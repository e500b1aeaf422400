"""Model families beyond the vision zoo.

Counterpart of the JAX package's ``models/``: BERT and its transformer
blocks (BASELINE.json config 3) and SSD-300 (config 5).
"""

from .transformer import (BERTEncoder, BERTModel, MultiHeadAttention,
                          PositionwiseFFN, TransformerEncoderCell, get_bert)
from .ssd import (SSD, SSDMultiBoxLoss, VGGAtrousBase, get_ssd,
                  ssd_300_vgg16_atrous_voc)

__all__ = ["BERTEncoder", "BERTModel", "MultiHeadAttention",
           "PositionwiseFFN", "SSD", "SSDMultiBoxLoss",
           "TransformerEncoderCell", "VGGAtrousBase", "get_bert", "get_ssd",
           "ssd_300_vgg16_atrous_voc"]
