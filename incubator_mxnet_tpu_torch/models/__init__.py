"""Model families beyond the vision zoo.

Counterpart of the JAX package's ``models/``: BERT and its transformer
blocks (BASELINE.json config 3). SSD waits for its slice (ROADMAP.md
queue 1, item 7).
"""

from .transformer import (BERTEncoder, BERTModel, MultiHeadAttention,
                          PositionwiseFFN, TransformerEncoderCell, get_bert)

__all__ = ["BERTEncoder", "BERTModel", "MultiHeadAttention",
           "PositionwiseFFN", "TransformerEncoderCell", "get_bert"]
