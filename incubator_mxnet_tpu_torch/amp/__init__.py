"""AMP: automatic mixed precision (counterpart of the JAX package's
``amp/``, reference ``python/mxnet/amp/``)."""

from .amp import (AmpPolicy, convert_model, deinit, init, init_trainer,
                  scale_loss, unscale)
from .loss_scaler import LossScaler
from . import lists

__all__ = ["AmpPolicy", "LossScaler", "convert_model", "deinit", "init",
           "init_trainer", "lists", "scale_loss", "unscale"]
