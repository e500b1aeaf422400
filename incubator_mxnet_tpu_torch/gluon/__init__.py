"""Gluon API of the port."""

from . import contrib, loss, model_zoo, nn, utils
from .block import Block
from .trainer import Trainer

__all__ = ["Block", "Trainer", "contrib", "loss", "model_zoo", "nn",
           "utils"]
