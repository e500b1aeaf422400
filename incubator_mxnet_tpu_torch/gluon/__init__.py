"""Gluon API of the port."""

from . import loss, model_zoo, nn
from .block import Block
from .trainer import Trainer

__all__ = ["Block", "Trainer", "loss", "model_zoo", "nn"]
