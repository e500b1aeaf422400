"""Gluon API of the port."""

from . import model_zoo, nn
from .block import Block

__all__ = ["Block", "model_zoo", "nn"]
