"""Gluon API of the port."""

from . import contrib, loss, model_zoo, nn, utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import Constant, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "Constant", "HybridBlock", "Parameter", "ParameterDict",
           "SymbolBlock", "Trainer", "contrib", "loss", "model_zoo", "nn",
           "utils"]
