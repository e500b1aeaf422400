"""Gluon layers of the port."""

from .basic_layers import (Dense, Dropout, Embedding, HybridSequential,
                           LayerNorm, Sequential)

__all__ = ["Dense", "Dropout", "Embedding", "HybridSequential", "LayerNorm",
           "Sequential"]
