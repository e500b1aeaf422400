"""Gluon layers of the port."""

from .basic_layers import Dense, Dropout, Embedding, LayerNorm

__all__ = ["Dense", "Dropout", "Embedding", "LayerNorm"]
