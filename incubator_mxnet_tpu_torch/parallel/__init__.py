"""Fused training steps (counterpart of the JAX package's ``parallel/``):
one card in this slice; ``superstep`` runs K steps a dispatch on CUDA
graphs."""

from . import superstep
from .spmd import SPMDTrainer, collect_params, make_functional_loss

__all__ = ["SPMDTrainer", "collect_params", "make_functional_loss",
           "superstep"]
