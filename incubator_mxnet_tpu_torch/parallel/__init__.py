"""Fused training steps (counterpart of the JAX package's ``parallel/``):
one card in this slice."""

from .spmd import SPMDTrainer, collect_params, make_functional_loss

__all__ = ["SPMDTrainer", "collect_params", "make_functional_loss"]
