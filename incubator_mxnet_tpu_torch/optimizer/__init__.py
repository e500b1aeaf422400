"""Optimizers (counterpart of the JAX package's ``optimizer/``)."""

from .optimizer import (SGD, NAG, Adam, AdamW, Optimizer, Updater, create,
                        get_updater, register)

__all__ = ["Adam", "AdamW", "NAG", "Optimizer", "SGD", "Updater", "create",
           "get_updater", "register"]
