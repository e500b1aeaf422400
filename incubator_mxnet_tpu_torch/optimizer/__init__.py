"""Optimizers (counterpart of the JAX package's ``optimizer/``)."""

from .optimizer import (LAMB, LARS, NAG, SGD, SGLD, AdaDelta, AdaGrad, Adam,
                        AdamW, DCASGD, Ftrl, Optimizer, RMSProp, Signum,
                        Updater, create, get_updater, register)

__all__ = ["AdaDelta", "AdaGrad", "Adam", "AdamW", "DCASGD", "Ftrl", "LAMB",
           "LARS", "NAG", "Optimizer", "RMSProp", "SGD", "SGLD", "Signum",
           "Updater", "create", "get_updater", "register"]
