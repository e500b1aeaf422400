"""Gluon Trainer: the eager training entry point on one device.

Counterpart of the JAX package's ``gluon/trainer.py`` ``Trainer``::

    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    mx.autograd.backward(loss)
    trainer.step(batch_size)

``step`` sets ``rescale_grad = 1 / batch_size`` and applies the
optimizer's MXNet rule to every parameter in place. A gradient that no
backward has written since the last step is stale: ``step`` raises unless
``ignore_stale_grad=True``, which skips that parameter. A parameter
without a gradient (``requires_grad=False`` or ``grad_req="null"``: the
BatchNorm running statistics) is left alone. One device only:
``kvstore`` takes ``"device"`` (the reference's default), ``"local"`` or
None, which on one card all mean the same (there is no copy to reduce);
a distributed kvstore, a kvstore object, ``update_on_kvstore=True`` and
gradient compression wait for the multi-GPU slice and raise
``NotImplementedError``. The JAX package's FusedStep and SuperStep engines
are not ported (``parallel.SPMDTrainer`` is the fused one-device step
here).
"""

from __future__ import annotations

from typing import List, Mapping

import torch

from .. import optimizer as opt_mod

__all__ = ["Trainer"]

_STALE_GRAD_MSG = (
    "Gradient of Parameter `{name}` has not been updated by backward since "
    "last `step`. This could mean a bug in your model that made it only use "
    "a subset of the Parameters for this iteration. If you are "
    "intentionally only using a subset, call step with "
    "ignore_stale_grad=True")


def _consumed(p) -> bool:
    """True when ``p.grad`` is the gradient the last step already used:
    a backward since then either replaced it (``grad_req='write'``) or
    added into it in place (which bumps its version)."""
    g = p.grad
    return g is None or getattr(g, "_mx_consumed_version", None) == g._version


#: the kvstore values of one card; the rest wait for this ROADMAP item
_ONE_CARD_KVSTORES = ("device", "local", None)
_MULTI_GPU = "ROADMAP.md queue 1, item 10 (Multi-GPU)"


class Trainer:
    """Applies an optimizer to a set of parameters (reference
    ``gluon.Trainer``). ``params``: a name -> parameter mapping (as
    ``Block.collect_params()`` returns) or a list of parameters.
    ``kvstore``: ``"device"``, ``"local"`` or None (one card)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if kvstore not in _ONE_CARD_KVSTORES:
            raise NotImplementedError(
                f"kvstore {kvstore!r}: the port trains on one card "
                f"({_ONE_CARD_KVSTORES}); kvstores wait for {_MULTI_GPU}")
        if update_on_kvstore or compression_params:
            raise NotImplementedError(
                "update_on_kvstore and gradient compression wait for "
                f"{_MULTI_GPU}")
        if isinstance(params, Mapping):
            named = list(params.items())
        elif isinstance(params, (list, tuple)):
            named = [(getattr(p, "name", str(i)), p)
                     for i, p in enumerate(params)]
        else:
            raise ValueError("params must be a dict of parameters or a list")
        for name, p in named:
            if not isinstance(p, torch.nn.Parameter):
                raise ValueError(f"{name} is not a Parameter")
        self._names: List[str] = [n for n, _ in named]
        self._params: List[torch.nn.Parameter] = [p for _, p in named]
        self._scale = 1.0
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt_mod.Optimizer):
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(
                optimizer, param_dict=param_dict,
                **dict(optimizer_params or {}))
        self._updater = opt_mod.get_updater(self._optimizer)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.learning_rate = lr

    @property
    def optimizer(self):
        return self._optimizer

    def step(self, batch_size: int, ignore_stale_grad: bool = False):
        """Rescale the gradients by 1/batch_size and update."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def update(self, batch_size: int, ignore_stale_grad: bool = False):
        self.step(batch_size, ignore_stale_grad)

    def _update(self, ignore_stale_grad: bool = False):
        todo = []
        for i, p in enumerate(self._params):
            if not p.requires_grad or getattr(p, "grad_req", "write") \
                    == "null":
                continue
            if _consumed(p):
                if ignore_stale_grad:
                    continue
                raise UserWarning(_STALE_GRAD_MSG.format(name=self._names[i]))
            todo.append(i)
        for i in todo:           # nothing moves unless every gradient is new
            p = self._params[i]
            self._updater(i, p.grad, p.data)
            p.grad._mx_consumed_version = p.grad._version

    # -- states -------------------------------------------------------------
    def save_states(self, fname: str):
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=True))

    def load_states(self, fname: str):
        with open(fname, "rb") as f:
            data = f.read()
        device = self._params[0].device if self._params else None
        self._updater.set_states(data, device=device)
        self._updater.optimizer.param_dict = dict(enumerate(self._params))
        self._optimizer = self._updater.optimizer
