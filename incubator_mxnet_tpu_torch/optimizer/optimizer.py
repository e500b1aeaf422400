"""Optimizers of the ported training path, with MXNet's update rules.

Counterpart of the JAX package's ``optimizer/optimizer.py``: ``register``
and ``create``, the ``Optimizer`` base (``rescale_grad``, ``wd``,
``clip_gradient``, an ``lr_scheduler``, lr/wd multipliers, per-index update
counts), the rules ``SGD``, ``NAG``, ``Adam`` and ``AdamW`` (dense
gradients), and ``Updater``. The JAX package compiles each rule's pure
core; here each rule updates the weight and its states in place with
PyTorch tensor ops (the weight is a parameter: updating it in place keeps
every reference to it, and saves a copy of the model per step).

The other rules of the JAX package (AdaGrad, AdaDelta, RMSProp, Ftrl,
LAMB, Signum, SGLD, DCASGD, LARS), sparse gradients and multi-precision
master weights are not ported yet.
"""

from __future__ import annotations

import math
import pickle
from typing import Any, Dict, Tuple

import torch

__all__ = ["Adam", "AdamW", "NAG", "Optimizer", "SGD", "Updater", "create",
           "get_updater", "register"]

_OPTIMIZERS: Dict[str, type] = {}


def register(cls):
    """Register an Optimizer subclass under its lowercased name."""
    _OPTIMIZERS[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs) -> "Optimizer":
    if isinstance(name, Optimizer):
        return name
    if name.lower() not in _OPTIMIZERS:
        raise ValueError(
            f"unknown optimizer {name!r}; known: {sorted(_OPTIMIZERS)} (the "
            "JAX package's other rules are not ported yet)")
    return _OPTIMIZERS[name.lower()](**kwargs)


class Optimizer:
    """Base optimizer (reference ``mxnet.optimizer.Optimizer``)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 multi_precision=False, param_dict=None, begin_num_update=0):
        if multi_precision:
            raise NotImplementedError(
                "multi_precision (fp32 master weights) is not ported yet")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self._lr_mult: Dict[Any, float] = {}
        self._wd_mult: Dict[Any, float] = {}

    def __getstate__(self):
        # the parameters themselves are not part of a saved optimizer
        return dict(self.__dict__, param_dict={})

    # -- schedules / multipliers -------------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("lr_scheduler is set; use it instead")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.lr = lr

    def set_lr_mult(self, args_lr_mult: Dict[Any, float]):
        self._lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict[Any, float]):
        self._wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

    def _mult(self, index, attr, table) -> float:
        p = self.param_dict.get(index)
        if p is not None:
            return getattr(p, attr, 1.0)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index) -> float:
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return lr * self._mult(index, "lr_mult", self._lr_mult)

    def _get_wd(self, index) -> float:
        return self.wd * self._mult(index, "wd_mult", self._wd_mult)

    # -- state --------------------------------------------------------------
    def create_state(self, index, weight: torch.Tensor):
        return None

    # -- update -------------------------------------------------------------
    def _prepare_grad(self, weight, grad):
        """The rescaled, clipped gradient in the weight's dtype (a new
        tensor: the caller's gradient is left as it is)."""
        g = grad.to(weight.dtype) * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp_(-self.clip_gradient, self.clip_gradient)
        return g

    def step(self, weight, g, state, lr, wd, t):
        """Apply the rule in place: ``weight`` and ``state`` are updated,
        ``g`` is the prepared gradient, ``t`` this index's update count."""
        raise NotImplementedError

    @torch.no_grad()
    def update(self, index, weight: torch.Tensor, grad: torch.Tensor,
               state):
        """Update ``weight`` (and ``state``) in place; returns the state."""
        self._update_count(index)
        t = self._index_update_count[index]
        self.step(weight, self._prepare_grad(weight, grad), state,
                  self._get_lr(index), self._get_wd(index), t)
        return state


@register
class SGD(Optimizer):
    """SGD with momentum: ``m = momentum*m - lr*(g + wd*w); w += m``.
    ``lazy_update`` (kept, default True as in MXNet) chooses how a sparse
    gradient updates; a dense gradient updates the same either way."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def step(self, weight, g, state, lr, wd, t):
        g.add_(weight, alpha=wd)
        if state is None:
            weight.sub_(g, alpha=lr)
            return
        state.mul_(self.momentum).sub_(g, alpha=lr)
        weight.add_(state)


@register
class NAG(Optimizer):
    """Nesterov SGD: ``m = momentum*m + g; w -= lr*(g + momentum*m)``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def step(self, weight, g, state, lr, wd, t):
        g.add_(weight, alpha=wd)
        if state is None:
            weight.sub_(g, alpha=lr)
            return
        state.mul_(self.momentum).add_(g)
        weight.sub_(g.add_(state, alpha=self.momentum), alpha=lr)


class _AdamBase(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def _moments(self, g, state: Tuple[torch.Tensor, torch.Tensor]):
        m, v = state
        m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
        v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
        return m, v.sqrt().add_(self.epsilon)

    def _correction(self, t):
        return math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)


@register
class Adam(_AdamBase):
    """Adam with MXNet's step: ``lr_t = lr*sqrt(1-b2^t)/(1-b1^t)``,
    ``w -= lr_t * m / (sqrt(v) + eps)``, wd added to the gradient.
    ``lazy_update`` is kept as SGD keeps it (dense gradients only)."""

    def __init__(self, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.lazy_update = lazy_update

    def step(self, weight, g, state, lr, wd, t):
        g.add_(weight, alpha=wd)
        m, denom = self._moments(g, state)
        weight.addcdiv_(m, denom, value=-lr * self._correction(t))


@register
class AdamW(_AdamBase):
    """Adam with decoupled weight decay:
    ``w -= lr * (correction * m / (sqrt(v) + eps) + wd * w)``."""

    def step(self, weight, g, state, lr, wd, t):
        m, denom = self._moments(g, state)
        upd = (m * self._correction(t)).div_(denom).add_(weight, alpha=wd)
        weight.sub_(upd, alpha=lr)


class Updater:
    """State-managing update callable (reference
    ``mxnet.optimizer.Updater``)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def __call__(self, index, grad: torch.Tensor, weight: torch.Tensor):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.states[index] = self.optimizer.update(index, weight, grad,
                                                   self.states[index])

    def get_states(self, dump_optimizer=False) -> bytes:
        """The states (and optionally the optimizer) as bytes; tensors are
        stored as CPU copies."""
        def cpu(s):
            if isinstance(s, tuple):
                return tuple(cpu(x) for x in s)
            return None if s is None else s.detach().cpu()

        return pickle.dumps(({k: cpu(v) for k, v in self.states.items()},
                             self.optimizer if dump_optimizer else None))

    def set_states(self, states: bytes, device=None) -> None:
        """Restore :meth:`get_states` output, tensors onto ``device``."""
        def place(s):
            if isinstance(s, tuple):
                return tuple(place(x) for x in s)
            return None if s is None else s.to(device)

        st, opt = pickle.loads(states)
        self.states = {k: place(v) for k, v in st.items()}
        if opt is not None:
            self.optimizer = opt


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
