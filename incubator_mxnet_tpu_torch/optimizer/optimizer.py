"""Optimizers of the ported training path, with MXNet's update rules.

Counterpart of the JAX package's ``optimizer/optimizer.py``: ``register``
and ``create``, the ``Optimizer`` base (``rescale_grad``, ``wd``,
``clip_gradient``, an ``lr_scheduler``, lr/wd multipliers, per-index update
counts), the rules ``SGD``, ``NAG``, ``Adam`` and ``AdamW`` (dense
gradients), and ``Updater``. Each rule is written once, as its functional
core ``update_fn``: it updates a list of weights and their states in place
(the weight is a parameter: updating it in place keeps every reference to
it, and saves a copy of the model per step) with the ``torch._foreach_*``
multi-tensor ops (a handful of launches for every parameter of a model),
and takes ``lr``, ``wd`` and ``t`` as device scalars, so that a CUDA graph
that captured it reads their values at each replay (``gluon.Trainer``'s
FusedStep and SuperStep). ``update`` (the ``Updater``'s one parameter at
a time) is the same core over a list of one.

The other rules of the JAX package (AdaGrad, AdaDelta, RMSProp, Ftrl,
LAMB, Signum, SGLD, DCASGD, LARS), sparse gradients and multi-precision
master weights are not ported yet.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Sequence, Tuple

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

    #: the rule has a functional core (:meth:`update_fn`)
    _has_fused_core = False

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

    # external state (None / a tensor / a tuple) <-> the flat tuple the
    # functional core takes
    @staticmethod
    def _pack_state(state) -> Tuple:
        if state is None:
            return ()
        if isinstance(state, tuple):
            return state
        return (state,)

    def _hyper_key(self) -> tuple:
        """Every plain scalar hyperparameter of the rule (what a captured
        update bakes in: a changed value must capture again)."""
        return tuple(sorted(
            (k, v) for k, v in self.__dict__.items()
            if not k.startswith("_") and k not in self._NON_HYPER
            and isinstance(v, (int, float, bool, str, type(None)))))

    # per-step inputs (device scalars or counters), not hyperparameters
    _NON_HYPER = frozenset(("lr", "wd", "rescale_grad", "num_update",
                            "begin_num_update"))

    # -- functional core ------------------------------------------------------
    @torch.no_grad()
    def update_fn(self, ws, gs, states, lr, wd, t):
        """The rule over a list of parameters, in place: ``ws`` the
        weights, ``gs`` their gradients (already rescaled; left as they
        are), ``states`` one ``_pack_state`` tuple each, ``lr``/``wd``/
        ``t`` 0-d fp32 tensors on the weights' device shared by the list
        (``t``: the update count, for bias corrections). Every weight of
        the list has one dtype. Returns ``(ws, states)``; a single tensor
        ``ws`` (the JAX package's per-parameter form) gives a single
        weight and its tuple back."""
        if not self._has_fused_core:
            raise NotImplementedError(
                f"{type(self).__name__} has no functional core")
        if isinstance(ws, torch.Tensor):
            self._core([ws], [gs], [tuple(states)], lr, wd, t)
            return ws, tuple(states)
        ws, gs, states = list(ws), list(gs), [tuple(s) for s in states]
        if ws:
            self._core(ws, gs, states, lr, wd, t)
        return ws, states

    def _prologue(self, ws, gs) -> List[torch.Tensor]:
        """Shared core prologue: the gradients cast to the weights' dtype
        and clipped. The rules never write into what it returns (it may be
        the caller's gradients)."""
        gs = [g.to(w.dtype) for w, g in zip(ws, gs)]
        if self.clip_gradient is not None:
            gs = torch._foreach_clamp_min(gs, -self.clip_gradient)
            torch._foreach_clamp_max_(gs, self.clip_gradient)
        return gs

    def _core(self, ws: List[torch.Tensor], gs: List[torch.Tensor],
              states: Sequence[Tuple], lr, wd, t) -> None:
        raise NotImplementedError

    # -- update -------------------------------------------------------------
    @torch.no_grad()
    def update(self, index, weight: torch.Tensor, grad: torch.Tensor,
               state):
        """Update ``weight`` (and ``state``) in place: the rule's core over
        this one parameter, with its rescale, lr, wd and update count as
        device scalars (as FusedStep gives them); returns the state. A
        rule of a user's that cannot be fused (``_has_fused_core`` False)
        overrides this."""
        from ..parallel.superstep import device_scalars

        self._update_count(index)
        lr, wd, t, rescale = device_scalars(
            (self._get_lr(index), self._get_wd(index),
             self._index_update_count[index], self.rescale_grad),
            weight.device)
        self._core([weight], [grad * rescale.to(grad.dtype)],
                   [self._pack_state(state)], lr, wd, t)
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

    _has_fused_core = True

    def _core(self, ws, gs, states, lr, wd, t):
        lr, wd = lr.to(ws[0].dtype), wd.to(ws[0].dtype)
        gs = torch._foreach_add(self._prologue(ws, gs),
                                torch._foreach_mul(ws, wd))
        if not states[0]:
            torch._foreach_sub_(ws, torch._foreach_mul(gs, lr))
            return
        ms = [st[0] for st in states]
        torch._foreach_mul_(ms, self.momentum)
        torch._foreach_sub_(ms, torch._foreach_mul(gs, lr))
        torch._foreach_add_(ws, ms)


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

    _has_fused_core = True

    def _core(self, ws, gs, states, lr, wd, t):
        lr, wd = lr.to(ws[0].dtype), wd.to(ws[0].dtype)
        gs = torch._foreach_add(self._prologue(ws, gs),
                                torch._foreach_mul(ws, wd))
        if not states[0]:
            torch._foreach_sub_(ws, torch._foreach_mul(gs, lr))
            return
        ms = [st[0] for st in states]
        torch._foreach_mul_(ms, self.momentum)
        torch._foreach_add_(ms, gs)
        upd = torch._foreach_add(gs, torch._foreach_mul(ms, self.momentum))
        torch._foreach_sub_(ws, torch._foreach_mul(upd, lr))


class _AdamBase(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    _has_fused_core = True

    def _moments_of(self, gs, states):
        """The moments of a list, in place; returns ``(ms, sqrt(v)+eps)``."""
        ms = [st[0] for st in states]
        vs = [st[1] for st in states]
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, gs, alpha=1 - self.beta1)
        torch._foreach_mul_(vs, self.beta2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - self.beta2)
        denom = torch._foreach_sqrt(vs)
        torch._foreach_add_(denom, self.epsilon)
        return ms, denom

    def _correction_of(self, t):
        """The bias correction at the device scalar ``t`` (fp32)."""
        return torch.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)


@register
class Adam(_AdamBase):
    """Adam with MXNet's step: ``lr_t = lr*sqrt(1-b2^t)/(1-b1^t)``,
    ``w -= lr_t * m / (sqrt(v) + eps)``, wd added to the gradient.
    ``lazy_update`` is kept as SGD keeps it (dense gradients only)."""

    def __init__(self, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.lazy_update = lazy_update

    def _core(self, ws, gs, states, lr, wd, t):
        dt = ws[0].dtype
        lr_t = (lr * self._correction_of(t)).to(dt)
        gs = torch._foreach_add(self._prologue(ws, gs),
                                torch._foreach_mul(ws, wd.to(dt)))
        ms, denom = self._moments_of(gs, states)
        upd = torch._foreach_mul(ms, lr_t)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(ws, upd)


@register
class AdamW(_AdamBase):
    """Adam with decoupled weight decay:
    ``w -= lr * (correction * m / (sqrt(v) + eps) + wd * w)``."""

    def _core(self, ws, gs, states, lr, wd, t):
        dt = ws[0].dtype
        ms, denom = self._moments_of(self._prologue(ws, gs), states)
        upd = torch._foreach_mul(ms, self._correction_of(t).to(dt))
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, torch._foreach_mul(ws, wd.to(dt)))
        torch._foreach_mul_(upd, lr.to(dt))
        torch._foreach_sub_(ws, upd)


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
