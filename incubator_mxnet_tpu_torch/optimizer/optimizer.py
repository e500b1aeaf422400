"""Optimizers of the ported training path, with MXNet's update rules.

Counterpart of the JAX package's ``optimizer/optimizer.py``: ``register``
and ``create``, the ``Optimizer`` base (``rescale_grad``, ``wd``,
``clip_gradient``, an ``lr_scheduler``, lr/wd multipliers, per-index update
counts), the rules ``SGD``, ``NAG``, ``Adam`` and ``AdamW``, and
``Updater``. A row-sparse gradient (a sparse COO tensor, as a gluon
``Embedding(sparse_grad=True)`` leaves it) takes SGD's lazy update, which
moves only the rows it holds; every other rule, and SGD with
``lazy_update=False``, densifies it first, as the JAX package's
``update_multi_precision`` does. Each rule is written once, as its
functional core ``update_fn``: it updates a list of weights and their
states in place (the weight is a parameter: updating it in place keeps
every reference to it, and saves a copy of the model per step) with the
``torch._foreach_*``
multi-tensor ops (a handful of launches for every parameter of a model),
and takes ``lr``, ``wd`` and ``t`` as device scalars, so that a CUDA graph
that captured it reads their values at each replay (``gluon.Trainer``'s
FusedStep and SuperStep). ``update`` (the ``Updater``'s one parameter at
a time) is the same core over a list of one.

The rules: SGD, NAG, Adam, AdamW, AdaGrad, AdaDelta, RMSProp (plain and
centered), Ftrl, LAMB, LARS, Signum, SGLD and DCASGD, with the JAX
package's formulas. RMSProp, Ftrl, Signum and LAMB run the registered
update ops of ``ops/optimizer_ops.py`` (which compute the same rules) a
parameter at a time and write the results back in place; the others are
written with ``torch._foreach_*``. SGLD draws its noise from the
package's generator of the weights' device (``random.generator``).

``multi_precision=True`` keeps an fp32 master weight for every fp16/bf16
parameter (``create_state_multi_precision``): the rule updates the master
with the gradient in fp32 and the parameter becomes the master's cast
(``update_multi_precision``; a row-sparse gradient is densified there).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Sequence, Tuple

import torch

__all__ = ["AdaDelta", "AdaGrad", "Adam", "AdamW", "DCASGD", "Ftrl", "LAMB",
           "LARS", "NAG", "Optimizer", "RMSProp", "SGD", "SGLD", "Signum",
           "Updater", "create", "get_updater", "register"]

#: the parameter types that take an fp32 master weight
_LOW_PRECISION = (torch.float16, torch.bfloat16)

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
            f"unknown optimizer {name!r}; known: {sorted(_OPTIMIZERS)}")
    return _OPTIMIZERS[name.lower()](**kwargs)


class Optimizer:
    """Base optimizer (reference ``mxnet.optimizer.Optimizer``)."""

    #: the rule has a functional core (:meth:`update_fn`)
    _has_fused_core = False
    #: the rule draws random numbers each step (SGLD)
    _needs_rng = False

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 multi_precision=False, param_dict=None, begin_num_update=0):
        self.multi_precision = multi_precision
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

    def create_state_multi_precision(self, index, weight: torch.Tensor):
        """The state of ``weight``: with ``multi_precision`` and an fp16 or
        bf16 weight, ``(fp32 master copy, the rule's state of the
        master)``; else the rule's own state."""
        if self.multi_precision and weight.dtype in _LOW_PRECISION:
            master = weight.detach().to(torch.float32).clone()
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def _has_master(self, weight, state) -> bool:
        """``state`` holds an fp32 master weight of the 16-bit
        ``weight``."""
        return (self.multi_precision and weight.dtype in _LOW_PRECISION
                and isinstance(state, tuple) and len(state) == 2
                and isinstance(state[0], torch.Tensor)
                and state[0].dtype == torch.float32
                and state[0].shape == weight.shape)

    @torch.no_grad()
    def update_multi_precision(self, index, weight: torch.Tensor,
                               grad: torch.Tensor, state):
        """``update`` through the fp32 master weight where ``state`` holds
        one (the gradient in fp32, the weight written back as the
        master's cast); else ``update``. A row-sparse gradient is
        densified under a master weight, as in the reference."""
        if not self._has_master(weight, state):
            return self.update(index, weight, grad, state)
        if grad.is_sparse:
            grad = grad.to_dense()
        master, inner = state
        inner = self.update(index, master, grad.to(torch.float32), inner)
        weight.copy_(master)
        return (master, inner)

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
        overrides this. A row-sparse ``grad`` is densified first."""
        from ..parallel.superstep import device_scalars

        if grad.is_sparse:
            grad = grad.to_dense()
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
    ``lazy_update`` (default True, as in MXNet) chooses how a row-sparse
    gradient updates: lazily, only the rows it holds (their weight decay,
    clipping and momentum; an untouched row's momentum does not decay),
    or densified; a dense gradient updates the same either way."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        if grad.is_sparse and self.lazy_update:
            return self._update_rows(index, weight, grad, state)
        return super().update(index, weight, grad, state)

    def _update_rows(self, index, weight, grad, state):
        """The lazy rule over the rows of a sparse COO ``grad`` (reference
        ``sgd_update``/``sgd_mom_update`` on row_sparse with
        ``lazy_update``), in place."""
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = grad.coalesce()
        idx = grad.indices()[0]
        w = weight.index_select(0, idx)
        g = grad.values().to(weight.dtype) * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        g = g + wd * w
        if state is None:
            weight.index_copy_(0, idx, w - lr * g)
            return state
        m = self.momentum * state.index_select(0, idx) - lr * g
        weight.index_copy_(0, idx, w + m)
        state.index_copy_(0, idx, m)
        return state

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


@register
class AdaGrad(Optimizer):
    """AdaGrad: ``h += g^2; w -= lr * (g / sqrt(h + eps) + wd * w)`` (the
    history takes the clipped gradient; wd applies at the update)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    _has_fused_core = True

    def _core(self, ws, gs, states, lr, wd, t):
        dt = ws[0].dtype
        gs = self._prologue(ws, gs)
        hs = [st[0] for st in states]
        torch._foreach_addcmul_(hs, gs, gs)
        den = torch._foreach_add(hs, self.float_stable_eps)
        torch._foreach_sqrt_(den)
        upd = torch._foreach_div(gs, den)
        torch._foreach_add_(upd, torch._foreach_mul(ws, wd.to(dt)))
        torch._foreach_mul_(upd, lr.to(dt))
        torch._foreach_sub_(ws, upd)


@register
class AdaDelta(Optimizer):
    """AdaDelta: ``g += wd * w; E[g^2] = rho E[g^2] + (1-rho) g^2;
    d = sqrt(E[d^2] + eps) / sqrt(E[g^2] + eps) * g; E[d^2] = rho E[d^2] +
    (1-rho) d^2; w -= d`` (no learning rate)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    _has_fused_core = True

    def _core(self, ws, gs, states, lr, wd, t):
        rho, eps = self.rho, self.epsilon
        gs = torch._foreach_add(self._prologue(ws, gs),
                                torch._foreach_mul(ws, wd.to(ws[0].dtype)))
        ags = [st[0] for st in states]
        ads = [st[1] for st in states]
        torch._foreach_mul_(ags, rho)
        torch._foreach_addcmul_(ags, gs, gs, value=1 - rho)
        num = torch._foreach_add(ads, eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(ags, eps)
        torch._foreach_sqrt_(den)
        d = torch._foreach_div(num, den)
        torch._foreach_mul_(d, gs)
        torch._foreach_mul_(ads, rho)
        torch._foreach_addcmul_(ads, d, d, value=1 - rho)
        torch._foreach_sub_(ws, d)


def _write(dsts, srcs) -> None:
    """Copy each result of a functional update op into its tensor."""
    for dst, src in zip(dsts, srcs):
        dst.copy_(src)


@register
class RMSProp(Optimizer):
    """RMSProp, plain (``rmsprop_update``) and ``centered`` (Graves',
    ``rmspropalex_update``), with ``clip_weights``; wd added to the
    gradient."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2, self.epsilon = gamma1, gamma2, epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return tuple(torch.zeros_like(weight) for _ in range(3))
        return (torch.zeros_like(weight),)

    _has_fused_core = True

    def _core(self, ws, gs, states, lr, wd, t):
        from ..ops import optimizer_ops as ops

        dt = ws[0].dtype
        lr, wd = lr.to(dt), wd.to(dt)
        cw = self.clip_weights
        for w, g, st in zip(ws, self._prologue(ws, gs), states):
            if self.centered:
                out = ops.rmspropalex_update(
                    w, g, *st, lr=lr, gamma1=self.gamma1,
                    gamma2=self.gamma2, epsilon=self.epsilon, wd=wd)
                if cw is not None:
                    out = (out[0].clamp(-cw, cw), *out[1:])
            else:
                out = ops.rmsprop_update(
                    w, g, st[0], lr=lr, gamma1=self.gamma1,
                    epsilon=self.epsilon, wd=wd,
                    clip_weights=-1.0 if cw is None else cw)
            _write((w, *st), out)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (``ftrl_update``): ``z += g - sigma * w``, ``n +=
    g^2``, ``w = -(z - sign(z) l1) / ((beta + sqrt(n)) / lr + wd)`` where
    ``|z| > l1``, else 0."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    _has_fused_core = True

    def _core(self, ws, gs, states, lr, wd, t):
        from ..ops import optimizer_ops as ops

        dt = ws[0].dtype
        lr, wd = lr.to(dt), wd.to(dt)
        for w, g, st in zip(ws, self._prologue(ws, gs), states):
            _write((w, *st), ops.ftrl_update(
                w, g, *st, lr=lr, lamda1=self.lamda1, beta=self.beta,
                wd=wd))


@register
class LAMB(Optimizer):
    """LAMB (``lamb_update_phase1`` then ``lamb_update_phase2``): Adam's
    moments (bias-corrected with ``bias_correction``), ``u = m / (sqrt(v)
    + eps) + wd * w``, and ``w -= lr * (||w|| / ||u||) * u`` (the trust
    ratio 1 unless both norms are positive; ``lower_bound``/
    ``upper_bound`` clamp ``||w||``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    _has_fused_core = True

    def _core(self, ws, gs, states, lr, wd, t):
        from ..ops import optimizer_ops as ops

        dt = ws[0].dtype
        lr, wd = lr.to(dt), wd.to(dt)
        lb = -1.0 if self.lower_bound is None else self.lower_bound
        ub = -1.0 if self.upper_bound is None else self.upper_bound
        for w, g, (m, v) in zip(ws, self._prologue(ws, gs), states):
            u, m2, v2 = ops.lamb_update_phase1(
                w, g, m, v, beta1=self.beta1, beta2=self.beta2,
                epsilon=self.epsilon, t=t,
                bias_correction=self.bias_correction, wd=wd)
            m.copy_(m2)
            v.copy_(v2)
            r1 = torch.linalg.vector_norm(w, dtype=torch.float32)
            r2 = torch.linalg.vector_norm(u, dtype=torch.float32)
            w.copy_(ops.lamb_update_phase2(w, u, r1, r2, lr=lr,
                                           lower_bound=lb, upper_bound=ub))


@register
class LARS(Optimizer):
    """LARS: the trust ratio ``eta * ||w|| / (||g|| + wd ||w|| + eps)``
    (1 unless both norms are positive) scales the step: ``m = momentum *
    m + trust * lr * (g + wd * w); w -= m``."""

    def __init__(self, momentum=0.9, eta=0.001, epsilon=1e-9, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.eta, self.epsilon = momentum, eta, epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    _has_fused_core = True

    def _core(self, ws, gs, states, lr, wd, t):
        dt = ws[0].dtype
        gs = self._prologue(ws, gs)
        ms = [st[0] for st in states]
        for w, g, m in zip(ws, gs, ms):
            wn = torch.linalg.vector_norm(w, dtype=torch.float32)
            gn = torch.linalg.vector_norm(g, dtype=torch.float32)
            trust = torch.where((wn > 0) & (gn > 0),
                                self.eta * wn / (gn + wd * wn + self.epsilon),
                                torch.ones_like(wn)).to(dt)
            step = (g + wd.to(dt) * w) * (trust * lr.to(dt))
            m.mul_(self.momentum).add_(step)
            w.sub_(m)


@register
class Signum(Optimizer):
    """signSGD with momentum (``signum_update``): ``m = momentum * m -
    (1 - momentum) * (g + wd * w); w = w * (1 - lr * wd_lh) + lr *
    sign(m)``; without momentum ``w -= lr * sign(g + wd * w)``."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.wd_lh = momentum, wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    _has_fused_core = True

    def _core(self, ws, gs, states, lr, wd, t):
        from ..ops import optimizer_ops as ops

        dt = ws[0].dtype
        lr, wd = lr.to(dt), wd.to(dt)
        gs = self._prologue(ws, gs)
        if not states[0]:
            gs = torch._foreach_add(gs, torch._foreach_mul(ws, wd))
            torch._foreach_sign_(gs)
            torch._foreach_sub_(ws, torch._foreach_mul(gs, lr))
            return
        for w, g, (m,) in zip(ws, gs, states):
            _write((w, m), ops.signum_update(
                w, g, m, lr=lr, momentum=self.momentum, wd=wd,
                wd_lh=self.wd_lh))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: ``w -= lr/2 * (g + wd * w)``
    plus Gaussian noise of variance ``lr``, drawn from the package's
    generator of the weights' device (``_noise``)."""

    _needs_rng = True

    def create_state(self, index, weight):
        return None

    _has_fused_core = True

    @staticmethod
    def _noise(w, lr):
        """N(0, lr) noise shaped like ``w``, in its dtype."""
        from .. import random as _random
        from ..device import Context

        dev = w.device
        ctx = Context("cpu") if dev.type == "cpu" else \
            Context("gpu", dev.index or 0)
        z = torch.randn(w.shape, generator=_random.generator(ctx),
                        device=dev, dtype=w.dtype)
        return z * torch.sqrt(lr).to(w.dtype)

    def _core(self, ws, gs, states, lr, wd, t):
        dt = ws[0].dtype
        gs = torch._foreach_add(self._prologue(ws, gs),
                                torch._foreach_mul(ws, wd.to(dt)))
        torch._foreach_mul_(gs, (0.5 * lr).to(dt))
        torch._foreach_sub_(ws, gs)
        torch._foreach_add_(ws, [self._noise(w, lr) for w in ws])


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD: ``g += wd * w; g += lamda * g * g *
    (w - w_prev); m = momentum * m - lr * g; w_prev = w; w += m``. The
    previous weight is its own copy (never the weight's storage)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.lamda = momentum, lamda

    def create_state(self, index, weight):
        return torch.zeros_like(weight), weight.detach().clone()

    _has_fused_core = True

    def _core(self, ws, gs, states, lr, wd, t):
        dt = ws[0].dtype
        gs = torch._foreach_add(self._prologue(ws, gs),
                                torch._foreach_mul(ws, wd.to(dt)))
        ms = [st[0] for st in states]
        pws = [st[1] for st in states]
        diff = torch._foreach_sub(ws, pws)
        torch._foreach_mul_(diff, gs)
        torch._foreach_mul_(diff, gs)
        torch._foreach_add_(gs, diff, alpha=self.lamda)
        torch._foreach_mul_(ms, self.momentum)
        torch._foreach_sub_(ms, torch._foreach_mul(gs, lr.to(dt)))
        torch._foreach_copy_(pws, ws)
        torch._foreach_add_(ws, ms)


class Updater:
    """State-managing update callable (reference
    ``mxnet.optimizer.Updater``)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def __call__(self, index, grad, weight):
        """Update ``weight`` in place by ``grad``: tensors, or an NDArray
        weight and an NDArray or ``RowSparseNDArray`` gradient."""
        grad, weight = (x.as_torch() if hasattr(x, "as_torch") else x
                        for x in (grad, weight))
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.states[index] = self.optimizer.update_multi_precision(
            index, weight, grad, self.states[index])

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
