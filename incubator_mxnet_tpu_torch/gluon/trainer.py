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
``NotImplementedError``.

The JAX package's two step engines, on one card:

* **FusedStep**: ``step`` updates every parameter through the optimizer's
  functional core (``Optimizer.update_fn``, ``torch._foreach_*``) in a
  handful of launches whatever the parameter count, whenever the rule has
  one (``fused_step(False)`` pins the per-parameter path);
* **SuperStep** (``Trainer.superstep(net, loss_fn, window)``): forward,
  backward and ``update_fn`` for the K batches of a stacked window; on a
  CUDA device the K step bodies are one CUDA graph
  (``parallel/superstep.py``) and a window costs one replay, on the CPU
  the same body runs K times. ``t`` advances per iteration, ``lr``/``wd``
  at window granularity, as in the JAX package. The eager path (K rounds
  of forward, backward and ``Trainer.step(1)``) runs when
  ``MXTPU_SUPERSTEP`` is off or a reason the JAX package names applies
  (``last_fallback``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Mapping, Optional

import torch

from .. import optimizer as opt_mod

__all__ = ["FusedStep", "SuperStep", "Trainer"]

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
_DATA = "ROADMAP.md queue 1, item 9 (the data pipeline)"


def _groups(keys) -> "OrderedDict[tuple, List[int]]":
    """Positions grouped by key, in order of first appearance."""
    out: "OrderedDict[tuple, List[int]]" = OrderedDict()
    for pos, key in enumerate(keys):
        out.setdefault(key, []).append(pos)
    return out


class FusedStep:
    """The whole-model update through the optimizer's functional core.

    One ``update_fn`` call per group of parameters that share (lr, wd, t,
    dtype): the rescale, clip and rule of every parameter in a handful of
    multi-tensor launches, with ``lr``/``wd``/``t``/the rescale as device
    scalars. ``run`` returns False (and names why in ``last_fallback``)
    when the rule has no functional core; the trainer then takes the
    per-parameter path."""

    def __init__(self, trainer: "Trainer"):
        self._trainer = trainer
        self.dispatch_count = 0          # fused updates run (tests)
        self.last_fallback: Optional[str] = None

    def _fallback(self, why: str) -> bool:
        self.last_fallback = why
        return False

    @torch.no_grad()
    def run(self, todo: List[int]) -> bool:
        tr = self._trainer
        opt, upd = tr._optimizer, tr._updater
        if not getattr(opt, "_has_fused_core", False):
            return self._fallback("optimizer has no functional core")
        if not todo:
            return True
        from ..parallel import superstep

        params = tr._params
        for i in todo:
            opt._update_count(i)
            if i not in upd.states:
                upd.states[i] = opt.create_state(i, params[i].data)
        keys = [(opt._get_lr(i), opt._get_wd(i),
                 float(opt._index_update_count[i]), params[i].dtype,
                 params[i].device) for i in todo]
        for (lr, wd, t, dtype, device), pos in _groups(keys).items():
            idxs = [todo[q] for q in pos]
            scal = superstep.device_scalars(
                (lr, wd, t, opt.rescale_grad), device)
            gs = [params[i].grad for i in idxs]
            gs = torch._foreach_mul(gs, scal[3].to(gs[0].dtype))
            opt.update_fn([params[i].data for i in idxs], gs,
                          [opt._pack_state(upd.states[i]) for i in idxs],
                          scal[0], scal[1], scal[2])
        self.dispatch_count += 1
        return True


class SuperStep:
    """K whole train steps (forward, backward and every parameter's
    update through ``update_fn``) a dispatch, over a stacked ``[K, ...]``
    window of distinct batches; the per-step losses come back as a
    ``[K]`` tensor. Built by :meth:`Trainer.superstep`.

    On a CUDA device the K step bodies are captured in one CUDA graph
    (cached by window signature, K and the optimizer's hyperparameters)
    and each window costs one replay; on the CPU the same body runs K
    times. Either counts one dispatch. ``t`` is exact per iteration (Adam's
    bias correction matches the per-step path), ``lr``/``wd`` are read once
    a window. The eager path, K rounds of forward, backward and
    ``Trainer.step(1)`` (the same loss stream), runs when ``MXTPU_SUPERSTEP``
    is off or the JAX package's reasons apply; ``last_fallback`` names
    which. A capture or replay that fails raises."""

    def __init__(self, trainer: "Trainer", net, loss_fn,
                 window: Optional[int] = None):
        from ..parallel import superstep

        self._trainer = trainer
        self._net = net
        self._loss_fn = loss_fn
        self.window = max(1, int(window if window is not None
                                 else superstep.superstep_window()))
        self._graphs = None            # a GraphCache, on the card
        self.dispatch_count = 0
        self.last_fallback: Optional[str] = None

    def _fallback(self, why: str) -> bool:
        self.last_fallback = why
        return False

    def _trainable(self):
        from ..parallel.spmd import collect_params

        objs = collect_params(self._net)
        return OrderedDict(
            (n, p) for n, p in objs.items()
            if p.requires_grad and getattr(p, "grad_req", "write") != "null")

    def _engageable(self) -> bool:
        from ..parallel import superstep

        tr = self._trainer
        if not superstep.superstep_enabled():
            return self._fallback("MXTPU_SUPERSTEP off")
        opt = tr._optimizer
        if not getattr(opt, "_has_fused_core", False):
            return self._fallback("optimizer has no functional core")
        if getattr(opt, "_needs_rng", False):
            return self._fallback("optimizer draws per-step randomness")
        if getattr(tr, "_amp_loss_scaler", None) is not None:
            return self._fallback("amp loss scaling")
        for n, p in self._trainable().items():
            if id(p) not in tr._param2idx:
                return self._fallback(
                    f"net parameter {n} not owned by the trainer")
        self.last_fallback = None      # this window runs fused
        return True

    def feed(self, source, depth=None):
        """Device-resident windows of a data pipeline (the JAX package's
        ``DevicePrefetcher`` over ``Stage.window``)."""
        raise NotImplementedError(f"SuperStep.feed waits for {_DATA}")

    def run_window(self, data, labels) -> torch.Tensor:
        """Train on one stacked window: ``data``/``labels`` leaves are
        ``[k, ...]`` (k may be shorter than ``window``). Returns the
        ``[k]`` fp32 per-step losses."""
        from ..parallel import superstep

        data = data if isinstance(data, (list, tuple)) else [data]
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        data = [superstep.as_torch(a) for a in data]
        labels = [superstep.as_torch(a) for a in labels]
        k = superstep.window_len(data + labels)
        if self._engageable():
            return self._fused_window(data, labels, k)
        return self._eager_window(data, labels, k)

    def _eager_window(self, data, labels, k) -> torch.Tensor:
        """K rounds of forward, backward of the fp32 mean loss and
        ``Trainer.step(1)`` (the mean already divides by the batch)."""
        from .. import autograd
        from ..parallel import superstep

        device = next(self._net.parameters()).device
        data = [a.to(device) for a in data]
        labels = [a.to(device) for a in labels]
        losses = []
        for i in range(k):
            with autograd.record():
                out = self._net(*superstep.slice_window(data, i))
                outs = out if isinstance(out, tuple) else (out,)
                loss = self._loss_fn(
                    *outs, *superstep.slice_window(labels, i)).float().mean()
            autograd.backward(loss)
            self._trainer.step(1)
            losses.append(loss.detach())
        return torch.stack(losses)

    def _fused_window(self, data, labels, k) -> torch.Tensor:
        from ..parallel import superstep

        tr = self._trainer
        opt, upd = tr._optimizer, tr._updater
        trainable = self._trainable()
        params = list(trainable.values())
        device = params[0].device
        idxs = [tr._param2idx[id(p)] for p in params]
        for i, p in zip(idxs, params):
            if i not in upd.states:
                upd.states[i] = opt.create_state(i, p.data)
        # counts advance k per parameter up front; lr/wd are then read
        # once (schedules tick at window granularity) while t advances
        # per iteration in the body
        counts = opt._index_update_count
        old_counts, old_num_update = dict(counts), opt.num_update
        t0s = []
        for i in idxs:
            t0 = int(counts.get(i, opt.begin_num_update))
            t0s.append(t0)
            counts[i] = t0 + k
        opt.num_update = max([opt.num_update]
                             + [counts[i] for i in idxs])
        keys = [(opt._get_lr(i), opt._get_wd(i), float(t0), p.dtype)
                for i, t0, p in zip(idxs, t0s, params)]
        groups = _groups(keys)
        values = [float(tr._scale)]
        for lr, wd, t0, _ in groups:
            values += [lr, wd, t0]
        states = [opt._pack_state(upd.states[i]) for i in idxs]
        path = superstep.step_path(device)
        try:
            if path == "graph":
                losses = self._replay(k, data, labels, params, states,
                                      groups, values, device)
            else:
                with superstep.dispatch(device):
                    scal = superstep.device_scalars(values, device)
                    body = self._body(
                        [a.to(device) for a in data],
                        [a.to(device) for a in labels], params, states,
                        groups, scal)
                    losses = torch.stack([body(i) for i in range(k)])
        except BaseException:
            counts.clear()
            counts.update(old_counts)
            opt.num_update = old_num_update
            raise
        self.dispatch_count += 1
        return losses

    def _body(self, data, labels, params, states, groups, scal):
        """Step ``i`` of a window: forward and backward of the fp32 mean
        loss on batch ``i``, then ``update_fn`` per group with
        ``t = t0 + i + 1``; returns the loss."""
        from .. import autograd
        from ..parallel import superstep

        opt = self._trainer._optimizer
        plan = [(pos, scal[1 + 3 * j], scal[2 + 3 * j], scal[3 + 3 * j])
                for j, pos in enumerate(groups.values())]

        def body(i):
            with autograd.record():
                out = self._net(*superstep.slice_window(data, i))
                outs = out if isinstance(out, tuple) else (out,)
                loss = self._loss_fn(
                    *outs, *superstep.slice_window(labels, i)).float().mean()
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for pos, lr, wd, t0 in plan:
                    gs = [grads[q] for q in pos]
                    gs = torch._foreach_mul(gs, scal[0].to(gs[0].dtype))
                    opt.update_fn([params[q].data for q in pos], gs,
                                  [states[q] for q in pos], lr, wd,
                                  t0 + float(i + 1))
            return loss.detach()

        return body

    def _replay(self, k, data, labels, params, states, groups, values,
                device) -> torch.Tensor:
        """The graph path: the window and the scalars copied into the
        static buffers of the K bodies' graph (captured on a miss), one
        replay."""
        from ..parallel import superstep

        opt = self._trainer._optimizer
        every = [p.data for p in self._net.parameters()]
        for st in states:
            every.extend(st)
        key = (type(opt).__name__, opt._hyper_key(), len(data),
               tuple((tuple(pos), str(dt)) for (_, _, _, dt), pos
                     in groups.items()),
               tuple(id(p) for p in params))
        nd, nl = len(data), len(labels)

        def body_of(static):
            return self._body(static[:nd], static[nd:nd + nl], params,
                              states, groups, static[-1])

        if self._graphs is None:
            self._graphs = superstep.GraphCache(device)
        scal = superstep.device_scalars(values, device)
        return torch.stack(self._graphs.run(
            key, data + labels + [scal], body_of, k, every))


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
        self._param2idx: Dict[int, int] = {
            id(p): i for i, p in enumerate(self._params)}
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
        self._fused = FusedStep(self)
        self._fused_mode = True      # fuse whenever the rule has a core

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.learning_rate = lr

    @property
    def optimizer(self):
        return self._optimizer

    def fused_step(self, enabled: bool = True, shard_update: bool = False,
                   zero_stage: Optional[int] = None) -> "Trainer":
        """Configure the FusedStep engine: ``fused_step(False)`` pins the
        per-parameter path. Sharding the update (ZeRO) needs several
        cards."""
        if shard_update or (zero_stage or 0) >= 1:
            raise NotImplementedError(
                f"sharded updates (ZeRO) wait for {_MULTI_GPU}")
        self._fused_mode = bool(enabled)
        return self

    def superstep(self, net, loss_fn,
                  window: Optional[int] = None) -> SuperStep:
        """The K-steps-a-dispatch engine over ``net`` and ``loss_fn``::

            eng = trainer.superstep(net, loss_fn, window=8)
            losses = eng.run_window(xs, ys)    # [8] per-step losses

        ``xs``/``ys``: stacked ``[K, ...]`` windows
        (``parallel.superstep.stack_window``)."""
        return SuperStep(self, net, loss_fn, window=window)

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
        # nothing moves unless every gradient is new
        if not (self._fused_mode and self._fused.run(todo)):
            for i in todo:
                p = self._params[i]
                self._updater(i, p.grad, p.data)
        for i in todo:
            g = self._params[i].grad
            g._mx_consumed_version = g._version

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
