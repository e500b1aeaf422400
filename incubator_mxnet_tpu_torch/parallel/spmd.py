"""SPMDTrainer on one card: forward, backward and update in one call.

Counterpart of the JAX package's ``parallel/spmd.py``. There the step is
one jitted XLA computation partitioned over a device mesh, with optax
transformations as the update rules. This slice ports its one-device
form: the trainer owns its own copy of the parameters (``params``), each
``step`` runs the net on them under ``autograd.record()`` through
``torch.func.functional_call``, takes the fp32 mean of the loss, runs
backward and applies a ``torch.optim`` rule chosen to give the optax
formulas of ``_to_optax`` (clip -> coupled weight decay -> rule; ``adamw``
decouples it). ``sync_to_net`` writes the trained values back into the
net.

Auxiliary state: a parameter with ``requires_grad=False`` (declared with
``grad_req="null"``, the BatchNorm running statistics) is frozen, as the
JAX trainer's ``grad_req == "null"`` parameters: it stays out of the
optimizer. The JAX step returns the running statistics as ``aux`` and
writes them into its frozen parameters; here the model updates them in
place inside the step, on the trainer's own copies that
``functional_call`` hands it, so they persist in ``params`` from step to
step and ``sync_to_net`` writes them back with the weights.

One dispatch for many steps (``parallel/superstep.py``): ``run_superstep``
trains on a stacked ``[K, ...]`` window of K distinct batches and returns
the ``[K]`` fp32 losses; on a CUDA device the K step bodies are one CUDA
graph, replayed once a window. ``run_steps(n)`` trains n steps on one
batch through a one-step graph, replayed n times (n varies from call to
call, and a replay costs the host microseconds against a step's
milliseconds, so one graph serves every n). ``step`` stays eager: it is
the yardstick, and the graph path gives its loss stream bit for bit. The
optimizer states exist from construction (zeros, as the first step would
make them), and Adam/AdamW are built ``capturable`` on the card, so the
eager step and the captured one run the same arithmetic.

Meshes, the ZeRO ladder, quantized collectives and the optax names other
than ``sgd``, ``nag``, ``adam`` and ``adamw`` wait for the multi-GPU slice
and raise ``NotImplementedError`` here; ``superstep_feed`` and
``device_prefetcher`` wait for the data pipeline.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import torch
from torch.func import functional_call

from .. import autograd
from . import superstep

__all__ = ["SPMDTrainer", "collect_params", "make_functional_loss"]

_MULTI_GPU = "the multi-GPU slice of the port"
_DATA = "the data pipeline (ROADMAP.md queue 1, item 9)"


def _to_torch_optim(optimizer, optimizer_params: Optional[dict], params,
                    capturable: bool = False):
    """The ``torch.optim`` rule that computes the JAX package's optax chain
    for ``optimizer``; returns ``(optimizer, clip)``. ``clip`` (or None)
    clamps each gradient element before the rule, as ``optax.clip``.
    ``capturable`` builds Adam/AdamW with their step count on the device
    (a CUDA graph may capture them)."""
    p = dict(optimizer_params or {})
    lr = p.pop("learning_rate", 0.01)
    wd = p.pop("wd", 0.0)
    clip = p.pop("clip_gradient", None)
    name = optimizer.lower() if isinstance(optimizer, str) else None
    if name == "sgd":
        # optax.sgd(momentum): m = g + mom*m; w -= lr*m (torch's SGD with
        # dampening 0); add_decayed_weights is torch's coupled wd
        tx = torch.optim.SGD(params, lr=lr, momentum=p.pop("momentum", 0.0),
                             weight_decay=wd)
    elif name == "nag":
        # optax.sgd(momentum=0, nesterov=True) is plain SGD; torch's SGD
        # refuses nesterov without a momentum
        mom = p.pop("momentum", 0.9)
        tx = torch.optim.SGD(params, lr=lr, momentum=mom,
                             nesterov=mom != 0, weight_decay=wd)
    elif name in ("adam", "adamw"):
        cls = torch.optim.Adam if name == "adam" else torch.optim.AdamW
        tx = cls(params, lr=lr, betas=(p.pop("beta1", 0.9),
                                       p.pop("beta2", 0.999)),
                 eps=p.pop("epsilon", 1e-8), weight_decay=wd,
                 capturable=capturable)
    elif name in ("lamb", "rmsprop", "adagrad"):
        raise NotImplementedError(
            f"SPMDTrainer optimizer {optimizer!r} is not ported yet (the "
            "port has sgd, nag, adam and adamw)")
    else:
        raise ValueError(f"no optax mapping for optimizer {optimizer!r}")
    return tx, clip


def _init_optimizer_state(tx) -> None:
    """Make ``tx``'s per-parameter state now, as its first step would
    (zeros), so that every step, eager or captured, runs the same code:
    SGD's momentum buffers (``m = momentum*m + g`` from m = 0 is the
    clone the first step would take), Adam's step count and moments."""
    for group in tx.param_groups:
        for p in group["params"]:
            st = tx.state[p]
            if isinstance(tx, torch.optim.SGD):
                if group["momentum"] != 0:
                    st["momentum_buffer"] = torch.zeros_like(p)
            else:
                st["step"] = torch.zeros((), dtype=torch.float32,
                                         device=p.device) \
                    if group["capturable"] else torch.tensor(0.0)
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)


def collect_params(block) -> "OrderedDict[str, torch.nn.Parameter]":
    """A Block's unique parameters by structural name; raises if one is
    not initialized or still waits for its shape (a deferred dim, filled
    by the first forward)."""
    out: "OrderedDict[str, torch.nn.Parameter]" = OrderedDict()
    for name, p in block.named_parameters():
        if p.device.type == "meta" or 0 in p.shape:
            raise RuntimeError(
                f"parameter {name} not initialized; call initialize() and "
                "run one forward (deferred shapes), or load weights, before "
                "building the trainer")
        out[name] = p
    return out


def make_functional_loss(net, loss_fn) -> Callable:
    """``loss_of(param_values, data, labels) -> fp32 mean loss``: runs
    ``net`` on the given parameter values (name -> tensor) under
    ``autograd.record()`` (recording, training mode: dropout on) and
    reduces ``loss_fn(*outputs, *labels)`` to its mean in fp32."""

    def loss_of(values: Dict[str, torch.Tensor], data, labels):
        with autograd.record():
            out = functional_call(net, values, tuple(data))
            outs = out if isinstance(out, tuple) else (out,)
            loss = loss_fn(*outs, *labels)
        return loss.float().mean()

    return loss_of


class SPMDTrainer:
    """Own a copy of the parameters; run fused train steps on one card.

    Usage::

        st = parallel.SPMDTrainer(net, loss_fn, 'sgd',
                                  {'learning_rate': 0.1, 'momentum': 0.9})
        loss = st.step(x, y)          # x, y: tensors or numpy arrays
        st.sync_to_net()              # write params back into the Block
    """

    def __init__(self, net, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, *, shard_weight_update: bool = False,
                 zero_stage: Optional[int] = None,
                 collective_quant: Optional[str] = None):
        if mesh is not None:
            raise NotImplementedError(f"device meshes wait for {_MULTI_GPU}")
        if shard_weight_update or (zero_stage or 0) >= 1:
            raise NotImplementedError(f"ZeRO stages wait for {_MULTI_GPU}")
        if collective_quant not in (None, "none"):
            raise NotImplementedError(
                f"quantized collectives wait for {_MULTI_GPU}")
        self.net = net
        self.loss_fn = loss_fn
        objs = collect_params(net)
        self._trainable = [n for n, p in objs.items() if p.requires_grad]
        # the trainer's own copy, as the JAX trainer's device arrays
        self.params = OrderedDict(
            (n, p.detach().clone().requires_grad_(p.requires_grad))
            for n, p in objs.items())
        self.device = next(iter(self.params.values())).device
        self.tx, self._clip = _to_torch_optim(
            optimizer, optimizer_params,
            [self.params[n] for n in self._trainable],
            capturable=self.device.type == "cuda")
        _init_optimizer_state(self.tx)
        self._loss_of = make_functional_loss(net, loss_fn)
        self._num_steps = 0
        #: the largest window run so far (the JAX trainer's attribute)
        self.superstep_window = 1
        #: the captured step graphs (kind, K, inputs, hyperparameters)
        self._graphs = superstep.GraphCache(self.device)

    @staticmethod
    def _tensors(xs) -> List[torch.Tensor]:
        xs = xs if isinstance(xs, (list, tuple)) else [xs]
        return [superstep.as_torch(x) for x in xs]

    def _place(self, xs) -> List[torch.Tensor]:
        return [x.to(self.device) for x in self._tensors(xs)]

    def _body(self, data, labels) -> torch.Tensor:
        """The step body: forward, backward, update; the fp32 mean loss
        taken before the update. Called directly by ``step`` and by the
        eager paths, captured by the graph paths."""
        self.tx.zero_grad(set_to_none=True)
        loss = self._loss_of(self.params, data, labels)
        loss.backward()
        if self._clip is not None:
            for n in self._trainable:
                g = self.params[n].grad
                if g is not None:
                    g.clamp_(-self._clip, self._clip)
        self.tx.step()
        return loss.detach()

    def step(self, data, labels) -> torch.Tensor:
        """One forward+backward+update step; returns the fp32 mean loss,
        taken before the update (a 0-d tensor on the card)."""
        loss = self._body(self._place(data), self._place(labels))
        self._num_steps += 1
        return loss

    def _state(self) -> List[torch.Tensor]:
        """Every tensor a step changes in place: the parameter values
        (running statistics included) and the optimizer states."""
        out = list(self.params.values())
        for st in self.tx.state.values():
            out.extend(v for v in st.values() if isinstance(v, torch.Tensor))
        return out

    def _replay(self, kind: str, k: int, data, labels,
                replays: int = 1) -> torch.Tensor:
        """The graph path: ``k`` step bodies captured in one graph (each
        reading slice i of the static window, or the static batch for
        ``kind == "loop"``), the inputs (host or device tensors) copied
        into its static buffers, then ``replays`` replays. Returns the
        losses of the last replay."""
        hyper = tuple((k2, v) for g in self.tx.param_groups
                      for k2, v in sorted(g.items()) if k2 != "params"
                      and isinstance(v, (int, float, bool, str, tuple,
                                         type(None))))
        nd = len(data)

        def body_of(static):
            d, lab = static[:nd], static[nd:]
            if kind == "loop":
                return lambda i: self._body(d, lab)
            return lambda i: self._body(superstep.slice_window(d, i),
                                        superstep.slice_window(lab, i))

        outs = self._graphs.run((kind, nd, hyper), data + labels, body_of,
                                k, self._state(), replays=replays)
        self._num_steps += k * replays
        return torch.stack(outs)

    def run_steps(self, n: int, data, labels) -> torch.Tensor:
        """``n`` steps on the same batch; returns the last step's loss. On
        a CUDA device: one captured step, replayed ``n`` times."""
        n = int(n)
        data, labels = self._tensors(data), self._tensors(labels)
        if superstep.step_path(self.device) == "eager" or n < 1:
            data, labels = self._place(data), self._place(labels)
            loss = None
            for _ in range(n):
                loss = self.step(data, labels)
            return loss
        return self._replay("loop", 1, data, labels, replays=n)[0]

    def run_superstep(self, data, labels) -> torch.Tensor:
        """Train on K distinct batches: ``data``/``labels`` leaves are
        stacked ``[K, ...]`` windows (``superstep.stack_window``). Returns
        the ``[K]`` fp32 losses (a device tensor), each taken before its
        step's update: the loss stream, every dropout draw and the final
        parameters equal K ``step()`` calls on the same batches. On a CUDA
        device the K step bodies are one CUDA graph and the window costs
        one replay; with ``MXTPU_SUPERSTEP=0`` (or on the CPU) the same K
        steps run eagerly."""
        data, labels = self._tensors(data), self._tensors(labels)
        k = superstep.window_len(data + labels)
        if k > self.superstep_window:
            self.superstep_window = k
        if superstep.step_path(self.device) == "eager":
            data, labels = self._place(data), self._place(labels)
            return torch.stack([
                self.step(superstep.slice_window(data, i),
                          superstep.slice_window(labels, i)).float()
                for i in range(k)])
        return self._replay("superstep", k, data, labels)

    def superstep_feed(self, source, window=None, depth=None):
        """Windows of a data pipeline, staged on the device (the JAX
        package's ``DevicePrefetcher`` over ``Stage.window``)."""
        raise NotImplementedError(f"superstep_feed waits for {_DATA}")

    def device_prefetcher(self, source, depth=None):
        raise NotImplementedError(f"device_prefetcher waits for {_DATA}")

    @torch.no_grad()
    def sync_to_net(self) -> None:
        """Write the trainer's parameter values back into the Block: the
        trained weights and the auxiliary state (running statistics)."""
        own = dict(self.net.named_parameters())
        for n, v in self.params.items():
            own[n].copy_(v)
