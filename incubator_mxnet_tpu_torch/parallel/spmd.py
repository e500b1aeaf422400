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

Meshes, the ZeRO ladder, quantized collectives, ``run_superstep`` and the
optax names other than ``sgd``, ``nag``, ``adam`` and ``adamw`` wait for
the multi-GPU slice and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from .. import autograd

__all__ = ["SPMDTrainer", "collect_params", "make_functional_loss"]

_MULTI_GPU = "the multi-GPU slice of the port"


def _to_torch_optim(optimizer, optimizer_params: Optional[dict], params):
    """The ``torch.optim`` rule that computes the JAX package's optax chain
    for ``optimizer``; returns ``(optimizer, clip)``. ``clip`` (or None)
    clamps each gradient element before the rule, as ``optax.clip``."""
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
                 eps=p.pop("epsilon", 1e-8), weight_decay=wd)
    elif name in ("lamb", "rmsprop", "adagrad"):
        raise NotImplementedError(
            f"SPMDTrainer optimizer {optimizer!r} is not ported yet (the "
            "port has sgd, nag, adam and adamw)")
    else:
        raise ValueError(f"no optax mapping for optimizer {optimizer!r}")
    return tx, clip


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
            [self.params[n] for n in self._trainable])
        self._loss_of = make_functional_loss(net, loss_fn)
        self._num_steps = 0

    def _place(self, xs):
        xs = xs if isinstance(xs, (list, tuple)) else [xs]
        return [torch.as_tensor(np.asarray(x)).to(self.device)
                if not isinstance(x, torch.Tensor) else x.to(self.device)
                for x in xs]

    def step(self, data, labels) -> torch.Tensor:
        """One forward+backward+update step; returns the fp32 mean loss,
        taken before the update (a 0-d tensor on the card)."""
        data, labels = self._place(data), self._place(labels)
        self.tx.zero_grad(set_to_none=True)
        loss = self._loss_of(self.params, data, labels)
        loss.backward()
        if self._clip is not None:
            for n in self._trainable:
                g = self.params[n].grad
                if g is not None:
                    g.clamp_(-self._clip, self._clip)
        self.tx.step()
        self._num_steps += 1
        return loss.detach()

    def run_steps(self, n: int, data, labels) -> torch.Tensor:
        """``n`` steps on the same batch; returns the last step's loss."""
        loss = None
        for _ in range(int(n)):
            loss = self.step(data, labels)
        return loss

    @torch.no_grad()
    def sync_to_net(self) -> None:
        """Write the trainer's parameter values back into the Block: the
        trained weights and the auxiliary state (running statistics)."""
        own = dict(self.net.named_parameters())
        for n, v in self.params.items():
            own[n].copy_(v)
