"""Control flow: ``foreach``, ``while_loop`` and ``cond``.

Counterpart of the JAX package's ``contrib/control_flow.py`` (reference
``src/operator/control_flow.cc`` and ``mx.nd.contrib``). The bodies are
written against NDArrays and run as ordinary ops, so torch's autograd
differentiates through the construct, free NDArrays of a body included
(the JAX package lowers each construct to one ``lax`` primitive and
captures those as extra inputs; here the tape does it).

* ``foreach`` runs the body once a step of the data's leading axis and
  stacks the outputs on a new leading axis.
* ``while_loop`` runs exactly ``max_iterations`` steps with an active
  flag kept on the device: ``func`` runs every step, and ``torch.where``
  keeps the loop variables of the steps after the condition turned false
  and zeros their output rows, as the reference's masked scan does. No
  step reads the device from the host.
* ``cond`` with ``inputs`` reads the predicate once and runs only the
  chosen branch, so gradients flow through that branch alone, as under
  ``lax.cond`` (computing both and selecting would let the other branch's
  NaN gradients through); without ``inputs`` the branches take no
  arguments.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ndarray.ndarray import NDArray, as_nd

__all__ = ["cond", "foreach", "while_loop"]


def _as_list(x):
    if isinstance(x, (list, tuple)):
        return list(x), False
    return [x], True


def _tensor(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, NDArray):
        return x._data
    return torch.as_tensor(x, device=like.device)


def _stack(rows):
    from .. import ndarray as nd

    return nd.stack(*rows, axis=0)


def foreach(body: Callable, data, init_states):
    """``body(data_t, states) -> (outputs, new_states)`` over axis 0 of
    ``data`` (reference ``mx.nd.contrib.foreach``); returns (the outputs
    stacked on a new leading axis, the final states)."""
    datas, data_single = _as_list(data)
    states, states_single = _as_list(init_states)
    datas = [as_nd(d) for d in datas]
    states = [as_nd(s, ctx=datas[0].ctx) for s in states]
    steps = datas[0].shape[0]
    rows, out_single = [], True
    for t in range(steps):
        xs = [d[t] for d in datas]
        outs, new = body(xs[0] if data_single else xs,
                         states[0] if states_single else states)
        outs, out_single = _as_list(outs)
        states, _ = _as_list(new)
        rows.append(outs)
    stacked = [_stack([r[j] for r in rows]) for j in range(len(rows[0]))]
    outs_r = stacked[0] if out_single and len(stacked) == 1 else stacked
    return outs_r, states[0] if states_single else states


def while_loop(cond: Callable, func: Callable, loop_vars,
               max_iterations: int):
    """``while cond(*loop_vars): outputs, loop_vars = func(*loop_vars)``
    for exactly ``max_iterations`` steps (reference
    ``mx.nd.contrib.while_loop``); returns (the outputs stacked, a row a
    step, zeros after the last active step; the final loop variables)."""
    lvars, single = _as_list(loop_vars)
    lvars = [as_nd(v) for v in lvars]
    dev = lvars[0]._data.device
    active = torch.ones((), dtype=torch.bool, device=dev)
    rows = []
    for _ in range(int(max_iterations)):
        go = cond(*lvars)
        go = _tensor(go, lvars[0]._data).reshape(()).to(torch.bool)
        active = torch.logical_and(active, go)
        outs, new = func(*lvars)
        outs, _ = _as_list(outs)
        new, _ = _as_list(new)
        lvars = [NDArray(torch.where(active, _tensor(n, o._data), o._data))
                 for n, o in zip(new, lvars)]
        outs = [_tensor(o, lvars[0]._data) for o in outs]
        rows.append([NDArray(torch.where(active, o, torch.zeros_like(o)))
                     for o in outs])
    stacked = [_stack([r[j] for r in rows]) for j in range(len(rows[0]))]
    return (stacked[0] if len(stacked) == 1 else stacked,
            lvars[0] if single else lvars)


def cond(pred: Callable, then_func: Callable, else_func: Callable,
         inputs=None):
    """``then_func(*inputs) if pred(*inputs) else else_func(*inputs)``
    (reference ``mx.nd.contrib.cond``): the predicate is read once and
    only the chosen branch runs."""
    ins = [] if inputs is None else [as_nd(i) for i in _as_list(inputs)[0]]
    p = pred(*ins)
    taken = bool(p.asscalar() if isinstance(p, NDArray) else p)
    return (then_func if taken else else_func)(*ins)
