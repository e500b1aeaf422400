"""Operator registry.

Counterpart of the JAX package's ``ops/registry.py`` (the reference's nnvm
op registry, ``NNVM_REGISTER_OP``). An op is a function over torch
tensors. Torch infers shapes and types and differentiates every op, so the
registry's jobs are the name -> op lookup that generates the ``mx.nd.*``
surface, per-op metadata (docs, whether the op is differentiable, whether
it draws random numbers) and ``list_ops``. An op with ``needs_rng`` takes
a keyword ``rng``: the ``torch.Generator`` it draws from, whose device is
the device it draws on (``ndarray.invoke`` passes the operands' device's,
or the context's).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass
class OpDef:
    name: str
    fn: Callable[..., Any]          # (*tensors, **kwargs) -> tensor | tuple
    differentiable: bool = True
    needs_rng: bool = False          # fn takes rng=<torch.Generator>
    aliases: tuple = ()
    doc: str = ""


_OPS: Dict[str, OpDef] = {}


def register(name: str, *, differentiable: bool = True,
             needs_rng: bool = False, aliases: tuple = ()) -> Callable:
    """Register a function over torch tensors as a framework op."""

    def deco(fn: Callable) -> Callable:
        opdef = OpDef(name=name, fn=fn, differentiable=differentiable,
                      needs_rng=needs_rng, aliases=aliases,
                      doc=fn.__doc__ or "")
        _OPS[name] = opdef
        for a in aliases:
            _OPS[a] = opdef
        return fn

    return deco


def get(name: str) -> Optional[OpDef]:
    return _OPS.get(name)


def list_ops():
    """All registered canonical op names."""
    return sorted({od.name for od in _OPS.values()})
