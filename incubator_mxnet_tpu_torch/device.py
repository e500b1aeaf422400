"""Device contexts.

Counterpart of the JAX package's ``device.py``: ``Context(device_type,
device_id)`` objects and a thread-local default-context stack usable as a
``with`` block. ``gpu(i)`` maps to ``cuda:i`` and ``cpu()`` to the CPU.

The default context is ``gpu(0)``. Resolving a GPU context with no card
present raises: nothing drops to the CPU unless the caller asks for
``cpu()``.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import torch


class Context:
    """A device context. Compare reference ``mxnet.context.Context``."""

    _TYPES = ("cpu", "gpu")
    _default_stack = threading.local()

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type not in self._TYPES:
            raise ValueError(f"unknown device type {device_type!r}; "
                             f"known {self._TYPES}")
        self.device_type = device_type
        self.device_id = int(device_id)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self) -> int:
        return hash((self.device_type, self.device_id))

    def __repr__(self) -> str:
        return f"{self.device_type}({self.device_id})"

    def torch_device(self) -> torch.device:
        """The ``torch.device`` of this context; raises for a GPU context
        when no CUDA card is visible or the id is out of range."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{self!r} requested but no CUDA device is available; pass "
                "ctx=mx.cpu() to run on the CPU")
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise ValueError(f"device_id {self.device_id} out of range "
                             f"({n} CUDA devices)")
        return torch.device("cuda", self.device_id)

    # -- default-context stack --------------------------------------------
    @classmethod
    def _stack(cls) -> List["Context"]:
        if not hasattr(cls._default_stack, "stack"):
            cls._default_stack.stack = []
        return cls._default_stack.stack

    def __enter__(self) -> "Context":
        self._stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        self._stack().pop()

    @classmethod
    def default_ctx(cls) -> "Context":
        stack = cls._stack()
        return stack[-1] if stack else gpu(0)


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def current_context() -> Context:
    return Context.default_ctx()


def resolve(ctx: Optional[Context]) -> torch.device:
    """``torch.device`` for an entry point's ``ctx`` argument (``None`` is
    the default context, ``gpu(0)`` unless a ``with`` block says else)."""
    if ctx is None:
        ctx = current_context()
    if not isinstance(ctx, Context):
        raise TypeError(f"ctx must be an mx Context, got {ctx!r}")
    return ctx.torch_device()
