"""Autograd scopes and backward with MXNet's meaning, over torch autograd.

Counterpart of the JAX package's ``autograd.py``. Torch records the graph
itself; this module keeps MXNet's two per-thread flags beside it:

* ``record()`` turns recording on (torch grad mode on) and training on;
* ``pause()`` turns recording off (``torch.no_grad()``) and training off;
* ``train_mode()`` / ``predict_mode()`` set only the training flag, which
  the layers read (``Dropout`` is active iff ``is_training()``).

``backward(heads)`` keeps two MXNet semantics that torch lacks: a head
that is not a scalar gets a head gradient of ones (``loss.backward()`` on a
per-sample loss), and a parameter whose ``grad_req`` is ``'write'`` (the
default) gets a fresh gradient from each backward instead of the sum torch
would accumulate into ``.grad``. ``grad_req = 'add'`` accumulates.

One difference stays: MXNet records nothing outside ``record()``, while
torch records whenever its grad mode is on, which is its default. So a
``net(x)`` outside ``record()`` builds a graph here (and its attention
saves what the backward needs). Run inference under ``pause()`` or
``torch.no_grad()``, as the serving path does.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

__all__ = ["backward", "grad", "is_recording", "is_training", "pause",
           "predict_mode", "record", "set_recording", "set_training",
           "train_mode"]


class _TLS(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_state = _TLS()


class _RecordingStateScope:
    """Set the recording and/or training flag for a ``with`` block (None
    leaves a flag alone); recording also sets torch's grad mode."""

    def __init__(self, is_record: Optional[bool],
                 train_mode: Optional[bool]):
        self._enter_record = is_record
        self._enter_train = train_mode
        self._prev = None

    def __enter__(self):
        self._prev = (_state.recording, _state.training,
                      torch.is_grad_enabled())
        if self._enter_record is not None:
            _state.recording = self._enter_record
            torch.set_grad_enabled(self._enter_record)
        if self._enter_train is not None:
            _state.training = self._enter_train
        return self

    def __exit__(self, *exc):
        _state.recording, _state.training, grad_mode = self._prev
        torch.set_grad_enabled(grad_mode)


def record(train_mode: bool = True):
    """``with autograd.record():`` recording (and training) on."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    """``with autograd.pause():`` recording (and training) off."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def is_recording() -> bool:
    return _state.recording


def is_training() -> bool:
    return _state.training


def set_recording(is_record: bool) -> bool:
    prev, _state.recording = _state.recording, bool(is_record)
    torch.set_grad_enabled(bool(is_record))
    return prev


def set_training(train: bool) -> bool:
    prev, _state.training = _state.training, bool(train)
    return prev


def _leaves(heads):
    """The leaf tensors that require grad and that ``heads`` depend on."""
    seen, leaves = set(), []
    stack = [h.grad_fn for h in heads if h.grad_fn is not None]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)      # an AccumulateGrad node
        if var is not None:
            leaves.append(var)
        stack.extend(f for f, _ in fn.next_functions)
    return leaves


def _head_grads(heads, head_grads):
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    return [torch.ones_like(h) if hg is None else hg
            for h, hg in zip(heads, head_grads)]


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """``autograd.backward([y])``: write gradients into the parameters the
    heads depend on. A missing head gradient is ones, whatever the head's
    shape. Parameters with ``grad_req == 'write'`` (the default) lose
    their previous gradient first; ``'add'`` accumulates."""
    heads = list(heads) if isinstance(heads, (list, tuple)) else [heads]
    for h in heads:
        if h.grad_fn is None:
            raise ValueError("cannot differentiate a head that was not "
                             "computed under autograd.record()")
    for leaf in _leaves(heads):
        if getattr(leaf, "grad_req", "write") == "write":
            leaf.grad = None
    torch.autograd.backward(heads, _head_grads(heads, head_grads),
                            retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned
    without touching ``.grad`` (reference ``autograd.grad``)."""
    heads = list(heads) if isinstance(heads, (list, tuple)) else [heads]
    single = not isinstance(variables, (list, tuple))
    variables = [variables] if single else list(variables)
    out = torch.autograd.grad(heads, variables, _head_grads(heads,
                                                            head_grads),
                              retain_graph=retain_graph,
                              create_graph=create_graph, allow_unused=True)
    out = [torch.zeros_like(v) if g is None else g
           for g, v in zip(out, variables)]
    return out[0] if single else out
