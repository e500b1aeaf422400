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

One difference stays for bare tensors: MXNet records nothing outside
``record()``, while torch records whenever its grad mode is on, which is
its default. So a ``net(x)`` on tensors outside ``record()`` builds a
graph here (and its attention saves what the backward needs). Run
inference under ``pause()`` or ``torch.no_grad()``, as the serving path
does. ``NDArray`` ops and a block called on NDArrays record only under
``record()``, as in MXNet.

NDArrays: ``backward`` and ``grad`` take NDArray heads, head gradients
and variables. A variable is an NDArray made one by ``attach_grad`` or
:func:`mark_variables`; ``backward`` writes its gradient into its
``grad`` array (``'write'`` replaces, ``'add'`` accumulates, ``'null'``
skips). A head computed under ``record()`` from no input that carries a
gradient backpropagates nothing and leaves every gradient as it was, as
in the JAX package. :class:`Function` is MXNet's custom differentiable op
over NDArrays, run as a ``torch.autograd.Function``.

Row-sparse gradients (reference ``grad_stype="row_sparse"``): a
cotangent may reach a leaf as a torch sparse COO tensor (the gluon
``Embedding(sparse_grad=True)``, a :class:`Function` whose ``backward``
returns a ``RowSparseNDArray``). A gluon parameter keeps it, coalesced,
as its ``.grad``; an NDArray variable whose buffer is row-sparse
(``attach_grad(stype="row_sparse")``) takes it as a ``RowSparseNDArray``
(``'write'`` replaces, ``'add'`` merges the rows), a dense cotangent
there is cast, and a dense buffer takes a sparse cotangent scattered.
Sparsity is a leaf's: an interior node receives a dense cotangent.
``grad`` returns a ``RowSparseNDArray`` for such a variable.

A graph is freed by the backward that walks it, so a second ``backward``
through it raises (MXNet's words: pass ``retain_graph=True``), where the
JAX package would compute the same gradient again: holding every graph
would cost memory on each step.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

__all__ = ["Function", "backward", "dense_grads", "grad", "is_recording",
           "is_training", "mark_recorded", "mark_variables", "pause",
           "predict_mode", "record", "set_recording", "set_training",
           "sparse_grads_enabled", "train_mode"]


class _TLS(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        # off inside a step engine whose whole step is one traced or
        # captured body (the JAX package's trace): layers keep their
        # gradients dense there
        self.sparse_grads = True


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


def sparse_grads_enabled() -> bool:
    """Whether a layer may give its weight a row-sparse gradient: under
    ``record()`` and outside :func:`dense_grads`."""
    return _state.recording and _state.sparse_grads


class dense_grads:
    """``with autograd.dense_grads():`` every gradient dense (the step
    engines' bodies, where the JAX package traces the step and its sparse
    layers take their dense path)."""

    def __enter__(self):
        self._prev, _state.sparse_grads = _state.sparse_grads, False
        return self

    def __exit__(self, *exc):
        _state.sparse_grads = self._prev


def mark_recorded(tensors) -> None:
    """Flag results computed under ``record()`` that torch left off its
    graph (no input carries a gradient): ``backward`` of such a head
    backpropagates nothing, where one computed outside ``record()``
    raises."""
    for t in tensors:
        if t.grad_fn is None:
            t._mx_recorded = True


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


def _tensor(x):
    """The tensor of an NDArray (a tensor passes through)."""
    from .ndarray.ndarray import NDArray

    return x._data if isinstance(x, NDArray) else x


def _head_grads(heads, head_grads):
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    return [torch.ones_like(h) if hg is None else _tensor(hg)
            for h, hg in zip(heads, head_grads)]


def _owner(leaf):
    """The NDArray variable whose tensor ``leaf`` is, or None."""
    ref = getattr(leaf, "_mx_owner", None)
    return None if ref is None else ref()


def _write_grad(var, g) -> None:
    """Store gradient ``g`` (dense or sparse COO) into NDArray variable
    ``var`` by its ``grad_req``."""
    from .ndarray.sparse import RowSparseNDArray, _merge_row_sparse

    buf = var._grad
    if var._grad_req == "null" or buf is None:
        return
    if isinstance(buf, RowSparseNDArray):
        g = RowSparseNDArray.from_torch(g)
        if var._grad_req == "add":
            g = _merge_row_sparse(buf, g)
        # in place: whoever holds the buffer sees the new rows
        buf._data, buf._indices = g._data.to(buf._data.dtype), g._indices
        return
    if g.is_sparse:
        g = g.to_dense()
    g = g.to(buf._data.dtype)
    buf._data = g if var._grad_req == "write" else buf._data + g


_FREED_GRAPH = (
    "Cannot differentiate node because it is not in a computational graph: "
    "an earlier backward freed it. If you want to differentiate the same "
    "graph twice, you need to pass retain_graph=True to backward.")


def _run(walk, *args, **kwargs):
    """``walk`` (torch's backward or grad) with a freed graph reported in
    MXNet's words."""
    try:
        return walk(*args, **kwargs)
    except RuntimeError as e:
        if "backward through the graph a second time" in str(e):
            raise RuntimeError(_FREED_GRAPH) from None
        raise


def _differentiable(heads):
    """The heads torch can differentiate; a head computed outside
    ``record()`` raises, one computed under it from no input that carries
    a gradient is left out (:func:`mark_recorded`)."""
    for h in heads:
        if h.grad_fn is None and not getattr(h, "_mx_recorded", False):
            raise ValueError("cannot differentiate a head that was not "
                             "computed under autograd.record()")
    return [h.grad_fn is not None for h in heads]


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """``autograd.backward([y])``: write gradients into the parameters and
    NDArray variables the heads depend on. A missing head gradient is
    ones, whatever the head's shape. Parameters with ``grad_req ==
    'write'`` (the default) lose their previous gradient first; ``'add'``
    accumulates. A parameter's row-sparse gradient is left coalesced."""
    heads = list(heads) if isinstance(heads, (list, tuple)) else [heads]
    heads = [_tensor(h) for h in heads]
    live = _differentiable(heads)
    grads = [g for g, on in zip(_head_grads(heads, head_grads), live) if on]
    heads = [h for h, on in zip(heads, live) if on]
    if not heads:
        return
    variables, params = [], []
    for leaf in _leaves(heads):
        var = _owner(leaf)
        if var is not None:
            variables.append((leaf, var))
            leaf.grad = None
            continue
        params.append(leaf)
        if getattr(leaf, "grad_req", "write") == "write":
            leaf.grad = None
    _run(torch.autograd.backward, heads, grads, retain_graph=retain_graph)
    for leaf, var in variables:
        if leaf.grad is not None:
            _write_grad(var, leaf.grad)
            leaf.grad = None
    for leaf in params:
        if leaf.grad is not None and leaf.grad.is_sparse \
                and not leaf.grad.is_coalesced():
            leaf.grad = leaf.grad.coalesce()


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned
    without touching ``.grad`` (reference ``autograd.grad``). NDArray
    variables must have a gradient attached (``attach_grad``), as in the
    JAX package, and give NDArray gradients; with ``create_graph`` those
    are on the tape for a higher-order gradient; a row-sparse gradient
    comes back as a ``RowSparseNDArray``."""
    from .ndarray.ndarray import NDArray
    from .ndarray.sparse import RowSparseNDArray

    heads = list(heads) if isinstance(heads, (list, tuple)) else [heads]
    heads = [_tensor(h) for h in heads]
    single = not isinstance(variables, (list, tuple))
    variables = [variables] if single else list(variables)
    for v in variables:
        if isinstance(v, NDArray) and v._grad is None:
            raise ValueError("autograd.grad: variables must have grad "
                             "attached (call x.attach_grad() before "
                             "recording)")
    leaves = [_tensor(v) for v in variables]
    out = _run(torch.autograd.grad, heads, leaves,
               _head_grads(heads, head_grads), retain_graph=retain_graph,
               create_graph=create_graph, allow_unused=True)
    out = [torch.zeros_like(t) if g is None else g
           for g, t in zip(out, leaves)]
    out = [g if not isinstance(v, NDArray) else
           RowSparseNDArray.from_torch(g) if g.is_sparse else NDArray(g)
           for g, v in zip(out, variables)]
    return out[0] if single else out


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make NDArrays variables with the given gradient buffers (reference
    ``autograd.mark_variables``): each becomes a leaf (any producer edge
    is cut) whose gradient ``backward`` writes into its buffer."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, buf, req in zip(variables, gradients, grad_reqs):
        var._grad = None if req == "null" else buf
        var._grad_req = req
        var._make_variable()


# ---------------------------------------------------------------------------
# Custom differentiable Function (reference autograd.Function)
# ---------------------------------------------------------------------------
class _Bridge(torch.autograd.Function):
    """Runs an op over NDArrays (an :class:`Function`, a custom op of
    ``mx.operator``) as one node of torch's graph. ``body.run_forward(
    tensors)`` returns the output tensors and the tensors its backward
    keeps; ``body.run_backward(grads, saved)`` returns one gradient per
    input. Both run with recording off. Integer outputs take no gradient
    and integer inputs receive none."""

    @staticmethod
    def forward(ctx, body, *tensors):
        outs, saved = body.run_forward(tensors)
        ctx.body = body
        ctx.float_in = [t.is_floating_point() for t in tensors]
        ctx.leaf_in = [t.grad_fn is None for t in tensors]
        ctx.save_for_backward(*saved)
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        in_grads = ctx.body.run_backward(grads, ctx.saved_tensors)
        # a sparse gradient reaches a leaf only: an interior node takes it
        # dense
        out = [g if f else None for g, f in zip(in_grads, ctx.float_in)]
        return (None, *[g.to_dense() if g is not None and g.is_sparse
                        and not leaf else g
                        for g, leaf in zip(out, ctx.leaf_in)])


class Function:
    """User-defined differentiable op (reference ``mx.autograd.Function``).

    Subclass and implement ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)`` over NDArrays; ``backward`` returns
    one gradient per input (a ``RowSparseNDArray`` is a row-sparse
    gradient). Both run with recording off. Under ``record()`` the call
    is one node of the tape (a ``torch.autograd.Function``)."""

    def __init__(self):
        self._saved = ()
        self._single = True

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def _forward_nd(self, inputs):
        with _RecordingStateScope(False, None):
            outputs = self.forward(*inputs)
        self._single = not isinstance(outputs, (list, tuple))
        return [outputs] if self._single else list(outputs)

    def run_forward(self, tensors):
        from .ndarray.ndarray import NDArray

        outs = self._forward_nd([NDArray(t) for t in tensors])
        return [o._data for o in outs], ()

    def run_backward(self, grads, saved):
        from .ndarray.ndarray import NDArray

        with _RecordingStateScope(False, None):
            in_grads = self.backward(*[NDArray(g) for g in grads])
        if not isinstance(in_grads, (list, tuple)):
            in_grads = [in_grads]
        # an NDArray's tensor, a RowSparseNDArray's sparse COO tensor
        return [g.as_torch() if hasattr(g, "as_torch") else g
                for g in in_grads]

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        if is_recording() and any(x._data.requires_grad for x in inputs):
            outs = [NDArray(t) for t in _Bridge.apply(
                self, *[x._data for x in inputs])]
        else:
            outs = self._forward_nd(list(inputs))
        return outs[0] if self._single else tuple(outs)
