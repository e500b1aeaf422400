"""``mx.operator``: custom operators over NDArrays.

Counterpart of the JAX package's ``operator.py`` (reference
``python/mxnet/operator.py`` over ``src/operator/custom/custom.cc``): users
define a ``CustomOp`` (``forward``/``backward`` over NDArrays) and a
``CustomOpProp`` (arguments, outputs, shape and type inference), register
the prop by name, and call ``mx.nd.Custom(*data, op_type=name)``.

The body runs on the inputs' device, as NDArray ops or ``mx.rtc`` kernel
launches, with recording off; nothing is copied to the host (the JAX
package runs it on numpy copies). Under ``autograd.record()`` the call is
one node of torch's graph (``autograd._Bridge``, as ``autograd.Function``
is): its forward runs ``CustomOp.forward`` into new output arrays, its
backward runs ``CustomOp.backward`` into new input-gradient arrays, with
``req`` ``"write"`` and MXNet's ``assign``; as in MXNet the arrays are not
cleared first, so the op writes all of each. The inputs' shapes must be
those ``infer_shape`` returns. A prop made with ``need_top_grad=False`` (a
loss layer) still receives the output gradients, and is free to ignore
them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

__all__ = ["CustomOp", "CustomOpProp", "get_prop", "invoke_custom",
           "register"]


class CustomOp:
    """Base class for custom operators (reference ``mx.operator.CustomOp``).
    Subclass and implement ``forward``/``backward``."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Store ``src`` into ``dst`` by ``req``: ``"write"`` (or
        ``"inplace"``) replaces, ``"add"`` accumulates, ``"null"`` skips
        (reference ``CustomOp.assign``)."""
        if req == "null":
            return
        if req == "add":
            dst += src
        else:
            dst._set_data(src)


class CustomOpProp:
    """Shape/type/argument declaration (reference ``CustomOpProp``)."""

    def __init__(self, need_top_grad: bool = True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps


_REGISTRY: Dict[str, type] = {}


def register(op_type: str):
    """Decorator registering a CustomOpProp subclass (reference
    ``mx.operator.register``)."""

    def deco(prop_cls):
        _REGISTRY[op_type] = prop_cls
        return prop_cls

    return deco


def get_prop(op_type: str) -> Optional[type]:
    return _REGISTRY.get(op_type)


class _Runner:
    """One call of a custom op: its operator, output shapes and types; the
    body of :class:`autograd._Bridge` when the call is recorded."""

    def __init__(self, op, out_shapes, out_dtypes, is_train):
        self.op = op
        self.out_shapes = out_shapes
        self.out_dtypes = out_dtypes
        self.is_train = is_train

    def forward(self, tensors):
        from . import autograd
        from .ndarray.ndarray import NDArray

        dev = tensors[0].device
        outs = [NDArray(torch.empty(tuple(s), dtype=d, device=dev))
                for s, d in zip(self.out_shapes, self.out_dtypes)]
        with autograd._RecordingStateScope(False, None):
            self.op.forward(is_train=self.is_train, req=["write"] * len(outs),
                            in_data=[NDArray(t) for t in tensors],
                            out_data=outs, aux=[])
        return [o._data for o in outs]

    def run_forward(self, tensors):
        outs = self.forward(tensors)
        return outs, (*tensors, *outs)

    def run_backward(self, out_grads, saved):
        from . import autograd
        from .ndarray.ndarray import NDArray

        ins, outs = saved[:-len(out_grads)], saved[-len(out_grads):]
        in_grads = [NDArray(torch.empty_like(t)) for t in ins]
        with autograd._RecordingStateScope(False, None):
            self.op.backward(req=["write"] * len(in_grads),
                             out_grad=[NDArray(g) for g in out_grads],
                             in_data=[NDArray(t) for t in ins],
                             out_data=[NDArray(t) for t in outs],
                             in_grad=in_grads, aux=[])
        return [g._data for g in in_grads]


def invoke_custom(op_type: str, inputs, kwargs):
    """Run a registered custom op over NDArray inputs (the ``nd.Custom``
    entry); differentiable through the user's ``backward``."""
    from . import autograd
    from .base import resolve_dtype
    from .ndarray.ndarray import NDArray, _operands

    prop_cls = _REGISTRY.get(op_type)
    if prop_cls is None:
        raise ValueError(f"no custom op registered as {op_type!r}")
    if not inputs:
        raise ValueError(f"Custom[{op_type}] needs at least one input")
    prop = prop_cls(**kwargs)
    inputs = _operands(inputs)
    in_shapes = [x.shape for x in inputs]
    in_dtypes = [x.dtype for x in inputs]
    want_shapes, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
    want_shapes = [tuple(s) for s in want_shapes]
    if want_shapes != [tuple(s) for s in in_shapes]:
        raise ValueError(f"Custom[{op_type}]: the inputs have shapes "
                         f"{in_shapes}, infer_shape wants {want_shapes}")
    _, out_dtypes, _ = prop.infer_type(list(in_dtypes))
    op = prop.create_operator(inputs[0].ctx, in_shapes, in_dtypes)
    runner = _Runner(op, out_shapes, [resolve_dtype(d) for d in out_dtypes],
                     autograd.is_training())
    tensors = [x._data for x in inputs]
    if autograd.is_recording() and any(t.requires_grad for t in tensors):
        outs = autograd._Bridge.apply(runner, *tensors)
    else:
        outs = runner.forward(tensors)
    outs = [NDArray(o) for o in outs]
    return outs[0] if len(outs) == 1 else tuple(outs)
