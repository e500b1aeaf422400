"""Superstep: K training steps per host dispatch, on CUDA graphs.

Counterpart of the JAX package's ``parallel/superstep.py``. There one XLA
executable runs a ``lax.fori_loop`` over a stacked ``[K, ...]`` window of
K distinct batches: one host dispatch for K steps, the per-step losses
back as a ``[K]`` array, the same loss stream as K ``step()`` calls. The
counterpart of that executable here is a CUDA graph: :func:`capture_steps`
records K step bodies in sequence, each reading its slice of a static
window buffer, and each window costs one ``graph.replay()``.

What a capture needs, and what this module does for it:

* a warm-up: the step body runs once on a side stream before the capture
  (lazily created state, the side stream's cuBLAS workspace, the TMA
  encoder of the kernels, the context of torch's autograd thread), and
  the state it changed is put back, so the warm-up trains nothing;
* a private memory pool for the graph (torch gives each graph its own),
  and static buffers the engine fills with ``copy_`` before each replay;
* the package's generators registered with the graph, so each replay
  draws fresh dropout masks and advances each generator exactly as the K
  eager steps would (``random.reserve_keys``/``rollback_keys`` put them
  back if a dispatch fails);
* the kernel launch counters kept exact (``ops.launches``): a capture
  runs nothing and counts into its own recording, and every replay adds
  what the capture recorded.

The three engines, ``SPMDTrainer.run_superstep``/``run_steps``
(``parallel/spmd.py``), the gluon ``SuperStep`` (``gluon/trainer.py``) and
the decode step of ``serving.DecodeSession``, pass their step body and
state to one :class:`GraphCache`, keyed by the input signature, K and the
state's addresses. :func:`step_path` chooses a trainer's path: the graph on
a CUDA device unless ``MXTPU_SUPERSTEP`` is off; else the same step body
is called K times. A capture or a replay that fails restores the
generators and raises: it never turns into the eager loop.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, List, Sequence

import numpy as np
import torch

from .. import random as _random
from ..ops import launches as _launches

__all__ = ["GraphCache", "PairGraph", "StepGraph", "as_torch",
           "capture_pair", "capture_steps",
           "device_scalars", "dispatch", "signature", "slice_window",
           "stack_window", "step_path", "superstep_enabled",
           "superstep_window", "window_len"]


def as_torch(x) -> torch.Tensor:
    """An NDArray's tensor, or any array-like as a (host) tensor: the
    shared input normalization of both engines."""
    from ..ndarray import NDArray

    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x))


def _cfg(name: str):
    from ..config import config

    return config.get(name)


def superstep_enabled() -> bool:
    """The ``MXTPU_SUPERSTEP`` knob: ``auto``/``1`` (default) capture the K
    step bodies of a window in one CUDA graph wherever the step is
    fusable; ``0``/``off`` runs the same K steps eagerly (the same loss
    stream, K host dispatches)."""
    return str(_cfg("MXTPU_SUPERSTEP")).strip().lower() not in (
        "0", "off", "false", "no", "never")


def superstep_window() -> int:
    """Default window size K (``MXTPU_SUPERSTEP_WINDOW``)."""
    return max(1, int(_cfg("MXTPU_SUPERSTEP_WINDOW")))


def step_path(device: torch.device) -> str:
    """``"graph"`` (K step bodies captured in one CUDA graph, one replay
    a window) on a CUDA device, or ``"eager"`` (the step body called K
    times): on the CPU, where the caller put the parameters, and when
    ``MXTPU_SUPERSTEP`` is off."""
    if torch.device(device).type == "cuda" and superstep_enabled():
        return "graph"
    return "eager"


def slice_window(arrays: Sequence[torch.Tensor], i: int) -> List[Any]:
    """Batch ``i`` of a stacked window (a view of each leaf)."""
    return [a[i] for a in arrays]


def window_len(arrays: Sequence[Any]) -> int:
    """K of a stacked window: the (common) leading dim of the leaves."""
    ks = {int(a.shape[0]) for a in arrays if hasattr(a, "shape")}
    if len(ks) != 1:
        raise ValueError(
            f"window leaves disagree on the leading (step) dim: "
            f"{sorted(ks)} — stack K whole batches per leaf")
    return ks.pop()


def stack_window(batches: Sequence[Any]) -> List[np.ndarray]:
    """Host-side stack of K same-shape batches into ``[K, ...]`` leaves
    (one numpy array per batch position)."""
    if not batches:
        raise ValueError("empty window")
    first = batches[0]
    parts = first if isinstance(first, (tuple, list)) else (first,)
    out = []
    for j in range(len(parts)):
        out.append(np.stack([
            np.asarray(b[j] if isinstance(b, (tuple, list)) else b)
            for b in batches]))
    return out


def device_scalars(values: Sequence[float],
                   device: torch.device) -> torch.Tensor:
    """``values`` as one fp32 vector on ``device`` (a CUDA device: one
    copy from pinned memory, queued on the stream without waiting)."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float32)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@contextlib.contextmanager
def dispatch(device: torch.device):
    """Around an engine's graph path (capture, buffer fills, replay): if
    it raises, every generator of ``device`` goes back to where it stood
    and the error propagates (the eager loop never stands in for a failed
    capture). The launch counters need nothing: a capture counts into its
    recording, which only a replay adds."""
    reserved = _random.reserve_keys(device)
    try:
        yield
    except BaseException:
        _random.rollback_keys(reserved)
        raise


_side_streams = {}


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream of ``device`` on which every warm-up and
    capture runs (PyTorch keeps a cuBLAS workspace per stream for the
    life of the process)."""
    s = _side_streams.get(device)
    if s is None:
        s = _side_streams[device] = torch.cuda.Stream(device)
    return s


class StepGraph:
    """K step bodies captured in one CUDA graph. ``outputs`` are the
    tensors the bodies returned: static, rewritten by every replay."""

    def __init__(self, graph, outputs: List[torch.Tensor], counted,
                 generators, device: torch.device):
        self.graph = graph
        self.outputs = outputs
        self.counted = counted          # launches the capture recorded
        self._generators = generators
        self.device = device
        self.replays = 0

    def current(self) -> bool:
        """False once ``random.seed`` replaced a generator the graph
        registered (the engine captures again)."""
        return [id(g) for g in self._generators] \
            == [id(g) for g in _random.generators_of(self.device)]

    def replay(self) -> List[torch.Tensor]:
        """Run the K captured steps: one ``graph.replay()``; the counters
        gain what the capture recorded. Call it inside :func:`dispatch`."""
        self.graph.replay()
        _launches.add(self.counted)
        self.replays += 1
        return self.outputs


#: one capture (and its warm-up) at a time in the process: they all run
#: on the device's one side stream, whichever thread asks. Reentrant: a
#: caller that measures what its captures reserve (the serving warm-up), or
#: releases cached memory (``torch.cuda.empty_cache`` must not run during
#: a capture), holds it around them
_capture_lock = threading.RLock()


def capture_steps(body: Callable[[int], torch.Tensor], k: int,
                  state: Sequence[torch.Tensor], device: torch.device,
                  capture_error_mode: str = "global",
                  pool=None) -> StepGraph:
    """Capture ``body(0) ... body(k-1)`` in one CUDA graph.

    ``body(i)`` runs step ``i`` on the engine's static buffers and
    returns a tensor (the step's loss). ``state`` are the tensors it
    changes in place (parameters, optimizer states, running statistics):
    the warm-up's changes to them and its draws are undone, so the capture
    leaves the model as it found it (the warm-up's kernels ran, and
    count). The capture runs nothing and counts nothing; the caller
    replays. On a failure the state goes back too, and the error is
    raised: call it inside :func:`dispatch`, which puts back the
    generators. ``pool`` (``torch.cuda.graph_pool_handle()``) lets graphs
    share one memory pool: safe when each replay's outputs are consumed
    before another graph of the pool replays."""
    device = torch.device(device)
    saved = [t.detach().clone() for t in state]
    reserved = _random.reserve_keys(device)
    side = side_stream(device)
    try:
        with _capture_lock:
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                body(0)
            torch.cuda.current_stream(device).wait_stream(side)
            _put_back(state, saved)
            _random.rollback_keys(reserved)
            graph = torch.cuda.CUDAGraph()
            gens = _random.generators_of(device)
            for g in gens:
                graph.register_generator_state(g)
            with _launches.recording(side) as counted, \
                    torch.cuda.graph(graph, pool=pool, stream=side,
                                     capture_error_mode=capture_error_mode):
                outputs = [body(i) for i in range(k)]
    except BaseException:
        torch.cuda.synchronize(device)
        _put_back(state, saved)
        raise
    return StepGraph(graph, outputs, dict(counted), gens, device)


class PairGraph:
    """A forward and its backward captured as two CUDA graphs of one memory
    pool (the reference CachedOp's forward/backward pair; what
    ``torch.cuda.make_graphed_callables`` makes). :meth:`run_forward`
    copies the inputs into the static ones and replays the forward,
    :meth:`run_backward` copies the output gradients into the static ones
    and replays the backward, which leaves the gradients of the inputs
    that require one and of ``params`` (the parameters that require one)
    in static buffers. Between the two, the forward's saved tensors live
    in the pool: the pair is busy until its backward ran or the autograd
    node that owns it went away (:meth:`claim`)."""

    def __init__(self, fwd, bwd, static_in, outputs, out_diff, grad_outs,
                 grads, params, in_diff, single, counted, generators,
                 device):
        self.fwd, self.bwd = fwd, bwd
        self.static_in = static_in
        self.outputs = outputs
        self.out_diff = out_diff
        self.grad_outs = grad_outs
        self.grads = grads
        self.params = params
        self.in_diff = in_diff
        self.n_inputs = len(static_in)
        self.single = single
        self.counted = counted          # (forward's, backward's) launches
        self._generators = generators
        self.device = device
        self._owner = None
        self._done = True

    def current(self) -> bool:
        return [id(g) for g in self._generators] \
            == [id(g) for g in _random.generators_of(self.device)]

    def busy(self) -> bool:
        return not self._done and self._owner is not None \
            and self._owner() is not None

    def claim(self, node) -> None:
        self._owner = weakref.ref(node)
        self._done = False

    def run_forward(self, inputs) -> List[torch.Tensor]:
        for dst, src in zip(self.static_in, inputs):
            dst.detach().copy_(src.detach(), non_blocking=True)
        with dispatch(self.device):
            self.fwd.replay()
        _launches.add(self.counted[0])
        return [o.detach().clone() for o in self.outputs]

    def run_backward(self, grads) -> list:
        diff = [g for g, d in zip(grads, self.out_diff) if d]
        for dst, g in zip(self.grad_outs, diff):
            if g is None:
                dst.zero_()
            else:
                dst.copy_(g, non_blocking=True)
        self.bwd.replay()
        _launches.add(self.counted[1])
        self._done = True
        got = [None if g is None else g.clone() for g in self.grads]
        it = iter(got)
        return [next(it) if d else None for d in self.in_diff] + list(it)


def capture_pair(fn: Callable, inputs: Sequence[torch.Tensor],
                 params: Sequence[torch.Tensor],
                 state: Sequence[torch.Tensor],
                 device: torch.device, pool=None) -> PairGraph:
    """Capture ``fn(*inputs)`` (returning ``(tuple of tensors, single)``)
    and the backward of its outputs to the inputs that require a gradient
    and to ``params`` that do, as a :class:`PairGraph`. As
    :func:`capture_steps`: a warm-up of the forward and the backward on
    the side stream first, ``state`` (the tensors the forward writes, the
    running statistics) and the generators put back after it, the launch
    counters of each graph recorded; a failure puts the state back and
    raises. Call it inside :func:`dispatch`."""
    device = torch.device(device)
    static_in = [x.detach().clone().requires_grad_(x.requires_grad)
                 for x in inputs]
    in_diff = [x.requires_grad for x in inputs]
    wrt_params = [p for p in params if p.requires_grad]
    wrt = [x for x in static_in if x.requires_grad] + wrt_params
    saved = [t.detach().clone() for t in state]
    reserved = _random.reserve_keys(device)
    side = side_stream(device)

    def backward(outs, seeds):
        diff = [o for o in outs if o.requires_grad]
        return torch.autograd.grad(diff, wrt, seeds, allow_unused=True)

    try:
        with _capture_lock:
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side), torch.enable_grad():
                outs, _ = fn(*static_in)
                backward(outs, [torch.ones_like(o) for o in outs
                                if o.requires_grad])
            torch.cuda.current_stream(device).wait_stream(side)
            _put_back(state, saved)
            _random.rollback_keys(reserved)
            pool = torch.cuda.graph_pool_handle() if pool is None else pool
            fwd, bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            gens = _random.generators_of(device)
            for g in gens:
                fwd.register_generator_state(g)
            with _launches.recording(side) as counted_fwd, \
                    torch.cuda.graph(fwd, pool=pool, stream=side), \
                    torch.enable_grad():
                outs, single = fn(*static_in)
            out_diff = [o.requires_grad for o in outs]
            grad_outs = [torch.empty_like(o) for o in outs
                         if o.requires_grad]
            with _launches.recording(side) as counted_bwd, \
                    torch.cuda.graph(bwd, pool=pool, stream=side):
                grads = backward(outs, grad_outs)
    except BaseException:
        torch.cuda.synchronize(device)
        _put_back(state, saved)
        raise
    # the outputs keep no autograd graph (it holds the capture's nodes)
    return PairGraph(fwd, bwd, static_in, [o.detach() for o in outs],
                     out_diff, grad_outs,
                     list(grads), wrt_params, in_diff, single,
                     (dict(counted_fwd), dict(counted_bwd)), gens, device)


def signature(xs: Sequence[torch.Tensor]) -> tuple:
    """Shapes, strides and dtypes: what a captured graph's static input
    buffers fix."""
    return tuple((tuple(x.shape), x.stride(), str(x.dtype)) for x in xs)


#: graphs a :class:`GraphCache` keeps (the least recently used goes)
GRAPH_CACHE_SIZE = 4


class GraphCache:
    """An engine's captured step graphs, each with its static inputs.

    :meth:`run` keys a graph by the engine's ``key``, K, the inputs'
    :func:`signature` and the addresses of the state the graph writes;
    on a miss it copies the inputs into fresh static buffers (with the
    inputs' strides: a channels-last window keeps its memory format, so
    the graph runs the kernels the eager step runs) and captures the body
    (:func:`capture_steps`), on a hit it copies them into the graph's
    buffers; then it replays. A state that moved (a cast, a
    loaded optimizer state) captures again and drops the graphs of the
    old addresses; past :data:`GRAPH_CACHE_SIZE` graphs (a short tail
    window, a changed hyperparameter) the least recently used goes, with
    its memory pool."""

    def __init__(self, device: torch.device, size: int = GRAPH_CACHE_SIZE,
                 capture_error_mode: str = "global"):
        self.device = torch.device(device)
        self.size = max(1, int(size))
        self.capture_error_mode = capture_error_mode
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.captures = 0              # graphs captured (misses)

    def __len__(self) -> int:
        return len(self._entries)

    def graphs(self) -> List[StepGraph]:
        """The cached graphs, least recently used first."""
        return [graph for graph, _ in self._entries.values()]

    def run(self, key, inputs: Sequence[torch.Tensor],
            body_of: Callable[[List[torch.Tensor]], Callable[[int],
                                                             torch.Tensor]],
            k: int, state: Sequence[torch.Tensor],
            replays: int = 1) -> List[torch.Tensor]:
        """Copy ``inputs`` (host or device tensors) into the static
        buffers of the graph of ``body_of(static)`` over ``k`` steps
        (captured on a miss) and replay it ``replays`` times; returns the
        outputs of the last replay (static: valid until the next)."""
        inputs = list(inputs)
        addrs = tuple(t.data_ptr() for t in state)
        full = (key, k, signature(inputs), addrs)
        with dispatch(self.device):
            entry = self._entries.get(full)
            if entry is None or not entry[0].current():
                for old in [f for f in self._entries
                            if f == full or f[3] != addrs]:
                    del self._entries[old]
                static = [torch.empty_like(x, device=self.device)
                          for x in inputs]
                for dst, src in zip(static, inputs):
                    dst.copy_(src)
                graph = capture_steps(
                    body_of(static), k, state, self.device,
                    capture_error_mode=self.capture_error_mode)
                self.captures += 1
                entry = self._entries[full] = (graph, static)
                while len(self._entries) > self.size:
                    self._entries.popitem(last=False)
            else:
                for dst, src in zip(entry[1], inputs):
                    dst.copy_(src, non_blocking=True)
                self._entries.move_to_end(full)
            for _ in range(replays):
                outs = entry[0].replay()
        return outs


@torch.no_grad()
def _put_back(state, saved) -> None:
    for t, s in zip(state, saved):
        t.copy_(s)
