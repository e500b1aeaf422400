"""Bucketed-shape executor cache: one CUDA graph per batch bucket.

Counterpart of the JAX package's ``serving/executor_cache.py``. Online
traffic arrives with ragged batch sizes; incoming batches are padded up to
a small set of batch-size buckets, and one executable is kept per (bucket,
feature shape, dtype). There the executable is an XLA program compiled
ahead of time; here it is a CUDA graph captured on the first miss (or at
:meth:`BucketedExecutorCache.warmup`), with static input buffers that each
call fills before one ``graph.replay()``. The parameters stay the block's
own resident tensors, which every graph reads at their addresses: a call
moves only the request bytes.

The prefill of ``DecodeSession`` buckets on sequence length through the
same cache (``pass_count=True, depad=False``), as the JAX package's does.
On the CPU an executable is the eager apply: nothing is captured, and the
cache counts no capture.

Not ported yet: the persistent artifact store (a CUDA graph cannot be
serialized), weight hot-swap (``stage_params``/``commit_params``) and the
profiler scopes and telemetry of a capture.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import autograd
from ..device import Context, resolve
from ..parallel import superstep
from .metrics import ServingMetrics

__all__ = ["DEFAULT_BUCKETS", "BucketedExecutorCache", "block_apply_fn",
           "pure_method_runner"]

# powers of two up to a modest ceiling: small buckets keep padding waste
# low for singleton traffic, the 2x spacing keeps the graph count (and the
# warm-up's captures) logarithmic in the largest batch
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


def _leaves(out) -> Tuple[torch.Tensor, ...]:
    if isinstance(out, (tuple, list)):
        return tuple(leaf for o in out for leaf in _leaves(o))
    return (out,)


def pure_method_runner(block) -> Tuple[Callable, List[torch.Tensor]]:
    """``(run, params)``: ``run(method, *arrays)`` applies any method of
    ``block`` (``block`` itself for its forward) in inference mode and
    returns its outputs as a flat tuple of tensors; ``params`` are the
    block's resident parameter tensors (running statistics included).

    Inference mode is recording and training off (``autograd.pause``):
    torch's grad mode off, so nothing saves tensors for a backward, dropout
    off, and BatchNorm on its running statistics without updating them. A
    floating input is cast to the type of the block's floating parameters,
    so a net cast to bf16 serves fp32 requests. Unlike the JAX package's
    runner, the parameters are not an argument: the block reads its own,
    which is what a captured graph needs (fixed addresses). Shared by the
    batch forward (:func:`block_apply_fn`) and the decode tier's
    prefill."""
    params = list(block.parameters())
    floats = {p.dtype for p in params if p.is_floating_point()}
    dtype = floats.pop() if len(floats) == 1 else None

    def run(method, *arrays):
        if dtype is not None:
            arrays = [a.to(dtype) if a.is_floating_point()
                      and a.dtype != dtype else a for a in arrays]
        with autograd.pause(train_mode=False):
            return _leaves(method(*arrays))

    return run, params


def block_apply_fn(block) -> Tuple[Callable, List[torch.Tensor]]:
    """``(apply_fn, params)``: ``apply_fn(x)`` is ``block``'s forward in
    inference mode (one tensor, or a tuple for a multi-output block), the
    single-forward case of :func:`pure_method_runner`."""
    run, params = pure_method_runner(block)

    def apply_fn(x):
        out = run(block, x)
        return out[0] if len(out) == 1 else out

    return apply_fn, params


def _torch_dtype(np_dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros((), np_dtype)).dtype


def _host_rows(t: torch.Tensor, n: int) -> np.ndarray:
    """The first ``n`` rows of an output on the host (bf16 as float32,
    exactly: numpy has no bfloat16)."""
    rows = t[:n].cpu()
    if rows.dtype in (torch.bfloat16, torch.float16):
        rows = rows.float()
    return rows.numpy()


class _EagerExecutable:
    """A signature's executable on the CPU: the apply, called eagerly."""

    def __init__(self, apply_fn: Callable, bucket: int, device: torch.device,
                 pass_count: bool):
        self._apply = apply_fn
        self._bucket = bucket
        self._device = device
        self._pass_count = pass_count

    def run(self, arr: np.ndarray, n: int) -> Tuple[torch.Tensor, ...]:
        if n < self._bucket:
            pad = np.zeros((self._bucket - n,) + arr.shape[1:], arr.dtype)
            arr = np.concatenate([arr, pad], axis=0)
        x = torch.from_numpy(arr).to(self._device)
        if self._pass_count:
            return _leaves(self._apply(x, torch.tensor(n, dtype=torch.int32,
                                                       device=self._device)))
        return _leaves(self._apply(x))


class _GraphExecutable:
    """A signature's executable on a CUDA device: the apply captured in one
    CUDA graph over a static input buffer (and, with ``pass_count``, a
    static int32 device scalar holding the true row count, so one graph
    serves every count in its bucket). A call stages the padded batch in
    pinned host memory, copies it into the static buffer, writes the count
    and replays; the outputs are the graph's static tensors, rewritten by
    the next replay."""

    def __init__(self, apply_fn: Callable, bucket: int, feature_shape,
                 np_dtype: np.dtype, device: torch.device, pass_count: bool,
                 pool):
        shape = (bucket,) + tuple(feature_shape)
        dtype = _torch_dtype(np_dtype)
        self._host = torch.zeros(shape, dtype=dtype, pin_memory=True)
        self._x = torch.zeros(shape, dtype=dtype, device=device)
        self._n = torch.full((), bucket, dtype=torch.int32, device=device) \
            if pass_count else None
        self._copied = torch.cuda.Event()
        args = (self._x,) if self._n is None else (self._x, self._n)
        with superstep.dispatch(device):
            self.graph = superstep.capture_steps(
                lambda i: _leaves(apply_fn(*args)), 1, (), device,
                capture_error_mode="thread_local", pool=pool)

    def run(self, arr: np.ndarray, n: int) -> Tuple[torch.Tensor, ...]:
        self._copied.synchronize()       # the last copy left the staging
        host = self._host.numpy()
        host[:n] = arr
        if n < host.shape[0]:
            host[n:] = 0
        self._x.copy_(self._host, non_blocking=True)
        self._copied.record()
        if self._n is not None:
            self._n.fill_(n)
        return self.graph.replay()[0]


class BucketedExecutorCache:
    """Executables keyed by (bucket, feature shape, dtype): on a CUDA
    device one CUDA graph each, on the CPU the eager apply.

    ``apply_fn(x)`` takes a batch-leading tensor and returns tensors whose
    leading axis is the batch axis (one, or a tuple: de-padding slices
    every output to the true batch size); it reads the parameters it
    closes over (``params``, the block's resident tensors, counted by
    :meth:`param_bytes`): there is no parameter argument, since a graph
    reads them at fixed addresses. Build one from a Block with
    :meth:`from_block`.

    ``pass_count=True``: ``apply_fn(x, n)`` also receives the true
    un-padded leading count as an int32 device scalar (a static buffer:
    one graph serves every count in its bucket; prefill reads the last
    valid position's logits with it). ``depad=False``: the outputs come
    back as the executable left them, bucket-padded device tensors; on a
    CUDA device they are the graph's static outputs, valid until the next
    replay of any graph of this cache, so such a caller serializes its
    calls and consumes the outputs first (``DecodeSession`` does, under
    its lock).

    The graphs share one memory pool (``share_pool``): replays are
    serialized under the cache's lock, and each call copies its rows out
    before the next replay, so one graph's activations may reuse
    another's. ``ctx`` (default ``gpu(0)``) is where the parameters live.
    """

    def __init__(self, apply_fn: Callable, params: Sequence[torch.Tensor],
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 metrics: Optional[ServingMetrics] = None,
                 name: str = "model", pass_count: bool = False,
                 depad: bool = True, ctx: Optional[Context] = None,
                 share_pool: bool = True):
        self.name = name
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.device = resolve(ctx)
        self._params = list(params)
        wrong = {str(p.device) for p in self._params} - {str(self.device)}
        if wrong:
            raise ValueError(f"parameters live on {sorted(wrong)}, the cache "
                             f"on {self.device}; initialize or load the "
                             "block on the cache's ctx")
        self._apply = apply_fn
        self._pass_count = bool(pass_count)
        self._depad = bool(depad)
        self._pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" and share_pool else None
        self._execs: Dict[Tuple, object] = {}
        self._building: Dict[Tuple, threading.Event] = {}
        self._lock = threading.Lock()       # the executable table
        self._run_lock = threading.Lock()   # replays and their outputs
        self.metrics = metrics if metrics is not None \
            else ServingMetrics(name)

    @classmethod
    def from_block(cls, block, ctx: Optional[Context] = None,
                   **kwargs) -> "BucketedExecutorCache":
        kwargs.setdefault("name", getattr(block, "name", "") or "model")
        apply_fn, params = block_apply_fn(block)
        return cls(apply_fn, params, ctx=ctx, **kwargs)

    # -- bucket policy --------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest bucket that holds ``n`` requests."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"batch of {n} exceeds the largest bucket {self.buckets[-1]}; "
            "raise buckets= or split the batch")

    @property
    def max_batch_size(self) -> int:
        return self.buckets[-1]

    def compiled_signatures(self) -> List[Tuple]:
        """(bucket, feature_shape, dtype) keys with a live executable."""
        with self._lock:
            return sorted(self._execs)

    # -- capture --------------------------------------------------------------
    def executable(self, bucket: int, feature_shape: Tuple[int, ...],
                   dtype):
        """The executable of one bucketed signature, captured on a miss.
        Concurrent callers of one signature build it once: one thread
        captures, the rest wait (and take over if it failed)."""
        if bucket not in self.buckets:
            raise ValueError(f"{bucket} is not one of {self.buckets}")
        key = (bucket, tuple(int(d) for d in feature_shape),
               np.dtype(dtype).name)
        while True:
            with self._lock:
                ex = self._execs.get(key)
                if ex is not None:
                    self.metrics.cache_hit()
                    return ex
                ev = self._building.get(key)
                if ev is None:
                    ev = self._building[key] = threading.Event()
                    break
            ev.wait()
        try:
            ex = self._build(key)
            with self._lock:
                self._execs[key] = ex
            return ex
        finally:
            with self._lock:
                self._building.pop(key, None)
            ev.set()

    def _build(self, key: Tuple):
        bucket, feat, dtype_name = key
        self.metrics.cache_miss()
        if self.device.type != "cuda":
            return _EagerExecutable(self._apply, bucket, self.device,
                                    self._pass_count)
        t0 = time.perf_counter()
        # a capture and a replay of one cache never overlap: its graphs
        # share a memory pool, and a replay's outputs are read after it
        with self._run_lock:
            ex = _GraphExecutable(self._apply, bucket, feat,
                                  np.dtype(dtype_name), self.device,
                                  self._pass_count, self._pool)
        self.metrics.observe_compile(time.perf_counter() - t0)
        return ex

    def warmup(self, feature_shape: Tuple[int, ...], dtype="float32",
               buckets: Optional[Sequence[int]] = None) -> None:
        """Capture every bucket for one input signature ahead of traffic,
        one at a time on the calling thread. ``MXTPU_SERVING_WARMUP_THREADS``
        has no counterpart here: a capture compiles nothing, so there is
        nothing to spread over threads."""
        t0 = time.perf_counter()
        for b in (buckets if buckets is not None else self.buckets):
            self.executable(b, tuple(feature_shape), dtype)
        self.metrics.observe_warmup(time.perf_counter() - t0)

    def param_bytes(self) -> int:
        """Device bytes held by the resident parameters."""
        return sum(p.numel() * p.element_size() for p in self._params)

    # -- execution ------------------------------------------------------------
    def __call__(self, x):
        """Pad ``x`` (a batch-leading array) up to its bucket, run its
        executable and return the first n rows of each output on the host
        (``depad=False``: the padded device outputs)."""
        arr = np.asarray(x)
        if arr.ndim < 1:
            raise ValueError("input must have a leading batch axis")
        n = arr.shape[0]
        ex = self.executable(self.bucket_for(n), arr.shape[1:], arr.dtype)
        with self._run_lock:
            out = ex.run(arr, n)
            if self._depad:
                # copied out before the next replay can overwrite them
                out = tuple(_host_rows(o, n) for o in out)
        return out[0] if len(out) == 1 else out
