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

**Weight hot-swap** (``stage_params``/``commit_params``). The reference
flips a list of device buffers; here every graph reads the block's own
parameter tensors at the addresses it captured, so a new version is
copied *into* them. Staging (off the hot path) puts each changed value on
the device and leaves each unchanged one (by content digest) alone; the
commit copies the staged values into the resident tensors in place,
under the lock replays take and on the stream they run on: a batch that
already replayed keeps the old values, the next sees the new ones whole.
A parameter is never rebound (``p.data = ...``, or a new tensor in the
list): every graph would go on reading the old storage, with no error.

**Persistent artifacts** (``artifact_dir``): a CUDA graph cannot be
serialized, so each signature's artifact is the kernel libraries its
capture loaded (``serving/artifacts.py``); a replica pointed at the store
installs them and captures again with no ``nvcc`` build. ``compiles``
counts kernel builds, ``captures`` the graphs.

Not ported yet: the profiler scopes and telemetry of a capture.
"""

from __future__ import annotations

import gc
import hashlib
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import autograd
from ..config import config
from ..device import Context, resolve
from ..ops import _build as _kernels
from ..parallel import superstep
from .artifacts import (ArtifactStore, environment_fingerprint,
                        kernel_payload, params_fingerprint,
                        serialization_supported)
from .metrics import ServingMetrics

__all__ = ["DEFAULT_BUCKETS", "BucketedExecutorCache", "block_apply_fn",
           "pure_method_runner", "release_device_memory", "reserved_bytes",
           "stage_weight_swap"]

logger = logging.getLogger("mxtpu_torch.serving")

# powers of two up to a modest ceiling: small buckets keep padding waste
# low for singleton traffic, the 2x spacing keeps the graph count (and the
# warm-up's captures) logarithmic in the largest batch
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _as_tensor(value) -> torch.Tensor:
    """A published value as a tensor of its exact type: a torch tensor as
    it is (on its device), a numpy array through ``torch.from_numpy`` (a
    bfloat16 array of the ``ml_dtypes`` kind through its raw 16-bit words:
    numpy itself has no bfloat16)."""
    if isinstance(value, torch.Tensor):
        return value.detach()
    arr = np.ascontiguousarray(value)
    if not arr.flags.writeable:       # torch refuses to alias a read-only
        arr = arr.copy()              # buffer
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _digest(value) -> str:
    """Content digest of one parameter value over its raw bytes (a numpy
    array, or a torch tensor on any device, bf16 included): the aliasing
    test of weight hot-swap (an equal digest leaves the resident tensor
    alone). A device tensor comes to the host on the current stream."""
    t = _as_tensor(value).reshape(-1).contiguous().cpu()
    raw = t.view(torch.uint8) if t.element_size() > 1 else t
    return hashlib.sha1(raw.numpy()).hexdigest()


_staging_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


def _staging_stream(device: torch.device):
    """A device's stream for weight staging: its copies to and from the
    host never queue behind the replays on the serving stream."""
    s = _staging_streams.get(device)
    if s is None:
        s = _staging_streams[device] = torch.cuda.Stream(device)
    return s


class _StagedSwap:
    """A fully staged weight version: each changed parameter's new value
    already on the device (``updates``: ``(position, tensor)``), unchanged
    ones left out (they keep the resident tensor). Built off the hot path
    by :meth:`BucketedExecutorCache.stage_params`; committed by
    :meth:`~BucketedExecutorCache.commit_params`, which copies the values
    into the resident tensors in place and drops them."""

    __slots__ = ("updates", "digests", "stats")

    def __init__(self, updates: List[Tuple[int, torch.Tensor]],
                 digests: List[str], stats: Dict[str, int]):
        self.updates = updates
        self.digests = digests
        self.stats = stats


def stage_weight_swap(params: List[torch.Tensor],
                      digests: Optional[List[str]],
                      param_names: Optional[List[str]], new,
                      allow_partial: bool = True,
                      model: str = "model") -> _StagedSwap:
    """Stage a new weight version against the resident parameter tensors:
    the aliasing core shared by :class:`BucketedExecutorCache` and the
    decode session. ``new`` is a ``{structural_name: value}`` dict (needs
    ``param_names``) or a full positional sequence; a value is a numpy
    array or a torch tensor (a bf16 parameter takes a bf16 tensor). Shapes
    and dtypes must match (the captured graphs are signature-frozen).
    Unchanged values (by content digest) are counted ``aliased`` and left
    alone; changed ones are put on the device here, off the hot path, so
    the commit is one device-to-device copy each."""
    if isinstance(new, dict):
        if param_names is None:
            raise ValueError(
                "named weight publish needs recorded structural param "
                "names (build the cache via from_block); pass a "
                "positional sequence instead")
        index = {n: i for i, n in enumerate(param_names)}
        unknown = sorted(k for k in new if k not in index)
        if unknown:
            raise ValueError(
                f"unknown parameter(s) {unknown[:5]} for model "
                f"{model}; served names: {param_names[:5]}...")
        if not allow_partial and len(new) != len(param_names):
            missing = sorted(set(param_names) - set(new))
            raise ValueError(
                f"partial weight publish refused; missing {missing[:5]}")
        items = [(index[k], v) for k, v in new.items()]
    else:
        seq = list(new)
        if len(seq) != len(params):
            raise ValueError(
                f"positional publish must cover all {len(params)} "
                f"params, got {len(seq)}")
        items = list(enumerate(seq))
    devices = {p.device for p in params if p.device.type == "cuda"}
    if len(devices) == 1:
        # every copy of the staging on a stream of its own, so the
        # replays of the live version never wait behind it
        (dev,) = devices
        stream = _staging_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            staged = _stage(params, digests, param_names, items)
        stream.synchronize()                 # staged before the commit
        return staged
    return _stage(params, digests, param_names, items)


def _stage(params, digests, param_names, items) -> _StagedSwap:
    if digests is None:
        # first swap: digest the live version once (off the hot path);
        # afterwards the digests follow each commit
        digests = [_digest(p) for p in params]
    digests = list(digests)
    updates: List[Tuple[int, torch.Tensor]] = []
    aliased = 0
    for i, v in items:
        t = _as_tensor(v)
        old = params[i]
        if tuple(t.shape) != tuple(old.shape) or t.dtype != old.dtype:
            name = param_names[i] if param_names else f"#{i}"
            raise ValueError(
                f"param {name}: published {_dtype_name(t.dtype)}"
                f"{tuple(t.shape)} vs served {_dtype_name(old.dtype)}"
                f"{tuple(old.shape)} — captured graphs are "
                f"signature-frozen; an architecture change needs a new "
                f"server, not a weight swap")
        d = _digest(t)
        if d == digests[i]:
            aliased += 1              # keep the resident tensor as it is
            continue
        updates.append((i, t.to(device=old.device, copy=True)))
        digests[i] = d
    n = len(params)
    stats = {"params": n, "aliased": aliased, "updated": len(updates),
             "carried": n - aliased - len(updates)}
    return _StagedSwap(updates, digests, stats)


def reserved_bytes(device: torch.device) -> int:
    """What the card has reserved for this process once the caching
    allocator gave back what it holds unused: the caller holds the capture
    lock (``superstep._capture_lock``), so no capture is under way. The
    difference across a capture is what its graph keeps (its pool, its
    static buffers). This accounting is the port's own: the reference
    counts parameters and KV caches only, while here a model's graphs pin
    more than its parameters (a ResNet-50's six bucket graphs reserve
    several times its 100 MB of weights)."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(device)


def release_device_memory() -> None:
    """Give the card back what the caching allocator holds unused (a
    dropped model's graph pools and activations). Runs under the capture
    lock: ``torch.cuda.empty_cache`` during another thread's capture
    would invalidate it."""
    gc.collect()
    if not torch.cuda.is_available():
        return
    with superstep._capture_lock:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _leaves(out) -> Tuple[torch.Tensor, ...]:
    if isinstance(out, (tuple, list)):
        return tuple(leaf for o in out for leaf in _leaves(o))
    return (out,)


def pure_method_runner(block) -> Tuple[Callable, List[torch.Tensor]]:
    """``(run, params)``: ``run(method, *arrays)`` applies any method of
    ``block`` (``block`` itself for its forward) in inference mode and
    returns its outputs as a flat tuple of tensors; ``params`` are the
    block's resident parameter tensors (running statistics included), and
    ``run.param_names`` their structural names from the same walk (the
    names ``parallel.collect_params`` gives, which are the JAX package's:
    a dict of its ``collect_params`` publishes straight into the port).

    Inference mode is recording and training off (``autograd.pause``):
    torch's grad mode off, so nothing saves tensors for a backward, dropout
    off, and BatchNorm on its running statistics without updating them. A
    floating input is cast to the type of the block's floating parameters,
    so a net cast to bf16 serves fp32 requests. Unlike the JAX package's
    runner, the parameters are not an argument: the block reads its own,
    which is what a captured graph needs (fixed addresses). Shared by the
    batch forward (:func:`block_apply_fn`) and the decode tier's
    prefill."""
    named = list(block.named_parameters())
    params = [p for _, p in named]
    floats = {p.dtype for p in params if p.is_floating_point()}
    dtype = floats.pop() if len(floats) == 1 else None

    def run(method, *arrays):
        if dtype is not None:
            arrays = [a.to(dtype) if a.is_floating_point()
                      and a.dtype != dtype else a for a in arrays]
        with autograd.pause(train_mode=False):
            return _leaves(method(*arrays))

    run.param_names = [n for n, _ in named]
    return run, params


def block_apply_fn(block) -> Tuple[Callable, List[torch.Tensor]]:
    """``(apply_fn, params)``: ``apply_fn(x)`` is ``block``'s forward in
    inference mode (one tensor, or a tuple for a multi-output block), the
    single-forward case of :func:`pure_method_runner`."""
    run, params = pure_method_runner(block)

    def apply_fn(x):
        out = run(block, x)
        return out[0] if len(out) == 1 else out

    apply_fn.param_names = run.param_names
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
    :meth:`from_block`, which records their structural names
    (``param_names``) for a named weight publish.

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
    ``donate`` is accepted for the reference's signature: a graph's input
    is already one static buffer, rewritten by each call, which is what
    donation buys there. ``artifact_dir`` (default
    ``MXTPU_SERVING_ARTIFACT_DIR``; ``""`` disables) is the persistent
    artifact store; ``model_version`` rides its guard.
    """

    def __init__(self, apply_fn: Callable, params: Sequence[torch.Tensor],
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 donate: Optional[bool] = None,
                 metrics: Optional[ServingMetrics] = None,
                 name: str = "model", pass_count: bool = False,
                 depad: bool = True, ctx: Optional[Context] = None,
                 share_pool: bool = True,
                 artifact_dir: Optional[str] = None,
                 model_version: str = ""):
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
        self._donate = bool(donate)
        self._pass_count = bool(pass_count)
        self._depad = bool(depad)
        self._share_pool = bool(share_pool)
        self._pool = None
        self._execs: Dict[Tuple, object] = {}
        self._building: Dict[Tuple, threading.Event] = {}
        self._lock = threading.Lock()       # the executable table
        self._run_lock = threading.Lock()   # replays and their outputs
        self._stream = None                 # the stream replays run on
        self.metrics = metrics if metrics is not None \
            else ServingMetrics(name)
        # weight hot-swap: structural names (set by from_block) map a
        # published checkpoint onto parameter positions; the digests are
        # computed at the first stage_params, then follow each commit
        self.param_names: Optional[List[str]] = None
        self._digests: Optional[List[str]] = None
        #: milliseconds the last commit held the replay lock
        self.last_commit_ms = 0.0
        #: device bytes the graphs (their pool, static buffers) reserve,
        #: measured at each capture (:func:`reserved_bytes` across it)
        self.graph_bytes = 0
        if artifact_dir is None:
            artifact_dir = str(config.get("MXTPU_SERVING_ARTIFACT_DIR") or "")
        self._store = ArtifactStore(artifact_dir) \
            if artifact_dir and serialization_supported() else None
        self._guard = dict(
            environment_fingerprint(), model=str(name),
            fingerprint=params_fingerprint(self._params),
            version=str(model_version), pass_count=self._pass_count)

    @classmethod
    def from_block(cls, block, ctx: Optional[Context] = None,
                   **kwargs) -> "BucketedExecutorCache":
        kwargs.setdefault("name", getattr(block, "name", "") or "model")
        apply_fn, params = block_apply_fn(block)
        cache = cls(apply_fn, params, ctx=ctx, **kwargs)
        # the names ride the runner: the same walk the tensors came from
        cache.param_names = list(apply_fn.param_names)
        return cache

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
        """The executable of one bucketed signature, built on a miss (its
        kernel libraries from the artifact store where warm, then the
        capture). Concurrent callers of one signature build it once: one
        thread builds, the rest wait (and take over if it failed)."""
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

    @staticmethod
    def _logical_key(key: Tuple) -> Dict[str, Any]:
        bucket, feat, dtype_name = key
        return {"component": "bucket", "bucket": int(bucket),
                "features": tuple(feat), "dtype": dtype_name}

    def _build(self, key: Tuple, installed: bool = False):
        """Artifact, then capture, for one missed signature (one thread a
        key runs this). ``installed``: the caller installed its artifact."""
        bucket, feat, dtype_name = key
        self.metrics.cache_miss()
        if self._store is not None and not installed:
            t0 = time.perf_counter()
            payload, reason = self._store.load(
                self.name, self._logical_key(key), self._guard)
            if payload is not None:
                installed = True
                self.metrics.observe_deserialize(time.perf_counter() - t0)
            else:
                self.metrics.artifact_miss(
                    refused=reason.startswith("refused"))
        if self.device.type != "cuda":
            ex = _EagerExecutable(self._apply, bucket, self.device,
                                  self._pass_count)
            kernels = set()
        else:
            t0 = time.perf_counter()
            # a capture and a replay of one cache never overlap: its graphs
            # share a memory pool, and a replay's outputs are read after it;
            # what the card reserves across the capture is the graph's
            with superstep._capture_lock:
                r0 = reserved_bytes(self.device)
                with self._run_lock, _kernels.recorded() as rec:
                    if self._pool is None and self._share_pool:
                        self._pool = torch.cuda.graph_pool_handle()
                    ex = _GraphExecutable(self._apply, bucket, feat,
                                          np.dtype(dtype_name), self.device,
                                          self._pass_count, self._pool)
                self.graph_bytes += reserved_bytes(self.device) - r0
            if rec["built"]:
                self.metrics.observe_compile(rec["build_seconds"],
                                             len(rec["built"]))
            self.metrics.observe_capture(
                time.perf_counter() - t0 - rec["build_seconds"])
            kernels = rec["loaded"]
        ex.kernels = frozenset(kernels)
        if self._store is not None and not installed:
            try:
                self._store.save(self.name, self._logical_key(key),
                                 self._guard, kernel_payload(ex.kernels))
            except OSError as e:   # persistence is an optimization: a full
                # disk must not break serving
                logger.warning("artifact persist failed for %s %s: %s",
                               self.name, key, e)
        return ex

    def warmup(self, feature_shape: Tuple[int, ...], dtype="float32",
               buckets: Optional[Sequence[int]] = None) -> None:
        """Build every bucket for one input signature ahead of traffic, one
        at a time on the calling thread. ``MXTPU_SERVING_WARMUP_THREADS``
        has no counterpart here: a capture compiles nothing, and the
        kernel builds already run in parallel (``ops/_build.build_all``)."""
        t0 = time.perf_counter()
        for b in (buckets if buckets is not None else self.buckets):
            self.executable(b, tuple(feature_shape), dtype)
        self.metrics.observe_warmup(time.perf_counter() - t0)

    def param_bytes(self) -> int:
        """Device bytes held by the resident parameters."""
        return sum(p.numel() * p.element_size() for p in self._params)

    def resident_bytes(self) -> int:
        """Device bytes the cache pins: its parameters and its graphs'
        memory (:attr:`graph_bytes`)."""
        return self.param_bytes() + max(0, self.graph_bytes)

    def release(self) -> None:
        """Drop every executable (the graphs, their static buffers and
        outputs, the shared pool) and give the memory back to the card
        (:func:`release_device_memory`). The next call captures again."""
        with self._lock, self._run_lock:
            self._execs.clear()
            self._pool = None
            self.graph_bytes = 0
        release_device_memory()

    # -- persistent artifacts -------------------------------------------------
    def save_artifacts(self, directory: Optional[str] = None) -> int:
        """Store every live executable's kernel libraries in the artifact
        store (``directory`` overrides the configured one); returns the
        count written. A replica pointed at the same directory then warms
        with no ``nvcc`` build."""
        store = self._resolve_store(directory)
        with self._lock:
            snap = dict(self._execs)
        for key, ex in snap.items():
            store.save(self.name, self._logical_key(key), self._guard,
                       kernel_payload(ex.kernels))
        return len(snap)

    def load_artifacts(self, directory: Optional[str] = None) -> int:
        """Install every stored artifact of this model whose guard matches
        and capture its signature (no feature signature needed up front);
        returns the count loaded. Mismatched artifacts are skipped: the
        next :meth:`warmup` builds and persists again."""
        store = self._resolve_store(directory)
        loaded = 0
        t_last = time.perf_counter()
        for logical, _ in store.load_all(self.name, self._guard):
            bucket = int(logical.get("bucket", 0))
            if logical.get("component") != "bucket" \
                    or bucket not in self.buckets:
                t_last = time.perf_counter()
                continue
            key = (bucket, tuple(logical.get("features", ())),
                   str(logical.get("dtype")))
            with self._lock:
                fresh = key not in self._execs and key not in self._building
            if fresh:
                self.metrics.observe_deserialize(time.perf_counter() - t_last)
                ex = self._build(key, installed=True)
                with self._lock:
                    self._execs.setdefault(key, ex)
                loaded += 1
            t_last = time.perf_counter()
        return loaded

    def _resolve_store(self, directory: Optional[str]) -> ArtifactStore:
        if directory is not None:
            return ArtifactStore(directory)
        if self._store is None:
            raise RuntimeError(
                "no artifact store configured: pass artifact_dir= (or "
                "set MXTPU_SERVING_ARTIFACT_DIR), or pass an explicit "
                "directory")
        return self._store

    # -- live weight hot-swap -------------------------------------------------
    def stage_params(self, new, allow_partial: bool = True) -> _StagedSwap:
        """Stage a new weight version off the hot path: ``new`` is a
        ``{structural_name: value}`` dict (needs :meth:`from_block`, which
        records the names) or a full positional sequence; a value is a
        numpy array or a torch tensor. Shapes and dtypes must match the
        resident parameters (the graphs are signature-frozen: a mismatch
        is an architecture change, not a weight update). Unchanged values
        (by content digest) are left alone; changed ones go to the device
        here (:func:`stage_weight_swap`)."""
        return stage_weight_swap(self._params, self._digests,
                                 self.param_names, new,
                                 allow_partial=allow_partial,
                                 model=self.name)

    def commit_params(self, staged: _StagedSwap) -> Dict[str, int]:
        """Make the staged version live: copy each staged value into its
        resident tensor in place (the graphs read them at their captured
        addresses), under the replay lock and on the stream the replays
        run on, then wait for the copies and free the staged tensors. A
        batch that already replayed kept the old values; the next sees the
        new ones whole: old or new, never a mix. No graph is captured
        again. :attr:`last_commit_ms` is how long the lock was held."""
        with self._run_lock:
            t0 = time.perf_counter()
            self._copy_in(staged)
            self.last_commit_ms = (time.perf_counter() - t0) * 1e3
        self._digests = staged.digests
        staged.updates = []
        self.metrics.observe_swap()
        return dict(staged.stats)

    def _copy_in(self, staged: _StagedSwap) -> None:
        """The commit's copies (the caller holds what keeps replays out)."""
        if self.device.type != "cuda":
            with torch.no_grad():
                for i, t in staged.updates:
                    self._params[i].copy_(t)
            return
        stream = self._stream or torch.cuda.current_stream(self.device)
        with torch.no_grad(), torch.cuda.stream(stream):
            for i, t in staged.updates:
                self._params[i].copy_(t)
        stream.synchronize()

    def swap_params(self, new, allow_partial: bool = True) -> Dict[str, int]:
        """``commit_params(stage_params(new))``: the one-call form."""
        return self.commit_params(self.stage_params(new, allow_partial))

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
            if self.device.type == "cuda":
                self._stream = torch.cuda.current_stream(self.device)
            out = ex.run(arr, n)
            if self._depad:
                # copied out before the next replay can overwrite them
                out = tuple(_host_rows(o, n) for o in out)
        return out[0] if len(out) == 1 else out
