"""ModelServer: the serving front door over the batcher and the executor
cache.

Counterpart of the JAX package's ``serving/server.py`` (the MXNet Model
Server / ``Module.predict`` capability). A server owns one model end to
end: load it (a live gluon Block, a prebuilt ``BucketedExecutorCache``, or
a ``save_parameters`` checkpoint), capture one CUDA graph per batch bucket
(``warmup``), dispatch traffic through the dynamic batcher's worker
thread, and wind down (graceful ``drain`` with a forced close past its
timeout, or an immediate ``close``).

Usage::

    import incubator_mxnet_tpu_torch as mx

    net = mx.gluon.nn.Dense(10, in_units=784).initialize(ctx=mx.gpu(0))
    with mx.serving.ModelServer(net, max_wait_ms=2.0) as srv:
        srv.warmup((784,), "float32")
        probs = srv.submit(example).result()   # one example, no batch axis
        print(srv.stats()["latency_ms"]["p99"])

A new weight version goes live with no drain through
:meth:`ModelServer.publish_weights` (staged off the hot path, copied into
the resident tensors between batches); ``artifact_dir`` points the cache
at the persistent artifact store (the kernel libraries its graphs launch).

Not ported yet: ``from_exported`` (it waits for hybridize/export), the
sharded-checkpoint reader and the native C reader of
``load_block_checkpoint`` and ``load_weight_arrays``; the telemetry spans,
the health registry and the profiler scopes wait for the telemetry port.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import config
from ..device import Context
from .batcher import (DeadlineExceededError, DynamicBatcher, QueueFullError,
                      ServerClosedError)
from .executor_cache import DEFAULT_BUCKETS, BucketedExecutorCache
from .metrics import ServingMetrics

__all__ = ["DeadlineExceededError", "ModelServer", "QueueFullError",
           "ServerClosedError", "load_block_checkpoint",
           "load_weight_arrays"]

logger = logging.getLogger("mxtpu_torch.serving")


def load_block_checkpoint(block, params_path: str,
                          ctx: Optional[Context] = None,
                          use_native: Optional[bool] = None):
    """Load ``params_path`` into ``block`` on ``ctx`` (default ``gpu(0)``):
    the loader of every serving front door (``ModelServer.from_checkpoint``
    and ``DecodeSession.from_checkpoint``). ``params_path`` is an
    ``mx.nd.save`` checkpoint as ``Block.save_parameters`` writes it (in
    either package), read by ``nd.load``. A sharded training checkpoint
    (``{prefix}.manifest.json``) and the native C reader
    (``use_native=True``) raise ``NotImplementedError``: they wait for the
    sharded checkpoints (queue 1 item 10) and the native C library (item
    12) of the port."""
    _refuse_sharded(params_path)
    if use_native:
        raise NotImplementedError(
            "the native C checkpoint reader is not ported yet (ROADMAP "
            "queue 1 item 12): load through nd.load (use_native=None)")
    return block.load_parameters(params_path, ctx=ctx)


def _refuse_sharded(path: str) -> None:
    if path.endswith(".manifest.json") \
            or os.path.exists(path + ".manifest.json"):
        raise NotImplementedError(
            "sharded training checkpoints are not ported yet (ROADMAP "
            "queue 1 item 10): save_parameters() a dense checkpoint")


def load_weight_arrays(source, names=None):
    """Resolve a weight *source* to ``{structural_name: value}``: the
    block-less loader behind live weight hot-swap
    (:meth:`ModelServer.publish_weights`). ``source`` may be

    * a dict of numpy arrays or torch tensors (returned as it is, keys
      taken as structural names; a bf16 parameter takes a bf16 tensor, as
      numpy has no bfloat16),
    * a positional list/tuple of them (for a cache built without names),
    * an ``mx.nd.save`` checkpoint (``Block.save_parameters`` of either
      package), read by ``nd.load`` with ``arg:``/``aux:`` prefixes
      stripped. ``names`` (the reference's filter of a sharded read) is
      accepted; the caller filters.

    A sharded training checkpoint raises ``NotImplementedError`` (ROADMAP
    queue 1 item 10), as the native C reader would (item 12): the port has
    neither."""
    if isinstance(source, dict):
        return {k: v if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in source.items()}
    if isinstance(source, (list, tuple)):
        return [v if isinstance(v, torch.Tensor) else np.asarray(v)
                for v in source]
    path = str(source)
    _refuse_sharded(path)
    from ..device import cpu
    from ..ndarray import ndarray as _nd

    out = {}
    for k, v in _nd.load(path, ctx=cpu()).items():
        if k.startswith(("arg:", "aux:")):
            k = k.split(":", 1)[1]
        out[k] = v._data
    return out


def _stage_publish(cache: BucketedExecutorCache, source,
                   allow_partial: bool, model: str):
    """The first half of every weight publish: resolve the source, drop
    checkpoint tensors the served model does not read (an explicit dict
    keeps unknown keys, so staging refuses a typo loudly), and stage the
    swap, all off the hot path."""
    names = set(cache.param_names or []) or None
    arrays = load_weight_arrays(source, names=names)
    if names is not None and isinstance(arrays, dict) \
            and not isinstance(source, dict):
        arrays = {k: v for k, v in arrays.items() if k in names}
        if not arrays:
            # a checkpoint whose names match nothing served is a wrong
            # model or a typo'd path, not a weight update: committing it
            # would bump the version while the old weights keep serving
            raise ValueError(
                f"checkpoint {source!r} contains no tensors matching "
                f"{model}'s served parameter names "
                f"(e.g. {sorted(names)[:3]}); wrong checkpoint?")
    return cache.stage_params(arrays, allow_partial=allow_partial)


def _resolve_version(base, version):
    """Explicit version tag, else autobump an integer lineage."""
    if version is not None:
        return version
    return (base + 1) if isinstance(base, int) else 1


class ModelServer:
    """Serve one model with dynamic batching over one CUDA graph a batch
    bucket.

    ``model`` is a gluon Block (parameters initialized on ``ctx``, default
    ``gpu(0)``; pass ``mx.cpu()`` to serve eagerly on the CPU) or a prebuilt
    :class:`BucketedExecutorCache`, which fixes the buckets and the device
    (``buckets=``/``ctx=`` are then refused). ``max_batch_size`` defaults
    to the largest bucket and may not exceed it (a flushed batch must fit
    the biggest graph). ``deadline_ms`` (default
    ``MXTPU_SERVING_DEADLINE_MS``; 0 disables) sheds requests that aged
    past it while queued. ``artifact_dir`` (default
    ``MXTPU_SERVING_ARTIFACT_DIR``) points the cache at the persistent
    artifact store, with ``model_version`` in its guard; ``donate`` is
    accepted (see :class:`BucketedExecutorCache`).
    """

    def __init__(self, model, buckets: Optional[Sequence[int]] = None,
                 max_batch_size: Optional[int] = None,
                 max_wait_ms: float = 5.0, max_queue: int = 64,
                 name: Optional[str] = None,
                 donate: Optional[bool] = None,
                 deadline_ms: Optional[float] = None,
                 artifact_dir: Optional[str] = None,
                 model_version: str = "",
                 ctx: Optional[Context] = None):
        if isinstance(model, BucketedExecutorCache):
            if buckets is not None or ctx is not None \
                    or donate is not None or artifact_dir is not None:
                raise ValueError(
                    "buckets/ctx/donate/artifact_dir are fixed by the "
                    "prebuilt BucketedExecutorCache; configure them there")
            self._cache = model
            name = name or model.name
        else:
            name = name or (getattr(model, "name", "") or "model")
            self._cache = BucketedExecutorCache.from_block(
                model, ctx=ctx,
                buckets=DEFAULT_BUCKETS if buckets is None else buckets,
                donate=donate, name=name, metrics=ServingMetrics(name),
                artifact_dir=artifact_dir, model_version=model_version)
        self.name = name
        self.metrics: ServingMetrics = self._cache.metrics
        if max_batch_size is None:
            max_batch_size = self._cache.max_batch_size
        if max_batch_size > self._cache.max_batch_size:
            raise ValueError(
                f"max_batch_size={max_batch_size} exceeds the largest "
                f"bucket {self._cache.max_batch_size}")
        if deadline_ms is None:
            deadline_ms = float(config.get("MXTPU_SERVING_DEADLINE_MS"))
        self._batcher = DynamicBatcher(
            self._cache, max_batch_size=max_batch_size,
            max_wait_ms=max_wait_ms, max_queue=max_queue,
            metrics=self.metrics, name=name, deadline_ms=deadline_ms)
        self._maintenance = 0          # healthz unready while > 0
        self._maintenance_lock = threading.Lock()
        self._weights_version: object = 0   # bumped by publish_weights
        self._swap_lock = threading.Lock()  # serializes publishers only

    @classmethod
    def from_checkpoint(cls, block, params_path: str,
                        ctx: Optional[Context] = None,
                        use_native: Optional[bool] = None,
                        **kwargs) -> "ModelServer":
        """Load ``params_path`` into ``block`` on ``ctx``
        (:func:`load_block_checkpoint`) and serve it there."""
        load_block_checkpoint(block, params_path, ctx=ctx,
                              use_native=use_native)
        return cls(block, ctx=ctx, **kwargs)

    @classmethod
    def from_exported(cls, path: str, ctx: Optional[Context] = None,
                      **kwargs) -> "ModelServer":
        """Serve the ``HybridBlock.export_for_serving`` trio at ``path``
        (either package's): the graph as a ``SymbolBlock`` with its
        parameters on ``ctx`` (default ``gpu(0)``), the recorded buckets
        (unless ``buckets`` is given), warmed on the recorded input
        signature, one CUDA graph a bucket on the card (reference
        ``ModelServer.from_exported``)."""
        from ..gluon.block import SymbolBlock

        with open(f"{path}-serving.json") as f:
            spec = json.load(f)
        if spec.get("version") != 1:
            raise ValueError(f"unsupported serving spec {path}-serving.json")
        if len(spec["inputs"]) != 1:
            raise NotImplementedError(
                "serving batches single-input models")
        base = os.path.dirname(os.path.abspath(path))
        block = SymbolBlock.imports(
            os.path.join(base, spec["symbol"]),
            [io["name"] for io in spec["inputs"]],
            os.path.join(base, spec["params"]), ctx=ctx)
        kwargs.setdefault("buckets", tuple(spec["buckets"]))
        kwargs.setdefault("name", os.path.basename(path))
        srv = cls(block, ctx=ctx, **kwargs)
        io0 = spec["inputs"][0]
        srv.warmup(tuple(io0["features"]), io0["dtype"])
        return srv

    # -- dispatch -------------------------------------------------------------
    def submit(self, example) -> Future:
        """Enqueue one example (feature shape, no batch axis); resolves to
        the model's output row (a tuple of rows for a multi-output net).
        Raises ``QueueFullError`` (backpressure) / ``ServerClosedError``."""
        return self._batcher.submit(example)

    def predict(self, example, timeout: Optional[float] = 60.0):
        """Synchronous ``submit``: one request through the batcher."""
        return self.submit(example).result(timeout=timeout)

    # -- lifecycle ------------------------------------------------------------
    def warmup(self, feature_shape: Tuple[int, ...], dtype="float32",
               buckets: Optional[Sequence[int]] = None) -> None:
        """Capture every bucket's graph for the request signature before
        traffic arrives (else the captures land on the first unlucky
        requests), and pin the accepted signature."""
        self._cache.warmup(tuple(feature_shape), dtype, buckets)
        self._batcher.expect_features(tuple(feature_shape), dtype)

    # -- persistent artifacts and weight hot-swap -----------------------------
    def save_artifacts(self, directory: Optional[str] = None) -> int:
        """Persist the kernel libraries of every live graph so the next
        replica warms with no ``nvcc`` build
        (:meth:`BucketedExecutorCache.save_artifacts`)."""
        return self._cache.save_artifacts(directory)

    def load_artifacts(self, directory: Optional[str] = None) -> int:
        """Install every guard-matching artifact of this model and capture
        its signature."""
        return self._cache.load_artifacts(directory)

    @property
    def weights_version(self):
        """The version tag of the live weights (0 until the first
        :meth:`publish_weights`)."""
        return self._weights_version

    def publish_weights(self, source, version=None,
                        allow_partial: bool = True) -> dict:
        """Publish a new weight version into the live server: no drain, no
        capture, no dropped request.

        ``source`` is a ``{structural_name: value}`` dict (numpy arrays or
        torch tensors), a positional list, or an ``mx.nd.save``
        checkpoint path (:func:`load_weight_arrays`). The heavy work
        (reading, digesting, putting changed values on the device) runs
        here, off the hot path, while traffic flows and ``healthz()``
        stays ready. Only the commit (the in-place copies into the
        resident tensors, between batches) runs inside a
        :meth:`maintenance` window: a batch in flight keeps the version
        it read, the next sees the new one whole.

        Returns the swap stats (``params``/``aliased``/``updated``/
        ``carried`` counts, ``seconds``, ``version``)."""
        with self._swap_lock:
            t0 = time.perf_counter()
            staged = _stage_publish(self._cache, source, allow_partial,
                                    self.name)
            with self.maintenance():
                stats = self._cache.commit_params(staged)
                version = _resolve_version(self._weights_version, version)
                self._weights_version = version
            dt = time.perf_counter() - t0
        stats["version"] = version
        stats["seconds"] = round(dt, 4)
        return stats

    def resident_bytes(self) -> int:
        """Device bytes the server pins: parameters and its graphs' memory
        (the registry's budget accounting; the graphs' share is the
        port's own, see ``executor_cache.reserved_bytes``)."""
        return self._cache.resident_bytes()

    def estimated_wait_s(self) -> float:
        """Queue-wait estimate for a new request (0 when the backlog fits
        one batch)."""
        return self._batcher.estimated_wait_s()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful: refuse new requests, answer everything queued; after
        ``timeout`` seconds (default ``MXTPU_SERVING_DRAIN_TIMEOUT_S``) a
        wedged in-flight batch is force-closed with a warning, queued
        requests fail with ``ServerClosedError``, and the event counts in
        ``forced_closes``. True on a clean drain."""
        if timeout is None:
            timeout = float(config.get("MXTPU_SERVING_DRAIN_TIMEOUT_S"))
        if self._batcher.drain(timeout):
            return True
        logger.warning(
            "drain of %s did not finish within %.1fs (queue_depth=%d); "
            "force-closing", self.name, timeout, self.queue_depth)
        self.metrics.observe_forced_close()
        self._batcher.close(join_timeout=0.5)
        return False

    def close(self) -> None:
        """Immediate: fail queued requests, stop the worker."""
        self._batcher.close()

    def release(self) -> None:
        """After :meth:`close`: drop the graphs and give their memory back
        to the card (what a registry eviction does)."""
        self._cache.release()

    def maintenance(self):
        """Context manager flipping :meth:`healthz` unready for its
        duration (traffic is still served meanwhile)."""
        server = self

        class _Maintenance:
            def __enter__(self):
                with server._maintenance_lock:
                    server._maintenance += 1
                return server

            def __exit__(self, *exc):
                with server._maintenance_lock:
                    server._maintenance -= 1
                return False

        return _Maintenance()

    def healthz(self) -> dict:
        """Readiness probe: ``ready`` only while the server accepts and
        serves traffic; it flips during drain/close and inside a
        :meth:`maintenance` window."""
        state = self._batcher._state
        with self._maintenance_lock:
            in_maintenance = self._maintenance > 0
        return {
            "ready": state == "running" and not in_maintenance,
            "state": state,
            "maintenance": in_maintenance,
            "model": self.name,
            "queue_depth": self.queue_depth,
            "compiled_buckets": len(self.compiled_signatures()),
            "weights_version": self._weights_version,
        }

    def __enter__(self) -> "ModelServer":
        return self

    def __exit__(self, *exc) -> None:
        if exc and exc[0] is None:
            self.drain(timeout=30.0)
        self.close()

    # -- introspection --------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return self._batcher.queue_depth

    @property
    def buckets(self) -> Tuple[int, ...]:
        return self._cache.buckets

    def compiled_signatures(self):
        """(bucket, feature_shape, dtype) keys with a captured graph."""
        return self._cache.compiled_signatures()

    def stats(self) -> dict:
        snap = self.metrics.snapshot()
        snap["buckets"] = list(self.buckets)
        snap["compiled"] = [list(k) for k in self.compiled_signatures()]
        snap["weights_version"] = self._weights_version
        return snap
