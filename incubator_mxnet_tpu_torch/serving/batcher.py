"""Dynamic micro-batcher: coalesce concurrent single requests into
executor-sized batches.

Counterpart of the JAX package's ``serving/batcher.py`` (the Model-Server
pattern, TF-Serving and MXNet Model Server): callers submit ONE example
each and get a Future; a worker thread flushes the queue into a batch when
either

* the batch is full (``max_batch_size`` requests waiting), or
* the oldest waiting request has aged ``max_wait_ms``: a partial batch goes
  out rather than holding the client.

Backpressure is explicit: a bounded queue, and ``submit`` raises
``QueueFullError`` (with a ``retry_after`` estimate from the observed batch
service time) instead of buffering without bound. Requests that age past
``deadline_ms`` while queued are shed with ``DeadlineExceededError``. A
runner failure fails its batch's futures, never the worker. The request
trace spans wait for the telemetry port.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple

import numpy as np

from .metrics import ServingMetrics

__all__ = ["DeadlineExceededError", "DynamicBatcher", "QueueFullError",
           "ServerClosedError"]


class QueueFullError(RuntimeError):
    """The request queue is at capacity; retry after ``retry_after`` s."""

    def __init__(self, message: str, retry_after: float):
        super().__init__(message)
        self.retry_after = retry_after


class DeadlineExceededError(RuntimeError):
    """The request aged past the per-request deadline while queued and was
    shed: answering it late would still miss the client's deadline. Retry
    after ``retry_after`` seconds."""

    def __init__(self, message: str, retry_after: float):
        super().__init__(message)
        self.retry_after = retry_after


class ServerClosedError(RuntimeError):
    """Submitted to a draining or shut-down server."""


class DynamicBatcher:
    """Bounded request queue + worker thread + flush policy.

    ``runner(batch)`` receives a stacked ``(k, *feature_shape)`` array
    (``k <= max_batch_size``) and returns one array or a tuple of arrays
    with leading batch axis ``k``; row ``i`` answers request ``i``.
    """

    def __init__(self, runner: Callable, max_batch_size: int = 8,
                 max_wait_ms: float = 5.0, max_queue: int = 64,
                 metrics: Optional[ServingMetrics] = None,
                 name: str = "model",
                 deadline_ms: Optional[float] = None):
        if max_batch_size < 1 or max_queue < 1:
            raise ValueError("max_batch_size and max_queue must be >= 1")
        if deadline_ms is not None and deadline_ms <= 0:
            deadline_ms = None
        self._runner = runner
        self.max_batch_size = int(max_batch_size)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        self.metrics = metrics if metrics is not None else ServingMetrics(name)
        self._cv = threading.Condition()
        self._queue: deque = deque()   # (example, t_submit, future)
        self._state = "running"        # -> "draining" -> / "closed"
        self._feature_sig: Optional[Tuple] = None
        self._ewma_batch_s = 0.0       # service-time estimate for retry_after
        self._worker = threading.Thread(
            target=self._loop, name=f"mxtpu-torch-serving-{name}",
            daemon=True)
        self._worker.start()

    # -- client side ----------------------------------------------------------
    def expect_features(self, shape, dtype) -> None:
        """Pin the accepted feature signature (the server's warmup does) so
        a misshapen request fails at submit instead of poisoning a
        batch."""
        self._feature_sig = (tuple(shape), np.dtype(dtype).name)

    def submit(self, example) -> Future:
        """Enqueue ONE example (feature shape, no batch axis)."""
        arr = np.asarray(example)
        sig = (arr.shape, arr.dtype.name)
        with self._cv:
            if self._state != "running":
                raise ServerClosedError(
                    f"server is {self._state}; not accepting requests")
            if self._feature_sig is None:
                self._feature_sig = sig
            elif sig != self._feature_sig:
                raise ValueError(
                    f"request signature {sig} does not match the served "
                    f"model's {self._feature_sig}")
            if len(self._queue) >= self.max_queue:
                self.metrics.observe_reject()
                raise QueueFullError(
                    f"queue full ({self.max_queue} waiting)",
                    retry_after=self._retry_after_locked())
            fut: Future = Future()
            self._queue.append((arr, time.monotonic(), fut))
            self.metrics.observe_queue_depth(len(self._queue))
            self._cv.notify_all()
            return fut

    def _retry_after_locked(self) -> float:
        batches_ahead = (len(self._queue) + self.max_batch_size - 1) \
            // self.max_batch_size
        service = self._ewma_batch_s or self.max_wait_ms / 1e3
        return max(self.max_wait_ms / 1e3, batches_ahead * service)

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def estimated_wait_s(self) -> float:
        """Queue-wait estimate for a request submitted now: full batches
        ahead of it times the observed batch service time (0 while the
        backlog fits the next flush)."""
        with self._cv:
            batches_ahead = len(self._queue) // self.max_batch_size
            return batches_ahead * (self._ewma_batch_s
                                    or self.max_wait_ms / 1e3)

    # -- worker side ----------------------------------------------------------
    def _next_batch(self) -> Optional[List[Tuple]]:
        """Block until the flush policy yields a batch; None = exit."""
        with self._cv:
            while True:
                if self._state == "closed":
                    return None
                if self._queue:
                    break
                if self._state == "draining":
                    return None
                self._cv.wait()
            # flush-on-full vs flush-on-timeout: wait for a full batch,
            # but never past the oldest request's max_wait
            deadline = self._queue[0][1] + self.max_wait_ms / 1e3
            while (len(self._queue) < self.max_batch_size
                   and self._state == "running"):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            if self._state == "closed":
                return None            # close() already failed the queue
            shed: List[Tuple] = []
            if self.deadline_ms is not None:
                # the queue is FIFO over monotonic submit times, so only
                # the front can be expired
                cutoff = time.monotonic() - self.deadline_ms / 1e3
                while self._queue and self._queue[0][1] < cutoff:
                    shed.append(self._queue.popleft())
            k = min(len(self._queue), self.max_batch_size)
            items = [self._queue.popleft() for _ in range(k)]
            self.metrics.observe_queue_depth(len(self._queue))
            retry_after = self._retry_after_locked() if shed else 0.0
        for _, _, f in shed:           # futures resolve outside the lock
            self.metrics.observe_shed()
            if not f.done():
                f.set_exception(DeadlineExceededError(
                    f"request exceeded its {self.deadline_ms:.1f} ms "
                    "deadline while queued", retry_after=retry_after))
        return items

    def _run_batch(self, items: List[Tuple]) -> None:
        t0 = time.perf_counter()
        try:
            out = self._runner(np.stack([x for x, _, _ in items]))
        except Exception as exc:       # noqa: BLE001 — failure -> callers
            for _, _, f in items:
                if not f.done():
                    f.set_exception(exc)
            return
        dt = time.perf_counter() - t0
        self._ewma_batch_s = dt if not self._ewma_batch_s \
            else 0.8 * self._ewma_batch_s + 0.2 * dt
        self.metrics.observe_batch(len(items))
        now = time.monotonic()
        leaves = out if isinstance(out, tuple) else (out,)
        for i, (_, t_submit, f) in enumerate(items):
            # per-future guard: a runner output whose leading axis is not
            # the batch axis fails THAT caller, not the worker
            try:
                row = tuple(leaf[i] for leaf in leaves)
                self.metrics.observe_latency(now - t_submit)
                if not f.done():
                    f.set_result(row[0] if len(row) == 1 else row)
            except Exception as exc:   # noqa: BLE001
                if not f.done():
                    f.set_exception(exc)

    def _loop(self) -> None:
        while True:
            items = self._next_batch()
            if items is None:
                return
            if not items:              # every queued request was shed
                continue
            try:
                self._run_batch(items)
            except Exception as exc:   # noqa: BLE001 — worker must survive
                for _, _, f in items:
                    if not f.done():
                        f.set_exception(exc)

    # -- lifecycle ------------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop accepting; serve everything queued; True when empty."""
        with self._cv:
            if self._state == "running":
                self._state = "draining"
            self._cv.notify_all()
        self._worker.join(timeout)
        return not self._worker.is_alive()

    def close(self, join_timeout: float = 5.0) -> None:
        """Stop now: fail queued requests (an in-flight batch still
        lands). ``join_timeout`` bounds the wait for the worker: a
        force-close after a timed-out drain passes a short one."""
        with self._cv:
            self._state = "closed"
            pending = list(self._queue)
            self._queue.clear()
            self._cv.notify_all()
        for _, _, f in pending:
            if not f.done():
                f.set_exception(ServerClosedError("server closed"))
        self._worker.join(timeout=join_timeout)
