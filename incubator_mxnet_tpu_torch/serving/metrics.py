"""Serving metrics: the batch tier's ``ServingMetrics`` and the decode
tier's ``DecodeMetrics``.

Counterparts of the JAX package's ``serving/metrics.py`` classes of the
same names, with the same ``snapshot()`` keys. One ``ServingMetrics`` is
shared by a model's executor cache, batcher and server: request latency
percentiles (a sliding window), queue depth, batch occupancy (requests per
executed batch, the number dynamic batching exists to raise), rejects,
sheds, forced closes, the executor cache's hits, misses and captures, the
last warm-up's seconds. ``DecodeMetrics`` counts slot occupancy, token
throughput, the prefill-vs-decode wall-time split, KV-cache bytes, queue
wait and time to first token. The telemetry exporters and the profiler
counters are not ported yet, so the counters live here only.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict

__all__ = ["DecodeMetrics", "ServingMetrics"]


def _percentile(sorted_vals, p: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   math.ceil(p / 100.0 * len(sorted_vals)) - 1))
    return sorted_vals[k]


class ServingMetrics:
    """Thread-safe counters and a sliding-window latency reservoir.

    A CUDA-graph capture is this port's counterpart of the JAX package's
    XLA compile: the executor cache records each under the reference's
    names (:meth:`observe_compile`, ``compiles``, ``compile_seconds``).
    The persistent-artifact keys (``artifact_hits``, ``artifact_misses``,
    ``artifact_refused``, ``deserialize_seconds``) stay 0: a CUDA graph is
    not serialized, and the artifact store is not ported. ``swaps`` stays
    0 until weight hot-swap is ported."""

    def __init__(self, model: str = "model", window: int = 2048):
        self.model = model
        self._lock = threading.Lock()
        self._latencies = deque(maxlen=window)     # seconds per request
        self._batch_sizes = deque(maxlen=window)   # requests per batch
        self.requests = 0
        self.rejected = 0
        self.shed = 0
        self.forced_closes = 0
        self.batches = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.compiles = 0
        self.compile_seconds = 0.0
        self.artifact_hits = 0
        self.artifact_misses = 0
        self.artifact_refused = 0
        self.deserialize_seconds = 0.0
        self.warmup_seconds = 0.0    # last warmup() wall time
        self.swaps = 0
        self.queue_depth = 0

    # -- batcher-side observations -------------------------------------------
    def observe_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = depth

    def observe_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def observe_shed(self) -> None:
        """A queued request aged past the per-request deadline and was
        failed with ``DeadlineExceededError`` instead of served late."""
        with self._lock:
            self.shed += 1

    def observe_forced_close(self) -> None:
        """A graceful drain hit its timeout and was force-closed."""
        with self._lock:
            self.forced_closes += 1

    def observe_batch(self, batch_size: int) -> None:
        with self._lock:
            self.batches += 1
            self._batch_sizes.append(batch_size)

    def observe_latency(self, seconds: float) -> None:
        with self._lock:
            self.requests += 1
            self._latencies.append(seconds)

    # -- executor-cache-side observations ------------------------------------
    def cache_hit(self) -> None:
        with self._lock:
            self.cache_hits += 1

    def cache_miss(self) -> None:
        with self._lock:
            self.cache_misses += 1

    def observe_compile(self, seconds: float) -> None:
        """One CUDA-graph capture (warm-up run included) of ``seconds``."""
        with self._lock:
            self.compiles += 1
            self.compile_seconds += seconds

    def observe_warmup(self, seconds: float) -> None:
        with self._lock:
            self.warmup_seconds = seconds

    # -- reads ----------------------------------------------------------------
    def latency_ms(self, p: float) -> float:
        """Latency percentile in milliseconds over the sliding window."""
        with self._lock:
            vals = sorted(self._latencies)
        return _percentile(vals, p) * 1e3

    def mean_batch_occupancy(self) -> float:
        """Mean requests per executed batch (> 1 means batching works)."""
        with self._lock:
            sizes = list(self._batch_sizes)
        return sum(sizes) / len(sizes) if sizes else 0.0

    def snapshot(self) -> Dict[str, object]:
        occ = self.mean_batch_occupancy()
        with self._lock:
            vals = sorted(self._latencies)
            return {
                "model": self.model,
                "requests": self.requests,
                "rejected": self.rejected,
                "shed": self.shed,
                "forced_closes": self.forced_closes,
                "batches": self.batches,
                "queue_depth": self.queue_depth,
                "batch_occupancy": occ,
                "latency_ms": {f"p{p}": _percentile(vals, p) * 1e3
                               for p in (50, 90, 99)},
                "warmup_seconds": self.warmup_seconds,
                "swaps": self.swaps,
                "executor_cache": {
                    "hits": self.cache_hits,
                    "misses": self.cache_misses,
                    "compiles": self.compiles,
                    "compile_seconds": self.compile_seconds,
                    "artifact_hits": self.artifact_hits,
                    "artifact_misses": self.artifact_misses,
                    "artifact_refused": self.artifact_refused,
                    "deserialize_seconds": self.deserialize_seconds},
            }


class DecodeMetrics:
    """Thread-safe per-session continuous-batching decode counters."""

    def __init__(self, model: str = "model", window: int = 2048):
        self.model = model
        self._lock = threading.Lock()
        self._queue_waits = deque(maxlen=window)    # seconds, per request
        self._ttfts = deque(maxlen=window)          # submit -> first token
        self._active_hist = deque(maxlen=window)    # slots active per step
        self.requests = 0
        self.rejected = 0
        self.shed = 0
        self.finished = 0
        self.tokens = 0
        self.prefills = 0
        self.steps = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        self.slots_active = 0
        self.cache_bytes = 0

    def set_capacity(self, cache_bytes: int) -> None:
        with self._lock:
            self.cache_bytes = int(cache_bytes)

    def observe_submit(self) -> None:
        with self._lock:
            self.requests += 1

    def observe_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def observe_shed(self) -> None:
        with self._lock:
            self.shed += 1

    def observe_admit(self, queue_wait_s: float, prefill_s: float) -> None:
        with self._lock:
            self.prefills += 1
            self.prefill_seconds += prefill_s
            self._queue_waits.append(queue_wait_s)

    def observe_first_token(self, ttft_s: float) -> None:
        with self._lock:
            self._ttfts.append(ttft_s)
            self.tokens += 1          # prefill emits the first token

    def observe_step(self, active: int, seconds: float) -> None:
        """One decode step with ``active`` live slots (one token each)."""
        with self._lock:
            self.steps += 1
            self.decode_seconds += seconds
            self.tokens += active
            self._active_hist.append(active)

    def observe_slots(self, active: int) -> None:
        with self._lock:
            self.slots_active = active

    def observe_finish(self) -> None:
        with self._lock:
            self.finished += 1

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            waits = sorted(self._queue_waits)
            ttfts = sorted(self._ttfts)
            act = list(self._active_hist)
            total = self.prefill_seconds + self.decode_seconds
            return {
                "model": self.model,
                "requests": self.requests,
                "rejected": self.rejected,
                "shed": self.shed,
                "finished": self.finished,
                "tokens": self.tokens,
                "steps": self.steps,
                "prefills": self.prefills,
                "slots_active": self.slots_active,
                "cache_bytes": self.cache_bytes,
                "mean_step_occupancy":
                    (sum(act) / len(act)) if act else 0.0,
                "queue_wait_ms": {f"p{p}": _percentile(waits, p) * 1e3
                                  for p in (50, 90, 99)},
                "ttft_ms": {f"p{p}": _percentile(ttfts, p) * 1e3
                            for p in (50, 90, 99)},
                "prefill_seconds": self.prefill_seconds,
                "decode_seconds": self.decode_seconds,
                "prefill_frac":
                    (self.prefill_seconds / total) if total else 0.0,
            }
