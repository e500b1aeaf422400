"""Serving metrics: the batch tier's ``ServingMetrics``, the decode tier's
``DecodeMetrics`` and the registry's ``RegistryMetrics``.

Counterparts of the JAX package's ``serving/metrics.py`` classes of the
same names, with the same ``snapshot()`` keys. One ``ServingMetrics`` is
shared by a model's executor cache, batcher and server: request latency
percentiles (a sliding window), queue depth, batch occupancy (requests per
executed batch, the number dynamic batching exists to raise), rejects,
sheds, forced closes, the executor cache's hits, misses, kernel builds,
captures, artifacts and weight swaps, the last warm-up's seconds. ``DecodeMetrics`` counts slot occupancy, token
throughput, the prefill-vs-decode wall-time split, KV-cache bytes, queue
wait and time to first token. ``RegistryMetrics`` counts a
``ModelRegistry``'s admissions, evictions, SLO rejections and weight swaps
and gauges its residency against its budget. The telemetry exporters and
the profiler counters are not ported yet, so the counters live here only.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict

__all__ = ["DecodeMetrics", "RegistryMetrics", "ServingMetrics"]


def _percentile(sorted_vals, p: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   math.ceil(p / 100.0 * len(sorted_vals)) - 1))
    return sorted_vals[k]


class ServingMetrics:
    """Thread-safe counters and a sliding-window latency reservoir.

    What a cold start pays for here is the kernel libraries' ``nvcc``
    builds, so ``compiles`` (and ``compile_seconds``) count those: the
    builds a signature's executable set off (:meth:`observe_compile`).
    The CUDA-graph captures, which compile nothing, are counted apart
    (:meth:`observe_capture`, ``captures``, ``capture_seconds``). An
    artifact hit (:meth:`observe_deserialize`) is a signature whose kernel
    libraries came off the artifact store; ``swaps`` counts weight
    versions published into the live model."""

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
        self.captures = 0
        self.capture_seconds = 0.0
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

    def observe_compile(self, seconds: float, n: int = 1) -> None:
        """``n`` kernel-library builds (``nvcc``) taking ``seconds``."""
        with self._lock:
            self.compiles += n
            self.compile_seconds += seconds

    def observe_capture(self, seconds: float) -> None:
        """One CUDA-graph capture (warm-up run included) of ``seconds``."""
        with self._lock:
            self.captures += 1
            self.capture_seconds += seconds

    def observe_deserialize(self, seconds: float) -> None:
        """A signature's kernel libraries came off the persistent artifact
        store (installed in ``seconds``; no ``nvcc`` ran for them)."""
        with self._lock:
            self.artifact_hits += 1
            self.deserialize_seconds += seconds

    def artifact_miss(self, refused: bool = False) -> None:
        """No usable artifact for a missed signature: its kernels build
        where they must (and the artifact is written again).
        ``refused`` marks a stale one: an artifact existed but its guard
        (torch, CUDA, driver, device, kernel sources, model fingerprint)
        disagreed."""
        with self._lock:
            self.artifact_misses += 1
            if refused:
                self.artifact_refused += 1

    def observe_warmup(self, seconds: float) -> None:
        with self._lock:
            self.warmup_seconds = seconds

    def observe_swap(self) -> None:
        """A new weight version was published into the live model."""
        with self._lock:
            self.swaps += 1

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
                    "captures": self.captures,
                    "capture_seconds": self.capture_seconds,
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


class RegistryMetrics:
    """Registry-level counters of a ``ModelRegistry``: resident models and
    bytes against the budget, and admissions (cold ones apart), evictions,
    SLO rejections and weight swaps, in all and per model."""

    def __init__(self, registry: str = "registry"):
        self.registry = registry
        self._lock = threading.Lock()
        self.admissions = 0
        self.cold_admissions = 0     # built by nvcc (no warm kernel artifacts)
        self.evictions = 0
        self.slo_rejections = 0
        self.swaps = 0
        self.resident = 0
        self.resident_bytes = 0
        self.budget_bytes = 0
        self.per_model: Dict[str, Dict[str, int]] = {}

    def _bump(self, model: str, key: str) -> None:
        slot = self.per_model.setdefault(
            model, {"admissions": 0, "evictions": 0, "slo_rejections": 0,
                    "swaps": 0})
        slot[key] += 1

    def observe_admit(self, model: str, cold: bool) -> None:
        with self._lock:
            self.admissions += 1
            if cold:
                self.cold_admissions += 1
            self._bump(model, "admissions")

    def observe_evict(self, model: str) -> None:
        with self._lock:
            self.evictions += 1
            self._bump(model, "evictions")

    def observe_slo_rejection(self, model: str) -> None:
        with self._lock:
            self.slo_rejections += 1
            self._bump(model, "slo_rejections")

    def observe_swap(self, model: str) -> None:
        with self._lock:
            self.swaps += 1
            self._bump(model, "swaps")

    def set_residency(self, resident: int, resident_bytes: int) -> None:
        with self._lock:
            self.resident = int(resident)
            self.resident_bytes = int(resident_bytes)

    def set_budget(self, budget_bytes: int) -> None:
        with self._lock:
            self.budget_bytes = int(budget_bytes)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "registry": self.registry,
                "admissions": self.admissions,
                "cold_admissions": self.cold_admissions,
                "evictions": self.evictions,
                "slo_rejections": self.slo_rejections,
                "swaps": self.swaps,
                "resident": self.resident,
                "resident_bytes": self.resident_bytes,
                "budget_bytes": self.budget_bytes,
                "per_model": {m: dict(v)
                              for m, v in self.per_model.items()},
            }
