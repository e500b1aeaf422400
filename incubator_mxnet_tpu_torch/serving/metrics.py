"""Decode serving metrics.

Counterpart of ``DecodeMetrics`` in the JAX package's ``serving/
metrics.py``, with the same ``snapshot()`` keys: slot occupancy, token
throughput, the prefill-vs-decode wall-time split, KV-cache bytes, queue
wait and time to first token. The telemetry exporters are not ported yet,
so the counters live here only.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict

__all__ = ["DecodeMetrics"]


def _percentile(sorted_vals, p: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   math.ceil(p / 100.0 * len(sorted_vals)) - 1))
    return sorted_vals[k]


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
