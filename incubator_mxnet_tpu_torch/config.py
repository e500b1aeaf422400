"""Environment-knob configuration.

Counterpart of the JAX package's ``config.py``: one registry of typed env
knobs (``MXTPU_*``, with the ``MXNET_*`` spelling accepted as an alias),
read lazily and cached. Only the knobs the ported path reads are
registered, with the reference's names and defaults.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass
class Knob:
    name: str
    default: Any
    type: Callable[[str], Any]
    doc: str = ""


class _Config:
    """Process-global typed env-var registry with caching."""

    def __init__(self) -> None:
        self._knobs: Dict[str, Knob] = {}
        self._cache: Dict[str, Any] = {}
        self._overrides: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def register(self, name: str, default: Any, type: Callable[[str], Any],
                 doc: str = "") -> None:
        with self._lock:
            self._knobs[name] = Knob(name, default, type, doc)

    @staticmethod
    def _env_lookup(name: str) -> Optional[str]:
        for candidate in (name, name.replace("MXTPU_", "MXNET_", 1)):
            if candidate in os.environ:
                return os.environ[candidate]
        return None

    def get(self, name: str) -> Any:
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
            if name in self._cache:
                return self._cache[name]
            knob = self._knobs.get(name)
            if knob is None:
                raise KeyError(f"unknown config knob {name!r}")
            raw = self._env_lookup(name)
            val = knob.default if raw is None else knob.type(raw)
            self._cache[name] = val
            return val

    def set(self, name: str, value: Any) -> None:
        """Runtime override (takes precedence over env)."""
        with self._lock:
            self._overrides[name] = value

    def unset(self, name: str) -> None:
        with self._lock:
            self._overrides.pop(name, None)
            self._cache.pop(name, None)


config = _Config()

config.register(
    "MXTPU_ENGINE_TYPE", "async", str,
    "Execution mode: 'async' (the default: ops queue on the card's stream) "
    "or 'naive' (torch.cuda.synchronize after every NDArray op, so a "
    "device fault surfaces at the op that caused it; reference "
    "NaiveEngine).")
config.register(
    "MXTPU_SERVING_DEADLINE_MS", 0.0, float,
    "Per-request serving deadline: requests that age past this while "
    "queued are shed with DeadlineExceededError(retry_after) instead of "
    "served late. 0 disables.")
config.register(
    "MXTPU_SERVING_DRAIN_TIMEOUT_S", 30.0, float,
    "Default drain() timeout: past it the session is force-closed so "
    "shutdown can never hang.")
config.register(
    "MXTPU_DECODE_SLOTS", 8, int,
    "KV-cache slot count of a serving.DecodeSession (how many sequences "
    "decode concurrently). Sizes the device-resident cache as slots x "
    "layers x heads x max_len x head_dim x 2.")
config.register(
    "MXTPU_DECODE_MAX_LEN", 512, int,
    "Per-slot KV-cache capacity (tokens) of a serving.DecodeSession, "
    "prompt plus generated tokens; clipped to the decoder's max_length "
    "position table. A sequence that fills its slot finishes.")
config.register(
    "MXTPU_DECODE_BUCKETS", "16,32,64,128,256", str,
    "Prompt-length buckets of a serving.DecodeSession's prefill "
    "(comma-separated; entries above the cache max_len are dropped). "
    "Prompts zero-pad up to their bucket.")
config.register(
    "MXTPU_DECODE_MAX_NEW_TOKENS", 128, int,
    "Default generation budget per decode request (submit's "
    "max_new_tokens overrides). Generation also stops at the request's "
    "eos_id or at cache capacity.")

config.register(
    "MXTPU_SUPERSTEP", "auto", str,
    "K training steps per dispatch: 'auto' (the default) or '1' captures "
    "the K step bodies of a window in one CUDA graph wherever a caller "
    "drives stacked windows (SPMDTrainer.run_superstep and run_steps, "
    "gluon Trainer.superstep) on a CUDA device and the step is fusable; "
    "'0'/'off' runs the same K steps eagerly, one after another (the same "
    "loss stream, K host dispatches).")
config.register(
    "MXTPU_SUPERSTEP_WINDOW", 8, int,
    "Default superstep window K (gluon Trainer.superstep): batches per "
    "graph replay. A larger K spreads the host's dispatch over more steps "
    "but holds K stacked batches on the device and captures K step bodies.")


def is_naive_engine() -> bool:
    return str(config.get("MXTPU_ENGINE_TYPE")).lower() == "naive"
