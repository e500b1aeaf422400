"""Global random state.

Counterpart of the JAX package's ``random.py``. ``seed(s)`` resets the
process-wide seed; ``generator(ctx)`` hands out one ``torch.Generator`` per
device, seeded from it; ``next_seed()`` gives the initializers a fresh
numpy seed per draw, so weights are reproducible from ``seed()`` alone.
The draws differ from the JAX package's threefry draws: tests that compare
the two packages carry weights across instead of drawing them twice.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from .device import Context, resolve

_lock = threading.Lock()
_seed = 0
_counter = 0
_generators: Dict[torch.device, torch.Generator] = {}


def seed(seed_state: int) -> None:
    """Seed every random source of the package (reference
    ``mx.random.seed``)."""
    global _seed, _counter
    with _lock:
        _seed = int(seed_state)
        _counter = 0
        _generators.clear()


def next_seed() -> int:
    """A fresh 63-bit seed derived from the global seed and a counter."""
    global _counter
    with _lock:
        _counter += 1
        # splitmix64 of (seed, counter): decorrelated consecutive seeds
        z = (_seed * 0x9E3779B97F4A7C15 + _counter) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return (z ^ (z >> 31)) >> 1


def generator(ctx: Optional[Context] = None) -> torch.Generator:
    """The ``torch.Generator`` of ``ctx``'s device (default context:
    ``gpu(0)``), created on first use and seeded from the global seed."""
    dev = resolve(ctx)
    with _lock:
        gen = _generators.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_seed)
            _generators[dev] = gen
        return gen
