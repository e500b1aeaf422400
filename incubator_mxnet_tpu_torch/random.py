"""Global random state.

Counterpart of the JAX package's ``random.py``. ``seed(s)`` resets the
process-wide seed; ``generator(ctx)`` hands out one ``torch.Generator`` per
device, seeded from it; ``next_seed()`` gives the initializers a fresh
numpy seed per draw, so weights are reproducible from ``seed()`` alone.
The draws differ from the JAX package's threefry draws: tests that compare
the two packages carry weights across instead of drawing them twice.

``get_state``/``set_state`` save and restore all of it, so a restored
state replays the same draws (the samplers of ``ops/random_ops.py`` and
``ops/more.py`` draw from these generators alone).

``reserve_keys``/``rollback_keys`` are the superstep's RNG contract. In the
JAX package a dispatch of K steps reserves K fold-in keys up front. Here a
CUDA graph of K steps advances a registered generator on every replay by
exactly what the K eager steps would have drawn, so the contract left to
keep on the host is the rollback: a dispatch that ran no step puts every
generator of the device back where it stood.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

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


def generators_of(device: torch.device) -> List[torch.Generator]:
    """The package's generators of ``device`` created so far (a CUDA graph
    registers them, so that each replay draws fresh values)."""
    with _lock:
        return [g for d, g in _generators.items() if d == device]


def reserve_keys(device: torch.device) -> Tuple:
    """The state of every generator a step on ``device`` may draw from:
    the package's own (created here if a step has not yet made it, seeded
    as that first step would) and torch's default one. A dispatch takes
    this before it runs and hands it to :func:`rollback_keys` if it ran
    no step."""
    from .device import Context

    device = torch.device(device)
    if device.type == "cuda":
        generator(Context("gpu", device.index or 0))
        default = torch.cuda.default_generators[device.index or 0]
    else:
        generator(Context("cpu"))
        default = torch.default_generator
    gens = [default] + generators_of(device)
    return tuple((g, g.get_state()) for g in gens)


def rollback_keys(reserved: Tuple) -> None:
    """Undo the draws made since :func:`reserve_keys` (a dispatch that
    failed before it ran a step): every generator it named goes back to
    the state it had."""
    for g, state in reserved:
        g.set_state(state)


def get_state() -> dict:
    """Snapshot the package's random state as plain JSON-able data: the
    global seed, the initializers' counter and every generator's state
    by device (reference ``mx.random.get_state``). :func:`set_state`
    replays the same draws from it."""
    with _lock:
        return {"seed": _seed, "counter": _counter,
                "generators": {str(d): g.get_state().tolist()
                               for d, g in _generators.items()}}


def set_state(state: dict) -> None:
    """Inverse of :func:`get_state`. Each generator is set in place (a
    captured CUDA graph keeps the one it registered); a generator made
    since the snapshot goes back to its first state, seeded from the
    seed."""
    global _seed, _counter
    saved = {torch.device(d): torch.tensor(v, dtype=torch.uint8)
             for d, v in state["generators"].items()}
    with _lock:
        _seed = int(state["seed"])
        _counter = int(state["counter"])
        for dev in saved.keys() - _generators.keys():
            gen = torch.Generator(device=dev)
            _generators[dev] = gen
        for dev, gen in _generators.items():
            if dev in saved:
                gen.set_state(saved[dev])
            else:
                gen.manual_seed(_seed)
