"""The kernel launch counters, kept exact under CUDA-graph capture.

Each kernel wrapper counts its launch with :func:`count`: one on its
module's ``*_launches`` integers (``ops/flash_attention.py``,
``ops/fused_conv.py``), or on ``rtc.launches`` under the kernel's name. A
counter says how many times its kernel ran on the card. Inside a CUDA
graph that needs help: a capture calls the wrappers but runs no kernel,
and a replay runs every captured kernel without calling any Python. So a
capture made inside :func:`recording` counts nothing: each launch into
the recorded stream goes to the recording instead (the backward's too,
which autograd runs on its own thread but on the forward's stream), and
the engine adds the recording with :func:`add` after every replay.
Launches of other threads into other streams count as they run, so a
capture in ``thread_local`` mode leaves the rest of the process alone.
"""

from __future__ import annotations

import contextlib
import importlib
import sys
from typing import Dict, Iterator, Tuple

import torch

__all__ = ["add", "count", "delta", "recording", "snapshot"]

#: the modules whose ``*_launches`` integers count kernel launches
_COUNTED = ("incubator_mxnet_tpu_torch.ops.flash_attention",
            "incubator_mxnet_tpu_torch.ops.fused_conv")

Counts = Dict[Tuple[str, str], int]

#: open recordings: CUDA stream handle -> the launches captured into it
_recordings: Dict[int, Counts] = {}


def _bump(counts_of: Counts, module: str, names) -> None:
    for name in names:
        counts_of[module, name] = counts_of.get((module, name), 0) + 1


def count(module: str, *names: str) -> None:
    """One launch on each counter ``names`` of ``module`` (a module's
    ``__name__``, or ``"rtc"`` for ``rtc.launches`` by kernel name); a
    launch into a stream that a :func:`recording` captures goes to that
    recording instead."""
    if _recordings and torch.cuda.is_current_stream_capturing():
        rec = _recordings.get(torch.cuda.current_stream().cuda_stream)
        if rec is not None:
            _bump(rec, module, names)
            return
    if module == "rtc":
        from .. import rtc

        for name in names:
            rtc.launches[name] += 1
        return
    mod = sys.modules[module]
    for name in names:
        setattr(mod, name, getattr(mod, name) + 1)


@contextlib.contextmanager
def recording(stream: torch.cuda.Stream) -> Iterator[Counts]:
    """Around a capture into ``stream``: yields the counts of the launches
    captured (filled as the capture runs), which no counter gains."""
    key = stream.cuda_stream
    if key in _recordings:
        raise RuntimeError("a recording of this stream is already open")
    rec: Counts = {}
    _recordings[key] = rec
    try:
        yield rec
    finally:
        del _recordings[key]


def snapshot() -> Counts:
    """Every counter's value: ``(module, name) -> count``; the rtc
    kernels' counts under ``("rtc", kernel name)``."""
    out: Counts = {}
    for modname in _COUNTED:
        mod = importlib.import_module(modname)
        for name, value in vars(mod).items():
            if name.endswith("_launches") and isinstance(value, int):
                out[modname, name] = value
    from .. import rtc

    for name, value in rtc.launches.items():
        out["rtc", name] = value
    return out


def delta(before: Counts, after: Counts) -> Counts:
    """The counters that moved between two snapshots, and by how much."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def add(change: Counts, times: int = 1) -> None:
    """Add ``times`` x ``change`` to the counters (a replay of a graph
    whose capture recorded ``change``)."""
    from .. import rtc

    for (modname, name), n in change.items():
        if modname == "rtc":
            rtc.launches[name] += n * times
        else:
            mod = importlib.import_module(modname)
            setattr(mod, name, getattr(mod, name) + n * times)
