"""Carry weights from the JAX package into the port.

No counterpart in the JAX package. The port's parameter names are the JAX
package's structural names (``parallel.spmd.collect_params`` there), and
the layouts are the same, so the carry-over is a checked copy by name.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ...device import Context, resolve
from ..block import Block


def load_jax_params(net: Block, params: Mapping[str, np.ndarray],
                    ctx: Optional[Context] = None) -> Block:
    """Copy ``params`` (structural name -> numpy array, as the JAX
    package's ``collect_params`` names them) into ``net`` on ``ctx``
    (default ``gpu(0)``). Every name of ``net`` must be given and no
    other, each with its exact shape (a dim the net defers to its first
    forward takes the given one); anything else raises ``ValueError``
    before a single parameter changes. Returns ``net``."""
    dev = resolve(ctx)
    own = dict(net.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise ValueError(f"parameter names differ: missing {missing}, "
                         f"unexpected {extra}")
    arrays = {}
    for name, p in own.items():
        arr = np.asarray(params[name])
        if arr.ndim != p.dim() or any(s not in (0, a) for s, a in
                                      zip(p.shape, arr.shape)):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                             f"{tuple(p.shape)}")
        arrays[name] = arr
    for name, p in own.items():
        # np.array copies: the parameter never aliases the caller's buffer
        net.set_param(name, torch.from_numpy(np.array(arrays[name])).to(
            device=dev, dtype=p.dtype))
    return net
