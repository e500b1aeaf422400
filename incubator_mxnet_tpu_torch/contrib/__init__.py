"""``mx.contrib``: control flow (counterpart of the JAX package's
``contrib/``; quantization and text are not ported yet)."""

from . import control_flow
from .control_flow import cond, foreach, while_loop

# reference spelling: mx.contrib.nd.foreach (and mx.nd.contrib.foreach)
nd = control_flow

__all__ = ["cond", "control_flow", "foreach", "nd", "while_loop"]
