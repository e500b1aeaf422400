"""gluon.contrib of the port (reference ``gluon/contrib/``): ``nn``.

``estimator`` waits for ``metric.py`` (``ROADMAP.md``, queue 1)."""

from . import nn

__all__ = ["nn"]
