"""Serving errors.

Counterpart of the error classes of the JAX package's ``serving/
batcher.py``; the dynamic batcher itself is not ported yet.
"""

from __future__ import annotations

__all__ = ["DeadlineExceededError", "QueueFullError", "ServerClosedError"]


class QueueFullError(RuntimeError):
    """The request queue is at capacity; retry after ``retry_after`` s."""

    def __init__(self, message: str, retry_after: float):
        super().__init__(message)
        self.retry_after = retry_after


class DeadlineExceededError(RuntimeError):
    """The request aged past the per-request deadline while queued and was
    shed: answering it late would still miss the client's deadline. Retry
    after ``retry_after`` seconds."""

    def __init__(self, message: str, retry_after: float):
        super().__init__(message)
        self.retry_after = retry_after


class ServerClosedError(RuntimeError):
    """Submitted to a draining or shut-down server."""
