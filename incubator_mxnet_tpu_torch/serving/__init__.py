"""Serving of the port: KV-cache continuous-batching decode."""

from .batcher import DeadlineExceededError, QueueFullError, ServerClosedError
from .decode import DecodeHandle, DecodeSession, KVCache
from .executor_cache import BucketPolicy
from .metrics import DecodeMetrics

__all__ = ["BucketPolicy", "DeadlineExceededError", "DecodeHandle",
           "DecodeMetrics", "DecodeSession", "KVCache", "QueueFullError",
           "ServerClosedError"]
