"""``mx.serving``: dynamic-batching inference and KV-cache decode.

Counterpart of the JAX package's ``serving`` package, on CUDA graphs:

* ``BucketedExecutorCache``: requests are padded to a small set of batch
  buckets; one CUDA graph per (bucket, feature shape, dtype), captured at
  warm-up, parameters resident.
* ``DynamicBatcher``: concurrent single requests coalesce into batches
  under a ``max_batch_size`` / ``max_wait_ms`` flush policy, with
  bounded-queue backpressure (``QueueFullError.retry_after``) and deadline
  shedding (``DeadlineExceededError.retry_after``).
* ``ModelServer``: load (a Block, a prebuilt cache, or a checkpoint), warm
  up, serve, drain (with a forced close past its timeout), shut down;
  ``healthz()`` reports readiness.
* ``ServingMetrics``: latency percentiles, queue depth, batch occupancy,
  cache hits, misses and captures.
* ``DecodeSession``: greedy KV-cache decode with continuous batching; its
  prefill goes through a ``BucketedExecutorCache`` (one graph per prompt
  bucket), its decode step is one graph; ``DecodeMetrics`` counts it.

Not ported yet: the model registry, the persistent artifact store and
weight hot-swap.
"""

from .batcher import (DeadlineExceededError, DynamicBatcher, QueueFullError,
                      ServerClosedError)
from .decode import DecodeHandle, DecodeSession, KVCache
from .executor_cache import (DEFAULT_BUCKETS, BucketedExecutorCache,
                             block_apply_fn, pure_method_runner)
from .metrics import DecodeMetrics, ServingMetrics
from .server import ModelServer, load_block_checkpoint

__all__ = [
    "BucketedExecutorCache", "DEFAULT_BUCKETS", "DeadlineExceededError",
    "DecodeHandle", "DecodeMetrics", "DecodeSession", "DynamicBatcher",
    "KVCache", "ModelServer", "QueueFullError", "ServerClosedError",
    "ServingMetrics", "block_apply_fn", "load_block_checkpoint",
    "pure_method_runner",
]
