"""``mx.serving``: dynamic-batching inference, KV-cache decode and the model
registry.

Counterpart of the JAX package's ``serving`` package, on CUDA graphs:

* ``BucketedExecutorCache``: requests are padded to a small set of batch
  buckets; one CUDA graph per (bucket, feature shape, dtype), captured at
  warm-up, parameters resident. A new weight version is staged off the
  hot path and copied into the resident tensors in place
  (``stage_params``/``commit_params``): the graphs read them at their
  captured addresses.
* ``DynamicBatcher``: concurrent single requests coalesce into batches
  under a ``max_batch_size`` / ``max_wait_ms`` flush policy, with
  bounded-queue backpressure (``QueueFullError.retry_after``) and deadline
  shedding (``DeadlineExceededError.retry_after``).
* ``ModelServer``: load (a Block, a prebuilt cache, or a checkpoint), warm
  up, serve, publish new weights with no drain (``publish_weights``),
  drain (with a forced close past its timeout), shut down; ``healthz()``
  reports readiness.
* ``ServingMetrics``: latency percentiles, queue depth, batch occupancy,
  cache hits and misses, kernel builds, captures, artifacts and swaps.
* ``DecodeSession``: greedy KV-cache decode with continuous batching; its
  prefill goes through a ``BucketedExecutorCache`` (one graph per prompt
  bucket), its decode step is one graph; ``DecodeMetrics`` counts it. A
  weight publish flips between decode steps.
* ``ArtifactStore``: the persistent artifacts. A CUDA graph cannot be
  serialized, so what is stored is the kernel libraries the graphs launch,
  guarded by ``environment_fingerprint`` and ``params_fingerprint``: a
  replica pointed at the store runs no ``nvcc`` and captures its graphs
  again.
* ``ModelRegistry``: N models behind one routing front door within one
  device-memory budget: LRU eviction of idle models (never in-flight
  ones; eviction gives their graphs' and KV caches' memory back to the
  card), per-model SLO admission control, and live weight hot-swap
  (applied at once when the model is resident, at its next admission
  when it is not). ``RegistryMetrics`` counts it.
"""

from .artifacts import (ArtifactStore, environment_fingerprint,
                        params_fingerprint)
from .batcher import (DeadlineExceededError, DynamicBatcher, QueueFullError,
                      ServerClosedError)
from .decode import DecodeHandle, DecodeSession, KVCache
from .executor_cache import (DEFAULT_BUCKETS, BucketedExecutorCache,
                             block_apply_fn, pure_method_runner,
                             stage_weight_swap)
from .metrics import DecodeMetrics, RegistryMetrics, ServingMetrics
from .registry import ModelRegistry
from .server import ModelServer, load_block_checkpoint, load_weight_arrays

__all__ = [
    "ArtifactStore", "BucketedExecutorCache", "DEFAULT_BUCKETS",
    "DeadlineExceededError", "DecodeHandle", "DecodeMetrics",
    "DecodeSession", "DynamicBatcher", "KVCache", "ModelRegistry",
    "ModelServer", "QueueFullError", "RegistryMetrics",
    "ServerClosedError", "ServingMetrics", "block_apply_fn",
    "environment_fingerprint", "load_block_checkpoint",
    "load_weight_arrays", "params_fingerprint", "pure_method_runner",
    "stage_weight_swap",
]
