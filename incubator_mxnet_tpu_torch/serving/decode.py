"""KV-cache-resident autoregressive decode with continuous batching.

Counterpart of the JAX package's ``serving/decode.py``: a prefill/decode
split over a slot-based, device-resident KV cache ``[layers, slots, heads,
max_len, head_dim]``.

* **Prefill** pads a prompt with zeros up to its length bucket and runs one
  causal forward that gives the greedy first token and the per-layer K/V
  planes.
* **Join** copies those planes into a free slot's cache range.
* **Decode** advances EVERY slot one token per step; a per-slot
  ``cache_len`` (host int32 vector, copied to the device each step) lets one
  step serve any mix of sequence ages: attention reads exactly
  ``[0, cache_len]`` per slot through the ``cache_offset`` mode of the flash
  attention kernel. Free slots compute harmlessly with ``cache_len`` 0.

**Continuous batching**: new sequences join the running batch at step
boundaries, finished sequences free their slot without disturbing their
neighbours. The scheduler mirrors ``cache_len`` and the next tokens on the
host: they follow from its own actions, so the only device-to-host traffic
per step is the ``[slots]`` next-token vector the clients need anyway.

Front door: bounded-queue backpressure (``QueueFullError.retry_after``),
per-request deadline shedding while queued, ``drain``/``close``/
``healthz``; tokens stream out per step through :class:`DecodeHandle`.

**The decode step is one CUDA graph** (the counterpart of the JAX
package's one jitted decode executable): on a CUDA device the first step
(``warmup`` makes it) captures ``decode_step`` and the argmax over every
slot, reading static ``tokens`` and ``cache_len`` buffers that each step
fills from the host mirrors before its replay, and writing the next tokens
into a static output; the KV cache planes already sit at fixed addresses.
A step then costs one ``graph.replay()`` instead of some hundreds of
launches from the host.

**Prefill is one CUDA graph per prompt bucket**, through the batch tier's
``BucketedExecutorCache(pass_count=True, depad=False)`` as in the JAX
package: the prompt's true length rides a static int32 device scalar, so
one graph serves every length of its bucket, and the greedy read of the
last valid position indexes with it on the device. The join (the copy of
the graph's static K/V planes into the slot's cache range) stays eager
under the session's lock: two copies a prefill, made before the next
replay can overwrite the planes. On the CPU prefill and step run eagerly.

**Weight hot-swap**: ``publish_weights`` stages the new version on the
publisher's thread; the scheduler commits it between decode steps, under
the session's device lock. The prefill graphs and the decode graph read
the same block tensors, so one in-place commit flips both at the same step
boundary: a sequence that finished before the flip is a pure old-version
stream, one admitted after it a pure new-version stream, and one in flight
goes on over its KV cache under the new weights.

**Persistent artifacts** (``artifact_dir``): the kernel libraries of the
prefill graphs (through the prefill cache) and of the decode graph are
stored, so a replica warms with no ``nvcc`` build; the graphs are captured
again at every warm-up. ``engine_metrics`` counts the decode graph's
builds, capture, artifacts and swaps (``<name>.engine``).

Not ported yet: trace spans and telemetry export. ``warmup`` captures
every prefill bucket and the decode step.
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import config
from ..device import Context, resolve
from ..parallel import superstep
from ..ops import _build as _kernels
from .artifacts import (ArtifactStore, environment_fingerprint,
                        kernel_payload, params_fingerprint,
                        serialization_supported)
from .batcher import DeadlineExceededError, QueueFullError, ServerClosedError
from .executor_cache import (BucketedExecutorCache, pure_method_runner,
                             release_device_memory, reserved_bytes)
from .metrics import DecodeMetrics, ServingMetrics

__all__ = ["DecodeHandle", "DecodeSession", "KVCache"]

logger = logging.getLogger("mxtpu_torch.serving")


def default_prefill_buckets(max_len: int) -> Tuple[int, ...]:
    """Prompt-length buckets from ``MXTPU_DECODE_BUCKETS`` clipped to the
    cache capacity (a bucket longer than ``max_len`` could never join a
    slot)."""
    raw = str(config.get("MXTPU_DECODE_BUCKETS"))
    buckets = tuple(sorted({int(b) for b in raw.split(",") if b.strip()}))
    clipped = tuple(b for b in buckets if b <= max_len)
    return clipped or (max_len,)


class KVCache:
    """Device-resident per-slot KV planes ``[L, S, H, T, D]`` (k and v).

    Owned by a :class:`DecodeSession` and updated in place by joins and
    decode steps. Freed slots are not zeroed: the next prefill overwrites
    their range and ``cache_len`` guards every attention read."""

    def __init__(self, num_layers: int, slots: int, num_heads: int,
                 max_len: int, head_dim: int, dtype: torch.dtype,
                 device: torch.device):
        self.shape = (int(num_layers), int(slots), int(num_heads),
                      int(max_len), int(head_dim))
        self.k = torch.zeros(self.shape, dtype=dtype, device=device)
        self.v = torch.zeros(self.shape, dtype=dtype, device=device)

    @property
    def nbytes(self) -> int:
        return 2 * self.k.numel() * self.k.element_size()


_DONE = object()


class DecodeHandle:
    """Streaming result of one decode request.

    Iterate to receive generated token ids as the session emits them (one
    per decode step; the first arrives with prefill)::

        for tok in handle:           # blocks per token
            ...
        toks = handle.result(30.0)   # or wait for the full list

    Errors (shed deadline, closed server, failed step) surface from both
    the iterator and ``result``."""

    def __init__(self):
        self._q: _queue.Queue = _queue.Queue()
        self._done = threading.Event()
        self._tokens: List[int] = []
        self._exc: Optional[BaseException] = None
        self._cb_lock = threading.Lock()
        self._callbacks: List = []

    # -- session side -------------------------------------------------------
    def _put(self, tok: int) -> None:
        if self._done.is_set():
            return
        self._tokens.append(int(tok))
        self._q.put(int(tok))

    def _finish(self) -> None:
        if not self._done.is_set():
            self._done.set()
            self._q.put(_DONE)
            self._fire_callbacks()

    def _fail(self, exc: BaseException) -> None:
        if not self._done.is_set():
            self._exc = exc
            self._done.set()
            self._q.put(_DONE)
            self._fire_callbacks()

    def _fire_callbacks(self) -> None:
        with self._cb_lock:
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            try:
                fn(self)
            except Exception:              # noqa: BLE001 — a callback
                logger.exception("decode done-callback failed")  # never
                # breaks the scheduler

    # -- client side --------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self) -> int:
        item = self._q.get()
        if item is _DONE:
            self._q.put(_DONE)       # keep the stream terminal
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def done(self) -> bool:
        return self._done.is_set()

    def add_done_callback(self, fn) -> None:
        """Future-style completion hook: ``fn(handle)`` runs when the
        sequence finishes or fails (at once if it already has). Keep it
        small: it runs on the scheduler thread. The same completion
        surface as the batch tier's ``Future``, which the registry and the
        open-loop harness use."""
        with self._cb_lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def exception(self, timeout: Optional[float] = None):
        """Block until done; the failure (or None)."""
        if not self._done.wait(timeout):
            raise TimeoutError("decode request not finished in time")
        return self._exc

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the sequence finishes; the full generated-token
        list (prompt not included)."""
        if not self._done.wait(timeout):
            raise TimeoutError("decode request not finished in time")
        if self._exc is not None:
            raise self._exc
        return list(self._tokens)

    @property
    def tokens(self) -> List[int]:
        """Tokens generated so far (live view; grows per step)."""
        return list(self._tokens)


class _Request:
    __slots__ = ("prompt", "max_new", "eos_id", "t_submit", "handle")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 eos_id: Optional[int]):
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.t_submit = time.monotonic()
        self.handle = DecodeHandle()


class _Active:
    __slots__ = ("req", "generated", "t_admitted")

    def __init__(self, req: _Request):
        self.req = req
        self.generated = 0
        self.t_admitted = time.monotonic()


class DecodeSession:
    """Continuous-batching greedy decode over one GPT-shaped block.

    ``block`` is a :class:`~..gluon.model_zoo.gpt.GPTDecoder`-shaped block
    (``prefill``/``decode_step``/``num_layers``/``num_heads``/``head_dim``/
    ``max_length``) whose parameters already live on ``ctx`` (default
    ``gpu(0)``). Decoding is greedy (argmax), so the stream matches the
    full-sequence forward oracle token for token. ``artifact_dir``
    (default ``MXTPU_SERVING_ARTIFACT_DIR``) is the persistent artifact
    store, ``model_version`` rides its guard. ``donate`` is accepted for
    the reference's signature: the port always updates the KV cache in
    place (the decode graph writes the cache planes at their addresses),
    which is what donation achieves there, so it needs nothing more.

    Usage::

        sess = DecodeSession(net, ctx=mx.gpu(0), max_slots=8, max_len=512)
        sess.warmup()
        h = sess.submit(prompt_ids, max_new_tokens=64, eos_id=0)
        for tok in h:                      # streams one token per step
            ...
        sess.drain(); sess.close()
    """

    def __init__(self, block, ctx: Optional[Context] = None,
                 max_slots: Optional[int] = None,
                 max_len: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 max_queue: int = 64, name: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 donate: Optional[bool] = None,
                 max_new_tokens: Optional[int] = None,
                 artifact_dir: Optional[str] = None,
                 model_version: str = ""):
        self.device = resolve(ctx)
        param = next(block.parameters())
        if param.device != self.device:
            raise ValueError(f"block parameters live on {param.device}, the "
                             f"session on {self.device}; initialize or load "
                             "the block on the session's ctx")
        self.name = name or "gpt"
        if max_slots is None:
            max_slots = int(config.get("MXTPU_DECODE_SLOTS"))
        if max_len is None:
            max_len = int(config.get("MXTPU_DECODE_MAX_LEN"))
        max_len = min(int(max_len), int(block.max_length))  # position table
        if max_slots < 1 or max_len < 2:
            raise ValueError(f"need max_slots >= 1 and max_len >= 2, got "
                             f"{max_slots}/{max_len}")
        if max_new_tokens is None:
            max_new_tokens = int(config.get("MXTPU_DECODE_MAX_NEW_TOKENS"))
        if deadline_ms is None:
            deadline_ms = float(config.get("MXTPU_SERVING_DEADLINE_MS"))
        self.max_len = max_len
        self.max_slots = int(max_slots)
        self.max_queue = int(max_queue)
        self.default_max_new = int(max_new_tokens)
        self.deadline_ms = None if deadline_ms <= 0 else float(deadline_ms)

        self._block = block
        buckets = tuple(prefill_buckets) if prefill_buckets is not None \
            else default_prefill_buckets(self.max_len)
        bad = [b for b in buckets if b > self.max_len]
        if bad:
            raise ValueError(f"prefill buckets {bad} exceed max_len="
                             f"{self.max_len}")
        self._run, self._params = pure_method_runner(block)
        if artifact_dir is None:
            artifact_dir = str(config.get("MXTPU_SERVING_ARTIFACT_DIR") or "")
        self._prefill_cache = BucketedExecutorCache(
            self._prefill_apply, self._params, buckets=buckets, ctx=ctx,
            name=f"{self.name}.prefill",
            metrics=ServingMetrics(f"{self.name}.prefill"),
            pass_count=True, depad=False, artifact_dir=artifact_dir,
            model_version=model_version)
        # the same walk the tensors came from: a named publish maps a
        # checkpoint onto positions with these
        self._prefill_cache.param_names = list(self._run.param_names)
        self._kv = KVCache(block.num_layers, self.max_slots, block.num_heads,
                           self.max_len, block.head_dim, dtype=param.dtype,
                           device=self.device)
        self.metrics = DecodeMetrics(self.name)
        self.metrics.set_capacity(self._kv.nbytes)
        # the decode graph's builds, capture, artifacts and swaps
        self.engine_metrics = ServingMetrics(f"{self.name}.engine")
        self._store = ArtifactStore(artifact_dir) \
            if artifact_dir and serialization_supported() else None
        self._guard = dict(
            environment_fingerprint(), model=self.name,
            fingerprint=params_fingerprint(self._params),
            version=str(model_version), kv_shape=tuple(self._kv.shape),
            kv_dtype=str(param.dtype).replace("torch.", ""))
        self._decode_kernels: frozenset = frozenset()
        self._decode_built = False
        #: device bytes the decode graph reserves, measured at its capture
        self.graph_bytes = 0
        # live weight hot-swap: a publisher stages off the hot path; the
        # scheduler commits the staged version between decode steps
        self._pending_swap: Optional[dict] = None
        self._weights_version: object = 0
        self._swap_lock = threading.Lock()
        # the captured decode step (CUDA); thread-local capture mode:
        # other threads of the process may use the card meanwhile
        self._graphs = superstep.GraphCache(
            self.device, size=1, capture_error_mode="thread_local") \
            if self.device.type == "cuda" else None
        self._step_ema: Optional[float] = None
        # serializes device work on the cache: the scheduler's prefills
        # (and their joins, which read the prefill graph's static
        # outputs) and steps, and a client's warmup()
        self._exec_lock = threading.Lock()

        # host mirrors of the device cache state — fully determined by
        # scheduler actions, so they are inputs each step, never fetched
        self._cache_len = np.zeros((self.max_slots,), np.int32)
        self._tokens = np.zeros((self.max_slots,), np.int32)
        self._slots: List[Optional[_Active]] = [None] * self.max_slots
        self._free = deque(range(self.max_slots))
        self._pending: deque = deque()
        self._cv = threading.Condition()
        self._state = "running"
        self._worker = threading.Thread(
            target=self._loop, name=f"mxtpu-torch-decode-{self.name}",
            daemon=True)
        self._worker.start()

    # -- construction from a checkpoint ---------------------------------------
    @classmethod
    def from_checkpoint(cls, block, params_path: str, ctx=None,
                        **kwargs) -> "DecodeSession":
        """Load ``params_path`` (an ``mx.nd.save`` checkpoint, as
        ``Block.save_parameters`` writes) into ``block`` on ``ctx`` and
        serve decode from it; the loader is shared with
        ``ModelServer.from_checkpoint`` (``load_block_checkpoint``)."""
        from .server import load_block_checkpoint

        load_block_checkpoint(block, params_path, ctx=ctx)
        return cls(block, ctx=ctx, **kwargs)

    # -- device work ----------------------------------------------------------
    def _prefill_apply(self, tokens: torch.Tensor,
                       n: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(first greedy token (int32 device scalar), k/v planes [L, H, Lb,
        D]) of one prompt padded to its bucket ``Lb``; ``n`` is the true
        length as an int32 device scalar, so the greedy read of the last
        valid position neither synchronizes nor needs a graph per
        length."""
        logits, k, v = self._run(self._block.prefill, tokens[None])
        last = logits[0].index_select(0, (n - 1).long().view(1))[0]
        return torch.argmax(last).to(torch.int32), k[:, 0], v[:, 0]

    def _prefill(self, prompt: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """``_prefill_apply`` of one prompt through the prefill cache: on
        a CUDA device one replay of its bucket's graph, whose static
        outputs the caller consumes under ``_exec_lock``."""
        return self._prefill_cache(prompt)

    def _decode_step(self, tokens: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
        """The step body: ``decode_step`` over every slot (cache updated in
        place) and the greedy next token per slot."""
        with torch.no_grad():
            logits, _, _ = self._block.decode_step(tokens, self._kv.k,
                                                   self._kv.v, cache_len)
            return torch.argmax(logits, dim=-1)

    def _decode(self, cache_len: np.ndarray,
                tokens: np.ndarray) -> torch.Tensor:
        """One decode step over every slot; the next greedy token per slot
        (device). On a CUDA device: the inputs copied into the graph's
        static buffers, one replay; the result is the graph's static
        output, valid until the next step (callers read it under
        ``_exec_lock``)."""
        tok, clen = torch.from_numpy(tokens), torch.from_numpy(cache_len)
        if not self._decode_built:
            return self._build_decode(tok, clen)
        if self.device.type != "cuda":
            return self._decode_step(tok, clen)
        return self._graphs.run((), (tok, clen), self._decode_body, 1,
                                ())[0]

    def _build_decode(self, tok: torch.Tensor,
                      clen: torch.Tensor) -> torch.Tensor:
        """The first step: the decode graph's kernel libraries from the
        artifact store where warm, then its capture (and its first
        replay; on the CPU the eager step), counted in ``engine_metrics``,
        with the memory the card reserves across it
        (:attr:`graph_bytes`)."""
        logical = {"component": "decode"}
        m = self.engine_metrics
        m.cache_miss()
        installed = False
        if self._store is not None:
            t0 = time.perf_counter()
            payload, reason = self._store.load(self.name, logical,
                                               self._guard)
            installed = payload is not None
            if installed:
                m.observe_deserialize(time.perf_counter() - t0)
            else:
                m.artifact_miss(refused=reason.startswith("refused"))
        if self.device.type != "cuda":
            out = self._decode_step(tok, clen)
        else:
            t0 = time.perf_counter()
            with superstep._capture_lock:
                r0 = reserved_bytes(self.device)
                with _kernels.recorded() as rec:
                    out = self._graphs.run((), (tok, clen),
                                           self._decode_body, 1, ())[0]
                self.graph_bytes = reserved_bytes(self.device) - r0
            if rec["built"]:
                m.observe_compile(rec["build_seconds"], len(rec["built"]))
            m.observe_capture(time.perf_counter() - t0
                              - rec["build_seconds"])
            self._decode_kernels = frozenset(rec["loaded"])
        self._decode_built = True
        if self._store is not None and not installed:
            try:
                self._store.save(self.name, logical, self._guard,
                                 kernel_payload(self._decode_kernels))
            except OSError as e:
                logger.warning("artifact persist failed for %s decode: %s",
                               self.name, e)
        return out

    def _decode_body(self, static):
        """The captured body over the static ``(tokens, cache_len)``: its
        capture's warm-up (``capture_steps`` runs the body once first)
        writes the KV rows the step that captures will write anyway."""
        return lambda i: self._decode_step(*static)

    def warmup(self) -> None:
        """Capture every prefill bucket's graph and the decode step's
        ahead of traffic, so the first requests pay no one-time costs (the
        kernel library build and load, allocator growth, library handles,
        the captures). The decode step reuses the current host mirrors, so
        it rewrites exactly what the next real step will write: it is
        harmless while sequences are live."""
        t0 = time.perf_counter()
        with self._exec_lock:
            self._prefill_cache.warmup((), "int32")
            with self._cv:
                cache_len = self._cache_len.copy()
                tokens = self._tokens.copy()
            self._decode(cache_len, tokens).cpu()
        self.engine_metrics.observe_warmup(time.perf_counter() - t0)

    def save_artifacts(self, directory: Optional[str] = None) -> int:
        """Persist the kernel libraries of the whole graph set (the prefill
        buckets and the decode step) so the next replica warms with no
        ``nvcc`` build; returns the artifact count written."""
        if directory is None and self._store is None:
            raise RuntimeError(
                "no artifact store configured: pass artifact_dir= (or "
                "set MXTPU_SERVING_ARTIFACT_DIR), or pass an explicit "
                "directory")
        store = self._store if directory is None \
            else ArtifactStore(directory)
        n = self._prefill_cache.save_artifacts(directory)
        if self._decode_built:
            store.save(self.name, {"component": "decode"}, self._guard,
                       kernel_payload(self._decode_kernels))
            n += 1
        return n

    # -- analytic cost ---------------------------------------------------------
    def _layer_flops(self, rows: int, keys: int) -> float:
        """Multiply-adds (x2) of one layer over ``rows`` query rows that
        each attend to ``keys`` positions: the QKV, output and two FFN
        matmuls, QK^T and PV."""
        b = self._block
        units = b.num_heads * b.head_dim
        hidden = b._cells()[0].ffn1.weight.shape[0]
        dense = 2 * rows * (units * 3 * units + units * units
                            + 2 * units * hidden)
        return dense + 4 * rows * keys * units

    def decode_cost_analysis(self) -> float:
        """FLOPs of ONE decode step over the whole cache (every slot, each
        attending to all ``max_len`` positions, as the step's program
        does): an analytic count from the model's dimensions (the
        reference reads XLA's cost model, which the port does not have)."""
        b = self._block
        s = self.max_slots
        return float(b.num_layers * self._layer_flops(s, self.max_len)
                     + 2 * s * b.num_heads * b.head_dim * b.vocab_size)

    def prefill_cost_analysis(self, bucket: int) -> float:
        """FLOPs of one prefill at ``bucket`` tokens (causal attention over
        the whole padded bucket, the head over every row), analytic as
        :meth:`decode_cost_analysis`."""
        b = self._block
        return float(b.num_layers * self._layer_flops(bucket, bucket)
                     + 2 * bucket * b.num_heads * b.head_dim * b.vocab_size)

    # -- live weight hot-swap --------------------------------------------------
    @property
    def weights_version(self):
        """Version tag of the live weights (0 until the first
        :meth:`publish_weights`)."""
        return self._weights_version

    def publish_weights(self, source, version=None,
                        allow_partial: bool = True,
                        timeout: Optional[float] = 30.0) -> dict:
        """Publish a new weight version into the live session: no drain,
        no capture, nothing dropped. Reading the source, digesting and
        putting changed values on the device happen here, on the
        publisher's thread, while decoding goes on; the scheduler then
        commits the staged version between decode steps (under the
        device lock), so every prefill and every step runs under exactly
        one version. In-flight sequences keep their KV cache (computed
        under the old weights) and continue under the new ones from the
        next step.

        Blocks until the scheduler applies the swap (``timeout``); returns
        the swap stats. On timeout the staged swap is withdrawn: a publish
        reported failed never flips in later."""
        from .server import _resolve_version, _stage_publish

        with self._swap_lock:
            t0 = time.perf_counter()
            staged = _stage_publish(self._prefill_cache, source,
                                    allow_partial, self.name)
            version = _resolve_version(self._weights_version, version)
            applied = threading.Event()
            swap = {"staged": staged, "version": version,
                    "applied": applied}
            with self._cv:
                if self._state != "running":
                    raise ServerClosedError(
                        f"decode session is {self._state}; not "
                        "accepting a weight publish")
                self._pending_swap = swap
                self._cv.notify_all()
            if not applied.wait(timeout):
                with self._cv:
                    if self._pending_swap is swap:
                        # withdraw: the scheduler never saw it, and a
                        # failed publish must not flip in later
                        self._pending_swap = None
                        raise TimeoutError(
                            "weight swap staged but not applied in "
                            "time (is the scheduler thread alive?)")
                # lost the race: the scheduler applied it after the wait
                # expired, so the publish did land
            if "error" in swap:
                raise swap["error"]
            with self._cv:
                if self._state == "closed" \
                        and self._weights_version != version:
                    raise ServerClosedError(
                        "decode session closed before the staged swap "
                        "was applied")
            dt = time.perf_counter() - t0
        stats = dict(staged.stats)
        stats["version"] = version
        stats["seconds"] = round(dt, 4)
        self.engine_metrics.observe_swap()
        return stats

    def _apply_pending_swap(self) -> None:
        """Commit a staged weight version (scheduler thread, between decode
        steps): under the device lock, so no prefill, join or step runs
        meanwhile, and under ``_cv``, so a publisher's timeout either
        withdraws it first or sees it applied."""
        if self._pending_swap is None:
            return
        with self._exec_lock, self._cv:
            swap, self._pending_swap = self._pending_swap, None
            if swap is None:
                return
            try:
                self._prefill_cache.commit_params(swap["staged"])
                self._weights_version = swap["version"]
            except Exception as exc:   # noqa: BLE001 — the publisher raises
                logger.exception("weight swap failed")
                swap["error"] = exc
            finally:
                swap["applied"].set()

    def resident_bytes(self) -> int:
        """Device bytes this session pins: its parameters, the KV cache and
        its graphs' memory (the prefill buckets' and the decode step's:
        the port's own accounting, see ``executor_cache.reserved_bytes``)."""
        return (self._prefill_cache.resident_bytes() + self._kv.nbytes
                + max(0, self.graph_bytes))

    def estimated_wait_s(self) -> float:
        """Queue-wait estimate for a new request (0 while a slot is free
        and nothing queues): the registry's SLO admission signal."""
        with self._cv:
            if self._free and not self._pending:
                return 0.0
            return self._retry_after_locked()

    def release(self) -> None:
        """After :meth:`close`: drop the prefill graphs, the decode graph
        and the KV cache, and give their memory back to the card (what a
        registry eviction does). The session serves no more."""
        with self._exec_lock:
            self._prefill_cache.release()
            if self._graphs is not None:
                self._graphs = superstep.GraphCache(
                    self.device, size=1, capture_error_mode="thread_local")
            self._kv.k = self._kv.v = None
            self._decode_built = False
            self.graph_bytes = 0
        release_device_memory()

    # -- client side ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None) -> DecodeHandle:
        """Enqueue one prompt (1-D int token ids). The sequence joins the
        running batch at the next step boundary with a free slot; tokens
        stream out through the returned handle (greedy; generation stops
        at ``eos_id`` (delivered), ``max_new_tokens``, or cache
        capacity). Raises ``QueueFullError`` (backpressure) /
        ``ServerClosedError``."""
        arr = np.asarray(prompt, np.int32).reshape(-1)
        n = arr.shape[0]
        if n < 1:
            raise ValueError("empty prompt")
        if n > self._prefill_cache.max_batch_size:
            raise ValueError(
                f"prompt of {n} tokens exceeds the largest prefill bucket "
                f"{self._prefill_cache.max_batch_size}; raise "
                "prefill_buckets=")
        if n >= self.max_len:
            raise ValueError(f"prompt of {n} tokens leaves no cache room "
                             f"(max_len={self.max_len})")
        vocab = int(self._block.vocab_size)
        if arr.min() < 0 or arr.max() >= vocab:
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        max_new = self.default_max_new if max_new_tokens is None \
            else int(max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        req = _Request(arr, max_new, eos_id)
        with self._cv:
            if self._state != "running":
                raise ServerClosedError(
                    f"decode session is {self._state}; not accepting")
            if len(self._pending) >= self.max_queue:
                self.metrics.observe_reject()
                raise QueueFullError(
                    f"decode queue full ({self.max_queue} waiting)",
                    retry_after=self._retry_after_locked())
            self._pending.append(req)
            self._cv.notify_all()
        self.metrics.observe_submit()
        return req.handle

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 timeout: Optional[float] = 300.0) -> List[int]:
        """Synchronous :meth:`submit`: the full generated-token list."""
        return self.submit(prompt, max_new_tokens, eos_id).result(timeout)

    def _retry_after_locked(self) -> float:
        # a slot frees after ~max_new steps; estimate from the step EMA
        ema = self._step_ema or 0.01
        waves = (len(self._pending) + self.max_slots - 1) \
            // max(1, self.max_slots)
        return max(0.01, waves * ema * max(1, self.default_max_new) * 0.25)

    # -- scheduler ------------------------------------------------------------
    @property
    def active_slots(self) -> int:
        with self._cv:
            return sum(1 for s in self._slots if s is not None)

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._pending)

    def _loop(self) -> None:
        while True:
            self._apply_pending_swap()
            admits, shed = self._wait_for_work()
            if admits is None:
                return
            for req in shed:
                self.metrics.observe_shed()
                with self._cv:
                    retry_after = self._retry_after_locked()
                req.handle._fail(DeadlineExceededError(
                    f"request exceeded its {self.deadline_ms:.1f} ms "
                    "deadline while queued", retry_after=retry_after))
            for slot, req in admits:
                try:
                    self._prefill_into(slot, req)
                except Exception as exc:   # noqa: BLE001 — fail the caller
                    logger.exception("prefill failed")
                    req.handle._fail(exc)
                    with self._cv:
                        # close() may have already nulled the slot and
                        # refilled _free underneath the prefill: only
                        # free what is still ours
                        if self._slots[slot] is not None:
                            self._slots[slot] = None
                            self._free.append(slot)
            if self.active_slots:
                try:
                    self._step()
                except Exception as exc:   # noqa: BLE001 — worker survives
                    logger.exception("decode step failed; failing the "
                                     "active sequences")
                    with self._cv:
                        active = [(i, s) for i, s in enumerate(self._slots)
                                  if s is not None]
                        for i, _ in active:
                            self._slots[i] = None
                            self._free.append(i)
                            self._cache_len[i] = 0
                            self._tokens[i] = 0
                    for _, s in active:
                        s.req.handle._fail(exc)

    def _wait_for_work(self):
        """Block until there is something to do. Returns ``(admissions,
        shed)``; admissions is None when the worker should exit (closed,
        or drained dry)."""
        with self._cv:
            while True:
                if self._state == "closed":
                    return None, []
                if self._pending_swap is not None:
                    return [], []      # the loop commits it first
                n_active = sum(1 for s in self._slots if s is not None)
                if n_active or (self._pending and self._free):
                    break
                if self._state == "draining" and not self._pending:
                    return None, []
                self._cv.wait(timeout=0.25)
            shed: List[_Request] = []
            admits: List[Tuple[int, _Request]] = []
            if self.deadline_ms is not None:
                # sweep expired requests at EVERY wakeup, not only when a
                # slot is free: while every slot is busy, expired entries
                # must still fail fast and stop counting against
                # max_queue. The queue is FIFO over submit times, so only
                # the front can be expired.
                cutoff = time.monotonic() - self.deadline_ms / 1e3
                while self._pending and self._pending[0].t_submit < cutoff:
                    shed.append(self._pending.popleft())
            while self._pending and self._free:
                req = self._pending.popleft()
                slot = self._free.popleft()
                self._slots[slot] = _Active(req)
                admits.append((slot, req))
            return admits, shed

    def _prefill_into(self, slot: int, req: _Request) -> None:
        """Admit one sequence at a step boundary: prefill its prompt, join
        the K/V planes into the slot's cache range, emit the first greedy
        token."""
        n = int(req.prompt.shape[0])
        t0 = time.perf_counter()
        with self._exec_lock:
            first, k, v = self._prefill(req.prompt)
            bucket = k.shape[2]
            self._kv.k[:, slot, :, :bucket] = k
            self._kv.v[:, slot, :, :bucket] = v
            first_tok = int(first)                    # the D2H fence
        dt = time.perf_counter() - t0
        now = time.monotonic()
        with self._cv:
            st = self._slots[slot]
            if st is None:                 # closed underneath the prefill
                return
            self._cache_len[slot] = n
            self._tokens[slot] = first_tok
        st.generated = 1
        self.metrics.observe_admit(st.t_admitted - req.t_submit, dt)
        self.metrics.observe_first_token(now - req.t_submit)
        req.handle._put(first_tok)
        # capacity cannot end a sequence here: submit() rejects prompts
        # with n >= max_len, so there is always room for one decode step
        if first_tok == req.eos_id or st.generated >= req.max_new:
            self._finish_slot(slot)
        self.metrics.observe_slots(self.active_slots)

    def _step(self) -> None:
        """One decode step for every occupied slot (free slots compute
        too: their rows are ignored and their writes land in freed
        space)."""
        with self._cv:
            active = [i for i, s in enumerate(self._slots) if s is not None]
            cache_len = self._cache_len.copy()
            tokens = self._tokens.copy()
        t0 = time.perf_counter()
        with self._exec_lock:
            nxt = self._decode(cache_len, tokens).cpu().numpy()  # D2H fence
        dt = time.perf_counter() - t0
        self._step_ema = dt if self._step_ema is None \
            else 0.9 * self._step_ema + 0.1 * dt
        self.metrics.observe_step(len(active), dt)
        finished: List[int] = []
        with self._cv:
            for i in active:
                st = self._slots[i]
                if st is None:        # closed underneath us
                    continue
                self._cache_len[i] += 1
                tok = int(nxt[i])
                self._tokens[i] = tok
                st.generated += 1
                st.req.handle._put(tok)
                if (tok == st.req.eos_id or st.generated >= st.req.max_new
                        or self._cache_len[i] >= self.max_len):
                    finished.append(i)
        for i in finished:
            self._finish_slot(i)
        self.metrics.observe_slots(self.active_slots)

    def _finish_slot(self, slot: int) -> None:
        """Retire a finished sequence: resolve its handle and free the slot
        (neighbouring slots keep decoding untouched)."""
        with self._cv:
            st = self._slots[slot]
            if st is None:
                return
            self._slots[slot] = None
            self._free.append(slot)
            # reset the mirrors: a capacity-finished slot would otherwise
            # keep cache_len == max_len and feed an out-of-range position
            # and cache index into every later step (torch raises there)
            self._cache_len[slot] = 0
            self._tokens[slot] = 0
            self._cv.notify_all()
        st.req.handle._finish()
        self.metrics.observe_finish()

    # -- lifecycle ------------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful: refuse new requests, finish every queued and active
        sequence; after ``timeout`` (default
        ``MXTPU_SERVING_DRAIN_TIMEOUT_S``) force-close. True on a clean
        drain."""
        if timeout is None:
            timeout = float(config.get("MXTPU_SERVING_DRAIN_TIMEOUT_S"))
        with self._cv:
            if self._state == "running":
                self._state = "draining"
            self._cv.notify_all()
        self._worker.join(timeout)
        if not self._worker.is_alive():
            return True
        logger.warning(
            "drain of decode session %s did not finish within %.1fs "
            "(queue_depth=%d active=%d); force-closing", self.name,
            timeout, self.queue_depth, self.active_slots)
        self.close(join_timeout=0.5)
        return False

    def close(self, join_timeout: float = 5.0) -> None:
        """Immediate: fail queued and active requests, stop the worker."""
        with self._cv:
            self._state = "closed"
            pending = list(self._pending)
            self._pending.clear()
            active = [s for s in self._slots if s is not None]
            self._slots = [None] * self.max_slots
            self._free = deque(range(self.max_slots))
            self._cache_len[:] = 0
            self._tokens[:] = 0
            swap, self._pending_swap = self._pending_swap, None
            if swap is not None:
                swap["applied"].set()   # a waiting publisher fails fast
            self._cv.notify_all()
        for req in pending:
            req.handle._fail(ServerClosedError("decode session closed"))
        for st in active:
            st.req.handle._fail(ServerClosedError("decode session closed"))
        self._worker.join(timeout=join_timeout)

    def __enter__(self) -> "DecodeSession":
        return self

    def __exit__(self, *exc) -> None:
        if exc and exc[0] is None:
            self.drain(timeout=30.0)
        self.close()

    # -- introspection --------------------------------------------------------
    def healthz(self) -> dict:
        """Readiness probe: ``ready`` only while accepting traffic."""
        with self._cv:
            state = self._state
            depth = len(self._pending)
            active = sum(1 for s in self._slots if s is not None)
        return {
            "ready": state == "running",
            "state": state,
            "model": self.name,
            "queue_depth": depth,
            "slots": {"active": active, "total": self.max_slots},
            "warm": self.engine_metrics.warmup_seconds > 0,
        }

    @property
    def prefill_buckets(self) -> Tuple[int, ...]:
        return self._prefill_cache.buckets

    def stats(self) -> dict:
        snap = self.metrics.snapshot()
        snap["prefill_buckets"] = list(self._prefill_cache.buckets)
        snap["prefill_cache"] = self._prefill_cache.metrics.snapshot()[
            "executor_cache"]
        snap["engine_cache"] = self.engine_metrics.snapshot()[
            "executor_cache"]
        snap["warmup_seconds"] = self.engine_metrics.warmup_seconds
        snap["weights_version"] = self._weights_version
        snap["max_len"] = self.max_len
        if self._step_ema is not None:
            snap["step_ema_ms"] = self._step_ema * 1e3
        return snap
