"""``ModelRegistry``: N models behind one front door, one device-memory
budget, one persistent artifact store.

Counterpart of the JAX package's ``serving/registry.py`` (the TF-Serving
model-manager layer: load, serve and unload servables, flip versions
without a drain), over the port's serving tier:

* **Routing**: ``submit``/``predict``/``generate`` address models by name;
  forward models answer through their dynamic batcher, decode models
  stream through :class:`~.decode.DecodeHandle`.
* **Budgeted residency with LRU eviction**: a model is *resident* while it
  holds device memory. Admitting a model that would overflow the budget
  (``MXTPU_REGISTRY_BUDGET_MB`` / ``budget_bytes``) evicts least recently
  used **idle** models first; a model with requests in flight or queued is
  never evicted. Eviction closes the server, drops its CUDA graphs, their
  static buffers and pools and its KV cache, and gives the memory back to
  the card (under the capture lock, so no other model's capture is under
  way). The artifact store keeps the kernel libraries on disk, so a
  re-admission runs no ``nvcc``; its graphs are captured again.
* **What a model costs**: ``resident_bytes()`` of its server: parameters,
  KV cache and, the port's own addition, the memory its graphs reserve
  (measured across each capture): a model pins more than its weights.
* **Per-model SLO admission control**: a model may declare a
  ``deadline_ms``; a request whose estimated queue wait already exceeds it
  is rejected at the front door (``DeadlineExceededError`` with
  ``retry_after``).
* **Live weight hot-swap**: ``publish_weights(model, source)`` goes to the
  resident server's no-drain flip; a publish to an evicted model is held
  and applied at its next admission, and every re-admission applies the
  latest publish again.

Builders, not instances, are registered: ``build_fn(artifact_dir)``
returns a fresh ``ModelServer`` or ``DecodeSession`` wired to the
registry's artifact store. A builder that makes its block (weights from a
seed or a checkpoint) lets an eviction free the parameters too; one that
closes over a live block keeps that block's parameters on the card.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

from ..config import config
from .batcher import DeadlineExceededError, QueueFullError
from .decode import DecodeSession
from .executor_cache import release_device_memory
from .metrics import RegistryMetrics
from .server import ModelServer

__all__ = ["ModelRegistry"]

logger = logging.getLogger("mxtpu_torch.serving")


class _Entry:
    __slots__ = ("name", "build_fn", "kind", "deadline_ms", "warmup_fn",
                 "server", "bytes", "last_used", "in_flight", "lock",
                 "published", "admissions", "building")

    def __init__(self, name: str, build_fn: Callable, kind: str,
                 deadline_ms: Optional[float], warmup_fn):
        self.name = name
        self.build_fn = build_fn
        self.kind = kind
        self.deadline_ms = deadline_ms
        self.warmup_fn = warmup_fn
        self.server = None            # None = evicted / never admitted
        self.bytes = 0                # learned at first admission
        self.last_used = 0.0
        self.in_flight = 0
        self.lock = threading.Lock()  # serializes (re)builds per model
        # the latest publish_weights (source, version): the serving
        # version survives eviction — every (re)admission re-applies it
        self.published = None
        self.admissions = 0
        self.building = False         # mid-admission: never a victim


class ModelRegistry:
    """Serve N models from one executor-cache/device-memory budget.

    Usage::

        reg = mx.serving.ModelRegistry(budget_bytes=2 << 30,
                                       artifact_dir="artifacts/")
        reg.register("ranker", lambda ad: mx.serving.ModelServer(
            make_ranker(), artifact_dir=ad, name="ranker"),
            warmup=lambda srv: srv.warmup((256,), "float32"))
        reg.register("gpt", lambda ad: mx.serving.DecodeSession(
            make_gpt(), artifact_dir=ad, name="gpt"),
            kind="decode", warmup=lambda s: s.warmup())

        probs = reg.predict("ranker", features)
        for tok in reg.submit("gpt", prompt_ids):
            ...
    """

    def __init__(self, budget_bytes: Optional[int] = None,
                 max_resident: Optional[int] = None,
                 artifact_dir: Optional[str] = None,
                 name: str = "registry"):
        if budget_bytes is None:
            mb = float(config.get("MXTPU_REGISTRY_BUDGET_MB"))
            budget_bytes = int(mb * 2 ** 20) if mb > 0 else 0
        if max_resident is None:
            max_resident = int(config.get("MXTPU_REGISTRY_MAX_RESIDENT"))
        if artifact_dir is None:
            artifact_dir = str(
                config.get("MXTPU_SERVING_ARTIFACT_DIR") or "")
        self.name = name
        self.budget_bytes = int(budget_bytes)
        self.max_resident = int(max_resident)
        self.artifact_dir = artifact_dir or None
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._lock = threading.RLock()
        self._closed = False
        self.metrics = RegistryMetrics(name)
        self.metrics.set_budget(self.budget_bytes)

    # -- registration ---------------------------------------------------------
    def register(self, name: str, build_fn: Callable[[Optional[str]], Any],
                 kind: str = "forward",
                 deadline_ms: Optional[float] = None,
                 warmup: Optional[Callable[[Any], Any]] = None,
                 resident: bool = False) -> None:
        """Declare a servable. ``build_fn(artifact_dir)`` constructs its
        server (a :class:`ModelServer` for ``kind="forward"``, a
        :class:`DecodeSession` for ``kind="decode"``) — called lazily at
        first use and again after every eviction, with the registry's
        artifact dir so rebuilds warm from disk. ``warmup(server)`` (if
        given) runs after each build — compile/deserialize the bucket
        set before traffic: capture, after installing the kernel libraries
        from the store where warm. ``deadline_ms`` arms front-door SLO
        admission for this model. ``resident=True`` admits eagerly."""
        if kind not in ("forward", "decode"):
            raise ValueError(f"kind must be forward|decode, got {kind!r}")
        with self._lock:
            if self._closed:
                raise RuntimeError("registry is closed")
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered")
            self._entries[name] = _Entry(name, build_fn, kind,
                                         deadline_ms, warmup)
        if resident:
            self._acquire(name, admit_only=True)

    def models(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def resident_models(self) -> List[str]:
        with self._lock:
            return [n for n, e in self._entries.items()
                    if e.server is not None]

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.bytes for e in self._entries.values()
                       if e.server is not None)

    # -- admission / eviction -------------------------------------------------
    def _entry(self, name: str) -> _Entry:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"model {name!r} not registered; known: "
                f"{list(self._entries)}") from None

    def _acquire(self, name: str, admit_only: bool = False) -> _Entry:
        """The entry with a LIVE server; in_flight incremented (unless
        ``admit_only``). Builds — evicting idle LRU models to fit — when
        the model is cold."""
        with self._lock:
            if self._closed:
                raise RuntimeError("registry is closed")
            entry = self._entry(name)
            entry.last_used = time.monotonic()
            self._entries.move_to_end(name)      # MRU position
            if entry.server is not None:
                if not admit_only:
                    entry.in_flight += 1
                return entry
        with entry.lock:                         # one builder per model
            with self._lock:
                if entry.server is None:
                    # known size from a previous residency lets the
                    # budget clear BEFORE the expensive build
                    self._make_room_locked(entry)
                    entry.building = True        # never a victim mid-build
            try:
                if entry.server is None:
                    self._admit(entry)
                with self._lock:
                    # sizes are learned at first admission: re-check the
                    # budget now that entry.bytes is real — best-effort
                    # (the model is already built and about to serve; a
                    # lone over-budget model warns instead of failing)
                    self._make_room_locked(entry, best_effort=True)
                    if not admit_only:
                        entry.in_flight += 1
                    self._publish_residency_locked()
            finally:
                entry.building = False
            return entry

    def _admit(self, entry: _Entry) -> None:
        """Build (or rebuild) one model's server — entry.lock held."""
        t0 = time.perf_counter()
        srv = entry.build_fn(self.artifact_dir)
        expected = DecodeSession if entry.kind == "decode" else ModelServer
        if not isinstance(srv, expected):
            logger.warning(
                "registry model %s: build_fn returned %s for "
                "kind=%s", entry.name, type(srv).__name__, entry.kind)
        if entry.warmup_fn is not None:
            entry.warmup_fn(srv)
        cold = self._looks_cold(srv)
        with self._lock:
            entry.server = srv
            entry.bytes = int(srv.resident_bytes())
            entry.admissions += 1
            published = entry.published
        if published is not None:
            # the registry's serving version survives eviction: every
            # (re)admission re-applies the latest publish, so a rebuild
            # from build_fn's original weights can never silently revert
            source, version = published
            srv.publish_weights(source, version=version)
            self.metrics.observe_swap(entry.name)
        self.metrics.observe_admit(entry.name, cold=cold)
        logger.info("registry %s admitted %s in %.3f s (%.1f MiB, cold %s)",
                    self.name, entry.name, time.perf_counter() - t0,
                    entry.bytes / 2 ** 20, cold)

    @staticmethod
    def _looks_cold(srv) -> bool:
        """Did this build run ``nvcc`` (cold) or find every kernel library
        built (installed from the artifacts, or already in the build
        directory)? For decode sessions both count: the decode graph's
        (``engine_metrics``) and the prefill buckets'."""
        try:
            if isinstance(srv, DecodeSession):
                return (srv.engine_metrics.compiles
                        + srv._prefill_cache.metrics.compiles) > 0
            return srv.metrics.compiles > 0
        except Exception:   # noqa: BLE001 — accounting only
            return True

    def _make_room_locked(self, incoming: Optional[_Entry],
                          best_effort: bool = False) -> None:
        """Evict idle LRU models until ``incoming`` (with its last-known
        size) fits the budget and the residency cap — registry lock
        held; ``incoming`` itself is never a victim. When nothing
        evictable remains (every resident model is in flight), raises
        ``QueueFullError`` — or, with ``best_effort`` (the post-build
        re-check, where the incoming model is already resident and about
        to serve), warns and stops."""
        def resident():
            return [e for e in self._entries.values()
                    if e.server is not None and e is not incoming]

        def over() -> bool:
            n = len(resident()) + (1 if incoming is not None else 0)
            if self.max_resident and n > self.max_resident:
                return True
            if not self.budget_bytes:
                return False
            total = sum(e.bytes for e in resident()) \
                + (incoming.bytes if incoming is not None else 0)
            return total > self.budget_bytes

        while over():
            # oldest-used first; the OrderedDict is maintained in MRU
            # order, so iterate from the front
            victim = None
            for e in self._entries.values():
                if e.server is None or e is incoming or e.building:
                    continue
                if e.in_flight > 0 or self._busy(e):
                    continue          # never evict in-flight models
                victim = e
                break
            if victim is None:
                if best_effort:
                    logger.warning(
                        "registry %s over budget with nothing evictable "
                        "(budget=%dB, resident=%d incl. the admitted "
                        "model); serving anyway", self.name,
                        self.budget_bytes, len(resident()) + 1)
                    return
                raise QueueFullError(
                    f"registry over budget and every resident model is "
                    f"in flight (budget={self.budget_bytes}B, "
                    f"resident={len(resident())})", retry_after=0.5)
            self._evict_locked(victim)

    @staticmethod
    def _busy(entry: _Entry) -> bool:
        srv = entry.server
        try:
            if isinstance(srv, DecodeSession):
                return srv.active_slots > 0 or srv.queue_depth > 0
            return srv.queue_depth > 0
        except Exception:   # noqa: BLE001 — err on the safe side
            return True

    def _evict_locked(self, entry: _Entry) -> None:
        srv, entry.server = entry.server, None
        freed = entry.bytes
        self._shut(entry.name, srv)
        del srv
        release_device_memory()     # the parameters, once nothing holds them
        self.metrics.observe_evict(entry.name)
        logger.info("registry %s evicted idle model %s (%.1f MiB freed)",
                    self.name, entry.name, freed / 2 ** 20)

    @staticmethod
    def _shut(name: str, srv) -> None:
        """Close a server and drop its graphs, static buffers, pools and
        KV cache (``release``)."""
        try:
            srv.close()
            srv.release()
        except Exception:   # noqa: BLE001 — an idle close never blocks
            logger.exception("evicting %s: close failed", name)

    def evict(self, name: str) -> bool:
        """Explicitly evict one idle model (False when it is in flight
        or not resident). Its artifacts stay on disk: the next use
        re-admits with no kernel build."""
        with self._lock:
            entry = self._entry(name)
            if entry.server is None or entry.building:
                # building: a first-use admission holds the server but
                # has not yet counted itself in flight — evicting here
                # would null the server under the submit that built it
                return False
            if entry.in_flight > 0 or self._busy(entry):
                return False
            self._evict_locked(entry)
            self._publish_residency_locked()
            return True

    def _publish_residency_locked(self) -> None:
        n = sum(1 for e in self._entries.values() if e.server is not None)
        b = sum(e.bytes for e in self._entries.values()
                if e.server is not None)
        self.metrics.set_residency(n, b)

    def _release(self, entry: _Entry) -> None:
        with self._lock:
            entry.in_flight = max(0, entry.in_flight - 1)

    # -- the routing front door -----------------------------------------------
    def submit(self, model: str, payload, **kwargs):
        """Route one request: a forward model returns the batcher's
        ``Future``, a decode model a streaming
        :class:`~.decode.DecodeHandle` (``payload`` = prompt token ids;
        ``max_new_tokens=``/``eos_id=`` pass through). Cold models are
        admitted first (evicting idle LRU models to fit); per-model SLO
        admission rejects requests whose queue-wait estimate already
        exceeds the model's ``deadline_ms``."""
        entry = self._acquire(model)
        try:
            if entry.deadline_ms is not None:
                est = entry.server.estimated_wait_s()
                if est * 1e3 > entry.deadline_ms:
                    self.metrics.observe_slo_rejection(model)
                    raise DeadlineExceededError(
                        f"{model}: estimated wait {est * 1e3:.1f} ms "
                        f"already exceeds the {entry.deadline_ms:.1f} ms "
                        "deadline; rejected at admission",
                        retry_after=est)
            handle = entry.server.submit(payload, **kwargs)
        except BaseException:
            self._release(entry)
            raise
        handle.add_done_callback(lambda _obj: self._release(entry))
        return handle

    def predict(self, model: str, example,
                timeout: Optional[float] = 60.0):
        """Synchronous forward request through the batcher."""
        return self.submit(model, example).result(timeout=timeout)

    def generate(self, model: str, prompt,
                 max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 timeout: Optional[float] = 300.0) -> List[int]:
        """Synchronous decode request — the full generated-token list."""
        return self.submit(model, prompt, max_new_tokens=max_new_tokens,
                           eos_id=eos_id).result(timeout)

    def server(self, model: str):
        """The model's LIVE server (admitting it if evicted) — for
        warmup calls, stats, or direct submission. Does not count as
        in-flight; prefer :meth:`submit` for traffic."""
        return self._acquire(model, admit_only=True).server

    # -- weight publication ---------------------------------------------------
    def publish_weights(self, model: str, source, version=None) -> dict:
        """Hot-swap a model's weights without drain: resident models
        flip live (see ``ModelServer.publish_weights``); an evicted
        model defers the flip to its next admission (a cold model never
        pays device memory just to receive weights). Either way the
        publish is RECORDED on the entry, and every later (re)admission
        re-applies it — an eviction can never revert the serving
        version, and a flip racing an eviction is recovered at the next
        admit."""
        with self._lock:
            entry = self._entry(model)
            entry.published = (source, version)
            srv = entry.server
            if srv is None:
                return {"deferred": True, "version": version}
        stats = srv.publish_weights(source, version=version)
        self.metrics.observe_swap(model)
        return stats

    # -- lifecycle / introspection --------------------------------------------
    def healthz(self) -> dict:
        """Aggregate readiness: the registry routes as long as it is
        open; per-model readiness rides along for load balancers that
        route per model."""
        with self._lock:
            models = {}
            for n, e in self._entries.items():
                if e.server is None:
                    models[n] = {"resident": False, "ready": True,
                                 "bytes": e.bytes}
                else:
                    h = e.server.healthz()
                    models[n] = {"resident": True,
                                 "ready": bool(h.get("ready")),
                                 "in_flight": e.in_flight,
                                 "bytes": e.bytes}
            return {
                "ready": not self._closed,
                "registry": self.name,
                "resident": sum(1 for m in models.values()
                                if m["resident"]),
                "resident_bytes": sum(e.bytes
                                      for e in self._entries.values()
                                      if e.server is not None),
                "budget_bytes": self.budget_bytes,
                "models": models,
            }

    def stats(self) -> dict:
        snap = self.metrics.snapshot()
        with self._lock:
            snap["models"] = {
                n: (e.server.stats() if e.server is not None
                    else {"resident": False, "admissions": e.admissions})
                for n, e in self._entries.items()}
        return snap

    def close(self) -> None:
        """Drain-free shutdown of every resident server."""
        with self._lock:
            self._closed = True
            servers = [(n, e) for n, e in self._entries.items()
                       if e.server is not None]
        for _, e in servers:
            srv, e.server = e.server, None
            self._shut(e.name, srv)
        del servers
        release_device_memory()
        with self._lock:
            self._publish_residency_locked()

    def __enter__(self) -> "ModelRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
