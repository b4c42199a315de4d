"""Deterministic fault injection for the serving path (chaos harness).

The resilience layer (request deadlines, the stuck-dispatch watchdog,
degraded mode, graceful drain, the feedback circuit breaker) only earns
its keep if every recovery path can be PROVEN to fire. Real hangs are
not reproducible in CI, so the serving path carries named injection
sites — `FAULTS.fire("microbatch.dispatch")` and friends — that are
zero-cost no-ops until a test arms them (the akka analog is a
supervision-strategy test kit; TensorFlow's nonfatal-failure design,
arXiv:1605.08695 §4.2, bakes the same idea into its runtime).

Sites instrumented in this repo:

- ``microbatch.dispatch``   — inside the dispatch worker thread, before
  ``batch_fn`` runs (a hang here is a hung device call holding one of
  ``max_inflight`` pipeline slots)
- ``retrieval.topk``        — the shared top-k entry every retriever
  funnels through (``ops/retrieval._dispatch_topk``)
- ``server.serve_batch``    — head of ``EngineServer.serve_query_batch``
- ``server.feedback``       — before each feedback POST leaves the
  ``FeedbackPublisher`` (async site)
- ``eventserver.insert``    — inside the event-store write path of
  ``POST /events.json`` (async site; arm a ``StorageError`` to exercise
  the 500/stats path without a broken backend; direct mode only — with a
  journal the write path never touches the backend inline)
- ``journal.append``        — head of ``EventJournal.append`` (sync
  site; an ``error`` is a failing disk → the API answers 500)
- ``journal.fsync``         — before each journal ``os.fsync`` (sync
  site; fires under the journal lock, so a hang models a hung disk
  stalling ingestion)
- ``eventserver.drain``     — before each drainer push of journaled
  records into the backend (async site; arm an un-bounded ``error`` for
  a hard storage outage the 201 acks must survive)
- ``journal.partition_append`` — head of every routed
  ``PartitionedJournal.append``, before the record reaches its
  partition's journal (sync site; an ``error`` is a failing disk on the
  partitioned write path → the API answers 500)
- ``eventserver.drain_partition`` — fired by every per-partition drainer
  right after ``eventserver.drain`` (async site); each drainer ALSO
  fires a dynamic partition-targeted twin
  ``eventserver.drain_partition.p<k>`` — arm that one to wedge a single
  partition's drainer and prove a poison partition browns out alone
  while its siblings keep draining
- ``train.step``            — top of every ALS training iteration
  (``models/als.train_als``; sync site; arm with ``after=N`` to kill a
  run mid-training once checkpoints exist, proving the supervisor
  resumes from the latest checkpoint instead of restarting)
- ``train.persist``         — in ``run_train`` before the serialized
  model blob is inserted (sync site; models a preemption between
  training and persistence — the last moment a run can die with a full
  model's work to lose)
- ``admission.decide``      — head of ``AdmissionController.decide``
  (sync site; an ``error`` proves the fail-OPEN path — overload
  control must never become the outage, so a broken controller admits
  and counts ``decision="error_open"``)
- ``loadgen.slow_device``   — inside the ``pio bench serve`` load
  generator's timed loop (``tools/serve_bench.sweep``), before each
  device top-k call; arm ``slow`` to model a degraded device under
  generated load and watch the latency histogram move
- ``retrieval.ann_build``   — head of the ANN index construction at
  deploy/reload time (``ops/ann.AnnRetriever``; sync site; an
  ``error`` proves a failed k-means/index build degrades the deploy
  to exact retrieval — ``pio_retrieval_exact_fallback`` 1 — instead
  of failing it)
- ``checkpoint.shard_write`` — before a process writes its factor
  shard in ``ShardedTrainCheckpointer.save`` (sync site; an ``error``
  models a host dying mid-save — the step stays partial, the manifest
  never commits, and resume must fall back to the previous complete
  step)
- ``checkpoint.manifest_commit`` — on process 0, after every shard is
  durable but before the manifest rename makes the step complete
  (sync site; a kill here is the torn-manifest window — all shards on
  disk, no manifest — and the step must never be loaded)
- ``train.host_lost``        — head of the cross-host checkpoint
  barrier (sync site; the sync point where a dead peer surfaces to
  survivors — arm an ``error`` to prove the surviving process
  classifies the loss transient and aborts the step cleanly)
- ``stream.tail``            — head of every streaming-updater journal
  poll (``workflow/streaming.StreamingUpdater``; sync site; an
  ``error`` models an unreadable journal partition — the cycle is
  classified transient and retried, tail cursors untouched)
- ``stream.fold_in``         — before each batched fold-in solve in the
  streaming updater (sync site; an ``error`` models a failed device
  dispatch — the batch is retried whole, never half-applied)
- ``stream.publish``         — before each ``POST /reload/delta`` to
  the engine server (sync site; an ``error`` is an unreachable server —
  feeds the publish breaker, and the follow cursor must NOT advance so
  a restart replays the batch; the exactly-once chaos test arms this)
- ``tune.trial``             — head of each trial's supervised
  score-and-record body in ``workflow/tuning.TuneSupervisor`` (sync
  site; an ``error`` with ``times=1`` fails exactly one trial and the
  leaderboard must show that trial FAILED while every other trial
  completes and a winner still promotes)
- ``pipeline.swap``          — the double-buffer handoff in the
  device-resident serving pipeline (``ops/pipeline.ServingPipeline
  .topk_rows``), after the staging buffer is filled and before the
  device step takes it (sync site; arm a ``hang`` to hold one pinned
  staging buffer hostage — the batch must degrade through the
  micro-batcher's watchdog while later dispatches swap to the second
  buffer or a transient one, never wedging the pool)
- ``fleet.route``            — head of the fleet router's routing
  decision (``workflow/fleet.FleetRouter.handle_query``; async site;
  an ``error`` is a routing-tier bug — the router answers 500 and the
  replicas never see the request)
- ``fleet.replica_dispatch`` — before every proxied query attempt to a
  replica (async site; an ``error`` with ``times=1`` kills exactly one
  dispatch and the bounded hedged retry must answer from a sibling
  within the request's remaining deadline budget)
- ``fleet.delta_fanout``     — before each per-replica delta POST in
  the router's streaming fan-out (async site; an ``error`` makes a
  replica miss a patch epoch — the probe loop must reconcile it from
  the journal before it rejoins the eligible set)
- ``replica.blob_pull``      — head of the model-blob fetch in
  ``prepare_deploy`` (sync site; an ``error`` is a poisoned or
  unreachable blob pull — the deploy-with-fallback walk quarantines
  the instance and deploys the next-newest COMPLETED one, or a pinned
  deploy fails loud and the replica never reports ready, keeping it
  out of the router's rotation)
- ``supervisor.respawn``     — in ``workflow/supervise.FleetSupervisor``
  right before a crashed replica's respawn ``Popen`` (sync site; an
  ``error`` is a failed exec — the attempt counts against the crash
  window and the supervisor must re-enter backoff, not busy-loop)
- ``router.state_write``     — inside the atomic tmp+fsync+rename
  state write (``workflow/fleet._atomic_write_json``), after the tmp
  file is durable but before the rename publishes it (sync site; an
  ``error`` is a kill mid-write — the previous ``fleet.json`` /
  ``epoch.json`` must survive intact and parseable)
- ``backup.copy``            — in ``storage/backup.create_backup``
  right before each file enters the snapshot (sync site; a ``hang``
  plus SIGKILL is a host dying mid-backup — the partial backup has no
  manifest so it does not exist, and the previous complete backup
  stays restorable)
- ``restore.apply``          — in ``storage/backup.restore`` right
  before each verified file is materialized into the target home
  (sync site; an ``error`` is a disk filling mid-restore — the
  backup itself is untouched and the restore can be re-run)

A fault is armed per site with a kind:

- ``error``  — raise ``exc`` (default ``FaultInjected``)
- ``slow``   — sleep ``delay_s`` then continue
- ``hang``   — block on a per-site release event, capped at
  ``max_hang_s`` so an un-released hang can never wedge a test past its
  budget; ``release()`` (or ``clear()``) unblocks stuck threads

``times`` bounds how often the fault fires (then it disarms itself), so
a test can hang exactly ``max_inflight`` dispatches and let recovery
traffic through; ``after`` skips the first N calls before the budget
starts (skips don't count as firings), so a training fault can strike
mid-run after checkpoints exist. ``fired(site)`` counts actual firings
for assertions.

Copied from ``predictionio_tpu/workflow/faults.py``; the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import threading
import time

from ..obs.metrics import METRICS

__all__ = ["FaultInjected", "FaultSpec", "FaultInjector", "FAULTS", "SITES"]

#: every named injection site in the codebase — the docstring above
#: documents each; keep the two lists and docs/operations.md in sync
#: (tests/test_train_supervision.py and tests/test_observability.py
#: guard both)
SITES: tuple[str, ...] = (
    "microbatch.dispatch",
    "retrieval.topk",
    "server.serve_batch",
    "server.feedback",
    "eventserver.insert",
    "journal.append",
    "journal.fsync",
    "eventserver.drain",
    "journal.partition_append",
    "eventserver.drain_partition",
    "train.step",
    "train.persist",
    "admission.decide",
    "loadgen.slow_device",
    "retrieval.ann_build",
    "checkpoint.shard_write",
    "checkpoint.manifest_commit",
    "train.host_lost",
    "stream.tail",
    "stream.fold_in",
    "stream.publish",
    "tune.trial",
    "pipeline.swap",
    "fleet.route",
    "fleet.replica_dispatch",
    "fleet.delta_fanout",
    "replica.blob_pull",
    "supervisor.respawn",
    "router.state_write",
    "backup.copy",
    "restore.apply",
)

#: chaos runs must always be measurable: one counter series per site,
#: pre-registered at import so `/metrics` shows a zero before the first
#: firing instead of a missing family
_M_FAULTS = METRICS.counter(
    "faults_injected_total",
    "fault-injection firings by site (workflow/faults.py)",
    labelnames=("site",))
for _site in SITES:
    _M_FAULTS.labels(site=_site).inc(0)


class FaultInjected(RuntimeError):
    """The default exception an armed ``error`` fault raises."""


class FaultSpec:
    """One armed fault: kind + budget + its release latch."""

    __slots__ = ("kind", "exc", "delay_s", "max_hang_s", "times", "after",
                 "release_event")

    def __init__(self, kind: str, *, exc: BaseException | None = None,
                 delay_s: float = 0.05, max_hang_s: float = 30.0,
                 times: int | None = None, after: int = 0):
        if kind not in ("error", "slow", "hang"):
            raise ValueError(f"unknown fault kind {kind!r}")
        self.kind = kind
        self.exc = exc
        self.delay_s = delay_s
        self.max_hang_s = max_hang_s
        self.times = times  # None = every call until cleared
        self.after = after  # skip the first N calls (not counted as fired)
        self.release_event = threading.Event() if kind == "hang" else None


class FaultInjector:
    """Thread-safe registry of armed faults, keyed by site name.

    The un-armed fast path is one attribute read (`_armed` empty-dict
    truthiness) — serving pays nothing when chaos is off.
    """

    def __init__(self):
        self._armed: dict[str, FaultSpec] = {}
        self._fired: dict[str, int] = {}
        # hang events with a thread (possibly) blocked on them — kept
        # separately from _armed so a times-bounded hang that disarmed
        # itself can still be released by clear()/release()
        self._hanging: dict[str, list[threading.Event]] = {}
        self._lock = threading.Lock()

    # -- arming ------------------------------------------------------------
    def inject(self, site: str, kind: str = "error", **kw) -> FaultSpec:
        """Arm ``kind`` at ``site``; returns the spec (its
        ``release_event`` unblocks a ``hang``)."""
        spec = FaultSpec(kind, **kw)
        with self._lock:
            self._armed[site] = spec
        return spec

    def clear(self, site: str | None = None) -> None:
        """Disarm one site (or all), releasing any threads hung there and
        resetting the fired counters — a cleared site starts from a clean
        slate, so per-test teardown isolates ``fired()`` assertions."""
        with self._lock:
            sites = ([site] if site is not None
                     else list(self._armed.keys() | self._hanging.keys()
                               | self._fired.keys()))
            for s in sites:
                spec = self._armed.pop(s, None)
                if spec is not None and spec.release_event is not None:
                    spec.release_event.set()
                for ev in self._hanging.pop(s, []):
                    ev.set()
                self._fired.pop(s, None)

    def release(self, site: str) -> None:
        """Unblock threads hung at ``site`` without disarming it."""
        with self._lock:
            spec = self._armed.get(site)
            hanging = list(self._hanging.get(site, []))
        if spec is not None and spec.release_event is not None:
            spec.release_event.set()
        for ev in hanging:
            ev.set()

    def _enter_hang(self, site: str, ev: threading.Event) -> None:
        with self._lock:
            self._hanging.setdefault(site, []).append(ev)

    def _exit_hang(self, site: str, ev: threading.Event) -> None:
        with self._lock:
            evs = self._hanging.get(site)
            if evs is not None:
                try:
                    evs.remove(ev)
                except ValueError:
                    pass
                if not evs:
                    self._hanging.pop(site, None)

    def fired(self, site: str) -> int:
        with self._lock:
            return self._fired.get(site, 0)

    # -- firing ------------------------------------------------------------
    def _take(self, site: str) -> FaultSpec | None:
        """Book one firing at ``site``; returns the spec to execute, or
        None when nothing (still) armed there."""
        with self._lock:
            spec = self._armed.get(site)
            if spec is None:
                return None
            if spec.after > 0:
                spec.after -= 1
                return None
            if spec.times is not None:
                if spec.times <= 0:
                    self._armed.pop(site, None)
                    return None
                spec.times -= 1
                if spec.times == 0:
                    # disarm now; threads already inside keep their spec
                    self._armed.pop(site, None)
            self._fired[site] = self._fired.get(site, 0) + 1
        _M_FAULTS.labels(site=site).inc()
        return spec

    def fire(self, site: str) -> None:
        """Synchronous site (worker thread / sync handler). No-op unless
        armed."""
        if not self._armed:
            return
        spec = self._take(site)
        if spec is None:
            return
        if spec.kind == "error":
            raise spec.exc if spec.exc is not None else FaultInjected(site)
        if spec.kind == "slow":
            time.sleep(spec.delay_s)
            return
        assert spec.release_event is not None
        self._enter_hang(site, spec.release_event)
        try:
            spec.release_event.wait(spec.max_hang_s)
        finally:
            self._exit_hang(site, spec.release_event)

    async def afire(self, site: str) -> None:
        """Async site (aiohttp handler / publisher task): sleeps and hangs
        must suspend the coroutine, never block the event loop."""
        if not self._armed:
            return
        spec = self._take(site)
        if spec is None:
            return
        if spec.kind == "error":
            raise spec.exc if spec.exc is not None else FaultInjected(site)
        if spec.kind == "slow":
            await asyncio.sleep(spec.delay_s)
            return
        assert spec.release_event is not None
        self._enter_hang(site, spec.release_event)
        try:
            await asyncio.to_thread(spec.release_event.wait, spec.max_hang_s)
        finally:
            self._exit_hang(site, spec.release_event)


#: Process-wide registry. Serving code fires against this; chaos tests
#: arm it and MUST clear it on teardown (tests/conftest.py's chaos guard
#: clears it for marked tests).
FAULTS = FaultInjector()
