"""TrainSupervisor: checkpoint-restart supervision for training runs.

On TPUs preemption is the NORMAL failure mode, not the exceptional one —
the runtime yanks devices out from under a healthy run, the process dies
or sees a device-lost error, and production systems are expected to come
back from the latest checkpoint on their own (TensorFlow's nonfatal-
failure design, arXiv:1605.08695 §4.2; Google's ads-ranking training
infrastructure makes the same checkpoint-restart loop its availability
backbone, arXiv:2501.10546). The reference PredictionIO has nothing
here: a crashed `pio train` leaves its EngineInstance stuck at INIT
forever and the operator re-runs by hand.

This module closes that gap with three cooperating pieces:

- ``classify_error``: splits *transient* failures (device-lost /
  preemption / transient-OOM message patterns, injected chaos faults,
  and anything wrapped in ``TransientTrainingError``) from *fatal* ones
  (a ValueError in user code retries forever and never gets better).
  ``BaseException``s that aren't ``Exception``s — KeyboardInterrupt,
  SystemExit — are always fatal: the operator asked the run to die.

- ``TrainSupervisor``: runs a train body under bounded jittered-backoff
  retries. The body is re-invoked whole on a transient failure; resume
  comes from ``TrainCheckpointer.restore_first_valid`` inside the
  algorithm, so a retry continues from the latest durable step instead
  of iteration zero. A daemon heartbeat thread stamps liveness
  (``last_heartbeat``/``attempt``) through a caller-provided callback so
  `pio status` and the reaper can tell a live run from an orphan, and an
  optional wall-clock budget aborts a hung attempt cleanly
  (``TrainBudgetExceeded``) instead of wedging the process — the hung
  worker thread is abandoned as a daemon zombie, the same reclamation
  pattern as the serving watchdog.

- ``reap_orphans``: flips stale-heartbeat INIT instances to ABANDONED.
  Run explicitly via `pio admin reap` or automatically at the start of
  every training run, so the instance table converges on the truth even
  when runs die without a survivor to mark them.

Copied from ``predictionio_tpu/workflow/supervisor.py``; the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import replace
from datetime import datetime, timezone
from typing import Any, Callable

from .faults import FaultInjected

log = logging.getLogger("predictionio_tpu.workflow.supervisor")

__all__ = [
    "TransientTrainingError", "TrainBudgetExceeded", "classify_error",
    "TrainSupervisor", "reap_orphans", "DEFAULT_STALE_AFTER_S",
    "HostLostError", "BarrierTimeoutError", "CoordinatorUnreachableError",
    "host_heartbeats", "stale_peers", "check_peer_liveness",
    "DEFAULT_PEER_STALE_AFTER_S",
]

#: An INIT instance whose heartbeat (or, lacking one, start time) is
#: older than this is presumed dead and eligible for reaping.
DEFAULT_STALE_AFTER_S = 600.0

#: A peer process whose per-host heartbeat is older than this is
#: presumed dead (much tighter than the reaper's 10 min: peers beat at
#: heartbeat_s≈5 s, and a survivor blocked on a dead peer's barrier
#: should abort the step, not wait for the orphan reaper).
DEFAULT_PEER_STALE_AFTER_S = 60.0


class TransientTrainingError(RuntimeError):
    """Explicit marker: the wrapped failure is retryable. Engine code can
    raise this around errors the pattern classifier can't know about."""


class HostLostError(TransientTrainingError):
    """A peer process of a multi-host run died (stale peer heartbeat, or
    its absence surfaced at a sync point). Transient by construction:
    the supervisor relaunch resumes from the last complete sharded
    manifest, possibly at a different process count."""


class BarrierTimeoutError(TransientTrainingError):
    """A cross-host barrier (checkpoint shard/manifest sync) timed out —
    the classic symptom of a dead or wedged peer. Survivors abort the
    step cleanly and retry/relaunch from the last complete manifest."""


class CoordinatorUnreachableError(TransientTrainingError):
    """The jax.distributed coordinator (or the shared checkpoint
    filesystem standing in for it) stopped answering. Retryable: a
    restarted coordinator re-forms the cluster and training resumes."""


class TrainBudgetExceeded(RuntimeError):
    """The wall-clock budget expired before the run finished."""


#: Message fragments that mark an exception as transient — the
#: device-lost / preemption / capacity vocabulary of TPU & GPU runtimes
#: (compare tensorflow's UnavailableError/AbortedError retry set).
_TRANSIENT_PATTERNS = (
    "device lost",
    "device is lost",
    "device_lost",
    "preempt",            # "preempted", "preemption notice", ...
    "maintenance event",
    "resource_exhausted",
    "resource exhausted",
    "out of memory",
    "oom",
    "data_loss",
    "unavailable",
    "deadline_exceeded",
    "deadline exceeded",
    "connection reset",
    "socket closed",
    "transient",
    # multi-host failure vocabulary: a dead peer / lost coordinator is
    # the preemption of pod-scale training — always worth a relaunch
    # from the last complete sharded manifest
    "barrier timeout",
    "barrier timed out",
    "coordinator unreachable",
    "coordinator disconnected",
    "host lost",
    "peer heartbeat",
    "heartbeat stale",
)


def classify_error(exc: BaseException) -> str:
    """Return ``"transient"`` (worth a supervised retry) or ``"fatal"``.

    KeyboardInterrupt/SystemExit and every other non-``Exception``
    ``BaseException`` are fatal by construction — retrying an operator's
    Ctrl-C would be hostile.
    """
    if not isinstance(exc, Exception):
        return "fatal"
    if isinstance(exc, (TransientTrainingError, FaultInjected)):
        return "transient"
    if isinstance(exc, (MemoryError, ConnectionError, TimeoutError)):
        return "transient"
    msg = f"{type(exc).__name__}: {exc}".lower()
    if any(p in msg for p in _TRANSIENT_PATTERNS):
        return "transient"
    return "fatal"


def _utcnow_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


class _Heartbeat:
    """Daemon thread stamping liveness every ``interval_s`` via
    ``on_beat(iso_timestamp, attempt)``; attempt updates take effect on
    the next beat, plus an immediate beat at every set_attempt()."""

    def __init__(self, on_beat: Callable[[str, int], None], interval_s: float):
        self._on_beat = on_beat
        self._interval_s = interval_s
        self._attempt = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="train-heartbeat", daemon=True)

    def start(self) -> None:
        self.beat()
        self._thread.start()

    def set_attempt(self, attempt: int) -> None:
        self._attempt = attempt
        self.beat()

    def beat(self) -> None:
        try:
            self._on_beat(_utcnow_iso(), self._attempt)
        except Exception:
            # liveness stamping must never kill the training run
            log.warning("heartbeat stamp failed", exc_info=True)

    def _run(self) -> None:
        while not self._stop.wait(self._interval_s):
            self.beat()

    def stop(self) -> None:
        self._stop.set()
        # join briefly; a daemon thread stuck in a slow stamp can't block
        # run teardown
        self._thread.join(timeout=2.0)


class TrainSupervisor:
    """Retry/heartbeat/budget harness around one training run's body.

    ``run(body)`` invokes ``body()`` up to ``1 + max_retries`` times.
    Transient failures (see ``classify_error``) sleep a jittered
    exponential backoff and re-invoke the body; fatal failures and
    exhausted budgets re-raise immediately. With ``train_budget_s`` set,
    each attempt runs in a worker thread and the overall wall clock is
    enforced across attempts — on expiry the worker is abandoned (daemon
    zombie) and ``TrainBudgetExceeded`` raised.
    """

    def __init__(
        self,
        *,
        max_retries: int = 0,
        retry_backoff_s: float = 1.0,
        backoff_cap_s: float = 60.0,
        train_budget_s: float | None = None,
        heartbeat_s: float = 5.0,
        on_heartbeat: Callable[[str, int], None] | None = None,
        rng: random.Random | None = None,
    ):
        self.max_retries = max(0, int(max_retries))
        self.retry_backoff_s = max(0.0, retry_backoff_s)
        self.backoff_cap_s = backoff_cap_s
        self.train_budget_s = (
            train_budget_s if train_budget_s and train_budget_s > 0 else None)
        self.heartbeat_s = heartbeat_s
        self._on_heartbeat = on_heartbeat
        self._rng = rng or random.Random()
        #: attempts actually started (1-based after run(); exposed for
        #: assertions and the instance record)
        self.attempts = 0
        self.retries_used = 0

    # -- internals ---------------------------------------------------------
    def _backoff(self, retry_index: int) -> float:
        """Jittered exponential backoff: base*2^i capped, scaled by a
        uniform [0.5, 1.0) factor so synchronized preemptees don't
        stampede the scheduler together."""
        raw = min(self.backoff_cap_s, self.retry_backoff_s * (2 ** retry_index))
        return raw * (0.5 + self._rng.random() / 2)

    def _run_attempt(self, body: Callable[[], Any], deadline: float | None) -> Any:
        if deadline is None:
            return body()
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TrainBudgetExceeded(
                f"train budget {self.train_budget_s}s exhausted before "
                f"attempt {self.attempts}")
        holder: dict[str, Any] = {}

        def _target():
            try:
                holder["result"] = body()
            except BaseException as e:  # noqa: BLE001 — relayed to caller
                holder["error"] = e

        t = threading.Thread(target=_target, name="train-attempt", daemon=True)
        t.start()
        t.join(remaining)
        if t.is_alive():
            # abandon the hung attempt — same zombie pattern as the
            # serving watchdog; the daemon thread dies with the process
            raise TrainBudgetExceeded(
                f"train budget {self.train_budget_s}s expired mid-attempt "
                f"{self.attempts}; abandoning the hung training thread")
        if "error" in holder:
            raise holder["error"]
        return holder["result"]

    # -- public ------------------------------------------------------------
    def run(self, body: Callable[[], Any]) -> Any:
        """Run ``body`` under supervision; returns its result or raises
        the final (fatal / budget / retries-exhausted) error."""
        heartbeat = None
        if self._on_heartbeat is not None:
            heartbeat = _Heartbeat(self._on_heartbeat, self.heartbeat_s)
            heartbeat.start()
        deadline = (
            time.monotonic() + self.train_budget_s
            if self.train_budget_s is not None else None)
        try:
            retry = 0
            while True:
                self.attempts += 1
                if heartbeat is not None:
                    heartbeat.set_attempt(self.attempts - 1)
                try:
                    return self._run_attempt(body, deadline)
                except TrainBudgetExceeded:
                    raise
                except BaseException as exc:
                    kind = classify_error(exc)
                    if kind != "transient" or retry >= self.max_retries:
                        if kind == "transient":
                            log.error(
                                "transient training failure, retries "
                                "exhausted (%d/%d): %r",
                                retry, self.max_retries, exc)
                        raise
                    delay = self._backoff(retry)
                    retry += 1
                    self.retries_used = retry
                    log.warning(
                        "transient training failure (attempt %d, retry "
                        "%d/%d), resuming from latest checkpoint in "
                        "%.2fs: %r",
                        self.attempts, retry, self.max_retries, delay, exc)
                    if deadline is not None and (
                            time.monotonic() + delay >= deadline):
                        raise TrainBudgetExceeded(
                            f"train budget {self.train_budget_s}s leaves no "
                            f"room for retry {retry}") from exc
                    time.sleep(delay)
        finally:
            if heartbeat is not None:
                heartbeat.stop()


def _parse_iso(ts: str) -> datetime | None:
    try:
        dt = datetime.fromisoformat(ts)
    except (TypeError, ValueError):
        return None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt


def heartbeat_age_s(instance, *, now: datetime | None = None) -> float | None:
    """Seconds since the instance's last liveness signal (heartbeat, or
    start_time for pre-supervisor records); None when unparseable."""
    now = now or datetime.now(timezone.utc)
    last = _parse_iso(instance.last_heartbeat) if instance.last_heartbeat else None
    if last is None:
        last = instance.start_time
        if last.tzinfo is None:
            last = last.replace(tzinfo=timezone.utc)
    try:
        return (now - last).total_seconds()
    except TypeError:
        return None


def host_heartbeats(instance) -> dict[int, dict]:
    """Per-process liveness stamps from the instance record:
    ``{process_id: {"ts": iso, "attempt": int, ...}}``. Empty for
    single-host / pre-elastic records or unparseable JSON — liveness
    introspection must never throw."""
    import json

    raw = getattr(instance, "host_heartbeats", "") or ""
    if not raw:
        return {}
    try:
        parsed = json.loads(raw)
        return {int(k): dict(v) for k, v in parsed.items()}
    except (ValueError, TypeError, AttributeError):
        return {}


def stale_peers(
    instance,
    *,
    num_processes: int,
    stale_after_s: float = DEFAULT_PEER_STALE_AFTER_S,
    self_id: int | None = None,
    now: datetime | None = None,
) -> list[int]:
    """Process ids of peers presumed dead: never-stamped or stale-stamped
    entries in the instance's per-host heartbeat map. ``self_id`` is
    excluded — a process never declares itself lost."""
    now = now or datetime.now(timezone.utc)
    beats = host_heartbeats(instance)
    out = []
    for pid in range(num_processes):
        if pid == self_id:
            continue
        entry = beats.get(pid)
        ts = _parse_iso(entry.get("ts", "")) if entry else None
        if ts is None or (now - ts).total_seconds() >= stale_after_s:
            out.append(pid)
    return out


def check_peer_liveness(
    instance,
    *,
    num_processes: int,
    stale_after_s: float = DEFAULT_PEER_STALE_AFTER_S,
    self_id: int | None = None,
    now: datetime | None = None,
) -> None:
    """Raise ``HostLostError`` (transient) when any peer's heartbeat in
    the instance record has gone stale — the survivor-side detection of
    a dead worker, checked between steps so the surviving processes
    abort cleanly instead of wedging on the next barrier."""
    dead = stale_peers(instance, num_processes=num_processes,
                       stale_after_s=stale_after_s, self_id=self_id, now=now)
    if dead:
        raise HostLostError(
            f"host lost: peer heartbeat stale (> {stale_after_s:.0f}s) for "
            f"process(es) {dead} of {num_processes}; aborting step — "
            "relaunch resumes from the last complete sharded manifest")


def reap_orphans(
    meta,
    *,
    stale_after_s: float = DEFAULT_STALE_AFTER_S,
    dry_run: bool = False,
    now: datetime | None = None,
) -> list:
    """Flip INIT instances with a stale heartbeat to ABANDONED; returns
    the instances that were (or with ``dry_run`` would be) reaped.

    An INIT row whose supervisor is alive beats at ``heartbeat_s``
    intervals, so anything quiet for ``stale_after_s`` (default 10 min)
    is an orphan from a process that died without marking itself.
    """
    now = now or datetime.now(timezone.utc)
    reaped = []
    for inst in meta.engine_instance_get_by_status("INIT"):
        age = heartbeat_age_s(inst, now=now)
        if age is None or age < stale_after_s:
            continue
        reaped.append(inst)
        if dry_run:
            continue
        meta.engine_instance_update(
            replace(inst, status="ABANDONED", end_time=now))
        log.warning(
            "reaped orphan engine instance %s (INIT, last liveness %.0fs "
            "ago) -> ABANDONED", inst.id, age)
    return reaped
