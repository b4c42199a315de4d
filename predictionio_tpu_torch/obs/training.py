"""Convergence telemetry for batch training and streaming fold-in.

"Is this ALS run converging or just burning iterations?" — the tracker
collects, per source (``"train"`` for the batch ALS loop, ``"stream"``
for the journal-tailing updater), a bounded per-iteration history of
step time, sampled-holdout loss, and factor-delta norm, surfaces the
live values as ``pio_train_convergence_*`` gauges, and summarizes each
finished attempt for the EngineInstance record (``pio status`` prints
the summary; the dashboard's ``/train.json`` proxies the snapshot).

Like the ledger, this is pure bookkeeping and must never take down a
training run: every public method swallows its own errors.

Copied from ``predictionio_tpu/obs/training.py``; its ``METRICS`` is the
port's own registry (``obs/metrics.py``).
"""

from __future__ import annotations

import threading

from .metrics import METRICS

_G_LOSS = METRICS.gauge(
    "pio_train_convergence_loss",
    "latest sampled-holdout loss (RMSE over the sampled ratings for "
    "ALS training; gate metric for streaming)",
    labelnames=("source",))

_G_DELTA = METRICS.gauge(
    "pio_train_convergence_delta_norm",
    "latest relative factor-delta norm ||x_t - x_{t-1}|| / ||x_{t-1}|| "
    "— the direct convergence signal (0 = fixed point)",
    labelnames=("source",))

_G_ITERATION = METRICS.gauge(
    "pio_train_convergence_iteration",
    "latest completed iteration (train) or cycle (stream) number",
    labelnames=("source",))

#: per-source iteration history kept for the dashboard; summaries only
#: need aggregates, so a small bound is plenty
HISTORY_LIMIT = 256


class ConvergenceTracker:
    """Process-wide convergence telemetry, one channel per source."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live: dict[str, dict] = {}
        self._attempts: dict[str, list[dict]] = {}

    def begin(self, source: str, total_iterations: int | None = None) -> None:
        """Open a fresh attempt for ``source`` (prior live state is
        finalized as "superseded" if it never finished)."""
        try:
            with self._lock:
                live = self._live.get(source)
                if live is not None and live["history"]:
                    self._finish_locked(source, "superseded")
                self._live[source] = {
                    "totalIterations": total_iterations,
                    "history": [],
                    "iterations": 0,
                }
        except Exception:
            pass

    def observe(self, source: str, iteration: int, *,
                loss: float | None = None,
                delta_norm: float | None = None,
                step_seconds: float | None = None) -> None:
        """Record one completed iteration/cycle. ``None`` fields are
        simply absent (e.g. the loss sampler was disabled)."""
        try:
            rec = {"iteration": int(iteration)}
            if loss is not None:
                rec["loss"] = float(loss)
                _G_LOSS.set(float(loss), source=source)
            if delta_norm is not None:
                rec["deltaNorm"] = float(delta_norm)
                _G_DELTA.set(float(delta_norm), source=source)
            if step_seconds is not None:
                rec["stepSeconds"] = float(step_seconds)
            _G_ITERATION.set(float(iteration), source=source)
            with self._lock:
                live = self._live.get(source)
                if live is None:
                    live = {"totalIterations": None, "history": [],
                            "iterations": 0}
                    self._live[source] = live
                live["history"].append(rec)
                del live["history"][:-HISTORY_LIMIT]
                live["iterations"] = max(live["iterations"],
                                         int(iteration) + 1)
        except Exception:
            pass

    def finish(self, source: str, status: str = "COMPLETED") -> None:
        """Close the live attempt into the per-source summary list."""
        try:
            with self._lock:
                self._finish_locked(source, status)
        except Exception:
            pass

    def _finish_locked(self, source: str, status: str) -> None:
        live = self._live.pop(source, None)
        if live is None:
            return
        self._attempts.setdefault(source, []).append(
            _summarize(live, status))

    def summaries(self, source: str) -> list[dict]:
        """Finished-attempt summaries, oldest first — the JSON stamped
        into ``EngineInstance.convergence``."""
        with self._lock:
            return [dict(s) for s in self._attempts.get(source, [])]

    def snapshot(self) -> dict:
        """Dashboard/stats view: live history + finished attempts."""
        with self._lock:
            out: dict = {}
            for source in set(self._live) | set(self._attempts):
                live = self._live.get(source)
                out[source] = {
                    "live": {
                        "totalIterations": live["totalIterations"],
                        "iterations": live["iterations"],
                        "history": list(live["history"][-32:]),
                    } if live is not None else None,
                    "attempts": [dict(s)
                                 for s in self._attempts.get(source, [])],
                }
            return out

    def reset_source(self, source: str) -> None:
        """Drop everything for one source (a fresh run_train attempt
        must not inherit a previous run's attempt summaries)."""
        with self._lock:
            self._live.pop(source, None)
            self._attempts.pop(source, None)

    def reset(self) -> None:
        with self._lock:
            self._live.clear()
            self._attempts.clear()


def _summarize(live: dict, status: str) -> dict:
    hist = live["history"]
    losses = [r["loss"] for r in hist if "loss" in r]
    steps = [r["stepSeconds"] for r in hist if "stepSeconds" in r]
    deltas = [r["deltaNorm"] for r in hist if "deltaNorm" in r]
    return {
        "status": status,
        "iterations": live["iterations"],
        "totalIterations": live["totalIterations"],
        "finalLoss": losses[-1] if losses else None,
        "firstLoss": losses[0] if losses else None,
        "finalDeltaNorm": deltas[-1] if deltas else None,
        "meanStepSeconds": (sum(steps) / len(steps)) if steps else None,
    }


#: process-wide singleton, mirroring METRICS / FLIGHT / LEDGER
TRAINING = ConvergenceTracker()
