"""Per-phase wall-clock timing of a training run.

Copied from ``predictionio_tpu/workflow/tracing.py``: ``phase_timer`` and
the phase report helpers that ``run_train`` persists. The JAX package's
``maybe_profile`` (a ``jax.profiler`` trace) comes to the port, on
``torch.profiler``, with the serving plane's profiling.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time

log = logging.getLogger("predictionio_tpu_torch.workflow")

__all__ = ["phase_timer", "phase_report", "reset_phases", "phase_times_json"]


def reset_phases(ctx) -> None:
    """Start a run (or a supervised RETRY attempt) with a clean slate.

    ``phase_times`` accumulates on the Context object; a retried attempt
    re-runs every phase, so without this reset the breakdown would
    double-count and the persisted record would blame phases for time
    they never spent in the successful attempt."""
    ctx.phase_times = []


def phase_times_json(ctx) -> str:
    """The phase breakdown as a compact JSON list of [phase, seconds]
    pairs — the shape persisted into the EngineInstance record."""
    times = getattr(ctx, "phase_times", None) or []
    return json.dumps([[p, round(dt, 6)] for p, dt in times])


@contextlib.contextmanager
def phase_timer(ctx, phase: str):
    """Time one pipeline phase; record on ctx.phase_times + log."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        times = getattr(ctx, "phase_times", None)
        if times is None:
            times = ctx.phase_times = []
        times.append((phase, dt))
        log.info("phase %-24s %8.3fs", phase, dt)


def phase_report(ctx) -> str:
    """One-line breakdown of every timed phase, longest first."""
    times = getattr(ctx, "phase_times", None) or []
    total = sum(dt for _, dt in times)
    parts = ", ".join(
        f"{p}={dt:.2f}s" for p, dt in sorted(times, key=lambda x: -x[1]))
    return f"total {total:.2f}s ({parts})" if parts else "no phases timed"
