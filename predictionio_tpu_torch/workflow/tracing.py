"""Per-phase wall-clock timing of a training run.

Copied from ``predictionio_tpu/workflow/tracing.py``: ``phase_timer``
only. The JAX package's ``maybe_profile`` (a ``jax.profiler`` trace) and
the phase report helpers come to the port with the CLI.
"""

from __future__ import annotations

import contextlib
import logging
import time

log = logging.getLogger("predictionio_tpu_torch.workflow")

__all__ = ["phase_timer"]


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
