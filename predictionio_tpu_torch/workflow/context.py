"""Workflow context: the ambient state of a training run.

The port of ``predictionio_tpu/workflow/context.py``. Components receive
this ``Context`` as the first argument of their work methods. It holds the
workflow knobs that ``Engine.train`` reads (``WorkflowParams``), the
run's mode and batch label, the device the run trains on (``None`` means
CUDA), the mid-training checkpoint knobs (``checkpoint_dir``,
``checkpoint_every``), with ``checkpointer(subdir)`` namespaced by the
algorithm that ``Engine.train`` is training (``current_algorithm``), and
the event-store binding that data sources read (``app_name``,
``channel_name``, ``event_store()``). Single-process: the sharded
checkpointer, the seed and the mesh come to the port with the slices that
read them.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

__all__ = ["Context", "WorkflowParams"]


@dataclasses.dataclass
class WorkflowParams:
    """(reference: workflow/WorkflowParams.scala)"""

    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False


class Context:
    """Ambient run state: workflow knobs, device, checkpoint knobs and the
    event-store binding."""

    def __init__(self, workflow_params: WorkflowParams | None = None,
                 device=None, *, mode: str = "", batch: str = "",
                 app_name: str | None = None,
                 channel_name: str | None = None,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 0):
        self.workflow_params = workflow_params or WorkflowParams()
        self.mode = mode
        self.batch = batch
        self.app_name = app_name
        self.channel_name = channel_name
        #: where algorithms train: None means CUDA, "cpu" runs the plain
        #: PyTorch versions of the kernels
        self.device = device
        #: mid-training checkpoint/resume knobs (workflow/checkpoint.py);
        #: algorithms that support step-level resume read these
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        #: set by Engine.train around each algorithm's train() call —
        #: namespaces per-algorithm state such as checkpoints
        self.current_algorithm: str | None = None

    def checkpointer(self, subdir: str = ""):
        """TrainCheckpointer for this run, or None when checkpointing is
        off (no ``checkpoint_dir``). The path is namespaced by the
        algorithm currently training (Engine.train sets
        ``current_algorithm``) so multiple algorithm entries never clobber
        each other's steps."""
        if not self.checkpoint_dir:
            return None
        from .checkpoint import TrainCheckpointer

        d = Path(self.checkpoint_dir)
        if self.current_algorithm:
            d = d / self.current_algorithm.replace("/", "_")
        d = d / subdir if subdir else d
        return TrainCheckpointer(d)

    # -- event store access (PEventStore binding) ---------------------------
    def event_store(self):
        from ..store import EventStore

        return EventStore(default_app_name=self.app_name,
                          default_channel_name=self.channel_name)

    def __repr__(self) -> str:
        return (f"Context(mode={self.mode!r}, batch={self.batch!r}, "
                f"device={self.device!r})")
