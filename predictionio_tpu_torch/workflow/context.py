"""Workflow context: the ambient state of a training run.

The port of ``predictionio_tpu/workflow/context.py``. Components receive
this ``Context`` as the first argument of their work methods. It holds the
workflow knobs that ``Engine.train`` reads (``WorkflowParams``) and the
device the run trains on (``None`` means CUDA). The seed, the mesh, the
checkpointer and the event store come to the port with the slices that
read them.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Context", "WorkflowParams"]


@dataclasses.dataclass
class WorkflowParams:
    """(reference: workflow/WorkflowParams.scala)"""

    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False


class Context:
    """Ambient run state: workflow knobs and device."""

    def __init__(self, workflow_params: WorkflowParams | None = None,
                 device=None):
        self.workflow_params = workflow_params or WorkflowParams()
        #: where algorithms train: None means CUDA, "cpu" runs the plain
        #: PyTorch versions of the kernels
        self.device = device

    def __repr__(self) -> str:
        return f"Context(device={self.device!r})"
