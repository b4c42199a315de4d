"""PredictionIO on PyTorch and CUDA: the port of ``predictionio_tpu``.

A second package beside the JAX one, which stays the reference. It
imports ``torch`` and never ``jax``, and nothing of ``predictionio_tpu``:
what it needs of that package's pure-Python modules it keeps as copies.
Device work runs on CUDA through hand-written kernels (``csrc/``) unless
a caller asks for ``device="cpu"``, which runs their plain PyTorch
versions.

Two templates serve so far, through the micro-batcher and the HTTP front
end: recommendation (exact top-k over device-resident ALS factors, on the
top-k kernel) and seqrec (a causal-attention next-item model, on the
flash-attention forward kernel).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
