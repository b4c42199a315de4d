"""Device choice and float32 precision for the whole port.

``resolve_device`` is the one place that picks where the port's tensors
live and the one place that pins full-f32 arithmetic. The JAX package
scores with ``Precision.HIGHEST`` (``predictionio_tpu/ops/retrieval.py``);
a TF32 product keeps about three decimal digits and would reorder
rankings against host float32 references, so TF32 is switched off for
matrix products and convolutions alike. The seqrec model's bf16 ``Dense``
layers accumulate in f32 on XLA; cuBLAS may reduce a bf16 product's
split-K partial sums in bf16 unless told not to, so that is switched off
too.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for (or defaulted
    to) and absent: the port never falls back to the CPU silently; a
    caller that wants the CPU says ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch versions on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision("highest")
    return dev
