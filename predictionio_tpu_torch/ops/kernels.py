"""The hand-written Hopper kernels: build, binding and launch counts.

- ``csrc/topk.cu`` replaces the Pallas kernel
  ``predictionio_tpu/ops/retrieval.py::_topk_kernel``. Entry points
  ``topk`` and ``topk_rows``: on a CUDA tensor each launches the kernel;
  on a CPU tensor each runs its plain PyTorch version,
  ``ops.retrieval.topk_reference`` / ``topk_rows_reference``.
- ``csrc/flash_attn.cu`` replaces jax's stock Pallas TPU flash-attention
  forward (``_flash_attention_kernel``), which
  ``predictionio_tpu/parallel/ring_attention.py::flash_attention`` calls.
  Entry point ``flash_attention_fwd``, which also writes the per-row
  logsumexp when given a buffer for it.
- ``csrc/flash_attn_bwd.cu`` replaces the same file's two backward kernels
  (``_flash_attention_dkv_kernel``, ``_flash_attention_dq_kernel``).
  Entry points ``flash_attention_bwd_dkv`` and ``flash_attention_bwd_dq``.
  One CTA per output tile, no atomics, so the gradients are the same bits
  from run to run; the streamed Q/dO (or K/V) tiles go through a two-stage
  ``cp.async`` ring. f32 runs SIMT register tiles on CUDA-core FFMAs (no
  TF32); bf16 runs all five products on the tensor cores (``mma.sync``
  m16n8k16 fed by ``ldmatrix``), P and dS rounded to bf16 in registers.

The attention entry points take CUDA tensors only; the CPU dispatch to the
plain versions (``blockwise_attention``, ``blockwise_attention_bwd``) lives
in ``parallel/ring_attention.py``.

The sources are compiled with ``nvcc`` for ``sm_90a`` in one
``torch.utils.cpp_extension.load`` call on first use, into
``predictionio_tpu_torch/_build/``, and bound with ``ctypes``: they have a
plain C interface and include no PyTorch header, which keeps the build to
seconds. The build runs under a lock because the serving micro-batcher
calls from several threads. Every launch goes on the current stream and
raises if the build or the launch fails. ``LAUNCHES`` counts kernel
launches by entry point and nothing else.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "build", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq", "flash_attention_fwd", "topk",
           "topk_rows"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / name for name in (
    "topk.cu", "flash_attn.cu", "flash_attn_bwd.cu"))
BUILD_DIR = _PKG / "_build"

#: Kernel launches per entry point (plain integers; reset by assigning 0).
LAUNCHES = {"topk": 0, "topk_rows": 0, "flash_attention": 0,
            "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build() -> ctypes.CDLL:
    """Compile (first call only) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from torch.utils.cpp_extension import load

        BUILD_DIR.mkdir(exist_ok=True)
        path = load(
            name="pio_kernels", sources=[str(p) for p in SOURCES],
            build_directory=str(BUILD_DIR),
            extra_cuda_cflags=["-O3", "-std=c++17",
                               "-gencode=arch=compute_90a,code=sm_90a"],
            is_python_module=False, verbose=False)
        lib = ctypes.CDLL(path)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pio_topk_workspace.argtypes = [i, ll, i]
        lib.pio_topk_workspace.restype = ll
        lib.pio_topk_init.argtypes = []
        lib.pio_topk_init.restype = i
        lib.pio_topk.argtypes = [p, p, ll, i, p, ll, i, ll, i, p, p, p, p, p]
        lib.pio_topk.restype = i
        lib.pio_flash_attn_init.argtypes = []
        lib.pio_flash_attn_init.restype = i
        f = ctypes.c_float
        lib.pio_flash_attn_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                           f, p]
        lib.pio_flash_attn_fwd.restype = i
        lib.pio_flash_attn_bwd_init.argtypes = []
        lib.pio_flash_attn_bwd_init.restype = i
        lib.pio_flash_attn_bwd_dkv.argtypes = [p] * 8 + [i] * 6 + [f, p]
        lib.pio_flash_attn_bwd_dkv.restype = i
        lib.pio_flash_attn_bwd_dq.argtypes = [p] * 7 + [i] * 6 + [f, p]
        lib.pio_flash_attn_bwd_dq.restype = i
        for init in (lib.pio_topk_init, lib.pio_flash_attn_init,
                     lib.pio_flash_attn_bwd_init):
            err = init()
            if err:
                raise RuntimeError(f"{init.__name__} failed: cudaError {err}")
        _lib = lib
        return lib


def _count(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != device:
        raise ValueError(
            f"{name}: expected a {ndim}-d {dtype} tensor on {device}, got "
            f"{t.dim()}-d {t.dtype} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned "
                         "tensor")


def _launch(name, q, rows, items, n_total: int, k_pad: int):
    from . import retrieval

    dev = items.device
    b_pad = q.shape[0] if rows is None else rows.shape[0]
    _check("items", items, torch.float32, 2, dev)
    _check("queries", q, torch.float32, 2, dev)
    if rows is not None:
        _check("rows", rows, torch.int32, 1, dev)
    n_items, dim = items.shape
    if q.shape[1] != dim or dim % 32 or b_pad % 8:
        raise ValueError(f"{name}: query width {q.shape[1]}, catalog width "
                         f"{dim} (a multiple of 32) and batch {b_pad} (a "
                         "multiple of 8) do not fit")
    if not 0 < k_pad <= n_items or not 0 <= n_total <= n_items:
        raise ValueError(f"{name}: k_pad={k_pad}, n_total={n_total} for a "
                         f"{n_items}-row catalog")
    lib = build()
    ws = torch.empty(lib.pio_topk_workspace(b_pad, n_items, k_pad),
                     dtype=torch.int64, device=dev)
    packed = n_total < retrieval.PACKED_IDX_LIMIT
    if packed:
        out = torch.empty(b_pad, 2 * k_pad, dtype=torch.float32, device=dev)
        ptrs = (out.data_ptr(), None, None)
    else:
        vals = torch.empty(b_pad, k_pad, dtype=torch.float32, device=dev)
        ids = torch.empty(b_pad, k_pad, dtype=torch.int32, device=dev)
        out = (vals, ids)
        ptrs = (None, vals.data_ptr(), ids.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pio_topk(
        q.data_ptr(), None if rows is None else rows.data_ptr(), q.shape[0],
        b_pad, items.data_ptr(), n_items, dim, n_total, k_pad,
        ws.data_ptr(), *ptrs, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    _count(name)
    return out


def _pack(vals: torch.Tensor, ids: torch.Tensor, n_total: int):
    """The kernel's output layout from a plain (vals, ids) pair."""
    from . import retrieval

    if n_total >= retrieval.PACKED_IDX_LIMIT:
        return vals, ids
    return torch.cat([vals, ids.to(torch.float32)], dim=1)


def topk(q: torch.Tensor, items: torch.Tensor, n_total: int, k_pad: int):
    """Top-``k_pad`` of ``q [B_pad, D_pad] @ items [N_pad, D_pad].T`` over
    the first ``n_total`` catalog rows. Returns the packed ``[B_pad,
    2*k_pad]`` f32 buffer (scores, then ids as f32) below
    ``PACKED_IDX_LIMIT``, else ``(vals f32, ids int32)``."""
    if q.device.type == "cpu":
        from .retrieval import topk_reference

        return _pack(*topk_reference(q, items, n_total, k_pad), n_total)
    return _launch("topk", q, None, items, n_total, k_pad)


def topk_rows(rows: torch.Tensor, qtab: torch.Tensor, items: torch.Tensor,
              n_total: int, k_pad: int):
    """``topk`` of the query-table rows ``qtab[rows]``, gathered inside the
    kernel; a row outside ``[0, len(qtab))`` scores as a zero query."""
    if rows.device.type == "cpu":
        from .retrieval import topk_rows_reference

        return _pack(*topk_rows_reference(rows, qtab, items, n_total, k_pad),
                     n_total)
    return _launch("topk_rows", qtab, rows, items, n_total, k_pad)


#: dtype codes of ``pio_flash_attn_fwd``
_ATTN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


#: the backward kernels' grid holds at most this many 64-row tiles
_ATTN_MAX_TILES = 65535


def _attn_args(name: str, qlike: dict, rows: dict) -> tuple[int, ...]:
    """Check the attention tensors: ``qlike`` [B, L, H, D] of one type (f32
    or bf16) and ``rows`` [B, H, L] f32, all CUDA, contiguous and 16-byte
    aligned; return (B, L, H, D). Anything the kernels do not take raises
    ``ValueError`` naming ``name``."""
    q = next(iter(qlike.values()))
    if q.dtype not in _ATTN_DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype}; expected float32 or "
                         "bfloat16")
    if q.dim() != 4 or any(t.shape != q.shape for t in qlike.values()):
        raise ValueError(f"{name}: shapes "
                         f"{[tuple(t.shape) for t in qlike.values()]}; "
                         f"expected {len(qlike)} equal [B, L, H, D]")
    B, L, H, D = q.shape
    if not (0 < B <= 65535 and 0 < H <= 65535 and L > 0
            and D % 8 == 0 and 8 <= D <= 128):
        raise ValueError(f"{name}: shape {tuple(q.shape)}; the kernel takes "
                         "B, H in [1, 65535], L >= 1 and a head dim that is "
                         "a multiple of 8 up to 128")
    if rows and -(-L // 64) > _ATTN_MAX_TILES:
        raise ValueError(f"{name}: L {L} is more than {_ATTN_MAX_TILES} "
                         "tiles of 64")
    for key, t in rows.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, L):
            raise ValueError(f"{name}: {key} is {t.dtype} "
                             f"{tuple(t.shape)}; expected float32 [B, H, L]"
                             f" = {(B, H, L)}")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}; the "
                         "CPU runs the plain version (parallel/"
                         "ring_attention.py)")
    for key, t in qlike.items():
        _check(key, t, q.dtype, 4, dev)
    for key, t in rows.items():
        _check(key, t, torch.float32, 3, dev)
    return B, L, H, D


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool,
                        lse: torch.Tensor | None = None) -> torch.Tensor:
    """``softmax(q k^T / sqrt(D), causal mask) v`` for CUDA tensors
    ``[B, L, H, D]`` of one type (f32 or bf16), contiguous and 16-byte
    aligned, with ``L >= 1`` and a head dim ``D`` that is a multiple of 8
    up to 128. Returns a new ``[B, L, H, D]`` tensor of ``q.dtype``. Given
    ``lse``, a ``[B, H, L]`` f32 CUDA buffer, the kernel also writes each
    row's logsumexp of its scaled scores there (the backward's residual).
    Anything else raises."""
    B, L, H, D = _attn_args("flash_attention_fwd", {"q": q, "k": k, "v": v},
                            {} if lse is None else {"lse": lse})
    lib = build()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.pio_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, L, H, D,
        _ATTN_DTYPES[q.dtype], int(causal), 1.0 / (D**0.5), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError "
                           f"{err}")
    _count("flash_attention")
    return out


def _bwd_args(name, q, k, v, do, lse, di):
    return _attn_args(name, {"q": q, "k": k, "v": v, "do": do},
                      {"lse": lse, "di": di})


def flash_attention_bwd_dkv(q, k, v, do, lse, di, *, causal: bool):
    """``(dk, dv)`` of ``flash_attention_fwd`` for the output gradient
    ``do``: q, k, v, do CUDA ``[B, L, H, D]`` of one type, ``lse`` the
    forward's logsumexp and ``di = rowsum(do * o)``, both ``[B, H, L]``
    f32; the same shape rules as the forward. Returns two new ``[B, L, H,
    D]`` tensors of ``q.dtype``. Anything else raises."""
    B, L, H, D = _bwd_args("flash_attention_bwd_dkv", q, k, v, do, lse, di)
    lib = build()
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.pio_flash_attn_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, L, H,
        D, _ATTN_DTYPES[q.dtype], int(causal), 1.0 / (D**0.5), stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd_dkv kernel launch failed: "
                           f"cudaError {err}")
    _count("flash_attention_bwd_dkv")
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, di, *, causal: bool):
    """``dq`` of ``flash_attention_fwd`` from the same inputs as
    ``flash_attention_bwd_dkv``. Returns a new ``[B, L, H, D]`` tensor of
    ``q.dtype``. Anything else raises."""
    B, L, H, D = _bwd_args("flash_attention_bwd_dq", q, k, v, do, lse, di)
    lib = build()
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.pio_flash_attn_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), B, L, H, D,
        _ATTN_DTYPES[q.dtype], int(causal), 1.0 / (D**0.5), stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd_dq kernel launch failed: "
                           f"cudaError {err}")
    _count("flash_attention_bwd_dq")
    return dq
