"""The hand-written Hopper kernels: build, binding and launch counts.

- ``csrc/topk.cu`` replaces the Pallas kernel
  ``predictionio_tpu/ops/retrieval.py::_topk_kernel``. Entry points
  ``topk`` and ``topk_rows``: on a CUDA tensor each launches the kernel;
  on a CPU tensor each runs its plain PyTorch version,
  ``ops.retrieval.topk_reference`` / ``topk_rows_reference``. Stage 1
  keeps each 256-row catalog chunk's best ``min(k_pad, 256)`` keys from
  f32 register tiles: for ``k_pad <= 32`` by a warp selection
  (``topk_select``), else by a warp-wide bitonic sort in registers
  (``topk_sort``); stage 2 merges the chunk lists in rounds spread over
  the card (``topk_merge_round``, one launch a round). One call of either
  entry point runs both stages.
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
- ``csrc/flash_attn_wide_fwd.cu`` and ``csrc/flash_attn_wide.cu`` replace
  no TPU kernel: the same three entry points launch them for head dims
  above 256 (multiples of 128 up to 1,024; the dispatch pads to one), where
  the JAX package runs its plain ``blockwise_attention`` and the narrow
  kernels stop. The forward (``flash_attn_wide_fwd.cu``) is a thread-block
  cluster of D/128 CTAs per 64-row query tile, one CTA a 128-feature slice
  running the narrow kernel's head-dim-128 tile loop (f32 SIMT FFMAs, bf16
  ``mma.sync``); the CTAs sum their partial score tiles through
  distributed shared memory in rank order, so every CTA holds the same
  scores and softmax (``wide_fwd_plan`` is its launch). The backward
  (``flash_attn_wide.cu``) is the same split over the narrow backward's
  head-dim-128 loop: a cluster per 64-row own tile (keys for dK/dV,
  queries for dQ) streaming 32-row tiles, the partial S and dP of a tile
  reduce-scattered together in rank order (``wide_bwd_plan`` is its
  launch). No atomics in either.
- ``csrc/flash_attn_huge.cu`` replaces no TPU kernel either: the same
  three entry points launch it for head dims above 1,024 (multiples of
  128, with no ceiling; the dispatch pads to one). Each runs as passes
  over bands of own tiles, so its workspace stays within 256 MiB. The
  forward: a score pass (one CTA per visible 64 x 64 tile pair: S over
  all of D into an f32 workspace), a softmax pass (a warp a query row:
  the row's max, sum and logsumexp, then P in the input type) and a
  product pass (O = P V, one CTA per 64-row query tile and 128-feature
  slice); ``huge_fwd_plan`` is its launch. The backward: a score pass (S
  and dP, then P and dS into the workspace in the input type) and a
  product pass (the other side's tiles summed in registers);
  ``huge_bwd_plan`` is its launch. f32 on CUDA-core FFMAs, bf16 on
  ``mma.sync``. No atomics.

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
launches and nothing else: by entry point (a top-k call counts once), and
top-k's by kernel as ``pio_topk`` reports them (``topk_select``,
``topk_sort``, and ``topk_merge``, one a merge round).
"""

from __future__ import annotations

import ctypes
import hashlib
import threading
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "build", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq", "flash_attention_fwd", "huge_bwd_plan",
           "huge_bwd_plan_on_card", "huge_fwd_plan", "huge_fwd_plan_on_card",
           "source_digest", "topk", "topk_rows",
           "wide_bwd_plan", "wide_bwd_plan_on_card", "wide_fwd_plan",
           "wide_fwd_plan_on_card"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / name for name in (
    "topk.cu", "flash_attn.cu", "flash_attn_bwd.cu", "flash_attn_wide_fwd.cu",
    "flash_attn_wide.cu", "flash_attn_huge.cu"))
BUILD_DIR = _PKG / "_build"

#: Kernel launches per entry point (plain integers; reset by assigning 0),
#: and by kernel where an entry point has several: top-k's stages, and the
#: attention entry points' wide kernels (head dims from 257 to 1,024) and
#: huge kernels (above 1,024)
LAUNCHES = {"topk": 0, "topk_rows": 0, "topk_select": 0, "topk_sort": 0,
            "topk_merge": 0, "flash_attention": 0,
            "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_wide": 0, "flash_attention_wide_bwd_dkv": 0,
            "flash_attention_wide_bwd_dq": 0, "flash_attention_huge": 0,
            "flash_attention_huge_bwd_dkv": 0,
            "flash_attention_huge_bwd_dq": 0}

#: pio_topk's launched[] slots, in order
_TOPK_KERNELS = ("topk_select", "topk_sort", "topk_merge")

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
        lib.pio_topk.argtypes = [p, p, ll, i, p, ll, i, ll, i, p, p, p, p, p,
                                 p]
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
        lib.pio_flash_attn_wide_init.argtypes = []
        lib.pio_flash_attn_wide_init.restype = i
        lib.pio_flash_attn_wide_fwd.argtypes = (
            lib.pio_flash_attn_fwd.argtypes)
        lib.pio_flash_attn_wide_fwd.restype = i
        lib.pio_flash_attn_wide_fwd_plan.argtypes = [i] * 6 + [p]
        lib.pio_flash_attn_wide_fwd_plan.restype = i
        lib.pio_flash_attn_wide_bwd_init.argtypes = []
        lib.pio_flash_attn_wide_bwd_init.restype = i
        lib.pio_flash_attn_wide_bwd_dkv.argtypes = (
            lib.pio_flash_attn_bwd_dkv.argtypes)
        lib.pio_flash_attn_wide_bwd_dkv.restype = i
        lib.pio_flash_attn_wide_bwd_dq.argtypes = (
            lib.pio_flash_attn_bwd_dq.argtypes)
        lib.pio_flash_attn_wide_bwd_dq.restype = i
        lib.pio_flash_attn_wide_bwd_plan.argtypes = [i] * 7 + [p]
        lib.pio_flash_attn_wide_bwd_plan.restype = i
        lib.pio_flash_attn_huge_workspace.argtypes = [i] * 6
        lib.pio_flash_attn_huge_workspace.restype = ll
        lib.pio_flash_attn_huge_fwd_plan.argtypes = [i] * 6 + [p]
        lib.pio_flash_attn_huge_fwd_plan.restype = i
        lib.pio_flash_attn_huge_bwd_plan.argtypes = [i] * 7 + [p]
        lib.pio_flash_attn_huge_bwd_plan.restype = i
        lib.pio_flash_attn_huge_fwd.argtypes = [p] * 6 + [i] * 6 + [f, p]
        lib.pio_flash_attn_huge_fwd.restype = i
        lib.pio_flash_attn_huge_bwd_dkv.argtypes = [p] * 9 + [i] * 6 + [f, p]
        lib.pio_flash_attn_huge_bwd_dkv.restype = i
        lib.pio_flash_attn_huge_bwd_dq.argtypes = [p] * 8 + [i] * 6 + [f, p]
        lib.pio_flash_attn_huge_bwd_dq.restype = i
        for init in (lib.pio_topk_init, lib.pio_flash_attn_init,
                     lib.pio_flash_attn_bwd_init,
                     lib.pio_flash_attn_wide_init,
                     lib.pio_flash_attn_wide_bwd_init):
            err = init()
            if err:
                raise RuntimeError(f"{init.__name__} failed: cudaError {err}")
        _lib = lib
        return lib


_digest: str | None = None


def source_digest() -> str:
    """sha256 over the sources the kernel library is built from (and the
    headers they include), in build order: what names the built extension
    without building it."""
    global _digest
    if _digest is None:
        h = hashlib.sha256()
        for p in SOURCES + tuple(sorted((_PKG / "csrc").glob("*.cuh"))):
            h.update(p.name.encode() + b"\0" + p.read_bytes())
        _digest = h.hexdigest()
    return _digest


def _count(name: str, n: int = 1) -> None:
    with _lock:
        LAUNCHES[name] += n


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
    launched = (ctypes.c_int * len(_TOPK_KERNELS))()
    err = lib.pio_topk(
        q.data_ptr(), None if rows is None else rows.data_ptr(), q.shape[0],
        b_pad, items.data_ptr(), n_items, dim, n_total, k_pad,
        ws.data_ptr(), *ptrs, stream, launched)
    for kernel, n in zip(_TOPK_KERNELS, launched):
        _count(kernel, n)
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
#: the widest head dim the wide kernels (csrc/flash_attn_wide.cu) take;
#: above it the huge kernels (csrc/flash_attn_huge.cu) take every multiple
#: of 128
WIDE_MAX_HEAD_DIM = 1024

#: the attention kernels' C entry points by route: (forward, dK/dV, dQ)
_ATTN_FNS = {
    "narrow": ("pio_flash_attn_fwd", "pio_flash_attn_bwd_dkv",
               "pio_flash_attn_bwd_dq"),
    "wide": ("pio_flash_attn_wide_fwd", "pio_flash_attn_wide_bwd_dkv",
             "pio_flash_attn_wide_bwd_dq"),
    "huge": ("pio_flash_attn_huge_fwd", "pio_flash_attn_huge_bwd_dkv",
             "pio_flash_attn_huge_bwd_dq"),
}


#: the wide forward (csrc/flash_attn_wide_fwd.cu): features a CTA, query
#: rows (and keys) of a tile, the clusters it takes (D 384 to 1,024), and
#: the score-tile lines the smallest cluster's CTA sums (ceil(64 / 3))
_WIDE_SLICE, _WIDE_TILE, _WIDE_CLUSTERS = 128, 64, range(3, 9)
_WIDE_OWN_MAX = -(-_WIDE_TILE // _WIDE_CLUSTERS[0])
#: the wide forward's plan fields, in pio_flash_attn_wide_fwd_plan's order
_WIDE_PLAN_FIELDS = ("cluster", "grid_x", "grid_y", "grid_z", "threads",
                     "smem_bytes", "max_active_clusters")


def wide_fwd_plan(B: int, L: int, H: int, D: int,
                  dtype: torch.dtype) -> dict:
    """The wide forward's launch, as ``csrc/flash_attn_wide_fwd.cu`` plans
    it (``pio_flash_attn_wide_fwd_plan`` reports the same on the card): a
    cluster of ``D / 128`` CTAs, one a 128-feature slice, per (batch, head,
    64-row query tile); grid ``(cluster * H, B, tiles)``, the query tile
    the slowest axis; threads and dynamic shared memory a CTA (f32: the
    Q slice transposed, the two-stage K/V ring, P, and the partial and
    summed score tiles; bf16: Q, the ring, and the two score tiles); and
    the first query row of the tile each grid z index takes, the last tile
    (under a causal mask the heaviest) first. Raises ``ValueError`` on a
    shape the kernel does not take."""
    n, tiles = D // _WIDE_SLICE, -(-L // _WIDE_TILE)
    if (D % _WIDE_SLICE or n not in _WIDE_CLUSTERS or tiles > _ATTN_MAX_TILES
            or not (0 < B <= 65535 and 0 < H <= 65535 and L > 0)):
        raise ValueError(f"wide forward: B {B}, L {L}, H {H}, D {D}; it "
                         f"takes D a multiple of 128 from 384 to 1,024 and "
                         f"at most {_ATTN_MAX_TILES} query tiles of 64")
    T, S = _WIDE_TILE, _WIDE_SLICE
    lines = T + _WIDE_OWN_MAX  # the partial tile and the owned sums
    if dtype == torch.float32:
        threads = 256
        qt, ring, p = S * (T + 4), 4 * T * (S + 4), T * (T + 4)
        smem = 4 * (qt + ring + p + lines * (T + 4))
    else:
        threads = 128
        smem = 2 * (T + 4 * T) * (S + 8) + 4 * lines * (T + 8)
    return {"cluster": n, "grid": (n * H, B, tiles), "threads": threads,
            "smem_bytes": smem,
            "tile_rows": range((tiles - 1) * T, -1, -T)}


def wide_fwd_plan_on_card(B: int, L: int, H: int, D: int,
                          dtype: torch.dtype, causal: bool) -> dict:
    """``pio_flash_attn_wide_fwd_plan``: the launch the card would make, by
    ``_WIDE_PLAN_FIELDS``, with the clusters it holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    lib = build()
    out = (ctypes.c_int * len(_WIDE_PLAN_FIELDS))()
    err = lib.pio_flash_attn_wide_fwd_plan(B, L, H, D, _ATTN_DTYPES[dtype],
                                           int(causal), out)
    if err:
        raise RuntimeError(f"pio_flash_attn_wide_fwd_plan: cudaError {err}")
    return dict(zip(_WIDE_PLAN_FIELDS, out))


#: the wide backward (csrc/flash_attn_wide.cu): rows of a streamed tile,
#: and its kinds as ``_attn_launch`` numbers them (1 dQ, 2 dK/dV)
_WIDE_STREAM = 32
_WIDE_BWD_KINDS = (1, 2)


def wide_bwd_plan(B: int, L: int, H: int, D: int, dtype: torch.dtype,
                  kind: int) -> dict:
    """The wide backward's launch, as ``csrc/flash_attn_wide.cu`` plans it
    (``pio_flash_attn_wide_bwd_plan`` reports the same on the card) for
    ``kind`` 1 (dQ) or 2 (dK/dV): a cluster of ``D / 128`` CTAs, one a
    128-feature slice, per (batch, head, 64-row own tile: keys for dK/dV,
    query rows for dQ); grid ``(cluster * H, B, tiles)``, the own tile the
    slowest axis; threads and dynamic shared memory a CTA (f32: the own
    slice's two tiles transposed, a three-stage ring of 32-row streamed
    tiles, the tile before's P and dS (dS alone for dQ), the lse and di of
    each stage for dK/dV, the partial [32 streamed][64 S + 64 dP] tile and
    the lines the CTA sums; bf16: the own tiles and the ring row-major,
    the lse and di stages, the partial [64 own][32 S + 32 dP] tile and the
    lines the CTA sums); ``stream_rows``; and the first own row of the tile
    each grid z index takes, the heaviest under a causal mask first (dK/dV
    its first key tiles, dQ its last query tiles). Raises ``ValueError`` on
    a shape or kind the kernels do not take."""
    n, tiles = D // _WIDE_SLICE, -(-L // _WIDE_TILE)
    if (kind not in _WIDE_BWD_KINDS or D % _WIDE_SLICE
            or n not in _WIDE_CLUSTERS or tiles > _ATTN_MAX_TILES
            or not (0 < B <= 65535 and 0 < H <= 65535 and L > 0)):
        raise ValueError(f"wide backward: kind {kind}, B {B}, L {L}, H {H}, "
                         f"D {D}; it takes kind 1 (dQ) or 2 (dK/dV), D a "
                         f"multiple of 128 from 384 to 1,024 and at most "
                         f"{_ATTN_MAX_TILES} own tiles of 64")
    T, S, R, stages = _WIDE_TILE, _WIDE_SLICE, _WIDE_STREAM, 3
    dkv = kind == 2
    rows = 4 * stages * 2 * R if dkv else 0  # lse, di
    if dtype == torch.float32:
        threads = 256
        sx, sy = T + 4, S + 4
        lines = R + -(-R // _WIDE_CLUSTERS[0])  # the partial tile, the sums
        smem = (4 * (2 * S * sx + stages * 2 * R * sy
                     + (2 if dkv else 1) * R * sx + lines * (2 * T + 4))
                + rows)
    else:
        threads = 128
        lines = T + -(-T // _WIDE_CLUSTERS[0])
        smem = (2 * (2 * T + stages * 2 * R) * (S + 8) + rows
                + 4 * lines * (2 * R + 8))
    heavy_first = (range(0, tiles * T, T) if dkv
                   else range((tiles - 1) * T, -1, -T))
    return {"cluster": n, "grid": (n * H, B, tiles), "threads": threads,
            "smem_bytes": smem, "stream_rows": R, "tile_rows": heavy_first}


def wide_bwd_plan_on_card(B: int, L: int, H: int, D: int,
                          dtype: torch.dtype, causal: bool,
                          kind: int) -> dict:
    """``pio_flash_attn_wide_bwd_plan``: the backward launch of ``kind``
    (1 dQ, 2 dK/dV) the card would make, by ``_WIDE_PLAN_FIELDS``, with
    the clusters it holds at once (``cudaOccupancyMaxActiveClusters``)."""
    lib = build()
    out = (ctypes.c_int * len(_WIDE_PLAN_FIELDS))()
    err = lib.pio_flash_attn_wide_bwd_plan(B, L, H, D, _ATTN_DTYPES[dtype],
                                           int(causal), kind, out)
    if err:
        raise RuntimeError(f"pio_flash_attn_wide_bwd_plan: cudaError {err}")
    return dict(zip(_WIDE_PLAN_FIELDS, out))


#: the huge kernels (csrc/flash_attn_huge.cu): rows of a score tile on
#: each side, features of a product CTA's slice, the workspace's cap, and
#: the query rows of a softmax CTA (a warp each)
_HUGE_TILE, _HUGE_SLICE, HUGE_WS_CAP = 64, 128, 256 << 20
_HUGE_SOFTMAX_ROWS = 8
_HUGE_LAUNCH = ("grid_x", "grid_y", "grid_z", "threads", "smem_bytes",
                "blocks_per_sm")
#: pio_flash_attn_huge_bwd_plan's fields, in order: the band, then each
#: pass's launch for the first band
_HUGE_PLAN_FIELDS = ("band_tiles", "band_heads", "bands", "workspace_bytes",
                     *(f"{pass_}_{key}" for pass_ in ("score", "product")
                       for key in _HUGE_LAUNCH))
#: pio_flash_attn_huge_fwd_plan's fields, likewise for its three passes
_HUGE_FWD_PLAN_FIELDS = (*_HUGE_PLAN_FIELDS[:4],
                         *(f"{pass_}_{key}"
                           for pass_ in ("score", "softmax", "product")
                           for key in _HUGE_LAUNCH))


def _huge_seen(kind: int, causal: bool, t: int, nt: int) -> range:
    """The other side's tiles own tile ``t`` sees: dK/dV (kind 2) owns key
    tiles and, under a causal mask, sees the query tiles from its own on;
    dQ (kind 1) and the forward (kind 0) own query tiles and see the key
    tiles up to their own."""
    if not causal:
        return range(nt)
    return range(t, nt) if kind == 2 else range(t + 1)


def _huge_plan(B: int, L: int, H: int, D: int, dtype: torch.dtype,
               kind: int, causal: bool) -> dict:
    """The bands and launches of a huge ``kind`` (0 forward, 1 dQ, 2
    dK/dV), as ``huge_fwd_plan`` and ``huge_bwd_plan`` describe them."""
    what = "backward" if kind else "forward"
    T, nt, bh, cap = _HUGE_TILE, -(-L // _HUGE_TILE), B * H, HUGE_WS_CAP
    if (dtype not in _ATTN_DTYPES or D <= WIDE_MAX_HEAD_DIM
            or D % _HUGE_SLICE
            or not (0 < B <= 65535 and 0 < H <= 65535 and L > 0)):
        raise ValueError(f"huge {what}: {dtype}, B {B}, L {L}, H {H}, D {D};"
                         f" it takes f32 or bf16 and D a multiple of 128 "
                         f"above 1,024")
    esize = 4 if dtype == torch.float32 else 2
    planes = 2 if kind == 2 else 1
    # one visible pair: the forward's f32 S (and its bf16 P), the
    # backward's P and dS or dS alone in the input type
    pair = T * T * (4 + (esize == 2) * 2 if kind == 0 else planes * esize)
    col = nt * pair  # one own tile of one (batch, head)
    if col > cap:
        raise ValueError(f"huge {what}: L {L} needs {col} bytes of "
                         f"workspace for one own tile, above the cap of "
                         f"{cap} bytes")
    per = cap // col
    heads, tiles = (bh, min(nt, per // bh)) if per >= bh else (per, 1)
    bands = []
    for h0 in range(0, bh, heads):
        nh = min(heads, bh - h0)
        for t0 in range(0, nt, tiles):
            if kind == 2:
                own = range(t0, min(nt, t0 + tiles))
            else:
                own = range(nt - 1 - t0, max(0, nt - t0 - tiles) - 1, -1)
            band = {"heads": range(h0, h0 + nh), "tiles": own,
                    "score_grid": (sum(len(_huge_seen(kind, causal, t, nt))
                                       for t in own), nh, 1),
                    "product_grid": (D // _HUGE_SLICE, nh, len(own))}
            if kind == 0:
                band["softmax_grid"] = (
                    _HUGE_TILE // _HUGE_SOFTMAX_ROWS * len(own), nh, 1)
            bands.append(band)
    tiles_a_stage = 2 if kind == 0 else 4
    ring = 2 * tiles_a_stage * T * (128 + 16)  # 128 bytes of features a row
    stage = T * ((T + 16 // esize) + (_HUGE_SLICE + 16 // esize)) * esize
    plan = {"band_tiles": tiles, "band_heads": heads, "bands": bands,
            "workspace_bytes": heads * tiles * col,
            "score": {"grid": bands[0]["score_grid"],
                      "threads": 128 if kind == 0 else 256,
                      "smem_bytes": ring},
            "product": {"grid": bands[0]["product_grid"],
                        "threads": 128 * planes,
                        "smem_bytes": 2 * planes * stage}}
    if kind == 0:
        plan["softmax"] = {"grid": bands[0]["softmax_grid"],
                           "threads": 32 * _HUGE_SOFTMAX_ROWS,
                           "smem_bytes": 0}
    return plan


def huge_fwd_plan(B: int, L: int, H: int, D: int, dtype: torch.dtype,
                  causal: bool = True) -> dict:
    """The huge forward's launch, as ``csrc/flash_attn_huge.cu`` plans it
    (``pio_flash_attn_huge_fwd_plan`` reports the same on the card). Three
    passes a band: ``score`` (a CTA of 128 threads per visible 64 x 64
    tile pair of a (batch, head): S over D through a two-stage ring of the
    Q and K row tiles, 32 f32 or 64 bf16 features, written raw in f32),
    ``softmax`` (a CTA per 8 query rows, a warp a row: the row's max, sum
    and logsumexp, then P in the input type, over S for f32 and into a bf16
    plane after S for bf16) and ``product`` (dQ's: ``D / 128`` slices, the
    (batch, head)s, the own query tiles; O = P V). The workspace holds one
    band's S (and bf16 P) tiles, each own query tile's ``nt`` key tiles,
    ``nt * 64 * 64 * (4 + 2 for bf16)`` bytes an own tile of a (batch,
    head), at most ``HUGE_WS_CAP`` bytes. Bands over own query tiles, the
    last (heaviest under a causal mask) first, as dQ's: ``bands``,
    ``band_tiles``, ``band_heads`` and ``workspace_bytes`` as
    ``huge_bwd_plan`` gives them, each band with its ``softmax_grid`` too;
    ``score``, ``softmax`` and ``product`` give each pass's threads and
    dynamic shared memory a CTA, with the first band's grid. Raises
    ``ValueError`` on a shape the kernels do not take, among them one own
    tile of one (batch, head) above the cap (L above 1,048,576 for f32,
    699,008 for bf16)."""
    return _huge_plan(B, L, H, D, dtype, 0, causal)


def huge_bwd_plan(B: int, L: int, H: int, D: int, dtype: torch.dtype,
                  kind: int, causal: bool = True) -> dict:
    """The huge backward's launch, as ``csrc/flash_attn_huge.cu`` plans it
    (``pio_flash_attn_huge_bwd_plan`` reports the same on the card) for
    ``kind`` 1 (dQ) or 2 (dK/dV). The workspace holds one band's P and dS
    tiles (64 x 64, in the input type; P^T and dS^T for dK/dV, dS for dQ),
    each own tile's ``nt`` other tiles, at most ``HUGE_WS_CAP`` bytes: a
    band is the most own tiles (``band_tiles``) of every (batch, head)
    that fit, or where one own tile of every (batch, head) does not fit,
    one own tile of the most (batch, head)s (``band_heads``). ``bands``
    lists them in launch order, each with its (batch, head)s (``b * H +
    h``), its own tiles in the product pass's order, heaviest first under
    a causal mask (dK/dV from the first key tile, dQ from the last query
    tile), and its score grid (a CTA per visible tile pair of a (batch,
    head), by the (batch, head)s) and product grid (``D / 128`` slices,
    the (batch, head)s, the own tiles). ``score`` and ``product`` give
    each pass's threads and dynamic shared memory a CTA (score: a
    two-stage ring of the four row tiles, 32 f32 or 64 bf16 features;
    product: a two-stage ring of each output's workspace tile and
    128-feature slice), with the first band's grid. Raises ``ValueError``
    on a shape or kind the kernels do not take (among them one own tile of
    one (batch, head) above the cap: L above 524,288 for f32 dK/dV)."""
    if kind not in _WIDE_BWD_KINDS:
        raise ValueError(f"huge backward: kind {kind}; it takes kind 1 (dQ)"
                         f" or 2 (dK/dV)")
    return _huge_plan(B, L, H, D, dtype, kind, causal)


def huge_fwd_plan_on_card(B: int, L: int, H: int, D: int,
                          dtype: torch.dtype, causal: bool) -> dict:
    """``pio_flash_attn_huge_fwd_plan``: the forward launch the card would
    make, by ``_HUGE_FWD_PLAN_FIELDS``, with the CTAs an SM holds at once
    of each pass (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = build()
    out = (ctypes.c_longlong * len(_HUGE_FWD_PLAN_FIELDS))()
    err = lib.pio_flash_attn_huge_fwd_plan(B, L, H, D, _ATTN_DTYPES[dtype],
                                           int(causal), out)
    if err:
        raise RuntimeError(f"pio_flash_attn_huge_fwd_plan: cudaError {err}")
    return dict(zip(_HUGE_FWD_PLAN_FIELDS, out))


def huge_bwd_plan_on_card(B: int, L: int, H: int, D: int,
                          dtype: torch.dtype, causal: bool,
                          kind: int) -> dict:
    """``pio_flash_attn_huge_bwd_plan``: the backward launch of ``kind``
    (1 dQ, 2 dK/dV) the card would make, by ``_HUGE_PLAN_FIELDS``, with
    the CTAs an SM holds at once of each pass
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = build()
    out = (ctypes.c_longlong * len(_HUGE_PLAN_FIELDS))()
    err = lib.pio_flash_attn_huge_bwd_plan(B, L, H, D, _ATTN_DTYPES[dtype],
                                           int(causal), kind, out)
    if err:
        raise RuntimeError(f"pio_flash_attn_huge_bwd_plan: cudaError {err}")
    return dict(zip(_HUGE_PLAN_FIELDS, out))


def _route(D: int) -> str:
    """The kernels a head dim that ``_attn_args`` took goes to: the narrow
    ones up to 256, the wide ones up to ``WIDE_MAX_HEAD_DIM``, the huge
    ones above."""
    return ("narrow" if D <= 256 else "wide" if D <= WIDE_MAX_HEAD_DIM
            else "huge")


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
            and D % 8 == 0 and (8 <= D <= 128 or D == 256 or (
                D % 128 == 0 and D > 256))):
        raise ValueError(f"{name}: shape {tuple(q.shape)}; the kernels take "
                         "B, H in [1, 65535], L >= 1 and a head dim that is "
                         "a multiple of 8 up to 128, 256, or a multiple of "
                         "128 above 256")
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


def _attn_launch(name: str, kind: int, ptrs: list, shape: tuple,
                 dtype: torch.dtype, causal: bool, scale: float | None,
                 device: torch.device) -> None:
    """Launch the entry point ``name``'s kernel (``kind``: 0 forward, 1 dQ,
    2 dK/dV) for ``shape`` on the current stream, with the workspace the
    huge kernels take (as ``huge_fwd_plan`` or ``huge_bwd_plan`` sizes it,
    held equal to the card's), and count it."""
    B, L, H, D = shape
    route, code = _route(D), _ATTN_DTYPES[dtype]
    plan = None  # each plan raises on a shape it refuses
    if route == "wide":
        if kind == 0:
            wide_fwd_plan(B, L, H, D, dtype)
        else:
            wide_bwd_plan(B, L, H, D, dtype, kind)
    elif route == "huge":
        plan = (huge_bwd_plan(B, L, H, D, dtype, kind, causal) if kind
                else huge_fwd_plan(B, L, H, D, dtype, causal))
    lib = build()
    fn = getattr(lib, _ATTN_FNS[route][(0, 2, 1)[kind]])
    extra = []
    if plan is not None:
        card = lib.pio_flash_attn_huge_workspace(B, L, H, D, kind, code)
        nbytes = plan["workspace_bytes"]
        if card != nbytes:
            raise ValueError(f"{name}: the huge kernels refuse shape {shape} "
                             f"or size its workspace otherwise ({card} "
                             f"bytes, the plan {nbytes})")
        extra = [_workspace(nbytes, device).data_ptr()]
    err = fn(*ptrs, *extra, B, L, H, D, code, int(causal), _scale(scale, D),
             _stream(device))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    _count(name)
    if route != "narrow":
        _count(name.replace("flash_attention", f"flash_attention_{route}"))


def _workspace(nbytes: int, device: torch.device) -> torch.Tensor:
    """The huge kernels' scratch: ``nbytes`` bytes on ``device``."""
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, lse: torch.Tensor | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """``softmax(q k^T / sqrt(D), causal mask) v`` for CUDA tensors
    ``[B, L, H, D]`` of one type (f32 or bf16), contiguous and 16-byte
    aligned, with ``L >= 1`` and a head dim ``D`` that is a multiple of 8
    up to 128, or 256 (``csrc/flash_attn.cu``), or a multiple of 128 up to
    1,024 (``csrc/flash_attn_wide_fwd.cu``) or above (``csrc/
    flash_attn_huge.cu``). Returns a new ``[B, L, H, D]`` tensor of
    ``q.dtype``. Given ``lse``, a ``[B, H, L]`` f32 CUDA buffer, the kernel
    also writes each row's logsumexp of its scaled scores there (the
    backward's residual). ``scale`` multiplies the scores, ``1/sqrt(D)`` by
    default. Anything else raises."""
    shape = _attn_args("flash_attention_fwd", {"q": q, "k": k, "v": v},
                       {} if lse is None else {"lse": lse})
    out = torch.empty_like(q)
    _attn_launch("flash_attention", 0,
                 [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr()],
                 shape, q.dtype, causal, scale, q.device)
    return out


def _scale(scale: float | None, D: int) -> float:
    return 1.0 / (D**0.5) if scale is None else float(scale)


def _bwd_args(name, q, k, v, do, lse, di):
    return _attn_args(name, {"q": q, "k": k, "v": v, "do": do},
                      {"lse": lse, "di": di})


def flash_attention_bwd_dkv(q, k, v, do, lse, di, *, causal: bool,
                            scale: float | None = None):
    """``(dk, dv)`` of ``flash_attention_fwd`` for the output gradient
    ``do``: q, k, v, do CUDA ``[B, L, H, D]`` of one type, ``lse`` the
    forward's logsumexp and ``di = rowsum(do * o)``, both ``[B, H, L]``
    f32; the same shape rules and ``scale`` as the forward. Returns two
    new ``[B, L, H, D]`` tensors of ``q.dtype``. Anything else raises."""
    shape = _bwd_args("flash_attention_bwd_dkv", q, k, v, do, lse, di)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _attn_launch("flash_attention_bwd_dkv", 2,
                 [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
                  dv.data_ptr()], shape, q.dtype, causal, scale, q.device)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, di, *, causal: bool,
                           scale: float | None = None):
    """``dq`` of ``flash_attention_fwd`` from the same inputs as
    ``flash_attention_bwd_dkv``. Returns a new ``[B, L, H, D]`` tensor of
    ``q.dtype``. Anything else raises."""
    shape = _bwd_args("flash_attention_bwd_dq", q, k, v, do, lse, di)
    dq = torch.empty_like(q)
    _attn_launch("flash_attention_bwd_dq", 1,
                 [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), di.data_ptr(), dq.data_ptr()],
                 shape, q.dtype, causal, scale, q.device)
    return dq
