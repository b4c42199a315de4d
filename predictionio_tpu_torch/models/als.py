"""Blocked WALS matrix factorization: training and serving.

The port of ``predictionio_tpu/models/als.py``: ``ALSConfig``, the serving
half of ``ALSModel`` (scoring, top-N recommendation through the retrieval
mixin — the kernel once a retriever is attached — and the exact host
float64 fold-in of new users), and blocked WALS training:
``put_layout``, ``_gram_blocks``, ``_ridge``, ``_spd_solve``,
``_solve_side``, ``_half_step``, ``make_train_step`` and ``train_als``.

The reference computes the half-step as XLA ops (a factor gather, batched
einsum gramians, ``segment_sum`` and a ``fori_loop`` CG; its Pallas
gramian kernel was tried and dropped). The port computes the same
arithmetic as PyTorch tensor ops: ``index_select`` gathers, ``torch.bmm``
gramians, a segmented reduction for the chunked tier and ``torch.linalg``
for the exact solvers. The design is the reference's: ratings live as
padded fixed-shape neighbor blocks in a PERMUTED two-sided layout
(``ops/neighbors.py::build_bilinear_layout``), built once on the host and
resident on the device for every iteration; each half-step forms per-row
normal equations A_u = Σ_j v_j v_jᵀ, b_u = Σ_j r_uj v_j tier by tier and
solves them with a Jacobi-preconditioned batched CG (or cholesky / LU);
tier outputs concatenate into the permuted factor array, so the step
holds no scatter. Rows heavier than ``chunk_cap`` ride a dedicated tier as
balanced chunks whose partial equations are summed per owner row.
Implicit feedback (Hu-Koren-Volinsky): confidence c = 1 + alpha·r with the
VᵀV gramian term. Regularization matches MLlib's ALS-WR: λ scaled by each
row's degree in explicit mode; plain λ in implicit mode.

Where the port takes care (each is named again where the code handles it):

- **Full f32.** Every entry point goes through ``resolve_device``, so TF32
  stays off. At ``compute_dtype="bfloat16"`` the factors are rounded to
  bf16 and then upcast to f32 before the product: products of bf16 values
  are exact in f32, so this is the reference's ``preferred_element_type=
  f32`` arithmetic (a bf16 ``torch.bmm`` would round its output to bf16).
  The bf16 roundings of ``cw = alpha·vals`` and of CG's matvec copy of A
  are kept.
- **Run-to-run determinism.** The chunked tier's per-owner sums use a
  segmented reduction in a fixed order, never ``index_add_`` (its CUDA
  atomics change the summation order between runs).
- **The zero slot.** Padded ids point at the other side's ``zero_slot``;
  every half-step writes an all-zero tail, so padded gathers read zeros.
- **No fallback.** On a CUDA tensor every step runs on the card; a
  failure raises.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from .. import prng
from ..device import resolve_device
from ..obs.metrics import METRICS
from ..obs.training import TRAINING
from ..ops.neighbors import build_bilinear_layout
from ..ops.retrieval import RetrievalServingMixin
from ..storage.bimap import BiMap
from ..storage.frame import Ratings

log = logging.getLogger("predictionio_tpu_torch.als")

_M_TRAIN_STEP = METRICS.histogram(
    "pio_train_step_seconds",
    "one ALS alternation (user+item half-steps); a step observes its own "
    "device time only where the convergence probe reads its factors")

__all__ = ["ALSModel", "ALSConfig", "make_train_step", "put_layout",
           "train_als"]

#: equation-concat budget for _solve_side: below this, all tiers' normal
#: equations concatenate into ONE batched solve (fewest launches); above
#: it, tiers solve piece-wise so peak memory is bounded by the budget
#: instead of [all rows, R, R]. Same math either way: the batched CG is
#: row-independent. The reference's value, kept so both packages take the
#: same branch on the same data.
SOLVE_EQ_BUDGET_BYTES = 1024**3

#: the CG inner-solver depth, one source of truth: cold solves (no x0)
#: run DEFAULT_CG_ITERS Jacobi-preconditioned iterations; the training
#: sweep warm-starts each solve from the row's previous factors and runs
#: DEFAULT_CG_ITERS_WARM (the reference's accuracy gate chose 4: depth 3
#: passed its 1e-3 gap with too thin a margin). Implicit mode's normal
#: equations are worse conditioned and less diagonal, so it runs deeper.
DEFAULT_CG_ITERS = 8
DEFAULT_CG_ITERS_WARM = 4
DEFAULT_CG_ITERS_IMPLICIT = 16


def _resolve_cg_iters(cg_iters, implicit: bool, *, warm: bool = False) -> int:
    if cg_iters is not None:
        return cg_iters
    if implicit:
        # implicit normal equations are worse conditioned and less
        # diagonal (Jacobi helps less) — no measured warm shortcut
        return DEFAULT_CG_ITERS_IMPLICIT
    return DEFAULT_CG_ITERS_WARM if warm else DEFAULT_CG_ITERS


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    rank: int = 32
    iterations: int = 10
    lambda_: float = 0.1
    implicit_prefs: bool = False
    alpha: float = 1.0  # implicit confidence scale
    #: degree tiers of the bucketed layout. "auto" (default) computes
    #: histogram-optimal edges — zero dropped entries, ~5-15% padding; an
    #: explicit tuple is auto-extended to the observed max so it is
    #: lossless too
    tiers: tuple | str = "auto"
    #: per-block gather budget in elements (B*D cap) — bounds peak memory
    gather_budget: int = 2_000_000
    #: rows heavier than this split into balanced chunks riding a
    #: dedicated tier, partial normal equations segment-summed per owner
    chunk_cap: int = 2048
    #: "bfloat16" rounds the gathered factors, the confidence weights and
    #: CG's copy of the equations to bf16 (products and sums stay f32);
    #: "float32" is the bit-stable default
    compute_dtype: str = "float32"
    #: normal-equation solver: "cg" (batched conjugate gradient),
    #: "cholesky", or "lu"
    solver: str = "cg"
    #: CG iteration count; None = auto (DEFAULT_CG_ITERS* above)
    cg_iters: int | None = None
    #: shard the factor matrices' rows over a mesh's ``model`` axis; on
    #: the port's one device, training logs this and keeps the factors
    #: replicated (the reference's behaviour on a mesh without that axis)
    model_sharded: bool = False
    seed: int = 7


@dataclasses.dataclass
class ALSModel(RetrievalServingMixin):
    """Trained factors + id maps. Arrays are host numpy (device-independent
    for checkpointing); serving moves them to the device when a retriever
    is attached."""

    user_factors: np.ndarray  # [num_users, rank] f32
    item_factors: np.ndarray  # [num_items, rank] f32
    user_ids: BiMap  # str -> row
    item_ids: BiMap  # str -> row
    config: ALSConfig

    def __setattr__(self, name, value):
        # _vtv_cache is derived from item_factors; replacing the factors
        # must drop it or fold-in keeps solving against the OLD VᵀV.
        # In-place mutation (item_factors[:] = ...) bypasses this — call
        # invalidate_item_caches() explicitly there.
        super().__setattr__(name, value)
        if name == "item_factors":
            self.__dict__.pop("_vtv_cache", None)

    def invalidate_item_caches(self) -> None:
        """Drop every cache derived from ``item_factors``. Assigning a new
        ``item_factors`` array does this automatically; call this after
        mutating the array IN PLACE."""
        self.__dict__.pop("_vtv_cache", None)

    # -- serving-side scoring ------------------------------------------------
    def scores_for_user(self, user_id: str) -> np.ndarray | None:
        row = self.user_ids.get(user_id)
        if row is None:
            return None
        return self.item_factors @ self.user_factors[row]

    def recommend_products(self, user_id: str, num: int) -> list[tuple[str, float]]:
        """Top-N items for a user (reference ALSModel.recommendProducts,
        examples/.../ALSModel.scala:200-219)."""
        row = self.user_ids.get(user_id)
        if row is None:
            return []
        return self.top_n_from_catalog(self.user_factors[row], num)

    def fold_in_user(self, item_ids: list, ratings=None) -> "np.ndarray | None":
        """Exact WALS fold-in: solve one user's normal equations against
        the trained item factors — the factor vector training WOULD have
        produced for a user with these events, without retraining (ALS-WR
        λ·max(n,1) ridge in explicit mode, the Hu-Koren-Volinsky VᵀV +
        confidence form in implicit mode). One R×R host solve.

        ``ratings``: per-item values aligned with ``item_ids``; defaults to
        1.0 each. Unknown item ids are skipped; returns None if none are
        known.
        """
        prep = self._fold_in_prep(item_ids, ratings)
        if prep is None:
            return None
        a, b = self._fold_in_equations(*prep)
        return np.linalg.solve(a, b).astype(np.float32)

    def _fold_in_lookup(self, item_ids) -> tuple[np.ndarray, np.ndarray]:
        """One vectorized id→row pass (``BiMap.map_array``). Returns
        ``(rows, kept)``: ``kept`` is the boolean keep-mask over
        ``item_ids`` and ``rows`` the factor rows of the kept ids."""
        idx = self.item_ids.map_array(list(item_ids), default=-1)
        kept = idx >= 0
        return idx[kept], kept

    def _fold_in_prep(self, item_ids, ratings):
        """(rows, r) of the known items in float64, or None when no item
        is known — the normal-equation inputs of one user's fold-in."""
        rows, kept = self._fold_in_lookup(item_ids)
        if rows.size == 0:
            return None
        if ratings is None:
            r = np.ones(rows.size, np.float64)
        else:
            r = np.asarray([float(x) for x in ratings], np.float64)[kept]
        return rows, r

    def _vtv(self) -> np.ndarray:
        """The implicit-mode VᵀV term, cached (depends only on the item
        factors)."""
        vtv = getattr(self, "_vtv_cache", None)
        if vtv is None:
            v_all = self.item_factors.astype(np.float64)
            vtv = v_all.T @ v_all
            self._vtv_cache = vtv
        return vtv

    def _fold_in_equations(self, rows: np.ndarray, r: np.ndarray):
        """One user's regularized normal equations (a, b) in float64."""
        v_s = self.item_factors[rows].astype(np.float64)  # [k, R]
        lam = self.config.lambda_
        rank = v_s.shape[1]
        eye = np.eye(rank)
        if self.config.implicit_prefs:
            alpha = self.config.alpha
            a = self._vtv() + (v_s * (alpha * r)[:, None]).T @ v_s + lam * eye
            b = ((1.0 + alpha * r)[:, None] * v_s).sum(axis=0)
        else:
            a = v_s.T @ v_s + lam * max(len(rows), 1) * eye
            b = (r[:, None] * v_s).sum(axis=0)
        return a, b

    def fold_in_users(self, batch):
        """Batched host fold-in: ``batch = [(item_ids, ratings|None), ...]``.
        Returns ``(factors, kept_users)``: ``kept_users`` is a boolean [B]
        mask of users with at least one known item; ``factors`` is
        ``[kept_users.sum(), R]`` float32. Per-user float64 normal
        equations stacked into ONE batched LAPACK solve — bitwise identical
        to B independent ``fold_in_user`` calls."""
        prep: list = []
        kept_users = np.zeros(len(batch), bool)
        for u, (iids, ratings) in enumerate(batch):
            p = self._fold_in_prep(iids, ratings)
            if p is None:
                continue
            kept_users[u] = True
            prep.append(p)
        rank = self.config.rank
        if not prep:
            return np.zeros((0, rank), np.float32), kept_users
        nb = len(prep)
        a = np.empty((nb, rank, rank), np.float64)
        b = np.empty((nb, rank), np.float64)
        for i, (rows, r) in enumerate(prep):
            a[i], b[i] = self._fold_in_equations(rows, r)
        x = np.linalg.solve(a, b[..., None]).squeeze(-1)
        return x.astype(np.float32), kept_users


def _run_fingerprint(ratings: Ratings, config: ALSConfig) -> int:
    """64-bit fingerprint of (ratings, config) gating checkpoint resume
    (the reference's, unchanged). crc32 runs at memory speed, so hashing
    20M triples is negligible next to one training iteration."""
    import json
    import zlib

    cfg_d = dataclasses.asdict(config)
    # iterations excluded: continuing a crashed or shorter run to a larger
    # iteration target is legitimate resume (the `it <= iterations` check
    # handles checkpoints past the current target)
    cfg_d.pop("iterations", None)
    # model_sharded excluded: it changes array placement, not the math
    cfg_d.pop("model_sharded", None)
    cfg_js = json.dumps(cfg_d, sort_keys=True, default=str)
    parts = (
        zlib.crc32(np.ascontiguousarray(ratings.user_indices).tobytes()),
        zlib.crc32(np.ascontiguousarray(ratings.item_indices).tobytes()),
        zlib.crc32(np.ascontiguousarray(ratings.ratings).tobytes()),
        zlib.crc32(cfg_js.encode()),
    )
    h = 0xCBF29CE484222325
    for p in parts:
        h = ((h ^ p) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


# ---------------------------------------------------------------------------
# the half-step
# ---------------------------------------------------------------------------

def _compute_dtype(name) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _spd_solve(a, b, *, solver="cg", cg_iters=DEFAULT_CG_ITERS,
               matvec_dtype=None, shift=None, gram=None, diag=None,
               x0=None):
    """Batched SPD solve of (a + diag(shift) + gram) x = b, [B, R, R] x [B, R].

    ``a`` arrives UNREGULARIZED (and possibly bf16); the ridge lives in
    ``shift`` ([B] or scalar, the ALS-WR λ·n_u term) and ``gram`` ([R, R],
    the implicit-mode VᵀV term), applied EXACTLY in f32 inside the matvec
    — ap += shift·p (+ p@gram) — so quantizing a to bf16 never touches the
    conditioning-critical ridge. ``diag`` optionally supplies a's f32
    diagonal (the gramian pass emits it).

    "cg": fixed-iteration Jacobi-preconditioned conjugate gradient
    (z = r / diag(A)), an INEXACT inner solver: the next half-step
    corrects what a few iterations leave. ``x0`` warm-starts it (the
    initial residual is b - A·x0). "cholesky" / "lu": exact
    factorizations; ``x0`` is ignored.

    ``matvec_dtype=bfloat16`` rounds A to bf16 once and multiplies in f32
    (f32 residual and search-vector updates). PyTorch ops cannot read bf16
    and multiply in f32 without materializing the f32 copy, so the port
    holds that copy once per solve: the reference's arithmetic, not its
    halved traffic (a fused kernel would give that).
    """
    f32 = torch.float32
    rank = a.shape[-1]
    dev = a.device
    if shift is None:
        shift_b = torch.zeros((), dtype=f32, device=dev)
    else:
        shift_b = torch.as_tensor(shift, dtype=f32, device=dev)
        if shift_b.ndim == 1:
            shift_b = shift_b[:, None]  # [B, 1] broadcasting over R

    if solver in ("lu", "cholesky"):
        a_full = a.to(f32)
        eye = torch.eye(rank, dtype=f32, device=dev)
        a_full = a_full + (shift_b[..., None] if shift_b.ndim else shift_b) * eye
        if gram is not None:
            a_full = a_full + gram.to(f32)[None]
        if solver == "lu":
            x, info = torch.linalg.solve_ex(a_full, b[..., None])
        else:
            # Cholesky on a matrix that is not SPD: JAX returns NaN where
            # torch.linalg.cholesky raises. With λ > 0 every system of the
            # layout is SPD (padding rows too: λ·max(n, 1) > 0); at λ = 0 a
            # row without ratings is singular, and ``cholesky_ex`` reports
            # it in ``info`` without a host sync, so such rows come out NaN
            # as in the reference.
            chol, info = torch.linalg.cholesky_ex(a_full)
            x = torch.cholesky_solve(b[..., None], chol)
        return torch.where((info != 0)[:, None], float("nan"), x[..., 0])

    mdt = matvec_dtype if matvec_dtype is not None else a.dtype
    # rounded to the matvec dtype once, held in f32 (see the docstring)
    a_m = a.to(mdt).to(f32)
    gram_f = gram.to(f32) if gram is not None else None
    if diag is None:
        diag = torch.diagonal(a, dim1=-2, dim2=-1).to(f32)
    diag_eff = diag + shift_b
    if gram_f is not None:
        diag_eff = diag_eff + torch.diagonal(gram_f)[None]
    # Jacobi preconditioner (SPD ⇒ diag > 0; the floor only guards
    # all-padding rows whose system is exactly 0·x = 0)
    dinv = 1.0 / torch.clamp_min(diag_eff, 1e-30)

    def matvec(p):
        ap = torch.bmm(a_m, p[:, :, None])[:, :, 0]
        ap = ap + shift_b * p
        if gram_f is not None:
            ap = ap + p @ gram_f  # [B, R] x [R, R]
        return ap

    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0.to(f32)
        r = b - matvec(x)
    z = r * dinv
    rz = (r * z).sum(-1)
    p = z
    for _ in range(cg_iters):
        ap = matvec(p)
        alpha = rz / torch.clamp_min((p * ap).sum(-1), 1e-30)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        z = r * dinv
        rz_new = (r * z).sum(-1)
        p = z + (rz_new / torch.clamp_min(rz, 1e-30))[:, None] * p
        rz = rz_new
    return x


def _gram_blocks(ids, vals, other_c, *, implicit, alpha, rank, masked=False,
                 out_dtype=None, with_diag=False):
    """Partial normal equations for every block row, NO regularization.

    ids/vals: [NB, B, D]; other_c: [NO, R] already in compute dtype.
    Returns (a [NB, B, R, R] out_dtype (default f32), b [NB, B, R] f32,
    n [NB, B] f32[, d [NB, B, R] f32 — a's f32 diagonal, when
    ``with_diag``]). a/b are this block row's *contribution*: a chunked
    heavy row's pieces are summed per owner by the caller. n counts valid
    entries (the ALS-WR λ·n_u term needs the total).

    Validity derives from ``vals != 0``: the layout zeroes padded slots
    and nudges genuine zero ratings to 1e-30. With ``masked=False`` (the
    permuted layout) padded ids point at a guaranteed-zero factor slot, so
    no mask multiply is needed; ``masked=True`` is the standalone-blocks
    path (pad ids point at row 0, a real row, so gathered rows are zeroed).

    One [B, D, R] gather at a time, as the reference's ``lax.map`` bounds
    peak memory: a whole tier is never gathered at once.
    """
    f32 = torch.float32
    cdt = other_c.dtype
    odt = out_dtype or f32
    nb, blk = ids.shape[:2]
    dev = other_c.device
    # Full f32: a bf16 ``other_c`` is upcast before the gather, so every
    # product below multiplies bf16 values in f32, where they are exact —
    # the reference's preferred_element_type=f32 einsums. (Upcasting the
    # [NO, R] table once costs less than upcasting every gathered block.)
    other32 = other_c.to(f32)
    a_out = torch.empty((nb, blk, rank, rank), dtype=odt, device=dev)
    b_out = torch.empty((nb, blk, rank), dtype=f32, device=dev)
    n_out = torch.empty((nb, blk), dtype=f32, device=dev)
    d_out = (torch.empty((nb, blk, rank), dtype=f32, device=dev)
             if with_diag else None)
    for j in range(nb):
        b_ids, b_vals = ids[j], vals[j]
        valid = b_vals != 0  # [B, D] — padded slots are exactly 0
        f = other32.index_select(0, b_ids.reshape(-1)).view(blk, -1, rank)
        if masked:
            f = f * valid.to(f32)[..., None]
        vals_f32 = b_vals.to(f32)
        n_out[j] = valid.sum(1).to(f32)
        if implicit:
            # confidence c = 1 + alpha*r; (c-1) is 0 at padded slots
            # already. The global VᵀV term is added ONCE per owner row by
            # the solver's `gram`, not per chunk. cw keeps the reference's
            # rounding to the compute dtype.
            cw = (alpha * vals_f32).to(cdt).to(f32)
            a = torch.bmm((f * cw[..., None]).transpose(1, 2), f)
            w = ((1.0 + alpha * vals_f32) * valid.to(f32)).to(cdt).to(f32)
            b = torch.bmm(w[:, None, :], f)[:, 0]
        else:
            a = torch.bmm(f.transpose(1, 2), f)
            b = torch.bmm(b_vals.to(cdt).to(f32)[:, None, :], f)[:, 0]
        a_out[j] = a
        b_out[j] = b
        if with_diag:
            d_out[j] = torch.diagonal(a, dim1=-2, dim2=-1)
    out = (a_out, b_out, n_out)
    if with_diag:
        out = out + (d_out,)
    return out


def _segment_sum(x, lengths):
    """Sums of consecutive runs of ``x``'s rows: run i is ``lengths[i]``
    rows long (the chunked tier's ``seg`` is sorted, so each owner's
    chunks are one run). Run-to-run determinism: a segmented reduction
    adds each run in a fixed order, where ``index_add_`` on CUDA would
    add through atomics whose order changes between runs."""
    return torch.segment_reduce(x, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def _ridge(other_c, n, *, lambda_, implicit):
    """(shift, gram) regularization pair for _spd_solve: ALS-WR
    λ·max(n,1) diagonal shift in explicit mode; the Hu-Koren-Volinsky
    VᵀV gramian + plain-λ shift in implicit mode."""
    if implicit:
        o = other_c.to(torch.float32)  # bf16 products are exact in f32
        return lambda_, o.T @ o  # VᵀV
    return lambda_ * torch.clamp_min(n, 1.0), None


def _half_step(ids, vals, other, *, lambda_, implicit, alpha, rank,
               compute_dtype="float32", solver="cg", cg_iters=None):
    """Solve all rows of one (un-chunked) block layout given the other
    side's factors — the self-contained single-shot path.
    ids/vals: [NB, B, D] tensors; other: [NO, R]. Returns [NB, B, R]
    float32. The training path goes through ``_solve_side`` instead."""
    cdt = _compute_dtype(compute_dtype)
    other_c = other.to(cdt)
    cg_iters = _resolve_cg_iters(cg_iters, implicit)
    with torch.no_grad():
        a, b, n = _gram_blocks(ids, vals, other_c, implicit=implicit,
                               alpha=alpha, rank=rank, masked=True)
        nb, blk = ids.shape[:2]
        shift, gram = _ridge(other_c, n.reshape(-1), lambda_=lambda_,
                             implicit=implicit)
        x = _spd_solve(a.reshape(nb * blk, rank, rank),
                       b.reshape(nb * blk, rank), solver=solver,
                       cg_iters=cg_iters, matvec_dtype=cdt, shift=shift,
                       gram=gram)
    return x.reshape(nb, blk, rank)


def put_layout(layout, device=None, *, vals_dtype=None):
    """Move one side of the permuted layout to ``device`` (None means
    CUDA), once: per tier ``ids`` int32 (``index_select`` takes it) and
    ``vals`` f32, or bf16 with ``vals_dtype="bfloat16"`` (exact for
    half-star ratings; otherwise a rounding the bf16 compute path would
    apply anyway). A chunked tier also carries its ``seg`` (block row →
    owner slot, sorted) in the form the segmented reduction reads:
    ``seg_lengths``, the block rows of each owner slot. No mask: validity
    is encoded in vals, and padded ids point at the other side's zero
    slot. ``layout`` is a ``SideLayout`` (the port's, or any object with
    the same arrays)."""
    dev = resolve_device(device)
    vdt = _compute_dtype(vals_dtype)
    out = []
    for b, m in zip(layout.buckets, layout.metas):
        e = {"ids": torch.from_numpy(
                 np.ascontiguousarray(b.ids, np.int32)).to(dev),
             "vals": torch.from_numpy(
                 np.ascontiguousarray(b.vals, np.float32)).to(dev, vdt)}
        if m.seg is not None:
            e["seg_lengths"] = torch.from_numpy(np.bincount(
                np.asarray(m.seg, np.int64), minlength=m.span)).to(dev)
        out.append(e)
    return out


def _solve_side(buckets, layout, other, *, kw, x0=None):
    """One side's full half-step over the permuted layout.

    Per tier, ``_gram_blocks`` computes each block row's partial normal
    equations and the chunked tier sums its pieces per owner; then the
    tiers' equations CONCATENATE and one batched solve covers the whole
    side (piece-wise past ``SOLVE_EQ_BUDGET_BYTES``), emitting factors
    already in permuted order. Degree-0 rows and padding slots are the
    all-zero tail the layout reserves.

    ``buckets`` are the device dicts from ``put_layout``; ``layout`` the
    host ``SideLayout`` (spans and segments). ``x0`` is this side's
    PREVIOUS permuted factor array ([slots, R]) warm-starting CG: its
    first ``covered`` rows line up with the concatenated equations.

    Above the budget, regular tiers split into block groups of at most
    ``rows_budget`` rows, each solved on its own, so peak memory is
    bounded by the budget; chunked tiers stay whole (their owner span is
    small by construction). CG is row-independent, so the split is the
    same math. At ML-20M rank 64 f32 the user side's equations take
    2.27 GB, above the budget: that side runs this piece-wise path."""
    rank, implicit = kw["rank"], kw["implicit"]
    # the bf16 gramian quantization only serves CG; the exact
    # factorizations are chosen for precision, so they always get f32
    # equations
    cdt = (torch.bfloat16 if kw.get("compute_dtype") == "bfloat16"
           and kw.get("solver") == "cg" else torch.float32)
    other_c = other.to(cdt)
    f32 = torch.float32

    def tier_equations(b, m):
        """One tier's regularization-free normal equations
        (pa [span, R, R] cdt, pb [span, R] f32, pn [span] f32,
        pd [span, R] f32)."""
        if m.seg is not None:
            # partial gramians stay f32 through the per-owner sums so the
            # chunk accumulation doesn't round at bf16
            pa, pb, pn = _gram_blocks(b["ids"], b["vals"], other_c,
                                      implicit=implicit, alpha=kw["alpha"],
                                      rank=rank)
            lengths = b["seg_lengths"]
            pa = _segment_sum(pa.reshape(-1, rank, rank), lengths)
            pb = _segment_sum(pb.reshape(-1, rank), lengths)
            pn = _segment_sum(pn.reshape(-1), lengths)
            pd = torch.diagonal(pa, dim1=-2, dim2=-1).to(f32)
            pa = pa.to(cdt)
        else:
            pa, pb, pn, pd = _gram_blocks(b["ids"], b["vals"], other_c,
                                          implicit=implicit, alpha=kw["alpha"],
                                          rank=rank, out_dtype=cdt,
                                          with_diag=True)
            pa = pa.reshape(-1, rank, rank)
            pb = pb.reshape(-1, rank)
            pn = pn.reshape(-1)
            pd = pd.reshape(-1, rank)
        return pa, pb, pn, pd

    def tier_solve(pa, pb, pn, pd, x0_t):
        shift, gram = _ridge(other_c, pn, lambda_=kw["lambda_"],
                             implicit=implicit)
        return _spd_solve(pa, pb, solver=kw["solver"],
                          cg_iters=kw["cg_iters"], matvec_dtype=cdt,
                          shift=shift, gram=gram, diag=pd, x0=x0_t)

    covered = sum(m.span for m in layout.metas)
    eq_bytes = covered * rank * rank * cdt.itemsize
    cat = lambda xs: torch.cat(xs) if len(xs) > 1 else xs[0]  # noqa: E731
    if eq_bytes <= SOLVE_EQ_BUDGET_BYTES:
        # one global batched solve over the concatenated equations
        eqs = [tier_equations(b, m) for b, m in zip(buckets, layout.metas)]
        a, bvec, n, d = (cat([e[i] for e in eqs]) for i in range(4))
        del eqs  # free the per-tier pieces before the solve
        x = tier_solve(a, bvec, n, d, None if x0 is None else x0[:covered])
    else:
        rows_budget = max(1, SOLVE_EQ_BUDGET_BYTES
                          // (rank * rank * cdt.itemsize))
        xs = []
        off = 0
        for b, m in zip(buckets, layout.metas):
            if m.seg is not None:
                pa, pb, pn, pd = tier_equations(b, m)
                xs.append(tier_solve(
                    pa, pb, pn, pd,
                    None if x0 is None else x0[off:off + m.span]))
                off += m.span
                continue
            nb, blk = b["ids"].shape[:2]
            g = max(1, rows_budget // blk)  # blocks per solve group
            for s in range(0, nb, g):
                sub = {"ids": b["ids"][s:s + g], "vals": b["vals"][s:s + g]}
                rows = int(sub["ids"].shape[0]) * blk
                pa, pb, pn, pd = tier_equations(sub, m)
                xs.append(tier_solve(
                    pa, pb, pn, pd,
                    None if x0 is None else x0[off:off + rows]))
                off += rows
        x = cat(xs)
    # The zero slot: padded ids of the other side's blocks point at this
    # side's last slot, so the tail (degree-0 rows, then the zero slot)
    # must be written as exact zeros — anything else there would leak
    # into every padded gather of the next half-step.
    tail = layout.slots - covered
    if tail:
        x = torch.cat([x, torch.zeros((tail, rank), dtype=f32,
                                      device=x.device)])
    return x


def make_train_step(u_layout, i_layout, *, rank, lambda_=0.1,
                    implicit=False, alpha=1.0, compute_dtype: str = "float32",
                    solver: str = "cg", cg_iters: int | None = None):
    """One full ALS iteration (user half-step + item half-step) over the
    permuted two-sided layout, the inner loop of ``train_als``:
    ``step(u_buckets, i_buckets, u_perm, v_perm) -> (u_perm, v_perm)`` in
    permuted slot space ([slots_u, R] / [slots_i, R]); the incoming
    factors seed the CG warm start. On one device the reference's mesh,
    shardings and ``model_sharded`` fall away."""
    warm = solver == "cg"
    kw = dict(lambda_=lambda_, implicit=implicit, alpha=alpha, rank=rank,
              compute_dtype=compute_dtype, solver=solver,
              cg_iters=_resolve_cg_iters(cg_iters, implicit, warm=warm))

    @torch.no_grad()
    def step(u_buckets, i_buckets, u_prev, v):
        u = _solve_side(u_buckets, u_layout, v, kw=kw,
                        x0=u_prev if warm else None)
        v_new = _solve_side(i_buckets, i_layout, u, kw=kw,
                            x0=v if warm else None)
        return u, v_new

    return step


def to_slots(host_arr, layout, device=None) -> torch.Tensor:
    """True-row-order factors ([rows, R], numpy or tensor) -> the permuted
    f32 [slots, R] device array of ``layout``. Slots no row owns stay
    exactly zero: padded ids gather from them."""
    arr = torch.as_tensor(np.asarray(host_arr, np.float32))
    perm = torch.zeros((layout.slots, arr.shape[1]), dtype=torch.float32)
    perm[torch.from_numpy(np.asarray(layout.pos, np.int64))] = arr
    return perm.to(resolve_device(device))


class _ConvergenceSampler:
    """Sampled-holdout convergence probe for the training loop: a fixed
    seeded sample of <=512 rating triples, scored against the live factor
    matrices each iteration — sampled RMSE plus the relative user-factor
    delta norm, streamed into ``TRAINING``. Factors live in PERMUTED slot
    order during training, so true rows map through ``SideLayout.pos``
    once at construction; the per-iteration cost is one [S, R] gather per
    side. Pure telemetry: any failure disables the probe, never the run."""

    SAMPLE = 512

    def __init__(self, ratings: Ratings, config: ALSConfig, u_lay, i_lay):
        self.ok = False
        self._prev = None
        try:
            n = int(len(ratings.ratings))
            take = min(self.SAMPLE, n)
            if take == 0:
                return
            rng = np.random.default_rng((config.seed or 0) ^ 0x5EED)
            sel = rng.choice(n, size=take, replace=False)
            self.u_slots = np.asarray(u_lay.pos)[
                np.asarray(ratings.user_indices)[sel]]
            self.i_slots = np.asarray(i_lay.pos)[
                np.asarray(ratings.item_indices)[sel]]
            self.r = np.asarray(ratings.ratings)[sel].astype(np.float32)
            self.ok = True
        except Exception:
            self.ok = False

    @staticmethod
    def _rows(x: torch.Tensor, slots: np.ndarray) -> np.ndarray:
        idx = torch.from_numpy(slots.astype(np.int64)).to(x.device)
        return x.index_select(0, idx).cpu().numpy()

    def observe(self, it: int, u, v, step_seconds: float) -> None:
        loss = delta = None
        if self.ok:
            try:
                uu = self._rows(u, self.u_slots)
                vv = self._rows(v, self.i_slots)
                pred = (uu * vv).sum(axis=1)
                loss = float(np.sqrt(np.mean((pred - self.r) ** 2)))
                if self._prev is not None:
                    delta = float(
                        np.linalg.norm(uu - self._prev)
                        / (np.linalg.norm(self._prev) + 1e-12))
                self._prev = uu
            except Exception:
                loss = delta = None
        TRAINING.observe("train", it, loss=loss, delta_norm=delta,
                         step_seconds=step_seconds)


def train_als(ratings: Ratings, config: ALSConfig, *, device=None,
              checkpointer=None, checkpoint_every: int = 0,
              init=None) -> ALSModel:
    """Alternate user/item half-steps for ``config.iterations`` rounds on
    ``device`` (None means CUDA; ``"cpu"`` runs the same tensor ops on
    the host).

    ``init=(u0, v0)`` gives the starting factors as true-row-order arrays
    ([num_users, R], [num_items, R]); the first half-step solves u from
    v0, and u0 only seeds its CG warm start. Without ``init`` both are
    drawn as the reference draws them: ``k_u, k_v = split(PRNGKey(seed))``
    and ``|normal(k, (rows, rank))| / sqrt(rank)`` in true row order,
    through ``predictionio_tpu_torch.prng`` (jax's numbers, bit for bit).

    With a ``TrainCheckpointer`` and ``checkpoint_every > 0``, both factor
    matrices (true row order), the iteration counter and a fingerprint of
    (ratings, config) snapshot every k iterations and at the end; a rerun
    with the same checkpoint directory resumes from the newest step of
    the same run, and clears steps of a changed run. The reference's
    chaos site ``FAULTS.fire("train.step")`` waits for the port's copy of
    ``workflow/faults.py``."""
    dev = resolve_device(device)
    nu, ni = ratings.num_users, ratings.num_items
    if nu == 0 or ni == 0:
        raise ValueError("empty ratings: no users or items")
    rank = config.rank
    if config.model_sharded:
        log.warning("model_sharded requested but the port trains on one "
                    "device; training with replicated factors")

    u_lay, i_lay = build_bilinear_layout(
        ratings.user_indices, ratings.item_indices, ratings.ratings, nu, ni,
        tiers=config.tiers, gather_budget=config.gather_budget,
        seed=config.seed, chunk_cap=config.chunk_cap, align=8,
    )
    dropped = u_lay.dropped + i_lay.dropped
    if dropped:
        log.info("degree tiers dropped %d entries beyond the last tier", dropped)
    # factor matrices live in PERMUTED slot order during training
    # (tier-concatenation order, SideLayout.pos maps true rows to slots);
    # everything host-facing (checkpoints, the final model) is unpermuted
    # via pos
    vals_dtype = "bfloat16" if config.compute_dtype == "bfloat16" else None
    u_bk = put_layout(u_lay, dev, vals_dtype=vals_dtype)
    i_bk = put_layout(i_lay, dev, vals_dtype=vals_dtype)

    # run fingerprint: a checkpoint is only resumable for the exact same
    # ratings + config — resuming across changed data or hyperparameters
    # would silently return a model of the wrong run
    fp = _run_fingerprint(ratings, config)

    def _same_run(state) -> bool:
        v_arr, u_arr = state.get("v"), state.get("u")
        return (state.get("fp") is not None and int(state["fp"]) == fp
                and v_arr is not None and u_arr is not None
                and v_arr.shape == (ni, rank) and u_arr.shape == (nu, rank))

    saw_same_run = False

    def _resumable(state) -> bool:
        nonlocal saw_same_run
        if not _same_run(state):
            return False
        saw_same_run = True
        return int(state["it"]) <= config.iterations

    start_it = 0
    v = None
    u_restored = None
    if checkpointer is not None:
        restored = checkpointer.restore_first_valid(_resumable)
        if restored is not None:
            ck_step, state = restored
            start_it = int(state["it"])
            # checkpoints hold true-row-order arrays; re-permute into this
            # run's slot order
            v = to_slots(state["v"], i_lay, dev)
            u_restored = to_slots(state["u"], u_lay, dev)
            log.info("resuming ALS from checkpoint step %d (iter %d)",
                     ck_step, start_it)
        elif checkpointer.steps():
            if saw_same_run:
                # same data+config, just trained past the current target:
                # those checkpoints stay valid for a later higher-target
                # run — keep them
                log.warning(
                    "checkpoint steps exist beyond the current iteration "
                    "target (%d); keeping them and training fresh",
                    config.iterations)
            else:
                # genuinely stale (data/config changed); purge or retention
                # would prefer them over this run's fresh saves
                log.warning("no resumable checkpoint (data/config changed); "
                            "clearing %d stale step(s) and starting fresh",
                            len(checkpointer.steps()))
                checkpointer.clear()
    if v is None:
        if init is not None:
            u0, v0 = init
            if np.shape(u0) != (nu, rank) or np.shape(v0) != (ni, rank):
                raise ValueError(
                    f"init must be ([{nu}, {rank}], [{ni}, {rank}]); got "
                    f"{np.shape(u0)} and {np.shape(v0)}")
        else:
            # MLlib-style init: small positive factors (true rows only —
            # the layout's padding slots must stay exactly zero)
            k_u, k_v = prng.split(prng.PRNGKey(config.seed))
            v0 = np.abs(prng.normal(k_v, (ni, rank))) / np.sqrt(rank)
            u0 = np.abs(prng.normal(k_u, (nu, rank))) / np.sqrt(rank)
        v = to_slots(v0, i_lay, dev)
        # the user side's init only seeds the first sweep's CG warm start
        # (the first half-step solves u from v). Kept apart from
        # u_restored: a seed is not a trained factor, and the
        # iterations==0 path below must not return it.
        u_seed = to_slots(u0, u_lay, dev)
    else:
        u_seed = None

    # the warm-start depth presumes alternation corrects the shallower
    # inner solves — true from 3 iterations up; for 1-2 iteration runs the
    # first sweep's "warm" seed is still the random init and nothing
    # corrects after it, so those keep the cold depth
    cg_iters = config.cg_iters
    if (cg_iters is None and config.solver == "cg"
            and not config.implicit_prefs and config.iterations < 3):
        cg_iters = DEFAULT_CG_ITERS
    step = make_train_step(
        u_lay, i_lay, rank=rank, lambda_=config.lambda_,
        implicit=config.implicit_prefs, alpha=config.alpha,
        compute_dtype=config.compute_dtype, solver=config.solver,
        cg_iters=cg_iters,
    )
    u = None
    carry_u = u_restored if u_restored is not None else u_seed
    conv = _ConvergenceSampler(ratings, config, u_lay, i_lay)
    TRAINING.begin("train", total_iterations=config.iterations)
    for it in range(start_it, config.iterations):
        t_step = time.perf_counter()
        u, v = step(u_bk, i_bk, carry_u, v)
        step_s = time.perf_counter() - t_step
        _M_TRAIN_STEP.record(step_s)
        conv.observe(it, u, v, step_s)
        carry_u = u
        done = it + 1
        if (checkpointer is not None and checkpoint_every > 0
                and (done % checkpoint_every == 0 or done == config.iterations)):
            # both sides: the final model pairs u_k (solved from v_{k-1})
            # with v_k, so v alone cannot reconstruct it exactly
            checkpointer.save(done, {"u": u.cpu().numpy()[u_lay.pos],
                                     "v": v.cpu().numpy()[i_lay.pos],
                                     "it": np.int64(done),
                                     "fp": np.uint64(fp)})
    if u is None:
        # no iteration ran: a checkpoint already at the final iteration,
        # or iterations == 0 (one cold half-step from the init's v)
        if u_restored is not None:
            u = u_restored
        else:
            with torch.no_grad():
                u = _solve_side(u_bk, u_lay, v, kw=dict(
                    lambda_=config.lambda_, implicit=config.implicit_prefs,
                    alpha=config.alpha, rank=rank,
                    compute_dtype=config.compute_dtype, solver=config.solver,
                    cg_iters=_resolve_cg_iters(config.cg_iters,
                                               config.implicit_prefs)))
    log.info("ALS done: %d iters, U %s, V %s", config.iterations,
             (nu, rank), (ni, rank))
    return ALSModel(
        user_factors=u.cpu().numpy()[u_lay.pos],
        item_factors=v.cpu().numpy()[i_lay.pos],
        user_ids=ratings.user_ids,
        item_ids=ratings.item_ids,
        config=config,
    )
