"""Host-side layout: COO ratings -> fixed-shape padded neighbor blocks.

Copied from ``predictionio_tpu/ops/neighbors.py``. The entry sorts and
the block fill run on the port's copy of the native host library
(``predictionio_tpu_torch/native``) where it builds, and on numpy
otherwise; the two paths are bit-identical, and the layout equals the
reference's array for array.

The ALS solver needs, for every user (resp. item), the list of rated
items (resp. rating users) as FIXED-SHAPE arrays, so every block is one
batched gather and one batched product. This module builds that layout:

  ``NeighborBlocks``: ids [NB, B, D], vals [NB, B, D], mask [NB, B, D]

where B is the per-block row count and D the padded max degree. This is the role MLlib ALS's
``InLinkBlock/OutLinkBlock`` shuffle layout plays in the reference's
training path (examples/.../ALSAlgorithm.scala -> org.apache.spark.mllib.
recommendation.ALS), re-thought for static shapes instead of shuffles:
layout is computed once on host with numpy sorts, then stays resident.

``build_bilinear_layout`` is the production entry: BOTH sides (user rows
gathering item factors and vice versa) built together in a PERMUTED
"slot" order, so that per-tier solved factors concatenate straight into
the factor arrays and the training step needs no scatter (the reference
chose this on its TPU, where a scatter runs far slower than a gather; the
port keeps the layout so both packages train on the same arrays).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .. import native


__all__ = [
    "NeighborBlocks", "SideLayout", "TierMeta", "build_bilinear_layout",
    "build_neighbor_blocks", "geometric_tiers", "optimal_tiers",
]

_splitmix64 = native.splitmix64_np


@dataclasses.dataclass
class NeighborBlocks:
    """Padded per-row neighbor lists, reshaped into blocks.

    Validity is encoded in ``vals``: padded slots are exactly 0; genuine
    zero values are nudged to 1e-30 at build time, so consumers derive
    the mask as ``vals != 0`` instead of carrying a third array (a third
    of the layout's memory and transfer at 20M-rating scale). ``mask`` is
    computed lazily for the few callers (tests) that want it explicitly.
    """

    ids: np.ndarray  # int32 [NB, B, D] neighbor indices (0 where padded)
    vals: np.ndarray  # float32 [NB, B, D] ratings/confidences (0 where padded)
    num_rows: int  # true number of rows (before padding to NB*B)
    max_degree: int  # D after capping
    dropped: int  # entries dropped by the degree cap

    @property
    def mask(self) -> np.ndarray:  # float32 [NB, B, D] 1.0 = real entry
        return (self.vals != 0).astype(np.float32)

    @property
    def padded_rows(self) -> int:
        return self.ids.shape[0] * self.ids.shape[1]


@dataclasses.dataclass
class TierMeta:
    """Static facts the solver needs about one tier bucket."""

    span: int  # rows this tier contributes to the permuted factor array
    #: None for regular tiers (block row j IS slot offset+j). For a
    #: chunked tier: int32 [NB*B] mapping each block row (a chunk of a
    #: heavy row) to its owner's local slot 0..span-1, SORTED ascending —
    #: the solver segment-sums partial normal equations over it. Block
    #: padding rows map to the last local slot (their contribution is
    #: exactly zero, and a trailing index keeps the sequence sorted).
    seg: np.ndarray | None = None


@dataclasses.dataclass
class SideLayout:
    """One side of the permuted two-sided layout (see
    ``build_bilinear_layout``). The permuted factor array has ``slots``
    rows: tier spans back to back, then degree-0 rows, then ≥1 always-
    zero slot (``zero_slot`` = slots-1). ``pos[r]`` is true row r's slot.
    Block ``ids`` reference the OTHER side's slots; padded entries point
    at the other side's ``zero_slot``, so gathers return exact zeros and
    the solver needs no [B, D, R]-shaped validity mask."""

    buckets: list[NeighborBlocks]
    metas: list[TierMeta]
    slots: int
    pos: np.ndarray  # int32 [num_rows] true row -> slot
    zero_slot: int

    @property
    def dropped(self) -> int:
        return sum(b.dropped for b in self.buckets)


def geometric_tiers(max_degree: int, *, base: int = 16,
                    ratio: float = 1.25) -> tuple[int, ...]:
    """Degree-tier edges in (rough) geometric progression, each a multiple
    of 8, ending exactly at ``max_degree`` rounded up to 8.

    Padding waste per row is bounded by the ratio between consecutive
    tiers (worst case a row's degree is one past the previous edge).
    Padded entries cost real gather bandwidth (the reference measured
    the gather as its training step's floor), so the ratio is set fine
    (~14% average padding); tiers are cheap — every tier's normal
    equations concatenate into ONE batched solve (models/als._solve_side)
    and small tiers merge upward anyway (``merge_budget``).
    """
    top = max(8, ((max_degree + 7) // 8) * 8)
    edges: list[int] = []
    d = float(base)
    while d < top:
        e = int(((int(d) + 7) // 8) * 8)
        if not edges or e > edges[-1]:
            edges.append(e)
        d *= ratio
    if not edges or edges[-1] < top:
        edges.append(top)
    else:
        edges[-1] = top
    return tuple(edges)


def optimal_tiers(degrees: np.ndarray, *, tier_cost: int) -> tuple[int, ...]:
    """Degree-histogram-OPTIMAL tier edges: minimize
    Σ (rows in tier) x (tier edge)  +  tier_cost x (number of tiers)
    by dynamic programming over the distinct 8-rounded degrees present.
    Geometric edges bound worst-case padding by the ratio but ignore the
    actual distribution; on ML-20M's Poisson-bulk user degrees the DP
    places edges through the bulk and cuts padded gather rows ~2x for the
    same tier count. ``tier_cost`` is the padded-element equivalent of
    one extra tier dispatch (the merge_budget calibration)."""
    d8 = ((np.asarray(degrees, np.int64) + 7) // 8) * 8
    vals, rows = np.unique(d8[d8 > 0], return_counts=True)
    if len(vals) == 0:
        return (8,)
    csum = np.concatenate([[0], np.cumsum(rows)])
    n = len(vals)
    best = np.full(n + 1, np.inf)
    best[0] = 0.0
    choice = np.zeros(n + 1, np.int64)
    for i in range(1, n + 1):
        # one tier covering distinct degrees j..i-1, padded to vals[i-1]
        costs = best[:i] + (csum[i] - csum[:i]) * vals[i - 1] + tier_cost
        j = int(np.argmin(costs))
        best[i] = costs[j]
        choice[i] = j
    edges = []
    i = n
    while i > 0:
        edges.append(int(vals[i - 1]))
        i = choice[i]
    return tuple(reversed(edges))


def _assign_tiers(vcounts: np.ndarray, tiers, merge_budget: int,
                  eligible: np.ndarray, dp_cost: int) -> list[tuple[int, np.ndarray]]:
    """Group eligible rows into degree tiers. ``tiers="auto"`` computes
    histogram-optimal edges (``optimal_tiers`` — already cost-aware, no
    further merging); an explicit tuple is honored with small tiers
    merged upward when all their rows padded at the NEXT tier's width
    stay within ``merge_budget`` elements."""
    vmax = int(vcounts[eligible].max()) if eligible.any() else 0
    if tiers == "auto":
        tiers = optimal_tiers(vcounts[eligible], tier_cost=dp_cost)
        merge_budget = 0  # the DP already priced tier count
    elif vmax > tiers[-1]:
        # extend rather than drop: one extra tier holding the heaviest rows
        tiers = tuple(tiers) + (((vmax + 7) // 8) * 8,)
    out: list[tuple[int, np.ndarray]] = []
    pending: list[np.ndarray] = []
    pending_n = 0
    prev = 0
    for t_idx, tier_d in enumerate(tiers):
        last = t_idx == len(tiers) - 1
        sel = eligible & (vcounts > prev) & ((vcounts <= tier_d) | last)
        prev = tier_d
        row_idx = np.nonzero(sel)[0]
        cand_n = pending_n + len(row_idx)
        if cand_n == 0:
            continue
        if not last and cand_n * tiers[t_idx + 1] <= merge_budget:
            pending.append(row_idx)
            pending_n = cand_n
            continue
        if pending:
            row_idx = np.concatenate(pending + [row_idx])
            pending, pending_n = [], 0
        out.append((tier_d, row_idx))
    return out


@dataclasses.dataclass
class _ChunkClass:
    """Heavy rows whose balanced chunks share one padded width."""

    width: int
    owners: np.ndarray  # ascending row ids
    k: np.ndarray  # chunks per owner
    span: int


@dataclasses.dataclass
class _SidePlan:
    """One side's slot plan: where every row's factor lives in permuted
    order, before any blocks are built (both sides' plans must exist
    before either side's blocks, because ids hold the OTHER side's
    slots)."""

    tiers: list[tuple[int, np.ndarray]]  # (tier_d, original row ids)
    tier_block_rows: list[int]
    chunks: list[_ChunkClass]
    slots: int
    pos: np.ndarray  # int32 [num_rows]
    zero_slot: int


def _plan_side(counts: np.ndarray, *, tiers, gather_budget: int,
               chunk_cap: int | None, merge_budget, nnz: int,
               align: int = 8) -> _SidePlan:
    num_rows = len(counts)
    align = 8 * max(1, align) // math.gcd(8, max(1, align))  # lcm(8, align)
    if merge_budget == "auto":
        # the reference's balance point between one extra tier's
        # dispatch and the gather+gramian cost of padded entries, as
        # measured on its TPU (kept so the layouts agree)
        merge_budget = max(8192, nnz // 48)
    # the DP prices a tier at the reference's marginal per-tier launch
    # cost, much cheaper than the merge heuristic's bound (kept so the
    # layouts agree)
    dp_cost = max(8192, nnz // 160)
    cap = 0
    heavy = np.zeros(num_rows, bool)
    if chunk_cap is not None:
        cap = max(8, (int(chunk_cap) // 8) * 8)
        heavy = counts > cap
    light = (counts > 0) & ~heavy
    tier_list = _assign_tiers(counts, tiers, merge_budget, light, dp_cost)

    pos = np.full(num_rows, -1, np.int64)
    off = 0
    tier_block_rows = []
    for tier_d, row_idx in tier_list:
        br = _block_rows_for(tier_d, gather_budget, len(row_idx))
        span = max(1, math.ceil(len(row_idx) / br)) * br
        pos[row_idx] = off + np.arange(len(row_idx))
        tier_block_rows.append(br)
        off += span

    chunks: list[_ChunkClass] = []
    if heavy.any():
        heavy_rows = np.nonzero(heavy)[0]  # ascending
        k = -(-counts[heavy_rows] // cap)  # balanced chunk counts
        # balanced chunks of a degree-d row are ceil(d/k) wide, i.e. in
        # (cap/2, cap]; group heavy rows into histogram-optimal width
        # classes so a near-half-full chunk doesn't pad all the way to
        # cap. Each row contributes k chunks, so the DP weights widths
        # by repetition (padding cost = k x class edge per row).
        width = ((-(-counts[heavy_rows] // k) + 7) // 8) * 8
        edges = optimal_tiers(np.repeat(width, k), tier_cost=dp_cost)
        cls = np.searchsorted(np.asarray(edges), width, side="left")
        for c in np.unique(cls):
            sel = cls == c
            owners = heavy_rows[sel]
            span = ((len(owners) + 7) // 8) * 8
            pos[owners] = off + np.arange(len(owners))
            chunks.append(_ChunkClass(width=int(edges[c]), owners=owners,
                                      k=k[sel], span=span))
            off += span

    deg0 = np.nonzero(counts == 0)[0]
    pos[deg0] = off + np.arange(len(deg0))
    off += len(deg0)
    # ≥1 guaranteed-zero slot, rounded so factor rows shard evenly over a
    # model axis of size `align` (tensor-parallel NamedSharding requires
    # dim 0 divisible by the axis size)
    slots = -(-(off + 1) // align) * align
    return _SidePlan(
        tiers=tier_list, tier_block_rows=tier_block_rows, chunks=chunks,
        slots=slots, pos=pos.astype(np.int32), zero_slot=slots - 1,
    )


def _stable_argsort_bounded(keys: np.ndarray, key_max: int) -> np.ndarray:
    """np.argsort(kind="stable") for non-negative bounded int keys, via
    the native parallel counting sort when available (bit-identical —
    test_torch_native pins it). The entry-stream sorts are the layout
    build's dominant host cost at 100M-rating scale."""
    out = native.counting_argsort(keys, key_max)
    if out is not None:
        return out
    return np.argsort(keys, kind="stable")


def _build_side(plan: _SidePlan, rows, cols_slots, vals, *, zero_other: int,
                gather_budget: int, seed: int) -> SideLayout:
    """Build one side's blocks from its plan. ``cols_slots`` is the
    neighbor column array ALREADY remapped to the other side's slots.

    One radix sort groups the entry stream by tier, then every tier works
    on a contiguous slice — the naive per-tier full-stream mask costs
    O(nnz · tiers) (measured 8s at ML-20M scale against this path's ~2s).
    """
    num_rows = len(plan.pos)
    rows = np.asarray(rows)
    if rows.dtype.itemsize > 4:
        rows = rows.astype(np.int32)  # numpy radix-sorts small ints
    vals = np.asarray(vals)
    buckets: list[NeighborBlocks] = []
    metas: list[TierMeta] = []

    # tier code per entry: 1..T = regular tier, 0 = chunked classes
    # (int32 so the native counting sort takes it without a 100M-entry
    # cast copy)
    n_tiers = len(plan.tiers)
    tier_of_row = np.zeros(num_rows, np.int32)
    for t, (_tier_d, row_idx) in enumerate(plan.tiers):
        tier_of_row[row_idx] = t + 1
    tcode = tier_of_row[rows]
    order_t = _stable_argsort_bounded(tcode, n_tiers + 1)
    # tier boundaries from the histogram — searchsorted with sorter=
    # walks the permutation indirection and measured ~6 s at 100M entries
    bounds = np.zeros(n_tiers + 2, np.int64)
    np.cumsum(np.bincount(tcode, minlength=n_tiers + 1), out=bounds[1:])

    remap = np.empty(num_rows, np.int64)
    for t, ((tier_d, row_idx), br) in enumerate(
            zip(plan.tiers, plan.tier_block_rows)):
        sl = order_t[bounds[t + 1]:bounds[t + 2]]
        remap[row_idx] = np.arange(len(row_idx))
        b = build_neighbor_blocks(
            remap[rows[sl]], cols_slots[sl], vals[sl],
            len(row_idx), block_rows=br, degree_cap=tier_d,
            pad_id=zero_other, seed=seed,
        )
        buckets.append(b)
        metas.append(TierMeta(span=b.padded_rows))

    if plan.chunks:
        hv = order_t[bounds[0]:bounds[1]]  # all chunked-class entries
        rows_h, cols_h, vals_h = rows[hv], cols_slots[hv], vals[hv]
        counts = np.bincount(rows_h, minlength=num_rows)
        order = _stable_argsort_bounded(rows_h, num_rows - 1)
        starts = np.zeros(num_rows + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        rs = rows_h[order]
        pos_in = np.arange(len(rows_h), dtype=np.int64) - starts[rs]
        cols_o, vals_o = cols_h[order], vals_h[order]
        k_full = np.zeros(num_rows, np.int64)
        hv_base = np.full(num_rows, -1, np.int64)
        for cc in plan.chunks:
            k_full[cc.owners] = cc.k
            hv_base[cc.owners] = np.concatenate([[0], np.cumsum(cc.k[:-1])])
            sel = hv_base[rs] >= 0
            # balanced chunk of each entry: position p of d entries split
            # into k chunks lands in chunk p*k//d (sizes differ by at most
            # 1, so every chunk fits this width class)
            vrow = (hv_base[rs[sel]]
                    + (pos_in[sel] * k_full[rs[sel]]) // counts[rs[sel]])
            n_hv = int(cc.k.sum())
            br = _block_rows_for(cc.width, gather_budget, n_hv)
            b = build_neighbor_blocks(
                vrow, cols_o[sel], vals_o[sel], n_hv, block_rows=br,
                degree_cap=cc.width, pad_id=zero_other, seed=seed,
            )
            # seg: block row (chunk) -> owner's local slot, sorted
            # ascending; block padding rows map to the LAST local slot
            # (their partial equations are exactly zero, and a trailing
            # index keeps the sequence sorted for segment_sum's fast path)
            seg = np.full(b.padded_rows, cc.span - 1, np.int32)
            seg[:n_hv] = np.repeat(
                np.arange(len(cc.owners), dtype=np.int32), cc.k)
            buckets.append(b)
            metas.append(TierMeta(span=cc.span, seg=seg))
            k_full[cc.owners] = 0
            hv_base[cc.owners] = -1

    return SideLayout(buckets=buckets, metas=metas, slots=plan.slots,
                      pos=plan.pos, zero_slot=plan.zero_slot)


def build_bilinear_layout(
    u_idx: np.ndarray,
    i_idx: np.ndarray,
    vals: np.ndarray,
    num_users: int,
    num_items: int,
    *,
    tiers: tuple[int, ...] | str = "auto",
    gather_budget: int = 2_000_000,
    seed: int = 0,
    chunk_cap: int | None = 2048,
    merge_budget: int | str = "auto",
    align: int = 8,
) -> tuple[SideLayout, SideLayout]:
    """Both sides of the ALS layout, ALX-style density-grouped and
    PERMUTED so the training step needs zero scatters:

    - rows are grouped by degree tier (``tiers="auto"`` computes
      histogram-OPTIMAL edges via ``optimal_tiers`` — zero entries
      dropped, total padding + per-tier dispatch cost minimized by DP
      over the observed degree distribution; explicit tuples auto-extend
      past their last edge and merge small tiers within ``merge_budget``,
      lossless either way), block row counts sized so one block's
      gathered factors stay within ``gather_budget`` elements;
    - rows heavier than ``chunk_cap`` split into balanced chunks riding a
      dedicated cap-wide tier, their partial normal equations segment-
      summed per owner (kills the one-block-per-80k-degree-row tail);
    - factor arrays live in tier-concatenation order during training
      (``SideLayout.pos`` maps true rows to slots), padded slots point at
      the other side's guaranteed-zero slot; ``align`` rounds each side's
      slot count so factor rows shard evenly over a model axis of that
      size (pass the mesh's model-axis size for tensor-parallel factors).

    Replaces the factor-block shuffle MLlib ALS performs every iteration
    (reference examples/.../ALSAlgorithm.scala:96-154): layout is computed
    once on host, then stays device-resident for every iteration.
    """
    u_idx = np.asarray(u_idx, np.int64)
    i_idx = np.asarray(i_idx, np.int64)
    nnz = len(u_idx)
    counts_u = np.bincount(u_idx, minlength=num_users) if nnz else np.zeros(num_users, np.int64)
    counts_i = np.bincount(i_idx, minlength=num_items) if nnz else np.zeros(num_items, np.int64)
    kw = dict(tiers=tiers, gather_budget=gather_budget, chunk_cap=chunk_cap,
              merge_budget=merge_budget, nnz=nnz, align=align)
    plan_u = _plan_side(counts_u, **kw)
    plan_i = _plan_side(counts_i, **kw)
    lay_u = _build_side(plan_u, u_idx, plan_i.pos[i_idx], vals,
                        zero_other=plan_i.zero_slot,
                        gather_budget=gather_budget, seed=seed)
    lay_i = _build_side(plan_i, i_idx, plan_u.pos[u_idx], vals,
                        zero_other=plan_u.zero_slot,
                        gather_budget=gather_budget, seed=seed)
    return lay_u, lay_i


def _block_rows_for(tier_d: int, gather_budget: int, n_rows: int) -> int:
    """Per-block row count for a tier: bounded by the gather budget
    (B*D elements of peak gathered factors) and BALANCED across the
    tier's blocks — a tier one row past a block boundary must not pad a
    whole extra block of rows (ceil-divide the rows over the block count
    the budget implies; waste < 8 rows per block)."""
    b_max = min(8192, max(8, gather_budget // max(tier_d, 8)))
    nb = max(1, math.ceil(max(n_rows, 1) / b_max))
    return max(8, ((math.ceil(n_rows / nb) + 7) // 8) * 8) if n_rows else 8


def build_neighbor_blocks(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    num_rows: int,
    *,
    block_rows: int = 4096,
    max_degree: int | None = None,
    degree_cap: int = 1024,
    seed: int = 0,
    pad_id: int = 0,
) -> NeighborBlocks:
    """Group (rows, cols, vals) COO triples by row into padded blocks.

    - D = min(max observed degree, ``degree_cap``) rounded up to a multiple
      of 8.
    - Rows with degree > D keep a deterministic hash-keyed subsample (the
      same trade MLlib users make with sampling heavy users); the key is
      splitmix64(seed, row, pos) so the native C++ path and the numpy
      fallback produce identical layouts.
    - Rows padded to a multiple of ``block_rows``.
    - Padded id slots hold ``pad_id`` (the permuted layout points them at
      the other side's guaranteed-zero factor slot so consumers skip the
      [B, D, R]-wide validity mask; the default 0 keeps the standalone
      mask-deriving path working).

    Dispatches to the C++ counting-sort kernel
    (predictionio_tpu_torch/native) when built; falls back to numpy sorts
    otherwise.
    """
    # Exact-zero values are nudged to a tiny epsilon so that downstream
    # consumers may derive the validity mask as ``vals != 0`` (the padded
    # slots are exactly 0) instead of carrying a separate mask array —
    # that mask is a third of the layout's device traffic at 20M-rating
    # scale. 1e-30 contributes nothing at float32/bfloat16 precision.
    vals = np.asarray(vals, np.float32)
    if len(vals) and (vals == 0).any():
        vals = np.where(vals == 0, np.float32(1e-30), vals)

    if len(rows) == 0:
        d = 8
        nb = max(1, math.ceil(max(num_rows, 1) / block_rows))
        shape = (nb, block_rows, d)
        return NeighborBlocks(
            ids=np.full(shape, pad_id, np.int32),
            vals=np.zeros(shape, np.float32),
            num_rows=num_rows,
            max_degree=d,
            dropped=0,
        )

    rows = np.asarray(rows, np.int64)
    counts = np.bincount(rows, minlength=num_rows)
    observed_max = int(counts.max())
    d = observed_max if max_degree is None else min(max_degree, observed_max)
    d = min(d, degree_cap)
    d = max(8, ((d + 7) // 8) * 8)

    nb = max(1, math.ceil(num_rows / block_rows))
    padded_rows = nb * block_rows

    nat = native.neighbor_blocks_native(
        rows, cols, vals, num_rows, padded_rows, d, seed
    ) if native.available() else None
    if nat is not None:
        ids, vv, _, dropped = nat
        if pad_id:
            # the C++ kernel zero-fills padding; vv==0 identifies exactly
            # those slots (genuine zero ratings were nudged to 1e-30 above)
            ids = np.where(vv == 0, np.int32(pad_id), ids)
        return NeighborBlocks(
            ids=ids.reshape(nb, block_rows, d),
            vals=vv.reshape(nb, block_rows, d),
            num_rows=num_rows,
            max_degree=d,
            dropped=dropped,
        )

    order = np.argsort(rows, kind="stable")
    r_sorted = rows[order]
    c_sorted = cols[order].astype(np.int32)
    v_sorted = vals[order].astype(np.float32)

    # position of each entry within its row
    starts = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos_in_row = np.arange(len(r_sorted)) - starts[r_sorted]

    dropped = 0
    overflow = counts > d
    if overflow.any():
        # deterministic per-row subsample: keep the d smallest
        # splitmix64(seed, row, pos) keys — same scheme as the C++ kernel
        key = _splitmix64(
            _splitmix64(np.uint64(seed) + r_sorted.astype(np.uint64))
            + pos_in_row.astype(np.uint64)
        )
        order2 = np.lexsort((key, r_sorted))
        rank = np.empty(len(r_sorted), dtype=np.int64)
        rank[order2] = np.arange(len(r_sorted)) - starts[r_sorted[order2]]
        keep = rank < d
        dropped = int((~keep).sum())
        r_sorted, c_sorted, v_sorted = r_sorted[keep], c_sorted[keep], v_sorted[keep]
        counts = np.bincount(r_sorted, minlength=num_rows)
        starts = np.zeros(num_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        pos_in_row = np.arange(len(r_sorted)) - starts[r_sorted]

    ids = np.full((padded_rows, d), pad_id, np.int32)
    vv = np.zeros((padded_rows, d), np.float32)
    ids[r_sorted, pos_in_row] = c_sorted
    vv[r_sorted, pos_in_row] = v_sorted

    return NeighborBlocks(
        ids=ids.reshape(nb, block_rows, d),
        vals=vv.reshape(nb, block_rows, d),
        num_rows=num_rows,
        max_degree=d,
        dropped=dropped,
    )
