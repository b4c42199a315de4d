"""The port's ALS layout against the JAX package's, on the CPU.

``predictionio_tpu_torch/ops/neighbors.py`` is a copy of the reference's
with its numpy paths only (a stable argsort for the native counting sort,
the file's own block fill, ``splitmix64`` copied in). The reference holds
its native and numpy paths bit-identical, so the port's layout must equal
the reference's array for array: every bucket's ids and vals, every
tier's span and chunk segments, the slot map, the slot count and the zero
slot. The fixtures: the heavy-user fixture of ``__graft_entry__.py``
(user 0 rates every item, so with a small ``chunk_cap`` it rides a
chunked tier), genuine zero ratings, explicit tiers, ``chunk_cap=None``,
a degree cap that takes the hash subsample, and an empty side.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import predictionio_tpu.ops.neighbors as ref  # noqa: E402
import predictionio_tpu_torch.ops.neighbors as port  # noqa: E402


def graft_coo(nu=64, ni=48, seed=0):
    """``__graft_entry__.py::_tiny_coo``: uniform ratings plus one heavy
    user (user 0 rates all ni items)."""
    rng = np.random.default_rng(seed)
    n = nu * 6
    rows = rng.integers(0, nu, n).astype(np.int32)
    cols = rng.integers(0, ni, n).astype(np.int32)
    rows[:ni] = 0
    cols[:ni] = np.arange(ni, dtype=np.int32)
    vals = (rng.random(n) * 5).astype(np.float32)
    return rows, cols, vals, nu, ni


def zero_coo(seed=1):
    """30% genuine zero ratings (nudged to 1e-30 by the layout)."""
    rng = np.random.default_rng(seed)
    nu, ni, n = 20, 15, 200
    rows = rng.integers(0, nu, n)
    cols = rng.integers(0, ni, n)
    vals = np.where(rng.random(n) < 0.3, 0.0,
                    rng.random(n) * 4 + 1).astype(np.float32)
    return rows, cols, vals, nu, ni


def skewed_coo(seed=2):
    """One user of degree 200 and a zipf-ish item side, with users and
    items that have no ratings at all."""
    rng = np.random.default_rng(seed)
    nu, ni = 57, 41
    rows = np.concatenate([np.zeros(200, np.int64), rng.integers(1, nu - 3, 400)])
    cols = np.minimum((rng.pareto(1.1, len(rows)) * 4).astype(np.int64), ni - 4)
    vals = (np.round(rng.random(len(rows)) * 9 + 1) / 2).astype(np.float32)
    return rows, cols, vals, nu, ni


FIXTURES = {
    "graft_chunked": (graft_coo, dict(chunk_cap=16)),
    "graft_default": (graft_coo, dict()),
    "graft_cap_none": (graft_coo, dict(chunk_cap=None)),
    "graft_tiers": (graft_coo, dict(tiers=(8, 16), chunk_cap=24)),
    "zeros": (zero_coo, dict(chunk_cap=8)),
    "zeros_tiers": (zero_coo, dict(tiers=(8,), chunk_cap=None)),
    "skewed": (skewed_coo, dict(chunk_cap=64, seed=5)),
    "skewed_tiers": (skewed_coo, dict(tiers=(8, 64, 256), chunk_cap=64)),
    "skewed_cap_none": (skewed_coo, dict(chunk_cap=None, gather_budget=512)),
    "skewed_align5": (skewed_coo, dict(align=5, merge_budget=0)),
}


def assert_side_equal(a, b):
    assert a.slots == b.slots and a.zero_slot == b.zero_slot
    np.testing.assert_array_equal(a.pos, b.pos)
    assert a.pos.dtype == b.pos.dtype
    assert len(a.buckets) == len(b.buckets) == len(a.metas) == len(b.metas)
    for x, y in zip(a.buckets, b.buckets):
        assert x.ids.dtype == y.ids.dtype and x.vals.dtype == y.vals.dtype
        np.testing.assert_array_equal(x.ids, y.ids)
        np.testing.assert_array_equal(x.vals, y.vals)
        assert (x.num_rows, x.max_degree, x.dropped) == \
            (y.num_rows, y.max_degree, y.dropped)
    for x, y in zip(a.metas, b.metas):
        assert x.span == y.span
        assert (x.seg is None) == (y.seg is None)
        if x.seg is not None:
            assert x.seg.dtype == y.seg.dtype
            np.testing.assert_array_equal(x.seg, y.seg)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_bilinear_layout_equals_reference(name):
    make, kw = FIXTURES[name]
    rows, cols, vals, nu, ni = make()
    want = ref.build_bilinear_layout(rows, cols, vals, nu, ni, **kw)
    got = port.build_bilinear_layout(rows, cols, vals, nu, ni, **kw)
    for g, w in zip(got, want):
        assert_side_equal(g, w)
    if name == "graft_chunked":
        assert any(m.seg is not None for m in got[0].metas)


@pytest.mark.parametrize("degree_cap,seed", [(16, 0), (24, 9), (1024, 3)])
def test_neighbor_blocks_subsample_equals_reference(degree_cap, seed):
    """Rows past the degree cap keep the splitmix64-keyed subsample."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.zeros(100, np.int64), rng.integers(1, 9, 60)])
    cols = rng.integers(0, 500, len(rows))
    vals = rng.random(len(rows)).astype(np.float32)
    kw = dict(block_rows=8, degree_cap=degree_cap, seed=seed, pad_id=7)
    w = ref.build_neighbor_blocks(rows, cols, vals, 10, **kw)
    g = port.build_neighbor_blocks(rows, cols, vals, 10, **kw)
    np.testing.assert_array_equal(g.ids, w.ids)
    np.testing.assert_array_equal(g.vals, w.vals)
    assert (g.max_degree, g.dropped) == (w.max_degree, w.dropped)


def test_empty_side_and_splitmix_equal_reference():
    from predictionio_tpu import native

    e = np.array([], np.int64)
    w = ref.build_neighbor_blocks(e, e, e.astype(np.float32), 5)
    g = port.build_neighbor_blocks(e, e, e.astype(np.float32), 5)
    np.testing.assert_array_equal(g.ids, w.ids)
    np.testing.assert_array_equal(g.vals, w.vals)
    x = np.arange(0, 1 << 40, 1 << 27, dtype=np.uint64)
    np.testing.assert_array_equal(port._splitmix64(x), native.splitmix64_np(x))


@pytest.mark.parametrize("cost", [1000, 100_000])
def test_tier_edges_equal_reference(cost):
    rng = np.random.default_rng(0)
    degrees = rng.poisson(144, 3000) + 1
    assert port.optimal_tiers(degrees, tier_cost=cost) == \
        ref.optimal_tiers(degrees, tier_cost=cost)
    assert port.geometric_tiers(5000) == ref.geometric_tiers(5000)
