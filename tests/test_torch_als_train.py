"""ALS training on the port against the JAX package, on the CPU.

Each module of the half-step runs on the same numpy inputs in both
packages (the reference on its own CPU mesh, jitted as it runs; the port
with ``device="cpu"``, where every op is a plain PyTorch op):

- ``_gram_blocks``: explicit and implicit, masked and not, f32 and bf16
  factors, with and without the diagonal. Each output within 1e-5 of its
  largest magnitude (the two sum the D products in another order).
- ``_spd_solve``: CG cold and warm, a vector and a scalar shift, the
  implicit ``gram`` term, a bf16 matvec copy of A, cholesky and LU.
  Within 1e-4 of the largest |x|, or within twice the reference's own
  distance from the same solver run in float64 where that is larger: a
  cold CG that runs all R iterations on an R-dimensional system divides
  by residuals near zero in its last steps, and on this fixture JAX's f32
  CG lands 2.3e-3 (vector shift), 6.0e-3 (scalar shift) and 6.7e-3 (bf16
  matvec) of the largest |x| from float64 (measured; the port 2.3e-3,
  3.7e-3 and 6.7e-3, and 1.1e-3 to 4.5e-3 from JAX).
- ``make_train_step``: one step from identical ``u0``/``v0`` on the
  heavy-user fixture of ``__graft_entry__.py`` (``chunk_cap`` 16, so user
  0 rides the chunked tier), explicit and implicit, CG and cholesky,
  float32 and bfloat16: within 1e-4 of the largest |factor|. With bf16 CG
  the item half-step rounds the freshly solved user factors to bf16, and
  a summation-order difference of ~1e-5 in u tips some of those
  roundings: JAX's own item half-step moves by 1.1e-2 of the largest
  |v| when fed the port's u instead of its own (measured on this
  fixture). So at bf16 CG the item side is held at 1e-4 from the
  reference's own u, and the whole step's v at 2**-5.
- ``train_als``: three iterations from the reference's own init (its
  ``jax.random`` draws, handed to the port through ``init=``), within
  1e-3 of the largest |factor|, and the same top-10 for every user
  wherever neighbouring reference scores differ by 1e-4 or more — or by
  twice the reference's own score distance from the same algorithm in
  float64 (``_als64``), where that is larger: warm CG of depth 4 carries
  f32 rounding forward, and JAX's explicit-mode scores land 2.6e-3 from
  float64 on this fixture (the port's 1.5e-3; implicit mode and cholesky
  under 3e-5, measured). Both packages' factors are also held within
  twice the reference's distance from float64 (or 1e-4).

Then the semantics of the JAX package's own ALS tests
(``tests/test_als.py``) on the port alone, checkpoint resume, the
recommendation template trained through ``Engine.train`` and served over
HTTP, and a fresh interpreter that trains through the port without
loading jax.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import predictionio_tpu.models.als as jals  # noqa: E402
from predictionio_tpu.ops.neighbors import (  # noqa: E402
    build_bilinear_layout as jax_layout)
from predictionio_tpu.parallel.mesh import make_mesh  # noqa: E402
from predictionio_tpu.storage.bimap import BiMap as JaxBiMap  # noqa: E402
from predictionio_tpu.storage.frame import Ratings as JaxRatings  # noqa: E402
import predictionio_tpu_torch.models.als as tals  # noqa: E402
from predictionio_tpu_torch.controller import (  # noqa: E402
    DataSource, EngineParams)
from predictionio_tpu_torch.convert import als_train_state_from_numpy  # noqa: E402
from predictionio_tpu_torch.models.als import ALSConfig, train_als  # noqa: E402
from predictionio_tpu_torch.storage.bimap import BiMap  # noqa: E402
from predictionio_tpu_torch.storage.frame import Ratings  # noqa: E402
from predictionio_tpu_torch.templates.recommendation import (  # noqa: E402
    engine as tengine)
from predictionio_tpu_torch.workflow.checkpoint import TrainCheckpointer  # noqa: E402
from predictionio_tpu_torch.workflow.context import Context  # noqa: E402
from predictionio_tpu_torch.workflow.create_server import (  # noqa: E402
    EngineServer, serve)

REPO = Path(__file__).resolve().parents[1]
RANK = 8


def _load(relpath: str, name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / relpath)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


_tiny_coo = _load("__graft_entry__.py", "graft_torch_als")._tiny_coo


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def both_ratings(rows, cols, vals, nu, ni):
    """The same triples as the reference's Ratings and the port's."""
    kw = dict(user_indices=np.asarray(rows, np.int64),
              item_indices=np.asarray(cols, np.int64),
              ratings=np.asarray(vals, np.float32))
    return (JaxRatings(**kw, user_ids=JaxBiMap({f"u{i}": i for i in range(nu)}),
                       item_ids=JaxBiMap({f"i{j}": j for j in range(ni)})),
            Ratings(**kw, user_ids=BiMap({f"u{i}": i for i in range(nu)}),
                    item_ids=BiMap({f"i{j}": j for j in range(ni)})))


def make_ratings(rng, nu=60, ni=40, rank=3, density=0.5):
    """``tests/test_als.py::make_ratings`` on the port's Ratings."""
    u_true = rng.normal(size=(nu, rank)) / np.sqrt(rank) + 0.5
    v_true = rng.normal(size=(ni, rank)) / np.sqrt(rank) + 0.5
    full = u_true @ v_true.T
    mask = rng.random((nu, ni)) < density
    rows, cols = np.nonzero(mask)
    vals = full[rows, cols].astype(np.float32)
    return Ratings(
        user_indices=rows.astype(np.int32),
        item_indices=cols.astype(np.int32),
        ratings=vals,
        user_ids=BiMap({f"u{i}": i for i in range(nu)}),
        item_ids=BiMap({f"i{j}": j for j in range(ni)}),
    ), full, mask


def _cg64(a, b, shift, gram, x0, iters, diag=None):
    """The reference's Jacobi-preconditioned CG in float64 numpy."""
    a = np.asarray(a, np.float64)
    sh = np.zeros(len(b)) if shift is None else np.broadcast_to(
        np.asarray(shift, np.float64), (len(b),))
    d = np.diagonal(a, axis1=1, axis2=2) if diag is None else diag
    d = d + sh[:, None] + (np.diagonal(gram)[None] if gram is not None else 0)
    dinv = 1.0 / np.maximum(d, 1e-30)

    def mv(p):
        ap = np.einsum("brs,bs->br", a, p) + sh[:, None] * p
        return ap + p @ gram if gram is not None else ap

    x = np.zeros_like(b) if x0 is None else np.asarray(x0, np.float64)
    r = b - mv(x) if x0 is not None else np.asarray(b, np.float64)
    z = r * dinv
    rz = (r * z).sum(-1)
    p = z
    for _ in range(iters):
        ap = mv(p)
        alpha = rz / np.maximum((p * ap).sum(-1), 1e-30)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        z = r * dinv
        rz_new = (r * z).sum(-1)
        p = z + (rz_new / np.maximum(rz, 1e-30))[:, None] * p
        rz = rz_new
    return x


def _als64(rows, cols, vals, nu, ni, u0, v0, *, iters, lambda_, solver="cg",
           cg_iters=4, implicit=False, alpha=1.0):
    """The same blocked-WALS sweeps in float64, in true row order (the
    permuted layout only reorders rows, and every row solves on its own):
    the floor f32 rounding leaves, for either package."""
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)

    def side(r, c, n_rows, other, x0):
        rank = other.shape[1]
        a = np.zeros((n_rows, rank, rank))
        b = np.zeros((n_rows, rank))
        n = np.bincount(r, minlength=n_rows).astype(np.float64)
        f = other[c]
        w = alpha * vals if implicit else np.ones_like(vals)
        np.add.at(a, r, w[:, None, None] * f[:, :, None] * f[:, None, :])
        np.add.at(b, r, ((1 + alpha * vals) if implicit else vals)[:, None] * f)
        gram = other.T @ other if implicit else None
        shift = np.full(n_rows, lambda_) if implicit else lambda_ * np.maximum(n, 1)
        if solver == "cg":
            x = _cg64(a, b, shift, gram, x0, cg_iters)
        else:
            full = a + shift[:, None, None] * np.eye(rank)
            x = np.linalg.solve(full + (gram if implicit else 0),
                                b[..., None])[..., 0]
        x[n == 0] = 0.0  # the layout's zero tail
        return x

    u, v = np.asarray(u0, np.float64), np.asarray(v0, np.float64)
    v = np.where((np.bincount(cols, minlength=ni) == 0)[:, None], 0.0, v)
    for _ in range(iters):
        u = side(rows, cols, nu, v, u)
        v = side(cols, rows, ni, u, v)
    return u, v


# -- _gram_blocks -----------------------------------------------------------


def gram_inputs(seed=0, nb=3, blk=16, d=24, no=40, masked=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, no, (nb, blk, d)).astype(np.int32)
    vals = (rng.random((nb, blk, d)) * 5 + 0.5).astype(np.float32)
    deg = rng.integers(0, d + 1, (nb, blk))
    pad = np.arange(d)[None, None, :] >= deg[..., None]
    vals[pad] = 0.0
    # the permuted layout points padding at a zero row (the last); the
    # standalone path (masked) at row 0, a real row
    ids[pad] = 0 if masked else no - 1
    other = (rng.standard_normal((no, RANK)) / np.sqrt(RANK)).astype(np.float32)
    if not masked:
        other[no - 1] = 0.0
    return ids, vals, other


@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
@pytest.mark.parametrize("masked", [False, True], ids=["permuted", "masked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_diag", [False, True], ids=["nodiag", "diag"])
def test_gram_blocks_matches_reference(implicit, masked, dtype, with_diag):
    ids, vals, other = gram_inputs(masked=masked)
    kw = dict(implicit=implicit, alpha=2.5, rank=RANK, masked=masked,
              with_diag=with_diag)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jax.jit(lambda i, v, o: jals._gram_blocks(i, v, o, **kw))(
        jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(other, jdt))
    got = tals._gram_blocks(torch.from_numpy(ids), torch.from_numpy(vals),
                            torch.from_numpy(other).to(tdt), **kw)
    assert len(got) == len(want) == (4 if with_diag else 3)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert g.dtype == torch.float32
        assert rel(g.numpy(), np.asarray(w)) <= 1e-5


# -- _spd_solve -------------------------------------------------------------


def spd_inputs(seed=1, b=48, d=20):
    """Gramians of random factor rows, right-hand sides, degrees, an
    implicit-style VᵀV and a warm start near the solution."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((b, d, RANK)).astype(np.float32)
    n = rng.integers(1, d + 1, b)
    f[np.arange(d)[None, :] >= n[:, None]] = 0.0
    a = np.einsum("bdr,bds->brs", f, f).astype(np.float32)
    rhs = rng.standard_normal((b, RANK)).astype(np.float32)
    v = rng.standard_normal((30, RANK)).astype(np.float32) / 3
    gram = (v.T @ v).astype(np.float32)
    x0 = rng.standard_normal((b, RANK)).astype(np.float32) * 0.1
    return a, rhs, n.astype(np.float32), gram, x0


SOLVE_CASES = {
    "cg_cold": dict(solver="cg", cg_iters=8, shift="vector"),
    "cg_warm": dict(solver="cg", cg_iters=4, shift="vector", x0=True),
    "cg_scalar_shift": dict(solver="cg", cg_iters=8, shift="scalar"),
    "cg_gram": dict(solver="cg", cg_iters=16, shift="scalar", gram=True),
    "cg_gram_warm": dict(solver="cg", cg_iters=16, shift="scalar", gram=True,
                         x0=True),
    "cg_bf16_matvec": dict(solver="cg", cg_iters=8, shift="vector",
                           bf16=True, diag=True),
    "cg_no_shift": dict(solver="cg", cg_iters=8, shift=None, gram=True),
    "cholesky": dict(solver="cholesky", shift="vector"),
    "cholesky_gram": dict(solver="cholesky", shift="scalar", gram=True),
    "lu": dict(solver="lu", shift="vector"),
    "lu_gram": dict(solver="lu", shift="scalar", gram=True),
}


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_spd_solve_matches_reference(case):
    c = SOLVE_CASES[case]
    a, rhs, n, gram, x0 = spd_inputs()
    shift = {"vector": 0.1 * n, "scalar": 0.3, None: None}[c["shift"]]
    kw = dict(solver=c["solver"], cg_iters=c.get("cg_iters", 8))
    jargs, targs = {}, {}
    if shift is not None:
        jargs["shift"] = jnp.asarray(shift) if np.ndim(shift) else shift
        targs["shift"] = torch.from_numpy(shift) if np.ndim(shift) else shift
    if c.get("gram"):
        jargs["gram"], targs["gram"] = jnp.asarray(gram), torch.from_numpy(gram)
    if c.get("x0"):
        jargs["x0"], targs["x0"] = jnp.asarray(x0), torch.from_numpy(x0)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    jkw, tkw = dict(kw), dict(kw)
    if c.get("bf16"):
        ja, ta = ja.astype(jnp.bfloat16), ta.to(torch.bfloat16)
        jkw["matvec_dtype"], tkw["matvec_dtype"] = jnp.bfloat16, torch.bfloat16
    if c.get("diag"):
        dg = np.diagonal(a, axis1=1, axis2=2).copy()
        jargs["diag"], targs["diag"] = jnp.asarray(dg), torch.from_numpy(dg)
    want = np.asarray(jax.jit(
        lambda aa, bb, kk: jals._spd_solve(aa, bb, **jkw, **kk))(
            ja, jnp.asarray(rhs), jargs))
    got = tals._spd_solve(ta, torch.from_numpy(rhs), **tkw, **targs)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.isfinite(want).all()
    # the same solve in float64, on the same (bf16-rounded) A
    a64 = np.asarray(ja.astype(jnp.float32), np.float64)
    g64 = gram.astype(np.float64) if c.get("gram") else None
    sh64 = None if shift is None else np.asarray(shift, np.float64)
    if c["solver"] == "cg":
        exact = _cg64(a64, rhs.astype(np.float64), sh64, g64,
                      x0 if c.get("x0") else None, kw["cg_iters"],
                      diag=(np.diagonal(a, axis1=1, axis2=2)
                            if c.get("diag") else None))
    else:
        full = a64 + np.broadcast_to(sh64, (len(rhs),))[:, None, None] * \
            np.eye(RANK) + (g64 if g64 is not None else 0)
        exact = np.linalg.solve(full, rhs.astype(np.float64)[..., None])[..., 0]
    floor = rel(want, exact)
    tol = max(1e-4, 2 * floor)
    assert rel(got.numpy(), want) <= tol, (floor, rel(got.numpy(), exact))
    assert rel(got.numpy(), exact) <= tol


def test_cholesky_marks_a_singular_system_nan():
    """λ = 0 and a row without ratings: the reference's cholesky gives
    NaN; the port's ``cholesky_ex`` path gives NaN for that row (no
    raise) and solves the others."""
    a, rhs, n, _gram, _x0 = spd_inputs(b=4)
    a += np.eye(RANK, dtype=np.float32)  # SPD without a shift
    a[2] = 0.0
    got = tals._spd_solve(torch.from_numpy(a), torch.from_numpy(rhs),
                          solver="cholesky", shift=torch.zeros(4))
    assert torch.isnan(got[2]).all()
    assert torch.isfinite(got[[0, 1, 3]]).all()


# -- make_train_step -------------------------------------------------------


@pytest.fixture(scope="module")
def graft_layout():
    rows, cols, vals = _tiny_coo()
    lays = jax_layout(rows, cols, vals, 64, 48, chunk_cap=16, seed=0)
    assert any(m.seg is not None for m in lays[0].metas)
    rng = np.random.default_rng(11)
    u0 = np.abs(rng.standard_normal((64, RANK))).astype(np.float32) / np.sqrt(RANK)
    v0 = np.abs(rng.standard_normal((48, RANK))).astype(np.float32) / np.sqrt(RANK)
    return lays, u0, v0


def _jax_perm(mesh, x, lay):
    p = np.zeros((lay.slots, x.shape[1]), np.float32)
    p[lay.pos] = x
    return jax.device_put(p, NamedSharding(mesh, P(None, None)))


@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
@pytest.mark.parametrize("solver", ["cg", "cholesky"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_reference(mesh, graft_layout, implicit, solver,
                                      dtype):
    (u_lay, i_lay), u0, v0 = graft_layout
    vd = "bfloat16" if dtype == "bfloat16" else None
    kw = dict(rank=RANK, lambda_=0.1, implicit=implicit, alpha=2.0,
              compute_dtype=dtype, solver=solver)
    jstep = jals.make_train_step(mesh, u_lay, i_lay, **kw)
    jub = jals.put_layout(u_lay, mesh, vals_dtype=vd)
    jib = jals.put_layout(i_lay, mesh, vals_dtype=vd)
    uj, vj = (np.asarray(x) for x in jstep(
        jub, jib, _jax_perm(mesh, u0, u_lay), _jax_perm(mesh, v0, i_lay)))
    # the port reads the reference's layout arrays (the layout test pins
    # them equal to its own)
    ub, ib, up, vp = als_train_state_from_numpy(u_lay, i_lay, u0, v0,
                                                device="cpu", vals_dtype=vd)
    tstep = tals.make_train_step(u_lay, i_lay, **kw)
    ut, vt = tstep(ub, ib, up, vp)
    assert ut.shape == (u_lay.slots, RANK) and vt.shape == (i_lay.slots, RANK)
    # the zero tail: degree-0 rows, block padding past the tiers, zero slot
    covered_u = sum(m.span for m in u_lay.metas)
    assert not ut[covered_u:].any() and not vt[sum(m.span for m in i_lay.metas):].any()
    assert rel(ut.numpy(), uj) <= 1e-4
    if solver == "cg" and dtype == "bfloat16":
        assert rel(vt.numpy(), vj) <= 2.0**-5
        kwd = dict(kw, cg_iters=jals._resolve_cg_iters(None, implicit,
                                                       warm=True))
        v_from_ref_u = tals._solve_side(ib, i_lay, torch.from_numpy(uj.copy()),
                                        kw=kwd, x0=vp)
        assert rel(v_from_ref_u.numpy(), vj) <= 1e-4
    else:
        assert rel(vt.numpy(), vj) <= 1e-4


def test_half_step_matches_reference():
    """The standalone half-step (masked blocks, pad ids at row 0) on the
    graft entry's own arguments."""
    from predictionio_tpu.ops.neighbors import build_neighbor_blocks

    rows, cols, vals = _tiny_coo()
    ub = build_neighbor_blocks(rows, cols, vals, 64, block_rows=16)
    other = np.ones((48, RANK), np.float32) / RANK
    other += np.random.default_rng(3).random((48, RANK)).astype(np.float32) / 10
    kw = dict(lambda_=0.1, implicit=False, alpha=1.0, rank=RANK)
    want = np.asarray(jax.jit(lambda i, v, o: jals._half_step(i, v, o, **kw))(
        ub.ids, ub.vals, other))
    got = tals._half_step(torch.from_numpy(ub.ids), torch.from_numpy(ub.vals),
                          torch.from_numpy(other), **kw)
    assert tuple(got.shape) == want.shape
    assert rel(got.numpy(), want) <= 1e-4


# -- train_als --------------------------------------------------------------


def _jax_init(seed, nu, ni, rank):
    """The reference's init draws (models/als.py train_als)."""
    k_u, k_v = jax.random.split(jax.random.PRNGKey(seed))
    v0 = np.abs(np.asarray(jax.random.normal(k_v, (ni, rank), jnp.float32))) \
        / np.sqrt(rank)
    u0 = np.abs(np.asarray(jax.random.normal(k_u, (nu, rank), jnp.float32))) \
        / np.sqrt(rank)
    return u0.astype(np.float32), v0.astype(np.float32)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(implicit_prefs=True, alpha=4.0),
    dict(solver="cholesky", chunk_cap=16),
], ids=["explicit_cg", "implicit_cg", "cholesky_chunked"])
def test_train_als_matches_reference(mesh, cfg):
    rng = np.random.default_rng(5)
    nu, ni = 64, 48
    rows, cols, vals = _tiny_coo(nu, ni, seed=4)
    vals = np.abs(vals) + rng.random(len(vals)).astype(np.float32)
    jr, tr = both_ratings(rows, cols, vals, nu, ni)
    config = dict(rank=RANK, iterations=3, lambda_=0.1, seed=9, **cfg)
    u0, v0 = _jax_init(9, nu, ni, RANK)
    want = jals.train_als(jr, jals.ALSConfig(**config), mesh=mesh)
    got = train_als(tr, ALSConfig(**config), device="cpu", init=(u0, v0))
    implicit = cfg.get("implicit_prefs", False)
    u64, v64 = _als64(rows, cols, vals, nu, ni, u0, v0, iters=3,
                      lambda_=0.1, solver=cfg.get("solver", "cg"),
                      cg_iters=16 if implicit else 4, implicit=implicit,
                      alpha=cfg.get("alpha", 1.0))
    for mine, ref, exact in ((got.user_factors, want.user_factors, u64),
                             (got.item_factors, want.item_factors, v64)):
        assert rel(mine, ref) <= 1e-3
        assert rel(mine, exact) <= max(1e-4, 2 * rel(ref, exact))
    ref_scores = want.user_factors @ want.item_factors.T
    port_scores = got.user_factors @ got.item_factors.T
    score_floor = float(np.abs(ref_scores - u64 @ v64.T).max())
    near_tie = max(1e-4, 2 * score_floor)
    for u in range(nu):
        order = np.argsort(-ref_scores[u], kind="stable")[:10]
        mine = np.argsort(-port_scores[u], kind="stable")[:10]
        s = ref_scores[u][order]
        # a swap is allowed only between near-tied neighbours
        for k in np.nonzero(order != mine)[0]:
            near = [abs(s[k] - s[j]) < near_tie for j in (k - 1, k + 1)
                    if 0 <= j < len(s)]
            assert any(near), (u, k, order, mine, score_floor)


def test_train_als_init_shape_is_checked():
    ratings, _full, _mask = make_ratings(np.random.default_rng(0), nu=6, ni=5)
    with pytest.raises(ValueError, match="init must be"):
        train_als(ratings, ALSConfig(rank=4, iterations=1), device="cpu",
                  init=(np.zeros((6, 3)), np.zeros((5, 4))))
    with pytest.raises(ValueError, match="empty ratings"):
        train_als(Ratings(np.zeros(0, np.int64), np.zeros(0, np.int64),
                          np.zeros(0, np.float32), BiMap({}), BiMap({})),
                  ALSConfig(rank=4), device="cpu")


def test_train_als_model_sharded_trains_replicated(caplog):
    ratings, _full, _mask = make_ratings(np.random.default_rng(0), nu=12, ni=9)
    cfg = ALSConfig(rank=4, iterations=2, solver="cholesky")
    with caplog.at_level("WARNING"):
        ms = train_als(ratings, dataclasses.replace(cfg, model_sharded=True),
                       device="cpu")
    assert "replicated factors" in caplog.text
    rep = train_als(ratings, cfg, device="cpu")
    np.testing.assert_array_equal(ms.user_factors, rep.user_factors)
    np.testing.assert_array_equal(ms.item_factors, rep.item_factors)


# -- the semantics of tests/test_als.py on the port --------------------------


def test_als_explicit_reconstructs(rng):
    ratings, full, mask = make_ratings(rng)
    model = train_als(ratings, ALSConfig(rank=8, iterations=12, lambda_=0.01),
                      device="cpu")
    pred = model.user_factors @ model.item_factors.T
    rmse = np.sqrt(np.mean((pred[mask] - full[mask]) ** 2))
    base = np.sqrt(np.mean((full[mask] - full[mask].mean()) ** 2))
    assert rmse < 0.15 * base, f"rmse {rmse} vs baseline {base}"


def test_als_zero_iterations_solves_half_step(rng):
    """iterations=0 returns the half-step solve of u from the item init,
    not the user init that only seeds CG."""
    ratings, _full, _mask = make_ratings(rng)
    m0 = train_als(ratings, ALSConfig(rank=8, iterations=0, lambda_=0.01),
                   device="cpu")
    v = m0.item_factors
    checked = 0
    for u in range(ratings.num_users):
        sel = ratings.user_indices == u
        if sel.sum() < 12:
            continue
        vi = v[ratings.item_indices[sel]]
        b = ratings.ratings[sel]
        a = vi.T @ vi + 0.01 * sel.sum() * np.eye(8)
        x = np.linalg.solve(a, vi.T @ b)
        np.testing.assert_allclose(m0.user_factors[u], x, rtol=0.05, atol=0.02)
        checked += 1
        if checked >= 3:
            break
    assert checked >= 3


def test_als_implicit_ranks_positives():
    nu, ni = 40, 30
    rows, cols = [], []
    for u in range(nu):
        for j in range(ni):
            if j % 2 == u % 2:
                rows.append(u)
                cols.append(j)
    ratings = Ratings(
        user_indices=np.asarray(rows, np.int32),
        item_indices=np.asarray(cols, np.int32),
        ratings=np.ones(len(rows), np.float32),
        user_ids=BiMap({f"u{i}": i for i in range(nu)}),
        item_ids=BiMap({f"i{j}": j for j in range(ni)}),
    )
    cfg = ALSConfig(rank=4, iterations=8, implicit_prefs=True, alpha=20.0,
                    lambda_=0.05)
    model = train_als(ratings, cfg, device="cpu")
    pred = model.user_factors @ model.item_factors.T
    seen = np.zeros((nu, ni), bool)
    seen[rows, cols] = True
    assert pred[seen].mean() > pred[~seen].mean() + 0.3


def test_solver_parity_cg_vs_exact(rng):
    ratings, full, mask = make_ratings(rng, nu=40, ni=30, rank=4, density=0.4)
    base = ALSConfig(rank=8, iterations=8, lambda_=0.05, seed=3)

    def rmse(m):
        pred = m.user_factors @ m.item_factors.T
        return float(np.sqrt(np.mean((pred[mask] - full[mask]) ** 2)))

    scores = {solver: rmse(train_als(
        ratings, dataclasses.replace(base, solver=solver), device="cpu"))
        for solver in ("cg", "cholesky", "lu")}
    assert abs(scores["cg"] - scores["cholesky"]) < 1e-3, scores
    assert abs(scores["cholesky"] - scores["lu"]) < 1e-4, scores


def test_solver_parity_implicit(rng):
    ratings, _full, _mask = make_ratings(rng, nu=30, ni=25, rank=4, density=0.5)
    ratings = Ratings(
        user_indices=ratings.user_indices, item_indices=ratings.item_indices,
        ratings=np.abs(ratings.ratings), user_ids=ratings.user_ids,
        item_ids=ratings.item_ids)
    base = ALSConfig(rank=8, iterations=6, lambda_=0.1, seed=3,
                     implicit_prefs=True, alpha=5.0)
    m_cg = train_als(ratings, dataclasses.replace(base, solver="cg"),
                     device="cpu")
    m_ex = train_als(ratings, dataclasses.replace(base, solver="cholesky"),
                     device="cpu")
    p_cg = m_cg.user_factors @ m_cg.item_factors.T
    p_ex = m_ex.user_factors @ m_ex.item_factors.T
    assert np.max(np.abs(p_cg - p_ex)) / (np.abs(p_ex).max() + 1e-9) < 5e-3


@pytest.mark.parametrize("cfg", [dict(), dict(compute_dtype="bfloat16"),
                                 dict(implicit_prefs=True, chunk_cap=16)],
                         ids=["f32", "bf16", "implicit_chunked"])
def test_tier_wise_solve_matches_global(rng, monkeypatch, cfg):
    """Above SOLVE_EQ_BUDGET_BYTES the half-step solves piece-wise (the
    path the ML-20M user side takes); the result matches the global
    solve."""
    ratings, _full, _mask = make_ratings(rng, nu=80, ni=50)
    config = ALSConfig(rank=8, iterations=4, lambda_=0.01, seed=9, **cfg)
    m_global = train_als(ratings, config, device="cpu")
    monkeypatch.setattr(tals, "SOLVE_EQ_BUDGET_BYTES", 1)
    m_tiered = train_als(ratings, config, device="cpu")
    np.testing.assert_allclose(m_tiered.user_factors, m_global.user_factors,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m_tiered.item_factors, m_global.item_factors,
                               rtol=1e-5, atol=1e-6)


def test_zero_rating_mask_derivation(rng):
    nu, ni, n = 20, 15, 200
    r = Ratings(
        user_indices=rng.integers(0, nu, n).astype(np.int64),
        item_indices=rng.integers(0, ni, n).astype(np.int64),
        ratings=np.where(rng.random(n) < 0.3, 0.0,
                         rng.random(n) * 4 + 1).astype(np.float32),
        user_ids=BiMap({f"u{i}": i for i in range(nu)}),
        item_ids=BiMap({f"i{i}": i for i in range(ni)}),
    )
    model = train_als(r, ALSConfig(rank=4, iterations=3, implicit_prefs=True),
                      device="cpu")
    assert np.isfinite(model.user_factors).all()
    assert np.isfinite(model.item_factors).all()


# -- checkpoint resume ------------------------------------------------------


@pytest.mark.parametrize("cfg", [dict(cg_iters=4), dict(solver="cholesky")],
                         ids=["cg", "cholesky"])
def test_checkpoint_resume_is_bitwise(rng, tmp_path, cfg):
    """2 + 2 iterations through the checkpointer equal 4 uninterrupted
    ones bitwise (an explicit ``cg_iters``: runs under 3 iterations
    otherwise take the cold CG depth)."""
    ratings, _full, _mask = make_ratings(rng, nu=30, ni=20)
    base = ALSConfig(rank=6, iterations=4, lambda_=0.05, seed=4, **cfg)
    whole = train_als(ratings, base, device="cpu")
    ck = TrainCheckpointer(tmp_path / "ck")
    train_als(ratings, dataclasses.replace(base, iterations=2), device="cpu",
              checkpointer=ck, checkpoint_every=1)
    assert ck.steps() == [1, 2]
    resumed = train_als(ratings, base, device="cpu", checkpointer=ck,
                        checkpoint_every=2)
    assert ck.steps() == [2, 4]
    np.testing.assert_array_equal(resumed.user_factors, whole.user_factors)
    np.testing.assert_array_equal(resumed.item_factors, whole.item_factors)
    # a finished run resumes to the same model without a step
    again = train_als(ratings, base, device="cpu", checkpointer=ck)
    np.testing.assert_array_equal(again.user_factors, whole.user_factors)
    # a changed fingerprint (another λ) clears the stale steps
    other = train_als(ratings, dataclasses.replace(base, lambda_=0.2),
                      device="cpu", checkpointer=ck)
    assert ck.steps() == []
    assert not np.array_equal(other.user_factors, whole.user_factors)


# -- the template -----------------------------------------------------------


def _template_ratings():
    rng = np.random.default_rng(21)
    rows, cols, vals = _tiny_coo(seed=6)
    vals = (np.round(rng.random(len(vals)) * 9 + 1) / 2).astype(np.float32)
    return both_ratings(rows, cols, vals, 64, 48)[1]


class MemoryRatings(DataSource):
    """An in-memory data source (the event store comes with the storage
    slice)."""

    def read_training(self, ctx):
        return tengine.TrainingData(_template_ratings())


def _post(port, payload: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_template_trains_and_serves(tmp_path):
    engine = tengine.engine_factory()
    engine.data_source_classes = {"": MemoryRatings}
    params = tengine.AlgorithmParams(rank=8, num_iterations=4, lambda_=0.05,
                                     seed=3)
    ctx = Context(device="cpu", checkpoint_dir=str(tmp_path),
                  checkpoint_every=2)
    result = engine.train(ctx, EngineParams(
        algorithm_params_list=(("als", params),)))
    model = result.models[0]
    assert ctx.current_algorithm is None
    assert [p for p, _ in ctx.phase_times][-1] == "train[als#0]"
    assert TrainCheckpointer(tmp_path / "als#0" / "als").steps() == [2, 4]
    want = train_als(_template_ratings(), tengine.ALSAlgorithm(params)
                     .als_config(), device="cpu")
    np.testing.assert_array_equal(model.user_factors, want.user_factors)
    np.testing.assert_array_equal(model.item_factors, want.item_factors)

    server = EngineServer(tengine.engine_factory(), result, "als-train",
                          device="cpu", batch_max=8)
    users, items = model.user_factors, model.item_factors
    queries = [{"user": f"u{u}", "num": n}
               for u, n in ((0, 4), (3, 10), (17, 1), (63, 20), (41, 48))]
    with serve(server, "127.0.0.1", 0) as front:
        for q in queries:
            got = _post(front.port, q)["itemScores"]
            scores = items @ users[int(q["user"][1:])]
            top = np.argsort(-scores, kind="stable")[:q["num"]]
            assert [g["item"] for g in got] == [f"i{j}" for j in top]
            np.testing.assert_allclose([g["score"] for g in got], scores[top],
                                       rtol=1e-5, atol=1e-6)
        assert _post(front.port, {"user": "nobody", "num": 3}) == \
            {"itemScores": []}


def test_template_data_checks():
    empty = Ratings(np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.float32), BiMap({}), BiMap({}))
    with pytest.raises(ValueError, match="No rate/buy events"):
        tengine.TrainingData(empty).sanity_check()
    td = tengine.TrainingData(_template_ratings())
    assert tengine.RecommendationPreparator().prepare(None, td) is td.ratings
    cfg = tengine.ALSAlgorithm(tengine.AlgorithmParams(
        rank=5, num_iterations=7, lambda_=0.2, seed=1)).als_config()
    assert (cfg.rank, cfg.iterations, cfg.lambda_, cfg.seed) == (5, 7, 0.2, 1)


_DRIVE = r"""
import json, sys
import numpy as np
from predictionio_tpu_torch.models.als import ALSConfig, train_als
from predictionio_tpu_torch.storage.frame import Ratings

rng = np.random.default_rng(0)
r = Ratings.from_triples([f"u{u}" for u in rng.integers(0, 20, 300)],
                         [f"i{i}" for i in rng.integers(0, 15, 300)],
                         rng.random(300) * 4 + 1)
m = train_als(r, ALSConfig(rank=4, iterations=2, chunk_cap=8), device="cpu")
print(json.dumps({
    "finite": bool(np.isfinite(m.user_factors).all()),
    "jax": sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib")),
    "reference": sorted(k for k in sys.modules
                        if k.split(".")[0] == "predictionio_tpu"),
}))
"""


def test_training_through_the_port_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _DRIVE], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"finite": True, "jax": [], "reference": []}
