"""The huge attention backward (head dims above 1,024) as a score pass into
a banded workspace and tiled products over 128-feature slices:
``csrc/flash_attn_huge.cu``.

The kernels run only on the card. Here a torch mirror of their arithmetic
(``huge_backward``) stands in for them. The score pass forms S and dP of
every visible 64 x 64 tile pair over D, in chunks of 32 (f32) or 64 (bf16)
features in increasing order, then P = exp2(S * s * log2(e) - lse *
log2(e)) masked to exact zeros and dS = (dP - di) * P * s from the
unrounded P, both rounded to bf16 for bf16 inputs. The product pass sums,
per 64-row own tile and 128-feature slice, the other side's visible tiles
in increasing position: dV = P^T dO and dK = dS^T Q over query tiles, dQ =
dS K over key tiles, band by band as ``kernels.huge_bwd_plan`` splits the
own tiles so the workspace stays within its cap.

- The mirror against ``jax.vjp`` of the JAX package's
  ``blockwise_attention`` (the reference answers these head dims with it),
  each gradient within ``GRAD_TOL`` of its largest magnitude (1e-4 for
  f32: the two sum in other orders; 2^-6 for bf16: P and dS rounded where
  autodiff of the bf16 forward rounds elsewhere), at D 1,152 and 2,048,
  causal and full, f32 and bf16, at lengths ragged at 64 (200, 257); and
  bitwise the same when a small cap splits it into bands.
- The launch plan as ``ops/kernels.py::huge_bwd_plan`` computes it (and
  ``pio_flash_attn_huge_bwd_plan`` reports it on the card): band width and
  count, workspace bytes within the cap, grids, threads and shared memory
  at the timed shape; every visible tile pair in exactly one band from L 1
  to 12,345 and with (batch, head)s split across bands; the shapes and
  kinds refused; the heaviest own tile first; and the launch path sizing
  the workspace from the plan.
- A planted defect: a dK/dV band boundary that drops or doubles one key
  tile fails the parity check.
- On the card (``cuda`` marker, skipped here): the kernels against the
  plain version at D 1,152, 1,536, 2,048 and 4,096, causal and full, both
  types, bitwise from run to run, and at L 8,192 in two bands.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from predictionio_tpu.parallel import ring_attention as jra  # noqa: E402
from predictionio_tpu_torch.ops import kernels  # noqa: E402
from predictionio_tpu_torch.parallel import ring_attention as tra  # noqa: E402

#: each gradient against its largest magnitude (chip_smoke.py's BWD_TOL)
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2.0**-6}
#: rows of a score tile, features of a product slice, the workspace cap,
#: and the shared memory a CTA may take on an H100
TILE, SLICE, CAP, SMEM_MAX_BYTES = 64, 128, 256 << 20, 232_448
HUGE_DIMS = [1152, 2048]
#: ops/kernels.py's kinds of backward launch
DQ, DKV = 1, 2
#: log2(e) as the kernels hold it (f32)
LOG2E = float(np.float32(1.4426950408889634))
#: the plan itself, for stand-ins while a test spies on it
PLAN = kernels.huge_bwd_plan


def _seen(kind: int, causal: bool, t: int, nt: int) -> range:
    """The other side's tiles that own tile ``t`` sees (in increasing
    position): dK/dV's key tile t the query tiles from t on, dQ's query tile
    t the key tiles up to t, under a causal mask; all of them without."""
    if not causal:
        return range(nt)
    return range(t, nt) if kind == DKV else range(t + 1)


def huge_backward(q, k, v, do, lse, di, *, causal: bool,
                  scale: float | None = None, bands=None):
    """The kernels' arithmetic in torch on [B, L, H, D] tensors (f32 or
    bf16, D a multiple of 128 above 1,024) with the forward's ``lse`` and
    ``di = rowsum(do * o)`` ([B, H, L] f32): returns ``(dq, dk, dv)`` in
    the input type. ``bands[kind]`` (a list of ((batch, head)s, own tiles))
    replaces the plan's bands for that kind; each band's sums are added to
    the gradients, so a tile in two bands counts twice and a tile in none
    stays zero."""
    B, L, H, D = q.shape
    f32, bf16 = torch.float32, q.dtype == torch.bfloat16
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    scale2 = float(np.float32(scale) * np.float32(LOG2E))
    chunk = 64 if bf16 else 32
    nt = -(-L // TILE)
    Lp, pad = nt * TILE, nt * TILE - L

    def rows(x):  # [B * H, Lp, D] f32, zero rows past L
        x = torch.nn.functional.pad(x.transpose(1, 2).to(f32),
                                    (0, 0, 0, pad))
        return x.reshape(B * H, Lp, D)

    def rounded(x):  # a workspace value as the kernels store it
        return x.to(torch.bfloat16).to(f32) if bf16 else x

    qs, ks, vs, dos = (rows(x) for x in (q, k, v, do))
    # the score pass: S and dP [query][key] over D, chunks in order
    s = torch.zeros(B * H, Lp, Lp)
    dp = torch.zeros(B * H, Lp, Lp)
    for c0 in range(0, D, chunk):
        c = slice(c0, c0 + chunk)
        s += qs[..., c] @ ks[..., c].transpose(-1, -2)
        dp += dos[..., c] @ vs[..., c].transpose(-1, -2)
    lse2 = torch.nn.functional.pad(lse.reshape(B * H, L), (0, pad)) * LOG2E
    dis = torch.nn.functional.pad(di.reshape(B * H, L), (0, pad))
    pos = torch.arange(Lp)
    seen = (pos[:, None] < L) & (pos[None, :] < L)
    if causal:
        seen &= pos[None, :] <= pos[:, None]
    p = torch.where(seen, torch.exp2(s * scale2 - lse2[..., None]), 0.0)
    ds = torch.where(seen, (dp - dis[..., None]) * p * scale, 0.0)
    p, ds = rounded(p), rounded(ds)

    # the product pass, band by band: every 128-feature slice's columns are
    # dot products over the 64 rows of each other tile, independent of the
    # other slices, so one product takes all slices (and the band's (batch,
    # head)s) at once
    dq, dk, dv = (torch.zeros(B * H, Lp, D) for _ in range(3))
    for kind in (DKV, DQ):
        plan_bands = (bands or {}).get(kind) or [
            (band["heads"], band["tiles"]) for band in kernels.huge_bwd_plan(
                B, L, H, D, q.dtype, kind, causal)["bands"]]
        for heads, tiles in plan_bands:
            hs = slice(heads.start, heads.stop)
            for t in tiles:
                own = slice(t * TILE, (t + 1) * TILE)
                acc = torch.zeros(2, len(heads), TILE, D)
                for o in _seen(kind, causal, t, nt):  # increasing position
                    oth = slice(o * TILE, (o + 1) * TILE)
                    if kind == DKV:
                        acc[0] += p[hs, oth, own].transpose(-1, -2) @ dos[
                            hs, oth]
                        acc[1] += ds[hs, oth, own].transpose(-1, -2) @ qs[
                            hs, oth]
                    else:
                        acc[0] += ds[hs, own, oth] @ ks[hs, oth]
                if kind == DKV:
                    dv[hs, own] += acc[0]
                    dk[hs, own] += acc[1]
                else:
                    dq[hs, own] += acc[0]

    def back(x):
        return (x.reshape(B, H, Lp, D)[:, :, :L].transpose(1, 2)
                .to(q.dtype))

    return back(dq), back(dk), back(dv)


def _arrays(seed: int, B: int, L: int, H: int, D: int):
    """q, k, v and the output gradient, f32 numpy."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, L, H, D)) * 0.5).astype(np.float32)
            for _ in range(4)]


def _mirror(tq, tk, tv, tdo, causal: bool, **kw):
    """The mirror on the plain forward's logsumexp and di."""
    o, lse = tra.blockwise_attention(tq, tk, tv, causal=causal,
                                     return_lse=True)
    return huge_backward(tq, tk, tv, tdo, lse, tra.attention_di(o, tdo),
                         causal=causal, **kw)


def _jax_grads(arrs, causal: bool, dtype: str):
    jdt = getattr(jnp, dtype)
    # one compiled program for the forward and its vjp
    grads = jax.jit(lambda q, k, v, do: jax.vjp(
        lambda q, k, v: jra.blockwise_attention(q, k, v, causal=causal),
        q, k, v)[1](do))
    return [np.asarray(g.astype(jnp.float32))
            for g in grads(*(jnp.asarray(a, jdt) for a in arrs))]


def _worst(got, want) -> float:
    """The largest error of the three gradients over each one's largest
    magnitude."""
    return max(float(np.abs(g.float().numpy() - w).max())
               / float(np.abs(w).max()) for g, w in zip(got, want))


@pytest.mark.parametrize("L", [200, 257])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", HUGE_DIMS)
def test_mirror_matches_jax_vjp(D, causal, dtype, L):
    arrs = _arrays(D + L + 3, 1, L, 2, D)
    tdt = getattr(torch, dtype)
    want = _jax_grads(arrs, causal, dtype)
    got = _mirror(*(torch.from_numpy(a).to(tdt) for a in arrs), causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == (1, L, 2, D) and g.dtype == tdt, name
        scale = float(np.abs(w).max())
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= GRAD_TOL[dtype] * scale, (name, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_bands_leave_the_sums_unchanged(monkeypatch, causal, dtype):
    """Every gradient row is complete in one band, so a cap that splits
    both kinds into several bands (and the (batch, head)s across bands)
    gives the same bits as one band."""
    B, L, H, D = 2, 257, 2, 1152
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _arrays(D + 17, B, L, H, D))
    one = _mirror(q, k, v, do, causal)
    cap = 5 * TILE * TILE * 2 * (4 if dtype == torch.float32 else 2) * 2
    monkeypatch.setattr(kernels, "HUGE_WS_CAP", cap)
    for kind in (DQ, DKV):
        plan = kernels.huge_bwd_plan(B, L, H, D, dtype, kind, causal)
        assert len(plan["bands"]) >= 3 and plan["workspace_bytes"] <= cap
    split = _mirror(q, k, v, do, causal)
    assert all(torch.equal(a, b) for a, b in zip(one, split))


def test_timed_shape_plan():
    """B1 L1024 H2 D4096: one band of all 16 tiles of both heads; a score
    CTA per visible tile pair (136 a head causal, 256 full), a product CTA
    per (slice, head, own tile): 32 x 2 x 16 = 1,024."""
    B, L, H, D = 1, 1024, 2, 4096
    for dtype, esize in ((torch.float32, 4), (torch.bfloat16, 2)):
        for kind, planes in ((DKV, 2), (DQ, 1)):
            for causal, pairs in ((True, 136), (False, 256)):
                plan = kernels.huge_bwd_plan(B, L, H, D, dtype, kind,
                                             causal)
                assert (plan["band_tiles"], plan["band_heads"],
                        len(plan["bands"])) == (16, 2, 1)
                # both heads' 16 x 16 tile slots, planes 64 x 64 tiles each
                assert plan["workspace_bytes"] == (
                    2 * 16 * 16 * planes * TILE * TILE * esize)
                assert plan["score"]["grid"] == (pairs, 2, 1)
                assert plan["product"]["grid"] == (32, 2, 16)
                assert plan["score"]["threads"] == 256
                assert plan["product"]["threads"] == 128 * planes
                # score: two stages of the four 64-row tiles, rows of 128
                # bytes of features padded by 16; product: two stages of
                # each output's workspace tile [64][64 + pad] and slice
                # [64][128 + pad]
                assert plan["score"]["smem_bytes"] == 2 * 4 * 64 * 144
                pad = 16 // esize
                assert plan["product"]["smem_bytes"] == (
                    2 * planes * 64 * (64 + pad + 128 + pad) * esize)
                assert plan["product"]["smem_bytes"] <= SMEM_MAX_BYTES
    assert kernels.huge_bwd_plan(B, L, H, D, torch.float32, DKV)[
        "product"]["smem_bytes"] == 204_800


def _cover(plan, B, L, H, kind, causal):
    """Every (batch, head, own tile) in exactly one band, and each band's
    score grid its visible pairs."""
    nt = -(-L // TILE)
    hits = np.zeros((B * H, nt), np.int64)
    for band in plan["bands"]:
        heads, tiles = band["heads"], band["tiles"]
        assert band["score_grid"] == (
            sum(len(_seen(kind, causal, t, nt)) for t in tiles),
            len(heads), 1)
        assert band["product_grid"][1:] == (len(heads), len(tiles))
        hits[heads.start:heads.stop, min(tiles):max(tiles) + 1] += 1
        assert len(tiles) <= plan["band_tiles"]
        assert len(heads) <= plan["band_heads"]
    assert (hits == 1).all()
    return hits


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", [DQ, DKV])
@pytest.mark.parametrize("L", [1, 64, 1024, 8192, 12_345])
def test_every_visible_pair_in_one_band(L, kind, dtype, causal):
    B, H, D = 1, 1, 1152
    plan = kernels.huge_bwd_plan(B, L, H, D, dtype, kind, causal)
    nt = -(-L // TILE)
    col = nt * (2 if kind == DKV else 1) * TILE * TILE * (
        4 if dtype == torch.float32 else 2)
    assert col <= plan["workspace_bytes"] <= CAP
    assert plan["band_tiles"] == min(nt, CAP // col)
    assert len(plan["bands"]) == -(-nt // plan["band_tiles"])
    _cover(plan, B, L, H, kind, causal)
    # the pairs themselves, band by band
    pairs = [(t, o) for band in plan["bands"] for t in band["tiles"]
             for o in _seen(kind, causal, t, nt)]
    assert len(pairs) == len(set(pairs)) == sum(
        len(_seen(kind, causal, t, nt)) for t in range(nt))
    if L == 8192:  # f32 dK/dV: 128 tiles of 4 MiB, 64 a band
        assert len(plan["bands"]) == (
            2 if (kind, dtype) == (DKV, torch.float32) else 1)
    if L == 12_345 and dtype == torch.float32:
        assert len(plan["bands"]) >= 3


@pytest.mark.parametrize("kind", [DQ, DKV])
def test_heads_split_across_bands(kind):
    """Where one own tile of every (batch, head) is above the cap, a band
    takes one own tile of as many (batch, head)s as fit."""
    B, L, H, D = 20, 8192, 10, 1152
    plan = kernels.huge_bwd_plan(B, L, H, D, torch.float32, kind)
    col = 128 * (2 if kind == DKV else 1) * TILE * TILE * 4
    assert plan["band_tiles"] == 1 and plan["band_heads"] == CAP // col
    assert plan["workspace_bytes"] == CAP
    assert len(plan["bands"]) == -(-200 // plan["band_heads"]) * 128
    _cover(plan, B, L, H, kind, True)


def test_plan_refuses_what_the_kernels_do_not_take():
    ok = kernels.huge_bwd_plan(1, 524_288, 1, 1152, torch.float32, DKV)
    assert ok["workspace_bytes"] == CAP and ok["band_tiles"] == 1
    for shape, dtype, kind in (
            ((1, 524_289, 1, 1152), torch.float32, DKV),  # one tile > cap
            ((1, 1_048_577, 1, 1152), torch.float32, DQ),
            ((1, 8, 1, 1024), torch.float32, DQ),  # the wide kernels'
            ((1, 8, 1, 1100), torch.float32, DKV),
            ((0, 8, 1, 1152), torch.float32, DKV),
            ((1, 8, 65536, 1152), torch.float32, DQ),
            ((1, 0, 1, 1152), torch.float32, DKV),
            ((1, 8, 1, 1152), torch.float16, DKV),
            ((1, 8, 1, 1152), torch.float32, 0),
            ((1, 8, 1, 1152), torch.float32, 3)):
        with pytest.raises(ValueError):
            kernels.huge_bwd_plan(*shape, dtype, kind)
    # bf16 dK/dV and f32 dQ store half the bytes a pair: twice the length
    assert kernels.huge_bwd_plan(1, 1_048_576, 1, 1152, torch.bfloat16,
                                 DKV)["band_tiles"] == 1


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", [DQ, DKV])
@pytest.mark.parametrize("L", [1, 200, 1024, 12_345])
def test_heaviest_own_tile_first(L, kind, causal):
    """In launch order (bands, then each band's own tiles as grid z takes
    them) the other-side tiles an own tile walks never grow: dK/dV from the
    first key tile, dQ from the last query tile."""
    plan = kernels.huge_bwd_plan(1, L, 1, 1152, torch.float32, kind, causal)
    nt = -(-L // TILE)
    order = [t for band in plan["bands"] for t in band["tiles"]]
    assert sorted(order) == list(range(nt))
    walks = [len(_seen(kind, causal, t, nt)) for t in order]
    assert walks == sorted(walks, reverse=True)
    assert order == sorted(order, reverse=kind == DQ)


class _FakeLib:
    """Stand-in for the kernel library: the workspace it reports (the
    plan's, or off by ``skew``) and the entry points' arguments."""

    def __init__(self, skew: int = 0):
        self.skew, self.calls = skew, []

    def pio_flash_attn_huge_workspace(self, B, L, H, D, kind, dtype):
        plan = PLAN(B, L, H, D, (torch.float32, torch.bfloat16)[dtype], kind)
        return plan["workspace_bytes"] + self.skew

    def _entry(self, *args):
        self.calls.append(args)
        return 0

    pio_flash_attn_huge_bwd_dkv = pio_flash_attn_huge_bwd_dq = _entry


@pytest.mark.parametrize("kind", [DQ, DKV])
def test_the_launch_sizes_the_workspace_from_the_plan(monkeypatch, kind):
    """``_attn_launch`` asks ``huge_bwd_plan`` for every huge backward
    launch before it builds anything (so a refused shape raises there),
    allocates the plan's workspace bytes, passes it to the entry point, and
    raises where the card's library sizes it otherwise."""
    asked, sized = [], []

    def spy(*args, **kw):
        asked.append(args)
        return PLAN(*args, **kw)

    def workspace(nbytes, device):
        sized.append(nbytes)
        return torch.empty(nbytes, dtype=torch.uint8, device=device)

    fake = _FakeLib()
    monkeypatch.setattr(kernels, "huge_bwd_plan", spy)
    monkeypatch.setattr(kernels, "build", lambda: fake)
    monkeypatch.setattr(kernels, "_workspace", workspace)
    monkeypatch.setattr(kernels, "_stream", lambda device: 0)
    name = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")[kind - 1]
    ptrs = [1] * (8 if kind == DKV else 7)
    before = dict(kernels.LAUNCHES)
    kernels._attn_launch(name, kind, ptrs, (2, 200, 3, 1152),
                         torch.bfloat16, True, None, torch.device("cpu"))
    assert asked == [(2, 200, 3, 1152, torch.bfloat16, kind, True)]
    want = PLAN(2, 200, 3, 1152, torch.bfloat16, kind)["workspace_bytes"]
    assert sized == [want] and want == 2 * 3 * 4 * 4 * TILE * TILE * (
        2 if kind == DKV else 1) * 2
    (call,) = fake.calls
    assert call[:len(ptrs)] == tuple(ptrs) and call[len(ptrs)]  # the ws
    assert call[len(ptrs) + 1:len(ptrs) + 7] == (2, 200, 3, 1152, 1, 1)
    assert kernels.LAUNCHES[name] == before[name] + 1
    huge = name.replace("flash_attention", "flash_attention_huge")
    assert kernels.LAUNCHES[huge] == before[huge] + 1
    monkeypatch.setattr(kernels, "build", lambda: _FakeLib(skew=16))
    with pytest.raises(ValueError, match="workspace"):
        kernels._attn_launch(name, kind, ptrs, (2, 200, 3, 1152),
                             torch.bfloat16, True, None, torch.device("cpu"))
    monkeypatch.setattr(kernels, "build", lambda: pytest.fail("built"))
    with pytest.raises(ValueError):  # one own tile above the cap
        kernels._attn_launch(name, kind, ptrs,
                             (1, 524_289 * (3 - kind), 1, 1152),
                             torch.float32, True, None, torch.device("cpu"))


@pytest.mark.parametrize("defect", ["drops", "doubles"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_band_boundary_off_by_one_tile_breaks_parity(dtype, defect):
    """dK/dV bands over key tiles [0, 2) and [2, 4); a boundary that skips
    key tile 2 leaves its dK and dV rows zero, one that gives it to both
    bands counts it twice: either fails the parity check the right bands
    pass."""
    B, L, H, D = 1, 200, 2, 1152
    arrs = _arrays(D + 29, B, L, H, D)
    want = _jax_grads(arrs, True, dtype)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    heads = range(B * H)
    right = {DKV: [(heads, range(0, 2)), (heads, range(2, 4))]}
    bad = {"drops": [(heads, range(0, 2)), (heads, range(3, 4))],
           "doubles": [(heads, range(0, 3)), (heads, range(2, 4))]}[defect]
    assert _worst(_mirror(*t, True, bands=right), want) <= GRAD_TOL[dtype]
    got = _mirror(*t, True, bands={DKV: bad})
    assert _worst(got, want) > GRAD_TOL[dtype]
    # dQ is untouched: the defect is in dK and dV alone
    assert float(np.abs(got[0].float().numpy() - want[0]).max()) <= \
        GRAD_TOL[dtype] * float(np.abs(want[0]).max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the huge backward kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _card_case(dev, B, L, H, D, dtype, causal):
    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(dev, tdt)
                   for a in _arrays(D + L, B, L, H, D))
    lse = torch.empty(B, H, L, device=dev)
    o = kernels.flash_attention_fwd(q, k, v, causal=causal, lse=lse)
    di = tra.attention_di(o, do)
    before = dict(kernels.LAUNCHES)
    runs = [(kernels.flash_attention_bwd_dq(q, k, v, do, lse, di,
                                            causal=causal),
             *kernels.flash_attention_bwd_dkv(q, k, v, do, lse, di,
                                              causal=causal))
            for _ in range(2)]
    torch.cuda.synchronize()
    for key in ("flash_attention_huge_bwd_dq",
                "flash_attention_huge_bwd_dkv"):
        assert kernels.LAUNCHES[key] - before[key] == 2
    want = tra.blockwise_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for got, again, w in zip(*runs, want):
        assert torch.equal(got, again)
        scale = float(w.float().abs().max())
        assert float((got.float() - w.float()).abs().max()) \
            <= GRAD_TOL[dtype] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [1152, 1536, 2048, 4096])
def test_huge_backward_on_the_card(cuda_device, D, causal, dtype):
    _card_case(cuda_device, 2, 257, 2, D, dtype, causal)


@pytest.mark.cuda
def test_huge_backward_in_two_bands_on_the_card(cuda_device):
    assert len(kernels.huge_bwd_plan(1, 8192, 1, 1152, torch.float32, DKV,
                                     True)["bands"]) >= 2
    _card_case(cuda_device, 1, 8192, 1, 1152, "float32", True)
