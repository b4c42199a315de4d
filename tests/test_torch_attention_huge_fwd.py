"""The huge attention forward (head dims above 1,024) as a score pass, a
softmax pass and the dQ product pass over 128-feature slices:
``csrc/flash_attn_huge.cu``.

The kernels run only on the card. Here a torch mirror of their arithmetic
(``huge_forward``) stands in for them. The score pass forms S of every
visible 64 x 64 tile pair over D, in chunks of 32 (f32) or 64 (bf16)
features in increasing order, and keeps it raw in f32, -inf where the mask
hides a pair. The softmax pass takes each query row over its visible key
tiles: m = max S * s * log2(e), l = sum exp2(S * s * log2(e) - m), lse = m
ln(2) + log(l), then P = exp2(S * s * log2(e) - lse * log2(e)) (the
backward's expression), rounded to bf16 for bf16 inputs. The product pass
sums, per 64-row query tile and 128-feature slice, P V over the visible
key tiles in increasing position, band by band as
``kernels.huge_fwd_plan`` splits the query tiles so the workspace stays
within its cap.

- The mirror against the JAX package's ``blockwise_attention`` (the
  reference answers these head dims with it) run on the CPU through
  ``jax.jit``: the output within ``ATTN_TOL`` (``chip_smoke.py``'s: 1e-5
  f32, 2^-7 bf16) and the logsumexp within 1e-5 of ``jax.nn.logsumexp``
  of the JAX side's scaled, masked scores, at D 1,152 and 2,048, causal
  and full, f32 and bf16, at lengths ragged at 64 (200, 257); and bitwise
  the same when a small cap splits it into bands.
- The launch plan as ``ops/kernels.py::huge_fwd_plan`` computes it (and
  ``pio_flash_attn_huge_fwd_plan`` reports it on the card): band width and
  count, workspace bytes within the cap, the three passes' grids, threads
  and shared memory at the timed shape; every visible tile pair in exactly
  one band from L 1 to 12,345 and with (batch, head)s split across bands;
  the shapes refused; the heaviest query tile first; and the launch path
  sizing the workspace from the plan.
- Planted defects: a softmax that skips the last visible key tile, and a
  band boundary that drops or doubles one query tile, each fail the parity
  check.
- On the card (``cuda`` marker, skipped here): the kernels against the
  plain version at D 1,152, 1,536, 2,048 and 4,096, causal and full, both
  types, bitwise from run to run and with and without the logsumexp, and
  at B1 L8192 H1 D1152 causal bf16 in two bands.
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

#: the output against the plain version (chip_smoke.py's ATTN_TOL: f32 sums
#: in another order; bf16 two bf16 steps at |o| ~ 1), and the logsumexp
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}
LSE_TOL = 1e-5
#: rows of a score tile, features of a product slice, the workspace cap,
#: query rows of a softmax CTA, and the shared memory a CTA may take on an
#: H100
TILE, SLICE, CAP, SOFTMAX_ROWS, SMEM_MAX_BYTES = 64, 128, 256 << 20, 8, 232_448
HUGE_DIMS = [1152, 2048]
#: log2(e) and ln(2) as the kernels hold them (f32)
LOG2E = float(np.float32(1.4426950408889634))
LN2 = float(np.float32(0.6931471805599453))
#: the plan itself, for stand-ins while a test spies on it
PLAN = kernels.huge_fwd_plan


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The mirror runs many small products, where torch's thread pool only
    adds overhead (25x here): one thread for this file's tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seen(causal: bool, t: int, nt: int) -> range:
    """The key tiles query tile ``t`` sees, in increasing position."""
    return range(t + 1) if causal else range(nt)


def _bytes_an_own_tile(L: int, dtype) -> int:
    """Workspace of one query tile of one (batch, head): its key tiles' f32
    S, and for bf16 their P."""
    return -(-L // TILE) * TILE * TILE * (4 if dtype == torch.float32 else 6)


def huge_forward(q, k, v, *, causal: bool, scale: float | None = None,
                 bands=None, skip_last: bool = False):
    """The kernels' arithmetic in torch on [B, L, H, D] tensors (f32 or
    bf16, D a multiple of 128 above 1,024): returns ``(o, lse)``, o in the
    input type and lse [B, H, L] f32. ``bands`` (a list of ((batch, head)s,
    query tiles)) replaces the plan's; each band's sums are added to the
    output, so a tile in two bands counts twice and a tile in none stays
    zero. ``skip_last`` leaves each row's last visible key tile out of its
    softmax and product where it sees another (a planted defect)."""
    B, L, H, D = q.shape
    f32, bf16 = torch.float32, q.dtype == torch.bfloat16
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    c = float(np.float32(scale) * np.float32(LOG2E))
    chunk = 64 if bf16 else 32
    nt = -(-L // TILE)
    Lp, pad = nt * TILE, nt * TILE - L

    def rows(x):  # [B * H, Lp, D] f32, zero rows past L
        x = torch.nn.functional.pad(x.transpose(1, 2).to(f32),
                                    (0, 0, 0, pad))
        return x.reshape(B * H, Lp, D)

    qs, ks, vs = (rows(x) for x in (q, k, v))
    # the score pass: raw S [query][key] over D, chunks in order, -inf where
    # the mask hides the pair
    s = torch.zeros(B * H, Lp, Lp)
    for c0 in range(0, D, chunk):
        cs = slice(c0, c0 + chunk)
        s += qs[..., cs] @ ks[..., cs].transpose(-1, -2)
    pos = torch.arange(Lp)
    seen = (pos[:, None] < L) & (pos[None, :] < L)
    if causal:
        seen &= pos[None, :] <= pos[:, None]
    s = torch.where(seen, s, -math.inf)

    # the softmax and the product pass, band by band, a (batch, head) and
    # a query tile at a time (torch's bits for a batched call may depend on
    # how much it batches); every 128-feature slice's columns are sums over
    # the key tiles independent of the other slices, so one product takes
    # all slices at once
    o = torch.zeros(B * H, Lp, D)
    lse = torch.zeros(B * H, Lp)
    plan_bands = bands or [(band["heads"], band["tiles"]) for band in
                           kernels.huge_fwd_plan(B, L, H, D, q.dtype,
                                                 causal)["bands"]]
    for heads, tiles in plan_bands:
        for hh in heads:
            for t in tiles:
                own = slice(t * TILE, (t + 1) * TILE)
                keys = list(_seen(causal, t, nt))
                if skip_last and len(keys) > 1:
                    keys = keys[:-1]
                st = torch.cat([s[hh, own, j * TILE:(j + 1) * TILE]
                                for j in keys], -1)
                x = st * c
                m = x.amax(-1, keepdim=True)
                row_lse = m[:, 0] * LN2 + torch.log(
                    torch.exp2(x - m).sum(-1))
                p = torch.exp2(st * c - (row_lse * LOG2E)[:, None])
                # padded rows: P zero, as the kernel writes it
                valid = (t * TILE + torch.arange(TILE)) < L
                p = torch.where(valid[:, None], p, 0.0)
                if bf16:
                    p = p.to(torch.bfloat16).to(f32)
                acc = torch.zeros(TILE, D)
                for n, j in enumerate(keys):  # increasing position
                    acc += p[:, n * TILE:(n + 1) * TILE] @ vs[
                        hh, j * TILE:(j + 1) * TILE]
                o[hh, own] += acc
                lse[hh, own] += torch.where(valid, row_lse, 0.0)
    o = o.reshape(B, H, Lp, D)[:, :, :L].transpose(1, 2).to(q.dtype)
    return o, lse.reshape(B, H, Lp)[..., :L]


def _arrays(seed: int, B: int, L: int, H: int, D: int):
    """q, k and v, f32 numpy."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, L, H, D)) * 0.5).astype(np.float32)
            for _ in range(3)]


def _jax_forward(arrs, causal: bool, dtype: str):
    """The JAX package's ``blockwise_attention`` and ``jax.nn.logsumexp``
    of its scaled, masked f32 scores of the same (rounded) inputs, one
    compiled program, as f32 numpy."""
    jdt = getattr(jnp, dtype)

    def fwd(q, k, v):
        B, L, H, D = q.shape
        s = jnp.einsum("bqhd,bkhd->bhqk", q.astype(jnp.float32),
                       k.astype(jnp.float32)) / math.sqrt(D)
        if causal:
            s = jnp.where(jnp.tril(jnp.ones((L, L), bool)), s, -jnp.inf)
        return (jra.blockwise_attention(q, k, v, causal=causal),
                jax.nn.logsumexp(s, axis=-1))

    o, lse = jax.jit(fwd)(*(jnp.asarray(a, jdt) for a in arrs))
    return np.asarray(o.astype(jnp.float32)), np.asarray(lse)


def _holds(got, want, dtype: str) -> bool:
    tol = ATTN_TOL[dtype]
    return np.allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("L", [200, 257])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", HUGE_DIMS)
def test_mirror_matches_jax(D, causal, dtype, L):
    arrs = _arrays(D + L + 5, 1, L, 2, D)
    tdt = getattr(torch, dtype)
    want_o, want_lse = _jax_forward(arrs, causal, dtype)
    o, lse = huge_forward(*(torch.from_numpy(a).to(tdt) for a in arrs),
                          causal=causal)
    assert o.shape == (1, L, 2, D) and o.dtype == tdt
    assert lse.shape == (1, 2, L) and lse.dtype == torch.float32
    err = float(np.abs(o.float().numpy() - want_o).max())
    assert _holds(o, want_o, dtype), err
    assert np.allclose(lse.numpy(), want_lse, rtol=LSE_TOL, atol=LSE_TOL), \
        float(np.abs(lse.numpy() - want_lse).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_bands_leave_the_output_unchanged(monkeypatch, causal, dtype):
    """Every output row is complete in one band, so a cap that splits the
    query tiles into several bands (and the (batch, head)s across bands)
    gives the same bits as one band."""
    B, L, H, D = 2, 257, 2, 1152
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _arrays(D + 19, B, L, H, D))
    one = huge_forward(q, k, v, causal=causal)
    assert len(kernels.huge_fwd_plan(B, L, H, D, dtype, causal)[
        "bands"]) == 1
    cap = 2 * _bytes_an_own_tile(L, dtype)
    monkeypatch.setattr(kernels, "HUGE_WS_CAP", cap)
    plan = kernels.huge_fwd_plan(B, L, H, D, dtype, causal)
    assert plan["band_heads"] == 2 and plan["band_tiles"] == 1
    assert len(plan["bands"]) == 2 * 5 and plan["workspace_bytes"] <= cap
    split = huge_forward(q, k, v, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(one, split))


@pytest.mark.parametrize("dtype,esize,ws", [(torch.float32, 4, 8 << 20),
                                            (torch.bfloat16, 2, 12 << 20)])
def test_timed_shape_plan(dtype, esize, ws):
    """B1 L1024 H2 D4096: one band of all 16 query tiles of both heads (8
    MiB of f32 S, and 4 MiB more of bf16 P); a score CTA of 128 threads per
    visible tile pair (136 a head causal, 256 full), a softmax CTA per 8
    query rows (8 a tile), a product CTA per (slice, head, query tile): 32
    x 2 x 16 = 1,024."""
    B, L, H, D = 1, 1024, 2, 4096
    for causal, pairs in ((True, 136), (False, 256)):
        plan = kernels.huge_fwd_plan(B, L, H, D, dtype, causal)
        assert (plan["band_tiles"], plan["band_heads"],
                len(plan["bands"])) == (16, 2, 1)
        assert plan["workspace_bytes"] == ws == 2 * 16 * _bytes_an_own_tile(
            L, dtype)
        assert plan["score"]["grid"] == (pairs, 2, 1)
        assert plan["softmax"]["grid"] == (128, 2, 1)
        assert plan["product"]["grid"] == (32, 2, 16)
        assert [plan[p]["threads"] for p in ("score", "softmax",
                                             "product")] == [128, 256, 128]
        # score: two stages of the Q and K row tiles, rows of 128 bytes of
        # features padded by 16 (36 KiB, three CTAs an SM); product: dQ's,
        # two stages of the P tile [64][64 + pad] and the V slice
        # [64][128 + pad]
        assert plan["score"]["smem_bytes"] == 2 * 2 * 64 * 144 == 36_864
        assert plan["softmax"]["smem_bytes"] == 0
        pad = 16 // esize
        assert plan["product"]["smem_bytes"] == (
            2 * 64 * (64 + pad + 128 + pad) * esize)
        assert plan["product"] == kernels.huge_bwd_plan(
            B, L, H, D, dtype, 1, causal)["product"]
        assert 3 * plan["score"]["smem_bytes"] <= SMEM_MAX_BYTES
        assert plan["product"]["smem_bytes"] <= SMEM_MAX_BYTES


def _cover(plan, B, L, H, causal):
    """Every (batch, head, query tile) in exactly one band, and each band's
    grids its visible pairs, its softmax row groups and its tiles."""
    nt = -(-L // TILE)
    hits = np.zeros((B * H, nt), np.int64)
    for band in plan["bands"]:
        heads, tiles = band["heads"], band["tiles"]
        assert band["score_grid"] == (
            sum(len(_seen(causal, t, nt)) for t in tiles), len(heads), 1)
        assert band["softmax_grid"] == (
            TILE // SOFTMAX_ROWS * len(tiles), len(heads), 1)
        assert band["product_grid"][1:] == (len(heads), len(tiles))
        hits[heads.start:heads.stop, min(tiles):max(tiles) + 1] += 1
        assert len(tiles) <= plan["band_tiles"]
        assert len(heads) <= plan["band_heads"]
    assert (hits == 1).all()
    return hits


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 64, 1024, 8192, 12_345])
def test_every_visible_pair_in_one_band(L, dtype, causal):
    B, H, D = 1, 1, 1152
    plan = kernels.huge_fwd_plan(B, L, H, D, dtype, causal)
    nt = -(-L // TILE)
    col = _bytes_an_own_tile(L, dtype)
    assert col <= plan["workspace_bytes"] <= CAP
    assert plan["band_tiles"] == min(nt, CAP // col)
    assert len(plan["bands"]) == -(-nt // plan["band_tiles"])
    _cover(plan, B, L, H, causal)
    # the pairs themselves, band by band
    pairs = [(t, o) for band in plan["bands"] for t in band["tiles"]
             for o in _seen(causal, t, nt)]
    assert len(pairs) == len(set(pairs)) == sum(
        len(_seen(causal, t, nt)) for t in range(nt))
    if L == 8192:  # bf16: 128 tiles of 3 MiB, 85 a band; f32 2 MiB, all
        assert len(plan["bands"]) == (2 if dtype == torch.bfloat16 else 1)
    if L == 12_345:
        assert len(plan["bands"]) >= 3


def test_heads_split_across_bands():
    """Where one query tile of every (batch, head) is above the cap, a band
    takes one query tile of as many (batch, head)s as fit."""
    B, L, H, D = 20, 8192, 10, 1152
    for dtype in (torch.float32, torch.bfloat16):
        plan = kernels.huge_fwd_plan(B, L, H, D, dtype)
        col = _bytes_an_own_tile(L, dtype)
        assert plan["band_tiles"] == 1 and plan["band_heads"] == CAP // col
        assert plan["workspace_bytes"] == CAP // col * col
        assert len(plan["bands"]) == -(-200 // plan["band_heads"]) * 128
        _cover(plan, B, L, H, True)


def test_plan_refuses_what_the_kernels_do_not_take():
    ok = kernels.huge_fwd_plan(1, 1_048_576, 1, 1152, torch.float32)
    assert ok["workspace_bytes"] == CAP and ok["band_tiles"] == 1
    assert kernels.huge_fwd_plan(1, 699_008, 1, 1152, torch.bfloat16)[
        "band_tiles"] == 1
    for shape, dtype in (
            ((1, 1_048_577, 1, 1152), torch.float32),  # one tile > cap
            ((1, 699_009, 1, 1152), torch.bfloat16),
            ((1, 8, 1, 1024), torch.float32),  # the wide kernels'
            ((1, 8, 1, 1100), torch.float32),
            ((0, 8, 1, 1152), torch.float32),
            ((1, 8, 65536, 1152), torch.float32),
            ((1, 0, 1, 1152), torch.float32),
            ((1, 8, 1, 1152), torch.float16)):
        with pytest.raises(ValueError):
            kernels.huge_fwd_plan(*shape, dtype)
    with pytest.raises(ValueError, match=f"above the cap of {CAP} bytes"):
        kernels.huge_fwd_plan(1, 1_048_577, 1, 1152, torch.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("L", [1, 200, 1024, 12_345])
def test_heaviest_query_tile_first(L, causal):
    """In launch order (bands, then each band's query tiles as the product
    grid's z and the softmax grid's x take them) the key tiles a query tile
    walks never grow: the last query tile first."""
    plan = kernels.huge_fwd_plan(1, L, 1, 1152, torch.float32, causal)
    nt = -(-L // TILE)
    order = [t for band in plan["bands"] for t in band["tiles"]]
    assert order == list(range(nt - 1, -1, -1))
    walks = [len(_seen(causal, t, nt)) for t in order]
    assert walks == sorted(walks, reverse=True)


class _FakeLib:
    """Stand-in for the kernel library: the workspace it reports (the
    plan's, or off by ``skew``) and the entry point's arguments."""

    def __init__(self, skew: int = 0):
        self.skew, self.calls = skew, []

    def pio_flash_attn_huge_workspace(self, B, L, H, D, kind, dtype):
        assert kind == 0
        plan = PLAN(B, L, H, D, (torch.float32, torch.bfloat16)[dtype])
        return plan["workspace_bytes"] + self.skew

    def pio_flash_attn_huge_fwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("causal", [True, False])
def test_the_launch_sizes_the_workspace_from_the_plan(monkeypatch, causal):
    """``_attn_launch`` asks ``huge_fwd_plan`` for every huge forward
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
    monkeypatch.setattr(kernels, "huge_fwd_plan", spy)
    monkeypatch.setattr(kernels, "build", lambda: fake)
    monkeypatch.setattr(kernels, "_workspace", workspace)
    monkeypatch.setattr(kernels, "_stream", lambda device: 0)
    ptrs = [1, 2, 3, 4, None]
    before = dict(kernels.LAUNCHES)
    kernels._attn_launch("flash_attention", 0, ptrs, (2, 200, 3, 1152),
                         torch.bfloat16, causal, None, torch.device("cpu"))
    assert asked == [(2, 200, 3, 1152, torch.bfloat16, causal)]
    want = PLAN(2, 200, 3, 1152, torch.bfloat16)["workspace_bytes"]
    assert sized == [want] and want == 2 * 3 * 4 * 4 * TILE * TILE * 6
    (call,) = fake.calls
    assert call[:5] == tuple(ptrs) and call[5]  # the workspace
    assert call[6:12] == (2, 200, 3, 1152, 1, int(causal))
    for key in ("flash_attention", "flash_attention_huge"):
        assert kernels.LAUNCHES[key] == before[key] + 1
    monkeypatch.setattr(kernels, "build", lambda: _FakeLib(skew=16))
    with pytest.raises(ValueError, match="workspace"):
        kernels._attn_launch("flash_attention", 0, ptrs, (2, 200, 3, 1152),
                             torch.bfloat16, causal, None,
                             torch.device("cpu"))
    monkeypatch.setattr(kernels, "build", lambda: pytest.fail("built"))
    with pytest.raises(ValueError, match="cap"):  # one own tile above it
        kernels._attn_launch("flash_attention", 0, ptrs,
                             (1, 1_048_577, 1, 1152), torch.float32, causal,
                             None, torch.device("cpu"))


@pytest.mark.parametrize("defect", ["skips the last key tile",
                                    "drops a query tile",
                                    "doubles a query tile"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_planted_defect_breaks_parity(dtype, defect):
    """Query tiles in bands [0, 2) and [2, 4): the right bands hold; a
    softmax that leaves each row's last visible key tile out (the diagonal
    tile under a causal mask), a boundary that skips query tile 2 (its
    output rows stay zero) or one that gives it to both bands (counted
    twice) fails the check."""
    B, L, H, D = 1, 200, 2, 1152
    arrs = _arrays(D + 31, B, L, H, D)
    want, _ = _jax_forward(arrs, True, dtype)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    heads = range(B * H)
    right = [(heads, range(0, 2)), (heads, range(2, 4))]
    assert _holds(huge_forward(*t, causal=True, bands=right)[0], want, dtype)
    if defect == "skips the last key tile":
        got = huge_forward(*t, causal=True, skip_last=True)[0]
        assert not _holds(got, want, dtype)
        # the first query tile sees no other key tile and stays right
        assert _holds(got[:, :TILE], want[:, :TILE], dtype)
    else:
        bad = {"drops a query tile": [(heads, range(0, 2)),
                                      (heads, range(3, 4))],
               "doubles a query tile": [(heads, range(0, 3)),
                                        (heads, range(2, 4))]}[defect]
        got = huge_forward(*t, causal=True, bands=bad)[0]
        assert not _holds(got, want, dtype)
        # the rows of the other query tiles are untouched
        rows = np.r_[0:2 * TILE, 3 * TILE:L]
        assert _holds(got[:, rows], want[:, rows], dtype)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the huge forward's kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _card_case(dev, B, L, H, D, dtype, causal):
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dev, tdt)
               for a in _arrays(D + L, B, L, H, D))
    lse = torch.empty(B, H, L, device=dev)
    before = kernels.LAUNCHES["flash_attention_huge"]
    runs = [kernels.flash_attention_fwd(q, k, v, causal=causal)
            for _ in range(2)]
    with_lse = kernels.flash_attention_fwd(q, k, v, causal=causal, lse=lse)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_huge"] - before == 3
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], with_lse)
    want, want_lse = tra.blockwise_attention(q, k, v, causal=causal,
                                             return_lse=True)
    tol = ATTN_TOL[dtype]
    assert torch.allclose(runs[0].float(), want.float(), rtol=tol, atol=tol)
    assert torch.allclose(lse, want_lse, rtol=LSE_TOL, atol=LSE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [1152, 1536, 2048, 4096])
def test_huge_forward_on_the_card(cuda_device, D, causal, dtype):
    _card_case(cuda_device, 2, 257, 2, D, dtype, causal)


@pytest.mark.cuda
def test_huge_forward_in_two_bands_on_the_card(cuda_device):
    assert len(kernels.huge_fwd_plan(1, 8192, 1, 1152, torch.bfloat16,
                                     True)["bands"]) == 2
    _card_case(cuda_device, 1, 8192, 1, 1152, "bfloat16", True)
