"""The wide attention backward (head dims 384 to 1,024) as thread-block
clusters over 128-feature slices: ``csrc/flash_attn_wide.cu``.

The kernels run only on the card. Here a torch mirror of their arithmetic
(``wide_backward``) stands in for them: one CTA per 128-feature slice and
one cluster per 64-row own tile (keys for dK/dV, query rows for dQ),
streamed 32 rows a tile; each slice's partial S and dP of a tile summed in
rank order 0, 1, ..., n - 1 (every CTA the same order, so every CTA holds
the same S and dP); P = exp2(S * s * log2(e) - lse * log2(e)) masked to
exact zeros and dS = (dP - di) * P * s from the unrounded P; for bf16
inputs P rounded to bf16 before dV and dS before dK and dQ; each CTA's
gradients over its own slice, the streamed tiles in increasing position.

- The mirror against ``jax.vjp`` of the JAX package's
  ``blockwise_attention`` (the reference answers these head dims with it,
  ``predictionio_tpu/parallel/ring_attention.py``), each gradient within
  ``GRAD_TOL`` of its largest magnitude (1e-4 for f32: the two sum in
  other orders; 2^-6 for bf16: P and dS rounded where autodiff of the bf16
  forward rounds elsewhere), at every wide head dim, causal and full, f32
  and bf16, at lengths ragged at both 32 and 64 (200, 257).
- The launch plan as ``ops/kernels.py::wide_bwd_plan`` computes it (and
  ``pio_flash_attn_wide_bwd_plan`` reports it on the card): the cluster
  size, the shared memory a CTA, the own tiles a grid holds, the heaviest
  tile first, the shapes and kinds refused, and the launch path asking it
  for both kernels; and the reduce-scatter's split of the exchanged tile's
  lines (32 in f32, 64 in bf16) among the cluster's CTAs.
- A planted defect: one CTA that sums the partials in another rank order
  holds other bits of dS than the rest of its cluster.
- On the card (``cuda`` marker, skipped here): the kernels against the
  plain version at every wide head dim, causal and full, both types,
  bitwise from run to run.
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
#: features a CTA, the own tile, the streamed tile, and the shared memory a
#: CTA may take on an H100
SLICE, OWN, STREAM, SMEM_MAX_BYTES = 128, 64, 32, 232_448
WIDE_DIMS = [384, 512, 640, 768, 896, 1024]
#: ops/kernels.py's kinds of backward launch
DQ, DKV = 1, 2
#: log2(e) as the kernels hold it (f32)
LOG2E = float(np.float32(1.4426950408889634))


def own_start(r: int, n: int, lines: int) -> int:
    """The first line of a ``lines``-line exchanged tile that rank ``r`` of
    an ``n``-CTA cluster sums (``csrc/attn_tiles.cuh::own_start``)."""
    return lines * r // n


def owner_of(line: int, n: int, lines: int) -> int:
    """The rank that sums ``line`` (``owner_of`` in the source)."""
    return ((line + 1) * n + lines - 1) // lines - 1


def _rank_sum(parts, order):
    """The partials of the slices summed in ``order``, left to right."""
    acc = parts[order[0]].clone()
    for r in order[1:]:
        acc = acc + parts[r]
    return acc


def wide_backward(q, k, v, do, lse, di, *, causal: bool,
                  scale: float | None = None, orders=None,
                  keep_ds: bool = False):
    """The kernels' arithmetic in torch on [B, L, H, D] tensors (f32 or
    bf16, D a multiple of 128) with the forward's ``lse`` and ``di =
    rowsum(do * o)`` ([B, H, L] f32): returns ``(dq, dk, dv, ds)`` in the
    input type, ``ds[c]`` with ``keep_ds`` the dK/dV kernel's dS^T tiles
    as CTA ``c`` holds them (each [B, H, 64, 32], own tiles in order, then
    streamed tiles in order). ``orders[c]`` is the rank order in which CTA
    ``c`` sums the partial S and dP (default: 0, 1, ..., n - 1 in every
    CTA)."""
    B, L, H, D = q.shape
    n, f32 = D // SLICE, torch.float32
    bf16 = q.dtype == torch.bfloat16
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    scale2 = float(np.float32(scale) * np.float32(LOG2E))
    orders = orders or [list(range(n))] * n
    groups = {}  # CTAs that sum in one order hold the same S and dP
    for c, order in enumerate(orders):
        groups.setdefault(tuple(order), []).append(c)
    Lp = -(-L // OWN) * OWN
    pad = Lp - L

    def slices(x):  # [B, H, Lp, n, 128], zero rows past L
        x = torch.nn.functional.pad(x.transpose(1, 2).to(f32),
                                    (0, 0, 0, pad))
        return x.reshape(B, H, Lp, n, SLICE)

    def rounded(x):  # an operand as the kernels round it
        return x.to(torch.bfloat16).to(f32) if bf16 else x

    def partials(x, y):  # each slice's x y^T: [n][B, H, rows x, rows y]
        return torch.einsum("bhird,bhjrd->rbhij", x, y)

    qs, ks, vs, dos = (slices(x) for x in (q, k, v, do))
    lse2 = torch.nn.functional.pad(lse, (0, pad)) * LOG2E
    dis = torch.nn.functional.pad(di, (0, pad))
    pos = torch.arange(Lp)
    dq, dk, dv = (torch.zeros(B, H, Lp, n, SLICE) for _ in range(3))
    kept = [[] for _ in range(n)]

    # dK/dV: a cluster owns 64 keys and streams 32-row query tiles
    for k0 in range(0, Lp, OWN):
        own = slice(k0, k0 + OWN)
        key = pos[own, None]
        for q0 in range(k0 if causal else 0, L, STREAM):
            st = slice(q0, q0 + STREAM)
            row = pos[None, st]
            seen = (row < L) & (key < L) & ((key <= row) if causal else True)
            ps, pdp = partials(ks[:, :, own], qs[:, :, st]), partials(
                vs[:, :, own], dos[:, :, st])
            for order, ctas in groups.items():
                s, dp = _rank_sum(ps, order), _rank_sum(pdp, order)
                p = torch.where(seen, torch.exp2(
                    s * scale2 - lse2[:, :, None, st]), 0.0)
                ds = (dp - dis[:, :, None, st]) * p * scale
                for c in ctas:
                    dv[:, :, own, c] += rounded(p) @ dos[:, :, st, c]
                    dk[:, :, own, c] += rounded(ds) @ qs[:, :, st, c]
                    if keep_ds:
                        kept[c].append(ds)
    # dQ: a cluster owns 64 query rows and streams 32-row key tiles
    for q0 in range(0, Lp, OWN):
        own = slice(q0, q0 + OWN)
        row = pos[own, None]
        for k0 in range(0, min(L, q0 + OWN) if causal else L, STREAM):
            st = slice(k0, k0 + STREAM)
            col = pos[None, st]
            seen = (row < L) & (col < L) & ((col <= row) if causal else True)
            ps, pdp = partials(qs[:, :, own], ks[:, :, st]), partials(
                dos[:, :, own], vs[:, :, st])
            for order, ctas in groups.items():
                s, dp = _rank_sum(ps, order), _rank_sum(pdp, order)
                p = torch.where(seen, torch.exp2(
                    s * scale2 - lse2[:, :, own, None]), 0.0)
                ds = (dp - dis[:, :, own, None]) * p * scale
                for c in ctas:
                    dq[:, :, own, c] += rounded(ds) @ ks[:, :, st, c]

    def back(x):
        return x.reshape(B, H, Lp, D)[:, :, :L].transpose(1, 2).to(q.dtype)

    return back(dq), back(dk), back(dv), kept if keep_ds else None


def _arrays(seed: int, B: int, L: int, H: int, D: int):
    """q, k, v and the output gradient, f32 numpy."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, L, H, D)) * 0.5).astype(np.float32)
            for _ in range(4)]


def _mirror(tq, tk, tv, tdo, causal: bool, **kw):
    """The mirror on the plain forward's logsumexp and di."""
    o, lse = tra.blockwise_attention(tq, tk, tv, causal=causal,
                                     return_lse=True)
    return wide_backward(tq, tk, tv, tdo, lse, tra.attention_di(o, tdo),
                         causal=causal, **kw)


@pytest.mark.parametrize("L", [200, 257])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_mirror_matches_jax_vjp(D, causal, dtype, L):
    arrs = _arrays(D + L + 3, 1, L, 2, D)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    # one compiled program for the forward and its vjp: a fraction of the
    # time of tracing the vjp op by op
    grads = jax.jit(lambda q, k, v, do: jax.vjp(
        lambda q, k, v: jra.blockwise_attention(q, k, v, causal=causal),
        q, k, v)[1](do))
    want = [np.asarray(g.astype(jnp.float32))
            for g in grads(*(jnp.asarray(a, jdt) for a in arrs))]
    got = _mirror(*(torch.from_numpy(a).to(tdt) for a in arrs), causal)[:3]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == (1, L, 2, D) and g.dtype == tdt, name
        scale = float(np.abs(w).max())
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= GRAD_TOL[dtype] * scale, (name, err, scale)


@pytest.mark.parametrize("kind", [DQ, DKV])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_launch_plan(D, dtype, kind):
    """One cluster of D / 128 CTAs (at most 8, the portable size) per
    (batch, head, 64-row own tile), within a CTA's shared memory."""
    B, L, H = 2, 2048, 4
    plan = kernels.wide_bwd_plan(B, L, H, D, dtype, kind)
    n = D // SLICE
    assert plan["cluster"] == n and 3 <= n <= 8
    assert plan["grid"] == (n * H, B, L // OWN)
    assert plan["threads"] == (256 if dtype == torch.float32 else 128)
    assert plan["stream_rows"] == STREAM
    assert plan["smem_bytes"] <= SMEM_MAX_BYTES
    dkv = kind == DKV
    if dtype == torch.float32:
        # the own slice's two tiles transposed (Kt, Vt or Qt, dOt) 69,632 B,
        # the three-stage ring 101,376, P and dS (dS alone for dQ) 8,704
        # each, lse and di of each stage 768 (dK/dV), the partial [32][64 S
        # + 64 dP] tile 16,896 and the 11 lines a CTA sums 5,808
        want = (2 * 128 * 68 + 3 * 2 * 32 * 132 + (2 if dkv else 1) * 32 * 68
                + (32 + 11) * 132) * 4 + (3 * 2 * 32 * 4 if dkv else 0)
        assert want == (211_888 if dkv else 202_416)
    else:
        # the own tiles and the ring row-major bf16, lse and di (dK/dV), the
        # partial [64][32 S + 32 dP] tile and the 22 lines a CTA sums
        want = ((2 * 64 + 3 * 2 * 32) * 136 * 2 + (64 + 22) * 72 * 4
                + (3 * 2 * 32 * 4 if dkv else 0))
        assert want == (112_576 if dkv else 111_808)
    assert plan["smem_bytes"] == want


def test_launch_plan_refuses_what_the_kernels_do_not_take():
    assert kernels.wide_bwd_plan(1, 65535 * OWN, 1, 512, torch.float32,
                                 DKV)["grid"][2] == 65535
    for shape, kind in (((1, 65535 * OWN + 1, 1, 512), DKV),
                        ((1, 8, 1, 256), DQ), ((1, 8, 1, 1152), DKV),
                        ((1, 8, 1, 448), DQ), ((0, 8, 1, 512), DKV),
                        ((1, 8, 65536, 512), DQ), ((1, 0, 1, 512), DKV),
                        ((1, 8, 1, 512), 0), ((1, 8, 1, 512), 3)):
        with pytest.raises(ValueError):
            kernels.wide_bwd_plan(*shape, torch.float32, kind)


@pytest.mark.parametrize("kind", [DQ, DKV])
@pytest.mark.parametrize("L", [1, 64, 200, 2048])
def test_launch_plan_runs_the_heaviest_tile_first(L, kind):
    """Grid z index i takes the own tile starting at ``tile_rows[i]``, every
    tile once; under a causal mask the streamed tiles a cluster walks never
    grow with i (dK/dV: its first key tiles first; dQ: its last query
    tiles first)."""
    plan = kernels.wide_bwd_plan(1, L, 1, 384, torch.float32, kind)
    rows = list(plan["tile_rows"])
    assert len(rows) == plan["grid"][2] == -(-L // OWN)
    assert sorted(rows) == list(range(0, L, OWN))
    if kind == DKV:
        walks = [-(-(L - k0) // STREAM) for k0 in rows]
    else:
        walks = [-(-min(L, q0 + OWN) // STREAM) for q0 in rows]
    assert walks == sorted(walks, reverse=True)
    assert rows == sorted(rows, reverse=kind == DQ)


@pytest.mark.parametrize("kind", [DQ, DKV])
def test_the_launch_asks_the_plan_for_both_kernels(monkeypatch, kind):
    """``_attn_launch`` asks ``wide_bwd_plan`` for every wide backward
    launch (before it builds anything), so a shape the kernels refuse
    raises there."""
    asked = []

    class Asked(Exception):
        pass

    def plan(*args):
        asked.append(args)
        raise Asked

    monkeypatch.setattr(kernels, "wide_bwd_plan", plan)
    name = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")[kind - 1]
    with pytest.raises(Asked):
        kernels._attn_launch(name, kind, [], (2, 200, 3, 640),
                             torch.bfloat16, True, None, torch.device("cpu"))
    assert asked == [(2, 200, 3, 640, torch.bfloat16, kind)]
    monkeypatch.undo()
    with pytest.raises(ValueError):
        kernels._attn_launch(name, kind, [], (1, 65535 * OWN + 1, 1, 512),
                             torch.float32, True, None, torch.device("cpu"))


@pytest.mark.parametrize("lines", [STREAM, OWN])
@pytest.mark.parametrize("n", range(3, 9))
def test_reduce_scatter_owns_each_line_once(n, lines):
    """f32 exchanges 32 lines (streamed rows), bf16 64 (own rows): each is
    summed by exactly one CTA, at most ceil(lines / 3) a CTA."""
    owned = [line for r in range(n)
             for line in range(own_start(r, n, lines),
                               own_start(r + 1, n, lines))]
    assert owned == list(range(lines))
    assert all(owner_of(line, n, lines) == r for r in range(n)
               for line in range(own_start(r, n, lines),
                                 own_start(r + 1, n, lines)))
    assert max(own_start(r + 1, n, lines) - own_start(r, n, lines)
               for r in range(n)) <= -(-lines // 3)


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_a_cta_summing_in_another_order_breaks_the_cluster(D):
    """Every CTA sums the partials in rank order, so every CTA holds the
    same bits of dS; a CTA that sums them in reverse holds other bits (f32
    addition is not associative), so its dK slice would follow another
    dS than its neighbours' slices."""
    arrs = _arrays(D + 5, 1, 200, 2, D)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    n = D // SLICE
    good = _mirror(q, k, v, do, True, keep_ds=True)[3]
    assert all(torch.equal(a, b) for ds in good[1:]
               for a, b in zip(good[0], ds))
    orders = [list(range(n))] * n
    orders[1] = list(reversed(range(n)))
    bad = _mirror(q, k, v, do, True, orders=orders, keep_ds=True)[3]
    assert all(torch.equal(a, b) for a, b in zip(bad[0], good[0]))
    assert not all(torch.equal(a, b) for a, b in zip(bad[1], bad[0]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the wide backward kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_wide_backward_on_the_card(cuda_device, D, causal, dtype):
    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, tdt)
                   for a in _arrays(D + 11, 2, 257, 2, D))
    lse = torch.empty(2, 2, 257, device=cuda_device)
    o = kernels.flash_attention_fwd(q, k, v, causal=causal, lse=lse)
    di = tra.attention_di(o, do)
    before = dict(kernels.LAUNCHES)
    runs = [(kernels.flash_attention_bwd_dq(q, k, v, do, lse, di,
                                            causal=causal),
             *kernels.flash_attention_bwd_dkv(q, k, v, do, lse, di,
                                              causal=causal))
            for _ in range(2)]
    torch.cuda.synchronize()
    for key in ("flash_attention_wide_bwd_dq", "flash_attention_wide_bwd_dkv"):
        assert kernels.LAUNCHES[key] - before[key] == 2
    want = tra.blockwise_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for got, again, w in zip(*runs, want):
        assert torch.equal(got, again)
        scale = float(w.float().abs().max())
        assert float((got.float() - w.float()).abs().max()) \
            <= GRAD_TOL[dtype] * scale
