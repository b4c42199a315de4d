"""The wide attention forward (head dims 384 to 1,024) as a thread-block
cluster over 128-feature slices: ``csrc/flash_attn_wide_fwd.cu``.

The kernel runs only on the card. Here a torch mirror of its arithmetic
(``wide_forward``) stands in for it: one CTA per 128-feature slice, each
slice's partial scores of a 64-key tile summed in rank order 0, 1, ...,
n - 1 (every CTA the same order, so every CTA holds the same scores), the
online softmax in log2 units (the running max of S * s * log2(e), P =
exp2(S * s * log2(e) - m), the sum and the accumulator rescaled by exp2 of
the change in m), P rounded to bf16 before P V for bf16 inputs, each CTA's
accumulator over its own slice of V, and the logsumexp m ln(2) + log(l).

- The mirror against the JAX package's ``blockwise_attention`` (the
  reference answers these head dims with it, on the CPU as its own tests
  run it) within ``ATTN_TOL`` (1e-5 for f32: the two sum in other orders;
  2^-7 for bf16: a P rounding an f32 difference tips), at every wide head
  dim, causal and full, f32 and bf16, at ragged lengths (200, 257); and its
  logsumexp against the port's plain version's within 1e-5.
- The launch plan as ``ops/kernels.py::wide_fwd_plan`` computes it (and
  ``pio_flash_attn_wide_fwd_plan`` reports it on the card): the cluster
  size, the shared memory a CTA, the query tiles a grid holds, the
  heaviest tile first; and the reduce-scatter's split of the score tile's
  64 lines among the cluster's CTAs (``own_start`` / ``owner_of``).
- A planted defect: one CTA that sums the partials in another rank order
  holds other bits of P than the rest of its cluster.
- On the card (``cuda`` marker, skipped here): the kernel against the
  plain version at every wide head dim, causal and full, both types,
  bitwise from run to run and with or without the logsumexp buffer.
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

#: the output against the reference's (chip_smoke.py's ATTN_TOL), and the
#: logsumexp against the plain version's
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}
LSE_TOL = 1e-5
#: features a CTA, the score tile (query rows x keys), and the shared
#: memory a CTA may take on an H100
SLICE, TILE, SMEM_MAX_BYTES = 128, 64, 232_448
WIDE_DIMS = [384, 512, 640, 768, 896, 1024]
#: log2(e) and ln(2) as the kernel holds them (f32)
LOG2E = float(np.float32(1.4426950408889634))
LN2 = float(np.float32(0.6931471805599453))


def own_start(r: int, n: int) -> int:
    """The first line of the score tile rank ``r`` of an ``n``-CTA cluster
    sums (``csrc/flash_attn_wide_fwd.cu::own_start``)."""
    return TILE * r // n


def owner_of(line: int, n: int) -> int:
    """The rank that sums ``line`` (``owner_of`` in the source)."""
    return ((line + 1) * n + TILE - 1) // TILE - 1


def wide_forward(q, k, v, *, causal: bool, scale: float | None = None,
                 orders=None, keep_p: bool = False):
    """The kernel's arithmetic in torch on [B, L, H, D] tensors (f32 or
    bf16, D a multiple of 128): returns ``(o, lse, probs)``, ``o`` in the
    input type, ``lse`` [B, H, L] f32 from rank 0, and with ``keep_p`` each
    CTA's P of every key tile (``probs[c]``: [B, H, L, tiles * 64]).
    ``orders[c]`` is the rank order in which CTA ``c`` sums the partial
    scores (default: 0, 1, ..., n - 1 in every CTA)."""
    B, L, H, D = q.shape
    n, f32 = D // SLICE, torch.float32
    bf16 = q.dtype == torch.bfloat16
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    scale2 = float(np.float32(scale) * np.float32(LOG2E))
    orders = orders or [list(range(n))] * n
    qt, kt, vt = (x.transpose(1, 2).to(f32) for x in (q, k, v))
    tiles = -(-L // TILE)
    pad = tiles * TILE - L
    kt, vt = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (kt, vt))
    row = torch.arange(L)[:, None]
    m = [torch.full((B, H, L), -math.inf) for _ in range(n)]
    lsum = [torch.zeros(B, H, L) for _ in range(n)]
    acc = [torch.zeros(B, H, L, SLICE) for _ in range(n)]
    probs = [[] for _ in range(n)]
    for t in range(tiles):
        ks, vs = (x[:, :, t * TILE:(t + 1) * TILE] for x in (kt, vt))
        part = [qt[..., r * SLICE:(r + 1) * SLICE]
                @ ks[..., r * SLICE:(r + 1) * SLICE].transpose(-1, -2)
                for r in range(n)]
        col = t * TILE + torch.arange(TILE)[None, :]
        seen = (col < L) & ((col <= row) if causal else True)
        for c in range(n):
            s = part[orders[c][0]].clone()
            for r in orders[c][1:]:
                s = s + part[r]
            s = torch.where(seen, s, -math.inf)
            m_new = torch.maximum(m[c], s.amax(-1) * scale2)
            m2 = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.where(m[c] == m2, 1.0, torch.exp2(m[c] - m2))
            p = torch.exp2(s * scale2 - m2[..., None])
            lsum[c] = lsum[c] * alpha + p.sum(-1)
            pv = p.to(torch.bfloat16).to(f32) if bf16 else p
            acc[c] = (acc[c] * alpha[..., None]
                      + pv @ vs[..., c * SLICE:(c + 1) * SLICE])
            m[c] = m_new
            if keep_p:
                probs[c].append(p)
    o = torch.cat([a / torch.clamp(lt, min=1e-20)[..., None]
                   for a, lt in zip(acc, lsum)], -1)
    lse = m[0] * LN2 + torch.log(lsum[0])
    probs = [torch.cat(ps, -1) for ps in probs] if keep_p else None
    return o.transpose(1, 2).to(q.dtype), lse, probs


def _arrays(seed: int, B: int, L: int, H: int, D: int, n: int = 3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, L, H, D)) * 0.5).astype(np.float32)
            for _ in range(n)]


def _as(arrs, dtype: str):
    """The same values as torch and jax arrays of ``dtype`` (both round to
    bf16 to nearest even)."""
    tdt = getattr(torch, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a).astype(jdt) for a in arrs])


@pytest.mark.parametrize("L", [200, 257])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_mirror_matches_jax_blockwise(D, causal, dtype, L):
    (tq, tk, tv), (jq, jk, jv) = _as(_arrays(D + L, 1, L, 2, D), dtype)
    got, _, _ = wide_forward(tq, tk, tv, causal=causal)
    want = jra.blockwise_attention(jq, jk, jv, causal=causal)
    assert got.shape == (1, L, 2, D) and got.dtype == tq.dtype
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    tol = ATTN_TOL[dtype]
    assert torch.allclose(got.float(), want, rtol=tol, atol=tol), \
        float((got.float() - want).abs().max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_mirror_logsumexp_matches_the_plain_version(D, causal):
    q, k, v = (torch.from_numpy(a) for a in _arrays(D, 2, 200, 2, D))
    o, lse, _ = wide_forward(q, k, v, causal=causal)
    po, plse = tra.blockwise_attention(q, k, v, causal=causal,
                                       return_lse=True)
    assert lse.shape == (2, 2, 200)
    assert float((lse - plse).abs().max()) <= LSE_TOL
    assert torch.allclose(o, po, rtol=ATTN_TOL["float32"],
                          atol=ATTN_TOL["float32"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_launch_plan(D, dtype):
    """One cluster of D / 128 CTAs (at most 8, the portable size) per
    (batch, head, 64-row tile), within a CTA's shared memory."""
    B, L, H = 2, 2048, 4
    plan = kernels.wide_fwd_plan(B, L, H, D, dtype)
    n = D // SLICE
    assert plan["cluster"] == n and 3 <= n <= 8
    assert plan["grid"] == (n * H, B, L // TILE)
    assert plan["grid"][0] % plan["cluster"] == 0
    assert plan["threads"] == (256 if dtype == torch.float32 else 128)
    assert plan["smem_bytes"] <= SMEM_MAX_BYTES
    # f32: Q^T 34.8 KB, the K/V ring 135.2 KB, P 17.4 KB, the partial
    # score tile 17.4 KB and the owned sums (22 lines) 6.0 KB
    want = (128 * 68 + 4 * 64 * 132 + 64 * 68 + (64 + 22) * 68) * 4 \
        if dtype == torch.float32 \
        else (64 + 4 * 64) * 136 * 2 + (64 + 22) * 72 * 4
    assert plan["smem_bytes"] == want


def test_launch_plan_refuses_what_the_kernel_does_not_take():
    assert kernels.wide_fwd_plan(1, 65535 * TILE, 1, 512,
                                 torch.float32)["grid"][2] == 65535
    for shape in ((1, 65535 * TILE + 1, 1, 512), (1, 8, 1, 256),
                  (1, 8, 1, 1152), (1, 8, 1, 448), (0, 8, 1, 512),
                  (1, 8, 65536, 512)):
        with pytest.raises(ValueError):
            kernels.wide_fwd_plan(*shape, torch.float32)


@pytest.mark.parametrize("L", [1, 64, 200, 2048])
def test_launch_plan_runs_the_heaviest_tile_first(L):
    """Grid z index i takes the query tile starting at ``tile_rows[i]``:
    the last tile first, every tile once; under a causal mask the key
    tiles a cluster walks never grow with i."""
    plan = kernels.wide_fwd_plan(1, L, 1, 384, torch.float32)
    rows = list(plan["tile_rows"])
    assert len(rows) == plan["grid"][2] == -(-L // TILE)
    assert sorted(rows) == list(range(0, L, TILE))
    assert rows == sorted(rows, reverse=True)
    walks = [-(-min(L, q0 + TILE) // TILE) for q0 in rows]
    assert walks == sorted(walks, reverse=True)


@pytest.mark.parametrize("n", range(3, 9))
def test_reduce_scatter_owns_each_line_once(n):
    owned = [line for r in range(n)
             for line in range(own_start(r, n), own_start(r + 1, n))]
    assert owned == list(range(TILE))
    assert all(owner_of(line, n) == r for r in range(n)
               for line in range(own_start(r, n), own_start(r + 1, n)))
    assert max(own_start(r + 1, n) - own_start(r, n)
               for r in range(n)) <= -(-TILE // 3)


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_a_cta_summing_in_another_order_breaks_the_cluster(D):
    """Every CTA sums the partials in rank order, so every CTA holds the
    same bits of P; a CTA that sums them in reverse holds other bits (f32
    addition is not associative), and its output slice follows other
    weights than the logsumexp its cluster writes."""
    q, k, v = (torch.from_numpy(a) for a in _arrays(D + 5, 1, 200, 2, D))
    n = D // SLICE
    _, _, good = wide_forward(q, k, v, causal=True, keep_p=True)
    assert all(torch.equal(good[0], p) for p in good[1:])
    orders = [list(range(n))] * n
    orders[1] = list(reversed(range(n)))
    _, _, bad = wide_forward(q, k, v, causal=True, orders=orders,
                             keep_p=True)
    assert torch.equal(bad[0], good[0])
    assert not torch.equal(bad[1], bad[0])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the wide forward kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_wide_forward_on_the_card(cuda_device, D, causal, dtype):
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda_device, tdt)
               for a in _arrays(D + 7, 2, 257, 2, D))
    before = kernels.LAUNCHES["flash_attention_wide"]
    out = kernels.flash_attention_fwd(q, k, v, causal=causal)
    lse = torch.empty(2, 2, 257, device=cuda_device)
    again = kernels.flash_attention_fwd(q, k, v, causal=causal, lse=lse)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_wide"] - before == 2
    assert torch.equal(out, again)
    want, wlse = tra.blockwise_attention(q, k, v, causal=causal,
                                         return_lse=True)
    tol = ATTN_TOL[dtype]
    assert torch.allclose(out.float(), want.float(), rtol=tol, atol=tol)
    assert float((lse - wlse).abs().max()) <= LSE_TOL
