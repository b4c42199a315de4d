"""The port's top-k at the edges of the kernel's stage-1 switch, against
the JAX package's.

``csrc/topk.cu`` scores a catalog in 256-row chunks and keeps each chunk's
best ``min(k_pad, 256)`` keys: by a warp selection when that is at most 32,
else by a bitonic sort. These cases put ``k_pad`` on both sides of 32,
``n_total`` on both sides of a chunk edge (255, 256, 257, 767) and the
batch on the query tiles 8, 16 and 32 (B 1, 9 and 17). On the CPU the
port runs its plain version; each case holds it against
``predictionio_tpu.ops.retrieval.topk_scores`` on the same numpy inputs,
through the XLA path and, for a subset, the Pallas kernel in interpret mode.
Values agree within rtol 1e-5 / atol 1e-5 (the two sum in different
orders) and every returned id scores what the JAX result holds at its rank;
on integer-valued factors (exact sums) the results are bitwise equal. The
``cuda``-marked case holds the kernel against its plain version on a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from predictionio_tpu.ops import retrieval as jret  # noqa: E402
from predictionio_tpu_torch.ops import kernels  # noqa: E402
from predictionio_tpu_torch.ops import retrieval as tret  # noqa: E402

RTOL = ATOL = 1e-5
KS = (8, 16, 24, 32, 40)
N_TOTALS = (255, 256, 257, 767)
BATCHES = (1, 9, 17)


def _assert_close(q, items, got, want):
    """Values within tolerance, and every returned id scores (on the host)
    what the JAX result says its rank holds."""
    (gv, gi), (wv, _wi) = got, want
    np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL)
    scores = np.atleast_2d(q) @ items.T
    at = np.take_along_axis(scores, np.atleast_2d(gi).astype(np.int64), 1)
    np.testing.assert_allclose(at, np.atleast_2d(wv), rtol=RTOL, atol=ATOL)


def _case(seed: int, B: int, N: int, k: int, interpret):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 20)).astype(np.float32)
    items = rng.standard_normal((N, 20)).astype(np.float32)
    got = tret.topk_scores(q, items, k, device="cpu")
    want = jret.topk_scores(q, items, k, interpret=interpret)
    assert got[0].shape == want[0].shape == (B, k)
    _assert_close(q, items, got, want)
    assert (got[1] >= 0).all() and (got[1] < N).all()


#: every (batch, n_total, k)
XLA_CASES = [(b, n, k) for b in BATCHES for n in N_TOTALS for k in KS]

#: a subset through the Pallas kernel in interpret mode: each k, n_total
#: and batch at least once
KERNEL_CASES = [(1, 255, 8), (9, 256, 16), (17, 257, 24), (1, 767, 32),
                (9, 255, 40), (17, 767, 40), (17, 256, 32), (9, 257, 32)]


@pytest.mark.parametrize("B,N,k", XLA_CASES)
def test_matches_jax_xla(B, N, k):
    _case(B * 1000 + N * 10 + k, B, N, k, None)


@pytest.mark.parametrize("B,N,k", KERNEL_CASES)
def test_matches_jax_kernel(B, N, k):
    _case(B * 1000 + N * 10 + k, B, N, k, True)


@pytest.mark.parametrize("interpret", [True, None],
                         ids=["jax-kernel", "jax-xla"])
def test_ties_across_a_chunk_edge_bitwise(interpret):
    """Integer-valued factors sum exactly in any order, so the result is
    the tie-break contract alone. Rows 200-299 repeat at 400-499 and rows
    240-271 again at 500-531, so equal scores straddle the chunk edge at
    row 256 and sit in three chunks; a zero query ties all 532 rows. At k
    32, the selection's upper edge, and 40, past it: lax.top_k's order,
    score descending, then id ascending, bit for bit."""
    rng = np.random.default_rng(32)
    base = rng.integers(-2, 3, (400, 12)).astype(np.float32)
    items = np.concatenate([base, base[200:300], base[240:272]], axis=0)
    q = rng.integers(-2, 3, (17, 12)).astype(np.float32)
    q[0] = 0.0
    for k in (32, 40):
        got = tret.topk_scores(q, items, k, device="cpu")
        want = jret.topk_scores(q, items, k, interpret=interpret)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[1][0], np.arange(k))  # zero query: id order


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_at_the_switch(cuda_device):
    """The kernel on both sides of the stage-1 switch (k_pad 32: the warp
    selection; 40: the bitonic sort), both entry points, a query tile of
    32 and n_total off a chunk edge, against its plain version."""
    dev = cuda_device
    rng = np.random.default_rng(40)
    items_np, _ = tret._pad_items(
        rng.standard_normal((1100, 64)).astype(np.float32), 1100, 512)
    items = torch.from_numpy(items_np).to(dev)
    q = torch.from_numpy(rng.standard_normal((32, 128)).astype(np.float32))
    q = q.to(dev)
    rows = torch.tensor(list(range(0, 64, 2)), dtype=torch.int32, device=dev)
    rows[3] = -1
    for k_pad in (32, 40):
        for out, ref in (
                (kernels.topk(q, items, 1029, k_pad),
                 tret.topk_reference(q, items, 1029, k_pad)),
                (kernels.topk_rows(rows, q, items, 1029, k_pad),
                 tret.topk_rows_reference(rows, q, items, 1029, k_pad))):
            v, i = tret._unpack(out, 32, k_pad, k_pad)
            np.testing.assert_allclose(v, ref[0].cpu().numpy(), rtol=RTOL,
                                       atol=ATOL)
            assert (i < 1029).all()
