"""The port's top-k past the warp selection (k_pad > 32), against the JAX
package's, and numpy models of the kernel's warp sort and merge rounds.

``csrc/topk.cu`` keeps each 256-row catalog chunk's best ``min(k_pad,
256)`` keys and merges the chunk lists in rounds. For k_pad > 32 stage 1
is ``topk_sort``, a bitonic sort of each query's 256 keys across a warp;
above k_pad 256 a chunk keeps all its keys and the merge sorts the
catalog. The parity cases put k on both sides of 256 (33, 64, 248, 256,
257, 1000), n_total from one chunk to 28 (255, 256, 257, 2049, 6913: odd
list counts and a short last chunk) and the batch on every query tile (B
1, 9, 17, 33, 129). On the CPU the port runs its plain version; each case
holds it against ``predictionio_tpu.ops.retrieval.topk_scores`` on the same
numpy inputs, through the XLA path and, for a subset, the Pallas kernel in
interpret mode: values within rtol 1e-5 / atol 1e-5 (the two sum in
different orders), every returned id scoring what the JAX result holds at
its rank, and bitwise equal on integer-valued factors (exact sums).

The models are the kernel's executable spec. ``warp_sort256`` replays
``warp_sort256_desc``'s compare-exchange schedule over the lanes' registers;
``merge_rounds`` replays ``launch_merge`` under ``merge_plan`` (the
host's S rule), every key placed at its rank in its own list plus its
count of greater keys in the partner list, and is held against a full
sort. The ``cuda``-marked case holds the kernel bitwise against its plain
version on a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from predictionio_tpu.ops import retrieval as jret  # noqa: E402
from predictionio_tpu_torch.ops import kernels  # noqa: E402
from predictionio_tpu_torch.ops import retrieval as tret  # noqa: E402

RTOL = ATOL = 1e-5
KS = (33, 64, 248, 256, 257, 1000)
N_TOTALS = (255, 256, 257, 2049, 6913)
BATCHES = (1, 9, 17, 33, 129)
CHUNK = 256


def _case(seed: int, B: int, N: int, k: int, interpret):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 20)).astype(np.float32)
    items = rng.standard_normal((N, 20)).astype(np.float32)
    (gv, gi) = tret.topk_scores(q, items, k, device="cpu")
    (wv, _wi) = jret.topk_scores(q, items, k, interpret=interpret)
    assert gv.shape == wv.shape == (B, min(k, N))
    np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL)
    at = np.take_along_axis(q @ items.T, gi.astype(np.int64), 1)
    np.testing.assert_allclose(at, wv, rtol=RTOL, atol=ATOL)
    assert (gi >= 0).all() and (gi < N).all()


#: every k against every n_total, the batch cycling through the query tiles
XLA_CASES = [(BATCHES[(i + j) % len(BATCHES)], n, k)
             for i, k in enumerate(KS) for j, n in enumerate(N_TOTALS)]

#: a subset through the Pallas kernel in interpret mode: each k, n_total
#: and batch at least once
KERNEL_CASES = [(1, 255, 33), (9, 256, 64), (17, 257, 248), (33, 2049, 256),
                (129, 2049, 257), (9, 6913, 1000), (17, 6913, 64),
                (1, 2049, 1000)]


@pytest.mark.parametrize("B,N,k", XLA_CASES)
def test_matches_jax_xla(B, N, k):
    _case(B * 10_000 + N * 10 + k, B, N, k, None)


@pytest.mark.parametrize("B,N,k", KERNEL_CASES)
def test_matches_jax_kernel(B, N, k):
    _case(B * 10_000 + N * 10 + k, B, N, k, True)


@pytest.mark.parametrize("interpret", [True, None],
                         ids=["jax-kernel", "jax-xla"])
def test_ties_across_chunk_edges_bitwise(interpret):
    """Integer-valued factors sum exactly in any order, so the result is
    the tie-break contract alone. Rows 200-599 repeat at 600-999 and rows
    250-265 again at 1000-1015, so equal scores straddle the chunk edges at
    256 and 768 and sit in up to three of the four chunks; a zero query
    ties all 1,016 rows. At k 33, 64, 256 (every key of a chunk) and 257:
    lax.top_k's order, score descending, then id ascending, bit for bit."""
    rng = np.random.default_rng(33)
    base = rng.integers(-2, 3, (600, 12)).astype(np.float32)
    items = np.concatenate([base, base[200:600], base[250:266]], axis=0)
    q = rng.integers(-2, 3, (9, 12)).astype(np.float32)
    q[0] = 0.0
    for k in (33, 64, 256, 257):
        got = tret.topk_scores(q, items, k, device="cpu")
        want = jret.topk_scores(q, items, k, interpret=interpret)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[1][0], np.arange(k))  # zero query: id order


# -- the warp sort -------------------------------------------------------


def warp_sort256(keys: np.ndarray) -> np.ndarray:
    """``warp_sort256_desc`` on 256 unique keys: position 8*lane + j is
    lane ``lane``'s register j. Each lane first sorts its 8 (``sort8_desc``);
    then blocks of 8m positions merge into 16m: the flip pairs lane L's
    register j with lane L ^ (2m - 1)'s register 7 - j, the half-cleaners
    lane L with L ^ s (s = m/2 .. 1), then registers j ^ 4, ^ 2, ^ 1; the
    lane whose bit m (or s) is set keeps the smaller key."""
    k = np.sort(keys.reshape(32, 8), axis=1)[:, ::-1].copy()
    lanes = np.arange(32)
    m = 1
    while m < 32:
        part = k[lanes ^ (2 * m - 1)][:, ::-1]
        upper = (lanes & m) != 0
        k = np.where(upper[:, None], np.minimum(k, part), np.maximum(k, part))
        s = m >> 1
        while s:
            part = k[lanes ^ s]
            up = (lanes & s) != 0
            k = np.where(up[:, None], np.minimum(k, part),
                         np.maximum(k, part))
            s >>= 1
        for st in (4, 2, 1):
            for j in range(8):
                if j & st == 0:
                    hi = np.maximum(k[:, j], k[:, j + st])
                    lo = np.minimum(k[:, j], k[:, j + st])
                    k[:, j], k[:, j + st] = hi, lo
        m <<= 1
    return k.reshape(256)


def _keys(rng, n: int) -> np.ndarray:
    """n unique keys > 0 (the kernel's real keys are > 0: ~id >= 1)."""
    return rng.choice(np.uint64(1) << np.uint64(62), n,
                      replace=False).astype(np.uint64) + np.uint64(1)


@pytest.mark.parametrize("order", ["random", "ascending", "descending",
                                   "lane-major", "interleaved", "two-runs"])
def test_warp_sort_model_sorts(order):
    """The schedule sorts any 256 unique keys descending, whatever order
    the scores arrive in across the lanes."""
    rng = np.random.default_rng(len(order))
    keys = np.sort(_keys(rng, 256))
    arranged = {"random": rng.permutation(keys), "ascending": keys,
                "descending": keys[::-1],
                "lane-major": keys.reshape(8, 32).T.reshape(256),
                "interleaved": np.concatenate([keys[0::2], keys[1::2]]),
                "two-runs": np.concatenate([keys[128:], keys[:128]])}[order]
    assert np.array_equal(warp_sort256(arranged), keys[::-1])


def stage_slot(p):
    """``topk.cu::stage_slot``: the staging word of sorted position p."""
    return p ^ ((p >> 3) & 7)


def test_staging_slots_turn_the_sort_around():
    """``topk_sort`` writes lane l's sorted positions 8l .. 8l+7 to its
    warp's staging row and reads positions 32i + l back for coalesced
    stores: the slots are a permutation of the row, every read touches 16
    distinct bank pairs a half-warp (8-byte words, two banks each), and
    no write puts more than two lanes of a half-warp on one bank pair."""
    p = np.arange(256)
    assert sorted(stage_slot(p)) == list(p)
    lanes = np.arange(32)
    for i in range(8):
        words = stage_slot(32 * i + lanes)
        for half in (words[:16], words[16:]):
            assert len(set(half % 16)) == 16
    for j in range(8):
        words = stage_slot(8 * lanes + j)
        for half in (words[:16], words[16:]):
            assert np.bincount(half % 16, minlength=16).max() <= 2


# -- the merge rounds ------------------------------------------------------


#: ``csrc/topk.cu``'s kMergeTarget, kMergeSmemMax and kMaxGroups: a merge
#: CTA's aimed-for and largest shared memory in bytes, and the largest
#: grid.y
MERGE_TARGET, MERGE_SMEM_MAX, MAX_GROUPS = 64 << 10, 192 << 10, 65535


def merge_plan(b_pad: int, n_items: int, k_pad: int,
               n_sm: int = 132) -> list[dict]:
    """The merge rounds of one ``topk`` call on a card of ``n_sm`` SMs (an
    H100's), as ``csrc/topk.cu::launch_merge`` and ``merge_group`` plan
    them (keep the two equal), one launch each: per round the lists a CTA
    merges (``group``), the CTAs a row (``n_groups``), the input lists'
    stride, the chunks each covers (``span``) and whether the group runs
    in shared memory. A round's group is every list left once
    they fit 192 KB (in the first round only if ``b_pad`` is at least 3/4
    of ``n_sm``); else as many as fit 64 KB, in the first round no more
    than leave one CTA an SM, at least 2, and enough that ``n_groups``
    fits a grid. Two lists that do not fit 192 KB merge from the
    workspace."""

    def group_of(n_lists: int, stride: int, first: bool) -> int:
        per_list = 2 * stride * 8
        filled = not first or 4 * b_pad >= 3 * n_sm
        if filled and n_lists * per_list <= MERGE_SMEM_MAX:
            return n_lists
        g = MERGE_TARGET // per_list
        if not filled:
            g = min(g, n_lists // -(-n_sm // b_pad))
        return min(max(g, -(-n_lists // MAX_GROUPS), 2), n_lists)

    n_lists = -(-n_items // CHUNK)
    stride = min(k_pad, CHUNK)
    span, rounds = 1, []
    while True:
        group = group_of(n_lists, stride, not rounds)
        smem = 2 * group * stride * 8
        in_smem = smem <= MERGE_SMEM_MAX
        if not in_smem:
            group = min(n_lists, 2)
        n_groups = -(-n_lists // group)
        rounds.append({"group": group, "n_groups": n_groups,
                       "stride": stride, "span": span, "in_smem": in_smem})
        if n_groups == 1:
            return rounds
        n_lists, span, stride = n_groups, span * group, min(group * stride,
                                                            k_pad)


def list_len(li: int, span: int, chunks: int, kc: int, k_pad: int) -> int:
    """``topk.cu::list_len``."""
    return min(min(span, chunks - li * span) * kc, k_pad)


def count_greater(desc: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Keys of the descending list ``desc`` greater than each of ``keys``."""
    return len(desc) - np.searchsorted(desc[::-1], keys, side="right")


def merge_rounds(lists: np.ndarray, b_pad: int, k_pad: int,
                 n_items: int) -> np.ndarray:
    """``launch_merge`` on one row of stage-1 lists ``[n_chunks, kc]``
    (each sorted descending) under ``merge_plan``; returns the row's
    ``k_pad`` result keys. Holds every write inside the row and the CTA's
    shared memory (half of it for each ping-pong buffer), on a slot
    nothing else wrote, and every list a group hands on sorted, of its
    length and free of unwritten slots."""
    n_chunks, kc = lists.shape
    row_len = n_chunks * kc
    src = lists.reshape(row_len).copy()
    for rnd in merge_plan(b_pad, n_items, k_pad):
        group, n_groups = rnd["group"], rnd["n_groups"]
        stride, span = rnd["stride"], rnd["span"]
        out_stride = min(group * stride, k_pad)
        cap = group * stride
        dst = np.zeros(row_len, np.uint64)
        for g in range(n_groups):
            chunks = min(group * span, n_chunks - g * group * span)
            n = -(-chunks // span)
            base = g * group * stride
            # full lists, then the last one's keys: all inside the row
            size = (n - 1) * stride + list_len(n - 1, span, chunks, kc, k_pad)
            assert base + size <= row_len and size <= cap
            s = np.zeros(cap, np.uint64)
            s[:size] = src[base:base + size]
            st, sp = stride, span
            while n > 1:
                o_st = min(2 * st, k_pad)
                t = np.zeros(cap, np.uint64)
                for li in range(n):
                    mine = s[li * st:li * st + list_len(li, sp, chunks, kc,
                                                        k_pad)]
                    pos = np.arange(len(mine))
                    if li ^ 1 < n:
                        other = li ^ 1
                        pos = pos + count_greater(
                            s[other * st:other * st + list_len(
                                other, sp, chunks, kc, k_pad)], mine)
                    keep = pos < o_st
                    at = (li >> 1) * o_st + pos[keep]
                    assert (at < cap).all() and (t[at] == 0).all()
                    t[at] = mine[keep]
                s, n, st, sp = t, (n + 1) >> 1, o_st, sp * 2
            length = list_len(0, chunks, chunks, kc, k_pad)
            merged = s[:length]
            assert (merged > 0).all() and (merged[:-1] > merged[1:]).all()
            if n_groups == 1:
                assert length == k_pad
                return merged
            at = g * out_stride
            assert at + length <= row_len and (dst[at:at + length] == 0).all()
            dst[at:at + length] = merged
        src = dst
    raise AssertionError("the plan never reached one group")


#: (n_items, k_pad, b_pad): one chunk, odd list counts, short last chunks,
#: kc 256 with k_pad on both sides of it, the serving buckets, the
#: unfilled and filled first rounds, lists that leave shared memory
MODEL_CASES = [(200, 40, 8), (256, 33, 8), (512, 8, 8), (2049, 24, 8),
               (2049, 64, 128), (6913, 33, 8), (6913, 248, 16),
               (6913, 256, 32), (6913, 257, 64), (6913, 1000, 8),
               (27136, 24, 8), (27136, 16, 128), (27136, 64, 128),
               (27136, 104, 8), (27136, 256, 128), (27136, 264, 8),
               (27136, 1000, 128), (27136, 1000, 8), (27136, 6913, 8),
               (27136, 10000, 8), (65536, 16, 8), (100_000, 40, 16)]


@pytest.mark.parametrize("n_items,k_pad,b_pad", MODEL_CASES)
def test_merge_model_matches_full_sort(n_items, k_pad, b_pad):
    """Stage 1's lists (each chunk's 256 keys, its best kc sorted) merged
    in the planned rounds give the row's best k_pad keys of the full sort,
    with every list length and tail as the kernel computes them."""
    rng = np.random.default_rng(n_items + k_pad + b_pad)
    n_chunks = -(-n_items // CHUNK)
    kc = min(k_pad, CHUNK)
    keys = _keys(rng, n_chunks * CHUNK)
    lists = np.sort(keys.reshape(n_chunks, CHUNK), axis=1)[:, ::-1][:, :kc]
    got = merge_rounds(np.ascontiguousarray(lists), b_pad, k_pad, n_items)
    assert np.array_equal(got, np.sort(keys)[::-1][:k_pad])


#: the shapes of chip_smoke.py's phase 2 and scripts/topk_ab.py
#: (b_pad, n_items, k_pad): the ML-20M catalog, one chunk, the 5-row and
#: 1,000-row catalogs, and the unpacked catalog past 2^24 rows (phase 2's
#: k 7000 fixture is test_plan_merges_long_lists_from_the_workspace's)
SMOKE_SHAPES = ([(b, 27136, k) for b in (8, 16, 32, 64, 128)
                 for k in (16, 24, 40, 64, 104, 256, 264, 1000)]
                + [(8, 256, 40), (8, 512, 5), (8, 1024, 16), (32, 2560, 32),
                   (8, 16_778_240, 16), (16, 1536, 200)])


@pytest.mark.parametrize("b_pad,n_items,k_pad", [
    pytest.param(*s, id=f"b{s[0]}-n{s[1]}-k{s[2]}") for s in SMOKE_SHAPES])
def test_plan_at_smoke_shapes(b_pad, n_items, k_pad):
    """At every shape the card runs: at most three rounds, each group in
    shared memory within 192 KB (64 KB where more than one group a row
    runs, unless the lists left fit one last group), the grid within
    bounds, and a first round of at least one CTA an SM wherever the rows
    alone leave more than a quarter of the 132 SMs idle and the lists
    allow it."""
    plan = merge_plan(b_pad, n_items, k_pad)
    assert 1 <= len(plan) <= 3
    n_lists = -(-n_items // CHUNK)
    for i, rnd in enumerate(plan):
        smem = 2 * rnd["group"] * rnd["stride"] * 8
        assert rnd["in_smem"] and smem <= 192 << 10
        assert rnd["n_groups"] == -(-n_lists // rnd["group"]) <= 65535
        if rnd["n_groups"] > 1:
            assert smem <= 64 << 10 or rnd["group"] == 2
        n_lists = rnd["n_groups"]
    first = plan[0]
    if 4 * b_pad < 3 * 132 and first["group"] > 2:
        assert first["n_groups"] * b_pad >= 132
    assert plan[-1]["n_groups"] == 1


def test_plan_merges_long_lists_from_the_workspace():
    """chip_smoke.py's k 7000 fixture (b_pad 8, ML-20M): lists grow past
    6,144 keys, two of which no longer fit 192 KB, so the last two rounds
    merge pairs from the workspace."""
    plan = merge_plan(8, 27136, 7000)
    assert [(r["group"], r["in_smem"]) for r in plan] == [
        (6, True), (2, True), (2, True), (2, True), (2, False), (2, False)]


def test_plan_spreads_the_serving_bucket():
    """The 8-row serving bucket at the ML-20M catalog: 18 groups of 6
    lists a row (144 CTAs), then one group of 18, against one CTA a row
    in a single CTA's seven levels before."""
    plan = merge_plan(8, 27136, 24)
    assert [(r["group"], r["n_groups"]) for r in plan] == [(6, 18), (18, 1)]


#: (b_pad, n_items, k_pad) -> each round's (group, n_groups), one launch a
#: round (what ``kernels.LAUNCHES["topk_merge"]`` counts): one round where
#: the rows fill the card and the lists fit one group; two at the 8-row
#: buckets (num 20 and num 100) and where kc is 256; three at b_pad 8,
#: k_pad 1000 (lists of 1,000 keys, four to a 64 KB group); 257 groups a
#: row on the unpacked catalog; one list on a one-chunk catalog
ROUNDS = {(8, 27136, 16): [(6, 18), (18, 1)],
          (8, 27136, 104): [(6, 18), (18, 1)],
          (128, 27136, 16): [(106, 1)],
          (128, 27136, 64): [(106, 1)],
          (128, 27136, 256): [(16, 7), (7, 1)],
          (128, 27136, 1000): [(16, 7), (7, 1)],
          (8, 27136, 264): [(6, 18), (18, 1)],
          (8, 27136, 1000): [(6, 18), (4, 5), (5, 1)],
          (8, 7168, 1000): [(2, 14), (14, 1)],
          (8, 16_778_240, 16): [(256, 257), (257, 1)],
          (8, 256, 40): [(1, 1)]}


@pytest.mark.parametrize("shape,rounds", list(ROUNDS.items()),
                         ids=[f"b{b}-n{n}-k{k}" for b, n, k in ROUNDS])
def test_plan_rounds(shape, rounds):
    plan = merge_plan(*shape)
    assert [(r["group"], r["n_groups"]) for r in plan] == rounds
    assert all(r["in_smem"] for r in plan)


# -- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_bitwise(cuda_device):
    """The kernel at k_pad 40, 256, 264 and 1000 (topk_sort, kc 256 on
    both sides of 256, two merge rounds), both entry points, query tiles
    of 8 and 32, n_total off a chunk edge and a one-chunk catalog, against
    its plain version bit for bit: integer-valued factors sum exactly in
    any order. Each call counts one topk_sort launch and one merge launch
    a round of ``merge_plan``."""
    dev = cuda_device
    rng = np.random.default_rng(41)
    for n_total, b in ((6913, 8), (6913, 32), (200, 8)):
        items_np, _ = tret._pad_items(
            rng.integers(-3, 4, (n_total, 40)).astype(np.float32), n_total,
            512)
        items = torch.from_numpy(items_np).to(dev)
        qtab = torch.from_numpy(rng.integers(-3, 4, (2 * b, 128)).astype(
            np.float32)).to(dev)
        q = qtab[:b].contiguous()
        rows = torch.arange(0, 2 * b, 2, dtype=torch.int32, device=dev)
        rows[1] = -1
        for k_pad in (40, 256, 264, 1000):
            k_pad = min(k_pad, n_total)
            before = dict(kernels.LAUNCHES)
            outs = (kernels.topk(q, items, n_total, k_pad),
                    kernels.topk_rows(rows, qtab, items, n_total, k_pad))
            moved = {key: kernels.LAUNCHES[key] - before[key]
                     for key in ("topk_select", "topk_sort", "topk_merge")}
            rounds = len(merge_plan(b, items.shape[0], k_pad))
            assert moved == {"topk_select": 0, "topk_sort": 2,
                             "topk_merge": 2 * rounds}
            for out, ref in zip(outs, (
                    tret.topk_reference(q, items, n_total, k_pad),
                    tret.topk_rows_reference(rows, qtab, items, n_total,
                                             k_pad))):
                v, i = tret._unpack(out, b, k_pad, k_pad)
                assert np.array_equal(v, ref[0].cpu().numpy())
                assert np.array_equal(i, ref[1].cpu().numpy())
