"""Chip smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Runs on one CUDA card and exits non-zero on any failure (and at once when
no card is visible). It imports nothing of JAX or of ``predictionio_tpu``.

1. Device: the card's name, ``nvidia-smi``'s name and power limit, and the
   time to build the kernels (``predictionio_tpu_torch/csrc/topk.cu`` and
   ``csrc/flash_attn.cu``, one ``nvcc`` each, in parallel) from the
   checkout's sources.
2. Kernel vs plain on the card: ``topk`` and ``topk_rows`` against their
   plain PyTorch versions (``topk_reference`` / ``topk_rows_reference``) on
   the ML-20M catalog (27,136 x 128 padded f32) for B in {1, 8, 64, 128}
   and k in {10, 64, 1000}, a 5-row catalog, a tie fixture (bitwise), the
   gather variant with unknown rows, and one unpacked case past 2^24 rows
   (an 8.6 GB catalog). Values agree within rtol 1e-5 / atol 1e-5 (the two
   sum in different orders) and every returned id's plain score equals the
   plain value at its rank; median times of the kernel, the plain version
   and ``torch.topk(q @ items.T, k)``.
3. Serving: an ML-20M-shaped ALS model (138,493 x 64 users, 26,744 x 64
   items, seeded random factors / sqrt(64)) deployed through the port's
   template, ``Deployed`` (prewarm on) and ``EngineServer``, behind
   ``serve()`` on 127.0.0.1; 16 sequential HTTP queries, then 256 sent at
   once by 64 client threads in 4 client processes (num in {1, 4, 10, 20},
   a few unknown users), each answer equal to a host numpy exact top-k;
   the kernel's launch counter moves with the batches; wall p50/p99, qps,
   and the device's busy share over a second, profiled burst.

4. Attention kernel vs plain on the card: ``flash_attention``
   (``csrc/flash_attn.cu``) against ``blockwise_attention`` at the seqrec
   attention shapes (B4 L4096 H8 D64 causal, bf16 and f32; B1 L16384 H8
   D64 causal bf16), the serving shapes of phase 5 (B8 and B128, L4096 H8
   D64 causal f32), the shipped template's head dim (B8 L64 H2 D24), D128
   L128, and an unaligned L25, causal and not. Max |err| within 1e-5 for
   f32 (summation order) and 2**-7 for bf16 (two bf16 steps at |o| ~ 1);
   median device times of the kernel, the plain version (run in batch
   chunks so its [B, H, L, block] scores fit) and, as a yardstick the port
   never calls, ``scaled_dot_product_attention``.
5. SeqRec serving: the ML-20M catalog (26,744 items) under a seqrec model
   at embed 512, 8 heads (head dim 64), 2 blocks, max_len 4096, weights
   from a seeded generator at flax's init scales, and 20,000 users with
   left-padded histories of 1 to 4096 items, deployed through the port's
   seqrec template, ``Deployed`` (prewarm on) and ``EngineServer`` behind
   ``serve()``; 8 sequential queries, then 64 at once from 4 client
   processes (num in {1, 4, 10, 20}, a few unknown users); every answer
   equal to the plain path's (the same module with attention through
   ``blockwise_attention``, then the same host top-k); the attention
   kernel launched once per block per forward; wall p50/p99, qps,
   queries per batch and the device's busy share. Then the shipped
   template configuration (embed 48, 2 heads, max_len 64) through
   ``batch_recommend`` once, against its plain path.

6. Seqrec training. (a) The backward kernels (``csrc/flash_attn_bwd.cu``:
   ``flash_attention_bwd_dkv`` and ``flash_attention_bwd_dq``) and the
   forward that writes the logsumexp against ``blockwise_attention_bwd`` /
   ``blockwise_attention`` at the phase-4 shapes (B8 L4096 H8 D64 causal
   f32 is also the training shape below), the template training shapes
   (head dims 24 and 16) and the kernels' tile edges (L 129 and 200 at
   D 40, L 257 at D 120, L 1 at D 8; f32 and bf16): each gradient within
   1e-4 (f32) or 2**-6 (bf16) of its largest magnitude (at L 1, where dq
   and dk are zero up to rounding, of dv's), the logsumexp within 1e-5, the
   output within phase 4's tolerance and bitwise equal to the serving
   forward's (which writes no logsumexp); at the training shape and at B4
   L4096 bf16 each kernel runs twice and its gradients must be bitwise
   equal (no atomics, a fixed summation order); median device times
   of each kernel, the plain backward (in batch chunks) and, as a yardstick
   the port never calls, the backward of ``scaled_dot_product_attention``.
   (b) Full-width training steps: the phase-5 model (embed 512, 8 heads, 2
   blocks, the ML-20M catalog) at max_len 4097, so the attention sees L
   4096, on 8 users per step from ``seq_histories``: one step through the
   kernels against the same step through ``blockwise_attention`` under
   autograd (in row chunks) from the same weights, the loss within 1e-5
   relative and every gradient leaf within 2**-3 of its largest magnitude,
   and the same comparison with the Dense layers in f32 (nothing rounded to
   bf16) with every leaf within 2**-5; in both, each attention call's dq,
   dk and dv within 1e-4 of blockwise_attention_bwd on that call's inputs,
   and a second plain step (512-key blocks) reported as the leaves' noise
   floor; then 2 warm-up and 8 timed Adam steps on that batch: step ms,
   real target tokens per second, device ms by kernel over one profiled
   step, peak device memory, the loss at each step (finite, falling), and
   one launch of each attention kernel per block per step. (c) The cyclic
   fixture of ``tests/test_parallel_seq.py`` trained through the port's
   ``Engine.train`` and seqrec template on the card, then served: u0's
   next item is i0.

The ALS path (phase 3), the seqrec serving path (phase 5) and the seqrec
training path (phase 6 b and c) are each driven with every launch count set
to 0 just before and read just after. Before the last line it prints one
JSON object with a record per kernel entry point (launches on its main
path, error, times and bound); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

from predictionio_tpu_torch.controller import (DataSource, EngineParams,
                                               FirstServing, TrainResult)
from predictionio_tpu_torch.convert import (als_model_from_numpy,
                                            seqrec_model_from_numpy)
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.models.seq_attention import (
    Dense, SeqRec, SeqRecConfig, SeqRecModel, init_params, seq_rec_loss)
from predictionio_tpu_torch.obs.metrics import METRICS
from predictionio_tpu_torch.ops import kernels
from predictionio_tpu_torch.ops.pipeline import _capacity
from predictionio_tpu_torch.ops.retrieval import (
    PACKED_IDX_LIMIT, _pad_items, _query_shapes, topk_reference,
    topk_rows_reference)
from predictionio_tpu_torch.parallel.ring_attention import (
    attention_di, blockwise_attention, blockwise_attention_bwd,
    flash_attention)
from predictionio_tpu_torch.templates.recommendation.engine import (
    ALSAlgorithm, AlgorithmParams, engine_factory)
from predictionio_tpu_torch.templates.seqrec import engine as seqrec_engine
from predictionio_tpu_torch.workflow.context import Context
from predictionio_tpu_torch.workflow.create_server import EngineServer, serve

SEED = 20
RTOL = ATOL = 1e-5
# ML-20M (bench.py's headline shape): users x items at rank 64
N_USERS, N_ITEMS, RANK = 138_493, 26_744, 64
# H100 SXM data-sheet peaks: HBM bytes/s, f32 (non-tensor-core) FLOP/s and
# dense bf16 tensor-core FLOP/s
PEAK_BYTES_S, PEAK_F32_FLOP_S, PEAK_BF16_FLOP_S = 3.35e12, 67e12, 989e12
KERNEL_SOURCE = "predictionio_tpu_torch/csrc/topk.cu"
REPLACES = "predictionio_tpu/ops/retrieval.py:196"
FLASH_SOURCE = "predictionio_tpu_torch/csrc/flash_attn.cu"
# jax's stock Pallas TPU kernel that predictionio_tpu/parallel/
# ring_attention.py:207 calls (jax 0.9.0; its pl.pallas_call is at :758)
FLASH_REPLACES = "jax/experimental/pallas/ops/tpu/flash_attention.py:331"
# attention: f32 sums in another order; bf16 outputs two bf16 steps at |o|~1
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}
# seqrec logits: one bf16 step at their magnitude (the Dense layers round to
# bf16, and an f32 summation-order difference can tip one rounding)
SEQ_TOL = 2.0**-7
# seqrec serving (phase 5): bench.py's seqrec attention shape (H8 D64,
# L4096) as a model of the template's depth over the ML-20M catalog
SEQ_CFG = SeqRecConfig(max_len=4096, embed_dim=512, num_heads=8,
                       num_blocks=2)
N_SEQ_USERS = 20_000
BWD_SOURCE = "predictionio_tpu_torch/csrc/flash_attn_bwd.cu"
# the stock kernel's two backward kernels (jax 0.9.0; their pl.pallas_calls
# are at :1121 and :1456)
BWD_REPLACES = {
    "flash_attention_bwd_dkv":
        "jax/experimental/pallas/ops/tpu/flash_attention.py:796",
    "flash_attention_bwd_dq":
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1146"}
# backward: each gradient against its largest magnitude (f32 sums in another
# order; bf16 P and dS roundings that an f32 difference can tip)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-6}
LSE_TOL = 1e-5
# a training step, kernels against plain: the loss relative, and each
# gradient leaf against its largest magnitude, as in
# tests/test_torch_seqrec_train.py. A leaf sums its terms over 32k
# positions with much cancellation, and a change in the last bits of the
# attention output moves terms whole (a ReLU or a bf16 rounding tips), so
# two correct plain steps that differ only in the order of the attention's
# f32 sums (512- against 1024-key blocks) differ by 5.7% of the worst
# leaf with the model's bf16 Dense layers and by 0.82% with f32 ones; the
# kernels measured 5.5% and 1.29% (all at full width on an H100 80GB HBM3
# at 700 W). Held to 2**-3 and 2**-5. The attention gradients inside the
# step are held to BWD_TOL, which is where a wiring fault would show.
STEP_LOSS_RTOL, STEP_GRAD_TOL, STEP_GRAD_TOL_F32 = 1e-5, 2.0**-3, 2.0**-5
# seqrec training (phase 6b): the phase-5 model at max_len 4097, so the
# attention sees L 4096; 8 users per step (cut from the trainer's 256: the
# f32 logits [8, 4096, 26745] alone take 3.3 GiB)
TRAIN_CFG = SeqRecConfig(max_len=4097, embed_dim=512, num_heads=8,
                         num_blocks=2)
TRAIN_BATCH, TRAIN_WARM, TRAIN_STEPS = 8, 2, 8
# the cyclic fixture of tests/test_parallel_seq.py:150-175
CYCLE_PARAMS = dict(max_len=12, embed_dim=32, num_heads=2, num_blocks=1,
                    epochs=30, batch_size=32, lr=3e-3)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke failed: {what}")


def split(out, k_pad: int):
    """(vals, ids) from the kernel's packed buffer or its pair."""
    if isinstance(out, tuple):
        return out
    return out[:, :k_pad], out[:, k_pad:].to(torch.int32)


def compare(out, ref, scores, k_pad: int, *, bitwise: bool) -> float:
    """Hold a kernel result against its plain version; return the max
    absolute value error. ``scores`` is the plain [B, N] score matrix."""
    v, i = split(out, k_pad)
    rv, ri = ref
    if bitwise:
        check(torch.equal(v, rv) and torch.equal(i, ri),
              "tie fixture not bitwise equal to topk_reference")
    check(torch.allclose(v, rv, rtol=RTOL, atol=ATOL),
          "kernel values disagree with topk_reference")
    finite = torch.isfinite(rv)
    check(torch.equal(i < 0, ~finite), "id -1 where the score is finite")
    at = torch.gather(scores, 1, i.clamp(min=0).long())
    check(torch.allclose(at[finite], rv[finite], rtol=RTOL, atol=ATOL),
          "a returned id's plain score differs from the value at its rank")
    return float((v - rv).abs().max()) if v.numel() else 0.0


def device_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the mean device time of ``iters`` calls.
    A device-side sleep first lets the host queue all calls, so the
    events time the device, not the Python launch path."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_profile(fn) -> tuple[dict, float]:
    """Run ``fn`` under the CUDA profiler: (device ms per activity name,
    wall seconds of the window). Device activity is every kernel and
    copy the profiler saw on the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = {e.key: e.self_device_time_total / 1e3
            for e in prof.key_averages() if e.self_device_time_total > 0}
    check(bool(busy), "the profiler saw no device activity")
    return busy, wall


def bound_ms(b_pad: int, n_pad: int, dim: int, k_pad: int,
             gather: bool) -> tuple[float, str]:
    """Least time for one call at H100 SXM peaks: each input read once
    (for the gather variant, only the b_pad query rows it reads plus the
    row ids), each output written once; 2*B*N*D f32 FLOP."""
    nbytes = 4 * (b_pad * dim + n_pad * dim + b_pad * 2 * k_pad)
    if gather:
        nbytes += 4 * b_pad
    flops = 2 * b_pad * n_pad * dim
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- phase 2 ------------------------------------------------------------


def padded_catalog(rng, n: int, dim: int, dev, scale: float = 1.0):
    items, _ = _pad_items(
        (rng.standard_normal((n, dim)) * scale).astype(np.float32), n, 512)
    return torch.from_numpy(items).to(dev)


def padded_queries(rng, b: int, dim: int, lane: int, dev, scale=1.0):
    b_pad, _ = _query_shapes(b, 1, 1)
    q = np.zeros((b_pad, lane), np.float32)
    q[:b, :dim] = rng.standard_normal((b, dim)) * scale
    return torch.from_numpy(q).to(dev)


def kernel_case(name, q, items, n_total, k, *, rows=None, timing=False,
                bitwise=False, iters=20) -> dict:
    """One fixture: compare, and optionally time kernel / plain / library."""
    k_pad = _query_shapes(1, min(k, n_total), n_total)[1]
    if rows is None:
        run = lambda: kernels.topk(q, items, n_total, k_pad)  # noqa: E731
        plain = lambda: topk_reference(q, items, n_total, k_pad)  # noqa: E731
        qg = q
    else:
        run = lambda: kernels.topk_rows(rows, q, items, n_total,  # noqa: E731
                                        k_pad)
        plain = lambda: topk_rows_reference(  # noqa: E731
            rows, q, items, n_total, k_pad)
        ok = (rows >= 0) & (rows < q.shape[0])
        qg = q[torch.where(ok, rows, 0).long()].masked_fill(~ok[:, None], 0.0)
    out = run()
    ref = plain()
    scores = (qg @ items.T).masked_fill(
        torch.arange(items.shape[0], device=items.device) >= n_total,
        float("-inf"))
    err = compare(out, ref, scores, k_pad, bitwise=bitwise)
    del scores
    rec = {"case": name, "b_pad": int(qg.shape[0]), "n_pad": int(items.shape[0]),
           "k_pad": k_pad, "packed": n_total < PACKED_IDX_LIMIT,
           "max_abs_err": err}
    if timing:
        rec["ms"] = device_ms(run, iters)
        rec["plain_ms"] = device_ms(plain, iters)
        rec["library_ms"] = device_ms(lambda: torch.topk(qg @ items.T, k_pad),
                                      iters)
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            rec["b_pad"], rec["n_pad"], int(items.shape[1]), k_pad,
            rows is not None)
    return rec


def phase_kernels(dev, *, n_items=N_ITEMS, n_users=N_USERS, rank=RANK,
                  big_rows=PACKED_IDX_LIMIT + 1000, timing=True) -> list:
    rng = np.random.default_rng(SEED)
    scale = 1 / np.sqrt(rank)
    recs = []
    items = padded_catalog(rng, n_items, rank, dev, scale)
    for b in (1, 8, 64, 128):
        q = padded_queries(rng, b, rank, items.shape[1], dev, scale)
        for k in (10, 64, 1000):
            recs.append(kernel_case(f"ml20m B={b} k={k}", q, items, n_items,
                                    k, timing=timing))
    # the serving shapes, num <= 20 through the gather: a full micro-batch
    # and the 8-row bucket that most measured serving batches fill
    qtab = torch.zeros(_capacity(n_users), items.shape[1], device=dev)
    qtab[:n_users, :rank] = torch.from_numpy(
        (rng.standard_normal((n_users, rank)) * scale).astype(np.float32))
    rows = torch.from_numpy(rng.integers(0, n_users, 128).astype(np.int32))
    rows[:4] = torch.tensor([-1, n_users, n_users + 7, qtab.shape[0] + 3])
    recs.append(kernel_case("ml20m rows B=128 k=20", qtab, items, n_items, 20,
                            rows=rows.to(dev), timing=timing))
    recs.append(kernel_case("ml20m rows B=8 k=20", qtab, items, n_items, 20,
                            rows=rows[4:12].contiguous().to(dev),
                            timing=timing))
    if timing:
        # where one serving-shape call spends its device time, by kernel
        for rec, sel in ((recs[-2], rows), (recs[-1], rows[4:12])):
            sel = sel.contiguous().to(dev)
            busy, _ = device_profile(lambda: [
                kernels.topk_rows(sel, qtab, items, n_items, 24)
                for _ in range(20)])
            rec["stage_ms"] = {k: v / 20 for k, v in busy.items()}
    del qtab
    # a 5-row catalog with k > N, and n_total off the 512 tile
    small = padded_catalog(rng, 5, 24, dev)
    recs.append(kernel_case("5 rows k=20", padded_queries(
        rng, 3, 24, small.shape[1], dev), small, 5, 20))
    odd = padded_catalog(rng, 1000, 32, dev)
    recs.append(kernel_case("n_total=1000 k=10", padded_queries(
        rng, 3, 32, odd.shape[1], dev), odd, 1000, 10))
    # ties: integer-valued factors, duplicated rows and a zero query
    base = rng.integers(-3, 4, (1400, 24)).astype(np.float32)
    tie = np.concatenate([base, base[:136]], axis=0)
    tied, _ = _pad_items(tie, len(tie), 512)
    tq = np.zeros((8, tied.shape[1]), np.float32)
    tq[1:6, :24] = rng.integers(-3, 4, (5, 24))
    for k in (10, 200):
        recs.append(kernel_case(f"ties k={k}", torch.from_numpy(tq).to(dev),
                                torch.from_numpy(tied).to(dev), len(tie), k,
                                bitwise=True))
    # unpacked: ids past 2^24 are not exact in f32, so two buffers
    big = torch.empty(((big_rows + 511) // 512 * 512, 128), device=dev)
    big.normal_(generator=torch.Generator(device=dev).manual_seed(SEED))
    bq = padded_queries(rng, 8, 128, 128, dev)
    recs.append(kernel_case(f"unpacked n_total={big_rows} B=8 k=10", bq, big,
                            big_rows, 10, timing=timing, iters=3))
    check(not recs[-1]["packed"] or big_rows < PACKED_IDX_LIMIT,
          "the large case did not take the two-buffer path")
    del big
    return recs


# -- phase 3 ------------------------------------------------------------


def build_server(dev, *, n_users=N_USERS, n_items=N_ITEMS, rank=RANK):
    rng = np.random.default_rng(SEED)
    scale = 1 / np.sqrt(rank)
    users = (rng.standard_normal((n_users, rank)) * scale).astype(np.float32)
    items = (rng.standard_normal((n_items, rank)) * scale).astype(np.float32)
    model = als_model_from_numpy(
        users, items, [f"u{i}" for i in range(n_users)],
        [f"i{j}" for j in range(n_items)], rank=rank, lambda_=0.1,
        device=dev)
    result = TrainResult([model], [ALSAlgorithm(AlgorithmParams(rank=rank))],
                         FirstServing(), ["als"])
    return EngineServer(engine_factory(), result, "chip-smoke", device=dev)


def host_check(body: dict, query: dict, users, items) -> None:
    """One answer against a host numpy exact top-k of the same factors;
    ties (and near-ties the summation order can swap) within 1e-5."""
    got = body["itemScores"]
    u = query["user"]
    if not u.startswith("u") or int(u[1:]) >= len(users):
        check(got == [], f"unknown user {u} got items")
        return
    scores = items @ users[int(u[1:])]
    want = np.argsort(-scores, kind="stable")[: query["num"]]
    check(len(got) == len(want), f"{u}: {len(got)} items, want {len(want)}")
    gs = np.array([g["score"] for g in got], np.float32)
    gi = np.array([int(g["item"][1:]) for g in got])
    check(np.allclose(gs, scores[want], rtol=RTOL, atol=1e-6),
          f"{u}: scores differ from the host top-k")
    check(np.allclose(scores[gi], gs, rtol=RTOL, atol=1e-6),
          f"{u}: an item's host score differs from its served score")


#: The load generator of the concurrent burst, run as separate processes so
#: that client threads do not share the server's interpreter lock. Reads
#: its queries as JSON on stdin; writes one JSON list of [body, wall
#: seconds, monotonic start, monotonic end] per query. One connection per
#: query through ``http.client``: ``urllib.request.urlopen`` builds its
#: process-wide opener (an HTTPS context that loads the CA store) on first
#: use, and threads racing to build it held the first query of every
#: client thread for about 2 s.
_CLIENT = r"""
import http.client, json, sys, time
from concurrent.futures import ThreadPoolExecutor
from urllib.parse import urlsplit

url, workers = sys.argv[1], int(sys.argv[2])
target = urlsplit(url)
queries = json.loads(sys.stdin.read())

def post(qj):
    t0 = time.monotonic()
    conn = http.client.HTTPConnection(target.hostname, target.port,
                                      timeout=60)
    conn.request("POST", target.path, body=json.dumps(qj),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    if resp.status != 200:
        raise RuntimeError(f"HTTP {resp.status}: {raw[:200]!r}")
    t1 = time.monotonic()
    return [json.loads(raw), t1 - t0, t0, t1]

with ThreadPoolExecutor(workers) as pool:
    print(json.dumps(list(pool.map(post, queries))))
"""


def post(url: str, qj: dict) -> tuple[dict, float]:
    """One query from this process: (body, wall seconds)."""
    t0 = time.perf_counter()
    req = urllib.request.Request(
        url, data=json.dumps(qj).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = json.loads(resp.read())
    return body, time.perf_counter() - t0


def burst(url: str, queries: list, procs: int, threads: int):
    """Send ``queries`` from ``procs`` client processes of ``threads``
    threads each: ([(body, wall s)] in query order, seconds from the first
    send to the last answer)."""
    shares = [queries[p::procs] for p in range(procs)]
    clients = [subprocess.Popen(
        [sys.executable, "-c", _CLIENT, url, str(threads)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for _ in shares]
    # every client gets its queries before any answer is read, so all of
    # them send at once (communicate() one by one would run them in turn)
    for c, share in zip(clients, shares):
        c.stdin.write(json.dumps(share))
        c.stdin.close()
    outs = [c.stdout.read() for c in clients]
    check(all(c.wait(timeout=300) == 0 for c in clients),
          "a load client failed")
    results = [json.loads(o) for o in outs]
    answers = [None] * len(queries)
    for p, res in enumerate(results):
        for j, r in zip(range(p, len(queries), procs), res):
            answers[j] = (r[0], r[1])
    span = (max(r[3] for res in results for r in res)
            - min(r[2] for res in results for r in res))
    return answers, span


def server_latency_ms(server) -> dict:
    """p50/p99 in ms of the server-side latency histograms."""
    return {name: {q: h[q] * 1e3 for q in ("p50", "p99")} | {"n": h["count"]}
            for name, h in server.serving_stats()["latency"].items()
            if h is not None and h["count"]}


def phase_serving(dev, server, *, n_seq=16, n_conc=256, procs=4,
                  threads=16) -> dict:
    model = server.deployed.result.models[0]
    users, items = model.user_factors, model.item_factors
    check(model._retriever._items.device.type == dev.type
          and model._pipeline._qtab.device.type == dev.type,
          f"catalog or query table not on {dev.type}")
    rng = np.random.default_rng(SEED + 1)
    nums = (1, 4, 10, 20)

    def query(j: int) -> dict:
        user = (f"nobody{j}" if j % 37 == 5
                else f"u{int(rng.integers(0, len(users)))}")
        return {"user": user, "num": nums[j % len(nums)]}

    seq = [query(j) for j in range(n_seq)]
    conc = [query(n_seq + j) for j in range(n_conc)]
    with serve(server, "127.0.0.1", 0) as front:
        url = f"http://127.0.0.1:{front.port}/queries.json"
        b = server.batcher
        batches0, launches0 = b.batches, kernels.LAUNCHES["topk_rows"]
        dispatches0 = model._pipeline.stats()["dispatches"]
        walls = []
        METRICS.reset()
        for qj in seq:
            body, wall = post(url, qj)
            host_check(body, qj, users, items)
            walls.append(wall)
        single_layers = server_latency_ms(server)
        burst0 = (b.batches, b.batched_queries)
        METRICS.reset()
        answers, conc_s = burst(url, conc, procs, threads)
        layers = server_latency_ms(server)
        for qj, (body, wall) in zip(conc, answers):
            host_check(body, qj, users, items)
            walls.append(wall)
        batches = b.batches - batches0
        burst_batch = ((b.batched_queries - burst0[1])
                       / max(b.batches - burst0[0], 1))
        launches = kernels.LAUNCHES["topk_rows"] - launches0
        dispatches = model._pipeline.stats()["dispatches"] - dispatches0
        # the same burst again under the profiler: the device's busy share
        prof_answers = []
        busy, prof_s = device_profile(lambda: prof_answers.extend(
            burst(url, conc, procs, threads)[0]))
        for qj, (body, _wall) in zip(conc, prof_answers):
            host_check(body, qj, users, items)
    unknown = sum(not q["user"].startswith("u") for q in seq + conc)
    # a batch of unknown users only has nothing to score: it launches nothing
    check(launches == dispatches and batches - unknown <= launches <= batches,
          f"{launches} topk_rows launches for {batches} batches "
          f"({dispatches} pipeline dispatches, {unknown} unknown users)")
    walls_ms = np.array(walls) * 1e3
    return {"queries": len(walls), "unknown_users": unknown,
            "batches": batches, "topk_rows_launches": launches,
            "wall_p50_ms": float(np.percentile(walls_ms, 50)),
            "wall_p99_ms": float(np.percentile(walls_ms, 99)),
            "single_p50_ms": float(np.percentile(walls_ms[:n_seq], 50)),
            "single_max_ms": float(walls_ms[:n_seq].max()),
            "single_server_ms": single_layers,
            "burst_p50_ms": float(np.percentile(walls_ms[n_seq:], 50)),
            "burst_p99_ms": float(np.percentile(walls_ms[n_seq:], 99)),
            "qps_concurrent": n_conc / conc_s,
            "clients": procs * threads,
            "burst_avg_batch": burst_batch,
            "burst_server_ms": layers,
            "max_batch": b.max_seen_batch,
            "device_busy_share": sum(busy.values()) / 1e3 / prof_s}


# -- phase 4 ------------------------------------------------------------


#: (case, B, L, H, D, dtype, causal); the phase-5 serving shapes are the
#: model's per-block call at b_pad 8 (one query) and 128 (a full batch)
ATTN_CASES = [
    ("seqrec B4 L4096 H8 D64 causal bf16", 4, 4096, 8, 64, "bfloat16", True),
    ("seqrec B4 L4096 H8 D64 causal f32", 4, 4096, 8, 64, "float32", True),
    ("long B1 L16384 H8 D64 causal bf16", 1, 16384, 8, 64, "bfloat16", True),
    ("serving B8 L4096 H8 D64 causal f32", 8, 4096, 8, 64, "float32", True),
    ("serving B128 L4096 H8 D64 causal f32", 128, 4096, 8, 64, "float32",
     True),
    ("template B8 L64 H2 D24 causal f32", 8, 64, 2, 24, "float32", True),
    ("template B8 L64 H2 D24 causal bf16", 8, 64, 2, 24, "bfloat16", True),
    ("D128 B4 L128 H8 causal f32", 4, 128, 8, 128, "float32", True),
    ("D128 B4 L128 H8 full f32", 4, 128, 8, 128, "float32", False),
    ("unaligned B2 L25 H2 D64 causal f32", 2, 25, 2, 64, "float32", True),
    ("unaligned B2 L25 H2 D64 full f32", 2, 25, 2, 64, "float32", False),
    ("unaligned B2 L25 H2 D64 causal bf16", 2, 25, 2, 64, "bfloat16", True),
    ("unaligned B2 L25 H2 D64 full bf16", 2, 25, 2, 64, "bfloat16", False),
]
SERVING_CASE = "serving B8 L4096 H8 D64 causal f32"
#: plain attention: batch rows per chunk, so [chunk, H, L, 1024] f32 scores
#: stay near 1 GiB at L 4096
PLAIN_CHUNK = 8


def chunked_blockwise(q, k, v, *, causal: bool, chunk: int = PLAIN_CHUNK):
    """``blockwise_attention`` over ``chunk`` batch rows at a time."""
    return torch.cat([blockwise_attention(q[s:s + chunk], k[s:s + chunk],
                                          v[s:s + chunk], causal=causal)
                      for s in range(0, q.shape[0], chunk)])


def attn_bound_ms(B, L, H, D, dtype, causal) -> tuple[float, str]:
    """Least time at H100 SXM peaks: q, k, v read and o written once; 4*D
    FLOP per visible (query, key) pair (QK^T and PV), L(L+1)/2 pairs when
    causal, at the f32 peak for f32 and the bf16 tensor-core peak for
    bf16."""
    elem = 4 if dtype == torch.float32 else 2
    nbytes = 4 * B * L * H * D * elem
    pairs = L * (L + 1) // 2 if causal else L * L
    flops = 4 * B * H * D * pairs
    peak = PEAK_F32_FLOP_S if dtype == torch.float32 else PEAK_BF16_FLOP_S
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attention_case(dev, name, B, L, H, D, dtype, causal, *, timing):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + B * L + D)
    q, k, v = (torch.randn(B, L, H, D, generator=gen, device=dev)
               .mul_(0.5).to(dt) for _ in range(3))
    out = flash_attention(q, k, v, causal=causal)
    ref = chunked_blockwise(q, k, v, causal=causal)
    check(out.dtype == dt and out.shape == q.shape,
          f"{name}: kernel output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    err = float((out.float() - ref.float()).abs().max())
    tol = ATTN_TOL[dt]
    check(bool(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)),
          f"{name}: kernel disagrees with blockwise_attention (max |err| "
          f"{err:.3g}, tolerance {tol:.3g})")
    rec = {"case": name, "shape": [B, L, H, D], "dtype": dtype,
           "causal": causal, "max_abs_err": err, "tol": tol}
    del out, ref
    if timing:
        iters, reps = (2, 3) if B * L * L * H >= 1 << 34 else (10, 5)
        rec["ms"] = device_ms(lambda: flash_attention(q, k, v, causal=causal),
                              iters, reps)
        rec["plain_ms"] = device_ms(
            lambda: chunked_blockwise(q, k, v, causal=causal), iters, reps)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec["library_ms"] = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), iters, reps)
        rec["bound_ms"], rec["bound_by"] = attn_bound_ms(B, L, H, D, dt,
                                                         causal)
    return rec


def phase_attention(dev, cases=ATTN_CASES, *, timing=True) -> list:
    recs = []
    for case in cases:
        recs.append(attention_case(dev, *case, timing=timing))
        print("[attention] " + json.dumps(recs[-1]), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return recs


# -- phase 5 ------------------------------------------------------------


def seq_histories(rng, n_users: int, max_len: int, n_items: int):
    """Left-padded histories [n_users, max_len] int32: lengths uniform in
    [1, max_len], items uniform in [1, n_items] (0 = pad)."""
    seqs = rng.integers(1, n_items + 1, (n_users, max_len), dtype=np.int32)
    lengths = rng.integers(1, max_len + 1, n_users)
    seqs[np.arange(max_len)[None, :] < (max_len - lengths)[:, None]] = 0
    return seqs


def build_seq_model(dev, cfg: SeqRecConfig, *, n_users, n_items,
                    seed=SEED) -> SeqRecModel:
    rng = np.random.default_rng(seed)
    seqs = seq_histories(rng, n_users, cfg.max_len, n_items)
    return seqrec_model_from_numpy(
        init_params(n_items, cfg, seed), seqs,
        [f"u{i}" for i in range(n_users)], [f"i{j}" for j in range(n_items)],
        cfg, device=dev)


class PlainSeqRec(SeqRecModel):
    """The served model's weights and histories with every block's
    attention through ``blockwise_attention``, ``PLAIN_CHUNK`` users at a
    time, then the same host top-k: the plain path each answer is held
    to."""

    def logits_last(self, seqs: np.ndarray) -> np.ndarray:
        net = self._net
        dev = net.item_embed.device
        outs = []
        with torch.inference_mode():
            for s in range(0, len(seqs), PLAIN_CHUNK):
                x = torch.from_numpy(seqs[s:s + PLAIN_CHUNK]).to(dev)
                outs.append(net.forward_last(
                    x, attention=blockwise_attention).cpu().numpy())
        return np.concatenate(outs)


def plain_twin(model: SeqRecModel) -> PlainSeqRec:
    twin = PlainSeqRec(params=model.params, seqs=model.seqs,
                       user_ids=model.user_ids, item_ids=model.item_ids,
                       config=model.config)
    twin._net = model._net
    return twin


def seq_check(got: list, want: list, num: int, what: str) -> None:
    """A served list of ``num`` items against the plain path's list of
    ``num + 1`` (the extra rank is the neighbour of the last): the same
    length, scores within SEQ_TOL, and the same item at every rank whose
    plain score is more than SEQ_TOL from both neighbours' (near-ties may
    swap, across the list's end too)."""
    n = min(num, len(want))
    check(len(got) == n, f"{what}: {len(got)} items, want {n}")
    ws = [s for _, s in want]
    for r, ((gi, gs), (wi, w)) in enumerate(zip(got, want)):
        check(abs(gs - w) <= SEQ_TOL, f"{what}: rank {r} score {gs} vs "
              f"plain {w}")
        near = any(abs(w - ws[m]) <= SEQ_TOL
                   for m in (r - 1, r + 1) if 0 <= m < len(ws))
        check(near or gi == wi, f"{what}: rank {r} item {gi} ({gs}) vs "
              f"plain {wi} ({w}); plain neighbours {ws[max(r - 1, 0):r + 2]}")


def build_seq_server(dev, *, n_users=N_SEQ_USERS, n_items=N_ITEMS,
                     cfg=SEQ_CFG) -> EngineServer:
    model = build_seq_model(dev, cfg, n_users=n_users, n_items=n_items)
    params = seqrec_engine.AlgorithmParams(
        max_len=cfg.max_len, embed_dim=cfg.embed_dim,
        num_heads=cfg.num_heads, num_blocks=cfg.num_blocks)
    result = TrainResult([model], [seqrec_engine.SeqRecAlgorithm(params)],
                         FirstServing(), ["seqrec"])
    return EngineServer(seqrec_engine.engine_factory(), result,
                        "chip-smoke-seqrec", device=dev)


def phase_seq_serving(dev, server, *, n_seq=8, n_conc=64, procs=4,
                      threads=16) -> dict:
    model = server.deployed.result.models[0]
    check(model.device is not None and model.device.type == dev.type,
          f"seqrec module not on {dev.type}")
    n_users = len(model.user_ids)
    rng = np.random.default_rng(SEED + 2)
    nums = (1, 4, 10, 20)

    def query(j: int) -> dict:
        user = (f"nobody{j}" if j % 23 == 5
                else f"u{int(rng.integers(0, n_users))}")
        return {"user": user, "num": nums[j % len(nums)]}

    seq = [query(j) for j in range(n_seq)]
    conc = [query(n_seq + j) for j in range(n_conc)]
    plain = plain_twin(model)
    want = plain.batch_recommend([q["user"] for q in seq + conc],
                                 [q["num"] + 1 for q in seq + conc])

    def verify(queries, answers, offset=0):
        for j, (qj, (body, _wall)) in enumerate(zip(queries, answers)):
            got = [(g["item"], g["score"]) for g in body["itemScores"]]
            seq_check(got, want[offset + j], qj["num"], f"query {qj}")

    with serve(server, "127.0.0.1", 0) as front:
        url = f"http://127.0.0.1:{front.port}/queries.json"
        b = server.batcher
        batches0, forwards0 = b.batches, model.forwards
        launches0 = kernels.LAUNCHES["flash_attention"]
        METRICS.reset()
        seq_answers = [post(url, qj) for qj in seq]
        verify(seq, seq_answers)
        single_layers = server_latency_ms(server)
        burst0 = (b.batches, b.batched_queries)
        METRICS.reset()
        answers, conc_s = burst(url, conc, procs, threads)
        layers = server_latency_ms(server)
        verify(conc, answers, n_seq)
        batches = b.batches - batches0
        burst_batch = ((b.batched_queries - burst0[1])
                       / max(b.batches - burst0[0], 1))
        forwards = model.forwards - forwards0
        launches = kernels.LAUNCHES["flash_attention"] - launches0
        prof_answers = []
        busy, prof_s = device_profile(lambda: prof_answers.extend(
            burst(url, conc, procs, threads)[0]))
        verify(conc, prof_answers, n_seq)
    unknown = sum(not q["user"].startswith("u") for q in seq + conc)
    # a batch of unknown users only runs no forward
    check(launches == model.config.num_blocks * forwards
          and batches - unknown <= forwards <= batches,
          f"{launches} flash_attention launches for {forwards} forwards of "
          f"{model.config.num_blocks} blocks in {batches} batches")
    walls_ms = np.array([w for _, w in seq_answers + answers]) * 1e3
    return {"queries": len(walls_ms), "unknown_users": unknown,
            "batches": batches, "forwards": forwards,
            "flash_attention_launches": launches,
            "single_p50_ms": float(np.percentile(walls_ms[:n_seq], 50)),
            "single_max_ms": float(walls_ms[:n_seq].max()),
            "single_server_ms": single_layers,
            "burst_p50_ms": float(np.percentile(walls_ms[n_seq:], 50)),
            "burst_p99_ms": float(np.percentile(walls_ms[n_seq:], 99)),
            "wall_p50_ms": float(np.percentile(walls_ms, 50)),
            "wall_p99_ms": float(np.percentile(walls_ms, 99)),
            "qps_concurrent": n_conc / conc_s,
            "clients": procs * threads,
            "burst_avg_batch": burst_batch,
            "burst_server_ms": layers,
            "max_batch": b.max_seen_batch,
            "device_busy_share": sum(busy.values()) / 1e3 / prof_s,
            "device_ms_by_kernel": dict(sorted(
                busy.items(), key=lambda kv: -kv[1])[:8])}


def phase_seq_template(dev, *, n_users=1000, n_items=N_ITEMS) -> dict:
    """The shipped template configuration (seqrec engine.json: embed 48,
    2 heads, max_len 64) through ``batch_recommend`` once, against its
    plain path."""
    cfg = SeqRecConfig(**{f: getattr(seqrec_engine.AlgorithmParams(), f)
                          for f in ("max_len", "embed_dim", "num_heads",
                                    "num_blocks")})
    model = build_seq_model(dev, cfg, n_users=n_users, n_items=n_items,
                            seed=SEED + 3)
    users = [f"u{i}" for i in range(0, n_users, max(n_users // 40, 1))]
    users += ["nobody"]
    nums = [(1, 4, 10, 20)[j % 4] for j in range(len(users))]
    launches0, forwards0 = kernels.LAUNCHES["flash_attention"], model.forwards
    got = model.batch_recommend(users, nums)
    launches = kernels.LAUNCHES["flash_attention"] - launches0
    forwards = model.forwards - forwards0
    check(forwards == 1 and (dev.type != "cuda"
                             or launches == cfg.num_blocks),
          f"{launches} launches in {forwards} forwards")
    check(got[-1] == [], "an unknown user got items")
    want = plain_twin(model).batch_recommend(users, [n + 1 for n in nums])
    for u, num, g, w in zip(users, nums, got, want):
        seq_check(g, w, num, f"template user {u}")
    return {"config": {"max_len": cfg.max_len, "embed_dim": cfg.embed_dim,
                       "num_heads": cfg.num_heads,
                       "num_blocks": cfg.num_blocks},
            "queries": len(users), "forwards": forwards,
            "flash_attention_launches": launches}


# -- phase 6 ------------------------------------------------------------


#: the phase-4 shapes (B8 L4096 H8 D64 causal f32 is also the training
#: shape of phase 6b), plus the template's training shapes: max_len 64 at
#: head dim 24 (L 63) and the cyclic fixture's max_len 12 at head dim 16;
#: then the kernels' tile edges in both types: L 129 and 200 cross a 128-
#: and a 64-row tile boundary, D 40 and 120 are no multiple of the bf16
#: k-step 16, L 1 is a lone row
BWD_CASES = ATTN_CASES + [
    ("template train B32 L63 H2 D24 causal f32", 32, 63, 2, 24, "float32",
     True),
    ("template train B32 L63 H2 D24 causal bf16", 32, 63, 2, 24, "bfloat16",
     True),
    ("cycle train B32 L11 H2 D16 causal f32", 32, 11, 2, 16, "float32", True),
] + [
    (f"edge B{B} L{L} H2 D{D} {'causal' if causal else 'full'} {tag}", B, L,
     2, D, dtype, causal)
    for B, L, D, causal in ((2, 129, 40, True), (2, 129, 40, False),
                            (2, 200, 40, True), (2, 200, 40, False),
                            (2, 257, 120, True), (3, 1, 8, True))
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16"))
]
TRAIN_CASE = SERVING_CASE
#: cases whose gradients are computed twice and held bitwise equal: the
#: kernels use no atomics and sum in a fixed order
REPEAT_CASES = (TRAIN_CASE, "seqrec B4 L4096 H8 D64 causal bf16")
#: plain backward: batch rows per chunk ([chunk, H, L, 1024] f32 blocks)
BWD_PLAIN_CHUNK = 2


def chunked_blockwise_lse(q, k, v, *, causal: bool,
                          chunk: int = PLAIN_CHUNK):
    """``blockwise_attention(..., return_lse=True)`` over ``chunk`` batch
    rows at a time: (out, lse)."""
    return tuple(torch.cat(part) for part in zip(*(blockwise_attention(
        q[s:s + chunk], k[s:s + chunk], v[s:s + chunk], causal=causal,
        return_lse=True) for s in range(0, q.shape[0], chunk))))


def chunked_bwd(q, k, v, o, lse, do, *, causal: bool,
                chunk: int = BWD_PLAIN_CHUNK):
    """``blockwise_attention_bwd`` over ``chunk`` batch rows at a time."""
    parts = [blockwise_attention_bwd(
        q[s:s + chunk], k[s:s + chunk], v[s:s + chunk], o[s:s + chunk],
        lse[s:s + chunk], do[s:s + chunk], causal=causal)
        for s in range(0, q.shape[0], chunk)]
    return tuple(torch.cat(g) for g in zip(*parts))


def bwd_bound_ms(B, L, H, D, dtype, causal, *, dkv: bool):
    """Least time at H100 SXM peaks: q, k, v, dO, lse and di read once, the
    outputs (dk and dv, or dq) written once; 8*D FLOP per visible pair for
    dK/dV (S, dP, dV, dK) and 6*D for dQ (S, dP, dQ), at the f32 peak for
    f32 and the bf16 tensor-core peak for bf16."""
    elem = 4 if dtype == torch.float32 else 2
    nbytes = (4 + (2 if dkv else 1)) * B * L * H * D * elem + 2 * B * H * L * 4
    pairs = L * (L + 1) // 2 if causal else L * L
    flops = (8 if dkv else 6) * D * B * H * pairs
    peak = PEAK_F32_FLOP_S if dtype == torch.float32 else PEAK_BF16_FLOP_S
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rel_err(got, want, scale=None) -> float:
    """Max |got - want| over the largest |want| (or over ``scale``)."""
    if scale is None:
        scale = want.float().abs().max()
    return float((got.float() - want.float()).abs().max()
                 / torch.as_tensor(scale).clamp(min=1e-30))


def bwd_case(dev, name, B, L, H, D, dtype, causal, *, timing):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7 * B * L + D)
    q, k, v, do = (torch.randn(B, L, H, D, generator=gen, device=dev)
                   .mul_(0.5).to(dt) for _ in range(4))
    lse = torch.empty(B, H, L, device=dev)
    o = kernels.flash_attention_fwd(q, k, v, causal=causal, lse=lse)
    ref_o, ref_lse = chunked_blockwise_lse(q, k, v, causal=causal)
    # the forward that writes the logsumexp, held as phase 4 holds the
    # serving forward
    o_err, o_tol = float((o.float() - ref_o.float()).abs().max()), ATTN_TOL[dt]
    check(o.dtype == dt and o.shape == q.shape
          and bool(torch.allclose(o.float(), ref_o.float(), rtol=o_tol,
                                  atol=o_tol)),
          f"{name}: the forward's output with the logsumexp disagrees with "
          f"blockwise_attention (max |err| {o_err:.3g}, tolerance {o_tol:.3g})")
    check(torch.equal(o, kernels.flash_attention_fwd(q, k, v, causal=causal)),
          f"{name}: the forward's output changes when it writes the "
          f"logsumexp")
    lse_err = float((lse - ref_lse).abs().max())
    check(bool(torch.allclose(lse, ref_lse, rtol=LSE_TOL, atol=LSE_TOL)),
          f"{name}: the forward's logsumexp disagrees with "
          f"blockwise_attention ({lse_err:.3g})")
    del ref_o, ref_lse
    di = attention_di(o, do)
    dk, dv = kernels.flash_attention_bwd_dkv(q, k, v, do, lse, di,
                                             causal=causal)
    dq = kernels.flash_attention_bwd_dq(q, k, v, do, lse, di, causal=causal)
    want = chunked_bwd(q, k, v, o, lse, do, causal=causal)
    tol = BWD_TOL[dt]
    rec = {"case": name, "shape": [B, L, H, D], "dtype": dtype,
           "causal": causal, "o_max_abs_err": o_err,
           "lse_max_abs_err": lse_err, "tol": tol}
    # with one key per row (L 1) the softmax has no gradient: dq and dk are
    # zero up to rounding on both sides, so they are held against dv's
    # largest magnitude (the output gradient flowing in), not their own
    scales = [None, None, None] if L > 1 else [want[2].float().abs().max()] * 3
    for key, got, w, scale in zip(("dq", "dk", "dv"), (dq, dk, dv), want,
                                  scales):
        check(got.dtype == dt and got.shape == q.shape
              and bool(torch.isfinite(got).all()),
              f"{name}: {key} {got.dtype} {tuple(got.shape)} or not finite")
        rec[f"{key}_max_abs_err"] = float((got.float() - w.float()).abs().max())
        rec[f"{key}_rel_err"] = rel_err(got, w, scale)
        check(rec[f"{key}_rel_err"] <= tol,
              f"{name}: {key} disagrees with blockwise_attention_bwd "
              f"({rec[f'{key}_rel_err']:.3g} of its largest magnitude, "
              f"tolerance {tol:.3g})")
    if name in REPEAT_CASES:
        again = (kernels.flash_attention_bwd_dq(q, k, v, do, lse, di,
                                                causal=causal),
                 *kernels.flash_attention_bwd_dkv(q, k, v, do, lse, di,
                                                  causal=causal))
        for key, got, rerun in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
            check(torch.equal(got, rerun),
                  f"{name}: {key} differs between two runs of its kernel")
        rec["repeat_bitwise"] = True
        del again
    del dq, dk, dv, want
    if timing:
        iters, reps = (2, 3) if B * L * L * H >= 1 << 34 else (10, 5)
        rec["dkv_ms"] = device_ms(lambda: kernels.flash_attention_bwd_dkv(
            q, k, v, do, lse, di, causal=causal), iters, reps)
        rec["dq_ms"] = device_ms(lambda: kernels.flash_attention_bwd_dq(
            q, k, v, do, lse, di, causal=causal), iters, reps)
        rec["plain_ms"] = device_ms(lambda: chunked_bwd(
            q, k, v, o, lse, do, causal=causal), iters, reps)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2)
        rec["library_ms"] = device_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), iters, reps)
        del out
        for key, dkv in (("dkv", True), ("dq", False)):
            rec[f"{key}_bound_ms"], rec[f"{key}_bound_by"] = bwd_bound_ms(
                B, L, H, D, dt, causal, dkv=dkv)
    return rec


def phase_attention_bwd(dev, cases=BWD_CASES, *, timing=True) -> list:
    recs = []
    for case in cases:
        recs.append(bwd_case(dev, *case, timing=timing))
        print("[attention-bwd] " + json.dumps(recs[-1]), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return recs


def leaf_grads(net: SeqRec) -> dict:
    return {name: p.grad.detach().clone() for name, p in
            net.named_parameters()}


def real_targets(x) -> torch.Tensor:
    return torch.clamp((x[:, 1:] > 0).sum(), min=1).float()


def step_grads(net: SeqRec, x, attention, chunk: int):
    """The loss and leaf gradients of one step on ``x``, ``chunk`` rows at a
    time (each chunk's mean loss weighted by its share of the real targets,
    so the parts add up to the batch's loss)."""
    net.zero_grad(set_to_none=True)
    count, total = real_targets(x), 0.0
    for s in range(0, len(x), chunk):
        part = x[s:s + chunk]
        loss = seq_rec_loss(net, part, attention) * (real_targets(part)
                                                     / count)
        loss.backward()
        total += float(loss.detach())
    grads = leaf_grads(net)
    net.zero_grad(set_to_none=True)
    return total, grads


def recording_attention(records: list):
    """``flash_attention`` that records each call's q, k, v, the gradient
    that reaches its output and the gradients its backward returns."""
    def attention(q, k, v, *, causal):
        rec = {"causal": causal, "qkv": [t.detach() for t in (q, k, v)]}
        for key, t in zip(("dq", "dk", "dv"), (q, k, v)):
            t.register_hook(lambda g, key=key: rec.__setitem__(key,
                                                               g.detach()))
        o = flash_attention(q, k, v, causal=causal)
        o.register_hook(lambda g: rec.__setitem__("do", g.detach()))
        records.append(rec)
        return o
    return attention


def step_compare(dev, net: SeqRec, x, *, chunk: int, grad_tol: float,
                 what: str) -> dict:
    """One training step's loss and gradients through the kernels against
    the same step with attention through ``blockwise_attention`` under
    autograd, ``chunk`` rows at a time. Each attention call's dq, dk, dv
    in the kernel step are held at the kernels' own tolerance against
    ``blockwise_attention_bwd`` on that call's inputs. A second plain step
    with 512-key blocks in place of 1024 (another order of the same f32
    sums) gives the leaves' noise floor, which is reported."""
    records = []
    got_loss, got = step_grads(net, x, recording_attention(records), len(x))
    want_loss, want = step_grads(net, x, blockwise_attention, chunk)
    _, other = step_grads(net, x, functools.partial(blockwise_attention,
                                                    block_size=512), chunk)
    check(abs(got_loss - want_loss) <= STEP_LOSS_RTOL * abs(want_loss),
          f"{what}: loss {got_loss} through the kernels, "
          f"{want_loss} through the plain path")
    errs = {name: rel_err(got[name], want[name]) for name in want}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= grad_tol,
          f"{what}: gradient {worst} differs from the plain path by "
          f"{errs[worst]:.3g} of its largest magnitude (tolerance "
          f"{grad_tol:.3g})")
    floor = {name: rel_err(other[name], want[name]) for name in want}
    attn_err = 0.0
    for i, rec in enumerate(records):
        q, k, v = rec["qkv"]
        o, lse = chunked_blockwise_lse(q, k, v, causal=rec["causal"])
        for key, w in zip(("dq", "dk", "dv"), chunked_bwd(
                q, k, v, o, lse, rec["do"], causal=rec["causal"])):
            err = rel_err(rec[key], w)
            check(err <= BWD_TOL[torch.float32],
                  f"{what}: attention call {i}'s {key} differs from "
                  f"blockwise_attention_bwd by {err:.3g} of its largest "
                  f"magnitude")
            attn_err = max(attn_err, err)
    return {"loss_kernels": got_loss, "loss_plain": want_loss,
            "grad_worst_leaf": worst, "grad_worst_rel_err": errs[worst],
            "grad_tol": grad_tol, "plain_vs_plain_worst_leaf": max(
                floor, key=floor.get),
            "plain_vs_plain_worst_rel_err": max(floor.values()),
            "attention_calls": len(records),
            "attention_grad_worst_rel_err": attn_err}


@contextlib.contextmanager
def f32_dense():
    """The port's Dense layers as plain f32 products plus bias, as
    tests/test_torch_seqrec_train.py patches them: with nothing rounded to
    bf16, a step through the kernels and one through the plain path differ
    only in the order of f32 sums."""
    forward = Dense.forward
    Dense.forward = lambda self, x: x @ self.kernel + self.bias
    try:
        yield
    finally:
        Dense.forward = forward


def phase_train(dev, cfg=TRAIN_CFG, *, n_items=N_ITEMS, batch=TRAIN_BATCH,
                warm=TRAIN_WARM, steps=TRAIN_STEPS, chunk=BWD_PLAIN_CHUNK,
                profile=True) -> dict:
    """Seqrec training steps at full width; the caller counts launches."""
    rng = np.random.default_rng(SEED + 4)
    x = torch.from_numpy(seq_histories(rng, batch, cfg.max_len,
                                       n_items)).to(dev)
    tokens = int((x[:, 1:] > 0).sum())
    tree = init_params(n_items, cfg, SEED)
    net = SeqRec(n_items, cfg).load_flax(tree).to(dev)
    compare = step_compare(dev, net, x, chunk=chunk, grad_tol=STEP_GRAD_TOL,
                           what="training step")
    with f32_dense():
        compare_f32 = step_compare(dev, net, x, chunk=chunk,
                                   grad_tol=STEP_GRAD_TOL_F32,
                                   what="training step with f32 Dense layers")
    reset_launches()
    opt = torch.optim.Adam(net.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                           eps=1e-8)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = seq_rec_loss(net, x)
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [float(step()) for _ in range(warm)]
    per_step = dict(kernels.LAUNCHES)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            loss = step()
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    per_step = {key: (kernels.LAUNCHES[key] - per_step[key]) / steps
                for key in ("flash_attention", "flash_attention_bwd_dkv",
                            "flash_attention_bwd_dq")}
    check(all(n == cfg.num_blocks for n in per_step.values()),
          f"launches per step {per_step}, want {cfg.num_blocks} of each")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"training losses not finite and falling: {losses}")
    rec = {"config": {"max_len": cfg.max_len, "embed_dim": cfg.embed_dim,
                      "num_heads": cfg.num_heads,
                      "num_blocks": cfg.num_blocks, "n_items": n_items,
                      "batch": batch},
           "compare": compare, "compare_f32_dense": compare_f32,
           "target_tokens": tokens,
           "launches_per_step": per_step,
           "step_ms": times, "step_ms_median": statistics.median(times),
           "tokens_per_s": tokens / (statistics.median(times) / 1e3),
           "losses": losses}
    if dev.type == "cuda":
        rec["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if profile:
        busy, wall = device_profile(step)
        rec["profiled_step_wall_ms"] = wall * 1e3
        rec["device_ms_by_kernel"] = dict(sorted(
            busy.items(), key=lambda kv: -kv[1])[:12])
        rec["profiled_step_device_ms"] = sum(busy.values())
    return rec


def cyclic_events(n_users=32, n_items=6, hist=12):
    """User u's history cycles items (u % k, u%k+1, ...): the fixture of
    tests/test_parallel_seq.py."""
    users = [f"u{u}" for u in range(n_users) for _ in range(hist)]
    items = [f"i{(u + t) % n_items}" for u in range(n_users)
             for t in range(hist)]
    times = [float(t) for _ in range(n_users) for t in range(hist)]
    return (np.asarray(users, dtype=object), np.asarray(items, dtype=object),
            np.asarray(times))


class CyclicEvents(DataSource):
    """An in-memory data source (the event store comes with the storage
    slice)."""

    def read_training(self, ctx):
        return seqrec_engine.TrainingData(*cyclic_events())


def phase_train_template(dev) -> dict:
    """The cyclic fixture through the port's Engine.train and seqrec
    template on ``dev``, then served: u0 last saw i5, so its next is i0."""
    engine = seqrec_engine.engine_factory()
    engine.data_source_classes = {"": CyclicEvents}
    ep = EngineParams(algorithm_params_list=(
        ("seqrec", seqrec_engine.AlgorithmParams(**CYCLE_PARAMS)),))
    ctx = Context(device=dev)
    t0 = time.perf_counter()
    result = engine.train(ctx, ep)
    train_s = time.perf_counter() - t0
    model = result.models[0]
    check(model.device is not None and model.device.type == dev.type,
          f"trained seqrec model not on {dev.type}")
    top = model.recommend_products("u0", 2, exclude_seen=False)
    check(bool(top) and top[0][0] == "i0",
          f"the trained cyclic model recommends {top} to u0, want i0 first")
    return {"params": CYCLE_PARAMS, "train_s": train_s, "u0_top": top,
            "phases": [[p, dt] for p, dt in ctx.phase_times]}


# -- main ---------------------------------------------------------------


def kernel_record(name: str, launches: int, case: dict, *,
                  source=KERNEL_SOURCE, replaces=REPLACES) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"]}


class Clock:
    """Prints each phase's wall seconds as it ends."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"[time] phase {phase}: {now - self.t:.1f} s", flush=True)
        self.t = now


def reset_launches() -> None:
    for key in kernels.LAUNCHES:
        kernels.LAUNCHES[key] = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = resolve_device(None)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    print(f"[device] {name} | nvidia-smi: {smi} | kernel build "
          f"{build_s:.2f} s | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(smi, flush=True)

    clock = Clock()
    recs = phase_kernels(dev)
    clock.lap("2 topk kernels")
    for r in recs:
        print("[kernel] " + json.dumps(r), flush=True)
    print(f"[kernel] {len(recs)} fixtures match the plain versions "
          f"(max |err| {max(r['max_abs_err'] for r in recs):.3g}, "
          f"tie fixtures bitwise)", flush=True)
    torch.cuda.empty_cache()

    # the ALS path: deploy (which prewarms) and serve, counted from zero
    reset_launches()
    server = build_server(dev)
    serving = phase_serving(dev, server)
    launches = dict(kernels.LAUNCHES)
    check(launches["topk"] > 0 and launches["topk_rows"] > 0,
          f"a kernel of the ALS serving path never launched: {launches}")
    print("[serving] " + json.dumps({**serving, "launches": launches,
                                     "card": smi}), flush=True)
    del server
    torch.cuda.empty_cache()
    clock.lap("3 ALS serving")

    attn = phase_attention(dev)
    clock.lap("4 attention kernel")
    print(f"[attention] {len(attn)} fixtures match blockwise_attention "
          f"(max |err| f32 "
          f"{max(r['max_abs_err'] for r in attn if r['dtype'] == 'float32'):.3g}"
          f", bf16 "
          f"{max(r['max_abs_err'] for r in attn if r['dtype'] == 'bfloat16'):.3g})",
          flush=True)

    # the seqrec path: deploy (which prewarms) and serve, counted from zero
    reset_launches()
    t0 = time.perf_counter()
    seq_server = build_seq_server(dev)
    deploy_s = time.perf_counter() - t0
    seq_serving = phase_seq_serving(dev, seq_server)
    seq_launches = dict(kernels.LAUNCHES)
    check(seq_launches["flash_attention"] > 0,
          f"the attention kernel never launched on the seqrec path: "
          f"{seq_launches}")
    print("[seqrec] " + json.dumps({
        **seq_serving, "deploy_s": deploy_s,
        "warmed": seq_server.deployed.warmed, "launches": seq_launches,
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
        "card": smi}), flush=True)
    del seq_server
    torch.cuda.empty_cache()
    print("[seqrec-template] " + json.dumps(phase_seq_template(dev)),
          flush=True)
    clock.lap("5 seqrec serving")

    bwd = phase_attention_bwd(dev)
    clock.lap("6a attention backward kernels")
    print(f"[attention-bwd] {len(bwd)} fixtures match "
          f"blockwise_attention_bwd (largest error "
          f"{max(r[f'{g}_rel_err'] for r in bwd for g in ('dq', 'dk', 'dv')):.3g}"
          f" of a gradient's largest magnitude)", flush=True)

    # the seqrec training path: full-width steps, then the template trained
    # and served, counted from zero (phase_train resets the counts after
    # its kernel-vs-plain step)
    train = phase_train(dev)
    train["card"] = smi
    torch.cuda.empty_cache()
    template = phase_train_template(dev)
    train_launches = dict(kernels.LAUNCHES)
    check(all(train_launches[key] > 0 for key in (
        "flash_attention", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq")),
          f"an attention kernel never launched on the training path: "
          f"{train_launches}")
    print("[train] " + json.dumps(train), flush=True)
    print("[train-template] " + json.dumps({**template,
                                            "launches": train_launches}),
          flush=True)
    clock.lap("6b-c seqrec training")

    by_case = {r["case"]: r for r in recs}
    by_attn = {r["case"]: r for r in attn}
    tb = {r["case"]: r for r in bwd}[TRAIN_CASE]
    bwd_records = []
    for entry, key, grads in (("flash_attention_bwd_dkv", "dkv", ("dk", "dv")),
                              ("flash_attention_bwd_dq", "dq", ("dq",))):
        bwd_records.append(kernel_record(entry, train_launches[entry], {
            "max_abs_err": max(tb[f"{g}_max_abs_err"] for g in grads),
            "ms": tb[f"{key}_ms"], "plain_ms": tb["plain_ms"],
            "bound_ms": tb[f"{key}_bound_ms"],
            "bound_by": tb[f"{key}_bound_by"],
            "library_ms": tb["library_ms"]},
            source=BWD_SOURCE, replaces=BWD_REPLACES[entry]))
    print(json.dumps({"kernels": [
        kernel_record("topk", launches["topk"],
                      by_case["ml20m B=128 k=10"]),
        kernel_record("topk_rows", launches["topk_rows"],
                      by_case["ml20m rows B=8 k=20"]),
        kernel_record("flash_attention", seq_launches["flash_attention"],
                      by_attn[SERVING_CASE], source=FLASH_SOURCE,
                      replaces=FLASH_REPLACES),
        *bwd_records,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
