"""Chip smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Runs on one CUDA card and exits non-zero on any failure (and at once when
no card is visible). It imports nothing of JAX or of ``predictionio_tpu``.

1. Device: the card's name, ``nvidia-smi``'s name and power limit, and the
   time to build the kernels (``predictionio_tpu_torch/csrc/topk.cu`` and
   ``csrc/flash_attn.cu``, one ``nvcc`` each, in parallel) from the
   checkout's sources, with the native host library
   (``predictionio_tpu_torch/native/pio_native.cpp``, g++) built beside
   them; the run fails if the library did not build.
2. Kernel vs plain on the card: ``topk`` and ``topk_rows`` against their
   plain PyTorch versions (``topk_reference`` / ``topk_rows_reference``) on
   the ML-20M catalog (27,136 x 128 padded f32) for B in {1, 8, 64, 128}
   and k in {10, 64, 1000}, and on both sides of stage 1's switch (k 32:
   the warp selection; k 40: the warp sort) at B 8 and 32; k 256 and 264
   (kc 256 on both sides of it) at B 8 and 128; k 7000 at B 8 (lists
   too long for shared memory merge from the workspace); a one-chunk
   catalog (200
   rows, k 40); a 5-row catalog; n_total off the 512-row tile and off a
   256-row chunk (2,049 rows, B 20, k 32); tie fixtures at k 10, 32 and
   200 (bitwise); the gather variant with unknown rows at B 8, 16 and
   128, and at B 8 with k 100; and one unpacked case past 2^24 rows (an
   8.6 GB catalog). Values agree within rtol 1e-5 / atol 1e-5 (the two
   sum in different orders) and every returned id's plain score equals
   the plain value at its rank; median times of the kernel, the plain
   version and ``torch.topk(q @ items.T, k)``, and device time by kernel
   (stage 1 against the merge rounds) at ``topk`` B 128 (k 10, 64, 1000)
   and ``topk_rows`` B 8 (k 20, 100) and 128. Stage 1's ``topk_sort`` at
   ``topk_rows`` B 8 k 100 (phase 3b's shape) and B 128 k 64, and the
   merge at ``topk_rows`` B 8 k 20 (two ``topk_merge_round`` launches) are
   each timed beside a plain version of their own (the kernel's 64-bit
   keys in torch: each chunk's sorted best, then a sort of the row's
   lists, whose decoded result must equal ``topk_reference``) and
   ``torch.topk``.
3. Serving: an ML-20M-shaped ALS model (138,493 x 64 users, 26,744 x 64
   items, seeded random factors / sqrt(64)) deployed through the port's
   template, ``Deployed`` (prewarm on) and ``EngineServer``, behind
   ``serve()`` on 127.0.0.1; 16 sequential HTTP queries, then 256 sent at
   once by 64 client threads in 4 client processes (num in {1, 4, 10, 20},
   a few unknown users), each answer equal to a host numpy exact top-k;
   the kernel's launch counter moves with the batches; wall p50/p99, qps,
   and the device's busy share over a second, profiled burst.
   3b. The same server at num 100 (k_pad 104: ``topk_sort``): 64 queries
   at once from 4 client processes, each answer equal to the host's exact
   top-100, one ``topk_rows`` launch a batch; a second, profiled burst
   must show ``topk_sort`` and the merge rounds among its kernels.

4. Attention kernel vs plain on the card: ``flash_attention``
   (``csrc/flash_attn.cu``) against ``blockwise_attention`` at the seqrec
   attention shapes (B4 L4096 H8 D64 causal, bf16 and f32; B1 L16384 H8
   D64 causal bf16), the serving shapes of phase 5 (B8 and B128, L4096 H8
   D64 causal f32), the shipped template's head dim (B8 L64 H2 D24), D128
   L128, D256 L2048, and an unaligned L25, causal and not; then three head
   dims through the dispatch, each asserting from the launch count that the
   kernel ran: D10 (B2 L200 H4, padded to 16), D136 (B2 L200 H2, padded to
   256) and D256 (B2 L256 H2), f32 and bf16, causal. Max |err| within 1e-5
   for f32 (summation order) and 2**-7 for
   bf16 (two bf16 steps at |o| ~ 1); median device times of the kernel,
   the plain version (run in batch chunks so its [B, H, L, block] scores
   fit) and, as a yardstick the port never calls,
   ``scaled_dot_product_attention``.
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
   equal (no atomics, a fixed summation order); and phase 4's D10, D136
   and D256 fixtures through ``flash_attention`` under autograd, the launch
   counts showing that all three kernels ran once, the output bitwise equal
   to the serving forward's and held with the gradients against the plain
   versions at the original D; median device times
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

7. ALS training. (a) Blocked WALS at the ML-20M shape: 20M ratings from
   ``synth_ml20m`` (a copy of bench.py's) over 138,493 users x 26,744
   items at rank 64, λ 0.1, nothing cut; the data seconds, the layout's
   seconds on the native host library and on the numpy path (the library
   switched off in-process), the two layouts equal array for array, then
   two steps from the same state, which must be bitwise equal, one
   warm-up and 10 timed ``make_train_step`` iterations at float32, then
   at bfloat16 (iterations/s each), one profiled iteration split into
   gather+gramian, the chunked tier's segment sums and the solve, beside
   their bounds, and the peak device memory. (b) A cholesky half-step
   each way at full width against host float64 solves for 512 sampled
   users and 512 sampled items (the chunked tier's owners among them),
   within 1e-4 relative a row; CG's gap reported. (c) is the bitwise
   check of (a). (d) ``bench.py::accuracy_gate`` copied: 200k ratings,
   seed 3, rank 64, 3 iterations, cholesky f32 against CG at float32 and
   at bfloat16, each RMSE gap ≤ 1e-3. (e) The ML-20M ratings trained
   through the recommendation template's ``Engine.train`` (rank 64, 10
   iterations) from an in-memory data source, deployed through
   ``Deployed`` and ``EngineServer`` behind ``serve()``, and served: 16
   sequential and 48 concurrent HTTP queries, each answer equal to a host
   exact top-k, ``topk_rows`` launched.

8. Events to answers: SQLite storage under a temp dir for metadata,
   events and models; the reference's e2e quickstart shape
   (``bench.py:686-760``): 200,000 ``rate`` events over 5,000 users x
   2,000 items in steps of 0.5, plus 10,000 ``buy`` events, written with
   ``insert_batch``; ``run_train`` with the template's own
   ``templates/recommendation/engine.json`` (rank 10, 10 iterations, λ
   0.01, seed 3, no init hook), twice, the two blobs' factors bitwise
   equal; ``EngineServer`` built from the newest COMPLETED instance behind
   ``serve()``: 16 sequential queries, each against a host exact top-N of
   the stored factors, ``topk_rows`` launched; a retrain (seed 4) and
   ``GET /reload`` switches the served instance; a third (seed 5) whose
   blob is then corrupted in the models table is skipped by the next
   ``/reload`` while serving goes on; device memory after the third
   reload within one bundle's bytes of its value after the first. Stage
   seconds (insert, find_frame, layout, iterations, persist, deploy, first
   answer) print beside the card's name and power limit.

9. The CLI quickstart: phase 8's events as a JSONL file under a temp
   ``PIO_HOME``, then the port's ``pio`` verbs in this process
   (``tools.cli.main``): ``app new``, ``import``, ``template get
   recommendation``, ``build``, ``train`` (the template's own engine.json),
   ``deploy`` on a thread and a free port, 16 queries over HTTP each
   against the stored blob's host exact top-N (phase 8's check), an
   unknown user (empty) and a malformed query (400), ``topk_rows``
   launched in the deployed server; a second ``train`` and ``GET
   /reload`` switch the instance; ``batchpredict`` of 64 queries checked
   the same way; ``undeploy`` ends the deploy thread; ``export`` gives as
   many lines as were imported. Then ``eventserver`` on a thread takes
   100 single and 500 batched posts, reads them back and counts them in
   ``/stats.json``, and ``python3 -m predictionio_tpu_torch.tools.cli
   status`` runs as a subprocess: exit 0, the card listed, and no jax in
   its ``-X importtime`` list. Stage seconds (import, train, deploy to
   first answer, batchpredict, the event server's posts) print beside the
   card's name and power limit.

The ALS path (phase 3) and its num-100 path (phase 3b), the seqrec
serving path (phase 5), the seqrec training path (phase 6 b and c), the
trained ALS model's serving path (phase 7e), the storage-deployed path
(phase 8) and the deployed server of the CLI quickstart (phase 9) are
each driven with every launch count set to 0 just before and read just
after. Before the last line it prints one JSON object with a record per
kernel entry point, and for top-k's ``topk_sort`` (its launches in phase
3b) and merge rounds (``topk_merge_round``, its launches in phase 3):
launches on its main path, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import os
import socket
import sqlite3
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import torch

from predictionio_tpu_torch import native
from predictionio_tpu_torch import storage as pio_storage
from predictionio_tpu_torch.controller import (DataSource, EngineParams,
                                               FirstServing, TrainResult)
from predictionio_tpu_torch.convert import (als_model_from_numpy,
                                            als_train_state_from_numpy,
                                            seqrec_model_from_numpy)
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.models.als import (ALSConfig, make_train_step,
                                               train_als)
from predictionio_tpu_torch.models.seq_attention import (
    Dense, SeqRec, SeqRecConfig, SeqRecModel, init_params, seq_rec_loss)
from predictionio_tpu_torch.obs.metrics import METRICS
from predictionio_tpu_torch.ops import kernels
from predictionio_tpu_torch.ops.neighbors import build_bilinear_layout
from predictionio_tpu_torch.ops.pipeline import _capacity
from predictionio_tpu_torch.ops.retrieval import (
    PACKED_IDX_LIMIT, _pad_items, _query_shapes, topk_reference,
    topk_rows_reference)
from predictionio_tpu_torch.parallel.ring_attention import (
    attention_di, blockwise_attention, blockwise_attention_bwd,
    flash_attention)
from predictionio_tpu_torch.storage.bimap import BiMap
from predictionio_tpu_torch.storage.frame import Ratings
from predictionio_tpu_torch.templates.recommendation.engine import (
    ALSAlgorithm, AlgorithmParams, TrainingData, engine_factory)
from predictionio_tpu_torch.templates.seqrec import engine as seqrec_engine
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow import core_workflow
from predictionio_tpu_torch.workflow.context import Context
from predictionio_tpu_torch.workflow.create_server import EngineServer, serve
from predictionio_tpu_torch.workflow.serialization import deserialize_models

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
# ALS training (phase 7): bench.py's ML-20M shape (bench.py:28-29), 20M
# ratings, λ 0.1, one warm-up and 10 timed iterations a compute dtype
N_RATINGS, ALS_LAMBDA, ALS_TIMED = 20_000_000, 0.1, 10


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


def stage_ms(fn, iters: int = 20) -> dict:
    """Device ms per call of ``fn`` by kernel name, under the profiler."""
    busy, _ = device_profile(lambda: [fn() for _ in range(iters)])
    return {k: v / iters for k, v in busy.items()}


def kernel_ms(stages: dict, name: str) -> float:
    """The device ms of the kernels whose names hold ``name``."""
    return sum(v for k, v in stages.items() if name in k)


#: the sign bit of an int64: flipping it orders csrc/topk.cu's unsigned
#: 64-bit keys as signed ones
KEY_FLIP = torch.iinfo(torch.int64).min


def plain_keys(scores: torch.Tensor, n_total: int) -> torch.Tensor:
    """csrc/topk.cu's keys of a [B, N_pad] f32 score matrix (columns at or
    past n_total -inf, -0.0 as +0.0), in int64 with the sign bit flipped,
    so that torch's signed order is the keys' order."""
    n = scores.shape[1]
    col = torch.arange(n, device=scores.device)
    s = scores.masked_fill(col >= n_total, float("-inf")) + 0.0
    u = s.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    return ((u << 32) | (~col & 0xFFFFFFFF)) ^ KEY_FLIP


def decode_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores f32, ids int32, -1 where the score is not finite) of
    ``plain_keys``' keys: the kernel's epilogue."""
    k = keys ^ KEY_FLIP
    u = (k >> 32) & 0xFFFFFFFF
    u = torch.where(u >= 0x80000000, u & 0x7FFFFFFF, ~u & 0xFFFFFFFF)
    vals = u.to(torch.int32).view(torch.float32)
    ids = (~k & 0xFFFFFFFF).to(torch.int32)
    return vals, torch.where(torch.isfinite(vals), ids, -1)


def chunk_lists(keys: torch.Tensor, k_pad: int) -> torch.Tensor:
    """Stage 1's plain version: each 256-row chunk's best min(k_pad, 256)
    keys, sorted descending, [B, n_chunks * kc]."""
    b, n = keys.shape
    return keys.view(b, n // 256, 256).topk(min(k_pad, 256), dim=2).values \
        .reshape(b, -1)


def merge_case(name, q, items, n_total, call: dict) -> dict:
    """The merge rounds against their plain version (a full sort of the
    row's chunk lists) and ``torch.topk`` of the same keys, at the shape of
    the timed fixture ``call`` (its ``stage_ms`` split gives the rounds'
    device time). The plain keys decoded equal ``topk_reference``."""
    k_pad = call["k_pad"]
    scores = q @ items.T
    lists = chunk_lists(plain_keys(scores, n_total), k_pad)
    plain = lambda: torch.sort(lists, dim=1,  # noqa: E731
                               descending=True).values[:, :k_pad]
    vals, ids = decode_keys(plain())
    ref = topk_reference(q, items, n_total, k_pad)
    check(torch.equal(vals, ref[0]) and torch.equal(ids, ref[1]),
          "the plain merge of the plain keys differs from topk_reference")
    scores = scores.masked_fill(
        torch.arange(items.shape[0], device=items.device) >= n_total,
        float("-inf"))
    err = compare(kernels.topk(q, items, n_total, k_pad), (vals, ids),
                  scores, k_pad, bitwise=False)
    del scores
    b, n_keys = lists.shape
    nbytes = 8 * b * n_keys + 4 * b * 2 * k_pad
    return {"case": name, "b_pad": b, "n_pad": int(items.shape[0]),
            "k_pad": k_pad, "packed": True, "max_abs_err": err,
            "ms": kernel_ms(call["stage_ms"], "topk_merge"),
            "plain_ms": device_ms(plain),
            "library_ms": device_ms(lambda: torch.topk(lists, k_pad)),
            "bound_ms": nbytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes"}


def stage1_record(call: dict, q, items, n_total: int) -> dict:
    """Stage 1 (``topk_sort`` at k_pad > 32) at the timed fixture ``call``
    of queries ``q`` (a ``topk_rows`` fixture's gathered rows): its device
    time from the ``stage_ms`` split, its plain version
    (the scores, the keys and each chunk's sorted best, ``chunk_lists``)
    and ``torch.topk`` of each chunk's scores; the bound reads the queries
    and the catalog, writes the lists and does 2*B*N*D f32 FLOP."""
    k_pad = call["k_pad"]
    b, n = call["b_pad"], call["n_pad"]
    dim = int(items.shape[1])
    plain = lambda: chunk_lists(  # noqa: E731
        plain_keys(q @ items.T, n_total), k_pad)
    library = lambda: torch.topk(  # noqa: E731
        (q @ items.T).view(b, n // 256, 256), min(k_pad, 256), dim=2)
    nbytes = 4 * (b * dim + n * dim) + 8 * b * (n // 256) * min(k_pad, 256)
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = 2 * b * n * dim / PEAK_F32_FLOP_S
    return {"max_abs_err": call["max_abs_err"],
            "ms": kernel_ms(call["stage_ms"], "topk_sort"),
            "plain_ms": device_ms(plain), "library_ms": device_ms(library),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
    if timing:
        # where the full plain-entry batch (b_pad 128) spends its device
        # time, by kernel: k_pad 16 (topk_select), 64 and 1000 (topk_sort)
        for rec in recs[-3:]:
            rec["stage_ms"] = stage_ms(lambda rec=rec: kernels.topk(
                q, items, n_items, rec["k_pad"]))
        recs[-2]["stage1"] = stage1_record(recs[-2], q, items, n_items)
    # both sides of the stage-1 switch (k_pad <= 32: warp selection, else
    # the warp sort) at QT 8 and QT 32; a generator of their own keeps
    # the other fixtures' data as it was
    rng2 = np.random.default_rng(SEED + 1)
    for b in (8, 32):
        q = padded_queries(rng2, b, rank, items.shape[1], dev, scale)
        for k in (32, 40):
            recs.append(kernel_case(f"ml20m B={b} k={k}", q, items, n_items,
                                    k))
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
    recs.append(kernel_case("ml20m rows B=16 k=20", qtab, items, n_items,
                            20, rows=rows[:16].contiguous().to(dev)))
    # num 100 at the 8-row bucket (k_pad 104: topk_sort), as phase 3b sends
    recs.append(kernel_case("ml20m rows B=8 k=100", qtab, items, n_items,
                            100, rows=rows[4:12].contiguous().to(dev),
                            timing=timing))
    if timing:
        # where one serving-shape call spends its device time, by kernel
        for rec, sel in ((recs[-4], rows), (recs[-3], rows[4:12]),
                         (recs[-1], rows[4:12])):
            sel = sel.contiguous().to(dev)
            rec["stage_ms"] = stage_ms(lambda rec=rec, sel=sel: (
                kernels.topk_rows(sel, qtab, items, n_items, rec["k_pad"])))
        # topk_sort at phase 3b's shape, and the merge rounds at the 8-row
        # bucket, against their plain versions
        rows8 = rows[4:12].contiguous().to(dev)
        ok = (rows8 >= 0) & (rows8 < qtab.shape[0])
        q8 = qtab[torch.where(ok, rows8, 0).long()].masked_fill(
            ~ok[:, None], 0.0)
        recs[-1]["stage1"] = stage1_record(recs[-1], q8, items, n_items)
        recs.append(merge_case("merge rows B=8 k=20", q8, items, n_items,
                               recs[-3]))
    del qtab
    # a 5-row catalog with k > N, and n_total off the 512 tile
    small = padded_catalog(rng, 5, 24, dev)
    recs.append(kernel_case("5 rows k=20", padded_queries(
        rng, 3, 24, small.shape[1], dev), small, 5, 20))
    odd = padded_catalog(rng, 1000, 32, dev)
    recs.append(kernel_case("n_total=1000 k=10", padded_queries(
        rng, 3, 32, odd.shape[1], dev), odd, 1000, 10))
    odd = padded_catalog(rng2, 2049, 128, dev)
    recs.append(kernel_case("n_total=2049 B=20 k=32", padded_queries(
        rng2, 20, 128, odd.shape[1], dev), odd, 2049, 32))
    # ties: integer-valued factors, duplicated rows and a zero query
    base = rng.integers(-3, 4, (1400, 24)).astype(np.float32)
    tie = np.concatenate([base, base[:136]], axis=0)
    tied, _ = _pad_items(tie, len(tie), 512)
    tq = np.zeros((8, tied.shape[1]), np.float32)
    tq[1:6, :24] = rng.integers(-3, 4, (5, 24))
    for k in (10, 32, 200):
        recs.append(kernel_case(f"ties k={k}", torch.from_numpy(tq).to(dev),
                                torch.from_numpy(tied).to(dev), len(tie), k,
                                bitwise=True))
    # kc 256 on both sides of k 256 (two merge rounds at b_pad 8 and 128),
    # and a one-chunk catalog (one list, one round); a generator of their
    # own
    rng3 = np.random.default_rng(SEED + 2)
    for b in (8, 128):
        q = padded_queries(rng3, b, rank, items.shape[1], dev, scale)
        for k in (256, 264):
            recs.append(kernel_case(f"ml20m B={b} k={k}", q, items, n_items,
                                    k))
    # k 7000: lists past 6,144 keys merge in pairs from the workspace
    # (six rounds, the last two topk_merge_round<false>)
    q = padded_queries(rng3, 8, rank, items.shape[1], dev, scale)
    recs.append(kernel_case("ml20m B=8 k=7000", q, items, n_items, 7000))
    one = padded_catalog(rng3, 200, rank, dev, scale)
    recs.append(kernel_case("n_total=200 B=8 k=40", padded_queries(
        rng3, 8, rank, one.shape[1], dev, scale), one, 200, 40))
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


def phase_wide_serving(dev, server, *, n_conc=64, num=100, procs=4,
                       threads=16) -> dict:
    """Phase 3b: ``n_conc`` queries at ``num`` (k_pad 104: stage 1 is
    ``topk_sort``) sent at once to phase 3's server, each answer the host's
    exact top-``num``; then the same burst under the profiler, which must
    show ``topk_sort`` and the merge (``topk_merge_round``)."""
    model = server.deployed.result.models[0]
    users, items = model.user_factors, model.item_factors
    rng = np.random.default_rng(SEED + 3)
    queries = [{"user": f"u{int(rng.integers(0, len(users)))}", "num": num}
               for _ in range(n_conc)]
    with serve(server, "127.0.0.1", 0) as front:
        url = f"http://127.0.0.1:{front.port}/queries.json"
        b = server.batcher
        batches0 = b.batches
        dispatches0 = model._pipeline.stats()["dispatches"]
        answers, span = burst(url, queries, procs, threads)
        for qj, (body, _wall) in zip(queries, answers):
            host_check(body, qj, users, items)
        batches = b.batches - batches0
        launches = kernels.LAUNCHES["topk_rows"]
        dispatches = model._pipeline.stats()["dispatches"] - dispatches0
        prof_answers = []
        busy, prof_s = device_profile(lambda: prof_answers.extend(
            burst(url, queries, procs, threads)[0]))
        for qj, (body, _wall) in zip(queries, prof_answers):
            host_check(body, qj, users, items)
    check(launches == dispatches == batches,
          f"{launches} topk_rows launches for {batches} batches at num "
          f"{num} ({dispatches} pipeline dispatches)")
    seen = {name: sum(v for k, v in busy.items() if name in k)
            for name in ("topk_select", "topk_sort", "topk_merge")}
    check(seen["topk_sort"] > 0 and seen["topk_merge"] > 0,
          f"the profiled num-{num} burst ran no topk_sort or no merge round:"
          f" {sorted(busy)}")
    walls_ms = np.array([w for _body, w in answers]) * 1e3
    return {"queries": n_conc, "num": num, "batches": batches,
            "topk_rows_launches": launches,
            "wall_p50_ms": float(np.percentile(walls_ms, 50)),
            "wall_p99_ms": float(np.percentile(walls_ms, 99)),
            "qps_concurrent": n_conc / span, "clients": procs * threads,
            "kernel_device_ms": seen,
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
    ("D256 B2 L2048 H4 causal f32", 2, 2048, 4, 256, "float32", True),
    ("D256 B2 L2048 H4 causal bf16", 2, 2048, 4, 256, "bfloat16", True),
    ("unaligned B2 L25 H2 D64 causal f32", 2, 25, 2, 64, "float32", True),
    ("unaligned B2 L25 H2 D64 full f32", 2, 25, 2, 64, "float32", False),
    ("unaligned B2 L25 H2 D64 causal bf16", 2, 25, 2, 64, "bfloat16", True),
    ("unaligned B2 L25 H2 D64 full bf16", 2, 25, 2, 64, "bfloat16", False),
]
#: head dims through the dispatch, which pads them for the kernels (D 10 to
#: 16, D 136 to 256) or gives them as they are (D 256); phases 4 and 6a
HEAD_DIM_CASES = [
    (f"{case} causal {tag}", B, L, H, D, dtype, True)
    for case, B, L, H, D in (("head dim D10 B2 L200 H4", 2, 200, 4, 10),
                             ("head dim D136 B2 L200 H2", 2, 200, 2, 136),
                             ("head dim D256 B2 L256 H2", 2, 256, 2, 256))
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16"))
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
    launches0 = kernels.LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, causal=causal)
    launches = kernels.LAUNCHES["flash_attention"] - launches0
    # every head dim here reaches the kernel (padded where it must be); a
    # CPU tensor runs the plain version and launches nothing
    want_launches = int(dev.type == "cuda")
    check(launches == want_launches,
          f"{name}: {launches} kernel launches, want {want_launches}")
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
           "causal": causal, "max_abs_err": err, "tol": tol,
           "kernel_launches": launches}
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


def phase_attention(dev, cases=ATTN_CASES + HEAD_DIM_CASES, *,
                    timing=True) -> list:
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


def head_dim_bwd_case(dev, name, B, L, H, D, dtype, causal) -> dict:
    """A head dim through the dispatch the model trains with
    (``flash_attention`` under autograd): the launch counts show the three
    kernels ran once each (on the padded tensors at D 10 and 136); the
    output with the logsumexp is bitwise equal to the serving forward's,
    and held with the gradients against the plain versions at the original
    D, as ``bwd_case`` holds the kernels."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7 * B * L + D)
    q, k, v, do = (torch.randn(B, L, H, D, generator=gen, device=dev)
                   .mul_(0.5).to(dt) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(kernels.LAUNCHES)
    o = flash_attention(*leaves, causal=causal)
    grads = torch.autograd.grad(o, leaves, do)
    moved = {key: kernels.LAUNCHES[key] - before[key] for key in before}
    n = int(dev.type == "cuda")
    want_moved = {"topk": 0, "topk_rows": 0, "topk_select": 0,
                  "topk_sort": 0, "topk_merge": 0, "flash_attention": n,
                  "flash_attention_bwd_dkv": n, "flash_attention_bwd_dq": n}
    check(moved == want_moved,
          f"{name}: launches {moved}, want {want_moved}")
    o = o.detach()
    with torch.inference_mode():
        served = flash_attention(q, k, v, causal=causal)
    check(torch.equal(o, served), f"{name}: the training forward's output "
          "differs from the serving forward's")
    ref_o, ref_lse = chunked_blockwise_lse(q, k, v, causal=causal)
    o_err, o_tol = float((o.float() - ref_o.float()).abs().max()), ATTN_TOL[dt]
    check(o.dtype == dt and o.shape == q.shape
          and bool(torch.allclose(o.float(), ref_o.float(), rtol=o_tol,
                                  atol=o_tol)),
          f"{name}: the training forward disagrees with blockwise_attention "
          f"(max |err| {o_err:.3g}, tolerance {o_tol:.3g})")
    want = chunked_bwd(q, k, v, ref_o, ref_lse, do, causal=causal)
    tol = BWD_TOL[dt]
    rec = {"case": name, "shape": [B, L, H, D], "dtype": dtype,
           "causal": causal, "o_max_abs_err": o_err, "tol": tol,
           "launches": moved, "serving_bitwise": True}
    for key, got, w in zip(("dq", "dk", "dv"), grads, want):
        check(got.dtype == dt and got.shape == q.shape
              and bool(torch.isfinite(got).all()),
              f"{name}: {key} {got.dtype} {tuple(got.shape)} or not finite")
        rec[f"{key}_max_abs_err"] = float((got.float() - w.float()).abs().max())
        rec[f"{key}_rel_err"] = rel_err(got, w)
        check(rec[f"{key}_rel_err"] <= tol,
              f"{name}: {key} disagrees with blockwise_attention_bwd "
              f"({rec[f'{key}_rel_err']:.3g} of its largest magnitude, "
              f"tolerance {tol:.3g})")
    return rec


def phase_attention_bwd(dev, cases=BWD_CASES, head_dim_cases=HEAD_DIM_CASES,
                        *, timing=True) -> list:
    recs = []
    for case in cases:
        recs.append(bwd_case(dev, *case, timing=timing))
        print("[attention-bwd] " + json.dumps(recs[-1]), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for case in head_dim_cases:
        recs.append(head_dim_bwd_case(dev, *case))
        print("[attention-bwd] " + json.dumps(recs[-1]), flush=True)
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


# -- phase 7 ------------------------------------------------------------


def synth_ml20m(n: int, seed: int = 0, *, n_users=N_USERS, n_items=N_ITEMS):
    """ML-20M-shaped synthetic ratings, copied from ``bench.py::synth_ml20m``
    (bench.py:118-130): zipf item popularity truncated at ML-20M's real max
    item degree (~67k ratings for the top movie), uniform user activity,
    ratings in [0.5, 5]."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    pop = 1.0 / ranks**0.9
    pop = np.minimum(pop / pop.sum(), 67_000 / N_RATINGS)
    pop /= pop.sum()
    items = rng.choice(n_items, size=n, p=pop).astype(np.int32)
    users = rng.integers(0, n_users, n).astype(np.int32)
    vals = (np.round(rng.random(n) * 9 + 1) / 2).astype(np.float32)
    return users, items, vals


def als_ratings(users, items, vals, n_users: int, n_items: int) -> Ratings:
    return Ratings(
        user_indices=users.astype(np.int64), item_indices=items.astype(np.int64),
        ratings=vals, user_ids=BiMap({f"u{i}": i for i in range(n_users)}),
        item_ids=BiMap({f"i{j}": j for j in range(n_items)}))


def layout_digest(lay) -> str:
    """One sha256 over every array and scalar of one side of a bilinear
    layout: two sides with equal digests are equal array for array."""
    h = hashlib.sha256()

    def put(x) -> None:
        if isinstance(x, np.ndarray):
            h.update(f"{x.dtype}{x.shape}".encode())
            h.update(np.ascontiguousarray(x))
        else:
            h.update(repr(x).encode())

    put((lay.slots, lay.zero_slot, len(lay.buckets), len(lay.metas)))
    put(lay.pos)
    for b in lay.buckets:
        put((b.num_rows, b.max_degree, b.dropped))
        put(b.ids)
        put(b.vals)
    for m in lay.metas:
        put((m.span, m.seg is None))
        if m.seg is not None:
            put(m.seg)
    return h.hexdigest()


def ml20m_layout(n_ratings: int, n_users: int, n_items: int, rank: int):
    """Phase 7's synthetic ML-20M ratings, their bilinear layout (both
    sides) and the seconds the layout alone took."""
    users, items, vals = synth_ml20m(n_ratings, seed=0, n_users=n_users,
                                     n_items=n_items)
    cfg = ALSConfig(rank=rank, lambda_=ALS_LAMBDA)
    t0 = time.perf_counter()
    lay = build_bilinear_layout(
        users, items, vals, n_users, n_items, tiers=cfg.tiers,
        gather_budget=cfg.gather_budget, seed=cfg.seed,
        chunk_cap=cfg.chunk_cap)
    return (users, items, vals), lay, time.perf_counter() - t0


def numpy_layout_child() -> None:
    """Phase 7a's numpy layout, run in a process started with
    ``PIO_NO_NATIVE=1`` (every call site then takes its numpy path): prints
    one JSON line with the layout's seconds and both sides' digests."""
    n_ratings, n_users, n_items, rank = json.loads(sys.argv[1])
    _, lay, secs = ml20m_layout(n_ratings, n_users, n_items, rank)
    print(json.dumps({"native": native.available(), "layout_s": secs,
                      "digests": [layout_digest(side) for side in lay]}))


def numpy_layout(n_ratings: int, n_users: int, n_items: int,
                 rank: int) -> dict:
    """``numpy_layout_child`` in a fresh interpreter with the native
    library switched off by ``PIO_NO_NATIVE=1``."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.numpy_layout_child()",
         json.dumps([n_ratings, n_users, n_items, rank])],
        cwd=here, env={**os.environ, "PIO_NO_NATIVE": "1"},
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0,
          f"the numpy layout process failed:\n{proc.stderr[-4000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    check(got["native"] is False,
          "PIO_NO_NATIVE=1 did not switch the native library off")
    return got


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def layout_stats(lay) -> dict:
    return {"tiers": len(lay.metas),
            "chunked_tiers": sum(m.seg is not None for m in lay.metas),
            "chunk_rows": int(sum(b.padded_rows for b, m in
                                  zip(lay.buckets, lay.metas)
                                  if m.seg is not None)),
            "covered_rows": int(sum(m.span for m in lay.metas)),
            "padded_entries": int(sum(b.ids.size for b in lay.buckets)),
            "slots": int(lay.slots)}


#: the three parts of a half-step the split reads, by the module function
#: that computes each (``_solve_side`` looks them up at call time)
ALS_PARTS = {"gather+gramian": "_gram_blocks", "segment sums": "_segment_sum",
             "solve": "_spd_solve"}


@contextlib.contextmanager
def als_part_probes():
    """Wrap ``_gram_blocks``, ``_segment_sum`` and ``_spd_solve`` in a
    profiler range each (``als.<part>``)."""
    from torch.profiler import record_function

    saved = {part: getattr(als, fn) for part, fn in ALS_PARTS.items()}

    def probe(part, fn):
        def wrapped(*args, **kwargs):
            with record_function(f"als.{part}"):
                return fn(*args, **kwargs)
        return wrapped

    for part, fn in ALS_PARTS.items():
        setattr(als, fn, probe(part, saved[part]))
    try:
        yield
    finally:
        for part, fn in ALS_PARTS.items():
            setattr(als, fn, saved[part])


def als_step_split(dev, run) -> dict:
    """One iteration ``run()`` under the profiler with the part probes:
    device ms of each part (the kernel time under each ``als.<part>``
    range) and its five largest kernels, and the iteration's whole kernel
    time. On the CPU the profiler sees no device: the parts are None."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with als_part_probes(), profile(activities=acts) as prof:
        run()
        sync(dev)
    from torch.autograd import DeviceType

    events = prof.events()
    out = {"parts_ms": {}, "part_kernels_ms": {}}

    def kernels_under(e, acc):
        for k in e.kernels:
            acc[k.name] = acc.get(k.name, 0.0) + k.duration / 1e3
        for ch in e.cpu_children:
            kernels_under(ch, acc)
        return acc

    for part in ALS_PARTS:
        # a CPU range's device time is its children's kernel time
        out["parts_ms"][part] = (sum(
            e.device_time_total for e in events
            if e.name == f"als.{part}" and e.device_type == DeviceType.CPU)
            / 1e3 if dev.type == "cuda" else None)
        acc: dict = {}
        for e in events:
            if e.name == f"als.{part}" and e.device_type == DeviceType.CPU:
                kernels_under(e, acc)
        # the part's five largest kernels by device ms (names cut short)
        out["part_kernels_ms"][part] = [
            [name[:90], ms] for name, ms in
            sorted(acc.items(), key=lambda kv: -kv[1])[:5]]
    if dev.type == "cuda":
        out["kernel_ms"] = sum(
            e.device_time_total for e in events
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)) / 1e3
        out["other_ms"] = out["kernel_ms"] - sum(out["parts_ms"].values())
    return out


def als_bounds(u_lay, i_lay, rank: int, cg_iters: int, val_bytes: int) -> dict:
    """The least time (ms, at H100 SXM peaks) of each part of one
    iteration, as the torch ops compute it: gather+gramian writes the
    gathered f32 [B, D, R] blocks and reads them back for the products
    (2·entries·R² + 2·entries·R f32 FLOP, no tensor cores: TF32 is off)
    and writes the equations; the chunked tier's sums read the partial
    equations and write the owners'; each solve reads the equations once
    for the residual and once per CG iteration. ``fused`` is the least any
    kernel could take: ratings and factors read once, factors written
    once, the gramian FLOPs."""
    eq = rank * rank + 2 * rank + 1  # a, b, diagonal, n per row (f32)
    nbytes = {"gather+gramian": 0, "segment sums": 0, "solve": 0}
    flops = {"gather+gramian": 0, "segment sums": 0, "solve": 0}
    fused_bytes = fused_flops = 0
    for lay in (u_lay, i_lay):
        entries = sum(b.ids.size for b in lay.buckets)
        block_rows = sum(b.padded_rows for b in lay.buckets)
        covered = sum(m.span for m in lay.metas)
        chunk_rows = sum(b.padded_rows for b, m in zip(lay.buckets, lay.metas)
                         if m.seg is not None)
        owners = sum(m.span for m in lay.metas if m.seg is not None)
        nbytes["gather+gramian"] += (entries * (4 + val_bytes)
                                     + 2 * entries * rank * 4
                                     + block_rows * eq * 4)
        flops["gather+gramian"] += 2 * entries * rank * (rank + 1)
        nbytes["segment sums"] += (chunk_rows + owners) * eq * 4
        nbytes["solve"] += (cg_iters + 1) * covered * rank * rank * 4 \
            + covered * rank * 4 * 8
        flops["solve"] += (cg_iters + 1) * 2 * covered * rank * rank
        fused_bytes += entries * (4 + val_bytes) + 2 * lay.slots * rank * 4
        fused_flops += 2 * entries * rank * (rank + 1) \
            + (cg_iters + 1) * 2 * covered * rank * rank
    out = {}
    for part in nbytes:
        tb, to = nbytes[part] / PEAK_BYTES_S, flops[part] / PEAK_F32_FLOP_S
        out[part] = {"bound_ms": max(tb, to) * 1e3,
                     "bound_by": "bytes" if tb >= to else "operations",
                     "gbytes": nbytes[part] / 1e9, "gflop": flops[part] / 1e9}
    tb, to = fused_bytes / PEAK_BYTES_S, fused_flops / PEAK_F32_FLOP_S
    out["fused"] = {"bound_ms": max(tb, to) * 1e3,
                    "bound_by": "bytes" if tb >= to else "operations",
                    "gbytes": fused_bytes / 1e9, "gflop": fused_flops / 1e9}
    return out


def host_half_step(order, starts, other_idx, vals, rows, other64, lam):
    """Exact float64 ALS-WR solves for ``rows``: (A + λ·n·I) x = b from
    their ratings (``order`` sorts the entries by row; ``starts`` bounds
    each row's run) against the other side's factors in true row order."""
    rank = other64.shape[1]
    out = np.zeros((len(rows), rank))
    for k, r in enumerate(rows):
        idx = order[starts[r]:starts[r + 1]]
        f = other64[other_idx[idx]]
        a = f.T @ f + lam * max(len(idx), 1) * np.eye(rank)
        out[k] = np.linalg.solve(a, f.T @ vals[idx].astype(np.float64))
    return out


def row_rel_err(got, want) -> np.ndarray:
    return (np.linalg.norm(got - want, axis=1)
            / np.maximum(np.linalg.norm(want, axis=1), 1e-30))


def accuracy_gate(dev, *, n: int = 200_000, seed: int = 3, rank: int = RANK,
                  n_users=N_USERS, n_items=N_ITEMS) -> dict:
    """``bench.py::accuracy_gate`` (bench.py:2602-2636), copied onto the
    port: train three times on a 200k-rating sample (rank 64, 3
    iterations, λ 0.1, seed 5) — cholesky in f32, CG in f32 and CG in
    bf16 — and compare reconstruction RMSE over observed entries; each CG
    gap to the exact solver's must be ≤ 1e-3."""
    users, items, vals = synth_ml20m(n, seed=seed, n_users=n_users,
                                     n_items=n_items)
    nu, ni = int(users.max()) + 1, int(items.max()) + 1
    r = als_ratings(users, items, vals, nu, ni)

    def rmse(m):
        pred = np.einsum("nr,nr->n", m.user_factors[users],
                         m.item_factors[items])
        return float(np.sqrt(np.mean((pred - vals) ** 2)))

    base = dict(rank=rank, iterations=3, lambda_=0.1, seed=5)
    exact = rmse(train_als(r, ALSConfig(**base, solver="cholesky",
                                        compute_dtype="float32"), device=dev))
    out = {"n": n, "seed": seed, "exact_f32_rmse": exact}
    for dtype in ("float32", "bfloat16"):
        fast = rmse(train_als(r, ALSConfig(**base, solver="cg",
                                           compute_dtype=dtype), device=dev))
        gap = abs(fast - exact)
        check(gap <= 1e-3, f"accuracy gate: cg/{dtype} RMSE gap {gap:.2e} "
              f"> 1e-3")
        out[f"cg_{dtype}_rmse"] = fast
        out[f"cg_{dtype}_gap"] = gap
    return out


class MemoryRatings(DataSource):
    """An in-memory data source of the phase's 20M ratings (phase 8 reads
    the event store, at the quickstart's size)."""

    ratings: Ratings | None = None

    def read_training(self, ctx):
        return TrainingData(MemoryRatings.ratings)


def phase_als_train(dev, *, n_ratings=N_RATINGS, n_users=N_USERS,
                    n_items=N_ITEMS, rank=RANK, timed=ALS_TIMED,
                    gate_n=200_000, n_check=512, template_iters=10,
                    n_seq=16, n_conc=48, procs=4, threads=12) -> dict:
    """Blocked WALS training at the ML-20M shape (20M ratings over 138,493
    x 26,744 at rank 64, λ 0.1, nothing cut), then the template trained
    and served. Every check raises on failure."""
    out: dict = {"n_ratings": n_ratings, "users": n_users, "items": n_items,
                 "rank": rank, "lambda": ALS_LAMBDA}
    # the layout on the native host library (what training runs), then on
    # the numpy path in a process with the library switched off: equal
    # array for array
    check(native.available(), "the native host library did not build")
    t0 = time.perf_counter()
    (users, items, vals), (u_lay, i_lay), out["layout_s"] = ml20m_layout(
        n_ratings, n_users, n_items, rank)
    out["data_s"] = time.perf_counter() - t0 - out["layout_s"]
    cfg = ALSConfig(rank=rank, lambda_=ALS_LAMBDA)
    np_run = numpy_layout(n_ratings, n_users, n_items, rank)
    out["layout_numpy_s"] = np_run["layout_s"]
    for side, lay, digest in (("users", u_lay, np_run["digests"][0]),
                              ("items", i_lay, np_run["digests"][1])):
        check(layout_digest(lay) == digest,
              f"the native and numpy {side} layouts differ")
    print(f"[als-train] layout at {n_ratings:,} ratings: native "
          f"{out['layout_s']:.3f} s, numpy {out['layout_numpy_s']:.3f} s, "
          f"equal array for array", flush=True)
    out["layout"] = {"users": layout_stats(u_lay), "items": layout_stats(i_lay)}
    rng = np.random.default_rng(SEED)
    u0 = (np.abs(rng.standard_normal((n_users, rank))) / np.sqrt(rank)
          ).astype(np.float32)
    v0 = (np.abs(rng.standard_normal((n_items, rank))) / np.sqrt(rank)
          ).astype(np.float32)
    warm = als._resolve_cg_iters(None, False, warm=True)

    # (a) iterations per second at float32, then bfloat16; (c) two steps
    # from the same state are bitwise equal
    for dtype in ("float32", "bfloat16"):
        vd = "bfloat16" if dtype == "bfloat16" else None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ub, ib, up, vp = als_train_state_from_numpy(
            u_lay, i_lay, u0, v0, device=dev, vals_dtype=vd)
        sync(dev)
        upload_s = time.perf_counter() - t0
        step = make_train_step(u_lay, i_lay, rank=rank, lambda_=ALS_LAMBDA,
                               compute_dtype=dtype)
        u1, v1 = step(ub, ib, up, vp)
        u2, v2 = step(ub, ib, up, vp)
        check(torch.equal(u1, u2) and torch.equal(v1, v2),
              f"two {dtype} steps from the same state differ")
        del u2, v2
        u, v = step(ub, ib, u1, v1)  # warm-up
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(timed):
            u, v = step(ub, ib, u, v)
        sync(dev)
        wall = time.perf_counter() - t0
        check(bool(torch.isfinite(u).all() and torch.isfinite(v).all()),
              f"non-finite factors after {dtype} training")
        rec = {"upload_s": upload_s, "iters": timed, "wall_s": wall,
               "iters_per_s": timed / wall, "ms_per_iter": wall / timed * 1e3,
               "bitwise_run_to_run": True}
        split = als_step_split(dev, lambda: step(ub, ib, u, v))
        rec.update(split)
        rec["bounds"] = als_bounds(u_lay, i_lay, rank, warm,
                                   2 if vd else 4)
        if dev.type == "cuda":
            rec["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out[dtype] = rec
        print(f"[als-train] {dtype}: {rec['iters_per_s']:.2f} iterations/s "
              f"({rec['ms_per_iter']:.2f} ms), parts "
              f"{json.dumps(rec['parts_ms'])}", flush=True)
        if dtype == "float32":
            f32_state = (ub, ib, u, v)
        del ub, ib, up, vp, u, v, u1, v1

    # (b) a cholesky half-step each way against host float64 solves for
    # sampled rows (the heaviest items, chunked-tier owners, among them);
    # CG's warm depth-4 half-step from the same state reports its gap
    ub, ib, u, v = f32_state
    del f32_state
    kw = dict(lambda_=ALS_LAMBDA, implicit=False, alpha=1.0, rank=rank,
              compute_dtype="float32", solver="cholesky", cg_iters=warm)
    with torch.no_grad():
        t0 = time.perf_counter()
        u_ch = als._solve_side(ub, u_lay, v, kw=kw)
        v_ch = als._solve_side(ib, i_lay, u, kw=kw)
        sync(dev)
        chol_s = time.perf_counter() - t0
        u_cg = als._solve_side(ub, u_lay, v, kw=dict(kw, solver="cg"), x0=u)
        v_cg = als._solve_side(ib, i_lay, u, kw=dict(kw, solver="cg"), x0=v)
    u_true = u.cpu().numpy()[u_lay.pos].astype(np.float64)
    v_true = v.cpu().numpy()[i_lay.pos].astype(np.float64)
    crng = np.random.default_rng(SEED + 7)
    deg_i = np.bincount(items, minlength=n_items)
    owners = np.nonzero(deg_i > cfg.chunk_cap)[0]
    s_items = np.unique(np.concatenate([
        owners[:n_check // 8],
        crng.choice(np.nonzero(deg_i > 0)[0], n_check, replace=False)]))[:n_check]
    deg_u = np.bincount(users, minlength=n_users)
    s_users = crng.choice(np.nonzero(deg_u > 0)[0], n_check, replace=False)
    check_rec = {"sampled_users": len(s_users), "sampled_items": len(s_items),
                 "chunked_owners": int(np.isin(s_items, owners).sum()),
                 "cholesky_half_steps_s": chol_s}
    for side, rows, idx, other_idx, other64, lay, ch, cg in (
            ("users", s_users, users, items, v_true, u_lay, u_ch, u_cg),
            ("items", s_items, items, users, u_true, i_lay, v_ch, v_cg)):
        order = np.argsort(idx, kind="stable")
        starts = np.zeros(len(lay.pos) + 1, np.int64)
        np.cumsum(np.bincount(idx, minlength=len(lay.pos)), out=starts[1:])
        want = host_half_step(order, starts, other_idx, vals, rows, other64,
                              ALS_LAMBDA)
        slots = lay.pos[rows]
        err_ch = row_rel_err(ch.cpu().numpy()[slots], want)
        err_cg = row_rel_err(cg.cpu().numpy()[slots], want)
        check(float(err_ch.max()) <= 1e-4,
              f"cholesky {side} half-step {err_ch.max():.2e} from float64")
        check_rec[f"{side}_cholesky_max_rel_err"] = float(err_ch.max())
        check_rec[f"{side}_cg_max_rel_err"] = float(err_cg.max())
        check_rec[f"{side}_cg_median_rel_err"] = float(np.median(err_cg))
    out["float64_check"] = check_rec
    print("[als-train] float64 check " + json.dumps(check_rec), flush=True)
    del ub, ib, u, v, u_ch, v_ch, u_cg, v_cg
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (d) the accuracy gate
    out["accuracy_gate"] = accuracy_gate(dev, n=gate_n, rank=rank,
                                         n_users=n_users, n_items=n_items)
    print("[als-train] accuracy gate " + json.dumps(out["accuracy_gate"]),
          flush=True)

    # (e) the template: Engine.train on the ML-20M ratings, then deployed
    # and served over HTTP, every answer against a host exact top-k
    MemoryRatings.ratings = als_ratings(users, items, vals, n_users, n_items)
    engine = engine_factory()
    engine.data_source_classes = {"": MemoryRatings}
    ctx = Context(device=dev)
    params = AlgorithmParams(rank=rank, num_iterations=template_iters,
                             lambda_=ALS_LAMBDA)
    t0 = time.perf_counter()
    result = engine.train(ctx, EngineParams(
        algorithm_params_list=(("als", params),)))
    train_s = time.perf_counter() - t0
    MemoryRatings.ratings = None
    model = result.models[0]
    check(model.user_factors.shape == (n_users, rank)
          and model.item_factors.shape == (n_items, rank)
          and np.isfinite(model.user_factors).all()
          and np.isfinite(model.item_factors).all(),
          "the template-trained factors are not finite [rows, rank]")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reset_launches()
    server = EngineServer(engine_factory(), result, "chip-smoke-als-train",
                          device=dev)
    serving = phase_serving(dev, server, n_seq=n_seq, n_conc=n_conc,
                            procs=procs, threads=threads)
    launches = dict(kernels.LAUNCHES)
    check(launches["topk_rows"] > 0,
          f"topk_rows never launched serving the trained model: {launches}")
    del server
    out["template"] = {"iterations": template_iters, "train_s": train_s,
                       "phases": [[p, dt] for p, dt in ctx.phase_times],
                       "serving": serving, "launches": launches}
    return out


# -- phase 8: events to answers -----------------------------------------

#: the reference's e2e quickstart shape (bench.py:686-760): 200,000 rate
#: events over 5,000 users x 2,000 items, ratings in steps of 0.5; plus
#: 10,000 buy events (rating 4 through the data source's rating_of)
QS_USERS, QS_ITEMS, QS_RATES, QS_BUYS = 5_000, 2_000, 200_000, 10_000
QS_APP = "chipsmoke"
ENGINE_JSON = "templates/recommendation/engine.json"


def quickstart_events(seed: int, n_users=QS_USERS, n_items=QS_ITEMS,
                      n_rates=QS_RATES, n_buys=QS_BUYS) -> list:
    rng = np.random.default_rng(seed)
    n = n_rates + n_buys
    users = rng.integers(0, n_users, n)
    items = rng.integers(0, n_items, n)
    vals = np.round(rng.random(n_rates) * 9 + 1) / 2
    t0 = datetime(2020, 1, 1, tzinfo=timezone.utc)
    Event, DataMap = pio_storage.Event, pio_storage.DataMap
    return [Event(event="rate" if k < n_rates else "buy",
                  entity_type="user", entity_id=f"u{users[k]}",
                  target_entity_type="item", target_entity_id=f"i{items[k]}",
                  properties=DataMap({"rating": float(vals[k])}
                                     if k < n_rates else {}),
                  event_time=t0 + timedelta(seconds=k))
            for k in range(n)]


def stored_model(iid: str):
    """The ALS model of an instance's stored blob, on the host."""
    blob = pio_storage.Storage.get_models().get(iid)
    return deserialize_models(blob.models)[0]


def stored_check(body: dict, query: dict, model) -> None:
    """One answer against a host exact top-N of the stored factors
    (phase 3's check and tolerance)."""
    got = body["itemScores"]
    row = model.user_ids.get(query["user"])
    if row is None:
        check(got == [], f"unknown user {query['user']} got items")
        return
    scores = model.item_factors @ model.user_factors[row]
    want = np.argsort(-scores, kind="stable")[: query["num"]]
    check(len(got) == len(want),
          f"{query['user']}: {len(got)} items, want {len(want)}")
    gs = np.array([g["score"] for g in got], np.float32)
    gi = np.array([model.item_ids[g["item"]] for g in got])
    check(np.allclose(gs, scores[want], rtol=RTOL, atol=1e-6),
          f"{query['user']}: scores differ from the stored factors' top-N")
    check(np.allclose(scores[gi], gs, rtol=RTOL, atol=1e-6),
          f"{query['user']}: an item's stored score differs from its "
          "served score")


def get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=300) as resp:
        return json.loads(resp.read())


def bundle_bytes(server) -> int:
    """Device bytes the served bundle's retriever and pipeline hold."""
    total = 0
    for model in server.deployed.result.models:
        for attr in ("_retriever", "_pipeline"):
            obj = getattr(model, attr, None)
            for t in vars(obj).values() if obj is not None else ():
                if isinstance(t, torch.Tensor) and t.device.type != "cpu":
                    total += t.numel() * t.element_size()
    return total


def device_memory(dev) -> int:
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def phase_events_to_answers(dev, *, seed=SEED, n_seq=16, n_users=QS_USERS,
                            n_items=QS_ITEMS, n_rates=QS_RATES,
                            n_buys=QS_BUYS) -> dict:
    """The recommendation template from the event store: SQLite storage
    under a temp dir, the quickstart's events written with
    ``insert_batch``, ``run_train`` with the template's own engine.json
    (no init hook), a server built from the newest COMPLETED instance and
    served over HTTP; then retrains, ``GET /reload``, and a corrupt
    newest blob skipped while serving goes on. Every check raises."""
    out: dict = {"users": n_users, "items": n_items, "rates": n_rates,
                 "buys": n_buys}
    home = tempfile.mkdtemp(prefix="pio-chip-smoke-")
    os.environ["PIO_HOME"] = home
    Storage = pio_storage.Storage
    Storage.reset()
    for repo, name in (("METADATA", "meta"), ("EVENTDATA", "events"),
                       ("MODELDATA", "models")):
        Storage.configure(repo, "sqlite", path=os.path.join(home,
                                                            f"{name}.db"))
    app = Storage.get_metadata().app_insert(QS_APP)
    Storage.get_events().init_app(app.id)
    events = quickstart_events(seed, n_users, n_items, n_rates, n_buys)
    t0 = time.perf_counter()
    Storage.get_events().insert_batch(events, app.id)
    out["insert_s"] = time.perf_counter() - t0
    del events

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           ENGINE_JSON)) as fh:
        variant = json.load(fh)
    variant["datasource"]["params"]["app_name"] = QS_APP
    engine = engine_factory()
    store = Context(device=dev).event_store()
    t0 = time.perf_counter()
    frame = store.find_frame(app_name=QS_APP, entity_type="user",
                             event_names=("rate", "buy"),
                             target_entity_type="item")
    out["find_frame_s"] = time.perf_counter() - t0
    check(len(frame) == n_rates + n_buys,
          f"find_frame read {len(frame)} events")
    del frame

    # train_als's layout and each of its steps timed where it calls them
    # (a step between two syncs of the card)
    layout_s: list = []
    step_s: list = []
    real_layout, real_step = als.build_bilinear_layout, als.make_train_step

    def timed_layout(*a, **kw):
        t = time.perf_counter()
        lay = real_layout(*a, **kw)
        layout_s.append(time.perf_counter() - t)
        return lay

    def timed_step_factory(*a, **kw):
        step = real_step(*a, **kw)

        def timed_step(*sa):
            sync(dev)
            t = time.perf_counter()
            res = step(*sa)
            sync(dev)
            step_s.append(time.perf_counter() - t)
            return res
        return timed_step

    def train(seed_override=None) -> tuple[str, dict]:
        v = json.loads(json.dumps(variant))
        if seed_override is not None:
            v["algorithms"][0]["params"]["seed"] = seed_override
        ctx = Context(device=dev, mode="Train")
        step_s.clear()
        als.build_bilinear_layout = timed_layout
        als.make_train_step = timed_step_factory
        try:
            t = time.perf_counter()
            iid = core_workflow.run_train(engine,
                                          engine.engine_params_from_json(v),
                                          ctx)
            wall = time.perf_counter() - t
        finally:
            als.build_bilinear_layout = real_layout
            als.make_train_step = real_step
        phases = dict(ctx.phase_times)
        train_s = sum(dt for p, dt in phases.items() if p.startswith("train["))
        check(len(step_s) == int(v["algorithms"][0]["params"]
                                 ["num_iterations"]),
              f"train_als ran {len(step_s)} steps")
        return iid, {"wall_s": wall,
                     "read_s": phases["datasource.read_training"],
                     "layout_s": layout_s[-1],
                     "iterations_s": sum(step_s),
                     # the seeded init draws, the upload and the sampler
                     "train_other_s": train_s - layout_s[-1] - sum(step_s),
                     "persist_s": wall - sum(phases.values())}

    iid, stages = train()
    meta = Storage.get_metadata()
    inst = meta.engine_instance_get(iid)
    check(inst is not None and inst.status == "COMPLETED",
          "run_train did not complete")
    out["train"] = stages
    model = stored_model(iid)
    check(model.item_factors.shape[1] == 10
          and np.isfinite(model.user_factors).all()
          and np.isfinite(model.item_factors).all(),
          "the stored factors are not finite [rows, 10]")

    # the same events trained twice: bitwise-equal factors
    again, _ = train()
    twin = stored_model(again)
    check(np.array_equal(model.user_factors, twin.user_factors)
          and np.array_equal(model.item_factors, twin.item_factors),
          "two trainings of the same events differ")
    out["retrain_bitwise"] = True
    del twin

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reset_launches()
    base_mem = device_memory(dev)
    t0 = time.perf_counter()
    latest = meta.engine_instance_get_latest_completed(
        inst.engine_id, inst.engine_version, inst.engine_variant)
    server = EngineServer(engine, latest, device=dev)
    out["deploy_s"] = time.perf_counter() - t0
    out["bundle_bytes"] = bundle_bytes(server)
    check(server.engine_instance_id == again,
          f"deployed {server.engine_instance_id}, not the newest {again}")
    rng = np.random.default_rng(seed + 8)
    with serve(server, "127.0.0.1", 0) as front:
        base = f"http://127.0.0.1:{front.port}"
        url = base + "/queries.json"
        queries = [{"user": f"u{int(rng.integers(0, n_users))}",
                    "num": int(rng.choice([1, 4, 10, 20]))}
                   for _ in range(n_seq - 1)] + [{"user": "nobody", "num": 4}]
        walls = []
        for q in queries:
            body, wall = post(url, q)
            stored_check(body, q, model)
            walls.append(wall)
        out["first_answer_s"] = walls[0]
        out["p50_ms"] = statistics.median(walls) * 1e3
        launches = dict(kernels.LAUNCHES)
        check(launches["topk_rows"] > 0,
              f"topk_rows never launched on the storage-deployed path: "
              f"{launches}")
        out["launches"] = launches

        # reload 1: a retrain with seed 4 becomes the served instance
        newer, _ = train(4)
        body = get_json(base + "/reload")
        check(body.get("engineInstanceId") == newer,
              f"/reload answered {body}, not {newer}")
        check(get_json(base + "/")["engineInstanceId"] == newer,
              "status does not show the reloaded instance")
        newer_model = stored_model(newer)
        body, _ = post(url, queries[0])
        stored_check(body, queries[0], newer_model)
        mem_after_first = device_memory(dev)

        # reload 2: the newest blob is corrupt; serving stays on `newer`
        bad, _ = train(5)
        conn = sqlite3.connect(os.path.join(home, "models.db"))
        conn.execute("UPDATE models SET blob = ? WHERE id = ?",
                     (b"\x80\x05corrupt", bad))
        conn.commit()
        conn.close()
        body = get_json(base + "/reload")
        check(body.get("engineInstanceId") == newer,
              f"/reload after a corrupt blob answered {body}")
        status = get_json(base + "/")
        check(status["engineInstanceId"] == newer
              and [s["engineInstanceId"] for s in status["deploySkips"]]
              == [bad], f"the corrupt blob was not skipped: {status}")
        body, _ = post(url, queries[1])
        stored_check(body, queries[1], newer_model)

        # reload 3: the same walk again; device memory stays put
        get_json(base + "/reload")
        mem_after_third = device_memory(dev)
    check(abs(mem_after_third - mem_after_first) <= out["bundle_bytes"],
          f"device memory moved {mem_after_third - mem_after_first} bytes "
          f"over reloads (a bundle holds {out['bundle_bytes']})")
    out["device_mem"] = {"before_deploy": base_mem,
                         "after_reload_1": mem_after_first,
                         "after_reload_3": mem_after_third}
    out["skips"] = status["deploySkips"]
    del server
    Storage.reset()
    return out


# -- phase 9: the CLI quickstart ----------------------------------------


def pio(argv: list) -> tuple[int, str]:
    """One ``pio`` verb in this process: (exit code, what it printed; the
    lines are also passed on to this script's output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    text = out.getvalue()
    for line in text.splitlines():
        print(f"[cli] pio {argv[0]}: {line}", flush=True)
    return rc, text


def pio_ok(argv: list) -> str:
    rc, text = pio(argv)
    check(rc == 0, f"pio {' '.join(map(str, argv))} exited {rc}")
    return text


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def pio_thread(argv: list) -> tuple[threading.Thread, list]:
    """A blocking verb (deploy, eventserver) on a daemon thread; the list
    receives its exit code or exception."""
    result: list = []

    def run():
        try:
            result.append(cli.main([str(a) for a in argv]))
        except BaseException as e:  # noqa: BLE001 — the phase reads it
            result.append(e)

    thread = threading.Thread(target=run, name=f"pio-{argv[0]}", daemon=True)
    thread.start()
    return thread, result


def wait_answer(url: str, thread: threading.Thread, result: list,
                timeout_s: float = 300.0) -> dict:
    """GET ``url`` until it answers, while ``thread`` still runs."""
    deadline = time.perf_counter() + timeout_s
    while True:
        check(thread.is_alive(), f"{thread.name} ended: {result}")
        try:
            return get_json(url)
        except OSError:
            check(time.perf_counter() < deadline, f"{url} never answered")
            time.sleep(0.05)


def post_status(url: str, body) -> tuple[int, object]:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_cli_quickstart(dev, *, seed=SEED, n_seq=16, n_batch=64,
                         n_users=QS_USERS, n_items=QS_ITEMS,
                         n_rates=QS_RATES, n_buys=QS_BUYS,
                         n_single=100, n_batched=500) -> dict:
    """The README quickstart through the port's ``pio``, in this process
    (so the launch counts see the deployed server): phase 8's events as a
    JSONL file, ``app new``, ``import``, ``template get``, ``build``,
    ``train``, ``deploy`` on a thread with the launch counts set to 0
    first, queries over HTTP against the stored blob's host top-N, a
    second ``train`` and ``GET /reload``, ``batchpredict``, ``undeploy``
    and ``export``; then ``eventserver`` on a thread (it has no stop
    route and ends with this process) and ``status`` in a subprocess.
    Every check raises."""
    out: dict = {"users": n_users, "items": n_items, "rates": n_rates,
                 "buys": n_buys}
    home = tempfile.mkdtemp(prefix="pio-chip-cli-")
    os.environ["PIO_HOME"] = home
    if dev.type == "cpu":
        os.environ["PIO_PLATFORM"] = "cpu"
    else:
        os.environ.pop("PIO_PLATFORM", None)
    Storage = pio_storage.Storage
    Storage.reset()  # the console's own storage: its defaults under PIO_HOME

    events_file = os.path.join(home, "events.jsonl")
    with open(events_file, "w") as fh:
        for e in quickstart_events(seed, n_users, n_items, n_rates, n_buys):
            fh.write(json.dumps(pio_storage.event_to_api_dict(e)) + "\n")
    n_events = n_rates + n_buys
    pio_ok(["app", "new", QS_APP])
    app_id = Storage.get_metadata().app_get_by_name(QS_APP).id
    t0 = time.perf_counter()
    text = pio_ok(["import", "--appid", app_id, "--input", events_file])
    out["import_s"] = time.perf_counter() - t0
    check(f"Imported {n_events} events" in text, f"import said {text!r}")

    engine_dir = os.path.join(home, "engine")
    pio_ok(["template", "get", "recommendation", engine_dir])
    variant_path = os.path.join(engine_dir, "engine.json")
    with open(variant_path) as fh:
        variant = json.load(fh)
    variant["datasource"]["params"]["app_name"] = QS_APP
    with open(variant_path, "w") as fh:
        json.dump(variant, fh)
    pio_ok(["build", "--engine-dir", engine_dir])

    def train() -> tuple[str, float]:
        t = time.perf_counter()
        text = pio_ok(["train", "--engine-dir", engine_dir])
        wall = time.perf_counter() - t
        marker = "Training completed. Engine instance: "
        check(marker in text, f"train said {text!r}")
        return text.split(marker)[1].split()[0], wall

    iid, out["train_s"] = train()
    model = stored_model(iid)
    check(model.item_factors.shape[1] == variant["algorithms"][0]["params"]
          ["rank"] and np.isfinite(model.user_factors).all()
          and np.isfinite(model.item_factors).all(),
          "the trained factors are not finite [rows, rank]")

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reset_launches()
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    deploy, deploy_result = pio_thread(
        ["deploy", "--engine-dir", engine_dir, "--ip", "127.0.0.1",
         "--port", port])
    status = wait_answer(base + "/", deploy, deploy_result)
    out["deploy_s"] = time.perf_counter() - t0
    check(status["engineInstanceId"] == iid,
          f"deploy serves {status['engineInstanceId']}, not {iid}")
    rng = np.random.default_rng(seed + 9)
    queries = [{"user": f"u{int(rng.integers(0, n_users))}",
                "num": int(rng.choice([1, 4, 10, 20]))}
               for _ in range(n_seq)]
    walls = []
    for q in queries:
        body, wall = post(base + "/queries.json", q)
        stored_check(body, q, model)
        walls.append(wall)
    out["deploy_to_first_answer_s"] = out["deploy_s"] + walls[0]
    out["p50_ms"] = statistics.median(walls) * 1e3
    check(post_status(base + "/queries.json", {"user": "nobody", "num": 4})
          == (200, {"itemScores": []}), "an unknown user got items")
    code, body = post_status(base + "/queries.json", {"wrong": 1})
    check(code == 400, f"a malformed query answered {code} {body}")
    launches = dict(kernels.LAUNCHES)
    check(launches["topk_rows"] > 0,
          f"topk_rows never launched in the deployed server: {launches}")
    out["launches"] = launches

    newer, out["retrain_s"] = train()
    body = get_json(base + "/reload")
    check(body.get("engineInstanceId") == newer != iid,
          f"/reload answered {body}, not the new instance {newer}")
    newer_model = stored_model(newer)
    body, _ = post(base + "/queries.json", queries[0])
    stored_check(body, queries[0], newer_model)

    queries_file = os.path.join(home, "queries.jsonl")
    batch_queries = [{"user": f"u{int(rng.integers(0, n_users))}",
                      "num": int(rng.choice([1, 4, 10, 20]))}
                     for _ in range(n_batch - 1)] + [{"user": "nobody",
                                                     "num": 3}]
    with open(queries_file, "w") as fh:
        fh.write("\n".join(json.dumps(q) for q in batch_queries) + "\n")
    preds_file = os.path.join(home, "predictions.jsonl")
    t0 = time.perf_counter()
    pio_ok(["batchpredict", "--engine-dir", engine_dir, "--input",
            queries_file, "--output", preds_file])
    out["batchpredict_s"] = time.perf_counter() - t0
    with open(preds_file) as fh:
        rows = [json.loads(line) for line in fh]
    check(len(rows) == n_batch, f"batchpredict wrote {len(rows)} rows")
    for row, q in zip(rows, batch_queries):
        check(row.get("query") == q and "prediction" in row,
              f"batchpredict row {row} for {q}")
        stored_check(row["prediction"], q, newer_model)

    pio_ok(["undeploy", "--port", port])
    deploy.join(60)
    check(not deploy.is_alive() and deploy_result == [0],
          f"undeploy did not end the server: {deploy_result}")

    export_file = os.path.join(home, "export.jsonl")
    t0 = time.perf_counter()
    pio_ok(["export", "--appid", app_id, "--output", export_file])
    out["export_s"] = time.perf_counter() - t0
    with open(export_file) as fh:
        n_exported = sum(1 for _ in fh)
    check(n_exported == n_events,
          f"export wrote {n_exported} lines, {n_events} were imported")

    # the event server, on its own app
    text = pio_ok(["app", "new", "chipevents"])
    key = text.split("Access key: ")[1].split()[0]
    eport = free_port()
    ebase = f"http://127.0.0.1:{eport}"
    server, server_result = pio_thread(
        ["eventserver", "--ip", "127.0.0.1", "--port", eport, "--stats"])
    check(wait_answer(ebase + "/health.json", server, server_result)
          ["status"] == "ok", "the event server is not healthy")
    fresh = quickstart_events(seed + 1, n_users, n_items, n_single,
                              n_batched)
    wire = [pio_storage.event_to_api_dict(e) for e in fresh]
    for e in wire:
        e.pop("creationTime", None)  # the server stamps its own
    t0 = time.perf_counter()
    for e in wire[:n_single]:
        code, body = post_status(f"{ebase}/events.json?accessKey={key}", e)
        check(code == 201, f"POST /events.json answered {code} {body}")
    out["events_single_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(n_single, len(wire), 50):
        code, body = post_status(f"{ebase}/batch/events.json?accessKey={key}",
                                 wire[i:i + 50])
        check(code == 200 and all(r["status"] == 201 for r in body),
              f"POST /batch/events.json answered {code} {body}")
    out["events_batch_s"] = time.perf_counter() - t0
    got = get_json(f"{ebase}/events.json?accessKey={key}&limit=-1")
    check(len(got) == len(wire), f"GET /events.json read {len(got)} events")
    check(sorted((e["entityId"], e["targetEntityId"], e["eventTime"])
                 for e in got)
          == sorted((e["entityId"], e["targetEntityId"], e["eventTime"])
                    for e in wire), "the events read back differ")
    stats = get_json(f"{ebase}/stats.json?accessKey={key}")
    check(stats["statusCount"] == {"201": len(wire)},
          f"/stats.json counted {stats['statusCount']}")
    check(get_json(ebase + "/health.json")["status"] == "ok",
          "the event server is not healthy after the posts")

    # `pio status` in a process of its own: the card listed, no jax loaded
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "predictionio_tpu_torch.tools.cli", "status"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=300)
    out["status_s"] = time.perf_counter() - t0
    imported = [ln.rsplit("|", 1)[-1].strip() for ln in
                proc.stderr.splitlines() if ln.startswith("import time:")]
    jaxy = [m for m in imported
            if m.split(".")[0] in ("jax", "jaxlib", "predictionio_tpu")]
    device_line = [ln.strip() for ln in proc.stdout.splitlines()
                   if ln.strip().startswith("devices:")]
    check(proc.returncode == 0, f"pio status exited {proc.returncode}: "
          f"{proc.stdout[-1000:]} {proc.stderr[-1000:]}")
    check(imported and not jaxy, f"pio status imported {jaxy}")
    if dev.type == "cuda":
        check(device_line and torch.cuda.get_device_name(0)
              in device_line[0], f"pio status listed {device_line}")
    out["status_devices"] = device_line
    Storage.reset()
    return out


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
    # the native host library (g++) builds while nvcc builds the kernels
    native_s: list = []

    def build_native() -> None:
        t = time.perf_counter()
        native.available()
        native_s.append(time.perf_counter() - t)

    native_build = threading.Thread(target=build_native)
    t0 = time.perf_counter()
    native_build.start()
    kernels.build()
    build_s = time.perf_counter() - t0
    native_build.join()
    check(native.available(), "the native host library did not build")
    print(f"[device] {name} | nvidia-smi: {smi} | kernel build "
          f"{build_s:.2f} s, native host library {native_s[0]:.2f} s "
          f"beside it | torch {torch.__version__} cuda "
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
    check(all(launches[key] > 0 for key in (
              "topk", "topk_rows", "topk_select", "topk_merge")),
          f"a kernel of the ALS serving path never launched: {launches}")
    print("[serving] " + json.dumps({**serving, "launches": launches,
                                     "card": smi}), flush=True)
    clock.lap("3 ALS serving")

    # the same server at num 100 (topk_sort and the merge rounds), counted
    # from zero
    reset_launches()
    wide = phase_wide_serving(dev, server)
    wide_launches = dict(kernels.LAUNCHES)
    check(wide_launches["topk_sort"] == wide_launches["topk_rows"] > 0
          and wide_launches["topk_merge"] > 0,
          f"topk_sort or the merge never launched at num 100: "
          f"{wide_launches}")
    print("[serving-num100] " + json.dumps({
        **wide, "launches": wide_launches, "card": smi}), flush=True)
    del server
    torch.cuda.empty_cache()
    clock.lap("3b ALS serving at num 100")

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

    # the ALS training path: train at full width, then the template
    # trained, deployed and served (phase_als_train resets the launch
    # counts before it deploys)
    als_train = phase_als_train(dev)
    als_train["card"] = smi
    print("[als-train] " + json.dumps(als_train), flush=True)
    clock.lap("7 ALS training")

    # the recommendation path from the event store: run_train to a stored
    # blob, then deployed and served from storage, counted from zero
    # (phase_events_to_answers resets the launch counts before it deploys)
    e2e = phase_events_to_answers(dev)
    e2e["card"] = smi
    print("[events] stage seconds: " + json.dumps({
        "insert": e2e["insert_s"], "find_frame": e2e["find_frame_s"],
        "layout": e2e["train"]["layout_s"],
        "iterations": e2e["train"]["iterations_s"],
        "train_other": e2e["train"]["train_other_s"],
        "persist": e2e["train"]["persist_s"], "deploy": e2e["deploy_s"],
        "first_answer": e2e["first_answer_s"]}) + f" | {smi}", flush=True)
    print("[events] " + json.dumps(e2e), flush=True)
    clock.lap("8 events to answers")

    # the quickstart through the port's `pio`, in this process; the deployed
    # server counted from zero (phase_cli_quickstart resets the launch
    # counts before it deploys)
    qs = phase_cli_quickstart(dev)
    qs["card"] = smi
    print("[cli] stage seconds: " + json.dumps({
        "import": qs["import_s"], "train": qs["train_s"],
        "deploy_to_first_answer": qs["deploy_to_first_answer_s"],
        "batchpredict": qs["batchpredict_s"],
        "eventserver_100_single_posts": qs["events_single_s"],
        "eventserver_500_batched_posts": qs["events_batch_s"]})
        + f" | {smi}", flush=True)
    print("[cli] " + json.dumps(qs), flush=True)
    clock.lap("9 CLI quickstart")

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
        # stage 1 past k_pad 32 on its path (phase 3b), and the merge
        # rounds on theirs (phase 3), as pio_topk counted the launches
        kernel_record("topk_sort", wide_launches["topk_sort"],
                      by_case["ml20m rows B=8 k=100"]["stage1"]),
        kernel_record("topk_merge", launches["topk_merge"],
                      by_case["merge rows B=8 k=20"]),
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
