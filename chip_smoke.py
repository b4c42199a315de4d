"""Chip smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Runs on one CUDA card and exits non-zero on any failure (and at once when
no card is visible). It imports nothing of JAX or of ``predictionio_tpu``.

1. Device: the card's name, ``nvidia-smi``'s name and power limit, and the
   time to build the kernels (``predictionio_tpu_torch/csrc/topk.cu``,
   ``csrc/flash_attn.cu``, ``csrc/flash_attn_bwd.cu``,
   ``csrc/flash_attn_wide_fwd.cu``, ``csrc/flash_attn_wide.cu`` and
   ``csrc/flash_attn_huge.cu``, one
   ``nvcc`` each, in parallel) from the
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
   256) and D256 (B2 L256 H2), f32 and bf16, causal; then the wide head
   dims through the dispatch to the cluster forward
   ``csrc/flash_attn_wide_fwd.cu``, counted from zero: D320 (B2 L200 H2,
   padded to 384), D512 (B2 L256 H2) and D1024 (B1 L256 H2), causal, and
   D640, D768 and D896 (B1 L200 H2), causal and full, so every cluster
   size from 3 to 8 CTAs runs, f32 and bf16, each run twice and bitwise
   equal; the launch plans the card reports for every wide head dim and
   type (``pio_flash_attn_wide_fwd_plan``, and ``pio_flash_attn_wide_bwd_
   plan`` for dK/dV and dQ: cluster size, grid, threads, shared memory)
   equal to ``kernels.wide_fwd_plan``'s and ``kernels.wide_bwd_plan``'s,
   with the clusters the card holds at once (``[attention-wide-plan]``);
   then the head dims
   above 1,024 through
   the dispatch to ``csrc/flash_attn_huge.cu`` (the forward a score, a
   softmax and a product pass a band), counted from zero: B1 L1024 H2 at
   D 1,536 and 4,096, causal and not, f32 and bf16, and B1 L8192 H1 D1152
   causal bf16, whose forward takes two workspace bands, each run twice
   and bitwise equal, and once more with the logsumexp (the same output
   bits; the logsumexp within 1e-5 of the plain one), then timed at D
   4,096 causal f32 and bf16 (``[attention-huge]``). Max |err| within 1e-5
   for f32 (summation order) and 2**-7 for
   bf16 (two bf16 steps at |o| ~ 1); at the shapes the kernels line and
   ``PERF.md`` read (B8 L4096 H8 D64 causal f32, B4 L4096 H8 D64 causal
   f32 and bf16, the wide and the huge timed shapes), median device times
   of the kernel, the plain version (run in batch chunks so its [B, H, L, block] scores
   fit) and, as a yardstick the port never calls,
   ``scaled_dot_product_attention``, also at the wide kernels' timed shape
   (B2 L2048 H4 D512 causal, f32 and bf16), where the line names the
   backend SDPA chose (``[attention-wide]``).
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
   versions at the original D; the wide kernels alike (``csrc/
   flash_attn_wide.cu``: clusters of D/128 CTAs, a 64-row own tile each):
   directly at D1024 (B1 L256 H2) and at their timed shape (B2 L2048 H4
   D512), f32 and bf16, each run twice and bitwise equal, and D320 and
   D1024 through the autograd dispatch, counted from zero
   (``[attention-wide-bwd]``: both types' times, bounds and shares of the
   bound); the huge kernels (``csrc/flash_attn_huge.cu``: a score pass
   of S and dP into a banded workspace, then tiled products over
   128-feature slices) at phase 4's eight huge fixtures and at B1 L8192
   H1 D1152 causal f32, whose dK/dV takes two workspace bands, each run
   twice and bitwise equal (timed at D 4,096 causal, f32 and bf16), then
   phase 4's through the autograd dispatch, counted from zero, one launch
   of each kernel a fixture (``[attention-huge-bwd]``); the card's plan of
   every pass (``pio_flash_attn_huge_fwd_plan`` and ``pio_flash_attn_huge_
   bwd_plan``: band, workspace, grids, threads, shared memory) equal to
   ``kernels.huge_fwd_plan``'s and ``kernels.huge_bwd_plan``'s at both
   shapes, types, kinds and masks, with the CTAs an SM holds at once
   (``[attention-huge-plan]``); at phase 4's timed
   shapes, median device times of each kernel, the plain backward (in batch chunks) and, as a yardstick
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

10. Evaluation: phase 9's store (phase 8's events as app ``MyApp``, the
   one ``RecommendationEvaluation`` reads), then ``pio eval
   engine:RecommendationEvaluation`` in this process (3 folds x 4
   variants: 12 trainings through ``train_als`` on the card; the eval
   queries scored on the host, as the reference scores them) and the
   same with ``--fast``: both records EVALCOMPLETED, best.json written,
   the two leaderboards and best.json bitwise equal, FastEval's hits
   ``{'preparator': 3}``. The best variant's three folds are retrained
   on the CPU through the template and held to the card's under the
   fold rule of tests/test_torch_eval_workflow.py, the CPU run as the
   reference and the float64 sweeps of ``tests/torch_als64.py`` as the
   yardstick: the card's largest-entry gap to float64 over the folds and
   both sides <= max(1e-4, 4 x the CPU run's), each fold's and side's
   <= 1e-2, the top-10 lists equal but at near-ties (neighbouring CPU
   scores within the row's width, max(1e-3 x its largest |score|, 5 x
   its largest gap to the float64 scores)), and HitRate@10 within the
   share of queries whose hit such a near-tie can move; each raises. Then the
   movielensevaluation walkthrough: ``gen_movielens.py`` (400 users, 200
   items, 20,000 ratings), ``import``, ``eval
   engine:MovieLensEvaluation``, ``train --engine-json best.json`` on the
   card, and 16 queries served in process through ``EngineServer``, each
   the host exact top-N of the stored factors, with ``topk`` launched.
   Stage seconds (phase 9's import, read_eval, fold training mean and
   max, host scoring, metrics, each ``pio eval``, the CPU retrain and
   its comparison, the walkthrough), the leaderboards, FastEval's hits
   and the fold rule's readings print on an ``[eval]`` line beside the
   card's name and power limit.

11. Tuning. (a) ``train_als_grid`` on phase 7's ML-20M ratings and
   layout: rank 64 and 32, each at λ 0.01 and 0.1, 3 iterations, f32,
   twice, against four serial ``train_als`` runs of the same configs:
   every trial bitwise equal to its serial run and to the first grid
   run; the grid's step seconds against the sum of the serial steps,
   each call's seconds and the peak device memory. (b) ``pio tune
   engine:RecommendationEvaluation`` in this process on phase 10's store
   (3 folds x 4 variants, every fold's grid trained on the card): the
   grid packed ("vmapped"), every trial's score bitwise phase 10's ``pio
   eval`` score, best.json phase 10's, the winner trained on the full
   data with the leaderboard on its instance, ``pio status`` printing the
   tuning lines, a second ``tune --deploy`` whose gate asks 0.01 more
   than the incumbent holding with exit code 2, and the winner served in
   process through ``EngineServer``: 16 answers, each the host exact
   top-N of its stored factors, ``topk`` launched by the deploy's
   prewarm and ``topk_rows`` once an answer. Stage seconds (``pio
   tune``, read_eval, the grid train, the scoring, the winner's train)
   and the grid-against-serial step ratio print on a ``[tune]`` line
   beside the card's name and power limit.

12. Resilience. (a) Phase 3's ML-20M server behind ``serve()`` with
   ``dispatch_timeout_s=0.5``, ``batch_inflight=2`` and
   ``degraded_cooldown_s=2``: ``microbatch.dispatch`` armed to hang twice,
   both hung queries answer 504 and ``/health.json`` reads degraded with
   ``maxInflight`` 1, and the trip's flight incident dump holds the hung
   requests, each stamped with the stage its batch stalled in
   (``stalledStage``); 16 more answer 200 off the batcher, each the host's
   exact top-N, ``topk_rows`` launched 16 times and the batch count
   unchanged; past the cooldown the probe returns the server to ``ok``
   with two slots. (b) ``X-PIO-Deadline-Ms: 0.001`` answers 504, and with
   ``retrieval.topk`` hung on both slots (released once the query has
   waited past its deadline, capped at 0.45 s) a query with a 50 ms
   deadline expires in the queue: 504 "deadline", counted in
   ``pio_deadline_expired_total``. (c) ``pio deploy`` of phase 9's engine
   and store in a subprocess with ``--admission --rate-limit-qps 100
   --rate-limit-burst 50``: a burst of 256 queries from 64 threads sees
   429s with ``Retry-After``
   and every 200 equals the stored blob's host top-N; then SIGTERM during
   a second burst (every served batch held 0.2 s): every query is
   answered (200, 429 or 503 "draining"), ``/health.json`` reads 503
   while the queue flushes, and the process exits 0. A ``[resilience]``
   line gives the fallback p50 wall ms, the seconds from the trip to
   degraded mode and from the probe back to ``ok``, the drain seconds and
   the counts of 429, 503 and 504, beside the card's name and power limit.

13. Streaming fold-in. (a) ``ALSModel.fold_in_users(solver="device")``
   for 4,096 users unseen at train time (5 to 200 half-star events each,
   from ``--seed``: d_pad 256, a 268 MB gather) against phase 3's ML-20M
   catalog (26,744 x 64), explicit (λ 0.1) and implicit: within 5e-4
   (the reference's own fold-in tolerance) of the host float64 solve,
   two runs bitwise equal; the device path's median ms over 5 runs after
   a warm-up (CUDA events), the host solve's seconds, users per second
   and the peak device memory (``[fold-in]``). (b) Phase 9's store and
   engine: ``pio eventserver --journal-dir D --journal-partitions 2`` and
   ``pio stream --fold-in-solver device --batch-window-ms 200`` in
   processes of their own, ``pio deploy`` in this process; 32 users
   unseen at train time post 8 events each (16 to the trained app, 16 to
   an app no training reads), and each is personalized within one
   updater cycle: an answer that differs from the cold-start one, equal
   to the host exact top-N of the factor the server holds, and that
   factor within 5e-4 of the host float64 fold-in of its events (of the
   later cycle's events, for a user the updater polled across two
   cycles); then ``pio train`` and ``GET /reload``: the 16 patches of
   the users the retrain saw are discarded, the other 16 re-applied, and
   ``patchedUsers`` falls to 16. A ``[stream]`` line gives the seconds
   from the last ack to the first and to every personalized answer and
   the ``topk_rows`` launches on this path.

14. Similarity serving and the ALS template family. (a) Phase 3's
   ML-20M catalog (26,744 x 64, seeded) as the port's similarproduct model,
   its items given 1 to 3 of 20 categories from ``--seed``, deployed by an
   ``EngineServer`` of the similarproduct engine (prewarm on) behind
   ``serve()``, the launch counts set to 0 first: 16 sequential queries of
   1 to 5 query items at num 10, 256 sent at once from 64 threads in 4
   client processes, 64 at num 100 (``topk_sort``) and 32 filtered ones
   (categories, whiteList, blackList: the host path, which must launch
   nothing); every answer against a float64 host cosine top-N of the same
   factors (the same items but where two whose float64 scores differ by
   less than 1e-5 of the row's largest swap, scores within 1e-5
   relative, no query item served, every filter obeyed); single p50/p99,
   burst qps and p50/p99, the busy share over a profiled burst, and the
   ``topk`` launches (``[similar]``). (b) One app from ``--seed`` at phase
   9's scale (5,000 users, 2,000 items with categories; 100k ``view``, 20k
   ``like``/``dislike``, 10k ``buy``, 50k ``rate`` events and one
   ``constraint/unavailableItems`` ``$set``) through ``pio import``; then
   similarproduct, ecommercerecommendation and filterbycategory in turn
   through ``pio template get``, ``train`` on the card, ``deploy`` (launch
   counts set to 0 first), 16 queries each held to the host scoring of the
   stored blob's factors, and ``undeploy``; the e-commerce engine also
   answers an unseen user with views posted to ``pio eventserver`` with the
   host fold-in's top-N, and drops the items of an ``unavailableItems``
   ``$set`` posted there once its 1 s TTL has passed, without a retrain;
   then customdatasource trained from its shipped file, deployed and
   queried. Each stage's seconds and the ``topk`` launches print on a
   ``[templates]`` line.

15. The engine server's instrumentation and golden traffic. (a) Phase 3's
   ML-20M catalog (26,744 x 64, 138,493 users, seeded) served pipelined by
   an ``EngineServer`` with instrumentation on (the default), capture at
   sample 1.0 and a 512-record flight ring, the launch counts set to 0
   before its traffic: 16 sequential queries, then 256 from 64 threads in
   4 client processes, every answer the host's exact top-N. Every answered
   query's flight record sums to its wall within the reference's check (5%
   of the wall plus 0.05 ms), carries ``queue_wait``, ``batch_form``,
   ``host_assembly``, ``device_dispatch``, ``device_compute`` and
   ``result_scatter``, and a fenced ``device_compute`` above 0;
   ``/health.json`` carries ``slo`` and ``flight``, ``/metrics`` every
   ``pio_serve_stage_*`` family, and ``/stats.json``'s ``device``
   ledger the catalog and the query table at their tensors' bytes. A
   ``[waterfall]`` line gives each stage's p50/p99 ms over the burst,
   ``hostShare``/``deviceShare`` and the ``topk_rows`` launches, and the
   qps and p50 of the same burst against a server with instrumentation off
   (its cost, recorded, no bound). (b) ``POST /debug/profile?seconds=2``
   while 64 queries run: the chrome trace's CUDA kernel events name
   ``topk_rows``'s kernels (``topk_select``, ``topk_merge_round``), the
   flight snapshots bracket the window, a second POST answers 409. (c)
   ``POST /capture/stop``; the capture replayed against the same server is
   100% bitwise with an empty provenance delta; a legacy server
   (``serving_pipeline="legacy"``: ``topk``, counted from zero) replays it
   bitwise; ``POST /reload/delta`` patching 8 captured users, then the
   replay again: the mismatches are exactly those users' queries and the
   provenance delta names ``patchEpoch``; a third server shadowing to the
   legacy one answers 64 queries and ``pio_shadow_diff_total`` counts all
   64 in the legacy replay's tier. (d) ``pio deploy --capture-dir D
   --capture-sample 1.0`` of phase 9's engine in this process (launch
   counts set to 0 first), 32 queries held to the stored blob's host
   top-N, then ``pio capture stop``, ``capture export``, ``replay
   --target`` (100% bitwise, no provenance delta), ``replay`` in-process
   (the same), ``top --once``, ``trace <rid> --url`` and ``profile serve
   --seconds 1``; then ``pio undeploy``. Every engine server's flight
   incident dumps go to a directory of this run (``PIO_FLIGHT_DIR``).

16. Variants, the feedback loop and ``--prewarm-async``. (a) Phase 3's
   ML-20M model (138,493 x 26,744, rank 64, seeded) as the live variant
   and a challenger from another seed, two ``EngineServer``s co-hosted
   on the card behind one ``serve()`` at weights 0.8/0.2, capture at
   sample 1.0 on the primary (``torch.cuda.memory_allocated`` before the
   challenger's build and after its registration). 256 queries over
   distinct users from 64 threads in 4 client processes, the launch
   counts set to 0 first: each answer from the variant ``bucket_for``
   names (the ``X-PIO-Provenance`` envelope), equal to the host exact
   top-N of that variant's factors, and each variant's ``topk_rows``
   launches (its pipeline's dispatches) above 0 and summing to the
   count; 16 ``X-PIO-Variant`` queries to each variant; the capture
   replayed against the server 100% bitwise per variant; the challenger
   promoted once a third of a second 256-query burst is answered (every
   answer 200, from the variant its provenance names, by the old weights
   or the new, some of each); ``POST /reload/delta`` of 8 users to the
   challenger alone moves only the challenger's answers for them; the old
   champion retired: 64 hashed queries all reach the challenger, forced
   ones still reach it. Its qps beside phase 3's and the ledger print on
   ``[variants]`` lines. (b) On phase 9's store the recommendation
   template trained again under ``variantId`` "als-b" (another seed),
   ``pio deploy`` of phase 9's engine, ``pio deploy --variant-of PORT
   --weight 0.5`` of the second, ``pio variant weight default 0.5`` and
   ``list``: 32 queries, each from the variant the hash names and equal to
   its stored blob's host top-N; then ``pio variant promote als-b`` and
   ``retire default``: 32 more, all from "als-b". (c) The port's event
   server (``EventServing``, what ``pio eventserver`` runs, in this
   process), ``pio deploy --feedback --event-server-url --accesskey``
   (the breaker's reset cut to 2 s): 64 answers, 64
   ``predict`` events in the store with the answers' ``prId``s; the event
   server stopped: every query 200 and the breaker open after its 5
   failures; restarted: the half-open probe closes it; ``server.feedback``
   armed as an error 4 times: 4 failures counted, every answer 200. (d)
   ``pio deploy --prewarm-async``, the launch counts set to 0 first: the
   first ``/health.json`` seen, the seconds from it to ``ready``, every
   query answered while prewarming the stored blob's host top-N, and once
   ready ``topk`` launched once per lattice point (the retriever's
   prewarm) and an ``execCacheKey`` in the answers.

The ALS path (phase 3) and its num-100 path (phase 3b), the seqrec
serving path (phase 5), the seqrec training path (phase 6 b and c), the
trained ALS model's serving path (phase 7e), the storage-deployed path
(phase 8), the deployed server of the CLI quickstart (phase 9), the
served movielens winner (phase 10), the tuned winner (phase 11b), the
streaming fold-in's deployed server (phase 13b), the
wide and the huge head dims through the attention dispatch (phases 4 and
6a), the similarity server (phase 14a) and each template's deployed
server (phase 14b), the instrumented server (phase 15a), the legacy
replay (phase 15c), the deployed capture server (phase 15d), the two
co-hosted variants (phase 16a), the variants through ``pio`` (16b) and
the server deployed with ``--prewarm-async`` (16d) are each driven with
every launch count set to 0 just before and read just after; phase 12a counts ``topk_rows`` over its fallback answers. Before
the last line
it prints one JSON object with a record per kernel entry point, for
top-k's ``topk_sort`` (its launches in phase 3b) and merge rounds
(``topk_merge_round``, its launches in phase 3), and for the three wide
and the three huge attention kernels (their launches through the
dispatch, their times at the timed shape, f32; D 4,096 causal for the
huge ones): launches on its main
path, error, times and bound; the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import gc
import glob
import hashlib
import http.client
import io
import json
import os
import socket
import sqlite3
import statistics
import subprocess
import sys
import tempfile
import signal
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import warnings
from concurrent.futures import ThreadPoolExecutor
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
from predictionio_tpu_torch.obs.capture import iter_capture
from predictionio_tpu_torch.obs.device import LEDGER
from predictionio_tpu_torch.obs.flight import FLIGHT
from predictionio_tpu_torch.obs.metrics import METRICS
from predictionio_tpu_torch.obs.replay import replay_records
from predictionio_tpu_torch.obs.waterfall import STAGES
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
from predictionio_tpu_torch.api.event_server import EventServing
from predictionio_tpu_torch.store import EventStore
from predictionio_tpu_torch.workflow import feedback as feedback_mod
from predictionio_tpu_torch.workflow.faults import FAULTS
from predictionio_tpu_torch.workflow.serialization import deserialize_models
from predictionio_tpu_torch.workflow.variants import VARIANT_HEADER, bucket_for

# the float64 ALS sweeps the CPU tests hold trained factors to (numpy alone)
sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests"))
from torch_als64 import als64  # noqa: E402

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
WIDE_SOURCE = "predictionio_tpu_torch/csrc/flash_attn_wide.cu"
WIDE_FWD_SOURCE = "predictionio_tpu_torch/csrc/flash_attn_wide_fwd.cu"
# the wide kernels replace no TPU kernel: the JAX package answers head dims
# above 256 with its plain blockwise_attention, called here
WIDE_REPLACES = "none (predictionio_tpu/parallel/ring_attention.py:212)"
HUGE_SOURCE = "predictionio_tpu_torch/csrc/flash_attn_huge.cu"
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


def build_server(dev, *, n_users=N_USERS, n_items=N_ITEMS, rank=RANK,
                 seed=SEED, **server_args):
    rng = np.random.default_rng(seed)
    scale = 1 / np.sqrt(rank)
    users = (rng.standard_normal((n_users, rank)) * scale).astype(np.float32)
    items = (rng.standard_normal((n_items, rank)) * scale).astype(np.float32)
    model = als_model_from_numpy(
        users, items, [f"u{i}" for i in range(n_users)],
        [f"i{j}" for j in range(n_items)], rank=rank, lambda_=0.1,
        device=dev)
    result = TrainResult([model], [ALSAlgorithm(AlgorithmParams(rank=rank))],
                         FirstServing(), ["als"])
    return EngineServer(engine_factory(), result, "chip-smoke", device=dev,
                        **server_args)


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
#: seconds, monotonic start, monotonic end, provenance header] per query. One connection per
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
    return [json.loads(raw), t1 - t0, t0, t1,
            resp.getheader("X-PIO-Provenance")]

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


def burst(url: str, queries: list, procs: int, threads: int, *,
          provenance: bool = False):
    """Send ``queries`` from ``procs`` client processes of ``threads``
    threads each: ([(body, wall s)] in query order, with the answer's
    provenance envelope third when ``provenance``, seconds from the first
    send to the last answer). A client fails on any answer but 200."""
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
            answers[j] = ((r[0], r[1], json.loads(r[4])) if provenance
                          else (r[0], r[1]))
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
#: head dims above 256 through the dispatch, which pads them to a width of
#: the wide kernels (csrc/flash_attn_wide_fwd.cu, csrc/flash_attn_wide.cu:
#: D 320 to 384) or gives them as they are (D 512 to 1024); the forward's
#: cluster has D / 128 CTAs, so D 384 to 1024 run every cluster size from 3
#: to 8; phases 4 and 6a (6a takes D 320 and 1024)
WIDE_HEAD_DIM_CASES = [
    (f"{case} causal {tag}", B, L, H, D, dtype, True)
    for case, B, L, H, D in (("wide D320 B2 L200 H2", 2, 200, 2, 320),
                             ("wide D512 B2 L256 H2", 2, 256, 2, 512),
                             ("wide D1024 B1 L256 H2", 1, 256, 2, 1024))
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16"))
] + [
    (f"wide D{D} B1 L200 H2 {'causal' if causal else 'full'} {tag}", 1, 200,
     2, D, dtype, causal)
    for D in (640, 768, 896) for causal in (True, False)
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16"))
]
#: the wide kernels' timed shape (phases 4 and 6a)
WIDE_TIMED_CASES = [
    (f"wide timed B2 L2048 H4 D512 causal {tag}", 2, 2048, 4, 512, dtype,
     True) for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16"))]
WIDE_TIMED_CASE = WIDE_TIMED_CASES[0][0]
#: head dims above 1,024 (csrc/flash_attn_huge.cu), which the dispatch gives
#: as they are: B1 L1024 H2 at D 1,536 and 4,096, causal and not, f32 and
#: bf16; phases 4 and 6a, each through the dispatch counted from zero, then
#: timed at the kernels line's shape alone
HUGE_HEAD_DIM_CASES = [
    (f"huge D{D} B1 L1024 H2 {'causal' if causal else 'full'} {tag}", 1,
     1024, 2, D, dtype, causal)
    for D in (1536, 4096) for causal in (True, False)
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16"))]
#: the huge kernels' record in the kernels line, and their timed shape in
#: both types
HUGE_TIMED_CASE = "huge D4096 B1 L1024 H2 causal f32"
HUGE_TIMED_NAMES = (HUGE_TIMED_CASE, "huge D4096 B1 L1024 H2 causal bf16")
#: the huge backward at a length whose dK/dV workspace takes two bands
#: (128 own key tiles of 4 MiB against the 256 MiB cap); phase 6a
HUGE_BANDED_CASES = [("huge D1152 B1 L8192 H1 causal f32 two bands", 1,
                      8192, 1, 1152, "float32", True)]
#: the huge forward at the same length in bf16, whose workspace takes two
#: bands (128 own query tiles of 3 MiB, f32 S and bf16 P); phase 4
HUGE_FWD_BANDED_CASES = [("huge D1152 B1 L8192 H1 causal bf16 two bands",
                          1, 8192, 1, 1152, "bfloat16", True)]
SERVING_CASE = "serving B8 L4096 H8 D64 causal f32"
#: the attention fixtures timed in phases 4 and 6a: those the kernels line
#: and PERF.md's kernel table read (the serving and training shape, the
#: seqrec shape at f32 and bf16, the wide and the huge kernels' timed
#: shapes); every other fixture is held against the plain versions
#: untimed
TIMED_ATTN_CASES = frozenset({
    SERVING_CASE, "seqrec B4 L4096 H8 D64 causal f32",
    "seqrec B4 L4096 H8 D64 causal bf16", *HUGE_TIMED_NAMES,
    *(case[0] for case in WIDE_TIMED_CASES)})
#: phase 4's timed pass over the huge head dims
HUGE_TIMED_CASES = [case for case in HUGE_HEAD_DIM_CASES
                    if case[0] in HUGE_TIMED_NAMES]
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


def sdpa_backend(fn) -> str:
    """The backend ``scaled_dot_product_attention`` chose for ``fn``, from
    the names of the kernels one profiled call ran."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(e.key.lower() for e in prof.key_averages())
    for tag, backend in (("flash", "flash"), ("cudnn", "cudnn"),
                         ("fmha", "efficient"), ("efficient", "efficient")):
        if tag in names:
            return backend
    return "math"


def attention_case(dev, name, B, L, H, D, dtype, causal, *, timing):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + B * L + D)
    q, k, v = (torch.randn(B, L, H, D, generator=gen, device=dev)
               .mul_(0.5).to(dt) for _ in range(3))
    before = dict(kernels.LAUNCHES)
    out = flash_attention(q, k, v, causal=causal)
    moved = {key: kernels.LAUNCHES[key] - before[key] for key in (
        "flash_attention", "flash_attention_wide", "flash_attention_huge")}
    # every head dim here reaches a kernel (padded where it must be), the
    # wide one above 256, the huge one above 1,024; a CPU tensor runs the
    # plain version and launches nothing
    n, route = int(dev.type == "cuda"), kernels._route(D)
    want = {"flash_attention": n, "flash_attention_wide": n * (route == "wide"),
            "flash_attention_huge": n * (route == "huge")}
    check(moved == want, f"{name}: kernel launches {moved}, want {want}")
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
           "kernel_launches": moved["flash_attention"],
           "wide_launches": moved["flash_attention_wide"],
           "huge_launches": moved["flash_attention_huge"]}
    if route != "narrow" and n:
        # every sum runs in one fixed order: a second run gives the same
        # bits (its launch counts as the path's too)
        rec["repeat_bitwise"] = torch.equal(
            out, flash_attention(q, k, v, causal=causal))
        check(rec["repeat_bitwise"], f"{name}: the {route} forward's output "
              f"differs between two runs")
    if route == "huge" and n:
        # the forward that writes the logsumexp (the backward's residual):
        # the same output bits, and the logsumexp of the plain version
        lse = torch.empty(B, H, L, device=dev)
        rec["lse_bitwise"] = torch.equal(
            out, kernels.flash_attention_fwd(q, k, v, causal=causal,
                                             lse=lse))
        check(rec["lse_bitwise"], f"{name}: the huge forward's output "
              f"changes when it writes the logsumexp")
        ref_lse = chunked_blockwise_lse(q, k, v, causal=causal)[1]
        rec["lse_max_abs_err"] = float((lse - ref_lse).abs().max())
        check(bool(torch.allclose(lse, ref_lse, rtol=LSE_TOL, atol=LSE_TOL)),
              f"{name}: the huge forward's logsumexp disagrees with "
              f"blockwise_attention ({rec['lse_max_abs_err']:.3g})")
        del lse, ref_lse
    del out, ref
    if timing:
        iters, reps = ((2, 3) if B * L * L * H >= 1 << 34 or D > 1024
                       else (10, 5))
        rec["ms"] = device_ms(lambda: flash_attention(q, k, v, causal=causal),
                              iters, reps)
        rec["plain_ms"] = device_ms(
            lambda: chunked_blockwise(q, k, v, causal=causal), iters, reps)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal)

        rec["library_ms"] = device_ms(sdpa, iters, reps)
        if D > 256:
            rec["library_backend"] = sdpa_backend(sdpa)
        rec["bound_ms"], rec["bound_by"] = attn_bound_ms(B, L, H, D, dt,
                                                         causal)
    return rec


def phase_attention(dev, cases=ATTN_CASES + HEAD_DIM_CASES
                    + WIDE_HEAD_DIM_CASES + WIDE_TIMED_CASES, *,
                    timing=True) -> list:
    """Every case against the plain version; with ``timing``, the cases
    of ``TIMED_ATTN_CASES`` also timed."""
    recs = []
    for case in cases:
        recs.append(attention_case(
            dev, *case, timing=timing and case[0] in TIMED_ATTN_CASES))
        print("[attention] " + json.dumps(recs[-1]), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return recs


def wide_plans(B=2, L=2048, H=4) -> dict:
    """The wide kernels' launches at every wide head dim and type, as the
    card reports them (``pio_flash_attn_wide_fwd_plan``, and
    ``pio_flash_attn_wide_bwd_plan`` for dK/dV and dQ), each held equal to
    ``kernels.wide_fwd_plan``'s or ``kernels.wide_bwd_plan``'s; with the
    clusters the card holds at once."""
    out = {}
    for D in range(384, kernels.WIDE_MAX_HEAD_DIM + 1, 128):
        for dtype in (torch.float32, torch.bfloat16):
            for kind, what in ((0, "fwd"), (2, "dkv"), (1, "dq")):
                if kind:
                    card = kernels.wide_bwd_plan_on_card(B, L, H, D, dtype,
                                                         True, kind)
                    plan = kernels.wide_bwd_plan(B, L, H, D, dtype, kind)
                else:
                    card = kernels.wide_fwd_plan_on_card(B, L, H, D, dtype,
                                                         True)
                    plan = kernels.wide_fwd_plan(B, L, H, D, dtype)
                check([card[key] for key in (
                    "cluster", "grid_x", "grid_y", "grid_z", "threads",
                    "smem_bytes")] == [plan["cluster"], *plan["grid"],
                                       plan["threads"], plan["smem_bytes"]],
                      f"the wide {what} plan at D {D} {dtype}: the card's "
                      f"{card}, kernels' {plan}")
                out[f"D{D} {str(dtype)[6:]} {what}"] = card
    return out


def huge_plans() -> dict:
    """The huge kernels' launches (each pass of the first band, the band and
    the workspace) as the card reports them (``pio_flash_attn_huge_fwd_plan``
    for the forward's score, softmax and product passes,
    ``pio_flash_attn_huge_bwd_plan`` for the backward's score and product
    passes) at the timed and the banded shape, both types, every kind and
    both masks, each held equal to ``kernels.huge_fwd_plan``'s or
    ``kernels.huge_bwd_plan``'s; with the CTAs an SM holds at once."""
    out = {}
    for B, L, H, D in ((1, 1024, 2, 4096), (1, 8192, 1, 1152)):
        for dtype in (torch.float32, torch.bfloat16):
            for kind, what in ((0, "fwd"), (2, "dkv"), (1, "dq")):
                for causal in (True, False):
                    if kind:
                        card = kernels.huge_bwd_plan_on_card(
                            B, L, H, D, dtype, causal, kind)
                        plan = kernels.huge_bwd_plan(B, L, H, D, dtype,
                                                     kind, causal)
                        passes = ("score", "product")
                        fields = kernels._HUGE_PLAN_FIELDS
                    else:
                        card = kernels.huge_fwd_plan_on_card(
                            B, L, H, D, dtype, causal)
                        plan = kernels.huge_fwd_plan(B, L, H, D, dtype,
                                                     causal)
                        passes = ("score", "softmax", "product")
                        fields = kernels._HUGE_FWD_PLAN_FIELDS
                    want = [plan["band_tiles"], plan["band_heads"],
                            len(plan["bands"]), plan["workspace_bytes"]]
                    for pass_ in passes:
                        want += [*plan[pass_]["grid"],
                                 plan[pass_]["threads"],
                                 plan[pass_]["smem_bytes"]]
                    got = [card[key] for key in fields
                           if not key.endswith("blocks_per_sm")]
                    check(got == want,
                          f"the huge {what} plan at B{B} L{L} H{H} D{D} "
                          f"{dtype} causal={causal}: the card's {card}, "
                          f"kernels' {want}")
                    out[f"B{B} L{L} H{H} D{D} {str(dtype)[6:]} {what} "
                        f"{'causal' if causal else 'full'}"] = card
    return out


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
#: the wide kernels at a width they take as it is (D 1024), and at their
#: timed shape
WIDE_BWD_CASES = [case for case in WIDE_HEAD_DIM_CASES
                  if case[4] == 1024] + WIDE_TIMED_CASES
BWD_CASES += WIDE_BWD_CASES + HUGE_HEAD_DIM_CASES + HUGE_BANDED_CASES
#: head dims through the autograd dispatch in phase 6a: phase 4's, and the
#: wide D 320 (padded to 384) and D 1024
WIDE_BWD_HEAD_DIM_CASES = [case for case in WIDE_HEAD_DIM_CASES
                           if case[4] in (320, 1024)]
BWD_HEAD_DIM_CASES = HEAD_DIM_CASES + WIDE_BWD_HEAD_DIM_CASES
TRAIN_CASE = SERVING_CASE
#: cases whose gradients are computed twice and held bitwise equal: the
#: kernels use no atomics and sum in a fixed order
REPEAT_CASES = (TRAIN_CASE, "seqrec B4 L4096 H8 D64 causal bf16",
                *(case[0] for case in WIDE_BWD_CASES + HUGE_HEAD_DIM_CASES
                  + HUGE_BANDED_CASES))
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
        iters, reps = ((2, 3) if B * L * L * H >= 1 << 34 or D > 1024
                       else (10, 5))
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

        def sdpa_bwd():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

        rec["library_ms"] = device_ms(sdpa_bwd, iters, reps)
        if D > 256:
            rec["library_backend"] = sdpa_backend(sdpa_bwd)
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
    n, route = int(dev.type == "cuda"), kernels._route(D)
    want_moved = dict.fromkeys(before, 0)
    for entry in ("flash_attention", "flash_attention_bwd_dkv",
                  "flash_attention_bwd_dq"):
        want_moved[entry] = n
        if route != "narrow":
            want_moved[entry.replace("flash_attention",
                                     f"flash_attention_{route}")] = n
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


def phase_attention_bwd(dev, cases=BWD_CASES,
                        head_dim_cases=BWD_HEAD_DIM_CASES, *,
                        timing=True) -> list:
    """Every case against the plain versions; with ``timing``, the cases
    of ``TIMED_ATTN_CASES`` also timed."""
    recs = []
    for case in cases:
        recs.append(bwd_case(dev, *case,
                             timing=timing and case[0] in TIMED_ATTN_CASES))
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


@functools.lru_cache(maxsize=1)
def ml20m_layout(n_ratings: int, n_users: int, n_items: int, rank: int):
    """Phase 7's synthetic ML-20M ratings, their bilinear layout (both
    sides) and the seconds the layout alone took; kept for phase 11a,
    which asks again with the same arguments."""
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


def numpy_layout_start(n_ratings: int, n_users: int, n_items: int,
                       rank: int) -> subprocess.Popen:
    """``numpy_layout_child`` started in a fresh interpreter with the
    native library switched off by ``PIO_NO_NATIVE=1``; it runs while the
    caller goes on (``numpy_layout_finish`` collects it)."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.numpy_layout_child()",
         json.dumps([n_ratings, n_users, n_items, rank])],
        cwd=here, env={**os.environ, "PIO_NO_NATIVE": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(proc.kill)  # a failed check must not leave it running
    return proc


def numpy_layout_finish(proc: subprocess.Popen) -> dict:
    stdout, stderr = proc.communicate(timeout=600)
    check(proc.returncode == 0,
          f"the numpy layout process failed:\n{stderr[-4000:]}")
    got = json.loads(stdout.strip().splitlines()[-1])
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
    # the numpy layout runs beside (a) to (d) and is collected before (e)
    np_proc = numpy_layout_start(n_ratings, n_users, n_items, rank)
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
    np_run = numpy_layout_finish(np_proc)
    out["layout_numpy_s"] = np_run["layout_s"]
    for side, lay, digest in (("users", u_lay, np_run["digests"][0]),
                              ("items", i_lay, np_run["digests"][1])):
        check(layout_digest(lay) == digest,
              f"the native and numpy {side} layouts differ")
    print(f"[als-train] layout at {n_ratings:,} ratings: native "
          f"{out['layout_s']:.3f} s, numpy {out['layout_numpy_s']:.3f} s "
          f"(beside 7a-d), equal array for array", flush=True)

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


# -- phase 11a: the tuning grid at the north-star shape -----------------

#: phase 11a's grid: (rank, λ) trials, two rank groups of two lanes
TUNE_GRID = ((64, 0.01), (64, 0.1), (32, 0.01), (32, 0.1))
TUNE_ITERS = 3


def phase_tune_grid(dev, *, n_ratings=N_RATINGS, n_users=N_USERS,
                    n_items=N_ITEMS, grid=TUNE_GRID, iters=TUNE_ITERS) -> dict:
    """``train_als_grid`` on phase 7's ML-20M ratings and layout (rank 64
    and 32, each at λ 0.01 and 0.1, ``iters`` iterations, f32), twice,
    against four serial ``train_als`` runs of the same configs: every
    trial's factors bitwise equal to its serial run's and to the first
    grid run's. Both trainers get phase 7's layout (``ml20m_layout``: what
    ``build_bilinear_layout`` makes of these ratings at ALSConfig's
    defaults), so no run pays for the host layout. Times: each call's
    wall seconds (upload, init, iterations, download), the grid's step
    seconds (its convergence probe synchronizes the card before reading
    the clock) against the sum of the serial steps
    (``make_train_step`` from the same init, synchronized), and the peak
    device memory of each grid run."""
    (users, items, vals), (u_lay, i_lay), _ = ml20m_layout(
        n_ratings, n_users, n_items, RANK)
    ratings = als_ratings(users, items, vals, n_users, n_items)
    configs = [ALSConfig(rank=r, iterations=iters, lambda_=lam)
               for r, lam in grid]
    out: dict = {"trials": [[r, lam] for r, lam in grid],
                 "iterations": iters, "n_ratings": n_ratings}
    built = als.build_bilinear_layout
    als.build_bilinear_layout = lambda *a, **k: (u_lay, i_lay)
    try:
        runs = []
        for run in range(2):
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            steps: dict = {}
            t0 = time.perf_counter()
            runs.append(als.train_als_grid(
                ratings, configs, device=dev,
                observe=lambda i, it, loss, d, s: steps.setdefault(it, s)))
            sync(dev)
            out[f"grid_run{run}_s"] = time.perf_counter() - t0
            out[f"grid_run{run}_step_s"] = [steps[it] for it in sorted(steps)]
            if dev.type == "cuda":
                out[f"grid_run{run}_peak_gib"] = (
                    torch.cuda.max_memory_allocated() / 2**30)
        serial, serial_s = [], []
        for cfg in configs:
            t0 = time.perf_counter()
            serial.append(train_als(ratings, cfg, device=dev))
            sync(dev)
            serial_s.append(time.perf_counter() - t0)
    finally:
        als.build_bilinear_layout = built
    out["serial_s"] = serial_s
    for k, cfg in enumerate(configs):
        for name, got in (("grid", runs[0][k]), ("second grid", runs[1][k])):
            want = serial[k] if name == "grid" else runs[0][k]
            check(np.array_equal(got.user_factors, want.user_factors)
                  and np.array_equal(got.item_factors, want.item_factors),
                  f"{name} trial {k} (rank {cfg.rank}, λ {cfg.lambda_}) "
                  f"differs from "
                  f"{'its serial train_als' if name == 'grid' else 'the first grid run'}"
                  f": largest user gap "
                  f"{np.abs(got.user_factors - want.user_factors).max():.3g}")
    out["bitwise"] = True
    del runs, serial

    # the serial steps, synchronized, from train_als's init
    ub, ib = (als.put_layout(lay, dev) for lay in (u_lay, i_lay))
    k_u, k_v = als.prng.split(als.prng.PRNGKey(configs[0].seed))
    step_s = []
    for cfg in configs:
        u = als.to_slots(np.abs(als.prng.normal(k_u, (n_users, cfg.rank)))
                         / np.sqrt(cfg.rank), u_lay, dev)
        v = als.to_slots(np.abs(als.prng.normal(k_v, (n_items, cfg.rank)))
                         / np.sqrt(cfg.rank), i_lay, dev)
        step = make_train_step(u_lay, i_lay, rank=cfg.rank,
                               lambda_=cfg.lambda_)
        per = []
        for _ in range(iters):
            sync(dev)
            t0 = time.perf_counter()
            u, v = step(ub, ib, u, v)
            sync(dev)
            per.append(time.perf_counter() - t0)
        step_s.append(per)
    del ub, ib, u, v
    out["serial_step_s"] = step_s
    grid_step = float(np.median(out["grid_run1_step_s"]))
    serial_sum = float(sum(np.median(per) for per in step_s))
    out.update(grid_step_median_s=grid_step,
               serial_step_sum_median_s=serial_sum,
               grid_over_serial_step=grid_step / serial_sum,
               grid_over_serial_call=out["grid_run1_s"] / sum(serial_s))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# -- phase 8: events to answers -----------------------------------------

#: the reference's e2e quickstart shape (bench.py:686-760): 200,000 rate
#: events over 5,000 users x 2,000 items, ratings in steps of 0.5; plus
#: 10,000 buy events (rating 4 through the data source's rating_of)
QS_USERS, QS_ITEMS, QS_RATES, QS_BUYS = 5_000, 2_000, 200_000, 10_000
#: the recommendation template's own app, which ``RecommendationEvaluation``
#: reads: phase 10 evaluates phase 9's store
QS_APP = "MyApp"
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
    return stored_models(iid)[0]


def stored_models(iid: str) -> list:
    """Every model of an instance's stored blob, on the host."""
    blob = pio_storage.Storage.get_models().get(iid)
    return deserialize_models(blob.models)


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
    out["home"] = home
    Storage.reset()
    return out


# -- phase 10: evaluation -----------------------------------------------


#: the movielens walkthrough's app
ML_APP = "mlapp"
ML_GEN = ("predictionio_tpu_torch/templates/movielensevaluation/data/"
          "gen_movielens.py")
#: the near-tie width of a reference row: max(TIE_TOL x the row's largest
#: |score|, TIE_F64 x the row's largest gap to the float64 sweeps' scores)
#: (tests/test_torch_eval_workflow.py::_near_ties)
TIE_TOL, TIE_F64 = 1e-3, 5


def fold_f64(ratings, cfg: ALSConfig):
    """The float64 sweeps of ``cfg``'s ALS on ``ratings`` from
    ``train_als``'s init (``tests/torch_als64.py``): the yardstick of the
    fold rule."""
    from predictionio_tpu_torch import prng

    k_u, k_v = prng.split(prng.PRNGKey(cfg.seed))
    rank = cfg.rank
    v0 = np.abs(prng.normal(k_v, (ratings.num_items, rank))) / np.sqrt(rank)
    u0 = np.abs(prng.normal(k_u, (ratings.num_users, rank))) / np.sqrt(rank)
    return als64(ratings.user_indices, ratings.item_indices,
                 ratings.ratings, ratings.num_users, ratings.num_items,
                 u0, v0, iters=cfg.iterations, lambda_=cfg.lambda_)


def factor_gaps(card, cpu, u64, v64) -> dict:
    """One fold's factor gaps, relative to the largest entry, for the fold
    rule of tests/test_torch_eval_workflow.py::_factor_rule with the CPU
    run as the reference and the float64 sweeps (``u64``, ``v64``) as the
    yardstick: per side the card's and the CPU's largest-entry gap to
    float64, and the card's to the CPU's (reported)."""

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    return {side: {"max_card_f64": rel(mine, exact),
                   "max_cpu_f64": rel(ref, exact),
                   "max_card_cpu": rel(mine, ref)}
            for side, mine, ref, exact in (
                ("user", card.user_factors, cpu.user_factors, u64),
                ("item", card.item_factors, cpu.item_factors, v64))}


def top_k(scores: np.ndarray, k: int) -> np.ndarray:
    """Each row's k best columns, best first."""
    part = np.argpartition(-scores, k - 1, axis=1)[:, :k]
    o = np.argsort(-np.take_along_axis(scores, part, 1), axis=1,
                   kind="stable")
    return np.take_along_axis(part, o, 1)


def prediction_agreement(card, cpu, qa: list, u64, v64) -> dict:
    """The card's eval predictions of a fold against the CPU run's, under
    the list rule of tests/test_torch_eval_workflow.py, a property of
    the CPU row alone: with scores over the row's largest |score|, the
    row's near-tie width is max(``TIE_TOL``, ``TIE_F64`` x the row's
    largest gap to the float64 sweeps' scores); a list breaks the rule
    (``beyond_tie``) where, at a position the two lists differ, the
    card's item is in the CPU list and the CPU scores there have no
    neighbour within the width, or where an item only the card lists
    lies the width or more from the CPU's k-th score. HitRate can then
    move only at ``hit_movable`` queries: a tie at the list's boundary
    (k-th and k+1-th CPU scores within the width) and the held-out item
    in the CPU list or within the width of its k-th score.
    ``hit_flips_unexplained`` counts the queries whose hit differs
    anywhere else. Each user's lists are computed once; the counts are
    of queries."""
    k = qa[0][0].num
    rows = np.asarray([cpu.user_ids[q.user] for q, _ in qa])
    actual = np.asarray([cpu.item_ids[a["item"]] for _, a in qa])
    users, at = np.unique(rows, return_inverse=True)
    c_idx = top_k(card.user_factors[users] @ card.item_factors.T, k)
    ref = (cpu.user_factors[users] @ cpu.item_factors.T).astype(np.float64)
    scale = np.maximum(np.abs(ref).max(1, keepdims=True), 1e-30)
    eps = np.abs(ref - u64[users] @ v64.T).max(1, keepdims=True)
    ref /= scale
    tol = np.maximum(TIE_TOL, TIE_F64 * eps / scale)  # [U, 1]
    r_all = top_k(ref, k + 1)
    r_idx, s_ref = r_all[:, :k], np.take_along_axis(ref, r_all, 1)
    gap = np.abs(np.diff(s_ref, axis=1)) < tol  # [U, k]
    near = gap.copy()  # position j: the neighbour below...
    near[:, 1:] |= gap[:, :-1]  # ...or above within the width
    member = (c_idx[:, :, None] == r_idx[:, None, :]).any(2)
    moved = (c_idx != r_idx) & member
    outsider = ~member & (np.abs(np.take_along_axis(ref, c_idx, 1)
                                 - s_ref[:, k - 1:k]) >= tol)
    differ = (c_idx != r_idx).any(1)[at]
    beyond = ((moved & ~near) | outsider).any(1)[at]
    boundary = gap[at, k - 1]
    hit_c = (c_idx[at] == actual[:, None]).any(1)
    hit_r = (r_idx[at] == actual[:, None]).any(1)
    movable = boundary & (hit_r | (np.abs(ref[at, actual]
                                          - s_ref[at, k - 1]) < tol[at, 0]))
    flips = hit_c != hit_r
    return {"queries": len(qa), "differ": int(differ.sum()),
            "beyond_tie": int(beyond.sum()),
            "boundary_ties": int(boundary.sum()),
            "hit_movable": int(movable.sum()),
            "hit_flips": int(flips.sum()),
            "hit_flips_unexplained": int((flips & ~movable).sum()),
            "hits_card": int(hit_c.sum()), "hits_cpu": int(hit_r.sum()),
            "width_median": float(np.median(tol))}


@contextlib.contextmanager
def timed_methods(sink: dict, *targets):
    """Time every call of each ``(class, method name, key)`` into
    ``sink[key]`` (a list of seconds) while the block runs."""
    saved = []
    for cls, name, key in targets:
        orig = getattr(cls, name)
        sink.setdefault(key, [])

        def wrapper(*a, _orig=orig, _key=key, **kw):
            t = time.perf_counter()
            try:
                return _orig(*a, **kw)
            finally:
                sink[_key].append(time.perf_counter() - t)

        saved.append((cls, name, orig))
        setattr(cls, name, wrapper)
    try:
        yield sink
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)


def leaderboard(text: str) -> str:
    """The leaderboard lines ``pio eval`` printed (without the instance
    line)."""
    return "\n".join(ln for ln in text.splitlines()
                     if ln.startswith(("MetricEvaluator", "  ")))


def phase_evaluation(dev, cli: dict | None = None, *, seed=SEED,
                     n_users=QS_USERS, n_items=QS_ITEMS, n_rates=QS_RATES,
                     n_buys=QS_BUYS, ml_users=400, ml_items=200,
                     ml_ratings=20_000, n_seq=16) -> dict:
    """``pio eval`` through the port's console in this process, on phase
    8's events as app ``MyApp``: in phase 9's store where ``cli`` (phase
    9's record) is given, else imported here first. ``pio eval
    engine:RecommendationEvaluation`` (3 folds x 4 variants, each fold
    trained on ``dev``) and the same with ``--fast``: leaderboards and
    best.json bitwise equal, records EVALCOMPLETED. Then the best
    variant's folds retrained on the CPU through the template and held to
    the card's run under the fold rule (``factor_gaps``,
    ``prediction_agreement``): the pooled float64 clause, the 1e-2
    ceiling, the list rule and HitRate within its movable share each
    raise. Then the movielensevaluation walkthrough: generator, ``import``,
    ``eval``, ``train --engine-json best.json`` and 16 queries served in
    process, each the host exact top-N of the stored factors."""
    from predictionio_tpu_torch.controller.evaluation import MetricEvaluator
    from predictionio_tpu_torch.templates.movielensevaluation import (
        engine as ml_engine)
    from predictionio_tpu_torch.templates.recommendation import (
        engine as rec_engine)

    out: dict = {"users": n_users, "items": n_items, "rates": n_rates,
                 "buys": n_buys}
    home = cli["home"] if cli else tempfile.mkdtemp(prefix="pio-chip-eval-")
    os.environ["PIO_HOME"] = home
    if dev.type == "cpu":
        os.environ["PIO_PLATFORM"] = "cpu"
    else:
        os.environ.pop("PIO_PLATFORM", None)
    Storage = pio_storage.Storage
    Storage.reset()
    meta = Storage.get_metadata

    if cli:
        out["import_s"], out["import_of"] = cli["import_s"], "phase 9"
    else:
        events_file = os.path.join(home, "events.jsonl")
        with open(events_file, "w") as fh:
            for e in quickstart_events(seed, n_users, n_items, n_rates,
                                       n_buys):
                fh.write(json.dumps(pio_storage.event_to_api_dict(e)) + "\n")
        pio_ok(["app", "new", QS_APP])
        t0 = time.perf_counter()
        pio_ok(["import", "--appid", meta().app_get_by_name(QS_APP).id,
                "--input", events_file])
        out["import_s"], out["import_of"] = time.perf_counter() - t0, "here"
    engine_dir = os.path.join(home, "evalengine")
    pio_ok(["template", "get", "recommendation", engine_dir])
    argv = ["eval", "--engine-dir", engine_dir,
            "engine:RecommendationEvaluation"]

    # the plain run: every stage timed, every fold's model and the folds
    # kept (the card's side of step 2)
    stages: dict = {}
    folds: list = []
    trained: list = []
    read_eval = rec_engine.RecommendationDataSource.read_eval
    train = rec_engine.ALSAlgorithm.train

    def keep_folds(self, ctx):
        folds[:] = read_eval(self, ctx)
        return folds

    def keep_model(self, ctx, ratings):
        model = train(self, ctx, ratings)
        trained.append((self.params, ratings, model))
        return model

    rec_engine.RecommendationDataSource.read_eval = keep_folds
    rec_engine.ALSAlgorithm.train = keep_model
    try:
        with timed_methods(
                stages,
                (rec_engine.RecommendationDataSource, "read_eval",
                 "read_eval"),
                (rec_engine.ALSAlgorithm, "train", "train"),
                (rec_engine.ALSAlgorithm, "batch_predict", "host_scoring"),
                (MetricEvaluator, "evaluate", "metrics")):
            t0 = time.perf_counter()
            plain = pio_ok(argv)
            out["eval_s"] = time.perf_counter() - t0
    finally:
        rec_engine.RecommendationDataSource.read_eval = read_eval
        rec_engine.ALSAlgorithm.train = train
    with open(os.path.join(engine_dir, "best.json")) as fh:
        best = json.load(fh)
    check(len(trained) == 12 and len(folds) == 3,
          f"pio eval trained {len(trained)} folds, read {len(folds)} folds")
    out["read_eval_s"] = sum(stages["read_eval"])
    out["fold_train_mean_s"] = statistics.mean(stages["train"])
    out["fold_train_max_s"] = max(stages["train"])
    out["host_scoring_s"] = sum(stages["host_scoring"])
    out["metrics_s"] = sum(stages["metrics"])
    out["queries"] = sum(len(qa) for _, _, qa in folds)

    t0 = time.perf_counter()
    fast = pio_ok(argv[:1] + ["--fast"] + argv[1:])
    out["eval_fast_s"] = time.perf_counter() - t0
    with open(os.path.join(engine_dir, "best.json")) as fh:
        best_fast = json.load(fh)
    out["leaderboard"] = leaderboard(plain).splitlines()
    check(leaderboard(plain) == leaderboard(fast) and best == best_fast,
          f"--fast differs from the plain run:\n{plain}\n{fast}")
    hits = fast.split("FastEval prefix cache hits: ")[1].splitlines()[0]
    out["fast_eval_hits"] = hits
    check(hits == "{'preparator': 3}", f"FastEval hits {hits}")
    records = sorted(meta().evaluation_instance_get_all(), key=lambda i: i.id)
    check([r.status for r in records] == ["EVALCOMPLETED"] * 2
          and records[0].evaluator_results == records[1].evaluator_results,
          "evaluation records "
          f"{[(r.status, r.evaluator_results) for r in records]}")
    out["best"] = best["algorithmsParams"]
    out["scores"] = [row["score"][0] for row in json.loads(
        records[0].evaluator_results_json)["engineParamsScores"]]
    out["home"], out["engine_dir"] = home, engine_dir

    # step 2: the best variant's folds retrained on the CPU through the
    # template, held to the card's models and metric
    bp = best["algorithmsParams"][0]["params"]
    params = rec_engine.AlgorithmParams(**bp)
    cards = [(r, m) for p, r, m in trained if p == params]
    check(len(cards) == 3, f"{len(cards)} card models of {params}")
    cfg = rec_engine.ALSAlgorithm(params).als_config()
    cpu_ctx = Context(device="cpu")
    t0 = time.perf_counter()
    cpu_models = [rec_engine.ALSAlgorithm(params).train(cpu_ctx, r)
                  for r, _ in cards]
    out["cpu_retrain_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs = out["card_vs_cpu"] = []
    for f, ((ratings, card), cpu, (_, _, qa)) in enumerate(
            zip(cards, cpu_models, folds)):
        u64, v64 = fold_f64(ratings, cfg)
        runs.append({"fold": f, **factor_gaps(card, cpu, u64, v64),
                     **prediction_agreement(card, cpu, qa, u64, v64)})
    out["card_vs_cpu_s"] = time.perf_counter() - t0
    total = {key: sum(r[key] for r in runs) for key in (
        "hits_card", "hits_cpu", "hit_movable")}
    out.update(hit_card=total["hits_card"] / out["queries"],
               hit_cpu=total["hits_cpu"] / out["queries"],
               hit_bound=total["hit_movable"] / out["queries"])
    # the fold rule: pooled over the folds and both sides, the card's
    # float64 gap within max(1e-4, 4 x the CPU run's), each one within
    # 1e-2, and the lists equal but at near-ties
    gaps = [r[side] for r in runs for side in ("user", "item")]
    card_gap = max(g["max_card_f64"] for g in gaps)
    cpu_gap = max(g["max_cpu_f64"] for g in gaps)
    out["fold_rule"] = {"card_f64": card_gap, "cpu_f64": cpu_gap,
                        "ratio": card_gap / cpu_gap, "bound": 4}
    check(card_gap <= max(1e-4, 4 * cpu_gap),
          f"the card's folds are {card_gap:.3g} from float64, the CPU "
          f"run's {cpu_gap:.3g}: beyond 4 times")
    for r in runs:
        check(max(r["user"]["max_card_f64"],
                  r["item"]["max_card_f64"]) <= 1e-2,
              f"fold {r['fold']}: card factors beyond 1e-2 of float64 "
              f"{json.dumps(r)}")
        check(r["beyond_tie"] == 0,
              f"fold {r['fold']}: {r['beyond_tie']} card lists differ from "
              f"the CPU run's beyond a near-tie {json.dumps(r)}")
    check(abs(out["hit_card"] - out["hit_cpu"]) <= out["hit_bound"],
          f"HitRate card {out['hit_card']} vs CPU {out['hit_cpu']} beyond "
          f"{out['hit_bound']}")

    # step 3: the movielensevaluation walkthrough
    ml_dir = os.path.join(home, "mleval")
    pio_ok(["template", "get", "movielensevaluation", ml_dir])
    pio_ok(["app", "new", ML_APP])
    ml_file = os.path.join(home, "ml.jsonl")
    t0 = time.perf_counter()
    with open(ml_file, "w") as fh:
        subprocess.run([sys.executable, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), ML_GEN),
            "--users", str(ml_users), "--items", str(ml_items),
            "--ratings", str(ml_ratings)], stdout=fh, check=True,
            timeout=300)
    pio_ok(["import", "--appid", meta().app_get_by_name(ML_APP).id,
            "--input", ml_file])
    text = pio_ok(["eval", "--engine-dir", ml_dir,
                   "engine:MovieLensEvaluation"])
    out["ml_leaderboard"] = leaderboard(text).splitlines()
    check(os.path.exists(os.path.join(ml_dir, "best.json")),
          "the movielens eval wrote no best.json")
    text = pio_ok(["train", "--engine-dir", ml_dir, "--engine-json",
                   "best.json"])
    iid = text.split("Training completed. Engine instance: ")[1].split()[0]
    out["ml_walkthrough_s"] = time.perf_counter() - t0
    model = stored_model(iid)
    with open(os.path.join(ml_dir, "best.json")) as fh:
        ml_best = json.load(fh)["algorithmsParams"][0]["params"]
    check(model.item_factors.shape[1] == ml_best["rank"],
          f"the trained winner has rank {model.item_factors.shape[1]}, "
          f"best.json says {ml_best['rank']}")
    inst = meta().engine_instance_get(iid)
    engine = ml_engine.engine_factory()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reset_launches()
    server = EngineServer(engine, inst, device=dev, batch_window_ms=0)
    rng = np.random.default_rng(seed + 10)
    for _ in range(n_seq):
        q = {"user": f"u{int(rng.integers(0, ml_users))}", "num": 10}
        stored_check(server.serve_query(q), q, model)
    launches = dict(kernels.LAUNCHES)
    out["ml_launches"] = launches
    if dev.type == "cuda":
        check(launches["topk"] > 0,
              f"the movielens winner was served without the kernel: "
              f"{launches}")
    Storage.reset()
    return out


# -- phase 11b: pio tune ------------------------------------------------


def tuning_lines(text: str) -> list:
    """The tuning lines ``pio status`` printed."""
    return [ln.strip() for ln in text.splitlines()
            if ln.startswith(("    tuning:", "      trial #"))]


def phase_tune(dev, ev: dict, *, seed=SEED, n_seq=16) -> dict:
    """``pio tune engine:RecommendationEvaluation`` in this process on
    phase 10's store and engine dir (phase 8's events as app ``MyApp``;
    3 folds x rank {5, 10} x λ {0.01, 0.1}, 10 iterations, every fold's
    grid trained on ``dev``): the grid packed ("vmapped"), every trial's
    score bitwise phase 10's ``pio eval`` score of the same variant (the
    grid's contract), best.json phase 10's, the winner trained on the
    full data with the leaderboard stamped on its instance, ``pio
    status`` printing the tuning lines; then a second ``tune --deploy``
    whose gate asks 0.01 more than the incumbent's score holds and exits
    2; then the winner served in process through ``EngineServer``, each
    of ``n_seq`` answers the host exact top-N of its stored factors,
    ``topk`` launched by the prewarm and ``topk_rows`` once an answer.
    Stage seconds: ``read_eval``, the grid train, the
    trials' scoring, the winner's train."""
    from predictionio_tpu_torch.templates.recommendation import (
        engine as rec_engine)
    from predictionio_tpu_torch.workflow import tuning

    os.environ["PIO_HOME"] = ev["home"]
    Storage = pio_storage.Storage
    Storage.reset()
    meta = Storage.get_metadata
    argv = ["tune", "--engine-dir", ev["engine_dir"],
            "engine:RecommendationEvaluation"]
    stages: dict = {}
    with timed_methods(stages,
                       (rec_engine.RecommendationDataSource, "read_eval",
                        "read_eval"),
                       (tuning, "run_train", "winner_train")):
        t0 = time.perf_counter()
        text = pio_ok(argv)
        tune_s = time.perf_counter() - t0
    out: dict = {"tune_s": tune_s, "read_eval_s": sum(stages["read_eval"]),
                 "winner_train_s": sum(stages["winner_train"])}
    check("packed grid: vmapped (4 trial(s)" in text,
          f"pio tune did not pack the grid:\n{text}")
    iid = text.split("trained as instance ")[1].split(";")[0]
    inst = meta().engine_instance_get(iid)
    check(inst is not None and inst.status == "COMPLETED" and inst.tuning,
          f"the winner's instance {iid} is not COMPLETED with a leaderboard")
    doc = json.loads(inst.tuning)
    out.update(grid_mode=doc["gridMode"], grid_s=doc["gridSeconds"],
               scoring_s=sum(r["seconds"] for r in doc["trials"]),
               scores=[r["score"] for r in doc["trials"]],
               best_trial=doc["bestTrial"])
    check(doc["gridMode"] == "vmapped", f"grid mode {doc['gridMode']}")
    check([r["status"] for r in doc["trials"]] == ["COMPLETED"] * 4,
          f"trial statuses {[r['status'] for r in doc['trials']]}")
    check(out["scores"] == ev["scores"],
          f"the tuned scores {out['scores']} differ from pio eval's "
          f"{ev['scores']}")
    with open(os.path.join(ev["engine_dir"], "best.json")) as fh:
        best = json.load(fh)
    check(best["algorithmsParams"] == ev["best"],
          f"tune's best.json {best['algorithmsParams']} differs from pio "
          f"eval's {ev['best']}")
    check(json.loads(inst.algorithms_params) == ev["best"],
          "the winner's instance was not trained with best.json's params")
    status = pio_ok(["status"])
    out["status_lines"] = tuning_lines(status)
    check(out["status_lines"][:1] and out["status_lines"][0].startswith(
        "tuning: 4 trial(s), vmapped grid")
          and sum("<== winner" in ln for ln in out["status_lines"]) == 1,
          f"pio status printed no tuning lines:\n{status}")

    # the gate: a winner no better than the incumbent (itself) by 0.01
    t0 = time.perf_counter()
    rc, held = pio(argv + ["--deploy", "--eval-gate=-0.01"])
    out["held_tune_s"] = time.perf_counter() - t0
    check(rc == 2 and "gate: hold" in held and "HELD deployment" in held,
          f"the gated tune exited {rc}:\n{held}")

    # the winner served in process, counted from zero
    model = stored_model(iid)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reset_launches()
    server = EngineServer(rec_engine.engine_factory(), inst, device=dev,
                          batch_window_ms=0)
    rng = np.random.default_rng(seed + 11)
    for _ in range(n_seq):
        q = {"user": f"u{int(rng.integers(0, QS_USERS))}", "num": 10}
        stored_check(server.serve_query(q), q, model)
    launches = dict(kernels.LAUNCHES)
    out["launches"] = launches
    if dev.type == "cuda":
        # the deploy's prewarm launches topk; the template's batch_predict
        # answers through topk_rows, one launch a query here
        check(launches["topk"] > 0 and launches["topk_rows"] >= n_seq,
              f"the tuned winner was served without the kernel: {launches}")
    del server
    Storage.reset()
    return out


# -- phase 12: resilience on the card ------------------------------------


#: phase 12a's server: phase 3's, with a watchdog that trips in 0.5 s, two
#: pipeline slots and a 2 s cooldown between half-open probes
RES_SERVER = dict(dispatch_timeout_s=0.5, batch_inflight=2,
                  degraded_cooldown_s=2.0)
#: ``pio deploy`` as a user runs it, with one addition for phase 12c: on
#: SIGUSR1 it arms ``server.serve_batch`` (the batched and the per-query
#: path alike) to hold each served batch 0.2 s, so the drain that SIGTERM
#: starts has batches in flight to finish while /health.json is read
_DEPLOY = r"""
import signal, sys
from predictionio_tpu_torch.workflow.faults import FAULTS
from predictionio_tpu_torch.tools.cli import main
signal.signal(signal.SIGUSR1, lambda *_: FAULTS.inject(
    "server.serve_batch", "slow", delay_s=0.2))
sys.exit(main(sys.argv[1:]))
"""


def post_full(url: str, qj: dict, headers=None, timeout=60):
    """One ``POST /queries.json`` on a connection of its own through
    ``http.client`` (``urllib``'s opener is built on first use, and
    threads racing to build it stall for seconds): (status, body,
    headers, wall seconds)."""
    t0 = time.perf_counter()
    target = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(target.hostname, target.port,
                                      timeout=timeout)
    try:
        conn.request("POST", "/queries.json", body=json.dumps(qj),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        status, body = resp.status, json.loads(resp.read())
        hdrs = dict(resp.getheaders())
    finally:
        conn.close()
    return status, body, hdrs, time.perf_counter() - t0


def get_status(url: str) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def poll_until(cond, timeout_s: float = 30.0) -> bool:
    end = time.perf_counter() + timeout_s
    while time.perf_counter() < end:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def on_thread(fn, *args) -> tuple[threading.Thread, list]:
    out: list = []
    t = threading.Thread(target=lambda: out.append(fn(*args)), daemon=True)
    t.start()
    return t, out


def phase_resilience_server(dev, *, n_fallback=16, **sizes) -> dict:
    """12a and 12b on phase 3's ML-20M server behind ``serve()``. (a) Both
    pipeline slots hung at ``microbatch.dispatch``: both queries answer
    504, ``/health.json`` reads degraded with ``maxInflight`` 1; the hung
    threads are released and finish, then ``n_fallback`` queries answer
    200 off the batcher, each the host's exact top-N (its count clamped to
    the brownout top-k, 10, as degraded mode clamps it), with one
    ``topk_rows`` launch each and the batch count unchanged; past the
    cooldown one probe through the batcher returns the server to ``ok``
    with two slots. (b) ``X-PIO-Deadline-Ms: 0.001`` answers 504; with
    ``retrieval.topk`` hung on both slots until a query with a 50 ms
    deadline has waited past it in the queue (then released; capped at
    0.45 s, below the watchdog), that query expires: 504 "deadline",
    counted in ``pio_deadline_expired_total``; the held ones answer 200."""
    out: dict = {}
    FLIGHT.reset()  # the incident cooldowns start afresh
    FLIGHT.configure(dump_dir=tempfile.mkdtemp(prefix="pio-chip-flight-"))
    server = build_server(dev, **sizes, **RES_SERVER)
    model = server.deployed.result.models[0]
    users, items = model.user_factors, model.item_factors
    rng = np.random.default_rng(SEED + 12)

    def query() -> dict:
        return {"user": f"u{int(rng.integers(0, len(users)))}",
                "num": int(rng.choice([1, 4, 10, 20]))}

    codes: list = []
    with serve(server, "127.0.0.1", 0) as front:
        url = f"http://127.0.0.1:{front.port}"
        q = query()
        status, body, _, _ = post_full(url, q)
        check(status == 200, f"the first query answered {status}")
        host_check(body, q, users, items)
        # (a) every slot hung: the watchdog answers, the server degrades
        FAULTS.inject("microbatch.dispatch", "hang", times=2, max_hang_s=60)
        t_trip = time.perf_counter()
        hung = []
        for _ in range(2):
            hung.append(on_thread(post_full, url, query()))
            check(poll_until(lambda: server.batcher._live == len(hung)),
                  "a hung batch did not take its slot")
        for t, res in hung:
            t.join(30)
            check(res and res[0][0] == 504
                  and "watchdog" in res[0][1]["message"],
                  f"a hung query answered {res and res[0][:2]}")
            codes.append(res[0][0])
        status, health = get_status(url + "/health.json")
        out["trip_to_degraded_s"] = time.perf_counter() - t_trip
        check(status == 200 and health["status"] == "degraded"
              and health["degraded"]["maxInflight"] == 1
              and health["degraded"]["watchdogTrips"] == 2,
              f"after the trips /health.json read {status} {health}")
        # the trip wrote a flight incident dump holding its hung requests,
        # each stamped with the stage its batch stalled in
        dumps = sorted(glob.glob(os.path.join(FLIGHT.dump_dir,
                                              "flight-watchdog-*.json")))
        check(bool(dumps), "the watchdog trip wrote no flight incident dump")
        with open(dumps[0]) as fh:
            payload = json.load(fh)
        hung = [r for r in payload["records"] if r.get("hung")]
        check(bool(hung) and all(r.get("stalledStage") in STAGES
                                 for r in hung),
              f"the incident dump's hung records: {hung}")
        out["incident_stalled_stages"] = sorted(
            {r["stalledStage"] for r in hung})
        FAULTS.clear("microbatch.dispatch")  # the hung threads finish
        check(poll_until(lambda: server.batcher.stats()
                         ["zombieDispatches"] == 0),
              "the released batches never finished")
        rows0, batches0 = kernels.LAUNCHES["topk_rows"], server.batcher.batches
        walls = []
        for _ in range(n_fallback):
            q = query()
            status, body, _, wall = post_full(url, q)
            check(status == 200, f"a degraded query answered {status}")
            # degraded mode clamps the count to the brownout top-k
            host_check(body, {**q, "num": min(q["num"], server.brownout_topk)},
                       users, items)
            walls.append(wall)
            codes.append(status)
        launched = kernels.LAUNCHES["topk_rows"] - rows0
        want = n_fallback * (dev.type == "cuda")
        check(server.degraded and server.batcher.batches == batches0,
              "a fallback answer went through the batcher, or the server "
              "left degraded mode before the probe")
        check(launched == want, f"{n_fallback} fallback answers launched "
              f"topk_rows {launched} times, want {want}")
        out["fallback_answers"] = n_fallback
        out["fallback_topk_rows_launches"] = launched
        out["fallback_p50_ms"] = statistics.median(walls) * 1e3
        # the half-open probe, once the cooldown has passed
        time.sleep(max(0.0, server._probe_at - time.monotonic()) + 0.05)
        t_probe = time.perf_counter()
        q = query()
        status, body, _, _ = post_full(url, q)
        check(status == 200, f"the probe answered {status}")
        host_check(body, q, users, items)
        codes.append(status)
        check(poll_until(lambda: get_status(url + "/health.json")[1]
                         ["status"] == "ok", 10),
              "the probe did not return the server to ok")
        out["probe_to_ok_s"] = time.perf_counter() - t_probe
        health = get_status(url + "/health.json")[1]
        check(health["degraded"]["maxInflight"] == 2
              and server.batcher.batches == batches0 + 1,
              f"after the probe: {health['degraded']}, batches "
              f"{server.batcher.batches - batches0}")
        # (b) deadlines
        status, body, _, _ = post_full(url, query(),
                                       {"X-PIO-Deadline-Ms": "0.001"})
        check(status == 504 and "deadline" in body["message"],
              f"a 0.001 ms deadline answered {status} {body}")
        codes.append(status)
        expired = METRICS.get("pio_deadline_expired_total").value()
        # both slots held (a hang released once the deadline query has
        # waited in the queue past its 50 ms, capped below the 0.5 s
        # watchdog), so its expiry does not race the slots' release
        FAULTS.inject("retrieval.topk", "hang", times=2, max_hang_s=0.45)
        slow = []
        for _ in range(2):
            q = query()
            slow.append((q, on_thread(post_full, url, q)))
            check(poll_until(lambda: server.batcher._live == len(slow)),
                  "a slow batch did not take its slot")
        late, late_res = on_thread(post_full, url, query(),
                                   {"X-PIO-Deadline-Ms": "50"})
        check(poll_until(lambda: len(server.batcher._pending) == 1),
              "the deadline query did not queue behind the held slots")
        time.sleep(0.06)
        FAULTS.release("retrieval.topk")
        late.join(30)
        check(bool(late_res), "the deadline query got no answer")
        status, body = late_res[0][0], late_res[0][1]
        check(status == 504 and "deadline" in body["message"],
              f"a query queued past its 50 ms deadline answered {status} "
              f"{body}")
        codes.append(status)
        counted = METRICS.get("pio_deadline_expired_total").value() - expired
        check(counted == 1, f"pio_deadline_expired_total moved by {counted}")
        for q, (t, res) in slow:
            t.join(30)
            check(res and res[0][0] == 200, "a slow query did not answer 200")
            host_check(res[0][1], q, users, items)
            codes.append(200)
        FAULTS.clear()
    out["codes"] = {str(c): codes.count(c) for c in sorted(set(codes))}
    return out


def phase_resilience_drain(dev, home: str, *, n_burst=256, threads=64,
                           nums=(1, 4, 10)) -> dict:
    """12c: ``pio deploy`` of phase 9's engine and store in a subprocess,
    with ``--admission --rate-limit-qps 100 --rate-limit-burst 50`` (the
    default burst, twice the rate, outlasts a 256-query burst at the
    serving rate this host reaches). A burst of ``n_burst`` queries from
    ``threads`` threads (one client address: one token bucket) sees 429s,
    each with a ``Retry-After``, and every 200 is the stored blob's host
    top-N. Then every served batch is held 0.2 s
    (SIGUSR1), the clients send until ``/health.json`` reads 503 (as a
    load balancer rotates a draining server out), and SIGTERM lands
    while batches are in flight: every query is answered (200, 429 or
    503 "draining"; none dropped or reset), ``/health.json`` reads 503
    "draining" while the queue flushes, and the process exits 0."""
    out: dict = {}
    engine_dir = os.path.join(home, "engine")
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    env = dict(os.environ, PIO_HOME=home,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    if dev.type == "cpu":
        env["PIO_PLATFORM"] = "cpu"
    else:
        env.pop("PIO_PLATFORM", None)
    log_path = os.path.join(home, "deploy-12c.log")
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-c", _DEPLOY, "deploy", "--engine-dir",
             engine_dir, "--ip", "127.0.0.1", "--port", str(port),
             "--admission", "--rate-limit-qps", "100",
             "--rate-limit-burst", "50"],
            env=env, stdout=log_file, stderr=subprocess.STDOUT)
    try:
        t0 = time.perf_counter()
        while True:
            check(proc.poll() is None,
                  f"pio deploy exited {proc.returncode}: "
                  f"{open(log_path).read()[-2000:]}")
            try:
                if get_status(url + "/health.json")[0] == 200:
                    break
            except OSError:
                check(time.perf_counter() - t0 < 300, "pio deploy never "
                      "answered")
                time.sleep(0.1)
        out["deploy_s"] = time.perf_counter() - t0
        iid = get_json(url + "/")["engineInstanceId"]
        os.environ["PIO_HOME"] = home
        pio_storage.Storage.reset()
        model = stored_model(iid)
        pio_storage.Storage.reset()
        users = model.user_ids.inverse_array()
        rng = np.random.default_rng(SEED + 13)

        def query() -> dict:
            return {"user": str(users[int(rng.integers(0, len(users)))]),
                    "num": int(rng.choice(nums))}

        # the burst: one client address, one token bucket
        queries = [query() for _ in range(n_burst)]
        results: list = [None] * n_burst
        with ThreadPoolExecutor(threads) as pool:
            for j, res in enumerate(pool.map(
                    lambda qj: post_full(url, qj), queries)):
                results[j] = res
        shed = [r for r in results if r[0] == 429]
        check(set(r[0] for r in results) <= {200, 429} and shed,
              f"the burst answered {sorted(set(r[0] for r in results))} "
              f"with {len(shed)} 429s")
        check(all(float(r[2]["Retry-After"]) > 0 for r in shed),
              "a 429 came without a Retry-After")
        for (status, body, _, _), q in zip(results, queries):
            if status == 200:
                stored_check(body, q, model)
        out["burst"] = {"200": n_burst - len(shed), "429": len(shed)}
        out["retry_after_s"] = [min(float(r[2]["Retry-After"])
                                    for r in shed),
                                max(float(r[2]["Retry-After"])
                                    for r in shed)]
        # the drain
        time.sleep(1.0)  # the token bucket refills
        proc.send_signal(signal.SIGUSR1)
        rotated = threading.Event()
        answers: list = []
        lock = threading.Lock()

        def client() -> None:
            while not rotated.is_set():
                q = query()
                try:
                    status, body, _, _ = post_full(url, q)
                except OSError as e:  # dropped or reset: a failure
                    status, body = "dropped", {"message": repr(e)}
                with lock:
                    answers.append((status, body, q))
                if status == 503:
                    return  # rotated out, as by the health check
                if status == 429:
                    time.sleep(0.05)

        clients = [threading.Thread(target=client, daemon=True)
                   for _ in range(threads)]
        for t in clients:
            t.start()
        check(poll_until(lambda: len(answers) >= threads, 60),
              "the second burst got no answers")
        health_503: list = []

        def watch() -> None:
            while proc.poll() is None:
                try:
                    status, health = get_status(url + "/health.json")
                except OSError:
                    return
                if status == 503:
                    health_503.append(health["status"])
                    rotated.set()

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        # the clients keep the server busy: each admitted query holds its
        # batch 0.2 s, so the drain has work in flight to finish
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        out["drain_s"] = time.perf_counter() - t_term
        rotated.set()
        for t in clients + [watcher]:
            t.join(60)
        check(code == 0, f"pio deploy exited {code} after SIGTERM: "
              f"{open(log_path).read()[-2000:]}")
        check(health_503 and set(health_503) == {"draining"},
              f"/health.json during the drain read {set(health_503)}")
        statuses = [a[0] for a in answers]
        odd = [a[1] for a in answers if a[0] not in (200, 429, 503)]
        check(not odd, f"the drained burst answered "
              f"{sorted(set(map(str, statuses)))}: {odd[:3]}")
        for status, body, q in answers:
            if status == 503:
                check("draining" in body["message"], f"a 503 said {body}")
            elif status == 200:
                stored_check(body, q, model)
        out["drain_burst"] = {str(c): statuses.count(c)
                              for c in sorted(set(statuses))}
        out["health_503_reads"] = len(health_503)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return out


# -- phase 13: streaming fold-in ----------------------------------------


#: 13a: users unseen at train time folded in at once against phase 3's
#: catalog, 5 to 200 events each (d_pad 256)
FOLD_USERS, FOLD_MIN, FOLD_MAX = 4096, 5, 200
#: the reference's own fold-in tolerance (tests/test_als.py:576-589)
FOLD_TOL = 5e-4
#: 13b: users unseen at train time posted through the event server, and
#: the events each; the first half to the trained app, the rest to an
#: app no training reads
STREAM_USERS, STREAM_EVENTS = 32, 8


def phase3_catalog(n_users=N_USERS, n_items=N_ITEMS, rank=RANK):
    """Phase 3's item factors (``build_server``'s draws, users first)."""
    rng = np.random.default_rng(SEED)
    scale = 1 / np.sqrt(rank)
    rng.standard_normal((n_users, rank))
    return (rng.standard_normal((n_items, rank)) * scale).astype(np.float32)


def fold_batch(rng, n_users: int, n_items: int, lo: int, hi: int) -> list:
    """``n_users`` users of ``lo``..``hi`` distinct items each, rated in
    half stars: the ``fold_in_users`` batch."""
    batch = []
    for _ in range(n_users):
        k = int(rng.integers(lo, hi + 1))
        its = rng.choice(n_items, k, replace=False)
        batch.append(([f"i{j}" for j in its],
                      (np.round(rng.random(k) * 9 + 1) / 2).tolist()))
    return batch


def phase_fold_in(dev, *, n_users=FOLD_USERS, n_items=N_ITEMS, rank=RANK,
                  table_users=N_USERS, lo=FOLD_MIN, hi=FOLD_MAX,
                  reps=5) -> dict:
    """13a: ``fold_in_users(solver="device")`` for ``n_users`` unseen users
    against phase 3's catalog, explicit (λ 0.1) and implicit (α 1): within
    ``FOLD_TOL`` of the host float64 solve, two runs bitwise equal; the
    device path's median time (CUDA events, after a warm-up), the host
    solve's seconds, users per second and the peak device memory."""
    items = phase3_catalog(table_users, n_items, rank)
    names = BiMap({f"i{j}": j for j in range(n_items)})
    batch = fold_batch(np.random.default_rng(SEED + 13), n_users, n_items,
                       lo, hi)
    d_pad = 1 << max(3, (max(len(b[0]) for b in batch) - 1).bit_length())
    out: dict = {"users": n_users, "items": n_items, "rank": rank,
                 "d_pad": d_pad,
                 "gather_bytes": (1 << max(0, (n_users - 1).bit_length()))
                 * d_pad * rank * 4}
    for mode, implicit in (("explicit", False), ("implicit", True)):
        model = als.ALSModel(np.zeros((1, rank), np.float32), items,
                             BiMap({"u0": 0}), names,
                             ALSConfig(rank=rank, lambda_=0.1,
                                       implicit_prefs=implicit, alpha=1.0))
        t0 = time.perf_counter()
        host, kept = model.fold_in_users(batch)
        host_s = time.perf_counter() - t0
        check(bool(kept.all()), f"{mode}: a user had no known item")
        got, kept_d = model.fold_in_users(batch, solver="device",
                                          device=dev)
        again, _ = model.fold_in_users(batch, solver="device", device=dev)
        check(np.array_equal(kept, kept_d), f"{mode}: kept masks differ")
        check(np.isfinite(got).all() and got.shape == host.shape,
              f"{mode}: device fold-in {got.shape} not finite like "
              f"{host.shape}")
        check(np.array_equal(got, again),
              f"{mode}: two device fold-ins differ")
        err = float(np.abs(got - host).max())
        check(np.allclose(got, host, rtol=FOLD_TOL, atol=FOLD_TOL),
              f"{mode}: device fold-in off the host float64 one by {err}")
        prep = [model._fold_in_prep(*b) for b in batch]
        times = []
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for _ in range(reps):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                model._fold_in_users_device(prep, dev)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                model._fold_in_users_device(prep, dev)
                times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        out[mode] = {
            "max_abs_err": err, "repeat_bitwise": True,
            "device_ms": ms, "host_s": host_s,
            "users_per_s": n_users / (ms / 1e3),
            "peak_device_gib": (torch.cuda.max_memory_allocated() / 2**30
                                if dev.type == "cuda" else None)}
    return out


def live_front(port: int):
    """The ``HttpServing`` a ``pio deploy`` thread of this process serves
    on ``port`` (its server holds the patched factors)."""
    from predictionio_tpu_torch.workflow.create_server import HttpServing

    with warnings.catch_warnings():  # isinstance on deprecated proxies
        warnings.simplefilter("ignore")
        fronts = [o for o in gc.get_objects()
                  if isinstance(o, HttpServing) and not o._closed.is_set()
                  and o.port == port]
    check(len(fronts) == 1, f"{len(fronts)} live front ends on {port}")
    return fronts[0]


def suffix_fold(model, items: list, ratings: list, factor) -> int | None:
    """The first j for which ``factor`` is within ``FOLD_TOL`` of the host
    float64 fold-in of ``items[j:]``, else None. A user whose events the
    updater polled across two cycles holds the fold-in of the later
    cycle's events, a suffix of them: fold-in recomputes a user from one
    batch's events, it does not accumulate (the reference's semantics)."""
    for j in range(len(items)):
        want = model.fold_in_user(items[j:], ratings[j:])
        if np.allclose(factor, want, rtol=FOLD_TOL, atol=FOLD_TOL):
            return j
    return None


def log_tail(path: str) -> str:
    with open(path) as fh:
        return fh.read()[-3000:]


def phase_stream(dev, home: str, *, n_users=STREAM_USERS,
                 n_events=STREAM_EVENTS, window_ms=200, num=10) -> dict:
    """13b: phase 9's store and engine through ``pio``: ``eventserver
    --journal-dir D --journal-partitions 2`` and ``stream --fold-in-solver
    device`` in processes of their own, ``deploy`` in this process with
    the launch counts set to 0 first. ``n_users`` users unseen at train
    time post ``n_events`` events each (the first half to the trained
    app, the rest to an app no training reads); each must be personalized
    within one updater cycle: an answer that differs from the cold-start
    one, equal to the host exact top-N of the factor in the bundle that
    served it; once the updater has consumed the journal, a fresh answer
    equal to that of the factor the server then holds, and that factor
    within ``FOLD_TOL`` of the host float64 fold-in of a suffix of its
    events. Then ``pio train`` and ``GET /reload``: the patches of the
    users the retrain saw are discarded, the rest re-applied."""
    out: dict = {"users": n_users, "events_each": n_events}
    os.environ["PIO_HOME"] = home
    Storage = pio_storage.Storage
    Storage.reset()
    engine_dir = os.path.join(home, "engine")
    meta = Storage.get_metadata()
    app = meta.app_get_by_name(QS_APP)
    key = meta.access_key_get_by_appid(app.id)[0].key
    text = pio_ok(["app", "new", "streamonly"])
    other_key = text.split("Access key: ")[1].split()[0]
    Storage.reset()  # the subprocesses open the same files
    journal = os.path.join(home, "journal")
    env = dict(os.environ, PIO_HOME=home, PYTHONUNBUFFERED="1",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    if dev.type == "cpu":
        env["PIO_PLATFORM"] = "cpu"
    else:
        env.pop("PIO_PLATFORM", None)
    procs: list = []

    def start(name: str, argv: list):
        log_path = os.path.join(home, f"{name}-13.log")
        with open(log_path, "w") as log_file:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "predictionio_tpu_torch.tools.cli",
                 *map(str, argv)], env=env, stdout=log_file,
                stderr=subprocess.STDOUT))
        return procs[-1], log_path

    eport = free_port()
    ebase = f"http://127.0.0.1:{eport}"
    es, es_log = start("eventserver", [
        "eventserver", "--ip", "127.0.0.1", "--port", eport,
        "--journal-dir", journal, "--journal-partitions", 2])
    deploy = None
    try:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        reset_launches()
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        deploy, deploy_result = pio_thread(
            ["deploy", "--engine-dir", engine_dir, "--ip", "127.0.0.1",
             "--port", port])
        iid = wait_answer(base + "/", deploy, deploy_result)[
            "engineInstanceId"]
        front = live_front(port)
        os.environ["PIO_HOME"] = home
        trained = stored_model(iid)
        Storage.reset()

        def es_up() -> bool:
            check(es.poll() is None,
                  f"the event server exited: {log_tail(es_log)}")
            try:
                return get_status(ebase + "/health.json")[0] == 200
            except OSError:
                return False

        check(poll_until(es_up, 120), "the event server never answered")
        t0 = time.perf_counter()
        stream, stream_log = start("stream", [
            "stream", "--engine-dir", engine_dir, "--journal-dir", journal,
            "--engine-url", base, "--fold-in-solver", "device",
            "--batch-window-ms", window_ms])
        check(poll_until(lambda: stream.poll() is not None
                         or "Streaming updater:" in log_tail(stream_log),
                         180) and stream.poll() is None,
              f"pio stream did not start: {log_tail(stream_log)}")
        out["stream_start_s"] = time.perf_counter() - t0

        rng = np.random.default_rng(SEED + 17)
        catalog = trained.item_ids.inverse_array()
        users = {}
        for u in range(n_users):
            its = [str(x) for x in rng.choice(catalog, n_events,
                                              replace=False)]
            users[f"s{u}"] = (its, (np.round(rng.random(n_events) * 9 + 1)
                                    / 2).tolist())
        cold = {u: post_status(base + "/queries.json",
                               {"user": u, "num": num})
                for u in list(users)[:2]}
        check(all(c == (200, {"itemScores": []}) for c in cold.values()),
              f"an unseen user was answered before any event: {cold}")
        t_start = time.perf_counter()
        for j, (u, (its, rts)) in enumerate(users.items()):
            k = key if j < n_users // 2 else other_key
            batch = [{"event": "rate", "entityType": "user", "entityId": u,
                      "targetEntityType": "item", "targetEntityId": i,
                      "properties": {"rating": r}}
                     for i, r in zip(its, rts)]
            code, body = post_status(
                f"{ebase}/batch/events.json?accessKey={k}", batch)
            check(code == 200 and all(r["status"] == 201 for r in body),
                  f"POST /batch/events.json answered {code} {body}")
        t_ack = time.perf_counter()
        out["post_s"] = t_ack - t_start
        # every answer is held against the bundle that served it: a delta
        # swaps in a new bundle, and a user whose events two cycles
        # polled is patched twice, so a later bundle may hold another
        # factor than the one its first answer came from
        answers: dict = {}
        first = None
        deadline = t_ack + 60
        while len(answers) < n_users:
            check(time.perf_counter() < deadline and stream.poll() is None,
                  f"{n_users - len(answers)} users never personalized: "
                  f"{log_tail(stream_log)}")
            for u in users:
                if u in answers:
                    continue
                q = {"user": u, "num": num}
                before = front.server.deployed
                code, body = post_status(base + "/queries.json", q)
                after = front.server.deployed
                check(code == 200, f"{u} answered {code} {body}")
                if body["itemScores"]:
                    if first is None:
                        first = time.perf_counter() - t_ack
                    if before is after:  # else ask again
                        answers[u] = (q, body, before.result.models[0])
            time.sleep(0.01)
        out["ack_to_first_personalized_s"] = first
        out["ack_to_all_personalized_s"] = time.perf_counter() - t_ack
        for u, (q, body, served_by) in answers.items():
            stored_check(body, q, served_by)
        # the updater commits a partition's cursor once its batch is
        # published: with every cursor at the journal's end, the bundle
        # holds every user's last patch
        from predictionio_tpu_torch.storage.journal import JournalFollower

        def stream_caught_up() -> bool:
            follower = JournalFollower(journal, name="stream", partitions=2)
            return all(follower.lag(k) == 0 for k in range(2))

        check(poll_until(stream_caught_up, 60),
              f"pio stream never consumed the journal: {log_tail(stream_log)}")
        model = front.server.deployed.result.models[0]
        split = 0
        for u, (q, _, _) in answers.items():
            code, body = post_status(base + "/queries.json", q)
            check(code == 200, f"{u} answered {code} {body}")
            stored_check(body, q, model)
            factor = model.user_factors[model.user_ids[u]]
            j = suffix_fold(trained, *users[u], factor)
            check(j is not None, f"{u}: the served factor is no host "
                  f"float64 fold-in of its events")
            split += j > 0
        out["users_split_across_cycles"] = split
        launches = dict(kernels.LAUNCHES)
        check(launches["topk_rows"] > 0,
              f"topk_rows never launched on the streaming path: {launches}")
        out["launches"] = launches
        health = get_json(base + "/health.json")["model"]
        check(health["patchedUsers"] == n_users and health["patchEpoch"] > 0,
              f"/health.json model block {health}")
        out["patch_epoch"] = health["patchEpoch"]

        # the retrain sees the trained app's half once the drainers pushed
        # it into the event store
        check(poll_until(lambda: get_json(ebase + "/health.json")
                         ["journal"]["lag"] == 0, 60),
              "the journal never drained")
        t0 = time.perf_counter()
        text = pio_ok(["train", "--engine-dir", engine_dir])
        out["retrain_s"] = time.perf_counter() - t0
        marker = "Training completed. Engine instance: "
        check(marker in text, f"train said {text!r}")
        newer = text.split(marker)[1].split()[0]
        Storage.reset()
        body = get_json(base + "/reload")
        check(body.get("engineInstanceId") == newer,
              f"/reload answered {body}, not {newer}")
        seen = n_users // 2
        health = get_json(base + "/health.json")["model"]
        patches = get_json(base + "/stats.json")["patches"]
        check(health["patchedUsers"] == n_users - seen
              and patches["discardedByReload"] == seen,
              f"after the reload: {health}, {patches}")
        retrained = front.server.deployed.result.models[0]
        for u in list(users)[:seen]:
            code, body = post_status(base + "/queries.json",
                                     {"user": u, "num": num})
            check(code == 200 and body["itemScores"],
                  f"{u} lost its answer after the retrain: {body}")
            stored_check(body, {"user": u, "num": num}, retrained)
        for u in list(users)[seen:]:
            check(np.array_equal(
                retrained.user_factors[retrained.user_ids[u]],
                model.user_factors[model.user_ids[u]]),
                  f"{u}'s patch was not re-applied after the reload")
        out["patched_after_reload"] = health["patchedUsers"]
        for proc, log_path in ((stream, stream_log), (es, es_log)):
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=60)
            check(code == 0, f"exit {code}: {log_tail(log_path)}")
        stats_line = [ln for ln in log_tail(stream_log).splitlines()
                      if "Streaming updater stopped:" in ln]
        check(bool(stats_line), "pio stream printed no stats")
        st = json.loads(stats_line[-1].split("stopped: ", 1)[1])
        check(st["usersPatched"] >= n_users and st["publishFailures"] == 0,
              f"pio stream stats {st}")
        out["stream_cycles"] = st["cycles"]
        pio_ok(["undeploy", "--port", port])
        deploy.join(60)
        check(not deploy.is_alive() and deploy_result == [0],
              f"undeploy did not end the server: {deploy_result}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if deploy is not None and deploy.is_alive():
            pio(["undeploy", "--port", port])
            deploy.join(60)
        Storage.reset()
    return out


# -- main ---------------------------------------------------------------


# -- phase 14: similarity serving and the ALS template family -----------


#: 14a: categories drawn for the catalog's items (1 to 3 of these each)
N_CATS = 20
#: 14a: a served list may swap two items whose float64 scores differ by
#: less than this share of the row's largest |score|; scores agree within
#: this relative tolerance
SIM_TOL = 1e-5
#: 14b: the app the four templates read, its scale (phase 9's users and
#: items) and the events of each kind
TMPL_APP = "MyApp"
TMPL_USERS, TMPL_ITEMS = QS_USERS, QS_ITEMS
TMPL_VIEWS, TMPL_LIKES, TMPL_BUYS, TMPL_RATES = (100_000, 20_000, 10_000,
                                                 50_000)
#: 14b: the e-commerce engine's constraint TTL, short so the phase sees an
#: unavailableItems $set take effect
TMPL_TTL_S = 1.0


def item_categories(rng, n_items: int, n_cats: int = N_CATS) -> dict:
    """``{"i<j>": (1 to 3 distinct "c<k>")}`` from ``rng``."""
    return {f"i{j}": tuple(f"c{c}" for c in sorted(rng.choice(
        n_cats, int(rng.integers(1, 4)), replace=False)))
            for j in range(n_items)}


def cosine_row64(items64n: np.ndarray, rows: list, mask=None) -> np.ndarray:
    """The float64 aggregate cosine of every item to the query ``rows``
    over the normalized float64 catalog, the query items and the items
    ``mask`` leaves out at -inf."""
    row = items64n @ items64n[rows].sum(axis=0)
    row[rows] = -np.inf
    if mask is not None:
        row = np.where(mask, row, -np.inf)
    return row


def sim_mask(query: dict, cats: dict, n_items: int):
    """The candidate mask of a similarproduct query (the template's rule),
    or None when it has no filter."""
    mask = None
    if query.get("categories"):
        want = set(query["categories"])
        mask = np.array([bool(want & set(cats[f"i{j}"]))
                         for j in range(n_items)])
    for key, keep in (("whiteList", True), ("blackList", False)):
        if query.get(key):
            m = np.full(n_items, not keep)
            m[[int(i[1:]) for i in query[key]]] = keep
            mask = m if mask is None else mask & m
    return mask


def list_check(what: str, got: list, row: np.ndarray, num: int,
               tol: float = SIM_TOL) -> None:
    """A served list of ``{"item": "i<j>", "score"}`` against the top-``num``
    of the float64 ``row``: the same length, the same items but where two
    whose float64 scores differ by less than ``tol`` of the row's largest
    |score| swap, and every score within ``tol`` relative of its float64
    score."""
    finite = np.isfinite(row)
    order = np.argsort(-row, kind="stable")
    want = order[:min(num, int(finite.sum()))]
    check(len(got) == len(want), f"{what}: {len(got)} items, want "
          f"{len(want)}")
    gi = np.array([int(g["item"][1:]) for g in got], np.int64)
    gs = np.array([g["score"] for g in got], np.float64)
    check(bool(finite[gi].all()), f"{what}: an excluded item was served")
    width = tol * float(np.abs(row[finite]).max())
    check(bool(np.all(np.abs(row[gi] - row[want]) < width)),
          f"{what}: items beyond a near-tie of the float64 top-{num}")
    check(bool(np.allclose(gs, row[gi], rtol=tol, atol=0.0)),
          f"{what}: scores differ from the float64 cosines")


def sim_check(body: dict, query: dict, items64n, cats) -> None:
    """One similar-items answer against the float64 host cosine top-N: the
    filters obeyed, no query item served, ``list_check``'s rule."""
    rows = [int(i[1:]) for i in query["items"]]
    mask = sim_mask(query, cats, len(items64n))
    got = body["itemScores"]
    check(not {f"i{r}" for r in rows} & {g["item"] for g in got},
          f"{query}: a query item in its own answer")
    list_check(str(query), got, cosine_row64(items64n, rows, mask),
               query["num"])


def sim_queries(rng, n: int, n_items: int, num: int, cats: dict | None = None,
                filtered: bool = False) -> list:
    """``n`` queries of 1 to 5 query items at ``num``; ``filtered`` ones
    carry categories, a whiteList or a blackList in turn."""
    out = []
    for j in range(n):
        q = {"items": [f"i{int(i)}" for i in rng.choice(
            n_items, int(rng.integers(1, 6)), replace=False)], "num": num}
        if filtered:
            kind = j % 3
            if kind == 0:
                q["categories"] = [f"c{int(c)}" for c in rng.choice(
                    N_CATS, 2, replace=False)]
            elif kind == 1:
                q["whiteList"] = [f"i{int(i)}" for i in rng.choice(
                    n_items, 200, replace=False)]
            else:
                q["blackList"] = [f"i{int(i)}" for i in rng.choice(
                    n_items, 50, replace=False)]
        out.append(q)
    return out


def build_similar_server(dev, *, n_items=N_ITEMS, rank=RANK, **server_args):
    """Phase 3's ML-20M catalog as the port's similarproduct model (its
    ``als`` algorithm, implicit ALS factors from a seed), items with 1 to
    3 of ``N_CATS`` categories from ``--seed``, deployed by an
    ``EngineServer`` of the similarproduct engine (prewarm on)."""
    from predictionio_tpu_torch.templates.similarproduct import (
        engine as sp)

    items = phase3_catalog(n_items=n_items, rank=rank)
    cats = item_categories(np.random.default_rng(SEED + 14), n_items)
    model = als.ALSModel(
        user_factors=np.zeros((1, rank), np.float32), item_factors=items,
        user_ids=BiMap({"u0": 0}),
        item_ids=BiMap({f"i{j}": j for j in range(n_items)}),
        config=ALSConfig(rank=rank, implicit_prefs=True))
    result = TrainResult([sp._CosineModel(model, cats)],
                         [sp.ALSAlgorithm(sp.AlgorithmParams(rank=rank))],
                         sp.DedupeServing(), ["als"])
    return EngineServer(sp.engine_factory(), result, "chip-similar",
                        device=dev, **server_args), cats


def phase_similar_serving(dev, *, n_items=N_ITEMS, rank=RANK, n_seq=16,
                          n_conc=256, n_wide=64, n_filtered=32, procs=4,
                          threads=16) -> dict:
    """Phase 14a: the similarproduct server over HTTP at full width, with
    the launch counts set to 0 before it deploys: 16 sequential queries of
    1 to 5 items at num 10, 256 sent at once from ``procs`` client
    processes of ``threads`` threads, 64 at num 100 (``topk_sort``) and 32
    filtered ones (the host path, no launch); every answer against the
    float64 host cosine top-N (``sim_check``); the same burst again under
    the profiler for the device's busy share."""
    reset_launches()
    t0 = time.perf_counter()
    server, cats = build_similar_server(dev, n_items=n_items, rank=rank)
    out = {"items": n_items, "rank": rank, "deploy_s":
           time.perf_counter() - t0, "warmed": server.deployed.warmed}
    model = server.deployed.result.models[0]
    check(model.als._sim_retriever._items.device.type == dev.type
          and not hasattr(model, "_pipeline"),
          f"the normalized catalog is not on {dev.type}, or the wrapper "
          "got a pipeline")
    items64 = model.als.item_factors.astype(np.float64)
    items64n = items64 / (np.linalg.norm(items64, axis=1, keepdims=True)
                          + 1e-9)
    rng = np.random.default_rng(SEED + 15)
    seq = sim_queries(rng, n_seq, n_items, 10)
    conc = sim_queries(rng, n_conc, n_items, 10)
    wide = sim_queries(rng, n_wide, n_items, 100)
    filtered = sim_queries(rng, n_filtered, n_items, 10, cats,
                           filtered=True)
    with serve(server, "127.0.0.1", 0) as front:
        url = f"http://127.0.0.1:{front.port}/queries.json"
        walls = []
        for qj in seq:
            body, wall = post(url, qj)
            sim_check(body, qj, items64n, cats)
            walls.append(wall)
        answers, conc_s = burst(url, conc, procs, threads)
        for qj, (body, wall) in zip(conc, answers):
            sim_check(body, qj, items64n, cats)
            walls.append(wall)
        wide_answers, wide_s = burst(url, wide, procs, threads)
        for qj, (body, _wall) in zip(wide, wide_answers):
            sim_check(body, qj, items64n, cats)
        before = kernels.LAUNCHES["topk"]
        t0 = time.perf_counter()
        for qj in filtered:
            body, _wall = post(url, qj)
            sim_check(body, qj, items64n, cats)
        out["filtered_s"] = time.perf_counter() - t0
        check(kernels.LAUNCHES["topk"] == before,
              "a filtered similar-items query launched the top-k kernel")
        launches = dict(kernels.LAUNCHES)
        prof_answers = []
        busy, prof_s = device_profile(lambda: prof_answers.extend(
            burst(url, conc, procs, threads)[0]))
        for qj, (body, _wall) in zip(conc, prof_answers):
            sim_check(body, qj, items64n, cats)
    check(launches["topk"] > 0 and launches["topk_select"] > 0
          and launches["topk_sort"] > 0,
          f"similar-items serving did not launch topk at num 10 and 100: "
          f"{launches}")
    walls_ms = np.array(walls) * 1e3
    out.update({
        "queries": n_seq + n_conc + n_wide + n_filtered,
        "single_p50_ms": float(np.percentile(walls_ms[:n_seq], 50)),
        "single_p99_ms": float(np.percentile(walls_ms[:n_seq], 99)),
        "burst_qps": n_conc / conc_s, "clients": procs * threads,
        "burst_p50_ms": float(np.percentile(walls_ms[n_seq:], 50)),
        "burst_p99_ms": float(np.percentile(walls_ms[n_seq:], 99)),
        "num100_qps": n_wide / wide_s,
        "device_busy_share": sum(busy.values()) / 1e3 / prof_s,
        "launches": launches})
    del server
    return out


def template_events(seed: int, n_users=TMPL_USERS, n_items=TMPL_ITEMS,
                    n_views=TMPL_VIEWS, n_likes=TMPL_LIKES,
                    n_buys=TMPL_BUYS, n_rates=TMPL_RATES) -> tuple:
    """One app's events from ``seed``, as wire dicts: an item ``$set`` with
    categories per item, then ``view``, ``like``/``dislike``, ``buy`` and
    ``rate`` (half stars) events, and one ``constraint/unavailableItems``
    ``$set``; and the item categories."""
    rng = np.random.default_rng(seed)
    cats = item_categories(rng, n_items)
    t0 = datetime(2021, 1, 1, tzinfo=timezone.utc)
    Event, DataMap = pio_storage.Event, pio_storage.DataMap
    events = [Event(event="$set", entity_type="item", entity_id=i,
                    properties=DataMap({"categories": list(c)}),
                    event_time=t0) for i, c in cats.items()]
    k = 0
    for kinds, n in ((("view",), n_views), (("like", "dislike"), n_likes),
                     (("buy",), n_buys), (("rate",), n_rates)):
        users = rng.integers(0, n_users, n)
        items = rng.integers(0, n_items, n)
        which = rng.integers(0, len(kinds), n)
        stars = np.round(rng.random(n) * 9 + 1) / 2
        for j in range(n):
            k += 1
            name = kinds[which[j]]
            events.append(Event(
                event=name, entity_type="user", entity_id=f"u{users[j]}",
                target_entity_type="item", target_entity_id=f"i{items[j]}",
                properties=DataMap({"rating": float(stars[j])}
                                   if name == "rate" else {}),
                event_time=t0 + timedelta(seconds=k)))
    blocked = [f"i{int(i)}" for i in rng.choice(n_items, 20, replace=False)]
    events.append(Event(event="$set", entity_type="constraint",
                        entity_id="unavailableItems",
                        properties=DataMap({"items": blocked}),
                        event_time=t0 + timedelta(seconds=k + 1)))
    return [pio_storage.event_to_api_dict(e) for e in events], cats


def deployed_template(name: str, engine_dir: str, queries: list,
                      host_answer, extra=None) -> dict:
    """``pio train`` then ``pio deploy`` of ``engine_dir`` (launch counts
    set to 0 first), ``queries`` over HTTP each held to ``host_answer(query,
    models)`` of the stored blob's models, ``extra(base, models)`` while it
    serves, then ``pio undeploy``. Returns the stage seconds and the
    launches."""
    out: dict = {}
    t0 = time.perf_counter()
    text = pio_ok(["train", "--engine-dir", engine_dir])
    out["train_s"] = time.perf_counter() - t0
    marker = "Training completed. Engine instance: "
    check(marker in text, f"{name}: train said {text!r}")
    iid = text.split(marker)[1].split()[0]
    models = stored_models(iid)
    reset_launches()
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    deploy, deploy_result = pio_thread(
        ["deploy", "--engine-dir", engine_dir, "--ip", "127.0.0.1",
         "--port", port])
    try:
        status = wait_answer(base + "/", deploy, deploy_result)
        out["deploy_s"] = time.perf_counter() - t0
        check(status["engineInstanceId"] == iid,
              f"{name}: deploy serves {status['engineInstanceId']}")
        t0 = time.perf_counter()
        for q in queries:
            body, _wall = post(base + "/queries.json", q)
            host_answer(body, q, models)
        out["queries_s"] = time.perf_counter() - t0
        if extra is not None:
            out.update(extra(base, models))
        out["launches"] = dict(kernels.LAUNCHES)
    finally:
        pio(["undeploy", "--port", port])
        deploy.join(60)
    check(not deploy.is_alive() and deploy_result == [0],
          f"{name}: undeploy did not end the server: {deploy_result}")
    return out


def rows_check(what: str, got: list, want: list, tie: float = 0.0) -> None:
    """A served list against the host's (item, score) list on the stored
    factors: the same length, scores rank by rank within phase 3's
    tolerance, and the same items but where the host's scores at a rank
    lie within ``tie`` of the list's largest |score| of the served one's
    (a near-tie the kernel's summation order can swap)."""
    gi, gs = [g["item"] for g in got], [g["score"] for g in got]
    wi, ws = [i for i, _ in want], [s for _, s in want]
    check(len(gi) == len(wi), f"{what}: {len(gi)} items, host {len(wi)}")
    check(np.allclose(gs, ws, rtol=RTOL, atol=1e-6),
          f"{what}: scores differ from the host's")
    width = tie * max((abs(s) for s in ws), default=0.0)
    check(all(g == w or abs(a - b) <= width
              for g, w, a, b in zip(gi, wi, gs, ws)),
          f"{what}: {gi} != host {wi}")


def phase_als_templates(dev, *, seed=SEED, n_seq=16, **sizes) -> dict:
    """Phase 14b: one app from ``seed`` (``template_events``) imported with
    ``pio import``; then similarproduct, ecommercerecommendation and
    filterbycategory in turn through ``pio template get``, ``pio train``
    on the card, ``pio deploy`` and 16 queries, each held to the host
    scoring of the stored blob's factors, and ``pio undeploy``; the
    e-commerce engine also serves an unseen user with recent views (the
    host fold-in's top-N) and sees an ``unavailableItems`` ``$set`` posted
    to ``pio eventserver`` once its TTL has passed, without a retrain;
    then customdatasource trained from its shipped file, deployed and
    queried. Every check raises."""
    from predictionio_tpu_torch.templates.ecommercerecommendation import (
        engine as ecomm)
    from predictionio_tpu_torch.templates.similarproduct import (
        engine as sp)

    out: dict = {}
    home = tempfile.mkdtemp(prefix="pio-chip-templates-")
    os.environ["PIO_HOME"] = home
    if dev.type == "cpu":
        os.environ["PIO_PLATFORM"] = "cpu"
    else:
        os.environ.pop("PIO_PLATFORM", None)
    Storage = pio_storage.Storage
    Storage.reset()
    t0 = time.perf_counter()
    wire, cats = template_events(seed, **sizes)
    events_file = os.path.join(home, "events.jsonl")
    with open(events_file, "w") as fh:
        for e in wire:
            fh.write(json.dumps(e) + "\n")
    out["events"] = len(wire)
    out["events_s"] = time.perf_counter() - t0
    text = pio_ok(["app", "new", TMPL_APP])
    key = text.split("Access key: ")[1].split()[0]
    app_id = Storage.get_metadata().app_get_by_name(TMPL_APP).id
    t0 = time.perf_counter()
    text = pio_ok(["import", "--appid", app_id, "--input", events_file])
    out["import_s"] = time.perf_counter() - t0
    check(f"Imported {len(wire)} events" in text, f"import said {text!r}")
    n_users = sizes.get("n_users", TMPL_USERS)
    n_items = sizes.get("n_items", TMPL_ITEMS)
    rng = np.random.default_rng(seed + 14)

    def engine_dir(name: str, **algo_params) -> str:
        d = os.path.join(home, name)
        pio_ok(["template", "get", name, d])
        path = os.path.join(d, "engine.json")
        with open(path) as fh:
            variant = json.load(fh)
        if "app_name" in variant["datasource"]["params"]:
            variant["datasource"]["params"]["app_name"] = TMPL_APP
        for algo in variant["algorithms"]:
            algo["params"].update(algo_params)
        with open(path, "w") as fh:
            json.dump(variant, fh)
        return d

    # similarproduct: two implicit-ALS algorithms, cosine top-N summed by
    # DedupeServing; each answer against the same code on the host
    def similar_host(body, q, models):
        query = sp.Query(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in q.items()})
        preds = [sp.PredictedResult(itemScores=m.similar(query))
                 for m in models]
        want = sp.DedupeServing().serve(query, preds).itemScores
        got = body["itemScores"]
        check(not set(q["items"]) & {g["item"] for g in got},
              f"similarproduct {q}: a query item in its own answer")
        mask = sim_mask(q, cats, n_items)
        check(mask is None or all(mask[int(g["item"][1:])] for g in got),
              f"similarproduct {q}: a filter not obeyed")
        rows_check(f"similarproduct {q}", got,
                   [(s.item, s.score) for s in want], tie=SIM_TOL)

    sim_q = sim_queries(rng, n_seq - 4, n_items, 10) + sim_queries(
        rng, 4, n_items, 10, cats, filtered=True)
    t0 = time.perf_counter()
    d = engine_dir("similarproduct")
    sim = deployed_template("similarproduct", d, sim_q, similar_host)
    check(sim["launches"]["topk"] > 0,
          f"similarproduct never launched topk: {sim['launches']}")
    sim["stage_s"] = time.perf_counter() - t0
    out["similarproduct"] = sim

    # ecommercerecommendation: host scoring with the live filters, as the
    # reference; held to the same algorithm run here on the stored blob
    ecomm_algo = ecomm.ECommAlgorithm(ecomm.AlgorithmParams(
        app_name=TMPL_APP, constraint_ttl_seconds=0.0))

    def ecomm_host(body, q, models):
        want = ecomm_algo.predict(models[0], ecomm.Query(**q)).itemScores
        rows_check(f"ecommercerecommendation {q}", body["itemScores"],
                   [(s.item, s.score) for s in want])

    def ecomm_live(base, models):
        """An unseen user's recent views, and an unavailableItems $set,
        posted to ``pio eventserver``."""
        res: dict = {}
        eport = free_port()
        ebase = f"http://127.0.0.1:{eport}"
        es, es_result = pio_thread(["eventserver", "--ip", "127.0.0.1",
                                    "--port", eport])
        check(wait_answer(ebase + "/health.json", es, es_result)
              ["status"] == "ok", "the event server is not healthy")
        viewed = [f"i{int(i)}" for i in rng.choice(n_items, 6,
                                                   replace=False)]
        for item in viewed:
            code, body = post_status(f"{ebase}/events.json?accessKey={key}", {
                "event": "view", "entityType": "user",
                "entityId": "newcomer", "targetEntityType": "item",
                "targetEntityId": item})
            check(code == 201, f"POST /events.json answered {code} {body}")
        q = {"user": "newcomer", "num": 10}
        body, _ = post(base + "/queries.json", q)
        als_model = models[0].als
        u = als_model.fold_in_user(sorted(viewed), [1.0] * len(viewed))
        scores = als_model.item_factors @ u
        check(bool(body["itemScores"]) and not set(viewed) & {
            g["item"] for g in body["itemScores"]},
              f"the unseen user's answer {body}")
        ecomm_host(body, q, models)
        served = [g["item"] for g in body["itemScores"]]
        check(np.allclose([g["score"] for g in body["itemScores"]],
                          [scores[als_model.item_ids[i]] for i in served],
                          rtol=RTOL, atol=1e-6),
              "the unseen user's scores are not the host fold-in's")
        # the top two go unavailable: gone once the TTL has passed
        blocked = served[:2]
        t_post = time.perf_counter()
        code, body = post_status(f"{ebase}/events.json?accessKey={key}", {
            "event": "$set", "entityType": "constraint",
            "entityId": "unavailableItems",
            "properties": {"items": blocked}})
        check(code == 201, f"POST the constraint answered {code} {body}")
        gone = poll_until(lambda: not set(blocked) & {
            g["item"] for g in post(base + "/queries.json", q)[0]
            ["itemScores"]}, TMPL_TTL_S + 30)
        check(gone, f"the unavailableItems $set never took effect: "
              f"{blocked}")
        res["constraint_effect_s"] = time.perf_counter() - t_post
        body, _ = post(base + "/queries.json", q)
        ecomm_host(body, q, models)
        return res

    ecomm_q = [{"user": f"u{int(rng.integers(0, n_users))}",
                "num": int(rng.choice([4, 10, 20]))} for _ in range(n_seq)]
    t0 = time.perf_counter()
    d = engine_dir("ecommercerecommendation", app_name=TMPL_APP,
                   constraint_ttl_seconds=TMPL_TTL_S)
    out["ecommercerecommendation"] = deployed_template(
        "ecommercerecommendation", d, ecomm_q, ecomm_host, ecomm_live)
    out["ecommercerecommendation"]["stage_s"] = time.perf_counter() - t0

    # filterbycategory: unfiltered queries through batch_recommend and the
    # top-k kernel, filtered ones on the gathered host slice
    def category_host(body, q, models):
        model = models[0]
        got = body["itemScores"]
        if q.get("categories"):
            want = model.recommend(q["user"], q["num"],
                                   tuple(q["categories"]))
            rows_check(f"filterbycategory {q}", got, want)
            check(all(set(q["categories"]) & set(
                cats[g["item"]]) for g in got),
                  f"filterbycategory {q}: a category not obeyed")
        else:
            stored_check(body, q, model.als)

    cat_q = [{"user": f"u{int(rng.integers(0, n_users))}", "num": 10,
              **({"categories": [f"c{int(c)}" for c in rng.choice(
                  N_CATS, 2, replace=False)]} if j % 2 else {})}
             for j in range(n_seq)]
    t0 = time.perf_counter()
    d = engine_dir("filterbycategory")
    fc = deployed_template("filterbycategory", d, cat_q, category_host)
    check(fc["launches"]["topk"] > 0,
          f"filterbycategory never launched topk: {fc['launches']}")
    fc["stage_s"] = time.perf_counter() - t0
    out["filterbycategory"] = fc

    # customdatasource: trained from the shipped ratings file
    def custom_host(body, q, models):
        stored_check(body, q, models[0])

    custom_q = [{"user": f"u{j % 12}", "num": 4} for j in range(n_seq - 1)]
    custom_q.append({"user": "nobody", "num": 4})
    t0 = time.perf_counter()
    d = engine_dir("customdatasource")
    out["customdatasource"] = deployed_template("customdatasource", d,
                                                custom_q, custom_host)
    out["customdatasource"]["stage_s"] = time.perf_counter() - t0
    out["home"] = home
    Storage.reset()
    return out


def kernel_record(name: str, launches: int, case: dict, *,
                  source=KERNEL_SOURCE, replaces=REPLACES) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"],
            "share_of_bound": case["bound_ms"] / case["ms"]}


def wide_records(fwd_launches: int, bwd_launches: dict, fwd: dict,
                 bwd: dict, *, route: str = "wide",
                 source: str = WIDE_SOURCE,
                 fwd_source: str = WIDE_FWD_SOURCE) -> list:
    """The kernels line's records of the wide (or huge) kernels at their
    timed f32 shape."""
    recs = [kernel_record(f"flash_attention_{route}", fwd_launches, fwd,
                          source=fwd_source, replaces=WIDE_REPLACES)]
    for entry, key, grads in ((f"flash_attention_{route}_bwd_dkv", "dkv",
                               ("dk", "dv")),
                              (f"flash_attention_{route}_bwd_dq", "dq",
                               ("dq",))):
        recs.append(kernel_record(entry, bwd_launches[entry], {
            "max_abs_err": max(bwd[f"{g}_max_abs_err"] for g in grads),
            "ms": bwd[f"{key}_ms"], "plain_ms": bwd["plain_ms"],
            "bound_ms": bwd[f"{key}_bound_ms"],
            "bound_by": bwd[f"{key}_bound_by"],
            "library_ms": bwd["library_ms"]},
            source=source, replaces=WIDE_REPLACES))
    return recs


# -- phase 15: the engine server's instrumentation and golden traffic -------

#: the stages every answered pipelined query's waterfall must carry
WF_STAGES = ("queue_wait", "batch_form", "host_assembly", "device_dispatch",
             "device_compute", "result_scatter")


def wf_sound(rec: dict) -> bool:
    """The reference's own check (``tests/test_latency_attribution.py``,
    ``_assert_sound``): the stages sum to the wall within 5% of the wall
    plus 0.05 ms."""
    total = sum(rec["stagesMs"].values())
    return abs(total - rec["wallMs"]) <= 0.05 * rec["wallMs"] + 0.05


def known_queries(rng, n: int, n_users: int, nums=(1, 4, 10, 20)) -> list:
    return [{"user": f"u{int(rng.integers(0, n_users))}",
             "num": nums[j % len(nums)]} for j in range(n)]


def stage_percentiles(records: list) -> dict:
    """Each stage's p50 and p99 in ms over ``records``."""
    out = {}
    for s in STAGES:
        xs = [r["stagesMs"][s] for r in records if s in r["stagesMs"]]
        if xs:
            out[s] = {"p50": float(np.percentile(xs, 50)),
                      "p99": float(np.percentile(xs, 99)), "n": len(xs)}
    return out


def burst_qps(url: str, queries: list, procs: int, threads: int,
              users, items) -> tuple[float, float]:
    """(qps, p50 ms) of one burst, every answer against the host top-k."""
    answers, span = burst(url + "/queries.json", queries, procs, threads)
    for qj, (body, _wall) in zip(queries, answers):
        host_check(body, qj, users, items)
    return (len(queries) / span,
            float(np.percentile([w for _, w in answers], 50)) * 1e3)


def phase_waterfalls(dev, *, n_seq=16, n_conc=256, procs=4, threads=16,
                     **sizes) -> tuple:
    """15a: phase 3's ML-20M catalog served pipelined with instrumentation
    on, capture at sample 1.0 and a 512-record flight ring; ``n_seq``
    sequential queries, then ``n_conc`` from ``procs`` x ``threads``
    client threads. Every answered query's flight record sums to its wall
    (the reference's 5% + 0.05 ms), carries each stage of the path, and a
    fenced ``device_compute`` above 0; ``/health.json``, ``/metrics`` and
    ``/stats.json`` carry the SLO, flight, stage families and the device
    ledger's catalog and table. Then the same burst against a server with
    instrumentation off (its cost, recorded, not bounded). Returns the
    record, the instrumented server (still capturing), its front end and
    its capture directory."""
    out: dict = {}
    cap_dir = tempfile.mkdtemp(prefix="pio-chip-capture-")
    FLIGHT.reset()  # before the server registers its capture listener
    LEDGER.reset()
    server = build_server(dev, capture_dir=cap_dir, capture_sample=1.0,
                          flight_capacity=512, **sizes)
    model = server.deployed.result.models[0]
    users, items = model.user_factors, model.item_factors
    rng = np.random.default_rng(SEED + 15)
    seq = known_queries(rng, n_seq, len(users))
    conc = known_queries(rng, n_conc, len(users))
    front = serve(server, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{front.port}"
    reset_launches()
    for j, qj in enumerate(seq):
        status, body, hdrs, _ = post_full(url, qj,
                                          {"X-PIO-Request-ID": f"seq-{j}"})
        check(status == 200 and hdrs.get("X-PIO-Provenance"),
              f"a sequential query answered {status} {hdrs}")
        host_check(body, qj, users, items)
    METRICS.reset()  # the burst's stage histograms alone
    t0 = time.perf_counter()
    qps_on, p50_on = burst_qps(url, conc, procs, threads, users, items)
    out["burst_s"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check(launches["topk_rows"] > 0 and launches["topk"] == 0,
          f"15a did not serve through topk_rows alone: {launches}")
    records = [r for r in FLIGHT.snapshot()["records"] if r["status"] == "ok"]
    check(len(records) == n_seq + n_conc,
          f"{len(records)} flight records for {n_seq + n_conc} answers")
    for rec in records:
        check(wf_sound(rec), f"a waterfall does not sum to its wall: {rec}")
        check(all(s in rec["stagesMs"] for s in WF_STAGES),
              f"a waterfall lacks a stage of the path: {rec}")
        check(rec["stagesMs"]["device_compute"] > 0,
              f"a waterfall's fenced device_compute is 0: {rec}")
    burst_recs = [r for r in records if not str(r["requestId"])
                  .startswith("seq-")]
    health = get_json(url + "/health.json")
    check(health["slo"] is not None and health["flight"] is not None
          and health["flight"]["records"] == len(records),
          f"/health.json slo/flight: {health['slo']} {health['flight']}")
    with urllib.request.urlopen(url + "/metrics", timeout=60) as resp:
        metrics = resp.read().decode()
    missing = [s for s in STAGES
               if f"pio_serve_stage_{s}_seconds" not in metrics]
    check(not missing, f"/metrics lacks the stage families {missing}")
    stats = get_json(url + "/stats.json")
    comps = stats["device"]["components"]
    want = {"retriever_catalog": model._retriever._items.nbytes,
            "pipeline_query_table": model._pipeline._qtab.nbytes}
    check(all(comps.get(k, {}).get("bytes") == v for k, v in want.items()),
          f"/stats.json device components {comps}, want {want}")
    wfb = stats["waterfall"]
    out.update({
        "queries": len(records), "topk_rows_launches": launches["topk_rows"],
        "topk_select_launches": launches["topk_select"],
        "topk_merge_launches": launches["topk_merge"],
        "burst_stage_ms": stage_percentiles(burst_recs),
        "seq_stage_ms": stage_percentiles(
            [r for r in records if r not in burst_recs]),
        "burst_wall_ms": {
            "p50": float(np.percentile([r["wallMs"] for r in burst_recs],
                                       50)),
            "p99": float(np.percentile([r["wallMs"] for r in burst_recs],
                                       99))},
        "hostShare": wfb["hostShare"], "deviceShare": wfb["deviceShare"],
        "ledger_bytes": {k: comps[k]["bytes"] for k in comps},
        "cuda_max_allocated_bytes":
            stats["device"]["cudaMaxAllocatedBytes"],
        "qps_instrumented": qps_on, "p50_ms_instrumented": p50_on})
    # the instrumentation's cost: the same burst with waterfalls off
    # (FLIGHT keeps the 512 ring; the recorder's context stays server's)
    plain = build_server(dev, instrumentation=False, flight_capacity=512,
                         **sizes)
    FLIGHT.set_context_provider(server._flight_context)
    with serve(plain, "127.0.0.1", 0) as pfront:
        qps_off, p50_off = burst_qps(f"http://127.0.0.1:{pfront.port}",
                                     conc, procs, threads, users, items)
    out.update({"qps_uninstrumented": qps_off,
                "p50_ms_uninstrumented": p50_off})
    check(len(FLIGHT.snapshot()["records"]) == len(records),
          "the uninstrumented server recorded waterfalls")
    return out, server, front, cap_dir


def trace_kernel_names(trace_file: str) -> set:
    """The names of the CUDA kernel events of a chrome trace."""
    with open(trace_file) as fh:
        events = json.load(fh).get("traceEvents", [])
    return {e.get("name", "") for e in events
            if str(e.get("cat", "")).lower() == "kernel"}


def phase_profile(dev, server, url: str, *, n_conc=64, procs=4,
                  threads=16) -> dict:
    """15b: ``POST /debug/profile?seconds=2`` while ``n_conc`` queries
    run: the chrome trace's CUDA kernel events name ``topk_rows``'s
    kernels (``topk_select`` and the merge), ``flightBefore`` and
    ``flightAfter`` come back, and a second POST in the window answers
    409."""
    model = server.deployed.result.models[0]
    users, items = model.user_factors, model.item_factors
    conc = known_queries(np.random.default_rng(SEED + 151), n_conc,
                         len(users))
    trace_dir = tempfile.mkdtemp(prefix="pio-chip-profile-")
    t, res = on_thread(post_status, f"{url}/debug/profile?seconds=2&dir="
                       f"{urllib.parse.quote(trace_dir)}", {})
    check(poll_until(lambda: server._profile_lock.locked(), 30),
          "the profile window never opened")
    time.sleep(0.2)  # the profiler is recording before the burst goes
    answers, _span = burst(url + "/queries.json", conc, procs, threads)
    for qj, (body, _wall) in zip(conc, answers):
        host_check(body, qj, users, items)
    second = post_status(url + "/debug/profile?seconds=1", {})
    t.join(120)
    check(second[0] == 409, f"a second profile POST answered {second}")
    check(bool(res) and res[0][0] == 200, f"the profile POST: {res}")
    body = res[0][1]
    check(body["flightBefore"] is not None and body["flightAfter"] is not None
          and len(body["flightAfter"]["records"])
          >= len(body["flightBefore"]["records"]),
          "the flight snapshots do not bracket the window")
    names = trace_kernel_names(body["traceFile"])
    topk_names = sorted(n for n in names if "topk" in n)
    check(any("topk_select" in n for n in names)
          and any("topk_merge_round" in n for n in names),
          f"the trace's kernel events do not name topk_rows' kernels: "
          f"{topk_names or sorted(names)[:20]}")
    return {"trace_file": body["traceFile"],
            "trace_bytes": os.path.getsize(body["traceFile"]),
            "kernel_names": topk_names, "kernel_event_names": len(names),
            "second_post": second[0]}


def tier_counts(report: dict) -> dict:
    return {t: n for t, n in report["tiers"].items() if n}


def phase_capture_replay(dev, server, front, url: str, cap_dir: str, *,
                         n_patch=8, n_shadow=64, **sizes) -> dict:
    """15c: ``POST /capture/stop``, then the capture replayed against the
    same server: 100% bitwise with an empty provenance delta. A legacy
    server (``topk``, not ``topk_rows``) replays the pipelined capture
    bitwise. ``POST /reload/delta`` patching ``n_patch`` captured users,
    then the replay again: the mismatches are exactly those users'
    queries and the provenance delta names ``patchEpoch``. A third server
    shadowing to the legacy one answers ``n_shadow`` queries, and
    ``pio_shadow_diff_total`` counts every one in the legacy replay's
    tier."""
    out: dict = {}
    status, body = post_status(url + "/capture/stop", {})
    check(status == 200 and body["capture"]["enabled"] is False,
          f"/capture/stop answered {status} {body}")
    records = list(iter_capture(cap_dir))
    check(bool(records)
          and len(records) == body["capture"]["journalRecords"],
          f"{len(records)} captured records")
    out["records"] = len(records)
    t0 = time.perf_counter()
    rep = replay_records(records, target=url)
    out["self_replay_s"] = time.perf_counter() - t0
    check(rep["tiers"]["bitwise"] == len(records)
          and rep["provenance"]["delta"] == {},
          f"the self-replay: {tier_counts(rep)} {rep['provenance']['delta']}")
    out["self_replay"] = tier_counts(rep)

    legacy = build_server(dev, serving_pipeline="legacy", **sizes)
    lfront = serve(legacy, "127.0.0.1", 0)
    lurl = f"http://127.0.0.1:{lfront.port}"
    reset_launches()
    t0 = time.perf_counter()
    lrep = replay_records(records, target=lurl)
    out["legacy_replay_s"] = time.perf_counter() - t0
    legacy_launches = dict(kernels.LAUNCHES)
    check(legacy_launches["topk"] > 0 and legacy_launches["topk_rows"] == 0,
          f"the legacy server did not serve through topk: {legacy_launches}")
    out["legacy_replay"] = tier_counts(lrep)
    out["legacy_topk_launches"] = legacy_launches["topk"]
    out["legacy_delta"] = sorted(lrep["provenance"]["delta"])
    check(lrep["tiers"]["bitwise"] == len(records),
          f"the legacy replay of the pipelined capture is not bitwise: "
          f"{tier_counts(lrep)}; first rows "
          f"{json.dumps(lrep['mismatches'][:3])[:2000]}")

    # the delta plane: exactly the patched users' queries move
    model = server.deployed.result.models[0]
    rng = np.random.default_rng(SEED + 152)
    captured = sorted({r["request"]["user"] for r in records})
    patched = [captured[int(i)] for i in
               rng.choice(len(captured), n_patch, replace=False)]
    rank = model.user_factors.shape[1]
    vecs = {u: (rng.standard_normal(rank) / np.sqrt(rank)).tolist()
            for u in patched}
    status, body = post_status(url + "/reload/delta", {"users": vecs})
    check(status == 200 and body["appliedCount"] == n_patch,
          f"/reload/delta answered {status} {body}")
    drep = replay_records(records, target=url)
    touched = {r["rid"] for r in records if r["request"]["user"] in vecs}
    moved = {m["rid"] for m in drep["mismatches"]}
    check(moved == touched and drep["tiers"]["mismatch"] == len(touched)
          and drep["tiers"]["bitwise"] == len(records) - len(touched),
          f"after the patch {tier_counts(drep)}: {len(moved)} moved, "
          f"{len(touched)} patched-user records")
    check(drep["provenance"]["delta"].get("patchEpoch") == {
        "captured": 0, "replayed": 1},
          f"the provenance delta {drep['provenance']['delta']}")
    out["delta_replay"] = tier_counts(drep)
    out["delta_patched_records"] = len(touched)

    # the shadow mirror: a third server shadowing to the legacy one
    shadowing = build_server(dev, shadow_target=lurl, shadow_sample=1.0,
                             **sizes)
    queries = known_queries(rng, n_shadow, len(model.user_factors))
    before = {t: METRICS.get("pio_shadow_diff_total").value(t)
              for t in ("bitwise", "topk_set", "score_tol", "mismatch",
                        "error")}
    with serve(shadowing, "127.0.0.1", 0) as sfront:
        surl = f"http://127.0.0.1:{sfront.port}"
        burst(surl + "/queries.json", queries, 4, 16)
        check(poll_until(lambda: shadowing.shadow.mirrored
                         + shadowing.shadow.tiers["error"] >= n_shadow, 60),
              f"the shadow mirrored {shadowing.shadow.stats()}")
    diff = {t: METRICS.get("pio_shadow_diff_total").value(t) - before[t]
            for t in before}
    want_tier = max(lrep["tiers"], key=lrep["tiers"].get)
    check(diff[want_tier] == n_shadow and sum(diff.values()) == n_shadow,
          f"pio_shadow_diff_total moved {diff}, want {n_shadow} {want_tier}")
    out["shadow_diff"] = {t: n for t, n in diff.items() if n}
    out["shadow_lag_s"] = METRICS.get("pio_shadow_lag_seconds").value()
    lfront.close()
    return out


def phase_verbs(dev, home: str, *, n_queries=32) -> dict:
    """15d: ``pio deploy --capture-dir D --capture-sample 1.0`` of phase
    9's engine (in this process, the launch counts set to 0 first), 32
    queries, then ``pio capture stop``, ``capture export``, ``replay
    --target`` (100% bitwise), ``replay`` in-process, ``top --once``,
    ``trace <rid> --url`` (one query's waterfall as a span tree) and
    ``profile serve --seconds 1``; then ``pio undeploy``."""
    out: dict = {}
    os.environ["PIO_HOME"] = home
    Storage = pio_storage.Storage
    Storage.reset()
    engine_dir = os.path.join(home, "engine")
    cap_dir = os.path.join(home, "capture-15d")
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    reset_launches()
    deploy, deploy_result = pio_thread([
        "deploy", "--engine-dir", engine_dir, "--port", port,
        "--capture-dir", cap_dir, "--capture-sample", "1.0"])
    try:
        iid = wait_answer(base + "/", deploy, deploy_result)[
            "engineInstanceId"]
        model = stored_model(iid)
        names = model.user_ids.inverse_array()
        rng = np.random.default_rng(SEED + 153)
        for j in range(n_queries):
            q = {"user": str(names[int(rng.integers(0, len(names)))]),
                 "num": (1, 4, 10, 20)[j % 4]}
            status, body, _, _ = post_full(base, q,
                                           {"X-PIO-Request-ID": f"verb-{j}"})
            check(status == 200, f"a 15d query answered {status}")
            stored_check(body, q, model)
        check(kernels.LAUNCHES["topk_rows"] > 0,
              f"the deployed server never launched topk_rows: "
              f"{kernels.LAUNCHES}")
        out["topk_rows_launches"] = kernels.LAUNCHES["topk_rows"]
        text = pio_ok(["capture", "stop", "--url", base])
        check("onDisk=32" in text, f"pio capture stop said {text!r}")
        export = os.path.join(home, "capture-15d.jsonl")
        text = pio_ok(["capture", "export", cap_dir, "--output", export])
        check(f"Exported {n_queries} captured record(s)" in text,
              f"pio capture export said {text!r}")
        t0 = time.perf_counter()
        text = pio_ok(["replay", cap_dir, "--target", base, "--json"])
        out["replay_target_s"] = time.perf_counter() - t0
        report = json.loads(text)
        check(report["parityPct"] == 100.0
              and report["provenance"]["delta"] == {},
              f"pio replay --target: {tier_counts(report)} "
              f"{report['provenance']['delta']}")
        t0 = time.perf_counter()
        text = pio_ok(["replay", cap_dir, "--engine-dir", engine_dir])
        out["replay_in_process_s"] = time.perf_counter() - t0
        check("parity 100.0%" in text
              and "provenance identical between capture and replay" in text,
              f"pio replay in-process said {text!r}")
        text = pio_ok(["top", "--url", base, "--once"])
        check("pio top · mode=normal" in text and "device ledger" in text,
              f"pio top said {text!r}")
        text = pio_ok(["trace", "verb-5", "--url", base])
        check(text.startswith("trace verb-5") and "device_compute" in text,
              f"pio trace said {text!r}")
        out["trace_lines"] = len(text.splitlines())
        text = pio_ok(["profile", "serve", "--url", base, "--seconds", "1"])
        check("Captured 1.0s profiler trace" in text,
              f"pio profile serve said {text!r}")
        pio_ok(["undeploy", "--port", port])
        deploy.join(60)
        check(not deploy.is_alive() and deploy_result == [0],
              f"undeploy did not end the server: {deploy_result}")
    finally:
        if deploy.is_alive():
            pio(["undeploy", "--port", port])
            deploy.join(60)
        Storage.reset()
    return out


#: phase 16a's traffic split and the split after the promote (a swap)
AB_WEIGHTS = {"default": 0.8, "challenger": 0.2}
AB_PROMOTED = {"default": 0.2, "challenger": 0.8}
#: 16c: the feedback breaker's reset, cut from the reference's 30 s so the
#: half-open probe comes within the phase
FEEDBACK_RESET_S = 2.0


def pipeline_dispatches(server) -> int:
    return server.deployed.result.models[0]._pipeline.stats()["dispatches"]


def served_factors(server) -> tuple:
    """(user factors, item factors) of the bundle ``server`` serves now."""
    model = server.deployed.result.models[0]
    return model.user_factors, model.item_factors


def ab_queries(rows) -> list:
    return [{"user": f"u{int(r)}", "num": (1, 4, 10, 20)[j % 4]}
            for j, r in enumerate(rows)]


def phase_variants(dev, *, n_users=N_USERS, n_items=N_ITEMS, rank=RANK,
                   n_burst=256, n_forced=16, n_patch=8, n_retired=64,
                   procs=4, threads=16) -> dict:
    """16a: phase 3's catalog as the live variant and a challenger from
    another seed, co-hosted at 0.8/0.2 behind one ``serve()``, capture at
    sample 1.0 on the primary. A burst over distinct users: each answer
    from the variant ``bucket_for`` names, equal to the host top-N of that
    variant's factors, each variant's answers ``topk_rows`` launches on
    its own pipeline; ``n_forced`` ``X-PIO-Variant`` queries a variant;
    the capture replayed 100% bitwise per variant; the challenger promoted
    during a second burst (every answer 200 and from the variant its
    provenance names, by the old weights or the new); a delta of
    ``n_patch`` users to the challenger moves only the challenger's
    answers for them; the old champion retired: no hashed query reaches
    it, forced ones do. ``torch.cuda.memory_allocated`` before the
    challenger's build and after its registration, the ledger, and the
    burst's qps."""
    out: dict = {}
    sizes = dict(n_users=n_users, n_items=n_items, rank=rank)
    cap_dir = tempfile.mkdtemp(prefix="pio-chip-abcap-")
    FLIGHT.reset()
    LEDGER.reset()
    primary = build_server(dev, capture_dir=cap_dir, capture_sample=1.0,
                           capture_ring=1024, **sizes)
    mem0 = device_memory(dev)
    t0 = time.perf_counter()
    challenger = build_server(dev, seed=SEED + 160, variant_id="challenger",
                              **sizes)
    primary.variants.register("challenger", challenger,
                              weight=AB_WEIGHTS["challenger"])
    primary.variants.set_weight("default", AB_WEIGHTS["default"])
    out["challenger_deploy_s"] = time.perf_counter() - t0
    mem1 = device_memory(dev)
    out["memory_allocated_bytes"] = {"before": mem0, "after": mem1,
                                     "added": mem1 - mem0}
    servers = {"default": primary, "challenger": challenger}
    factors = {vid: served_factors(s) for vid, s in servers.items()}
    check(not np.array_equal(factors["default"][1], factors["challenger"][1]),
          "the two variants serve the same factors")
    rng = np.random.default_rng(SEED + 16)
    rows = rng.choice(n_users, size=2 * n_burst + n_forced + 2 * n_patch
                      + n_retired, replace=False)
    ab = ab_queries(rows[:n_burst])
    forced = ab_queries(rows[n_burst:n_burst + n_forced])
    mid = ab_queries(rows[n_burst + n_forced:2 * n_burst + n_forced])
    rest = rows[2 * n_burst + n_forced:]
    patch_rows, still_rows = rest[:n_patch], rest[n_patch:2 * n_patch]
    retired_q = ab_queries(rest[2 * n_patch:])
    with serve(primary, "127.0.0.1", 0) as front:
        url = f"http://127.0.0.1:{front.port}"
        d0 = {vid: pipeline_dispatches(s) for vid, s in servers.items()}
        reset_launches()
        answers, span = burst(url + "/queries.json", ab, procs, threads,
                              provenance=True)
        launches = dict(kernels.LAUNCHES)
        dispatches = {vid: pipeline_dispatches(s) - d0[vid]
                      for vid, s in servers.items()}
        routed = {vid: 0 for vid in servers}
        for q, (body, _wall, prov) in zip(ab, answers):
            want = bucket_for(q["user"], AB_WEIGHTS)
            check(prov["variantId"] == want,
                  f"{q['user']} answered by {prov['variantId']}, the hash "
                  f"names {want}")
            host_check(body, q, *factors[want])
            routed[want] += 1
        check(all(dispatches[v] > 0 for v in servers)
              and launches["topk_rows"] == sum(dispatches.values()),
              f"topk_rows launches {launches['topk_rows']} against the "
              f"variants' pipeline dispatches {dispatches}")
        walls = np.array([w for _, w, _ in answers]) * 1e3
        out.update({
            "ab_queries": len(ab), "ab_routed": routed,
            "ab_qps": n_burst / span,
            "ab_p50_ms": float(np.percentile(walls, 50)),
            "ab_p99_ms": float(np.percentile(walls, 99)),
            "topk_rows_launches_by_variant": dispatches,
            "topk_rows_launches": launches["topk_rows"]})
        for vid in servers:
            for q in forced:
                status, body, hdrs, _ = post_full(url, q,
                                                  {VARIANT_HEADER: vid})
                prov = json.loads(hdrs["X-PIO-Provenance"])
                check(status == 200 and prov["variantId"] == vid,
                      f"a query forced to {vid}: {status} {prov}")
                host_check(body, q, *factors[vid])
        status, _ = post_status(url + "/variants/ghost/weight",
                                {"weight": 1.0})
        check(status == 404, f"an unknown variant's weight answered {status}")
        status, body = post_status(url + "/capture/stop", {})
        check(status == 200, f"/capture/stop answered {status} {body}")
        records = list(iter_capture(cap_dir))
        check(len(records) == n_burst + 2 * n_forced,
              f"{len(records)} captured records")
        t0 = time.perf_counter()
        rep = replay_records(records, target=url)
        out["replay_s"] = time.perf_counter() - t0
        out["replay"] = {vid: r["tiers"]["bitwise"]
                         for vid, r in rep["variants"].items()}
        check(set(rep["variants"]) == set(servers)
              and all(r["parityPct"] == 100.0
                      for r in rep["variants"].values()),
              f"the A/B replay: {rep['variants']}")

        # the challenger promoted while a burst runs: once a third of it
        # is answered
        served0 = sum(s.request_count for s in servers.values())
        t, res = on_thread(lambda: burst(url + "/queries.json", mid, procs,
                                         threads, provenance=True))
        poll_until(lambda: sum(s.request_count for s in servers.values())
                   - served0 >= len(mid) // 3, 60)
        status, body = post_status(url + "/variants/challenger/promote", {})
        check(status == 200 and body["previousLive"] == "default",
              f"the promote answered {status} {body}")
        t.join(300)
        check(bool(res), "the burst across the promote failed (an answer "
                         "other than 200)")
        by_old = by_new = 0
        for q, (body, _wall, prov) in zip(mid, res[0][0]):
            vid = prov["variantId"]
            old = bucket_for(q["user"], AB_WEIGHTS)
            new = bucket_for(q["user"], AB_PROMOTED)
            check(vid in (old, new), f"{q['user']} answered by {vid}")
            host_check(body, q, *factors[vid])
            if old != new:
                by_old += vid == old
                by_new += vid == new
        out["promote_burst"] = {"queries": len(mid), "by_old_weights": by_old,
                                "by_new_weights": by_new}
        check(by_old > 0 and by_new > 0,
              f"the promote did not land inside the burst: {by_old} answers "
              f"by the old weights, {by_new} by the new")

        # a delta to the challenger alone
        probe = ab_queries(np.concatenate([patch_rows, still_rows]))

        def forced_answers(vid):
            return [post_full(url, q, {VARIANT_HEADER: vid})[1]
                    for q in probe]

        before = {vid: forced_answers(vid) for vid in servers}
        vecs = (rng.standard_normal((n_patch, rank)) / np.sqrt(rank)
                ).astype(np.float32)
        patch = {f"u{int(r)}": v.tolist() for r, v in zip(patch_rows, vecs)}
        status, body = post_status(url + "/reload/delta",
                                   {"users": patch, "variant": "challenger"})
        check(status == 200 and body["variant"] == "challenger"
              and body["appliedCount"] == n_patch,
              f"the challenger's delta answered {status} {body}")
        after = {vid: forced_answers(vid) for vid in servers}
        check(after["default"] == before["default"],
              "the delta to the challenger moved the default's answers")
        check(after["challenger"][n_patch:] == before["challenger"][n_patch:],
              "the delta moved the challenger's answers of unpatched users")
        cu, ci = served_factors(challenger)
        for q, b, a in zip(probe[:n_patch], before["challenger"],
                           after["challenger"]):
            check(a != b, f"the delta did not move {q['user']}'s answer")
            host_check(a, q, cu, ci)
        check(challenger.patch_epoch == 1 and primary.patch_epoch == 0,
              f"patch epochs {challenger.patch_epoch}, {primary.patch_epoch}")
        factors["challenger"] = (cu, ci)

        # the old champion retired
        status, body = post_status(url + "/variants/default/retire", {})
        check(status == 200 and body["state"] == "retired",
              f"the retire answered {status} {body}")
        answers, _ = burst(url + "/queries.json", retired_q, procs, threads,
                           provenance=True)
        for q, (body, _wall, prov) in zip(retired_q, answers):
            check(prov["variantId"] == "challenger",
                  f"a hashed query reached {prov['variantId']} after the "
                  f"retire")
            host_check(body, q, *factors["challenger"])
        for q in forced[:4]:
            status, body, hdrs, _ = post_full(url, q,
                                              {VARIANT_HEADER: "default"})
            check(status == 200 and json.loads(hdrs["X-PIO-Provenance"])
                  ["variantId"] == "default",
                  f"a forced query to the retired variant answered {status}")
            host_check(body, q, *factors["default"])
        stats = get_json(url + "/stats.json")
        health = get_json(url + "/health.json")
        check(set(health["variants"]) == set(servers)
              and health["variants"]["default"]["state"] == "retired",
              f"/health.json variants {health.get('variants')}")
        out["ledger"] = {k: v["bytes"] for k, v in
                         stats["device"]["components"].items()}
        out["variants"] = {v["variantId"]: {k: v[k] for k in (
            "state", "weight", "trafficShare", "routed")}
            for v in stats["variants"]["variants"]}
        out["requests_by_variant"] = {
            vid: stats["variants"]["byVariant"][vid]["requestCount"]
            for vid in servers}
    check(all(s.draining and s.health()["drain"]["complete"]
              for s in servers.values()),
          "closing the front end did not drain every variant")
    return out


def phase_variants_cli(dev, home: str, *, n_queries=32) -> dict:
    """16b: on phase 9's store, the recommendation template trained again
    under another ``variantId`` (another seed), ``pio deploy`` of phase
    9's engine, ``pio deploy --variant-of`` of the second, ``pio variant
    weight`` to 0.5/0.5 and ``list``: every answer from the variant the
    hash names, equal to its stored blob's host top-N; then ``pio variant
    promote`` and ``retire``: every answer from the second."""
    out: dict = {}
    os.environ["PIO_HOME"] = home
    Storage = pio_storage.Storage
    Storage.reset()
    engine_dir = os.path.join(home, "engine")
    engine_b = os.path.join(home, "engine-b")
    os.makedirs(engine_b, exist_ok=True)
    with open(os.path.join(engine_dir, "engine.json")) as fh:
        variant = json.load(fh)
    variant["variantId"] = "als-b"
    variant["algorithms"][0]["params"]["seed"] = SEED + 161
    with open(os.path.join(engine_b, "engine.json"), "w") as fh:
        json.dump(variant, fh)
    t0 = time.perf_counter()
    pio_ok(["train", "--engine-dir", engine_b])
    out["train_s"] = time.perf_counter() - t0
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    reset_launches()
    deploy, deploy_result = pio_thread([
        "deploy", "--engine-dir", engine_dir, "--ip", "127.0.0.1",
        "--port", port])
    try:
        wait_answer(base + "/", deploy, deploy_result)
        t0 = time.perf_counter()
        text = pio_ok(["deploy", "--engine-dir", engine_b, "--ip",
                       "127.0.0.1", "--variant-of", port, "--weight", "0.5"])
        out["variant_of_s"] = time.perf_counter() - t0
        check("Registered variant 'als-b'" in text,
              f"pio deploy --variant-of said {text!r}")
        pio_ok(["variant", "weight", "default", "0.5", "--url", base])
        text = pio_ok(["variant", "list", "--url", base])
        check("2 variant(s)" in text and "share=50.0%" in text,
              f"pio variant list said {text!r}")
        weights = {"default": 0.5, "als-b": 0.5}
        models = {v["variantId"]: stored_model(v["engineInstanceId"])
                  for v in get_json(base + "/variants.json")["variants"]}
        check(set(models) == set(weights), f"variants {sorted(models)}")
        names = models["default"].user_ids.inverse_array()
        rng = np.random.default_rng(SEED + 162)

        def ask(vid_ok) -> dict:
            seen: dict = {}
            for j in range(n_queries):
                q = {"user": str(names[int(rng.integers(0, len(names)))]),
                     "num": (1, 4, 10, 20)[j % 4]}
                status, body, hdrs, _ = post_full(base, q)
                vid = json.loads(hdrs["X-PIO-Provenance"])["variantId"]
                check(status == 200 and vid_ok(q, vid),
                      f"16b: {q['user']} answered {status} by {vid}")
                stored_check(body, q, models[vid])
                seen[vid] = seen.get(vid, 0) + 1
            return seen

        out["split"] = ask(lambda q, vid: vid == bucket_for(q["user"],
                                                             weights))
        check(len(out["split"]) == 2, f"16b answers came from {out['split']}")
        text = pio_ok(["variant", "promote", "als-b", "--url", base])
        check("Promoted 'als-b'" in text, f"pio variant promote said {text!r}")
        pio_ok(["variant", "retire", "default", "--url", base])
        out["after_retire"] = ask(lambda q, vid: vid == "als-b")
        out["topk_rows_launches"] = kernels.LAUNCHES["topk_rows"]
        check(out["topk_rows_launches"] > 0,
              f"16b never launched topk_rows: {kernels.LAUNCHES}")
        pio_ok(["undeploy", "--port", port])
        deploy.join(60)
        check(not deploy.is_alive() and deploy_result == [0],
              f"undeploy did not end the server: {deploy_result}")
    finally:
        if deploy.is_alive():
            pio(["undeploy", "--port", port])
            deploy.join(60)
        Storage.reset()
    return out


def phase_feedback(dev, home: str, *, n_queries=64, n_down=16,
                   n_faults=4) -> dict:
    """16c: the port's event server (``EventServing``, what ``pio
    eventserver`` runs; in this process, so it can be stopped and started
    again), then ``pio deploy --feedback --event-server-url --accesskey``
    of phase 9's engine (the breaker's reset cut to ``FEEDBACK_RESET_S``):
    ``n_queries`` answers give as many ``predict`` events in the store,
    their ``prId``s the answers'. The event server stopped: queries answer
    200 and the breaker opens after its 5 failures. Started again: the
    half-open probe closes it. ``server.feedback`` armed as an error:
    each failure counted, every answer 200."""
    out: dict = {}
    os.environ["PIO_HOME"] = home
    Storage = pio_storage.Storage
    Storage.reset()
    engine_dir = os.path.join(home, "engine")
    text = pio_ok(["app", "new", "chipfeedback"])
    key = text.split("Access key: ")[1].split()[0]
    eport, port = free_port(), free_port()
    ebase, base = f"http://127.0.0.1:{eport}", f"http://127.0.0.1:{port}"
    events = EventServing("127.0.0.1", eport)
    defaults = feedback_mod.FeedbackPublisher.__init__.__kwdefaults__
    reset_s = defaults["breaker_reset_s"]
    defaults["breaker_reset_s"] = FEEDBACK_RESET_S
    deploy, deploy_result = pio_thread([
        "deploy", "--engine-dir", engine_dir, "--ip", "127.0.0.1",
        "--port", port, "--feedback", "--event-server-url", ebase,
        # one argument: a generated key may begin with "-"
        f"--accesskey={key}"])
    try:
        iid = wait_answer(base + "/", deploy, deploy_result)[
            "engineInstanceId"]
        model = stored_model(iid)
        names = model.user_ids.inverse_array()
        rng = np.random.default_rng(SEED + 163)

        def ask() -> dict:
            q = {"user": str(names[int(rng.integers(0, len(names)))]),
                 "num": 4}
            status, body, _, _ = post_full(base, q)
            check(status == 200 and body.get("prId"),
                  f"a 16c query answered {status} {body}")
            stored_check({"itemScores": body["itemScores"]}, q, model)
            return body

        def fb() -> dict:
            return get_json(base + "/stats.json")["feedback"]

        t0 = time.perf_counter()
        pr_ids = {ask()["prId"] for _ in range(n_queries)}
        check(poll_until(lambda: fb()["sent"] == n_queries, 60),
              f"feedback sent {fb()} of {n_queries}")
        out["publish_s"] = time.perf_counter() - t0
        stored = list(EventStore().find(app_name="chipfeedback",
                                        event_names=["predict"]))
        check(len(stored) == n_queries
              and {e.pr_id for e in stored} == pr_ids
              and all(e.entity_type == "pio_pr" for e in stored),
              f"the store holds {len(stored)} predict events for "
              f"{n_queries} answers")
        out["stored_predict_events"] = len(stored)

        events.close()
        for _ in range(n_down):
            ask()
        check(poll_until(lambda: fb()["breakerState"] == "open", 30),
              f"the breaker did not open: {fb()}")
        down = fb()
        check(down["failed"] >= 5 and down["breakerOpens"] == 1,
              f"the breaker opened after {down['failed']} failures")
        out["event_server_down"] = down
        t0 = time.perf_counter()
        events = EventServing("127.0.0.1", eport)
        time.sleep(FEEDBACK_RESET_S)
        check(poll_until(lambda: bool(ask())
                         and fb()["breakerState"] == "closed", 30),
              f"the half-open probe did not close the breaker: {fb()}")
        out["restart_to_closed_s"] = time.perf_counter() - t0
        out["event_server_back"] = fb()

        before = fb()["failed"]
        FAULTS.inject("server.feedback", "error", times=n_faults)
        for _ in range(n_faults):
            ask()
        check(poll_until(lambda: FAULTS.fired("server.feedback") == n_faults
                         and fb()["failed"] - before >= n_faults, 30),
              f"server.feedback fired {FAULTS.fired('server.feedback')}, "
              f"failures {fb()['failed'] - before}")
        out["fault_failures"] = fb()["failed"] - before
        out["feedback"] = fb()
        pio_ok(["undeploy", "--port", port])
        deploy.join(60)
        check(not deploy.is_alive() and deploy_result == [0],
              f"undeploy did not end the server: {deploy_result}")
    finally:
        defaults["breaker_reset_s"] = reset_s
        FAULTS.clear()
        if deploy.is_alive():
            pio(["undeploy", "--port", port])
            deploy.join(60)
        events.close()
        Storage.reset()
    return out


def phase_prewarm_async(dev, home: str) -> dict:
    """16d: ``pio deploy --prewarm-async`` of phase 9's engine, the launch
    counts set to 0 first: the first ``/health.json`` seen, the seconds
    from it to ``ready``; every query answered while ``prewarming`` is the
    stored blob's host top-N; once ready the retriever has launched
    ``topk`` once per point of the lattice (b_pad 8, 16, ..., 128) and
    answers name an ``execCacheKey``."""
    out: dict = {}
    os.environ["PIO_HOME"] = home
    Storage = pio_storage.Storage
    Storage.reset()
    engine_dir = os.path.join(home, "engine")
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    reset_launches()
    t0 = time.perf_counter()
    deploy, deploy_result = pio_thread([
        "deploy", "--engine-dir", engine_dir, "--ip", "127.0.0.1",
        "--port", port, "--prewarm-async"])
    try:
        first = wait_answer(base + "/health.json", deploy, deploy_result)
        t_bind = time.perf_counter()
        out["deploy_to_bind_s"] = t_bind - t0
        out["first_health"] = {k: first[k] for k in (
            "status", "live", "ready", "prewarming", "variant")}
        model = stored_model(first["engineInstanceId"])
        names = model.user_ids.inverse_array()
        rng = np.random.default_rng(SEED + 164)
        during = 0
        while True:
            h0 = get_json(base + "/health.json")
            if h0["ready"]:
                break
            q = {"user": str(names[int(rng.integers(0, len(names)))]),
                 "num": 10}
            status, body, _, _ = post_full(base, q)
            check(status == 200, f"a query while prewarming answered {status}")
            stored_check(body, q, model)
            during += get_json(base + "/health.json")["prewarming"]
            check(time.perf_counter() - t_bind < 300, "never ready")
        out["bind_to_ready_s"] = time.perf_counter() - t_bind
        out["answered_while_prewarming"] = during
        lattice = [8, 16, 32, 64, 128]  # batch 1 pads to 8
        check(kernels.LAUNCHES["topk"] == len(lattice),
              f"the retriever's prewarm launched topk "
              f"{kernels.LAUNCHES['topk']} times for a lattice of "
              f"{len(lattice)}")
        q = {"user": str(names[0]), "num": 10}
        status, body, hdrs, _ = post_full(base, q)
        check(status == 200 and json.loads(hdrs["X-PIO-Provenance"])
              ["execCacheKey"], "an answer after ready names no execCacheKey")
        stored_check(body, q, model)
        out["launches"] = {k: kernels.LAUNCHES[k]
                           for k in ("topk", "topk_rows")}
        pio_ok(["undeploy", "--port", port])
        deploy.join(60)
        check(not deploy.is_alive() and deploy_result == [0],
              f"undeploy did not end the server: {deploy_result}")
    finally:
        if deploy.is_alive():
            pio(["undeploy", "--port", port])
            deploy.join(60)
        Storage.reset()
    return out


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

    # every engine server's flight incident dumps (and those of the `pio`
    # subprocesses) go to a directory of this run
    os.environ["PIO_FLIGHT_DIR"] = tempfile.mkdtemp(prefix="pio-chip-flight-")
    FLIGHT.configure(dump_dir=os.environ["PIO_FLIGHT_DIR"])

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

    attn = phase_attention(dev, ATTN_CASES + HEAD_DIM_CASES
                           + WIDE_TIMED_CASES)
    # the wide head dims through the dispatch, counted from zero
    reset_launches()
    attn += phase_attention(dev, WIDE_HEAD_DIM_CASES, timing=False)
    wide_fwd_launches = kernels.LAUNCHES["flash_attention_wide"]
    check(wide_fwd_launches == 2 * len(WIDE_HEAD_DIM_CASES),
          f"the wide forward launched {wide_fwd_launches} times for "
          f"{len(WIDE_HEAD_DIM_CASES)} wide head-dim cases run twice")
    print("[attention-wide-plan] " + json.dumps(wide_plans()) + f" | {smi}",
          flush=True)
    # the huge head dims through the dispatch, counted from zero (each
    # case runs the forward three times: twice bitwise, once with the
    # logsumexp), then timed
    reset_launches()
    huge_fwd_cases = HUGE_HEAD_DIM_CASES + HUGE_FWD_BANDED_CASES
    attn += phase_attention(dev, huge_fwd_cases, timing=False)
    huge_fwd_launches = kernels.LAUNCHES["flash_attention_huge"]
    check(huge_fwd_launches == 3 * len(huge_fwd_cases),
          f"the huge forward launched {huge_fwd_launches} times for "
          f"{len(huge_fwd_cases)} huge head-dim cases run three times")
    attn += phase_attention(dev, HUGE_TIMED_CASES)
    wt = {r["case"]: r for r in attn}
    for tag, cases in (("wide", WIDE_TIMED_CASES),
                       ("huge", HUGE_TIMED_CASES)):
        print(f"[attention-{tag}] " + json.dumps({
            r[0]: {**{key: wt[r[0]][key] for key in (
                "ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
                "library_backend", "max_abs_err")},
                "share_of_bound": wt[r[0]]["bound_ms"] / wt[r[0]]["ms"]}
            for r in cases}) + f" | {smi}", flush=True)
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

    bwd = phase_attention_bwd(dev, BWD_CASES, HEAD_DIM_CASES)
    # the wide head dims through the autograd dispatch, counted from zero
    reset_launches()
    bwd += phase_attention_bwd(dev, [], WIDE_BWD_HEAD_DIM_CASES)
    wide_bwd_launches = dict(kernels.LAUNCHES)
    check(all(wide_bwd_launches[f"flash_attention_wide{key}"] > 0
              for key in ("", "_bwd_dkv", "_bwd_dq")),
          f"a wide kernel never launched through the autograd dispatch: "
          f"{wide_bwd_launches}")
    # the huge head dims through the autograd dispatch, counted from zero
    reset_launches()
    bwd += phase_attention_bwd(dev, [], HUGE_HEAD_DIM_CASES)
    huge_bwd_launches = dict(kernels.LAUNCHES)
    # a fixture runs a training step (forward, dK/dV, dQ) and a serving
    # forward
    n = len(HUGE_HEAD_DIM_CASES)
    check([huge_bwd_launches[f"flash_attention_huge{key}"]
           for key in ("", "_bwd_dkv", "_bwd_dq")] == [2 * n, n, n],
          f"the huge kernels did not launch once a fixture through the "
          f"autograd dispatch (the forward twice): {huge_bwd_launches}")
    huge_plan = huge_plans()
    check(all(huge_plan[f"B1 L8192 H1 D1152 float32 dkv {m}"]["bands"] >= 2
              for m in ("causal", "full")),
          "the banded fixture's dK/dV took one workspace band")
    check(huge_plan["B1 L8192 H1 D1152 bfloat16 fwd causal"]["bands"] == 2,
          "the banded bf16 forward fixture did not take two workspace "
          "bands")
    print("[attention-huge-plan] " + json.dumps(huge_plan) + f" | {smi}",
          flush=True)
    wb = {r["case"]: r for r in bwd if "dkv_ms" in r}
    for tag, cases in (("wide", WIDE_TIMED_CASES),
                       ("huge", HUGE_TIMED_CASES)):
        print(f"[attention-{tag}-bwd] " + json.dumps({
            r[0]: {**{key: wb[r[0]][key] for key in (
                "dkv_ms", "dq_ms", "dkv_bound_ms", "dq_bound_ms",
                "plain_ms", "library_ms", "library_backend",
                "repeat_bitwise", "dq_rel_err", "dk_rel_err",
                "dv_rel_err")},
                **{f"{key}_share_of_bound": wb[r[0]][f"{key}_bound_ms"]
                   / wb[r[0]][f"{key}_ms"] for key in ("dkv", "dq")}}
            for r in cases}) + f" | {smi}", flush=True)
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

    # evaluation through the port's `pio eval`, each fold trained on the
    # card; the served movielens winner counted from zero
    # (phase_evaluation resets the launch counts before it deploys)
    ev = phase_evaluation(dev, qs)
    print("[eval] stage seconds: " + json.dumps({
        "import (phase 9's)": ev["import_s"], "read_eval": ev["read_eval_s"],
        "fold_train_mean": ev["fold_train_mean_s"],
        "fold_train_max": ev["fold_train_max_s"],
        "host_scoring": ev["host_scoring_s"], "metrics": ev["metrics_s"],
        "pio_eval": ev["eval_s"], "pio_eval_fast": ev["eval_fast_s"],
        "cpu_retrain": ev["cpu_retrain_s"],
        "card_vs_cpu": ev["card_vs_cpu_s"],
        "movielens_walkthrough": ev["ml_walkthrough_s"]})
        + f" | leaderboard {ev['leaderboard'][1:]} | FastEval hits "
        f"{ev['fast_eval_hits']} | fold rule {json.dumps(ev['fold_rule'])}, "
        f"lists beyond a near-tie "
        f"{[r['beyond_tie'] for r in ev['card_vs_cpu']]} | {smi}",
        flush=True)
    print("[eval] " + json.dumps({**ev, "card": smi}), flush=True)
    clock.lap("10 evaluation")

    # tuning: the grid at the north-star shape against serial training,
    # then `pio tune` on phase 10's store; the served winner counted from
    # zero (phase_tune resets the launch counts before it deploys)
    grid = phase_tune_grid(dev)
    print("[tune-grid] " + json.dumps({**grid, "card": smi}), flush=True)
    clock.lap("11a tuning grid")
    tune = phase_tune(dev, ev)
    print("[tune] stage seconds: " + json.dumps({
        "pio_tune": tune["tune_s"], "read_eval": tune["read_eval_s"],
        "grid_train": tune["grid_s"], "scoring": tune["scoring_s"],
        "winner_train": tune["winner_train_s"],
        "held_pio_tune": tune["held_tune_s"]})
        + f" | ML-20M grid step {grid['grid_step_median_s']:.4f} s against "
        f"the serial steps' sum {grid['serial_step_sum_median_s']:.4f} s "
        f"(ratio {grid['grid_over_serial_step']:.3f}), peak "
        f"{grid.get('grid_run1_peak_gib', 0):.2f} GiB | {smi}", flush=True)
    print("[tune] " + json.dumps({**tune, "card": smi}), flush=True)
    clock.lap("11b pio tune")

    # resilience: phase 3's server degraded by hung dispatches and served
    # off the batcher (topk_rows counted per answer), deadlines, then
    # phase 9's `pio deploy` drained by SIGTERM
    torch.cuda.empty_cache()
    res = phase_resilience_server(dev)
    torch.cuda.empty_cache()
    res_drain = phase_resilience_drain(dev, qs["home"])
    counts = dict(res["codes"])
    for block in (res_drain["burst"], res_drain["drain_burst"]):
        for code, n in block.items():
            counts[code] = counts.get(code, 0) + n
    print("[resilience] " + json.dumps({
        "fallback_p50_ms": res["fallback_p50_ms"],
        "trip_to_degraded_s": res["trip_to_degraded_s"],
        "probe_to_ok_s": res["probe_to_ok_s"],
        "drain_s": res_drain["drain_s"],
        "429": counts.get("429", 0), "503": counts.get("503", 0),
        "504": counts.get("504", 0)}) + f" | {smi}", flush=True)
    print("[resilience] " + json.dumps({**res, **res_drain, "card": smi}),
          flush=True)
    clock.lap("12 resilience")

    # streaming fold-in: the device solve at full width, then events to
    # personalized answers through `pio eventserver --journal-dir`, `pio
    # stream` and `pio deploy` (phase_stream resets the launch counts
    # before it deploys)
    torch.cuda.empty_cache()
    fold = phase_fold_in(dev)
    print("[fold-in] " + json.dumps({**fold, "card": smi}), flush=True)
    clock.lap("13a device fold-in")
    stream = phase_stream(dev, qs["home"])
    print("[stream] " + json.dumps({
        "ack_to_first_personalized_s": stream["ack_to_first_personalized_s"],
        "ack_to_all_personalized_s": stream["ack_to_all_personalized_s"],
        "topk_rows_launches": stream["launches"]["topk_rows"],
        "patched_after_reload": stream["patched_after_reload"]})
        + f" | {smi}", flush=True)
    print("[stream] " + json.dumps({**stream, "card": smi}), flush=True)
    clock.lap("13b streaming fold-in")

    # similarity serving: the similarproduct engine over the ML-20M catalog
    # over HTTP, counted from zero (phase_similar_serving resets the launch
    # counts before it deploys)
    torch.cuda.empty_cache()
    similar = phase_similar_serving(dev)
    print("[similar] " + json.dumps({
        key: similar[key] for key in (
            "single_p50_ms", "single_p99_ms", "burst_qps", "burst_p50_ms",
            "burst_p99_ms", "device_busy_share")}
        | {"topk_launches": similar["launches"]["topk"]}) + f" | {smi}",
        flush=True)
    print("[similar] " + json.dumps({**similar, "card": smi}), flush=True)
    clock.lap("14a similarity serving")
    # the four ALS templates through `pio`, each deployed server counted
    # from zero (deployed_template resets the launch counts before it
    # deploys)
    tmpl = phase_als_templates(dev)
    print("[templates] stage seconds: " + json.dumps({
        "events": tmpl["events_s"], "import": tmpl["import_s"],
        **{f"{name}_{stage}": tmpl[name][f"{stage}_s"]
           for name in ("similarproduct", "ecommercerecommendation",
                        "filterbycategory", "customdatasource")
           for stage in ("train", "deploy", "queries", "stage")},
        "constraint_effect": tmpl["ecommercerecommendation"]
        ["constraint_effect_s"]}) + " | topk launches " + json.dumps({
            name: tmpl[name]["launches"]["topk"] for name in (
                "similarproduct", "ecommercerecommendation",
                "filterbycategory", "customdatasource")}) + f" | {smi}",
        flush=True)
    print("[templates] " + json.dumps({**tmpl, "card": smi}), flush=True)
    clock.lap("14b ALS templates through pio")

    # the engine server's instrumentation and golden traffic: phase 3's
    # catalog served with waterfalls, capture and a 512-record flight ring
    # (the launch counts set to 0 before its traffic), then the profiler,
    # replay on the same and on a legacy server, the delta plane's diff and
    # the shadow mirror, then the verbs against phase 9's engine
    torch.cuda.empty_cache()
    wf, wf_server, wf_front, cap_dir = phase_waterfalls(dev)
    wf_url = f"http://127.0.0.1:{wf_front.port}"
    print("[waterfall] burst stage ms (p50/p99): " + json.dumps({
        s: [round(v["p50"], 4), round(v["p99"], 4)]
        for s, v in wf["burst_stage_ms"].items()}) + " | " + json.dumps({
            key: wf[key] for key in (
                "hostShare", "deviceShare", "topk_rows_launches",
                "qps_instrumented", "qps_uninstrumented",
                "p50_ms_instrumented", "p50_ms_uninstrumented")})
        + f" | {smi}", flush=True)
    print("[waterfall] " + json.dumps({**wf, "card": smi}), flush=True)
    clock.lap("15a waterfalls")
    prof = phase_profile(dev, wf_server, wf_url)
    print("[profile] " + json.dumps({**prof, "card": smi}), flush=True)
    clock.lap("15b profiler")
    capr = phase_capture_replay(dev, wf_server, wf_front, wf_url, cap_dir)
    wf_front.close()
    print("[capture] " + json.dumps({**capr, "card": smi}), flush=True)
    clock.lap("15c capture, replay, shadow")
    verbs = phase_verbs(dev, qs["home"])
    print("[verbs] " + json.dumps({**verbs, "card": smi}), flush=True)
    clock.lap("15d verbs")

    # variants: phase 3's catalog and a challenger co-hosted at 0.8/0.2
    # (the launch counts set to 0 before the A/B burst, each variant's
    # topk_rows launches read from its own pipeline), then variants, the
    # feedback loop and --prewarm-async through `pio` on phase 9's store
    del wf_server
    torch.cuda.empty_cache()
    ab = phase_variants(dev)
    print("[variants] " + json.dumps({
        key: ab[key] for key in (
            "ab_qps", "ab_p50_ms", "ab_p99_ms", "ab_routed",
            "topk_rows_launches_by_variant", "memory_allocated_bytes",
            "promote_burst", "replay")}
        | {"phase3_qps": serving["qps_concurrent"]}) + f" | {smi}",
        flush=True)
    print("[variants] " + json.dumps({**ab, "card": smi}), flush=True)
    clock.lap("16a variants co-hosted")
    vcli = phase_variants_cli(dev, qs["home"])
    print("[variants-cli] " + json.dumps({**vcli, "card": smi}), flush=True)
    clock.lap("16b variants through pio")
    fb = phase_feedback(dev, qs["home"])
    print("[feedback] " + json.dumps({**fb, "card": smi}), flush=True)
    clock.lap("16c feedback")
    pw = phase_prewarm_async(dev, qs["home"])
    print("[prewarm-async] " + json.dumps({**pw, "card": smi}), flush=True)
    clock.lap("16d prewarm-async")

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
        # no TPU kernel: the wide head dims' path is the dispatch itself
        # (phase 4's and 6a's wide head-dim cases, counted from zero)
        *wide_records(wide_fwd_launches, wide_bwd_launches,
                      by_attn[WIDE_TIMED_CASE], wb[WIDE_TIMED_CASE]),
        # no TPU kernel either: head dims above 1,024 (phase 4's and 6a's
        # huge cases through the dispatch, counted from zero)
        *wide_records(huge_fwd_launches, huge_bwd_launches,
                      by_attn[HUGE_TIMED_CASE], wb[HUGE_TIMED_CASE],
                      route="huge", source=HUGE_SOURCE,
                      fwd_source=HUGE_SOURCE),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
