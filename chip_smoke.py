#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure raises, prints no result and exits non-zero):

1. Device and build: the card's name and power limit, then every CUDA
   kernel of ``src/repro_torch/kernels/csrc`` built with nvcc (one process
   per source, started together; phase 9, which reaches no kernel, runs
   on the card meanwhile, then the one-rank whole runs of phases 12-16
   and 18, which reach no kernel either, in a process of their own, joined
   before phase 2), the build's wall seconds, each source's nvcc seconds
   and its ptxas registers and spills.
2. Kernel vs plain version on the card.  Fig. 1's kernels: row norms
   (pass 1), the fused clip -> Bucketing -> CM/TM pass (bucketed s = 2
   and unbucketed, CM and TM(0.1), clip on and off) and the standalone
   masked CM/TM, at the Fig. 1 shape (n=20, d=40), an odd-n bucket-padding
   shape (n=21) and a ragged wide server-step shape (n=20, d=2^24+37,
   1.3 GB in f32), the medians also with every row kept and with 4 rows
   kept (``select_masks``).  Tolerances: the coordinate median exactly
   when kernel and plain version get the same clip factors; sums f32 rtol
   1e-5.  The standalone CM is timed under the three masks, each against
   the bytes of the rows its mask keeps (``bound_all_rows_ms`` beside it:
   every row), and pass 2 at s = 1 under the 4-row mask;
   pass 2 at s = 2 and the bucketed median keep bounds over every row,
   since a masked row in a bucket with a kept row is read.  An operations
   term counts the comparisons any selection needs (``_select_ops``).
   Fig. 2's Weiszfeld geometric-median kernels (gm_resident, diff_row_ssq,
   bucket_means, gm_update) and the whole clip_then_geometric_median,
   each against its plain version at rtol 1e-5: at the Fig. 2 shape
   (n=20, d=698, s = 1 and 2), odd n (n=21, s = 2 and 3), the largest d
   the resident rule admits at n=20 and one past it (both sides of the
   dispatch), and the wide shape (s = 1 and 2, clipped); random masks and
   an all-masked case (result 0).  At the wide shape: each kernel's time,
   its bound, the plain version's time and one library call's time
   (bucket_means: B @ x with B the (n/2, n) bucket-mean
   weights; gm_update: (w / wsum) @ x; diff_row_ssq: torch.cdist);
   gm_resident is timed at the Fig. 2 shape, the largest it takes on the
   path, and at the largest its rule admits (n=20, s = 2), each also with
   no step (``iters0_ms``: the launch, staging, z0 and write-out), beside
   the launch floor (``floor_ms``: back-to-back one-cycle spin kernels),
   which the bytes bound of a one-block iterative kernel cannot show.
   Krum's four kernels (gram_matrix, cross_gram, weighted_row_sum,
   select_row) against their plain versions at the serve shape (n=16,
   d=4,096), an odd shape (n=17, d=4,097) and the wide shape (n=20,
   d=2^24+37), with random masks as weights, an inf in a zero-weight row,
   scale 0, winner indices out of range and bf16: the Gram and cross-Gram
   to rtol 1e-5 of each entry's scale sqrt(G_ii G_jj), the row-sum to
   rtol 1e-5, select_row exactly; and bit for bit G == G^T and
   cross_gram(x, x) == gram_matrix(x) at all three shapes, and at the
   shapes of GRAM_EDGES: rows 1-3 values off a 16-byte boundary (d = 1, 2,
   3 mod 4 in f32, odd d in bf16), tiny d (1-33), n in {1, 4, 5, 20, 128},
   many steps of misaligned rows (d = 2^20+3) and matrices whose last row
   ends at the end of their allocation.  The Gram's f32
   arithmetic is held against a float64 Gram of the same inputs, each
   entry within GRAM_F32_K * 2^-24 * sqrt(D) * (sqrt(sum_k a_ik^2 b_jk^2)
   + |G_ij|), D the most roundings a product passes through in the
   kernel's sum (``gram_rounding_depth``): the f32 summation error of
   sums of random-sign and of same-sign terms.  On f32 inputs the same
   limit must reject two stand-ins, the float64 Gram of the operands
   rounded to TF32 and to bf16, or the check fails as too loose.  At the wide
   shape each is timed beside its bound, its plain version and one library
   call (x @ x.T, a @ b.T, w @ x, x[r] * scale with r a Python int; TF32
   off), the Gram kernels also at the serve shape (their rows' ``serve``);
   select_row at an aligned winner (r = 8) and a misaligned one
   (r = 10), in f32 and bf16, with an int32 winner as the engine's.  Then
   select_row and clipped_diff_scale at every alignment, exactly:
   select_row at the wide shape at winners whose rows start at every
   residue mod 4 (f32) and 8 (bf16) and at n = 20 with d in STREAM_DS
   (every winner, int32 and int64), clipped_diff_scale at the lengths of
   SCALE_LENS starting 0-7 values past an aligned start, f32 and bf16.
   CenteredClip's two kernels (cclip_resident, cclip_update) and the whole
   clip_then_centered_clip (tau = 10, 5 steps) against their plain versions
   at rtol 1e-5, atol 1e-6: at the Fig. 1 shape (n=20, d=40, s = 2 and 1),
   odd n (n=21, s = 2 and 3), the largest d its own shared-memory rule
   admits at n=20 and one past it, and the wide shape (s = 1 and 2,
   tiled); random masks and an all-masked case (result 0).  cclip_update
   is timed at the wide shape beside its library call (torch.addmv with
   the weights s_i f_i / den and beta = 1 - sum s_i / den, checked against
   the kernel first), cclip_resident at the Fig. 1 shape and at the
   largest it takes (with no step and the launch floor, as gm_resident),
   and the whole tiled call (s = 1, 2) with its
   launches.  The entry points: clipped_diff on one vector of 2^24+37
   values (f32 with a bool and a numeric keep mask, bf16, a 2-D shape):
   its norm to rtol 1e-6 and d and the output bit for bit given the same
   factor; bucketed_coordinate_median (an explicit permutation of the
   padded slots) bit for bit at the wide shape, in bf16 and with padded
   slots; then the entry-points run (one call of each, counted from 0)
   and their times (library: d * factor for the scale pass, in f32 and
   bf16; none for the others).
   Times: a kernel's and a library call's ``ms`` is its device time
   (``_device_ms``: after a warm-up, N back-to-back calls between one
   event pair, over N, the median of 5 windows of about 3 ms, the card
   held by a spin kernel while the host queues each window), and
   ``call_ms`` the median of single calls each between its own event
   pair (``_time_ms``, which counts the wrapper's host time while the card
   waits); plain versions keep the single-call timer.  select_row and
   clipped_diff_scale also give each wrapper's host enqueue time,
   ``enqueue_us``: a host clock over 300 calls with no synchronise.
3. Fig. 1: the paper's configuration (20 clients, 15 good, m=300, d=40,
   CM over Bucketing(2), shift-back, C=4, C_hat=20, p=0.2, gamma=0.5) on
   "cuda" with backend "auto", clipped and unclipped, 300 steps each, plus
   the clipped run with CM without Bucketing (the path of the standalone
   CM kernel).  Each run's launch counts, set to 0 just before it and
   read just after it, must equal the counts that run's own coins
   predict; the clipped run must converge (final loss < 0.64, within 1e-3
   of the optimum of the data) and the unclipped one diverge (> 5); the
   runs must agree with the plain PyTorch path on the CPU, which makes
   the same draws.  Then Algorithm 1 with compression and CenteredClip:
   fig1-randk-{40,20,5} (bench_ablation.py's RandK sweep, 400 steps, gap
   to the optimum below 1e-3, fixed from the port's CPU run),
   fig1-cclip (CenteredClip(10, 5) over Bucketing(2), 300 steps, the
   resident kernel, gap below 1e-3), fig1-theory (``from_theory`` with
   Theorem 4.2, CenteredClip and RandK k=10, 300 steps; the final loss
   below the first) and d30-randk-10 (test_compression_still_converges'
   problem and criterion: gap below 2e-2 after 400 steps); each within
   rtol 1e-4 of the CPU plain path, with its predicted launches and its
   wall ms per step.
4. Fig. 2: ``ClippedPPMomentum`` with RFA on the MLP problem, on "cuda"
   with backend "auto": fig2-rfa (the paper's Fig. 2 configuration,
   d = 698, 300 steps, the resident kernel), RFA without Bucketing on the
   majority cell (10 clients, 7 good, C = 3, gamma = 0.15) clipped and
   unclipped (300 steps each; clipped must end below 2.0 and unclipped
   above 20), and fig2-rfa-wide (the Fig. 2 configuration at MNIST's
   input width, d = 101,770, 50 steps, the tiled kernels).  Launch counts
   as in phase 3, each equal to its run's prediction; each run agrees
   with the CPU plain path at rtol 1e-4 (the unclipped run over its first
   100 steps).
5. Serving: ``AggregationServer`` on "cuda" with backend "auto" at the
   serve launcher's size (16 slots, the trailing 4 under ALIE, cohort
   12), driven by ``repro_torch.launch.serve.run_stream``:
   serve-krum-steady, serve-krum-burst (Krum, byz_bound 4, static radius
   5.0, one row or a cohort per pump), serve-multikrum-bucketed
   (multi-Krum over Bucketing(2), radius 5.0), serve-cm (CM, no clip),
   serve-cclip (CenteredClip, radius 5.0, the tiled kernels) at d = 4,096,
   8 rounds, and serve-krum-wide (d = 2^20, 4 rounds).  Every
   round's close must equal the one-shot ServerStep on the assembled
   buffer bit for bit, each run must agree with the same stream on the
   CPU plain path (rtol 1e-5, the same Krum winners and multi-Krum sets),
   end without executor faults or degraded rounds, and launch exactly
   what its own chunking predicts; a second, unchecked run of each
   gives rows per second and p50/p99 submit-to-resolution ms.
6. Scenarios, on "cuda" with backend "auto": adaptive-grad (the
   kernel-backed ``differentiable_aggregate`` against the plain shadow on
   the same inputs and Bucketing order at the Fig. 1 shape, CM over
   Bucketing(2) clipped, and the Fig. 2 shape, RFA over Bucketing(2)
   clipped: the forward within rtol 1e-5, the CM exactly equal to pass
   2's plain version given the kernel's factors, the gradient within rtol
   1e-5, finite and non-zero); adaptive-pin (the reference's pin,
   tests/test_scenarios.py: n = 12 with 4 byzantine, d = 8, budget 16,
   radius 0.5; mean unclipped deviates > 0.6, cm/rfa/centered_clip
   clipped < 0.3 and mean > 2.5 times each); adaptive-fig1-clipped,
   adaptive-fig1-unclipped and adaptive-fig2 (Fig. 1 and Fig. 2 under
   ``ScenarioSpec(attack="adaptive", budget=8)``, 300 steps: launches
   equal to each run's prediction, within rtol 1e-4 of the CPU plain
   path, wall ms per step and the adversary's share; no threshold on the
   Fig. 1 losses, since the port's CPU run shows no separation);
   matrix-smoke (SMOKE_GRID, 24 cells of 250 steps at d = 30, on the card
   and the CPU: every verdict and the breakdown map equal, every finite
   gap below 1 within rtol 1e-4 plus 4 f32 units of the loss (the gap
   subtracts two f32 losses near 0.5), cm.shb.clip and mean.shb.clip at 1.0,
   mean.gauss.* at 0.1, every noclip curve at or below 0.45, launches of
   each cell's own coins).
7. Faults, recovery and scoring, on "cuda" with backend "auto" at the
   serve launcher's size (16 slots, d = 4,096, cohort 12, the trailing 4
   under ALIE, static radius 5.0), the clock injected (0.1 s a pump):
   serve-chaos-krum (Krum behind a ``FaultInjector`` running
   ``canonical_fault_plan(seed=11)``, a 1.2 s deadline backstop, so that
   both triggers fire, 8 rounds: two card runs bitwise equal with equal
   ``FaultStats``; card and CPU plain path with equal ``FaultStats``,
   round ids, close reasons, fills and Krum winners, aggregates within
   rtol 1e-5; every aggregate finite); serve-crash (``FaultPlan(executor_crash=1.0)``: every round
   degraded with ``executor_error:InjectedFault``, ``executor_faults``
   equal to the rounds, the fallback within rtol 1e-5 of the CPU's);
   serve-snapshot-krum and serve-snapshot-cclip (Krum and CenteredClip
   parked mid-round, ``save_server`` and ``restore_server`` into a fresh
   card server, timed; the round finished on both, the closes bitwise
   equal); serve-resume-krum and serve-resume-cclip (``python -m
   repro_torch.launch.serve --mode stream`` as subprocesses on the card,
   which load the kernels phase 1 built: uninterrupted, and with a pump sleep SIGKILLed after 3 emitted
   rounds and restarted with ``--resume``; every round id carries one
   aggregate, bitwise the uninterrupted run's); score-krum (radius 5.0)
   and score-cm (no clip, the standalone CM kernel):
   ``make_scoring_step`` on B = 8 requests of 16 clients at d = 4,096
   with the trailing 4 at 100x, every output within rtol 1e-5 of the
   CPU, the same Krum winners, the trailing 4 flagged in every request
   and no other, ms a request from a second, warmed call.  The
   in-process runs' launches equal their predictions; wall seconds of
   each run and of the phase.
8. The mesh aggregation (``ServerPlan.build(mesh)``, on
   ``torch.distributed``), with the plan's backend "auto": mesh-naive-fig2
   (NCCL, one rank, a (1, 1) mesh; Fig. 2's MNIST tree, w1 (784, 128), b1,
   w2 (128, 10), b2, d = 101,770, 20 worker rows; the registry (cm, tm,
   mean, cclip, rfa, krum, multi_krum, bucket_cm, bucket_krum,
   bucket_rfa) at radius 3.0 and unclipped, superleaf_elems 0 and
   24,576: every output within rtol 1e-5 (atol 1e-6) of the CPU plain
   path, the same Krum winners; then the one-rank sharded placement on
   one row, through NCCL's all_reduce (an all_to_all or all-gather over
   an axis of one rank returns its input and runs no collective), equal
   to its naive placement within atol 3e-5 and pipelined bitwise equal to
   sequential); mesh-naive-wide (NCCL, one rank; 20 rows of w (4096,
   4096) and b (37,), 2^24+37 f32 coordinates; cm, rfa, krum, bucket_cm
   at radius 3.0, five timed steps each, the clip factors from each row's
   whole-tree norm: within rtol 1e-5 of the plain versions on the card,
   the same Krum winner); mesh-sharded-4rank (gloo, four processes on
   cuda:0, spawned once: the MNIST tree on (4, 1) and on (2, 2) with w1's
   second dimension split over "model" through ``base_specs``, the
   registry as above; the wide tree with one worker per rank on (4, 1),
   cm, rfa, krum, bucket_cm); mesh-sharded-8rank (gloo, eight processes
   on cuda:0: the MNIST tree on (4, 2) with w1 split over "model", four
   workers all sampled at byz_bound 0, so that Krum's choice rests on
   the Gram summed over "model"); on each rank: pipelined bitwise equal
   to sequential, sharded within atol 3e-5 of naive, every output within
   rtol 1e-5 of the one-process CPU plain path on the gathered tree.
   Each run prints its wall ms a step, its launches (per rank for the
   spawned runs) and its collectives with the bytes they returned and
   their route: NCCL's must stay on the card ("device"); on gloo every
   collective takes gloo's host route ("host": gloo stages each CUDA
   tensor through pinned host memory and runs the collective on the
   CPU), which the phase checks and prints op by op.  Each transport's
   collectives are also timed alone at 2^22 f32 a rank (gloo on the
   card's tensors and on CPU ones).
9. The model zoo (``repro_torch.models``; no kernel: the models run
   plain PyTorch, TF32 off; it runs while phase 1's nvcc builds), each
   run printing its wall seconds and the
   card's name and power limit, the reduced sizes listed:
   models-smoke (each of the ten ``smoke()`` configs in f32, remat off,
   batch 2 x 32, params and batch made on the CPU from one seed, the
   VLM's cross-attention gates opened to 0.5: ``apply_train``'s loss and
   aux on the card within rtol 1e-5 of the CPU's, every gradient leaf
   (``torch.autograd.grad``) and the prefill logits within 1e-4 of their
   max-abs, remat on within 1e-6 of remat off; 12 ``apply_decode`` steps
   from ``init_cache`` equal to the prefill of the same tokens on the
   seven decodable families at capacity 8.0, atol 2e-3 and rtol 2e-2;
   the same step in bf16 with a finite, non-zero loss and gradient
   norm); models-minitron-wide (minitron-8b at full width, 2 of its 32
   layers, seq 4,096, batch 1: the same params in f32 and in bf16, the
   bf16 loss within 2e-2 relative of the f32 loss and the global
   gradient norms within 5%); models-minitron-full (minitron-8b as
   configured, 9.9e9 parameters, 32 layers, bf16, remat: two train steps
   at train_4k's seq 4,096 with batch 1, the first cold, the loss finite
   and within [ln V - 1, ln V + 2], one ``sgd`` update, one prefill at
   prefill_32k's seq 32,768 with batch 1); models-mamba2-full
   (mamba2-780m as configured, 48 layers, state 128, chunk 256, bf16:
   two train steps at 4,096 with every gradient leaf finite, a prefill
   at 32,768, and layer 0's chunked SSD at S = 1,024 in f32 within 1e-4
   of its max-abs of the recurrence run step by step in float64).  Each
   prints ms, tokens/s and the peak of ``torch.cuda.max_memory_allocated``.
10. The mesh trainer and the decode launcher (``repro_torch.launch.train``,
    ``launch/serve.py``'s decode mode), each run printing its wall seconds,
    the card's name and power limit and its reduced sizes:
    train-minitron-wide (NCCL, one rank, the (1, 1) mesh: one worker;
    minitron-8b at full width with 2 of its 32 layers, bf16, remat,
    train_4k's seq 4,096 with batch 1, the default plan: sharded CM with
    alpha 2; 4 steps on a tape, a full round then three difference
    rounds: the params x - gamma g bit for bit; the step's aggregate
    (``make_train_step``'s ``on_aggregate``) within 1e-4 of each leaf's
    max-abs of its definition, the gradient at x+ (full round, the CM of
    one row) or min(1, lambda/||d||) d (difference rounds, d the
    gradients' difference), each gradient from its own
    ``_value_and_grad`` call, with the clip factor the aggregate shows
    printed beside the plain one; g+ (agg, or g + agg cast to bf16)
    within 2^-7; ms a step, tokens/s, peak GB, launches and collectives,
    which stay on the card: over the axes of one rank the port runs no
    all_to_all and no all-gather);
    train-robust-8rank (gloo, eight processes on cuda:0, the (4, 2) mesh:
    the reference's robustness job, tests/test_mesh_trainer.py:588-635,
    gauss from one of 4 workers, 12 steps, the default plan and mean on
    the naive placement under the tensor-parallel split, and the default
    plan under zero3 (params and g held in pieces over "model", each
    layer gathered over it, the worker's 2 rows split over it); then the
    same job on the CPU in the same ranks: CM below its start and below mean - 0.05
    on both, under either mode; the card against the CPU: the loss on
    batch 0 after each step within rtol 1e-4 at every step for CM and at
    the first two for mean (which takes gauss's noise whole and runs away
    chaotically from there), g after the first step within 1e-4 of each
    leaf's max-abs for all; every rank's params, gathered whole, equal
    bit for bit, launches and collectives per rank on gloo's host route);
    train-example (``python -m repro_torch.train_marina_pp --smoke
    --steps 8 --ckpt-dir``, eight gloo ranks on cuda:0: OK, and the
    checkpoint restores to the final params); decode-minitron
    (minitron-8b as configured, 32 layers, bf16, on decode_32k's cache of
    32,768 with the batch cut to 8: 16 ``make_serve_step`` steps from
    index 0 against ``apply_prefill`` of the same tokens (one token and
    t + 1 tokens run GEMMs of other shapes, whose bf16 roundings differ
    by 2.7e-2 of the logits' max-abs after 32 layers: held within 6e-2,
    and at least 0.9 of the greedy tokens equal to the prefill's argmax),
    ms a token at index 32,767, tokens/s, peak GB; the same 16 steps in
    f32 at batch 2, held to the prefill at atol 2e-3 and rtol 2e-2; then ``python -m
    repro_torch.launch.serve --arch minitron_8b`` and ``python -m
    repro_torch.serve_demo``, which must print OK).  Rows 1-3
    (``row_norms``, ``clip_bucket_select``, ``coordinate_median``) must
    be launched on both trainer runs, and by the zero3 plan alone.
11. The tensor-parallel split and the dry run (``repro_torch.models.tp``,
    ``launch/dryrun.py``): train-tp-small (``TINY`` in f32, the default
    plan, 3 steps on one ``TrainTape``, on 2 gloo ranks of a (1, 2) and 4
    of a (1, 4) mesh on cuda:0, whose ``wk``/``wv`` pieces are half a kv
    head; each rank's pieces of params and g within 1e-5 of each leaf's
    max-abs of the matching slices of a one-rank NCCL run on the card
    after every step; launches per rank); train-tp-wide (minitron-8b at
    full width with 2 of 32 layers, bf16, remat, seq 4,096, batch 1, on 2
    gloo ranks of a (1, 2) mesh on cuda:0: a difference and a full round;
    each rank's held bytes of params and g equal to the sum of its
    ``param_specs`` pieces exactly, the step-0 loss within 1e-3 relative
    of train-minitron-wide's on the same weights and batch, and each
    rank's g^0 pieces within 5e-2 of each leaf's max-abs of the same
    cut of train-minitron-wide's g^0 (bf16); peak, ms a round and
    collectives by route, gloo's host route); dryrun-vs-card
    (``launch.dryrun.run_one`` on train-minitron-wide's own config and
    batch on the (1, 1) mesh: its state's bytes on the card within 1% of
    what ``torch.cuda.memory_allocated`` grew by when phase 10 built that
    state; its temp figure beside phase 10's measured peak; the same
    config's held state on (16, 16)).
12. The split of the MoE and MLA decoders (``models.moe``'s experts over
    "model", ``layers._mla_split``, the dense prefix and the MTP head):
    train-tp-moe-small (arctic-480b's and deepseek-v3-671b's smoke configs
    in f32, remat on, the default plan, a full round and a difference
    round on one ``TrainTape``, on 2 gloo ranks of a (1, 2) and 4 of a
    (1, 4) mesh on cuda:0; each rank's pieces of params and g within 1e-5
    of each leaf's max-abs of the slices of a one-rank NCCL run on the
    card after every round; held bytes exactly the ``param_specs``
    pieces; choices dropped over capacity counted, above 0; rows 1-3
    launched on every rank); train-tp-v3-wide (deepseek-v3-671b at full
    width, 2 layers: the dense prefix layer and one MoE layer of 32 of
    its 256 experts, MTP on, bf16, remat, seq 4,096, batch 1: first the
    whole one-rank run's step-0 loss and g^0 and their routings, g^0
    written to disk; then the trainer on 2 gloo ranks of a (1, 2) mesh on
    cuda:0: held bytes exactly the pieces; routed by the whole run's
    expert ids (``moe.record_routing``: top-k on bf16 activations sends a
    few tokens elsewhere when the split's sums round otherwise), the
    step-0 loss within 5e-5 relative and each g^0 piece within 5e-2 of
    its leaf's max-abs of the whole run's; on the split's own routing, the
    (token, choice) pairs routed elsewhere counted and the loss within
    5e-5; a full and a difference round's ms, peak GB, launches and
    collectives); moe-v3-full-experts (the same 2 layers with all 256
    experts, 14.28 G values: ``apply_train``'s loss and gradient whole on
    one rank, then split on the (1, 2) mesh, the ranks making the whole
    params one after another and keeping their pieces; the loss on its
    own routing within 5e-5 relative, its choices routed elsewhere
    counted; routed as the whole run, the loss within 5e-5 and the
    gradient of every non-expert leaf and of experts 0, 127, 128 and 255
    within 5e-2 of max-abs; peak GB of both runs).
13. The split of the SSM and hybrid decoders (``models.ssm``'s Mamba-2
    mixer over "model": its heads, ``in_proj`` and ``conv_w`` whole once
    a layer, the gated norm's sum of squares summed over the axis):
    train-tp-ssm-small (mamba2-780m's and jamba-v0.1-52b's smoke configs
    in f32, remat on, the default plan, a full round and two difference
    rounds on one ``TrainTape``, on 2 gloo ranks of a (1, 2) and 4 of a
    (1, 4) mesh on cuda:0; each rank's pieces of params and g within 1e-5
    of each leaf's max-abs of the slices of a one-rank NCCL run after
    every round, the per-head ``A_log`` and ``dt_bias`` within 1e-4;
    held bytes exactly the pieces; rows 1-3 launched on every rank);
    train-tp-mamba2-wide (mamba2-780m at full width, 4 of
    its 48 layers, bf16, remat, seq 4,096, batch 1: first the whole
    one-rank run's step-0 loss and g^0 in a process of its own, g^0
    written to disk; then the trainer on 2 gloo ranks of a (1, 2) mesh:
    held bytes exactly the pieces, the step-0 loss within 5e-5 relative
    and each g^0 piece within 5e-2 of its leaf's max-abs of the whole
    run's; a full and a difference round's ms, peak GB, launches and
    collectives); train-tp-jamba-wide (jamba at full width cut to the
    first 4 positions of its period, all 16 experts, 6.87 G values:
    ``apply_train``'s loss and gradient whole on one rank, then split on
    the (1, 2) mesh, held bytes exactly the pieces; routed by the whole
    run's expert ids (one routing a MoE layer, in turn), the loss within
    5e-5 and each gradient piece of every non-expert leaf and of experts
    0, 7, 8 and 15 within 5e-2 of max-abs or 0.15 of rms; the choices its
    own routing sends elsewhere counted, its loss beside).
14. fsdp_tp's split over "data" (params and g held in "data" x "model"
    pieces, each layer gathered over "data" in the period loop):
    fsdp-small (``TINY`` and the arctic and v3 smoke configs in f32,
    the default plan, a full and a difference round on one
    ``TrainTape``, under fsdp_tp and under "tp" on the same mesh: (data 2,
    model 2) with two "data" workers and (pod 1, data 2, model 2) with
    the pods the workers, the worker's 4 rows split over "data"; 4 gloo
    ranks on cuda:0; each rank's pieces within 1e-5 of each leaf's
    max-abs of the matching slice of the "tp" run's after every round,
    exactly the ``param_specs`` shapes, the same choices dropped, the
    collectives by kind on gloo's host route, a reduce-scatter where the
    rows split); fsdp-wide (minitron-8b at full width, 2 of 32 layers,
    bf16, remat, 2 rows x 2,048 split over "data" on (pod 1, data 2,
    model 2): held bytes exactly the pieces, the step-0 loss within 2e-4
    relative and each g^0 piece within 5e-2 of max-abs of a one-rank
    whole run's on the same weights and batch; a full and a difference
    round's ms and peak GB).
15. The split of cross-attention (llama-3.2-vision-90b: ``_gqa_split``'s
    heads with the vision tokens as keys and values, the gate after the
    sum), every cross-attention gate opened to 0.5: vision-small (the
    smoke config in f32, remat on, the default plan, a full and a
    difference round on one ``TrainTape``; "tp" on 2 gloo ranks of a
    (1, 2) and 4 of a (1, 4) mesh, fsdp_tp on 4 of (pod 1, data 2, model
    2) with the pod the worker, its rows and vision rows split over
    "data"; each rank's pieces of params and g within 1e-5 of each leaf's
    max-abs of the slices of a one-rank NCCL run after every round, held
    bytes exactly the pieces); vision-wide (llama-3.2-vision-90b at full
    width, the first 2 positions of its period (cross/dense,
    attn/dense), bf16, remat, seq 4,096, batch 1: the whole one-rank
    run's step-0 loss and g^0 in the whole runs' process, then the
    trainer on 2 gloo ranks of a (1, 2) mesh: held bytes exactly the
    pieces, the step-0 loss and each g^0 piece against the whole run's
    at the limits of ``VISION_LOSS_RTOL`` and ``VISION_G0_REL``; a full
    and a difference round's ms, peak GB, launches and collectives).
16. The split of frame inputs (hubert-xlarge: the frame projection
    column-split and gathered back to the residual, the masked
    cross-entropy's sums over rows added up where the rows split):
    frames-small (the smoke config in f32, remat on, the default plan, a
    full and a difference round on one ``TrainTape``; "tp" on 2 gloo
    ranks of a (1, 2) and 4 of a (1, 4) mesh, fsdp_tp on 4 of (pod 1,
    data 2, model 2) with the pod the worker, its frames, targets and
    mask split over "data"; each rank's pieces within 1e-5 of each leaf's
    max-abs of the slices of a one-rank NCCL run after every round, held
    bytes exactly the pieces); frames-wide (hubert-xlarge at full width,
    4 of its 48 layers, bf16, remat, one row of 4,096 frames with the
    pipeline's targets and mask: the whole one-rank run in the whole
    runs' process, then the trainer on 2 gloo ranks of a (1, 2) mesh:
    held bytes exactly the pieces, the step-0 loss and each g^0 piece at
    the limits of ``FRAMES_LOSS_RTOL`` and ``FRAMES_G0_REL``; a full and
    a difference round's ms, peak GB, launches and collectives).
17. zero3's pieces over "model" (no Megatron split: each layer gathered
    over "model" in the period loop, the rows split over it where it
    divides them): zero3-small (``TINY`` and deepseek-v3's smoke config
    in f32, the default plan, a full and a difference round on one
    ``TrainTape``, on 2 gloo ranks of a (1, 2) mesh, the worker's 2 rows
    split over "model" (v3's MoE routing over split rows), and 4 of a
    (1, 4) mesh, where 4 does not divide them and every rank runs both;
    against the one-rank NCCL runs at 1e-5 of max-abs, held bytes
    exactly the zero3 pieces); zero3-wide (minitron-8b with 2 of 32
    layers on fsdp-wide's weights and 2 rows x 2,048 on 2 gloo ranks of
    a (1, 2) mesh, one full round: held bytes exactly the zero3 pieces,
    the step-0 loss and g^0 against fsdp-wide's whole run at its limits;
    ms, peak GB and collectives by kind).
18. The split of prefill and decode (``make_prefill_step`` and
    ``make_serve_step`` with a mesh: params in their ``param_specs``
    pieces, the decode cache in its ``cache_specs`` pieces, the attention
    caches' length over "model"): serve-split-small (the configs, inputs
    and meshes of ``tests/test_torch_serve_split.py``: every family's
    smoke config in f32 and minitron's with a sliding window, a prefill
    and 4 decode steps at write positions 6-9 of 16 on (1, 2) and (1, 4)
    under "tp", (2, 2) under fsdp_tp and (1, 2, 2) under "tp", gloo ranks
    on cuda:0; each rank's logits and cache pieces within 1e-5 of max-abs
    of a one-rank NCCL run's, the next tokens equal); serve-tp-wide
    (minitron-8b at full width, 2 of 32 layers, bf16, on (1, 2): a
    prefill of prefill_32k's 32,768 positions at batch 1, 8 decode steps
    on decode_32k's cache of 32,768 at batch 8 from index 16,380, across
    the blocks' boundary at 16,384, then timed steps at the cache's end)
    and serve-v3-wide (deepseek-v3 with train-tp-v3-wide's cut, decoding
    on its latent cache alike, routed as the whole run routed): the
    whole one-rank runs in the whole runs' process, the logits, next
    tokens and written cache slots held at ``SERVE_WIDE_REL``; ms a
    token, peak GB and held bytes a rank.
    Phases 11-18 run their splits first (``split_paths``: the one-rank
    NCCL runs; one spawn of 4 gloo ranks and one of 2 side by side,
    shared by every phase, the 2-rank spawn's wide runs after the 4-rank
    spawn; the whole runs they are held to ran beside the build), then
    each phase's checks, and print each phase's seconds.
19. A ``{"kernels": [...]}`` line, then the card line, then the result.
    A kernel's ``launches`` are those of the run of the path it serves
    (``path``; "entry-points" for clipped_diff's and the bucketed
    median's, which no engine calls); ``launches_by_path`` has its counts
    in every in-process run, the mesh runs and the trainer runs (the
    spawned ones summed over their ranks).
"""
import dataclasses
import functools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, same source
WIDE_D = 2 ** 24 + 37
STEPS = 300
WIDE_STEPS = 50  # fig2-rfa-wide
GM_ITERS = 8
CCLIP_TAU, CCLIP_ITERS = 10.0, 5
RANDK_KS, RANDK_STEPS = (40, 20, 5), 400  # bench_ablation.py's sweep
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
NORM_RTOL = 1e-6  # clipped_diff's norm against its plain version
GRAM_F32_K = 8.0  # the Gram's limit against float64, in f32 rounding units
# phase 4's thresholds for the unbucketed majority runs, fixed from the
# port's own CPU run (clipped 1.6687, unclipped 199.42 after 300 steps)
CLIPPED_BELOW, UNCLIPPED_ABOVE = 2.0, 20.0
# phase 3's thresholds for the compressed and CenteredClip runs, fixed
# from the port's own CPU run: gaps to the optimum 1.01e-4 (RandK k = 40,
# 20, 5, 400 steps) and 4.75e-4 (CenteredClip, 300 steps)
SWEEP_GAP_BELOW = 1e-3
MAJORITY = dict(n_clients=10, n_good=7, m=128, in_dim=32, hidden=16,
                heterogeneous=True)
# phase 2's device-time yardstick: windows of back-to-back calls
WINDOW_MS, DEVICE_WINDOWS, MAX_WINDOW_CALLS = 3.0, 5, 1000
ENQUEUE_CALLS = 300  # calls over which a wrapper's host enqueue time is taken


def _fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def _time_ms(fn, reps):
    """Median wall time of one call on the card (CUDA events), after one
    warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@functools.cache
def _spin_cycles_per_ms():
    """Clock cycles of the card's spin kernel (``torch.cuda._sleep``) in one
    ms, measured once."""
    import torch

    cycles = 10 ** 7
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def _device_ms(fn):
    """Device time of one call: after a warm-up, N calls back to back
    between one event pair with no synchronise between them, the window
    over N; the median of DEVICE_WINDOWS windows, N chosen so that a window
    lasts about WINDOW_MS.  Before each window a spin kernel holds the card
    for 1.5 times as long as the host takes to queue the window's calls,
    so the host's cost per call stays out of the window."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(3):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / 3
    end.synchronize()
    calls = max(1, min(MAX_WINDOW_CALLS,
                       round(WINDOW_MS / max(start.elapsed_time(end) / 3,
                                             1e-3))))
    spin = int(min(1.5 * calls * host_ms + 0.2, 100.0)
               * _spin_cycles_per_ms())
    times = []
    for _ in range(DEVICE_WINDOWS):
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _enqueue_us(fn, calls=ENQUEUE_CALLS):
    """Host time to enqueue one call, in us: a host clock over ``calls``
    calls with no synchronise between them, and one at the end."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / calls * 1e6


def _row(kernel, plain, library=None, reps=10, plain_reps=3):
    """One kernel's times: the kernel's and the library call's device time
    (``ms``, ``library_ms``: ``_device_ms``) and single-call time
    (``call_ms``, ``library_call_ms``: ``_time_ms``), and the plain
    version's single-call time (no yardstick, so the old timer)."""
    t = {"ms": _device_ms(kernel), "call_ms": _time_ms(kernel, reps),
         "plain_ms": _time_ms(plain, plain_reps),
         "library_ms": None, "library_call_ms": None}
    if library is not None:
        t["library_ms"] = _device_ms(library)
        t["library_call_ms"] = _time_ms(library, reps)
    return t


@functools.cache
def _launch_floor_ms():
    """Device time of one back-to-back spin kernel of one cycle
    (``torch.cuda._sleep(1)``) under ``_device_ms``: what a launch costs on
    this card, the floor of a one-block resident kernel."""
    import torch

    return _device_ms(lambda: torch.cuda._sleep(1))


def _time_resident(fn, plain_fn, d, s, steps, step_ops, seed):
    """A resident kernel's times at n = 20, width d, bucket size s, on data
    made from ``seed``: ``fn(x, m, f, i, iters)`` and its plain version as
    ``_row`` times them, the bound (the input read once; the clip, the
    bucket means, z0 and ``step_ops`` operations a value a step), and
    ``iters0_ms``: the launch, the staging, z0 and the write-out alone."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(20, d, device="cuda", generator=g)
    m = (torch.rand(20, device="cuda", generator=g) > 0.3).float()
    f = torch.rand(20, device="cuda", generator=g)
    i = torch.randperm(20, device="cuda", generator=g).int()
    rows = 20 // s
    t = _row(lambda: fn(x, m, f, i, steps), lambda: plain_fn(x, m, f, i, steps),
             reps=20, plain_reps=10)
    t["bound_ms"], t["bound_by"] = _bound(
        4 * (20 * d + d + 3 * 20),
        3 * 20 * d + 2 * rows * d + steps * step_ops * rows * d)
    t["iters0_ms"] = _device_ms(lambda: fn(x, m, f, i, 0))
    return t


def _print_resident(name, t):
    big = t["largest"]
    print(f"  {name:18s} no step (iters = 0) {t['iters0_ms']:.4f} ms  launch "
          f"floor {t['floor_ms']:.4f} ms; at n=20 d={big['shape'][1]} "
          f"s={big['shape'][2]} (the largest it takes): kernel "
          f"{big['ms']:.4f} ms (one call {big['call_ms']:.4f})  no step "
          f"{big['iters0_ms']:.4f} ms  bound {big['bound_ms']:.6f} ms "
          f"({big['bound_by']})  plain {big['plain_ms']:.4f} ms")


def _print_rows(out, digits=4):
    for name, v in out.items():
        lib = "none" if v["library_ms"] is None else (
            f"{v['library_ms']:.4f} (one call {v['library_call_ms']:.4f})")
        print(f"  {name:18s} kernel {v['ms']:.4f} ms (one call "
              f"{v['call_ms']:.4f})  bound {v['bound_ms']:.{digits}f} ms "
              f"({v['bound_by']})  plain {v['plain_ms']:.4f} ms  "
              f"library {lib} ms")


class Checks:
    """Kernel-vs-plain comparisons; keeps the worst error per kernel."""

    def __init__(self):
        self.max_abs = {}

    def compare(self, kernel, what, got, want, exact, scale=None,
                rtol=SUM_RTOL, atol=SUM_ATOL):
        """``scale``: what rtol is relative to (default |want|)."""
        import torch

        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs()
        max_abs = float(err.max())
        scale = want.abs() if scale is None else scale
        rel = float((err / scale.clamp(min=1e-30)).max())
        if exact:
            ok = torch.equal(got, want)
            tol = "exact"
        else:
            ok = bool((err <= atol + rtol * scale).all())
            tol = f"rtol {rtol:g} atol {atol:g}"
        print(f"  {kernel:18s} {what:44s} max_abs {max_abs:.3e} "
              f"max_rel {rel:.3e} [{tol}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kernel} {what}: kernel and plain version "
                                 f"disagree (max abs {max_abs:.3e})")
        self.max_abs[kernel] = max(self.max_abs.get(kernel, 0.0), max_abs)


def check_shape(checks, n, d, seed):
    import torch

    from repro_torch.kernels import clip_aggregate as ca
    from repro_torch.kernels import ops

    cmk = sys.modules["repro_torch.kernels.coordinate_median"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, d, device="cuda", generator=g)
    mask = torch.rand(n, device="cuda", generator=g) > 0.3
    mask[0] = True
    maskf = mask.float()
    idx = torch.randperm(n, device="cuda", generator=g).to(torch.int32)
    norms_plain = ca.row_norms_plain(x)
    radius = float(norms_plain.median())  # clips about half the rows
    factors = ca.clip_factor(norms_plain, radius)
    ones = torch.ones(n, device="cuda")
    print(f"shape n={n} d={d}")
    checks.compare("row_norms", "row norms", ops.row_norms(x), norms_plain,
                   exact=False)
    for s in (2, 1):
        bidx = idx if s == 2 else None
        for trim in (-1.0, 0.1):
            rule = "cm" if trim < 0 else "tm0.1"
            tag = f"s={s} {rule}"
            exact = trim < 0
            checks.compare(
                "clip_bucket_select", f"{tag} same factors",
                ca.clip_bucket_select(x, factors, maskf, bidx, s, trim),
                ca.clip_bucket_select_plain(x, factors, maskf, bidx, s, trim),
                exact)
            checks.compare(
                "clip_bucket_select", f"{tag} no clip",
                ops.clip_then_aggregate(x, radius, mask, bidx, trim_ratio=trim,
                                        bucket_s=s, use_clip=False)[0],
                ca.clip_bucket_select_plain(x, ones, maskf, bidx, s, trim),
                exact)
            # clip on: pass 1 then pass 2; the factors come from norms
            # summed in another order, so even the median is held to rtol
            checks.compare(
                "clip_bucket_select", f"{tag} clip (pass 1 + pass 2)",
                ops.clip_then_aggregate(x, radius, mask, bidx, trim_ratio=trim,
                                        bucket_s=s)[0],
                ca.clip_bucket_select_plain(x, factors, maskf, bidx, s, trim),
                exact=False)
    for trim in (-1.0, 0.1):
        kern = ops.coordinate_median(x, mask) if trim < 0 \
            else ops.trimmed_mean(x, mask, trim)
        checks.compare("coordinate_median", "cm" if trim < 0 else "tm0.1",
                       kern, cmk.coordinate_median_plain(x, mask, trim),
                       exact=trim < 0)
    for tag, m in select_masks(mask).items():  # the masks time_wide times
        if m is mask:
            continue
        checks.compare("coordinate_median", f"cm {tag}",
                       ops.coordinate_median(x, m),
                       cmk.coordinate_median_plain(x, m, -1.0), exact=True)
        checks.compare(
            "clip_bucket_select", f"s=1 cm {tag} same factors",
            ca.clip_bucket_select(x, factors, m.float(), None, 1, -1.0),
            ca.clip_bucket_select_plain(x, factors, m.float(), None, 1, -1.0),
            exact=True)
    return x, mask, idx, factors


def _select_ops(values):
    """Comparisons a coordinate needs to select an order statistic of
    ``values`` values: every value but one has to be compared at least once,
    whatever network or algorithm does it."""
    return max(values - 1, 0)


def select_masks(mask):
    """The row masks the selection kernels are held and timed under: every
    row kept (the full rounds of the cm-unbucketed path), the random mask of
    ``check_shape`` (``random``), and 4 rows kept (the paper's
    difference-round cohort, C = 4 of 20, ``configs/paper.py``)."""
    import torch

    n = mask.shape[0]
    g = torch.Generator(device=mask.device).manual_seed(17)
    four = torch.zeros_like(mask)
    four[torch.randperm(n, device=mask.device, generator=g)[:4]] = True
    return {"all": torch.ones_like(mask), "random": mask, f"4-of-{n}": four}


def _bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_wide(x, mask, idx, factors):
    """Kernel, plain and library times at the wide shape."""
    import torch

    from repro_torch.kernels import clip_aggregate as ca
    from repro_torch.kernels import ops

    cmk = sys.modules["repro_torch.kernels.coordinate_median"]
    n, d = x.shape
    maskf = mask.float()
    nb = (n + 1) // 2
    chunks = -(-d // 8192)
    out = {}

    t = _row(lambda: ops.row_norms(x), lambda: ca.row_norms_plain(x),
             lambda: torch.linalg.vector_norm(x, dim=1))
    t["bound_ms"], t["bound_by"] = _bound(4 * n * d + 4 * n * chunks,
                                          2 * n * d)
    out["row_norms"] = t

    # pass 2 alone (bucketed s=2, CM, given factors): no single PyTorch
    # call clips, buckets and selects, so there is no library time.  Its
    # bound reads every row: a masked row in a bucket with a kept row is
    # read, since its inf or NaN makes the bucket's mean NaN
    t = _row(lambda: ca.clip_bucket_select(x, factors, maskf, idx, 2, -1.0),
             lambda: ca.clip_bucket_select_plain(x, factors, maskf, idx, 2,
                                                 -1.0))
    t["bound_ms"], t["bound_by"] = _bound(
        4 * n * d + 4 * d + 12 * n, (3 * n + nb + _select_ops(nb)) * d)
    # pass 2 at s = 1 (the cm-unbucketed path's difference rounds) under the
    # paper's cohort: only the kept rows need reading
    masks = select_masks(mask)
    tag = f"4-of-{n}"
    four = masks[tag].float()
    v = _row(lambda: ca.clip_bucket_select(x, factors, four, None, 1, -1.0),
             lambda: ca.clip_bucket_select_plain(x, factors, four, None, 1,
                                                 -1.0))
    kept = int(masks[tag].sum())
    v["bound_ms"], v["bound_by"] = _bound(
        4 * kept * d + 4 * d + 12 * n, (2 * kept + _select_ops(kept)) * d)
    t["variants"] = {f"s=1 {tag}": v}
    out["clip_bucket_select"] = t

    # masked CM under each mask of select_masks; its bound reads the kept
    # rows (a masked row never counts at s = 1), the old one every row.  The
    # library call is the midpoint median of the rows with NaN at the
    # masked ones, made before the timing
    variants = {}
    for tag, m in masks.items():
        kept = int(m.sum())
        vals = torch.where(m[:, None], x, float("nan"))
        t = _row(lambda: ops.coordinate_median(x, m),
                 lambda: cmk.coordinate_median_plain(x, m, -1.0))
        try:
            quantile = lambda: torch.nanquantile(  # noqa: E731
                vals, 0.5, dim=0, interpolation="midpoint")
            t["library_ms"] = _device_ms(quantile)
            t["library_call_ms"] = _time_ms(quantile, 5)
        except RuntimeError as e:  # the yardstick only; never called
            print(f"  torch.nanquantile refused the wide shape: {e}")
        del vals
        t["kept_rows"] = kept
        t["bound_ms"], t["bound_by"] = _bound(4 * kept * d + 4 * d + 4 * n,
                                              _select_ops(kept) * d)
        t["bound_all_rows_ms"], _ = _bound(4 * n * d + 4 * d + 4 * n,
                                           _select_ops(n) * d)
        variants[tag] = t
    out["coordinate_median"] = dict(variants["random"], variants=variants)
    _print_rows(out)
    for name in ("clip_bucket_select", "coordinate_median"):
        for tag, v in out[name]["variants"].items():
            old = v.get("bound_all_rows_ms")
            print(f"  {name:18s} {tag:12s} kernel {v['ms']:.4f} ms, "
                  f"{100 * v['bound_ms'] / v['ms']:.0f}% of bound "
                  f"{v['bound_ms']:.4f} ({v['bound_by']}, kept rows)"
                  + ("" if old is None else
                     f", {100 * old / v['ms']:.0f}% of the all-rows bound "
                     f"{old:.4f}"))
    return out


def _gm_mods():
    """(centered_clip, geometric_median) kernel modules (the package
    re-exports functions under the modules' names)."""
    return (sys.modules["repro_torch.kernels.centered_clip"],
            sys.modules["repro_torch.kernels.geometric_median"])


def _gm_plain(x, radius, mask, idx, s):
    """The plain clip_then_geometric_median: same dispatch and composition."""
    _, gmk = _gm_mods()
    return gmk.clip_then_geometric_median_plain(
        x, radius, mask, idx, iters=GM_ITERS, bucket_s=s)[0]


def check_gm(checks, x, mask, idx, s, tag, expect=None):
    """The four GM kernels and the whole clip_then_geometric_median
    against their plain versions on one input; ``expect`` ("resident" or
    "tiled") is the schedule the whole call must take.  Returns the
    padded auxiliaries."""
    import torch

    from repro_torch.kernels import clip_aggregate as ca
    from repro_torch.kernels import ops

    cc, gmk = _gm_mods()
    n, d = x.shape
    norms = ca.row_norms_plain(x)
    radius = float(norms.median())
    f = ca.clip_factor(norms, radius)
    bidx = idx if s >= 2 else None
    m, fp, ip = cc.pad_bucket_aux(mask.float(), f, bidx, n, s)
    rows = m.shape[0] // s
    fits = cc.resident_smem_bytes(rows, d) <= cc.smem_budget(x.device)
    t = f"{tag} s={s}"
    if fits:
        checks.compare("gm_resident", t,
                       gmk.gm_resident(x, m, fp, ip, s, iters=GM_ITERS),
                       gmk.gm_resident_plain(x, m, fp, ip, s, iters=GM_ITERS,
                                             eps=1e-8), exact=False)
    if s >= 2:
        checks.compare("bucket_means", t, cc.bucket_means(x, m, fp, ip, s),
                       cc.bucket_means_plain(x, m, fp, ip, s)[0], exact=False)
    z = _gm_plain(x, radius, mask, bidx, s)
    checks.compare("diff_row_ssq", t, cc.diff_row_ssq(x, z, fp[:n]),
                   cc.diff_row_ssq_plain(x, z, fp[:n]), exact=False)
    ssq = cc.diff_row_ssq_plain(x, z, fp[:n])
    w = m[:n] / (ssq + 1e-8).sqrt()
    wsum = w.sum().clamp(min=1e-8)
    checks.compare("gm_update", t, gmk.gm_update(x, w, fp[:n], wsum),
                   gmk.gm_update_plain(x, w, fp[:n], wsum), exact=False)
    ops.reset_launch_counts()
    got, _ = ops.clip_then_geometric_median(x, radius, mask, bidx,
                                            iters=GM_ITERS, bucket_s=s)
    counts = ops.launch_counts()
    took = "resident" if counts["gm_resident"] else "tiled"
    if took != ("resident" if fits else "tiled") or (expect and took != expect):
        raise AssertionError(f"{t}: the whole call took the {took} schedule "
                             f"(expected {expect}, fits={fits}): {counts}")
    checks.compare("clip_then_gm", f"{t} whole call ({took})", got, z,
                   exact=False)
    none = torch.zeros_like(mask)
    zero = torch.zeros(d, device=x.device)
    checks.compare("clip_then_gm", f"{t} all rows masked",
                   ops.clip_then_geometric_median(x, radius, none, bidx,
                                                  bucket_s=s)[0], zero,
                   exact=True)
    checks.compare("clip_then_gm", f"{t} all rows masked (plain)",
                   _gm_plain(x, radius, none, bidx, s), zero, exact=True)
    return m, fp, ip


def gm_shapes(checks):
    """Phase 2's GM checks at the Fig. 2, odd-n and threshold shapes;
    returns the largest resident d at n = 20 for s = 1 and 2."""
    import torch

    cc, _ = _gm_mods()
    budget = cc.smem_budget(torch.device("cuda"))
    print(f"gm shapes (opt-in shared memory per block: {budget} bytes)")

    def data(n, d, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(n, d, device="cuda", generator=g)
        mask = torch.rand(n, device="cuda", generator=g) > 0.3
        mask[0] = True
        return x, mask, torch.randperm(n, device="cuda", generator=g).int()

    for s in (1, 2):
        check_gm(checks, *data(20, 698, 10 + s), s, "n=20 d=698",
                 expect="resident")
    for s in (2, 3):
        check_gm(checks, *data(21, 700, 20 + s), s, "n=21 d=700",
                 expect="resident")
    largest = {}
    for s in (1, 2):
        rows = 20 // s
        d_max = 1
        while cc.resident_smem_bytes(rows, d_max + 1) <= budget:
            d_max += 1
        largest[s] = d_max
        for d, expect in ((d_max, "resident"), (d_max + 1, "tiled")):
            check_gm(checks, *data(20, d, 30 + d), s, f"n=20 d={d}",
                     expect=expect)
    return largest


def time_gm(x, mask, idx, checks, largest):
    """GM checks at the wide shape, then kernel, plain and library times:
    the tiled kernels at the wide shape, gm_resident at the Fig. 2 shape
    and at the largest shape its rule admits (``largest[2]``, s = 2)."""
    import torch

    from repro_torch.kernels import ops

    cc, gmk = _gm_mods()
    n, d = x.shape
    nb = n // 2
    for s in (1, 2):
        check_gm(checks, x, mask, idx, s, f"n={n} d={d}", expect="tiled")
    out = {}
    z = torch.randn(d, device="cuda")
    t = _row(lambda: cc.diff_row_ssq(x, z),
             lambda: cc.diff_row_ssq_plain(x, z),
             lambda: torch.cdist(x, z[None]) ** 2)
    t["bound_ms"], t["bound_by"] = _bound(4 * (n * d + d + n), 3 * n * d)
    out["diff_row_ssq"] = t

    # the library call is one GEMM, B @ x with B[b, r] = f_r m_r / max(cnt_b,
    # 1) for the rows r of bucket b, B made before the timing
    m, fp, ip = cc.pad_bucket_aux(mask.float(), torch.rand(n, device="cuda"),
                                  idx, n, 2)
    slots = ip.long().view(nb, 2)
    cnt = m[slots].sum(dim=1).clamp(min=1.0)
    bmat = torch.zeros(nb, m.shape[0], device="cuda").scatter_(
        1, slots, (fp * m)[slots] / cnt[:, None])[:, :n].contiguous()
    checks.compare("B @ x (library)", f"n={n} d={d} s=2 vs bucket_means",
                   bmat @ x, cc.bucket_means(x, m, fp, ip, 2), exact=False)
    t = _row(lambda: cc.bucket_means(x, m, fp, ip, 2),
             lambda: cc.bucket_means_plain(x, m, fp, ip, 2), lambda: bmat @ x)
    t["bound_ms"], t["bound_by"] = _bound(4 * (n * d + nb * d), 4 * n * d)
    out["bucket_means"] = t

    w = torch.rand(n, device="cuda")
    wsum = w.sum()
    wn = w / wsum
    t = _row(lambda: gmk.gm_update(x, w, None, wsum),
             lambda: gmk.gm_update_plain(x, w, None, wsum), lambda: wn @ x)
    t["bound_ms"], t["bound_by"] = _bound(4 * (n * d + d), 2 * n * d)
    out["gm_update"] = t

    # gm_resident at the shape the Fig. 2 path gives it, and the largest
    def gm(xr, mr, fr, ir, iters, s=2):
        return gmk.gm_resident(xr, mr, fr, ir, s, iters=iters)

    def gm_plain(xr, mr, fr, ir, iters, s=2):
        return gmk.gm_resident_plain(xr, mr, fr, ir, s, iters=iters, eps=1e-8)

    t = _time_resident(gm, gm_plain, 698, 2, GM_ITERS, 5, seed=5)
    t["floor_ms"] = _launch_floor_ms()
    t["largest"] = dict(_time_resident(gm, gm_plain, largest[2], 2, GM_ITERS,
                                       5, seed=largest[2]),
                        shape=[20, largest[2], 2])
    out["gm_resident"] = t
    _print_rows(out, digits=6)
    _print_resident("gm_resident", t)

    # the whole call, clipped, per schedule: the bytes its kernels move
    # (pass 1, bucket means, z0 and two streams per step) against the
    # bytes the function must move (its input once, its output once)
    for s in (1, 2):
        rows = n if s == 1 else nb
        moved = (4 * n * d  # pass 1
                 + (4 * (n + nb) * d if s == 2 else 0)  # bucket means
                 + 4 * (rows * d + d)  # z0
                 + GM_ITERS * 4 * (2 * rows * d + 2 * d))  # per step
        bidx = idx if s == 2 else None
        ms = _time_ms(lambda: ops.clip_then_geometric_median(
            x, 1.0, mask, bidx, bucket_s=s), 5)
        plain = _time_ms(lambda: _gm_plain(x, 1.0, mask, bidx, s), 3)
        print(f"  clip_then_gm s={s}  whole call {ms:.4f} ms  schedule bytes "
              f"{moved / 1e9:.3f} GB -> {moved / HBM_BYTES_PER_S * 1e3:.4f} ms"
              f"  function bound {4 * (n * d + d) / HBM_BYTES_PER_S * 1e3:.4f}"
              f" ms (bytes)  plain {plain:.4f} ms  library none")
    return out


def _krum_mod():
    return sys.modules["repro_torch.kernels.krum"]


def _entry_scale(gram_a, gram_b):
    """Each Gram entry's Cauchy-Schwarz scale sqrt(|A_ii B_jj|)."""
    import torch

    return torch.sqrt(torch.outer(gram_a.diagonal(), gram_b.diagonal()).abs())


def _tf32(t):
    """f32 values rounded to TF32's 10-bit mantissa (ties away from 0)."""
    import torch

    bits = (t.float().view(torch.int32) + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def check_gram_f64(what, tag, got, a, b):
    """Hold a Gram or cross-Gram against the float64 product of its
    operands at the f32 summation limit (module docstring); on f32 inputs
    the limit must also reject the TF32 and bf16 stand-ins."""
    import torch

    kr = _krum_mod()
    n, d = a.shape
    a64, b64 = a.double(), b.double()
    g64 = a64 @ b64.T
    q = (a64 * a64) @ (b64 * b64).T
    tol = (GRAM_F32_K * 2.0 ** -24 * math.sqrt(kr.gram_rounding_depth(n, d))
           * (q.sqrt() + g64.abs()))
    del a64, b64, q

    def worst(g):
        return float(((g.double() - g64).abs() / tol).max())

    ratio = worst(got)
    line = f"  {what:18s} {tag + ' vs float64':44s} err/limit {ratio:.3e}"
    stand_ins = {}
    if a.dtype == torch.float32:
        stand_ins = {"tf32": worst(_tf32(a).double() @ _tf32(b).double().T),
                     "bf16": worst(a.bfloat16().double()
                                   @ b.bfloat16().double().T)}
        line += "  stand-ins " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in stand_ins.items())
    ok = ratio <= 1.0 and all(v > 1.0 for v in stand_ins.values())
    print(line + f" [limit {GRAM_F32_K:g} units] {'ok' if ok else 'FAIL'}")
    if ratio > 1.0:
        raise AssertionError(f"{what} {tag}: beyond the f32 summation limit "
                             f"of the float64 Gram ({ratio:.3e})")
    if not ok:
        raise AssertionError(f"{what} {tag}: the f32 limit does not reject a "
                             f"rounded-operand stand-in {stand_ins}")


def check_krum(checks, x, y, tag):
    """Krum's four kernels against their plain versions on (n, d) rows x
    (and y, the second cross-Gram operand), and the Gram's bitwise
    properties."""
    import torch

    kr = _krum_mod()
    n, d = x.shape
    g = torch.Generator(device="cuda").manual_seed(n + d)
    mask = torch.rand(n, device="cuda", generator=g) > 0.3
    gram = kr.gram_matrix(x)
    want = kr.gram_matrix_plain(x)
    want_y = kr.gram_matrix_plain(y)
    checks.compare("gram_matrix", tag, gram, want, exact=False,
                   scale=_entry_scale(want, want))
    check_gram_f64("gram_matrix", tag, gram, x, x)
    torch.cuda.synchronize()
    sym = torch.equal(gram, gram.T)
    same = torch.equal(kr.cross_gram(x, x), gram)
    print(f"  {'gram_matrix':18s} {tag + ' G == G^T, cross(x,x) == gram(x)':44s}"
          f" {'bit for bit' if sym and same else 'FAIL'}")
    if not (sym and same):
        raise AssertionError(f"{tag}: symmetric {sym}, cross == gram {same}")
    cross = kr.cross_gram(x, y)
    checks.compare("cross_gram", tag, cross, kr.cross_gram_plain(x, y),
                   exact=False, scale=_entry_scale(want, want_y))
    check_gram_f64("cross_gram", tag, cross, x, y)
    w = torch.rand(n, device="cuda", generator=g) * mask
    checks.compare("weighted_row_sum", f"{tag} masked weights",
                   kr.weighted_row_sum(x, w), kr.weighted_row_sum_plain(x, w),
                   exact=False)
    for win, sc in ((n // 2, 0.75), (-3, 1.0), (n + 5, 2.0), (1, 0.0)):
        win_t = torch.tensor(win, device="cuda")
        sc_t = torch.tensor(sc, device="cuda")
        checks.compare("select_row", f"{tag} row {win} scale {sc}",
                       kr.select_row(x, win_t, sc_t),
                       kr.select_row_plain(x, win_t, sc_t), exact=True)


def krum_edges(checks):
    """At the serve shape: an inf row of weight 0 and of scale 0, and bf16."""
    import torch

    kr = _krum_mod()
    g = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(16, 4096, device="cuda", generator=g)
    x[3] = float("inf")
    w = torch.rand(16, device="cuda", generator=g)
    w[3] = 0.0
    got = kr.weighted_row_sum(x, w)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("weighted_row_sum: an inf row of weight 0 "
                             "leaked into the sum")
    checks.compare("weighted_row_sum", "n=16 d=4096 inf row of weight 0", got,
                   kr.weighted_row_sum_plain(x, w), exact=False)
    zero = torch.zeros(4096, device="cuda")
    checks.compare("select_row", "n=16 d=4096 inf row, scale 0",
                   kr.select_row(x, torch.tensor(3, device="cuda"),
                                 torch.tensor(0.0, device="cuda")), zero,
                   exact=True)
    xb = torch.randn(17, 4097, device="cuda", generator=g).bfloat16()
    yb = torch.randn(17, 4097, device="cuda", generator=g).bfloat16()
    check_krum(checks, xb, yb, "n=17 d=4097 bf16")


# (n, d, dtype, where): rows 0-3 values past an allocation's start, or the
# last row ending at the allocation's end ("end")
GRAM_EDGES = (
    (20, 4097, "f32", 1), (20, 4098, "f32", 2), (20, 4099, "f32", 3),
    (17, 4097, "bf16", 1), (20, 4099, "bf16", 0), (1, 1, "f32", 0),
    (5, 1, "f32", 1), (4, 2, "f32", 0), (20, 3, "f32", 2), (4, 5, "bf16", 1),
    (1, 33, "f32", 3), (5, 31, "f32", 0), (20, 17, "bf16", 0),
    (128, 9, "f32", 1), (128, 33, "bf16", 1), (20, 2 ** 20 + 3, "f32", 1),
    (20, 4097, "f32", "end"), (17, 4099, "bf16", "end"), (5, 3, "f32", "end"))


def _placed(n, d, dtype, where, g):
    """Random (n, d) rows ``where`` values past an allocation's start, or
    ending at its end (an allocation of whole 512-byte blocks)."""
    import torch

    per = 512 // dtype.itemsize
    size = -(-n * d // per) * per if where == "end" else where + n * d
    buf = torch.randn(size, device="cuda", generator=g).to(dtype)
    start = size - n * d if where == "end" else where
    return buf[start:].view(n, d)


def gram_edges(checks):
    """Krum's kernels (check_krum: the Gram's bitwise properties and its
    float64 limit included) at GRAM_EDGES: rows off a 16-byte boundary
    (d = 1, 2, 3 mod 4 in f32, odd d in bf16), tiny d, n in {1, 4, 5, 20,
    128}, many steps of misaligned rows, and a last row ending at the end
    of its allocation."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(17)
    for n, d, name, where in GRAM_EDGES:
        dtype = torch.float32 if name == "f32" else torch.bfloat16
        check_krum(checks, _placed(n, d, dtype, where, g),
                   _placed(n, d, dtype, where, g),
                   f"n={n} d={d} {name} at {where}")


STREAM_DS = (1, 3, 4, 5, 7, 8, 9, 4095, 4097, 2 ** 20 + 3)
SCALE_LENS = (*range(1, 10), 4095, 4096, 4097, 3 * 2 ** 20 + 7)


def stream_edges(checks, x):
    """select_row and clipped_diff_scale at every alignment, exactly:
    select_row at the wide shape at winners 0-3 in f32 (d = 1 mod 4, so
    their rows start at every residue mod 4) and 0-7 in bf16 (every residue
    mod 8), and at n = 20 with d in STREAM_DS for every winner (the
    outputs of the 20 winners stacked into one comparison), in f32 and
    bf16, with an int64 winner; clipped_diff_scale at the lengths of
    SCALE_LENS starting 0-7 values past an aligned start, in f32 and bf16
    (the 8 outputs concatenated into one comparison)."""
    import torch

    kr, cd = _krum_mod(), _cd_mod()
    sc = torch.tensor(0.75, device="cuda")
    n, d = x.shape
    for tag, xs, residues in (("f32", x, 4), ("bf16", x.bfloat16(), 8)):
        for r in range(residues):
            win = torch.tensor(r, dtype=torch.int32, device="cuda")
            checks.compare("select_row", f"n={n} d={d} {tag} row {r}",
                           kr.select_row(xs, win, sc),
                           kr.select_row_plain(xs, win, sc), exact=True)
        del xs
    g = torch.Generator(device="cuda").manual_seed(41)
    for dd in STREAM_DS:
        x32 = torch.randn(20, dd, device="cuda", generator=g)
        for tag, xs in (("f32", x32), ("bf16", x32.bfloat16())):
            wins = [torch.tensor(r, dtype=torch.int64 if r % 2 else torch.int32,
                                 device="cuda") for r in range(20)]
            checks.compare(
                "select_row", f"n=20 d={dd} {tag} every row",
                torch.stack([kr.select_row(xs, w, sc) for w in wins]),
                torch.stack([kr.select_row_plain(xs, w, sc) for w in wins]),
                exact=True)
    factor = torch.tensor(0.6180339887, device="cuda")
    for length in SCALE_LENS:
        base = torch.randn(length + 8, device="cuda", generator=g)
        for tag, src in (("f32", base), ("bf16", base.bfloat16())):
            parts = [src[o:o + length] for o in range(8)]
            checks.compare(
                "clipped_diff_scale", f"len={length} {tag} offsets 0-7",
                torch.cat([cd.clipped_diff_scale(p, factor) for p in parts]),
                torch.cat([cd.clipped_diff_scale_plain(p, factor)
                           for p in parts]), exact=True)


def _gram_rows(x, y, plain_reps):
    """gram_matrix and cross_gram on (n, d) rows x and y: kernel, plain and
    library times (x @ x.T, x @ y.T; TF32 is off) and bounds."""
    kr = _krum_mod()
    n, d = x.shape
    nt = -(-n // 4)  # the kernels' 4 x 4 tiles per side
    t = _row(lambda: kr.gram_matrix(x), lambda: kr.gram_matrix_plain(x),
             lambda: x @ x.T, plain_reps=plain_reps)
    t["bound_ms"], t["bound_by"] = _bound(4 * (n * d + n * n),
                                          2 * 16 * nt * (nt + 1) // 2 * d)
    c = _row(lambda: kr.cross_gram(x, y), lambda: kr.cross_gram_plain(x, y),
             lambda: x @ y.T, plain_reps=plain_reps)
    c["bound_ms"], c["bound_by"] = _bound(4 * (2 * n * d + n * n),
                                          2 * 16 * nt * nt * d)
    return {"gram_matrix": t, "cross_gram": c}


def time_krum(x, y):
    """Krum's kernels at the wide shape: kernel, plain and library times
    (TF32 is off for the library products); the Gram kernels also at the
    serve shape (n = 16, d = 4,096), under ``serve`` in their rows."""
    import torch

    kr = _krum_mod()
    n, d = x.shape
    w = torch.rand(n, device="cuda") + 0.5  # every row read
    out = _gram_rows(x, y, plain_reps=2)
    t = _row(lambda: kr.weighted_row_sum(x, w),
             lambda: kr.weighted_row_sum_plain(x, w), lambda: w @ x)
    t["bound_ms"], t["bound_by"] = _bound(4 * (n * d + d + n), 2 * n * d)
    out["weighted_row_sum"] = t
    _print_rows(out)
    g = torch.Generator(device="cuda").manual_seed(4)
    serve = _gram_rows(torch.randn(16, 4096, device="cuda", generator=g),
                       torch.randn(16, 4096, device="cuda", generator=g),
                       plain_reps=5)
    print("  at the serve shape n=16 d=4096:")
    _print_rows(serve, digits=6)
    for name, v in serve.items():
        out[name]["serve"] = v
    out["select_row"] = time_select_row(x)
    return out


def _variant(kernel, plain, library, bound):
    """A streaming kernel's row at one input (``_row``), with its bound and
    the host enqueue us a call of the kernel and of its library call."""
    t = _row(kernel, plain, library, reps=20, plain_reps=5)
    t["bound_ms"], t["bound_by"] = bound
    t["enqueue_us"] = _enqueue_us(kernel)
    t["library_enqueue_us"] = _enqueue_us(library)
    return t


def _print_variants(name, variants):
    for tag, v in variants.items():
        print(f"  {name:18s} {tag:22s} kernel {v['ms']:.4f} ms (one call "
              f"{v['call_ms']:.4f}, {100 * v['bound_ms'] / v['ms']:.0f}% of "
              f"bound {v['bound_ms']:.4f})  library {v['library_ms']:.4f} ms "
              f"(one call {v['library_call_ms']:.4f})  plain "
              f"{v['plain_ms']:.4f} ms  enqueue {v['enqueue_us']:.1f} us, "
              f"library {v['library_enqueue_us']:.1f} us")


def time_select_row(x):
    """select_row at the wide shape with an int32 winner (the engine's),
    at an aligned winner (r = 8: its row starts 8 d values in, a multiple
    of 4 and 8) and a misaligned one (r = n // 2 = 10: 8 bytes past a
    16-byte boundary in f32, 4 in bf16), in f32 and bf16.  The library
    call is x[r] * s with r a Python int: a view, then one multiply (in
    bf16 x[r] * s.view(1), which promotes to f32 as select_row does),
    held equal to the kernel first.  The row of the kernels line is f32 at
    r = 10; every input is in ``variants``."""
    import torch

    kr = _krum_mod()
    n, d = x.shape
    sc = torch.tensor(0.5, device="cuda")
    variants = {}
    for tag, xs, lib_sc in (("f32", x, sc), ("bf16", x.bfloat16(), sc.view(1))):
        for r in (8, n // 2):
            win = torch.tensor(r, dtype=torch.int32, device="cuda")
            got, want = kr.select_row(xs, win, sc), xs[r] * lib_sc
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"select_row {tag} r={r}: x[r] * s "
                                     "(library) differs from the kernel")
            del got, want
            variants[f"{tag} r={r}"] = _variant(
                lambda: kr.select_row(xs, win, sc),
                lambda: kr.select_row_plain(xs, win, sc),
                lambda: xs[r] * lib_sc,
                _bound((xs.element_size() + 4) * d, d))
    _print_variants("select_row", variants)
    return dict(variants[f"f32 r={n // 2}"], variants=variants)


def _cc_mod():
    return sys.modules["repro_torch.kernels.centered_clip"]


def _cclip_plain(x, radius, mask, idx, s, tau=CCLIP_TAU):
    """The plain clip_then_centered_clip: same dispatch and composition."""
    return _cc_mod().clip_then_centered_clip_plain(
        x, radius, mask, idx, tau=tau, iters=CCLIP_ITERS, bucket_s=s)[0]


def check_cclip(checks, x, mask, idx, s, tag, expect=None):
    """The two CenteredClip kernels and the whole clip_then_centered_clip
    against their plain versions on one input (tau at the median distance,
    so that some rows are clipped); ``expect`` is the schedule the whole
    call must take."""
    import torch

    from repro_torch.kernels import clip_aggregate as ca
    from repro_torch.kernels import ops

    cc = _cc_mod()
    n, d = x.shape
    norms = ca.row_norms_plain(x)
    radius = float(norms.median())
    f = ca.clip_factor(norms, radius)
    bidx = idx if s >= 2 else None
    m, fp, ip = cc.pad_bucket_aux(mask.float(), f, bidx, n, s)
    rows = m.shape[0] // s
    fits = (cc.resident_smem_bytes(rows, d, "cclip")
            <= cc.smem_budget(x.device, "cclip"))
    tau = 0.5 * radius
    t = f"{tag} s={s}"
    if fits:
        checks.compare("cclip_resident", t,
                       cc.cclip_resident(x, m, fp, ip, s, iters=CCLIP_ITERS,
                                         tau=tau),
                       cc.cclip_resident_plain(x, m, fp, ip, s,
                                               iters=CCLIP_ITERS, tau=tau),
                       exact=False)
    v = _cclip_plain(x, radius, mask, bidx, s, tau)
    sc = cc._cclip_scale(tau, cc.diff_row_ssq_plain(x, v, fp[:n]), m[:n])
    den = m[:n].sum().clamp(min=1.0)
    checks.compare("cclip_update", t, cc.cclip_update(x, sc, fp[:n], v, den),
                   cc.cclip_update_plain(x, sc, fp[:n], v, den), exact=False)
    checks.compare("cclip_update", f"{t} v0 (z = 0, s = m)",
                   cc.cclip_update(x, m[:n], fp[:n], None, den),
                   cc.cclip_update_plain(x, m[:n], fp[:n], None, den),
                   exact=False)
    ops.reset_launch_counts()
    got, _ = ops.clip_then_centered_clip(x, radius, mask, bidx, tau=tau,
                                         iters=CCLIP_ITERS, bucket_s=s)
    counts = ops.launch_counts()
    took = "resident" if counts["cclip_resident"] else "tiled"
    if took != ("resident" if fits else "tiled") or (expect and took != expect):
        raise AssertionError(f"{t}: the whole call took the {took} schedule "
                             f"(expected {expect}, fits={fits}): {counts}")
    checks.compare("clip_then_cclip", f"{t} whole call ({took})", got, v,
                   exact=False)
    none = torch.zeros_like(mask)
    zero = torch.zeros(d, device=x.device)
    checks.compare("clip_then_cclip", f"{t} all rows masked",
                   ops.clip_then_centered_clip(x, radius, none, bidx, tau=tau,
                                               bucket_s=s)[0], zero,
                   exact=True)
    checks.compare("clip_then_cclip", f"{t} all rows masked (plain)",
                   _cclip_plain(x, radius, none, bidx, s, tau), zero,
                   exact=True)
    return counts


def cclip_shapes(checks):
    """Phase 2's CenteredClip checks at the Fig. 1, odd-n and threshold
    shapes; returns the largest resident d at n = 20 under Bucketing(2)."""
    import torch

    cc = _cc_mod()
    budget = cc.smem_budget(torch.device("cuda"), "cclip")
    print(f"cclip shapes (opt-in shared memory per block: {budget} bytes)")

    def data(n, d, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(n, d, device="cuda", generator=g)
        mask = torch.rand(n, device="cuda", generator=g) > 0.3
        mask[0] = True
        return x, mask, torch.randperm(n, device="cuda", generator=g).int()

    for s in (2, 1):
        check_cclip(checks, *data(20, 40, 50 + s), s, "n=20 d=40",
                    expect="resident")
    for s in (2, 3):
        check_cclip(checks, *data(21, 700, 60 + s), s, "n=21 d=700",
                    expect="resident")
    largest = {}
    for s in (1, 2):
        rows = 20 // s
        d_max = 1
        while cc.resident_smem_bytes(rows, d_max + 1, "cclip") <= budget:
            d_max += 1
        largest[s] = d_max
        for d, expect in ((d_max, "resident"), (d_max + 1, "tiled")):
            check_cclip(checks, *data(20, d, 70 + d), s, f"n=20 d={d}",
                        expect=expect)
    return largest


def time_cclip(x, mask, idx, checks, largest):
    """CenteredClip at the wide shape (checks, then times): cclip_update
    with its library call, the whole tiled call for s = 1 and 2 with its
    launches; cclip_resident at the Fig. 1 shape and at the largest shape
    its rule admits."""
    import torch

    from repro_torch.kernels import ops

    cc = _cc_mod()
    n, d = x.shape
    nb = n // 2
    for s in (1, 2):
        check_cclip(checks, x, mask, idx, s, f"n={n} d={d}", expect="tiled")
    out = {}
    g = torch.Generator(device="cuda").manual_seed(21)
    z = torch.randn(d, device="cuda", generator=g)
    f = torch.rand(n, device="cuda", generator=g)
    sc = torch.rand(n, device="cuda", generator=g) * mask.float()
    den = mask.float().sum().clamp(min=1.0)
    # the library call: z + sum_i s_i (f_i x_i - z) / den = beta z + x^T w
    # with w_i = s_i f_i / den and beta = 1 - sum_i s_i / den, made before
    # the timing; a check of the yardstick, kept out of the kernel's error
    w = sc * f / den
    beta = float(1.0 - sc.sum() / den)
    # rtol 1e-5 of the summands' magnitude |z| + sum_i |w_i x_i|, as the
    # two sum them in different orders
    checks.compare("addmv (library)", f"n={n} d={d} vs cclip_update",
                   torch.addmv(z, x.T, w, beta=beta),
                   cc.cclip_update(x, sc, f, z, den), exact=False,
                   scale=z.abs() + w.abs() @ x.abs())
    t = _row(lambda: cc.cclip_update(x, sc, f, z, den),
             lambda: cc.cclip_update_plain(x, sc, f, z, den),
             lambda: torch.addmv(z, x.T, w, beta=beta))
    t["bound_ms"], t["bound_by"] = _bound(4 * (n * d + 2 * d + 2 * n),
                                          4 * n * d + 2 * d)
    out["cclip_update"] = t

    # cclip_resident at the Fig. 1 shape (its path's) and the largest
    def resident(xr, mr, fr, ir, iters, s=2):
        return cc.cclip_resident(xr, mr, fr, ir, s, iters=iters, tau=1.0)

    def resident_plain(xr, mr, fr, ir, iters, s=2):
        return cc.cclip_resident_plain(xr, mr, fr, ir, s, iters=iters,
                                       tau=1.0)

    t = _time_resident(resident, resident_plain, 40, 2, CCLIP_ITERS, 6,
                       seed=40)
    t["floor_ms"] = _launch_floor_ms()
    t["largest"] = dict(_time_resident(resident, resident_plain, largest[2],
                                       2, CCLIP_ITERS, 6, seed=largest[2]),
                        shape=[20, largest[2], 2])
    out["cclip_resident"] = t
    _print_rows(out, digits=6)
    _print_resident("cclip_resident", t)

    # the whole call, clipped, per schedule, with its launches
    for s in (1, 2):
        rows = n if s == 1 else nb
        moved = (4 * n * d  # pass 1
                 + (4 * (n + nb) * d if s == 2 else 0)  # bucket means
                 + 4 * (rows * d + d)  # v0
                 + CCLIP_ITERS * 4 * (2 * rows * d + 3 * d))  # per step
        bidx = idx if s == 2 else None
        ops.reset_launch_counts()
        ops.clip_then_centered_clip(x, 1.0, mask, bidx, bucket_s=s)
        torch.cuda.synchronize()
        launched = {k: v for k, v in ops.launch_counts().items() if v}
        ms = _time_ms(lambda: ops.clip_then_centered_clip(
            x, 1.0, mask, bidx, bucket_s=s), 5)
        plain = _time_ms(lambda: _cclip_plain(x, 1.0, mask, bidx, s), 3)
        print(f"  clip_then_cclip s={s}  whole call {ms:.4f} ms  launches "
              f"{launched}  schedule bytes {moved / 1e9:.3f} GB -> "
              f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms  function bound "
              f"{4 * (n * d + d) / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)  "
              f"plain {plain:.4f} ms  library none")
    return out


def _cd_mod():
    return sys.modules["repro_torch.kernels.clipped_diff"]


def check_clipped_diff(checks, gn, go, keep, tag):
    """clipped_diff against its plain version: the norm to rtol 1e-6, the
    output bit for bit given the same factor (the plain d rescaled by the
    factor of the kernel's norm)."""
    import torch

    from repro_torch.kernels import ops

    cd = _cd_mod()
    radius = 0.25 * float(gn.numel()) ** 0.5  # clips: ||d|| ~ sqrt(0.6 N)
    scale = 10.0 / 3.0
    got, norm = ops.clipped_diff(gn, go, radius, keep, scale)
    d, psum = cd.clipped_diff_ssq_plain(gn.view(-1), go.view(-1),
                                        keep.view(-1), scale)
    checks.compare("clipped_diff_ssq", f"{tag} norm", norm,
                   torch.sqrt(psum.sum()), exact=False, rtol=NORM_RTOL,
                   atol=0.0)
    kd, _ = cd.clipped_diff_ssq(gn.view(-1), go.view(-1),
                                (keep if keep.dtype == torch.bool
                                 else keep.to(gn.dtype)).view(-1), scale)
    checks.compare("clipped_diff_ssq", f"{tag} d", kd, d, exact=True)
    factor = sys.modules["repro_torch.kernels.clip_aggregate"].clip_factor(
        norm, torch.tensor(radius, device=gn.device))
    checks.compare("clipped_diff_scale", f"{tag} out (same factor)",
                   got.view(-1), cd.clipped_diff_scale_plain(d, factor),
                   exact=True)
    return radius, scale


def time_scale(kd, factor):
    """clipped_diff_scale on 2^24+37 values in f32 and bf16 (d aligned, as
    the entry point makes it), beside its library call: d * f in f32; in
    bf16 torch.mul(d, f.view(1), out=bf16), which multiplies in f32 and
    rounds once, as the kernel does; each held equal to the kernel first.
    The row of the kernels line is f32."""
    import torch

    cd = _cd_mod()
    variants = {}
    kb = kd.bfloat16()
    buf = torch.empty_like(kb)
    for tag, dv, library in (
            ("f32", kd, lambda: kd * factor),
            ("bf16", kb, lambda: torch.mul(kb, factor.view(1), out=buf))):
        got = cd.clipped_diff_scale(dv, factor)
        want = library()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"clipped_diff_scale {tag}: the library call "
                                 "differs from the kernel")
        variants[tag] = _variant(
            lambda: cd.clipped_diff_scale(dv, factor),
            lambda: cd.clipped_diff_scale_plain(dv, factor), library,
            _bound(2 * dv.element_size() * dv.numel() + 4, dv.numel()))
    _print_variants("clipped_diff_scale", variants)
    return dict(variants["f32"], variants=variants)


def time_entry_points(checks, x, mask):
    """The worker-side clipped_diff (sites 13-14) on one vector of
    2^24+37 values and the bucketed coordinate median (site 15) at the
    wide shape: checks (f32 with a bool and a numeric keep mask, bf16),
    the entry-points run whose launches the kernels line reports, and
    kernel, plain and library times."""
    import torch

    from repro_torch.kernels import clip_aggregate as ca
    from repro_torch.kernels import ops

    cd = _cd_mod()
    n, d = x.shape
    g = torch.Generator(device="cuda").manual_seed(31)
    gn = torch.randn(WIDE_D, device="cuda", generator=g)
    go = torch.randn(WIDE_D, device="cuda", generator=g)
    keep = torch.rand(WIDE_D, device="cuda", generator=g) < 0.3
    radius, scale = check_clipped_diff(checks, gn, go, keep,
                                       f"len={WIDE_D} f32 bool keep")
    check_clipped_diff(checks, gn, go, keep.float(),
                       f"len={WIDE_D} f32 f32 keep")
    check_clipped_diff(checks, gn.bfloat16(), go.bfloat16(), keep,
                       f"len={WIDE_D} bf16 bool keep")
    check_clipped_diff(checks, gn[:1001].view(7, 143), go[:1001].view(7, 143),
                       keep[:1001].view(7, 143), "shape (7, 143) f32")
    n_p = n + n % 2
    perm = torch.randperm(n_p, device="cuda", generator=g).int()
    checks.compare("bucketed_cm", f"n={n} d={d} s=2",
                   ops.bucketed_coordinate_median(x, perm, mask.float()),
                   ca.bucketed_cm_plain(x, perm, mask.float(), 2), exact=True)
    xb = x[:, :4133].bfloat16().contiguous()
    checks.compare("bucketed_cm", "n=20 d=4133 s=2 bf16",
                   ops.bucketed_coordinate_median(xb, perm, mask.float()),
                   ca.bucketed_cm_plain(xb, perm, mask.float(), 2)
                   .bfloat16(), exact=True)
    x16 = x[:16, :4133].contiguous()
    perm18 = torch.randperm(18, device="cuda", generator=g).int()
    checks.compare("bucketed_cm", "n=16 d=4133 s=3 (2 padded slots)",
                   ops.bucketed_coordinate_median(x16, perm18, mask[:16], s=3),
                   ca.bucketed_cm_plain(x16, perm18, mask[:16].float(), 3),
                   exact=True)

    # the entry points, through the calls a user makes, counted from 0
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ops.clipped_diff(gn, go, radius, keep, scale)
    ops.bucketed_coordinate_median(x, perm, mask.float())
    torch.cuda.synchronize()
    counts = ops.launch_counts()

    out = {}
    keep_f = keep.float()
    kd, _ = cd.clipped_diff_ssq(gn, go, keep, scale)
    factor = torch.tensor(0.5, device="cuda")
    # bool keep: g_new, g_old (4 bytes), keep (1), d written (4), partials
    t = _row(lambda: cd.clipped_diff_ssq(gn, go, keep, scale),
             lambda: cd.clipped_diff_ssq_plain(gn, go, keep, scale), reps=20,
             plain_reps=5)
    t["bound_ms"], t["bound_by"] = _bound(13 * WIDE_D + 4 * 1024, 5 * WIDE_D)
    out["clipped_diff_ssq"] = t
    t_f = _device_ms(lambda: cd.clipped_diff_ssq(gn, go, keep_f, scale))
    out["clipped_diff_scale"] = time_scale(kd, factor)
    nb = n_p // 2
    # bound over every row, as pass 2's at s = 2: a masked row in a bucket
    # with a kept row is read
    t = _row(lambda: ops.bucketed_coordinate_median(x, perm, mask.float()),
             lambda: ca.bucketed_cm_plain(x, perm, mask.float(), 2))
    t["bound_ms"], t["bound_by"] = _bound(
        4 * n * d + 4 * d + 4 * (n + n_p), (3 * n_p + nb + _select_ops(nb)) * d)
    out["bucketed_cm"] = t
    _print_rows({k: v for k, v in out.items() if k != "clipped_diff_scale"})
    f32_bound, _ = _bound(16 * WIDE_D + 4 * 1024, 5 * WIDE_D)
    print(f"  {'clipped_diff_ssq':18s} with an f32 keep mask: kernel {t_f:.4f}"
          f" ms  bound {f32_bound:.4f} ms (bytes)")
    return out, counts


def _optimum(prob):
    import torch

    x = prob.x0.clone()
    for _ in range(2000):
        x = x - 2.0 * prob.grad(x)
    return float(prob.loss(x)), torch.linalg.vector_norm(prob.grad(x))


_NO_LAUNCHES = {"row_norms": 0, "clip_bucket_select": 0,
                "coordinate_median": 0, "diff_row_ssq": 0, "bucket_means": 0,
                "gm_resident": 0, "gm_update": 0, "gram_matrix": 0,
                "cross_gram": 0, "weighted_row_sum": 0, "select_row": 0,
                "bucketed_cm": 0, "cclip_resident": 0, "cclip_update": 0,
                "clipped_diff_ssq": 0, "clipped_diff_scale": 0}


def _predicted(name, n_diff):
    """Launches per kernel that a run of ``STEPS`` steps with ``n_diff``
    difference rounds makes: g^0 and every full round aggregate without
    clip, every difference round clips (pass 1) and aggregates."""
    n_full = STEPS - n_diff
    if name == "cm-unbucketed":  # the clip goes through pass 2 with s = 1
        return dict(_NO_LAUNCHES, row_norms=n_diff, clip_bucket_select=n_diff,
                    coordinate_median=1 + n_full)
    return dict(_NO_LAUNCHES, row_norms=n_diff if name == "clipped" else 0,
                clip_bucket_select=1 + STEPS)


def main_path():
    """The Fig. 1 runs on the card; returns each run's launch counts."""
    import torch

    from repro_torch.api import AggregatorSpec, ClipSpec, ServerPlan
    from repro_torch.configs.paper import fig1_marina_pp, fig1_problem_kwargs
    from repro_torch.core import ByzVRMarinaPP, logistic_problem
    from repro_torch.kernels import ops

    fig1 = fig1_marina_pp(True)
    runs = {
        "clipped": fig1,
        "unclipped": fig1_marina_pp(False),
        "cm-unbucketed": dataclasses.replace(fig1, plan=ServerPlan(
            aggregate=AggregatorSpec("cm"), clip=ClipSpec(alpha=1.0))),
    }
    prob = logistic_problem(0, device="cuda", **fig1_problem_kwargs())
    cpu_prob = logistic_problem(0, device="cpu", **fig1_problem_kwargs())
    results, counts = {}, {}
    for name, cfg in runs.items():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, met = ByzVRMarinaPP(prob, cfg, device="cuda").run(STEPS)
        torch.cuda.synchronize()
        counts[name] = ops.launch_counts()
        results[name] = (met, time.perf_counter() - t0)

    diff = {k: int((~m["full_round"]).sum()) for k, (m, _) in results.items()}
    full = {k: STEPS - v for k, v in diff.items()}
    f_star, _ = _optimum(cpu_prob)
    print(f"optimum of the data (full-batch GD on the CPU): {f_star:.6f}")
    for name, (met, wall) in results.items():
        loss = met["loss"]
        marks = ", ".join(f"{i + 1}: {float(loss[i]):.6f}"
                          for i in (0, 49, 99, 199, 299))
        print(f"  {name:14s} loss at steps {{{marks}}}  full rounds "
              f"{full[name]}  wall {wall / STEPS * 1e3:.3f} ms/step")
        if not torch.isfinite(loss[:100]).all():
            raise AssertionError(f"{name}: non-finite loss")
        # the plain path on the CPU makes the same draws from the same seeds
        _, ref = ByzVRMarinaPP(cpu_prob, runs[name], device="cpu").run(STEPS)
        agree = 300 if name != "unclipped" else 100
        err = float(((loss[:agree] - ref["loss"][:agree]).abs()
                     / ref["loss"][:agree].abs()).max())
        print(f"  {name:14s} vs the CPU plain path, steps 1-{agree}: "
              f"max rel err {err:.3e} [rtol 1e-4]")
        if err > 1e-4 or not torch.equal(met["full_round"], ref["full_round"]):
            raise AssertionError(f"{name}: the card and the CPU disagree")
    final = {k: float(m["loss"][-1]) for k, (m, _) in results.items()}
    if not (final["clipped"] < 0.64 and final["clipped"] - f_star < 1e-3):
        raise AssertionError(f"clipped run did not converge: {final}")
    if not final["unclipped"] > 5.0:
        raise AssertionError(f"unclipped run did not diverge: {final}")
    for name in runs:
        predicted = _predicted(name, diff[name])
        print(f"  {name:14s} launches {counts[name]}  predicted {predicted}")
        if counts[name] != predicted:
            raise AssertionError(f"{name}: launch counts differ from the "
                                 "prediction")
    return counts


def _compress_predicted(rule, steps, n_diff):
    """Launches of a compressed or CenteredClip Algorithm-1 run: g^0 and
    every step aggregate once over Bucketing(2) (d = 40 or 30: CenteredClip
    takes its resident kernel), every difference round clips (pass 1).
    Compression is elementwise work on the clients' rows, no kernel."""
    agg = "cclip_resident" if rule == "centered_clip" else \
        "clip_bucket_select"
    return dict(_NO_LAUNCHES, row_norms=n_diff, **{agg: 1 + steps})


def compress_path():
    """Phase 3's compressed and CenteredClip runs of Algorithm 1 on the
    card: fig1-randk-{40,20,5} (bench_ablation.py's sweep, 400 steps),
    fig1-cclip, fig1-theory (300 steps) and the reference's
    test_compression_still_converges problem (d = 30, 400 steps).  Each
    agrees with the CPU plain path at rtol 1e-4 and launches what its own
    coins predict.  Returns each run's launch counts."""
    import torch

    from repro_torch.api import (AggregatorSpec, BucketSpec, ClipSpec,
                                 CompressSpec, ScheduleSpec, ServerPlan)
    from repro_torch.configs.paper import (fig1_marina_pp, fig1_problem_kwargs,
                                           paper_plan)
    from repro_torch.core import (ByzVRMarinaPP, MarinaPPConfig,
                                  logistic_problem)
    from repro_torch.kernels import ops

    fig1 = fig1_marina_pp(True)
    problems = {  # kwargs, optimum on the CPU
        "fig1": (fig1_problem_kwargs(), lambda p: _optimum(p)[0]),
        "d30": (dict(n_clients=20, n_good=15, m=200, dim=30,
                     homogeneous=True), _optimum_d30),
    }

    def plan_cfg(plan):
        return lambda prob, dev: ByzVRMarinaPP(
            prob, dataclasses.replace(fig1, plan=plan), device=dev)

    def theory(prob, dev):
        return ByzVRMarinaPP.from_theory(
            prob, C=4, C_hat=20, p=0.2, delta=0.25, theorem="4.2",
            aggregator="centered_clip", compressor="rand_k",
            compressor_kwargs=(("k", 10),), attack="shb", device=dev)

    def d30_run(prob, dev):  # tests/test_marina_pp.py's _run settings
        return ByzVRMarinaPP(prob, MarinaPPConfig(
            gamma=0.5, p=0.2, C=4, C_hat=20, batch=32, attack="shb", seed=1,
            plan=ServerPlan(aggregate=AggregatorSpec("cm"),
                            clip=ClipSpec(alpha=1.0),
                            compress=CompressSpec("rand_k", k=10),
                            bucket=BucketSpec(s=2),
                            schedule=ScheduleSpec(backend="auto"))),
            device=dev)

    runs = {  # name: (problem, engine factory, steps, rule)
        **{f"fig1-randk-{k}": ("fig1", plan_cfg(
            dataclasses.replace(paper_plan("cm", 1.0),
                                compress=CompressSpec("rand_k", k=k))),
            RANDK_STEPS, "cm") for k in RANDK_KS},
        "fig1-cclip": ("fig1", plan_cfg(paper_plan("centered_clip", 1.0)),
                       STEPS, "centered_clip"),
        "fig1-theory": ("fig1", theory, STEPS, "centered_clip"),
        "d30-randk-10": ("d30", d30_run, RANDK_STEPS, "cm"),
    }
    optima = {k: opt(logistic_problem(0, device="cpu", **kw))
              for k, (kw, opt) in problems.items()}
    print("optima of the data (GD on the CPU): "
          + ", ".join(f"{k} {v:.6f}" for k, v in optima.items()))
    counts, final = {}, {}
    for name, (pname, make, steps, rule) in runs.items():
        kw = problems[pname][0]
        f_star = optima[pname]
        prob = logistic_problem(0, device="cuda", **kw)
        algo = make(prob, "cuda")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, met = algo.run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = ops.launch_counts()
        loss = met["loss"]
        cpu = logistic_problem(0, device="cpu", **kw)
        final[name] = (float(loss[0]), float(loss[-1]), f_star)
        marks = ", ".join(f"{i + 1}: {float(loss[i]):.6f}"
                          for i in (0, 99, 199, steps - 1))
        print(f"  {name:14s} loss at steps {{{marks}}}  gap to the optimum "
              f"{float(loss[-1]) - f_star:.3e}  wall {wall / steps * 1e3:.3f}"
              f" ms/step" + (f"  gamma {algo.cfg.gamma:.6f} alpha "
                             f"{algo.plan.clip.alpha:.6f}"
                             if name == "fig1-theory" else ""))
        if not torch.isfinite(loss).all():
            raise AssertionError(f"{name}: non-finite loss")
        # the plain path on the CPU makes the same draws from the same seeds
        _, ref = make(cpu, "cpu").run(steps)
        err = float(((loss - ref["loss"]).abs() / ref["loss"].abs()).max())
        print(f"  {name:14s} vs the CPU plain path, steps 1-{steps}: max rel "
              f"err {err:.3e} [rtol 1e-4]; CPU final "
              f"{float(ref['loss'][-1]):.6f}")
        if err > 1e-4 or not torch.equal(met["full_round"], ref["full_round"]):
            raise AssertionError(f"{name}: the card and the CPU disagree")
        n_diff = int((~met["full_round"]).sum())
        predicted = _compress_predicted(rule, steps, n_diff)
        print(f"  {name:14s} launches {counts[name]}  predicted {predicted}")
        if counts[name] != predicted:
            raise AssertionError(f"{name}: launch counts differ from the "
                                 "prediction")
    for name, (first, last, f_star) in final.items():
        if name == "fig1-theory":
            ok = last < first  # the reference's criterion for from_theory
        elif name == "d30-randk-10":
            ok = last - f_star < 2e-2  # test_compression_still_converges
        else:
            ok = last - f_star < SWEEP_GAP_BELOW
        if not ok:
            raise AssertionError(f"{name} did not converge: first {first}, "
                                 f"last {last}, optimum {f_star}")
    return counts


def _optimum_d30(prob):
    """The reference's optimum of its d = 30 problem: 3,000 GD steps of
    0.5 (tests/test_marina_pp.py ``fstar``)."""
    x = prob.x0.clone()
    for _ in range(3000):
        x = x - 0.5 * prob.grad(x)
    return float(prob.loss(x))


def _fig2_predicted(name):
    """Launches per kernel of a Fig. 2 run: g^0 and every step aggregate
    once, every clipped step (the 3.4e37 warm-up step 0 too) runs pass 1.
    d = 698 fits the resident kernel; d = 101,770 under Bucketing(2) takes
    one bucket_means pass, z0 and 8 Weiszfeld steps of diff_row_ssq +
    gm_update per call."""
    if name == "fig2-rfa-wide":
        calls = WIDE_STEPS + 1
        return dict(_NO_LAUNCHES, row_norms=WIDE_STEPS, bucket_means=calls,
                    diff_row_ssq=GM_ITERS * calls,
                    gm_update=(GM_ITERS + 1) * calls)
    clipped = name != "fig2-rfa-unbucketed-noclip"
    return dict(_NO_LAUNCHES, row_norms=STEPS if clipped else 0,
                gm_resident=STEPS + 1)


def fig2_path():
    """The Fig. 2 runs on the card; returns each run's launch counts."""
    import torch

    from repro_torch.api import AggregatorSpec, ClipSpec, ServerPlan
    from repro_torch.configs.paper import fig2_heuristic, fig2_problem_kwargs
    from repro_torch.core import (ClippedPPConfig, ClippedPPMomentum,
                                  mlp_problem)
    from repro_torch.kernels import ops

    def unbucketed(clip):
        return ClippedPPConfig(gamma=0.15, C=3, attack="shb", plan=ServerPlan(
            aggregate=AggregatorSpec("rfa"),
            clip=ClipSpec(alpha=1.0) if clip else None))

    fig2 = (0, fig2_problem_kwargs("shb"))
    runs = {  # name: (problem seed and kwargs, config, steps)
        "fig2-rfa": (fig2, fig2_heuristic("rfa", "shb", True), STEPS),
        "fig2-rfa-unbucketed-clip": ((5, MAJORITY), unbucketed(True), STEPS),
        "fig2-rfa-unbucketed-noclip": ((5, MAJORITY), unbucketed(False),
                                       STEPS),
        "fig2-rfa-wide": ((0, dict(fig2_problem_kwargs("shb"), in_dim=784,
                                   hidden=128)),
                          fig2_heuristic("rfa", "shb", True), WIDE_STEPS),
    }
    counts, final = {}, {}
    for name, ((seed, kw), cfg, steps) in runs.items():
        prob = mlp_problem(seed, device="cuda", **kw)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, met = ClippedPPMomentum(prob, cfg, device="cuda").run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = ops.launch_counts()
        loss = met["loss"]
        final[name] = float(loss[-1])
        marks = ", ".join(f"{i + 1}: {float(loss[i]):.6f}"
                          for i in (0, 49, 99, 199, 299) if i < steps)
        print(f"  {name:26s} d={prob.dim} loss at steps {{{marks}}}  wall "
              f"{wall / steps * 1e3:.3f} ms/step")
        # the plain path on the CPU makes the same draws from the same seeds
        cpu = mlp_problem(seed, device="cpu", **kw)
        _, ref = ClippedPPMomentum(cpu, cfg, device="cpu").run(steps)
        agree = 100 if name.endswith("noclip") else steps
        if not torch.isfinite(loss[:agree]).all():
            raise AssertionError(f"{name}: non-finite loss")
        err = float(((loss[:agree] - ref["loss"][:agree]).abs()
                     / ref["loss"][:agree].abs()).max())
        print(f"  {name:26s} vs the CPU plain path, steps 1-{agree}: max rel "
              f"err {err:.3e} [rtol 1e-4]; CPU final {float(ref['loss'][-1]):.6f}")
        if err > 1e-4:
            raise AssertionError(f"{name}: the card and the CPU disagree")
        predicted = _fig2_predicted(name)
        print(f"  {name:26s} launches {counts[name]}  predicted {predicted}")
        if counts[name] != predicted:
            raise AssertionError(f"{name}: launch counts differ from the "
                                 "prediction")
    if not final["fig2-rfa-unbucketed-clip"] < CLIPPED_BELOW:
        raise AssertionError(f"clipped unbucketed run ended at "
                             f"{final['fig2-rfa-unbucketed-clip']}, not below "
                             f"{CLIPPED_BELOW}")
    if not final["fig2-rfa-unbucketed-noclip"] > UNCLIPPED_ABOVE:
        raise AssertionError(f"unclipped unbucketed run ended at "
                             f"{final['fig2-rfa-unbucketed-noclip']}, not "
                             f"above {UNCLIPPED_ABOVE}")
    return counts


SERVE_RUNS = (  # name, rule, bucket_s, radius, arrival, rounds, dim
    ("serve-krum-steady", "krum", 0, 5.0, "steady", 8, 4096),
    ("serve-krum-burst", "krum", 0, 5.0, "burst", 8, 4096),
    ("serve-multikrum-bucketed", "multi_krum", 2, 5.0, "steady", 8, 4096),
    ("serve-cm", "cm", 0, None, "steady", 8, 4096),
    ("serve-krum-wide", "krum", 0, 5.0, "steady", 4, 1 << 20),
    ("serve-cclip", "centered_clip", 0, 5.0, "steady", 8, 4096),
)
SERVE_SLOTS, SERVE_BYZ, SERVE_COHORT, SERVE_SEED = 16, 4, 12, 0


class _Audit:
    """An ``on_close`` hook that records, at every close, the round's
    selection (winner and the rows of non-zero weight) and, when asked,
    the one-shot ServerStep on the assembled buffer and mask."""

    def __init__(self, one_shot):
        self.one_shot = one_shot
        self.server = None
        self.records = []

    def __call__(self, result, state):
        import torch

        from repro_torch.serve import round_key

        srv = self.server
        ex = srv.executor
        buf, arrived, stats = state
        picked = once = None
        if ex.two_phase:  # (n, n) algebra only: no kernel launches
            sel = ex.aggregator.finalize(
                stats, mask=arrived,
                key=round_key(srv.config.seed, result.round_id),
                radius=ex.radius)
            picked = (int(sel.winner),
                      tuple(torch.nonzero(sel.weights).flatten().tolist()))
        if self.one_shot:
            once = ex.step(buf, mask=arrived,
                           key=round_key(srv.config.seed, result.round_id))
            once = once.cpu().numpy()
        self.records.append((result, picked, once))


def _audited(plan, cfg, device, one_shot=False, clock=None):
    """An AggregationServer with an _Audit on its closes."""
    from repro_torch.serve import AggregationServer

    audit = _Audit(one_shot)
    audit.server = AggregationServer(plan, cfg, device=device, clock=clock,
                                     on_close=audit)
    return audit


def _serve_predicted(rule, bucket_s, rounds, chunks):
    """Launches of a checked serve run: one cross-Gram per chunk; per
    round one apply at the close and one Gram + apply for the one-shot
    check; CM closes (and checks) through the standalone CM kernel.
    CenteredClip at n = 16, d = 4,096 (262 KB of rows) takes the tiled
    schedule at every close and check: pass 1, v0 and CCLIP_ITERS steps
    of diff_row_ssq + cclip_update."""
    if rule == "cm":
        return dict(_NO_LAUNCHES, coordinate_median=2 * rounds)
    if rule == "centered_clip":
        return dict(_NO_LAUNCHES, row_norms=2 * rounds,
                    diff_row_ssq=2 * CCLIP_ITERS * rounds,
                    cclip_update=2 * (CCLIP_ITERS + 1) * rounds)
    apply = "select_row" if rule == "krum" and bucket_s < 2 \
        else "weighted_row_sum"
    return dict(_NO_LAUNCHES, cross_gram=chunks, gram_matrix=rounds,
                **{apply: 2 * rounds})


def serve_path():
    """Phase 5: the streaming server on the card; returns each run's
    launch counts and its rows/s and latency."""
    import numpy as np
    import torch

    from repro_torch.api import (AggregatorSpec, BucketSpec, ClipSpec,
                                 ScheduleSpec, ServerPlan)
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import latency_ms, run_stream
    from repro_torch.scenarios import SyntheticCohort
    from repro_torch.serve import AggregationServer, ServeConfig

    counts, rates = {}, {}
    for name, rule, bucket_s, radius, arrival, rounds, dim in SERVE_RUNS:
        plan = ServerPlan(
            aggregate=AggregatorSpec(rule, byz_bound=SERVE_BYZ),
            clip=ClipSpec(radius=radius) if radius else None,
            bucket=BucketSpec(s=bucket_s) if bucket_s else None,
            schedule=ScheduleSpec(placement="naive", backend="auto"))
        cfg = ServeConfig(n_slots=SERVE_SLOTS, dim=dim,
                          cohort_size=SERVE_COHORT, seed=SERVE_SEED)
        per = SERVE_COHORT if arrival == "burst" else 1

        def drive(server):
            cohort = SyntheticCohort("alie", n_slots=SERVE_SLOTS, dim=dim,
                                     n_byz=SERVE_BYZ)
            return run_stream(server, cohort, rounds=rounds, seed=SERVE_SEED,
                              rows_per_pump=per)

        card = _audited(plan, cfg, "cuda", one_shot=True)
        if not card.server.executor.kernels:
            raise AssertionError(f"{name}: the executor did not take the "
                                 "kernel form on the card")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        drive(card.server)
        torch.cuda.synchronize()
        counts[name] = ops.launch_counts()
        cpu = _audited(plan, cfg, "cpu")
        drive(cpu.server)
        timed = AggregationServer(plan, cfg, device="cuda")
        tickets, wall = drive(timed)
        lat = latency_ms(tickets)
        rates[name] = dict(rows_per_s=timed.metrics.rows_ingested / wall,
                           **lat)

        worst = 0.0
        for server in (card.server, cpu.server, timed):
            m = server.metrics
            if (m.rounds_closed != rounds or m.executor_faults
                    or m.rounds_degraded):
                raise AssertionError(f"{name}: {m.snapshot()}")
        for (rc, pc, once), (rp, pp, _), rt in zip(card.records, cpu.records,
                                                    _closed(tickets)):
            if not np.array_equal(once, rc.aggregate):
                raise AssertionError(f"{name} round {rc.round_id}: the close "
                                     "differs from the one-shot ServerStep")
            if not np.array_equal(rt, rc.aggregate):
                raise AssertionError(f"{name} round {rc.round_id}: the timed "
                                     "run closed another aggregate")
            if (rc.round_id, rc.close_reason, rc.cohort_fill) != \
                    (rp.round_id, rp.close_reason, rp.cohort_fill) \
                    or pc != pp:
                raise AssertionError(f"{name} round {rc.round_id}: card "
                                     f"{pc} vs CPU {pp}")
            err = np.abs(rc.aggregate - rp.aggregate)
            if not np.all(err <= 1e-7 + 1e-5 * np.abs(rp.aggregate)):
                raise AssertionError(f"{name} round {rc.round_id}: card and "
                                     "CPU aggregates differ")
            worst = max(worst, float((err / np.maximum(
                np.abs(rp.aggregate), 1e-30)).max()))
        predicted = _serve_predicted(rule, bucket_s, rounds,
                                     card.server.metrics.chunks_ingested)
        picks = [p for _, p, _ in card.records]
        print(f"  {name:25s} d={dim} rounds {rounds} bitwise == one-shot: ok;"
              f" vs CPU max rel err {worst:.3e} [rtol 1e-5], same winners")
        print(f"  {name:25s} winners (row, rows of non-zero weight) "
              f"{picks[:3]}{' ...' if len(picks) > 3 else ''}")
        print(f"  {name:25s} launches {counts[name]}  predicted {predicted}")
        print(f"  {name:25s} {rates[name]['rows_per_s']:.1f} rows/s  p50 "
              f"{rates[name]['p50_ms']:.3f} ms  p99 {rates[name]['p99_ms']:.3f}"
              f" ms ({len(tickets)} rows, {wall:.3f} s, unchecked run)")
        if counts[name] != predicted:
            raise AssertionError(f"{name}: launch counts differ from the "
                                 "prediction")
    return counts, rates


def _closed(tickets):
    """The aggregates of a finished run's rounds, in round order."""
    seen = {}
    for t in tickets:
        if t.done:
            seen[t.result.round_id] = t.result.aggregate
    return [seen[k] for k in sorted(seen)]


ADAPTIVE_BUDGET = 8  # ScenarioSpec(attack="adaptive", budget=8)
PIN = dict(n=12, n_byz=4, d=8, budget=16, radius=0.5)  # tests/test_scenarios.py
# matrix-smoke's gaps: f32 rounding units of the final loss allowed beside
# rtol 1e-4 (the card and the CPU gave one unit apart at a gap of 2.7e-4)
GAP_ULPS = 4


def adaptive_grad(checks):
    """The kernel-backed ``differentiable_aggregate`` against the plain
    shadow on the same inputs and order: at the Fig. 1 shape (CM over
    Bucketing(2), clipped) and the Fig. 2 shape (RFA over Bucketing(2),
    clipped).  The forward within rtol 1e-5 of the shadow (the CM also
    exactly equal to pass 2's plain version given the kernel's clip
    factors: the shadow clips the rows before it takes the bucket means,
    which rounds differently), the gradient within rtol 1e-5, finite and
    not zero, and the kernel path went through the Function."""
    import torch

    from repro_torch.api import (AggregatorSpec, BucketSpec, ClipSpec,
                                 ScheduleSpec, ServerPlan)
    from repro_torch.core.aggregators import _bucket_order
    from repro_torch.kernels.clip_aggregate import (clip_bucket_select_plain,
                                                    clip_factor, row_norms,
                                                    row_norms_plain)
    from repro_torch.scenarios import (differentiable_aggregate,
                                       torch_shadow_plan)

    for tag, rule, d, kernel in (("fig1", "cm", 40, "clip_bucket_select"),
                                 ("fig2", "rfa", 698, "gm_resident")):
        g = torch.Generator(device="cuda").manual_seed(d)
        x = torch.randn(20, d, device="cuda", generator=g)
        mask = torch.zeros(20, dtype=torch.bool, device="cuda")
        mask[torch.randperm(20, device="cuda", generator=g)[:12]] = True
        w = torch.randn(d, device="cuda", generator=g)
        order = torch.randperm(20, generator=torch.Generator().manual_seed(d))
        radius = row_norms_plain(x).median()  # clips about half the rows
        plan = ServerPlan(aggregate=AggregatorSpec(rule),
                          clip=ClipSpec(alpha=1.0), bucket=BucketSpec(s=2),
                          schedule=ScheduleSpec(backend="auto"))
        outs, grads = [], []
        for p in (plan, torch_shadow_plan(plan)):
            m = x.clone().requires_grad_(True)
            out = differentiable_aggregate(p)(m, mask=mask, key=order,
                                              radius=radius)
            through = type(out.grad_fn).__name__ == "KernelForwardBackward"
            if through != (p is plan):
                raise AssertionError(f"adaptive-grad {tag}: the kernel path "
                                     "did not go through KernelForward")
            (gr,) = torch.autograd.grad((out * w).sum(), m)
            outs.append(out.detach())
            grads.append(gr)
        checks.compare(kernel, f"adaptive-grad {tag} forward", outs[0],
                       outs[1], exact=False)
        if rule == "cm":
            factors = clip_factor(row_norms(x), radius)  # pass 1's
            checks.compare(kernel, f"adaptive-grad {tag} forward, same "
                           "factors", outs[0], clip_bucket_select_plain(
                               x, factors, mask.float(),
                               _bucket_order(order, mask, 20, x.device), 2,
                               -1.0), exact=True)
        checks.compare(kernel, f"adaptive-grad {tag} gradient", grads[0],
                       grads[1], exact=False, atol=0.0)
        if not (torch.isfinite(grads[0]).all() and grads[0].abs().sum() > 0):
            raise AssertionError(f"adaptive-grad {tag}: the gradient is not "
                                 "finite and non-zero")


def _pin_deviation(rule, clip, device):
    """The reference pin's measure (tests/test_scenarios.py): the
    aggregate's distance from the good mean under the adaptive adversary
    optimised against this plan, on ``device``."""
    import numpy as np
    import torch

    from repro_torch.api import (AggregatorSpec, ClipSpec, ScenarioSpec,
                                 ScheduleSpec, ServerPlan)
    from repro_torch.scenarios import AttackStage, make_context

    n, n_byz, d = PIN["n"], PIN["n_byz"], PIN["d"]
    rng = np.random.RandomState(3)
    mu = (0.1 * rng.randn(d)).astype(np.float32)
    honest = torch.from_numpy(
        mu[None] + 0.05 * rng.randn(n, d).astype(np.float32)).to(device)
    good = torch.arange(n, device=device) < n - n_byz
    plan = ServerPlan(
        aggregate=AggregatorSpec(rule, byz_bound=n_byz),
        clip=ClipSpec(radius=PIN["radius"]) if clip else None,
        schedule=ScheduleSpec(backend="auto"))
    ctx = make_context(honest, good_mask=good,
                       sampled=torch.ones(n, dtype=torch.bool, device=device),
                       key=torch.Generator().manual_seed(1))
    attack = ScenarioSpec(attack="adaptive",
                          budget=PIN["budget"]).build(plan)
    out = plan.build()(AttackStage(attack).corrupt(ctx), mask=ctx.sampled,
                       key=ctx.key)
    return float(torch.linalg.vector_norm(out - honest[good].mean(0)))


def adaptive_pin():
    """The reference's acceptance pin on the card: mean without a clip
    deviates by more than 0.6; cm, rfa and centered_clip with the clip
    each by less than 0.3, and mean by more than 2.5 times each.  Each
    server call and each ascent step launches its rule's kernels once."""
    import torch

    from repro_torch.kernels import ops

    cases = (("mean", False), ("cm", True), ("rfa", True),
             ("centered_clip", True))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    dev = {rule: _pin_deviation(rule, clip, "cuda") for rule, clip in cases}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    cpu = {rule: _pin_deviation(rule, clip, "cpu") for rule, clip in cases}
    print("  adaptive-pin deviation from the good mean: " + ", ".join(
        f"{r} {v:.6f} (CPU {cpu[r]:.6f})" for r, v in dev.items()))
    if not dev["mean"] > 0.6:
        raise AssertionError(f"adaptive-pin: mean deviates {dev['mean']}")
    for rule, _ in cases[1:]:
        if not (dev[rule] < 0.3 and dev["mean"] > 2.5 * dev[rule]):
            raise AssertionError(f"adaptive-pin: {rule} deviates "
                                 f"{dev[rule]} (mean {dev['mean']})")
    calls = PIN["budget"] + 1  # the ascent steps and the server's call
    predicted = dict(_NO_LAUNCHES, coordinate_median=calls,
                     row_norms=3 * calls, clip_bucket_select=calls,
                     gm_resident=calls, cclip_resident=calls)
    print(f"  adaptive-pin launches {counts}  predicted {predicted}")
    if counts != predicted:
        raise AssertionError("adaptive-pin: launch counts differ from the "
                             "prediction")
    return {"adaptive-pin": counts}


def _adaptive_predicted(name, n_diff):
    """Launches of an adaptive run of STEPS steps: g^0 once, every round
    ADAPTIVE_BUDGET ascent steps (one kernel forward each, the backward
    being the plain shadow) against the clip the adversary models, and
    the server's own call (a difference round clips, a full round of
    Algorithm 1 does not; the heuristic clips every round)."""
    calls = STEPS * ADAPTIVE_BUDGET
    if name == "adaptive-fig2":
        return dict(_NO_LAUNCHES, row_norms=calls + STEPS,
                    gm_resident=1 + calls + STEPS)
    if name == "adaptive-fig1-clipped":
        return dict(_NO_LAUNCHES, row_norms=calls + n_diff,
                    clip_bucket_select=1 + calls + STEPS)
    return dict(_NO_LAUNCHES, clip_bucket_select=1 + calls + STEPS)


def _timed_attack(algo):
    """Wrap the engine's attack so that its host wall time, from a
    synchronised start to a synchronised end, adds up in the returned
    list's one entry."""
    import torch

    spent = [0.0]
    inner = algo.attack_stage.attack

    def timed(ctx):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(ctx)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    algo.attack_stage.attack = dataclasses.replace(inner, fn=timed)
    return spent


def adaptive_runs():
    """Fig. 1 (clipped and unclipped) and Fig. 2 under ``ScenarioSpec(
    attack="adaptive", budget=8)``, 300 steps each on "cuda" with backend
    "auto": launches equal to each run's prediction, the card within
    rtol 1e-4 of the CPU plain path on the same draws, the wall ms per
    step and the adversary's share of it."""
    import torch

    from repro_torch.api import ScenarioSpec
    from repro_torch.configs.paper import (fig1_marina_pp,
                                           fig1_problem_kwargs,
                                           fig2_heuristic,
                                           fig2_problem_kwargs)
    from repro_torch.core import (ByzVRMarinaPP, ClippedPPMomentum,
                                  logistic_problem, mlp_problem)
    from repro_torch.kernels import ops

    spec = ScenarioSpec(attack="adaptive", budget=ADAPTIVE_BUDGET)
    fig1 = (lambda dev: logistic_problem(0, device=dev,
                                         **fig1_problem_kwargs()))
    fig2 = (lambda dev: mlp_problem(0, device=dev,
                                    **fig2_problem_kwargs("shb")))
    runs = {  # name: (problem, engine, config)
        "adaptive-fig1-clipped": (fig1, ByzVRMarinaPP, dataclasses.replace(
            fig1_marina_pp(True), scenario=spec)),
        "adaptive-fig1-unclipped": (fig1, ByzVRMarinaPP, dataclasses.replace(
            fig1_marina_pp(False), scenario=spec)),
        "adaptive-fig2": (fig2, ClippedPPMomentum, dataclasses.replace(
            fig2_heuristic("rfa", "shb", True), scenario=spec)),
    }
    counts, final = {}, {}
    for name, (problem, engine, cfg) in runs.items():
        algo = engine(problem("cuda"), cfg, device="cuda")
        spent = _timed_attack(algo)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, met = algo.run(STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = ops.launch_counts()
        loss = met["loss"]
        final[name] = float(loss[-1])
        marks = ", ".join(f"{i + 1}: {float(loss[i]):.6f}"
                          for i in (0, 49, 99, 199, 299))
        print(f"  {name:24s} loss at steps {{{marks}}}  wall "
              f"{wall / STEPS * 1e3:.3f} ms/step, the adversary "
              f"{spent[0] / STEPS * 1e3:.3f} ms/step "
              f"({spent[0] / wall:.1%})")
        if not torch.isfinite(loss).all():
            raise AssertionError(f"{name}: non-finite loss")
        # the plain path on the CPU makes the same draws from the same seeds
        _, ref = engine(problem("cpu"), cfg, device="cpu").run(STEPS)
        err = float(((loss - ref["loss"]).abs() / ref["loss"].abs()).max())
        print(f"  {name:24s} vs the CPU plain path, steps 1-{STEPS}: max rel "
              f"err {err:.3e} [rtol 1e-4]; CPU final "
              f"{float(ref['loss'][-1]):.6f}")
        if err > 1e-4:
            raise AssertionError(f"{name}: the card and the CPU disagree")
        full = met.get("full_round")
        if full is not None and not torch.equal(full, ref["full_round"]):
            raise AssertionError(f"{name}: the card and the CPU drew apart")
        n_diff = STEPS - int(full.sum()) if full is not None else STEPS
        predicted = _adaptive_predicted(name, n_diff)
        print(f"  {name:24s} launches {counts[name]}  predicted {predicted}")
        if counts[name] != predicted:
            raise AssertionError(f"{name}: launch counts differ from the "
                                 "prediction")
    # the port's CPU run shows no separation of the clipped and unclipped
    # Fig. 1 runs under this adversary (0.638186 and 0.637542 after 300
    # steps), so no threshold is set
    print("  adaptive-fig1 final losses: clipped "
          f"{final['adaptive-fig1-clipped']:.6f}, unclipped "
          f"{final['adaptive-fig1-unclipped']:.6f} (no threshold: no "
          "separation on the CPU)")
    return counts


def matrix_smoke():
    """SMOKE_GRID (24 cells, 250 steps, d = 30) on "cuda" with backend
    "auto" and on the CPU, on the same draws: every verdict and so the
    breakdown map equal, every finite gap below 1 within rtol 1e-4 plus
    GAP_ULPS units of f32 rounding of the loss (the gap is the difference
    of two f32 losses near 0.5, each rounded; the card and the CPU sum
    the loss in other orders), the wide-margin outcomes (cm.shb.clip and
    mean.shb.clip at 1.0, mean.gauss.* at 0.1, every noclip curve at or
    below 0.45), and the launches of each cell's own coins."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.scenarios import (SMOKE_GRID, breakdown_points,
                                       collect_resilience)

    grid = SMOKE_GRID
    card, cpu = [], []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    collect_resilience(grid, progress=card.append, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    collect_resilience(grid, progress=cpu.append, device="cpu")
    print(f"  matrix-smoke: {len(card)} cells of {grid.steps} steps in "
          f"{wall:.3f} s on the card "
          f"({wall / len(card) / grid.steps * 1e3:.3f} ms/step)")
    worst = worst_ulps = 0.0
    for a, b in zip(card, cpu):
        if (a["key"], a["byz_frac"]) != (b["key"], b["byz_frac"]):
            raise AssertionError("matrix-smoke: the cells differ in order")
        if a["converged"] != b["converged"] or \
                a["full_rounds"] != b["full_rounds"]:
            raise AssertionError(f"matrix-smoke: {a['key']}@{a['byz_frac']} "
                                 f"card {a} CPU {b}")
        if math.isfinite(b["gap"]) and abs(b["gap"]) < 1.0:
            err = abs(a["gap"] - b["gap"])
            ulp = float(np.spacing(np.float32(b["final"])))
            worst = max(worst, err / abs(b["gap"]))
            worst_ulps = max(worst_ulps, err / ulp)
            if err > 1e-4 * abs(b["gap"]) + GAP_ULPS * ulp:
                raise AssertionError(
                    f"matrix-smoke: {a['key']}@{a['byz_frac']} gap card "
                    f"{a['gap']!r} CPU {b['gap']!r}")
    bmap = breakdown_points(card)
    if bmap != breakdown_points(cpu):
        raise AssertionError("matrix-smoke: the breakdown maps differ")
    print(f"  matrix-smoke gaps below 1: card vs CPU max rel err "
          f"{worst:.3e}, max err {worst_ulps:.1f} f32 units of the loss "
          f"[rtol 1e-4 + {GAP_ULPS} units]")
    print("  breakdown points (card = CPU): " + json.dumps(bmap))
    wide = {k: v for k, v in bmap.items()
            if (k.startswith(("cm.shb.clip", "mean.shb.clip")) and v != 1.0)
            or (k.startswith("mean.gauss.") and v != 0.1)
            or (".noclip." in k and v > 0.45)}
    if wide:
        raise AssertionError(f"matrix-smoke: wide-margin outcomes fail: "
                             f"{wide}")
    n_diff = sum(grid.steps - c["full_rounds"] for c in card
                 if ".clip." in c["key"])
    predicted = dict(_NO_LAUNCHES, row_norms=n_diff,
                     clip_bucket_select=len(card) * (grid.steps + 1))
    print(f"  matrix-smoke launches {counts}  predicted {predicted}")
    if counts != predicted:
        raise AssertionError("matrix-smoke: launch counts differ from the "
                             "prediction")
    return {"matrix-smoke": counts}


def scenario_path(checks):
    """Phase 6: the adversarial scenarios on the card; returns each
    run's launch counts."""
    print("adaptive-grad: the kernel forward against the plain shadow")
    adaptive_grad(checks)
    counts = adaptive_pin()
    counts.update(adaptive_runs())
    counts.update(matrix_smoke())
    return counts


# ---------------------------------------------------------------------------
# phase 7: faults, recovery, scoring
# ---------------------------------------------------------------------------

SERVE_DIM = 4096
CHAOS_ROUNDS, CHAOS_FAULT_SEED, CHAOS_DEADLINE = 8, 11, 1.2
RESUME_ROUNDS, RESUME_SLEEP_MS, RESUME_KILL_AFTER = 8, 60.0, 3
SCORE_REQUESTS = 8
PROC_TIMEOUT = 300  # seconds for any one stream subprocess


class _Clock:
    """The injected serve clock: 0.1 s a pump, so deadline closes are
    the same on the card and the CPU (the wall clock would differ)."""

    def __init__(self):
        self.t = 0.0

    def tick(self, cursor, closed):
        self.t += 0.1

    def __call__(self):
        return self.t


def _serve_plan(rule, radius):
    from repro_torch.api import (AggregatorSpec, ClipSpec, ScheduleSpec,
                                 ServerPlan)

    return ServerPlan(
        aggregate=AggregatorSpec(rule, byz_bound=SERVE_BYZ),
        clip=ClipSpec(radius=radius) if radius else None,
        schedule=ScheduleSpec(placement="naive", backend="auto"))


def _fault_run(fault_plan, device, deadline=None):
    """Krum at the serve size behind a FaultInjector, driven by
    ``run_stream`` on the injected clock for CHAOS_ROUNDS rounds; returns
    (audit, injector, launch counts, wall seconds)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_stream
    from repro_torch.scenarios import SyntheticCohort
    from repro_torch.serve import FaultInjector, ServeConfig

    clock = _Clock()
    cfg = ServeConfig(n_slots=SERVE_SLOTS, dim=SERVE_DIM,
                      cohort_size=SERVE_COHORT, deadline=deadline,
                      seed=SERVE_SEED)
    audit = _audited(_serve_plan("krum", 5.0), cfg, device, clock=clock)
    inj = FaultInjector(fault_plan, audit.server)
    cohort = SyntheticCohort("alie", n_slots=SERVE_SLOTS, dim=SERVE_DIM,
                             n_byz=SERVE_BYZ)
    if device == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run_stream(inj, cohort, rounds=CHAOS_ROUNDS, seed=SERVE_SEED,
               on_pump=clock.tick)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for r, _, _ in audit.records:
        if not np.all(np.isfinite(r.aggregate)):
            raise AssertionError(f"round {r.round_id}: a non-finite aggregate")
    return audit, inj, counts, wall


def _same_rounds(name, card, cpu, check_picks=True):
    """Card and CPU closed the same rounds (ids, reasons, fills, degraded
    and fallback reasons, Krum winners) with aggregates within rtol 1e-5;
    returns the worst relative error."""
    import numpy as np

    if len(card.records) != len(cpu.records):
        raise AssertionError(f"{name}: {len(card.records)} rounds on the "
                             f"card, {len(cpu.records)} on the CPU")
    worst = 0.0
    for (rc, pc, _), (rp, pp, _) in zip(card.records, cpu.records):
        key_c = (rc.round_id, rc.close_reason, rc.cohort_fill, rc.degraded,
                 rc.fallback_reason)
        key_p = (rp.round_id, rp.close_reason, rp.cohort_fill, rp.degraded,
                 rp.fallback_reason)
        if key_c != key_p or (check_picks and pc != pp):
            raise AssertionError(f"{name}: card {key_c} {pc} vs CPU {key_p} "
                                 f"{pp}")
        err = np.abs(rc.aggregate - rp.aggregate)
        if not np.all(err <= 1e-7 + 1e-5 * np.abs(rp.aggregate)):
            raise AssertionError(f"{name} round {rc.round_id}: card and CPU "
                                 "aggregates differ")
        worst = max(worst, float((err / np.maximum(np.abs(rp.aggregate),
                                                   1e-30)).max()))
    return worst


def chaos_runs():
    """serve-chaos-krum (the canonical plan, seed 11, deadline backstop)
    and serve-crash (a certain executor crash); returns launch counts."""
    import numpy as np

    from repro_torch.serve import FaultPlan, canonical_fault_plan

    counts = {}
    fp = canonical_fault_plan(seed=CHAOS_FAULT_SEED)
    card, inj, counts["serve-chaos-krum"], wall = _fault_run(
        fp, "cuda", CHAOS_DEADLINE)
    again, inj2, _, wall2 = _fault_run(fp, "cuda", CHAOS_DEADLINE)
    cpu, inj_cpu, _, wall_cpu = _fault_run(fp, "cpu", CHAOS_DEADLINE)
    stats = inj.stats.snapshot()
    if inj2.stats.snapshot() != stats or inj_cpu.stats.snapshot() != stats:
        raise AssertionError(f"serve-chaos-krum: FaultStats differ: {stats},"
                             f" {inj2.stats.snapshot()}, "
                             f"{inj_cpu.stats.snapshot()}")
    for (a, pa, _), (b, pb, _) in zip(card.records, again.records):
        if (a.round_id, a.close_reason, pa) != (b.round_id, b.close_reason,
                                                pb) or \
                not np.array_equal(a.aggregate, b.aggregate):
            raise AssertionError(f"serve-chaos-krum round {a.round_id}: two "
                                 "card runs differ")
    if len(card.records) != len(again.records):
        raise AssertionError("serve-chaos-krum: two card runs closed "
                             "different rounds")
    worst = _same_rounds("serve-chaos-krum", card, cpu)
    m = card.server.metrics
    full = sum(1 for r, _, _ in card.records if not r.degraded)
    predicted = dict(_NO_LAUNCHES, cross_gram=m.chunks_ingested,
                     select_row=full)
    reasons = [r.close_reason[0] + str(r.cohort_fill)
               for r, _, _ in card.records]
    print(f"  serve-chaos-krum  rounds {reasons} (f: fill, d: deadline), "
          f"{m.rounds_degraded} degraded; FaultStats {stats}")
    print(f"  serve-chaos-krum  replay bitwise on the card: ok; vs CPU same "
          f"FaultStats, rounds and winners, max rel err {worst:.3e} "
          f"[rtol 1e-5]; winners {[p for _, p, _ in card.records][:3]} ...")
    print(f"  serve-chaos-krum  launches {counts['serve-chaos-krum']}  "
          f"predicted {predicted}")
    print(f"  serve-chaos-krum  wall {wall:.3f} s, {wall2:.3f} s (card), "
          f"{wall_cpu:.3f} s (CPU); {wall / len(card.records) * 1e3:.3f} ms "
          f"a round")
    if counts["serve-chaos-krum"] != predicted:
        raise AssertionError("serve-chaos-krum: launch counts differ from "
                             "the prediction")

    crash = FaultPlan(executor_crash=1.0)
    card, inj, counts["serve-crash"], wall = _fault_run(crash, "cuda")
    cpu, _, _, _ = _fault_run(crash, "cpu")
    m = card.server.metrics
    for r, _, _ in card.records:
        if not r.degraded or \
                r.fallback_reason != "executor_error:InjectedFault":
            raise AssertionError(f"serve-crash round {r.round_id}: "
                                 f"{r.degraded} {r.fallback_reason}")
    if not (m.executor_faults == inj.stats.executor_crashes
            == len(card.records) == CHAOS_ROUNDS):
        raise AssertionError(f"serve-crash: {m.snapshot()} "
                             f"{inj.stats.snapshot()}")
    worst = _same_rounds("serve-crash", card, cpu)
    predicted = dict(_NO_LAUNCHES, cross_gram=m.chunks_ingested)
    print(f"  serve-crash       {CHAOS_ROUNDS} rounds, every one degraded "
          f"(executor_error:InjectedFault), executor_faults "
          f"{m.executor_faults}; fallback vs CPU max rel err {worst:.3e} "
          f"[rtol 1e-5]; wall {wall:.3f} s")
    print(f"  serve-crash       launches {counts['serve-crash']}  predicted "
          f"{predicted}")
    if counts["serve-crash"] != predicted:
        raise AssertionError("serve-crash: launch counts differ from the "
                             "prediction")
    return counts


def snapshot_run(work, name, rule):
    """serve-snapshot-*: ``rule`` on the card parked mid-round (one round
    closed, 5 of 12 rows of the next), save_server, restore_server into a
    fresh card server, the round finished on both: the closes bitwise
    equal.  Three closes in all (two on the live server, one on the
    restored one).  Returns (launch counts, save ms, restore ms)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.scenarios import SyntheticCohort
    from repro_torch.serve import (AggregationServer, ServeConfig,
                                   restore_server, save_server)

    plan = _serve_plan(rule, 5.0)
    cfg = ServeConfig(n_slots=SERVE_SLOTS, dim=SERVE_DIM,
                      cohort_size=SERVE_COHORT, seed=SERVE_SEED)
    rows = SyntheticCohort("alie", n_slots=SERVE_SLOTS, dim=SERVE_DIM,
                           n_byz=SERVE_BYZ).round_rows(
        np.random.RandomState([SERVE_SEED, 0]))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    live = AggregationServer(plan, cfg, device="cuda")
    for slot in range(SERVE_COHORT):
        live.submit(slot, rows[slot])
    closed = live.pump()
    for slot in (12, 13, 14, 15, 0):
        live.submit(slot, rows[slot])
        live.pump()
    ckpt_dir = work / name
    t0 = time.perf_counter()
    save_server(live, str(ckpt_dir))
    save_ms = (time.perf_counter() - t0) * 1e3
    clone = AggregationServer(plan, cfg, device="cuda")
    t0 = time.perf_counter()
    step, _ = restore_server(clone, str(ckpt_dir))
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    if step != 1 or clone.round_id != 1 or \
            clone._arrived_slots != live._arrived_slots:
        raise AssertionError(f"{name}: restored step {step}, round "
                             f"{clone.round_id}")
    for slot in range(1, 8):
        for srv in (live, clone):
            srv.submit(slot, rows[slot] * 0.5)
    closed += live.pump()
    mine = clone.pump()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if len(closed) != 2 or len(mine) != 1 or \
            not np.array_equal(closed[1].aggregate, mine[0].aggregate):
        raise AssertionError(f"{name}: the restored server closed another "
                             "aggregate")
    if rule == "krum":  # the clone ingests one chunk
        predicted = dict(_NO_LAUNCHES, select_row=3,
                         cross_gram=live.metrics.chunks_ingested + 1)
    else:  # the tiled CenteredClip at every close (phase 5's serve-cclip)
        predicted = dict(_NO_LAUNCHES, row_norms=3,
                         diff_row_ssq=3 * CCLIP_ITERS,
                         cclip_update=3 * (CCLIP_ITERS + 1))
    print(f"  {name:18s} mid-round (fill 5/12) save {save_ms:.3f} ms, "
          f"restore {restore_ms:.3f} ms; the finished round bitwise equal "
          f"on both: ok")
    print(f"  {name:18s} launches {counts}  predicted {predicted}")
    if counts != predicted:
        raise AssertionError(f"{name}: launch counts differ from the "
                             "prediction")
    return counts, save_ms, restore_ms


def _stream_cmd(rule, ckpt_dir, emit, *, sleep_ms=0.0, resume=False):
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
           "stream", "--device", "cuda", "--aggregator", rule, "--backend",
           "auto", "--clients", str(SERVE_SLOTS), "--dim", str(SERVE_DIM),
           "--cohort-size", str(SERVE_COHORT), "--clip-radius", "5.0",
           "--attack", "alie", "--n-byz", str(SERVE_BYZ), "--rounds",
           str(RESUME_ROUNDS), "--seed", str(SERVE_SEED), "--ckpt-dir",
           str(ckpt_dir), "--emit-rounds", str(emit), "--pump-sleep-ms",
           str(sleep_ms)]
    return cmd + ["--resume"] if resume else cmd


def _rounds_by_id(path):
    out = {}
    if path.exists():
        for line in path.read_text().splitlines():
            d = json.loads(line)
            out.setdefault(d["round_id"], set()).add(d["aggregate_hex"])
    return out


def _lines(path):
    return len(path.read_text().splitlines()) if path.exists() else 0


def resume_runs(work, src):
    """serve-resume-krum and serve-resume-cclip: the stream launcher as a
    subprocess on the card, uninterrupted; again with a pump sleep,
    SIGKILLed after RESUME_KILL_AFTER emitted rounds and restarted with
    --resume.  Every round id must carry one aggregate, bitwise the
    uninterrupted run's.  The four first processes run together, then
    the two resumes.  Returns each rule's seconds."""
    import os
    import signal

    env = dict(os.environ, PYTHONPATH=str(src))
    rules = (("serve-resume-krum", "krum"),
             ("serve-resume-cclip", "centered_clip"))
    procs, logs = [], []

    def start(cmd, tag):
        log = open(work / f"{tag}.log", "w")
        logs.append(log)
        p = subprocess.Popen(cmd, cwd=src.parent, env=env, stdout=log,
                             stderr=subprocess.STDOUT)
        procs.append(p)
        return p, time.perf_counter()

    out = {}
    try:
        runs = {}
        for name, rule in rules:
            d = work / name
            d.mkdir()
            runs[name] = dict(
                oracle=start(_stream_cmd(rule, d / "oracle_ck",
                                         d / "oracle.jsonl"),
                             f"{name}-oracle"),
                victim=start(_stream_cmd(rule, d / "victim_ck",
                                         d / "victim.jsonl",
                                         sleep_ms=RESUME_SLEEP_MS),
                             f"{name}-victim"),
                dir=d)
        t_end = time.perf_counter() + PROC_TIMEOUT
        pending = {name for name, _ in rules}
        while pending:
            for name in sorted(pending):
                p, _ = runs[name]["victim"]
                if p.poll() is not None:
                    log = (work / f"{name}-victim.log").read_text()
                    raise AssertionError(f"{name}: the stream server ended "
                                         f"before the kill landed: "
                                         f"{log[-2000:]}")
                if _lines(runs[name]["dir"] / "victim.jsonl") \
                        >= RESUME_KILL_AFTER:
                    p.send_signal(signal.SIGKILL)
                    p.wait(timeout=60)
                    runs[name]["killed_at"] = _lines(
                        runs[name]["dir"] / "victim.jsonl")
                    pending.discard(name)
            if time.perf_counter() > t_end:
                raise AssertionError(f"{sorted(pending)}: no "
                                     f"{RESUME_KILL_AFTER} rounds emitted")
            time.sleep(0.02)
        for name, _ in rules:
            p, t0 = runs[name]["oracle"]
            if p.wait(timeout=PROC_TIMEOUT) != 0:
                raise AssertionError(f"{name}: the uninterrupted run failed "
                                     f"({(work / f'{name}-oracle.log').read_text()[-2000:]})")
            runs[name]["oracle_s"] = time.perf_counter() - t0
            runs[name]["resume"] = start(
                _stream_cmd(dict(rules)[name], runs[name]["dir"] / "victim_ck",
                            runs[name]["dir"] / "victim.jsonl", resume=True),
                f"{name}-resume")
        for name, _ in rules:
            p, t0 = runs[name]["resume"]
            if p.wait(timeout=PROC_TIMEOUT) != 0:
                raise AssertionError(f"{name}: the resumed run failed "
                                     f"({(work / f'{name}-resume.log').read_text()[-2000:]})")
            resume_s = time.perf_counter() - t0
            log = (work / f"{name}-resume.log").read_text()
            m = re.search(r"resumed from checkpoint step (\d+)", log)
            if m is None or "(0 degraded" not in log:
                raise AssertionError(f"{name}: the run did not resume from a "
                                     f"checkpoint or degraded: {log[-2000:]}")
            oracle = _rounds_by_id(runs[name]["dir"] / "oracle.jsonl")
            victim = _rounds_by_id(runs[name]["dir"] / "victim.jsonl")
            if set(oracle) != set(range(RESUME_ROUNDS)) or \
                    set(victim) != set(oracle):
                raise AssertionError(f"{name}: rounds {sorted(oracle)} vs "
                                     f"{sorted(victim)}")
            for rid in range(RESUME_ROUNDS):
                if len(victim[rid]) != 1 or victim[rid] != oracle[rid]:
                    raise AssertionError(f"{name} round {rid}: the resumed "
                                         "run diverged")
            replayed = _lines(runs[name]["dir"] / "victim.jsonl") \
                - runs[name]["killed_at"]
            # the serve loop's own seconds (restore to the last close)
            loop_s = [float(re.search(r"wall_s = ([0-9.]+)", (
                work / f"{name}-{tag}.log").read_text()).group(1))
                for tag in ("oracle", "resume")]
            out[name] = dict(oracle_s=runs[name]["oracle_s"],
                             resume_s=resume_s, step=int(m.group(1)))
            print(f"  {name:18s} killed after {runs[name]['killed_at']} "
                  f"rounds, resumed from step {m.group(1)}, {replayed} "
                  f"rounds emitted after the resume; every round bitwise "
                  f"== the uninterrupted run: ok; uninterrupted "
                  f"{runs[name]['oracle_s']:.3f} s, resume {resume_s:.3f} s "
                  f"(process wall, start-up included); serve loop "
                  f"{loop_s[0]:.3f} s for {RESUME_ROUNDS} rounds, the "
                  f"replay {loop_s[1]:.3f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        for log in logs:
            log.close()
    return out


def score_runs():
    """score-krum (radius 5.0) and score-cm (no clip): make_scoring_step
    on _main_score's batch (B = 8 requests of 16 clients, d = 4,096, the
    trailing 4 x100) on the card and the CPU; returns launch counts and
    ms per request of a second, warmed call."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_scoring_step

    xs = np.random.RandomState(0).randn(
        SCORE_REQUESTS, SERVE_SLOTS, SERVE_DIM).astype(np.float32)
    xs[:, SERVE_SLOTS - SERVE_BYZ:, :] *= 100.0
    card_xs = torch.from_numpy(xs).cuda()
    counts, ms = {}, {}
    for name, rule, radius, kernel in (
            ("score-krum", "krum", 5.0, None),
            ("score-cm", "cm", None, "coordinate_median")):
        plan = _serve_plan(rule, radius)
        score = make_scoring_step(plan, "cuda")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        card = score(card_xs, key=2)
        torch.cuda.synchronize()
        counts[name] = ops.launch_counts()
        t0 = time.perf_counter()
        score(card_xs, key=2)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3 / SCORE_REQUESTS
        cpu = make_scoring_step(plan, "cpu")(xs, key=2)
        card = {k: v.cpu().numpy() for k, v in card.items()}
        worst = 0.0
        for k, want in cpu.items():
            want = want.numpy()
            err = np.abs(card[k] - want)
            if card[k].shape != want.shape or \
                    not np.all(err <= 1e-7 + 1e-5 * np.abs(want)):
                raise AssertionError(f"{name}: {k} differs from the CPU")
            worst = max(worst, float((err / np.maximum(np.abs(want),
                                                       1e-30)).max()))
        winners = card["distance"].argmin(axis=1)
        if rule == "krum" and not np.array_equal(
                winners, cpu["distance"].numpy().argmin(axis=1)):
            raise AssertionError(f"{name}: other Krum winners than the CPU")
        dist = card["distance"]
        flagged = dist > np.median(dist, axis=1, keepdims=True) * 3.0
        if not (flagged[:, SERVE_SLOTS - SERVE_BYZ:].all()
                and not flagged[:, :SERVE_SLOTS - SERVE_BYZ].any()):
            raise AssertionError(f"{name}: flagged {flagged.sum(1)}")
        predicted = dict(_NO_LAUNCHES, gram_matrix=SCORE_REQUESTS,
                         select_row=SCORE_REQUESTS) if rule == "krum" \
            else dict(_NO_LAUNCHES, coordinate_median=SCORE_REQUESTS)
        print(f"  {name:18s} B={SCORE_REQUESTS} x {SERVE_SLOTS} x "
              f"d={SERVE_DIM}: vs CPU max rel err {worst:.3e} [rtol 1e-5]"
              f"{', same winners ' + str(winners.tolist()) if rule == 'krum' else ''};"
              f" the trailing {SERVE_BYZ} flagged in every request, no "
              f"other; {ms[name]:.3f} ms a request (warm call)")
        print(f"  {name:18s} launches {counts[name]}  predicted {predicted}")
        if counts[name] != predicted:
            raise AssertionError(f"{name}: launch counts differ from the "
                                 "prediction")
    return counts, ms


def recovery_path():
    """Phase 7: faults, recovery, scoring on the card; returns the
    in-process runs' launch counts."""
    import shutil

    print("faults, recovery, scoring")
    t0 = time.perf_counter()
    src = Path(__file__).resolve().parent / "src"
    work = src.parent / "build" / "chip_smoke_phase7"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    phase = {}
    t = time.perf_counter()
    counts = chaos_runs()
    phase["chaos"] = time.perf_counter() - t
    t = time.perf_counter()
    for name, rule in (("serve-snapshot-krum", "krum"),
                       ("serve-snapshot-cclip", "centered_clip")):
        counts[name], _, _ = snapshot_run(work, name, rule)
    phase["snapshot"] = time.perf_counter() - t
    t = time.perf_counter()
    resume_runs(work, src)
    phase["resume"] = time.perf_counter() - t
    t = time.perf_counter()
    score_counts, _ = score_runs()
    counts.update(score_counts)
    phase["score"] = time.perf_counter() - t
    print(f"  phase 7 wall {time.perf_counter() - t0:.3f} s ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in phase.items()) + ")")
    return counts


# ---------------------------------------------------------------------------
# phase 8: the mesh aggregation
# ---------------------------------------------------------------------------

MESH_RULES = ("cm", "tm", "mean", "cclip", "rfa", "krum", "multi_krum",
              "bucket_cm", "bucket_krum", "bucket_rfa")
MESH_ITERATIVE = ("cclip", "rfa", "bucket_rfa")
MESH_WIDE_RULES = ("cm", "rfa", "krum", "bucket_cm")
# Fig. 2's MNIST MLP, d = 101,770 (phase 4's fig2-rfa-wide)
MNIST_LEAVES = (("w1", (784, 128)), ("b1", (128,)), ("w2", (128, 10)),
                ("b2", (10,)))
WIDE_LEAVES = (("w", (4096, 4096)), ("b", (37,)))  # 2^24 + 37 coordinates
MESH_N = 20
MESH_CHUNK = 24576
MESH_RADIUS = 3.0
MESH_BYZ = 2
MESH_ATOL = 3e-5
MESH_TIMEOUT = 300  # seconds for a spawned job
MESH_WIDE_STEPS = 5  # timed steps per rule of mesh-naive-wide
COLL_FLOATS = 1 << 22  # f32 values a rank in the collectives' timing
MESH_SCHEDULES = (("naive", "sequential"), ("sharded", "sequential"),
                  ("sharded", "pipelined"))
# the spawned jobs' trees: (leaves, workers, seed, mesh, w1 split, rules,
# radii, superleaf sizes, byz_bound, mask (None: from the seed))
MESH_RUNS = {
    "mnist-4x1": (MNIST_LEAVES, 4, 81, (4, 1), False, MESH_RULES,
                  (MESH_RADIUS, None), (0, MESH_CHUNK), MESH_BYZ,
                  (True, True, False, True)),
    "mnist-2x2": (MNIST_LEAVES, 2, 82, (2, 2), True, MESH_RULES,
                  (MESH_RADIUS, None), (0, MESH_CHUNK), MESH_BYZ, None),
    "wide-4x1": (WIDE_LEAVES, 4, 83, (4, 1), False, MESH_WIDE_RULES,
                 (MESH_RADIUS,), (0,), MESH_BYZ, (True, True, False, True)),
    # four workers on the split layout, every one sampled and byz_bound 0:
    # Krum sums each row's 2 nearest distances, a choice that a wrong
    # Gram all-reduce over "model" would change
    "mnist-4x2": (MNIST_LEAVES, 4, 84, (4, 2), True, MESH_RULES,
                  (MESH_RADIUS, None), (0, MESH_CHUNK), 0,
                  (True, True, True, True)),
}
# the spawned jobs: name -> (ranks, runs)
MESH_JOBS = {
    "mesh-sharded-4rank": (4, ("mnist-4x1", "mnist-2x2", "wide-4x1")),
    "mesh-sharded-8rank": (8, ("mnist-4x2",)),
}


def _mesh_plan(agg, placement="naive", blocks="sequential", sle=0,
               backend="auto", byz=MESH_BYZ):
    import warnings

    from repro_torch.api import (AggregatorSpec, BucketSpec, ScheduleSpec,
                                 ServerPlan)

    rule, s = (agg[7:], 2) if agg.startswith("bucket_") else (agg, 0)
    with warnings.catch_warnings():  # superleaf chunks with rfa/cclip
        warnings.simplefilter("ignore")
        return ServerPlan(
            aggregate=AggregatorSpec(rule, byz_bound=byz),
            bucket=BucketSpec(s=s) if s else None,
            schedule=ScheduleSpec(placement=placement, blocks=blocks,
                                  superleaf_elems=sle, backend=backend))


def _mesh_tree(leaves, n, seed):
    """A worker-stacked tree of ``n`` rows on the card, from ``seed``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return {k: torch.randn(n, *shape, device="cuda", generator=g)
            for k, shape in leaves}


def _mesh_inputs(n, seed):
    """(mask with row 0 in, Bucketing's permutation), on the card."""
    import torch

    g = torch.Generator().manual_seed(seed)
    mask = torch.rand(n, generator=g) > 0.2
    mask[0] = True
    return mask.cuda(), torch.randperm(n, generator=g).cuda()


def _mesh_configs(rules, radii, chunks, split=False):
    for agg in rules:
        for radius in radii:
            for sle in chunks:
                if split and sle and agg in MESH_ITERATIVE:
                    continue  # chunks other than the whole tree's
                yield agg, radius, sle


def _mesh_factors(tree, radius):
    """The clip factors of each row's whole message (None: no clip), the
    norms taken in float64: an f32 sum of 2^24 squares may round 1e-4
    apart from the kernel's partial sums."""
    import torch

    from repro_torch.core.tree_utils import tree_batch_ravel
    from repro_torch.kernels.clip_aggregate import clip_factor

    if radius is None:
        return None
    flat = tree_batch_ravel(tree)[0].double()
    return clip_factor(torch.linalg.vector_norm(flat, dim=1).float(), radius)


def _mesh_reference(tree, mask, perm, agg, radius, sle, byz=MESH_BYZ):
    """The one-process plain path of the naive placement on ``tree``'s
    device: (output leaves, clip factors)."""
    from repro_torch.api.mesh_exec import naive_aggregate
    from repro_torch.core.tree_utils import tree_leaves

    f = _mesh_factors(tree, radius)
    out = naive_aggregate(tree, mask, perm, agg=_mesh_plan(
        agg, backend="torch", byz=byz).build_aggregator(), chunk_elems=sle,
        factors=f)
    return tree_leaves(out), f


def _mesh_close(what, got, want, rtol=SUM_RTOL, atol=SUM_ATOL):
    """Every leaf within atol + rtol |want|; returns the largest error."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float().cpu(), w.float().cpu()
        if g.shape != w.shape:
            raise AssertionError(f"{what}: shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        err = (g - w).abs()
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        if not bool((err <= atol + rtol * w.abs()).all()):
            raise AssertionError(f"{what}: max abs err {float(err.max()):.3e}"
                                 f" beyond rtol {rtol:g} atol {atol:g}")
    return worst


def _krum_winner(tree, factors, out_leaves):
    """The row of the (clipped) message that the Krum output is."""
    import torch

    from repro_torch.core.tree_utils import tree_batch_ravel

    rows = tree_batch_ravel(tree)[0].float()
    if factors is not None:
        rows = rows * factors[:, None]
    out = torch.cat([x.reshape(-1).float() for x in out_leaves])
    return int((rows - out.to(rows.device)[None]).abs().amax(dim=1).argmin())


def _timed_step(step, *args, **kw):
    import torch

    from repro_torch.core.tree_utils import tree_leaves

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = step(*args, **kw)
    torch.cuda.synchronize()
    return tree_leaves(out), (time.perf_counter() - t) * 1e3


def _print_mesh_run(name, wall_ms, counts, colls):
    launched = {k: v for k, v in counts.items() if v}
    print(f"  {name:22s} wall {statistics.mean(wall_ms):.3f} ms/step "
          f"(median {statistics.median(wall_ms):.3f}, {len(wall_ms)} steps)")
    print(f"  {name:22s} launches {launched}")
    print(f"  {name:22s} collectives {colls}")


def _check_routes(what, colls, route):
    """Every collective in ``colls`` (``collective_counts()``) took
    ``route``; returns their names."""
    off = {op: c["route"] for op, c in colls.items() if c["route"] != route}
    if off:
        raise AssertionError(f"{what}: collectives off the {route!r} route: "
                             f"{off}")
    return sorted(colls)


def _collective_ms(group, dev):
    """Median host ms of each collective the mesh runs, on ``group`` at
    COLL_FLOATS f32 values a rank on ``dev``: one warm-up, then five
    synchronised calls."""
    import torch
    import torch.distributed as dist

    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    W = dist.get_world_size(group)
    y = torch.randn(COLL_FLOATS, device=dev)
    calls = {
        "all_to_all": lambda: dist.all_to_all_single(
            torch.empty_like(y), y, group=group),
        "all_reduce": lambda: dist.all_reduce(y.clone(), group=group),
        "all_gather": lambda: gather(
            torch.empty(W * COLL_FLOATS, device=dev), y, group=group),
    }
    out = {}
    for op, call in calls.items():
        call()
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        out[op] = round(statistics.median(ms), 3)
    return out


def mesh_fig2(mesh):
    """mesh-naive-fig2: the MNIST tree's 20 rows on the one-rank (1, 1)
    NCCL mesh, the whole registry clipped and unclipped, superleaf 0 and
    24,576, against the CPU plain path; then the one-rank sharded
    placement (one row) against the naive one, pipelined bitwise equal
    to sequential.  Returns the naive run's launch counts."""
    import torch

    from repro_torch.api.mesh_exec import (collective_counts,
                                           reset_collective_counts)
    from repro_torch.core.tree_utils import tree_map
    from repro_torch.kernels import ops

    name = "mesh-naive-fig2"
    tree = _mesh_tree(MNIST_LEAVES, MESH_N, 80)
    mask, perm = _mesh_inputs(MESH_N, 80)
    configs = list(_mesh_configs(MESH_RULES, (MESH_RADIUS, None),
                                 (0, MESH_CHUNK)))
    steps = {c: _mesh_plan(c[0], sle=c[2]).build(mesh) for c in configs}
    outs, wall = {}, []
    for c in configs:  # warm-up: the first calls load the libraries
        steps[c](tree, mask=mask, key=perm, radius=c[1])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    reset_collective_counts()
    for c in configs:
        outs[c], ms = _timed_step(steps[c], tree, mask=mask, key=perm,
                                  radius=c[1])
        wall.append(ms)
    counts, colls = ops.launch_counts(), collective_counts()
    _print_mesh_run(name, wall, counts, colls)
    _check_routes(name, colls, "device")
    cpu = tree_map(lambda x: x.cpu(), tree)
    worst = 0.0
    for agg, radius, sle in configs:
        want, f = _mesh_reference(cpu, mask.cpu(), perm.cpu(), agg, radius,
                                  sle)
        what = f"{name} {agg} radius={radius} superleaf={sle}"
        worst = max(worst, _mesh_close(what, outs[(agg, radius, sle)], want))
        if agg == "krum":
            got_w = _krum_winner(cpu, f, outs[(agg, radius, sle)])
            want_w = _krum_winner(cpu, f, want)
            if got_w != want_w:
                raise AssertionError(f"{what}: Krum winner {got_w} on the "
                                     f"card, {want_w} on the CPU")
    print(f"  {name:22s} {len(configs)} steps vs the CPU plain path: max abs "
          f"err {worst:.3e} [rtol {SUM_RTOL:g} atol {SUM_ATOL:g}], the same "
          "Krum winners")
    # the one-rank sharded placement: W = 1 row, through NCCL
    one = tree_map(lambda x: x[:1].contiguous(), tree)
    m1 = mask[:1]
    worst, wall = 0.0, []
    ops.reset_launch_counts()
    reset_collective_counts()
    for agg, radius, sle in configs:
        got = {}
        for placement, blocks in MESH_SCHEDULES:
            got[(placement, blocks)], ms = _timed_step(
                _mesh_plan(agg, placement, blocks, sle).build(mesh), one,
                mask=m1, radius=radius)
            wall.append(ms)
        what = f"{name} sharded-1rank {agg} radius={radius} superleaf={sle}"
        seq, pipe = got[("sharded", "sequential")], got[("sharded",
                                                         "pipelined")]
        if not all(torch.equal(a, b) for a, b in zip(seq, pipe)):
            raise AssertionError(f"{what}: pipelined != sequential")
        worst = max(worst, _mesh_close(what, seq, got[("naive", "sequential")],
                                       rtol=0.0, atol=MESH_ATOL))
    _print_mesh_run("sharded-1rank", wall, ops.launch_counts(),
                    collective_counts())
    # over axes of one rank the scatter and the gathers are the identity
    # and run no collective; the row statistics' reductions still do
    if set(_check_routes("sharded-1rank", collective_counts(),
                         "device")) != {"all_reduce"}:
        raise AssertionError("the one-rank sharded placement ran "
                             f"{sorted(collective_counts())}, not only its "
                             "all_reduce")
    print(f"  sharded-1rank          {3 * len(configs)} steps: pipelined "
          f"bitwise equal to sequential, sharded vs naive max abs err "
          f"{worst:.3e} [atol {MESH_ATOL:g}]")
    return counts


def mesh_wide(mesh):
    """mesh-naive-wide: 20 rows of 2^24+37 f32 coordinates on the one-rank
    mesh, cm, rfa, krum and bucket_cm at radius 3.0, against the plain
    versions on the card.  Returns the launch counts."""
    import torch

    from repro_torch.api.mesh_exec import (collective_counts,
                                           reset_collective_counts)
    from repro_torch.kernels import ops

    name = "mesh-naive-wide"
    tree = _mesh_tree(WIDE_LEAVES, MESH_N, 90)
    mask, perm = _mesh_inputs(MESH_N, 90)
    steps = {agg: _mesh_plan(agg).build(mesh) for agg in MESH_WIDE_RULES}
    outs, wall = {}, []
    for agg in MESH_WIDE_RULES:  # warm-up: the first calls load libraries
        steps[agg](tree, mask=mask, key=perm, radius=MESH_RADIUS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    reset_collective_counts()
    by_rule = {}
    for agg in MESH_WIDE_RULES:
        for _ in range(MESH_WIDE_STEPS):
            outs[agg], ms = _timed_step(steps[agg], tree, mask=mask,
                                        key=perm, radius=MESH_RADIUS)
            by_rule.setdefault(agg, []).append(ms)
            wall.append(ms)
    counts, colls = ops.launch_counts(), collective_counts()
    _print_mesh_run(name, wall, counts, colls)
    _check_routes(name, colls, "device")
    for agg, ms in by_rule.items():
        print(f"  {name:22s} {agg}: median {statistics.median(ms):.3f} "
              f"ms/step, min {min(ms):.3f}, max {max(ms):.3f} ({len(ms)} "
              f"steps: " + ", ".join(f"{v:.3f}" for v in ms) + ")")
    worst = 0.0
    for agg in MESH_WIDE_RULES:
        plain, plain_ms = _timed_step(_mesh_plan(agg, backend="torch")
                                      .build(mesh), tree, mask=mask,
                                      key=perm, radius=MESH_RADIUS)
        what = f"{name} {agg}"
        worst = max(worst, _mesh_close(what, outs[agg], plain))
        print(f"  {name:22s} {agg}: plain versions on the card "
              f"{plain_ms:.3f} ms")
        if agg == "krum":
            f = _mesh_factors(tree, MESH_RADIUS)
            if _krum_winner(tree, f, outs[agg]) != _krum_winner(tree, f,
                                                                plain):
                raise AssertionError(f"{what}: the Krum winners differ")
        del plain
    print(f"  {name:22s} vs the plain versions on the card: max abs err "
          f"{worst:.3e} [rtol {SUM_RTOL:g} atol {SUM_ATOL:g}], the same "
          "Krum winner")
    del tree, outs
    torch.cuda.empty_cache()
    return counts


def _mesh_local(tree, rank_d, rank_m, n_model, split):
    """A rank's piece: its worker's row, and its 1/n_model of w1's
    columns when w1 is split over "model"."""
    out = {}
    for k, x in tree.items():
        x = x[rank_d:rank_d + 1]
        if split and k == "w1":
            cols = x.shape[2] // n_model
            x = x[:, :, rank_m * cols:(rank_m + 1) * cols]
        out[k] = x.contiguous()
    return out


def _mesh_job(rank, ref_path, runs):
    """One rank of a spawned mesh job (gloo, every rank on cuda:0): each
    tree of ``runs`` under the naive and both sharded schedules, checked
    here against the CPU references the parent wrote to ``ref_path``;
    then each collective timed on the first mesh's "data" group, on the
    card's tensors and on CPU ones.  Returns this rank's launches,
    collectives and times."""
    import torch

    from repro_torch.api.mesh_exec import (collective_counts,
                                           reset_collective_counts)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import P, make_debug_mesh

    refs = torch.load(ref_path, weights_only=False)
    report = {"ms": {}, "checks": 0, "worst_ref": 0.0, "worst_naive": 0.0}
    meshes = {}
    for run in runs:
        shape = MESH_RUNS[run][3]
        if shape not in meshes:
            meshes[shape] = make_debug_mesh(*shape)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    reset_collective_counts()
    for run in runs:
        leaves, n, seed, shape, split, rules, radii, chunks, byz, _ = \
            MESH_RUNS[run]
        mesh = meshes[shape]
        rd, rm = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        full = _mesh_tree(leaves, n, seed)
        local = _mesh_local(full, rd, rm, shape[1], split)
        del full
        mask, perm = refs[run]["mask"].cuda(), refs[run]["perm"].cuda()
        specs = ({"w1": P(None, "model"), "b1": P(), "w2": P(), "b2": P()}
                 if split else None)
        for agg, radius, sle in _mesh_configs(rules, radii, chunks, split):
            got = {}
            for placement, blocks in MESH_SCHEDULES:
                step = _mesh_plan(agg, placement, blocks, sle,
                                  byz=byz).build(mesh)
                got[(placement, blocks)], ms = _timed_step(
                    step, local, mask=mask, key=perm, radius=radius,
                    base_specs=specs)
                report["ms"].setdefault((run, placement, blocks),
                                        []).append(ms)
            what = f"rank {rank} {run} {agg} radius={radius} superleaf={sle}"
            seq = got[("sharded", "sequential")]
            if not all(torch.equal(a, b) for a, b in
                       zip(seq, got[("sharded", "pipelined")])):
                raise AssertionError(f"{what}: pipelined != sequential")
            report["worst_naive"] = max(report["worst_naive"], _mesh_close(
                f"{what} sharded vs naive", seq, got[("naive", "sequential")],
                rtol=0.0, atol=MESH_ATOL))
            want = [w.cuda() for w in refs[run]["out"][(agg, radius, sle)]]
            if split:  # this rank's w1 columns (flatten order b1 b2 w1 w2)
                cols = want[2].shape[1] // shape[1]
                want[2] = want[2][:, rm * cols:(rm + 1) * cols]
            for out in got.values():
                report["worst_ref"] = max(report["worst_ref"], _mesh_close(
                    f"{what} vs the CPU plain path", out, want))
            report["checks"] += 1
            del got, want
        del local
        torch.cuda.empty_cache()
    report["launches"] = ops.launch_counts()
    report["collectives"] = collective_counts()
    group = next(iter(meshes.values())).get_group("data")
    report["coll_ms"] = {dev: _collective_ms(group, dev)
                         for dev in ("cuda", "cpu")}
    return report


def mesh_sharded(work, name):
    """A spawned mesh job of MESH_JOBS: its ranks as gloo processes on
    cuda:0, spawned once; returns the launch counts summed over the
    ranks."""
    import torch

    from repro_torch.core.tree_utils import tree_map
    from repro_torch.launch.mesh import spawn

    nprocs, runs = MESH_JOBS[name]
    refs = {}
    t0 = time.perf_counter()
    for run in runs:
        leaves, n, seed, shape, split, rules, radii, chunks, byz, mask = \
            MESH_RUNS[run]
        cpu = tree_map(lambda x: x.cpu(), _mesh_tree(leaves, n, seed))
        seeded, perm = _mesh_inputs(n, seed)
        mask = seeded.cpu() if mask is None else torch.tensor(mask)
        refs[run] = {"mask": mask, "perm": perm.cpu(), "out": {
            c: _mesh_reference(cpu, mask, perm.cpu(), *c, byz=byz)[0]
            for c in _mesh_configs(rules, radii, chunks, split)}}
        del cpu
    ref_path = work / f"{name}_refs.pt"
    torch.save(refs, ref_path)
    del refs
    print(f"  {name:22s} CPU references written in "
          f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    reports = spawn(_mesh_job, nprocs, (str(ref_path), runs),
                    timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t0
    host_ops = set()
    for rank, rep in enumerate(reports):
        host_ops.update(_check_routes(f"{name} rank {rank}",
                                      rep["collectives"], "host"))
    print(f"  {name:22s} transport gloo, {nprocs} processes on cuda:0: "
          f"{', '.join(sorted(host_ops))} took gloo's host route on every "
          "rank (gloo copies each CUDA tensor into pinned host memory, runs "
          "the collective over TCP on the CPU and copies the result back); "
          f"spawn to join {wall:.3f} s")
    total = {}
    for rank, rep in enumerate(reports):
        launched = {k: v for k, v in rep["launches"].items() if v}
        print(f"  {name:22s} rank {rank}: {rep['checks']} configurations, "
              f"vs CPU max abs err {rep['worst_ref']:.3e}, sharded vs naive "
              f"{rep['worst_naive']:.3e}; launches {launched}; collectives "
              f"{rep['collectives']}")
        for k, v in rep["launches"].items():
            total[k] = total.get(k, 0) + v
    for key, ms in sorted(reports[0]["ms"].items()):
        print(f"  {name:22s} rank 0 {key[0]} {key[1]}/{key[2]}: "
              f"{statistics.mean(ms):.3f} ms/step (median "
              f"{statistics.median(ms):.3f}, {len(ms)} steps)")
    coll = reports[0]["coll_ms"]
    print(f"  {name:22s} rank 0, {COLL_FLOATS} f32 a rank on the data "
          f"group, median ms: card tensors {coll['cuda']}, CPU tensors "
          f"{coll['cpu']}")
    print(f"  {name:22s} checks: pipelined bitwise equal to sequential, "
          f"sharded vs naive [atol {MESH_ATOL:g}], every output vs the "
          f"CPU plain path [rtol {SUM_RTOL:g} atol {SUM_ATOL:g}]")
    return total


def mesh_path():
    """Phase 8: the mesh aggregation; returns each run's launch counts."""
    import os
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    print("mesh aggregation")
    t0 = time.perf_counter()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_phase8"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    counts = {}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        work, "rendezvous"), rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1)
        print(f"  transport {dist.get_backend()}, one rank: {mesh}; "
              f"{COLL_FLOATS} f32 on the card, median ms "
              f"{_collective_ms(mesh.get_group('data'), 'cuda')}")
        counts["mesh-naive-fig2"] = mesh_fig2(mesh)
        counts["mesh-naive-wide"] = mesh_wide(mesh)
    finally:
        dist.destroy_process_group()
    for name in MESH_JOBS:
        counts[name] = mesh_sharded(work, name)
    shutil.rmtree(work, ignore_errors=True)
    print(f"  phase 8 wall {time.perf_counter() - t0:.3f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 9: the model zoo
# ---------------------------------------------------------------------------

MODEL_SEED = 0
SMOKE_B, SMOKE_S, DECODE_STEPS = 2, 32, 12
MODEL_LOSS_RTOL = 1e-5  # losses and aux losses, card against the CPU
MODEL_LEAF_REL = 1e-4  # a gradient leaf or logits, of its max-abs
MODEL_REMAT_REL = 1e-6  # remat on against remat off, of the leaf's max-abs
DECODABLE = ("minitron_8b", "yi_34b", "mamba2_780m", "jamba_v01_52b",
             "deepseek_v3_671b", "llama32_vision_90b", "arctic_480b")
VISION_GATE = 0.5  # the VLM's cross-attention gates, opened
TRAIN_SEQ = 4096  # train_4k's sequence; its global batch of 256 cut to 1
PREFILL_SEQ = 32768  # prefill_32k's sequence; its batch of 32 cut to 1
WIDE_LOSS_RTOL, WIDE_GNORM_RTOL = 2e-2, 0.05  # bf16 against f32
SSD_SEQ, SSD_REL = 1024, 1e-4  # the chunked SSD against the recurrence


def _value_and_grad(params, cfg, batch):
    """(loss, aux, grads in flatten order) by ``torch.autograd.grad``."""
    import torch

    from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
    from repro_torch.models import apply_train

    leaves, treedef = tree_flatten(params)
    leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
    loss, aux = apply_train(tree_unflatten(treedef, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            list(grads))


def _global_norm(grads) -> float:
    return math.sqrt(sum(float(g.float().square().sum()) for g in grads))


def _scaled_check(what, got, want, rel):
    """max |got - want| within ``rel`` of max |want|; returns the ratio."""
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    if err > rel * max(scale, 1e-30):
        raise AssertionError(f"{what}: max err {err:.3e} > {rel:g} x "
                             f"{scale:.3e}")
    return err / max(scale, 1e-30)


def _to(tree, device):
    from repro_torch.core.tree_utils import tree_map

    return tree_map(lambda t: t.to(device), tree)


def _open_gates(params, cfg):
    for pos, mixer in enumerate(cfg.mixer_pattern):
        if mixer == "cross":
            params["body"][pos]["mixer"]["gate"].fill_(VISION_GATE)
    return params


def _smoke_inputs(arch, dtype):
    """The smoke config in ``dtype`` (remat off), its params and batch made
    on the CPU from MODEL_SEED (bf16 is the f32 draws rounded)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.models import init_params

    cfg = get_smoke_config(arch).replace(dtype=dtype, remat=False)
    params = _open_gates(init_params(MODEL_SEED, cfg, device="cpu"), cfg)
    batch = synthetic_batch(MODEL_SEED + 1, cfg, SMOKE_B, SMOKE_S,
                            device="cpu")
    return cfg, params, batch


def _decode_vs_prefill(params, cfg, batch):
    """12 decode steps from ``init_cache`` against the prefill of the same
    12 tokens, capacity 8.0 (test_decode_matches_prefill's check)."""
    import torch

    from repro_torch.models import apply_decode, apply_prefill, init_cache

    cfg = cfg.replace(capacity_factor=8.0)
    cache = init_cache(cfg, SMOKE_B, DECODE_STEPS, device="cuda")
    with torch.no_grad():
        for t in range(DECODE_STEPS):
            step = {k: (v[:, t:t + 1] if k == "tokens" else v)
                    for k, v in batch.items()}
            logits, cache = apply_decode(params, cfg, step, cache, t)
        head = {k: (v[:, :DECODE_STEPS] if k == "tokens" else v)
                for k, v in batch.items()}
        want = apply_prefill(params, cfg, head)
    err = (logits - want).abs()
    if not bool((err <= 2e-3 + 2e-2 * want.abs()).all()):
        raise AssertionError(f"{cfg.name}: decode differs from prefill by "
                             f"{float(err.max()):.3e}")
    return float(err.max())


def models_smoke(card):
    """Each smoke config in f32 on the card against the CPU, with remat,
    decode and bf16."""
    import torch

    from repro_torch.configs import list_archs
    from repro_torch.models import apply_prefill

    t_run = time.perf_counter()
    print(f"  models-smoke on {card}: batch {SMOKE_B} x seq {SMOKE_S}, f32, "
          "remat off; "
          f"loss rtol {MODEL_LOSS_RTOL:g}, grads and logits {MODEL_LEAF_REL:g}"
          f" of max-abs, remat {MODEL_REMAT_REL:g}")
    for arch in list_archs():
        t0 = time.perf_counter()
        cfg, params_cpu, batch_cpu = _smoke_inputs(arch, "float32")
        params, batch = _to(params_cpu, "cuda"), _to(batch_cpu, "cuda")
        loss, aux, grads = _value_and_grad(params, cfg, batch)
        loss_cpu, aux_cpu, grads_cpu = _value_and_grad(params_cpu, cfg,
                                                       batch_cpu)
        for what, a, b in [("loss", loss, loss_cpu)] + [
                (k, aux[k], aux_cpu[k]) for k in aux]:
            if not math.isclose(float(a), float(b), rel_tol=MODEL_LOSS_RTOL):
                raise AssertionError(f"{arch} {what}: card {float(a)!r} cpu "
                                     f"{float(b)!r}")
        g_err = max(_scaled_check(f"{arch} grad leaf {i}", a, b,
                                  MODEL_LEAF_REL)
                    for i, (a, b) in enumerate(zip(grads, grads_cpu)))
        _, _, remat = _value_and_grad(params, cfg.replace(remat=True), batch)
        r_err = max(_scaled_check(f"{arch} remat leaf {i}", a, b,
                                  MODEL_REMAT_REL)
                    for i, (a, b) in enumerate(zip(remat, grads)))
        with torch.no_grad():
            p_err = _scaled_check(
                f"{arch} prefill", apply_prefill(params, cfg, batch),
                apply_prefill(params_cpu, cfg, batch_cpu), MODEL_LEAF_REL)
        d_err = (_decode_vs_prefill(params, cfg, batch)
                 if arch in DECODABLE else None)
        bcfg, bparams, bbatch = _smoke_inputs(arch, "bfloat16")
        bloss, _, bgrads = _value_and_grad(_to(bparams, "cuda"), bcfg,
                                           _to(bbatch, "cuda"))
        bnorm = _global_norm(bgrads)
        if not (math.isfinite(float(bloss)) and float(bloss) != 0.0
                and math.isfinite(bnorm) and bnorm > 0.0):
            raise AssertionError(f"{arch} bf16: loss {float(bloss)} grad norm "
                                 f"{bnorm}")
        torch.cuda.synchronize()
        print(f"  {arch:20s} loss {float(loss):.6f} (cpu {float(loss_cpu):.6f}"
              f") lb {float(aux['lb_loss']):.6f} z {float(aux['z_loss']):.6f};"
              f" grads {g_err:.2e} of max-abs over {len(grads)} leaves, remat"
              f" {r_err:.2e}, prefill {p_err:.2e}, decode-prefill "
              + ("-" if d_err is None else f"{d_err:.2e}")
              + f"; bf16 loss {float(bloss):.6f} grad norm {bnorm:.4f}; "
              f"wall {time.perf_counter() - t0:.3f} s")
    print(f"    models-smoke wall {time.perf_counter() - t_run:.3f} s")


def _run_header(name, card, reduced):
    import gc

    import torch

    gc.collect()  # tensors an earlier run left in reference cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"  {name} on {card}; reduced: {reduced}")
    return time.perf_counter()


def _peak_gb() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 1e9


def _timed(fn):
    """(result, ms) of one call, synchronised."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def minitron_wide(card):
    """minitron-8b at full width, 2 layers: the same params in f32 and
    bf16, loss within 2e-2 and global gradient norm within 5%."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
    from repro_torch.data import synthetic_batch
    from repro_torch.models import init_params, param_count

    t0 = _run_header("models-minitron-wide", card,
                     f"n_layers 32 -> 2, batch 256 -> 1 (seq {TRAIN_SEQ})")
    cfg = get_config("minitron_8b", n_layers=2)
    batch = synthetic_batch(MODEL_SEED + 1, cfg, 1, TRAIN_SEQ)
    out = {}
    f32 = cfg.replace(dtype="float32")
    params = init_params(MODEL_SEED, f32)
    for name, c in (("f32", f32), ("bf16", cfg)):
        if name == "bf16":  # each leaf in the bf16 config's dtype
            leaves, treedef = tree_flatten(params)
            meta, _ = tree_flatten(init_params(0, c, device="meta"))
            params = tree_unflatten(treedef, [
                leaf.to(m.dtype) for leaf, m in zip(leaves, meta)])
            del leaves
        torch.cuda.reset_peak_memory_stats()
        (loss, _, grads), ms = _timed(lambda: _value_and_grad(params, c,
                                                              batch))
        out[name] = (float(loss), _global_norm(grads), ms, _peak_gb())
        del grads
        print(f"    {name}: loss {out[name][0]:.6f} grad norm "
              f"{out[name][1]:.6f}; {ms:.1f} ms a step, "
              f"{TRAIN_SEQ / ms * 1e3:.0f} tokens/s, peak "
              f"{out[name][3]:.2f} GB")
    del params
    (l32, n32, _, _), (l16, n16, _, _) = out["f32"], out["bf16"]
    if not (abs(l16 - l32) <= WIDE_LOSS_RTOL * abs(l32)
            and abs(n16 - n32) <= WIDE_GNORM_RTOL * n32):
        raise AssertionError(f"minitron-wide: bf16 loss {l16} / f32 {l32}, "
                             f"grad norm {n16} / {n32}")
    print(f"    {param_count(cfg):,} parameters; bf16 vs f32: loss "
          f"{abs(l16 - l32) / abs(l32):.3e} (limit {WIDE_LOSS_RTOL:g}), grad "
          f"norm {abs(n16 - n32) / n32:.3e} (limit {WIDE_GNORM_RTOL:g}); "
          f"wall {time.perf_counter() - t0:.3f} s")


def _check_lm_loss(what, loss, vocab):
    lo, hi = math.log(vocab) - 1, math.log(vocab) + 2
    if not (math.isfinite(loss) and lo <= loss <= hi):
        raise AssertionError(f"{what}: loss {loss} outside [{lo:.3f}, "
                             f"{hi:.3f}]")


def minitron_full(card):
    """minitron-8b as configured (32 layers, bf16, remat): two train steps
    at seq 4,096 (the first cold), one sgd update, one prefill at 32,768."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.models import apply_prefill, init_params, param_count
    from repro_torch.optim import sgd

    t0 = _run_header("models-minitron-full", card,
                     "train_4k batch 256 -> 1, prefill_32k batch 32 -> 1")
    cfg = get_config("minitron_8b")
    params = init_params(MODEL_SEED, cfg)
    torch.cuda.synchronize()
    print(f"    {param_count(cfg):,} parameters, {cfg.n_layers} layers, "
          f"{cfg.dtype}, remat {cfg.remat}; init "
          f"{time.perf_counter() - t0:.3f} s")
    batch = synthetic_batch(MODEL_SEED + 1, cfg, 1, TRAIN_SEQ)
    losses = []
    for step in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        (loss, _, grads), ms = _timed(lambda: _value_and_grad(params, cfg,
                                                              batch))
        losses.append(float(loss))
        _check_lm_loss(f"minitron-full {step} step", float(loss), cfg.vocab)
        print(f"    train step ({step}): loss {float(loss):.6f}, {ms:.1f} ms,"
              f" {TRAIN_SEQ / ms * 1e3:.0f} tokens/s, peak {_peak_gb():.2f} GB")
        if step == "cold":
            del grads
    torch.cuda.reset_peak_memory_stats()
    opt = sgd()
    (params, _), ms = _timed(lambda: opt.apply(params, grads, opt.init(params),
                                               1e-3))
    del grads
    if not bool(torch.isfinite(params["unembed"]).all()):
        raise AssertionError("minitron-full: sgd gave non-finite weights")
    print(f"    sgd update: {ms:.1f} ms, peak {_peak_gb():.2f} GB")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tokens = synthetic_batch(MODEL_SEED + 2, cfg, 1, PREFILL_SEQ)
    with torch.no_grad():
        logits, ms = _timed(lambda: apply_prefill(params, cfg, tokens))
    if not (logits.shape == (1, cfg.vocab)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError("minitron-full prefill: bad logits")
    print(f"    prefill at {PREFILL_SEQ}: {ms:.1f} ms, "
          f"{PREFILL_SEQ / ms * 1e3:.0f} tokens/s, peak {_peak_gb():.2f} GB; "
          f"wall {time.perf_counter() - t0:.3f} s")


def _ssd_sequential(xh, dt, B_mat, C_mat, A):
    """The SSM recurrence, one step at a time in float64:
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t . h_t."""
    import torch

    xh, dt, B_mat, C_mat, A = (t.double() for t in (xh, dt, B_mat, C_mat, A))
    Bsz, S, H, P = xh.shape
    h = torch.zeros((Bsz, H, P, B_mat.shape[-1]), dtype=torch.float64,
                    device=xh.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A[None])
        h = h * decay[:, :, None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], xh[:, t], B_mat[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, C_mat[:, t]))
    return torch.stack(ys, 1), h


def _ssd_layer_inputs(params, cfg, tokens):
    """Layer 0's SSD inputs at full width in f32 (the path of
    ``mamba2_forward`` up to ``_ssd_chunked``)."""
    from repro_torch.core.tree_utils import tree_map
    from repro_torch.models import layers, ssm

    layer = tree_map(lambda t: t[0].float(), params["body"][0])
    mixer = layer["mixer"]
    x = params["embed"][tokens.long()].float()
    h = layers.rmsnorm(layer["norm1"], x)
    z, xbc, dt = ssm._split_proj(cfg, h @ mixer["in_proj"])
    xbc, _ = ssm._causal_conv(mixer["conv_w"], mixer["conv_b"], xbc)
    d_inner, nh = ssm._dims(cfg)
    N, S = cfg.ssm_state, tokens.shape[1]
    xs = xbc[..., :d_inner].reshape(1, S, nh, cfg.ssm_head_dim)
    return (xs, ssm._softplus(dt + mixer["dt_bias"][None, None]),
            xbc[..., d_inner:d_inner + N], xbc[..., d_inner + N:],
            -mixer["A_log"].exp())


def mamba2_full(card):
    """mamba2-780m as configured (48 layers, state 128, chunk 256, bf16,
    remat): a train step at 4,096 with every gradient finite, a prefill at
    32,768, and layer 0's chunked SSD in f32 against the recurrence."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.models import apply_prefill, init_params, param_count
    from repro_torch.models import ssm

    t0 = _run_header("models-mamba2-full", card,
                     "train_4k batch 256 -> 1, prefill_32k batch 32 -> 1")
    cfg = get_config("mamba2_780m")
    params = init_params(MODEL_SEED, cfg)
    print(f"    {param_count(cfg):,} parameters, {cfg.n_layers} layers, state "
          f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, {cfg.dtype}, remat "
          f"{cfg.remat}")
    batch = synthetic_batch(MODEL_SEED + 1, cfg, 1, TRAIN_SEQ)
    for step in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        (loss, _, grads), ms = _timed(lambda: _value_and_grad(params, cfg,
                                                              batch))
        bad = [i for i, g in enumerate(grads)
               if not bool(torch.isfinite(g).all())]
        if bad or not math.isfinite(float(loss)):
            raise AssertionError(f"mamba2-full: loss {float(loss)}, "
                                 f"non-finite gradient leaves {bad}")
        print(f"    train step ({step}): loss {float(loss):.6f}, all "
              f"{len(grads)} gradient leaves finite, grad norm "
              f"{_global_norm(grads):.4f}; {ms:.1f} ms, "
              f"{TRAIN_SEQ / ms * 1e3:.0f} tokens/s, peak {_peak_gb():.2f} GB")
        del grads
    torch.cuda.reset_peak_memory_stats()
    tokens = synthetic_batch(MODEL_SEED + 2, cfg, 1, PREFILL_SEQ)
    with torch.no_grad():
        logits, ms = _timed(lambda: apply_prefill(params, cfg, tokens))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("mamba2-full prefill: non-finite logits")
        print(f"    prefill at {PREFILL_SEQ}: {ms:.1f} ms, "
              f"{PREFILL_SEQ / ms * 1e3:.0f} tokens/s, peak {_peak_gb():.2f} "
              f"GB")
        ins = _ssd_layer_inputs(params, cfg, batch["tokens"][:, :SSD_SEQ])
        (y, h), ms = _timed(lambda: ssm._ssd_chunked(cfg, *ins))
        y_seq, h_seq = _ssd_sequential(*ins)
    y_err = _scaled_check("mamba2 SSD y", y, y_seq, SSD_REL)
    h_err = _scaled_check("mamba2 SSD state", h, h_seq, SSD_REL)
    print(f"    layer 0's SSD at S = {SSD_SEQ}, f32 ({ins[0].shape[2]} heads "
          f"x {ins[0].shape[3]} x state {ins[2].shape[-1]}): chunked {ms:.1f} "
          f"ms; against the float64 recurrence y {y_err:.2e}, final state "
          f"{h_err:.2e} of max-abs (limit {SSD_REL:g}); wall "
          f"{time.perf_counter() - t0:.3f} s")


def models_path(card):
    """Phase 9: the model zoo on the card."""
    import torch

    print("model zoo")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    models_smoke(card)
    minitron_wide(card)
    minitron_full(card)
    mamba2_full(card)
    torch.cuda.empty_cache()
    print(f"  phase 9 wall {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# phase 10: the mesh trainer and the decode launcher
# ---------------------------------------------------------------------------

# train-minitron-wide: a full round, then three difference rounds, on a tape
TRAIN_COINS = (True, False, False, False)
# the step's whole aggregate (``make_train_step``'s on_aggregate) against
# its definition from separate gradients, d their difference: CM of one
# row is the row, clipped on difference rounds, so the aggregate must be
# d's entries times the clip factor, cast to the messages' bf16, bit for
# bit, where the factor is the one the kernels give for d (row_norms' sums
# over the whole tree); that factor within TRAIN_FACTOR_RTOL of the plain
# code's (torch's f32 sums, in another order); and g+ = agg, or g + agg in
# f32 cast to bf16, bit for bit
TRAIN_FACTOR_RTOL = 1e-5
# train-robust-8rank (tests/test_torch_train_mesh.py holds the same job
# and thresholds on the CPU: CM 5.5637 -> 5.4504, mean 11455 after 25
# steps); 12 steps for the script's time limit, the first full round
# among them (the CPU: CM 5.5637 -> 5.4109, mean 1187.7 after 12)
ROBUST_STEPS, ROBUST_MARGIN, ROBUST_RTOL = 12, 0.05, 1e-4
# mean takes gauss's noise whole every round: its loss climbs from the
# first step on and the runs part chaotically (a relative change of
# 1e-7 in the initial params moves the loss after the third step by
# 1.2e-4 and after the fourth by 5e-3 on the CPU), so the card is held
# to the CPU on mean's loss after the first ROBUST_MEAN_HELD steps, and
# on g after the first step (the first aggregate, of the TM kernel) at
# ROBUST_G_REL of each leaf's max-abs
ROBUST_MEAN_HELD, ROBUST_G_REL = 2, 1e-4
ROBUST_TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, d_ff=128, vocab=256, remat=False,
                   dtype="float32")
# the plans: cm and mean run the tensor-parallel split on the (4, 2) mesh;
# cm-zero3 is cm under zero3, which splits no model compute: params and g
# held in pieces over "model", each layer gathered over it in the pass,
# the worker's 2 rows split over it and the gathered leaves' gradients
# reduce-scattered; it is held as cm
ROBUST_PLANS = ("cm", "mean", "cm-zero3")
EXAMPLE_STEPS = 8
# decode-minitron: decode_32k's cache with its batch of 128 cut to 8
DECODE_B, DECODE_LEN, DECODE_CHECK, DECODE_TIMED = 8, 32768, 16, 8
# the f32 check's batch: 39.5 GB of weights and 17.2 of cache; two rows,
# so that a cache write that crosses rows shows
DECODE_F32_B = 2
# bf16 at batch 8 against the prefill, of the logits' max-abs, and the
# share of greedy tokens equal to the prefill's argmax: one token and t + 1
# tokens run GEMMs of other shapes, whose bf16 roundings grow over 32
# layers to 2.69e-2 and 0.953 (PERF.md, phase 10); a wrong cache or a
# wrong row moves both far past these bounds
DECODE_BF16_REL, DECODE_BF16_AGREE = 6e-2, 0.9
TRAIN_TIMEOUT = 600  # seconds for a spawned job or a subprocess
TRAINER_KERNELS = ("row_norms", "clip_bucket_select", "coordinate_median")
# what train-minitron-wide measured, for phase 11: the loss at x^0 on step
# 0's batch, the bytes the allocator grew by for params and g^0, the peak
# of its steps, and the file its g^0 leaves were saved to (host copies)
PHASE10 = {}


def _check_train_step(old, new, agg, cfg, tc, batch, full):
    """The one-worker (1, 1) step against its definition: x+ = x - gamma g
    (f32, cast back) bit for bit; the step's whole aggregate ``agg`` (in
    the messages' dtype) = the gradient at x+ (full round: CM of one row
    is the row) or f d, with d the gradients' difference and f = min(1,
    lambda/||d||), lambda = 2 gamma ||g|| (CM clipped at lambda), bit for
    bit, with ||d|| from the ``row_ssq`` wrapper on d's leaves (on the
    card, the kernel) and f held to the plain code's; g+ = agg, or g + agg
    in f32 cast to g's dtype, bit for bit.  Each gradient comes from its
    own ``_value_and_grad`` call.  Returns the kernels' and the plain
    code's clip factors (None on a full round)."""
    import torch

    from repro_torch.core.tree_utils import tree_flatten, tree_norm
    from repro_torch.kernels.clip_aggregate import clip_factor, row_ssq

    p_old, g_old = tree_flatten(old.params)[0], tree_flatten(old.g)[0]
    for i, (x, g, got) in enumerate(zip(p_old, g_old,
                                        tree_flatten(new.params)[0])):
        if not torch.equal(got, (x.float() - tc.gamma * g.float()).to(
                x.dtype)):
            raise AssertionError(f"train-minitron-wide: params leaf {i} is "
                                 "not x - gamma g")
    want = _value_and_grad(new.params, cfg, batch)[2]
    factor = plain = None
    if not full:
        old_grads = _value_and_grad(old.params, cfg, batch)[2]
        for a, b in zip(want, old_grads):
            a.sub_(b)  # the difference, in the gradient dtype
        del old_grads
        radius = 2.0 * tc.gamma * tree_norm(g_old)
        ssq = sum(row_ssq(d.reshape(1, -1)) for d in want)
        factor = clip_factor(torch.sqrt(ssq), radius).float()
        plain = torch.clamp(radius / torch.sqrt(sum(
            (d.float() ** 2).sum() for d in want)), max=1.0)
        if not abs(float(factor) - float(plain)) <= (TRAIN_FACTOR_RTOL *
                                                     float(plain)):
            raise AssertionError(f"train-minitron-wide: clip factor "
                                 f"{float(factor):.8f} from row_ssq, "
                                 f"{float(plain):.8f} from torch's sums")
    for i, (a, got, g, w) in enumerate(zip(agg, tree_flatten(new.g)[0],
                                           g_old, want)):
        # on the card (bf16 values and their differences are exact in
        # f32): a host copy of the 1.05e9-value embedding would take
        # seconds a leaf
        ref = w if factor is None else (w.float() * factor).to(w.dtype)
        if not torch.equal(a, ref):
            k = int((a.float() - ref.float()).abs().argmax())
            raise AssertionError(
                f"train-minitron-wide aggregate leaf {i} {tuple(a.shape)}: "
                f"entry {k} is {float(a.reshape(-1)[k]):.6e}, its "
                f"definition {float(ref.reshape(-1)[k]):.6e}")
        ref = (ref if factor is None else g.float() + ref.float()).to(
            g.dtype)
        if not (bool(torch.isfinite(got).all()) and torch.equal(got, ref)):
            raise AssertionError(f"train-minitron-wide g leaf {i}: max err "
                                 f"{float((got - ref).abs().max()):.3e}")
    if factor is None:
        return None, None
    return float(factor), float(plain)


def train_minitron_wide(card, work):
    """train-minitron-wide: the trainer on NCCL with one rank, the (1, 1)
    mesh (one worker), minitron-8b at full width with 2 layers, bf16,
    remat, seq 4,096, the default plan (sharded CM, alpha 2); 4 steps on a
    tape, each checked against its definition.  Returns the launches."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.api.mesh_exec import (collective_counts,
                                           reset_collective_counts)
    from repro_torch.configs import get_config
    from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import (ByzTrainConfig, MeshTrainState,
                                          TrainTape, make_train_step,
                                          train_key, worker_grads)
    from repro_torch.models import apply_train, init_params, param_count

    t0 = _run_header(
        "train-minitron-wide", card,
        f"n_layers 32 -> 2, train_4k's batch 256 -> 1 (seq {TRAIN_SEQ}), "
        f"one worker on the (1, 1) mesh, 4 steps (coins {TRAIN_COINS})")
    cfg = get_config("minitron_8b", n_layers=2)
    tc = ByzTrainConfig(n_byz=0)  # the default plan; gamma 3e-4
    counts = dict.fromkeys(ops.launch_counts(), 0)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        work, "rendezvous_train"), rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1)
        batches = [synthetic_batch(MODEL_SEED + 1 + k, cfg, 1, TRAIN_SEQ)
                   for k in range(len(TRAIN_COINS) + 1)]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        params = init_params(MODEL_SEED, cfg)
        with torch.no_grad():  # phase 11 holds its split's loss to this one
            PHASE10["loss0"] = float(apply_train(params, cfg,
                                                 batches[1])[0])
        g0 = tree_unflatten(tree_flatten(params)[1],
                            worker_grads(params, cfg, batches[0]))
        state = MeshTrainState(params, g0, train_key(tc.seed),
                               torch.zeros((), dtype=torch.int32))
        del params, g0
        torch.cuda.synchronize()
        PHASE10["state_bytes"] = torch.cuda.memory_allocated() - before
        # host copies of g^0 for phase 11's split, written to a file after
        # the timed steps
        g0_host = [x.cpu() for x in tree_flatten(state.g)[0]]
        n = len(TRAIN_COINS)
        tape = TrainTape(c=np.array(TRAIN_COINS), sampled=np.ones((n, 1), bool),
                         order=np.zeros((n, 1), np.int64))
        probe = []
        step = make_train_step(cfg, mesh, tc, on_aggregate=lambda full, agg:
                               probe.append(agg))
        print(f"    {param_count(cfg):,} parameters, {cfg.dtype}, remat "
              f"{cfg.remat}; loss at x^0 on step 0's batch "
              f"{PHASE10['loss0']:.6f}; params and g^0 "
              f"{PHASE10['state_bytes']:,} bytes of the allocator's; "
              f"g^0 and init {time.perf_counter() - t0:.3f} s; "
              "check: params, the step's aggregate and g bit for bit, the "
              f"clip factor within {TRAIN_FACTOR_RTOL:g} of the plain one")
        for k, full in enumerate(TRAIN_COINS):
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            reset_collective_counts()
            new, ms = _timed(lambda: step(state, batches[k + 1], tape))
            peak = _peak_gb()
            PHASE10["peak_gb"] = max(PHASE10.get("peak_gb", 0.0), peak)
            launched = {a: b for a, b in ops.launch_counts().items() if b}
            colls = collective_counts()
            for a, b in ops.launch_counts().items():
                counts[a] += b
            _check_routes(f"train-minitron-wide step {k}", colls, "device")
            factor, plain = _check_train_step(
                state, new, probe.pop(), cfg, tc, batches[k + 1], full)
            kind = "full round" if full else (
                f"difference round, clip factor {factor:.8f} (plain "
                f"{plain:.8f})")
            print(f"    step {k} ({kind}): {ms:.1f} ms, "
                  f"{TRAIN_SEQ / ms * 1e3:.0f} tokens/s, peak {peak:.2f} GB; "
                  f"aggregate and g+ equal to their definitions; launches "
                  f"{launched}; collectives {colls}")
            state = new
            del new
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    del state, batches
    # phase 11's spawned ranks read it by mmap; synced, so that no
    # writeback of its 5.17 GB runs under a later timed step
    PHASE10["g0"] = str(work.parent / "chip_smoke_g0.pt")
    with open(PHASE10["g0"], "wb") as f:
        torch.save(g0_host, f)
        f.flush()
        os.fsync(f.fileno())
    del g0_host
    print(f"    train-minitron-wide wall {time.perf_counter() - t0:.3f} s")
    return counts


def _robust_job(rank, devices):
    """One rank of train-robust-8rank: the reference's robustness job
    (tests/test_mesh_trainer.py:588-635) on the (4, 2) mesh, once a
    device of ``devices``: per device and plan the loss on batch 0 before
    and after each of ROBUST_STEPS steps, the final params' digest and ms
    a step;
    the card run's launches and collectives, and its launches per plan;
    per plan the worst leaf error of g after the first step of the first
    device over the second's, of the leaf's max-abs."""
    import hashlib

    import torch

    from repro_torch.api import AggregatorSpec, ScheduleSpec, ServerPlan
    from repro_torch.api.mesh_exec import (collective_counts,
                                           reset_collective_counts)
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import (ByzTrainConfig, initial_state,
                                          make_train_step, train_loss)
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.models.model import gather_params

    torch.set_num_threads(1)
    cfg = ModelConfig(**ROBUST_TINY)
    mesh = make_debug_mesh(4, 2)
    out, g1 = {}, {}
    for dev in devices:
        if dev == "cuda":
            ops.reset_launch_counts()
            reset_collective_counts()
        for agg in ROBUST_PLANS:
            before = ops.launch_counts()
            if agg != "mean":  # the default plan: sharded CM, alpha = 2
                tc = ByzTrainConfig(gamma=0.3, n_byz=1, attack="gauss",
                                    p=0.125, shard_mode="zero3" if
                                    agg == "cm-zero3" else "tp")
            else:
                tc = ByzTrainConfig.from_plan(
                    ServerPlan(aggregate=AggregatorSpec("mean"),
                               schedule=ScheduleSpec(placement="naive")),
                    gamma=0.3, n_byz=1, attack="gauss", p=0.125)
            step = make_train_step(cfg, mesh, tc)
            # weights and batches drawn on the CPU, so that the card's run
            # starts where the CPU's does (a CUDA generator draws others)
            it = (_to(b, dev) for b in make_batch_iterator(
                cfg, 8, 64, seed=3, device="cpu"))
            params = _to(init_params(0, cfg, device="cpu"), dev)
            batch0 = next(it)
            state = initial_state(params, cfg, mesh, tc, batch0)
            start = train_loss(state.params, cfg, batch0, mesh, tc.shard_mode)
            losses, spent = [], 0.0
            for k in range(ROBUST_STEPS):
                t = time.perf_counter()
                state = step(state, next(it))
                if dev == "cuda":
                    torch.cuda.synchronize()
                spent += time.perf_counter() - t
                if k == 0:
                    g1[(dev, agg)] = [x.cpu() for x in
                                      tree_flatten(state.g)[0]]
                losses.append(train_loss(state.params, cfg, batch0, mesh,
                                         tc.shard_mode))
            digest = hashlib.sha256()
            for leaf in tree_flatten(gather_params(state.params, mesh, cfg,
                                                   tc.shard_mode))[0]:
                digest.update(leaf.cpu().numpy().tobytes())
            out[(dev, agg)] = (start, losses, digest.hexdigest(),
                               spent * 1e3 / ROBUST_STEPS)
            if dev == "cuda":
                out["launches " + agg] = {k: v - before.get(k, 0) for k, v in
                                          ops.launch_counts().items()}
        if dev == "cuda":
            out["launches"] = ops.launch_counts()
            out["collectives"] = collective_counts()
    for agg in ROBUST_PLANS:  # g after the first step, card against CPU
        out["g1 " + agg] = max(
            float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
            for a, b in zip(g1[(devices[0], agg)], g1[(devices[1], agg)]))
    return out


def train_robust(card):
    """train-robust-8rank: eight gloo ranks on cuda:0, then the same job on
    the CPU in the same ranks; returns the card run's launches summed over
    the ranks: of cm and mean (the split), and of cm-zero3."""
    from repro_torch.launch.mesh import spawn

    t0 = _run_header(
        "train-robust-8rank", card,
        "none (the reference's robustness job: 2 layers, d_model 64, vocab "
        f"256, f32, batch 8 x 64, gauss x1 of 4 workers, {ROBUST_STEPS} "
        "steps)")
    reports = spawn(_robust_job, 8, (("cuda", "cpu"),), timeout=TRAIN_TIMEOUT)
    first = reports[0]
    for rank, rep in enumerate(reports):
        for key in (k for k in rep if isinstance(k, tuple)):
            if rep[key][2] != first[key][2]:
                raise AssertionError(f"train-robust-8rank rank {rank} {key}: "
                                     "params differ from rank 0's")
        _check_routes(f"train-robust-8rank rank {rank}", rep["collectives"],
                      "host")
    for dev in ("cuda", "cpu"):
        (_, mean, _, mean_ms) = first[(dev, "mean")]
        for agg in ("cm", "cm-zero3"):
            cm0, cm, _, cm_ms = first[(dev, agg)]
            if not (cm[-1] < cm0 and cm[-1] < mean[-1] - ROBUST_MARGIN):
                raise AssertionError(f"train-robust-8rank on {dev}: {agg} "
                                     f"{cm0} -> {cm[-1]}, mean {mean[-1]}")
            print(f"    {dev}: {agg} {cm0:.6f} -> {cm[-1]:.6f} ({cm_ms:.1f} "
                  "ms a step)")
        print(f"    {dev}: mean -> {mean[-1]:.6f} ({mean_ms:.1f} ms a step); "
              "every rank's params (gathered whole) equal bit for bit")
    # the card against the CPU, step by step: CM at every step, mean after
    # its first ROBUST_MEAN_HELD steps; g after the first step for all
    for agg in ROBUST_PLANS:
        card, cpu = first[("cuda", agg)][1], first[("cpu", agg)][1]
        held = len(card) if agg != "mean" else ROBUST_MEAN_HELD
        rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
        bad = [k for k in range(held) if not rel[k] <= ROBUST_RTOL]
        if bad:
            raise AssertionError(f"train-robust-8rank {agg}: card vs CPU loss"
                                 f" after step {bad[0]}: {card[bad[0]]} vs "
                                 f"{cpu[bad[0]]} (rtol {ROBUST_RTOL:g})")
        g1 = max(rep["g1 " + agg] for rep in reports)
        if not g1 <= ROBUST_G_REL:
            raise AssertionError(f"train-robust-8rank {agg}: g after the "
                                 f"first step, card vs CPU {g1:.3e} of "
                                 "max-abs")
        parted = next((k for k, r in enumerate(rel) if r > ROBUST_RTOL), None)
        print(f"    {agg} card vs CPU: g after step 0 {g1:.2e} of max-abs "
              f"[{ROBUST_G_REL:g}]; the loss after steps 0-{held - 1} at "
              f"most {max(rel[:held]):.2e} [rtol {ROBUST_RTOL:g}], over all "
              f"{len(rel)} steps {max(rel):.2e} (first beyond the rtol: "
              f"{parted}); final card {card[-1]:.6f}, CPU {cpu[-1]:.6f}")
    split, zero3 = {}, {}
    for rank, rep in enumerate(reports):
        zero = rep["launches cm-zero3"]
        print(f"    rank {rank}: launches "
              f"{ {k: v for k, v in rep['launches'].items() if v} } "
              f"(cm-zero3's { {k: v for k, v in zero.items() if v} }); "
              f"collectives {rep['collectives']}")
        for k, v in rep["launches"].items():
            split[k] = split.get(k, 0) + v - zero[k]
            zero3[k] = zero3.get(k, 0) + zero[k]
    print(f"    checks: cm and cm-zero3 below their start and below mean - "
          f"{ROBUST_MARGIN:g} on both, the card's loss vs the CPU's [rtol "
          f"{ROBUST_RTOL:g}] after every step for cm and cm-zero3 and the "
          f"first {ROBUST_MEAN_HELD} for mean, g after the first step "
          f"[{ROBUST_G_REL:g} of max-abs], gloo's host route; wall "
          f"{time.perf_counter() - t0:.3f} s")
    return split, zero3


def train_example(card, work, src):
    """train-example: ``python -m repro_torch.train_marina_pp --smoke
    --steps 8 --ckpt-dir``, eight gloo ranks on cuda:0; OK, and the
    checkpoint restores to the final params."""
    import os

    from repro_torch.checkpoint import restore
    from repro_torch.models import init_params
    from repro_torch.train_marina_pp import build_config, params_digest

    t0 = _run_header("train-example", card,
                     f"--smoke --steps {EXAMPLE_STEPS} (the example's own "
                     "smoke size)")
    ckpt = work / "example_ckpt"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.train_marina_pp", "--smoke",
         "--steps", str(EXAMPLE_STEPS), "--ckpt-dir", str(ckpt)],
        cwd=src.parent, env=dict(os.environ, PYTHONPATH=str(src)),
        capture_output=True, text=True, timeout=TRAIN_TIMEOUT)
    lines = r.stdout.rstrip().splitlines()
    if r.returncode != 0 or not lines or lines[-1] != "OK":
        raise AssertionError(f"train-example: rc {r.returncode}\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    for line in lines:
        print(f"    | {line}")
    digest = params_digest(restore(str(ckpt), EXAMPLE_STEPS, init_params(
        0, build_config(True), device="cpu")))
    if f"final params sha256 {digest}" not in r.stdout:
        raise AssertionError("train-example: the checkpoint does not "
                             "restore to the final params")
    print(f"    the checkpoint restores to the final params (sha256 "
          f"{digest[:16]}...); wall {time.perf_counter() - t0:.3f} s")


def _decode_steps(params, cfg, cache, tokens, hold):
    """DECODE_CHECK ``make_serve_step`` steps from index 0, step t's logits
    against ``apply_prefill`` of the first t + 1 tokens (held at phase
    9's atol 2e-3 and rtol 2e-2 when ``hold``); returns the last next
    tokens, the cache, the worst abs error, the worst error over the
    prefill's max-abs and the share of greedy tokens equal to the
    prefill's argmax."""
    import torch

    from repro_torch.launch.serve import make_serve_step
    from repro_torch.models import apply_prefill

    step = make_serve_step(cfg)
    worst, worst_rel, agree = 0.0, 0.0, 0
    for t in range(DECODE_CHECK):
        nxt, logits, cache = step(params, {"tokens": tokens[:, t:t + 1]},
                                  cache, t)
        with torch.no_grad():
            want = apply_prefill(params, cfg, {"tokens": tokens[:, :t + 1]})
        err = (logits - want).abs()
        if not bool(torch.isfinite(logits).all()) or (hold and not bool(
                (err <= 2e-3 + 2e-2 * want.abs()).all())):
            raise AssertionError(f"decode-minitron {cfg.dtype} step {t}: "
                                 "differs from the prefill by "
                                 f"{float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
        worst_rel = max(worst_rel, float(err.max() / want.abs().max()))
        agree += int((nxt == want.argmax(dim=-1)).sum())
    if not (nxt.dtype == torch.int32 and nxt.shape == tokens.shape[:1]):
        raise AssertionError(f"decode-minitron: next tokens {nxt.dtype} "
                             f"{tuple(nxt.shape)}")
    return nxt, cache, worst, worst_rel, agree / nxt.numel() / DECODE_CHECK


def decode_minitron(card, src):
    """decode-minitron: minitron-8b as configured on decode_32k's cache
    (batch cut to 8, bf16): 16 decode steps from 0 against the prefill of
    the same tokens (bounds for bf16's roundings) and timed steps at the
    cache's last index; the same 16 steps in f32 at batch 2, held to the
    prefill at phase 9's tolerance; then the decode launcher and the demo
    as subprocesses."""
    import os

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.serve import make_serve_step
    from repro_torch.models import init_cache, init_params, param_count

    t0 = _run_header("decode-minitron", card,
                     f"decode_32k's batch 128 -> {DECODE_B} in bf16 and -> "
                     f"{DECODE_F32_B} in f32 (cache {DECODE_LEN})")
    cfg = get_config("minitron_8b")
    params = init_params(MODEL_SEED, cfg)
    cache = init_cache(cfg, DECODE_B, DECODE_LEN)
    cache_gb = sum(t.numel() * t.element_size() for t in
                   (cache["body"][0]["k"], cache["body"][0]["v"])) / 1e9
    step = make_serve_step(cfg)
    tokens = synthetic_batch(MODEL_SEED + 3, cfg, DECODE_B,
                             DECODE_CHECK)["tokens"]
    torch.cuda.synchronize()
    print(f"    {param_count(cfg):,} parameters, {cfg.n_layers} layers, "
          f"{cfg.dtype}; cache {cache_gb:.2f} GB; init "
          f"{time.perf_counter() - t0:.3f} s")
    nxt, cache, worst, rel, agree = _decode_steps(params, cfg, cache, tokens,
                                                  hold=False)
    print(f"    bf16: {DECODE_CHECK} decode steps from index 0 vs the "
          f"prefill of the same tokens: max abs err {worst:.3e} ({rel:.2e} "
          f"of max-abs) [{DECODE_BF16_REL:g}], greedy tokens equal to the "
          f"prefill's argmax {agree:.3f} [{DECODE_BF16_AGREE:g}]")
    if not (rel <= DECODE_BF16_REL and agree >= DECODE_BF16_AGREE):
        raise AssertionError("decode-minitron bf16: the decode steps "
                             "part from the prefill")
    torch.cuda.reset_peak_memory_stats()
    tok = nxt[:, None]
    ms = []
    for _ in range(DECODE_TIMED):
        (nxt, _, cache), m = _timed(lambda: step(
            params, {"tokens": tok}, cache, DECODE_LEN - 1))
        ms.append(m)
    if not bool(((nxt >= 0) & (nxt < cfg.vocab)).all()):
        raise AssertionError("decode-minitron: tokens outside the vocabulary")
    print(f"    at cache index {DECODE_LEN - 1}: {statistics.median(ms):.1f} "
          f"ms a token (median of {DECODE_TIMED}; first {ms[0]:.1f}, range "
          f"{min(ms):.1f}-{max(ms):.1f}), "
          f"{DECODE_B / statistics.median(ms) * 1e3:.1f} tokens/s, peak "
          f"{_peak_gb():.2f} GB")
    del params, cache
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(dtype="float32")
    params = init_params(MODEL_SEED, cfg32)
    _, _, worst, rel, agree = _decode_steps(
        params, cfg32, init_cache(cfg32, DECODE_F32_B, DECODE_LEN),
        tokens[:DECODE_F32_B], hold=True)
    print(f"    f32 at batch {DECODE_F32_B}: {DECODE_CHECK} decode steps vs "
          f"the prefill: max abs err {worst:.3e} ({rel:.2e} of max-abs) "
          f"[atol 2e-3, rtol 2e-2]; greedy tokens equal {agree:.3f}")
    del params
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=str(src))
    for cmd, want_ok in (
            (["-m", "repro_torch.launch.serve", "--arch", "minitron_8b"],
             False),
            (["-m", "repro_torch.serve_demo"], True)):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, *cmd], cwd=src.parent, env=env,
                           capture_output=True, text=True,
                           timeout=TRAIN_TIMEOUT)
        lines = r.stdout.rstrip().splitlines()
        if r.returncode != 0 or not lines or (want_ok and lines[-1] != "OK"):
            raise AssertionError(f"{' '.join(cmd)}: rc {r.returncode}\n"
                                 f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
        print(f"    {' '.join(cmd[1:])}: {lines[0]}"
              f"{' ... OK' if want_ok else ''} "
              f"({time.perf_counter() - t:.3f} s)")
    print(f"    decode-minitron wall {time.perf_counter() - t0:.3f} s")


def train_path(card):
    """Phase 10: the mesh trainer and the decode launcher; returns the
    trainer runs' launch counts."""
    import shutil

    import torch

    print("mesh trainer and decode")
    t0 = time.perf_counter()
    src = Path(__file__).resolve().parent / "src"
    work = src.parent / "build" / "chip_smoke_phase10"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    torch.cuda.set_device(0)
    torch.cuda.empty_cache()
    counts = {"train-minitron-wide": train_minitron_wide(card, work)}
    counts["train-robust-8rank"], counts["train-robust-zero3"] = \
        train_robust(card)
    for run, c in counts.items():
        missing = [k for k in TRAINER_KERNELS if not c.get(k)]
        if missing:
            raise AssertionError(f"{run}: {missing} not launched")
    train_example(card, work, src)
    decode_minitron(card, src)
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"  phase 10 wall {time.perf_counter() - t0:.3f} s")
    return counts

# ---------------------------------------------------------------------------
# phase 11: the tensor-parallel split and the dry run
# ---------------------------------------------------------------------------

# train-tp-small: the trainer's test model in f32, the default config
# (plan and gamma; one worker, no byzantine), a full round then three
# difference rounds
TP_TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
               d_ff=128, vocab=256, remat=False, dtype="float32")
TP_COINS = (True, False, False)  # few: the script's time limit
TP_SMALL_MESHES = ((1, 2), (1, 4))
TP_REL = 1e-5  # of each leaf's max-abs, against the one-rank card run
# train-tp-wide: a difference round, then a full round
TP_WIDE_COINS = (False, True)
# the step-0 loss against train-minitron-wide's: the split read 1.29e-5 on
# the card; a rehearsal on the CPU at reduced width (d_model 256, vocab
# 4,096, seq 256, bf16) read 3.65e-6, and 1.70e-3 with the MLP's row-split
# all-reduce left out (PERF.md, phase 11)
TP_WIDE_LOSS_RTOL = 1e-3
# each rank's g^0 pieces against the slices of train-minitron-wide's g^0
# on the same weights and batch, of each leaf's max-abs: bf16 products
# summed in other orders (the row splits' partial sums rounded to bf16
# before their all-reduce); that rehearsal read at most 1.77e-2 of a
# leaf's max-abs, and 0.72-1.62 a leaf with the all-reduce left out
TP_WIDE_G0_REL = 5e-2
DRYRUN_STATE_RTOL = 0.01  # the dry run's state bytes against the allocator


def _tp_tape(coins, workers=1):
    import numpy as np

    from repro_torch.launch.train import TrainTape

    n = len(coins)
    return TrainTape(c=np.array(coins), sampled=np.ones((n, workers), bool),
                     order=np.tile(np.arange(workers), (n, 1)))


def _tp_small_run(mesh_shape):
    """TINY on ``mesh_shape`` (its ranks on cuda:0, or one rank): per step
    this rank's params and g leaves (numpy), its launches and
    collectives, and its "model" coordinate."""
    import torch

    from repro_torch.api.mesh_exec import (collective_counts,
                                           reset_collective_counts)
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import (ByzTrainConfig, initial_state,
                                          make_train_step)
    from repro_torch.models import ModelConfig, init_params

    cfg = ModelConfig(**TP_TINY)
    mesh = make_debug_mesh(*mesh_shape)
    tc = ByzTrainConfig()  # the default plan and gamma; one honest worker
    # weights and batches from the CPU's generator, the same on every run
    it = (_to(b, "cuda") for b in make_batch_iterator(cfg, 2, 32, seed=3,
                                                      device="cpu"))
    state = initial_state(_to(init_params(0, cfg, device="cpu"), "cuda"),
                          cfg, mesh, tc, next(it))
    step = make_train_step(cfg, mesh, tc)
    tape = _tp_tape(TP_COINS)
    ops.reset_launch_counts()
    reset_collective_counts()
    steps = []
    for _ in TP_COINS:
        state = step(state, next(it), tape)
        # numpy: a spawned rank's tensors would cross by shared memory
        steps.append([[x.cpu().numpy() for x in
                       tree_flatten(getattr(state, w))[0]]
                      for w in ("params", "g")])
    torch.cuda.synchronize()
    return {"steps": steps, "model": mesh.get_local_rank("model"),
            "launches": {k: v for k, v in ops.launch_counts().items() if v},
            "collectives": collective_counts()}


def _rms_err(got, want, chunk=1 << 26):
    """||got - want|| / ||want|| (the root-mean-square error over the
    root-mean-square value), in f64 sums over chunks of ``chunk``
    values."""
    import torch

    a, b = got.reshape(-1), want.reshape(-1)
    num = den = torch.zeros((), dtype=torch.float64, device=a.device)
    for i in range(0, a.numel(), chunk):
        x, y = a[i:i + chunk].double(), b[i:i + chunk].double()
        num = num + (x - y).square().sum()
        den = den + y.square().sum()
    return float((num / den.clamp(min=1e-300)).sqrt())


def _rel_err(got, want, chunk=1 << 26):
    """max |got - want| / max |want| in f32, in chunks of ``chunk`` values
    (a 1.05e9-value leaf in f32 would take 4.2 GB at once)."""
    import torch

    a, b = got.reshape(-1), want.reshape(-1)
    err = scale = torch.zeros((), device=a.device)
    for i in range(0, a.numel(), chunk):
        x, y = a[i:i + chunk].float(), b[i:i + chunk].float()
        err = torch.maximum(err, (x - y).abs().max())
        scale = torch.maximum(scale, y.abs().max())
    return float(err / scale.clamp(min=1e-30))


def _split_mesh(shape):
    """The debug mesh of ``shape``: (data, model), or (pod, data, model)."""
    from repro_torch.launch.mesh import make_debug_mesh

    if len(shape) == 2:
        return make_debug_mesh(*shape)
    return make_debug_mesh(shape[1], shape[2], pod=shape[0])


def _tp_wide_run(g0_path, cfg=None, coins=TP_WIDE_COINS, routes=None,
                 mesh_shape=(1, 2), shard_mode="tp", rows=None):
    """train-tp-wide (``cfg``: minitron-8b with 2 layers by default) on
    this rank of the ``mesh_shape`` mesh (a (pod, data, model) one with
    the pods the workers), under ``shard_mode``, on batches of ``rows``
    (rows, sequence; one row of ``TRAIN_SEQ`` by default): the readings
    of ``_tp_wide_start`` and, per round (``coins``), ms, peak GB,
    launches and collectives."""
    import torch

    from repro_torch.api.mesh_exec import (collective_counts,
                                           reset_collective_counts)
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.kernels import ops

    out, state, step, batches = _tp_wide_start(
        g0_path, cfg, len(coins) + 1, routes, mesh_shape, shard_mode, rows)
    tape = _tp_tape(coins)
    rounds = []
    for k, full in enumerate(coins):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        reset_collective_counts()
        state, ms = _timed(lambda: step(state, batches[k + 1], tape))
        finite = all(bool(torch.isfinite(x).all())
                     for x in tree_flatten(state.g)[0])
        rounds.append({"full": full, "ms": ms, "peak_gb": _peak_gb(),
                       "finite": finite,
                       "launches": {a: b for a, b in
                                    ops.launch_counts().items() if b},
                       "collectives": collective_counts()})
    return {**out, "rounds": rounds}


def _tp_wide_start(g0_path, cfg=None, n_batches=2, routes=None,
                   mesh_shape=(1, 2), shard_mode="tp", rows=None,
                   device=None):
    """A wide split run's start (``_tp_wide_run``'s arguments) on
    ``device`` (the card by default): its held bytes and their
    ``param_specs`` sum, the step-0 loss (on the second batch), each
    leaf's error of its g^0 pieces (the first) against the slices of the
    one-rank g^0 (the file ``g0_path``); with the state, the train step
    and the ``n_batches`` batches.  With ``routes`` (a model of one MoE
    layer: the one-rank run's expert ids on step 0's batch, "g0", and on
    step 1's, "loss0"), g^0 and the step-0 loss route as the one-rank run
    did (``moe.record_routing``), and the step-0 loss is also taken on
    the split's own routing, whose choices that differ from the one-rank
    run's are counted."""
    import contextlib

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.mesh import P
    from repro_torch.launch.train import (ByzTrainConfig, initial_state,
                                          make_train_step, train_loss)
    from repro_torch.models import init_params, moe
    from repro_torch.models.model import shard_params
    from repro_torch.sharding.rules import local_shape, param_specs

    def pinned(name):
        return (moe.record_routing(torch.from_numpy(routes[name]))
                if routes else contextlib.nullcontext())

    torch.cuda.empty_cache()
    cfg = cfg or get_config("minitron_8b", n_layers=2)
    mesh = _split_mesh(mesh_shape)
    waxes = ("pod",) if len(mesh_shape) == 3 else ()
    # the default plan; gamma 3e-4
    tc = ByzTrainConfig(n_byz=0, shard_mode=shard_mode,
                        worker_axes_override=waxes)
    # the one-rank run's weights and batches: ``device``'s generator
    batches = [synthetic_batch(MODEL_SEED + 1 + k, cfg,
                               *(rows or (1, TRAIN_SEQ)), device=device)
               for k in range(n_batches)]
    whole = _open_gates(init_params(MODEL_SEED, cfg, device=device), cfg)
    specs = tree_flatten(param_specs(mesh, cfg, whole, shard_mode),
                         is_leaf=lambda x: isinstance(x, P))[0]
    want = sum(math.prod(local_shape(mesh, x.shape, sp)) * x.element_size()
               for x, sp in zip(tree_flatten(whole)[0], specs))
    treedef = tree_flatten(whole)[1]
    with pinned("g0"):
        state = initial_state(whole, cfg, mesh, tc, batches[0])
    del whole
    torch.cuda.empty_cache()
    held = {w: sum(x.numel() * x.element_size()
                   for x in tree_flatten(getattr(state, w))[0])
            for w in ("params", "g")}
    # g^0's pieces against the same cut of the one-rank g^0, leaf by leaf
    ref = tree_unflatten(treedef, torch.load(g0_path, mmap=True,
                                             weights_only=True))
    g0_errs, g0_rms = [], []
    for got, piece in zip(tree_flatten(state.g)[0], tree_flatten(
            shard_params(ref, mesh, cfg, shard_mode))[0]):
        piece = piece.to(got.device)
        g0_errs.append(_rel_err(got, piece))
        g0_rms.append(_rms_err(got, piece))
    del ref
    with pinned("loss0"):
        loss0 = train_loss(state.params, cfg, batches[1], mesh, shard_mode,
                           waxes)
    own = {}
    if routes:  # the split's own routing
        with moe.record_routing() as seen:
            own["loss0_own"] = train_loss(state.params, cfg, batches[1], mesh)
        own["flips"] = _flips(seen, routes["loss0"], "train-tp-v3-wide")
    return ({"held": held, "want": want, "loss0": loss0,
             "g0_errs": g0_errs, "g0_rms": g0_rms, **own}, state,
            make_train_step(cfg, mesh, tc), batches)


def _tp_job(rank, mesh_shape, g0_path):
    """Phase 11's part of a rank of the shared spawns: train-tp-small on
    ``mesh_shape`` (None: none) or, given train-minitron-wide's g^0 file,
    train-tp-wide."""
    out = {"small": _tp_small_run(mesh_shape)} if mesh_shape else {}
    if g0_path:
        out["wide"] = _tp_wide_run(g0_path)
    return out


def _held_slice(whole, mesh_shape, model_rank, cfg=None, mode="tp",
                data_rank=0):
    """The pieces a rank at ``model_rank`` (and, under fsdp_tp,
    ``data_rank``) of ``mesh_shape`` ((data, model) or (pod, data,
    model)) holds of the whole leaves of ``cfg`` (TP_TINY by default;
    ``held_specs`` under ``mode`` on an abstract mesh)."""
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.mesh import P
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.sharding.constraints import AbstractMesh
    from repro_torch.sharding.rules import held_specs

    cfg = cfg or ModelConfig(**TP_TINY)
    names = ("pod", "data", "model")[-len(mesh_shape):]
    mesh = AbstractMesh(mesh_shape, names)
    sizes = dict(zip(names, mesh_shape))
    coords = {"data": data_rank, "model": model_rank}
    specs = tree_flatten(held_specs(mesh, cfg, init_params(
        0, cfg, device="meta"), mode), is_leaf=lambda x: isinstance(x, P))[0]
    out = []
    for x, sp in zip(whole, specs):
        for j, entry in enumerate(sp):
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis in coords:  # the first axis of a tuple major
                    w = x.shape[j] // sizes[axis]
                    x = x.take(range(coords[axis] * w,
                                     (coords[axis] + 1) * w), axis=j)
        out.append(x)
    return out


def train_tp_small(card, whole, jobs):
    """train-tp-small's checks: the one-rank NCCL run of TINY (``whole``)
    against the spawns of 2 and 4 gloo ranks on cuda:0 (``jobs``: mesh
    shape -> the ranks' phase-11 reports; the 2-rank one also ran
    train-tp-wide); returns the launches of both runs, summed over the
    ranks, and train-tp-wide's ranks' reports."""
    from repro_torch.kernels import ops

    print(f"  train-tp-small on {card}; reduced: none (the mesh trainer's "
          "test model: 2 layers, d_model 64, 4 heads, 2 kv heads, vocab "
          f"256, f32; batch 2 x 32, {len(TP_COINS)} steps on a tape, coins "
          f"{TP_COINS})")
    # every kernel's count, launched or not: the kernels line reads them
    counts = {run: dict.fromkeys(ops.launch_counts(), 0)
              for run in ("train-tp-small", "train-tp-wide")}
    for shape, reports in jobs.items():
        worst = 0.0
        for rank, rep in enumerate(reports):
            r = rep["small"]
            for k, (got, ref) in enumerate(zip(r["steps"], whole["steps"])):
                for what, g, w in zip(("params", "g"), got, ref):
                    for i, (a, b) in enumerate(zip(g, _held_slice(
                            w, shape, r["model"]))):
                        if a.shape != b.shape:
                            raise AssertionError(
                                f"train-tp-small {shape} rank {rank} {what} "
                                f"leaf {i}: {tuple(a.shape)}, not the "
                                f"piece {tuple(b.shape)}")
                        err = float(abs(a - b).max() /
                                    max(abs(b).max(), 1e-30))
                        worst = max(worst, err)
                        if not err <= TP_REL:
                            raise AssertionError(
                                f"train-tp-small {shape} rank {rank} step {k} "
                                f"{what} leaf {i}: {err:.3e} of max-abs "
                                f"[{TP_REL:g}]")
            _check_routes(f"train-tp-small {shape} rank {rank}",
                          r["collectives"], "host")
            for a, b in r["launches"].items():
                counts["train-tp-small"][a] += b
            print(f"    {shape} rank {rank} (model {r['model']}): launches "
                  f"{r['launches']}; collectives {r['collectives']}")
        print(f"    {shape}: every rank's pieces of params and g within "
              f"{worst:.3e} of max-abs of the one-rank card run's slices "
              f"after each of {len(TP_COINS)} steps [{TP_REL:g}]")
    print(f"    one-rank run: launches {whole['launches']}")
    wide = [rep["wide"] for rep in jobs[(1, 2)]]
    for rep in wide:
        for rnd in rep["rounds"]:
            for a, b in rnd["launches"].items():
                counts["train-tp-wide"][a] += b
    return counts, wide


def train_tp_wide(card, wide):
    """train-tp-wide's checks and readings (its ranks ran in
    ``train_tp_small``'s 2-rank spawn)."""
    print(f"  train-tp-wide on {card}; reduced: n_layers 32 -> 2, train_4k's "
          f"batch 256 -> 1 (seq {TRAIN_SEQ}), one worker on the (1, 2) "
          f"mesh, 2 gloo ranks on cuda:0, rounds {TP_WIDE_COINS} (True: "
          "full)")
    _check_wide("train-tp-wide", wide, PHASE10["loss0"],
                "train-minitron-wide", TP_WIDE_LOSS_RTOL, TP_WIDE_G0_REL)


def _check_wide(name, wide, want_loss, whole, loss_rtol, g0_rel):
    """The checks and readings of a wide split run's ranks (``wide``:
    their ``_tp_wide_run`` reports) against the one-rank run ``whole``:
    held bytes, step-0 loss (and, where the run was pinned to the whole
    run's routing, the loss on its own routing, with the choices that
    differ counted), each g^0 piece's max error of its leaf's max-abs
    (root-mean-square error of its root-mean-square printed beside),
    finite rounds on the host route."""
    for rank, rep in enumerate(wide):
        held = rep["held"]["params"] + rep["held"]["g"]
        if rep["held"]["params"] != rep["want"] or \
                rep["held"]["g"] != rep["want"]:
            raise AssertionError(
                f"{name} rank {rank}: held {rep['held']} bytes, its "
                f"param_specs pieces {rep['want']} each")
        rels = {}
        for key in ("loss0", "loss0_own"):
            if key not in rep:
                continue
            rels[key] = abs(rep[key] - want_loss) / abs(want_loss)
            if not rels[key] <= loss_rtol:
                raise AssertionError(
                    f"{name} rank {rank}: step-0 {key} {rep[key]:.6f}, "
                    f"{whole}'s {want_loss:.6f} (rtol {loss_rtol:g})")
        g0 = max(rep["g0_errs"])
        if not g0 <= g0_rel:
            worst = rep["g0_errs"].index(g0)
            raise AssertionError(
                f"{name} rank {rank}: g^0 leaf {worst} {g0:.3e} of "
                f"max-abs from {whole}'s [{g0_rel:g}]")
        own = ""
        if "flips" in rep:
            own = (f"; on its own routing {rep['loss0_own']:.6f} "
                   f"({rels['loss0_own']:.2e} relative), "
                   f"{rep['flips'][0]:,} of {rep['flips'][1]:,} (token, "
                   "choice) pairs routed to another expert than the "
                   "one-rank run's")
        print(f"    rank {rank}: params {rep['held']['params']:,} B and g "
              f"{rep['held']['g']:,} B held (= its param_specs pieces, "
              f"{held / 1e9:.3f} GB); step-0 loss {rep['loss0']:.6f} "
              f"({whole} {want_loss:.6f}, {rels['loss0']:.2e} relative "
              f"[{loss_rtol:g}]){own}; g^0 pieces within {g0:.3e} of "
              f"max-abs of {whole}'s [{g0_rel:g}] (by leaf "
              f"{', '.join(f'{e:.1e}' for e in rep['g0_errs'])}; of rms "
              f"{', '.join(f'{e:.1e}' for e in rep['g0_rms'])})")
        for rnd in rep["rounds"]:
            if not rnd["finite"]:
                raise AssertionError(f"{name} rank {rank}: g not finite")
            _check_routes(f"{name} rank {rank}", rnd["collectives"], "host")
            kind = "full round" if rnd["full"] else "difference round"
            print(f"      {kind}: {rnd['ms']:.1f} ms, peak "
                  f"{rnd['peak_gb']:.2f} GB; launches {rnd['launches']}; "
                  f"collectives {rnd['collectives']}")


def dryrun_vs_card(card):
    """dryrun-vs-card: the dry run of train-minitron-wide's config, batch
    and plan on the (1, 1) mesh against what the card allocated, and on
    (16, 16)."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.dryrun import run_one
    from repro_torch.launch.train import ByzTrainConfig, train_key

    t0 = _run_header("dryrun-vs-card", card,
                     "train-minitron-wide's config (2 of 32 layers) and batch "
                     "(1 x 4,096) on meta tensors")
    cfg = get_config("minitron_8b", n_layers=2)
    shape = dc.replace(SHAPES["train_4k"], global_batch=1)
    tc = ByzTrainConfig(n_byz=0)
    host = train_key(0).numel() + 4  # the key and the step stay on the host
    recs = {mesh: run_one("minitron_8b", shape, multi_pod=False, mesh=mesh,
                          cfg=cfg, train_cfg=tc, out_dir="", verbose=False)
            for mesh in ("1x1", "16x16")}
    one = recs["1x1"]
    dry = one["state_bytes"] - host
    got = PHASE10["state_bytes"]
    rel = abs(dry - got) / got
    if not rel <= DRYRUN_STATE_RTOL:
        raise AssertionError(f"dryrun-vs-card: the dry run's state {dry:,} B,"
                             f" the allocator's {got:,} B ({rel:.2e})")
    print(f"    (1, 1): params and g {dry:,} B on meta, the allocator grew by "
          f"{got:,} B when phase 10 built them ({rel:.2e} relative "
          f"[{DRYRUN_STATE_RTOL:g}]); temp {one['memory']['temp_size_in_bytes'] / 1e9:.2f} GB "
          f"on meta beside train-minitron-wide's measured peak "
          f"{PHASE10['peak_gb']:.2f} GB; flops "
          f"{one['cost']['flops']:.4e}; traced in {one['trace_s']} s")
    big = recs["16x16"]
    print(f"    (16, 16): the rank's params and g {big['state_bytes'] - host:,} "
          f"B ({(big['state_bytes'] - host) / dry:.4f} of (1, 1)'s), temp "
          f"{big['memory']['temp_size_in_bytes'] / 1e9:.2f} GB, model split "
          f"{big['model_split']}, collectives {big['collectives']['bytes']} "
          f"B; traced in {big['trace_s']} s; wall "
          f"{time.perf_counter() - t0:.3f} s")


def tp_path(card, whole, jobs):
    """Phase 11's checks: the tensor-parallel split (its runs in
    ``split_paths``) and the dry run; returns the split runs' launch
    counts."""
    import torch

    print("tensor-parallel split and dry run")
    t0 = time.perf_counter()
    counts, wide = train_tp_small(card, whole, jobs)
    train_tp_wide(card, wide)
    for run, c in counts.items():
        missing = [k for k in TRAINER_KERNELS if not c.get(k)]
        if missing:
            raise AssertionError(f"{run}: {missing} not launched")
    dryrun_vs_card(card)
    torch.cuda.empty_cache()
    print(f"  phase 11 checks and dry run {time.perf_counter() - t0:.3f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 12: the split of the MoE and MLA decoders
# ---------------------------------------------------------------------------

MOE_ARCHS = ("arctic_480b", "deepseek_v3_671b")
# train-tp-moe-small: the smoke configs in f32 (remat on), the default
# config (plan and gamma; one honest worker), a full round then a
# difference round (few: the script's time limit)
MOE_COINS = (True, False)
MOE_SMALL_MESHES = ((1, 2), (1, 4))
MOE_REL = 1e-5  # of each leaf's max-abs, against the one-rank card run
# train-tp-v3-wide: deepseek-v3-671b at full width, 2 layers (the dense
# prefix layer and one MoE layer) and 32 of its 256 experts, bf16, remat
V3_WIDE = dict(n_layers=2, first_dense_layers=1, n_experts=32)
V3_WIDE_COINS = (True, False)  # few: the script's time limit
# the step-0 loss and the gradient pieces against the one-rank run's: the
# split routes by the one-rank run's expert ids (``moe.record_routing``),
# since the top-k on bf16 activations picks other experts for a few
# tokens when the split's sums round otherwise (counted, and the loss on
# the split's own routing held too); limits set between the sound
# reading and a planted fault (the MoE combine's all-reduce left out), in
# PERF.md, phase 12
V3_LOSS_RTOL = 5e-5
V3_G_REL = 5e-2  # of each leaf's max-abs, as train-tp-wide's
# moe-v3-full-experts: the same 2 layers with all 256 experts; the
# experts held against the whole run's: each rank's first and last
V3_FULL = dict(n_layers=2, first_dense_layers=1)
V3_KEPT_EXPERTS = (0, 127, 128, 255)
MOE_TIMEOUT = 900  # seconds for a spawned job


def _small_split_run(arch, mesh_shape, coins=MOE_COINS, shard_mode="tp"):
    """The smoke config of ``arch`` (``_small_config``; a cross-attention
    model's gates opened) on ``mesh_shape`` (its ranks on cuda:0, or one rank; a (pod,
    data, model) mesh with the pods the workers) under ``shard_mode``
    for the rounds ``coins``: per step this rank's params and g leaves
    (numpy), its held bytes and their ``param_specs`` sum, the choices
    its MoE layers dropped, its launches, collectives, "data" and
    "model" coordinates and the mode."""
    import torch

    from repro_torch.api.mesh_exec import (collective_counts,
                                           reset_collective_counts)
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import P
    from repro_torch.launch.train import (ByzTrainConfig, initial_state,
                                          make_train_step)
    from repro_torch.models import init_params, moe
    from repro_torch.sharding.rules import local_shape, param_specs

    cfg = _small_config(arch)
    mesh = _split_mesh(mesh_shape)
    # the default plan and gamma; one honest worker
    tc = ByzTrainConfig(shard_mode=shard_mode, worker_axes_override=(
        ("pod",) if len(mesh_shape) == 3 else ()))
    it = (_to(b, "cuda") for b in make_batch_iterator(cfg, 2, 32, seed=3,
                                                      device="cpu"))
    whole = _open_gates(init_params(0, cfg, device="cpu"), cfg)
    specs = tree_flatten(param_specs(mesh, cfg, whole, shard_mode),
                         is_leaf=lambda x: isinstance(x, P))[0]
    want = sum(math.prod(local_shape(mesh, x.shape, sp)) * x.element_size()
               for x, sp in zip(tree_flatten(whole)[0], specs))
    state = initial_state(_to(whole, "cuda"), cfg, mesh, tc, next(it))
    step = make_train_step(cfg, mesh, tc)
    tape = _tp_tape(coins)
    ops.reset_launch_counts()
    reset_collective_counts()
    steps = []
    with moe.count_drops() as drops:
        for _ in coins:
            state = step(state, next(it), tape)
            steps.append([[x.cpu().numpy() for x in
                           tree_flatten(getattr(state, w))[0]]
                          for w in ("params", "g")])
    torch.cuda.synchronize()
    held = {w: sum(x.numel() * x.element_size()
                   for x in tree_flatten(getattr(state, w))[0])
            for w in ("params", "g")}
    return {"steps": steps, "model": mesh.get_local_rank("model"),
            "data": mesh.get_local_rank("data"), "mode": shard_mode,
            "held": held, "want": want, "drops": int(drops[0]),
            "launches": {k: v for k, v in ops.launch_counts().items() if v},
            "collectives": collective_counts()}


def _routings(log, what, layers=1):
    """The routings of a model with ``layers`` MoE layers, whose passes
    (recomputed ones too) recorded in ``log`` (``moe.record_routing``)
    must have run the layers in turn and each layer's passes chosen
    alike: a list of its (T, K) expert ids a layer, numpy."""
    import torch

    if not log or len(log) % layers or any(
            not torch.equal(x, log[i % layers])
            for i, x in enumerate(log)):
        raise AssertionError(f"{what}: {len(log)} MoE passes, not one "
                             f"routing a layer of {layers}")
    return [x.cpu().numpy() for x in log[:layers]]


def _one_routing(log, what):
    """The routing of a model with one MoE layer (``_routings``)."""
    return _routings(log, what)[0]


def _flips(log, want, what):
    """(the (token, choice) pairs whose expert in the routing recorded in
    ``log`` differs from ``want``'s, all pairs); ``want``: the (T, K)
    expert ids, or a list of them a MoE layer."""
    wants = want if isinstance(want, list) else [want]
    got = _routings(log, what, len(wants))
    return (sum(int((g != w).sum()) for g, w in zip(got, wants)),
            sum(int(w.size) for w in wants))


def _v3_full_split(ref_path):
    """moe-v3-full-experts on this rank of the (1, 2) mesh
    (``_full_split``)."""
    from repro_torch.configs import get_config

    return _full_split(ref_path, get_config("deepseek_v3_671b", **V3_FULL),
                       V3_KEPT_EXPERTS, "moe-v3-full-experts")


def _full_split(ref_path, cfg, kept, what):
    """The split of ``cfg`` (its MoE layers' experts whole on one card) on
    this rank of the (1, 2) mesh: the ranks make the whole params one
    after another and keep their pieces; the loss on the split's own
    routing, with the choices that differ from the one-rank run's
    counted; the loss and the gradient of the pieces routed as the
    one-rank run (the file ``ref_path``) was (``apply_train`` split, no
    trainer); the error of every non-expert leaf and of this rank's first
    and last expert (``kept``: the whole run's experts kept, each rank's
    first and last) against the one-rank run's, its held bytes and their
    ``param_specs`` sum, its values and peak GB."""
    import torch
    import torch.distributed as dist

    from repro_torch.api.mesh_exec import _local_piece
    from repro_torch.core.tree_utils import tree_flatten, tree_map
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.mesh import P, make_debug_mesh
    from repro_torch.launch.train import (model_axis_of, train_loss,
                                          worker_grads)
    from repro_torch.models import init_params, moe
    from repro_torch.models.model import shard_params
    from repro_torch.sharding.rules import held_specs, local_shape

    mesh = make_debug_mesh(1, 2)
    r = mesh.get_local_rank("model")
    batch = synthetic_batch(MODEL_SEED + 1, cfg, 1, TRAIN_SEQ)
    held = None
    for owner in range(2):  # one whole tree on the card at a time
        if r == owner:
            whole = init_params(MODEL_SEED, cfg)
            # storage of their own: a piece may be a view of the whole
            held = tree_map(torch.clone, shard_params(whole, mesh, cfg))
            del whole
            torch.cuda.empty_cache()
        dist.barrier()
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    torch.cuda.reset_peak_memory_stats()
    with moe.record_routing() as seen:
        own_loss = train_loss(held, cfg, batch, mesh)
    flips = _flips(seen, [x.numpy() for x in ref["routing"]], what)
    with moe.record_routing(ref["routing"]):
        loss = train_loss(held, cfg, batch, mesh)
        grads, ms = _timed(lambda: worker_grads(held, cfg, batch,
                                                model_axis_of(mesh, cfg)))
    peak = _peak_gb()
    leaves = tree_flatten(held)[0]
    n_values = sum(x.numel() for x in leaves)
    whole = tree_flatten(init_params(0, cfg, device="meta"))[0]
    specs = tree_flatten(held_specs(mesh, cfg, init_params(
        0, cfg, device="meta")), is_leaf=lambda x: isinstance(x, P))[0]
    held_bytes = sum(x.numel() * x.element_size() for x in leaves)
    want_bytes = sum(math.prod(local_shape(mesh, x.shape, sp))
                     * x.element_size() for x, sp in zip(whole, specs))
    errs, rms = {}, {}
    for i, g in enumerate(grads):
        if i in ref["experts"]:  # (1, 4, ...): the experts ``kept``
            for j, local in enumerate((0, g.shape[1] - 1)):
                want = ref["experts"][i][:, 2 * r + j].to(g.device)
                at = (i, kept[2 * r + j])
                errs[at] = _rel_err(g[:, local], want)
                rms[at] = _rms_err(g[:, local], want)
        else:
            piece = _local_piece(ref["leaves"][i], specs[i],
                                 mesh).to(g.device)
            errs[(i, None)] = _rel_err(g, piece)
            rms[(i, None)] = _rms_err(g, piece)
    return {"loss": loss, "own_loss": own_loss, "flips": flips,
            "want_loss": ref["loss"], "errs": errs, "rms": rms,
            "peak_gb": peak, "ms": ms, "values": n_values,
            "held": held_bytes, "want": want_bytes}


def _moe_job(rank, mesh_shape, g0_path, ref_path, routes):
    """Phase 12's part of a rank of the shared spawns: train-tp-moe-small
    on ``mesh_shape`` (None: none) for both configs or, given the one-rank
    runs' files (and train-tp-v3-wide's routings), train-tp-v3-wide and
    moe-v3-full-experts."""
    import torch

    out = {"small": {arch: _small_split_run(arch, mesh_shape)
                     for arch in MOE_ARCHS}} if mesh_shape else {}
    if g0_path:
        from repro_torch.configs import get_config

        out["wide"] = _tp_wide_run(
            g0_path, get_config("deepseek_v3_671b", **V3_WIDE), V3_WIDE_COINS,
            routes)
        torch.cuda.empty_cache()
        out["full"] = _v3_full_split(ref_path)
    return out


def _v3_wide_whole(card, work):
    """train-tp-v3-wide's one-rank whole run in this process: its step-0
    loss and g^0 (written to disk) and the routings of both; returns the
    file and the readings."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.train import worker_grads
    from repro_torch.models import apply_train, init_params, moe, param_count

    out = {}
    t0 = _run_header(
        "train-tp-v3-wide (one rank, whole)", card,
        "n_layers 61 -> 2 (first_dense_layers 3 -> 1, one MoE layer), "
        f"n_experts 256 -> 32, train_4k's batch 256 -> 1 (seq {TRAIN_SEQ}); "
        "d_model 7,168, 128 heads, MLA ranks 1,536 / 512 / 64, 2,048 per "
        "expert, top-8, one shared expert, vocab 129,280, MTP on, bf16, "
        "remat on")
    cfg = get_config("deepseek_v3_671b", **V3_WIDE)
    batches = [synthetic_batch(MODEL_SEED + 1 + k, cfg, 1, TRAIN_SEQ)
               for k in range(2)]
    params = init_params(MODEL_SEED, cfg)
    with torch.no_grad(), moe.record_routing() as seen:
        out["wide_loss0"] = float(apply_train(params, cfg, batches[1])[0])
    routes = {"loss0": _one_routing(seen, "train-tp-v3-wide")}
    with moe.record_routing() as seen:
        g0, ms = _timed(lambda: worker_grads(params, cfg, batches[0]))
    routes["g0"] = _one_routing(seen, "train-tp-v3-wide")
    out["wide_routes"] = routes
    if not all(bool(torch.isfinite(g).all()) for g in g0):
        raise AssertionError("train-tp-v3-wide: the whole g^0 not finite")
    peak = _peak_gb()
    out["g0"] = str(work / "v3_wide_g0.pt")
    _save([g.cpu() for g in g0], out["g0"])
    print(f"    {param_count(cfg):,} parameters; loss at x^0 on step 0's "
          f"batch {out['wide_loss0']:.6f}; g^0 in {ms:.1f} ms, peak "
          f"{peak:.2f} GB; wall {time.perf_counter() - t0:.3f} s")
    del params, g0
    torch.cuda.empty_cache()
    return out


def _v3_full_whole(card, work):
    """moe-v3-full-experts' one-rank whole run in this process
    (``_full_whole``)."""
    from repro_torch.configs import get_config

    t0 = _run_header(
        "moe-v3-full-experts (one rank, whole)", card,
        "n_layers 61 -> 2 (first_dense_layers 3 -> 1, one MoE layer) with "
        f"all 256 experts, train_4k's batch 256 -> 1 (seq {TRAIN_SEQ}); "
        "bf16, remat on; apply_train's loss and gradient, no trainer")
    ref, peak, loss = _full_whole(get_config("deepseek_v3_671b", **V3_FULL),
                                  V3_KEPT_EXPERTS, "moe-v3-full-experts",
                                  work / "v3_full_ref.pt", t0)
    return {"ref": ref, "full_peak": peak, "full_loss": loss}


def _full_whole(cfg, kept, what, path, t0):
    """The one-rank whole run of ``cfg`` in this process: its loss, its
    routing (one a MoE layer) and the gradient leaves its split is held
    to (every non-expert leaf, and the experts ``kept`` of each expert
    stack), written to ``path``; returns the file, the peak GB and the
    loss."""
    import torch

    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.train import worker_grads
    from repro_torch.models import apply_train, init_params, moe

    layers = sum(m == "moe" for m in cfg.mlp_pattern) * cfg.n_periods
    batch = synthetic_batch(MODEL_SEED + 1, cfg, 1, TRAIN_SEQ)
    params = init_params(MODEL_SEED, cfg)
    leaves, _ = tree_flatten(params)
    n_values = sum(x.numel() for x in leaves)
    with torch.no_grad(), moe.record_routing() as seen:
        loss = float(apply_train(params, cfg, batch)[0])
    routing = _routings(seen, what, layers)
    with moe.record_routing() as seen:
        grads, ms = _timed(lambda: worker_grads(params, cfg, batch))
    if _flips(seen, routing, what)[0]:
        raise AssertionError(f"{what}: the gradient's pass routed "
                             "otherwise than the loss's")
    peak = _peak_gb()
    # the expert stacks: (1, E, ...) leaves; kept, the experts ``kept`` of
    # them, and every other leaf, on the host
    stacks = [i for i, x in enumerate(leaves)
              if x.dim() == 4 and x.shape[1] == cfg.n_experts]
    ref = {"loss": loss, "routing": [torch.from_numpy(r) for r in routing],
           "leaves": {}, "experts": {}}
    for i, g in enumerate(grads):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: leaf {i} not finite")
        if i in stacks:
            ref["experts"][i] = g[:, list(kept)].cpu()
        else:
            ref["leaves"][i] = g.cpu()
    del params, grads, leaves, g
    _save(ref, path)
    print(f"    {n_values:,} parameters ({n_values * 2 / 1e9:.2f} GB bf16); "
          f"loss {loss:.6f}; gradient in {ms:.1f} ms, peak {peak:.2f} GB; "
          f"expert stacks {stacks} (experts {kept} kept); wall "
          f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.empty_cache()
    return str(path), peak, loss


def _save(obj, path):
    """``torch.save`` to ``path``, synced, so that no writeback runs under
    a later timed step."""
    import os

    import torch

    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def _check_moe_small(whole, jobs, counts):
    """train-tp-moe-small's checks (``_check_small``), dropped choices
    too."""
    _check_small("train-tp-moe-small", MOE_ARCHS, whole, jobs, counts,
                 MOE_COINS, MOE_REL, drops=True)


def _check_small(name, archs, whole, jobs, counts, coins, rel, drops,
                 loose=(), loose_rel=None):
    """A small split run's checks: each rank's pieces against the slices
    of the one-rank run's after each round of ``coins`` (``rel`` of
    max-abs; ``loose_rel`` for the leaves named in ``loose``, the last
    key on their path), held bytes, the MoE layers' dropped choices (where
    ``drops``), the trainer's kernels on every rank; adds the launches to
    ``counts``."""
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.models import init_params
    from repro_torch.sharding.rules import _map_with_name

    for arch in archs:
        cfg = _small_config(arch)
        names = tree_flatten(_map_with_name(
            lambda leaf, _: leaf, init_params(0, cfg, device="meta")))[0]
        one = whole[arch]
        for shape, reports in jobs.items():
            worst = [0.0, 0.0]  # the other leaves', the loose ones'
            where = ""  # the worst of the other leaves

            for rank, rep in enumerate(reports):
                r = rep["small"][arch]
                what = f"{name} {arch} {shape} rank {rank}"
                for k, (got, ref) in enumerate(zip(r["steps"],
                                                   one["steps"])):
                    for leaf, g, w in zip(("params", "g"), got, ref):
                        for i, (a, b) in enumerate(zip(g, _held_slice(
                                w, shape, r["model"], cfg, r["mode"],
                                r["data"]))):
                            if a.shape != b.shape:
                                raise AssertionError(
                                    f"{what} {leaf} leaf {i}: "
                                    f"{tuple(a.shape)}, not the piece "
                                    f"{tuple(b.shape)}")
                            err = float(abs(a - b).max() /
                                        max(abs(b).max(), 1e-30))
                            at = int(names[i] in loose)
                            if not at and err >= worst[0]:
                                where = (f"rank {rank} step {k} {leaf} "
                                         f"leaf {i} ({names[i]})")
                            worst[at] = max(worst[at], err)
                            limit = loose_rel if at else rel
                            if not err <= limit:
                                raise AssertionError(
                                    f"{what} step {k} {leaf} leaf {i} "
                                    f"({names[i]}): {err:.3e} of max-abs "
                                    f"[{limit:g}]")
                if r["held"] != {"params": r["want"], "g": r["want"]}:
                    raise AssertionError(f"{what}: held {r['held']} bytes, "
                                         f"its pieces {r['want']} each")
                if drops and not r["drops"] > 0:
                    raise AssertionError(f"{what}: no choice dropped")
                missing = [k for k in TRAINER_KERNELS
                           if not r["launches"].get(k)]
                if missing:
                    raise AssertionError(f"{what}: {missing} not launched")
                _check_routes(what, r["collectives"], "host")
                for a, b in r["launches"].items():
                    counts[a] += b
                print(f"    {arch} {shape} rank {rank} (model {r['model']}):"
                      f" held {r['held']['params']:,} B of params and of g "
                      f"(= its pieces); {r['drops']} choices dropped; "
                      f"launches {r['launches']}; collectives "
                      f"{r['collectives']}")
            held_at = (f"; {', '.join(loose)} within {worst[1]:.3e} "
                       f"[{loose_rel:g}]" if loose else "")
            print(f"    {arch} {shape}: every rank's pieces of params and g "
                  f"within {worst[0]:.3e} of max-abs of the one-rank card "
                  f"run's slices after each of {len(coins)} rounds "
                  f"[{rel:g}] (the worst: {where}){held_at}")
        print(f"    {arch} one-rank run: {one['drops']} choices dropped; "
              f"launches {one['launches']}")


def _check_v3_full(full, whole_peak):
    """moe-v3-full-experts' checks on each rank of the split."""
    _check_full("moe-v3-full-experts", full, whole_peak, V3_LOSS_RTOL,
                V3_LOSS_RTOL, V3_G_REL)


def _check_full(what, full, whole_peak, loss_rtol, own_rtol, g_rel,
                rms_rel=None):
    """The checks of a split's ranks (``full``: their ``_full_split``
    reports) against the whole run: held bytes, the loss routed as the
    whole run (``loss_rtol``) and on the split's own routing (``own_rtol``,
    or reported only when None), each gradient piece's max error of its
    leaf's max-abs (``g_rel``; a piece whose root-mean-square error of
    its root-mean-square is within ``rms_rel`` passes too)."""
    for rank, rep in enumerate(full):
        if rep["held"] != rep["want"]:
            raise AssertionError(f"{what} rank {rank}: held {rep['held']:,} "
                                 f"B of params, its pieces {rep['want']:,}")
        rels = {}
        for key, rtol in (("loss", loss_rtol), ("own_loss", own_rtol)):
            rels[key] = abs(rep[key] - rep["want_loss"]) / abs(
                rep["want_loss"])
            if rtol is not None and not rels[key] <= rtol:
                raise AssertionError(
                    f"{what} rank {rank}: {key} {rep[key]:.6f}, the whole "
                    f"run's {rep['want_loss']:.6f} [{rtol:g}]")
        for at, err in rep["errs"].items():
            if not (err <= g_rel or (rms_rel is not None
                                     and rep["rms"][at] <= rms_rel)):
                raise AssertionError(
                    f"{what} rank {rank}: leaf {at} {err:.3e} of max-abs "
                    f"[{g_rel:g}], {rep['rms'][at]:.3e} of rms "
                    f"[{rms_rel}]")

        def show(errs):
            others = max((v, i) for (i, e), v in errs.items() if e is None)
            return (f"non-expert leaves {others[0]:.3e} (leaf {others[1]}), "
                    "experts ") + ", ".join(
                f"{e} (leaf {i}) {v:.3e}" for (i, e), v in sorted(
                    errs.items()) if e is not None)

        print(f"    rank {rank}: {rep['values']:,} values held "
              f"({rep['held']:,} B = its param_specs pieces); on its own "
              f"routing {rep['flips'][0]:,} of {rep['flips'][1]:,} (token, "
              f"choice) pairs routed to another expert than the whole "
              f"run's, loss {rep['own_loss']:.6f} ({rels['own_loss']:.2e} "
              f"relative [{own_rtol}]); routed as the whole run: "
              f"loss {rep['loss']:.6f} ({rels['loss']:.2e} relative "
              f"[{loss_rtol:g}]), gradient pieces within, of max-abs: "
              f"{show(rep['errs'])} [{g_rel:g}]; of rms: "
              f"{show(rep['rms'])} [{rms_rel}]; gradient {rep['ms']:.1f} "
              f"ms; peak {rep['peak_gb']:.2f} GB (both ranks on one card; "
              f"the whole run {whole_peak:.2f} GB)")


def moe_tp_path(card, whole, one, jobs):
    """Phase 12's checks: the split of the MoE and MLA decoders (its runs
    in ``split_paths``: ``whole`` the one-rank NCCL runs of the smoke
    configs, ``one`` the one-rank whole runs' readings, ``jobs`` mesh
    shape -> the ranks' phase-12 reports); returns the split runs' launch
    counts."""
    import torch

    from repro_torch.kernels import ops

    print("tensor-parallel split of the MoE and MLA decoders")
    t0 = time.perf_counter()
    counts = {run: dict.fromkeys(ops.launch_counts(), 0)
              for run in ("train-tp-moe-small", "train-tp-v3-wide")}
    print(f"  train-tp-moe-small on {card}; reduced: none (the smoke configs "
          "of arctic-480b and deepseek-v3-671b, f32, remat on; batch 2 x 32, "
          f"{len(MOE_COINS)} rounds on a tape, coins {MOE_COINS})")
    _check_moe_small(whole, jobs, counts["train-tp-moe-small"])
    wide = [rep["wide"] for rep in jobs[(1, 2)]]
    print(f"  train-tp-v3-wide on {card}: the trainer on the (1, 2) mesh, 2 "
          f"gloo ranks on cuda:0, rounds {V3_WIDE_COINS} (True: full)")
    _check_wide("train-tp-v3-wide", wide, one["wide_loss0"],
                "the one-rank run", V3_LOSS_RTOL, V3_G_REL)
    for rep in wide:
        for rnd in rep["rounds"]:
            for a, b in rnd["launches"].items():
                counts["train-tp-v3-wide"][a] += b
    print(f"  moe-v3-full-experts on {card}: split on the (1, 2) mesh, 2 "
          "gloo ranks on cuda:0")
    _check_v3_full([rep["full"] for rep in jobs[(1, 2)]], one["full_peak"])
    for run, c in counts.items():
        missing = [k for k in TRAINER_KERNELS if not c.get(k)]
        if missing:
            raise AssertionError(f"{run}: {missing} not launched")
    torch.cuda.empty_cache()
    print(f"  phase 12 checks {time.perf_counter() - t0:.3f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 13: the split of the SSM and hybrid decoders
# ---------------------------------------------------------------------------

SSM_ARCHS = ("mamba2_780m", "jamba_v01_52b")
# train-tp-ssm-small: the smoke configs in f32 (remat on), the default
# config (plan and gamma; one honest worker), a full round then two
# difference rounds
SSM_COINS = (True, False, False)
SSM_SMALL_MESHES = ((1, 2), (1, 4))
SSM_REL = 1e-5  # of each leaf's max-abs, against the one-rank card run
# the Mamba-2 mixers' per-head leaves, whose gradients are sums over every
# token that cancel to 1e-6..2e-5 of the other leaves' scale: f32
# rounding in another order moves them by up to 9.4e-6 of their max-abs
# (a CPU rehearsal of this phase, jamba on (1, 4)), as it moves the
# port's whole model from the reference's (tests/test_torch_train_mesh_
# ssm.py)
SSM_HEAD_LEAVES = ("A_log", "dt_bias")
SSM_HEAD_REL = 1e-4
# train-tp-mamba2-wide: mamba2-780m at full width, 4 of its 48 layers,
# bf16, remat, the trainer's full round then a difference round; its g^0
# pieces held at train-tp-wide's limit (TP_WIDE_G0_REL), its step-0 loss
# at MAMBA2_LOSS_RTOL: a CPU rehearsal at d_model 256, vocab 4,096, seq
# 4,096 read 4.33e-6 sound and 1.47e-4 with the gated norm's sum over the
# axis left out, which train-tp-wide's 1e-3 would pass (its g^0: 2.2e-2
# sound, 0.20-0.69 of max-abs the fault; PERF.md, phase 13)
MAMBA2_WIDE = dict(n_layers=4)
MAMBA2_WIDE_COINS = (True, False)
MAMBA2_LOSS_RTOL = 5e-5
# train-tp-jamba-wide: jamba-v0.1-52b at full width, the first 4
# positions of its period (ssm/dense, ssm/moe, ssm/dense, attn/moe) with
# all 16 experts, bf16, remat; apply_train's loss and gradient split,
# routed by the whole run's expert ids, held at moe-v3-full-experts'
# limits (V3_LOSS_RTOL; V3_G_REL of max-abs, or JAMBA_G_RMS of rms); the
# whole run's experts 0, 7, 8 and 15 (each rank's first and last) kept.
# The rehearsal above read the loss 9.09e-6 sound, 1.77e-4 the fault;
# the gradient 4.84e-2 of max-abs and 4.75e-2 of rms at worst sound, the
# fault's experts 0.38-0.62 and 0.49-0.52, its non-expert leaves 1.39 and
# 1.05
JAMBA_WIDE = dict(n_layers=4, mixer_pattern=("ssm", "ssm", "ssm", "attn"),
                  mlp_pattern=("dense", "moe", "dense", "moe"))
JAMBA_KEPT_EXPERTS = (0, 7, 8, 15)
JAMBA_G_RMS = 0.15
SSM_TIMEOUT = 900  # seconds for a spawned job


def _wide_whole(card, work, what, cfg, reduced, key, rows=None):
    """A wide split run's one-rank whole run (in ``_whole_job``'s
    process), on the weights and batches its split starts from
    (``_tp_wide_start``; gates opened): the step-0 loss (on the second
    batch) and g^0 (on the first, written to disk); returns {``key``_g0:
    the file, ``key``_loss0: the loss}."""
    import torch

    from repro_torch.data import synthetic_batch
    from repro_torch.launch.train import worker_grads
    from repro_torch.models import apply_train, init_params, param_count

    t0 = _run_header(f"{what} (one rank, whole)", card, reduced)
    batches = [synthetic_batch(MODEL_SEED + 1 + k, cfg,
                               *(rows or (1, TRAIN_SEQ))) for k in range(2)]
    params = _open_gates(init_params(MODEL_SEED, cfg), cfg)
    with torch.no_grad():
        loss0 = float(apply_train(params, cfg, batches[1])[0])
    g0, ms = _timed(lambda: worker_grads(params, cfg, batches[0]))
    if not all(bool(torch.isfinite(g).all()) for g in g0):
        raise AssertionError(f"{what}: the whole g^0 not finite")
    peak = _peak_gb()
    path = str(Path(work) / f"{key}_wide_g0.pt")
    _save([g.cpu() for g in g0], path)
    print(f"    {param_count(cfg):,} parameters; loss at x^0 on step 0's "
          f"batch {loss0:.6f}; g^0 in {ms:.1f} ms, peak {peak:.2f} GB; "
          f"wall {time.perf_counter() - t0:.3f} s")
    del params, g0
    torch.cuda.empty_cache()
    return {f"{key}_g0": path, f"{key}_loss0": loss0}


def _ssm_whole(card, work):
    """Phase 13's one-rank whole runs (in ``_whole_job``'s process):
    train-tp-mamba2-wide's and train-tp-jamba-wide's."""
    from repro_torch.configs import get_config

    out = _wide_whole(
        card, work, "train-tp-mamba2-wide",
        get_config("mamba2_780m", **MAMBA2_WIDE),
        f"n_layers 48 -> 4, train_4k's batch 256 -> 1 (seq {TRAIN_SEQ}); "
        "d_model 1,536, d_inner 3,072, 48 heads of 64, state 128, chunk "
        "256, vocab 50,280, bf16, remat on", "mamba2")
    t0 = _run_header(
        "train-tp-jamba-wide (one rank, whole)", card,
        "n_layers 32 -> 4 (the first 4 positions of its period: ssm/dense, "
        "ssm/moe, ssm/dense, attn/moe) with all 16 experts, train_4k's "
        f"batch 256 -> 1 (seq {TRAIN_SEQ}); d_model 4,096, 32 heads, 8 kv "
        "heads, d_ff 14,336, top-2, state 16, vocab 65,536, bf16, remat "
        "on; apply_train's loss and gradient, no trainer")
    out["jamba_ref"], out["jamba_peak"], _ = _full_whole(
        get_config("jamba_v01_52b", **JAMBA_WIDE), JAMBA_KEPT_EXPERTS,
        "train-tp-jamba-wide", Path(work) / "jamba_wide_ref.pt", t0)
    return out


def _ssm_job(rank, mesh_shape, one):
    """Phase 13's part of a rank of the shared spawns: train-tp-ssm-small
    on ``mesh_shape`` (None: none) for both configs or, given the one-rank
    runs' files (``one``), train-tp-mamba2-wide and train-tp-jamba-wide."""
    import torch

    out = {"small": {arch: _small_split_run(arch, mesh_shape, SSM_COINS)
                     for arch in SSM_ARCHS}} if mesh_shape else {}
    if one:
        from repro_torch.configs import get_config

        out["wide"] = _tp_wide_run(
            one["mamba2_g0"], get_config("mamba2_780m", **MAMBA2_WIDE),
            MAMBA2_WIDE_COINS)
        torch.cuda.empty_cache()
        out["jamba"] = _full_split(
            one["jamba_ref"], get_config("jamba_v01_52b", **JAMBA_WIDE),
            JAMBA_KEPT_EXPERTS, "train-tp-jamba-wide")
    return out


def ssm_tp_path(card, whole, one, jobs):
    """Phase 13's checks: the split of the SSM and hybrid decoders (its
    runs in ``split_paths``, as phase 12's); returns the split runs'
    launch counts."""
    import torch

    from repro_torch.kernels import ops

    print("tensor-parallel split of the SSM and hybrid decoders")
    t0 = time.perf_counter()
    counts = {run: dict.fromkeys(ops.launch_counts(), 0)
              for run in ("train-tp-ssm-small", "train-tp-mamba2-wide")}
    print(f"  train-tp-ssm-small on {card}; reduced: none (the smoke configs "
          "of mamba2-780m and jamba-v0.1-52b, f32, remat on; batch 2 x 32, "
          f"{len(SSM_COINS)} rounds on a tape, coins {SSM_COINS})")
    _check_small("train-tp-ssm-small", SSM_ARCHS, whole, jobs, counts[
        "train-tp-ssm-small"], SSM_COINS, SSM_REL, drops=False,
        loose=SSM_HEAD_LEAVES, loose_rel=SSM_HEAD_REL)
    wide = [rep["wide"] for rep in jobs[(1, 2)]]
    print(f"  train-tp-mamba2-wide on {card}: the trainer on the (1, 2) mesh, "
          f"2 gloo ranks on cuda:0, rounds {MAMBA2_WIDE_COINS} (True: full)")
    _check_wide("train-tp-mamba2-wide", wide, one["mamba2_loss0"],
                "the one-rank run", MAMBA2_LOSS_RTOL, TP_WIDE_G0_REL)
    for rep in wide:
        for rnd in rep["rounds"]:
            for a, b in rnd["launches"].items():
                counts["train-tp-mamba2-wide"][a] += b
    print(f"  train-tp-jamba-wide on {card}: split on the (1, 2) mesh, 2 "
          "gloo ranks on cuda:0")
    _check_full("train-tp-jamba-wide", [rep["jamba"] for rep in jobs[(1, 2)]],
                one["jamba_peak"], V3_LOSS_RTOL, None, V3_G_REL, JAMBA_G_RMS)
    for run, c in counts.items():
        missing = [k for k in TRAINER_KERNELS if not c.get(k)]
        if missing:
            raise AssertionError(f"{run}: {missing} not launched")
    torch.cuda.empty_cache()
    print(f"  phase 13 checks {time.perf_counter() - t0:.3f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 14: fsdp_tp's split over "data"
# ---------------------------------------------------------------------------

# fsdp-small: the trainer's test model and the MoE smoke configs in f32
# (the smoke configs with remat on), the default config (plan and gamma;
# no byzantine), a full round then a difference round, under fsdp_tp and
# under "tp" on the same mesh and tape: (data 2, model 2), two "data"
# workers; (pod 1, data 2, model 2) with the pods the workers, one worker
# whose 4 rows split over "data" (under "tp" every "data" rank runs them
# all: an independent check of the split rows)
FSDP_ARCHS = ("tiny", "arctic_480b", "deepseek_v3_671b")
FSDP_MESHES = ((2, 2), (1, 2, 2))
FSDP_COINS = (True, False)
FSDP_REL = 1e-5  # of each leaf's max-abs, against the "tp" run's slice
# fsdp-wide: minitron-8b at full width, 2 of its 32 layers, bf16, remat,
# batch 2 rows x 2,048 (split over "data") on (pod 1, data 2, model 2),
# against a one-rank whole run of the same batch.  A CPU rehearsal at
# d_model 256, vocab 4,096 read the step-0 loss 3.19e-6 relative and g^0
# 1.76e-2 of max-abs sound; with the cross-entropy's count left out of the
# sum over "data" 5.90e-4 and 1.02, with the reduce-scatter left out (each
# rank its own rows' gradient) 3.19e-6 and 1.10 (PERF.md, phase 14): g^0
# at train-tp-wide's TP_WIDE_G0_REL catches both, the loss at
# FSDP_WIDE_LOSS_RTOL the first (train-tp-wide's 1e-3 would pass it)
FSDP_WIDE_LOSS_RTOL = 2e-4
FSDP_WIDE = dict(n_layers=2)
FSDP_WIDE_ROWS = (2, 2048)
FSDP_WIDE_MESH = (1, 2, 2)
FSDP_WIDE_COINS = (True, False)


def _small_config(arch):
    """The small runs' config of ``arch``: the smoke config in f32, or
    ``TP_TINY`` for "tiny"."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import ModelConfig

    if arch == "tiny":
        return ModelConfig(**TP_TINY)
    return get_smoke_config(arch).replace(dtype="float32")


def _fsdp_small_run(arch, mesh_shape):
    """``arch``'s small config on this rank of ``mesh_shape`` under "tp"
    and under fsdp_tp, on one tape: per round the worst error of the
    fsdp_tp pieces of params and g against the matching slices of the
    "tp" run's (of each leaf's max-abs); whether every leaf has its
    ``param_specs`` local shape; held bytes and their ``param_specs`` sum;
    the choices each run's MoE layers dropped; the fsdp_tp run's launches
    and collectives; the rank's "data" and "model" coordinates."""
    import itertools

    import torch

    from repro_torch.api.mesh_exec import (collective_counts,
                                           reset_collective_counts)
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import P
    from repro_torch.launch.train import (ByzTrainConfig, initial_state,
                                          make_train_step)
    from repro_torch.models import init_params, moe
    from repro_torch.sharding.rules import (LocalShard, held_specs,
                                            local_shape, only_axis,
                                            param_specs)

    cfg = _small_config(arch)
    mesh = _split_mesh(mesh_shape)
    waxes = ("pod",) if len(mesh_shape) == 3 else ()
    workers = mesh_shape[0]
    batches = [_to(b, "cuda") for b in itertools.islice(make_batch_iterator(
        cfg, 4, 32, seed=3, device="cpu"), len(FSDP_COINS) + 1)]
    params = _to(init_params(0, cfg, device="cpu"), "cuda")
    whole = tree_flatten(init_params(0, cfg, device="meta"))[0]
    tape = _tp_tape(FSDP_COINS, workers)
    runs = {}
    for mode in ("tp", "fsdp_tp"):
        tc = ByzTrainConfig(shard_mode=mode, worker_axes_override=waxes)
        ops.reset_launch_counts()
        reset_collective_counts()
        states = []
        with moe.count_drops() as drops:
            state = initial_state(params, cfg, mesh, tc, batches[0])
            step = make_train_step(cfg, mesh, tc)
            for k in range(len(FSDP_COINS)):
                state = step(state, batches[k + 1], tape)
                states.append([tree_flatten(getattr(state, w))[0]
                               for w in ("params", "g")])
        torch.cuda.synchronize()
        runs[mode] = (states, int(drops[0]),
                      {k: v for k, v in ops.launch_counts().items() if v},
                      collective_counts())
    held = tree_flatten(held_specs(mesh, cfg, init_params(
        0, cfg, device="meta"), "fsdp_tp"), is_leaf=lambda x: isinstance(
            x, P))[0]
    specs = tree_flatten(param_specs(mesh, cfg, init_params(
        0, cfg, device="meta"), "fsdp_tp"), is_leaf=lambda x: isinstance(
            x, P))[0]
    shapes = [local_shape(mesh, x.shape, sp) for x, sp in zip(whole, specs)]
    cuts = [LocalShard(mesh, only_axis(sp, "data")) for sp in held]
    worst, shaped = [], True
    for got, ref in zip(runs["fsdp_tp"][0], runs["tp"][0]):
        err = 0.0
        for g_leaves, r_leaves in zip(got, ref):
            for a, b, cut, shp in zip(g_leaves, r_leaves, cuts, shapes):
                b = cut(b) if any(cut.spec) else b
                shaped &= tuple(a.shape) == tuple(shp)
                if a.shape != b.shape:
                    raise AssertionError(f"fsdp-small {arch} {mesh_shape}: "
                                         f"{tuple(a.shape)} against the "
                                         f"slice {tuple(b.shape)}")
                err = max(err, float((a - b).abs().max() / b.abs().max()
                                     .clamp(min=1e-30)))
        worst.append(err)
    last = runs["fsdp_tp"][0][-1]
    nbytes = [sum(x.numel() * x.element_size() for x in leaves)
              for leaves in last]
    want = sum(math.prod(shp) * x.element_size()
               for shp, x in zip(shapes, whole))
    return {"worst": worst, "shaped": shaped, "held": nbytes, "want": want,
            "drops": (runs["tp"][1], runs["fsdp_tp"][1]),
            "launches": runs["fsdp_tp"][2],
            "collectives": runs["fsdp_tp"][3],
            "coords": (mesh.get_local_rank("data"),
                       mesh.get_local_rank("model"))}


def _fsdp_job(rank, one=None):
    """Phase 14's part of a rank of the shared 4-rank spawn: fsdp-wide
    against the one-rank run's g^0 file (``one``) or, without it,
    fsdp-small on both meshes."""
    from repro_torch.configs import get_config

    t = time.perf_counter()
    if one:
        out = {"wide": _tp_wide_run(
            one["fsdp_g0"], get_config("minitron_8b", **FSDP_WIDE),
            FSDP_WIDE_COINS, mesh_shape=FSDP_WIDE_MESH, shard_mode="fsdp_tp",
            rows=FSDP_WIDE_ROWS)}
        out["wide_s"] = time.perf_counter() - t
        return out
    out = {"small": {(arch, shape): _fsdp_small_run(arch, shape)
                     for shape in FSDP_MESHES for arch in FSDP_ARCHS}}
    out["small_s"] = time.perf_counter() - t
    return out


def _fsdp_wide_whole(card, work):
    """fsdp-wide's one-rank whole run (``_wide_whole``), which zero3-wide
    is held to as well."""
    from repro_torch.configs import get_config

    return _wide_whole(
        card, work, "fsdp-wide", get_config("minitron_8b", **FSDP_WIDE),
        f"n_layers 32 -> 2, train_4k's batch 256 x 4,096 -> "
        f"{FSDP_WIDE_ROWS[0]} x {FSDP_WIDE_ROWS[1]:,}; bf16, remat on",
        "fsdp", FSDP_WIDE_ROWS)


def fsdp_path(card, jobs, one):
    """Phase 14's checks: fsdp_tp's split over "data" (its runs in
    ``split_paths``' 4-rank spawn, ``jobs`` the ranks' reports; ``one``
    the one-rank whole run's readings); returns its launch counts."""
    import torch

    from repro_torch.kernels import ops

    print('fsdp_tp: params and g held in "data" x "model" pieces')
    t0 = time.perf_counter()
    counts = {run: dict.fromkeys(ops.launch_counts(), 0)
              for run in ("train-fsdp-small", "train-fsdp-wide")}
    print(f"  fsdp-small on {card}; reduced: none (the mesh trainer's test "
          "model, f32; the smoke configs of arctic-480b and "
          "deepseek-v3-671b, f32, remat on; batch 4 x 32, rounds "
          f"{FSDP_COINS} (True: full) on a tape); meshes (data 2, model 2) "
          "with two \"data\" workers and (pod 1, data 2, model 2) with one "
          "pod worker, 4 gloo ranks on cuda:0, each against \"tp\" on the "
          "same mesh")
    for shape in FSDP_MESHES:
        for arch in FSDP_ARCHS:
            reps = [r["small"][(arch, shape)] for r in jobs]
            what = f"fsdp-small {arch} {shape}"
            worst = max(max(r["worst"]) for r in reps)
            if not worst <= FSDP_REL:
                raise AssertionError(f"{what}: pieces {worst:.3e} of max-abs "
                                     f"from the \"tp\" run's [{FSDP_REL:g}]")
            for rank, r in enumerate(reps):
                if not r["shaped"] or r["held"] != [r["want"]] * 2:
                    raise AssertionError(
                        f"{what} rank {rank}: held {r['held']} bytes, its "
                        f"param_specs pieces {r['want']} each")
                _check_routes(f"{what} rank {rank}", r["collectives"], "host")
                if "all_gather" not in r["collectives"]:
                    raise AssertionError(f"{what} rank {rank}: no gather")
                if len(shape) == 3 and "reduce_scatter" not in \
                        r["collectives"]:
                    raise AssertionError(f"{what} rank {rank}: rows split "
                                         "over \"data\" and no reduce-scatter")
                missing = [k for k in TRAINER_KERNELS
                           if not r["launches"].get(k)]
                if missing:
                    raise AssertionError(f"{what} rank {rank}: {missing} not "
                                         "launched")
                for a, b in r["launches"].items():
                    counts["train-fsdp-small"][a] += b
                # the choices dropped: the same as "tp"'s, the rows of the
                # ranks of a "data" group summed where they split
                tp_drops, mine = r["drops"]
                if len(shape) == 3:
                    mine = sum(o["drops"][1] for o in reps
                               if o["coords"][1] == r["coords"][1])
                if mine != tp_drops or (arch != "tiny" and not mine):
                    raise AssertionError(
                        f"{what} rank {rank}: {mine} choices dropped, the "
                        f"\"tp\" run {tp_drops}")
            r0 = reps[0]
            by_round = ", ".join(f"{max(r['worst'][k] for r in reps):.2e}"
                                 for k in range(len(FSDP_COINS)))
            print(f"    {arch} {shape}: every rank's pieces within "
                  f"{worst:.3e} of max-abs of the \"tp\" run's slices "
                  f"(by round {by_round}) [{FSDP_REL:g}]; held {r0['held'][0]:,} B of params and "
                  f"of g a rank (= the pieces); choices dropped "
                  f"{r0['drops'][0]} (\"tp\") and {r0['drops'][1]} (rank 0); "
                  f"rank 0's launches {r0['launches']}, collectives "
                  f"{r0['collectives']}")
    print(f"    fsdp-small's runs {max(r['small_s'] for r in jobs):.3f} s "
          "(the slowest rank)")
    print(f"  fsdp-wide on {card}; reduced: n_layers 32 -> 2, train_4k's "
          f"batch 256 x 4,096 -> {FSDP_WIDE_ROWS[0]} x "
          f"{FSDP_WIDE_ROWS[1]:,} (one pod worker, its rows split over "
          f"\"data\"), {FSDP_WIDE_MESH} mesh, 4 gloo ranks on cuda:0, rounds "
          f"{FSDP_WIDE_COINS} (True: full)")
    wide = [r["wide"] for r in jobs]
    _check_wide("fsdp-wide", wide, one["fsdp_loss0"], "the one-rank run",
                FSDP_WIDE_LOSS_RTOL, TP_WIDE_G0_REL)
    print(f"    fsdp-wide's runs {max(r['wide_s'] for r in jobs):.3f} s "
          "(the slowest rank)")
    for rep in wide:
        for rnd in rep["rounds"]:
            if not rnd["collectives"].get("reduce_scatter"):
                raise AssertionError("fsdp-wide: no reduce-scatter")
            for a, b in rnd["launches"].items():
                counts["train-fsdp-wide"][a] += b
    for run, c in counts.items():
        missing = [k for k in TRAINER_KERNELS if not c.get(k)]
        if missing:
            raise AssertionError(f"{run}: {missing} not launched")
    torch.cuda.empty_cache()
    print(f"  phase 14 checks {time.perf_counter() - t0:.3f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 15: the split of cross-attention (llama-3.2-vision-90b)
# ---------------------------------------------------------------------------

VISION_ARCH = "llama32_vision_90b"
# vision-small: the smoke config in f32 (remat on) with its gates opened
# (VISION_GATE), the default config (plan and gamma; one honest worker), a
# full round then a difference round, against the one-rank card run:
# under "tp" on (1, 2) and (1, 4) (a rank's kv piece half a head, gathered
# by ``take``), under fsdp_tp on (pod 1, data 2, model 2) with the pod the
# worker (its 2 rows, tokens and vision tokens, split over "data")
VISION_COINS = (True, False)
VISION_SMALL = (((1, 2), "tp"), ((1, 4), "tp"), ((1, 2, 2), "fsdp_tp"))
VISION_REL = 1e-5  # of each leaf's max-abs, against the one-rank card run
# vision-wide: llama-3.2-vision-90b at full width, the first 2 positions
# of its period (cross/dense, attn/dense), bf16, remat, gates opened, one
# row of TRAIN_SEQ, split on (1, 2) against a one-rank whole run of the
# same weights and batches; its step-0 loss at VISION_LOSS_RTOL and its
# g^0 pieces at VISION_G0_REL of each leaf's max-abs, each set between
# the sound reading and the reading with the cross-attention's ``wo``
# product left unsummed (``tools/vision_split_fault.py`` on the CPU at
# d_model 256, 4 heads of 64, 2 kv heads, d_ff 512, vocab 4,096, seq
# 4,096; PERF.md, phase 15)
VISION_WIDE = dict(n_layers=2, mixer_pattern=("cross", "attn"),
                   mlp_pattern=("dense", "dense"))
VISION_WIDE_COINS = (True, False)
VISION_LOSS_RTOL = 2e-4
VISION_G0_REL = 5e-2


def _vision_wide_whole(card, work):
    """vision-wide's one-rank whole run (``_wide_whole``)."""
    from repro_torch.configs import get_config

    return _wide_whole(
        card, work, "vision-wide", get_config(VISION_ARCH, **VISION_WIDE),
        "n_layers 100 -> 2 (the first 2 positions of its period: "
        "cross/dense, attn/dense), train_4k's batch 256 -> 1 (seq "
        f"{TRAIN_SEQ}); d_model 8,192, 64 heads, 8 kv heads, d_ff 28,672, "
        "vocab 128,256, 1,601 vision tokens, bf16, remat on, gates "
        f"{VISION_GATE}", "vision")


def _vision_job(rank, mesh_shape, one):
    """Phase 15's part of a rank of the shared spawns: vision-small on
    ``mesh_shape`` (None: none; the 4-rank spawn: (1, 4) under "tp" and
    (pod 1, data 2, model 2) under fsdp_tp) or, given the one-rank run's
    files (``one``), vision-wide."""
    out = {}
    for shape, mode in VISION_SMALL:
        if mesh_shape and math.prod(shape) == math.prod(mesh_shape):
            out[shape] = _small_split_run(VISION_ARCH, shape, VISION_COINS,
                                          mode)
    if one:
        from repro_torch.configs import get_config

        out["wide"] = _tp_wide_run(
            one["vision_g0"], get_config(VISION_ARCH, **VISION_WIDE),
            VISION_WIDE_COINS)
    return out


def _family_path(phase, name, arch, small, coins, rel, card, whole, one,
                 jobs, wide, reduced):
    """The checks of a family's split (phases 15-16): ``name``-small,
    ``_small_split_run`` of ``arch`` on each (mesh, mode) of ``small``
    against the one-rank NCCL run (``whole``), and ``name``-wide, the
    2-rank spawn's ``_tp_wide_run`` (``jobs``' "wide") against the
    one-rank whole run's ``wide`` = (loss key of ``one``, loss rtol, g^0
    limit); returns the runs' launch counts."""
    import torch

    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    counts = {run: dict.fromkeys(ops.launch_counts(), 0)
              for run in (f"train-{name}-small", f"train-{name}-wide")}
    print(f"  {name}-small on {card}; reduced: {reduced}; " + ", ".join(
        f"{shape} {mode}" for shape, mode in small)
          + " (the pod the worker, its rows split over \"data\"), gloo "
          "ranks on cuda:0, each against the one-rank NCCL run")
    by_shape = {shape: [{"small": {arch: rep[shape]}}
                        for rep in jobs[(1, 2) if shape == (1, 2)
                                        else (1, 4)]]
                for shape, _ in small}
    _check_small(f"{name}-small", (arch,), whole, by_shape,
                 counts[f"train-{name}-small"], coins, rel, drops=False)
    for shape, mode in small:  # the rows split over "data": summed
        for rep in by_shape[shape]:
            colls = rep["small"][arch]["collectives"]
            if len(shape) == 3 and "reduce_scatter" not in colls:
                raise AssertionError(f"{name}-small {shape}: rows split "
                                     "over \"data\" and no reduce-scatter")
    reps = [rep["wide"] for rep in jobs[(1, 2)]]
    key, loss_rtol, g0_rel = wide
    print(f"  {name}-wide on {card}: the trainer on the (1, 2) mesh, 2 gloo "
          f"ranks on cuda:0, rounds {tuple(r['full'] for r in reps[0]['rounds'])}"
          " (True: full)")
    _check_wide(f"{name}-wide", reps, one[key], "the one-rank run",
                loss_rtol, g0_rel)
    for rep in reps:
        for rnd in rep["rounds"]:
            for a, b in rnd["launches"].items():
                counts[f"train-{name}-wide"][a] += b
    for run, c in counts.items():
        missing = [k for k in TRAINER_KERNELS if not c.get(k)]
        if missing:
            raise AssertionError(f"{run}: {missing} not launched")
    torch.cuda.empty_cache()
    print(f"  phase {phase} checks {time.perf_counter() - t0:.3f} s")
    return counts


def vision_path(card, whole, one, jobs):
    """Phase 15's checks: the split of cross-attention (its runs in
    ``split_paths``); returns the split runs' launch counts."""
    print("tensor-parallel split of cross-attention (llama-3.2-vision-90b)")
    return _family_path(
        15, "vision", VISION_ARCH, VISION_SMALL, VISION_COINS, VISION_REL,
        card, whole, one, jobs,
        ("vision_loss0", VISION_LOSS_RTOL, VISION_G0_REL),
        "none (the smoke config of llama-3.2-vision-90b, f32, remat on, "
        f"gates {VISION_GATE}; batch 2 x 32, {len(VISION_COINS)} rounds on "
        f"a tape, coins {VISION_COINS})")


# ---------------------------------------------------------------------------
# phase 16: the split of frame inputs (hubert-xlarge)
# ---------------------------------------------------------------------------

FRAMES_ARCH = "hubert_xlarge"
# frames-small: the smoke config in f32 (remat on), the default config, a
# full round then a difference round, against the one-rank card run:
# under "tp" on (1, 2) and (1, 4), under fsdp_tp on (pod 1, data 2, model
# 2) with the pod the worker (its 2 rows of frames, targets and mask split
# over "data": each rank's count of kept positions differs, and the
# cross-entropy adds them up)
FRAMES_COINS = (True, False)
FRAMES_SMALL = (((1, 2), "tp"), ((1, 4), "tp"), ((1, 2, 2), "fsdp_tp"))
FRAMES_REL = 1e-5  # of each leaf's max-abs, against the one-rank card run
# frames-wide: hubert-xlarge at full width, the first 4 of its 48 layers,
# bf16, remat, one row of TRAIN_SEQ frames with the pipeline's targets and
# mask, split on (1, 2) against a one-rank whole run of the same weights
# and batches; its step-0 loss at FRAMES_LOSS_RTOL and its g^0 pieces at
# FRAMES_G0_REL of each leaf's max-abs, set between the sound reading and
# the reading with the frame projection's gather summing its gradient over
# "model" (tests/test_torch_wide_limits.py on the CPU at d_model 256;
# PERF.md, phase 16)
FRAMES_WIDE = dict(n_layers=4)
FRAMES_WIDE_COINS = (True, False)
FRAMES_LOSS_RTOL = 2e-4
FRAMES_G0_REL = 5e-2


def _frames_wide_whole(card, work):
    """frames-wide's one-rank whole run (``_wide_whole``)."""
    from repro_torch.configs import get_config

    return _wide_whole(
        card, work, "frames-wide", get_config(FRAMES_ARCH, **FRAMES_WIDE),
        "n_layers 48 -> 4, train_4k's batch 256 -> 1 (seq "
        f"{TRAIN_SEQ} frames); d_model 1,280, 16 heads of 80, d_ff 5,120, "
        "frame_dim 512, vocab 504, not causal, 65% of the positions "
        "masked in, bf16, remat on", "frames")


def _frames_job(rank, mesh_shape, one):
    """Phase 16's part of a rank of the shared spawns: frames-small on
    ``mesh_shape`` (None: none; the 4-rank spawn: (1, 4) under "tp" and
    (pod 1, data 2, model 2) under fsdp_tp) or, given the one-rank run's
    files (``one``), frames-wide."""
    out = {}
    for shape, mode in FRAMES_SMALL:
        if mesh_shape and math.prod(shape) == math.prod(mesh_shape):
            out[shape] = _small_split_run(FRAMES_ARCH, shape, FRAMES_COINS,
                                          mode)
    if one:
        from repro_torch.configs import get_config

        out["wide"] = _tp_wide_run(
            one["frames_g0"], get_config(FRAMES_ARCH, **FRAMES_WIDE),
            FRAMES_WIDE_COINS)
    return out


def frames_path(card, whole, one, jobs):
    """Phase 16's checks: the split of frame inputs (its runs in
    ``split_paths``); returns the split runs' launch counts."""
    print("tensor-parallel split of frame inputs (hubert-xlarge)")
    return _family_path(
        16, "frames", FRAMES_ARCH, FRAMES_SMALL, FRAMES_COINS, FRAMES_REL,
        card, whole, one, jobs,
        ("frames_loss0", FRAMES_LOSS_RTOL, FRAMES_G0_REL),
        "none (the smoke config of hubert-xlarge, f32, remat on; batch 2 "
        f"x 32 frames, {len(FRAMES_COINS)} rounds on a tape, coins "
        f"{FRAMES_COINS})")


# ---------------------------------------------------------------------------
# phase 17: zero3's pieces over "model"
# ---------------------------------------------------------------------------

ZERO3_ARCHS = ("tiny", "deepseek_v3_671b")
# zero3-small: the default config, a full round then a difference round
# (v3's one-rank run is phase 12's, on the same coins), on (1, 2), the
# worker's 2 rows split over "model", and on (1, 4), where 4 does not
# divide them and every rank runs both, against the one-rank card run
ZERO3_COINS = MOE_COINS
ZERO3_SMALL = ((1, 2), (1, 4))
ZERO3_REL = 1e-5  # of each leaf's max-abs, against the one-rank card run
# zero3-wide: fsdp-wide's model, weights and 2 x 2,048 rows on (1, 2)
# under zero3 (the rows split over "model"), one full round, held to
# fsdp-wide's whole run at its limits; the reduce-scatter left out reads
# far past them (tests/test_torch_wide_limits.py; PERF.md, phase 17).  A
# full round aggregates the raw gradients: of rows 1-3 it launches the
# coordinate median alone (zero3-small's difference rounds launch all 3)
ZERO3_WIDE_COINS = (True,)


def _zero3_job(rank, mesh_shape, one):
    """Phase 17's part of a rank of the shared spawns: zero3-small on
    ``mesh_shape`` (None: none) or, given fsdp-wide's one-rank run
    (``one``), zero3-wide."""
    out = {shape: {arch: _small_split_run(arch, shape, ZERO3_COINS,
                                          "zero3")
                   for arch in ZERO3_ARCHS}
           for shape in ZERO3_SMALL if shape == mesh_shape}
    if one:
        from repro_torch.configs import get_config

        out["wide"] = _tp_wide_run(
            one["fsdp_g0"], get_config("minitron_8b", **FSDP_WIDE),
            ZERO3_WIDE_COINS, mesh_shape=(1, 2), shard_mode="zero3",
            rows=FSDP_WIDE_ROWS)
    return out


def zero3_path(card, whole, one, jobs):
    """Phase 17's checks: zero3's pieces over "model" (its runs in
    ``split_paths``; ``whole`` the one-rank NCCL runs, ``one`` fsdp-wide's
    whole run); returns the runs' launch counts."""
    import torch

    from repro_torch.kernels import ops

    print('zero3: params and g held in pieces over "model", each layer '
          'gathered over it, the rows split over it')
    t0 = time.perf_counter()
    counts = {run: dict.fromkeys(ops.launch_counts(), 0)
              for run in ("train-zero3-small", "train-zero3-wide")}
    print(f"  zero3-small on {card}; reduced: none (the mesh trainer's "
          "test model and the smoke config of deepseek-v3-671b, f32; batch "
          f"2 x 32, {len(ZERO3_COINS)} rounds on a tape, coins "
          f"{ZERO3_COINS}); {ZERO3_SMALL[0]} (the rows split over "
          f"\"model\") and {ZERO3_SMALL[1]} (every rank runs both rows), gloo "
          "ranks on cuda:0, each against the one-rank NCCL run")
    small = {shape: [{"small": rep[shape]} for rep in jobs[shape]]
             for shape in ZERO3_SMALL}
    _check_small("zero3-small", ZERO3_ARCHS, whole, small,
                 counts["train-zero3-small"], ZERO3_COINS, ZERO3_REL,
                 drops=False)
    for shape, reps in small.items():
        for rank, rep in enumerate(reps):
            for arch, r in rep["small"].items():
                colls = r["collectives"]
                # the rows split on (1, 2): the gathered leaves' gradients
                # reduce-scattered; on (1, 4) each rank narrows its own
                split = shape == (1, 2)
                if ("reduce_scatter" in colls) != split or \
                        "all_gather" not in colls:
                    raise AssertionError(
                        f"zero3-small {arch} {shape} rank {rank}: "
                        f"collectives {colls}")
    reps = [rep["wide"] for rep in jobs[(1, 2)]]
    print(f"  zero3-wide on {card}; reduced: fsdp-wide's (n_layers 32 -> 2, "
          f"{FSDP_WIDE_ROWS[0]} x {FSDP_WIDE_ROWS[1]:,} rows, split over "
          "\"model\"), (1, 2) mesh, 2 gloo ranks on cuda:0, rounds "
          f"{ZERO3_WIDE_COINS} (True: full)")
    _check_wide("zero3-wide", reps, one["fsdp_loss0"],
                "fsdp-wide's one-rank run", FSDP_WIDE_LOSS_RTOL,
                TP_WIDE_G0_REL)
    for rep in reps:
        for rnd in rep["rounds"]:
            if not rnd["collectives"].get("reduce_scatter"):
                raise AssertionError("zero3-wide: no reduce-scatter")
            for a, b in rnd["launches"].items():
                counts["train-zero3-wide"][a] += b
    for run, c in counts.items():
        want = TRAINER_KERNELS if run == "train-zero3-small" else [
            k for k in TRAINER_KERNELS if k == "coordinate_median"]
        missing = [k for k in want if not c.get(k)]
        if missing:
            raise AssertionError(f"{run}: {missing} not launched")
    torch.cuda.empty_cache()
    print(f"  phase 17 checks {time.perf_counter() - t0:.3f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 18: the split of prefill and decode
# ---------------------------------------------------------------------------

# serve-split-small: tests/test_torch_serve_split.py's configs ("window":
# minitron-8b's with a sliding window of SERVE_WINDOW, whose writes past it
# clamp), inputs and meshes, each rank against the one-rank NCCL run
SERVE_ARCHS = ("minitron_8b", "deepseek_v3_671b", "arctic_480b",
               "mamba2_780m", "jamba_v01_52b", "llama32_vision_90b",
               "hubert_xlarge", "window")
SERVE_SMALL = (((1, 2), "tp"), ((1, 4), "tp"), ((2, 2), "fsdp_tp"),
               ((1, 2, 2), "tp"))
SERVE_B, SERVE_S, SERVE_L, SERVE_WINDOW = 4, 12, 16, 8
SERVE_IDX = (6, 7, 8, 9)  # across the blocks' boundary at 8 on every mesh
SERVE_REL = 1e-5  # of max-abs, against the one-rank card run
# serve-tp-wide (with a prefill) and serve-v3-wide (decode, the MoE routed
# as the whole run routed: bf16 top-k ties move otherwise)
SERVE_WIDE = {"serve-tp-wide": ("minitron_8b", dict(n_layers=2)),
              "serve-v3-wide": ("deepseek_v3_671b", V3_WIDE)}
SERVE_WIDE_START = DECODE_LEN // 2 - 4  # 8 steps across 16,384
SERVE_WIDE_STEPS, SERVE_WIDE_TIMED = 8, 5
# the wide runs' logits and written cache slots against the whole run's,
# of max-abs: bf16 products summed in other orders; a CPU rehearsal at
# reduced width (d_model 256, prefill and cache 1,024; tests/
# test_torch_wide_limits.py) read at most 1.42e-2 sound (prefill 7.4e-3,
# slots 9.5e-3) and 1.70, or NaN, with the softmax's merge over "model"
# left out; the share of next tokens equal to the whole run's 0.969-1.0
# sound, 0.0-0.031 with the fault
SERVE_WIDE_REL = 1e-1
SERVE_WIDE_AGREE = 0.9


def _serve_config(arch):
    """serve-split-small's f32 config of ``arch``."""
    from repro_torch.configs import get_smoke_config

    if arch == "window":
        return get_smoke_config("minitron_8b").replace(
            dtype="float32", sliding_window=SERVE_WINDOW)
    return get_smoke_config(arch).replace(dtype="float32")


def _serve_inputs(arch):
    """(params, prefill batch, decode cache, the decode steps' tokens) of
    ``arch`` on the CPU, from seeds, as ``tests/test_torch_serve_split.py``
    makes them: the cache normal values at every position."""
    import numpy as np
    import torch

    from repro_torch.core.tree_utils import tree_flatten, tree_unflatten
    from repro_torch.models import init_cache, init_params

    cfg = _serve_config(arch)
    rs = np.random.RandomState(SERVE_ARCHS.index(arch))
    params = _open_gates(init_params(0, cfg, device="cpu"), cfg)
    if cfg.input_kind == "frames":
        batch = {"frames": rs.randn(SERVE_B, SERVE_S, cfg.frame_dim)}
    else:
        batch = {"tokens": rs.randint(0, cfg.vocab, (SERVE_B, SERVE_S))}
    if cfg.input_kind == "tokens+vision":
        batch["vision"] = rs.randn(SERVE_B, cfg.n_vision_tokens, cfg.d_model)
    batch = {k: torch.from_numpy(v.astype(np.int32 if k == "tokens" else
                                          np.float32))
             for k, v in batch.items()}
    if not cfg.causal:
        return cfg, params, batch, None, None
    leaves, treedef = tree_flatten(init_cache(cfg, SERVE_B, SERVE_L,
                                              device="meta"))
    cache = tree_unflatten(treedef, [torch.from_numpy(rs.randn(
        *x.shape).astype(np.float32)) for x in leaves])
    tokens = [torch.from_numpy(rs.randint(0, cfg.vocab, (SERVE_B, 1)).astype(
        np.int32)) for _ in SERVE_IDX]
    return cfg, params, batch, cache, tokens


def _serve_small_run(arch, mesh_shape, mode="tp"):
    """serve-split-small's run of ``arch`` on this rank of ``mesh_shape``
    (one rank: the whole steps): the prefill's logits, each decode step's
    logits and next tokens and the cache after it (numpy), this rank's
    coordinates and the collectives."""
    import torch

    from repro_torch.api.mesh_exec import (collective_counts,
                                           reset_collective_counts)
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.models.model import (cache_to_numpy, shard_cache,
                                          shard_params)

    cfg, params, batch, cache, tokens = _serve_inputs(arch)
    mesh = _split_mesh(mesh_shape)
    held = shard_params(_to(params, "cuda"), mesh, cfg, mode)
    batch = _to(batch, "cuda")
    reset_collective_counts()
    out = {"prefill": make_prefill_step(cfg, mesh, mode)(
        held, batch).cpu().numpy(),
        "coords": {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}}
    if cache is not None:
        cache = shard_cache(_to(cache, "cuda"), mesh, cfg)
        step = make_serve_step(cfg, mesh, mode)
        for t, idx in enumerate(SERVE_IDX):
            db = {"tokens": tokens[t].cuda()}
            if "vision" in batch:
                db["vision"] = batch["vision"]
            nxt, logits, cache = step(held, db, cache, idx)
            out[f"logits{t}"] = logits.cpu().numpy()
            out[f"next{t}"] = nxt.cpu().numpy()
            out[f"cache{t}"] = tree_flatten(cache_to_numpy(cache))[0]
    torch.cuda.synchronize()
    out["collectives"] = collective_counts()
    return out


def _serve_cache_piece(arch, mesh_shape, leaves, coords):
    """The pieces of the whole cache ``leaves`` (flatten order) that a rank
    at ``coords`` of ``mesh_shape`` holds (``cache_specs`` on an abstract
    mesh)."""
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.mesh import P
    from repro_torch.models import init_cache
    from repro_torch.sharding.constraints import AbstractMesh
    from repro_torch.sharding.rules import cache_specs

    names = ("pod", "data", "model")[-len(mesh_shape):]
    sizes = dict(zip(names, mesh_shape))
    cfg = _serve_config(arch)
    specs = tree_flatten(cache_specs(AbstractMesh(mesh_shape, names), cfg,
                                     init_cache(cfg, SERVE_B, SERVE_L,
                                                device="meta")),
                         is_leaf=lambda x: isinstance(x, P))[0]
    out = []
    for x, sp in zip(leaves, specs):
        for j, entry in enumerate(sp):
            if entry is not None:
                w = x.shape[j] // sizes[entry]
                x = x.take(range(coords[entry] * w,
                                 (coords[entry] + 1) * w), axis=j)
        out.append(x)
    return out


def _or_inf(err: float) -> float:
    """``err``, a NaN read as inf (so that ``max`` and ``<=`` see it)."""
    return float("inf") if math.isnan(err) else err


def _np_rel(got, want):
    """max |got - want| of max |want| (numpy; NaN reads as inf)."""
    import numpy as np

    return _or_inf(float(np.abs(got - want).max() / max(
        float(np.abs(want).max()), 1e-30)) if got.size else 0.0)


def _serve_wide_cfg(name, **over):
    from repro_torch.configs import get_config

    arch, cut = SERVE_WIDE[name]
    return get_config(arch, **{**cut, **over})


def _serve_wide_cache(cfg, rows, length, device=None):
    """A wide run's whole decode cache: normal values at every position,
    from a seeded generator on ``device`` (the card by default), the
    same in every process."""
    import torch

    from repro_torch._device import resolve_device
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.models import init_cache

    dev = resolve_device(device)
    cache = init_cache(cfg, rows, length, device=dev)
    gen = torch.Generator(device=dev).manual_seed(MODEL_SEED + 5)
    for leaf in tree_flatten(cache)[0]:
        leaf.normal_(generator=gen)
    return cache


def _serve_wide_whole(name, path, cfg=None, seq=PREFILL_SEQ,
                      length=DECODE_LEN, rows=DECODE_B,
                      start=SERVE_WIDE_START, timed=SERVE_WIDE_TIMED,
                      device=None):
    """A wide serve run's one-rank whole run (``cfg``: ``SERVE_WIDE``'s
    by default): serve-tp-wide's prefill of ``seq`` positions at batch 1,
    then ``SERVE_WIDE_STEPS`` decode steps of ``rows`` rows on a cache of
    ``length`` positions from index ``start``, the MoE's routing
    recorded; the logits, next tokens, routes and written cache slots go
    to ``path``; with ``timed`` steps at the cache's end on the card,
    their ms.  Returns the readings to print."""
    import torch

    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.models import init_params, moe

    cfg = cfg or _serve_wide_cfg(name)
    params = init_params(MODEL_SEED, cfg, device=device)
    ref, info = {"logits": [], "next": []}, {}
    if name == "serve-tp-wide":
        batch = synthetic_batch(MODEL_SEED + 1, cfg, 1, seq, device=device)
        step = make_prefill_step(cfg)
        if device is None:
            ref["prefill"], info["prefill_ms"] = _timed(
                lambda: step(params, batch))
        else:
            ref["prefill"] = step(params, batch)
        ref["prefill"] = ref["prefill"].cpu()
        del batch
    cache = _serve_wide_cache(cfg, rows, length, device)
    tokens = synthetic_batch(MODEL_SEED + 2, cfg, rows, SERVE_WIDE_STEPS,
                             device=device)["tokens"]
    step = make_serve_step(cfg)
    with moe.record_routing() as routes:
        for t in range(SERVE_WIDE_STEPS):
            nxt, logits, cache = step(params, {"tokens": tokens[:, t:t + 1]},
                                      cache, start + t)
            ref["logits"].append(logits.cpu())
            ref["next"].append(nxt.cpu())
    ref["routes"] = [r.cpu() for r in routes]
    ref["slots"] = [x.narrow(2, start, SERVE_WIDE_STEPS).cpu()
                    for x in tree_flatten(cache)[0]]
    if device is None:
        info["ms"] = [_timed(lambda: step(params, {"tokens": nxt[:, None]},
                                          cache, length - 1))[1]
                      for _ in range(timed)]
        info["peak_gb"] = _peak_gb()
    info["held"] = sum(x.numel() * x.element_size() for x in
                       tree_flatten((params, cache))[0])
    _save(ref, path)
    del params, cache
    return info


def _serve_wide_split(name, path, cfg=None, mesh_shape=(1, 2),
                      seq=PREFILL_SEQ, length=DECODE_LEN, rows=DECODE_B,
                      start=SERVE_WIDE_START, timed=SERVE_WIDE_TIMED,
                      device=None):
    """A wide serve run's split on this rank of ``mesh_shape`` under "tp"
    (``_serve_wide_whole``'s arguments; its file ``path``): the same
    weights' ``param_specs`` pieces and the same cache's ``cache_specs``
    pieces, the prefill, the decode steps (routed by the whole run's
    recorded routes), each against the whole run's: the logits' errors
    of max-abs, the share of equal next tokens, the written slots of
    this rank's block; held bytes, and on the card the steps' ms, peak GB
    and one step's collectives."""
    import contextlib

    import torch

    from repro_torch.api.mesh_exec import (collective_counts,
                                           reset_collective_counts)
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.models import init_params, moe
    from repro_torch.models.model import shard_cache, shard_params

    if device is None:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = cfg or _serve_wide_cfg(name)
    mesh = _split_mesh(mesh_shape)
    ref = torch.load(path, weights_only=True)
    held = shard_params(init_params(MODEL_SEED, cfg, device=device), mesh,
                        cfg)
    out = {"errs": []}
    if "prefill" in ref:
        batch = synthetic_batch(MODEL_SEED + 1, cfg, 1, seq, device=device)
        step = make_prefill_step(cfg, mesh)
        logits, ms = _timed(lambda: step(held, batch)) if device is None \
            else (step(held, batch), None)
        out["prefill_err"], out["prefill_ms"] = _or_inf(_rel_err(
            logits.cpu(), ref["prefill"])), ms
        del batch, logits
    cache = shard_cache(_serve_wide_cache(cfg, rows, length, device), mesh,
                        cfg)
    out["held"] = {w: sum(x.numel() * x.element_size()
                          for x in tree_flatten(t)[0])
                   for w, t in (("params", held), ("cache", cache))}
    tokens = synthetic_batch(MODEL_SEED + 2, cfg, rows, SERVE_WIDE_STEPS,
                             device=device)["tokens"]
    step = make_serve_step(cfg, mesh)
    agree = 0
    with (moe.record_routing(ref["routes"]) if ref["routes"]
          else contextlib.nullcontext()):
        for t in range(SERVE_WIDE_STEPS):
            reset_collective_counts()
            nxt, logits, cache = step(held, {"tokens": tokens[:, t:t + 1]},
                                      cache, start + t)
            out["errs"].append(_or_inf(_rel_err(logits.cpu(),
                                                ref["logits"][t])))
            agree += int((nxt.cpu() == ref["next"][t]).sum())
    out["collectives"] = collective_counts()
    out["agree"] = agree / (rows * SERVE_WIDE_STEPS)
    # the slots written into this rank's block of every cache leaf
    rank, slots = mesh.get_local_rank("model"), []
    for leaf, want in zip(tree_flatten(cache)[0], ref["slots"]):
        width = leaf.shape[2]
        for t in range(SERVE_WIDE_STEPS):
            if (start + t) // width == rank:
                slots.append(_or_inf(_rel_err(
                    leaf.narrow(2, (start + t) % width, 1).cpu(),
                    want.narrow(2, t, 1))))
    out["slot_err"], out["slots"] = max(slots, default=0.0), len(slots)
    out["leaves"] = len(ref["slots"])
    if device is None:
        out["ms"] = [_timed(lambda: step(held, {"tokens": nxt[:, None]},
                                         cache, length - 1))[1]
                     for _ in range(timed)]
        out["peak_gb"] = _peak_gb()
    del held, cache
    return out


def _serve_whole(card, work):
    """Phase 18's one-rank whole runs (in ``_whole_job``'s process): both
    wide runs' files, and their readings."""
    import torch

    from repro_torch.models import param_count

    out = {}
    for name in SERVE_WIDE:
        cfg = _serve_wide_cfg(name)
        t0 = _run_header(f"{name} (one rank, whole)", card,
                         _serve_wide_reduced(name))
        path = str(Path(work) / f"{name}.pt")
        info = _serve_wide_whole(name, path)
        out[name] = {"path": path, **info}
        pre = (f"prefill of {PREFILL_SEQ:,} in {info['prefill_ms']:.1f} ms; "
               if "prefill_ms" in info else "")
        print(f"    {param_count(cfg):,} parameters; {pre}decode "
              f"{statistics.median(info['ms']):.1f} ms a token at batch "
              f"{DECODE_B} (median of {len(info['ms'])} at index "
              f"{DECODE_LEN - 1}); held {info['held'] / 1e9:.3f} GB, peak "
              f"{info['peak_gb']:.2f} GB; wall {time.perf_counter() - t0:.3f}"
              " s")
        torch.cuda.empty_cache()
    return out


def _serve_wide_reduced(name):
    """How the wide serve run ``name`` is cut from its configuration."""
    if name == "serve-tp-wide":
        return (f"n_layers 32 -> 2; prefill_32k's batch 32 -> 1 (seq "
                f"{PREFILL_SEQ:,}); decode_32k's batch 128 -> {DECODE_B} "
                f"(cache {DECODE_LEN:,}); bf16")
    return (f"train-tp-v3-wide's cut (n_layers 61 -> 2, the first dense, "
            f"experts 256 -> 32); decode_32k's batch 128 -> {DECODE_B} "
            f"(cache {DECODE_LEN:,}); bf16; no prefill")


def _serve_job(rank, mesh_shape, one):
    """Phase 18's part of a rank of the shared spawns: serve-split-small
    on the meshes of ``mesh_shape``'s size (None: none) or, given the
    whole runs' readings (``one``), both wide runs on (1, 2)."""
    import torch

    out = {}
    for shape, mode in SERVE_SMALL:
        if mesh_shape and math.prod(shape) == math.prod(mesh_shape):
            out[shape] = {arch: _serve_small_run(arch, shape, mode)
                          for arch in SERVE_ARCHS}
    if one:
        for name in SERVE_WIDE:
            out[name] = _serve_wide_split(name, one[name]["path"])
            torch.cuda.empty_cache()
    return out


def serve_split_path(card, ones, whole, jobs):
    """Phase 18's checks (its runs in ``split_paths``; ``ones`` the
    one-rank NCCL runs, ``whole`` the wide runs' whole readings); no
    kernel is launched on this path."""
    import torch

    print("serve split: params in their param_specs pieces, the decode "
          "cache in its cache_specs pieces (length over \"model\")")
    t0 = time.perf_counter()
    print(f"  serve-split-small on {card}; reduced: none (the smoke configs "
          f"in f32, batch {SERVE_B}, prefill {SERVE_S}, cache {SERVE_L}, "
          f"decode steps at {SERVE_IDX}); "
          + ", ".join(f"{s} {m}" for s, m in SERVE_SMALL)
          + ", gloo ranks on cuda:0, each against the one-rank NCCL run")
    for shape, mode in SERVE_SMALL:
        key = shape if math.prod(shape) == 2 else (1, 4)
        worst = {}
        for rank, rep in enumerate(jobs[key]):
            for arch, r in rep[shape].items():
                want = ones[arch]
                errs = [_np_rel(r["prefill"], want["prefill"])]
                same = True
                for t in range(len(SERVE_IDX) if "logits0" in r else 0):
                    errs.append(_np_rel(r[f"logits{t}"], want[f"logits{t}"]))
                    same &= bool((r[f"next{t}"] == want[f"next{t}"]).all())
                    errs += [_np_rel(a, b) for a, b in zip(
                        r[f"cache{t}"], _serve_cache_piece(
                            arch, shape, want[f"cache{t}"], r["coords"]))]
                worst[arch] = max(worst.get(arch, 0.0), *errs)
                if max(errs) > SERVE_REL or not same:
                    raise AssertionError(
                        f"serve-split-small {arch} {shape} {mode} rank "
                        f"{rank}: {max(errs):.3e} of max-abs [{SERVE_REL:g}],"
                        f" next tokens equal: {same}")
                if not r["collectives"]:
                    raise AssertionError(f"serve-split-small {arch} {shape}: "
                                         "no collective ran")
        print(f"    {shape} {mode}: worst of max-abs by arch "
              + ", ".join(f"{a} {v:.3e}" for a, v in worst.items())
              + f" [{SERVE_REL:g}]; next tokens equal")
    for name in SERVE_WIDE:
        one = whole[name]
        print(f"  {name} on {card}; reduced: {_serve_wide_reduced(name)}; "
              "(1, 2) mesh, 2 gloo ranks on cuda:0, against the whole run")
        for rank, r in enumerate(rep[name] for rep in jobs[(1, 2)]):
            pre = ""
            if "prefill_err" in r:
                pre = (f"prefill {r['prefill_err']:.3e} in "
                       f"{r['prefill_ms']:.1f} ms (whole "
                       f"{one['prefill_ms']:.1f}); ")
            print(f"    rank {rank}: held params {r['held']['params']:,} B, "
                  f"cache {r['held']['cache']:,} B (whole run "
                  f"{one['held']:,} B); {pre}decode logits <= "
                  f"{max(r['errs']):.3e} of max-abs [{SERVE_WIDE_REL:g}], "
                  f"next tokens equal {r['agree']:.3f} "
                  f"[{SERVE_WIDE_AGREE:g}], {r['slots']} written slots <= "
                  f"{r['slot_err']:.3e}; {statistics.median(r['ms']):.1f} ms "
                  f"a token (whole {statistics.median(one['ms']):.1f}), "
                  f"peak {r['peak_gb']:.2f} GB; a step's collectives "
                  + ", ".join(f"{k} {v['calls']} x {v['bytes']:,} B"
                              for k, v in r["collectives"].items()))
            bad = max(r["errs"] + [r.get("prefill_err", 0.0),
                                   r["slot_err"]])
            if not (bad <= SERVE_WIDE_REL and r["agree"] >= SERVE_WIDE_AGREE):
                raise AssertionError(f"{name} rank {rank}: the split parts "
                                     "from the whole run")
        # every step's slot of every leaf was held by the rank whose
        # block holds it
        leaves = jobs[(1, 2)][0][name]["leaves"]
        if sum(r[name]["slots"] for r in jobs[(1, 2)]) != \
                leaves * SERVE_WIDE_STEPS:
            raise AssertionError(f"{name}: written slots "
                                 f"{[r[name]['slots'] for r in jobs[(1, 2)]]}"
                                 f" for {leaves} leaves")
    torch.cuda.empty_cache()
    print(f"  phase 18 checks {time.perf_counter() - t0:.3f} s")
    return {}


# ---------------------------------------------------------------------------
# the runs of phases 11-18: the one-rank whole runs in a process of their
# own beside the build; one spawn of 2 ranks and one of 4 for every split
# ---------------------------------------------------------------------------

SPLIT_TIMEOUT = 900  # seconds for a spawned job, or a wait for a marker
# markers in the work dir: the 2-rank spawn's wide runs free to start
# (the whole runs' files and readings in WIDE_FILES), or not
WIDE_GO, WIDE_STOP, WIDE_FILES = "wide.go", "wide.stop", "wide.pkl"


def _whole_job(rank, card, work):
    """The one-rank whole runs of phases 12-16 and 18, in a process of
    their own (the segments they leave the allocator, cuBLAS's workspaces pin two of
    3.7 GB after the full-experts gradient, die with it); each phase's
    seconds."""
    import gc

    import torch

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work, out, secs = Path(work), {}, {}
    for phase, fn in ((12, lambda: {**_v3_wide_whole(card, work),
                                    **_v3_full_whole(card, work)}),
                      (13, lambda: _ssm_whole(card, work)),
                      (14, lambda: _fsdp_wide_whole(card, work)),
                      (15, lambda: _vision_wide_whole(card, work)),
                      (16, lambda: _frames_wide_whole(card, work)),
                      (18, lambda: _serve_whole(card, work))):
        t = time.perf_counter()
        out[phase] = fn()
        secs[phase] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = secs
    return out


class WholeRuns:
    """``_whole_job`` in a spawned process, waited for in a thread: started
    once phase 9 has left the card, beside nvcc's tail, and joined before
    phase 2, whose device times must not share the card."""

    def __init__(self, card, work):
        from repro_torch.launch.mesh import spawn

        self.out, self.err, self.t0 = None, None, time.perf_counter()

        def run():
            try:
                self.out = spawn(_whole_job, 1, (card, str(work)),
                                 timeout=SPLIT_TIMEOUT)[0]
            except BaseException as err:  # noqa: BLE001 — raised in join
                self.err = err
            self.wall = time.perf_counter() - self.t0

        sys.stdout.flush()  # ahead of the spawned process's lines
        self.thread = threading.Thread(target=run)
        self.thread.start()

    def join(self):
        """The whole runs' readings and files (raises if they failed)."""
        t = time.perf_counter()
        self.thread.join()
        if self.err is not None:
            raise self.err
        print(f"the whole runs' process of phases 12-16, 18: {self.wall:.3f}"
              f" s, of which {time.perf_counter() - t:.3f} s after the build; "
              "by phase " + ", ".join(f"{p} {v:.3f} s" for p, v in
                                      self.out["seconds"].items()))
        return self.out


def _wait_for(work, done, failed):
    """Return the seconds until the marker ``done`` is in ``work``; raise
    if ``failed`` is there first or neither comes in SPLIT_TIMEOUT s."""
    work, t = Path(work), time.monotonic()
    while not (work / done).exists():
        if (work / failed).exists():
            raise RuntimeError(f"{failed} in {work} (waiting for {done})")
        if time.monotonic() > t + SPLIT_TIMEOUT:
            raise RuntimeError(f"no {done} in {work} in {SPLIT_TIMEOUT} s")
        time.sleep(0.2)
    return time.monotonic() - t


def _split_job(rank, mesh_shape, work):
    """One rank of a shared spawn on ``mesh_shape``, the whole runs' files
    and readings in ``work``: on 4 ranks phase 14's fsdp-wide first (about
    40 GB on the card), then the marker ``WIDE_GO``, then every phase's
    small split runs; on 2 ranks the small split runs and frames-wide (a
    few GB each) beside fsdp-wide, then, once ``WIDE_GO`` is there, the
    other wide runs (up to 75 GB); the seconds of each phase's part and
    of the wait."""
    import gc
    import pickle

    import torch

    work = Path(work)
    wide = mesh_shape == (1, 2)
    out, secs, waits = {}, {}, {}

    def run(parts):
        for phase, fn in parts:
            t = time.perf_counter()
            out[phase] = {**out.get(phase, {}), **fn()}
            secs[phase] = secs.get(phase, 0.0) + time.perf_counter() - t
            gc.collect()
            torch.cuda.empty_cache()

    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    with open(work / WIDE_FILES, "rb") as f:
        files = pickle.load(f)
    small = [(11, lambda: _tp_job(rank, mesh_shape, None)),
             (12, lambda: _moe_job(rank, mesh_shape, None, None, None)),
             (13, lambda: _ssm_job(rank, mesh_shape, None)),
             (15, lambda: _vision_job(rank, mesh_shape, None)),
             (16, lambda: _frames_job(rank, mesh_shape, None)),
             (17, lambda: _zero3_job(rank, mesh_shape, None)),
             (18, lambda: _serve_job(rank, mesh_shape, None))]
    if wide:
        # the serve runs (a few GB a rank at most) beside fsdp-wide too
        run(small + [(16, lambda: _frames_job(rank, None, files[16])),
                     (18, lambda: _serve_job(rank, None, files[18]))])
        waits["go"] = _wait_for(work, WIDE_GO, WIDE_STOP)
        run([(11, lambda: _tp_job(rank, None, files["g0"])),
             (12, lambda: _moe_job(rank, None, files[12]["g0"],
                                   files[12]["ref"],
                                   files[12]["wide_routes"])),
             (13, lambda: _ssm_job(rank, None, files[13])),
             (15, lambda: _vision_job(rank, None, files[15])),
             (17, lambda: _zero3_job(rank, None, files[14]))])
    else:
        run([(14, lambda: _fsdp_job(rank, files[14]))])
        torch.distributed.barrier()  # every rank's fsdp-wide has let go
        if rank == 0:
            (work / WIDE_GO).touch()
        run(small + [(14, lambda: _fsdp_job(rank))])
    out["seconds"], out["waits"] = secs, waits
    return out


def split_paths(card, work, whole):
    """The runs of phases 11-18 (their checks follow, phase by phase): the
    one-rank NCCL runs of the small configs in this process; then one
    spawn of 4 gloo ranks on cuda:0 and one of 2 side by side, which
    between them run every phase's split (``_split_job``), the 2-rank
    spawn's larger wide runs after the 4-rank spawn's fsdp-wide (the card
    cannot hold both);
    ``whole``: the one-rank whole runs' readings and files in ``work``
    (``WholeRuns``); returns each phase's runs and the seconds its parts
    took."""
    import os
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import spawn

    print("the split runs of phases 11-18")
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    secs = dict.fromkeys(range(11, 19), 0.0)
    secs.update({p: v for p, v in whole["seconds"].items()})
    ones = {}
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        work, "rendezvous"), rank=0, world_size=1)
    try:
        for phase, fn in (
                (11, lambda: _tp_small_run((1, 1))),
                (12, lambda: {arch: _small_split_run(arch, (1, 1))
                              for arch in MOE_ARCHS}),
                (13, lambda: {arch: _small_split_run(arch, (1, 1), SSM_COINS)
                              for arch in SSM_ARCHS}),
                (15, lambda: {VISION_ARCH: _small_split_run(
                    VISION_ARCH, (1, 1), VISION_COINS)}),
                (16, lambda: {FRAMES_ARCH: _small_split_run(
                    FRAMES_ARCH, (1, 1), FRAMES_COINS)}),
                # v3's one-rank run is phase 12's: the same coins
                (17, lambda: {"tiny": _small_split_run("tiny", (1, 1),
                                                       ZERO3_COINS),
                              "deepseek_v3_671b":
                              ones[12]["deepseek_v3_671b"]}),
                (18, lambda: {arch: _serve_small_run(arch, (1, 1))
                              for arch in SERVE_ARCHS})):
            t = time.perf_counter()
            ones[phase] = fn()
            secs[phase] += time.perf_counter() - t
    finally:
        dist.destroy_process_group()
    print(f"  one-rank NCCL runs of the small configs "
          f"{time.perf_counter() - t0:.3f} s")
    with open(work / WIDE_FILES, "wb") as f:
        pickle.dump({"g0": PHASE10["g0"], **whole}, f)
    env = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    walls, runs, errs = {}, {}, {}

    def run(key, fn, nprocs, args):  # a spawn, waited for in a thread
        t = time.perf_counter()
        try:
            runs[key] = spawn(fn, nprocs, args, timeout=SPLIT_TIMEOUT)
        except BaseException as err:  # noqa: BLE001 — raised below
            errs[key] = err
        walls[key] = time.perf_counter() - t

    try:
        # the split's ranks' allocators grow their segments in place: the
        # two ranks of moe-v3-full-experts share the card at some 36 GB each
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        sys.stdout.flush()  # ahead of the spawned processes' lines
        # the 4-rank spawn's fsdp-wide beside the 2-rank spawn's small
        # runs, then the 2-rank spawn's wide runs beside the 4-rank
        # spawn's small runs (``_split_job``)
        thread = threading.Thread(target=run, args=(
            (1, 2), _split_job, 2, ((1, 2), str(work))))
        thread.start()
        try:
            run((1, 4), _split_job, 4, ((1, 4), str(work)))
        finally:
            if errs:  # the 2-rank spawn waits for no WIDE_GO
                (work / WIDE_STOP).touch()
            thread.join()
        for key in ((1, 4), (1, 2)):
            if key in errs:
                raise errs[key]
        jobs = {shape: runs[shape] for shape in ((1, 4), (1, 2))}
        for reports in jobs.values():
            for phase in secs:
                secs[phase] += max(r["seconds"].get(phase, 0.0)
                                   for r in reports)
    finally:  # train-minitron-wide's g^0
        Path(PHASE10["g0"]).unlink(missing_ok=True)
        if env is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = env
    torch.cuda.empty_cache()
    go = max(r["waits"]["go"] for r in jobs[(1, 2)])
    print(f"  the (1, 4) spawn {walls[(1, 4)]:.3f} s beside the (1, 2) spawn "
          f"{walls[(1, 2)]:.3f} s (its wide runs waited {go:.3f} s for the "
          "(1, 4) spawn's fsdp-wide); the runs by phase (the slowest rank's "
          "part of each spawn, the whole runs' part): "
          + ", ".join(f"{p} {v:.3f} s" for p, v in secs.items())
          + f"; wall {time.perf_counter() - t0:.3f} s")

    def of(phase):
        return {shape: [r[phase] for r in jobs[shape]] for shape in jobs
                if phase in jobs[shape][0]}

    return {11: (ones[11], of(11)), 12: (ones[12], whole[12], of(12)),
            13: (ones[13], whole[13], of(13)),
            14: (of(14)[(1, 4)], whole[14]),
            15: (ones[15], whole[15], of(15)),
            16: (ones[16], whole[16], of(16)),
            17: (ones[17], whole[14], of(17)),
            18: (ones[18], whole[18], of(18))}, secs


def main():
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this needs a CUDA card")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        _fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
              "a checkout of the repository")
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device and build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    from repro_torch.kernels import _build

    # nvcc runs on the host while phase 9, which reaches no kernel, runs
    # on the card, then the whole runs of phases 12-16, 18 (no kernel
    # either)
    building = _build.start_all()
    sys.stdout.flush()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_split"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    nvcc, whole = {}, None
    try:
        try:
            models_path(card)
            torch.cuda.empty_cache()
            whole = WholeRuns(card, work)
        finally:  # no nvcc outlives the script
            secs = _build.finish_all(building, nvcc)
        print(f"built {', '.join(_build.SOURCES)} for sm_90a in {secs:.1f} s"
              f" into {_build.BUILD_DIR} (phase 9 and then the whole runs "
              "ran meanwhile)")
        for name in _build.SOURCES:  # ptxas -v: per kernel instantiation
            log = _build.build_log(name)
            regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
            spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                                 log)]
            took = f"nvcc {nvcc[name]:.1f} s, " if name in nvcc else ""
            print(f"  {name}: {took}{len(regs)} kernels, {min(regs)}-"
                  f"{max(regs)} registers, {sum(1 for v in spills if v)} "
                  f"with spill stores (at most {max(spills)} bytes)")
        phases = kernel_phases(card, work, whole.join())
    finally:  # the whole runs' files, once their process has ended
        if whole is not None:
            whole.thread.join()
        shutil.rmtree(work, ignore_errors=True)
    _result(card, phases)


def kernel_phases(card, work, whole):
    """Phases 2-8, 10 and 11-18 (``whole``: the whole runs' readings and
    files in ``work``); returns every run's launch counts, the checks' and
    times' for the kernels line."""
    import torch

    # 2. kernel vs plain version
    checks = Checks()
    check_shape(checks, 20, 40, 1)
    check_shape(checks, 21, 40, 2)
    wide = check_shape(checks, 20, WIDE_D, 3)
    times = time_wide(*wide)
    gm_largest = gm_shapes(checks)
    times.update(time_gm(*wide[:3], checks, gm_largest))
    print("krum shapes")
    for n, d, seed in ((16, 4096, 4), (17, 4097, 5)):
        g = torch.Generator(device="cuda").manual_seed(seed)
        check_krum(checks, torch.randn(n, d, device="cuda", generator=g),
                   torch.randn(n, d, device="cuda", generator=g),
                   f"n={n} d={d}")
    krum_edges(checks)
    print("gram kernels at misaligned, tiny and end-of-allocation shapes")
    gram_edges(checks)
    wide_y = torch.randn_like(wide[0])
    check_krum(checks, wide[0], wide_y, f"n=20 d={WIDE_D}")
    print("streaming kernels at every alignment")
    stream_edges(checks, wide[0])
    times.update(time_krum(wide[0], wide_y))
    del wide_y
    largest = cclip_shapes(checks)
    times.update(time_cclip(*wide[:3], checks, largest))
    print("entry points: clipped_diff, bucketed_coordinate_median")
    entry_times, entry_counts = time_entry_points(checks, *wide[:2])
    times.update(entry_times)
    del wide
    torch.cuda.empty_cache()

    # 3. Algorithm 1: Fig. 1, then the compressed and CenteredClip runs
    counts = main_path()
    counts.update(compress_path())
    counts["entry-points"] = entry_counts

    # 4. Fig. 2
    counts.update(fig2_path())

    # 5. serving
    serve_counts, _ = serve_path()
    counts.update(serve_counts)

    # 6. the adversarial scenarios
    counts.update(scenario_path(checks))

    # 7. faults, recovery, scoring
    counts.update(recovery_path())

    # 8. the mesh aggregation
    counts.update(mesh_path())

    # 9. the model zoo: ran while the kernels built (phase 1)

    # 10. the mesh trainer and the decode launcher
    counts.update(train_path(card))

    # 11-18: the runs of every split (shared spawns), then each phase's
    # checks: 11 the tensor-parallel split and the dry run, 12 the split
    # of the MoE and MLA decoders, 13 of the SSM and hybrid decoders, 14
    # fsdp_tp's split over "data", 15 the split of cross-attention, 16 of
    # frame inputs, 17 zero3's pieces over "model", 18 the split of
    # prefill and decode
    runs, secs = split_paths(card, work, whole)
    for phase, check in ((11, tp_path), (12, moe_tp_path),
                         (13, ssm_tp_path), (14, fsdp_path),
                         (15, vision_path), (16, frames_path),
                         (17, zero3_path), (18, serve_split_path)):
        t = time.perf_counter()
        counts.update(check(card, *runs[phase]))
        secs[phase] += time.perf_counter() - t
    print("phases 11-18, runs and checks: " + ", ".join(
        f"phase {p} {v:.3f} s" for p, v in secs.items()))
    return counts, checks, times


def _result(card, phases):
    """The kernels line, the card, the result."""
    import torch

    counts, checks, times = phases
    meta = {  # source, TPU kernel, the run of the path it serves
        "row_norms": ("csrc/row_norms.cu", "clip_aggregate.py:53",
                      "clipped"),
        "clip_bucket_select": ("csrc/clip_aggregate.cu",
                               "clip_aggregate.py:67", "clipped"),
        "coordinate_median": ("csrc/clip_aggregate.cu",
                              "coordinate_median.py:65", "cm-unbucketed"),
        "gm_resident": ("csrc/geometric_median.cu", "geometric_median.py:39",
                        "fig2-rfa"),
        "diff_row_ssq": ("csrc/geometric_median.cu", "centered_clip.py:149",
                         "fig2-rfa-wide"),
        "bucket_means": ("csrc/geometric_median.cu", "centered_clip.py:164",
                         "fig2-rfa-wide"),
        "gm_update": ("csrc/geometric_median.cu", "geometric_median.py:61",
                      "fig2-rfa-wide"),
        "gram_matrix": ("csrc/krum.cu", "krum.py:111", "serve-krum-steady"),
        "cross_gram": ("csrc/krum.cu", "krum.py:140", "serve-krum-steady"),
        "weighted_row_sum": ("csrc/krum.cu", "krum.py:185",
                             "serve-multikrum-bucketed"),
        "select_row": ("csrc/krum.cu", "krum.py:225", "serve-krum-steady"),
        "cclip_resident": ("csrc/centered_clip.cu", "centered_clip.py:104",
                           "fig1-cclip"),
        "cclip_update": ("csrc/centered_clip.cu", "centered_clip.py:156",
                         "serve-cclip"),
        "clipped_diff_ssq": ("csrc/clipped_diff.cu", "clipped_diff.py:28",
                             "entry-points"),
        "clipped_diff_scale": ("csrc/clipped_diff.cu", "clipped_diff.py:38",
                               "entry-points"),
        "bucketed_cm": ("csrc/clip_aggregate.cu", "bucketing.py:26",
                        "entry-points"),
    }
    kernels = []
    for name, (source, replaces, path) in meta.items():
        if counts[path][name] < 1:
            raise AssertionError(f"{name} was not launched on its path "
                                 f"({path})")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "path": path, "launches": counts[path][name],
            "launches_by_path": {k: c[name] for k, c in counts.items()},
            "max_abs_err": checks.max_abs[name],
            **times[name],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
