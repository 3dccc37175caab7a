#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: the profile -> predict -> decide
path, the online oracle riding the streaming simulator, the queueing, Pareto
and fleet slice of the simulator, the serving path, the kernel bench,
training (the LM loop, its flash backward, federated profiling), the
main paths traced by ``repro_torch.obs``, the mesh path with the
dry-run's predictions held against the card, the ten examples, the
benches, and the collating benches over what they wrote.

    python3 chip_smoke.py

Phases, in order (any failed check exits non-zero; nothing is caught):

1. Environment: the card's name and power limit (nvidia-smi), then the
   nine CUDA sources built from ``src/repro_torch/csrc`` in parallel (one
   ``nvcc`` each), with each build's register, spill and shared-memory
   lines; the SASS of each of ``flash_fwd_wgmma``'s ten instances (D, Dv
   = 64, 96, 128, 192/128, 256, each without and with the lse store) and of ``w8a16_wgmma`` must hold HGMMA
   and UTMALDG, none may write an A register of a ``wgmma`` still in
   flight (every instance's count is printed), and no
   ``flash_fwd_wgmma`` instance may spill; no instance of ``fleet_scan``'s
   registers route, of ``slstm_scan``'s cluster route or of the flash
   backward's tensor-core kernels (``flash_bwd_dkdv_mma``,
   ``flash_bwd_dq_mma``, 5 each) may use local memory (ptxas: 0 bytes of
   stack frame and of spills).
2. The decision slice at full width, through the entry points a user calls:
   a ``GBTRegressor(n_trees=200, max_depth=12, subsample=0.8, n_bins=64)``
   fitted on the card (``gbt_hist`` kernel, one launch per tree level: at
   most 200 x 12 = 2,400) on ~15.8k per-layer rows of all ten configs on
   the five edge devices, then ``decide_all`` over 2^20
   environments for qwen3-1.7b at its published shape (28 layers) with a
   ``PredictorCost`` (``tree_predict`` + ``decide_split`` kernels), with a
   ``CompositeCost`` over it, and the analytic default over a mixed fleet.
   Each plan is held against the exact f64 ``backend="torch"`` sweep.
   Launch counts of the three kernels are read right after this path
   (``tree_predict`` also per CUDA kernel: each call one descent with its
   trees in shared memory, then one fold).
   Then the fit runs again with timers (``fit_split``): its histogram
   calls, its per-tree updates, and the host's growth code in between.
3. The profiling loop at full width (the paper's offline loop, as
   ``benchmarks/fig3_predictions.py`` runs it): ``generate(n_runs=150,
   max_steps=6, seed=0)`` profiles 150 Table-I runs on the card (600
   more projected onto the other edge specs), every target finite and
   > 0, the TF32 flags back to their values afterwards, and one config of
   each of the six networks counted again on the CPU (equal FLOPs and
   parameters: ``FlopCounterMode`` counts by formula).  On the normalised
   80/20 split: ``MultiTargetGBT(300 trees, depth 12, subsample 0.8)``
   fitted on the card and on the CPU (node arrays equal, all 3 × 300
   trees), its lowered form's card predictions equal to the plain
   version's, ``MLPRegressor(hidden=(2048, 1024, 512), epochs=150)`` and
   ``RidgeRegressor()`` on the card, each family's per-target nRMSE; the
   MLP also on the card and on the CPU from the same initial weights:
   one full-batch step (the median gap of the parameters' displacements
   within ``MLP_STEP_TOL`` of their median) and two epochs
   (predictions within ``MLP_CARD_TOL`` of their scale), both measured by
   ``repro_torch.bench.mlp_spread``, which says why two epochs drift more.
   Then ridge and ``MLPRegressor(hidden=(256, 128), epochs=10)`` fitted on
   phase 2's per-layer rows, and ``decide_all(PredictorCost(model))`` over
   phase 2's 2^20 environments with each, held near-optimal against
   ``backend="torch"``.  ``gbt_hist``, ``tree_predict`` and
   ``decide_split`` launch counts are set to 0 before the phase and read
   after it.
4. The online oracle riding the streaming simulator, at the reference's
   own scale, each check holding the card's run against the same port code
   on the CPU in this process: (a) the profiling GBT of
   ``examples/oracle_serving.py`` (120 trees, depth 8, 256 random layers ×
   the five edge specs) fitted on both (node arrays equal); (b)
   ``decide_all(oracle.cost_model())`` over phase 2's 2^20 link states on
   the example's 48 layers, near-optimal against ``backend="torch"``, with
   the identity correction and again after a uniform 2x slowdown has moved
   the gain; (c) the example's drift loop (700 observations, the 12 W and
   15 W specs 3x slower from step 200; window 256, min_refit 120): at
   least one drift and one refit, the recovered nRMSE below half its peak,
   and the drift steps, refit versions, refit trees and nRMSE track equal
   to the CPU's; (d) ``benchmarks/bench_stream.py``'s largest cell (300
   tasks, 32 nodes, Poisson 200/s) with a ``PredictorCost`` and with an
   oracle: identical records, no refit, gain 1.0, equal to the CPU run;
   (e) the example's drifted stream (400 tasks over 400 s, 4 nodes): a
   drift and a refit through the loop, telemetry equal to the CPU run's;
   (f) (d)'s stream deciding each admitted task's split over a drifting
   link with the ``decide_split`` kernel, each within 1e-4 of the f64
   optimum of its snapshot.  The three decision kernels' launch counts
   are set to 0 before the phase and read after it (``oracle_launches``);
   the ``oracle`` line carries the fit and refit times, µs per observe,
   each stream's time and µs per arrival, and the nRMSE.
5. The queueing, Pareto and fleet slice, extending phase 4: (a)
   ``benchmarks/bench_fleet.py``'s largest cell (100,000 tasks on 256
   nodes over one diurnal day of 3,600 s, per-node diurnal links stepped
   every second, min-min) through ``simulate_stream(engine="fleet")`` on
   the card (its singleton runs on the ``fleet_scan`` kernel, each on the
   registers route) and on the CPU (the plain version): records,
   ``summary()`` and counters equal, and every singleton run's inputs and
   outputs equal on the two devices;
   (b) its first cell (20,000 tasks, 16 nodes) through the event loop and
   the fleet engine on the card, records equal, in four split modes: none,
   decide-at-admission with ``split_backend="kernel"`` from the
   jetson-orin-nano and from the pi5-arm to edge-server-a100 over a
   diurnal link, and a ``ParetoStreamScheduler`` (on the cell of
   ``PLANNER_TASKS`` tasks over the same day: its event loop is the
   phase's longest run); every kernel split (the
   event loop's E = 1 calls and the fleet engine's slab-batched ones)
   within 1e-4 of the f64 optimum of its environment; (c)
   ``benchmarks/bench_contention.py``'s tail-vs-mean scenario at its full
   240 s horizon: each arrival's split decided by ``decide_all(QueueAware
   Cost(CompositeCost(tail=...)), backend="kernel")`` at E = 1 with the
   live pool wait and the Weibull tail, for the mean, p99 and cvar
   policies, each split within 1e-4 of the ``backend="torch"`` sweep at
   the same pool state, the kernel-driven run's splits and misses equal
   to the torch-driven run's (a difference is printed with its costs),
   and tail-aware misses below mean-only; (d)
   ``benchmarks/bench_stream.py``'s largest cell with
   ``NodePools.uniform(32, 2)`` and a ``WeibullRTT`` on both engines on
   the card and on the CPU, all equal.  ``fleet_scan`` and
   ``decide_split`` launch counts are set to 0 before the phase and read
   after it; the ``fleet`` line carries each run's wall time, events/s,
   ``fleet_scan`` launches (per route) and steps, the slab sizes, misses
   per policy and µs per decision.
6. The serving slice at full width: ``ServeEngine(cfg, batch_size=4,
   max_len=prompt + 40, seed=0)`` on qwen3-1.7b, zamba2-1.2b,
   deepseek-v2-lite-16b (MLA + MoE), phi-3-vision-4.2b, gemma-2b (MQA,
   head dim 256), xlstm-350m (24 blocks, ``[m, m, m, s] × 6``),
   whisper-tiny (4 + 4 layers over 1,500 encoder frames drawn on the host
   from the seed), starcoder2-7b (36 query heads on 4 kv heads,
   ``gelu_plain``) and minitron-4b (24 on 8, ``relu2``, a 256,000-word
   vocabulary) at their published shapes in bf16, one at a time (each
   freed before the next loads), each serving 8 greedy requests of 2048
   random tokens (whisper: 224, its previous-text prompt cap) with 32 new
   tokens (``flash_attention``, ``ssm_scan`` and ``slstm_scan`` kernels;
   their launch counts are read right after the nine models: all 376
   flash launches must have taken ``flash_fwd_wgmma``, at head dims 128,
   64, 192 with v at 128, 96 and 256, none ``flash_fwd``, with
   whisper's 24 non-causal encoder and cross-attention calls among them;
   every ``ssm_scan`` call must have launched ``ssd_cb`` and
   ``ssd_chunk`` once each; ``slstm_scan`` 12 times, once an sLSTM block
   a batch, all on its cluster route).  Every request must get 32 in-range tokens and every logit
   must be finite.
6b. Continuous batching at full width and depth in bf16:
   ``ContinuousBatchEngine(deepseek-moe-16b, slots=4, max_len=2088,
   cost=AnalyticCost(), decision_backend="kernel")`` over 8 requests of
   1024-2048 seeded random tokens, 32 greedy new tokens each, arriving
   50 ms apart on its virtual clock, with a seeded link observation at each
   admission.  Each admission runs a batch-1 prefill (28
   ``flash_fwd_wgmma`` launches), splices its cache into a slot and
   re-plans the request's split (one ``decide_split`` launch, E = 1);
   decode runs the four slots at ragged positions.  Checks: 32 in-range
   tokens and finite logits per request, ``admitted_at >= arrived_at``,
   occupancy > 1, 8 re-plans, each split within 1e-4 of the f64 optimum
   of its environment, launches exactly 8 x 28 flash (all on the tensor
   cores) and 8 ``decide_split``.  The ``continuous`` line carries each
   admission's prefill and re-plan wall time, decode steps/s and
   tokens/s, peak memory and each request's virtual sojourn and queue
   wait.
7. The whole model on the card, f32: the kernel path
   (``build_model(cfg)``) and the plain path (``impl="naive"``) on one
   512-token prompt with shared weights, for qwen3-1.7b, zamba2-1.2b,
   phi-3-vision-4.2b, gemma-2b, xlstm-350m, starcoder2-7b (~30 GB of
   f32 weights) and minitron-4b whole (phi-3 also on a
   seeded embeddings prompt; xlstm's plain path runs the sLSTM's step
   loop), whisper-tiny whole on a 224-token prompt over seeded frames, and
   deepseek-moe-16b and deepseek-v2-lite-16b at full width cut
   to 4 layers (``MODEL_CHECKS``); their last-token logits must agree
   within 1e-3 of max |logit|.  The MoE lines count the (token, layer)
   expert choices that differ between the two paths and the smallest gap
   between a token's k-th and (k+1)-th router probability.  Then the continuous
   engine in f32 on deepseek-moe-16b cut to 4 layers: its greedy tokens
   for 4 requests x 8 tokens must equal ``ServeEngine(batch_size=1)``'s on
   the same weights (a mismatch prints the step and the top-2 logit gap).
8. Each kernel against its plain PyTorch version on the card, at the
   slices' shapes, with the tolerance stated beside each check; flash,
   ``ssm_scan`` and ``slstm_scan`` also against themselves (two calls,
   the same bits).  ``slstm_scan`` at xlstm-350m's prefill (B 4, S 2048,
   H 4, du 256) in bf16 and f32 on both routes (cluster, as served, and
   block) against its plain step loop: f32 h and the final state within
   1e-4, bf16 h within 2^-7 |h| + 1e-4.
   ``tree_predict`` equals its plain version bit for bit, phase by phase
   (the leaf matrix, the in-order fold) and on its global route too.
   ``gbt_hist`` must equal the plain version on a CPU copy bit for bit at
   two levels of phase 2's fit, two of phase 3's and two of phase 4's
   refits, as the fits called them (each fit's first root, and its level
   with the most nodes), and the card's GBT fit must grow the node arrays
   of the same fit on the CPU (``flatten_gbt``, bit for bit: all 200 trees
   with identical splits).
9. Timing with CUDA events after a warm-up: each kernel, its plain
   version, the library call where one computes the same function, and
   the bound (the larger of bytes over 3.35 TB/s and operations over the
   peak of the work's type: 67 TFLOP/s f32 outside the tensor cores, or
   989 TFLOP/s dense bf16 on the tensor cores; the H100 SXM's published
   rates, defined once in ``repro_torch.bench.common``).  The bf16 flash
   kernel and SDPA, ``tree_predict`` and ``decide_split`` are replayed
   from a CUDA graph, with the eager time beside it; the last two are
   timed by the kernel bench's rows on the decision path's inputs (the
   fit's ensemble at 56 rows; the predictor sweep), ``tree_predict`` also
   per CUDA kernel, ``decide_split`` also with L2 overwritten before each
   call and with its bound at the 30 operations a split that its
   division-bound form took; ``gbt_hist`` is timed at the six levels of
   phase 8, ``ssm_scan`` as a call and per CUDA kernel (``ssd_cb``,
   ``ssd_chunk``), and ``slstm_scan`` eager in bf16 and f32 on both
   routes, beside its plain step loop (no library call computes it).  Flash at the other
   served shapes (``OTHER_FLASH_SHAPES``: the MLA prefill with v at 128,
   phi-3's D 96, gemma's D 256 with one kv head, one MoE admission,
   whisper's non-causal encoder over 1,500 frames and its cross-attention
   of 224 queries over them, the prefills of starcoder2-7b and minitron-4b
   at GQA groups of 9 and 3) through ``ops`` as the models call it, each
   first held against its plain version in bf16 (tensor cores) and f32
   (CUDA cores, 1e-5 of max |want|) and against a second call bit for
   bit, with SDPA beside it and, in bf16, the CUDA-core kernel at the same
   shape (unaligned copies of the inputs, eager).  Phase 4's new shapes:
   ``tree_predict`` on one observation's row and on one admission's 32
   rows, eager as the path calls it (the graph replay beside), and
   ``decide_split`` on one admission's E = 1 sweep.  Phase 5's:
   ``fleet_scan`` on (a)'s longest singleton run, one launch, eager (f64:
   its operations over 34 TFLOP/s), on the registers and the shared
   route, its plain version on the card once by the host clock and held
   bit for bit against each; ``decide_split`` at
   (b)'s largest fleet slab and at (c)'s E = 1 contention sweep.
10. The kernel bench, ``repro_torch.bench.kernels.main()``, the entry point
   of ``int8_matmul`` (W8A16; no other path runs it): every kernel of the
   bench at its main path's shape (all six: ``tree_predict`` on a
   synthetic ensemble of the fit's size, ``decide_split`` at E = 2^20 for
   qwen3-1.7b and for 300 layers) and ``int8_matmul`` at qwen3-1.7b's five
   products (decode B 1 and B 4, the down projection, the LM head,
   prefill) in bf16, each held to its tolerance (``err_over_tol`` < 1;
   ``int8_matmul`` to ``int8_matmul.ref.int8_tolerance``) and timed beside
   its plain version, the library call and its bound.  The prefill row
   must have run on ``w8a16_wgmma`` and the decode, down-projection and
   LM-head rows on ``w8a16_mma`` (per-kernel launch counts), and the
   wgmma kernel's first pass (the weight in fragment order) must equal
   ``int8_matmul.ref.pack_fragments`` byte for byte.  The decode
   B 4 up projection is ``int8_matmul``'s record on the kernels line, with
   the prefill row's times and bound beside it.
11. Training, one model at a time, each freed before the next: (a)
   flash's log-sum-exp (``return_lse``) at every served
   ``flash_fwd_wgmma`` instance and at the training shapes (qwen3's at
   B 8, S 128; whisper-tiny's encoder, decoder and cross-attention at
   B 8; the six configurations of (m) at B 8, S 128) held against the
   plain version's within ``LSE_TOL`` (1 + |lse|),
   the output equal bit for bit to a call without it and within
   ``flash_attention.ref.bf16_tolerance`` of the plain version; qwen3's
   and the six training shapes timed with their lse beside SDPA, the
   bound counting the lse's bytes; the f32 route (``flash_fwd``) at the
   shape of its phase 14 launches (``train_tiny_lm``'s reduced qwen3-1.7b,
   ``F32_FLASH_SHAPE``, with lse) timed beside its f32 bound and SDPA on
   the same f32 tensors with TF32 off; (b) the backward in f32
   (``FlashAttention``: ``flash_fwd`` with its lse, the backward kernel's
   CUDA-core route ``flash_bwd``, the plain backward called 0 times on the
   card) at qwen3's, whisper's and the six training shapes (head dims 96,
   192 with v at 128 and 256; GQA groups of 9 and 3) and at
   starcoder2-7b's prefill (B 4, S 2048, group 9) against autograd
   through ``naive_attention`` within ``BWD_TOL``; the bf16 backward on
   the tensor cores (``flash_bwd_mma``) at these shapes and whisper's
   three training shapes against the plain backward of the same bf16
   inputs within ``flash_attention.ref.bwd_bf16_tolerance``, the same
   bits twice; at each causal shape of ``BWD_TIMED`` the kernel (CUDA
   graph and eager) timed beside the plain backward, SDPA's backward and
   the bound (``kernels.work.flash_bwd_work``);
   (c) qwen3-1.7b at full width and depth in bf16 through
   ``train()``: 30 steps at the ``TrainConfig`` defaults, then 5 at B 4,
   S 2048, every loss finite and the last 5 of the first run below its
   first 5, every flash call (the forward and its recompute: 2 a layer
   a step) on ``flash_fwd_wgmma`` and every backward (1 a layer a step)
   on ``flash_bwd_mma`` (counts set to 0 before, read after);
   steps/s, tokens/s, peak memory; (d) the same model in f32 cut to 2
   layers: one ``train_loss`` and its gradients on the card (``flash_fwd``
   and the backward) against the CPU, TF32 off, within
   ``TRAIN_F32_TOL``; (e) whisper-tiny at full width in bf16 through
   ``train()`` (6 steps, 1,500 frames), every flash call on the tensor
   cores; (g) ``ckpt.save`` / ``latest`` / ``restore`` of whisper's
   trained parameters, equal on the card; (f) ``python -m
   repro_torch.launch.train --arch qwen3-1.7b --steps 5`` (f32, naive,
   as the reference's launcher runs) in a child process; (h) FedAvg at the
   ``FedAvgConfig`` defaults, without and with ``DPConfig()``, on phase
   3's profiling dataset, five non-IID clients by hardware, each round's
   federated RMSE card against CPU within ``FEDAVG_CARD_TOL``
   (``repro_torch.bench.mlp_spread --fedavg``), the DP run the noisier.
   The flash record on the kernels line carries the training launches,
   the training shape's times and the backward's; the backward kernel
   has a record of its own (``flash_attention_bwd``: its launches in
   phase 11's trainings, qwen3's B 4, S 2048 times and bound).  Then the recurrent
   families (``scan_training_slice``): (i) the SSD backward kernels
   (``ssd_bwd_chain``, ``ssd_bwd_chunk``) against
   ``ssd_scan_chunked_bwd_ref`` and (j) ``slstm_scan_bwd`` against
   ``slstm_scan_bwd_ref`` (R in bf16 and f32) at the training shapes (B 8,
   S 128 and B 4, S 2048; zamba2's H 64, P = N = 64, Q 128 and
   xlstm-350m's H 4, du 256), random cotangents on every output, each
   within ``SCAN_BWD_TOL`` of each gradient's largest magnitude and the
   same bits twice, the forward that saves its states the same bits as the
   served one, each timed part by part (``bench.scan_bwd``: the SSD's
   chain, chunks, at each head group too, and head sum; the sLSTM's
   chain and dR product) beside its bounds (f32 on the CUDA cores; the
   SSD's also as three TF32 products at the TF32 rate), the plain
   backward beside; (k)
   zamba2-1.2b and xlstm-350m at full width and depth in bf16 through
   ``train()``: 10 steps at B 8, S 128, then 3 at B 4, S 2048, every loss
   finite, the last 3 of the first run below its first 3, the counts set
   to 0 before each run and read after it: every ``ssm_scan`` call (the
   forward and its recompute, 2 a Mamba layer a step) one ``ssd_cb`` and
   one ``ssd_chunk``, one backward call a layer a step, each on
   ``ssd_bwd_chain`` and ``ssd_bwd_chunk``; every sLSTM forward (2 a block
   a step) and backward (1) on the cluster route; zamba2's shared-block
   flash (2 a group a step) all on ``flash_fwd_wgmma``; steps/s,
   tokens/s, peak memory; (l) one f32 ``train_loss`` and its gradients of
   each, cut to 2 groups, ``impl="chunked"`` (the kernels on the card, the
   plain versions on the CPU), TF32 off, within ``TRAIN_F32_TOL``
   (xLSTM's leaves against their block's largest gradient).  The
   ``ssm_scan`` and ``slstm_scan`` records gain ``training_launches``,
   ``training_backward_launches`` and ``backward`` timings.  Then the six
   configurations served but not trained above
   (``served_training_slice``): (m) deepseek-moe-16b (MoE),
   deepseek-v2-lite-16b (MLA + MoE), phi-3-vision-4.2b (its embeds),
   gemma-2b (D 256, MQA, tied embeddings), starcoder2-7b (group 9,
   ``gelu_plain``) and minitron-4b (group 3, ``relu2``) at full width in
   bf16 through ``train()``, 10 steps at B 8, S 128 with 3 warm-up steps,
   at full depth or at ``TRAIN_LAYERS``' cut (the MoE models to 6 layers,
   starcoder2-7b to 20: weights, gradients and AdamW's moments), every
   loss finite, the last 3 below the first 3, every flash call (2 a layer
   a step) on ``flash_fwd_wgmma``; steps/s, tokens/s, peak memory; (n)
   one f32 ``train_loss`` and its gradients of each at full width cut to
   2 layers, card against CPU within ``TRAIN_F32_TOL`` (the VLM's token
   embedding without a gradient on either side; the MoE lines count the
   (token, k) router choices that differ).  The flash record gains
   ``served_training_launches`` and ``training_shapes``.

12. The main paths traced (``trace_slice``): each again with a
   ``repro_torch.obs.Tracer``, held equal to its untraced run. (a) Phase
   4's 300-task, 32-node stream with the oracle riding it, on the card and
   on the CPU: the card's records equal phase 4's untraced card run field
   for field, ``attribute(tracer).summary()`` equals the CPU's traced run
   (virtual time), ``attribute(telemetry)`` equals ``attribute(tracer)``
   on the phase totals, ``Telemetry.to_prometheus()`` and
   ``registry().to_rows()`` equal the CPU's; phase 4's decide-at-admission
   run traced, its records and ``decide_split`` launches phase 4's. (b)
   ``bench_fleet.py``'s 20k × 16 cell on the fleet engine with
   ``WeibullRTT`` draws (transfer spans), untraced and traced on the card
   and traced on the CPU: equal records, and the card's spans and
   instants (``span_arrays`` / ``instant_arrays`` columns) equal the
   CPU's; the host seconds of each run and of the first read that builds
   the spans. (c) TRACE_ARCH through ``ServeEngine`` at phase 6's shape
   with a ``MetricsRegistry``: phase 6's tokens, one ``prefill`` and one
   ``decode`` span and one ``first_token`` instant per batch, the spans'
   sums equal to ``stats.prefill_s`` / ``decode_s``; CONT_ARCH through
   ``ContinuousBatchEngine`` at phase 6b's: its tokens, an ``admit`` and a
   ``replan`` instant and a lifecycle per request.  Both models are built
   again from the seed (their ``init_s`` is on the line).  Every Chrome
   trace is written to ``results/trace_*.json`` and validated from the
   file; the kernels' launches per traced path (counts set to 0 just
   before, read just after) join the kernels line as ``trace_launches``;
   the ``trace`` line has the rest.
13. The mesh and the dry-run (``mesh_slice``), on a one-rank ``nccl``
   (1, 1) mesh (``launch.mesh.make_card_mesh``): (a) qwen3-1.7b at full
   width and depth in bf16 through ``launch.steps.assemble``, 5 steps at B
   8, S 128 under ``train()``, its losses the same bits as ``train()``'s on
   the same batches, init and knobs (flash 2 a layer a step, all on
   ``flash_fwd_wgmma``); (b) deepseek-moe-16b's prefill through
   ``assemble`` at phase 6b's admission shape (B 1, S 2048), its logits the
   same bits as ``api.prefill``'s; (c) zamba2-1.2b's decode step through
   ``assemble`` after a 2048-token prefill at B 4, the same bits as
   ``decode_step``; (d) ``decide_all_sharded(mesh=)`` over phase 2's 2^20
   envs, bit for bit with ``backend="torch"``.  For (a)-(c) the dry-run at
   chips = 1 (``launch.dryrun.step_costs``) against the card: its static
   bytes at most ``max_memory_allocated()`` (the ratio printed), its FLOPs
   (ATen's and the kernels' custom ops by their ``kernels.work`` formulas)
   within ``MESH_FLOP_TOL`` of ``FlopCounterMode`` of the card's step,
   and its roofline bound at most the measured step time (a bound
   above it is an impossible reading); the ``mesh_check`` and ``mesh``
   lines, flash's ``mesh_launches`` on the kernels line.  After phase 14,
   alone on the card, four processes of ``python -m
   repro_torch.launch.card_mesh`` (``nccl`` puts no two ranks on one
   device): a ``gloo`` (2, 2) data x model mesh whose compute and
   collectives all run on the card's tensors: (a) qwen3-1.7b trained 2
   steps with sequence parallelism (checked on: its row-parallel products
   reduce-scattered), (b) gemma-2b's prefill and 2 decode steps on its
   sequence-split cache at B 2 and B 1, (c) deepseek-v2-lite-16b's
   latent-cache decode, naive and absorbed, and with MoE capacity that
   drops tokens, held to one process serving each data rank's row alone
   (the whole batch in one process at least ``CARD_MESH_DROP_MIN`` away),
   (d) xlstm-350m and whisper-tiny trained 2 steps, then served, their
   heads split (``slstm_scan`` and flash on half the heads), each against
   one process on the card within ``CARD_MESH_TOL``
   (``CARD_MESH_EXPECT``: the kernels each part launches, the heads they
   see), gradients within ``CARD_MESH_GRAD_TOL``; the ``mesh4`` line,
   ``mesh4_launches`` on the kernels line.
14. The examples (``examples_slice``): each ``repro_torch.examples``
   module through its ``main`` on the card at the reference's defaults
   (``EXAMPLE_RUNS``; ``train_tiny_lm`` also on zamba2-1.2b and xlstm-350m
   for 30 steps), TF32 off, its output captured, the kernels' launches
   read after each (counts set to 0 at the phase's start); each run must
   launch the kernels of ``EXAMPLE_EXPECT`` (``decide_split``,
   ``tree_predict``, ``gbt_hist``, f32 ``flash_fwd`` in ``serve_batched``
   and, storing its lse, in ``train_tiny_lm``, ``ssm_scan`` and
   ``slstm_scan`` forward and backward), and every example's own asserts
   hold.  Child processes started at the phase's start run on the CPU
   meanwhile: the pinned examples (``PINNED_EXAMPLES``: the policy table
   and sweep shares, misses and percentiles, the streaming telemetry, the
   attribution, the pod-scale schedules), whose printed lines, host
   timing masked, must equal the card's; the three ``train_tiny_lm``
   runs, whose every step's loss the card's must match within
   ``EXAMPLE_LOSS_TOL`` (the same host-drawn weights and batches, the
   plain versions on the CPU); and ``python -m repro_torch.launch.dryrun``
   on meta tensors (xlstm-350m's shapes left out), whose records
   ``pod_scale_scheduling`` reads.  ``serve_batched``'s prefill logits of
   its first batch, card against CPU on the same weights, within
   ``EXAMPLE_LOGIT_TOL`` of the largest |logit|.  The ``example`` and
   ``example_losses`` lines, the ``examples`` line (seconds per run,
   launches, the records the leave-one-out ran over, the loss gaps, the
   logit error), ``examples_launches`` on the kernels line.
15. The benches (``bench_slice``): each ``repro_torch.bench`` module
   (``BENCH_EXPECT``) on the card, its CPU rows, the card's plain-path rows
   and its kernels' rows in one run: the smoke mode of ``decisions`` (all
   three modes), ``oracle``, ``stream``, ``fleet`` and ``contention``;
   ``scheduler``, ``offload``, ``fl`` and ``serving`` whole; ``fig2a_mlp``
   at ``BENCH_FIG2A`` on the card, ``fig2b_gbt`` at ``BENCH_FIG2B`` and
   ``fig3_predictions`` on the kernels, the last five on phase 3's records.
   Each module holds the reference script's gates (the card's sweeps no
   slower than the CPU's at 16,384 envs and 65,536 rows, one predict call
   per predictor sweep, the drift loop's refit and recovery and the card's
   loop equal to the CPU's, the gain within 0.25 of 2, incremental no
   slower than from-scratch, the fleet engine no slower than the event loop
   and tracing within 10%, the contention assertions) and fails a kernel
   row whose kernel was not launched; each bench's rows between them must
   launch the kernels of ``BENCH_EXPECT``.  A gate the card breaks
   (``BENCH_BROKEN``, each an open fault in ROADMAP.md §3; none since the
   fleet engine's tracing overhead was repaired) is printed with its
   numbers (``gate_broken``) after its bench's rows are written; any other
   failed gate stops the script.  The ``bench`` line (rows, seconds and launches per bench),
   ``bench_launches`` on the kernels line; rows under
   ``results/bench_torch_<name>.json``.  Phases 3, 4(d), 5(a)-(d) and 12(b)
   build their cells with these modules (``fig3_predictions``' predictors,
   ``stream.cell``, ``fleet.fleet_day``, ``contention.tail_scenario``).
16. The collating benches (``collate_slice``), each on what the phases
   before wrote: ``bench.roofline`` over phase 14's dry-run records (every
   ok row's bound above 0, its dominant term the largest);
   ``bench.perf_experiments``, the reference's ten §Perf experiments on
   meta tensors, run by CPU children (``CUDA_VISIBLE_DEVICES=""``, one a
   group of ``PERF_PAIRS``) started with phase 14's, every experiment ok
   and A1's compute term below ``ABSORB_MAX`` of A0's (a ``perf`` line
   each: terms, bytes a device, ratios to the pair's baseline, verdict);
   ``bench.report`` over phase 15's rows (a headline for each of the five
   subsystems, naming the card's ``nvidia-smi`` line, or ``cpu`` where the
   headline is a host-only row); ``bench.write_experiments`` from all of
   them and phase 3's records (saved as
   ``results/profiling_records_torch.json``) to
   ``results/EXPERIMENTS_torch.md`` (every section of
   ``EXPERIMENTS_HEADINGS``, none of ``TPU_FIGURES``); and ``python -m
   repro_torch.bench.run scheduler`` in a child on the card meanwhile
   (exit 0, its header, footer and rows).  The ``collate`` line has the
   seconds of each step.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or run from a
directory that holds this file and nothing else of the repository, it
fails before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_ENVS = 1 << 20
SEED = 0
SERVE_ARCHS = ("qwen3-1.7b", "zamba2-1.2b", "deepseek-v2-lite-16b",
               "phi-3-vision-4.2b", "gemma-2b", "xlstm-350m", "whisper-tiny",
               "starcoder2-7b", "minitron-4b")
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_REQUESTS = 4, 2048, 32, 8
# whisper's decoder prompt: its previous-text cap, n_text_ctx // 2 = 224
# (the encoder takes its 1,500 frames)
PROMPT_OF = {"whisper-tiny": 224}
# the served model phase 12 serves again, traced (phase 6's shape)
TRACE_ARCH = "qwen3-1.7b"
# continuous batching (phase 6b): prompts drawn from 1024-2048 tokens,
# arriving 50 ms apart on the engine's virtual clock
CONT_ARCH, CONT_PROMPT, CONT_GAP_S = "deepseek-moe-16b", (1024, 2048), 0.05
CHECK_PROMPT = 512                   # the whole-model f32 check
# f32 checks at full width; the MoE models' depth cut to 4 layers (their
# 27-28 f32 layers are ~65-68 GB); starcoder2-7b at full depth (~30 GB)
CHECK_LAYERS = 4
MODEL_CHECKS = (("qwen3-1.7b", None), ("zamba2-1.2b", None),
                ("deepseek-moe-16b", CHECK_LAYERS),
                ("deepseek-v2-lite-16b", CHECK_LAYERS),
                ("phi-3-vision-4.2b", None), ("gemma-2b", None),
                ("xlstm-350m", None), ("whisper-tiny", None),
                ("starcoder2-7b", None), ("minitron-4b", None))
# (case, B, Sq, Sk, Hq, Hkv, D of q/k, D of v, causal) of flash_attention
# on the served models' paths: deepseek-v2-lite's MLA prefill,
# phi-3-vision's prefill, gemma-2b's prefill (MQA), one deepseek-moe
# admission, whisper-tiny's encoder over 1,500 frames and its decoder's
# cross-attention (224 prompt tokens against the frames), both non-causal,
# and the prefills of starcoder2-7b and minitron-4b (GQA groups of 9 and 3)
OTHER_FLASH_SHAPES = (
    ("mla_dsv2lite", 4, 2048, 2048, 16, 16, 192, 128, True),
    ("phi3v_d96", 4, 2048, 2048, 32, 32, 96, 96, True),
    ("gemma_d256", 1, 2048, 2048, 8, 1, 256, 256, True),
    ("moe_admission", 1, 2048, 2048, 16, 16, 128, 128, True),
    ("whisper_encoder", 4, 1500, 1500, 6, 6, 64, 64, False),
    ("whisper_cross", 4, 224, 1500, 6, 6, 64, 64, False),
    ("starcoder2_7b", 4, 2048, 2048, 36, 4, 128, 128, True),
    ("minitron_4b", 4, 2048, 2048, 24, 8, 128, 128, True))
PROFILE_RUNS, PROFILE_STEPS = 150, 6  # benchmarks/common.py's grid
MLP_STEP_TOL = 1e-5                  # one MLP step, card vs CPU
MLP_CARD_TOL = 5e-2                  # two-epoch MLP, card vs CPU
# benchmarks/bench_fleet.py's cells: its largest (the engine on card and
# CPU) and its first (event loop against fleet engine), one diurnal day
FLEET_TASKS, FLEET_NODES, FLEET_DAY_S = 100_000, 256, 3600.0
COMPARE_TASKS, COMPARE_NODES = 20_000, 16
# the Pareto planner's mode of (b) at a cell of this many tasks (its event
# loop took 90-116 s at 20,000, which kept the script over 1,100 s)
PLANNER_TASKS = 8_000
# benchmarks/bench_contention.py's tail-vs-mean scenario at full horizon
CONTENTION_HORIZON_S, CONTENTION_DEADLINE_S = 240.0, 0.35
# the training phase (11): qwen3-1.7b at full width and depth in bf16, 30
# steps at the TrainConfig defaults (B 8, S 128), then 5 at B 4, S 2048
TRAIN_ARCH = "qwen3-1.7b"
TRAIN_RUNS = ((30, 8, 128), (5, 4, 2048))
CHECK_TRAIN_LAYERS = 2               # the f32 card-vs-CPU check's depth
# the six served-only configurations trained in phase 11 (m)-(n), and the
# flash_fwd_wgmma instance (D, Dv) each trains through
SERVED_TRAIN_ARCHS = {"deepseek-moe-16b": (128, 128),
                      "deepseek-v2-lite-16b": (192, 128),
                      "phi-3-vision-4.2b": (96, 96), "gemma-2b": (256, 256),
                      "starcoder2-7b": (128, 128), "minitron-4b": (128, 128)}
# their bf16 depth in train(): full, except where bf16 weights and
# gradients and AdamW's f32 moments (12 B a parameter) overfill 80 GB.
# The ParamTree's numel, embeddings and head L1 plus L layers:
# starcoder2-7b 0.453 + 0.217 L billion (32 layers 88.8 GB; 20 layers
# 57.5 GB), deepseek-moe-16b 0.419 + 0.588 L (28 layers 202.6 GB; 6 layers
# 47.4 GB), deepseek-v2-lite-16b 0.419 + 0.585 L (27 layers 194.5 GB; 6
# layers 47.1 GB); the rest leave room for activations and the 256,000-word
# logits at full depth (gemma-2b 30.1 GB, minitron-4b 50.3 GB, phi-3-vision
# 45.9 GB)
TRAIN_LAYERS = {"starcoder2-7b": 20, "deepseek-moe-16b": 6,
                "deepseek-v2-lite-16b": 6}
# (case, B, Sq, Sk, Hq, Hkv, D, Dv, causal) of the six configurations'
# attention at the TrainConfig defaults (B 8, S 128): the MoE's, MLA's
# (v at 128), phi-3's D 96, gemma's D 256 on one kv head, and the GQA
# groups of 9 and 3 of starcoder2-7b and minitron-4b
SERVED_TRAIN_SHAPES = (
    ("moe_train", 8, 128, 128, 16, 16, 128, 128, True),
    ("mla_train", 8, 128, 128, 16, 16, 192, 128, True),
    ("phi3v_train", 8, 128, 128, 32, 32, 96, 96, True),
    ("gemma_train", 8, 128, 128, 8, 1, 256, 256, True),
    ("starcoder2_train", 8, 128, 128, 36, 4, 128, 128, True),
    ("minitron_train", 8, 128, 128, 24, 8, 128, 128, True))
# (case, B, Sq, Sk, Hq, Hkv, D, Dv, causal) of the lse check: every served
# flash_fwd_wgmma instance at its served shape, and the training shapes:
# qwen3's, whisper-tiny's encoder, decoder and cross-attention at the
# TrainConfig defaults (B 8, S 128 against 1,500 frames), and the six
# above; the lse's training shapes timed beside SDPA (LSE_TIMED)
LSE_SHAPES = (
    ("whisper_encoder", 4, 1500, 1500, 6, 6, 64, 64, False),
    ("phi3v_d96", 4, 2048, 2048, 32, 32, 96, 96, True),
    ("qwen3", 4, 2048, 2048, 16, 8, 128, 128, True),
    ("mla_dsv2lite", 4, 2048, 2048, 16, 16, 192, 128, True),
    ("gemma_d256", 1, 2048, 2048, 8, 1, 256, 256, True),
    ("qwen3_train", 8, 128, 128, 16, 8, 128, 128, True),
    ("whisper_encoder_train", 8, 1500, 1500, 6, 6, 64, 64, False),
    ("whisper_dec_train", 8, 128, 128, 6, 6, 64, 64, True),
    ("whisper_cross_train", 8, 128, 1500, 6, 6, 64, 64, False),
    *SERVED_TRAIN_SHAPES)
LSE_TIMED = ("qwen3_train", *(c[0] for c in SERVED_TRAIN_SHAPES))
# f32 sums in another order and exp2 for exp: |lse - want| within
# LSE_TOL (1 + |want|)
LSE_TOL = 2e-5
# (case, B, Sq, Sk, Hq, Hkv, D, Dv, causal) of the f32 backward check:
# qwen3's and whisper's shapes, the six training shapes above, and
# starcoder2-7b's prefill (its group of 9, the widest)
BWD_SHAPES = (
    ("qwen3_train", 8, 128, 128, 16, 8, 128, 128, True),
    ("qwen3_prefill", 4, 2048, 2048, 16, 8, 128, 128, True),
    ("whisper_encoder", 4, 1500, 1500, 6, 6, 64, 64, False),
    ("whisper_cross", 4, 224, 1500, 6, 6, 64, 64, False),
    *SERVED_TRAIN_SHAPES,
    ("starcoder2_prefill", 4, 2048, 2048, 36, 4, 128, 128, True))
# the backward kernel timed in bf16 beside the plain backward and SDPA's
# (all causal, Sq = Sk)
BWD_TIMED = ("qwen3_train", "qwen3_prefill",
             *(c[0] for c in SERVED_TRAIN_SHAPES), "starcoder2_prefill")
# the f32 flash route's shape on the main path: train_tiny_lm's reduced
# qwen3-1.7b in f32 at the example's B 8, S 64 (B, S, Hq, Hkv, D)
F32_FLASH_SHAPE = (8, 64, 4, 2, 64)
# f32 sums in other orders over up to 2,048 keys: each of dq, dk, dv within
# BWD_TOL of its largest magnitude
BWD_TOL = 5e-5
# f32 train_loss and gradients, card against CPU, TF32 off: the loss
# relative, each gradient leaf against its largest magnitude
TRAIN_F32_TOL = 1e-4
# the recurrent families' training (phase 11 i-l): zamba2-1.2b and
# xlstm-350m at full width and depth in bf16, 10 steps at B 8, S 128 (the
# TrainConfig defaults, warm-up cut to 3 steps so that 10 steps show the
# loss falling), then 3 at B 4, S 2048
SCAN_TRAIN_RUNS = ((10, 8, 128), (3, 4, 2048))
SCAN_TRAIN_WARMUP = 3
# (case, B, S) of the scans' backward kernel checks: the training shapes
SCAN_BWD_SHAPES = (("train", 8, 128), ("prefill", 4, 2048))
# f32 sums in other orders (dB and dC summed over 64 heads; the sLSTM's
# reverse chain): each gradient of either backward kernel within
# SCAN_BWD_TOL of its largest magnitude (tests/test_torch_cuda.py measured
# <= 6.3e-6 and <= 5.2e-7 on the card)
SCAN_BWD_TOL = 1e-4
# FedAvg's federated RMSE, card against CPU, the largest relative gap of a
# round: repro_torch.bench.mlp_spread --fedavg over 16 seeds, with and
# without DP, measured at most 7.1e-5 card against CPU and 5.6e-4 between
# two CPU runs whose lr differs by 1e-6 or 1e-5 relative (a change of
# rounding size; Adam over ReLU units makes its effect vary by orders of
# magnitude from seed to seed), and this script 3.2e-4 on its own
# profiling records.  As for MLP_CARD_TOL: above 6x the card's largest
# gap and 2.6x the largest under an lr change
FEDAVG_CARD_TOL = 2e-3
# the mesh phase (13), on a one-rank nccl (1, 1) mesh: qwen3-1.7b trained
# through assemble (steps, B, S), deepseek-moe-16b's prefill at phase 6b's
# admission shape (B, S), zamba2-1.2b's decode after a prefill (B, S)
MESH_TRAIN = (5, 8, 128)
MESH_PREFILL = (1, 2048)
MESH_DECODE = (4, 2048)
# the 4-process mesh on the one card (after phase 14, ``launch.card_mesh``):
# four gloo ranks that all compute on cuda:0, a (2, 2) data x model mesh,
# each part held against one process of the same model on the card, in
# f32 with TF32 off at full width and cut depth, the mesh changing only
# the order of f32 sums (the split products, the distributed softmax): a
# loss within CARD_MESH_TOL relative and logits within it of the largest
# |logit| (the CPU mesh tests' bar, tests/test_torch_mesh.py's TRAIN_TOL;
# the card measured <= 2.9e-6); each gradient leaf within
# CARD_MESH_GRAD_TOL of the leaf's largest, the xLSTM's of its block's
# (tests/test_torch_train.py's GRAD_TOL and BLOCK_SCALED: f32 gradients
# summed in other orders; the card measured <= 8.4e-6, the mLSTM's gate
# weights)
CARD_MESH_TOL = 1e-5
CARD_MESH_GRAD_TOL = 2e-5
# part c_mla_drops: one process on the whole batch (capacity over all its
# tokens, not a data rank's) at least this far from the per-row reference
# the mesh is held to, so that the drops the check covers happened
CARD_MESH_DROP_MIN = 100 * CARD_MESH_TOL
# the card mesh's ranks run alone on the card between phases 14 and 15;
# they may take this long
CARD_MESH_WAIT = 600
# per part: the kernels its mesh run must launch, and the heads a "model"
# rank's flash / slstm_scan calls see (half of each model's)
CARD_MESH_EXPECT = {
    "a_qwen3_sp": (("flash_fwd", "flash_fwd_lse", "flash_bwd"),
                   {"flash": [8]}),
    "b_gemma_b2": (("flash_fwd",), {"flash": [4]}),
    "b_gemma_b1": (("flash_fwd",), {"flash": [4]}),
    "c_mla_naive": (("flash_fwd",), {"flash": [8]}),
    "c_mla_absorbed": (("flash_fwd",), {"flash": [8]}),
    "c_mla_drops": (("flash_fwd",), {"flash": [8]}),
    "d_xlstm": (("slstm_scan", "slstm_scan_bwd"), {"slstm": [2]}),
    "d_whisper": (("flash_fwd", "flash_fwd_lse", "flash_bwd"),
                  {"flash": [3]}),
}
# the card's step under FlopCounterMode against the dry-run's count: the
# same ops (ATen's and the kernels' custom ops) at the same shapes, so
# equal; 1% leaves room for an op whose formula reads a stride the fake
# tensor does not have
MESH_FLOP_TOL = 0.01
# the examples phase (14): each port example at the reference's defaults
# on the card, train_tiny_lm also on the two recurrent families for
# EXAMPLE_TRAIN_STEPS (past TrainConfig's 20 warm-up steps, so that the
# example's loss falls; 200 at its default arch)
EXAMPLE_TRAIN_STEPS = "30"
EXAMPLE_RUNS = (
    ("offload_simulation", ()), ("contention_tails", ()),
    ("quickstart", ()), ("oracle_serving", ()), ("streaming_offload", ()),
    ("trace_analytics", ()), ("serve_batched", ()), ("train_tiny_lm", ()),
    ("train_tiny_lm", ("--arch", "zamba2-1.2b",
                       "--steps", EXAMPLE_TRAIN_STEPS)),
    ("train_tiny_lm", ("--arch", "xlstm-350m",
                       "--steps", EXAMPLE_TRAIN_STEPS)),
    ("fl_profiling", ()), ("pod_scale_scheduling", ()))
# the flags that name a file an example reads, given to the card's run and
# the CPU's alike (not part of a run's label)
EXAMPLE_FLAGS = {"trace_analytics": ("--baseline",
                                     str(ROOT / "BENCH_7.json"))}
# train_tiny_lm's runs again with --device cpu (the plain versions, the
# same host-drawn weights and batches), their losses held step by step:
# each card loss within EXAMPLE_LOSS_TOL relative of the CPU's
# (tests/test_torch_train.py's LOSS_TOL; the card measured <= 1.84e-7)
EXAMPLE_LOSS_TOL = 1e-5
# serve_batched's prefill logits of its first batch, card against CPU on
# the same weights, within EXAMPLE_LOGIT_TOL of the largest |logit|
# (tests/test_torch_serve.py's f32 tolerance; the card measured 1.65e-7)
EXAMPLE_LOGIT_TOL = 1e-5
# the examples whose printed results are pinned bit for bit: the card's
# lines equal those of --device cpu, their host timing masked
# (EXAMPLE_HOST_TIMING); pod_scale_scheduling last (it waits for the
# dry-run)
PINNED_EXAMPLES = ("offload_simulation", "contention_tails",
                   "streaming_offload", "trace_analytics",
                   "pod_scale_scheduling")
EXAMPLE_HOST_TIMING = (r"in [0-9.]+ ms", r"[0-9,]+ decisions/s",
                       r"scheduled in +[0-9.]+ ms")
# the kernels each run must launch: the decision kernels, flash_fwd (f32:
# the reduced models run in f32; in training storing its lse, counted as
# flash_fwd_lse, and its backward on the CUDA cores, flash_bwd) and the
# scans forward and backward
EXAMPLE_EXPECT = {
    "offload_simulation": ("decide_split", "gbt_hist", "tree_predict"),
    "contention_tails": ("decide_split",),
    "quickstart": ("gbt_hist", "tree_predict"),
    "oracle_serving": ("decide_split", "gbt_hist", "tree_predict"),
    "serve_batched": ("flash_fwd", "decide_split"),
    "train_tiny_lm": ("flash_fwd", "flash_fwd_lse", "flash_bwd"),
    f"train_tiny_lm --arch zamba2-1.2b --steps {EXAMPLE_TRAIN_STEPS}": (
        "ssm_scan", "ssm_scan_bwd"),
    f"train_tiny_lm --arch xlstm-350m --steps {EXAMPLE_TRAIN_STEPS}": (
        "slstm_scan", "slstm_scan_bwd"),
    "pod_scale_scheduling": ("gbt_hist", "tree_predict")}
# pod_scale_scheduling's dry-run records, written by DRYRUN_CHILDREN CPU
# processes of `python -m repro_torch.launch.dryrun` (meta tensors; the
# architectures dealt out among them), with xlstm-350m's shapes left out:
# its eager mLSTM chunk loop on meta tensors takes 70-110 s a shape
DRYRUN_SKIP = ("xlstm-350m",)
DRYRUN_CHILDREN = 3
# the bench phase (15): each repro_torch.bench module on the card, its CPU
# rows, its card's plain rows and its kernels' rows in one run, the
# smoke mode where the reference's script has one; the three figure
# benches on the card alone, the sweeps at these sub-grids (Fig. 2a's
# presets, Fig. 2b's (depth, subsample)): their CPU rows, a minute or more
# of host fits, run in the full runs by hand.  Cut to one point each to
# keep the script inside its time on a slow host: Fig. 2a's largest (the
# one its verdict reads), Fig. 2b's shallowest (fig3_predictions fits the
# (12, 0.8) ensemble on the same records)
BENCH_FIG2A = ("xl",)
BENCH_FIG2B = ((2, 0.5),)
# the kernels each bench's rows must launch between them
BENCH_EXPECT = {
    "decisions": ("decide_split",),
    "decisions_cost": ("decide_split", "tree_predict"),
    "decisions_backend": ("decide_split",),
    "oracle": ("decide_split", "gbt_hist", "tree_predict"),
    "stream": (), "fleet": ("fleet_scan",), "contention": ("decide_split",),
    "scheduler": (), "offload": ("decide_split", "gbt_hist", "tree_predict"),
    "fl": (), "serving": ("flash_attention", "slstm_scan"),
    "fig2a_mlp": (), "fig2b_gbt": ("gbt_hist", "tree_predict"),
    "fig3_predictions": ("gbt_hist", "tree_predict")}
# the gates the card breaks, each logged as an open fault in ROADMAP.md §3:
# phase 15 prints each one's numbers (the ``gate_broken`` line) where it
# would stop; any other gate that fails stops it.  None is open: the fleet
# engine's tracing overhead holds its 10% gate
BENCH_BROKEN: dict = {}
# the collate phase (16): the §Perf experiments run on meta tensors in CPU
# children started with phase 14's, one a group of pairs (pair B,
# xlstm-350m's train_4k, takes 40-52 s an experiment on one host thread,
# its eager mLSTM chunk loop; A and C 1-11 s); phase 16 waits at most
# PERF_WAIT seconds for them
PERF_PAIRS = ("A,C", "B")
PERF_WAIT = 420
# A1's compute term over A0's in the port's records must stay below this
# (the reference's journey invariant, tests/test_results_invariants.py)
ABSORB_MAX = 0.2
# the sections of the port's EXPERIMENTS document, and the reference's
# TPU figures, none of which it may state
EXPERIMENTS_HEADINGS = ("## §Paper-validation", "## §Dry-run",
                        "### Single pod", "## §Roofline", "## §Perf")
TPU_FIGURES = ("197 TFLOP/s", "819 GB/s", "v5e", "16G")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok, msg: str) -> None:
    if not ok:
        fail(msg)


def line(tag: str, **kv) -> None:
    print(json.dumps({tag: kv}), flush=True)


def inflight_a_writes(body: str) -> int:
    """Instructions of one kernel's SASS, read in program order, that write
    a register which a ``wgmma`` taking A from registers (HGMMA ... R<a>)
    still reads: the group is retired only by a ``WARPGROUP.DEPBAR.LE``
    that leaves fewer groups pending.  ptxas frees those registers at
    issue, so a kernel must keep them in use until the wait (0 expected;
    the order is the listing's, so a write reached round a loop's back
    edge is not seen)."""
    pending, group, hits = [], [], 0
    for ins in re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*);", body):
        if ins.startswith("HGMMA"):
            a = re.search(r"HGMMA\S*\s+R\d+,\s+R(\d+)", ins)
            if a:                              # A from registers
                group += range(int(a.group(1)), int(a.group(1)) + 4)
            if "gsb0" in ins:
                pending.append(set(group))
                group = []
        elif ins.startswith("WARPGROUP.DEPBAR.LE"):
            del pending[:max(0, len(pending) - int(ins.split(",")[-1], 16))]
        else:
            w = re.match(r"(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s+R(\d+)", ins)
            if w and not w.group(2).startswith(
                    ("ST", "RED", "ATOM", "BRA", "SYNCS", "ISETP", "FSETP")):
                hits += any(int(w.group(3)) in g for g in pending)
    return hits


def hopper_sass(build, source: str, entry: str, instances: int) -> dict:
    """Counts of the Hopper instructions in each instance of kernel
    ``entry``'s SASS in the library of ``source`` (``cuobjdump
    --dump-sass``): a tensor-core kernel must run warpgroup MMAs (HGMMA)
    fed by TMA loads (UTMALDG).  Each instance also reports its writes to
    the A registers of an in-flight wgmma (``inflight_a_writes``)."""
    counts, bodies, cur = {}, {}, None
    for ln in build.sass(source).splitlines():
        if "Function : " in ln:
            cur = ln.split("Function : ")[1].strip()
            if entry in cur:
                counts[cur] = dict.fromkeys(("HGMMA", "UTMALDG", "UTMASTG"), 0)
                bodies[cur] = []
            else:
                cur = None
        elif cur:
            bodies[cur].append(ln)
            for op in ("HGMMA", "UTMALDG", "UTMASTG"):
                counts[cur][op] += op in ln
    check(len(counts) == instances, f"{entry}: {len(counts)} instances in "
          f"the SASS, expected {instances}")
    for fn, c in counts.items():
        check(c["HGMMA"] > 0 and c["UTMALDG"] > 0,
              f"{fn}: no HGMMA or no UTMALDG in its SASS ({c})")
        c["inflight_a_writes"] = inflight_a_writes("\n".join(bodies[fn]))
    return counts


def serve_slice(dev, smi: str) -> dict:
    """The serving path at full width: ``ServeEngine`` on each model in
    bf16.  Returns the serving kernels' launch counts of this run, and
    TRACE_ARCH's tokens and host seconds for phase 12."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.serve import ServeEngine

    wrappers = {"flash_attention": fa_kernel.flash_attention_kernel,
                "ssm_scan": ss_kernel.ssd_scan_kernel,
                "slstm_scan": sl_kernel.slstm_scan_kernel}
    expected = dict.fromkeys(wrappers, 0)
    # bf16 at every served (D, Dv) on the tensor cores: 64, 96, 128, MLA's
    # 192 with v at 128, gemma's 256
    flash_expected = dict.fromkeys(fa_kernel.KERNELS, 0)
    n_batches = -(-SERVE_REQUESTS // SERVE_BATCH)
    fa_kernel.reset_counts()
    ss_kernel.reset_counts()
    sl_kernel.reset_counts()
    untraced = {}                   # phase 12 serves TRACE_ARCH again
    for arch in SERVE_ARCHS:
        cfg = get_config(arch)
        prompt = PROMPT_OF.get(arch, SERVE_PROMPT)
        check(cfg.dtype == "bfloat16", f"{arch}: dtype {cfg.dtype}")
        if cfg.family == "hybrid":
            n_flash = n_batches * -(-cfg.num_layers // cfg.shared_attn_every)
            expected["ssm_scan"] += n_batches * cfg.num_layers
        elif cfg.family == "ssm":     # one sLSTM block a group, no attention
            n_flash = 0
            expected["slstm_scan"] += (n_batches * cfg.num_layers
                                       // cfg.slstm_every)
        elif cfg.family == "audio":   # encoder self; decoder self and cross
            n_flash = n_batches * (cfg.enc_layers + 2 * cfg.num_layers)
        else:
            n_flash = n_batches * cfg.num_layers
        expected["flash_attention"] += n_flash
        dims = ((cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
                if cfg.attn_kind == "mla" else (cfg.head_dim,) * 2)
        flash_expected["flash_fwd_wgmma" if dims in fa_kernel.BLOCK_Q
                       else "flash_fwd"] += n_flash
        before = {k: w.launches for k, w in wrappers.items()}
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, batch_size=SERVE_BATCH,
                          max_len=prompt + SERVE_NEW + 8, seed=SEED,
                          device=dev)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        finite, sample = [], eng._sample

        def checked(logits, temperature, gen, sample=sample, finite=finite):
            finite.append(torch.isfinite(logits).all())
            return sample(logits, temperature, gen)

        eng._sample = checked
        t0 = time.perf_counter()
        done = eng.serve(serve_requests(cfg, prompt))
        serve_s = time.perf_counter() - t0
        if arch == TRACE_ARCH:
            untraced = dict(tokens={r.rid: r.output.tolist() for r in done},
                            init_s=init_s, serve_s=serve_s)
        check(sorted(r.rid for r in done) == list(range(SERVE_REQUESTS)),
              f"{arch}: not every request was answered")
        for r in done:
            check(r.output is not None and r.output.shape == (SERVE_NEW,)
                  and bool(((r.output >= 0)
                            & (r.output < cfg.vocab_size)).all()),
                  f"{arch}: request {r.rid} did not get {SERVE_NEW} "
                  "in-range tokens")
        check(bool(torch.stack(finite).all()), f"{arch}: a non-finite logit")
        st = eng.stats
        line("serve", model=arch, dtype=cfg.dtype, layers=cfg.num_layers,
             d_model=cfg.d_model, batch=SERVE_BATCH,
             requests=SERVE_REQUESTS, prompt_tokens=prompt,
             encoder_frames=cfg.enc_seq if cfg.family == "audio" else None,
             new_tokens=SERVE_NEW, init_s=init_s, serve_s=serve_s,
             prefill_s=st.prefill_s, decode_s=st.decode_s,
             decode_tokens_per_s=st.tokens_per_s,
             first_token_s_per_batch=[r.first_token_s for r in
                                      done[::SERVE_BATCH]],
             max_memory_allocated_bytes=torch.cuda.max_memory_allocated(dev),
             launches={k: w.launches - before[k]
                       for k, w in wrappers.items()}, device=smi)
        del eng, finite
        torch.cuda.empty_cache()
    launches = {k: w.launches for k, w in wrappers.items()}
    by_kernel = dict(fa_kernel.flash_attention_kernel.by_kernel)
    ssm_by_kernel = dict(ss_kernel.ssd_scan_kernel.by_kernel)
    slstm_by_route = dict(sl_kernel.slstm_scan_kernel.by_route)
    print(json.dumps({"serve_launch_counts": launches,
                      "flash_by_kernel": by_kernel,
                      "ssm_by_kernel": ssm_by_kernel,
                      "slstm_by_route": slstm_by_route,
                      "expected": expected,
                      "flash_by_kernel_expected": flash_expected}),
          flush=True)
    # every sLSTM prefill (B 4, du 256) on the cluster route
    check(slstm_by_route == {"cluster": expected["slstm_scan"],
                             "block": 0},
          f"slstm_scan: {slstm_by_route} on the serving path, expected "
          f"all {expected['slstm_scan']} on the cluster route")
    # every scan call: C·Bᵀ once, then the chunks
    check(ssm_by_kernel == dict.fromkeys(ss_kernel.KERNELS,
                                         expected["ssm_scan"]),
          f"ssm_scan launches per kernel {ssm_by_kernel}, expected "
          f"{expected['ssm_scan']} each")
    for k, n in launches.items():
        check(n == expected[k], f"kernel {k} launched {n} times on the "
              f"serving path, expected {expected[k]}")
    # every bf16 prefill takes the tensor-core kernel
    check(by_kernel == flash_expected
          and flash_expected["flash_fwd"] == 0,
          f"flash_attention: {by_kernel} on the serving path, expected "
          f"{flash_expected}")
    return dict(launches, ssm_scan_by_kernel=ssm_by_kernel,
                slstm_scan_by_route=slstm_by_route, untraced=untraced)


def serve_requests(cfg, prompt: int) -> list:
    """Phase 6's requests: SERVE_REQUESTS greedy prompts of ``prompt``
    tokens drawn from seed 0, 1 ms apart."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, size=prompt, dtype=np.int32),
                    max_new_tokens=SERVE_NEW, temperature=0.0,
                    arrived_at=i * 1e-3)
            for i in range(SERVE_REQUESTS)]


def continuous_requests(cfg) -> tuple:
    """Phase 6b's requests: prompt lengths, the requests (CONT_GAP_S
    apart) and the link observed at each admission (100 kB/s to 3 GB/s,
    log-uniform), all from SEED."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED)
    lens = rng.integers(CONT_PROMPT[0], CONT_PROMPT[1] + 1,
                        size=SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in lens]
    bws = 10.0 ** rng.uniform(5.0, 9.5, size=SERVE_REQUESTS)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW,
                    arrived_at=i * CONT_GAP_S)
            for i, p in enumerate(prompts)]
    return lens, reqs, bws


class LifecycleRecorder:
    """The engine's duck-typed ``obs`` seam: keeps each request's
    virtual-clock (arrived, admitted, finished) and the admit and replan
    instants."""
    enabled = True

    def __init__(self):
        self.spans, self.instants = {}, []

    def instant(self, track, name, ts, *, tid=0, args=None):
        self.instants.append((name, tid, ts))

    def task_spans(self, track, tid, name, arrived_s, started_s,
                   finished_s, **kw):
        self.spans[tid] = (arrived_s, started_s, finished_s)


def continuous_slice(dev, smi: str) -> dict:
    """Continuous batching at full width and depth in bf16 (phase 6b):
    ``ContinuousBatchEngine`` on deepseek-moe-16b, re-planning each
    admitted request's split with the ``decide_split`` kernel.  Returns
    the phase's launch counts, its per-admission times, and the
    ``decide_split`` row of its last admission's E = 1 sweep (timed after
    the counts are read), and the tokens and host seconds phase 12
    compares its traced run with."""
    import dataclasses as dc

    import torch
    from repro_torch.bench.kernels import decide_split_row
    from repro_torch.configs import get_config
    from repro_torch.core.costs import AnalyticCost, lower_to_accel
    from repro_torch.core.decisions import decide_all, make_envs
    from repro_torch.core.offload import transformer_layer_costs
    from repro_torch.hw import get_device
    from repro_torch.kernels.decide_split import kernel as ds_kernel
    from repro_torch.kernels.decide_split import ops as ds_ops
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.serve import ContinuousBatchEngine

    cfg = get_config(CONT_ARCH)
    check(cfg.dtype == "bfloat16" and cfg.num_layers == 28
          and cfg.d_model == 2048 and cfg.num_experts == 64,
          f"{CONT_ARCH} is not at its published shape")
    lens, reqs, bws = continuous_requests(cfg)
    link = iter(bws.tolist())
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    recorder = LifecycleRecorder()
    eng = ContinuousBatchEngine(
        cfg, slots=SERVE_BATCH, max_len=SERVE_PROMPT + SERVE_NEW + 8,
        seed=SEED, cost=AnalyticCost(), link_bw=lambda: next(link),
        decision_backend="kernel", obs=recorder, device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    times = {"prefill": [], "replan": [], "decode": []}
    finite = []

    def timed(fn, key, logits_at=None):
        def wrapped(*args):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize(dev)
            times[key].append(time.perf_counter() - t)
            if logits_at is not None:
                finite.append(torch.isfinite(out[logits_at]).all())
            return out
        return wrapped

    eng._prefill = timed(eng._prefill, "prefill", 0)
    eng._plan_offload = timed(eng._plan_offload, "replan")
    eng.api = dc.replace(eng.api, decode_step=timed(
        eng.api.decode_step, "decode", 0))
    fa_kernel.reset_counts()
    ds_kernel.decide_split_kernel.launches = 0
    t0 = time.perf_counter()
    done = eng.serve(reqs)
    serve_s = time.perf_counter() - t0
    launches = {"flash_attention": fa_kernel.flash_attention_kernel.launches,
                "decide_split": ds_kernel.decide_split_kernel.launches}
    by_kernel = dict(fa_kernel.flash_attention_kernel.by_kernel)
    peak = torch.cuda.max_memory_allocated(dev)

    check(sorted(r.rid for r in done) == list(range(SERVE_REQUESTS)),
          f"{CONT_ARCH}: not every request was answered")
    for r in done:
        check(r.output is not None and r.output.shape == (SERVE_NEW,)
              and bool(((r.output >= 0)
                        & (r.output < cfg.vocab_size)).all()),
              f"{CONT_ARCH}: request {r.rid} did not get {SERVE_NEW} "
              "in-range tokens")
        check(r.admitted_at >= r.arrived_at,
              f"request {r.rid} admitted at {r.admitted_at} before its "
              f"arrival at {r.arrived_at}")
    check(bool(torch.stack(finite).all()), f"{CONT_ARCH}: a non-finite logit")
    check(eng.occupancy > 1.0, f"occupancy {eng.occupancy}: the slots were "
          "not shared")
    check(eng.replans == SERVE_REQUESTS,
          f"{eng.replans} re-plans for {SERVE_REQUESTS} admissions")
    # each admission's split near-optimal against the exact f64 sweep on
    # the same environment
    jetson, a100 = get_device("jetson-orin-nano"), get_device(
        "edge-server-a100")
    gaps, splits = [], []
    for r in sorted(done, key=lambda r: r.rid):
        seq = len(r.prompt)
        envs = make_envs(jetson, a100, link_bw=[bws[r.rid]],
                         input_bytes=4.0 * seq, device=dev)
        layers = transformer_layer_costs(cfg, seq, 1)
        exact = decide_all(layers, envs, cost=AnalyticCost(),
                           backend="torch", device=dev)[0]
        got, ref = r.offload.total_time_s, exact.total_time_s
        check(got <= ref * (1 + 1e-4) + 1e-12, f"request {r.rid}: kernel "
              f"split {r.offload.split} costs {got}, the f64 optimum "
              f"(split {exact.split}) {ref}")
        gaps.append((got - ref) / ref)
        splits.append((r.offload.split, exact.split))
    want = {"flash_attention": SERVE_REQUESTS * cfg.num_layers,
            "decide_split": SERVE_REQUESTS}
    print(json.dumps({"continuous_launch_counts": launches,
                      "flash_by_kernel": by_kernel, "expected": want}),
          flush=True)
    for k, n in launches.items():
        check(n == want[k], f"kernel {k} launched {n} times in continuous "
              f"serving, expected {want[k]}")
    check(by_kernel["flash_fwd_wgmma"] == want["flash_attention"],
          f"flash_attention: {by_kernel} in continuous serving, expected "
          f"all {want['flash_attention']} launches on flash_fwd_wgmma")
    check(sorted(recorder.spans) == list(range(SERVE_REQUESTS))
          and [n for n, _, _ in recorder.instants].count("replan")
          == SERVE_REQUESTS, "the obs seam missed a request's lifecycle")
    decode_s = sum(times["decode"])
    line("continuous", model=CONT_ARCH, dtype=cfg.dtype,
         layers=cfg.num_layers, d_model=cfg.d_model, slots=SERVE_BATCH,
         requests=SERVE_REQUESTS, prompt_tokens=lens.tolist(),
         new_tokens=SERVE_NEW, init_s=init_s, serve_s=serve_s,
         prefill_s_per_admission=times["prefill"],
         replan_s_per_admission=times["replan"],
         decode_steps=eng.steps, decode_s=decode_s,
         decode_steps_per_s=eng.steps / decode_s,
         decode_tokens_per_s=eng.tokens_out / decode_s,
         occupancy=eng.occupancy, replans=eng.replans,
         splits_kernel_vs_f64=splits, max_rel_gap=max(gaps),
         link_bw=bws.tolist(),
         sojourn_s={rid: f - a for rid, (a, _, f) in recorder.spans.items()},
         queue_wait_s={rid: s - a
                       for rid, (a, s, _) in recorder.spans.items()},
         max_memory_allocated_bytes=peak, launches=launches, device=smi)
    tokens = {r.rid: r.output.tolist() for r in done}
    del eng, done, finite
    torch.cuda.empty_cache()
    # the last admission's sweep as the engine packs it, timed beside its
    # plain version
    row = decide_split_row(dev, "continuous_admission", ds_ops.pack_inputs(
        layers, envs, lower_to_accel(AnalyticCost())).kernel_args)
    check(row["err_over_tol"] < 1.0, "decide_split continuous_admission: "
          f"off by {row['err_over_tol']} of its tolerance")
    line("timing_extra", **row)
    return dict(launches, prefill_s=times["prefill"],
                replan_s=times["replan"], decide_split_row=row,
                untraced=dict(tokens=tokens, init_s=init_s,
                              serve_s=serve_s))


def continuous_f32_check(dev) -> None:
    """The continuous engine's greedy tokens equal ``ServeEngine(
    batch_size=1)``'s on the same weights: deepseek-moe-16b at full width
    in f32, its depth cut to 4 layers (28 f32 layers are ~68 GB)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serve import ContinuousBatchEngine, Request, ServeEngine

    cfg = get_config(CONT_ARCH).replace(num_layers=CHECK_LAYERS,
                                        dtype="float32")
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in rng.integers(256, 1025, size=4)]
    gaps = {}                       # (rid, step) -> static top-2 gap

    def top2(logits):
        t = torch.topk(logits.float(), 2, dim=-1).values
        return ((t[..., 0] - t[..., 1]) / logits.abs().max()).tolist()

    t0 = time.perf_counter()
    eng = ContinuousBatchEngine(cfg, slots=4, max_len=1100, seed=SEED,
                                device=dev)
    done = eng.serve([Request(rid=i, prompt=p, max_new_tokens=8,
                              arrived_at=i * 0.01)
                      for i, p in enumerate(prompts)])
    static = ServeEngine(cfg, batch_size=1, max_len=1100, device=dev)
    static.load_params(eng.params)
    del eng
    sample = static._sample
    for r in sorted(done, key=lambda r: r.rid):
        step = iter(range(9))

        def recording(logits, temperature, gen, rid=r.rid, step=step):
            gaps[rid, next(step)] = top2(logits[0])
            return sample(logits, temperature, gen)

        static._sample = recording
        want = static.generate_batch(r.prompt[None], 8)[0]
        if not np.array_equal(r.output, want):
            bad = int(np.flatnonzero(r.output != want)[0])
            fail(f"continuous f32 check: request {r.rid} differs from "
                 f"ServeEngine(batch_size=1) at step {bad} ({r.output} vs "
                 f"{want}); the static top-2 logit gap there "
                 f"{gaps[r.rid, bad]} of max|logit|")
    line("continuous_check", model=CONT_ARCH, dtype="float32",
         reduced=f"num_layers {get_config(CONT_ARCH).num_layers}→"
         f"{CHECK_LAYERS}", d_model=cfg.d_model, requests=len(done),
         new_tokens=8, prompt_tokens=[len(p) for p in prompts],
         tokens_equal=True, min_top2_gap=min(gaps.values()),
         seconds=time.perf_counter() - t0)
    del static
    torch.cuda.empty_cache()


def profiling_slice(dev, wrappers: dict, recorder, x_layers, y_layers,
                    layers, envs, pi5, a100) -> dict:
    """The paper's offline loop at full width on the card: profile the
    Table-I grid, fit the fig3 predictors on the profiling dataset, then
    decide with ridge and an MLP fitted on phase 2's per-layer rows.
    Returns the three decision kernels' launch counts of this phase and
    the profiling records and dataset (phase 11's FedAvg trains on the
    dataset, phase 15's benches read both)."""
    import collections

    import numpy as np
    import torch
    from repro_torch.bench import fig3_predictions as fig3
    from repro_torch.bench.mlp_spread import one_step_drift, two_epoch_drift
    from repro_torch.core import costs as co
    from repro_torch.core import dataset as ds
    from repro_torch.core import decisions as dec
    from repro_torch.core.predictors import (MLPRegressor, MultiTargetGBT,
                                             RidgeRegressor,
                                             per_target_nrmse)
    from repro_torch.core.workloads import WorkloadConfig
    from repro_torch.kernels.gbt_hist import ops as gh_ops
    from repro_torch.kernels.tree_predict import kernel as tp_kernel
    from repro_torch.kernels.tree_predict import ref as tp_ref
    from repro_torch.oracle.lowered import lower_predictor

    def synced():
        torch.cuda.synchronize(dev)
        return time.perf_counter()

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    for w in wrappers.values():
        w.launches = 0
    tp_kernel.reset_counts()

    # -- profile: the reference benchmark's grid, each run timed
    run_s, profile = [], ds.profile_workload

    def timed_run(*args, **kw):
        t0 = synced()
        rec = profile(*args, **kw)
        run_s.append(synced() - t0)
        return rec

    ds.profile_workload = timed_run
    t0 = synced()
    records, data = ds.generate(n_runs=PROFILE_RUNS, max_steps=PROFILE_STEPS,
                                seed=SEED, device=dev)
    profile_s = synced() - t0
    ds.profile_workload = profile
    measured = [r for r in records if "@" not in r.label]
    check(len(measured) == PROFILE_RUNS and len(records) == 5 * PROFILE_RUNS,
          f"{len(measured)} measured and {len(records)} records, expected "
          f"{PROFILE_RUNS} and {5 * PROFILE_RUNS}")
    check(all(np.isfinite(v) and v > 0 for r in records
              for v in r.targets(extended=True).values()),
          "a profiling target is not finite and positive")
    # one config of each network again on the CPU: FlopCounterMode counts
    # by formula, so the card's FLOPs and parameters are the CPU's
    firsts = {}
    for r in measured:
        firsts.setdefault((r.kind, r.config["type_idx"]), r)
    check(len(firsts) == 6, f"the grid sample covers {sorted(firsts)}")
    for (kind, ti), r in sorted(firsts.items()):
        host = ds.profile_workload(WorkloadConfig(**r.config), max_steps=1,
                                   seed=SEED, device="cpu")
        check((host.flops_per_step, host.param_count)
              == (r.flops_per_step, r.param_count),
              f"{kind}{ti}: card FLOPs/params {r.flops_per_step}/"
              f"{r.param_count}, CPU {host.flops_per_step}/"
              f"{host.param_count}")
    check((torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32) == tf32,
          f"the TF32 flags were not restored ({tf32} before)")
    line("profile", runs=len(measured), records=len(records),
         max_steps=PROFILE_STEPS, profile_s=profile_s,
         median_run_s=float(np.median(run_s)), max_run_s=max(run_s),
         by_kind=collections.Counter(r.kind for r in measured),
         by_optimiser=collections.Counter(r.config["optimiser"]
                                          for r in measured),
         median_step_s={k: float(np.median([r.step_time_s for r in measured
                                             if r.kind == k]))
                        for k in ("cnn", "mlp")},
         max_peak_bytes=max(r.peak_bytes for r in measured),
         flops_params_equal_cpu=sorted(f"{k}{t}" for k, t in firsts),
         tf32_restored=True)

    # -- fit the fig3 predictors (bench.fig3_predictions') on the
    # normalised 80/20 split
    norm, _ = data.normalised()
    tr, te = norm.split(0.8)
    gbt_kw = fig3.GBT_KW
    hist_before = wrappers["gbt_hist"].launches
    launch_level, gh_ops.level_histogram_kernel = \
        gh_ops.level_histogram_kernel, recorder("profiling_")
    t0 = synced()
    gbt = MultiTargetGBT(**gbt_kw).fit(tr.x, tr.y, device=dev)
    gbt_fit_s = synced() - t0
    gh_ops.level_histogram_kernel = launch_level
    hist_launches = wrappers["gbt_hist"].launches - hist_before
    t0 = time.perf_counter()
    gbt_cpu = MultiTargetGBT(**gbt_kw).fit(tr.x, tr.y, device="cpu")
    gbt_cpu_fit_s = time.perf_counter() - t0
    fields = ("feature", "threshold_bin", "left", "right", "value",
              "n_nodes", "edges")
    equal = all(np.array_equal(getattr(fa, f), getattr(fb, f))
                for a, b in zip(gbt.models_, gbt_cpu.models_)
                for fa, fb in [(tp_ref.flatten_gbt(a), tp_ref.flatten_gbt(b))]
                for f in fields)
    n_trees = sum(len(m.trees_) for m in gbt.models_)
    check(equal and n_trees == 3 * gbt_kw["n_trees"],
          "the card's profiling-dataset GBT fit differs from the CPU fit's "
          "node arrays")
    low = lower_predictor(gbt)
    pred_gbt = low.predict(te.x, device=dev)
    check(torch.equal(pred_gbt.cpu(), low.predict(te.x, device="cpu")),
          "the lowered GBT's card predictions differ from the plain "
          "version's (tolerance: exact)")
    nrmse = {"gbt": per_target_nrmse(pred_gbt.cpu().numpy(), te.y)}
    fit_s = {"gbt": gbt_fit_s}
    t0 = synced()
    mlp = MLPRegressor(**fig3.MLP_KW).fit(tr.x, tr.y, device=dev)
    fit_s["mlp"] = synced() - t0
    t0 = synced()
    ridge = RidgeRegressor().fit(tr.x, tr.y, device=dev)
    fit_s["ridge"] = synced() - t0
    for name, m in (("mlp", mlp), ("ridge", ridge)):
        nrmse[name] = per_target_nrmse(m.predict(te.x, device=dev).cpu()
                                       .numpy(), te.y)
    check(all(np.isfinite(v).all() for v in nrmse.values()),
          f"a non-finite nRMSE ({nrmse})")
    # one step and two epochs from the same initial weights on both devices
    step_err = one_step_drift(tr.x, tr.y, device=dev)
    check(step_err <= MLP_STEP_TOL, f"one MLP step: card and CPU parameter "
          f"displacements differ by {step_err} (median over median; "
          f"tolerance {MLP_STEP_TOL})")
    mlp_err = two_epoch_drift(tr.x, tr.y, te.x, device=dev)
    check(mlp_err <= MLP_CARD_TOL, f"two-epoch MLP: card and CPU predictions "
          f"differ by {mlp_err} of their scale (tolerance {MLP_CARD_TOL})")
    line("fig3", rows_train=len(tr.x), rows_test=len(te.x),
         features=int(tr.x.shape[1]), targets=te.target_names,
         nrmse={k: v.tolist() for k, v in nrmse.items()},
         nrmse_mean={k: float(v.mean()) for k, v in nrmse.items()},
         gbt_vs_mlp_ratio=float(nrmse["mlp"].mean() / nrmse["gbt"].mean()),
         fit_s=fit_s, gbt_cpu_fit_s=gbt_cpu_fit_s,
         gbt_hist_launches=hist_launches, trees_equal_cpu=n_trees,
         mlp_params=mlp.param_count(), mlp_one_step_card_vs_cpu=step_err,
         mlp_two_epoch_card_vs_cpu=mlp_err)

    # -- decide with ridge and an MLP fitted on phase 2's per-layer rows
    models = {"ridge": RidgeRegressor().fit(x_layers, y_layers, device=dev),
              "mlp": MLPRegressor(hidden=(256, 128), epochs=10).fit(
                  x_layers, y_layers, device=dev)}
    for name, model in models.items():
        cost = co.PredictorCost(model, pi5, a100)
        t0 = synced()
        plan = dec.decide_all(layers, envs, cost=cost)
        decide_s = synced() - t0
        exact = dec.decide_all(layers, envs, cost=cost, backend="torch")
        check(bool(torch.isfinite(plan.total_time_s).all()),
              f"{name}: non-finite latency")
        gap = (plan.total_time_s - exact.total_time_s) / exact.total_time_s
        check(bool((plan.total_time_s <= exact.total_time_s * (1 + 1e-4)
                    + 1e-12).all()),
              f"{name}: a kernel split is worse than the f64 optimum by "
              f"more than 1e-4 (max {gap.max().item()})")
        line("plan_check", plan=f"{name}_predictor",
             predict_and_decide_s=decide_s,
             split_match_share=(plan.splits == exact.splits).double()
             .mean().item(), max_rel_gap=gap.max().item(),
             distinct_splits=int(torch.unique(plan.splits).numel()))
        del exact
    launches = {k: w.launches for k, w in wrappers.items()}
    print(json.dumps({"profiling_launch_counts": launches,
                      "tree_predict_by_kernel":
                      dict(tp_kernel.tree_predict_kernel.by_kernel)}),
          flush=True)
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the profiling path")
    return launches, (records, data)


def oracle_slice(dev, wrappers: dict, recorder, bw, pi5,
                 a100) -> tuple[dict, dict, dict]:
    """The online oracle riding the streaming simulator, at the reference's
    own scale (``examples/oracle_serving.py``, ``benchmarks/
    bench_stream.py``), on the card and again on the CPU in the same
    process.  Writes the ``oracle`` line; returns the three decision
    kernels' launch counts of this phase, the shapes the timing takes, and
    the streams, models and untraced card records phase 12 traces again.
    """
    import numpy as np
    import torch
    from repro_torch import sim
    from repro_torch.bench import stream as bench_stream
    from repro_torch.core import costs as co
    from repro_torch.core import decisions as dec
    from repro_torch.core import offload as off
    from repro_torch.core import scheduler as sch
    from repro_torch.core.predictors.gbt import GBTRegressor
    from repro_torch.hw import EDGE_DEVICES
    from repro_torch.kernels.gbt_hist import ops as gh_ops
    from repro_torch.kernels.tree_predict import kernel as tp_kernel
    from repro_torch.kernels.tree_predict import ref as tp_ref
    from repro_torch.oracle import OnlineOracle
    from repro_torch.sim import fleet

    specs = list(EDGE_DEVICES.values())

    def synced():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def same_trees(a, b) -> bool:
        fa, fb = tp_ref.flatten_gbt(a), tp_ref.flatten_gbt(b)
        return fa.base == fb.base and all(
            np.array_equal(getattr(fa, f), getattr(fb, f))
            for f in ("feature", "threshold_bin", "left", "right", "value",
                      "n_nodes", "edges"))

    for w in wrappers.values():
        w.launches = 0
    tp_kernel.reset_counts()
    out = {}
    t_phase = time.perf_counter()

    # -- (a) the profiling GBT of examples/oracle_serving.py:31-40 --------
    rng = np.random.default_rng(SEED)
    flops = rng.uniform(1e8, 1e11, 256)
    fit_layers = [off.LayerCost(f"l{i}", flops=float(f), act_bytes=0.0)
                  for i, f in enumerate(flops)]
    x = np.concatenate([co.default_layer_features(fit_layers, s)
                        for s in specs])
    y = np.concatenate([[off.layer_time(lc.flops, s) for lc in fit_layers]
                        for s in specs])
    gbt_kw = dict(n_trees=120, max_depth=8)
    t0 = synced()
    gbt = GBTRegressor(**gbt_kw).fit(x, y, device=dev)
    out["fit_s"] = synced() - t0
    t0 = time.perf_counter()
    gbt_host = GBTRegressor(**gbt_kw).fit(x, y, device="cpu")
    out["host_fit_s"] = time.perf_counter() - t0
    check(same_trees(gbt, gbt_host), "oracle (a): the card's profiling GBT "
          "differs from the CPU fit's node arrays")

    # -- (b) the oracle's sweep, identity and corrected -------------------
    layers = [off.LayerCost(f"l{i}", flops=float(rng.uniform(1e8, 1e9)),
                            act_bytes=float(rng.uniform(1e3, 1e5)))
              for i in range(48)]
    # phase 2's link states, the example's input size
    envs = dec.make_envs(pi5, a100, link_bw=bw, input_bytes=1e7, device=dev)
    sweeper = OnlineOracle(gbt, pi5, a100, refit_on_drift=False,
                           torch_device=dev)
    cost = sweeper.cost_model()
    sweeps = {}
    for case in ("identity", "gain"):
        if case == "gain":           # tests/test_oracle.py:346's loop
            feats = co.default_layer_features(fit_layers[:8], pi5)
            for i in range(120):
                f = feats[i % len(feats)]
                sweeper.observe(f, realised_s=2.0 * sweeper.predict_one(f)
                                / sweeper.gain)
            check(abs(sweeper.gain - 2.0) < 0.15,
                  f"oracle (b): the gain moved to {sweeper.gain}, not ~2")
        t0 = synced()
        plan = dec.decide_all(layers, envs, cost=cost, backend="kernel",
                              device=dev)
        decide_s = synced() - t0
        exact = dec.decide_all(layers, envs, cost=cost, backend="torch",
                               device=dev)
        gap = (plan.total_time_s - exact.total_time_s) / exact.total_time_s
        check(bool(torch.isfinite(plan.total_time_s).all()) and bool(
            (plan.total_time_s <= exact.total_time_s * (1 + 1e-4) + 1e-12)
            .all()), f"oracle (b) {case}: a kernel split is worse than the "
            f"f64 optimum by more than 1e-4 (max {gap.max().item()})")
        sweeps[case] = dict(
            gain=sweeper.gain, predict_and_decide_s=decide_s,
            split_match_share=(plan.splits == exact.splits).double()
            .mean().item(), max_rel_gap=gap.max().item(),
            distinct_splits=int(torch.unique(plan.splits).numel()))
        del plan, exact, gap
    del envs
    check(cost.accel_spec().lowered.correction == (sweeper.gain, 0.0),
          "oracle (b): the lowered sweep does not carry the gain")
    out["sweeps"] = sweeps

    # -- (c) examples/oracle_serving.py's step 3: drift -> refit ----------
    stream = []
    for step in range(700):
        spec = specs[int(rng.integers(len(specs)))]
        fl = float(rng.uniform(1e8, 1e11))
        t = off.layer_time(fl, spec)
        if step >= 200 and spec.tdp_watts in (12, 15):
            t *= 3.0                 # pi5 + jetson quietly slow down
        stream.append((co.default_layer_features(
            [off.LayerCost("q", flops=fl, act_bytes=0.0)], spec)[0], t))
    loops = []                       # the card's run, then the host's
    for d, model in ((dev, gbt), ("cpu", gbt_host)):
        o = OnlineOracle(model, pi5, a100, window=256, min_refit=120,
                         correction="none", torch_device=d)
        if d is dev:
            launch = gh_ops.level_histogram_kernel
            gh_ops.level_histogram_kernel = recorder("oracle_refit_")
        drifts, refits, track, observe_s, refit_s = [], [], [], [], []
        for step, (f, t) in enumerate(stream):
            t0 = time.perf_counter()
            res = o.observe(f, t)
            dt = time.perf_counter() - t0
            if res["refit_version"] is not None:
                refits.append((step, res["refit_version"]))
                refit_s.append(dt)
            else:
                observe_s.append(dt)
            if res["drift"]:
                drifts.append(step)
            track.append(o.rolling_nrmse())
        if d is dev:
            gh_ops.level_histogram_kernel = launch
        loops.append((o, drifts, refits, track, observe_s, refit_s))
    (o, drifts, refits, track, observe_s, refit_s), host_loop = loops
    peak, recovered = max(track[200:]), float(np.mean(track[-50:]))
    check(len(drifts) >= 1 and len(refits) >= 1,
          f"oracle (c): {len(drifts)} drifts and {len(refits)} refits")
    check(recovered < 0.5 * peak, f"oracle (c): nRMSE recovered to "
          f"{recovered}, not below half its peak {peak}")
    check((drifts, refits) == tuple(host_loop[1:3]),
          f"oracle (c): card drifts/refits {drifts}/{refits}, CPU "
          f"{host_loop[1]}/{host_loop[2]}")
    check(track == host_loop[3], "oracle (c): the card's rolling nRMSE "
          "track differs from the CPU's (tolerance: exact)")
    for _, v in refits:
        check(same_trees(o.registry.get(v).model,
                         host_loop[0].registry.get(v).model),
              f"oracle (c): refit v{v} on the card differs from the CPU's")
    out.update(drift_steps=drifts, refits=[v for _, v in refits],
               refit_steps=[s for s, _ in refits], refit_s=refit_s,
               host_refit_s=host_loop[5],
               observe_us=1e6 * float(np.mean(observe_s)),
               host_observe_us=1e6 * float(np.mean(host_loop[4])),
               nrmse_pre_drift=float(np.mean(track[150:200])),
               nrmse_peak=peak, nrmse_recovered=recovered,
               recovered_over_peak=recovered / peak)

    # -- (d) the static stream: bench.stream's largest cell ---------------
    # 300 tasks at rate 200/s on 32 nodes, seeded as bench_stream.py seeds
    tasks, arrivals, nodes = bench_stream.cell(200.0, 32, 300)

    def records(tel):
        return [(r.node_id, r.started_s, r.finished_s) for r in tel.records]

    streams, static = {}, []
    for d, model in ((dev, gbt), ("cpu", gbt_host)):
        t0 = synced()
        plain = sim.simulate_stream(
            tasks, arrivals, nodes,
            cost=co.PredictorCost(model, pi5, a100), device=d)
        plain_s = synced() - t0
        riding = OnlineOracle(model, pi5, a100, torch_device=d)
        t0 = synced()
        tel = sim.simulate_stream(tasks, arrivals, nodes, oracle=riding,
                                  device=d)
        oracle_s = synced() - t0
        check(records(plain) == records(tel) and len(tel) == 300,
              f"oracle (d) on {d}: the oracle's placements differ from the "
              "PredictorCost's")
        check(riding.refits == 0 and riding.gain == 1.0
              and riding.bias == 0.0, f"oracle (d) on {d}: {riding.refits} "
              f"refits, gain {riding.gain}")
        static.append(records(tel))
        if d is dev:
            oracle_records = [dataclasses.astuple(r) for r in tel.records]
            streams.update(static_predictor=dict(
                stream_s=plain_s, us_per_arrival=1e6 * plain_s / 300),
                static_oracle=dict(stream_s=oracle_s,
                                   us_per_arrival=1e6 * oracle_s / 300))
    check(static[0] == static[1], "oracle (d): the card's records differ "
          "from the CPU run's")

    # -- (e) examples/oracle_serving.py's step 4, second half -------------
    for _ in range(60):              # the first half's tasks, drawn as there
        rng.uniform(1e9, 5e11), rng.uniform(1e4, 1e6)
    rng.uniform(0.0, 12.0, 60)
    many = [sch.Task(f"d{i}", flops=float(rng.uniform(1e8, 1e11)),
                     input_bytes=0.0) for i in range(400)]
    arr = np.sort(rng.uniform(0.0, 400.0, len(many)))
    four = [sch.Node(specs[j % len(specs)]) for j in range(4)]

    def ground_truth(task, spec, etc_s, start_s):
        slow = 3.0 if start_s >= 130.0 and spec.tdp_watts in (12, 15) \
            else 1.0
        return slow * off.layer_time(task.flops, spec)

    drifted = []
    for d, model in ((dev, gbt), ("cpu", gbt_host)):
        learner = OnlineOracle(model, pi5, a100, window=256, min_refit=64,
                               correction="none", torch_device=d)
        t0 = synced()
        tel = sim.simulate_stream(many, arr, four, oracle=learner,
                                  service_time_fn=ground_truth, device=d)
        dt = synced() - t0
        s = tel.summary()
        check(learner.drift_triggers >= 1 and learner.refits >= 1,
              f"oracle (e) on {d}: {learner.drift_triggers} drifts, "
              f"{learner.refits} refits")
        drifted.append(([dataclasses.astuple(r) for r in tel.records], s))
        if d is dev:
            streams["drifted_oracle"] = dict(
                stream_s=dt, us_per_arrival=1e6 * dt / len(many),
                drift_triggers=learner.drift_triggers,
                refits=learner.refits, oracle_nrmse=s["oracle_nrmse"])
    check(drifted[0] == drifted[1], "oracle (e): the card's telemetry "
          "differs from the CPU run's")

    # -- (f) decide at admission over a drifting link ---------------------
    seen, decide = [], fleet._split_decide

    def recording(*args):
        plan = decide(*args)
        seen.append((args[1], plan))
        return plan

    env = sim.DriftingEnv(pi5, a100, sim.RandomWalkLink(1.25e8, sigma=1.5,
                                                        seed=SEED + 2),
                          torch_device=dev)
    before = wrappers["decide_split"].launches
    fleet._split_decide = recording
    t0 = synced()
    tel = sim.simulate_stream(tasks, arrivals, nodes,
                              cost=co.PredictorCost(gbt, pi5, a100),
                              split_env=env, split_layers=layers,
                              split_backend="kernel", link_update_dt=0.05,
                              device=dev)
    admit_s = synced() - t0
    fleet._split_decide = decide
    admit_records = [dataclasses.astuple(r) for r in tel.records]
    check(records(tel) == static[0], "oracle (f): deciding splits moved a "
          "placement")
    worst = 0.0
    for e, plan in seen:
        lat = dec.latency_matrix(layers, e)[0]
        best = lat.min()
        worst = max(worst, ((lat[int(plan.splits[0])] - best) / best).item())
    check(len(seen) == 300 and worst <= 1e-4, f"oracle (f): {len(seen)} "
          f"admissions, worst split {worst} over the f64 optimum (1e-4)")
    streams["decide_at_admission"] = dict(
        stream_s=admit_s, us_per_arrival=1e6 * admit_s / 300,
        decide_split_launches=wrappers["decide_split"].launches - before,
        distinct_splits=len({int(p.splits[0]) for _, p in seen}),
        max_rel_gap=worst)
    out["streams"] = streams

    launches = {k: w.launches for k, w in wrappers.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"oracle_launch_counts": launches,
                      "tree_predict_by_kernel":
                      dict(tp_kernel.tree_predict_kernel.by_kernel)}),
          flush=True)
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the oracle path")
    line("oracle", **out)
    shapes = {"gbt": gbt, "one_row": stream[0][0][None, :],
              "admission": np.concatenate([co.default_layer_features(
                  [off.LayerCost(tasks[0].name, flops=tasks[0].flops,
                                 act_bytes=0.0)], n.spec) for n in nodes]),
              "admission_envs": seen[0][0], "layers": layers}
    # what phase 12 traces again: (d)'s stream and its card run's records,
    # (f)'s decide-at-admission run
    traced = dict(gbt=gbt, gbt_host=gbt_host, tasks=tasks,
                  arrivals=arrivals, nodes=nodes, pi5=pi5, a100=a100,
                  layers=layers, oracle_records=oracle_records,
                  oracle_s=streams["static_oracle"]["stream_s"],
                  admit_records=admit_records, admit_s=admit_s,
                  admit_launches=streams["decide_at_admission"][
                      "decide_split_launches"])
    return launches, shapes, traced


def oracle_timing(dev, shapes: dict) -> dict:
    """The oracle path's new kernel shapes, timed with CUDA events after a
    warm-up beside the plain version and the bound: ``tree_predict`` on
    one observation's row and one admission's 32 rows (the path calls it
    eagerly), and ``decide_split`` on one admission's E = 1 sweep.  The
    first refit's root level of ``gbt_hist`` is timed with the fits' other
    levels."""
    import torch
    from repro_torch.bench.kernels import decide_split_row, tree_predict_row
    from repro_torch.core import costs as co
    from repro_torch.kernels.decide_split import ops as ds_ops
    from repro_torch.kernels.tree_predict import ref as tp_ref

    arrays = tp_ref.flatten_gbt(shapes["gbt"])
    trees = tp_ref.device_trees(arrays, dev)
    tkw = dict(max_depth=arrays.max_depth, base=arrays.base)
    rows = {}
    for case in ("one_row", "admission"):
        codes = tp_ref.bin_codes_ref(torch.as_tensor(shapes[case],
                                                     device=dev),
                                     trees.edges)
        row = tree_predict_row(dev, f"oracle_{case}", (
            (codes, trees.feature, trees.threshold_bin, trees.left,
             trees.right, trees.scaled_value), tkw))
        check(row["err_over_tol"] < 1.0, f"tree_predict oracle_{case}: off "
              "its plain version (tolerance: exact)")
        line("timing_extra", **row)
        rows[f"tree_predict_{case}"] = row
    args = ds_ops.pack_inputs(shapes["layers"], shapes["admission_envs"],
                              co.lower_to_accel(None)).kernel_args
    row = decide_split_row(dev, "oracle_admission", args)
    check(row["err_over_tol"] < 1.0, "decide_split oracle_admission: off "
          f"by {row['err_over_tol']} of its tolerance")
    line("timing_extra", **row)
    rows["decide_split_admission"] = row
    return rows


def fleet_slice(dev) -> tuple[dict, dict]:
    """The queueing, Pareto and fleet slice (phase 5) through
    ``simulate_stream`` and ``decide_all``, on the card and, where it says
    so, again on the CPU in the same process.  Returns the launches of
    ``fleet_scan`` and ``decide_split`` in this phase (counts set to 0 at
    its start), the shapes the timing takes, and writes the ``fleet``
    line."""
    import numpy as np
    import torch
    from repro_torch import sim
    from repro_torch.bench import contention as bench_contention
    from repro_torch.bench import stream as bench_stream
    from repro_torch.bench.fleet import fleet_day
    from repro_torch.core import costs as co
    from repro_torch.core import decisions as dec
    from repro_torch.core import offload as off
    from repro_torch.core.workloads import WorkloadConfig
    from repro_torch.hw import get_device
    from repro_torch.kernels.decide_split import kernel as ds_kernel
    from repro_torch.kernels.fleet_scan import kernel as fs_kernel
    from repro_torch.kernels.fleet_scan import ops as fs_ops
    from repro_torch.sim import fleet

    jetson, pi5, a100 = (get_device(n) for n in (
        "jetson-orin-nano", "pi5-arm", "edge-server-a100"))

    def synced():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def rows_of(tel):
        return ([dataclasses.astuple(r) for r in tel.records], tel.summary(),
                dict(tel.counters))

    def events(tel, n_nodes):
        # bench_fleet.py's count: finishes + arrival batches + link ticks
        return len(tel) + tel.counters.get("replans", 0) \
            + int(tel.counters.get("link_refreshes", 0) / max(n_nodes, 1))

    fs_kernel.reset_counts()
    ds_kernel.decide_split_kernel.launches = 0
    out, shapes = {}, {}
    t_phase = time.perf_counter()

    # -- (a) the fleet engine at bench.fleet's largest cell --------------
    tasks, arr, nodes, links = fleet_day(FLEET_TASKS, FLEET_NODES,
                                         FLEET_DAY_S)
    runs, real = {}, fs_ops.place_singletons
    for d in (dev, "cpu"):
        calls = []

        def recording(avail, *args):
            ins = (avail.cpu().clone(), *(a.cpu() for a in args))
            t0 = synced()
            res = real(avail, *args)
            call_s = synced() - t0
            calls.append((ins, tuple(r.cpu() for r in res),
                          avail.cpu().clone(), call_s))
            return res

        fs_ops.place_singletons = recording
        t0 = synced()
        tel = sim.simulate_stream(tasks, arr, nodes, policy="min_min",
                                  links=links(), link_update_dt=1.0,
                                  engine="fleet", device=d)
        wall = synced() - t0
        fs_ops.place_singletons = real
        runs[str(d)] = (rows_of(tel), calls, wall, events(tel, FLEET_NODES))
    (card, calls, wall, n_ev), (cpu, host_calls, host_wall, _) = \
        runs[str(dev)], runs["cpu"]
    check(len(card[0]) == FLEET_TASKS, f"fleet (a): {len(card[0])} records "
          f"of {FLEET_TASKS} tasks")
    check(card == cpu, "fleet (a): the card's records, summary or counters "
          "differ from the CPU run's (tolerance: exact)")
    check(len(calls) >= 1 and len(calls) == len(host_calls),
          f"fleet (a): {len(calls)} singleton runs on the card, "
          f"{len(host_calls)} on the CPU")
    # 256 nodes: every singleton run on the registers route
    scan_by_route = dict(fs_kernel.place_singletons_kernel.by_route)
    check(scan_by_route == {"registers": len(calls), "shared": 0},
          f"fleet (a): fleet_scan launches per route {scan_by_route}, "
          f"expected all {len(calls)} on the registers route")
    # each run's inputs equal on both devices, and the kernel's outputs
    # and final avail equal to the plain version's on them: bit for bit
    for (ins, res, av, _), (h_ins, h_res, h_av, _) in zip(calls,
                                                           host_calls):
        check(all(torch.equal(a, b) for a, b in zip(ins, h_ins))
              and all(torch.equal(a, b) for a, b in zip(res, h_res))
              and torch.equal(av, h_av), "fleet (a): fleet_scan differs "
              "from its plain version on the CPU run's inputs (exact)")
    steps = sum(int(c[0][3].numel()) for c in calls)
    longest = max(range(len(calls)), key=lambda k: calls[k][0][3].numel())
    shapes["scan"] = calls[longest][0]
    shapes["scan_plain_cpu_ms"] = 1e3 * host_calls[longest][3]
    out["fleet"] = dict(
        tasks=FLEET_TASKS, nodes=FLEET_NODES, horizon_s=FLEET_DAY_S,
        events=n_ev, card_s=wall, cpu_s=host_wall,
        card_events_per_s=n_ev / wall, cpu_events_per_s=n_ev / host_wall,
        fleet_scan_launches=fs_kernel.place_singletons_kernel.launches,
        fleet_scan_by_route=scan_by_route,
        fleet_scan_steps=steps, singleton_runs=len(calls),
        # the launch as the engine made it, host clock to a synchronise
        fleet_scan_us_per_step=1e6 * sum(c[3] for c in calls) / steps,
        plain_cpu_us_per_step=1e6 * sum(c[3] for c in host_calls) / steps,
        makespan_s=card[1]["makespan_s"])
    del runs, calls, host_calls, card, cpu

    # -- (b) event loop against fleet engine on the card ------------------
    day = fleet_day(COMPARE_TASKS, COMPARE_NODES, FLEET_DAY_S)
    planner_day = fleet_day(PLANNER_TASKS, COMPARE_NODES, FLEET_DAY_S)
    layers = off.workload_layer_costs(WorkloadConfig(
        "cnn", 2, epochs=5, optimiser="adam", lr=1e-3, batch_size=32))

    def split_env(device=jetson):
        return sim.DriftingEnv(device, a100, sim.DiurnalLink(
            4e7, amplitude=0.5, period_s=FLEET_DAY_S / 2, noise_sigma=0.1,
            seed=1), input_bytes=2e6, torch_device=dev)

    # the jetson runs this CNN locally at every bandwidth; from the pi5 the
    # split moves with the link and the task's input (0, 1 or all 4 local)
    modes = {"none": lambda: {},
             "decide": lambda: dict(split_env=split_env(),
                                    split_layers=layers,
                                    split_backend="kernel"),
             "decide_pi5": lambda: dict(split_env=split_env(pi5),
                                        split_layers=layers,
                                        split_backend="kernel"),
             "planner": lambda: dict(
                 split_env=split_env(pi5), split_layers=layers,
                 split_planner=sim.ParetoStreamScheduler(
                     device=pi5, torch_device=dev))}
    compare, seen = {}, {}
    decide = fleet._split_decide
    for mode, kw in modes.items():
        got = {}
        tasks, arr, nodes, links = planner_day if mode == "planner" else day
        for engine in ("event", "fleet"):
            def recording(lay, envs, cost, backend, key=(mode, engine)):
                plan = decide(lay, envs, cost, backend)
                seen.setdefault(key, []).append((envs, plan.splits))
                return plan

            fleet._split_decide = recording
            before = ds_kernel.decide_split_kernel.launches
            t0 = synced()
            tel = sim.simulate_stream(tasks, arr, nodes, policy="min_min",
                                      links=links(), link_update_dt=1.0,
                                      engine=engine, device=dev, **kw())
            wall = synced() - t0
            fleet._split_decide = decide
            got[engine] = rows_of(tel)
            compare[f"{mode}_{engine}"] = dict(
                stream_s=wall, events_per_s=events(tel, COMPARE_NODES) / wall,
                decide_split_launches=ds_kernel.decide_split_kernel.launches
                - before)
        check(got["event"] == got["fleet"], f"fleet (b) {mode}: the event "
              "loop's and the fleet engine's records, summary or counters "
              "differ on the card (tolerance: exact)")
        if mode.startswith("decide"):
            compare[f"{mode}_distinct_splits"] = len(
                {r[8] for r in got["fleet"][0]})
        if mode == "planner":
            compare["planner_switches"] = got["fleet"][1].get(
                "split_switches", 0)
    # every kernel split within 1e-4 of the f64 optimum of its envs, both
    # engines' calls in one batched latency sweep each
    for (mode, engine), calls in seen.items():
        envs = dec.EnvArrays(*(None if c[0] is None else torch.cat(c)
                               for c in zip(*(e.columns()
                                              for e, _ in calls))))
        picked = torch.cat([s for _, s in calls]).to(dev)
        lat = dec.latency_matrix(layers, envs)
        rows = torch.arange(len(envs), device=dev)
        best = lat.min(dim=1).values
        chosen = lat[rows, picked]
        check(bool((chosen <= best * (1 + 1e-4) + 1e-12).all()),
              f"fleet (b) {mode} {engine}: a kernel split is worse than "
              f"the f64 optimum by more than 1e-4")
        sizes = [len(e) for e, _ in calls]
        compare[f"{mode}_{engine}"].update(
            calls=len(calls), envs=len(envs),
            max_rel_gap=((chosen - best) / best).max().item())
        if engine == "fleet" and mode == "decide_pi5":
            compare["slab_envs_median"] = float(np.median(sizes))
            compare["slab_envs_max"] = max(sizes)
            shapes["slab"] = max(calls, key=lambda c: len(c[0]))[0]
    check({m for m, _ in seen} == {"decide", "decide_pi5"},
          f"fleet (b): splits decided in modes {sorted(seen)}")
    shapes["layers"] = layers
    out["compare"] = dict(tasks=len(day[0]),
                          planner_tasks=len(planner_day[0]),
                          nodes=COMPARE_NODES, **compare)
    del seen

    # -- (c) bench.contention's tail-vs-mean scenario, full horizon -------
    sc = bench_contention.tail_scenario(CONTENTION_HORIZON_S)
    c_layers, c_arr, rtt_samples, rtt_model = (sc.layers, sc.arr,
                                               sc.rtt_samples, sc.rtt_model)
    n_c = len(c_arr)
    c_envs = dec.make_envs(sc.device, sc.edge, link_bw=np.asarray([30e6]),
                           link_latency_s=0.005,
                           input_bytes=np.asarray([sc.input_bytes]),
                           device=dev)

    def contention(tail, backend, check_against=None):
        pool = sim.ServerPool(2)
        cost = bench_contention.policy_cost(sc, tail, pool)
        misses, splits, worst, differ, decide_s = 0, [], 0.0, [], 0.0
        for i in range(n_c):
            t = float(c_arr[i])
            cost.set_now(t)
            t0 = synced()
            plan = dec.decide_all(c_layers, c_envs, cost=cost,
                                  backend=backend, device=dev)
            got = torch.stack([plan.splits.double(), plan.device_time_s,
                               plan.edge_time_s, plan.transfer_time_s,
                               plan.scalar_cost]).cpu()[:, 0].tolist()
            decide_s += time.perf_counter() - t0
            s, dev_t, edge_t, xfer_t, scal = got
            if check_against is not None:
                ex = dec.decide_all(c_layers, c_envs, cost=cost,
                                    backend=check_against, device=dev)
                ex_s, ex_c = torch.stack([ex.splits.double(),
                                          ex.scalar_cost]).cpu()[:, 0] \
                    .tolist()
                check(scal <= ex_c * (1 + 1e-4) + 1e-12, f"fleet (c) "
                      f"{tail}: a kernel split costs {scal}, the f64 "
                      f"optimum {ex_c} (1e-4)")
                worst = max(worst, (scal - ex_c) / ex_c)
                if int(s) != int(ex_s):
                    differ.append(dict(task=i, kernel_split=int(s),
                                       kernel_cost=scal,
                                       torch_split=int(ex_s),
                                       torch_cost=ex_c))
            if edge_t > 0.0:             # offloading: queue + tail RTT
                xfer = xfer_t - cost._edge_wait() + float(rtt_samples[i])
                _, fin = pool.admit(t + dev_t + xfer, edge_t)
                realised = fin - t
            else:
                realised = dev_t
            misses += realised > CONTENTION_DEADLINE_S
            splits.append(int(s))
        return dict(misses=misses, splits=splits, worst=worst,
                    differ=differ, us_per_decision=1e6 * decide_s / n_c)

    before = ds_kernel.decide_split_kernel.launches
    policies = {}
    for name, tail in (("mean", None), ("p99", "p99"), ("cvar", "cvar")):
        k_run = contention(tail, "kernel", check_against="torch")
        t_run = contention(tail, "torch")
        same = k_run["splits"] == t_run["splits"]
        if k_run["differ"]:
            print(json.dumps({"contention_split_differences": {
                name: k_run["differ"]}}), flush=True)
        check(same or all(d["kernel_cost"] <= d["torch_cost"] * (1 + 1e-4)
                          + 1e-12 for d in k_run["differ"]),
              f"fleet (c) {name}: the kernel run's splits differ from the "
              "torch run's outside the near-optimal bound")
        check(not same or k_run["misses"] == t_run["misses"],
              f"fleet (c) {name}: equal splits but misses "
              f"{k_run['misses']} (kernel) != {t_run['misses']} (torch)")
        policies[name] = dict(
            misses=k_run["misses"], torch_misses=t_run["misses"],
            splits_equal_torch=same, split_differences=len(k_run["differ"]),
            max_rel_gap=k_run["worst"],
            offload_share=float(np.mean(np.asarray(k_run["splits"])
                                        < len(c_layers))),
            us_per_decision=k_run["us_per_decision"],
            torch_us_per_decision=t_run["us_per_decision"])
    for name in ("p99", "cvar"):
        check(policies[name]["misses"] < policies["mean"]["misses"],
              f"fleet (c): {name} misses {policies[name]['misses']} not "
              f"below mean-only {policies['mean']['misses']}")
    cost = co.QueueAwareCost(base=co.CompositeCost(
        weights={"tail_latency_s": 1.0}, tail="p99", rtt=rtt_model,
        tail_alpha=0.99), edge_pool=sim.ServerPool(2), rtt=rtt_model)
    shapes["contention"] = (c_layers, c_envs, co.lower_to_accel(cost))
    out["contention"] = dict(
        tasks=n_c, deadline_s=CONTENTION_DEADLINE_S,
        horizon_s=CONTENTION_HORIZON_S,
        decide_split_launches=ds_kernel.decide_split_kernel.launches
        - before, policies=policies)

    # -- (d) pools and RTT in the stream: bench.stream's largest cell -----
    s_tasks, s_arr, s_nodes = bench_stream.cell(200.0, 32, 300)
    pooled = {}
    for d in (dev, "cpu"):
        for engine in ("event", "fleet"):
            t0 = synced()
            tel = sim.simulate_stream(
                s_tasks, s_arr, s_nodes, pools=sim.NodePools.uniform(32, 2),
                rtt=sim.WeibullRTT(shape=0.6, scale=0.02, seed=SEED + 5),
                engine=engine, device=d)
            pooled[f"{d}_{engine}"] = (rows_of(tel), synced() - t0)
    want = pooled[f"{dev}_event"][0]
    check(all(r == want for r, _ in pooled.values()), "fleet (d): pooled "
          "streams differ between engines or devices (tolerance: exact)")
    out["pools"] = dict(
        tasks=300, nodes=32, capacity=2,
        p99_wait_s=want[1]["p99_wait_s"], mean_wait_s=want[1]["mean_wait_s"],
        mean_queue_len=want[1]["mean_queue_len"],
        **{f"{k}_s": t for k, (_, t) in pooled.items()})

    launches = {"fleet_scan": fs_kernel.place_singletons_kernel.launches,
                "decide_split": ds_kernel.decide_split_kernel.launches}
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"fleet_launch_counts": launches,
                      "fleet_scan_by_route": dict(
                          fs_kernel.place_singletons_kernel.by_route)}),
          flush=True)
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the fleet path")
    line("fleet", **out)
    launches["fleet_scan_by_route"] = dict(
        fs_kernel.place_singletons_kernel.by_route)
    return launches, shapes


def fleet_timing(dev, shapes: dict) -> tuple[dict, list]:
    """The fleet phase's kernel shapes timed with CUDA events after a
    warm-up: ``fleet_scan`` on the longest singleton run of (a) (the
    kernel's record, on both routes; its plain version on the card once, by
    the host clock, and held bit for bit against each), and ``decide_split``
    at (b)'s largest fleet slab and at (c)'s E = 1 contention sweep."""
    import torch
    from repro_torch.bench.common import F64_OPS_PER_S, bound, timed_ms
    from repro_torch.bench.kernels import decide_split_row
    from repro_torch.core import costs as co
    from repro_torch.kernels.decide_split import ops as ds_ops
    from repro_torch.kernels.fleet_scan import kernel as fs_kernel
    from repro_torch.kernels.fleet_scan import ref as fs_ref

    ins = [t.to(dev) for t in shapes["scan"]]
    n, n_nodes, k = ins[3].numel(), ins[0].numel(), ins[2].shape[0]

    def kernel(route):
        return fs_kernel.place_singletons_kernel(ins[0].clone(), *ins[1:],
                                                 route=route)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fs_ref.place_singletons_ref(ins[0].clone(), *ins[1:])
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    # both routes (registers as the path takes it, shared the parent's
    # design), each held bit for bit against the plain version and timed in
    # this call
    check(fs_kernel.choose_route(n_nodes) == "registers",
          f"fleet_scan: {n_nodes} nodes are not on the registers route")
    times = {}
    for route in fs_kernel.ROUTES:
        got = kernel(route)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"fleet_scan {route}: the kernel differs from its plain "
              "version on the card (tolerance: exact)")
        times[route] = timed_ms(lambda: kernel(route), 1)
    ms = times["registers"]
    # each input read once (avail, peak_eff, the [K, N] table, four [n]
    # columns) and each output written once (four [n] columns, avail);
    # per step and node two divisions, two additions, a max, a compare
    nbytes = 8 * (2 * n_nodes + k * n_nodes + 4 * n) + 8 * (4 * n + n_nodes)
    b_ms, b_by = bound(nbytes, 6 * n_nodes * n, F64_OPS_PER_S)
    scan = dict(ms=ms, plain_ms=plain_ms,
                plain_cpu_ms=shapes["scan_plain_cpu_ms"], bound_ms=b_ms,
                bound_by=b_by, bytes=nbytes,
                bytes_ms=bound(nbytes, 0.0)[0],
                ops_ms=bound(0.0, 6 * n_nodes * n, F64_OPS_PER_S)[0],
                us_per_step=1e3 * ms / n, steps=n,
                nodes=n_nodes, table_rows=k, max_abs_err=0.0,
                shared_ms=times["shared"],
                shared_us_per_step=1e3 * times["shared"] / n)
    line("kernel_check", kernel="fleet_scan", steps=n, nodes=n_nodes,
         exact=True, max_abs_err=0.0)
    line("timing_extra", kernel="fleet_scan", **scan)
    rows = []
    for case, (layers, envs, spec) in (
            ("fleet_slab", (shapes["layers"], shapes["slab"],
                            co.lower_to_accel(None))),
            ("contention", shapes["contention"])):
        row = decide_split_row(dev, case, ds_ops.pack_inputs(
            layers, envs, spec).kernel_args)
        check(row["err_over_tol"] < 1.0, f"decide_split {case}: off by "
              f"{row['err_over_tol']} of its tolerance")
        line("timing_extra", **row)
        rows.append(row)
    return scan, rows


def fit_split(gbt, gbt_kw: dict, x, y, dev) -> None:
    """Where ``fit_s`` goes: the same fit again on the card, timing by the
    host clock its level histograms (launch, kernel and the copy of the
    [K, F, B] sums and counts to the host, synchronised) and its per-tree
    updates (``_tree_predict``); the rest is the host's growth code.  The
    timers synchronise, so this fit is not ``fit_s``; it must grow the same
    trees."""
    import numpy as np
    import torch
    from repro_torch.core.predictors import gbt as gbt_mod
    from repro_torch.kernels.tree_predict.ref import flatten_gbt

    spent = {"histograms_s": 0.0, "tree_update_s": 0.0}
    hist, update = gbt_mod.hist_ops.level_histogram, \
        gbt_mod.GBTRegressor._tree_predict

    def timed(key, fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            if key == "histograms_s":
                out = tuple(t.cpu() for t in out)
            spent[key] += time.perf_counter() - t0
            return out
        return run

    gbt_mod.hist_ops.level_histogram = timed("histograms_s", hist)
    gbt_mod.GBTRegressor._tree_predict = timed("tree_update_s", update)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = gbt_mod.GBTRegressor(**gbt_kw).fit(x, y, device=dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    gbt_mod.hist_ops.level_histogram = hist
    gbt_mod.GBTRegressor._tree_predict = update
    a, b = flatten_gbt(again), flatten_gbt(gbt)
    check(all(np.array_equal(getattr(a, f), getattr(b, f)) for f in
              ("feature", "threshold_bin", "left", "right", "value")),
          "the timed fit grew other trees")
    line("fit_split", fit_s=total, **spent,
         host_growth_s=total - sum(spent.values()))


def model_check(dev) -> None:
    """Each model in f32 (``MODEL_CHECKS``: full width, some at cut depth):
    the kernel path against the plain path (``impl="naive"``) with shared
    weights on one prompt, phi-3-vision's also as embeddings.  MoE lines
    count the (token, layer) expert choices that differ between the two
    paths and the smallest gap between a token's k-th and (k+1)-th router
    probability."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod

    # plain f32 products on both paths (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    route = moe_mod.route
    for arch, layers in MODEL_CHECKS:
        full = get_config(arch)
        cfg = full.replace(dtype="float32",
                           num_layers=layers or full.num_layers)
        fast, plain = build_model(cfg), build_model(cfg, impl="naive")
        params = fast.init_params(SEED, dev)
        rng = np.random.default_rng(SEED)
        n_prompt = PROMPT_OF.get(arch, CHECK_PROMPT)
        prompts = {"tokens": {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, size=(1, n_prompt)), device=dev)}}
        if cfg.takes_embeddings:
            prompts["embeds"] = {"embeds": torch.as_tensor(rng.normal(
                size=(1, n_prompt, cfg.d_model)), dtype=torch.float32,
                device=dev)}
        if cfg.family == "audio":     # the encoder's seeded frames
            prompts["tokens"]["frames"] = torch.as_tensor(rng.normal(
                size=(1, cfg.enc_seq, cfg.d_model)), dtype=torch.float32,
                device=dev)
        for kind, batch in prompts.items():
            routes = {"fast": [], "plain": []}

            def recording(p, x_flat, c, sink=None):
                w, idx, aux = route(p, x_flat, c)
                probs = torch.softmax(x_flat.float() @ p["router"].float(),
                                      dim=-1)
                top = torch.topk(probs, c.top_k + 1, dim=-1).values
                sink.append((idx.sort(dim=-1).values,
                             (top[:, -2] - top[:, -1]).min().item()))
                return w, idx, aux

            with torch.inference_mode():
                moe_mod.route = lambda *a: recording(*a, sink=routes["fast"])
                got, _ = fast.prefill(params, batch, n_prompt)
                moe_mod.route = lambda *a: recording(*a,
                                                     sink=routes["plain"])
                want, _ = plain.prefill(params, batch, n_prompt)
                moe_mod.route = route
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            extra = {}
            if cfg.num_experts:
                extra = dict(
                    expert_choices_differing=sum(
                        int((a[0] != b[0]).any(dim=-1).sum())
                        for a, b in zip(routes["fast"], routes["plain"])),
                    token_layer_choices=n_prompt * cfg.num_layers,
                    min_router_gap_k_vs_k1=min(g for _, g in
                                               routes["plain"]))
            line("model_check", model=arch, dtype="float32", prompt=kind,
                 layers=cfg.num_layers,
                 reduced=(f"num_layers {full.num_layers}→{layers}"
                          if layers else None),
                 prompt_tokens=n_prompt, max_abs_err=err,
                 max_abs_logit=scale, rel_err=err / scale,
                 same_argmax=bool(got.argmax() == want.argmax()), **extra)
            check(bool(torch.isfinite(got).all()),
                  f"{arch}: non-finite logits")
            # f32 sums in other orders through every layer: 1e-3 of
            # max|logit|
            check(err <= 1e-3 * scale, f"{arch} ({kind}): kernel path "
                  f"differs from the plain path by {err / scale} of "
                  "max|logit| (tolerance 1e-3)")
            del got, want
        del params
        torch.cuda.empty_cache()


def serving_kernels(dev, launches: dict) -> list:
    """Each serving kernel against its plain version at the serving shapes,
    then timed; returns their records for the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.bench.common import (BF16_OPS_PER_S, F32_OPS_PER_S,
                                          bound, timed_ms)
    from repro_torch.bench.kernels import (flash_work, slstm_work,
                                           ssm_cb_work, ssm_work)
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    from repro_torch.kernels.slstm_scan import ref as sl_ref
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.kernels.ssm_scan import ref as ss_ref

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32, scale=0.5):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    def plain_attn(q, k, v, **kw):
        return fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), **kw).transpose(1, 2)

    # (case, B, S, Hq, Hkv, D, window, valid_len); the first two are the
    # prefill attention of qwen3-1.7b and of zamba2's shared block (the
    # other served shapes are OTHER_FLASH_SHAPES)
    cases = [("qwen3", 4, 2048, 16, 8, 128, 0, 0),
             ("zamba2", 4, 2048, 32, 32, 64, 0, 0),
             ("window512", 4, 2048, 16, 8, 128, 512, 0),
             ("valid_len1500", 4, 2048, 16, 8, 128, 0, 1500)]
    timed = {}
    for case, b, s, hq, hkv, d, window, valid in cases:
        for dtype in (torch.bfloat16, torch.float32):
            # unit scale: scores of std 1, so the softmax is not flat
            q = randn(b, s, hq, d, dtype=dtype, scale=1.0)
            k, v = (randn(b, s, hkv, d, dtype=dtype, scale=1.0)
                    for _ in range(2))
            kw = dict(causal=True, window=window, valid_len=valid)
            got = fa_kernel.flash_attention_kernel(q, k, v, **kw)
            torch.cuda.synchronize()
            # the same bits on a second call: no race on the K/V ring
            check(torch.equal(got, fa_kernel.flash_attention_kernel(
                q, k, v, **kw)), f"flash_attention {case} {dtype}: two "
                "calls on the same inputs differ")
            if dtype == torch.float32:
                # the JAX package's 2e-5, absolute plus relative
                want = plain_attn(q, k, v, **kw)
                tol = 2e-5 + 2e-5 * want.abs()
                rule = "2e-5 abs + rel"
            else:
                # the f32 attention of the same bf16 values, and per
                # element the rounding of P and of the output to bf16
                want, tol = (t.transpose(1, 2) for t in fa_ref.bf16_tolerance(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    **kw))
                rule = ("2e-5 + 2^-8 (|want| + min(sum p|v|, "
                        "8 sqrt(sum p^2 v^2)))")
            err = (got.float() - want).abs()
            over = (err / tol).max().item()
            line("kernel_check", kernel="flash_attention", case=case,
                 dtype=str(dtype).split(".")[-1], shape=[b, s, hq, hkv, d],
                 window=window, valid_len=valid,
                 max_abs_err=err.max().item(), err_over_tol=over,
                 median_tol=tol.median().item(), tolerance=rule)
            check(over <= 1.0, f"flash_attention {case} {dtype}: off by "
                  f"{over} of its tolerance ({rule})")
            del tol
            if case in ("qwen3", "zamba2") and (
                    dtype == torch.bfloat16 or case == "qwen3"):
                timed[case, dtype] = (q, k, v, err.max().item())
            del got, want, err

    def flash_times(q, k, v, ops_per_s, graph, kernel=None, causal=True):
        """The kernel (by default the wrapper on q, k, v) and SDPA replayed
        from a CUDA graph (``graph``), so the ctypes launch path stays out
        of a ~0.2 ms figure, and eager."""
        b, s, hq, d = q.shape
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def wrapper():
            return fa_kernel.flash_attention_kernel(q, k, v, causal=causal)
        kernel = kernel or wrapper

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        return dict(
            ms=timed_ms(kernel, 10, graph=graph),
            eager_ms=timed_ms(kernel, 10),
            plain_ms=timed_ms(lambda: plain_attn(q, k, v, causal=causal), 3,
                              groups=3),
            library_ms=timed_ms(sdpa, 10, graph=graph),
            library_eager_ms=timed_ms(sdpa, 10),
            timing="graph" if graph else "eager",
            bound=bound(*flash_work(b, s, hq, k.shape[2], d,
                                    q.element_size(), v.shape[-1],
                                    sk=k.shape[1], causal=causal),
                        ops_per_s))

    bf16 = torch.bfloat16
    # the tensor-core kernel's walk over key tiles at the qwen3 shape
    tiles = fa_kernel.classify_key_tiles(2048, 2048, d=128, causal=True)
    per_head = {c: sum(len(getattr(t, c)) for t in tiles)
                for c in ("skipped", "masked", "full")}
    line("flash_tiles", shape=[4, 2048, 16, 8, 128],
         block_q=fa_kernel.BLOCK_Q[128, 128],
         block_k=fa_kernel.BLOCK_K[128, 128],
         query_tiles_per_head=len(tiles),
         key_tiles_per_head=per_head,
         visited_per_call=4 * 16 * (per_head["masked"] + per_head["full"]),
         masked_per_call=4 * 16 * per_head["masked"])
    fa = flash_times(*timed["qwen3", bf16][:3], BF16_OPS_PER_S, True)
    fa_err = timed["qwen3", bf16][3]
    line("timing_extra", kernel="flash_attention", case="qwen3",
         dtype="bfloat16", shape=[4, 2048, 16, 128],
         **{k: v for k, v in fa.items() if k != "bound"},
         bound_ms=fa["bound"][0], bound_by=fa["bound"][1])
    # the zamba2 shape (tensor cores), and the f32 CUDA-core kernel that
    # f32 models run, at the qwen3 shape against the f32 peak (eager: it
    # sets its shared-memory limit at every launch)
    for (case, dtype), rate, graph in (
            (("zamba2", bf16), BF16_OPS_PER_S, True),
            (("qwen3", torch.float32), F32_OPS_PER_S, False)):
        t = flash_times(*timed[case, dtype][:3], rate, graph)
        line("timing_extra", kernel="flash_attention", case=case,
             dtype=str(dtype).split(".")[-1],
             shape=list(timed[case, dtype][0].shape),
             **{k: v for k, v in t.items() if k != "bound"},
             bound_ms=t["bound"][0], bound_by=t["bound"][1])
    del timed

    def unaligned(t):
        """A copy of ``t`` whose base is 2 bytes past a 16-byte boundary:
        TMA cannot take it, so the call runs the CUDA-core flash_fwd."""
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=dev)
        out = buf[1:1 + t.numel()].view(t.shape)
        out.copy_(t)
        return out

    # the shapes of phase 6's and 6b's models besides qwen3 and zamba2,
    # through ``ops`` as the models call it (from a CUDA graph, eager
    # beside): deepseek-v2-lite's MLA prefill (q/k 192, v 128 at its own
    # width), phi-3-vision's head dim 96, gemma-2b's 256 (MQA), one
    # deepseek-moe admission (batch 1, D 128) and whisper-tiny's two
    # non-causal shapes (the encoder, 1,500 rows: ragged for both the
    # 192-row query tile and the 128-key tile; the cross-attention, Sq 224
    # against Sk 1,500), all bf16 on the tensor cores and f32 on the CUDA
    # cores; in bf16 also the CUDA-core kernel at the same shape (unaligned
    # copies of the same inputs), eager
    other_shapes = {}
    for case, b, s, sk, hq, hkv, d, dv, causal in OTHER_FLASH_SHAPES:
        for dtype in (bf16, torch.float32):
            q = randn(b, s, hq, d, dtype=dtype, scale=1.0)
            k = randn(b, sk, hkv, d, dtype=dtype, scale=1.0)
            v = randn(b, sk, hkv, dv, dtype=dtype, scale=1.0)
            fa_kernel.reset_counts()
            got = fa_ops.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            taken = [n for n, c in fa_kernel.flash_attention_kernel
                     .by_kernel.items() if c]
            route = "flash_fwd_wgmma" if dtype == bf16 else "flash_fwd"
            check(taken == [route], f"flash_attention {case} {dtype}: ran "
                  f"{taken}, expected {route}")
            check(got.shape == (b, s, hq, dv), f"flash_attention {case}: "
                  f"output {tuple(got.shape)}")
            check(torch.equal(got, fa_ops.flash_attention(q, k, v,
                                                          causal=causal)),
                  f"flash_attention {case} {dtype}: two calls on the same "
                  "inputs differ")
            if dtype == torch.float32:
                want = plain_attn(q, k, v, causal=causal)
                tol = 1e-5 * want.abs().max()
                rule = "1e-5 of max|want|"
            else:
                want, tol = (t.transpose(1, 2) for t in fa_ref.bf16_tolerance(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal))
                rule = ("2e-5 + 2^-8 (|want| + min(sum p|v|, "
                        "8 sqrt(sum p^2 v^2)))")
            err = (got.float() - want).abs()
            over = (err / tol).max().item()
            line("kernel_check", kernel="flash_attention", case=case,
                 dtype=str(dtype).split(".")[-1], shape=[b, s, hq, hkv, d],
                 keys=sk, causal=causal, v_head_dim=dv, cuda_kernel=taken,
                 max_abs_err=err.max().item(), err_over_tol=over,
                 tolerance=rule, same_bits_in_two_calls=True)
            check(over <= 1.0, f"flash_attention {case} {dtype}: off by "
                  f"{over} of its tolerance ({rule})")
            if dtype == bf16:
                t = flash_times(q, k, v, BF16_OPS_PER_S, True,
                                lambda: fa_ops.flash_attention(
                                    q, k, v, causal=causal), causal=causal)
                qu, ku, vu = unaligned(q), unaligned(k), unaligned(v)
                fa_kernel.reset_counts()
                fa_ops.flash_attention(qu, ku, vu, causal=causal)
                check(fa_kernel.flash_attention_kernel.by_kernel[
                    "flash_fwd"] == 1, f"flash_attention {case}: the "
                    "unaligned copies did not run flash_fwd")
                fwd_ms = timed_ms(lambda: fa_ops.flash_attention(
                    qu, ku, vu, causal=causal), 3)
                other_shapes[case] = dict(
                    {k_: v_ for k_, v_ in t.items() if k_ != "bound"},
                    bound_ms=t["bound"][0], bound_by=t["bound"][1],
                    max_abs_err=err.max().item(), err_over_tol=over,
                    shape=[b, s, hq, hkv, d], keys=sk, causal=causal,
                    v_head_dim=dv,
                    cuda_kernel=taken[0], flash_fwd_eager_ms=fwd_ms,
                    over_library=t["ms"] / t["library_ms"],
                    flash_fwd_over_ms=fwd_ms / t["ms"])
                line("timing_extra", kernel="flash_attention", case=case,
                     dtype="bfloat16", **other_shapes[case])
                del qu, ku, vu
            del q, k, v, got, want, tol, err

    b, s, h, p, n, chunk = 4, 2048, 64, 64, 64, 128   # zamba2's Mamba2
    x = randn(b, s, h, p)
    dt = F.softplus(randn(b, s, h) - 4.0)             # the dt_bias of init
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    bm, cm = randn(b, s, n), randn(b, s, n)
    xdt, loga = ss_ref.ssd_inputs(x, dt, a_log)
    args = (xdt, loga, bm, cm, chunk)
    y, st = ss_kernel.ssd_scan_kernel(*args)
    torch.cuda.synchronize()
    # the same bits on a second call: no race in the chunks' hand-off
    y2, st2 = ss_kernel.ssd_scan_kernel(*args)
    check(torch.equal(y, y2) and torch.equal(st, st2),
          "ssm_scan: two calls on the same inputs differ")
    del y2, st2
    y_p, st_p = ss_ref.ssd_scan_chunked_ref(*args)
    errs = {}
    for name, got, want in (("y", y, y_p), ("state", st, st_p)):
        err = (got - want).abs()
        scale = want.abs().max().item()
        errs[name] = err.max().item()
        # f32 in another order: the JAX package's 2e-4, rel + abs of scale
        check(bool((err <= 2e-4 * want.abs() + 2e-4 * scale).all()),
              f"ssm_scan {name}: off by {errs[name]} (scale {scale}, "
              "tolerance 2e-4)")
    line("kernel_check", kernel="ssm_scan", shape=[b, s, h, p, n],
         chunk=chunk, max_abs_err_y=errs["y"],
         max_abs_err_state=errs["state"], tolerance=2e-4,
         same_bits_in_two_calls=True)
    ss = dict(ms=timed_ms(lambda: ss_kernel.ssd_scan_kernel(*args), 10),
              plain_ms=timed_ms(lambda: ss_ref.ssd_scan_chunked_ref(*args),
                                2, groups=3),
              library_ms=None,
              bound=bound(*ssm_work(b, s, h, p, n, chunk), F32_OPS_PER_S))
    # each CUDA kernel of the call on its own, with its own bound: ssd_cb's
    # work, and ssd_chunk's (the rest, reading C·Bᵀ from ssd_cb)
    cb = ss_kernel.cb_kernel(bm, cm, chunk)
    cb_bytes, cb_ops = ssm_cb_work(b, s, n, chunk)
    all_bytes, all_ops = ssm_work(b, s, h, p, n, chunk)
    per_kernel = {}
    for name, fn, (nbytes, ops) in (
            ("ssd_cb", lambda: ss_kernel.cb_kernel(bm, cm, chunk),
             (cb_bytes, cb_ops)),
            ("ssd_chunk",
             lambda: ss_kernel.chunk_kernel(xdt, loga, bm, cm, cb, chunk),
             (all_bytes + 4 * cb.numel(), all_ops - cb_ops))):
        kb = bound(nbytes, ops, F32_OPS_PER_S)
        per_kernel[name] = dict(ms=timed_ms(fn, 10), bound_ms=kb[0],
                                bound_by=kb[1],
                                launches=launches["ssm_scan_by_kernel"][name])
    ss["kernels"] = per_kernel
    line("timing_extra", kernel="ssm_scan", shape=[b, s, h, p, n, chunk],
         **{k: v for k, v in ss.items() if k != "bound"},
         bound_ms=ss["bound"][0], bound_by=ss["bound"][1])
    del cb, x, dt, bm, cm, xdt, loga, args, y, st, y_p, st_p

    # slstm_scan at xlstm-350m's prefill (B 4, S 2048, H 4, du 256): pre of
    # unit scale, R at the init's scale (std du^-1/2), in bf16 as served
    # and in f32, on both routes (the cluster route as served, the block
    # route the parent's design), each against the plain step loop: f32 h
    # and the final state within 1e-4 absolute (|h| <= 1: |c| <= n), bf16
    # h within one bf16 ulp of |h| (2^-7 |h| bounds it) plus 1e-4; each
    # route the same bits in two calls; both timed in this call
    xcfg = get_config("xlstm-350m")
    xb, xs = SERVE_BATCH, SERVE_PROMPT
    xh, du = xcfg.num_heads, xcfg.d_model // xcfg.num_heads
    pre = randn(4, xb, xs, xh * du, scale=1.0)
    r32 = randn(4, xh, du, du, scale=du ** -0.5)
    sl = {}
    for dtype in (bf16, torch.float32):
        r = r32.to(dtype)
        name = str(dtype).split(".")[-1]
        t0 = time.perf_counter()
        want, st_want = sl_ref.slstm_scan_ref(pre, r, out_dtype=dtype)
        torch.cuda.synchronize()
        plain_host_s = time.perf_counter() - t0
        tol = 1e-4 + (want.float().abs() * 2.0 ** -7 if dtype == bf16
                      else 0.0)
        b_ms, b_by = bound(*slstm_work(xb, xs, xh, du, r.element_size(),
                                       want.element_size()), F32_OPS_PER_S)
        check(sl_kernel.choose_route(xb, du, dtype) == "cluster",
              f"slstm_scan {name}: xlstm-350m's shape is not on the "
              "cluster route")
        routes = {}
        for route in sl_kernel.ROUTES:
            got, st = sl_kernel.slstm_scan_kernel(pre, r, out_dtype=dtype,
                                                  route=route)
            torch.cuda.synchronize()
            again, st2 = sl_kernel.slstm_scan_kernel(pre, r, out_dtype=dtype,
                                                     route=route)
            check(torch.equal(got, again) and all(
                torch.equal(a, c) for a, c in zip(st, st2)),
                f"slstm_scan {name} {route}: two calls on the same inputs "
                "differ")
            err = (got.float() - want.float()).abs()
            over = (err / tol).max().item()
            state_err = max((a - c).abs().max().item()
                            for a, c in zip(st, st_want))
            line("kernel_check", kernel="slstm_scan", dtype=name,
                 route=route, shape=[xb, xs, xh, du],
                 max_abs_err_h=err.max().item(), err_over_tol_h=over,
                 max_abs_err_state=state_err,
                 max_abs_h=want.float().abs().max().item(),
                 tolerance="h: 1e-4 (+ 2^-7 |h| in bf16); state: 1e-4",
                 same_bits_in_two_calls=True)
            check(over <= 1.0 and state_err <= 1e-4, f"slstm_scan {name} "
                  f"{route}: h off by {over} of its tolerance, state by "
                  f"{state_err} (tolerance 1e-4)")
            ms = timed_ms(lambda: sl_kernel.slstm_scan_kernel(
                pre, r, out_dtype=dtype, route=route), 3, groups=3)
            routes[route] = dict(ms=ms, us_per_step=ms * 1e3 / xs,
                                 max_abs_err=err.max().item(),
                                 state_max_abs_err=state_err)
            del got, again, st, st2, err
        sl[name] = dict(
            **routes["cluster"],
            plain_ms=timed_ms(lambda: sl_ref.slstm_scan_ref(
                pre, r, out_dtype=dtype), 1, groups=1),
            plain_host_s=plain_host_s, library_ms=None,
            bound_ms=b_ms, bound_by=b_by,
            cluster_plan=[sl_kernel.CLUSTER, sl_kernel.LANES],
            block_ms=routes["block"]["ms"],
            block_us_per_step=routes["block"]["us_per_step"],
            block_over_cluster=routes["block"]["ms"]
            / routes["cluster"]["ms"])
        line("timing_extra", kernel="slstm_scan", dtype=name,
             shape=[xb, xs, xh, du], timing="eager",
             bound_us_per_step=b_ms * 1e3 / xs, **sl[name])
        del want, st_want, tol
    del pre, r32

    out = []
    for name, t, err, shape, source, replaces in (
            ("flash_attention", fa, fa_err, [4, 2048, 16, 8, 128],
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:78"),
            ("ssm_scan", ss, max(errs.values()), [b, s, h, p, n],
             "src/repro_torch/csrc/ssm_scan.cu",
             "src/repro/kernels/ssm_scan/kernel.py:73")):
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": err, "ms": t["ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                    "bound_by": t["bound"][1],
                    "library_ms": t["library_ms"], "shape": shape})
    # flash: replayed from a CUDA graph; the eager call beside it; the new
    # models' shapes, and the continuous phase's launches (6b)
    out[0].update(timing="graph", eager_ms=fa["eager_ms"],
                  library_eager_ms=fa["library_eager_ms"],
                  other_shapes=other_shapes,
                  continuous_launches=launches["continuous"][
                      "flash_attention"])
    # ssm_scan: launches count calls; each CUDA kernel's own record
    out[1]["kernels"] = ss["kernels"]
    # slstm_scan: the bf16 call as served (cluster route; the block
    # route's time beside it), the f32 one beside it
    out.append({"name": "slstm_scan", "route": "cuda",
                "source": "src/repro_torch/csrc/slstm_scan.cu",
                "replaces": "src/repro/models/xlstm.py:156",
                "counterpart_of": "the lax.scan of slstm_scan (not a Pallas "
                "kernel)",
                "launches": launches["slstm_scan"],
                "launches_by_route": launches["slstm_scan_by_route"],
                "shape": [xb, xs, xh, du],
                "timing": "eager", **sl["bfloat16"],
                "float32": sl["float32"]})
    return out


def training_slice(dev, smi: str, profiling_data) -> dict:
    """The training slice (phase 11): (a) flash's log-sum-exp at every
    served ``flash_fwd_wgmma`` instance and qwen3's training shape; (b) the
    attention backward against autograd through ``naive_attention``; (c)
    qwen3-1.7b at full width and depth in bf16 through ``train()``; (d)
    its f32 loss and gradients card against CPU at 2 layers; (e)
    whisper-tiny through ``train()``; (f) the launcher; (g) a checkpoint
    round trip; (h) FedAvg on phase 3's profiling dataset, card against
    CPU.  Returns the flash launches of (c) and (e) and the timing rows."""
    import os
    import subprocess
    import tempfile

    import numpy as np
    import torch
    from repro_torch import ckpt
    from repro_torch.bench.mlp_spread import fedavg_clients
    from repro_torch.configs import get_config
    from repro_torch.core import fl
    from repro_torch.data.synthetic import train_batch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train import TrainConfig, train

    def synced():
        torch.cuda.synchronize(dev)
        return time.perf_counter()

    watch_plain_backward()
    out = attention_training(dev, smi)
    torch.cuda.empty_cache()

    # -- (c) qwen3-1.7b at full width and depth in bf16 --------------------
    t_part = synced()
    cfg = get_config(TRAIN_ARCH)
    check(cfg.dtype == "bfloat16" and cfg.num_layers == 28
          and cfg.d_model == 2048, f"{TRAIN_ARCH} is not at its published "
          "shape in bf16")
    fa_kernel.reset_counts()
    runs = []
    params = None
    for steps, bsz, seq in TRAIN_RUNS:
        torch.cuda.reset_peak_memory_stats(dev)
        # what earlier phases (and the previous run) still hold
        held = torch.cuda.memory_allocated(dev)
        before = dict(fa_kernel.flash_attention_kernel.by_kernel)
        before_bwd = dict(fa_kernel.flash_attention_bwd_kernel.by_kernel)
        tcfg = TrainConfig(steps=steps, batch_size=bsz, seq_len=seq,
                           log_every=0, seed=SEED)
        t0 = synced()
        res = train(cfg, tcfg, params=params, device=dev,
                    log_fn=lambda m: None)
        wall = synced() - t0
        params = res.final_params
        losses = res.losses
        by_kernel = {k_: n - before[k_] for k_, n in
                     fa_kernel.flash_attention_kernel.by_kernel.items()}
        bwd = {k_: n - before_bwd[k_] for k_, n in
               fa_kernel.flash_attention_bwd_kernel.by_kernel.items()}
        # each layer's flash forward, and again in its backward (remat)
        want_calls = steps * cfg.num_layers * 2
        row = dict(model=TRAIN_ARCH, dtype="bfloat16",
                   layers=cfg.num_layers, d_model=cfg.d_model, steps=steps,
                   batch=bsz, seq_len=seq, lr=tcfg.lr,
                   warmup_steps=tcfg.warmup_steps, losses=losses,
                   steps_per_s=res.steps_per_s,
                   tokens_per_s=res.steps_per_s * bsz * seq, wall_s=wall,
                   max_memory_allocated_bytes=torch.cuda.max_memory_allocated(
                       dev), held_before_bytes=held,
                   flash_by_kernel=by_kernel, flash_bwd_by_kernel=bwd,
                   device=smi)
        # one more pair of steps, the second timed in two synchronised
        # parts: train_loss + backward, then AdamW's update
        api = build_model(cfg)
        opt = AdamW(params.parameters(), warmup_cosine(tcfg.lr, 1, 2))
        batch = train_batch(cfg, bsz, seq, seed=SEED + steps, device=dev)
        for _ in range(2):
            t0 = synced()
            loss, _ = api.train_loss(params, batch)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            t1 = synced()
            opt.step()
            t2 = synced()
        row.update(loss_backward_s=t1 - t0, adamw_step_s=t2 - t1)
        del opt, loss, batch
        line("train", **row)
        runs.append(row)
        check(all(np.isfinite(losses)), f"{TRAIN_ARCH} B {bsz} S {seq}: a "
              f"non-finite loss ({losses})")
        check(by_kernel == {"flash_fwd": 0, "flash_fwd_wgmma": want_calls},
              f"{TRAIN_ARCH} training: flash {by_kernel}, expected "
              f"{want_calls} calls on flash_fwd_wgmma")
        check(bwd == {"flash_bwd": 0, "flash_bwd_mma": want_calls // 2},
              f"{TRAIN_ARCH} training: flash backward {bwd}, expected "
              f"{want_calls // 2} calls on flash_bwd_mma")
    first = runs[0]["losses"]
    check(np.mean(first[-5:]) < np.mean(first[:5]), f"{TRAIN_ARCH}: the "
          f"loss did not fall ({first})")
    out["train"] = runs
    out["launches"] = sum(r["flash_by_kernel"]["flash_fwd_wgmma"]
                          for r in runs)
    # the backward kernel's launches on the training paths of phase 11
    out["bwd_launches"] = {
        "qwen3": sum(r["flash_bwd_by_kernel"]["flash_bwd_mma"]
                     for r in runs)}
    del params, res
    torch.cuda.empty_cache()
    out["phase_s"]["c_qwen3"] = synced() - t_part

    # -- (d) f32 at full width, 2 layers: the card against the CPU ---------
    t_part = synced()
    cfg32 = cfg.replace(dtype="float32", num_layers=CHECK_TRAIN_LAYERS)
    fa_kernel.reset_counts()
    f32_card_vs_cpu(cfg32, 64, dev, model=TRAIN_ARCH,
                    reduced=f"num_layers {cfg.num_layers}→{cfg32.num_layers}")
    check(fa_kernel.flash_attention_kernel.by_kernel == {
        "flash_fwd": 2 * cfg32.num_layers, "flash_fwd_wgmma": 0},
        f"f32 check: flash {fa_kernel.flash_attention_kernel.by_kernel}")
    check(fa_kernel.flash_attention_bwd_kernel.by_kernel == {
        "flash_bwd": cfg32.num_layers, "flash_bwd_mma": 0},
        f"f32 check: flash backward "
        f"{fa_kernel.flash_attention_bwd_kernel.by_kernel}")
    torch.cuda.empty_cache()
    out["phase_s"]["d_f32"] = synced() - t_part

    # -- (e) whisper-tiny at full width in bf16 ----------------------------
    t_part = synced()
    wcfg = get_config("whisper-tiny")
    steps = 6
    fa_kernel.reset_counts()
    res = train(wcfg, TrainConfig(steps=steps, log_every=0, seed=SEED),
                device=dev, log_fn=lambda m: None)
    wby = dict(fa_kernel.flash_attention_kernel.by_kernel)
    wbwd = dict(fa_kernel.flash_attention_bwd_kernel.by_kernel)
    want_calls = steps * 2 * (wcfg.enc_layers + 2 * wcfg.num_layers)
    line("train", model="whisper-tiny", dtype="bfloat16",
         layers=wcfg.num_layers, enc_layers=wcfg.enc_layers,
         encoder_frames=wcfg.enc_seq, steps=steps, batch=8, seq_len=128,
         losses=res.losses, steps_per_s=res.steps_per_s,
         flash_by_kernel=wby, flash_bwd_by_kernel=wbwd, device=smi)
    check(all(np.isfinite(res.losses)), f"whisper-tiny: a non-finite loss "
          f"({res.losses})")
    check(wby == {"flash_fwd": 0, "flash_fwd_wgmma": want_calls},
          f"whisper-tiny training: flash {wby}, expected {want_calls} on "
          "flash_fwd_wgmma")
    check(wbwd == {"flash_bwd": 0, "flash_bwd_mma": want_calls // 2},
          f"whisper-tiny training: flash backward {wbwd}, expected "
          f"{want_calls // 2} on flash_bwd_mma")
    out["bwd_launches"]["whisper-tiny"] = wbwd["flash_bwd_mma"]
    out["launches"] += fa_kernel.flash_attention_kernel.launches
    out["phase_s"]["e_whisper"] = synced() - t_part

    # -- (g) a checkpoint round trip on the card ---------------------------
    t_part = synced()
    results = ROOT / "results"
    results.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=results) as tmp:
        for step in (3, 12):
            ckpt.save(os.path.join(tmp, f"ckpt_{step}.npz"),
                      res.final_params, step=step)
        path = ckpt.latest(tmp)
        tree, meta = ckpt.restore(path, res.final_params)
        same = all(a.device == b.device and a.dtype == b.dtype
                   and torch.equal(a, b) for a, b in
                   zip(tree.parameters(), res.final_params.parameters()))
        line("checkpoint", latest=os.path.basename(path), meta=meta,
             leaves=len(list(tree.parameters())), equal_on_card=same)
        check(path.endswith("ckpt_12.npz") and meta == {"step": 12}
              and same, "checkpoint: the restored tree differs from the "
              "saved one, or latest/meta are wrong")
    del res, tree
    torch.cuda.empty_cache()
    out["phase_s"]["g_checkpoint"] = synced() - t_part

    # -- (f) the launcher, f32 naive, as the reference's runs it -----------
    t_part = synced()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         TRAIN_ARCH, "--steps", "5"], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    m = re.search(r"loss ([-\d.naif]+) -> ([-\d.naif]+) at ([\d.]+) steps/s",
                  tail[0])
    line("launcher", returncode=proc.returncode, last_line=tail[0],
         seconds=time.perf_counter() - t_part)
    check(proc.returncode == 0 and m and all(
        np.isfinite(float(g)) for g in m.groups()),
        f"launch.train failed ({proc.returncode}): {proc.stderr[-2000:]}")
    out["phase_s"]["f_launcher"] = synced() - t_part

    # -- (h) FedAvg on the profiling dataset, card against CPU -------------
    t_part = synced()
    clients, test = fedavg_clients(profiling_data)
    fed = {}
    for name, dp in (("plain", None), ("dp", fl.DPConfig())):
        cfg_fl = fl.FedAvgConfig(dp=dp)
        timing = {}
        for where in ("card", "cpu"):
            t0 = synced()
            fed[name, where] = fl.run_fedavg(
                clients, cfg_fl, central_test=test,
                device=dev if where == "card" else "cpu")
            timing[where] = synced() - t0
        hk, hc = (np.array([h["federated_rmse"] for h in
                            fed[name, w].round_history])
                  for w in ("card", "cpu"))
        gap = float(np.max(np.abs(hk - hc) / hc))
        line("fedavg", run=name, clients=[len(c.x) for c in clients],
             rounds=cfg_fl.rounds, federated_rmse_card=float(hk[-1]),
             federated_rmse_cpu=float(hc[-1]),
             centralised_rmse_card=fed[name, "card"].centralised_rmse,
             max_round_rel_gap=gap, tolerance=FEDAVG_CARD_TOL,
             card_s=timing["card"], cpu_s=timing["cpu"], device=smi)
        check(np.isfinite(hk).all() and gap <= FEDAVG_CARD_TOL,
              f"FedAvg {name}: card and CPU round histories differ by {gap} "
              f"(relative; tolerance {FEDAVG_CARD_TOL})")
    check(fed["dp", "card"].federated_rmse
          > fed["plain", "card"].federated_rmse,
          "FedAvg: the DP run is not the noisier one")
    out["phase_s"]["h_fedavg"] = synced() - t_part
    out["scans"] = scan_training_slice(dev, smi)
    out["phase_s"].update(out["scans"].pop("phase_s"))
    out["served"] = served_training_slice(dev, smi)
    out["phase_s"].update(out["served"].pop("phase_s"))
    out["launches"] += sum(out["served"]["launches"].values())
    out["bwd_launches"].update(out["scans"].pop("bwd_launches"))
    out["bwd_launches"].update(out["served"].pop("bwd_launches"))
    check(PLAIN_BWD["cuda"] == 0, f"the plain attention backward ran "
          f"{PLAIN_BWD['cuda']} times on the card in phase 11")
    line("training_phase", phase_s=out["phase_s"],
         total_s=sum(out["phase_s"].values()),
         flash_bwd_launches=out["bwd_launches"],
         plain_bwd_calls_on_card=PLAIN_BWD["cuda"])
    return out


# calls of the plain attention backward on CUDA tensors since phase 11
# started (watch_plain_backward): the card's training must make none
PLAIN_BWD = {"cuda": 0}


def watch_plain_backward() -> None:
    """Count the plain attention backward's calls on CUDA tensors where the
    port can reach it (the op's CPU branch, ``ops.attention_bwd_ref``, and
    ``models.attention.flash_attention_bwd``) in ``PLAIN_BWD``.  This
    script's own timings and tolerances call ``ref.attention_bwd_ref``,
    which stays as it is."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import attention as attn
    plain = fa_ops.attention_bwd_ref

    def counted(q, *args, **kw):
        PLAIN_BWD["cuda"] += q.device.type == "cuda"
        return plain(q, *args, **kw)

    fa_ops.attention_bwd_ref = attn.flash_attention_bwd = counted


def f32_card_vs_cpu(cfg32, seq: int, dev, *, block_scaled: bool = False,
                    counts=None, **fields) -> dict:
    """One f32 ``train_loss`` of ``cfg32`` (``impl="chunked"``: the kernels
    on the card, their plain versions on the CPU) and its gradients at B 2,
    S ``seq``, on the card and on the CPU from the same weights (drawn on
    the card from the seed twice, one tree moved home) and batch, TF32
    off; the ``train_check`` line (with ``fields``) and the check within
    ``TRAIN_F32_TOL``: the loss relative, each gradient leaf against its
    largest magnitude (with ``block_scaled`` its block's: the leaves of
    one name prefix).  A leaf the loss never reads (a VLM's token embedding)
    must have no gradient on either side.  For an MoE model the forwards'
    router choices are recorded: the (token, k) choices of the card that
    the CPU did not make, and the smallest gap between a token's k-th and
    (k+1)-th router probability (the CPU's).  ``counts()``, read right
    after the card's backward, joins the line as ``launches`` (the CPU
    counts none)."""
    import torch
    from repro_torch.data.synthetic import train_batch
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod

    api = build_model(cfg32)
    params = {"card": api.init_params(SEED, dev, trainable=True),
              "cpu": api.init_params(SEED, dev, trainable=True).cpu()}
    batch = train_batch(cfg32, 2, seq, seed=SEED, device="cpu")
    batches = {"card": {k: t.to(dev) for k, t in batch.items()},
               "cpu": batch}
    route, routes, losses = moe_mod.route, {"card": [], "cpu": []}, {}
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for where, sink in routes.items():
        def recording(p, x_flat, c, sink=sink):
            w, idx, aux = route(p, x_flat, c)
            # outside autograd: the layer's recompute must save what its
            # forward saved
            with torch.no_grad():
                probs = torch.softmax(x_flat.float() @ p["router"].float(),
                                      dim=-1)
                top = torch.topk(probs, c.top_k + 1, dim=-1).values
                sink.append((idx.cpu(),
                             (top[:, -2] - top[:, -1]).min().item()))
            return w, idx, aux

        moe_mod.route = recording
        loss, _ = api.train_loss(params[where], batches[where])
        moe_mod.route = route        # the backward's recompute unrecorded
        loss.backward()
        losses[where] = loss.item()
        if where == "card" and counts is not None:
            launches = counts()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        flags
    grads, no_grad = {}, []
    for (name, pc), pk in zip(params["cpu"].named_parameters(),
                              params["card"].parameters()):
        if pc.grad is None or pk.grad is None:
            check(pc.grad is None and pk.grad is None, f"{cfg32.name} f32 "
                  f"check: {name} has a gradient on one side only")
            no_grad.append(name)
            continue
        grads[name] = (pc.grad.to(dev), pk.grad)     # compared on the card

    def block(name):
        return name.rsplit(".", 1)[0] if block_scaled else name

    scale = {}
    for name, (w, _) in grads.items():
        scale[block(name)] = max(scale.get(block(name), 0.0),
                                 w.abs().max().item())
    worst, worst_name = 0.0, None
    for name, (w, g) in grads.items():
        e = (g - w).abs().max().item() / max(scale[block(name)], 1e-30)
        if e > worst:
            worst, worst_name = e, name
    loss_err = abs(losses["card"] - losses["cpu"]) / losses["cpu"]
    res = dict(layers=cfg32.num_layers, batch=2, seq_len=seq,
               loss_card=losses["card"], loss_cpu=losses["cpu"],
               loss_rel_err=loss_err, max_grad_rel_err=worst,
               worst_leaf=worst_name, leaves=len(grads),
               leaves_without_gradient=no_grad)
    if counts is not None:
        res["launches"] = launches
    if cfg32.num_experts:
        n_e, differing = cfg32.num_experts, 0
        for (a, _), (b, _) in zip(routes["card"], routes["cpu"]):
            ones = torch.ones(a.shape, dtype=torch.float32)
            mine = torch.zeros(a.shape[0], n_e).scatter_(1, a, ones)
            theirs = torch.zeros(b.shape[0], n_e).scatter_(1, b, ones)
            differing += int((mine * (1 - theirs)).sum())
        res.update(token_k_choices_differing=differing,
                   token_k_choices=sum(b.numel() for b, _ in routes["cpu"]),
                   min_router_gap_k_vs_k1=min(g for _, g in routes["cpu"]))
    line("train_check", **fields, dtype="float32", impl="chunked", **res,
         tolerance=f"loss {TRAIN_F32_TOL} relative, each gradient "
         f"{TRAIN_F32_TOL} of its leaf's max |value|"
         + (" (of its block's)" if block_scaled else ""), tf32=False)
    check(loss_err <= TRAIN_F32_TOL and worst <= TRAIN_F32_TOL,
          f"{fields.get('model')} f32 train_loss: card against CPU off by "
          f"{loss_err} (loss), {worst} ({worst_name}); tolerance "
          f"{TRAIN_F32_TOL}")
    return res


def attention_training(dev, smi: str) -> dict:
    """Phase 11 (a)-(b): (a) flash's log-sum-exp at every ``LSE_SHAPES``
    case against the plain version, the output the same bits as a call
    without it, the training shapes of ``LSE_TIMED`` timed beside SDPA;
    (b) the f32 backward (``FlashAttention``: the kernel's CUDA-core
    route) at ``BWD_SHAPES`` against autograd through ``naive_attention``,
    the bf16 backward kernel against the plain backward within
    ``bwd_bf16_tolerance``, and the kernel at ``BWD_TIMED`` beside the
    plain backward and SDPA's.  Returns qwen3's timed training shape
    (``train_shape``), the others' (``train_shapes``), the backward rows
    and the seconds of each part."""
    import torch
    import torch.nn.functional as F
    from repro_torch._device import true_f32
    from repro_torch.bench.attn_bwd import bwd_row
    from repro_torch.bench.common import (BF16_OPS_PER_S, F32_OPS_PER_S,
                                          bound, timed_ms)
    from repro_torch.bench.kernels import flash_work
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.attention import (chunked_attention,
                                              naive_attention)

    out = {"phase_s": {}}
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def synced():
        torch.cuda.synchronize(dev)
        return time.perf_counter()

    def sdpa(q, k, v, causal=True):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True)

    # -- (a) the log-sum-exp ------------------------------------------------
    t_part = synced()
    timed = {}
    for case, b, s, sk, hq, hkv, d, dv, causal in LSE_SHAPES:
        q = randn(b, s, hq, d, dtype=bf16)
        k, v = randn(b, sk, hkv, d, dtype=bf16), randn(b, sk, hkv, dv,
                                                        dtype=bf16)
        fa_kernel.reset_counts()
        got, lse = fa_kernel.flash_attention_kernel(q, k, v, causal=causal,
                                                    return_lse=True)
        alone = fa_kernel.flash_attention_kernel(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(fa_kernel.flash_attention_kernel.by_kernel == {
            "flash_fwd": 0, "flash_fwd_wgmma": 2}, f"lse {case}: ran "
            f"{fa_kernel.flash_attention_kernel.by_kernel}")
        check(torch.equal(got, alone), f"lse {case}: the output with lse "
              "differs from the output without it")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        _, want = attention_ref(qt, kt, vt, causal=causal, return_lse=True)
        err = (lse - want).abs()
        over = (err / (LSE_TOL * (1 + want.abs()))).max().item()
        want_o, tol_o = fa_ref.bf16_tolerance(qt, kt, vt, causal=causal)
        over_o = ((got.transpose(1, 2).float() - want_o).abs()
                  / tol_o).max().item()
        line("lse_check", case=case, shape=[b, s, sk, hq, hkv, d, dv],
             causal=causal, max_abs_err=err.max().item(), err_over_tol=over,
             tolerance=f"{LSE_TOL} (1 + |lse|)", output_same_bits=True,
             output_err_over_tol=over_o,
             output_tolerance="flash_attention.ref.bf16_tolerance")
        check(over <= 1.0, f"lse {case}: off by {over} of its tolerance")
        check(over_o <= 1.0, f"lse {case}: the output is off the plain "
              f"version by {over_o} of bf16_tolerance")
        if case in LSE_TIMED:
            timed[case] = (q, k, v)
        del q, k, v, qt, kt, vt, got, alone, lse, want, err, want_o, tol_o
    # the training shapes: the kernel with its lse, SDPA, the plain version
    rows = {}
    for case, (q, k, v) in timed.items():
        b, s, hq, d = q.shape
        hkv, dv = k.shape[2], v.shape[3]
        nbytes, ops = flash_work(b, s, hq, hkv, d, 2, dv)
        row = dict(
            ms=timed_ms(lambda: fa_kernel.flash_attention_kernel(
                q, k, v, return_lse=True), 20, graph=True),
            eager_ms=timed_ms(lambda: fa_kernel.flash_attention_kernel(
                q, k, v, return_lse=True), 20),
            plain_ms=timed_ms(lambda: attention_ref(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                return_lse=True), 5),
            library_ms=timed_ms(lambda: sdpa(q, k, v), 20, graph=True),
            timing="graph", shape=[b, s, hq, hkv, d, dv], with_lse=True,
            instance=f"flash_fwd_wgmma<{d}, {dv}, LSE>")
        # the lse's f32 [B, Hq, S] written besides
        row["bound_ms"], row["bound_by"] = bound(nbytes + 4 * b * hq * s,
                                                 ops, BF16_OPS_PER_S)
        line("timing_extra", kernel="flash_attention", case=f"{case}_lse",
             dtype="bfloat16", **row, device=smi)
        rows[case] = row
    out["train_shape"] = rows.pop("qwen3_train")
    out["train_shapes"] = rows
    del timed
    # the f32 route (flash_fwd, CUDA cores) at the shape of its phase 14
    # launches: train_tiny_lm's reduced qwen3-1.7b in f32 (B 8, S 64, Hq 4,
    # Hkv 2, D 64, causal, with lse), against its f32 bound and SDPA on the
    # same f32 tensors with TF32 off
    b, s, hq, hkv, d = F32_FLASH_SHAPE
    q, k, v = (randn(b, s, h_, d) for h_ in (hq, hkv, hkv))
    fa_kernel.reset_counts()
    got, lse = fa_kernel.flash_attention_kernel(q, k, v, return_lse=True)
    taken = dict(fa_kernel.flash_attention_kernel.by_kernel)
    want, want_lse = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), return_lse=True)
    err = max((got - want.transpose(1, 2)).abs().max().item(),
              (lse - want_lse).abs().max().item())
    check(taken == {"flash_fwd": 1, "flash_fwd_wgmma": 0}, f"f32 flash at "
          f"{F32_FLASH_SHAPE}: took {taken}, not flash_fwd")
    check(err <= 1e-4, f"f32 flash at {F32_FLASH_SHAPE}: off the plain "
          f"version by {err}")
    nbytes, ops = flash_work(b, s, hq, hkv, d, 4, d)
    with true_f32():
        library_ms = timed_ms(lambda: sdpa(q, k, v), 20)
    row = dict(ms=timed_ms(lambda: fa_kernel.flash_attention_kernel(
                   q, k, v, return_lse=True), 20),
               plain_ms=timed_ms(lambda: attention_ref(
                   q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   return_lse=True), 20),
               library_ms=library_ms, library="SDPA, f32, TF32 off",
               timing="eager, as train_tiny_lm calls it",
               shape=[b, s, hq, hkv, d, d], with_lse=True,
               kernel_taken="flash_fwd", max_abs_err=err)
    row["bound_ms"], row["bound_by"] = bound(nbytes + 4 * b * hq * s, ops,
                                             F32_OPS_PER_S)
    line("timing_extra", kernel="flash_attention", case="tiny_lm_f32_lse",
         dtype="float32", **row, device=smi)
    out["f32_shape"] = row
    del q, k, v, got, lse, want, want_lse
    out["phase_s"]["a_lse"] = synced() - t_part

    # -- (b) the backward ---------------------------------------------------
    t_part = synced()
    shapes = {}
    for case, b, s, sk, hq, hkv, d, dv, causal in BWD_SHAPES:
        q = randn(b, s, hq, d)
        k, v = randn(b, sk, hkv, d), randn(b, sk, hkv, dv)
        do = randn(b, s, hq, dv)
        grads = []
        for fn in (chunked_attention, naive_attention):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            fa_kernel.reset_counts()
            o = fn(*leaves, causal=causal)
            o.backward(do)
            grads.append([t.grad for t in leaves])
            if fn is chunked_attention:
                taken = dict(fa_kernel.flash_attention_bwd_kernel.by_kernel)
        worst = max(((g - w).abs().max() / w.abs().max()).item()
                    for g, w in zip(*grads))
        line("backward_check", case=case, shape=[b, s, sk, hq, hkv, d, dv],
             causal=causal, dtype="float32", max_rel_err=worst,
             route=taken, plain_calls_on_card=PLAIN_BWD["cuda"],
             tolerance=f"{BWD_TOL} of each gradient's max |value|")
        check(worst <= BWD_TOL, f"backward {case}: dq/dk/dv off by {worst} "
              f"of their largest magnitude (tolerance {BWD_TOL})")
        check(taken == {"flash_bwd": 1, "flash_bwd_mma": 0}, f"backward "
              f"{case}: f32 took {taken}, not one flash_bwd call")
        shapes[case] = (b, s, hq, hkv, d, dv)
        del q, k, v, do, grads, leaves, o
    torch.cuda.empty_cache()
    # bf16 on the tensor cores against the plain backward of the same bf16
    # inputs: BWD_SHAPES and whisper's three training shapes
    for case, b, s, sk, hq, hkv, d, dv, causal in (
            *BWD_SHAPES, *(c for c in LSE_SHAPES
                           if c[0].startswith("whisper_")
                           and c[0].endswith("_train"))):
        q = randn(b, s, hq, d, dtype=bf16)
        k, v = randn(b, sk, hkv, d, dtype=bf16), randn(b, sk, hkv, dv,
                                                        dtype=bf16)
        do = randn(b, s, hq, dv, dtype=bf16)
        o, lse = fa_kernel.flash_attention_kernel(q, k, v, causal=causal,
                                                  return_lse=True)
        fa_kernel.reset_counts()
        got = fa_kernel.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                                   causal=causal)
        again = fa_kernel.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                                     causal=causal)
        torch.cuda.synchronize()
        taken = dict(fa_kernel.flash_attention_bwd_kernel.by_kernel)
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        want, tol = fa_ref.bwd_bf16_tolerance(q, k, v, o, lse, do,
                                              causal=causal)
        over = {n: ((g.float() - w).abs() / t).max().item()
                for n, g, w, t in zip(("dq", "dk", "dv"), got, want, tol)}
        err = max((g.float() - w).abs().max().item()
                  for g, w in zip(got, want))
        line("backward_check", case=case, shape=[b, s, sk, hq, hkv, d, dv],
             causal=causal, dtype="bfloat16", route=taken,
             err_over_tol=over, max_abs_err=err, same_bits_in_two_calls=same,
             tolerance="flash_attention.ref.bwd_bf16_tolerance")
        check(taken == {"flash_bwd": 0, "flash_bwd_mma": 2}, f"bf16 "
              f"backward {case}: took {taken}, not flash_bwd_mma")
        check(same, f"bf16 backward {case}: two calls differ")
        check(max(over.values()) <= 1.0, f"bf16 backward {case}: off the "
              f"plain backward by {over} of bwd_bf16_tolerance")
        del q, k, v, do, o, lse, got, again, want, tol
    torch.cuda.empty_cache()
    # the kernel (CUDA graph and eager), the plain backward and SDPA's
    # backward under autograd in bf16, beside the bound (bench.attn_bwd)
    bwd_rows = {}
    for case in BWD_TIMED:
        bwd_rows[case] = bwd_row(dev, *shapes[case], seed=SEED)
        line("timing_extra", kernel="flash_attention_backward", case=case,
             timing="graph", **bwd_rows[case], device=smi)
        check(bwd_rows[case]["err_over_tol"] <= 1.0, f"bf16 backward "
              f"{case}: off by {bwd_rows[case]['err_over_tol']} of "
              "bwd_bf16_tolerance")
    out["backward"] = bwd_rows
    out["phase_s"]["b_backward"] = synced() - t_part
    return out


def scan_training_slice(dev, smi: str) -> dict:
    """The recurrent families' training (phase 11 i-l): (i) the SSD
    backward kernels against ``ssd_scan_chunked_bwd_ref`` and (j)
    ``slstm_scan_bwd`` against ``slstm_scan_bwd_ref`` at the training
    shapes, each the same bits twice and timed beside its bound; (k)
    zamba2-1.2b and xlstm-350m at full width and depth in bf16 through
    ``train()``, every scan and flash call counted on its kernel; (l) one
    f32 ``train_loss`` and its gradients of each, cut to 2 groups, card
    against CPU.  Returns the ``ssm_scan`` and ``slstm_scan`` records'
    training entries and the phase's seconds."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.bench.common import timed_ms
    from repro_torch.bench.scan_bwd import (slstm_bounds, slstm_parts,
                                            ssm_bounds, ssm_parts)
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    from repro_torch.kernels.slstm_scan import ref as sl_ref
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.kernels.ssm_scan import ref as ss_ref
    from repro_torch.train import TrainConfig, train

    out = {"phase_s": {}, "ssm_scan": {}, "slstm_scan": {},
           "bwd_launches": {}}
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def synced():
        torch.cuda.synchronize(dev)
        return time.perf_counter()

    def rel_errs(names, got, want):
        return {k: ((g - w).abs().max() / w.abs().max()).item()
                for k, g, w in zip(names, got, want)}

    def all_counts():
        return dict(
            ssm_scan=dict(ss_kernel.ssd_scan_kernel.by_kernel,
                          calls=ss_kernel.ssd_scan_kernel.launches),
            ssm_scan_bwd=dict(ss_kernel.ssd_scan_bwd_kernel.by_kernel,
                              calls=ss_kernel.ssd_scan_bwd_kernel.launches),
            slstm_scan=dict(sl_kernel.slstm_scan_kernel.by_route),
            slstm_scan_bwd=dict(sl_kernel.slstm_scan_bwd_kernel.by_route),
            flash=dict(fa_kernel.flash_attention_kernel.by_kernel),
            flash_bwd=dict(fa_kernel.flash_attention_bwd_kernel.by_kernel))

    def reset_all():
        ss_kernel.reset_counts()
        sl_kernel.reset_counts()
        fa_kernel.reset_counts()

    zcfg, xcfg = get_config("zamba2-1.2b"), get_config("xlstm-350m")

    # -- (i) the SSD backward kernels at zamba2's training shapes ----------
    t_part = synced()
    h, p, n, chunk = (zcfg.n_ssm_heads, zcfg.d_inner // zcfg.n_ssm_heads,
                      zcfg.ssm_state, zcfg.ssm_chunk)
    check((h, p, n, chunk) == (64, 64, 64, 128), "zamba2-1.2b's Mamba2 is "
          f"not at its published shape: H {h}, P {p}, N {n}, Q {chunk}")
    rows = {}
    for case, b, s in SCAN_BWD_SHAPES:
        x = randn(b, s, h, p)
        dt = F.softplus(randn(b, s, h) - 4.0)         # the dt_bias of init
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
        bm, cm = randn(b, s, n), randn(b, s, n)
        xdt, loga = ss_ref.ssd_inputs(x, dt, a_log)
        dy, dst = randn(b, s, h, p), randn(b, h, p, n)
        fwd = (xdt, loga, bm, cm, chunk)
        y, st, saved = ss_kernel.ssd_scan_kernel(*fwd, save_states=True)
        y2, st2 = ss_kernel.ssd_scan_kernel(*fwd)
        check(torch.equal(y, y2) and torch.equal(st, st2), f"ssm_scan "
              f"{case}: the forward that saves its states changes the bits")
        args = (xdt, loga, bm, cm, *saved, chunk, dy, dst)
        got = ss_kernel.ssd_scan_bwd_kernel(*args)
        again = ss_kernel.ssd_scan_bwd_kernel(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        want = ss_ref.ssd_scan_chunked_bwd_ref(xdt, loga, bm, cm, chunk, dy,
                                               dst)
        errs = rel_errs(("dxdt", "dloga", "db", "dc"), got, want)
        line("backward_check", kernel="ssm_scan", case=case,
             shape=[b, s, h, p, n, chunk], dtype="float32",
             max_rel_err=errs, same_bits_in_two_calls=same,
             tolerance=f"{SCAN_BWD_TOL} of each gradient's max |value|")
        check(same, f"ssm_scan backward {case}: two calls differ")
        check(max(errs.values()) <= SCAN_BWD_TOL, f"ssm_scan backward "
              f"{case}: off the plain backward by {errs} (tolerance "
              f"{SCAN_BWD_TOL})")
        del got, again, want, y, y2, st, st2
        # the call and its parts: the chain, the chunks (also at each head
        # group beside the one taken) and the head sum
        split = ssm_parts(dict(xdt=xdt, loga=loga, b=bm, c=cm, cb=saved[0],
                               h_prev=saved[1], chunk=chunk, dy=dy,
                               dst=dst))
        bounds = ssm_bounds(b, s)
        rows[case] = dict(
            ms=split["ms"], parts_ms=split["parts"],
            heads_per_block=split["heads_per_block"],
            chunk_ms_by_group=split["chunk_by_group"],
            plain_ms=timed_ms(lambda: ss_ref.ssd_scan_chunked_bwd_ref(
                xdt, loga, bm, cm, chunk, dy, dst), 1, groups=2),
            library_ms=None, bound_ms=bounds["bound_f32"][0],
            bound_by=bounds["bound_f32"][1],
            bound_3xtf32_ms=bounds["bound_3xtf32"][0],
            bound_3xtf32_by=bounds["bound_3xtf32"][1],
            forward_saving_ms=timed_ms(lambda: ss_kernel.ssd_scan_kernel(
                *fwd, save_states=True), 5),
            forward_ms=timed_ms(lambda: ss_kernel.ssd_scan_kernel(*fwd), 5),
            max_rel_err=errs, shape=[b, s, h, p, n, chunk])
        line("timing_extra", kernel="ssm_scan_backward", case=case,
             **rows[case], device=smi)
        del x, dt, bm, cm, xdt, loga, dy, dst, saved, args
    out["ssm_scan"]["backward"] = rows
    torch.cuda.empty_cache()
    out["phase_s"]["i_ssm_backward"] = synced() - t_part

    # -- (j) slstm_scan_bwd at xlstm-350m's training shapes ----------------
    t_part = synced()
    xh, du = xcfg.num_heads, xcfg.d_model // xcfg.num_heads
    rows = {}
    for case, b, s in SCAN_BWD_SHAPES:
        pre = randn(4, b, s, xh * du)
        r32 = randn(4, xh, du, du, scale=du ** -0.5)
        h_cot = randn(b, s, xh * du)
        st_cot = tuple(randn(b, xh * du) for _ in range(4))
        for dtype in (torch.bfloat16, torch.float32):
            r = r32.to(dtype)
            name = str(dtype).split(".")[-1]
            route = sl_kernel.bwd_routes(b, du, dtype)[0]
            check(route == "cluster", f"slstm_scan backward {case} {name}: "
                  f"xlstm-350m's shape is not on the cluster route")
            hs, st, saved = sl_kernel.slstm_scan_kernel(
                pre, r, out_dtype=dtype, save_states=True)
            hs2, st2 = sl_kernel.slstm_scan_kernel(pre, r, out_dtype=dtype)
            check(torch.equal(hs, hs2) and all(
                torch.equal(a, c) for a, c in zip(st, st2)),
                f"slstm_scan {case} {name}: the forward that saves its "
                "steps changes the bits")
            got = sl_kernel.slstm_scan_bwd_kernel(saved, r, h_cot, st_cot)
            again = sl_kernel.slstm_scan_bwd_kernel(saved, r, h_cot, st_cot)
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            t0 = synced()
            want = sl_ref.slstm_scan_bwd_ref(pre, r, h_cot, st_cot)
            plain_host_s = synced() - t0
            errs = rel_errs(("dpre", "dR"), got, want)
            line("backward_check", kernel="slstm_scan", case=case,
                 dtype=name, route=route, shape=[b, s, xh, du],
                 max_rel_err=errs, same_bits_in_two_calls=same,
                 tolerance=f"{SCAN_BWD_TOL} of each gradient's max |value|")
            check(same, f"slstm_scan backward {case} {name}: two calls "
                  "differ")
            check(max(errs.values()) <= SCAN_BWD_TOL, f"slstm_scan "
                  f"backward {case} {name}: off the plain backward by "
                  f"{errs} (tolerance {SCAN_BWD_TOL})")
            del got, again, want, hs, hs2, st, st2
            # the call and its parts: the chain and the dR product
            split = slstm_parts(dict(saved=saved, r=r, h_cot=h_cot,
                                     st_cot=st_cot))
            ms = split["ms"]
            b_ms, b_by = slstm_bounds(b, s, r.element_size())["bound_f32"]
            # the plain backward: its one call above by the host clock,
            # synchronised (two step loops, host-bound: seconds at S 2048)
            rows[case, name] = dict(
                ms=ms, us_per_step=ms * 1e3 / s, parts_ms=split["parts"],
                chain_us_per_step=split["parts"]["slstm_bwd_cluster"] * 1e3
                / s, plain_ms=plain_host_s * 1e3,
                plain_timing="host clock, one call", library_ms=None,
                bound_ms=b_ms, bound_by=b_by,
                forward_saving_ms=timed_ms(lambda: sl_kernel.slstm_scan_kernel(
                    pre, r, out_dtype=dtype, save_states=True), 3, groups=3),
                forward_ms=timed_ms(lambda: sl_kernel.slstm_scan_kernel(
                    pre, r, out_dtype=dtype), 3, groups=3),
                max_rel_err=errs, route=route, shape=[b, s, xh, du])
            if case == "prefill":     # the block route's backward beside
                rows[case, name]["block_ms"] = timed_ms(
                    lambda: sl_kernel.slstm_scan_bwd_kernel(
                        saved, r, h_cot, st_cot, route="block"), 1, groups=1)
            line("timing_extra", kernel="slstm_scan_backward", case=case,
                 dtype=name, **rows[case, name], device=smi)
            del saved
        del pre, r32, r, h_cot, st_cot
    out["slstm_scan"]["backward"] = {f"{c}_{d}": v for (c, d), v in
                                     rows.items()}
    torch.cuda.empty_cache()
    out["phase_s"]["j_slstm_backward"] = synced() - t_part

    # -- (k) zamba2-1.2b and xlstm-350m through train() in bf16 ------------
    launches = {"ssm_scan": 0, "ssm_scan_bwd": 0, "slstm_scan": 0,
                "slstm_scan_bwd": 0}
    for arch, cfg in (("zamba2-1.2b", zcfg), ("xlstm-350m", xcfg)):
        t_part = synced()
        check(cfg.dtype == "bfloat16" and (cfg.num_layers, cfg.d_model) in (
            (38, 2048), (24, 1024)), f"{arch} is not at its published "
            "shape in bf16")
        mamba = cfg.num_layers if cfg.family == "hybrid" else 0
        groups = -(-cfg.num_layers // cfg.shared_attn_every) if mamba else 0
        slstm = cfg.num_layers // cfg.slstm_every if cfg.slstm_every else 0
        runs, params = [], None
        for steps, bsz, seq in SCAN_TRAIN_RUNS:
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            reset_all()
            tcfg = TrainConfig(steps=steps, batch_size=bsz, seq_len=seq,
                               warmup_steps=SCAN_TRAIN_WARMUP, log_every=0,
                               seed=SEED)
            t0 = synced()
            res = train(cfg, tcfg, params=params, device=dev,
                        log_fn=lambda m: None)
            wall = synced() - t0
            params = res.final_params
            got = all_counts()
            # per layer and step: the forward and its recompute (2), one
            # backward; the shared block's flash likewise 2 a group
            want = dict(
                ssm_scan=dict(ssd_cb=2 * steps * mamba,
                              ssd_chunk=2 * steps * mamba,
                              calls=2 * steps * mamba),
                ssm_scan_bwd=dict(ssd_bwd_chain=steps * mamba,
                                  ssd_bwd_chunk=steps * mamba,
                                  calls=steps * mamba),
                slstm_scan=dict(cluster=2 * steps * slstm, block=0),
                slstm_scan_bwd=dict(cluster=steps * slstm, block=0),
                flash=dict(flash_fwd=0, flash_fwd_wgmma=2 * steps * groups),
                flash_bwd=dict(flash_bwd=0, flash_bwd_mma=steps * groups))
            row = dict(model=arch, dtype="bfloat16", layers=cfg.num_layers,
                       d_model=cfg.d_model, steps=steps, batch=bsz,
                       seq_len=seq, lr=tcfg.lr, warmup_steps=tcfg.warmup_steps,
                       losses=res.losses, steps_per_s=res.steps_per_s,
                       tokens_per_s=res.steps_per_s * bsz * seq, wall_s=wall,
                       max_memory_allocated_bytes=torch.cuda
                       .max_memory_allocated(dev), held_before_bytes=held,
                       launches=got, device=smi)
            line("train", **row)
            runs.append(row)
            check(all(np.isfinite(res.losses)), f"{arch} B {bsz} S {seq}: a "
                  f"non-finite loss ({res.losses})")
            check(got == want, f"{arch} B {bsz} S {seq}: launches {got}, "
                  f"expected {want}")
            for k in launches:
                launches[k] += got[k]["calls"] if "calls" in got[k] else sum(
                    got[k].values())
            out["bwd_launches"][arch] = out["bwd_launches"].get(
                arch, 0) + got["flash_bwd"]["flash_bwd_mma"]
        first = runs[0]["losses"]
        check(np.mean(first[-3:]) < np.mean(first[:3]), f"{arch}: the loss "
              f"did not fall ({first})")
        out[arch] = runs
        del params, res
        torch.cuda.empty_cache()
        out["phase_s"][f"k_{arch}"] = synced() - t_part
    out["ssm_scan"]["training_launches"] = launches["ssm_scan"]
    out["ssm_scan"]["training_backward_launches"] = launches["ssm_scan_bwd"]
    out["slstm_scan"]["training_launches"] = launches["slstm_scan"]
    out["slstm_scan"]["training_backward_launches"] = launches[
        "slstm_scan_bwd"]

    # -- (l) f32 at full width, 2 groups: the card against the CPU ---------
    for arch, cfg, seq in (("zamba2-1.2b", zcfg, 160),
                           ("xlstm-350m", xcfg, 64)):
        t_part = synced()
        every = cfg.shared_attn_every if cfg.family == "hybrid" else \
            cfg.slstm_every
        cfg32 = cfg.replace(dtype="float32", num_layers=2 * every)
        reset_all()
        # xLSTM's gate biases: held against their block's largest gradient,
        # as tests/test_torch_train.py's BLOCK_SCALED (their gradients
        # cancel to a small difference of large terms)
        got = f32_card_vs_cpu(
            cfg32, seq, dev, block_scaled=cfg.family == "ssm",
            counts=all_counts, model=arch,
            reduced=f"num_layers {cfg.num_layers}→{cfg32.num_layers} (2 "
            "groups)")["launches"]
        mamba = cfg32.num_layers if cfg.family == "hybrid" else 0
        slstm = 2 if cfg.family == "ssm" else 0
        check(got["ssm_scan"]["calls"] == 2 * mamba
              and got["ssm_scan_bwd"]["calls"] == mamba
              and got["slstm_scan"]["cluster"] == 2 * slstm
              and got["slstm_scan_bwd"]["cluster"] == slstm,
              f"{arch} f32 check: launches {got}")
        torch.cuda.empty_cache()
        out["phase_s"][f"l_{arch}_f32"] = synced() - t_part
    return out


def served_training_slice(dev, smi: str) -> dict:
    """The six served-only configurations trained (phase 11 m-n): (m) each
    of ``SERVED_TRAIN_ARCHS`` at full width in bf16 through ``train()``
    (``impl="chunked"``: the flash kernel storing its lse, the backward
    kernel), at full depth or ``TRAIN_LAYERS``' cut, 10 steps at B 8,
    S 128 with 3 warm-up steps (``SCAN_TRAIN_RUNS``' first run): every
    loss finite, the last 3 below the first 3, every flash call (the
    forward and its recompute, 2 a layer a step) on ``flash_fwd_wgmma``,
    every backward (1) on ``flash_bwd_mma``;
    (n) one f32 ``train_loss`` and its gradients of each at full width cut
    to 2 layers, card against CPU (``f32_card_vs_cpu``; the MoE lines
    count the router choices that differ).  Returns each run's row, the
    flash launches per configuration and the seconds of each part."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models.registry import param_count
    from repro_torch.models.transformer import param_shapes
    from repro_torch.train import TrainConfig, train

    def synced():
        torch.cuda.synchronize(dev)
        return time.perf_counter()

    out = {"phase_s": {}, "runs": {}, "launches": {}, "bwd_launches": {}}
    steps, bsz, seq = SCAN_TRAIN_RUNS[0]
    # -- (m) bf16 through train() -----------------------------------------
    for arch, (d, dv) in SERVED_TRAIN_ARCHS.items():
        t_part = synced()
        full = get_config(arch)
        cfg = full.replace(num_layers=TRAIN_LAYERS.get(arch, full.num_layers))
        check(full.dtype == "bfloat16", f"{arch} is not in bf16")
        n_params = param_count(param_shapes(cfg))
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        fa_kernel.reset_counts()
        tcfg = TrainConfig(steps=steps, batch_size=bsz, seq_len=seq,
                           warmup_steps=SCAN_TRAIN_WARMUP, log_every=0,
                           seed=SEED)
        t0 = synced()
        res = train(cfg, tcfg, device=dev, log_fn=lambda m: None)
        wall = synced() - t0
        by_kernel = dict(fa_kernel.flash_attention_kernel.by_kernel)
        bwd = dict(fa_kernel.flash_attention_bwd_kernel.by_kernel)
        want_calls = 2 * steps * cfg.num_layers
        row = dict(model=arch, dtype="bfloat16", layers=cfg.num_layers,
                   reduced=(f"num_layers {full.num_layers}→{cfg.num_layers}"
                            " (weights, gradients and AdamW's moments at "
                            f"12 B a parameter: {12 * n_params / 1e9:.1f} "
                            "GB)" if cfg.num_layers < full.num_layers
                            else None),
                   d_model=cfg.d_model, params=n_params, steps=steps,
                   batch=bsz, seq_len=seq, lr=tcfg.lr,
                   warmup_steps=tcfg.warmup_steps, losses=res.losses,
                   steps_per_s=res.steps_per_s,
                   tokens_per_s=res.steps_per_s * bsz * seq, wall_s=wall,
                   max_memory_allocated_bytes=torch.cuda.max_memory_allocated(
                       dev), held_before_bytes=held,
                   flash_by_kernel=by_kernel, flash_bwd_by_kernel=bwd,
                   flash_instance=f"flash_fwd_wgmma<{d}, {dv}, LSE>",
                   device=smi)
        line("train", **row)
        out["runs"][arch] = row
        out["launches"][arch] = by_kernel["flash_fwd_wgmma"]
        out["bwd_launches"][arch] = bwd["flash_bwd_mma"]
        losses = res.losses
        del res
        torch.cuda.empty_cache()
        check(all(np.isfinite(losses)), f"{arch} B {bsz} S {seq}: a "
              f"non-finite loss ({losses})")
        check(np.mean(losses[-3:]) < np.mean(losses[:3]), f"{arch}: the "
              f"loss did not fall ({losses})")
        check(by_kernel == {"flash_fwd": 0, "flash_fwd_wgmma": want_calls},
              f"{arch} training: flash {by_kernel}, expected {want_calls} "
              "calls on flash_fwd_wgmma")
        check(bwd == {"flash_bwd": 0, "flash_bwd_mma": want_calls // 2},
              f"{arch} training: flash backward {bwd}, expected "
              f"{want_calls // 2} calls on flash_bwd_mma")
        out["phase_s"][f"m_{arch}"] = synced() - t_part

    # -- (n) f32 at full width, 2 layers: the card against the CPU ---------
    for arch in SERVED_TRAIN_ARCHS:
        t_part = synced()
        full = get_config(arch)
        cfg32 = full.replace(dtype="float32", num_layers=CHECK_TRAIN_LAYERS)
        fa_kernel.reset_counts()
        f32_card_vs_cpu(cfg32, 64, dev, model=arch,
                        reduced=f"num_layers {full.num_layers}→"
                        f"{cfg32.num_layers}")
        by_kernel = fa_kernel.flash_attention_kernel.by_kernel
        check(by_kernel == {"flash_fwd": 2 * cfg32.num_layers,
                            "flash_fwd_wgmma": 0},
              f"{arch} f32 check: flash {by_kernel}")
        bwd = fa_kernel.flash_attention_bwd_kernel.by_kernel
        check(bwd == {"flash_bwd": cfg32.num_layers, "flash_bwd_mma": 0},
              f"{arch} f32 check: flash backward {bwd}")
        torch.cuda.empty_cache()
        out["phase_s"][f"n_{arch}_f32"] = synced() - t_part
    return out


def trace_slice(dev, smi: str, oracle_runs: dict, serve_untraced: dict,
                continuous_untraced: dict) -> dict:
    """The main paths traced (phase 12): each again with a
    :class:`repro_torch.obs.Tracer`, held equal to its untraced run.  (a)
    Phase 4's 300-task stream with the oracle riding it, on the card and
    the CPU, and its decide-at-admission run; (b) ``bench_fleet.py``'s
    20k × 16 cell on the fleet engine with an RTT, untraced and traced on
    the card and traced on the CPU; (c) TRACE_ARCH through ``ServeEngine``
    and CONT_ARCH through ``ContinuousBatchEngine`` at phases 6's and 6b's
    shapes, with a ``MetricsRegistry``.  Each Chrome trace is written to
    ``results/trace_*.json`` and validated from the file.  Writes the
    ``trace`` line; returns each kernel's launches per traced path (counts
    set to 0 just before the path, read just after)."""
    import dataclasses as dc

    import torch
    from repro_torch import sim
    from repro_torch.bench.fleet import fleet_day
    from repro_torch.configs import get_config
    from repro_torch.core import costs as co
    from repro_torch.kernels.decide_split import kernel as ds_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.fleet_scan import kernel as fs_kernel
    from repro_torch.kernels.tree_predict import kernel as tp_kernel
    from repro_torch.obs import (MetricsRegistry, Tracer, export_chrome,
                                 validate_chrome)
    from repro_torch.obs.analyze import attribute
    from repro_torch.oracle import OnlineOracle
    from repro_torch.serve import ContinuousBatchEngine, ServeEngine

    out_dir = ROOT / "results"
    out_dir.mkdir(exist_ok=True)
    t_phase = time.perf_counter()
    out = {}
    launches = {"tree_predict": {}, "decide_split": {}, "fleet_scan": {},
                "flash_attention": {}}

    def synced():
        torch.cuda.synchronize(dev)
        return time.perf_counter()

    def records(tel):
        return [dc.astuple(r) for r in tel.records]

    def first_read(tracer) -> float:
        """Host seconds of the first read: every deferred column batch
        brought home and built into events."""
        t0 = time.perf_counter()
        tracer.all_spans()
        tracer.all_instants()
        return time.perf_counter() - t0

    def exported(tracer, name: str) -> dict:
        """The Chrome export, written and validated from the file."""
        path = out_dir / f"trace_{name}.json"
        t0 = time.perf_counter()
        export_chrome(tracer, str(path))
        export_s = time.perf_counter() - t0
        return dict(validate_chrome(str(path)), export_s=export_s,
                    file_bytes=path.stat().st_size)

    # -- (a) phase 4's stream with the oracle, card and CPU ----------------
    o = oracle_runs
    runs = {}
    for where, d, model in (("card", dev, o["gbt"]),
                            ("cpu", "cpu", o["gbt_host"])):
        tracer = Tracer()
        riding = OnlineOracle(model, o["pi5"], o["a100"], torch_device=d)
        tp_kernel.reset_counts()
        ds_kernel.decide_split_kernel.launches = 0
        t0 = synced()
        tel = sim.simulate_stream(o["tasks"], o["arrivals"], o["nodes"],
                                  oracle=riding, obs=tracer, device=d)
        run_s = synced() - t0
        if where == "card":
            launches["tree_predict"]["oracle_stream"] = \
                tp_kernel.tree_predict_kernel.launches
            launches["decide_split"]["oracle_stream"] = \
                ds_kernel.decide_split_kernel.launches
        runs[where] = (tel, tracer, run_s, first_read(tracer))
    (tel, tracer, run_s, read_s), (h_tel, h_tracer, h_run_s, h_read_s) = \
        runs["card"], runs["cpu"]
    check(records(tel) == o["oracle_records"], "trace (a): the traced "
          "card run's records differ from phase 4's untraced card run "
          "(tolerance: exact)")
    check(launches["tree_predict"]["oracle_stream"] > 0,
          "trace (a): tree_predict was not launched on the traced stream")
    stats = exported(tracer, "oracle_stream")
    check(stats["n_spans"] >= 2 * len(tel) and stats["n_instants"] >= 1,
          f"trace (a): {stats} for {len(tel)} tasks")
    att, h_att = attribute(tracer), attribute(h_tracer)
    check(att.summary() == h_att.summary(), "trace (a): attribute(tracer) "
          "on the card differs from the CPU's traced run (exact)")
    via_rows = attribute(tel)
    check(via_rows.phase_totals() == att.phase_totals(), "trace (a): "
          "attribute(telemetry) and attribute(tracer) differ on the phase "
          f"totals ({via_rows.phase_totals()} vs {att.phase_totals()})")
    prom, reg = tel.to_prometheus(), tel.registry()
    check(prom == h_tel.to_prometheus() and reg.to_rows()
          == h_tel.registry().to_rows(), "trace (a): Telemetry's "
          "Prometheus text or registry rows differ between card and CPU")
    (out_dir / "trace_oracle_stream.prom").write_text(prom)
    out["oracle_stream"] = dict(
        tasks=len(tel), spans=stats["n_spans"],
        instants=stats["n_instants"], tracks=stats["n_tracks"],
        traced_s=run_s, untraced_s=o["oracle_s"], first_read_s=read_s,
        export_s=stats["export_s"], trace_bytes=stats["file_bytes"],
        cpu_traced_s=h_run_s, cpu_first_read_s=h_read_s,
        phase_totals=att.phase_totals(), prometheus_lines=len(
            prom.splitlines()), metrics=len(reg))

    # phase 4's decide-at-admission run, traced on the card
    env = sim.DriftingEnv(o["pi5"], o["a100"], sim.RandomWalkLink(
        1.25e8, sigma=1.5, seed=SEED + 2), torch_device=dev)
    tracer = Tracer()
    ds_kernel.decide_split_kernel.launches = 0
    t0 = synced()
    tel = sim.simulate_stream(o["tasks"], o["arrivals"], o["nodes"],
                              cost=co.PredictorCost(o["gbt"], o["pi5"],
                                                    o["a100"]),
                              split_env=env, split_layers=o["layers"],
                              split_backend="kernel", link_update_dt=0.05,
                              obs=tracer, device=dev)
    run_s = synced() - t0
    launches["decide_split"]["admission"] = \
        ds_kernel.decide_split_kernel.launches
    check(records(tel) == o["admit_records"], "trace (a): the traced "
          "decide-at-admission run's records differ from phase 4's")
    check(launches["decide_split"]["admission"] == o["admit_launches"],
          f"trace (a): {launches['decide_split']['admission']} decide_split "
          f"launches at admission, phase 4 made {o['admit_launches']}")
    read_s = first_read(tracer)
    stats = exported(tracer, "admission")
    out["admission"] = dict(tasks=len(tel), spans=stats["n_spans"],
                            instants=stats["n_instants"], traced_s=run_s,
                            untraced_s=o["admit_s"], first_read_s=read_s,
                            export_s=stats["export_s"])

    # -- (b) the fleet engine's slab path: 20k × 16 with an RTT ------------
    tasks, arr, nodes, links = fleet_day(COMPARE_TASKS, COMPARE_NODES,
                                         FLEET_DAY_S)
    runs = {}
    for name, d, traced in (("untraced", dev, False), ("traced", dev, True),
                            ("cpu", "cpu", True)):
        tracer = Tracer() if traced else None
        fs_kernel.reset_counts()
        t0 = synced()
        tel = sim.simulate_stream(
            tasks, arr, nodes, policy="min_min", links=links(),
            link_update_dt=1.0, rtt=sim.WeibullRTT(shape=0.6, scale=0.02,
                                                   seed=SEED + 5),
            engine="fleet", obs=tracer, device=d)
        run_s = synced() - t0
        if name == "traced":
            launches["fleet_scan"]["fleet"] = \
                fs_kernel.place_singletons_kernel.launches
        runs[name] = dict(records=records(tel), run_s=run_s, tracer=tracer,
                          read_s=None if tracer is None
                          else first_read(tracer))
    card, cpu = runs["traced"], runs["cpu"]
    check(card["records"] == runs["untraced"]["records"], "trace (b): the "
          "traced fleet run's records differ from the untraced run's")
    check(card["records"] == cpu["records"], "trace (b): the card's "
          "records differ from the CPU run's")
    spans = [dc.astuple(s) for s in card["tracer"].all_spans()]
    instants = [dc.astuple(i) for i in card["tracer"].all_instants()]
    check(spans == [dc.astuple(s) for s in cpu["tracer"].all_spans()]
          and instants == [dc.astuple(i)
                           for i in cpu["tracer"].all_instants()],
          "trace (b): the card run's spans or instants differ from the CPU "
          "run's (tolerance: exact)")
    n_transfer = sum(s[2] == "transfer" for s in spans)
    check(n_transfer > 0, "trace (b): no transfer span (rtt= draws none)")
    check(launches["fleet_scan"]["fleet"] > 0, "trace (b): fleet_scan was "
          "not launched on the traced fleet run")
    stats = exported(card["tracer"], "fleet")
    out["fleet"] = dict(
        tasks=COMPARE_TASKS, nodes=COMPARE_NODES, spans=stats["n_spans"],
        instants=stats["n_instants"], transfer_spans=n_transfer,
        untraced_s=runs["untraced"]["run_s"], traced_s=card["run_s"],
        first_read_s=card["read_s"], export_s=stats["export_s"],
        trace_bytes=stats["file_bytes"], cpu_traced_s=cpu["run_s"],
        cpu_first_read_s=cpu["read_s"])
    del runs, card, cpu, spans, instants

    # -- (c) serving, traced, at phases 6's and 6b's shapes ----------------
    cfg = get_config(TRACE_ARCH)
    prompt = PROMPT_OF.get(TRACE_ARCH, SERVE_PROMPT)
    n_batches = -(-SERVE_REQUESTS // SERVE_BATCH)
    tracer, reg = Tracer(), MetricsRegistry()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, batch_size=SERVE_BATCH,
                      max_len=prompt + SERVE_NEW + 8, seed=SEED, obs=tracer,
                      metrics=reg, device=dev)
    init_s = synced() - t0
    fa_kernel.reset_counts()
    t0 = time.perf_counter()
    done = eng.serve(serve_requests(cfg, prompt))
    serve_s = time.perf_counter() - t0
    launches["flash_attention"]["serve"] = \
        fa_kernel.flash_attention_kernel.launches
    by_kernel = dict(fa_kernel.flash_attention_kernel.by_kernel)
    check({r.rid: r.output.tolist() for r in done}
          == serve_untraced["tokens"], f"trace (c): {TRACE_ARCH}'s traced "
          "tokens differ from phase 6's")
    check(by_kernel["flash_fwd_wgmma"] == n_batches * cfg.num_layers
          == launches["flash_attention"]["serve"], f"trace (c): flash "
          f"{by_kernel}, expected {n_batches * cfg.num_layers} on wgmma")
    spans, instants = tracer.all_spans(), tracer.all_instants()
    check([s.name for s in spans] == ["prefill", "decode"] * n_batches
          and [i.name for i in instants] == ["first_token"] * n_batches,
          f"trace (c): {[s.name for s in spans]}, "
          f"{[i.name for i in instants]} for {n_batches} batches")
    st = eng.stats
    sums = {p: sum(s.duration for s in spans if s.name == p)
            for p in ("prefill", "decode")}
    check(sums == {"prefill": st.prefill_s, "decode": st.decode_s},
          f"trace (c): span sums {sums}, stats {st.prefill_s}, "
          f"{st.decode_s}")
    check(reg.counter("serve_requests_completed").value == SERVE_REQUESTS
          and reg.quantile("serve_first_token_seconds").count == n_batches
          and reg.quantile("serve_request_total_seconds").count
          == SERVE_REQUESTS, "trace (c): the serving registry missed a "
          "batch or a request")
    stats = exported(tracer, "serve")
    (out_dir / "trace_serve.prom").write_text(reg.to_prometheus())
    out["serve"] = dict(
        model=TRACE_ARCH, batches=n_batches, spans=stats["n_spans"],
        instants=stats["n_instants"], init_s=init_s,
        untraced_init_s=serve_untraced["init_s"], traced_serve_s=serve_s,
        untraced_serve_s=serve_untraced["serve_s"], prefill_s=sums[
            "prefill"], decode_s=sums["decode"],
        first_token_p50_s=reg.quantile("serve_first_token_seconds")
        .quantile(0.5), export_s=stats["export_s"])
    del eng, done
    torch.cuda.empty_cache()

    ccfg = get_config(CONT_ARCH)
    lens, reqs, bws = continuous_requests(ccfg)
    link = iter(bws.tolist())
    tracer, reg = Tracer(), MetricsRegistry()
    t0 = time.perf_counter()
    eng = ContinuousBatchEngine(
        ccfg, slots=SERVE_BATCH, max_len=SERVE_PROMPT + SERVE_NEW + 8,
        seed=SEED, cost=co.AnalyticCost(), link_bw=lambda: next(link),
        decision_backend="kernel", obs=tracer, metrics=reg, device=dev)
    init_s = synced() - t0
    fa_kernel.reset_counts()
    ds_kernel.decide_split_kernel.launches = 0
    t0 = time.perf_counter()
    done = eng.serve(reqs)
    serve_s = time.perf_counter() - t0
    launches["flash_attention"]["continuous"] = \
        fa_kernel.flash_attention_kernel.launches
    launches["decide_split"]["continuous"] = \
        ds_kernel.decide_split_kernel.launches
    check({r.rid: r.output.tolist() for r in done}
          == continuous_untraced["tokens"], f"trace (c): {CONT_ARCH}'s "
          "traced tokens differ from phase 6b's")
    check(launches["flash_attention"]["continuous"]
          == SERVE_REQUESTS * ccfg.num_layers
          and launches["decide_split"]["continuous"] == SERVE_REQUESTS,
          f"trace (c): continuous launches {launches}")
    names = [i.name for i in tracer.all_instants()]
    lifecycles = {s.tid: s for s in tracer.all_spans()
                  if s.name == "sojourn"}
    check(names.count("admit") == names.count("replan") == SERVE_REQUESTS,
          f"trace (c): {names.count('admit')} admit and "
          f"{names.count('replan')} replan instants for {SERVE_REQUESTS} "
          "requests")
    check(sorted(lifecycles) == list(range(SERVE_REQUESTS)) and all(
        lifecycles[r.rid].t0 == r.arrived_at for r in done),
        "trace (c): a request's sojourn span is missing or misplaced")
    check(reg.quantile("serve_sojourn_seconds").count == SERVE_REQUESTS,
          "trace (c): the continuous registry missed a request")
    att = attribute(tracer)
    stats = exported(tracer, "continuous")
    out["continuous"] = dict(
        model=CONT_ARCH, requests=SERVE_REQUESTS, spans=stats["n_spans"],
        instants=stats["n_instants"], init_s=init_s,
        untraced_init_s=continuous_untraced["init_s"],
        traced_serve_s=serve_s,
        untraced_serve_s=continuous_untraced["serve_s"],
        phase_totals=att.phase_totals(), export_s=stats["export_s"])
    del eng, done
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    line("trace", **out, launches=launches, device=smi)
    return launches


def mesh_slice(dev, smi: str, layers, envs) -> dict:
    """The mesh and the dry-run on the card (phase 13), on a one-rank
    ``nccl`` (1, 1) mesh: (a) qwen3-1.7b through ``assemble`` against
    ``train()`` on the same batches, init and knobs; (b) deepseek-moe-16b's
    prefill through ``assemble`` against ``api.prefill``; (c) zamba2-1.2b's
    decode step through ``assemble`` after a prefill, against
    ``decode_step``; (d) ``decide_all_sharded(mesh=)`` over phase 2's
    envs against ``backend="torch"``.  For (a)-(c) the dry-run at chips = 1
    (``launch.dryrun.step_costs`` on an abstract (1, 1) mesh) against the
    card: its static bytes within ``max_memory_allocated()``, its ATen
    FLOPs against ``FlopCounterMode`` of the card's step, its roofline
    bound at most the measured step time.  Returns flash's launches per
    part."""
    import tempfile
    from functools import partial

    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core import decisions as dec
    from repro_torch.data.synthetic import prefill_batch, train_batch
    from repro_torch.distributed.context import AbstractMesh
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch.dryrun import step_costs
    from repro_torch.launch.mesh import make_card_mesh
    from repro_torch.launch.steps import assemble
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.roofline import analyze, model_flops_estimate
    from repro_torch.sim.fleet import decide_all_sharded
    from repro_torch.train import TrainConfig, train

    t_phase = time.perf_counter()
    store = tempfile.mkdtemp()
    mesh = make_card_mesh(f"{store}/store")
    one = AbstractMesh((1, 1), ("data", "model"))
    out, parts = {"flash": {}}, {}

    def synced():
        torch.cuda.synchronize(dev)
        return time.perf_counter()

    def predicted(cfg, shape, **kw):
        """The dry-run at chips = 1 of the same step."""
        step = assemble(cfg, shape, one, **kw)
        costs = step_costs(step, shape)
        roof = analyze(step.name, costs, chips=1,
                       model_flops=model_flops_estimate(step.cfg, shape))
        return costs, roof

    def against(name, costs, roof, peak, card_flops, step_s, **extra):
        flop_gap = abs(card_flops - costs["flops"]) / costs["flops"]
        row = dict(static_bytes=costs["static"]["total"],
                   max_memory_allocated=peak,
                   static_over_peak=costs["static"]["total"] / peak,
                   temp_peak_bytes=costs["temp_peak_bytes"],
                   predicted_flops=costs["flops"],
                   predicted_aten_flops=costs["aten_flops"],
                   kernel_flops=costs["kernel_flops"],
                   card_flop_counter=card_flops, flop_gap=flop_gap,
                   flop_tolerance=MESH_FLOP_TOL,
                   bound_s=roof.bound_s, bound_by=roof.dominant,
                   compute_s=roof.compute_s, memory_s=roof.memory_s,
                   step_s=step_s, bound_over_step=roof.bound_s / step_s,
                   device=smi, **extra)
        line("mesh_check", part=name, **row)
        check(costs["static"]["total"] <= peak, f"mesh {name}: the dry-run's "
              f"static bytes {costs['static']['total']} exceed the card's "
              f"max_memory_allocated {peak}")
        check(flop_gap <= MESH_FLOP_TOL, f"mesh {name}: FlopCounterMode on "
              f"the card counts {card_flops}, the dry-run {costs['flops']}"
              f" (gap {flop_gap}, tolerance {MESH_FLOP_TOL})")
        check(roof.bound_s <= step_s, f"mesh {name}: the roofline bound "
              f"{roof.bound_s} s exceeds the measured step {step_s} s")
        parts[name] = row

    # -- (a) qwen3-1.7b trained through assemble -----------------------------
    steps, bsz, seq = MESH_TRAIN
    cfg = get_config("qwen3-1.7b")
    shape = InputShape("mesh_train", seq, bsz, "train")
    tcfg = TrainConfig(steps=steps, batch_size=bsz, seq_len=seq,
                       log_every=0, seed=SEED)
    opt = partial(AdamW, lr=warmup_cosine(tcfg.lr, tcfg.warmup_steps,
                                          tcfg.steps))
    step = assemble(cfg, shape, mesh, opt=opt)
    api = build_model(step.cfg)
    plain = train(step.cfg, tcfg, params=api.init_params(SEED, dev),
                  device=dev, log_fn=lambda m: None)
    plain.final_params = None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fa_kernel.reset_counts()
    params = step.shard_params(api.init_params(SEED, dev, trainable=True))
    meshed = train(step.cfg, tcfg, jit_step=step, params=params, device=dev,
                   log_fn=lambda m: None)
    by_kernel = dict(fa_kernel.flash_attention_kernel.by_kernel)
    bwd = dict(fa_kernel.flash_attention_bwd_kernel.by_kernel)
    peak = torch.cuda.max_memory_allocated(dev)
    want = steps * step.cfg.num_layers * 2
    check(by_kernel == {"flash_fwd": 0, "flash_fwd_wgmma": want},
          f"mesh train: flash {by_kernel}, expected {want} calls on "
          "flash_fwd_wgmma")
    check(bwd == {"flash_bwd": 0, "flash_bwd_mma": want // 2},
          f"mesh train: flash backward {bwd}, expected {want // 2} calls "
          "on flash_bwd_mma")
    out["flash"]["train"] = by_kernel["flash_fwd_wgmma"]
    out["flash"]["train_backward"] = bwd["flash_bwd_mma"]
    same = meshed.losses == plain.losses
    check(same, f"mesh train: losses {meshed.losses} differ from train()'s "
          f"{plain.losses}")
    with FlopCounterMode(display=False) as fc:
        step(meshed.final_params, None,
             train_batch(step.cfg, bsz, seq, seed=SEED + steps, device=dev))
    costs, roof = predicted(cfg, shape, opt=opt)
    against("train", costs, roof, peak, fc.get_total_flops(),
            1.0 / meshed.steps_per_s, model=step.cfg.name,
            loss_chunk=step.cfg.loss_chunk, losses=meshed.losses,
            same_bits_as_train=same, flash_by_kernel=by_kernel,
            flash_bwd_by_kernel=bwd, shape=[bsz, seq], steps=steps)
    del meshed, params, step, api
    torch.cuda.empty_cache()

    # -- (b) deepseek-moe-16b prefill ----------------------------------------
    bsz, seq = MESH_PREFILL
    cfg = get_config("deepseek-moe-16b")
    shape = InputShape("mesh_prefill", seq, bsz, "prefill")
    step = assemble(cfg, shape, mesh)
    api = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    params = api.init_params(SEED, dev)
    batch = prefill_batch(cfg, bsz, seq, seed=SEED, device=dev)
    with torch.no_grad():
        want_logits, _ = api.prefill(params, batch, seq)
        fa_kernel.reset_counts()
        got, cache = step(params, batch)
        by_kernel = dict(fa_kernel.flash_attention_kernel.by_kernel)
        out["flash"]["prefill"] = by_kernel["flash_fwd_wgmma"]
        check(by_kernel == {"flash_fwd": 0,
                            "flash_fwd_wgmma": cfg.num_layers},
              f"mesh prefill: flash {by_kernel}, expected {cfg.num_layers} "
              "calls on flash_fwd_wgmma")
        check(torch.equal(got, want_logits), "mesh prefill: logits differ "
              f"from api.prefill (max {(got - want_logits).abs().max()})")
        del cache, got
        t0 = synced()
        step(params, batch)
        step_s = synced() - t0
        with FlopCounterMode(display=False) as fc:
            step(params, batch)
    peak = torch.cuda.max_memory_allocated(dev)
    costs, roof = predicted(cfg, shape)
    against("prefill", costs, roof, peak, fc.get_total_flops(), step_s,
            model=cfg.name, shape=[bsz, seq], same_bits_as_prefill=True)
    del params, batch, want_logits, step, api
    torch.cuda.empty_cache()

    # -- (c) zamba2-1.2b decode after a prefill ------------------------------
    bsz, seq = MESH_DECODE
    cfg = get_config("zamba2-1.2b")
    shape = InputShape("mesh_decode", seq + 8, bsz, "decode")
    step = assemble(cfg, shape, mesh)
    api = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    params = api.init_params(SEED, dev)
    token = {"token": torch.arange(1, bsz + 1, device=dev)[:, None]}
    with torch.no_grad():
        _, cache = api.prefill(params, prefill_batch(cfg, bsz, seq,
                                                     seed=SEED, device=dev),
                               seq + 8)
        mine = {k: (v.clone() if torch.is_tensor(v) else v)
                for k, v in cache.items()}
        want_logits, _ = api.decode_step(params, token, cache)
        got, mine = step(params, token, mine)
        check(torch.equal(got, want_logits), "mesh decode: logits differ "
              f"from decode_step (max {(got - want_logits).abs().max()})")
        times = []
        for _ in range(3):
            t0 = synced()
            step(params, token, mine)
            times.append(synced() - t0)
        with FlopCounterMode(display=False) as fc:
            step(params, token, mine)
    peak = torch.cuda.max_memory_allocated(dev)
    costs, roof = predicted(cfg, shape)
    against("decode", costs, roof, peak, fc.get_total_flops(),
            sorted(times)[1], model=cfg.name, shape=[bsz, seq],
            same_bits_as_decode_step=True)
    del params, cache, mine, step, api
    torch.cuda.empty_cache()

    # -- (d) the sharded decision sweep --------------------------------------
    t0 = synced()
    plan = decide_all_sharded(layers, envs, mesh=mesh)
    sweep_s = synced() - t0
    exact = dec.decide_all(layers, envs, backend="torch", device=envs.device)
    for f in ("splits", "total_time_s", "device_time_s", "transfer_time_s",
              "edge_time_s"):
        check(torch.equal(getattr(plan, f), getattr(exact, f)),
              f"decide_all_sharded(mesh=): {f} differs from backend='torch'")
    dist.destroy_process_group()
    line("mesh", mesh="nccl (1, 1) data x model", parts=list(parts),
         sweep_envs=len(envs), sweep_s=sweep_s, sweep_bit_for_bit=True,
         flash_launches=out["flash"], phase_s=time.perf_counter() - t_phase,
         device=smi)
    return out


def card_mesh_check(procs, out: str, smi: str, t_start: float) -> dict:
    """Join the 4-process card mesh of ``launch.card_mesh`` and hold each
    part to ``CARD_MESH_TOL`` and ``CARD_MESH_EXPECT``, part (a) to
    sequence parallelism and part c_mla_drops to ``CARD_MESH_DROP_MIN``;
    prints the ``mesh4`` line (errors, launches, heads, collective bytes,
    seconds).  Returns the parts' kernel launches."""
    from repro_torch.launch import card_mesh

    res = card_mesh.finish(procs, out, CARD_MESH_WAIT)
    launches = {}
    for part, (kernels, heads) in CARD_MESH_EXPECT.items():
        r = res["parts"][part]
        errs = {k: r[k] for k in ("loss", "grad", "logits") if k in r}
        bars = {k: CARD_MESH_GRAD_TOL if k == "grad" else CARD_MESH_TOL
                for k in errs}
        check(errs and all(v <= bars[k] for k, v in errs.items()),
              f"card mesh {part}: errors {errs} over {bars} "
              f"(worst gradients {r.get('grad_worst')})")
        missing = [k for k in kernels if r["launches"].get(k, 0) <= 0]
        check(not missing, f"card mesh {part}: no {missing} launched "
              f"({r['launches']})")
        for kind, want in heads.items():
            check(r["heads"][kind] == want, f"card mesh {part}: {kind} saw "
                  f"heads {r['heads'][kind]}, expected {want}")
        launches[part] = {k: v for k, v in r["launches"].items() if v}
    sp = res["parts"]["a_qwen3_sp"]
    check(sp["seq_parallel"] and sp["collectives"]["reduce-scatter"] > 0,
          f"card mesh a_qwen3_sp: not sequence parallel ({sp['seq_parallel']}"
          f", collective bytes {sp['collectives']})")
    drop = res["parts"]["c_mla_drops"]["drop_effect"]
    check(drop >= CARD_MESH_DROP_MIN, f"card mesh c_mla_drops: the whole "
          f"batch {drop} from the per-row reference, under "
          f"{CARD_MESH_DROP_MIN}: no capacity drop checked")
    line("mesh4", mesh="gloo (2, 2) data x model, 4 processes on one card",
         tolerance=CARD_MESH_TOL, grad_tolerance=CARD_MESH_GRAD_TOL,
         errors={p: {k: r[k] for k in ("loss", "grad", "logits") if k in r}
                 for p, r in res["parts"].items()},
         launches=launches, heads={p: r["heads"]
                                   for p, r in res["parts"].items()},
         drop_effect=drop,
         collectives={p: r["collectives"] for p, r in res["parts"].items()},
         part_s={p: r["seconds"] for p, r in res["parts"].items()},
         mesh_s=res["mesh_s"], one_process_s=res["one_process_s"],
         wall_s=time.perf_counter() - t_start, device=smi)
    return launches


def kernel_counts() -> dict:
    """Every kernel wrapper's launch count, the flash kernels, flash's
    launches storing the lse, flash's backward routes and the scans'
    forward and backward apart."""
    from repro_torch.kernels.decide_split import kernel as ds_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.fleet_scan import kernel as fs_kernel
    from repro_torch.kernels.gbt_hist import kernel as gh_kernel
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.kernels.tree_predict import kernel as tp_kernel
    return dict(decide_split=ds_kernel.decide_split_kernel.launches,
                tree_predict=tp_kernel.tree_predict_kernel.launches,
                gbt_hist=gh_kernel.level_histogram_kernel.launches,
                fleet_scan=fs_kernel.place_singletons_kernel.launches,
                **fa_kernel.flash_attention_kernel.by_kernel,
                flash_fwd_lse=fa_kernel.flash_attention_kernel.lse_launches,
                **fa_kernel.flash_attention_bwd_kernel.by_kernel,
                ssm_scan=ss_kernel.ssd_scan_kernel.launches,
                ssm_scan_bwd=ss_kernel.ssd_scan_bwd_kernel.launches,
                slstm_scan=sl_kernel.slstm_scan_kernel.launches,
                slstm_scan_bwd=sl_kernel.slstm_scan_bwd_kernel.launches)


def reset_kernel_counts() -> None:
    from repro_torch.kernels.decide_split import kernel as ds_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.fleet_scan import kernel as fs_kernel
    from repro_torch.kernels.gbt_hist import kernel as gh_kernel
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.kernels.tree_predict import kernel as tp_kernel
    for mod in (fa_kernel, fs_kernel, sl_kernel, ss_kernel, tp_kernel):
        mod.reset_counts()
    ds_kernel.decide_split_kernel.launches = 0
    gh_kernel.level_histogram_kernel.launches = 0


def masked_lines(text: str) -> list:
    """An example's printed lines with their host timing masked."""
    lines = text.splitlines()
    for pat in EXAMPLE_HOST_TIMING:
        lines = [re.sub(pat, "<host>", ln) for ln in lines]
    return lines


def examples_slice(dev, smi: str) -> dict:
    """The port's examples on the card (phase 14): each of
    ``EXAMPLE_RUNS`` through its ``main`` in this process, its standard
    output captured, the kernels' launches read after each (counts set to
    0 at the start), TF32 off.  Child processes started at the phase's
    start run on the CPU meanwhile: the pinned examples
    (``PINNED_EXAMPLES``), whose lines must equal the card's with host
    timing masked; ``train_tiny_lm``'s runs, whose losses the card's must
    follow step by step within ``EXAMPLE_LOSS_TOL``; and
    ``python -m repro_torch.launch.dryrun`` over the architectures dealt
    out to ``DRYRUN_CHILDREN`` (``DRYRUN_SKIP`` left out), whose records
    ``pod_scale_scheduling`` reads.  Then ``serve_batched``'s prefill
    logits of one batch, card against CPU on the same weights, within
    ``EXAMPLE_LOGIT_TOL``.  Returns the launches per run for the kernels
    line."""
    import contextlib
    import copy
    import importlib
    import io
    import os
    import subprocess

    import torch
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.examples import EXAMPLES

    check(sorted({name for name, _ in EXAMPLE_RUNS}) == sorted(EXAMPLES),
          "examples: EXAMPLE_RUNS does not run every example")
    t_phase = time.perf_counter()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_dir, cpu_dir = (ROOT / "results" / f"examples_{d}"
                         for d in ("card", "cpu"))
    for d in (card_dir, cpu_dir):
        (d / "results").mkdir(parents=True, exist_ok=True)
    dryrun = cpu_dir / "results" / "dryrun_torch.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    children = {}

    def start(tag, argv, out):
        with open(out, "w") as f:     # the child holds its own copy
            children[tag] = (subprocess.Popen(
                [sys.executable, *argv], cwd=cpu_dir, env=env, stdout=f,
                stderr=subprocess.STDOUT), out)

    def finish(tag, timeout):
        proc, out = children[tag]
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            fail(f"examples: the CPU child {tag} took over {timeout} s")
        text = Path(out).read_text()
        check(rc == 0, f"examples: the CPU child {tag} exited {rc}: "
              f"{text[-2000:]}")
        return text

    def example(name, *argv):
        return ["-m", f"repro_torch.examples.{name}", "--device", "cpu",
                *argv, *EXAMPLE_FLAGS.get(name, ())]

    archs = [a for a in ARCH_NAMES if a not in DRYRUN_SKIP]
    trained = [" ".join((name, *argv)) for name, argv in EXAMPLE_RUNS
               if name == "train_tiny_lm"]
    card_out = {}
    try:
        for i in range(DRYRUN_CHILDREN):
            start(f"dryrun{i}", ["-m", "repro_torch.launch.dryrun",
                                 *(f for a in archs[i::DRYRUN_CHILDREN]
                                   for f in ("--arch", a)),
                                 "--out", str(cpu_dir / f"dry{i}.json")],
                  cpu_dir / f"dryrun{i}.log")
        for name in PINNED_EXAMPLES[:-1]:
            start(name, example(name), cpu_dir / f"{name}.out")
        for i, (name, argv) in enumerate(
                r for r in EXAMPLE_RUNS if r[0] == "train_tiny_lm"):
            start(trained[i], example(name, *argv, "--losses-out",
                                      str(cpu_dir / f"losses{i}.json")),
                  cpu_dir / f"train{i}.out")
        reset_kernel_counts()
        seconds, launches = {}, {}
        before = kernel_counts()
        cwd = os.getcwd()
        os.chdir(card_dir)
        try:
            for name, argv in EXAMPLE_RUNS:
                label = " ".join((name, *argv))
                argv = (*argv, *EXAMPLE_FLAGS.get(name, ()))
                if name == "train_tiny_lm":
                    argv = (*argv, "--losses-out", str(
                        card_dir / f"losses{trained.index(label)}.json"))
                if name == "pod_scale_scheduling":
                    # the dry-run's records, in ARCH_NAMES order
                    recs = []
                    for i in range(DRYRUN_CHILDREN):
                        finish(f"dryrun{i}", 600)
                        recs += json.loads(
                            (cpu_dir / f"dry{i}.json").read_text())
                    records = [r for a in archs for r in recs
                               if r["arch"] == a]
                    dryrun.write_text(json.dumps(records))
                    start(name, example(name, "--dryrun", str(dryrun)),
                          cpu_dir / f"{name}.out")
                    argv = (*argv, "--dryrun", str(dryrun))
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    importlib.import_module(
                        f"repro_torch.examples.{name}").main(list(argv))
                torch.cuda.synchronize(dev)
                seconds[label] = time.perf_counter() - t0
                after = kernel_counts()
                launches[label] = {k: after[k] - before[k] for k in after
                                   if after[k] > before[k]}
                before = after
                card_out[label] = buf.getvalue()
                line("example", run=label, seconds=seconds[label],
                     launches=launches[label],
                     lines=len(card_out[label].splitlines()),
                     tail=card_out[label].splitlines()[-3:])
        finally:
            os.chdir(cwd)
        # the pinned results: the card's lines are the CPU's
        pinned = {}
        for name in PINNED_EXAMPLES:
            cpu, card_lines = (masked_lines(finish(name, 600)),
                               masked_lines(card_out[name]))
            diff = [(a, b) for a, b in zip(card_lines, cpu) if a != b]
            check(len(card_lines) == len(cpu) and not diff,
                  f"examples: {name} on the card differs from --device "
                  f"cpu: {diff[:3]} ({len(card_lines)} vs {len(cpu)} "
                  "lines)")
            pinned[name] = len(cpu)
        # the training runs: the card's losses follow the CPU's
        losses = {}
        for i, label in enumerate(trained):
            finish(label, 600)
            card_l, cpu_l = (json.loads((d / f"losses{i}.json").read_text())
                             for d in (card_dir, cpu_dir))
            check(len(card_l) == len(cpu_l), f"examples: {label}: "
                  f"{len(card_l)} card steps, {len(cpu_l)} CPU steps")
            gaps = [abs(c - w) / abs(w) for c, w in zip(card_l, cpu_l)]
            worst = max(range(len(gaps)), key=gaps.__getitem__)
            losses[label] = dict(card=card_l, cpu=cpu_l,
                                 max_rel_gap=gaps[worst], worst_step=worst)
            check(gaps[worst] <= EXAMPLE_LOSS_TOL, f"examples: {label}: "
                  f"the card's loss at step {worst} is {card_l[worst]}, "
                  f"the CPU's {cpu_l[worst]} (relative gap {gaps[worst]}, "
                  f"tolerance {EXAMPLE_LOSS_TOL})")
    finally:
        for proc, _ in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    # serve_batched's first prefill, card against CPU on the same weights
    sb = importlib.import_module("repro_torch.examples.serve_batched")
    card_engine, cpu_engine = sb.build_engine(dev), sb.build_engine("cpu")
    cpu_engine.load_params(copy.deepcopy(card_engine.params).to("cpu"))
    reqs = sb.make_requests(card_engine.cfg.vocab_size)
    got = sb.prefill_logits(card_engine, reqs).cpu()
    want = sb.prefill_logits(cpu_engine, reqs)
    check(got.shape == want.shape, f"examples: serve_batched prefill "
          f"logits {tuple(got.shape)} on the card, {tuple(want.shape)} on "
          "the CPU")
    logit_err = ((got - want).abs().max() / want.abs().max()).item()
    check(logit_err <= EXAMPLE_LOGIT_TOL, f"examples: serve_batched prefill "
          f"logits off by {logit_err} of max |logit| (tolerance "
          f"{EXAMPLE_LOGIT_TOL})")
    del card_engine, cpu_engine
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        flags
    total = {}
    for per in launches.values():
        for k, n in per.items():
            total[k] = total.get(k, 0) + n
    for label, kernels in EXAMPLE_EXPECT.items():
        for k in kernels:
            check(launches[label].get(k, 0) > 0, f"examples: {label} "
                  f"launched no {k} ({launches[label]})")
    n_loo = int(re.search(r"over (\d+) workloads",
                          card_out["pod_scale_scheduling"]).group(1))
    for label, rec in losses.items():
        line("example_losses", run=label, **rec,
             tolerance=f"{EXAMPLE_LOSS_TOL} relative, each step")
    line("examples", seconds=seconds, launches=total,
         pinned_lines=pinned, dryrun_records=len(records),
         dryrun_skipped_archs=list(DRYRUN_SKIP), loo_workloads=n_loo,
         loss_gaps={k: r["max_rel_gap"] for k, r in losses.items()},
         prefill_logit_err=logit_err,
         prefill_logit_tolerance=f"{EXAMPLE_LOGIT_TOL} of max |logit|",
         phase_s=time.perf_counter() - t_phase, device=smi)
    return launches


def bench_slice(dev, smi: str, profiled) -> dict:
    """The port's benches on the card (phase 15): each module of
    ``repro_torch.bench`` (``BENCH_EXPECT``) through its ``main`` or, for
    the figure sweeps, its row functions at ``BENCH_FIG2A`` /
    ``BENCH_FIG2B``; the profiling benches on phase 3's records.  Each
    module holds its gates and fails a card row whose kernel was not
    launched; here every bench's rows must between them launch the kernels
    of ``BENCH_EXPECT``.  Writes the ``bench`` line (rows, seconds and
    launches per bench) and returns the launches per kernel."""
    import collections

    from repro_torch.bench import (contention, decisions, fig2a_mlp,
                                   fig2b_gbt, fig3_predictions, fl, fleet,
                                   offload, oracle, scheduler, serving,
                                   stream)
    from repro_torch.bench.common import GateBroken, emit

    data = profiled[1]

    def fig2a():
        rows = fig2a_mlp.mlp_rows(data, BENCH_FIG2A, 150, "card", dev)
        emit(rows, "fig2a_mlp")
        return rows

    def fig2b():
        rows = fig2b_gbt.gbt_rows(data, BENCH_FIG2B, "kernel", dev)
        emit(rows, "fig2b_gbt")
        return rows

    def fig3():
        rows = [fig3_predictions.fig3_row(data, "kernel", dev)]
        emit(rows, "fig3_predictions")
        return rows

    runs = {
        "decisions": lambda: decisions.main(smoke=True),
        "decisions_cost": lambda: decisions.main_costs("all", smoke=True),
        "decisions_backend": lambda: decisions.main_backends(
            "all", smoke=True),
        "oracle": lambda: oracle.main(smoke=True),
        "stream": lambda: stream.main(smoke=True),
        "fleet": lambda: fleet.main(smoke=True),
        "contention": lambda: contention.main(smoke=True),
        "scheduler": scheduler.main,
        "offload": lambda: offload.main(dataset=profiled),
        "fl": lambda: fl.main(dataset=profiled),
        "serving": serving.main,
        "fig2a_mlp": fig2a, "fig2b_gbt": fig2b, "fig3_predictions": fig3}
    check(set(runs) == set(BENCH_EXPECT), f"benches {sorted(runs)}")
    t_phase = time.perf_counter()
    out, total, broken = {}, collections.Counter(), {}
    for name, run in runs.items():
        t0 = time.perf_counter()
        try:
            rows = run()
        except GateBroken as e:
            check(name in BENCH_BROKEN and all(
                g.startswith(BENCH_BROKEN[name]) for g in e.gates),
                f"bench {name}: gate failed: {e}")
            rows, broken[name] = e.rows, e.gates
            print(json.dumps({"gate_broken": name, "gates": e.gates,
                              "logged": "ROADMAP.md section 3"}),
                  flush=True)
        seconds = time.perf_counter() - t0
        launched = collections.Counter()
        for r in rows:
            if "card" in r:
                check(r["card"] == smi and isinstance(r.get("launches"),
                                                      dict),
                      f"bench {name}: card row {r['name']} without the "
                      "card or its launches")
                launched.update(r["launches"])
            else:
                check(r.get("plain") is True, f"bench {name}: row "
                      f"{r['name']} is neither a CPU nor a card row")
        missing = [k for k in BENCH_EXPECT[name] if launched[k] <= 0]
        check(not missing, f"bench {name}: its rows launched no "
              f"{missing} ({dict(launched)})")
        out[name] = dict(rows=len(rows), seconds=seconds,
                         card_rows=sum("card" in r for r in rows),
                         launches=dict(launched))
        total.update(launched)
        print(json.dumps({"bench_done": name, **out[name]}), flush=True)
    line("bench", benches=out, launches=dict(total), gates_broken=broken,
         phase_s=time.perf_counter() - t_phase, device=smi)
    return dict(total)


def start_perf_children() -> list:
    """Phase 16's §Perf experiments: one CPU child of ``python -m
    repro_torch.bench.perf_experiments`` per group of ``PERF_PAIRS``, on
    meta tensors (``CUDA_VISIBLE_DEVICES=""``, one thread), started with
    phase 14's children.  Returns ``[(pairs, process, records, log)]``."""
    import os
    import subprocess

    out_dir = ROOT / "results" / "perf_cpu"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    children = []
    for i, pairs in enumerate(PERF_PAIRS):
        recs, log = out_dir / f"perf{i}.json", out_dir / f"perf{i}.log"
        with open(log, "w") as f:     # the child holds its own copy
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.bench.perf_experiments",
                 "--pairs", pairs, "--out", str(recs)], cwd=ROOT, env=env,
                stdout=f, stderr=subprocess.STDOUT)
        children.append((pairs, proc, recs, log))
    return children


def stop_children(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def collate_slice(dev, smi: str, profiled, perf_children) -> None:
    """The collating benches (phase 16), each on what the phases before
    wrote: ``bench.roofline`` over phase 14's dry-run records (every ok
    row's bound above 0, its dominant term the largest);
    ``bench.perf_experiments`` from the CPU children of
    :func:`start_perf_children` (every experiment ok, A1's compute term
    below ``ABSORB_MAX`` of A0's), merged into
    ``results/perf_experiments_torch.json``; ``bench.report`` over phase
    15's rows (a headline for each of the five subsystems, each naming
    where its row ran: the card's ``nvidia-smi`` line, or ``cpu`` for a
    host-only row); ``bench.write_experiments`` from all of them and phase
    3's records (every section, none of the reference's TPU figures); and
    ``python -m repro_torch.bench.run scheduler`` in a child on the card
    meanwhile (exit 0, its header and rows).  Prints the ``perf`` and
    ``collate`` lines."""
    import os
    import subprocess

    from repro_torch.bench import common as bcommon
    from repro_torch.bench import perf_experiments as pe
    from repro_torch.bench import report, roofline
    from repro_torch.bench import write_experiments as wx
    from repro_torch.core.dataset import save_records

    t_phase = time.perf_counter()
    results = Path(bcommon.RESULTS_DIR)
    seconds = {}
    run_log = results / "bench_run_scheduler.log"
    t_run = time.perf_counter()
    with open(run_log, "w") as f:
        run_child = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.bench.run", "scheduler"],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            stdout=f, stderr=subprocess.STDOUT)
    try:
        # (a) the roofline table of phase 14's dry-run
        t0 = time.perf_counter()
        dry = ROOT / "results" / "examples_cpu" / "results" / \
            roofline.DRYRUN_NAME
        recs = json.loads(dry.read_text())
        rows = roofline.main(str(dry), device=dev)
        ok_rows = [r for r in rows if "status" not in r]
        check(len(rows) == len(recs) and ok_rows and len(ok_rows) == sum(
            r["status"] == "ok" for r in recs),
            f"roofline: {len(rows)} rows, {len(ok_rows)} ok, of "
            f"{len(recs)} records")
        for r in ok_rows:
            terms = {k: r[f"{k}_s"] for k in ("compute", "memory",
                                              "collective")}
            check(r["us_per_call"] > 0
                  and r["dominant"] == max(terms, key=terms.get),
                  f"roofline: {r['name']} bound {r['us_per_call']} us, "
                  f"dominant {r['dominant']}, terms {terms}")
        seconds["roofline"] = time.perf_counter() - t0
        # (b) the perf experiments, from the CPU children
        t0 = time.perf_counter()
        perf, run_s = [], {}
        for pairs, proc, out, log in perf_children:
            try:
                rc = proc.wait(timeout=max(
                    1.0, PERF_WAIT - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                fail(f"perf: the CPU child of pairs {pairs} took over "
                     f"{PERF_WAIT} s of phase 16")
            check(rc == 0, f"perf: the CPU child of pairs {pairs} exited "
                  f"{rc}: {log.read_text()[-2000:]}")
            group = json.loads(out.read_text())
            run_s[pairs] = sum(r.get("run_s", 0.0) for r in group)
            perf += group
        order = [e["name"] for e in pe.EXPERIMENTS]
        perf.sort(key=lambda r: order.index(r["experiment"]))
        perf_path = results / pe.OUT_NAME
        perf_path.write_text(json.dumps(perf, indent=1))
        by = {r["experiment"]: r for r in perf}
        failed = [n for n, r in by.items() if r["status"] != "ok"]
        check(not failed, f"perf: {failed} failed: "
              f"{[by[n].get('error') for n in failed]}")
        for r in perf:
            line("perf", experiment=r["experiment"],
                 terms_s={k: r["roofline"][k] for k in (
                     "compute_s", "memory_s", "collective_s")},
                 dominant=r["roofline"]["dominant"],
                 bytes_per_device=r["bytes_per_device"],
                 vs_baseline=r["vs_baseline"], verdict=r["verdict"],
                 predicts=r.get("predicts"), run_s=r["run_s"])
        absorb = by["A1_mla_absorbed"]["roofline"]["compute_s"] / \
            by["A0_baseline_mla_naive"]["roofline"]["compute_s"]
        check(absorb < ABSORB_MAX, f"perf: A1's compute term is {absorb} "
              f"of A0's (must stay below {ABSORB_MAX})")
        seconds["perf_experiments_wait"] = time.perf_counter() - t0
        # (c) the report of phase 15's rows
        t0 = time.perf_counter()
        entries = report.main(["--out", str(results / "report_torch.md")])
        check(sorted(e["subsystem"] for e in entries) == sorted(
            s for s, _ in report.SUBSYSTEMS.values()),
            f"report: headlines {[e['subsystem'] for e in entries]}")
        for e in entries:
            head = next(r for r in json.loads(
                (results / f"{e['bench']}.json").read_text())
                if r["name"] == e["config"])
            check(e["card"] == smi if "card" in head
                  else e["card"] == "cpu" and head.get("plain") is True,
                  f"report: {e['subsystem']}'s headline {e['config']} "
                  f"reads card {e['card']!r}")
        seconds["report"] = time.perf_counter() - t0
        # (d) the EXPERIMENTS document from all of them
        t0 = time.perf_counter()
        save_records(profiled[0], str(results / bcommon.RECORDS_NAME))
        doc_path = wx.main(["--dryrun", str(dry), "--perf", str(perf_path)])
        doc = Path(doc_path).read_text()
        check(Path(doc_path) == results / wx.OUT_NAME,
              f"write_experiments wrote {doc_path}")
        missing = [h for h in EXPERIMENTS_HEADINGS if h not in doc]
        stated = [f for f in TPU_FIGURES if f in doc]
        check(not missing and not stated, f"write_experiments: sections "
              f"{missing} missing, TPU figures {stated} stated")
        seconds["write_experiments"] = time.perf_counter() - t0
        # (e) the orchestrator's child on the card
        try:
            rc = run_child.wait(timeout=300)
        except subprocess.TimeoutExpired:
            fail("bench.run scheduler took over 300 s")
        seconds["run_scheduler"] = time.perf_counter() - t_run
        text = run_log.read_text()
        check(rc == 0 and "# === scheduler (paper §II-D) ===" in text
              and "# --- scheduler (paper §II-D) done in " in text
              and "sched_min_min," in text,
              f"bench.run scheduler exited {rc}: {text[-2000:]}")
    finally:
        stop_children([run_child])
    line("collate", seconds=seconds, perf_run_s=run_s,
         perf_pairs=[p for p, *_ in perf_children],
         roofline_rows=len(rows), roofline_ok=len(ok_rows),
         a1_over_a0_compute=absorb,
         verdicts={r["experiment"]: r["verdict"] for r in perf},
         headlines={e["subsystem"]: [e["config"], e["speedup"], e["card"]]
                    for e in entries},
         document=str(doc_path), document_lines=len(doc.splitlines()),
         run_lines=len(text.splitlines()),
         phase_s=time.perf_counter() - t_phase, device=smi)


def kernel_bench() -> list:
    """``repro_torch.bench.kernels.main()`` on the card: every row within
    its tolerance, ``int8_matmul`` launched on it, the prefill row on
    ``w8a16_wgmma`` and the rest on ``w8a16_mma``; returns the
    ``int8_matmul`` record (decode B 4, the prefill row beside it) for the
    kernels line."""
    import torch
    from repro_torch.bench import kernels as bench
    from repro_torch.kernels.int8_matmul import kernel as q_kernel

    torch.backends.cuda.matmul.allow_tf32 = False     # the plain f32 product
    q_kernel.reset_counts()
    t0 = time.perf_counter()
    rows = bench.main()
    bench_s = time.perf_counter() - t0
    counted = q_kernel.int8_matmul_kernel.launches
    by_route = dict(q_kernel.int8_matmul_kernel.by_route)
    int8 = [r for r in rows if r["name"] == "int8_matmul"]
    for r in rows:
        line("bench_row", **r)
        check(r["err_over_tol"] < 1.0, f"bench {r['name']} {r['case']}: off "
              f"by {r['err_over_tol']} of its tolerance ({r['tolerance']})")
    # one comparison call per row, the rest timed on the bench's path
    launches = counted - len(int8)
    check(launches == sum(r["launches"] for r in int8) and launches > 0,
          f"int8_matmul launched {counted} times in the bench, rows say "
          f"{[r['launches'] for r in int8]} + {len(int8)} comparisons")
    # the prefill on the wgmma kernel, decode and the LM head on mma.sync
    for r in int8:
        want = "w8a16_wgmma" if r["case"] == "prefill" else "w8a16_mma"
        check(r["routes"] == {want: r["launches"]},
              f"int8_matmul {r['case']}: launches per kernel {r['routes']}, "
              f"expected all {r['launches']} on {want}")
    line("kernel_bench", seconds=bench_s, rows=len(rows),
         int8_matmul_launches=launches, int8_matmul_by_route=by_route)
    # w8a16_wgmma's first pass, the weight in fragment order, against its
    # plain version at the prefill's weight: equal byte for byte
    from repro_torch.kernels.int8_matmul import ref as q_ref
    m, k, n = bench.INT8_SHAPES[-1][1:]
    w_q, _ = q_ref.quantize(torch.randn(
        (k, n), generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda"))
    same = torch.equal(q_kernel.pack_fragments_kernel(w_q).cpu(),
                       q_ref.pack_fragments(w_q.cpu()))
    line("kernel_check", kernel="int8_matmul.pack_fragments", shape=[k, n],
         exact=same)
    check(same, "int8_matmul: the weight in fragment order differs from "
          "ref.pack_fragments")
    head = next(r for r in int8 if r["case"] == "decode_b4")
    pre = next(r for r in int8 if r["case"] == "prefill")
    return [{"name": "int8_matmul", "route": "cuda",
             "source": "src/repro_torch/csrc/int8_matmul.cu",
             "replaces": "src/repro/kernels/int8_matmul/kernel.py:41",
             "launches": launches, "max_abs_err": head["max_abs_err"],
             "ms": head["us_per_call"] / 1e3,
             "plain_ms": head["plain_us"] / 1e3,
             "bound_ms": head["bound_us"] / 1e3,
             "bound_by": head["bound_by"],
             "library_ms": head["library_us"] / 1e3, "shape": head["shape"],
             "err_over_tol": head["err_over_tol"],
             "kernel": "w8a16_mma",
             "prefill": {"kernel": "w8a16_wgmma", "shape": pre["shape"],
                         "ms": pre["us_per_call"] / 1e3,
                         "plain_ms": pre["plain_us"] / 1e3,
                         "library_ms": pre["library_us"] / 1e3,
                         "bound_ms": pre["bound_us"] / 1e3,
                         "bound_by": pre["bound_by"],
                         "launches": pre["launches"],
                         "max_abs_err": pre["max_abs_err"],
                         "err_over_tol": pre["err_over_tol"]}}]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT / 'src' / 'repro_torch'} is missing: run from a "
             "checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import configs
    from repro_torch.bench.common import bound, card, timed_ms
    from repro_torch.bench.kernels import (WIDEST_LEVEL, decide_split_case,
                                           decide_split_row, gbt_hist_work,
                                           tree_predict_row)
    from repro_torch.core import costs as co
    from repro_torch.core import decisions as dec
    from repro_torch.core import offload as off
    from repro_torch.core.predictors.gbt import GBTRegressor
    from repro_torch.hw import EDGE_DEVICES, get_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.decide_split import kernel as ds_kernel
    from repro_torch.kernels.decide_split import ops as ds_ops
    from repro_torch.kernels.decide_split import ref as ds_ref
    from repro_torch.kernels.gbt_hist import kernel as gh_kernel
    from repro_torch.kernels.gbt_hist import ops as gh_ops
    from repro_torch.kernels.gbt_hist import ref as gh_ref
    from repro_torch.kernels.tree_predict import kernel as tp_kernel
    from repro_torch.kernels.tree_predict import ref as tp_ref

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- 1. environment -----------------------------------------------------
    smi = card()
    print(smi, flush=True)
    line("environment", python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda, device=kind,
         device_count=torch.cuda.device_count())
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    # flash_fwd_wgmma at (D, Dv) = (64, 64), (96, 96), (128, 128),
    # (192, 128) and (256, 256), each without and with the lse store
    wgmma = {"flash_fwd_wgmma": ("flash_attention", 10),
             "w8a16_wgmma": ("int8_matmul", 1)}
    wgmma_ptxas = {k: [] for k in wgmma}
    # the scans' instances that keep their state in registers: fleet_scan's
    # registers route at 1-8 nodes a lane, slstm_scan's cluster route at
    # 2 R dtypes × 2 h dtypes; and the scans' backward kernels: the SSD's
    # chain and chunks (each with float4 rows or not), the sLSTM's cluster
    # route at 2 R dtypes × R's rows in registers (4 or 8 rows a thread)
    # or shared memory and its block route at 2 R dtypes; the flash
    # backward's tensor-core kernels at its 5 (D, Dv); none may touch
    # local memory
    frames = {"singleton_scan_registers": ("fleet_scan", 8),
              "slstm_scan_cluster": ("slstm_scan", 4),
              "ssd_bwd_chain": ("ssm_scan", 2),
              "ssd_bwd_chunk": ("ssm_scan", 2),
              "slstm_bwd_cluster": ("slstm_scan", 6),
              "slstm_bwd_block": ("slstm_scan", 2),
              "flash_bwd_dkdv_mma": ("flash_attention_bwd", 5),
              "flash_bwd_dq_mma": ("flash_attention_bwd", 5)}
    frame_lines = {k: [] for k in frames}
    for name, log in logs.items():
        entry = name          # a source may hold several kernels
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1]
            elif ("registers" in ln or "spill" in ln or "smem" in ln
                  or "warning" in ln):
                print(f"ptxas {name} {entry}: {ln.strip()}")
                for k in wgmma:
                    if k in entry:
                        wgmma_ptxas[k].append(ln.strip())
                for k in frames:
                    if k in entry and "stack frame" in ln:
                        frame_lines[k].append(ln.strip())
    for k, (source, instances) in frames.items():
        check(source not in logs or (
                  len(frame_lines[k]) == instances
                  and all(re.fullmatch(r"0 bytes stack frame, 0 bytes spill "
                                       r"stores, 0 bytes spill loads", ln)
                          for ln in frame_lines[k])),
              f"{k}: local memory (stack or spills) in an instance, or not "
              f"one line per instance ({frame_lines[k]})")
        line(f"{k}_build", ptxas=frame_lines[k])
    line("build", seconds=build_s, compiled=sorted(logs))
    for k, (source, instances) in wgmma.items():
        sass = hopper_sass(_build, source, k, instances)
        line(f"{k}_build", sass=sass, ptxas=wgmma_ptxas[k])
        # A registers (w8a16_wgmma's widened weight, flash_fwd_wgmma's P)
        # kept until the wait that retires their wgmma
        check(all(c["inflight_a_writes"] == 0 for c in sass.values()),
              f"{k}: SASS writes the A registers of an in-flight wgmma "
              f"({sass})")
        # built in this run (a fresh checkout): every instance's spill
        # line, and no spills
        spills = [ln for ln in wgmma_ptxas[k] if "spill" in ln]
        check(source not in logs or (len(spills) == instances and not any(
                  int(n) for ln in spills
                  for n in re.findall(r"(\d+) bytes spill", ln))),
              f"{k}: ptxas spills, or not one spill line per instance "
              f"({spills})")

    wrappers = {"gbt_hist": gh_kernel.level_histogram_kernel,
                "tree_predict": tp_kernel.tree_predict_kernel,
                "decide_split": ds_kernel.decide_split_kernel}

    # -- 2. the decision slice at full width -------------------------------
    feats, times = [], []
    for name in configs.ARCH_NAMES:
        cfg = configs.get_config(name)
        for seq in (128, 512, 2048, 8192):
            for batch in (1, 4, 16):
                layers = off.transformer_layer_costs(cfg, seq, batch)
                for spec in EDGE_DEVICES.values():
                    feats.append(co.default_layer_features(layers, spec))
                    times.append([off.layer_time(lc.flops, spec)
                                  for lc in layers])
    x, y = np.concatenate(feats), np.concatenate(times)
    line("training_set", rows=int(x.shape[0]), features=int(x.shape[1]))

    qwen = configs.get_config("qwen3-1.7b")
    layers = off.transformer_layer_costs(qwen, seq_len=4096, batch_size=1)
    check(len(layers) == 28 and qwen.d_model == 2048,
          "qwen3-1.7b is not at its published shape")
    pi5, a100 = get_device("pi5-arm"), get_device("edge-server-a100")
    bw = np.geomspace(1e5, 1e10, N_ENVS)
    fleet = [get_device(n) for n in ("xps15-i5", "gtx-1650", "pi5-arm",
                                     "jetson-orin-nano")]
    gbt_kw = dict(n_trees=200, max_depth=12, subsample=0.8, n_bins=64,
                  seed=SEED)

    # a fit's levels as it hands them to the kernel, kept for phases 8 and
    # 9 (references only): its first root, and its level with the most
    # nodes; phase 2's fit under "root" / "widest", phase 3's under
    # "profiling_root" / "profiling_widest", phase 4's refits (the first
    # refit's root, the widest level of any) under "oracle_refit_root" /
    # "oracle_refit_widest"
    levels, launch_level = {}, gh_ops.level_histogram_kernel

    def recorder(tag: str):
        def recorded(*args):
            args, k = args[:4], args[3].numel() - 1     # n_bins is 64
            levels.setdefault(f"{tag}root", args)
            wide = f"{tag}widest"
            if wide not in levels or k > levels[wide][3].numel() - 1:
                levels[wide] = args
            return launch_level(*args, 64)
        return recorded

    for w in wrappers.values():
        w.launches = 0
    tp_kernel.reset_counts()
    gh_ops.level_histogram_kernel = recorder("")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gbt = GBTRegressor(**gbt_kw).fit(x, y, device=dev)
    torch.cuda.synchronize()
    t_fit = time.perf_counter()
    gh_ops.level_histogram_kernel = launch_level
    envs = dec.make_envs(pi5, a100, link_bw=bw, link_latency_s=0.005,
                         input_bytes=4 * 4096, device=dev)
    pcost = co.PredictorCost(gbt, pi5, a100)
    plan_p = dec.decide_all(layers, envs, cost=pcost)
    torch.cuda.synchronize()
    t_decide = time.perf_counter()
    ccost = co.CompositeCost(base=co.PredictorCost(gbt, pi5, a100),
                             weights={"latency_s": 1.0, "energy_j": 0.05})
    plan_c = dec.decide_all(layers, envs, cost=ccost)
    envs_mix = dec.make_envs([fleet[i % 4] for i in range(N_ENVS)], a100,
                             link_bw=bw, link_latency_s=0.005,
                             input_bytes=4 * 4096, device=dev)
    plan_a = dec.decide_all(layers, envs_mix)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {k: w.launches for k, w in wrappers.items()}
    tp_by_kernel = dict(tp_kernel.tree_predict_kernel.by_kernel)
    print(json.dumps({"launch_counts": launches,
                      "tree_predict_by_kernel": tp_by_kernel}), flush=True)
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
    # every call: one descent, its trees in shared memory, then the fold
    check(tp_by_kernel == {"descend_shared": launches["tree_predict"],
                           "descend_global": 0,
                           "fold": launches["tree_predict"]},
          f"tree_predict launches per kernel {tp_by_kernel}, expected "
          f"{launches['tree_predict']} descend_shared and fold")
    # one histogram launch per level of each tree, none per node
    most = gbt_kw["n_trees"] * gbt_kw["max_depth"]
    check(launches["gbt_hist"] <= most, f"gbt_hist launched "
          f"{launches['gbt_hist']} times in the fit, at most {most} expected")
    line("e2e", fit_s=t_fit - t0, predict_and_decide_s=t_decide - t_fit,
         fit_predict_decide_s=t_decide - t0,
         composite_and_fleet_decide_s=t_end - t_decide,
         n_envs=N_ENVS, n_layers=len(layers))
    fit_split(gbt, gbt_kw, x, y, dev)

    # every plan: finite, right shape, near-optimal against exact f64
    for name, plan, cost, e in (("predictor", plan_p, pcost, envs),
                                ("composite", plan_c, ccost, envs),
                                ("analytic_fleet", plan_a, None, envs_mix)):
        exact = dec.decide_all(layers, e, cost=cost, backend="torch")
        check(plan.splits.shape == (N_ENVS,), f"{name}: plan shape")
        check(bool(((plan.splits >= 0) & (plan.splits <= len(layers)))
                   .all()), f"{name}: split out of range")
        check(bool(torch.isfinite(plan.total_time_s).all()),
              f"{name}: non-finite latency")
        got = plan.total_time_s if plan.scalar_cost is None \
            else plan.scalar_cost
        ref = exact.total_time_s if exact.scalar_cost is None \
            else exact.scalar_cost
        gap = (got - ref) / ref
        check(bool((got <= ref * (1 + 1e-4) + 1e-12).all()),
              f"{name}: a kernel split is worse than the f64 optimum by "
              f"more than 1e-4 (max {gap.max().item()})")
        line("plan_check", plan=name,
             split_match_share=(plan.splits == exact.splits).double()
             .mean().item(), max_rel_gap=gap.max().item(),
             distinct_splits=int(torch.unique(plan.splits).numel()))
        del exact

    # -- 3. the profiling loop at full width ------------------------------
    profiling_launches, profiled = profiling_slice(
        dev, wrappers, recorder, x, y, layers, envs, pi5, a100)

    # -- 4. the oracle loop and the streaming simulator -------------------
    oracle_launches, oracle_shapes, oracle_traced = oracle_slice(
        dev, wrappers, recorder, bw, pi5, a100)

    # -- 5. the queueing, Pareto and fleet slice --------------------------
    fleet_launches, fleet_shapes = fleet_slice(dev)

    # -- 6. the serving slice at full width -------------------------------
    serve_launches = serve_slice(dev, smi)

    # -- 6b. continuous batching at full width, a split per admission ------
    serve_launches["continuous"] = continuous_slice(dev, smi)

    # -- 7. the whole model on the card -----------------------------------
    model_check(dev)
    continuous_f32_check(dev)

    # -- 8. kernels against their plain versions ---------------------------
    records = {}

    # gbt_hist at two levels of each fit as the fit called them: the first
    # root (its most rows) and the level with the most nodes; the plain
    # version on a CPU copy adds in np.bincount's order, as the kernel does:
    # exactly equal (the card's torch.bincount uses atomics)
    level_shape, level_err = {}, []
    for case in levels:
        args = levels[case]
        gsum, cnt = gh_kernel.level_histogram_kernel(*args, 64)
        torch.cuda.synchronize()
        pg, pc = gh_ref.level_histogram_ref(*(t.cpu() for t in args), 64)
        gsum, cnt = gsum.cpu(), cnt.cpu()
        check(torch.equal(cnt.double(), pc), f"gbt_hist {case}: counts "
              "differ")
        check(torch.equal(gsum, pg), f"gbt_hist {case}: sums differ from "
              f"the plain version's (max {(gsum - pg).abs().max().item()}; "
              "tolerance: exact)")
        level_shape[case] = [args[2].numel(), args[0].shape[1], 64,
                             args[3].numel() - 1]
        level_err.append((gsum - pg).abs().max().item())
        line("kernel_check", kernel="gbt_hist", level=case,
             rows=level_shape[case][0], nodes=level_shape[case][3],
             counts_exact=True, sums_exact=True, max_abs_err=level_err[-1])
    records["gbt_hist"] = dict(max_abs_err=max(level_err),
                               shape=level_shape["root"])
    # the kernel bench's widest_level row times this level's node sizes;
    # their order within the level differs between numpy builds (2.0, 2.3)
    offs = levels["widest"][3].cpu()
    check(sorted((offs[1:] - offs[:-1]).tolist()) == sorted(WIDEST_LEVEL),
          "the fit's widest level has other node sizes than "
          "bench.kernels.WIDEST_LEVEL")

    # the card's fit against the same fit on the CPU: the same histograms
    # and the same host growth code, so the same node arrays, bit for bit
    t0 = time.perf_counter()
    gbt_plain = GBTRegressor(**gbt_kw).fit(x, y, device="cpu")
    plain_fit_s = time.perf_counter() - t0
    pk = gbt.predict(x, device=dev).cpu().numpy()
    pp = gbt_plain.predict(x, device="cpu").numpy()
    span = float(y.max() - y.min())
    rel = float(np.sqrt(np.mean((pk - pp) ** 2)) / span)
    rmse_k = float(np.sqrt(np.mean((pk - y) ** 2)))
    rmse_p = float(np.sqrt(np.mean((pp - y) ** 2)))
    same = sum(len(a) == len(b) and all(
        (n.feature, n.threshold_bin) == (m.feature, m.threshold_bin)
        for n, m in zip(a, b)) for a, b in zip(gbt.trees_, gbt_plain.trees_))
    fa, fp = tp_ref.flatten_gbt(gbt), tp_ref.flatten_gbt(gbt_plain)
    equal_arrays = {f: bool(np.array_equal(getattr(fa, f), getattr(fp, f)))
                    for f in ("feature", "threshold_bin", "left", "right",
                              "value", "n_nodes", "edges")}
    line("fit_check", plain_fit_s=plain_fit_s, nrmse_kernel_vs_plain=rel,
         rmse_kernel_fit=rmse_k, rmse_plain_fit=rmse_p,
         trees_with_identical_splits=same, n_trees=len(gbt.trees_),
         node_arrays_equal=equal_arrays)
    check(same == gbt_kw["n_trees"] == len(gbt.trees_),
          f"the card's fit has {same} of {gbt_kw['n_trees']} trees with the "
          "CPU fit's splits (expected all)")
    check(all(equal_arrays.values()) and fa.base == fp.base,
          f"the card's fit's node arrays differ from the CPU fit's "
          f"({equal_arrays})")
    # (implied by the two checks above; kept from the f32 histogram's days)
    check(rel <= 1e-2, f"kernel-fitted GBT differs from the plain fit by "
          f"{rel} of the target span (tolerance 1e-2)")
    check(abs(rmse_k - rmse_p) <= 1e-2 * span,
          "kernel and plain fits differ in training error")

    # tree_predict at the decision path's shape: 2L feature rows
    arrays = tp_ref.flatten_gbt(gbt)
    trees = tp_ref.device_trees(arrays, dev)
    feats_p = np.concatenate([co.default_layer_features(layers, pi5),
                              co.default_layer_features(layers, a100)])
    tcodes = tp_ref.bin_codes_ref(torch.as_tensor(feats_p, device=dev),
                                  trees.edges)
    targs = (tcodes, trees.feature, trees.threshold_bin, trees.left,
             trees.right, trees.scaled_value)
    tkw = dict(max_depth=arrays.max_depth, base=arrays.base)
    tk = tp_kernel.tree_predict_kernel(*targs, **tkw)
    torch.cuda.synchronize()
    tpl = tp_ref.tree_predict_ref(*targs, **tkw)
    # f64 additions in the plain version's order: exactly equal
    check(torch.equal(tk, tpl), "tree_predict: kernel differs from plain "
          f"(max {(tk - tpl).abs().max().item()}; tolerance: exact)")
    # each launch against its plain version, and the descent on the global
    # route (nodes from device memory) at the same shape, through the
    # wrapper's private helpers: exactly equal
    tleaf = tp_kernel._descend(*targs, arrays.max_depth)
    check(torch.equal(tleaf, tp_ref.leaf_matrix_ref(
        *targs, max_depth=arrays.max_depth)), "tree_predict: the descent's "
        "leaf matrix differs from leaf_matrix_ref")
    check(torch.equal(tp_kernel._fold(tleaf, arrays.base),
                      tp_ref.fold_ref(tleaf, arrays.base)),
          "tree_predict: the fold differs from fold_ref")
    check(torch.equal(tp_kernel._fold(tp_kernel._descend(
        *targs, arrays.max_depth, "descend_global"), arrays.base), tpl),
        "tree_predict: the global route differs from plain")
    del tleaf
    records["tree_predict"] = dict(max_abs_err=(tk - tpl).abs().max()
                                   .item(), shape=list(tcodes.shape))
    line("kernel_check", kernel="tree_predict", rows=int(tcodes.shape[0]),
         trees=arrays.n_trees, max_nodes=arrays.max_nodes,
         max_depth=arrays.max_depth,
         route=tp_kernel.choose_route(*tcodes.shape, *trees.feature.shape),
         max_abs_err=records["tree_predict"]["max_abs_err"],
         leaf_matrix_exact=True, fold_exact=True, global_route_exact=True)

    # decide_split: the predictor sweep's packed inputs, and L = 300 random
    # layers over 2^20 - 3 mixed environments (the kernel bench's L300 row)
    layers300, envs300 = decide_split_case(dev, "L300", N_ENVS, SEED)
    packed = {
        "main": (ds_ops.pack_inputs(layers, envs, co.lower_to_accel(pcost))
                 .kernel_args, len(layers)),
        "L300": (ds_ops.pack_inputs(layers300, envs300,
                                    co.lower_to_accel(None)).kernel_args,
                 300),
    }
    for case, (args, n_l) in packed.items():
        ks, kc = ds_kernel.decide_split_kernel(*args)
        torch.cuda.synchronize()
        ps, pcst = ds_ref.decide_split_ref(*args)
        # the min is continuous even where a near-tie flips the argmin
        check(torch.allclose(kc, pcst, rtol=1e-5, atol=0.0),
              f"decide_split {case}: costs differ from plain (rtol 1e-5)")
        share = (ks == ps).double().mean().item()
        line("kernel_check", kernel="decide_split", case=case,
             n_envs=int(ks.numel()), n_splits=n_l + 1,
             split_match_share=share,
             max_abs_err=(kc - pcst).abs().max().item())
        if case == "main":
            records["decide_split"] = dict(
                max_abs_err=(kc - pcst).abs().max().item(),
                shape=[int(ks.numel()), n_l + 1])
        del ps, pcst
    plan300 = dec.decide_all(layers300, envs300)
    exact300 = dec.decide_all(layers300, envs300, backend="torch")
    check(bool((plan300.total_time_s <= exact300.total_time_s * (1 + 1e-4)
                + 1e-12).all()), "L300: kernel split not near-optimal")
    line("plan_check", plan="L300_analytic",
         split_match_share=(plan300.splits == exact300.splits).double()
         .mean().item())
    del exact300

    # -- 9. timing ---------------------------------------------------------
    def level_times(codes_l, grad_l, order, offsets):
        m, f = order.numel(), codes_l.shape[1]
        k = offsets.numel() - 1
        node = torch.repeat_interleave(torch.arange(k, device=dev),
                                       (offsets[1:] - offsets[:-1]).long())
        flat = ((node[:, None] * f + torch.arange(f, device=dev)) * 64
                + codes_l[order.long()]).reshape(-1)
        wts = grad_l[order.long()].repeat_interleave(f)
        args = (codes_l, grad_l, order, offsets, 64)
        b_ms, b_by = bound(*gbt_hist_work(m, f, 64, k))
        return dict(
            ms=timed_ms(lambda: gh_kernel.level_histogram_kernel(*args), 50),
            plain_ms=timed_ms(lambda: gh_ref.level_histogram_ref(*args), 20),
            library_ms=timed_ms(lambda: (
                torch.bincount(flat, weights=wts, minlength=k * f * 64),
                torch.bincount(flat, minlength=k * f * 64)), 20),
            bound_ms=b_ms, bound_by=b_by, rows=m, nodes=k)

    gh_levels = {case: level_times(*levels[case]) for case in levels}
    line("timing_extra", kernel="gbt_hist", levels=gh_levels)
    gh_times = gh_levels["root"]
    gh_bound = (gh_times["bound_ms"], gh_times["bound_by"])
    del levels

    # tree_predict and decide_split at the decision path's shapes, on its
    # inputs, timed by the kernel bench's rows: replayed from a CUDA graph
    # (a few µs of device time; the ctypes path would set an eager time),
    # eager beside; tree_predict also per CUDA kernel, its bound counting
    # the nodes this run's rows reach; decide_split also with L2 overwritten
    # before each call (its 38 MB of inputs fit in the 50 MB L2, and the
    # caller writes them just before) and with its bound at the 30
    # operations a split counted before.  L300 is the bench's row (phase 10)
    tp_row = tree_predict_row(dev, "chip_smoke_fit", (targs, tkw))
    ds_row = decide_split_row(dev, "predictor_sweep", packed["main"][0])
    del packed
    for r in (tp_row, ds_row):
        line("timing_extra", **r)
        check(r["err_over_tol"] < 1.0, f"{r['name']} {r['case']}: off by "
              f"{r['err_over_tol']} of its tolerance ({r['tolerance']})")
    tp_times, ds_times = (dict(ms=r["us_per_call"] / 1e3,
                               plain_ms=r["plain_us"] / 1e3, library_ms=None)
                          for r in (tp_row, ds_row))
    tp_bound, ds_bound = ((r["bound_us"] / 1e3, r["bound_by"])
                          for r in (tp_row, ds_row))

    src = {"gbt_hist": ("src/repro_torch/csrc/gbt_hist.cu",
                        "src/repro/kernels/gbt_hist/kernel.py:49",
                        gh_times, gh_bound),
           "tree_predict": ("src/repro_torch/csrc/tree_predict.cu",
                            "src/repro/kernels/tree_predict/kernel.py:76",
                            tp_times, tp_bound),
           "decide_split": ("src/repro_torch/csrc/decide_split.cu",
                            "src/repro/kernels/decide_split/kernel.py:116",
                            ds_times, ds_bound)}
    kernels = []
    for name, (source, replaces, t, (bound_ms, bound_by)) in src.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "profiling_launches": profiling_launches[name],
                        "oracle_launches": oracle_launches[name],
                        "fleet_launches": fleet_launches.get(name, 0),
                        "max_abs_err": records[name]["max_abs_err"],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": t["library_ms"],
                        "shape": records[name]["shape"]})
    kernels[0]["levels"] = gh_levels
    # tree_predict and decide_split: replayed from a CUDA graph, the eager
    # call beside; per CUDA kernel, and the L2-flushed time and the bound
    # at 30 operations a split
    kernels[1].update(timing="graph",
                      eager_ms=tp_row["us_per_call_eager"] / 1e3,
                      kernels={k: dict(ms=us / 1e3, launches=tp_by_kernel[k])
                               for k, us in tp_row["kernels"].items()})
    kernels[2].update(timing="graph",
                      eager_ms=ds_row["us_per_call_eager"] / 1e3,
                      cold_ms=ds_row["us_per_call_cold"] / 1e3,
                      bound_ms_30ops=ds_row["bound_us_30ops"] / 1e3,
                      continuous_launches=serve_launches["continuous"][
                          "decide_split"],
                      continuous_replan_ms=[t * 1e3 for t in serve_launches[
                          "continuous"]["replan_s"]])
    # the oracle path's shapes (phase 4), eager as the path calls them,
    # the graph replay beside; the first refit's root level of gbt_hist
    oracle_rows = oracle_timing(dev, oracle_shapes)
    del oracle_shapes

    def oracle_shape(r):
        return dict(ms=r["us_per_call_eager"] / 1e3, timing="eager",
                    graph_ms=r["us_per_call"] / 1e3,
                    plain_ms=r["plain_us"] / 1e3,
                    bound_ms=r["bound_us"] / 1e3, bound_by=r["bound_by"],
                    shape=r["shape"])

    kernels[0]["oracle_shapes"] = {"refit_root": gh_levels[
        "oracle_refit_root"]}
    kernels[1]["oracle_shapes"] = {
        case: oracle_shape(oracle_rows[f"tree_predict_{case}"])
        for case in ("one_row", "admission")}
    kernels[2]["oracle_shapes"] = {"admission": dict(
        oracle_shape(oracle_rows["decide_split_admission"]),
        cold_ms=oracle_rows["decide_split_admission"]["us_per_call_cold"]
        / 1e3)}
    # phase 6b's admissions (E = 1, deepseek-moe's 28 layers, analytic)
    kernels[2]["continuous_shapes"] = {"admission": dict(
        oracle_shape(serve_launches["continuous"]["decide_split_row"]),
        cold_ms=serve_launches["continuous"]["decide_split_row"][
            "us_per_call_cold"] / 1e3)}
    # the fleet phase's shapes (phase 5): fleet_scan on (a)'s longest
    # singleton run, decide_split at (b)'s largest slab and (c)'s E = 1
    scan, fleet_rows = fleet_timing(dev, fleet_shapes)
    del fleet_shapes
    kernels[2]["fleet_shapes"] = {r["case"]: dict(
        oracle_shape(r), cold_ms=r["us_per_call_cold"] / 1e3)
        for r in fleet_rows}
    kernels.append({"name": "fleet_scan", "route": "cuda",
                    "source": "src/repro_torch/csrc/fleet_scan.cu",
                    "replaces": "src/repro/sim/fleet.py:72",
                    "counterpart_of": "the jitted lax.scan _singleton_scan "
                    "(not a Pallas kernel)",
                    "launches": fleet_launches["fleet_scan"],
                    "launches_by_route": fleet_launches[
                        "fleet_scan_by_route"],
                    "library_ms": None, "timing": "eager",
                    **scan})
    kernels += serving_kernels(dev, serve_launches)

    # -- 10. the kernel bench: int8_matmul's entry point --------------------
    kernels += kernel_bench()

    # -- 11. training -------------------------------------------------------
    trained = training_slice(dev, smi, profiled[1])
    flash = next(r for r in kernels if r["name"] == "flash_attention")
    flash.update(training_launches=trained["launches"],
                 served_training_launches=trained["served"]["launches"],
                 training_shape=trained["train_shape"],
                 training_shapes=trained["train_shapes"],
                 f32_shape=trained["f32_shape"],
                 backward=trained["backward"])
    # the backward kernel: its launches on phase 11's training paths, its
    # times at qwen3-1.7b's B 4, S 2048 (CUDA graph), the other timed
    # shapes beside
    bwd_row = trained["backward"]["qwen3_prefill"]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:167",
        "counterpart_of": "the custom_vjp backward of flash_attention, "
        "whose forward is the Pallas kernel "
        "src/repro/kernels/flash_attention/kernel.py:78",
        "launches": sum(trained["bwd_launches"].values()),
        "launches_by_model": trained["bwd_launches"],
        "max_abs_err": bwd_row["max_abs_err"], "ms": bwd_row["ms"],
        "eager_ms": bwd_row["eager_ms"], "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"], "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"], "library": bwd_row["library"],
        "err_over_tol": bwd_row["err_over_tol"],
        "shape": bwd_row["shape"], "timing": "graph",
        "other_shapes": {k: v for k, v in trained["backward"].items()
                         if k != "qwen3_prefill"}})
    for name in ("ssm_scan", "slstm_scan"):
        next(r for r in kernels if r["name"] == name).update(
            trained["scans"][name])

    # -- 12. the main paths traced ------------------------------------------
    traced = trace_slice(dev, smi, oracle_traced, serve_launches["untraced"],
                         serve_launches["continuous"]["untraced"])
    for name, per_path in traced.items():
        next(r for r in kernels if r["name"] == name)["trace_launches"] = \
            per_path

    # -- 13. the mesh and the dry-run ---------------------------------------
    from repro_torch.launch import card_mesh
    mesh4, perf_children = [], []
    try:
        meshed = mesh_slice(dev, smi, layers, envs)
        flash.update(mesh_launches=meshed["flash"])
        next(r for r in kernels if r["name"] == "flash_attention_bwd")[
            "mesh_launches"] = meshed["flash"]["train_backward"]

        # -- 14. the examples -------------------------------------------------
        perf_children = start_perf_children()
        by_run = examples_slice(dev, smi)

        # -- the 4-process card mesh, alone on the card -----------------------
        mesh4_dir = str(ROOT / "results" / "card_mesh")
        t_mesh4 = time.perf_counter()
        mesh4 = card_mesh.start(mesh4_dir)
        mesh4_launches = card_mesh_check(mesh4, mesh4_dir, smi, t_mesh4)
        flash.update(mesh4_launches={
            p: {k: v for k, v in n.items() if k.startswith("flash")}
            for p, n in mesh4_launches.items()})
        next(r for r in kernels if r["name"] == "slstm_scan").update(
            mesh4_launches=mesh4_launches["d_xlstm"])

        # -- 15. the benches --------------------------------------------------
        bench_launches = bench_slice(dev, smi, profiled)

        # -- 16. the collating benches ----------------------------------------
        collate_slice(dev, smi, profiled, perf_children)
    finally:
        stop_children(mesh4 + [proc for _, proc, *_ in perf_children])
    for rec in kernels:
        keys = {"flash_attention": ("flash_fwd", "flash_fwd_wgmma",
                                    "flash_fwd_lse", "flash_bwd",
                                    "flash_bwd_mma"),
                "flash_attention_bwd": ("flash_bwd", "flash_bwd_mma"),
                "ssm_scan": ("ssm_scan", "ssm_scan_bwd"),
                "slstm_scan": ("slstm_scan", "slstm_scan_bwd")}.get(
                    rec["name"], (rec["name"],))
        rec["examples_launches"] = {
            run: {k: per[k] for k in keys if k in per}
            for run, per in by_run.items() if any(k in per for k in keys)}
        rec["bench_launches"] = bench_launches.get(rec["name"], 0)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
