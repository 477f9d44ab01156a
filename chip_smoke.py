#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (mlease_tpu_torch) on one H100.

    python3 chip_smoke.py [--seed 0] [--rows-per-block 1562500] [--iters 3]
                          [--out FILE.json]
                          [--gram-only | --segsum-only | --streaming-only
                           | --modes-only | --mesh-only | --fused-only
                           | --bf16-only | --loops-only | --coverage-only
                           | --head-only]

Phases, each of which fails the run when it fails:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build the port's kernels (mlease_tpu_torch/csrc/segment_sum.cu, gram.cu
     and gram_mma_{f32,bf16,f64}.cu) and the fused loop's graph builder
     (csrc/device_loop.cu) with nvcc from the sources in this checkout, one
     nvcc process per source, started together, while the bench and full
     trainers are set up (their set-up launches no kernel);
  3. kernel phase K1: the contrib form `segment_sum_sorted` against its
     plain version on the card, at the main path's tail streams (the
     bench-default shape and the full-width shape of phase 6), float32 with
     L=3 and L=6 lanes and float64, the item CLI phase's record stream (2
     prefixes, float64, 9,600 records), plus empty segments and one giant
     segment; then the fused `segment_sum_gather` at each of tron_multi's
     three sites on the same trainers' real streams, random V and
     accumulator (float32, L 3; 2L 6 with square_from 3; one float64 row),
     beside the unfused path it replaced (torch gather, multiply, zero-filled
     K1, `out + ...`) and the library's (gather, multiply, index_add_);
     per segment |kernel - ref64| <= 1e-5 * (|out0| + sum|contrib|)
     (float32), 1e-12 (float64), and a second call that gives the same bits,
     at every row; times from CUDA events over >= 20 repeats;
  4. kernel phase K2: `gram_batched` against a float64 reference at the
     per-item bucket shapes (B = 20,000; R 64, F 16 in float32 and float64;
     R 256, F 64), the head-block shapes (3 lanes sharing X
     (--rows-per-block, 128), and phase 10's X (16,384, 512)), the TPU kernel's documented
     shape (R = 131,072, F = 512 in
     float32, bf16-in and float64; F = 256) and edge shapes (ragged R, rows
     that are no 16-byte multiple, R = 1, F = 8, rows with d = 0); per entry
     |G - G64| <= 1e-5 * sum_r|d x_i x_j| (float32 and bf16-in, the
     reference taken from the rounded inputs), 1e-12 (float64), G == G'
     exactly, and a second call that gives the same bits; every row names
     the kernel variant and the arithmetic that ran (ops/gram.py::
     launch_config); times as for K1, the library call being `torch.bmm` of the scaled transpose with TF32 off (for a
     shared X one `torch.matmul` that contracts the rows, or one product
     per lane, whichever is faster: `library_call` names it);
  5. CLI phase: `python -m mlease_tpu_torch train` on a copy of
     examples/data/breast-cancer.job (float64, head.size=16), output in a
     temporary directory; checks the output layout, finite logliks and
     that the kernel was launched; in a whole run every later train CLI
     run on this job (17 (c), 18 (f), 19 (d)'s four, 16 (f)) is started
     here with it, each a process of its own (CLI_RUNS), and checked in its
     own phase, so that the eight processes start up together;
  6. full-width phase (the ADMM main path): AdmmTrainer at the widths of
     examples/data/ctr-12m.job (1,000,001 columns, 12 nnz/row on zipf 1.3,
     head.size=128, 8 blocks, lambda 1/10/100, float32, Jacobi PCG, flat
     blocks) on synthetic data made from --seed, 8 x --rows-per-block rows
     (by default 8 x 781,250: ctr-12m.job's 12.5M rows cut to half to
     keep the whole run well inside its time limit; --rows-per-block
     1562500 for all of them, 250000 for a quicker run); K1's runs are counted in exactly this run (its
     eager launches and its executions inside run()'s device loop, counted
     on the card; the loop's set-up apart; kernel_runs); then the
     first iteration again with the plain reduce,
     max|z_kernel - z_plain| <= 1e-4 * max|z|;
  7. speed phase: ADMM iterations/s at bench.py's default shape (4 x 16,384
     rows, 50K features, 15 nnz, head 512) and at the full width, and one
     ADMM step of each under torch.profiler (device busy share, time by
     kernel);
  8. item phase (the per-item main path, at its full size): 10,000 items x
     48 rows x 12 features (the generator of bench.py's item mode, from
     --seed), 1 x 2 grid, full posterior covariance, Cholesky route,
     float32, through `train_item_models_columnar` (each bucket's solve a
     device loop, train/item.py::_solve_bucket); K1's and K2's runs are
     read from exactly this run (kernel_runs: eager launches and the
     executions counted on the card, the loops' set-up apart): K2's must
     equal the Newton trips plus one covariance pass per bucket, K1's
     the Newton trips plus the Newton init's two; then the same run with
     K2 patched to its plain version, and again with K1 patched to its
     plain version (each: coefficients to 1e-4 * max|w|, variances to
     1e-3 relative), the TRON route on 1,000 items against the Cholesky
     route (5e-3 * max|w|: float32 bounds both routes at about 1e-3),
     cold and steady models/s and one run under torch.profiler; the first
     two runs and the TRON run are phase 22 (a)'s loop runs;
  9. item CLI phase: 200 items written as Avro, then `python -m
     mlease_tpu_torch item` and `itemtest` on the card; checks the outputs,
     finite testLoglik and both kernels' launch counts; in a whole run it
     runs beside phase 12's CLI runs, with phase 13's;
 10. head-block phase: `tron_multi(precondition="head_block")` on one block
     of the bench shape (16,384 rows, head 512) against
     precondition="jacobi": the same W to 1e-3 * max|W|, no more CG trips,
     K2 launched once per Newton trip plus one, and the head block that
     `build_head_precond` factorises against K2's plain version on the
     same weights (a preconditioner does not move the solution, so the
     solve alone could not fail a wrong Gram).

 11. streaming phase (the scale path's trainer): StreamingAdmmTrainer at
     ctr-12m.job's widths on the full phase's data (8 x --rows-per-block
     rows, the same arrays), split as the job splits it (8 blocks in 4 groups),
     head 128 stored as bfloat16, float32, lambda 1/10/100, Jacobi PCG,
     --iters iterations, in three residency settings: (a) the job's 8 GB
     budget, (b) a budget that pins group 0's head and streams the
     others, (c) resident_head=False with the compact wire, and (c) again
     from pageable host memory. z and u of (b) and (c) must equal (a)'s bit
     for bit, K1
     must launch in every run (counts read around each), every head pass
     of each run must run in the bf16 head's kernels (ops/head_pass.py),
     one kernel run on the card a pass: their runs past the loops'
     warm-up equal the run's `head_pass` and `head_fused` executions in
     the span store, above 0 (`head_kernels`), and (c)'s first
     iteration with K1 patched to its plain version must be within
     1e-4 * max|z|. Recorded: s/iteration, wire bytes per iteration, the
     copies alone against a plain pinned copy of the same bytes, the share
     of copy time hidden under the solves, peak device memory, and one
     iteration of (a) and of (c) under torch.profiler;
 12. scale CLI phase: 1,000,000 training rows and 5,000 test rows at
     ctr-12m widths written as Avro by the port's native encoder (the
     generator of examples/make_scale_dataset.py; the row count cut from
     12.5M to keep the run inside its time limit: phase 11 runs the full
     phase's rows), then `python -m mlease_tpu_torch train` twice on a copy of
     examples/data/ctr-12m.job with its paths replaced and pack.cache.dir
     set: the first log must show the native decoder and the cache write,
     the second a cache hit, and both the same final models bit for bit;
     the ingest phase breakdown and rows/s come from the first log. Then
     the build's hand-off in this process on the same rows
     (handoff_check): native ingest, split, and the pipeline's
     _streaming_trainer on the card, writing a pack cache and then hitting
     it; after each build no weakref to the packed data, a group's ELL or
     a handed group's arrays is alive, every array the trainer keeps is
     page-locked and equal bit for bit to those of a trainer built from a
     list its caller keeps (left intact), and one iteration gives the
     same z in both (and in both routes);
 13. naive phase: 125,000 rows at ctr-12m widths written as Avro by the
     same generator (cut from 12.5M: the naive and boosted jobs read their
     rows record by record, as the JAX package's do, and three CLI runs
     read them); three CLI runs on a copy of ctr-12m.job, started
     together (in a whole run, beside phase 12's): `naive` with compute.model.mean=true, `train` with
     initialize.boost.rate=2 (initialModel/ must hold the 24 naive models,
     equal to the naive run's to 1e-4 * max|w|, z0 logged, an iteration-0
     sample loglik written, records read, K1 launched by the ADMM that
     follows) and the same with regularizer=1 (no warm start); then
     train_naive in this process on the same rows (float32, lambda
     1/10/100, the job's liblinear.epsilon), timed for models/s (whole
     call and solve alone) and once under torch.profiler, with both
     kernels' runs read around it (kernel_runs): the naive problem is the
     ELL layout of the JAX package's naive trainer (no dense head), whose
     entries the port carries as a row-sorted and a column-sorted tail
     (ops/tron_multi.py::ell_as_sorted_tails) and sums with K1 (one order
     every run), so K1 runs inside the solve's loop and K2 does not
     (phase 22 (c) holds the solve on these rows against K1's plain
     version);
     its models must equal the CLI's to 1e-4 * max|w|; and two blocks in
     float64 at liblinear.epsilon 1e-6 on the card must equal the same
     solve on the CPU to 1e-6 * max|w|; the solve is a device loop
     (train/naive.py::_solve_keys);
 14. solver-modes phase (run right after phase 7, on the full trainer's
     data: ctr-12m widths, head 128 float32, 8 blocks, --rows-per-block):
     AdmmTrainer with flat_blocks=False (Jacobi) and with pcg="head_block",
     --iters iterations each, K1 counted in both and K2 in the head-block
     run (one call per block per head-block build: 8 x (Newton trips + 1)
     an iteration); the head-block run's first iteration again with K2
     patched to its plain version (z within 1e-4 * max|z|); head-block CG
     trips no more than Jacobi's; one profiled head-block step; then one
     iteration of each again at liblinear.epsilon 1e-6, whose z must agree
     within 1e-3 * max|z| (at the job's 0.01 two solvers' z differ by that
     tolerance). Then StreamingAdmmTrainer with pcg="head_block" on the same
     data in 4 groups, head stored as bfloat16 (K2's bf16-in route), 2
     iterations, the job's 8 GB budget; and, at bench.py's shape without a
     head, the lanes solves multi_rhs=False and dual_layout beside flat
     Jacobi, --iters iterations, and one iteration of each at
     liblinear.epsilon 1e-6, within 1e-3 * max|z| of flat Jacobi's;
 15. fit phase: a libsvm file of 100,000 rows x 512 features, 32 nonzeros
     a row, from --seed; `fit --posterior-var --posterior-cov --f64`
     through the CLI's main in this process: K2 builds the (513, 513)
     dense Hessian once; the same fit with K2 patched to its plain version
     must give the same .cov within 1e-9 * max|cov|.
 16. mesh phase (mlease_tpu_torch.parallel): (a) right after phase 14, its
     data through AdmmTrainer on a one-rank NCCL mesh, per-block Jacobi
     and head-block: z and u equal phase 14's no-mesh runs bit for bit (or
     within 1e-6), equal trips, K1 (and K2 in head-block) launched, the
     NCCL sum and trip maximum timed; then, after phase 15, 2 gloo ranks on
     the one card, each a process of this script: (b) the same data, 4
     blocks a rank, both solves, z within 1e-5 of (a) with equal trips,
     every rank the same z and u, K1 and K2 launched on each rank and one
     call of each held against its plain version on the rank's data; (c)
     the streaming trainer with phase 11's split, nothing pinned, 2
     iterations, within 2e-3 of (b)'s float32-head z; (d) the
     feature-sharded trainer 1 x 2 in ELL at 8 x 125,000 rows, run()
     through its host-driven seam (_host_x_update: a gloo group cannot be
     captured on the card, where run() raises), K1 launched on every rank
     (X'v over the ELL's column copy), within 1e-5 of the same solve
     unsharded, the collectives' time reported; (e) phase 8's 10,000 items
     split over the ranks, models and
     posterior variances within 1e-6 of the one-rank run, every rank the
     same bucket stats (20,000 problems); (f) `train --mesh 1 --device
     cuda` on phase 5's job, checked as phase 5.
 17. fused-loop phase (AdmmTrainer.run_fused: the driver loop as a CUDA
     graph that loops on the card, ops/device_loop.py and
     csrc/device_loop.cu), run right after phase 16 (a) on the two
     trainers: run() against run_fused() on (b) bench.py's default step,
     10 iterations, and (a) the full trainer (flat Jacobi) and new
     per-block Jacobi and head-block trainers on its data, --iters
     iterations: z, u and the diffs bit for bit (or within 1e-6 * max|z|,
     the difference printed), equal iterations and trip totals, and K1
     (and K2 in head-block) executed inside the loop's graphs as often as
     they run in run() (kernel_runs; counted on the card by an add each
     wrapper makes right after its kernel, captured with it, and equal to the
     captured launches x branch executions); s/iteration, the end-to-end
     seconds of each run with run_fused's capture included, capture
     seconds, peak memory, the card's idle share of run() (profiler) and
     of the loop (against run()'s busy time); at bench, checkpoint_every=2
     against
     one chunk bit for bit with one callback per chunk, a chunk under
     torch.cuda.set_sync_debug_mode("error"), and the synchronizing calls
     of run() and run_fused() counted under "warn"; then (c) the train
     CLI on phase 5's job with fused.loop = true and checkpoint.every = 2:
     final models within 1e-10 of phase 5's, the last two chunk ends'
     checkpoints and every iteration's sample-test-loglik file. Phases 11
     and 12 log and check each streamed run's pass-floor decomposition
     (utils/floor.py, tools/torch_pass_floors*.json measured on the card):
     a numeric util from a table of this card.
 18. bfloat16 phase (dtype = bfloat16, ROADMAP.md A15), in six parts run
     beside the float32 phases they compare with: (a) after phase 17, K1's
     bf16 entry against its plain version at the full trainer's three
     fused sites into float32 accumulators, as a bf16 solve calls it (the
     stream's values and V rounded to bf16; per segment |kernel - ref64|
     <= 1e-5 * (|out0| + sum|contrib|)), and at the `_xtv_lm` site and the
     contrib form into bf16 (+ 2^-8 * |ref64|), library call beside each;
     (b) the full trainer's data in a bfloat16 AdmmTrainer, flat Jacobi,
     --iters iterations, K1 counted around exactly this run: z finite,
     within 1% of max|z_f32| after iteration 1 and 5% after the last
     against phase 6's run, trips, s an iteration and a CG trip and device
     memory beside phase 6's; (c) the bench cell in bf16, per-block Jacobi
     and head-block (K2 bf16-in): run_fused against run() bit for bit
     (phase 17's comparison, unprofiled), then the lanes solve
     (multi_rhs=False) in float32 and bf16: s an iteration, trips, z within
     5% of max|z_f32|; (e) after phase 8, its items in
     bf16: Cholesky on the 10,000 items against phase 8's main run, TRON
     on its 1,000 items at liblinear.epsilon 1e-6 against its TRON run,
     models within 1e-2 * max|w|, models/s of both routes on the 10,000
     items; (d) after phase 11, its stream (a) data in bf16
     compute: the job's budget, one pinned head, nothing pinned, the same
     bits, a floor decomposition from a bfloat16 table of this card, s an
     iteration and the copy kernels of 3 profiled iterations beside phase
     11's (a); (f) after phase 15, `train --device
     cuda` on phase 5's job with dtype = bfloat16: phase 5's layout,
     models within 5% of max|w| of phase 5's, checkpoints of the bf16
     bits (|V2).
 19. run_fused in the modes slice 8 added, and the int32 bound (ROADMAP.md
     A1b, A16), run right after phase 17: (a) at bench.py's shape without
     a head (phase 14's lanes data), the lanes solves multi_rhs=False and
     dual_layout, 5 iterations: run_fused against run() bit for bit, s an
     iteration, capture seconds and the synchronizing calls of each run,
     K1 (the lanes objective's sorted sums on the card) executed in the
     loop as often as it runs in run(), and those sums held against their
     float64 scatter on the same inputs (random out0 and vectors, per entry
     <= 1e-5 * (|out0| + sum|contrib|)): the column-sorted stream of both
     solves, of the lanes problem also in sub-stacks of 2 blocks and on a
     bfloat16 stream, and the full trainer's tails (row- and column-sorted)
     on the ids a streamed lanes group unstacks to (held equal to
     blocked_problem's), as built and in sub-stacks of 2; (b) the full
     trainer's data on a one-rank NCCL mesh, per-block Jacobi and
     head-block, --iters iterations: run_fused bit for bit with the mesh
     trainer's run() and with phase 14's no-mesh run, equal trips, and the
     K1, K2 and all_reduce executions counted on the card (the captured
     branches' adds) equal to run()'s runs and calls (two all_reduces
     an iteration; the branches holding one captured "thread_local", the
     node types of the captured iteration end printed); (c) the same
     per-block Jacobi solve with ops/tron_multi.py's STACK_ID_BOUND lowered
     in this process so that the 8 blocks solve as 4 sub-stacks of 2: z
     within 1e-6 * max|z| of phase 14's run with its trips, K1 executed
     in every sub-stack's branches of run()'s device loop every iteration
     (counted on the card), its runs counted (kernel_runs); (d) phase
     5's job through the CLI with
     fused.loop = true under use.mesh (a one-rank NCCL group) and with
     multi.rhs = false (the lanes solve), each against the same job
     run eagerly (the four processes started together): final models
     within 1e-10.
 20. lanes-minor phase (ROADMAP.md A17), run right after phase 19 on the
     full trainer's stacked problem (ctr-12m widths, 8 x --rows-per-block
     rows, head 128 float32 as (B, Rb, H), both sorted tails) with a
     random prior mean and rho_eff and random W, S, C, Dm from --seed: the
     ten public pass functions of ops/tron_multi.py (xv, xtv, scores,
     fun, grad_and_curvature, xtv_and_sqdiag, fun_grad_curvature, also
     with_diag, grad_norm_at_zero, hv, hessian_diagonal), each (a) against
     its lanes-major form on contiguous operands (bit for bit or within
     1e-6 * max|out|, the difference printed), (b) against itself with K1
     patched to its plain version (1e-5 * max|plain|, F to 1e-5
     relative), (c) with K1's launches counted around it (15 in all), (d)
     the JAX identities fun_grad_curvature(with_diag) = (fun,
     grad_and_curvature, hessian_diagonal) and grad_norm_at_zero =
     ||grad_and_curvature(0)[0]|| (bit for bit or within 1e-6 relative,
     printed; also whether K1's L and 2L sites sum the diagonal alike),
     (e) each function's time beside its lanes-major form's, K1 alone on
     the lanes-minor V of the xv and xtv sites (kernel, plain, library,
     bound) and the phase's peak device memory; at most 60 s.
 21. solve-loop phase (train/admm.py::_SolveLoop: each x-update one
     program on the card, a CUDA graph that loops until its solves stop,
     in AdmmTrainer.run() and in the streaming trainer's group solves),
     in two parts: right after phase 20 on the two trainers, (a) one
     x-update from random z and u through build_x_update (the host-driven
     solve) and through a _SolveLoop, x and trips bit for bit and K1 / K2
     run as often (the loop's set-up apart): at bench and full width flat,
     per-block and head-block, at bench the lanes solves (multi_rhs=False,
     dual_layout) and 4 sub-stacks at bench (of 1 block) and full width
     (of 2; the int32 bound lowered, as phase 19 does); then at bench flat
     and lanes and full flat, the host-driven path (run() with its
     x-update through build_x_update's solve, one host read a trip; no
     device loop made) and then run() on its loop, made anew, 3
     iterations each: z and u bit for bit with equal trips, (c) the
     synchronizing calls of each iteration (one; the others of the run
     named by file:line), (d) K1 and K2 run as often as on the host path
     (kernel_runs: the wrappers' eager launches less the calls captured,
     plus the executions counted on the card; the loop's set-up apart),
     (e) s an iteration of each, the capture seconds and the bytes the
     captures leave reserved (the graph pool), the peak allocated and
     reserved memory of each (after a garbage collection, with the free
     cache given back) and the bytes the loops keep after the run; the
     host path's idle share of an admm_iteration span at bench flat and
     full flat (profiler) and, for the loops, each iteration's time inside
     their graphs (CUDA events around each launch), whose complement
     bounds the idle share from above; the streamed part, on phase 11's
     trainers (a), (b), (c) and phase 18's (a) in bfloat16 right after
     each trainer's own runs (under --loops-only on trainers of its own):
     (b) group 0's first solve through the trainer's loop against
     build_group_solver on the same inputs while they are in the group's
     slot (bit for bit, equal trips), the tiers' runs bit for bit with
     each other; (c)-(e) as above on each run, at (a) and (a) in bfloat16
     against the host path (the group solves through build_group_solver),
     with the stream_iteration span's idle share of the host path at (a),
     and the slots' and solver state's bytes beside the reserve that
     _cap_budget keeps free of the pinned tiers.

 22. per-key loops phase (train/item.py::_solve_bucket and train/naive.py::
     _solve_keys: each item bucket's and each naive solve one program on
     the card), run right after phase 13 (its rows), each run on its
     loops (phase 8's and 18 (e)'s runs where a whole run made them),
     then again (items), then with the seam on the host-driven solvers
     (tests/torch_host_solves.py: newton_cholesky, tron, tron_multi; one
     host read a trip): (a) phase 8's items in float32, the Cholesky route
     on the 10,000 (full covariance), the TRON route on phase 8's 1,000 at
     liblinear.epsilon 1e-6, and both routes on 10,000 items in three
     (R, K, F) buckets (ITEM_BUCKET_PARTS, diagonal variances, no second
     run: s per bucket); (b) the same in bfloat16 (phase 18 (e)'s
     settings, diagonal variances); w, variances, covariances and trips
     bit for bit with the host path and between the two loop runs, K1 /
     K2 run as often as on the host path (the loops' set-up apart), one
     host read a bucket (the synchronizing calls by site, the captures'
     apart), s per bucket of each, capture seconds, the captures' pool
     (reserved bytes) and the bytes kept after the run; K1 held to its
     plain version on the item path's shapes: every K1 call of the first
     bucket's host-driven solve and Hessian diagonal against its float64
     plain version (k1_checked, K1's bound), the TRON and diagonal-variance
     runs again with K1 on its plain version (w and variances within
     K1_PLAIN_BOUNDS), and the Cholesky buckets' sorted sums, plain and
     squared, against the float64 scatter (lanes_sorted_sum_check); (c)
     phase 13's in-process train_naive on its 125,000 rows in its three
     modes (flat, per key in 4 sub-stacks with the int32 bound lowered as
     phase 19 lowers it, the lanes of multi_rhs=False): models and trips
     bit for bit with the host path, K1 run as often, no host read inside
     the solve, every K1 call of the host-driven solve against its float64
     plain version, and the stacked solves' loop with K1 on its plain
     version within NAIVE_K1_PLAIN_BOUND (the lanes' distance reported),
     s of each; (d), items on 2 gloo ranks against 1
     rank, is phase 16 (e)'s, whose rows say whether they are the same
     bits.
 23. head-less phase (X'v over the ELL summed by K1 over its column-sorted
     copy, ops/tron_multi.py::with_column_copy; the feature-sharded
     trainer's x-update as one device loop), run after phase 22, at most
     about 50 s: (a) bench's step without a head (head.size = 0, 4 x
     16,384 rows, 50K features, 15 nnz) flat, per-block and in 4
     sub-stacks (the int32 bound lowered): one x-update through the loop
     against build_x_update's host-driven solve (bits, trips, K1 run as
     often), two run() calls of LOOPS_ITERS iterations and a run on the
     host-driven path the same bits, s an iteration of each; (b)
     every K1 call of one host-driven x-update of each held to its float64
     plain sum (k1_checked); (c) at ctr-12m.job's widths without a head
     (1,000,001 columns, 12 nnz, 8 blocks, 3 lambdas, float32), rows cut to
     8 x 250,000 (HEADLESS_ROWS): the flat trainer's run() against its
     host-driven path and twice on its loop (bits, one host read an
     iteration, K1 counted on the card, s an iteration, capture s, pool
     and kept bytes), K1 at its X'v site against its plain version, timed
     beside the `index_add_` over the ELL it replaces and its bound; then
     FeatureShardedAdmmTrainer on a one-rank NCCL 1 x 1 mesh: run() on its
     loop (made and captured in the first run), again on the kept loop,
     and with the seam on the host-driven solve, bit for bit, one host read
     an iteration (set_sync_debug_mode("warn")), K1 executions on the card
     (kernel_runs; one feat shard's solve makes no collective, so none is
     captured), capture s, pool and kept bytes,
     s an iteration of each; every K1 call of one host-driven x-update
     held to its float64 plain sum.
 24. card-paths phase: the paths of the port that only the CPU tests had
     run, on the card, run after phase 23, at most about 60 s, each case
     one row with its bits, trips, s, host reads an iteration and K1's
     runs (in the loops' graphs, at their set-up): (a) the streamed lanes
     solve (multi_rhs=False) at bench.py's step (phase 14's lanes data,
     4 blocks in 2 groups), 3 iterations a run: without a head (each
     group ships its column order) streamed and streamed with consensus
     on the host, with bench's head (512) every group resident and
     streamed with consensus on the host (compact wire), and with the
     tails unpadded (streaming.pad.tails = false) resident and streamed
     (dense wire); each layout's runs the same bits, group 0's solve
     equal to build_group_solver's in its slot, each head-less group's
     problem unstacked with the shipped order equal to the in-memory
     lanes problem's blocks bit for bit (at liblinear.epsilon 0.01 the
     two runs' z apart by the distance stated, in float32 and float64,
     beside which sums differ between the layouts: known trait 10; in
     float64 at liblinear.epsilon 1e-8 within 1e-6 * max|z|, and the
     padded and unpadded tails alike), and K1 on it against the float64
     scatter (K1's bound); (b) the streamed lanes
     solve at ctr-12m.job's widths without a head (phase 23 (c)'s
     blocks) in 4 groups of 2, nothing resident: the loops' first
     iteration bit for bit with the host-driven group solves, then 2
     iterations on the kept loops (s, trips, wire bytes, each loop's
     capture and pool); (c) phase 11 (c)'s groups with consensus on the
     host (u pinned, shipped in the slots), --iters iterations bit for
     bit with phase 11 (c)'s run; (d) resume: a run stopped after 2
     iterations, its state kept as the pipeline's checkpoint keeps it,
     resumed by a new trainer for 2 more, bit for bit with 4 uninterrupted
     iterations, in memory (bench, flat Jacobi) and streamed ((a)'s
     groups, multi-RHS and lanes), and phase 5's job through the CLI, 10
     iterations then resume = true to 20 (two processes started in phase
     5, one after the other): final-model/ within 1e-10 * max|w| of phase
     5's (best-model/ is not compared: both packages checkpoint the
     best-loglik sentinel, ROADMAP.md C); (e) rho adaptation
     (rho.adapt.coefficient 0.1) in run() at bench, 4 iterations on its
     loop, bit for bit with the host-driven x-update; (f) the same for
     the solve keys no other phase runs on the card: pcg = false,
     relaxation 1.6, penalize.intercept = true (PERF.md section 4 lists
     every key that changes what runs on the card, and its phase).
 25. head-pass phase: the bfloat16 head's kernels (ops/head_pass.py,
     csrc/head_pass.cu) at ctr-12m's head (8 blocks of 1,562,500 x 128,
     bfloat16): Xv over 3 lanes, X'v over 3, and X'C with (X∘X)'Dm over
     2L 6 (square_from 3); each against the float64 product of the same
     head per element: |err| <= c 2^-24 (|out0| + sum|terms|), c the
     kernel's longest chain of float32 roundings (`head_chain`), and the
     largest |err| / (|out0| + sum|terms|) (reported) at most 1e-6, which
     a kernel that rounded to bfloat16 or TF32 exceeds; beside
     the widening route it replaced (`plain`: each block widened, one
     cuBLAS float32 GEMM; the square rounded in bfloat16 first) and the
     GEMM over the already widened head (`library`); a second call that
     gives the same bits; ms per block pass from CUDA events over 20
     repeats of the whole pass, against the head's bytes over 3.35 TB/s
     (0.119 ms a block).
The line before the last is the card's name and power limit, the one before
it the `kernels` line; the last line is {"ok": true, "device": {...}}.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result. --gram-only builds the kernels, runs phase 4
alone and stops there, without the closing lines (for work on K2);
--segsum-only builds them, sets up the two trainers and runs phases 3 and
20 alone (for work on K1); --streaming-only builds them and runs phases 11 and 12
alone (for work on the scale path); --modes-only builds them, sets up the
two trainers and runs phases 14, 13 and 15 alone; --mesh-only builds
them, sets up the two trainers and runs phase 16 alone (with its own
no-mesh runs for (a)); --fused-only builds them, sets up the two trainers
and runs phases 17 and 19 alone (with its own eager CLI run for 17 (c) and
no-mesh runs for 19 (b)-(c)); --loops-only builds them, sets up the two
trainers and runs phases 21, 22 and 23 alone (21's streamed part on
trainers of its own, on data made as phase 11 makes it; 22's naive rows
made as phase 13 makes them); --bf16-only
builds them, sets up the two trainers, makes the float32 runs phase 18
compares with (phase 5, phase 6, phase 8's first run, phase 11's (a) once)
and runs phase 18 alone; --coverage-only builds them, sets up the two
trainers, runs phase 5's CLI run and phase 24's two, then phase 24 alone
((c)'s reference made as phase 11 makes it); --head-only builds them and
runs phase 25 alone (for work on the head's kernels).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# peak rates (H100 SXM data sheet), FLOP/s: float32 and float64 outside the
# tensor cores, bfloat16 dense on them
PEAK_OPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
# ... and for a matrix product of the type's accuracy, which may go through
# the tensor cores: float32 as three TF32 products (495 / 3 = 165 TFLOP/s,
# above the 67 outside them), float64 as DMMA (67), bfloat16 as above
GRAM_PEAK_OPS = {"float32": 495e12 / 3, "float64": 67e12,
                 "bfloat16": 989e12}
CLI_TIMEOUT_S = 300
# the full trainer's rows per block: ctr-12m.job's 12.5M rows cut to half,
# 8 x 781,250, to keep the whole run well inside its time limit
FULL_ROWS = 781_250


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


SYNTH: dict = {}       # synth_blocked_data's results, by their arguments
BLOCKED_FIELDS = ("indices", "values", "y", "weight", "offset", "present",
                  "nrows")


def synth_blocked_data(n_features, nblocks, rows_per_block, nnz, seed,
                       blocks=None):
    """Power-law CTR-like blocks, the distribution of the JAX package's
    bench.py (zipf 1.3 column draw, intercept appended to every row); each
    block drawn from its own stream of `seed` (numpy's SeedSequence.spawn),
    the blocks on threads. Made once for each set of arguments: a later
    call gets copies of the same arrays. `blocks=(b0, b1)` draws only
    those blocks of the nblocks, the same arrays as theirs in the whole
    set, and keeps nothing (tools/torch_scale_layout.py makes its data
    group by group)."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from mlease_tpu_torch.core.dataset import BlockedData

    key = (n_features, nblocks, rows_per_block, nnz, seed)
    if key not in SYNTH or blocks is not None:
        n = n_features + 1
        icpt = n_features
        b0, b1 = blocks or (0, nblocks)
        B, R = b1 - b0, rows_per_block
        seqs = np.random.SeedSequence(seed).spawn(nblocks + 1)
        w_true = (np.random.default_rng(seqs[nblocks]).normal(size=n)
                  * 0.3).astype(np.float32)
        w_true[icpt] = -1.5
        indices = np.empty((B, R, nnz + 1), np.int32)
        values = np.empty((B, R, nnz + 1), np.float32)
        y = np.empty((B, R), np.float32)
        present = np.zeros((B, n), dtype=bool)

        def block(b):
            rng = np.random.default_rng(seqs[b0 + b])
            raw = rng.zipf(1.3, size=(R, nnz))
            raw -= 1
            raw %= n_features
            indices[b, :, :nnz] = raw
            indices[b, :, nnz] = icpt
            values[b, :, :nnz] = rng.normal(size=(R, nnz)) * 0.5
            values[b, :, nnz] = 1.0
            scores = np.einsum("rk,rk->r", values[b],
                               w_true[indices[b]]).astype(np.float32)
            p = 1.0 / (1.0 + np.exp(-scores))
            y[b] = np.where(rng.random(R) < p, 1.0, -1.0)
            present[b, indices[b].ravel()] = True

        with ThreadPoolExecutor(min(B, os.cpu_count() or 1)) as ex:
            list(ex.map(block, range(B)))
        made = BlockedData(
            indices=indices, values=values, y=y,
            weight=np.ones((B, R), np.float32),
            offset=np.zeros((B, R), np.float32), present=present,
            nrows=np.full(B, R, np.int32), nblocks=B, dim=n)
        if blocks is not None:
            return made
        SYNTH[key] = made
    d = SYNTH[key]
    return d._replace(**{f: getattr(d, f).copy() for f in BLOCKED_FIELDS})


def save_blocked(data, path):
    """synth_blocked_data's arrays into one .npz (uncompressed)."""
    import numpy as np
    np.savez(path, dim=data.dim, **{f: getattr(data, f)
                                    for f in BLOCKED_FIELDS})


def load_blocked(path):
    import numpy as np
    from mlease_tpu_torch.core.dataset import BlockedData
    with np.load(path) as z:
        arrays = {f: z[f] for f in BLOCKED_FIELDS}
        return BlockedData(**arrays, nblocks=int(arrays["y"].shape[0]),
                           dim=int(z["dim"]))


def make_vocab(n_features):
    from mlease_tpu_torch.core.vocab import FeatureVocab
    return FeatureVocab.from_names(f"f{i}" for i in range(n_features))


def stacked_tails(trainer):
    """The two sorted tail streams of a trainer's flat problem: the
    row-sorted Xv stream (segments = B*R rows) and the column-sorted X'v
    stream (segments = B*n columns)."""
    prob = trainer.prob
    return {"xv_rows": (prob.tail_rows, prob.y.shape[0]),
            "xtv_cols": (prob.tail_c_cols, prob.prior_mean.shape[0])}


def k1_tolerances():
    """K1's per-segment bound against the float64 sum of the same inputs:
    |got - ref64| <= tol * (|out0| + sum|contrib|) + rel * |ref64|, rel
    the one rounding of a bfloat16 result."""
    import torch
    return {torch.float32: (1e-5, 0.0), torch.float64: (1e-12, 0.0),
            torch.bfloat16: (1e-5, 2.0 ** -8)}


# K1 does a bfloat16 call's arithmetic in float32, on the CUDA cores
K1_ARITH = {"bfloat16": "float32"}


def check_and_time(name, seg, S, L, dtype, gen, results):
    """Kernel vs plain version at one shape; appends a result row."""
    import torch
    from mlease_tpu_torch.ops.segment_sum import (min_bytes,
                                                  segment_sum_sorted,
                                                  segment_sum_sorted_reference)
    T = seg.numel()
    contrib = torch.randn((L, T), generator=gen, device="cuda", dtype=dtype)
    got = segment_sum_sorted(contrib, seg, S)
    same_bits = bool(torch.equal(got, segment_sum_sorted(contrib, seg, S)))
    ref64 = segment_sum_sorted_reference(contrib.double(), seg, S)
    scale = segment_sum_sorted_reference(contrib.double().abs(), seg, S)
    torch.cuda.synchronize()
    err = (got.double() - ref64).abs()
    tol, rel = k1_tolerances()[dtype]
    ok = bool((err <= tol * scale + rel * ref64.abs()).all()) and same_bits
    lib_out = torch.zeros((L, S), dtype=dtype, device="cuda")
    dname = str(dtype).replace("torch.", "")
    # least time: the bytes it must move, or one add per entry and lane
    bytes_ms = min_bytes(L, T, S, contrib.element_size()) / HBM_BYTES_PER_S
    ops_ms = L * T / PEAK_OPS[K1_ARITH.get(dname, dname)]
    row = {
        "shape": name, "L": L, "T": T, "S": S, "dtype": dname,
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / scale.clamp_min(1e-300)).max()),
        "same_bits_again": same_bits, "ok": ok,
        "kernel_ms": cuda_ms(lambda: segment_sum_sorted(contrib, seg, S)),
        "plain_ms": cuda_ms(
            lambda: segment_sum_sorted_reference(contrib, seg, S)),
        # the same work as the kernel's call: zero fill, then one index_add_
        "library_ms": cuda_ms(
            lambda: lib_out.zero_().index_add_(1, seg, contrib)),
        "bound_ms": max(bytes_ms, ops_ms) * 1e3,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    print("kernel-check " + json.dumps(row), flush=True)
    results.append(row)
    if not ok:
        raise AssertionError(f"segment_sum_sorted disagrees at {name} "
                             f"L={L} {dtype}: max err {row['max_abs_err']}, "
                             f"same bits again {same_bits}")
    return row


def fused_sites(trainer):
    """The three sorted tail reduces of a trainer's flat problem, as
    tron_multi calls them: (vals, gather ids, segment ids, V's columns m,
    segments S, lanes of V per lambda)."""
    prob = trainer.prob
    R, n = prob.y.shape[0], prob.prior_mean.shape[0]
    c = (prob.tail_c_vals, prob.tail_c_rows, prob.tail_c_cols, R, n)
    return {"xv": (prob.tail_vals, prob.tail_cols, prob.tail_rows, n, R, 1),
            "xtv": (*c, 1), "xtv_sqdiag": (*c, 2)}


def fused_check_and_time(name, site, L, dtype, gen, results,
                         variants=True, out_dtype=None):
    """The fused gather + weight + reduce into an accumulator against its
    plain version, the unfused path it replaced (torch gather, multiply,
    cat, zero-filled K1, `out + ...`; PR 3's, with this PR's K1) and the
    library's (gather, multiply, index_add_), at one site's real stream
    with random V and accumulator; appends a result row. variants=False
    times the kernel (V lanes-major), the plain version and the library
    call only. out_dtype (default dtype) is the accumulator's type: a
    bfloat16 solve passes float32 sums (ops/tron_multi.py)."""
    import torch
    from mlease_tpu_torch.ops.segment_sum import (
        min_bytes, segment_sum_gather, segment_sum_gather_reference,
        segment_sum_sorted)
    vals, idx, seg, m, S, lanes = site
    vals = vals.to(dtype)
    out_dtype = out_dtype or dtype
    L2 = lanes * L
    sf = L if lanes == 2 else None
    V = torch.randn((L2, m), generator=gen, device="cuda", dtype=dtype)
    out0 = torch.randn((L2, S), generator=gen, device="cuda",
                       dtype=out_dtype)
    T = seg.numel()
    got = segment_sum_gather(vals, V, idx, seg, S, out=out0.clone(),
                             square_from=sf)
    again = segment_sum_gather(vals, V, idx, seg, S, out=out0.clone(),
                               square_from=sf)
    same_bits = bool(torch.equal(got, again))
    del again
    ref64 = segment_sum_gather_reference(
        vals.double(), V.double(), idx, seg, S, out=out0.double(),
        square_from=sf)
    scale = segment_sum_gather_reference(
        vals.double().abs(), V.double().abs(), idx, seg, S,
        out=out0.double().abs(), square_from=sf)
    torch.cuda.synchronize()
    err = (got.double() - ref64).abs()
    tol, rel = k1_tolerances()[out_dtype]
    ok = bool((err <= tol * scale + rel * ref64.abs()).all()) and same_bits
    del ref64
    dname = str(dtype).replace("torch.", "")
    m_hit = int(torch.unique(idx).numel())
    S_hit = int((seg[1:] != seg[:-1]).sum()) + 1 if T else 0
    bytes_ms = min_bytes(L2, T, S, V.element_size(), m_hit=m_hit,
                         S_hit=S_hit, out_itemsize=out0.element_size()
                         ) / HBM_BYTES_PER_S
    ops_ms = 2 * L2 * T / PEAK_OPS[K1_ARITH.get(dname, dname)]
    acc = out0.clone()

    def contrib():
        tv = vals[None, :]
        rows = V[:, idx]
        if sf is None:
            return tv * rows
        return torch.cat([tv * rows[:sf], (tv * tv) * rows[sf:]])

    def unfused():
        return acc + segment_sum_sorted(contrib(), seg, S)

    row = {
        "shape": name, "L": L2, "square_from": sf, "T": T, "S": S, "m": m,
        "m_hit": m_hit, "S_hit": S_hit, "dtype": dname,
        "out_dtype": str(out_dtype).replace("torch.", ""),
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / scale.clamp_min(1e-300)).max()),
        "same_bits_again": same_bits, "ok": ok,
        "bound_ms": max(bytes_ms, ops_ms) * 1e3,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    del err, scale
    if ok:
        def fused(Vx):
            return lambda: segment_sum_gather(vals, Vx, idx, seg, S, out=acc,
                                              square_from=sf)
        # V lanes-major, as the sites pass it; then a lanes-minor view, and
        # a lanes-minor copy of V made for the call (counted in it)
        row["kernel_ms"] = cuda_ms(fused(V))
        if variants:
            Vm = V.t().contiguous().t()
            row["kernel_ms_lanes_minor_given"] = cuda_ms(fused(Vm))
            del Vm
            row["kernel_ms_lanes_minor_copy"] = cuda_ms(
                lambda: fused(V.t().contiguous().t())())
        row["plain_ms"] = cuda_ms(lambda: segment_sum_gather_reference(
            vals, V, idx, seg, S, out=acc, square_from=sf))
        if variants:
            row["unfused_ms"] = cuda_ms(unfused)
        row["library_ms"] = cuda_ms(lambda: acc.index_add_(
            1, seg, contrib().to(acc.dtype)))
    del V, acc, out0
    print("kernel-check fused " + json.dumps(row), flush=True)
    results.append(row)
    if not ok:
        raise AssertionError(f"segment_sum_gather disagrees at {name} "
                             f"L={L2} {dtype} into {out_dtype}: max err "
                             f"{row['max_abs_err']}, same bits again "
                             f"{same_bits}")
    return row


def kernel_phase(trainers, args):
    import numpy as np
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    results = []
    for tag, trainer in trainers.items():
        for stream, (seg, S) in stacked_tails(trainer).items():
            for L, dtype in ((3, torch.float32), (6, torch.float32),
                             (3, torch.float64)):
                check_and_time(f"{tag}/{stream}", seg, S, L, dtype, gen,
                               results)
        # the fused call at each of tron_multi's three sites (3 lambdas;
        # the gradient + diagonal site over 6 lanes), and one float64 row
        for site, streams in fused_sites(trainer).items():
            for dtype in ((torch.float32, torch.float64) if site == "xtv"
                          else (torch.float32,)):
                fused_check_and_time(f"{tag}/{site}", streams, 3, dtype, gen,
                                     results)
                torch.cuda.empty_cache()
    # the record stream that the item CLI phase's `itemtest` reduces: one
    # entry per nonzero of its 200 x 48 records, 2 model prefixes, float64
    nnz = np.diff(item_cli_rows(args).row_start)
    seg = torch.as_tensor(np.repeat(np.arange(len(nnz)), nnz)
                          .astype(np.int32), device="cuda")
    check_and_time("item_cli/records", seg, len(nnz), 2, torch.float64, gen,
                   results)
    # edge streams: most segments empty; one segment holding everything
    rng = np.random.default_rng(args.seed)
    sparse = np.sort(rng.choice(np.arange(0, 1_000_000, 97), 300_000))
    edge = {"edge/empty_segments": (sparse, 1_000_000),
            "edge/one_segment": (np.full(2_000_000, 12_345), 20_000)}
    for name, (ids, S) in edge.items():
        seg = torch.as_tensor(ids.astype(np.int32), device="cuda")
        for L, dtype in ((3, torch.float32), (6, torch.float64)):
            check_and_time(name, seg, S, L, dtype, gen, results)
    empty = torch.ones(1_000_000, dtype=torch.bool, device="cuda")
    empty[torch.as_tensor(sparse, device="cuda")] = False
    from mlease_tpu_torch.ops.segment_sum import segment_sum_sorted
    seg = torch.as_tensor(sparse.astype(np.int32), device="cuda")
    out = segment_sum_sorted(torch.randn((3, seg.numel()), generator=gen,
                                         device="cuda"), seg, 1_000_000)
    if bool((out[:, empty] != 0).any()):
        raise AssertionError("empty segments are not exactly 0")
    return results


# K2 shapes: (name, B, R, F, dtype name, shared X)
GRAM_SHAPES = [
    ("item/R64_F16", 20_000, 64, 16, "float32", False),
    ("item/R64_F16", 20_000, 64, 16, "float64", False),
    ("item/R256_F64", 20_000, 256, 64, "float32", False),
    # one block of the full trainer (R None: --rows-per-block rows)
    ("head_block/ctr-12m", 3, None, 128, "float32", True),
    # the streamed head-block build: one block's bfloat16 head, 3 lanes
    ("head_block/ctr-12m", 3, None, 128, "bfloat16", True),
    ("fit/F513", 1, 100_000, 513, "float64", False),       # phase 15's
    ("head_block/bench", 3, 16_384, 512, "float32", True),   # phase 10's
    ("tpu_doc/F512", 1, 131_072, 512, "float32", False),
    ("tpu_doc/F512", 1, 131_072, 512, "bfloat16", False),
    ("tpu_doc/F512", 1, 131_072, 512, "float64", False),
    ("tpu_doc/F256", 1, 131_072, 256, "float32", False),
    ("edge/ragged_R", 2, 4_099, 200, "float32", False),
    ("edge/ragged_R", 2, 4_099, 200, "float64", True),
    ("edge/ragged_F", 1, 50_001, 130, "float32", False),   # 520-byte rows
    ("edge/ragged_F", 40, 300, 13, "bfloat16", False),      # the FMA kernel
    ("edge/R1_F8", 7, 1, 8, "float32", False),
    ("edge/F8", 1_000, 37, 8, "bfloat16", False),
]
ITEM_K2_ROW = ("item/R64_F16", "float32")   # the item phase's one bucket


def gram_check_and_time(name, B, R, F, dname, shared, gen, results):
    """K2 against a float64 reference at one shape; appends a result row."""
    import torch
    from mlease_tpu_torch.ops import gram

    dtype = getattr(torch, dname)
    acc = gram.accumulate_dtype(dtype)
    x = torch.randn((R, F) if shared else (B, R, F), generator=gen,
                    device="cuda").to(dtype)
    d = torch.rand((B, R), generator=gen, device="cuda").to(dtype)
    d[:, ::5] = 0                                   # rows with d = 0
    pvi = torch.rand((B, F), generator=gen, device="cuda").to(acc) + 0.5
    got = gram.gram_batched(x, d, pvi)
    # float64 reference from the (rounded) inputs; entry by entry for the
    # few long problems, whose batched float64 einsum would not fit
    def weighted_gram(xs, ds):
        if B > 4:
            return gram.gram_batched_reference(xs, ds)
        return torch.stack([((xs if shared else xs[b]).T * ds[b])
                            @ (xs if shared else xs[b]) for b in range(B)])

    x64, d64 = x.to(torch.float64, copy=True), d.double()   # abs_'d below
    ref64 = weighted_gram(x64, d64) + torch.diag_embed(pvi.double())
    scale = weighted_gram(x64.abs_(), d64)          # d >= 0
    del x64, d64
    torch.cuda.synchronize()
    err = (got.double() - ref64).abs()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    symmetric = bool((got == got.transpose(1, 2)).all())
    same_bits = bool((got == gram.gram_batched(x, d, pvi)).all())
    ok = bool((err <= tol * scale + 1e-300).all()) and symmetric \
        and same_bits
    bytes_ms = gram.min_bytes(B, R, F, x.element_size(), got.element_size(),
                              shared) / HBM_BYTES_PER_S
    ops_ms = gram.min_flops(B, R, F) / GRAM_PEAK_OPS[dname]
    cfg = gram.launch_config(B, R, F, dtype, shared, x.data_ptr() % 16 == 0)
    row = {"shape": name, "B": B, "R": R, "F": F, "dtype": dname,
           "shared_x": shared, "variant": cfg.variant,
           "route": gram.route(cfg.variant, dtype), "tile": cfg.tile,
           "row_splits": cfg.nsplit, "lanes": cfg.lanes,
           "ops_rate_tflops": GRAM_PEAK_OPS[dname] / 1e12,
           "max_abs_err": float(err.max()),
           "max_rel_err": float((err / scale.clamp_min(1e-300)).max()),
           "symmetric": symmetric, "same_bits_again": same_bits, "ok": ok,
           "bound_ms": max(bytes_ms, ops_ms) * 1e3,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    del ref64, scale, err
    if ok:
        row["kernel_ms"] = cuda_ms(lambda: gram.gram_batched(x, d, pvi))
        row["plain_ms"] = cuda_ms(
            lambda: gram.gram_batched_reference(x, d, pvi))
        # PyTorch's own product for the same function (no diagonal), TF32
        # off. A shared X is not expanded into a batch (bmm's long-K path
        # is slow there): one matmul that contracts the rows, or one
        # product per lane; the faster of the two is the yardstick
        if shared:
            calls = {
                "matmul": lambda: torch.matmul(x.T * d[:, None, :], x),
                "mm per lane": lambda: [(x.T * d[b]) @ x for b in range(B)]}
        else:
            calls = {"bmm": lambda: torch.bmm(
                x.transpose(1, 2) * d[:, None, :], x)}
        timed = {k: cuda_ms(fn) for k, fn in calls.items()}
        row["library_call"] = min(timed, key=timed.get)
        row["library_ms"] = timed[row["library_call"]]
        row["library_calls_ms"] = timed
    print("kernel-check K2 " + json.dumps(row), flush=True)
    results.append(row)
    if not ok:
        raise AssertionError(f"gram_batched disagrees at {name} {dname}: "
                             f"max err {row['max_abs_err']}, symmetric "
                             f"{symmetric}, same bits again {same_bits}")
    return row


def gram_phase(args):
    import torch

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 must be off for the library yardstick")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    results = []
    for name, B, R, *rest in GRAM_SHAPES:
        gram_check_and_time(name, B, R or args.rows_per_block, *rest, gen,
                            results)
        torch.cuda.empty_cache()
    return results


HEAD_SHAPE = (8, 1_562_500, 128)     # ctr-12m's flat-blocks head
HEAD_COLUMNS = 1_000_001             # ctr-12m's columns a block


def head_pass_phase(args):
    """Phase 25: the bfloat16 head's kernels at ctr-12m's head."""
    import torch
    import mlease_tpu_torch.ops.tron_multi as tm
    from mlease_tpu_torch.ops import head_pass

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 must be off for the library yardstick")
    B, Rb, H = HEAD_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    x = torch.randn((B, Rb, H), generator=gen, device="cuda").to(
        torch.bfloat16)
    n = B * HEAD_COLUMNS
    ids = (torch.randperm(HEAD_COLUMNS, generator=gen, device="cuda")[:H]
           [None, :] + HEAD_COLUMNS * torch.arange(B, device="cuda")[:, None]
           ).reshape(-1).to(torch.int32)
    bound_ms = head_pass.min_bytes(Rb, H) / HBM_BYTES_PER_S * 1e3
    rows = []
    for name, L, sf in (("xv", 3, None), ("xtv", 3, 3),
                        ("xtv_sqdiag", 6, 3)):
        if name == "xv":
            hw = torch.randn((L, B * H), generator=gen, device="cuda")
            out0 = torch.randn((L, B * Rb), generator=gen, device="cuda")

            def kernel(out):
                return head_pass.head_xv(x, hw, out)

            def plain(out):
                o = out.view(L, B, Rb)
                for b in range(B):
                    o[:, b] += hw[:, b * H:(b + 1) * H] @ tm._widen(
                        x[b], torch.float32).T
                return out

            def library(xf, b, out):
                return hw[:, b * H:(b + 1) * H] @ xf.T
        else:
            D = torch.randn((L, B * Rb), generator=gen, device="cuda")
            out0 = torch.randn((L, n), generator=gen, device="cuda")

            def kernel(out):
                return head_pass.head_xtv(x, D, ids, out, square_from=sf)

            def plain(out):
                parts = [tm._head_t(x, D[:sf])]
                if sf < L:
                    parts.append(tm._head_t(x, D[sf:], square=True))
                return out.index_add_(1, ids, torch.cat(parts))

            def library(xf, b, out):
                return D[:, b * Rb:(b + 1) * Rb] @ xf
        got = kernel(out0.clone())
        again = kernel(out0.clone())
        via_plain = plain(out0.clone())
        torch.cuda.synchronize()
        # float64, one block at a time: the error over the sum of
        # magnitudes, for the kernel and the widening route
        want = out0.double()
        scale = out0.double().abs()
        for b in range(B):
            x64 = x[b].double()
            if name == "xv":
                w64 = hw[:, b * H:(b + 1) * H].double()
                cols = slice(b * Rb, (b + 1) * Rb)
                want[:, cols] += w64 @ x64.T
                scale[:, cols] += w64.abs() @ x64.abs().T
                continue
            xs64 = (x[b] * x[b]).double()
            D64 = D[:, b * Rb:(b + 1) * Rb].double()
            bid = ids[b * H:(b + 1) * H].long()
            want[:sf].index_add_(1, bid, D64[:sf] @ x64)
            want[sf:].index_add_(1, bid, D64[sf:] @ xs64)
            scale[:sf].index_add_(1, bid, D64[:sf].abs() @ x64.abs())
            scale[sf:].index_add_(1, bid, D64[sf:].abs() @ xs64)
            del D64, xs64
        del x64

        def rel(t):
            # an entry of out0 can be exactly 0 (randn), and untouched by
            # the head: 0 over 0 there
            err = (t.double() - want).abs()
            return float(torch.where(scale > 0, err / scale, err).max())
        cx = head_pass.grid_blocks(x, L)
        chain = head_chain(name, Rb, cx)
        within = bool(((got.double() - want).abs()
                       <= chain * 2.0**-24 * scale).all())
        xf = x[0].float()
        out = out0.clone()
        rows.append({
            "shape": f"ctr12m/{name}", "B": B, "Rb": Rb, "H": H, "L": L,
            "square_from": sf, "same_bits": bool(torch.equal(got, again)),
            "max_rel_err": rel(got), "plain_max_rel_err": rel(via_plain),
            "chain": chain, "within_chain_bound": within,
            "bound_ms": bound_ms,
            "kernel_ms": cuda_ms(lambda: kernel(out)) / B,
            "plain_ms": cuda_ms(lambda: plain(out)) / B,
            "library_ms": cuda_ms(lambda: library(xf, 0, out)),
            "grid_blocks": cx})
        print("head_pass " + json.dumps(rows[-1]), flush=True)
        del got, again, via_plain, want, scale, xf, out, out0
        torch.cuda.empty_cache()
        if not rows[-1]["same_bits"]:
            raise AssertionError(f"head {name}: two calls differ")
        if not within or rows[-1]["max_rel_err"] > HEAD_REL_ERR:
            raise AssertionError(f"head {name}: error {rows[-1]}")
    return rows


# Phase 25's limit on the largest error over the sum of magnitudes. The
# kernels read 1.1e-7 (Xv, 128 terms) and 5e-9-7e-9 (X'v, 1,562,500) at
# ctr-12m's head; rounding D, w or the products to bfloat16 or TF32 on
# these random-sign sums gives about 2^-9 (2^-11) / sqrt(terms): 1e-4
# (4e-5) at Xv, 1.4e-6 (3.5e-7) at X'v, its largest over the columns a
# few times that.
HEAD_REL_ERR = 1e-6


def head_chain(name, Rb, cx):
    """The longest chain of float32 roundings of one output of a head
    kernel (csrc/head_pass.cu), as tests/test_torch_cuda.py bounds it:
    Xv's 16 products a lane, the butterfly and the add into out within
    32; X'v's rows a lane sums (16 a tile of its warp's, a tile every 256
    rows of its grid block's span), the butterflies, 8 warps, cx partials
    and the add into out."""
    if name == "xv":
        return 32
    span = -(-(-(-Rb // cx)) // 32) * 32
    return 16 * -(-span // 256) + 5 + 8 + cx + 1


def synth_item_decoded(n_items, rows_per_item, n_feat, seed):
    """Columnar per-item rows, the generator of the JAX package's bench.py
    item mode: 2-6 features a row drawn without replacement, a logistic
    response from per-item true coefficients."""
    import numpy as np
    from mlease_tpu_torch.io.fast_decode import DecodedRows

    rng = np.random.default_rng(seed)
    N = n_items * rows_per_item
    item_of_row = np.repeat(np.arange(n_items), rows_per_item)
    nnz = rng.integers(2, 7, size=N)
    order = np.argsort(rng.random((N, n_feat)), axis=1)
    lane = np.arange(n_feat)[None, :] < nnz[:, None]
    feat_id = order[lane].astype(np.int32)
    vals = rng.normal(size=len(feat_id)).astype(np.float32)
    row_start = np.zeros(N + 1, np.int64)
    np.cumsum(nnz, out=row_start[1:])
    w_true = (rng.normal(size=(n_items, n_feat)) * 0.5).astype(np.float32)
    score = np.zeros(N, np.float64)
    np.add.at(score, np.repeat(np.arange(N), nnz),
              w_true[np.repeat(item_of_row, nnz), feat_id] * vals)
    p = 1.0 / (1.0 + np.exp(-(score - 0.4)))
    response = (rng.random(N) < p).astype(np.int32)
    return DecodedRows(
        response=response, weight=np.ones(N, np.float32),
        offset=np.zeros(N, np.float32), row_start=row_start,
        feat_id=feat_id, feat_val=vals,
        vocab_names=[f"f{j}" for j in range(n_feat)],
        keys=[f"item{i}" for i in item_of_row])


def max_model_diff(a, b):
    """(max |coefficient difference|, max |coefficient|) over two model
    dictionaries with equal keys."""
    diff = scale = 0.0
    for key, m in a.items():
        o = b[key]
        diff = max(diff, abs(m.intercept - o.intercept))
        scale = max(scale, abs(m.intercept))
        for name, v in m.coefficients.items():
            diff = max(diff, abs(v - o.coefficients[name]))
            scale = max(scale, abs(v))
    return diff, scale


def max_var_rel(a, b):
    """max relative difference of two posterior-variance dictionaries with
    equal keys, relative to b's."""
    rel = 0.0
    for key, v in a.items():
        o = b[key]
        rel = max(rel, abs(v.intercept - o.intercept) / o.intercept,
                  *(abs(x - o.coefficients[n]) / o.coefficients[n]
                    for n, x in v.coefficients.items()))
    return rel


def item_phase(args):
    import math
    import torch
    import mlease_tpu_torch.ops.newton as newton_mod
    import mlease_tpu_torch.ops.objective as objective_mod
    from mlease_tpu_torch.ops.gram import gram_batched, gram_batched_reference
    from mlease_tpu_torch.ops.segment_sum import (
        segment_sum_gather_reference, segment_sum_sorted)
    from mlease_tpu_torch.train import item

    n_items, rows_per_item, n_feat = 10_000, 48, 12
    t0 = time.monotonic()
    decoded = synth_item_decoded(n_items, rows_per_item, n_feat, args.seed)
    datagen_s = time.monotonic() - t0
    cfg = item.ItemConfig(intercept_lambdas=[1.0], default_lambdas=[1.0, 10.0],
                          compute_var=True, full_cov=True, solver="cholesky",
                          dtype=torch.float32)

    def train():
        return item.train_item_models_columnar(decoded, cfg, device="cuda")

    def run():
        t0 = time.monotonic()
        res = train()
        torch.cuda.synchronize()
        return res, time.monotonic() - t0

    # main path, counted from here to here (kernel_runs in _counted), and
    # kept as phase 22 (a)'s first loop run
    first = item_loop_run(train)
    res, runs, cold_s = first["res"], first["counts"], first["counts"]["s"]
    launches = runs["k2"]              # every run, the loops' set-up too
    F32_BASE["item"] = {"decoded": decoded, "models": res.models}
    # each bucket's loop runs K2 once a Newton step, then dense_hessian;
    # K1 at the Newton init (2) and once a Newton finish
    expected = sum(s["newton_trips"] + 1 for s in res.solver_stats)
    expected_k1 = sum(s["newton_trips"] + 2 for s in res.solver_stats)
    n_models = len(res.models)
    finite = all(
        math.isfinite(m.intercept)
        and all(math.isfinite(v) for v in m.coefficients.values())
        for m in res.models.values())
    var_pos = all(
        v.intercept > 0 and all(math.isfinite(x) and x > 0
                                for x in v.coefficients.values())
        for v in res.posterior_var.values())
    row = {"items": n_items, "rows_per_item": rows_per_item,
           "features": n_feat, "models": n_models, "datagen_s": datagen_s,
           "buckets": res.solver_stats, "kernel_launches": launches,
           "kernel_runs": runs, "expected_launches": expected,
           "k1_runs": runs["k1"], "expected_k1_runs": expected_k1,
           "finite": finite,
           "variances_positive": var_pos, "cold_s": cold_s,
           "cold_models_per_s": n_models / cold_s}
    if (n_models != 2 * n_items or not finite or not var_pos or launches == 0
            or launches - runs["setup"]["k2"] != expected
            or runs["k1"] - runs["setup"]["k1"] != expected_k1
            or runs["card"]["k2"] == 0 or runs["card"]["k1"] == 0
            or len(res.covariances) != n_models):
        raise AssertionError(f"item run: {row}")

    # phase 22 (a)'s second loop run: its captures timed (timed_prepare
    # synchronises around each), so steady_s holds that too
    second = item_second_run(train)
    ITEM_LOOP_RUNS["a cholesky"] = dict(first, second=second)
    steady_s = second["s"]
    row["steady_s"] = steady_s
    row["steady_models_per_s"] = n_models / steady_s
    t0 = time.monotonic()
    packed = item.pack_buckets_columnar(decoded, cfg)
    row["pack_s"] = time.monotonic() - t0
    del packed
    prof = device_time(lambda: item.train_item_models_columnar(
        decoded, cfg, device="cuda"))
    row["profiled_run"] = prof

    # the same run with K2 on its plain version
    with mock.patch.object(newton_mod, "gram_batched",
                           gram_batched_reference), \
            mock.patch.object(objective_mod, "gram_batched",
                              gram_batched_reference):
        before = gram_batched.launches
        plain, plain_s = run()
        if gram_batched.launches != before:
            raise AssertionError("the plain run launched the kernel")
    row["plain_s"] = plain_s
    diff, scale = max_model_diff(res.models, plain.models)
    row["w_kernel_vs_plain_max_abs"], row["w_max_abs"] = diff, scale
    var_rel = max_var_rel(res.posterior_var, plain.posterior_var)
    row["var_kernel_vs_plain_max_rel"] = var_rel
    if not diff <= 1e-4 * scale or not var_rel <= 1e-3:
        raise AssertionError(f"kernel and plain item runs differ: {row}")

    # the same run with K1 on its plain version (X'v, the gradient, over
    # the item problem's column-sorted copy), held as K2's run is
    with mock.patch.object(objective_mod, "segment_sum_gather",
                           segment_sum_gather_reference):
        before = segment_sum_sorted.launches
        plain1, plain1_s = run()
        if segment_sum_sorted.launches != before:
            raise AssertionError("the K1-plain run launched the kernel")
    row["k1_plain_s"] = plain1_s
    row["w_k1_vs_plain_max_abs"], _ = max_model_diff(res.models,
                                                     plain1.models)
    row["var_k1_vs_plain_max_rel"] = max_var_rel(res.posterior_var,
                                                 plain1.posterior_var)
    if not (row["w_k1_vs_plain_max_abs"] <= 1e-4 * scale
            and row["var_k1_vs_plain_max_rel"] <= 1e-3):
        raise AssertionError(f"K1 and plain item runs differ: {row}")
    del plain, plain1

    # the TRON route on 1,000 items against the Cholesky route, both solved
    # to a tight tolerance. In float32 either route stops once a step no
    # longer lowers f by more than float32 resolves (~1e-7 * f), which
    # leaves each ~1e-3 from the float64 solution: hence 5e-3 * max|w|
    small = synth_item_decoded(1_000, rows_per_item, n_feat, args.seed + 1)
    tight = dataclasses.replace(cfg, full_cov=False, liblinear_epsilon=1e-6)
    chol = item.train_item_models_columnar(small, tight, device="cuda")
    tron_run = item_loop_run(lambda: item.train_item_models_columnar(
        small, dataclasses.replace(tight, solver="tron"), device="cuda"))
    ITEM_LOOP_RUNS["a tron"] = tron_run       # phase 22 (a)'s first run
    tron = tron_run["res"]
    F32_BASE["item"].update(small=small, tight=tight, tron=tron.models)
    diff, scale = max_model_diff(chol.models, tron.models)
    row["tron_vs_cholesky_max_abs"], row["tron_w_max_abs"] = diff, scale
    row["tron_buckets"] = tron.solver_stats
    print("item " + json.dumps(row), flush=True)
    if not diff <= 5e-3 * scale:
        raise AssertionError(f"TRON and Cholesky routes differ: {diff} vs "
                             f"max|w| {scale}")
    return row


def item_cli_rows(args):
    """The item CLI phase's rows: 200 items x 48 rows x 12 features."""
    return synth_item_decoded(200, 48, 12, args.seed + 2)


def item_cli_phase(args):
    import numpy as np
    from mlease_tpu_torch.io import avro

    decoded = item_cli_rows(args)
    feature = {"type": "record", "name": "feature", "fields": [
        {"name": "name", "type": "string"}, {"name": "term", "type": "string"},
        {"name": "value", "type": "float"}]}
    schema = {"type": "record", "name": "ItemRow", "fields": [
        {"name": "item", "type": "string"}, {"name": "response", "type": "int"},
        {"name": "features", "type": {"type": "array", "items": feature}},
        {"name": "weight", "type": "float"},
        {"name": "offset", "type": "float"}]}
    rs = decoded.row_start
    records = [{
        "item": decoded.keys[i], "response": int(decoded.response[i]),
        "features": [{"name": decoded.vocab_names[f], "term": "",
                      "value": float(v)}
                     for f, v in zip(decoded.feat_id[rs[i]:rs[i + 1]],
                                     decoded.feat_val[rs[i]:rs[i + 1]])],
        "weight": 1.0, "offset": 0.0} for i in range(len(decoded.response))]
    env = dict(os.environ, PYTHONPATH=REPO, MLEASE_LOG="WARNING")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-item-") as tmp:
        data = os.path.join(tmp, "items.avro")
        avro.write_records(data, schema, records)
        models = os.path.join(tmp, "models")
        out = os.path.join(tmp, "itest")
        jobs = {
            "item": {"input.paths": data, "item.key": "item",
                     "intercept.lambdas": "1", "default.lambdas": "1,10",
                     "compute.var": "true", "output.model.path": models},
            "itemtest": {"input.paths": data, "item.key": "item",
                         "model.path": os.path.join(models,
                                                    "part-r-00000.avro"),
                         "output.base.path": out}}
        summaries, walls = {}, {}
        for cmd, props in jobs.items():
            job = os.path.join(tmp, cmd + ".job")
            with open(job, "w") as f:
                f.writelines(f"{k}={v}\n" for k, v in props.items())
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, "-m", "mlease_tpu_torch", cmd, job],
                capture_output=True, text=True, env=env, cwd=REPO,
                timeout=CLI_TIMEOUT_S)
            walls[cmd] = time.monotonic() - t0
            if proc.returncode != 0:
                raise AssertionError(f"CLI {cmd} failed ({proc.returncode}):"
                                     f"\n{proc.stderr[-3000:]}")
            summaries[cmd] = json.loads(proc.stdout.strip().splitlines()[-1])
        for path in (os.path.join(models, "part-r-00000.avro"),
                     os.path.join(out, "pred", "part-r-00000.avro"),
                     os.path.join(out, "_loglik", "part-r-00000.avro")):
            if not os.path.exists(path):
                raise AssertionError(f"item CLI output lacks {path}")
        logliks = [r["testLoglik"] for r in avro.read_records(
            os.path.join(out, "_loglik"))]
        n_pred = len(avro.read_records(os.path.join(out, "pred")))
    row = {"models": summaries["item"]["models"], "scored": n_pred,
           "test_logliks": logliks, "wall_s": walls,
           "item_kernel_launches": summaries["item"]["kernel_launches"],
           "itemtest_kernel_launches":
               summaries["itemtest"]["kernel_launches"]}
    print("item-cli " + json.dumps(row), flush=True)
    if (row["models"] != 400 or n_pred != len(records) or len(logliks) != 2
            or not np.all(np.isfinite(logliks))
            or row["item_kernel_launches"]["gram_batched"] <= 0
            or row["itemtest_kernel_launches"]["segment_sum_sorted"] <= 0):
        raise AssertionError(f"item CLI run: {row}")
    return row


def head_block_phase(args):
    """tron_multi with the head-block preconditioner against Jacobi, on one
    block of bench.py's default shape."""
    import torch
    import mlease_tpu_torch.ops.tron_multi as tm
    from mlease_tpu_torch.core.dataset import to_hybrid
    from mlease_tpu_torch.ops.gram import gram_batched, gram_batched_reference

    R, nf, nnz, H = 16_384, 50_000, 15, 512
    data = to_hybrid(synth_blocked_data(nf, 1, R, nnz, args.seed + 3), H)
    n, lams = data.dim, [1.0, 10.0, 100.0]

    def t(a, dtype=None):
        return torch.as_tensor(a, device="cuda", dtype=dtype)

    f32 = torch.float32
    head = (t(data.head, f32), t(data.head_ids), t(data.tail_rows),
            t(data.tail_cols), t(data.tail_vals, f32), t(data.tail_c_rows),
            t(data.tail_c_cols), t(data.tail_c_vals, f32))
    prob = tm.stack_blocks(
        t(data.indices), t(data.values, f32), t(data.y, f32),
        t(data.weight, f32), t(data.offset, f32), head,
        torch.zeros((len(lams), 1, n), dtype=f32, device="cuda"),
        t(lams, f32))
    prob = prob._replace(head_x=prob.head_x[0])      # one block, non-flat
    W0 = torch.zeros((n, len(lams)), dtype=f32, device="cuda")
    eps = 1e-4
    # every head block that build_head_precond factorises during one solve,
    # against K2's plain version on the same weights
    diffs, scales, a_shapes = [], [], set()

    def checked_gram(x, d, pvi=None):
        got = gram_batched(x, d, pvi)
        ref = gram_batched_reference(x, d, pvi)
        diffs.append(float((got - ref).abs().max()))
        scales.append(float(ref.abs().max()))
        a_shapes.add((tuple(x.shape), tuple(got.shape)))
        return got

    with mock.patch.object(tm, "gram_batched", checked_gram):
        tm.tron_multi(prob, W0, eps, precondition="head_block")
    a_diff, a_scale = max(diffs), max(scales)
    out = {}
    for kind in ("jacobi", "head_block"):
        tm.tron_multi(prob, W0, eps, precondition=kind)          # warm
        torch.cuda.synchronize()
        gram_batched.launches = 0
        t0 = time.monotonic()
        res = tm.tron_multi(prob, W0, eps, precondition=kind)
        torch.cuda.synchronize()
        out[kind] = (res, time.monotonic() - t0, gram_batched.launches)
    jac, blk = out["jacobi"][0], out["head_block"][0]
    diff = float((blk.w - jac.w).abs().max())
    scale = float(jac.w.abs().max())
    row = {"rows": R, "dim": n, "head": H, "lambdas": lams, "eps": eps,
           "w_max_abs_diff": diff, "w_max_abs": scale,
           "head_block_kernel_vs_plain_max_abs": a_diff,
           "head_block_max_abs": a_scale,
           "converged": [bool(jac.converged.all()),
                         bool(blk.converged.all())],
           "jacobi": {"newton_trips": jac.newton_trips,
                      "cg_trips": jac.cg_trips, "s": out["jacobi"][1],
                      "gram_launches": out["jacobi"][2]},
           "head_block": {"newton_trips": blk.newton_trips,
                          "cg_trips": blk.cg_trips, "s": out["head_block"][1],
                          "gram_launches": out["head_block"][2]}}
    print("head-block " + json.dumps(row), flush=True)
    if (not bool(torch.isfinite(blk.w).all()) or not diff <= 1e-3 * scale
            or blk.cg_trips > jac.cg_trips
            or a_shapes != {((R, H), (len(lams), H, H))}
            or not a_diff <= 1e-5 * a_scale
            or out["head_block"][2] != blk.newton_trips + 1
            or out["jacobi"][2] != 0):
        raise AssertionError(f"head-block solve: {row}")
    return row


CLI_MODELS: dict = {}       # phase 5's final models, phase 17 (c)'s reference
CLI_ROWS: dict = {}         # phase 5's row (its output layout), phase 18 (f)'s
# the float32 runs phase 18 compares its bfloat16 runs with, kept by phases
# 6, 8 and 11 (or made by --bf16-only)
F32_BASE: dict = {}
# phase 11 (c)'s groups and its run, phase 24 (c)'s reference
COVERAGE: dict = {}


AHEAD: dict = {}            # work started before its phase: key -> Future
AHEAD_POOL: list = []


def ahead(key, fn, *a, **kw):
    """Start fn(*a, **kw) on a thread of its own now; the phase it belongs
    to takes its result (or its exception) with taken(key, ...)."""
    from concurrent.futures import ThreadPoolExecutor
    if not AHEAD_POOL:
        AHEAD_POOL.append(ThreadPoolExecutor(16))
    AHEAD[key] = AHEAD_POOL[0].submit(fn, *a, **kw)


def taken(key, fn, *a, **kw):
    """The result of the work started ahead under `key`, or fn(*a, **kw)
    run now where none was."""
    fut = AHEAD.pop(key, None)
    return fut.result() if fut is not None else fn(*a, **kw)


def wait_ahead(keys):
    """Wait until the work started under `keys` has ended (its results and
    exceptions stay for taken)."""
    from concurrent.futures import wait
    wait([AHEAD[k] for k in keys if k in AHEAD])


def _cli_key(extra_args=(), extra_props=None, tag="eager"):
    return ("cli", tuple(extra_args), tuple(sorted((extra_props
                                                    or {}).items())), tag)


# every run of the train CLI on phase 5's job, each a process of its own,
# all started together in phase 5 (none reads what another wrote): phase
# 5's, 17 (c)'s, 18 (f)'s, 19 (d)'s four and 16 (f)'s
CLI_RUNS = [((), None, "eager"),
            ((), {"fused.loop": "true", "checkpoint.every": "2"}, "fused"),
            ((), {"dtype": "bfloat16"}, "bf16"),
            *(((), dict(v, **({"fused.loop": "true"} if how == "fused"
                              else {})), f"{k} {how}")
              for k, v in (("use.mesh", {"use.mesh": "true"}),
                           ("multi.rhs=false", {"multi.rhs": "false"}))
              for how in ("eager", "fused")),
            (("--mesh", "1", "--device", "cuda"), None, "mesh")]


def cli_runs_phase(runs=CLI_RUNS):
    """Phase 5: every run of `runs` (CLI_RUNS; under --coverage-only
    phase 5's own) started together, and beside them phase 24 (d)'s two
    runs, one after the other; phase 5's own row once they have all ended
    (the later phases take theirs)."""
    keys = [_cli_key(*r) for r in runs]
    for key, r in zip(keys, runs):
        ahead(key, _cli_run, *r)
    ahead("cli_resume", cli_resume_runs)
    wait_ahead(keys + ["cli_resume"])
    return cli_phase()


def cli_resume_runs():
    """Phase 24 (d)'s CLI runs, one after the other on one output: phase
    5's job with num.iters = 10 (the host loop checkpoints every
    iteration, keeping the last two), then with resume = true and
    num.iters = 20. Returns their summaries and walls, the checkpoints
    the first left and the final models of the second."""
    from mlease_tpu_torch.core.linear_model import read_model_file
    with tempfile.TemporaryDirectory(prefix="chip-smoke-resume-") as tmp:
        out = os.path.join(tmp, "out")
        first, wall1 = _train_cli(_bc_job(tmp, "first.job", out,
                                          {"num.iters": "10"}))
        checkpoints = sorted(os.listdir(os.path.join(out, "checkpoint")))
        second, wall2 = _train_cli(_bc_job(tmp, "resumed.job", out, {
            "num.iters": "20", "resume": "true",
            "force.output.overwrite": "false"}))
        models = {k: (m.intercept, dict(m.coefficients)) for k, m in
                  read_model_file(os.path.join(out, "final-model")).items()}
    return {"first": first, "resumed": second, "wall_s": [wall1, wall2],
            "checkpoints_after_first": checkpoints, "models": models}


def cli_phase(extra_args=(), extra_props=None, tag="eager"):
    """The row of a train CLI run on phase 5's job: started ahead by
    cli_runs_phase, or run now."""
    return taken(_cli_key(extra_args, extra_props, tag), _cli_run,
                 extra_args, extra_props, tag)


def _bc_job(tmp, name, out, extra_props=None):
    """A copy of breast-cancer.job as phase 5 runs it (float64, head.size
    16, its data in this checkout, its output in `out`), with
    `extra_props`, written to tmp/name."""
    from mlease_tpu_torch.utils.config import JobConfig
    data = os.path.join(REPO, "examples", "data", "breast-cancer")
    props = dict(JobConfig.from_file(data + ".job"))
    props.update({"input.paths": os.path.join(data, "train"),
                  "test.path": os.path.join(data, "test"),
                  "output.base.path": out, "head.size": "16",
                  "dtype": "float64", **(extra_props or {})})
    job = os.path.join(tmp, name)
    with open(job, "w") as f:
        f.writelines(f"{k}={v}\n" for k, v in props.items())
    return job


def _train_cli(job, extra_args=()):
    """`python -m mlease_tpu_torch train job`: its summary (the last line
    of its output) and its wall seconds; a failed run raises."""
    env = dict(os.environ, PYTHONPATH=REPO, MLEASE_LOG="WARNING")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "mlease_tpu_torch", "train", job,
         *extra_args],
        capture_output=True, text=True, env=env, cwd=REPO,
        timeout=CLI_TIMEOUT_S)
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        raise AssertionError(f"CLI train failed ({proc.returncode}):\n"
                             f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), wall


def _cli_run(extra_args=(), extra_props=None, tag="eager"):
    """Phase 5 (and phase 17 (c) with extra job keys): the train CLI on
    breast-cancer.job in float64; the final models are kept under `tag`,
    and with checkpoint.every the checkpoint files are listed."""
    import numpy as np
    from mlease_tpu_torch.core.linear_model import read_model_file
    from mlease_tpu_torch.io import avro

    with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-") as tmp:
        out = os.path.join(tmp, "out")
        summary, wall = _train_cli(_bc_job(tmp, "breast-cancer.job", out,
                                           extra_props), extra_args)
        for rel in ("final-model/part-r-00000.avro",
                    "lambda-rho/part-r-00000.avro", "model-vocab.json",
                    "test/lambda-1.0/_loglik/part-r-00000.avro",
                    f"best-model/best-iteration-{summary['iterations']}.avro"):
            if not os.path.exists(os.path.join(out, rel)):
                raise AssertionError(f"CLI output lacks {rel}")
        ll_dir = os.path.join(out, "sample-test-loglik")
        lls = [r["testLoglik"] for f in sorted(os.listdir(ll_dir))
               for r in avro.read_records(os.path.join(ll_dir, f))]
        test_ll = [r["testLoglik"] for lam in summary["models"]
                   for r in avro.read_records(os.path.join(
                       out, "test", f"lambda-{lam}", "_loglik"))]
        if not lls or not np.all(np.isfinite(lls + test_ll)):
            raise AssertionError("non-finite or missing logliks")
        launches = summary["kernel_launches"]["segment_sum_sorted"]
        if launches <= 0:
            raise AssertionError("the CLI run never launched the kernel")
        CLI_MODELS[tag] = {
            k: (m.intercept, dict(m.coefficients)) for k, m in
            read_model_file(os.path.join(out, "final-model")).items()}
        ckpt_dir = os.path.join(out, "checkpoint")
        checkpoints = (sorted(os.listdir(ckpt_dir))
                       if os.path.isdir(ckpt_dir) else [])
        arrays = [c for c in checkpoints if c.endswith(".npz")]
        ckpt_dtypes = {}
        if arrays:
            with np.load(os.path.join(ckpt_dir, arrays[-1])) as z:
                ckpt_dtypes = {k: [z[k].dtype.str, list(z[k].shape)]
                               for k in ("z", "u")}
        ll_files = sorted(os.listdir(ll_dir))
        files = sorted(
            os.path.relpath(os.path.join(d, f), out)
            for d, _sub, fs in os.walk(out) for f in fs
            if os.path.relpath(d, out).split(os.sep)[0]
            not in ("checkpoint", "tmp-data"))
    row = {"args": list(extra_args), "props": extra_props or {},
           "checkpoints": checkpoints, "checkpoint_arrays": ckpt_dtypes,
           "files": files, "sample_loglik_files": ll_files,
           "iterations": summary["iterations"],
           "best_loglik": summary["best_loglik"], "wall_s": wall,
           "solver_wall_s": summary["wall_time_s"],
           "sample_logliks": len(lls), "test_logliks": test_ll,
           "kernel_launches": launches}
    print("cli " + json.dumps(row), flush=True)
    CLI_ROWS[tag] = row
    return row


def full_width_phase(trainer, args):
    import numpy as np
    import torch
    import mlease_tpu_torch.ops.tron_multi as tm
    from mlease_tpu_torch.ops.segment_sum import (segment_sum_gather_reference,
                                                  segment_sum_sorted)

    z_first = {}

    def keep_first(iteration, z, **_kw):
        if iteration == 1:
            z_first["z"] = z.clone()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    segment_sum_sorted.launches = 0          # main path: count from here
    with kernel_runs() as runs:
        res = trainer.run(callback=keep_first)
        torch.cuda.synchronize()
    launches = runs["k1"]                    # ... to here
    peak = torch.cuda.max_memory_allocated()
    F32_BASE["full"] = {"z1": z_first["z"].double().cpu().numpy(),
                        "z": res.z, "solver_stats": res.solver_stats,
                        "iter_s": res.iter_times, "peak_bytes": int(peak),
                        "resident_bytes": int(resident)}
    nt = sum(s["newton_trips"] for s in res.solver_stats)
    cg = sum(s["cg_trips"] for s in res.solver_stats)
    expected = 2 * cg + 2 * nt + 3 * len(res.solver_stats)
    row = {"rows": int(trainer.data.nrows.sum()), "dim": trainer.dim,
           "tail_entries": int(trainer.prob.tail_vals.numel()),
           "iterations": res.iterations, "iter_s": res.iter_times,
           "solver_stats": res.solver_stats, "kernel_launches": launches,
           "kernel_runs": runs, "expected_launches": expected,
           "max_memory_allocated_bytes": int(peak),
           "z_finite": bool(np.isfinite(res.z).all())}
    # K1's runs: eager, and inside run()'s device loop counted on the card;
    # beyond the host-driven solve's, those of the loop's set-up
    if launches == 0 or launches - runs["setup"]["k1"] != expected \
            or not runs["card"]["k1"] or not row["z_finite"]:
        raise AssertionError(f"full-width run: {row}")

    # the first iteration again, every sorted-tail reduce on the plain version
    trainer.config = dataclasses.replace(trainer.config, num_iters=1)
    before = segment_sum_sorted.launches
    fresh_loops(trainer)
    with mock.patch.object(tm, "segment_sum_gather",
                           segment_sum_gather_reference):
        plain = trainer.run()
    fresh_loops(trainer)
    if segment_sum_sorted.launches != before:
        raise AssertionError("the plain run launched the kernel")
    zk = z_first["z"].double().cpu().numpy()
    diff = float(np.abs(zk - plain.z).max())
    row["z_kernel_vs_plain_max_abs"] = diff
    row["z_max_abs"] = float(np.abs(zk).max())
    row["plain_iter_s"] = plain.iter_times
    row["plain_solver_stats"] = plain.solver_stats
    print("full-width " + json.dumps(row), flush=True)
    if not diff <= 1e-4 * row["z_max_abs"]:
        raise AssertionError(f"kernel and plain first iterations differ: "
                             f"{diff} vs max|z| {row['z_max_abs']}")
    return row


def device_time(fn):
    """Run fn() under torch.profiler: its host wall time and the device
    time by kernel (copies included). None when the profiler records no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_kernel = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue              # host events; device kernels and copies stay
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            by_kernel.append((ev.key, dev_us / 1e3, ev.count))
    if not by_kernel:
        return None
    by_kernel.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in by_kernel)
    seg = [r for r in by_kernel if "segment_sum_kernel" in r[0]]
    gram = [r for r in by_kernel if any(
        k in r[0] for k in ("gram_item_kernel", "gram_mma_kernel",
                            "gram_tile_kernel", "gram_reduce_kernel"))]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "segment_sum_kernel_ms": sum(r[1] for r in seg),
            "segment_sum_kernel_count": sum(r[2] for r in seg),
            "gram_kernel_ms": sum(r[1] for r in gram),
            "gram_kernel_count": sum(r[2] for r in gram),
            "top": [{"name": k[:100], "ms": ms, "count": c}
                    for k, ms, c in by_kernel[:15]]}


def speed_phase(trainers, args):
    """ADMM iterations/s at each shape: --iters timed iterations, then one
    ADMM step (no host transfers of z and u) under the profiler for the
    device's busy share and the time by kernel."""
    import torch

    device_time(lambda: torch.ones(1, device="cuda") + 1)  # profiler warm-up
    rows = {}
    for tag, trainer in trainers.items():
        trainer.config = dataclasses.replace(trainer.config,
                                             num_iters=args.iters)
        res = trainer.run()
        steady = res.iter_times[1:] or res.iter_times
        row = {"iter_s": res.iter_times, "solver_stats": res.solver_stats,
               "steady_iter_s": sum(steady) / len(steady),
               "iterations_per_s": len(steady) / sum(steady)}
        # the first iteration's step from z = u = 0, as run() takes it
        L, n, B = len(trainer.lambdas), trainer.dim, trainer.nblocks
        cfg, dev = trainer.config, trainer.device
        z = torch.zeros((L, n), dtype=cfg.dtype, device=dev)
        u = torch.zeros((L, B, n), dtype=cfg.dtype, device=dev)
        rho = torch.as_tensor(trainer.rhos, dtype=cfg.dtype, device=dev)
        eps = cfg.liblinear_epsilon * trainer.eps_scale
        stats = {}

        def one_step():
            stats.update(trainer.step(trainer.prob, trainer.present, z, u,
                                      trainer.lam_vec, rho, rho, eps)[3])
        one_step()                                    # warm
        row["profiled_step"] = device_time(one_step)
        row["profiled_step_stats"] = stats
        print(f"speed {tag} " + json.dumps(row), flush=True)
        rows[tag] = row
    return rows


STREAM_GROUPS = 4           # ctr-12m.job: num.blocks 8, streaming.groups 4
SCALE_CLI_ROWS = 1_000_000  # phase 12's training rows (ctr-12m.job: 12.5M)
# its test rows: make_scale_dataset.py writes 200,000 for 10M training
# rows; 5,000 here, since scoring them and writing the scored rows is most
# of a CLI run's time after training
SCALE_TEST_ROWS = 5_000


def steady_s(iter_times):
    steady = iter_times[1:] or iter_times
    return sum(steady) / len(steady)


def timed_puts(trainer):
    """One iteration's host->device copies and compact-wire rebuilds of
    every streamed group, alone (no solve), synchronised: seconds."""
    import torch
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for gi in range(len(trainer.groups)):
        trainer._put_group(gi)
    torch.cuda.synchronize()
    return time.monotonic() - t0


def plain_pinned_copy_s(nbytes, reps=5):
    """A plain copy of nbytes from page-locked host memory to the card."""
    import torch
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    src.fill_(1)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(reps):
        dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    return (time.monotonic() - t0) / reps


def span_profile(fn, span):
    """Run fn() under torch.profiler. For each host range named `span`
    (a torch.profiler.record_function in the code), its wall time and the
    time in it during which the device ran a kernel or a copy (device
    intervals merged); the idle share over all spans but the first; and
    the device time by kernel over the whole run. None when the profiler
    records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == span and e.device_type == DeviceType.CPU)
    busy = []
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.device_type != DeviceType.CUDA or e.name == span:
            continue
        lo, hi = e.time_range.start, e.time_range.end
        if busy and lo <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], hi)
        else:
            busy.append([lo, hi])
    if not busy or not spans:
        return None
    span_ms = [(hi - lo) / 1e3 for lo, hi in spans]
    busy_ms = [sum(max(0, min(hi, b1) - max(lo, b0)) for b0, b1 in busy)
               / 1e3 for lo, hi in spans]
    steady = slice(1, None) if len(spans) > 1 else slice(None)
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.key != span:
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            by_kernel[ev.key] = (dev_us / 1e3, ev.count)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    return {"span_ms": span_ms, "device_busy_ms": busy_ms,
            "device_idle_share_steady": 1.0 - sum(busy_ms[steady])
            / sum(span_ms[steady]),
            "top": [{"name": k[:100], "ms": ms, "count": c}
                    for k, (ms, c) in top]}


def streaming_phase(args, in_memory_iter_s=None):
    """Phase 11: StreamingAdmmTrainer at ctr-12m.job's widths (the full
    phase's rows in 8 blocks, 4 groups, head 128 stored as bfloat16), in three residency
    settings that must give the same bits."""
    import numpy as np
    import torch
    import mlease_tpu_torch.ops.tron_multi as tm
    from mlease_tpu_torch.core.dataset import split_blocks, to_hybrid
    from mlease_tpu_torch.ops.head_pass import head_xtv, head_xv
    from mlease_tpu_torch.ops.segment_sum import (segment_sum_gather_reference,
                                                  segment_sum_sorted)
    from mlease_tpu_torch.train.admm import AdmmConfig
    from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer
    from mlease_tpu_torch.utils import profiling
    from mlease_tpu_torch.utils.floor import (measure_put_bandwidth,
                                              streaming_floor)

    t0 = time.monotonic()
    nf = 1_000_000
    groups = split_blocks(synth_blocked_data(nf, 8, args.rows_per_block, 12,
                                             args.seed), STREAM_GROUPS)
    for i, g in enumerate(groups):
        groups[i] = to_hybrid(g, 128, column_sorted=True,
                              head_dtype=torch.bfloat16)
    vocab = make_vocab(nf)
    setup_s = time.monotonic() - t0
    cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=args.iters,
                     head_size=128, head_dtype=torch.bfloat16, pcg=True,
                     flat_blocks=True, dtype=torch.float32)
    head0 = int(groups[0].head.nbytes + groups[0].head_ids.nbytes)
    settings = {
        "a_job_budget": dict(resident_head_budget_gb=8.0),
        # pins group 0's head and streams the other groups' heads
        "b_one_head": dict(resident_head_budget_gb=1.2 * head0 / 2**30),
        "c_streamed_compact": dict(resident_head=False, compact_wire=True),
        "c_pageable": dict(resident_head=False, compact_wire=True,
                           pin_host=False),
    }
    rows, results = {}, {}
    z_first = {}

    def keep_first(iteration, z, **_kw):
        if iteration == 1:
            z_first["z"] = z.double().cpu().numpy()

    for name, kw in settings.items():
        t0 = time.monotonic()
        tr = StreamingAdmmTrainer(groups, vocab, cfg, **kw)
        torch.cuda.synchronize()
        build_s = time.monotonic() - t0
        torch.cuda.reset_peak_memory_stats()
        segment_sum_sorted.launches = 0          # this path: count from here
        head_xv.launches = head_xtv.launches = 0
        profiling.reset()
        with kernel_runs() as runs:
            res = tr.run(callback=keep_first if name.startswith("c_s")
                         else None)
            torch.cuda.synchronize()
        launches = runs["k1"]                    # ... to here
        row = {"residency": tr.residency_report(), "build_s": build_s,
               # the bf16 head's kernels: their runs on the card, and the
               # head passes the trainer's clock saw (the loops' warm-up,
               # whose stamps it puts back, apart)
               "head_kernels": head_runs(runs),
               "wire_bytes_per_iter": tr.stream_wire_bytes(),
               "dense_wire_bytes_per_iter": tr._dense_wire_bytes(),
               "iter_s": res.iter_times, "steady_iter_s": steady_s(
                   res.iter_times),
               "solver_stats": res.solver_stats,
               "kernel_launches": launches,
               "max_memory_allocated_bytes":
                   int(torch.cuda.max_memory_allocated()),
               "z_finite": bool(np.isfinite(res.z).all()),
               # the pipeline's log line (utils/floor.py, this card's table)
               "pass_floor": streaming_floor(
                   tr.groups, tr.trip_log, tr.stream_wire_bytes(),
                   steady_s(res.iter_times), measure_put_bandwidth(),
                   len(cfg.lambdas))}
        if name in ("a_job_budget", "c_streamed_compact"):
            if row["wire_bytes_per_iter"]:
                put_s = timed_puts(tr)
                plain_s = plain_pinned_copy_s(row["wire_bytes_per_iter"])
                row.update(
                    puts_alone_s=put_s,
                    puts_gb_per_s=row["wire_bytes_per_iter"] / put_s / 1e9,
                    plain_pinned_copy_gb_per_s=(
                        row["wire_bytes_per_iter"] / plain_s / 1e9))
            tr.config = dataclasses.replace(cfg, num_iters=3)
            row["profiled_iterations"] = span_profile(tr.run,
                                                      "stream_iteration")
        if name == "c_streamed_compact":
            # the first iteration again, every sorted-tail reduce plain
            tr.config = dataclasses.replace(cfg, num_iters=1)
            before = segment_sum_sorted.launches
            fresh_loops(tr)
            with mock.patch.object(tm, "segment_sum_gather",
                                   segment_sum_gather_reference):
                plain = tr.run()
            if segment_sum_sorted.launches != before:
                raise AssertionError("the plain run launched the kernel")
            row["z_kernel_vs_plain_max_abs"] = float(
                np.abs(z_first["z"] - plain.z).max())
            row["z_max_abs"] = float(np.abs(z_first["z"]).max())
        loops_stream_hook("float32", name, tr)
        del tr
        torch.cuda.empty_cache()
        print(f"streaming {name} " + json.dumps(row), flush=True)
        rows[name] = row
        results[name] = res
        if launches == 0 or not row["z_finite"]:
            raise AssertionError(f"streaming {name}: {row}")
        check_head_runs(row["head_kernels"], f"streaming {name}")
        check_floor(row["pass_floor"], f"streaming {name}")

    # phase 24 (c)'s reference: (c)'s run, on these groups
    COVERAGE["stream_c"] = {
        "groups": groups, "z": results["c_streamed_compact"].z,
        "u": results["c_streamed_compact"].u,
        "solver_stats": rows["c_streamed_compact"]["solver_stats"],
        "steady_iter_s": rows["c_streamed_compact"]["steady_iter_s"],
        "wire_bytes_per_iter": rows["c_streamed_compact"][
            "wire_bytes_per_iter"]}
    F32_BASE["stream"] = {
        "groups": groups, "setup_s": setup_s,
        "steady_iter_s": rows["a_job_budget"]["steady_iter_s"],
        "solver_stats": rows["a_job_budget"]["solver_stats"],
        "profiled_iterations": rows["a_job_budget"].get(
            "profiled_iterations")}
    a = results["a_job_budget"]
    same = {}
    for name in ("b_one_head", "c_streamed_compact", "c_pageable"):
        r = results[name]
        same[name] = {"z_equal": bool(np.array_equal(r.z, a.z)),
                      "u_equal": bool(np.array_equal(r.u, a.u)),
                      "max_abs_diff": max(float(np.abs(r.z - a.z).max()),
                                          float(np.abs(r.u - a.u).max()))}
    c = rows["c_streamed_compact"]
    exposed = max(0.0, c["steady_iter_s"] - rows["a_job_budget"][
        "steady_iter_s"])
    summary = {
        "setup_s": setup_s, "rows": 8 * args.rows_per_block,
        "vs_a": same,
        "copy_hidden_share": (1.0 - min(1.0, exposed / c["puts_alone_s"])
                              if c.get("puts_alone_s") else None),
        # the larger of the in-memory iteration on the same data (the
        # speed phase's, when it ran) and the wire over a plain copy
        "in_memory_iter_s": in_memory_iter_s,
        "wire_over_plain_copy_s": c["wire_bytes_per_iter"] / (
            c["plain_pinned_copy_gb_per_s"] * 1e9),
    }
    print("streaming-summary " + json.dumps(summary), flush=True)
    rows["summary"] = summary
    for name, s in same.items():
        if not (s["z_equal"] and s["u_equal"]):
            raise AssertionError(f"{name} differs from the job budget's run "
                                 f"by {s['max_abs_diff']}")
    if not c["z_kernel_vs_plain_max_abs"] <= 1e-4 * c["z_max_abs"]:
        raise AssertionError(f"kernel and plain first iterations differ: "
                             f"{c['z_kernel_vs_plain_max_abs']} vs max|z| "
                             f"{c['z_max_abs']}")
    return rows


def head_runs(runs):
    """The bf16 head kernels' runs in a kernel_runs() block around one
    trainer's run, beside the head passes of that run in the span store
    (its `head_pass` and `head_fused` executions; the store reset before
    the run)."""
    from mlease_tpu_torch.utils import profiling
    rec = profiling.recorded()
    spans = {"head_pass": 0, "head_fused": 0}
    for s in rec["spans"]:
        if s.name in spans:
            spans[s.name] += s.executions
    keys = ("head_xv", "head_xtv")
    return {"runs": sum(runs[k] for k in keys),
            "warm": sum(runs["warm"][k] for k in keys),
            "on_card": sum(runs["card"][k] for k in keys),
            "passes": spans["head_pass"], "fused": spans["head_fused"],
            "dropped": rec["dropped"]}


def check_head_runs(h, what):
    """Every head pass the clock saw ran in the kernels, one kernel run a
    pass: the runs past the loops' warm-up equal the passes, and the
    fused passes equal the passes, all above 0."""
    if not (h["passes"] > 0 and not h["dropped"]
            and h["fused"] == h["passes"] == h["runs"] - h["warm"]
            and h["on_card"] > 0):
        raise AssertionError(f"{what}: head kernels {h}")


FLOOR_TAG = "streaming pass-floor decomposition: "


def check_floor(sf, what):
    """A streamed run's pass-floor decomposition (utils/floor.py) must come
    from a table measured on this card, with a numeric util."""
    import torch
    name = torch.cuda.get_device_name(0)
    print(f"pass-floor {what} " + json.dumps(sf), flush=True)
    if not sf or not isinstance(sf.get("util"), float) \
            or name not in str(sf.get("source")):
        raise AssertionError(f"{what}: no floor decomposition from a table "
                             f"of {name}: {sf}")


def write_scale_dataset(path, n_rows, seed):
    """Avro rows at ctr-12m widths, the generator of
    examples/make_scale_dataset.py (1,000,000 features, 12 nonzeros a row
    on zipf 1.3, labels from a sparse ground truth), encoded by the port's
    native encoder."""
    import numpy as np
    from mlease_tpu_torch.io import avro, fast_encode

    n_features, nnz, chunk, block = 1_000_000, 12, 50_000, 4000
    w = (np.random.default_rng(12345).normal(size=n_features) * 0.3).astype(
        np.float32)
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with avro.AvroFileWriter(path, SCALE_SCHEMA, codec="null",
                             block_records=block) as out:
        done = 0
        while done < n_rows:
            m = min(chunk, n_rows - done)
            cols = (rng.zipf(1.3, size=(m, nnz)) - 1) % n_features
            vals = (rng.normal(size=(m, nnz)) * 0.5).astype(np.float32)
            score = np.einsum("rk,rk->r", vals, w[cols]) - 1.5
            y = (rng.random(m) < 1.0 / (1.0 + np.exp(-score))).astype(int)
            for s in range(0, m, block):
                e = min(s + block, m)
                out.append_raw_block(fast_encode.encode_ctr_block(
                    cols[s:e].astype(np.int32), vals[s:e],
                    y[s:e].astype(np.int32)), e - s)
            done += m


SCALE_SCHEMA = {
    "type": "record", "name": "CtrRow", "namespace": "mlease.examples",
    "fields": [
        {"name": "response", "type": "int"},
        {"name": "features", "type": {"type": "array", "items": {
            "type": "record", "name": "feature", "fields": [
                {"name": "name", "type": "string"},
                {"name": "term", "type": "string"},
                {"name": "value", "type": "float"}]}}},
        {"name": "weight", "type": "float"},
        {"name": "offset", "type": "float"},
    ]}


def scale_cli_phase(args):
    """Phase 12: `python -m mlease_tpu_torch train` twice on a copy of
    ctr-12m.job (paths replaced, pack.cache.dir set) over 1M rows: the
    native decoder must run and write the cache, the second run must hit
    it and give the same models bit for bit."""
    from mlease_tpu_torch.io import avro
    from mlease_tpu_torch.utils.config import JobConfig

    with tempfile.TemporaryDirectory(prefix="chip-smoke-scale-") as tmp:
        t0 = time.monotonic()
        write_scale_dataset(os.path.join(tmp, "train", "part-00000.avro"),
                            SCALE_CLI_ROWS, args.seed + 1000)
        write_scale_dataset(os.path.join(tmp, "test", "part-00000.avro"),
                            SCALE_TEST_ROWS, args.seed + 999)
        gen_s = time.monotonic() - t0
        props = dict(JobConfig.from_file(os.path.join(
            REPO, "examples", "data", "ctr-12m.job")))
        props.update({"input.paths": os.path.join(tmp, "train",
                                                  "part-00000.avro"),
                      "test.path": os.path.join(tmp, "test"),
                      "pack.cache.dir": os.path.join(tmp, "cache")})
        runs = []
        for k in (1, 2):
            props["output.base.path"] = os.path.join(tmp, f"out-{k}")
            job = os.path.join(tmp, f"ctr-12m-{k}.job")
            with open(job, "w") as f:
                f.writelines(f"{key}={v}\n" for key, v in props.items())
            env = dict(os.environ, PYTHONPATH=REPO, MLEASE_LOG="INFO")
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, "-m", "mlease_tpu_torch", "train", job],
                capture_output=True, text=True, env=env, cwd=REPO,
                timeout=CLI_TIMEOUT_S)
            wall = time.monotonic() - t0
            if proc.returncode != 0:
                raise AssertionError(f"scale CLI run {k} failed "
                                     f"({proc.returncode}):\n"
                                     f"{proc.stderr[-4000:]}")
            log = proc.stderr
            if args.out:
                with open(f"{args.out}.scale-cli-{k}.log", "w") as f:
                    f.write(log)
            summary = json.loads(proc.stdout.strip().splitlines()[-1])
            row = {"wall_s": wall, "solver_wall_s": summary["wall_time_s"],
                   "iterations": summary["iterations"],
                   "kernel_launches": summary["kernel_launches"][
                       "segment_sum_sorted"],
                   "native_ingest": "native ingest:" in log,
                   "python_fallback": "python path" in log,
                   "cache_written": "pack cache written" in log,
                   "cache_hit": "pack cache hit" in log}
            for line in log.splitlines():
                for key, tag in (("ingest", "ingest phase breakdown: "),
                                 ("pack_phases", "streaming pack phases: "),
                                 ("residency", "streaming residency: "),
                                 ("pass_floor", FLOOR_TAG)):
                    if tag in line:
                        row[key] = line.split(tag, 1)[1]
            row["pass_floor"] = json.loads(row.get("pass_floor", "null"))
            models = avro.read_records(os.path.join(
                props["output.base.path"], "final-model"))
            row["models"] = len(models)
            runs.append((row, models))
            print(f"scale-cli run {k} " + json.dumps(row), flush=True)
        (r1, m1), (r2, m2) = runs
        out = {"rows": SCALE_CLI_ROWS, "test_rows": SCALE_TEST_ROWS,
               "dataset_s": gen_s, "first": r1, "second": r2,
               "same_models": m1 == m2}
        bad = [what for what, ok in (
            ("native decoder ran in run 1", r1["native_ingest"]
             and not r1["python_fallback"]),
            ("cache written in run 1", r1["cache_written"]),
            ("cache hit in run 2", r2["cache_hit"]
             and not r2["native_ingest"]),
            ("K1 launched", r1["kernel_launches"] > 0
             and r2["kernel_launches"] > 0),
            ("models bit for bit", m1 == m2 and len(m1) > 0)) if not ok]
        if bad:
            raise AssertionError(f"scale CLI: not {bad}: {out}")
        for k, r in ((1, r1), (2, r2)):
            check_floor(r["pass_floor"], f"scale CLI run {k}")
        t0 = time.monotonic()
        out["handoff"] = handoff_check(tmp, props)
        out["handoff"]["s"] = time.monotonic() - t0
        print("scale-cli handoff " + json.dumps(out["handoff"]), flush=True)
        return out


def _group_arrays(g, fields=None):
    """A group's arrays, each numpy array with the arrays it views."""
    import numpy as np
    import torch
    for f in fields or g._fields:
        a = getattr(g, f)
        while isinstance(a, (np.ndarray, torch.Tensor)):
            yield a
            a = a.base if isinstance(a, np.ndarray) else None


def _same_bits(a, b) -> bool:
    import numpy as np
    import torch
    a, b = (torch.from_numpy(np.ascontiguousarray(x))
            if isinstance(x, np.ndarray) else x.cpu() for x in (a, b))
    return (a.dtype == b.dtype and a.shape == b.shape
            and (a.numel() == 0
                 or torch.equal(a.contiguous().view(torch.uint8),
                                b.contiguous().view(torch.uint8))))


def handoff_check(tmp, props):
    """Phase 12's build check: the pipeline's hand-off of streamed groups
    (train/pipeline.py::_streaming_trainer) on the card, at phase 12's
    rows and ctr-12m.job's layout, one iteration: the pack-cache write
    route (native ingest, split_blocks, the pipeline's hybrid conversion)
    and then its hit. Each build's originals must be gone once it
    returns, its arrays page-locked and equal bit for bit to a kept-list
    build's, and one iteration's z equal to that build's; the two routes
    pin the same bits and give the same z. (An empty array, such as a
    hybrid group's ELL slots, has no bytes to lock.)"""
    import weakref
    import torch
    from mlease_tpu_torch.core.dataset import split_blocks
    from mlease_tpu_torch.io import avro, pack_cache
    from mlease_tpu_torch.train import pipeline, streaming
    from mlease_tpu_torch.utils.config import JobConfig

    config = JobConfig(dict(props, **{
        "pack.cache.dir": os.path.join(tmp, "handoff-cache")}))
    cfg = dataclasses.replace(pipeline.admm_config_from_job(config),
                              num_iters=1)
    nblocks = config.get_int("num.blocks")
    files = avro.enumerate_avro_files(config.get_string("input.paths"))
    manifest = pack_cache.build_manifest(
        files, nblocks=nblocks, n_groups=config.get_int("streaming.groups"),
        head_size=cfg.head_size,
        head_dtype=pack_cache.dtype_name(cfg.head_dtype or cfg.dtype),
        num_click_replicates=cfg.num_click_replicates, seed=0,
        binary_feature=False)
    refs: list = []

    def track(what, groups, fields=None):
        refs.extend((what, weakref.ref(a)) for g in groups
                    for a in _group_arrays(g, fields))

    def kept_arrays(tr):
        return [*streaming._flat_tensors(
            (tr.groups, list(tr._wire.values()), tr.csc_perms)),
            *(g.nrows for g in tr.groups)]

    built: dict = {}

    class Probe(streaming.StreamingAdmmTrainer):
        def __init__(self, groups, vocab, cfg, **kw):
            items = list(groups)
            track("handed", items)
            kept = [g._replace(**{
                f: (a.clone() if isinstance(a, torch.Tensor)
                    else a.copy()) for f, a in g._asdict().items()
                if hasattr(a, "shape")}) for g in items]
            entries = list(kept)

            def hand():
                while items:
                    yield items.pop(0)
            t0 = time.monotonic()
            super().__init__(hand(), vocab, cfg, **kw)
            built["build_s"] = time.monotonic() - t0
            built["alive"] = [w for w, r in refs if r() is not None]
            built["kept"] = streaming.StreamingAdmmTrainer(kept, vocab, cfg,
                                                           **kw)
            built["kept_intact"] = (len(kept) == len(entries) and all(
                a is b for a, b in zip(kept, entries)))

    def route(name, groups, vocab, cache):
        with mock.patch.object(pipeline, "StreamingAdmmTrainer", Probe):
            tr = pipeline._streaming_trainer(config, cfg, groups, vocab,
                                             device="cuda", cache=cache)
        kept = built.pop("kept")
        mine, theirs = kept_arrays(tr), kept_arrays(kept)
        z, z_kept = tr.run().z, kept.run().z
        row = {"alive": sorted(set(built.pop("alive"))),
               "kept_intact": built.pop("kept_intact"),
               "build_s": built.pop("build_s"),
               "arrays": len(mine), "same_pinned": len(mine) == len(
                   theirs) and all(map(_same_bits, mine, theirs)),
               "all_page_locked": all(t.is_pinned() for t in mine
                                      if isinstance(t, torch.Tensor)
                                      and t.numel() > 0),
               "same_z": _same_bits(torch.as_tensor(z),
                                    torch.as_tensor(z_kept)),
               **tr._held_bytes()}
        bad = [what for what, ok in (
            ("originals freed", not row["alive"]),
            ("the kept list intact", row["kept_intact"]),
            ("pinned bits", row["same_pinned"]),
            ("page-locked", row["all_page_locked"]),
            ("z bits", row["same_z"])) if not ok]
        if bad:
            raise AssertionError(f"hand-off {name}: not {bad}: {row}")
        return row, mine, z

    t0 = time.monotonic()
    data, vocab = pipeline._native_prepare(
        config, cfg, files, nblocks, False, 0, tmp, main=False)
    if data is None:
        raise AssertionError("hand-off: native ingest did not run")
    ingest_s = time.monotonic() - t0
    track("packed data", [data])
    groups = split_blocks(data, config.get_int("streaming.groups"))
    del data
    track("ELL", groups, ("indices", "values"))
    write, pinned_w, z_w = route("cache write", groups, vocab,
                                 (config.get_string("pack.cache.dir"),
                                  manifest))
    del groups
    refs.clear()
    hit = pack_cache.load_groups(config.get_string("pack.cache.dir"),
                                 manifest)
    if hit is None:
        raise AssertionError("hand-off: the pack cache did not load")
    groups, vocab = hit
    del hit
    read, pinned_r, z_r = route("cache hit", groups, vocab, None)
    same = (len(pinned_w) == len(pinned_r)
            and all(map(_same_bits, pinned_w, pinned_r))
            and _same_bits(torch.as_tensor(z_w), torch.as_tensor(z_r)))
    if not same:
        raise AssertionError("hand-off: the cache hit pinned other bits "
                             "or gave another z than the cache write")
    del pinned_w, pinned_r
    torch.cuda.empty_cache()
    return {"ingest_s": ingest_s, "cache_write": write, "cache_hit": read,
            "routes_same_bits": same}


NAIVE_ROWS = 125_000         # phase 13's rows (ctr-12m.job: 12.5M)
NAIVE_BASE: dict = {}        # phase 13's rows and config, phase 22 (c)'s
NAIVE_LAMBDAS = [1.0, 10.0, 100.0]
FIT_ROWS, FIT_FEATURES, FIT_NNZ = 100_000, 512, 32


def naive_clis(args):
    """Phase 13's host part: its rows (NAIVE_ROWS, and SCALE_TEST_ROWS test
    rows) written as Avro into a new directory, its three CLI runs on them
    started together, and the same rows read and prepared in this process
    while they go; the CLI runs' rows and models, and the rows read."""
    import shutil
    from mlease_tpu_torch.core.linear_model import read_model_file
    from mlease_tpu_torch.core.prepare import prepare_to_blocks
    from mlease_tpu_torch.core.vocab import build_vocab
    from mlease_tpu_torch.io import avro
    from mlease_tpu_torch.utils.config import JobConfig

    tmp = tempfile.mkdtemp(prefix="chip-smoke-naive-")
    procs = {}
    try:
        t0 = time.monotonic()
        train = os.path.join(tmp, "train", "part-00000.avro")
        write_scale_dataset(train, NAIVE_ROWS, args.seed + 1000)
        write_scale_dataset(os.path.join(tmp, "test", "part-00000.avro"),
                            SCALE_TEST_ROWS, args.seed + 999)
        gen_s = time.monotonic() - t0
        base = dict(JobConfig.from_file(os.path.join(
            REPO, "examples", "data", "ctr-12m.job")))
        base.update({"input.paths": train,
                     "test.path": os.path.join(tmp, "test")})
        runs = {"naive": ("naive", {"compute.model.mean": "true"}),
                "boost_l2": ("train", {"initialize.boost.rate": "2.0"}),
                "boost_l1": ("train", {"initialize.boost.rate": "2.0",
                                       "regularizer": "1"})}
        env = dict(os.environ, PYTHONPATH=REPO, MLEASE_LOG="INFO")
        for name, (cmd, extra) in runs.items():
            props = dict(base, **extra,
                         **{"output.base.path": os.path.join(tmp, name)})
            job = os.path.join(tmp, f"{name}.job")
            with open(job, "w") as f:
                f.writelines(f"{k}={v}\n" for k, v in props.items())
            log = open(os.path.join(tmp, f"{name}.log"), "w")
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", "mlease_tpu_torch", cmd, job],
                stdout=subprocess.PIPE, stderr=log, text=True, env=env,
                cwd=REPO), log, time.monotonic())
        # the same rows in this process, read while the three runs go
        t0 = time.monotonic()
        blocks = prepare_to_blocks(avro.read_records(train), 8, seed=0)
        keyed = {str(i): b for i, b in enumerate(blocks)}
        vocab = build_vocab(r for b in blocks for r in b)
        del blocks
        read_s = time.monotonic() - t0
        rows = {}
        for name, (proc, log, t_start) in procs.items():
            out, _ = proc.communicate(timeout=CLI_TIMEOUT_S)
            log.close()
            text = open(log.name).read()
            if args.out:
                with open(f"{args.out}.naive-{name}.log", "w") as f:
                    f.write(text)
            if proc.returncode != 0:
                raise AssertionError(f"{name} CLI run failed "
                                     f"({proc.returncode}):\n{text[-4000:]}")
            summary = json.loads(out.strip().splitlines()[-1])
            rows[name] = {"wall_s": time.monotonic() - t_start,
                          "summary": summary,
                          "warm_start_logged": "warm start: z0 from" in text,
                          "native_ingest": "native ingest:" in text}
            for line in text.splitlines():
                if "warm start: z0 from" in line:
                    rows[name]["z0_line"] = line.split("warm start: ", 1)[1]
        out_dir = {k: os.path.join(tmp, k) for k in runs}
        init_dir = os.path.join(out_dir["boost_l2"], "initialModel")
        init = read_model_file(init_dir) if os.path.isdir(init_dir) else {}
        rows["boost_l2"]["initial_models"] = len(init)
        rows["boost_l1"]["initial_model_dir"] = os.path.isdir(os.path.join(
            out_dir["boost_l1"], "initialModel"))
        rows["boost_l2"]["iteration_0_loglik"] = os.path.exists(
            os.path.join(out_dir["boost_l2"], "sample-test-loglik",
                         "iteration-0.avro"))
        return {"base": base, "rows": rows, "init": init, "gen_s": gen_s,
                "read_s": read_s, "keyed": keyed, "vocab": vocab,
                "naive_cli": read_model_file(os.path.join(
                    out_dir["naive"], "models")),
                "means_cli": read_model_file(os.path.join(
                    out_dir["naive"], "final-model"))}
    finally:
        for proc, log, _ in procs.values():
            proc.kill()
            proc.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def naive_phase(args):
    """Phase 13: the naive trainer and the boosted warm start at ctr-12m
    widths. Three CLI runs on one Avro file, started together (naive_clis;
    in a whole run, beside phase 12's): `naive` (compute.model.mean),
    `train` with initialize.boost.rate (L2: the naive warm start) and the
    same with regularizer=1 (no warm start); then train_naive in this
    process on the same rows, with the kernels' launch counts read around
    it, against the naive run's mean models and, on two of the blocks in
    float64, against the same solve on the CPU."""
    import torch
    from mlease_tpu_torch.train.naive import NaiveConfig, train_naive

    clis = taken("naive_clis", naive_clis, args)
    base, rows, init = clis["base"], clis["rows"], clis["init"]
    naive_cli, means_cli = clis["naive_cli"], clis["means_cli"]
    keyed, vocab = clis["keyed"], clis["vocab"]
    gen_s, read_s = clis["gen_s"], clis["read_s"]

    # in process: the naive run's config, timed, kernels counted
    cfg = NaiveConfig(lambdas=NAIVE_LAMBDAS, liblinear_epsilon=float(
        base["liblinear.epsilon"]), compute_model_mean=True,
        dtype=torch.float32)
    NAIVE_BASE.update(keyed=keyed, vocab=vocab, cfg=cfg)  # phase 22
    with kernel_runs() as runs:
        t0 = time.monotonic()
        res = train_naive(keyed, cfg, vocab=vocab)          # the path
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    launches = {"segment_sum_sorted": runs["k1"],
                "gram_batched": runs["k2"], "setup": runs["setup"],
                "on_card": runs["card"]}
    profiled = device_time(lambda: train_naive(keyed, cfg, vocab=vocab))

    def diff(a, b):
        """max |coefficient difference| over two model dictionaries,
        infinite when their keys or features differ."""
        if sorted(a) != sorted(b) or any(
                sorted(a[k].coefficients) != sorted(b[k].coefficients)
                for k in a):
            return float("inf")
        return max_model_diff(a, b)[0]

    # float64 on two blocks, card against CPU, at a tight tolerance
    sub = {k: keyed[k] for k in ("0", "1")}
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64,
                                liblinear_epsilon=1e-6)
    t0 = time.monotonic()
    card64 = train_naive(sub, cfg64, vocab=vocab)
    cpu64 = train_naive(sub, cfg64, vocab=vocab, device="cpu")
    ref_s = time.monotonic() - t0
    row = {"rows": NAIVE_ROWS, "features": vocab.size, "blocks": 8,
           "lambdas": NAIVE_LAMBDAS, "dataset_s": gen_s,
           "read_prepare_s": read_s, "runs": rows,
           "models": len(res.models), "wall_s": wall_s,
           "solver_stats": res.solver_stats,
           "models_per_s": len(res.models) / wall_s,
           "models_per_s_solve": (len(res.models)
                                  / res.solver_stats["solve_s"]),
           "profiled_run": profiled,
           "kernel_launches": launches,
           "mean_vs_cli_max_abs": diff(res.mean_models, means_cli),
           "models_vs_cli_max_abs": diff(res.models, naive_cli),
           "initial_vs_naive_cli_max_abs": diff(init, naive_cli),
           "w_max_abs": max_model_diff(res.models, res.models)[1],
           "card_vs_cpu_f64_max_abs": diff(card64.models, cpu64.models),
           "f64_w_max_abs": max_model_diff(cpu64.models,
                                           cpu64.models)[1],
           "cpu_ref_s": ref_s}
    print("naive " + json.dumps(row), flush=True)
    bad = [what for what, ok in (
        ("models written", rows["naive"]["summary"]["models"] == 24
         and sorted(means_cli) == ["1.0", "10.0", "100.0"]),
        ("the in-process run equals the CLI's",
         row["mean_vs_cli_max_abs"] <= 1e-4 * row["w_max_abs"]
         and row["models_vs_cli_max_abs"] <= 1e-4 * row["w_max_abs"]),
        ("card equals CPU in float64",
         row["card_vs_cpu_f64_max_abs"] <= 1e-6 * row["f64_w_max_abs"]),
        ("L2 boost wrote initialModel/ and logged z0",
         len(init) == 24 and rows["boost_l2"]["warm_start_logged"]
         and rows["boost_l2"]["iteration_0_loglik"]
         and row["initial_vs_naive_cli_max_abs"]
         <= 1e-4 * row["w_max_abs"]),
        ("L1 boost did not warm-start",
         not rows["boost_l1"]["warm_start_logged"]
         and not rows["boost_l1"]["initial_model_dir"]),
        ("boosted runs read records",
         not rows["boost_l2"]["native_ingest"]
         and not rows["boost_l1"]["native_ingest"]),
        ("K1 ran in the boosted ADMM runs",
         rows["boost_l2"]["summary"]["kernel_launches"][
             "segment_sum_sorted"] > 0),
        ("K1 sums the naive ELL's X'v (its column-sorted copy) inside "
         "the solve's loop; K2 does not run",
         runs["card"]["k1"] > 0 and runs["k2"] == 0)) if not ok]
    if bad:
        raise AssertionError(f"naive phase: not {bad}: {row}")
    return row


def solver_modes_phase(trainers, args, flat_iter_s=None):
    """Phase 14: the per-block and head-block ADMM solves at full width on
    the full trainer's data, the streamed head-block solve (bfloat16 head,
    K2's bf16-in route) and, at bench.py's shape, the lanes solves
    (multi_rhs=False, dual_layout) against flat Jacobi."""
    import numpy as np
    import torch
    import mlease_tpu_torch.ops.tron_multi as tm
    from mlease_tpu_torch.core.dataset import split_blocks
    from mlease_tpu_torch.ops import gram
    from mlease_tpu_torch.ops.segment_sum import segment_sum_sorted
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer
    from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer

    full = trainers["full"]
    data, vocab = full.data, full.vocab
    base = dataclasses.replace(full.config, num_iters=args.iters)
    out = {}
    z_first = {}

    def run(name, cfg, build=AdmmTrainer, src=data, voc=vocab, **kw):
        t0 = time.monotonic()
        tr = build(src, voc, cfg, **kw)
        torch.cuda.synchronize()
        build_s = time.monotonic() - t0
        segment_sum_sorted.launches = gram.gram_batched.launches = 0

        def keep(iteration, z, **_kw):
            z_first.setdefault(name, {})[iteration] = \
                z.double().cpu().numpy()
        with kernel_runs() as runs:
            res = tr.run(callback=keep)
            torch.cuda.synchronize()
        # the runs of the solves: the device loop's set-up apart
        row = {"mode": tr.mode, "build_s": build_s, "iter_s": res.iter_times,
               "steady_iter_s": steady_s(res.iter_times),
               "solver_stats": res.solver_stats,
               "k1_launches": runs["k1"] - runs["setup"]["k1"],
               "k2_launches": runs["k2"] - runs["setup"]["k2"],
               "kernel_runs": runs,
               "z_finite": bool(np.isfinite(res.z).all()),
               "z_max_abs": float(np.abs(res.z).max())}
        out[name] = row
        print(f"solver-modes {name} " + json.dumps(row), flush=True)
        return tr, res

    def tight(name, tr):
        """One iteration again at liblinear.epsilon 1e-6: solves that stop
        far inside the job's tolerance, so that two solvers' z may be held
        to each other (at the job's 0.01 they differ by that tolerance)."""
        tr.config = dataclasses.replace(tr.config, num_iters=1,
                                        liblinear_epsilon=1e-6)
        res = tr.run()
        out[name] = {"solver_stats": res.solver_stats,
                     "iter_s": res.iter_times,
                     "z_finite": bool(np.isfinite(res.z).all()),
                     "z_max_abs": float(np.abs(res.z).max())}
        return res.z

    B = data.nblocks
    jac, res_jac = run("per_block_jacobi",
                       dataclasses.replace(base, flat_blocks=False))
    MESH_REFS["per_block_jacobi"] = res_jac       # phase 16 (a)'s reference
    z_jac = tight("tight_per_block_jacobi", jac)
    del jac
    hb, res_hb = run("head_block", dataclasses.replace(base,
                                                       pcg="head_block"))
    MESH_REFS["head_block"] = res_hb
    builds = sum(s["newton_trips"] + 1 for s in res_hb.solver_stats)
    row = out["head_block"]
    row["expected_k2_launches"] = B * builds
    # the first iteration again, every head Gram on K2's plain version
    hb.config = dataclasses.replace(base, pcg="head_block", num_iters=1)
    before = gram.gram_batched.launches
    fresh_loops(hb)
    with mock.patch.object(tm, "gram_batched", gram.gram_batched_reference):
        plain = hb.run()
    fresh_loops(hb)
    plain_launched = gram.gram_batched.launches != before
    zk = z_first["head_block"][1]
    row["z_kernel_vs_plain_max_abs"] = float(np.abs(zk - plain.z).max())
    row["z_first_max_abs"] = float(np.abs(zk).max())
    # one profiled step of head_block from z = u = 0
    L, n = len(hb.lambdas), hb.dim
    cfg, dev = hb.config, hb.device
    z = torch.zeros((L, n), dtype=cfg.dtype, device=dev)
    u = torch.zeros((L, B, n), dtype=cfg.dtype, device=dev)
    rho = torch.as_tensor(hb.rhos, dtype=cfg.dtype, device=dev)
    eps = cfg.liblinear_epsilon * hb.eps_scale
    stats = {}

    def one_step():
        stats.update(hb.step(hb.prob, hb.present, z, u, hb.lam_vec, rho,
                             rho, eps)[3])
    one_step()
    row["profiled_step"] = device_time(one_step)
    row["profiled_step_stats"] = stats
    z_hb = tight("tight_head_block", hb)
    out["tight_head_block_vs_per_block_jacobi_max_abs"] = float(np.abs(
        z_hb - z_jac).max())
    del hb
    torch.cuda.empty_cache()
    out["flat_jacobi_steady_iter_s"] = flat_iter_s

    # streamed, the job's 8 GB budget, head stored as bfloat16: head_block
    groups = split_blocks(data, STREAM_GROUPS)
    scfg = dataclasses.replace(base, num_iters=2, pcg="head_block",
                               head_dtype=torch.bfloat16)
    _st, res_st = run("stream_head_block", scfg, StreamingAdmmTrainer,
                      groups, resident_head_budget_gb=8.0)
    del _st, groups
    torch.cuda.empty_cache()
    srow = out["stream_head_block"]
    srow["k2_variant"] = gram.launch_config(
        3, data.padded_rows, data.head.shape[2], torch.bfloat16,
        True).variant
    # the in-memory head-block run after as many iterations, float32 head
    srow["vs_in_memory_f32_head_max_abs"] = float(np.abs(
        res_st.z - z_first["head_block"][2]).max()) \
        if 2 in z_first["head_block"] else None

    # the lanes solves at bench.py's shape, without a head (dual_layout
    # reads the column-sorted copy of the ELL nonzeros)
    bench = synth_blocked_data(50_000, 4, 16_384, 15, args.seed)
    bvocab = make_vocab(50_000)
    bcfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=args.iters,
                      pcg=True, flat_blocks=True, dtype=torch.float32)
    zt = {}
    for name, kw in (("bench_flat_jacobi", {}),
                     ("bench_lanes", dict(multi_rhs=False)),
                     ("bench_dual_layout", dict(dual_layout=True))):
        tr, _res = run(name, dataclasses.replace(bcfg, **kw), src=bench,
                       voc=bvocab)
        zt[name] = tight("tight_" + name, tr)
        del tr
    for name in ("bench_lanes", "bench_dual_layout"):
        out[f"tight_{name}_vs_flat_jacobi_max_abs"] = float(np.abs(
            zt[name] - zt["bench_flat_jacobi"]).max())

    cg = {k: sum(s["cg_trips"] for s in out[k]["solver_stats"])
          for k in ("per_block_jacobi", "head_block")}
    out["cg_trips_total"] = cg
    zmax = out["tight_per_block_jacobi"]["z_max_abs"]
    bzmax = out["tight_bench_flat_jacobi"]["z_max_abs"]
    bad = [what for what, ok in (
        ("finite z", all(r["z_finite"] for r in out.values()
                         if isinstance(r, dict) and "z_finite" in r)),
        ("K1 in the per-block solves", out["per_block_jacobi"]["k1_launches"]
         > 0 and row["k1_launches"] > 0 and srow["k1_launches"] > 0),
        ("K2 once per block per head-block build",
         row["k2_launches"] == B * builds
         and out["per_block_jacobi"]["k2_launches"] == 0),
        ("K2 in the streamed head-block solve, bf16-in",
         srow["k2_launches"] > 0 and srow["k2_variant"] == "mma"),
        ("the plain run launched no K2", not plain_launched),
        ("kernel vs plain first iteration",
         row["z_kernel_vs_plain_max_abs"] <= 1e-4 * row["z_first_max_abs"]),
        ("head-block z vs per-block Jacobi z",
         out["tight_head_block_vs_per_block_jacobi_max_abs"]
         <= 1e-3 * zmax),
        ("head-block CG trips <= Jacobi's",
         cg["head_block"] <= cg["per_block_jacobi"]),
        ("lanes and dual layout vs flat Jacobi at bench shape", all(
            out[f"tight_{k}_vs_flat_jacobi_max_abs"] <= 1e-3 * bzmax
            for k in ("bench_lanes", "bench_dual_layout")))) if not ok]
    print("solver-modes-summary " + json.dumps(
        {k: v for k, v in out.items() if not isinstance(v, dict)}),
        flush=True)
    if bad:
        raise AssertionError(f"solver modes: not {bad}")
    return out


def write_fit_libsvm(path, seed):
    """FIT_ROWS rows of FIT_NNZ distinct features out of FIT_FEATURES, a
    logistic response from a sparse ground truth, as libsvm lines."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = rng.normal(size=FIT_FEATURES) * 0.2
    cols = np.argsort(rng.random((FIT_ROWS, FIT_FEATURES)), axis=1)[
        :, :FIT_NNZ]
    vals = rng.normal(size=(FIT_ROWS, FIT_NNZ)).round(4)
    p = 1 / (1 + np.exp(-((vals * w[cols]).sum(1) - 0.5)))
    y = (rng.random(FIT_ROWS) < p).astype(int)
    with open(path, "w") as f:
        for i in range(FIT_ROWS):
            f.write(f"{y[i]} " + " ".join(
                f"f{c}:{v:g}" for c, v in zip(cols[i], vals[i])) + "\n")


def fit_phase(args):
    """Phase 15: `fit --posterior-var --posterior-cov --f64` on a synthetic
    libsvm file (100,000 rows x 512 features, 32 nonzeros a row, from
    --seed), in this process through the CLI's main: K2 builds the dense
    Hessian; the same fit with K2 patched to its plain version must give
    the same .cov within 1e-9 relative."""
    import numpy as np
    import mlease_tpu_torch.ops.objective as objective_mod
    from mlease_tpu_torch import cli
    from mlease_tpu_torch.ops.gram import gram_batched, gram_batched_reference

    with tempfile.TemporaryDirectory(prefix="chip-smoke-fit-") as tmp:
        data = os.path.join(tmp, "train.libsvm")
        t0 = time.monotonic()
        write_fit_libsvm(data, args.seed + 15)
        gen_s = time.monotonic() - t0
        runs = {}
        for name in ("kernel", "plain"):
            out = os.path.join(tmp, f"{name}.txt")
            ctx = (mock.patch.object(objective_mod, "gram_batched",
                                     gram_batched_reference)
                   if name == "plain" else contextlib.nullcontext())
            gram_batched.launches = 0
            t0 = time.monotonic()
            with ctx:
                rc = cli.main(["fit", data, "--out", out, "--posterior-var",
                               "--posterior-cov", "--f64"])
            runs[name] = {"rc": rc, "wall_s": time.monotonic() - t0,
                          "k2_launches": gram_batched.launches}

            def values(path):
                return np.array([float(line.rpartition(" = ")[2])
                                 for line in open(path)])
            runs[name]["cov"] = values(out + ".cov")
            runs[name]["w"] = values(out)
            runs[name]["cov_lines"] = sum(1 for _ in open(out + ".cov"))
        k, p = runs["kernel"], runs["plain"]
        scale = float(np.abs(p["cov"]).max())
        row = {"rows": FIT_ROWS, "features": FIT_FEATURES, "nnz": FIT_NNZ,
               "dataset_s": gen_s, "wall_s": k["wall_s"],
               "plain_wall_s": p["wall_s"], "k2_launches": k["k2_launches"],
               "plain_k2_launches": p["k2_launches"],
               "cov_lines": k["cov_lines"],
               "cov_kernel_vs_plain_max_abs": float(np.abs(
                   k["cov"] - p["cov"]).max()),
               "cov_max_abs": scale,
               "w_kernel_vs_plain_max_abs": float(np.abs(k["w"]
                                                         - p["w"]).max())}
        print("fit " + json.dumps(row), flush=True)
        if (k["rc"] != 0 or p["rc"] != 0 or k["k2_launches"] != 1
                or p["k2_launches"] != 0
                or k["cov_lines"] != (FIT_FEATURES + 1) ** 2
                or not np.isfinite(k["cov"]).all()
                or not row["cov_kernel_vs_plain_max_abs"] <= 1e-9 * scale):
            raise AssertionError(f"fit phase: {row}")
        return row

# ---------------------------------------------------------------------------
# phase 16: the mesh
# ---------------------------------------------------------------------------

def _fused_totals(stats):
    return {k: sum(int(s[k]) for s in stats)
            for k in ("newton_trips", "cg_trips")}


def _count_syncs(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): the number of
    synchronizing calls (blocking host reads and waits) it made."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in seen)


def fresh_loops(trainer):
    """Free a trainer's device loops (train/admm.py::_SolveLoop), so that
    its next run makes and captures them anew: a captured graph replays
    the kernels it was captured with, so a run with a kernel's wrapper
    patched to its plain version needs new loops, and so does the run
    after the patch is undone."""
    from mlease_tpu_torch.train.admm import _close_loops
    _close_loops(trainer._loops)


@contextlib.contextmanager
def kernel_runs():
    """K1's, K2's and the head kernels' runs on the card inside the block.
    A kernel wrapper adds one to its `launches` at each call: an eager
    launch, or a launch that a device loop's capture records into its
    graph, which then runs each time the graph does, counted on the card
    (ops/device_loop.py). So a kernel's runs here are its `launches` less
    the calls that the loops prepared here captured, plus the executions
    that the loops counted on the card here. "setup" counts apart, and
    among the runs, those of the loops' set-up: each _SolveLoop's (and the
    item trainer's _NewtonLoop's) first state and each loop's warm-up
    ("warm" alone: the runs whose clock stamps the warm-up puts back).
    Yields a dict filled in at the exit: {"k1", "k2", "head_xv",
    "head_xtv" (the runs), "setup", "warm", "eager", "card" (each by the
    same keys)}; it adds no host read before the exit."""
    from mlease_tpu_torch.ops import gram, head_pass
    from mlease_tpu_torch.ops.device_loop import DeviceLoop
    from mlease_tpu_torch.ops.segment_sum import segment_sum_sorted
    from mlease_tpu_torch.train import admm, item
    fns = {"k1": segment_sum_sorted, "k2": gram.gram_batched,
           "head_xv": head_pass.head_xv, "head_xtv": head_pass.head_xtv}
    names = {"k1": "segment_sum_gather", "k2": "gram_batched",
             "head_xv": "head_xv", "head_xtv": "head_xtv"}
    start = {k: f.launches for k, f in fns.items()}
    setup, captured = dict.fromkeys(fns, 0), dict.fromkeys(fns, 0)
    warm = dict.fromkeys(fns, 0)
    seen, box = {}, {}
    prepare, run = DeviceLoop.prepare, DeviceLoop.run
    inits = {cls: cls.__init__ for cls in (admm._SolveLoop,
                                           item._NewtonLoop)}

    def in_setup(fn, self, *a, **kw):
        before = {k: f.launches for k, f in fns.items()}
        fn(self, *a, **kw)
        for k, f in fns.items():
            setup[k] += f.launches - before[k]

    def prepared(self):
        fresh = self.on_card and self._handles is None
        before = {k: f.launches for k, f in fns.items()}
        in_setup(prepare, self)
        for k, f in fns.items():
            warm[k] += f.launches - before[k]
        if fresh:
            for k in fns:
                c = sum(b.get(names[k], 0) for b in self.captured.values())
                captured[k] += c
                setup[k] -= c
                warm[k] -= c

    def ran(self):
        if self not in seen:
            seen[self] = self.runs.clone()
        run(self)

    def maker(init):
        def made(self, *a, **kw):
            in_setup(init, self, *a, **kw)
        return made
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(DeviceLoop, "prepare",
                                              prepared))
        stack.enter_context(mock.patch.object(DeviceLoop, "run", ran))
        for cls, init in inits.items():
            stack.enter_context(mock.patch.object(cls, "__init__",
                                                  maker(init)))
        yield box
    card = dict.fromkeys(fns, 0)
    for lp, r0 in seen.items():
        ex = dict(zip(lp.kernels, (lp.runs - r0).tolist()[len(lp.names):]))
        for k in fns:
            card[k] += ex.get(names[k], 0)
    eager = {k: f.launches - start[k] - captured[k] for k, f in fns.items()}
    box.update({k: eager[k] + card[k] for k in fns}, setup=setup,
               warm=warm, eager=eager, card=card)


def fused_compare(name, tr, iters, profile=True):
    """run() against run_fused() on one trainer, --iters (or `iters`)
    iterations: bit for bit (or within 1e-6 * max|z| with equal trips,
    the difference recorded); the loop's K1 / K2 executions (counted on
    the card, and as captured launches x branch executions) against
    run()'s launches; s/iteration, the seconds of each whole run
    (run_fused's warm-up and capture included), capture seconds and peak
    memory of each; the card's idle share of
    run() from its profile and of the fused loop against run()'s busy
    time (the same kernels on the same values)."""
    import numpy as np
    import torch
    from mlease_tpu_torch.ops import gram
    from mlease_tpu_torch.ops.segment_sum import segment_sum_sorted

    tr.config = dataclasses.replace(tr.config, num_iters=1)
    tr.run()                  # warm: the first call on a trainer is cold
    tr.config = dataclasses.replace(tr.config, num_iters=iters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    segment_sum_sorted.launches = gram.gram_batched.launches = 0
    with kernel_runs() as runs:          # eager, and in run()'s device loop
        t0 = time.monotonic()
        run = tr.run()
        torch.cuda.synchronize()
        run_call_s = time.monotonic() - t0
    k_run = (runs["k1"], runs["k2"])
    run_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    fused = tr.run_fused()
    torch.cuda.synchronize()
    fused_call_s = time.monotonic() - t0
    fused_peak = torch.cuda.max_memory_allocated()
    counts = fused.loop_counts
    kexec = counts["kernel_executions"]
    derived = {c: sum(n[c] * counts["branch_executions"][b]
                      for b, n in counts["captured_launches"].items())
               for c in kexec}
    zmax = float(np.abs(run.z).max())
    row = {
        "mode": tr.mode, "iterations": [run.iterations, fused.iterations],
        "bit_for_bit": bool(np.array_equal(run.z, fused.z)
                            and np.array_equal(run.u, fused.u)
                            and run.diff_history == fused.diff_history),
        "max_abs_diff": max(float(np.abs(run.z - fused.z).max()),
                            float(np.abs(run.u - fused.u).max())),
        "z_max_abs": zmax,
        "trips_run": _fused_totals(run.solver_stats),
        "trips_fused": fused.solver_stats[0],
        # the fused loop reports wall / iterations: compare it with run()'s
        # mean over the same iterations (the first one takes more trips)
        "run_iter_s": steady_s(run.iter_times),
        "run_mean_iter_s": sum(run.iter_times) / len(run.iter_times),
        "fused_iter_s": fused.iter_times[0] if fused.iter_times else None,
        "compile_s": fused.compile_time,
        # each call end to end as its caller waits for it: run_fused's
        # warm-up and capture, and both results' copies to the host
        "run_call_s": run_call_s, "fused_call_s": fused_call_s,
        "k1_run_launches": k_run[0], "k2_run_launches": k_run[1],
        "k1_fused_executions": kexec["segment_sum_gather"],
        "k2_fused_executions": kexec["gram_batched"],
        "k1_k2_captured_x_branch_runs": [derived["segment_sum_gather"],
                                         derived["gram_batched"]],
        "branch_executions": counts["branch_executions"],
        "captured_launches": counts["captured_launches"],
        "run_peak_bytes": int(run_peak), "fused_peak_bytes": int(fused_peak),
    }
    if profile:
        keys = ("wall_ms", "device_busy_ms", "device_idle_share",
                "segment_sum_kernel_count", "gram_kernel_count")
        # run() under the profiler: its host overhead lengthens run()'s
        # waits on the host, so this idle share is an upper bound
        prof = device_time(tr.run)
        if prof:
            row["run_profile"] = {k: prof[k] for k in keys}
        # the loop alone: the window is its launch to the chunk end, where
        # the host does nothing but wait
        from mlease_tpu_torch.ops.device_loop import DeviceLoop
        launch, box = DeviceLoop.run, {}

        def profiled(self):
            box["p"] = device_time(lambda: launch(self))
        DeviceLoop.run = profiled
        try:
            tr.run_fused()
        finally:
            DeviceLoop.run = launch
        if box.get("p"):
            row["fused_loop_profile"] = {k: box["p"][k] for k in keys}
    print(f"fused {name} " + json.dumps(row), flush=True)
    bad = []
    if row["trips_fused"] != row["trips_run"] or \
            run.iterations != fused.iterations:
        bad.append("trips or iterations differ")
    if not row["bit_for_bit"] and not row["max_abs_diff"] <= 1e-6 * zmax:
        bad.append(f"z/u differ by {row['max_abs_diff']}")
    if row["k1_fused_executions"] != k_run[0] or k_run[0] == 0:
        bad.append(f"K1 ran {row['k1_fused_executions']} times in the loop "
                   f"against {k_run[0]} launches in run()")
    if row["k2_fused_executions"] != k_run[1]:
        bad.append(f"K2 ran {row['k2_fused_executions']} times in the loop "
                   f"against {k_run[1]} launches in run()")
    if derived != kexec:
        bad.append(f"kernel executions counted on the card {kexec} differ "
                   f"from captured launches x branch executions {derived}")
    if bad:
        raise AssertionError(f"fused {name}: {bad}")
    return row, run, fused


def fused_phase(trainers, args):
    """Phase 17: AdmmTrainer.run_fused, the driver loop as a CUDA graph
    that loops on the card, against run(): (a) full width (flat Jacobi,
    per-block Jacobi, head-block); (b) bench.py's default step, with
    checkpoint_every=2 against one chunk, a chunk under the sync debug
    mode "error" and the blocking host reads of each driver counted; (c)
    the train CLI with fused.loop = true and checkpoint.every = 2 against
    phase 5's eager run."""
    import numpy as np
    import torch
    from mlease_tpu_torch.ops.device_loop import DeviceLoop
    from mlease_tpu_torch.train.admm import AdmmTrainer

    out = {}
    # (b) first: the small shape, host-bound under run()
    bench = trainers["bench"]
    row, run, one = fused_compare("bench_flat", bench, 10)
    calls = []
    launch = DeviceLoop.run

    def checked(self):
        torch.cuda.set_sync_debug_mode("error")
        try:
            launch(self)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    DeviceLoop.run = checked
    try:
        chunked = bench.run_fused(checkpoint_every=2,
                                  callback=lambda **kw: calls.append(
                                      kw["iteration"]))
    finally:
        DeviceLoop.run = launch
    row["chunked_bit_for_bit"] = bool(
        np.array_equal(chunked.z, one.z) and np.array_equal(chunked.u, one.u)
        and chunked.diff_history == one.diff_history)
    row["chunk_callbacks"] = calls
    _, row["syncs_run"] = _count_syncs(bench.run)
    _, row["syncs_fused"] = _count_syncs(bench.run_fused)
    _, row["syncs_fused_chunked"] = _count_syncs(
        lambda: bench.run_fused(checkpoint_every=2))
    print("fused bench_chunks " + json.dumps(
        {k: row[k] for k in ("chunked_bit_for_bit", "chunk_callbacks",
                             "syncs_run", "syncs_fused",
                             "syncs_fused_chunked")}), flush=True)
    want_calls = list(range(2, one.iterations + 1, 2))
    if one.iterations % 2:
        want_calls.append(one.iterations)
    if not row["chunked_bit_for_bit"] or calls != want_calls:
        raise AssertionError(f"chunked fused run: {row}")
    out["bench"] = row
    # (a) full width: phase 7's trainer, then the per-block solves
    full = trainers["full"]
    out["full_flat"] = fused_compare("full_flat", full, args.iters)[0]
    for name, kw in (("full_per_block", dict(flat_blocks=False)),
                     ("full_head_block", dict(pcg="head_block"))):
        tr = AdmmTrainer(full.data, full.vocab,
                         dataclasses.replace(full.config, **kw))
        out[name] = fused_compare(name, tr, args.iters)[0]
        del tr
        torch.cuda.empty_cache()
    # (c) the CLI: fused.loop with checkpoint.every against phase 5's run
    if "eager" not in CLI_MODELS:
        cli_phase()
    cli = cli_phase(extra_props={"fused.loop": "true",
                                 "checkpoint.every": "2"}, tag="fused")
    ref, got = CLI_MODELS["eager"], CLI_MODELS["fused"]
    diff = max(
        [abs(got[k][0] - ref[k][0]) for k in ref]
        + [abs(got[k][1][f] - ref[k][1][f]) for k in ref for f in ref[k][1]])
    cli["max_abs_diff_vs_eager"] = diff
    out["cli"] = cli
    print("fused cli " + json.dumps(cli), flush=True)
    its = cli["iterations"]
    want_ckpt = sorted(f"iter-{i:05d}.{e}" for i in
                       sorted({*range(2, its + 1, 2), its})[-2:]
                       for e in ("json", "npz"))
    if sorted(got) != sorted(ref) or any(
            sorted(got[k][1]) != sorted(ref[k][1]) for k in ref) \
            or not diff <= 1e-10 or cli["checkpoints"] != want_ckpt \
            or len(cli["sample_loglik_files"]) != its:
        raise AssertionError(f"fused CLI run: {cli}, checkpoints wanted "
                             f"{want_ckpt}")
    return out


# ---------------------------------------------------------------------------
# phase 19: run_fused on the lanes solve and under a mesh (A1b), and the
# per-block solve in sub-stacks past the int32 bound (A16)
# ---------------------------------------------------------------------------

FUSED_LANES_ITERS = 5       # (a)'s iterations at bench


def _cli_together(runs):
    """cli_phase for each (tag, extra_props), the CLI processes started
    together; returns {tag: row}."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(runs)) as ex:
        futs = {tag: ex.submit(cli_phase, extra_props=props, tag=tag)
                for tag, props in runs}
        return {tag: f.result() for tag, f in futs.items()}


def _max_model_diff(ref, got):
    return max([abs(got[k][0] - ref[k][0]) for k in ref]
               + [abs(got[k][1][f] - ref[k][1][f]) for k in ref
                  for f in ref[k][1]])


def lanes_sorted_sum_check(name, prob, n, gen, L=3, squares=(False,),
                           tag="fused-more"):
    """The lanes objective's sorted sums on the card (ops/objective.py::
    _sorted_sum: K1 over prob.k1's ids, one call per block range), for
    every sorted stream prob carries and each of `squares` (True: the
    Hessian diagonal's sum of squared values, K1's square_from 0), against
    the float64 scatter of the same inputs (random out0 and V3): per entry
    |got - ref64| <= 1e-5 * (|out0| + sum|contrib|), K1's float32 bound
    (k1_tolerances). Returns one row per stream and square."""
    import torch
    from mlease_tpu_torch.ops import objective

    B, R = prob.y.shape
    tol = k1_tolerances()[torch.float32][0]
    rows = []
    for stream, (W, m) in (("csc", (n, R)), ("tail", (R, n)),
                           ("tail_c", (n, R))):
        if getattr(prob.k1, stream) is None:
            continue
        seg, idx, vals = (getattr(prob, f)
                          for f in objective._STREAMS[stream])
        for square in squares:
            V3 = torch.randn((L, B, m), generator=gen, device="cuda")
            out0 = torch.randn((L, B, W), generator=gen, device="cuda")
            got = objective._sorted_sum(prob, stream, out0.clone(), V3,
                                        square=square)
            torch.cuda.synchronize()

            def scatter64(o, v, V):
                v = v.double()
                return o.double().scatter_add_(
                    2, seg[None].expand(L, -1, -1), (v * v if square else v)
                    * V.double().gather(2, idx[None].expand(L, -1, -1)))
            err = (got.double() - scatter64(out0, vals, V3)).abs_()
            scale = scatter64(out0.abs(), vals.abs(), V3.abs())
            row = {"check": name, "stream": stream, "square": square,
                   "blocks": B, "lanes": L, "entries": int(seg.numel()),
                   "values": str(vals.dtype),
                   "ranges": [list(r) for r in prob.k1.ranges],
                   "max_abs_err": float(err.max()),
                   "max_rel_err": float(
                       (err / scale.clamp_min(1e-300)).max()),
                   "ok": bool((err <= tol * scale + 1e-300).all())}
            print(f"{tag} k1 " + json.dumps(row), flush=True)
            rows.append(row)
            del got, err, scale
            torch.cuda.empty_cache()
    return rows


def fused_more_phase(trainers, args):
    """Phase 19: (a) at bench's shape without a head, the lanes solves
    (multi_rhs=False, dual_layout) through run_fused against run(), and
    their sorted sums (K1) and the full trainer's tails against a float64
    scatter (lanes_sorted_sum_check); (b) at
    full width on a one-rank NCCL mesh, per-block Jacobi and head-block,
    run_fused against the mesh trainer's run() and phase 14's no-mesh run,
    with K1, K2 and all_reduce executions counted on the card against
    run()'s launches and calls; (c) the full per-block Jacobi solve with
    the int32 bound lowered so that its 8 blocks solve as 4 sub-stacks of
    2, against phase 14's run; (d) phase 5's job through the CLI with
    fused.loop = true under use.mesh and with multi.rhs = false, each
    against the same job run eagerly."""
    import numpy as np
    import torch
    import mlease_tpu_torch.ops.tron_multi as tm
    import mlease_tpu_torch.train.admm as admm_mod
    from mlease_tpu_torch.collectives import all_reduce
    from mlease_tpu_torch.ops import gram
    from mlease_tpu_torch.ops.objective import k1_streams
    from mlease_tpu_torch.ops.segment_sum import segment_sum_sorted
    from mlease_tpu_torch.parallel import distributed, make_mesh
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer

    out, bad, k1_rows = {}, [], []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    # (a) the lanes solves at bench's shape, as phase 14 runs them
    bench = synth_blocked_data(50_000, 4, 16_384, 15, args.seed)
    bvocab = make_vocab(50_000)
    bcfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0],
                      num_iters=FUSED_LANES_ITERS, pcg=True,
                      flat_blocks=True, dtype=torch.float32)
    for name, kw in (("lanes", dict(multi_rhs=False)),
                     ("dual_layout", dict(dual_layout=True))):
        tr = AdmmTrainer(bench, bvocab, dataclasses.replace(bcfg, **kw))
        row, _run, _fused = fused_compare(f"bench_{name}", tr,
                                          FUSED_LANES_ITERS, profile=False)
        _, row["syncs_run"] = _count_syncs(tr.run)
        _, row["syncs_fused"] = _count_syncs(tr.run_fused)
        print(f"fused-more (a) {name} " + json.dumps(
            {k: row[k] for k in ("bit_for_bit", "run_iter_s",
                                 "run_mean_iter_s", "fused_iter_s",
                                 "compile_s", "syncs_run", "syncs_fused",
                                 "trips_run", "k1_run_launches")}),
            flush=True)
        if not row["bit_for_bit"]:
            bad.append(f"(a) {name}: run_fused not bit for bit")
        out[f"bench_{name}"] = row
        # the sorted sums this solve ran, held against their plain float64
        # version: as built, and for the lanes problem also in sub-stacks
        # of 2 blocks (the bound lowered) and on a bfloat16 stream
        probs = {name: tr.prob}
        if name == "lanes":
            n, R = tr.dim, tr.prob.y.shape[1]
            with mock.patch.object(tm, "STACK_ID_BOUND", 2 * max(n, R) + 1):
                probs["lanes substacks"] = tr.prob._replace(
                    k1=k1_streams(tr.prob, n, tm.substack_ranges(
                        tr.prob.y.shape[0], n, R)))
            probs["lanes bfloat16"] = tr.prob._replace(
                csc_vals=tr.prob.csc_vals.to(torch.bfloat16))
        for label, prob in probs.items():
            k1_rows += lanes_sorted_sum_check(f"bench {label}", prob, tr.dim,
                                              gen)
        del tr, probs
    del bench
    # the tails' streams at full width: the full trainer's stacked problem
    # unstacked as the streamed lanes solve unstacks a group (its stacked
    # int32 ids are K1's), its ids held equal to those blocked_problem makes
    # from the per-block ids, then in sub-stacks of 2 blocks
    full = trainers["full"]
    if not isinstance(full.prob, tm.SubStacks):
        B, n = full.data.nblocks, full.dim
        lanes = admm_mod.unstack_problem(full.prob, B, n, torch.float32)
        R = lanes.y.shape[1]
        blocked = k1_streams(lanes, n, [(0, B)])
        same = all(
            (a is None) == (b is None) and all(
                bool(torch.equal(x, y)) for x, y in zip(a or (), b or ()))
            for a, b in zip(lanes.k1[1:], blocked[1:]))
        out["full_k1_ids_equal"] = same
        if not same:
            bad.append("(a) the stacked K1 ids differ from blocked_problem's")
        del blocked
        k1_rows += lanes_sorted_sum_check("full", lanes, n, gen)
        with mock.patch.object(tm, "STACK_ID_BOUND", 2 * max(n, R) + 1):
            lanes = lanes._replace(k1=k1_streams(
                lanes, n, tm.substack_ranges(B, n, R)))
        k1_rows += lanes_sorted_sum_check("full substacks", lanes, n, gen)
        del lanes
        torch.cuda.empty_cache()
    out["k1_sorted_sums"] = k1_rows
    bad += [f"(a) K1 sorted sum {r['check']} {r['stream']}: max rel err "
            f"{r['max_rel_err']}" for r in k1_rows if not r["ok"]]
    if not {"csc", "tail", "tail_c"} <= {r["stream"] for r in k1_rows}:
        bad.append("(a) a sorted stream went unchecked")

    # (b) a one-rank NCCL mesh at full width
    full = trainers["full"]
    data, vocab = full.data, full.vocab
    base = dataclasses.replace(full.config, num_iters=args.iters)
    for name, cfg in _mesh_modes(base).items():
        if name not in MESH_REFS:              # --fused-only
            tr = AdmmTrainer(data, vocab, cfg, device="cuda")
            MESH_REFS[name] = tr.run()
            del tr
    distributed.initialize_single("cuda")
    try:
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError("a cuda mesh must run NCCL")
        mesh = make_mesh(1, "cuda")
        for name, cfg in _mesh_modes(base).items():
            tr = AdmmTrainer(data, vocab, cfg, mesh=mesh)
            torch.cuda.synchronize()
            segment_sum_sorted.launches = gram.gram_batched.launches = 0
            all_reduce.launches = 0
            with kernel_runs() as runs:
                run = tr.run()
                torch.cuda.synchronize()
            # K1's, K2's and the head kernels' runs in run()'s solves (its
            # device loop's set-up apart: run_fused's is not counted on the
            # card)
            k_run = {"segment_sum_gather": runs["k1"] - runs["setup"]["k1"],
                     "gram_batched": runs["k2"] - runs["setup"]["k2"],
                     "head_xv": runs["head_xv"] - runs["setup"]["head_xv"],
                     "head_xtv": runs["head_xtv"]
                     - runs["setup"]["head_xtv"],
                     "all_reduce": all_reduce.launches}
            t0 = time.monotonic()
            fused = tr.run_fused()
            torch.cuda.synchronize()
            ref = MESH_REFS[name]
            counts = fused.loop_counts
            row = {"mode": tr.mode, "iterations": [run.iterations,
                                                   fused.iterations],
                   "bit_for_bit_run": bool(
                       np.array_equal(run.z, fused.z)
                       and np.array_equal(run.u, fused.u)
                       and run.diff_history == fused.diff_history),
                   "bit_for_bit_no_mesh": bool(
                       np.array_equal(ref.z, fused.z)
                       and np.array_equal(ref.u, fused.u)),
                   "trips_run": _fused_totals(run.solver_stats),
                   "trips_fused": fused.solver_stats[0],
                   "run_launches": k_run,
                   "fused_executions": counts["kernel_executions"],
                   "capture_modes": counts["capture_modes"],
                   "node_types_iteration_end":
                       counts["node_types"]["iteration_end"],
                   "run_iter_s": steady_s(run.iter_times),
                   "run_mean_iter_s": sum(run.iter_times)
                   / len(run.iter_times),
                   "fused_iter_s": fused.iter_times[0],
                   "compile_s": fused.compile_time,
                   "fused_call_s": time.monotonic() - t0}
            out[f"mesh_{name}"] = row
            print(f"fused-more (b) {name} " + json.dumps(row), flush=True)
            if not (row["bit_for_bit_run"] and row["bit_for_bit_no_mesh"]):
                bad.append(f"(b) {name}: not bit for bit")
            if row["trips_run"] != row["trips_fused"]:
                bad.append(f"(b) {name}: trips differ")
            if row["fused_executions"] != k_run or k_run[
                    "segment_sum_gather"] == 0 or k_run["all_reduce"] \
                    != 2 * run.iterations:
                bad.append(f"(b) {name}: executions on the card "
                           f"{row['fused_executions']} against run()'s "
                           f"{k_run}")
            if (k_run["gram_batched"] > 0) != (name == "head_block"):
                bad.append(f"(b) {name}: K2 launches {k_run}")
            del tr
            torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()

    # (c) the per-block solve in 4 sub-stacks of 2 blocks (the bound
    # lowered in this process only)
    n, R = data.dim, data.padded_rows
    cfg = _mesh_modes(base)["per_block_jacobi"]
    # K1's executions in each sub-stack's branches of the run's device
    # loop (captured launches x branch executions, counted on the card),
    # per iteration
    per_call, seen = [], {}

    def counted(**_kw):
        c = tr._loops["x"].loop.counts()
        for k in range(len(ranges)):
            got = sum(c["captured_launches"][b]["segment_sum_gather"]
                      * c["branch_executions"][b]
                      for b in c["captured_launches"]
                      if b.endswith(f".{k}"))
            per_call.append(got - seen.get(k, 0))
            seen[k] = got
    with mock.patch.object(tm, "STACK_ID_BOUND", 2 * max(n, R) + 1):
        t0 = time.monotonic()
        tr = AdmmTrainer(data, vocab, cfg)
        torch.cuda.synchronize()
        build_s = time.monotonic() - t0
        ranges = list(tr.prob.ranges) if isinstance(
            tr.prob, tm.SubStacks) else None
        segment_sum_sorted.launches = 0
        with kernel_runs() as runs:
            res = tr.run(callback=counted)
            torch.cuda.synchronize()
    ref = MESH_REFS["per_block_jacobi"]
    zmax = float(np.abs(ref.z).max())
    row = {"ranges": ranges, "build_s": build_s,
           "iter_s": res.iter_times, "steady_iter_s": steady_s(res.iter_times),
           "no_split_steady_iter_s": steady_s(ref.iter_times),
           "k1_launches": runs["k1"], "kernel_runs": runs,
           "k1_launches_per_substack_call": per_call,
           "solver_stats": res.solver_stats,
           "trips_equal": res.solver_stats == ref.solver_stats,
           "z_max_abs_diff": float(np.abs(res.z - ref.z).max()),
           "z_max_abs": zmax, "z_bitwise": bool(np.array_equal(res.z,
                                                               ref.z))}
    out["substacks"] = row
    print("fused-more (c) " + json.dumps(row), flush=True)
    if ranges != [(0, 2), (2, 4), (4, 6), (6, 8)]:
        bad.append(f"(c) sub-stacks {ranges}")
    if not (row["trips_equal"] and row["z_max_abs_diff"] <= 1e-6 * zmax):
        bad.append("(c) not within 1e-6 of phase 14's run with its trips")
    if len(per_call) != 4 * res.iterations or min(per_call) <= 0:
        bad.append(f"(c) K1 not launched by every sub-stack: {per_call}")
    del tr
    torch.cuda.empty_cache()

    # (d) the CLI: fused.loop under use.mesh and on the lanes solve, each
    # against the same job run eagerly (4 processes started together)
    cases = {"use.mesh": {"use.mesh": "true"},
             "multi.rhs=false": {"multi.rhs": "false"}}
    rows = _cli_together(
        [(f"{k} {how}", dict(v, **({"fused.loop": "true"}
                                   if how == "fused" else {})))
         for k, v in cases.items() for how in ("eager", "fused")])
    for k in cases:
        ref, got = CLI_MODELS[f"{k} eager"], CLI_MODELS[f"{k} fused"]
        diff = _max_model_diff(ref, got)
        row = {"iterations": [rows[f"{k} eager"]["iterations"],
                              rows[f"{k} fused"]["iterations"]],
               "max_abs_diff_fused_vs_eager": diff,
               "wall_s": [rows[f"{k} eager"]["wall_s"],
                          rows[f"{k} fused"]["wall_s"]]}
        if "eager" in CLI_MODELS:
            row["max_abs_diff_vs_phase_5"] = _max_model_diff(
                CLI_MODELS["eager"], got)
        out[f"cli {k}"] = row
        print(f"fused-more (d) {k} " + json.dumps(row), flush=True)
        if sorted(got) != sorted(ref) or not diff <= 1e-10:
            bad.append(f"(d) {k}: {row}")
    if bad:
        raise AssertionError(f"fused-more: {bad}")
    return out


MESH_REFS: dict = {}        # phase 14's no-mesh runs, phase 16 (a)'s reference
MESH_WORLD = 2              # gloo ranks on the one card in (b)-(e)
MESH_FS_ROWS = 125_000      # (d)'s rows per block (ctr-12m.job: 1,562,500)
MESH_RANK_TIMEOUT_S = 600


def _mesh_modes(base):
    return {"per_block_jacobi": dataclasses.replace(base, flat_blocks=False),
            "head_block": dataclasses.replace(base, pcg="head_block")}


def _untimed(stats):
    """solver_stats rows without their host timings (the *_s keys)."""
    return [{k: v for k, v in s.items() if not k.endswith("_s")}
            for s in stats]


def _rel(a, b):
    import numpy as np
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def mesh_one_rank_phase(trainers, args):
    """Phase 16 (a): the full trainer's data through AdmmTrainer on a
    one-rank NCCL mesh, per-block Jacobi and head-block, against phase 14's
    no-mesh runs of the same configuration (run here when phase 14 did
    not)."""
    import numpy as np
    import torch
    from mlease_tpu_torch.ops import gram
    from mlease_tpu_torch.ops.segment_sum import segment_sum_sorted
    from mlease_tpu_torch.collectives import all_reduce
    from mlease_tpu_torch.parallel import BLOCK_AXIS, distributed, make_mesh
    from mlease_tpu_torch.train.admm import AdmmTrainer

    full = trainers["full"]
    data, vocab = full.data, full.vocab
    base = dataclasses.replace(full.config, num_iters=args.iters)
    out = {}
    distributed.initialize_single("cuda")
    try:
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError("a cuda mesh must run NCCL")
        mesh = make_mesh(1, "cuda")
        group = mesh.get_group(BLOCK_AXIS)
        for name, cfg in _mesh_modes(base).items():
            ref = MESH_REFS.get(name)
            if ref is None:                  # --mesh-only
                tr = AdmmTrainer(data, vocab, cfg, device="cuda")
                ref = MESH_REFS[name] = tr.run()
                del tr
            tr = AdmmTrainer(data, vocab, cfg, mesh=mesh)
            torch.cuda.synchronize()
            segment_sum_sorted.launches = gram.gram_batched.launches = 0
            with kernel_runs() as runs:
                res = tr.run()
                torch.cuda.synchronize()
            row = {"mode": tr.mode, "iter_s": res.iter_times,
                   "steady_iter_s": steady_s(res.iter_times),
                   "no_mesh_steady_iter_s": steady_s(ref.iter_times),
                   "solver_stats": res.solver_stats,
                   "trips_equal": res.solver_stats == ref.solver_stats,
                   "k1_launches": runs["k1"], "k2_launches": runs["k2"],
                   "z_bitwise": bool(np.array_equal(res.z, ref.z)),
                   "u_bitwise": bool(np.array_equal(res.u, ref.u)),
                   "z_rel_diff": _rel(res.z, ref.z),
                   "u_rel_diff": _rel(res.u, ref.u),
                   "z_finite": bool(np.isfinite(res.z).all())}
            row["mesh_minus_no_mesh_iter_s"] = (
                row["steady_iter_s"] - row["no_mesh_steady_iter_s"])
            del tr
            torch.cuda.empty_cache()
            out[name] = row
            print(f"mesh (a) {name} " + json.dumps(row), flush=True)
        # the step's two collectives alone: (2, L, n) sums, trip maxima
        L, n = len(base.lambdas), data.dim
        buf = torch.zeros((2, L, n), dtype=base.dtype, device="cuda")
        trips = torch.zeros(2, dtype=torch.int64, device="cuda")
        out["nccl_sum_ms"] = cuda_ms(lambda: all_reduce(buf, "sum",
                                                        group))
        out["nccl_trip_max_ms"] = cuda_ms(lambda: all_reduce(
            trips, "max", group).cpu())
    finally:
        torch.distributed.destroy_process_group()
    print("mesh (a) " + json.dumps({k: v for k, v in out.items()
                                     if not isinstance(v, dict)}),
          flush=True)
    bad = [f"{k}: {what}" for k, r in out.items() if isinstance(r, dict)
           for what, ok in (
               ("finite z", r["z_finite"]),
               ("per_block mode", r["mode"] == "per_block"),
               ("equal trips", r["trips_equal"]),
               ("z, u bit for bit or within 1e-6",
                (r["z_bitwise"] and r["u_bitwise"])
                or max(r["z_rel_diff"], r["u_rel_diff"]) <= 1e-6),
               ("K1 launched", r["k1_launches"] > 0),
               ("K2 in head-block only", (r["k2_launches"] > 0)
                == (k == "head_block"))) if not ok]
    if bad:
        raise AssertionError(f"mesh (a): not {bad}")
    return out


def _rank_gram_check(hx, gen):
    """K2 on one block of this rank's head (3 lanes sharing X, random
    weights) against a float64 reference: per entry
    |G - G64| <= 1e-5 * sum_r |d x_i x_j| (phase 4's tolerance)."""
    import torch
    from mlease_tpu_torch.ops import gram
    R, H = hx.shape
    d = torch.rand((3, R), generator=gen, device="cuda")
    pvi = torch.rand((3, H), generator=gen, device="cuda") + 0.5
    before = gram.gram_batched.launches
    got = gram.gram_batched(hx, d, pvi)
    launched = gram.gram_batched.launches - before
    x64 = hx.double()
    ref = torch.stack([(x64.T * d[b].double()) @ x64 for b in range(3)]) \
        + torch.diag_embed(pvi.double())
    scale = torch.stack([(x64.abs().T * d[b].double()) @ x64.abs()
                         for b in range(3)])
    err = (got.double() - ref).abs()
    plain = gram.gram_batched_reference(hx, d, pvi)
    return {"k2_check_launches": launched,
            "k2_max_abs_err": float(err.max()),
            "k2_ok": bool((err <= 1e-5 * scale + 1e-300).all()),
            "k2_vs_plain_max_abs": float((got - plain).abs().max())}


def _mesh_rank(args) -> int:
    """One rank of phase 16 (b)-(e), started by mesh_phase: gloo over the
    one card; writes its numbers to --mesh-out/rank<R>.json."""
    import numpy as np
    import torch
    from mlease_tpu_torch.core.dataset import split_blocks, to_hybrid
    from mlease_tpu_torch.ops import gram
    from mlease_tpu_torch.ops.segment_sum import segment_sum_sorted
    from mlease_tpu_torch.collectives import COLLECTIVE_STATS
    from mlease_tpu_torch.parallel import distributed, make_mesh
    from mlease_tpu_torch.parallel.mesh import make_mesh_2d
    from mlease_tpu_torch.train import item
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer
    from mlease_tpu_torch.train.feature_sharded import \
        FeatureShardedAdmmTrainer
    from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer

    rank, world = args.mesh_rank, MESH_WORLD
    distributed.initialize("cuda", backend="gloo",
                           init_method=f"file://{args.mesh_init}",
                           world_size=world, rank=rank)
    mesh = make_mesh(world, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + rank)
    out = {"rank": rank}

    def counted(fn):
        torch.cuda.synchronize()
        distributed.barrier()
        segment_sum_sorted.launches = gram.gram_batched.launches = 0
        COLLECTIVE_STATS.update(calls=0, seconds=0.0)
        with kernel_runs() as runs:
            t0 = time.monotonic()
            res = fn()
            torch.cuda.synchronize()
            wall_s = time.monotonic() - t0
        return res, {"wall_s": wall_s,
                     "k1_launches": runs["k1"], "k2_launches": runs["k2"],
                     "collective_calls": COLLECTIVE_STATS["calls"],
                     "collective_s": COLLECTIVE_STATS["seconds"]}

    # (b) the full trainer's data (ctr-12m widths), 4 blocks a rank
    t0 = time.monotonic()
    nf = 1_000_000
    # the parent's data (synth_blocked_data at --rows-per-block), saved once
    data = to_hybrid(load_blocked(args.mesh_data), 128)
    vocab = make_vocab(nf)
    out["setup_s"] = time.monotonic() - t0
    base = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=args.iters,
                      head_size=128, pcg=True, flat_blocks=True,
                      dtype=torch.float32)
    z_at = {}
    for name, cfg in _mesh_modes(base).items():
        t0 = time.monotonic()
        tr = AdmmTrainer(data, vocab, cfg, mesh=mesh)
        build_s = time.monotonic() - t0

        def keep(iteration, z, **_kw):
            z_at[(name, iteration)] = z.double().cpu().numpy()
        res, row = counted(lambda: tr.run(callback=keep))
        row.update(build_s=build_s, mode=tr.mode, iter_s=res.iter_times,
                   steady_iter_s=steady_s(res.iter_times),
                   solver_stats=res.solver_stats,
                   z_sha1=hashlib.sha1(res.z.tobytes()).hexdigest(),
                   u_sha1=hashlib.sha1(res.u.tobytes()).hexdigest(),
                   u_shape=list(res.u.shape),
                   blocks_here=int(tr.data.nblocks))
        if rank == 0:
            np.save(os.path.join(args.mesh_out, f"z_{name}.npy"), res.z)
        if name == "head_block":
            # each kernel against its plain version on one call of this
            # rank's data: K1 at the X'v site of its stacked problem, K2 on
            # its first block's head
            checks = []
            fused_check_and_time(f"rank{rank}/xtv", fused_sites(tr)["xtv"],
                                 3, torch.float32, gen, checks)
            row["k1_check"] = {k: checks[0][k] for k in (
                "max_abs_err", "max_rel_err", "ok", "kernel_ms",
                "plain_ms")}
            row["k2_check"] = _rank_gram_check(tr.prob.head_x[0], gen)
        out[name] = row
        del tr
        torch.cuda.empty_cache()

    # (c) streamed: phase 11's split (4 groups), nothing pinned, 2 iterations
    scfg = dataclasses.replace(base, num_iters=2, head_dtype=torch.bfloat16)
    t0 = time.monotonic()
    st = StreamingAdmmTrainer(split_blocks(data, STREAM_GROUPS), vocab, scfg,
                              mesh=mesh, resident_head=False)
    build_s = time.monotonic() - t0
    res, row = counted(st.run)
    z2 = z_at[("per_block_jacobi", min(2, args.iters))]
    row.update(build_s=build_s, mode=st.mode, iter_s=res.iter_times,
               residency=st.residency_report(),
               wire_bytes_per_iter=st.stream_wire_bytes(),
               solver_stats=res.solver_stats,
               z_sum=float(np.abs(res.z).sum()),
               z_finite=bool(np.isfinite(res.z).all()),
               z_vs_in_memory_f32_head_rel=_rel(res.z, z2))
    out["streaming"] = row
    del st, data, res
    torch.cuda.empty_cache()

    # (d) feature-sharded 1 x world, ELL at ctr-12m widths, rows cut; a
    # gloo feat group cannot be captured on the card (run() raises), so
    # run() takes each x-update through the host-driven seam
    ell = synth_blocked_data(nf, 8, MESH_FS_ROWS, 12, args.seed)
    fcfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=2, pcg=True,
                      flat_blocks=False, dtype=torch.float32)
    t0 = time.monotonic()
    fst = FeatureShardedAdmmTrainer(ell, vocab, fcfg,
                                    mesh=make_mesh_2d(1, world, "cuda"))
    build_s = time.monotonic() - t0
    fst._x_update = fst._host_x_update
    res, row = counted(fst.run)
    row.update(x_update="the host-driven seam (_host_x_update)",
               build_s=build_s, iter_s=res.iter_times,
               solver_stats=res.solver_stats, z_sum=float(np.abs(
                   res.z).sum()), z_finite=bool(np.isfinite(res.z).all()),
               collective_s_per_iter=row["collective_s"] / res.iterations,
               collective_calls_per_iter=(row["collective_calls"]
                                          / res.iterations))
    if rank == 0:
        # the same data and solve on this rank alone, the columns whole
        ref = AdmmTrainer(ell, vocab, fcfg, device="cuda").run()
        row["z_vs_unsharded_rel"] = _rel(res.z, ref.z)
        row["unsharded_solver_stats"] = ref.solver_stats
        row["unsharded_iter_s"] = ref.iter_times
    out["feature_sharded"] = row
    del fst, ell, res
    torch.cuda.empty_cache()

    # (e) phase 8's 10,000 items, items split over the ranks
    decoded = synth_item_decoded(10_000, 48, 12, args.seed)
    icfg = item.ItemConfig(intercept_lambdas=[1.0],
                           default_lambdas=[1.0, 10.0], compute_var=True,
                           full_cov=True, solver="cholesky",
                           dtype=torch.float32)
    res, row = counted(lambda: item.train_item_models_columnar(
        decoded, icfg, mesh=mesh))
    row.update(models=len(res.models), buckets=res.solver_stats)
    if rank == 0:
        plain = item.train_item_models_columnar(decoded, icfg,
                                                device="cuda")
        diff, scale = max_model_diff(res.models, plain.models)
        vdiff, vscale = max_model_diff(res.posterior_var,
                                       plain.posterior_var)
        # phase 22 (d): since the item problem sums X'v with K1 (one
        # order every run), whether 2 ranks give one rank's bits
        row.update(w_vs_one_rank_max_abs=diff, w_max_abs=scale,
                   var_vs_one_rank_max_abs=vdiff, var_max_abs=vscale,
                   same_keys=set(res.models) == set(plain.models),
                   bit_for_bit_with_one_rank=diff == 0 and vdiff == 0
                   and res.covariances == plain.covariances)
    out["item"] = row
    distributed.barrier()
    torch.distributed.destroy_process_group()
    with open(os.path.join(args.mesh_out, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def mesh_phase(args):
    """Phase 16 (b)-(f): MESH_WORLD gloo ranks on the one card, each a
    process of this script (_mesh_rank), then `train --mesh 1` on the
    card."""
    import numpy as np

    row = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-") as tmp:
        data_path = os.path.join(tmp, "data.npz")
        save_blocked(synth_blocked_data(1_000_000, 8, args.rows_per_block,
                                        12, args.seed), data_path)
        env = dict(os.environ, PYTHONPATH=REPO, MLEASE_LOG="WARNING")
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT"):
            env.pop(k, None)
        t0 = time.monotonic()
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"),
             "--mesh-rank", str(r),
             "--mesh-init", os.path.join(tmp, "pg"), "--mesh-out", tmp,
             "--mesh-data", data_path,
             "--seed", str(args.seed), "--rows-per-block",
             str(args.rows_per_block), "--iters", str(args.iters)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO) for r in range(MESH_WORLD)]
        logs = [""] * MESH_WORLD
        try:
            for r, p in enumerate(procs):
                logs[r], _ = p.communicate(timeout=max(
                    1.0, MESH_RANK_TIMEOUT_S - (time.monotonic() - t0)))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        row["ranks_wall_s"] = time.monotonic() - t0
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(f"mesh rank {r} failed "
                                     f"({p.returncode}):\n{logs[r][-4000:]}")
        ranks = []
        for r in range(MESH_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        zs = {name: np.load(os.path.join(tmp, f"z_{name}.npy"))
              for name in ("per_block_jacobi", "head_block")}
    bad = []
    r0 = ranks[0]
    for name in ("per_block_jacobi", "head_block"):
        ref = MESH_REFS[name]
        b = {"z_vs_one_rank_rel": _rel(zs[name], ref.z),
             "trips_equal_one_rank": r0[name]["solver_stats"]
             == ref.solver_stats,
             "ranks_same_z": all(r[name]["z_sha1"] == r0[name]["z_sha1"]
                                 for r in ranks),
             "ranks_same_u": all(r[name]["u_sha1"] == r0[name]["u_sha1"]
                                 for r in ranks),
             "one_rank_steady_iter_s": steady_s(ref.iter_times)}
        row[name] = b
        bad += [f"(b) {name}: {w}" for w, ok in (
            ("z within 1e-5 of one rank", b["z_vs_one_rank_rel"] <= 1e-5),
            ("equal trips", b["trips_equal_one_rank"]),
            ("every rank the same z and u",
             b["ranks_same_z"] and b["ranks_same_u"]),
            ("u gathered whole", r0[name]["u_shape"][1] == 8),
            ("4 blocks a rank", all(r[name]["blocks_here"] == 4
                                    for r in ranks)),
            ("K1 launched on every rank", all(r[name]["k1_launches"] > 0
                                              for r in ranks)))
            if not ok]
    bad += [f"(b) rank {r['rank']}: {w}" for r in ranks for w, ok in (
        ("K2 launched in head-block",
         r["head_block"]["k2_launches"] > 0
         and r["per_block_jacobi"]["k2_launches"] == 0),
        ("K1 vs plain", r["head_block"]["k1_check"]["ok"]),
        ("K2 vs plain", r["head_block"]["k2_check"]["k2_ok"]
         and r["head_block"]["k2_check"]["k2_check_launches"] == 1))
        if not ok]
    s0 = r0["streaming"]
    bad += [f"(c) {w}" for w, ok in (
        ("finite z", s0["z_finite"]),
        ("every rank the same z", all(r["streaming"]["z_sum"]
                                      == s0["z_sum"] for r in ranks)),
        ("K1 launched on every rank", all(r["streaming"]["k1_launches"] > 0
                                          for r in ranks)),
        ("nothing pinned, dense wire",
         s0["residency"]["heads_pinned"] == 0
         and s0["residency"]["compact_wire_groups"] == 0),
        ("z within 2e-3 of the float32-head run",
         s0["z_vs_in_memory_f32_head_rel"] <= 2e-3)) if not ok]
    f0 = r0["feature_sharded"]
    bad += [f"(d) {w}" for w, ok in (
        ("finite z", f0["z_finite"]),
        ("every rank the same z", all(r["feature_sharded"]["z_sum"]
                                      == f0["z_sum"] for r in ranks)),
        ("K1 launched on every rank (X'v over the ELL's column copy), "
         "K2 on none", all(r["feature_sharded"]["k1_launches"] > 0
                           and r["feature_sharded"]["k2_launches"] == 0
                           for r in ranks)),
        ("z within 1e-5 of the unsharded solve",
         f0["z_vs_unsharded_rel"] <= 1e-5)) if not ok]
    i0 = r0["item"]
    bad += [f"(e) {w}" for w, ok in (
        ("20,000 models, the same keys", i0["models"] == 20_000
         and i0["same_keys"]),
        ("models within 1e-6 of one rank",
         i0["w_vs_one_rank_max_abs"] <= 1e-6 * i0["w_max_abs"]),
        ("posterior variances within 1e-6 of one rank",
         i0["var_vs_one_rank_max_abs"] <= 1e-6 * i0["var_max_abs"]),
        ("every rank the same bucket stats, 20,000 problems",
         all(_untimed(r["item"]["buckets"]) == _untimed(i0["buckets"])
             for r in ranks)
         and sum(b["problems"] for b in i0["buckets"]) == 20_000),
        ("K2 launched on every rank", all(r["item"]["k2_launches"] > 0
                                          for r in ranks))) if not ok]
    row["ranks"] = ranks
    row["cli"] = cli_phase(extra_args=("--mesh", "1", "--device", "cuda"),
                           tag="mesh")
    print("mesh " + json.dumps({k: v for k, v in row.items()
                                if k != "ranks"}), flush=True)
    for r in ranks:
        print(f"mesh rank {r['rank']} " + json.dumps(r), flush=True)
    if bad:
        raise AssertionError(f"mesh: not {bad}")
    return row



# ---------------------------------------------------------------------------
# phase 18: the bfloat16 compute dtype
# ---------------------------------------------------------------------------

def bf16_kernel_phase(trainer, args):
    """Phase 18 (a): K1's bf16 entry against its plain version at the full
    trainer's three fused sites (`_xv_lm`, `_xtv_lm`, the 2L site) as a
    bfloat16 solve calls them, the stream's values and random V rounded to
    bfloat16 and a float32 accumulator (per segment |kernel - ref64| <=
    1e-5 * (|out0| + sum|contrib|)); the `_xtv_lm` site into a bfloat16
    accumulator and the contrib form on its column stream (one rounding
    more: + 2^-8 * |ref64|); the library call (gather, multiply in
    bfloat16, index_add_ in the accumulator's type)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 18)
    results = []
    for site, streams in fused_sites(trainer).items():
        for out_dtype in ((torch.float32, torch.bfloat16) if site == "xtv"
                          else (torch.float32,)):
            fused_check_and_time(f"full/{site}", streams, 3, torch.bfloat16,
                                 gen, results, variants=False,
                                 out_dtype=out_dtype)
            torch.cuda.empty_cache()
    seg, S = stacked_tails(trainer)["xtv_cols"]
    check_and_time("full/xtv_cols", seg, S, 3, torch.bfloat16, gen, results)
    torch.cuda.empty_cache()
    return results


def _prob_bytes(trainer) -> int:
    import torch.utils._pytree as pytree
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(trainer.prob)
               if hasattr(t, "element_size"))


def bf16_full_phase(trainer, args):
    """Phase 18 (b): the full trainer's data (phases 6 and 7) through a
    bfloat16 AdmmTrainer, flat Jacobi, --iters iterations: K1's bf16 entry
    counted around exactly this run; z finite, within 1% of max|z_f32|
    after iteration 1 and 5% after the last, against phase 6's float32 run
    of the same data; trips, s an iteration and a CG trip, and device
    memory beside phase 6's."""
    import numpy as np
    import torch
    from mlease_tpu_torch.ops.segment_sum import segment_sum_sorted
    from mlease_tpu_torch.train.admm import AdmmTrainer

    base = F32_BASE["full"]
    cfg = dataclasses.replace(trainer.config, dtype=torch.bfloat16,
                              num_iters=args.iters)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    tr = AdmmTrainer(trainer.data, trainer.vocab, cfg)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    resident = torch.cuda.memory_allocated()
    z_first = {}

    def keep_first(iteration, z, **_kw):
        if iteration == 1:
            z_first["z"] = z.double().cpu().numpy()

    torch.cuda.reset_peak_memory_stats()
    segment_sum_sorted.launches = 0          # this path: count from here
    with kernel_runs() as runs:
        res = tr.run(callback=keep_first)
        torch.cuda.synchronize()
    launches = runs["k1"]                    # ... to here
    peak = torch.cuda.max_memory_allocated()

    def per_cg_trip(stats, iter_s):
        cg = sum(s["cg_trips"] for s in stats[1:] or stats)
        return steady_s(iter_s) * len(stats[1:] or stats) / max(cg, 1)

    nt = sum(s["newton_trips"] for s in res.solver_stats)
    cg = sum(s["cg_trips"] for s in res.solver_stats)
    zmax1 = float(np.abs(base["z1"]).max())
    zmax = float(np.abs(base["z"]).max())
    row = {
        "rows": int(tr.data.nrows.sum()), "dim": tr.dim,
        "setup_s": setup_s, "iterations": res.iterations,
        "kernel_launches": launches, "kernel_runs": runs,
        "expected_launches": 2 * cg + 2 * nt + 3 * len(res.solver_stats),
        "z_finite": bool(np.isfinite(res.z).all()),
        "z1_vs_f32_max_abs": float(np.abs(z_first["z"] - base["z1"]).max()),
        "z1_f32_max_abs": zmax1,
        "z_vs_f32_max_abs": float(np.abs(res.z - base["z"]).max()),
        "z_f32_max_abs": zmax,
        "trips_bf16": res.solver_stats, "trips_f32": base["solver_stats"],
        "iter_s_bf16": res.iter_times, "iter_s_f32": base["iter_s"],
        "steady_iter_s_bf16": steady_s(res.iter_times),
        "steady_iter_s_f32": steady_s(base["iter_s"]),
        "s_per_cg_trip_bf16": per_cg_trip(res.solver_stats, res.iter_times),
        "s_per_cg_trip_f32": per_cg_trip(base["solver_stats"],
                                         base["iter_s"]),
        "data_bytes_bf16": _prob_bytes(tr),
        "data_bytes_f32": _prob_bytes(trainer),
        "allocated_by_setup_bytes_bf16": int(resident - before),
        "run_peak_over_resident_bytes_bf16": int(peak - resident),
        "run_peak_over_resident_bytes_f32": int(base["peak_bytes"]
                                                - base["resident_bytes"]),
        "max_memory_allocated_bytes_bf16": int(peak),
        "max_memory_allocated_bytes_f32": base["peak_bytes"],
    }
    del tr
    torch.cuda.empty_cache()
    print("bf16-full " + json.dumps(row), flush=True)
    bad = []
    if not row["z_finite"]:
        bad.append("z not finite")
    if launches == 0 or launches - runs["setup"]["k1"] \
            != row["expected_launches"] or not runs["card"]["k1"]:
        bad.append(f"K1 ran {launches} times ({runs}), expected "
                   f"{row['expected_launches']} and the set-up's")
    if not row["z1_vs_f32_max_abs"] <= 0.01 * zmax1:
        bad.append("iteration 1 not within 1% of max|z_f32|")
    if not row["z_vs_f32_max_abs"] <= 0.05 * zmax:
        bad.append(f"iteration {res.iterations} not within 5% of "
                   f"max|z_f32|")
    if bad:
        raise AssertionError(f"bf16 full width: {bad}: {row}")
    return row


def bf16_bench_phase(trainer, args):
    """Phase 18 (c): the bench cell in bfloat16, per-block Jacobi and
    head-block (K2's bf16-in route in the head-block build): run_fused
    against run() bit for bit, K1 (and K2) executions in the loop equal to
    run()'s launches (phase 17's fused_compare, unprofiled); then the lanes
    solve timed in both types."""
    import numpy as np
    import torch
    from mlease_tpu_torch.train.admm import AdmmTrainer

    rows = {}
    for mode, kw in (("per_block", dict(flat_blocks=False, pcg=True)),
                     ("head_block", dict(pcg="head_block"))):
        cfg = dataclasses.replace(trainer.config, dtype=torch.bfloat16,
                                  num_iters=args.iters, **kw)
        tr = AdmmTrainer(trainer.data, trainer.vocab, cfg)
        row, _run, _fused = fused_compare(f"bf16 bench/{mode}", tr,
                                          args.iters, profile=False)
        del tr, _run, _fused
        torch.cuda.empty_cache()
        rows[mode] = row
        if not row["bit_for_bit"]:
            raise AssertionError(f"bf16 bench/{mode}: run_fused differs "
                                 f"from run() by {row['max_abs_diff']}")
        if mode == "head_block" and row["k2_run_launches"] == 0:
            raise AssertionError("bf16 head-block: K2 never launched")
    # the lanes solve (multi_rhs=False; ops/objective.py, K1 on its sorted
    # streams) in
    # bfloat16 and float32 on the same data: s an iteration and trips, z
    # within (b)'s 5% of max|z_f32| after the last iteration
    lanes = {}
    for dt in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(trainer.config, dtype=dt, multi_rhs=False,
                                  num_iters=args.iters)
        tr = AdmmTrainer(trainer.data, trainer.vocab, cfg)
        res = tr.run()
        torch.cuda.synchronize()
        lanes[dt] = res
        del tr
        torch.cuda.empty_cache()
    f32, bf = lanes[torch.float32], lanes[torch.bfloat16]
    zmax = float(np.abs(f32.z).max())
    row = {"iter_s_f32": f32.iter_times, "iter_s_bf16": bf.iter_times,
           "steady_iter_s_f32": steady_s(f32.iter_times),
           "steady_iter_s_bf16": steady_s(bf.iter_times),
           "trips_f32": f32.solver_stats, "trips_bf16": bf.solver_stats,
           "z_finite": bool(np.isfinite(bf.z).all()),
           "z_vs_f32_max_abs": float(np.abs(bf.z - f32.z).max()),
           "z_f32_max_abs": zmax}
    print("bf16-bench lanes " + json.dumps(row), flush=True)
    rows["lanes"] = row
    if not row["z_finite"] or not row["z_vs_f32_max_abs"] <= 0.05 * zmax:
        raise AssertionError(f"bf16 bench lanes: {row}")
    return rows


def _copy_kernel_ms(prof):
    """Device ms of the elementwise copy kernels (dtype conversions among
    them) in a span_profile's top kernels."""
    if not prof:
        return None
    return sum(k["ms"] for k in prof["top"] if "copy" in k["name"].lower())


def bf16_stream_phase(args):
    """Phase 18 (d): phase 11's stream (a) data (ctr-12m's split, 4 groups)
    in bfloat16 compute, the head stored as bfloat16 and read as stored:
    the job's budget, one pinned head, and nothing pinned with the compact
    wire, --iters iterations each, the same bits, each run's pass-floor
    decomposition from a bfloat16 table of this card; s an iteration
    beside phase 11's (a) (float32 compute, bfloat16 head), and the copy
    kernels (the head's widening among them) of 3 profiled iterations of
    each."""
    import numpy as np
    import torch
    from mlease_tpu_torch.ops.segment_sum import segment_sum_sorted
    from mlease_tpu_torch.train.admm import AdmmConfig
    from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer
    from mlease_tpu_torch.utils.floor import (measure_put_bandwidth,
                                              streaming_floor)

    base = F32_BASE.pop("stream")
    groups = base["groups"]
    cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=args.iters,
                     head_size=128, head_dtype=torch.bfloat16, pcg=True,
                     flat_blocks=True, dtype=torch.bfloat16)
    head0 = int(groups[0].head.nbytes + groups[0].head_ids.nbytes)
    settings = {
        "a_job_budget": dict(resident_head_budget_gb=8.0),
        "b_one_head": dict(resident_head_budget_gb=1.2 * head0 / 2**30),
        "c_streamed_compact": dict(resident_head=False, compact_wire=True),
    }
    rows, results = {}, {}
    vocab = make_vocab(1_000_000)
    put_bw = measure_put_bandwidth()         # one card: measured once
    for name, kw in settings.items():
        t0 = time.monotonic()
        tr = StreamingAdmmTrainer(groups, vocab, cfg, **kw)
        torch.cuda.synchronize()
        build_s = time.monotonic() - t0
        torch.cuda.reset_peak_memory_stats()
        segment_sum_sorted.launches = 0          # this path: count from here
        with kernel_runs() as runs:
            res = tr.run()
            torch.cuda.synchronize()
        launches = runs["k1"]                    # ... to here
        row = {"residency": tr.residency_report(), "build_s": build_s,
               "wire_bytes_per_iter": tr.stream_wire_bytes(),
               "iter_s": res.iter_times,
               "steady_iter_s": steady_s(res.iter_times),
               "solver_stats": res.solver_stats, "kernel_launches": launches,
               "max_memory_allocated_bytes":
                   int(torch.cuda.max_memory_allocated()),
               "z_finite": bool(np.isfinite(res.z).all()),
               # the pipeline's log line: a bfloat16 run takes a bfloat16
               # table (tools/torch_pass_floors*_bf16.json) or none
               "pass_floor": streaming_floor(
                   tr.groups, tr.trip_log, tr.stream_wire_bytes(),
                   steady_s(res.iter_times), put_bw, len(cfg.lambdas),
                   dtype=cfg.dtype)}
        if name == "a_job_budget":
            tr.config = dataclasses.replace(cfg, num_iters=3)
            prof = span_profile(tr.run, "stream_iteration")
            row["profiled_iterations"] = prof
            row["copy_kernel_ms_3_iterations"] = _copy_kernel_ms(prof)
        loops_stream_hook("bfloat16", name, tr)
        del tr
        torch.cuda.empty_cache()
        print(f"bf16-stream {name} " + json.dumps(row), flush=True)
        rows[name], results[name] = row, res
        if launches == 0 or not row["z_finite"]:
            raise AssertionError(f"bf16 stream {name}: {row}")
        check_floor(row["pass_floor"], f"bf16 stream {name}")
        if "bfloat16" not in row["pass_floor"]["source"]:
            raise AssertionError(f"bf16 stream {name}: the floor is not "
                                 f"from a bfloat16 table")
    del groups, base["groups"]
    a = results["a_job_budget"]
    same = {name: bool(np.array_equal(r.z, a.z) and np.array_equal(r.u, a.u))
            for name, r in results.items()}
    summary = {
        "same_bits_as_a": same,
        "steady_iter_s_bf16": rows["a_job_budget"]["steady_iter_s"],
        "steady_iter_s_f32_compute": base["steady_iter_s"],
        "trips_bf16": rows["a_job_budget"]["solver_stats"],
        "trips_f32_compute": base["solver_stats"],
        "copy_kernel_ms_3_iterations_bf16":
            rows["a_job_budget"]["copy_kernel_ms_3_iterations"],
        "copy_kernel_ms_3_iterations_f32_compute":
            _copy_kernel_ms(base["profiled_iterations"]),
    }
    print("bf16-stream-summary " + json.dumps(summary), flush=True)
    rows["summary"] = summary
    if not all(same.values()):
        raise AssertionError(f"bf16 stream: residency settings differ: "
                             f"{same}")
    return rows


def bf16_item_phase(args):
    """Phase 18 (e): phase 8's items in bfloat16, each route against
    phase 8's float32 models of that route: the Cholesky route (K2's
    bf16-in route, launches counted) on its 10,000 items at its settings,
    posterior variances on the diagonal, against its main run; TRON on
    its 1,000 items solved to liblinear.epsilon 1e-6, against its TRON
    run. Models within 1e-2 * max|w|. models/s of both routes on the
    10,000 items at phase 8's settings (TRON's timed only: at
    liblinear.epsilon 0.01 the float32 TRON itself stops up to about 1%
    of max|w| from the optimum, so its models are held at 1e-6)."""
    import math
    import torch
    from mlease_tpu_torch.train import item

    base = F32_BASE.pop("item")
    cfg = item.ItemConfig(intercept_lambdas=[1.0],
                          default_lambdas=[1.0, 10.0], compute_var=True,
                          full_cov=False, solver="cholesky",
                          dtype=torch.bfloat16)
    runs = {
        "cholesky": (base["decoded"], cfg, base["models"]),
        "tron": (base["decoded"], dataclasses.replace(cfg, solver="tron"),
                 None),
        "tron_tight": (base["small"], dataclasses.replace(
            base["tight"], dtype=torch.bfloat16, solver="tron"),
            base["tron"])}
    rows = {}
    # phase 22 (b)'s first loop runs
    kept = {"cholesky": "b bf16 cholesky", "tron_tight": "b bf16 tron"}
    for name, (decoded, rcfg, ref) in runs.items():
        # this path, counted from here to here (kernel_runs in _counted)
        loop_run = item_loop_run(lambda: item.train_item_models_columnar(
            decoded, rcfg, device="cuda"))
        if name in kept:
            ITEM_LOOP_RUNS[kept[name]] = loop_run
        res, wall = loop_run["res"], loop_run["counts"]["s"]
        launches = loop_run["counts"]["k2"]
        finite = all(math.isfinite(m.intercept) and all(
            math.isfinite(v) for v in m.coefficients.values())
            for m in res.models.values())
        row = {"models": len(res.models), "s": wall,
               "models_per_s": len(res.models) / wall,
               "liblinear_epsilon": rcfg.liblinear_epsilon,
               "buckets": res.solver_stats, "gram_launches": launches,
               "finite": finite}
        if ref is not None:
            row["w_vs_f32_max_abs"], row["w_f32_max_abs"] = \
                max_model_diff(res.models, ref)
        print(f"bf16-item {name} " + json.dumps(row), flush=True)
        rows[name] = row
        if not finite or (ref is not None and not row[
                "w_vs_f32_max_abs"] <= 1e-2 * row["w_f32_max_abs"]) or (
                name == "cholesky" and launches == 0):
            raise AssertionError(f"bf16 items ({name}): {row}")
    return rows


def bf16_cli_phase(args):
    """Phase 18 (f): `train --device cuda` on phase 5's job with dtype =
    bfloat16: phase 5's output layout, final models within 5% of
    max|w| of phase 5's (float64), checkpoint arrays of the bf16 bits
    (|V2, as the JAX package writes them)."""
    row = cli_phase(extra_props={"dtype": "bfloat16"}, tag="bf16")
    ref, got = CLI_MODELS["eager"], CLI_MODELS["bf16"]
    diff = scale = 0.0
    for key, (b, coef) in ref.items():
        gb, gcoef = got[key]
        diff = max(diff, abs(gb - b), *(abs(gcoef[k] - v)
                                        for k, v in coef.items()))
        scale = max(scale, abs(b), *(abs(v) for v in coef.values()))
    row.update(models_vs_float64_max_abs=diff, models_float64_max_abs=scale,
               same_layout_as_phase_5=row["files"] == CLI_ROWS["eager"][
                   "files"])
    print("bf16-cli " + json.dumps({k: row[k] for k in (
        "models_vs_float64_max_abs", "models_float64_max_abs",
        "same_layout_as_phase_5", "checkpoint_arrays")}), flush=True)
    bad = []
    if not row["same_layout_as_phase_5"]:
        bad.append("output layout differs from phase 5's")
    if sorted(got) != sorted(ref) or not diff <= 0.05 * scale:
        bad.append("models not within 5% of max|w| of phase 5's")
    if any(v[0] != "|V2" for v in row["checkpoint_arrays"].values()) or \
            not row["checkpoint_arrays"]:
        bad.append("checkpoint arrays are not the bf16 bits (|V2)")
    if bad:
        raise AssertionError(f"bf16 CLI: {bad}: {row}")
    return row


def bf16_baselines(trainers, args):
    """--bf16-only: the float32 runs phase 18 compares with, made as the
    full run's phases 5, 6, 8 and 11 make them (phase 6 whole; phase 8's
    first run; phase 11's stream (a) once, 3 iterations profiled)."""
    import torch
    from mlease_tpu_torch.core.dataset import split_blocks, to_hybrid
    from mlease_tpu_torch.train import item
    from mlease_tpu_torch.train.admm import AdmmConfig
    from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer

    cli_phase()
    full_width_phase(trainers["full"], args)
    decoded = synth_item_decoded(10_000, 48, 12, args.seed)
    cfg = item.ItemConfig(intercept_lambdas=[1.0], default_lambdas=[1.0, 10.0],
                          compute_var=True, full_cov=True, solver="cholesky",
                          dtype=torch.float32)
    small = synth_item_decoded(1_000, 48, 12, args.seed + 1)
    tight = dataclasses.replace(cfg, full_cov=False, liblinear_epsilon=1e-6)
    F32_BASE["item"] = {
        "decoded": decoded, "small": small, "tight": tight,
        "models": item.train_item_models_columnar(
            decoded, cfg, device="cuda").models,
        "tron": item.train_item_models_columnar(
            small, dataclasses.replace(tight, solver="tron"),
            device="cuda").models}
    t0 = time.monotonic()
    groups = split_blocks(synth_blocked_data(1_000_000, 8,
                                             args.rows_per_block, 12,
                                             args.seed), STREAM_GROUPS)
    for i, g in enumerate(groups):
        groups[i] = to_hybrid(g, 128, column_sorted=True,
                              head_dtype=torch.bfloat16)
    setup_s = time.monotonic() - t0
    scfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=args.iters,
                      head_size=128, head_dtype=torch.bfloat16, pcg=True,
                      flat_blocks=True, dtype=torch.float32)
    tr = StreamingAdmmTrainer(groups, make_vocab(1_000_000), scfg,
                              resident_head_budget_gb=8.0)
    res = tr.run()
    tr.config = dataclasses.replace(scfg, num_iters=3)
    prof = span_profile(tr.run, "stream_iteration")
    del tr
    torch.cuda.empty_cache()
    F32_BASE["stream"] = {"groups": groups, "setup_s": setup_s,
                          "steady_iter_s": steady_s(res.iter_times),
                          "solver_stats": res.solver_stats,
                          "profiled_iterations": prof}
    return {"stream_setup_s": setup_s,
            "stream_steady_iter_s": steady_s(res.iter_times)}


# phase 20: the public lanes-minor passes and what each launches of K1 on a
# hybrid problem with both sorted tails (ops/tron_multi.py)
LANES_MINOR_K1 = {"xv": 1, "xtv": 1, "scores": 1, "fun": 1,
                  "grad_and_curvature": 2, "xtv_and_sqdiag": 1,
                  "fun_grad_curvature": 2, "fun_grad_curvature_diag": 2,
                  "grad_norm_at_zero": 1, "hv": 2, "hessian_diagonal": 1}


def _near(got, want, rel):
    """(differences, bounds, bits equal) of two tuples of tensors, output
    by output: max|got - want| against rel * max|want|, and for an (L,)
    output (F, a norm) max|got - want| / |want| against rel."""
    import torch
    diffs, bounds, same = [], [], True
    for g, w in zip(got, want):
        same = same and g.shape == w.shape and g.dtype == w.dtype \
            and bool(torch.equal(g, w))
        d = (g.double() - w.double()).abs()
        if w.dim() == 1:
            diffs.append(float((d / w.double().abs()).max()))
            bounds.append(rel)
        else:
            diffs.append(float(d.max()))
            bounds.append(rel * float(w.double().abs().max()))
    return diffs, bounds, same


def lanes_strided_site(name, vals, idx, seg, S, V, gen):
    """K1 on a lanes-minor view V (L, m) (V.T of an (m, L) operand, as the
    public passes hand it on) into a random accumulator, against the
    float64 sum of the same inputs (per segment <= 1e-5 * (|out0| +
    sum|contrib|)); kernel, plain and library times, and the bound from
    min_bytes."""
    import torch
    from mlease_tpu_torch.ops.segment_sum import (
        min_bytes, segment_sum_gather, segment_sum_gather_reference)
    L, T = V.shape[0], seg.numel()
    out0 = torch.randn((L, S), generator=gen, device="cuda")
    got = segment_sum_gather(vals, V, idx, seg, S, out=out0.clone())
    ref64 = segment_sum_gather_reference(vals.double(), V.double(), idx, seg,
                                         S, out=out0.double())
    scale = segment_sum_gather_reference(
        vals.double().abs(), V.double().abs(), idx, seg, S,
        out=out0.double().abs())
    err = (got.double() - ref64).abs()
    tol = k1_tolerances()[torch.float32][0]
    ok = bool((err <= tol * scale).all())
    m_hit = int(torch.unique(idx).numel())
    S_hit = int((seg[1:] != seg[:-1]).sum()) + 1 if T else 0
    bytes_ms = min_bytes(L, T, S, V.element_size(), m_hit=m_hit,
                         S_hit=S_hit) / HBM_BYTES_PER_S
    ops_ms = 2 * L * T / PEAK_OPS["float32"]
    acc = out0.clone()
    row = {"site": name, "L": L, "V_strides": list(V.stride()), "T": T,
           "S": S, "m_hit": m_hit, "S_hit": S_hit,
           "max_abs_err": float(err.max()),
           "max_rel_err": float((err / scale.clamp_min(1e-300)).max()),
           "ok": ok,
           "kernel_ms": cuda_ms(lambda: segment_sum_gather(
               vals, V, idx, seg, S, out=acc)),
           "kernel_ms_lanes_major": cuda_ms(
               lambda Vc=V.contiguous(): segment_sum_gather(
                   vals, Vc, idx, seg, S, out=acc)),
           "plain_ms": cuda_ms(lambda: segment_sum_gather_reference(
               vals, V, idx, seg, S, out=acc)),
           "library_ms": cuda_ms(lambda: acc.index_add_(
               1, seg, vals[None, :] * V[:, idx])),
           "bound_ms": max(bytes_ms, ops_ms) * 1e3,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    print("lanes-minor k1 " + json.dumps(row), flush=True)
    return row


def lanes_minor_phase(trainer, args):
    """Phase 20: the ten public lanes-minor pass functions of
    ops/tron_multi.py at full width, on the full trainer's stacked problem
    (8 blocks, head 128 float32 as (B, Rb, H), both sorted tails) with a
    random prior mean and rho_eff and random W, S, C, Dm from --seed:
    (a) each against its lanes-major form on contiguous operands,
    transposed (bit for bit or within 1e-6 * max|out|, the difference
    printed); (b) each with K1 patched to its plain version (per output
    <= 1e-5 * max|plain|, F to 1e-5 relative); (c) K1's launches around
    each call, LANES_MINOR_K1's 15 in all; (d) the JAX identities
    fun_grad_curvature(with_diag) = (fun, grad_and_curvature,
    hessian_diagonal) and grad_norm_at_zero = ||grad_and_curvature(0)[0]||
    (bit for bit or within 1e-6 relative, printed); (e) each function's
    time beside its lanes-major form's, K1 alone on the lanes-minor V at
    the xv and xtv sites (kernel, plain, library, bound), and the phase's
    peak device memory."""
    import torch
    from mlease_tpu_torch.ops import tron_multi as tm
    from mlease_tpu_torch.ops.segment_sum import (
        segment_sum_gather_reference, segment_sum_sorted)

    t_start = time.monotonic()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 20)
    base = trainer.prob
    L = 3
    B = base.head_x.shape[0]
    N, R = base.prior_mean.shape[0], base.y.shape[0]

    def rand(*shape, scale=1.0, uniform=False):
        f = torch.rand if uniform else torch.randn
        return f(shape, generator=gen, device="cuda") * scale
    rho = torch.tensor([1.0, 10.0, 100.0], device="cuda") * (
        0.5 + rand(L, uniform=True))
    prob = tm.with_prior(base, rand(L, B, N // B, scale=0.05), rho)
    x = {"W": rand(N, L, scale=0.1), "S": rand(N, L), "C": rand(R, L),
         "Dm": rand(R, L, uniform=True) * 0.25}
    lm = tm.lanes_major(prob)
    xl = {k: v.T.contiguous() for k, v in x.items()}
    W, S, C, Dm = (x[k] for k in ("W", "S", "C", "Dm"))
    Wl, Sl, Cl, Dml = (xl[k] for k in ("W", "S", "C", "Dm"))

    def fgc_t(diag):
        out = tm._fun_grad_curvature_lm(lm, Wl, diag)
        return (out[0],) + tuple(t.T for t in out[1:])
    # name -> (the public call, its lanes-major form transposed)
    calls = {
        "xv": (lambda: tm.xv(prob, W), lambda: tm._xv_lm(lm, Wl).T),
        "xtv": (lambda: tm.xtv(prob, Dm), lambda: tm._xtv_lm(lm, Dml).T),
        "scores": (lambda: tm.scores(prob, W),
                   lambda: (tm._xv_lm(lm, Wl) + lm.offset[None, :]).T),
        "fun": (lambda: tm.fun(prob, W), lambda: fgc_t(False)[0]),
        "grad_and_curvature": (lambda: tm.grad_and_curvature(prob, W),
                               lambda: fgc_t(False)[1:]),
        "xtv_and_sqdiag": (
            lambda: tm.xtv_and_sqdiag(prob, C, Dm),
            lambda: tuple(t.T for t in tm._xtv_and_sqdiag_lm(lm, Cl, Dml))),
        "fun_grad_curvature": (lambda: tm.fun_grad_curvature(prob, W),
                               lambda: fgc_t(False)),
        "fun_grad_curvature_diag": (
            lambda: tm.fun_grad_curvature(prob, W, with_diag=True),
            lambda: fgc_t(True)),
        "grad_norm_at_zero": (lambda: tm.grad_norm_at_zero(prob, L),
                              lambda: tm._grad_norm_at_zero_lm(lm, L)),
        "hv": (lambda: tm.hv(prob, Dm, S), lambda: tm._hv_lm(lm, Dml, Sl).T),
        "hessian_diagonal": (
            lambda: tm.hessian_diagonal(prob, Dm),
            lambda: tm._hessian_diagonal_lm(lm, Dml).T),
    }

    def tup(o):
        return o if isinstance(o, tuple) else (o,)
    rows, bad, got = {}, [], {}
    segment_sum_sorted.launches = 0          # this path: count from here
    for name, (pub, _lm) in calls.items():
        before = segment_sum_sorted.launches
        got[name] = tup(pub())
        rows[name] = {"k1_launches": segment_sum_sorted.launches - before}
    launches = segment_sum_sorted.launches   # ... to here
    torch.cuda.synchronize()
    for name, (pub, lm_form) in calls.items():
        row = rows[name]
        if row["k1_launches"] != LANES_MINOR_K1[name]:
            bad.append(f"(c) {name}: {row['k1_launches']} K1 launches")
        out = got[name]
        if not all(bool(torch.isfinite(t).all()) for t in out):
            bad.append(f"{name}: not finite")
        # (a) the lanes-major form on contiguous operands
        d, b, same = _near(out, tup(lm_form()), 1e-6)
        row.update(lm_bitwise=same, lm_max_abs_diff=d, lm_bound=b,
                   dtypes=[str(t.dtype) for t in out],
                   shapes=[list(t.shape) for t in out])
        if not same and any(x > y for x, y in zip(d, b)):
            bad.append(f"(a) {name}: {d} > {b}")
        # (b) K1 patched to its plain version
        with mock.patch.object(tm, "segment_sum_gather",
                               segment_sum_gather_reference):
            plain = tup(pub())
        d, b, _same = _near(out, plain, 1e-5)
        row.update(plain_max_abs_diff=d, plain_bound=b)
        if any(x > y for x, y in zip(d, b)):
            bad.append(f"(b) {name}: {d} > {b}")
        del plain
    # (d) the JAX identities
    F, G, Dm_f, Hd = got["fun_grad_curvature_diag"]
    G0 = tm.grad_and_curvature(prob, torch.zeros_like(W))[0].T
    ident = {}
    for what, a, b in (
            ("fun", (F,), got["fun"]),
            ("grad_and_curvature", (G, Dm_f), got["grad_and_curvature"]),
            ("hessian_diagonal", (Hd,),
             (tm.hessian_diagonal(prob, Dm_f),)),
            ("grad_norm_at_zero", got["grad_norm_at_zero"],
             (torch.sqrt((G0 * G0).sum(-1)),))):
        d, bnd, same = _near(a, b, 1e-6)
        ident[what] = {"bitwise": same, "max_abs_diff": d, "bound": bnd}
        if not same and any(x > y for x, y in zip(d, bnd)):
            bad.append(f"(d) {what}: {d} > {bnd}")
    # the L site (square_from=0) and the 2L site (square_from=L) on the
    # same stream: the diagonal's tail sums alone
    Hd_l = tm.hessian_diagonal(prob, Dm)
    Hd_2l = tm.xtv_and_sqdiag(prob, C, Dm)[1]
    pvi = torch.broadcast_to(prob.prior_var_inv, Hd_l.shape)
    d, bnd, same = _near(((Hd_2l + pvi),), (Hd_l,), 1e-6)
    ident["diag_L_site_vs_2L_site"] = {"bitwise": same, "max_abs_diff": d,
                                       "bound": bnd}
    print("lanes-minor identities " + json.dumps(ident), flush=True)
    del got, F, G, Dm_f, Hd, G0, Hd_l, Hd_2l
    torch.cuda.empty_cache()
    # (e) times
    for name, (pub, lm_form) in calls.items():
        rows[name]["ms"] = cuda_ms(pub)
        rows[name]["lanes_major_ms"] = cuda_ms(lm_form)
        print(f"lanes-minor {name} " + json.dumps(rows[name]), flush=True)
    k1_rows = [
        lanes_strided_site("xv (W.T)", prob.tail_vals, prob.tail_cols,
                           prob.tail_rows, R, W.T, gen),
        lanes_strided_site("xtv (Dm.T)", prob.tail_c_vals, prob.tail_c_rows,
                           prob.tail_c_cols, N, Dm.T, gen)]
    for r in k1_rows:
        if not r["ok"]:
            bad.append(f"K1 at {r['site']}: max err {r['max_abs_err']}")
    torch.cuda.synchronize()
    out = {"rows": R, "columns": N, "blocks": B, "lanes": L,
           "head": list(prob.head_x.shape),
           "tail_entries": int(prob.tail_vals.numel()),
           "k1_launches": launches, "k1_launches_expected":
               sum(LANES_MINOR_K1.values()),
           "functions": rows, "identities": ident, "k1_sites": k1_rows,
           "phase_start_allocated_bytes": int(mem0),
           "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated()),
           "phase_s": time.monotonic() - t_start}
    print("lanes-minor " + json.dumps({k: v for k, v in out.items()
                                       if k not in ("functions",
                                                    "identities",
                                                    "k1_sites")}), flush=True)
    if launches != sum(LANES_MINOR_K1.values()):
        bad.append(f"(c) {launches} K1 launches in all")
    if out["phase_s"] > 60:
        bad.append(f"the phase took {out['phase_s']:.1f} s (> 60)")
    if bad:
        raise AssertionError(f"lanes-minor: {bad}")
    return out


# ---------------------------------------------------------------------------
# phase 21: every x-update as one program on the card (train/admm.py::
# _SolveLoop) in run() and in the streaming trainer, against the host-driven
# solves they replaced
# ---------------------------------------------------------------------------

LOOPS_ITERS = 3             # (c)-(e)'s iterations a run


@contextlib.contextmanager
def timed_prepare():
    """Every device loop's first prepare (warm-up, captures, build) made
    inside: its seconds (synchronised), and what the card holds after it
    beyond what it held before, each read after the caching allocator's
    free blocks were given back: the allocator's reserved bytes (which
    hold the graph pools) and the card's used bytes from cudaMemGetInfo
    (which also see the graphs themselves). Yields {"s", "loops",
    "pool_reserved_bytes", "card_used_bytes", "each"}, "each" the seconds
    and reserved bytes of each loop in turn."""
    import torch
    from mlease_tpu_torch.ops.device_loop import DeviceLoop
    box = {"s": 0.0, "loops": 0, "pool_reserved_bytes": 0,
           "card_used_bytes": 0, "each": []}
    prepare = DeviceLoop.prepare

    def held():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        return torch.cuda.memory_reserved(), total - free

    def timed(self):
        if not self.on_card or self._handles is not None:
            return prepare(self)
        r0, u0 = held()
        t0 = time.monotonic()
        prepare(self)
        torch.cuda.synchronize()
        s = time.monotonic() - t0
        box["s"] += s
        r1, u1 = held()
        box["loops"] += 1
        box["pool_reserved_bytes"] += r1 - r0
        box["card_used_bytes"] += u1 - u0
        box["each"].append({"s": s, "pool_reserved_bytes": r1 - r0})
    with mock.patch.object(DeviceLoop, "prepare", timed):
        yield box


def _syncs_by_iteration(run):
    """run(callback) under torch.cuda.set_sync_debug_mode("warn"): its
    result, and the synchronizing calls of each iteration (between one
    callback and the next; the first iteration's count includes the run's
    set-up), the run's total, and where those outside the steady
    iterations were made (file:line of the calling Python frame)."""
    import warnings
    import torch
    marks = []
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run(lambda **_kw: marks.append(len(seen)))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # torch's own notice that the mode is a prototype is not a sync
    sync = [i for i, w in enumerate(seen)
            if "called a synchronizing" in str(w.message)]
    bounds = [0] + marks + [len(seen)]
    per = [sum(lo <= i < hi for i in sync)
           for lo, hi in zip(bounds[:-1], bounds[1:])]

    def where(lo, hi):
        return sorted({f"{os.path.basename(seen[i].filename)}:"
                       f"{seen[i].lineno}" for i in sync if lo <= i < hi})
    return out, {"per_iteration": per[1:-1], "first": per[0],
                 "after_last": per[-1], "total": len(sync),
                 "first_iteration_and_setup_at": where(0, bounds[1]),
                 "after_last_at": where(bounds[-2], len(seen))}


def run_with(tr, iters, callback=None, run_kw=None, **seams):
    """tr.run(callback=callback, **run_kw) with the config's num_iters =
    `iters`, the trainer's methods named in `seams` replaced for the
    call."""
    kept = tr.config
    tr.config = dataclasses.replace(kept, num_iters=iters)
    for k, fn in seams.items():
        setattr(tr, k, fn)
    try:
        return tr.run(callback=callback, **(run_kw or {}))
    finally:
        for k in seams:
            delattr(tr, k)
        tr.config = kept


def host_x_update(tr):
    """An AdmmTrainer._x_update through build_x_update's solve, the
    host-driven reference (one host read a Newton and a CG trip)."""
    import torch
    solve = tr.step.solve

    def x_update(z, u, rho_eff, eps):
        x, trips = solve(tr.prob, tr.present, z, u, rho_eff, eps)
        return x, torch.as_tensor(trips, device=z.device)
    return x_update


def host_group_solve(tr):
    """A StreamingAdmmTrainer._solve_group that solves through the host
    reference, build_group_solver (one host read a Newton and a CG
    trip)."""
    import torch
    from mlease_tpu_torch.train.streaming import (_split_substacks,
                                                  build_group_solver)
    cfg = tr.config
    solver = build_group_solver(cfg.max_newton_iter, cfg.max_cg_iter,
                                mode=tr.mode, pcg=cfg.pcg,
                                relaxation=cfg.relaxation)

    def solve(gi, prob, present, z, u, rho_eff, eps, perm):
        if len(tr.ranges[gi]) > 1:
            prob = _split_substacks(prob, tr.ranges[gi])
        x, nt, cg = solver(prob, present, z, u, rho_eff, eps, perm)
        return x, torch.tensor([nt, cg], device=z.device)
    return solve


def group0_check(tr, seen):
    """A StreamingAdmmTrainer._solve_group (through the trainer's loops)
    that also solves group 0's first solve through build_group_solver on
    the same inputs, while they are in the group's slot, and puts into
    `seen` whether x is the same bits and both trip counts."""
    import torch
    host = host_group_solve(tr)
    solve_group = tr._solve_group

    def check(gi, prob, present, z, u, rho_eff, eps, perm):
        x, trips = solve_group(gi, prob, present, z, u, rho_eff, eps, perm)
        if gi == 0 and not seen:
            xh, th = host(gi, prob, present, z, u, rho_eff, eps, perm)
            seen.update(x=bool(torch.equal(x, xh)),
                        trips=[int(v) for v in trips.tolist()],
                        host_trips=[int(v) for v in th.tolist()])
        return x, trips
    return check


def _counted(fn):
    """fn() synchronised, with K1's and K2's runs (kernel_runs), its
    seconds, and the device memory at its start and its peak, after a
    garbage collection and with the caching allocator's free blocks given
    back: allocated (tensors) and reserved (the allocator's segments: the
    tensors' and the graph pools', which a graph's replays use without
    allocating). (result, {"k1", "k2", "setup", "card", "s", "base_bytes",
    "peak_bytes", "base_reserved_bytes", "peak_reserved_bytes"})."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    base_reserved = torch.cuda.memory_reserved()
    with kernel_runs() as k:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        s = time.monotonic() - t0
    return out, {"k1": k["k1"], "k2": k["k2"], "setup": k["setup"],
                 "card": k["card"], "s": s, "base_bytes": int(base),
                 "peak_bytes": int(torch.cuda.max_memory_allocated()),
                 "base_reserved_bytes": int(base_reserved),
                 "peak_reserved_bytes": int(torch.cuda.max_memory_reserved())}


def one_x_update_check(name, tr, mode, pcg, gen):
    """(a): one x-update of trainer tr's problem from random z and u
    through build_x_update (the host-driven solve) and through a
    _SolveLoop (captured, looped on the card), bit for bit with equal
    trips and K1 / K2 run as often (the loop's set-up apart); each
    solve's seconds and the loop's capture seconds."""
    import numpy as np
    import torch
    from mlease_tpu_torch.train.admm import (_SolveLoop, build_x_update,
                                             _graph_pool, substacks_of,
                                             x_prior)
    cfg = tr.config
    L, n, B, dt = len(tr.lambdas), tr.dim, tr.data.nblocks, cfg.dtype
    z = (0.01 * torch.randn((L, n), generator=gen, device="cuda")).to(dt)
    u = (0.01 * torch.randn((L, B, n), generator=gen, device="cuda")).to(dt)
    rho = torch.as_tensor(tr.rhos, dtype=dt, device="cuda")
    eps = cfg.liblinear_epsilon * tr.eps_scale
    solve = build_x_update(mode, cfg.max_newton_iter, cfg.max_cg_iter, pcg,
                           cfg.relaxation)
    (xh, th), ch = _counted(lambda: solve(tr.prob, tr.present, z, u, rho,
                                          eps))
    t0 = time.monotonic()
    with kernel_runs() as made:
        lp = _SolveLoop(mode, substacks_of(tr.prob, B), L, n, pcg,
                        cfg.max_newton_iter, cfg.max_cg_iter, z, u, rho, eps)
        lp.own_loop(_graph_pool(tr.device)).prepare()
        torch.cuda.synchronize()
        capture_s = time.monotonic() - t0
    try:
        _, cl = _counted(lambda: lp.solve(z, u, rho, eps))
        xl = solve.finish(lp.x(), tr.present, x_prior(z, u), z)
        tl = lp.trips().cpu().numpy()
    finally:
        lp.loop.close()
    row = {"mode": mode, "pcg": pcg,
           "parts": len(substacks_of(tr.prob, B)),
           "x_bit_for_bit": bool(torch.equal(xh, xl)),
           "x_max_abs_diff": float((xh.double() - xl.double()).abs().max()),
           "trips_equal": bool(np.array_equal(th, tl)),
           "trips_max": [int(v) for v in tl.max(0)],
           "host_s": ch["s"], "loop_s": cl["s"], "capture_s": capture_s,
           "k1_host": ch["k1"], "k1_loop": cl["k1"],
           "k2_host": ch["k2"], "k2_loop": cl["k2"],
           "loop_runs_on_card": cl["card"], "loop_setup_runs": made["setup"]}
    print(f"loops (a) {name} " + json.dumps(row), flush=True)
    bad = []
    if not (row["x_bit_for_bit"] and row["trips_equal"]):
        bad.append(f"(a) {name}: x or trips differ ({row})")
    if (cl["k1"], cl["k2"]) != (ch["k1"], ch["k2"]) or ch["k1"] == 0 \
            or cl["card"]["k1"] == 0:
        bad.append(f"(a) {name}: K1/K2 {cl} against the host's {ch}")
    return row, bad


def _loop_run(tr, **seams):
    """(c)-(e) of run() through the device loops on a trainer whose loops
    are made anew (captured in its first iteration), LOOPS_ITERS
    iterations: the synchronizing calls of each iteration, K1 / K2 runs
    (the loops' set-up apart), s an iteration, the captures' seconds and
    bytes, the peak memory, and each iteration's time inside the loops'
    graphs (CUDA events around each launch: no host read), whose share of
    the iteration's wall time bounds the card's idle share from above.
    `seams`: the trainer's methods replaced for the run (run_with).
    Returns (result, row)."""
    import gc
    import torch
    from mlease_tpu_torch.ops.device_loop import DeviceLoop
    fresh_loops(tr)
    spans, marks = [], []
    launch = DeviceLoop.run

    def timed(self):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        launch(self)
        ev[1].record()
        spans.append(ev)

    def run(cb):
        def mark(**kw):
            marks.append(len(spans))
            cb(**kw)
        return run_with(tr, LOOPS_ITERS, mark, **seams)
    with timed_prepare() as cap, mock.patch.object(DeviceLoop, "run", timed):
        (res, syncs), cl = _counted(lambda: _syncs_by_iteration(run))
    graph_ms = [sum(a.elapsed_time(b) for a, b in spans[lo:hi])
                for lo, hi in zip([0] + marks, marks)]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return res, {
        "solver_stats": res.solver_stats, "loop_iter_s": res.iter_times,
        "loop_steady_iter_s": steady_s(res.iter_times),
        "loop_graph_ms": graph_ms,
        "idle_share_loop_at_most": [
            1.0 - g / 1e3 / s for g, s in zip(graph_ms[1:],
                                               res.iter_times[1:])],
        "k1_loop": cl["k1"] - cl["setup"]["k1"],
        "k2_loop": cl["k2"] - cl["setup"]["k2"],
        "loop_setup_runs": cl["setup"], "loop_runs_on_card": cl["card"],
        "capture_s": cap["s"], "loops_captured": cap["loops"],
        "pool_reserved_bytes": cap["pool_reserved_bytes"],
        "card_used_bytes_by_captures": cap["card_used_bytes"],
        "peak_bytes_loop": cl["peak_bytes"],
        "peak_reserved_bytes_loop": cl["peak_reserved_bytes"],
        "solver_state_bytes": _state_bytes(tr._loops.values()),
        # what the loops keep after the run (their state and pool, and a
        # streaming trainer's slots), in reserved bytes
        "kept_reserved_bytes": int(torch.cuda.memory_reserved()
                                   - cl["base_reserved_bytes"]),
        "syncs": syncs}


def _loop_failures(name, row):
    bad = []
    if not row["loop_runs_on_card"]["k1"] > 0:
        bad.append(f"(d) {name}: no K1 run counted on the card")
    if any(k != 1 for k in row["syncs"]["per_iteration"]):
        bad.append(f"(c) {name}: syncs per iteration "
                   f"{row['syncs']['per_iteration']}")
    return bad


def _run_against_host(name, tr, host_seams, span, profile=True):
    """(c)-(e) on one trainer: first the host path (run() with
    `host_seams`, no device loop made), LOOPS_ITERS iterations, with K1 /
    K2 counted and its peak memory, and (profile) the device idle share of
    its `span` over 2 iterations; then the device loops (_loop_run): z and
    u bit for bit with equal trips, K1 / K2 run as
    often (the loops' set-up apart). Returns (row, failures, the loops'
    run's result)."""
    import numpy as np
    fresh_loops(tr)
    t = [time.monotonic()]
    hres, ch = _counted(lambda: run_with(tr, LOOPS_ITERS, **host_seams))
    prof = (span_profile(lambda: run_with(tr, 2, **host_seams), span)
            if profile else None)
    t.append(time.monotonic())
    res, row = _loop_run(tr)
    t.append(time.monotonic())
    row.update({
        "bit_for_bit_with_host_path": bool(
            np.array_equal(res.z, hres.z) and np.array_equal(res.u, hres.u)),
        "trips_equal": res.solver_stats == hres.solver_stats,
        "host_iter_s": hres.iter_times,
        "host_steady_iter_s": steady_s(hres.iter_times),
        "k1_host": ch["k1"], "k2_host": ch["k2"],
        "base_bytes": ch["base_bytes"], "peak_bytes_host": ch["peak_bytes"],
        "base_reserved_bytes": ch["base_reserved_bytes"],
        "peak_reserved_bytes_host": ch["peak_reserved_bytes"],
        "idle_share_host": prof and prof["device_idle_share_steady"],
        "host_and_profile_s_loop_s": [b - a for a, b in zip(t, t[1:])]})
    bad = _loop_failures(name, row)
    if not (row["bit_for_bit_with_host_path"] and row["trips_equal"]):
        bad.append(f"{name}: the run differs from the host path")
    if (row["k1_loop"], row["k2_loop"]) != (ch["k1"], ch["k2"]) \
            or ch["k1"] == 0:
        bad.append(f"(d) {name}: K1/K2 {row['k1_loop'], row['k2_loop']} "
                   f"against the host's {ch['k1'], ch['k2']}")
    return row, bad, res


def loops_phase(trainers, args):
    """Phase 21 (a), (c)-(e) in memory: see the module docstring."""
    import torch
    import mlease_tpu_torch.ops.tron_multi as tm
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer

    t_phase = time.monotonic()
    out, bad = {}, []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 21)
    bench, full = trainers["bench"], trainers["full"]
    bdata = synth_blocked_data(50_000, 4, 16_384, 15, args.seed)
    bvocab = make_vocab(50_000)
    bcfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=LOOPS_ITERS,
                      pcg=True, flat_blocks=True, dtype=torch.float32)
    # (a) one x-update, host against loop
    for tag, tr in (("bench", bench), ("full", full)):
        for mode, pcg in (("flat", True), ("per_block", True),
                          ("per_block", "head_block")):
            name = f"{tag} {mode} {pcg}"
            out[f"a {name}"], b = one_x_update_check(name, tr, mode, pcg, gen)
            bad += b
    lanes = None
    for name, kw in (("bench dual_layout", dict(dual_layout=True)),
                     ("bench lanes", dict(multi_rhs=False))):
        lanes = AdmmTrainer(bdata, bvocab, dataclasses.replace(bcfg, **kw))
        out[f"a {name}"], b = one_x_update_check(name, lanes, "lanes", True,
                                                 gen)
        bad += b
    # sub-stacks of the head trainers' data (head-less sub-stacks, whose
    # X'v K1 sums over the ELL's column copy, are phase 23's)
    for tag, tr, per in (("bench", bench, 1), ("full", full, 2)):
        t0 = time.monotonic()
        n, R = tr.data.dim, tr.data.padded_rows
        with mock.patch.object(tm, "STACK_ID_BOUND", per * max(n, R) + 1):
            sub = AdmmTrainer(tr.data, tr.vocab, dataclasses.replace(
                tr.config, flat_blocks=False))
        out[f"a {tag} 4 substacks build_s"] = time.monotonic() - t0
        if not (isinstance(sub.prob, tm.SubStacks)
                and len(sub.prob.ranges) == 4):
            bad.append(f"(a) {tag}: not 4 sub-stacks")
        name = f"{tag} 4 substacks"
        out[f"a {name}"], b = one_x_update_check(name, sub, "per_block",
                                                 True, gen)
        bad += b
        del sub
        torch.cuda.empty_cache()
    out["a_s"] = time.monotonic() - t_phase

    # (c)-(e) run() against the host-driven path: bench flat and lanes,
    # full flat
    for name, tr in (("bench flat", bench), ("bench lanes", lanes),
                     ("full flat", full)):
        row, b, _ = _run_against_host(
            name, tr, dict(_x_update=host_x_update(tr)), "admm_iteration",
            profile=name != "bench lanes")
        row["mode"] = tr.mode
        out[f"run {name}"] = row
        print(f"loops run {name} " + json.dumps(row), flush=True)
        bad += b
    del lanes
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"loops: {bad}")
    return out


# phase 21 (b)-(e) streamed: its cells, made on phase 11's and phase 18's
# trainers of the same settings (loops_stream_hook), or under --loops-only
# on trainers of its own
STREAM_CELLS = {("float32", "a_job_budget"): "a",
                ("float32", "b_one_head"): "b",
                ("float32", "c_streamed_compact"): "c",
                ("bfloat16", "a_job_budget"): "a bf16"}
LOOPS_STREAM: dict = {}     # "on": phase 21 runs; cell -> (row, bad, z, u)


def loops_stream_hook(dtype, setting, tr):
    """Phase 21's streamed cell of this phase 11 or 18 trainer, if it has
    one and phase 21 runs."""
    cell = STREAM_CELLS.get((dtype, setting))
    if cell is not None and LOOPS_STREAM.get("on"):
        LOOPS_STREAM[cell] = loops_stream_cell(cell, tr)


def loops_stream_cell(cell, tr):
    """Phase 21 (b)-(e) on one streaming trainer: a run through the loops
    (_loop_run), at "a" and "a bf16" against the host path (the group
    solves through build_group_solver, _run_against_host; the host's
    stream_iteration idle share at "a"); group 0's first solve of a run
    through the loops against build_group_solver on the same inputs while
    they are in the group's slot (bit for bit, equal trips): at "b" and
    "c" in that run, at "a" and "a bf16" in one more iteration (the
    reference's launches kept out of (d)'s counts). Returns (row,
    failures, z, u)."""
    t0 = time.monotonic()
    seen = {}
    if cell in ("a", "a bf16"):
        row, bad, res = _run_against_host(
            cell, tr, dict(_solve_group=host_group_solve(tr)),
            "stream_iteration", profile=cell == "a")
        run_with(tr, 1, _solve_group=group0_check(tr, seen))
    else:
        res, row = _loop_run(tr, _solve_group=group0_check(tr, seen))
        bad = _loop_failures(cell, row)
    row.update({"residency": tr.residency_report(),
                "group0_x_bit_for_bit": seen.get("x"),
                "group0_trips": seen.get("trips"),
                "group0_host_trips": seen.get("host_trips"),
                "slots_bytes": sum(sl.nbytes() for sl in tr._slots),
                "budget_reserve_bytes": tr._reserve_bytes(),
                "cell_s": time.monotonic() - t0})
    if not (seen.get("x") and seen["trips"] == seen["host_trips"]):
        bad.append(f"(b) {cell}: group 0's solve differs: {seen}")
    print(f"loops stream {cell} " + json.dumps(row), flush=True)
    return row, bad, res.z, res.u


def _state_bytes(loops):
    """Device bytes of these _SolveLoops' state (a tensor that loops share
    counted once)."""
    seen, n = set(), 0
    for lp in loops:
        for t in lp.state():
            if t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                n += t.numel() * t.element_size()
    return n


def loops_stream_phase(args):
    """Phase 21 (b)-(e) streamed: see the module docstring. Its cells are
    made on phases 11's and 18's trainers (loops_stream_hook); under
    --loops-only it makes their trainers itself, on the data phase 11
    makes."""
    import numpy as np
    import torch
    from mlease_tpu_torch.core.dataset import split_blocks, to_hybrid
    from mlease_tpu_torch.train.admm import AdmmConfig
    from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer

    if args.loops_only:
        groups = split_blocks(synth_blocked_data(
            1_000_000, 8, args.rows_per_block, 12, args.seed), STREAM_GROUPS)
        for i, g in enumerate(groups):
            groups[i] = to_hybrid(g, 128, column_sorted=True,
                                  head_dtype=torch.bfloat16)
        vocab = make_vocab(1_000_000)
        cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=LOOPS_ITERS,
                         head_size=128, head_dtype=torch.bfloat16, pcg=True,
                         flat_blocks=True, dtype=torch.float32)
        head0 = int(groups[0].head.nbytes + groups[0].head_ids.nbytes)
        settings = {  # phase 11's and 18's
            "a_job_budget": dict(resident_head_budget_gb=8.0),
            "b_one_head": dict(resident_head_budget_gb=1.2 * head0 / 2**30),
            "c_streamed_compact": dict(resident_head=False,
                                       compact_wire=True)}
        for (dtype, setting), cell in STREAM_CELLS.items():
            tr = StreamingAdmmTrainer(
                groups, vocab, dataclasses.replace(
                    cfg, dtype=getattr(torch, dtype)), **settings[setting])
            LOOPS_STREAM[cell] = loops_stream_cell(cell, tr)
            del tr
            torch.cuda.empty_cache()
    missing = [c for c in STREAM_CELLS.values() if c not in LOOPS_STREAM]
    if missing:
        raise AssertionError(f"loops stream: cells not run: {missing}")
    out, bad = {}, []
    for cell in STREAM_CELLS.values():
        out[cell], b, _, _ = LOOPS_STREAM[cell]
        bad += b
    a = LOOPS_STREAM["a"]
    same = {k: bool(np.array_equal(LOOPS_STREAM[k][2], a[2])
                    and np.array_equal(LOOPS_STREAM[k][3], a[3]))
            for k in ("b", "c")}
    out["tiers_bit_for_bit"] = same
    print("loops stream tiers " + json.dumps(same), flush=True)
    if not all(same.values()):
        bad.append(f"(b) the tiers' runs differ: {same}")
    if bad:
        raise AssertionError(f"loops stream: {bad}")
    return out


# ---------------------------------------------------------------------------
# phase 22: the per-key trainers' solves as device loops (train/item.py::
# _solve_bucket, train/naive.py::_solve_keys) against the host-driven solves
# they replaced, through those seams
# ---------------------------------------------------------------------------

# where a device loop's capture synchronizes (its set-up, not a read)
CAPTURE_SITES = ("device_loop.py", "graphs.py")


def _sync_sites(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): its result and
    the file:line of each synchronizing call it made."""
    import warnings
    import torch
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return out, [f"{os.path.basename(w.filename)}:{w.lineno}" for w in seen
                 if "called a synchronizing" in str(w.message)]


def _reads(sites):
    """The synchronizing calls outside a loop's capture, by site."""
    out = {}
    for site in sites:
        if not site.startswith(CAPTURE_SITES):
            out[site] = out.get(site, 0) + 1
    return out


def host_solves():
    """tests/torch_host_solves.py (the host-driven seams the CPU and card
    tests hold the loops to: host_bucket, host_keys), loaded by its path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_host_solves", os.path.join(REPO, "tests",
                                          "torch_host_solves.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def k1_checked(*modules):
    """Every K1 call `modules` make inside (through their
    segment_sum_gather; eager calls only) held, on the same inputs, to the float64 sum of its
    plain version: |got - ref64| <= tol * (|out0| + sum|contrib|) + rel *
    |ref64|, K1's bound for the result's type (k1_tolerances). Yields
    {"calls", "max_rel_err", "ok"}, filled at the exit (one read)."""
    import torch
    from mlease_tpu_torch.ops.segment_sum import (
        segment_sum_gather, segment_sum_gather_reference as ref)
    excess, rel, box = [], [], {}

    def checked(vals, V, idx, seg, S, *, out=None, square_from=None):
        out0 = None if out is None else out.clone()
        got = segment_sum_gather(vals, V, idx, seg, S, out=out,
                                 square_from=square_from)

        def f64(o, v, VV):
            return ref(v.double(), None if VV is None else VV.double(), idx,
                       seg, S, out=None if o is None else o.double(),
                       square_from=square_from)
        ref64 = f64(out0, vals, V)
        scale = f64(None if out0 is None else out0.abs(), vals.abs(),
                    None if V is None else V.abs())
        tol, r = k1_tolerances()[got.dtype]
        err = (got.double() - ref64).abs_()
        excess.append((err - tol * scale - r * ref64.abs()).max())
        rel.append((err / scale.clamp_min(1e-300)).max())
        return got
    with contextlib.ExitStack() as stack:
        for module in modules:
            stack.enter_context(mock.patch.object(
                module, "segment_sum_gather", checked))
        yield box
    box.update(calls=len(rel),
               max_rel_err=float(torch.stack(rel).max()) if rel else 0.0,
               ok=bool(rel) and float(torch.stack(excess).max()) <= 0.0)


@contextlib.contextmanager
def k1_plain(*modules):
    """`modules`' K1 calls on K1's plain version inside; the box says
    whether the kernel was launched all the same."""
    from mlease_tpu_torch.ops.segment_sum import (
        segment_sum_gather_reference, segment_sum_sorted)
    box, before = {}, segment_sum_sorted.launches
    with contextlib.ExitStack() as stack:
        for module in modules:
            stack.enter_context(mock.patch.object(
                module, "segment_sum_gather", segment_sum_gather_reference))
        yield box
    box["kernel_launched"] = segment_sum_sorted.launches != before


# phases 8 and 18 (e)'s item runs on their loops, phase 22 (a)/(b)'s first
# (and phase 8's second) loop runs, by cell name
ITEM_LOOP_RUNS: dict = {}


def item_loop_run(train):
    """train() (an item call) on its loops, as phase 22 reads a first run:
    {"res", "counts" (_counted: K1 / K2 runs, seconds, memory), "sites"
    (the synchronizing calls, _sync_sites)}."""
    (res, sites), counts = _counted(lambda: _sync_sites(train))
    return {"res": res, "counts": counts, "sites": sites}


def item_second_run(train):
    """train() again on new loops, its captures timed (timed_prepare:
    seconds, pool bytes), and the bytes the card keeps reserved after
    it: {"res", "s", "capture", "kept_reserved_bytes"}."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    with timed_prepare() as cap:
        t0 = time.monotonic()
        res = train()
        torch.cuda.synchronize()
        s = time.monotonic() - t0
    torch.cuda.empty_cache()
    return {"res": res, "s": s, "capture": cap,
            "kept_reserved_bytes": int(torch.cuda.memory_reserved()
                                       - reserved0)}


def _item_same(a, b):
    """Whether two ItemResults hold the same models, variances and
    covariances (every float compared, dictionaries as they are: no
    sorting of the 20,000 covariance dictionaries)."""
    def plain(models):
        return {k: (m.intercept, m.coefficients) for k, m in models.items()}
    return (plain(a.models) == plain(b.models)
            and plain(a.posterior_var) == plain(b.posterior_var)
            and a.covariances == b.covariances)


def _untimed_stats(stats):
    return [{k: v for k, v in s.items() if not k.endswith("_s")}
            for s in stats]


# phase 22's bounds on an item run with K1 on its plain version against
# the run with K1, by cell: (w as a share of max|w|, variances relative).
# The Cholesky route converges quadratically, as phase 8 holds K2; a
# float32 TRON stop leaves each run about 1e-3 of max|w| from the optimum
# (phase 8's 5e-3 between the routes); bfloat16 phase 18's 1e-2 of max|w|,
# and a few bfloat16 roundings (2^-8 each) on a variance
K1_PLAIN_BOUNDS = {"a tron": (5e-3, 1e-2), "b bf16 cholesky": (1e-2, 5e-2),
                   "b bf16 tron": (1e-2, 5e-2)}


def item_loop_cell(name, decoded, cfg, gen, second=True, k1_sums=False):
    """Phase 22 (a)/(b) on one item run: train_item_models_columnar on its
    loops (phase 8's or 18 (e)'s run where it made one, else here: K1 / K2
    runs, the synchronizing calls by site), again (bits; the captures'
    seconds and pool bytes, the bytes kept after the run), and with
    _solve_bucket on the host-driven solvers (K1 / K2 runs, its
    synchronizing calls): w, variances, covariances and trips bit for
    bit, K1 / K2 run as often (the loops' set-up apart), one host read a
    bucket, s per bucket of each. Then the first bucket's host-driven solve
    and Hessian diagonal with every K1 call held to its float64 plain
    version (k1_checked); where K1_PLAIN_BOUNDS names the cell, the run
    with K1 on its plain version; with k1_sums, the first bucket's sorted
    sums, plain and squared, against the float64 scatter
    (lanes_sorted_sum_check)."""
    import torch
    from mlease_tpu_torch.ops import objective
    from mlease_tpu_torch.train import item

    def train():
        return item.train_item_models_columnar(decoded, cfg, device="cuda")
    t0 = time.monotonic()
    first = ITEM_LOOP_RUNS.pop(name, None) or item_loop_run(train)
    res, sites, cl = first["res"], first["sites"], first["counts"]
    again = first.get("second") or (item_second_run(train) if second
                                    else None)
    seams = host_solves()
    buckets_seen = []

    def host_bucket(prob, w0, eps_t, c, pool=None):
        if not buckets_seen:
            buckets_seen.append((prob, w0, eps_t))
        return seams.host_bucket(prob, w0, eps_t, c)
    with mock.patch.object(item, "_solve_bucket", host_bucket):
        (resh, host_sites), ch = _counted(lambda: _sync_sites(train))
    reads = _reads(sites)
    buckets = len(res.solver_stats)
    row = {
        "models": len(res.models), "buckets": buckets,
        "shapes": [s["shape"] for s in res.solver_stats],
        "bit_for_bit_with_host_path": _item_same(res, resh),
        "trips_equal": (_untimed_stats(res.solver_stats)
                        == _untimed_stats(resh.solver_stats)),
        "trips": [{k: s.get(k) for k in ("newton_trips", "cg_trips")}
                  for s in res.solver_stats],
        "loop_reads": reads, "loop_reads_total": sum(reads.values()),
        "loop_capture_syncs": len(sites) - sum(reads.values()),
        "host_syncs": len(host_sites),
        "k1_loop": cl["k1"] - cl["setup"]["k1"], "k1_host": ch["k1"],
        "k2_loop": cl["k2"] - cl["setup"]["k2"], "k2_host": ch["k2"],
        "loop_setup_runs": cl["setup"], "loop_runs_on_card": cl["card"],
        "loop_s": cl["s"], "host_s": ch["s"],
        "loop_solve_s": [s["solve_s"] for s in res.solver_stats],
        "host_solve_s": [s["solve_s"] for s in resh.solver_stats],
        "capture_s": [s["capture_s"] for s in res.solver_stats],
        "peak_reserved_bytes_loop": cl["peak_reserved_bytes"],
        "peak_reserved_bytes_host": ch["peak_reserved_bytes"],
        "base_reserved_bytes": cl["base_reserved_bytes"]}
    if again is not None:
        cap = again["capture"]
        row.update(
            second_run_bit_for_bit=_item_same(res, again["res"]),
            second_trips_equal=(_untimed_stats(res.solver_stats) ==
                                _untimed_stats(again["res"].solver_stats)),
            second_loop_s=again["s"],
            capture_s_timed=cap["s"], loops_captured=cap["loops"],
            pool_reserved_bytes=cap["pool_reserved_bytes"],
            card_used_bytes_by_captures=cap["card_used_bytes"],
            kept_reserved_bytes=again["kept_reserved_bytes"])
    del first, again, resh
    # every K1 call of the first bucket's host-driven solve and of its
    # Hessian diagonal against its float64 plain version
    prob, w0, eps_t = buckets_seen[0]
    with k1_checked(objective) as kc:
        w = seams.host_bucket(prob, w0, eps_t, cfg).w
        objective.hessian_diagonal(prob, w)
    row["k1_calls_checked"] = kc
    if name in K1_PLAIN_BOUNDS:
        with k1_plain(objective) as kp:
            plain = train()
        w_tol, v_tol = K1_PLAIN_BOUNDS[name]
        diff, scale = max_model_diff(res.models, plain.models)
        row.update(k1_plain_launched=kp["kernel_launched"],
                   w_k1_vs_plain_max_abs=diff, w_max_abs=scale,
                   var_k1_vs_plain_max_rel=max_var_rel(
                       res.posterior_var, plain.posterior_var),
                   k1_plain_bounds=[w_tol, v_tol])
        del plain
    if k1_sums:
        G = w0.shape[0] // prob.y.shape[0]
        row["k1_sorted_sums"] = lanes_sorted_sum_check(
            f"item {name}", prob, prob.dim, gen, L=G, squares=(False, True),
            tag="per-key loops")
    row["cell_s"] = time.monotonic() - t0
    print(f"per-key loops {name} " + json.dumps(row), flush=True)
    checks = [
        ("the loop's bits are the host path's",
         row["bit_for_bit_with_host_path"] and row["trips_equal"]),
        ("K1 / K2 run as often as on the host path",
         (row["k1_loop"], row["k2_loop"]) == (ch["k1"], ch["k2"])
         and ch["k1"] > 0 and cl["card"]["k1"] > 0
         and (cfg.solver != "cholesky" or cl["card"]["k2"] > 0)),
        ("one host read a bucket", row["loop_reads_total"] == buckets),
        ("K1's calls on the host path equal its plain version's",
         kc["ok"] and kc["calls"] > 0)]
    if "second_run_bit_for_bit" in row:
        checks.append(("a second loop run gives the same bits",
                       row["second_run_bit_for_bit"]
                       and row["second_trips_equal"]))
    if "k1_plain_bounds" in row:
        checks.append(("the run with K1's plain version is within bounds",
                       not row["k1_plain_launched"]
                       and row["w_k1_vs_plain_max_abs"] <= w_tol * scale
                       and row["var_k1_vs_plain_max_rel"] <= v_tol))
    if k1_sums:
        checks.append(("K1's sorted sums on the item problem",
                       bool(row["k1_sorted_sums"])
                       and all(r["ok"] for r in row["k1_sorted_sums"])))
    return row, [f"{name}: {w}" for w, ok in checks if not ok]


def _runs_and_s(fn):
    """fn() synchronised, with K1's and K2's runs (kernel_runs) and its
    seconds: _counted without its garbage collection and memory reads (a
    call inside a trainer's call)."""
    import torch
    torch.cuda.synchronize()
    with kernel_runs() as k:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        s = time.monotonic() - t0
    return out, dict(k, s=s)


# phase 22 (c)'s bound on the naive solve with K1 on its plain version
# against the solve with K1: twice the job's liblinear.epsilon (0.01) of
# max|x|, the distance two runs that each stop at ||g|| <= eps * ||g0||
# may keep between them. It holds the stacked solves (tron_multi's K1
# calls) only: on the lanes solve the plain version's float32 atomics took
# 13 Newton and 133 CG trips against K1's 12 and 109 and ended 6% of
# max|x| away on an H100, every K1 call there within 3e-7 of its float64
# sum: that distance is the stop test's reach, and is reported
NAIVE_K1_PLAIN_BOUND = 2e-2


def naive_loop_cell(name, keyed, vocab, cfg, ranges):
    """Phase 22 (c) on one naive mode: one train_naive call whose
    _solve_keys first solves through the host-driven solvers (K1 runs,
    seconds, its synchronizing calls), then on its loop on the same inputs
    (K1 runs, seconds, the synchronizing calls inside it), the loop's
    result going on; then, on the same inputs, the host-driven solve with
    every K1 call held to its float64 plain version (k1_checked) and the
    loop with K1 on its plain version (NAIVE_K1_PLAIN_BOUND on the stacked
    solves, the lanes' distance and trips reported): x bit for
    bit, equal trips, K1 run as often (set-up apart), the block ranges of
    the solve's parts, no host read inside the loop's solve (the call's
    synchronizing calls outside the solves, this cell's comparisons among
    them, reported by site)."""
    import torch
    import mlease_tpu_torch.ops.tron_multi as tm
    from mlease_tpu_torch.ops import objective
    from mlease_tpu_torch.train import naive

    seen = {}
    solve_keys, host = naive._solve_keys, host_solves().host_keys

    def both(mode, probs, *a):
        seen.update(mode=mode, ranges=[list(r) for _p, r in probs])
        (hs, host_sites), ch = _runs_and_s(
            lambda: _sync_sites(lambda: host(mode, probs, *a)))
        (ls, sites), cl = _runs_and_s(
            lambda: _sync_sites(lambda: solve_keys(mode, probs, *a)))
        # the stacked solves' K1 calls are tron_multi's, the lanes' the
        # objective's
        with k1_checked(tm, objective) as kc:
            host(mode, probs, *a)
        with k1_plain(tm, objective) as kp:
            plain = solve_keys(mode, probs, *a)
        scale = float(ls.w.abs().max())
        seen.update(
            bits=bool(torch.equal(ls.w, hs.w)),
            trips=ls.trips.tolist(), host_trips=hs.trips.tolist(),
            solve_reads=_reads(sites), host_syncs=len(host_sites),
            k1_loop=cl["k1"] - cl["setup"]["k1"], k1_host=ch["k1"],
            loop_setup_runs=cl["setup"], loop_runs_on_card=cl["card"],
            loop_s=cl["s"], host_s=ch["s"], capture_s=ls.capture_s,
            k1_calls_checked=kc, k1_plain_launched=kp["kernel_launched"],
            x_k1_vs_plain_max_abs=float((ls.w - plain.w).abs().max()),
            plain_trips=plain.trips.tolist(), x_max_abs=scale,
            # the lanes' distance: the float32 lanes TRON at
            # liblinear.epsilon 0.01 moves with the order of its sums, as
            # the JAX package's does (tests/test_torch_f32_order.py)
            x_k1_vs_plain_is=("known trait 10 (ROADMAP.md C)"
                              if mode == "lanes"
                              else "held to NAIVE_K1_PLAIN_BOUND"))
        plain.loop.close()
        return ls

    t0 = time.monotonic()
    with mock.patch.object(naive, "_solve_keys", both):
        res, sites = _sync_sites(
            lambda: naive.train_naive(keyed, cfg, vocab=vocab))
    row = dict(seen, models=len(res.models),
               call_syncs_outside_the_solves=_reads(sites),
               pack_s=res.solver_stats["pack_s"],
               cell_s=time.monotonic() - t0)
    print(f"per-key loops naive {name} " + json.dumps(row), flush=True)
    bad = [f"naive {name}: {w}" for w, ok in (
        ("the loop's bits and trips are the host path's",
         row["bits"] and row["trips"] == row["host_trips"]),
        ("the solve's parts", row["ranges"] == ranges),
        ("K1 runs as often as on the host path",
         row["k1_loop"] == row["k1_host"] > 0
         and row["loop_runs_on_card"]["k1"] > 0),
        ("K1's calls on the host path equal its plain version's",
         row["k1_calls_checked"]["ok"]
         and row["k1_calls_checked"]["calls"] > 0),
        ("the loop with K1's plain version is within bounds",
         not row["k1_plain_launched"] and (
             row["mode"] == "lanes" or row["x_k1_vs_plain_max_abs"]
             <= NAIVE_K1_PLAIN_BOUND * row["x_max_abs"])),
        ("no host read inside the loop's solve",
         not row["solve_reads"])) if not ok]
    return row, bad


def synth_item_buckets(parts, seed):
    """Items of several (R, K, F) buckets in one columnar decode: for each
    (items, rows_per_item, features) of `parts` synth_item_decoded's items
    (a seed and a key prefix each), over the widest part's vocabulary."""
    import numpy as np
    from mlease_tpu_torch.io.fast_decode import DecodedRows
    decs = [synth_item_decoded(n, r, f, seed + i)
            for i, (n, r, f) in enumerate(parts)]
    starts, base = [], 0
    for d in decs:
        starts.append(d.row_start[:-1] + base)
        base += int(d.row_start[-1])
    return DecodedRows(
        response=np.concatenate([d.response for d in decs]),
        weight=np.concatenate([d.weight for d in decs]),
        offset=np.concatenate([d.offset for d in decs]),
        row_start=np.concatenate(starts + [np.array([base], np.int64)]),
        feat_id=np.concatenate([d.feat_id for d in decs]),
        feat_val=np.concatenate([d.feat_val for d in decs]),
        vocab_names=max((d.vocab_names for d in decs), key=len),
        keys=[f"p{i}-{k}" for i, d in enumerate(decs) for k in d.keys])


# phase 22 (a)'s multi-bucket items: (items, rows per item, features), the
# three (R, K, F) buckets (16, 8, 8), (64, 8, 16), (256, 8, 32)
ITEM_BUCKET_PARTS = ((4_000, 12, 6), (4_000, 48, 12), (2_000, 160, 24))


def per_key_loops_phase(args):
    """Phase 22: see the module docstring."""
    import torch
    import mlease_tpu_torch.ops.tron_multi as tm
    from mlease_tpu_torch.train import item

    t_phase = time.monotonic()
    out, bad = {}, []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 22)
    # (a) phase 8's items, float32: the Cholesky route on the 10,000, full
    # covariance; the TRON route on its 1,000 at its tolerance; then three
    # buckets of 10,000 items on each route, diagonal variances, timed
    decoded = synth_item_decoded(10_000, 48, 12, args.seed)
    small = synth_item_decoded(1_000, 48, 12, args.seed + 1)
    multi = synth_item_buckets(ITEM_BUCKET_PARTS, args.seed + 3)
    cfg = item.ItemConfig(intercept_lambdas=[1.0], default_lambdas=[1.0, 10.0],
                          compute_var=True, full_cov=True, solver="cholesky",
                          dtype=torch.float32)
    tight = dataclasses.replace(cfg, full_cov=False, liblinear_epsilon=1e-6,
                                solver="tron")
    diag = dataclasses.replace(cfg, full_cov=False)
    bf16 = dataclasses.replace(diag, dtype=torch.bfloat16)
    for name, dec, c, kw in (
            ("a cholesky", decoded, cfg, dict(k1_sums=True)),
            ("a tron", small, tight, {}),
            ("a multi-bucket cholesky", multi, diag, dict(second=False)),
            ("a multi-bucket tron", multi,
             dataclasses.replace(diag, solver="tron"), dict(second=False)),
            ("b bf16 cholesky", decoded, bf16, dict(k1_sums=True)),
            ("b bf16 tron", small, dataclasses.replace(
                tight, dtype=torch.bfloat16), {})):
        out[name], b = item_loop_cell(name, dec, c, gen, **kw)
        bad += b
    del decoded, small, multi
    torch.cuda.empty_cache()
    # (c) phase 13's rows and config: the three modes
    if not NAIVE_BASE:
        NAIVE_BASE.update(naive_rows(args))
    keyed, vocab, ncfg = (NAIVE_BASE[k] for k in ("keyed", "vocab", "cfg"))
    K, n = len(keyed), vocab.size
    rows = max(len(v) for v in keyed.values())
    for name, kw, ranges, bound in (
            ("flat", {}, [[0, K]], None),
            ("per_key 4 substacks", dict(flat_blocks=False),
             [[b, b + 2] for b in range(0, K, 2)],
             2 * max(n, rows) + 1),
            ("lanes", dict(multi_rhs=False), [[0, K]], None)):
        ctx = (mock.patch.object(tm, "STACK_ID_BOUND", bound) if bound
               else contextlib.nullcontext())
        with ctx:
            out[f"c {name}"], b = naive_loop_cell(
                name, keyed, vocab, dataclasses.replace(ncfg, **kw), ranges)
        bad += b
    out["s"] = time.monotonic() - t_phase
    print(f"per-key loops phase {out['s']:.1f} s", flush=True)
    if bad:
        raise AssertionError(f"per-key loops: {bad}")
    return out


# ---------------------------------------------------------------------------
# phase 23: X'v over the ELL on K1 (the column-sorted copy of a head-less
# problem) and the feature-sharded trainer's x-update as one device loop
# ---------------------------------------------------------------------------

HEADLESS_ROWS = 250_000      # (c)'s rows per block (ctr-12m.job: 1,562,500)


def _fs_run(tr):
    """tr.run() of a FeatureShardedAdmmTrainer under
    torch.cuda.set_sync_debug_mode("warn"): its result and the
    synchronizing calls of each iteration but the last (from the start of
    one x-update to the next's: the iteration's own read included, the
    run's set-up and its closing gathers apart). The iterations are
    marked at the trainer's `_x_update`, whatever it is set to."""
    import warnings
    import torch
    own = "_x_update" in tr.__dict__
    x_update, marks = tr._x_update, []
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")

        def marked(*a):
            marks.append(len(seen))
            return x_update(*a)
        tr._x_update = marked
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = tr.run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            if own:
                tr._x_update = x_update
            else:
                del tr._x_update
    sync = [i for i, w in enumerate(seen)
            if "called a synchronizing" in str(w.message)]
    return res, [sum(lo <= i < hi for i in sync)
                 for lo, hi in zip(marks[:-1], marks[1:])]


def _same_run(a, b):
    import numpy as np
    return bool(np.array_equal(a.z, b.z) and np.array_equal(a.u, b.u)
                and a.solver_stats == b.solver_stats)


def _k1_checked_x_update(tr, gen):
    """(b): one host-driven x-update of an AdmmTrainer from random z and u,
    every K1 call of it held to its float64 plain sum (k1_checked)."""
    import torch
    import mlease_tpu_torch.ops.tron_multi as tm
    cfg = tr.config
    L, n, B = len(tr.lambdas), tr.dim, tr.data.nblocks
    z = 0.01 * torch.randn((L, n), generator=gen, device="cuda")
    u = 0.01 * torch.randn((L, B, n), generator=gen, device="cuda")
    rho = torch.as_tensor(tr.rhos, device="cuda")
    with k1_checked(tm) as chk:
        tr.step.solve(tr.prob, tr.present, z, u, rho,
                      cfg.liblinear_epsilon * tr.eps_scale)
    return chk


def headless_fs_cell(ell, vocab, args, gen):
    """(c)'s feature-sharded cell: FeatureShardedAdmmTrainer on a one-rank
    NCCL 1 x 1 mesh, LOOPS_ITERS iterations on its device loop (made and
    captured in the first run's first iteration), again on the kept loop
    (host reads an iteration, K1 / all_reduce executions on the card), and
    with the seam on the host-driven solve; every K1 call of one
    host-driven x-update held to its float64 plain sum."""
    import gc
    import torch
    import mlease_tpu_torch.ops.tron_multi as tm
    from mlease_tpu_torch.parallel import distributed
    from mlease_tpu_torch.parallel.mesh import make_mesh_2d
    from mlease_tpu_torch.train.admm import AdmmConfig
    from mlease_tpu_torch.train.feature_sharded import \
        FeatureShardedAdmmTrainer
    cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=LOOPS_ITERS,
                     pcg=True, flat_blocks=False, dtype=torch.float32)
    distributed.initialize_single("cuda")
    try:
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError("a cuda mesh must run NCCL")
        t0 = time.monotonic()
        tr = FeatureShardedAdmmTrainer(ell, vocab, cfg,
                                       mesh=make_mesh_2d(1, 1, "cuda"))
        torch.cuda.synchronize()
        build_s = time.monotonic() - t0
        with timed_prepare() as cap:
            first, c1 = _counted(tr.run)
        # what the loop keeps after its run (its state and pool), with the
        # caching allocator's free blocks given back
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        kept = torch.cuda.memory_reserved() - c1["base_reserved_bytes"]
        (again, syncs), c2 = _counted(lambda: _fs_run(tr))
        counts = tr._loops["x"].loop.counts()
        tr._x_update = tr._host_x_update
        try:
            (host, host_syncs), ch = _counted(lambda: _fs_run(tr))
            L, nl = len(tr.lambdas), tr.fs.n_local
            B = tr.present.shape[0]
            z = 0.01 * torch.randn((L, nl), generator=gen, device="cuda")
            u = 0.01 * torch.randn((L, B, nl), generator=gen, device="cuda")
            rho = torch.as_tensor(tr.rhos, device="cuda")
            with k1_checked(tm) as chk:
                tr._host_x_update(z, u, rho,
                                  cfg.liblinear_epsilon * tr.eps_scale)
        finally:
            del tr._x_update
        row = {
            "rows": int(ell.y.size), "build_s": build_s,
            "iterations": [first.iterations, again.iterations,
                           host.iterations],
            "loop_bit_for_bit_with_seam": _same_run(again, host),
            "two_loop_runs_bit_for_bit": _same_run(first, again),
            "solver_stats": again.solver_stats,
            "syncs_per_iteration_loop": syncs,
            "syncs_per_iteration_seam": host_syncs,
            "k1_loop": c2["k1"], "k1_on_card": c2["card"]["k1"],
            "k1_seam": ch["k1"], "k1_first_run_setup": c1["setup"]["k1"],
            "all_reduce_executions": counts.get(
                "kernel_executions", {}).get("all_reduce"),
            "capture_modes": counts.get("capture_modes"),
            "capture_s": cap["s"],
            "pool_reserved_bytes": cap["pool_reserved_bytes"],
            "kept_reserved_bytes": int(kept),
            "solver_state_bytes": _state_bytes(tr._loops.values()),
            "loop_iter_s": again.iter_times,
            "loop_steady_iter_s": steady_s(again.iter_times),
            "seam_iter_s": host.iter_times,
            "seam_steady_iter_s": steady_s(host.iter_times),
            "k1_check": chk}
        del tr
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    bad = [f"(c) feature-sharded: {w}" for w, ok in (
        ("the loop's run equals the seam's", row[
            "loop_bit_for_bit_with_seam"]),
        ("two loop runs the same bits", row["two_loop_runs_bit_for_bit"]),
        ("one host read an iteration",
         row["syncs_per_iteration_loop"] == [1] * (LOOPS_ITERS - 1)),
        ("K1 executed on the card", row["k1_on_card"] > 0),
        ("K1 run as often as on the seam", row["k1_loop"] == row["k1_seam"]),
        ("every K1 call within its float64 bound",
         chk["ok"] and chk["calls"] > 0)) if not ok]
    return row, bad


def headless_phase(args):
    """Phase 23: see the module docstring."""
    import torch
    import mlease_tpu_torch.ops.tron_multi as tm
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer

    t_phase = time.monotonic()
    out, bad = {}, []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 23)
    # (a), (b) bench's step without a head
    bdata = synth_blocked_data(50_000, 4, 16_384, 15, args.seed)
    bvocab = make_vocab(50_000)
    bcfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=LOOPS_ITERS,
                      pcg=True, flat_blocks=True, dtype=torch.float32)
    n, R = bdata.dim, bdata.padded_rows
    for name, kw, bound in (
            ("flat", {}, None),
            ("per_block", dict(flat_blocks=False), None),
            ("4 substacks", {}, max(n, R) + 1)):
        ctx = (mock.patch.object(tm, "STACK_ID_BOUND", bound) if bound
               else contextlib.nullcontext())
        with ctx:
            tr = AdmmTrainer(bdata, bvocab, dataclasses.replace(bcfg, **kw))
        parts = tm.substacks_of(tr.prob, bdata.nblocks)
        row, b = one_x_update_check(f"headless {name}", tr, tr.mode, True,
                                    gen)
        bad += b
        row["k1_check"] = chk = _k1_checked_x_update(tr, gen)
        runs = [run_with(tr, LOOPS_ITERS) for _ in range(2)]
        host = run_with(tr, LOOPS_ITERS, _x_update=host_x_update(tr))
        row.update(parts=len(parts), copy_bytes=sum(
            t.numel() * t.element_size() for p, _r in parts
            for t in (p.csc_rows, p.csc_cols, p.csc_vals)),
            two_runs_bit_for_bit=_same_run(*runs),
            run_bit_for_bit_with_host_path=_same_run(runs[1], host),
            iter_s=[r.iter_times for r in runs],
            host_iter_s=host.iter_times)
        out[f"a {name}"] = row
        print(f"headless (a) {name} " + json.dumps(row), flush=True)
        if not (row["two_runs_bit_for_bit"]
                and row["run_bit_for_bit_with_host_path"]):
            bad.append(f"(a) {name}: two runs, or a run and the host "
                       f"path's, differ")
        if not (chk["ok"] and chk["calls"] > 0):
            bad.append(f"(b) {name}: K1 calls {chk}")
        if len(parts) != (4 if bound else 1):
            bad.append(f"(a) {name}: {len(parts)} sub-stacks")
        del tr, runs
        torch.cuda.empty_cache()
    out["a_s"] = time.monotonic() - t_phase

    # (c) ctr-12m.job's widths without a head, rows cut to HEADLESS_ROWS
    t0 = time.monotonic()
    ell = synth_blocked_data(1_000_000, 8, HEADLESS_ROWS, 12, args.seed)
    vocab = make_vocab(1_000_000)
    cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=LOOPS_ITERS,
                     pcg=True, flat_blocks=True, dtype=torch.float32)
    tr = AdmmTrainer(ell, vocab, cfg)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    prob = tr.prob
    row, b, res = _run_against_host("headless full flat", tr,
                                    dict(_x_update=host_x_update(tr)),
                                    "admm_iteration", profile=False)
    bad += b
    again = run_with(tr, LOOPS_ITERS)
    # K1 at the head-less X'v site against its plain version, and the
    # index_add_ over the ELL that it replaces (the library call)
    site = (prob.csc_vals, prob.csc_rows, prob.csc_cols, prob.y.shape[0],
            prob.prior_mean.shape[0], 1)
    sites = []
    fused_check_and_time("headless/xtv", site, 3, torch.float32, gen, sites,
                         variants=False)
    D = torch.randn((3, prob.y.shape[0]), generator=gen, device="cuda")
    lib = torch.zeros((3, prob.prior_mean.shape[0]), device="cuda")
    ids = prob.indices.reshape(-1)
    sites[0]["ell_index_add_ms"] = cuda_ms(lambda: lib.zero_().index_add_(
        1, ids, (prob.values[None] * D[:, :, None]).reshape(3, -1)))
    del D, lib, ids
    row.update(rows=int(ell.y.size), build_s=build_s,
               two_runs_bit_for_bit=_same_run(res, again),
               copy_bytes=sum(t.numel() * t.element_size() for t in (
                   prob.csc_rows, prob.csc_cols, prob.csc_vals)),
               ell_slots=int(prob.indices.numel()), xtv_site=sites[0])
    out["c flat"] = row
    print("headless (c) flat " + json.dumps(row), flush=True)
    if not row["two_runs_bit_for_bit"]:
        bad.append("(c) flat: two runs differ")
    del tr, prob, site, res, again
    torch.cuda.empty_cache()
    out["c feature_sharded"], b = headless_fs_cell(ell, vocab, args, gen)
    print("headless (c) feature-sharded " + json.dumps(
        out["c feature_sharded"]), flush=True)
    bad += b
    out["s"] = time.monotonic() - t_phase
    print(f"headless phase {out['s']:.1f} s", flush=True)
    if bad:
        raise AssertionError(f"headless: {bad}")
    return out


# ---------------------------------------------------------------------------
# phase 24: the card paths, run on the card where only the CPU tests had
# run them: the streamed lanes solve, consensus on the host, a resumed run
# and a moving rho on the device loops
# ---------------------------------------------------------------------------

COVERAGE_ITERS = 3          # (a)'s iterations a run
FULL_LANES_ITERS = 2        # (b)'s
RESUME_AT = 2               # (d): a run stopped after 2 of 4 iterations
RHO_ITERS = 4               # (e)'s
RHO_ADAPT = 0.1             # (e)'s rho.adapt.coefficient
TIGHT_EPS = 1e-8            # (a): liblinear.epsilon where two layouts'
                            # float64 runs are held to one another


def _card_run(tr, iters, seams=None, **run_kw):
    """tr.run(**run_kw) through run_with (`iters` iterations, the
    trainer's methods in `seams` replaced), counted: (result, row), the
    row its iterations, trips, s an iteration, the host reads of each
    iteration but the first and the last (_syncs_by_iteration; not
    counted for a run with a callback of its own, which reads z and u),
    K1's runs (kernel_runs: all of them, those inside the loops' graphs
    counted on the card, and those of the loops' set-up), the run's
    seconds and its peak device bytes."""
    seams = seams or {}
    callback = run_kw.pop("callback", None)
    if callback is not None:
        res, c = _counted(lambda: run_with(tr, iters, callback, run_kw,
                                           **seams))
        reads = None
    else:
        (res, syncs), c = _counted(lambda: _syncs_by_iteration(
            lambda cb: run_with(tr, iters, cb, run_kw, **seams)))
        reads = syncs["per_iteration"]
    return res, {"iterations": res.iterations,
                 "solver_stats": res.solver_stats, "iter_s": res.iter_times,
                 "steady_iter_s": steady_s(res.iter_times),
                 "reads_per_iteration": reads, "k1": c["k1"],
                 "k1_in_graphs": c["card"]["k1"],
                 "k1_setup": c["setup"]["k1"], "s": c["s"],
                 "peak_bytes": c["peak_bytes"]}


def _one_read(row, what):
    """A run on the device loops reads the host once an iteration."""
    reads = row["reads_per_iteration"]
    return [] if reads is not None and all(r == 1 for r in reads) else [
        f"{what}: host reads an iteration {reads}"]


def _checkpoint_into(kept):
    """A run's callback that keeps the run's state as the train pipeline's
    checkpoint keeps it (train/pipeline.py: z, u, inner_eps, the smallest
    diff, the best-loglik sentinel), as run()'s resume arguments
    (convert.state_from_numpy)."""
    import numpy as np
    from mlease_tpu_torch.convert import state_from_numpy

    def callback(iteration, z, u, diffs, inner_eps, logliks=None):
        kept.clear()
        kept.update(state_from_numpy(
            z.cpu().numpy(), u.cpu().numpy(), iteration=iteration,
            inner_eps=inner_eps, mindiff=float(np.min(diffs)),
            best_loglik=-9999999.0))
    return callback


def _same_blocks(whole, parts):
    """Whether `parts`, concatenated on the block axis, are `whole` bit
    for bit (None where all are None)."""
    import torch
    if whole is None or any(p is None for p in parts):
        return whole is None and all(p is None for p in parts)
    return bool(torch.equal(whole, torch.cat(parts)))


def _distance(a, b, tag):
    """{tag}_max_abs_diff, the largest |a.z - b.z|, and {tag}_max_abs,
    b's largest |z|."""
    import numpy as np
    return {f"{tag}_max_abs_diff": float(np.abs(a.z - b.z).max()),
            f"{tag}_max_abs": float(np.abs(b.z).max())}


def layout_sums(whole, parts, gen):
    """Which sums of the lanes solve move with the layout on the card.
    `whole` a lanes _SolveLoop, `parts` [(loop, b0)]: each loop's blocks
    are whole's from b0 on (the same bits in another layout: the groups
    of 2 and the 4 blocks in memory, or each group with its tails padded
    and unpadded). On the same random inputs: X'v, Xv and the Jacobi
    diagonal (objective.xtv, xv and hessian_diagonal: K1 over the
    column-sorted copy and the tails, the head's GEMM) and a lane dot
    product as ops/tron.py forms its norms
    ((a * a).sum(-1) over (L, B, n)), each compared on the part's
    blocks: {sum: {"bits_equal", "max_rel_diff"}} over all parts."""
    import torch
    from mlease_tpu_torch.ops import objective

    pw = whole.parts[0].solver.prob
    L = whole.parts[0].L
    (B, R), n = pw.y.shape, pw.dim
    dt = pw.prior_mean.dtype
    d = torch.randn((L, B, R), generator=gen, device="cuda", dtype=dt)
    v = torch.randn((L, B, n), generator=gen, device="cuda", dtype=dt)
    got = {"xtv": [], "xv": [], "hessian_diagonal": [], "dot": []}
    for loop, b0 in parts:
        pp = loop.parts[0].solver.prob
        b1 = b0 + pp.y.shape[0]
        Bp = b1 - b0
        got["xtv"].append((
            objective.xtv(pw, d.reshape(L * B, R)).view(L, B, n)[:, b0:b1],
            objective.xtv(pp, d[:, b0:b1].reshape(L * Bp, R)).view(
                L, Bp, n)))
        got["xv"].append((
            objective.xv(pw, v.reshape(L * B, n)).view(L, B, R)[:, b0:b1],
            objective.xv(pp, v[:, b0:b1].reshape(L * Bp, n)).view(
                L, Bp, R)))
        got["hessian_diagonal"].append((
            objective.hessian_diagonal(pw, v.reshape(L * B, n)).view(
                L, B, n)[:, b0:b1],
            objective.hessian_diagonal(
                pp, v[:, b0:b1].reshape(L * Bp, n)).view(L, Bp, n)))
        got["dot"].append(((v * v).sum(-1)[:, b0:b1],
                           (v[:, b0:b1] * v[:, b0:b1]).sum(-1)))
    torch.cuda.synchronize()
    return {k: {"bits_equal": all(bool(torch.equal(x, y)) for x, y in xy),
                "max_rel_diff": max(float(((x - y).abs() / y.abs(
                    ).clamp_min(1e-300)).max()) for x, y in xy)}
            for k, xy in got.items()}


def coverage_lanes_bench(args, gen):
    """(a): the streamed lanes solve at bench.py's step (4 blocks, phase
    14's lanes data) in 2 groups of 2, COVERAGE_ITERS iterations a run.
    Without a head (each group ships its column order; no residency tier
    exists without a head, in either package): streamed, and streamed
    with consensus on the host; with bench's head (512): every group
    resident and streamed with consensus on the host (the compact wire),
    and with the tails left at their widths (streaming.pad.tails =
    false) every group resident and streamed (the dense wire). Each
    layout's tiers the same bits; group 0's solve through its loop (a run
    of one iteration more) equal to build_group_solver's on the same
    inputs in its slot; each head-less group's problem, unstacked from
    its slot with the shipped order, equal to the in-memory lanes
    problem's blocks field by field (the ELL and its column-sorted copy,
    y, weight, offset), bit for bit; the two runs' z after one iteration
    and after COVERAGE_ITERS stated in float32 and float64 at the job's
    liblinear.epsilon 0.01 beside their trips and the sums that differ
    between the layouts (layout_sums; ROADMAP.md C, known trait 10), and
    in float64 at liblinear.epsilon TIGHT_EPS held within 1e-6 * max|z|;
    the head 512 layout's padded and unpadded tails alike in float64
    (stated at 0.01, held within 1e-6 * max|z| at TIGHT_EPS); K1 on each
    streamed group's problem against the float64 scatter
    (lanes_sorted_sum_check, K1's bound)."""
    import numpy as np
    import torch
    from mlease_tpu_torch.core.dataset import split_blocks, to_hybrid
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer
    from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer

    bdata = synth_blocked_data(50_000, 4, 16_384, 15, args.seed)
    vocab = make_vocab(50_000)
    cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=COVERAGE_ITERS,
                     pcg=True, multi_rhs=False, dtype=torch.float32)
    groups = split_blocks(bdata, 2)
    streamed = dict(resident_head=False)
    host_u = dict(resident_head=False, consensus_device=False)
    layouts = {
        "head-less": (groups, cfg, {"streamed": streamed,
                                    "streamed host u": host_u}),
        # the dense wire with unpadded tails in one streamed tier, the
        # compact wire with the tails padded to one width ("auto") in the
        # other (streaming.wire, streaming.pad.tails)
        # the unpadded tails are another layout of the same sums, which
        # the card associates otherwise (layout_sums), with bits of
        # their own: its streamed tier is held to a resident run of it,
        # the two layouts to each other below
        "head 512": ([to_hybrid(g, 512) for g in groups],
                     dataclasses.replace(cfg, head_size=512),
                     {"resident": dict(resident_head=True),
                      "streamed host u": host_u,
                      "resident, tails unpadded": dict(resident_head=True,
                                                       pad_tails=False),
                      "streamed": dict(streamed, compact_wire=False,
                                       pad_tails=False)})}
    out, bad, runs, k1 = {}, [], {}, 0
    for layout, (lgroups, lcfg, tiers) in layouts.items():
        for tier, kw in tiers.items():
            name = f"{layout} {tier}"
            t0 = time.monotonic()
            tr = StreamingAdmmTrainer(lgroups, vocab, lcfg, **kw)
            torch.cuda.synchronize()
            build_s = time.monotonic() - t0
            with timed_prepare() as cap:
                res, row = _card_run(tr, COVERAGE_ITERS)
            k1 += row["k1"]
            seen = {}
            one = run_with(tr, 1, _solve_group=group0_check(tr, seen))
            row.update(
                build_s=build_s, residency=tr.residency_report(),
                slots={str(g): s for g, s in tr._slot_of.items()},
                tail_widths=[None if g.tail_vals is None
                             else int(g.tail_vals.shape[1])
                             for g in tr.groups],
                tails_padded_from=tr._tail_orig_T,
                column_order_bytes=sum(
                    p.numel() * p.element_size() for p in tr.csc_perms
                    if p is not None),
                capture_s=cap["s"], loops=cap["loops"],
                pool_reserved_bytes=cap["pool_reserved_bytes"],
                group0=seen)
            if layout == "head-less" and tier == "streamed":
                # each group's problem as its loop reads it, unstacked
                # from its slot with the shipped order
                unstacked = [lp.parts[0].prob for _g, lp in
                             sorted(tr._loops.items())]
                row["k1_on_shipped_order"] = [
                    r for gi, lp in sorted(tr._loops.items())
                    for r in lanes_sorted_sum_check(
                        f"coverage (a) group {gi}", lp.parts[0].prob,
                        tr.dim, gen, tag="coverage")]
                if not (row["k1_on_shipped_order"] and all(
                        r["ok"] for r in row["k1_on_shipped_order"])):
                    bad.append(f"(a) {name}: K1 on the shipped order")
            print(f"coverage (a) {name} " + json.dumps(row), flush=True)
            out[name] = row
            runs[name] = res, one
            bad += _one_read(row, f"(a) {name}")
            if not (seen.get("x") and seen["trips"] == seen["host_trips"]):
                bad.append(f"(a) {name}: group 0's solve differs: {seen}")
            if row["k1_in_graphs"] <= 0:
                bad.append(f"(a) {name}: K1 not run in the loops' graphs")
            del tr
            torch.cuda.empty_cache()
    # the same blocks in memory: each group's problem is the in-memory
    # lanes problem's blocks, bit for bit, and so are its X'v, Xv and
    # Jacobi diagonal, but the solver's dot products and norms (torch's
    # reductions over 6 lanes or 12) associate otherwise (layout_sums),
    # and at the job's liblinear.epsilon 0.01 the solver's stop tests
    # carry a last-bit difference to its tolerance, as a permutation of
    # the rows does in the JAX package's own float64 solve on the CPU
    # (tests/test_torch_f64_order.py, ROADMAP.md C, known trait 10): the
    # runs' z after one iteration and after COVERAGE_ITERS are stated in
    # float32 and float64. At liblinear.epsilon TIGHT_EPS in float64 the
    # two solve to one point: z held within 1e-6 * max|z|, trips stated
    fields = ("indices", "values", "y", "weight", "offset", "csc_cols",
              "csc_rows", "csc_vals")
    f64 = dataclasses.replace(cfg, dtype=torch.float64)
    tight = dataclasses.replace(f64, liblinear_epsilon=TIGHT_EPS)
    for dt in (torch.float32, torch.float64):
        dcfg = dataclasses.replace(cfg, dtype=dt)
        if dt == torch.float32:
            res, one = runs["head-less streamed"]
        else:
            st = StreamingAdmmTrainer(groups, vocab, dcfg, **streamed)
            one = run_with(st, 1)
            res, srow = _card_run(st, COVERAGE_ITERS)
            k1 += srow["k1"]
        mem = AdmmTrainer(bdata, vocab, dcfg)
        if dt == torch.float32:
            out["unstacked_equal_in_memory"] = {
                f: _same_blocks(getattr(mem.prob, f),
                                [getattr(p, f) for p in unstacked])
                for f in fields}
            del unstacked
        mone, _ = _card_run(mem, 1)
        mres, mrow = _card_run(mem, COVERAGE_ITERS)
        if dt == torch.float64:
            mrow["layout_sums_streamed_vs_in_memory"] = layout_sums(
                mem._loops["x"], [(st._loops[g], 2 * g) for g in (0, 1)],
                gen)
            del st
        del mem
        k1 += mrow["k1"]
        mrow.update(_distance(one, mone, "z1"), **_distance(res, mres, "z"),
                    # the streamed run's trips are sums over its lanes,
                    # the in-memory run's the lock-step maxima
                    streamed_solver_stats=res.solver_stats)
        name = f"in memory lanes, head-less, {str(dt)[6:]}"
        out[name] = mrow
        print(f"coverage (a) {name} " + json.dumps(mrow), flush=True)
    # the head 512 layout's tails padded to one width and left at their
    # widths: in float64 at 0.01 (stated) and at TIGHT_EPS (held)
    hgroups = layouts["head 512"][0]
    for ecfg, held in ((f64, False), (tight, True)):
        pair = []
        for kw in (dict(resident_head=True),
                   dict(resident_head=True, pad_tails=False)):
            tr = StreamingAdmmTrainer(hgroups, vocab, dataclasses.replace(
                ecfg, head_size=512), **kw)
            pair.append((tr,) + _card_run(tr, COVERAGE_ITERS))
            k1 += pair[-1][2]["k1"]
        row = _distance(pair[0][1], pair[1][1], "z")
        row.update(solver_stats=[r.solver_stats for _t, r, _w in pair],
                   s=[w["s"] for _t, _r, w in pair],
                   liblinear_epsilon=ecfg.liblinear_epsilon)
        if not held:
            row["layout_sums"] = {
                str(g): layout_sums(pair[0][0]._loops[g],
                                    [(pair[1][0]._loops[g], 0)], gen)
                for g in (0, 1)}
        del pair
        name = ("padded vs unpadded tails, float64, eps "
                f"{ecfg.liblinear_epsilon}")
        out[name] = row
        print(f"coverage (a) {name} " + json.dumps(row), flush=True)
        if held and not row["z_max_abs_diff"] <= 1e-6 * row["z_max_abs"]:
            bad.append(f"(a) {name}: not within 1e-6 * max|z|: {row}")
    # the head-less streamed and in-memory runs at TIGHT_EPS (held)
    pair = []
    for make in (lambda: StreamingAdmmTrainer(groups, vocab, tight,
                                              **streamed),
                 lambda: AdmmTrainer(bdata, vocab, tight)):
        pair.append(_card_run(make(), COVERAGE_ITERS))
        k1 += pair[-1][1]["k1"]
    row = _distance(pair[0][0], pair[1][0], "z")
    row.update(solver_stats=[r.solver_stats for r, _w in pair],
               s=[w["s"] for _r, w in pair], liblinear_epsilon=TIGHT_EPS)
    name = f"streamed vs in memory, head-less, float64, eps {TIGHT_EPS}"
    out[name] = row
    print(f"coverage (a) {name} " + json.dumps(row), flush=True)
    if not row["z_max_abs_diff"] <= 1e-6 * row["z_max_abs"]:
        bad.append(f"(a) {name}: not within 1e-6 * max|z|: {row}")
    same = {name: _same_run(runs[name][0], runs[ref][0]) for name, ref in (
        ("head-less streamed host u", "head-less streamed"),
        ("head 512 streamed host u", "head 512 resident"),
        ("head 512 streamed", "head 512 resident, tails unpadded"))}
    out["tiers_bit_for_bit"] = same
    out["padded_vs_unpadded_z_max_abs_diff"] = float(np.abs(
        runs["head 512 resident"][0].z
        - runs["head 512 resident, tails unpadded"][0].z).max())
    out["k1_runs"] = k1
    if not all(same.values()):
        bad.append(f"(a) the tiers differ: {same}")
    if not all(out["unstacked_equal_in_memory"].values()):
        bad.append(f"(a) the streamed groups' problems against the "
                   f"in-memory one: {out['unstacked_equal_in_memory']}")
    return out, bad


def coverage_lanes_full(args, gen):
    """(b): the streamed lanes solve at ctr-12m.job's widths without a
    head (phase 23 (c)'s blocks, 8 x HEADLESS_ROWS rows) in 4 groups of
    2, nothing resident: one iteration on the loops (each group's loop
    made and captured) against the same trainer's host-driven group
    solves (build_group_solver), bit for bit; then FULL_LANES_ITERS
    iterations on the kept loops: s an iteration, trips, host reads, K1
    in the graphs, wire bytes (the column order 4 bytes an ELL entry),
    each loop's capture s and pool."""
    import torch
    from mlease_tpu_torch.core.dataset import split_blocks
    from mlease_tpu_torch.train.admm import AdmmConfig
    from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer

    cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=FULL_LANES_ITERS,
                     pcg=True, multi_rhs=False, dtype=torch.float32)
    t0 = time.monotonic()
    ell = synth_blocked_data(1_000_000, 8, HEADLESS_ROWS, 12, args.seed)
    entries = int(ell.indices.size)
    tr = StreamingAdmmTrainer(split_blocks(ell, 4), make_vocab(1_000_000),
                              cfg, resident_head=False)
    del ell
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    with timed_prepare() as cap:
        first, r1 = _card_run(tr, 1)
    host, rh = _card_run(tr, 1, seams=dict(
        _solve_group=host_group_solve(tr)))
    again, row = _card_run(tr, FULL_LANES_ITERS)
    row.update(
        build_s=build_s, rows=8 * HEADLESS_ROWS, groups=len(tr.groups),
        ell_entries=entries, residency=tr.residency_report(),
        wire_bytes_per_iter=tr.stream_wire_bytes(),
        column_order_bytes=sum(p.numel() * p.element_size()
                               for p in tr.csc_perms if p is not None),
        capture_s=cap["s"], capture_each=cap["each"],
        pool_reserved_bytes=cap["pool_reserved_bytes"],
        first_iteration_loop=r1, first_iteration_host=rh,
        bit_for_bit_with_host_path=_same_run(first, host),
        slots_bytes=sum(sl.nbytes() for sl in tr._slots),
        solver_state_bytes=_state_bytes(tr._loops.values()))
    del tr
    torch.cuda.empty_cache()
    print("coverage (b) " + json.dumps(row), flush=True)
    row["k1_runs"] = r1["k1"] + row["k1"]
    bad = _one_read(row, "(b)")
    if not row["bit_for_bit_with_host_path"]:
        bad.append("(b): the loops' first iteration differs from the host "
                   "path's")
    if row["k1_in_graphs"] <= 0 or r1["k1_in_graphs"] <= 0:
        bad.append("(b): K1 not run in the loops' graphs")
    return row, bad


def _stream_c_reference(args):
    """--coverage-only: phase 11's groups and its (c) run, made as phase 11
    makes them."""
    import torch
    from mlease_tpu_torch.core.dataset import split_blocks, to_hybrid
    from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer

    groups = split_blocks(synth_blocked_data(
        1_000_000, 8, args.rows_per_block, 12, args.seed), STREAM_GROUPS)
    for i, g in enumerate(groups):
        groups[i] = to_hybrid(g, 128, column_sorted=True,
                              head_dtype=torch.bfloat16)
    tr = StreamingAdmmTrainer(groups, make_vocab(1_000_000),
                              _stream_c_config(args), resident_head=False,
                              compact_wire=True)
    res = tr.run()
    row = {"groups": groups, "z": res.z, "u": res.u,
           "solver_stats": res.solver_stats,
           "steady_iter_s": steady_s(res.iter_times),
           "wire_bytes_per_iter": tr.stream_wire_bytes()}
    del tr
    torch.cuda.empty_cache()
    return row


def _stream_c_config(args):
    import torch
    from mlease_tpu_torch.train.admm import AdmmConfig
    return AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=args.iters,
                      head_size=128, head_dtype=torch.bfloat16, pcg=True,
                      flat_blocks=True, dtype=torch.float32)


def coverage_host_u(args):
    """(c): consensus on the host at full width: phase 11's (c) groups
    (nothing resident, the compact wire) with consensus_device=False, u
    in page-locked memory shipped in each group's slot and x fetched
    back: --iters iterations, bit for bit with phase 11 (c)'s run, equal
    trips; s an iteration beside (c)'s, the u and x bytes on the wire."""
    import numpy as np
    import torch
    from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer

    base = COVERAGE.pop("stream_c", None) or _stream_c_reference(args)
    t0 = time.monotonic()
    tr = StreamingAdmmTrainer(base["groups"], make_vocab(1_000_000),
                              _stream_c_config(args), resident_head=False,
                              compact_wire=True, consensus_device=False)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    with timed_prepare() as cap:
        res, row = _card_run(tr, args.iters)
    u_bytes = len(tr.lambdas) * tr.nblocks * tr.dim * 4
    row.update(
        build_s=build_s, residency=tr.residency_report(),
        wire_bytes_per_iter=tr.stream_wire_bytes(),
        u_bytes_each_way_per_iter=u_bytes,
        phase_11_c_wire_bytes_per_iter=base["wire_bytes_per_iter"],
        phase_11_c_steady_iter_s=base["steady_iter_s"],
        bit_for_bit_with_phase_11_c=bool(
            np.array_equal(res.z, base["z"])
            and np.array_equal(res.u, base["u"])),
        trips_equal=res.solver_stats == base["solver_stats"],
        capture_s=cap["s"], pool_reserved_bytes=cap["pool_reserved_bytes"])
    del tr, base
    torch.cuda.empty_cache()
    print("coverage (c) " + json.dumps(row), flush=True)
    row["k1_runs"] = row["k1"]
    bad = _one_read(row, "(c)")
    if not (row["bit_for_bit_with_phase_11_c"] and row["trips_equal"]):
        bad.append("(c): host consensus differs from phase 11 (c)'s run")
    if row["k1_in_graphs"] <= 0:
        bad.append("(c): K1 not run in the loops' graphs")
    return row, bad


def coverage_resume(args):
    """(d): a resumed run on the device loops: in memory (bench's step,
    flat Jacobi, its head) and streamed (phase 14's lanes data in (a)'s 2
    groups, nothing resident) in the multi-RHS and the lanes solve: a run
    stopped after RESUME_AT iterations, its state kept by the callback as
    the pipeline's checkpoint keeps it, then a new trainer resumed for
    RESUME_AT more: z, u, diffs and trips bit for bit with the
    uninterrupted run; then phase 5's job through the CLI, 10 iterations
    and resume = true to 20 (cli_resume_runs, started in phase 5): the
    final models within 1e-10 * max|w| of phase 5's 20 iterations."""
    import numpy as np
    import torch
    from mlease_tpu_torch.core.dataset import split_blocks
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer
    from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer

    bdata = synth_blocked_data(50_000, 4, 16_384, 15, args.seed)
    vocab = make_vocab(50_000)
    base = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=2 * RESUME_AT,
                      pcg=True, flat_blocks=True, dtype=torch.float32)

    def streamed(cfg):
        return StreamingAdmmTrainer(split_blocks(bdata, 2), vocab, cfg,
                                    resident_head=False)
    cells = {"in memory flat": (lambda cfg: AdmmTrainer(bdata, vocab, cfg),
                                dataclasses.replace(base, head_size=512)),
             "streamed multi_rhs": (streamed, base),
             "streamed lanes": (streamed, dataclasses.replace(
                 base, multi_rhs=False))}
    out, bad, k1 = {}, [], 0
    for name, (make, cfg) in cells.items():
        whole, rw = _card_run(make(cfg), 2 * RESUME_AT)
        kept = {}
        first, r1 = _card_run(make(cfg), RESUME_AT,
                              callback=_checkpoint_into(kept))
        start = kept["start_iteration"]
        resumed, rr = _card_run(make(cfg), 2 * RESUME_AT, **kept)
        k1 += rw["k1"] + r1["k1"] + rr["k1"]
        row = {"whole": rw, "first": r1, "resumed": rr,
               "start_iteration": start,
               "bit_for_bit": bool(
                   np.array_equal(resumed.z, whole.z)
                   and np.array_equal(resumed.u, whole.u)
                   and first.diff_history + resumed.diff_history
                   == whole.diff_history
                   and first.solver_stats + resumed.solver_stats
                   == whole.solver_stats)}
        print(f"coverage (d) {name} " + json.dumps(row), flush=True)
        out[name] = row
        if not (row["bit_for_bit"] and start == RESUME_AT + 1
                and resumed.iterations == 2 * RESUME_AT):
            bad.append(f"(d) {name}: the resumed run differs from the "
                       f"uninterrupted one")
        bad += _one_read(rr, f"(d) {name} resumed")
        if rr["k1_in_graphs"] <= 0:
            bad.append(f"(d) {name}: K1 not run in the loops' graphs")
        torch.cuda.empty_cache()

    if "eager" not in CLI_MODELS:
        cli_phase()
    cli = taken("cli_resume", cli_resume_runs)
    ref, got = CLI_MODELS["eager"], cli.pop("models")
    wmax = max([abs(ref[k][0]) for k in ref]
               + [abs(v) for k in ref for v in ref[k][1].values()])
    same_keys = sorted(got) == sorted(ref) and all(
        sorted(got[k][1]) == sorted(ref[k][1]) for k in ref)
    cli.update(max_abs_diff_vs_phase_5=_max_model_diff(ref, got)
               if same_keys else None, w_max_abs=wmax,
               phase_5_best_loglik=CLI_ROWS.get("eager", {}).get(
                   "best_loglik"))
    out["cli"] = cli
    out["k1_runs"] = k1
    print("coverage (d) cli " + json.dumps(cli), flush=True)
    want_ckpt = [f"iter-{i:05d}.{e}" for i in (9, 10) for e in ("json",
                                                                "npz")]
    if not (same_keys and cli["max_abs_diff_vs_phase_5"] <= 1e-10 * wmax
            and cli["first"]["iterations"] == 10
            and cli["resumed"]["iterations"] == 20
            and cli["checkpoints_after_first"] == want_ckpt):
        bad.append(f"(d) the resumed CLI run: {cli}")
    return out, bad


def _loop_against_host(case, cfg, args):
    """run() at bench's step (its head) with `cfg`, RHO_ITERS iterations
    on its loop, bit for bit with run() whose x-update goes through
    build_x_update's host-driven solve: z, u, diffs and trips, and K1 run
    as often (the loop's set-up apart). Returns (row, failures)."""
    import torch
    from mlease_tpu_torch.train.admm import AdmmTrainer

    tr = AdmmTrainer(synth_blocked_data(50_000, 4, 16_384, 15, args.seed),
                     make_vocab(50_000), cfg)
    loop, row = _card_run(tr, RHO_ITERS)
    host, rh = _card_run(tr, RHO_ITERS, seams=dict(
        _x_update=host_x_update(tr)))
    del tr
    torch.cuda.empty_cache()
    row.update(host=rh, bit_for_bit_with_host_path=bool(
        _same_run(loop, host) and loop.diff_history == host.diff_history))
    row["k1_runs"] = row["k1"]
    bad = _one_read(row, case)
    if not row["bit_for_bit_with_host_path"]:
        bad.append(f"{case}: the loop differs from the host path")
    if row["k1_in_graphs"] <= 0 \
            or row["k1"] - row["k1_setup"] != rh["k1"]:
        bad.append(f"{case}: K1 {row['k1']} (set-up {row['k1_setup']}) "
                   f"against the host path's {rh['k1']}")
    return row, bad


def coverage_rho(args):
    """(e): rho adaptation (rho.adapt.coefficient RHO_ADAPT: rho_eff
    moves every iteration, and reaches the loop through its inputs) in
    run(), flat Jacobi (_loop_against_host)."""
    import torch
    from mlease_tpu_torch.ops import admm_math
    from mlease_tpu_torch.train.admm import AdmmConfig

    cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=RHO_ITERS,
                     head_size=512, pcg=True, flat_blocks=True,
                     rho_adapt_coefficient=RHO_ADAPT, dtype=torch.float32)
    row, bad = _loop_against_host("(e)", cfg, args)
    row["rho_eff"] = [[admm_math.rho_effective(
        r, i, rho_adapt_coefficient=RHO_ADAPT) for r in cfg.resolved_rhos()]
        for i in range(1, RHO_ITERS + 1)]
    print("coverage (e) " + json.dumps(row), flush=True)
    return row, bad


def coverage_solve_keys(args):
    """(f): the solve keys no other phase runs on the card, in one run():
    pcg = false (CG without the Jacobi preconditioner), relaxation 1.6
    and penalize.intercept = true (_loop_against_host)."""
    import torch
    from mlease_tpu_torch.train.admm import AdmmConfig

    cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=RHO_ITERS,
                     head_size=512, pcg=False, flat_blocks=True,
                     relaxation=1.6, penalize_intercept=True,
                     dtype=torch.float32)
    row, bad = _loop_against_host("(f)", cfg, args)
    print("coverage (f) " + json.dumps(row), flush=True)
    return row, bad


def coverage_phase(args):
    """Phase 24: see the module docstring."""
    import torch
    t_phase = time.monotonic()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 24)
    out, bad = {}, []
    for key, fn, a in (("a", coverage_lanes_bench, (args, gen)),
                       ("b", coverage_lanes_full, (args, gen)),
                       ("c", coverage_host_u, (args,)),
                       ("d", coverage_resume, (args,)),
                       ("e", coverage_rho, (args,)),
                       ("f", coverage_solve_keys, (args,))):
        t0 = time.monotonic()
        out[key], b = fn(*a)
        out[f"{key}_s"] = time.monotonic() - t0
        print(f"coverage ({key}) {out[f'{key}_s']:.1f} s", flush=True)
        bad += b
    out["k1_runs"] = sum(out[k]["k1_runs"] for k in "abcdef")
    out["s"] = time.monotonic() - t_phase
    print(f"coverage phase {out['s']:.1f} s, K1 runs {out['k1_runs']}",
          flush=True)
    if bad:
        raise AssertionError(f"coverage: {bad}")
    return out


def naive_rows(args):
    """--loops-only: phase 13's rows (write_scale_dataset, read and
    prepared as phase 13 does) and its in-process config."""
    import torch
    from mlease_tpu_torch.core.prepare import prepare_to_blocks
    from mlease_tpu_torch.core.vocab import build_vocab
    from mlease_tpu_torch.io import avro
    from mlease_tpu_torch.train.naive import NaiveConfig
    from mlease_tpu_torch.utils.config import JobConfig

    with tempfile.TemporaryDirectory(prefix="chip-smoke-naive-") as tmp:
        train = os.path.join(tmp, "part-00000.avro")
        write_scale_dataset(train, NAIVE_ROWS, args.seed + 1000)
        blocks = prepare_to_blocks(avro.read_records(train), 8, seed=0)
    base = dict(JobConfig.from_file(os.path.join(
        REPO, "examples", "data", "ctr-12m.job")))
    return {"keyed": {str(i): b for i, b in enumerate(blocks)},
            "vocab": build_vocab(r for b in blocks for r in b),
            "cfg": NaiveConfig(lambdas=NAIVE_LAMBDAS, liblinear_epsilon=float(
                base["liblinear.epsilon"]), compute_model_mean=True,
                dtype=torch.float32)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows-per-block", type=int, default=FULL_ROWS,
                    help="full-width rows per block (8 blocks; the default"
                         " is half of ctr-12m.job's 12.5M rows)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default="",
                    help="also write every phase's numbers to this JSON file")
    ap.add_argument("--gram-only", action="store_true",
                    help="build, run the K2 kernel phase alone and stop")
    ap.add_argument("--segsum-only", action="store_true",
                    help="build, set up the trainers, run the K1 kernel "
                         "phase and the lanes-minor phase (3, 20) and "
                         "stop")
    ap.add_argument("--streaming-only", action="store_true",
                    help="build, run the streaming and scale CLI phases "
                         "(11, 12) alone and stop")
    ap.add_argument("--modes-only", action="store_true",
                    help="build, set up the trainers, run the naive, "
                         "solver-mode and fit phases (13-15) alone and stop")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build, set up the trainers, run the mesh phase "
                         "(16) alone and stop")
    ap.add_argument("--fused-only", action="store_true",
                    help="build, set up the trainers, run the fused-loop "
                         "phases (17, 19) alone and stop")
    ap.add_argument("--loops-only", action="store_true",
                    help="build, set up the trainers, run the solve-loop "
                         "phases (21, 22, 23) alone and stop")
    ap.add_argument("--coverage-only", action="store_true",
                    help="build, set up the trainers, run phase 5's and "
                         "phase 24's CLI runs, then the card-paths phase "
                         "(24) alone and stop")
    ap.add_argument("--head-only", action="store_true",
                    help="build, run the bf16 head's kernel phase (25) "
                         "alone and stop")
    ap.add_argument("--bf16-only", action="store_true",
                    help="build, set up the trainers, make the float32 "
                         "runs phase 18 compares with, run phase 18 (the "
                         "bfloat16 compute dtype) and stop")
    # one rank of phase 16, started by the phase itself
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-init", default="", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-out", default="", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-data", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "mlease_tpu_torch", "csrc")):
        return fail("run from a checkout of the repository: "
                    "mlease_tpu_torch/ is missing beside chip_smoke.py")
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this smoke run "
                    "needs a CUDA device")
    sys.path.insert(0, REPO)
    if args.mesh_rank is not None:
        return _mesh_rank(args)
    from mlease_tpu_torch.device import resolve_device
    from mlease_tpu_torch.ops import (_build, device_loop, gram, head_pass,
                                      segment_sum)
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer

    report = {"phases": {}, "failed": []}
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    resolve_device("cuda")

    def phase(name, fn, *a):
        t0 = time.monotonic()
        try:
            out = fn(*a)
            report["phases"][name] = {
                "ok": True, "s": time.monotonic() - t0,
                "result": out if name != "setup" else None}
            return out
        except Exception:
            traceback.print_exc()
            report["phases"][name] = {"ok": False,
                                      "s": time.monotonic() - t0}
            report["failed"].append(name)
            return None

    def build():
        t0 = time.monotonic()
        paths = _build.build_many([segment_sum.SOURCE, *gram.SOURCES,
                                   device_loop.SOURCE, head_pass.SOURCE],
                                  verbose=True)
        row = {"libraries": [os.path.relpath(p, REPO) for p in paths],
               "build_s": time.monotonic() - t0}
        print("build " + json.dumps(row), flush=True)
        return row

    def setup():
        trainers = {}
        # bench.py's default step: 4 x 16,384 rows, 50K features, 15 nnz,
        # head 512; then ctr-12m.job's widths, 8 x --rows-per-block rows
        for tag, (nf, B, R, nnz, head) in (
                ("bench", (50_000, 4, 16_384, 15, 512)),
                ("full", (1_000_000, 8, args.rows_per_block, 12, 128))):
            t0 = time.monotonic()
            cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=args.iters,
                             head_size=head, pcg=True, flat_blocks=True,
                             dtype=torch.float32)
            trainers[tag] = tr = AdmmTrainer(
                synth_blocked_data(nf, B, R, nnz, args.seed),
                make_vocab(nf), cfg)
            torch.cuda.synchronize()
            print(f"{tag} setup: {B * R} rows, {tr.dim} columns, head {head},"
                  f" {tr.prob.tail_vals.numel()} tail entries, "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
        print(f"full-width rows: {8 * args.rows_per_block} (ctr-12m.job has "
              f"12.5M)", flush=True)
        return trainers

    def write_report():
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(dict(report, card=card), f, indent=1)

    trainers = None
    if not (args.gram_only or args.streaming_only or args.head_only):
        # the trainers' set-up launches no kernel: it runs while nvcc builds
        ahead("build", build)
        trainers = phase("setup", setup)
    phase("build", taken, "build", build)
    if report["failed"]:
        trainers = None

    if args.head_only:
        if not report["failed"]:
            phase("head_pass", head_pass_phase, args)
        write_report()
        print(card_line(), flush=True)
        return fail(f"failed phases: {report['failed']}") \
            if report["failed"] else 0

    if args.gram_only:
        if not report["failed"]:
            phase("kernel_gram", gram_phase, args)
        write_report()
        print(card_line(), flush=True)
        return fail(f"failed phases: {report['failed']}") \
            if report["failed"] else 0

    if args.streaming_only:
        if not report["failed"]:
            phase("streaming", streaming_phase, args)
            phase("scale_cli", scale_cli_phase, args)
        write_report()
        print(card_line(), flush=True)
        return fail(f"failed phases: {report['failed']}") \
            if report["failed"] else 0

    if args.segsum_only or args.modes_only or args.mesh_only \
            or args.fused_only or args.bf16_only or args.loops_only \
            or args.coverage_only:
        if trainers is not None and args.coverage_only:
            del trainers
            torch.cuda.empty_cache()
            phase("cli", cli_runs_phase, CLI_RUNS[:1])
            phase("coverage", coverage_phase, args)
        elif trainers is not None and args.loops_only:
            phase("loops", loops_phase, trainers, args)
            del trainers
            torch.cuda.empty_cache()
            phase("loops_stream", loops_stream_phase, args)
            phase("per_key_loops", per_key_loops_phase, args)
            phase("headless", headless_phase, args)
        elif trainers is not None and args.bf16_only:
            phase("bf16_baselines", bf16_baselines, trainers, args)
            phase("bf16_kernel", bf16_kernel_phase, trainers["full"], args)
            phase("bf16_full", bf16_full_phase, trainers["full"], args)
            phase("bf16_bench", bf16_bench_phase, trainers["bench"], args)
            del trainers
            torch.cuda.empty_cache()
            phase("bf16_item", bf16_item_phase, args)
            phase("bf16_stream", bf16_stream_phase, args)
            phase("bf16_cli", bf16_cli_phase, args)
        elif trainers is not None and args.segsum_only:
            phase("kernel", kernel_phase, trainers, args)
            phase("lanes_minor", lanes_minor_phase, trainers["full"], args)
        elif trainers is not None and args.fused_only:
            phase("fused", fused_phase, trainers, args)
            phase("fused_more", fused_more_phase, trainers, args)
        elif trainers is not None and args.mesh_only:
            phase("mesh_one_rank", mesh_one_rank_phase, trainers, args)
            del trainers
            torch.cuda.empty_cache()
            phase("mesh", mesh_phase, args)
        elif trainers is not None:
            phase("solver_modes", solver_modes_phase, trainers, args)
            del trainers
            torch.cuda.empty_cache()
            phase("naive", naive_phase, args)
            phase("fit", fit_phase, args)
        write_report()
        print(card_line(), flush=True)
        return fail(f"failed phases: {report['failed']}") \
            if report["failed"] else 0
    if trainers is not None:
        kernels = phase("kernel", kernel_phase, trainers, args)
        grams = phase("kernel_gram", gram_phase, args)
        heads = phase("head_pass", head_pass_phase, args)
        phase("cli", cli_runs_phase)
        full = phase("full_width", full_width_phase, trainers["full"], args)
        speed = phase("speed", speed_phase, trainers, args)
        phase("solver_modes", solver_modes_phase, trainers, args,
              speed["full"]["steady_iter_s"] if speed else None)
        phase("mesh_one_rank", mesh_one_rank_phase, trainers, args)
        phase("fused", fused_phase, trainers, args)
        phase("fused_more", fused_more_phase, trainers, args)
        phase("lanes_minor", lanes_minor_phase, trainers["full"], args)
        phase("loops", loops_phase, trainers, args)
        # phase 18, the bfloat16 compute dtype: (a)-(c) on the trainers'
        # data, (d)-(f) right after the float32 phases they compare with
        bf16_kernels = phase("bf16_kernel", bf16_kernel_phase,
                             trainers["full"], args)
        bf16_full = phase("bf16_full", bf16_full_phase, trainers["full"],
                          args)
        phase("bf16_bench", bf16_bench_phase, trainers["bench"], args)
        del trainers
        torch.cuda.empty_cache()
        items = phase("item", item_phase, args)
        phase("bf16_item", bf16_item_phase, args)
        phase("head_block", head_block_phase, args)
        LOOPS_STREAM["on"] = True    # phase 21's cells on 11's and 18's
        stream = phase("streaming", streaming_phase, args,
                       speed["full"]["steady_iter_s"] if speed else None)
        phase("bf16_stream", bf16_stream_phase, args)
        phase("loops_stream", loops_stream_phase, args)
        # phase 9's and 13's CLI runs go with phase 12's (no phase runs in
        # this process meanwhile)
        ahead("item_cli", item_cli_phase, args)
        ahead("naive_clis", naive_clis, args)
        phase("scale_cli", scale_cli_phase, args)
        phase("item_cli", taken, "item_cli", item_cli_phase, args)
        phase("naive", naive_phase, args)
        phase("per_key_loops", per_key_loops_phase, args)
        NAIVE_BASE.clear()
        phase("headless", headless_phase, args)
        coverage = phase("coverage", coverage_phase, args)
        phase("fit", fit_phase, args)
        phase("bf16_cli", bf16_cli_phase, args)
        phase("mesh", mesh_phase, args)
    write_report()
    if report["failed"]:
        return fail(f"failed phases: {report['failed']}")

    main_row = next(r for r in kernels
                    if r["shape"] == "full/xtv" and r["L"] == 3
                    and r["dtype"] == "float32")
    gram_row = next(r for r in grams
                    if (r["shape"], r["dtype"]) == ITEM_K2_ROW)
    head_row = next(r for r in heads if r["shape"] == "ctr12m/xtv_sqdiag")
    bf16_row = next(r for r in bf16_kernels
                    if r["shape"] == "full/xtv" and r["L"] == 3
                    and r["out_dtype"] == "float32")
    print(json.dumps({"kernels": [{
        "name": "segment_sum_gather", "route": "cuda",
        "source": "mlease_tpu_torch/csrc/segment_sum.cu",
        "replaces": "mlease_tpu/ops/pallas/tile_sum.py:72",
        "dtype": "float32",
        "launches": full["kernel_launches"],
        # phase 8's 10,000-item run: its bucket loops' runs of K1
        "item_launches": items["k1_runs"],
        # phase 24's runs on the paths only the CPU tests had run
        "coverage_launches": coverage["k1_runs"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}, {
        # K1's bf16 entry: launches from phase 18 (b)'s bfloat16 run
        "name": "segment_sum_gather_bf16", "route": "cuda",
        "source": "mlease_tpu_torch/csrc/segment_sum.cu",
        "replaces": "mlease_tpu/ops/pallas/tile_sum.py:72",
        "dtype": "bfloat16",
        "launches": bf16_full["kernel_launches"],
        "max_abs_err": bf16_row["max_abs_err"],
        "ms": bf16_row["kernel_ms"], "plain_ms": bf16_row["plain_ms"],
        "bound_ms": bf16_row["bound_ms"], "bound_by": bf16_row["bound_by"],
        "library_ms": bf16_row["library_ms"]}, {
        "name": "gram_batched", "route": "cuda",
        "source": "mlease_tpu_torch/csrc/gram.cu",
        "replaces": "mlease_tpu/ops/pallas/gram.py:77",
        "dtype": "float32",
        "launches": items["kernel_launches"],
        "max_abs_err": gram_row["max_abs_err"],
        "ms": gram_row["kernel_ms"], "plain_ms": gram_row["plain_ms"],
        "bound_ms": gram_row["bound_ms"], "bound_by": gram_row["bound_by"],
        "library_ms": gram_row["library_ms"]}, {
        # no TPU kernel: XLA fuses the head's widening into its products;
        # the 2L pass of ctr-12m's head, ms a block
        "name": "head_xtv", "route": "cuda",
        "source": "mlease_tpu_torch/csrc/head_pass.cu", "replaces": None,
        "dtype": "bfloat16 head, float32",
        # phase 11 (a)'s runs of the two kernels on the card (eager and
        # in the loops' graphs), and its head passes (the span store)
        "launches": stream["a_job_budget"]["head_kernels"]["runs"],
        "passes": stream["a_job_budget"]["head_kernels"]["passes"],
        "max_rel_err": head_row["max_rel_err"],
        "ms": head_row["kernel_ms"], "plain_ms": head_row["plain_ms"],
        "bound_ms": head_row["bound_ms"], "bound_by": "bytes",
        "library_ms": head_row["library_ms"]}]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
