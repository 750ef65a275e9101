#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/``), then at a realistic size (A: 32768 x 32768 float32, symmetric
PSD, made on the card from a seed; r = 512, l = 1025):

  1. draws      — the gen-Omega kernel against the plain torch Philox on the
                  card, bitwise, for every dense kind, at the wrap of the
                  uint32 row counter, and at the Psi shape the path uses;
  2. kernels    — sketch_fwd / sketch_t against their plain versions at
                  ragged shapes: float32 and bfloat16, with and without
                  ``acc``, nonzero offsets, ``scale``; sketch_t split over
                  K at the Nystrom C shape, sketch_fwd split over K at a
                  serving lane and on its narrow path (r = 8, K = 9216;
                  r = 13), A a view at an odd element: two runs must give
                  the same bits, and 37 rows alone the bits of the same
                  rows of the whole call;
  3. one-shot   — ``ops.nystrom_fused(A, seed=7, r=512)`` against the plain
                  version, and the Nystrom relative error;
  4. streaming  — ``StreamingSketch`` ingests A in eight 4096-row slabs: Y
                  must be phase 3's B bitwise; W against the plain version,
                  the one-pass reconstruction and the Nystrom pair;
  5. launches   — every kernel's launch count over phases 3-4 (reset just
                  before them) must be > 0; then each kernel is timed at the
                  main path's shape beside its plain version, the PyTorch
                  library call computing the same function, and its bound;
                  sketch_t at both of its shapes (the W update and the
                  Nystrom C) and sketch_fwd at the one-shot, with the
                  device time of each call's Omega draw, its product and
                  its split-K reduce apart; gen_omega's bound is its
                  integer work: the instructions of one normal entry in
                  its SASS (cuobjdump of the built library), by pipe, at
                  the SM clock nvidia-smi reads while it runs.

then the serving path, at the shape of one serving configuration (streams
of n1 = 16384, n2 = 8192, r = 128, l = 257, float32):

  6. fold       — the K4 kernel (fold_rows) against its plain version on the
                  card, bitwise: float32 and bfloat16, masked and unmasked,
                  1 and 64 lanes, c not a multiple of 4 (the one-element
                  path) and c = 128 (16-byte vectors), resident -0.0 rows,
                  NaN in d's dead rows, starts outside [0, m + k], more
                  lanes than one launch holds (one launch per 240 lanes
                  with a row to change) and a lane that is a view at an
                  odd element;
  7. lanes      — 8 streams: one ``update_ragged`` round (NaN pad rows) on
                  one service, the same slabs one by one through ``update``
                  on another; then one more round through
                  ``make_ingest_queue(bucket_edges="auto")`` on the edges
                  ``choose_bucket_edges`` prices for its heights; Y and W
                  must be equal bitwise;
  8. serving    — ``repro_torch.launch.serve.run_sketch`` (the launcher's
                  entry point): 128 streams, 4 updates each, heights
                  uniform in [1, 256], window 64, depth 256, the buckets
                  the planner prices for those heights (``expected_ks``;
                  its edges, pad waste and updates/s printed);
                  launches counted over this run alone must be > 0 for
                  fold_rows, sketch_fwd and sketch_t, and over its timed
                  window the queue must have needed no retry and
                  quarantined nothing, with one fold launch per lane batch
                  and one sketch_fwd and one sketch_t per update; then one
                  bucket's host cost (staging a one-row lane and one
                  ``fold_rows_block`` call: the H100 entry's
                  ``dispatch_overhead``) is timed, and
                  fold_rows at one bucket of it (64 lanes, kb =
                  256): the wrapper, its host stages, the kernel on the
                  device (warm, and with the L2 flushed), beside its plain
                  version, one ``torch._foreach_add_`` over the live
                  windows, the per-lane ``narrow().add_()`` loop and its
                  bound; sketch_fwd at
                  one lane (k = 1, 128, 256) beside its plain version,
                  ``torch.matmul(H, Omega)`` and its bound, and the run is
                  repeated once under torch.profiler for its device time
                  by kernel and the card's idle share of the timed window.

then the training path, at gemma2-2b's published size (m = 256000,
n = 2304 is its largest leaf, ``embed``; r = 8):

  9. gemm       — the K5 kernel (gemm_block) against its plain version at
                  the calls of the gradient exchange on the embed leaf —
                  (a) P̂ᵀ·M, skinny, split over K; (b) P̂·Qᵀ into f32 and,
                  as the training path makes it, into a bf16 tensor
                  through out=; (c) M − P̂·Qᵀ in place into M (alpha -1);
                  (b) and (c) on the thin path — within
                  min(16·sqrt(K)·2**-24, 1e-5) (f32) or 2**-12 (bf16), and
                  at ragged shapes on every path with alpha 0.5 (K = 1, 7,
                  16 and N = 2305 thin, K = 17 tiled, acc at an odd
                  element); each embed call timed beside its plain
                  version, ``torch.matmul`` / ``addmm`` (none for the bf16
                  (b): matmul + cast printed) and its bound, with the path
                  ``gemm_plan`` chose and its kernels' device time
                  (torch.profiler); sketch_fwd (its narrow path) timed at
                  the embed shape too;
 10. exchange   — ``compress_and_allreduce`` on an embed-shaped gradient
                  with a nonzero error buffer, kernels against the same
                  exchange written with the plain versions, both on the
                  card: g_hat and e' within min(16·sqrt(m)·2**-24, 1e-5);
 11. training   — ``make_dp_compressed_step`` driven by ``train_loop`` on
                  gemma2-2b at its published size (26 layers, bf16,
                  2.61e9 parameters, random weights from seed 0), the
                  plan priced for 8 workers (12 compressed leaves; at one
                  worker nothing compresses), the port's pipeline, batch
                  4 x seq 1024, 6 steps (the first a warm-up): every loss
                  finite, 36 gemm and 12 sketch_fwd launches each step
                  (counts reset just before the loop), error buffers
                  nonzero after step 1; prints the losses, the median step
                  time, tokens/s, the exchange's share of the step (CUDA
                  events around ``compress_and_allreduce``) and
                  ``torch.cuda.max_memory_allocated``; then one more
                  step under torch.profiler for the device time by kernel
                  and the card's idle share of the step.

then Alg. 1 (paper §4.2), with the card freed by the main process first:

 12. alg1       — four ranks spawned on cuda:0 over gloo (NCCL refuses two
                  ranks on one card; gloo takes the CUDA tensors and stages
                  them through host memory itself), each holding phases
                  1-5's A (checked equal across ranks by the sum of its
                  bits); r = 512, Omega seed 7: ``rand_matmul_auto`` (the
                  §4.3 grid at P = 4 is (4,1,1), regime 1), ``rand_matmul``
                  on (4,1,1), (2,2,1), (1,2,2) and (1,1,4), and
                  ``rand_matmul_communicating`` on (2,2,1).  Each rank
                  holds its B block to the same rows and columns of the
                  one-device B (``sketch_block`` on the card): bitwise
                  where p2 = p3 = 1, within f32_tol(n2/p2) otherwise; its
                  words received to ``alg1_bandwidth_words`` (to
                  ``alg1_communicating_cost`` for the baseline, which must
                  receive more); each run launches sketch_fwd once (the
                  baseline gen_omega once and sketch_fwd never), counts
                  reset just before it.  Then each rank times sketch_fwd at
                  its local shapes (K = n2/p2, cols = r/p3) and gen_omega
                  at its Omega rows, four ranks sharing the card, beside
                  their plain versions, ``torch.matmul`` and their bounds,
                  and prints each call's wall time (gloo through host
                  memory, not an interconnect time) and its peak memory.

then the 1-D Alg. 2 (paper §5.3), the same way:

 13. alg2       — four ranks spawned on cuda:0 over gloo (the
                  reduce-scatter and the all-to-all take CUDA tensors),
                  each holding phases 1-5's A; r = 512, Omega seed 7:
                  ``nystrom_auto`` (it must choose no_redist: n/r = 64 >
                  P = 4), ``nystrom_no_redist`` and ``nystrom_redist``.
                  Each rank holds B bitwise to the one-device B's rows
                  (No-Redist) or columns (Redist: the all-to-all is a
                  layout move), C within f32_tol(n) of the one-device
                  ``sketch_t_block(B, 7, 512)``'s rows or columns, its
                  words received exactly ((1 - 1/P)·r² = 196,608 and
                  (1 - 1/P)·n·r/P = 3,145,728, below the formula's n·r/P =
                  4,194,304: the gap is printed) and its launches (one
                  sketch_fwd, one sketch_t, no gen_omega a run); rank 0
                  gathers each variant's pair and its Nystrom relative
                  error must be <= 1e-4.  Then each rank times sketch_t at
                  its two second-stage shapes (8192x512 -> 512x512 at row
                  i·8192, 32768x128 -> 512x128) and sketch_fwd at its
                  first stage (8192x32768 -> 512), four ranks sharing the
                  card, beside their plain versions, ``torch.matmul`` and
                  their bounds, with sketch_t's splits, Omega scratch and
                  work bytes; rank 0 alone splits each sketch_t call's
                  device time into its draw, product and reduce.

then the two-grid Alg. 2 (paper §5.3 approach 1), the same way:

 14. two-grid   — four ranks spawned on cuda:0 over gloo (the Redistribute
                  of B is one uneven ``all_to_all_single`` of CUDA
                  tensors), each holding phases 1-5's A; Omega seed 7:
                  ``nystrom_auto(variant="bound_driven")`` at r = 512 (it
                  must pick ((4,1,1), (1,1,4)), and B and C must be
                  bitwise phase 13's ``nystrom_redist`` blocks),
                  ``nystrom_two_grid`` on (4,1,1) -> (1,2,2), (4,1,1) ->
                  (2,1,2) and (2,2,1) -> (4,1,1), ``nystrom_two_grid_fused``
                  on the first (bitwise ``nystrom_two_grid``),
                  ``nystrom_general`` on (2,2,1) with its axes permuted to
                  q = (1,2,2), ``nystrom_second_stage_two_grid_fused`` from
                  the one-device B's row blocks under salt 3, and
                  ``nystrom_auto(variant="bound_driven")`` at r = 2 (it
                  must pick the regime-2 pair ((4,1,1), (2,1,2)); the 1-D
                  variants must refuse).  Each rank holds B bitwise to the
                  one-device B's q-block where p = (4,1,1) (within
                  f32_tol(n) elsewhere), C within f32_tol(n) of the
                  one-device C's block, its words received exactly by kind
                  (the Redistribute: its q-block less what it held), one
                  sketch_fwd and one sketch_t a run (none of sketch_fwd for
                  the second stage alone) and no gen_omega; rank 0's
                  Nystrom error of the r = 512 pair must be <= 1e-4.  Then
                  each rank times the runs' collectives alone (the
                  Redistribute from (4,1,1) to three q-layouts, the q2
                  all-gather of (1,2,2), the p2 reduce-scatter of
                  (2,2,1)), and sketch_t at the new second-stage shapes
                  (32768x256 -> 256x256; 16384x256 -> 512x256 at row
                  i·16384; 16384x1 -> 2x1) and sketch_fwd on its narrow
                  path (8192x32768 -> 2) as phase 13 does.

then distributed streaming (the paper's Alg. 1 once per update), the same
way:

 15. stream-dist — four ranks spawned on cuda:0 over gloo (the co-range and
                  dY all-reduces take CUDA tensors), each holding phases
                  1-5's A; the stream is ``StreamConfig(n1 = n2 = 32768,
                  r = 512, l = 1025, seed 7)``: (a) ``ShardedStreamingSketch``
                  on (4,1,1) fed phase 4's eight 4096-row slabs out of
                  order through ``update_rows``: the Y block bitwise this
                  rank's ``rand_matmul`` block (itself bitwise the
                  one-device B's rows), W bitwise a one-device
                  ``StreamingSketch`` fed the same slabs, 0 words; (b) the
                  same slabs on (2,2,1) and (1,2,2): words received exactly
                  ``stream_update_cost(4096, ...).words`` a slab, the
                  gathered Y and W within f32_tol(n) of (a)'s, and on
                  (2,2,1) Y bitwise (c)'s; (c) ``update(A)`` once on
                  (2,2,1): the Y block bitwise ``rand_matmul``'s, words
                  Alg. 1's plus the co-range all-reduce; (d) the streamed
                  Nystrom from (a)'s Y, ``auto``, ``no_redist``, ``redist``
                  and ``bound_driven``: B bitwise the one-device B's block,
                  B and C bitwise the same second stage on the one-shot
                  blocks, words exactly the second stages'; (e) ``save`` on
                  (4,1,1), ``restore`` on (2,2,1), bitwise; (f)
                  ``make_sketch_service(grid=(4,1,1), max_resident=1)``
                  with two streams: eviction and restore bitwise, and
                  ``nystrom(sid, "redist")`` bitwise (d)'s.  Every rank
                  launches sketch_fwd, sketch_t and fold_rows (counts reset
                  just before each run); then each rank times the three
                  kernels at the phase's shapes (a (4,1,1) slab's dY, its W
                  update, the shard fold, held bitwise to its plain
                  version) beside their plain versions and one library
                  call each.

then sparse streaming on the one card (COO row slabs folded by S1):

 16. sparse     — ``StreamConfig(n1 = n2 = 32768, r = 512, l = 1025, seed
                  7)`` f32 streams of the kinds normal, countsketch and
                  rowsample, each fed eight 4096-row COO slabs (131072
                  distinct coordinates plus 8192 repeats, shuffled, from
                  numpy seed 0) in phase 15's order through
                  ``update_rows_sparse``: (a) Y and W after the first slab
                  (and for normal the second, onto a nonzero W) bitwise the
                  plain wave form run on the card over the same payload;
                  (b) after all eight, Y within f32_tol(n2) and W within
                  f32_tol(k) of the densified slabs through ``update_rows``;
                  (c) the normal stream fed again from zero, bitwise; (d) a
                  bfloat16 normal stream's first slab bitwise the plain
                  version; (e) 16 streams of phases 6-8's shape in two
                  batches of 8 lanes (normal, countsketch), one 256-row
                  slab a lane of nnz 1 to 65536: ``update_sparse_batch``
                  lane i bitwise ``update_sparse`` on a second service and
                  ``update_rows_sparse`` alone; (f) over (a)'s main path
                  exactly 2 sparse_fold launches an update, 2 gen_omega a
                  normal update, no sketch_fwd or sketch_t; (g) S1 at its
                  tile's edges (100 segments of 1025 elements, tiles with
                  no entry, untouched columns of touched tiles holding
                  -0.0 and NaN bits, a segment of 4096 entries and one of
                  65536), both forms, both axes, both ``from_zero``,
                  float32 and bfloat16, bitwise the plain wave form on the
                  card.  Then at one normal slab: S1's Y and W launches
                  (CUDA events), the wrapper with its CSR build, the plain
                  wave form, ``torch.sparse.mm`` of the slab with Omega
                  and of its transpose with Psi's rows, the
                  ``update_rows_sparse`` wall and its stages apart
                  (validate, the payload's copies, the draws, the CSR
                  build, S1; each ended by a synchronize), the densified
                  ``update_rows``, and S1's byte bound.

then the cost model (``repro_torch.plan``) against those runs:

 records        — one record per measured call, its ``plan.model`` cost
                  beside its seconds: phase 3's one-shot ``sketch_block``
                  (``local_cost``) and ``ops.nystrom_fused``
                  (``nystrom_local_cost``), phase 4's eight slabs
                  (``stream_update_cost``), phases 12-15's runs at the
                  slowest rank's wall (``alg1_cost``,
                  ``alg1_communicating_cost``, ``alg2_cost``,
                  ``alg2_fused_cost``, ``stream_update_cost`` a slab), phase
                  16's ``update_rows_sparse`` (``sparse_stream_update_cost``):
                  (a) a record's words are the words its phase counted, (b)
                  its local floor on the H100 entry is at most its seconds,
                  (c) ``save_sweep`` / ``load_sweep`` round-trip them to
                  ``build/repro_torch/cost_sweep.json``, (d)
                  ``calibrate_machine_model`` fits a finite, positive alpha
                  and byte_bw (printed beside the committed entry's, with
                  each record's predicted / measured seconds; nothing gates
                  on the ratio), (e) ``probe_machine()`` is the H100 entry
                  and ``device_kind_tag()`` the nvidia-smi name with
                  underscores;

and the planner (``plan_sketch``, ``plan_nystrom``, ``plan_stream``):

 17. plan       — (c) on the H100 entry: ``regime_sweep`` of the sketch at
                  A = 32768², r = 512 over P in ``PL_SWEEP``, the Nystrom
                  crossover and a sweep around it, and gemma2-2b's
                  gradient-exchange plan (rank 8, P = 8) under the seconds
                  objective beside the words one; (a) on one card at
                  phases 1-5's A (made again from seed 0): the three
                  one-card plans (the sketch, the Nystrom pair, eight
                  4096-row stream slabs), every executable candidate
                  executed (``dataclasses.replace`` of its variant) and
                  held bitwise to the direct call it names, the kernel
                  bodies and the stream's Y bitwise phase 3's B, each
                  timed (CUDA events, median of 3) beside its predicted
                  seconds, whether the model's pick was the fastest
                  (printed, not gating), and ``explain`` of each plan;
                  (b) on four ranks of the card over gloo (``_plan_rank``):
                  ``rand_matmul_auto(grid="plan")``,
                  ``nystrom_auto(variant="plan")``,
                  ``ShardedStreamingSketch(cfg, plan_stream(...))`` fed
                  phase 15's slab order and ``make_sketch_service(grid=
                  "auto")``'s one full update, each bitwise the same entry
                  point with the plan's grid or variant passed explicitly,
                  its words a rank those phases 12-15 count and at most the
                  plan's, and its slowest wall beside the plan's seconds;

and the measured autotuner (``autotune``):

 18. autotune   — (a) on one card: ``autotune`` of phase 17's three
                  one-card plans on a fresh cache under build/ (each
                  candidate timed with CUDA events, median of 3 after a
                  warm-up, on its own seeded synthetic A; printed beside
                  its predicted seconds, the analytic pick beside the
                  measured one), the tuned plan bitwise the direct call
                  of its variant on phases 1-5's A, a second ``autotune``
                  on a new cache object a pure hit (its timer raises), a
                  preset hit (the shipped ``PRESET_ENTRIES``, else this
                  run's entry) bitwise its direct call; the records
                  written to build/repro_torch/autotune_sweep.json;
                  (b) on four ranks of the card over gloo
                  (``_autotune_rank``): ``autotune`` of the P = 4 sketch
                  and Nystrom plans, each rank on a cache of its own: one
                  tuned plan on every rank, bitwise its explicit call with
                  phases 12-14's words, rank 0's file alone written, a
                  second call a hit; (c) the fit: ``mem_get_info`` beside
                  the largest candidate's bytes, and each kernel's shared
                  memory (``kernel_smem_bytes``) held to
                  ``cudaFuncGetAttributes`` and the H100 entry's
                  ``smem_bytes``;

and the communication ledger (``repro_torch.obs``):

 19. ledger     — (a) on one card under ``install_observability()``:
                  phase 17's three one-card ``Plan.execute`` calls (one
                  analytic ``plan.execute[...]`` record each, its
                  ``cache_key``, one call, a wall > 0), the service at
                  phases 6-8's stream shape (``update`` of one row slab,
                  ``update_batch`` of 8 lanes, ``update_ragged`` of 64
                  lanes) and ``update_sparse`` / ``update_sparse_batch``
                  with phase 16's ``StreamConfig`` and first COO slab:
                  each observed site 0 words at a 0 floor (bound fraction
                  1.0, drift 0.0), the sparse records ``2·nnz`` words;
                  the launches of the run (counts reset just before);
                  ``honesty_report`` with the H100 entry's ``byte_bw / 4``
                  words a second; then the ledger's hot-path cost:
                  ``update_ragged`` rounds (16 lanes of 64 rows at phase
                  8's width) with and without observability, interleaved,
                  the ratio of the minima printed (no gate); (b) on four
                  ranks of the card over gloo (``_obs_rank``):
                  ``ShardedStreamingSketch.update`` and ``update_rows`` of
                  one slab on (4,1,1), (2,2,1), (1,2,2), a grid service's
                  ``update`` on (2,2,1), ``nystrom_two_grid_fused`` on
                  ((4,1,1), (1,1,4)) and the P = 4 sketch and Nystrom
                  ``Plan.execute``: on every rank each measured site's
                  words equal the rank's ``COMM`` delta and the words
                  phases 12-15 count for the call, at drift 0; then a
                  stale decision (the P = 4 sketch's 0 predicted words
                  and its cache key, run on (2,2,1)) and
                  ``revalidate_autotune`` on a temporary cache holding
                  phase 18's keys: only the flagged key is popped, and a
                  second call pops nothing; (c) the phase under 90 s;

and the roofline (``repro_torch.roofline``):

 20. roofline   — every main path through ``analyze_call`` (a warm-up,
                  then one call under ``counting()``: the FLOPs, device
                  bytes and collective bytes the port counts), priced on
                  the card's rates (``h100_rates``), and timed: the median
                  of 5 CUDA-event runs after the warm-up, the L2 flushed
                  (a 256 MiB read) before each.  One card: (a) the
                  one-shot sketch at phases 1-5's A through ``cuda_fused``
                  (``ops.sketch_matmul``) and ``local_torch``
                  (``sketch_reference``), (b) ``nystrom_fused``, (c) one
                  4096-row stream slab, (d) one ``update_ragged`` round
                  of 64 lanes of 1-256 rows at phases 6-8's shape, (e)
                  ``update_rows_sparse`` of phase 16's first COO slab, (f)
                  one gemma2-2b step at 4 x 1024 (taken in phase 11, where
                  the model and state are held; model_flops 6·N·D on the
                  bf16 peak); four ranks over gloo (``_roofline_rank``,
                  ``chips=4``, the ranks' counts summed; median of 3,
                  the slowest rank's; the link priced at gloo's peak,
                  the fastest rate of any timed gather or reduce-scatter
                  of 64 MiB or more in the rows' calls or a probe's, on
                  any rank, since the H100 entry's fitted ``byte_bw`` is
                  no peak, and a probe's best alone was beaten by a
                  row's): (g) Alg. 1
                  on (4,1,1) and (1,2,2), (h) ``nystrom_two_grid_fused``
                  on ((4,1,1), (1,1,4)).
                  Each row prints its counts, terms, bottleneck and
                  ``t_bound``, its time and ``t_bound / measured`` (in
                  (0, 1.05]), ``model_flops``, ``useful_ratio``,
                  ``roofline_fraction`` and ``model_flops / (chips ·
                  peak_flops · measured)``; then ``format_table``.  (a)'s
                  counted FLOPs are 2·32768·32768·512 in both bodies; a
                  four-rank row's collective bytes are its ranks' ``COMM``
                  words x 4 summed, and ``plan.model``'s words x P x 4;
                  the phase, (f) included, under 60 s.

and recovery (``repro_torch.stream.elastic``, ``faults``, spill, WAL):

 21. recovery   — (a) on one card at phases 6-8's stream shape, under
                  build/repro_torch/recovery/: ``run_chaos_scenario``
                  kill-worker (32 streams, 4 updates each; WAL replay into
                  a fresh service bitwise the run that never crashed),
                  torn-write (``torn_steps == [2]``, ``latest_step == 1``,
                  step 1 restored bitwise) and eviction-storm (16 streams,
                  ``max_resident=1`` spilling to disk, bitwise); a
                  co-range stream evicted to disk and touched again, Y and
                  W bitwise, five times: the spill's write ms and MB/s,
                  the restore's ms, and the replay's records/s and
                  ``recover_s``; (b) on four ranks of the card over gloo
                  (``_recovery_rank``) at phase 15's stream (A = 32768²,
                  r = 512, l = 1025, co-range, seed 7, phase 15's slabs):
                  ``reshard_stream`` (4,1,1) -> (2,2,1) -> (1,2,2) ->
                  (2,1,1) -> (4,1,1) with a slab before each hop, Y and W
                  bitwise the same slabs on the same grids with the state
                  carried by gathers (the slabs on (2,2,1) and (1,2,2) sum
                  over p2, so the stream that never moved is within
                  f32_tol(n)), and (4,1,1) -> (2,1,1) -> (4,1,1) bitwise
                  the stream that never moved; on every rank each hop's
                  words = its ``COMM`` delta = ``rank_words`` = the ledger
                  site's, drift 0, and their maximum
                  ``stream_reshard_words``; a grid service's ``reshard``
                  (2,2,1) -> (4,1,1) holding one stream spilled to disk,
                  touched again bitwise; ``drain_reshard_resume`` (4,1,1)
                  -> (2,1,1) -> (4,1,1) through grid-mode queues of
                  different windows, bitwise the service never disturbed;
                  each hop's wall, its slowest rank and its MiB; (c)
                  ``python -m repro_torch.launch.serve --chaos all`` as a
                  subprocess, exit 0; (d) sketch_fwd, fold_rows and
                  sketch_t launched in (a) and on every rank of (b), the
                  phase under 120 s;

and data-parallel training across ranks (``repro_torch.launch.elastic``):

 22. dp-train   — (a) four ranks of the card over gloo (``_dp_train_rank``)
                  each hold a replica of gemma2-2b at its published widths
                  (d_model 2304, 8 heads, kv 4, head_dim 256, d_ff 9216,
                  vocab 256000, bf16) cut to 1 layer, with AdamW and the
                  error buffers of the plan priced for P = 4 at rank 8,
                  and take 3 sketched steps (the first a warm-up) and one
                  all-raw step through ``train_loop`` on a global batch of
                  4 x 1024 (1 x 1024 a rank): every loss finite, the
                  replicas' params bitwise equal after each step (bit
                  checksums gathered), each rank's ``COMM`` words the
                  plan's (``comm_words_compressed`` or ``comm_words_exact``,
                  and the loss's word), K2 and K5 launched on every rank
                  (counts reset just before), and one exchange on every
                  rank at a layer leaf's shape against the same exchange
                  written with the plain versions (within gemm_tol); the
                  exchange's words and CUDA-event ms, the step time,
                  tokens/s and ``max_memory_allocated`` per rank; (b) the
                  DP checkpoint at world 4 (free space checked first; GB
                  and seconds written), ``remesh`` onto 2 ranks (2-3 stand
                  by), ``elastic_restore`` into a zeroed state: params
                  bitwise what was saved, each buffer bitwise
                  ``reshard_error_fb`` of the saved stack; 1 step at world
                  2 on the same global batch, finite; the checkpoint
                  deleted; (c) ``python -m repro_torch.launch.train`` as 2
                  subprocess ranks on the card (``--grad-compress 4``),
                  both exit 0, rank 0's checkpoint holding both rank
                  files; the phase under 240 s.

and LM serving of the dense family (``repro_torch.serve.engine``):

 23. lm-serve   — gemma2-2b at its published size, no depth cut (26
                  layers, d_model 2304, 8 heads, kv 4, head_dim 256, d_ff
                  9216, vocab 256000, bf16; 2,614,341,888 params, random
                  weights from seed 0): (a) ``prefill`` of 4 x 1024
                  tokens with max_len 1280 and 64 greedy ``decode_step``s,
                  every logit finite; prefill ms and decode-step ms
                  (CUDA events), tokens/s, ``max_memory_allocated``, the
                  card's idle share over 8 profiled decode steps, and one
                  step's counted bytes and FLOPs (``analyze_call``)
                  beside the bytes it must move and its time; (b) a
                  4200-token prompt, past the 4096 window, so the even
                  layers' caches are rings: prefill with max_len 4224,
                  then 16 teacher-forced decode steps held against
                  ``lm_hidden`` plus the head (bf16 within
                  LM_RING_TOL_BF16; the same in float32 within
                  LM_RING_TOL, where every step with the rings rolled by
                  one slot must miss that limit); (c) ``python -m
                  repro_torch.launch.serve --workload lm --arch gemma2-2b
                  --full`` (6 requests, 4 slots, 16 new tokens, max_len
                  128) as a subprocess, exit 0, its tokens/s; the phase
                  under 120 s.  No kernel of the port runs here: the
                  reference computes attention and the LM's products
                  outside any Pallas kernel.

then MoE (``repro_torch.models.ffn`` ``moe``, the LM's MoE branch):

 24. moe        — granite-moe-1b-a400m at its published size, no depth
                  cut (24 layers, d_model 1024, 32 experts top-8, d_ff
                  512, vocab 49155, bf16; 1,334,628,352 params, random
                  weights from seed 0): (a) 6 steps of 4 x 1024 through
                  ``make_dp_compressed_step`` and ``train_loop``, the plan
                  priced for 8 workers at rank 8 (11 compressed leaves,
                  the f32 router among them): every loss finite, 11
                  sketch_fwd and 33 gemm launches a step (counts reset
                  just before), the median step, tokens/s, the exchange's
                  CUDA-event ms, peak memory; apart from the loop, the
                  exchange on the (786432, 512) expert stack with a bf16
                  gradient, the (24576, 32) f32 router and the (49155,
                  1024) embedding against ``_plain_exchange``, and
                  sketch_fwd and K5's calls (a)-(c) timed at each beside
                  their plain versions, ``torch.matmul`` and their bounds;
                  (b) phase 23 (a)'s prefill and decode at capacity factor
                  1.25, and the share of assignments dropped at prefill
                  (cap 1280) and decode (cap 1); (c) at capacity factor 8,
                  where nothing drops, 16 teacher-forced decode steps
                  after a 4 x 64 prefill against ``lm_hidden`` plus the
                  head: float32 within MOE_FWD_TOL, bf16 reported, with
                  the smallest top-8 margin seen; (d) one MoE layer in
                  bf16 on 4096 tokens in both dispatch forms: the einsum
                  form's one-hot dispatch carries exactly the scatter
                  form's kept assignments, outputs within
                  MOE_DISPATCH_TOL; (e) dbrx-132b at its published widths
                  on 8 of its 40 layers (27,305,809,920 params, 54.61 GB;
                  the whole model does not fit the card), built on the
                  card within 1.1 x its weights, prefill 4 x 1024 and 16
                  decode steps against the bytes a step must move; (f)
                  ``python -m repro_torch.launch.serve --workload lm
                  --arch granite-moe-1b-a400m --full`` as a subprocess,
                  exit 0; the phase under MOE_SECONDS.

then the SSM and hybrid families (``repro_torch.models`` ``ssm``,
``mamba_lm``, ``zamba``, ``attention.nystrom_attention``):

 25. ssm        — (a) falcon-mamba-7b at its published size, no cut (64
                  Mamba-1 layers, d_model 4096, d_inner 8192, ssm_state
                  16, dt_rank 256, vocab 65024, bf16; 7,272,665,088
                  params, random weights from seed 0), built on the card
                  within 1.1 x its weights; ``serve_prefill`` of 4 x 1024
                  (the last logits, no cache) timed, its device time split
                  by torch.profiler into the chunk scan's levels (inside
                  ``ssm.scan`` ranges), the products and the rest; a
                  16-token prompt replayed by decode into a batch-4 state,
                  64 greedy decode steps timed, 8 profiled (idle share,
                  device events), one step counted (``analyze_call``)
                  beside the bytes it must move (the weights, the states
                  read and written, the logits); (b) its decode against
                  the forward at published widths cut to 4 of 64 layers:
                  32 teacher-forced steps of 4 rows, float32 within
                  SSM_FWD_TOL, bf16 reported; (c) zamba2-1.2b at its
                  published size, no cut (38 Mamba-2 layers, d_model 2048,
                  d_inner 4096, 64 SSM heads, ssm_state 64, one shared
                  attention+FFN block applied 6 times, 32 heads, d_ff
                  8192, vocab 32000, bf16; 1,170,473,856 params) trained
                  as phase 24 (a): 6 steps of 4 x 1024 (1 warm-up),
                  AdamW, the rank-8 exchange priced for 8 workers, every
                  loss and gradient norm finite, sketch_fwd and gemm
                  launched on every compressed leaf every step, step 1's
                  largest masked decay exponent; the exchange at
                  blocks.mamba.in_proj (77824 x 8384) and shared.attn.wq
                  against ``_plain_exchange`` with its calls timed; (d)
                  zamba2-1.2b served as (a), its six shared KV caches at
                  max_len 1280, and its float32 decode against the forward
                  over the whole depth within SSM_FWD_TOL; (e) one 1 x
                  65536 prompt through ``serve_prefill``, which takes the
                  Nystrom branch: ``nystrom_attention`` called 6 times,
                  the logits finite; (f) ``python -m
                  repro_torch.launch.serve --workload lm --arch
                  zamba2-1.2b --full`` as a subprocess, exit 0; the phase
                  under SSM_SECONDS.

then the encoder-decoder and VLM families (``repro_torch.models``
``whisper``, the LM's projector):

 26. encdec-vlm — (a) whisper-tiny at its published size, no cut (4 + 4
                  layers, d_model 384, vocab 51865, enc_seq 1500;
                  62,205,312 params by ``count_params`` and
                  ``count_params_split``) through ``train_loop`` with the
                  exchange, 6 steps of 4 x 448 tokens and 4 x 1500 frames,
                  then the exchange at ``dec_pos`` (65536 x 384) and
                  ``embed`` against ``_plain_exchange`` and its kernels
                  timed there; (b) served: ``serve_prefill`` of 4 x 1500
                  frames into a self cache of 448, 64 greedy decode steps
                  timed, 8 profiled, one counted beside the bytes it must
                  move; its float32 decode against ``decode_hidden`` at
                  enc_seq 1024 within ED_FWD_TOL and at 1500 (the padded
                  keys) reported; (c) internvl2-26b at its published size
                  (48 layers, d_model 6144, vocab 92553, projector 3200 ->
                  6144; 19,880,927,232 params) built on the card,
                  ``serve_prefill`` of 4 x (256 patch embeddings + 1024
                  tokens), then the text path's prefill and 32 decode
                  steps as phase 23 (a); (d) internvl2-26b at its
                  published widths on 2 of 48 layers trained with the
                  patch embeddings in the batch, the exchange and its
                  kernels at ``projector.w`` and ``embed``; (e) the train
                  and serve launchers on whisper-tiny as subprocesses
                  (ED_TRAIN_LAUNCHER, ED_SERVE_LAUNCHER), exit 0; the
                  phase under ENCDEC_VLM_SECONDS.

It prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Any failure raises
and the exit code is non-zero; without a CUDA card it exits 1 and prints no
result.
"""
import contextlib
import dataclasses
import gc
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
N, R, SLAB, SEED = 32768, 512, 4096, 7
EPS32 = 2.0 ** -24
NYSTROM_RCOND = 1e-4
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/sketch_kernels.cu"
SKETCH_T_SOURCE = "src/repro_torch/kernels/csrc/sketch_t_kernels.cu"
FOLD_SOURCE = "src/repro_torch/kernels/csrc/fold_kernels.cu"
GEMM_SOURCE = "src/repro_torch/kernels/csrc/gemm_kernels.cu"
# the training path of phases 9-11: gemma2-2b's embed leaf, rank 8
T_M, T_N, T_R = 256000, 2304, 8
T_BATCH, T_SEQ, T_STEPS, T_PLAN_WORKERS = 4, 1024, 6, 8
# the serving configuration of phases 6-8
S_N1, S_N2, S_R, S_KMAX = 16384, 8192, 128, 256
# phase 12: Alg. 1 on four ranks of one card, at phase 1-5's A
ALG1_WORLD = 4
ALG1_GRIDS = [(4, 1, 1), (2, 2, 1), (1, 2, 2), (1, 1, 4)]   # auto: the first
ALG1_COMM_GRID = (2, 2, 1)
# phase 13: the 1-D Alg. 2 on four ranks of one card, at phase 1-5's A
ALG2_WORLD = 4
ALG2_VARIANTS = ("no_redist", "redist")
# phase 14: the two-grid Alg. 2 on four ranks of one card, at phase 1-5's A
TG_WORLD = 4
TG_R2 = 2                       # regime 2 (r < P): the 1-D variants refuse
TG_SALT = 3
TG_PAIRS = [((4, 1, 1), (1, 2, 2)), ((4, 1, 1), (2, 1, 2)),
            ((2, 2, 1), (4, 1, 1))]
TG_FUSED = ((4, 1, 1), (1, 2, 2))
TG_GENERAL = ((2, 2, 1), (2, 1, 0))      # q-axes (p3, p2, p1): q = (1, 2, 2)
# words each rank receives at n = 32768, P = 4, by (p, q, r): (the
# Redistribute's, all of them), worked out with the reference's functions
TG_WORDS = {((4, 1, 1), (1, 1, 4), 512): (3145728, 3145728),
            ((4, 1, 1), (1, 2, 2), 512): (3145728, 7340032),
            ((4, 1, 1), (2, 1, 2), 512): (2097152, 2162688),
            ((2, 2, 1), (4, 1, 1), 512): (0, 4390912),
            ((4, 1, 1), (2, 1, 2), 2): (8192, 8193)}
# phase 15: distributed streaming on four ranks of one card, at phase 1-5's A
SD_WORLD = 4
SD_ORDER = (3, 0, 6, 1, 5, 7, 2, 4)      # phase 4's eight slabs, out of order
SD_GRIDS = [(2, 2, 1), (1, 2, 2)]        # (b); (a) runs on (4, 1, 1)
SD_VARIANTS = ("auto", "no_redist", "redist", "bound_driven")
SD_SEEDS = (SEED, SEED + 1)              # (f)'s two streams
# phase 16: sparse streaming on one card, at phase 1-5's width
SP_KINDS = ("normal", "countsketch", "rowsample")
SP_DISTINCT, SP_REPEATS = 131072, 8192   # a slab's distinct coordinates,
                                         # then entries that repeat them
SP_LANE_NNZ = (1, 8, 64, 512, 2048, 8192, 32768, 65536)
SP_LANE_K = 256
SP_EDGE = (100, 1025)                    # (g): segments, elements
SP_EDGE_NNZ = (4096, 65536)              # (g): the long segment's entries
SP_STAGE_REPS = 20
SPARSE_SOURCE = "src/repro_torch/kernels/csrc/sparse_kernels.cu"
# phases 22-26 on each architecture's reduced config (``phase_config``):
# a CPU rehearsal, never on the card
REDUCED = False
# phase 22: data-parallel training on four ranks of one card (gemma2-2b at
# its published widths, depth cut: four replicas of 26 layers do not fit;
# cut to 1 layer and the fewest steps each check needs, for the script's
# clock: the vocabulary leaves, which the layer cut keeps, are most of the
# checkpoint)
DP_WORLD, DP_TO, DP_LAYERS = 4, 2, 1
DP_SKETCHED, DP_RAW, DP_AFTER = 3, 1, 1  # steps: sketched (the first a
                                         # warm-up), all-raw, after the resume
DP_DIR = ROOT / "build" / "repro_torch" / "dp_train"
DP_SECONDS = 240                         # the phase's time limit
DP_MIN_FREE = 25e9                       # bytes free for the checkpoint
DP_LAUNCHER = ["--arch", "gemma2-2b", "--steps", "12", "--batch", "4",
               "--seq", "32", "--grad-compress", "4", "--ckpt-every", "6"]
RANKS_TIMEOUT_S = 600
SWEEP_PATH = ROOT / "build" / "repro_torch" / "cost_sweep.json"
SERVE_ARGS = ["--workload", "sketch", "--streams", "128", "--updates", "4",
              "--n1", str(S_N1), "--n2", str(S_N2), "--r", str(S_R),
              "--max-rows", str(S_KMAX), "--window", "64", "--depth", "256"]
# phase 23: LM serving of gemma2-2b at its published size, no depth cut
LM_ARCH = "gemma2-2b"
LM_BATCH, LM_PROMPT, LM_MAX_LEN = 4, 1024, 1280          # (a)
LM_DECODE, LM_PROFILED = 64, 8           # (a): decode steps; profiled steps
LM_RING_PROMPT, LM_RING_MAX_LEN, LM_RING_STEPS = 4200, 4224, 16   # (b)
# (b)'s limits, relative Frobenius of the logits against the forward pass,
# set from two readings on an H100 (NVIDIA H100 80GB HBM3, 700 W): in
# bfloat16 decode missed the forward by 1.818e-2 (worst step 1.913e-2),
# since the forward stores its scores and probabilities in bf16 and decode
# keeps them in f32, while rings rolled by one slot missed by 2.492e-2
# (best step 1.926e-2): the two cannot be told apart there.  In float32
# decode missed by 2.545e-6 (worst step 2.639e-6) and the rolled rings by
# 1.662e-2 (best step 6.011e-3), so the float32 limit refuses every
# rolled step with a margin of 60 and passes decode with one of 38.
LM_RING_TOL_BF16 = 3e-2
LM_RING_TOL = 1e-4
LM_SECONDS = 120                         # the phase's time limit
LM_LAUNCHER = ["--workload", "lm", "--arch", LM_ARCH, "--full",
               "--requests", "6", "--slots", "4", "--max-new", "16",
               "--max-len", "128"]
# phase 24: MoE, granite-moe-1b-a400m at its published size (no depth cut)
# and dbrx-132b at its published widths on 8 of its 40 layers (its 263 GB
# do not fit one card's 80 GB; 8 layers hold 54.61 GB)
MOE_ARCH, MOE_BIG, MOE_BIG_LAYERS = "granite-moe-1b-a400m", "dbrx-132b", 8
MOE_STEPS = 6                            # (a): steps of T_BATCH x T_SEQ
# (a): the leaves whose exchange is held and timed: the tallest (an expert
# stack folded to 786432 x 512), the f32 router, the odd vocabulary
MOE_LEAVES = ("blocks.moe.w_gate", "blocks.moe.router", "embed")
MOE_DROP_STEPS = 8                       # (b): decode steps counted
MOE_FWD_PROMPT, MOE_FWD_STEPS = 64, 16   # (c)
MOE_FWD_TOL = LM_RING_TOL                # (c): float32, phase 23's limit
MOE_DISPATCH_N = 4096                    # (d): tokens
# (d): the einsum form against the scatter form in bf16.  Both feed the
# experts the same bf16 rows (a one-hot einsum moves a row exactly) and run
# the same three batched products on them; they differ in the combine,
# where the scatter form rounds each of a token's k gate x output products
# to bf16 (at most 2**-9 relative each) before its f32 sum, and the einsum
# form rounds once.  Where a token's k terms cancel, those roundings weigh
# more against the sum: one granite layer in bf16 on the CPU (1024 tokens)
# gave 2.65e-3 relative Frobenius.  2**-7 leaves a factor of three; one
# misrouted or dropped assignment among 4096 tokens moves the norm by about
# 4096**-0.5 = 1.6e-2.
MOE_DISPATCH_TOL = 2.0 ** -7
MOE_BIG_DECODE = 16                      # (e)
MOE_SECONDS = 300                        # the phase's time limit
MOE_LAUNCHER = ["--workload", "lm", "--arch", MOE_ARCH, "--full",
                "--requests", "6", "--slots", "4", "--max-new", "16",
                "--max-len", "128"]
# phase 25: the SSM and hybrid families at their published sizes:
# falcon-mamba-7b served only (its bf16 params and grads and f32 AdamW
# moments, 87.3 GB, do not fit one 80 GB card), cut to 4 of its 64 layers
# for (b) alone; zamba2-1.2b trained and served, no cut
SSM_ARCH, HY_ARCH = "falcon-mamba-7b", "zamba2-1.2b"
SSM_PARAMS = {SSM_ARCH: 7_272_665_088, HY_ARCH: 1_170_473_856}
SSM_REPLAY = 16                          # (a), (d): prompt tokens replayed
SSM_FWD_LAYERS, SSM_FWD_STEPS = 4, 32    # (b): falcon's depth cut; steps
SSM_FWD_TOL = LM_RING_TOL                # (b), (d): float32, phase 23's
SSM_STEPS = 6                            # (c): 1 warm-up and 5 timed
HY_COMPRESSED = 18                       # (c): all but the three norms
# (c): the exchange held and timed at the tallest leaf (38 Mamba-2
# in_proj folded to 77824 x 8384) and a shared 2-D leaf
HY_LEAVES = ("blocks.mamba.in_proj", "shared.attn.wq")
HY_LONG = 65536                          # (e): one prompt, the Nystrom side
SSM_SECONDS = 240                        # the phase's time limit
HY_LAUNCHER = ["--workload", "lm", "--arch", HY_ARCH, "--full",
               "--requests", "6", "--slots", "4", "--max-new", "16",
               "--max-len", "128"]
# phase 26: the encoder-decoder and VLM families.  whisper-tiny trained
# and served at its published size (no cut); internvl2-26b served at its
# published size, and trained at its published widths cut to 2 of its 48
# layers (the bf16 params and grads and f32 AdamW moments of 19.9B
# parameters, about 240 GB, do not fit one 80 GB card)
ED_ARCH, VLM_ARCH = "whisper-tiny", "internvl2-26b"
ED_PARAMS = {ED_ARCH: 62_205_312, VLM_ARCH: 19_880_927_232}
VLM_TRAIN_PARAMS = 1_937_129_472         # (d): 2 of 48 layers
ED_COMPRESSED = {ED_ARCH: 19, VLM_ARCH: 10}   # (a), (d): the plan's leaves
ED_STEPS, ED_BATCH, ED_SEQ = 6, 4, 448   # (a): Whisper's decoder context
ED_DECODE, ED_MAX_LEN = 64, 448          # (b): decode steps; self cache
ED_FWD_STEPS = 32                        # (b): teacher-forced steps
ED_CONTROL_ENC = 1024                    # (b): enc_seq without padded keys
ED_FWD_TOL = SSM_FWD_TOL                 # (b): float32, phase 23's limit
VLM_DECODE = 32                          # (c): after LM_PROMPT text tokens
VLM_MIN_FREE = 60e9                      # (c): bytes free before the build
VLM_TRAIN_LAYERS, VLM_TRAIN_SEQ = 2, 1024     # (d): 256 patches + 768 text
ED_LEAVES = ("dec_pos", "embed")         # (a): the exchange held and timed
VLM_LEAVES = ("projector.w", "embed")    # (d): the exchange held and timed
ENCDEC_VLM_SECONDS = 240                 # the phase's time limit
# (e): the train launcher stops with "loss did not decrease" unless the
# mean loss of its last 10 steps is below that of its first 10, so 2
# steps (the same losses on both sides) cannot pass.  At the published
# size whisper-tiny's loss barely moves on the pipeline's data (each
# step's 51865-way transitions are new, the frames fresh noise): PERF.md
# section 6 has both means, read on an H100, for 2 to 200 steps.  The
# reduced config (vocabulary 256) learns the transitions: 100 steps at lr
# 3e-3, the recipe of tests/test_torch_whisper.py and README.md, lowered
# the mean by 0.04-0.20 for seeds 0-3 on the CPU.  So the launcher
# trains that config.
ED_TRAIN_LAUNCHER = ["--arch", ED_ARCH, "--grad-compress", "8",
                     "--steps", "100", "--batch", "4", "--seq", "16",
                     "--lr", "3e-3", "--ckpt-every", "0",
                     "--ckpt-dir", "build/repro_torch/ed_train_ckpt"]
ED_SERVE_LAUNCHER = ["--workload", "lm", "--arch", ED_ARCH, "--full",
                     "--requests", "6", "--slots", "4", "--max-new", "16",
                     "--max-len", "128"]


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def phase_config(arch: str, **changes):
    """``arch``'s config, reduced where REDUCED, with ``changes``."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg.reduced() if REDUCED else cfg, **changes)


def f32_tol(K: int) -> float:
    """Relative Frobenius tolerance of an f32 sum of K terms taken in two
    orders (the kernel's fixed k loop vs the library GEMM's blocking)."""
    return 16 * math.sqrt(K) * EPS32


# The K5 calls and the exchange of phases 9-10 are held to no more than
# 1e-5 relative Frobenius whatever K: their readings on an H100 were
# 1.3e-6 (call (a), K = 256000), 1.1e-6 (K = 100003) and 2.8e-7 (the
# exchange's g_hat), while a product with TF32 inputs (10-bit mantissas,
# about 2**-11 relative rounding each) misses by about 3e-4, which
# f32_tol(256000) = 4.8e-4 would let through.
GEMM_TOL_CAP = 1e-5


def gemm_tol(K: int) -> float:
    return min(f32_tol(K), GEMM_TOL_CAP)


# Both sides round an f32 sum to bfloat16, so an element differs by one bf16
# ulp only where the two sums straddle a rounding boundary: rare, and well
# under 2**-12 relative Frobenius.  Rounding Omega itself to bfloat16 would
# give about 2**-9 / sqrt(3) ~ 1e-3, which this limit refuses.
BF16_TOL = 2.0 ** -12


def rel_fro(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.float(), ref.float()
    return float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))


def max_abs(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref.float()).abs().max())


def time_ms(fn, reps: int = 5, inner: int = 1, before=None,
            warm: bool = True) -> float:
    """Median of ``reps`` CUDA-event timings (each of ``inner`` calls,
    divided by ``inner``) after one warm-up call (none when ``warm`` is
    False: the caller has made one), each after ``before()`` (outside the
    events) when given."""
    if warm:
        fn()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, kernel: str, calls: int = 20, before=None):
    """Device time of one launch of the CUDA kernel whose name contains
    ``kernel``, from a torch.profiler trace of ``calls`` calls of ``fn``
    (a host-bound wrapper's CUDA-event time is its host overhead, not its
    kernel's time), each after ``before()`` if given; None when the trace
    holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in evs)
    if not count:
        return None
    return sum(e.device_time_total for e in evs) / 1e3 / count


def bound_ms(flops: float, nbytes: float):
    """(ms, what binds): FLOPs at the card's f32 peak or bytes at its
    device-memory rate, whichever is longer (``repro_torch.roofline``'s
    rates)."""
    from repro_torch.roofline import h100_rates
    rates = h100_rates()
    t_ops = flops / rates.peak("float32") * 1e3
    t_bytes = nbytes / rates.hbm_bw * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# The SASS of gen_omega_kernel (K8), read with cuobjdump from the built
# library, gives its bound by integer work.  Each instruction of one normal
# entry's path through the kernel's grid-stride loop (the loop with the most
# IMAD.WIDE: three Philox calls; the 64-bit e / cols takes its 32-bit path
# while rows x cols < 2**32, so the slow path that CALLs the 64-bit division
# is left out) goes to a pipe of an H100 SM, in lanes per clock per SM: the
# integer ALU 64 (LOP3, IADD3, LEA, SHF, ISETP, MOV, I2FP, ...), the FMA
# pipe's heavy half 64 (IMAD*, IMUL, and VIADD, taken as an IMAD.IADD),
# both FMA halves 128 (with FMUL/FADD/FFMA), the XU 16 (MUFU, I2F, F2I),
# the LSU 32 (STG), and issue 128 (one warp instruction a clock in each of
# 4 schedulers).  Each pipe at its full rate, all overlapped: an entry
# takes max(count / rate) clocks of one SM's lane, and the kernel at least
# entries x that / (132 SMs x the SM clock under load).
SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s*(@!?U?P[T0-9]+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)\s*([^;]*);")
PIPE_RATES = {"alu": 64, "fma_heavy": 64, "fma": 128, "xu": 16, "lsu": 32,
              "issue": 128}
H100_SMS = 132


def sass_pipe(op: str) -> str:
    if op.startswith(("IMAD", "IMUL", "VIADD")):
        return "fma_heavy"
    if op.startswith(("FMUL", "FADD", "FFMA", "HFMA2", "HADD2", "HMUL2")):
        return "fp32"
    if op.startswith(("MUFU", "I2F.", "F2I", "F2F.", "POPC", "FLO", "BREV")):
        return "xu"
    if op.startswith(("STG", "LDG", "LDS", "STS", "ATOM", "RED")):
        return "lsu"
    if op.startswith(("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "NOP",
                      "BAR", "U")):
        return "other"
    return "alu"


def omega_entry_sass(lib_path) -> dict:
    """Instructions of one normal entry of gen_omega_kernel, by pipe, from
    ``cuobjdump -sass`` of the built library."""
    from repro_torch.kernels import _build
    cuobjdump = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
    return count_entry_sass(subprocess.run(
        [str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
        text=True, timeout=600, check=True).stdout)


def count_entry_sass(text: str) -> dict:
    fn = re.search(r"Function : \S*gen_omega_kernel\S*\n(.*?)"
                   r"(?=\n\s*Function :|\Z)", text, re.S)
    check(fn is not None, "gen_omega_kernel not found in the SASS")
    ins = [(int(x.group(1), 16), x.group(2) or "", x.group(3), x.group(4))
           for x in map(SASS_LINE.match, fn.group(1).splitlines()) if x]

    def target(ops):
        t = re.search(r"0x([0-9a-f]+)", ops)
        return int(t.group(1), 16) if t else None
    loops = [(target(o), a) for a, _, op, o in ins
             if op == "BRA" and target(o) is not None and target(o) < a]
    check(bool(loops), "gen_omega_kernel has no loop in its SASS")
    lo, hi = max(loops, key=lambda lh: sum(
        op.startswith("IMAD.WIDE") for a, _, op, _ in ins
        if lh[0] <= a <= lh[1]))
    body = [x for x in ins if lo <= x[0] <= hi]
    skip = set()
    for a, pred, op, o in body:
        t = target(o)
        if op == "BRA" and pred and t is not None and a < t <= hi:
            region = [x for x in body if a < x[0] < t]
            if any(x[2].startswith("CALL") for x in region):
                skip |= {x[0] for x in region}
    path = [x[2] for x in body if x[0] not in skip]
    count = {pipe: 0 for pipe in ("alu", "fma_heavy", "fp32", "xu", "lsu",
                                  "other")}
    for op in path:
        count[sass_pipe(op)] += 1
    count["issue"] = len(path)
    count["fma"] = count["fma_heavy"] + count["fp32"]
    count["imad_wide"] = sum(op.startswith("IMAD.WIDE") for op in path)
    return count


def sm_clock_mhz(fn, ms: float, seconds: float = 2.0) -> float:
    """The SM clock (nvidia-smi clocks.sm, median of 3 reads) while the card
    runs about ``seconds`` of back-to-back calls of ``fn`` (``ms`` each)."""
    for _ in range(max(1, int(seconds / (ms * 1e-3)))):
        fn()
    reads = []
    for _ in range(3):
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60,
                             check=True)
        reads.append(float(out.stdout.strip().splitlines()[0]))
    torch.cuda.synchronize()
    return statistics.median(reads)


def omega_ops_bound_ms(count: dict, entries: int, mhz: float):
    """(bound ms, clocks an entry takes of one SM lane, binding pipe)."""
    pipe = max(PIPE_RATES, key=lambda p: count[p] / PIPE_RATES[p])
    clocks = count[pipe] / PIPE_RATES[pipe]
    return entries * clocks / (H100_SMS * mhz * 1e6) * 1e3, clocks, pipe


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_matrix(dev) -> torch.Tensor:
    """Symmetric PSD A = G·G^T (rank 64) + 1e-4 symmetric noise, from a
    seeded generator on the card."""
    g = torch.Generator(device=dev).manual_seed(0)
    G = torch.randn(N, 64, generator=g, device=dev)
    A = G @ G.T
    E = torch.randn(N, N, generator=g, device=dev)
    A.add_(E, alpha=0.5e-4).add_(E.T, alpha=0.5e-4)
    del E
    return A


def phase_draws(dev, gen_omega_cuda, kinds, plain_tile, L):
    k0, k1 = SEED & 0xFFFFFFFF, SEED >> 32
    cases = [(kind, 0, 0, N, R, 0) for kind in kinds]
    cases += [("normal", 2 ** 32 - 1000, 7, SLAB, R, 0),     # row wrap
              ("uniform", 2 ** 32 - 3, 2 ** 32 - 5, 64, 64, 5),
              ("normal", 0, 0, N, L, 1)]                      # the Psi tile
    worst = 0.0
    for kind, row0, col0, rows, cols, salt in cases:
        got = gen_omega_cuda(k0, k1, row0, col0, rows, cols, kind, salt,
                             device=dev)
        ref = plain_tile(k0, k1, row0, col0, rows, cols, kind, salt, None,
                         None, dev)
        same = torch.equal(got.view(torch.int32), ref.view(torch.int32))
        print(f"[draws] {kind:10s} ({rows}x{cols}) at ({row0}, {col0}) "
              f"salt {salt}: bitwise={same}")
        check(same, f"gen_omega differs from the plain Philox ({kind})")
        worst = max(worst, max_abs(got, ref))
    return worst


def phase_kernels(dev, local):
    g = torch.Generator(device=dev).manual_seed(1)
    cases = [  # (kind, dtype, use_acc, scale, row0, col0)
        ("normal", torch.float32, False, None, 0, 0),
        ("uniform", torch.float32, True, 0.5, 123457, 17),
        ("rademacher", torch.bfloat16, False, -2.0, 2 ** 32 - 300, 5),
        ("normal", torch.bfloat16, True, None, 99, 2 ** 31),
    ]
    m, K, cols = 1000, 777, 333                       # ragged vs the tiles
    for fn, plain in ((local.sketch_block, local._sketch_block_torch),
                      (local.sketch_t_block, local._sketch_t_block_torch)):
        for kind, dt, use_acc, scale, row0, col0 in cases:
            X = torch.randn(m, K, generator=g, device=dev).to(dt)
            shape = (m, cols) if fn is local.sketch_block else (cols, K)
            acc = (torch.randn(*shape, generator=g, device=dev).to(dt)
                   if use_acc else None)
            kw = dict(row0=row0, col0=col0, kind=kind, salt=3, scale=scale)
            ref = plain(X, SEED, cols, acc=acc, **kw)
            got = fn(X, SEED, cols,
                     acc=None if acc is None else acc.clone(), **kw)
            torch.cuda.synchronize()
            contraction = K if fn is local.sketch_block else m
            tol = f32_tol(contraction) if dt == torch.float32 else BF16_TOL
            err = rel_fro(got, ref)
            print(f"[kernels] {fn.__name__:14s} {kind:10s} {str(dt):14s} "
                  f"acc={use_acc!s:5s} scale={scale}: rel_fro={err:.3e} "
                  f"(tol {tol:.1e})")
            check(got.dtype == dt and tuple(got.shape) == shape,
                  f"{fn.__name__}: wrong output {got.dtype} {got.shape}")
            check(err <= tol, f"{fn.__name__} disagrees with its plain "
                              f"version: {err:.3e} > {tol:.1e}")
    # sketch_t at the Nystrom C shape (B (N, R) -> C (R, R)) is split over
    # K; the partial sums are added in a fixed order, so two runs agree
    from repro_torch.kernels.sketch_matmul import sketch_t_splits
    splits = sketch_t_splits(R, R, N)
    check(splits > 1, f"sketch_t does not split at the C shape ({splits})")
    for dt, use_acc in ((torch.float32, False), (torch.bfloat16, True)):
        X = torch.randn(N, R, generator=g, device=dev).to(dt)
        acc = (torch.randn(R, R, generator=g, device=dev).to(dt)
               if use_acc else None)
        kw = dict(row0=2 ** 32 - 300, col0=2 ** 31, kind="normal", salt=4)
        ref = local._sketch_t_block_torch(X, SEED, R, acc=acc, **kw)
        runs = [local.sketch_t_block(
            X, SEED, R, acc=None if acc is None else acc.clone(), **kw)
            for _ in range(2)]
        torch.cuda.synchronize()
        tol = f32_tol(N) if dt == torch.float32 else BF16_TOL
        err = rel_fro(runs[0], ref)
        same = torch.equal(_bits(runs[0]), _bits(runs[1]))
        print(f"[kernels] sketch_t_block  split {splits} x {N // splits} "
              f"rows ({N}x{R} -> {R}x{R}) {str(dt):14s} acc={use_acc!s:5s}: "
              f"rel_fro={err:.3e} (tol {tol:.1e}); two runs bitwise={same}")
        check(err <= tol, f"split sketch_t disagrees with its plain "
                          f"version: {err:.3e} > {tol:.1e}")
        check(same, "two runs of the split sketch_t differ")
    # sketch_fwd at a serving lane (K split 16 ways, A a view at an odd
    # element) and on the narrow path (r = 8, K longer than one
    # shared-memory chunk); two runs agree, and the first rows computed
    # alone have the bits of the same rows of the whole call
    from repro_torch.kernels.sketch_matmul import sketch_fwd_plan
    for m, K, n, dt, use_acc, want in (
            (S_KMAX, S_N2, S_R, torch.float32, False, ("wide", 16)),
            (S_KMAX, S_N2, S_R, torch.bfloat16, True, ("wide", 16)),
            (20000, 9216, T_R, torch.float32, True, ("narrow", 1)),
            (3001, 5000, 13, torch.bfloat16, False, ("narrow", 1))):
        plan = sketch_fwd_plan(m, n, K)
        check((plan["path"], plan["splits"]) == want,
              f"sketch_fwd plan at ({m}, {K}) -> {n}: {plan}")
        buf = torch.randn(m * K + 1, generator=g, device=dev).to(dt)
        X = buf[1:].view(m, K)
        acc = (torch.randn(m, n, generator=g, device=dev).to(dt)
               if use_acc else None)
        kw = dict(row0=2 ** 32 - 300, col0=7, kind="normal", salt=4)
        ref = local._sketch_block_torch(X, SEED, n, acc=acc, **kw)
        runs = [local.sketch_block(
            X, SEED, n, acc=None if acc is None else acc.clone(), **kw)
            for _ in range(2)]
        head = local.sketch_block(
            X[:37], SEED, n, acc=None if acc is None else acc[:37].clone(),
            **kw)
        torch.cuda.synchronize()
        tol = f32_tol(K) if dt == torch.float32 else BF16_TOL
        err = rel_fro(runs[0], ref)
        same = torch.equal(_bits(runs[0]), _bits(runs[1]))
        rows = torch.equal(_bits(head), _bits(runs[0][:37]))
        print(f"[kernels] sketch_block    {plan['path']} x{plan['splits']} "
              f"({m}x{K} -> {m}x{n}, A at an odd element) {str(dt):14s} "
              f"acc={use_acc!s:5s}: rel_fro={err:.3e} (tol {tol:.1e}); two "
              f"runs bitwise={same}; 37 rows alone bitwise={rows}")
        check(err <= tol, f"sketch_fwd ({plan['path']}, {plan['splits']} "
                          f"splits) disagrees with its plain version: "
                          f"{err:.3e} > {tol:.1e}")
        check(same, "two runs of sketch_fwd differ")
        check(rows, "sketch_fwd rows depend on m")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def kernel_parts(fn, gemm: str) -> dict:
    """Device time of one sketch_fwd or sketch_t call's draw, product
    (``gemm``: the kernel's name) and split-K reduce kernels
    (torch.profiler; None where the call has no such kernel)."""
    return {part: device_ms(fn, name) for part, name in (
        ("draw", "omega_slab_draw_kernel"), ("gemm", gemm),
        ("reduce", "split_reduce_kernel"))}


def parts_text(parts: dict) -> str:
    return ", ".join(f"{part} " + ("none" if t is None else f"{t:.4f} ms")
                     for part, t in parts.items())


def phase_fold(dev, fold_rows_block, plain_fold, LAUNCHES, capacity):
    """Phase 6: the fold kernel against its plain version, bitwise."""
    g = torch.Generator(device=dev).manual_seed(6)
    worst = 0.0
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (lanes, m, k, c, y dtype, d dtype, masked, odd lane)
        (1, S_N1, S_KMAX, S_R, f32, f32, True, False),
        (64, S_N1, S_KMAX, S_R, f32, f32, True, False),
        (64, S_N1, S_KMAX, S_R, bf16, f32, True, False),
        (64, 2000, 77, 45, bf16, bf16, True, False),
        (1, 2000, 77, 45, f32, bf16, False, False),
        (64, 2000, 77, 45, f32, f32, False, False),
        (64, 1000, 200, 100, bf16, f32, False, False),
        # more lanes than one launch's parameter block holds
        (2 * capacity + 3, 1000, 77, S_R, f32, f32, True, False),
        (capacity + 1, 300, 40, 100, bf16, f32, False, False),
        # lane 5 a view at an odd element: the one-element path
        (64, S_N1, S_KMAX, S_R, f32, f32, True, True),
    ]
    for lanes, m, k, c, ydt, ddt, masked, odd in cases:
        y = torch.randn(lanes, m, c, generator=g, device=dev).to(ydt)
        y[:, ::3] = -0.0                          # resident -0.0 rows
        d = torch.randn(lanes, k, c, generator=g, device=dev).to(ddt)
        gen = torch.Generator().manual_seed(lanes * m + c)
        starts = torch.randint(-k, m + 2 * k, (lanes,), generator=gen)
        starts[0] = m + k + 999                   # outside [0, m + k]
        if lanes > 1:
            starts[1] = -5
        starts = starts.tolist()
        nvalid = None
        if masked:
            nvalid = torch.randint(0, k + 1, (lanes,), generator=gen).tolist()
            for i, nv in enumerate(nvalid):
                d[i, nv:] = float("nan")          # never read
        want = plain_fold(y, d, starts, nvalid)
        ys = [y[i].clone() for i in range(lanes)]
        if odd:
            buf = torch.empty(m * c + 1, dtype=ydt, device=dev)
            ys[5] = buf[1:].view(m, c)
            ys[5].copy_(y[5])
        # one launch per `capacity` lanes that holds a row to change
        launches = sum(1 for a in range(0, lanes, capacity)
                       if nvalid is None or max(nvalid[a:a + capacity]) > 0)
        before = LAUNCHES["fold_rows"]
        fold_rows_block(ys, d, starts, nvalid)
        torch.cuda.synchronize()
        got = torch.stack(ys)
        same = torch.equal(_bits(got), _bits(want))
        print(f"[fold] lanes={lanes:3d} y=({m}x{c}) {str(ydt):14s} "
              f"d=({k}x{c}) {str(ddt):14s} masked={masked!s:5s}"
              + (" (lane 5 at an odd element)" if odd else "")
              + f": {LAUNCHES['fold_rows'] - before} launch(es), "
              f"bitwise={same}")
        check(LAUNCHES["fold_rows"] == before + launches,
              f"fold_rows_block launched {LAUNCHES['fold_rows'] - before} "
              f"times for {launches} lane groups")
        check(same, "fold_rows differs from its plain version")
        worst = max(worst, max_abs(got, want))
    return worst


def phase_lanes(dev, SketchService, StreamConfig, make_ingest_queue):
    """Phase 7: one ragged round == the same slabs applied one by one; then
    a round through the queue on the edges ``bucket_edges="auto"``
    prices."""
    rng = np.random.default_rng(7)
    cfgs = [StreamConfig(S_N1, S_N2, r=S_R, seed=700 + i) for i in range(8)]
    svc, solo = SketchService(), SketchService()
    sids = [svc.open(c) for c in cfgs]
    rids = [solo.open(c) for c in cfgs]
    items = []
    for i in range(8):
        k = int(rng.integers(1, S_KMAX + 1))
        items.append((i, rng.standard_normal((k, S_N2), dtype=np.float32),
                      int(rng.integers(0, S_N1 - k + 1))))
    svc.update_ragged([(sids[i], H, row0) for i, H, row0 in items],
                      pad_value=float("nan"))
    for i, H, row0 in items:
        solo.update(rids[i], H, row0=row0)
    torch.cuda.synchronize()
    for sid, rid in zip(sids, rids):
        for got, want in ((svc.sketch(sid), solo.sketch(rid)),
                          (svc.corange(sid), solo.corange(rid))):
            check(torch.isfinite(got).all().item(), "non-finite lane state")
            check(torch.equal(_bits(got), _bits(want)),
                  "a ragged lane differs from its solo update")
    print(f"[lanes] 8 streams ({S_N1}x{S_N2}, r={S_R}, l={cfgs[0].sketch_l}) "
          f"heights {[H.shape[0] for _, H, _ in items]}: ragged round == "
          f"solo updates, Y and W bitwise")
    # one more round through the queue, on the edges "auto" prices for
    # these heights on this card's machine entry
    items = []
    for i in range(8):
        k = int(rng.integers(1, S_KMAX + 1))
        items.append((i, rng.standard_normal((k, S_N2), dtype=np.float32),
                      int(rng.integers(0, S_N1 - k + 1))))
    q = make_ingest_queue(svc, expected_ks=[H.shape[0] for _, H, _ in items])
    check(q.bucket_edges is not None, '"auto" gave no bucket edges')
    batches = svc.stats()["lane_batches"]
    for i, H, row0 in items:
        q.submit(sids[i], H, row0)
    q.flush(raise_errors=True)
    st = q.stats()
    q.shutdown()
    for i, H, row0 in items:
        solo.update(rids[i], H, row0=row0)
    torch.cuda.synchronize()
    check(st["errors"] == 0 and st["retries"] == 0
          and st["quarantined"] == 0, f"the auto-edge round: {st}")
    for sid, rid in zip(sids, rids):
        for got, want in ((svc.sketch(sid), solo.sketch(rid)),
                          (svc.corange(sid), solo.corange(rid))):
            check(torch.equal(_bits(got), _bits(want)),
                  "a lane on the auto edges differs from its solo update")
    print(f"[lanes] heights {[H.shape[0] for _, H, _ in items]} through "
          f"make_ingest_queue(bucket_edges=\"auto\"): edges "
          f"{q.bucket_edges}, {svc.stats()['lane_batches'] - batches} lane "
          f"batches, pad waste {st['pad_waste']:.4f}; Y and W bitwise the "
          f"solo updates")


def phase_serving(serve, reset_launches, LAUNCHES):
    """Phase 8: the launcher's entry point on the serving configuration."""
    args = serve.build_parser().parse_args(SERVE_ARGS)
    reset_launches()
    st = serve.run_sketch(args)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    print(f"[serving] {st['updates_per_s']:.1f} updates/s over "
          f"{st['seconds']:.3f} s; latency p50 "
          f"{st['latency_p50_s'] * 1e3:.1f} ms p99 "
          f"{st['latency_p99_s'] * 1e3:.1f} ms; pad waste "
          f"{st['pad_waste']:.4f}; {st['rounds']} rounds; launches over the "
          f"run (warm-up included): {counts}")
    timed = st["launches"]
    print(f"[serving] bucket edges {list(st['bucket_edges'])} "
          f"(make_ingest_queue(bucket_edges=\"auto\", expected_ks=the "
          f"run's heights)): pad waste {st['pad_waste']:.4f}, "
          f"{st['updates_per_s']:.1f} updates/s, {st['lane_batches']} lane "
          f"batches")
    print(f"[serving] timed window: {timed}, {st['lane_batches']} lane "
          f"batches, {st['retries']} retries, {st['quarantined']} "
          f"quarantined")
    check(st["bucket_edges"] is not None,
          "serving: the queue took no planner-priced bucket edges")
    check(st["errors"] == 0 and st["applied"] == 512,
          f"serving: errors {st['errors']}, applied {st['applied']}")
    # the queue's retry and per-lane paths would hide a failed fold behind
    # the solo update: the timed window must have taken neither
    check(st["retries"] == 0 and st["quarantined"] == 0,
          f"serving: {st['retries']} retries, {st['quarantined']} "
          f"quarantined lanes")
    check(timed["fold_rows"] == st["lane_batches"] > 0,
          f"serving: {timed['fold_rows']} fold launches for "
          f"{st['lane_batches']} lane batches")
    check(timed["sketch_fwd"] == timed["sketch_t"] == st["applied"],
          f"serving: sketch_fwd {timed['sketch_fwd']} and sketch_t "
          f"{timed['sketch_t']} launches for {st['applied']} updates")
    for name in ("fold_rows", "sketch_fwd", "sketch_t"):
        check(counts[name] > 0, f"kernel {name} never launched on the "
                                f"serving path")
    return counts, st


def dispatch_timing(dev, SketchService, StreamConfig, fold_rows_block):
    """The host cost of one bucket of the ragged ingest, the H100 entry's
    ``dispatch_overhead``: staging a one-lane, one-row bucket at the
    serving shape (``SketchService._stage``: pinned buffer, copy, one
    host-to-device copy) and one ``fold_rows_block`` call on it; host
    clock (``time.perf_counter_ns``) around the two, the card idle
    before each, median of 200 in microseconds."""
    svc = SketchService()
    cfg = StreamConfig(S_N1, S_N2, r=S_R, seed=800)
    Y = svc.sketch(svc.open(cfg))
    H = torch.randn(1, S_N2)
    dY = torch.zeros(1, 1, S_R, device=dev)
    times = []
    for _ in range(200):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        svc._stage([(None, H, 0, 1)], 1, cfg, 0.0)
        fold_rows_block([Y], dY, [S_N1], [1])
        times.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) / 1e3


def fold_timing(dev, fold_rows_block, plain_fold, sm):
    """fold_rows at one bucket of the serving phase: 64 lanes, kb = 256,
    heights uniform in (128, 256] (the pow2 bucket of 256): the wrapper
    call (CUDA events; host-bound), the kernel's device time, the host
    time of the wrapper's stages (``time.perf_counter_ns``, median of 200
    calls), its plain version, the library call (one
    ``torch._foreach_add_`` over the live windows, building the view lists
    included) and the per-lane ``narrow().add_()`` loop."""
    rng = np.random.default_rng(8)
    lanes, kb = 64, S_KMAX
    ks = rng.integers(kb // 2 + 1, kb + 1, lanes).tolist()
    row0s = [int(rng.integers(0, S_N1 - k + 1)) for k in ks]
    ys = [torch.zeros(S_N1, S_R, device=dev) for _ in range(lanes)]
    d = torch.randn(lanes, kb, S_R, device=dev)
    starts = [S_N1 - r0 for r0 in row0s]
    ms = time_ms(lambda: fold_rows_block(ys, d, starts, ks), inner=50)
    kernel = device_ms(lambda: fold_rows_block(ys, d, starts, ks),
                       "fold_rows_kernel")
    # the same with a 256 MiB read before each call: y and d come from
    # device memory (back to back, the bucket's 14 MB stay in the L2)
    flush = torch.empty(64 * 2 ** 20, device=dev)
    cold = device_ms(lambda: fold_rows_block(ys, d, starts, ks),
                     "fold_rows_kernel", before=flush.sum)
    del flush
    stages = {"check": [], "pack": [], "launch": []}
    for _ in range(200):
        t0 = time.perf_counter_ns()
        lanes = sm._fold_check(ys, d, starts, ks)
        t1 = time.perf_counter_ns()
        plan, calls = sm._fold_pack(ys[0].dtype, d, *lanes)
        t2 = time.perf_counter_ns()
        sm._fold_launch(d, calls)
        t3 = time.perf_counter_ns()
        torch.cuda.synchronize()
        for name, t in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[name].append(t)
    split = {name: statistics.median(t) / 1e3 for name, t in stages.items()}
    ystack = torch.stack(ys)
    plain = time_ms(lambda: plain_fold(ystack, d, starts, ks), reps=3)
    del ystack

    def library():
        torch._foreach_add_([y.narrow(0, r0, k)
                             for y, r0, k in zip(ys, row0s, ks)],
                            [di[:k] for di, k in zip(d, ks)])

    def loop():
        for y, r0, k, di in zip(ys, row0s, ks, d):
            y.narrow(0, r0, k).add_(di[:k])
    lib = time_ms(library, inner=10)
    loop_ms = time_ms(loop, inner=10)
    nbytes = 3.0 * 4 * S_R * sum(ks)        # read y + d windows, write y
    return (ms, (kernel, cold), plain, lib, bound_ms(0.0, nbytes), split,
            plan, loop_ms)


def device_busy_us(dev_events, w0, w1) -> float:
    """Microseconds of [w0, w1] covered by at least one device event (the
    union of their intervals)."""
    busy, edge = 0.0, w0
    for s, t in sorted((max(e.time_range.start, w0),
                        min(e.time_range.end, w1)) for e in dev_events):
        if t > max(s, edge):
            busy += t - max(s, edge)
            edge = t
    return busy


def serving_profile(serve):
    """Phase 8 once more, under torch.profiler: the device time of each
    kernel and copy over the run (warm-up included), and the card's idle
    share of the timed window — one minus the union of the device events
    inside the launcher's ``serve.timed_window`` range over its length,
    both read from this trace (the profiler slows the host, so this is
    the profiled run's share)."""
    from torch.profiler import ProfilerActivity, profile
    mark = "serve.timed_window"
    args = serve.build_parser().parse_args(SERVE_ARGS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st = serve.run_sketch(args)
    dev, ranges = trace_events(prof)
    by_name = {}
    for e in dev:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() * 1e-6, n + 1)
    wins = [e.time_range for e in ranges
            if e.name == mark and e.cat == "user_annotation"]
    idle = "not measured (no timed-window range in the trace)"
    if wins:
        w0, w1 = wins[0].start, wins[0].end
        busy = device_busy_us(dev, w0, w1)
        idle = (f"{1.0 - busy / (w1 - w0):.3f} of the timed window "
                f"({busy * 1e-6:.3f} s busy in {(w1 - w0) * 1e-6:.3f} s)")
    print(f"[profile] phase 8 again under torch.profiler: "
          f"{st['updates_per_s']:.1f} updates/s, {st['seconds']:.3f} s; "
          f"device idle share {idle}")
    for key, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"[profile]   {t:.4f} s in {n} x {key[:90]}")


def serving_diagnosis(dev, local, omega_tile):
    """Per-lane times at the serving shape, to split the serving phase's
    time: sketch_fwd (k rows, K = n2 -> r) and sketch_t (the W update),
    each a wrapper call's CUDA-event time; for sketch_fwd also the plain
    version, ``torch.matmul(H, Omega)`` with Omega drawn beforehand, the
    bound, and at k = 128 the device time of its kernels.  Returns
    {(name, k): ms} and {k: (ms, plain, library, bound, parts)}."""
    g = torch.Generator(device=dev).manual_seed(9)
    L = 2 * S_R + 1
    W = torch.zeros(L, S_N2, device=dev)
    om = omega_tile(SEED, 0, 0, 0, S_N2, S_R, "normal", 0, None, None, dev)
    out, fwd = {}, {}
    for k in (1, 128, 256):
        H = torch.randn(k, S_N2, generator=g, device=dev)
        dY = torch.empty(k, S_R, device=dev)

        def kernel():
            local.sketch_block(H, SEED, S_R, out=dY)
        out[("sketch_fwd", k)] = time_ms(kernel, inner=5)
        out[("sketch_t", k)] = time_ms(lambda: local.sketch_t_block(
            H, SEED, L, salt=1, acc=W), inner=5)
        fwd[k] = (out[("sketch_fwd", k)],
                  time_ms(lambda: local._sketch_block_torch(H, SEED, S_R),
                          inner=5),
                  time_ms(lambda: torch.matmul(H, om), inner=5),
                  bound_ms(2.0 * k * S_N2 * S_R, 4.0 * (k * S_N2 + k * S_R)),
                  kernel_parts(kernel, "sketch_fwd_gemm_kernel")
                  if k == 128 else None)
    return out, fwd


# the kernels each K5 path launches (csrc/gemm_kernels.cu)
GEMM_KERNELS = {"thin": ("gemm_thin_kernel",),
                "skinny": ("gemm_skinny_kernel", "splitk_reduce_kernel"),
                "tiled": ("gemm_tiled_kernel",)}


# what phase 9 times beside a K5 call, by the key it is kept under
YARDSTICKS = {"matmul_cast_ms": "matmul + cast (two calls)",
              "zero_ms": "zero_() of the output's bytes",
              "neg_ms": "neg_() of M in place"}


def gemm_parts(fn, path: str) -> dict:
    """Device time of one K5 call's kernels on ``path`` (torch.profiler)."""
    return {name: device_ms(fn, name) for name in GEMM_KERNELS[path]}


def phase_gemm(dev, local):
    """Phase 9: K5 against its plain version at the exchange's calls on the
    embed leaf — (a), (b) into f32 and, as the training path makes it, into
    a bf16 tensor through out=, and (c) — and at ragged shapes on every
    path; each embed call timed with its path and its kernels' device time.
    Returns (worst max-abs error, {call: (ms, plain, library, bound,
    {"path": ..., "device_ms": {kernel: ms}, ...})})."""
    from repro_torch.kernels.sketch_matmul import gemm_plan
    g = torch.Generator(device=dev).manual_seed(9)
    M = torch.randn(T_M, T_N, generator=g, device=dev)
    P_hat = torch.linalg.qr(torch.randn(T_M, T_R, generator=g,
                                        device=dev)).Q
    print(f"[gemm] Q of torch.linalg.qr: strides {P_hat.stride()} "
          f"({'column' if P_hat.stride(0) == 1 else 'row'}-major)")
    Qt = torch.randn(T_R, T_N, generator=g, device=dev)
    bf16 = torch.bfloat16
    worst, times = 0.0, {}

    def held(name, got, ref, K):
        nonlocal worst
        tol = gemm_tol(K) if ref.dtype == torch.float32 else BF16_TOL
        err = rel_fro(got, ref)
        print(f"[gemm] {name}: rel_fro={err:.3e} (tol {tol:.1e})")
        check(got.dtype == ref.dtype and got.shape == ref.shape,
              f"gemm {name}: wrong output {got.dtype} {tuple(got.shape)}")
        check(err <= tol, f"gemm {name} disagrees with its plain version: "
                          f"{err:.3e}")
        worst = max(worst, max_abs(got, ref))

    def timed(call, shape, fn, plain, lib, out_bytes, **extra):
        path = gemm_plan(*shape)["path"]
        m_, n_, k_ = shape
        times[call] = (time_ms(fn), time_ms(plain),
                       None if lib is None else time_ms(lib),
                       bound_ms(2.0 * m_ * n_ * k_,
                                out_bytes + 4.0 * (m_ * k_ + k_ * n_)),
                       {"path": path, "device_ms": gemm_parts(fn, path),
                        **extra})

    # (a) Q^T_loc = P^T M: K = m, an r x n output
    held(f"(a) P^T.M ({T_R}x{T_M})({T_M}x{T_N})",
         local.gemm_block(P_hat.T, M), local._gemm_block_torch(P_hat.T, M),
         T_M)
    timed("a", (T_R, T_N, T_M), lambda: local.gemm_block(P_hat.T, M),
          lambda: local._gemm_block_torch(P_hat.T, M),
          lambda: torch.matmul(P_hat.T, M), 4.0 * T_R * T_N)
    # (b) g_hat = P Q^T: K = r, into f32
    held(f"(b) P.Q^T ({T_M}x{T_R})({T_R}x{T_N}) f32",
         local.gemm_block(P_hat, Qt), local._gemm_block_torch(P_hat, Qt),
         T_R)
    # beside (b) and (c), a PyTorch pass over the same output bytes with
    # no product (zero_: writes only; neg_: reads and writes in place), a
    # yardstick of the streaming rate the card gives
    X = torch.empty_like(M)
    timed("b", (T_M, T_N, T_R), lambda: local.gemm_block(P_hat, Qt),
          lambda: local._gemm_block_torch(P_hat, Qt),
          lambda: torch.matmul(P_hat, Qt), 4.0 * T_M * T_N,
          zero_ms=time_ms(X.zero_))
    del X
    # (b) as the training path makes it: rounded to bf16 into the
    # gradient's storage (grad_compress: out_dtype=g.dtype, out=g.view)
    G = torch.empty(T_M, T_N, dtype=bf16, device=dev)
    got = local.gemm_block(P_hat, Qt, out_dtype=bf16, out=G)
    check(got.data_ptr() == G.data_ptr(), "gemm (b) bf16 ignored out=")
    held("(b) P.Q^T into a bf16 out=", got,
         local._gemm_block_torch(P_hat, Qt, out_dtype=bf16), T_R)
    # no one PyTorch call takes f32 operands to a bf16 product: the
    # library column is empty, and matmul + cast (two calls) is printed
    timed("b_bf16", (T_M, T_N, T_R),
          lambda: local.gemm_block(P_hat, Qt, out_dtype=bf16, out=G),
          lambda: local._gemm_block_torch(P_hat, Qt, out_dtype=bf16), None,
          2.0 * T_M * T_N,
          matmul_cast_ms=time_ms(lambda: torch.matmul(P_hat, Qt).to(bf16)),
          zero_ms=time_ms(G.zero_))
    del G, got
    # (c) e' = M - P Q^T_loc in place, checked on a copy of M
    ref = local._gemm_block_torch(P_hat, Qt, -1.0, M)
    Mc = M.clone()
    got = local.gemm_block(P_hat, Qt, acc=Mc, alpha=-1.0)
    check(got.data_ptr() == Mc.data_ptr(), "gemm (c) did not write in place")
    held("(c) M - P.Q^T in place", got, ref, T_R)
    del ref, got
    timed("c", (T_M, T_N, T_R),
          lambda: local.gemm_block(P_hat, Qt, acc=Mc, alpha=-1.0),
          lambda: local._gemm_block_torch(P_hat, Qt, -1.0, Mc),
          lambda: Mc.addmm_(P_hat, Qt, alpha=-1.0), 8.0 * T_M * T_N,
          neg_ms=time_ms(Mc.neg_))
    # K2 at the exchange's shape: P = M Omega, K = n, r columns
    om = local._omega_f32(5, 0, 0, 0, T_N, T_R, "normal", 0, None, dev)
    times["sketch_fwd"] = (
        time_ms(lambda: local.sketch_block(M, (5, 0), T_R)),
        time_ms(lambda: local._sketch_block_torch(M, (5, 0), T_R)),
        time_ms(lambda: torch.matmul(M, om)),
        bound_ms(2.0 * T_M * T_N * T_R, 4.0 * (T_M * T_N + T_M * T_R)),
        kernel_parts(lambda: local.sketch_block(M, (5, 0), T_R),
                     "sketch_fwd_narrow_kernel"))
    del M, Mc, P_hat, Qt, om
    # ragged against every path, alpha 0.5, with acc (at = 1: acc a view
    # one element into a larger buffer, off every vector boundary); A
    # column-major, as P is
    for m, K, n, at, want in ((5, 100003, 1001, 0, "skinny"),
                              (1001, 7, 2305, 0, "thin"),
                              (1001, 1, 2304, 0, "thin"),
                              (1001, 16, 2304, 0, "thin"),
                              (1001, 17, 2304, 0, "tiled"),
                              (4099, 8, 2305, 0, "thin"),
                              (1001, 8, 2304, 1, "thin")):
        path = gemm_plan(m, n, K)["path"]
        check(path == want, f"gemm_plan({m}, {n}, {K}) is {path}, not {want}")
        A = torch.randn(K, m, generator=g, device=dev).T
        B = torch.randn(K, n, generator=g, device=dev)
        acc = torch.randn(m, n, generator=g, device=dev)
        buf = torch.zeros(m * n + at, device=dev)
        view = buf[at:].view(m, n)
        view.copy_(acc)
        held(f"ragged ({m}x{K})({K}x{n}) alpha 0.5, {path}"
             + (f", acc at element {at}" if at else ""),
             local.gemm_block(A, B, alpha=0.5, acc=view),
             local._gemm_block_torch(A, B, 0.5, acc), K)
    torch.cuda.synchronize()
    for call, (ms, plain, lib, (bms, by), parts) in times.items():
        name = "sketch_fwd" if call == "sketch_fwd" else f"gemm ({call})"
        if call == "sketch_fwd":
            extra = f"; on the device (torch.profiler): {parts_text(parts)}"
        else:
            extra = (f"; path {parts['path']}, on the device "
                     f"(torch.profiler): {parts_text(parts['device_ms'])}"
                     + "".join(f"; {YARDSTICKS[k]} {t:.3f} ms"
                               for k, t in parts.items() if k in YARDSTICKS))
        print(f"[timing] {name} at the embed leaf ({T_M}x{T_N}, r={T_R}): "
              f"{ms:.3f} ms (plain {plain:.3f}, library "
              f"{'none' if lib is None else f'{lib:.3f}'}, bound "
              f"{bms:.3f} ms by {by}){extra}")
    return worst, times


def _plain_exchange(local, g, e, seed, r, mean=lambda t: t):
    """The exchange of one leaf written with the plain versions (new
    tensors, nothing in place): (g_hat, e').  ``mean`` is the mean over
    the workers (one worker: none)."""
    M = g.float() + e
    P_hat = torch.linalg.qr(mean(local._sketch_block_torch(M, seed, r))).Q
    Qt_loc = local._gemm_block_torch(P_hat.T, M)
    return (local._gemm_block_torch(P_hat, mean(Qt_loc.clone()),
                                    out_dtype=g.dtype),
            local._gemm_block_torch(P_hat, Qt_loc, -1.0, M))


def phase_exchange(dev, local, grad_compress):
    """Phase 10: the exchange at full size, kernels against plain."""
    g = torch.Generator(device=dev).manual_seed(10)
    grad = torch.randn(T_M, T_N, generator=g, device=dev)
    fb = 0.1 * torch.randn(T_M, T_N, generator=g, device=dev)
    seed = grad_compress.leaf_seed(0, 3)
    want_g, want_e = _plain_exchange(local, grad, fb, seed, T_R)
    grads, fbs = {"embed": grad.clone()}, {"embed": fb.clone()}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    grad_compress.compress_and_allreduce(grads, fbs, step=3, rank=T_R,
                                         decisions={"embed": True})
    end.record()
    end.synchronize()
    err_g = rel_fro(grads["embed"], want_g)
    err_e = rel_fro(fbs["embed"], want_e)
    print(f"[exchange] embed-shaped gradient ({T_M}x{T_N}, r={T_R}): "
          f"{start.elapsed_time(end):.3f} ms with the kernels; g_hat "
          f"rel_fro={err_g:.3e}, e' rel_fro={err_e:.3e} (tol "
          f"{gemm_tol(T_M):.1e})")
    check(err_g <= gemm_tol(T_M) and err_e <= gemm_tol(T_M),
          "the exchange disagrees with its plain version")
    check(float(fbs["embed"].abs().max()) > 0, "zero error feedback")
    plain = time_ms(lambda: _plain_exchange(local, grad, fb, seed, T_R),
                    reps=3)
    print(f"[exchange] the same exchange with the plain versions: "
          f"{plain:.3f} ms")


def phase_training(dev, LAUNCHES, reset_launches):
    """Phase 11: gemma2-2b at its published size, through train_loop."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import get_api, param_leaves
    from repro_torch.plan import plan_train_compression
    from repro_torch.train import (init_state, make_dp_compressed_step,
                                   train_loop)
    cfg = get_config("gemma2-2b")
    api = get_api(cfg)
    run = RunConfig(steps=T_STEPS, learning_rate=1e-4, warmup_steps=2,
                    checkpoint_every=0, grad_compress_rank=T_R)
    plan = plan_train_compression(api.init(0, cfg, "meta"), rank=T_R,
                                  P=T_PLAN_WORKERS)
    check(plan.n_compressed == 12, f"plan compresses {plan.n_compressed} "
                                   f"leaves, not 12")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(api, cfg, run, 0, dev, decisions=plan.decision_tree())
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in param_leaves(state.params))
    print(f"[train] {cfg.name}: {n_params} parameters ({cfg.n_layers} "
          f"layers, {cfg.dtype}), state on the card in "
          f"{time.perf_counter() - t0:.1f} s; plan at P={T_PLAN_WORKERS}: "
          f"{plan.n_compressed}/{len(plan.decisions)} leaves compressed, "
          f"{plan.exchange_words:.0f} words vs {plan.raw_words:.0f} raw")
    step = make_dp_compressed_step(api, cfg, run, plan=plan)
    per_step, exchange_ms, fb_nonzero = [], [], []
    last = dict(LAUNCHES)

    def on_step(i, metrics):
        now = dict(LAUNCHES)
        per_step.append({k: now[k] - last[k] for k in now})
        last.update(now)
        start, end = step.exchange
        end.synchronize()
        exchange_ms.append(start.elapsed_time(end))
        if i == 0:
            fb_nonzero.append(all(
                float(e.abs().max()) > 0
                for (_, e), d in zip(param_leaves(state.error_fb),
                                     plan.decisions) if d.compress))

    reset_launches()
    last.update(LAUNCHES)
    res = train_loop(step, state, DataConfig(cfg.vocab, T_SEQ, T_BATCH,
                                             seed=0),
                     run, device=dev, on_step=on_step)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"[train] losses: {[round(x, 4) for x in res.losses]}")
    print(f"[train] launches a step: {per_step}")
    check(len(res.losses) == T_STEPS and all(
        math.isfinite(x) for x in res.losses), f"losses {res.losses}")
    for c in per_step:
        check(c["gemm"] == 3 * plan.n_compressed and
              c["sketch_fwd"] == plan.n_compressed,
              f"a step launched gemm {c['gemm']} and sketch_fwd "
              f"{c['sketch_fwd']} times")
    check(fb_nonzero == [True], "error buffers zero after step 1")
    steady = res.step_seconds[1:]
    step_s = statistics.median(steady)
    ex_s = statistics.median(exchange_ms[1:]) * 1e-3
    print(f"[train] step times (s, host clock, each ending in a device "
          f"synchronize): {[round(t, 4) for t in res.step_seconds]}")
    print(f"[train] median step {step_s:.4f} s over {len(steady)} steps "
          f"after the warm-up: {T_BATCH * T_SEQ / step_s:.1f} tokens/s; the "
          f"exchange {ex_s * 1e3:.3f} ms, {ex_s / step_s:.4f} of the step; "
          f"peak memory {peak / 2 ** 30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    batch = make_batch(DataConfig(cfg.vocab, T_SEQ, T_BATCH, seed=0),
                       T_STEPS, dev)
    profile_step(step, state, batch)
    train_row = roofline_train_row(step, state, batch, cfg, dev)
    del state, res, step, batch
    torch.cuda.empty_cache()
    return counts, train_row


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")   # a trace's device work


def trace_events(prof):
    """A finished profile's events, read back from the Chrome trace that
    kineto writes in C++ (``prof.events()`` builds its list in Python, some
    seconds for a trace of 10^5 events): ``(device, ranges)``, the device
    events (kernels, copies, sets) and the ``record_function`` ranges on
    the host (``user_annotation``) and their spans on the device
    (``gpu_user_annotation``), each a ``SimpleNamespace(name, cat,
    time_range)``, times in us."""
    import os
    import tempfile
    import types

    from torch.autograd.profiler_util import Interval
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    keep = DEVICE_CATS + ("user_annotation", "gpu_user_annotation")
    out = [types.SimpleNamespace(
        name=e["name"], cat=e["cat"],
        time_range=Interval(e["ts"], e["ts"] + e.get("dur", 0)))
        for e in evs if e.get("ph") == "X" and e.get("cat") in keep]
    return ([e for e in out if e.cat in DEVICE_CATS],
            [e for e in out if e.cat not in DEVICE_CATS])


def profiled(fn, mark: str):
    """``fn()`` once under torch.profiler inside a ``mark`` range, ended
    by a synchronize: the device events and the range's start and end
    (us)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(mark):
            fn()
            torch.cuda.synchronize()
    dev, ranges = trace_events(prof)
    wins = [e.time_range for e in ranges
            if e.name == mark and e.cat == "user_annotation"]
    check(bool(dev) and bool(wins), f"the profiled {mark} has no device "
                                    f"events")
    return dev, wins[0].start, wins[0].end


def profile_step(step, state, batch):
    """One more training step under torch.profiler: device time by kernel
    and the card's idle share inside the step's ``train.profiled_step``
    range (the profiler's own host cost included)."""
    dev, w0, w1 = profiled(lambda: step(state, batch), "train.profiled_step")
    busy = device_busy_us(dev, w0, w1)
    by_name = {}
    for e in dev:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() * 1e-3, n + 1)
    total = sum(t for t, _ in by_name.values())
    print(f"[profile] one step under torch.profiler: {(w1 - w0) * 1e-3:.1f} "
          f"ms, device busy {busy * 1e-3:.1f} ms, idle share "
          f"{1.0 - busy / (w1 - w0):.3f}; device time {total:.1f} ms in "
          f"{sum(n for _, n in by_name.values())} events")
    groups = {}
    for key, (t, n) in by_name.items():
        group = ("the port's kernels" if "repro_torch" in key
                 else "copies" if key.startswith("Memcpy")
                 else "library GEMMs" if any(w in key.lower() for w in (
                     "nvjet", "gemm", "cutlass", "xmma"))
                 else "other torch kernels (elementwise, reductions)")
        groups[group] = groups.get(group, 0.0) + t
    for group, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {t:9.3f} ms ({t / total:.3f}) {group}")
    port = {}
    for key, (t, n) in by_name.items():
        found = re.search(r"(\w+_kernel)\b", key)
        if "repro_torch" in key and found:
            pt, pn = port.get(found.group(1), (0.0, 0))
            port[found.group(1)] = (pt + t, pn + n)
    print("[profile]   the port's kernels by name: " + ", ".join(
        f"{name} {t:.3f} ms in {n}"
        for name, (t, n) in sorted(port.items(), key=lambda kv: -kv[1][0])))
    for key, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile]   {t:9.3f} ms ({t / total:.3f}) in {n:5d} x "
              f"{key[:100]}")


# -- phases 12-13: four ranks of one card -------------------------------------

def rank_entry(fn, rank, world, store, queue, args):
    """One rank of a spawned phase (a process of its own): joins the gloo
    group at the ``file://`` store on cuda:0, runs ``fn(rank, world,
    *args)`` and puts its result or its error on ``queue``."""
    import datetime
    import traceback

    import torch.distributed as dist
    try:
        sys.path.insert(0, str(ROOT / "src"))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=RANKS_TIMEOUT_S))
        try:
            res = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, res, None))
    except BaseException:  # noqa: BLE001 — reported to the parent, which fails
        queue.put((rank, None, traceback.format_exc()))


def spawn_ranks(phase: int, fn, world: int, args=()):
    """``[fn(rank, world, *args) for rank in range(world)]``, each rank a
    spawned process of one gloo group on cuda:0 (NCCL refuses two ranks
    on one card), meeting at a ``file://`` store in a fresh temporary
    directory.  Any rank's failure, or a rank that has not answered in
    ``RANKS_TIMEOUT_S``, fails the phase; every process is joined or
    killed."""
    import multiprocessing as mp
    import shutil
    import tempfile
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_phase{phase}_")
    store = str(pathlib.Path(tmp) / "store")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=rank_entry,
                         args=(fn, r, world, store, queue, tuple(args)))
             for r in range(world)]
    for p in procs:
        p.start()
    results = [None] * world
    try:
        for _ in range(world):
            rank, res, err = queue.get(timeout=RANKS_TIMEOUT_S)
            check(err is None, f"phase {phase}, rank {rank} failed:\n{err}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    check(all(p.exitcode == 0 for p in procs),
          f"phase {phase} ranks exited {[p.exitcode for p in procs]}")
    print(f"[phase {phase}] spawned, ran and joined in "
          f"{time.perf_counter() - t0:.1f} s")
    return results


def same_matrix(A, rank: int, world: int) -> None:
    """Every rank must hold the same A: the sums of its bits agree."""
    import torch.distributed as dist
    bits = torch.tensor([int(A.view(torch.int32).sum(dtype=torch.int64))])
    every = [torch.zeros_like(bits) for _ in range(world)]
    dist.all_gather(every, bits)
    check(all(torch.equal(b, bits) for b in every),
          f"rank {rank}: the ranks' A differ")


def _alg1_rank(rank, world, sass, mhz):
    """Phase 12, one rank."""
    import torch.distributed as dist
    from repro_torch.core import sketch as sk
    from repro_torch.core.grid import alg1_bandwidth_words
    from repro_torch.core.sketch import _omega_tile_torch
    from repro_torch.kernels import local
    from repro_torch.kernels.sketch_matmul import (LAUNCHES, gen_omega_cuda,
                                                   reset_launches)
    from repro_torch.parallel import collectives as col
    from repro_torch.plan.model import alg1_communicating_cost

    dev = torch.device("cuda", 0)
    lines = []

    def say(msg):
        lines.append(f"[alg1] rank {rank}: {msg}")

    A = make_matrix(dev)
    same_matrix(A, rank, world)
    # the check: the one-device port's B (sketch_fwd on the card)
    B_one = local.sketch_block(A, SEED, R)
    torch.cuda.synchronize()
    groups = {grid: sk.make_grid_groups(*grid) for grid in ALG1_GRIDS}
    runs, launches = {}, {"sketch_fwd": 0, "gen_omega": 0}

    def drive(name, grid, fn, comm_words, compare_grid=None):
        g = groups[grid]
        dist.barrier()
        reset_launches()
        col.reset_comm()
        t0 = time.perf_counter()
        blk = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: LAUNCHES[k] for k in launches}
        words = col.comm_words()
        for k in launches:
            launches[k] += counts[k]
        ref = sk.output_block(B_one, g)
        p1, p2, p3 = grid
        check(tuple(blk.shape) == tuple(ref.shape)
              and bool(torch.isfinite(blk).all()),
              f"rank {rank}: {name}: block {tuple(blk.shape)}")
        err = rel_fro(blk, ref)
        if p2 == 1 and p3 == 1:
            check(torch.equal(blk, ref),
                  f"rank {rank}: {name}: block not bitwise the "
                  f"one-device B (rel_fro {err:.3e})")
            held = "bitwise"
        else:
            tol = f32_tol(N // p2)
            check(err <= tol, f"rank {rank}: {name}: rel_fro {err:.3e} "
                              f"> {tol:.1e}")
            held = f"rel_fro {err:.3e} <= f32_tol(n2/p2) {tol:.1e}"
        check(words == comm_words,
              f"rank {rank}: {name}: {words} words received, the "
              f"formula says {comm_words}")
        say(f"{name} on {grid}: block {tuple(blk.shape)} {held}; words "
            f"received {words} == {comm_words:.0f}; launches {counts}; "
            f"wall {wall:.4f} s")
        runs[name] = {"grid": list(grid), "words": words,
                      "formula_words": comm_words, "rel_fro": err,
                      "bitwise": held == "bitwise", "wall_s": wall,
                      "launches": counts}
        return counts, words

    counts, _ = drive(
        "auto", ALG1_GRIDS[0],
        lambda: _auto_checked(sk.rand_matmul_auto(A, SEED, R)),
        alg1_bandwidth_words(N, N, R, *ALG1_GRIDS[0]))
    check(counts["sketch_fwd"] == 1, f"rank {rank}: auto launched "
                                     f"sketch_fwd {counts['sketch_fwd']}")
    for grid in ALG1_GRIDS:
        blk_in = sk.input_block(A, groups[grid])
        counts, _ = drive(
            str(grid), grid,
            lambda: sk.rand_matmul(blk_in, SEED, R, groups[grid]),
            alg1_bandwidth_words(N, N, R, *grid))
        check(counts["sketch_fwd"] == 1 and counts["gen_omega"] == 0,
              f"rank {rank}: {grid} launched {counts}")
        del blk_in
    blk_in = sk.input_block(A, groups[ALG1_COMM_GRID])
    counts, words = drive(
        "communicating", ALG1_COMM_GRID,
        lambda: sk.rand_matmul_communicating(blk_in, SEED, R,
                                             groups[ALG1_COMM_GRID]),
        alg1_communicating_cost(N, N, R, ALG1_COMM_GRID).words)
    check(counts["gen_omega"] == 1 and counts["sketch_fwd"] == 0,
          f"rank {rank}: communicating launched {counts}")
    check(words > runs[str(ALG1_COMM_GRID)]["words"],
          f"rank {rank}: communicating moved no more words than Alg. 1")
    del blk_in
    torch.cuda.empty_cache()

    # the local kernels at this rank's shapes, four ranks sharing the
    # card: sketch_fwd on its gathered panel, gen_omega on its Omega rows
    calls = {"sketch_fwd": {}, "gen_omega": {}}
    for grid in ALG1_GRIDS:
        p1, p2, p3 = grid
        i, j, k = groups[grid].coords
        m, K, cols = N // p1, N // p2, R // p3
        row0, col0 = j * K, k * cols
        key = f"{m}x{K}->{cols} at ({row0},{col0})"
        a_ij = A[i * m:(i + 1) * m, row0:row0 + K].contiguous()
        om = _omega_tile_torch(SEED, 0, row0, col0, K, cols, "normal", 0,
                               None, None, dev)
        got = local.sketch_block(a_ij, SEED, cols, row0=row0, col0=col0)
        plain = local._sketch_block_torch(a_ij, SEED, cols, row0=row0,
                                          col0=col0)
        err, abs_err = rel_fro(got, plain), max_abs(got, plain)
        check(err <= f32_tol(K), f"rank {rank}: sketch_fwd {key}: "
                                 f"rel_fro {err:.3e} vs plain")
        ms = time_ms(lambda: local.sketch_block(a_ij, SEED, cols,
                                                row0=row0, col0=col0))
        plain_ms = time_ms(lambda: local._sketch_block_torch(
            a_ij, SEED, cols, row0=row0, col0=col0), reps=3)
        lib_ms = time_ms(lambda: torch.matmul(a_ij, om))
        bms, by = bound_ms(2.0 * m * K * cols, 4.0 * (m * K + m * cols))
        calls["sketch_fwd"][key] = {
            "grids": calls["sketch_fwd"].get(key, {}).get("grids", [])
            + [list(grid)], "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": abs_err, "rel_fro": err}
        del a_ij, om, got, plain
    own = N // math.prod(ALG1_COMM_GRID)
    row0 = rank * own
    key = f"{own}x{R} at row {row0}"
    got = gen_omega_cuda(SEED, 0, row0, 0, own, R, "normal", 0,
                         device=dev)
    plain = _omega_tile_torch(SEED, 0, row0, 0, own, R, "normal", 0,
                              None, None, dev)
    check(torch.equal(got, plain), f"rank {rank}: gen_omega {key} not "
                                   f"bitwise its plain version")
    ops_ms = omega_ops_bound_ms(sass, own * R, mhz)[0]
    bytes_ms = bound_ms(0.0, 4.0 * own * R)[0]
    calls["gen_omega"][key] = {
        "ms": time_ms(lambda: gen_omega_cuda(SEED, 0, row0, 0, own, R,
                                             "normal", 0, device=dev)),
        "plain_ms": time_ms(lambda: _omega_tile_torch(
            SEED, 0, row0, 0, own, R, "normal", 0, None, None, dev),
            reps=3),
        "library_ms": None, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "max_abs_err": 0.0}
    for name, by_shape in calls.items():
        for key, c in by_shape.items():
            lib = c["library_ms"]
            say(f"local kernel {name} {key} (four ranks share one "
                f"card): {c['ms']:.3f} ms (plain {c['plain_ms']:.3f}, "
                f"library {'none' if lib is None else f'{lib:.3f}'}, "
                f"bound {c['bound_ms']:.3f} ms by {c['bound_by']}), "
                f"max_abs_err {c['max_abs_err']:.3e}")
    say("wall time per call (gloo through host memory, not an "
        "interconnect time): " + ", ".join(
            f"{n} {r['wall_s']:.4f} s" for n, r in runs.items()))
    peak = torch.cuda.max_memory_allocated()
    say(f"peak memory {peak / 2 ** 30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    dist.barrier()
    return {"lines": lines, "runs": runs, "launches": launches,
            "calls": calls, "peak_gib": peak / 2 ** 30}


def _auto_checked(res):
    B_blk, gm, _ = res
    check(gm.shape == ALG1_GRIDS[0] and gm.regime == 1,
          f"rand_matmul_auto chose {gm.shape} (regime {gm.regime}), not "
          f"{ALG1_GRIDS[0]} (regime 1)")
    return B_blk


def phase_alg1(sass, mhz):
    """Phase 12: Alg. 1 on ALG1_WORLD ranks of one card over gloo, each
    rank holding phase 1-5's A."""
    print(f"[alg1] {ALG1_WORLD} ranks on cuda:0 over gloo (the collectives "
          f"take CUDA tensors; gloo stages them through host memory "
          f"itself): A {N}x{N} f32, r = {R}, grids auto "
          f"{ALG1_GRIDS}, communicating {ALG1_COMM_GRID}")
    results = spawn_ranks(12, _alg1_rank, ALG1_WORLD, (sass, mhz))
    for res in results:
        for line in res["lines"]:
            print(line)
    for name in ("sketch_fwd", "gen_omega"):
        n = [res["launches"][name] for res in results]
        check(all(x > 0 for x in n), f"{name} not launched on every rank: "
                                     f"{n}")
    return results


def _alg2_rank(rank, world, sass, mhz):
    """Phase 13, one rank."""
    import torch.distributed as dist
    from repro_torch.core import nystrom as nys
    from repro_torch.core import sketch as sk
    from repro_torch.core.grid import alg2_bandwidth_words
    from repro_torch.core.sketch import _omega_tile_torch
    from repro_torch.kernels import local
    from repro_torch.kernels.sketch_matmul import (
        LAUNCHES, reset_launches, sketch_t_plan)
    from repro_torch.parallel import collectives as col

    dev = torch.device("cuda", 0)
    P, p = world, (world, 1, 1)
    lines = []

    def say(msg):
        lines.append(f"[alg2] rank {rank}: {msg}")

    A = make_matrix(dev)
    same_matrix(A, rank, world)
    # the check: the one-device port's pair (sketch_fwd, then sketch_t)
    B_one = local.sketch_block(A, SEED, R)
    C_one = local.sketch_t_block(B_one, SEED, R)
    torch.cuda.synchronize()
    g = sk.make_grid_groups(*p)
    # words received: No-Redist's reduce-scatter is the formula on
    # (P,1,1) twice; Redist's all-to-all keeps 1/P of its n·r/P words, so
    # it receives less than the formula's n·r/P term
    words = {"no_redist": (P - 1) * R * R // P,
             "redist": (P - 1) * N * R // P ** 2}
    formula = {"no_redist": alg2_bandwidth_words(N, R, p, p),
               "redist": alg2_bandwidth_words(N, R, p, (1, 1, P))}
    check(words["no_redist"] == formula["no_redist"]
          and words["redist"] < formula["redist"] == N * R / P,
          f"the word counts {words} against the formula {formula}")
    names = ("sketch_fwd", "sketch_t", "gen_omega")
    runs, launches, pairs = {}, dict.fromkeys(names, 0), {}

    def drive(name, variant, fn):
        dist.barrier()
        reset_launches()
        col.reset_comm()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        B, C = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: LAUNCHES[k] for k in names}
        got = col.comm_words()
        peak = torch.cuda.max_memory_allocated()
        for k in names:
            launches[k] += counts[k]
        B_ref = nys.nystrom_block(B_one, g, variant)
        C_ref = nys.nystrom_block(C_one, g, variant)
        check(B.shape == B_ref.shape and C.shape == C_ref.shape
              and bool(torch.isfinite(B).all() and torch.isfinite(C).all()),
              f"rank {rank}: {name}: B {tuple(B.shape)}, C {tuple(C.shape)}")
        where = "rows" if variant == "no_redist" else "columns"
        check(torch.equal(B, B_ref), f"rank {rank}: {name}: B is not "
                                     f"bitwise the one-device B's {where}")
        err, tol = rel_fro(C, C_ref), f32_tol(N)
        check(err <= tol, f"rank {rank}: {name}: C rel_fro {err:.3e} > "
                          f"f32_tol(n) {tol:.1e}")
        check(got == words[variant],
              f"rank {rank}: {name}: {got} words received, not "
              f"{words[variant]}")
        check(counts == {"sketch_fwd": 1, "sketch_t": 1, "gen_omega": 0},
              f"rank {rank}: {name} launched {counts}")
        say(f"{name} ({variant}): B {tuple(B.shape)} bitwise the one-device "
            f"B's {where}; C {tuple(C.shape)} rel_fro {err:.3e} <= "
            f"f32_tol(n) {tol:.1e}; words received {got} (formula "
            f"{formula[variant]:.0f}, gap {formula[variant] - got:.0f}); "
            f"launches {counts}; wall {wall:.4f} s; peak "
            f"{peak / 2 ** 30:.2f} GiB")
        runs[name] = {"variant": variant, "words": got,
                      "formula_words": formula[variant], "c_rel_fro": err,
                      "wall_s": wall, "peak_gib": peak / 2 ** 30,
                      "launches": counts}
        pairs[name] = (B, C)

    def auto():
        B, C, ga, variant = nys.nystrom_auto(A, SEED, R)
        check((variant, ga.shape) == ("no_redist", p),
              f"nystrom_auto chose {variant} on {ga.shape}, not no_redist "
              f"(n/r = {N // R} > P = {P})")
        return B, C

    drive("auto", "no_redist", auto)
    blk_in = sk.input_block(A, g)
    for variant in ALG2_VARIANTS:
        fn = {"no_redist": nys.nystrom_no_redist,
              "redist": nys.nystrom_redist}[variant]
        drive(variant, variant, lambda: fn(blk_in, SEED, R, g))
    check(torch.equal(pairs["auto"][0], pairs["no_redist"][0])
          and torch.equal(pairs["auto"][1], pairs["no_redist"][1]),
          f"rank {rank}: auto and no_redist differ")
    del B_one, C_one
    # each variant's pair, gathered (uncounted), reconstructs A on rank 0
    rel = {}
    for variant in ALG2_VARIANTS:
        B, C = pairs[variant]
        B_full = nys.nystrom_gather(B, g, variant)
        C_full = nys.nystrom_gather(C, g, variant)
        if rank == 0:
            rel[variant] = float(nys.relative_error(A, B_full, C_full,
                                                    rcond=NYSTROM_RCOND))
            check(math.isfinite(rel[variant]) and rel[variant] <= 1e-4,
                  f"{variant}: Nystrom relative error {rel[variant]}")
            say(f"{variant}: Nystrom relative error ||A - B C+ B^T||/||A|| "
                f"= {rel[variant]:.3e} at rcond {NYSTROM_RCOND:g}")
        del B_full, C_full
    dist.barrier()
    torch.cuda.empty_cache()

    # the local kernels at this rank's shapes, four ranks sharing the card;
    # the device time of each sketch_t call's draw, product and reduce on
    # rank 0 alone (the other ranks wait)
    calls = {"sketch_t": {}, "sketch_fwd": {}}
    stage2 = (("no_redist", pairs["no_redist"][0], g.coords[0] * (N // P)),
              ("redist", pairs["redist"][0], 0))
    for variant, Bb, row0 in stage2:
        K, c = Bb.shape
        om = _omega_tile_torch(SEED, 0, row0, 0, K, R, "normal", 0, None,
                               None, dev)

        def kernel():
            return local.sketch_t_block(Bb, SEED, R, row0=row0)

        def plain_fn():
            return local._sketch_t_block_torch(Bb, SEED, R, row0=row0)

        got, plain = kernel(), plain_fn()
        err, abs_err = rel_fro(got, plain), max_abs(got, plain)
        check(err <= f32_tol(K), f"rank {rank}: sketch_t ({variant}) "
                                 f"rel_fro {err:.3e} vs plain")
        bms, by = bound_ms(2.0 * R * K * c, 4.0 * (K * c + R * c))
        calls["sketch_t"][variant] = {
            "shape": f"{K}x{c} -> {R}x{c} at row0 {row0}",
            "ms": time_ms(kernel), "plain_ms": time_ms(plain_fn, reps=3),
            "library_ms": time_ms(lambda: torch.matmul(om.T, Bb)),
            "bound_ms": bms, "bound_by": by,
            "draw_bound_ms": omega_ops_bound_ms(sass, K * R, mhz)[0],
            **sketch_t_plan(R, c, K), "max_abs_err": abs_err, "rel_fro": err}
        dist.barrier()
        if rank == 0:
            calls["sketch_t"][variant]["device_ms"] = kernel_parts(
                kernel, "sketch_t_gemm_kernel")
        dist.barrier()
        del om, got, plain
    m = N // P
    om = _omega_tile_torch(SEED, 0, 0, 0, N, R, "normal", 0, None, None,
                           dev)
    got = local.sketch_block(blk_in, SEED, R)
    plain = local._sketch_block_torch(blk_in, SEED, R)
    err = rel_fro(got, plain)
    check(err <= f32_tol(N), f"rank {rank}: sketch_fwd rel_fro {err:.3e} "
                             f"vs plain")
    bms, by = bound_ms(2.0 * m * N * R, 4.0 * (m * N + m * R))
    calls["sketch_fwd"]["first_stage"] = {
        "shape": f"{m}x{N} -> {m}x{R}",
        "ms": time_ms(lambda: local.sketch_block(blk_in, SEED, R)),
        "plain_ms": time_ms(lambda: local._sketch_block_torch(blk_in, SEED,
                                                             R), reps=3),
        "library_ms": time_ms(lambda: torch.matmul(blk_in, om)),
        "bound_ms": bms, "bound_by": by, "max_abs_err": max_abs(got, plain),
        "rel_fro": err}
    del om, got, plain
    for name, by_call in calls.items():
        for call, rec in by_call.items():
            extra = ""
            if name == "sketch_t":
                extra = (f"; {rec['splits']} splits, Omega scratch "
                         f"{rec['scratch_bytes'] / 2 ** 20:.0f} MiB, work "
                         f"{rec['work_bytes'] / 2 ** 20:.0f} MiB; draw bound "
                         f"{rec['draw_bound_ms']:.4f} ms (SASS)")
                if "device_ms" in rec:
                    extra += (f"; on the device, rank 0 alone "
                              f"(torch.profiler): "
                              f"{parts_text(rec['device_ms'])}")
            say(f"local kernel {name} ({call}) {rec['shape']} (four ranks "
                f"share the card): {rec['ms']:.4f} ms (plain "
                f"{rec['plain_ms']:.3f}, library {rec['library_ms']:.4f}, "
                f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}), "
                f"max_abs_err {rec['max_abs_err']:.3e}{extra}")
    say("wall time per call (gloo through host memory, not an "
        "interconnect time): " + ", ".join(
            f"{n} {r['wall_s']:.4f} s" for n, r in runs.items()))
    dist.barrier()
    return {"lines": lines, "runs": runs, "launches": launches,
            "calls": calls, "relative_error": rel}


def phase_alg2(sass, mhz):
    """Phase 13: the 1-D Alg. 2 on ALG2_WORLD ranks of one card over gloo,
    each rank holding phase 1-5's A."""
    print(f"[alg2] {ALG2_WORLD} ranks on cuda:0 over gloo (the "
          f"reduce-scatter and the all-to-all take CUDA tensors; gloo "
          f"stages them through host memory itself): A {N}x{N} f32, r = "
          f"{R}, nystrom_auto, then {', '.join(ALG2_VARIANTS)}")
    results = spawn_ranks(13, _alg2_rank, ALG2_WORLD, (sass, mhz))
    for res in results:
        for line in res["lines"]:
            print(line)
    for name in ("sketch_fwd", "sketch_t"):
        n = [res["launches"][name] for res in results]
        check(all(x > 0 for x in n), f"{name} not launched on every rank: "
                                     f"{n}")
    return results


def _coords(rank: int, shape) -> tuple:
    """Row-major coordinates of ``rank`` on a grid of ``shape``."""
    return tuple(int(c) for c in np.unravel_index(rank, shape))


def two_grid_words(n, r, p, q, pc, qc, stage1=True) -> dict:
    """Words the rank at p-coordinates ``pc`` and q-coordinates ``qc``
    receives in one two-grid run, by kind (its second stage alone when
    ``stage1`` is False): Alg. 1's on p, its q-block of B (rows over q1,
    columns over (q3, q2)) less what its p-block (rows over (p1, p2),
    columns over p3) held, the q2 all-gather, the q1 reduce-scatter."""
    p1, p2, p3 = p
    q1, q2, q3 = q
    P = p1 * p2 * p3
    i, j, k = pc
    iq, jq, kq = qc
    held_r = ((i * p2 + j) * (n // (p1 * p2)), n // (p1 * p2))
    held_c = (k * (r // p3), r // p3)
    rows, cols = n // q1, r // (q2 * q3)
    want_r, want_c = (iq * rows, rows), ((kq * q2 + jq) * cols, cols)

    def span(a, b):
        return max(0, min(a[0] + a[1], b[0] + b[1]) - max(a[0], b[0]))

    words = {"all_gather": (q2 - 1) * n * r // (q1 * q2 * q3),
             "reduce_scatter": (q1 - 1) * r * r // (q1 * q2 * q3),
             "all_reduce": 0, "all_to_all": 0,
             "redistribute": rows * cols - span(held_r, want_r)
             * span(held_c, want_c)}
    if stage1:
        words["all_gather"] += (p3 - 1) * n * n // P
        words["reduce_scatter"] += (p2 - 1) * n * r // P
    return words


def _two_grid_rank(rank, world, sass, mhz):
    """Phase 14, one rank."""
    import torch.distributed as dist
    from repro_torch.core import nystrom as nys
    from repro_torch.core import sketch as sk
    from repro_torch.core.grid import select_two_grid_executable
    from repro_torch.core.sketch import _omega_tile_torch
    from repro_torch.kernels import local
    from repro_torch.kernels.sketch_matmul import (
        LAUNCHES, reset_launches, sketch_t_plan)
    from repro_torch.parallel import collectives as col
    from repro_torch.plan.model import fused_redistribute_words

    dev = torch.device("cuda", 0)
    P = world
    lines = []

    def say(msg):
        lines.append(f"[two-grid] rank {rank}: {msg}")

    A = make_matrix(dev)
    same_matrix(A, rank, world)
    # the check: the one-device port's pairs (sketch_fwd, then sketch_t),
    # and C of B under the second stages' salt
    one = {r: local.sketch_block(A, SEED, r) for r in (R, TG_R2)}
    C_one = {r: local.sketch_t_block(B, SEED, r) for r, B in one.items()}
    C_salt = local.sketch_t_block(one[R], SEED, R, salt=TG_SALT)
    torch.cuda.synchronize()
    g1 = sk.make_grid_groups(P, 1, 1)
    names = ("sketch_fwd", "sketch_t", "gen_omega")
    runs, launches, outs = {}, dict.fromkeys(names, 0), {}

    def drive(name, p, q, r, fn, gq, qc, fwd=1, C_full=None):
        dist.barrier()
        reset_launches()
        col.reset_comm()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        B, C = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: LAUNCHES[k] for k in names}
        words = {k: v["words"] for k, v in col.COMM.items()}
        peak = torch.cuda.max_memory_allocated()
        for k in names:
            launches[k] += counts[k]
        B_ref = nys.two_grid_block(one[r], gq, "B")
        C_ref = nys.two_grid_block(C_one[r] if C_full is None else C_full,
                                   gq, "C")
        check(B.shape == B_ref.shape and C.shape == C_ref.shape
              and bool(torch.isfinite(B).all() and torch.isfinite(C).all()),
              f"rank {rank}: {name}: B {tuple(B.shape)}, "
              f"C {tuple(C.shape)}")
        err_b, tol = rel_fro(B, B_ref), f32_tol(N)
        if p == (P, 1, 1):
            check(torch.equal(B, B_ref), f"rank {rank}: {name}: B is not "
                                         f"bitwise the one-device B's "
                                         f"q-block (rel_fro {err_b:.3e})")
            held = "bitwise"
        else:
            check(err_b <= tol, f"rank {rank}: {name}: B rel_fro "
                                f"{err_b:.3e} > f32_tol(n) {tol:.1e}")
            held = f"rel_fro {err_b:.3e}"
        err_c = rel_fro(C, C_ref)
        check(err_c <= tol, f"rank {rank}: {name}: C rel_fro {err_c:.3e} > "
                            f"f32_tol(n) {tol:.1e}")
        want = two_grid_words(N, r, p, q, _coords(rank, p), qc,
                              stage1=fwd > 0)
        check(words == want, f"rank {rank}: {name}: words received "
                             f"{words}, not {want}")
        table = TG_WORDS.get((p, q, r))
        if table is not None and fwd:
            check((want["redistribute"], sum(want.values())) == table,
                  f"rank {rank}: {name}: {want} against the table {table}")
        if gq.order is None:
            check(words["redistribute"]
                  <= fused_redistribute_words(N, r, p, q),
                  f"rank {rank}: {name}: Redistribute above the "
                  f"reference's min-cut")
        check(counts == {"sketch_fwd": fwd, "sketch_t": 1, "gen_omega": 0},
              f"rank {rank}: {name} launched {counts}")
        say(f"{name}: p {p} -> q {q}, r = {r}: B {tuple(B.shape)} {held} "
            f"the one-device B's q-block; C {tuple(C.shape)} rel_fro "
            f"{err_c:.3e} <= f32_tol(n) {tol:.1e}; words received "
            f"{sum(words.values())} ({words}); launches {counts}; wall "
            f"{wall:.4f} s; peak {peak / 2 ** 30:.2f} GiB")
        runs[name] = {"p": list(p), "q": list(q), "r": r, "words": words,
                      "b_rel_fro": err_b, "c_rel_fro": err_c,
                      "b_bitwise": held == "bitwise", "wall_s": wall,
                      "peak_gib": peak / 2 ** 30, "launches": counts}
        outs[name] = (B, C)

    def auto(r, q):
        def fn():
            B, C, gq, variant = nys.nystrom_auto(A, SEED, r,
                                                 variant="bound_driven")
            check((variant, gq.shape) == ("bound_driven", q),
                  f"nystrom_auto at r = {r} ran {variant} on {gq.shape}")
            return B, C
        return fn

    # bound-driven at r = 512: regime 1's pair, which is the 1-D Redist
    p, q = (P, 1, 1), (1, 1, P)
    check(select_two_grid_executable(N, R, P) == (p, q, True),
          f"bound-driven pair at r = {R}: "
          f"{select_two_grid_executable(N, R, P)}")
    gq = sk.make_grid_groups(*q)
    drive("auto", p, q, R, auto(R, q), gq, _coords(rank, q))
    B_x, C_x = nys.nystrom_redist(sk.input_block(A, g1), SEED, R, g1)
    check(torch.equal(outs["auto"][0], B_x)
          and torch.equal(outs["auto"][1], C_x),
          f"rank {rank}: bound-driven (4,1,1) -> (1,1,4) is not bitwise "
          f"nystrom_redist")
    say("bound-driven at r = 512 picked ((4,1,1), (1,1,4)); B and C "
        "bitwise phase 13's nystrom_redist blocks")
    del B_x, C_x
    # B and C gathered (uncounted) reconstruct A on rank 0
    rel = {}
    B_full = nys.two_grid_gather(outs["auto"][0], gq, "B")
    C_full = nys.two_grid_gather(outs["auto"][1], gq, "C")
    if rank == 0:
        rel["auto"] = float(nys.relative_error(A, B_full, C_full,
                                               rcond=NYSTROM_RCOND))
        check(math.isfinite(rel["auto"]) and rel["auto"] <= 1e-4,
              f"bound-driven: Nystrom relative error {rel['auto']}")
        say(f"bound-driven: Nystrom relative error ||A - B C+ B^T||/||A|| "
            f"= {rel['auto']:.3e} at rcond {NYSTROM_RCOND:g}")
    del B_full, C_full
    torch.cuda.empty_cache()
    for p, q in TG_PAIRS:
        blk = sk.input_block(A, sk.make_grid_groups(*p))
        drive(f"{p}->{q}", p, q, R,
              lambda: nys.nystrom_two_grid(blk, SEED, R, p=p, q=q),
              sk.make_grid_groups(*q), _coords(rank, q))
        del blk
    p, q = TG_FUSED
    blk = sk.input_block(A, sk.make_grid_groups(*p))
    drive("fused", p, q, R,
          lambda: nys.nystrom_two_grid_fused(blk, SEED, R, p=p, q=q),
          sk.make_grid_groups(*q), _coords(rank, q))
    check(all(torch.equal(a, b) for a, b in zip(outs["fused"],
                                                outs[f"{p}->{q}"])),
          f"rank {rank}: nystrom_two_grid_fused differs from "
          f"nystrom_two_grid on {p} -> {q}")
    del blk
    p, perm = TG_GENERAL
    g = sk.make_grid_groups(*p)
    gq = nys.permuted_grid_groups(g, perm)
    blk = sk.input_block(A, g)
    pc = _coords(rank, p)
    drive("general", p, gq.shape, R,
          lambda: nys.nystrom_general(blk, SEED, R, g, q_perm=perm), gq,
          tuple(pc[a] for a in perm))
    del blk
    # the streamed-finalize form: the one-device B's row blocks, a salt
    p, q = (P, 1, 1), (1, 2, 2)
    rows = nys.nystrom_block(one[R], g1, "no_redist")
    drive("stage2_fused", p, q, R,
          lambda: nys.nystrom_second_stage_two_grid_fused(
              rows, SEED, R, q, salt=TG_SALT),
          sk.make_grid_groups(*q), _coords(rank, q), fwd=0, C_full=C_salt)
    # regime 2: r = 2 < P; only the two-grid pair runs
    p, q = (P, 1, 1), (2, 1, 2)
    check(select_two_grid_executable(N, TG_R2, P)[:2] == (p, q),
          f"bound-driven pair at r = {TG_R2}: "
          f"{select_two_grid_executable(N, TG_R2, P)}")
    drive("auto_r2", p, q, TG_R2, auto(TG_R2, q), sk.make_grid_groups(*q),
          _coords(rank, q))
    refused = []
    for variant, fn in (("no_redist", nys.nystrom_no_redist),
                        ("redist", nys.nystrom_redist)):
        try:
            fn(sk.input_block(A, g1), SEED, TG_R2, g1)
        except ValueError as e:
            refused.append(f"{variant}: {e}")
        else:
            check(False, f"rank {rank}: {variant} ran at r = {TG_R2} < P")
    say(f"regime 2 (r = {TG_R2}) picked {(p, q)}; the 1-D variants refuse "
        f"({'; '.join(refused)})")
    outs.clear()
    dist.barrier()
    torch.cuda.empty_cache()

    # the collectives of the runs above alone, at their shapes: median of
    # three host-clock times between barriers, each ending in a synchronize
    def timed(fn):
        times = []
        for _ in range(3):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    comm_s = {}
    rows = rows.contiguous()
    src = [nys._b_p_rect(g1.coords_of(d), g1.shape, N, R) for d in range(P)]
    for q in ((1, 1, P), (1, 2, 2), (2, 1, 2)):
        gq = sk.make_grid_groups(*q)
        dst = [nys._q_rect(gq.coords_of(d), q, "B", N, R) for d in range(P)]
        comm_s[f"redistribute (4,1,1)->{q}"] = timed(
            lambda: col.redistribute(rows, src, dst, rank, gq.grid_group))
    gq = sk.make_grid_groups(1, 2, 2)
    b_q = nys.two_grid_block(one[R], gq, "B").contiguous()
    comm_s["all_gather of B over q2 = 2, q = (1,2,2)"] = timed(
        lambda: col.all_gather(b_q, 1, gq.p2_group, 2))
    g = sk.make_grid_groups(2, 2, 1)
    part = one[R][:N // 2].contiguous()
    comm_s["reduce_scatter of B over p2 = 2, p = (2,2,1)"] = timed(
        lambda: col.reduce_scatter(part, g.p2_group, 2))
    del rows, b_q, part
    say("collectives alone (gloo through host memory, CUDA tensors): "
        + ", ".join(f"{k} {v:.4f} s" for k, v in comm_s.items()))

    # sketch_t at the new second-stage shapes and sketch_fwd on its narrow
    # path, four ranks sharing the card; rank 0 alone splits the device
    # time into draw, product and reduce (the other ranks wait)
    calls = {"sketch_t": {}, "sketch_fwd": {}}
    i, j, k = _coords(rank, (1, 2, 2))
    i2, _, k2 = _coords(rank, (2, 1, 2))
    half = N // 2
    w = R // 2
    shapes = {
        "q=(1,2,2)": (one[R][:, k * w:(k + 1) * w], w, 0, j * w),
        "q=(2,1,2)": (one[R][i2 * half:(i2 + 1) * half,
                             k2 * w:(k2 + 1) * w], R, i2 * half, 0),
        "q=(2,1,2), r=2": (one[TG_R2][i2 * half:(i2 + 1) * half,
                                      k2:k2 + 1], TG_R2, i2 * half, 0)}
    for call, (view, cols, row0, col0) in shapes.items():
        Bb = view.contiguous()
        K, c = Bb.shape
        om = _omega_tile_torch(SEED, 0, row0, col0, K, cols, "normal", 0,
                               None, None, dev)

        def kernel():
            return local.sketch_t_block(Bb, SEED, cols, row0=row0,
                                        col0=col0)

        def plain_fn():
            return local._sketch_t_block_torch(Bb, SEED, cols, row0=row0,
                                               col0=col0)

        got, plain = kernel(), plain_fn()
        err, abs_err = rel_fro(got, plain), max_abs(got, plain)
        check(err <= f32_tol(K), f"rank {rank}: sketch_t ({call}) rel_fro "
                                 f"{err:.3e} vs plain")
        bms, by = bound_ms(2.0 * cols * K * c, 4.0 * (K * c + cols * c))
        calls["sketch_t"][call] = {
            "shape": f"{K}x{c} -> {cols}x{c} at ({row0},{col0})",
            "ms": time_ms(kernel), "plain_ms": time_ms(plain_fn, reps=3),
            "library_ms": time_ms(lambda: torch.matmul(om.T, Bb)),
            "bound_ms": bms, "bound_by": by,
            "draw_bound_ms": omega_ops_bound_ms(sass, K * cols, mhz)[0],
            **sketch_t_plan(cols, c, K), "max_abs_err": abs_err,
            "rel_fro": err}
        dist.barrier()
        if rank == 0:
            calls["sketch_t"][call]["device_ms"] = kernel_parts(
                kernel, "sketch_t_gemm_kernel")
        dist.barrier()
        del Bb, om, got, plain
    blk_in = sk.input_block(A, g1)
    m = blk_in.shape[0]
    om = _omega_tile_torch(SEED, 0, 0, 0, N, TG_R2, "normal", 0, None, None,
                           dev)

    def fwd_kernel():
        return local.sketch_block(blk_in, SEED, TG_R2)

    got = fwd_kernel()
    plain = local._sketch_block_torch(blk_in, SEED, TG_R2)
    err = rel_fro(got, plain)
    check(err <= f32_tol(N), f"rank {rank}: narrow sketch_fwd rel_fro "
                             f"{err:.3e} vs plain")
    bms, by = bound_ms(2.0 * m * N * TG_R2, 4.0 * (m * N + m * TG_R2))
    calls["sketch_fwd"]["regime 2"] = {
        "shape": f"{m}x{N} -> {m}x{TG_R2}", "ms": time_ms(fwd_kernel),
        "plain_ms": time_ms(lambda: local._sketch_block_torch(
            blk_in, SEED, TG_R2), reps=3),
        "library_ms": time_ms(lambda: torch.matmul(blk_in, om)),
        "bound_ms": bms, "bound_by": by, "max_abs_err": max_abs(got, plain),
        "rel_fro": err}
    dist.barrier()
    if rank == 0:
        calls["sketch_fwd"]["regime 2"]["device_ms"] = kernel_parts(
            fwd_kernel, "sketch_fwd_narrow_kernel")
    dist.barrier()
    del om, got, plain
    for name, by_call in calls.items():
        for call, rec in by_call.items():
            extra = ""
            if name == "sketch_t":
                extra = (f"; {rec['splits']} splits, Omega scratch "
                         f"{rec['scratch_bytes'] / 2 ** 20:.2f} MiB, work "
                         f"{rec['work_bytes'] / 2 ** 20:.2f} MiB; draw "
                         f"bound {rec['draw_bound_ms']:.4f} ms (SASS)")
            if "device_ms" in rec:
                extra += (f"; on the device, rank 0 alone "
                          f"(torch.profiler): {parts_text(rec['device_ms'])}")
            say(f"local kernel {name} ({call}) {rec['shape']} (four ranks "
                f"share the card): {rec['ms']:.4f} ms (plain "
                f"{rec['plain_ms']:.3f}, library {rec['library_ms']:.4f}, "
                f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}), "
                f"max_abs_err {rec['max_abs_err']:.3e}{extra}")
    say("wall time per call (gloo through host memory, not an "
        "interconnect time): " + ", ".join(
            f"{n} {r['wall_s']:.4f} s" for n, r in runs.items()))
    dist.barrier()
    return {"lines": lines, "runs": runs, "launches": launches,
            "calls": calls, "relative_error": rel, "collectives_s": comm_s}


def phase_two_grid(sass, mhz):
    """Phase 14: the two-grid Alg. 2 on TG_WORLD ranks of one card over
    gloo, each rank holding phase 1-5's A."""
    print(f"[two-grid] {TG_WORLD} ranks on cuda:0 over gloo (the "
          f"Redistribute is an uneven all_to_all_single of CUDA tensors; "
          f"gloo stages them through host memory itself): A {N}x{N} f32, "
          f"r = {R} and {TG_R2}: nystrom_auto(variant='bound_driven'), "
          f"nystrom_two_grid on {TG_PAIRS}, nystrom_two_grid_fused on "
          f"{TG_FUSED}, nystrom_general on {TG_GENERAL[0]} with its axes "
          f"permuted {TG_GENERAL[1]}, nystrom_second_stage_two_grid_fused "
          f"(salt {TG_SALT})")
    results = spawn_ranks(14, _two_grid_rank, TG_WORLD, (sass, mhz))
    for res in results:
        for line in res["lines"]:
            print(line)
    for name in ("sketch_fwd", "sketch_t"):
        n = [res["launches"][name] for res in results]
        check(all(x > 0 for x in n), f"{name} not launched on every rank: "
                                     f"{n}")
    return results


def _stream_dist_rank(rank, world, ckdir):
    """Phase 15, one rank."""
    import torch.distributed as dist
    from repro_torch.core import nystrom as nys
    from repro_torch.core import sketch as sk
    from repro_torch.core.grid import (alg1_bandwidth_words,
                                       select_two_grid_executable)
    from repro_torch.core.sketch import _omega_tile_torch
    from repro_torch.kernels import local
    from repro_torch.kernels.sketch_matmul import LAUNCHES, reset_launches
    from repro_torch.parallel import collectives as col
    from repro_torch.plan.model import stream_update_cost
    from repro_torch.serve import make_sketch_service
    from repro_torch.stream import (ShardedStreamingSketch, StreamConfig,
                                    StreamingSketch)
    from repro_torch.stream import distributed as sd

    dev = torch.device("cuda", 0)
    P = world
    lines = []

    def say(msg):
        lines.append(f"[stream-dist] rank {rank}: {msg}")

    A = make_matrix(dev)
    same_matrix(A, rank, world)
    cfg = StreamConfig(N, N, r=R, seed=SEED)
    L = cfg.sketch_l
    names = ("sketch_fwd", "sketch_t", "fold_rows")
    launches = dict.fromkeys(names, 0)
    walls = {}
    groups = {grid: sk.make_grid_groups(*grid)
              for grid in [(P, 1, 1)] + SD_GRIDS}
    g1, g221 = groups[(P, 1, 1)], groups[(2, 2, 1)]

    def drive(name, fn):
        """One run of the main path between barriers: counts reset just
        before it and read just after."""
        dist.barrier()
        reset_launches()
        col.reset_comm()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k in names:
            launches[k] += LAUNCHES[k]
        walls.setdefault(name, []).append(wall)
        return out, col.comm_words()

    slab_words = {}

    def stream(grid):
        st = ShardedStreamingSketch(cfg, groups[grid])
        words = []
        for s in SD_ORDER:
            r0 = s * SLAB
            words.append(drive(f"slab {grid}", lambda: st.update_rows(
                r0, A[r0:r0 + SLAB]))[1])
        slab_words[f"slab {grid}"] = words
        return st, words

    # (a) regime 1: the slabs out of order on (4,1,1)
    st_a, words_a = stream((P, 1, 1))
    B_one = local.sketch_block(A, SEED, R)
    one_blk = sk.rand_matmul(sk.input_block(A, g1), SEED, R, g1)
    check(torch.equal(one_blk, sk.output_block(B_one, g1)),
          f"rank {rank}: rand_matmul's (4,1,1) block is not bitwise the "
          f"one-device B's rows")
    check(torch.equal(st_a.Y, one_blk), f"rank {rank}: (a) Y block is not "
                                        f"bitwise rand_matmul's")
    solo = StreamingSketch(cfg)
    for s in SD_ORDER:
        solo.update_rows(s * SLAB, A[s * SLAB:(s + 1) * SLAB])
    check(torch.equal(st_a.W, solo.W), f"rank {rank}: (a) W is not bitwise "
                                       f"the one-device stream's")
    check(words_a == [0] * len(SD_ORDER), f"rank {rank}: (a) words {words_a}")
    del solo
    Y_a, W_a = sk.gather_output(st_a.Y, g1), sd.gather_corange(st_a.W, g1)
    say(f"(a) (4,1,1), {len(SD_ORDER)} slabs of {SLAB} rows in the order "
        f"{SD_ORDER}: Y block {tuple(st_a.Y.shape)} bitwise rand_matmul's "
        f"(bitwise the one-device B's rows); W {tuple(st_a.W.shape)} "
        f"bitwise a one-device StreamingSketch fed the same slabs; words "
        f"received 0 a slab")

    # (c) one full-shape update on (2,2,1)
    st_c = ShardedStreamingSketch(cfg, g221)
    _, words_c = drive("update (2,2,1)", lambda: st_c.update(A))
    blk_c = sk.rand_matmul(sk.input_block(A, g221), SEED, R, g221)
    check(torch.equal(st_c.Y, blk_c), f"rank {rank}: (c) Y block is not "
                                      f"bitwise rand_matmul's on (2,2,1)")
    want_c = (alg1_bandwidth_words(N, N, R, 2, 2, 1)
              + 2.0 * (1.0 - 1.0 / 2) * L * N / 2)
    check(words_c == want_c, f"rank {rank}: (c) {words_c} words received, "
                             f"not {want_c:.0f}")
    del blk_c
    say(f"(c) update(A) on (2,2,1): Y block {tuple(st_c.Y.shape)} bitwise "
        f"rand_matmul's; words received {words_c} == Alg. 1's "
        f"{alg1_bandwidth_words(N, N, R, 2, 2, 1):.0f} + the co-range "
        f"all-reduce {want_c - alg1_bandwidth_words(N, N, R, 2, 2, 1):.0f}")

    # (b) the same slabs on (2,2,1) and (1,2,2)
    for grid in SD_GRIDS:
        st, words = stream(grid)
        want = stream_update_cost(SLAB, N, R, L, grid=grid).words
        check(words == [want] * len(SD_ORDER),
              f"rank {rank}: (b) {grid} words {words}, not {want:.0f} a slab")
        g = groups[grid]
        err_y = rel_fro(sk.gather_output(st.Y, g), Y_a)
        err_w = rel_fro(sd.gather_corange(st.W, g), W_a)
        tol = f32_tol(N)
        check(err_y <= tol and err_w <= tol,
              f"rank {rank}: (b) {grid}: Y rel_fro {err_y:.3e}, W rel_fro "
              f"{err_w:.3e} against (a)'s, tol {tol:.1e}")
        same = ""
        if grid == (2, 2, 1):
            check(torch.equal(st.Y, st_c.Y), f"rank {rank}: (b) (2,2,1) Y "
                                             f"is not bitwise (c)'s")
            same = "; Y block bitwise (c)'s full-shape update"
        say(f"(b) {grid}: words received {words[0]:.0f} a slab == "
            f"stream_update_cost; Y rel_fro {err_y:.3e}, W rel_fro "
            f"{err_w:.3e} against (a)'s (tol {tol:.1e}){same}")
        del st
    del st_c

    # (d) the streamed Nystrom from (a)'s Y
    q = select_two_grid_executable(N, R, P, p=(P, 1, 1))[1]
    check(q == (1, 1, P), f"the bound-driven q-grid is {q}, not (1,1,{P})")
    gq = sk.make_grid_groups(*q)
    finals = {"auto": (P - 1) * R * R // P, "no_redist": (P - 1) * R * R // P,
              "redist": (P - 1) * N * R // P ** 2,
              "bound_driven": (P - 1) * N * R // P ** 2}
    pairs = {}
    for variant in SD_VARIANTS:
        (B, C), words = drive(f"nystrom {variant}",
                              lambda: st_a.nystrom(variant))
        B1, C1 = sd.nystrom_finalize(one_blk, cfg, g1, variant)
        check(torch.equal(B, B1) and torch.equal(C, C1),
              f"rank {rank}: (d) {variant}: not bitwise the second stage on "
              f"the one-shot blocks")
        B_ref = (nys.two_grid_block(B_one, gq, "B")
                 if variant == "bound_driven" else
                 nys.nystrom_block(B_one, g1, "redist" if variant == "redist"
                                   else "no_redist"))
        check(torch.equal(B, B_ref), f"rank {rank}: (d) {variant}: B is not "
                                     f"bitwise the one-device B's block")
        check(words == finals[variant], f"rank {rank}: (d) {variant}: "
                                        f"{words} words, not "
                                        f"{finals[variant]}")
        check(bool(torch.isfinite(C).all()), f"rank {rank}: (d) C")
        pairs[variant] = (B, C)
        say(f"(d) nystrom({variant!r}): B {tuple(B.shape)} bitwise the "
            f"one-device B's block, B and C {tuple(C.shape)} bitwise the "
            f"second stage on rand_matmul's blocks; words received {words}")
        del B1, C1

    # (e) save on (4,1,1), restore on (2,2,1)
    path, _ = drive("save", lambda: st_a.save(ckdir))
    st_e, _ = drive("restore",
                    lambda: ShardedStreamingSketch.restore(ckdir, g221))
    check(torch.equal(sk.gather_output(st_e.Y, g221), Y_a)
          and torch.equal(sd.gather_corange(st_e.W, g221), W_a)
          and st_e.num_updates == st_a.num_updates,
          f"rank {rank}: (e) the restored stream differs")
    say(f"(e) save on (4,1,1) ({path}), restore on (2,2,1): Y, W bitwise, "
        f"num_updates {st_e.num_updates}")
    del st_e, W_a

    # (f) a grid service: two streams, one resident
    svc = make_sketch_service(grid=(P, 1, 1), max_resident=1)
    sids, kept = [], []
    for seed in SD_SEEDS:
        sid = svc.open(StreamConfig(N, N, r=R, seed=seed))
        drive("service update", lambda: svc.update(sid, A))
        sids.append(sid)
        kept.append((svc.sketch(sid).clone(), svc.corange(sid).clone()))
    check(svc.num_evicted == 1 and svc.num_resident == 1,
          f"rank {rank}: (f) {svc.stats()}")
    check(torch.equal(kept[0][0], one_blk) and not torch.equal(*(
        k[0] for k in kept)), f"rank {rank}: (f) the streams' Y blocks")
    (B, C), words = drive("service nystrom redist",
                          lambda: svc.nystrom(sids[0], "redist"))
    check(torch.equal(svc.sketch(sids[0]), kept[0][0])
          and torch.equal(svc.corange(sids[0]), kept[0][1]),
          f"rank {rank}: (f) the restored stream is not bitwise")
    check(torch.equal(B, pairs["redist"][0])
          and torch.equal(C, pairs["redist"][1]),
          f"rank {rank}: (f) nystrom(sid, 'redist') is not bitwise (d)'s")
    say(f"(f) make_sketch_service(grid=(4,1,1), max_resident=1), streams "
        f"seeded {SD_SEEDS}: {svc.stats()}; the evicted stream restored "
        f"bitwise; nystrom(sid, 'redist') bitwise (d)'s, {words} words")
    del svc, kept, pairs, B, C, st_a, B_one, one_blk, Y_a
    torch.cuda.empty_cache()

    # the three kernels at this phase's shapes, four ranks sharing the card
    calls = {}

    def profiled(name, parts):
        """Rank 0 alone splits the device time (the other ranks wait)."""
        dist.barrier()
        if rank == 0:
            calls[name]["device_ms"] = parts()
        dist.barrier()

    H = A[:SLAB]
    om = _omega_tile_torch(SEED, 0, 0, 0, N, R, "normal", 0, None, None, dev)

    def fwd():
        return local.sketch_block(H, SEED, R, out_dtype=torch.float32)

    def fwd_plain():
        return local._sketch_block_torch(H, SEED, R,
                                         out_dtype=torch.float32)

    got, ref = fwd(), fwd_plain()
    err = rel_fro(got, ref)
    check(err <= f32_tol(N), f"rank {rank}: sketch_fwd rel_fro {err:.3e}")
    bms, by = bound_ms(2.0 * SLAB * N * R, 4.0 * (SLAB * N + SLAB * R))
    calls["sketch_fwd"] = {
        "shape": f"{SLAB}x{N} -> {SLAB}x{R} (a (4,1,1) slab's dY)",
        "ms": time_ms(fwd), "plain_ms": time_ms(fwd_plain, reps=3),
        "library_ms": time_ms(lambda: torch.matmul(H, om)),
        "bound_ms": bms, "bound_by": by, "max_abs_err": max_abs(got, ref),
        "rel_fro": err}
    profiled("sketch_fwd", lambda: kernel_parts(fwd,
                                                "sketch_fwd_gemm_kernel"))
    del om
    W = torch.zeros(L, N, device=dev)
    psi = _omega_tile_torch(SEED, 0, 0, 0, SLAB, L, "normal", cfg.psi_salt,
                            None, None, dev)

    def wup():
        return local.sketch_t_block(H, SEED, L, salt=cfg.psi_salt, acc=W)

    def wup_plain():
        return local._sketch_t_block_torch(H, SEED, L, salt=cfg.psi_salt,
                                           acc=W)

    got = local.sketch_t_block(H, SEED, L, salt=cfg.psi_salt)
    ref = local._sketch_t_block_torch(H, SEED, L, salt=cfg.psi_salt)
    err = rel_fro(got, ref)
    check(err <= f32_tol(SLAB), f"rank {rank}: sketch_t rel_fro {err:.3e}")
    bms, by = bound_ms(2.0 * SLAB * N * L, 4.0 * (SLAB * N + 2 * L * N))
    calls["sketch_t"] = {
        "shape": f"{SLAB}x{N} -> {L}x{N} += (a (4,1,1) slab's W update)",
        "ms": time_ms(wup), "plain_ms": time_ms(wup_plain, reps=3),
        "library_ms": time_ms(lambda: torch.addmm(W, psi.T, H)),
        "bound_ms": bms, "bound_by": by, "max_abs_err": max_abs(got, ref),
        "rel_fro": err}
    profiled("sketch_t", lambda: kernel_parts(wup, "sketch_t_gemm_kernel"))
    del W, psi, got, ref
    m = N // P
    gen = torch.Generator(device=dev).manual_seed(15)
    Yf = torch.randn(m, R, generator=gen, device=dev)
    dY = torch.randn(SLAB, R, generator=gen, device=dev)
    start = m - SLAB            # the slab meets the shard's second half

    def fold():
        return local.fold_rows_block(Yf, dY, start, nvalid=SLAB)

    ref = local._fold_rows_torch(Yf, dY, start, SLAB)
    fold()
    check(torch.equal(Yf, ref), f"rank {rank}: fold_rows is not bitwise its "
                                f"plain version at the shard fold")
    bms, by = bound_ms(0.0, 3.0 * 4 * SLAB * R)
    calls["fold_rows"] = {
        "shape": f"Y shard {m}x{R} += dY {SLAB}x{R} at start {start}",
        "ms": time_ms(fold),
        "plain_ms": time_ms(lambda: local._fold_rows_torch(Yf, dY, start,
                                                           SLAB), reps=3),
        "library_ms": time_ms(lambda: Yf.narrow(0, m - SLAB, SLAB)
                              .add_(dY)),
        "bound_ms": bms, "bound_by": by, "max_abs_err": 0.0}
    # on the device back to back (Y's rows and dY, 16 MiB, stay in the
    # L2), and with a 256 MiB read before each call
    flush = torch.empty(64 * 2 ** 20, device=dev)
    profiled("fold_rows", lambda: {
        "fold": device_ms(fold, "fold_rows_kernel"),
        "fold, L2 flushed": device_ms(fold, "fold_rows_kernel",
                                      before=flush.sum)})
    del flush
    for name, c in calls.items():
        dev_txt = ("" if "device_ms" not in c else
                   f"; on the device, rank 0 alone (torch.profiler): "
                   f"{parts_text(c['device_ms'])}")
        say(f"local kernel {name} {c['shape']} (four ranks share the "
            f"card): {c['ms']:.4f} ms (plain {c['plain_ms']:.3f}, library "
            f"{c['library_ms']:.4f}, bound {c['bound_ms']:.4f} ms by "
            f"{c['bound_by']}), max_abs_err {c['max_abs_err']:.3e}{dev_txt}")
    say("wall time per run (gloo through host memory, not an interconnect "
        "time): " + "; ".join(
            f"{k} " + ", ".join(f"{w:.4f}" for w in v) + " s"
            for k, v in walls.items()))
    say(f"launches over the phase's runs: {launches}")
    dist.barrier()
    return {"lines": lines, "launches": launches, "calls": calls,
            "walls": walls, "slab_words": slab_words}


def phase_stream_dist():
    """Phase 15: distributed streaming on SD_WORLD ranks of one card over
    gloo, each rank holding phase 1-5's A."""
    import shutil
    import tempfile
    print(f"[stream-dist] {SD_WORLD} ranks on cuda:0 over gloo (the "
          f"all-reduces take CUDA tensors): A {N}x{N} f32, r = {R}, "
          f"l = {2 * R + 1}: update_rows of {len(SD_ORDER)} slabs of {SLAB} "
          f"rows on (4,1,1) and {SD_GRIDS}, update on (2,2,1), the streamed "
          f"Nystrom {SD_VARIANTS}, save / restore, a grid service")
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_phase15_")
    try:
        results = spawn_ranks(15, _stream_dist_rank, SD_WORLD, (ckdir,))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    for res in results:
        for line in res["lines"]:
            print(line)
    for name in ("sketch_fwd", "sketch_t", "fold_rows"):
        n = [res["launches"][name] for res in results]
        check(all(x > 0 for x in n), f"{name} not launched on every rank: "
                                     f"{n}")
    return results


def cost_record(phase: int, call: str, cost, seconds: float,
                counted_words: float = 0.0) -> dict:
    """One measured call beside its analytic cost (``plan.model``): the
    record ``calibrate_machine_model`` reads, with the words the phase
    counted (``counted_words``) for check (a)."""
    return {"phase": phase, "call": call, "words": cost.words,
            "messages": cost.messages, "flops": cost.flops,
            "hbm_words": cost.hbm_words, "itemsize": 4, "seconds": seconds,
            "counted_words": counted_words}


def times(cost, n: int):
    """``n`` calls of one cost, back to back."""
    return dataclasses.replace(cost, words=n * cost.words,
                               messages=n * cost.messages,
                               flops=n * cost.flops,
                               hbm_words=n * cost.hbm_words)


def slowest(results, name: str, field: str = "wall_s"):
    """The largest of a run's ``field`` over the ranks (for walls: the
    slowest rank's, each between a barrier and a synchronize)."""
    return max(res["runs"][name][field] for res in results)


def alg1_records(results) -> list:
    """Phase 12's runs beside ``alg1_cost`` (``alg1_communicating_cost``
    for the baseline)."""
    from repro_torch.plan import alg1_communicating_cost, alg1_cost
    out = []
    for name, run in results[0]["runs"].items():
        fn = (alg1_communicating_cost if name == "communicating"
              else alg1_cost)
        out.append(cost_record(
            12, f"alg1 {name} on {tuple(run['grid'])}",
            fn(N, N, R, tuple(run["grid"])), slowest(results, name),
            slowest(results, name, "words")))
    return out


def alg2_records(results, world: int) -> list:
    """Phase 13's runs beside ``alg2_cost`` (No-Redist, p == q) or
    ``alg2_fused_cost`` (Redist: the all-to-all priced at what moves)."""
    from repro_torch.plan import alg2_cost, alg2_fused_cost
    p = (world, 1, 1)
    out = []
    for name, run in results[0]["runs"].items():
        q = p if run["variant"] == "no_redist" else (1, 1, world)
        fn = alg2_cost if q == p else alg2_fused_cost
        out.append(cost_record(13, f"alg2 {name} {p}->{q}", fn(N, R, p, q),
                               slowest(results, name),
                               slowest(results, name, "words")))
    return out


def two_grid_records(results) -> list:
    """Phase 14's runs of both stages beside ``alg2_fused_cost`` (the
    second stage alone has no cost function and makes no record)."""
    from repro_torch.plan import alg2_fused_cost
    out = []
    for name, run in results[0]["runs"].items():
        if run["launches"]["sketch_fwd"] == 0:
            continue
        p, q, r = tuple(run["p"]), tuple(run["q"]), run["r"]
        words = max(sum(res["runs"][name]["words"].values())
                    for res in results)
        out.append(cost_record(14, f"two-grid {name} (p {p}, q {q}, r {r})",
                               alg2_fused_cost(N, r, p, q),
                               slowest(results, name), words))
    return out


def stream_dist_records(results, l: int) -> list:
    """Phase 15's slabs beside ``stream_update_cost``, one record a slab
    (the slowest rank's wall)."""
    from repro_torch.plan import stream_update_cost
    out = []
    for name, words in results[0]["slab_words"].items():
        grid = tuple(int(x) for x in name[len("slab ("):-1].split(","))
        cost = stream_update_cost(SLAB, N, R, l, grid=grid)
        for i, s in enumerate(SD_ORDER):
            out.append(cost_record(
                15, f"update_rows slab {s} on {grid}", cost,
                max(res["walls"][name][i] for res in results),
                max(res["slab_words"][name][i] for res in results)))
    return out


def phase_records(records: list, card: str):
    """Checks on the calibration records: (a) a record's words are the
    words its phase counted; (b) its local floor on the H100 entry,
    max(flops / flop_rate, hbm_words·4 / hbm_bw), is at most its measured
    seconds; (c) ``save_sweep`` / ``load_sweep`` round-trip them under
    ``build/repro_torch/``; (d) ``calibrate_machine_model`` fits a finite,
    positive alpha and byte_bw (printed beside the committed entry's, and
    each record's predicted / measured seconds on both); (e)
    ``probe_machine()`` is the H100 entry and ``device_kind_tag()`` the
    card's name from nvidia-smi with underscores.  Each record gets the
    card's ``device_kind`` and power limit."""
    from repro_torch.plan import (H100_GLOO, PRESETS,
                                  calibrate_machine_model, device_kind_tag,
                                  load_sweep, probe_machine, save_sweep)
    h100 = PRESETS[H100_GLOO]
    name, power = (x.strip() for x in card.split(",", 1))
    tag = device_kind_tag()
    check(probe_machine() == h100, f"(e) probe_machine() is "
                                   f"{probe_machine()}, not {H100_GLOO}")
    check(tag == name.replace(" ", "_"),
          f"(e) device_kind_tag() {tag!r} against nvidia-smi's {name!r}")
    props = torch.cuda.get_device_properties(0)
    smem = getattr(props, "shared_memory_per_multiprocessor", None)
    print(f"[records] (e) probe_machine() is {H100_GLOO}; "
          f"device_kind_tag() {tag}; the card: total_memory "
          f"{props.total_memory} (entry {h100.hbm_bytes}), shared memory "
          f"per SM {smem} (entry {h100.smem_bytes})")
    for rec in records:
        rec.update(device_kind=tag, power_limit=power)
        check(rec["words"] == rec["counted_words"],            # (a)
              f"(a) {rec['call']}: {rec['words']} words priced, "
              f"{rec['counted_words']} counted")
        floor = max(rec["flops"] / h100.flop_rate,
                    rec["hbm_words"] * rec["itemsize"] / h100.hbm_bw)
        check(floor <= rec["seconds"],                         # (b)
              f"(b) {rec['call']}: local floor {floor:.6f} s above the "
              f"measured {rec['seconds']:.6f} s")
    SWEEP_PATH.parent.mkdir(parents=True, exist_ok=True)      # (c)
    save_sweep(records, SWEEP_PATH)
    check(load_sweep(SWEEP_PATH) == records, "(c) the sweep's round trip")
    fit = calibrate_machine_model(records, base=h100)         # (d)
    check(all(math.isfinite(x) and x > 0 for x in (fit.alpha, fit.byte_bw)),
          f"(d) the fit: alpha {fit.alpha}, byte_bw {fit.byte_bw}")
    informative = sum(r["words"] > 0 or r["messages"] > 0 for r in records)
    kept = [t for t, v, b in (("alpha", fit.alpha, h100.alpha),
                              ("byte_bw", fit.byte_bw, h100.byte_bw))
            if v == b]
    note = (f"; the fit of {', '.join(kept)} was not positive: the "
            f"committed value kept" if kept else "")
    print(f"[records] (a)-(c): {len(records)} records ({informative} with "
          f"words or messages) written to {SWEEP_PATH.relative_to(ROOT)}; "
          f"words equal the counted words, local floors below the walls")
    print(f"[records] (d) calibrate_machine_model: alpha {fit.alpha!r} s, "
          f"byte_bw {fit.byte_bw!r} B/s ({2 ** 20 / fit.byte_bw * 1e3:.3f} "
          f"ms a MiB){note}; the committed {H100_GLOO}: alpha "
          f"{h100.alpha!r} s, byte_bw {h100.byte_bw!r} B/s")
    for rec in records:
        print(f"[records]   phase {rec['phase']} {rec['call']}: measured "
              f"{rec['seconds']:.6f} s; predicted / measured "
              f"{_seconds(rec, h100) / rec['seconds']:.3f} (committed), "
              f"{_seconds(rec, fit) / rec['seconds']:.3f} (this fit)")
    return fit


def _seconds(rec: dict, machine) -> float:
    from repro_torch.plan import Cost
    cost = Cost(words=rec["words"], flops=rec["flops"],
                messages=rec["messages"], hbm_words=rec["hbm_words"])
    return cost.seconds(machine, rec["itemsize"])


def sparse_coo(rng, k: int, n2: int, distinct: int, repeats: int):
    """(row, col, val) of one COO slab of a (k, n2) block: ``distinct``
    coordinates with standard-normal values, ``repeats`` more entries on
    coordinates already drawn (new values), the whole shuffled."""
    idx = rng.choice(k * n2, size=distinct, replace=False)
    val = rng.standard_normal(distinct, dtype=np.float32)
    idx = np.concatenate([idx, idx[rng.integers(0, distinct, repeats)]])
    val = np.concatenate([val, rng.standard_normal(repeats,
                                                   dtype=np.float32)])
    order = rng.permutation(idx.size)
    idx, val = idx[order], val[order]
    return (idx // n2).astype(np.int32), (idx % n2).astype(np.int32), val


def plain_sparse_update(state, local, cfg, Y, W, row0, sp) -> None:
    """``update_rows_sparse``'s folds through the plain wave form, on the
    card (the draws are the update's own: gen_omega, counted)."""
    from repro_torch.core.sketch import seed_keys
    for acc, dest, val, kw in state.sparse_update_folds(
            cfg, seed_keys(cfg.seed), Y, W, row0, sp):
        acc.copy_(local._sparse_fold_torch(acc, dest, val, **kw))


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(_bits(a), _bits(b))


def sparse_service(state, SparseRows):
    """(e): 16 streams of the serving shape, two batches of 8 lanes (one
    all normal, one all countsketch), one 256-row slab a lane with nnz
    from 1 to 65536: update_sparse_batch lane i must be bitwise
    update_sparse on a second service and update_rows_sparse alone."""
    from repro_torch.stream import SketchService, StreamingSketch
    rng = np.random.default_rng(16)
    svc, one = SketchService(), SketchService()
    lanes = len(SP_LANE_NNZ)
    row0s = [i * ((S_N1 - SP_LANE_K) // lanes) for i in range(lanes)]
    for kind, seeds in (("normal", range(0, 8)),
                        ("countsketch", range(8, 16))):
        cfgs = [state.StreamConfig(S_N1, S_N2, r=S_R, seed=s, kind=kind)
                for s in seeds]
        sps = [SparseRows(*sparse_coo(rng, SP_LANE_K, S_N2, nnz, 0),
                          (SP_LANE_K, S_N2)) for nnz in SP_LANE_NNZ]
        sids = [svc.open(c) for c in cfgs]
        ones = [one.open(c) for c in cfgs]
        svc.update_sparse_batch(sids, sps, row0=row0s)
        for i, (c, sp, r0) in enumerate(zip(cfgs, sps, row0s)):
            one.update_sparse(ones[i], sp, row0=r0)
            solo = StreamingSketch(c).update_rows_sparse(r0, sp)
            lane = (svc.sketch(sids[i]), svc.corange(sids[i]))
            for other in ((one.sketch(ones[i]), one.corange(ones[i])),
                          (solo.Y, solo.W)):
                check(all(torch.isfinite(x).all().item() for x in lane),
                      "non-finite sparse lane state")
                check(_same(lane[0], other[0]) and _same(lane[1], other[1]),
                      f"sparse lane {i} ({kind}) differs from its solo "
                      f"update")
        print(f"[sparse] (e) service: 8 {kind} lanes ({S_N1}x{S_N2}, "
              f"r={S_R}, l={cfgs[0].sketch_l}), {SP_LANE_K}-row slabs of "
              f"nnz {list(SP_LANE_NNZ)} at rows {row0s}: "
              f"update_sparse_batch == update_sparse == update_rows_sparse, "
              f"Y and W bitwise")


NAN_BITS = {torch.float32: (0x7FC00001, -0x3FFFFF),      # 0xFFC00001
            torch.bfloat16: (0x7FC1, -0x3F)}               # 0xFFC1


def sparse_edge_case(dev, dtype, form, axis, from_zero, long_nnz):
    """(g)'s operands: SP_EDGE segments (not a multiple of the tile's 32 or
    64 columns; 1025 elements, one row past 32·32), entries only in
    segments 0-31 and 96-99 (so 32-95 are tiles with no entry in float32
    and untouched columns of a touched tile in bfloat16), ``long_nnz`` of
    them in segment 5; -0.0 in acc and val; unless ``from_zero`` (which
    rewrites every element through arithmetic) NaN bits of two payloads
    and both signs in untouched segments and, for the cell form, in
    element 1024, which no entry names."""
    rng = np.random.default_rng(17)
    nseg, width = SP_EDGE
    acc = torch.from_numpy(rng.standard_normal(
        (nseg, width) if axis == 0 else (width, nseg), dtype=np.float32))
    acc = acc.to(dev, dtype)
    seg = acc if axis == 0 else acc.T
    seg[40, :7] = -0.0
    seg[3, 9] = -0.0
    if not from_zero:
        ib = seg.view(torch.int32 if dtype == torch.float32 else torch.int16)
        for s in (33, 70):
            ib[s, 0], ib[s, 1000] = NAN_BITS[dtype]
        if form == "cell":
            ib[:, width - 1] = NAN_BITS[dtype][0]
    dest = np.concatenate([rng.integers(0, 32, 3000), np.full(long_nnz, 5),
                           rng.integers(96, 100, 500)])
    dest = torch.from_numpy(rng.permutation(dest)).to(dev)
    nnz = dest.numel()
    val = torch.from_numpy(rng.standard_normal(nnz, dtype=np.float32))
    val = val.to(dev, dtype)
    val[:4] = -0.0
    if form == "table":
        ops = {"table": torch.from_numpy(rng.standard_normal(
                   (257, width), dtype=np.float32)).to(dev, dtype),
               "src": torch.from_numpy(rng.integers(0, 257, nnz)).to(dev)}
    else:
        ops = {"cell": torch.from_numpy(rng.integers(0, width - 1, nnz))
               .to(dev),
               "coef": torch.from_numpy(rng.choice(
                   [-1.0, 0.0, 1.0, 3.5], nnz).astype(np.float32))
               .to(dev, dtype)}
    return acc, dest, val, ops


def sparse_edges(dev, local) -> int:
    """(g): S1 bitwise its plain wave form on the card at every edge case,
    the long segment in the settings the stream uses (W into itself along
    axis 1, Y from zero along axis 0).  Returns the cases run."""
    cases = [(dt, form, axis, fz, SP_EDGE_NNZ[0])
             for dt in (torch.float32, torch.bfloat16)
             for form in ("table", "cell") for axis in (0, 1)
             for fz in (True, False)]
    cases += [(torch.float32, "table", 1, False, SP_EDGE_NNZ[1]),
              (torch.bfloat16, "cell", 0, True, SP_EDGE_NNZ[1])]
    for dt, form, axis, fz, n in cases:
        acc, dest, val, ops = sparse_edge_case(dev, dt, form, axis, fz, n)
        ref = local._sparse_fold_torch(acc, dest, val, axis=axis,
                                       from_zero=fz, **ops)
        got = local.sparse_fold_block(acc.clone(), dest, val, axis=axis,
                                      from_zero=fz, **ops)
        again = local.sparse_fold_block(acc.clone(), dest, val, axis=axis,
                                        from_zero=fz, **ops)
        check(_same(got, ref) and _same(again, got),
              f"(g) S1 differs from its plain version or from itself at "
              f"the tile's edges ({dt}, {form}, axis {axis}, from_zero "
              f"{fz}, a segment of {n} entries)")
    print(f"[sparse] (g) S1 at the tile's edges ({SP_EDGE[0]} segments of "
          f"{SP_EDGE[1]} elements, empty tiles, -0.0 and NaN bits in "
          f"untouched columns, segments of {SP_EDGE_NNZ[0]} and "
          f"{SP_EDGE_NNZ[1]} entries): {len(cases)} cases over both forms, "
          f"axes, from_zero and dtypes, bitwise the plain wave form on the "
          f"card and run to run")
    return len(cases)


def sparse_stages(state, local, st, row0, sp) -> dict:
    """``update_rows_sparse`` replayed stage by stage, each stage ended by
    a synchronize (``time.perf_counter_ns``, median of SP_STAGE_REPS):
    ``SparseRows.validate``, ``_entries``' copies to the card, the draws
    (the Omega and Psi tiles), the CSR builds (``sparse_fold_operands``,
    Y's and W's) and S1's two launches.  The replay must leave Y and W
    bitwise what ``update_rows_sparse`` leaves on a copy of the stream."""
    from repro_torch.kernels.sketch_matmul import sparse_fold_cuda
    cfg, dev = st.cfg, st.Y.device
    k = sp.shape[0]
    sync, ns = torch.cuda.synchronize, time.perf_counter_ns

    def replay(Y, W):
        sync()
        t0 = ns()
        sp.validate(cfg, row0)
        t1 = ns()
        row, col, val = state._entries(sp, dev, cfg.dtype)
        sync()
        t2 = ns()
        om = state.omega_tile(st.keys, 0, 0, cfg.n2, cfg.r, cfg.kind,
                              cfg.dtype, salt=cfg.omega_salt, device=dev)
        psi = state.omega_tile(st.keys, row0, 0, k, cfg.sketch_l, cfg.kind,
                               cfg.dtype, salt=cfg.psi_salt, n_total=cfg.n1,
                               device=dev)
        sync()
        t3 = ns()
        ptr_y, ops_y = local.sparse_fold_operands(row, k, val, col)
        ptr_w, ops_w = local.sparse_fold_operands(col, cfg.n2, val, row)
        sync()
        t4 = ns()
        sparse_fold_cuda(Y[row0:row0 + k], ptr_y, table=om, from_zero=True,
                         **ops_y)
        sparse_fold_cuda(W, ptr_w, table=psi, axis=1, **ops_w)
        sync()
        t5 = ns()
        return {"validate": t1 - t0, "entries": t2 - t1, "draws": t3 - t2,
                "csr": t4 - t3, "s1": t5 - t4, "sum": t5 - t0}

    a = (st.Y.clone(), st.W.clone())
    b = (st.Y.clone(), st.W.clone())
    replay(*a)
    ref = state.StreamingSketch(cfg)
    ref.Y.copy_(b[0])
    ref.W.copy_(b[1])
    ref.update_rows_sparse(row0, sp)
    check(_same(a[0], ref.Y) and _same(a[1], ref.W),
          "the staged replay of update_rows_sparse differs from it")
    del b, ref
    runs = [replay(*a) for _ in range(SP_STAGE_REPS)]
    return {name: statistics.median(r[name] for r in runs) / 1e6
            for name in runs[0]}


def sparse_bound(sp, r: int, l: int) -> tuple:
    """S1's least time for one slab's two launches (this slab's data): the
    bytes a fold must move — each distinct table row it gathers read once
    (Omega's rows at the slab's columns, Psi's at its rows), the slab's k
    rows of Y read and written, W's touched columns read and written, the
    CSR payload (ptr, and a 4-byte index and value an entry, a launch) —
    against 2·nnz·(r + l) FLOPs.  Returns (ms, by, bytes, the draws' tile
    bytes)."""
    k, n2 = sp.shape
    ucols = np.unique(sp.col).size
    urows = np.unique(sp.row).size
    nbytes = 4.0 * (ucols * r + 2 * k * r + (k + 1) + 2 * sp.nnz
                    + urows * l + 2 * ucols * l + (n2 + 1) + 2 * sp.nnz)
    ms, by = bound_ms(2.0 * sp.nnz * (r + l), nbytes)
    return ms, by, nbytes, 4.0 * (n2 * r + k * l)


def phase_sparse(dev, LAUNCHES, reset_launches):
    """Phase 16: sparse COO row slabs of the local stream through S1, at
    phases 1-5's width (A = 32768², r = 512, l = 1025, seed 7)."""
    from repro_torch.kernels import local
    from repro_torch.kernels.sketch_matmul import sparse_fold_cuda
    from repro_torch.plan import sparse_payload_words
    from repro_torch.stream import SparseRows, StreamingSketch
    from repro_torch.stream import state
    rng = np.random.default_rng(0)
    slabs = {s: SparseRows(*sparse_coo(rng, SLAB, N, SP_DISTINCT, SP_REPEATS),
                           (SLAB, N)) for s in range(N // SLAB)}
    nnz = slabs[0].nnz
    print(f"[sparse] 8 COO slabs of {SLAB}x{N}: {nnz} entries each "
          f"({SP_DISTINCT} distinct coordinates + {SP_REPEATS} repeats, "
          f"density {nnz / (SLAB * N):.3e}); sparse_payload_words "
          f"{sparse_payload_words(nnz):.0f} against the dense slab's "
          f"{SLAB * N}")
    cfgs = {kind: state.StreamConfig(N, N, r=R, seed=SEED, kind=kind)
            for kind in SP_KINDS}
    L = cfgs["normal"].sketch_l

    def feed(kind, snaps=None):
        st = StreamingSketch(cfgs[kind])
        for i, s in enumerate(SD_ORDER):
            st.update_rows_sparse(s * SLAB, slabs[s])
            if snaps is not None and i < (2 if kind == "normal" else 1):
                snaps[(kind, i)] = (st.Y.clone(), st.W.clone())
        return st

    # -- the main path: counts set to 0 just before, read just after -------
    snaps = {}
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    streams = {kind: feed(kind, snaps) for kind in SP_KINDS}
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    dense_kinds = sum(k not in ("countsketch", "rowsample") for k in SP_KINDS)
    want = {"sparse_fold": 2 * len(SP_KINDS) * len(SD_ORDER),
            "gen_omega": 2 * dense_kinds * len(SD_ORDER),
            "sketch_fwd": 0, "sketch_t": 0}
    print(f"[sparse] main path: {len(SP_KINDS)} streams {SP_KINDS} x "
          f"{len(SD_ORDER)} slabs in order {SD_ORDER} through "
          f"update_rows_sparse in {t_main:.3f} s; launches {counts} (the "
          f"design: 2 sparse_fold an update, 2 gen_omega a dense-kind "
          f"update, no sketch_fwd or sketch_t)")
    for name, n in want.items():                            # (f)
        check(counts[name] == n, f"(f) {name} launched {counts[name]} "
                                 f"times, the design says {n}")
    for kind, st in streams.items():
        check(torch.isfinite(st.Y).all().item()
              and torch.isfinite(st.W).all().item(),
              f"non-finite sparse stream state ({kind})")

    # -- (a) kernel vs plain, bitwise, on the card ---------------------------
    worst = 0.0
    for kind in SP_KINDS:
        cfg = cfgs[kind]
        Y = torch.zeros(N, R, device=dev)
        W = torch.zeros(L, N, device=dev)
        for i, s in enumerate(SD_ORDER[:2 if kind == "normal" else 1]):
            plain_sparse_update(state, local, cfg, Y, W, s * SLAB, slabs[s])
            gY, gW = snaps[(kind, i)]
            same = _same(gY, Y) and _same(gW, W)
            worst = max(worst, max_abs(gY, Y), max_abs(gW, W))
            print(f"[sparse] (a) {kind}: after slab {i + 1} (rows "
                  f"{s * SLAB}:{(s + 1) * SLAB}) Y and W bitwise the plain "
                  f"wave form on the card: {same}")
            check(same, f"(a) S1 differs from its plain version ({kind}, "
                        f"slab {i + 1})")
        del Y, W
    snaps.clear()

    # -- (b) against the densified slabs through update_rows -----------------
    dense = {kind: StreamingSketch(cfgs[kind]) for kind in SP_KINDS}
    for s in SD_ORDER:
        Hd = torch.from_numpy(slabs[s].to_dense()).to(dev)
        for st in dense.values():
            st.update_rows(s * SLAB, Hd)
    del Hd
    for kind in SP_KINDS:
        eY = rel_fro(streams[kind].Y, dense[kind].Y)
        eW = rel_fro(streams[kind].W, dense[kind].W)
        path = ("sketch_fwd / sketch_t" if kind == "normal"
                else "H @ omega_matrix")
        print(f"[sparse] (b) {kind}: against to_dense() through update_rows "
              f"({path}): Y rel_fro {eY:.3e} (tol {f32_tol(N):.1e}), W "
              f"rel_fro {eW:.3e} (tol {f32_tol(SLAB):.1e})")
        check(eY <= f32_tol(N) and eW <= f32_tol(SLAB),
              f"(b) the sparse {kind} stream disagrees with the dense path")
    del dense

    # -- (c) run to run, (d) bf16 ---------------------------------------------
    again = feed("normal")
    same = (_same(again.Y, streams["normal"].Y)
            and _same(again.W, streams["normal"].W))
    print(f"[sparse] (c) the normal stream fed again from zero: bitwise "
          f"{same}")
    check(same, "(c) two runs of the sparse stream differ")
    del again
    cfg16 = state.StreamConfig(N, N, r=R, seed=SEED, dtype=torch.bfloat16)
    st16 = StreamingSketch(cfg16)
    s0 = SD_ORDER[0]
    st16.update_rows_sparse(s0 * SLAB, slabs[s0])
    Y16 = torch.zeros(N, R, dtype=torch.bfloat16, device=dev)
    W16 = torch.zeros(L, N, dtype=torch.bfloat16, device=dev)
    plain_sparse_update(state, local, cfg16, Y16, W16, s0 * SLAB, slabs[s0])
    same = _same(st16.Y, Y16) and _same(st16.W, W16)
    print(f"[sparse] (d) a bfloat16 normal stream's first slab bitwise the "
          f"plain wave form on the card: {same}")
    check(same, "(d) the bfloat16 sparse update differs from its plain "
                "version")
    del st16, Y16, W16

    # -- (e) the service, (g) the tile's edges --------------------------------
    sparse_service(state, SparseRows)
    edge_cases = sparse_edges(dev, local)

    # -- timings at one full-width normal slab --------------------------------
    cfg, sp, row0 = cfgs["normal"], slabs[s0], s0 * SLAB
    st = StreamingSketch(cfg)
    folds = state.sparse_update_folds(cfg, st.keys, st.Y, st.W, row0, sp)
    parts = {}
    for part, (acc, dest, val, kw) in zip(("Y", "W"), folds):
        axis = kw.get("axis", 0)
        ptr, ops = local.sparse_fold_operands(dest, acc.shape[axis], val,
                                              kw["src"])
        work = acc.clone()
        k_ms = time_ms(lambda: sparse_fold_cuda(
            work, ptr, table=kw["table"], axis=axis,
            from_zero=kw.get("from_zero", False), **ops))
        w_ms = time_ms(lambda: local.sparse_fold_block(work, dest, val, **kw))
        p_ms = time_ms(lambda: local._sparse_fold_torch(acc, dest, val,
                                                        **kw), reps=3)
        dev_ms = device_ms(lambda: sparse_fold_cuda(
            work, ptr, table=kw["table"], axis=axis,
            from_zero=kw.get("from_zero", False), **ops),
            "sparse_fold_")
        parts[part] = {"ms": k_ms, "wrapper_ms": w_ms, "plain_ms": p_ms,
                       "profiler_ms": dev_ms}
        del work
    # the library call: torch.sparse.mm of the slab as a COO tensor with the
    # materialized Omega (Y) and of H^T with Psi's rows (W), coalesced first
    row = torch.from_numpy(sp.row).to(dev, torch.int64)
    col = torch.from_numpy(sp.col).to(dev, torch.int64)
    val = torch.from_numpy(sp.val).to(dev)
    Hs = torch.sparse_coo_tensor(torch.stack([row, col]), val, (SLAB, N),
                                 check_invariants=True).coalesce()
    HsT = torch.sparse_coo_tensor(torch.stack([col, row]), val, (N, SLAB),
                                  check_invariants=True).coalesce()
    om, psi = folds[0][3]["table"], folds[1][3]["table"]
    lib_y = time_ms(lambda: torch.sparse.mm(Hs, om))
    lib_w = time_ms(lambda: torch.sparse.mm(HsT, psi))
    del Hs, HsT, row, col, val, folds, om, psi

    def wall(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)
    upd_wall = wall(lambda: st.update_rows_sparse(row0, sp))
    stages = sparse_stages(state, local, st, row0, sp)
    Yp, Wp = st.Y.clone(), st.W.clone()
    plain_wall = wall(lambda: plain_sparse_update(state, local, cfg, Yp, Wp,
                                                  row0, sp), reps=3)
    del Yp, Wp
    Hd = torch.from_numpy(sp.to_dense()).to(dev)
    dense_ms = time_ms(lambda: st.update_rows(row0, Hd))
    dense_wall = wall(lambda: st.update_rows(row0, Hd))
    del Hd, st
    b_ms, b_by, b_bytes, tile_bytes = sparse_bound(sp, R, L)
    with_draw = bound_ms(0.0, b_bytes + tile_bytes)[0]
    s1_ms = parts["Y"]["ms"] + parts["W"]["ms"]
    plain_ms = parts["Y"]["plain_ms"] + parts["W"]["plain_ms"]
    for part, t in parts.items():
        print(f"[timing] sparse_fold {part} part (one {SLAB}-row slab, "
              f"{nnz} entries): {t['ms']:.4f} ms a launch (CUDA events; "
              f"torch.profiler "
              + ("none" if t["profiler_ms"] is None
                 else f"{t['profiler_ms']:.4f}")
              + f"), the wrapper with its CSR build {t['wrapper_ms']:.4f} "
              f"ms, the plain wave form {t['plain_ms']:.3f} ms")
    print(f"[timing] sparse_fold Y + W {s1_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms by {b_by} ({b_bytes / 1e6:.1f} MB; "
          f"{with_draw:.4f} ms counting the draws' Omega and Psi tiles "
          f"written, {tile_bytes / 1e6:.1f} MB more); library "
          f"torch.sparse.mm Y {lib_y:.4f} + W {lib_w:.4f} ms; "
          f"update_rows_sparse wall {upd_wall:.3f} ms (validate, CSR, "
          f"draws, S1), its plain version on the card {plain_wall:.3f} ms; "
          f"the densified update_rows {dense_ms:.3f} ms on the device "
          f"(CUDA events), {dense_wall:.3f} ms wall")
    print(f"[timing] update_rows_sparse by stage (each ended by a "
          f"synchronize; median of {SP_STAGE_REPS}): "
          + ", ".join(f"{name} {ms:.4f} ms" for name, ms in stages.items()))
    return {"launches": counts["sparse_fold"], "err": worst, "ms": s1_ms,
            "plain_ms": plain_ms, "bound": (b_ms, b_by),
            "library_ms": lib_y + lib_w,
            "extra": {"parts": parts, "library_y_ms": lib_y,
                      "library_w_ms": lib_w, "bound_bytes": b_bytes,
                      "bound_with_draw_ms": with_draw,
                      "update_rows_sparse_wall_ms": upd_wall,
                      "update_rows_sparse_stages_ms": stages,
                      "edge_cases": edge_cases,
                      "plain_update_wall_ms": plain_wall,
                      "dense_update_ms": dense_ms,
                      "dense_update_wall_ms": dense_wall,
                      "main_path_s": t_main, "nnz": nnz}}


# -- phase 17: the planner --------------------------------------------------

PL_WORLD = 4
PL_SWEEP = (1, 4, 64, 4096, 1048576)       # (c): regime_sweep's P
PL_NYS_SWEEP = (4, 64, 66, 128, 1024)      # (c): around the crossover
PL_REPS = 3


def _bitwise(a, b) -> bool:
    """Tensors, or tuples of tensors, equal bit for bit."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_bitwise(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def phase_plan_one_card(dev, A, B_oneshot, LAUNCHES, reset_launches):
    """Phase 17 (a): the three one-card plans on ``probe_machine()`` (the
    H100 entry), each executable candidate executed, bitwise its direct
    call, and timed beside its predicted seconds."""
    from repro_torch.core.nystrom import nystrom_reference
    from repro_torch.core.sketch import sketch_reference
    from repro_torch.kernels import ops
    from repro_torch.plan import (H100_GLOO, explain, plan_nystrom,
                                  plan_sketch, plan_stream, probe_machine)
    from repro_torch.stream import StreamConfig, StreamingSketch

    machine = probe_machine()
    check(machine.name == H100_GLOO,
          f"probe_machine() is {machine.name}, not {H100_GLOO}")
    cfg = StreamConfig(N, N, r=R, seed=SEED)
    L = cfg.sketch_l
    plans = {"sketch": plan_sketch(N, N, R),
             "nystrom": plan_nystrom(N, R),
             "stream": plan_stream(N, N, R, chunk_rows=SLAB, l=L,
                                   corange=True)}

    def stream_direct():
        st = StreamingSketch(cfg, device=dev)
        for r0 in range(0, N, SLAB):
            st.update_rows(r0, A[r0:r0 + SLAB])
        return st
    direct = {
        ("sketch", "cuda_fused"): lambda: ops.sketch_matmul(A, seed=SEED,
                                                            r=R),
        ("sketch", "local_torch"): lambda: sketch_reference(A, SEED, R),
        ("nystrom", "cuda_fused"): lambda: ops.nystrom_fused(A, seed=SEED,
                                                             r=R),
        ("nystrom", "local_torch"): lambda: nystrom_reference(A, SEED, R),
        ("stream", "stream_local"): stream_direct}

    def result(task, out):
        return (out.sketch, out.corange_sketch) if task == "stream" else out

    out = {}
    for task, plan in plans.items():
        check(plan.machine == H100_GLOO and plan.n_procs == 1
              and plan.executable, f"phase 17 (a): the {task} plan {plan}")
        rows = {}
        for cand in plan.candidates:
            if not cand.executable:
                continue
            p = dataclasses.replace(plan, variant=cand.variant)
            key = (task, cand.variant)
            check(key in direct, f"phase 17 (a): no direct call for {key}")
            reset_launches()
            got = result(task, p.execute(A, seed=SEED, device=dev))
            torch.cuda.synchronize()
            launches = {k: v for k, v in LAUNCHES.items() if v}
            want = result(task, direct[key]())
            check(_bitwise(got, want), f"phase 17 (a): {task} plan "
                                       f"{cand.variant} is not bitwise "
                                       f"its direct call")
            if cand.variant == "cuda_fused" or task == "stream":
                oneshot = got[0] if isinstance(got, tuple) else got
                check(torch.equal(oneshot, B_oneshot),
                      f"phase 17 (a): {task} plan {cand.variant} is not "
                      f"bitwise phase 3's B")
            del got, want
            ms = time_ms(lambda: p.execute(A, seed=SEED, device=dev),
                         reps=PL_REPS)
            rows[cand.variant] = {
                "predicted_s": cand.seconds, "measured_s": ms * 1e-3,
                "ratio": cand.seconds / (ms * 1e-3), "launches": launches,
                "bottleneck": cand.cost.bottleneck(machine)}
            torch.cuda.empty_cache()
        fastest = min(rows, key=lambda v: rows[v]["measured_s"])
        out[task] = {"chosen": plan.variant, "fastest": fastest,
                     "candidates": rows}
        for v, row in rows.items():
            chosen = " (chosen)" if v == plan.variant else ""
            print(f"[plan] (a) {task}: {v}{chosen} predicted {row['predicted_s'] * 1e3:.4g} ms "
                  f"({row['bottleneck']}-bound on the H100 entry), "
                  f"measured {row['measured_s'] * 1e3:.4f} ms (CUDA events,"
                  f" median of {PL_REPS} after a warm-up), predicted / "
                  f"measured {row['ratio']:.4g}; launches {row['launches']}; "
                  f"bitwise its direct call")
        print(f"[plan] (a) {task}: the model picked {plan.variant}, the "
              f"fastest measured is {fastest}: "
              f"{'match' if fastest == plan.variant else 'MISMATCH'}")
        print(explain(plan))
    return out


def _alg2_counted(variant, p, q, rank) -> int:
    """The words a rank receives in one Alg. 2 call, as phases 13-14
    count them: No-Redist's reduce-scatter, Redist's all-to-all less the
    1/P a rank keeps, a two-grid run's ``two_grid_words``."""
    P = p[0] * p[1] * p[2]
    if variant == "alg2_no_redist":
        return (P - 1) * R * R // P
    if variant == "alg2_redist":
        return (P - 1) * N * R // (P * P)
    return sum(two_grid_words(N, R, p, q, _coords(rank, p),
                              _coords(rank, q)).values())


def _plan_rank(rank, world, device="cuda"):
    """Phase 17 (b), one rank: each planned call beside the same entry
    point with the plan's grid or variant passed explicitly (``device``
    other than the card only to rehearse the phase on the CPU)."""
    import torch.distributed as dist
    from repro_torch.core import nystrom as nys
    from repro_torch.core import sketch as sk
    from repro_torch.core.grid import alg1_bandwidth_words
    from repro_torch.kernels.sketch_matmul import LAUNCHES, reset_launches
    from repro_torch.parallel import collectives as col
    from repro_torch.plan import (H100_GLOO, plan_nystrom, plan_sketch,
                                  plan_stream, stream_update_cost)
    from repro_torch.serve import make_sketch_service
    from repro_torch.stream import ShardedStreamingSketch, StreamConfig

    dev = torch.device(device, 0)
    lines, runs = [], {}

    def say(msg):
        lines.append(f"[plan] (b) rank {rank}: {msg}")

    A = make_matrix(dev)
    same_matrix(A, rank, world)
    cfg = StreamConfig(N, N, r=R, seed=SEED)
    L = cfg.sketch_l
    ps = plan_sketch(N, N, R, P=world)
    pn = plan_nystrom(N, R, P=world)
    pst = plan_stream(N, N, R, P=world, chunk_rows=SLAB, l=L, corange=True)
    for plan in (ps, pn, pst):
        check(plan.machine == H100_GLOO and plan.n_procs == world
              and plan.executable, f"rank {rank}: phase 17 plan {plan}")

    def drive(name, fn, plan=None):
        """One call between barriers, its counts reset just before it."""
        dist.barrier()
        reset_launches()
        col.reset_comm()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = {"wall_s": wall, "words": col.comm_words(),
                      "launches": {k: v for k, v in LAUNCHES.items() if v},
                      "predicted_s": None if plan is None
                      else plan.predicted_seconds,
                      "predicted_words": None if plan is None
                      else plan.predicted_words}
        return res, runs[name]["words"]

    def held(name, bitwise, words, want_words, plan):
        check(bitwise, f"rank {rank}: {name} is not bitwise the explicit "
                       f"call")
        check(words == want_words and words <= plan.predicted_words,
              f"rank {rank}: {name}: {words} words, the explicit call's "
              f"and phases 12-15's count {want_words}, the plan's "
              f"{plan.predicted_words}")
        say(f"{name}: bitwise the explicit call; {words} words (phases "
            f"12-15 count {want_words}; predicted {plan.predicted_words:g}"
            f"); wall {runs[name]['wall_s']:.4f} s against the plan's "
            f"{plan.predicted_seconds:.4g} s (four ranks share the card)")

    # Alg. 1: grid="plan" against the plan's grid passed explicitly
    (blk, gm, g), w = drive("rand_matmul_auto(grid='plan')",
                            lambda: sk.rand_matmul_auto(A, SEED, R,
                                                        grid="plan"), ps)
    (ref, _, _), w_ref = drive(f"rand_matmul_auto(grid={ps.grid})",
                               lambda: sk.rand_matmul_auto(A, SEED, R,
                                                           grid=ps.grid))
    check(gm.shape == ps.grid, f"rank {rank}: grid {gm.shape}")
    held("rand_matmul_auto(grid='plan')", torch.equal(blk, ref), w, w_ref,
         ps)
    check(w_ref == alg1_bandwidth_words(N, N, R, *ps.grid),
          f"rank {rank}: Alg. 1 words {w_ref}")
    del ref

    # Alg. 2: variant="plan" against the plan's variant passed explicitly
    planned = f"nystrom_auto(variant='plan') -> {pn.variant}"
    (B, C, _, got), w = drive(planned, lambda: nys.nystrom_auto(
        A, SEED, R, variant="plan"), pn)
    if pn.variant in ("alg2_no_redist", "alg2_redist"):
        name = pn.variant[len("alg2_"):]
        (B0, C0, _, _), w_ref = drive(
            f"nystrom_auto(variant={name!r})",
            lambda: nys.nystrom_auto(A, SEED, R, variant=name))
    else:
        fn = (nys.nystrom_two_grid_fused
              if pn.variant == "alg2_bound_driven_fused"
              else nys.nystrom_two_grid)
        (B0, C0), w_ref = drive(
            f"{fn.__name__}(p={pn.grid}, q={pn.q_grid})",
            lambda: fn(sk.input_block(A, sk.make_grid_groups(*pn.grid)),
                       SEED, R, p=pn.grid, q=pn.q_grid))
    held(planned, torch.equal(B, B0) and torch.equal(C, C0), w, w_ref, pn)
    check(w_ref == _alg2_counted(pn.variant, pn.grid, pn.q_grid, rank),
          f"rank {rank}: Alg. 2 words {w_ref}")
    del B, C, B0, C0

    # a sharded stream placed by plan_stream, fed phase 15's slab order
    def feed(st):
        for i in SD_ORDER:
            st.update_rows(i * SLAB, A[i * SLAB:(i + 1) * SLAB])
        return st
    st, w = drive("ShardedStreamingSketch(cfg, plan_stream(...))",
                  lambda: feed(ShardedStreamingSketch(cfg, pst, device=dev)),
                  pst)
    st0, w_ref = drive(f"ShardedStreamingSketch(cfg, grid {pst.grid})",
                       lambda: feed(ShardedStreamingSketch(
                           cfg, sk.make_grid_groups(*pst.grid), device=dev)))
    slab_words = stream_update_cost(SLAB, N, R, L, pst.grid).words
    held("ShardedStreamingSketch(cfg, plan_stream(...))",
         torch.equal(st.Y, st0.Y) and torch.equal(st.W, st0.W), w, w_ref,
         pst)
    check(w_ref == len(SD_ORDER) * slab_words,
          f"rank {rank}: stream words {w_ref}")
    if pst.grid == ps.grid:
        check(torch.equal(st.Y, blk), f"rank {rank}: the planned stream's "
                                      f"Y is not bitwise Alg. 1's block")
    del st, st0

    # a grid service placed by grid="auto": one stream, one full update
    # (a grid service takes full-shape deltas; without the co-range its
    # update is Alg. 1 on the grid, what plan_sketch prices)
    scfg = StreamConfig(N, N, r=R, seed=SEED, corange=False)
    svc = make_sketch_service(grid="auto", shape=(N, N, R), device=dev)
    svc0 = make_sketch_service(grid=ps.grid, device=dev)
    sid, sid0 = svc.open(scfg), svc0.open(scfg)
    _, w = drive("make_sketch_service(grid='auto').update",
                 lambda: svc.update(sid, A), ps)
    _, w_ref = drive(f"make_sketch_service(grid={ps.grid}).update",
                     lambda: svc0.update(sid0, A))
    check(svc.mesh.shape == ps.grid, f"rank {rank}: service grid "
                                     f"{svc.mesh.shape}")
    held("make_sketch_service(grid='auto').update",
         torch.equal(svc.sketch(sid), svc0.sketch(sid0)), w, w_ref, ps)
    check(w_ref == alg1_bandwidth_words(N, N, R, *ps.grid)
          and torch.equal(svc.sketch(sid), blk),
          f"rank {rank}: the service's update is not Alg. 1's")
    launches = sum(sum(r["launches"].values()) for r in runs.values())
    check(launches > 0, f"rank {rank}: no kernel launched")
    return {"lines": lines, "runs": runs,
            "plans": {k: (p.variant, p.grid, p.q_grid, p.predicted_words,
                          p.predicted_seconds)
                      for k, p in (("sketch", ps), ("nystrom", pn),
                                   ("stream", pst))}}


def phase_plan_ranks():
    """Phase 17 (b): the grid="plan" entry points on PL_WORLD ranks of one
    card over gloo, each rank holding phase 1-5's A."""
    print(f"[plan] (b) {PL_WORLD} ranks on cuda:0 over gloo: "
          f"rand_matmul_auto(grid='plan'), nystrom_auto(variant='plan'), "
          f"ShardedStreamingSketch(cfg, plan_stream(...)) fed "
          f"{len(SD_ORDER)} slabs in {SD_ORDER}, make_sketch_service("
          f"grid='auto'); each against the explicit call")
    results = spawn_ranks(17, _plan_rank, PL_WORLD)
    for res in results:
        for line in res["lines"]:
            print(line)
    for name in results[0]["runs"]:
        walls = [res["runs"][name]["wall_s"] for res in results]
        print(f"[plan] (b) {name}: slowest rank {max(walls):.4f} s "
              f"(four ranks sharing the card; plan predicted "
              f"{results[0]['runs'][name]['predicted_s']})")
    print(f"[plan] (b) plans (variant, grid, q, words, seconds): "
          f"{results[0]['plans']}")
    return results


def phase_plan_tables():
    """Phase 17 (c): analytic tables on the H100 entry."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_api
    from repro_torch.plan import (explain_train_compression,
                                  nystrom_crossover_P, plan_nystrom,
                                  plan_sketch, plan_train_compression,
                                  regime_sweep)
    print(f"[plan] (c) regime_sweep(plan_sketch, ({N}, {N}, {R}), "
          f"{list(PL_SWEEP)}):")
    print(regime_sweep(plan_sketch, (N, N, R), PL_SWEEP))
    print(f"[plan] (c) Nystrom at n = {N}, r = {R}: crossover P ~ "
          f"{nystrom_crossover_P(N, R)}; regime_sweep(plan_nystrom, "
          f"{list(PL_NYS_SWEEP)}):")
    print(regime_sweep(plan_nystrom, (N, R), PL_NYS_SWEEP))
    cfg = get_config("gemma2-2b")
    shapes = get_api(cfg).init(0, cfg, "meta")
    words = plan_train_compression(shapes, rank=T_R, P=T_PLAN_WORKERS)
    secs = plan_train_compression(shapes, rank=T_R, P=T_PLAN_WORKERS,
                                  objective="seconds")
    differ = [d.name for d, e in zip(secs.decisions, words.decisions)
              if d.compress != e.compress]
    print(explain_train_compression(secs))
    print(f"[plan] (c) gemma2-2b, rank {T_R}, P = {T_PLAN_WORKERS} on "
          f"{secs.machine}: the seconds objective compresses "
          f"{secs.n_compressed} leaves, the words objective "
          f"{words.n_compressed}; {len(differ)} differ: {differ}")
    return {"seconds_compressed": secs.n_compressed,
            "words_compressed": words.n_compressed, "differ": differ}


# -- phase 18: the measured autotuner ------------------------------------------

AT_WORLD = 4
AT_TOP_K = 3
AT_DIR = ROOT / "build" / "repro_torch"
AT_CACHE = AT_DIR / "autotune_cache.json"
AT_SWEEP = AT_DIR / "autotune_sweep.json"


def _forbidden_timer(fn):
    raise AssertionError("a cache or preset hit ran the timer")


def _about(plan) -> tuple:
    return (plan.variant, plan.grid, plan.q_grid, plan.chunk_rows)


def _record_line(prefix: str, rec: dict, machine, pick: bool) -> str:
    where = (f" grid={rec['grid']}" if rec["grid"] else "") + (
        f" q={rec['q_grid']}" if rec["q_grid"] else "")
    return (f"{prefix} {rec['variant']}{where} chunk_rows="
            f"{rec['chunk_rows']}{' (the pick)' if pick else ''}: predicted "
            f"{_seconds(rec, machine) * 1e3:.4f} ms, measured "
            f"{rec['seconds'] * 1e3:.4f} ms")


def phase_autotune_one_card(dev, A, card: str, LAUNCHES, reset_launches):
    """Phase 18 (a): ``autotune`` of the one-card sketch, Nystrom and
    stream plans at phases 1-5's shape on a fresh cache (CUDA events,
    median of 3 after a warm-up, on its own synthetic A); each tuned plan
    bitwise the direct call of its variant on phases 1-5's A; a second
    ``autotune`` on a new cache object at the same path a pure hit; a
    preset hit executed.  The records go to ``AT_SWEEP``."""
    from repro_torch.core.nystrom import nystrom_reference
    from repro_torch.core.sketch import sketch_reference
    from repro_torch.kernels import ops
    from repro_torch.plan import (PRESET_ENTRIES, AutotuneCache, autotune,
                                  cache_key, explain, plan_nystrom,
                                  plan_sketch, plan_stream, probe_machine,
                                  save_sweep)
    from repro_torch.stream import StreamConfig, StreamingSketch

    machine = probe_machine()
    name, power = (x.strip() for x in card.split(",", 1))
    AT_DIR.mkdir(parents=True, exist_ok=True)
    AT_CACHE.unlink(missing_ok=True)
    cfg = StreamConfig(N, N, r=R, seed=SEED)
    plans = {"sketch": plan_sketch(N, N, R),
             "nystrom": plan_nystrom(N, R),
             "stream": plan_stream(N, N, R, chunk_rows=SLAB,
                                   l=cfg.sketch_l, corange=True)}

    def stream_direct(k):
        st = StreamingSketch(cfg, device=dev)
        for r0 in range(0, N, k):
            st.update_rows(r0, A[r0:r0 + k])
        return st.sketch, st.corange_sketch

    direct = {
        ("sketch", "cuda_fused"): lambda p: ops.sketch_matmul(A, seed=SEED,
                                                              r=R),
        ("sketch", "local_torch"): lambda p: sketch_reference(A, SEED, R),
        ("nystrom", "cuda_fused"): lambda p: ops.nystrom_fused(A, seed=SEED,
                                                               r=R),
        ("nystrom", "local_torch"): lambda p: nystrom_reference(A, SEED, R),
        ("stream", "stream_local"): lambda p: stream_direct(p.chunk_rows)}

    def run(task, plan):
        out = plan.execute(A, seed=SEED, device=dev)
        return (out.sketch, out.corange_sketch) if task == "stream" else out

    out, records, entries = {}, [], {}
    for task, plan in plans.items():
        recs = []
        t0 = time.perf_counter()
        tuned = autotune(plan, cache=str(AT_CACHE), top_k=AT_TOP_K,
                         records=recs, presets={})
        tune_s = time.perf_counter() - t0
        check(tuned.measured_seconds is not None and len(recs) >= 2,
              f"phase 18 (a): {task} was not measured ({tuned.notes})")
        for rec in recs:
            rec.update(device_kind=name.replace(" ", "_"), power_limit=power)
            print(_record_line(f"[autotune] (a) {task}:", rec, machine,
                               _about(tuned) == (rec["variant"], None, None,
                                                 rec["chunk_rows"])))
        records += recs
        key = (task, tuned.variant)
        check(key in direct, f"phase 18 (a): no direct call for {key}")
        reset_launches()
        got = run(task, tuned)
        torch.cuda.synchronize()
        launches = {k: v for k, v in LAUNCHES.items() if v}
        want = direct[key](tuned)
        check(_bitwise(got, want), f"phase 18 (a): the tuned {task} plan "
                                   f"{_about(tuned)} is not bitwise its "
                                   f"direct call")
        del got, want
        check(launches.get("gen_omega" if tuned.variant == "local_torch"
                           else "sketch_fwd", 0) > 0,
              f"phase 18 (a): the tuned {task} plan launched {launches}")
        again = AutotuneCache(AT_CACHE)
        hit = autotune(plan, cache=again, timer=_forbidden_timer,
                       presets={})
        check(again.hits == 1 and _about(hit) == _about(tuned),
              f"phase 18 (a): the second {task} autotune was not a pure "
              f"hit ({again.hits} hits, {_about(hit)})")
        k = cache_key(plan)
        entries[k] = again.get(k)
        shipped = k in PRESET_ENTRIES
        presets = PRESET_ENTRIES if shipped else {k: entries[k]}
        pre = autotune(plan, timer=_forbidden_timer, presets=presets)
        got = run(task, pre)
        want = direct[(task, pre.variant)](pre)
        check(_bitwise(got, want), f"phase 18 (a): the {task} preset plan "
                                   f"{_about(pre)} is not bitwise its "
                                   f"direct call")
        del got, want
        torch.cuda.empty_cache()
        print(f"[autotune] (a) {task}: the model picked {plan.variant} "
              f"(predicted {plan.predicted_seconds * 1e3:.4f} ms), the tuner "
              f"{tuned.variant} chunk_rows={tuned.chunk_rows} (measured "
              f"{tuned.measured_seconds * 1e3:.4f} ms; tuning took "
              f"{tune_s:.2f} s); bitwise its direct call, launches "
              f"{launches}; again a pure hit, no timer call; "
              + ("the shipped preset " if shipped else "a preset of this "
                 "run's entry ")
              + f"{_about(pre)} executed bitwise its direct call"
              + (f", {'the same as' if _about(pre) == _about(tuned) else 'NOT'}"
                 f" this run's pick" if shipped else ""))
        print(explain(tuned))
        out[task] = {"model": plan.variant, "tuned": _about(tuned),
                     "measured_s": tuned.measured_seconds,
                     "predicted_s": tuned.predicted_seconds,
                     "tune_s": tune_s, "launches": launches,
                     "preset": _about(pre), "shipped": shipped}
    save_sweep(records, AT_SWEEP)
    print(f"[autotune] (a) {len(records)} records written to "
          f"{AT_SWEEP.relative_to(ROOT)}; measured entries "
          + json.dumps(entries))
    out["entries"] = entries
    return out


def _autotune_rank(rank, world, cache_dir, device="cuda"):
    """Phase 18 (b), one rank: ``autotune`` of the P = 4 sketch and
    Nystrom plans on a cache of its own (``cache_dir/rank<r>.json``), the
    tuned plan against the explicit call it names, then a second
    ``autotune`` that must hit (``device`` other than the card only to
    rehearse the phase on the CPU)."""
    import os

    import torch.distributed as dist
    from repro_torch.core import nystrom as nys
    from repro_torch.core import sketch as sk
    from repro_torch.core.grid import alg1_bandwidth_words
    from repro_torch.kernels.sketch_matmul import LAUNCHES, reset_launches
    from repro_torch.parallel import collectives as col
    from repro_torch.plan import (AutotuneCache, autotune, plan_nystrom,
                                  plan_sketch)

    dev = torch.device(device, 0)
    A = make_matrix(dev)
    same_matrix(A, rank, world)
    out = {}
    for task, plan in (("sketch", plan_sketch(N, N, R, P=world)),
                       ("nystrom", plan_nystrom(N, R, P=world))):
        path = os.path.join(cache_dir, f"{task}_rank{rank}.json")
        recs = []
        dist.barrier()
        t0 = time.perf_counter()
        tuned = autotune(plan, cache=path, top_k=AT_TOP_K, records=recs,
                         presets={}, device=dev)
        tune_s = time.perf_counter() - t0
        dist.barrier()
        reset_launches()
        col.reset_comm()
        got = tuned.execute(A, seed=SEED, device=dev)
        torch.cuda.synchronize()
        words, launches = col.comm_words(), {k: v for k, v in
                                             LAUNCHES.items() if v}
        col.reset_comm()
        if task == "sketch":
            g = sk.make_grid_groups(*tuned.grid)
            want = sk.rand_matmul(sk.input_block(A, g), SEED, R, g)
            bitwise = _bitwise(got, want)
            counted = alg1_bandwidth_words(N, N, R, *tuned.grid)
        else:
            g = sk.make_grid_groups(*tuned.grid)
            fn = {"alg2_no_redist": nys.nystrom_no_redist,
                  "alg2_redist": nys.nystrom_redist}.get(tuned.variant)
            if fn is not None:
                want = fn(sk.input_block(A, g), SEED, R, g)
            else:
                fn = (nys.nystrom_two_grid_fused
                      if tuned.variant == "alg2_bound_driven_fused"
                      else nys.nystrom_two_grid)
                want = fn(sk.input_block(A, g), SEED, R, p=tuned.grid,
                          q=tuned.q_grid)
            bitwise = _bitwise(tuple(got), tuple(want))
            counted = _alg2_counted(tuned.variant, tuned.grid, tuned.q_grid,
                                    rank)
        words_ref = col.comm_words()
        del got, want
        check(bitwise, f"rank {rank}: the tuned {task} plan "
                       f"{_about(tuned)} is not bitwise its explicit call")
        check(words == words_ref == counted
              and words <= tuned.predicted_words,
              f"rank {rank}: the tuned {task} plan moved {words} words, the "
              f"explicit call {words_ref}, phases 12-14 count {counted}, "
              f"the plan predicts {tuned.predicted_words}")
        dist.barrier()
        written = os.path.exists(path)
        again = AutotuneCache(path) if rank == 0 else None
        hit = autotune(plan, cache=again, timer=_forbidden_timer,
                       presets={}, device=dev)
        check(_about(hit) == _about(tuned),
              f"rank {rank}: the second {task} autotune gave {_about(hit)}")
        torch.cuda.empty_cache()
        out[task] = {"tuned": _about(tuned), "words": words,
                     "measured_s": tuned.measured_seconds,
                     "predicted_words": tuned.predicted_words,
                     "tune_s": tune_s, "launches": launches,
                     "written": written,
                     "hit": None if again is None else again.hits,
                     "records": recs}
    return out


def phase_autotune_ranks():
    """Phase 18 (b): ``autotune`` of the P = 4 sketch and Nystrom plans on
    AT_WORLD ranks of cuda:0 over gloo: one tuned plan on every rank,
    bitwise its explicit call with phases 12-14's words, rank 0 alone
    writing the cache, and a second call a hit."""
    import shutil
    import tempfile

    from repro_torch.plan import (H100_GLOO, PRESETS, cache_key,
                                  plan_nystrom, plan_sketch)
    h100 = PRESETS[H100_GLOO]
    print(f"[autotune] (b) {AT_WORLD} ranks on cuda:0 over gloo: autotune "
          f"(top_k={AT_TOP_K}) of plan_sketch(P={AT_WORLD}) and "
          f"plan_nystrom(P={AT_WORLD}), each rank on a cache of its own")
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    try:
        results = spawn_ranks(18, _autotune_rank, AT_WORLD, (cache_dir,))
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    for task in ("sketch", "nystrom"):
        got = [res[task] for res in results]
        check(all(g["tuned"] == got[0]["tuned"] for g in got),
              f"phase 18 (b): the ranks tuned {task} differently: "
              f"{[g['tuned'] for g in got]}")
        check([g["written"] for g in got] == [True] + [False] * (AT_WORLD - 1),
              f"phase 18 (b): {task}'s cache files {[g['written'] for g in got]}")
        check(got[0]["hit"] == 1, f"phase 18 (b): rank 0's second {task} "
                                  f"call was not a hit")
        for rank, g in enumerate(got):
            print(f"[autotune] (b) rank {rank}: {task} tuned to {g['tuned']} "
                  f"in {g['tune_s']:.2f} s (measured {g['measured_s']:.4f} s,"
                  f" the slowest rank's); bitwise the explicit call; "
                  f"{g['words']} words (predicted {g['predicted_words']:g}); "
                  f"launches {g['launches']}")
        for rec in got[0]["records"]:
            print(_record_line(f"[autotune] (b) {task}:", rec, h100,
                               got[0]["tuned"][:3] == (
                                   rec["variant"],
                                   tuple(rec["grid"]) if rec["grid"] else None,
                                   tuple(rec["q_grid"]) if rec["q_grid"]
                                   else None))
                  + " (the slowest rank's)")
    entries = {}
    for task, plan in (("sketch", plan_sketch(N, N, R, P=AT_WORLD)),
                       ("nystrom", plan_nystrom(N, R, P=AT_WORLD))):
        variant, grid, q_grid, chunk_rows = results[0][task]["tuned"]
        entries[cache_key(plan)] = {
            "variant": variant, "grid": list(grid),
            "q_grid": list(q_grid) if q_grid else None,
            "chunk_rows": chunk_rows, "source": "measured",
            "seconds": results[0][task]["measured_s"]}
    print(f"[autotune] (b) every rank tuned the same plans; rank 0 alone "
          f"wrote each cache; the second calls were hits; measured entries "
          + json.dumps(entries))
    return results, entries


def phase_autotune_fit(sweeps) -> dict:
    """Phase 18 (c): the fit on the card: the free device memory beside the
    largest candidate's bytes, and each kernel's shared memory a block
    (the tile constants, ``kernel_smem_bytes``) against the H100 entry's
    ``smem_bytes`` and ``cudaFuncGetAttributes``."""
    from repro_torch.kernels.sketch_matmul import (kernel_smem_attributes,
                                                   kernel_smem_bytes)
    from repro_torch.plan import H100_GLOO, PRESETS
    from repro_torch.plan.autotune import _measurable_candidates, device_bytes
    machine = PRESETS[H100_GLOO]
    free, total = torch.cuda.mem_get_info()
    largest = max(((device_bytes(c), c) for plan in sweeps
                   for c in _measurable_candidates(plan, machine, AT_TOP_K)),
                  key=lambda t: t[0])
    print(f"[autotune] (c) mem_get_info: {free} free of {total} bytes; the "
          f"largest candidate, {_about(largest[1])} on P = "
          f"{largest[1].n_procs}, needs {largest[0]} bytes a rank")
    table, read = kernel_smem_bytes(), kernel_smem_attributes()
    for name, (static, dyn) in table.items():
        print(f"[autotune] (c) {name}: {static} static + {dyn} dynamic bytes "
              f"of shared memory a block (cudaFuncGetAttributes "
              f"{read[name][0]}, the launcher asks {read[name][1]}); the "
              f"entry's smem_bytes {machine.smem_bytes}")
    check(read == table, f"phase 18 (c): the kernels' shared memory "
                         f"{read} is not the tile constants' {table}")
    check(all(s + d <= machine.smem_bytes for s, d in table.values()),
          "phase 18 (c): a kernel does not fit one SM")
    return {"free": free, "total": total, "largest": largest[0],
            "smem": table}


# -- phase 19: the communication ledger --------------------------------------

OBS_WORLD = 4
OBS_GRIDS = [(4, 1, 1), (2, 2, 1), (1, 2, 2)]
OBS_SERVICE_GRID = (2, 2, 1)
OBS_FUSED = ((4, 1, 1), (1, 1, 4))
OBS_DRILL_GRID = (2, 2, 1)               # where the stale decision runs
OBS_LANES = 64                           # (a)'s update_ragged lanes
OBS_BATCH = (8, 128)                     # (a)'s update_batch: lanes, rows
OBS_HOT_LANES, OBS_HOT_K, OBS_HOT_PAIRS = 16, 64, 40
OBS_SECONDS = 90                         # (c): the phase's time limit


def obs_hot_path(dev, card: str) -> dict:
    """Phase 19 (a), the ledger's hot-path cost: ``update_ragged`` rounds
    (OBS_HOT_LANES lanes of OBS_HOT_K rows at phase 8's width, each ended
    by a synchronize) timed on the host clock, untraced and traced
    interleaved (the reference's ``tests/test_obs.py`` overhead test):
    the tracer and ledger are installed once and reused, the minimum of
    each class kept.  Printed, not gated."""
    from repro_torch import obs
    from repro_torch.stream import SketchService, StreamConfig
    svc = SketchService()
    sids = [svc.open(StreamConfig(S_N1, S_N2, r=S_R, seed=s))
            for s in range(OBS_HOT_LANES)]
    items = [(sid, np.ones((OBS_HOT_K, S_N2), np.float32), 0)
             for sid in sids]

    def timed():
        t0 = time.perf_counter()
        svc.update_ragged(items)
        svc.sync()
        return time.perf_counter() - t0

    timed()                                 # warm every path
    tracer = obs.Tracer(max_spans=1_000_000)
    ledger = obs.CommLedger()
    obs.install_tracer(tracer)
    obs.install_ledger(ledger)
    timed()                                 # the site's first call
    obs.uninstall_observability()
    untraced = traced = math.inf
    for _ in range(OBS_HOT_PAIRS):
        untraced = min(untraced, timed())
        obs.install_tracer(tracer)
        obs.install_ledger(ledger)
        try:
            traced = min(traced, timed())
        finally:
            obs.uninstall_observability()
    site = ledger.site("service.update_ragged")
    check(site is not None and site.calls == OBS_HOT_PAIRS + 1
          and site.measured_words == 0.0,
          f"phase 19 (a): the hot path's ledger site {site}")
    ratio = traced / untraced
    print(f"[ledger] (a) hot path: update_ragged of {OBS_HOT_LANES} lanes x "
          f"{OBS_HOT_K} rows ({S_N1}x{S_N2}, r={S_R}), {OBS_HOT_PAIRS} "
          f"interleaved pairs, host clock around a synchronized round: "
          f"untraced min {untraced * 1e3:.4f} ms, traced (tracer + ledger) "
          f"min {traced * 1e3:.4f} ms, traced/untraced {ratio:.4f} ({card})")
    del svc
    torch.cuda.empty_cache()
    return {"untraced_s": untraced, "traced_s": traced, "ratio": ratio}


def phase_obs_one_card(dev, card: str, LAUNCHES, reset_launches) -> dict:
    """Phase 19 (a): one card under ``install_observability()``."""
    from repro_torch import obs
    from repro_torch.parallel import collectives as col
    from repro_torch.plan import (H100_GLOO, PRESETS, cache_key,
                                  plan_nystrom, plan_sketch, plan_stream)
    from repro_torch.stream import SketchService, SparseRows, StreamConfig
    machine = PRESETS[H100_GLOO]
    cfg = StreamConfig(N, N, r=R, seed=SEED)
    plans = {"sketch": plan_sketch(N, N, R), "nystrom": plan_nystrom(N, R),
             "stream": plan_stream(N, N, R, chunk_rows=SLAB,
                                   l=cfg.sketch_l, corange=True)}
    # every payload made before the counts are reset
    rng = np.random.default_rng(19)
    ks = [int(k) for k in rng.integers(1, S_KMAX + 1, OBS_LANES)]
    lanes = [(rng.standard_normal((k, S_N2), dtype=np.float32),
              int(rng.integers(0, S_N1 - k + 1))) for k in ks]
    H_one = rng.standard_normal((S_KMAX, S_N2), dtype=np.float32)
    nb, kb = OBS_BATCH
    H_batch = rng.standard_normal((nb, kb, S_N2), dtype=np.float32)
    slab = SparseRows(*sparse_coo(np.random.default_rng(0), SLAB, N,
                                  SP_DISTINCT, SP_REPEATS), (SLAB, N))
    A = make_matrix(dev)
    torch.cuda.synchronize()
    tracer, ledger, _ = obs.install_observability()
    try:
        reset_launches()
        col.reset_comm()
        t0 = time.perf_counter()
        for task, plan in plans.items():
            out = plan.execute(A, seed=SEED, device=dev)
            del out
        del A
        svc = SketchService()
        sids = [svc.open(StreamConfig(S_N1, S_N2, r=S_R, seed=s))
                for s in range(OBS_LANES)]
        svc.update(sids[0], H_one, row0=0)
        svc.update_batch(sids[:nb], H_batch, row0=[i * kb for i in range(nb)])
        svc.update_ragged([(sid, H, r0) for sid, (H, r0) in zip(sids, lanes)])
        sp = SketchService()
        sp_sids = [sp.open(cfg), sp.open(StreamConfig(N, N, r=R,
                                                      seed=SEED + 1))]
        sp.update_sparse(sp_sids[0], slab, row0=0)
        sp.update_sparse_batch(sp_sids, [slab, slab], row0=[SLAB, 2 * SLAB])
        svc.sync()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        words = col.comm_words()
        states = [svc.sketch(s) for s in sids] + [sp.sketch(s)
                                                  for s in sp_sids]
        check(all(torch.isfinite(Y).all().item() for Y in states),
              "phase 19 (a): a non-finite stream after the ledger's run")
        del svc, sp, states
    finally:
        obs.uninstall_observability()
    torch.cuda.empty_cache()
    check(words == 0, f"phase 19 (a): {words} words counted on one card")
    print(f"[ledger] (a) one card: 3 plans executed, the service's "
          f"update / update_batch ({nb} lanes of {kb} rows) / update_ragged "
          f"({OBS_LANES} lanes, heights in [1, {S_KMAX}]) at {S_N1}x{S_N2}, "
          f"r={S_R}, update_sparse / update_sparse_batch (2 lanes) of "
          f"{slab.nnz} entries at {N}x{N}, r={R}, in {wall:.3f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} } ({card})")
    for name in ("sketch_fwd", "sketch_t", "fold_rows", "sparse_fold"):
        check(launches.get(name, 0) > 0,
              f"phase 19 (a): {name} never launched under the ledger")
    sites = ledger.sites()
    for task, plan in plans.items():
        name = f"plan.execute[{task}/{plan.variant}]"
        got = [s for s in sites if s.name == name]
        check(len(got) == 1 and got[0].calls == 1 and got[0].wall_s > 0
              and got[0].cache_key == cache_key(plan)
              and got[0].measured_words is None
              and got[0].predicted_words == plan.predicted_words,
              f"phase 19 (a): {name}: {got}")
    for name in ("service.update[local]", "service.update_batch",
                 "service.update_ragged"):
        got = [s for s in sites if s.name == name]
        check(got and all((s.measured_words_per_call, s.predicted_words,
                           s.lower_bound_words, s.bound_fraction, s.drift)
                          == (0.0, 0.0, 0.0, 1.0, 0.0) for s in got),
              f"phase 19 (a): {name} is not 0 words at a 0 floor: {got}")
    ragged = sum(s.calls for s in sites if s.name == "service.update_ragged")
    sparse = sorted((s.predicted_words, s.lower_bound_words, s.calls)
                    for s in sites if s.name == "service.update[sparse]")
    nnz = slab.nnz
    check(sparse == [(2.0 * nnz, float(nnz), 1), (4.0 * nnz, 2.0 * nnz, 1)]
          and all(s.measured_words is None for s in sites
                  if s.name == "service.update[sparse]"),
          f"phase 19 (a): the sparse records {sparse}")
    report = obs.honesty_report(ledger,
                                machine_words_per_s=machine.byte_bw / 4)
    print(f"[ledger] (a) honesty report, one card ({card}; roofline_frac "
          f"at the H100 entry's byte_bw / 4 = {machine.byte_bw / 4:.6g} "
          f"words/s; wall_s is the host clock, not synchronized):")
    print(report)
    print(f"[ledger] (a) {len(ledger)} sites; update_ragged {ragged} "
          f"buckets observed, each 0 words at a 0 floor; the sparse "
          f"records {sparse} (predicted 2·nnz, floor nnz, no measured "
          f"words) ({card})")
    hot = obs_hot_path(dev, card)
    return {"wall_s": wall, "launches": launches, "sites": len(ledger),
            "report": report, "hot": hot,
            "rows": [dict(r, card=card) for r in obs.report_rows(ledger)]}


def _obs_rank(rank, world, entries, cache_dir, card, device="cuda"):
    """Phase 19 (b), one rank (``device`` other than the card only to
    rehearse the phase on the CPU)."""
    import os

    import torch.distributed as dist
    from repro_torch import obs
    from repro_torch.core import nystrom as nys
    from repro_torch.core import sketch as sk
    from repro_torch.core.grid import alg1_bandwidth_words
    from repro_torch.kernels.sketch_matmul import LAUNCHES, reset_launches
    from repro_torch.parallel import collectives as col
    from repro_torch.plan import (AutotuneCache, cache_key, plan_nystrom,
                                  plan_sketch, stream_update_cost)
    from repro_torch.stream import (ShardedStreamingSketch, SketchService,
                                    StreamConfig)

    dev = torch.device(device, 0)
    A = make_matrix(dev)
    same_matrix(A, rank, world)
    cfg = StreamConfig(N, N, r=R, seed=SEED)
    L = cfg.sketch_l
    groups = {g: sk.make_grid_groups(*g) for g in OBS_GRIDS}
    p, q = OBS_FUSED
    plans = {"sketch": plan_sketch(N, N, R, P=world),
             "nystrom": plan_nystrom(N, R, P=world)}
    _, ledger, _ = obs.install_observability()
    rows = []
    names = ("sketch_fwd", "sketch_t", "fold_rows", "gen_omega")
    launches = dict.fromkeys(names, 0)

    def call(tag, want, fn):
        """One call between barriers, its counts reset just before it;
        every site it touched beside the rank's COMM delta."""
        before = {id(s): (s.calls, s.measured_words or 0.0)
                  for s in ledger.sites()}
        dist.barrier()
        reset_launches()
        col.reset_comm()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = col.comm_words()
        check(delta == want, f"rank {rank}: {tag} received {delta} words, "
                             f"phases 12-15 count {want}")
        for k in names:
            launches[k] += LAUNCHES[k]
        touched = [s for s in ledger.sites()
                   if s.calls != before.get(id(s), (0, 0.0))[0]]
        measured = [s for s in touched if s.measured_words is not None]
        check(len(measured) <= 1, f"rank {rank}: {tag} touched "
                                  f"{len(measured)} measured sites")
        for s in touched:
            words = (None if s.measured_words is None
                     else s.measured_words - before.get(id(s),
                                                        (0, 0.0))[1])
            if words is not None:
                check(words == delta == want and s.drift == 0.0,
                      f"rank {rank}: {tag} {s.name}: measured {words}, COMM "
                      f"delta {delta}, phases 12-15 count {want}, drift "
                      f"{s.drift}")
            rows.append({"tag": tag, "name": s.name, "calls": s.calls,
                         "words": words, "comm": delta, "want": want,
                         "pred": s.predicted_words,
                         "floor": s.lower_bound_words,
                         "bound_fraction": s.bound_fraction,
                         "drift": s.drift, "cache_key": s.cache_key,
                         "wall_s": wall})
        return out

    for grid in OBS_GRIDS:
        p1, p2, p3 = grid
        st = ShardedStreamingSketch(cfg, groups[grid], device=dev)
        want = (alg1_bandwidth_words(N, N, R, *grid)
                + 2 * (p1 - 1) * L * N // (p1 * p2 * p3))
        call(f"update {grid}", want, lambda: st.update(A))
        r0 = SD_ORDER[0] * SLAB
        call(f"update_rows {grid}",
             stream_update_cost(SLAB, N, R, L, grid=grid).words,
             lambda: st.update_rows(r0, A[r0:r0 + SLAB]))
        del st
        torch.cuda.empty_cache()
    g = groups[OBS_SERVICE_GRID]
    svc = SketchService(mesh=g, device=dev)
    sid = svc.open(cfg)
    p1, p2, p3 = OBS_SERVICE_GRID
    call(f"service.update {OBS_SERVICE_GRID}",
         alg1_bandwidth_words(N, N, R, *OBS_SERVICE_GRID)
         + 2 * (p1 - 1) * L * N // (p1 * p2 * p3),
         lambda: svc.update(sid, A))
    del svc
    torch.cuda.empty_cache()
    gp = groups[p]
    A_blk = sk.input_block(A, gp)
    out = call(f"nystrom_two_grid_fused {p} {q}", TG_WORDS[(p, q, R)][1],
               lambda: nys.nystrom_two_grid_fused(A_blk, SEED, R, p=p, q=q))
    del out
    for task, plan in plans.items():
        if task == "sketch":
            want = alg1_bandwidth_words(N, N, R, *plan.grid)
        else:
            want = _alg2_counted(plan.variant, plan.grid, plan.q_grid, rank)
        out = call(f"Plan.execute {task} P={world}", want,
                   lambda: plan.execute(A, seed=SEED, device=dev))
        del out
    # a stale decision: the P = 4 sketch's (4,1,1) prediction and cache
    # key, run on another grid
    stale = plans["sketch"]
    gd = sk.make_grid_groups(*OBS_DRILL_GRID)
    dist.barrier()
    with obs.observing("drill.stale_decision", (A, OBS_DRILL_GRID),
                       predicted_words=stale.predicted_words,
                       lower_bound_words=stale.lower_bound_words,
                       cache_key=cache_key(stale)) as ob:
        sk.rand_matmul(sk.input_block(A, gd), SEED, R, gd)
    torch.cuda.synchronize()
    drill_words = ob.site.measured_words
    check(drill_words == alg1_bandwidth_words(N, N, R, *OBS_DRILL_GRID),
          f"rank {rank}: the drill moved {drill_words} words")
    cache = AutotuneCache(os.path.join(cache_dir, f"rank{rank}.json"))
    for key, entry in entries.items():
        cache.put(key, entry)
    flags = obs.drift_flags(ledger)
    flagged = []
    for s, _ in flags:
        if s.cache_key and s.cache_key in entries and s.cache_key not in \
                flagged:
            flagged.append(s.cache_key)
    popped = obs.revalidate_autotune(ledger, cache)
    again = obs.revalidate_autotune(ledger, cache)
    left = sorted(k for k in entries if cache.get(k) is not None)
    check([s.name for s, _ in flags] == ["drill.stale_decision"],
          f"rank {rank}: drift flags {[(s.name, d) for s, d in flags]}")
    check(popped == flagged == [cache_key(stale)] and again == []
          and left == sorted(set(entries) - set(popped)),
          f"rank {rank}: revalidate_autotune popped {popped} (flagged "
          f"{flagged}), then {again}; left {left}")
    report = obs.honesty_report(ledger)
    obs.uninstall_observability()
    return {"rows": rows, "launches": launches, "report": report,
            "flags": [(s.name, s.drift, s.cache_key) for s, _ in flags],
            "popped": popped, "again": again, "left": left,
            "drill_words": drill_words, "card": card}


def phase_obs_ranks(entries: dict, card: str) -> list:
    """Phase 19 (b): the ledger on OBS_WORLD ranks of cuda:0 over gloo."""
    import shutil
    import tempfile
    print(f"[ledger] (b) {OBS_WORLD} ranks on cuda:0 over gloo at A = "
          f"{N}x{N}, r = {R}: update and update_rows on {OBS_GRIDS}, a grid "
          f"service on {OBS_SERVICE_GRID}, nystrom_two_grid_fused on "
          f"{OBS_FUSED}, the P = {OBS_WORLD} plans; a stale decision on "
          f"{OBS_DRILL_GRID}; {len(entries)} autotune keys from phase 18")
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_ledger_")
    try:
        results = spawn_ranks(19, _obs_rank, OBS_WORLD,
                              (entries, cache_dir, card))
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    tags = []
    for row in results[0]["rows"]:
        if (row["tag"], row["name"]) not in tags:
            tags.append((row["tag"], row["name"]))
    for tag, name in tags:
        got = [r for res in results for r in res["rows"]
               if r["tag"] == tag and r["name"] == name]
        check(len(got) == OBS_WORLD, f"phase 19 (b): {tag} {name} on "
                                     f"{len(got)} ranks")
        top = max(got, key=lambda r: (r["comm"], r["words"] or 0))
        words = ("-" if top["words"] is None
                 else f"{max(r['words'] for r in got):.0f}")
        print(f"[ledger] (b) {tag}: {name} largest over ranks: meas_words "
              f"{words}, COMM delta {max(r['comm'] for r in got):.0f}, "
              f"phases 12-15 count {top['want']:.0f}; pred_words "
              f"{top['pred']:.6g}, thm_floor {top['floor']:.6g}, bound_frac "
              f"{top['bound_fraction']}, drift {top['drift']}; slowest wall "
              f"{max(r['wall_s'] for r in got):.4f} s ({card})")
    res0 = results[0]
    same = all(r["popped"] == res0["popped"] and r["left"] == res0["left"]
               for r in results)
    print(f"[ledger] (b) drift flags {res0['flags']}; revalidate_autotune "
          f"popped {res0['popped']}, then {res0['again']}; keys left "
          f"{res0['left']} (every rank the same: {same})")
    print(f"[ledger] (b) rank 0's honesty report ({card}):")
    print(res0["report"])
    check(same, "phase 19 (b): the ranks popped differently")
    return results


# -- phase 20: the roofline ---------------------------------------------------

RF_REPS, RF_RANK_REPS = 5, 3         # timed runs after the warm-up
RF_WORLD = 4
RF_GRIDS = [(4, 1, 1), (1, 2, 2)]    # (g): regime 1, and a grid that gathers
RF_PAIR = ((4, 1, 1), (1, 1, 4))     # (h): phase 19's fused two-grid pair
RF_LANES = 64                        # (d): one update_ragged round's lanes
# gloo's peak on this machine: the fastest gather or reduce-scatter of the
# four-rank rows and of a probe (an (8192, 8192) f32 block all-gathered over
# (1,2,2)'s p3 fibers, 256 MiB received a rank, RF_RANK_REPS times) among
# those that receive at least RF_PEAK_MIN_BYTES (a smaller call can find
# part of its bytes already in the sockets' buffers)
RF_PEAK_GRID, RF_PEAK_BLOCK = (1, 2, 2), (8192, 8192)
RF_PEAK_MIN_BYTES = 64 * 2 ** 20
RF_MAX_RATIO = 1.05                  # t_bound / measured, at most
RF_SECONDS = 60                      # the phase's time limit, (f) included


def roofline_row(name: str, fn, model_flops: float, dev, flush=None) -> dict:
    """One one-card row of phase 20: ``analyze_call`` (a warm-up, then the
    counted call), then ``time_ms`` (RF_REPS runs, each after ``flush``)."""
    from repro_torch.roofline import analyze_call
    terms = analyze_call(name, fn, model_flops=model_flops, device=dev)
    return {"terms": terms.to_dict(),
            "ms": time_ms(fn, RF_REPS, before=flush)}


def roofline_train_row(step, state, batch, cfg, dev) -> dict:
    """Phase 20 (f), taken in phase 11 where gemma2-2b's model and state are
    held: one training step, model_flops = 6·N·D (``models.model_flops``,
    N from ``count_params_split``).  Its operands far exceed the L2, so no
    flush; its seconds are added to phase 20's."""
    import types

    from repro_torch.models import count_params_split, model_flops
    t0 = time.perf_counter()
    n_params, _ = count_params_split(cfg, state.params)
    shape = types.SimpleNamespace(global_batch=T_BATCH, seq_len=T_SEQ,
                                  kind="train")
    row = roofline_row(f"(f) {cfg.name} step {T_BATCH}x{T_SEQ}",
                       lambda: step(state, batch),
                       model_flops(cfg, shape, n_params), dev)
    row["seconds"] = time.perf_counter() - t0
    return row


def phase_roofline_one_card(dev) -> list:
    """Phase 20 (a)-(e) on one card, the L2 flushed before each timed run
    (a 256 MiB read)."""
    from repro_torch.core.sketch import sketch_reference
    from repro_torch.kernels import ops
    from repro_torch.stream import (SketchService, SparseRows, StreamConfig,
                                    StreamingSketch)
    cfg = StreamConfig(N, N, r=R, seed=SEED)
    L = cfg.sketch_l
    rng = np.random.default_rng(20)
    ks = [int(k) for k in rng.integers(1, S_KMAX + 1, RF_LANES)]
    lanes = [(rng.standard_normal((k, S_N2), dtype=np.float32),
              int(rng.integers(0, S_N1 - k + 1))) for k in ks]
    slab = SparseRows(*sparse_coo(np.random.default_rng(0), SLAB, N,
                                  SP_DISTINCT, SP_REPEATS), (SLAB, N))
    A = make_matrix(dev)
    flush = torch.empty(64 * 2 ** 20, device=dev).sum
    sketch = 2.0 * N * N * R
    rows = [roofline_row("(a) sketch cuda_fused",
                         lambda: ops.sketch_matmul(A, seed=SEED, r=R),
                         sketch, dev, flush),
            roofline_row("(a) sketch local_torch",
                         lambda: sketch_reference(A, SEED, R), sketch, dev,
                         flush),
            roofline_row("(b) nystrom_fused",
                         lambda: ops.nystrom_fused(A, seed=SEED, r=R),
                         sketch + 2.0 * N * R * R, dev, flush)]
    st = StreamingSketch(cfg)
    rows.append(roofline_row(f"(c) stream slab of {SLAB} rows",
                             lambda: st.update_rows(0, A[:SLAB]),
                             2.0 * SLAB * N * (R + L), dev, flush))
    svc = SketchService()
    scfg = [StreamConfig(S_N1, S_N2, r=S_R, seed=s) for s in range(RF_LANES)]
    items = [(svc.open(c), H, r0) for c, (H, r0) in zip(scfg, lanes)]

    def ragged():
        svc.update_ragged(items)
        svc.sync()
    rows.append(roofline_row(
        f"(d) update_ragged of {RF_LANES} lanes", ragged,
        sum(2.0 * k * S_N2 * (S_R + scfg[0].sketch_l) for k in ks), dev,
        flush))
    del svc, st
    st = StreamingSketch(cfg)
    rows.append(roofline_row("(e) update_rows_sparse of slab 1",
                             lambda: st.update_rows_sparse(0, slab),
                             2.0 * slab.nnz * (R + L), dev, flush))
    del st, A, flush
    torch.cuda.empty_cache()
    return rows


def observe_link(col, seen: list, stage: dict):
    """Time every flat all-gather and reduce-scatter that ``col`` (the
    port's ``parallel.collectives``) makes from here on, a synchronize on
    each side: each call appends ``(bytes this rank received / seconds,
    kind, bytes, seconds, stage["name"])`` to ``seen``.  Returns the undo.
    The calls are the port's own; only their clock is added."""
    flats = {"all_gather": "_all_gather_flat",
             "reduce_scatter": "_reduce_scatter_flat"}
    originals = {kind: getattr(col, attr) for kind, attr in flats.items()}

    def timed(kind, flat):
        def call(out, inp, **kwargs):
            cuda = inp.is_cuda
            if cuda:
                torch.cuda.synchronize(inp.device)
            t0 = time.perf_counter()
            res = flat(out, inp, **kwargs)
            if cuda:
                torch.cuda.synchronize(inp.device)
            s = time.perf_counter() - t0
            got = abs(out.numel() - inp.numel()) * inp.element_size()
            seen.append((got / s, kind, got, s, stage["name"]))
            return res
        return call

    for kind, attr in flats.items():
        setattr(col, attr, timed(kind, originals[kind]))

    def undo():
        for kind, attr in flats.items():
            setattr(col, attr, originals[kind])
    return undo


def link_probe(A) -> None:
    """RF_RANK_REPS gloo all-gathers of RF_PEAK_BLOCK over RF_PEAK_GRID's
    p3 fibers, every fiber at once, as Alg. 1 gathers, each after a
    barrier: rates for ``observe_link`` apart from the rows' own calls."""
    import torch.distributed as dist
    from repro_torch.core import sketch as sk
    from repro_torch.parallel import collectives as col
    g = sk.make_grid_groups(*RF_PEAK_GRID)
    x = A[:RF_PEAK_BLOCK[0], :RF_PEAK_BLOCK[1]].contiguous()
    for _ in range(RF_RANK_REPS):
        dist.barrier()
        col.all_gather(x, 1, g.p3_group, RF_PEAK_GRID[2])


def price_link(terms, link_bw: float):
    """``terms`` with its collective term priced on ``link_bw`` bytes/s,
    its bottleneck again the largest of the three terms."""
    t = dataclasses.replace(
        terms, link_bw=link_bw,
        t_collective=terms.collective_bytes / (terms.chips * link_bw))
    times = {"compute": t.t_compute, "memory": t.t_memory,
             "collective": t.t_collective}
    t.bottleneck = max(times, key=times.get)
    return t


def _roofline_rank(rank, world, t_spawn, device="cuda"):
    """Phase 20 (g)-(h), one rank (``device`` other than the card only to
    rehearse the phase on the CPU): ``link_probe``, then each call through
    ``analyze_call(chips=world)`` (the ranks' counts summed, the fleet's
    terms on every rank), the words this rank received a call (``COMM``),
    ``plan.model``'s words for it, and the median of RF_RANK_REPS runs
    (``default_timer``) between barriers; every gather and reduce-scatter
    of all that timed by ``observe_link``.  gloo's peak is the fastest
    rate of a call that received at least RF_PEAK_MIN_BYTES, on any rank,
    and every row's terms are priced on it at the end; ``fastest`` is this
    rank's fastest such call, ``marks`` the seconds since the parent's
    spawn (``t_spawn``, wall clock) at which each stage ended."""
    import torch.distributed as dist
    from repro_torch.core import nystrom as nys
    from repro_torch.core import sketch as sk
    from repro_torch.parallel import collectives as col
    from repro_torch.plan import alg1_cost, alg2_fused_cost, default_timer
    from repro_torch.roofline import analyze_call

    marks = [("started", time.time() - t_spawn)]
    dev = torch.device(device, 0)
    A = make_matrix(dev)
    same_matrix(A, rank, world)
    marks.append(("A made", time.time() - t_spawn))
    seen, stage = [], {"name": "link_probe"}
    out = []

    def row(name, fn, model_words, mf):
        stage["name"] = name
        dist.barrier()
        col.reset_comm()
        terms = analyze_call(name, fn, chips=world, model_flops=mf,
                             device=dev)
        words = col.comm_words() / 2      # the warm-up and the counted call
        dist.barrier()
        s = default_timer(fn, warmup=0, iters=RF_RANK_REPS, device=dev)
        out.append({"terms": terms, "words": words,
                    "model_words": model_words, "ms": s * 1e3})
        marks.append((name, time.time() - t_spawn))

    undo = observe_link(col, seen, stage)
    try:
        link_probe(A)
        marks.append(("link_probe", time.time() - t_spawn))
        for grid in RF_GRIDS:
            g = sk.make_grid_groups(*grid)
            blk = sk.input_block(A, g)
            row(f"(g) alg1 {grid}", lambda: sk.rand_matmul(blk, SEED, R, g),
                alg1_cost(N, N, R, grid).words, 2.0 * N * N * R)
            del blk
        p, q = RF_PAIR
        blk = sk.input_block(A, sk.make_grid_groups(*p))
        row(f"(h) nystrom_two_grid_fused {p} {q}",
            lambda: nys.nystrom_two_grid_fused(blk, SEED, R, p=p, q=q),
            alg2_fused_cost(N, R, p, q).words,
            2.0 * N * N * R + 2.0 * N * R * R)
    finally:
        undo()
    fastest = max(c for c in seen if c[2] >= RF_PEAK_MIN_BYTES)
    peak = torch.tensor([fastest[0]], dtype=torch.float64)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    for res in out:
        res["terms"] = price_link(res["terms"], float(peak)).to_dict()
    return {"rows": out, "marks": marks, "fastest": fastest,
            "calls": len(seen)}


def phase_roofline_ranks() -> list:
    """Phase 20 (g)-(h) on RF_WORLD ranks of cuda:0 over gloo: each row's
    fleet collective bytes held to its ranks' ``COMM`` words and to
    ``plan.model``'s; the row's time is the slowest rank's."""
    from repro_torch.roofline import h100_rates
    t_spawn = time.time()
    results = spawn_ranks(20, _roofline_rank, RF_WORLD, (t_spawn,))
    print("[roofline] rank 0's stages, seconds since the spawn: " + ", ".join(
        f"{label} {t:.1f}" for label, t in results[0]["marks"]))
    for rank, res in enumerate(results):
        rate, kind, got, s, where = res["fastest"]
        print(f"[roofline] rank {rank}: fastest of its {res['calls']} timed "
              f"gathers and reduce-scatters of at least "
              f"{RF_PEAK_MIN_BYTES} bytes: a {kind} in {where}, {got} bytes "
              f"received in {s * 1e3:.4f} ms, {rate:.6g} B/s")
    results = [res["rows"] for res in results]
    fit = h100_rates().link_bw
    peak = results[0][0]["terms"]["link_bw"]
    print(f"[roofline] gloo's peak, the fastest of those calls on any rank: "
          f"{peak:.6g} B/s received a rank ({2 ** 20 / peak * 1e3:.4f} ms "
          f"a MiB); the H100 entry's fit {fit:.6g} B/s "
          f"({2 ** 20 / fit * 1e3:.4f} ms a MiB)")
    rows = []
    for i, first in enumerate(results[0]):
        every = [res[i] for res in results]
        t = first["terms"]
        check(all(e["terms"] == t for e in every),
              f"phase 20: {t['name']}: the ranks' fleet terms differ")
        counted = sum(e["words"] for e in every) * 4
        model = first["model_words"] * RF_WORLD * 4
        print(f"[roofline] {t['name']}: t_collective at gloo's measured "
              f"peak {t['t_collective'] * 1e3:.4f} ms, at the H100 entry's "
              f"fit {t['collective_bytes'] / (t['chips'] * fit) * 1e3:.4f} "
              f"ms; collective bytes "
              f"{t['collective_bytes']:.0f}, the ranks' COMM words x 4 "
              f"{counted:.0f} ({[e['words'] for e in every]}), plan.model's "
              f"words x P x 4 {model:.0f}; each rank's ms "
              f"{[round(e['ms'], 4) for e in every]}")
        check(t["collective_bytes"] == counted == model,
              f"phase 20: {t['name']}: collective bytes "
              f"{t['collective_bytes']}, COMM {counted}, model {model}")
        rows.append({"terms": t, "ms": max(e["ms"] for e in every)})
    return rows


def roofline_report(rows: list, card: str, seconds: float) -> None:
    """Phase 20's rows and table, and its checks."""
    from repro_torch.roofline import format_table
    for row in rows:
        t, ms = row["terms"], row["ms"]
        ratio = t["t_bound"] * 1e3 / ms
        mf = t["model_flops"]
        share = mf / (t["chips"] * t["peak_flops"] * ms * 1e-3)
        row["ratio"], row["share"] = ratio, share
        print(f"[roofline] {t['name']}: chips {t['chips']}; counted FLOPs "
              f"{t['hlo_flops']:.0f}, device bytes {t['hlo_bytes']:.0f}, "
              f"collective bytes {t['collective_bytes']:.0f} "
              f"{t['collective_by_kind']}; t_compute "
              f"{t['t_compute'] * 1e3:.4f} ms, t_memory "
              f"{t['t_memory'] * 1e3:.4f} ms, t_collective "
              f"{t['t_collective'] * 1e3:.4f} ms, bottleneck "
              f"{t['bottleneck']}, t_bound {t['t_bound'] * 1e3:.4f} ms; "
              f"measured {ms:.4f} ms, t_bound/measured {ratio:.4f}; "
              f"model_flops {mf:.0f}, useful_ratio {t['useful_ratio']}, "
              f"roofline_fraction {t['roofline_fraction']:.4f}, model_flops"
              f"/(chips·peak_flops·measured) {share:.4f} (peak "
              f"{t['peak_flops']:.4g} FLOP/s, link {t['link_bw']:.6g} B/s; "
              f"peak memory "
              f"{t['per_device_peak_memory']}; {card})")
    print("[roofline] table (format_table):")
    print(format_table([row["terms"] for row in rows]))
    print("[roofline] summary " + json.dumps({
        "rows": [{"terms": row["terms"], "ms": row["ms"],
                  "t_bound_over_measured": row["ratio"],
                  "model_share_of_peak": row["share"]} for row in rows],
        "seconds": seconds, "card": card}))
    gemm = 2 * N * N * R
    for row in rows:
        t = row["terms"]
        check(0 < row["ratio"] <= RF_MAX_RATIO,
              f"phase 20: {t['name']}: t_bound / measured = {row['ratio']} "
              f"is outside (0, {RF_MAX_RATIO}]: a count or a rate is wrong")
        if t["name"].startswith("(a)"):
            check(t["hlo_flops"] == gemm,
                  f"phase 20: {t['name']} counted {t['hlo_flops']} FLOPs, "
                  f"not 2·{N}·{N}·{R} = {gemm}")
    check(sum(row["terms"]["name"].startswith("(a)") for row in rows) == 2,
          "phase 20: (a) needs both bodies")
    check(seconds < RF_SECONDS, f"phase 20 took {seconds:.1f} s, not under "
                                f"{RF_SECONDS} s")


# -- 21: recovery -------------------------------------------------------------

RC_WORLD = 4
RC_HOPS = [(2, 2, 1), (1, 2, 2), (2, 1, 1), (4, 1, 1)]   # from (4,1,1)
RC_SHRINK = [(2, 1, 1), (4, 1, 1)]       # (b): the hops of the plain 4 -> 2 -> 4
RC_SERVICE = ((2, 2, 1), (4, 1, 1))      # (b): a grid service's reshard
RC_QUEUE_N1 = 2048                       # (b): the grid queue's delta rows
RC_QUEUE_UPDATES = 3                     # (b): rounds of the grid queue
RC_CYCLES = 5                            # (a): spill / restore cycles timed
RC_DIR = ROOT / "build" / "repro_torch" / "recovery"
RC_SECONDS = 120                         # the phase's time limit


def _fresh_dir(path) -> str:
    import shutil
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return str(path)


def phase_recovery_one_card(dev, card: str, LAUNCHES,
                            reset_launches) -> dict:
    """Phase 21 (a): the one-card drills at phases 6-8's stream shape and
    a co-range stream spilled to disk and touched again, timed."""
    import os

    from repro_torch.stream import SketchService, StreamConfig
    from repro_torch.stream.faults import bits_equal, run_chaos_scenario

    work = _fresh_dir(RC_DIR / "one_card")
    shape = dict(n1=S_N1, n2=S_N2, r=S_R)
    reset_launches()
    out = {}
    for name, kw in (("kill-worker", dict(streams=32, updates=4)),
                     ("torn-write", {}),
                     ("eviction-storm", dict(streams=16))):
        t0 = time.perf_counter()
        res = run_chaos_scenario(name, workdir=os.path.join(work, name),
                                 verbose=False, device=dev, **shape, **kw)
        res["wall_s"] = time.perf_counter() - t0
        print(f"[recovery] (a) {name} at {S_N1}x{S_N2}, r = {S_R}: "
              f"recovered={res['recovered']} {res} ({card})")
        check(res["recovered"], f"phase 21: the {name} drill did not "
                                f"recover: {res}")
        out[name] = res
    kw = out["kill-worker"]
    print(f"[recovery] (a) WAL replay: {kw['replayed_records']} records "
          f"({kw['replayed_words']} words) in recover_s "
          f"{kw['recover_s']:.4f} s: "
          f"{kw['replayed_records'] / kw['recover_s']:.1f} records/s, a "
          f"fresh service included ({card})")
    # a co-range stream evicted to disk and touched again, bitwise
    svc = SketchService(spill_dir=os.path.join(work, "spill"), device=dev)
    cfg = StreamConfig(seed=SEED, **shape)
    sid = svc.open(cfg)
    g = torch.Generator(device=dev).manual_seed(21)
    svc.update(sid, torch.randn(S_KMAX, S_N2, generator=g, device=dev),
               row0=S_N1 // 3)
    Y, W = svc.sketch(sid).clone(), svc.corange(sid).clone()
    nbytes = (Y.numel() + W.numel()) * Y.element_size()
    writes, reads = [], []
    for _ in range(RC_CYCLES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.evict(sid)
        writes.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        got = svc.sketch(sid)
        torch.cuda.synchronize()
        reads.append(time.perf_counter() - t0)
        check(bits_equal(got, Y) and bits_equal(svc.corange(sid), W),
              "phase 21: the co-range stream restored from disk is not "
              "bitwise")
    w_ms, r_ms = (statistics.median(writes) * 1e3,
                  statistics.median(reads) * 1e3)
    print(f"[recovery] (a) spill of one co-range stream ({S_N1}x{S_R} Y + "
          f"{cfg.sketch_l}x{S_N2} W, {nbytes} bytes) to disk and back, "
          f"{RC_CYCLES} cycles, bitwise: write (ckpt.save, fsynced) "
          f"{w_ms:.3f} ms, {nbytes / w_ms / 1e3:.1f} MB/s; restore (read, "
          f"to the card, the directory removed) {r_ms:.3f} ms; each write "
          f"{[round(x * 1e3, 3) for x in writes]} ms, each restore "
          f"{[round(x * 1e3, 3) for x in reads]} ms ({card})")
    out["spill"] = {"bytes": nbytes, "write_ms": w_ms, "restore_ms": r_ms,
                    "writes_ms": [x * 1e3 for x in writes],
                    "restores_ms": [x * 1e3 for x in reads]}
    out["launches"] = {k: LAUNCHES[k] for k in ("sketch_fwd", "fold_rows",
                                                "sketch_t")}
    return out


def _hop_timed(fn):
    """``fn()`` between barriers, ended by a synchronize: (result, wall)."""
    import torch.distributed as dist
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _recovery_rank(rank, world, work, device="cuda"):
    """Phase 21 (b), one rank."""
    import os

    import torch.distributed as dist
    from repro_torch.core import sketch as sk
    from repro_torch.kernels.sketch_matmul import LAUNCHES, reset_launches
    from repro_torch.obs import install_ledger, uninstall_ledger
    from repro_torch.parallel import collectives as col
    from repro_torch.stream import (IngestQueue, ShardedStreamingSketch,
                                    SketchService, StreamConfig)
    from repro_torch.stream import distributed as sd
    from repro_torch.stream.elastic import (LEDGER_SITE,
                                            drain_reshard_resume,
                                            rank_words, reshard_stream)
    from repro_torch.stream.faults import bits_equal

    dev = torch.device(device)
    lines = []

    def say(msg):
        lines.append(f"[recovery] rank {rank}: {msg}")

    A = make_matrix(dev)
    same_matrix(A, rank, world)
    cfg = StreamConfig(N, N, r=R, seed=SEED)
    slabs = [(s * SLAB, A[s * SLAB:(s + 1) * SLAB]) for s in SD_ORDER]
    reset_launches()

    def gathered(Y, W, g):
        if g.coords is None:
            return None
        return sk.gather_output(Y, g), sd.gather_corange(W, g)

    def same(a, b):
        return all(bits_equal(x, y) for x, y in zip(a, b))

    def hop(st, new):
        """One observed hop: (stream, its record)."""
        old = st.mesh.shape
        led = install_ledger()
        try:
            col.reset_comm()
            st2, wall = _hop_timed(lambda: reshard_stream(st, new))
            words = col.COMM["redistribute"]["words"]
            site = next(x for x in led.sites() if x.name == LEDGER_SITE)
        finally:
            uninstall_ledger()
        want = rank_words(cfg, old, new, world)[rank]
        check(words == want == site.measured_words_per_call
              == site.predicted_words and site.drift == 0.0,
              f"rank {rank}: hop {old} -> {new}: COMM {words}, rank_words "
              f"{want}, ledger {site.measured_words_per_call} / "
              f"{site.predicted_words}, drift {site.drift}")
        return st2, {"old": old, "new": tuple(new), "words": words,
                     "wall_s": wall}

    # the hops of RC_HOPS with a slab before each, and the same slabs on the
    # same grids with the state carried by gathers (never resharded live)
    g0 = sk.make_grid_groups(world, 1, 1)
    st = ShardedStreamingSketch(cfg, g0, device=dev)
    Yf = torch.zeros(N, R, device=dev)
    Wf = torch.zeros(cfg.sketch_l, N, device=dev)
    grids = [(world, 1, 1)] + RC_HOPS
    hops = []
    for i, (r0, H) in enumerate(slabs[:len(grids)]):
        g = sk.make_grid_groups(*grids[i])
        if i:
            st, rec = hop(st, grids[i])
            hops.append(rec)
        st.update_rows(r0, H)
        if g.coords is not None:
            blk = sd.stream_blocks(cfg, g, Yf, Wf, device=dev)
            sd.sharded_update_rows(cfg, sk.seed_keys(SEED), blk["Y"],
                                   blk["W"], r0, H, g)
            Yf, Wf = gathered(blk["Y"], blk["W"], g)
        dist.broadcast(Yf, 0)
        dist.broadcast(Wf, 0)
    check(same(gathered(st.Y, st.W, st.mesh), (Yf, Wf)),
          f"rank {rank}: the stream resharded live along {grids} is not "
          f"bitwise the same slabs on the same grids carried by gathers")
    # the stream that never moved, on (4,1,1): the plain 4 -> 2 -> 4
    # sequence is bitwise it; the sequence above sums slabs on p2 = 2
    never = ShardedStreamingSketch(cfg, g0, device=dev)
    z = ShardedStreamingSketch(cfg, g0, device=dev)
    for i, (r0, H) in enumerate(slabs[:len(grids)]):
        never.update_rows(r0, H)
        if i < len(RC_SHRINK) + 1:
            if i:
                z, rec = hop(z, RC_SHRINK[i - 1])
                hops.append(rec)
            z.update_rows(r0, H)
        if i == len(RC_SHRINK):
            check(bits_equal(z.Y, never.Y) and bits_equal(z.W, never.W),
                  f"rank {rank}: the stream resharded {RC_SHRINK} is not "
                  f"bitwise the stream that never moved")
    full_never = gathered(never.Y, never.W, g0)
    errs = [rel_fro(a, b) for a, b in zip((Yf, Wf), full_never)]
    check(max(errs) <= f32_tol(N), f"rank {rank}: the resharded stream "
                                   f"departs from the one that never moved "
                                   f"by {errs}")
    say(f"(b) hops (4,1,1) -> {' -> '.join(map(str, RC_HOPS))} with a "
        f"{SLAB}-row slab before each: Y and W bitwise the same slabs on "
        f"the same grids carried by gathers, within {errs} of the stream "
        f"that never moved (the (2,2,1) and (1,2,2) slabs sum over p2); "
        f"(4,1,1) -> {' -> '.join(map(str, RC_SHRINK))}: bitwise the stream "
        f"that never moved; every hop's words = COMM = rank_words = the "
        f"ledger's, drift 0")
    del never, z, Yf, Wf, full_never

    # a grid service holding an evicted stream, spilled to disk
    old, new = RC_SERVICE
    svc = SketchService(mesh=sk.make_grid_groups(*old), max_resident=1,
                        spill_dir=os.path.join(work, "service"),
                        device=dev)
    a = svc.open(cfg)
    svc.update(a, A)
    snap = gathered(svc.sketch(a), svc.corange(a), svc.mesh)
    svc.open(StreamConfig(N, N, r=R, seed=SEED + 1))       # spills a
    check(svc.num_evicted == 1, f"rank {rank}: no stream was evicted")
    moved, wall = _hop_timed(lambda: svc.reshard(new))
    got = gathered(svc.sketch(a), svc.corange(a), svc.mesh)
    check(moved == 1 and same(got, snap),
          f"rank {rank}: the evicted stream is not bitwise after the "
          f"service's reshard {old} -> {new}")
    say(f"(b) a grid service's reshard {old} -> {new} with one stream "
        f"spilled to disk: {wall:.3f} s; the spilled stream touched again "
        f"on {new}, bitwise")
    service_wall = wall
    del svc, snap, got

    # drain -> reshard -> resume through grid-mode queues
    qcfg = [StreamConfig(RC_QUEUE_N1, N, r=R, seed=SEED + s, corange=False)
            for s in range(2)]
    gen = torch.Generator().manual_seed(2100)
    deltas = [[torch.randn(RC_QUEUE_N1, N, generator=gen).numpy()
               for _ in qcfg] for _ in range(RC_QUEUE_UPDATES)]
    ref = SketchService(mesh=g0, device=dev)
    svc = SketchService(mesh=g0, device=dev)
    rids = [ref.open(c) for c in qcfg]
    sids = [svc.open(c) for c in qcfg]
    arcs = []
    with IngestQueue(svc, window=rank + 1) as q:
        for u, grid in enumerate([(world // 2, 1, 1), (world, 1, 1), None]):
            for sid, H in zip(sids, deltas[u]):
                q.submit(sid, H)
            if grid is not None:
                # no barrier here: the queue's worker may still be applying
                # this round
                t0 = time.perf_counter()
                arc = drain_reshard_resume(q, grid)
                torch.cuda.synchronize()
                arcs.append((grid, arc, time.perf_counter() - t0))
        q.flush(raise_errors=True)
    for row in deltas:
        for rid, H in zip(rids, row):
            ref.update(rid, H)
    check(all(bits_equal(svc.sketch(s), ref.sketch(t))
              for s, t in zip(sids, rids)),
          f"rank {rank}: drain_reshard_resume is not bitwise the service "
          f"that was never disturbed")
    say(f"(b) drain_reshard_resume (4,1,1) -> (2,1,1) -> (4,1,1) through "
        f"a grid-mode queue (window {rank + 1}), {RC_QUEUE_UPDATES} rounds "
        f"of {len(qcfg)} {RC_QUEUE_N1}x{N} deltas: bitwise the service "
        f"that was never disturbed; "
        + ", ".join(f"{g}: {a} in {w:.3f} s" for g, a, w in arcs))
    launches = {k: LAUNCHES[k] for k in ("sketch_fwd", "fold_rows",
                                         "sketch_t")}
    return {"lines": lines, "hops": hops, "launches": launches,
            "service_wall_s": service_wall,
            "arcs": [(g, a, w) for g, a, w in arcs]}


def phase_recovery_ranks(card: str) -> list:
    """Phase 21 (b) on RC_WORLD ranks of cuda:0 over gloo: each hop's
    slowest rank, its words against ``stream_reshard_words``."""
    from repro_torch.plan.model import stream_reshard_words
    work = _fresh_dir(RC_DIR / "ranks")
    results = spawn_ranks(21, _recovery_rank, RC_WORLD, (work,))
    for res in results:
        for line in res["lines"]:
            print(line)
    L = 2 * R + 1
    for i, first in enumerate(results[0]["hops"]):
        every = [res["hops"][i] for res in results]
        old, new = first["old"], first["new"]
        words = [e["words"] for e in every]
        walls = [e["wall_s"] for e in every]
        want = stream_reshard_words(N, R, old, new, l=L, n2=N, corange=True)
        print(f"[recovery] (b) hop {old} -> {new}: wall {max(walls):.4f} s "
              f"(slowest rank {walls.index(max(walls))}; each "
              f"{[round(w, 4) for w in walls]}); words a rank {words}, "
              f"{[round(w * 4 / 2 ** 20, 3) for w in words]} MiB, the most "
              f"{max(words)} = stream_reshard_words {want:.0f} ({card})")
        check(max(words) == want,
              f"phase 21: hop {old} -> {new}: the most words a rank "
              f"{max(words)}, stream_reshard_words {want}")
    for name in ("sketch_fwd", "fold_rows", "sketch_t"):
        n = [res["launches"][name] for res in results]
        check(all(x > 0 for x in n), f"phase 21: {name} not launched on "
                                     f"every rank: {n}")
    return results


def phase_recovery_launcher() -> float:
    """Phase 21 (c): ``python -m repro_torch.launch.serve --chaos all`` on
    the card, as a subprocess; exit 0."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--chaos", "all"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.startswith("[chaos] ") and ": " in line:
            print(f"[recovery] (c) {line}")
    check(proc.returncode == 0, f"phase 21: --chaos all exited "
                                f"{proc.returncode}:\n{proc.stdout[-3000:]}"
                                f"\n{proc.stderr[-3000:]}")
    print(f"[recovery] (c) python -m repro_torch.launch.serve --chaos all: "
          f"exit 0 in {wall:.1f} s")
    return wall


# -- phase 22: data-parallel training on four ranks ---------------------------

def param_sums(params) -> torch.Tensor:
    """A checksum of every leaf's bits: the sum of its 16- or 32-bit words
    and their sum weighted by position (mod 65521), in int64, taken in
    chunks; equal on two replicas whose params are bitwise equal."""
    from repro_torch.models import param_leaves
    out = []
    for _, t in param_leaves(params):
        flat = t.detach().reshape(-1)
        bits = flat.view(torch.int16 if flat.element_size() == 2
                         else torch.int32)
        s0 = s1 = 0
        for c in range(0, bits.numel(), 1 << 26):
            x = bits[c:c + (1 << 26)].to(torch.int64)
            w = torch.arange(c, c + x.numel(), device=x.device) % 65521 + 1
            s0 += int(x.sum())
            s1 += int((x * w).sum())
            del x, w
        out += [s0, s1]
    return torch.tensor(out, dtype=torch.int64)


def same_replicas(params, group, what: str) -> None:
    """Every rank of ``group`` must hold the same params, bit for bit."""
    import torch.distributed as dist
    mine = param_sums(params)
    every = [torch.zeros_like(mine)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, mine, group=group)
    check(all(torch.equal(e, mine) for e in every),
          f"phase 22: the replicas' params differ {what}")


def _all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the world's ranks, in place."""
    import torch.distributed as dist
    dist.all_reduce(t)
    return t.div_(dist.get_world_size())


def _dp_train_rank(rank, world, work, device="cuda"):
    """Phase 22 (a) and (b), one rank."""
    import shutil

    import torch.distributed as dist
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import RunConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import local
    from repro_torch.kernels.sketch_matmul import LAUNCHES, reset_launches
    from repro_torch.launch.elastic import elastic_restore, remesh
    from repro_torch.models import get_api, param_leaves
    from repro_torch.parallel import grad_compress as gcomp
    from repro_torch.parallel.grad_compress import reshard_error_fb
    from repro_torch.plan import plan_train_compression
    from repro_torch.train import (init_state, make_dp_compressed_step,
                                   train_loop)

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    lines, out = [], {}

    def say(msg):
        lines.append(f"[dp-train] rank {rank}: {msg}")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def gib(x):
        return round(x / 2 ** 30, 3)

    cfg = phase_config("gemma2-2b", n_layers=DP_LAYERS)
    api = get_api(cfg)
    shapes = api.init(0, cfg, "meta")
    plan = plan_train_compression(shapes, rank=T_R, P=world)
    dec = plan.decision_tree()
    raw = dataclasses.replace(plan, decisions=tuple(
        dataclasses.replace(d, compress=False) for d in plan.decisions))
    data = DataConfig(cfg.vocab, T_SEQ, T_BATCH, seed=0)
    run = RunConfig(steps=DP_SKETCHED, learning_rate=1e-4, warmup_steps=2,
                    checkpoint_every=0, grad_compress_rank=T_R)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    state = init_state(api, cfg, run, 0, dev, decisions=dec)
    sync()
    n_params = sum(t.numel() for _, t in param_leaves(state.params))
    held = torch.cuda.memory_allocated() if on_card else 0
    out["state"] = {"params": n_params, "held_gib": gib(held)}
    same_replicas(state.params, None, "at the start")

    def loop(step_fn, run_, group=None):
        """``train_loop`` with each step's COMM words, exchange ms and a
        replica check."""
        words, ex_ms, seen = [], [], [gcomp.COMM["words"]]

        def on_step(i, metrics):
            words.append(gcomp.COMM["words"] - seen[0])
            seen[0] = gcomp.COMM["words"]
            if step_fn.exchange is not None:
                start, end = step_fn.exchange
                end.synchronize()
                ex_ms.append(start.elapsed_time(end))
            same_replicas(state.params, group, f"after step {i}")
        first = state.step
        res = train_loop(step_fn, state, data, run_, device=dev,
                         on_step=on_step)
        check(len(res.losses) == run_.steps - first
              and all(math.isfinite(x) for x in res.losses),
              f"phase 22: rank {rank}'s losses {res.losses}")
        return res, words, ex_ms

    # (a) sketched steps, then one all-raw step
    sketched = make_dp_compressed_step(api, cfg, run, plan=plan)
    reset_launches()
    res, words, ex_ms = loop(sketched, run)
    sync()
    launches = dict(LAUNCHES)
    run_raw = dataclasses.replace(run, steps=DP_SKETCHED + DP_RAW)
    raw_step = make_dp_compressed_step(api, cfg, run_raw, plan=raw)
    res_raw, raw_words, raw_ms = loop(raw_step, run_raw)
    want = gcomp.comm_words_compressed(shapes, T_R, dec)
    want_raw = gcomp.comm_words_exact(shapes)
    check(words == [want + 1] * DP_SKETCHED,
          f"phase 22: rank {rank} counted {words} words a step, the plan "
          f"{want} + 1")
    check(raw_words == [want_raw + 1] * DP_RAW,
          f"phase 22: rank {rank} counted {raw_words} words in the raw "
          f"step, comm_words_exact {want_raw} + 1")
    nc = plan.n_compressed
    check(launches.get("gemm") == 3 * nc * DP_SKETCHED
          and launches.get("sketch_fwd") == nc * DP_SKETCHED,
          f"phase 22: rank {rank} launched {launches} in {DP_SKETCHED} "
          f"steps of {nc} compressed leaves")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    steady = res.step_seconds[1:]
    out["a"] = {"losses": res.losses + res_raw.losses, "words": words,
                "raw_words": raw_words, "exchange_ms": ex_ms,
                "raw_exchange_ms": raw_ms, "step_s": res.step_seconds,
                "raw_step_s": res_raw.step_seconds,
                "median_step_s": statistics.median(steady),
                "tokens_per_s": T_BATCH * T_SEQ / statistics.median(steady),
                "peak_gib": gib(peak), "launches": launches,
                "n_compressed": nc, "exchange_words": want,
                "raw_words_plan": want_raw}
    say(f"{n_params} params, {gib(held)} GiB held after init; losses "
        f"{[round(x, 4) for x in out['a']['losses']]}; exchange "
        f"{want} words a step ({[round(t, 3) for t in ex_ms]} ms), all-raw "
        f"{want_raw} ({[round(t, 3) for t in raw_ms]} ms); steps "
        f"{[round(t, 4) for t in res.step_seconds]} s, raw "
        f"{[round(t, 4) for t in res_raw.step_seconds]} s; peak "
        f"{gib(peak)} GiB; launches {launches}")

    # one exchange across the ranks against its plain version
    m, n = (128, 128) if REDUCED else (4608, 9216)
    g = torch.Generator(device=dev).manual_seed(220 + rank)
    grad = torch.randn(m, n, generator=g, device=dev)
    fb = 0.1 * torch.randn(m, n, generator=g, device=dev)
    seed = gcomp.leaf_seed(0, 3)            # leaf 0 of {"w": ...}, step 3
    want_g, want_e = _plain_exchange(local, grad, fb, seed, T_R,
                                     _all_reduce_mean)
    grads, fbs = {"w": grad}, {"w": fb.clone()}
    gcomp.compress_and_allreduce(grads, fbs, step=3, rank=T_R,
                                 decisions={"w": True})
    err = (rel_fro(grads["w"], want_g), rel_fro(fbs["w"], want_e))
    out["exchange_err"] = err
    check(max(err) <= gemm_tol(m), f"phase 22: rank {rank}'s exchange "
                                   f"disagrees with its plain version {err}")
    del grad, fb, grads, fbs, want_g, want_e
    if on_card:
        torch.cuda.empty_cache()

    # (b) the DP checkpoint at world 4, then 4 -> 2
    dist.barrier()
    t0 = time.perf_counter()
    path = ckpt.save(work, state.step, state, world=world)
    sync()
    save_s = time.perf_counter() - t0
    written = sum(f.stat().st_size for f in pathlib.Path(path).iterdir())
    saved = {n: t.detach().cpu().clone()
             for n, t in param_leaves(state.params)} if rank < DP_TO else {}
    out["b"] = {"save_s": save_s, "written_gb": written / 1e9}
    group = remesh(range(world), dp=DP_TO)
    out["b"]["standby"] = group is None
    if group is None:
        del state, res, res_raw
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        say(f"stands by after the DP checkpoint ({save_s:.2f} s)")
        dist.barrier()
        return {"lines": lines, **out}
    with torch.no_grad():
        for t in ckpt.state_tensors(state).values():
            t.zero_()
    state.step, state.opt.count = 0, 0
    sync()
    t0 = time.perf_counter()
    state, step_at, _ = elastic_restore(work, state, group=group)
    sync()
    restore_s = time.perf_counter() - t0
    me = dist.get_rank(group)
    check(all(torch.equal(t.detach().cpu(), saved[n])
              for n, t in param_leaves(state.params)),
          f"phase 22: rank {rank}'s restored params differ from the saved")
    del saved
    manifest, _, _, step_dir = ckpt.load_train_step(work, step_at)
    files = [ckpt.load_rank(step_dir, manifest, k) for k in range(world)]
    for n, t in param_leaves(state.error_fb):
        name = f"error_fb.{n}"
        stack = torch.stack([f[name].to(dev) for f in files])
        expect = reshard_error_fb({n: stack}, world, DP_TO)[n][me]
        check(torch.equal(t, expect), f"phase 22: rank {rank}'s restored "
                                      f"buffer {n} is not reshard_error_fb")
        del stack, expect
    del files
    if on_card:
        torch.cuda.empty_cache()
    run2 = dataclasses.replace(run, steps=state.step + DP_AFTER)
    res2, words2, ms2 = loop(make_dp_compressed_step(api, cfg, run2,
                                                     plan=plan, group=group),
                             run2, group)
    out["b"].update({"restore_s": restore_s, "step": step_at,
                     "losses": res2.losses, "step_s": res2.step_seconds,
                     "exchange_ms": ms2, "words": words2})
    say(f"DP checkpoint {written / 1e9:.3f} GB in {save_s:.2f} s; "
        f"elastic_restore onto {DP_TO} ranks in {restore_s:.2f} s, bitwise; "
        f"losses at world {DP_TO} {[round(x, 4) for x in res2.losses]}, "
        f"steps {[round(t, 4) for t in res2.step_seconds]} s")
    dist.barrier()
    return {"lines": lines, **out}


def phase_dp_launcher() -> float:
    """Phase 22 (c): ``python -m repro_torch.launch.train`` as two ranks of
    one gloo group on the card, ``--grad-compress 4``; both exit 0 and
    rank 0's checkpoint holds both rank files."""
    import os
    import shutil
    import tempfile
    work = DP_DIR / "launcher"
    shutil.rmtree(work, ignore_errors=True)
    store = tempfile.mkdtemp(prefix="chip_smoke_phase22_")
    env = dict(os.environ, WORLD_SIZE="2", PYTHONPATH=str(ROOT / "src") + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *DP_LAUNCHER,
           "--ckpt-dir", str(work / "ckpt"), "--init-method",
           f"file://{store}/store"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r),
                                            LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=ROOT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(store, ignore_errors=True)
    wall = time.perf_counter() - t0
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"phase 22: launcher rank {r} exited "
                                 f"{p.returncode}:\n{o[-3000:]}\n{e[-3000:]}")
    for line in outs[0][0].splitlines():
        if line.startswith("[train]"):
            print(f"[dp-train] (c) rank 0: {line}")
    steps = sorted((work / "ckpt").glob("step_*"))
    files = sorted(p.name for p in steps[-1].iterdir()) if steps else []
    check(files == ["error_fb.rank0.pt", "error_fb.rank1.pt",
                    "manifest.json", "tensors.pt"],
          f"phase 22: the launcher's checkpoint holds {files}")
    shutil.rmtree(work, ignore_errors=True)
    print(f"[dp-train] (c) python -m repro_torch.launch.train, 2 ranks on "
          f"the card over gloo: exit 0 and 0 in {wall:.1f} s; "
          f"{steps[-1].name} holds {files}")
    return wall


def phase_dp_train(card: str) -> dict:
    """Phase 22: (a)-(b) on DP_WORLD ranks of cuda:0, then (c)."""
    import shutil
    t0 = time.perf_counter()
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(DP_DIR).free
    # the checkpoint: bf16 params and f32 moments once, f32 buffers a rank
    print(f"[dp-train] free space under {DP_DIR}: {free / 1e9:.1f} GB; "
          f"this process holds "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB of the card")
    check(free > DP_MIN_FREE, f"phase 22: {free / 1e9:.1f} GB free, the "
                              f"DP checkpoint needs about 17.4")
    work = str(DP_DIR / "ckpt")
    try:
        results = spawn_ranks(22, _dp_train_rank, DP_WORLD, (work,))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for res in results:
        for line in res["lines"]:
            print(line)
    a = [res["a"] for res in results]

    def med(xs):
        return statistics.median(xs) if xs else float("nan")
    for name in ("gemm", "sketch_fwd"):
        n = [x["launches"].get(name, 0) for x in a]
        check(all(x > 0 for x in n), f"phase 22: {name} not launched on "
                                     f"every rank: {n}")
    steady = max(x["median_step_s"] for x in a)
    print(f"[dp-train] (a) gemma2-2b, {DP_LAYERS} layers, "
          f"{results[0]['state']['params']} params a rank; "
          f"{a[0]['n_compressed']} leaves sketched at P={DP_WORLD}: "
          f"{a[0]['exchange_words']} words a step a rank against "
          f"{a[0]['raw_words_plan']} raw; sketched exchange ms (each rank, "
          f"after the warm-up) "
          f"{[round(med(x['exchange_ms'][1:]), 3) for x in a]}, "
          f"all-raw {[round(med(x['raw_exchange_ms']), 3) for x in a]}; "
          f"median step {steady:.4f} s (slowest rank), "
          f"{T_BATCH * T_SEQ / steady:.1f} tokens/s; all-raw step "
          f"{max(x['raw_step_s'][0] for x in a):.4f} s; peak memory a rank "
          f"{[x['peak_gib'] for x in a]} GiB; exchange vs plain "
          f"{[tuple(f'{e:.2e}' for e in res['exchange_err']) for res in results]} "
          f"({card})")
    b = results[0]["b"]
    print(f"[dp-train] (b) DP checkpoint at world {DP_WORLD}: "
          f"{b['written_gb']:.3f} GB written (rank 0's params and moments, "
          f"each rank's buffers) in "
          f"{max(res['b']['save_s'] for res in results):.2f} s; "
          f"elastic_restore onto {DP_TO} ranks "
          f"{[round(res['b']['restore_s'], 2) for res in results[:DP_TO]]} "
          f"s; losses at world {DP_TO} {b['losses']}, steps "
          f"{[round(t, 4) for t in b['step_s']]} s ({card})")
    check([res["b"]["standby"] for res in results]
          == [k >= DP_TO for k in range(DP_WORLD)],
          "phase 22: the wrong ranks stood by")
    launcher_s = phase_dp_launcher()
    seconds = time.perf_counter() - t0
    check(seconds < DP_SECONDS, f"phase 22 took {seconds:.1f} s, not under "
                                f"{DP_SECONDS} s")
    return {"ranks": [{k: res[k] for k in ("state", "a", "b",
                                           "exchange_err")}
                      for res in results],
            "launcher_s": launcher_s, "seconds": seconds, "card": card}


# -- phase 23: LM serving (dense family) at gemma2-2b's published size -------

def lm_decode_profile(api, params, cfg, tok, caches, pos: int) -> dict:
    """LM_PROFILED decode steps under torch.profiler: the card's idle
    share inside the ``lm.decode_window`` range, and its device events a
    step."""
    def steps():
        nonlocal tok, caches
        for i in range(LM_PROFILED):
            logits, caches = api.decode_step(params, cfg, tok, caches,
                                             pos + i)
            tok = logits.argmax(-1)
    dev, w0, w1 = profiled(steps, "lm.decode_window")
    busy = device_busy_us(dev, w0, w1)
    inside = [e for e in dev if w0 <= e.time_range.start <= w1]
    return {"window_ms": (w1 - w0) * 1e-3, "busy_ms": busy * 1e-3,
            "idle_share": 1.0 - busy / (w1 - w0),
            "device_events_a_step": len(inside) / LM_PROFILED}


def timed_decode(api, params, cfg, tok, cache, pos0: int, n: int):
    """``n`` greedy decode steps from ``tok`` at positions ``pos0``,
    ``pos0 + 1``, ..., each timed by CUDA events: the steps' ms, their
    median and range after the first, tokens/s at that median and over
    the loop on the host clock, whether every logit was finite; then the
    last logits, token and cache."""
    finite, marks = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = api.decode_step(params, cfg, tok, cache, pos0 + i)
        end.record()
        marks.append((start, end))
        finite.append(torch.isfinite(logits).all())
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    step_ms = [s.elapsed_time(e) for s, e in marks]
    decode_ms = statistics.median(step_ms[1:])
    batch = tok.shape[0]
    return {"step_ms": step_ms, "decode_ms": decode_ms,
            "decode_ms_range": [min(step_ms[1:]), max(step_ms[1:])],
            "tokens_per_s": batch / decode_ms * 1e3,
            "loop_tokens_per_s": batch * n / loop_s,
            "finite": bool(torch.stack(finite).all())}, logits, tok, cache


def lm_prefill_decode(dev, api, params, cfg, n_params: int, card: str,
                      tag: str = "[lm-serve] (a)", decode: int = LM_DECODE):
    """Phase 23 (a) (and 24 (b), 26 (c)): prefill LM_BATCH x LM_PROMPT
    (max_len LM_MAX_LEN), then ``decode`` greedy decode steps, each timed
    by CUDA events; every logit finite; a decode step's counted bytes
    (``analyze_call``) beside the bytes it must move and its time."""
    import types

    from repro_torch.models import model_flops, param_leaves
    from repro_torch.roofline import analyze_call, h100_rates
    g = np.random.default_rng(0)
    toks = torch.from_numpy(g.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT))
                            ).to(dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = time_ms(lambda: api.prefill(params, cfg, toks,
                                             max_len=LM_MAX_LEN))
    logits, caches = api.prefill(params, cfg, toks, max_len=LM_MAX_LEN)
    finite = bool(torch.isfinite(logits).all())
    dec, logits, tok, caches = timed_decode(
        api, params, cfg, logits.argmax(-1), caches, LM_PROMPT, decode)
    peak = torch.cuda.max_memory_allocated()
    check(finite and dec["finite"], f"{tag}: a logit is not finite")
    check(tuple(logits.shape) == (LM_BATCH, 1, cfg.vocab),
          f"{tag}: logits {tuple(logits.shape)}")
    decode_ms = statistics.median(dec["step_ms"][1:6])
    steady_ms = dec["decode_ms"]
    pos = LM_PROMPT + decode
    prof = lm_decode_profile(api, params, cfg, tok, caches, pos)
    pos += LM_PROFILED
    shape = types.SimpleNamespace(global_batch=LM_BATCH, seq_len=LM_MAX_LEN,
                                  kind="decode")
    terms = analyze_call("decode step", lambda: api.decode_step(
        params, cfg, tok, caches, pos), model_flops=model_flops(
        cfg, shape, n_params), device=dev)
    # what a step must move: every weight and every cache read once, the
    # new K/V rows and the logits written once
    must = (sum(t.numel() * t.element_size()
                for _, t in param_leaves(params))
            + sum(c[kv].numel() * c[kv].element_size()
                  for c in caches for kv in c)
            + logits.numel() * logits.element_size())
    must_ms = must / h100_rates().hbm_bw * 1e3
    out = {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
           "decode_steady_ms": steady_ms,
           "decode_ms_range": dec["decode_ms_range"],
           "tokens_per_s": LM_BATCH / decode_ms * 1e3,
           "loop_tokens_per_s": dec["loop_tokens_per_s"],
           "peak_gib": peak / 2 ** 30, "held_gib": held / 2 ** 30, **prof,
           "counted_bytes": terms.hlo_bytes, "counted_flops": terms.hlo_flops,
           "t_memory_ms": terms.t_memory * 1e3,
           "t_bound_ms": terms.t_bound * 1e3, "bottleneck": terms.bottleneck,
           "must_move_bytes": must, "must_move_ms": must_ms}
    print(f"{tag} {cfg.name}, {n_params} params: prefill "
          f"{LM_BATCH}x{LM_PROMPT} (max_len {LM_MAX_LEN}) {prefill_ms:.3f} "
          f"ms (CUDA events, median of 5 after a warm-up, "
          f"{LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.1f} prompt tokens/s); "
          f"decode step {decode_ms:.3f} ms (median of steps 2-6), "
          f"{steady_ms:.3f} ms (median of steps 2-{decode}; range "
          f"{out['decode_ms_range'][0]:.3f}-{out['decode_ms_range'][1]:.3f}"
          f"), {out['tokens_per_s']:.1f} tokens/s at batch {LM_BATCH} "
          f"({out['loop_tokens_per_s']:.1f} over the {decode}-step loop "
          f"on the host clock); peak memory {out['peak_gib']:.2f} GiB "
          f"(max_memory_allocated; {out['held_gib']:.2f} GiB held before "
          f"the prefill, the weights included); every logit finite "
          f"({card})")
    print(f"{tag} profiled decode window ({LM_PROFILED} steps): "
          f"{prof['window_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} "
          f"ms, idle share {prof['idle_share']:.3f}, "
          f"{prof['device_events_a_step']:.0f} device events a step")
    print(f"{tag} one decode step counted: {terms.hlo_bytes:.4e} "
          f"device bytes, {terms.hlo_flops:.4e} FLOPs, bound "
          f"{terms.t_bound * 1e3:.3f} ms by {terms.bottleneck}; must move "
          f"{must:.4e} bytes (weights, caches, logits once): "
          f"{must_ms:.3f} ms at {h100_rates().hbm_bw / 1e12:.2f} TB/s, "
          f"{must_ms / decode_ms:.4f} of the measured {decode_ms:.3f} ms")
    return out


def lm_ring_handoff(dev, api, params, cfg, tol: float, card: str) -> dict:
    """Phase 23 (b), in ``cfg.dtype``: one LM_RING_PROMPT-token prompt,
    past the window, so the windowed layers' caches are rings; prefill
    (max_len LM_RING_MAX_LEN), then LM_RING_STEPS teacher-forced decode
    steps, every step's logits within ``tol`` (relative Frobenius) of
    ``lm_hidden`` plus the head over the same tokens; the same steps with
    every ring rolled by one slot (the newest prompt key overwritten
    first) are reported beside them."""
    from repro_torch.models import lm_hidden
    from repro_torch.models.common import matmul, softcap
    g = np.random.default_rng(1)
    P, n = LM_RING_PROMPT, LM_RING_STEPS
    toks = torch.from_numpy(g.integers(0, cfg.vocab, (1, P + n))).to(dev)
    first, caches = api.prefill(params, cfg, toks[:, :P],
                                max_len=LM_RING_MAX_LEN)
    windows = cfg.layer_windows(LM_RING_MAX_LEN)
    lens = [c["k"].shape[1] for c in caches]
    check(lens == [min(w, LM_RING_MAX_LEN) for w in windows] and
          min(lens) < P, f"phase 23 (b): cache lengths {lens}")
    control = [{kv: (torch.roll(c[kv], 1, dims=1) if c[kv].shape[1] < P
                     else c[kv].clone()) for kv in c} for c in caches]
    real, ctrl = [], []
    for t in range(P, P + n):
        logits, caches = api.decode_step(params, cfg, toks[:, t:t + 1],
                                         caches, t)
        real.append(logits[:, 0])
        logits, control = api.decode_step(params, cfg, toks[:, t:t + 1],
                                          control, t)
        ctrl.append(logits[:, 0])
    with torch.inference_mode():
        h, _ = lm_hidden(params, cfg, toks, remat=False)
        W = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        ref = softcap(matmul(h[:, P - 1:], W.T), cfg.final_softcap)[0]
    real, ctrl = torch.cat(real), torch.cat(ctrl)
    out = {"dtype": cfg.dtype, "prefill_err": rel_fro(first[0, 0], ref[0]),
           "err": rel_fro(real, ref[1:]),
           "step_err_max": max(rel_fro(real[i], ref[1 + i])
                               for i in range(n)),
           "control_err": rel_fro(ctrl, ref[1:]),
           "control_step_err_min": min(rel_fro(ctrl[i], ref[1 + i])
                                       for i in range(n)),
           "tol": tol, "ring_lens": sorted(set(lens))}
    print(f"[lm-serve] (b) {cfg.dtype}: ring hand-off at {P} + {n} tokens "
          f"(rings of {min(lens)}, full caches of {max(lens)}): relative "
          f"Frobenius against lm_hidden + head: prefill's last logits "
          f"{out['prefill_err']:.3e}, the {n} decode steps {out['err']:.3e} "
          f"(worst step {out['step_err_max']:.3e}); rings rolled by one "
          f"slot {out['control_err']:.3e} (best step "
          f"{out['control_step_err_min']:.3e}); limit {tol} ({card})")
    check(out["prefill_err"] <= tol and out["step_err_max"] <= tol,
          f"phase 23 (b): {cfg.dtype} prefill or decode after the ring "
          f"hand-off misses the forward: {out['prefill_err']:.3e}, "
          f"{out['step_err_max']:.3e} > {tol}")
    return out


def _to_float32(tree):
    if isinstance(tree, dict):
        return {k: _to_float32(v) for k, v in tree.items()}
    return tree.float()


def phase_lm_launcher(argv=None, tag: str = "[lm-serve] (c)") -> dict:
    """Phase 23 (c) (and 24 (f)): ``python -m repro_torch.launch.serve
    --workload lm`` with ``argv`` (LM_LAUNCHER: gemma2-2b at its published
    size) as a subprocess: exit 0, its ``[serve]`` line and tokens/s."""
    argv = LM_LAUNCHER if argv is None else argv
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *argv], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"{tag}: the launcher exited "
                               f"{out.returncode}:\n{out.stdout[-3000:]}\n"
                               f"{out.stderr[-3000:]}")
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[serve]")]
    found = re.search(r"([0-9.]+) tokens/s", lines[-1]) if lines else None
    check(found is not None, f"{tag}: no [serve] line with "
                             f"tokens/s:\n{out.stdout[-3000:]}")
    print(f"{tag} {' '.join(argv)}: exit 0 in {wall:.1f} s "
          f"(process included); {lines[-1]}")
    return {"line": lines[-1], "tokens_per_s": float(found.group(1)),
            "wall_s": wall}


def phase_lm_serve(dev, card: str) -> dict:
    """Phase 23: (a) prefill and decode, (b) the ring hand-off, (c) the
    launcher, at gemma2-2b's published size on the card."""
    from repro_torch.models import get_api, param_leaves
    t0 = time.perf_counter()
    cfg = phase_config(LM_ARCH)
    api = get_api(cfg)
    params = api.init(0, cfg, dev)
    n_params = sum(t.numel() for _, t in param_leaves(params))
    check(REDUCED or n_params == 2_614_341_888,
          f"phase 23: {n_params} parameters")
    print(f"[lm-serve] {cfg.name}: {n_params} parameters ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads, kv "
          f"{cfg.n_kv_heads}, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.dtype}), random weights from seed 0, "
          f"on the card in {time.perf_counter() - t0:.1f} s")
    a = lm_prefill_decode(dev, api, params, cfg, n_params, card)
    gc.collect()
    torch.cuda.empty_cache()
    b = [lm_ring_handoff(dev, api, params, cfg, LM_RING_TOL_BF16, card)]
    # in bf16 the forward's bf16 scores miss decode's f32 ones by about as
    # much as a ring rolled by one slot moves the logits; in float32 the
    # two paths differ only by the order of their sums, so the control is
    # held there
    params = _to_float32(params)
    b.append(lm_ring_handoff(dev, api, params,
                             dataclasses.replace(cfg, dtype="float32"),
                             LM_RING_TOL, card))
    check(b[1]["control_step_err_min"] > LM_RING_TOL,
          f"phase 23 (b): a step with the rings rolled by one slot is within "
          f"the limit: {b[1]['control_step_err_min']:.3e} <= {LM_RING_TOL}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    c = phase_lm_launcher()
    seconds = time.perf_counter() - t0
    check(seconds < LM_SECONDS, f"phase 23 took {seconds:.1f} s, not under "
                                f"{LM_SECONDS} s")
    return {"a": a, "b": b, "c": c, "seconds": seconds, "card": card}


# -- phase 24: MoE (granite-moe-1b-a400m; dbrx-132b on 8 layers) -------------

@contextlib.contextmanager
def moe_route_log():
    """While open, each ``moe_routes`` call (every MoE layer of a forward
    or a decode step) appends (dropped assignments, assignments, smallest
    top-k margin: the k-th probability less the (k+1)-th) as tensors on
    the device, so that a step is not synchronised; ``moe_route_sums``
    reads them."""
    from repro_torch.models import ffn
    routes, log = ffn.moe_routes, []

    def logged(params, xt, *, top_k, **kw):
        r = routes(params, xt, top_k=top_k, **kw)
        top = torch.topk(r.probs, top_k + 1, dim=-1).values
        log.append(((~r.keep).sum(), r.keep.numel(),
                    (top[:, top_k - 1] - top[:, top_k]).min()))
        return r
    ffn.moe_routes = logged
    try:
        yield log
    finally:
        ffn.moe_routes = routes


def moe_route_sums(log: list) -> dict:
    dropped = sum(int(d) for d, _, _ in log)
    total = sum(n for _, n, _ in log)
    return {"calls": len(log), "dropped": dropped, "assignments": total,
            "drop_share": dropped / max(total, 1),
            "min_margin": min(float(m) for _, _, m in log)}


def exchange_train(dev, cfg, LAUNCHES, reset_launches, card: str, *,
                   tag: str, steps: int, n_params: int, n_compressed: int,
                   on_first_step=None, data=None) -> dict:
    """``cfg`` through ``train_loop`` (the plan priced for T_PLAN_WORKERS
    workers at rank T_R), ``steps`` steps of ``data`` (a ``DataConfig``;
    by default T_BATCH x T_SEQ tokens), the counts reset just before the
    loop: every loss and gradient norm finite, one sketch_fwd and three
    gemm launches a compressed leaf a step, the median step after the
    first, tokens/s (a VLM's frontend tokens counted), the exchange's
    CUDA-event ms, peak memory.  ``n_params`` and ``n_compressed`` are
    checked unless REDUCED; ``on_first_step()`` runs after step 1."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.configs import RunConfig
    from repro_torch.models import get_api, param_leaves
    from repro_torch.plan import plan_train_compression
    from repro_torch.train import (init_state, make_dp_compressed_step,
                                   train_loop)
    api = get_api(cfg)
    run = RunConfig(steps=steps, learning_rate=1e-4, warmup_steps=2,
                    checkpoint_every=0, grad_compress_rank=T_R)
    plan = plan_train_compression(api.init(0, cfg, "meta"), rank=T_R,
                                  P=T_PLAN_WORKERS)
    check(REDUCED or plan.n_compressed == n_compressed,
          f"{tag}: the plan compresses {plan.n_compressed} leaves, not "
          f"{n_compressed}")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(api, cfg, run, 0, dev, decisions=plan.decision_tree())
    torch.cuda.synchronize()
    got = sum(t.numel() for _, t in param_leaves(state.params))
    check(REDUCED or got == n_params, f"{tag}: {got} parameters")
    print(f"{tag} {cfg.name}: {got} parameters ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}), state "
          f"on the card in {time.perf_counter() - t0:.1f} s; plan at "
          f"P={T_PLAN_WORKERS}, rank {T_R}: {plan.n_compressed}/"
          f"{len(plan.decisions)} leaves compressed (raw: "
          f"{[d.name for d in plan.decisions if not d.compress]})")
    step = make_dp_compressed_step(api, cfg, run, plan=plan)
    per_step, exchange_ms, norms, last = [], [], [], {}

    def on_step(i, metrics):
        now = dict(LAUNCHES)
        per_step.append({k: now[k] - last[k] for k in now})
        last.update(now)
        norms.append(metrics.get("grad_norm", float("nan")))
        if step.exchange is not None:
            start, end = step.exchange
            end.synchronize()
            exchange_ms.append(start.elapsed_time(end))
        if i == 0 and on_first_step is not None:
            on_first_step()

    reset_launches()
    last.update(LAUNCHES)
    data = data or DataConfig(cfg.vocab, T_SEQ, T_BATCH, seed=0)
    tokens = data.global_batch * (data.seq_len + data.num_frontend_tokens)
    res = train_loop(step, state, data, run, device=dev, on_step=on_step)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag} losses: {res.losses}; gradient norms: {norms}")
    print(f"{tag} launches a step: {per_step}")
    check(len(res.losses) == steps and all(
        math.isfinite(x) for x in res.losses + norms),
        f"{tag}: losses {res.losses}, gradient norms {norms}")
    for c in per_step:
        check(c["gemm"] == 3 * plan.n_compressed and
              c["sketch_fwd"] == plan.n_compressed,
              f"{tag}: a step launched gemm {c['gemm']} and sketch_fwd "
              f"{c['sketch_fwd']} times")
    check(len(exchange_ms) == steps, f"{tag}: no CUDA events around the "
                                     f"exchange")
    steady = res.step_seconds[1:]
    step_s = statistics.median(steady)
    ex_ms = statistics.median(exchange_ms[1:])
    out = {"n_params": got, "losses": res.losses, "grad_norms": norms,
           "step_seconds": res.step_seconds, "median_step_s": step_s,
           "tokens_per_s": tokens / step_s,
           "exchange_ms": exchange_ms, "median_exchange_ms": ex_ms,
           "peak_gib": peak / 2 ** 30, "held_gib": held / 2 ** 30,
           "launches": {k: counts[k] for k in ("sketch_fwd", "gemm")},
           "per_step": per_step, "n_compressed": plan.n_compressed}
    print(f"{tag} step times (s, host clock, each ending in a device "
          f"synchronize): {res.step_seconds}; median {step_s:.4f} s over "
          f"{len(steady)} steps after the warm-up: "
          f"{out['tokens_per_s']:.1f} tokens/s; the exchange "
          f"{ex_ms:.3f} ms (CUDA events, median), "
          f"{ex_ms * 1e-3 / step_s:.4f} of the step; peak memory "
          f"{out['peak_gib']:.2f} GiB (max_memory_allocated; "
          f"{out['held_gib']:.2f} GiB held before; {card})")
    del state, res, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_train(dev, LAUNCHES, reset_launches, card: str) -> dict:
    """Phase 24 (a): granite-moe-1b-a400m at its published size through
    ``train_loop``, MOE_STEPS steps of T_BATCH x T_SEQ."""
    return exchange_train(
        dev, phase_config(MOE_ARCH), LAUNCHES, reset_launches, card,
        tag="[moe] (a)", steps=MOE_STEPS,
        n_params=1_334_628_352, n_compressed=11)


def exchange_calls(dev, local, grad_compress, card: str, cfg, leaves,
                   tag: str) -> dict:
    """Apart from the training loop: for each leaf of ``leaves`` of
    ``cfg``, the whole exchange on a gradient of the leaf's folded shape
    and dtype with a nonzero error buffer, against ``_plain_exchange``;
    then sketch_fwd and the three K5 calls at that shape, each timed
    beside its plain version, the PyTorch call computing the same function
    (none for a product rounded to bf16) and its bound."""
    from repro_torch.kernels.sketch_matmul import gemm_plan
    from repro_torch.models import get_api, param_leaves
    shapes = dict(param_leaves(get_api(cfg).init(0, cfg, "meta")))
    g = torch.Generator(device=dev).manual_seed(24)
    seed = grad_compress.leaf_seed(0, 3)
    out = {}
    for name in leaves:
        meta = shapes[name]
        m, n, dt = math.prod(meta.shape[:-1]), meta.shape[-1], meta.dtype
        r = min(T_R, m, n)
        grad = torch.randn(m, n, generator=g, device=dev).to(dt)
        fb = 0.1 * torch.randn(m, n, generator=g, device=dev)
        want_g, want_e = _plain_exchange(local, grad, fb, seed, r)
        grads, fbs = {name: grad.clone()}, {name: fb.clone()}
        grad_compress.compress_and_allreduce(grads, fbs, step=3, rank=T_R,
                                             decisions={name: True})
        tol_g = gemm_tol(m) if dt == torch.float32 else BF16_TOL
        err_g = rel_fro(grads[name], want_g)
        err_e = rel_fro(fbs[name], want_e)
        print(f"{tag} exchange of {name} ({m}x{n} {dt}, r={r}): g_hat "
              f"rel_fro={err_g:.3e} (tol {tol_g:.1e}), e' rel_fro="
              f"{err_e:.3e} (tol {gemm_tol(m):.1e})")
        check(grads[name].dtype == dt, f"{tag}: {name}'s g_hat is "
                                       f"{grads[name].dtype}")
        check(err_g <= tol_g and err_e <= gemm_tol(m),
              f"{tag}: the exchange of {name} disagrees with its "
              f"plain version")
        err = max(max_abs(grads[name], want_g), max_abs(fbs[name], want_e))
        del grads, fbs, want_g, want_e
        M = fb + grad.float()
        om = local._omega_f32(*seed, 0, 0, n, r, "normal", 0, None, dev)
        P_hat = torch.linalg.qr(local.sketch_block(M, seed, r)).Q
        Qt = local.gemm_block(P_hat.T, M)
        G = torch.empty(m, n, dtype=dt, device=dev)
        isz = G.element_size()
        calls = {
            "sketch_fwd": (lambda: local.sketch_block(M, seed, r),
                           lambda: local._sketch_block_torch(M, seed, r),
                           lambda: torch.matmul(M, om),
                           (m, r, n), 4.0 * (m * n + m * r)),
            "a": (lambda: local.gemm_block(P_hat.T, M),
                  lambda: local._gemm_block_torch(P_hat.T, M),
                  lambda: torch.matmul(P_hat.T, M),
                  (r, n, m), 4.0 * (r * m + m * n + r * n)),
            "b": (lambda: local.gemm_block(P_hat, Qt, out_dtype=dt, out=G),
                  lambda: local._gemm_block_torch(P_hat, Qt, out_dtype=dt),
                  (lambda: torch.matmul(P_hat, Qt)) if dt == torch.float32
                  else None,
                  (m, n, r), 4.0 * (m * r + r * n) + isz * m * n),
            "c": (lambda: local.gemm_block(P_hat, Qt, acc=M, alpha=-1.0),
                  lambda: local._gemm_block_torch(P_hat, Qt, -1.0, M),
                  lambda: M.addmm_(P_hat, Qt, alpha=-1.0),
                  (m, n, r), 4.0 * (m * r + r * n) + 8.0 * m * n)}
        timed = {}
        for call, (fn, plain, lib, (mm, nn, kk), nbytes) in calls.items():
            bms, by = bound_ms(2.0 * mm * nn * kk, nbytes)
            timed[call] = {
                "ms": time_ms(fn), "plain_ms": time_ms(plain, reps=3),
                "library_ms": None if lib is None else time_ms(lib),
                "bound_ms": bms, "bound_by": by,
                "path": (None if call == "sketch_fwd"
                         else gemm_plan(mm, nn, kk)["path"])}
            t = timed[call]
            print(f"[timing] {'sketch_fwd' if call == 'sketch_fwd' else 'gemm (' + call + ')'}"
                  f" at {name} ({m}x{n} {dt}, r={r}"
                  + ("" if t["path"] is None else f", path {t['path']}")
                  + f"): {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, "
                  f"library " + ("none" if t["library_ms"] is None
                                 else f"{t['library_ms']:.4f}")
                  + f", bound {bms:.4f} ms by {by}; {card})")
        out[name] = {"shape": [m, n], "dtype": str(dt), "r": r,
                     "g_hat_err": err_g, "e_err": err_e,
                     "max_abs_err": err, "calls": timed}
        del M, om, P_hat, Qt, G, grad, fb, calls
        torch.cuda.empty_cache()
    return out


def moe_exchange_calls(dev, local, grad_compress, card: str) -> dict:
    """Phase 24 (a), apart from the loop, at MOE_LEAVES."""
    return exchange_calls(dev, local, grad_compress, card,
                          phase_config(MOE_ARCH), MOE_LEAVES, "[moe] (a)")


def moe_serve(dev, api, params, cfg, n_params: int, card: str) -> dict:
    """Phase 24 (b): phase 23 (a)'s prefill and decode at granite's
    published capacity factor, then the share of assignments dropped at
    that prefill and over MOE_DROP_STEPS decode steps after it (counted
    apart from the timed runs)."""
    out = lm_prefill_decode(dev, api, params, cfg, n_params, card,
                            tag="[moe] (b)")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(dev)
    with moe_route_log() as log:
        logits, caches = api.prefill(params, cfg, toks, max_len=LM_MAX_LEN)
        pre = moe_route_sums(log)
        log.clear()
        tok = logits.argmax(-1)
        for i in range(MOE_DROP_STEPS):
            logits, caches = api.decode_step(params, cfg, tok, caches,
                                             LM_PROMPT + i)
            tok = logits.argmax(-1)
        dec = moe_route_sums(log)
    out.update(prefill_routes=pre, decode_routes=dec)
    print(f"[moe] (b) dropped assignments at capacity factor "
          f"{cfg.capacity_factor}: prefill ({LM_BATCH}x{LM_PROMPT}, cap "
          f"{int(cfg.capacity_factor * cfg.top_k * LM_BATCH * LM_PROMPT / cfg.n_experts)}) "
          f"{pre['dropped']} of {pre['assignments']} ({pre['drop_share']:.4f});"
          f" {MOE_DROP_STEPS} decode steps (batch {LM_BATCH}, cap "
          f"{max(1, int(cfg.capacity_factor * cfg.top_k * LM_BATCH / cfg.n_experts))}) "
          f"{dec['dropped']} of {dec['assignments']} ({dec['drop_share']:.4f})")
    return out


def moe_decode_vs_forward(dev, api, params, cfg, tol, card: str) -> dict:
    """Phase 24 (c), in ``cfg.dtype`` at capacity factor 8.0, where
    nothing drops: prefill MOE_FWD_PROMPT tokens of LM_BATCH rows, then
    MOE_FWD_STEPS teacher-forced decode steps, each step's logits held
    against ``lm_hidden`` plus the head over the same tokens (within
    ``tol``; None: reported only); the smallest top-k margin seen, to
    tell a near-tie from a fault."""
    from repro_torch.models import lm_hidden
    from repro_torch.models.common import matmul
    cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    P, n = MOE_FWD_PROMPT, MOE_FWD_STEPS
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (LM_BATCH, P + n))).to(dev)
    with moe_route_log() as log:
        first, caches = api.prefill(params, cfg, toks[:, :P], max_len=P + n)
        real = []
        for t in range(P, P + n):
            logits, caches = api.decode_step(params, cfg, toks[:, t:t + 1],
                                             caches, t)
            real.append(logits[:, 0])
        served = moe_route_sums(log)
        log.clear()
        with torch.inference_mode():
            h, _ = lm_hidden(params, cfg, toks, remat=False)
            W = params["embed"] if cfg.tie_embeddings else params["lm_head"]
            ref = matmul(h[:, P - 1:], W.T)
        forward = moe_route_sums(log)
    real = torch.stack(real, dim=1)
    out = {"dtype": cfg.dtype, "prefill_err": rel_fro(first[:, 0], ref[:, 0]),
           "err": rel_fro(real, ref[:, 1:]),
           "step_err_max": max(rel_fro(real[:, i], ref[:, 1 + i])
                               for i in range(n)),
           "dropped": served["dropped"] + forward["dropped"],
           "min_margin": min(served["min_margin"], forward["min_margin"]),
           "tol": tol}
    print(f"[moe] (c) {cfg.dtype}: prefill {LM_BATCH}x{P} then {n} "
          f"teacher-forced decode steps at capacity factor 8.0, relative "
          f"Frobenius against lm_hidden + head: prefill's last logits "
          f"{out['prefill_err']:.3e}, the decode steps {out['err']:.3e} "
          f"(worst step {out['step_err_max']:.3e}); assignments dropped "
          f"{out['dropped']}; smallest top-{cfg.top_k} margin "
          f"{out['min_margin']:.3e}; limit "
          f"{'none (reported)' if tol is None else tol} ({card})")
    check(out["dropped"] == 0, "phase 24 (c): an assignment dropped at "
                               "capacity factor 8")
    check(tol is None or (out["prefill_err"] <= tol and
                          out["step_err_max"] <= tol),
          f"phase 24 (c): {cfg.dtype} decode misses the forward: "
          f"{out['prefill_err']:.3e}, {out['step_err_max']:.3e} > {tol}")
    return out


def moe_dispatch_forms(dev, params, cfg, card: str) -> dict:
    """Phase 24 (d): layer 0's MoE in bf16 on MOE_DISPATCH_N tokens in
    both dispatch forms: the (token, expert) pairs the einsum form's
    one-hot dispatch tensor carries must be exactly the scatter form's
    kept assignments, and the outputs agree within MOE_DISPATCH_TOL;
    each form timed (CUDA events)."""
    from repro_torch.models.ffn import (MoEParams, einsum_dispatch_matrix,
                                        moe, moe_routes)
    p = MoEParams(**{k: v[0].detach() for k, v in
                     params["blocks"]["moe"].items()})
    g = torch.Generator(device=dev).manual_seed(25)
    x = torch.randn(1, MOE_DISPATCH_N, cfg.d_model, generator=g,
                    device=dev).to(cfg.torch_dtype)
    N, E = MOE_DISPATCH_N, cfg.n_experts
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    with torch.inference_mode():
        r = moe_routes(p, x.reshape(N, -1), **kw)
        disp, _ = einsum_dispatch_matrix(r, x.dtype)
        kept = torch.zeros(N, E, device=dev)
        kept[torch.arange(N, device=dev)[:, None], r.gate_idx] = \
            r.keep.float()
        same = bool(torch.equal(disp.float().sum(-1), kept))
        del disp
        y = {d: moe(p, x, dispatch=d, **kw) for d in ("scatter", "einsum")}
        ms = {d: time_ms(lambda: moe(p, x, dispatch=d, **kw), reps=3)
              for d in ("scatter", "einsum")}
    out = {"tokens": N, "cap": r.cap, "dropped": int((~r.keep).sum()),
           "assignments": r.keep.numel(), "kept_sets_equal": same,
           "err": rel_fro(y["einsum"], y["scatter"]),
           "max_abs_err": max_abs(y["einsum"], y["scatter"]),
           "tol": MOE_DISPATCH_TOL, "ms": ms}
    print(f"[moe] (d) one {cfg.name} MoE layer, {cfg.dtype}, {N} tokens "
          f"(cap {r.cap}; {out['dropped']} of {out['assignments']} "
          f"assignments dropped): kept sets of the two forms equal: {same};"
          f" einsum against scatter rel_fro {out['err']:.3e} (max abs "
          f"{out['max_abs_err']:.3e}; limit {MOE_DISPATCH_TOL:.3e}); "
          f"scatter {ms['scatter']:.3f} ms, einsum {ms['einsum']:.3f} ms "
          f"(CUDA events; {card})")
    check(same, "phase 24 (d): the einsum form dispatches another set")
    check(out["err"] <= MOE_DISPATCH_TOL,
          f"phase 24 (d): the dispatch forms disagree: {out['err']:.3e}")
    return out


def moe_big_serve(dev, card: str) -> dict:
    """Phase 24 (e): dbrx-132b at every published width on MOE_BIG_LAYERS
    of its 40 layers, built on the card (its peak over what was held
    before within 1.1 x its weights), prefill LM_BATCH x LM_PROMPT and
    MOE_BIG_DECODE greedy decode steps; the decode step beside the bytes
    it must move (every weight, every cache, the logits)."""
    from repro_torch.models import get_api, param_leaves
    from repro_torch.roofline import h100_rates
    cfg = phase_config(MOE_BIG, n_layers=MOE_BIG_LAYERS)
    api = get_api(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(0, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - held
    leaves = param_leaves(params)
    n_params = sum(t.numel() for _, t in leaves)
    weights = sum(t.numel() * t.element_size() for _, t in leaves)
    print(f"[moe] (e) {cfg.name} on {cfg.n_layers} of 40 layers at its "
          f"published widths: {n_params} parameters, {weights / 1e9:.3f} "
          f"GB, built on the card in {init_s:.1f} s; peak while building "
          f"{init_peak / 1e9:.3f} GB over the {held / 1e9:.3f} GB held "
          f"before ({init_peak / weights:.4f} of the weights; {card})")
    check(REDUCED or n_params == 27_305_809_920,
          f"phase 24 (e): {n_params} parameters")
    check(init_peak <= 1.1 * weights,
          f"phase 24 (e): building the params peaked at {init_peak} bytes, "
          f"over 1.1 x the weights' {weights}")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(dev)
    prefill_ms = time_ms(lambda: api.prefill(params, cfg, toks,
                                             max_len=LM_MAX_LEN), reps=3)
    logits, caches = api.prefill(params, cfg, toks, max_len=LM_MAX_LEN)
    finite = bool(torch.isfinite(logits).all())
    dec, logits, tok, caches = timed_decode(
        api, params, cfg, logits.argmax(-1), caches, LM_PROMPT,
        MOE_BIG_DECODE)
    peak = torch.cuda.max_memory_allocated() - held
    check(finite and dec["finite"], "phase 24 (e): a logit is not finite")
    check(tuple(logits.shape) == (LM_BATCH, 1, cfg.vocab),
          f"phase 24 (e): logits {tuple(logits.shape)}")
    decode_ms = dec["decode_ms"]
    must = (weights + sum(c[kv].numel() * c[kv].element_size()
                          for c in caches for kv in c)
            + logits.numel() * logits.element_size())
    must_ms = must / h100_rates().hbm_bw * 1e3
    out = {"n_layers": cfg.n_layers, "n_params": n_params,
           "weights_bytes": weights, "init_s": init_s,
           "init_peak_bytes": init_peak, "peak_bytes": peak,
           "prefill_ms": prefill_ms, "decode_ms": decode_ms,
           "decode_ms_range": dec["decode_ms_range"],
           "tokens_per_s": dec["tokens_per_s"],
           "must_move_bytes": must, "must_move_ms": must_ms}
    print(f"[moe] (e) prefill {LM_BATCH}x{LM_PROMPT} (max_len "
          f"{LM_MAX_LEN}) {prefill_ms:.3f} ms (CUDA events, median of 3); "
          f"decode step {decode_ms:.3f} ms (median of steps 2-"
          f"{MOE_BIG_DECODE}; range {out['decode_ms_range'][0]:.3f}-"
          f"{out['decode_ms_range'][1]:.3f}), {out['tokens_per_s']:.1f} "
          f"tokens/s; must move {must:.4e} bytes: {must_ms:.3f} ms at "
          f"{h100_rates().hbm_bw / 1e12:.2f} TB/s, {must_ms / decode_ms:.4f} "
          f"of the step; peak {peak / 1e9:.3f} GB over what was held "
          f"({card})")
    del params, caches, logits, tok
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_moe(dev, card: str, local, grad_compress, LAUNCHES,
              reset_launches) -> dict:
    """Phase 24: (a) training granite-moe-1b-a400m at its published size
    and its exchange's kernels at the new leaves, (b) serving it at the
    published capacity factor, (c) decode against the forward, (d) the
    two dispatch forms, (e) dbrx-132b on 8 layers, (f) the launcher."""
    from repro_torch.models import get_api, param_leaves
    t0 = time.perf_counter()
    a = moe_train(dev, LAUNCHES, reset_launches, card)
    a["leaves"] = moe_exchange_calls(dev, local, grad_compress, card)
    cfg = phase_config(MOE_ARCH)
    api = get_api(cfg)
    params = api.init(0, cfg, dev)
    n_params = sum(t.numel() for _, t in param_leaves(params))
    b = moe_serve(dev, api, params, cfg, n_params, card)
    gc.collect()
    torch.cuda.empty_cache()
    c = [moe_decode_vs_forward(dev, api, params, cfg, None, card)]
    d = moe_dispatch_forms(dev, params, cfg, card)
    # in bf16 a rounding difference between the two paths can flip a
    # route; in float32 the paths differ only by the order of their sums
    params = _to_float32(params)
    c.append(moe_decode_vs_forward(dev, api, params,
                                   dataclasses.replace(cfg, dtype="float32"),
                                   MOE_FWD_TOL, card))
    del params
    e = moe_big_serve(dev, card)
    f = phase_lm_launcher(MOE_LAUNCHER, tag="[moe] (f)")
    seconds = time.perf_counter() - t0
    check(seconds < MOE_SECONDS, f"phase 24 took {seconds:.1f} s, not under "
                                 f"{MOE_SECONDS} s")
    return {"a": a, "b": b, "c": c, "d": d, "e": e, "f": f,
            "seconds": seconds, "card": card}


# -- phase 25: SSM and hybrid (falcon-mamba-7b, zamba2-1.2b) ---------------

@contextlib.contextmanager
def patched(module, name: str, wrap):
    """``module.name`` replaced by ``wrap(the original)`` while open."""
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def scan_ranged(real):
    """Each Mamba-1 chunk scan inside a ``ssm.scan`` profiler range, whose
    device span tells its kernels apart."""
    from torch.profiler import record_function

    def ranged(*args):
        with record_function("ssm.scan"):
            return real(*args)
    return ranged


def prefill_split(fn) -> dict:
    """``fn()`` once under torch.profiler: the device ms of the Mamba-1
    scan's levels (the kernels inside the ``ssm.scan`` ranges' device
    spans), of the products (GEMM kernels) and of the rest."""
    import bisect

    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import ssm
    torch.cuda.synchronize()
    with patched(ssm, "_scan_chunk_diag", scan_ranged), profile(
            activities=[ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev, ranges = trace_events(prof)
    spans = sorted((e.time_range.start, e.time_range.end) for e in ranges
                   if e.name == "ssm.scan" and e.cat == "gpu_user_annotation")
    starts = [a for a, _ in spans]
    parts = {"scan": 0.0, "products": 0.0, "rest": 0.0}
    for e in dev:
        ms = e.time_range.elapsed_us() * 1e-3
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start < spans[i][1]:
            parts["scan"] += ms
        elif any(w in e.name.lower() for w in ("nvjet", "gemm", "gemv",
                                                "cutlass", "xmma")):
            parts["products"] += ms
        else:
            parts["rest"] += ms
    total = sum(parts.values())
    return {**parts, "total": total, "events": len(dev),
            "scan_spans": len(spans),
            "scan_share": parts["scan"] / total if spans and total else
            None}


def ssm_serve(dev, api, params, cfg, n_params: int, card: str, tag: str,
              max_len: int) -> dict:
    """Phase 25 (a) / (d): ``serve_prefill`` of LM_BATCH x LM_PROMPT (the
    last logits, no cache), timed by CUDA events and its device time split
    by torch.profiler; a SSM_REPLAY-token prompt replayed by decode into a
    batch-LM_BATCH state, then LM_DECODE greedy steps, each timed; the
    idle share of LM_PROFILED profiled steps; one step's counted bytes
    (``analyze_call``) beside the bytes it must move: every weight once,
    the SSM states read and written, the KV caches read once, the logits
    written."""
    import types

    from repro_torch.models import model_flops, param_leaves
    from repro_torch.roofline import analyze_call, h100_rates
    from repro_torch.serve.engine import serve_prefill
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(dev)
    batch = {"tokens": toks}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # the profiled call is the warm-up: the split reads kernels' device
    # time, which a first call's host-side allocations do not move
    first = []
    split = prefill_split(lambda: first.append(serve_prefill(params, cfg,
                                                             batch)))
    logits, none = first.pop()
    check(none is None and tuple(logits.shape) == (LM_BATCH, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"{tag}: serve_prefill gave {tuple(logits.shape)}, {none}")
    prefill_ms = time_ms(lambda: serve_prefill(params, cfg, batch), reps=2,
                         warm=False)
    prefill_peak = torch.cuda.max_memory_allocated() - held
    caches = api.init_cache(cfg, LM_BATCH, max_len, device=dev)
    for t in range(SSM_REPLAY):
        logits, caches = api.decode_step(params, cfg, toks[:, t:t + 1],
                                         caches, t)
    finite = bool(torch.isfinite(logits).all())
    dec, logits, tok, caches = timed_decode(
        api, params, cfg, logits.argmax(-1), caches, SSM_REPLAY, LM_DECODE)
    check(finite and dec["finite"], f"{tag}: a decode logit is not finite")
    decode_ms = dec["decode_ms"]
    pos = SSM_REPLAY + LM_DECODE
    prof = lm_decode_profile(api, params, cfg, tok, caches, pos)
    pos += LM_PROFILED
    shape = types.SimpleNamespace(global_batch=LM_BATCH, seq_len=max_len,
                                  kind="decode")
    terms = analyze_call("decode step", lambda: api.decode_step(
        params, cfg, tok, caches, pos), model_flops=model_flops(
        cfg, shape, n_params), device=dev)
    nbytes = (lambda t: t.numel() * t.element_size())
    weights = sum(nbytes(t) for _, t in param_leaves(params))
    state = nbytes(caches["conv"]) + nbytes(caches["ssm"])
    kv = sum(nbytes(e[kv]) for e in caches.get("shared", []) for kv in e)
    must = weights + 2 * state + kv + nbytes(logits)
    must_ms = must / h100_rates().hbm_bw * 1e3
    out = {"prefill_ms": prefill_ms, "prefill_peak_bytes": prefill_peak,
           "prefill_split_ms": split, "decode_ms": decode_ms,
           "decode_ms_range": dec["decode_ms_range"],
           "tokens_per_s": dec["tokens_per_s"],
           "loop_tokens_per_s": dec["loop_tokens_per_s"], **prof,
           "counted_bytes": terms.hlo_bytes, "counted_flops": terms.hlo_flops,
           "t_bound_ms": terms.t_bound * 1e3, "bottleneck": terms.bottleneck,
           "weights_bytes": weights, "state_bytes": state, "kv_bytes": kv,
           "must_move_bytes": must, "must_move_ms": must_ms}
    if split["scan_share"] is not None:
        scan = f"scan {split['scan']:.3f} ms ({split['scan_share']:.3f})"
    else:
        scan = ("no ssm.scan span in the trace" if cfg.family == "ssm"
                else "no Mamba-1 scan")
    print(f"{tag} {cfg.name}, {n_params} params: serve_prefill "
          f"{LM_BATCH}x{LM_PROMPT} {prefill_ms:.3f} ms (CUDA events, median "
          f"of 2 after the profiled one, "
          f"{LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.1f}"
          f" prompt tokens/s; peak {prefill_peak / 1e9:.3f} GB over the "
          f"weights); its device time under torch.profiler "
          f"{split['total']:.3f} ms in {split['events']} events: {scan}, "
          f"products {split['products']:.3f} ms, the rest "
          f"{split['rest']:.3f} ms ({card})")
    print(f"{tag} decode after a {SSM_REPLAY}-token replay at batch "
          f"{LM_BATCH}: step {decode_ms:.3f} ms (median of steps 2-"
          f"{LM_DECODE}; range {out['decode_ms_range'][0]:.3f}-"
          f"{out['decode_ms_range'][1]:.3f}), {out['tokens_per_s']:.1f} "
          f"tokens/s ({out['loop_tokens_per_s']:.1f} over the loop on the "
          f"host clock); profiled ({LM_PROFILED} steps): idle share "
          f"{prof['idle_share']:.3f}, {prof['device_events_a_step']:.0f} "
          f"device events a step ({card})")
    print(f"{tag} one decode step counted: {terms.hlo_bytes:.4e} device "
          f"bytes, {terms.hlo_flops:.4e} FLOPs; must move {must:.4e} bytes "
          f"(weights {weights:.4e}, states {state:.4e} read and written, KV "
          f"caches {kv:.4e} read, logits): {must_ms:.3f} ms at "
          f"{h100_rates().hbm_bw / 1e12:.2f} TB/s, "
          f"{must_ms / decode_ms:.4f} of the measured {decode_ms:.3f} ms")
    del caches, logits, tok
    gc.collect()
    torch.cuda.empty_cache()
    return out


def decode_vs_forward(api, params, cfg, toks, cache, ref, tol, card: str,
                      tag: str, what: str) -> dict:
    """Teacher-forced decode of ``toks`` (B, n) from ``cache`` at positions
    0 .. n - 1, each step's logits held against ``ref`` (B, n, vocab), the
    forward plus the head over the same tokens: every logit finite, every
    step within ``tol`` relative Frobenius (None: reported only)."""
    n = toks.shape[1]
    real = []
    for t in range(n):
        logits, cache = api.decode_step(params, cfg, toks[:, t:t + 1],
                                        cache, t)
        real.append(logits[:, 0])
    real = torch.stack(real, dim=1)
    out = {"dtype": cfg.dtype, "err": rel_fro(real, ref),
           "step_err_max": max(rel_fro(real[:, i], ref[:, i])
                               for i in range(n)),
           "max_abs": max_abs(real, ref),
           "finite": bool(torch.isfinite(real).all()), "tol": tol}
    print(f"{tag} {cfg.name} {what}, {cfg.dtype}: {n} teacher-forced "
          f"decode steps of {toks.shape[0]} rows against the forward plus "
          f"head, relative Frobenius {out['err']:.3e} (worst step "
          f"{out['step_err_max']:.3e}, max abs {out['max_abs']:.3e}); limit "
          f"{'none (reported)' if tol is None else tol} ({card})")
    check(out["finite"], f"{tag}: a decode logit {what} is not finite")
    check(tol is None or out["step_err_max"] <= tol,
          f"{tag}: {cfg.dtype} decode {what} misses the forward: "
          f"{out['step_err_max']:.3e} > {tol}")
    return out


def ssm_decode_vs_forward(dev, api, params, cfg, tol, card: str,
                          tag: str) -> dict:
    """Phase 25 (b) / (d), in ``cfg.dtype``: SSM_FWD_STEPS teacher-forced
    decode steps of LM_BATCH rows from an empty state against the
    family's hidden forward plus the head (``decode_vs_forward``)."""
    from repro_torch.models import mamba_lm, zamba
    from repro_torch.models.common import matmul
    hidden = (mamba_lm.mamba_lm_hidden if cfg.family == "ssm"
              else zamba.hybrid_hidden)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (LM_BATCH, SSM_FWD_STEPS))).to(dev)
    with torch.inference_mode():
        ref = matmul(hidden(params, cfg, toks, remat=False),
                     params["lm_head"].T)
    cache = api.init_cache(cfg, LM_BATCH, SSM_FWD_STEPS, device=dev)
    out = decode_vs_forward(api, params, cfg, toks, cache, ref, tol, card,
                            tag, f"on {cfg.n_layers} layers")
    out["layers"] = cfg.n_layers
    return out


def ssm_build(dev, cfg, card: str, tag: str):
    """``cfg``'s params built on the card from seed 0, the build's peak
    over what was held before within 1.1 x the weights."""
    from repro_torch.models import get_api, param_leaves
    api = get_api(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(0, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    leaves = param_leaves(params)
    n_params = sum(t.numel() for _, t in leaves)
    weights = sum(t.numel() * t.element_size() for _, t in leaves)
    print(f"{tag} {cfg.name}: {n_params} parameters ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, d_inner {cfg.d_inner}, "
          f"ssm_state {cfg.ssm_state}, vocab {cfg.vocab}, {cfg.dtype}), "
          f"{weights / 1e9:.3f} GB, random weights from seed 0, built on "
          f"the card in {init_s:.1f} s; peak while building "
          f"{peak / 1e9:.3f} GB ({peak / weights:.4f} of the weights; "
          f"{card})")
    check(n_params == SSM_PARAMS[cfg.name], f"{tag}: {n_params} parameters")
    check(peak <= 1.1 * weights, f"{tag}: building the params peaked at "
                                 f"{peak} bytes, over 1.1 x {weights}")
    return api, params, {"n_params": n_params, "weights_bytes": weights,
                         "init_s": init_s, "init_peak_bytes": peak}


def hybrid_long_prompt(dev, params, cfg, card: str) -> dict:
    """Phase 25 (e): one 1 x HY_LONG prompt through ``serve_prefill``,
    past ``nystrom_attn_above``: each application of the shared block
    attends through ``nystrom_attention`` (counted), the logits finite."""
    from repro_torch.models import zamba
    from repro_torch.serve.engine import serve_prefill
    length = HY_LONG
    check(length >= cfg.nystrom_attn_above > 0,
          f"phase 25 (e): {length} tokens do not take the Nystrom branch")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, length))).to(dev)
    calls = []

    def counted(real):
        def call(*args, **kw):
            calls.append(1)
            return real(*args, **kw)
        return call
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    with patched(zamba, "nystrom_attention", counted):
        start.record()
        logits, none = serve_prefill(params, cfg, {"tokens": toks})
        end.record()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    want = zamba._n_shared_applications(cfg)
    out = {"tokens": length, "ms": start.elapsed_time(end), "wall_s": wall,
           "nystrom_calls": len(calls), "applications": want,
           "peak_bytes": peak,
           "finite": bool(torch.isfinite(logits).all())}
    print(f"[ssm] (e) {cfg.name}: serve_prefill of 1 x {length} tokens "
          f"(nystrom_attn_above {cfg.nystrom_attn_above}, "
          f"{cfg.nystrom_landmarks} landmarks) {out['ms']:.1f} ms (CUDA "
          f"events, one call; {wall:.2f} s on the host clock); "
          f"nystrom_attention called {len(calls)} times for {want} "
          f"applications of the shared block; logits finite: "
          f"{out['finite']}; peak {peak / 1e9:.3f} GB over the weights "
          f"({card})")
    check(len(calls) == want == 6,
          f"phase 25 (e): nystrom_attention called {len(calls)} times, not "
          f"{want}")
    check(out["finite"] and none is None and tuple(logits.shape) == (
        1, 1, cfg.vocab), "phase 25 (e): the long prompt's logits")
    return out


def decay_logged(log: list, real):
    """``ssm.masked_decay`` (``real``) that also appends the chunk's
    largest masked exponent (cum_t - cum_s for t < s) to ``log``, as a
    device tensor."""
    def logged(cum, mask):
        with torch.no_grad():
            diff = cum[:, :, None, :] - cum[:, None, :, :]
            log.append(diff.masked_fill(mask[None, :, :, None],
                                        -math.inf).amax())
        return real(cum, mask)
    return logged


def phase_ssm(dev, card: str, local, grad_compress, LAUNCHES,
              reset_launches) -> dict:
    """Phase 25: (a) falcon-mamba-7b served at its published size, (b) its
    decode against the forward on 4 layers, (c) zamba2-1.2b trained at its
    published size with the exchange, (d) zamba2-1.2b served, its float32
    decode against the forward over the whole depth, (e) its 65536-token
    prompt through the Nystrom branch, (f) the launcher."""
    from repro_torch.models import ssm
    t0 = time.perf_counter()
    parts, last = {}, [t0]

    def part(name: str) -> None:
        now = time.perf_counter()
        parts[name] = parts.get(name, 0.0) + now - last[0]
        last[0] = now
    cfg = phase_config(SSM_ARCH)
    api, params, built = ssm_build(dev, cfg, card, "[ssm] (a)")
    a = dict(built, **ssm_serve(dev, api, params, cfg, built["n_params"],
                                card, "[ssm] (a)", LM_MAX_LEN))
    part("a")
    del params
    cfg4 = phase_config(SSM_ARCH, n_layers=SSM_FWD_LAYERS)
    params = api.init(0, cfg4, dev)
    b = [ssm_decode_vs_forward(dev, api, params, cfg4, None, card,
                               "[ssm] (b)")]
    b.append(ssm_decode_vs_forward(
        dev, api, _to_float32(params),
        dataclasses.replace(cfg4, dtype="float32"), SSM_FWD_TOL, card,
        "[ssm] (b)"))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    part("b")

    hcfg = phase_config(HY_ARCH)
    decay, real_decay = [], ssm.masked_decay
    ssm.masked_decay = decay_logged(decay, real_decay)

    def first_step_done():
        ssm.masked_decay = real_decay
    try:
        c = exchange_train(dev, hcfg, LAUNCHES, reset_launches, card,
                           tag="[ssm] (c)", steps=SSM_STEPS,
                           n_params=SSM_PARAMS[HY_ARCH],
                           n_compressed=HY_COMPRESSED,
                           on_first_step=first_step_done)
    finally:
        ssm.masked_decay = real_decay
    c["max_masked_exponent"] = max(float(x) for x in decay)
    c["decay_calls"] = len(decay)
    print(f"[ssm] (c) step 1's largest masked decay exponent (cum_t - "
          f"cum_s, t < s) over {len(decay)} chunk calls: "
          f"{c['max_masked_exponent']:.3f} (exp overflows f32 past 88.7; "
          f"the port masks before the exp)")
    c["leaves"] = exchange_calls(dev, local, grad_compress, card, hcfg,
                                 HY_LEAVES, "[ssm] (c)")
    part("c")
    api, params, built = ssm_build(dev, hcfg, card, "[ssm] (d)")
    d = dict(built, **ssm_serve(dev, api, params, hcfg, built["n_params"],
                                card, "[ssm] (d)", LM_MAX_LEN))
    part("d")
    e = hybrid_long_prompt(dev, params, hcfg, card)
    part("e")
    params = _to_float32(params)
    d["vs_forward"] = ssm_decode_vs_forward(
        dev, api, params, dataclasses.replace(hcfg, dtype="float32"),
        SSM_FWD_TOL, card, "[ssm] (d)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    part("d")
    f = phase_lm_launcher(HY_LAUNCHER, tag="[ssm] (f)")
    part("f")
    seconds = time.perf_counter() - t0
    print("[ssm] seconds by part (host clock): " + ", ".join(
        f"({k}) {v:.1f}" for k, v in parts.items()) + f"; {seconds:.1f} in "
        f"all ({card})")
    check(seconds < SSM_SECONDS, f"phase 25 took {seconds:.1f} s, not "
                                 f"under {SSM_SECONDS} s")
    return {"a": a, "b": b, "c": c, "d": d, "e": e, "f": f,
            "seconds": seconds, "part_seconds": parts, "card": card}


# -- phase 26: encoder-decoder and VLM (whisper-tiny, internvl2-26b) --------

def ed_data(cfg, seq_len: int, batch: int):
    """``data_config_for`` at ``seq_len`` x ``batch`` (a VLM's seq_len
    counts its frontend tokens)."""
    import types

    from repro_torch.data.pipeline import data_config_for
    return data_config_for(cfg, types.SimpleNamespace(
        seq_len=seq_len, global_batch=batch), seed=0)


def ed_train(dev, local, grad_compress, LAUNCHES, reset_launches,
             card: str) -> dict:
    """Phase 26 (a): whisper-tiny at its published size through
    ``train_loop`` with the exchange, ED_STEPS steps of ED_BATCH x ED_SEQ
    decoder tokens and as many rows of enc_seq frames; its parameter
    count by ``count_params`` and ``count_params_split`` first; then the
    exchange and its kernels at ED_LEAVES."""
    from repro_torch.models import count_params, count_params_split, get_api
    cfg = phase_config(ED_ARCH)
    shapes = get_api(cfg).init(0, cfg, "meta")
    counts = (count_params(shapes), count_params_split(cfg)[0])
    check(REDUCED or counts == (ED_PARAMS[ED_ARCH],) * 2,
          f"phase 26 (a): count_params, count_params_split {counts}")
    out = exchange_train(dev, cfg, LAUNCHES, reset_launches, card,
                         tag="[encdec-vlm] (a)", steps=ED_STEPS,
                         n_params=ED_PARAMS[ED_ARCH],
                         n_compressed=ED_COMPRESSED[ED_ARCH],
                         data=ed_data(cfg, ED_SEQ, ED_BATCH))
    out["counts"] = counts
    out["leaves"] = exchange_calls(dev, local, grad_compress, card, cfg,
                                   ED_LEAVES, "[encdec-vlm] (a)")
    return out


def ed_serve(dev, api, params, cfg, card: str) -> dict:
    """Phase 26 (b): ``serve_prefill`` of ED_BATCH x enc_seq frames (the
    encoder, the cross K/V, BOS at position 0 into a self cache of
    ED_MAX_LEN), timed by CUDA events over 2 calls after a profiled one;
    ED_DECODE greedy decode steps, each timed; the idle share of
    LM_PROFILED profiled steps; one step's counted bytes beside the bytes
    it must move: the decoder's weights and the head once (one dec_pos
    row), every cache read, the logits written."""
    import types

    from repro_torch.models import model_flops, param_leaves
    from repro_torch.roofline import analyze_call, h100_rates
    from repro_torch.serve.engine import serve_prefill
    g = torch.Generator(device=dev).manual_seed(26)
    batch = {"frames": torch.randn(ED_BATCH, cfg.enc_seq, cfg.d_model,
                                   generator=g, device=dev)}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    first = []
    pre_dev, w0, w1 = profiled(lambda: first.append(serve_prefill(
        params, cfg, batch, max_len=ED_MAX_LEN)), "ed.prefill")
    logits, cache = first.pop()
    check(tuple(logits.shape) == (ED_BATCH, 1, cfg.vocab) and
          bool(torch.isfinite(logits).all()) and
          tuple(cache["self_k"].shape[:3]) == (cfg.n_layers, ED_BATCH,
                                               ED_MAX_LEN) and
          tuple(cache["cross_k"].shape[:3]) == (cfg.n_layers, ED_BATCH,
                                                cfg.enc_seq),
          f"phase 26 (b): serve_prefill gave {tuple(logits.shape)}")
    prefill_ms = time_ms(lambda: serve_prefill(params, cfg, batch,
                                               max_len=ED_MAX_LEN),
                         reps=2, warm=False)
    prefill_peak = torch.cuda.max_memory_allocated() - held
    dec, logits, tok, cache = timed_decode(
        api, params, cfg, logits.argmax(-1), cache, 1, ED_DECODE)
    check(dec["finite"], "phase 26 (b): a decode logit is not finite")
    decode_ms = dec["decode_ms"]
    pos = 1 + ED_DECODE
    prof = lm_decode_profile(api, params, cfg, tok, cache, pos)
    pos += LM_PROFILED
    nbytes = (lambda t: t.numel() * t.element_size())
    decoder = {n: t for n, t in param_leaves(params)
               if n.startswith(("dec_blocks", "dec_ln", "embed"))}
    weights = (sum(nbytes(t) for t in decoder.values())
               + cfg.d_model * params["dec_pos"].element_size())
    caches = sum(nbytes(t) for t in cache.values())
    must = weights + caches + nbytes(logits)
    must_ms = must / h100_rates().hbm_bw * 1e3
    shape = types.SimpleNamespace(global_batch=ED_BATCH, seq_len=ED_MAX_LEN,
                                  kind="decode")
    terms = analyze_call("decode step", lambda: api.decode_step(
        params, cfg, tok, cache, pos), model_flops=model_flops(
        cfg, shape, sum(t.numel() for t in decoder.values())), device=dev)
    out = {"prefill_ms": prefill_ms, "prefill_peak_bytes": prefill_peak,
           "prefill_device_ms": device_busy_us(pre_dev, w0, w1) * 1e-3,
           "prefill_events": len(pre_dev), "decode_ms": decode_ms,
           "decode_ms_range": dec["decode_ms_range"],
           "tokens_per_s": dec["tokens_per_s"],
           "loop_tokens_per_s": dec["loop_tokens_per_s"], **prof,
           "counted_bytes": terms.hlo_bytes, "counted_flops": terms.hlo_flops,
           "t_bound_ms": terms.t_bound * 1e3, "bottleneck": terms.bottleneck,
           "weights_bytes": weights, "cache_bytes": caches,
           "must_move_bytes": must, "must_move_ms": must_ms}
    print(f"[encdec-vlm] (b) {cfg.name}: serve_prefill of {ED_BATCH} x "
          f"{cfg.enc_seq} frames (the encoder, the cross K/V, BOS into a "
          f"self cache of {ED_MAX_LEN}) {prefill_ms:.3f} ms (CUDA events, "
          f"median of 2 after the profiled one; its device busy "
          f"{out['prefill_device_ms']:.3f} ms in {len(pre_dev)} events; "
          f"peak {prefill_peak / 1e9:.3f} GB over the weights); decode step "
          f"{decode_ms:.3f} ms (median of steps 2-{ED_DECODE}; range "
          f"{out['decode_ms_range'][0]:.3f}-{out['decode_ms_range'][1]:.3f}"
          f"), {out['tokens_per_s']:.1f} tokens/s at batch {ED_BATCH} "
          f"({out['loop_tokens_per_s']:.1f} over the loop on the host "
          f"clock); profiled ({LM_PROFILED} steps): idle share "
          f"{prof['idle_share']:.3f}, {prof['device_events_a_step']:.0f} "
          f"device events a step ({card})")
    print(f"[encdec-vlm] (b) one decode step counted: {terms.hlo_bytes:.4e} "
          f"device bytes, {terms.hlo_flops:.4e} FLOPs; must move "
          f"{must:.4e} bytes (decoder weights and head {weights:.4e}, "
          f"caches {caches:.4e} read, logits): {must_ms:.4f} ms at "
          f"{h100_rates().hbm_bw / 1e12:.2f} TB/s, "
          f"{must_ms / decode_ms:.4f} of the measured {decode_ms:.3f} ms")
    del cache, logits, tok
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ed_decode_vs_forward(dev, api, params, cfg, enc_seq: int, tol,
                         card: str) -> dict:
    """Phase 26 (b), in ``cfg.dtype`` at ``enc_seq`` frames: ED_FWD_STEPS
    teacher-forced decode steps of ED_BATCH rows against the cross K/V of
    the encoder's output, held against ``decode_hidden`` plus the head
    (``decode_vs_forward``).  The forward's chunked attention pads the
    encoder's keys to a multiple of 1024 and leaves the pad unmasked, as
    the reference's does; decode attends over the real keys alone, so the
    two agree only where enc_seq is such a multiple."""
    from repro_torch.models import whisper
    from repro_torch.models.common import matmul
    cfg = dataclasses.replace(cfg, enc_seq=enc_seq)
    n = ED_FWD_STEPS
    g = torch.Generator(device=dev).manual_seed(27)
    frames = torch.randn(ED_BATCH, enc_seq, cfg.d_model, generator=g,
                         device=dev)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (ED_BATCH, n))).to(dev)
    with torch.inference_mode():
        enc = whisper.encode(params, cfg, frames, remat=False)
        h = whisper.decode_hidden(params, cfg, toks, enc, remat=False)
        ref = matmul(h, params["embed"].T)
        cache = api.init_cache(cfg, ED_BATCH, n, device=dev)
        cache["cross_k"], cache["cross_v"] = whisper.encdec_prepare_cross(
            params, cfg, enc)
    out = decode_vs_forward(
        api, params, cfg, toks, cache, ref, tol, card, "[encdec-vlm] (b)",
        f"at enc_seq {enc_seq}" + ("" if tol else " (padded keys)"))
    out["enc_seq"] = enc_seq
    return out


def vlm_serve(dev, card: str) -> dict:
    """Phase 26 (c): internvl2-26b at its published size built on the card
    (the free memory checked first; the build's peak beside the weights),
    ``serve_prefill`` of LM_BATCH x (num_frontend_tokens patch embeddings
    + LM_PROMPT text tokens), timed over 2 calls after a profiled one;
    then the text path as phase 23 (a): prefill of LM_PROMPT tokens into
    caches of LM_MAX_LEN and VLM_DECODE decode steps."""
    from repro_torch.models import get_api, param_leaves
    from repro_torch.serve.engine import serve_prefill
    cfg = phase_config(VLM_ARCH)
    api = get_api(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    free = torch.cuda.mem_get_info()[0]
    check(REDUCED or free >= VLM_MIN_FREE,
          f"phase 26 (c): {free / 1e9:.2f} GB free before the build, under "
          f"{VLM_MIN_FREE / 1e9:.0f} GB")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(0, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    leaves = param_leaves(params)
    n_params = sum(t.numel() for _, t in leaves)
    weights = sum(t.numel() * t.element_size() for _, t in leaves)
    print(f"[encdec-vlm] (c) {cfg.name}: {n_params} parameters "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads, kv {cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"projector {cfg.frontend_dim} -> {cfg.d_model}, {cfg.dtype}), "
          f"{weights / 1e9:.3f} GB, random weights from seed 0, built on "
          f"the card in {init_s:.1f} s with {free / 1e9:.2f} GB free; peak "
          f"while building {peak / 1e9:.3f} GB ({peak / weights:.4f} of the "
          f"weights; {card})")
    check(REDUCED or n_params == ED_PARAMS[VLM_ARCH],
          f"phase 26 (c): {n_params} parameters")
    g = torch.Generator(device=dev).manual_seed(28)
    nf = cfg.num_frontend_tokens
    batch = {"tokens": torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(dev),
        "frontend_feats": torch.randn(LM_BATCH, nf, cfg.frontend_dim,
                                      generator=g, device=dev)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = []
    pre_dev, w0, w1 = profiled(lambda: first.append(serve_prefill(
        params, cfg, batch)), "vlm.prefill")
    logits, none = first.pop()
    check(none is None and tuple(logits.shape) == (LM_BATCH, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"phase 26 (c): serve_prefill gave {tuple(logits.shape)}, {none}")
    prefill_ms = time_ms(lambda: serve_prefill(params, cfg, batch), reps=2,
                         warm=False)
    prefill_peak = torch.cuda.max_memory_allocated() - held - weights
    out = {"n_params": n_params, "weights_bytes": weights, "init_s": init_s,
           "free_before": free, "init_peak_bytes": peak,
           "prefill_ms": prefill_ms, "prefill_tokens": LM_PROMPT + nf,
           "prefill_device_ms": device_busy_us(pre_dev, w0, w1) * 1e-3,
           "prefill_events": len(pre_dev),
           "prefill_peak_bytes": prefill_peak}
    print(f"[encdec-vlm] (c) serve_prefill {LM_BATCH} x ({nf} patches + "
          f"{LM_PROMPT} text tokens) {prefill_ms:.3f} ms (CUDA events, median "
          f"of 2 after the profiled one, "
          f"{LM_BATCH * (LM_PROMPT + nf) / prefill_ms * 1e3:.1f} tokens/s; its "
          f"device busy {out['prefill_device_ms']:.3f} ms in {len(pre_dev)} "
          f"events; peak {prefill_peak / 1e9:.3f} GB over the weights); "
          f"logits finite, {tuple(logits.shape)} ({card})")
    del logits
    out["text"] = lm_prefill_decode(dev, api, params, cfg, n_params, card,
                                    tag="[encdec-vlm] (c)",
                                    decode=VLM_DECODE)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def vlm_train(dev, local, grad_compress, LAUNCHES, reset_launches,
              card: str) -> dict:
    """Phase 26 (d): internvl2-26b at its published widths on
    VLM_TRAIN_LAYERS of its 48 layers through ``train_loop`` with the
    exchange, ED_STEPS steps of T_BATCH rows of (patch embeddings + text)
    = VLM_TRAIN_SEQ tokens (``data_config_for``); then the exchange and
    its kernels at VLM_LEAVES."""
    cfg = phase_config(VLM_ARCH, n_layers=VLM_TRAIN_LAYERS)
    data = ed_data(cfg, VLM_TRAIN_SEQ, T_BATCH)
    check(data.frontend == "vision" and data.seq_len ==
          VLM_TRAIN_SEQ - cfg.num_frontend_tokens,
          f"phase 26 (d): data_config_for gave {data}")
    out = exchange_train(dev, cfg, LAUNCHES, reset_launches, card,
                         tag="[encdec-vlm] (d)", steps=ED_STEPS,
                         n_params=VLM_TRAIN_PARAMS,
                         n_compressed=ED_COMPRESSED[VLM_ARCH], data=data)
    out["leaves"] = exchange_calls(dev, local, grad_compress, card, cfg,
                                   VLM_LEAVES, "[encdec-vlm] (d)")
    return out


def phase_train_launcher(argv, tag: str) -> dict:
    """``python -m repro_torch.launch.train`` with ``argv`` as a
    subprocess: exit 0, its ``[train] done`` line."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *argv], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"{tag}: the launcher exited "
                               f"{out.returncode}:\n{out.stdout[-3000:]}\n"
                               f"{out.stderr[-3000:]}")
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("[train] done")]
    check(bool(lines), f"{tag}: no [train] done line:\n"
                       f"{out.stdout[-3000:]}")
    print(f"{tag} train {' '.join(argv)}: exit 0 in {wall:.1f} s (process "
          f"included); {lines[-1]}")
    return {"line": lines[-1], "wall_s": wall}


def phase_encdec_vlm(dev, card: str, local, grad_compress, LAUNCHES,
                     reset_launches) -> dict:
    """Phase 26: (a) whisper-tiny trained at its published size with the
    exchange, its kernels timed at ED_LEAVES, (b) served, its float32 decode against the forward at
    enc_seq ED_CONTROL_ENC (held) and at the published enc_seq (reported),
    (c) internvl2-26b served at its published size, (d) trained on 2 of
    its 48 layers with the exchange, its kernels timed at VLM_LEAVES, (e)
    the launchers: train on reduced whisper-tiny (ED_TRAIN_LAUNCHER says
    why), serve at its published size."""
    from repro_torch.models import get_api
    t0 = time.perf_counter()
    parts, last = {}, [t0]

    def part(name: str) -> None:
        now = time.perf_counter()
        parts[name] = parts.get(name, 0.0) + now - last[0]
        last[0] = now
    a = ed_train(dev, local, grad_compress, LAUNCHES, reset_launches, card)
    part("a")
    cfg = phase_config(ED_ARCH)
    api = get_api(cfg)
    params = api.init(0, cfg, dev)
    b = ed_serve(dev, api, params, cfg, card)
    params = _to_float32(params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    control = cfg.enc_seq if REDUCED else ED_CONTROL_ENC
    b["vs_forward"] = [
        ed_decode_vs_forward(dev, api, params, cfg32, control, ED_FWD_TOL,
                             card),
        ed_decode_vs_forward(dev, api, params, cfg32, cfg.enc_seq, None,
                             card)]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    part("b")
    c = vlm_serve(dev, card)
    part("c")
    d = vlm_train(dev, local, grad_compress, LAUNCHES, reset_launches, card)
    part("d")
    e = {"train": phase_train_launcher(ED_TRAIN_LAUNCHER,
                                       "[encdec-vlm] (e)"),
         "serve": phase_lm_launcher(ED_SERVE_LAUNCHER,
                                    tag="[encdec-vlm] (e)")}
    part("e")
    seconds = time.perf_counter() - t0
    print("[encdec-vlm] seconds by part (host clock): " + ", ".join(
        f"({k}) {v:.1f}" for k, v in parts.items()) + f"; {seconds:.1f} in "
        f"all ({card})")
    check(seconds < ENCDEC_VLM_SECONDS,
          f"phase 26 took {seconds:.1f} s, not under {ENCDEC_VLM_SECONDS} s")
    return {"a": a, "b": b, "c": c, "d": d, "e": e, "seconds": seconds,
            "part_seconds": parts, "card": card}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core.nystrom import relative_error
        from repro_torch.core.sketch import _omega_tile_torch
        from repro_torch.kernels import _build, local, ops
        from repro_torch.kernels.sketch_matmul import (
            KIND_CODES, LAUNCHES, gen_omega_cuda, reset_launches)
        from repro_torch.stream import (SketchService, StreamConfig,
                                        StreamingSketch, reconstruction_error)
        from repro_torch.launch import serve
        from repro_torch.parallel import grad_compress
        from repro_torch.plan import (H100_GLOO, PRESETS, local_cost,
                                      nystrom_local_cost,
                                      sparse_stream_update_cost,
                                      stream_update_cost)
        from repro_torch.serve import make_ingest_queue
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    # the launcher module (the package's `sketch_matmul` is the ops function)
    sm = sys.modules["repro_torch.kernels.sketch_matmul"]

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = t0 = time.perf_counter()
    _build.library()
    print(f"[build] nvcc + load: {time.perf_counter() - t0:.2f} s "
          f"({_build.build().name})")

    A = make_matrix(dev)
    cfg = StreamConfig(N, N, r=R, seed=SEED)
    L = cfg.sketch_l
    machine = PRESETS[H100_GLOO]
    records = []        # measured calls beside their plan.model costs
    torch.cuda.synchronize()

    # -- 1. draws, 2. kernels vs plain ---------------------------------------
    gen_err = phase_draws(dev, gen_omega_cuda, KIND_CODES,
                          _omega_tile_torch, L)
    phase_kernels(dev, local)

    # -- 3. one-shot main path -----------------------------------------------
    reset_launches()
    t0 = time.perf_counter()
    B, C = ops.nystrom_fused(A, seed=SEED, r=R)
    torch.cuda.synchronize()
    t_oneshot = time.perf_counter() - t0
    om = _omega_tile_torch(SEED, 0, 0, 0, N, R, "normal", 0, None, None, dev)
    B_ref = A @ om
    C_ref = om.T @ B
    err_B, err_C = rel_fro(B, B_ref), rel_fro(C, C_ref)
    print(f"[one-shot] nystrom_fused {t_oneshot * 1e3:.1f} ms; "
          f"B rel_fro={err_B:.3e}, C rel_fro={err_C:.3e} "
          f"(tol {f32_tol(N):.1e})")
    check(tuple(B.shape) == (N, R) and tuple(C.shape) == (R, R),
          "nystrom_fused: wrong shapes")
    check(err_B <= f32_tol(N) and err_C <= f32_tol(N),
          "nystrom_fused disagrees with the plain version")
    # C's top 64 eigenvalues carry A's rank-64 part; its other 448 sit about
    # 1e-6 below them, at the level of C's own f32 rounding, so the default
    # f32 cutoff (1e-6) inverts rounding noise.  1e-4 drops them.
    nys_err = float(relative_error(A, B, C, rcond=NYSTROM_RCOND))
    nys_default = float(relative_error(A, B, C))
    nys_plain = float(relative_error(A, B_ref, C_ref))
    print(f"[one-shot] Nystrom relative error ||A - B C+ B^T||/||A|| = "
          f"{nys_err:.3e} at rcond {NYSTROM_RCOND:g}; at the default f32 "
          f"rcond 1e-6: {nys_default:.3e} (plain pair {nys_plain:.3e})")
    check(math.isfinite(nys_err) and nys_err < 1e-2,
          f"Nystrom error {nys_err}")
    fwd_err = max_abs(B, B_ref)
    del om, B_ref, C_ref
    records.append(cost_record(3, "ops.nystrom_fused",
                               nystrom_local_cost(N, R), t_oneshot))

    # -- 4. streaming main path ----------------------------------------------
    t0 = time.perf_counter()
    st = StreamingSketch(cfg)
    for r0 in range(0, N, SLAB):
        st.update_rows(r0, A[r0:r0 + SLAB])
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    records.append(cost_record(
        4, f"StreamingSketch.update_rows x {N // SLAB}",
        times(stream_update_cost(SLAB, N, R, L), N // SLAB), t_stream))
    low = st.reconstruct(rank=64)
    Yn, Cn = st.nystrom()
    torch.cuda.synchronize()
    counts = {k: LAUNCHES[k] for k in ("gen_omega", "sketch_fwd", "sketch_t")}

    y_bitwise = torch.equal(st.Y, B)
    err_Y = rel_fro(st.Y, B)
    W_ref = torch.zeros_like(st.W)
    for r0 in range(0, N, SLAB):
        W_ref = local._sketch_t_block_torch(A[r0:r0 + SLAB], SEED, L,
                                            row0=r0, salt=cfg.psi_salt,
                                            acc=W_ref)
    err_W = rel_fro(st.W, W_ref)
    t_err = max_abs(st.W, W_ref)
    rec_err = float(reconstruction_error(A, low))
    err_Cn = rel_fro(Cn, C)
    print(f"[stream] 8 slabs of {SLAB} rows in {t_stream * 1e3:.1f} ms; "
          f"Y == one-shot B bitwise: {y_bitwise} (rel_fro {err_Y:.3e}); "
          f"W rel_fro={err_W:.3e} (tol {f32_tol(SLAB):.1e})")
    print(f"[stream] reconstruct(rank=64) error {rec_err:.3e}; nystrom() C "
          f"vs one-shot C rel_fro {err_Cn:.3e}")
    check(y_bitwise, "streamed Y is not bitwise the one-shot B")
    check(err_Y <= f32_tol(N), "streamed Y disagrees with the one-shot B")
    check(err_W <= f32_tol(SLAB), "W disagrees with the plain version")
    check(math.isfinite(rec_err) and rec_err < 1e-2,
          f"reconstruction error {rec_err}")
    check(err_Cn <= f32_tol(N), "stream nystrom() C disagrees")
    del low, Yn, Cn, W_ref

    # -- 5. launches and timings ----------------------------------------------
    print(f"[launches] main path (phases 3-4): {counts}")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} never launched on the main path")

    k0, k1 = SEED, 0
    rows = []
    # gen_omega at the Psi tile of reconstruct(): (N, l), output only
    gen_ms = time_ms(lambda: gen_omega_cuda(k0, k1, 0, 0, N, L, "normal", 1,
                                            device=dev))
    gen_plain = time_ms(lambda: _omega_tile_torch(k0, k1, 0, 0, N, L,
                                                  "normal", 1, None, None,
                                                  dev))
    # its bound by integer work: the SASS count of one normal entry, the SM
    # clock under this load
    sass = omega_entry_sass(_build.build())
    mhz = sm_clock_mhz(lambda: gen_omega_cuda(k0, k1, 0, 0, N, L, "normal",
                                              1, device=dev), gen_ms)
    gen_ops, gen_clocks, gen_pipe = omega_ops_bound_ms(sass, N * L, mhz)
    gen_bytes = bound_ms(0.0, 4.0 * N * L)[0]
    gen_bound = ((gen_ops, "operations") if gen_ops >= gen_bytes
                 else (gen_bytes, "bytes"))
    print(f"[k8] gen_omega_kernel SASS, one normal entry: "
          f"{sass['issue']} instructions ({sass['alu']} integer ALU, "
          f"{sass['fma_heavy']} IMAD/VIADD of which {sass['imad_wide']} "
          f"IMAD.WIDE, {sass['fp32']} FP32, {sass['xu']} XU, {sass['lsu']} "
          f"LSU, {sass['other']} branch/barrier); SM clock under load "
          f"{mhz:.0f} MHz; {gen_clocks:.4f} clocks an entry of an SM lane "
          f"({gen_pipe} binds) x {N * L} entries / {H100_SMS} SMs: bound "
          f"{gen_ops:.4f} ms by operations (bytes {gen_bytes:.4f} ms); "
          f"measured {gen_ms:.4f} ms, {gen_ops / gen_ms:.3f} of the bound")
    rows.append(("gen_omega",
                 "src/repro/kernels/sketch_matmul.py:161 gen_omega_pallas "
                 "(K8; generator K1: kernels/local.py:173 _om_block)",
                 counts["gen_omega"], gen_err, gen_ms, gen_plain,
                 gen_bound, None))
    # sketch_fwd at nystrom_fused's shape: A (N, N) -> B (N, r)
    om = _omega_tile_torch(k0, k1, 0, 0, N, R, "normal", 0, None, None, dev)
    fwd_ms = time_ms(lambda: local.sketch_block(A, SEED, R))
    fwd_plain = time_ms(lambda: local._sketch_block_torch(A, SEED, R))
    fwd_lib = time_ms(lambda: torch.matmul(A, om))
    fwd_bound = bound_ms(2.0 * N * N * R, 4.0 * (N * N + N * R))
    fwd_parts = kernel_parts(lambda: local.sketch_block(A, SEED, R),
                             "sketch_fwd_gemm_kernel")
    rows.append(("sketch_fwd",
                 "src/repro/kernels/local.py:286 _sketch_block_pallas (K2; "
                 "K6: kernels/sketch_matmul.py:76 sketch_matmul_pallas)",
                 counts["sketch_fwd"], fwd_err, fwd_ms, fwd_plain,
                 fwd_bound, fwd_lib))
    sketch_fwd_calls = {
        "one_shot": (fwd_ms, fwd_plain, fwd_lib, fwd_bound, fwd_parts)}
    records.append(cost_record(3, "sketch_block (the one-shot B)",
                               local_cost(N, N, R), fwd_ms * 1e-3))
    print(f"[timing] sketch_fwd at the one-shot ({N}x{N} -> {N}x{R}): "
          f"{fwd_ms:.3f} ms (plain {fwd_plain:.3f}, library {fwd_lib:.3f}, "
          f"bound {fwd_bound[0]:.3f} ms by {fwd_bound[1]}); on the device "
          f"(torch.profiler): {parts_text(fwd_parts)}")
    del om
    # sketch_t at the streaming W update's shape: W (l, N) += Psi_k^T H_k
    H = A[:SLAB]
    W = torch.zeros(L, N, device=dev)
    psi = _omega_tile_torch(k0, k1, 0, 0, SLAB, L, "normal", 1, None, None,
                            dev)
    t_ms = time_ms(lambda: local.sketch_t_block(H, SEED, L, salt=1, acc=W))
    t_plain = time_ms(lambda: local._sketch_t_block_torch(H, SEED, L,
                                                          salt=1, acc=W))
    t_lib = time_ms(lambda: torch.addmm(W, psi.T, H))
    t_bound = bound_ms(2.0 * SLAB * N * L, 4.0 * (SLAB * N + 2 * L * N))
    t_parts = kernel_parts(
        lambda: local.sketch_t_block(H, SEED, L, salt=1, acc=W),
        "sketch_t_gemm_kernel")
    rows.append(("sketch_t",
                 "src/repro/kernels/local.py:326 _sketch_t_block_pallas (K3; "
                 "K7: kernels/sketch_matmul.py:125 sketch_t_matmul_pallas)",
                 counts["sketch_t"], t_err, t_ms, t_plain, t_bound, t_lib))
    # sketch_t at the Nystrom C shape (B (N, r) -> C (r, r)), split over K
    om = _omega_tile_torch(k0, k1, 0, 0, N, R, "normal", 0, None, None, dev)
    c_ms = time_ms(lambda: local.sketch_t_block(B, SEED, R))
    c_plain = time_ms(lambda: local._sketch_t_block_torch(B, SEED, R))
    c_lib = time_ms(lambda: torch.matmul(om.T, B))
    c_bound = bound_ms(2.0 * N * R * R, 4.0 * (N * R + R * R))
    c_parts = kernel_parts(lambda: local.sketch_t_block(B, SEED, R),
                           "sketch_t_gemm_kernel")
    del om
    sketch_t_calls = {
        "w_update": (t_ms, t_plain, t_lib, t_bound, t_parts),
        "nystrom_c": (c_ms, c_plain, c_lib, c_bound, c_parts)}
    for call, shape in (("w_update", f"W update ({SLAB}x{N} -> {L}x{N})"),
                        ("nystrom_c", f"Nystrom C ({N}x{R} -> {R}x{R})")):
        ms, plain, lib, (bms, by), parts = sketch_t_calls[call]
        print(f"[timing] sketch_t at the {shape}: {ms:.3f} ms (plain "
              f"{plain:.3f}, library {lib:.3f}, bound {bms:.3f} ms by {by}); "
              f"on the device (torch.profiler): {parts_text(parts)}")

    B_oneshot = B       # phase 3's B, held to phase 17's one-card plans
    del A, B, C, st, H, W, psi
    torch.cuda.empty_cache()

    # -- 6. fold, 7. lanes vs solo, 8. serving -------------------------------
    fold_err = phase_fold(dev, local.fold_rows_block, local._fold_rows_torch,
                          LAUNCHES, sm.FOLD_LANE_CAPACITY)
    phase_lanes(dev, SketchService, StreamConfig, make_ingest_queue)
    serve_counts, serve_st = phase_serving(serve, reset_launches, LAUNCHES)
    (f_ms, f_kernel, f_plain, f_lib, (f_bound, f_by), f_split, f_plan,
     f_loop) = fold_timing(dev, local.fold_rows_block,
                           local._fold_rows_torch, sm)
    rows.append(("fold_rows",
                 "src/repro/kernels/local.py:503 _fold_rows_pallas (K4; "
                 "vmapped over lanes by src/repro/stream/state.py:336 "
                 "local_rowblock_ragged_prog)",
                 serve_counts["fold_rows"], fold_err, f_ms, f_plain,
                 (f_bound, f_by), f_lib))
    print(f"[timing] fold_rows library call: one torch._foreach_add_ over "
          f"the 64 live windows (view lists built in the call) "
          f"{f_lib:.4f} ms; diagnosis: the per-lane "
          f"Y.narrow(0, row0, k).add_(dY[:k]) loop {f_loop:.4f} ms")
    print(f"[timing] fold_rows at one bucket (64 lanes, kb={S_KMAX}; plan "
          f"{f_plan}): the wrapper {f_ms:.4f} ms a call (host-bound), the "
          f"kernel itself "
          + ("not measured (no profiler trace)" if None in f_kernel
             else f"{f_kernel[0]:.4f} ms on the device (torch.profiler; "
                  f"{f_kernel[1]:.4f} ms with the L2 flushed by a read)")
          + f", bound {f_bound:.4f} ms; the wrapper's host stages "
          + ", ".join(f"{k} {us:.1f} us" for k, us in f_split.items()))
    dispatch_us = dispatch_timing(dev, SketchService, StreamConfig,
                                  local.fold_rows_block)
    print(f"[timing] one bucket's host cost (stage a one-row lane, one "
          f"fold_rows_block call; median of 200): {dispatch_us:.1f} us; "
          f"the H100 entry's dispatch_overhead "
          f"{machine.dispatch_overhead * 1e6:.1f} us")
    diag, lane_fwd = serving_diagnosis(dev, local, _omega_tile_torch)
    for (name, k), ms in diag.items():
        print(f"[diagnosis] serving shape: {name} one lane of k={k} "
              f"(n2={S_N2}, r={S_R}): {ms:.3f} ms")
    for k, (ms, plain, lib, (bms, by), parts) in lane_fwd.items():
        print(f"[timing] sketch_fwd at a serving lane of k={k} ({k}x{S_N2} "
              f"-> {k}x{S_R}): {ms:.4f} ms a wrapper call (plain "
              f"{plain:.4f}, library torch.matmul(H, Omega) {lib:.4f}, bound "
              f"{bms:.4f} ms by {by})"
              + ("" if parts is None else
                 f"; on the device (torch.profiler): {parts_text(parts)}"))
    sketch_fwd_calls["serving_lane"] = lane_fwd[128]
    # phase 8's lanes average about 128 rows: the kernel time of its timed
    # window, estimated
    timed = serve_st["launches"]
    est = {name: timed[name] * diag[(name, 128)] * 1e-3
           for name in ("sketch_fwd", "sketch_t")}
    est["fold_rows"] = timed["fold_rows"] * f_ms * 1e-3
    print(f"[diagnosis] phase 8 kernel time at k=128 per lane: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in est.items())
          + f"; the run took {serve_st['seconds']:.3f} s")
    serving_profile(serve)
    del diag
    torch.cuda.empty_cache()
    print(f"[phases] 1-8 done at {time.perf_counter() - t_start:.1f} s")

    # -- 9. gemm, 10. exchange, 11. training ---------------------------------
    gemm_err, gemm_times = phase_gemm(dev, local)
    sketch_fwd_calls["embed_leaf"] = gemm_times["sketch_fwd"]
    torch.cuda.empty_cache()
    phase_exchange(dev, local, grad_compress)
    torch.cuda.empty_cache()
    print(f"[phases] 9-10 done at {time.perf_counter() - t_start:.1f} s")
    train_counts, train_row = phase_training(dev, LAUNCHES,
                                             reset_launches)
    print(f"[phases] 11 done at {time.perf_counter() - t_start:.1f} s")
    check(train_counts["gemm"] > 0 and train_counts["sketch_fwd"] > 0,
          "gemm or sketch_fwd never launched on the training path")

    # -- 12. Alg. 1 on four ranks of one card ---------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[phases] before the spawn this process holds "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved of the "
          f"card")
    alg1 = phase_alg1(sass, mhz)
    print(f"[phases] 12 done at {time.perf_counter() - t_start:.1f} s")
    alg2 = phase_alg2(sass, mhz)
    print(f"[phases] 13 done at {time.perf_counter() - t_start:.1f} s")
    two_grid = phase_two_grid(sass, mhz)
    print(f"[phases] 14 done at {time.perf_counter() - t_start:.1f} s")
    stream_dist = phase_stream_dist()
    print(f"[phases] 15 done at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    sparse = phase_sparse(dev, LAUNCHES, reset_launches)
    print(f"[phases] 16 done at {time.perf_counter() - t_start:.1f} s")
    ex = sparse["extra"]
    records += (alg1_records(alg1) + alg2_records(alg2, ALG2_WORLD)
                + two_grid_records(two_grid) + stream_dist_records(
                    stream_dist, L)
                + [cost_record(16, "update_rows_sparse (normal)",
                               sparse_stream_update_cost(
                                   SLAB, N, R, L, ex["nnz"], kind="normal"),
                               ex["update_rows_sparse_wall_ms"] * 1e-3)])
    phase_records(records, card)

    # -- 17. the planner ------------------------------------------------------
    t17 = time.perf_counter()
    plan_tables = phase_plan_tables()
    A = make_matrix(dev)
    plan_one = phase_plan_one_card(dev, A, B_oneshot, LAUNCHES,
                                   reset_launches)
    del A, B_oneshot
    gc.collect()
    torch.cuda.empty_cache()
    plan_ranks = phase_plan_ranks()
    print("[plan] summary " + json.dumps({
        "one_card": plan_one, "tables": plan_tables,
        "ranks": [{"runs": res["runs"], "plans": res["plans"]}
                  for res in plan_ranks], "card": card}))
    print(f"[phases] 17 done at {time.perf_counter() - t_start:.1f} s "
          f"(phase 17: {time.perf_counter() - t17:.1f} s)")

    # -- 18. the measured autotuner ------------------------------------------
    t18 = time.perf_counter()
    A = make_matrix(dev)
    tuned_one = phase_autotune_one_card(dev, A, card, LAUNCHES,
                                        reset_launches)
    del A
    gc.collect()
    torch.cuda.empty_cache()
    tuned_ranks, rank_entries = phase_autotune_ranks()
    from repro_torch.plan import plan_nystrom, plan_sketch, plan_stream
    fit = phase_autotune_fit([
        plan_sketch(N, N, R), plan_nystrom(N, R),
        plan_stream(N, N, R, chunk_rows=SLAB, l=L, corange=True),
        plan_sketch(N, N, R, P=AT_WORLD), plan_nystrom(N, R, P=AT_WORLD)])
    print("[autotune] summary " + json.dumps({
        "one_card": tuned_one, "ranks": [
            {task: {k: v for k, v in res[task].items() if k != "records"}
             for task in res} for res in tuned_ranks],
        "rank_entries": rank_entries, "fit": fit, "card": card}))
    print(f"[phases] 18 done at {time.perf_counter() - t_start:.1f} s "
          f"(phase 18: {time.perf_counter() - t18:.1f} s)")

    # -- 19. the communication ledger -----------------------------------------
    t19 = time.perf_counter()
    obs_one = phase_obs_one_card(dev, card, LAUNCHES, reset_launches)
    gc.collect()
    torch.cuda.empty_cache()
    with open(AT_CACHE) as f:
        entries = dict(json.load(f)["entries"])
    entries.update(rank_entries)
    obs_ranks = phase_obs_ranks(entries, card)
    t19 = time.perf_counter() - t19
    check(t19 < OBS_SECONDS, f"phase 19 took {t19:.1f} s, not under "
                             f"{OBS_SECONDS} s")
    print("[ledger] summary " + json.dumps({
        "one_card": {k: v for k, v in obs_one.items() if k != "report"},
        "ranks": [{k: res[k] for k in ("rows", "launches", "flags", "popped",
                                       "again", "left")}
                  for res in obs_ranks],
        "seconds": t19, "card": card}, default=str))
    print(f"[phases] 19 done at {time.perf_counter() - t_start:.1f} s "
          f"(phase 19: {t19:.1f} s; {card})")

    # -- 20. the roofline -----------------------------------------------------
    t20 = time.perf_counter()
    rf_rows = phase_roofline_one_card(dev)
    gc.collect()
    torch.cuda.empty_cache()
    rf_rows += [train_row] + phase_roofline_ranks()
    t20 = time.perf_counter() - t20 + train_row["seconds"]
    roofline_report(rf_rows, card, t20)
    print(f"[phases] 20 done at {time.perf_counter() - t_start:.1f} s "
          f"(phase 20: {t20:.1f} s, (f) included; {card})")

    # -- 21. recovery ---------------------------------------------------------
    t21 = time.perf_counter()
    recovery = phase_recovery_one_card(dev, card, LAUNCHES, reset_launches)
    for name, n in recovery["launches"].items():
        check(n > 0, f"phase 21: {name} never launched on one card")
    gc.collect()
    torch.cuda.empty_cache()
    rc_ranks = phase_recovery_ranks(card)
    rc_launcher = phase_recovery_launcher()
    t21 = time.perf_counter() - t21
    print("[recovery] summary " + json.dumps({
        "one_card": recovery, "launcher_s": rc_launcher,
        "ranks": [{k: res[k] for k in ("hops", "launches",
                                       "service_wall_s", "arcs")}
                  for res in rc_ranks],
        "seconds": t21, "card": card}, default=str))
    check(t21 < RC_SECONDS, f"phase 21 took {t21:.1f} s, not under "
                            f"{RC_SECONDS} s")
    print(f"[phases] 21 done at {time.perf_counter() - t_start:.1f} s "
          f"(phase 21: {t21:.1f} s; {card})")

    # -- 22. data-parallel training on four ranks -----------------------------
    gc.collect()
    torch.cuda.empty_cache()
    dp = phase_dp_train(card)
    print("[dp-train] summary " + json.dumps(dp, default=str))
    print(f"[phases] 22 done at {time.perf_counter() - t_start:.1f} s "
          f"(phase 22: {dp['seconds']:.1f} s; {card})")

    # -- 23. LM serving of gemma2-2b at its published size --------------------
    gc.collect()
    torch.cuda.empty_cache()
    lm = phase_lm_serve(dev, card)
    print("[lm-serve] summary " + json.dumps(lm, default=str))
    print(f"[phases] 23 done at {time.perf_counter() - t_start:.1f} s "
          f"(phase 23: {lm['seconds']:.1f} s; {card})")

    # -- 24. MoE: granite-moe-1b-a400m, dbrx-132b on 8 layers -----------------
    gc.collect()
    torch.cuda.empty_cache()
    moe = phase_moe(dev, card, local, grad_compress, LAUNCHES, reset_launches)
    for name in ("sketch_fwd", "gemm"):
        check(moe["a"]["launches"][name] > 0,
              f"phase 24: {name} never launched on the MoE training path")
    print("[moe] summary " + json.dumps(moe, default=str))
    print(f"[phases] 24 done at {time.perf_counter() - t_start:.1f} s "
          f"(phase 24: {moe['seconds']:.1f} s; {card})")

    # -- 25. SSM and hybrid: falcon-mamba-7b, zamba2-1.2b ---------------------
    gc.collect()
    torch.cuda.empty_cache()
    hy = phase_ssm(dev, card, local, grad_compress, LAUNCHES, reset_launches)
    for name in ("sketch_fwd", "gemm"):
        check(hy["c"]["launches"][name] > 0,
              f"phase 25: {name} never launched on the hybrid training path")
    print("[ssm] summary " + json.dumps(hy, default=str))
    print(f"[phases] 25 done at {time.perf_counter() - t_start:.1f} s "
          f"(phase 25: {hy['seconds']:.1f} s; {card})")

    # -- 26. encoder-decoder and VLM: whisper-tiny, internvl2-26b ------------
    gc.collect()
    torch.cuda.empty_cache()
    ev = phase_encdec_vlm(dev, card, local, grad_compress, LAUNCHES,
                          reset_launches)
    for p in ("a", "d"):
        for name in ("sketch_fwd", "gemm"):
            check(ev[p]["launches"][name] > 0,
                  f"phase 26 ({p}): {name} never launched on the training "
                  f"path")
    print("[encdec-vlm] summary " + json.dumps(ev, default=str))
    print(f"[phases] 26 done at {time.perf_counter() - t_start:.1f} s "
          f"(phase 26: {ev['seconds']:.1f} s; {card})")

    total = [sum(gemm_times[c][i] for c in "abc") for i in range(3)]
    bound3 = sum(gemm_times[c][3][0] for c in "abc")
    rows.append(("gemm",
                 "src/repro/kernels/local.py:429 _gemm_pallas (K5; bodies "
                 ":386 _gemm_body, :406 _gemm_acc_body; via :617 "
                 "gemm_block)",
                 train_counts["gemm"], gemm_err, total[0], total[1],
                 (bound3, "bytes"), total[2]))
    rows.append(("sparse_fold",
                 "none: src/repro/stream/state.py:368 _local_sparse_update "
                 "is a plain XLA scatter, no pallas_call",
                 sparse["launches"], sparse["err"], sparse["ms"],
                 sparse["plain_ms"], sparse["bound"], sparse["library_ms"]))

    def leaf_calls(name: str, leaves: dict) -> dict:
        # the kernel's calls at each leaf of an ``exchange_calls`` result:
        # sketch_fwd, or gemm's (a), (b) into the gradient's dtype, (c)
        return {leaf: {"shape": res["shape"], "dtype": res["dtype"],
                       **{c: res["calls"][c] for c in (
                           ("sketch_fwd",) if name == "sketch_fwd"
                           else "abc")}}
                for leaf, res in leaves.items()}

    kernels = []
    for name, rep, n, err, ms, plain_ms, (bms, by), lib in rows:
        kernels.append({
            "name": name, "route": "cuda",
            "source": {"fold_rows": FOLD_SOURCE, "gemm": GEMM_SOURCE,
                       "sketch_t": SKETCH_T_SOURCE,
                       "sparse_fold": SPARSE_SOURCE}.get(name,
                                                         KERNEL_SOURCE),
            "replaces": rep, "launches": n, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib, "card": card})
        if name == "gen_omega":
            # bound_ms: the larger of the byte bound and the operation
            # bound from the SASS count of one normal entry
            kernels[-1].update(sass_per_entry=sass, sm_clock_mhz=mhz,
                               ops_bound_ms=gen_ops,
                               bytes_bound_ms=gen_bytes)
        if name == "fold_rows":
            # ms is the wrapper call (host-bound); the kernel's device
            # time, the wrapper's host stages and the plan beside it
            kernels[-1].update(kernel_ms=f_kernel[0],
                               kernel_cold_ms=f_kernel[1],
                               host_split_us=f_split,
                               plan=f_plan, per_lane_loop_ms=f_loop)
        if name == "gemm":
            # ms, plain_ms, library_ms and bound_ms sum calls (a), (b) into
            # f32 and (c) of one embed-leaf exchange (the training path's
            # (b) writes bf16, "b_bf16", which no one library call does);
            # each call on its own, with its path and its kernels' device
            # time:
            kernels[-1]["calls"] = {
                c: {"ms": t[0], "plain_ms": t[1], "library_ms": t[2],
                    "bound_ms": t[3][0], "bound_by": t[3][1], **t[4]}
                for c, t in gemm_times.items() if c != "sketch_fwd"}
        if name in ("sketch_fwd", "gen_omega"):
            # phase 12: each rank's launches over its Alg. 1 runs (counts
            # reset just before each run), and its local calls timed with
            # four ranks sharing the card
            kernels[-1]["alg1"] = {
                "launches": [res["launches"][name] for res in alg1],
                "calls": [res["calls"][name] for res in alg1]}
        if name in ("sketch_fwd", "sketch_t"):
            # phase 13: each rank's launches over its three Alg. 2 runs
            # (counts reset just before each run), and its local calls
            # timed with four ranks sharing the card
            kernels[-1]["alg2"] = {
                "launches": [res["launches"][name] for res in alg2],
                "calls": [res["calls"][name] for res in alg2]}
            # phase 14: the same for the two-grid Alg. 2's seven runs
            kernels[-1]["alg2_two_grid"] = {
                "launches": [res["launches"][name] for res in two_grid],
                "calls": [res["calls"][name] for res in two_grid]}
        if name in ("sketch_fwd", "gemm"):
            # phase 22: each rank's launches over its sketched DP steps
            # (counts reset just before)
            kernels[-1]["dp_train"] = {
                "launches": [res["a"]["launches"][name]
                             for res in dp["ranks"]],
                "steps": DP_SKETCHED}
            # phase 24 (a): the launches over granite-moe-1b-a400m's steps
            # (counts reset just before), and the kernel timed at the
            # leaves it meets first there (sketch_fwd; gemm's calls (a),
            # (b) into the gradient's dtype, (c))
            kernels[-1]["moe_train"] = {
                "launches": moe["a"]["launches"][name],
                "steps": MOE_STEPS,
                "calls": leaf_calls(name, moe["a"]["leaves"])}
            # phase 25 (c): the same over zamba2-1.2b's steps and at its
            # tallest leaf and a shared one
            kernels[-1]["hybrid_train"] = {
                "launches": hy["c"]["launches"][name],
                "steps": SSM_STEPS,
                "calls": leaf_calls(name, hy["c"]["leaves"])}
            # phase 26 (a) and (d): the same over whisper-tiny's steps, at
            # its positional table and embedding, and over internvl2-26b's
            # on 2 layers, at its projector and embedding
            kernels[-1]["encdec_vlm_train"] = {
                key: {"launches": ev[p]["launches"][name],
                      "steps": ED_STEPS,
                      "calls": leaf_calls(name, ev[p]["leaves"])}
                for key, p in (("whisper", "a"),
                               ("internvl2_2_layers", "d"))}
        if name in ("sketch_fwd", "sketch_t", "fold_rows"):
            # phase 21: the launches of the one-card recovery paths and of
            # each rank's reshards, queue and service (counts reset at the
            # start of each)
            kernels[-1]["recovery"] = {
                "launches_one_card": recovery["launches"][name],
                "launches_ranks": [res["launches"][name]
                                   for res in rc_ranks]}
        if name in ("sketch_fwd", "sketch_t", "fold_rows"):
            # phase 15: each rank's launches over its distributed-stream
            # runs (counts reset just before each run), and the kernel
            # timed at the phase's shape with four ranks sharing the card
            kernels[-1]["stream_dist"] = {
                "launches": [res["launches"][name] for res in stream_dist],
                "calls": [res["calls"][name] for res in stream_dist]}
        if name == "sparse_fold":
            # ms, plain_ms, library_ms and bound_ms sum the Y and the W
            # launch of one full-width normal slab (ms: the launcher alone,
            # CUDA events); each part, the walls and the bound's bytes:
            kernels[-1].update(sparse["extra"])
        if name in ("sketch_t", "sketch_fwd"):
            # ms, plain_ms, library_ms and bound_ms are those of sketch_t's
            # W update and of sketch_fwd's one-shot; each of the main
            # paths' shapes on its own, with the device time of the call's
            # draw, product and reduce kernels:
            kernels[-1]["calls"] = {
                c: {"ms": t[0], "plain_ms": t[1], "library_ms": t[2],
                    "bound_ms": t[3][0], "bound_by": t[3][1],
                    "device_ms": t[4]}
                for c, t in (sketch_t_calls if name == "sketch_t"
                             else sketch_fwd_calls).items()}
        print(f"[timing] {name}: {ms:.3f} ms (plain {plain_ms:.3f}, library "
              f"{'none' if lib is None else f'{lib:.3f}'}, bound {bms:.3f} "
              f"ms by {by}) launches={n}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
