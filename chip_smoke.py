#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FastMatch on one NVIDIA GPU and check it.

Run from the root of a checkout (one card; about 13 to 15 minutes at the
default size with the kernels' build, half of it phase 14's gloo ranks
and phase 15):

    python3 chip_smoke.py [--tuples N] [--seed S]

Phases, each of which raises (non-zero exit) when a check fails. The
tables of phases 4 and 7 are made from the start of the run, each by a
process of its own on host cores (`Tables`), while the kernels build and
phases 2, 3, 16 and 11 to 13 use the card; phase 4 then waits for its
table. Phases run in the order 1, 2, 3, 16, 11, 12, 13, 4, 5, 8, 9, 10,
6, 7, 14, 15.

1. Setup: build the three CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc each, in parallel) and print the card's name and power limit.
2. Each kernel against its plain PyTorch version on the card, at the
   main path's shapes: AnyActive on a gathered 512-block window of 236
   words; kernel A as the round runs it, the final marks of a 512-id
   window read in place from a 781,250 x 236 bitmap table (737 MB, made
   on the card from a seed): on a permuted window with padding rows,
   rows read already and a bit-31 row, in the table, gathered-window and
   scan forms, at W = 237 (the word-by-word path) and at phase 11a's
   W = 2 (a 32,768 x 2 table, 256-id windows), then timed warm
   and with the table cold against the parent's six-launch marking
   (gather, A, &, read-mask gather, ~, &); the fused ingest of one
   262,144-id window into 7548 x 24 counts, its ids drawn as the main
   path sends them (z zipf 0.3, the tuples of ~10 % of the blocks -1),
   and of uniform, out-of-range and empty batches: bitwise equal to its
   plain version, its inputs unchanged and its scratch back at zero,
   and the fresh histograms it also serves; the same cases at phase
   11a's 64 x 128 (a 256-block window of 2048 tokens a block, each
   block one domain), at the monitor's (1, 64) (587,776 N(0, 1) values
   crowded into the central bins) and the registry's (1, 14) (91 ids),
   and on both sides of the private form's bound (1 x 8,192 and
   1 x 8,193), each also cut to a length no multiple of 4 and as a view
   one element off its alignment, every form the shape can take pinned
   at the C entry and, at V_Z = 1, the z-less call; then kernel B timed
   at those four callers' shapes in its form, beside each form pinned,
   its plain version and `torch.bincount`; the batched distance for Q
   in {1, 8} and every metric at 7548 x 24 and 64 x 128 (narrow branch) and, in the
   wide branch, at 256 x 8192, 161 x 1440 (phase 7's shape), 7548 x 1440,
   191 x 2 under a forced sweeps = 2 and 3 x 524,288 (past the shared
   memory of a cluster: the two-sweep fallback), each in its f32 and its
   uint16 form (bitwise the f32 form), and the uint16 gate on counts
   holding 70,000 (both branches: bitwise the f32 form).
   Integer outputs must be equal, tau within 2e-5. Each check prints its device time (CUDA events around
   launches queued behind a sleep kernel, so the card runs them back to
   back), the kernel alone into preallocated outputs, the plain
   version's and, where one PyTorch call computes the same function,
   that call's; beside B and C, the whole `multiquery.ingest` and
   `multiquery.stats_step` at Q = 1, the whole gated uint16 tau step,
   kernel C under the plan the scheduler resolves for the taxi key at
   Q = 1 and 8 (the main path's launch; ``plan`` and ``plan_ms`` in the
   ``kernels`` line) and the reference's one-broadcast `xla` form (plain
   PyTorch). One ingest under the profiler must run kernel B and
   nothing else.
3. The engine on the test fixture (3M tuples): FastMatch at seed 3 on the
   card and on the CPU must return the same ids, counters and counts,
   and tau within 2e-5. Then `MatchServer` on the same fixture, for
   metric l1 and hellinger: three top-k queries (one with a tuples
   stop) and two closeness queries admitted after the first
   retirement; the card and the CPU must give the same ids, counters
   and stop fields. Then l1 on the card again under
   ``kernel_plans=PlanPair(TauPlan(sweeps=2, lowprec=True),
   IngestPlan(fused=False))``: kernel C's wide uint16 branch and the
   unfused ingest must give the default plans' ids and counters.
4. The engine at the paper's data scale: the TAXI-q1 shape (V_Z = 7548,
   V_X = 24, zipf 0.3, k = 10, eps = 0.12, delta = 0.01, lookahead 512)
   with 400M tuples resident on the card, under the kernel plans the
   scheduler resolves from benchmarks/results/tuned_torch/cuda.json
   (printed). FastMatch (seed 0) runs with every kernel's launch count
   set to 0 just before and read just after; kernels A and B must have
   launched once per round (and at 400M, seed 0: 27 rounds, 12,395
   blocks), kernel C in the form the plan names (Q times a stats step
   under an unrolled plan) and in no other form. Then Scan, counts reset
   again: A and B once per round, and its tau must equal the
   generator's true distances within 2e-5, FastMatch must not be exact,
   must read under half the blocks and must meet Guarantee 1 against
   Scan's exact distances. Both run again under a pinned lowprec plan
   (a plan file under build/): the same ids, rounds and blocks, kernel C
   only in its uint16 form, Scan's tau again within 2e-5 of the true
   distances; Scan's final max count says whether the gate tripped.
   A second FastMatch run under torch.profiler gives the device time by
   kernel and the PyTorch launches per round, and must gather no rows of
   the bitmap table.
5. Serving at full width on phase 4's resident table: `MatchServer(
   max_queries=8, lookahead=512, metric="l1")` answers 8 top-k queries
   (k = 10, eps = 0.12, delta = 0.01; the dataset's target and 7
   perturbations of it at l1 0.05-0.3; the target's own query stops at
   half the tuples its solo `run_engine` reads) and 4 closeness queries
   (eps = 0.10, gap = 0.20, delta = 0.01) submitted after the first
   retirement, one of them followed through `iter_results`. Counts at
   0 just before, read just after: kernels A and B once per round,
   kernel C per statistics step as the server's resolved plan says
   (printed), always called at Q = 8. Every answer is
   checked against the exact tau (kernel C's plain version over Scan's
   final counts): top-k answers (eps, k)-correct, closeness labels
   right outside the gap, the stop and the stream as specified. It
   prints walls, rounds, host syncs, shared against solo tuples, a warm
   re-submission's tuples, a profiled rerun's kernels and launches per
   round, and kernel C and `stats_step` at Q = 8.
8. The I/O, fault and recovery layer, right after phase 5 on its resident
   table, each sub-phase with the launch counts at 0 just before and read
   just after (kernels A and B at least once a round, kernel C at least
   once a statistics step) and its wall printed. 8a: phase 5's workload
   through `maybe_chaos` (FASTMATCH_CHAOS=1, seed 0): every request's ids,
   rounds, tuples and ``exact`` phase 5's, tau bitwise, retries > 0, not
   degraded, ``eps_effective == eps``. 8b: the same workload through
   ``ResilientSource(FaultySource(source, FaultPlan(p_corrupt=0.02,
   p_truncate=0.02), seed=5))``: blocks are quarantined, every outcome
   reports ``degraded`` and ``eps_effective = eps + 2q`` for the q known at
   its own retirement, the counts and n are bitwise the `torch.bincount`
   histogram of exactly the blocks the read mask marks (no quarantined
   tuple reached ingest), top-k answers meet Guarantee 1 at
   ``eps_effective`` and closeness labels are right outside the gap widened
   by 2q. 8c: a `ServeSupervisor` over the resident table serves the 8
   top-k targets with snapshots every 2 retirements; a `FaultySource`
   crashes it halfway through the rounds of an uncrashed run: one restart,
   every answer meets Guarantee 1, the restored cache is bitwise the
   snapshot's files, device memory after the recovery is within 8 MB of
   before the crash, and `MatchServer.restore` on the same files answers
   the last-retired target with 0 new tuples; each save's bytes and wall
   and the recovery's wall are printed. 8d: phase 4's FastMatch query from
   a host-resident source over the kept host arrays without and with
   prefetch, then from the resident table with prefetch: bitwise the same
   ids, tau, rounds and blocks (27 and 12,395 at 400M, seed 0), no prefetch
   worker alive after; walls (each the second run, after a warm-up) and
   device busy shares printed. 8b and 8c run with telemetry on: in 8b the
   registry's ``fastmatch_blocks_quarantined_total`` and the
   ``window_quarantine`` events must be the sources' quarantine (2,048
   blocks in 4 windows at 400M, seed 0); in 8c ``serve_crashes_total`` and
   ``serve_recoveries_total`` must be 1 and ``checkpoint_saves_total`` the
   saves the phase counts.
9. Telemetry, right after phase 8 on its resident table: phase 5's
   workload six times in one process, telemetry off and on in turns
   (``MatchServer(telemetry=True)``), counts at 0 just before each run and
   read just after. Every run must be bitwise phase 5 (each request's
   ids, rounds, tuples, ``exact`` and tau; ``host_syncs``, ``loop_syncs``
   and the exported cache) with phase 5's launches; a profiled on run must
   make phase 5's PyTorch launches a round. On each on run the registry's
   counters must equal the scheduler's mirrors and every curve point's
   ``eps_n`` Theorem 1 at its ``n_min``; the on runs' skeletons must be
   equal; ``export_trace`` and ``prometheus_metrics`` must round-trip; the
   registry's read must launch kernel B once a non-empty histogram and bin
   bitwise as ``np.bincount`` (the z-less call, in the private form).
   It prints the walls, the accounted
   telemetry host time (every telemetry entry point timed on the last on
   run, as the reference's benchmarks/telemetry_overhead.py accounts it)
   as a share of the off walls' median, the ``round_batch`` split of
   each on run's wall into gather, dispatch and sync, and kernel B at the
   registry's shape against its plain version and `torch.bincount`.
10. The mesh and the data-parallel pump, right after phase 9 on phase
   4's table (7548 x 24: V_Z divides by 2 and 4), generating none: the
   host arrays go into shared memory and four gloo ranks on the card
   (`distributed.run_ranks`) map them; each sub-phase has its own launch
   counts on every rank (kernels A and B once a round, kernel C at least
   once a statistics step). 10a: a 2 x 2 (data x model) `DistributedPump`
   and the single-stream scheduler here, driven with the same 12
   shuffled global windows of 512 blocks, 3 queries admitted first (the
   first stops after two windows of tuples), a fourth at round 3: every
   round's counts, n, read mask, counters, live and retired slots equal,
   and tau and delta_upper bitwise (within the Theorem-1 tolerance of
   `tests/test_torch_rounds.py` if the shard resolved another plan). 10b: phase 4's query
   through `MatchServer(mesh=, pump=True)`, first on a one-rank NCCL
   mesh here, bitwise phase 4 (ids, rounds, blocks, tau, counts, n,
   delta_upper), then on a 4 x 1 pump: Guarantee 1 against Scan's exact
   tau, the bound fired, and the counts and n bitwise the histogram of
   the blocks the read mask marks. 10c: phase 5's workload through a
   2 x 2 pump server, every answer through phase 5's checks. It prints
   rounds, passes, blocks, walls beside phases 4 and 5, every worker's
   gather seconds, collective calls, KB and host ms a round and kernel
   launches a round on every rank, and the phase's seconds with the
   children's start-up; ``{"check": "mesh", ...}``.
   The host arrays are dropped after phase 10.
6. The tuner on the card at the taxi keys (Q = 1 and 8 for l1, Q = 8
   for chi2 and hellinger, and the ingest) into build/tuned_smoke/: every
   candidate's time, and whether each winner is the committed file's
   (reported, not checked).
7. Wide rows: FastMatch at the minute-of-day shape, after phases 4 and 5
   freed their table. FLIGHTS' scheduled departure at minute resolution
   (V_Z = 161 origin airports, V_X = 1440, zipf 0.3, seed 47) with
   ``--tuples`` (400M) resident on the card, phase 4's query (k = 10,
   eps = 0.12, delta = 0.01, lookahead 512) and phase 4's checks:
   FastMatch with A and B once per round (and at 400M, seed 0: 53
   rounds, 27,134 blocks) and kernel C only in its wide f32 form; Scan's
   tau the true distances; Guarantee 1; the pinned
   lowprec plan with the same ids, rounds and blocks, tau bitwise the
   default's and kernel C only as its wide uint16 form; a profiled rerun.
11. The data layer and the LM (after phase 16, while the tables are made),
   each sub-phase with the launch counts at 0 just before and read just
   after. 11a: the token corpus `make_corpus(CorpusSpec(vocab_size=
   151936, num_blocks=32768))` (seed 0, 67.1M tokens) and
   `select_domains(corpus, k=8, seed=0)` on the card: the planted
   `close_ids` in 9 rounds and 449 blocks (the reference's numbers on
   XLA:CPU), kernels A and B once a round, kernel C once a statistics
   step. 11b: a full-width qwen2.5-3b (`get_config`, bf16, weights from
   a seeded generator) behind `ServeEngine(slots=8, max_len=512)`, 16
   requests of 256-token prompts (two batches of `TokenStream(corpus,
   selected, batch_size=8, seq_len=256, seed=0)`), 32 new tokens each: 2
   prefills, 62 decode ticks, 512 tokens, every output the greedy
   prefill + decode loop's on the same 8-prompt batch, every logit
   finite; prefill ms, ms a decode tick and tokens/s. 11d: an
   `ActivationMonitor` over the 72 filled K and V caches of the loop's
   final caches (8 x 287 x 2 x 128 values each), captured on batch 1 and
   checked on batch 2 with its layer-0 keys times 4: one kernel-B launch
   a tensor (the z-less call, in the private form), every histogram
   bitwise `ref.histogram_ref` on the card, the planted drift flagged
   (the other 71 flags printed), kernel B at (1, 64) on layer 0's keys
   beside the call with zero z ids, each form pinned and
   `torch.bincount`. 11c: the same configuration in float32:
   prefill 128 tokens and decode the next 128, against `forward` on all
   256 (max |dlogits| <= 1e-3, equal argmax). ``{"check": "lm", ...}``.
12. Training (after phase 11 freed its model). 12a: the launcher's
   `train_loop` on a full-width qwen2.5-3b as its config defines it (bf16,
   AdamW, remat "full"; weights from a generator seeded 0), 4 steps of 8 x
   256 tokens at lr 3e-4, behind the launcher's own default corpus
   (`CorpusSpec(vocab_size=151936, num_blocks=512, block_tokens=2048,
   seed=0)`): the selected domains are the planted `close_ids`, kernels A
   and B once a round of the selection and kernel C once a statistics step
   (counts at 0 just before the loop, read just after: path
   ``train_select``; the LM itself runs none of the repo's kernels), every
   step ``step_ok`` 1 with a finite loss and grad norm, every weight matrix
   changed; it prints ms a step (median of the steps after the first),
   tokens/s and peak memory. 12b: three more steps on one fixed batch, the
   loss falling strictly at each; the first profiled (device time, top
   kernels, launches). 12c: a NaN in an embedding row the batch uses: the
   step reports ``step_ok`` 0, every parameter and moment bitwise unchanged
   (exact digests of every leaf), the step incremented. 12d: the smoke
   config in float32, the same weights on the card and the CPU: one step
   each within the CPU twins' bars (loss 1e-5, grad norm 1e-5 relative,
   parameters 5 % of the learning rate); remat none / full / dots give
   bitwise equal grads on the card. 12e: at the smoke config on the card,
   10 steps against 5, a save and a resume to 10 (atol 2e-2, the
   reference test's), and a bf16 train state through `CheckpointManager`
   bitwise. ``{"check": "train", ...}``.
13. Every model family (after phase 12 freed its model; under 2 GB
   allocated on the card when it starts), each sub-phase with the launch
   counts at 0 just before and read just after. For mixtral-8x7b (16 of
   its 32 layers: 23.48B parameters, the one cut; every width, all 8
   experts, top-2 and the 4096 window whole), recurrentgemma-2b,
   xlstm-125m and whisper-medium (whole), in turn: 13a
   `make_corpus(CorpusSpec(vocab_size=<the model's>, num_blocks=4096))`
   (seed 0) and `select_domains(corpus, k=8, seed=0)` on the card: the
   planted `close_ids` in 9 rounds and 457 blocks (the reference's numbers
   on XLA:CPU at every vocabulary), kernels A and B once a round, kernel C
   once a statistics step (path ``families_select``). 13b: the model in
   bf16 (`get_config`, weights from a generator seeded 0) behind
   `ServeEngine(slots=8, max_len=512)`, 8 requests of one `TokenStream(
   corpus, selected, batch_size=8, seq_len=256, seed=0)` batch (whisper:
   the last 224 tokens of each, its prompt limit), 32 new tokens each: 1
   prefill, 31 ticks, every output the greedy prefill + decode loop's on
   the same batch, every logit finite; prefill ms, ms a tick, tokens/s,
   peak memory and one profiled tick (device time, top kernels,
   launches). 13d: an `ActivationMonitor` over the loop's final decode
   state (mixtral: the K/V caches; recurrentgemma: the window K/V,
   ``lru_h`` and ``conv``; xLSTM: the mLSTM c/n/m and the sLSTM c/n/h/m;
   whisper: the self and cross K/V): one kernel-B launch at (1, 64) a
   tensor, every histogram bitwise `ref.histogram_ref` (path
   ``families_monitor``). 13c: float32 (mixtral at 4 layers, forward at
   the dropless capacity; whisper with encoder frames N(0, 0.02^2) from a
   seeded generator), 2 sequences: prefill 128 tokens (max_len 256, so
   recurrentgemma's window is 256) and decode the next 128 against
   `forward` on all 256 (max |dlogits| <= 1e-3, equal argmax). Then 13e:
   one train step of each family's smoke config (grok-1-314b too) in
   float32, the same weights and batch on the card and the CPU, within
   12d's bars, the MoE aux terms reported and within the loss's bar.
   ``{"check": "families", ...}``.

14. Sharded serving (after phase 7 freed its table; under 2 GB
   allocated on the card when it starts). 14a: `select_domains` on
   qwen2.5-3b's vocabulary corpus (4,096 blocks, seed 0) in this process:
   the planted `close_ids` in 9 rounds and 457 blocks, kernels A and B once
   a round, kernel C once a statistics step (path ``sharded_select``), and
   8 x 256-token prompts from its `TokenStream`. Then the one-process
   references on the card (freed before the spawn), and one `run_ranks`
   spawn of 4 gloo ranks sharing the card, re-meshing one process group.
   14b: a full-width qwen2.5-3b (bf16, seed 0) placed by
   `distributed.shard_model` on a 2 x 2 ("data", "model") mesh (local
   heads, head-sharded caches), each data replica's `ServeEngine(slots=4)`
   serving its 4 prompts, 32 new tokens: the prefill's last and the first
   tick's logits against one process on the same weights and prompts
   (the greedy loop on the replica's 4 rows: the engine's computation,
   phase 11b) and against the float32 evaluation of those bf16 weights:
   with delta the one-process logits' distance from the float32 ones at
   that step, within max(0.05, 2 delta) of one process and delta + 0.05 of
   float32 (at 36 bf16 layers delta is 0.09-0.10, over 0.05); every token
   equal to that loop's up to its first top-two margin under 0.05, both
   model ranks of a replica picking the same tokens; prefill ms, ms a
   tick, tokens/s a replica and in all, all-reduce calls, bytes and host
   seconds a tick (`COLLECTIVES`). 14c: the same weights on 1 x 4 under
   ``decode_seq_shard`` (flash-decoding, the cache's 512 positions in 4
   ranges): the prefill's and 4 ticks' logits under 14b's bars. 14d:
   mixtral-8x7b at 4 of its 32 layers in float32 (``moe_impl="local"``,
   the dropless capacity; in bf16 a router's near tie flips a token's
   experts between any two evaluations) on 2 x 2, 8 x 128 tokens: forward
   logits within 0.05 of one process, the aux terms within 0.05 of the
   one-process mean over the data shards, ``drop_frac`` 0. 14e:
   qwen2.5-3b in float32 at 4 layers on 2 x 2: the prefill's and 4 ticks'
   logits within 1e-4. 14f: qwen2.5-3b's 36 blocks as 4 stages of 9
   (`pipeline.stage_model`, a (4, 1, 1) ("pod", "data", "model") mesh), 4
   microbatches of 2 x 256: every stage returns the same hidden states,
   within 0.05 of one process on the same microbatches. 14g-14i, the
   recurrent and audio families at full width and depth from seed 0,
   each served by `shard_model` on its mesh: recurrentgemma-2b on 1 x 4
   in bf16 (LRU channels split, the conv output assembled for the gates;
   "q_heads" with uneven heads: each rank attends its own 3, 3, 2 or 2 of
   the 10 q heads against the one kv head), xlstm-125m on 2 x 2 in
   float32 (mLSTM and sLSTM heads split, ``w_up`` and ``w_gates``
   assembled; in bf16 one process is itself 1.0-1.5 from float32 and two
   bf16 evaluations land 0.65 apart, `tools/torch_bf16_spread.py`, as the
   reference's own bf16 does, tests/test_torch_xlstm_bf16.py),
   whisper-medium on 2 x 2 in bf16 (heads split, its 1,500 encoder
   frames from seed 0, the 51,865-token vocabulary whole): 14a's prompts
   (ids modulo the vocabulary; whisper's last 224), a prefill and 8 new
   tokens. The prefill's and 7 ticks' logits (teacher-forced on one
   process's tokens) under 14b's bars (xlstm-125m's float32 under
   SHARD_FAM_F32_ATOL, 1e-3), each data replica's
   `ServeEngine` picking one process's tokens up to the first top-two
   margin under 0.05, the plan's layout; prefill ms, ms a tick,
   all-reduces a tick, peak a rank against one process. 14j, the
   pipeline's backward: qwen2.5-3b at 8 of its 36 layers in float32
   (TF32 off) as 4 stages of 2, 4 microbatches of 14a's prompts, the
   gradient of sum(hidden * c) (c from seed 1) on every leaf a stage
   holds (its 2 blocks and the embedding table) within 1e-4 of the
   leaf's largest |grad| from one process's autograd on the card
   (saved to a temporary directory for the ranks to compare); ms a
   forward and a backward, collectives, peak a rank. 14k, training under
   the FSDP x TP layout: qwen2.5-3b at full width and 4 of its 36 layers
   in float32 (TF32 off, AdamW, ``remat="full"``, seed 0) placed by
   `shard_model(serving=False)` on 2 x 2 (`param_pspecs`: the d_model-like
   dims over "data" as well), two `make_train_step` steps on 14a's 8 x 256
   batch (4 rows a data replica) against one process on the same weights,
   batch and learning rate (run on the card before the spawn, its
   post-step parameters saved for the ranks): loss within 1e-5,
   grad_norm and param_norm within rtol 1e-5, every rank's blocks within
   5 % of the learning rate of the one process's slice after each step
   wherever the RMS gradient was at least 9 eps at every step so far,
   within the update's range (2 lr a step) on the elements whose
   gradient was near AdamW's eps = 1e-8, where f32 sums are rounding
   noise and AdamW's step swings on it;
   step_ok 1, the second loss below the first; ms a step, collectives a
   step, parameters held and peak a rank against one process. 14l, the
   same for every other family, each at full width in float32 with its
   own optimizer and remat, cut only in depth (SHARD_FAM_TRAIN, each cut
   printed): mixtral-8x7b at 1 of 32 layers (``moe_impl="gather"`` at
   its capacity factor 1.25: the global batch's slotting, the kept-pair
   count one process's exactly), internvl2-76b at 1 of 80 (Adafactor;
   14a's tokens behind its 256 vision-stub positions), recurrentgemma-2b
   at 3 of 26 (one "rra" period), xlstm-125m uncut, whisper-medium at
   4 + 4 layers (14g-14i's encoder frames); two steps against one process
   on the card, every step's metrics under 14k's bars, step 2 started on
   both sides from one process's parameters after step 1; after step 1
   every AdamW gradient block (the first moment over 1 - b1) within 1e-4
   of the leaf's largest |grad| (1e-3 for xlstm-125m, whose f32
   gradient one process's own rounding moves by 1.9e-4) and the post-step
   blocks within 5 % of lr
   where the gradient is well over both AdamW's eps and that bar (an
   Adafactor leaf's update within 5 % of its largest); ms a step,
   all-reduces, GB and host seconds a step, peak a rank against one
   process's; the FLOPs each rank counts in step 1 (`FlopCounterMode`),
   equal on every rank and held by 15a to the dry run's; mixtral-8x7b's
   expert rows a rank (`moe.batched_buffer`: its T*K pairs sorted by
   expert) and the global batch's kept pairs. 14l's uneven cases
   (SHARD_FAM_UNEVEN), on 1 x 4, where the heads do not divide over 4
   model ranks (`transformer.rank_heads`): recurrentgemma-2b's 10 q
   heads, each rank attending its own 3, 3, 2 or 2 (the "q_heads"
   layout: q, k and v assembled after their column products, the rank's
   q heads and the kv head they read kept, its output against ``wo``'s
   even row block through one collective more,
   `layers.row_parallel_span`); and xlstm-125m at its full width with 6
   heads in place of 4 (which divide), cut to one mLSTM and one sLSTM
   layer (SHARD_FAM_VARIANTS, printed), each rank running its own 2, 2,
   1 or 1 ("heads": the mLSTM's q, k and v assembled and cut to them,
   ``mix_norm`` over the rank's span, ``w_down`` through
   `layers.row_parallel_span`; the sLSTM's whole ``r_gates`` cut to
   them, its hidden states assembled by `layers.gather_span`), as the
   pod's 16 model ranks run xlstm-125m's 4. Each case's two steps under
   the same bars, and the ranks' FLOPs differing by design: each rank's
   held by 15a to the dry run at its own coordinate. 14g serves
   recurrentgemma-2b on 1 x 4 in the "q_heads" layout.
   14m, the "q_heads" layout (qwen2.5-3b's 16 q heads split 4 ways and
   its 2 kv heads not, so each rank attends its 4 q heads against the
   one kv head they read): 14e's float32 cut on 1 x 4 without
   flash-decoding, the prefill's and 4 ticks' logits within 14e's 1e-4 of
   one process, each rank's cache one kv head; 14k's two steps on 1 x 4
   under 14k's bars; the FLOPs each rank counts (`FlopCounterMode`) in a
   prefill, a tick and a train step, equal on every rank and held by 15a
   to the dry run's. No rank holds the whole
   model, and each rank's peak is under the one-process serving peak.
   ``{"check": "sharded", ...}``.
15. Training under ``scan_layers`` and the dry run, last (after phase 14).
   15c's two processes start before phase 14, so their meta runs use host
   cores while the card works: `python -m repro_torch.launch.dryrun` for
   llama3-405b x train_4k (stacked, Adafactor) and for the FastMatch
   round, each on the pod's rank (0, 0) on the meta device, the card
   hidden from them; each JSON ``ok``, FLOPs above 0, a bottleneck named
   (read after 15a). 15b: `train_loop` on qwen2.5-3b at full width and
   depth with each per-layer leaf one (36, ...) parameter (bf16, AdamW,
   remat "full", seed 0), phase 12's 4 steps of 8 x 256 behind the
   launcher's corpus and FastMatch's selection (kernels A and B once a
   round, C once a statistics step; path ``scan_train_select``): phase
   12's selection, every step ``step_ok`` 1 and finite, step 1's loss
   phase 12's within SCAN_LOSS_ATOL and its grad norm within
   SCAN_GNORM_RTOL (the same weights and batch), three more steps on one
   batch with the loss falling at each; ms a step beside phase 12's,
   peak memory. 15a: 14k's cell, 14l's seven and 14m's, each one train
   step of `launch.specs.make_case` on the meta device at rank (0, 0) of
   a virtual mesh of the cell's shape (2 x 2; 1 x 4 for 14l's uneven
   cases and 14m): the recorded all-reduce calls and payload bytes equal
   to what phase 14's rank 0 issued at each step, the FLOPs to what it
   counted in step 1 (`FlopCounterMode`), the parameter and
   optimizer-state elements to what it held; for 14l's uneven cases the
   same at every rank's own coordinate, each rank's FLOPs its own meta
   run's (not one rank's for all); the predicted argument +
   temp bytes printed beside its measured peak. 14m's prefill and tick
   on 1 x 4: the FLOPs equal to what 14m's rank 0 counted.
   ``{"check": "scan_dryrun", ...}``.
16. The families trained at full width, and the examples (after phase 3,
   while phase 4's and 7's tables are still being made on host cores;
   under 2 GB allocated on the card when it starts). 16a: phase
   12a's recipe for recurrentgemma-2b, xlstm-125m and whisper-medium in
   turn (`get_config`: full width and depth, bf16, AdamW, remat "full";
   weights from a generator seeded 0), each freed before the next is
   built: the launcher's `train_loop`, 4 steps of 8 x 256 at lr 3e-4
   behind its default corpus (`CorpusSpec(vocab_size=<the model's>,
   num_blocks=512, block_tokens=2048, seed=0)`) and FastMatch's selection,
   whisper's encoder frames N(0, 0.02^2) from a generator seeded 0 through
   the launcher's ``extra_batch_fn``: the planted `close_ids` selected,
   kernels A and B once a round and kernel C once a statistics step (path
   ``families_train_select``, each family's counts at 0 just before its
   loop and read just after, summed), every step ``step_ok`` 1 and finite,
   every weight matrix changed (and every other leaf an update of lr can
   move in bf16), then 12b's three steps on one batch with the loss
   falling at each; ms a step (median of steps 2-4), tokens/s and peak
   memory. ``{"check": "family_train", ...}``. 16b: the seven
   `examples/torch_*.py` in this process on the card at the reference
   examples' sizes, each run's launch counts at 0 just before and read
   just after (path ``examples``, their sum: kernels A, B and C each
   launched), each held to what it prints: quickstart's ids the planted
   top-k and ``delta_upper`` < 0.01; anytime's final ids its last
   statement's and the SLA query stopped for "tuples"; serve_match's
   shared tuples under the solo engines' sum and its late and restored
   queries reading 0 new tuples (as the reference example's do); census's
   five queries answered and every variant reading at most Scan's blocks;
   telemetry's trace, curves and scrape non-empty and parsing; serve_batch
   (its smoke config) every output the greedy prefill + decode loop's on
   the same left-padded batch; train_lm_fastmatch 4 steps with its
   checkpoints in a temporary directory (its `train_loop` wrapped to
   snapshot every 4 steps in place of the example's 100), then
   rerun to 6 steps from that directory: "[resume] restored step 4",
   every logged loss finite and ``step_ok`` 1. Each example's lines go to
   ``chiprun_out/examples/<name>.txt``. ``{"check": "examples", ...}``.

Every kernel must have launched on some path, each path's counts set to
0 just before it and read just after; a kernel's ``launches`` in the
``kernels`` line are those of the first path that runs it (``path``),
with every path's count beside them; kernel B's row adds the registry
read's launches and its registry-shape timing, and the monitor's
launches and its (1, 64) timing (phase 11d) and phase 13d's launches; every
row's ``launches_by_path`` includes ``train_select`` (phase 12a),
``families_select`` (13a), ``families_monitor`` (13d),
``sharded_select`` (14a), ``scan_train_select`` (15b),
``families_train_select`` (16a) and ``examples`` (16b). The last lines are the
``kernels`` JSON line, the card's name and power limit from
nvidia-smi, and ``{"ok": true, "device": {...}}``. Results
also go to ``chiprun_out/chip_smoke.json``. Exits 2 without a CUDA
device or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

TAU_ATOL = 2e-5
# Peaks of one H100 SXM (NVIDIA's data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

T0 = time.perf_counter()
T0_WALL = time.time()  # this module's import, comparable across processes


def log(msg: str) -> None:
    """A progress line, on standard output and on standard error (so the
    end of either shows how far a run got)."""
    line = f"[{time.perf_counter() - T0:8.1f}s] {msg}"
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class DeviceTimer:
    """Device time of one call: ``reps`` calls queued behind a sleep kernel
    long enough to cover their enqueue, timed with CUDA events, so the
    card runs them back to back and host overhead stays out. Median over
    ``batches``; also the host's enqueue time per call."""

    def __init__(self, torch):
        self.torch = torch
        start, end = self._events()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        self.ms_per_cycle = start.elapsed_time(end) / 10_000_000

    def _events(self):
        ev = self.torch.cuda.Event
        return ev(enable_timing=True), ev(enable_timing=True)

    def __call__(self, fn, *, reps: int = 30, batches: int = 5) -> tuple:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        cycles = int(3.0 * host_ms / self.ms_per_cycle) + 100_000
        per_call, host = [], []
        for _ in range(batches):
            start, end = self._events()
            torch.cuda._sleep(cycles)
            start.record()
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            host.append((time.perf_counter() - t) * 1e3 / reps)
            end.record()
            end.synchronize()
            per_call.append(start.elapsed_time(end) / reps)
        return statistics.median(per_call), statistics.median(host)


def _device_kernels(torch, fn, *, tries: int = 3) -> list:
    """Names of the device kernels one call of ``fn`` runs, under the
    profiler. A capture that comes back empty (CUPTI drops one now and
    then; a call that ran nothing on the card shows the same) is taken
    again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted(e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if names:
            break
    return names


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _check_fields(row: dict) -> dict:
    """A kernel measurement as a check line prints it (``kernel_ms``)."""
    return {("kernel_ms" if k == "ms" else k): v for k, v in row.items()}


def phase_setup(torch):
    from repro_torch.kernels import _build

    t = time.perf_counter()
    _build.build_all()
    log(f"built {len(_build.SOURCES)} kernel libraries in {time.perf_counter() - t:.1f}s")
    for name in _build.SOURCES:
        report = _build.library_path(name).with_suffix(".log").read_text()
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}.cu ptxas: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()
    log(f"card: {smi}")
    return smi


# kernel C's phase-2 shapes: (V_Z, V_X, the plan's sweeps)
C_SHAPES = ((7548, 24, 0), (64, 128, 0), (256, 8192, 0), (161, 1440, 0), (7548, 1440, 0),
            (191, 2, 2), (3, 524_288, 0))


def phase_kernels(torch, timer) -> dict:
    """Every kernel against its plain version at the main path's shapes.
    Returns the main-path measurement of each kernel by name."""
    import numpy as np

    from repro_torch.core.bitmap import words_for
    from repro_torch.kernels import anyactive, histogram, metrics, ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    main = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # the fixed cost of one launch in this timer: a kernel that does nothing
    floor_ms, _ = timer(lambda: torch.cuda._sleep(0))
    emit({"check": "launch_floor", "kernel_ms": floor_ms})

    # -- A: AnyActive, one lookahead window of the TAXI shape
    L, W = 512, words_for(7548)
    bm = rng.integers(0, 2**32, size=(L, W), dtype=np.uint32)
    mask = rng.integers(0, 2**32, size=(W,), dtype=np.uint32)
    bm[rng.random(L) < 0.5] &= ~mask  # half the blocks hold no active candidate
    bm[3] = 0
    bm[3, 7] = 1 << 31  # a block holding only a bit-31 candidate
    mask[7] |= np.uint32(1 << 31)
    b, m = t(bm.view(np.int32)), t(mask.view(np.int32))
    got, want = anyactive.anyactive(b, m), ref.anyactive_ref(b, m)
    torch.cuda.synchronize()
    check(torch.equal(got, want) and bool(got[3]), "anyactive disagrees with its plain version")
    ms, host = timer(lambda: anyactive.anyactive(b, m))
    plain, _ = timer(lambda: ref.anyactive_ref(b, m))
    bnd, by = bound_ms(L * W * 4 + W * 4 + L, 2 * L * W)
    emit({"check": "anyactive", "shape": [L, W], "marked": int(got.sum()), "equal": True,
          "kernel_ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
          "host_us": host * 1e3})
    main["anyactive"] = _phase_marking(torch, timer)

    # -- B: the fused ingest of one lookahead window (512 blocks x 512 tuples)
    from repro_torch.core import multiquery as mq

    v_z, v_x, n = 7548, 24, 262_144
    z, x = (t(a) for a in _window_ids(rng, v_z, v_x))
    _check_ingest_cases(torch, rng, z, x, v_z, v_x)
    counts = t(rng.integers(0, 2000, size=(v_z, v_x)).astype(np.float32))
    rows = counts.sum(dim=1)
    scratch = histogram.delta_scratch(v_z, v_x, dev)
    # phase 11a's shape: the corpus's 64 domains x 128 token buckets, one
    # 256-block window of 2048 tokens a block, each block one domain
    corpus_ids = [t(a) for a in _corpus_window_ids(rng)]
    _check_ingest_cases(torch, rng, *corpus_ids, 64, 128)
    # the V_Z = 1 shapes: the drift monitor's 587,776 activations into 64
    # bins (crowded in the central bins) and the registry's 91 latencies
    # into 14 buckets; the rule's threshold from both sides
    monitor_x = t(_skewed_ids(rng, 587_776, 64))
    registry_x = t(_skewed_ids(rng, 91, 14))
    _check_ingest_cases(torch, rng, torch.zeros_like(monitor_x), monitor_x, 1, 64)
    _check_ingest_cases(torch, rng, torch.zeros_like(registry_x), registry_x, 1, 14)
    for bins in (histogram.PRIVATE_MAX_BINS, histogram.PRIVATE_MAX_BINS + 1):
        edge_x = t(rng.integers(-2, bins + 2, size=262_144).astype(np.int32))
        _check_ingest_cases(torch, rng, torch.zeros_like(edge_x), edge_x, 1, bins)
    # the library yardstick: one torch.bincount over the flattened kept ids
    keep = z >= 0
    flat = (z.long() * v_x + x.long())[keep]
    lib = torch.bincount(flat, minlength=v_z * v_x).view(v_z, v_x)
    check(torch.equal(lib.float(), histogram.histogram(z, x, v_z=v_z, v_x=v_x)),
          "the bincount yardstick disagrees with the histogram")
    counts_out, rows_out = torch.empty_like(counts), torch.empty_like(rows)
    # the raw C entry below trusts its sizes: hold them to the buffers
    check(z.numel() == x.numel() == n and tuple(counts.shape) == (v_z, v_x)
          and tuple(scratch.shape) == (v_z, v_x) and tuple(rows.shape) == (v_z,),
          f"phase 2's pinned launch: {n} samples into {v_z} x {v_x} do not fit its buffers")
    ptrs = (z.data_ptr(), x.data_ptr(), counts.data_ptr(), rows.data_ptr(),
            counts_out.data_ptr(), rows_out.data_ptr(), scratch.data_ptr(), n, v_z, v_x,
            histogram.FORMS["global"])
    kern_ms, _ = timer(lambda: histogram.KERNEL.launch(*ptrs))
    flush_ms, _ = timer(lambda: histogram.KERNEL.launch(*ptrs[:7], 0, *ptrs[8:]))  # no samples
    ms, host = timer(lambda: histogram.ingest_counts(counts, rows, z, x, v_z=v_z, v_x=v_x))
    plain, _ = timer(lambda: histogram.ingest_counts_ref(counts, rows, z, x, v_z=v_z, v_x=v_x))
    library, _ = timer(lambda: torch.bincount(flat, minlength=v_z * v_x))
    # the whole ingest of the main path, Q = 1: one launch, nothing around it
    spec = mq.MultiQuerySpec(v_z=v_z, v_x=v_x, max_queries=1, k_cap=10)
    state = mq.admit_slot(mq.init_multi_state(spec, device=dev), 0,
                          t(rng.dirichlet(np.ones(v_x)).astype(np.float32)), 10, 0.12, 0.01)
    state = mq.stats_step(mq.ingest(state, z, x, spec=spec), spec=spec)
    ingest_ms, ingest_host = timer(lambda: mq.ingest(state, z, x, spec=spec))
    ingest_kernels = sorted(set(
        _device_kernels(torch, lambda: mq.ingest(state, z, x, spec=spec))))
    check(ingest_kernels and all("ingest_" in k for k in ingest_kernels),
          f"multiquery.ingest ran kernels besides kernel B: {ingest_kernels}")
    # ids read once, counts and n read once and written once
    bnd, by = bound_ms(8 * n + 2 * (v_z * v_x * 4 + v_z * 4), int(keep.sum()) + 2 * v_z * v_x)
    # kernel B at the four shapes its callers hand it, in the form each
    # takes, beside each form pinned
    forms = [_kernel_b_row(torch, timer, z, x, v_z, v_x, ingest=True),
             _kernel_b_row(torch, timer, *corpus_ids, 64, 128, ingest=True),
             _kernel_b_row(torch, timer, None, monitor_x, 1, 64, ingest=False),
             _kernel_b_row(torch, timer, None, registry_x, 1, 14, ingest=False)]
    for row in forms:
        emit({"check": "kernel_b_form", **_check_fields(row)})
    main["histogram"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                             library_ms=library, host_us=host * 1e3, form="global", forms=forms)
    emit({"check": "ingest_counts", "shape": [n, v_z, v_x], "kept": int(keep.sum()),
          "equal": True, "inputs_unchanged": True, "scratch_zero": True,
          **_check_fields({k: v for k, v in main["histogram"].items() if k != "forms"}),
          "kernel_only_ms": kern_ms, "flush_only_ms": flush_ms,
          "ingest_ms": ingest_ms, "ingest_host_us": ingest_host * 1e3,
          "ingest_kernels": ingest_kernels})

    # -- C: batched distance in its f32 and its uint16 form: the narrow
    # branch at the taxi shape and at phase 11a's 64 x 128; the wide branch at the minute-of-day path's
    # shape (phase 7), at 7548 x 1440 where the bytes bound dominates, at
    # 256 x 8192, at police_q1's shape under a forced sweeps = 2 (191 x 2) and past
    # its shared-memory threshold (3 x 524,288, the two-sweep fallback)
    from repro_torch.kernels import autotune, ops

    for (vz, vx, sweeps) in C_SHAPES:
        counts_np = rng.integers(0, 40, size=(vz, vx)).astype(np.float32)
        counts_np[rng.random(vz) < 0.2] = 0.0
        counts_np[0] = 0.0  # an empty row
        counts = t(counts_np)
        c16, fits = counts.to(torch.uint16), torch.amax(counts) <= 65535.0
        lowprec = autotune.TauPlan(sweeps=sweeps, lowprec=True)
        wide = metrics.wide_branch(vx, sweeps=sweeps)
        f32_name = "distance_wide" if wide else "distance_multi"
        for q in (1, 8):
            q_hat = t(np.stack([rng.dirichlet(np.ones(vx)) for _ in range(q)]).astype(np.float32))
            for metric in metrics.METRIC_NAMES:
                got = metrics.distance_multi(counts, q_hat, metric=metric, sweeps=sweeps)
                want = metrics.distance_multi_ref(counts, q_hat, metric=metric)
                got16 = metrics.distance_multi(c16, q_hat, metric=metric, sweeps=sweeps,
                                               gate=(counts, fits))
                want16 = metrics.distance_multi_ref(c16, q_hat, metric=metric)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                err16 = float((got16 - want16).abs().max())
                check(err <= TAU_ATOL and bool(torch.isfinite(got).all()),
                      f"distance_multi {metric} Q={q} {vz}x{vx}: max err {err}")
                check(err16 <= TAU_ATOL and torch.equal(got16, got),
                      f"distance_multi uint16 {metric} Q={q} {vz}x{vx}: max err {err16}, "
                      "not bitwise the f32 form")
                ms, host = timer(lambda: metrics.distance_multi(counts, q_hat, metric=metric,
                                                                sweeps=sweeps))
                plain, _ = timer(lambda: metrics.distance_multi_ref(counts, q_hat, metric=metric))
                ms16, host16 = timer(lambda: metrics.distance_multi(
                    c16, q_hat, metric=metric, sweeps=sweeps, gate=(counts, fits)))
                plain16, _ = timer(lambda: metrics.distance_multi_ref(c16, q_hat, metric=metric))
                # the whole gate: max, compare, cast and the uint16 launch
                gated_ms, gated_host = timer(lambda: autotune.run_tau(
                    counts, q_hat, plan=lowprec, metric=metric))
                per_elem = {"l1": 4, "chi2": 6, "hellinger": 7}[metric]
                n_ops = vz * vx * (1 + q * per_elem)
                bnd, by = bound_ms(vz * vx * 4 + q * vx * 4 + q * vz * 4, n_ops)
                bnd16, by16 = bound_ms(vz * vx * 2 + q * vx * 4 + q * vz * 4 + 1, n_ops)
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                           library_ms=None, host_us=host * 1e3)
                row16 = dict(max_abs_err=err16, ms=ms16, plain_ms=plain16, bound_ms=bnd16,
                             bound_by=by16, library_ms=None, host_us=host16 * 1e3)
                extra = {}
                if (q, metric) == (1, "l1") and (vz, vx) in ((7548, 24), (161, 1440)):
                    main[f32_name] = row
                    main[f32_name + "_u16"] = row16
                if (vz, vx, q, metric) == (7548, 24, 1, "l1"):
                    tau = torch.empty((q, vz), dtype=torch.float32, device=dev)
                    extra["kernel_only_ms"], _ = timer(lambda: metrics.KERNEL.launch(
                        counts.data_ptr(), q_hat.data_ptr(), tau.data_ptr(), vz, vx, q, 0))
                    # ~100 launches a call: 5 calls stay inside the launch queue, so the
                    # card runs them back to back; no closeness slot, as on the main path
                    extra["stats_step_ms"], host = timer(
                        lambda: mq.stats_step(state, spec=spec, closeness=False), reps=5)
                    extra["stats_step_host_us"] = host * 1e3
                if vx in (24, 128) and metric == "l1":
                    # the launch the main path makes: the plan the scheduler resolves
                    # for this key from the committed plan file (phases 4, 5 and 11a)
                    resolved = autotune.resolve_plans(vz, vx, q, metric=metric, device=dev).tau
                    planned = ops.distance_multi(counts, q_hat, metric=metric, plan=resolved)
                    torch.cuda.synchronize()
                    check(float((planned - want).abs().max()) <= TAU_ATOL,
                          f"the resolved plan {resolved} disagrees at Q={q}")
                    extra["resolved_plan"] = dataclasses.asdict(resolved)
                    extra["resolved_ms"], _ = timer(lambda: ops.distance_multi(
                        counts, q_hat, metric=metric, plan=resolved))
                    row["plan"], row["plan_ms"] = extra["resolved_plan"], extra["resolved_ms"]
                    # the reference's one-broadcast form, plain PyTorch: timed, never run
                    # on the card's path
                    xla = metrics.distance_multi_xla(counts, q_hat)
                    extra["xla_max_abs_err"] = float((xla - want).abs().max())
                    check(extra["xla_max_abs_err"] <= TAU_ATOL, "the xla form disagrees")
                    extra["xla_ms"], _ = timer(lambda: metrics.distance_multi_xla(counts, q_hat))
                emit({"check": "distance_multi", "metric": metric, "q": q, "shape": [vz, vx],
                      "sweeps": sweeps, "branch": "wide" if wide else "narrow",
                      **_check_fields(row), "u16": _check_fields(row16),
                      "u16_bitwise_f32": True, "gated_ms": gated_ms,
                      "gated_host_us": gated_host * 1e3, **extra})
        # the gate's overflow case: one entry past the uint16 range, which the
        # cast wraps; every block must read the f32 counts instead
        over = counts.clone()
        over[min(3, vz - 1), min(5, vx - 1)] = 70_000.0
        over16, over_fits = over.to(torch.uint16), torch.amax(over) <= 65535.0
        q_hat = t(np.stack([rng.dirichlet(np.ones(vx)) for _ in range(8)]).astype(np.float32))
        for metric in metrics.METRIC_NAMES:
            for sweeps in (0, 2):
                want = metrics.distance_multi(over, q_hat, metric=metric, sweeps=sweeps)
                got = metrics.distance_multi(over16, q_hat, metric=metric, sweeps=sweeps,
                                             gate=(over, over_fits))
                planned = autotune.run_tau(over, q_hat, metric=metric,
                                           plan=autotune.TauPlan(sweeps=sweeps, lowprec=True))
                torch.cuda.synchronize()
                check(not bool(over_fits) and torch.equal(got, want) and torch.equal(planned, want),
                      f"the uint16 gate did not fall back exactly ({metric}, {vz}x{vx}, "
                      f"sweeps={sweeps})")
        del counts, c16, over, over16
        emit({"check": "distance_u16_gate", "shape": [vz, vx], "entry": 70_000.0,
              "fits": False, "bitwise_f32": True})
    return main


def _marking_table(torch, rows: int, words: int, seed: int) -> tuple:
    """A bitmap table made on the card from ``seed`` (half its rows miss
    the active mask), the active mask, and a read mask with ~5 % read."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randint(-2**31, 2**31, (rows, words), generator=gen, dtype=torch.int32,
                          device="cuda")
    mask = torch.randint(-2**31, 2**31, (words,), generator=gen, dtype=torch.int32,
                         device="cuda")
    table[torch.rand(rows, generator=gen, device="cuda") < 0.5] &= ~mask
    read_mask = torch.rand(rows, generator=gen, device="cuda") < 0.05
    return gen, table, mask, read_mask


def _permuted_window(torch, gen, table, mask, read_mask, length: int = 512) -> tuple:
    """A window of ``length`` permuted ids with ~10 % padding rows (id 0,
    not valid), ~5 % of its rows read already, and row 0 a block that
    holds only the last word's bit-31 candidate."""
    ids = torch.randperm(table.shape[0], generator=gen, device="cuda")[:length]
    valid = torch.rand(length, generator=gen, device="cuda") >= 0.1
    ids[~valid] = 0
    valid[0] = True
    read_mask[ids[0]] = False
    table[ids[0]] = 0
    table[ids[0], -1] = -2**31
    mask[-1] |= -2**31
    return ids, valid


def _phase_marking(torch, timer) -> dict:
    """Kernel A as the round runs it: the window's final marks from the
    whole resident bitmap table and the window's ids, in one launch.
    Checked against its plain version on a permuted window (padding,
    rows read already, a bit-31 row), in the gathered-window and scan
    forms, and at W = 237 (the word-by-word path); then timed against
    the parent's six-launch marking (gather, A, &, read-mask gather, ~,
    &), warm and with the table cold. Returns the main-path row."""
    from repro_torch.core.bitmap import words_for
    from repro_torch.kernels import anyactive, ops, ref

    nb, W, L = 781_250, 236, 512  # the 400M-tuple TAXI table and window
    gen, table, mask, read_mask = _marking_table(torch, nb, W, 11)
    ids, valid = _permuted_window(torch, gen, table, mask, read_mask)
    kept = [a.clone() for a in (ids, valid, read_mask, mask)]
    want = ref.mark_blocks_ref(ids, valid, read_mask, table, mask, by_id=True)
    got = ops.mark_blocks(ids, valid, read_mask, table, mask, by_id=True)
    gathered = ops.mark_blocks(ids, valid, read_mask, table[ids], mask)
    scan = ops.mark_blocks(ids, valid, read_mask)
    torch.cuda.synchronize()
    check(torch.equal(got, want) and bool(got[0]), "mark_blocks disagrees with its plain version")
    check(torch.equal(gathered, want), "mark_blocks on a gathered window disagrees")
    check(torch.equal(scan, ref.mark_blocks_ref(ids, valid, read_mask)),
          "mark_blocks' scan form disagrees with its plain version")
    check(all(torch.equal(a, b) for a, b in zip((ids, valid, read_mask, mask), kept)),
          "mark_blocks changed its inputs")
    emit({"check": "mark_blocks", "table": [nb, W], "window": L, "padding": int((~valid).sum()),
          "read_already": int((valid & read_mask[ids]).sum()), "marked": int(got.sum()),
          "equal": True, "gathered_equal": True, "scan_equal": True, "inputs_unchanged": True})
    # W = 237: rows off 16-byte boundaries take the word-by-word path
    g2, t2, m2, r2 = _marking_table(torch, 230_000, 237, 12)
    i2, v2 = _permuted_window(torch, g2, t2, m2, r2)
    w2 = ref.mark_blocks_ref(i2, v2, r2, t2, m2, by_id=True)
    check(torch.equal(ops.mark_blocks(i2, v2, r2, t2, m2, by_id=True), w2) and bool(w2[0]),
          "mark_blocks at W = 237 disagrees with its plain version")
    emit({"check": "mark_blocks", "table": [230_000, 237], "window": L, "equal": True})
    del g2, t2, m2, r2, i2, v2, w2
    # W = 2: phase 11a's shape, the corpus's 64 domains over its 32,768-block
    # table, windows of 256 ids (select_domains' lookahead)
    g3, t3, m3, r3 = _marking_table(torch, 32_768, words_for(64), 13)
    i3, v3 = _permuted_window(torch, g3, t3, m3, r3, length=256)
    w3 = ref.mark_blocks_ref(i3, v3, r3, t3, m3, by_id=True)
    check(torch.equal(ops.mark_blocks(i3, v3, r3, t3, m3, by_id=True), w3) and bool(w3[0]),
          "mark_blocks at W = 2 disagrees with its plain version")
    check(torch.equal(ops.mark_blocks(i3, v3, r3, t3[i3], m3), w3),
          "mark_blocks on a gathered window at W = 2 disagrees")
    check(torch.equal(anyactive.anyactive(t3[i3], m3), ref.anyactive_ref(t3[i3], m3)),
          "anyactive at W = 2 disagrees with its plain version")
    emit({"check": "mark_blocks", "table": [32_768, words_for(64)], "window": 256,
          "marked": int(w3.sum()), "equal": True, "gathered_equal": True,
          "anyactive_equal": True})
    del g3, t3, m3, r3, i3, v3, w3

    def parent(i, v):  # the parent's round: gather, kernel A, then four elementwise ops
        return anyactive.anyactive(table[i], mask) & v & ~read_mask[i]

    def fused(i, v):
        return ops.mark_blocks(i, v, read_mask, table, mask, by_id=True)

    def plain(i, v):
        return ref.mark_blocks_ref(i, v, read_mask, table, mask, by_id=True)

    # device kernels of one call of each form
    counts = {name: _device_kernels(torch, lambda fn=fn: fn(ids, valid))
              for name, fn in (("six_launch", parent), ("fused", fused))}
    check(torch.equal(parent(ids, valid), want), "the six-launch marking disagrees")
    check(len(counts["fused"]) == 1 and "mark_kernel" in counts["fused"][0],
          f"the fused marking ran {counts['fused']}")

    # windows as the main path sends them: 512 consecutive unread block ids
    # (the visit order is cyclic over the block ids), all valid; a fresh
    # stretch of the 737 MB table for each call keeps its rows cold
    read_mask.zero_()
    starts = torch.randperm(nb // L, generator=gen, device="cuda")[:200].tolist()
    span = torch.arange(L, device="cuda")
    cold = [(s * L + span, torch.ones(L, dtype=torch.bool, device="cuda")) for s in starts]
    warm = [cold[0]]

    def cycling(fn, windows):
        it = itertools.cycle(windows)
        return lambda: fn(*next(it))

    # ids 8 B, valid 1 B and a read-mask byte a row; each needed row read
    # once; the mask; one byte out
    rows_needed = L
    bnd, by = bound_ms(10 * L + 4 * W * rows_needed + 4 * W + L, 2 * W * rows_needed)
    rows = {}
    for temp, windows in (("warm", warm), ("cold", cold)):
        plain_ms, _ = timer(cycling(plain, windows))
        for name, fn in (("six_launch", parent), ("fused", fused)):
            ms, host = timer(cycling(fn, windows))
            rows[(name, temp)] = dict(ms=ms, host_us=host * 1e3)
            emit({"check": "marking", "form": name, "table": temp, "shape": [nb, W, L],
                  "device_kernels": len(counts[name]), "kernel_ms": ms, "host_us": host * 1e3,
                  "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by})
        rows[("plain", temp)] = plain_ms
    return dict(max_abs_err=0.0, ms=rows[("fused", "cold")]["ms"],
                plain_ms=rows[("plain", "cold")], bound_ms=bnd, bound_by=by, library_ms=None,
                host_us=rows[("fused", "cold")]["host_us"])


def _window_ids(rng, v_z: int, v_x: int, *, blocks: int = 512, block: int = 512) -> tuple:
    """One lookahead window's (z, x) as `fused_round` hands them to ingest:
    z zipf 0.3 over the candidates (as data/synth.py draws them), x
    uniform, and every tuple of ~10 % of the blocks -1 (blocks left
    unmarked)."""
    import numpy as np

    freq = np.arange(1, v_z + 1, dtype=np.float64) ** -0.3
    z = rng.choice(v_z, size=(blocks, block), p=freq / freq.sum()).astype(np.int32)
    x = rng.integers(0, v_x, size=(blocks, block)).astype(np.int32)
    unmarked = rng.random(blocks) < 0.1
    z[unmarked] = -1
    x[unmarked] = -1
    return z.reshape(-1), x.reshape(-1)


def _corpus_window_ids(rng, v_z: int = 64, v_x: int = 128, *, blocks: int = 256,
                       block: int = 2048) -> tuple:
    """One lookahead window of phase 11a's corpus as `fused_round` hands
    it to ingest: every block one domain, its tokens' buckets uniform,
    and every tuple of ~10 % of the blocks -1 (blocks left unmarked)."""
    import numpy as np

    z = np.repeat(rng.integers(0, v_z, size=blocks), block).reshape(blocks, block)
    z = z.astype(np.int32)
    x = rng.integers(0, v_x, size=(blocks, block)).astype(np.int32)
    unmarked = rng.random(blocks) < 0.1
    z[unmarked] = -1
    x[unmarked] = -1
    return z.reshape(-1), x.reshape(-1)


def _launch_form(torch, form: str, z, x, counts, rows, v_z: int, v_x: int, *,
                 with_rowsums: bool = True) -> tuple:
    """Kernel B's C entry with its form pinned: the outputs of
    `ingest_counts` (counts and rows given) or of
    `histogram_with_rowsums`, into new tensors; ``z`` None at V_Z = 1."""
    from repro_torch.kernels import histogram

    dev = x.device
    out = torch.empty((v_z, v_x), dtype=torch.float32, device=dev)
    n_out = torch.empty((v_z,), dtype=torch.float32, device=dev) if with_rowsums else None
    histogram.KERNEL.launch(
        None if z is None else z.data_ptr(), x.data_ptr(),
        None if counts is None else counts.data_ptr(), None if rows is None else rows.data_ptr(),
        out.data_ptr(), None if n_out is None else n_out.data_ptr(),
        histogram.delta_scratch(v_z, v_x, dev).data_ptr(), x.numel(), v_z, v_x,
        histogram.FORMS[form])
    return out, n_out


def _pinned_forms(v_z: int, v_x: int) -> tuple:
    """The forms kernel B can take at (v_z, v_x): the global form always,
    the private form where its counts fit the rule's bound."""
    from repro_torch.kernels import histogram

    return ("global",) if histogram.form_for(v_z, v_x) == "global" else ("global", "private")


def _skewed_ids(rng, n: int, bins: int = 64):
    """Bin ids as the drift monitor makes them from activations: N(0, 1)
    values binned over [-8, 8), so they crowd the central bins."""
    import numpy as np

    t = np.floor((rng.standard_normal(n) + 8.0) / 16.0 * bins)
    return np.clip(t, 0, bins - 1).astype(np.int32)


def _check_ingest_cases(torch, rng, z, x, v_z: int, v_x: int) -> None:
    """Kernel B at (v_z, v_x), its fused ingest and its histogram forms,
    bitwise against their plain versions on the window (z, x) and on
    uniform, out-of-range and empty batches of its size, the window cut
    to a length that is no multiple of 4 and as a view one element off
    its 16-byte alignment: the wrapper's form and every form the shape
    can take pinned (`_pinned_forms`), and at V_Z = 1 the z-less call;
    the inputs unchanged and the scratch back at zero."""
    import numpy as np

    from repro_torch.kernels import histogram, ref

    dev, n = z.device, z.numel()

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    uniform = [t(rng.integers(0, v, size=n).astype(np.int32)) for v in (v_z, v_x)]
    dropped = [t(rng.integers(-2, v + 2, size=n).astype(np.int32)) for v in (v_z, v_x)]
    empty = [t(np.zeros(0, np.int32))] * 2
    counts = t(rng.integers(0, 2000, size=(v_z, v_x)).astype(np.float32))
    rows = counts.sum(dim=1)
    scratch = histogram.delta_scratch(v_z, v_x, dev)
    cut = max(n - 1 - 4 * (n > 8), 0)
    cases = ((z, x, "window ids"), (*uniform, "uniform ids"),
             (*dropped, "out-of-range ids"), (*empty, "empty batch"),
             (z[:cut], x[:cut], f"{cut} ids"), (z[1:], x[1:], "a view one element off"))
    forms = _pinned_forms(v_z, v_x)
    for zz, xx, tag in cases:
        tag = f"{tag}, {v_z} x {v_x}"
        kept = [a.clone() for a in (counts, rows, zz, xx)]
        got = histogram.ingest_counts(counts, rows, zz, xx, v_z=v_z, v_x=v_x)
        want = histogram.ingest_counts_ref(counts, rows, zz, xx, v_z=v_z, v_x=v_x)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"ingest_counts disagrees with its plain version ({tag})")
        check(all(torch.equal(a, b) for a, b in zip((counts, rows, zz, xx), kept)),
              f"ingest_counts changed its inputs ({tag})")
        check(not bool(scratch.any()), f"ingest_counts left the scratch nonzero ({tag})")
        c, r = histogram.histogram_with_rowsums(zz, xx, v_z=v_z, v_x=v_x)
        wc, wr = ref.histogram_with_rowsums_ref(zz, xx, v_z=v_z, v_x=v_x)
        c1 = histogram.histogram(zz, xx, v_z=v_z, v_x=v_x)
        torch.cuda.synchronize()
        check(torch.equal(c, wc) and torch.equal(r, wr) and torch.equal(c1, wc),
              f"histogram disagrees with its plain version ({tag})")
        check(not bool(scratch.any()), f"histogram left the scratch nonzero ({tag})")
        # at V_Z = 1 also without z: every sample's row 0
        z_sets = [(zz, want, (wc, wr))]
        if v_z == 1:
            zeros = torch.zeros_like(xx)
            z_sets.append((None, histogram.ingest_counts_ref(counts, rows, zeros, xx, v_z=1,
                                                              v_x=v_x),
                           ref.histogram_with_rowsums_ref(zeros, xx, v_z=1, v_x=v_x)))
            check(torch.equal(histogram.histogram(None, xx, v_z=1, v_x=v_x), z_sets[1][2][0]),
                  f"the z-less histogram disagrees with its plain version ({tag})")
            check(not bool(scratch.any()), f"the z-less histogram left the scratch nonzero ({tag})")
        for form in forms:
            for zf, w_ingest, w_hist in z_sets:
                what = f"the {form} form{' without z' if zf is None else ''} ({tag})"
                fc, fr = _launch_form(torch, form, zf, xx, counts, rows, v_z, v_x)
                hc, hr = _launch_form(torch, form, zf, xx, None, None, v_z, v_x)
                torch.cuda.synchronize()
                check(torch.equal(fc, w_ingest[0]) and torch.equal(fr, w_ingest[1]),
                      f"{what}: the ingest disagrees with its plain version")
                check(torch.equal(hc, w_hist[0]) and torch.equal(hr, w_hist[1]),
                      f"{what}: the histogram disagrees with its plain version")
                check(not bool(scratch.any()), f"{what} left the scratch nonzero")
    emit({"check": "ingest_counts_cases", "shape": [n, v_z, v_x], "kept": int((z >= 0).sum()),
          "form": histogram.form_for(v_z, v_x), "forms_checked": list(forms),
          "z_less": v_z == 1, "equal": True, "inputs_unchanged": True, "scratch_zero": True})


def _kernel_b_row(torch, timer, z, x, v_z: int, v_x: int, *, ingest: bool) -> dict:
    """Kernel B at (v_z, v_x) on the ids (z, x), timed: the wrapper's call
    (`ingest_counts` into random counts when ``ingest``, else `histogram`;
    ``z`` None: the z-less call), each form pinned at the C entry, the
    plain version and `torch.bincount` of the kept ids. The bound reads
    the ids once (z only where given) and the counts and rows in and out
    (the counts out alone for a histogram)."""
    import numpy as np

    from repro_torch.kernels import histogram, ref

    dev = x.device
    n = x.numel()
    zr = torch.zeros_like(x) if z is None else z
    keep = (zr >= 0) & (zr < v_z) & (x >= 0) & (x < v_x)
    flat = (zr.long() * v_x + x.long())[keep]
    kept = int(keep.sum())
    counts = rows = None
    if ingest:
        gen = np.random.default_rng(v_z * v_x)
        counts = torch.from_numpy(gen.integers(0, 2000, size=(v_z, v_x)).astype(np.float32)).to(dev)
        rows = counts.sum(dim=1)

        def call():
            return histogram.ingest_counts(counts, rows, z, x, v_z=v_z, v_x=v_x)

        def plain():
            return histogram.ingest_counts_ref(counts, rows, zr, x, v_z=v_z, v_x=v_x)

        n_bytes = (4 if z is None else 8) * n + 2 * (v_z * v_x * 4 + v_z * 4)
        n_ops = kept + 2 * v_z * v_x
    else:
        def call():
            return histogram.histogram(z, x, v_z=v_z, v_x=v_x)

        def plain():
            return ref.histogram_ref(zr, x, v_z=v_z, v_x=v_x)

        n_bytes = (4 if z is None else 8) * n + v_z * v_x * 4
        n_ops = kept
    before = dict(histogram.FORM_LAUNCHES)
    got = call()
    want = plain()
    torch.cuda.synchronize()
    got, want = (got, want) if ingest else ((got,), (want,))
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"kernel B at {v_z} x {v_x} disagrees with its plain version")
    form = histogram.form_for(v_z, v_x)
    check(histogram.FORM_LAUNCHES[form] == before[form] + 1,
          f"kernel B at {v_z} x {v_x} did not take its {form} form")
    ms, host = timer(call)
    plain_ms, _ = timer(plain)
    library_ms, _ = timer(lambda: torch.bincount(flat, minlength=v_z * v_x))
    bnd, by = bound_ms(n_bytes, n_ops)
    row = dict(shape=[v_z, v_x], samples=n, kept=kept, z_less=z is None, form=form,
               max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
               library_ms=library_ms, host_us=host * 1e3)
    scratch = histogram.delta_scratch(v_z, v_x, dev)

    def still_right(outs, what: str) -> None:
        # one more call after a timed run's ~180 back-to-back launches:
        # bitwise the plain version, the scratch zero
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(outs, want)) and not bool(scratch.any()),
              f"kernel B at {v_z} x {v_x} ({what}) after its timed launches: not bitwise "
              f"the plain version, or the scratch not zero")

    still_right(call() if ingest else (call(),), form)
    for pinned in _pinned_forms(v_z, v_x):
        def launch(pinned=pinned):
            return _launch_form(torch, pinned, z, x, counts, rows, v_z, v_x, with_rowsums=ingest)

        row[f"{pinned}_ms"], _ = timer(launch)
        still_right(launch(), f"the {pinned} form pinned")
    return row


def _fixture_dataset(num_tuples: int, seed: int):
    from repro_torch.data.layout import block_layout
    from repro_torch.data.synth import SynthSpec, make_dataset

    spec = SynthSpec(v_z=80, v_x=16, num_tuples=num_tuples, k=8, n_close=8,
                     close_distance=0.02, far_distance=0.3, zipf_a=0.9, seed=seed)
    ds = make_dataset(spec)
    return ds, block_layout(ds.z, ds.x, v_z=80, v_x=16, block_size=512, seed=seed)


def phase_engine_small(torch) -> tuple:
    import numpy as np

    from repro_torch.core import engine, histsim

    ds, blocked = _fixture_dataset(3_000_000, 7)
    params = histsim.HistSimParams(v_z=80, v_x=16, k=8, eps=0.08, delta=0.05)
    cfg = engine.EngineConfig(variant="fastmatch", seed=3)
    a = engine.run_engine(blocked, ds.target, params, cfg, device="cuda")
    b = engine.run_engine(blocked, ds.target, params, cfg, device="cpu")
    check(np.array_equal(a.ids, b.ids), f"ids differ: card {a.ids} cpu {b.ids}")
    for f in ("blocks_read", "blocks_considered", "tuples_read", "rounds", "passes", "exact"):
        check(getattr(a, f) == getattr(b, f), f"{f} differs: {getattr(a, f)} vs {getattr(b, f)}")
    check(torch.equal(a.state.counts.cpu(), b.state.counts), "counts differ")
    err = float((a.state.tau.cpu() - b.state.tau).abs().max())
    check(err <= TAU_ATOL, f"tau differs by {err}")
    emit({"check": "engine_small", "ids": a.ids.tolist(), "blocks_read": a.blocks_read,
          "rounds": a.rounds, "exact": a.exact, "tau_max_abs_err": err, "equal": True})
    return ds, blocked


SERVE_FIELDS = ("rounds", "passes", "blocks_read", "blocks_considered", "tuples_read", "exact",
                "stopped", "stop_reason", "qtype")


def _serve_fixture(blocked, target, *, device, metric: str, kernel_plans=None) -> tuple:
    """Mixed serving on the fixture: three top-k queries (one stopped at
    20,000 tuples), then two closeness queries after the first retirement.
    Returns the results and the server."""
    import numpy as np

    from repro_torch.core.multiquery import StopPolicy
    from repro_torch.data.synth import perturb_distribution
    from repro_torch.serve import MatchServer

    rng = np.random.default_rng(17)
    targets = [target] + [perturb_distribution(target, d, rng) for d in (0.05, 0.1)]
    eps_k, (eps_c, gap) = {"l1": (0.08, (0.1, 0.2)), "hellinger": (0.05, (0.01, 0.04))}[metric]
    srv = MatchServer(blocked, device=device, max_queries=4, lookahead=64, seed=3, metric=metric,
                      kernel_plans=kernel_plans)
    srv.submit(targets[0], k=8, eps=eps_k, delta=0.05)
    srv.submit(targets[1], k=8, eps=eps_k, delta=0.05, stop=StopPolicy(tuples=20_000))
    srv.submit(targets[2], k=4, eps=eps_k, delta=0.05)
    while not srv.results:
        srv.step()
    for t in targets[:2]:
        srv.submit_closeness(t, eps=eps_c, gap=gap, delta=0.05)
    return srv.run_until_idle(), srv


def phase_serving_small(torch, ds, blocked) -> dict:
    """Card against CPU for l1 and hellinger, then l1 on the card under a
    pinned plan that forces kernel C's wide branch in its uint16 form and
    the unfused ingest: the same answers and counters as the default
    plans. Returns that run's launches."""
    import numpy as np

    from repro_torch.kernels import autotune, ops

    default_card = None
    for metric in ("l1", "hellinger"):
        card, srv = _serve_fixture(blocked, ds.target, device="cuda", metric=metric)
        cpu, _ = _serve_fixture(blocked, ds.target, device="cpu", metric=metric)
        check(srv.kernel_plans == autotune.PlanPair(),
              f"the fixture's shape resolved plans {srv.kernel_plans}")
        if metric == "l1":
            default_card = card
        check(sorted(card) == sorted(cpu) == list(range(5)),
              f"served {sorted(card)} on the card, {sorted(cpu)} on the CPU")
        for rid, b in cpu.items():
            a = card[rid]
            check(np.array_equal(a.ids, b.ids), f"{metric} request {rid}: ids {a.ids} vs {b.ids}")
            for f in SERVE_FIELDS:
                check(getattr(a, f) == getattr(b, f),
                      f"{metric} request {rid}: {f} {getattr(a, f)} vs {getattr(b, f)}")
        check(cpu[1].stopped and cpu[1].stop_reason == "tuples", "the fixture's stop did not fire")
        emit({"check": "serving_small", "metric": metric, "equal": True,
              "results": {rid: dict(qtype=r.qtype, ids=len(r.ids), rounds=r.rounds,
                                    tuples=r.tuples_read, exact=r.exact, stopped=r.stopped)
                          for rid, r in sorted(cpu.items())}})

    # -- the wide uint16 branch's path: counts at 0 just before, read just after
    pinned = autotune.PlanPair(autotune.TauPlan(sweeps=2, lowprec=True),
                               autotune.IngestPlan(fused=False))
    for kern in ops.KERNELS.values():
        kern.launches = 0
    got, srv = _serve_fixture(blocked, ds.target, device="cuda", metric="l1", kernel_plans=pinned)
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in ops.KERNELS.items()}
    rounds = srv.scheduler.rounds
    check(srv.kernel_plans == pinned, f"the server runs {srv.kernel_plans}, not {pinned}")
    check(sorted(got) == sorted(default_card), "the pinned plans served other requests")
    for rid, b in default_card.items():
        a = got[rid]
        check(np.array_equal(a.ids, b.ids), f"pinned plans, request {rid}: ids {a.ids} vs {b.ids}")
        for f in SERVE_FIELDS:
            check(getattr(a, f) == getattr(b, f),
                  f"pinned plans, request {rid}: {f} {getattr(a, f)} vs {getattr(b, f)}")
    check(launches["distance_wide_u16"] > 0 and launches["histogram"] == rounds
          and launches["anyactive"] == rounds,
          f"the pinned plans launched {launches} in {rounds} rounds")
    check(all(launches[k] == 0 for k in ("distance_multi", "distance_multi_u16", "distance_wide")),
          f"the pinned plans launched another form of kernel C: {launches}")
    emit({"check": "serving_small_pinned_plans", "plans": dataclasses.asdict(pinned),
          "rounds": rounds, "launches": launches, "equal_to_default_plans": True})
    return launches


def _profile_tables(torch, prof) -> tuple:
    """(total device ms, device rows, host rows) of a profile; a row is
    (name, ms, calls), largest first. Device rows are the kernels and
    copies on the card; host rows are the PyTorch ops by self CPU time
    (inflated by the profiler itself, so read them for their order)."""
    device, host = [], []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                device.append((e.key, us / 1e3, e.count))
        elif e.self_cpu_time_total > 0:
            host.append((e.key, e.self_cpu_time_total / 1e3, e.count))
    device.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    return sum(r[1] for r in device), device, host


def taxi_spec(num_tuples: int):
    """Phase 4's table: the reference's taxi_q1 shape scaled up."""
    from repro_torch.data.synth import SynthSpec

    return SynthSpec(v_z=7548, v_x=24, num_tuples=num_tuples, k=10, n_close=10,
                     close_distance=0.05, far_distance=0.45, zipf_a=0.3, close_rank="head",
                     seed=44)


def minute_spec(num_tuples: int):
    """Phase 7's table: FLIGHTS' scheduled departure at minute resolution
    (V_X = 1440) over its 161 origin airports."""
    from repro_torch.data.synth import SynthSpec

    return SynthSpec(v_z=161, v_x=1440, num_tuples=num_tuples, k=10, n_close=10,
                     close_distance=0.05, far_distance=0.45, zipf_a=0.3, close_rank="head",
                     seed=47)


TABLE_ARRAYS = ("z_blocks", "x_blocks", "bitmap", "target", "true_dists")


def _make_table(spec, out: str) -> None:
    """``spec``'s table (`make_dataset` and `block_layout`'s 512-tuple
    blocks), saved as .npy files under ``out`` with its seconds: a
    `Tables` process's work."""
    import numpy as np

    from repro_torch.data.layout import block_layout
    from repro_torch.data.synth import make_dataset

    t = time.perf_counter()
    ds = make_dataset(spec)
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    blocked = block_layout(ds.z, ds.x, v_z=spec.v_z, v_x=spec.v_x, block_size=512, seed=spec.seed)
    layout_s = time.perf_counter() - t
    arrays = dict(z_blocks=blocked.z_blocks, x_blocks=blocked.x_blocks, bitmap=blocked.bitmap,
                  target=ds.target, true_dists=ds.true_dists)
    for name in TABLE_ARRAYS:
        np.save(os.path.join(out, f"{name}.npy"), arrays[name])
    Path(out, "seconds.json").write_text(json.dumps(dict(generate_s=gen_s, layout_s=layout_s,
                                                         done_at=time.time())))


class Tables:
    """Phases 4's and 7's tables, each made by `_make_table` in a process of
    its own from the start of the run (host cores only) while the kernels
    build and the earlier phases use the card; `get` waits for one and
    loads it. A context manager that stops whatever is still running and
    removes the tables' files on exit."""

    def __init__(self, specs: dict):
        self.specs = specs

    def __enter__(self):
        import multiprocessing

        self.where = tempfile.mkdtemp(prefix="chip_smoke_tables_")
        self.started = time.time()
        ctx = multiprocessing.get_context("spawn")
        self.procs = {}
        for name, spec in self.specs.items():
            os.mkdir(os.path.join(self.where, name))
            self.procs[name] = ctx.Process(target=_make_table,
                                           args=(spec, os.path.join(self.where, name)))
            self.procs[name].start()
        return self

    def get(self, name: str) -> dict:
        """``name``'s table: the BlockedDataset, the target, the true
        distances and the seconds (made, laid out, waited for, loaded)."""
        import numpy as np

        from repro_torch.data.layout import BlockedDataset

        t = time.perf_counter()
        proc = self.procs[name]
        proc.join()
        wait_s = time.perf_counter() - t
        check(proc.exitcode == 0, f"the process making the {name} table exited {proc.exitcode}")
        out = Path(self.where, name)
        t = time.perf_counter()
        arrays = {key: np.load(out / f"{key}.npy") for key in TABLE_ARRAYS}
        seconds = json.loads((out / "seconds.json").read_text())
        seconds.update(wait_s=wait_s, load_s=time.perf_counter() - t,
                       ready_s=seconds.pop("done_at") - self.started)
        shutil.rmtree(out)
        spec = self.specs[name]
        blocked = BlockedDataset(z_blocks=arrays["z_blocks"], x_blocks=arrays["x_blocks"],
                                 bitmap=arrays["bitmap"], v_z=spec.v_z, v_x=spec.v_x)
        return dict(spec=spec, blocked=blocked, target=arrays["target"],
                    true_dists=arrays["true_dists"], seconds=seconds)

    def __exit__(self, *exc):
        for proc in self.procs.values():
            if proc.is_alive():
                proc.kill()
            proc.join()
        shutil.rmtree(self.where, ignore_errors=True)


def phase_engine_scale(torch, table: dict, seed: int, *, check_name: str, expect=None) -> tuple:
    """FastMatch and Scan on ``table`` (`Tables.get`) resident on the card
    (see the module docstring, phases 4 and 7); ``expect`` is FastMatch's
    (rounds, blocks) where they are known. Returns the report and what
    phase 5 serves from."""
    import numpy as np

    from repro_torch.core import engine, histsim
    from repro_torch.core.bitmap import words_for
    from repro_torch.io import InMemorySource
    from repro_torch.kernels import autotune, metrics, ops

    k, eps, delta = 10, 0.12, 0.01
    spec, blocked = table["spec"], table["blocked"]
    target, true_dists = table["target"], table["true_dists"]
    num_tuples = spec.num_tuples
    sec = table["seconds"]
    gen_s, layout_s = sec["generate_s"], sec["layout_s"]
    log(f"generated {num_tuples} tuples in {gen_s:.1f}s and laid out {blocked.num_blocks} blocks "
        f"in {layout_s:.1f}s in a process of their own, ready {sec['ready_s']:.1f}s into the "
        f"run (waited {sec['wait_s']:.1f}s, loaded in {sec['load_s']:.1f}s)")
    nb = blocked.num_blocks
    resident_gb = (blocked.z_blocks.nbytes + blocked.x_blocks.nbytes + blocked.bitmap.nbytes) / 1e9
    t = time.perf_counter()
    source = InMemorySource(blocked, device="cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t
    log(f"moved {resident_gb:.2f} GB to the card in {upload_s:.1f}s")

    params = histsim.HistSimParams(v_z=spec.v_z, v_x=spec.v_x, k=k, eps=eps, delta=delta)
    cfg = engine.EngineConfig(variant="fastmatch", seed=seed, lookahead=512)
    # what the engine's scheduler resolves from the committed plan file
    plans = autotune.resolve_plans(spec.v_z, spec.v_x, 1, metric="l1", device="cuda")
    c_launches = autotune.tau_launches(plans.tau, spec.v_x, 1)
    if spec.v_x > metrics.NARROW_MAX_VX:
        check(c_launches == {"distance_wide": 1},
              f"{plans.tau} does not take kernel C's wide f32 form once a stats step")
    log(f"resolved plans: {plans}")

    def check_c(launches: dict, expect: dict, run: str) -> None:
        for name in ("distance_multi", "distance_multi_u16", "distance_wide", "distance_wide_u16"):
            if name in expect:
                check(launches[name] > 0 and launches[name] % expect[name] == 0,
                      f"{run}: {launches[name]} {name} launches, not a positive multiple of "
                      f"{expect[name]}")
            else:
                check(launches[name] == 0, f"{run}: kernel C's {name} form ran under {plans}")

    # -- the main path: every launch count at 0 just before, read just after
    for kern in ops.KERNELS.values():
        kern.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    fm = engine.run_engine(source, target, params, cfg)
    torch.cuda.synchronize()
    fm_wall = time.perf_counter() - t
    launches = {name: kern.launches for name, kern in ops.KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"fastmatch: {fm.rounds} rounds, {fm.blocks_read}/{nb} blocks, {fm_wall:.3f}s, "
        f"{fm.host_syncs} host syncs, launches {launches}")
    for name in ("histogram", "anyactive"):
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")
    check_c(launches, c_launches, "fastmatch")
    for name in ("histogram", "anyactive"):
        check(launches[name] == fm.rounds,
              f"{launches[name]} {name} launches for {fm.rounds} fastmatch rounds")
    if expect is not None:
        check((fm.rounds, fm.blocks_read) == expect,
              f"fastmatch took {fm.rounds} rounds and read {fm.blocks_read} blocks, not {expect}")

    for kern in ops.KERNELS.values():
        kern.launches = 0
    t = time.perf_counter()
    scan = engine.run_engine(source, target, params, engine.EngineConfig(variant="scan"))
    torch.cuda.synchronize()
    scan_wall = time.perf_counter() - t
    scan_launches = {name: kern.launches for name, kern in ops.KERNELS.items()}
    log(f"scan: {scan.rounds} rounds, {scan.blocks_read} blocks, {scan_wall:.3f}s, "
        f"launches {scan_launches}")
    for name in ("histogram", "anyactive"):
        check(scan_launches[name] == scan.rounds,
              f"{scan_launches[name]} {name} launches for {scan.rounds} scan rounds")
    check_c(scan_launches, c_launches, "scan")

    truth = scan.state.tau.cpu().numpy()
    check(bool(np.isfinite(truth).all()) and truth.shape == (spec.v_z,), "scan tau malformed")
    scan_err = float(np.abs(truth.astype(np.float64) - true_dists).max())
    check(scan.exact and scan.blocks_read == nb, "scan did not read every block")
    check(scan_err <= TAU_ATOL, f"scan tau differs from the generator's by {scan_err}")
    check(not fm.exact, "fastmatch fell back to an exact read")
    check(fm.blocks_read < 0.5 * nb, f"fastmatch read {fm.blocks_read} of {nb} blocks")
    check(fm.delta_upper < delta, f"fastmatch delta_upper {fm.delta_upper} >= {delta}")
    true_top = set(np.argsort(truth, kind="stable")[:k].tolist())
    worst = max(float(truth[i]) for i in fm.ids)
    missing = sorted(true_top - set(fm.ids.tolist()))
    for j in missing:
        check(worst - float(truth[j]) < eps, f"Guarantee 1 broken by candidate {j}")

    # -- the same two queries under a pinned lowprec plan (kernel C's uint16
    # form behind the gate), through a plan file as a deployment would pin it
    pinned = autotune.PlanPair(autotune.TauPlan(lowprec=True), plans.ingest)
    reg = autotune.PlanRegistry(backend="cuda")
    reg.tau[autotune.tau_key(spec.v_z, spec.v_x, 1)] = pinned.tau
    reg.ingest[autotune.ingest_key(spec.v_z, spec.v_x)] = pinned.ingest
    autotune.reload(path=reg.save(ROOT / "build" / "smoke_plans" / "cuda.json"), backend="cuda")
    try:
        check(autotune.resolve_plans(spec.v_z, spec.v_x, 1, device="cuda") == pinned,
              "the pinned plan file did not resolve")
        lowprec = {}
        for run, variant_cfg, base in (("fastmatch", cfg, fm),
                                       ("scan", engine.EngineConfig(variant="scan"), scan)):
            for kern in ops.KERNELS.values():
                kern.launches = 0
            t = time.perf_counter()
            res = engine.run_engine(source, target, params, variant_cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            runs = {n: kern.launches for n, kern in ops.KERNELS.items()}
            check(np.array_equal(res.ids, base.ids) and res.rounds == base.rounds
                  and res.blocks_read == base.blocks_read,
                  f"{run} under a lowprec plan: ids {res.ids}, {res.rounds} rounds, "
                  f"{res.blocks_read} blocks, not the default plan's")
            check(torch.equal(res.state.tau, base.state.tau),
                  f"{run} under a lowprec plan: tau is not bitwise the default plan's")
            check_c(runs, autotune.tau_launches(pinned.tau, spec.v_x, 1),
                    f"{run} under a lowprec plan")
            max_count = float(res.state.counts.max())
            lowprec[run] = dict(rounds=res.rounds, blocks_read=res.blocks_read, wall_s=wall,
                                launches=runs, max_count=max_count,
                                gate_tripped=max_count > 65535.0, tau_bitwise_default=True)
            if run == "scan":
                lp_err = float(np.abs(res.state.tau.cpu().numpy().astype(np.float64)
                                      - true_dists).max())
                check(lp_err <= TAU_ATOL, f"scan under a lowprec plan: tau off by {lp_err}")
                lowprec[run]["tau_max_abs_err_vs_generator"] = lp_err
            log(f"{run} under {pinned.tau}: {res.rounds} rounds, {res.blocks_read} blocks, "
                f"{wall:.3f}s, max count {max_count:.0f} (gate tripped: "
                f"{lowprec[run]['gate_tripped']}), launches {runs}")
    finally:
        autotune.reload(backend="cuda")

    # -- where the device time goes: the same query under the profiler
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        again = engine.run_engine(source, target, params, cfg)
        torch.cuda.synchronize()
    check(np.array_equal(again.ids, fm.ids) and again.rounds == fm.rounds,
          "a repeated fastmatch run differs")
    # the rounds read bitmap rows in place: no gather takes the bitmap table
    table_shape = [nb, words_for(spec.v_z)]
    gathers = [e for e in prof.events()
               if e.name in ("aten::index", "aten::index_select") and e.input_shapes]
    check(not [e for e in gathers if list(e.input_shapes[0]) == table_shape],
          "a profiled round gathered rows of the bitmap table")
    device_ms, by_kernel, by_host_op = _profile_tables(torch, prof)
    busy = device_ms / (fm_wall * 1e3) if device_ms > 0 else None
    # what one round costs in launches: runtime launch calls on the host,
    # kernels (not copies or memsets) on the card
    host_launches = sum(c for name, _, c in by_host_op if name.startswith("cudaLaunch"))
    device_kernels = sum(c for name, _, c in by_kernel if not name.startswith(("Memcpy", "Memset")))
    log(f"profiled fastmatch: device time {device_ms:.3f} ms of {fm_wall * 1e3:.1f} ms wall")

    out = dict(
        shape=[spec.v_z, spec.v_x], tuples=num_tuples, blocks=nb, resident_gb=resident_gb,
        generate_s=gen_s,
        layout_s=layout_s, table_wait_s=sec["wait_s"], upload_s=upload_s,
        fastmatch=dict(ids=fm.ids.tolist(), rounds=fm.rounds, passes=fm.passes,
                       blocks_read=fm.blocks_read, blocks_share=fm.blocks_read / nb,
                       tuples_read=fm.tuples_read, wall_s=fm_wall, host_syncs=fm.host_syncs,
                       delta_upper=fm.delta_upper, exact=fm.exact,
                       ms_per_round=fm_wall * 1e3 / max(fm.rounds, 1),
                       peak_device_gb=peak_gb, missing_true_top_k=missing),
        scan=dict(rounds=scan.rounds, blocks_read=scan.blocks_read, wall_s=scan_wall,
                  tau_max_abs_err_vs_generator=scan_err),
        launches=launches, scan_launches=scan_launches,
        plans=dataclasses.asdict(plans), lowprec=lowprec,
        profile=dict(device_ms=device_ms, device_busy_share=busy,
                     host_launches_per_round=host_launches / again.rounds,
                     device_kernels_per_round=device_kernels / again.rounds,
                     index_ops_per_round=len(gathers) / again.rounds,
                     top=[dict(name=n, ms=ms, calls=c) for n, ms, c in by_kernel[:15]],
                     host_top=[dict(name=n, ms=ms, calls=c) for n, ms, c in by_host_op[:15]]),
    )
    emit({"check": check_name, **{k2: v for k2, v in out.items() if k2 != "profile"}})
    emit({"check": f"{check_name}_profile", **out["profile"]})
    # what phases 5 and 8 serve from: the resident table, the exact counts,
    # and the host arrays (phase 8's host-resident source)
    ctx = dict(source=source, target=target, counts=scan.state.counts, params=params, cfg=cfg,
               solo_target=fm, blocked=blocked, fastmatch=fm)
    return out, ctx


class _StatsProbe:
    """Counts `multiquery.stats_step` calls and records the Q of every
    `ops.distance_multi` call while installed (phase 5's launch checks);
    the kernels' own launch counts are untouched."""

    def __init__(self):
        from repro_torch.core import multiquery as mq
        from repro_torch.kernels import ops

        self.mq, self.ops = mq, ops
        self.stats_steps, self.qs = 0, []
        self._stats_step, self._distance = mq.stats_step, ops.distance_multi

    def __enter__(self):
        def stats_step(*a, **kw):
            self.stats_steps += 1
            return self._stats_step(*a, **kw)

        def distance_multi(counts, q_hat, **kw):
            self.qs.append(int(q_hat.shape[0]))
            return self._distance(counts, q_hat, **kw)

        self.mq.stats_step, self.ops.distance_multi = stats_step, distance_multi
        return self

    def __exit__(self, *exc):
        self.mq.stats_step, self.ops.distance_multi = self._stats_step, self._distance


def _serve_taxi(torch, source, topk_targets, close_targets, stop_tuples: int,
                telemetry=None, server=None, **server_kw) -> dict:
    """Phase 5's workload on one fresh server: 8 top-k queries (the first
    with a tuples stop), served step by step until the first retirement,
    then 4 closeness queries, the first followed through `iter_results`,
    then the rest drained. Returns the server, request ids and stream.
    A ``server`` built beforehand is served as it is (its construction
    outside the wall)."""
    from repro_torch.core.multiquery import StopPolicy
    from repro_torch.serve import MatchServer

    k, eps, delta, eps_c, gap = 10, 0.12, 0.01, 0.10, 0.20
    t = time.perf_counter()
    if server is None:
        server = MatchServer(source, max_queries=8, lookahead=512, metric="l1",
                             telemetry=telemetry, **server_kw)
    topk = [server.submit(tg, k=k, eps=eps, delta=delta,
                          stop=StopPolicy(tuples=stop_tuples) if i == 0 else None)
            for i, tg in enumerate(topk_targets)]
    while not server.results:
        server.step()
    close = [server.submit_closeness(tg, eps=eps_c, gap=gap, delta=delta) for tg in close_targets]
    stream = list(server.iter_results(close[0]))
    server.run_until_idle()
    torch.cuda.synchronize()
    return dict(server=server, topk=topk, close=close, stream=stream,
                wall_s=time.perf_counter() - t)


def phase_serving(torch, timer, ctx: dict) -> dict:
    """Serving at full width on phase 4's resident table (see the module
    docstring, phase 5)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine
    from repro_torch.core import multiquery as mq
    from repro_torch.data.synth import perturb_distribution
    from repro_torch.kernels import autotune, metrics, ops

    source, target, params, cfg = ctx["source"], ctx["target"], ctx["params"], ctx["cfg"]
    k, eps, eps_c, gap = 10, 0.12, 0.10, 0.20
    rng = np.random.default_rng(4321)
    topk_targets = [target] + [perturb_distribution(target, d, rng)
                               for d in np.linspace(0.05, 0.3, 7)]
    close_targets = [target] + [perturb_distribution(target, d, rng) for d in (0.05, 0.1, 0.2)]

    # one solo run_engine per top-k target: the I/O the server amortizes
    solo = [ctx["solo_target"]] + [engine.run_engine(source, tg, params, cfg)
                                   for tg in topk_targets[1:]]
    stop_tuples = solo[0].tuples_read // 2
    log(f"solo tuples: {[r.tuples_read for r in solo]}; stop at {stop_tuples}")

    # -- the serving path: counts at 0 just before, read just after
    for kern in ops.KERNELS.values():
        kern.launches = 0
    with _StatsProbe() as probe:
        run = _serve_taxi(torch, source, topk_targets, close_targets, stop_tuples)
    # phases 8 and 9 serve the same workload through faulty sources and
    # with telemetry on
    ctx["workload"] = (topk_targets, close_targets, stop_tuples)
    ctx["served"] = {rid: run["server"].results[rid] for rid in run["topk"] + run["close"]}
    launches = {name: kern.launches for name, kern in ops.KERNELS.items()}
    server, sched = run["server"], run["server"].scheduler
    ctx["phase5"] = dict(host_syncs=sched.host_syncs, loop_syncs=sched.loop_syncs,
                         rounds=sched.rounds, launches=launches, wall_s=run["wall_s"],
                         cache=[leaf.clone() for leaf in sched.export_cache()])
    results = dict(server.results)
    log(f"serving: {sched.rounds} rounds, {sched.host_syncs} host syncs, "
        f"{run['wall_s']:.3f}s, launches {launches}, stats steps {probe.stats_steps}")
    for name in ("anyactive", "histogram"):
        check(launches[name] == sched.rounds,
              f"{launches[name]} {name} launches for {sched.rounds} serving rounds")
    # kernel C as the plans the server resolved say: each stats step one
    # launch at Q = 8, or 8 at Q = 1 under an unrolled plan
    plans = server.kernel_plans
    log(f"serving plans: {plans}")
    c_launches = autotune.tau_launches(plans.tau, source.v_x, 8)
    check(probe.stats_steps == len(probe.qs), "a stats step ran kernel C twice")
    for name in ("distance_multi", "distance_multi_u16", "distance_wide", "distance_wide_u16"):
        want = c_launches.get(name, 0) * probe.stats_steps
        check(launches[name] == want,
              f"{launches[name]} {name} launches for {probe.stats_steps} stats steps under {plans}")
    check(set(probe.qs) == {8}, f"kernel C ran at Q = {sorted(set(probe.qs))}, not 8")

    # -- every answer against the exact tau of its target
    q_hats = np.stack([tg / tg.sum() for tg in topk_targets + close_targets]).astype(np.float32)
    truth = metrics.distance_multi_ref(
        ctx["counts"], torch.from_numpy(q_hats).to(ctx["counts"].device)
    ).cpu().numpy().astype(np.float64)
    check(bool(np.isfinite(truth).all()) and truth.shape == (12, source.v_z), "truth malformed")
    answers = []
    for i, rid in enumerate(run["topk"]):
        res, d = results[rid], truth[i]
        check(res.qtype == "topk" and len(res.ids) == k, f"top-k request {rid} malformed")
        true_top = set(np.argsort(d, kind="stable")[:k].tolist())
        worst = max(float(d[j]) for j in res.ids)
        correct = all(worst - float(d[j]) < eps for j in true_top - set(res.ids.tolist()))
        if i == 0:
            check(res.stopped and res.stop_reason == "tuples" and not res.exact,
                  f"the stopped query reports stopped={res.stopped} {res.stop_reason!r}")
            last = server.poll_result(rid)
            check(last.status == "done" and last.stopped and np.array_equal(last.ids, res.ids),
                  "the stopped answer is not its last poll")
        else:
            check(not res.stopped and correct, f"top-k request {rid} is not (eps, k)-correct")
        answers.append(dict(rid=rid, qtype="topk", correct=correct, rounds=res.rounds,
                            tuples=res.tuples_read, exact=res.exact, stopped=res.stopped,
                            delta_upper=res.delta_upper, wall_ms=res.wall_time_s * 1e3))
    for i, rid in enumerate(run["close"]):
        res, d = results[rid], truth[8 + i]
        got = set(res.ids.tolist())
        check(res.qtype == "closeness" and not res.stopped, f"closeness request {rid} malformed")
        check(set(np.flatnonzero(d <= eps_c).tolist()) <= got,
              f"closeness request {rid} missed a candidate within eps")
        check(got.isdisjoint(np.flatnonzero(d >= eps_c + gap).tolist()),
              f"closeness request {rid} labeled a far candidate close")
        answers.append(dict(rid=rid, qtype="closeness", close=len(got), rounds=res.rounds,
                            tuples=res.tuples_read, exact=res.exact,
                            delta_upper=res.delta_upper, wall_ms=res.wall_time_s * 1e3))
    stream = run["stream"]
    final = stream[-1]
    check(final.status == "done" and all(a.status != "done" for a in stream[:-1]),
          "the iter_results stream does not end at its one done answer")
    blocking = results[run["close"][0]]
    check(final.result is blocking and np.array_equal(final.ids, blocking.ids)
          and final.delta_upper == blocking.delta_upper,
          "the iter_results stream does not end with the blocking answer")
    shared = sched.tuples_read
    solo_total = sum(r.tuples_read for r in solo)

    # a warm re-submission of the first target, after everything retired
    rid = server.submit(topk_targets[0], k=k, eps=eps, delta=0.01)
    warm = server.run_until_idle()[rid]
    check(warm.delta_upper < 0.01 or warm.exact, "the warm re-submission did not resolve")

    # -- kernel C and the statistics step at Q = 8, on the path's last state
    state, spec = sched.state, sched.spec
    c_ms, c_host = timer(lambda: metrics.distance_multi(state.counts, state.q_hat))
    c_plain, _ = timer(lambda: metrics.distance_multi_ref(state.counts, state.q_hat))
    # the tau step as the resolved plan runs it (the gate included under lowprec)
    c_plan_ms, c_plan_host = timer(lambda: ops.distance_multi(state.counts, state.q_hat,
                                                              plan=plans.tau))
    stats_ms, stats_host = timer(lambda: mq.stats_step(state, spec=spec), reps=5)
    topk_stats_ms, _ = timer(lambda: mq.stats_step(state, spec=spec, closeness=False), reps=5)

    # -- where the time goes: the same workload on a fresh server, profiled
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = _serve_taxi(torch, source, topk_targets, close_targets, stop_tuples)
    again_sched = again["server"].scheduler
    check(again_sched.rounds == sched.rounds and again_sched.tuples_read == shared,
          "a repeated serving run differs")
    device_ms, by_kernel, by_host_op = _profile_tables(torch, prof)
    host_launches = sum(c for name, _, c in by_host_op if name.startswith("cudaLaunch"))
    device_kernels = sum(c for name, _, c in by_kernel if not name.startswith(("Memcpy", "Memset")))

    out = dict(
        rounds=sched.rounds, passes=sched.passes, host_syncs=sched.host_syncs,
        wall_s=run["wall_s"], wall_ms_per_query=run["wall_s"] * 1e3 / 12,
        shared_tuples=shared, solo_tuples=[r.tuples_read for r in solo],
        solo_tuples_total=solo_total, solo_walls_s=[r.wall_time_s for r in solo],
        stop_tuples=stop_tuples, warm_resubmit_tuples=warm.tuples_read,
        warm_resubmit_rounds=warm.rounds, answers=answers, stream_len=len(stream),
        launches=launches, stats_steps=probe.stats_steps,
        plans=dataclasses.asdict(plans),
        kernel_c_q8=dict(ms=c_ms, host_us=c_host * 1e3, plain_ms=c_plain, planned_ms=c_plan_ms,
                         planned_host_us=c_plan_host * 1e3),
        stats_step_q8=dict(ms=stats_ms, host_us=stats_host * 1e3, topk_only_ms=topk_stats_ms),
        profile=dict(wall_s=again["wall_s"], device_ms=device_ms,
                     device_busy_share=device_ms / (again["wall_s"] * 1e3),
                     device_kernels_per_round=device_kernels / again_sched.rounds,
                     host_launches_per_round=host_launches / again_sched.rounds,
                     top=[dict(name=n, ms=ms, calls=c) for n, ms, c in by_kernel[:15]]),
    )
    ctx["phase5"]["host_launches_per_round"] = out["profile"]["host_launches_per_round"]
    emit({"check": "serving", **{k2: v for k2, v in out.items() if k2 != "profile"}})
    emit({"check": "serving_profile", **out["profile"]})
    return out


# ---------------------------------------------------------------------------
# phase 8: the I/O, fault and recovery layer on phase 4's resident table
# ---------------------------------------------------------------------------

C_FORMS = ("distance_multi", "distance_multi_u16", "distance_wide", "distance_wide_u16")


def _reset_launches() -> None:
    from repro_torch.kernels import histogram, ops

    for kern in ops.KERNELS.values():
        kern.launches = 0
    for form in histogram.FORM_LAUNCHES:
        histogram.FORM_LAUNCHES[form] = 0


def _form_launches() -> dict:
    """Kernel B's launches by form since the last `_reset_launches`."""
    from repro_torch.kernels import histogram

    return dict(histogram.FORM_LAUNCHES)


def _launch_counts() -> dict:
    from repro_torch.kernels import ops

    return {name: kern.launches for name, kern in ops.KERNELS.items()}


def _check_per_round(launches: dict, rounds: int, stats_steps: int, what: str) -> None:
    """Kernels A and B launched at least once a round, kernel C at least
    once a statistics step (every sampling round runs one; an exact
    completion's ingest rounds run none, and it runs one at its end)."""
    c = sum(launches[name] for name in C_FORMS)
    for name, n, per in (("anyactive", launches["anyactive"], rounds),
                         ("histogram", launches["histogram"], rounds),
                         ("kernel C", c, stats_steps)):
        check(per > 0 and n >= per, f"{what}: {n} {name} launches for {rounds} rounds, "
                                    f"{stats_steps} statistics steps")


def _meets_guarantee1(ids, truth, eps: float, k: int) -> bool:
    """Every true top-k candidate left out is within ``eps`` of the worst
    one returned (Guarantee 1)."""
    import numpy as np

    true_top = set(np.argsort(truth, kind="stable")[:k].tolist())
    worst = max(float(truth[j]) for j in ids)
    return all(worst - float(truth[j]) < eps for j in true_top - set(ids.tolist()))


def _workload_truth(torch, ctx) -> tuple:
    """Phase 5's targets, their queries' eps by request id, and every
    target's exact tau (kernel C's plain version over Scan's counts)."""
    import numpy as np

    from repro_torch.kernels import metrics

    topk, close, _ = ctx["workload"]
    q_hats = np.stack([tg / tg.sum() for tg in topk + close]).astype(np.float32)
    truth = metrics.distance_multi_ref(
        ctx["counts"], torch.from_numpy(q_hats).to(ctx["counts"].device)
    ).cpu().numpy().astype(np.float64)
    eps = {rid: (0.12 if rid < len(topk) else 0.10) for rid in range(len(topk) + len(close))}
    return truth, eps


def _phase8_chaos(torch, ctx) -> dict:
    """8a: phase 5's workload through `maybe_chaos`: bitwise phase 5."""
    import numpy as np

    from repro_torch.io import maybe_chaos

    topk, close, stop_tuples = ctx["workload"]
    base = ctx["served"]
    _, eps = _workload_truth(torch, ctx)
    chaos = maybe_chaos(ctx["source"], env={"FASTMATCH_CHAOS": "1", "FASTMATCH_CHAOS_SEED": "0"})
    _reset_launches()
    with _StatsProbe() as probe:
        run = _serve_taxi(torch, chaos, topk, close, stop_tuples)
    launches = _launch_counts()
    server, sched = run["server"], run["server"].scheduler
    _check_per_round(launches, sched.rounds, probe.stats_steps, "8a")
    check(run["topk"] + run["close"] == list(base), "8a served other requests than phase 5")
    for rid, want in base.items():
        got = server.results[rid]
        check(np.array_equal(got.ids, want.ids), f"8a request {rid}: ids differ from phase 5")
        for f in ("rounds", "tuples_read", "exact", "stopped"):
            check(getattr(got, f) == getattr(want, f),
                  f"8a request {rid}: {f} {getattr(got, f)} vs phase 5's {getattr(want, f)}")
        check(torch.equal(got.state.tau, want.state.tau),
              f"8a request {rid}: tau is not bitwise phase 5's")
        check(not got.degraded and got.eps_effective == eps[rid],
              f"8a request {rid}: degraded={got.degraded}, eps_effective {got.eps_effective}")
    check(chaos.retries_total > 0, "8a: the chaos source retried nothing")
    out = dict(wall_s=run["wall_s"], rounds=sched.rounds, retries=chaos.retries_total,
               injected=chaos.inner.injector.injected, attempts=chaos.inner.injector.attempts,
               launches=launches, bitwise_phase5=True)
    log(f"8a chaos: {out}")
    return out


class _RetireProbe:
    """Records, at every retirement while installed, the quarantine the
    scheduler then knew and what the outcome reports (8b's check)."""

    def __init__(self):
        from repro_torch.core.multiquery import SharedCountsScheduler

        self.cls, self._retire, self.rows = SharedCountsScheduler, SharedCountsScheduler.retire, []

    def __enter__(self):
        probe = self

        def retire(sched, slot, **kw):
            eps = sched.tickets[slot].eps
            bq, tq = sched.blocks_quarantined, sched.tuples_quarantined
            out = probe._retire(sched, slot, **kw)
            want = eps + (2.0 * (tq / sched.total_tuples) if bq else 0.0)
            probe.rows.append(dict(eps=eps, blocks_quarantined=bq, tuples_quarantined=tq,
                                   degraded=out.degraded, eps_effective=out.eps_effective,
                                   expected=want))
            return out

        self.cls.retire = retire
        return self

    def __exit__(self, *exc):
        self.cls.retire = self._retire


def _phase8_quarantine(torch, ctx, expect_quarantine) -> dict:
    """8b: corruption quarantines and degrades honestly; nothing
    quarantined reaches ingest; telemetry counts it."""
    import numpy as np

    from repro_torch.io import FaultPlan, FaultySource, ResilientSource
    from repro_torch.obs import Telemetry

    topk, close, stop_tuples = ctx["workload"]
    truth, eps = _workload_truth(torch, ctx)
    source = ctx["source"]
    tel = Telemetry(device=source.device)
    res_src = ResilientSource(FaultySource(source, FaultPlan(p_corrupt=0.02, p_truncate=0.02),
                                           seed=5), telemetry=tel)
    _reset_launches()
    with _RetireProbe() as probe, _StatsProbe() as stats:
        run = _serve_taxi(torch, res_src, topk, close, stop_tuples, telemetry=tel)
    launches = _launch_counts()
    server, sched = run["server"], run["server"].scheduler
    _check_per_round(launches, sched.rounds, stats.stats_steps, "8b")
    # telemetry: the scheduler's and the source's quarantine counts
    reg = tel.registry
    events = tel.tracer.events("window_quarantine")
    quarantine_telemetry = dict(
        blocks_quarantined_total=reg.get("fastmatch_blocks_quarantined_total").value,
        io_blocks_quarantined_total=reg.get("io_blocks_quarantined_total").value,
        window_quarantine_events=len(events),
        blocks_quarantine_events=len(tel.tracer.events("blocks_quarantine")),
        io_validation_failures_total=reg.get("io_validation_failures_total").value)
    check(quarantine_telemetry["blocks_quarantined_total"] == sched.blocks_quarantined
          and quarantine_telemetry["io_blocks_quarantined_total"] == res_src.blocks_quarantined
          and len(events) == res_src.windows_quarantined
          and sum(e["blocks"] for e in events) == res_src.blocks_quarantined,
          f"8b: telemetry counted {quarantine_telemetry}, the sources "
          f"{sched.blocks_quarantined} / {res_src.windows_quarantined} windows")
    if expect_quarantine is not None:
        check((quarantine_telemetry["blocks_quarantined_total"], len(events))
              == expect_quarantine, f"8b: telemetry {quarantine_telemetry}, not {expect_quarantine}")
    q = sched.tuples_quarantined / sched.total_tuples
    check(sched.blocks_quarantined > 0 and res_src.validation_failures > 0,
          f"8b quarantined {sched.blocks_quarantined} blocks")
    check(probe.rows and all(r["degraded"] == (r["blocks_quarantined"] > 0)
                             and r["eps_effective"] == r["expected"] for r in probe.rows),
          f"8b: an outcome's eps_effective is not eps + 2q at its retirement: {probe.rows}")
    check(any(r["degraded"] for r in probe.rows), "8b: no outcome saw the quarantine")
    # no quarantined tuple reached ingest: the counts are exactly the
    # histogram of the blocks the read mask marks (torch.bincount: the
    # check's oracle)
    v_z, v_x = source.v_z, source.v_x
    read = torch.nonzero(sched.cursor.read_mask).squeeze(1)
    z, x = source._z[read].reshape(-1), source._x[read].reshape(-1)
    keep = z >= 0
    hist = torch.bincount(z[keep].long() * v_x + x[keep].long(), minlength=v_z * v_x)
    hist = hist.to(torch.float32).reshape(v_z, v_x)
    check(torch.equal(hist, sched.state.counts),
          "8b: the counts are not the read blocks' histogram")
    check(torch.equal(hist.sum(dim=1), sched.state.n), "8b: n is not the read blocks' row sums")
    check(not (sched.read_mask & sched.quarantined).any(), "8b: a quarantined block was read")
    answers = []
    for i, rid in enumerate(run["topk"] + run["close"]):
        res = server.results[rid]
        d, e = truth[i], res.eps_effective
        if rid in run["topk"]:
            ok = _meets_guarantee1(res.ids, d, e, 10)
            check(ok or res.stopped, f"8b top-k request {rid} misses Guarantee 1 at {e}")
        else:
            infl = e - eps[rid]
            got = set(res.ids.tolist())
            ok = (set(np.flatnonzero(d <= eps[rid] - infl).tolist()) <= got
                  and got.isdisjoint(np.flatnonzero(d >= eps[rid] + 0.20 + infl).tolist()))
            check(ok, f"8b closeness request {rid} is wrong outside its widened gap")
        answers.append(dict(rid=rid, degraded=res.degraded, eps_effective=e, correct=ok,
                            stopped=res.stopped, rounds=res.rounds, tuples=res.tuples_read))
    out = dict(wall_s=run["wall_s"], rounds=sched.rounds, blocks_read=sched.blocks_read,
               blocks_quarantined=sched.blocks_quarantined,
               tuples_quarantined=sched.tuples_quarantined, q=q,
               eps_inflation=sched.eps_inflation, injected=res_src.inner.injector.injected,
               validation_failures=res_src.validation_failures,
               degraded_outcomes=sum(r["degraded"] for r in probe.rows),
               outcomes=len(probe.rows), counts_are_read_histogram=True, answers=answers,
               launches=launches, telemetry=quarantine_telemetry)
    log(f"8b quarantine: {({k: v for k, v in out.items() if k != 'answers'})}")
    return out


class _SaveProbe:
    """Times every `CheckpointManager.save` while installed, with the
    bytes its step dir holds."""

    def __init__(self):
        from repro_torch.checkpoint import CheckpointManager

        self.cls, self._save, self.saves = CheckpointManager, CheckpointManager.save, []

    def __enter__(self):
        probe = self

        def save(manager, state, step):
            t = time.perf_counter()
            path = probe._save(manager, state, step)
            wall = time.perf_counter() - t
            probe.saves.append(dict(step=step, ms=wall * 1e3,
                                    bytes=sum(f.stat().st_size for f in path.iterdir())))
            return path

        self.cls.save = save
        return self

    def __exit__(self, *exc):
        self.cls.save = self._save


def _phase8_recovery(torch, ctx, tmp: Path) -> dict:
    """8c: a supervisor crashed halfway restores its snapshot and answers
    every request; no device memory leaks from the wounded server."""
    import numpy as np

    from repro_torch.io import FaultPlan, FaultySource
    from repro_torch.serve import MatchServer, ServeSupervisor

    source = ctx["source"]
    topk, _, _ = ctx["workload"]
    truth, _ = _workload_truth(torch, ctx)
    k, eps, delta = 10, 0.12, 0.01
    kw = dict(max_queries=8, lookahead=512, metric="l1", autosave_every=2)

    def supervise(crash_at, directory, telemetry=None):
        sup = ServeSupervisor(FaultySource(source, FaultPlan(crash_at=crash_at)),
                              checkpoint_dir=str(directory), telemetry=telemetry, **kw)
        return sup, [sup.submit(tg, k=k, eps=eps, delta=delta) for tg in topk]

    # the run that never crashes places the crash halfway through its rounds
    clean, clean_rids = supervise(None, tmp / "clean")
    clean_res = clean.run_until_idle()
    clean_rounds = clean.server.scheduler.rounds
    second = sorted(clean_res[r].rounds for r in clean_rids)[1]
    crash_at = 1 + max(clean_rounds // 2, second + 1)  # attempt 0: the config-hash probe
    del clean

    sup, rids = supervise(crash_at, tmp / "crash", telemetry=True)
    mem = {}
    restored = {}
    build, recover = sup._build_server, sup._recover

    def build_server():
        server = build()
        manager, sched = server._manager, server.scheduler
        step = manager.latest_step()
        check(step is not None, "8c: no snapshot was on disk at the crash")
        files = [np.load(manager.dir / f"step_{step}" / f"arr_{i}.npy") for i in range(9)]
        snap = sched.export_cache()
        for f, want in zip(snap._fields, files):
            got = getattr(snap, f).cpu().numpy()
            check(np.array_equal(got, want.astype(got.dtype)) and want.shape == got.shape,
                  f"8c: the restored {f} is not the snapshot's file")
        restored.update(step=step, rounds=sched.rounds, tuples=sched.tuples_read)
        return server

    def recover_server(exc):
        recover(exc)
        torch.cuda.synchronize()
        mem["after_recovery"] = torch.cuda.memory_allocated()

    sup._build_server, sup._recover = build_server, recover_server
    # the device memory with the wounded server still live: read at the
    # fetch that crashes
    faulty = sup._dataset
    fetch = faulty.fetch

    def fetch_and_measure(win, pad_to=None):
        if faulty.injector.attempts == crash_at:
            torch.cuda.synchronize()
            mem["live"] = torch.cuda.memory_allocated()
        return fetch(win, pad_to)

    faulty.fetch = fetch_and_measure
    _reset_launches()
    t = time.perf_counter()
    with _SaveProbe() as saves, _StatsProbe() as stats:
        results = sup.run_until_idle()
        sup.server.save_cache()  # at shutdown, so the restore below sees every read
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = _launch_counts()
    sched = sup.server.scheduler
    _check_per_round(launches, sched.rounds, stats.stats_steps, "8c")
    check(sup.restarts == 1 and "UnrecoverableIOError" in sup.last_error,
          f"8c: {sup.restarts} restarts, last error {sup.last_error!r}")
    check(sup.unresolved == 0 and sorted(results) == sorted(rids), "8c: a request went unanswered")
    for i, rid in enumerate(rids):
        check(_meets_guarantee1(results[rid].ids, truth[i], eps, k),
              f"8c request {rid} misses Guarantee 1")
    leak = mem["after_recovery"] - mem["live"]
    check(abs(leak) <= 8 << 20, f"8c: device memory moved {leak} bytes across the recovery")
    same_ids = all(np.array_equal(results[r].ids, clean_res[c].ids)
                   for r, c in zip(rids, clean_rids))
    reg = sup.telemetry.registry
    recovery_telemetry = {name: reg.get(name).value for name in (
        "serve_crashes_total", "serve_recoveries_total", "checkpoint_saves_total",
        "checkpoint_save_bytes_total", "fastmatch_queries_retired_total")}
    recovery_telemetry.update(
        serve_crash_events=len(sup.telemetry.tracer.events("serve_crash")),
        serve_recovered_events=len(sup.telemetry.tracer.events("serve_recovered")),
        checkpoint_save_events=len(sup.telemetry.tracer.events("checkpoint_save")))
    check(recovery_telemetry["serve_crashes_total"] == recovery_telemetry["serve_recoveries_total"]
          == recovery_telemetry["serve_crash_events"] == 1
          and recovery_telemetry["checkpoint_saves_total"] == len(saves.saves)
          == recovery_telemetry["checkpoint_save_events"],
          f"8c: telemetry {recovery_telemetry}, {len(saves.saves)} saves counted")

    # warm construction on the same files, no crash plan: the query that
    # retired last did so on the counts saved at shutdown, so its
    # re-submission is covered by the cache and reads nothing new
    last = list(results)[-1]
    t = time.perf_counter()
    warm = MatchServer.restore(source, checkpoint_dir=str(tmp / "crash"), max_queries=8,
                               lookahead=512, metric="l1")
    restore_ms = (time.perf_counter() - t) * 1e3
    warm_rid = warm.submit(topk[rids.index(last)], k=k, eps=eps, delta=delta)
    warm_res = warm.run_until_idle()[warm_rid]
    check(warm_res.tuples_read == 0, f"8c: the covered re-submission read {warm_res.tuples_read}")
    out = dict(wall_s=wall, crash_at=crash_at, clean_rounds=clean_rounds, rounds=sched.rounds,
               restarts=sup.restarts, recovery_ms=sup.recovery_s_total * 1e3,
               restored=restored, saves=saves.saves, restore_ms=restore_ms,
               memory_live_bytes=mem["live"], memory_after_recovery_bytes=mem["after_recovery"],
               memory_moved_bytes=leak, ids_equal_uncrashed=same_ids,
               warm_resubmit_tuples=warm_res.tuples_read, launches=launches,
               telemetry=recovery_telemetry)
    log(f"8c recovery: {out}")
    return out


def _prefetch_threads() -> list:
    import threading

    return [t for t in threading.enumerate() if t.name == "block-prefetch" and t.is_alive()]


def _phase8_prefetch(torch, ctx, expect) -> dict:
    """8d: phase 4's FastMatch query from host memory without and with
    prefetch, then from the resident table with prefetch: bitwise the
    same three times."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine
    from repro_torch.io import InMemorySource

    host = InMemorySource(ctx["blocked"], device_resident=False, device=ctx["source"].device)
    base = ctx["fastmatch"]
    runs = {}
    for name, source, prefetch in (("host", host, False), ("host_prefetch", host, True),
                                   ("resident_prefetch", ctx["source"], True)):
        cfg = dataclasses.replace(ctx["cfg"], prefetch=prefetch)
        # a first run pays the one-time costs (pinned host buffers, the
        # side stream), so the timed run is the second
        warm = engine.run_engine(source, ctx["target"], ctx["params"], cfg)
        check(np.array_equal(warm.ids, base.ids), f"8d {name}: the warm-up run differs")
        _reset_launches()
        with _StatsProbe() as stats:
            t = time.perf_counter()
            res = engine.run_engine(source, ctx["target"], ctx["params"], cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches = _launch_counts()
        _check_per_round(launches, res.rounds, stats.stats_steps, f"8d {name}")
        check(np.array_equal(res.ids, base.ids) and torch.equal(res.state.tau, base.state.tau)
              and (res.rounds, res.blocks_read) == (base.rounds, base.blocks_read),
              f"8d {name}: {res.rounds} rounds, {res.blocks_read} blocks, not phase 4's answer")
        if expect is not None:
            check((res.rounds, res.blocks_read) == expect, f"8d {name}: not {expect}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            again = engine.run_engine(source, ctx["target"], ctx["params"], cfg)
            torch.cuda.synchronize()
        check(np.array_equal(again.ids, res.ids), f"8d {name}: a repeated run differs")
        device_ms, by_kernel, _ = _profile_tables(torch, prof)
        runs[name] = dict(wall_ms=wall * 1e3, rounds=res.rounds, blocks_read=res.blocks_read,
                          device_ms=device_ms, device_busy_share=device_ms / (wall * 1e3),
                          copies=[dict(name=n, ms=ms, calls=c) for n, ms, c in by_kernel
                                  if n.startswith("Memcpy")],
                          launches=launches)
        log(f"8d {name}: {wall * 1e3:.1f} ms, {res.rounds} rounds, device {device_ms:.2f} ms")
    check(not _prefetch_threads(), "8d: a prefetch worker is still alive")
    return dict(runs=runs, bitwise_equal=True, threads_alive=0)


def phase_faults(torch, ctx, *, expect, expect_quarantine) -> dict:
    """Phase 8 (see the module docstring)."""
    import tempfile

    report = {}
    for name, fn in (("chaos", lambda: _phase8_chaos(torch, ctx)),
                     ("quarantine", lambda: _phase8_quarantine(torch, ctx, expect_quarantine))):
        t = time.perf_counter()
        report[name] = fn()
        report[name]["phase_s"] = time.perf_counter() - t
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t = time.perf_counter()
        report["recovery"] = _phase8_recovery(torch, ctx, Path(tmp))
        report["recovery"]["phase_s"] = time.perf_counter() - t
    t = time.perf_counter()
    report["prefetch"] = _phase8_prefetch(torch, ctx, expect)
    report["prefetch"]["phase_s"] = time.perf_counter() - t
    emit({"check": "faults", **report})
    return report


# ---------------------------------------------------------------------------
# phase 9: telemetry on phase 4's resident table
# ---------------------------------------------------------------------------


class _CostAccount:
    """The host time spent inside every telemetry entry point while
    installed, reentrancy-guarded so that nested entry points count once
    (the reference's accounting, benchmarks/telemetry_overhead.py). Every
    wrapped entry point runs on the serving loop's thread."""

    def __init__(self):
        from repro_torch.core import multiquery as mq
        from repro_torch.obs import registry, telemetry, tracer

        self.sites = ((mq.SharedCountsScheduler, "_record_poll"),
                      (mq.SharedCountsScheduler, "flush_telemetry"),
                      (mq.SharedCountsScheduler, "_emit_round_batch"),
                      (tracer.Tracer, "emit"), (registry.Counter, "inc"),
                      (registry.Gauge, "set"), (registry.Histogram, "observe"),
                      (registry.Histogram, "observe_many"),
                      (telemetry.Telemetry, "record_curve_point"))
        self.total_s, self.by_site, self._depth, self._saved = 0.0, {}, 0, []

    def _wrap(self, fn, site: str):
        def timed(*args, **kwargs):
            if self._depth:
                return fn(*args, **kwargs)
            self._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                self.total_s += dt
                self.by_site[site] = self.by_site.get(site, 0.0) + dt
                self._depth -= 1

        return timed

    def __enter__(self):
        for cls, name in self.sites:
            fn = getattr(cls, name)
            self._saved.append((cls, name, fn))
            setattr(cls, name, self._wrap(fn, f"{cls.__name__}.{name}"))
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)
        self._saved.clear()


def _timer_residual_s() -> float:
    """What the wrappers cannot see, a window: the bare `perf_counter`
    pairs of the gather, dispatch and sync timing and the accumulator
    adds, charged as 8 timer calls and 3 list appends (rounded up, as the
    reference charges them), measured here."""
    sink: list = []
    reps = 20_000
    t0 = time.perf_counter()
    for _ in range(reps):
        for _ in range(8):
            time.perf_counter()
        sink.append(0.0)
        sink.append(0.0)
        sink.append(0.0)
        if len(sink) >= 30_000:
            sink.clear()
    return (time.perf_counter() - t0) / reps


def _prometheus_values(text: str) -> dict:
    """{sample name with labels: value} of a Prometheus text body."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def _check_against_phase5(torch, run, ctx, launches, what: str) -> None:
    """A serving run of phase 5's workload is bitwise phase 5: every
    request's answer, the polls, the exported cache and the launches."""
    import numpy as np

    p5, base = ctx["phase5"], ctx["served"]
    server, sched = run["server"], run["server"].scheduler
    check(run["topk"] + run["close"] == list(base), f"{what} served other requests than phase 5")
    for rid, want in base.items():
        got = server.results[rid]
        check(np.array_equal(got.ids, want.ids), f"{what} request {rid}: ids differ from phase 5")
        for f in ("rounds", "tuples_read", "exact", "stopped"):
            check(getattr(got, f) == getattr(want, f),
                  f"{what} request {rid}: {f} {getattr(got, f)} vs phase 5's {getattr(want, f)}")
        check(torch.equal(got.state.tau, want.state.tau),
              f"{what} request {rid}: tau is not bitwise phase 5's")
    for f in ("host_syncs", "loop_syncs", "rounds"):
        check(getattr(sched, f) == p5[f], f"{what}: {f} {getattr(sched, f)} vs phase 5's {p5[f]}")
    for f, got, want in zip(sched.export_cache()._fields, sched.export_cache(), p5["cache"]):
        check(torch.equal(got, want), f"{what}: the exported {f} is not bitwise phase 5's")
    check(launches == p5["launches"], f"{what}: launches {launches} vs phase 5's {p5['launches']}")


def phase_telemetry(torch, timer, ctx) -> dict:
    """Phase 9 (see the module docstring)."""
    import contextlib
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import multiquery as mq
    from repro_torch.kernels import histogram, ref

    topk, close, stop_tuples = ctx["workload"]
    source = ctx["source"]
    t_phase = time.perf_counter()
    runs = []
    # off and on in turns, three each; the last on run is the accounted one
    for i, on in enumerate((False, True) * 3):
        accounted = i == 5
        _reset_launches()
        with _CostAccount() if accounted else contextlib.nullcontext() as acct:
            run = _serve_taxi(torch, source, topk, close, stop_tuples,
                              telemetry=True if on else None)
        launches = _launch_counts()
        what = f"9 ({'on' if on else 'off'} run {i // 2 + 1})"
        _check_against_phase5(torch, run, ctx, launches, what)
        check((run["server"].telemetry is not None) == on, f"{what}: telemetry is not {on}")
        runs.append(dict(on=on, wall_s=run["wall_s"], accounted=accounted, server=run["server"],
                         account=acct, launches=launches))
    off_walls = [r["wall_s"] for r in runs if not r["on"]]
    on_runs = [r for r in runs if r["on"]]
    on_walls = [r["wall_s"] for r in on_runs if not r["accounted"]]

    # the registry against the scheduler, the curves against Theorem 1, the
    # skeletons of the on runs against each other
    skeletons, splits = [], []
    for r in on_runs:
        server = r["server"]
        tel, sched = server.telemetry, server.scheduler
        reg = tel.registry
        mirrors = {"fastmatch_rounds_total": sched.rounds,
                   "fastmatch_tuples_read_total": sched.tuples_read,
                   "fastmatch_blocks_read_total": sched.blocks_read,
                   "fastmatch_host_syncs_total": sched.host_syncs,
                   "fastmatch_passes_total": sched.passes,
                   "fastmatch_queries_submitted_total": 12,
                   "fastmatch_queries_admitted_total": 12,
                   "fastmatch_queries_retired_total": 12}
        sched.flush_telemetry()
        for name, want in mirrors.items():
            check(reg.get(name).value == want, f"9: {name} {reg.get(name).value} vs {want}")
        deltas = {e["qid"]: e["delta"] for e in tel.tracer.events("query_admit")}
        check(sorted(deltas) == tel.query_ids() and len(deltas) == 12,
              f"9: curves for {tel.query_ids()}, admissions {sorted(deltas)}")
        for qid in tel.query_ids():
            traj = tel.trajectory(qid)
            check(bool(traj) and all(
                p["eps_n"] == mq._metric_eps_np(p["n_min"], deltas[qid] / source.v_z, source.v_x,
                                                "l1") for p in traj),
                f"9: query {qid}'s eps_n is not Theorem 1 at its n_min")
        skeletons.append(tel.tracer.skeleton())
        batches = tel.tracer.events("round_batch")
        splits.append(dict(
            windows=sum(e["windows"] for e in batches), batches=len(batches),
            gather_ms=sum(e["gather_s"] for e in batches) * 1e3,
            dispatch_ms=sum(e["dispatch_s"] for e in batches) * 1e3,
            sync_ms=sum(e["sync_s"] for e in batches) * 1e3, wall_ms=r["wall_s"] * 1e3))
    check(all(sk == skeletons[0] for sk in skeletons[1:]), "9: the on runs' skeletons differ")

    # the accounted telemetry host time, as a share of the off walls
    acct = on_runs[-1]["account"]
    per_window_s = _timer_residual_s()
    timers_s = splits[-1]["windows"] * per_window_s
    accounted_s = acct.total_s + timers_s
    off_ms = statistics.median(off_walls) * 1e3

    # a profiled on run: the PyTorch launches a round of phase 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = _serve_taxi(torch, source, topk, close, stop_tuples, telemetry=True)
    rounds = again["server"].scheduler.rounds
    device_ms, by_kernel, by_host_op = _profile_tables(torch, prof)
    host_launches = sum(c for name, _, c in by_host_op if name.startswith("cudaLaunch"))
    device_kernels = sum(c for name, _, c in by_kernel if not name.startswith(("Memcpy", "Memset")))
    check(host_launches / rounds == ctx["phase5"]["host_launches_per_round"],
          f"9: {host_launches / rounds} PyTorch launches a round with telemetry on, phase 5 "
          f"{ctx['phase5']['host_launches_per_round']}")

    # the exports round-trip (a registry read: kernel B bins, counted
    # apart from the serving runs above)
    server = on_runs[0]["server"]
    tel = server.telemetry
    metrics = {name: tel.registry.get(name) for name in tel.registry.names()}
    hists = {name: m for name, m in metrics.items() if m.kind == "histogram"}
    pending = {name: np.asarray(m._pending, np.float64) for name, m in hists.items()}
    _reset_launches()
    t = time.perf_counter()
    prom = server.prometheus_metrics()
    torch.cuda.synchronize()
    read_ms = (time.perf_counter() - t) * 1e3
    registry_launches = _launch_counts()["histogram"]
    registry_forms = _form_launches()
    nonempty = [name for name, v in pending.items() if v.size]
    check(registry_launches == len(nonempty),
          f"9: the registry read launched kernel B {registry_launches} times for {nonempty}")
    check(registry_forms == {"global": 0, "private": len(nonempty)},
          f"9: the registry read's kernel B forms {registry_forms}")
    snap = tel.registry.snapshot()
    for name, vals in pending.items():
        edges = hists[name].edges
        ids = np.searchsorted(edges, vals, side="left")
        want = np.bincount(ids, minlength=len(edges) + 1)
        check(snap[name]["buckets"] == want.tolist(),
              f"9: {name} binned {snap[name]['buckets']}, the plain count {want.tolist()}")
    parsed = _prometheus_values(prom)
    for name, m in snap.items():
        if m["kind"] == "histogram":
            cum = np.cumsum(m["buckets"])[:-1]
            check([parsed[f'{name}_bucket{{le="{le}"}}'] for le in
                   [_le(e) for e in m["edges"]]] == cum.tolist()
                  and parsed[f"{name}_count"] == m["count"], f"9: {name} does not round-trip")
        else:
            check(parsed[name] == m["value"], f"9: {name} does not round-trip")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = Path(tmp) / "trace.jsonl"
        n_events = server.export_trace(path)
        back = [json.loads(line) for line in path.read_text().splitlines()]
    check(n_events == len(back) and back == json.loads(json.dumps(tel.tracer.events())),
          "9: the exported trace does not round-trip")

    # kernel B at the registry's shape: the round-batch histogram's samples
    name = "fastmatch_round_batch_seconds"
    edges = hists[name].edges
    vals = pending[name]
    x = torch.from_numpy(np.searchsorted(edges, vals, side="left").astype(np.int32)).cuda()
    z = torch.zeros_like(x)
    v_x = len(edges) + 1
    check(torch.equal(histogram.histogram(z, x, v_z=1, v_x=v_x),
                      ref.histogram_ref(z, x, v_z=1, v_x=v_x)),
          "9: kernel B at the registry's shape differs from its plain version")
    # the registry's z-less call, timed in its form and in each form
    # pinned, beside the old call with zero z ids
    registry_kernel = _kernel_b_row(torch, timer, None, x, 1, v_x, ingest=False)
    registry_kernel["zeros_ms"], _ = timer(lambda: histogram.histogram(z, x, v_z=1, v_x=v_x))
    b_ms = registry_kernel["ms"]
    flush_h = type(hists[name])(name, edges, device=source.device)
    flush_h.observe_many(vals)
    t = time.perf_counter()
    flush_h.bucket_counts()
    flush_us = (time.perf_counter() - t) * 1e6

    out = dict(
        off_walls_ms=[w * 1e3 for w in off_walls], on_walls_ms=[w * 1e3 for w in on_walls],
        accounted_run_wall_ms=on_runs[-1]["wall_s"] * 1e3,
        phase5_wall_ms=ctx["phase5"]["wall_s"] * 1e3,
        accounted_ms=accounted_s * 1e3, accounted_hooks_ms=acct.total_s * 1e3,
        accounted_timers_ms=timers_s * 1e3, timer_residual_us_per_window=per_window_s * 1e6,
        accounted_share_of_off_wall=accounted_s * 1e3 / off_ms,
        accounted_by_site_ms={k: v * 1e3 for k, v in sorted(acct.by_site.items())},
        round_batch=splits, rounds=rounds, host_syncs=ctx["phase5"]["host_syncs"],
        loop_syncs=ctx["phase5"]["loop_syncs"],
        host_launches_per_round=host_launches / rounds,
        device_kernels_per_round=device_kernels / rounds, profiled_device_ms=device_ms,
        profiled_wall_ms=again["wall_s"] * 1e3,
        trace_events=len(skeletons[0]), curve_points=sum(
            len(tel.trajectory(q)) for q in tel.query_ids()),
        registry_read=dict(launches=registry_launches, forms=registry_forms,
                           histograms=nonempty, ms=read_ms, flush_us=flush_us,
                           samples=int(vals.size)),
        registry_kernel=registry_kernel,
        bitwise_phase5=True, launches=on_runs[0]["launches"],
    )
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"9 telemetry: off {out['off_walls_ms']} ms, on {out['on_walls_ms']} ms, accounted "
        f"{out['accounted_ms']:.3f} ms ({out['accounted_share_of_off_wall']:.2%}); "
        f"round_batch {splits[0]}; registry read {registry_launches} B launches, kernel B at "
        f"(1, {v_x}) {b_ms * 1e3:.2f} us z-less, {registry_kernel['zeros_ms'] * 1e3:.2f} with "
        f"zero z ids, global form {registry_kernel['global_ms'] * 1e3:.2f}; "
        f"{out['phase_s']:.1f}s")
    emit({"check": "telemetry", **out})
    return out


# ---------------------------------------------------------------------------
# phase 10: the mesh and the data-parallel pump on phase 4's resident table
# ---------------------------------------------------------------------------

MESH_RANKS = 4
LOCKSTEP_ROUNDS = 12
LOCKSTEP_ORDER_SEED = 10  # 10a's shuffled global windows


def _digest(*arrays) -> str:
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _lockstep_targets(ctx):
    """10a's four queries: phase 5's first top-k targets; the first stops
    after ~2 windows of tuples (a retirement inside the 12 rounds), the
    fourth is admitted at round 3."""
    topk, _, _ = ctx["workload"]
    return [topk[0], topk[1], topk[2], topk[3]]


def _lockstep(sched, targets, order, window: int, full_counts) -> list:
    """Drive ``sched`` through 10a's rounds; one record a round."""
    from repro_torch.core.multiquery import StopPolicy

    k, eps, delta = 10, 0.12, 0.01
    sched.admit(targets[0], k=k, eps=eps, delta=delta,
                stop=StopPolicy(tuples=2 * window * 512))
    for tg in targets[1:3]:
        sched.admit(tg, k=k, eps=eps, delta=delta)
    records = []
    for r in range(LOCKSTEP_ROUNDS):
        if r == 3:
            sched.admit(targets[3], k=k, eps=0.2, delta=delta)
        sched.run_window(order[r * window : (r + 1) * window])
        sched._poll_terminated()
        counts, n = full_counts()
        st = sched.state
        records.append(dict(
            counts=_digest(counts.cpu().numpy()), n=_digest(n.cpu().numpy()),
            tau=st.tau.cpu().numpy(), du=st.delta_upper.cpu().numpy(),
            eps_i=st.eps_i.cpu().numpy(), n_full=n.cpu().numpy(),
            mask=_digest(sched.read_mask),
            counters=[sched.rounds, sched.blocks_read, sched.blocks_considered,
                      sched.tuples_read],
            live=sorted(sched.tickets), retired=sorted(sched.outcomes)))
    return records


def _mesh_rank(rank, world, shared, meta):
    """One gloo rank of phase 10 on the card: 10a's lockstep at 2 x 2, 10b's
    query at 4 x 1, 10c's serving at 2 x 2. Rank 0 returns the records;
    every rank its launches and collective time per sub-phase."""
    import numpy as np
    import torch

    from repro_torch.core import distributed
    from repro_torch.core.multiquery import MultiQuerySpec
    from repro_torch.core.pump import DistributedPump
    from repro_torch.data.layout import BlockedDataset
    from repro_torch.serve import MatchServer

    entered_at = time.time()  # the wall clock, comparable with the parent's
    t_start = time.perf_counter()
    blocked = BlockedDataset(shared["z"].numpy(), shared["x"].numpy(),
                             shared["bitmap"].numpy().view(np.uint32), meta["v_z"], meta["v_x"])
    order = np.random.default_rng(LOCKSTEP_ORDER_SEED).permutation(blocked.num_blocks)
    mesh22 = distributed.init_mesh((2, 2), device_type="cuda")
    mesh41 = distributed.init_mesh((4, 1), device_type="cuda")
    out = dict(rank=rank, entered_at=entered_at, attach_s=time.perf_counter() - t_start,
               startup=dict(imported=T0_WALL, **distributed.RANK_STARTUP))

    def measured(name, fn):
        _reset_launches()
        c0 = dict(distributed.COLLECTIVES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[name] = dict(
            wall_s=time.perf_counter() - t, launches=_launch_counts(),
            collective_calls=distributed.COLLECTIVES["calls"] - c0["calls"],
            collective_s=distributed.COLLECTIVES["seconds"] - c0["seconds"],
            collective_bytes=distributed.COLLECTIVES["bytes"] - c0["bytes"])
        return result

    # -- 10a: the lockstep golden at 2 x 2
    spec = MultiQuerySpec(v_z=meta["v_z"], v_x=meta["v_x"], max_queries=4)
    pmp = DistributedPump(blocked, spec, mesh=mesh22, window=512, seed=0, start_block=0)
    records = measured("lockstep", lambda: _lockstep(pmp, meta["lockstep_targets"], order, 512,
                                                     pmp._full_counts))
    out["lockstep"].update(rounds=pmp.rounds, plans=dataclasses.asdict(pmp.plans),
                           stats_steps=LOCKSTEP_ROUNDS + 4)
    if rank == 0:
        out["lockstep_records"] = records
    del pmp
    torch.cuda.empty_cache()

    # -- 10b: phase 4's query through a 4 x 1 pump server, telemetry on
    t = time.perf_counter()
    srv = MatchServer(blocked, mesh=mesh41, pump=True, max_queries=1, k_cap=10,
                      lookahead=512, seed=meta["seed"], telemetry=True)
    construct_s = time.perf_counter() - t

    def query():
        rid = srv.submit(meta["target"], k=10, eps=0.12, delta=0.01)
        return srv.run_until_idle()[rid]

    res = measured("query", query)
    sched = srv.scheduler
    gathers = [e["worker_gather_s"] for e in srv.telemetry.tracer.events("round_batch")]
    out["query"].update(
        rounds=sched.rounds, passes=sched.passes, host_syncs=sched.host_syncs,
        worker_gather_s=np.sum(gathers, axis=0).tolist(), shard_blocks=sched.shard.num_blocks,
        construct_s=construct_s)
    if rank == 0:
        counts, n = sched._full_counts()
        out["query_result"] = dict(
            ids=np.asarray(res.ids), rounds=res.rounds, passes=res.passes,
            blocks_read=res.blocks_read, tuples_read=res.tuples_read, exact=res.exact,
            delta_upper=res.delta_upper, counts=counts.cpu().numpy(), n=n.cpu().numpy(),
            read_mask=np.array(sched.read_mask))
    del srv, sched, res
    torch.cuda.empty_cache()

    # -- 10c: phase 5's workload through a 2 x 2 pump server
    topk, close, stop_tuples = meta["workload"]
    t = time.perf_counter()
    server = MatchServer(blocked, max_queries=8, lookahead=512, metric="l1", mesh=mesh22,
                         pump=True)
    construct_s = time.perf_counter() - t
    run = measured("serving", lambda: _serve_taxi(torch, blocked, topk, close, stop_tuples,
                                                  server=server))
    server, sched = run["server"], run["server"].scheduler
    out["serving"].update(rounds=sched.rounds, host_syncs=sched.host_syncs,
                          tuples=sched.tuples_read, served_wall_s=run["wall_s"],
                          construct_s=construct_s)
    if rank == 0:
        results = server.results
        blocking = results[run["close"][0]]
        final = run["stream"][-1]
        out["serving_results"] = dict(
            topk=[dict(ids=np.asarray(results[r].ids), stopped=results[r].stopped,
                       stop_reason=results[r].stop_reason, exact=results[r].exact,
                       tuples=results[r].tuples_read, qtype=results[r].qtype)
                  for r in run["topk"]],
            close=[dict(ids=np.asarray(results[r].ids), stopped=results[r].stopped,
                        qtype=results[r].qtype, tuples=results[r].tuples_read)
                   for r in run["close"]],
            stream_ok=bool(final.status == "done"
                           and all(a.status != "done" for a in run["stream"][:-1])
                           and final.result is blocking
                           and np.array_equal(final.ids, blocking.ids)),
            stopped_last_poll=bool(np.array_equal(server.poll_result(run["topk"][0]).ids,
                                                  results[run["topk"][0]].ids)))
    out["total_s"] = time.perf_counter() - t_start
    out["done_at"] = time.time()
    return out


def _share_table(torch, blocked) -> dict:
    """The host arrays in shared memory: a child maps them by handle."""
    import numpy as np

    return dict(
        z=torch.from_numpy(blocked.z_blocks).share_memory_(),
        x=torch.from_numpy(blocked.x_blocks).share_memory_(),
        bitmap=torch.from_numpy(np.ascontiguousarray(blocked.bitmap).view(np.int32))
        .share_memory_())


def _one_rank_nccl(torch, ctx, seed: int) -> dict:
    """10b on a one-rank NCCL mesh in this process: phase 4's query through
    `MatchServer(mesh=, pump=True)`, which must be bitwise phase 4."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.core import distributed
    from repro_torch.serve import MatchServer

    fm = ctx["fastmatch"]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{distributed._free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = distributed.init_mesh((1, 1), device_type="cuda")
        walls = []
        for _ in range(2):  # the second run's wall, after a warm-up; both checked
            server = MatchServer(ctx["blocked"], mesh=mesh, pump=True, max_queries=1, k_cap=10,
                                 lookahead=512, seed=seed)
            _reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            rid = server.submit(ctx["target"], k=10, eps=0.12, delta=0.01)
            res = server.run_until_idle()[rid]
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            launches = _launch_counts()
            counts, n = server.scheduler._full_counts()
            check(np.array_equal(res.ids, fm.ids)
                  and (res.rounds, res.blocks_read, res.tuples_read, res.exact)
                  == (fm.rounds, fm.blocks_read, fm.tuples_read, fm.exact),
                  f"10b one-rank NCCL: {res.rounds} rounds, {res.blocks_read} blocks, ids "
                  f"{res.ids}, not phase 4's {fm.rounds} / {fm.blocks_read} / {fm.ids}")
            check(torch.equal(res.state.tau, fm.state.tau) and torch.equal(counts, fm.state.counts)
                  and torch.equal(n, fm.state.n) and res.delta_upper == fm.delta_upper,
                  "10b one-rank NCCL: tau, counts, n or delta_upper not bitwise phase 4's")
            _check_per_round(launches, res.rounds, res.rounds + 1, "10b one-rank NCCL")
            del server, counts, n
            torch.cuda.empty_cache()
        check(dist.get_backend() == "nccl", "10b: the one-rank mesh is not NCCL")
        wall = walls[-1]
        out = dict(rounds=res.rounds, blocks_read=res.blocks_read, wall_s=wall,
                   walls_s=walls, launches=launches, bitwise_phase4=True,
                   backend=dist.get_backend(), phase4_wall_s=ctx["fastmatch"].wall_time_s)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"10b one-rank NCCL: {out['rounds']} rounds, {out['blocks_read']} blocks, "
        f"{wall * 1e3:.1f} ms, bitwise phase 4")
    return out


def _theorem1_ok(du_got, du_want, tau_got, tau_want, n, eps_i) -> bool:
    """log(delta_upper) within max_i n_i (eps_i + 2D) 2D + 1e-6 of the
    single stream's, D the tau gap (the Theorem-1 tolerance of
    `tests/test_torch_rounds.py`)."""
    import numpy as np

    d = float(np.abs(tau_got.astype(np.float64) - tau_want.astype(np.float64)).max())
    if d > TAU_ATOL:
        return False
    for s in range(len(du_want)):
        if du_want[s] == 0.0 or du_got[s] == 0.0:
            if du_want[s] != du_got[s]:
                return False
            continue
        bound = float(np.max(n.astype(np.float64) * (eps_i[s].astype(np.float64) + 2 * d)
                             * 2 * d)) + 1e-6
        if abs(np.log(float(du_got[s])) - np.log(float(du_want[s]))) > bound:
            return False
    return True


def phase_mesh(torch, ctx, *, seed: int) -> dict:
    """Phase 10 (see the module docstring): the mesh paths on phase 4's
    resident table and its host arrays."""
    import numpy as np

    from repro_torch.core import distributed
    from repro_torch.core.multiquery import MultiQuerySpec, SharedCountsScheduler
    from repro_torch.kernels import metrics

    t_phase = time.perf_counter()
    blocked, source = ctx["blocked"], ctx["source"]
    v_z, v_x, nb = source.v_z, source.v_x, source.num_blocks

    # -- 10b, first half: a one-rank NCCL mesh in this process
    nccl = _one_rank_nccl(torch, ctx, seed)

    # -- 10a's single stream, here, on the resident table
    targets = _lockstep_targets(ctx)
    order = np.random.default_rng(LOCKSTEP_ORDER_SEED).permutation(nb)
    spec = MultiQuerySpec(v_z=v_z, v_x=v_x, max_queries=4)
    single = SharedCountsScheduler(source, spec, window=512, seed=0, start_block=0)
    want = _lockstep(single, targets, order, 512, lambda: (single.state.counts, single.state.n))
    single_plans = dataclasses.asdict(single.plans)
    del single

    # -- the children: 10a at 2 x 2, 10b at 4 x 1, 10c at 2 x 2
    t = time.perf_counter()
    shared = _share_table(torch, blocked)
    share_s = time.perf_counter() - t
    # small arguments only: a child reads its pickled arguments after it
    # imports torch, and the parent's write of a large pickle waits for
    # it, which would start the children one after another
    meta = dict(v_z=v_z, v_x=v_x, seed=seed, target=ctx["target"], lockstep_targets=targets,
                workload=ctx["workload"])
    t, spawned_at = time.perf_counter(), time.time()
    ranks = distributed.run_ranks(_mesh_rank, MESH_RANKS, shared, meta, backend="gloo",
                                  device_type="cuda", timeout=600)
    ranks_s = time.perf_counter() - t
    del shared
    r0 = ranks[0]

    # -- 10a: every round bitwise the single stream (delta_upper within
    # Theorem 1 if the shard resolved another plan)
    got = r0["lockstep_records"]
    same_plans = r0["lockstep"]["plans"] == single_plans
    check(any(w["retired"] for w in want), "10a: no query retired inside the lockstep rounds")
    for r, (g, w) in enumerate(zip(got, want)):
        for key in ("counts", "n", "mask", "counters", "live", "retired"):
            check(g[key] == w[key], f"10a round {r}: {key} differs from the single stream")
        if same_plans:
            check(np.array_equal(g["tau"], w["tau"]) and np.array_equal(g["du"], w["du"]),
                  f"10a round {r}: tau or delta_upper not bitwise the single stream's")
        else:
            check(_theorem1_ok(g["du"], w["du"], g["tau"], w["tau"], w["n_full"], w["eps_i"]),
                  f"10a round {r}: tau or delta_upper past the Theorem-1 tolerance")
    for rk in ranks:
        lk = rk["lockstep"]
        for name in ("anyactive", "histogram"):
            check(lk["launches"][name] == LOCKSTEP_ROUNDS,
                  f"10a rank {rk['rank']}: {lk['launches'][name]} {name} launches for "
                  f"{LOCKSTEP_ROUNDS} rounds")
        check(sum(lk["launches"][c] for c in C_FORMS) >= lk["stats_steps"],
              f"10a rank {rk['rank']}: kernel C launched under once a statistics step")

    # -- 10b: Guarantee 1 against the exact truth; the counts the read
    # blocks' histogram
    q = r0["query_result"]
    truth = ctx["counts"]  # Scan's exact counts: the exact tau below
    q_hat = torch.from_numpy((ctx["target"] / ctx["target"].sum()).astype(np.float32))
    exact_tau = metrics.distance_multi_ref(truth, q_hat[None].to(truth.device))[0]
    exact_tau = exact_tau.cpu().numpy().astype(np.float64)
    check(_meets_guarantee1(q["ids"], exact_tau, 0.12, 10),
          "10b 4 x 1: the answer misses Guarantee 1")
    check(q["delta_upper"] < 0.01 and not q["exact"], "10b 4 x 1: the bound did not fire")
    read = torch.from_numpy(np.flatnonzero(q["read_mask"])).to(source.device)
    z, x = source._z[read].reshape(-1), source._x[read].reshape(-1)
    keep = z >= 0
    hist = torch.bincount(z[keep].long() * v_x + x[keep].long(), minlength=v_z * v_x)
    hist = hist.to(torch.float32).reshape(v_z, v_x).cpu().numpy()
    check(np.array_equal(hist, q["counts"]) and np.array_equal(hist.sum(1), q["n"]),
          "10b 4 x 1: the counts are not the histogram of the blocks the read mask marks")
    check(int(q["read_mask"].sum()) == q["blocks_read"], "10b 4 x 1: read mask and blocks differ")
    for rk in ranks:
        qr = rk["query"]
        _check_per_round(qr["launches"], qr["rounds"], qr["rounds"], f"10b rank {rk['rank']}")

    # -- 10c: phase 5's checks on every answer
    sv = r0["serving_results"]
    wtruth, _ = _workload_truth(torch, ctx)
    for i, res in enumerate(sv["topk"]):
        check(res["qtype"] == "topk" and len(res["ids"]) == 10, f"10c top-k {i} malformed")
        if i == 0:
            check(res["stopped"] and res["stop_reason"] == "tuples" and not res["exact"],
                  f"10c: the stopped query reports {res['stopped']} {res['stop_reason']!r}")
        else:
            check(not res["stopped"] and _meets_guarantee1(res["ids"], wtruth[i], 0.12, 10),
                  f"10c top-k request {i} is not (eps, k)-correct")
    for i, res in enumerate(sv["close"]):
        d, ids = wtruth[8 + i], set(res["ids"].tolist())
        check(res["qtype"] == "closeness" and not res["stopped"], f"10c closeness {i} malformed")
        check(set(np.flatnonzero(d <= 0.10).tolist()) <= ids,
              f"10c closeness {i} missed a candidate within eps")
        check(ids.isdisjoint(np.flatnonzero(d >= 0.30).tolist()),
              f"10c closeness {i} labeled a far candidate close")
    check(sv["stream_ok"] and sv["stopped_last_poll"], "10c: the anytime stream or stop differs")
    for rk in ranks:
        sr = rk["serving"]
        _check_per_round(sr["launches"], sr["rounds"], 1, f"10c rank {rk['rank']}")

    def per_round(rk, name, rounds):
        m = rk[name]
        return dict(launches_per_round={k: v / rounds for k, v in m["launches"].items() if v},
                    collective_ms_per_round=m["collective_s"] * 1e3 / rounds,
                    collectives_per_round=m["collective_calls"] / rounds,
                    collective_kb_per_round=m["collective_bytes"] / 1e3 / rounds)

    out = dict(
        seconds=time.perf_counter() - t_phase, share_s=share_s, ranks_s=ranks_s,
        rank_startup_s=[rk["entered_at"] - spawned_at for rk in ranks],
        rank_startup_steps_s=[{k: v - spawned_at for k, v in rk["startup"].items()}
                              for rk in ranks],
        ranks_shutdown_s=spawned_at + ranks_s - max(rk["done_at"] for rk in ranks),
        rank_attach_s=[rk["attach_s"] for rk in ranks], rank_total_s=[rk["total_s"] for rk in ranks],
        one_rank_nccl=nccl,
        lockstep=dict(rounds=LOCKSTEP_ROUNDS, bitwise=same_plans, plans_equal=same_plans,
                      retired=got[-1]["retired"], wall_s=r0["lockstep"]["wall_s"],
                      per_rank=[per_round(rk, "lockstep", LOCKSTEP_ROUNDS) for rk in ranks]),
        query=dict(mesh=[4, 1], rounds=q["rounds"], passes=q["passes"], blocks_read=q["blocks_read"],
                   tuples_read=q["tuples_read"], wall_s=r0["query"]["wall_s"],
                   construct_s=[rk["query"]["construct_s"] for rk in ranks],
                   phase4=dict(rounds=ctx["fastmatch"].rounds,
                               blocks_read=ctx["fastmatch"].blocks_read,
                               wall_s=ctx["fastmatch"].wall_time_s),
                   worker_gather_s=r0["query"]["worker_gather_s"],
                   per_rank=[per_round(rk, "query", rk["query"]["rounds"]) for rk in ranks]),
        serving=dict(mesh=[2, 2], rounds=r0["serving"]["rounds"],
                     host_syncs=r0["serving"]["host_syncs"], shared_tuples=r0["serving"]["tuples"],
                     wall_s=r0["serving"]["served_wall_s"],
                     construct_s=[rk["serving"]["construct_s"] for rk in ranks],
                     phase5=dict(rounds=ctx["phase5"]["rounds"], wall_s=ctx["phase5"]["wall_s"],
                                 shared_tuples=int(ctx["phase5"]["cache"][5])),
                     tuples=[r["tuples"] for r in sv["topk"] + sv["close"]],
                     per_rank=[per_round(rk, "serving", rk["serving"]["rounds"]) for rk in ranks]),
        launches=dict(lockstep=r0["lockstep"]["launches"], query=r0["query"]["launches"],
                      serving=r0["serving"]["launches"], one_rank_nccl=nccl["launches"]),
    )
    emit({"check": "mesh", **{k: v for k, v in out.items() if k != "launches"}})
    log(f"phase 10 took {out['seconds']:.1f}s (children {ranks_s:.1f}s)")
    return out


def _le(edge: float) -> str:
    """An edge as the registry's Prometheus text writes it."""
    from repro_torch.obs.registry import _fmt

    return _fmt(edge)


# the taxi keys phase 6 tunes: (Q, metric)
TUNE_KEYS = ((1, "l1"), (8, "l1"), (8, "chi2"), (8, "hellinger"))


def phase_tuner(torch) -> dict:
    """The tuner on the card at the taxi keys, into a scratch plan file
    under build/ (the committed one is never written): every candidate's
    time, and whether each winner is the committed file's, reported, not
    checked (winners inside the margin are noise). Returns the tuner's
    launches and the report."""
    from repro_torch.kernels import autotune, ops

    v_z, v_x = 7548, 24
    committed = autotune.PlanRegistry.load(backend="cuda")
    reg = autotune.PlanRegistry(backend="cuda")
    for kern in ops.KERNELS.values():
        kern.launches = 0
    report = dict(tau={}, ingest={})
    for q, metric in TUNE_KEYS:
        key = autotune.tau_key(v_z, v_x, q, metric=metric)
        plan, timed = autotune.tune_tau(v_z, v_x, q, metric=metric, device="cuda")
        reg.tau[key] = plan
        report["tau"][key] = dict(
            winner=dataclasses.asdict(plan),
            matches_committed=committed.tau.get(key) == plan,
            candidates=[dict(plan=dataclasses.asdict(c), ms=ms * 1e3) for c, ms in timed.items()])
        log(f"tuned {key}: {plan} (committed: {committed.tau.get(key)})")
        for c, ms in sorted(timed.items(), key=lambda kv: kv[1]):
            log(f"  {ms * 1e3:9.4f} ms  {c}")
    key = autotune.ingest_key(v_z, v_x)
    plan, timed = autotune.tune_ingest(v_z, v_x, device="cuda")
    reg.ingest[key] = plan
    report["ingest"][key] = dict(
        winner=dataclasses.asdict(plan), matches_committed=committed.ingest.get(key) == plan,
        candidates=[dict(plan=dataclasses.asdict(c), ms=ms * 1e3) for c, ms in timed.items()])
    log(f"tuned {key}: {plan} (committed: {committed.ingest.get(key)})")
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in ops.KERNELS.items()}
    path = reg.save(ROOT / "build" / "tuned_smoke" / "cuda.json")
    check(autotune.PlanRegistry.load(path=path, backend="cuda").decisions() == reg.decisions(),
          "the tuned plan file does not load back byte-stable")
    check(all(launches[name] > 0 for name in ops.KERNELS if name != "anyactive"),
          f"the tuner did not launch every form of kernels B and C: {launches}")
    emit({"check": "tuner", "launches": launches,
          "matches_committed": {k: v["matches_committed"]
                                for part in report.values() for k, v in part.items()}})
    return dict(launches=launches, report=report)


# ---------------------------------------------------------------------------
# phase 11: the data layer and the LM
# ---------------------------------------------------------------------------

LM_DEVICE = "cuda"
LM_CORPUS = dict(vocab_size=151936, num_blocks=32768)  # seed 0: 67.1M tokens
LM_SELECT_EXPECT = (9, 449)  # the reference's rounds and blocks on XLA:CPU
LM_ARCH = "qwen2_5_3b"
LM_PROMPT, LM_NEW, LM_SLOTS, LM_MAX_LEN = 256, 32, 8, 512
LM_F32_SPLIT = 128  # 11c: prefill this many tokens, decode as many again
LM_F32_ATOL = 1e-3
LM_MONITOR_BINS = 64


def _greedy_loop(torch, model, prompts, max_len: int, steps: int) -> tuple:
    """The greedy prefill + decode loop on one batch: its tokens a row,
    its final cache, whether every logit was finite, and its prefill and
    per-tick ms (each synchronised)."""
    toks = torch.from_numpy(prompts).to(LM_DEVICE)
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = model.prefill(toks, max_len)
    tok = torch.argmax(logits[:, -1], dim=-1)
    finite = bool(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    out = [tok]
    t = time.perf_counter()
    for _ in range(steps - 1):
        logits, cache = model.decode_step(cache, tok)
        finite &= bool(torch.isfinite(logits).all())
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t) * 1e3 / max(steps - 1, 1)
    rows = torch.stack(out, 1).cpu().numpy().tolist()
    return rows, cache, finite, prefill_ms, tick_ms


def _cache_tensors(cache) -> dict:
    """The filled part of every layer's K and V cache, by monitor name."""
    n = cache.length
    out = {f"k{i}": k[:, :n] for i, k in enumerate(cache.k)}
    out.update({f"v{i}": v[:, :n] for i, v in enumerate(cache.v)})
    return out


def phase_lm(torch, timer, card: str) -> dict:
    """Phase 11 (see the module docstring): selection, serving at full
    width, the monitor, decode consistency in float32."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.corpus import CorpusSpec, make_corpus
    from repro_torch.data.pipeline import TokenStream, select_domains
    from repro_torch.kernels import histogram, ref
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train import ActivationMonitor
    from repro_torch.train import monitor as monitor_mod

    t_phase = time.perf_counter()
    out = {}

    # -- 11a: FastMatch picks the corpus's domains on the card
    t = time.perf_counter()
    corpus = make_corpus(CorpusSpec(**LM_CORPUS))
    corpus_s = time.perf_counter() - t
    _reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    rep = select_domains(corpus, k=8, seed=0, device=LM_DEVICE)
    torch.cuda.synchronize()
    select_s = time.perf_counter() - t
    launches = _launch_counts()
    res = rep.result
    selected = np.sort(rep.selected_domains)
    check(np.array_equal(selected, corpus.close_ids),
          f"11a: selected {selected.tolist()}, planted {corpus.close_ids.tolist()}")
    if LM_SELECT_EXPECT is not None:
        check((res.rounds, res.blocks_read) == LM_SELECT_EXPECT,
              f"11a: {res.rounds} rounds, {res.blocks_read} blocks, not {LM_SELECT_EXPECT}")
    c = sum(launches[name] for name in C_FORMS)
    check(launches["anyactive"] == launches["histogram"] == res.rounds
          and res.rounds <= c <= res.rounds + 1,
          f"11a: launches {launches} for {res.rounds} rounds")
    out["select"] = dict(
        ids=selected.tolist(), rounds=res.rounds, blocks_read=res.blocks_read,
        blocks_scanned_frac=rep.blocks_scanned_frac, delta_upper=res.delta_upper,
        exact=res.exact, query_wall_ms=res.wall_time_s * 1e3, select_s=select_s,
        corpus_s=corpus_s, tokens=int(corpus.tokens.size), launches=launches)
    log(f"11a selection: {selected.tolist()} in {res.rounds} rounds, {res.blocks_read} blocks "
        f"(blocks_scanned_frac {rep.blocks_scanned_frac:.6f}), delta_upper "
        f"{res.delta_upper:.6g}; query {res.wall_time_s * 1e3:.1f} ms, select_domains "
        f"{select_s:.2f}s, corpus {corpus_s:.1f}s; launches {launches}")

    # -- 11b: serving at full width
    stream = TokenStream(corpus, rep.selected_domains, batch_size=LM_SLOTS, seq_len=LM_PROMPT,
                         seed=0)
    batches = [next(stream)["tokens"] for _ in range(2)]
    del corpus, rep, res, stream
    cfg = get_config(LM_ARCH)
    t = time.perf_counter()
    model = get_model(cfg, device=LM_DEVICE,
                      generator=torch.Generator(device=LM_DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    # the loop first on batch 1: it also warms the card's libraries
    loops = [_greedy_loop(torch, model, b, LM_MAX_LEN, LM_NEW) for b in batches]
    engine = ServeEngine(model, slots=LM_SLOTS, max_len=LM_MAX_LEN)
    reqs = [Request(rid=i, prompt=row, max_new_tokens=LM_NEW)
            for i, row in enumerate(np.concatenate(batches))]
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    t = time.perf_counter()
    done = engine.run()
    serve_s = time.perf_counter() - t
    want_metrics = {"prefills": 2, "decode_ticks": 2 * (LM_NEW - 1),
                    "tokens_out": len(reqs) * LM_NEW}
    check(engine.metrics == want_metrics, f"11b: metrics {engine.metrics}, not {want_metrics}")
    check(all(loop[2] for loop in loops), "11b: a logit was not finite")
    manual = loops[0][0] + loops[1][0]
    check([r.rid for r in done] == list(range(len(reqs)))
          and all(r.output == manual[r.rid] for r in done),
          "11b: an engine output differs from the greedy loop on the same batch")
    # where a decode tick's time goes: one tick at the served depth, profiled
    from torch.profiler import ProfilerActivity, profile

    cache = model.init_cache(LM_SLOTS, LM_MAX_LEN)._replace(length=LM_PROMPT + LM_NEW - 1)
    tok = torch.zeros(LM_SLOTS, dtype=torch.int64, device=LM_DEVICE)
    model.decode_step(cache, tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model.decode_step(cache, tok)
        torch.cuda.synchronize()
        tick_wall_ms = (time.perf_counter() - t) * 1e3
    del cache
    device_ms, by_kernel, by_host_op = _profile_tables(torch, prof)
    out["serve"] = dict(
        arch=LM_ARCH, dtype=cfg.dtype, params=sum(p.numel() for p in model.parameters()),
        build_s=build_s, metrics=engine.metrics, wall_s=serve_s,
        tokens_per_s=engine.metrics["tokens_out"] / serve_s,
        prefill_ms=[loop[3] for loop in loops], tick_ms=[loop[4] for loop in loops],
        distinct_outputs=len({tuple(r.output) for r in done}),
        profiled_tick=dict(
            wall_ms=tick_wall_ms, device_ms=device_ms,
            host_launches=sum(c for name, _, c in by_host_op if name.startswith("cudaLaunch")),
            top_kernels=by_kernel[:8], top_host_ops=by_host_op[:8]))
    log(f"11b serving {LM_ARCH} ({out['serve']['params'] / 1e9:.3f}B params, {cfg.dtype}, built "
        f"in {build_s:.1f}s): {engine.metrics} in {serve_s * 1e3:.1f} ms, "
        f"{out['serve']['tokens_per_s']:.1f} tokens/s; loop prefill "
        f"{[round(x, 2) for x in out['serve']['prefill_ms']]} ms, decode tick "
        f"{[round(x, 3) for x in out['serve']['tick_ms']]} ms; outputs equal the loop's; {card}; "
        f"a profiled tick: device {device_ms:.2f} of {tick_wall_ms:.2f} ms wall, top kernels "
        f"{[(name[:60], round(ms, 3), n) for name, ms, n in by_kernel[:4]]}")

    # -- 11d: the monitor bins the served model's KV caches
    names = [f"{kv}{i}" for kv in "kv" for i in range(cfg.num_layers)]
    mon = ActivationMonitor(names=names, bins=LM_MONITOR_BINS)
    first = _cache_tensors(loops[0][1])
    second = _cache_tensors(loops[1][1])
    second["k0"] = second["k0"] * 4  # the planted drift
    _reset_launches()
    t = time.perf_counter()
    mon.capture_reference(first)
    report = mon.check(second)
    monitor_s = time.perf_counter() - t
    mon_launches = _launch_counts()
    mon_forms = _form_launches()
    check(mon_launches["histogram"] == 2 * len(names)
          and sum(mon_launches.values()) == 2 * len(names),
          f"11d: launches {mon_launches} for 2 x {len(names)} tensors")
    check(mon_forms == {"global": 0, "private": 2 * len(names)},
          f"11d: kernel B's forms {mon_forms} for 2 x {len(names)} tensors")
    check(report["k0"]["drifted"], f"11d: the planted drift was not flagged: {report['k0']}")
    flagged = sorted(n for n in names[1:] if report[n]["drifted"])
    rows = mon._histogram(second)
    samples = set()
    for name, row in zip(names, rows):
        ids = monitor_mod._bin_ids(second[name], mon.lo, mon.hi, mon.bins)
        plain = ref.histogram_ref(torch.zeros_like(ids), ids, v_z=1, v_x=mon.bins)[0]
        check(np.array_equal(row, plain.cpu().numpy()),
              f"11d: {name}'s histogram is not its plain version's")
        samples.add(int(ids.numel()))
    # kernel B on layer 0's planted keys: the monitor's z-less call in its
    # form and each form pinned, and the old call with zero z ids
    ids = monitor_mod._bin_ids(second["k0"], mon.lo, mon.hi, mon.bins)
    zeros = torch.zeros_like(ids)
    kernel = _kernel_b_row(torch, timer, None, ids, 1, mon.bins, ingest=False)
    kernel["zeros_ms"], _ = timer(lambda: histogram.histogram(zeros, ids, v_z=1, v_x=mon.bins))
    out["monitor"] = dict(
        tensors=len(names), samples_per_tensor=sorted(samples), launches=mon_launches,
        forms=mon_forms, wall_s=monitor_s, drift_k0=report["k0"], flagged_others=flagged,
        kernel=kernel)
    log(f"11d monitor: {len(names)} tensors of {sorted(samples)} values, {monitor_s * 1e3:.1f} ms "
        f"for capture + check, launches {mon_launches}; k0 x 4 flagged (distance "
        f"{report['k0']['distance']:.4f}, bound {report['k0']['sampling_bound']:.4f}); "
        f"{len(flagged)} of the other {len(names) - 1} flagged {flagged}; kernel B at (1, "
        f"{mon.bins}) {kernel['ms'] * 1e3:.2f} us z-less {kernel['form']} (zero z ids "
        f"{kernel['zeros_ms'] * 1e3:.2f}, global {kernel['global_ms'] * 1e3:.2f}, "
        f"plain {kernel['plain_ms'] * 1e3:.2f}, bincount {kernel['library_ms'] * 1e3:.2f}, "
        f"bound {kernel['bound_ms'] * 1e3:.4f} us)")
    del model, loops, first, second, engine, done
    torch.cuda.empty_cache()

    # -- 11c: decode consistency at full width in float32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg32, device=LM_DEVICE,
                      generator=torch.Generator(device=LM_DEVICE).manual_seed(1))
    toks = torch.from_numpy(batches[0][:2]).to(LM_DEVICE)
    with torch.no_grad():
        full, _ = model(toks)
    logits, cache = model.prefill(toks[:, :LM_F32_SPLIT], LM_PROMPT)
    steps = [logits]
    for i in range(LM_F32_SPLIT, LM_PROMPT):
        step, cache = model.decode_step(cache, toks[:, i])
        steps.append(step[:, None])
    got = torch.cat(steps, dim=1)
    err = float((got - full).abs().max())
    same_argmax = bool(torch.equal(got.argmax(-1), full.argmax(-1)))
    scale = float(full.abs().max())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del model, cache, full, got, steps, logits
    torch.cuda.empty_cache()
    check(err <= LM_F32_ATOL and same_argmax,
          f"11c: max |dlogits| {err:.3g} (bound {LM_F32_ATOL}), argmax equal {same_argmax}")
    out["f32_decode"] = dict(max_abs_dlogits=err, bound=LM_F32_ATOL, argmax_equal=same_argmax,
                             max_abs_logit=scale, tokens=[2, LM_PROMPT], peak_gb=peak_gb)
    log(f"11c float32: prefill {LM_F32_SPLIT} + decode {LM_PROMPT - LM_F32_SPLIT} against "
        f"forward: max |dlogits| {err:.3g} (largest |logit| {scale:.3g}), argmax equal; "
        f"peak {peak_gb:.1f} GB")

    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 11 took {out['phase_s']:.1f}s")
    emit({"check": "lm", **out})
    return out


# ---------------------------------------------------------------------------
# phase 12: training
# ---------------------------------------------------------------------------

TRAIN_DEVICE = "cuda"
TRAIN_ARCH = "qwen2_5_3b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 4, 8, 256, 3e-4
TRAIN_CORPUS = dict(num_blocks=512, block_tokens=2048, seed=0)  # the launcher's default
TRAIN_F32_ATOL, TRAIN_F32_PARAM_FRAC = 1e-5, 0.05  # the CPU twins' f32 bars
TRAIN_RESUME_ATOL = 2e-2  # tests/test_train_serve.py's resume bar
TINY_CORPUS = dict(num_domains=16, num_buckets=32, vocab_size=256, num_blocks=256,
                   block_tokens=512, n_reference=4, reference_alpha=0.08, seed=1)


def _bits_digest(torch, t) -> tuple:
    """An exact fingerprint of a tensor's bits: the plain and the
    position-weighted sums of its words as int64 (wrapping)."""
    t = t.detach().reshape(-1)
    words = t.view(torch.int16 if t.element_size() == 2 else torch.int32).to(torch.int64)
    weights = torch.arange(1, words.numel() + 1, dtype=torch.int64, device=t.device) % 65521
    return int(words.sum()), int((words * weights).sum())


def _state_digests(torch, state) -> list:
    from repro_torch.optimizer.base import tree_leaves

    return [_bits_digest(torch, t) for t in tree_leaves((state.params, state.opt_state))]


def _smoke_models(torch, dtype: str, remat: str = "none"):
    """The smoke qwen2.5-3b drawn on the CPU from seed 0 and its copy on the
    card (the same weights on both sides)."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model_zoo import get_model

    cfg = dataclasses.replace(get_smoke_config(TRAIN_ARCH), dtype=dtype, remat=remat)
    host = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return host, copy.deepcopy(host).to(TRAIN_DEVICE)


def _moves(torch, p, lr: float) -> bool:
    """Whether AdamW's first steps can change leaf ``p``: an update of
    ``lr`` is over half an ulp of some element (in bf16, |p| < 2^8 lr; a
    norm scale at 1.0 or a gate bias of a few units cannot move)."""
    return bool((p.detach().float().abs() < 2 * lr / torch.finfo(p.dtype).eps).any())


def _train_loop_checked(torch, cfg, arch: str, label: str, *, extra_batch_fn=None) -> tuple:
    """The launcher's `train_loop` on ``cfg`` (weights from a generator
    seeded 0), TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ at TRAIN_LR
    behind its default corpus and FastMatch's selection, with the launch
    counts at 0 just before the loop and read just after, held to phase
    12a's gates: the planted domains selected, kernels A and B once a
    round and C once a statistics step, every step ``step_ok`` 1 and
    finite, every leaf that AdamW can move changed (`_moves`). Returns
    the loop's output and its report (ms a step: those after the first)."""
    import numpy as np

    from repro_torch.data.corpus import CorpusSpec, make_corpus
    from repro_torch.launch import train as launch

    spec = CorpusSpec(vocab_size=cfg.vocab_size, **TRAIN_CORPUS)
    close_ids = make_corpus(spec).close_ids
    built, step_times = {}, []
    real_get_model = launch.get_model

    def recording_get_model(*args, **kwargs):
        model = real_get_model(*args, **kwargs)
        torch.cuda.synchronize()
        built["model"] = model
        built["digests"] = [_bits_digest(torch, p) for p in model.parameters()]
        built["movable"] = [_moves(torch, p, TRAIN_LR) for p in model.parameters()]
        return model

    def log_fn(msg):
        if msg.startswith("[train]"):
            torch.cuda.synchronize()
            step_times.append(time.perf_counter())
        log(f"  {msg}")

    launch.get_model = recording_get_model
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t = time.perf_counter()
    try:
        run = launch.train_loop(cfg=cfg, steps=TRAIN_STEPS, batch_size=TRAIN_BATCH,
                                seq_len=TRAIN_SEQ, lr=TRAIN_LR, seed=0, log_every=1,
                                log_fn=log_fn, device=TRAIN_DEVICE,
                                extra_batch_fn=extra_batch_fn)
    finally:
        launch.get_model = real_get_model
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model, state, sel = run["model"], run["state"], run["selection"]
    res = sel.result
    selected = np.sort(sel.selected_domains)
    check(model is built["model"], f"{label}: the loop trained another model than it built")
    check(np.array_equal(selected, close_ids),
          f"{label}: selected {selected.tolist()}, planted {close_ids.tolist()}")
    c = sum(launches[name] for name in C_FORMS)
    check(launches["anyactive"] == launches["histogram"] == res.rounds
          and res.rounds <= c <= res.rounds + 1,
          f"{label}: launches {launches} for {res.rounds} rounds of the selection")
    hist = run["history"]
    check(len(hist) == TRAIN_STEPS and int(state.step) == TRAIN_STEPS,
          f"{label}: {len(hist)} logged steps, state at step {int(state.step)}")
    check(all(h["step_ok"] == 1.0 and math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              for h in hist), f"{label}: a step was skipped or not finite: {hist}")
    # every weight matrix moved; a leaf whose every element is over 2^8 lr
    # (a norm scale at 1.0) may not, in bf16: an update of lr is under half
    # its ulp
    named = list(model.named_parameters())
    moved = {name: d != _bits_digest(torch, p) for d, (name, p) in zip(built["digests"], named)}
    still = sorted(name for (name, p), movable in zip(named, built["movable"])
                   if not moved[name] and (p.ndim >= 2 or movable))
    check(not still, f"{label}: parameters that did not change: {still}")
    step_ms = [(b - a) * 1e3 for a, b in zip(step_times, step_times[1:])]
    warm_ms = statistics.median(step_ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    report = dict(
        arch=arch, dtype=cfg.dtype, remat=cfg.remat, optimizer=cfg.optimizer,
        params=sum(p.numel() for p in model.parameters()), steps=TRAIN_STEPS,
        leaves_moved=sum(moved.values()), leaves=len(moved),
        leaves_unmovable=[name for (name, _), movable in zip(named, built["movable"])
                          if not movable],
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, loop_s=loop_s, step_ms_after_first=step_ms,
        ms_per_step=warm_ms, tokens_per_s=tokens / warm_ms * 1e3, peak_gb=peak_gb,
        losses=[h["loss"] for h in hist], grad_norms=[h["grad_norm"] for h in hist],
        select=dict(ids=selected.tolist(), rounds=res.rounds, blocks_read=res.blocks_read,
                    blocks_scanned_frac=sel.blocks_scanned_frac,
                    delta_upper=res.delta_upper, launches=launches))
    return run, report


def _learn_one_batch(torch, cfg, model, state, selected, label: str, *, extra_batch_fn=None,
                     profiled: bool = False) -> tuple:
    """Phase 12b: three more steps on one fixed batch of the loop's
    corpus (its stream seeded 1), the loss falling strictly at each; the
    first under torch.profiler when ``profiled``. Returns the state, the
    batch, the step, the losses and (the profile, its wall ms) or None."""
    from repro_torch.data.corpus import CorpusSpec, make_corpus
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.optimizer import get_optimizer
    from repro_torch.train import make_train_step
    from torch.profiler import ProfilerActivity, profile

    corpus = make_corpus(CorpusSpec(vocab_size=cfg.vocab_size, **TRAIN_CORPUS))
    batch = next(TokenStream(corpus, selected, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                             seed=1))
    batch = {"tokens": torch.from_numpy(batch["tokens"]).to(TRAIN_DEVICE)}
    if extra_batch_fn:
        batch.update(extra_batch_fn(batch))
    del corpus
    train_step = make_train_step(model, get_optimizer(cfg.optimizer, TRAIN_LR))
    losses, prof = [], None
    for i in range(3):
        if i == 0 and profiled:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
                t = time.perf_counter()
                state, m = train_step(state, batch)
                torch.cuda.synchronize()
                prof = (p, (time.perf_counter() - t) * 1e3)
        else:
            state, m = train_step(state, batch)
        check(float(m["step_ok"]) == 1.0, f"{label}: step {i} skipped")
        losses.append(float(m["loss"]))
    check(all(a > b for a, b in zip(losses, losses[1:])),
          f"{label}: the loss on one batch did not fall at every step: {losses}")
    return state, batch, train_step, losses, prof


def phase_train(torch, card: str) -> dict:
    """Phase 12 (see the module docstring): training on the card."""
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import CorpusSpec, make_corpus
    from repro_torch.launch import train as launch
    from repro_torch.optimizer import get_optimizer
    from repro_torch.optimizer.base import tree_leaves
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.train.step import make_loss_fn

    t_phase = time.perf_counter()
    out = {}

    # -- 12a: the entry point at full width
    cfg = get_config(TRAIN_ARCH)
    check(cfg.dtype == "bfloat16" and cfg.optimizer == "adamw" and cfg.remat == "full",
          f"12a: {TRAIN_ARCH} is {cfg.dtype}, {cfg.optimizer}, remat {cfg.remat}")
    run, out["loop"] = _train_loop_checked(torch, cfg, TRAIN_ARCH, "12a")
    model, state, sel = run["model"], run["state"], run["selection"]
    lp = out["loop"]
    log(f"12a train_loop {TRAIN_ARCH} ({lp['params'] / 1e9:.3f}B params, bf16, AdamW, "
        f"remat full), {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}: selection "
        f"{lp['select']['ids']} in {lp['select']['rounds']} rounds, launches "
        f"{lp['select']['launches']}; ms a step after the first "
        f"{[round(x, 1) for x in lp['step_ms_after_first']]} (median {lp['ms_per_step']:.1f}, "
        f"{lp['tokens_per_s']:.0f} tokens/s), peak {lp['peak_gb']:.2f} GB, loop "
        f"{lp['loop_s']:.1f}s; {card}")

    # -- 12b: learning on one fixed batch (its first step profiled)
    state, batch, train_step, losses, (prof, prof_wall_ms) = _learn_one_batch(
        torch, cfg, model, state, sel.selected_domains, "12b", profiled=True)
    device_ms, by_kernel, by_host_op = _profile_tables(torch, prof)
    out["learn"] = dict(losses=losses)
    out["profiled_step"] = dict(
        wall_ms=prof_wall_ms, device_ms=device_ms,
        device_kernels=sum(n for _, _, n in by_kernel),
        host_launches=sum(n for name, _, n in by_host_op if name.startswith("cudaLaunch")),
        top_kernels=by_kernel[:10], top_host_ops=by_host_op[:8])
    del prof
    log(f"12b one batch, 3 steps: losses {[round(x, 5) for x in losses]} (strictly falling); "
        f"a profiled step: device {device_ms:.1f} of {prof_wall_ms:.1f} ms wall, "
        f"{out['profiled_step']['device_kernels']} device kernels, "
        f"{out['profiled_step']['host_launches']} launches; top "
        f"{[(name[:50], round(ms, 1), n) for name, ms, n in by_kernel[:5]]}")

    # -- 12c: the guard at full width
    row = int(batch["tokens"][0, 5])
    with torch.no_grad():
        model.embed["table"][row] = float("nan")
    before = _state_digests(torch, state)
    step_before = int(state.step)
    state, m = train_step(state, batch)
    after = _state_digests(torch, state)
    check(float(m["step_ok"]) == 0.0, f"12c: the NaN step was not skipped: {m}")
    check(before == after, "12c: a parameter or moment changed on a skipped step")
    check(int(state.step) == step_before + 1, "12c: the step did not increment")
    out["guard"] = dict(step_ok=float(m["step_ok"]), loss=float(m["loss"]), leaves=len(before),
                        unchanged=True, step=int(state.step))
    log(f"12c guard: NaN in embedding row {row}: step_ok 0, {len(before)} leaves bitwise "
        f"unchanged, step {step_before} -> {int(state.step)}")
    del model, state, run, sel, train_step, batch, m
    torch.cuda.empty_cache()

    # -- 12d: card against CPU at the smoke config, and remat on the card
    host, dev = _smoke_models(torch, "float32")
    opt = get_optimizer("adamw", 1e-3)
    hs, ds = TrainState.create(host, opt), TrainState.create(dev, opt)
    toks = np.random.default_rng(0).integers(0, host.cfg.vocab_size, (2, 16)).astype(np.int32)
    hs, hm = make_train_step(host, opt)(hs, {"tokens": torch.from_numpy(toks)})
    ds, dm = make_train_step(dev, opt)(ds, {"tokens": torch.from_numpy(toks).to(TRAIN_DEVICE)})
    loss_err = max(abs(float(dm[k]) - float(hm[k])) for k in ("loss", "ce"))
    gnorm_rel = abs(float(dm["grad_norm"]) / float(hm["grad_norm"]) - 1)
    param_err = max(float((a.detach().cpu() - b.detach()).abs().max())
                    for a, b in zip(tree_leaves(ds.params), tree_leaves(hs.params)))
    check(loss_err <= TRAIN_F32_ATOL and gnorm_rel <= TRAIN_F32_ATOL
          and param_err <= TRAIN_F32_PARAM_FRAC * 1e-3,
          f"12d: card against CPU: loss {loss_err:.3g}, grad_norm {gnorm_rel:.3g} relative, "
          f"params {param_err:.3g}")
    toks_c = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 32))
                              .astype(np.int32)).to(TRAIN_DEVICE)
    grads = {}
    for remat in ("none", "full", "dots"):
        dev.cfg = dataclasses.replace(dev.cfg, remat=remat)
        loss = make_loss_fn(dev)({"tokens": toks_c})[0]
        loss.backward()
        grads[remat] = [loss.detach()] + [p.grad.clone() for p in tree_leaves(ds.params)]
        for p in tree_leaves(ds.params):
            p.grad = None
    remat_equal = {r: all(torch.equal(a, b) for a, b in zip(grads[r], grads["none"]))
                   for r in ("full", "dots")}
    check(all(remat_equal.values()), f"12d: remat grads differ from none: {remat_equal}")
    out["card_vs_cpu"] = dict(loss_abs=loss_err, grad_norm_rel=gnorm_rel, param_abs=param_err,
                              bars=dict(loss=TRAIN_F32_ATOL, grad_norm=TRAIN_F32_ATOL,
                                        params=TRAIN_F32_PARAM_FRAC * 1e-3),
                              remat_bitwise=remat_equal)
    log(f"12d smoke f32 card against CPU: loss {loss_err:.3g}, grad_norm {gnorm_rel:.3g} "
        f"relative, params {param_err:.3g}; remat full / dots grads bitwise none's")
    del host, dev, hs, ds, grads

    # -- 12e: resume, and a bf16 state through the checkpoint manager
    tiny = make_corpus(CorpusSpec(**TINY_CORPUS))
    from repro_torch.configs import get_smoke_config

    kw = dict(cfg=get_smoke_config(TRAIN_ARCH), batch_size=4, seq_len=64, lr=1e-3, corpus=tiny,
              select_k=4, log_fn=lambda *_: None, seed=3, device=TRAIN_DEVICE)
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as tmp:
        full = launch.train_loop(steps=10, **kw)
        launch.train_loop(steps=5, ckpt_dir=tmp, ckpt_every=5, **kw)
        resumed = launch.train_loop(steps=10, ckpt_dir=tmp, ckpt_every=5, **kw)
        resume_err = max(float((a.detach().float() - b.detach().float()).abs().max())
                         for a, b in zip(tree_leaves(full["state"].params),
                                         tree_leaves(resumed["state"].params)))
        check(int(resumed["state"].step) == 10 and resume_err <= TRAIN_RESUME_ATOL,
              f"12e: resumed to step {int(resumed['state'].step)}, max |dparam| {resume_err:.3g}")
        mgr = CheckpointManager(os.path.join(tmp, "roundtrip"))
        saved = resumed["state"]
        mgr.save(saved.to_disk(), 10)
        _, fresh_model = _smoke_models(torch, "bfloat16")
        fresh = TrainState.create(fresh_model, get_optimizer("adamw", 1e-3))
        loaded = fresh.load_(mgr.restore(fresh.skeleton()))
        round_trip = _state_digests(torch, loaded) == _state_digests(torch, saved)
        check(round_trip and int(loaded.step) == 10,
              "12e: a bf16 train state did not round-trip bitwise")
    out["resume"] = dict(max_abs_dparam=resume_err, bar=TRAIN_RESUME_ATOL,
                         bf16_round_trip_bitwise=round_trip)
    log(f"12e resume 5 + 5 against 10 uninterrupted: max |dparam| {resume_err:.3g} (bar "
        f"{TRAIN_RESUME_ATOL}); bf16 state round-trips bitwise")
    del full, resumed, saved, fresh, loaded, fresh_model
    torch.cuda.empty_cache()

    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 12 took {out['phase_s']:.1f}s")
    emit({"check": "train", **out})
    return out


# ---------------------------------------------------------------------------
# phase 13: every model family
# ---------------------------------------------------------------------------

FAM_ARCHS = ("mixtral_8x7b", "recurrentgemma_2b", "xlstm_125m", "whisper_medium")
# the one cut: mixtral-8x7b's 32 layers (46.70B parameters, 93.4 GB in bf16)
# do not fit one 80 GB card; its layers are alike, so 16 keep the pattern
FAM_LAYERS = {"mixtral_8x7b": 16}
FAM_CORPUS_BLOCKS = 4096
FAM_SELECT_EXPECT = (9, 457)  # the reference's rounds and blocks on XLA:CPU, every vocab
FAM_PROMPT = {"whisper_medium": 224}  # whisper's prompt limit; the others LM_PROMPT
FAM_F32_LAYERS = {"mixtral_8x7b": 4}  # 13c: 24.3 GB in float32
FAM_TRAIN_ARCHS = ("mixtral_8x7b", "grok_1_314b", "recurrentgemma_2b", "xlstm_125m",
                   "whisper_medium")
FAM_MEMORY_BEFORE = 2e9  # bytes allocated on the card when phase 13 starts, at most


def _family_cfg(arch: str, **kw):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch in FAM_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=FAM_LAYERS[arch])
    return dataclasses.replace(cfg, **kw)


def _state_tensors(cache) -> dict:
    """The decode state the activation monitor bins (13d), by name: the
    filled K/V (transformer, whisper's self and cross), the RG-LRU's
    window K/V, ``lru_h`` and ``conv``, the mLSTM's c/n/m and the sLSTM's
    c/n/h/m."""
    from repro_torch.models.rglru import HybridCache
    from repro_torch.models.whisper import WhisperCache
    from repro_torch.models.xlstm import XLSTMCache

    n = cache.length
    out = {}
    if isinstance(cache, HybridCache):
        for i, (k, v, h, c) in enumerate(zip(cache.attn_k, cache.attn_v, cache.lru_h,
                                             cache.conv)):
            if k.shape[1]:
                out[f"k{i}"], out[f"v{i}"] = k[:, :n], v[:, :n]
            else:
                out[f"h{i}"], out[f"conv{i}"] = h, c
    elif isinstance(cache, XLSTMCache):
        for i, (m, s) in enumerate(zip(cache.mlstm, cache.slstm)):
            state, fields = (m, "cnm") if m is not None else (s, "cnhm")
            prefix = "m" if m is not None else "s"
            out.update({f"{prefix}{f}{i}": getattr(state, f) for f in fields})
    elif isinstance(cache, WhisperCache):
        for i in range(len(cache.self_k)):
            out[f"k{i}"], out[f"v{i}"] = cache.self_k[i][:, :n], cache.self_v[i][:, :n]
            out[f"xk{i}"], out[f"xv{i}"] = cache.cross_k[i], cache.cross_v[i]
    else:
        out = _cache_tensors(cache)
    return out


def _family_select(torch, arch: str, vocab: int, label: str = "13a") -> tuple:
    """13a (14a) for one family: the selection on the card and its
    launches (counts at 0 just before, read just after), and the stream's
    prompts."""
    import numpy as np

    from repro_torch.data.corpus import CorpusSpec, make_corpus
    from repro_torch.data.pipeline import TokenStream, select_domains

    corpus = make_corpus(CorpusSpec(vocab_size=vocab, num_blocks=FAM_CORPUS_BLOCKS))
    _reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    rep = select_domains(corpus, k=8, seed=0, device=LM_DEVICE)
    torch.cuda.synchronize()
    select_s = time.perf_counter() - t
    launches = _launch_counts()
    res = rep.result
    selected = np.sort(rep.selected_domains)
    check(np.array_equal(selected, corpus.close_ids),
          f"{label} {arch}: selected {selected.tolist()}, planted {corpus.close_ids.tolist()}")
    if FAM_SELECT_EXPECT is not None:
        check((res.rounds, res.blocks_read) == FAM_SELECT_EXPECT,
              f"{label} {arch}: {res.rounds} rounds, {res.blocks_read} blocks, "
              f"not {FAM_SELECT_EXPECT}")
    c = sum(launches[name] for name in C_FORMS)
    check(launches["anyactive"] == launches["histogram"] == res.rounds
          and res.rounds <= c <= res.rounds + 1,
          f"{label} {arch}: launches {launches} for {res.rounds} rounds")
    batch = next(TokenStream(corpus, rep.selected_domains, batch_size=LM_SLOTS,
                             seq_len=LM_PROMPT, seed=0))["tokens"]
    report = dict(ids=selected.tolist(), rounds=res.rounds, blocks_read=res.blocks_read,
                  blocks_scanned_frac=rep.blocks_scanned_frac, select_s=select_s,
                  launches=launches)
    return report, batch


def _family_serve(torch, arch: str, prompts) -> tuple:
    """13b (and 13d on its decode state) for one family at full width."""
    import numpy as np

    from repro_torch.kernels import ref
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train import ActivationMonitor
    from repro_torch.train import monitor as monitor_mod
    from torch.profiler import ProfilerActivity, profile

    cfg = _family_cfg(arch)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = get_model(cfg, device=LM_DEVICE,
                      generator=torch.Generator(device=LM_DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    loop = _greedy_loop(torch, model, prompts, LM_MAX_LEN, LM_NEW)
    engine = ServeEngine(model, slots=LM_SLOTS, max_len=LM_MAX_LEN)
    for i, row in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=row, max_new_tokens=LM_NEW))
    torch.cuda.synchronize()
    t = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"prefills": 1, "decode_ticks": LM_NEW - 1, "tokens_out": len(prompts) * LM_NEW}
    check(engine.metrics == want, f"13b {arch}: metrics {engine.metrics}, not {want}")
    check(loop[2], f"13b {arch}: a logit was not finite")
    check([r.rid for r in done] == list(range(len(prompts)))
          and all(r.output == loop[0][r.rid] for r in done),
          f"13b {arch}: an engine output differs from the greedy loop on the same batch")

    # -- 13d: the monitor over the loop's final decode state
    state = _state_tensors(loop[1])
    names = sorted(state)
    mon = ActivationMonitor(names=names, bins=LM_MONITOR_BINS)
    _reset_launches()
    t = time.perf_counter()
    rows = mon._histogram(state)
    monitor_s = time.perf_counter() - t
    mon_launches = _launch_counts()
    check(mon_launches["histogram"] == len(names)
          and sum(mon_launches.values()) == len(names),
          f"13d {arch}: launches {mon_launches} for {len(names)} tensors")
    check(_form_launches() == {"global": 0, "private": len(names)},
          f"13d {arch}: kernel B's forms {_form_launches()} for {len(names)} tensors")
    for name, row in zip(names, rows):
        ids = monitor_mod._bin_ids(state[name], mon.lo, mon.hi, mon.bins)
        plain = ref.histogram_ref(torch.zeros_like(ids), ids, v_z=1, v_x=mon.bins)[0]
        check(np.array_equal(row, plain.cpu().numpy()),
              f"13d {arch}: {name}'s histogram is not its plain version's")
    values = sum(int(state[name].numel()) for name in names)
    del state

    # one decode tick at the served depth, profiled
    tok = torch.zeros(LM_SLOTS, dtype=torch.int64, device=LM_DEVICE)
    model.decode_step(loop[1], tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model.decode_step(loop[1], tok)
        torch.cuda.synchronize()
        tick_wall_ms = (time.perf_counter() - t) * 1e3
    device_ms, by_kernel, by_host_op = _profile_tables(torch, prof)
    serve = dict(
        arch=arch, layers=cfg.num_layers, dtype=cfg.dtype,
        params=sum(p.numel() for p in model.parameters()), build_s=build_s,
        prompt=int(prompts.shape[1]), metrics=engine.metrics, wall_s=serve_s,
        tokens_per_s=engine.metrics["tokens_out"] / serve_s, prefill_ms=loop[3],
        tick_ms=loop[4], peak_gb=peak_gb,
        distinct_outputs=len({tuple(r.output) for r in done}),
        profiled_tick=dict(
            wall_ms=tick_wall_ms, device_ms=device_ms,
            host_launches=sum(c for name, _, c in by_host_op if name.startswith("cudaLaunch")),
            top_kernels=by_kernel[:6]))
    monitor = dict(tensors=len(names), values=values, launches=mon_launches, wall_s=monitor_s)
    del model, loop, engine, done, prof
    torch.cuda.empty_cache()
    return serve, monitor


def _family_f32_decode(torch, arch: str, rows) -> dict:
    """13c for one family: float32, 2 sequences, prefill LM_F32_SPLIT tokens
    and decode the rest against `forward` on all LM_PROMPT (MoE forward at
    the dropless capacity; whisper with seeded encoder frames)."""
    from repro_torch.models.model_zoo import get_model

    kw = dict(dtype="float32")
    if arch in FAM_F32_LAYERS:
        kw["num_layers"] = FAM_F32_LAYERS[arch]
    cfg = _family_cfg(arch, **kw)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, expert_capacity_factor=float(cfg.num_experts))
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=LM_DEVICE).manual_seed(1)
    model = get_model(cfg, device=LM_DEVICE, generator=gen)
    toks = torch.from_numpy(rows[:2]).to(LM_DEVICE)
    extra = {}
    if cfg.frontend == "audio_stub":
        extra["encoder_frames"] = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen,
                                              device=LM_DEVICE) * 0.02
    with torch.no_grad():
        full, _ = model(toks, **extra)
    logits, cache = model.prefill(toks[:, :LM_F32_SPLIT], LM_PROMPT, **extra)
    steps = [logits]
    for i in range(LM_F32_SPLIT, LM_PROMPT):
        step, cache = model.decode_step(cache, toks[:, i])
        steps.append(step[:, None])
    got = torch.cat(steps, dim=1)
    err = float((got - full).abs().max())
    same_argmax = bool(torch.equal(got.argmax(-1), full.argmax(-1)))
    out = dict(layers=cfg.num_layers, max_abs_dlogits=err, argmax_equal=same_argmax,
               max_abs_logit=float(full.abs().max()),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del model, cache, full, got, steps, logits
    torch.cuda.empty_cache()
    check(err <= LM_F32_ATOL and same_argmax,
          f"13c {arch}: max |dlogits| {err:.3g} (bound {LM_F32_ATOL}), argmax equal {same_argmax}")
    return out


def _family_train_step(torch, arch: str) -> dict:
    """13e for one family: one step of its smoke config in float32, the
    same weights and batch on the card and the CPU (12d's bars; every aux
    term of the MoE loss within the loss's)."""
    import copy

    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model_zoo import get_model
    from repro_torch.optimizer import get_optimizer
    from repro_torch.optimizer.base import tree_leaves
    from repro_torch.train import TrainState, make_train_step

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    host = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    dev = copy.deepcopy(host).to(TRAIN_DEVICE)
    opt = get_optimizer("adamw", 1e-3)
    hs, ds = TrainState.create(host, opt), TrainState.create(dev, opt)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                                        .astype(np.int32))}
    if cfg.frontend == "audio_stub":
        batch["encoder_frames"] = torch.from_numpy(
            (rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32))
    hs, hm = make_train_step(host, opt)(hs, batch)
    ds, dm = make_train_step(dev, opt)(ds, {k: v.to(TRAIN_DEVICE) for k, v in batch.items()})
    aux = sorted(k for k in hm if k.startswith("aux/"))
    loss_err = max(abs(float(dm[k]) - float(hm[k])) for k in ("loss", "ce", *aux))
    gnorm_rel = abs(float(dm["grad_norm"]) / float(hm["grad_norm"]) - 1)
    param_err = max(float((a.detach().cpu() - b.detach()).abs().max())
                    for a, b in zip(tree_leaves(ds.params), tree_leaves(hs.params)))
    ok = float(dm["step_ok"]) == float(hm["step_ok"]) == 1.0
    check(ok and set(dm) == set(hm) and loss_err <= TRAIN_F32_ATOL
          and gnorm_rel <= TRAIN_F32_ATOL and param_err <= TRAIN_F32_PARAM_FRAC * 1e-3,
          f"13e {arch}: card against CPU: loss/aux {loss_err:.3g}, grad_norm {gnorm_rel:.3g} "
          f"relative, params {param_err:.3g}, step_ok {ok}")
    return dict(loss_abs=loss_err, grad_norm_rel=gnorm_rel, param_abs=param_err,
                aux={k: float(dm[k]) for k in aux})


def phase_families(torch, card: str) -> dict:
    """Phase 13 (see the module docstring): every model family on the card."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    allocated = torch.cuda.memory_allocated()
    check(allocated < FAM_MEMORY_BEFORE,
          f"13: {allocated / 1e9:.2f} GB allocated on the card before the phase")
    out = dict(select={}, serve={}, monitor={}, f32_decode={}, train={},
               cut={arch: dict(layers=n, of=get_config(arch).num_layers)
                    for arch, n in FAM_LAYERS.items()})
    for arch in FAM_ARCHS:
        out["select"][arch], batch = _family_select(torch, arch, get_config(arch).vocab_size)
        prompts = batch[:, -FAM_PROMPT.get(arch, LM_PROMPT):]
        out["serve"][arch], out["monitor"][arch] = _family_serve(torch, arch, prompts)
        out["f32_decode"][arch] = _family_f32_decode(torch, arch, batch)
        s, m, f = out["serve"][arch], out["monitor"][arch], out["f32_decode"][arch]
        sel, tick = out["select"][arch], s["profiled_tick"]
        top = [(name[:50], round(ms, 2), n) for name, ms, n in tick["top_kernels"][:3]]
        log(f"13 {arch} ({s['layers']} layers, {s['params'] / 1e9:.3f}B params, bf16): 13a "
            f"{sel['ids']} in {sel['rounds']} rounds, {sel['blocks_read']} blocks, launches "
            f"{sel['launches']}; 13b {LM_SLOTS} x {s['prompt']} prompts, {LM_NEW} new: prefill "
            f"{s['prefill_ms']:.1f} ms, tick {s['tick_ms']:.2f} ms, {s['tokens_per_s']:.1f} "
            f"tokens/s, peak {s['peak_gb']:.2f} GB, outputs equal the loop's; profiled tick "
            f"device {tick['device_ms']:.2f} of {tick['wall_ms']:.2f} ms, "
            f"{tick['host_launches']} launches, top {top}; 13d {m['tensors']} tensors bitwise, "
            f"launches {m['launches']['histogram']}; 13c f32 ({f['layers']} layers) max "
            f"|dlogits| {f['max_abs_dlogits']:.3g}, argmax equal; {card}")
    for arch in FAM_TRAIN_ARCHS:
        out["train"][arch] = _family_train_step(torch, arch)
        log(f"13e {arch} smoke f32 card against CPU: {out['train'][arch]}")
    out["select_launches"] = {name: sum(r["launches"][name] for r in out["select"].values())
                              for name in KERNEL_ROWS}
    out["monitor_launches"] = {name: sum(r["launches"][name] for r in out["monitor"].values())
                               for name in KERNEL_ROWS}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 13 took {out['phase_s']:.1f}s")
    emit({"check": "families", **out})
    return out


# ---------------------------------------------------------------------------
# phase 14: sharded serving
# ---------------------------------------------------------------------------

SHARD_RANKS = 4
SHARD_ARCH = "qwen2_5_3b"
SHARD_MOE_ARCH = "mixtral_8x7b"
# the one cut of 14d: mixtral-8x7b at 4 of its 32 layers, in float32 (its
# layers are alike; the one-process reference must fit the card alone
# before the spawn: 23.5 GB; in bf16 a router's near tie flips a token's
# experts between any two evaluations, so its logits compare in float32)
SHARD_MOE_LAYERS = 4
SHARD_MOE_SEQ = 128  # 14d: 8 x 128 tokens, forward at the dropless capacity
SHARD_F32_LAYERS = 4  # 14e: qwen2.5-3b in float32 at 4 of 36 layers
SHARD_TICKS = 4  # 14b's timed ticks and 14c's and 14e's checked ticks
SHARD_STAGES, SHARD_MICRO = 4, 4  # 14f: 36 blocks as 4 stages of 9, 4 microbatches
SHARD_ATOL, SHARD_F32_ATOL, SHARD_MARGIN = 0.05, 1e-4, 0.05
SHARD_SMOKE = False  # a CPU rehearsal sets it (smoke configs), SHARD_LAYERS and SHARD_DEVICE
SHARD_LAYERS = None
SHARD_DEVICE = "cuda"
# 14g-14i: the recurrent and audio families served tensor-parallel at full
# width and depth from seed 0, each on its mesh and in its dtype: 14a's
# prompts (ids modulo the family's vocabulary; whisper's last FAM_PROMPT
# tokens, its 1,500 encoder frames N(0, 0.02^2) from seed 0), a prefill and
# SHARD_FAM_NEW new tokens. xlstm-125m runs in float32: in bf16 the one
# process is itself 1.0-1.5 from the float32 evaluation of its weights,
# and two bf16 evaluations that differ only in the products' f32 rounding
# land 0.65 apart and pick different tokens (H100, 700 W); the reference's
# own bf16 scatters as far (tests/test_torch_xlstm_bf16.py)
SHARD_FAMILIES = (("recurrentgemma_2b", (1, 4), "bfloat16"), ("xlstm_125m", (2, 2), "float32"),
                  ("whisper_medium", (2, 2), "bfloat16"))
# a float32 family's bar in place of SHARD_ATOL: its 12 recurrent layers
# read 2.47e-4 from one process (H100, 700 W); 14e's SHARD_F32_ATOL holds
# 4 transformer layers
SHARD_FAM_F32_ATOL = 1e-3
SHARD_FAM_NEW = 8
SHARD_FAM_LAYOUT = {  # each family's plan on its mesh (full width)
    "recurrentgemma_2b": dict(attn="q_heads", mlp=True, layout={"lru": "channels"}),
    "xlstm_125m": dict(attn="replicated", mlp=False,
                       layout={"mlstm": "heads", "slstm": "heads", "slstm_ffn": "replicated"}),
    "whisper_medium": dict(attn="heads", mlp=True, layout={}),
}
# 14j: the pipeline's backward, qwen2.5-3b at 8 of its 36 layers in float32
# (TF32 off) as 4 stages of 2, SHARD_MICRO microbatches of 14a's prompts
SHARD_GRAD_LAYERS, SHARD_GRAD_RTOL = 8, 1e-4
# 14k: the FSDP x TP training layout, qwen2.5-3b at SHARD_F32_LAYERS (14e's
# cut: every FSDP byte crosses gloo) in float32, two steps; the float32
# train twins' bars (tests/torch_lm_twins.py BARS; params within 5 % of lr)
SHARD_TRAIN_STEPS = 2
SHARD_TRAIN_LOSS_ATOL, SHARD_TRAIN_NORM_RTOL, SHARD_TRAIN_PARAM_FRAC = 1e-5, 1e-5, 0.05
# AdamW's step u = m / (sqrt(v) + eps) (eps 1e-8) follows the gradient
# smoothly where its running RMS sqrt(v) is well over eps: at step 1, u =
# g / (|g| + eps) moves by eps / (|g| + eps)^2 a unit of gradient, at most
# 1e6 where |g| >= 9 eps, so 5 % of lr allows a gradient difference of
# 5e-8. Where a gradient element is near eps its f32 sum is rounding noise
# (~3e-9 apart between one process and the data and model splits, H100),
# which moves u anywhere in -1..1: there the post-step blocks are held to
# the update's range, 2 lr a step. The 5 % bar holds on every element
# whose RMS gradient sqrt(v / (1 - b2^t)) was at least this at every step
# so far (at half of it, |u| = 0.5 at step 1, the sensitivity allows 2e-9,
# under that noise: 6.4 % of lr on an H100, PERF.md)
SHARD_TRAIN_FULL_G = 9e-8
TRAIN_B2 = 0.95  # AdamW's default second-moment decay (repro_torch.optimizer.adamw)
# 14l: every other family trained under the FSDP x TP layout on 2 x 2: full
# width, float32 (TF32 off), each config's own optimizer, remat and (MoE)
# moe_impl "gather" at its capacity factor, cut only in depth (the one
# process and its float32 optimizer state must fit the card beside the
# ranks' references, and every FSDP byte crosses gloo), SHARD_TRAIN_STEPS
# steps on 14a's 8 x 256 batch (internvl2's behind its 256 vision-stub
# positions, whisper's with 14g-14i's encoder frames), held to 14k's bars.
# The ranks start step 2 from one process's parameters after step 1:
# AdamW's first step turns f32 noise on a gradient element near zero into
# a move of up to 2 lr, which xlstm-125m's exponential gates carry into
# step 2's loss (1.8e-4 apart without the restart, H100, 700 W), so step 2
# would hold step 1's noise and not step 2's computation. After step 1,
# an AdamW rank's gradient (its first moment over 1 - b1, unclipped) is
# held to one process's within SHARD_FAM_GRAD_RTOL of the leaf's largest
# |grad|, floored at SHARD_FAM_GRAD_FLOOR of the model's largest (a leaf
# whose gradient is zero in exact arithmetic, as whisper's key biases,
# holds f32 noise on both sides). The bar is about five times one
# process's own rounding: its gradient of the whole batch against the
# mean of its two halves' (what the data replicas sum), equal in exact
# arithmetic, lands up to 1.9e-4 of a leaf's largest apart for
# xlstm-125m (its mLSTM gates' and embedding's gradients sum terms that
# cancel), 1.8e-5 for whisper-medium and 3.2e-6 for recurrentgemma-2b
# (tools/torch_grad_noise.py, H100, 700 W; 14l's ranks land 2.9e-4,
# 1.8e-5 and 3.3e-6 from one process, mixtral-8x7b's 8.8e-6), so 1e-3
# for xLSTM and 1e-4 for the rest; a lost, repeated or unscaled part of
# a sharded gradient moves it by a share of its largest element, orders
# of magnitude more. Its post-step blocks within
# SHARD_TRAIN_PARAM_FRAC of lr on the elements whose clipped gradient is
# at least SHARD_TRAIN_FULL_G and whose gradient is at least
# SHARD_FAM_GRAD_MARGIN times that bar (a gradient within the bar then
# moves u = g / (|g| + eps) by at most eps / (3 |g|) <= 1/27, 3.7 % of
# lr); on the rest the update follows rounding noise and the gradient
# check holds them. Adafactor's step scales with the parameter's RMS, not
# with lr, and follows the gradient smoothly: its post-step blocks are
# held to SHARD_TRAIN_PARAM_FRAC of the leaf's largest update
# the AdamW families (internvl2-76b's smoke config takes AdamW too, in a
# CPU rehearsal)
SHARD_FAM_GRAD_RTOL = dict(mixtral_8x7b=1e-4, recurrentgemma_2b=1e-4, xlstm_125m=1e-3,
                           whisper_medium=1e-4, internvl2_76b=1e-4)
SHARD_FAM_GRAD_FLOOR, SHARD_FAM_GRAD_MARGIN = 1e-3, 4
TRAIN_B1 = 0.9  # AdamW's default first-moment decay (repro_torch.optimizer.adamw)
SHARD_FAM_TRAIN = (("mixtral_8x7b", dict(num_layers=1)), ("internvl2_76b", dict(num_layers=1)),
                   ("recurrentgemma_2b", dict(num_layers=3)), ("xlstm_125m", {}),
                   ("whisper_medium", dict(num_layers=4, encoder_layers=4)))
# 14l's uneven cases, on 1 x 4, by name: the plan each rank must take.
# recurrentgemma-2b's 10 q heads do not divide over 4 model ranks, so each
# rank attends its own 3, 3, 2 or 2 ("q_heads"). xlstm-125m's 4 heads do,
# so its case takes 6 (mLSTM heads of 256 channels, sLSTM heads of 128, at
# the full width of 768), cut to one mLSTM and one sLSTM layer: each rank
# runs its own 2, 2, 1 or 1 mLSTM and sLSTM heads ("heads"), as the pod's
# 16 model ranks run xlstm-125m's 4 (SHARD_FAM_VARIANTS)
SHARD_FAM_UNEVEN = {
    "recurrentgemma_2b": dict(attn="q_heads", layout={"lru": "channels"}),
    "xlstm_125m_h6": dict(attn="replicated", layout={"mlstm": "heads", "slstm": "heads",
                                                     "slstm_ffn": "replicated"}),
}
SHARD_FAM_UNEVEN_MESH = (1, 4)
# a 14l name that is not a family's: (its family, the fields it changes,
# the fields a CPU rehearsal's smoke config also changes: 6 heads need
# d_model 96 there)
SHARD_FAM_VARIANTS = {"xlstm_125m_h6": ("xlstm_125m", dict(num_heads=6, num_kv_heads=6,
                                                           num_layers=2, slstm_every=2),
                                          dict(d_model=96))}


def _shard_cfg(meta: dict, arch: str, **kw):
    """``arch``'s config (the smoke config in a CPU rehearsal, which may
    also set qwen's depth: its smoke config's 2 layers are under 14f's 4
    stages)."""
    from repro_torch.configs import get_config, get_smoke_config

    cfg = (get_smoke_config if meta["smoke"] else get_config)(arch)
    if arch == SHARD_ARCH and meta.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=meta["layers"])
    return dataclasses.replace(cfg, **kw)


def _fam_cfg(meta: dict, arch: str):
    """``arch``'s config for 14g-14i, in its SHARD_FAMILIES dtype."""
    return _shard_cfg(meta, arch, dtype=dict((a, dt) for a, _, dt in SHARD_FAMILIES)[arch])


def _fam_prompts(meta: dict, arch: str):
    """14a's prompts as ``arch``'s (14g-14i): ids modulo its vocabulary,
    whisper's last FAM_PROMPT tokens."""
    import numpy as np

    cfg = _shard_cfg(meta, arch)
    rows = meta["prompts"][:, -FAM_PROMPT.get(arch, meta["prompts"].shape[1]):]
    return np.ascontiguousarray(rows % cfg.vocab_size).astype(np.int32)


def _fam_frames(torch, meta: dict, arch: str, dtype):
    """Whisper's encoder frames for 14a's prompts, N(0, 0.02^2) drawn on the
    device from seed 0 (the same values in every process); None for the
    other families."""
    cfg = _shard_cfg(meta, arch)
    if cfg.frontend != "audio_stub":
        return None
    dev = meta["device"]
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (meta["prompts"].shape[0], cfg.encoder_seq, cfg.d_model)
    return (torch.randn(shape, generator=g, device=dev) * 0.02).to(dtype)


def _grad_cotangent(torch, meta: dict, d_model: int):
    """14j's loss is sum(hidden * c): c N(0, 1) from seed 1 on the device."""
    dev = meta["device"]
    g = torch.Generator(device=dev).manual_seed(1)
    return torch.randn((*meta["prompts"].shape, d_model), generator=g, device=dev)


def _sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _peak_reset(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak_gb(torch, device: str) -> float:
    return torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else 0.0


def _shard_ref_loop(torch, model, rows, steps: int, device: str, keep: int = SHARD_TICKS,
                    extra=None) -> dict:
    """The one-process greedy loop on one data replica's rows: the
    prefill's last logits, the first ``keep`` ticks' logits, every
    token and every step's top-two margin (``extra``: `prefill`'s stub
    inputs)."""
    import numpy as np

    toks = torch.from_numpy(rows).to(device)
    logits, cache = model.prefill(toks, LM_MAX_LEN, **(extra or {}))
    logits = logits[:, -1]
    kept, tokens, margins = [logits.float().cpu().numpy()], [], []
    for i in range(steps):
        top = torch.topk(logits.float(), 2, dim=-1).values
        margins.append((top[:, 0] - top[:, 1]).cpu().numpy())
        tok = torch.argmax(logits, dim=-1)
        tokens.append(tok.cpu().numpy())
        if i == steps - 1:
            break
        logits, cache = model.decode_step(cache, tok)
        if i < keep:
            kept.append(logits.float().cpu().numpy())
    return dict(logits=kept, tokens=np.stack(tokens, 1), margins=np.stack(margins, 1))


def _fam_references(torch, meta: dict) -> dict:
    """The one-process side of 14g-14i: per family, the greedy loop on each
    data replica's rows (every step's logits, tokens, margins) and the
    float32 evaluation of the same bf16 weights teacher-forced on its
    tokens; its peak. Sets ``meta["fam_forced"]``, the tokens each rank's
    teacher-forced decode feeds."""
    import copy

    import numpy as np

    from repro_torch.models.model_zoo import get_model

    dev = meta["device"]
    out, meta["fam_forced"] = {}, {}
    for arch, (nd, _), _ in SHARD_FAMILIES:
        cfg = _fam_cfg(meta, arch)
        prompts = _fam_prompts(meta, arch)
        frames = _fam_frames(torch, meta, arch, getattr(torch, cfg.dtype))
        n = prompts.shape[0] // nd
        _peak_reset(torch, dev)
        model = get_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        with torch.no_grad():
            loops = [_shard_ref_loop(
                torch, model, prompts[r : r + n], SHARD_FAM_NEW, dev, keep=SHARD_FAM_NEW,
                extra=None if frames is None else {"encoder_frames": frames[r : r + n]})
                for r in range(0, prompts.shape[0], n)]
            ref = dict(logits=[np.concatenate([lp["logits"][i] for lp in loops])
                               for i in range(SHARD_FAM_NEW)],
                       tokens=np.concatenate([lp["tokens"] for lp in loops]),
                       margins=np.concatenate([lp["margins"] for lp in loops]),
                       peak_gb=_peak_gb(torch, dev))
            forced = np.ascontiguousarray(ref["tokens"][:, : SHARD_FAM_NEW - 1])
            meta["fam_forced"][arch] = forced
            if cfg.dtype == "float32":  # its own float32 evaluation
                ref["exact"] = ref["logits"]
                out[arch] = ref
                del model
                continue
            exact = copy.deepcopy(model).float()
            exact.cfg = dataclasses.replace(cfg, dtype="float32")  # its caches' dtype too
            del model
            extra = {} if frames is None else {"encoder_frames": frames.float()}
            logits, cache = exact.prefill(torch.from_numpy(prompts).to(dev), LM_MAX_LEN, **extra)
            steps = [logits[:, -1].cpu().numpy()]
            for i in range(SHARD_FAM_NEW - 1):
                tick, cache = exact.decode_step(cache, torch.from_numpy(forced[:, i]).to(dev))
                steps.append(tick.cpu().numpy())
            ref["exact"] = steps
        out[arch] = ref
        del exact, cache, logits, tick, frames
        if dev == "cuda":
            torch.cuda.empty_cache()
    return out


def _grad_references(torch, meta: dict, where: str) -> dict:
    """The one-process side of 14j on the card: autograd of sum(hidden * c)
    through the same SHARD_GRAD_LAYERS blocks in float32 (TF32 off) on
    14a's prompts, each layer leaf's gradient saved to ``where`` (the
    ranks compare their stages' there), the table's on the prompts' ids
    (its only nonzero rows). Returns the one process's ms and peak."""
    import numpy as np

    from repro_torch.models.model_zoo import get_model
    from repro_torch.models.transformer import embed_tokens

    dev = meta["device"]
    cfg = _shard_cfg(meta, SHARD_ARCH, dtype="float32", num_layers=meta["grad_layers"])
    _peak_reset(torch, dev)
    model = get_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    for name, p in model.named_parameters():
        p.requires_grad_(name.startswith(("layers.", "embed.")))
    toks = torch.from_numpy(meta["prompts"]).to(dev)
    cot = _grad_cotangent(torch, meta, cfg.d_model)
    _sync(torch, dev)
    t = time.perf_counter()
    h = embed_tokens(model, toks)
    pos = torch.arange(toks.shape[1], dtype=torch.int32, device=dev).expand(toks.shape)
    for lp in model.layers:
        h = model._block(lp, h, pos, cfg.expert_capacity_factor)[0]
    (h * cot).sum().backward()
    _sync(torch, dev)
    wall_ms = (time.perf_counter() - t) * 1e3
    ids = np.unique(meta["prompts"])
    np.save(f"{where}/table_ids.npy", ids)
    for name, p in model.named_parameters():
        if name.startswith("layers."):
            np.save(f"{where}/{name}.npy", p.grad.cpu().numpy())
    np.save(f"{where}/embed.table.npy",
            model.embed["table"].grad[torch.from_numpy(ids).to(dev)].cpu().numpy())
    out = dict(wall_ms=wall_ms, peak_gb=_peak_gb(torch, dev))
    del model, h, cot
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _fp32_matmuls(torch) -> None:
    """TF32 off: the float32 comparisons of 14j and 14k."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _train_cfg(meta: dict):
    """14k's config: qwen2.5-3b in float32 at SHARD_F32_LAYERS layers,
    its own optimizer (AdamW) and remat ("full")."""
    return _shard_cfg(meta, SHARD_ARCH, dtype="float32", num_layers=meta["f32_layers"])


def _train_references(torch, meta: dict, where: str) -> dict:
    """The one-process side of 14k on the card: the same cut model, seed,
    batch and learning rate through SHARD_TRAIN_STEPS `make_train_step`
    steps, each step's metrics, and its parameters after each step saved
    to ``where`` (``step<i>/<name>.npy``) for the ranks to compare their
    blocks. Returns the metrics, ms a step, the peak."""
    import numpy as np

    from repro_torch.models.model_zoo import get_model
    from repro_torch.optimizer import get_optimizer
    from repro_torch.train import TrainState, make_train_step

    dev = meta["device"]
    _fp32_matmuls(torch)
    cfg = _train_cfg(meta)
    _peak_reset(torch, dev)
    model = get_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    opt = get_optimizer(cfg.optimizer, TRAIN_LR)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt)
    batch = {"tokens": torch.from_numpy(meta["prompts"]).to(dev)}
    steps, walls = [], []
    for i in range(SHARD_TRAIN_STEPS):
        _sync(torch, dev)
        t = time.perf_counter()
        state, metrics = step(state, batch)
        _sync(torch, dev)
        walls.append((time.perf_counter() - t) * 1e3)
        steps.append({k: float(v) for k, v in metrics.items()})
        Path(f"{where}/step{i}").mkdir()
        for name, p in model.named_parameters():
            np.save(f"{where}/step{i}/{name}.npy", p.detach().cpu().numpy())
    out = dict(steps=steps, step_ms=walls, peak_gb=_peak_gb(torch, dev),
               params=sum(p.numel() for p in model.parameters()))
    del model, state, step, batch
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _fam_train_cut(name: str) -> dict:
    """The fields 14l's ``name`` changes in its family's config: its cut
    in depth (SHARD_FAM_TRAIN), or a variant's (SHARD_FAM_VARIANTS)."""
    if name in SHARD_FAM_VARIANTS:
        return dict(SHARD_FAM_VARIANTS[name][1])
    return dict(dict(SHARD_FAM_TRAIN)[name])


def _fam_train_cfg(meta: dict, name: str):
    """14l's config for ``name`` (a family, or a SHARD_FAM_VARIANTS
    name): float32, cut as `_fam_train_cut` says (a CPU rehearsal's
    smoke config keeps its own depth where the cut is deeper)."""
    arch, _, smoke_kw = SHARD_FAM_VARIANTS.get(name, (name, None, {}))
    cfg = _shard_cfg(meta, arch, dtype="float32", **(smoke_kw if meta["smoke"] else {}))
    cut = {k: min(v, getattr(cfg, k)) if k in ("num_layers", "encoder_layers") else v
           for k, v in _fam_train_cut(name).items()}
    return dataclasses.replace(cfg, **cut)


def _fam_train_batch(torch, meta: dict, arch: str, rows=slice(None)) -> dict:
    """14l's batch for ``arch`` on the device, ``rows`` of it: 14a's
    prompts (ids modulo the vocabulary); internvl2's behind its
    ``vision_tokens`` positions of vision embeddings, N(0, 0.02^2) from
    seed 0 (the loss mask zeroes them, as the reference's step does);
    whisper's with 14g-14i's encoder frames."""
    import numpy as np

    cfg = _fam_train_cfg(meta, arch)
    dev = meta["device"]
    toks = meta["prompts"] % cfg.vocab_size
    batch = {}
    if cfg.frontend == "vision_stub":
        n = cfg.vision_tokens
        toks = np.concatenate([np.zeros((toks.shape[0], n), toks.dtype), toks], axis=1)
        g = torch.Generator(device=dev).manual_seed(0)
        batch["vision_embeds"] = torch.randn((toks.shape[0], n, cfg.d_model), generator=g,
                                             device=dev) * 0.02
    elif cfg.frontend == "audio_stub":
        batch["encoder_frames"] = _fam_frames(torch, meta, arch, torch.float32)
    batch["tokens"] = torch.from_numpy(np.ascontiguousarray(toks).astype(np.int32)).to(dev)
    return {k: v[rows] for k, v in batch.items()}


def _fam_train_references(torch, meta: dict, where: str) -> dict:
    """The one-process side of 14l on the card, a family at a time: the
    same cut model, seed, batch and learning rate through
    SHARD_TRAIN_STEPS `make_train_step` steps, each step's metrics and
    ms, the peak; after step 1 its parameters, gradient and scales saved
    to ``where/<arch>`` (`_fam_train_save`) for the ranks to check their
    blocks against and to start step 2 from."""
    from repro_torch.models.model_zoo import get_model
    from repro_torch.optimizer import get_optimizer
    from repro_torch.train import TrainState, make_train_step

    dev = meta["device"]
    _fp32_matmuls(torch)
    out = {}
    for arch in [a for a, _ in SHARD_FAM_TRAIN] + [n for n in SHARD_FAM_UNEVEN
                                                    if n in SHARD_FAM_VARIANTS]:
        cfg = _fam_train_cfg(meta, arch)
        _peak_reset(torch, dev)
        model = get_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        # Adafactor's post-step bar scales with the leaf's largest update
        p0 = ({} if cfg.optimizer == "adamw" else
              {name: p.detach().to("cpu", copy=True) for name, p in model.named_parameters()})
        opt = get_optimizer(cfg.optimizer, TRAIN_LR)
        state = TrainState.create(model, opt)
        step = make_train_step(model, opt)
        batch = _fam_train_batch(torch, meta, arch)
        steps, walls = [], []
        for i in range(SHARD_TRAIN_STEPS):
            _sync(torch, dev)
            t = time.perf_counter()
            state, metrics = step(state, batch)
            _sync(torch, dev)
            walls.append((time.perf_counter() - t) * 1e3)
            steps.append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                _fam_train_save(torch, model, state, p0, steps[0]["grad_norm"],
                                f"{where}/{arch}")
        out[arch] = dict(steps=steps, step_ms=walls, peak_gb=_peak_gb(torch, dev),
                         optimizer=cfg.optimizer, layers=cfg.num_layers,
                         encoder_layers=cfg.encoder_layers, tokens=list(batch["tokens"].shape),
                         params=sum(p.numel() for p in model.parameters()))
        del model, p0, state, step, batch
        if dev == "cuda":
            torch.cuda.empty_cache()
    return out


def _first_moments(state, model) -> dict:
    """{parameter name: its AdamW first moment}."""
    from repro_torch.optimizer.base import tree_leaves

    names = {id(p): name for name, p in model.named_parameters()}
    return {names[id(p)]: mu for p, mu in zip(tree_leaves(state.params),
                                               tree_leaves(state.opt_state["mu"]))}


def _fam_train_save(torch, model, state, p0: dict, grad_norm: float, where: str) -> None:
    """One process after step 1, into ``where``: each leaf's parameters
    (``p1/<name>.npy``) and, for AdamW, its gradient recovered from the
    first moment (``grad1/<name>.npy``: mu / (1 - b1), unclipped), float32;
    ``scale.json``: each gradient's largest |value| and the model's, and
    each leaf's largest |update| since ``p0`` where that holds it."""
    import numpy as np

    adamw = "mu" in state.opt_state
    for sub in ("p1", "grad1") if adamw else ("p1",):
        Path(f"{where}/{sub}").mkdir(parents=True)
    mus = _first_moments(state, model) if adamw else {}
    clip = max(1.0, grad_norm)
    scale = dict(grad_max={}, update_max={})
    with torch.no_grad():
        for name, p in model.named_parameters():
            p1 = p.detach().cpu()
            np.save(f"{where}/p1/{name}.npy", p1.numpy())
            if name in p0:
                scale["update_max"][name] = float((p1 - p0.pop(name)).abs().max())
            if adamw:
                g = mus[name].cpu() * (clip / (1 - TRAIN_B1))
                np.save(f"{where}/grad1/{name}.npy", g.numpy())
                scale["grad_max"][name] = float(g.abs().max())
    scale["tree_max"] = max(scale["grad_max"].values(), default=0.0)
    scale["clip"] = clip
    Path(f"{where}/scale.json").write_text(json.dumps(scale))


def _shard_references(torch, meta: dict) -> dict:
    """The one-process side of 14b-14f on the card, then freed: the same
    seeds, weights and inputs as the ranks'. Sets ``meta["forced"]``, the
    tokens 14b's loop fed its first ticks, which every decode check feeds."""
    import copy

    import numpy as np

    from repro_torch.models.model_zoo import get_model
    from repro_torch.models.transformer import embed_tokens

    dev = meta["device"]
    out = {}
    prompts = meta["prompts"]
    half = prompts.shape[0] // 2
    cfg = _shard_cfg(meta, SHARD_ARCH)
    _peak_reset(torch, dev)
    model = get_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        loops = [_shard_ref_loop(torch, model, prompts[r : r + half], LM_NEW, dev)
                 for r in (0, half)]
        out["serve"] = dict(
            logits=[np.concatenate([a, b]) for a, b in zip(loops[0]["logits"], loops[1]["logits"])],
            tokens=np.concatenate([lp["tokens"] for lp in loops]),
            margins=np.concatenate([lp["margins"] for lp in loops]),
            peak_gb=_peak_gb(torch, dev))
        # 14c-14e decode what this loop decoded (teacher-forced)
        meta["forced"] = np.ascontiguousarray(out["serve"]["tokens"][:, :SHARD_TICKS])
        # the same bf16 weights evaluated in float32: how far each bf16
        # evaluation (one process, sharded) rounds from it
        exact = copy.deepcopy(model).float()
        steps = []
        for r in (0, half):
            logits, cache = exact.prefill(torch.from_numpy(prompts[r : r + half]).to(dev),
                                          LM_MAX_LEN)
            kept = [logits[:, -1].cpu().numpy()]
            for i in range(SHARD_TICKS):
                tick, cache = exact.decode_step(
                    cache, torch.from_numpy(meta["forced"][r : r + half, i]).to(dev))
                kept.append(tick.cpu().numpy())
            steps.append(kept)
        out["serve"]["exact"] = [np.concatenate([a[i] for a in steps])
                                 for i in range(SHARD_TICKS + 1)]
        del exact, cache, logits, tick
        # 14f: the 36 blocks on each microbatch (the stages' shapes)
        mb = prompts.shape[0] // SHARD_MICRO
        pos = torch.arange(prompts.shape[1], dtype=torch.int32, device=dev).expand(mb, -1)
        hidden = []
        for m in range(SHARD_MICRO):
            h = embed_tokens(model, torch.from_numpy(prompts[m * mb : (m + 1) * mb]).to(dev))
            for lp in model.layers:
                h = model._block(lp, h, pos, cfg.expert_capacity_factor)[0]
            hidden.append(h.float().cpu().numpy())
        out["pipeline"] = np.concatenate(hidden)
    del model, loops
    # 14e: float32 at SHARD_F32_LAYERS layers, teacher-forced on 14b's tokens
    cfg32 = _shard_cfg(meta, SHARD_ARCH, dtype="float32", num_layers=meta["f32_layers"])
    model = get_model(cfg32, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        toks = torch.from_numpy(prompts).to(dev)
        logits, cache = model.prefill(toks, LM_MAX_LEN)
        f32 = [logits[:, -1].cpu().numpy()]
        for i in range(SHARD_TICKS):
            step, cache = model.decode_step(
                cache, torch.from_numpy(meta["forced"][:, i]).to(dev))
            f32.append(step.cpu().numpy())
    out["f32"] = f32
    del model, cache
    # 14d: the MoE cut at the dropless capacity, and each data shard alone
    cfg_moe = _shard_cfg(meta, SHARD_MOE_ARCH, num_layers=meta["moe_layers"], moe_impl="local",
                         dtype="float32")
    cfg_moe = dataclasses.replace(cfg_moe, expert_capacity_factor=float(cfg_moe.num_experts))
    model = get_model(cfg_moe, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        toks = torch.from_numpy(meta["moe_tokens"]).to(dev)
        logits, _ = model(toks)
        auxes = [model(toks[r : r + half])[1] for r in (0, half)]
    out["moe"] = dict(logits=logits.cpu().numpy(),
                      aux={k: float(sum(float(a[k]) for a in auxes) / 2) for k in auxes[0]})
    del model, logits, toks
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _shard_rank(rank, world, meta):
    """One gloo rank of phase 14 on the card: 14b at 2 x 2, 14c at 1 x 4,
    14d and 14e at 2 x 2, 14f at 4 x 1 x 1, re-meshing one process group.
    Returns numpy: this rank's logit columns of its data shard's rows,
    timings, collectives and peak memory per sub-phase."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.core import distributed
    from repro_torch.distributed import shard_model
    from repro_torch.distributed.pipeline import (
        make_pipeline_forward, stage_model, transformer_stage_fn,
    )
    from repro_torch.models.transformer import embed_tokens
    from repro_torch.serve import Request, ServeEngine

    entered_at = time.time()
    t_start = time.perf_counter()
    dev = meta["device"]
    mesh22 = distributed.init_mesh((2, 2), device_type=dev)
    mesh14 = distributed.init_mesh((1, 4), device_type=dev)
    mesh_pipe = distributed.init_mesh((SHARD_STAGES, 1, 1), ("pod", "data", "model"),
                                      device_type=dev)
    coord = dict(zip(mesh22.mesh_dim_names, mesh22.get_coordinate()))
    d = coord["data"]
    prompts, forced = meta["prompts"], meta["forced"]
    half = prompts.shape[0] // 2
    mine = slice(d * half, (d + 1) * half)
    out = dict(rank=rank, entered_at=entered_at, coord=coord,
               startup=dict(imported=T0_WALL, **distributed.RANK_STARTUP))

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    def collectives():
        return dict(distributed.COLLECTIVES)

    delta = _collective_delta

    def decode(model, toks, ticks):
        """prefill + ``ticks`` ticks fed ``forced``: logits, ms, collectives."""
        _sync(torch, dev)
        c0, t = collectives(), time.perf_counter()
        logits, cache = model.prefill(toks, LM_MAX_LEN)
        last = logits[:, -1].float().cpu().numpy()
        prefill_ms = (time.perf_counter() - t) * 1e3
        pre = delta(c0)
        kept, walls, per_tick = [last], [], []
        rows = forced[mine] if toks.shape[0] == half else forced
        for i in range(ticks):
            c0, t = collectives(), time.perf_counter()
            step, cache = model.decode_step(cache, torch.from_numpy(rows[:, i]).to(dev))
            kept.append(step.float().cpu().numpy())
            walls.append((time.perf_counter() - t) * 1e3)
            per_tick.append(delta(c0))
        return dict(logits=kept, prefill_ms=prefill_ms, tick_ms=walls, prefill_collectives=pre,
                    tick_collectives=per_tick[-1], cols=model.tp.logits, attn=model.tp.attn,
                    seq=cache.seq, cache_shape=list(cache.k[0].shape))

    # -- 14b: full-width qwen2.5-3b on 2 x 2, each data replica's engine
    cfg = _shard_cfg(meta, SHARD_ARCH)
    _peak_reset(torch, dev)
    t = time.perf_counter()
    model = shard_model(cfg, mesh22, generator=gen())
    _sync(torch, dev)
    build_s = time.perf_counter() - t
    held = sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        serve = decode(model, torch.from_numpy(prompts[mine]).to(dev), SHARD_TICKS)
    engine = ServeEngine(model, slots=half, max_len=LM_MAX_LEN)
    for i in range(mine.start, mine.stop):
        engine.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=LM_NEW))
    _sync(torch, dev)
    c0, t = collectives(), time.perf_counter()
    done = engine.run()
    _sync(torch, dev)
    serve.update(engine_s=time.perf_counter() - t, engine_collectives=delta(c0),
                 outputs={r.rid: r.output for r in done}, metrics=engine.metrics,
                 build_s=build_s, params_held=held, peak_gb=_peak_gb(torch, dev))
    out["serve"] = serve
    del model, engine, done

    # -- 14c: the same weights on 1 x 4, flash-decoding
    _peak_reset(torch, dev)
    model = shard_model(dataclasses.replace(cfg, decode_seq_shard=True), mesh14, generator=gen())
    with torch.no_grad():
        out["seq"] = decode(model, torch.from_numpy(prompts).to(dev), SHARD_TICKS)
    out["seq"].update(params_held=sum(p.numel() for p in model.parameters()),
                      peak_gb=_peak_gb(torch, dev))
    del model

    # -- 14d: the mixtral cut in float32, shard-local MoE on 2 x 2, dropless
    cfg_moe = _shard_cfg(meta, SHARD_MOE_ARCH, num_layers=meta["moe_layers"], moe_impl="local",
                         dtype="float32")
    cfg_moe = dataclasses.replace(cfg_moe, expert_capacity_factor=float(cfg_moe.num_experts))
    _peak_reset(torch, dev)
    model = shard_model(cfg_moe, mesh22, generator=gen())
    _sync(torch, dev)
    c0, t = collectives(), time.perf_counter()
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(meta["moe_tokens"][mine]).to(dev))
    _sync(torch, dev)
    out["moe"] = dict(logits=logits.float().cpu().numpy(), cols=model.tp.logits,
                      aux={k: float(v) for k, v in aux.items()}, wall_ms=(time.perf_counter() - t)
                      * 1e3, collectives=delta(c0), attn=model.tp.attn,
                      expert_block=list(model.layers[0].moe["w_gate"].shape),
                      params_held=sum(p.numel() for p in model.parameters()),
                      peak_gb=_peak_gb(torch, dev))
    del model, logits

    # -- 14e: float32 at SHARD_F32_LAYERS layers on 2 x 2
    _peak_reset(torch, dev)
    model = shard_model(_shard_cfg(meta, SHARD_ARCH, dtype="float32",
                                   num_layers=meta["f32_layers"]), mesh22, generator=gen())
    with torch.no_grad():
        out["f32"] = decode(model, torch.from_numpy(prompts[mine]).to(dev), SHARD_TICKS)
    del model

    # -- 14m: the same float32 cut on 1 x 4 without flash-decoding: qwen2.5-3b's
    # 16 q heads split 4 ways and its 2 kv heads do not ("q_heads")
    _peak_reset(torch, dev)
    model = shard_model(_shard_cfg(meta, SHARD_ARCH, dtype="float32",
                                   num_layers=meta["f32_layers"]), mesh14, generator=gen())
    toks = torch.from_numpy(prompts).to(dev)
    with torch.no_grad():
        out["q_heads"] = decode(model, toks, SHARD_TICKS)
        out["q_heads"]["flops"] = _serve_flops(torch, model, toks,
                                               torch.from_numpy(forced[:, 0]).to(dev))
    del model, toks

    # -- 14f: GPipe, the 36 blocks as 4 stages of 9
    _peak_reset(torch, dev)
    model, layers = stage_model(cfg, mesh_pipe, n_stages=SHARD_STAGES, generator=gen())
    mb = prompts.shape[0] // SHARD_MICRO
    pos = torch.arange(prompts.shape[1], dtype=torch.int32, device=dev).expand(mb, -1)

    def block(lp, h):
        return model._block(lp, h, pos, cfg.expert_capacity_factor)[0]

    fwd = make_pipeline_forward(transformer_stage_fn(block, len(layers)), mesh_pipe,
                                n_stages=SHARD_STAGES, n_microbatches=SHARD_MICRO)
    _sync(torch, dev)
    c0, t = collectives(), time.perf_counter()
    with torch.no_grad():
        hidden = fwd([layers], embed_tokens(model, torch.from_numpy(prompts).to(dev)))
    _sync(torch, dev)
    hidden = hidden.float().cpu().numpy()
    out["pipeline"] = dict(wall_ms=(time.perf_counter() - t) * 1e3, collectives=delta(c0),
                           digest=hashlib.sha256(hidden.tobytes()).hexdigest(),
                           params_held=sum(p.numel() for p in model.parameters()),
                           peak_gb=_peak_gb(torch, dev))
    if rank == 0:
        out["pipeline"]["hidden"] = hidden
    del model, layers

    # -- 14g-14i: the recurrent and audio families, each on its mesh
    meshes = {(2, 2): mesh22, (1, 4): mesh14}
    for arch, shape, _ in SHARD_FAMILIES:
        out[f"fam_{arch}"] = _fam_rank(torch, meta, arch, meshes[shape])
    # -- 14j: the pipeline's backward
    out["grad"] = _grad_rank(torch, meta, mesh_pipe)
    # -- 14k: training under the FSDP x TP layout on 2 x 2
    out["train"] = _train_rank(torch, meta, mesh22)
    # -- 14m: the same steps on 1 x 4, where the rank attends its own q heads
    out["q_heads_train"] = _train_rank(torch, meta, mesh14)
    # -- 14l: every other family's training under the same layout
    t = time.perf_counter()
    out["fam_train"] = {arch: _fam_train_rank(torch, meta, arch, mesh22)
                        for arch, _ in SHARD_FAM_TRAIN}
    # its uneven cases: the heads do not divide over the model axis
    out["fam_train_uneven"] = {name: _fam_train_rank(torch, meta, name, mesh14)
                               for name in SHARD_FAM_UNEVEN}
    out["fam_train_s"] = time.perf_counter() - t
    out["total_s"] = time.perf_counter() - t_start
    out["done_at"] = time.time()
    return out


def _serve_flops(torch, model, tokens, token) -> dict:
    """The FLOPs a rank counts (`FlopCounterMode`) in a prefill of
    ``tokens`` to LM_MAX_LEN and in one decode tick of ``token`` after it:
    what `launch.dryrun.measure` counts of the same cells on meta."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counted:
        _, cache = model.prefill(tokens, LM_MAX_LEN)
    prefill = float(counted.get_total_flops())
    with FlopCounterMode(display=False) as counted:
        model.decode_step(cache, token)
    return dict(prefill=prefill, tick=float(counted.get_total_flops()))


def _collective_delta(c0: dict, ticks: int = 1) -> dict:
    """The all-reduces since the `COLLECTIVES` snapshot ``c0``: calls,
    bytes and host seconds, per tick over ``ticks``."""
    from repro_torch.core import distributed

    c = distributed.COLLECTIVES
    return dict(calls=(c["calls"] - c0["calls"]) / ticks, bytes=(c["bytes"] - c0["bytes"]) / ticks,
                host_s=(c["seconds"] - c0["seconds"]) / ticks)


def _fam_rank(torch, meta: dict, arch: str, mesh) -> dict:
    """14g-14i on one rank: ``arch`` placed by `shard_model` on ``mesh``
    from seed 0; the prefill and SHARD_FAM_NEW - 1 ticks teacher-forced on
    the one-process tokens (every step's logit columns of the replica's
    rows, ms, collectives a tick), then each data replica's
    `ServeEngine` serving its rows (whisper's with their frames)."""
    from repro_torch.core import distributed
    from repro_torch.distributed import shard_model
    from repro_torch.serve import Request, ServeEngine

    dev = meta["device"]
    cfg = _fam_cfg(meta, arch)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    prompts = _fam_prompts(meta, arch)
    n = prompts.shape[0] // mesh.mesh.shape[0]
    mine = slice(coord["data"] * n, (coord["data"] + 1) * n)
    forced = meta["fam_forced"][arch][mine]
    _peak_reset(torch, dev)
    t = time.perf_counter()
    model = shard_model(cfg, mesh, generator=torch.Generator(device=dev).manual_seed(0))
    _sync(torch, dev)
    build_s = time.perf_counter() - t
    frames = _fam_frames(torch, meta, arch, model.dtype)
    extra = {} if frames is None else {"encoder_frames": frames[mine]}
    c0, t = dict(distributed.COLLECTIVES), time.perf_counter()
    with torch.no_grad():
        logits, cache = model.prefill(torch.from_numpy(prompts[mine]).to(dev), LM_MAX_LEN, **extra)
        kept = [logits[:, -1].float().cpu().numpy()]
        prefill_ms, pre = (time.perf_counter() - t) * 1e3, _collective_delta(c0)
        walls = []
        for i in range(SHARD_FAM_NEW - 1):
            c0, t = dict(distributed.COLLECTIVES), time.perf_counter()
            step, cache = model.decode_step(cache, torch.from_numpy(forced[:, i]).to(dev))
            kept.append(step.float().cpu().numpy())
            walls.append((time.perf_counter() - t) * 1e3)
        tick = _collective_delta(c0)
    del logits, cache, step
    engine = ServeEngine(model, slots=n, max_len=LM_MAX_LEN)
    for i in range(mine.start, mine.stop):
        engine.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=SHARD_FAM_NEW,
                              extras=None if frames is None
                              else {"encoder_frames": frames[i]}))
    _sync(torch, dev)
    c0, t = dict(distributed.COLLECTIVES), time.perf_counter()
    done = engine.run()
    _sync(torch, dev)
    out = dict(logits=kept, cols=model.tp.logits, rows=(mine.start, mine.stop), coord=coord,
               attn=model.tp.attn, mlp=model.tp.mlp, layout=model.tp.layout,
               vocab=model.tp.vocab, prefill_ms=prefill_ms, tick_ms=walls,
               prefill_collectives=pre, tick_collectives=tick, build_s=build_s,
               engine_s=time.perf_counter() - t, engine_collectives=_collective_delta(c0),
               outputs={r.rid: r.output for r in done}, metrics=engine.metrics,
               params_held=sum(p.numel() for p in model.parameters()),
               peak_gb=_peak_gb(torch, dev))
    del model, engine, done, frames
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _grad_rank(torch, meta: dict, mesh) -> dict:
    """14j on one rank: its stage of SHARD_GRAD_LAYERS float32 blocks
    (`stage_model`, seed 0), the GPipe forward and backward of
    sum(hidden * c), and each gradient the stage holds against the one
    process's (saved in ``meta["grad_dir"]``): the max |difference| and
    the leaf's largest |grad| a leaf; the table's gradient on the
    prompts' ids, and zero on every other row."""
    import numpy as np

    from repro_torch.core import distributed
    from repro_torch.distributed.pipeline import (
        make_pipeline_forward, stage_model, transformer_stage_fn,
    )
    from repro_torch.models.transformer import embed_tokens

    dev = meta["device"]
    _fp32_matmuls(torch)
    cfg = _shard_cfg(meta, SHARD_ARCH, dtype="float32", num_layers=meta["grad_layers"])
    _peak_reset(torch, dev)
    model, layers = stage_model(cfg, mesh, n_stages=SHARD_STAGES,
                                generator=torch.Generator(device=dev).manual_seed(0))
    held = [model.embed["table"], *(p for lp in layers for p in lp.parameters())]
    for p in held:
        p.requires_grad_()
    toks = torch.from_numpy(meta["prompts"]).to(dev)
    cot = _grad_cotangent(torch, meta, cfg.d_model)

    def block(lp, h):
        pos = torch.arange(h.shape[1], dtype=torch.int32, device=dev).expand(h.shape[:2])
        return model._block(lp, h, pos, cfg.expert_capacity_factor)[0]

    fwd = make_pipeline_forward(transformer_stage_fn(block, len(layers)), mesh,
                                n_stages=SHARD_STAGES, n_microbatches=SHARD_MICRO)
    _sync(torch, dev)
    c0, t = dict(distributed.COLLECTIVES), time.perf_counter()
    y = fwd([layers], embed_tokens(model, toks))
    _sync(torch, dev)
    forward_ms, c_fwd = (time.perf_counter() - t) * 1e3, _collective_delta(c0)
    c0, t = dict(distributed.COLLECTIVES), time.perf_counter()
    (y * cot).sum().backward()
    _sync(torch, dev)
    backward_ms, c_bwd = (time.perf_counter() - t) * 1e3, _collective_delta(c0)
    where = meta["grad_dir"]
    leaves = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.startswith("layers.") or p.numel() == 0:
                continue
            ref = torch.from_numpy(np.load(f"{where}/{name}.npy")).to(dev)
            leaves[name] = (float((p.grad - ref).abs().max()), float(ref.abs().max()))
        ids = torch.from_numpy(np.load(f"{where}/table_ids.npy")).to(dev)
        ref = torch.from_numpy(np.load(f"{where}/embed.table.npy")).to(dev)
        g = model.embed["table"].grad
        leaves["embed.table"] = (float((g[ids] - ref).abs().max()), float(ref.abs().max()))
        others = torch.ones(g.shape[0], dtype=torch.bool, device=dev)
        others[ids] = False
        table_zero = not bool(g[others].any())
    stage = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))["pod"]
    out = dict(stage=stage, leaves=leaves, table_zero_elsewhere=table_zero, forward_ms=forward_ms,
               backward_ms=backward_ms, forward_collectives=c_fwd, backward_collectives=c_bwd,
               params_held=sum(p.numel() for p in model.parameters()),
               peak_gb=_peak_gb(torch, dev))
    del model, layers, held, y, cot, g
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _train_rank(torch, meta: dict, mesh) -> dict:
    """14k (and 14m) on one rank: the cut qwen2.5-3b placed by
    `shard_model(serving=False)` (seed 0) on ``mesh`` (2 x 2; 14m's 1 x 4),
    its AdamW state on its blocks, SHARD_TRAIN_STEPS steps on its data
    replica's rows of 14a's batch: each step's metrics, ms, collectives
    (`COLLECTIVES`) and, after it, each block's max |difference| from
    its slice of the one process's parameters (saved in
    ``meta["train_dir"]``); the FLOPs step 1 counted (`FlopCounterMode`),
    parameters held, peak."""
    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core import distributed
    from repro_torch.distributed import shard_model
    from repro_torch.optimizer import get_optimizer
    from repro_torch.optimizer.base import tree_leaves
    from repro_torch.train import TrainState, make_train_step

    dev = meta["device"]
    _fp32_matmuls(torch)
    cfg = _train_cfg(meta)
    _peak_reset(torch, dev)
    model = shard_model(cfg, mesh, serving=False,
                        generator=torch.Generator(device=dev).manual_seed(0))
    opt = get_optimizer(cfg.optimizer, TRAIN_LR)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt)
    d = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))["data"]
    n = meta["prompts"].shape[0] // mesh.mesh.shape[0]  # rows a data replica
    batch = {"tokens": torch.from_numpy(meta["prompts"][d * n:(d + 1) * n]).to(dev)}
    steps, walls, coll, errs = [], [], [], []
    counted = FlopCounterMode(display=False)
    names = {id(p): name for name, p in model.named_parameters()}
    nu = {names[id(p)]: v for p, v in zip(tree_leaves(state.params),
                                          tree_leaves(state.opt_state["nu"]))}
    full = {name: torch.ones_like(p, dtype=torch.bool) for name, p in model.named_parameters()}
    for i in range(SHARD_TRAIN_STEPS):
        _sync(torch, dev)
        c0, t = dict(distributed.COLLECTIVES), time.perf_counter()
        if i == 0:
            with counted:
                state, metrics = step(state, batch)
        else:
            state, metrics = step(state, batch)
        _sync(torch, dev)
        walls.append((time.perf_counter() - t) * 1e3)
        coll.append(_collective_delta(c0))
        steps.append({k: float(v) for k, v in metrics.items()})
        errs.append({})
        with torch.no_grad():
            for name, p in model.named_parameters():
                whole = np.load(f"{meta['train_dir']}/step{i}/{name}.npy", mmap_mode="r")
                ref = torch.from_numpy(np.array(whole[model.tp.block(name)])).to(dev)
                # an element stays in ``full`` while its RMS gradient (the rank's
                # AdamW second moment, bias-corrected) was over the bar every step
                f = full[name]
                f &= torch.sqrt(nu[name] / (1 - TRAIN_B2 ** (i + 1))) >= SHARD_TRAIN_FULL_G
                diff = (p - ref).abs()
                errs[i][name] = (float(diff[f].max()) if f.any() else 0.0,
                                 float(diff[~f].max()) if not f.all() else 0.0,
                                 int((~f).sum()))
    out = dict(steps=steps, step_ms=walls, collectives=coll, param_err=errs,
               flops=float(counted.get_total_flops()), tokens=list(batch["tokens"].shape),
               fsdp_leaves=len(model.tp.fsdp), attn=model.tp.attn,
               params_held=sum(p.numel() for p in model.parameters()),
               state_held=sum(t.numel() for t in tree_leaves(state.opt_state)),
               peak_gb=_peak_gb(torch, dev))
    del model, state, step, batch
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _fam_train_rank(torch, meta: dict, arch: str, mesh) -> dict:
    """14l on one rank for ``arch``: the cut model placed by
    `shard_model(serving=False)` (seed 0) on ``mesh`` (2 x 2; the uneven
    case's 1 x 4), its optimizer state on its blocks, SHARD_TRAIN_STEPS
    steps on its data replica's rows of the batch: each step's metrics,
    ms and collectives; the FLOPs step 1 counted (`FlopCounterMode`);
    after step 1 each block against one process's (`_fam_train_errors`),
    then one process's parameters after step 1 in place of the rank's for
    step 2; parameters held, peak; for a MoE model, the rows each MoE
    call's expert products ran (`moe.batched_buffer`) and the rank's
    pairs."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core import distributed
    from repro_torch.distributed import shard_model
    from repro_torch.models import moe
    from repro_torch.optimizer import get_optimizer
    from repro_torch.optimizer.base import tree_leaves
    from repro_torch.train import TrainState, make_train_step

    dev = meta["device"]
    _fp32_matmuls(torch)
    cfg = _fam_train_cfg(meta, arch)
    _peak_reset(torch, dev)
    model = shard_model(cfg, mesh, serving=False,
                        generator=torch.Generator(device=dev).manual_seed(0))
    opt = get_optimizer(cfg.optimizer, TRAIN_LR)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt)
    d = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))["data"]
    n = meta["prompts"].shape[0] // mesh.mesh.shape[0]  # rows a data replica
    batch = _fam_train_batch(torch, meta, arch, slice(d * n, (d + 1) * n))
    steps, walls, coll, errs = [], [], [], {}
    counted = FlopCounterMode(display=False)
    for i in range(SHARD_TRAIN_STEPS):
        _sync(torch, dev)
        c0, t = dict(distributed.COLLECTIVES), time.perf_counter()
        if i == 0:
            with counted:
                state, metrics = step(state, batch)
        else:
            state, metrics = step(state, batch)
        _sync(torch, dev)
        walls.append((time.perf_counter() - t) * 1e3)
        coll.append(_collective_delta(c0))
        steps.append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            errs = _fam_train_errors(torch, model, state, steps[0]["grad_norm"],
                                     SHARD_FAM_GRAD_RTOL.get(
                                         SHARD_FAM_VARIANTS.get(arch, (arch,))[0]),
                                     f"{meta['fam_train_dir']}/{arch}", dev)
    experts = None
    if cfg.num_experts:
        t_rank = batch["tokens"].numel()
        pairs = t_rank * cfg.experts_per_token
        capacity = int(max(1, round(pairs * mesh.mesh.shape[0] / cfg.num_experts
                                    * cfg.expert_capacity_factor)))
        batched = moe.batched_buffer(cfg.num_experts, capacity, t_rank, cfg.experts_per_token)
        experts = dict(pairs=pairs, capacity=capacity,
                       rows=cfg.num_experts * min(capacity, t_rank) if batched else pairs,
                       batched_rows=cfg.num_experts * min(capacity, t_rank))
    peak = _peak_gb(torch, dev)
    out = dict(steps=steps, step_ms=walls, collectives=coll, errs=errs, experts=experts,
               flops=float(counted.get_total_flops()),
               fsdp_leaves=len(model.tp.fsdp), attn=model.tp.attn, layout=dict(model.tp.layout),
               logits=model.tp.logits, optimizer=cfg.optimizer,
               params_held=sum(p.numel() for p in model.parameters()),
               state_held=sum(t.numel() for t in tree_leaves(state.opt_state)), peak_gb=peak)
    del model, state, step, batch
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _fam_train_errors(torch, model, state, grad_norm: float, rtol, where: str,
                      dev: str) -> dict:
    """Each block after step 1 against its slice of one process's in
    ``where`` (`_fam_train_save`), which then replaces it. AdamW: (the
    largest |gradient difference|, its bar (``rtol`` of the leaf's largest
    |grad|, floored), the largest |parameter difference| on the elements
    the post-step bar holds, their count, the block's size); Adafactor:
    (the largest |parameter difference|, its bar). The gradients are the
    first moments over 1 - b1, unclipped."""
    import numpy as np

    scale = json.loads(Path(f"{where}/scale.json").read_text())
    adamw = "mu" in state.opt_state
    mus = _first_moments(state, model) if adamw else {}
    clip = max(1.0, grad_norm)
    errs = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            index = model.tp.block(name)

            def block(sub):
                whole = np.load(f"{where}/{sub}/{name}.npy", mmap_mode="r")
                return torch.from_numpy(np.array(whole[index])).to(dev)

            p1 = block("p1")
            diff = (p - p1).abs()
            if adamw:
                want = block("grad1")
                bar = rtol * max(scale["grad_max"][name],
                                 SHARD_FAM_GRAD_FLOOR * scale["tree_max"])
                g_err = float((mus[name] * (clip / (1 - TRAIN_B1)) - want).abs().max())
                # the clipped gradient over 9 eps and the gradient well over its bar
                held = ((want.abs() >= SHARD_TRAIN_FULL_G * scale["clip"])
                        & (want.abs() >= SHARD_FAM_GRAD_MARGIN * bar))
                errs[name] = (g_err, bar, float(diff[held].max()) if held.any() else 0.0,
                              int(held.sum()), diff.numel())
            else:
                errs[name] = (float(diff.max()),
                              SHARD_TRAIN_PARAM_FRAC * scale["update_max"][name])
            p.copy_(p1)  # step 2 starts from one process's parameters
    return errs


def _check_fam_train(ranks, rf: dict, gate, dev: str) -> dict:
    """14l's checks (phase 14's ``gate``) for every family: each rank's
    metrics the same bits as rank 0's at every step, step_ok 1, the
    second loss below the first, ``drop_frac`` one process's (the kept
    pairs), no rank holding the whole model, each rank's peak under one
    process's; against one process, 14k's bars at every step (loss and
    every aux term within SHARD_TRAIN_LOSS_ATOL, grad_norm and param_norm
    within SHARD_TRAIN_NORM_RTOL relative); after step 1 every AdamW
    gradient block within its bar and the post-step blocks within
    SHARD_TRAIN_PARAM_FRAC of lr where that bar holds them (the
    SHARD_FAM_TRAIN comment), on some elements of every family; an
    Adafactor leaf's within SHARD_TRAIN_PARAM_FRAC of its largest update;
    every rank's counted FLOPs the same. The same for SHARD_FAM_UNEVEN's
    cases on 1 x 4, where no leaf splits over "data" and each rank takes
    the plan SHARD_FAM_UNEVEN gives, with uneven heads, so the ranks'
    FLOPs differ (15a holds each rank's to the dry run at its
    coordinate). Returns each case's errors and what it ran (an uneven
    case under "<name> uneven")."""
    out = {}
    cells = [(arch, arch, lambda rk, a=arch: rk["fam_train"][a]) for arch, _ in SHARD_FAM_TRAIN]
    cells += [(f"{name} uneven", name, lambda rk, n=name: rk["fam_train_uneven"][n])
              for name in SHARD_FAM_UNEVEN]
    for key, arch, of in cells:
        want = rf[arch]
        err = dict(loss=[], grad_norm=[], param_norm=[], grad=0.0, params=0.0,
                   held_elements=0, elements=0)
        label = f"14l {key}"
        uneven = key != arch
        adamw = want["optimizer"] == "adamw"
        for i, w in enumerate(want["steps"]):
            losses = [k for k in w if k in ("loss", "ce") or k.startswith("aux/")]
            got = of(ranks[0])["steps"][i]
            if set(got) != set(w):
                gate(False, f"{label} step {i}: metrics {sorted(got)}, one process {sorted(w)}")
                continue
            err["loss"].append(max(abs(got[k] - w[k]) for k in losses))
            for k in ("grad_norm", "param_norm"):
                err[k].append(abs(got[k] / w[k] - 1))
            if "aux/drop_frac" in w:
                gate(got["aux/drop_frac"] == w["aux/drop_frac"],
                     f"{label} step {i}: drop_frac {got['aux/drop_frac']}, one process "
                     f"{w['aux/drop_frac']} (the kept pairs differ)")
            gate(err["loss"][i] <= SHARD_TRAIN_LOSS_ATOL, f"{label} step {i}: loss / aux "
                 f"{err['loss'][i]:.3g} from one process (bar {SHARD_TRAIN_LOSS_ATOL})")
            for k in ("grad_norm", "param_norm"):
                gate(err[k][i] <= SHARD_TRAIN_NORM_RTOL, f"{label} step {i}: {k} "
                     f"{err[k][i]:.3g} relative from one process (bar {SHARD_TRAIN_NORM_RTOL})")
        for rk in ranks:
            g = of(rk)
            if uneven:
                plan = SHARD_FAM_UNEVEN[arch]
                gate(g["attn"] == plan["attn"] and g["layout"] == plan["layout"]
                     and g["fsdp_leaves"] == 0,
                     f"{label} rank {rk['rank']}: attention {g['attn']}, layout {g['layout']}, "
                     f"{g['fsdp_leaves']} leaves over 'data'; not {plan}")
            else:
                gate(g["fsdp_leaves"] > 0, f"{label} rank {rk['rank']}: no leaf split over 'data'")
                gate(g["flops"] == of(ranks[0])["flops"], f"{label} rank {rk['rank']}: counted "
                     f"{g['flops']} FLOPs in step 1, rank 0 {of(ranks[0])['flops']}")
            for i, got in enumerate(g["steps"]):
                gate(got == of(ranks[0])["steps"][i],
                     f"{label} step {i}: rank {rk['rank']}'s metrics differ from rank 0's")
                gate(got["step_ok"] == 1.0, f"{label} step {i} rank {rk['rank']}: step_ok "
                     f"{got['step_ok']}")
            for leaf, e in g["errs"].items():
                if adamw:
                    g_err, bar, p_err, held, n = e
                    err["grad"] = max(err["grad"], g_err / bar)
                    err["params"] = max(err["params"], p_err)
                    err["held_elements"] += held
                    err["elements"] += n
                    gate(g_err <= bar, f"{label} rank {rk['rank']}: {leaf}'s gradient "
                         f"{g_err:.3g} from one process's after step 1 (bar {bar:.3g})")
                    gate(p_err <= SHARD_TRAIN_PARAM_FRAC * TRAIN_LR,
                         f"{label} rank {rk['rank']}: {leaf} {p_err:.3g} from one process after "
                         f"step 1 where its gradient holds the update (bar "
                         f"{SHARD_TRAIN_PARAM_FRAC * TRAIN_LR:.3g})")
                else:
                    p_err, bar = e
                    err["params"] = max(err["params"], p_err / bar if bar else p_err)
                    gate(p_err <= bar, f"{label} rank {rk['rank']}: {leaf} {p_err:.3g} from "
                         f"one process after step 1 (bar {bar:.3g})")
            gate(g["steps"][-1]["loss"] < g["steps"][0]["loss"],
                 f"{label} rank {rk['rank']}: losses {[s['loss'] for s in g['steps']]} do not fall")
            gate(g["params_held"] < want["params"],
                 f"{label} rank {rk['rank']}: holds {g['params_held']} of {want['params']} "
                 "parameters")
            if dev == "cuda":
                gate(g["peak_gb"] < want["peak_gb"],
                     f"{label} rank {rk['rank']}: peak {g['peak_gb']:.2f} GB, one process "
                     f"{want['peak_gb']:.2f} GB")
        if adamw:
            gate(err["held_elements"] > 0, f"{label}: the post-step bar holds no element")
        r0 = of(ranks[0])
        out[key] = dict(
            err=err, optimizer=r0["optimizer"], attn=r0["attn"], layout=r0["layout"],
            logits=r0["logits"], layers=want["layers"], encoder_layers=want["encoder_layers"],
            tokens=want["tokens"], loss=[s["loss"] for s in r0["steps"]],
            loss_reference=[s["loss"] for s in want["steps"]],
            aux={k: v for k, v in r0["steps"][-1].items() if k.startswith("aux/")},
            step_ms=[of(rk)["step_ms"] for rk in ranks],
            collectives=[of(rk)["collectives"] for rk in ranks],
            params_held=[of(rk)["params_held"] for rk in ranks],
            state_held=[of(rk)["state_held"] for rk in ranks],
            params_whole=want["params"], peak_gb=[of(rk)["peak_gb"] for rk in ranks],
            one_process_step_ms=want["step_ms"], one_process_peak_gb=want["peak_gb"],
            mesh=list(SHARD_FAM_UNEVEN_MESH) if uneven else [2, 2], flops=r0["flops"],
            flops_ranks=[of(rk)["flops"] for rk in ranks], ranks=[rk["rank"] for rk in ranks],
            experts=r0["experts"])
    return out


def _check_train(ranks, key: str, label: str, rt: dict, gate, dev: str, layout_ok) -> tuple:
    """14k's checks (phase 14's ``gate``) of each rank's ``key`` steps
    (`_train_rank`) against one process's ``rt``: the layout
    (``layout_ok``), every rank's metrics the same bits, step_ok 1, loss
    within SHARD_TRAIN_LOSS_ATOL, grad_norm and param_norm within
    SHARD_TRAIN_NORM_RTOL, every block within SHARD_TRAIN_PARAM_FRAC of lr
    where the RMS gradient was over 9 eps and within 2 lr a step elsewhere,
    the loss falling, no rank holding the whole model, each peak under
    one process's. Returns (the largest errors, the elements a step under
    9 eps summed over the ranks)."""
    train_err = dict(loss=0.0, grad_norm=0.0, param_norm=0.0, params=0.0, params_small_g=0.0)
    small = [0] * SHARD_TRAIN_STEPS
    for rk in ranks:
        g = rk[key]
        gate(layout_ok(g),
             f"{label} rank {rk['rank']}: layout {g['attn']}, {g['fsdp_leaves']} leaves over "
             "'data'")
        for i, (got, want) in enumerate(zip(g["steps"], rt["steps"])):
            gate(got == ranks[0][key]["steps"][i],
                 f"{label} step {i}: rank {rk['rank']}'s metrics differ from rank 0's")
            gate(got["step_ok"] == 1.0,
                 f"{label} step {i} rank {rk['rank']}: step_ok {got['step_ok']}")
            train_err["loss"] = max(train_err["loss"], abs(got["loss"] - want["loss"]))
            for k in ("grad_norm", "param_norm"):
                train_err[k] = max(train_err[k], abs(got[k] / want[k] - 1))
            for leaf, (err, err_small, n_small) in g["param_err"][i].items():
                train_err["params"] = max(train_err["params"], err)
                train_err["params_small_g"] = max(train_err["params_small_g"], err_small)
                small[i] += n_small
                gate(err <= SHARD_TRAIN_PARAM_FRAC * TRAIN_LR,
                     f"{label} step {i} rank {rk['rank']}: {leaf} {err:.3g} from one process "
                     f"where its RMS gradient is over 9 eps (bar "
                     f"{SHARD_TRAIN_PARAM_FRAC * TRAIN_LR:.3g})")
                gate(err_small <= 2 * (i + 1) * TRAIN_LR,
                     f"{label} step {i} rank {rk['rank']}: {leaf} {err_small:.3g} from one "
                     f"process where its gradient is near AdamW's eps (bar {2 * (i + 1)} x lr)")
        gate(g["steps"][-1]["loss"] < g["steps"][0]["loss"],
             f"{label} rank {rk['rank']}: losses {[s['loss'] for s in g['steps']]} do not fall")
        gate(g["params_held"] < rt["params"],
             f"{label} rank {rk['rank']}: holds {g['params_held']} of {rt['params']} parameters")
        if dev == "cuda":
            gate(g["peak_gb"] < rt["peak_gb"],
                 f"{label} rank {rk['rank']}: peak {g['peak_gb']:.2f} GB, one process "
                 f"{rt['peak_gb']:.2f} GB")
    gate(train_err["loss"] <= SHARD_TRAIN_LOSS_ATOL,
         f"{label}: loss {train_err['loss']:.3g} from one process (bar {SHARD_TRAIN_LOSS_ATOL})")
    gate(max(train_err["grad_norm"], train_err["param_norm"]) <= SHARD_TRAIN_NORM_RTOL,
         f"{label}: grad_norm / param_norm {train_err['grad_norm']:.3g} / "
         f"{train_err['param_norm']:.3g} relative (bar {SHARD_TRAIN_NORM_RTOL})")
    return train_err, small


def _check_q_heads(ranks, ref: dict, rt: dict, gate, dev: str, max_err, tokens) -> dict:
    """14m's checks (phase 14's ``gate``): on 1 x 4 every rank attends its
    own q heads ("q_heads"); the prefill's and SHARD_TICKS ticks' float32
    logits within 14e's SHARD_F32_ATOL of one process, each rank's cache
    the one kv head its q heads read; the training steps under 14k's
    bars (`_check_train`); every rank's counted FLOPs the same."""
    import numpy as np

    logits = [_assemble(ranks, "q_heads", lambda rk: (0, tokens[0]), i)
              for i in range(SHARD_TICKS + 1)]
    errs = [max_err(g, w) for g, w in zip(logits, ref["f32"])]
    gate(max(errs) <= SHARD_F32_ATOL,
         f"14m: float32 logits {errs} from one process (bar {SHARD_F32_ATOL})")
    for rk in ranks:
        q = rk["q_heads"]
        gate(q["attn"] == "q_heads" and q["seq"] is None and q["cache_shape"][2] == 1,
             f"14m rank {rk['rank']}: layout {q['attn']}, cache {q['seq']} "
             f"{q['cache_shape']}")
        for key in ("q_heads", "q_heads_train"):
            gate(rk[key]["flops"] == ranks[0][key]["flops"],
                 f"14m rank {rk['rank']}: counted {rk[key]['flops']} FLOPs, rank 0 "
                 f"{ranks[0][key]['flops']}")
    train_err, small = _check_train(ranks, "q_heads_train", "14m", rt, gate, dev,
                                    lambda g: g["attn"] == "q_heads" and g["fsdp_leaves"] == 0)
    r0, t0 = ranks[0]["q_heads"], ranks[0]["q_heads_train"]
    return dict(
        mesh=[1, 4], layers=SHARD_F32_LAYERS, dtype="float32", tokens=list(tokens),
        attn=r0["attn"],
        cache_shape=r0["cache_shape"], max_abs_dlogits=errs, bar=SHARD_F32_ATOL,
        prefill_ms=[rk["q_heads"]["prefill_ms"] for rk in ranks],
        tick_ms=[rk["q_heads"]["tick_ms"] for rk in ranks],
        tick_ms_median=float(np.median(r0["tick_ms"])),
        prefill_collectives=r0["prefill_collectives"], tick_collectives=r0["tick_collectives"],
        flops=r0["flops"], train_flops=t0["flops"],
        train=dict(err=train_err, small_g_elements=[n / len(ranks) for n in small],
                   loss=[s["loss"] for s in t0["steps"]],
                   loss_reference=[s["loss"] for s in rt["steps"]],
                   step_ms=[rk["q_heads_train"]["step_ms"] for rk in ranks],
                   collectives=[rk["q_heads_train"]["collectives"] for rk in ranks],
                   params_held=[rk["q_heads_train"]["params_held"] for rk in ranks],
                   state_held=[rk["q_heads_train"]["state_held"] for rk in ranks],
                   peak_gb=[rk["q_heads_train"]["peak_gb"] for rk in ranks]))


def _assemble(ranks, key: str, rows_of, index=None) -> "np.ndarray":
    """The whole logits from the ranks' (rows, column blocks)."""
    import numpy as np

    parts = {}
    for rk in ranks:
        got = rk[key]
        arr = got["logits"] if index is None else got["logits"][index]
        lo, hi = got["cols"] or (0, arr.shape[-1])
        r0, r1 = rows_of(rk)
        parts[(r0, lo)] = (r1, hi, arr)
    n_rows = max(v[0] for v in parts.values())
    n_cols = max(v[1] for v in parts.values())
    whole = np.full((n_rows, *arr.shape[1:-1], n_cols), np.nan, np.float32)
    for (r0, lo), (r1, hi, arr) in parts.items():
        whole[r0:r1, ..., lo:hi] = arr
    return whole


def phase_sharded(torch, card: str) -> dict:
    """Phase 14 (see the module docstring): sharded serving on gloo ranks
    sharing the card."""
    import numpy as np

    from repro_torch.core import distributed

    t_phase = time.perf_counter()
    dev = SHARD_DEVICE
    if dev == "cuda":
        allocated = torch.cuda.memory_allocated()
        check(allocated < FAM_MEMORY_BEFORE,
              f"14: {allocated / 1e9:.2f} GB allocated on the card before the phase")
    out = {}
    # -- 14a: the selection, in this process
    vocab = _shard_cfg(dict(smoke=SHARD_SMOKE), SHARD_ARCH).vocab_size
    out["select"], batch = _family_select(torch, SHARD_ARCH, vocab, label="14a")
    prompts = np.ascontiguousarray(batch[:, -LM_PROMPT:]).astype(np.int32)
    meta = dict(device=dev, smoke=SHARD_SMOKE, layers=SHARD_LAYERS, prompts=prompts,
                moe_layers=SHARD_MOE_LAYERS, f32_layers=SHARD_F32_LAYERS,
                grad_layers=SHARD_GRAD_LAYERS,
                moe_tokens=np.random.default_rng(0).integers(
                    0, _shard_cfg(dict(smoke=SHARD_SMOKE), SHARD_MOE_ARCH).vocab_size,
                    (prompts.shape[0], SHARD_MOE_SEQ)).astype(np.int32))
    # -- the one-process references, freed before the spawn
    t = time.perf_counter()
    ref = _shard_references(torch, meta)
    ref["fam"] = _fam_references(torch, meta)
    meta["grad_dir"] = tempfile.mkdtemp(prefix="chip_smoke_14j_")
    meta["train_dir"] = tempfile.mkdtemp(prefix="chip_smoke_14k_")
    meta["fam_train_dir"] = tempfile.mkdtemp(prefix="chip_smoke_14l_")
    try:
        ref["grad"] = _grad_references(torch, meta, meta["grad_dir"])
        ref["train"] = _train_references(torch, meta, meta["train_dir"])
        t_fam = time.perf_counter()
        ref["fam_train"] = _fam_train_references(torch, meta, meta["fam_train_dir"])
        out["fam_train_reference_s"] = time.perf_counter() - t_fam
        out["reference_s"] = time.perf_counter() - t
        allocated = torch.cuda.memory_allocated() / 1e9 if dev == "cuda" else 0.0
        # -- the ranks: one spawn runs 14b-14j
        t, spawned_at = time.perf_counter(), time.time()
        ranks = distributed.run_ranks(_shard_rank, SHARD_RANKS, meta, backend="gloo",
                                      device_type=dev, timeout=900)
    finally:
        shutil.rmtree(meta["grad_dir"], ignore_errors=True)
        shutil.rmtree(meta["train_dir"], ignore_errors=True)
        shutil.rmtree(meta["fam_train_dir"], ignore_errors=True)
    out["ranks_s"] = time.perf_counter() - t
    out["allocated_before_spawn_gb"] = allocated
    out["rank_startup_s"] = [rk["entered_at"] - spawned_at for rk in ranks]
    out["rank_total_s"] = [rk["total_s"] for rk in ranks]
    half = prompts.shape[0] // 2
    failed = []

    def gate(cond: bool, msg: str) -> None:
        """A phase-14 check: every failure is reported, then the phase raises."""
        if not cond:
            failed.append(msg)
            log(f"FAILED {msg}")

    def replica_rows(rk):
        d = rk["coord"]["data"]
        return d * half, (d + 1) * half

    def max_err(got, want):
        check(not np.isnan(got).any(), "14: the ranks' logit blocks do not tile the logits")
        return float(np.abs(got - want).max())

    # -- 14b: logits, tokens up to the first near tie, the engines' metrics
    rs = ref["serve"]
    errs = [max_err(_assemble(ranks, "serve", replica_rows, i), rs["logits"][i])
            for i in range(2)]
    tp_first = [_assemble(ranks, "serve", replica_rows, i) for i in range(2)]
    # how far each bf16 evaluation is from the bf16 weights in float32
    exact_err = dict(one_process=[float(np.abs(rs["logits"][i] - rs["exact"][i]).max())
                                  for i in range(SHARD_TICKS + 1)],
                     sharded=[float(np.abs(tp_first[i] - rs["exact"][i]).max())
                              for i in range(2)],
                     max_abs_logit=float(np.abs(rs["exact"][0]).max()))
    log(f"14b: prefill / first-tick max |dlogits| {errs} from one process; from the float32 "
        f"evaluation of the same weights: one process {exact_err['one_process']}, sharded "
        f"{exact_err['sharded']} (largest |logit| {exact_err['max_abs_logit']:.3g})")
    # the bars: at 36 bf16 layers the one-process model is itself delta =
    # 0.09-0.10 from the float32 evaluation of its weights (H100, 700 W),
    # above 0.05; so each step holds the sharded logits within
    # max(0.05, 2 delta) of one process and within delta + 0.05 of float32
    bars = [max(SHARD_ATOL, 2 * d) for d in exact_err["one_process"]]
    gate(all(e <= b for e, b in zip(errs, bars)),
         f"14b: prefill / first-tick logits {errs} from one process (bars {bars[:2]})")
    gate(all(e <= d + SHARD_ATOL for e, d in zip(exact_err["sharded"],
                                                 exact_err["one_process"])),
         f"14b: {exact_err['sharded']} from float32, one process {exact_err['one_process'][:2]}")
    tokens = {}
    for rk in ranks:
        for rid, output in rk["serve"]["outputs"].items():
            gate(tokens.setdefault(rid, output) == output,
                  f"14b: the model ranks of request {rid}'s replica picked different tokens")
    compared, ties = 0, 0
    for rid in range(prompts.shape[0]):
        low = np.flatnonzero(rs["margins"][rid] < SHARD_MARGIN)
        upto = int(low[0]) if low.size else LM_NEW
        ties += int(low.size > 0)
        gate(tokens[rid][:upto] == rs["tokens"][rid][:upto].tolist(),
              f"14b request {rid}: tokens {tokens[rid][:upto]} differ from one process's "
              f"{rs['tokens'][rid][:upto].tolist()} before its first near tie (step {upto})")
        compared += upto
    want_metrics = {"prefills": 1, "decode_ticks": LM_NEW - 1, "tokens_out": half * LM_NEW}
    for rk in ranks:
        gate(rk["serve"]["metrics"] == want_metrics,
              f"14b rank {rk['rank']}: metrics {rk['serve']['metrics']}, not {want_metrics}")
        gate(rk["serve"]["attn"] == "heads" and rk["serve"]["seq"] is None,
              f"14b rank {rk['rank']}: layout {rk['serve']['attn']}, cache {rk['serve']['seq']}")
    # -- 14c: flash-decoding, SHARD_TICKS ticks
    seq_logits = [_assemble(ranks, "seq", lambda rk: (0, prompts.shape[0]), i)
                  for i in range(SHARD_TICKS + 1)]
    errs_c = [max_err(g, w) for g, w in zip(seq_logits, rs["logits"])]
    exact_err["sharded_seq"] = [float(np.abs(g - w).max())
                                for g, w in zip(seq_logits, rs["exact"])]
    log(f"14c: max |dlogits| {errs_c} from one process; from the float32 evaluation "
        f"{exact_err['sharded_seq']}")
    gate(all(e <= b for e, b in zip(errs_c, bars)),
         f"14c: logits {errs_c} from one process (bars {bars})")
    gate(all(e <= d + SHARD_ATOL for e, d in zip(exact_err["sharded_seq"],
                                                 exact_err["one_process"])),
         f"14c: {exact_err['sharded_seq']} from float32, one process {exact_err['one_process']}")
    for rk in ranks:
        gate(rk["seq"]["attn"] == "whole" and rk["seq"]["seq"] is not None,
              f"14c rank {rk['rank']}: layout {rk['seq']['attn']}, cache {rk['seq']['seq']}")
    # -- 14d: the MoE cut
    rm = ref["moe"]
    err_d = max_err(_assemble(ranks, "moe", replica_rows), rm["logits"])
    gate(err_d <= SHARD_ATOL, f"14d: forward logits {err_d:.3g} from one process")
    aux_err = {}
    for rk in ranks:
        got = rk["moe"]["aux"]
        gate(set(got) == set(rm["aux"]) and got["drop_frac"] == 0.0,
              f"14d rank {rk['rank']}: aux {got}")
        for k in ("load_balance_loss", "router_z_loss"):
            aux_err[k] = max(aux_err.get(k, 0.0), abs(got[k] - rm["aux"][k]))
    gate(max(aux_err.values()) <= SHARD_ATOL,
          f"14d: aux terms {aux_err} from the data shards' one-process mean")
    # -- 14e: float32
    errs_e = [max_err(_assemble(ranks, "f32", replica_rows, i), ref["f32"][i])
              for i in range(SHARD_TICKS + 1)]
    gate(max(errs_e) <= SHARD_F32_ATOL, f"14e: float32 logits {errs_e} (bar {SHARD_F32_ATOL})")
    # -- 14f: every stage returns the last stage's hidden states
    r0 = ranks[0]["pipeline"]
    gate(len({rk["pipeline"]["digest"] for rk in ranks}) == 1,
          "14f: the stages returned different hidden states")
    err_f = float(np.abs(r0["hidden"] - ref["pipeline"]).max())
    gate(err_f <= SHARD_ATOL, f"14f: hidden states {err_f:.3g} from one process")
    # -- 14g-14i: each family's logits, tokens, metrics and layout
    fam_out = {}
    for (arch, shape, _), sub in zip(SHARD_FAMILIES, "ghi"):
        fam_out[arch] = _check_family(torch, ranks, ref["fam"][arch], meta, arch, shape,
                                      f"14{sub}", gate, max_err)
    # -- 14j: every gradient a stage holds against the one process's
    per = meta["grad_layers"] // SHARD_STAGES
    layer_leaves = sum(1 for n, _ in _meta_model(torch, meta).named_parameters()
                       if n.startswith("layers.0."))
    grad_rel = 0.0
    for rk in ranks:
        g = rk["grad"]
        s0 = g["stage"] * per
        want = {f"layers.{i}" for i in range(s0, s0 + per)}
        got_layers = {".".join(n.split(".")[:2]) for n in g["leaves"] if n != "embed.table"}
        gate(got_layers == want and len(g["leaves"]) == per * layer_leaves + 1,
             f"14j stage {g['stage']}: gradients of {sorted(got_layers)} "
             f"({len(g['leaves'])} leaves), not of {sorted(want)}")
        for name, (err, big) in g["leaves"].items():
            grad_rel = max(grad_rel, err / big if big else err)
            gate(err <= SHARD_GRAD_RTOL * big,
                 f"14j stage {g['stage']} {name}: |dgrad| {err:.3g} over {SHARD_GRAD_RTOL} x "
                 f"its largest |grad| {big:.3g}")
        gate(g["table_zero_elsewhere"],
             f"14j stage {g['stage']}: the table's gradient is nonzero off the prompts' ids")
    # -- 14k: every rank's step against one process's, after each step
    rt = ref["train"]
    train_err, small = _check_train(ranks, "train", "14k", rt, gate, dev,
                                    lambda g: g["attn"] == "heads" and g["fsdp_leaves"] > 0)
    # -- 14m: "q_heads" on 1 x 4, 14e's float32 cut served and 14k's trained
    q_heads = _check_q_heads(ranks, ref, rt, gate, dev, max_err, prompts.shape)
    # -- 14l: every other family's steps against one process's
    fam_train = _check_fam_train(ranks, ref["fam_train"], gate, dev)
    # no rank holds the whole model; each rank's peak under one process's
    whole = sum(p.numel() for p in _meta_model(torch, meta).parameters())
    peaks = [max(rk[k]["peak_gb"] for k in ("serve", "seq", "pipeline")) for rk in ranks]
    for rk in ranks:
        for k in ("serve", "seq", "pipeline"):
            gate(rk[k]["params_held"] < whole,
                  f"14 rank {rk['rank']}: {k} holds {rk[k]['params_held']} of {whole} parameters")
    if dev == "cuda":
        gate(max(peaks) < rs["peak_gb"],
              f"14: a rank's peak {max(peaks):.2f} GB is not under one process's "
              f"{rs['peak_gb']:.2f} GB")

    def tick_stats(rk, key):
        m = rk[key]
        return dict(prefill_ms=m["prefill_ms"], tick_ms=m["tick_ms"],
                    prefill_collectives=m["prefill_collectives"],
                    tick_collectives=m["tick_collectives"])

    serve = [rk["serve"] for rk in ranks]
    engine_s = max(s["engine_s"] for s in serve)
    out.update(
        serve=dict(mesh=[2, 2], max_abs_dlogits=errs, bars=bars, from_float32=exact_err,
                   tokens_compared=compared,
                   rows_with_near_tie=ties, metrics=serve[0]["metrics"],
                   tokens_per_s_replica=[half * LM_NEW / s["engine_s"] for s in serve[::2]],
                   tokens_per_s=prompts.shape[0] * LM_NEW / engine_s,
                   engine_s=[s["engine_s"] for s in serve],
                   engine_collectives=[s["engine_collectives"] for s in serve],
                   build_s=[s["build_s"] for s in serve],
                   per_rank=[tick_stats(rk, "serve") for rk in ranks],
                   params_held=[s["params_held"] for s in serve], params_whole=whole,
                   peak_gb=[s["peak_gb"] for s in serve],
                   one_process_peak_gb=rs["peak_gb"]),
        seq=dict(mesh=[1, 4], max_abs_dlogits=errs_c,
                 cache_shape=ranks[0]["seq"]["cache_shape"],
                 per_rank=[tick_stats(rk, "seq") for rk in ranks],
                 peak_gb=[rk["seq"]["peak_gb"] for rk in ranks]),
        moe=dict(mesh=[2, 2], layers=SHARD_MOE_LAYERS, tokens=list(meta["moe_tokens"].shape),
                 dtype="float32", max_abs_dlogits=err_d, aux_err=aux_err,
                 aux=ranks[0]["moe"]["aux"],
                 aux_reference=rm["aux"], expert_block=ranks[0]["moe"]["expert_block"],
                 wall_ms=[rk["moe"]["wall_ms"] for rk in ranks],
                 collectives=[rk["moe"]["collectives"] for rk in ranks],
                 peak_gb=[rk["moe"]["peak_gb"] for rk in ranks]),
        f32=dict(mesh=[2, 2], layers=SHARD_F32_LAYERS, max_abs_dlogits=errs_e),
        q_heads=q_heads,
        pipeline=dict(mesh=[SHARD_STAGES, 1, 1], microbatches=SHARD_MICRO, max_abs_dhidden=err_f,
                      wall_ms=[rk["pipeline"]["wall_ms"] for rk in ranks],
                      collectives=[rk["pipeline"]["collectives"] for rk in ranks],
                      params_held=[rk["pipeline"]["params_held"] for rk in ranks],
                      peak_gb=[rk["pipeline"]["peak_gb"] for rk in ranks]),
        families=fam_out,
        grad=dict(mesh=[SHARD_STAGES, 1, 1], layers=meta["grad_layers"],
                  microbatches=SHARD_MICRO, tokens=list(prompts.shape), dtype="float32",
                  max_rel_err=grad_rel, bar=SHARD_GRAD_RTOL,
                  leaves=[len(rk["grad"]["leaves"]) for rk in ranks],
                  forward_ms=[rk["grad"]["forward_ms"] for rk in ranks],
                  backward_ms=[rk["grad"]["backward_ms"] for rk in ranks],
                  forward_collectives=[rk["grad"]["forward_collectives"] for rk in ranks],
                  backward_collectives=[rk["grad"]["backward_collectives"] for rk in ranks],
                  params_held=[rk["grad"]["params_held"] for rk in ranks],
                  peak_gb=[rk["grad"]["peak_gb"] for rk in ranks],
                  one_process_ms=ref["grad"]["wall_ms"],
                  one_process_peak_gb=ref["grad"]["peak_gb"]),
        rank_peak_gb=peaks, reduced={
            SHARD_MOE_ARCH: dict(
                layers=SHARD_MOE_LAYERS,
                of=_shard_cfg(dict(smoke=False), SHARD_MOE_ARCH).num_layers,
                why="14d's float32 one-process reference must fit the card alone before the "
                    "spawn"),
            "14j": dict(layers=meta["grad_layers"],
                        of=_shard_cfg(dict(smoke=False), SHARD_ARCH).num_layers,
                        why="the float32 one-process gradients are saved for the ranks to "
                            "compare, and 2 blocks a stage exercise the backward's handoffs"),
            "14k": dict(layers=meta["f32_layers"],
                        of=_shard_cfg(dict(smoke=False), SHARD_ARCH).num_layers,
                        why="every FSDP byte crosses gloo (about 0.4 GB/s): 36 layers would "
                            "move about 18 GB a step; the one process's float32 AdamW state "
                            "must fit the card beside its post-step parameters")},
        train=dict(mesh=[2, 2], layers=meta["f32_layers"], dtype="float32",
                   optimizer=_train_cfg(meta).optimizer, remat=_train_cfg(meta).remat,
                   lr=TRAIN_LR, tokens=list(prompts.shape), steps=SHARD_TRAIN_STEPS,
                   loss=[s["loss"] for s in ranks[0]["train"]["steps"]],
                   loss_reference=[s["loss"] for s in rt["steps"]], err=train_err,
                   bars=dict(loss=SHARD_TRAIN_LOSS_ATOL, norms=SHARD_TRAIN_NORM_RTOL,
                             params=SHARD_TRAIN_PARAM_FRAC * TRAIN_LR),
                   small_g_elements=[n / len(ranks) for n in small],
                   step_ms=[rk["train"]["step_ms"] for rk in ranks],
                   collectives=[rk["train"]["collectives"] for rk in ranks],
                   params_held=[rk["train"]["params_held"] for rk in ranks],
                   state_held=[rk["train"]["state_held"] for rk in ranks],
                   params_whole=rt["params"],
                   peak_gb=[rk["train"]["peak_gb"] for rk in ranks],
                   one_process_step_ms=rt["step_ms"], one_process_peak_gb=rt["peak_gb"],
                   flops=ranks[0]["train"]["flops"]),
        fam_train=dict(mesh=[2, 2], dtype="float32", lr=TRAIN_LR, steps=SHARD_TRAIN_STEPS,
                       families=fam_train, reference_s=out["fam_train_reference_s"],
                       ranks_s=[rk["fam_train_s"] for rk in ranks]),
    )
    for arch, cut in SHARD_FAM_TRAIN:
        full = _shard_cfg(dict(smoke=False), arch)
        out["reduced"][f"14l {arch}"] = dict(
            cut={k: [v, getattr(full, k)] for k, v in cut.items()},
            why="the one process's float32 model, gradients and optimizer state must fit the "
                "card before the spawn, and every FSDP byte crosses gloo" if cut else "uncut")
    for name, (arch, kw, _) in SHARD_FAM_VARIANTS.items():
        full = _shard_cfg(dict(smoke=False), arch)
        out["reduced"][f"14l {name} uneven"] = dict(
            cut={k: [v, getattr(full, k)] for k, v in kw.items()},
            why="xlstm-125m's 4 heads divide over 1 x 4: 6 heads at its full width split "
                "unevenly, as its 4 do over the pod's 16 model ranks; one mLSTM and one sLSTM "
                "layer hold each block's uneven path")
    out["phase_s"] = time.perf_counter() - t_phase
    p0 = out["serve"]["per_rank"][0]
    log(f"14 sharded serving ({card}): 14a {out['select']['ids']} in "
        f"{out['select']['rounds']} rounds, launches {out['select']['launches']}; 14b 2 x 2 "
        f"max |dlogits| {max(errs):.3g}, {compared} tokens equal ({ties} rows with a near "
        f"tie), prefill {p0['prefill_ms']:.1f} ms, ticks {[round(x, 1) for x in p0['tick_ms']]} "
        f"ms, {p0['tick_collectives']['calls']:.0f} all-reduces a tick "
        f"({p0['tick_collectives']['host_s'] * 1e3:.1f} ms host, "
        f"{p0['tick_collectives']['bytes'] / 1e3:.1f} KB), {out['serve']['tokens_per_s']:.1f} "
        f"tokens/s; 14c 1 x 4 max {max(errs_c):.3g}; 14d {err_d:.3g}, aux {aux_err}; 14e "
        f"{max(errs_e):.3g}; 14f {err_f:.3g}; rank peaks {[round(p, 2) for p in peaks]} GB "
        f"(one process {rs['peak_gb']:.2f}); ranks {out['ranks_s']:.1f}s of "
        f"{out['phase_s']:.1f}s")
    for (arch, shape, dtype), sub in zip(SHARD_FAMILIES, "ghi"):
        f = fam_out[arch]
        log(f"14{sub} {arch} {shape[0]} x {shape[1]}, {dtype} ({card}): max |dlogits| "
            f"{max(f['max_abs_dlogits']):.3g} (bars {min(f['bars']):.3g}-{max(f['bars']):.3g}), "
            f"{f['tokens_compared']} tokens equal ({f['rows_with_near_tie']} rows with a near "
            f"tie), prefill {f['prefill_ms'][0]:.1f} ms, tick {f['tick_ms_median'][0]:.1f} ms, "
            f"{f['tick_collectives'][0]['calls']:.0f} all-reduces a tick "
            f"({f['tick_collectives'][0]['bytes'] / 1e3:.1f} KB, "
            f"{f['tick_collectives'][0]['host_s'] * 1e3:.1f} ms host), "
            f"{f['tokens_per_s']:.1f} tokens/s, rank peak {max(f['peak_gb']):.2f} GB (one "
            f"process {f['one_process_peak_gb']:.2f})")
    gr = out["grad"]
    log(f"14j GPipe backward ({card}): {gr['layers']} float32 blocks as {SHARD_STAGES} stages, "
        f"max |dgrad| / largest |grad| {gr['max_rel_err']:.3g} (bar {SHARD_GRAD_RTOL}); "
        f"forward {max(gr['forward_ms']):.1f} ms, backward {max(gr['backward_ms']):.1f} ms "
        f"({gr['backward_collectives'][0]['calls']:.0f} all-reduces, "
        f"{gr['backward_collectives'][0]['bytes'] / 1e6:.1f} MB); one process "
        f"{gr['one_process_ms']:.1f} ms; rank peaks {[round(p, 2) for p in gr['peak_gb']]} GB "
        f"(one process {gr['one_process_peak_gb']:.2f})")
    tr = out["train"]
    c1 = tr["collectives"][0][-1]
    log(f"14k FSDP x TP training ({card}): {tr['layers']} float32 layers on 2 x 2, "
        f"{tr['optimizer']}, remat {tr['remat']}; losses {tr['loss']} (one process "
        f"{tr['loss_reference']}), |dloss| {train_err['loss']:.3g}, grad_norm / param_norm "
        f"{train_err['grad_norm']:.3g} / {train_err['param_norm']:.3g} relative, params "
        f"{train_err['params']:.3g} where the RMS gradient is over 9 eps (bar "
        f"{SHARD_TRAIN_PARAM_FRAC * TRAIN_LR:.3g}), {train_err['params_small_g']:.3g} on the "
        f"{tr['small_g_elements']} elements a rank under it; step 2 "
        f"{max(ms[-1] for ms in tr['step_ms']):.1f} ms a rank (one process "
        f"{tr['one_process_step_ms'][-1]:.1f} ms), {c1['calls']:.0f} all-reduces "
        f"({c1['bytes'] / 1e9:.2f} GB, {c1['host_s']:.2f} s host) a step; rank peaks "
        f"{[round(p, 2) for p in tr['peak_gb']]} GB (one process {tr['one_process_peak_gb']:.2f})"
        f", {tr['params_held'][0]} of {tr['params_whole']} parameters a rank")
    qh, qt = out["q_heads"], out["q_heads"]["train"]
    log(f"14m q_heads ({card}): {qh['layers']} float32 layers on 1 x 4, each rank its "
        f"{_shard_cfg(meta, SHARD_ARCH).num_heads // 4} q heads, cache {qh['cache_shape']}; "
        f"max |dlogits| {max(qh['max_abs_dlogits']):.3g} (bar {SHARD_F32_ATOL}), prefill "
        f"{qh['prefill_ms'][0]:.1f} ms, tick {qh['tick_ms_median']:.1f} ms, "
        f"{qh['tick_collectives']['calls']:.0f} all-reduces a tick; FLOPs counted a rank: prefill "
        f"{qh['flops']['prefill']:.4g}, tick {qh['flops']['tick']:.4g}, train step "
        f"{qh['train_flops']:.4g}; training: losses {qt['loss']} (one process "
        f"{qt['loss_reference']}), errors {qt['err']}, step 2 "
        f"{max(ms[-1] for ms in qt['step_ms']):.1f} ms a rank, "
        f"{qt['collectives'][0][-1]['calls']:.0f} all-reduces a step")
    for key, f in fam_train.items():
        c = f["collectives"][0][-1]
        cut = _fam_train_cut(key.split()[0])
        log(f"14l {key} FSDP x TP training ({card}): {f['layers']} layers"
            f"{' + %d encoder layers' % f['encoder_layers'] if f['encoder_layers'] else ''}, "
            f"cut {cut or 'none'}, float32, {f['optimizer']}, {f['tokens']} tokens on "
            f"{' x '.join(map(str, f['mesh']))}, "
            f"layout {f['attn']} {f['layout']}, logits {'split' if f['logits'] else 'whole'}; "
            f"losses {f['loss']} (one process {f['loss_reference']}), aux {f['aux']}; errors "
            f"{f['err']} (gradient: the largest error over its bar; params: AdamW's largest "
            f"error on the elements held, Adafactor's over its bar); step 2 "
            f"{max(ms[-1] for ms in f['step_ms']):.1f} ms a rank (one "
            f"process {f['one_process_step_ms'][-1]:.1f} ms), {c['calls']:.0f} all-reduces "
            f"({c['bytes'] / 1e9:.2f} GB, {c['host_s']:.2f} s host) a step; rank peaks "
            f"{[round(p, 2) for p in f['peak_gb']]} GB (one process "
            f"{f['one_process_peak_gb']:.2f}), {f['params_held'][0]} of {f['params_whole']} "
            f"parameters a rank; step 1 counted {f['flops']:.6g} FLOPs a rank")
        if f["experts"]:
            x, kept = f["experts"], 1.0 - f["aux"]["aux/drop_frac"]
            log(f"14l {key} expert products a rank, each MoE call: {x['rows']} rows for its "
                f"{x['pairs']} pairs (the batched (E, min(C, T)) buffer: {x['batched_rows']}); "
                f"capacity {x['capacity']}; step 2 kept a share {kept:.6g} of the global "
                f"batch's pairs (1 - drop_frac)")
    log(f"14l took {max(rk['fam_train_s'] for rk in ranks):.1f}s in the ranks, "
        f"{out['fam_train_reference_s']:.1f}s for the one-process references")
    out["failed"] = failed
    emit({"check": "sharded", **out})
    check(not failed, f"phase 14: {len(failed)} checks failed: {failed}")
    return out


def _check_family(torch, ranks, rf: dict, meta: dict, arch: str, shape, label: str, gate,
                  max_err) -> dict:
    """14g-14i's checks for one family (phase 14's ``gate``): every step's
    logits within max(atol, 2 delta) of one process and delta + atol of
    float32 (atol 0.05 in bf16, SHARD_FAM_F32_ATOL in float32), tokens to
    the first near tie, the engines' metrics, the plan, no rank holding
    the whole model. Returns the family's report."""
    import numpy as np

    from repro_torch.models import model_zoo

    key = f"fam_{arch}"
    got = [_assemble(ranks, key, lambda rk: rk[key]["rows"], i) for i in range(SHARD_FAM_NEW)]
    errs = [max_err(g, w) for g, w in zip(got, rf["logits"])]
    delta = [float(np.abs(w - e).max()) for w, e in zip(rf["logits"], rf["exact"])]
    from32 = [float(np.abs(g - e).max()) for g, e in zip(got, rf["exact"])]
    atol = SHARD_FAM_F32_ATOL if _fam_cfg(meta, arch).dtype == "float32" else SHARD_ATOL
    bars = [max(atol, 2 * d) for d in delta]
    gate(all(e <= b for e, b in zip(errs, bars)),
         f"{label} {arch}: logits {errs} from one process (bars {bars})")
    gate(all(f <= d + atol for f, d in zip(from32, delta)),
         f"{label} {arch}: {from32} from float32, one process {delta}")
    tokens = {}
    for rk in ranks:
        for rid, output in rk[key]["outputs"].items():
            gate(tokens.setdefault(rid, output) == output,
                 f"{label} {arch}: the model ranks of request {rid}'s replica picked different "
                 "tokens")
    compared, ties = 0, 0
    for rid in range(rf["tokens"].shape[0]):
        low = np.flatnonzero(rf["margins"][rid] < SHARD_MARGIN)
        upto = int(low[0]) if low.size else SHARD_FAM_NEW
        ties += int(low.size > 0)
        gate(tokens.get(rid, [])[:upto] == rf["tokens"][rid][:upto].tolist(),
             f"{label} {arch} request {rid}: tokens {tokens.get(rid)} differ from one "
             f"process's {rf['tokens'][rid].tolist()} before its first near tie (step {upto})")
        compared += upto
    n = rf["tokens"].shape[0] // shape[0]
    want_metrics = {"prefills": 1, "decode_ticks": SHARD_FAM_NEW - 1,
                    "tokens_out": n * SHARD_FAM_NEW}
    whole = sum(p.numel() for p in model_zoo.build(_fam_cfg(meta, arch),
                                                   torch.device("meta")).parameters())
    for rk in ranks:
        f = rk[key]
        gate(f["metrics"] == want_metrics,
             f"{label} {arch} rank {rk['rank']}: metrics {f['metrics']}, not {want_metrics}")
        plan = {k: f[k] for k in ("attn", "mlp", "layout")}
        gate(meta["smoke"] or plan == SHARD_FAM_LAYOUT[arch],
             f"{label} {arch} rank {rk['rank']}: plan {plan}, not {SHARD_FAM_LAYOUT[arch]}")
        gate(f["params_held"] < whole,
             f"{label} {arch} rank {rk['rank']}: holds {f['params_held']} of {whole} parameters")
    fams = [rk[key] for rk in ranks]
    engine_s = max(f["engine_s"] for f in fams)
    return dict(mesh=list(shape), layers=_fam_cfg(meta, arch).num_layers,
                dtype=_fam_cfg(meta, arch).dtype,
                max_abs_dlogits=errs, bars=bars,
                from_float32=dict(one_process=delta, sharded=from32),
                tokens_compared=compared, rows_with_near_tie=ties, metrics=fams[0]["metrics"],
                plan={k: fams[0][k] for k in ("attn", "mlp", "layout", "vocab")},
                tokens_per_s=rf["tokens"].shape[0] * SHARD_FAM_NEW / engine_s,
                engine_s=[f["engine_s"] for f in fams],
                engine_collectives=[f["engine_collectives"] for f in fams],
                build_s=[f["build_s"] for f in fams],
                prefill_ms=[f["prefill_ms"] for f in fams],
                tick_ms=[f["tick_ms"] for f in fams],
                tick_ms_median=[float(np.median(f["tick_ms"])) for f in fams],
                prefill_collectives=[f["prefill_collectives"] for f in fams],
                tick_collectives=[f["tick_collectives"] for f in fams],
                params_held=[f["params_held"] for f in fams], params_whole=whole,
                peak_gb=[f["peak_gb"] for f in fams], one_process_peak_gb=rf["peak_gb"])


# ---------------------------------------------------------------------------
# phase 15: training under scan_layers, and the dry run on the meta device
# ---------------------------------------------------------------------------

# 15b's bars against phase 12's step 1 (the same weights and batch, each
# per-layer leaf stacked): the forward reads the same values in the same
# products, so the loss is phase 12's bit for bit; the gradient norm sums a
# stacked leaf's squares in one reduction where phase 12 sums its layers'
# apart, which may move it by a few f32 ulps (1e-6 is ~8). Readings, H100
# 80GB HBM3 at 700 W: 0 and 0 (PERF.md, PR 28 call 15)
SCAN_LOSS_ATOL = 0.0
SCAN_GNORM_RTOL = 1e-6
# 15c: production cells through the launcher's CLI, each in its own process
DRYRUN_CELLS = (("--arch", "llama3-405b", "--shape", "train_4k", "--mesh", "pod"),
                ("--arch", "fastmatch_round", "--mesh", "pod"))
DRYRUN_TIMEOUT_S = 240


def _dry_inputs(torch, cfg, tokens) -> dict:
    """The global batch of a phase-14 train cell as `TensorSpec` s: its
    (rows, seq) tokens (seq including a vlm's vision positions) and the
    frontend stubs."""
    from repro_torch.models.base import TensorSpec, extra_input_shapes

    rows, seq = tokens
    return {"tokens": TensorSpec((rows, seq), torch.int32),
            **extra_input_shapes(cfg, rows, seq)}


def _scan_predictions(torch, sharded) -> dict:
    """15a: 14k's, 14l's and 14m's train cells, each one step of
    `launch.specs.make_case` on the meta device at rank (0, 0) of a
    virtual mesh of the cell's shape (2 x 2; 1 x 4 for 14m and 14l's
    uneven cases) (`launch.dryrun.measure`): the recorded all-reduce calls
    and payload bytes must be what phase 14's rank 0 issued at each step
    (`COLLECTIVES`), the FLOPs what it counted in step 1
    (`FlopCounterMode`), the parameter and optimizer-state elements what
    it held; the predicted argument + temp bytes beside its measured
    peak. Each of 14l's uneven cases the same at every rank's coordinate
    (0, r) against what rank r issued, counted and held: its ranks' FLOPs
    differ by design. 14m's prefill and decode tick too, each one's FLOPs what
    rank 0 counted."""
    from repro_torch.core.distributed import VirtualMesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import make_case
    from repro_torch.models.base import TensorSpec

    meta = dict(smoke=SHARD_SMOKE, layers=SHARD_LAYERS, f32_layers=SHARD_F32_LAYERS)
    fam = sharded["fam_train"]["families"]
    qh = sharded["q_heads"]
    cells = [("14k", SHARD_ARCH, _train_cfg(meta), sharded["train"], 0)]
    cells += [("14l", arch, _fam_train_cfg(meta, arch), fam[arch], 0)
              for arch, _ in SHARD_FAM_TRAIN]
    for name in SHARD_FAM_UNEVEN:
        got = fam[f"{name} uneven"]
        cells += [("14l uneven" + (f" rank {r}" if i else ""), name, _fam_train_cfg(meta, name),
                   dict(got, flops=got["flops_ranks"][i]), i) for i, r in enumerate(got["ranks"])]
    cells.append(("14m", SHARD_ARCH, _train_cfg(meta), dict(
        qh["train"], tokens=qh["tokens"], flops=qh["train_flops"]), 0))
    out = {}
    for label, arch, cfg, got, i in cells:
        shape = (1, 4) if label.startswith(("14m", "14l uneven")) else (2, 2)
        # the rank's coordinate: row-major over (1, 4), rank r is model rank r
        each = label.startswith("14l uneven")
        coord = (0, got["ranks"][i]) if each else (0, 0)
        mesh = VirtualMesh(shape, ("data", "model"), coord)
        t = time.perf_counter()
        case = make_case(cfg, mesh, "train", _dry_inputs(torch, cfg, got["tokens"]), lr=TRAIN_LR)
        m = dryrun.measure(case.fn, case.args, mesh, params=list(case.model.parameters()),
                           state=case.state.opt_state)
        del case
        predicted = m["totals"]
        measured = [dict(calls=c["calls"], bytes=c["bytes"]) for c in got["collectives"][i]]
        name = f"15a {label} {arch}"
        who = f"rank {coord[1]}"
        check(all(c == predicted for c in measured),
              f"{name}: predicted {predicted} all-reduce calls / bytes a step, {who} issued "
              f"{measured}")
        check((m["params_held"], m["state_held"]) == (got["params_held"][i],
                                                       got["state_held"][i]),
              f"{name}: predicted {m['params_held']} parameter and {m['state_held']} state "
              f"elements, {who} held {got['params_held'][i]} and {got['state_held'][i]}")
        check(m["flops"] == got["flops"],
              f"{name}: predicted {m['flops']} FLOPs a step, {who} counted {got['flops']}")
        mem = m["memory"]
        out[f"{label} {arch}"] = dict(
            predicted=predicted, measured=measured, by_axis=m["by_axis"],
            params_held=m["params_held"], state_held=m["state_held"],
            argument_gb=mem["argument_bytes"] / 1e9, temp_gb=mem["temp_bytes"] / 1e9,
            predicted_gb=(mem["argument_bytes"] + mem["temp_bytes"]) / 1e9,
            measured_peak_gb=got["peak_gb"][i], flops=m["flops"], counted=got["flops"],
            bytes=m["bytes"], coordinate=list(coord),
            meta_run_s=m["run_s"], cell_s=time.perf_counter() - t)
    # 14m's serving on meta: the FLOPs of a prefill and of a tick, each what
    # rank 0 counted
    cfg, (rows, seq) = _train_cfg(meta), qh["tokens"]
    for kind, inputs, counted in (
            ("prefill", {"tokens": TensorSpec((rows, seq), torch.int32)}, qh["flops"]["prefill"]),
            ("decode", {"token": TensorSpec((rows,), torch.int32)}, qh["flops"]["tick"])):
        mesh = VirtualMesh((1, 4), ("data", "model"), (0, 0))
        case = make_case(cfg, mesh, kind, inputs, max_len=LM_MAX_LEN, serving=True)
        m = dryrun.measure(case.fn, case.args, mesh)
        del case
        check(m["flops"] == counted,
              f"15a 14m {kind}: predicted {m['flops']} FLOPs, rank 0 counted {counted}")
        out[f"14m {kind}"] = dict(flops=m["flops"], counted=counted, predicted=m["totals"],
                                  meta_run_s=m["run_s"])
    return out


def _scan_train(torch, card: str, train: dict) -> dict:
    """15b: `train_loop` on the full-width, full-depth qwen2.5-3b with its
    layers stacked (``scan_layers``; bf16, AdamW, remat "full", seed 0),
    phase 12's steps, batch and sequence behind FastMatch's selection
    (counts at 0 just before the loop, read just after: path
    ``scan_train_select``); phase 12's gates; step 1 against phase 12's;
    three more steps on one batch, the loss falling at each."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.corpus import CorpusSpec, make_corpus
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import train as launch
    from repro_torch.optimizer import get_optimizer
    from repro_torch.train import make_train_step

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), scan_layers=True)
    spec = CorpusSpec(vocab_size=cfg.vocab_size, **TRAIN_CORPUS)
    step_times = []

    def log_fn(msg):
        if msg.startswith("[train]"):
            torch.cuda.synchronize()
            step_times.append(time.perf_counter())
        log(f"  {msg}")

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t = time.perf_counter()
    run = launch.train_loop(cfg=cfg, steps=TRAIN_STEPS, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                            lr=TRAIN_LR, seed=0, log_every=1, log_fn=log_fn, device=TRAIN_DEVICE)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model, state, sel = run["model"], run["state"], run["selection"]
    res = sel.result
    selected = np.sort(sel.selected_domains)
    check(np.array_equal(selected, train["loop"]["select"]["ids"]),
          f"15b: selected {selected.tolist()}, phase 12 {train['loop']['select']['ids']}")
    c = sum(launches[name] for name in C_FORMS)
    check(launches["anyactive"] == launches["histogram"] == res.rounds
          and res.rounds <= c <= res.rounds + 1,
          f"15b: launches {launches} for {res.rounds} rounds of the selection")
    stacked = {name: tuple(p.shape) for name, p in model.named_parameters()
               if name.startswith("layers.")}
    check(stacked and all(s[0] == cfg.num_layers for s in stacked.values())
          and not any(name.split(".")[1].isdigit() for name in stacked),
          f"15b: the layer leaves are not ({cfg.num_layers}, ...) stacks: {stacked}")
    hist = run["history"]
    check(len(hist) == TRAIN_STEPS and int(state.step) == TRAIN_STEPS,
          f"15b: {len(hist)} logged steps, state at step {int(state.step)}")
    check(all(h["step_ok"] == 1.0 and math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              for h in hist), f"15b: a step was skipped or not finite: {hist}")
    want_loss, want_gn = train["loop"]["losses"][0], train["loop"]["grad_norms"][0]
    d_loss = abs(hist[0]["loss"] - want_loss)
    d_gn = abs(hist[0]["grad_norm"] / want_gn - 1)
    check(d_loss <= SCAN_LOSS_ATOL and d_gn <= SCAN_GNORM_RTOL,
          f"15b: step 1 loss {hist[0]['loss']!r} / grad_norm {hist[0]['grad_norm']!r}, phase 12 "
          f"{want_loss!r} / {want_gn!r} (|dloss| {d_loss:.3g}, bar {SCAN_LOSS_ATOL}; grad_norm "
          f"{d_gn:.3g} relative, bar {SCAN_GNORM_RTOL})")
    step_ms = [(b - a) * 1e3 for a, b in zip(step_times, step_times[1:])]
    warm_ms = statistics.median(step_ms)
    # one batch, three steps: the loss falls at each (phase 12b's gate)
    corpus = make_corpus(spec)
    batch = next(TokenStream(corpus, sel.selected_domains, batch_size=TRAIN_BATCH,
                             seq_len=TRAIN_SEQ, seed=1))
    batch = {"tokens": torch.from_numpy(batch["tokens"]).to(TRAIN_DEVICE)}
    del corpus
    train_step = make_train_step(model, get_optimizer(cfg.optimizer, TRAIN_LR))
    losses = []
    for i in range(3):
        state, m = train_step(state, batch)
        check(float(m["step_ok"]) == 1.0, f"15b: one-batch step {i} skipped")
        losses.append(float(m["loss"]))
    check(all(a > b for a, b in zip(losses, losses[1:])),
          f"15b: the loss on one batch did not fall at every step: {losses}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = dict(
        arch=TRAIN_ARCH, dtype=cfg.dtype, remat=cfg.remat, optimizer=cfg.optimizer,
        scan_layers=True, params=sum(p.numel() for p in model.parameters()),
        stacked_leaves=len(stacked), stacked_example=stacked.get("layers.attn.wq"),
        steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, loop_s=loop_s,
        step_ms_after_first=step_ms, ms_per_step=warm_ms, phase12_ms_per_step=train["loop"][
            "ms_per_step"], tokens_per_s=tokens / warm_ms * 1e3, peak_gb=peak_gb,
        phase12_peak_gb=train["loop"]["peak_gb"],
        losses=[h["loss"] for h in hist], grad_norms=[h["grad_norm"] for h in hist],
        step1=dict(loss=hist[0]["loss"], grad_norm=hist[0]["grad_norm"], phase12_loss=want_loss,
                   phase12_grad_norm=want_gn, abs_dloss=d_loss, rel_dgrad_norm=d_gn,
                   bars=dict(loss=SCAN_LOSS_ATOL, grad_norm=SCAN_GNORM_RTOL)),
        learn=losses,
        select=dict(ids=selected.tolist(), rounds=res.rounds, blocks_read=res.blocks_read,
                    launches=launches))
    log(f"15b train_loop {TRAIN_ARCH} stacked ({len(stacked)} leaves of {cfg.num_layers} "
        f"layers, {out['params'] / 1e9:.3f}B params, bf16, AdamW, remat full), {TRAIN_STEPS} "
        f"steps of {TRAIN_BATCH} x {TRAIN_SEQ}: selection in {res.rounds} rounds, launches "
        f"{launches}; step 1 |dloss| {d_loss:.3g}, grad_norm {d_gn:.3g} relative from phase 12; "
        f"ms a step after the first {[round(x, 1) for x in step_ms]} (median {warm_ms:.1f}, "
        f"phase 12 {train['loop']['ms_per_step']:.1f}), peak {peak_gb:.2f} GB (phase 12 "
        f"{train['loop']['peak_gb']:.2f}); one batch {[round(x, 5) for x in losses]}; {card}")
    del model, state, run, train_step, batch
    torch.cuda.empty_cache()
    return out


def _dryrun_cells(procs, where: str) -> dict:
    """15c: each production cell's JSON from its `dryrun.main` process:
    ``ok``, FLOPs above 0, a bottleneck named."""
    out = {}
    for i, (cell, proc) in enumerate(procs):
        proc.wait(timeout=DRYRUN_TIMEOUT_S)
        check(proc.returncode == 0, f"15c {' '.join(cell)}: exit {proc.returncode}: "
              f"{Path(where, f'cell{i}.log').read_text()[-2000:]}")
        arch = cell[1].replace("-", "_").replace(".", "_")
        tag = arch if arch == "fastmatch_round" else f"{arch}_{cell[3]}"
        d = json.loads(Path(where, f"{tag}_{cell[-1]}.json").read_text())
        r = d.get("roofline", {})
        check(d.get("ok") is True and d.get("flops_per_device", 0) > 0
              and r.get("bottleneck") in ("compute", "memory", "collective"),
              f"15c {tag}: {json.dumps(d)[:2000]}")
        out[tag] = d
        log(f"15c {tag} x {d['mesh']} ({d['chips']} ranks, rank {d['coordinate']}): flops/dev "
            f"{d['flops_per_device']:.4g}, bytes/dev {d['bytes_per_device']:.4g}, collective "
            f"bytes/dev {d['collective_bytes_per_device']:.4g}; roofline on {d['hardware']['card']}"
            f": compute {r['t_compute_s'] * 1e3:.1f} ms, memory {r['t_memory_s'] * 1e3:.1f} ms, "
            f"collective {r['t_collective_s'] * 1e3:.1f} ms -> {r['bottleneck']}; argument "
            f"{d['memory']['argument_bytes'] / 1e9:.2f} GB, temp "
            f"{d['memory']['temp_bytes'] / 1e9:.2f} GB; meta run {d['run_s']:.1f}s")
    return out


class DryRunCells:
    """15c's `dryrun.main` processes, one a cell of DRYRUN_CELLS, started
    ahead of phase 15 (their meta runs use host cores only, and the card
    is hidden from them) so they run while the card works; a context
    manager that stops whatever is still running and removes their
    output directory on exit."""

    def __enter__(self):
        self.where = tempfile.mkdtemp(prefix="chip_smoke_15c_")
        self.started = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
        self.procs = []
        for i, cell in enumerate(DRYRUN_CELLS):
            with open(Path(self.where, f"cell{i}.log"), "w") as log_file:  # the child's copy
                self.procs.append((cell, subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun", *cell, "--out",
                     self.where], cwd=str(ROOT), env=env, stdout=log_file,
                    stderr=subprocess.STDOUT)))
        return self

    def __exit__(self, *exc):
        for _, proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.where, ignore_errors=True)


def phase_scan_dryrun(torch, card: str, train: dict, sharded: dict, cells: DryRunCells) -> dict:
    """Phase 15 (see the module docstring): 15b on the card, 15a in this
    process, then the results of 15c's ``cells``."""
    t_phase = time.perf_counter()
    out = dict(train=_scan_train(torch, card, train))
    t = time.perf_counter()
    out["predictions"] = _scan_predictions(torch, sharded)
    out["predictions_s"] = time.perf_counter() - t
    for name, p in out["predictions"].items():
        if "measured" not in p:  # 14m's serving cells
            log(f"15a {name}: {p['flops']:.6g} FLOPs predicted = rank 0's counted "
                f"{p['counted']:.6g}; meta run {p['meta_run_s']:.1f}s")
            continue
        log(f"15a {name}: {p['predicted']['calls']} all-reduces, "
            f"{p['predicted']['bytes'] / 1e9:.4f} GB a step predicted = rank "
            f"{p['coordinate'][1]}'s {p['measured']}; {p['flops']:.6g} FLOPs predicted = "
            f"counted; {p['params_held']} parameters, "
            f"{p['state_held']} state elements held; argument + temp {p['predicted_gb']:.2f} "
            f"GB predicted, peak {p['measured_peak_gb']:.2f} GB measured; meta run "
            f"{p['meta_run_s']:.1f}s")
    t = time.perf_counter()
    out["production"] = _dryrun_cells(cells.procs, cells.where)
    out["production_wait_s"] = time.perf_counter() - t
    out["production_since_start_s"] = time.perf_counter() - cells.started
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 15 took {out['phase_s']:.1f}s, {out['production_wait_s']:.1f}s of it waiting for "
        f"15c's processes (started {out['production_since_start_s']:.1f}s ago) ({card})")
    emit({"check": "scan_dryrun", **out})
    return out


def _meta_model(torch, meta: dict):
    from repro_torch.models import model_zoo

    return model_zoo.build(_shard_cfg(meta, SHARD_ARCH), torch.device("meta"))


# ---------------------------------------------------------------------------
# phase 16: the families trained at full width, and the examples
# ---------------------------------------------------------------------------

# the families whose full model, AdamW state and a step of 8 x 256 fit one
# card (mixtral-8x7b does not: 93.4 GB of bf16 weights alone)
FAM_TRAIN_FULL = ("recurrentgemma_2b", "xlstm_125m", "whisper_medium")
EXAMPLES = ("torch_quickstart", "torch_anytime_match", "torch_serve_match",
            "torch_census_explore", "torch_telemetry_trace", "torch_serve_batch",
            "torch_train_lm_fastmatch")
EXAMPLE_TRAIN_STEPS = (4, 6)  # the first run's steps, then the resumed run's


def _frames_fn(torch, cfg):
    """Whisper's encoder frames for each batch the launcher draws, N(0,
    0.02^2) in the model's dtype from a generator on the device seeded 0
    (13c's and 14i's convention); None for the other families."""
    if cfg.frontend != "audio_stub":
        return None
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(0)

    def extra(batch):
        shape = (batch["tokens"].shape[0], cfg.encoder_seq, cfg.d_model)
        frames = torch.randn(shape, generator=gen, device=TRAIN_DEVICE) * 0.02
        return {"encoder_frames": frames.to(getattr(torch, cfg.dtype))}

    return extra


def phase_family_train(torch, card: str) -> dict:
    """Phase 16a (see the module docstring): recurrentgemma-2b, xlstm-125m
    and whisper-medium trained at full width and depth through the
    launcher, each freed before the next is built."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    allocated = torch.cuda.memory_allocated()
    check(allocated < FAM_MEMORY_BEFORE,
          f"16a: {allocated / 1e9:.2f} GB allocated on the card before the phase")
    out = dict(loop={}, learn={})
    for arch in FAM_TRAIN_FULL:
        cfg = get_config(arch)
        check(cfg.dtype == "bfloat16" and cfg.optimizer == "adamw" and cfg.remat == "full",
              f"16a: {arch} is {cfg.dtype}, {cfg.optimizer}, remat {cfg.remat}")
        extra = _frames_fn(torch, cfg)
        run, lp = _train_loop_checked(torch, cfg, arch, f"16a {arch}", extra_batch_fn=extra)
        out["loop"][arch] = lp
        state, batch, train_step, losses, _ = _learn_one_batch(
            torch, cfg, run["model"], run["state"], run["selection"].selected_domains,
            f"16a {arch} one batch", extra_batch_fn=extra)
        out["learn"][arch] = dict(losses=losses, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"16a train_loop {arch} ({cfg.num_layers} layers, {lp['params'] / 1e9:.3f}B params, "
            f"bf16, AdamW, remat full), {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}: "
            f"selection {lp['select']['ids']} in {lp['select']['rounds']} rounds, launches "
            f"{lp['select']['launches']}; losses {[round(x, 4) for x in lp['losses']]}; ms a "
            f"step after the first {[round(x, 1) for x in lp['step_ms_after_first']]} (median "
            f"{lp['ms_per_step']:.1f}, {lp['tokens_per_s']:.0f} tokens/s), peak "
            f"{lp['peak_gb']:.2f} GB, loop {lp['loop_s']:.1f}s, {lp['leaves_moved']} of "
            f"{lp['leaves']} leaves moved ({len(lp['leaves_unmovable'])} unmovable in bf16); one "
            f"batch, 3 steps: losses {[round(x, 5) for x in losses]} (strictly falling); {card}")
        del run, state, batch, train_step
        torch.cuda.empty_cache()
    out["select_launches"] = {name: sum(r["select"]["launches"][name]
                                        for r in out["loop"].values())
                              for name in KERNEL_ROWS}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 16a took {out['phase_s']:.1f}s")
    emit({"check": "family_train", **out})
    return out


def _load_example(name: str):
    """examples/<name>.py as a module (the examples are scripts, not a
    package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # a dataclass resolves its module's names there
    spec.loader.exec_module(mod)
    return mod


def _parses(path: Path) -> bool:
    """Telemetry's files read back: every trace line a JSON object, the
    CSV's header `obs.CURVE_COLUMNS` and every row that many floats,
    every Prometheus sample line a name and a float."""
    import csv

    from repro_torch.obs import CURVE_COLUMNS

    text = path.read_text()
    if not text.strip():
        return False
    if path.suffix == ".jsonl":
        return all(isinstance(json.loads(line), dict) for line in text.splitlines())
    if path.suffix == ".csv":
        rows = list(csv.reader(text.splitlines()))
        return (tuple(rows[0])[-len(CURVE_COLUMNS):] == tuple(CURVE_COLUMNS) and len(rows) > 1
                and all(len(r) == len(rows[0]) and all(math.isfinite(float(v)) for v in r)
                        for r in rows[1:]))
    samples = [line.rsplit(" ", 1) for line in text.splitlines()
               if line and not line.startswith("#")]
    return bool(samples) and all(len(s) == 2 and not math.isnan(float(s[1])) for s in samples)


def _check_examples(torch, name: str, got: dict, tmp: Path) -> dict:
    """Phase 16b's gates on one example, from what it returns (the values
    it prints); returns the numbers the report keeps."""
    import numpy as np

    if name == "torch_quickstart":
        res = got["result"]
        check(sorted(res.ids.tolist()) == sorted(got["true_top_k"].tolist())
              and res.delta_upper < 0.01,
              f"16b quickstart: ids {sorted(res.ids.tolist())}, planted "
              f"{sorted(got['true_top_k'].tolist())}, delta_upper {res.delta_upper:.3g}")
        return dict(ids=res.ids.tolist(), rounds=res.rounds, blocks_read=res.blocks_read,
                    num_blocks=got["num_blocks"], delta_upper=res.delta_upper)
    if name == "torch_anytime_match":
        final, sla = got["final"], got["sla_result"]
        check(got["stream"][-1].ids.tolist() == final.ids.tolist()
              and got["stream"][-1].status == "done",
              f"16b anytime: final ids {final.ids.tolist()}, last statement "
              f"{got['stream'][-1].ids.tolist()} ({got['stream'][-1].status})")
        check(sla.stopped and sla.stop_reason == "tuples" and not sla.exact,
              f"16b anytime: the SLA query stopped {sla.stopped} for {sla.stop_reason!r}")
        return dict(rows=len(got["stream"]), ids=final.ids.tolist(),
                    tuples=final.result.tuples_read, within_eps=bool(got["within_eps"]),
                    sla_tuples=sla.tuples_read, sla_stop_reason=sla.stop_reason)
    if name == "torch_serve_match":
        shared = got["metrics"]["total_tuples_read"]
        check(shared < got["solo_tuples"],
              f"16b serve_match: shared {shared} tuples, solo {got['solo_tuples']}")
        # the reference example's late and restored queries read nothing new
        check(got["late_new_tuples"] == 0 and got["restored_new_tuples"] == 0,
              f"16b serve_match: the late query read {got['late_new_tuples']} new tuples, the "
              f"restored one {got['restored_new_tuples']}")
        return dict(shared_tuples=shared, solo_tuples=got["solo_tuples"],
                    late_new_tuples=got["late_new_tuples"],
                    restored_new_tuples=got["restored_new_tuples"])
    if name == "torch_census_explore":
        topk = [got[q] for q in ("q1", "q2", "q3", "q4", "q5_topk")]
        check(all(len(r.ids) == 10 and r.qtype == "topk" for r in topk)
              and got["q5_closeness"].qtype == "closeness" and len(got["q5_closeness"].ids),
              "16b census: a query did not answer")
        scan = got["variants"]["scan"].blocks_read
        blocks = {v: r.blocks_read for v, r in got["variants"].items()}
        check(all(b <= scan for b in blocks.values()), f"16b census: blocks {blocks}, Scan {scan}")
        return dict(blocks=blocks, q1_ids=sorted(got["q1"].ids.tolist()),
                    closeness=len(got["q5_closeness"].ids), shared_tuples=got["shared_tuples"])
    if name == "torch_telemetry_trace":
        paths = (got["trace_path"], got["csv_path"], got["prom_path"])
        check(all(_parses(p) for p in paths), f"16b telemetry: a file is empty or unreadable: "
              f"{[(p.name, p.stat().st_size) for p in paths]}")
        return dict(events=got["events"], curve_points=got["curve_points"],
                    bytes={p.name: p.stat().st_size for p in paths})
    if name == "torch_serve_batch":
        done, eng = sorted(got["done"], key=lambda r: r.rid), got["engine"]
        for lo in range(0, len(done), eng.slots):  # the queue in batches of ``slots``
            batch = done[lo:lo + eng.slots]
            plen = max(len(r.prompt) for r in batch)
            prompts = np.zeros((len(batch), plen), np.int32)
            for i, r in enumerate(batch):
                prompts[i, plen - len(r.prompt):] = r.prompt  # left-pad, as the engine
            new = max(r.max_new_tokens for r in batch)
            rows, _, finite = _greedy_loop(torch, eng.model, prompts, eng.max_len, new)[:3]
            check(finite and all(r.output == rows[i] for i, r in enumerate(batch)),
                  f"16b serve_batch: requests {lo}-{lo + len(batch) - 1} differ from the greedy "
                  "loop on their batch")
        return dict(metrics=got["metrics"], wall_s=got["wall_s"],
                    tokens_per_s=got["metrics"]["tokens_out"] / got["wall_s"])
    # torch_train_lm_fastmatch: the first run, then its resumption (below)
    hist = got["history"]
    check(hist and all(h["step_ok"] == 1.0 and math.isfinite(h["loss"]) for h in hist)
          and math.isfinite(got["final_loss"]),
          f"16b train: a step was skipped or not finite: {hist}")
    return dict(final_loss=got["final_loss"], step=int(got["state"].step),
                history=[dict(step=h["step"], loss=h["loss"], step_ok=h["step_ok"])
                         for h in hist])


def phase_examples(torch, card: str) -> dict:
    """Phase 16b (see the module docstring): the seven examples on the
    card at the reference's sizes, each with its launch counts at 0 just
    before and read just after (path ``examples``: their sum)."""
    import tempfile

    t_phase = time.perf_counter()
    out = dict(examples={}, walls={})
    lines_dir = ROOT / "chiprun_out" / "examples"
    lines_dir.mkdir(parents=True, exist_ok=True)
    launches = dict.fromkeys(KERNEL_ROWS, 0)
    with tempfile.TemporaryDirectory(prefix="examples_") as tmp:
        tmp = Path(tmp)
        for name in EXAMPLES:
            mod = _load_example(name)
            if name == "torch_train_lm_fastmatch":  # a snapshot at step 4, resumed to 6
                loop = mod.train_loop  # the example snapshots every 100 steps
                mod.train_loop = lambda **kw: loop(**dict(kw, ckpt_every=EXAMPLE_TRAIN_STEPS[0]))
                runs = [((dataclasses.replace(mod.TrainSpec(), steps=steps,
                                              ckpt_dir=str(tmp / "ckpt")), LM_DEVICE), {})
                        for steps in EXAMPLE_TRAIN_STEPS]
            elif name == "torch_telemetry_trace":
                runs = [((mod.SPEC, LM_DEVICE), dict(out_dir=tmp / "telemetry"))]
            elif name == "torch_serve_batch":  # its smoke config
                runs = [((None, LM_DEVICE), {})]
            else:
                runs = [((mod.SPEC, LM_DEVICE), {})]
            reports, lines = [], []
            for a, kw in runs:
                _reset_launches()
                torch.cuda.synchronize()
                t = time.perf_counter()
                got = mod.run(*a, **kw)
                torch.cuda.synchronize()
                out["walls"].setdefault(name, []).append(time.perf_counter() - t)
                counts = _launch_counts()
                for kernel, n in counts.items():
                    launches[kernel] += n
                reports.append(dict(_check_examples(torch, name, got, tmp), launches=counts))
                lines += got["lines"]
                del got
            if name == "torch_train_lm_fastmatch":
                first, resumed = reports
                resume_line = f"[resume] restored step {EXAMPLE_TRAIN_STEPS[0]} from {tmp / 'ckpt'}"
                check(first["step"] == EXAMPLE_TRAIN_STEPS[0]
                      and resumed["step"] == EXAMPLE_TRAIN_STEPS[1] and resume_line in lines,
                      f"16b train: steps {first['step']} then {resumed['step']}, resumed "
                      f"{resume_line in lines}")
            (lines_dir / f"{name}.txt").write_text("\n".join(lines) + "\n")
            out["examples"][name] = reports if len(reports) > 1 else reports[0]
            log(f"16b {name}: {reports}, wall {[round(w, 2) for w in out['walls'][name]]} s")
            torch.cuda.empty_cache()
    out["launches"] = launches
    c = sum(launches[name] for name in C_FORMS)
    check(launches["anyactive"] > 0 and launches["histogram"] > 0 and c > 0,
          f"16b: the examples launched {launches}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 16b took {out['phase_s']:.1f}s; the examples' lines in "
        f"chiprun_out/examples/; {card}")
    emit({"check": "examples", **out})
    return out


# kernel name -> (its source, the pallas_call it replaces), and the path
# whose run gives its launches: the first of PATHS that launches it
KERNEL_ROWS = {
    "anyactive": ("src/repro_torch/kernels/csrc/anyactive.cu",
                  "src/repro/kernels/anyactive.py:55"),
    "histogram": ("src/repro_torch/kernels/csrc/histogram.cu",
                  "src/repro/kernels/histogram.py:108"),
    "distance_multi": ("src/repro_torch/kernels/csrc/distance.cu",
                       "src/repro/kernels/metrics.py:373"),
    "distance_multi_u16": ("src/repro_torch/kernels/csrc/distance.cu",
                           "src/repro/kernels/metrics.py:373"),
    "distance_wide": ("src/repro_torch/kernels/csrc/distance.cu",
                      "src/repro/kernels/metrics.py:385"),
    "distance_wide_u16": ("src/repro_torch/kernels/csrc/distance.cu",
                          "src/repro/kernels/metrics.py:385"),
}
ALSO_REPLACES = {"anyactive": "src/repro/core/multiquery.py:644-645"}
PATHS = ("fastmatch", "serving", "minute_fastmatch", "minute_fastmatch_lowprec",
         "fastmatch_lowprec", "fixture_wide_u16", "tuner")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tuples", type=int, default=400_000_000,
                    help="tuples in the paper-scale datasets of phases 4 and 7 (default 400M)")
    ap.add_argument("--seed", type=int, default=0, help="FastMatch's start-block seed")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              f"(no {SRC / 'repro_torch'})", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    # phases 4's and 7's tables are made on host cores from the start, while
    # the kernels build and phases 2, 3, 16 and 11 to 13 use the card
    with Tables(dict(taxi=taxi_spec(args.tuples), minute=minute_spec(args.tuples))) as tables:
        smi = phase_setup(torch)
        timer = DeviceTimer(torch)
        log("phase 2: kernels against their plain versions")
        main_rows = phase_kernels(torch, timer)
        log("phase 3: engine and server on the test fixture, card against CPU")
        ds, blocked = phase_engine_small(torch)
        fixture_wide_u16 = phase_serving_small(torch, ds, blocked)
        del ds, blocked
        torch.cuda.empty_cache()
        # phases 16 and 11 to 13 need neither table: they run while the
        # tables are still being made
        log(f"phase 16a: {', '.join(FAM_TRAIN_FULL)} trained at full width on the card")
        family_train = phase_family_train(torch, smi)
        log(f"phase 16b: the {len(EXAMPLES)} examples on the card")
        examples = phase_examples(torch, smi)
        torch.cuda.empty_cache()
        log(f"phase 11: the data layer and a full-width {LM_ARCH} on the card")
        lm = phase_lm(torch, timer, smi)
        log(f"phase 12: training a full-width {TRAIN_ARCH} on the card")
        train = phase_train(torch, smi)
        log(f"phase 13: every model family at full width on the card ({', '.join(FAM_ARCHS)})")
        families = phase_families(torch, smi)
        torch.cuda.empty_cache()
        full_size = (args.tuples, args.seed) == (400_000_000, 0)
        log(f"phase 4: engine at {args.tuples} tuples")
        scale, ctx = phase_engine_scale(torch, tables.get("taxi"), args.seed,
                                        check_name="engine_scale",
                                        expect=(27, 12_395) if full_size else None)
        log("phase 5: serving 12 queries on the resident table")
        serving = phase_serving(torch, timer, ctx)
        log("phase 8: the I/O, fault and recovery layer on the resident table")
        t = time.perf_counter()
        faults = phase_faults(torch, ctx, expect=(27, 12_395) if full_size else None,
                              expect_quarantine=(2_048, 4) if full_size else None)
        log(f"phase 8 took {time.perf_counter() - t:.1f}s")
        log("phase 9: telemetry on the resident table")
        telemetry = phase_telemetry(torch, timer, ctx)
        log(f"phase 10: the mesh and the data-parallel pump, {MESH_RANKS} gloo ranks on the card")
        mesh = phase_mesh(torch, ctx, seed=args.seed)
        del ctx  # the resident table and the host arrays
        torch.cuda.empty_cache()
        log("phase 6: the tuner at the taxi keys")
        tuner = phase_tuner(torch)
        log(f"phase 7: wide rows, FastMatch at the minute-of-day shape, {args.tuples} tuples")
        # [0]: phase 7's resident table (its context) is dropped here, so
        # phase 14 starts from an empty card
        wide = phase_engine_scale(torch, tables.get("minute"), args.seed,
                                  check_name="wide_rows",
                                  expect=(53, 27_134) if full_size else None)[0]
        torch.cuda.empty_cache()
    with DryRunCells() as cells:  # 15c's processes, on host cores while the card works
        log(f"phase 14: sharded serving, {SHARD_RANKS} gloo ranks on the card")
        sharded = phase_sharded(torch, smi)
        log(f"phase 15: {TRAIN_ARCH} trained with its layers stacked; the dry run on the meta "
            "device")
        scan = phase_scan_dryrun(torch, smi, train, sharded, cells)

    leaked = sorted(m for m in sys.modules if m.startswith("jax") or m == "repro"
                    or m.startswith("repro."))
    check(not leaked, f"the port loaded {leaked}")

    # each path's launches, its counts set to 0 just before it and read just after
    paths = dict(fastmatch=scale["launches"], scan=scale["scan_launches"],
                 serving=serving["launches"],
                 fastmatch_lowprec=scale["lowprec"]["fastmatch"]["launches"],
                 scan_lowprec=scale["lowprec"]["scan"]["launches"],
                 fixture_wide_u16=fixture_wide_u16, tuner=tuner["launches"],
                 minute_fastmatch=wide["launches"], minute_scan=wide["scan_launches"],
                 minute_fastmatch_lowprec=wide["lowprec"]["fastmatch"]["launches"],
                 minute_scan_lowprec=wide["lowprec"]["scan"]["launches"],
                 lm_select=lm["select"]["launches"], lm_monitor=lm["monitor"]["launches"],
                 train_select=train["loop"]["select"]["launches"],
                 families_select=families["select_launches"],
                 families_monitor=families["monitor_launches"],
                 sharded_select=sharded["select"]["launches"],
                 scan_train_select=scan["train"]["select"]["launches"],
                 families_train_select=family_train["select_launches"],
                 examples=examples["launches"],
                 fault_chaos=faults["chaos"]["launches"],
                 fault_quarantine=faults["quarantine"]["launches"],
                 fault_recovery=faults["recovery"]["launches"],
                 telemetry_on=telemetry["launches"],
                 **{f"mesh_{name}": counts for name, counts in mesh["launches"].items()},
                 **{f"prefetch_{name}": run["launches"]
                    for name, run in faults["prefetch"]["runs"].items()})
    kernels = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        path = next((p for p in PATHS if paths[p][name] > 0), None)
        check(path is not None, f"kernel {name} was launched on no path")
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=paths[path][name], path=path,
                   launches_by_path={p: counts[name] for p, counts in paths.items()},
                   serving_launches=serving["launches"][name], **main_rows[name])
        if name in ALSO_REPLACES:
            row["also_replaces"] = ALSO_REPLACES[name]
        if name == "histogram":
            # the registry's binning: one launch a non-empty histogram read
            row["registry_launches"] = telemetry["registry_read"]["launches"]
            row["registry_shape"] = telemetry["registry_kernel"]
            # the activation monitor's binning: one launch a monitored tensor
            row["monitor_launches"] = lm["monitor"]["launches"]["histogram"]
            row["monitor_shape"] = lm["monitor"]["kernel"]
            # phase 13d: one launch a decode-state tensor of the four families
            row["families_monitor_launches"] = families["monitor_launches"]["histogram"]
        kernels.append(row)
    for row in kernels:
        check(all(isinstance(row[k], (int, float)) and math.isfinite(row[k])
                  for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")), f"bad row {row}")

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, device=device, kernels=kernels, scale=scale, serving=serving,
             faults=faults, telemetry=telemetry, mesh=mesh, tuner=tuner["report"],
             wide_rows=wide, lm=lm, train=train, families=families,
             sharded=sharded, scan_dryrun=scan, family_train=family_train,
             examples=examples,
             wall_s=time.perf_counter() - T0), indent=1))
    log(f"all checks passed in {time.perf_counter() - T0:.1f}s")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
