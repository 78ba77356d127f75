#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold every
hand-written kernel against its plain PyTorch version.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``PATH`` or ``CUDA_HOME``, default ``/usr/local/cuda``)
and the repository's ``src/repro_torch``; without them it exits non-zero
and prints no result. Phases, in order (any failure ends the run with a
traceback and a non-zero exit):

1. environment: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions; TF32 is switched off for matmuls and cuDNN
   (the plain int8/int4 versions are exact only in full fp32);
2. build: every kernel source compiled with ``nvcc``, all at once; the
   registers, spills and static shared memory of every kernel instance
   (``-Xptxas -v``);
3. kernels against their plain versions: first ``deltagru_act`` (B in
   {1, 2, 8, 9}, H in {768, 770, 4097}, all operands 16-byte aligned and
   each of the four in turn 4-byte aligned; within ``TOL_F32`` on the
   card and the CPU, every case launched twice and the two results
   bitwise equal) and ``ops.deltagru_cell_fused`` against the dense GRU
   step; then at the two layer shapes of the
   paper's 2L-768H network (k = 896 and 1536), for both cells (GRU and
   LSTM), B in {1, 2, 8, 9} (the one-stream instance, the tile instance,
   two tile passes) with exactly 0, 1, U - 1, U, U + 1 and all column
   blocks fired (U: the fired blocks one unrolled group of the walk
   covers), a group across the x/h seam and, at B > 1, every block fired
   by one stream other than stream 0: fp32 within ``TOL_F32``; int8 and
   int4 bitwise equal to the plain version on the card and on the CPU, and
   each buffered instance (``buffered=True``) bitwise equal to its
   unbuffered twin; an LSTM step whose cell state saturates at the Q8.8
   rail; and narrow layouts (int8 ``block_k`` 8 and 4, int4 16 and 4)
   through the narrow-load instance, their buffered form (a ring filled by
   ``cp.async`` or 2-byte copies) bitwise equal to it, also launched after
   an L2 flush (copies that land late); then the engine step's two
   kernels (``engine_kernels_phase``): the Delta Unit at the main paths'
   layer shapes, N in {1, 3, 8, 9, 128}, θ 0 and 0.25 (a number and a
   device tensor), the input on the Q8.8 grid or not, with steps exactly
   at θ, NaN and ±inf inputs (deltas, memories and count totals bitwise),
   with the frame guard folded in (finite and last_x bitwise too) and with
   a host threshold of 0 on NaN memories; and the epilogue over 2, 4 and
   24 layers of those count rows at N in {1, 3, 8, 128}, grids of 2 to
   264 blocks, with non-finite values in a slot's first leaf and in
   another slot's last leaf alone (flags, poison and bad-state sums and
   ``last_x`` bitwise, over 2 layers the per-slot terms too, the slot sums
   bitwise the fixed-order tree, the other fp32 terms within
   ``TOL_EPILOGUE_REL``); then
   the train steps' fused AdamW (``adam_kernels_phase``): fp32 and bf16
   parameters (and bf16 with fp32 gradients, and a tree of both), leaves
   of 1, 3, 4095 and 2**20 + 1 elements aligned and 2-4 bytes off 16-byte
   alignment, clipping and decay on and off, steps 1 and 1000, NaN and
   +-inf gradients, heads and tails around vector pieces at element
   offsets 3 and 7 and operands at odd phases (all scalar): ``p``,
   ``mu`` and ``nu`` bitwise the plain version on the card, every case
   launched twice and once in place; then the clip's global norm
   (``norm_kernels_phase``): leaves of 1, 7 and 4097 elements, misaligned
   views bitwise their aligned copies, a mixed fp32 / bf16 tree, +inf and
   NaN leaves, a square and a sum past the fp32 range (inf), a 2**22 + 3
   element leaf and 300 leaves, within ``TOL_NORM_REL`` of the plain
   version, every case twice bitwise, and one graph replayed twice bitwise
   and once after its leaves doubled;
4. the int8/int4 kernels' own activation stage over every Q8.8 input,
   bitwise against ``torch.sigmoid`` / ``torch.tanh`` on the CPU after the
   LUT rounding;
5. the main path, per cell (``gru``: ``compile_deltagru`` of
   ``init_gru_model``; ``lstm``: ``compile_delta_program(cell="lstm")`` of
   ``init_lstm_model``) and backend (``fused``, ``fused_q8``,
   ``fused_q4``), from seeded random 2L-768H weights: a 1-stream
   ``DeltaStreamEngine.step_many`` over smooth synthetic frames at
   θx = θh = 0.25 under ``torch.cuda.set_sync_debug_mode("error")``, then a
   ``GruStreamBatcher`` over an 8-slot engine draining 16 requests of mixed
   lengths (its sessions open and close between replays). Each engine
   steps by replaying its CUDA graphs (the one-step graph captured at
   construction, the 16-, 8-, 4-, 2- and 1-step chunks of ``step_many``
   captured by a warm-up run of 31 frames before the timed run, each
   once); its state, carry and report must equal, bit for bit, the same
   frames stepped op by op through the engine's ``_one_step`` on a second
   engine (``eager_steps``), its outputs too or within ``TOL_HEAD``.
   Launch counts, the captures' taken back and each replay's added, must
   equal a step's launches (the layer kernels, a Delta Unit a layer, two
   for RG-LRU, and one epilogue) times the steps, and no other kernel may
   launch, in each run; the results must match the same program compiled
   with ``device="cpu"``;
5c. resilience (after 5b, below), on the main path's engines: (a) each
   of the eight 1-stream engines opens a session, steps, snapshots and
   ``checkpoint``s; ``DeltaStreamEngine.restore`` builds a second engine
   on the card (its graph captured, then the checkpoint written into its
   buffers); both step 20 frames bitwise alike in state, carry, shadows,
   outputs and report, the restored one through graphs captured over the
   buffers it has (the one-step graph before the restore wrote them, the
   16- and 4-step chunks after); ``corrupt_slot_state`` on it is flagged in
   ``bad_state`` by its next replay and ``rollback_stream`` restores the
   snapshot bitwise; ``step_many``, ``snapshot_streams``,
   ``rollback_stream`` and the corruption run under
   ``set_sync_debug_mode("error")``, and each engine's launches are
   exact; (b) the seeded chaos soak of ``tests/test_resilience.py::
   TestChaosSoak`` through ``serve_resumable`` at 2L-768H
   (``quantize_delta_model``, 8 slots, θ = 0.25; poison, a slot
   corruption, a stall and a crash at tick 120): every arrival terminal,
   one restart, ``recovered == quarantined >= 2``, every ``ok`` stream
   bitwise equal to a clean run of its sanitized frames on an 8-slot
   engine on the card, a second card run and a run of the same program
   with ``device="cpu"`` equal in every status and tick-based counter;
   (c) checkpoint and restore times, the soak's p99 tick wall and frames
   per second;
5d. training, the paper's recipe (Sec. IV-A) at 2L-768H CTC
   (``PAPER_NETWORKS["2L-768H"]``, seeded ``init_gru_model``, batches of
   ``digit_batch`` at its defaults, B = 32, T = 96): (a) 10 steps of
   ``make_gru_train_step(use_delta=False)``, Adam at 1e-3; (b) 10 steps with
   ``qat=EDGEDRNN_QAT`` at θx = θh = 0.25 from the pretrained weights
   (a fresh Adam state, as ``examples/train_gas_regression.py``); every
   loss finite and each stage's last 3 below its first. Each stage's
   first step runs eagerly, the other nine through the compiled step (one
   CUDA graph, captured at its first call; the last call under
   ``set_sync_debug_mode("error")``), and the ten are held bitwise
   (losses, parameters, moments) against ten eager steps (``.eager``) from
   a copy of the stage's first state. Each stage's first
   step is held against the same step with ``device="cpu"`` from the same
   weights and batch: the loss within ``TOL_TRAIN_LOSS``, every gradient
   leaf within ``TOL_TRAIN_GRAD`` of its largest element, every updated
   parameter within what Adam's first step makes of that; in (b) the CPU
   replays the card's LUT outputs where its own differ, each such flip
   within ``FLIP_MARGIN`` of a rounding boundary, and the flips are
   counted. Training launches the global norm and the fused Adam once a
   step each (eager steps, compiled steps' warm-ups and replays) and no
   other hand-written kernel. (c) A ``CheckpointManager`` saves the compiled step's state
   after step 5 of (b); it restores bitwise, and steps 6-10 from it and
   from the state in memory, both through the compiled step under
   ``torch.use_deterministic_algorithms(True)`` (a switch in the capture's
   key: it captures again), are bitwise equal. (d)
   ``quantize_delta_model`` exports the trained stack to ``fused_q8`` on
   the card; an engine of 32 streams replays its captured graph over a
   fresh digit batch under ``set_sync_debug_mode("error")``, with exact
   launches of the int8 GRU kernel and no other, its final state bitwise
   and its outputs within ``TOL_HEAD`` of the same program compiled with
   ``device="cpu"``; the greedy-decode edit distance is reported;
5e. the serving fabric (``ShardedStreamFleet`` behind ``StreamRouter``,
   driven by ``run_fabric_load``), at ``benchmarks/BENCH_fabric.json``'s
   configuration: 8 shards × 128 streams on the one card (the mesh lists
   it once a shard), 2000 Poisson arrivals at 120 a tick of 6-20 frames
   (seed 777), queues of 64, shard 5 lost at tick 12 (drain checkpoint,
   replay of its streams from frame 0 on the survivors). (a) At the
   record's own width (I = 8, H = 16, L = 2, O = 3, θ = 0.05,
   ``quantize_delta_model`` of seed-0 ``init_gru_model``): the record's
   ``counts`` block key for key, as ``benchmarks/loadgen_fabric.py``
   computes it, and every completed stream bitwise equal to a clean run
   on a same-width reference engine on the card. (b) The same traffic at
   2L-768H (``fused_q8``, θx = θh = 0.25, frames of 40): the same counts in
   two runs, every completed stream bitwise its reference on the card, the
   first reference group rerun with ``device="cpu"`` (state bitwise,
   outputs within ``TOL_HEAD``), the drain checkpoint restored through
   ``DeltaStreamEngine.restore`` equal in state, carry and report to the
   dying shard's export taken just before ``remove_shard``, launches of
   the int8 GRU kernel exactly layers × (live shards summed over the ticks
   + every other engine's warm-up and replays) and no other kernel, every
   tick on which no stream can finish run under
   ``set_sync_debug_mode("error")``; ticks 6-10 of the second run profiled.
   The sessions (``session_opens``): an engine's ``open_stream`` is at
   most two host launches (the slot buffer's fill and one replay of its
   open program, profiled), a fleet open the shard engine's reset replay
   alone, its rollback shadow untouched; host µs an open. Then a ``fused``
   fleet of 4 × 8 through ``step_many`` (20 frames),
   every shard's state and outputs bitwise a standalone 8-stream engine,
   with exact launches of the fp32 GRU kernel;
5f. the LM zoo's serving path (``lm_phase``), from seeded weights drawn
   on the card by ``init_lm``. Every ``LmEngine`` prefill and decode step
   is one replay of a CUDA graph (the prefill's captured at its
   signature's first use: a warm-up prefill, then the capture); each
   model's timed run holds every prefill and decode replay's logits and
   caches bitwise against ``lm_prefill`` / ``lm_decode`` run op by op on
   copies of the same caches and inputs (``eager_twin``). (a) llama3.2-1b
   at full size in bf16, an ``LmEngine(batch=4, max_len=256)`` under a
   ``ContinuousBatcher`` draining 12 prompts of 16-96 tokens, 32 new
   tokens each, twice with the same tokens (the first run's prefills held
   against their eager twins), one prefill capture a distinct wave length
   (``check_waves``), a staggered admission that leaves the live
   request's tokens those of its solo run, and no hand-written kernel;
   (b) rwkv6-1.6b at full size in bf16, a prefill of 4 prompts of 128
   tokens (its capture: ``rwkv6_scan_bf16`` launched 24 times by the
   warm-up and 24 by the replay), then ``generate_greedy`` on them for 32
   steps, ``rwkv6_scan_bf16`` launched exactly 24 times by the prefill's
   replay and by each decode step and no other kernel, each launch of the
   prefill and the first decode step held against its plain version on
   the inputs the path gave it (within ``TOL_F32``; recorded on the
   replays' eager twins, since a replay calls no wrapper); (c)
   recurrentgemma-9b at full size, all 38 layers (26 RG-LRU), the same,
   ``rglru_scan`` launched 26 times by the prefill's replay (52 by the
   capturing call) and never by a decode step, each launch bitwise its
   plain version; the bf16 prefill-then-decode logits of (a) and (c)
   within ``TOL_LM_BF16_RMS`` of the teacher-forced forward; (d)
   llama3.2-1b and rwkv6-1.6b in fp32 at full width and 2 layers, the card
   against the CPU within ``TOL_LM`` and prefill-then-decode against the
   forward within ``TOL_F32``; (e) rwkv6-1.6b's fp32 2-layer prefill
   [2, 32] under ``REPRO_RWKV_CHUNKED=1`` (the chunk-parallel route, plain
   PyTorch, no kernel) within ``TOL_LM`` of the same prefill through
   ``rwkv6_scan_f32``, and an engine's prefill graph captured again under
   that route; then ``PREFILL_GRAPHS + 1`` prompt lengths swept three
   times through one engine of that model (``bound_sweep``: evictions, one
   shared pool, no memory kept by an evicted graph); with each model's
   init, prefill (graph replay and eager, the capture's ms split into
   warm-up, body and end, the prefill graphs' shared pool, a profiled
   replay's kernels,
   busy time and idle share, host syncs: none) and decode times, kernels
   a decode step and idle share, peak memory, the decode graph's capture
   ms and private pool (``graph_pool_bytes``), and the drain's tokens a
   second;
5g. the rest of the LM zoo (``zoo_phase``), seeded ``init_lm`` on the
   card, bf16, full size, through the same graphs and eager twins: (a)
   deepseek-v2-lite-16b (MLA, MoE) under the batcher as (a) of 5f (two
   drains the same tokens, one prefill capture a wave length, a staggered
   admission that leaves the live request's tokens those of its run with
   the same waves); (b) granite-moe-3b-a800m, (c) llama-3.2-vision-11b
   with seeded image embeddings [4, 1601, 7680], (d)
   seamless-m4t-large-v2 with seeded audio frames [4, 1536, 160], (e)
   qwen2.5-32b (its init's peak beside the card's memory), (f) olmo-1b
   and (g) smollm-360m, through ``generate_greedy`` on 4 prompts of 128
   tokens for 32 steps; each model's prefill-then-decode logits within
   ``TOL_LM_BF16_RMS`` of its teacher-forced forward (MoE with capacity
   for every token; routing flips held to ``ROUTE_MARGIN_BF16``); phases
   5f and 5g together must have served every arch of the registry at full
   size (``check_served``); (h) all seven in fp32 at full width and the
   fewest layers that hold each block kind, card against CPU within
   ``TOL_LM`` (a flip within ``ROUTE_MARGIN_F32`` replayed) and decode
   against forward within ``TOL_F32``; no hand-written kernel launched;
   per model the times of 5f, the init's peak and the host RSS; then one
   line of every served model's prefill rows (``lm_prefill_rows``);
5h. LM training (``lm_train_phase``): (a) ``repro_torch.launch.train``
   trains llama3.2-1b at full size (the registry config: bf16 weights,
   fp32 Adam moments, remat) for 8 steps of [8, 128], every loss finite,
   and 2 steps with ``--grad-accum 2``, each step one replay of its
   compiled step; 5 steps of the compiled ``make_lm_train_step`` on one
   fixed batch with the launcher's optimizer, whose loss falls, one more
   under ``set_sync_debug_mode("error")``, 2 more profiled, then the same
   8 steps through its eager twin from a copy of the first state, bitwise
   in losses, parameters and moments; eager and compiled: kernels a step,
   device busy, idle share, the fused Adam's time, the step cut into
   forward, backward and Adam, peak memory, tokens/s, beside the step's
   bound, and the capture's time and graph pool; (b) one eager train step
   on the card against the same step on
   the CPU in fp32 from the same seeded weights and batch [2, 32]:
   llama3.2-1b, rwkv6-1.6b and granite-moe-3b-a800m at full width and 2
   layers, recurrentgemma-9b at full width and 3 layers (its vocabulary
   cut), deepseek-v2-lite-16b, llama-3.2-vision-11b and
   seamless-m4t-large-v2 at ``reduced()`` widths, and rwkv6-1.6b again
   at 2 layers under ``REPRO_RWKV_CHUNKED=1`` on both devices: the loss within
   ``TOL_LM``, every gradient leaf within ``TOL_LM_TRAIN_GRAD`` of its
   largest (``TOL_LM_TRAIN_GRAD_RWKV6``), no zero card gradient on a
   scan's leaves, the parameters after Adam within its first-step bound,
   MoE choices replayed (flips within ``ROUTE_MARGIN_F32``); (c) the same
   3 ``--reduced`` steps of llama3.2-1b and granite-moe-3b-a800m twice,
   losses bitwise equal, and a run stopped at step 4 by its checkpoint
   and resumed to 6 bitwise an uninterrupted run's steps 5-6, through the
   launcher's compiled step. The blocks run the plain scans under
   autograd: the only hand-written kernels launched are the global norm,
   once a step, and the fused Adam, once a step and parameter dtype;
5i. the mesh paths (``mesh_phase``) on a (4, 2) mesh over the card listed
   8 times (``best_mesh(devices=[card] * 8, model_parallel=2)``): (a) the
   expert-parallel forward of granite-moe-3b-a800m and
   deepseek-v2-lite-16b at full width, 2 layers, fp32, against the CPU
   under its mesh and against the sorted path within ``TOL_LM`` (choices
   replayed, flips within ``ROUTE_MARGIN_F32``), and granite at full size
   in bf16 once beside the sorted path; (b) llama3.2-1b's train step at
   full size under the mesh (``grad_accum=2``, the ZeRO-1
   ``accum_rules``, the one-hot embedding): loss bitwise the step without
   a mesh, gradients within ``TOL_LM_TRAIN_GRAD``, parameters within
   Adam's first-step bound; timed steps; (c) a granite mesh step against
   the CPU, every fed expert with a nonzero gradient; (d)
   ``pipeline_forward`` over 4 stages bitwise the stages applied in turn
   and within ``TOL_F32`` of the CPU; (e) ``--model-parallel 2`` bitwise
   ``--model-parallel 1`` and ``prefetch_to_mesh``'s spec; the global
   norm and the fused Adam once a step and no other hand-written kernel;
5j. the examples and the launch tooling (``examples_phase``): the card's
   HBM copy rate and bf16 matmul rate beside ``H100``'s data-sheet
   constants, and ``gpu_batch1_gru_roofline`` of 2L-768H at phase 5's
   sparsity beside its measured step; the four example twins
   (``examples/*_torch.py``), two in this process with their launches
   counted (the quickstart launches rows 1, 2, 4, 6 and 7, the digits twin
   rows 1 and 2, the B = 4 tile under its batcher, exactly two a replay,
   and rows 13 and 14, the fused Adam and the global norm, once a
   compiled training step each)
   and two as subprocesses, each printing its JAX example's labelled lines
   and holding its invariants (the quickstart and the decode twin also
   against ``--device cpu``); ``repro_torch.launch.dryrun --all`` over the
   (16, 16) mesh over the card, every runnable cell ok;
5k. the mesh paths over ranks (``rank_phase``), one process a card over
   NCCL: with one card this process is the one rank of a group over a
   ``file://`` store, with more ``spawn_ranks`` starts one a card. (a)
   llama3.2-1b's compiled ``make_lm_train_step`` at full size, bf16, [8,
   128] over the ranks against the same step in one process: at world 1
   every metric of 3 steps and the state after a fourth, profiled step
   bitwise (beyond: every loss within ``TOL_RANK_BF16_REL`` and clip norm
   within ``TOL_RANK_NORM_REL``, the ranks' states equal), the gradients'
   all-reduces captured in the graph (NCCL's kernels a replay printed),
   the replays' wall p50, and the first call's peak memory beside
   ``dryrun.run_cell``'s per-device peak; (b)
   ``moe_apply_ep`` at granite-moe-3b-a800m's full width in fp32 over the
   ranks' experts axis, bitwise the one-process loop, its two all-to-alls
   and three sums counted; (c) ``launch.train --reduced`` under
   ``torch.distributed.run --nproc-per-node <cards>``, its losses bitwise
   the one-process launcher's at world 1 (within ``TOL_RANK_REL``
   beyond); the global norm and the fused Adam once a step, no other
   hand-written kernel; (d) the train state sharded over the ranks as the
   reference lays it out (``launch.train.init_state``,
   ``make_lm_train_step_fn(..., state_sharding=)``): llama3.2-1b at full
   size, bf16, [8, 128] under FSDP and ZeRO-1, 3 steps and a profiled
   replay each, against (a)'s one-process step (metrics and state bitwise
   at world 1, where every extent is 1; losses and clip norms within
   ``TOL_RANK_BF16_REL`` / ``TOL_RANK_NORM_REL`` beyond), every leaf the
   block of its spec, the collectives issued at the warm-up and the
   capture and none at a replay, each rank's state bytes, the first
   call's peak beside ``dryrun.run_cell``'s, the replays' wall p50, busy
   and idle share; over four cards also llama-3.2-vision-11b at full size
   under FSDP at (4, 1) (its state fits no one card: losses finite, a
   rank's bytes at most a quarter of the whole plus the replicated
   leaves); over several cards the ranks that hold a block alike hold it
   bitwise; (e) the work split over the ``model`` axis (tensor
   parallelism): at world 1 every extent is 1, no leaf splits and (d)'s
   FSDP step at (1, 1) is bitwise (a)'s one-process step with no
   collective added; over several cards llama3.2-1b at full size under
   FSDP at (1, world) and, from four cards, under FSDP and ZeRO-1 at (2,
   world / 2), and granite-moe-3b-a800m at full size under FSDP at (2,
   world / 2) against its one-process eager step (updated in place)
   under a mesh of that shape listing the card, as (d) holds and times
   its runs, but for the losses after the first step, held within
   ``TOL_RANK_SPLIT_STEP_REL``;
6. times on the card: each kernel instance at B = 1 and its plain version
   (device time from CUDA-graph replay between CUDA events, also with the
   L2 flushed before each call, and the kernel's time per call launched
   from Python), each GRU/LSTM step also at B = 8 (the tile instance), the
   floor under a launch (an empty kernel of the q8 build, two launches),
   the Delta Unit's launches of one step and the epilogue over that step's
   state for GRU ``fused`` / ``fused_q8`` and RWKV6 (warm, cold, from
   Python, plain, bound),
   the dense ``torch.addmm``
   over the cell's fp32 volume as a yardstick the port never calls,
   ``deltagru_act`` also cold, at B = 8 and beside an empty kernel of its
   build at its grid, ``ops.deltagru_cell_fused`` at I = 40 and 768, and
   per path the engine, through its graph and op by op
   (``eager_steps``): wall and CUDA-event time per step with its kernels
   per step and idle share (``torch.profiler``, which sees the kernels of
   a replay one by one), the per-frame latency of ``step`` (median and p95
   over the frames), each chunk graph's capture time and the batcher's frames per
   second; per training stage of 5d, eager against compiled, the wall per
   train step, frames per second, kernels per step and idle share, the
   fused Adam's time, the eager step cut into forward, backward and Adam,
   the capture's time and graph pool, the peak memory, and the export's
   time; for 5e (b)
   the wall, streams and frames a second, the steady tick p50 and p99
   (``loadgen_fabric``'s rule: ticks over 10 × the median dropped), replays
   a tick, kernels, device busy and idle share a profiled tick, and the
   scale-down's time; the fused Adam's instances and the global norm at
   their main paths' trees (fp32: the 2L-768H GRU; bf16: llama3.2-1b,
   timed in 5h) beside their plain versions, ``torch._fused_adamw_`` and
   ``torch.nn.utils.get_total_norm``, and the bytes bounds.

The delta-ized LM cells run through the same phases: in phase 3
``delta_spmv`` with fp32 and with bf16 operands (the LM layer shapes, the
64-row decay call whose k blocks a cluster splits, unpacked ragged edges,
``ldw % 4 != 0``; B in {1, 2, 8, 9} on the walk's tails as above; every
case launched twice and the two results bitwise equal), ``rwkv6_scan`` (B
in {1, 2, 8, 9}, T in {1, 37, 128}, H in {32, 3}, with and without s0, and
4-byte aligned operands; within ``TOL_F32``), ``rglru_scan`` (the same B
and T, W in {4096, 4094, 4097}, with and without h0, and each operand in
turn 4-byte aligned; bitwise on the card), every scan case launched twice
and the two results bitwise equal; in phase 5 ``rwkv6 fused`` (RWKV6 at
D = 2048, 24 layers) and ``rglru fused`` (RG-LRU at D = W = 4096, 4
layers) from seeded random weights over the smooth stream ``c <- 0.9 c +
0.35 n``, through their captured graphs held to the eager steps as
above, with exact launch counts of ``delta_spmv`` (4 per layer step)
and of the cell's scan (1 per layer step) and no other kernel, against
the CPU program at θ = 0 over 50 frames and layer by layer in lockstep at
θ = 0.25; in phase 6 their kernels' times at the main path's shapes,
``delta_spmv`` (fp32 and bf16) per layer step at 0 %, ~10 % and 100 %
fired, also with a cold L2, the scans also cold, at B = 8, at T = 128 and
beside an empty kernel of their build at the same grid, and the engine
profile of both paths. Row 9b, ``rwkv6_scan``'s bf16 instance (bf16 r, k,
v with fp32 w, u and state, the bf16 RWKV6 models' operands), is held in
phase 3 at B in {1, 4, 9}, T in {1, 37, 128}, H in {32, 3}, with and
without s0 and with r 2-byte aligned, within ``TOL_F32``, and timed in 5f
at the LM path's shapes. Both instances are also held at the chunked
kernel's edges (``rwkv6_scan`` at T > 1 stages ``RWKV6_CHUNK`` steps at a
time): T in {2, chunk - 1, chunk, chunk + 1}, B in {1, 4, 9}, H in {32, 3},
with s0 and without, with r one element into its buffer, on a grid of a
third of the units, and with r, k, v, w in the model's [B, T, H, D]
memory, from a generator of their own.

Each phase's seconds are logged where the next one starts.

The line before the last is ``{"kernels": [...]}`` (every kernel instance;
the ``launches`` of a main-path instance are those of phases 5, 5b, 5c, 5d,
5e and 5f (the fabric's runs add to the int8 and fp32 GRU kernels', 5f to
the scans'; 5g launches none; the fused Adam's and the global norm's are
those of 5d's training runs (fp32) and 5h (a)'s launcher (bf16)), each run
counted from zero; those of an
instance on no main path, a buffered one, ``delta_spmv_bf16`` or
``deltagru_act``, are those of phases 3 and 6, and its ``path`` names the
entry that reaches it); the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# fp32 kernel vs its plain version: both sum up to 1536 products per
# output in different orders. The error of such a sum grows like sqrt(k)
# ulps of the terms' magnitude: 1e-5 bounds it at the test widths of the
# CPU suite (k <= 288, the JAX package's own batch-against-solo bound), and
# 1e-4 at k <= 1536 keeps a factor of four over that sqrt(k) scaling.
TOL_F32 = 1e-4
# The LM-path kernels are held to TOL_F32 times the magnitude of the plain
# result, max(1, max|plain|). delta_spmv at k = 4096 sums 4096 products per
# output: a random-sign sum's rounding error grows like sqrt(k) ulps of its
# own magnitude, 64 * 6e-8 = 3.8e-6 of it, and 1e-4 keeps a factor of 26
# over that. The scans sum 64 products (WKV) or none (RG-LRU) per step, but
# their state carries the error of every earlier step over T <= 128 steps.
# The head is a plain fp32 matmul (768 x 12) left to the library on each
# device; the order of its sum differs between the card and the CPU.
TOL_HEAD = 1e-5
# bf16 delta_spmv against its plain version: the same exact fp32 products
# (of bf16 values) summed in other orders, then one rounding to bf16 each,
# so the two may land one bf16 step apart: at most 2**-7 of the result's
# magnitude, held against max(1, max|plain|) like TOL_F32.
TOL_BF16 = 2.0 ** -7
# The LM paths against the CPU program, per state tensor and output, scaled
# the same way: the error of one layer (matvecs over 2048 or 4096 products,
# the WKV sum, group norm, which divides by a head's standard deviation and
# so amplifies a head's absolute error) passes on to the next, through 24
# layers of group norm in RWKV6. On the CPU, fp32 against fp64 at D = 512
# the scaled error stayed at 1e-6 or less in every layer; 1e-3 keeps a
# factor of ten over TOL_F32 for what 24 layers add.
TOL_LM = 1e-3
# The train step on the card against the same step on the CPU (phase 5d):
# the loss is a mean of CTC log-likelihoods over 96-frame recursions on a
# forward whose sums (808 and 768 products a gate, 96 steps, 2 layers) run
# in other orders on each device: 1e-5 of it. A gradient leaf sums BPTT
# over 96 steps: the CPU suite measured 2e-6 of a leaf's largest element at
# H = 32, T = 24; H = 768 sums 24 times the terms and T = 96 four times the
# steps, a factor of ~10 under sqrt growth, and 1e-4 keeps five over that.
# The engine epilogue's fp32 terms against its plain version on the card
# (R5): the kernel sums the layers and the slots in index order, PyTorch's
# reductions pair them otherwise, a few ulps of the sum (24 layers, 128
# slots); counts, flags, poison and bad-state sums and last_x are exact.
TOL_EPILOGUE_REL = 1e-6
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_GRAD = 1e-4
# A LUT output of the CPU's QAT forward may differ from the card's only
# where its pre-rounding value lies this close (in Q1.4 grid steps) to a
# rounding boundary: the two devices' arguments differ by float32 sum
# orders (~1e-6 after 96 steps of accumulation, 4e-6 of a step through the
# sigmoid's slope, 16 steps a unit), so 1e-3 of a step keeps a factor of
# ~250.
FLIP_MARGIN = 1e-3
TRAIN_STEPS = 10
TRAIN_LR = 1e-3
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM data sheet, fp32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20
THETA = 0.25                  # Q8.8 64
N_FRAMES = 300
SEED = 0
# The delta-ized LM cells at full width: RWKV6 at rwkv6-1.6b's d_model and
# depth (configs/rwkv6_1_6b.py); RG-LRU at recurrentgemma-9b's width with 4
# of its 26 recurrent layers (configs/recurrentgemma_9b.py): all 26 would be
# 15.7 GB on the card and again on the host for the CPU program. The head
# maps to 48 outputs, OUTPUT_SIZE of benchmarks/lm_delta_bench.py.
LM_OUTPUT = 48
RGLRU_LAYERS = 4


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def ptxas_summary(text: str) -> list:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its registers,
    spill stores and loads, and static shared memory (names demangled by
    ``c++filt`` where the host has it)."""
    import re
    import shutil
    entries, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            entries[cur] = {"regs": None, "spill": (0, 0), "smem": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entries[cur]["spill"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[cur]["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            entries[cur]["smem"] = int(sm.group(1)) if sm else 0
    names = list(entries)
    shown = dict(zip(names, names))
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        plain = out.stdout.splitlines()
        if out.returncode == 0 and len(plain) == len(names):
            shown = {n: re.sub(r"\(anonymous namespace\)::|^void |\(.*$",
                               "", p) for n, p in zip(names, plain)}
    return [f"{shown[n]}: {e['regs']} registers, spill stores "
            f"{e['spill'][0]} B / loads {e['spill'][1]} B, static smem "
            f"{e['smem']} B" for n, e in entries.items()]


def smooth_frames(rng, t: int, n: int, i: int):
    """Smooth synthetic sensor frames ``[t, n, i]``: a few sinusoids per
    channel plus small noise (the repository has no dataset)."""
    import numpy as np
    tt = np.arange(t, dtype=np.float64)[:, None, None]
    out = np.zeros((t, n, i))
    for _ in range(3):
        f = rng.uniform(0.005, 0.05, (1, n, i))
        ph = rng.uniform(0, 2 * np.pi, (1, n, i))
        out += rng.uniform(0.2, 0.6, (1, n, i)) * np.sin(2 * np.pi * f * tt + ph)
    out += rng.normal(0, 0.02, out.shape)
    return out.astype(np.float32)


def tree_to(tree, device):
    """A program state's tensors copied to ``device``."""
    import dataclasses

    import torch
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, stack=tree_to(tree.stack, device))
    vals = [tree_to(x, device) for x in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


def tree_leaves(tree):
    import dataclasses

    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return tree_leaves(tree.stack)
    return [leaf for x in tree for leaf in tree_leaves(x)]


def device_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in a CUDA
    graph and replayed ``reps`` times between CUDA events, so the host's
    launch cost is not in it. Weights stay in L2 across calls (the 2L-768H
    volumes are at most 22.4 MB of the 50 MB), as they do between the
    steps of a stream."""
    import torch
    from repro_torch.kernels import ops
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)

    def body():
        for _ in range(calls):
            fn()
    replay = ops.capture_cuda_graph(body)
    replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * calls)


def eager_ms(fn, iters: int = 100) -> float:
    """Time per call issued from Python, launch overhead included."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def step_latencies_us(step, frames) -> list:
    """Per-frame latency of ``step(frame)`` (an engine's ``step``): frame
    in on the host to output ready on the device (each step ends in a
    synchronise), after warm-up."""
    import torch
    for x in frames[:10]:
        step(x)
    torch.cuda.synchronize()
    lat = []
    for x in frames:
        t0 = time.perf_counter()
        step(x)
        torch.cuda.synchronize()
        lat.append(1e6 * (time.perf_counter() - t0))
    return lat


PAD_KERNEL = "spin_kernel"   # torch.cuda._sleep's kernel


def engine_profile(run, n: int, match: str | None = None) -> dict:
    """Kernels per step, device-busy time per step and the idle share of
    ``run()``, ``n`` steps (an engine's ``step_many``), from
    ``torch.profiler``; beside them the wall time and the device time
    between two CUDA events around the run, per step; the launches per
    step of each kernel name (``by_name``; memory copies apart, under
    ``copies_per_step``); with ``match`` (a string or a tuple of them), the
    busy time per step of the kernels whose name holds it (each string's
    under ``match_us_by``, their sum under ``match_us_per_step``).

    A session has read fewer device events than the run launched (7.66
    kernels a 2L-768H step, whose graph holds 8), so the session first
    runs 64 short padding kernels (``torch.cuda._sleep``) and waits 2 ms:
    what it loses at its start is padding, which every figure leaves out.
    ``counted_kernels`` holds ``by_name`` to the wrappers' counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.002)
        t0 = time.perf_counter()
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(0.002)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and PAD_KERNEL not in e.name]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0) + 1
    copies = sum(v for k, v in by_name.items() if k.startswith("Memcpy")
                 or k.startswith("Memset"))
    out = {"kernels_per_step": len(events) / n,
           "copies_per_step": copies / n,
           "by_name": {k[:90]: v / n for k, v in sorted(
               by_name.items(), key=lambda kv: -kv[1])},
           "device_busy_us_per_step": busy_us / n,
           "wall_us_per_step": 1e6 * wall / n,
           "event_us_per_step": 1e3 * start.elapsed_time(stop) / n,
           "idle_share": 1.0 - busy_us / (1e6 * wall) if events else None}
    if match is not None:
        names = (match,) if isinstance(match, str) else match
        out["match_us_by"] = {m: sum(e.time_range.elapsed_us()
                                     for e in events if m in e.name) / n
                              for m in names}
        out["match_us_per_step"] = sum(out["match_us_by"].values())
    return out


# the train steps' optimizer kernels, by device kernel name
OPT_KERNELS = ("fused_adam", "global_norm")
# the engine step's two kernels: KernelInfo name -> device kernel name
STEP_KERNELS = {"delta_unit_f32": "delta_unit_kernel",
                "engine_epilogue_f32": "engine_epilogue_kernel"}


def counted_kernels(prof: dict, counted: dict, what: str) -> None:
    """Hold an ``engine_profile`` of a run to the launches its kernel
    wrappers counted in it (``counted``: ``{KernelInfo name: launches a
    step}``): the engine step's two kernels' events a step by device
    name; raises on a difference (the profile lost or added events)."""
    for name, device_name in STEP_KERNELS.items():
        want = counted.get(name, 0)
        got = sum(v for k, v in prof["by_name"].items() if device_name in k)
        if abs(got - want) > 1e-9:
            raise AssertionError(
                f"{what}: the profile read {got} launches a step of "
                f"{device_name}, its wrapper counted {want}")


def eager_steps(eng, frames):
    """``eng``'s step run op by op, the engine's ``_one_step`` over
    ``frames`` (``[T, I]`` or ``[T, N, I]``) from its buffers, as the
    engine stepped before its step was a captured graph: the reference the
    graph's replays are held to. One host-to-device copy for the chunk.
    The final state and carry are written into the engine's buffers, so its
    ``report()`` reads them. Returns the outputs ``[T, N, O]``."""
    import torch
    xs = eng._to_device(frames).reshape(len(frames), eng.n_streams, -1)
    state, carry = eng.state, eng._carry
    outs = []
    for x in xs:
        out, state, carry = eng._one_step(state, carry, x)
        outs.append(out)
    eng._write(eng.state, eng._carry, state, carry)
    eng._n_steps += len(frames)
    return torch.stack(outs)


def graph_against_eager(path, eng, ref, outs, ref_outs) -> str:
    """Hold a graph engine's run (``outs``, its state, carry and report)
    against the eager run of the same frames (``ref``, ``ref_outs``) on the
    card: the state and the carry bitwise, the report equal, the outputs
    bitwise or, where the head's library matmul differs under capture,
    within ``TOL_HEAD``. Returns a line for the log; raises on a
    difference."""
    import torch
    g_leaves, r_leaves = tree_leaves(eng.state), tree_leaves(ref.state)
    state_same = all(torch.equal(a, b) for a, b in zip(g_leaves, r_leaves))
    state_err = max(scaled_err(a, b) for a, b in zip(g_leaves, r_leaves))
    carry_same = all(torch.equal(eng._carry[k], ref._carry[k])
                     for k in ref._carry)
    outs = outs.reshape(ref_outs.shape)
    out_same = torch.equal(outs, ref_outs)
    out_err = float((outs - ref_outs).abs().max())
    rep_same = eng.report() == ref.report()
    line = (f"  {path} graph vs eager on the card: state bitwise "
            f"{state_same} (scaled {state_err:.3e}), carry bitwise "
            f"{carry_same}, outputs bitwise {out_same} ({out_err:.3e}), "
            f"report equal {rep_same}")
    if not (state_same and carry_same and rep_same
            and out_err <= TOL_HEAD):
        raise AssertionError(f"{path}: the graph's steps differ from the "
                             f"eager steps:\n{line}")
    return line


def buffer_ptrs(eng) -> list:
    """Data pointers of an engine's buffers: the live state, carry and frame
    its captured step reads and writes, and the rollback shadows."""
    bufs = (tree_leaves(eng.state) + list(eng._carry.values()) + [eng._x]
            + tree_leaves(eng._snap_state) + list(eng._snap_carry.values()))
    return [t.data_ptr() for t in bufs]


def recording(engine_cls):
    """A subclass of ``engine_cls`` that keeps every engine it makes and
    the buffer pointers each captured its step graphs over."""
    class Recorded(engine_cls):
        made = []

        def __init__(self, *args, **kwargs):
            self.captured_ptrs = None
            super().__init__(*args, **kwargs)
            Recorded.made.append(self)

        def _capture_step(self, k=1, session=None):
            if session is None:
                self.captured_ptrs = buffer_ptrs(self)
            super()._capture_step(k, session)

    return Recorded


class env_var:
    """Set an environment variable inside a ``with`` block and restore it
    (or its absence) after: the blocks read the scan-route variables
    (``REPRO_RWKV_CHUNKED``, ``REPRO_RGLRU_ASSOC``) at each call."""

    def __init__(self, name: str, value: str):
        self.name, self.value = name, value

    def __enter__(self):
        self.old = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.old
        return False


class no_sync:
    """Inside, a host sync on a CUDA device raises
    (``torch.cuda.set_sync_debug_mode("error")``)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        import torch
        if self.cuda:
            torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        import torch
        if self.cuda:
            torch.cuda.set_sync_debug_mode("default")
        return False


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def same_buffers(a, b) -> bool:
    """Two engines' state, carry and rollback shadows bit for bit."""
    import torch
    leaves = zip(tree_leaves(a.state) + tree_leaves(a._snap_state),
                 tree_leaves(b.state) + tree_leaves(b._snap_state))
    return (all(torch.equal(x, y) for x, y in leaves)
            and all(torch.equal(a._carry[k], b._carry[k])
                    and torch.equal(a._snap_carry[k], b._snap_carry[k])
                    for k in a._carry))


def restore_round_trip(path, eng, prog, task, frames, engine_cls,
                       ckpt_dir) -> dict:
    """The resilience phase's part (a) on one main-path engine ``eng``
    (one stream, 41 ``frames``): open a session, step, snapshot, step,
    ``checkpoint``; ``engine_cls.restore`` a second engine (built, its
    graph captured, then the checkpoint written into its buffers); both
    step 20 frames, bitwise equal in state, carry, shadows, outputs and
    report, the restored engine through its one capture over the buffers
    it captured; then ``corrupt_slot_state`` on the restored engine is
    flagged in ``bad_state`` by its next step, ``rollback_stream`` brings
    back its snapshot bit for bit, and both engines, rolled back, step 5
    frames alike. ``step_many``, ``snapshot_streams``, ``rollback_stream``
    and the corruption run under ``no_sync``. Returns the times and the
    number of engine steps run (each launches its step's kernels)."""
    import torch
    from repro_torch.serve.faults import corrupt_slot_state
    dev = eng.device
    eng_steps = engine_steps(eng)
    sid = eng.open_stream()
    with no_sync(dev):
        eng.step_many(frames[:10])
        eng.snapshot_streams()
        eng.step_many(frames[10:15])
    sync(dev)
    t0 = time.perf_counter()
    eng.checkpoint(ckpt_dir)
    ckpt_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    back = engine_cls.restore(ckpt_dir, prog, task, device=dev)
    sync(dev)
    restore_ms = 1e3 * (time.perf_counter() - t0)
    cuda = dev.type == "cuda"
    if not same_buffers(eng, back) or (back._slot_busy, back._n_steps) != (
            eng._slot_busy, eng._n_steps):
        raise AssertionError(f"{path}: the restored engine differs")
    with no_sync(dev):
        a = eng.step_many(frames[15:35])
        b = back.step_many(frames[15:35])
    graphs = back.graph_stats
    if not (torch.equal(a, b) and same_buffers(eng, back)
            and back.report() == eng.report()):
        raise AssertionError(f"{path}: the restored engine stepped apart "
                             "from the one it was checkpointed from")
    # the one-step graph captured before the restore wrote the buffers,
    # the 16- and 4-step graphs of step_many's 20 frames after it
    if cuda and (graphs["captures"] != 3 or graphs["replays"] != 2
                 or graphs["steps"] != 20
                 or back.captured_ptrs != buffer_ptrs(back)):
        raise AssertionError(f"{path}: restored engine graph {graphs}, "
                             "want 3 captures, 20 steps in 2 replays over "
                             "the buffers it captured")
    capture_ms = 1e3 * graphs["capture_s"]
    snap = [t.clone() for t in tree_leaves(back._snap_state)]
    keys = back._PER_STREAM_KEYS + ("last_x",)
    snap_carry = {k: back._snap_carry[k].clone() for k in keys}
    with no_sync(dev):
        corrupt_slot_state(back, sid)
        back.step(frames[35])
    bad = float(back.host_carry()["bad_state"][sid])
    with no_sync(dev):
        back.rollback_stream(sid)
        eng.rollback_stream(sid)
    rolled = (all(torch.equal(x, y) for x, y in zip(tree_leaves(back.state),
                                                    snap))
              and all(torch.equal(back._carry[k], snap_carry[k])
                      for k in keys))
    with no_sync(dev):
        a = eng.step_many(frames[36:41])
        b = back.step_many(frames[36:41])
    if bad != 1.0 or not rolled or not torch.equal(a, b):
        raise AssertionError(f"{path}: corruption flagged {bad} (want 1.0), "
                             f"rollback bitwise {rolled}, after it equal "
                             f"{torch.equal(a, b)}")
    return {"ckpt_ms": ckpt_ms, "restore_ms": restore_ms,
            "capture_ms": capture_ms,
            "steps": engine_steps(eng) - eng_steps + engine_steps(back)}


SOAK_ARRIVALS = 200
SOAK_SLOTS = 8


def soak_arrivals(input_size: int) -> list:
    """The chaos soak's schedule (``tests/test_resilience.py::
    TestChaosSoak``): 200 arrivals of 5-29 standard-normal frames, 0-3
    ticks apart, seed 1234."""
    import numpy as np
    rng = np.random.default_rng(1234)
    arrivals, t = [], 0
    for _ in range(SOAK_ARRIVALS):
        n = int(rng.integers(5, 30))
        arrivals.append((t, rng.standard_normal((n, input_size)).astype(
            np.float32)))
        t += int(rng.integers(0, 4))
    return arrivals


def soak_plan():
    from repro_torch.serve.faults import FaultPlan
    return FaultPlan(seed=99, poison_streams=(17, 90), inf_streams=(55,),
                     poison_frames=4, corrupt_slot_at=((40, 3),),
                     stall_ticks=(25,), crash_at_tick=120)


def chaos_soak(prog, task, device, ckpt_dir) -> dict:
    """The seeded chaos soak through ``serve_resumable`` (8 slots, the
    ``TestChaosSoak`` policy, a checkpoint every 32 ticks, the crash at
    tick 120). Returns its results, server, restarts, wall time and the
    frames of the streams it completed ``ok``."""
    from repro_torch.serve import resilience
    pol = resilience.ResiliencePolicy(
        max_queue=64, deadline_ticks=60, quarantine_after=3,
        on_quarantine="readmit", check_every=8, ckpt_dir=ckpt_dir,
        ckpt_every=32)
    arrivals = soak_arrivals(task.input_size)
    sync(device)
    t0 = time.perf_counter()
    results, srv, restarts = resilience.serve_resumable(
        prog, task, arrivals, pol, n_streams=SOAK_SLOTS,
        engine_kwargs={"device": device}, fault_plan=soak_plan())
    sync(device)
    wall = time.perf_counter() - t0
    ok_frames = sum(len(r.outputs) for r in results.values()
                    if r.status == "ok")
    return {"results": results, "srv": srv, "restarts": restarts,
            "wall_s": wall, "ok_frames": ok_frames,
            "statuses": {i: r.status for i, r in results.items()},
            "counters": {k: v for k, v in srv.counters.items()
                         if k not in ("straggler_flags",
                                      "missed_heartbeats")}}


def check_soak(run, what) -> None:
    """What ``TestChaosSoak`` asserts of one run."""
    c = run["counters"]
    if not (run["restarts"] == 1 and len(run["results"]) == SOAK_ARRIVALS
            and c["quarantined"] >= 2 and c["recovered"] == c["quarantined"]
            and c["poison_frames"] > 0
            and sum(s == "ok" for s in run["statuses"].values())
            >= SOAK_ARRIVALS // 2):
        raise AssertionError(f"{what}: restarts {run['restarts']}, "
                             f"{len(run['results'])} terminal, counters {c}")


def soak_reference_check(prog, task, run, device) -> int:
    """Every ``ok`` stream of a soak bitwise equal to a clean run of its
    sanitized frames through slot 0 of an 8-slot engine. Returns how many
    streams were checked."""
    import numpy as np
    from repro_torch.serve.engine import DeltaStreamEngine
    from repro_torch.serve.faults import sanitize_frames
    plan = soak_plan()
    ref = DeltaStreamEngine(prog, task, n_streams=SOAK_SLOTS, device=device)
    checked = 0
    for i, (_, frames) in enumerate(soak_arrivals(task.input_size)):
        r = run["results"][i]
        if r.status != "ok":
            continue
        fed = sanitize_frames(plan.poison_stream(i, frames))
        ref.reset()
        sid = ref.open_stream()
        xs = np.zeros((len(fed), SOAK_SLOTS, task.input_size), np.float32)
        xs[:, sid] = fed
        want = ref.step_many(xs)[:, sid].cpu().numpy()
        got = np.stack([np.asarray(o) for o in r.outputs])
        if not np.array_equal(got, want):
            raise AssertionError(f"soak arrival {i} differs from a clean "
                                 f"run: {np.abs(got - want).max():.3e}")
        checked += 1
    return checked


def layer_inputs(rng, b, lay, fire, quant):
    """Random kernel inputs for one layer: deltas fired in a random subset
    of the k-blocks (``fire`` of them per stream, at least one unless
    ``fire == 0``), dense inside a fired block. On the Q8.8 grid when
    ``quant``. Returns numpy arrays ``(m, h, c, dx, dh)`` and the real
    (unpadded) x and h columns of the blocks fired in any stream."""
    import numpy as np
    i_dim, h_dim, block_k, ip = (lay.input_size, lay.hidden_size,
                                 lay.block_k, lay.ip)
    k = ip + h_dim + (-h_dim) % block_k
    nbk = k // block_k
    d = np.zeros((b, k), np.float32)
    n_fire = 0 if fire == 0 else max(1, round(fire * nbk))
    for s in range(b):
        for blk in rng.choice(nbk, n_fire, replace=False):
            d[s, blk * block_k:(blk + 1) * block_k] = rng.uniform(
                -1, 1, block_k)
    d[:, i_dim:ip] = 0.0
    d[:, ip + h_dim:] = 0.0
    union = np.any(d.reshape(b, nbk, block_k) != 0, axis=(0, 2))
    cols = np.concatenate([np.arange(ip) < i_dim,
                           np.arange(k - ip) < h_dim])
    fired_cols = int((cols.reshape(nbk, block_k).sum(1) * union).sum())
    m = rng.normal(0, 1.0, (b, 4 * h_dim))
    h = rng.uniform(-1, 1, (b, h_dim))
    c = rng.uniform(-3, 3, (b, h_dim))
    if quant:
        d = np.round(d * 256) / 256
        m = np.round(m * 256 * 32) / 256
        h = np.round(h * 256) / 256
        c = np.round(c * 256) / 256
    dx = np.ascontiguousarray(d[:, :i_dim])
    dh = np.ascontiguousarray(d[:, ip:ip + h_dim])
    return [a.astype(np.float32) for a in (m, h, c, dx, dh)], fired_cols


def fired_inputs(rng, b, lay, fired, solo=False, quant=True):
    """Kernel inputs for one layer whose deltas fire exactly the column
    blocks ``fired`` in the union of the streams, dense inside a fired
    block, on the Q8.8 grid (``m`` in the code domain) when ``quant``. Each
    block has an owner, a stream drawn at random, that fires it; every
    other stream fires it with odds of one half, or, with ``solo``, none
    does and the owner is never stream 0 (at ``b > 1``), so only the union
    over the streams finds the block. Returns numpy arrays
    ``(m, h, c, dx, dh)``."""
    import numpy as np
    i_dim, h_dim, bk, ip = (lay.input_size, lay.hidden_size, lay.block_k,
                            lay.ip)
    k = ip + lay.hk
    d = np.zeros((b, k))
    for blk in fired:
        owner = int(rng.integers(1 if solo and b > 1 else 0, b))
        for s in range(b):
            if s == owner or (not solo and rng.uniform() < 0.5):
                d[s, blk * bk:(blk + 1) * bk] = rng.uniform(-1, 1, bk)
    d[:, i_dim:ip] = 0.0
    d[:, ip + h_dim:] = 0.0
    m = rng.normal(0, 1.0, (b, 4 * h_dim))
    h = rng.uniform(-1, 1, (b, h_dim))
    c = rng.uniform(-3, 3, (b, h_dim))
    if quant:
        d = np.round(d * 256) / 256
        m = np.round(m * 256 * 32) / 256
        h = np.round(h * 256) / 256
        c = np.round(c * 256) / 256
    union = np.flatnonzero(d.reshape(b, k // bk, bk).any(axis=(0, 2)))
    if tuple(union) != tuple(fired):
        raise AssertionError(f"inputs fire {list(union)}, want {fired}")
    return [a.astype(np.float32) for a in
            (m, h, c, d[:, :i_dim], d[:, ip:ip + h_dim])]


def run_step(cell, fn, lay, ins):
    """One layer step of ``cell`` on ``ins = (m, h, c, dx, dh)``: the GRU
    step takes no cell state. Returns ``(m, h)`` or ``(m, h, c)``."""
    m, h, c, dx, dh = ins
    if cell == "gru":
        return fn(lay, m, h, dx, dh)
    return fn(lay, m, h, c, dx, dh)


def step_bytes(cell, be, lay, fired_cols, b: int = 1) -> int:
    """Bytes one layer step of ``b`` streams must move: the real rows and
    columns of the blocks fired in any stream once (not the block padding
    of the layout), the per-row scales and biases of the int8/int4
    layouts, and each stream's operands in and out once."""
    gates = 3 if cell == "gru" else 4
    h, i = lay.hidden_size, lay.input_size
    wbytes = {"fused": 4.0, "fused_q8": 1.0, "fused_q4": 0.5}[be]
    side = 0 if be == "fused" else (gates + 4) * h * 4
    # m in and out, h in and out (GRU) or c in, h and c out (LSTM), dx, dh
    io = 4 * b * (4 * h * 2 + h * (2 if cell == "gru" else 3) + i + h)
    return int(gates * h * fired_cols * wbytes + side + io)


def device_ms_cold(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` (captured in a CUDA graph) with a
    cold L2: before each replay a reduction reads a buffer of twice the L2,
    then the card sleeps while the host enqueues the timed replay, so
    neither the host's launch cost nor the flush is between the events."""
    import torch
    from repro_torch.kernels import ops
    flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.float32, device="cuda")
    flush.fill_(1.0)
    sink = torch.empty((), dtype=torch.float32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    replay = ops.capture_cuda_graph(fn)
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        torch.sum(flush, dim=0, out=sink)
        torch.cuda._sleep(2_000_000)        # ~1 ms at the H100's clock
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        replay()
        stop.record()
        events.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def lm_stream(rng, t: int, d: int):
    """The smooth stream of ``benchmarks/lm_delta_bench.py``: a first-order
    low-pass ``c <- 0.9 c + 0.35 n`` over white noise, ``[t, d]``."""
    import numpy as np
    noise = rng.normal(size=(t, d))
    out = np.zeros((t, d))
    c = np.zeros(d)
    for i in range(t):
        c = 0.9 * c + 0.35 * noise[i]
        out[i] = c
    return out.astype(np.float32)


def scaled_err(a, b) -> float:
    """max|a - b| over max(1, max|b|), on the host."""
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.numel() == 0:
        return 0.0
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def spmv_case(rng, i_dim, o_dim, b, fire):
    """Random ``delta_spmv`` operands: weights ``[o_dim, i_dim]``, deltas
    fired in ``fire`` of the 128-wide column blocks of each stream (at
    least one unless 0, dense inside a fired block) and an accumulator.
    Returns numpy ``(w, dx, acc)`` and the real columns of the blocks fired
    in any stream."""
    import numpy as np
    nbk = -(-i_dim // 128)
    w = rng.normal(0, i_dim ** -0.5, (o_dim, i_dim)).astype(np.float32)
    d = np.zeros((b, nbk * 128), np.float32)
    n_fire = 0 if fire == 0 else max(1, round(fire * nbk))
    for s in range(b):
        for blk in rng.choice(nbk, n_fire, replace=False):
            d[s, blk * 128:(blk + 1) * 128] = rng.uniform(-1, 1, 128)
    union = (d.reshape(b, nbk, 128) != 0).any(axis=(0, 2))
    cols = np.minimum(128, i_dim - 128 * np.arange(nbk))
    acc = rng.normal(0, 1, (b, o_dim)).astype(np.float32)
    return (w, np.ascontiguousarray(d[:, :i_dim]), acc,
            int((cols * union).sum()))


def spmv_fired(rng, i_dim, o_dim, b, fired, solo=False):
    """``delta_spmv`` deltas ``[b, i_dim]`` that fire exactly the 128-wide
    column blocks ``fired`` in the union of the streams (owners drawn as in
    ``fired_inputs``; the last block may be ragged), and an accumulator
    ``[b, o_dim]``. Returns numpy ``(dx, acc)``."""
    import numpy as np
    d = np.zeros((b, -(-i_dim // 128) * 128))
    for blk in fired:
        owner = int(rng.integers(1 if solo and b > 1 else 0, b))
        for s in range(b):
            if s == owner or (not solo and rng.uniform() < 0.5):
                d[s, blk * 128:(blk + 1) * 128] = rng.uniform(-1, 1, 128)
    d = d[:, :i_dim]
    acc = rng.normal(0, 1, (b, o_dim))
    return d.astype(np.float32), acc.astype(np.float32)


def lm_layer_lockstep(prog, cpu_prog, frames, theta, tree_to, tree_leaves):
    """Layer by layer, feed the card's and the CPU's copies of the program
    the same layer input and state (the card's), for every frame, and
    compare the layer output and new state scaled by magnitude. A layer
    step whose firing masks differ (one ulp moved a value across θ) is
    counted and not compared. Returns ``(max scaled error, flips, layer
    steps)``."""
    import torch
    step = prog.spec.step
    state = prog.init_state((1,))
    layers = list(state.stack.layers)
    err, flips, n = 0.0, 0, 0
    in_max = [0.0] * prog.num_layers
    for x in frames:
        inp = torch.from_numpy(x[None]).to(prog.device)
        for li in range(prog.num_layers):
            in_max[li] = max(in_max[li], float(inp.abs().max()))
            g = step(prog.layers[li], layers[li], inp, theta, theta,
                     layout=prog.layouts[li])
            c = step(cpu_prog.layers[li], tree_to(layers[li], "cpu"),
                     inp.cpu(), theta, theta, layout=cpu_prog.layouts[li])
            n += 1
            same_fire = all(torch.equal((a.cpu() != 0), (bb != 0)) for a, bb
                            in ((g.delta_x, c.delta_x),
                                (g.delta_h, c.delta_h)))
            if not same_fire:
                flips += 1
            else:
                for a, bb in zip([g.h] + tree_leaves(g.state),
                                 [c.h] + tree_leaves(c.state)):
                    err = max(err, scaled_err(a, bb))
            layers[li] = g.state
            inp = g.h
    return err, flips, n, in_max


def train_grads(params, task, batch, qat, use_delta):
    """The loss and gradients (in ``tree_leaves`` order) of the paper's
    train step, by autograd: what ``make_gru_train_step`` computes before
    its Adam update."""
    from repro_torch.models.gru_rnn import gru_model_forward
    from repro_torch.train.losses import ctc_loss_mean
    from repro_torch.train.optim import tree_leaves, tree_map
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    out, _ = gru_model_forward(p, task, batch["features"],
                               use_delta=use_delta, qat=qat)
    loss = ctc_loss_mean(out, batch["labels"], batch["in_lens"],
                         batch["lab_lens"])[0]
    loss.backward()
    return loss.detach(), [t.grad for t in tree_leaves(p)]


def lut_lockstep(margin: float):
    """Two QAT policies on ``EDGEDRNN_QAT``'s grids for holding a card's QAT
    train step against the CPU's: ``record`` keeps every LUT output of a
    forward on the card, in call order; ``replay``, on the CPU, computes its
    own and, where the two differ (a one-ulp difference of the LUT's
    argument, a float32 sum, moved the output a grid step), takes the
    card's, after checking that its own pre-rounding value lies within
    ``margin`` grid steps of a rounding boundary (else it raises: no flip
    explains the difference). The backward is the exact function's either
    way. Returns ``(record, replay, stats)``; ``stats`` counts the LUT
    sites, the flips and the largest flip margin."""
    import dataclasses

    import torch
    from repro_torch.quant.fake_quant import quantize
    from repro_torch.quant.lut import LutNonlinearity
    from repro_torch.quant.qat import QatPolicy

    log = []
    stats = {"sites": 0, "flips": 0, "max_margin": 0.0}

    @dataclasses.dataclass(frozen=True)
    class Recording(LutNonlinearity):
        def __call__(self, x):
            y = LutNonlinearity.__call__(self, x)
            log.append(y.detach())
            return y

    @dataclasses.dataclass(frozen=True)
    class Replaying(LutNonlinearity):
        calls: object = None

        def __call__(self, x):
            exact = self.fn(x)
            lut = quantize(exact, self.out_fmt)
            card = next(self.calls).to(lut.device)
            stats["sites"] += lut.numel()
            differs = lut.detach() != card
            n = int(differs.sum())
            if n:
                s = exact.detach()[differs].double() * self.out_fmt.scale
                m = float((s - torch.floor(s) - 0.5).abs().max())
                if m > margin:
                    raise AssertionError(
                        f"a LUT output differs from the card's {m:.3e} grid "
                        f"steps from a rounding boundary (> {margin})")
                stats["flips"] += n
                stats["max_margin"] = max(stats["max_margin"], m)
                lut = torch.where(differs, card, lut)
            return exact + (lut - exact).detach()

    @dataclasses.dataclass(frozen=True)
    class Record(QatPolicy):
        def act_fns(self):
            sig, tanh = QatPolicy.act_fns(self)
            return (Recording(sig.fn, sig.out_fmt),
                    Recording(tanh.fn, tanh.out_fmt))

    @dataclasses.dataclass(frozen=True)
    class Replay(QatPolicy):
        def act_fns(self):
            sig, tanh = QatPolicy.act_fns(self)
            calls = iter(log)      # one forward's calls, in order
            return (Replaying(sig.fn, sig.out_fmt, calls),
                    Replaying(tanh.fn, tanh.out_fmt, calls))

    return Record(), Replay(), stats


def adam_first_step_bound(g, delta, scale, lr, eps=1e-8):
    """How far Adam's first update ``lr * c g / (|c g| + eps)`` (``c`` the
    clip scale) moves when the gradient ``g`` moves by ``delta``: monotone
    in ``g``, so the worst case is at an end of ``[g - delta, g + delta]``;
    plus 8 ulps of ``lr`` for the bias corrections' rounding."""
    import numpy as np

    def upd(v):
        v = scale * np.asarray(v, np.float64)
        return v / (np.abs(v) + eps)
    u = upd(g)
    reach = np.maximum(np.abs(upd(g + delta) - u), np.abs(upd(g - delta) - u))
    return lr * (reach + 8 * 2.0 ** -24)


def first_step_against_cpu(what, step, cpu_step, state, cpu_state, batch,
                           qat, cpu_qat, task, use_delta, lr):
    """The first step of a training stage on the card held against the same
    step run with ``device="cpu"`` from the same weights and batch: the
    loss within ``TOL_TRAIN_LOSS``, every gradient leaf within
    ``TOL_TRAIN_GRAD`` of its largest element, every updated parameter
    within what Adam's first step makes of that bound. The gradients come
    from ``train_grads`` (with ``qat`` / ``cpu_qat``, the recording and
    replaying policies for a QAT stage), the updated parameters from the
    two packages' ``step``. Returns ``(card state, metrics, report)``."""
    import numpy as np
    import torch
    from repro_torch.train.optim import tree_leaves
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    loss, grads = train_grads(state.params, task, batch, qat, use_delta)
    c_loss, c_grads = train_grads(cpu_state.params, task, cpu_batch,
                                  cpu_qat, use_delta)
    new, metrics = step(state, batch)
    c_new, c_metrics = cpu_step(cpu_state, cpu_batch)
    loss_err = abs(float(loss) - float(c_loss)) / abs(float(c_loss))
    step_loss_err = abs(float(metrics["loss"]) - float(c_metrics["loss"])) \
        / abs(float(c_metrics["loss"]))
    scale = min(1.0, 1.0 / (float(c_metrics["grad_norm"]) + 1e-9))
    grad_err, param_excess = 0.0, -float("inf")
    for g, cg, p, cp in zip(grads, c_grads, tree_leaves(new.params),
                            tree_leaves(c_new.params)):
        cg = cg.numpy()
        top = float(np.abs(cg).max())
        grad_err = max(grad_err, float(np.abs(g.cpu().numpy() - cg).max())
                       / top)
        bound = adam_first_step_bound(cg, TOL_TRAIN_GRAD * top, scale, lr)
        cp = cp.numpy()
        excess = (np.abs(p.cpu().numpy() - cp)
                  - bound - np.spacing(np.abs(cp)))
        param_excess = max(param_excess, float(excess.max()))
    report = (f"{what} first step, card against CPU: loss {loss_err:.3e} "
              f"(step {step_loss_err:.3e}) relative, gradients "
              f"{grad_err:.3e} of each leaf's largest, updated parameters "
              f"within the Adam bound with {-param_excess:.3e} to spare at "
              f"the closest")
    if (loss_err > TOL_TRAIN_LOSS or step_loss_err > TOL_TRAIN_LOSS
            or grad_err > TOL_TRAIN_GRAD or param_excess > 0
            or not torch.isfinite(loss)):
        raise AssertionError(f"{report}: outside the bounds")
    return new, metrics, report


def train_split_ms(params, task, batch, qat, use_delta, opt_state, opt_cfg):
    """One train step cut at its joints, each part ended by a synchronise:
    the forward with its loss, the backward, the Adam update (ms)."""
    import torch
    from repro_torch.models.gru_rnn import gru_model_forward
    from repro_torch.train.losses import ctc_loss_mean
    from repro_torch.train.optim import adam_update, tree_map
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    out, _ = gru_model_forward(p, task, batch["features"],
                               use_delta=use_delta, qat=qat)
    loss = ctc_loss_mean(out, batch["labels"], batch["in_lens"],
                         batch["lab_lens"])[0]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    adam_update(tree_map(lambda t: t.grad, p), opt_state, params, opt_cfg)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return {"forward_ms": 1e3 * (t1 - t0), "backward_ms": 1e3 * (t2 - t1),
            "adam_ms": 1e3 * (t3 - t2)}


def graph_check(what, eng, steps):
    """The engine stepped ``steps`` steps through its captured graphs, each
    captured once (the one-step graph at construction, a chunk's at its
    first use) and never again, with no more replays than ``chunk_plan``
    needs a call."""
    g = eng.graph_stats
    if g["captures"] != len(eng._graphs) or g["steps"] != steps \
            or g["replays"] > steps:
        raise AssertionError(f"{what}: graph {g} over {sorted(eng._graphs)}"
                             f", want each graph captured once and {steps} "
                             "steps")


# frames that capture every chunk graph of step_many (16 + 8 + 4 + 2 + 1)
WARM_FRAMES = 31


def warm_chunks(eng, frames):
    """Capture every graph ``step_many`` uses (a run of WARM_FRAMES of
    ``frames``), then reset the engine: a timed or counted run after it
    captures nothing."""
    eng.step_many(frames[:WARM_FRAMES])
    eng.reset()


def engine_steps(eng) -> int:
    """The steps an engine ran on the card: its replays' steps, and one
    a capture (the step a capture runs first, outside the graph)."""
    g = eng.graph_stats
    return g["steps"] + g["captures"]


def step_launches(layer_kernels: dict, units: int) -> dict:
    """The launches of one engine step: its layer kernels'
    (``{name: launches}``), ``units`` Delta Unit launches and one
    epilogue."""
    from repro_torch.kernels import ops
    return {**layer_kernels, ops.DELTA_UNIT_F32.name: units,
            ops.ENGINE_EPILOGUE_F32.name: 1}


def counted_per_step(before: dict, after: dict, steps: int) -> dict:
    """The launches a step of each kernel between two
    ``ops.launch_counts()`` over ``steps`` steps (those launched only)."""
    return {k: (after[k] - before[k]) / steps for k in after
            if after[k] != before[k]}


def times(per_step: dict, steps: int) -> dict:
    return {k: v * steps for k, v in per_step.items()}


def add_counts(total: dict, n: dict) -> None:
    for k, v in n.items():
        total[k] = total.get(k, 0) + v


def bits(t):
    """A float tensor's bit patterns (NaN-safe bitwise comparison)."""
    import torch
    return t.contiguous().view(-1).view(torch.int32).cpu()


def du_streams(rng, n, widths, dev, theta, quant, strided):
    """Delta Unit operands: a ``(s, memory)`` pair of ``[n, w]`` per width,
    memories on the Q8.8 grid, ``s`` = memory + a step that lands exactly
    on ``theta`` (fires under >=, not under >), exactly 0 (fires at
    theta = 0 with a zero delta), below, above, or at NaN / +-inf; with
    ``quant`` also off the grid by half a step (rounded to even);
    ``strided``: ``s`` a column block of a wider tensor (row stride)."""
    import numpy as np
    import torch
    out = []
    for w in widths:
        mem = np.round(rng.normal(0, 1, (n, w)) * 256) / 256
        pick = rng.integers(0, 7, (n, w))
        step = np.choose(pick, [np.full((n, w), theta), np.zeros((n, w)),
                                rng.uniform(0, 0.9, (n, w)) * theta,
                                theta + rng.uniform(0.01, 2, (n, w)),
                                -theta - rng.uniform(0.01, 2, (n, w)),
                                np.full((n, w), -theta),
                                rng.normal(0, 1, (n, w))])
        s = mem + step
        if quant:
            half = rng.random((n, w)) < 0.1
            s = np.where(half, np.floor(s * 256) / 256 + 0.5 / 256, s)
        special = rng.random((n, w))
        s = np.where(special < 0.01, np.nan, s)
        s = np.where((special >= 0.01) & (special < 0.02), np.inf, s)
        s = np.where((special >= 0.02) & (special < 0.03), -np.inf, s)
        if n > 1:
            s[-1] = mem[-1]                        # a silent slot
        s_t = torch.from_numpy(s.astype(np.float32)).to(dev)
        if strided:
            wide = torch.zeros((n, w + 8), dtype=torch.float32, device=dev)
            wide[:, 3:3 + w] = s_t
            s_t = wide[:, 3:3 + w]
        out.append((s_t, torch.from_numpy(mem.astype(np.float32)).to(dev)))
    return out


def engine_kernel_rows(dev, programs: dict, rng, floor_ms: float,
                       smi: str) -> dict:
    """Phase 6 for the engine step's two kernels at the main paths' shapes,
    theta = 0.25, at one stream (B = 1) and at a fabric shard's N = 128:
    warm (CUDA-graph replay), with a cold L2, launched from Python, and the
    plain version on the card; the bound is the bytes each launch must
    move (each input read once, each output written once) at 3.35 TB/s,
    beside the launch floor (no single PyTorch call computes either:
    library_ms None). ``programs``: a compiled program per path, ``{"gru
    fused_q8": ..., "rwkv6 fused": ...}``; per path the Delta Unit launches
    of one step (layer 0's with the frame guard on the GRU / LSTM paths
    where the engine folds it: at B = 1, not at N = 128) and the epilogue
    over that step's state (without last_x's copy where the guard wrote
    it). Returns ``{kernel name: {path: row}}``, each row's ``n128`` the
    same at N = 128."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.delta_unit import (FrameGuard, delta_unit,
                                                delta_unit_ref, guard_fits,
                                                tile_columns)
    from repro_torch.kernels.engine_epilogue import (AGGREGATES, PER_STREAM,
                                                     EpilogueConsts,
                                                     engine_epilogue,
                                                     engine_epilogue_ref,
                                                     epilogue_table,
                                                     epilogue_workspace_words)
    from repro_torch.core.sparsity import cell_dims
    th = torch.full((), THETA, dtype=torch.float32, device=dev)
    rows = {ops.DELTA_UNIT_F32.name: {}, ops.ENGINE_EPILOGUE_F32.name: {}}
    for path, prog in programs.items():
        cell = prog.cell
        quant = prog.backend.startswith("fused_q")
        d_in, hid, n_layers = prog.input_size, prog.hidden_size, \
            prog.num_layers
        if cell == "rwkv6":
            shapes = [([hid] * 3, [hid])] * n_layers
        else:
            shapes = [([d_in if l == 0 else hid], [hid])
                      for l in range(n_layers)]
        grid = (256.0, -128.0, 128.0 - 1.0 / 256) if quant else None
        for n in (1, 128):
            # the guard in layer 0's launch where the engine folds it
            guarded = prog.spec.frame_guard and guard_fits(n, d_in)
            calls = [(du_streams(rng, n, wx, dev, THETA, quant, False),
                      du_streams(rng, n, wh, dev, THETA, False, False))
                     for wx, wh in shapes]
            last_x = torch.zeros((n, d_in), device=dev)
            finite = torch.ones((n,), dtype=torch.bool, device=dev)
            guard = FrameGuard(last_x, finite) if guarded else None

            def du_all(fn=delta_unit, calls=calls, guard=guard):
                return [fn(xs, hs, THETA, th, act_grid=grid,
                           guard=guard if l == 0 else None)[2]
                        for l, (xs, hs) in enumerate(calls)]

            du_bytes = 0
            for l, (wx, wh) in enumerate(shapes):
                du_bytes += 16 * n * (sum(wx) + sum(wh))
                du_bytes += 4 * (n + 2) * sum(   # a count row a block
                    -(-w // tile_columns(n, w, guarded and l == 0 and j == 0))
                    for j, w in enumerate(wx + wh))
                if guarded and l == 0:
                    du_bytes += 8 * n * d_in + n
            counts = [(l, c) for l, c in enumerate(du_all())]
            cols = [(sum(wx), sum(wh)) for wx, wh in shapes]
            state = prog.init_state((n,))
            leaves = [t for t in tree_leaves(state)]
            carry = {k: torch.zeros((n,), device=dev) for k in PER_STREAM}
            carry.update({k: torch.zeros((), device=dev)
                          for k in AGGREGATES})
            carry["last_x"] = torch.zeros((n, d_in), device=dev)
            x = None if guarded else torch.rand((n, d_in), device=dev)
            consts = EpilogueConsts(cell_dims(cell, d_in, hid, n_layers),
                                    8.0 * 125e6, 8)
            ws = torch.zeros((epilogue_workspace_words(n, n_layers),),
                             dtype=torch.int32, device=dev)
            table = epilogue_table(leaves, counts, cols, n)
            ep_bytes = (sum(4 * t.numel() for t in leaves)
                        + sum(4 * c.numel() for _, c in counts)
                        + (0 if guarded else 4 * 2 * n * d_in) + n
                        + 4 * 2 * (len(PER_STREAM) * n + len(AGGREGATES))
                        + 4 + table.words.nbytes)

            def ep(fn=engine_epilogue, leaves=leaves, counts=counts,
                   cols=cols, carry=carry, x=x, finite=finite,
                   consts=consts, ws=ws):
                args = (leaves, counts, cols, carry, x, finite, consts)
                return fn(*args, ws) if fn is engine_epilogue else fn(*args)

            for kinfo, run, plain, nbytes in (
                    (ops.DELTA_UNIT_F32, du_all,
                     lambda du_all=du_all: du_all(delta_unit_ref), du_bytes),
                    (ops.ENGINE_EPILOGUE_F32, ep,
                     lambda ep=ep: ep(engine_epilogue_ref), ep_bytes)):
                before = kinfo.launches     # the launches of one timed call
                run()
                launches = kinfo.launches - before
                row = {"ms": device_ms(run), "cold_ms": device_ms_cold(run),
                       "eager_ms": eager_ms(run),
                       "plain_ms": device_ms(plain),
                       "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                       "bound_by": "bytes", "library_ms": None,
                       "bytes": nbytes, "launches_timed": launches,
                       "launch_floor_ms": floor_ms * launches / 2}
                if n == 1:
                    rows[kinfo.name][path] = row
                else:
                    rows[kinfo.name][path]["n128"] = row
                log(f"time {kinfo.name} {path}, one step's {launches} "
                    f"launch{'es' if launches > 1 else ''} at N={n}"
                    f"{' (guard folded)' if guarded else ''}: kernel "
                    f"{row['ms']:.5f} ms warm, {row['cold_ms']:.5f} ms with "
                    f"a cold L2 ({row['eager_ms']:.4f} ms launched from "
                    f"Python), plain {row['plain_ms']:.5f} ms, bound "
                    f"{row['bound_ms']:.6f} ms ({nbytes} B), launch floor "
                    f"{row['launch_floor_ms']:.5f} ms [{smi}]")
            del calls, state, leaves, counts, carry
    return rows


def guard_frames(rng, n, width, dev):
    """A frame guard's operands: ``(s, memory)`` as ``du_streams`` draws
    them (NaN and +-inf in ~3 % of the elements), the odd slots' rows made
    finite and the even slots' last column NaN (so some slots pass and
    some are guarded), and a finite ``last_x``."""
    import numpy as np
    import torch
    (s, mem), = du_streams(rng, n, [width], dev, THETA, True, False)
    s[1::2] = mem[1::2] + 0.5
    s[0::2, -1] = float("nan")
    last = torch.from_numpy(rng.normal(0, 1, (n, width)).astype(
        np.float32)).to(dev)
    return s, mem, last


def engine_kernels_phase(dev, rng) -> dict:
    """Phase 3 for the engine step's two kernels, each against its plain
    version on the card, every case launched twice and bitwise equal.

    The Delta Unit at the main paths' layer shapes (2L-768H's two GRU /
    LSTM layers, RWKV6's three input streams, row-strided, and its decay
    stream at D = 2048, RG-LRU's 4096-wide streams one group at a time) at
    N in {1, 3, 8, 9, 128}, theta 0 and 0.25 (a number, and a device tensor),
    the input group on the Q8.8 grid or not: deltas and memories bitwise,
    the count rows' totals exact. Then the frame guard folded into layer
    0's launch (frames of 40, 33 and 256 columns, half the slots holding
    NaN / +-inf, on the grid or not): finite and last_x bitwise too; and a
    host threshold of 0 (StepTheta) on NaN memories, which fires them.

    The epilogue on count rows of those launches (N in {1, 3, 8, 128}), over
    2 and 24 layers, with state leaves like the engines' (the GRU's small
    leaves; a [N, 32, 64, 64] WKV state past one scan chunk, a
    row-strided [N, 3, W] slice of [N, 4, W], an empty row),
    non-finite values in the first leaf of one slot and in the last leaf
    alone of another, frames flagged non-finite, last_x written by the
    launch or already by the guard: flags, counts, poison and bad-state
    sums and last_x bitwise, the fp32 terms within TOL_EPILOGUE_REL of
    the plain version (bitwise per slot over 2 layers), the workspace left
    zero; on a zeroed carry the aggregates bitwise the kernel's fixed-order
    tree (tree_sum_ref) of its per-slot terms.
    Returns ``{"max_err": {name: max absolute error}, "cases": n}``."""
    import numpy as np
    import torch
    from repro_torch.core.delta import StepTheta
    from repro_torch.core.sparsity import cell_dims
    from repro_torch.kernels import ops
    from repro_torch.kernels.delta_unit import (FrameGuard, count_totals,
                                                delta_unit, delta_unit_ref)
    from repro_torch.kernels.engine_epilogue import (AGGREGATES, PER_STREAM,
                                                     EpilogueConsts,
                                                     engine_epilogue,
                                                     engine_epilogue_ref,
                                                     epilogue_grid,
                                                     epilogue_table,
                                                     epilogue_workspace_words,
                                                     tree_sum_ref)
    du, ep = ops.DELTA_UNIT_F32, ops.ENGINE_EPILOGUE_F32
    err = {du.name: 0.0, ep.name: 0.0}
    grid = (256.0, -128.0, 128.0 - 1.0 / 256)
    shapes = {"gru layer 0": ([40], [768]), "gru layer 1": ([768], [768]),
              "rwkv6 layer": ([2048] * 3, [2048]),
              "rglru x": ([4096], []), "rglru u": ([], [4096])}
    n_cases = 0
    rows_for = {}

    def same_du(runs, ref, desc, n, extra=()):
        torch.cuda.synchronize()
        outs = [[t for pair in r[0] + r[1] for t in pair]
                for r in runs + [ref]]
        same = all(torch.equal(bits(a), bits(b))
                   for o in outs[1:] for a, b in zip(outs[0], o))
        same = same and all(torch.equal(a, b) for a, b in extra)
        totals = [count_totals(r[2]).cpu() for r in runs + [ref]]
        exact = all(torch.equal(totals[0], t) for t in totals)
        if not (same and exact):
            raise AssertionError(
                f"{du.name} disagrees with its plain version: {desc}; "
                f"outputs bitwise {same}, counts {exact} "
                f"({totals[0].tolist()} against {totals[-1].tolist()})")
        return totals[0]

    for n in (1, 3, 8, 9, 128):
        for what, (wx, wh) in shapes.items():
            for theta in (0.0, 0.25):
                for quant in ((False, True) if what.startswith("gru")
                              else (False,)):
                    xs = du_streams(rng, n, wx, dev, theta, quant,
                                    strided=what.startswith("rwkv6"))
                    hs = du_streams(rng, n, wh, dev, theta, False, False)
                    th = torch.full((), theta, dtype=torch.float32,
                                    device=dev)
                    ag = grid if quant else None
                    runs = [delta_unit(xs, hs, theta, th, act_grid=ag)
                            for _ in range(2)]
                    ref = delta_unit_ref(xs, hs, theta, th, act_grid=ag)
                    desc = (f"{what} N={n} theta={theta}"
                            f"{' Q8.8 input' if quant else ''}")
                    totals = same_du(runs, ref, desc, n)
                    n_cases += 1
                    if theta > 0 and not quant:
                        rows_for[(n, what)] = runs[0][2]
        log(f"kernel {du.name} N={n}: every shape, theta and grid bitwise "
            "its plain version (deltas, memories, count totals)")
        # the frame guard folded into layer 0's launch
        for width in (40, 33, 256):
            for quant in (False, True):
                s, mem, last = guard_frames(rng, n, width, dev)
                hs = du_streams(rng, n, [768], dev, THETA, False, False)
                ag = grid if quant else None
                guards = [FrameGuard(last.clone(), torch.zeros(
                    (n,), dtype=torch.bool, device=dev)) for _ in range(3)]
                runs = [delta_unit([(s, mem)], hs, THETA, THETA, act_grid=ag,
                                   guard=g) for g in guards[:2]]
                ref = delta_unit_ref([(s, mem)], hs, THETA, THETA,
                                     act_grid=ag, guard=guards[2])
                passed = int(guards[2].finite.sum())
                desc = (f"the frame guard, {width} columns, N={n}"
                        f"{' Q8.8 input' if quant else ''}: {passed} slots "
                        "finite")
                same_du(runs, ref, desc, n, extra=[
                    (bits(g.last_x), bits(guards[2].last_x))
                    for g in guards[:2]] + [
                    (g.finite.cpu(), guards[2].finite.cpu())
                    for g in guards[:2]])
                if n > 1 and not 0 < passed < n:
                    raise AssertionError(f"{desc}: want some slots guarded")
                n_cases += 1
        # a host threshold of 0 fires NaN memories (the reference's jitted
        # step folds |raw| >= 0); a tensor threshold of 0 does not
        for wx, wh in (([40], [768]), ([2048] * 3, [2048])):
            xs = du_streams(rng, n, wx, dev, 0.0, False, False)
            hs = du_streams(rng, n, wh, dev, 0.0, False, False)
            for _, mem in xs + hs:
                mem[:, ::7] = float("nan")
            th0 = torch.zeros((), dtype=torch.float32, device=dev)
            runs = [delta_unit(xs, hs, StepTheta(0.0), th0)
                    for _ in range(2)]
            ref = delta_unit_ref(xs, hs, StepTheta(0.0), th0)
            same_du(runs, ref, f"a host zero threshold, N={n}, {wx}", n)
            fired = [int(torch.isnan(d).sum()) for d, _ in runs[0][0]]
            kept = [int(torch.isnan(d).sum()) for d, _ in runs[0][1]]
            if not (all(f > 0 for f in fired) and sum(kept) == 0):
                raise AssertionError(
                    f"{du.name}: a host 0 should fire NaN differences "
                    f"({fired}), a tensor 0 none ({kept})")
            n_cases += 1
        log(f"kernel {du.name} N={n}: the folded frame guard (finite, "
            "last_x) and the host zero threshold bitwise its plain version")

    leaf_sets = {
        # the 2L-768H GRU's state: h, x_mem, h_mem, M of two layers
        "gru": lambda rand, n: [rand(n, 768), rand(n, 40), rand(n, 768),
                                rand(n, 3072), rand(n, 768), rand(n, 768),
                                rand(n, 768), rand(n, 3072)],
        "lm": lambda rand, n: [rand(n, 768), rand(n, 32, 64, 64),
                               rand(n, 4, 33)[:, 1:], rand(n, 0),
                               rand(n, 3)],
    }
    for n in (1, 3, 8, 128):
        for n_layers, kinds, leaf_set, folded in (
                (2, ("gru layer 0", "gru layer 1"), "gru", True),
                (2, ("gru layer 0", "gru layer 1"), "lm", False),
                (24, ("rwkv6 layer",) * 24, "lm", False),
                (4, ("rglru x", "rglru u") * 4, "lm", False)):
            i_dim = {"gru layer 0": 40}.get(kinds[0], 2048 if kinds[0]
                                            .startswith("rwkv6") else 4096)
            if kinds[0].startswith("rglru"):
                counts = [(l // 2, rows_for[(n, k)])
                          for l, k in enumerate(kinds)]
                cols = [(4096, 4096)] * n_layers
                dims = cell_dims("rglru", 4096, 4096, n_layers)
            else:
                counts = [(l, rows_for[(n, k)]) for l, k in enumerate(kinds)]
                cols = ([(40, 768), (768, 768)] if n_layers == 2
                        else [(3 * 2048, 2048)] * n_layers)
                dims = (cell_dims("gru", 40, 768, 2) if n_layers == 2
                        else cell_dims("rwkv6", 2048, 2048, n_layers))
            g = torch.Generator(device=dev).manual_seed(n * 100 + n_layers)

            def rand(*shape):
                return torch.rand(shape, generator=g, device=dev)

            leaves = leaf_sets[leaf_set](rand, n)
            leaves[0][0, 5] = float("nan")         # slot 0: the first leaf
            if n > 1:
                leaves[-1][n - 1, 2] = float("inf")   # the last slot: last
            if n > 2:
                leaves[1].view(n, -1)[1, -1] = float("-inf")  # a row's end
            x = None if folded else rand(n, i_dim)
            finite = rand(n) > 0.3
            carry = {k: rand(n) for k in PER_STREAM}
            carry.update({k: rand() for k in AGGREGATES})
            carry["last_x"] = rand(n, i_dim)
            consts = EpilogueConsts(dims, 8.0 * 125e6, 8)
            got = [{k: v.clone() for k, v in carry.items()}
                   for _ in range(2)]
            ws = torch.zeros((epilogue_workspace_words(n, n_layers),),
                             dtype=torch.int32, device=dev)
            fh = [engine_epilogue(leaves, counts, cols, c, x, finite,
                                  consts, ws) for c in got]
            want = {k: v.clone() for k, v in carry.items()}
            fh_ref = engine_epilogue_ref(leaves, counts, cols, want, x,
                                         finite, consts)
            # on a zeroed carry the per-slot entries are the terms: the
            # aggregates are their fixed-order tree sums
            zero = {k: torch.zeros_like(v) for k, v in carry.items()}
            engine_epilogue(leaves, counts, cols, zero, x, finite, consts, ws)
            torch.cuda.synchronize()
            exact_keys = ("poison_steps", "bad_state", "agg_poison_steps",
                          "agg_bad_state", "last_x")
            if n_layers == 2:    # sums of at most two terms a slot
                exact_keys += ("fired_x", "fired_h", "lat_s", "w_bytes",
                               "agg_ufired_x", "agg_ufired_h",
                               "agg_tile_lat_s", "agg_tile_w_bytes")
            twice = all(torch.equal(got[0][k], got[1][k]) for k in carry) \
                and torch.equal(fh[0], fh[1])
            exact = all(torch.equal(bits(got[0][k]), bits(want[k]))
                        for k in exact_keys)
            inv_n = 1.0 / n
            tree = all(torch.equal(bits(zero[f"agg_{k}"]),
                                   bits(tree_sum_ref(zero[k]) * inv_n))
                       for k in ("fired_x", "fired_h", "lat_s", "w_bytes"))
            tree = tree and all(
                torch.equal(bits(zero[f"agg_{k}"]), bits(tree_sum_ref(
                    zero[k]))) for k in ("poison_steps", "bad_state"))
            terms = [(got[0][k], want[k]) for k in carry
                     if k not in exact_keys] + [(fh[0], fh_ref)]
            rel = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                      for a, b in terms)
            err[ep.name] = max([err[ep.name]] + [
                float((a - b).abs().max()) for a, b in terms])
            flagged = got[0]["bad_state"] != carry["bad_state"]
            items = epilogue_table(leaves, counts, cols, n).items
            route = f"{epilogue_grid(items)} blocks"
            desc = (f"N={n}, {n_layers} layers, {leaf_set} leaves ({route}"
                    f"{', last_x by the guard' if folded else ''}): slots "
                    f"flagged {int(flagged.sum())}, fp32 terms {rel:.3e} "
                    "relative")
            if not (twice and exact and tree and rel <= TOL_EPILOGUE_REL
                    and int(ws.abs().sum()) == 0
                    and bool(flagged[0]) and bool(flagged[n - 1])):
                raise AssertionError(
                    f"{ep.name} disagrees with its plain version: {desc}; "
                    f"launched twice bitwise {twice}, exact entries {exact}, "
                    f"tree sums bitwise {tree}, workspace "
                    f"{ws.tolist()[:4]}")
            n_cases += 1
            log(f"kernel {ep.name} {desc}: exact entries bitwise, fp32 "
                f"within {TOL_EPILOGUE_REL}, tree sums bitwise")
    return {"max_err": err, "cases": n_cases}


# -- the fused AdamW kernel ----------------------------------------------------

# phase 3's leaves: one element, a few, one short of a 4096-element tile,
# and past 2**20 (128 of the kernel's 8192-element chunks and a ragged one)
ADAM_SIZES = (1, 3, 4095, 2 ** 20 + 1)
# the plan's cases: a head, a piece and a tail; 16 elements; a tile and a
# part of one; two chunks and a tail; three chunks and a tail, at each of
# these offsets a leaf (in elements: heads of 5 and 1 elements of bf16, 1
# and 1 of fp32)
ADAM_PLAN_SIZES = (9, 16, 300, 8205, 3 * 8192 + 7)
ADAM_PLAN_OFFSETS = (3, 7)
# p, g, mu, nu at offsets of their own: no element starts all four on 16
# bytes, so every element takes a scalar access
ADAM_ODD_PHASES = (1, 2, 0, 3)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def adam_bits(t):
    """A float tensor's bit patterns, fp32 or bf16 (NaN-safe)."""
    import torch
    view = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
    return t.contiguous().view(-1).view(view)


def adam_err(x, y) -> float:
    """The largest absolute difference of two float tensors of one shape;
    a position where both hold the same value (NaN, or an infinity of one
    sign) counts 0."""
    import torch
    if not x.numel():
        return 0.0
    x, y = x.float(), y.float()
    same = (x == y) | (torch.isnan(x) & torch.isnan(y))
    return float(torch.where(same, 0.0, (x - y).abs()).max())


def adam_compare(got, ref, p_dtypes) -> tuple:
    """``got`` and ``ref`` (each ``(params', mu', nu')``) leaf by leaf:
    ``(mismatches, {instance name: max abs error})``, a mismatch being a
    leaf whose dtype or bits differ, each leaf's error under the instance
    of its parameter's dtype."""
    import torch
    from repro_torch.kernels import ops
    names = {torch.float32: ops.FUSED_ADAM_F32.name,
             torch.bfloat16: ops.FUSED_ADAM_BF16.name}
    bad, err = 0, {}
    for j, pd in enumerate(p_dtypes):
        for x, y in ((got[0][j], ref[0][j]), (got[1][j], ref[1][j]),
                     (got[2][j], ref[2][j])):
            if x.dtype != y.dtype or not torch.equal(adam_bits(x),
                                                     adam_bits(y)):
                bad += 1
            err[names[pd]] = max(err.get(names[pd], 0.0), adam_err(x, y))
    return bad, err


def adam_operands(dev, gen, sizes, p_dtypes, g_dtypes, misalign):
    """Seeded leaves on the card, each a view ``misalign`` elements into a
    buffer of its own (1 puts every leaf 2 or 4 bytes off 16-byte
    alignment; a tuple gives p, g, mu and nu offsets of their own):
    parameters N(0, 1), gradients N(0, 3), ``mu`` N(0, 1e-2), ``nu``
    |N(0, 1e-4)|, in the leaves' dtypes."""
    import torch
    f32 = torch.float32
    off = misalign if isinstance(misalign, tuple) else (misalign,) * 4

    def leaf(n, dtype, scale, k, absval=False):
        t = torch.randn(n + off[k], generator=gen) * scale
        return (t.abs() if absval else t).to(dtype).to(dev)[off[k]:]
    p = [leaf(n, d, 1.0, 0) for n, d in zip(sizes, p_dtypes)]
    g = [leaf(n, d, 3.0, 1) for n, d in zip(sizes, g_dtypes)]
    mu = [leaf(n, f32, 1e-2, 2) for n in sizes]
    nu = [leaf(n, f32, 1e-4, 3, absval=True) for n in sizes]
    return p, g, mu, nu


def adam_scalars(grads, step: int, clip, dev) -> dict:
    """The plain ops' device scalars of ``adam_update`` at ``step`` (the
    warmup-cosine schedule of the launcher): the clip scale or None, lr,
    corr1, corr2."""
    import torch
    from repro_torch.train.optim import (clip_scale, global_norm,
                                         warmup_cosine_schedule)
    st = torch.tensor(step, dtype=torch.int32, device=dev)
    t = st.to(torch.float32)
    return {"scale": None if clip is None else clip_scale(
                global_norm(grads), clip),
            "lr": warmup_cosine_schedule(1e-3, 20, 2000)(st),
            "corr1": 1 - ADAM_B1 ** t, "corr2": 1 - ADAM_B2 ** t}


def adam_kernels_phase(dev) -> dict:
    """Phase 3's fused AdamW cases: the kernel against its plain version on
    the card, bitwise in ``p``, ``mu`` and ``nu``: fp32 and bf16
    parameters (bf16 ones also with fp32 gradients, as ``grad_accum``
    gives them, and a tree of both dtypes, two launches), leaves of
    ``ADAM_SIZES`` aligned and 2 or 4 bytes off 16-byte alignment, with and
    without clipping and decay, at steps 1 and 1000; a NaN and a +-inf
    gradient with and without clipping; the kernel's plan in both
    instances (leaves of ``ADAM_PLAN_SIZES`` at ``ADAM_PLAN_OFFSETS``:
    scalar heads and tails around vector pieces; operands at
    ``ADAM_ODD_PHASES``: scalar accesses alone); every case launched
    twice, the two bitwise equal, and once in place on copies (``out`` the
    inputs), bitwise the functional result."""
    import torch
    from repro_torch.kernels.fused_adam import fused_adam, fused_adam_ref
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 28)
    cases = []
    for pd, gd in ((f32, f32), (bf16, bf16), (bf16, f32)):
        for misalign in (0, 1):
            for clip in (None, 1.0):
                for wd in (0.0, 0.1):
                    for step in (1, 1000):
                        cases.append(((pd,) * 4, (gd,) * 4, misalign, clip,
                                      wd, step, None))
    mixed = (f32, bf16, f32, bf16)
    cases.append((mixed, mixed, 1, 1.0, 0.1, 7, None))
    for pd in (f32, bf16):
        for clip in (None, 1.0):
            cases.append(((pd,) * 4, (pd,) * 4, 0, clip, 0.1, 3, "nonfinite"))
    # the plan's heads, pieces and tails, and all-scalar leaves, in both
    # instances
    for pd, gd in ((f32, f32), (bf16, bf16), (bf16, f32)):
        for misalign in ADAM_PLAN_OFFSETS + (ADAM_ODD_PHASES,):
            cases.append(((pd,) * 4, (gd,) * 4, misalign, 1.0, 0.1, 7,
                          "plan"))
    n_bad = []
    max_err = {"fused_adam_f32": 0.0, "fused_adam_bf16": 0.0}
    for p_dt, g_dt, misalign, clip, wd, step, special in cases:
        sizes = ADAM_PLAN_SIZES if special == "plan" else ADAM_SIZES
        p, g, mu, nu = adam_operands(dev, gen, sizes, p_dt, g_dt, misalign)
        if special == "nonfinite":
            g[3][5] = float("nan")
            g[2][0] = float("inf")
            g[2][4094] = -float("inf")
        kw = dict(adam_scalars(g, step, clip, dev), b1=ADAM_B1, b2=ADAM_B2,
                  eps=ADAM_EPS, weight_decay=wd)
        a = fused_adam(p, g, mu, nu, **kw)
        b = fused_adam(p, g, mu, nu, **kw)
        ip = ([t.clone() for t in p], [t.clone() for t in mu],
              [t.clone() for t in nu])
        fused_adam(ip[0], g, ip[1], ip[2], out=ip, **kw)
        r = fused_adam_ref(p, g, mu, nu, **kw)
        torch.cuda.synchronize()
        for got in (a, b, ip):
            bad, err = adam_compare(got, r, p_dt)
            n_bad += [(p_dt, g_dt, misalign, clip, wd, step, special)] * bad
            for name, e in err.items():
                max_err[name] = max(max_err[name], e)
        if special == "nonfinite" and not (torch.isnan(a[0][3][5])
                            and torch.isnan(a[0][2][0])):
            raise AssertionError(f"fused Adam {p_dt} clip {clip}: a "
                                 "non-finite gradient did not propagate")
    if n_bad:
        raise AssertionError(f"fused Adam against its plain version: "
                             f"{len(n_bad)} mismatches, first {n_bad[0]}")
    log(f"fused Adam: {len(cases)} cases (fp32 / bf16 / bf16 with fp32 "
        f"gradients / a mixed tree; leaves {ADAM_SIZES}, aligned and 2-4 "
        f"bytes off; clip and decay on and off; steps 1 and 1000; NaN and "
        f"+-inf gradients; leaves {ADAM_PLAN_SIZES} at element offsets "
        f"{ADAM_PLAN_OFFSETS} (scalar heads and tails around vector "
        f"pieces) and p, g, mu, nu at offsets {ADAM_ODD_PHASES} (all "
        f"scalar)), each launched twice and in place: p, mu and nu bitwise "
        f"the plain version on the card")
    return {"cases": len(cases), "max_err": max_err}


# -- the clip's global norm -------------------------------------------------

# The kernel against its plain version, relative: the plain version sums
# each leaf in fp32 (PyTorch's reduction, up to ~2000 terms an accumulator
# at llama3.2-1b's 262 M-element embedding), whose error on positive terms
# is at most terms x 2**-24 of the sum, 1.2e-4 worst case, half that on the
# root; the kernel sums in double. 1e-4 of the norm keeps a factor of ~1.7
# over that worst case (random roundings stay near 1e-7).
TOL_NORM_REL = 1e-4
# phase 3's trees: leaf sizes, a multi-chunk leaf (grid-stride loop),
# and 300 leaves (the last block's warps take several leaves each)
NORM_SIZES = (1, 7, 4097)
NORM_LONG = 2 ** 22 + 3
NORM_MANY = 300


def norm_close(got, ref, rel: float) -> bool:
    """Two 0-d norms within ``rel`` of the larger, relative; both the same
    infinity or both NaN count as equal."""
    g, r = float(got), float(ref)
    if math.isnan(g) or math.isnan(r):
        return math.isnan(g) and math.isnan(r)
    if math.isinf(g) or math.isinf(r):
        return g == r
    return abs(g - r) <= rel * max(abs(g), abs(r))


def norm_kernels_phase(dev) -> dict:
    """Phase 3's global norm cases: the kernel (``global_norm``) against its
    plain version ``global_norm_ref`` on the card within ``TOL_NORM_REL``
    and against ``global_norm_model`` (its order in plain ops) within an
    fp32 rounding a leaf and two of the root (a leaf's double sum taken in
    another order may round to a neighbouring fp32, the root then to a
    neighbouring one): fp32 leaves of ``NORM_SIZES``; the same at
    element offset 1 (2 or 4 bytes off 16), bitwise the aligned copies; a
    mixed fp32 / bf16 tree; a +inf and a NaN leaf; a bf16 value whose fp32
    square overflows and an fp32 leaf whose squares' sum does (inf, as the
    plain version); one leaf of ``NORM_LONG`` elements; ``NORM_MANY``
    leaves; every case called twice, bitwise equal. Then one graph of a
    call over the mixed tree (``ops.capture_cuda_graph``, its table and
    ticket written after the capture) replayed twice on a NaN-filled
    output, bitwise the eager call each time, and once more after the
    leaves doubled in place (the norm doubles exactly). The sum-of-squares
    form (``squares=True``, the same launch's total before the root) in
    every case: twice bitwise equal, within ``TOL_NORM_REL`` of the plain
    version's sum and its root (``torch.sqrt``, correctly rounded as the
    kernel's ``__fsqrt_rn``) bitwise the norm; and captured in a graph
    beside the norm, its replays bitwise the eager call."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.global_norm import (global_norm,
                                                 global_norm_model,
                                                 global_norm_ref)
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 30)

    def leaves(sizes, dtypes, off=0):
        out = []
        for n, dt in zip(sizes, dtypes):
            t = (torch.randn(n + off, generator=gen) * 3).to(dt).to(dev)
            out.append(t[off:])
        return out

    mixed_sizes = NORM_SIZES + (3 * 32768 + 5,)
    mixed_dt = (f32, bf16) * 2
    cases = {"fp32": leaves(NORM_SIZES, (f32,) * 3),
             "bf16 offset 1": leaves(NORM_SIZES + (70001,), (bf16,) * 4, 1),
             "fp32 offset 1": leaves(NORM_SIZES + (70001,), (f32,) * 4, 1),
             "mixed": leaves(mixed_sizes, mixed_dt),
             "long": leaves((NORM_LONG,), (bf16,)),
             "many": leaves([int(v) for v in torch.randint(
                 1, 5000, (NORM_MANY,), generator=gen)],
                 (f32, bf16) * (NORM_MANY // 2))}
    special = {"+inf": (2, 17, float("inf")), "nan": (3, 4096, float("nan")),
               "square overflow": (1, 2, 3e19)}
    for name, (leaf, i, v) in special.items():
        cases[name] = [t.clone() for t in cases["mixed"]]
        cases[name][leaf][i] = v
    cases["sum overflow"] = [t.clone() for t in cases["mixed"]]
    cases["sum overflow"][2].fill_(1.5e19)     # fp32: squares finite
    want_inf = {"+inf", "square overflow", "sum overflow"}
    max_rel = max_abs = max_sq_rel = 0.0
    for name, lv in cases.items():
        a, b = global_norm(lv), global_norm(lv)
        ref, model = global_norm_ref(lv), global_norm_model(lv)
        torch.cuda.synchronize()
        n_leaves = sum(1 for t in lv if t.numel())
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"global norm {name}: two calls differ "
                                 f"({float(a)!r}, {float(b)!r})")
        if not (norm_close(a, ref, TOL_NORM_REL)
                and norm_close(a, model, (n_leaves + 2) * 2.0 ** -24)):
            raise AssertionError(f"global norm {name}: kernel {float(a)!r}, "
                                 f"plain {float(ref)!r}, model "
                                 f"{float(model)!r}")
        if (name in want_inf) != math.isinf(float(a)) or (
                (name == "nan") != math.isnan(float(a))):
            raise AssertionError(f"global norm {name}: {float(a)!r}")
        if math.isfinite(float(a)):
            max_abs = max(max_abs, abs(float(a) - float(ref)))
            max_rel = max(max_rel, abs(float(a) - float(ref)) / float(ref))
        if "offset" in name:
            copy = global_norm([t.clone() for t in lv])
            if not torch.equal(a.view(torch.int32), copy.view(torch.int32)):
                raise AssertionError(f"global norm {name}: {float(a)!r}, "
                                     f"aligned copies {float(copy)!r}")
        sa, sb = global_norm(lv, squares=True), global_norm(lv, squares=True)
        sref = global_norm_ref(lv, squares=True)
        torch.cuda.synchronize()
        root = torch.sqrt(sa)
        if not (torch.equal(sa.view(torch.int32), sb.view(torch.int32))
                and norm_close(sa, sref, TOL_NORM_REL)
                and (torch.equal(root.view(torch.int32), a.view(torch.int32))
                     if math.isfinite(float(a))
                     else norm_close(root, a, TOL_NORM_REL))):
            raise AssertionError(
                f"global norm {name}, sum of squares: kernel {float(sa)!r} "
                f"then {float(sb)!r}, plain {float(sref)!r}, its root "
                f"{float(torch.sqrt(sa))!r} against the norm {float(a)!r}")
        if math.isfinite(float(sa)):
            max_sq_rel = max(max_sq_rel,
                             abs(float(sa) - float(sref)) / float(sref))
    # one graph, replayed twice and after the leaves changed
    lv = cases["mixed"]
    eager = global_norm(lv)
    before = ops.launch_counts()
    replay = ops.capture_cuda_graph(lambda: global_norm(lv))
    captured = ops.take_back_launches(before)
    out = replay()
    outs = [out.clone()]
    out.fill_(float("nan"))
    replay()
    outs.append(out.clone())
    for t in lv:
        t.mul_(2)
    out.fill_(float("nan"))
    replay()
    doubled = out.clone()
    torch.cuda.synchronize()
    if not (all(torch.equal(o.view(torch.int32), eager.view(torch.int32))
                for o in outs) and float(doubled) == 2 * float(eager)):
        raise AssertionError(f"global norm graph: eager {float(eager)!r}, "
                             f"replays {[float(o) for o in outs]}, after "
                             f"doubling {float(doubled)!r}")
    if captured != ((ops.GLOBAL_NORM, 1),):
        raise AssertionError(f"global norm graph: captured {captured}")
    # the sum-of-squares form in a graph beside the norm
    for t in lv:
        t.div_(2)
    eager_sq = global_norm(lv, squares=True)
    replay = ops.capture_cuda_graph(
        lambda: (global_norm(lv), global_norm(lv, squares=True)))
    got = []
    for _ in range(2):
        norm_out, sq_out = replay()
        got.append((norm_out.clone(), sq_out.clone()))
        norm_out.fill_(float("nan"))
        sq_out.fill_(float("nan"))
    torch.cuda.synchronize()
    if not all(torch.equal(n.view(torch.int32), eager.view(torch.int32))
               and torch.equal(q.view(torch.int32), eager_sq.view(torch.int32))
               for n, q in got):
        raise AssertionError(f"global norm graph, sum of squares: eager "
                             f"{float(eager)!r} / {float(eager_sq)!r}, "
                             f"replays {[(float(n), float(q)) for n, q in got]}")
    log(f"global norm: {len(cases)} cases (fp32 leaves {NORM_SIZES}, the "
        f"same and 70001 at element offset 1 in fp32 and bf16, bitwise "
        f"their aligned copies; a mixed tree; +inf, NaN, a square and a sum "
        f"past fp32; {NORM_LONG} elements; {NORM_MANY} leaves), each "
        f"called twice, bitwise equal, within {TOL_NORM_REL} of the plain "
        f"version (largest {max_rel:.3e}, {max_abs:.3e} absolute) and an "
        f"fp32 rounding a leaf of "
        f"its model; a graph replayed twice bitwise the eager call and "
        f"after the leaves doubled, its double; the sum-of-squares form in "
        f"every case twice bitwise, within {TOL_NORM_REL} of the plain sum "
        f"(largest {max_sq_rel:.3e}), its root bitwise the norm, and "
        f"replayed in a graph beside the norm bitwise the eager calls")
    return {"cases": len(cases) + 1,
            "max_err": {ops.GLOBAL_NORM.name: max_abs}, "max_rel": max_rel}


def norm_row(grads, where: str, large: bool, smi) -> dict:
    """The global norm timed on ``grads`` (a main path's gradient leaves):
    the kernel, its plain version, one PyTorch call for the same norm
    (``torch.nn.utils.get_total_norm`` where this torch has it, else
    ``torch._foreach_norm`` and one ``vector_norm``: norms in the leaves'
    dtype, another rounding; a yardstick the port never calls), and the
    bound: each gradient read once at ``HBM_BYTES_PER_S``. ``large``: CUDA
    events over eager calls rather than graph replays. Before the timing
    the kernel is held against the plain version within ``TOL_NORM_REL``
    and against its order in plain ops (``global_norm_model``) within an
    fp32 rounding a leaf and two of the root, as phase 3 holds it: at a
    main path's shapes the second bound is the tight one (a dropped small
    leaf or partial chunk moves the norm by less than ``TOL_NORM_REL``).
    ``max_err`` and ``rel_err``: the kernel's distance from the plain
    version, absolute and relative."""
    import torch
    from repro_torch.kernels.global_norm import (global_norm,
                                                 global_norm_model,
                                                 global_norm_ref)
    got, ref = global_norm(grads), global_norm_ref(grads)
    model = global_norm_model(grads)
    model_rel = (sum(1 for t in grads if t.numel()) + 2) * 2.0 ** -24
    if not (norm_close(got, ref, TOL_NORM_REL)
            and norm_close(got, model, model_rel)):
        raise AssertionError(f"global_norm at {where}: {float(got)!r}, plain "
                             f"{float(ref)!r}, model {float(model)!r} "
                             f"(within {model_rel:.3e})")
    del model
    max_err = abs(float(got) - float(ref))
    total_norm = getattr(torch.nn.utils, "get_total_norm", None)
    if total_norm is not None:
        library_name = "torch.nn.utils.get_total_norm"

        def library():
            total_norm(grads, 2.0)
    else:
        library_name = "torch._foreach_norm + torch.linalg.vector_norm"

        def library():
            torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    timer = (lambda fn: events_ms(fn, 5)) if large else device_ms
    ms = timer(lambda: global_norm(grads))
    plain_ms = timer(lambda: global_norm_ref(grads))
    library_ms = timer(library)
    nbytes = sum(t.numel() * t.element_size() for t in grads)
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    n = sum(t.numel() for t in grads)
    log(f"time global_norm at {where} ({n} elements in {len(grads)} leaves): "
        f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, {library_name} "
        f"{library_ms:.5f} ms; bound {bound_ms:.5f} ms ({nbytes} B at "
        f"{HBM_BYTES_PER_S:.3e} B/s), the kernel at {bound_ms / ms:.3f} of "
        f"it; norm {float(got)!r}, kernel against plain {max_err:.3e} "
        f"({max_err / float(ref):.3e} relative), within {model_rel:.3e} of "
        f"its model [{smi}]")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": library_name, "bound_ms": bound_ms,
            "bound_by": "bytes", "bytes": nbytes, "elements": n,
            "shape": where, "max_err": max_err,
            "rel_err": max_err / float(ref)}


def adam_bytes(params, grads) -> int:
    """What one update must move: each parameter read and written, each
    gradient read, both fp32 moments read and written."""
    return sum(p.numel() * (2 * p.element_size() + g.element_size() + 16)
               for p, g in zip(params, grads))


def events_ms(fn, reps: int) -> float:
    """Time of one call of ``fn`` issued from Python between CUDA events,
    after one warm-up call (for calls whose device time dwarfs their
    launches)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def adam_row(kinfo, params, step: int, clip, wd, where: str, large: bool,
             smi) -> dict:
    """The fused Adam instance ``kinfo`` timed on the leaves of ``params``
    (a main path's tree), with seeded gradients of the parameters' dtype
    and fp32 moments: the kernel (updating in place), its plain version,
    ``torch._fused_adamw_`` over the same leaves (PyTorch's fused AdamW,
    its moments in the parameters' dtype as ``torch.optim`` keeps them,
    another rounding: a yardstick the port never calls), and the bound
    (``adam_bytes`` at ``HBM_BYTES_PER_S``); and the global norm's row on
    the same gradients (``norm_row``, under ``"norm"``). ``large``:
    time eager calls between events (a llama-size update takes ~10 ms)
    rather than graph replays. Before the timing, one update of the kernel
    in place (as the compiled step makes it) is held bitwise against the
    plain version on the same inputs; a mismatch raises, and the row's
    ``max_err`` is the largest difference measured."""
    import torch
    from repro_torch.kernels.fused_adam import fused_adam, fused_adam_ref
    from repro_torch.train.optim import tree_leaves
    dev = tree_leaves(params)[0].device
    p = [t.detach().clone() for t in tree_leaves(params)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    g = [torch.randn(t.shape, generator=gen, device=dev).mul_(1e-3).to(
        t.dtype) for t in p]
    mu = [torch.zeros_like(t, dtype=torch.float32) for t in p]
    nu = [torch.zeros_like(t, dtype=torch.float32) for t in p]
    kw = dict(adam_scalars(g, step, clip, dev), b1=ADAM_B1, b2=ADAM_B2,
              eps=ADAM_EPS, weight_decay=wd)

    def kernel():
        fused_adam(p, g, mu, nu, out=(p, mu, nu), **kw)

    ref = fused_adam_ref(p, g, mu, nu, **kw)
    kernel()
    bad, err = adam_compare((p, mu, nu), ref, [t.dtype for t in p])
    del ref
    if bad or set(err) != {kinfo.name}:
        raise AssertionError(f"{kinfo.name} at {where}: {bad} leaves differ "
                             f"from the plain version (max abs error "
                             f"{err}) or another instance ran")
    max_err = err[kinfo.name]

    def plain():
        fused_adam_ref(p, g, mu, nu, **kw)
    if large:
        ms, plain_ms = events_ms(kernel, 5), events_ms(plain, 2)
    else:
        ms, plain_ms = device_ms(kernel), device_ms(plain, 5)
    library_ms, library_note = None, ""
    try:
        lib_mu = [torch.zeros_like(t) for t in p]
        lib_nu = [torch.zeros_like(t) for t in p]
        steps = [torch.full((), float(step), device=dev) for _ in p]
        lr = float(kw["lr"])

        def library():
            torch._fused_adamw_(p, g, lib_mu, lib_nu, [], steps, lr=lr,
                                beta1=ADAM_B1, beta2=ADAM_B2,
                                weight_decay=wd, eps=ADAM_EPS,
                                amsgrad=False, maximize=False)
        library_ms = (events_ms(library, 5) if large
                      else device_ms(library))
        del lib_mu, lib_nu
    except Exception as exc:              # noqa: BLE001 - reported
        library_note = f" (torch._fused_adamw_ refused: {exc!r:.200})"
    nbytes = adam_bytes(p, g)
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    n = sum(t.numel() for t in p)
    log(f"{kinfo.name} at {where}: one update in place bitwise the plain "
        f"version in p, mu and nu (max abs error {max_err!r}) [{smi}]")
    log(f"time {kinfo.name} at {where} ({n} elements in {len(p)} leaves, "
        f"clip {clip}, decay {wd}): kernel {ms:.5f} ms, plain "
        f"{plain_ms:.5f} ms, torch._fused_adamw_ "
        + (f"{library_ms:.5f} ms" if library_ms is not None else "n/a")
        + f"{library_note}; bound {bound_ms:.5f} ms ({nbytes} B at "
        f"{HBM_BYTES_PER_S:.3e} B/s), the kernel at "
        f"{bound_ms / ms:.3f} of it [{smi}]")
    del mu, nu
    norm = norm_row(g, where, large, smi)
    del p, g
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes,
            "elements": n, "shape": where, "max_err": max_err,
            "norm": norm}


def adam_instances(dtypes) -> list:
    """The kernels a clipped step of parameters of ``dtypes`` launches, each
    once: the global norm, and the fused Adam's instance of each dtype."""
    import torch
    from repro_torch.kernels import ops
    return [ops.GLOBAL_NORM] + [
        k for dt, k in ((torch.float32, ops.FUSED_ADAM_F32),
                        (torch.bfloat16, ops.FUSED_ADAM_BF16))
        if dt in set(dtypes)]


def tally_adam(want: dict, dtypes, steps: int) -> None:
    """Add ``steps`` steps' optimizer launches to ``want`` (kernel name ->
    launches): every step of these phases clips (``AdamConfig``'s
    ``clip_norm=1.0``), so one global norm a step beside the fused Adam."""
    for k in adam_instances(dtypes):
        want[k.name] = want.get(k.name, 0) + steps


def compiled_steps(stats: dict) -> int:
    """Steps a compiled step ran: a warm-up each capture, a replay each
    call."""
    return stats["captures"] + stats["replays"]


def check_adam_launches(what: str, want: dict) -> dict:
    """The phase's launches since its reset: the global norm and the fused
    Adam's instances exactly ``want`` (its steps: one norm a clipped step,
    one Adam launch a parameter dtype), and no other hand-written
    kernel."""
    from repro_torch.kernels import ops
    n = {k: v for k, v in ops.launch_counts().items() if v}
    if n != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{what}: launches {n}, want the global norm's "
                             f"and the fused Adam's {want} alone")
    return n


def state_bitwise(a, b) -> bool:
    """Two train states (or trees) bitwise equal, leaf for leaf."""
    import torch
    from repro_torch.train.optim import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and (
            torch.equal(adam_bits(x), adam_bits(y)) if x.is_floating_point()
            else torch.equal(x, y)) for x, y in zip(la, lb))


def training_phase(dev, train_task, batch: int = 32, max_t: int = 96):
    """Phase 5d on ``train_task`` (a CTC ``GruTaskConfig``): (a) 10 steps of
    the dense pretrain, (b) 10 of the QAT DeltaGRU retrain at θ = 0.25, each
    stage's first step held against the CPU, (c) a checkpoint after step 5
    of (b), restored and steps 6-10 replayed under deterministic
    algorithms, (d) the trained stack exported to ``fused_q8`` and streamed
    through the engine's captured graph. Returns the per-stage records
    (losses, final state, step, step times, peak memory) with the served
    export's under ``"serve"`` (launches, export ms, decode errors), the
    batches and the optimizer config."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import digit_batch
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.ft.checkpoint import restore as ckpt_restore
    from repro_torch.kernels import ops
    from repro_torch.models.gru_rnn import gru_model_forward, init_gru_model
    from repro_torch.quant.export import quantize_delta_model
    from repro_torch.quant.qat import EDGEDRNN_QAT, FP32
    from repro_torch.serve.engine import DeltaStreamEngine
    from repro_torch.train.ctc import ctc_greedy_decode, edit_distance
    from repro_torch.train.losses import ctc_loss_mean
    from repro_torch.train.optim import (AdamConfig, constant_schedule,
                                         tree_leaves as opt_leaves, tree_map)
    from repro_torch.train.trainer import (LoopHooks, init_train_state,
                                           make_gru_train_step, train_loop)
    delta_task = dataclasses.replace(train_task, theta_x=THETA,
                                     theta_h=THETA)
    gen = torch.Generator().manual_seed(SEED + 2)
    batches = [digit_batch(gen, batch, max_t, device=dev)
               for _ in range(2 * TRAIN_STEPS)]
    serve_draws = digit_batch(gen, batch, max_t, device=dev)
    opt_cfg = AdamConfig(schedule=constant_schedule(TRAIN_LR))
    train = {}
    ops.reset_launch_counts()
    record, replay, qat_stats = lut_lockstep(FLIP_MARGIN)
    stages = {"dense": (train_task, FP32, False, FP32, FP32),
              "qat": (delta_task, EDGEDRNN_QAT, True, record, replay)}
    train_params = init_gru_model(SEED, train_task, device=dev)
    cpu_train_params = init_gru_model(SEED, train_task, device="cpu")
    stash = {}
    adam_want, main_adam, main_steps = {}, {}, {}
    f32 = {torch.float32}
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, every=5, keep=2)
        for si, (name, spec) in enumerate(stages.items()):
            task_s, qat, use_delta, rec, rep = spec
            step = make_gru_train_step(task_s, opt_cfg, qat=qat,
                                       use_delta=use_delta)
            cpu_step = make_gru_train_step(task_s, opt_cfg, qat=rep,
                                           use_delta=use_delta)
            stage = batches[si * TRAIN_STEPS:(si + 1) * TRAIN_STEPS]
            start = init_train_state(train_params)
            twin_start = tree_map(torch.clone, start)
            before = ops.launch_counts()
            # the first step runs eagerly (it is held against the CPU's),
            # the other nine through the compiled step: one capture, then
            # a replay each
            tstate, m1, report = first_step_against_cpu(
                f"train {name}", step.eager, cpu_step, start,
                init_train_state(cpu_train_params), stage[0], rec, rep,
                task_s, use_delta, TRAIN_LR)
            log(report)

            def keep(i, st, name=name):
                if name == "qat":
                    mgr.maybe_save(int(st.step), st)
                    if int(st.step) == 5:
                        stash[5] = st
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            pools0 = graph_pools()
            tstate, hist = train_loop(
                step, tstate, stage[1:-1], TRAIN_STEPS - 2,
                LoopHooks(checkpoint_every=1, save_checkpoint=keep))
            # the last step: a call after the first makes no host sync
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                tstate, m_last = step(tstate, stage[-1])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            hist.append({k: float(v) for k, v in m_last.items()})
            hist[-1]["step_time_s"] = time.perf_counter() - t0
            keep(TRAIN_STEPS - 1, tstate)
            peak = torch.cuda.max_memory_allocated() - base
            pool = new_pool_bytes(pools0)
            after = ops.launch_counts()
            for k in (ops.FUSED_ADAM_F32, ops.FUSED_ADAM_BF16,
                      ops.GLOBAL_NORM):
                main_adam[k.name] = (main_adam.get(k.name, 0)
                                     + after[k.name] - before[k.name])
            tally_adam(adam_want, f32, 1 + compiled_steps(step.stats))
            tally_adam(main_steps, f32, 1 + compiled_steps(step.stats))
            losses = [float(m1["loss"])] + [h["loss"] for h in hist]
            if not all(np.isfinite(losses)) or not (
                    np.mean(losses[-3:]) < losses[0]):
                raise AssertionError(f"train {name}: losses {losses}")
            # the eager twin: the same ten steps op by op from a copy of
            # the stage's first state
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_e = torch.cuda.memory_allocated()
            e_state, e_hist = train_loop(step.eager, twin_start, stage,
                                         TRAIN_STEPS)
            peak_e = torch.cuda.max_memory_allocated() - base_e
            tally_adam(adam_want, f32, TRAIN_STEPS)
            e_losses = [h["loss"] for h in e_hist]
            if e_losses != losses or not state_bitwise(tstate, e_state):
                raise AssertionError(
                    f"train {name}: the compiled steps are not bitwise the "
                    f"eager step's: losses {losses} / {e_losses}, state "
                    f"bitwise {state_bitwise(tstate, e_state)}")
            del e_state, twin_start
            log(f"train {name}: steps 2-{TRAIN_STEPS} through the compiled "
                f"step ({step.stats['captures']} capture, "
                f"{step.stats['replays']} replays, the last under "
                f"set_sync_debug_mode('error')) and the first eager: "
                f"losses, parameters, moments and step count bitwise "
                f"{TRAIN_STEPS} eager steps from a copy of the first state")
            train[name] = {"losses": losses, "state": tstate, "step": step,
                           "task": task_s, "qat": qat, "use_delta": use_delta,
                           "step_ms": [1e3 * h["step_time_s"] for h in hist],
                           "eager_step_ms": [1e3 * h["step_time_s"]
                                             for h in e_hist],
                           "capture_s": step.stats["capture_s"],
                           "pool_bytes": pool,
                           "peak_bytes": peak, "eager_peak_bytes": peak_e,
                           "base_bytes": base}
            cell = f"QAT DeltaGRU, theta={THETA}" if use_delta else "GRU"
            log(f"train {name} ({cell}, {train_task.num_layers}L-"
                f"{train_task.hidden_size}H CTC, B={batch} T={max_t}, Adam "
                f"{TRAIN_LR}): losses "
                + ", ".join(f"{v:.4f}" for v in losses))
            train_params = tstate.params
            cpu_train_params = {
                k2: (v.cpu() if isinstance(v, torch.Tensor)
                     else [p.to("cpu") for p in v])
                for k2, v in tstate.params.items()}
        mgr.wait()

        # (c) resume: steps 6-10 of the QAT stage from the in-memory state
        # at step 5 and from its checkpoint, both under deterministic
        # algorithms (gather's backward, a scatter-add, otherwise adds with
        # atomics); PyTorch then refuses cuBLAS unless its workspace is fixed
        prior_ws = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        q = train["qat"]
        tail = batches[TRAIN_STEPS + 5:2 * TRAIN_STEPS]
        torch.use_deterministic_algorithms(True)
        try:
            restored = ckpt_restore(tmp, stash[5], step=5, device=dev)
            same_restore = all(torch.equal(a, b) for a, b in zip(
                opt_leaves(restored), opt_leaves(stash[5])))
            # the compiled step captures again: the switch is in its key
            captures = q["step"].stats["captures"]
            replays = q["step"].stats["replays"]
            a_state, _ = train_loop(q["step"], stash[5], tail, 5)
            b_state, _ = train_loop(q["step"], restored, tail, 5)
            tally_adam(adam_want, f32,
                       q["step"].stats["captures"] - captures
                       + q["step"].stats["replays"] - replays)
        finally:
            torch.use_deterministic_algorithms(False)
            if prior_ws is None:
                os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = prior_ws
        resume_bitwise = all(torch.equal(a, b) for a, b in zip(
            opt_leaves(a_state), opt_leaves(b_state)))
        timed_diff = max(float((a - b).abs().max()) for a, b in zip(
            opt_leaves(a_state.params), opt_leaves(q["state"].params)))
        # which part of the step differs between runs with the default
        # algorithms: the CTC loss's gradient w.r.t. the logits, and the
        # network's gradient under a fixed cotangent, each taken twice
        p = tree_map(lambda t: t.detach().requires_grad_(True),
                     q["state"].params)
        bt = batches[TRAIN_STEPS]
        out, _ = gru_model_forward(p, delta_task, bt["features"],
                                   qat=EDGEDRNN_QAT)
        logits = out.detach().requires_grad_(True)
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            SEED)).to(dev)

        def ctc_grad():
            loss = ctc_loss_mean(logits, bt["labels"], bt["in_lens"],
                                 bt["lab_lens"])[0]
            return [torch.autograd.grad(loss, logits)[0]]

        def net_grad():
            return torch.autograd.grad(out, opt_leaves(p), cot,
                                       retain_graph=True)
        twice = {}
        for part, fn in (("ctc", ctc_grad), ("net", net_grad)):
            g1, g2 = fn(), fn()
            twice[part] = max(float((a - b).abs().max())
                              for a, b in zip(g1, g2))
        log(f"train resume: checkpoint at step 5 restored bitwise "
            f"{same_restore}; steps 6-10 replayed from it under "
            f"deterministic algorithms bitwise equal to the same steps from "
            f"the state in memory: {resume_bitwise}; the timed run's step 10 "
            f"(default algorithms) differs from them by {timed_diff:.3e} in "
            f"the parameters; with the default algorithms, twice over: the "
            f"CTC loss's gradient w.r.t. the logits differs by "
            f"{twice['ctc']:.3e}, the network's gradient under a fixed "
            f"cotangent by {twice['net']:.3e}")
        if not (same_restore and resume_bitwise):
            raise AssertionError("train resume is not bitwise")
        n_adam = check_adam_launches("phase 5d training", adam_want)
        log(f"train launches: {n_adam}, exactly one global_norm and one "
            f"fused_adam_f32 a step (eager steps, compiled steps' warm-ups "
            f"and replays) and no other hand-written kernel")
    # the CPU ran two forwards (gradients, then the step) over one log
    log(f"train qat first step: {qat_stats['sites'] // 2} LUT sites a "
        f"forward; {qat_stats['flips'] // 2} of the CPU's outputs differed "
        f"from the card's and took the card's value (largest distance of "
        f"such a pre-rounding value from a rounding boundary: "
        f"{qat_stats['max_margin']:.3e} of a Q1.4 step)")

    # (d) export the trained stack and stream a fresh digit batch through
    # the engine's captured graph at θ = 0.25
    trained = train["qat"]["state"].params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_prog = quantize_delta_model(trained)
    torch.cuda.synchronize()
    export_ms = 1e3 * (time.perf_counter() - t0)
    serve_cpu = quantize_delta_model(
        {k2: (v.cpu() if isinstance(v, torch.Tensor)
              else [p.to("cpu") for p in v]) for k2, v in trained.items()},
        device="cpu")
    feats = serve_draws["features"].cpu().numpy()
    n_serve = feats.shape[1]
    eng = DeltaStreamEngine(serve_prog, delta_task, n_streams=n_serve)
    steps0 = engine_steps(eng)
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = eng.step_many(feats)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    n_served = {k: v for k, v in ops.launch_counts().items() if v}
    q8 = ops.DELTA_Q8_GRU_I8
    layers = train_task.num_layers
    want = times(step_launches({q8.name: layers}, layers),
                 engine_steps(eng) - steps0)
    if n_served != want:
        raise AssertionError(f"served export: launches {n_served}, want "
                             f"{want}")
    graph_check("served export", eng, feats.shape[0])
    ce = DeltaStreamEngine(serve_cpu, delta_task, n_streams=n_serve,
                           device="cpu")
    c_outs = ce.step_many(feats)
    same_state = all(torch.equal(a.cpu(), b) for a, b in zip(
        tree_leaves(eng.state), tree_leaves(ce.state)))
    head_err = float((outs.cpu() - c_outs).abs().max())
    if not same_state or head_err > TOL_HEAD or not torch.isfinite(
            outs).all():
        raise AssertionError(f"served export disagrees with the CPU program: "
                             f"state bitwise {same_state}, outputs "
                             f"{head_err:.3e}")
    decoded = ctc_greedy_decode(torch.log_softmax(outs, -1),
                                serve_draws["in_lens"]).cpu().numpy()
    labels = serve_draws["labels"].cpu().numpy()
    lab_lens = serve_draws["lab_lens"].cpu().numpy()
    errors = sum(edit_distance([v for v in d if v >= 0],
                               list(lab[:ln]))
                 for d, lab, ln in zip(decoded, labels, lab_lens))
    train["serve"] = {"export_ms": export_ms, "errors": errors,
                      "labels": int(lab_lens.sum()),
                      "launches": n_served}
    train["adam_launches"] = main_adam
    train["adam_steps"] = main_steps
    log(f"served export (fused_q8, {n_serve} streams, {feats.shape[0]} "
        f"frames, theta={THETA}): launches {n_served}; final state bitwise the CPU program's, outputs "
        f"{head_err:.3e}; greedy "
        f"decode edit distance {errors} over {int(lab_lens.sum())} labels "
        f"({errors / lab_lens.sum():.4f} a label); report gamma_dx "
        f"{eng.report()['gamma_dx']:.4f}")
    return train, batches, opt_cfg


# -- phase 5e: the serving fabric --------------------------------------------

FABRIC_JSON = ROOT / "benchmarks" / "BENCH_fabric.json"
# the fabric's own tick-exact record (benchmarks/loadgen_fabric.py, the JAX
# package's): its config is the run, its counts the gate
FABRIC_PROFILE_TICKS = (6, 10)     # ticks profiled in (b)'s second run


def steady_percentile(walls, q):
    """``benchmarks/loadgen_fabric.py::_steady_percentile``: the percentile
    of the tick walls after dropping ticks over 10 × the median."""
    if not walls:
        return 0.0
    walls = sorted(walls)
    med = walls[len(walls) // 2]
    steady = [w for w in walls if w <= 10 * med] or walls
    return steady[min(len(steady) - 1, int(q * len(steady)))]


def fabric_check_contract(router, summary, cfg) -> None:
    """The hard asserts of ``benchmarks/loadgen_fabric.py`` on one run:
    both books close, the scale-down displaced streams and every one of
    them completed, and the full fleet reached ``min_concurrent``."""
    cons = router.conservation()
    replayed = [r for r in summary.results.values() if r.replayed]
    if not (cons["conserved"] and cons["queued"] == 0
            and cons["in_flight"] == 0
            and cons["submitted"] == cfg["n_arrivals"]
            == cons["completed"] + cons["rejected"] + cons["shed"]
            and cons["frames_conserved"]
            and summary.scale_info is not None and cons["rebalanced"] > 0
            and len(replayed) == cons["rebalanced"]
            and all(r.status == "ok" for r in replayed)
            and summary.peak_concurrent_full >= cfg["min_concurrent"]):
        raise AssertionError(f"fabric contract: {cons}, peak on the full "
                             f"fleet {summary.peak_concurrent_full}")


def fabric_counts(router, summary, fleet, parity_ok) -> dict:
    """The tick-exact ``counts`` block, computed as
    ``benchmarks/loadgen_fabric.py`` computes it."""
    cons = router.conservation()
    results = summary.results
    ok_lat = sorted(r.latency_ticks for r in results.values()
                    if r.status == "ok")
    rep = router.report()
    return {
        "submitted": cons["submitted"],
        "completed": cons["completed"],
        "rejected": cons["rejected"],
        "shed": cons["shed"],
        "rebalanced": cons["rebalanced"],
        "replayed_completed": sum(r.replayed for r in results.values()),
        "parity_ok": parity_ok,
        "frames_out": cons["frames_out"],
        "harvested_steps": cons["harvested_steps"],
        "ticks": summary.ticks,
        "peak_concurrent": summary.peak_concurrent,
        "peak_concurrent_full": summary.peak_concurrent_full,
        "peak_active": summary.peak_active,
        "latency_ticks_p50": ok_lat[len(ok_lat) // 2],
        "latency_ticks_p99": ok_lat[min(len(ok_lat) - 1,
                                        int(0.99 * len(ok_lat)))],
        "per_shard_completed": (
            [b["completed"] for b in rep["retired_shards"]]
            + [b["completed"] for b in rep["per_shard"]]),
        "fleet_shards_final": fleet.n_shards,
    }


def fabric_parity(arrivals, results, fleet, keep_first=False):
    """``benchmarks/loadgen_fabric.py::_check_parity`` on the fleet's
    device: every completed stream bitwise equal to a clean run on a
    same-width reference engine (``fleet.reference_engine()``), B streams
    a reference run, short streams padded with their last frame. Returns
    the count and, with ``keep_first``, the first group's frames, outputs
    and final state (for the CPU rerun)."""
    import numpy as np
    b = fleet.streams_per_shard
    ref = fleet.reference_engine()
    completed = [(i, r) for i, r in sorted(results.items())
                 if r.status == "ok"]
    parity_ok, first = 0, None
    for base in range(0, len(completed), b):
        group = completed[base:base + b]
        t_max = max(len(arrivals[i][1]) for i, _ in group)
        xs = np.zeros((t_max, b, fleet.dims.input_size), np.float32)
        for j, (i, _) in enumerate(group):
            frames = arrivals[i][1]
            xs[:len(frames), j] = frames
            xs[len(frames):, j] = frames[-1]
        ref.reset()
        want = ref.step_many(xs).cpu().numpy()
        if keep_first and first is None:
            first = {"xs": xs, "outs": want,
                     "state": [t.to("cpu", copy=True)
                               for t in tree_leaves(ref.state)]}
        for j, (i, r) in enumerate(group):
            got = np.stack([np.asarray(o) for o in r.outputs])
            if want[:len(got), j].tobytes() != got.tobytes():
                raise AssertionError(
                    f"fabric parity: arrival {i} (shard {r.shard}, replayed="
                    f"{r.replayed}, {len(got)} frames) diverged from its "
                    "clean same-width reference")
            parity_ok += 1
    return parity_ok, first


class TickProfile:
    """``torch.profiler`` (device activity only: recording every host op
    of ~1000 streams' bookkeeping would slow the ticks it measures) and
    two CUDA events over router ticks ``first`` to ``last`` (the arrivals
    submitted between them included), driven from ``run_fabric_load``'s
    ``on_tick`` hook: kernels, device busy and idle share a tick, as
    ``engine_profile`` reads them."""

    def __init__(self, first: int, last: int):
        self.first, self.last = first, last
        self.result = None

    def __call__(self, router, tick):
        import torch
        from torch.profiler import ProfilerActivity, profile
        if tick == self.first - 1:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.start = torch.cuda.Event(enable_timing=True)
            self.stop = torch.cuda.Event(enable_timing=True)
            self.t0 = time.perf_counter()
            self.start.record()
        elif tick == self.last:
            self.stop.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)
            n = self.last - self.first + 1
            kernels = [e for e in self.prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_us = sum(e.time_range.elapsed_us() for e in kernels)
            self.result = {
                "ticks": n, "kernels_per_tick": len(kernels) / n,
                "device_busy_us_per_tick": busy_us / n,
                "wall_us_per_tick": 1e6 * wall / n,
                "event_us_per_tick": 1e3 * self.start.elapsed_time(
                    self.stop) / n,
                "idle_share": 1.0 - busy_us / (1e6 * wall)}


def timed(obj, name, acc, calls=None) -> None:
    """Wrap the method ``name`` of ``obj`` so that ``acc[name]`` sums the
    host seconds spent in its calls (and ``calls[name]`` counts them)."""
    fn = getattr(obj, name)
    acc[name] = 0.0
    if calls is not None:
        calls[name] = 0

    def call(*args, **kwargs):
        if calls is not None:
            calls[name] += 1
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[name] += time.perf_counter() - t0

    setattr(obj, name, call)


# the host launches of a session open: the slot buffer's fill and one graph
# replay (the CUDA runtime calls that put work on a stream)
OPEN_LAUNCHES = 2
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                "cudaMemcpy", "cudaMemset")


def host_launches(fn) -> dict:
    """The CUDA runtime calls of ``LAUNCH_CALLS`` the host makes while
    ``fn()`` runs, by name (``torch.profiler``'s runtime events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.name.startswith(LAUNCH_CALLS):
            names[e.name] = names.get(e.name, 0) + 1
    return names


def session_opens(fleet, dev, n: int = 16) -> dict:
    """The session programs on the drained fleet of a 5e (b) run. Shard
    0's engine opens a stream (its open program captured), then one more
    under the profiler: at most ``OPEN_LAUNCHES`` host launches and one
    session replay; then ``n`` back to back (host µs an open). The fleet
    then opens on shard 1 the same way: each open the shard engine's reset
    replay alone (its only session program), its rollback shadow bitwise
    as it was. Every stream is closed after. Returns the launches by name
    and the host µs an open, of each kind."""
    import torch
    out = {}

    def opens(open_one, eng, what):
        sids = [open_one()]
        replays = eng.session_stats["replays"]
        names = host_launches(lambda: sids.append(open_one()))
        if not (1 <= sum(names.values()) <= OPEN_LAUNCHES
                and eng.session_stats["replays"] == replays + 1):
            raise AssertionError(f"{what}: host launches {names} (want at "
                                 f"most {OPEN_LAUNCHES}), "
                                 f"{eng.session_stats['replays'] - replays} "
                                 "session replays (want 1)")
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            sids.append(open_one())
        host_us = 1e6 * (time.perf_counter() - t0) / n
        sync(dev)
        if eng.session_stats["replays"] != replays + 1 + n:
            raise AssertionError(f"{what}: {n} opens, session replays "
                                 f"{eng.session_stats['replays'] - replays}")
        return sids, {"launches": names, "host_us": host_us}

    eng = fleet.engines[0]
    pools = graph_pool_bytes()
    sids, out["engine"] = opens(eng.open_stream, eng, "engine open")
    out["pool_kib"] = (None if pools is None
                       else (graph_pool_bytes() - pools) / 2 ** 10)
    host = eng.host_carry()
    for sid in sids:
        eng.close_stream(sid, host_carry=host)
    out["capture_ms"] = 1e3 * eng.session_stats["capture_s"]
    shard = fleet.engines[1]
    snap = [t.clone() for t in tree_leaves(shard._snap_state)
            + list(shard._snap_carry.values())]
    sids, out["fleet"] = opens(lambda: fleet.open_stream(1), shard,
                               "fleet open")
    after = tree_leaves(shard._snap_state) + list(shard._snap_carry.values())
    if sorted(shard._sessions) != ["reset"] or not all(
            torch.equal(a, b) for a, b in zip(snap, after)):
        raise AssertionError(f"fleet open: session programs "
                             f"{sorted(shard._sessions)} (want the reset "
                             "alone), or the shard's shadow moved")
    host = fleet.host_carry()
    for sid in sids:
        fleet.close_stream(sid, host_carry=host)
    return out


def fabric_run(prog, task, cfg, arrivals, dev, ckpt_dir, *, quiet_no_sync,
               on_tick=None) -> dict:
    """One load run of the committed fabric configuration ``cfg``
    (``BENCH_fabric.json``'s): a ``ShardedStreamFleet`` of
    ``n_shards × streams_per_shard`` slots on ``dev`` (the mesh lists the
    device once a shard), a ``StreamRouter`` with ``max_queue``, the
    arrivals through ``run_fabric_load`` with the scale-down of
    ``scale_down_shard`` at ``scale_down_at`` into ``ckpt_dir``. With
    ``quiet_no_sync`` every tick on which no stream can finish runs under
    ``no_sync``. Records the ticks that stepped the fleet with the live
    shards, the export of the dying shard taken just before
    ``remove_shard`` and the scale-down's time (drain checkpoint and
    remove)."""
    from repro_torch.dist.elastic import best_mesh
    from repro_torch.dist.serving import ShardedStreamFleet
    from repro_torch.serve.loadgen import run_fabric_load
    from repro_torch.serve.router import RouterPolicy, StreamRouter
    n_shards = cfg["n_shards"]
    mesh = best_mesh(n_shards, devices=[dev] * n_shards)
    fleet = ShardedStreamFleet(prog, task,
                               n_streams=n_shards * cfg["streams_per_shard"],
                               mesh=mesh)
    router = StreamRouter(fleet, RouterPolicy(max_queue=cfg["max_queue"]))
    rec = {"quiet_ticks": 0, "shard_steps": 0, "before_remove": None,
           "scale_ms": None}
    router_tick, fleet_remove = router.tick, fleet.remove_shard

    def tick():
        # a stream finishes this tick iff it is in flight on its last
        # frame, or queued with a single frame (admitted and finished)
        harvest = (any(r.cursor + 1 >= len(r.frames)
                       for r in router._slot_rec.values())
                   or any(len(r.frames) == 1 for q in router.queues
                          for r in q))
        ticks = fleet._n_ticks
        if quiet_no_sync and not harvest:
            rec["quiet_ticks"] += 1
            with no_sync(dev):
                out = router_tick()
        else:
            out = router_tick()
        if fleet._n_ticks > ticks:
            rec["shard_steps"] += fleet.n_shards
        return out

    def remove_shard(dead, ckpt_dir=None):
        rec["before_remove"] = fleet.export_shard_engine(dead)
        sync(dev)
        t0 = time.perf_counter()
        info = fleet_remove(dead, ckpt_dir=ckpt_dir)
        sync(dev)
        rec["scale_ms"] = 1e3 * (time.perf_counter() - t0)
        return info

    router.tick, fleet.remove_shard = tick, remove_shard
    # host seconds in the fleet's calls and the router's submits (a carry
    # read waits for the tick's replays to finish)
    rec["host_s"], rec["host_calls"] = {}, {}
    for obj, name in ((fleet, "step"), (fleet, "open_stream"),
                      (fleet, "host_carry"), (fleet, "close_stream"),
                      (router, "submit")):
        timed(obj, name, rec["host_s"], rec["host_calls"])
    sync(dev)
    t0 = time.perf_counter()
    summary = run_fabric_load(
        router, arrivals, scale_down_at=cfg["scale_down_at"],
        scale_down_shard=cfg["scale_down_shard"], ckpt_dir=ckpt_dir,
        on_tick=on_tick)
    sync(dev)
    rec["wall_s"] = time.perf_counter() - t0
    ckpt = summary.scale_info["checkpoint"]
    if not (ckpt and os.path.exists(ckpt)):
        raise AssertionError("scale-down did not publish the dying shard's "
                             "drain checkpoint")
    fabric_check_contract(router, summary, cfg)
    rec.update(fleet=fleet, router=router, summary=summary)
    return rec


def fabric_phase(dev, model_768, kernel_q8, kernel_f32, smi) -> dict:
    """Phase 5e: the serving fabric on the card. (a) ``BENCH_fabric.json``'s
    configuration at its own width (I = 8, H = 16, L = 2, O = 3, θ = 0.05,
    ``quantize_delta_model`` of seed-0 ``init_gru_model``): its counts
    exactly, every completed stream bitwise its same-width reference, the
    drain checkpoint published. (b) The same traffic at 2L-768H
    (``model_768``, ``quantize_delta_model``, θx = θh = 0.25, frames of
    40): the counts twice, every stream bitwise, the first reference group
    against the CPU, the drain checkpoint restored into an engine equal to
    the dying shard's export, exact launches of ``kernel_q8`` and no other,
    no host sync on ticks that harvest nothing, and the tick profile of
    the second run. Then a ``fused`` fleet of 4 × 8 ``step_many`` over 20
    frames, bitwise 4 standalone 8-stream engines. Returns the launches a
    kernel and the timings."""
    import numpy as np
    import torch
    from repro_torch.core.program import compile_deltagru
    from repro_torch.dist import serving
    from repro_torch.dist.elastic import best_mesh
    from repro_torch.kernels import ops
    from repro_torch.models.gru_rnn import (PAPER_NETWORKS, GruTaskConfig,
                                            init_gru_model)
    from repro_torch.quant.export import quantize_delta_model
    from repro_torch.serve.loadgen import poisson_arrivals
    bench = json.loads(FABRIC_JSON.read_text())
    cfg, want_counts = bench["config"], bench["counts"]
    launches = {kernel_q8.name: 0, kernel_f32.name: 0}
    Recorded = recording(serving.DeltaStreamEngine)
    saved = serving.DeltaStreamEngine
    serving.DeltaStreamEngine = Recorded

    def arrivals_of(width):
        return poisson_arrivals(cfg["n_arrivals"], cfg["rate_per_tick"],
                                min_len=cfg["min_len"],
                                max_len=cfg["max_len"], input_size=width,
                                seed=cfg["seed"])

    def counted(what, run_fn, kinfo, layers):
        """``run_fn()`` from zero counts; the launches must be a step's
        (``layers`` of ``kinfo`` and of the Delta Unit, one epilogue) for
        each step of every engine it made (captures' warm-up steps and
        replays' steps) and no other."""
        Recorded.made.clear()
        ops.reset_launch_counts()
        out = run_fn()
        sync(dev)
        n = {k: v for k, v in ops.launch_counts().items() if v}
        steps = sum(engine_steps(e) for e in Recorded.made)
        want = times(step_launches({kinfo.name: layers}, layers), steps)
        # (on the CPU no kernel launches)
        if n != (want if dev.type == "cuda" else {}):
            raise AssertionError(f"{what}: launches {n}, want {want}")
        add_counts(launches, n)
        return out, list(Recorded.made)

    res = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # (a) the committed configuration at its own width
            task_a = GruTaskConfig(cfg["input"], cfg["hidden"], cfg["layers"],
                                   3, task="regression", theta_x=0.05,
                                   theta_h=0.05)
            prog_a = quantize_delta_model(
                init_gru_model(0, task_a, device=dev), device=dev)
            arr_a = arrivals_of(cfg["input"])

            def run_a():
                run = fabric_run(prog_a, task_a, cfg, arr_a, dev,
                                 os.path.join(tmp, "a"), quiet_no_sync=False)
                run["parity_ok"], _ = fabric_parity(
                    arr_a, run["summary"].results, run["fleet"])
                return run

            run, _ = counted("fabric (a)", run_a, kernel_q8, task_a.num_layers)
            counts = fabric_counts(run["router"], run["summary"], run["fleet"],
                                   run["parity_ok"])
            if counts != want_counts:
                raise AssertionError(f"fabric (a): counts {counts}, "
                                     f"BENCH_fabric.json {want_counts}")
            log(f"fabric (a) I={cfg['input']} H={cfg['hidden']} "
                f"L={cfg['layers']} fused_q8, {cfg['n_shards']} shards x "
                f"{cfg['streams_per_shard']} on {dev}: counts equal "
                f"BENCH_fabric.json key for key ({counts['completed']} "
                f"completed, {counts['rejected']} rejected, "
                f"{counts['rebalanced']} rebalanced, {counts['ticks']} "
                f"ticks); {counts['parity_ok']} streams bitwise their "
                f"reference; wall {run['wall_s']:.4f} s [{smi}]")
            del run

            # (b) the same traffic at 2L-768H
            task_b = dataclasses.replace(PAPER_NETWORKS["2L-768H"],
                                         theta_x=THETA, theta_h=THETA)
            prog_b = quantize_delta_model(model_768, device=dev)
            arr_b = arrivals_of(task_b.input_size)
            layers = task_b.num_layers

            def run_b1():
                run = fabric_run(prog_b, task_b, cfg, arr_b, dev,
                                 os.path.join(tmp, "b1"), quiet_no_sync=True)
                run["parity_ok"], run["first"] = fabric_parity(
                    arr_b, run["summary"].results, run["fleet"],
                    keep_first=True)
                run["restored"] = Recorded.restore(
                    os.path.join(tmp, "b1"), run["fleet"].program, task_b,
                    n_streams=cfg["streams_per_shard"], device=dev)
                return run

            run, made = counted("fabric (b) run 1", run_b1, kernel_q8, layers)
            fleet, router = run["fleet"], run["router"]
            fleet_steps = fleet.graph_stats["replays"]
            if (fleet_steps != run["shard_steps"] and dev.type == "cuda") \
                    or run["quiet_ticks"] < 1:
                raise AssertionError(
                    f"fabric (b): {fleet_steps} shard replays, want live "
                    f"shards summed over the ticks, {run['shard_steps']}; "
                    f"{run['quiet_ticks']} ticks without a harvest")
            counts = fabric_counts(router, run["summary"], fleet,
                                   run["parity_ok"])
            if counts != want_counts:
                raise AssertionError(f"fabric (b): counts {counts}, "
                                     f"BENCH_fabric.json {want_counts}")
            # the first reference group again on the CPU
            first = run["first"]
            cpu_ref = fleet.reference_engine(device="cpu")
            cpu_outs = cpu_ref.step_many(first["xs"]).numpy()
            state_same = all(torch.equal(a, b) for a, b in zip(
                first["state"], tree_leaves(cpu_ref.state)))
            cpu_err = float(np.abs(cpu_outs - first["outs"]).max())
            if not state_same or cpu_err > TOL_HEAD:
                raise AssertionError(
                    f"fabric (b): the first group on the CPU: state bitwise "
                    f"{state_same}, outputs {cpu_err:.3e} > {TOL_HEAD}")
            # the drain checkpoint against the dying shard's export
            back, exported = run["restored"], run["before_remove"]
            if not (same_buffers(back, exported)
                    and back.report() == exported.report()
                    and back._slot_busy == exported._slot_busy
                    and back._n_steps == exported._n_steps):
                raise AssertionError("fabric (b): the drain checkpoint "
                                     "restores into another engine than "
                                     "the dying shard's export")
            walls = router.tick_wall_s
            res["b"] = {
                "wall_s": run["wall_s"],
                "streams_per_s": counts["completed"] / run["wall_s"],
                "frames_per_s": counts["frames_out"] / run["wall_s"],
                "p50_tick_ms": 1e3 * steady_percentile(walls, 0.50),
                "p99_tick_ms": 1e3 * steady_percentile(walls, 0.99),
                "median_tick_ms": 1e3 * float(np.median(walls)),
                "max_tick_ms": 1e3 * max(walls),
                "replays_per_tick": fleet_steps / fleet.graph_stats["ticks"],
                "scale_ms": run["scale_ms"],
                "quiet_ticks": run["quiet_ticks"],
                "engines": len(made),
                "ticks_ms": 1e3 * sum(walls),
                "host_ms": {k: 1e3 * v for k, v in run["host_s"].items()}}
            log(f"fabric (b) 2L-768H fused_q8, {cfg['n_shards']} shards x "
                f"{cfg['streams_per_shard']} on {dev}: counts equal "
                f"BENCH_fabric.json; {counts['parity_ok']} streams bitwise "
                f"their reference on the card; first group on the CPU: "
                f"state bitwise, outputs {cpu_err:.3e}; drain checkpoint "
                f"restored equal to the export; {fleet_steps} shard replays "
                f"in {fleet.graph_stats['ticks']} ticks, "
                f"{launches[kernel_q8.name]} launches of {kernel_q8.name} "
                f"with the step's Delta Units and epilogues and no other "
                f"({len(made)} engines); "
                f"{run['quiet_ticks']} ticks without a harvest under "
                f"set_sync_debug_mode('error') [{smi}]")
            # the session programs: host launches and host µs an open
            calls = run["host_calls"]["open_stream"]
            res["b"]["open_us"] = 1e6 * run["host_s"]["open_stream"] / calls
            res["b"]["opens"] = calls
            if dev.type == "cuda":
                op = res["b"]["sessions"] = session_opens(fleet, dev)
                log(f"fabric (b) sessions: an engine open "
                    f"{op['engine']['launches']} (one fill and one replay "
                    f"of the open program: reset and snapshot), "
                    f"{op['engine']['host_us']:.2f} us of host time an open "
                    f"(16 back to back), its capture "
                    f"{op['capture_ms']:.3f} ms, its graph's private pool "
                    f"{op['pool_kib']} KiB; a fleet open "
                    f"{op['fleet']['launches']} (the shard's reset replay "
                    f"alone, its rollback shadow bitwise as it was), "
                    f"{op['fleet']['host_us']:.2f} us; the run's {calls} "
                    f"fleet opens {res['b']['open_us']:.2f} us each "
                    f"[{smi}]")
            # one surviving shard's replay at B = 128, 20 steps of frames
            # like the arrivals': kernels, busy, the int8 tile kernel's time
            shard = fleet.engines[0]
            xs = np.random.default_rng(SEED + 3).standard_normal(
                (20, cfg["streams_per_shard"], task_b.input_size)).astype(
                np.float32)
            if dev.type == "cuda":
                shard.step_many(xs)           # its chunks' graphs, once
                ops.reset_launch_counts()
                res["shard_profile"] = engine_profile(
                    lambda: shard.step_many(xs), len(xs),
                    match="delta_q8_kernel")
                n = {k: v for k, v in ops.launch_counts().items() if v}
                if n != times(step_launches({kernel_q8.name: layers},
                                            layers), len(xs)):
                    raise AssertionError(f"fabric shard profile: launches "
                                         f"{n}")
                res["shard_counted"] = {k: v / len(xs) for k, v in n.items()}
                counted_kernels(res["shard_profile"], res["shard_counted"],
                                "fabric shard profile")
                add_counts(launches, n)
            del run, fleet, router, made, back, exported, cpu_ref, shard

            # (b) again, counts equal; ticks FABRIC_PROFILE_TICKS profiled
            prof = TickProfile(*FABRIC_PROFILE_TICKS)

            def run_b2():
                return fabric_run(prog_b, task_b, cfg, arr_b, dev,
                                  os.path.join(tmp, "b2"),
                                  quiet_no_sync=False, on_tick=prof)

            run, _ = counted("fabric (b) run 2", run_b2, kernel_q8, layers)
            # parity was held on the first run; the counts' parity_ok is
            # the completed streams that equal their reference there
            counts2 = fabric_counts(run["router"], run["summary"],
                                    run["fleet"], counts["parity_ok"])
            if counts2 != want_counts or prof.result is None:
                raise AssertionError(f"fabric (b) run 2: counts {counts2}")
            res["b"]["profile"] = prof.result
            res["b"]["wall2_s"] = run["wall_s"]
            res["b"]["p50_tick2_ms"] = 1e3 * steady_percentile(
                run["router"].tick_wall_s, 0.50)
            res["b"]["p99_tick2_ms"] = 1e3 * steady_percentile(
                run["router"].tick_wall_s, 0.99)
            del run

            # a fused (fp32) fleet of 4 x 8 against 4 standalone engines
            prog_f = compile_deltagru(model_768, "fused", device=dev)
            xs = smooth_frames(np.random.default_rng(SEED + 2), 20, 32,
                               task_b.input_size)

            def run_f():
                mesh = best_mesh(4, devices=[dev] * 4)
                fl = serving.ShardedStreamFleet(prog_f, task_b, n_streams=32,
                                                mesh=mesh)
                got = fl.step_many(xs)
                solo = [serving.DeltaStreamEngine(prog_f, task_b,
                                                  n_streams=8, device=dev)
                        for _ in range(4)]
                want = [e.step_many(xs[:, 8 * s:8 * (s + 1)])
                        for s, e in enumerate(solo)]
                return fl, got, solo, want

            (fl, got, solo, want), _ = counted("fabric fp32 fleet", run_f,
                                               kernel_f32, layers)
            same = all(
                torch.equal(got[:, 8 * s:8 * (s + 1)], want[s])
                and all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(fl.engines[s].state),
                    tree_leaves(solo[s].state)))
                for s in range(4))
            if not same:
                raise AssertionError("fabric fp32 fleet: a shard differs "
                                     "from its standalone engine")
            log(f"fabric fp32 fleet 4 x 8 (2L-768H fused, step_many of 20 "
                f"frames): every shard's state and outputs bitwise a "
                f"standalone 8-stream engine; {fl.graph_stats['replays']} "
                f"replays [{smi}]")
    finally:
        serving.DeltaStreamEngine = saved
    res["launches"] = launches
    return res


# -- phase 5f: the LM zoo's serving path -------------------------------------

LM_SLOTS = 4
LM_MAX_LEN = 256
LM_REQUESTS = 12
LM_NEW = 32            # new tokens a request, and decode steps of (b), (c)
LM_T = 128             # the prompt length of (b) and (c)
# prefill-then-decode logits against the teacher-forced forward of the same
# model on the card, relative RMS over a step's logits. One function over
# other matmul shapes (one row a decode step, 72 rows in the forward): on
# the CPU the two agree bitwise, but the card's matmuls pick kernels by
# shape and round a step apart here and there, and the layers pass that
# on. In bf16: measured 1.2e-2 over llama3.2-1b's 16 layers and 7.0e-3 over
# recurrentgemma's 3 (first run); a wrong cache position or carried state
# moves the logits by their own size (~1). In fp32 at 2 layers (phase 5f
# (d)) the check is TOL_F32. The seeded random RWKV6 is chaotic in depth
# (a 1e-6 change of its input moves its logits 1.7e-3 at 16 layers and
# 3.8e-2 at 24, D = 512 on the CPU; ROADMAP.md R20), so at 24 layers its
# check is printed, not held: 6.2e-2 in bf16 and 1.1e-3 in fp32 (runs 0
# and 1), rounding amplified, not a fault.
TOL_LM_BF16_RMS = 2.0 ** -3


def rel_rms(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).square().mean().sqrt()
                 / want.square().mean().sqrt())


def scan_row(kern, ref, args, nbytes, nops) -> dict:
    """A scan's times at one shape of the path (its recorded inputs): the
    kernel warm (graph replay) and with a cold L2, its plain version, and
    the bound: the larger of the bytes over HBM_BYTES_PER_S and the
    operations over FP32_OPS_PER_S."""
    row = {"ms": device_ms(lambda: kern(*args)),
           "cold_ms": device_ms_cold(lambda: kern(*args)),
           "eager_ms": eager_ms(lambda: kern(*args)),
           "plain_ms": device_ms(lambda: ref(*args), calls=2, reps=3),
           "library_ms": None, "bytes": nbytes, "ops": nops}
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * nops / FP32_OPS_PER_S
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return row


def lm_build(cfg, dev, base: dict):
    """The model's seeded weights drawn on the card (``init_lm``), the
    seconds it took and the peak bytes the init held above what the
    process held before (``base["bytes"]``, set here: the earlier phases'
    tensors); the peak memory counts from the end of the init on."""
    import torch
    from repro_torch.models.lm import init_lm
    gc.collect()          # an engine wrapped by counting() is a cycle
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base["bytes"] = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(SEED, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base["bytes"]
    torch.cuda.reset_peak_memory_stats()
    return params, init_s, init_peak


class RouteLog:
    """Within a ``with``: every MoE router call of the port (``moe._route``,
    which ``moe_apply`` reaches through the module, and
    ``moe_ep._route_local``, one a data shard of the expert-parallel
    dispatch) keeps its top-k choice in ``calls``. With ``replay`` (a list
    of ``[T, K]`` choices, one a call in order, from another run of the
    same tokens) the calls take those choices instead, their gates
    renormalized from their own probabilities, so the two runs' hidden
    states stay comparable; :meth:`flips` then counts the tokens whose own
    choice differed."""

    def __init__(self, replay=None):
        self.calls, self.replay, self.own = [], replay, []

    def __enter__(self):
        import torch
        from repro_torch.models import moe, moe_ep
        self.patched = [(moe, "_route", moe._route),
                        (moe_ep, "_route_local", moe_ep._route_local)]

        def wrap(orig, router_of):
            def route(*args):
                out = orig(*args)
                vals, idx = out[0], out[1]
                if self.replay is not None:
                    router_w, xt = router_of(args)
                    probs = torch.softmax(xt.float() @ router_w, dim=-1)
                    self.own.append((probs, idx))
                    idx = self.replay[len(self.calls)].to(idx.device)
                    vals = probs.gather(1, idx)
                    vals = vals / (vals.sum(-1, keepdim=True) + 1e-9)
                self.calls.append(idx)
                return (vals, idx) + tuple(out[2:])
            return route
        moe._route = wrap(moe._route, lambda a: (a[0]["router"], a[1]))
        moe_ep._route_local = wrap(moe_ep._route_local,
                                   lambda a: (a[0], a[1]))
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.patched:
            setattr(mod, name, orig)

    def flips(self) -> tuple:
        """Tokens whose own top-k set differed from the replayed one, and
        the largest gap, in their own probabilities, between such a
        token's k-th and (k+1)-th probability."""
        n, gap = 0, 0.0
        for (probs, own), used in zip(self.own, self.calls):
            bad = (own.sort(-1).values != used.sort(-1).values).any(-1)
            if bad.any():
                k = own.shape[1]
                p = probs[bad].sort(-1, descending=True).values
                n += int(bad.sum())
                gap = max(gap, float((p[:, k - 1] - p[:, k]).max()))
        return n, gap


def flips_allowed(what, n, gap, margin) -> str:
    """Hold a run's routing flips to ``margin``; their summary."""
    if n and gap > margin:
        raise AssertionError(f"{what}: {n} routing flips, one at a gap of "
                             f"{gap:.3e} (margin {margin:.1e})")
    return (f"{n} routing flips" + (f" (largest gap {gap:.3e}, margin "
                                    f"{margin:.1e})" if n else ""))


def no_drop(cfg):
    """``cfg`` with MoE capacity for every token (capacity factor E / K
    makes the capacity the token count), for checks that compare two
    token counts (prefill then decode against one forward): at the
    config's own factor each drops other assignments by design."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg,
                               capacity_factor=cfg.n_experts / cfg.top_k)


# an fp32 sum of 512 bf16 products is off by ~1e-7 to 1e-6 of its scale;
# a term rounded to bf16 moves by up to 2**-9 of itself (R21)
TOL_SCORES_F64 = 1e-5
SCORE_CACHE_ROWS = 32768   # the dry-run's decode_32k cache


def mla_scores_err(cfg, dev) -> float:
    """R21 on the card: ``absorbed_scores`` (the absorbed MLA decode's two
    score terms, one fp32-output matmul each) over bf16 ``q_eff``,
    ``q_rope`` and a bf16 cache of ``SCORE_CACHE_ROWS`` rows at ``cfg``'s
    widths and ``LM_SLOTS`` streams, against fp64 sums over the same
    values: the largest error over the largest |score|. Seeded inputs from
    a generator of their own (the other phases' inputs stay)."""
    import numpy as np
    import torch
    from repro_torch.models.mla import absorbed_scores
    rng = np.random.default_rng(SEED + 31)

    def bf16(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(
            np.float32)).to(dev, torch.bfloat16)

    q, q_rope = (bf16(LM_SLOTS, 1, cfg.n_heads, n)
                 for n in (cfg.kv_lora, cfg.qk_rope))
    c_kv, k_rope = (bf16(LM_SLOTS, SCORE_CACHE_ROWS, n)
                    for n in (cfg.kv_lora, cfg.qk_rope))
    got = absorbed_scores(q, q_rope, c_kv, k_rope)
    want = (torch.einsum("bshl,btl->bhst", q.double(), c_kv.double())
            + torch.einsum("bshr,btr->bhst", q_rope.double(),
                           k_rope.double()))
    if got.dtype != torch.float32 or got.shape != want.shape:
        raise AssertionError(f"absorbed_scores: {got.dtype} "
                             f"{tuple(got.shape)}, want fp32 "
                             f"{tuple(want.shape)}")
    return float((got.double() - want).abs().max() / want.abs().max())


def lm_forced(params, cfg, dev, rng, what, tol=TOL_LM_BF16_RMS,
              modality=None, margin=None) -> dict:
    """Prefill 64 tokens and decode 8 greedy ones, against the
    teacher-forced forward over the same 72 tokens: the largest relative
    RMS of a step's logits, held within ``tol`` (``None``: measured only).
    MoE runs at ``no_drop(cfg)``, and the forward takes the prefill's and
    the decode steps' expert choices; the tokens whose own choice differed
    (routing flips) are held to ``margin``. Returns ``{"err", "flips",
    "gap"}``."""
    import torch
    from repro_torch.models.lm import (init_lm_caches, lm_decode,
                                       lm_forward, lm_prefill)
    cfg = no_drop(cfg)
    mod = modality or {}
    b = LM_SLOTS
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (b, 64))).to(dev)
    caches = init_lm_caches(cfg, b, LM_MAX_LEN, dev)
    with torch.no_grad(), RouteLog() as seq_log:
        lg, caches = lm_prefill(params, cfg, toks, caches, **mod)
        got, seq = [lg], [toks]
        for _ in range(8):
            seq.append(torch.argmax(got[-1][:, -1:], dim=-1))
            lg, caches = lm_decode(params, cfg, seq[-1], caches)
            got.append(lg)
    # the prefill's and the decode steps' choices, in the forward's order
    layers = len(seq_log.calls) // 9
    seq_idx = [torch.cat([seq_log.calls[layer].reshape(b, 64, -1)] + [
        seq_log.calls[layers * (1 + i) + layer].reshape(b, 1, -1)
        for i in range(8)], dim=1).reshape(b * 72, -1)
        for layer in range(layers)]
    with torch.no_grad(), RouteLog(replay=seq_idx) as full_log:
        full, _ = lm_forward(params, cfg, torch.cat(seq, dim=1), **mod)
    n, gap = full_log.flips()
    flips_allowed(what, n, gap, margin if margin is not None else 0.0)
    errs = [rel_rms(g[:, 0], full[:, 63 + i]) for i, g in enumerate(got)]
    if (tol is not None and max(errs) > tol) or not all(
            torch.isfinite(g).all() for g in got):
        raise AssertionError(f"{what}: prefill/decode against the "
                             f"teacher-forced forward {errs}")
    return {"err": max(errs), "flips": n, "gap": gap}


# the warning of torch.cuda.set_sync_debug_mode("warn") at a host sync
# (its first use also warns that the mode is a prototype, "does not yet
# detect all synchronizing operations": not a sync)
SYNC_WARNING = "called a synchronizing CUDA operation"


def host_syncs(fn) -> int:
    """Host synchronisations (each a wait for the card) while ``fn()``
    runs, counted by ``torch.cuda.set_sync_debug_mode("warn")``."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(SYNC_WARNING in str(w.message) for w in caught)


def graph_pools() -> dict | None:
    """Bytes of the caching allocator's segments by CUDA graph private pool
    id (every graph alive), from ``torch.cuda.memory_snapshot()``; ``None``
    where the snapshot does not name the pools."""
    import torch
    segments = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in seg for seg in segments):
        return None
    pools = {}
    for seg in segments:
        pid = tuple(seg["segment_pool_id"])
        if pid != (0, 0):
            pools[pid] = pools.get(pid, 0) + seg["total_size"]
    return pools


def new_pool_bytes(before: dict | None) -> int | None:
    """Bytes of the private pools that appeared since ``before`` (a
    :func:`graph_pools`): the pools of the graphs captured since."""
    after = graph_pools()
    if before is None or after is None:
        return None
    return sum(v for pid, v in after.items() if pid not in before)


def graph_pool_bytes() -> int | None:
    """Bytes of the caching allocator's segments that belong to a CUDA
    graph's private pool (every graph alive); ``None`` where the snapshot
    does not name the pools."""
    pools = graph_pools()
    return None if pools is None else sum(pools.values())


def eager_twin(eng, which=("prefill", "decode")) -> dict:
    """Wrap ``eng.prefill`` and ``eng.decode_step`` (an ``LmEngine`` on the
    card: one graph replay a call), those named in ``which``: each call
    first copies the caches, the tokens and the modality inputs, and after
    the replay ``lm_prefill`` / ``lm_decode`` runs op by op on the copies;
    its logits and every cache leaf must equal the replay's bit for bit.
    Returns ``{"prefill": n, "decode": n}``, the calls so held, counted as
    they come."""
    import torch
    from repro_torch.models.common import tree_leaves as lm_leaves
    from repro_torch.models.common import tree_map
    from repro_torch.models.lm import lm_decode, lm_prefill
    held = {"prefill": 0, "decode": 0}
    fns = {"prefill": (eng.prefill, lm_prefill),
           "decode": (eng.decode_step, lm_decode)}

    def wrap(what):
        graph, eager = fns[what]

        def call(tokens, **mod):
            caches = tree_map(torch.clone, eng.caches)
            toks = torch.as_tensor(tokens).to(eng.device, torch.int64,
                                              copy=True)
            ins = {k: torch.as_tensor(v).to(eng.device, copy=True)
                   for k, v in mod.items()}
            out = graph(tokens, **mod)
            with torch.no_grad():
                want, caches = eager(eng.params, eng.cfg, toks, caches,
                                     **ins)
            if not (torch.equal(out, want) and all(
                    torch.equal(a, b) for a, b in zip(lm_leaves(eng.caches),
                                                      lm_leaves(caches)))):
                raise AssertionError(
                    f"{eng.cfg.name}: {what} {held[what]} "
                    f"{list(toks.shape)}: the replay differs from "
                    f"lm_{what} op by op on copies of its caches")
            held[what] += 1
            return out
        return call

    if "prefill" in which:
        eng.prefill = wrap("prefill")
    if "decode" in which:
        eng.decode_step = wrap("decode")
    return held


def record_waves(eng) -> list:
    """Wrap ``eng.prefill`` to keep each call's prompt length (a batcher's
    wave length); returns the list."""
    waves, prefill = [], eng.prefill

    def call(tokens, **mod):
        waves.append(tokens.shape[1])
        return prefill(tokens, **mod)

    eng.prefill = call
    return waves


def check_waves(what, eng, waves) -> str:
    """Hold an engine's prefill graphs to the prompt lengths it was given
    (one signature a length): one capture a distinct length, one replay a
    call, none evicted. Returns a summary."""
    from repro_torch.serve.engine import PREFILL_GRAPHS
    st = eng.prefill_stats
    distinct = len(set(waves))
    if (distinct > PREFILL_GRAPHS or st["captures"] != distinct
            or st["replays"] != len(waves) or st["evictions"]):
        raise AssertionError(f"{what}: prefill graphs {st} over waves of "
                             f"{waves}")
    held = eng.prefill_graphs()
    graphs = "; ".join(f"{sig[0][1]}: {capture_split(g)}"
                       for sig, g in held.items())
    return (f"{len(waves)} waves of {distinct} lengths "
            f"{sorted(set(waves))}: {st['captures']} prefill captures, "
            f"{st['replays']} replays (a length's capture: {graphs}; "
            f"{pools_held(held)})")


def capture_split(g: dict) -> str:
    """A prefill graph's capture ms (``LmEngine.prefill_graphs()``): in
    all, and its warm-up, body and end."""
    return (f"{1e3 * g['capture_s']:.1f} ms (warm-up "
            f"{1e3 * g['warmup_s']:.1f}, body {1e3 * g['body_s']:.1f}, end "
            f"{1e3 * g['end_s']:.1f})")


def pools_held(held: dict) -> str:
    """The pools of the prefill graphs held and their MiB."""
    pools = {g["pool"]: g["pool_bytes"] for g in held.values()}
    return f"{len(held)} graphs in {len(pools)} pool(s) of " + ", ".join(
        "not measured" if b is None else f"{b / 2 ** 20:.1f} MiB"
        for b in pools.values())


def bound_sweep(params, cfg, dev, rng, smi) -> dict:
    """``PREFILL_GRAPHS + 1`` prompt lengths, 1 to ``PREFILL_GRAPHS + 1``,
    swept three times in that order through one ``LmEngine(batch=2)`` on
    the card, each prefill held bitwise against its eager twin. The first
    sweep captures each length and evicts the least recently used graph
    once; the later ones evict each graph just before its length comes
    back, so every call captures. After each sweep the engine holds
    ``PREFILL_GRAPHS`` graphs in one pool, the evicted lengths not among
    them; an evicted graph is freed: the third sweep repeats the second's
    evictions and captures, so its caching allocator's reserved bytes are
    not above the second's, and the driver's used bytes not above by more
    than one 2 MiB page (the second may grow the pool over the first,
    whose captures met no eviction). Returns the sweeps' counts and
    bytes."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import PREFILL_GRAPHS, LmEngine
    n = PREFILL_GRAPHS
    eng = LmEngine(params, cfg, 2, n + 8, device=dev)
    held = eager_twin(eng, ("prefill",))
    lengths = list(range(1, n + 2))
    toks = {t: torch.from_numpy(rng.integers(1, cfg.vocab, (2, t)))
            for t in lengths}
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    out = {0: {"reserved": torch.cuda.memory_reserved(),
               "used": total - free}}
    ends = []
    for k in (1, 2, 3):
        for t in lengths:
            eng.prefill(toks[t])
            ends.append(next(reversed(eng.prefill_graphs().values()))[
                "end_s"])
        torch.cuda.synchronize()
        graphs = eng.prefill_graphs()
        free, total = torch.cuda.mem_get_info()
        out[k] = {"stats": dict(eng.prefill_stats),
                  "held": [sig[0][1] for sig in graphs],
                  "pools": {g["pool"]: g["pool_bytes"]
                            for g in graphs.values()},
                  "reserved": torch.cuda.memory_reserved(),
                  "used": total - free,
                  "split_ms": {key: 1e3 * float(sum(
                      g[key] for g in graphs.values()) / len(graphs))
                      for key in ("warmup_s", "body_s", "end_s")}}
    s1, s3 = out[1]["stats"], out[3]["stats"]
    want = {k: {"captures": k * (n + 1), "replays": k * (n + 1),
                "evictions": 1 + (k - 1) * (n + 1), "held": n}
            for k in (1, 2, 3)}
    if (any(out[k]["stats"][key] != v for k in want
            for key, v in want[k].items())
            or any(out[k]["held"] != lengths[1:] or len(out[k]["pools"]) != 1
                   for k in want)
            or held["prefill"] != 3 * (n + 1)
            or out[3]["reserved"] > out[2]["reserved"]
            or out[3]["used"] > out[2]["used"] + 2 ** 21):
        raise AssertionError(f"{cfg.name} prefill bound {n}: sweeps {out}, "
                             f"{held} held against their eager twins")
    pools = [next(iter(out[k]["pools"].values())) for k in want]
    # what the driver holds for a graph beside the caching allocator
    outside = ((out[1]["used"] - out[0]["used"])
               - (out[1]["reserved"] - out[0]["reserved"])) / n
    out["outside_mib_a_graph"] = outside / 2 ** 20
    # a capture's end (the instantiation) with few graphs held and with
    # the bound's worth: the median of the first sweep's first and last 8
    out["end_ms"] = [1e3 * float(np.median(ends[:8])),
                     1e3 * float(np.median(ends[n - 7:n + 1]))]
    log(f"lm {cfg.name} ({cfg.dtype}, full width, {cfg.n_layers} layers) "
        f"prefill bound: lengths 1-{n + 1} swept three times through one "
        f"engine (PREFILL_GRAPHS = {n}), every call bitwise its eager twin: "
        f"{s1['captures']} captures and {s1['evictions']} eviction, then "
        f"{s3['captures'] - s1['captures']} captures and "
        f"{s3['evictions'] - s1['evictions']} evictions (every call a "
        f"capture); {n} graphs held after each, lengths 2-{n + 1}, in one "
        f"pool of "
        + ("not measured" if None in pools
           else " / ".join(f"{b / 2 ** 20:.2f}" for b in pools) + " MiB")
        + "; caching allocator reserved "
        + " / ".join(str(out[k]["reserved"]) for k in want)
        + " B, the driver's used "
        + " / ".join(str(out[k]["used"]) for k in want)
        + " B after each sweep (the "
        f"driver's beside the allocator {out['outside_mib_a_graph']:.3f} "
        f"MiB a graph held); a capture's end, median of the first sweep's "
        f"first 8 / last 8: {out['end_ms'][0]:.2f} / {out['end_ms'][1]:.2f} "
        f"ms; a held "
        f"graph's capture, mean ms: warm-up "
        f"{out[3]['split_ms']['warmup_s']:.2f}, body "
        f"{out[3]['split_ms']['body_s']:.2f}, end "
        f"{out[3]['split_ms']['end_s']:.2f} [{smi}]")
    del eng
    return out


def drains(make_engine, prompts, what) -> list:
    """Three ``ContinuousBatcher`` drains of ``prompts``, ``LM_NEW`` new
    tokens each: on a fresh engine whose prefills are held against their
    eager twins, on a second fresh engine (its prefill captures in the
    wall) and on that engine again (its graphs replayed). Each drain's
    waves are held to its engine's captures (``check_waves``) and the
    three give the same tokens. Returns ``(outputs, wall s, summary)`` a
    drain."""
    import torch
    from repro_torch.serve.scheduler import ContinuousBatcher
    twin_eng, eng = make_engine(), make_engine()
    held = eager_twin(twin_eng, ("prefill",))
    waves = {id(twin_eng): record_waves(twin_eng), id(eng): record_waves(eng)}
    runs = []
    for e in (twin_eng, eng, eng):
        cb = ContinuousBatcher(e)
        for p in prompts:
            cb.submit(p, max_new_tokens=LM_NEW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = cb.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append([{r.uid: r.output for r in done}, wall,
                     check_waves(f"{what} drain {len(runs)}", e,
                                 waves[id(e)])])
    outs = runs[0][0]
    if (held["prefill"] != len(waves[id(twin_eng)])
            or any(r[0] != outs for r in runs)
            or sorted(outs) != list(range(len(prompts)))
            or any(len(o) != LM_NEW for o in outs.values())):
        raise AssertionError(f"{what} drains: {held} held, {len(outs)} "
                             f"requests, the same tokens "
                             f"{[r[0] == outs for r in runs]}")
    return runs


def lm_timed(name, cfg, params, init_s, t_prompt, dev, rng, base, smi,
             extra="", modality=None) -> dict:
    """The engine's graphs at [4, t_prompt]: the first prefill captures its
    graph (its call timed, ``capture_call_ms``), then three more and
    ``generate_greedy``'s, each timed between synchronisations (graph
    ``prefill_ms``: the median of the four replays) and held bitwise
    against its eager twin (``eager_twin``, outside the clock); the eager
    ``lm_prefill`` on copies of the caches and the same inputs, three times
    (``eager_prefill_ms``: median); decode ms a step (each synchronised)
    over ``generate_greedy``'s LM_NEW steps, each held against its eager
    twin; one profiled prefill replay and 5 profiled decode steps
    (kernels, busy, idle share, replays a call), host syncs a prefill
    replay and a decode step (none), both graphs' capture ms (the
    prefill's split into warm-up, body and end) and pools (the decode
    graph's private, the prefill graphs' shared), peak memory;
    ``"tokens"``: the greedy tokens."""
    import numpy as np
    import torch
    from repro_torch.models.common import count_params
    from repro_torch.models.common import tree_leaves as lm_leaves
    from repro_torch.models.common import tree_map
    from repro_torch.models.lm import lm_prefill
    from repro_torch.serve.engine import LmEngine
    pools = graph_pool_bytes()
    eng = LmEngine(params, cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
    torch.cuda.synchronize()
    pool_mib = (None if pools is None
                else (graph_pool_bytes() - pools) / 2 ** 20)
    cache_mib = sum(t.numel() * t.element_size()
                    for t in lm_leaves(eng.caches)) / 2 ** 20
    toks = rng.integers(1, cfg.vocab, (LM_SLOTS, t_prompt))
    mod = modality or {}
    pre, dec = [], []

    def timing(fn, into):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            into.append(1e3 * (time.perf_counter() - t0))
            return out
        return call

    prefill, decode = eng.prefill, eng.decode_step
    eng.prefill, eng.decode_step = timing(prefill, pre), timing(decode, dec)
    held = eager_twin(eng)
    for _ in range(4):
        eng.prefill(toks, **mod)
    new = eng.generate_greedy(toks, LM_NEW, **mod)
    eng.prefill, eng.decode_step = prefill, decode
    if held != {"prefill": 5, "decode": LM_NEW}:
        raise AssertionError(f"{name}: {held} calls held against their "
                             f"eager twin, want 5 prefills, {LM_NEW} steps")
    eager = []
    for _ in range(3):
        caches = tree_map(torch.clone, eng.caches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            lm_prefill(params, cfg, torch.as_tensor(toks, device=dev),
                       caches, **mod)
        torch.cuda.synchronize()
        eager.append(1e3 * (time.perf_counter() - t0))
        del caches
    (sig, graph), = eng.prefill_graphs().items()
    replays = eng.prefill_stats["replays"]
    pre_prof = engine_profile(lambda: eng.prefill(toks, **mod), 1)
    pre_prof["replays_per_call"] = eng.prefill_stats["replays"] - replays
    pre_prof["syncs_per_call"] = host_syncs(lambda: eng.prefill(toks, **mod))
    cur = new[:, -1:]
    replays = eng.decode_stats["replays"]
    prof = engine_profile(lambda: [eng.decode_step(cur)
                                   for _ in range(5)], 5)
    prof["replays_per_step"] = (eng.decode_stats["replays"] - replays) / 5
    prof["syncs_per_step"] = host_syncs(lambda: eng.decode_step(cur))
    if (prof["replays_per_step"] != 1 or eng.decode_stats["captures"] != 1
            or pre_prof["replays_per_call"] != 1
            or eng.prefill_stats["captures"] != 1
            or prof["syncs_per_step"] or pre_prof["syncs_per_call"]):
        raise AssertionError(
            f"{name}: decode graph {eng.decode_stats}, {prof['replays_per_step']}"
            f" replays and {prof['syncs_per_step']} host syncs a step; "
            f"prefill graphs {eng.prefill_stats}, "
            f"{pre_prof['replays_per_call']} replays and "
            f"{pre_prof['syncs_per_call']} host syncs a call")
    pre_pool = graph["pool_bytes"]
    out = {"init_s": init_s, "prefill_ms": float(np.median(pre[1:])),
           "prefill_each_ms": pre,
           "capture_call_ms": pre[0],
           "eager_prefill_ms": float(np.median(eager)),
           "eager_prefill_each_ms": eager,
           "prefill_capture_ms": 1e3 * graph["capture_s"],
           "prefill_capture_split_ms": {
               k: 1e3 * graph[k] for k in ("warmup_s", "body_s", "end_s")},
           "prefill_pool_mib": (None if pre_pool is None
                                else pre_pool / 2 ** 20),
           "prefill_profile": pre_prof,
           "tokens": new,
           "decode_p50_ms": float(np.percentile(dec, 50)),
           "decode_p95_ms": float(np.percentile(dec, 95)),
           "profile": prof, "params": count_params(params),
           "capture_ms": 1e3 * eng.decode_stats["capture_s"],
           "pool_mib": pool_mib, "cache_mib": cache_mib,
           "peak_gib": (torch.cuda.max_memory_allocated()
                        - base["bytes"]) / 2 ** 30}
    log(f"time lm {name}: {out['params']} parameters, init "
        f"{init_s:.3f} s; prefill [{LM_SLOTS}, {t_prompt}] one graph "
        f"replay {out['prefill_ms']:.3f} ms (each "
        + ", ".join(f"{v:.3f}" for v in pre[1:])
        + f"; the capturing call {pre[0]:.3f} ms), eager lm_prefill "
        f"{out['eager_prefill_ms']:.3f} ms (each "
        + ", ".join(f"{v:.3f}" for v in eager)
        + f"), every replay bitwise lm_prefill op by op on copies of its "
        f"caches; the prefill graph's capture {capture_split(graph)}, the "
        f"prefill graphs' pool "
        + ("not measured" if pre_pool is None
           else f"{out['prefill_pool_mib']:.2f} MiB")
        + f"; profiled prefill: {pre_prof['replays_per_call']} replay, "
        f"{pre_prof['kernels_per_step']:.0f} kernels, device busy "
        f"{pre_prof['device_busy_us_per_step']:.1f} us, idle share "
        f"{idle_share(pre_prof)} (wall "
        f"{pre_prof['wall_us_per_step']:.1f} us under the profiler), "
        f"{pre_prof['syncs_per_call']} host syncs a call; decode a step at "
        f"B={LM_SLOTS} p50 "
        f"{out['decode_p50_ms']:.3f} ms, p95 {out['decode_p95_ms']:.3f} "
        f"ms over {LM_NEW} steps, each bitwise lm_decode op by op on "
        f"copies of its caches; profiled decode step: "
        f"{prof['replays_per_step']:.0f} replay, "
        f"{prof['kernels_per_step']:.1f} kernels, device busy "
        f"{prof['device_busy_us_per_step']:.1f} us, idle share "
        f"{idle_share(prof)} (wall {prof['wall_us_per_step']:.1f} "
        f"us under the profiler), {prof['syncs_per_step']} host syncs a "
        f"step; the decode graph's capture {out['capture_ms']:.1f} ms, its "
        f"private pool "
        + ("not measured" if pool_mib is None else f"{pool_mib:.2f} MiB")
        + f" (the caches {cache_mib:.2f} MiB); peak memory after the init, "
        f"above the "
        f"{base['bytes']} B held before the model, {out['peak_gib']:.3f} "
        f"GiB{extra} [{smi}]")
    return out


def idle_share(prof: dict) -> str:
    """``engine_profile``'s idle share as printed: "not measured" where the
    profiler session recorded no device event (seen once, on one of
    phase 5g's decode sessions)."""
    share = prof["idle_share"]
    return ("not measured (no device event recorded)" if share is None
            else f"{share:.4f}")


def lm_phase(dev, smi) -> dict:
    """Phase 5f: the LM zoo's serving path on the card, from seeded random
    weights drawn on the card (``init_lm``). Every ``LmEngine`` prefill and
    decode step is one replay of a CUDA graph. (a) llama3.2-1b at full size
    in bf16: an ``LmEngine(batch=4, max_len=256)`` and a
    ``ContinuousBatcher`` drain 12 prompts of 16-96 tokens, 32 new tokens
    each, twice with the same tokens (the first run's prefills held
    bitwise against their eager twins), one prefill capture a distinct
    wave length; a staggered admission leaves the live request's tokens
    those of its solo run; prefill-then-decode logits within
    ``TOL_LM_BF16_RMS`` of the teacher-forced forward. (b) rwkv6-1.6b at
    full size in bf16: one prefill of 4 prompts of 128 tokens (its
    capture: row 9b, ``rwkv6_scan_bf16``, launched 24 times by the warm-up
    and 24 by the replay), then ``generate_greedy`` on them for 32 steps,
    row 9b launched exactly 24 times by the prefill's replay and by each
    decode step and no other kernel, each launch of the prefill and of the
    first decode step held against the plain version on the card at the
    inputs the path gave it (recorded on the replays' eager twins, which
    the replays equal bitwise). (c) recurrentgemma-9b at full size, all 38
    layers (26 RG-LRU): the same, ``rglru_scan`` launched 26 times by the
    prefill (52 by the capturing call) and never by a decode step, each
    launch bitwise its plain version. (d) llama3.2-1b and rwkv6-1.6b in
    fp32 at full width and 2 layers: the prefill's and the first decode
    step's logits and the caches on the card within ``TOL_LM`` of the same
    weights on the CPU, and their prefill-then-decode logits within
    ``TOL_F32`` (relative RMS) of their teacher-forced forward. (e)
    rwkv6-1.6b's fp32 2-layer prefill under ``REPRO_RWKV_CHUNKED=1``
    against the same prefill through row 9, and an engine's prefill graph
    captured again under the other route, each replay bitwise its eager
    twin; ``bound_sweep`` on that model (``PREFILL_GRAPHS + 1`` lengths,
    three times, the scan's shared memory setting of the device made
    again from the first length, as in a new process). The bf16
    prefill-then-decode logits of (a) and (c) are held within
    ``TOL_LM_BF16_RMS`` of their teacher-forced forward; (b)'s are
    measured (R20). Times per model (``lm_timed``): init, prefill at
    T = 128 (graph and eager), the prefill graph's capture (warm-up, body,
    end) and the prefill graphs' pool, a profiled prefill, decode a step (p50 / p95), kernels a decode step and
    idle share, peak memory after the init; the second drain's tokens a
    second; rows 8 and 9b (and 9's fp32 instance) at the path's shapes, on
    the inputs the path gave them. Returns the launches and errors of the
    kernels, their time rows, the archs served at full size
    (``"served"``) and each model's times."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.rglru_scan import (rglru_scan,
                                                rglru_scan_batched_ref)
    from repro_torch.kernels import rwkv6_scan as wkv_mod
    from repro_torch.kernels.rwkv6_scan import (rwkv6_scan,
                                                rwkv6_scan_batched_ref)
    from repro_torch.models.common import tree_map
    from repro_torch.models.common import tree_leaves as lm_leaves
    from repro_torch.models.blocks import make_schedule
    from repro_torch.models.lm import init_lm_caches, lm_decode, lm_prefill
    from repro_torch.serve.engine import LmEngine
    from repro_torch.serve.scheduler import ContinuousBatcher

    rng = np.random.default_rng(SEED)
    res = {"launches": {}, "max_err": {}, "rows": {}, "served": [],
           "times": {}}
    wkv16, wkv32, lru = (ops.RWKV6_SCAN_BF16, ops.RWKV6_SCAN_F32,
                         ops.RGLRU_SCAN_F32)

    base = {}

    def build(cfg):
        return lm_build(cfg, dev, base)[:2]

    def forced(params, cfg, what, tol=TOL_LM_BF16_RMS):
        return lm_forced(params, cfg, dev, rng, what, tol)["err"]

    def counting(eng):
        """Wrap the engine's prefill and decode_step to keep the launches
        each call made."""
        per_call = []

        def wrap(fn):
            def call(tokens):
                before = ops.launch_counts()
                out = fn(tokens)
                after = ops.launch_counts()
                per_call.append({k: v - before[k] for k, v in after.items()
                                 if v != before[k]})
                return out
            return call
        eng.prefill, eng.decode_step = wrap(eng.prefill), wrap(
            eng.decode_step)
        return per_call

    def recording(name, keep):
        """Replace ``ops.<name>`` (what the blocks call) by a wrapper that
        keeps the inputs and outputs of the calls ``keep`` selects."""
        orig, kept = getattr(ops, name), []

        def call(*args):
            out = orig(*args)
            if keep(args, len(kept)):
                kept.append(([None if a is None else a.clone() for a in args],
                             [o.clone() for o in out]))
            return out
        setattr(ops, name, call)
        return orig, kept

    def served(arch, cfg, out):
        del out["tokens"]
        res["times"][arch] = out
        res["served"].append(arch)
        return out

    def scan_path(params, cfg, name, keep, toks):
        """The engine's prefill at ``toks`` captured (a first call, its
        launches counted), then ``generate_greedy`` on the same prompts,
        each call one replay held bitwise against its eager twin, with
        ``ops.<name>`` recording the calls ``keep`` selects (those of the
        twins). Returns the launches of each call and the records."""
        eng = LmEngine(params, cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
        per_call = counting(eng)
        held = eager_twin(eng)
        eng.prefill(toks)
        orig, kept = recording(name, keep)
        try:
            new = eng.generate_greedy(toks, LM_NEW)
            torch.cuda.synchronize()
        finally:
            setattr(ops, name, orig)
        if held != {"prefill": 2, "decode": LM_NEW} or (
                eng.prefill_stats["captures"], eng.prefill_stats["replays"],
                eng.decode_stats["captures"]) != (1, 2, 1):
            raise AssertionError(f"{cfg.name}: {held} held against their "
                                 f"eager twins; {eng.prefill_stats}, "
                                 f"{eng.decode_stats}")
        if new.shape != (LM_SLOTS, LM_NEW) or not (0 <= new).all() or not (
                new < cfg.vocab).all():
            raise AssertionError(f"{cfg.name} tokens {new.shape}")
        return per_call, kept

    # (a) llama3.2-1b, full size, bf16
    cfg = get_config("llama3.2-1b")
    params, init_s = build(cfg)
    prompts = [rng.integers(1, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, 97, LM_REQUESTS)]

    ops.reset_launch_counts()
    (outs, wall, waves1), (outs2, wall2, waves2), (outs3, wall3, waves3) = (
        drains(lambda: LmEngine(params, cfg, LM_SLOTS, LM_MAX_LEN,
                                device=dev), prompts, "llama3.2-1b"))
    n = {k: v for k, v in ops.launch_counts().items() if v}
    if n:
        raise AssertionError(f"llama3.2-1b drain: launches {n} (want none)")

    def staggered(stagger):
        cb = ContinuousBatcher(LmEngine(params, cfg, LM_SLOTS, LM_MAX_LEN,
                                        device=dev))
        cb.submit(prompts[0], max_new_tokens=LM_NEW)
        done, submitted = [], not stagger
        while cb.queue or any(cb.slots):
            done += cb.step()
            if (not submitted and cb.slots[0] is not None
                    and len(cb.slots[0].output) >= 3):
                for p in prompts[1:4]:
                    cb.submit(p, max_new_tokens=8)
                submitted = True
        return {r.uid: r.output for r in done}

    solo, mixed = staggered(False), staggered(True)
    if mixed[0] != solo[0] or len(mixed) != 4:
        raise AssertionError("llama3.2-1b: a staggered admission changed the "
                             "live request's tokens")
    err_a = forced(params, cfg, "llama3.2-1b")
    n_tok = LM_REQUESTS * LM_NEW
    log(f"lm llama3.2-1b (bf16, full size) batcher: {LM_REQUESTS} prompts "
        f"of {min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
        f"{LM_NEW} new each, {LM_SLOTS} slots: {n_tok} tokens in "
        f"{wall3:.3f} s on a warm engine ({n_tok / wall3:.1f} tokens/s; on "
        f"a fresh one, its prefill captures included, {wall2:.3f} s, "
        f"{n_tok / wall2:.1f} tokens/s; the first run, its captures and its "
        f"prefills' eager twins included, {wall:.3f} s; the same tokens in "
        f"all three, every prefill of the first bitwise its eager twin); "
        f"{waves1}; fresh engine {waves2}, then warm {waves3}; staggered "
        f"admission: the live request's tokens equal its solo run's; "
        f"prefill-then-decode "
        f"against the teacher-forced forward: relative RMS {err_a:.3e} "
        f"(within {TOL_LM_BF16_RMS}); no hand-written kernel launched "
        f"[{smi}]")
    served("llama3.2-1b", cfg, lm_timed(
        "llama3.2-1b", cfg, params, init_s, LM_T, dev, rng, base, smi,
        f"; drain {n_tok / wall3:.1f} tokens/s warm, {n_tok / wall2:.1f} "
        f"fresh"))
    res["times"]["llama3.2-1b"].update(tokens_per_s=n_tok / wall3,
                                       fresh_tokens_per_s=n_tok / wall2)
    del params

    # (b) rwkv6-1.6b, full size, bf16
    cfg = get_config("rwkv6-1.6b")
    params, init_s = build(cfg)
    toks = rng.integers(1, cfg.vocab, (LM_SLOTS, LM_T))
    per_call, kept = scan_path(params, cfg, "rwkv6_scan",
                               lambda args, k: k < 2 * cfg.n_layers, toks)
    want = {wkv16.name: cfg.n_layers}
    if (len(per_call) != 2 + LM_NEW
            or per_call[0] != {wkv16.name: 2 * cfg.n_layers}
            or any(c != want for c in per_call[1:])):
        raise AssertionError(f"rwkv6-1.6b: launches a call {per_call}, want "
                             f"{2 * cfg.n_layers} for the capturing prefill "
                             f"then {want} each of {1 + LM_NEW}")
    res["launches"][wkv16.name] = sum(c[wkv16.name] for c in per_call)
    errs = {}
    for args, out in kept:
        t = args[0].shape[2]
        want_out = rwkv6_scan_batched_ref(*args)
        errs[t] = max([errs.get(t, 0.0)] + [
            scaled_err(a, b) for a, b in zip(out, want_out)])
        res["max_err"][wkv16.name] = max(
            res["max_err"].get(wkv16.name, 0.0),
            max(float((a - b).abs().max()) for a, b in zip(out, want_out)))
    if (sorted(errs) != [1, LM_T] or max(errs.values()) > TOL_F32
            or not all(a[0].dtype == torch.bfloat16 for a, _ in kept)):
        raise AssertionError(f"rwkv6_scan_bf16 on the path against its "
                             f"plain version: scaled {errs}")
    err_b = forced(params, cfg, "rwkv6-1.6b", None)
    log(f"lm rwkv6-1.6b (bf16, full size): a prefill of {LM_SLOTS} "
        f"prompts of {LM_T} (its capture: {wkv16.name} launched "
        f"{cfg.n_layers} times by the warm-up and {cfg.n_layers} by the "
        f"replay), then generate_greedy on them, {LM_NEW} steps; "
        f"{wkv16.name} launched {cfg.n_layers} times by the prefill's "
        f"replay and by each decode step's "
        f"({res['launches'][wkv16.name]} in all) and no other kernel; the "
        f"{len(kept)} launches of the prefill [{LM_SLOTS}, 32, {LM_T}, 64] "
        f"and the first decode step [{LM_SLOTS}, 32, 1, 64] (each call one "
        f"replay, bitwise its eager twin, whose launches were recorded) "
        f"against the plain version on the card: scaled {errs[LM_T]:.3e} / "
        f"{errs[1]:.3e} (within {TOL_F32}); prefill-then-decode against the "
        f"teacher-forced forward: relative RMS {err_b:.3e} (not held: the "
        f"random 24-layer RWKV6 amplifies rounding, R20) [{smi}]")
    served("rwkv6-1.6b", cfg, lm_timed("rwkv6-1.6b", cfg, params, init_s,
                                       LM_T, dev, rng, base, smi))
    # rows 9b and 9 at the path's shapes, on the inputs the path gave them
    prefill_args = next(a for a, _ in kept if a[0].shape[2] == LM_T)
    decode_args = next(a for a, _ in kept if a[0].shape[2] == 1)
    for kinfo, cast in ((wkv16, None), (wkv32, torch.float32)):
        shapes = {}
        for key, args in (("t1", decode_args), ("t128", prefill_args)):
            if cast is not None:
                args = [a.to(cast) for a in args[:3]] + list(args[3:])
            b, h, t, d = args[0].shape
            in_bytes = args[0].element_size()
            nbytes = (3 * in_bytes + 8) * b * h * t * d + 4 * h * d + (
                2 * 4 * b * h * d * d)
            shapes[key] = scan_row(rwkv6_scan, rwkv6_scan_batched_ref, args,
                                   nbytes, 7 * b * h * t * d * d)
            r = shapes[key]
            log(f"time {kinfo.name} [{b}, {h}, {t}, {d}] (the path's "
                f"{'decode' if t == 1 else 'prefill'} inputs"
                f"{'' if cast is None else ', r k v cast to fp32'}): kernel "
                f"{r['ms']:.5f} ms warm, {r['cold_ms']:.5f} ms with a cold "
                f"L2 ({r['eager_ms']:.4f} ms launched from Python), plain "
                f"{r['plain_ms']:.5f} ms, bound {r['bound_ms']:.6f} ms "
                f"({r['bytes']} B, {r['ops']} operations, {r['bound_by']}) "
                f"[{smi}]")
        res["rows"][kinfo.name] = shapes
    del params, kept, prefill_args, decode_args

    # (c) recurrentgemma-9b at full size, all 38 layers
    cfg = get_config("recurrentgemma-9b")
    n_lru = sum(pattern.count("rglru") * count
                for pattern, count in make_schedule(cfg))
    params, init_s = build(cfg)
    toks = rng.integers(1, cfg.vocab, (LM_SLOTS, LM_T))
    per_call, kept = scan_path(params, cfg, "rglru_scan",
                               lambda args, k: True, toks)
    if (per_call[0] != {lru.name: 2 * n_lru} or per_call[1] != {
            lru.name: n_lru} or any(per_call[2:])
            or len(per_call) != 2 + LM_NEW or len(kept) != n_lru):
        raise AssertionError(f"recurrentgemma-9b: launches a call {per_call}"
                             f", want {2 * n_lru} for the capturing prefill, "
                             f"{n_lru} for the next, then nothing")
    res["launches"][lru.name] = per_call[0][lru.name] + n_lru
    same = True
    for args, out in kept:
        want_out = rglru_scan_batched_ref(*args)
        same = same and all(torch.equal(a, b) for a, b in zip(out, want_out))
    if not same or tuple(kept[0][0][0].shape) != (LM_SLOTS, LM_T,
                                                    cfg.d_model):
        raise AssertionError("rglru_scan on the path differs from its plain "
                             "version")
    res["max_err"][lru.name] = 0.0
    err_c = forced(params, cfg, "recurrentgemma-9b")
    log(f"lm recurrentgemma-9b (bf16, full size: {cfg.n_layers} layers, "
        f"{n_lru} of them RG-LRU, D={cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} kv head, window {cfg.attn_window}): a prefill "
        f"[{LM_SLOTS}, {LM_T}] (its capture: {lru.name} launched {n_lru} "
        f"times by the warm-up and {n_lru} by the replay), then "
        f"generate_greedy on the same prompts, {LM_NEW} steps: {lru.name} "
        f"launched {n_lru} times by the prefill's replay and 0 by each "
        f"decode step, no other kernel; all {len(kept)} launches "
        f"[{LM_SLOTS}, {LM_T}, {cfg.d_model}] (recorded on the prefill's "
        f"eager twin, which the replay equals bitwise) bitwise their plain "
        f"version on the card; prefill-then-decode against the "
        f"teacher-forced forward: relative RMS {err_c:.3e} (within "
        f"{TOL_LM_BF16_RMS}) [{smi}]")
    served("recurrentgemma-9b", cfg, lm_timed(
        "recurrentgemma-9b", cfg, params, init_s, LM_T, dev, rng, base,
        smi))
    args = kept[0][0]
    b, t, w = args[0].shape
    res["rows"][lru.name] = {"t128": scan_row(
        rglru_scan, rglru_scan_batched_ref, args,
        4 * (3 * b * t * w + 2 * b * w), 6 * b * t * w)}
    r = res["rows"][lru.name]["t128"]
    log(f"time {lru.name} [{b}, {t}, {w}] (the path's prefill inputs): "
        f"kernel {r['ms']:.5f} ms warm, {r['cold_ms']:.5f} ms with a cold L2 "
        f"({r['eager_ms']:.4f} ms launched from Python), plain "
        f"{r['plain_ms']:.5f} ms, bound {r['bound_ms']:.6f} ms ({r['bytes']} "
        f"B, {r['bound_by']}) [{smi}]")
    del params, kept, args

    # (d) fp32 at full width, 2 layers: the card against the CPU, and the
    # prefill-then-decode logits against the teacher-forced forward
    res["launches"][wkv32.name] = 0
    for arch in ("llama3.2-1b", "rwkv6-1.6b"):
        cfg = dataclasses.replace(get_config(arch), n_layers=2,
                                  dtype="float32")
        params, _ = build(cfg)
        cpu = torch.device("cpu")
        cpu_params = tree_map(lambda x: x.to(cpu), params)
        toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 32)))
        ops.reset_launch_counts()
        with torch.no_grad():
            caches = init_lm_caches(cfg, 2, 64, dev)
            lg_p, caches = lm_prefill(params, cfg, toks.to(dev), caches)
            cur = torch.argmax(lg_p[:, -1:], dim=-1)
            lg_d, caches = lm_decode(params, cfg, cur, caches)
            torch.cuda.synchronize()
            n = {k: v for k, v in ops.launch_counts().items() if v}
            c_caches = init_lm_caches(cfg, 2, 64, cpu)
            c_p, c_caches = lm_prefill(cpu_params, cfg, toks, c_caches)
            c_d, c_caches = lm_decode(cpu_params, cfg, cur.cpu(), c_caches)
        want_n = {wkv32.name: 4} if arch.startswith("rwkv") else {}
        err = max([scaled_err(lg_p, c_p), scaled_err(lg_d, c_d)] + [
            scaled_err(a.float(), b.float()) for a, b in zip(
                lm_leaves(caches), lm_leaves(c_caches))])
        if err > TOL_LM or n != want_n:
            raise AssertionError(f"{arch} fp32 2 layers: card against CPU "
                                 f"{err:.3e}; launches {n}, want {want_n}")
        res["launches"][wkv32.name] += n.get(wkv32.name, 0)
        err_f = forced(params, cfg, f"{arch} fp32", TOL_F32)
        log(f"lm {arch} (fp32, full width, 2 layers) card against CPU: "
            f"prefill [2, 32] and first decode logits and every cache leaf "
            f"within {err:.3e} of max(1, |CPU|) (tolerance {TOL_LM}); "
            f"launches {n}; on the card, prefill-then-decode against the "
            f"teacher-forced forward: relative RMS {err_f:.3e} (within "
            f"{TOL_F32}) [{smi}]")
        del params, cpu_params, caches, c_caches

    # (e) the chunk-parallel route: rwkv6-1.6b's fp32 2-layer prefill
    # [2, 32] under REPRO_RWKV_CHUNKED=1 (ops.rwkv6_chunked, plain
    # PyTorch, no kernel) against the same prefill through row 9; then an
    # engine's prefill graph under each route: the route is part of the
    # graph's signature, so the second captures a graph of its own
    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), n_layers=2,
                              dtype="float32")
    params, _ = build(cfg)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 32))).to(dev)
    with torch.no_grad():
        ops.reset_launch_counts()
        lg_k, caches_k = lm_prefill(params, cfg, toks,
                                    init_lm_caches(cfg, 2, 64, dev))
        n_k = {k: v for k, v in ops.launch_counts().items() if v}
        ops.reset_launch_counts()
        with env_var("REPRO_RWKV_CHUNKED", "1"):
            lg_c, caches_c = lm_prefill(params, cfg, toks,
                                        init_lm_caches(cfg, 2, 64, dev))
        torch.cuda.synchronize()
        n_c = {k: v for k, v in ops.launch_counts().items() if v}
    err = max([scaled_err(lg_c, lg_k)] + [
        scaled_err(a.float(), b.float()) for a, b in zip(
            lm_leaves(caches_c), lm_leaves(caches_k))])
    if err > TOL_LM or n_k != {wkv32.name: 2} or n_c:
        raise AssertionError(f"rwkv6 chunked prefill: against row 9 "
                             f"{err:.3e}; launches {n_c} (row 9's {n_k})")
    res["launches"][wkv32.name] += n_k[wkv32.name]
    eng = LmEngine(params, cfg, 2, 64, device=dev)
    held = eager_twin(eng, ("prefill",))
    route_n = []
    for value in ("0", "1", "0"):
        ops.reset_launch_counts()
        with env_var("REPRO_RWKV_CHUNKED", value):
            eng.prefill(toks)
        route_n.append({k: v for k, v in ops.launch_counts().items() if v})
    st = eng.prefill_stats
    # the twins' eager runs launch row 9 on the default route (2 a call)
    want_route = [{wkv32.name: 2 + 2 + 2}, {}, {wkv32.name: 2 + 2}]
    if (held["prefill"] != 3 or (st["captures"], st["replays"]) != (2, 3)
            or route_n != want_route):
        raise AssertionError(f"rwkv6 fp32 engine across routes: {st}, "
                             f"launches {route_n} (want {want_route}), "
                             f"{held} held")
    log(f"lm rwkv6-1.6b (fp32, full width, 2 layers) prefill [2, 32] under "
        f"REPRO_RWKV_CHUNKED=1 against the same prefill through row 9: "
        f"logits and every cache leaf within {err:.3e} of max(1, |row 9|) "
        f"(tolerance {TOL_LM}); launches {n_c or 'none'} (row 9's run "
        f"{n_k}); an LmEngine's prefill under the routes 0, 1, 0: "
        f"{st['captures']} captures, {st['replays']} replays, each bitwise "
        f"its eager twin under the same route, launches {route_n} (the "
        f"warm-up, the replay and the twin's run on row 9's route; none on "
        f"the chunked one) [{smi}]")
    del caches_k, caches_c, eng
    # the sweep's lengths come as in a new process: the chunked scan's
    # shared memory limit not yet raised, the first prompt one token (its
    # warm-up the only launch outside a capture), the longer ones captured
    # with no warm-up of their own and past 48 KB from T = 27 at 32 columns
    wkv_mod._PREPARED.clear()
    res["bound"] = bound_sweep(params, cfg, dev, rng, smi)
    del params
    torch.cuda.empty_cache()
    log(f"phase 5f served at full size: {res['served']}")
    return res


# -- phase 5g: the rest of the LM zoo: MLA, MoE, cross-attention ----------

# A routing flip: MoE top-k over near-tied router probabilities picks
# another expert in one of two runs of the same tokens. One run takes the
# other's expert choices (so the hidden states stay comparable: a flip
# left free moves its token's state by its own size and cascades through
# the later layers), and a token whose own top-k differs is allowed only
# where its k-th and (k+1)-th probabilities lie within this of each other.
# A probability p moves by ~p * dlogit when its logit (of order 1) moves
# by dlogit; p <= 2**-3 at the top-k boundary of 40-64 experts. fp32: the
# runs' hidden states differ by ~1e-6 relative (phase 5f (d)), dp ~1e-7:
# 1e-5 keeps a factor of 100. bf16: by 1-3 % at 16-40 layers (5f: 1.2e-2
# at 16), tails to 4 times that, dlogit up to ~0.1, a gap up to
# 2 * 2**-3 * 0.1 = 2.5e-2: 2**-5.
ROUTE_MARGIN_F32 = 1e-5
ROUTE_MARGIN_BF16 = 2.0 ** -5
# (a)'s staggered admission: the live request's new tokens (the wave
# joins at its third; a decode step of deepseek takes ~0.2 s)
ZOO_STAGGER_NEW = 12
# the fp32 runs of (e): the fewest layers that hold every block kind of
# the arch (the VLM: one period of four self-attention layers and a cross
# one; seamless: two encoder and two decoder layers)
ZOO_F32_LAYERS = {"deepseek-v2-lite-16b": {"n_layers": 2},
                  "granite-moe-3b-a800m": {"n_layers": 2},
                  "llama-3.2-vision-11b": {"n_layers": 5},
                  "seamless-m4t-large-v2": {"n_layers": 2,
                                            "n_encoder_layers": 2},
                  "qwen2.5-32b": {"n_layers": 2},
                  "olmo-1b": {"n_layers": 2},
                  "smollm-360m": {"n_layers": 2}}
# (b)-(g): the archs served through generate_greedy at full size, qwen's
# 65.5 GB of bf16 weights among them
ZOO_GREEDY = ("granite-moe-3b-a800m", "llama-3.2-vision-11b",
              "seamless-m4t-large-v2", "qwen2.5-32b", "olmo-1b",
              "smollm-360m")


def check_served(served_5f, served_5g) -> None:
    """Phases 5f and 5g together serve every arch of the registry at full
    size, each once: an arch added to the registry and to neither phase
    fails here."""
    from repro_torch.configs.registry import ARCH_IDS
    both = list(served_5f) + list(served_5g)
    if sorted(both) != sorted(ARCH_IDS):
        raise AssertionError(f"phases 5f {list(served_5f)} and 5g "
                             f"{list(served_5g)} serve at full size "
                             f"{sorted(both)}; the registry holds "
                             f"{sorted(ARCH_IDS)}")


def modality_inputs(cfg, b: int, dev, dtype, gen) -> dict:
    """Seeded stub modality inputs drawn on ``dev``: image embeddings
    ``[b, n_image_tokens, vision_dim]`` (normal, scaled 0.02 as the
    reference's ``lm_batch``) or audio frames ``[b, n_audio_frames,
    audio_dim]`` (standard normal)."""
    import torch
    out = {}
    if cfg.cross_attn_every:
        out["image_embeds"] = (torch.randn(
            (b, cfg.n_image_tokens, cfg.vision_dim), generator=gen,
            device=dev) * 0.02).to(dtype)
    if cfg.encdec:
        out["audio_frames"] = torch.randn(
            (b, cfg.n_audio_frames, cfg.audio_dim), generator=gen,
            device=dev).to(dtype)
    return out


def host_rss_gib() -> tuple:
    """The process's resident host memory now and at its peak, GiB."""
    import resource
    with open("/proc/self/status") as f:
        now = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS:"))
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return now / 2 ** 20, peak / 2 ** 20


def lm_prefill_rows(times: dict, smi: str) -> dict:
    """One line of every served model's prefill at [4, 128] (phases 5f and
    5g's ``lm_timed``): the graph's replay and the eager ``lm_prefill``
    (ms), the capturing call, the capture (warm-up, body, end) and the
    prefill graphs' pool, and the
    profiled replay's kernels, busy µs and idle share; the decode step's
    p50 beside them."""
    rows = {}
    for arch, t in times.items():
        prof = t["prefill_profile"]
        rows[arch] = {
            "prefill_ms": t["prefill_ms"],
            "eager_prefill_ms": t["eager_prefill_ms"],
            "capture_call_ms": t["capture_call_ms"],
            "capture_ms": t["prefill_capture_ms"],
            "capture_split_ms": t["prefill_capture_split_ms"],
            "pool_mib": t["prefill_pool_mib"],
            "kernels": prof["kernels_per_step"],
            "busy_us": prof["device_busy_us_per_step"],
            "idle_share": prof["idle_share"],
            "decode_p50_ms": t["decode_p50_ms"]}
    log("lm prefill rows [4, 128] " + json.dumps(rows) + f" [{smi}]")
    return rows


def zoo_phase(dev, smi, served_5f) -> dict:
    """Phase 5g: the rest of the LM zoo on the card, seeded ``init_lm`` on
    the card, bf16, at full size; every prefill and decode step one graph
    replay. (a) deepseek-v2-lite-16b (MLA, 64 routed experts top-6 and 2
    shared): an ``LmEngine(4, 256)`` under a ``ContinuousBatcher`` drains
    12 prompts of 16-96 tokens, 32 new each, twice with the same tokens
    (the first run's prefills held bitwise against their eager twins), one
    prefill capture a distinct wave length, and a staggered admission
    leaves the live request's tokens those of a run with the same waves;
    its decode's scores (``mla_scores_err``) within ``TOL_SCORES_F64`` of
    fp64; then ``ZOO_GREEDY``: (b) granite-moe-3b-a800m (40 experts padded to
    48, top-8), (c) llama-3.2-vision-11b (8 cross layers of 40, image
    embeddings [4, 1601, 7680]), (d) seamless-m4t-large-v2 (24 encoder and
    24 decoder layers, audio frames [4, 1536, 160]), (e) qwen2.5-32b
    (64 layers, QKV bias, 40 query heads over 8 KV heads; its init's peak
    beside the card's memory), (f) olmo-1b (non-parametric LayerNorm, tied
    embeddings) and (g) smollm-360m (15 query heads over 5 KV heads, tied
    embeddings): ``generate_greedy`` on 4 prompts of 128 tokens for 32
    steps. For each, the prefill-then-decode logits within
    ``TOL_LM_BF16_RMS`` of the teacher-forced forward (``lm_forced``; MoE
    at a capacity for every token, routing flips within
    ``ROUTE_MARGIN_BF16``). (h) all of them in fp32 at full width and the
    fewest layers that hold each block kind (``ZOO_F32_LAYERS``): prefill
    [2, 32] and a decode step on the card and on the CPU within ``TOL_LM``
    (the CPU takes the card's expert choices; flips within
    ``ROUTE_MARGIN_F32``),
    and prefill-then-decode against the forward within ``TOL_F32``. No
    hand-written kernel is launched. Times per model as phase 5f's
    (``lm_timed``), with the init's peak memory. With ``served_5f``, the
    archs phase 5f served, every arch of the registry must have been
    served at full size once (``check_served``). Returns the time rows
    and ``"served"``."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_map
    from repro_torch.models.common import tree_leaves as lm_leaves
    from repro_torch.models.lm import init_lm_caches, lm_decode, lm_prefill
    from repro_torch.serve.engine import LmEngine
    from repro_torch.serve.scheduler import ContinuousBatcher

    rng = np.random.default_rng(SEED + 7)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base, res, served = {}, {}, []
    ops.reset_launch_counts()
    card_gib = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30

    def no_kernels(what):
        n = {k: v for k, v in ops.launch_counts().items() if v}
        if n:
            raise AssertionError(f"{what}: hand-written kernels launched {n}")

    # (a) deepseek-v2-lite-16b, full size, bf16, under the batcher
    cfg = get_config("deepseek-v2-lite-16b")
    params, init_s, init_peak = lm_build(cfg, dev, base)
    prompts = [rng.integers(1, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, 97, LM_REQUESTS)]

    def batcher():
        return ContinuousBatcher(LmEngine(params, cfg, LM_SLOTS, LM_MAX_LEN,
                                          device=dev))


    def staggered(stagger):
        cb = batcher()
        cb.submit(prompts[0], max_new_tokens=ZOO_STAGGER_NEW)
        done, submitted = [], not stagger
        while cb.queue or any(cb.slots):
            done += cb.step()
            if (not submitted and cb.slots[0] is not None
                    and len(cb.slots[0].output) >= 3):
                for p in prompts[1:4]:
                    cb.submit(p, max_new_tokens=8)
                submitted = True
        return {r.uid: r.output for r in done}

    (outs, wall, waves1), (outs2, wall2, waves2), (outs3, wall3, waves3) = (
        drains(lambda: LmEngine(params, cfg, LM_SLOTS, LM_MAX_LEN,
                                device=dev), prompts, "deepseek-v2-lite-16b"))
    solo, mixed = staggered(False), staggered(True)
    if mixed[0] != solo[0] or len(mixed) != 4:
        raise AssertionError("deepseek-v2-lite-16b: a staggered admission "
                             "changed the live request's tokens")
    f = lm_forced(params, cfg, dev, rng, "deepseek-v2-lite-16b",
                  margin=ROUTE_MARGIN_BF16)
    no_kernels("deepseek-v2-lite-16b")
    score_err = mla_scores_err(cfg, dev)
    if not score_err <= TOL_SCORES_F64:
        raise AssertionError(f"deepseek-v2-lite-16b: the absorbed decode's "
                             f"scores {score_err:.3e} from fp64 (tolerance "
                             f"{TOL_SCORES_F64})")
    n_tok = LM_REQUESTS * LM_NEW
    log(f"lm deepseek-v2-lite-16b (bf16, full size: MLA kv_lora "
        f"{cfg.kv_lora}, {cfg.n_experts} experts top-{cfg.top_k} + "
        f"{cfg.n_shared_experts} shared) batcher: {LM_REQUESTS} prompts of "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
        f"{LM_NEW} new each, {LM_SLOTS} slots: {n_tok} tokens in "
        f"{wall3:.3f} s on a warm engine ({n_tok / wall3:.1f} tokens/s; on "
        f"a fresh one, its prefill captures included, {wall2:.3f} s, "
        f"{n_tok / wall2:.1f} tokens/s; the first run, its captures and its "
        f"prefills' eager twins included, {wall:.3f} s; the same tokens in "
        f"all three, every prefill of the first bitwise its eager twin); "
        f"{waves1}; fresh engine {waves2}, then warm {waves3}; staggered "
        f"admission: the live request's tokens equal those of its run with "
        f"the same waves; prefill-then-decode against the teacher-forced "
        f"forward: relative RMS {f['err']:.3e} (within {TOL_LM_BF16_RMS}), "
        + flips_allowed("deepseek", f["flips"], f["gap"], ROUTE_MARGIN_BF16)
        + f"; the absorbed decode's scores over a bf16 cache of "
        f"{SCORE_CACHE_ROWS} rows within {score_err:.3e} of fp64 sums of "
        f"the same values (tolerance {TOL_SCORES_F64}); init {init_s:.3f} s,"
        f" its peak {init_peak / 2 ** 30:.3f} GiB "
        f"above the {base['bytes']} B held before; no hand-written kernel "
        f"launched [{smi}]")
    res["deepseek-v2-lite-16b"] = lm_timed(
        "deepseek-v2-lite-16b", cfg, params, init_s, LM_T, dev, rng, base,
        smi, f"; drain {n_tok / wall3:.1f} tokens/s warm, "
        f"{n_tok / wall2:.1f} fresh")
    del res["deepseek-v2-lite-16b"]["tokens"]
    res["deepseek-v2-lite-16b"].update(
        tokens_per_s=n_tok / wall3, fresh_tokens_per_s=n_tok / wall2,
        init_peak_gib=init_peak / 2 ** 30,
        forced=f)
    served.append("deepseek-v2-lite-16b")
    del params

    # (b)-(g): generate_greedy on 4 prompts of 128 tokens, 32 steps
    for arch in ZOO_GREEDY:
        cfg = get_config(arch)
        params, init_s, init_peak = lm_build(cfg, dev, base)
        mod = modality_inputs(cfg, LM_SLOTS, dev, torch.bfloat16, gen)
        res[arch] = lm_timed(arch, cfg, params, init_s, LM_T, dev, rng, base,
                             smi, modality=mod)
        new = res[arch].pop("tokens")
        if new.shape != (LM_SLOTS, LM_NEW) or not (0 <= new).all() or not (
                new < cfg.vocab).all():
            raise AssertionError(f"{arch} tokens {new.shape}")
        f = lm_forced(params, cfg, dev, rng, arch, modality=mod,
                      margin=ROUTE_MARGIN_BF16)
        no_kernels(arch)
        what = ", ".join(f"{k} {list(v.shape)}" for k, v in mod.items())
        log(f"lm {arch} (bf16, full size) generate_greedy: {LM_SLOTS} "
            f"prompts of {LM_T}{', ' + what if what else ''}, {LM_NEW} "
            f"steps; prefill-then-decode against the teacher-forced "
            f"forward: relative RMS {f['err']:.3e} (within "
            f"{TOL_LM_BF16_RMS}), "
            + flips_allowed(arch, f["flips"], f["gap"], ROUTE_MARGIN_BF16)
            + f"; init peak {init_peak / 2 ** 30:.3f} GiB above the "
            f"{base['bytes'] / 2 ** 30:.3f} GiB held before, of the card's "
            f"{card_gib:.3f} GiB; no hand-written kernel launched [{smi}]")
        res[arch].update(init_peak_gib=init_peak / 2 ** 30,
                         held_before_gib=base["bytes"] / 2 ** 30,
                         card_gib=card_gib, forced=f)
        served.append(arch)
        del params, mod, new

    check_served(served_5f, served)
    res["served"] = served

    # (h) fp32 at full width and few layers: the card against the CPU
    cpu = torch.device("cpu")
    for arch, layers in ZOO_F32_LAYERS.items():
        cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                  **layers)
        params, _, _ = lm_build(cfg, dev, base)
        cpu_params = tree_map(lambda x: x.to(cpu), params)
        mod = modality_inputs(cfg, LM_SLOTS, dev, torch.float32, gen)
        mod2 = {k: v[:2] for k, v in mod.items()}
        toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 32)))

        def run(p, where, m, replay=None):
            with torch.no_grad(), RouteLog(replay) as routes:
                caches = init_lm_caches(cfg, 2, 64, where)
                lg_p, caches = lm_prefill(p, cfg, toks.to(where), caches,
                                          **{k: v.to(where)
                                             for k, v in m.items()})
                lg_d, caches = lm_decode(p, cfg, cur.to(where), caches)
            return lg_p, lg_d, caches, routes

        cur = torch.zeros((2, 1), dtype=torch.long)
        with torch.no_grad():
            caches = init_lm_caches(cfg, 2, 64, dev)
            lg, _ = lm_prefill(params, cfg, toks.to(dev), caches, **mod2)
            cur = torch.argmax(lg[:, -1:], dim=-1).cpu()
        lg_p, lg_d, caches, card_routes = run(params, dev, mod2)
        t0 = time.perf_counter()
        c_p, c_d, c_caches, cpu_routes = run(cpu_params, cpu, mod2,
                                             card_routes.calls)
        cpu_s = time.perf_counter() - t0
        n, gap = cpu_routes.flips()
        flips = flips_allowed(f"{arch} fp32 card against CPU", n, gap,
                              ROUTE_MARGIN_F32)
        err = max([scaled_err(lg_p, c_p), scaled_err(lg_d, c_d)] + [
            scaled_err(a.float(), b.float()) for a, b in zip(
                lm_leaves(caches), lm_leaves(c_caches))])
        if err > TOL_LM:
            raise AssertionError(f"{arch} fp32: card against CPU {err:.3e}")
        f = lm_forced(params, cfg, dev, rng, f"{arch} fp32", TOL_F32,
                      modality=mod, margin=ROUTE_MARGIN_F32)
        no_kernels(f"{arch} fp32")
        rss, rss_peak = host_rss_gib()
        shape = ", ".join(f"{k}={v}" for k, v in layers.items())
        log(f"lm {arch} (fp32, full width, {shape}) card against CPU: "
            f"prefill [2, 32] and first decode logits and every cache leaf "
            f"within {err:.3e} of max(1, |CPU|) (tolerance {TOL_LM}), the "
            f"CPU taking the card's expert choices: {flips}; CPU run "
            f"{cpu_s:.1f} s, host RSS {rss:.2f} GiB (peak {rss_peak:.2f}); "
            f"on the card, prefill-then-decode against the teacher-forced "
            f"forward: relative RMS {f['err']:.3e} (within {TOL_F32}), "
            + flips_allowed(arch, f["flips"], f["gap"], ROUTE_MARGIN_F32)
            + f" [{smi}]")
        res[f"{arch} fp32"] = {"err": err, "forced": f, "flips": n}
        del params, cpu_params, caches, c_caches, mod, mod2
        gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 5g served at full size: {served}, with phase 5f's "
        f"{list(served_5f)} every arch of the registry")
    return res


# -- phase 5h: LM training ------------------------------------------------------

# (a) the launcher at full size: llama3.2-1b, bf16 weights, fp32 Adam
# moments, remat on, 8 steps of [8, 128]; then 5 steps of
# make_lm_train_step on one fixed batch with the launcher's optimizer at
# its defaults (AdamW, weight decay 0.1, warmup to 3e-4 over 20 steps):
# the loss must fall; two more steps profiled. (At a constant 3e-4 or
# 1e-3 the first steps' near-sign updates of every weight overshoot and
# the loss swings up and down on a fixed batch.)
LM_TRAIN_ARCH = "llama3.2-1b"
LM_TRAIN_STEPS = 8
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 128
LM_FIXED_STEPS = 5
# bf16 dense rate of an H100 SXM's tensor cores, from the data sheet (not
# measured here), for the step's bound
BF16_OPS_PER_S = 989e12
# (b) one train step on the card against the same step on the CPU, in fp32,
# from the same weights and batch [2, 32]: the loss within TOL_LM, each
# gradient leaf within TOL_LM_TRAIN_GRAD of the leaf's largest magnitude
# (the CPU suite holds the packages to 1e-5 at D = 64; the card sums the
# same products in other orders over D up to 4096, ~8 times the terms of a
# dot product, a factor of ~3 under sqrt growth, and 1e-4 keeps three over
# that), the parameters after Adam within adam_first_step_bound of that.
# The families at full width and few layers (recurrentgemma-9b: one period
# of 3 layers, its vocabulary cut to LM_GRAD_RG_VOCAB: the 256,000-row
# embedding alone is 4.2 GB in fp32, and the CPU's copies of a training
# step hold it ~8 times); deepseek-v2-lite-16b, llama-3.2-vision-11b and
# seamless-m4t-large-v2 at reduced() widths: at full width two of their
# layers are 1.3-6.0 G fp32 parameters, whose training copies on the CPU
# would take ~50 GB and most of the phase's time
TOL_LM_TRAIN_GRAD = 1e-4
# RWKV6's group norm divides each head by rsqrt(var + 1e-5), and its
# backward subtracts near-equal terms where a head's variance is small: the
# CPU suite holds RWKV6's leaves to 5e-4 (measured 1.2e-4 on a microbatch
# of 2 at D = 64) where it holds the others to 1e-5; the card against the
# CPU at full width measured 1.2e-4 (first run), and 1e-3 keeps a factor
# of eight
TOL_LM_TRAIN_GRAD_RWKV6 = 1e-3
LM_GRAD_BATCH, LM_GRAD_SEQ = 2, 32
LM_GRAD_RG_VOCAB = 32768
LM_GRAD_FULL = {"llama3.2-1b": {"n_layers": 2},
                "rwkv6-1.6b": {"n_layers": 2},
                "recurrentgemma-9b": {"n_layers": 3,
                                      "vocab": LM_GRAD_RG_VOCAB},
                "granite-moe-3b-a800m": {"n_layers": 2}}
LM_GRAD_REDUCED = ("deepseek-v2-lite-16b", "llama-3.2-vision-11b",
                   "seamless-m4t-large-v2")
# the leaves whose gradient flows only through a scan: a zero gradient on
# any of them on the card fails (b)
SCAN_LEAVES = {"rwkv6-1.6b": ("time_mix/w_r", "time_mix/w_k", "time_mix/w_v",
                              "time_mix/decay_w1", "time_mix/bonus_u"),
               "recurrentgemma-9b": ("rglru/w_rg", "rglru/w_ig",
                                     "rglru/b_rg", "rglru/lambda")}


def adam_first_step_excess(p, cp, cg, delta, scale, lr, eps=1e-8) -> float:
    """``adam_first_step_bound`` on the card, in float64: the most by which
    ``|p - cp|`` (the parameters after Adam's first step from the gradients
    ``g`` and ``cg``, the CPU's, ``|g - cg| <= delta``) exceeds the bound
    plus an ulp of ``cp``; negative when every element is within it."""
    import torch
    g = cg.double()

    def upd(v):
        v = scale * v
        return v / (v.abs() + eps)
    u = upd(g)
    reach = torch.maximum((upd(g + delta) - u).abs(), (upd(g - delta) - u).abs())
    a = cp.abs()
    if a.dtype == torch.bfloat16:        # the next bf16 up, by its bits
        ulp = (a.view(torch.int16) + 1).view(torch.bfloat16).double() - (
            a.double())
    else:
        ulp = (torch.nextafter(a, torch.full_like(a, float("inf")))
               - a).double()
    return float(((p.double() - cp.double()).abs() - lr * (reach + 8 * 2.0 ** -24)
                  - ulp).max())


def steps_apart(grads, ref_grads, params, ref_params, ref_grad_norm, tol,
                lr, dev, scan_leaves=()) -> tuple:
    """Two Adam first steps from the same state, leaf by leaf on ``dev``:
    the largest gradient error as a share of the reference leaf's largest
    (and its leaf), the most by which a parameter exceeds Adam's
    first-step bound of ``tol`` (``adam_first_step_excess``; negative
    within it), and the ``scan_leaves`` whose gradient is zero."""
    from repro_torch.ft.checkpoint import tree_paths
    scale = min(1.0, 1.0 / (ref_grad_norm + 1e-9))
    grad_err, worst, excess, zero = 0.0, "none", -float("inf"), []
    for (path, g), (_, cg), (_, p), (_, cp) in zip(
            tree_paths(grads), tree_paths(ref_grads), tree_paths(params),
            tree_paths(ref_params)):
        cg, cp = cg.to(dev), cp.to(dev)
        top = float(cg.abs().max())
        diff = float((g - cg).abs().max())
        err = diff / top if top else (0.0 if diff == 0 else float("inf"))
        if err > grad_err:
            grad_err, worst = err, path
        if any(path.endswith(leaf) for leaf in scan_leaves) and not float(
                g.abs().max()) > 0:
            zero.append(path)
        excess = max(excess, adam_first_step_excess(p, cp, cg, tol * top,
                                                    scale, lr))
    return grad_err, worst, excess, zero


def lm_step_against_cpu(what, cfg, dev, smi, meshes=None,
                        shape=(LM_GRAD_BATCH, LM_GRAD_SEQ),
                        on_card=None) -> dict:
    """(b) for one config: seeded ``init_lm`` on the card, copied to the
    CPU; one batch ``shape`` (``lm_batch``, default [2, 32]) on both; one
    eager ``make_lm_train_step`` step on each (``.eager``: the check
    compares arithmetic across devices, not the program), its gradients
    kept by a
    ``grad_transform`` that returns them unchanged; the card's MoE choices
    replayed on the CPU (flips within ``ROUTE_MARGIN_F32``). Compared on
    the card, leaf by leaf. ``meshes``: a (card mesh, CPU mesh) pair the
    two steps run under (``use_mesh`` with ``AxisRules()``, the batch put
    by ``shard_batch``); ``on_card(grads, route_calls)`` sees the card's
    gradients and router choices."""
    import contextlib

    import torch
    from repro_torch.data.lm_data import lm_batch
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist.sharding import AxisRules, use_mesh
    from repro_torch.models.common import count_params, tree_leaves, tree_map
    from repro_torch.models.lm import init_lm
    from repro_torch.train.optim import AdamConfig, constant_schedule
    from repro_torch.train.trainer import (init_train_state,
                                           make_lm_train_step)
    cpu = torch.device("cpu")
    arch = what.split(" ")[0]
    tol = TOL_LM_TRAIN_GRAD_RWKV6 if arch.startswith("rwkv6") else (
        TOL_LM_TRAIN_GRAD)
    t0 = time.perf_counter()
    params = init_lm(SEED, cfg, device=dev)
    n_params = count_params(params)
    dtypes = {t.dtype for t in tree_leaves(params)}
    cpu_params = tree_map(lambda t: t.to(cpu), params)
    batch = lm_batch((SEED, 5), cfg, *shape, device="cpu")
    kept = {}

    def under(i):
        if meshes is None:
            return contextlib.nullcontext()
        return use_mesh(meshes[i], AxisRules())

    def put(b, i):
        return b if meshes is None else shard_batch(b, meshes[i])

    def step_on(where):
        def keep(grads):
            kept[where] = grads
            return grads
        return make_lm_train_step(cfg, AdamConfig(
            schedule=constant_schedule(TRAIN_LR)), grad_transform=keep).eager

    with under(0), RouteLog() as card_log:
        new, metrics = step_on("card")(
            init_train_state(params), put({k: v.to(dev) for k, v in
                                           batch.items()}, 0))
    del params
    if on_card is not None:
        on_card(kept["card"], card_log.calls)
    c_t0 = time.perf_counter()
    with under(1), RouteLog(card_log.calls) as cpu_log:
        c_new, c_metrics = step_on("cpu")(init_train_state(cpu_params),
                                          put(batch, 1))
    cpu_s = time.perf_counter() - c_t0
    del cpu_params
    n_flip, gap = cpu_log.flips()
    flip_text = flips_allowed(f"{arch} train step", n_flip, gap,
                              ROUTE_MARGIN_F32)
    loss_err = abs(float(metrics["loss"]) - float(c_metrics["loss"])) / abs(
        float(c_metrics["loss"]))
    scan_leaves = SCAN_LEAVES.get(arch, ())
    grad_err, worst, excess, zero = steps_apart(
        kept["card"], kept["cpu"], new.params, c_new.params,
        float(c_metrics["grad_norm"]), tol, TRAIN_LR, dev, scan_leaves)
    report = (f"train {what} (fp32, {n_params} parameters) card against "
              f"CPU, one make_lm_train_step on [{shape[0]}, {shape[1]}]"
              + ("" if meshes is None else
                 f" under a {meshes[0].shape} mesh on each")
              + f": loss {loss_err:.3e} relative (tolerance "
              f"{TOL_LM}), gradients {grad_err:.3e} of the leaf's largest at "
              f"the worst ({worst}; tolerance {tol}), parameters after Adam "
              f"within its first-step bound with {-excess:.3e} to spare at "
              f"the closest; {flip_text}"
              + (f"; nonzero card gradients on {', '.join(scan_leaves)}"
                 if scan_leaves else "")
              + f"; {time.perf_counter() - t0:.1f} s ({cpu_s:.1f} the CPU's "
              f"step) [{smi}]")
    if (loss_err > TOL_LM or grad_err > tol or excess > 0 or zero
            or not math.isfinite(float(metrics["loss"]))):
        raise AssertionError(f"{report}: outside the bounds; zero card "
                             f"gradients on {zero}")
    log(report)
    return {"loss_err": loss_err, "grad_err": grad_err, "worst": worst,
            "flips": n_flip, "cpu_s": cpu_s, "dtypes": dtypes}


# substrings of the names of cuBLAS's matmul kernels on an H100
MATMUL_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")


def lm_step_split(cfg, state, batch, opt_cfg, steps: dict) -> dict:
    """One eager LM train step cut at its joints, each part ended by a
    synchronise (ms): the forward with its loss, the backward (remat's
    second forward in it), the Adam update (norm, schedule, fused kernel);
    and for each of ``steps`` (name -> step, e.g. eager and compiled),
    after one unprofiled call (a compiled step's capture), the device time
    of one step by kernel group (``torch.profiler``): the
    library's matmuls (``MATMUL_KERNELS`` in the kernel's name), the fused
    Adam, the rest, and the six kernels that took the most. Each step
    updates ``state["s"]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.common import tree_map
    from repro_torch.models.lm import lm_forward
    from repro_torch.train.losses import lm_loss
    from repro_torch.train.optim import adam_update
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    live = tree_map(lambda p: p.detach().requires_grad_(True),
                    state["s"].params)
    logits, aux = lm_forward(live, cfg, batch["tokens"])
    loss = lm_loss(logits, batch["tokens"])[0] + 0.01 * torch.as_tensor(aux)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    adam_update(tree_map(lambda p: p.grad, live), state["s"].opt,
                state["s"].params, opt_cfg)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del live, logits, loss

    def short(name):
        for cut in ("void ", "at::native::", "(anonymous namespace)::"):
            name = name.replace(cut, "")
        return name[:150]
    out = {"forward_ms": 1e3 * (t1 - t0), "backward_ms": 1e3 * (t2 - t1),
           "adam_ms": 1e3 * (t3 - t2)}
    for how, step in steps.items():
        state["s"], _ = step(state["s"], batch)   # a compiled step captures
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state["s"], _ = step(state["s"], batch)
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        gemm = sum(us for name, (_, us) in by_name.items()
                   if any(m in name.lower() for m in MATMUL_KERNELS))
        adam = sum(us for name, (_, us) in by_name.items()
                   if "fused_adam" in name)
        norm = sum(us for name, (_, us) in by_name.items()
                   if "global_norm" in name)
        rest = sum(us for _, us in by_name.values()) - gemm - adam - norm
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        out[how] = {"gemm_us": gemm, "adam_us": adam, "norm_us": norm,
                    "other_us": rest,
                    "top": [(short(name), n, us) for name, (n, us) in top]}
    return out


def lm_train_phase(dev, smi) -> dict:
    """Phase 5h: LM training on the card. (a) ``launch.train.main`` trains
    llama3.2-1b at full size (the registry config: bf16 weights, fp32 Adam
    moments, remat) for 8 steps of [8, 128], every loss finite, its step
    compiled (one CUDA graph, donated state); ``--grad-accum 2`` for 2
    steps; 5 steps of the compiled ``make_lm_train_step`` on one fixed
    batch, whose loss falls, one more under ``set_sync_debug_mode("error")``
    and 2 profiled (``engine_profile``), then the same 8 steps through its
    eager twin from a copy of the first state: losses, parameters, moments
    and step bitwise; both profiled, timed and cut into forward, backward
    and Adam. (b) One eager train step on the card against the CPU in fp32
    per family (``LM_GRAD_FULL``, ``LM_GRAD_REDUCED``;
    ``lm_step_against_cpu``). (c) The same 3 steps of ``--reduced``
    llama3.2-1b and granite-moe-3b-a800m twice, losses bitwise equal; a run
    stopped at step 4 by its checkpoint and resumed to step 6 gives the
    losses of steps 5-6 of an uninterrupted run, bitwise. The only
    hand-written kernels launched are the global norm, once a step, and
    the fused Adam, once a step and parameter dtype: the blocks run the
    plain scans under autograd.
    Returns the numbers."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm_data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.common import count_params, tree_map
    from repro_torch.models.lm import init_lm
    from repro_torch.train.optim import AdamConfig, warmup_cosine_schedule
    from repro_torch.train.trainer import (init_train_state,
                                           make_lm_train_step)

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    res = {}

    def finite(what, losses, n):
        if len(losses) != n or not all(np.isfinite(losses)):
            raise AssertionError(f"{what}: losses {losses}")

    # (a) the launcher at full size, its step compiled with donation
    f32, bf16 = {torch.float32}, {torch.bfloat16}
    adam_want = {}
    args = ["--arch", LM_TRAIN_ARCH, "--steps", str(LM_TRAIN_STEPS),
            "--batch", str(LM_TRAIN_BATCH), "--seq", str(LM_TRAIN_SEQ),
            "--log-every", "1"]
    t0 = time.perf_counter()
    run = train_main(args)
    run_s = time.perf_counter() - t0
    finite("launch.train " + " ".join(args), run["losses"], LM_TRAIN_STEPS)
    tally_adam(adam_want, bf16, compiled_steps(run["compiled"]))
    main_adam = {k: v for k, v in ops.launch_counts().items() if v}
    main_steps = dict(adam_want)
    log(f"train {LM_TRAIN_ARCH} (full size, bf16) launch.train "
        f"{' '.join(args)}: {LM_TRAIN_STEPS} finite losses "
        + ", ".join(f"{v:.4f}" for v in run["losses"])
        + f"; steps 2-{LM_TRAIN_STEPS} p50 "
        f"{float(np.median(run['step_ms'][1:])):.3f} ms (the first, warm-up "
        f"and capture included, {run['step_ms'][0]:.3f} ms; the capture "
        f"{1e3 * run['compiled']['capture_s']:.3f} ms); compiled step "
        f"{run['compiled']}; {run_s:.1f} s in all [{smi}]")
    run2 = train_main(args[:2] + ["--steps", "2", "--batch",
                                  str(LM_TRAIN_BATCH), "--seq",
                                  str(LM_TRAIN_SEQ), "--grad-accum", "2",
                                  "--log-every", "1"])
    finite("launch.train --grad-accum 2", run2["losses"], 2)
    tally_adam(adam_want, bf16, compiled_steps(run2["compiled"]))
    log(f"train {LM_TRAIN_ARCH} --grad-accum 2 (2 microbatches of "
        f"[{LM_TRAIN_BATCH // 2}, {LM_TRAIN_SEQ}], compiled): losses "
        + ", ".join(f"{v:.4f}" for v in run2["losses"])
        + "; step ms " + ", ".join(f"{v:.3f}" for v in run2["step_ms"])
        + f" [{smi}]")

    # the fixed batch: the compiled make_lm_train_step (LM_FIXED_STEPS
    # timed steps, one under set_sync_debug_mode("error"), two profiled),
    # then the same steps op by op (its eager twin) from a copy of the
    # first state, bitwise; the graph is freed before the twin runs
    cfg = get_config(LM_TRAIN_ARCH)
    free_card()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(SEED, cfg, device=dev)
    n_params = count_params(params)
    state = {"s": init_train_state(params)}
    del params
    state_bytes = torch.cuda.memory_allocated() - base
    twin = {"s": tree_map(torch.clone, state["s"])}
    step_opt = AdamConfig(schedule=warmup_cosine_schedule(3e-4, 20, 100),
                          weight_decay=0.1)
    step = make_lm_train_step(cfg, step_opt)
    eager = step.eager
    batch = lm_batch((SEED, 9), cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                     device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_c = torch.cuda.memory_allocated()
    pools0 = graph_pools()
    losses, walls = [], []
    for _ in range(LM_FIXED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state["s"], m = step(state["s"], batch)
        losses.append(float(m["loss"]))
        walls.append(1e3 * (time.perf_counter() - t0))
    pool = new_pool_bytes(pools0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state["s"], m = step(state["s"], batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    losses.append(float(m["loss"]))
    if not all(np.isfinite(losses)) or not losses[LM_FIXED_STEPS - 1] < \
            losses[0]:
        raise AssertionError(f"{LM_TRAIN_ARCH} fixed batch: losses {losses}"
                             " (want finite and falling)")

    def two_steps(fn, out, into):
        def run2steps():
            for _ in range(2):
                out["s"], mm = fn(out["s"], batch)
                into.append(float(mm["loss"]))
        return run2steps
    prof = {"compiled": engine_profile(two_steps(step, state, losses), 2,
                                       match=OPT_KERNELS)}
    peak = {"compiled": (torch.cuda.max_memory_allocated() - base_c)
            / 2 ** 30}
    tally_adam(adam_want, bf16, compiled_steps(step.stats))
    capture_s, stats = step.stats["capture_s"], dict(step.stats)
    del step, m
    free_card()
    torch.cuda.reset_peak_memory_stats()
    base_e = torch.cuda.memory_allocated()
    e_losses, e_walls = [], []
    for _ in range(LM_FIXED_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        twin["s"], m = eager(twin["s"], batch)
        e_losses.append(float(m["loss"]))
        e_walls.append(1e3 * (time.perf_counter() - t0))
    del m
    prof["eager"] = engine_profile(two_steps(eager, twin, e_losses), 2,
                                   match=OPT_KERNELS)
    peak["eager"] = (torch.cuda.max_memory_allocated() - base_e) / 2 ** 30
    tally_adam(adam_want, bf16, LM_FIXED_STEPS + 3)
    same = e_losses == losses and state_bitwise(state["s"], twin["s"])
    report = (f"train {LM_TRAIN_ARCH} (full size) make_lm_train_step "
              f"compiled ({stats['captures']} capture, {stats['replays']} "
              f"replays, one under set_sync_debug_mode('error')) against "
              f"its eager twin over {len(losses)} steps on one batch: "
              f"losses bitwise {e_losses == losses}, parameters, moments "
              f"and step bitwise {state_bitwise(state['s'], twin['s'])}")
    if not same:
        raise AssertionError(f"{report}: {losses} / {e_losses}")
    log(report + f" [{smi}]")
    del twin
    free_card()
    split = lm_step_split(cfg, state, batch, step_opt,
                          {"eager": eager,
                           "compiled": make_lm_train_step(cfg, step_opt)})
    # the split's update, the eager step twice, the compiled step's warm-up
    # and two replays
    tally_adam(adam_want, bf16, 1 + 2 + 3)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    walls_of = {"compiled": walls[1:], "eager": e_walls[1:]}
    # the step's least time: 6 N T operations of forward and backward plus
    # remat's second forward (2 N T) at the bf16 tensor-core rate, or the
    # bytes of the Adam update (bf16 weights read and written, bf16
    # gradients read, fp32 moments read and written) at HBM_BYTES_PER_S
    t_ops = 8 * n_params * tokens / BF16_OPS_PER_S
    t_bytes = (2 * 2 + 2 + 4 * 4) * n_params / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    res["a"] = {"launcher_losses": run["losses"],
                "launcher_step_ms": run["step_ms"],
                "fixed_losses": losses, "params": n_params,
                "state_bytes": state_bytes,
                "bound_ms": bound_ms, "split": split,
                "capture_s": capture_s, "pool_bytes": pool}
    for how in ("eager", "compiled"):
        pr, w = prof[how], walls_of[how]
        p50 = float(np.median(w))
        res["a"][how] = {"step_ms": w, "p50_ms": p50, "profile": pr,
                         "peak_gib": peak[how],
                         "tokens_per_s": 1e3 * tokens / p50}
        log(f"time train {LM_TRAIN_ARCH} {how} (full size: {n_params} "
            f"parameters, bf16, fp32 Adam moments, remat) "
            f"make_lm_train_step on one [{LM_TRAIN_BATCH}, {LM_TRAIN_SEQ}] "
            f"batch: losses "
            + ", ".join(f"{v:.4f}" for v in (
                losses if how == "compiled" else e_losses))
            + f"; step wall p50 {p50:.3f} ms over steps 2-"
            f"{len(w) + 1} (each " + ", ".join(f"{v:.3f}" for v in w)
            + f"), {1e3 * tokens / p50:.1f} tokens/s; profiled step: "
            f"{pr['kernels_per_step']:.1f} kernels, device busy "
            f"{pr['device_busy_us_per_step']:.1f} us, idle share "
            f"{pr['idle_share']:.4f} (wall {pr['wall_us_per_step']:.1f} us "
            f"under the profiler), fused Adam kernel "
            f"{pr['match_us_by']['fused_adam']:.1f} us, global norm kernel "
            f"{pr['match_us_by']['global_norm']:.1f} us; peak memory "
            f"{peak[how]:.3f} GiB above the state and its copy (the state "
            f"{state_bytes / 2 ** 30:.3f} GiB, {state_bytes} B; peak with "
            f"the state {peak[how] + state_bytes / 2 ** 30:.3f} GiB) [{smi}]")
    log(f"time train {LM_TRAIN_ARCH} compiled: capture {1e3 * capture_s:.3f} "
        f"ms (a warm-up step, then the capture), graph pool "
        + (f"{pool / 2 ** 30:.3f} GiB ({pool} B)" if pool is not None
           else "not measured")
        + f"; bound {bound_ms:.3f} ms (8 N T = {8 * n_params * tokens:.4e} "
        f"bf16 operations at {BF16_OPS_PER_S:.3e}/s: {1e3 * t_ops:.3f} ms; "
        f"Adam's {(2 * 2 + 2 + 4 * 4) * n_params} B at "
        f"{HBM_BYTES_PER_S:.3e} B/s: {1e3 * t_bytes:.3f} ms) [{smi}]")
    log(f"time train {LM_TRAIN_ARCH} eager step split (each part "
        f"synchronised): forward and loss {split['forward_ms']:.3f} ms, "
        f"backward (remat's second forward in it) "
        f"{split['backward_ms']:.3f} ms, Adam (norm, schedule, fused "
        f"kernel) {split['adam_ms']:.3f} ms [{smi}]")
    for how in ("eager", "compiled"):
        sp = split[how]
        log(f"time train {LM_TRAIN_ARCH} {how}: device time of one step: "
            f"matmul kernels {sp['gemm_us']:.1f} us, fused Adam "
            f"{sp['adam_us']:.1f} us, global norm {sp['norm_us']:.1f} us, "
            f"the rest {sp['other_us']:.1f} us; the "
            f"six largest: " + "; ".join(f"{name} x{n} {us:.1f} us"
                                         for name, n, us in sp["top"])
            + f" [{smi}]")
    # the bf16 instance's row at the main path's tree (timing launches are
    # taken back: they are no step's)
    before = ops.launch_counts()
    res["adam_row"] = adam_row(ops.FUSED_ADAM_BF16, state["s"].params, 8,
                               1.0, 0.1, "llama3.2-1b at full size",
                               True, smi)
    ops.take_back_launches(before)
    del state, batch
    free_card()

    # (b) the card against the CPU, per family, fp32
    res["b"] = {}
    for arch, shape in LM_GRAD_FULL.items():
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **shape)
        cut = ", ".join(f"{k}={v}" for k, v in shape.items())
        res["b"][arch] = lm_step_against_cpu(f"{arch} ({cut}, full width)",
                                             cfg, dev, smi)
        tally_adam(adam_want, res["b"][arch]["dtypes"], 1)
        gc.collect()
        torch.cuda.empty_cache()
    # the chunk-parallel route's step: rwkv6-1.6b at 2 layers under
    # REPRO_RWKV_CHUNKED=1 on both devices (its backward through the
    # chunks' matmul form)
    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), dtype="float32",
                              **LM_GRAD_FULL["rwkv6-1.6b"])
    with env_var("REPRO_RWKV_CHUNKED", "1"):
        res["b"]["rwkv6-1.6b chunked"] = lm_step_against_cpu(
            "rwkv6-1.6b (n_layers=2, full width, REPRO_RWKV_CHUNKED=1)", cfg,
            dev, smi)
    tally_adam(adam_want, res["b"]["rwkv6-1.6b chunked"]["dtypes"], 1)
    gc.collect()
    torch.cuda.empty_cache()
    for arch in LM_GRAD_REDUCED:
        cfg = get_config(arch).reduced()
        res["b"][arch] = lm_step_against_cpu(
            f"{arch} (reduced: D={cfg.d_model}, {cfg.n_layers} layers)", cfg,
            dev, smi)
        tally_adam(adam_want, res["b"][arch]["dtypes"], 1)
    rss, rss_peak = host_rss_gib()
    log(f"train card against CPU: host RSS {rss:.2f} GiB (peak "
        f"{rss_peak:.2f})")

    # (c) determinism and resume, --reduced
    res["c"] = {}
    for arch in (LM_TRAIN_ARCH, "granite-moe-3b-a800m"):
        args = ["--arch", arch, "--reduced", "--steps", "3", "--batch", "8",
                "--seq", "128", "--log-every", "1"]
        ra, rb = train_main(args), train_main(args)
        a, b = ra["losses"], rb["losses"]
        for r in (ra, rb):
            tally_adam(adam_want, f32, compiled_steps(r["compiled"]))
        finite(f"{arch} --reduced", a, 3)
        if a != b:
            raise AssertionError(f"{arch} --reduced: two runs of 3 steps "
                                 f"differ: {a} / {b}")
        res["c"][arch] = a
        log(f"train {arch} --reduced: two runs of 3 steps, losses bitwise "
            f"equal: " + ", ".join(repr(v) for v in a) + f" [{smi}]")
    base_args = ["--arch", LM_TRAIN_ARCH, "--reduced", "--batch", "8",
                 "--seq", "128", "--log-every", "1"]
    whole_run = train_main(base_args + ["--steps", "6"])
    whole = whole_run["losses"]
    with tempfile.TemporaryDirectory() as tmp:
        ck = ["--ckpt-dir", tmp, "--ckpt-every", "4"]
        first = train_main(base_args + ["--steps", "4"] + ck)
        resumed = train_main(base_args + ["--steps", "6"] + ck)
    for r in (whole_run, first, resumed):
        tally_adam(adam_want, f32, compiled_steps(r["compiled"]))
    if (first["losses"] != whole[:4] or resumed["start"] != 4
            or resumed["losses"] != whole[4:]):
        raise AssertionError(f"resume: uninterrupted {whole}, stopped at 4 "
                             f"{first['losses']}, resumed from "
                             f"{resumed['start']} {resumed['losses']}")
    log(f"train {LM_TRAIN_ARCH} --reduced resume: stopped at step 4 by its "
        f"checkpoint, resumed to 6; steps 5-6 "
        + ", ".join(repr(v) for v in resumed["losses"])
        + f" bitwise those of an uninterrupted run [{smi}]")

    n = check_adam_launches("phase 5h", adam_want)
    res["adam_launches"] = main_adam
    res["adam_steps"] = main_steps
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 5h took {res['seconds']:.1f} s; launches {n}: the global "
        f"norm once a step, the fused Adam once a step and parameter dtype, "
        f"no other hand-written kernel (the blocks run the plain scans "
        f"under autograd)")
    return res


# -- phase 5i: the mesh paths ----------------------------------------------------

# The phase's mesh: (data, model) = (4, 2) over the card listed 8 times
# (best_mesh(devices=[card] * 8, model_parallel=2)), and its twin over the
# CPU. A mesh over ranks (one process a card) is phase 5k's; GSPMD over
# several cards in one process is ROADMAP.md Queue 1, "Multi-card GSPMD".
MESH_DEVICES, MESH_MODEL = 8, 2
# (a) the expert-parallel forward at full width and 2 layers in fp32, at a
# capacity that drops nothing (no_drop: the local capacity is then the
# shard's token count, so EP and the sorted path keep every assignment), on
# [8, 32], whose 8 rows split over the 4 data shards; then granite at full
# size in bf16 on [8, 128]
MESH_EP_ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")
MESH_EP_BATCH, MESH_EP_SEQ = 8, 32
# (b) llama3.2-1b at full size as 5h (a), [8, 128] in two microbatches;
# timed steps after the compared one
MESH_TRAIN_ACCUM = 2
MESH_TRAIN_STEPS = 3
# (d) pipeline_forward: 4 stages tanh(x @ w) at llama3.2-1b's width, 8
# microbatches of [4, 128, D]
PIPE_STAGES, PIPE_MICRO, PIPE_D = 4, 8, 2048
PIPE_MB = (4, 128)


def free_card():
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def mesh_ep_forward(arch, mesh, cpu_mesh, dev, rng, merged, ep_calls,
                    smi) -> dict:
    """5i (a) for one config: ``lm_forward`` at full width, 2 layers, fp32,
    ``no_drop``, on [8, 32] under ``mesh`` (the expert-parallel branch),
    under ``cpu_mesh`` on the CPU (the card's choices replayed) and without
    a mesh (the sorted path, the card's choices merged and replayed)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.sharding import AxisRules, use_mesh
    from repro_torch.models.common import count_params, tree_map
    from repro_torch.models.lm import init_lm, lm_forward
    t0 = time.perf_counter()
    dp = mesh.shape["data"]
    rules = AxisRules()
    cfg = no_drop(dataclasses.replace(get_config(arch), dtype="float32",
                                      n_layers=2))
    params = init_lm(SEED, cfg, device=dev)
    n_params = count_params(params)
    cpu_params = tree_map(lambda t: t.to("cpu"), params)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab, (MESH_EP_BATCH, MESH_EP_SEQ))).to(dev)
    ep_calls.clear()
    with torch.no_grad():
        with use_mesh(mesh, rules), RouteLog() as ep_log:
            logits, aux = lm_forward(params, cfg, tokens)
        n_ep = len(ep_calls)
        with use_mesh(cpu_mesh, rules), RouteLog(ep_log.calls) as cpu_log:
            c_logits, c_aux = lm_forward(cpu_params, cfg, tokens.cpu())
        with RouteLog(merged(ep_log.calls)) as s_log:
            s_logits, s_aux = lm_forward(params, cfg, tokens)

        def under_mesh():
            with use_mesh(mesh, rules):
                lm_forward(params, cfg, tokens)
        syncs = host_syncs(under_mesh)
    n_moe = len(s_log.calls)
    if not n_moe or n_ep != n_moe or len(ep_log.calls) != dp * n_moe:
        raise AssertionError(
            f"{arch}: {n_ep} expert-parallel calls and {len(ep_log.calls)} "
            f"router calls for {n_moe} MoE layers")
    flips = [flips_allowed(f"{arch} EP against {what}", *log_.flips(),
                           ROUTE_MARGIN_F32)
             for what, log_ in (("the CPU", cpu_log),
                                ("the sorted path", s_log))]
    errs = {"card_cpu": scaled_err(logits, c_logits),
            "ep_sorted": scaled_err(logits, s_logits),
            "aux_card_cpu": abs(float(aux) - float(c_aux)) / abs(float(c_aux)),
            "aux_ep_sorted": abs(float(aux) - float(s_aux))
            / abs(float(s_aux))}
    if max(errs.values()) > TOL_LM or not torch.isfinite(logits).all():
        raise AssertionError(f"{arch} EP forward: {errs}")
    log(f"mesh (a) {arch} (fp32, full width, 2 layers, {n_params} "
        f"parameters) lm_forward [{MESH_EP_BATCH}, {MESH_EP_SEQ}] under the "
        f"{mesh.shape} mesh: the expert-parallel branch ({n_ep} calls, "
        f"{len(ep_log.calls)} router calls, {dp} a layer); card against CPU "
        f"under its mesh: logits {errs['card_cpu']:.3e}, aux "
        f"{errs['aux_card_cpu']:.3e}; against the sorted path without a "
        f"mesh: logits {errs['ep_sorted']:.3e}, aux "
        f"{errs['aux_ep_sorted']:.3e} (tolerance {TOL_LM}); {flips[0]} (CPU),"
        f" {flips[1]} (sorted); {syncs} host syncs a forward under the mesh; "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")
    return dict(errs, syncs=syncs)


def mesh_ep_timed(mesh, dev, rng, smi) -> dict:
    """5i (a): granite-moe-3b-a800m at full size in bf16, ``lm_forward`` on
    [8, 128] once without a mesh (the sorted path) and once under ``mesh``
    (expert-parallel), each after a warm-up: wall, kernels, device busy,
    peak memory above the weights."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.sharding import AxisRules, use_mesh
    from repro_torch.models.common import count_params
    from repro_torch.models.lm import init_lm, lm_forward
    arch = "granite-moe-3b-a800m"
    cfg = get_config(arch)
    params = init_lm(SEED, cfg, device=dev)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab, (LM_TRAIN_BATCH, LM_TRAIN_SEQ))).to(dev)
    outs, rows = {}, {}
    for name, on in (("sorted", None), ("expert-parallel", mesh)):
        def run():
            with torch.no_grad():
                if on is None:
                    return lm_forward(params, cfg, tokens)
                with use_mesh(on, AxisRules()):
                    return lm_forward(params, cfg, tokens)
        run()
        free_card()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs[name] = run()[0]
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        prof = engine_profile(run, 1)
        if not torch.isfinite(outs[name]).all():
            raise AssertionError(f"{arch} bf16 {name}: logits not finite")
        rows[name] = {"wall_ms": wall, "peak_gib": peak, "profile": prof}
    apart = rel_rms(outs["expert-parallel"], outs["sorted"])
    log(f"time mesh (a) {arch} (full size, bf16, {count_params(params)} "
        f"parameters) lm_forward [{LM_TRAIN_BATCH}, {LM_TRAIN_SEQ}] once "
        f"each: " + "; ".join(
            f"{name}: wall {r['wall_ms']:.3f} ms, "
            f"{r['profile']['kernels_per_step']:.0f} kernels, device busy "
            f"{r['profile']['device_busy_us_per_step']:.1f} us, peak "
            f"{r['peak_gib']:.3f} GiB above the weights"
            for name, r in rows.items())
        + f"; logits {apart:.3e} relative RMS apart (at the capacity factor "
        f"1.25 EP drops by the local token count, by design) [{smi}]")
    return dict(rows, rel_rms=apart)


def mesh_train_step(mesh, dev, smi) -> dict:
    """5i (b): llama3.2-1b at full size, ``make_lm_train_step_fn`` with
    ``grad_accum=2`` and the ZeRO-1 ``accum_rules`` under ``mesh`` against
    the same step without a mesh, from one state and batch; then timed
    steps under the mesh, one profiled."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm_data import lm_batch
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist.sharding import AxisRules, use_mesh
    from repro_torch.ft.checkpoint import tree_paths
    from repro_torch.models.common import count_params
    from repro_torch.models.lm import init_lm
    from repro_torch.train.optim import AdamConfig, constant_schedule
    from repro_torch.train.trainer import (init_train_state,
                                           make_lm_train_step_fn)
    arch = LM_TRAIN_ARCH
    cfg = get_config(arch)
    rules = AxisRules()
    base = torch.cuda.memory_allocated()
    params = init_lm(SEED, cfg, device=dev)
    n_params = count_params(params)
    state0 = init_train_state(params)
    del params
    batch = lm_batch((SEED, 13), cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                     device=dev)
    opt = AdamConfig(schedule=constant_schedule(TRAIN_LR))
    kept = {}

    def keeping(tag, accum_rules):
        def keep(grads):
            kept[tag] = grads
            return grads
        return make_lm_train_step_fn(cfg, opt, grad_transform=keep,
                                     grad_accum=MESH_TRAIN_ACCUM,
                                     accum_rules=accum_rules)
    with use_mesh(mesh, rules):
        new_m, met_m = keeping("mesh", AxisRules())(
            state0, shard_batch(batch, mesh, rules))
    new_p, met_p = keeping("plain", None)(state0, batch)
    same_loss = torch.equal(met_m["loss"], met_p["loss"])
    # The forward is bitwise the gather's, so is every gradient but the
    # embedding's. There the one-hot's backward is a matmul that sums a
    # row's tokens in fp32 and rounds once; the gather's is an index
    # accumulation that adds a repeated token's rows in bf16 one by one.
    # So rows whose token occurs at most once in each microbatch (or never)
    # are held bitwise, the repeated ones are measured; the parameters are
    # held within Adam's first-step bound of the measured difference.
    counts = torch.stack([torch.bincount(t.flatten(), minlength=cfg.vocab)
                          for t in batch["tokens"].chunk(MESH_TRAIN_ACCUM)])
    single = counts.max(0).values <= 1
    scale = min(1.0, 1.0 / (float(met_p["grad_norm"]) + 1e-9))
    excess, differ, rep_err = -float("inf"), [], 0.0
    for (path, g), (_, gp), (_, pm), (_, pp) in zip(
            tree_paths(kept["mesh"]), tree_paths(kept["plain"]),
            tree_paths(new_m.params), tree_paths(new_p.params)):
        top = float(gp.abs().max())
        delta = TOL_LM_TRAIN_GRAD * top
        if path == "embedding":
            diff = (g - gp).abs()
            if float(diff[single].max()) > 0:
                differ.append(path + " (single rows)")
            rep_err = float(diff.max()) / top
            delta = max(delta, float(diff.max()))
            del diff
        elif not torch.equal(g, gp):
            differ.append(path)
        excess = max(excess, adam_first_step_excess(pm, pp, gp, delta, scale,
                                                    TRAIN_LR))
    report = (f"train {arch} (full size, bf16, remat, {n_params} "
              f"parameters) make_lm_train_step_fn(grad_accum="
              f"{MESH_TRAIN_ACCUM}, accum_rules=AxisRules()) on "
              f"[{LM_TRAIN_BATCH}, {LM_TRAIN_SEQ}] under the {mesh.shape} "
              f"mesh (one-hot embedding) against the step without a mesh: "
              f"loss {float(met_m['loss'])!r} / {float(met_p['loss'])!r} "
              f"({'bitwise' if same_loss else 'not bitwise'}); every "
              f"gradient bitwise (differing: {differ or 'none'}) but the "
              f"embedding's {int((~single).sum())} rows of repeated tokens, "
              f"{rep_err:.3e} of its largest apart there (the gather's bf16 "
              f"accumulation); parameters within Adam's first-step bound of "
              f"that with {-excess:.3e} to spare")
    if not same_loss or differ or excess > 0:
        raise AssertionError(report)
    log(report + f" [{smi}]")
    del kept, new_p, state0, met_p, met_m
    free_card()

    step = make_lm_train_step_fn(cfg, opt, grad_accum=MESH_TRAIN_ACCUM,
                                 accum_rules=AxisRules())
    state = {"s": new_m}
    del new_m
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    with use_mesh(mesh, rules):
        placed = shard_batch(batch, mesh, rules)
        for _ in range(MESH_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state["s"], m = step(state["s"], placed)
            losses.append(float(m["loss"]))
            walls.append(1e3 * (time.perf_counter() - t0))
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30

        def one_step():
            state["s"], mm = step(state["s"], placed)
            float(mm["loss"])
        prof = engine_profile(one_step, 1)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{arch} mesh steps: losses {losses}")
    p50 = float(np.median(walls))
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    log(f"time train {arch} under the {mesh.shape} mesh (grad_accum "
        f"{MESH_TRAIN_ACCUM}, ZeRO-1 accumulator, one-hot embedding): "
        f"{MESH_TRAIN_STEPS} steps on one batch, losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f"; wall p50 {p50:.3f} ms (each "
        + ", ".join(f"{v:.3f}" for v in walls)
        + f"), {1e3 * tokens / p50:.1f} tokens/s; profiled step: "
        f"{prof['kernels_per_step']:.1f} kernels, device busy "
        f"{prof['device_busy_us_per_step']:.1f} us, idle share "
        f"{prof['idle_share']:.4f}; peak memory {peak:.3f} GiB above the "
        f"{base} B held before the model [{smi}]")
    return {"embedding_err": rep_err, "step_ms": walls, "p50_ms": p50,
            "peak_gib": peak, "profile": prof,
            "adam_steps": 2 + MESH_TRAIN_STEPS + 1}


def mesh_pipeline(dev, smi) -> dict:
    """5i (d): ``pipeline_forward`` over ``PIPE_STAGES`` stages on the card
    listed that many times, against the stages applied in turn on the card
    (bitwise) and the pipeline on the CPU (``TOL_F32``)."""
    import numpy as np
    import torch
    from repro_torch.dist.elastic import Mesh
    from repro_torch.dist.pipeline import pipeline_forward, split_microbatches
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ws = torch.randn(PIPE_STAGES, PIPE_D, PIPE_D, generator=gen,
                     device=dev) * PIPE_D ** -0.5
    xs = split_microbatches(torch.randn(
        PIPE_MICRO * PIPE_MB[0], PIPE_MB[1], PIPE_D, generator=gen,
        device=dev), PIPE_MICRO)

    def stage(w, xm):
        return torch.tanh(xm @ w)

    def in_turn():
        outs = []
        for m in range(PIPE_MICRO):
            y = xs[m]
            for s in range(PIPE_STAGES):
                y = stage(ws[s], y)
            outs.append(y)
        return torch.stack(outs)

    def over(device):
        return Mesh(np.array([device] * PIPE_STAGES, dtype=object),
                    ("stage",))
    fwd = pipeline_forward(stage, over(dev), "stage", PIPE_MICRO)
    got, want = fwd(ws, xs), in_turn()
    cpu_got = pipeline_forward(stage, over(torch.device("cpu")), "stage",
                               PIPE_MICRO)(ws.cpu(), xs.cpu())
    err = scaled_err(got, cpu_got)
    if not torch.equal(got, want) or err > TOL_F32:
        raise AssertionError(f"pipeline_forward: bitwise the stages in turn "
                             f"{torch.equal(got, want)}, against the CPU "
                             f"{err:.3e}")
    walls = {}
    for name, fn in (("pipeline", lambda: fwd(ws, xs)), ("in turn", in_turn)):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        walls[name] = float(np.median(ts))
    log(f"mesh (d) pipeline_forward: {PIPE_STAGES} stages tanh(x @ w) at D "
        f"= {PIPE_D} on the card listed {PIPE_STAGES} times, {PIPE_MICRO} "
        f"microbatches of [{PIPE_MB[0]}, {PIPE_MB[1]}, {PIPE_D}] fp32: "
        f"bitwise the stages applied in turn on the card, {err:.3e} from the "
        f"CPU (tolerance {TOL_F32}); wall (median of 3) "
        f"{walls['pipeline']:.3f} ms over {PIPE_MICRO + PIPE_STAGES - 1} "
        f"ticks, in turn {walls['in turn']:.3f} ms [{smi}]")
    return {"cpu_err": err, "walls_ms": walls}


def mesh_phase(dev, smi) -> dict:
    """Phase 5i: the mesh paths on a (4, 2) mesh over the card listed 8
    times (and its twin over the CPU). (a) ``mesh_ep_forward`` for
    granite-moe-3b-a800m and deepseek-v2-lite-16b: the expert-parallel
    branch, 4 router calls a layer, card against CPU and against the
    sorted path within ``TOL_LM``, choices replayed (``RouteLog``, flips
    within ``ROUTE_MARGIN_F32``); ``mesh_ep_timed``, granite at full size
    in bf16 under the mesh once beside the sorted path. (b)
    ``mesh_train_step``: llama3.2-1b at full size, the mesh step's loss
    bitwise the plain step's (the one-hot embedding picks its rows
    exactly), gradients within ``TOL_LM_TRAIN_GRAD`` of each leaf's
    largest, parameters within Adam's first-step bound; timed steps. (c)
    One granite-moe-3b-a800m step (fp32, full width, 2 layers, [8, 32])
    under the mesh, card against CPU (``lm_step_against_cpu``), every
    expert a layer routed a token to with a nonzero gradient there. (d)
    ``mesh_pipeline``. (e) ``launch.train --model-parallel 2 --reduced``
    repeats ``--model-parallel 1``'s losses bitwise, both through the
    launcher's compiled step; ``prefetch_to_mesh`` puts batches on the card
    with the reference's spec. The only hand-written kernels launched are
    the global norm, once a step (eager or compiled), and the fused Adam,
    once a step and parameter dtype.
    Returns the numbers."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm_data import lm_batch_stream
    from repro_torch.data.pipeline import prefetch_to_mesh
    from repro_torch.dist.elastic import best_mesh
    from repro_torch.dist.sharding import AxisRules
    from repro_torch.ft.checkpoint import tree_paths
    from repro_torch.kernels import ops
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import moe_ep

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    adam_want = {}
    mesh = best_mesh(devices=[dev] * MESH_DEVICES, model_parallel=MESH_MODEL)
    cpu_mesh = best_mesh(devices=[torch.device("cpu")] * MESH_DEVICES,
                         model_parallel=MESH_MODEL)
    if mesh.shape != {"data": 4, "model": 2}:
        raise AssertionError(f"best_mesh gave {mesh.shape}")
    dp = mesh.shape["data"]
    rng = np.random.default_rng(SEED + 24)
    res = {}
    ep_calls = []
    orig_ep = moe_ep.moe_apply_ep

    def counted(*a, **kw):
        ep_calls.append(1)
        return orig_ep(*a, **kw)

    def merged(calls):
        """The expert-parallel choices as the sorted path's: one [T, K] a
        layer, the data shards' rows in order."""
        return [torch.cat(calls[i:i + dp]) for i in range(0, len(calls), dp)]

    moe_ep.moe_apply_ep = counted
    try:
        res["a"] = {arch: mesh_ep_forward(arch, mesh, cpu_mesh, dev, rng,
                                          merged, ep_calls, smi)
                    for arch in MESH_EP_ARCHS}
        free_card()
        res["a"]["bf16"] = mesh_ep_timed(mesh, dev, rng, smi)
        free_card()
        res["b"] = mesh_train_step(mesh, dev, smi)
        tally_adam(adam_want, {torch.bfloat16}, res["b"]["adam_steps"])
        free_card()

        # (c) the MoE mesh train step, card against CPU
        arch = "granite-moe-3b-a800m"
        cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                  n_layers=2)
        fed = {}

        def experts_fed(grads, calls):
            """Every expert a layer's forward routed a token to has a
            nonzero gradient in that layer's slice of each expert leaf
            (the forward's choices: the first ``dp`` calls a layer)."""
            for path, g in tree_paths(grads):
                if "experts_" not in path:
                    continue
                for layer in range(cfg.n_layers):
                    used = torch.unique(torch.cat(
                        calls[layer * dp:(layer + 1) * dp]).flatten())
                    zero = [int(e) for e in used
                            if not float(g[layer, e].abs().max()) > 0]
                    if zero:
                        raise AssertionError(f"{arch} EP: zero gradients of "
                                             f"{path} layer {layer} experts "
                                             f"{zero}")
                    fed[(path, layer)] = int(used.numel())
        ep_calls.clear()
        res["c"] = lm_step_against_cpu(
            f"{arch} (n_layers=2, full width)", cfg, dev, smi,
            meshes=(mesh, cpu_mesh), shape=(MESH_EP_BATCH, MESH_EP_SEQ),
            on_card=experts_fed)
        tally_adam(adam_want, res["c"]["dtypes"], 1)
        if len(ep_calls) < 2 * cfg.n_layers or not fed:
            raise AssertionError(f"{arch} mesh step: {len(ep_calls)} "
                                 f"expert-parallel calls, {len(fed)} leaves")
        log(f"train {arch} mesh step: {len(ep_calls)} expert-parallel calls "
            f"(card and CPU, remat's recompute included); nonzero gradients "
            f"on every fed expert of {len(fed)} leaf layers ("
            + ", ".join(sorted({str(v) for v in fed.values()}))
            + " experts fed a layer)")
        free_card()
    finally:
        moe_ep.moe_apply_ep = orig_ep

    res["d"] = mesh_pipeline(dev, smi)
    free_card()

    # (e) the launcher's mesh flag and the mesh-placed batches
    args = ["--arch", LM_TRAIN_ARCH, "--reduced", "--steps", "3", "--batch",
            "8", "--seq", "128", "--log-every", "1", "--device", dev.type]
    runs = [train_main(args + ["--model-parallel", k]) for k in "12"]
    for r in runs:
        tally_adam(adam_want, {torch.float32}, compiled_steps(r["compiled"]))
    one, two = (r["losses"] for r in runs)
    if one != two or len(one) != 3:
        raise AssertionError(f"--model-parallel 2 {two} against 1 {one}")
    cfg = get_config(LM_TRAIN_ARCH).reduced()
    stream = prefetch_to_mesh(lm_batch_stream((1, 0), cfg, 8, 128,
                                              device=dev), mesh, AxisRules())
    # the reference's shard_batch spec on a (data, model) mesh: the batch
    # dim on "data", the rest replicated
    for _ in range(2):
        b = next(stream)["tokens"]
        if (b.device.type != dev.type or b.sharding.mesh is not mesh
                or tuple(b.sharding.spec) != ("data", None)):
            raise AssertionError(f"prefetch_to_mesh: {b.device} "
                                 f"{b.sharding.spec}")
    stream.close()
    for _ in stream:
        pass
    res["e"] = one
    log(f"mesh (e) launch.train --reduced --model-parallel 2 (one card: "
        f"mesh {{'data': 1, 'model': 1}}) repeats --model-parallel 1 "
        f"bitwise: " + ", ".join(repr(v) for v in two) + "; "
        f"prefetch_to_mesh batches on {dev} with spec ('data', None) "
        f"[{smi}]")

    n = check_adam_launches("phase 5i", adam_want)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 5i took {res['seconds']:.1f} s; launches {n}: the global "
        f"norm once a step, the fused Adam once a step and parameter dtype, "
        f"no other hand-written kernel")
    return res


# -- phase 5k: the mesh paths over ranks ------------------------------------

# (a) llama3.2-1b's compiled step at full size over the ranks, [8, 128] as
# 5h; (b) the expert-parallel exchange at granite's full width, 2 layers,
# fp32, [8, 32]; (c) the launcher under torchrun, 3 --reduced steps
RANK_STEPS = 3
RANK_EP_ARCH = "granite-moe-3b-a800m"
RANK_EP_LAYERS = 2
RANK_EP_SHAPE = (8, 32)
RANK_LAUNCH = ["--arch", LM_TRAIN_ARCH, "--reduced", "--steps", "3",
               "--batch", "8", "--seq", "32", "--log-every", "1"]
RANK_LAUNCH_TIMEOUT_S = 300
RANK_SPAWN_TIMEOUT_S = 900
# at world > 1: the launcher's fp32 losses, as the CPU rank tests hold
# them; the bf16 step's losses and clip norms (the ranks' matmuls over
# 1 / world of the rows round their bf16 gradients once a rank, and the
# reduction adds them in bf16 at each hop, as the reference's psum adds
# bf16 gradients: four cards gave 9.3e-5 between the losses and 3.5e-3
# between the first step's clip norms). The clip norm is what a wrong
# scale of the reduction moves (by the data extent), which Adam's update
# hides from the losses.
TOL_RANK_REL = 1e-5
TOL_RANK_BF16_REL = 1e-3
TOL_RANK_NORM_REL = 1e-2
# (e)'s losses after the first step. The first is the forward alone and
# keeps TOL_RANK_BF16_REL (four cards, tools/split_gap.py over 4 seeds:
# within 1e-4 split or not). Adam's first update, lr times the gradient's
# sign, turns the ranks' bf16 sums into later losses that differ by more,
# split or not: at steps 2 and 3 the data-parallel (4, 1) step reached
# 1.0e-3, the split (2, 2) and (1, 4) steps 1.9e-3 and 2.9e-3, granite's
# (2, 2) 1.9e-3; the bound is 1.75 times the largest.
TOL_RANK_SPLIT_STEP_REL = 5e-3


def new_in(prof: dict, base: dict) -> dict:
    """The device work a profiled replay has that ``base``'s has not:
    kernel or copy name -> launches a step more."""
    return {k: v - base["by_name"].get(k, 0) for k, v in
            prof["by_name"].items() if v > base["by_name"].get(k, 0)}


def rank_train(dev, smi) -> dict:
    """5k (a): llama3.2-1b at full size in bf16, ``make_lm_train_step(...,
    donate=True)`` on [8, 128] under the mesh over the ranks, against the
    same compiled step in one process under a (1, 1) mesh that lists the
    card, from one state and batch: ``RANK_STEPS`` steps each, every metric
    and then the whole state (parameters and moments, after one more
    profiled step each) bitwise at world 1 (the average over one rank is
    exact); at world > 1 every loss within ``TOL_RANK_BF16_REL`` relative,
    every clip norm within ``TOL_RANK_NORM_REL`` and the ranks' states
    bitwise equal. The first rank call's peak memory (the warm-up's
    eager step and the capture, the state and batch counted, other memory
    not) beside ``dryrun.run_cell``'s per-device peak at the same shape on
    a (1, 1) mesh; the profiled replay's NCCL work, as the nodes it has
    that the one-process replay has not."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm_data import lm_batch
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist import ranks
    from repro_torch.dist.elastic import best_mesh
    from repro_torch.dist.sharding import (P, AxisRules, NamedSharding,
                                           device_put, use_mesh)
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models.lm import init_lm
    from repro_torch.train.optim import (AdamConfig, constant_schedule,
                                         tree_leaves as leaves, tree_map)
    from repro_torch.train.trainer import (init_train_state,
                                           make_lm_train_step)
    world, rank = dist.get_world_size(), dist.get_rank()
    cfg = get_config(LM_TRAIN_ARCH)
    rules = AxisRules()
    opt = AdamConfig(schedule=constant_schedule(TRAIN_LR))
    ops.reset_launch_counts()
    adam_want = {}
    state_r = init_train_state(init_lm(SEED, cfg, device=dev))
    grad_dtypes = {t.dtype for t in leaves(state_r.params)}
    state_p = tree_map(torch.clone, state_r)
    batch = lm_batch((SEED, 13), cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                     device=dev)
    meshes = {"rank": best_mesh(), "one": best_mesh(devices=[dev])}
    steps = {k: make_lm_train_step(cfg, opt, donate=True) for k in meshes}
    states = {"rank": state_r, "one": state_p}
    del state_r, state_p
    placed = {k: shard_batch(batch, m, rules) for k, m in meshes.items()}
    states["rank"] = device_put(states["rank"],
                                NamedSharding(meshes["rank"], P()))
    walls = {k: [] for k in meshes}
    metrics = {k: [] for k in meshes}
    peak = {}
    before = dict(ranks.COLLECTIVES)
    for i in range(RANK_STEPS):
        for k in ("rank", "one"):
            with use_mesh(meshes[k], rules):
                if i == 0:
                    # the first call's peak: the warm-up's eager step and
                    # the capture, with the step's state and batch and
                    # without the other memory held
                    args = sum(t.numel() * t.element_size() for t in
                               leaves(states[k]) + leaves(placed[k]))
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    other = torch.cuda.memory_allocated() - args
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                states[k], m = steps[k](states[k], placed[k])
                float(m["loss"])
                walls[k].append(1e3 * (time.perf_counter() - t0))
                if i == 0:
                    peak[k] = torch.cuda.max_memory_allocated() - other
            metrics[k].append(m)
    profs = {}
    for k in ("one", "rank"):
        with use_mesh(meshes[k], rules):
            def replay(k=k):
                states[k], mm = steps[k](states[k], placed[k])
                float(mm["loss"])
            profs[k] = engine_profile(replay, 1, match=("nccl",))
        walls[k].append(profs[k]["wall_us_per_step"] / 1e3)
    issued = {k: v - before[k] for k, v in ranks.COLLECTIVES.items() if v
              - before[k]}
    extra = new_in(profs["rank"], profs["one"])
    extra_us = (profs["rank"]["device_busy_us_per_step"]
                - profs["one"]["device_busy_us_per_step"])
    nccl = {k: v for k, v in profs["rank"]["by_name"].items()
            if "nccl" in k.lower()}
    nccl_us = profs["rank"]["match_us_by"]["nccl"]
    losses = {k: [float(m["loss"]) for m in v] for k, v in metrics.items()}
    if world == 1:
        same_metrics = all(torch.equal(a[key], b[key])
                           for a, b in zip(metrics["rank"], metrics["one"])
                           for key in a)
        same_state = state_bitwise(states["rank"], states["one"])
        ok = same_metrics and same_state
        how = (f"every metric of the {RANK_STEPS} steps bitwise "
               f"{same_metrics}, the state after the profiled step bitwise "
               f"{same_state}")
    else:
        tols = {"loss": TOL_RANK_BF16_REL, "grad_norm": TOL_RANK_NORM_REL}
        gaps = {key: [abs(float(a[key]) - float(b[key])) / abs(float(b[key]))
                      for a, b in zip(metrics["rank"], metrics["one"])]
                for key in tols}
        near = all(g <= tols[k] for k, v in gaps.items() for g in v)
        flat = torch.cat([t.float().reshape(-1)[:4096]
                          for t in leaves(states["rank"])])
        first = flat.clone()
        ranks.broadcast_(first, 0)
        replicas = torch.equal(flat, first)
        ok = near and replicas and all(np.isfinite(losses["rank"]))
        norms = {k: [float(m["grad_norm"]) for m in v]
                 for k, v in metrics.items()}
        how = (f"every loss and clip norm of the {RANK_STEPS} steps within "
               f"{TOL_RANK_BF16_REL} and {TOL_RANK_NORM_REL} relative {near} "
               f"(relative gaps {gaps}; "
               f"one process's losses {losses['one']}, clip norms "
               f"{norms['one']} against {norms['rank']}), the ranks' "
               f"states bitwise equal {replicas}")
    for k in meshes:
        tally_adam(adam_want, {torch.bfloat16},
                   compiled_steps(steps[k].stats))
    launches = check_adam_launches("phase 5k (a)", adam_want)
    captures = {k: dict(v.stats) for k, v in steps.items()}
    # (d) holds its sharded steps to the one-process step's metrics and
    # state after the same steps from the same state and batch
    one = {"metrics": metrics["one"], "state": states["one"],
           "batch": batch}
    del states, steps, placed, metrics
    free_card()
    # the dry-run's estimate of the same step on a (1, 1) mesh
    rec = dryrun.run_cell(LM_TRAIN_ARCH, ShapeConfig(
        "train_8x128", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train"),
        mesh=best_mesh(devices=[dev]), grad_accum=1)
    if not rec["ok"]:
        raise AssertionError(f"dryrun.run_cell: {rec['error']}")
    mem = rec["memory"]
    est = mem["argument_bytes"] + mem["peak_live_bytes_per_device"]
    report = (f"train {LM_TRAIN_ARCH} (full size, bf16) make_lm_train_step("
              f"donate=True) on [{LM_TRAIN_BATCH}, {LM_TRAIN_SEQ}] over "
              f"{world} rank(s), mesh {meshes['rank'].shape} (rank {rank}, "
              f"NCCL), against the one-process compiled step under a (1, 1) "
              f"mesh: {how}; losses " + ", ".join(
                  repr(v) for v in losses["rank"]))
    if not ok:
        raise AssertionError(report)
    # the collectives are in the capture: the warm-up's and the capture's
    # all-reduce of each bucket (one a gradient dtype, the fp32 metrics in
    # their own where no gradient is fp32) issued, nothing at a replay;
    # over several ranks NCCL's kernels run in each replay (over one rank
    # its in-place all-reduce moves nothing, and launches nothing)
    buckets = len(grad_dtypes | {torch.float32})
    if issued != {"all_reduce": 2 * buckets} or (world > 1 and not nccl):
        raise AssertionError(f"the rank step's collectives: issued {issued}, "
                             f"NCCL kernels in its replay {nccl}")
    out = {"world": world, "losses": losses["rank"],
           "p50_ms": {k: float(np.median(v[1:])) for k, v in walls.items()},
           "walls_ms": walls,
           "peak_gib": {k: v / 2 ** 30 for k, v in peak.items()},
           "dryrun_gib": est / 2 ** 30, "dryrun_argument_gib":
           mem["argument_bytes"] / 2 ** 30, "dryrun_live_gib":
           mem["peak_live_bytes_per_device"] / 2 ** 30,
           "nccl_kernels": nccl, "nccl_us": nccl_us,
           "extra_nodes": extra, "extra_busy_us": extra_us,
           "kernels": {k: p["kernels_per_step"] for k, p in profs.items()},
           "busy_us": {k: p["device_busy_us_per_step"]
                       for k, p in profs.items()},
           "issued": issued, "launches": launches, "captures": captures,
           "one": one}
    log(report + f" [{smi}]")
    log(f"rank (a) the captured rank step's replay: NCCL kernels "
        f"{nccl or 'none'} ({nccl_us:.1f} us a step); the device work it has "
        f"beyond the one-process replay's (the buckets' copies, NCCL's "
        f"kernels and, over several ranks, the matmuls of 1 / world of the "
        f"rows): {extra}, busy {extra_us:.1f} us more a step; kernels a "
        f"step {out['kernels']}; collectives issued from the host {issued} "
        f"(the warm-up's and the capture's) [{smi}]")
    log(f"time rank (a) wall p50 of the replays (steps 2-{RANK_STEPS} and the "
        f"profiled one): over the ranks {out['p50_ms']['rank']:.3f} ms, one "
        f"process {out['p50_ms']['one']:.3f} ms (each: rank "
        + ", ".join(f"{v:.3f}" for v in walls["rank"]) + "; one "
        + ", ".join(f"{v:.3f}" for v in walls["one"])
        + f"); device busy {out['busy_us']['rank']:.1f} / "
        f"{out['busy_us']['one']:.1f} us a step [{smi}]")
    pk = out["peak_gib"]
    log(f"rank (a) memory: the measured peak of the first call (the "
        f"warm-up's eager step and the capture, with the state and batch, "
        f"{args / 2 ** 30:.3f} GiB) over the rank(s) {pk['rank']:.3f} GiB, "
        f"in one process {pk['one']:.3f} GiB, against dryrun.run_cell's "
        f"per-device peak {out['dryrun_gib']:.3f} GiB (arguments "
        f"{out['dryrun_argument_gib']:.3f} + live "
        f"{out['dryrun_live_gib']:.3f}) on a (1, 1) mesh: ratio measured / "
        f"estimate {pk['rank'] / out['dryrun_gib']:.4f} over the ranks, "
        f"{pk['one'] / out['dryrun_gib']:.4f} in one process [{smi}]")
    return out


def rank_exchange(dev, smi) -> dict:
    """5k (b): ``moe_apply_ep`` at granite-moe-3b-a800m's full width (its
    first MoE layer of a 2-layer fp32 model) on [8, 32] over the mesh of
    all the ranks on the experts axis (at world 1 the (1, 1) mesh, where
    the all-to-all runs on one rank), against the one-process loop on the
    same mesh shape listing the card: output and aux bitwise, the
    collectives of the exchange counted."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import ranks
    from repro_torch.dist.elastic import best_mesh
    from repro_torch.dist.sharding import AxisRules, use_mesh
    from repro_torch.ft.checkpoint import tree_paths
    from repro_torch.models.lm import init_lm
    from repro_torch.models.moe_ep import moe_apply_ep
    world = dist.get_world_size()
    cfg = dataclasses.replace(get_config(RANK_EP_ARCH), dtype="float32",
                              n_layers=RANK_EP_LAYERS)
    params = init_lm(SEED, cfg, device=dev)
    path = next(p for p, _ in tree_paths(params) if p.endswith("/router"))
    node = params
    for key in path.split("/")[:-1]:
        node = node[int(key) if isinstance(node, list) else key]
    moe = {k: v[0] for k, v in node.items() if isinstance(v, torch.Tensor)}
    del params
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(*RANK_EP_SHAPE, cfg.d_model, generator=gen, device=dev)
    rules = AxisRules()
    meshes = {"rank": best_mesh(model_parallel=world),
              "one": best_mesh(devices=[dev] * world, model_parallel=world)}
    out, walls = {}, {}
    for k, mesh in meshes.items():
        with use_mesh(mesh, rules):
            before = dict(ranks.COLLECTIVES)
            y, aux = moe_apply_ep(moe, x, top_k=cfg.top_k,
                                  capacity_factor=cfg.capacity_factor,
                                  activation=cfg.activation)
            torch.cuda.synchronize()
            issued = {n: v - before[n] for n, v in ranks.COLLECTIVES.items()
                      if v - before[n]}
            ts = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                moe_apply_ep(moe, x, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor,
                             activation=cfg.activation)
                torch.cuda.synchronize()
                ts.append(1e3 * (time.perf_counter() - t0))
        out[k] = (y, aux, issued)
        walls[k] = float(np.median(ts))
    (y_r, aux_r, issued), (y_p, aux_p, none) = out["rank"], out["one"]
    same = torch.equal(y_r, y_p) and torch.equal(aux_r, aux_p)
    want = {"all_to_all": 2, "all_reduce": 3}
    report = (f"rank (b) moe_apply_ep {RANK_EP_ARCH} (full width, D = "
              f"{cfg.d_model}, {moe['router'].shape[-1]} experts, top "
              f"{cfg.top_k}, fp32) on [{RANK_EP_SHAPE[0]}, "
              f"{RANK_EP_SHAPE[1]}] over the {meshes['rank'].shape} mesh of "
              f"{world} rank(s): output and aux bitwise the one-process loop "
              f"{same}; collectives issued {issued} (want {want}: the two "
              f"exchanges, the router statistics' two sums and the token "
              f"slices' sum), one-process {none or 'none'}; wall (median of "
              f"5) {walls['rank']:.3f} ms, one process {walls['one']:.3f} ms")
    if not same or issued != want or none:
        raise AssertionError(report)
    log(report + f" [{smi}]")
    return {"issued": issued, "walls_ms": walls}


# (d) the train state sharded over the ranks as the reference lays it out:
# llama3.2-1b at full size under FSDP and ZeRO-1 on the (world, 1) mesh of
# all ranks, and over four cards llama-3.2-vision-11b, whose state fits no
# one card, under FSDP at (4, 1); the meshes with a model axis are (e)'s
RANK_LAYOUTS = ("fsdp", "zero1")
RANK_VLM_ARCH = "llama-3.2-vision-11b"


def sharded_steps(cfg, mesh, layout, batch, dev, one=None) -> dict:
    """``RANK_STEPS`` compiled steps of ``cfg`` (``make_lm_train_step_fn``
    with ``state_sharding``, donated) from ``launch.train.init_state``'s
    state under ``layout`` on ``mesh`` (over the ranks), then one profiled
    replay: the state's bytes on this rank beside the whole and the
    replicated leaves', whether every leaf is the block its spec gives,
    the first call's peak, the collectives issued at each call, the walls,
    the profile and the metrics; with ``one`` (5k (a)'s one-process step
    from the same state and batch), the metrics against its and, at world
    1, the state too."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist import ranks
    from repro_torch.dist.sharding import (AxisRules, block_shape,
                                           sharded_dims, use_mesh)
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import RULE_VARIANTS
    from repro_torch.launch.train import init_state
    from repro_torch.train.optim import (AdamConfig, constant_schedule,
                                         tree_leaves as leaves)
    from repro_torch.train.trainer import (CompiledTrainStep,
                                           make_lm_train_step_fn)
    rules = AxisRules()
    # ZeRO-1 is the dry-run's variant: the parameters' rules only differ
    param_rules = (rules.with_overrides(**RULE_VARIANTS["zero1"])
                   if layout == "zero1" else rules)
    opt = AdamConfig(schedule=constant_schedule(TRAIN_LR))
    world = dist.get_world_size()
    free_card()
    with use_mesh(mesh, rules):
        t0 = time.perf_counter()
        state, st_sh = init_state(cfg, SEED, dev, mesh, param_rules, rules)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        abstract = specs.abstract_train_state(cfg)
        trip = list(zip(leaves(state), leaves(abstract), leaves(st_sh)))
        held = sum(t.numel() * t.element_size() for t in leaves(state))
        whole = sum(a.numel() * a.element_size() for a in leaves(abstract))
        repl = sum(a.numel() * a.element_size() for _, a, sh in trip
                   if not sharded_dims(sh.spec, mesh))
        # a leaf spread over fewer ranks than the world (a dim the mesh's
        # extent does not divide stays whole): its block's bytes beyond a
        # 1 / world share
        uneven = sum(
            t.numel() * t.element_size() - a.numel() * a.element_size()
            / world for t, a, sh in trip
            if sharded_dims(sh.spec, mesh) and math.prod(
                mesh.shape[n] for _, ns in sharded_dims(sh.spec, mesh)
                for n in ns) < world)
        blocks = all(tuple(t.shape) == block_shape(a.shape, sh.spec, mesh)
                     for t, a, sh in trip)
        share = specs.per_device_bytes(abstract, st_sh)
        del abstract, trip
        step = CompiledTrainStep(make_lm_train_step_fn(
            cfg, opt, state_sharding=st_sh), donate=True)
        placed = shard_batch(batch, mesh, rules)
        args = held + sum(t.numel() * t.element_size()
                          for t in placed.values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        other = torch.cuda.memory_allocated() - args
        walls, metrics, issued = [], [], []
        for i in range(RANK_STEPS):
            before = dict(ranks.COLLECTIVES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, placed)
            float(m["loss"])
            walls.append(1e3 * (time.perf_counter() - t0))
            if i == 0:
                peak = torch.cuda.max_memory_allocated() - other
            issued.append({k: v - before[k] for k, v in
                           ranks.COLLECTIVES.items() if v - before[k]})
            metrics.append(m)

        def replay():
            nonlocal state
            state, mm = step(state, placed)
            float(mm["loss"])
        before = dict(ranks.COLLECTIVES)
        prof = engine_profile(replay, 1, match=("nccl",))
        issued.append({k: v - before[k] for k, v in
                       ranks.COLLECTIVES.items() if v - before[k]})
        walls.append(prof["wall_us_per_step"] / 1e3)
    per_rank = [None] * world
    dist.all_gather_object(per_rank, held)
    replicas = world == 1 or replicas_equal(state, st_sh, mesh)
    out = {"arch": cfg.name, "layout": layout, "mesh": mesh.shape,
           "replicas": replicas,
           "held": held, "held_by_rank": per_rank, "whole": whole,
           "replicated": repl, "uneven": uneven, "share": share,
           "blocks": blocks, "peak": peak,
           "init_s": init_s, "walls_ms": walls,
           "p50_ms": float(np.median(walls[1:])),
           "busy_us": prof["device_busy_us_per_step"],
           "idle": idle_share(prof), "nccl_us": prof["match_us_by"]["nccl"],
           "kernels": prof["kernels_per_step"], "issued": issued,
           "captures": dict(step.stats),
           "losses": [float(m["loss"]) for m in metrics],
           "norms": [float(m["grad_norm"]) for m in metrics]}
    if one is not None and world == 1:
        out["same_metrics"] = all(
            torch.equal(a[k], b[k]) for a, b in zip(metrics, one["metrics"])
            for k in a)
        out["same_state"] = state_bitwise(state, one["state"])
    elif one is not None:
        ref = {k: [float(m[k]) for m in one["metrics"]]
               for k in ("loss", "grad_norm")}
        out["gaps"] = {k: [abs(a - b) / abs(b) for a, b in zip(
            out["losses" if k == "loss" else "norms"], ref[k])]
            for k in ref}
    del state, step, placed, metrics
    free_card()
    return out


def replicas_equal(state, st_sh, mesh) -> bool:
    """Whether the ranks that hold the same block of a leaf of ``state``
    (laid out by ``st_sh`` on ``mesh``, over the ranks) hold it bitwise
    alike: each block's bits summed plain and weighted by position (int64)
    on the card, gathered to every rank beside its coordinates on the
    leaf's sharded axes, and compared within each set of ranks that share
    them."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist.sharding import sharded_dims
    from repro_torch.train.optim import tree_leaves as leaves
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    at = mesh.coords()
    keys, prints = [], []
    for t, sh in zip(leaves(state), leaves(st_sh)):
        axes = sorted({n for _, ns in sharded_dims(sh.spec, mesh)
                       for n in ns})
        keys.append(tuple(at[a] for a in axes))
        bits = t.detach().reshape(-1).view(ints[t.element_size()]).to(
            torch.int64)
        weight = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        prints.append(torch.stack([bits.sum(), (bits * weight).sum()]))
        del bits, weight
    mine = (keys, torch.stack(prints).cpu().tolist())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    for i in range(len(keys)):
        seen = {}
        for k, p in every:
            if seen.setdefault(k[i], p[i]) != p[i]:
                return False
    return True


def check_sharded(r: dict, world: int, tag: str = "d") -> str:
    """``sharded_steps``' checks, raising on the first that fails; the
    line that reports them (phase 5k ``tag``)."""
    first, later = r["issued"][0], r["issued"][1:]
    # the warm-up's eager step and the capture issue the same collectives;
    # a replay issues none
    captured = bool(first) and all(v % 2 == 0 for v in first.values()) and (
        not any(later))
    # a gather a sharded leaf; a reduce-scatter a leaf the data axis
    # shards; where model splits the work, the row-parallel weights' swap
    moved = world == 1 or (
        first.get("all_gather", 0) > 0
        and (r["mesh"]["data"] == 1 or first.get("reduce_scatter", 0) > 0)
        and (r["mesh"]["model"] == 1 or first.get("all_to_all", 0) > 0))
    if world == 1:
        # every extent is 1: the step is the replicated one, whose two
        # buckets (bf16 gradients, fp32 metrics) are all-reduced
        moved = first == {"all_reduce": 4}
    # the bytes the layout gives a rank (``specs.per_device_bytes``), and
    # under FSDP at most a 1 / world share of the leaves it shards over
    # every rank (``uneven``: the rest's bytes beyond that share)
    bound = r["held"] == r["share"] and (
        r["layout"] != "fsdp" or r["held"] <= r["whole"] / world
        + r["replicated"] + r["uneven"])
    near = True
    if "same_metrics" in r:
        near = r["same_metrics"] and r["same_state"]
        how = (f"metrics of the {RANK_STEPS} steps bitwise the one-process "
               f"compiled step {r['same_metrics']}, the state after the "
               f"profiled step bitwise {r['same_state']}")
    elif "gaps" in r:
        # (e): the losses after the first step within the split's bound
        later = TOL_RANK_SPLIT_STEP_REL if tag == "e" else TOL_RANK_BF16_REL
        near = (all(g <= TOL_RANK_NORM_REL for g in r["gaps"]["grad_norm"])
                and r["gaps"]["loss"][0] <= TOL_RANK_BF16_REL
                and all(g <= later for g in r["gaps"]["loss"][1:]))
        how = (f"the first loss within {TOL_RANK_BF16_REL}, the later "
               f"within {later} and every clip norm within "
               f"{TOL_RANK_NORM_REL} relative of the one-process step's "
               f"{near} (gaps {r['gaps']})")
    else:
        how = "no one-process step (the state fits no one card)"
    finite = all(math.isfinite(v) for v in r["losses"] + r["norms"])
    line = (f"rank ({tag}) {r['arch']} {r['layout']} over the mesh "
            f"{r['mesh']} of {world} rank(s): {how}; losses {r['losses']}, "
            f"all finite {finite}; the ranks that hold a block alike hold "
            f"it bitwise {r['replicas']}; each leaf the block of its spec "
            f"{r['blocks']}; state "
            f"bytes a rank {r['held_by_rank']} of {r['whole']} "
            f"({r['held'] / r['whole']:.4f}; replicated leaves "
            f"{r['replicated']}; the layout's share "
            f"(specs.per_device_bytes) {r['share']}, and under FSDP at most "
            f"a 1 / {world} share of the rest, beside {r['uneven']:.0f} of "
            f"leaves spread over fewer ranks: {bound}); collectives issued "
            f"at the first call (warm-up and "
            f"capture) {first}, at the later calls and the profiled replay "
            f"{later} (captured: {captured})")
    if not (captured and moved and bound and near and finite
            and r["blocks"] and r["replicas"]):
        raise AssertionError(line)
    return line


def dryrun_gib(arch: str, world: int, mp: int, layout: str, dev) -> float:
    """``dryrun.run_cell``'s per-device peak (arguments and live bytes,
    GiB) of ``arch``'s train step at [8, 128], one microbatch, on the
    (world / mp, mp) mesh over the card listed ``world`` times, under the
    layout's rule variant."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.elastic import best_mesh
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(
        arch, ShapeConfig("train_8x128", LM_TRAIN_SEQ, LM_TRAIN_BATCH,
                          "train"),
        mesh=best_mesh(devices=[dev] * world, model_parallel=mp),
        grad_accum=1, variant="zero1" if layout == "zero1" else "baseline")
    if not rec["ok"]:
        raise AssertionError(f"dryrun.run_cell: {rec['error']}")
    mem = rec["memory"]
    return (mem["argument_bytes"] + mem["peak_live_bytes_per_device"]) / 2 ** 30


def log_sharded(r: dict, tag: str, smi: str, line: bool = True) -> None:
    """``sharded_steps``' lines: the checks' (unless ``line`` is false:
    logged already), the times', the memory's."""
    if line:
        log(r["line"] + f" [{smi}]")
    log(f"time rank ({tag}) {r['arch']} {r['layout']} {r['mesh']}: the "
        f"replays' wall p50 {r['p50_ms']:.3f} ms (each "
        + ", ".join(f"{v:.3f}" for v in r["walls_ms"])
        + f" ms, the first the warm-up and the capture), device busy "
        f"{r['busy_us']:.1f} us a step, idle share {r['idle']}, NCCL "
        f"kernels {r['nccl_us']:.1f} us a step, {r['kernels']:.0f} "
        f"kernels a step; init {r['init_s']:.2f} s [{smi}]")
    log(f"rank ({tag}) memory {r['arch']} {r['layout']} {r['mesh']}: the "
        f"state {r['held'] / 2 ** 30:.3f} GiB on rank 0 (whole "
        f"{r['whole'] / 2 ** 30:.3f} GiB), the first call's peak "
        f"{r['peak'] / 2 ** 30:.3f} GiB against dryrun.run_cell's "
        f"per-device peak {r['dryrun_gib']:.3f} GiB at the same mesh shape "
        f"(ratio {r['peak'] / 2 ** 30 / r['dryrun_gib']:.4f}) [{smi}]")


def rank_sharded(dev, smi, one, a) -> dict:
    """5k (d): the train state sharded over the ranks (``sharded_steps``
    under each of ``RANK_LAYOUTS``): llama3.2-1b at full size in bf16 on
    [8, 128] on the (world, 1) mesh of all ranks, against 5k (a)'s
    one-process step ``one`` (metrics and state bitwise at world 1); over
    four ranks also ``RANK_VLM_ARCH`` at full size under FSDP at (4, 1).
    The fused Adam and the global norm launch once a step and nothing
    else does; the first call's peak beside ``dryrun.run_cell``'s
    per-device peak for the same mesh shape and layout (at world 1, 5k
    (a)'s). ``one``'s state is dropped after; its metrics and batch stay
    for (e)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm_data import lm_batch
    from repro_torch.dist.elastic import best_mesh
    from repro_torch.kernels import ops
    world = dist.get_world_size()
    t_part = time.perf_counter()
    ops.reset_launch_counts()
    adam_want = {}
    runs = []
    mesh = best_mesh()
    for layout in RANK_LAYOUTS:
        r = sharded_steps(get_config(LM_TRAIN_ARCH), mesh, layout,
                          one["batch"], dev, one)
        tally_adam(adam_want, {torch.bfloat16},
                   compiled_steps(r["captures"]))
        r["line"] = check_sharded(r, world)
        runs.append(r)
    one.pop("state")
    free_card()
    if world == 4:
        vcfg = get_config(RANK_VLM_ARCH)
        vbatch = lm_batch((SEED, 13), vcfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                          dtype=torch.bfloat16, device=dev)
        r = sharded_steps(vcfg, best_mesh(), "fsdp", vbatch, dev)
        del vbatch
        tally_adam(adam_want, {torch.bfloat16},
                   compiled_steps(r["captures"]))
        r["line"] = check_sharded(r, world)
        runs.append(r)
    launches = check_adam_launches("phase 5k (d)", adam_want)
    steps_s = time.perf_counter() - t_part
    # every rank estimates (only rank 0 prints), so no rank leaves the
    # group while another still works
    for r in runs:
        r["dryrun_gib"] = (a["dryrun_gib"] if world == 1 else dryrun_gib(
            RANK_VLM_ARCH if r["arch"] == RANK_VLM_ARCH else LM_TRAIN_ARCH,
            world, r["mesh"]["model"], r["layout"], dev))
        log_sharded(r, "d", smi)
    seconds = time.perf_counter() - t_part
    log(f"rank (d) took {seconds:.1f} s over {world} rank(s) ({steps_s:.1f} "
        f"s of steps and checks); launches {launches} [{smi}]")
    return {"runs": [{k: v for k, v in r.items() if k != "line"}
                     for r in runs], "seconds": seconds,
            "launches": launches}


# (e) tensor parallelism over the model axis: over several cards
# llama3.2-1b at (1, world) and (2, world / 2), granite at (2, world / 2)
RANK_TP_MOE_ARCH = "granite-moe-3b-a800m"


def one_process_steps(cfg, mesh, batch, dev) -> dict:
    """``RANK_STEPS`` eager steps (``make_lm_train_step_fn``) of ``cfg``
    from ``init_lm(SEED)``'s state on ``batch``, in this process under
    ``mesh`` (a mesh listing the card), the update written into the state
    (``optim.updates_in_place``, as a compiled step writes its buffers: a
    state that fills most of the card, as granite's 3.98 G parameters
    with their fp32 moments do, leaves no room for a functional update's
    copy of it, which a compiled step's eager warm-up makes): their metrics
    and the batch, as 5k (a)'s one-process step gives them to
    ``sharded_steps``. A compiled step is bitwise its eager step (phase
    5h)."""
    import torch
    from repro_torch.dist.sharding import AxisRules, use_mesh
    from repro_torch.models.lm import init_lm
    from repro_torch.train.optim import (AdamConfig, constant_schedule,
                                         updates_in_place)
    from repro_torch.train.trainer import (init_train_state,
                                           make_lm_train_step_fn)
    free_card()
    step = make_lm_train_step_fn(cfg, AdamConfig(schedule=constant_schedule(
        TRAIN_LR)))
    state = init_train_state(init_lm(SEED, cfg, device=dev))
    metrics = []
    with use_mesh(mesh, AxisRules()), updates_in_place():
        for _ in range(RANK_STEPS):
            state, m = step(state, batch)
            metrics.append(m)
    torch.cuda.synchronize()
    del state, step
    free_card()
    return {"metrics": metrics, "batch": batch}


def rank_split(dev, smi, one, d) -> dict:
    """5k (e): the work split over the ``model`` axis (tensor
    parallelism: each rank its heads, FFN columns and vocabulary slice).
    At world 1 every extent is 1 and the split is the identity: the
    ``heads``, ``kv_heads``, ``ff`` and ``vocab`` extents of the (1, 1)
    mesh over the rank are 1, ``lm.lm_splits`` finds no leaf to split, and
    (d)'s FSDP step at (1, 1), which runs this code, is bitwise 5k (a)'s
    one-process step with (d)'s two all-reduces a call and no other
    collective. Over several cards ``sharded_steps`` of llama3.2-1b at
    full size under FSDP at (1, world), and, where world / 2 > 1, under
    FSDP and ZeRO-1 at (2, world / 2), against ``one`` (5k (a)'s
    one-process step), and ``RANK_TP_MOE_ARCH`` at full size under FSDP at
    (2, world / 2) against its one-process eager step
    (``one_process_steps``) under a (2, world / 2) mesh listing the card
    (the expert-parallel loop, the same capacity a data
    shard): the first loss within ``TOL_RANK_BF16_REL``, the later ones
    within ``TOL_RANK_SPLIT_STEP_REL`` and clip norms within
    ``TOL_RANK_NORM_REL``, the ranks holding a block alike, collectives at
    the warm-up and the capture only; each run's replay p50, busy, idle
    share, NCCL time, state bytes a rank and first-call peak beside
    ``dryrun.run_cell``'s at the same mesh shape."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm_data import lm_batch
    from repro_torch.dist.elastic import best_mesh
    from repro_torch.dist.sharding import AxisRules, split_extent, use_mesh
    from repro_torch.kernels import ops
    from repro_torch.models.lm import init_lm_abstract, lm_splits
    from repro_torch.train.optim import tree_leaves as leaves
    world = dist.get_world_size()
    t_part = time.perf_counter()
    cfg = get_config(LM_TRAIN_ARCH)
    if world == 1:
        with use_mesh(best_mesh(model_parallel=world), AxisRules()):
            extents = {ax: split_extent(ax, n) for ax, n in (
                ("heads", cfg.n_heads), ("kv_heads", cfg.n_kv_heads),
                ("ff", cfg.d_ff), ("vocab", cfg.vocab))}
            none = lm_splits(init_lm_abstract(cfg), cfg) is None
        r = next(r for r in d["runs"] if r["layout"] == "fsdp")
        ok = (all(v == 1 for v in extents.values()) and none
              and r["same_metrics"] and r["same_state"]
              and r["issued"][0] == {"all_reduce": 4}
              and not any(r["issued"][1:]))
        line = (f"rank (e) the split over model at world 1, mesh "
                f"{r['mesh']}: extents {extents}, no leaf split {none}; "
                f"(d)'s FSDP step there bitwise 5k (a)'s one-process step "
                f"(metrics {r['same_metrics']}, state {r['same_state']}), "
                f"collectives {r['issued'][0]} at the first call and none "
                f"after (no collective added): {ok}")
        if not ok:
            raise AssertionError(line)
        log(line + f" [{smi}]")
        one.clear()
        return {"world": 1, "extents": extents, "ok": ok,
                "seconds": time.perf_counter() - t_part}
    ops.reset_launch_counts()
    adam_want = {}
    plan = [(LM_TRAIN_ARCH, world, "fsdp")]
    if world // 2 > 1:
        plan += [(LM_TRAIN_ARCH, world // 2, "fsdp"),
                 (LM_TRAIN_ARCH, world // 2, "zero1"),
                 (RANK_TP_MOE_ARCH, world // 2, "fsdp")]
    runs, missed = [], []
    for arch, mp, layout in plan:
        acfg = get_config(arch)
        ref = one
        # granite's router is fp32 in every dtype: a second Adam instance
        dtypes = {t.dtype for t in leaves(init_lm_abstract(acfg))}
        if arch != LM_TRAIN_ARCH:
            batch = lm_batch((SEED, 13), acfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                             dtype=torch.bfloat16, device=dev)
            ref = one_process_steps(acfg, best_mesh(
                devices=[dev] * world, model_parallel=mp), batch, dev)
            tally_adam(adam_want, dtypes, RANK_STEPS)
        r = sharded_steps(acfg, best_mesh(model_parallel=mp), layout,
                          ref["batch"], dev, ref)
        del ref
        tally_adam(adam_want, dtypes, compiled_steps(r["captures"]))
        try:
            r["line"] = check_sharded(r, world, "e")
        except AssertionError as e:     # raised below, after every run
            r["line"] = f"FAILED {e}"
            missed.append(r["line"])
        log(r["line"] + f" [{smi}]")
        runs.append(r)
    one.clear()
    free_card()
    launches = check_adam_launches("phase 5k (e)", adam_want)
    steps_s = time.perf_counter() - t_part
    for r in runs:
        r["dryrun_gib"] = dryrun_gib(
            LM_TRAIN_ARCH if r["arch"] == cfg.name else RANK_TP_MOE_ARCH,
            world, r["mesh"]["model"], r["layout"], dev)
        log_sharded(r, "e", smi, line=False)
    seconds = time.perf_counter() - t_part
    log(f"rank (e) took {seconds:.1f} s over {world} rank(s) ({steps_s:.1f} "
        f"s of steps and checks); launches {launches} [{smi}]")
    if missed:
        raise AssertionError("phase 5k (e): " + "\n".join(missed))
    return {"runs": [{k: v for k, v in r.items() if k != "line"}
                     for r in runs], "seconds": seconds,
            "launches": launches}


def rank_checks(rank, smi) -> dict:
    """5k (a), (b), (d) and (e) on this process's group of ranks (only
    rank 0 logs)."""
    from repro_torch.dist import ranks
    if rank:
        sys.stdout = open(os.devnull, "w")
    dev = ranks.rank_device()
    res = {"a": rank_train(dev, smi)}
    free_card()
    res["b"] = rank_exchange(dev, smi)
    free_card()
    one = res["a"].pop("one")
    res["d"] = rank_sharded(dev, smi, one, res["a"])
    free_card()
    res["e"] = rank_split(dev, smi, one, res["d"])
    del one
    free_card()
    return res


def rank_launcher(dev, world, smi) -> dict:
    """5k (c): ``launch.train`` under ``python -m torch.distributed.run
    --standalone --nproc-per-node <cards>`` (NCCL, one rank a card),
    against the one-process launcher in this process: the losses bitwise at
    world 1, within ``TOL_RANK_REL`` beyond; one set of lines, rank 0's."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import main as train_main
    ops.reset_launch_counts()
    run = train_main(RANK_LAUNCH)
    adam_want = {}
    tally_adam(adam_want, {torch.float32}, compiled_steps(run["compiled"]))
    check_adam_launches("phase 5k (c)", adam_want)
    one = run["losses"]
    free_card()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(world), "-m", "repro_torch.launch.train",
           *RANK_LAUNCH]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        text = finish(start(cmd, env, tmp, "torchrun"), "torchrun launcher",
                      RANK_LAUNCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = [line for line in text.splitlines()
             if line.startswith("[train] ")]
    got = [json.loads(line[len("[train] losses "):]) for line in lines
           if line.startswith("[train] losses ")]
    mesh_line = f"{{'data': {world}, 'model': 1}}"
    ok = (len(got) == 1 and lines[0].endswith(mesh_line)
          and (got[0] == one if world == 1 else all(
              abs(a - b) <= TOL_RANK_REL * abs(b)
              for a, b in zip(got[0], one))) and len(got[0]) == len(one))
    report = (f"rank (c) python -m torch.distributed.run --standalone "
              f"--nproc-per-node {world} -m repro_torch.launch.train "
              + " ".join(RANK_LAUNCH) + f": losses {got} against the "
              f"one-process launcher's {one} "
              f"({'bitwise' if world == 1 else f'within {TOL_RANK_REL}'}: "
              f"{ok}); {wall:.1f} s of wall with torchrun's start-up")
    if not ok:
        raise AssertionError(report + "\n" + text)
    log(report + f" [{smi}]")
    return {"losses": got[0], "wall_s": wall}


def rank_phase(dev, smi) -> dict:
    """Phase 5k: the mesh paths over ranks, one process a card (NCCL). On
    a machine with one card the script's own process is the one rank of a
    group over a ``file://`` store in a temporary directory, left at the
    end of the phase; with more cards ``spawn_ranks`` starts one process a
    card. (a) ``rank_train``, (b) ``rank_exchange``, (d) ``rank_sharded``,
    (e) ``rank_split`` (in the ranks), (c) ``rank_launcher`` (here, once
    the group is left)."""
    import shutil
    import torch
    from repro_torch.dist import ranks
    t_phase = time.perf_counter()
    world = torch.cuda.device_count()
    free_card()
    if world == 1:
        tmp = tempfile.mkdtemp(prefix="ranks-")
        ranks.init_ranks(dev, rank=0, world_size=1,
                         init_method=f"file://{os.path.join(tmp, 'store')}")
        try:
            res = rank_checks(0, smi)
        finally:
            ranks.destroy_ranks()
            shutil.rmtree(tmp, ignore_errors=True)
    else:
        res = ranks.spawn_ranks(rank_checks, world, "cuda",
                                timeout=RANK_SPAWN_TIMEOUT_S,
                                args=(smi,))[0]
    free_card()
    res["c"] = rank_launcher(dev, world, smi)
    free_card()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 5k took {res['seconds']:.1f} s over {world} rank(s) "
        f"[{smi}]")
    return res


# -- phase 5j: the examples and the launch tooling ---------------------------

EXAMPLES = ROOT / "examples"
TWIN_TIMEOUT_S = 300
DRYRUN_TIMEOUT_S = 600
DRYRUN_WORKERS = 5            # beside the two twins run as subprocesses
# the digits twin's CTC steps and the gas twin's dense ones (half as many
# QAT steps follow): their defaults, 400 and 150, would take 70 s and 100 s
# of the card's eager steps (host-bound, ~0.17 s a digits step)
DIGITS_STEPS = 100
GAS_STEPS = 40
COPY_BYTES = 4 * 2 ** 30      # the HBM copy of (c)
MATMUL_N = 8192               # the bf16 matmul of (c)
# the labelled lines each twin prints, in its JAX example's order
TWIN_LABELS = {
    "quickstart_torch.py": (
        "theta=0   max |DeltaGRU - GRU| = ", "theta=  8 (Q8.8)  gamma_dx=",
        "theta= 32 (Q8.8)  gamma_dx=", "theta= 64 (Q8.8)  gamma_dx=",
        "Eq.7 on the EdgeDRNN config (8 PEs @125 MHz, peak 2 GOp/s):",
        "  est latency/step = ", "delta_spmv kernel: weight HBM traffic ",
        "compiled program (backend=fused): step/sequence API",
        "int8 program: weights quantized+packed at compile time",
        "state safety: ", "quantized LSTM (cell=lstm, backend=fused_q8)",
        "  layout: gates=4, w_q "),
    "serve_stream_digits_torch.py": (
        "trained digit recognizer: CTC loss ", "reference digits: ",
        "decoded digits:   ", "streaming report over ", "  gamma_dx=",
        "  mean Eq.7 latency ", "int8 deployment (backend=fused_q8, 8-bit",
        "  gamma_dh=", "session batcher: 10 streams recycled through 4 slots",
        "with closed-loop theta controller (target 15% hidden firing):",
        "  theta_h adapted "),
    "train_gas_regression_torch.py": (
        "== SensorsGas regression, 2L-64H ==",
        "stage 1 (dense pretrain):   loss ",
        "stage 2 (DeltaGRU retrain): loss -> ", "eval: RMSE=",
        "temporal sparsity: gamma_dx=", "Eq.7 deployment estimate: "),
    "lm_delta_decode_torch.py": (
        "delta-RWKV6 greedy decode (rwkv6-1.6b-smoke: D=64, L=2, vocab=48,",
        "   theta  gamma_dx  gamma_dh  KB/step     drift  tok match",
        "   0.000 ", "   0.031 ", "   0.125 ", "   0.250 ",
        "=> the engine prices exactly what the deltas fetch"),
}


def twin_labels(name: str, out: str) -> None:
    """Every labelled line of the twin, in order."""
    lines = out.splitlines()
    at = 0
    for label in TWIN_LABELS[name]:
        while at < len(lines) and not lines[at].startswith(label):
            at += 1
        if at == len(lines):
            raise AssertionError(f"{name}: no line {label!r} in order:\n"
                                 f"{out}")
        at += 1


def twin_numbers(line: str) -> list:
    import re
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e[-+]\d+)?", line)]


def twin_line(out: str, label: str) -> str:
    return next(ln for ln in out.splitlines() if ln.startswith(label))


def run_twin(name: str, argv: list) -> tuple:
    """``examples/<name>`` run in this process (``runpy``) with ``argv``;
    returns its output and its globals."""
    import contextlib
    import io
    import runpy
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [str(EXAMPLES / name), *argv]
    try:
        with contextlib.redirect_stdout(buf):
            env = runpy.run_path(str(EXAMPLES / name), run_name="__main__")
    finally:
        sys.argv = saved
    return buf.getvalue(), env


def start(cmd: list, env: dict, out_dir: str, what: str):
    """``cmd`` in a process group of its own (it may start others), its
    output and errors written to files under ``out_dir``."""
    out = open(os.path.join(out_dir, f"{what}.out"), "w")
    err = open(os.path.join(out_dir, f"{what}.err"), "w")
    proc = subprocess.Popen(cmd, stdout=out, stderr=err, text=True, env=env,
                            cwd=ROOT, start_new_session=True)
    out.close()
    err.close()
    proc.files = (out.name, err.name)
    return proc


def stop(proc) -> None:
    """Kill ``proc``'s whole process group, whatever is left of it."""
    import signal
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def finish(proc, what: str, timeout: float) -> str:
    """The process's output once it exits 0 (its group killed at
    ``timeout``)."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        stop(proc)
        raise AssertionError(f"{what} ran past {timeout} s")
    stop(proc)                      # anything it left behind
    with open(proc.files[0]) as f:
        out = f.read()
    if proc.returncode != 0:
        with open(proc.files[1]) as f:
            err = f.read()
        raise AssertionError(f"{what} exited {proc.returncode}:\n{out}\n"
                             f"{err[-4000:]}")
    return out


def card_rates(dev) -> dict:
    """The card's HBM copy rate (a 4 GiB device-to-device copy: read and
    write) and dense bf16 matmul rate (8192^3, a library call: it measures
    the card), by CUDA events over repeated calls."""
    import torch

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / 1e3 / reps

    a = torch.empty(COPY_BYTES, dtype=torch.uint8, device=dev)
    b = torch.empty_like(a)
    t_copy = timed(lambda: b.copy_(a), 10)
    del a, b
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((MATMUL_N, MATMUL_N), generator=g, device=dev,
                    dtype=torch.bfloat16)
    y = torch.randn((MATMUL_N, MATMUL_N), generator=g, device=dev,
                    dtype=torch.bfloat16)
    t_mm = timed(lambda: x @ y, 20)
    del x, y
    free_card()
    return {"hbm_bytes_per_s": 2 * COPY_BYTES / t_copy,
            "copy_ms": 1e3 * t_copy,
            "bf16_flops_per_s": 2 * MATMUL_N ** 3 / t_mm,
            "matmul_ms": 1e3 * t_mm}


def examples_phase(dev, smi, main_gru: dict) -> dict:
    """Phase 5j: the four example twins and the launch tooling on the card.
    (a) ``examples/quickstart_torch.py`` and
    ``examples/serve_stream_digits_torch.py`` run in this process (each
    with the launch counts set to 0 just before and read just after), and
    ``train_gas_regression_torch.py`` and ``lm_delta_decode_torch.py`` as
    subprocesses, each within ``TWIN_TIMEOUT_S``; every twin exits cleanly
    and prints every labelled line of its JAX example (the digits twin at
    ``--steps DIGITS_STEPS``, the gas twin at ``--steps GAS_STEPS``: their
    defaults would take minutes of eager steps). The quickstart must
    launch rows 1, 2, 4, 6 and 7 (``deltagru_seq_f32``,
    ``delta_q8_gru_i8``, ``delta_q8_lstm_i8``, ``deltalstm_seq_f32``,
    ``delta_spmv_f32``); the digits twin rows 1 and 2 exactly two layers a
    replay (and a capture's warm-up step) of its engines (row 2 one-stream
    and the B = 4 tile under the batcher) and nothing while it trains. (b) The quickstart's theta=0 line
    within ``TOL_F32`` (the delta memory sums rounded deltas: JAX's example
    prints 2.1e-7 there) and its state-safety ``ValueError``; the decode
    twin's theta=0 row at drift 0.0000 and 100 % token match; the training
    twins' losses finite and falling; the quickstart and the decode twin
    against the same twins with ``--device cpu``: every int8 output
    bitwise, every fp32 output within ``TOL_F32``, the decode's reference
    tokens equal. (c) The card's HBM copy rate and bf16 matmul rate beside
    ``H100``'s data-sheet constants; ``gpu_batch1_gru_roofline`` of the
    paper's 2L-768H at phase 5's measured sparsity beside phase 5's
    ``step_many`` time (``main_gru``: backend -> (gamma_dx, gamma_dh,
    us a step)). (d) ``python -m repro_torch.launch.dryrun --all`` on the
    (16, 16) mesh over the card, in ``DRYRUN_WORKERS`` processes: one line
    a cell, every runnable cell of ``grid()`` ok. Returns the launches and
    the numbers."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs.registry import grid
    from repro_torch.core.perf_model import H100, gpu_batch1_gru_roofline
    from repro_torch.core.sparsity import GruDims, effective_sparsity
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    res = {"launches": {}}
    # (c) first, while nothing else runs on the card
    rates = card_rates(dev)
    res["rates"] = rates
    log(f"examples (c) HBM: a {COPY_BYTES} B device-to-device copy in "
        f"{rates['copy_ms']:.4f} ms, {rates['hbm_bytes_per_s'] / 1e12:.4f} "
        f"TB/s read + written (data sheet {H100.hbm_bw / 1e12:.2f} TB/s); "
        f"bf16 {MATMUL_N}^3 matmul in {rates['matmul_ms']:.4f} ms, "
        f"{rates['bf16_flops_per_s'] / 1e12:.2f} TFLOP/s (data sheet "
        f"{H100.peak_bf16_flops / 1e12:.0f} TFLOP/s dense) [{smi}]")
    dims = GruDims(40, 768, 2)
    for be, wbytes in (("fused", 4), ("fused_q8", 1)):
        gdx, gdh, us = main_gru[be]
        g_eff = float(effective_sparsity(dims, gdx, gdh))
        roof = gpu_batch1_gru_roofline(dims, g_eff, weight_bytes=wbytes)
        bound_us = 1e6 * max(roof["t_compute"], roof["t_memory"])
        res[f"roofline_{be}"] = dict(roof, gamma_eff=g_eff, bound_us=bound_us,
                                     step_many_us=us)
        log(f"examples (c) gpu_batch1_gru_roofline 2L-768H {be} "
            f"({wbytes}-byte weights) at phase 5's gamma_eff {g_eff:.4f} "
            f"(gamma_dx {gdx:.4f}, gamma_dh {gdh:.4f}): compute "
            f"{1e6 * roof['t_compute']:.5f} us, memory "
            f"{1e6 * roof['t_memory']:.5f} us ({roof['bound']}-bound, "
            f"{bound_us:.5f} us a step); phase 5's step_many {us:.1f} us a "
            f"step, {us / bound_us:.1f} x the bound [{smi}]")

    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    out_dir = tempfile.mkdtemp(prefix="examples_")
    rec_dir = os.path.join(out_dir, "dryrun")
    procs = {}
    try:
        procs["dryrun"] = start(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--workers", str(DRYRUN_WORKERS), "--out", rec_dir], env,
            out_dir, "dryrun")
        procs["gas"] = start(
            [sys.executable, str(EXAMPLES / "train_gas_regression_torch.py"),
             "--steps", str(GAS_STEPS)], env, out_dir, "gas")
        procs["decode"] = start(
            [sys.executable, str(EXAMPLES / "lm_delta_decode_torch.py")],
            env, out_dir, "decode")
        # (a) the in-process twins, each launch counted
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        out_q, card_q = run_twin("quickstart_torch.py", [])
        n_q = {k: v for k, v in ops.launch_counts().items() if v}
        res["quickstart_s"] = time.perf_counter() - t0
        log(out_q.rstrip())
        twin_labels("quickstart_torch.py", out_q)
        want_q = (ops.DELTAGRU_SEQ_F32, ops.DELTA_Q8_GRU_I8,
                  ops.DELTA_Q8_LSTM_I8, ops.DELTALSTM_SEQ_F32,
                  ops.DELTA_SPMV_F32, ops.DELTA_UNIT_F32)
        if any(not n_q.get(k.name) for k in want_q) or set(n_q) - {
                k.name for k in want_q}:
            raise AssertionError(f"quickstart launches {n_q}")
        log(f"examples (a) quickstart on {dev}: launches {n_q} "
            f"({res['quickstart_s']:.1f} s)")

        t0 = time.perf_counter()
        ops.reset_launch_counts()
        log(f"examples (a) quickstart done at "
            f"{time.perf_counter() - t_phase:.1f} s of the phase")
        out_d, card_d = run_twin("serve_stream_digits_torch.py",
                                 ["--steps", str(DIGITS_STEPS)])
        n_d = {k: v for k, v in ops.launch_counts().items() if v}
        res["digits_s"] = time.perf_counter() - t0
        log(out_d.rstrip())
        twin_labels("serve_stream_digits_torch.py", out_d)
        # a step runs two layer kernels, two Delta Units and an epilogue;
        # so does the warm-up step each capture runs first, outside the
        # graph
        replays = {k: engine_steps(card_d[k])
                   for k in ("eng", "eng2", "eng_q", "eng_m")}
        # and its training: the compiled step's warm-up and a replay a
        # step, one global norm and one fused Adam launch each
        want_d = {ops.DELTAGRU_SEQ_F32.name:
                  2 * (replays["eng"] + replays["eng2"]),
                  ops.DELTA_Q8_GRU_I8.name:
                  2 * (replays["eng_q"] + replays["eng_m"]),
                  ops.DELTA_UNIT_F32.name: 2 * sum(replays.values()),
                  ops.ENGINE_EPILOGUE_F32.name: sum(replays.values()),
                  ops.FUSED_ADAM_F32.name: compiled_steps(
                      card_d["step"].stats),
                  ops.GLOBAL_NORM.name: compiled_steps(
                      card_d["step"].stats)}
        if card_d["step"].stats["replays"] != DIGITS_STEPS:
            raise AssertionError(f"digits training: {card_d['step'].stats}, "
                                 f"want a replay for each of {DIGITS_STEPS} "
                                 f"steps")
        if (n_d != want_d or card_d["eng_m"].n_streams != 4
                or not replays["eng_m"] or not replays["eng_q"]):
            raise AssertionError(f"digits launches {n_d}, want {want_d} "
                                 f"(replays {replays})")
        log(f"examples (a) serve_stream_digits --steps {DIGITS_STEPS} on "
            f"{dev}: launches {n_d} = 2 layers x steps {replays} (the "
            f"int8 kernel's B=4 tile under the batcher: "
            f"{2 * replays['eng_m']}), the global norm and the fused Adam "
            f"once a training step "
            f"(compiled: {card_d['step'].stats}) ({res['digits_s']:.1f} s)")
        for k in set(n_q) | set(n_d):
            res["launches"][k] = n_q.get(k, 0) + n_d.get(k, 0)

        # (b) invariants and the card against the CPU
        err0 = twin_numbers(twin_line(out_q, "theta=0   max"))[0]
        if not err0 <= TOL_F32:
            raise AssertionError(f"quickstart theta=0: {err0} > {TOL_F32}")
        losses = twin_numbers(twin_line(out_d, "trained digit recognizer"))
        if not (np.all(np.isfinite(losses)) and losses[1] < losses[0]):
            raise AssertionError(f"digits losses {losses}")
        out_qc, cpu_q = run_twin("quickstart_torch.py", ["--device", "cpu"])
        twin_labels("quickstart_torch.py", out_qc)
        errs = {}
        for key in ("ys_dense", "ys_delta0", "ys_prog", "ys_legacy",
                    "ys_l"):
            errs[key] = float((card_q[key].cpu() - cpu_q[key]).abs().max())
            if errs[key] > TOL_F32:
                raise AssertionError(f"quickstart {key}: card against CPU "
                                     f"{errs[key]:.3e} > {TOL_F32}")
        for key in ("ys_q8", "ys_lq8"):
            if not torch.equal(card_q[key].cpu(), cpu_q[key]):
                raise AssertionError(f"quickstart {key}: card and CPU "
                                     "differ")
        log(f"examples (b) quickstart: theta=0 {err0:.2e} <= {TOL_F32}; "
            f"state safety raised; card against --device cpu: int8 "
            f"outputs (ys_q8, ys_lq8) bitwise, fp32 "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f" <= {TOL_F32}; digits CTC loss {losses[0]} -> {losses[1]}")

        out_dec, card_dec = run_twin("lm_delta_decode_torch.py", [])
        _, cpu_dec = run_twin("lm_delta_decode_torch.py",
                              ["--device", "cpu"])
        dec_err = float((card_dec["ref_logits"].cpu()
                         - cpu_dec["ref_logits"]).abs().max())
        if dec_err > TOL_F32 or card_dec["ref_toks"] != cpu_dec["ref_toks"]:
            raise AssertionError(f"decode: card against CPU {dec_err:.3e}, "
                                 f"tokens {card_dec['ref_toks']} / "
                                 f"{cpu_dec['ref_toks']}")

        # the subprocesses
        out_gas = finish(procs.pop("gas"), "train_gas_regression_torch.py",
                         TWIN_TIMEOUT_S)
        log(out_gas.rstrip())
        twin_labels("train_gas_regression_torch.py", out_gas)
        stage1 = twin_numbers(twin_line(out_gas, "stage 1"))
        stage2 = twin_numbers(twin_line(out_gas, "stage 2"))
        if not (np.all(np.isfinite(stage1 + stage2))
                and stage1[1] < stage1[0] and stage2[0] < stage1[0]):
            raise AssertionError(f"gas losses {stage1} {stage2}")
        out_dsub = finish(procs.pop("decode"), "lm_delta_decode_torch.py",
                          TWIN_TIMEOUT_S)
        log(out_dsub.rstrip())
        twin_labels("lm_delta_decode_torch.py", out_dsub)
        row0 = twin_line(out_dsub, "   0.000 ").split()
        if row0[4] != "0.0000" or row0[5] != "100%":
            raise AssertionError(f"decode theta=0 row {row0}")
        log(f"examples (b) gas: stage 1 loss {stage1[0]} -> {stage1[1]}, "
            f"stage 2 -> {stage2[0]}; decode theta=0 row drift {row0[4]}, "
            f"match {row0[5]}; decode card against --device cpu: reference "
            f"logits {dec_err:.2e} <= {TOL_F32}, reference tokens equal "
            f"[{smi}]")

        # (d) the dry-run
        t0 = time.perf_counter()
        out_dr = finish(procs.pop("dryrun"), "launch.dryrun --all",
                        DRYRUN_TIMEOUT_S)
        for line in out_dr.splitlines():
            if line.strip():
                log(f"dryrun {line}")
        runnable = [(a, s.name) for a, s, skip in grid() if not skip]
        recs = {}
        for a, s in runnable:
            with open(os.path.join(rec_dir, f"{a}__{s}__16x16.json")) as f:
                recs[(a, s)] = json.load(f)
        bad = [k for k, r in recs.items()
               if not r["ok"] or r.get("mesh") != "16x16"]
        if bad:
            raise AssertionError(f"dry-run cells not ok: {bad}")
        res["dryrun"] = recs
        res["dryrun_wait_s"] = time.perf_counter() - t0
        log(f"examples (d) dry-run: {len(recs)} runnable cells of grid() "
            f"ok on the 16x16 mesh over {dev}, "
            f"{sum(r['memory']['fits'] for r in recs.values())} fit; waited "
            f"{res['dryrun_wait_s']:.1f} s for it after the twins [{smi}]")
    finally:
        for p in procs.values():
            stop(p)
        shutil.rmtree(out_dir, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 5j took {res['seconds']:.1f} s")
    return res


def main() -> int:
    import functools
    t_script = time.perf_counter()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run it from "
              "the root of a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))

    from repro_torch.configs.edgedrnn import CONFIG_2L768H
    from repro_torch.configs.recurrentgemma_9b import CONFIG as RGLRU_CONFIG
    from repro_torch.configs.rwkv6_1_6b import CONFIG as RWKV6_CONFIG
    from repro_torch.core.delta import DeltaState, delta_encode
    from repro_torch.core.deltagru import deltagru_step, init_deltagru_state
    from repro_torch.core.deltarglru import init_deltarglru_model
    from repro_torch.core.deltarwkv import init_deltarwkv_model
    from repro_torch.core.program import (compile_delta_program,
                                          compile_deltagru)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.delta_spmv import (delta_spmv, delta_spmv_ref,
                                                pack_spmv_weights,
                                                spmv_launch_plan)
    from repro_torch.kernels.delta_step_f32 import f32_step_plan
    from repro_torch.kernels.delta_unit import guard_fits
    from repro_torch.kernels.deltagru_cell import (deltagru_act,
                                                   deltagru_act_plan,
                                                   deltagru_act_ref)
    from repro_torch.kernels.rglru_scan import (rglru_scan,
                                                rglru_scan_batched_ref,
                                                rglru_scan_plan)
    from repro_torch.kernels.rwkv6_scan import RWKV6_CHUNK
    from repro_torch.kernels.rwkv6_scan import (rwkv6_scan,
                                                rwkv6_scan_batched_ref,
                                                rwkv6_scan_plan)
    from repro_torch.kernels.delta_q8 import (deltagru_q8_step,
                                              deltagru_q8_step_ref,
                                              deltalstm_q8_step,
                                              deltalstm_q8_step_ref,
                                              lut_activation_grid,
                                              lut_activation_grid_ref,
                                              pack_delta_weights_q8,
                                              q8_launch_plan)
    from repro_torch.kernels.deltagru_seq import (deltagru_seq_step,
                                                  deltagru_seq_step_ref)
    from repro_torch.kernels.deltalstm_seq import (deltalstm_seq_step,
                                                   deltalstm_seq_step_ref)
    from repro_torch.models.gru_rnn import (PAPER_NETWORKS, GruTaskConfig,
                                            init_gru_model, init_lstm_model)
    from repro_torch.quant.export import quantize_delta_model
    from repro_torch.serve import resilience
    from repro_torch.serve.engine import DeltaStreamEngine
    from repro_torch.serve.scheduler import GruStreamBatcher

    # each phase's seconds, logged where the next one starts
    marks = [("1", time.perf_counter())]

    def phase(name):
        prev, t = marks[-1]
        now = time.perf_counter()
        log(f"phase {prev} took {now - t:.1f} s")
        marks.append((name, now))

    # -- 1. environment ---------------------------------------------------
    smi = nvidia_smi_line()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")

    phase("2")
    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)}")
    for src, text in sorted(logs.items()):
        for line in ptxas_summary(text):
            log(f"  {src}: {line}")

    cfg = CONFIG_2L768H
    backends = ("fused", "fused_q8", "fused_q4")
    models = {"gru": init_gru_model(SEED, cfg, device="cuda"),
              "lstm": init_lstm_model(SEED, cfg, device="cuda")}
    models_cpu = {"gru": init_gru_model(SEED, cfg, device="cpu"),
                  "lstm": init_lstm_model(SEED, cfg, device="cpu")}
    # the main paths: the GRU through compile_deltagru, the LSTM through
    # compile_delta_program(cell="lstm")
    progs = {("gru", be): compile_deltagru(models["gru"], be)
             for be in backends}
    progs.update({("lstm", be): compile_delta_program(models["lstm"], be,
                                                      cell="lstm")
                  for be in backends})
    cpu_progs = {(cell, be): compile_delta_program(models_cpu[cell], be,
                                                   cell=cell, device="cpu")
                 for cell, be in progs}
    kernel_of = {("gru", "fused"): ops.DELTAGRU_SEQ_F32,
                 ("gru", "fused_q8"): ops.DELTA_Q8_GRU_I8,
                 ("gru", "fused_q4"): ops.DELTA_Q8_GRU_I4,
                 ("lstm", "fused"): ops.DELTALSTM_SEQ_F32,
                 ("lstm", "fused_q8"): ops.DELTA_Q8_LSTM_I8,
                 ("lstm", "fused_q4"): ops.DELTA_Q8_LSTM_I4}
    gru_q8 = (deltagru_q8_step, deltagru_q8_step_ref)
    lstm_q8 = (deltalstm_q8_step, deltalstm_q8_step_ref)
    step_of = {("gru", "fused"): (deltagru_seq_step, deltagru_seq_step_ref),
               ("gru", "fused_q8"): gru_q8, ("gru", "fused_q4"): gru_q8,
               ("lstm", "fused"): (deltalstm_seq_step,
                                   deltalstm_seq_step_ref),
               ("lstm", "fused_q8"): lstm_q8, ("lstm", "fused_q4"): lstm_q8}
    # the double-buffered instances: (cell, backend) of their unbuffered twin
    buffered = {(cell, be): ops.q8_kernel(3 if cell == "gru" else 4,
                                          8 if be == "fused_q8" else 4, True)
                for cell, be in progs if be != "fused"}
    buffered_path = {"gru": "repro_torch.kernels.delta_q8.deltagru_q8_step"
                            "(buffered=True)",
                     "lstm": "repro_torch.kernels.delta_q8.deltalstm_q8_step"
                             "(buffered=True)"}

    phase("3")
    # -- 3. kernels against their plain versions --------------------------
    rng = np.random.default_rng(SEED)
    max_err = {k.name: 0.0 for k in ops.KERNELS}

    def check(name, ok, err, what):
        max_err[name] = max(max_err[name], err)
        log(f"kernel {name} {what}: max|kernel-plain|={err:.3e} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"({what})")

    def max_diff(xs, ys):
        return max(float((x.cpu() - y.cpu()).abs().max())
                   for x, y in zip(xs, ys))

    def same(xs, ys):
        return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(xs, ys))

    def offset_view(a):
        """``a`` copied into a buffer one float in: contiguous, 4-byte but
        not 16-byte aligned."""
        buf = torch.empty(a.numel() + 4, dtype=a.dtype, device=a.device)
        view = buf[1:1 + a.numel()].view(a.shape)
        view.copy_(a)
        return view

    # deltagru_act at B in {1, 2, 8, 9} and H in {768, 770, 4097} (grids
    # whose last block is ragged), with all operands 16-byte aligned and
    # with each of the four in turn one float into its buffer (4-byte
    # aligned), within TOL_F32 of its plain version on the card and the
    # CPU; every case launched twice, the two results bitwise equal
    n_act = 0
    for b in (1, 2, 8, 9):
        for h in (768, 770, 4097):
            act = [rng.normal(0, 2, (b, 4 * h)), rng.normal(0, 1, (b, 3 * h)),
                   rng.normal(0, 1, (b, 3 * h)), rng.uniform(-1, 1, (b, h))]
            act = [torch.from_numpy(a.astype(np.float32)) for a in act]
            gpu = [a.to(dev) for a in act]
            for moved in (None, 0, 1, 2, 3):
                ins = list(gpu)
                if moved is not None:
                    ins[moved] = offset_view(gpu[moved])
                plan = deltagru_act_plan(b, h)
                k = deltagru_act(*ins)
                k2 = deltagru_act(*ins)
                r = deltagru_act_ref(*ins)
                c = deltagru_act_ref(*act)
                torch.cuda.synchronize()
                err, err_c = max_diff(k, r), max_diff(k, c)
                twice = same(k, k2)
                where = ("all 16-byte aligned" if moved is None else
                         f"{('m_prev', 'zx', 'zh', 'h_prev')[moved]} 4-byte "
                         "aligned")
                check(ops.DELTAGRU_ACT_F32.name,
                      err <= TOL_F32 and err_c <= TOL_F32 and twice, err,
                      f"[{b}, 4*{h}] {where} ({plan.threads} threads a "
                      f"block, grid {plan.grid}), "
                      f"within {TOL_F32} on the card and the CPU (CPU: "
                      f"{err_c:.3e}), two launches bitwise equal {twice}")
                n_act += 1
    log(f"deltagru_act cases: {n_act}, each launched twice")
    # ops.deltagru_cell_fused (two unpacked spmvs, I = 40 with its ragged
    # edge and I = 768, then deltagru_act) against the dense GRU step
    h_dim = cfg.hidden_size
    for li, p in enumerate(models["gru"]["gru"]):
        st = init_deltagru_state(p, (8,))
        st = st._replace(
            h=torch.from_numpy(rng.uniform(-1, 1, (8, h_dim)).astype(
                np.float32)).to(dev),
            h_mem=DeltaState(torch.from_numpy(rng.uniform(
                -1, 1, (8, h_dim)).astype(np.float32)).to(dev)))
        x = torch.from_numpy(rng.normal(0, 1, (8, p.input_size)).astype(
            np.float32)).to(dev)
        want = deltagru_step(p, st, x, THETA, THETA, backend="dense")
        dx = delta_encode(x, st.x_mem, THETA).delta
        dh = delta_encode(st.h, st.h_mem, THETA).delta
        got = ops.deltagru_cell_fused(p.w_x, p.w_h, st.m, st.h, dx, dh)
        torch.cuda.synchronize()
        err = max_diff(got, (want.state.m, want.h))
        check(ops.DELTAGRU_ACT_F32.name, err <= TOL_F32, err,
              f"ops.deltagru_cell_fused layer {li} (I={p.input_size}) "
              "against the dense GRU step")

    def walk_sets(lay, u, b):
        """The fired sets of the walk's tails: exactly 0, 1, U - 1, U, U + 1
        and all column blocks (U: the blocks one unrolled group of the walk
        covers), a group across the x/h seam and, at B > 1, every block
        fired by one stream other than stream 0 alone. Returns the counts,
        the seam group and ``(fired blocks, solo)`` pairs."""
        nbk = lay.nbk
        seam = tuple(range(max(0, lay.nbk_x - 2), min(nbk, lay.nbk_x + 2)))
        counts = sorted({n for n in (0, 1, u - 1, u, u + 1, nbk)
                         if 0 <= n <= nbk})
        sets = [(tuple(sorted(rng.choice(nbk, n, replace=False))), False)
                for n in counts] + [(seam, False)]
        if b > 1:
            sets.append((tuple(range(nbk)), True))
        return counts, seam, sets

    # fp32: the same tails, B = 1 (one-stream instance), 2, 8 (tile) and 9
    # (two tile passes), within TOL_F32 of the plain version on the card
    # and on the CPU
    n_f32 = 0
    for (cell, be), prog in progs.items():
        if be != "fused":
            continue
        kern, ref = step_of[(cell, be)]
        for li, lay in enumerate(prog.layouts):
            lay_cpu = cpu_progs[(cell, be)].layouts[li]
            for b in (1, 2, 8, 9):
                plan = f32_step_plan(lay.block_k, lay.ip, lay.ip + lay.hk,
                                     lay.hidden_size, b)
                counts, seam, sets = walk_sets(lay, plan.blocks_per_group, b)
                err = err_c = 0.0
                for fired, solo in sets:
                    args = [torch.from_numpy(a) for a in fired_inputs(
                        rng, b, lay, fired, solo, quant=False)]
                    gpu = [a.to(dev) for a in args]
                    k = run_step(cell, kern, lay, gpu)
                    r = run_step(cell, ref, lay, gpu)
                    c = run_step(cell, ref, lay_cpu, args)
                    torch.cuda.synchronize()
                    err = max(err, max_diff(k, r))
                    err_c = max(err_c, max_diff(k, c))
                n_f32 += len(sets)
                solo = ", every block in one stream > 0" if b > 1 else ""
                check(kernel_of[(cell, be)].name,
                      err <= TOL_F32 and err_c <= TOL_F32, err,
                      f"layer {li} B={b} ({plan.instance}, "
                      f"U={plan.blocks_per_group}): fired blocks {counts} of "
                      f"{lay.nbk}, {list(seam)} across the seam{solo}, "
                      f"within {TOL_F32} on the card and the CPU")
    log(f"fp32 walk cases: {n_f32} fired sets")

    def q8_cases(cell, kern, ref, lay, lay_cpu, b, fired_sets):
        """The unbuffered and buffered step on each fired set, against the
        plain version on the card and on the CPU: ``(unbuffered ok,
        buffered ok, max|kernel - plain|, max|buffered - plain|)``.
        ``fired_sets`` holds ``(fired blocks, solo)`` pairs
        (``fired_inputs``)."""
        ok = ok_b = True
        err = err_b = 0.0
        for fired, solo in fired_sets:
            args = [torch.from_numpy(a)
                    for a in fired_inputs(rng, b, lay, fired, solo)]
            gpu = [a.to(dev) for a in args]
            k = run_step(cell, kern, lay, gpu)
            kb = run_step(cell, functools.partial(kern, buffered=True), lay,
                          gpu)
            r = run_step(cell, ref, lay, gpu)
            c = run_step(cell, ref, lay_cpu, args)
            torch.cuda.synchronize()
            ok = ok and same(k, r) and same(k, c)
            ok_b = ok_b and same(kb, k) and same(kb, c)
            err = max(err, max_diff(k, r))
            err_b = max(err_b, max_diff(kb, r))
        return ok, ok_b, err, err_b

    # int8 / int4: exactly 0, 1, U - 1, U, U + 1 and all column blocks
    # fired, U the fired blocks one unrolled group of the walk covers (the
    # tails of the unroll and of the int4 two-blocks-a-load split), and a
    # group across the x/h seam; B = 1 (one-stream instance), 2, 8 (tile)
    # and 9 (two tile passes). At B > 1 one more set fires every block,
    # each in one stream other than stream 0 alone: the fired list is the
    # union over the streams of a pass, not stream 0's blocks
    n_q8 = 0
    for (cell, be), prog in progs.items():
        if be == "fused":
            continue
        kern, ref = step_of[(cell, be)]
        gates = 3 if cell == "gru" else 4
        for li, lay in enumerate(prog.layouts):
            lay_cpu = cpu_progs[(cell, be)].layouts[li]
            nbk = lay.nbk
            for b in (1, 2, 8, 9):
                plan = q8_launch_plan(gates, lay.weight_bits, lay.block_k,
                                      lay.ip, lay.ip + lay.hk,
                                      lay.hidden_size, b, False)
                u = plan.blocks_per_group
                counts, seam, sets = walk_sets(lay, u, b)
                ok, ok_b, err, err_b = q8_cases(cell, kern, ref, lay,
                                                lay_cpu, b, sets)
                n_q8 += len(sets)
                solo = ", every block in one stream > 0" if b > 1 else ""
                what = (f"layer {li} B={b} ({plan.instance}, U={u}): fired "
                        f"blocks {counts} of {nbk}, {list(seam)} across "
                        f"the seam{solo}, bitwise on the card and the CPU")
                check(kernel_of[(cell, be)].name, ok, err, what)
                check(buffered[(cell, be)].name, ok_b, err_b,
                      what + ", and equal to the unbuffered kernel")
    log(f"int8/int4 walk cases: {n_q8} fired sets, each through both forms")

    # the LSTM cell state at the Q8.8 rail: gates i, f, g driven to 1.0 by
    # their delta memories, c_prev one step below the rail in stream 0 (it
    # must clip to act_max, never wrap) and near the other rail in stream 1.
    # M = 1.5 * 2**14 in the code domain dequantizes to about 8 (int8) or
    # 150 (int4) and keeps every sum with the Q8.8 products exact in fp32.
    for be in ("fused_q8", "fused_q4"):
        lay = progs[("lstm", be)].layouts[0]
        lay_cpu = cpu_progs[("lstm", be)].layouts[0]
        ins, _ = layer_inputs(rng, 2, lay, 0.1, True)
        h_dim = lay.hidden_size
        ins[0][:, :3 * h_dim] = 24576.0
        ins[2][0], ins[2][1] = 255.5, -255.5
        args = [torch.from_numpy(a) for a in ins]
        gpu = [a.to(dev) for a in args]
        k = deltalstm_q8_step(lay, *gpu)
        kb = deltalstm_q8_step(lay, *gpu, buffered=True)
        r = deltalstm_q8_step_ref(lay, *gpu)
        c = deltalstm_q8_step_ref(lay_cpu, *args)
        torch.cuda.synchronize()
        at_rail = bool((k[2][0] == lay.act_max).all())
        log(f"saturating cell state {be}: c[0] max {float(k[2][0].max())} "
            f"(act_max {lay.act_max}), all at the rail {at_rail}, "
            f"c[1] min {float(k[2][1].min())}")
        check(kernel_of[("lstm", be)].name,
              at_rail and same(k, r) and same(k, c), max_diff(k, r),
              "saturating c")
        check(buffered[("lstm", be)].name, same(kb, k) and same(kb, c),
              max_diff(kb, r), "saturating c")

    # narrow layouts at the first layer's shape: block rows that are not a
    # multiple of 16 bytes run the narrow-load instance, and the buffered
    # form fills its ring without tensor copies: cp.async of 8 bytes (int8
    # block_k 8, int4 block_k 16), of 4 bytes (int8 block_k 4) or 2-byte
    # copies (int4 block_k 4). Each bitwise against the plain version on
    # the card and the CPU, the buffered form against the unbuffered one
    narrow = {8: (8, 4), 4: (16, 4)}
    for cell in ("gru", "lstm"):
        gates = 3 if cell == "gru" else 4
        kern, ref = step_of[(cell, "fused_q8")]
        p0 = models_cpu[cell][cell][0]
        for bits, block_ks in narrow.items():
            for block_k in block_ks:
                lay_cpu = pack_delta_weights_q8(p0.w_x, p0.w_h, p0.b,
                                                gates=gates, block_k=block_k,
                                                weight_bits=bits)
                lay = lay_cpu.to(dev)
                nbk = lay.nbk
                counts = (0, 1, 5, nbk)
                sets = [(tuple(sorted(rng.choice(nbk, n, replace=False))),
                         False) for n in counts]
                ok = ok_b = True
                err = err_b = 0.0
                for b in (1, 9):
                    plan = q8_launch_plan(gates, bits, block_k, lay.ip,
                                          lay.ip + lay.hk, lay.hidden_size,
                                          b, True)
                    o, o_b, e, e_b = q8_cases(cell, kern, ref, lay, lay_cpu,
                                              b, sets)
                    ok = ok and o and plan.instance == "narrow"
                    ok_b = ok_b and o_b
                    err, err_b = max(err, e), max(err_b, e_b)
                what = (f"narrow layout block_k={block_k} "
                        f"({plan.vector_bytes}-byte loads), B in (1, 9), "
                        f"fired blocks {list(counts)} of {nbk}: bitwise on "
                        f"the card and the CPU")
                check(ops.q8_kernel(gates, bits, False).name, ok, err, what)
                check(ops.q8_kernel(gates, bits, True).name, ok_b, err_b,
                      f"{what}, the ring filled by {plan.fill} "
                      f"({plan.copy_bytes} B), equal to the unbuffered "
                      f"kernel")

    # the narrow rings again with a cold L2: flushed before each buffered
    # launch, a stage's copies come from device memory and land late
    # enough that a consumer that read a stage before its barrier said the
    # copies were in would see the stage's old bytes (with the L2 warm,
    # such a read came too late to tell). Each narrow layout of the GRU,
    # B in (1, 9), 30 launches each on every block or half of them fired,
    # each bitwise equal to the unbuffered kernel
    flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.float32, device=dev)
    flush.fill_(1.0)
    sink = torch.empty((), dtype=torch.float32, device=dev)
    kern = step_of[("gru", "fused_q8")][0]
    p0 = models_cpu["gru"]["gru"][0]
    for bits, block_ks in narrow.items():
        for block_k in block_ks:
            lay = pack_delta_weights_q8(p0.w_x, p0.w_h, p0.b, gates=3,
                                        block_k=block_k,
                                        weight_bits=bits).to(dev)
            ok, err = True, 0.0
            for b in (1, 9):
                plan = q8_launch_plan(3, bits, block_k, lay.ip,
                                      lay.ip + lay.hk, lay.hidden_size, b,
                                      True)
                for rep in range(30):
                    n = lay.nbk if rep % 2 == 0 else lay.nbk // 2
                    fired = tuple(sorted(rng.choice(lay.nbk, n,
                                                    replace=False)))
                    gpu = [torch.from_numpy(a).to(dev)
                           for a in fired_inputs(rng, b, lay, fired)]
                    k = run_step("gru", kern, lay, gpu)
                    torch.sum(flush, dim=0, out=sink)
                    kb = run_step("gru", functools.partial(kern,
                                                           buffered=True),
                                  lay, gpu)
                    torch.cuda.synchronize()
                    ok = ok and same(kb, k)
                    err = max(err, max_diff(kb, k))
            check(ops.q8_kernel(3, bits, True).name, ok, err,
                  f"narrow layout block_k={block_k}, the ring filled by "
                  f"{plan.fill} ({plan.stages} stages), B in (1, 9), 30 "
                  "launches each after an L2 flush: bitwise equal to the "
                  "unbuffered kernel")

    # the LM-path kernels: delta_spmv at the RWKV6 and RG-LRU layer shapes
    # ([I -> O]; the decay LoRA's 64 rows in a 128-padded layout, whose k
    # blocks the plan splits over a cluster), two unpacked ragged edges
    # (I = 1000: 16-byte loads, the last block masked; I = 999: ldw % 4 != 0,
    # the narrow instance) and a narrow split (I = 1002 -> 130), fp32 and
    # bf16, B in {1, 2, 8, 9}, on exactly 0, 1, U - 1, U, U + 1 and all
    # fired blocks (U: the blocks one unrolled group of the walk covers)
    # and, at B > 1, every block fired by one stream other than stream 0
    # alone; every case launched twice, the two results bitwise equal
    spmv_shapes = [("2048->2048", 2048, 2048, True),
                   ("2048->64", 2048, 64, True),
                   ("4096->4096", 4096, 4096, True),
                   ("1000->999 unpacked", 1000, 999, False),
                   ("999->1000 unpacked", 999, 1000, False),
                   ("1002->130 unpacked", 1002, 130, False)]
    spmv_kinfo = {torch.float32: (ops.DELTA_SPMV_F32, TOL_F32),
                  torch.bfloat16: (ops.DELTA_SPMV_BF16, TOL_BF16)}
    spmv_kinfo_all = [k for k, _ in spmv_kinfo.values()]
    n_spmv = 0
    for label, i_dim, o_dim, packed in spmv_shapes:
        w32 = torch.from_numpy(rng.normal(0, i_dim ** -0.5, (
            o_dim, i_dim)).astype(np.float32))
        nbk = -(-i_dim // 128)
        for dtype, (kinfo, tol) in spmv_kinfo.items():
            w = w32.to(dtype)
            w_op = (pack_spmv_weights(w) if packed else w).to(dev)
            w_dev = w.to(dev)
            for b in (1, 2, 8, 9):
                plan = spmv_launch_plan(o_dim, i_dim, w_op.shape[1], 128, b,
                                        dtype)
                u = plan.blocks_per_group
                counts = sorted({n for n in (0, 1, u - 1, u, u + 1, nbk)
                                 if 0 <= n <= nbk})
                sets = [(tuple(sorted(rng.choice(nbk, n, replace=False))),
                         False) for n in counts]
                if b > 1:
                    sets.append((tuple(range(nbk)), True))
                err = err_c = err_abs = 0.0
                twice = True
                for fired, solo in sets:
                    dx, acc = (torch.from_numpy(a).to(dtype) for a in
                               spmv_fired(rng, i_dim, o_dim, b, fired, solo))
                    gpu = [w_op, dx.to(dev), acc.to(dev)]
                    kw = dict(packed=packed, out_dim=o_dim if packed else None)
                    k = delta_spmv(*gpu, **kw)
                    k2 = delta_spmv(*gpu, **kw)
                    r = delta_spmv_ref(w_dev, gpu[1], gpu[2])
                    c = delta_spmv_ref(w, dx, acc)
                    torch.cuda.synchronize()
                    err = max(err, scaled_err(k.float(), r.float()))
                    err_c = max(err_c, scaled_err(k.float(), c.float()))
                    err_abs = max(err_abs, max_diff([k.float()], [r.float()]))
                    twice = (twice and torch.equal(k, k2)
                             and k.dtype == r.dtype == c.dtype)
                n_spmv += len(sets)
                solo = ", every block in one stream > 0" if b > 1 else ""
                check(kinfo.name, err <= tol and err_c <= tol and twice,
                      err_abs,
                      f"[{label}] B={b} ({plan.instance}, split "
                      f"{plan.split}, U={u}): fired blocks {counts} of "
                      f"{nbk}{solo}, within {tol:.3g} of max(1, |plain|) on "
                      f"the card and the CPU (scaled {max(err, err_c):.3e}), "
                      f"two launches bitwise equal {twice}")
    log(f"delta_spmv walk cases: {n_spmv} fired sets, each launched twice")
    # the scans: rwkv6_scan at B in {1, 2, 8, 9} (one stream, two, the
    # 8-slot batcher, more units than one block a unit) x T in {1, 37, 128}
    # x H in {32, 3} (the main path's heads, and fewer heads than the SMs),
    # with s0 and with a zero state (s0=None), within TOL_F32 of its plain
    # version on the card and the CPU; rglru_scan at W in {4096, 4094, 4097}
    # (the 16-byte path, and ragged rows of the 4-byte path) over the same B
    # and T, with h0 and without, bitwise equal to its plain version on the
    # card and within TOL_F32 of it on the CPU (PyTorch's float32 sqrt on
    # the CPU is not correctly rounded: up to an ulp off); each also with an
    # operand that is a contiguous view one float into its buffer (4-byte
    # aligned: the 4-byte path). Every case launched twice, the two results
    # bitwise equal
    def scan_case(kinfo, kern, ref, cpu_args, dev_args, exact, what):
        """``exact``: bitwise equal to the plain version on the card (and
        within TOL_F32 of it on the CPU, whose float32 sqrt is not
        correctly rounded); else within TOL_F32 of both."""
        k = kern(*dev_args)
        k2 = kern(*dev_args)
        r = ref(*dev_args)
        c = ref(*cpu_args)
        torch.cuda.synchronize()
        twice = same(k, k2)
        err_c = max(scaled_err(a, bb) for a, bb in zip(k, c))
        ok = err_c <= TOL_F32 and (
            same(k, r) if exact
            else max(scaled_err(a, bb) for a, bb in zip(k, r)) <= TOL_F32)
        check(kinfo.name, ok and twice, max_diff(k, r),
              f"{what} (CPU: scaled {err_c:.3e}), two launches bitwise "
              f"equal {twice}")

    n_scan = 0
    for b in (1, 2, 8, 9):
        for t in (1, 37, 128):
            for h in (32, 3):
                shape = (b, h, t, 64)
                wkv = [rng.normal(0, 1, shape), rng.normal(0, 1, shape),
                       rng.normal(0, 1, shape),
                       np.exp(-np.exp(rng.normal(-3, 1.5, shape))),
                       rng.normal(0, 0.1, (h, 64)),
                       rng.normal(0, 1, (b, h, 64, 64))]
                wkv = [torch.from_numpy(a.astype(np.float32)) for a in wkv]
                gpu = [a.to(dev) for a in wkv]
                plan = rwkv6_scan_plan(b, h, t, 64)
                for with_s0 in (True, False):
                    n = 6 if with_s0 else 5
                    scan_case(ops.RWKV6_SCAN_F32, rwkv6_scan,
                              rwkv6_scan_batched_ref, wkv[:n], gpu[:n],
                              False,
                              f"[{b}, {h}, {t}, 64] "
                              f"{'with s0' if with_s0 else 's0=None'} "
                              f"({plan.cols} columns a block, grid "
                              f"{plan.grid} for {plan.units} units), within "
                              f"{TOL_F32} of max(1, |plain|) on the card "
                              "and the CPU")
                    n_scan += 1
                if (b, t) in ((1, 1), (2, 37)):
                    # the 4-byte path: r and s0 one float into their buffers
                    mis = [offset_view(gpu[0])] + gpu[1:5] + [
                        offset_view(gpu[5])]
                    scan_case(ops.RWKV6_SCAN_F32, rwkv6_scan,
                              rwkv6_scan_batched_ref, wkv, mis, False,
                              f"[{b}, {h}, {t}, 64] r and s0 4-byte aligned "
                              f"(4-byte loads), within {TOL_F32} on the "
                              "card and the CPU")
                    n_scan += 1
            for w in (4096, 4094, 4097):
                shape = (b, t, w)
                lru = [rng.normal(0, 1, shape),
                       1 / (1 + np.exp(-rng.normal(2, 1, shape))),
                       rng.normal(0, 1, (b, w))]
                lru = [torch.from_numpy(a.astype(np.float32)) for a in lru]
                gpu = [a.to(dev) for a in lru]
                plan = rglru_scan_plan(b, t, w)
                for with_h0 in (True, False):
                    n = 3 if with_h0 else 2
                    scan_case(ops.RGLRU_SCAN_F32, rglru_scan,
                              rglru_scan_batched_ref, lru[:n], gpu[:n], True,
                              f"[{b}, {t}, {w}] "
                              f"{'with h0' if with_h0 else 'h0=None'} "
                              f"({plan.vec * 4}-byte loads, {plan.threads} "
                              f"threads a block, grid {plan.grid}), bitwise "
                              "on the card")
                    n_scan += 1
                if w == 4096 and t in (1, 37):
                    for i in range(3):     # x, a and h0 in turn
                        mis = list(gpu)
                        mis[i] = offset_view(gpu[i])
                        scan_case(ops.RGLRU_SCAN_F32, rglru_scan,
                                  rglru_scan_batched_ref, lru, mis, True,
                                  f"[{b}, {t}, {w}] {'xah'[i]}"
                                  f"{'' if i < 2 else '0'} 4-byte aligned "
                                  "(4-byte loads), bitwise on the card")
                        n_scan += 1
    # row 9b, rwkv6_scan's bf16 instance (bf16 r, k, v; fp32 w, u, s0): B
    # in {1, 4, 9} (one stream, the LM engine's 4 slots, more units than
    # blocks at H = 32) x T in {1, 37, 128} x H in {32, 3}, with s0 and
    # without, and r one element into its buffer (2-byte aligned: the scalar
    # loads); within TOL_F32 of the plain version on the card and the CPU,
    # which round k v to bf16 as the kernel does
    bf16 = torch.bfloat16
    for b in (1, 4, 9):
        for t in (1, 37, 128):
            for h in (32, 3):
                shape = (b, h, t, 64)
                wkv = [torch.from_numpy(rng.normal(0, 1, shape).astype(
                    np.float32)).to(bf16) for _ in range(3)]
                wkv += [torch.from_numpy(a.astype(np.float32)) for a in (
                    np.exp(-np.exp(rng.normal(-3, 1.5, shape))),
                    rng.normal(0, 0.1, (h, 64)),
                    rng.normal(0, 1, (b, h, 64, 64)))]
                gpu = [a.to(dev) for a in wkv]
                plan = rwkv6_scan_plan(b, h, t, 64, bf16)
                for with_s0 in (True, False):
                    n = 6 if with_s0 else 5
                    scan_case(ops.RWKV6_SCAN_BF16, rwkv6_scan,
                              rwkv6_scan_batched_ref, wkv[:n], gpu[:n],
                              False,
                              f"bf16 r k v [{b}, {h}, {t}, 64] "
                              f"{'with s0' if with_s0 else 's0=None'} "
                              f"(grid {plan.grid} for {plan.units} units), "
                              f"within {TOL_F32} of max(1, |plain|) on the "
                              "card and the CPU")
                    n_scan += 1
                if t == 37:
                    mis = [offset_view(gpu[0])] + gpu[1:]
                    scan_case(ops.RWKV6_SCAN_BF16, rwkv6_scan,
                              rwkv6_scan_batched_ref, wkv, mis, False,
                              f"bf16 r k v [{b}, {h}, {t}, 64], r 2-byte "
                              f"aligned (scalar loads), within {TOL_F32} on "
                              "the card and the CPU")
                    n_scan += 1
    # the chunked kernel's edges (rwkv6_scan at T > 1 stages RWKV6_CHUNK
    # steps at a time; T in {37, 128} are above): T in {2, chunk - 1,
    # chunk, chunk + 1} for both instances at B in {1, 4, 9} x H in {32, 3},
    # with s0 and without, with r one element into its buffer (element
    # copies in place of 16-byte ones) and with r, k, v, w in the model's
    # [B, T, H, D] memory (read in place); at B = 9, H = 32 the blocks
    # walk the units (more units than the SMs hold blocks); within TOL_F32
    # of the plain version on the card and the CPU, two launches bitwise
    # equal. From a generator of their own: the other phases' inputs stay
    wkv_rng = np.random.default_rng(SEED + 7)
    chunk = RWKV6_CHUNK
    for kinfo, in_dt in ((ops.RWKV6_SCAN_F32, torch.float32),
                         (ops.RWKV6_SCAN_BF16, bf16)):
        for b in (1, 4, 9):
            for t in (2, chunk - 1, chunk, chunk + 1):
                for h in (32, 3):
                    shape = (b, h, t, 64)
                    wkv = [torch.from_numpy(wkv_rng.normal(0, 1, shape).astype(
                        np.float32)).to(in_dt) for _ in range(3)]
                    wkv += [torch.from_numpy(a.astype(np.float32)) for a in (
                        np.exp(-np.exp(wkv_rng.normal(-3, 1.5, shape))),
                        wkv_rng.normal(0, 0.1, (h, 64)),
                        wkv_rng.normal(0, 1, (b, h, 64, 64)))]
                    gpu = [a.to(dev) for a in wkv]
                    plan = rwkv6_scan_plan(b, h, t, 64, in_dt)
                    # r, k, v, w as the model hands them: [B, H, T, D]
                    # views of contiguous [B, T, H, D] tensors
                    tmajor = [z.movedim(2, 1).contiguous().movedim(1, 2)
                              for z in gpu[:4]] + gpu[4:]
                    cases = [
                        (rwkv6_scan, gpu, "with s0"),
                        (rwkv6_scan, gpu[:5], "s0=None"),
                        (rwkv6_scan, [offset_view(gpu[0])] + gpu[1:],
                         "r one element into its buffer (element copies)"),
                        (rwkv6_scan, tmajor,
                         "r k v w views of [B, T, H, D] (read in place)")]
                    for kern, dev_args, what in cases:
                        scan_case(kinfo, kern, rwkv6_scan_batched_ref,
                                  wkv[:len(dev_args)], dev_args, False,
                                  f"{in_dt} r k v [{b}, {h}, {t}, 64] {what} "
                                  f"(chunk {plan.chunk}, {plan.cols} columns "
                                  f"a block, grid {plan.grid} for "
                                  f"{plan.units} units), within {TOL_F32} "
                                  "of max(1, "
                                  "|plain|) on the card and the CPU")
                        n_scan += 1
    log(f"scan cases: {n_scan}, each launched twice")
    # the engine step's Delta Unit and epilogue (inputs from a generator of
    # their own: the other phases' inputs stay)
    eng_k = engine_kernels_phase(dev, np.random.default_rng(SEED + 5))
    for name, e in eng_k["max_err"].items():
        max_err[name] = max(max_err[name], e)
    log(f"engine kernel cases: {eng_k['cases']}, each launched twice")
    # the train steps' fused AdamW update
    adam_k = adam_kernels_phase(dev)
    for name, e in adam_k["max_err"].items():
        max_err[name] = max(max_err[name], e)
    # the clip's global norm
    norm_k = norm_kernels_phase(dev)
    for name, e in norm_k["max_err"].items():
        max_err[name] = max(max_err[name], e)
    phase3 = ops.launch_counts()

    phase("4")
    # -- 4. exhaustive activation grid ------------------------------------
    lay_q = progs[("gru", "fused_q8")].layouts[0]
    sig, tnh = lut_activation_grid(lay_q, dev)
    rsig, rtnh = lut_activation_grid_ref(lay_q)
    n_bad = int((sig.cpu() != rsig).sum()) + int((tnh.cpu() != rtnh).sum())
    log(f"activation grid: {sig.numel()} Q8.8 inputs, sigmoid+tanh "
        f"mismatches after LUT rounding: {n_bad}")
    if n_bad:
        raise AssertionError(f"{n_bad} activation-grid mismatches")

    phase("5")
    # -- 5. main path -----------------------------------------------------
    task = GruTaskConfig(cfg.input_size, cfg.hidden_size, cfg.num_layers,
                         cfg.output_size, theta_x=THETA, theta_h=THETA)
    frames = smooth_frames(rng, N_FRAMES, 1, cfg.input_size)[:, 0]
    lengths = rng.integers(20, 61, 16)
    requests = [smooth_frames(rng, int(t), 1, cfg.input_size)[:, 0]
                for t in lengths]
    launches = {}
    main_rates = {}
    wall_us = {}
    eager_us = {}
    batch_fps = {}
    # each path's 1-stream engine after its run, its program and task, the
    # launches of one of its steps, and frames for the resilience phase
    # (drawn from a generator of their own: the other phases' inputs stay)
    main_engines = {}
    res_rng = np.random.default_rng(SEED + 1)

    for (cell, be), prog in progs.items():
        path = f"{cell} {be}"
        kinfo = kernel_of[(cell, be)]
        # warm-up (cuBLAS handle, allocator), then the counted runs; each
        # engine captures its step at construction
        DeltaStreamEngine(prog, task).step_many(frames[:4])
        torch.cuda.synchronize()

        eng = DeltaStreamEngine(prog, task)
        warm_chunks(eng, frames)
        ref = DeltaStreamEngine(prog, task)
        t0 = time.perf_counter()
        ref_outs = eager_steps(ref, frames)
        torch.cuda.synchronize()
        eager_us[path] = 1e6 * (time.perf_counter() - t0) / N_FRAMES
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = eng.step_many(frames)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall_us[path] = 1e6 * (time.perf_counter() - t0) / N_FRAMES
        n1 = {k: v for k, v in ops.launch_counts().items() if v}
        per_step = step_launches({kinfo.name: cfg.num_layers},
                                 cfg.num_layers)
        want = times(per_step, N_FRAMES)
        if n1 != want:
            raise AssertionError(f"{path}: launches {n1}, want {want}")
        graph_check(path, eng, WARM_FRAMES + N_FRAMES)
        log(graph_against_eager(path, eng, ref, outs, ref_outs))
        main_engines[path] = (eng, prog, task, per_step,
                              smooth_frames(res_rng, 41, 1,
                                            cfg.input_size)[:, 0])

        eng8 = DeltaStreamEngine(prog, task, n_streams=8)
        batcher = GruStreamBatcher(eng8)
        for fr in requests:
            batcher.submit(fr)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = batcher.run_until_drained()
        torch.cuda.synchronize()
        batch_fps[path] = sum(len(fr) for fr in requests) / (
            time.perf_counter() - t0)
        n8 = {k: v for k, v in ops.launch_counts().items() if v}
        want8 = times(per_step, batcher.counters["ticks"])
        if n8 != want8:
            raise AssertionError(f"{path} batcher: launches {n8}, want "
                                 f"{want8}")
        graph_check(f"{path} batcher", eng8, batcher.counters["ticks"])
        add_counts(launches, n1)
        add_counts(launches, n8)
        rep1 = eng.report()
        main_rates[path] = (rep1["gamma_dx"], rep1["gamma_dh"],
                            wall_us[path])
        log(f"main path {path}: 1 stream {N_FRAMES} steps -> "
            f"{n1[kinfo.name]} launches; 8-slot batcher {len(done)} "
            f"requests in {batcher.counters['ticks']} ticks -> "
            f"{n8[kinfo.name]} launches; {wall_us[path]:.1f} us/step wall "
            f"(eager {eager_us[path]:.1f}); report "
            f"{eng.report()['gamma_dx']:.4f} gamma_dx; graphs: 1 stream "
            f"{eng.graph_stats}, batcher {eng8.graph_stats}")

        # the same program on the CPU
        cpu_prog = cpu_progs[(cell, be)]
        if be == "fused":
            # θ = 0: no threshold decision can flip, so the engines agree
            # within the fp32 bound over a whole run
            t0_task = GruTaskConfig(cfg.input_size, cfg.hidden_size,
                                    cfg.num_layers, cfg.output_size)
            g = DeltaStreamEngine(prog, t0_task).step_many(frames[:50])
            c = DeltaStreamEngine(cpu_prog, t0_task,
                                  device="cpu").step_many(frames[:50])
            err0 = float((g.cpu() - c).abs().max())
            # θ > 0: a 1-ulp difference can flip a threshold decision, so
            # feed both the same state each step (lockstep)
            st = prog.init_state((1,))
            errs = 0.0
            for x in frames[:20]:
                xg = torch.from_numpy(x[None]).to(dev)
                yg, st_g, _ = prog.step(st, xg, THETA, THETA)
                yc, st_c, _ = cpu_prog.step(tree_to(st, "cpu"), xg.cpu(),
                                            THETA, THETA)
                for a, bb in zip(tree_leaves(st_g), tree_leaves(st_c)):
                    errs = max(errs, float((a.cpu() - bb).abs().max()))
                st = st_g
            log(f"  {path} vs cpu: theta=0 outputs {err0:.3e}, "
                f"theta={THETA} lockstep state {errs:.3e}")
            if err0 > TOL_F32 or errs > TOL_F32:
                raise AssertionError(f"{path} main path disagrees with the "
                                     "CPU program")
        else:
            ce = DeltaStreamEngine(cpu_prog, task, device="cpu")
            c_outs = ce.step_many(frames)
            same_state = all(torch.equal(a.cpu(), bb) for a, bb in zip(
                tree_leaves(eng.state), tree_leaves(ce.state)))
            head_err = float((outs.cpu() - c_outs).abs().max())
            cb = GruStreamBatcher(DeltaStreamEngine(cpu_prog, task,
                                                    n_streams=8,
                                                    device="cpu"))
            for fr in requests:
                cb.submit(fr)
            c_done = {r.uid: r for r in cb.run_until_drained()}
            b_err = max(float(np.abs(np.stack(r.outputs)
                                     - np.stack(c_done[r.uid].outputs)).max())
                        for r in done)
            log(f"  {path} vs cpu: final state bitwise {same_state}, "
                f"outputs {head_err:.3e}, batcher outputs {b_err:.3e}")
            if not same_state or head_err > TOL_HEAD or b_err > TOL_HEAD:
                raise AssertionError(f"{path} main path disagrees with the "
                                     "CPU program")
        if not torch.isfinite(outs).all():
            raise AssertionError(f"{path}: non-finite outputs")

    phase("5b")
    # -- 5b. main path of the delta-ized LM cells -------------------------
    lm_specs = {"rwkv6": (init_deltarwkv_model, RWKV6_CONFIG.d_model,
                          RWKV6_CONFIG.n_layers, ops.RWKV6_SCAN_F32),
                "rglru": (init_deltarglru_model, RGLRU_CONFIG.d_model,
                          RGLRU_LAYERS, ops.RGLRU_SCAN_F32)}
    spmv = ops.DELTA_SPMV_F32
    lm = {}
    for cell, (init, d, n_layers, scan) in lm_specs.items():
        path = f"{cell} fused"
        t0 = time.perf_counter()
        lm_model = init(SEED, d, n_layers, LM_OUTPUT, device="cpu")
        lm_prog = compile_delta_program(lm_model, "fused", cell=cell)
        lm_cpu = compile_delta_program(lm_model, "fused", cell=cell,
                                       device="cpu")
        torch.cuda.synchronize()
        n_w = sum(t.numel() for p in lm_model[cell] for t in p)
        n_pack = sum(t.numel() for lay in lm_prog.layouts for t in lay)
        log(f"{path}: D={d}, {n_layers} layers, {n_w} weights "
            f"({4 * n_w / 1e9:.3f} GB) + {4 * n_pack / 1e9:.3f} GB packed, "
            f"built and compiled in {time.perf_counter() - t0:.1f} s")
        lm_task = GruTaskConfig(d, d, n_layers, LM_OUTPUT, theta_x=THETA,
                                theta_h=THETA)
        frames_lm = lm_stream(rng, N_FRAMES, d)
        requests_lm = [lm_stream(rng, int(t), d)
                       for t in rng.integers(20, 61, 16)]
        DeltaStreamEngine(lm_prog, lm_task).step_many(frames_lm[:4])
        torch.cuda.synchronize()

        lm_eng = DeltaStreamEngine(lm_prog, lm_task)
        warm_chunks(lm_eng, frames_lm)
        lm_ref = DeltaStreamEngine(lm_prog, lm_task)
        t0 = time.perf_counter()
        lm_ref_outs = eager_steps(lm_ref, frames_lm)
        torch.cuda.synchronize()
        eager_us[path] = 1e6 * (time.perf_counter() - t0) / N_FRAMES
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            lm_outs = lm_eng.step_many(frames_lm)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall_us[path] = 1e6 * (time.perf_counter() - t0) / N_FRAMES
        n1 = {k: v for k, v in ops.launch_counts().items() if v}
        # a Delta Unit a layer (RWKV6: its four streams together; RG-LRU
        # one before and one after its conv)
        lm_step = step_launches({spmv.name: 4 * n_layers,
                                 scan.name: n_layers},
                                n_layers * (2 if cell == "rglru" else 1))
        want = times(lm_step, N_FRAMES)
        if n1 != want:
            raise AssertionError(f"{path}: launches {n1}, want {want}")
        graph_check(path, lm_eng, WARM_FRAMES + N_FRAMES)
        log(graph_against_eager(path, lm_eng, lm_ref, lm_outs, lm_ref_outs))
        del lm_ref, lm_ref_outs
        main_engines[path] = (lm_eng, lm_prog, lm_task, lm_step,
                              lm_stream(res_rng, 41, d))

        lm_batcher = GruStreamBatcher(DeltaStreamEngine(lm_prog, lm_task,
                                                     n_streams=8))
        for fr in requests_lm:
            lm_batcher.submit(fr)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        lm_done = lm_batcher.run_until_drained()
        torch.cuda.synchronize()
        batch_fps[path] = sum(len(fr) for fr in requests_lm) / (
            time.perf_counter() - t0)
        ticks = lm_batcher.counters["ticks"]
        n8 = {k: v for k, v in ops.launch_counts().items() if v}
        want8 = times(lm_step, ticks)
        if n8 != want8 or len(lm_done) != len(requests_lm):
            raise AssertionError(f"{path} batcher: launches {n8}, want "
                                 f"{want8}; {len(lm_done)} requests done")
        graph_check(f"{path} batcher", lm_batcher.engine, ticks)
        add_counts(launches, n1)
        add_counts(launches, n8)
        lm_rep = lm_eng.report()
        log(f"main path {path}: 1 stream {N_FRAMES} steps -> {n1}; 8-slot "
            f"batcher {len(lm_done)} requests in {ticks} ticks -> {n8}; "
            f"{wall_us[path]:.1f} us/step wall (eager "
            f"{eager_us[path]:.1f}); report gamma_dx "
            f"{lm_rep['gamma_dx']:.4f} gamma_dh {lm_rep['gamma_dh']:.4f}; "
            f"graphs: 1 stream {lm_eng.graph_stats}, batcher "
            f"{lm_batcher.engine.graph_stats}")
        if not torch.isfinite(lm_outs).all():
            raise AssertionError(f"{path}: non-finite outputs")

        # the same program on the CPU: θ = 0 over 50 frames (nothing can
        # flip), then layer by layer in lockstep at θ = 0.25
        lm_task0 = GruTaskConfig(d, d, n_layers, LM_OUTPUT)
        ge = DeltaStreamEngine(lm_prog, lm_task0)
        ce = DeltaStreamEngine(lm_cpu, lm_task0, device="cpu")
        g = ge.step_many(frames_lm[:50])
        c = ce.step_many(frames_lm[:50])
        err0 = max([scaled_err(g, c)] + [
            scaled_err(a, bb) for a, bb in zip(tree_leaves(ge.state),
                                               tree_leaves(ce.state))])
        err_ls, flips, n_ls, in_max = lm_layer_lockstep(
            lm_prog, lm_cpu, frames_lm[:20], THETA, tree_to, tree_leaves)
        log(f"  {path} vs cpu: theta=0 outputs and final state {err0:.3e} "
            f"(scaled), theta={THETA} lockstep {err_ls:.3e} over "
            f"{n_ls - flips} layer steps, {flips} with a flipped firing "
            f"decision; max |layer input| per layer "
            f"{[float(f'{v:.3g}') for v in in_max]}")
        if err0 > TOL_LM or err_ls > TOL_LM or flips > n_ls // 100:
            raise AssertionError(f"{path} main path disagrees with the CPU "
                                 "program")
        lm[cell] = (lm_prog, lm_task, frames_lm)
        del lm_cpu, ge, ce

    phase("5c")
    # -- 5c. resilience ---------------------------------------------------
    # (a) a checkpoint/restore round trip on each path's 1-stream engine,
    # then corruption and rollback on the restored one; each engine's exact
    # launches, no other kernel
    Recorded = recording(DeltaStreamEngine)
    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory() as tmp:
        for path, (eng, prog_p, task_p, per_step, fr) in main_engines.items():
            ops.reset_launch_counts()
            rt = restore_round_trip(path, eng, prog_p, task_p, fr, Recorded,
                                    os.path.join(tmp, path.replace(" ", "_")))
            n = {k: v for k, v in ops.launch_counts().items() if v}
            want = {k: rt["steps"] * v for k, v in per_step.items()}
            if n != want:
                raise AssertionError(f"{path} round trip: launches {n}, "
                                     f"want {want}")
            add_counts(launches, n)
            log(f"resilience {path}: checkpoint {rt['ckpt_ms']:.3f} ms, "
                f"restore {rt['restore_ms']:.3f} ms (capture "
                f"{rt['capture_ms']:.3f} ms), round trip bitwise over 20 "
                "replays, corruption flagged by the next replay, rollback "
                f"bitwise; launches {n} [{smi}]")
        del main_engines

        # (b) the seeded chaos soak through serve_resumable at 2L-768H,
        # fused_q8 on 8 slots: twice on the card, once on the CPU
        q8 = ops.DELTA_Q8_GRU_I8
        soak_prog = quantize_delta_model(models["gru"])
        soak_cpu = quantize_delta_model(models_cpu["gru"], device="cpu")
        runs = []
        saved = resilience.DeltaStreamEngine
        resilience.DeltaStreamEngine = Recorded
        try:
            for k in range(2):
                Recorded.made.clear()
                ops.reset_launch_counts()
                run = chaos_soak(soak_prog, task, dev,
                                 os.path.join(tmp, f"soak{k}"))
                n = {k2: v for k2, v in ops.launch_counts().items() if v}
                made = list(Recorded.made)
                steps = sum(engine_steps(e) for e in made)
                want = times(step_launches({q8.name: cfg.num_layers},
                                           cfg.num_layers), steps)
                if n != want:
                    raise AssertionError(f"soak {k}: launches {n}, want "
                                         f"{want}")
                if len(made) != 2 or not all(
                        e.graph_stats["captures"] == 1
                        and e.captured_ptrs == buffer_ptrs(e) for e in made):
                    raise AssertionError(
                        f"soak {k}: engines {[e.graph_stats for e in made]}"
                        ", want 2 (one restored after the crash), each "
                        "one capture over the buffers it still has")
                add_counts(launches, n)
                check_soak(run, f"soak {k} on the card")
                run["restore_capture_ms"] = 1e3 * made[1].graph_stats[
                    "capture_s"]
                runs.append(run)
            cpu_run = chaos_soak(soak_cpu, task, cpu,
                                 os.path.join(tmp, "soak_cpu"))
        finally:
            resilience.DeltaStreamEngine = saved
        check_soak(cpu_run, "soak on the CPU")
        for other, what in ((runs[1], "the second card run"),
                            (cpu_run, "the CPU run")):
            if (other["statuses"] != runs[0]["statuses"]
                    or other["counters"] != runs[0]["counters"]
                    or other["srv"].theta_peak != runs[0]["srv"].theta_peak
                    or other["srv"].tick_no != runs[0]["srv"].tick_no):
                raise AssertionError(
                    f"soak: {what} differs: {other['counters']} against "
                    f"{runs[0]['counters']}")
        checked = soak_reference_check(soak_prog, task, runs[0], dev)
        soak_err = max(
            float(np.abs(np.stack(r.outputs) - np.stack(
                cpu_run["results"][i].outputs)).max())
            for i, r in runs[0]["results"].items() if r.status == "ok")
        if soak_err > TOL_HEAD:
            raise AssertionError(f"soak outputs: card against CPU "
                                 f"{soak_err:.3e} > {TOL_HEAD}")
        for k, run in enumerate(runs):
            srv = run["srv"]
            statuses = {s: sum(v == s for v in run["statuses"].values())
                        for s in ("ok", "shed", "rejected", "quarantined")}
            log(f"soak {k} (fused_q8 2L-768H, 8 slots, serve_resumable): "
                f"{SOAK_ARRIVALS} arrivals in {srv.tick_no} ticks, "
                f"{run['wall_s']:.4f} s wall, {run['ok_frames']} frames of "
                f"ok streams, {run['ok_frames'] / run['wall_s']:.1f} "
                f"frames/s; p99 tick "
                f"wall {1e3 * srv.p99_tick_wall_s():.4f} ms, median "
                f"{1e3 * float(np.median(srv.tick_wall_s)):.4f} ms; restart "
                f"capture {run['restore_capture_ms']:.3f} ms; restarts "
                f"{run['restarts']}; statuses {statuses}; counters "
                f"{run['counters']} [{smi}]")
        log(f"soak: the two card runs and the CPU run agree in every "
            f"status and counter; {checked} ok streams bitwise equal to a "
            f"clean 8-slot run on the card; card against CPU outputs "
            f"{soak_err:.3e}")
        del runs, cpu_run, soak_cpu

    phase("5d")
    # -- 5d. training: the paper's recipe at 2L-768H ----------------------
    train, batches, opt_cfg = training_phase(dev, PAPER_NETWORKS["2L-768H"])
    add_counts(launches, train["serve"]["launches"])
    add_counts(launches, train["adam_launches"])

    phase("5e")
    # -- 5e. the serving fabric -------------------------------------------
    fabric = fabric_phase(dev, models["gru"], ops.DELTA_Q8_GRU_I8,
                          ops.DELTAGRU_SEQ_F32, smi)
    for name, n in fabric["launches"].items():
        launches[name] += n

    phase("5f")
    # -- 5f. the LM zoo's serving path ------------------------------------
    zoo = lm_phase(dev, smi)
    for name, n in zoo["launches"].items():
        launches[name] = launches.get(name, 0) + n
    for name, err in zoo["max_err"].items():
        max_err[name] = max(max_err[name], err)

    phase("5g")
    # -- 5g. the rest of the LM zoo: MLA, MoE, cross-attention ------------
    zoo_rest = zoo_phase(dev, smi, zoo["served"])
    lm_prefill_rows(zoo["times"] | {k: v for k, v in zoo_rest.items()
                                    if k in zoo_rest["served"]}, smi)

    phase("5h")
    # -- 5h. LM training --------------------------------------------------
    lm_train = lm_train_phase(dev, smi)
    add_counts(launches, lm_train["adam_launches"])

    phase("5i")
    # -- 5i. the mesh paths -------------------------------------------------
    mesh_phase(dev, smi)

    phase("5j")
    # -- 5j. the examples and the launch tooling ------------------------------
    ex = examples_phase(dev, smi, {be: main_rates[f"gru {be}"]
                                   for be in ("fused", "fused_q8")})
    for name, n in ex["launches"].items():
        launches[name] = launches.get(name, 0) + n

    phase("5k")
    # -- 5k. the mesh paths over ranks ----------------------------------------
    rank_phase(dev, smi)

    phase("6")
    # -- 6. times on the card ---------------------------------------------
    ops.reset_launch_counts()
    instances = [(kernel_of[key], key, *step_of[key]) for key in progs]
    instances += [(kinfo, key,
                   functools.partial(step_of[key][0], buffered=True),
                   step_of[key][1]) for key, kinfo in buffered.items()]
    rows = {}
    # the floor under a launch: an empty kernel of the q8 build at the main
    # path's grid (the LSTM int8 step at B = 1), two launches a 2-layer step
    lay_f = progs[("lstm", "fused_q8")].layouts[1]
    plan_f = q8_launch_plan(4, 8, lay_f.block_k, lay_f.ip,
                            lay_f.ip + lay_f.hk, lay_f.hidden_size, 1, False)
    empty = _build.load("delta_q8.cu").delta_q8_empty
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    empty.restype = ctypes.c_int

    def empty_launch():
        if empty(plan_f.grid, plan_f.threads,
                 torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("delta_q8_empty launch failed")

    floor = {"ms": 2 * device_ms(empty_launch),
             "cold_ms": 2 * device_ms_cold(empty_launch)}
    log(f"launch floor: two launches of an empty kernel of delta_q8.cu "
        f"({plan_f.grid} blocks of {plan_f.threads} threads): "
        f"{floor['ms']:.5f} ms warm, {floor['cold_ms']:.5f} ms timed as "
        f"the cold rows are [{smi}]")
    for kinfo, (cell, be), kern, ref in instances:
        fp32 = progs[(cell, "fused")].layouts
        for fire in (0.1, 1.0):
            row = {"ms": 0.0, "cold_ms": 0.0, "eager_ms": 0.0,
                   "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0}
            for li, lay in enumerate(progs[(cell, be)].layouts):
                ins, fired_cols = layer_inputs(rng, 1, lay, fire,
                                               be != "fused")
                gpu = [torch.from_numpy(a).to(dev) for a in ins]
                row["ms"] += device_ms(lambda: run_step(cell, kern, lay, gpu))
                row["cold_ms"] += device_ms_cold(
                    lambda: run_step(cell, kern, lay, gpu))
                row["eager_ms"] += eager_ms(
                    lambda: run_step(cell, kern, lay, gpu))
                row["plain_ms"] += device_ms(
                    lambda: run_step(cell, ref, lay, gpu))
                wf = fp32[li].w
                w2 = wf.reshape(-1, wf.shape[-1])
                d_cat = torch.zeros((1, wf.shape[-1]), device=dev)
                acc = torch.zeros((1, w2.shape[0]), device=dev)
                row["library_ms"] += device_ms(
                    lambda: torch.addmm(acc, d_cat, w2.T))
                row["bytes"] += step_bytes(cell, be, lay, fired_cols)
            row["bound_ms"] = 1e3 * row["bytes"] / HBM_BYTES_PER_S
            log(f"time {kinfo.name} B=1 fire={fire} per 2-layer step: kernel "
                f"{row['ms']:.5f} ms warm, {row['cold_ms']:.5f} ms with a "
                f"cold L2 ({row['eager_ms']:.4f} ms launched from Python), "
                f"plain {row['plain_ms']:.5f} ms, addmm "
                f"{row['library_ms']:.5f} ms, bound {row['bound_ms']:.5f} ms "
                f"({row['bytes']} B), launch floor {floor['ms']:.5f} ms "
                f"[{smi}]")
        rows[kinfo.name] = row               # the 100 % firing row
        # the tile instance (8 streams a pass), as the 8-slot batcher
        # launches it: each stream fires ``fire`` of the blocks on its own
        for fire in (0.1, 1.0):
            tile = {"ms": 0.0, "bytes": 0}
            for lay in progs[(cell, be)].layouts:
                ins, fired_cols = layer_inputs(rng, 8, lay, fire,
                                               be != "fused")
                gpu = [torch.from_numpy(a).to(dev) for a in ins]
                tile["ms"] += device_ms(lambda: run_step(cell, kern, lay, gpu))
                tile["bytes"] += step_bytes(cell, be, lay, fired_cols, 8)
            log(f"time {kinfo.name} B=8 (tile) fire={fire} per 2-layer "
                f"step: kernel {tile['ms']:.5f} ms warm, bound "
                f"{1e3 * tile['bytes'] / HBM_BYTES_PER_S:.5f} ms "
                f"({tile['bytes']} B) [{smi}]")
        row["tile_ms"] = tile["ms"]
    def bound(row):
        t_bytes = 1e3 * row["bytes"] / HBM_BYTES_PER_S
        t_ops = 1e3 * row["ops"] / FP32_OPS_PER_S
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"

    def f32(*shape, lo=None):
        a = (rng.normal(0, 1, shape) if lo is None
             else rng.uniform(lo, 1.0, shape))
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    # delta_spmv: the four calls of one layer step of each LM cell at 0 %,
    # ~10 % and 100 % fired, warm (CUDA-graph replay) and with the L2
    # flushed before each call; fp32 (the main path's) and bf16 weights,
    # deltas and accumulator (its addmm in bf16 as library_ms, 2 bytes a
    # weight in the bound)
    lm_shapes = {"rwkv6": [(2048, 2048)] * 3 + [(2048, 64)],
                 "rglru": [(4096, 4096)] * 4}
    for dtype, (kinfo, _) in spmv_kinfo.items():
        size = dtype.itemsize
        spmv_row = {"ms": 0.0, "cold_ms": 0.0, "eager_ms": 0.0,
                    "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "ops": 0}
        for cell, shapes in lm_shapes.items():
            for fire in (0.0, 0.1, 1.0):
                row = dict.fromkeys(spmv_row, 0.0)
                calls = []
                for i_dim, o_dim in shapes:
                    w, dx, acc, fired_cols = spmv_case(rng, i_dim, o_dim, 1,
                                                       fire)
                    wp = pack_spmv_weights(torch.from_numpy(w)).to(
                        dtype=dtype, device=dev)
                    w, dx, acc = (torch.from_numpy(a).to(dtype=dtype,
                                                         device=dev)
                                  for a in (w, dx, acc))

                    def kern():
                        return delta_spmv(wp, dx, acc, packed=True,
                                          out_dim=o_dim)

                    calls.append(device_ms(kern))
                    row["ms"] += calls[-1]
                    row["cold_ms"] += device_ms_cold(kern)
                    row["eager_ms"] += eager_ms(kern)
                    row["plain_ms"] += device_ms(
                        lambda: delta_spmv_ref(w, dx, acc))
                    row["library_ms"] += device_ms(
                        lambda: torch.addmm(acc, dx, w.T))
                    row["bytes"] += size * (o_dim * fired_cols + i_dim
                                            + 2 * o_dim)
                    row["ops"] += 2 * o_dim * fired_cols
                bound(row)
                log(f"time {kinfo.name} {cell} layer step (4 calls) B=1 "
                    f"fire={fire}: kernel {row['ms']:.5f} ms warm "
                    f"(calls {', '.join(f'{c:.5f}' for c in calls)} ms), "
                    f"{row['cold_ms']:.5f} ms with a cold L2 "
                    f"({row['eager_ms']:.4f} ms launched from Python), plain "
                    f"{row['plain_ms']:.5f} ms, addmm "
                    f"{row['library_ms']:.5f} ms, bound "
                    f"{row['bound_ms']:.5f} ms ({int(row['bytes'])} B, "
                    f"{row['bound_by']}) [{smi}]")
            for key in spmv_row:             # the 100 % firing rows, summed
                spmv_row[key] += row[key]
        bound(spmv_row)
        rows[kinfo.name] = spmv_row

    # the scans and the activation at the main path's shapes, B = 1; no
    # single PyTorch call computes any of the three (library_ms null). The
    # scans also with a cold L2, at B = 8 (the 8-slot batcher's launch), at
    # T = 128 (a prefill, not on the main path), and beside the floor under
    # their launch: an empty kernel of their build at the same grid
    def wkv_args(b, t):
        shape = (b, 32, t, 64)
        return [f32(*shape), f32(*shape), f32(*shape), f32(*shape, lo=0.9),
                f32(32, 64) * 0.1, f32(b, 32, 64, 64)]

    def lru_args(b, t):
        return [f32(b, t, 4096), f32(b, t, 4096, lo=0.5), f32(b, 4096)]

    scans = {
        ops.RWKV6_SCAN_F32.name: (
            rwkv6_scan, rwkv6_scan_batched_ref, wkv_args,
            lambda b, t: 4 * (5 * b * 32 * t * 64 + 32 * 64
                              + 2 * b * 32 * 64 * 64),
            lambda b, t: 7 * b * t * 32 * 64 * 64,
            lambda: rwkv6_scan_plan(1, 32, 1, 64), "rwkv6_scan.cu",
            "rwkv6_scan_empty"),
        ops.RGLRU_SCAN_F32.name: (
            rglru_scan, rglru_scan_batched_ref, lru_args,
            lambda b, t: 4 * (3 * b * t * 4096 + 2 * b * 4096),
            lambda b, t: 6 * b * t * 4096,
            lambda: rglru_scan_plan(1, 1, 4096), "rglru_scan.cu",
            "rglru_scan_empty"),
    }
    for name, (kern, ref, make, nbytes, nops, plan_of, src,
               empty_name) in scans.items():
        args = make(1, 1)
        row = {"ms": device_ms(lambda: kern(*args)),
               "cold_ms": device_ms_cold(lambda: kern(*args)),
               "eager_ms": eager_ms(lambda: kern(*args)),
               "plain_ms": device_ms(lambda: ref(*args)),
               "library_ms": None, "bytes": nbytes(1, 1),
               "ops": nops(1, 1)}
        bound(row)
        plan = plan_of()
        empty_fn = getattr(_build.load(src), empty_name)
        empty_fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        empty_fn.restype = ctypes.c_int

        def empty_scan():
            if empty_fn(plan.grid, plan.threads,
                        torch.cuda.current_stream().cuda_stream):
                raise RuntimeError(f"{empty_name} launch failed")

        row["launch_floor_ms"] = device_ms(empty_scan)
        row["launch_floor_cold_ms"] = device_ms_cold(empty_scan)
        log(f"time {name} B=1 T=1: kernel {row['ms']:.5f} ms warm, "
            f"{row['cold_ms']:.5f} ms with a cold L2 "
            f"({row['eager_ms']:.4f} ms launched from Python), plain "
            f"{row['plain_ms']:.5f} ms, bound {row['bound_ms']:.6f} ms "
            f"({row['bytes']} B, {row['bound_by']}); launch floor (an empty "
            f"kernel of {plan.grid} blocks of {plan.threads} threads) "
            f"{row['launch_floor_ms']:.5f} ms warm, "
            f"{row['launch_floor_cold_ms']:.5f} ms timed cold [{smi}]")
        for key, (b, t) in (("tile", (8, 1)), ("t128", (1, 128))):
            args = make(b, t)
            t_bytes = 1e3 * nbytes(b, t) / HBM_BYTES_PER_S
            t_ops = 1e3 * nops(b, t) / FP32_OPS_PER_S
            row[f"{key}_ms"] = device_ms(lambda: kern(*args))
            row[f"{key}_cold_ms"] = device_ms_cold(lambda: kern(*args))
            row[f"{key}_bound_ms"] = max(t_bytes, t_ops)
            log(f"time {name} B={b} T={t}: kernel {row[f'{key}_ms']:.5f} ms "
                f"warm, {row[f'{key}_cold_ms']:.5f} ms with a cold L2, bound "
                f"{row[f'{key}_bound_ms']:.6f} ms ({nbytes(b, t)} B) [{smi}]")
        rows[name] = row
    # deltagru_act at the 2L-768H width: B = 1, also cold, at B = 8, and
    # beside the floor under its launch (an empty kernel of its build at
    # its grid, launched as it is); then ops.deltagru_cell_fused (two
    # unpacked delta_spmv calls, every column fired, then deltagru_act) at
    # the network's two layer shapes, I = 40 and I = 768
    def act_args(b):
        return [f32(b, 4 * h_dim), f32(b, 3 * h_dim), f32(b, 3 * h_dim),
                f32(b, h_dim)]

    act = act_args(1)
    row = {"ms": device_ms(lambda: deltagru_act(*act)),
           "cold_ms": device_ms_cold(lambda: deltagru_act(*act)),
           "eager_ms": eager_ms(lambda: deltagru_act(*act)),
           "plain_ms": device_ms(lambda: deltagru_act_ref(*act)),
           "library_ms": None, "bytes": 4 * 16 * h_dim, "ops": 30 * h_dim}
    bound(row)
    act8 = act_args(8)
    row["tile_ms"] = device_ms(lambda: deltagru_act(*act8))
    row["tile_bound_ms"] = 8 * row["bound_ms"]
    plan = deltagru_act_plan(1, h_dim)
    act_empty = _build.load("deltagru_cell.cu").deltagru_act_empty
    act_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    act_empty.restype = ctypes.c_int

    def empty_act():
        if act_empty(plan.grid, plan.threads,
                     torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("deltagru_act_empty launch failed")

    row["launch_floor_ms"] = device_ms(empty_act)
    row["launch_floor_cold_ms"] = device_ms_cold(empty_act)
    rows[ops.DELTAGRU_ACT_F32.name] = row
    log(f"time {ops.DELTAGRU_ACT_F32.name} B=1: kernel {row['ms']:.5f} ms "
        f"warm, {row['cold_ms']:.5f} ms with a cold L2 "
        f"({row['eager_ms']:.4f} ms launched from Python), plain "
        f"{row['plain_ms']:.5f} ms, bound {row['bound_ms']:.6f} ms "
        f"({row['bytes']} B, {row['bound_by']}); B=8: {row['tile_ms']:.5f} "
        f"ms, bound {row['tile_bound_ms']:.6f} ms; launch floor (an empty "
        f"kernel of {plan.grid} blocks of {plan.threads} threads) "
        f"{row['launch_floor_ms']:.5f} ms warm, "
        f"{row['launch_floor_cold_ms']:.5f} ms timed cold [{smi}]")
    for p in models["gru"]["gru"]:
        m, hp = f32(1, 4 * h_dim), f32(1, h_dim)
        dx, dh = f32(1, p.input_size), f32(1, h_dim)
        ms = device_ms(lambda: ops.deltagru_cell_fused(p.w_x, p.w_h, m, hp,
                                                       dx, dh))
        log(f"time ops.deltagru_cell_fused I={p.input_size} H={h_dim} B=1, "
            f"every column fired: {ms:.5f} ms warm (two delta_spmv and "
            f"deltagru_act) [{smi}]")

    # the engine step's Delta Unit and epilogue at the main paths' shapes
    eng_progs = {"gru fused": progs[("gru", "fused")],
                 "gru fused_q8": progs[("gru", "fused_q8")],
                 "rwkv6 fused": lm["rwkv6"][0]}
    eng_rows = engine_kernel_rows(dev, eng_progs, rng, floor["ms"], smi)
    phase6 = ops.launch_counts()
    for name in ([k.name for k in buffered.values()]
                 + [ops.DELTA_SPMV_BF16.name, ops.DELTAGRU_ACT_F32.name]):
        launches[name] = phase3[name] + phase6[name]

    # the engine per path, through its captured graph and, as before it
    # was one, op by op (eager_steps): kernels a step, device busy, idle
    # share, wall and CUDA-event time a step (torch.profiler over 50 steps
    # of the GRU/LSTM, 10 of the LM paths, which issue thousands of
    # kernels a step), the latency of one step, and the capture's time
    engine_paths = [(f"{cell} {be}", prog, task, frames, 50)
                    for (cell, be), prog in progs.items()]
    engine_paths += [(f"{cell} fused", lm_prog, lm_task, frames_lm, 10)
                     for cell, (lm_prog, lm_task, frames_lm) in lm.items()]
    step_kernels, step_counted = {}, {}
    for path, prog, eng_task, fr, n_prof in engine_paths:
        eng = DeltaStreamEngine(prog, eng_task)
        warm_chunks(eng, fr)
        before = ops.launch_counts()
        prof = engine_profile(lambda: eng.step_many(fr[:n_prof]), n_prof)
        # the wrappers' launches a step in the profiled run, and the
        # profile's kernels a step (its copies apart)
        step_counted[path] = counted_per_step(before, ops.launch_counts(),
                                              n_prof)
        counted_kernels(prof, step_counted[path], f"engine {path} graph")
        step_kernels[path] = prof["kernels_per_step"] - prof[
            "copies_per_step"]
        lat = step_latencies_us(DeltaStreamEngine(prog, eng_task).step, fr)
        ref = DeltaStreamEngine(prog, eng_task)
        before = ops.launch_counts()
        prof_e = engine_profile(lambda: eager_steps(ref, fr[:n_prof]),
                                n_prof)
        counted_kernels(prof_e, counted_per_step(
            before, ops.launch_counts(), n_prof), f"engine {path} eager")
        lat_e = step_latencies_us(lambda x: eager_steps(ref, x[None]), fr)
        caps = {k: round(1e3 * v, 3) for k, v in sorted(eng.capture_s.items())}
        log(f"engine {path} graph: capture ms by steps a graph {caps}; "
            f"frame-to-output latency at 1 stream over {len(lat)} "
            f"frames: median {np.median(lat):.1f} us, p95 "
            f"{np.percentile(lat, 95):.1f} us; step_many {wall_us[path]:.1f} "
            f"us/step; 8-slot batcher {batch_fps[path]:.1f} frames/s; "
            f"profiled: {json.dumps(prof)} [{smi}]")
        log(f"engine {path} eager (op by op): latency median "
            f"{np.median(lat_e):.1f} us, p95 {np.percentile(lat_e, 95):.1f} "
            f"us; step_many {eager_us[path]:.1f} us/step; profiled: "
            f"{json.dumps(prof_e)} [{smi}]")

    # the train step of each stage, eager against compiled: wall ms a step
    # (median of the timed steps, each ended by reading its metrics: the
    # compiled run's steps 3-10, the eager twin's 2-10), frames a second,
    # kernels a step, device busy and idle share (torch.profiler over one
    # step, as engine_profile; also the share against the unprofiled wall),
    # the fused Adam kernel's device time in it, the eager step cut into
    # forward, backward and Adam (each part synchronised), the capture's
    # time and the graph's private pool, each timed loop's peak memory
    # above what the process held when it began; and the export's time
    for name in ("dense", "qat"):
        tr = train[name]
        st, bt = tr["state"], batches[TRAIN_STEPS - 1]
        frames = bt["features"].shape[0] * bt["features"].shape[1]
        tr["step"](st, bt)   # captures again if (c) left its key switched
        prof = {"compiled": engine_profile(lambda: tr["step"](st, bt), 1,
                                           match=OPT_KERNELS),
                "eager": engine_profile(lambda: tr["step"].eager(st, bt), 1,
                                        match=OPT_KERNELS)}
        split = train_split_ms(st.params, tr["task"], bt, tr["qat"],
                               tr["use_delta"], st.opt, opt_cfg)
        walls = {"compiled": tr["step_ms"][1:],
                 "eager": tr["eager_step_ms"][1:]}
        peaks = {"compiled": tr["peak_bytes"], "eager": tr["eager_peak_bytes"]}
        tr["times"] = {}
        for how in ("eager", "compiled"):
            pr = prof[how]
            wall_ms = float(np.median(walls[how]))
            busy_ms = pr["device_busy_us_per_step"] / 1e3
            tr["times"][how] = {"wall_ms": wall_ms, "profile": pr,
                                "peak_bytes": peaks[how]}
            log(f"time train {name} {how} (2L-768H CTC, "
                f"B={bt['features'].shape[1]}, T={bt['features'].shape[0]})"
                f": {wall_ms:.3f} ms a step wall (median of "
                + ", ".join(f"{v:.3f}" for v in walls[how])
                + f"), {1e3 * frames / wall_ms:.1f} frames/s; profiled "
                f"step: {pr['kernels_per_step']:.0f} kernels, device busy "
                f"{busy_ms:.3f} ms, idle share {pr['idle_share']:.4f} (wall "
                f"{pr['wall_us_per_step'] / 1e3:.3f} ms under the profiler), "
                f"{1 - busy_ms / wall_ms:.4f} against the unprofiled wall; "
                f"fused Adam kernel {pr['match_us_by']['fused_adam']:.1f} "
                f"us, global norm kernel "
                f"{pr['match_us_by']['global_norm']:.1f} us; peak "
                f"memory {peaks[how] / 2 ** 30:.3f} GiB ({peaks[how]} B) "
                f"above what the loop began with [{smi}]")
        pool = tr["pool_bytes"]
        log(f"time train {name} eager step split (each part synchronised): "
            f"forward {split['forward_ms']:.3f} ms, backward "
            f"{split['backward_ms']:.3f} ms, Adam (norm, schedule, fused "
            f"kernel) {split['adam_ms']:.3f} ms; compiled: capture "
            f"{1e3 * tr['capture_s']:.3f} ms (a warm-up step, then the "
            f"capture), graph pool "
            + (f"{pool / 2 ** 20:.1f} MiB ({pool} B)" if pool is not None
               else "not measured (no pool ids in the snapshot)")
            + f" [{smi}]")
    # the fused Adam's two instances at their main paths' trees: fp32 at
    # the 2L-768H GRU (5d: Adam 1e-3, clip 1.0, no decay), bf16 at
    # llama3.2-1b's full size (5h: the launcher's AdamW, timed there)
    adam_rows = {
        ops.FUSED_ADAM_F32.name: adam_row(
            ops.FUSED_ADAM_F32, train["dense"]["state"].params, TRAIN_STEPS,
            1.0, 0.0, "the 2L-768H GRU tree", False, smi),
        ops.FUSED_ADAM_BF16.name: lm_train["adam_row"]}
    for name, row in adam_rows.items():
        max_err[name] = max(max_err[name], row["max_err"])
        max_err[ops.GLOBAL_NORM.name] = max(max_err[ops.GLOBAL_NORM.name],
                                            row["norm"]["max_err"])
    log(f"time train export: quantize_delta_model of the trained 2L-768H "
        f"stack {train['serve']['export_ms']:.3f} ms [{smi}]")

    # the fabric at 2L-768H (phase 5e (b)): the first run's wall, streams
    # and frames a second and steady tick walls (loadgen_fabric's rule),
    # replays a tick, the second run's profiled ticks, the scale-down
    fb = fabric["b"]
    pr = fb["profile"]
    log(f"time fabric (b) 2L-768H fused_q8, 8 shards x 128: wall "
        f"{fb['wall_s']:.4f} s, {fb['streams_per_s']:.2f} streams/s, "
        f"{fb['frames_per_s']:.2f} frames/s; steady tick p50 "
        f"{fb['p50_tick_ms']:.4f} ms, p99 {fb['p99_tick_ms']:.4f} ms "
        f"(median {fb['median_tick_ms']:.4f}, max {fb['max_tick_ms']:.4f}); "
        f"{fb['replays_per_tick']:.4f} replays a tick; ticks "
        f"{FABRIC_PROFILE_TICKS[0]}-{FABRIC_PROFILE_TICKS[1]} of the second "
        f"run profiled: {pr['kernels_per_tick']:.1f} kernels a tick, device "
        f"busy {pr['device_busy_us_per_tick']:.1f} us a tick, idle share "
        f"{pr['idle_share']:.4f} (wall {pr['wall_us_per_tick']:.1f} us, "
        f"events {pr['event_us_per_tick']:.1f} us a tick under the "
        f"profiler); scale-down (drain checkpoint and remove) "
        f"{fb['scale_ms']:.3f} ms; second run (profiled) wall "
        f"{fb['wall2_s']:.4f} s, tick p50 {fb['p50_tick2_ms']:.4f} ms, p99 "
        f"{fb['p99_tick2_ms']:.4f} ms [{smi}]")
    sp = fabric["shard_profile"]
    log(f"time fabric (b) one shard's replay at B=128 (20 steps): "
        f"{sp['kernels_per_step']:.1f} kernels a step, device busy "
        f"{sp['device_busy_us_per_step']:.1f} us a step, of which the int8 "
        f"tile kernel {sp['match_us_per_step']:.1f} us (2 launches); events "
        f"{sp['event_us_per_step']:.1f} us, wall "
        f"{sp['wall_us_per_step']:.1f} us a step [{smi}]")
    host = fb["host_ms"]
    inside = sum(v for k, v in host.items() if k != "submit")
    log(f"time fabric (b) where the first run's {fb['ticks_ms']:.3f} ms of "
        f"ticks went (host ms): fleet.step (stage and 8 or 7 replays, no "
        f"sync) {host['step']:.3f}, open_stream {host['open_stream']:.3f} "
        f"({fb['opens']} opens, {fb['open_us']:.2f} us each), "
        f"host_carry (waits for the replays) {host['host_carry']:.3f}, "
        f"close_stream {host['close_stream']:.3f}, the router's own (shed, "
        f"admit, staging, output rows, one output copy a harvest) "
        f"{fb['ticks_ms'] - inside:.3f}; submits between ticks "
        f"{host['submit']:.3f} of the {1e3 * fb['wall_s']:.3f} ms wall "
        f"[{smi}]")

    entries = []
    for kinfo, (cell, be), _, _ in instances:
        row = rows[kinfo.name]
        entry = {"name": kinfo.name, "route": "cuda", "source": kinfo.source,
                 "replaces": kinfo.replaces,
                 "launches": launches[kinfo.name],
                 "max_abs_err": max_err[kinfo.name], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": "bytes", "library_ms": row["library_ms"],
                 "eager_ms": row["eager_ms"], "cold_ms": row["cold_ms"]}
        entry["launch_floor_ms"] = floor["ms"]
        entry["tile_ms"] = row["tile_ms"]
        if kinfo in buffered.values():
            entry["path"] = buffered_path[cell]
        entries.append(entry)
    # row 9b at the LM path's decode shape [4, 32, 1, 64], and its prefill
    # [4, 32, 128, 64] (phase 5f, on the inputs the path gave it)
    zrows = zoo["rows"]
    rows[ops.RWKV6_SCAN_BF16.name] = dict(
        zrows[ops.RWKV6_SCAN_BF16.name]["t1"],
        t128_ms=zrows[ops.RWKV6_SCAN_BF16.name]["t128"]["ms"],
        t128_bound_ms=zrows[ops.RWKV6_SCAN_BF16.name]["t128"]["bound_ms"])
    for kinfo in (ops.DELTA_SPMV_F32, ops.DELTA_SPMV_BF16, ops.RGLRU_SCAN_F32,
                  ops.RWKV6_SCAN_F32, ops.RWKV6_SCAN_BF16,
                  ops.DELTAGRU_ACT_F32):
        row = rows[kinfo.name]
        entry = {"name": kinfo.name, "route": "cuda", "source": kinfo.source,
                 "replaces": kinfo.replaces,
                 "launches": launches[kinfo.name],
                 "max_abs_err": max_err[kinfo.name], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"],
                 "eager_ms": row["eager_ms"]}
        if kinfo in spmv_kinfo_all:
            entry["cold_ms"] = row["cold_ms"]
        if kinfo.name in scans:
            for key in ("cold_ms", "launch_floor_ms", "tile_ms", "t128_ms",
                        "t128_bound_ms"):
                entry[key] = row[key]
            # at the LM path's prefill shape (phase 5f)
            lm_row = zrows[kinfo.name]["t128"]
            entry["lm_prefill_ms"] = lm_row["ms"]
            entry["lm_prefill_bound_ms"] = lm_row["bound_ms"]
        if kinfo is ops.RWKV6_SCAN_BF16:
            for key in ("cold_ms", "t128_ms", "t128_bound_ms"):
                entry[key] = row[key]
            entry["shape"] = "[4, 32, 1, 64] (t128: [4, 32, 128, 64])"
        if kinfo is ops.DELTAGRU_ACT_F32:
            for key in ("cold_ms", "launch_floor_ms", "tile_ms"):
                entry[key] = row[key]
        if kinfo is ops.DELTA_SPMV_BF16:
            entry["path"] = ("repro_torch.kernels.delta_spmv.delta_spmv on "
                             "bf16 weights")
        if kinfo is ops.DELTAGRU_ACT_F32:
            entry["path"] = "repro_torch.kernels.ops.deltagru_cell_fused"
        entries.append(entry)
    # the engine step's two kernels: the 2L-768H fused_q8 step's launches
    # (the paper's deployment), the other paths' beside them.
    # launches_per_step: the wrappers' counted launches over the steps of
    # phase 6's profiled step_many (B = 1) and of the fabric shard's
    # profiled replays (n128, the 2L-768H fused_q8 shard), a Delta Unit a
    # layer and one epilogue
    for kinfo in (ops.DELTA_UNIT_F32, ops.ENGINE_EPILOGUE_F32):
        main_row = eng_rows[kinfo.name]["gru fused_q8"]
        entry = {"name": kinfo.name, "route": "cuda", "source": kinfo.source,
                 "replaces": kinfo.replaces,
                 "launches": launches[kinfo.name],
                 "max_abs_err": max_err[kinfo.name]}
        for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "eager_ms", "cold_ms", "launch_floor_ms"):
            entry[key] = main_row[key]
        per_layer = kinfo is ops.DELTA_UNIT_F32
        by_path = {}
        for path, prog in eng_progs.items():
            by_path[path] = step_counted[path].get(kinfo.name, 0)
            if by_path[path] != (prog.num_layers if per_layer else 1):
                raise AssertionError(f"{path}: {by_path[path]} launches a "
                                     f"step of {kinfo.name}")
        shard = fabric["shard_counted"].get(kinfo.name, 0)
        if shard != by_path["gru fused_q8"]:
            raise AssertionError(f"fabric shard: {shard} launches a step "
                                 f"of {kinfo.name}")
        entry["launches_per_step"] = by_path["gru fused_q8"]
        entry["shape"] = ("one 2L-768H fused_q8 step at B = 1 (others: "
                          "by_path; n128: N = 128, a fabric shard's tile)")
        keys = ("ms", "cold_ms", "plain_ms", "bound_ms", "bytes")
        entry["n128"] = {**{k: main_row["n128"][k] for k in keys},
                         "launches_per_step": shard}
        entry["by_path"] = {
            path: {**{k: r[k] for k in keys},
                   "launches_per_step": by_path[path],
                   "n128": {k: r["n128"][k] for k in keys},
                   "step_kernels_per_step": step_kernels[path]}
            for path, r in eng_rows[kinfo.name].items()}
        # the engine step's kernels, read from the profiled run (its
        # copies apart): the frame guard runs inside the first Delta Unit
        # launch on this path
        entry["step_kernels_per_step"] = step_kernels["gru fused_q8"]
        q8_prog = progs[("gru", "fused_q8")]
        entry["frame_guard"] = {
            key: ("folded into layer 0's Delta Unit launch"
                  if q8_prog.spec.frame_guard
                  and guard_fits(n, q8_prog.input_size)
                  else "plain ops") for key, n in (("B1", 1), ("n128", 128))}
        entries.append(entry)
    # the train steps' fused AdamW and global norm: launches of the main
    # paths' runs (5d's stages, 5h (a)'s launcher), and those launches over
    # the steps the runs took (eager steps, and each compiled step's
    # warm-ups and replays)
    adam_launches, adam_steps = {}, {}
    for ph in (train, lm_train):
        add_counts(adam_launches, ph["adam_launches"])
        add_counts(adam_steps, ph["adam_steps"])
    for kinfo in (ops.FUSED_ADAM_F32, ops.FUSED_ADAM_BF16):
        row = adam_rows[kinfo.name]
        entry = {"name": kinfo.name, "route": "cuda", "source": kinfo.source,
                 "replaces": kinfo.replaces,
                 "launches": launches.get(kinfo.name, 0),
                 "max_abs_err": max_err[kinfo.name]}
        for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "bytes", "elements", "shape"):
            entry[key] = row[key]
        entry["launches_per_step"] = (adam_launches.get(kinfo.name, 0)
                                      / adam_steps[kinfo.name])
        entries.append(entry)
    # the clip's global norm: its row at llama3.2-1b's bf16 gradients (5h),
    # the 2L-768H GRU's fp32 ones beside it
    kinfo = ops.GLOBAL_NORM
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library", "bytes", "elements", "shape", "rel_err")
    norm_main = adam_rows[ops.FUSED_ADAM_BF16.name]["norm"]
    norm_gru = adam_rows[ops.FUSED_ADAM_F32.name]["norm"]
    entry = {"name": kinfo.name, "route": "cuda", "source": kinfo.source,
             "replaces": kinfo.replaces,
             "launches": launches.get(kinfo.name, 0),
             "max_abs_err": max_err[kinfo.name],
             **{key: norm_main[key] for key in keys},
             "gru_tree": {key: norm_gru[key] for key in keys},
             "launches_per_step": (adam_launches.get(kinfo.name, 0)
                                   / adam_steps[kinfo.name])}
    entries.append(entry)
    if len(entries) != len(ops.KERNELS) or not all(
            e["launches"] > 0 for e in entries):
        got = [(e["name"], e["launches"]) for e in entries]
        raise AssertionError(f"kernel line incomplete: {got}")
    phase("end")
    log(f"chip_smoke took {time.perf_counter() - t_script:.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
