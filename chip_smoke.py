#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, the CUDA toolkit's ``nvcc`` and this checkout's
sources; it imports nothing of JAX and nothing of the JAX package.
Phases (any failure raises and the script exits non-zero):

1. environment: the card's name and power limit, torch/CUDA versions, and
   the build of every kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together), with ptxas' register report;
   no flash-attention, decode, chunked-prefill, MoE, WKV or RG-LRU
   instantiation may spill (ptxas' spill bytes all 0), and the flash, MoE,
   WKV and RG-LRU wrappers' plans must state what the CUDA sources launch
   with (the WKV chunk of 64 steps and the RG-LRU chunk of 16 among it);
2. kernels: each CUDA kernel against its plain PyTorch version on the card
   at its path's shapes, timed with CUDA events (device time, inputs
   rotated past the L2 cache) beside its roofline bound, the plain version
   and one PyTorch library call computing the same function.  Serving's
   kernels in bf16 at rtol/atol 2e-2, the page gather bit for bit;
   training's ring gather bit for bit on the full-width packed row (and
   once under ``torch.cuda.set_sync_debug_mode("error")``: no host sync);
   the flash-attention backward against torch autograd of the plain
   attention, f32 at rtol/atol 1e-4, bf16 at a normalized max error of
   2e-2; the split decode kernel reading its ring in place from 16-slot
   page pools under a shuffled table (an idle row on the junk page), bit
   for bit its gathered form over ``ref.page_gather``'s view, also at
   recurrentgemma-2b's local heads (10 over 1 kv head of 256, a 2048-slot
   ring) in bf16 and f32 (1e-4), each row of a batch of 8 bit-identical
   to the row alone and two calls bit-identical, timed beside the
   gathered pair it replaces (two ``page_gather`` calls and the gathered
   form); the page gather also at mixtral-8x7b's head dim 128 (no serving
   path launches it: it is the oracle of the gathered forms);
   chunked-prefill attention reading its ring in place from
   page pools under a shuffled table (against the plain version over
   ``ref.page_gather``; its gathered form against the plain version and
   bit-identical to the paged one) over rings with dead slots, wrapped
   rings and windows, bf16 at 2e-2 and f32 at 1e-4, recurrentgemma-2b's
   local heads with its 2048 window included, timed beside the two
   ``page_gather`` calls it replaces; the three attention kernels also at
   mixtral-8x7b's head dim 128 (the backward at its training shape, batch
   4 x 512 with its 4096 window); the grouped MoE FFN at
   mixtral-8x7b's width (a decode batch, a 128-token chunk, prompts of 300
   and 512 tokens, the training shape: 2 groups of 1024, C 320) in bf16
   at a normalized 2e-2, its edge cases (an expert
   with no token, a token no expert takes: exactly 0, two tokens in one
   slot) and one f32 case at 1e-4; its backward against torch autograd of
   the plain version at the training shape (dx, dcombine, dwg, dwu, dwd
   each at a normalized 2e-2, two calls bit for bit), the same edge cases
   (an idle expert's weight gradients and a dropped token's dx exactly 0)
   and one f32 case at 1e-4; the RWKV-6 WKV forward at rwkv6-1.6b's
   training shape (batch 4 x 512, 32 heads of 64) in bf16 at 2e-2, with
   the decay from N(0, 1) and near 0 (N(2, 1)), at a ragged T = 77 in f32
   at 1e-4 (head dims 16 and 64) and at T = 513 (nine 64-step chunks),
   its checkpointed states against the plain stateful version at 1e-4,
   and its backward against torch autograd of the plain version (f32 at
   1e-4, du against its f64 closed form, bf16 at a normalized 2e-2), both
   decays, and in f32 at T = 513; no PyTorch call computes the
   recurrence, so these two rows have no library time (they carry the
   chunk, the blocks a pass launches and the launch plan); flash attention forward and backward
   at recurrentgemma-2b's heads (10 over 1 kv head of 256) at batch 4 x
   512 and at 4096 tokens with its 2048 window (``hd256`` entries, SDPA
   with a boolean mask as the library time); the RG-LRU forward at
   recurrentgemma-2b's training shape (batch 4 x 512, 2560 channels) in
   bf16 at 2e-2, the decay from the model's map and near 1, at ragged
   T 77 and 513, D 200 and on strided inputs in f32 at 1e-4, its
   checkpoints (the state at each 16-step chunk's last step) against the
   plain version's states at 1e-4, and its backward against torch
   autograd of the plain version where a < 1 (f32 at 1e-4, also at
   T 513; bf16 at a normalized 2e-2), its value at a = 1 (dx = 0, da = dh
   h_{t-1}) pinned and two runs bit for bit; no library time either (these
   rows carry the chunk and the threads a pass); serving's forms of both
   recurrences from a carried state (the RG-LRU from h0, the WKV from S0
   with its final state out) at B1 T 1, 37, 128, 512 and B8 T1, in bf16 at
   2e-2 and f32 at 1e-4 against ``ref.rglru(x, a, h0)`` and
   ``ref.rwkv6_stateful`` (output and final state), a null and a zero
   state bit for bit the stateless call (output and every checkpoint),
   timed beside their bounds and plain versions (the ``stateful`` lists
   of the two rows); the three attention kernels also at
   recurrentgemma-2b's serving shapes (flash prefills of 128, 300 and 512
   tokens, decode and chunked prefill on the 544-slot ring); the three at
   gemma3-4b's heads (8 q over 4 kv heads of 256: a 1100-token prefill in
   its local (window 1024) and global layers, decode on its 1024- and
   2048-slot rings, the last chunk of that prompt over both rings) and
   the backward at its training shape (batch 2 x 2048, window 1024 and
   global); the flash forward at Sq != Sk, non-causal (the vision
   model's xattn: a 300-token prefill and a B8 decode step against 1600
   media tokens at 32 q over 8 kv heads of 128, ragged key tails of 1601
   and 8, and phase 13's own B2 prefill of 256 and B2 decode step) in
   bf16 at 2e-2 and f32 at 1e-4 (and its log-sum-exp), timed in both
   beside the plain version and SDPA (the ``xattn`` list of the flash
   row); the backward at Sq != Sk, non-causal (phase 14's B2 Sq2048
   against Sk1600 at 32 q over 8 kv heads of 128, then the CUDA tests'
   cross cases: a B8 decode row, a 300-token prompt, ragged tails of Sq
   77, 130 and 65 and Sk 1601, 8 and 100) against torch autograd of the
   plain attention, bf16 at a normalized 2e-2 and f32 at 1e-4, timed in
   both beside its bound, autograd of the plain version and SDPA's
   backward (the ``xattn_bwd`` list of the backward row); the three at olmo-1b's (16 over 16 of 128) and musicgen-large's
   (32 over 32 of 64) heads, a group of one (prefills of 128 and 300, B4
   decode on the 544 ring, the 300-token prompt's last chunk; olmo's
   decode and chunk in f32 too: the ``group1`` lists); then
   flash attention's batch invariance in bf16 at llama3.2-1b's and
   recurrentgemma-2b's training shapes: each batch row alone gives the
   bits of the forward, lse and the three gradients it gives inside the
   batch of 4;
2b. AdamW's one-pass kernel (``kernels/adamw.py``, no TPU kernel behind
   it) against its plain version at olmo-1b's leaf shapes and a ragged
   1,000,003 (also through unaligned views), f32 and bf16 leaves, with and
   without the clip, three steps: p, m and v bit for bit (``ADAMW_ULPS``
   0: round-to-nearest intrinsics, no FMA contraction); a non-contiguous
   CUDA leaf refused, no host sync; each olmo shape timed beside its bound
   (28 bytes an f32 parameter), the plain version and
   ``torch._fused_adamw_`` (timed only).  The training phases below gate
   every parameter of every step through it;
3. end to end, small: the serving engine on a narrow f32 model on the card
   (CUDA kernels) against the same model on the CPU (plain versions): same
   greedy tokens, prefill logits within 1e-3; on shared-prefix requests,
   chunked, prefix-cached, prefix-cached under eviction pressure and
   sampled runs: greedy tokens CUDA == CPU, chunked == prefix-cached ==
   static whole-prompt on the card, sampled tokens the same under both
   schedules and not the greedy ones;
4. serving at full width: ``llama3.2-1b`` in bf16 with random weights from
   seed 0, batch 8, page 16, 16 open-loop requests (prompts 128/300/512,
   generations 16/32, cache 544).  Continuous and static modes on the
   ``steps`` clock must give identical greedy tokens, and the continuous
   run (the serving path: launch counts reset just before, read just
   after) must launch each of its kernels and no ``page_gather`` (decode
   reads the pages in place).  Then one continuous
   ``wall``-clock run, and ``torch.profiler`` over a continuous run of 8
   requests arriving together: device time by kernel group and the
   device's idle share.  Then the chunked path on the same weights: 16
   shared-prefix requests (4 hot 256-token prefixes, suffixes 64/192,
   generations 16/32), chunk 128, run chunked, prefix-cached and
   prefix-cached with nucleus sampling (launch counts reset before the
   three, read after): each run launches ``prefill_page_attention`` 16
   times per chunk (its own and the warmup's) and the paged decode
   kernel, ``page_gather`` never (the chunks and decode read the pools in
   place), no plain version runs, every output
   is whole, the cache hits more than 30 % of prompt tokens and saves
   chunks, sampling changes the tokens; the first-token logits of the chunk plan agree with the whole
   prompt's within a normalized 2e-2; then a ``wall``-clock prefix-cached
   run and its profile;
4b. MoE serving: a narrow f32 mixtral (4 experts, top-2, window 16) on the
   card against the CPU at capacity factor 1.25 (whole prompt, chunked,
   prefix-cached: same greedy tokens, prefill logits within 1e-3), and
   continuous == static on the card at 4.0, where nothing is dropped; then
   ``mixtral-8x7b`` at full width, depth 8 of 32, bf16, random weights from
   seed 0 built leaf by leaf, batch 8, page 16, cache 544, the traffic of
   phase 4: continuous and static runs on the steps clock (the MoE serving
   path: exact launch counts of the grouped FFN and the attention kernels,
   0 of ``page_gather``, no plain version; continuous-vs-static agreement
   reported, not gated, since capacity drops depend on the batch), the
   first-token logits of the kernels against the plain versions on the
   card, a ``wall``-clock run, a chunked (128) prefix-cached run on
   shared-prefix traffic, and a profile;
4c. recurrent serving: recurrentgemma-2b's smoke config in f32 on the card
   against the CPU (greedy tokens equal whole-prompt, chunked,
   prefix-cached with hit rate 0, static and sampled); then
   ``recurrentgemma-2b`` at full width, depth cut to 14 of 26 layers
   (``RG_SERVE_GROUPS``: the script's time limit; bf16, random weights
   from seed 0), batch 8, page 16, cache 544, phase 4's
   whole-prompt draw: continuous, static and chunked (128) runs on the
   steps clock, each with exact launch counts of flash, decode and
   chunked-prefill attention and the RG-LRU forward (reset just before,
   read just after) and no plain version; continuous == static; the chunk
   plan's first-token logits (chunks, then the tail through decode)
   within a normalized 2e-2 of the whole prompt's; a wall-clock run and a
   profile.  Then ``rwkv6-1.6b`` at full width and full depth through the
   model-level serving functions (its engine refuses an attention-free
   model): in bf16, 4 prompts prefilled and joined, 16 decode steps at
   batch 4, a 512-token prompt in 4 chunks of 128 with the carry (the WKV
   forward's launches exact, no plain version); the chunks against the
   whole prefill at f32 compute on the same weights (first-token logits
   within a normalized 2e-2, final states within 1e-3 relative; the bf16
   differences, which random weights carry from layer to layer as far as
   the kernels' own difference from the plain versions, reported);
5. training, small: a narrow f32 model trained 4 steps through the train
   engine at delta 2 on the packed ring, on the card (CUDA kernels)
   against the CPU (plain versions): losses and parameters within 1e-4.
   Then, under ``torch.use_deterministic_algorithms(True)`` on the card,
   delta=0 of the delayed step is bit-identical to the synchronous step
   and the packed ring bit-identical to the tree ring at delta 2;
6. training at full width: ``llama3.2-1b``, f32 master and bf16 compute,
   batch 4 x 512 tokens, AdamW, delta 2 on the packed ring, 8 steps from
   seed 0 (the training path: launch counts reset just before, read just
   after; every kernel of the path launches, as often as the model says,
   and no plain version runs).  Finite losses, the staleness ramp 0, 1,
   2, 2, ... in the telemetry, non-zero q/k/v projection gradients; step
   time, tokens/s, peak memory, and ``torch.profiler`` over 2 more steps;
7. RWKV-6 training: phase 5 on the rwkv6-1.6b smoke config (f32, 2 layers,
   d 64, 4 heads of 16), then phase 6 on ``rwkv6-1.6b`` at full width and
   full depth (24 layers, d 2048, 32 heads of 64, d_ff 7168, vocab 65536,
   untied head): the WKV forward and backward kernels launch once per
   layer and step, the ring gather once per group and step, and no plain
   version runs; ``wr``, ``wk``, ``wv``, ``decay_w1`` and ``bonus_u`` of
   layer 0 get non-zero gradients;
8. recurrentgemma training: phase 5 on the recurrentgemma-2b smoke config
   (f32, one (rglru, rglru, local) group, d 64, window 16 at 96 tokens),
   then phase 6 on ``recurrentgemma-2b`` at full width (d 2560, 10 heads
   over 1 kv head of 256, window 2048, d_ff 7680, vocab 256000, tied and
   scaled embeddings), depth cut to 11 of 26 layers (``reduced``): each
   rglru layer launches the RG-LRU forward and backward once a step, each
   local layer the flash forward and backward, the ring gather once per
   group and step, no plain version runs, and layer 0's ``wx``, ``wa``,
   ``wi``, ``lam``, ``conv_w`` (slot 0) and ``wq``, ``wk``, ``wv`` (slot 2)
   get non-zero gradients;
8b. MoE training: phase 5 on the mixtral-8x7b smoke config (f32, 2
   layers, d 64, 4 experts top-2, window 16), then phase 6 on
   ``mixtral-8x7b`` at full width (d 4096, 32 heads over 8 of 128, window
   4096, 8 experts of d_ff 14336, vocab 32000), depth cut to 1 of 32
   layers (``reduced``): flash forward and backward and the grouped FFN's
   forward and backward kernels once per layer and step, the ring gather
   once per group and step, no plain version; each step's loss (with the
   router's losses) finite and ``lm_loss``'s total, its ``lb_loss`` and
   ``router_entropy`` finite, and layer 0's ``wq``, ``wk``, ``wv``, ``router``,
   ``wg``, ``wu`` and ``wd`` get non-zero gradients;
9. the paper's Sec-6 regression (``repro_torch.core.threaded``) in f64 on
   the card, under deterministic algorithms: the synthetic set (960
   features x 5,000 examples, 100 iterations, 4 threads) in GD, SGD and
   mini-batch, where dc, dc-array and bsp at delta 0 and
   ``run_interleaved`` (seeds 0-2) give theta bit for bit
   ``run_sequential``'s with complete, sequentially-correct histories,
   SSP (slack 2) keeps its clock bound, and the card's sequential theta
   is within 1e-10 of the CPU's; then the real dataset's shape (150,360
   x 16,087, the sparse proxy scattered into a 19.35 GB dense matrix on
   the card) at 4 and 8 threads: SGD (400 iterations) and GD (20
   iterations) dc and bsp, bit for bit sequential; dc at delta 2 (GD, 8
   threads) within 1.5x of the sequential loss and within a tenth of
   GD's descent from theta = 0 of it, with some reads stale and none
   more than 2 behind (SGD at delta 2 reported: the config's step
   diverges at this shape's row norms, in sequence too); ``X @ theta`` timed
   against its bound, and the runs' peak within 1.1x of X's bytes (no
   copy of a column slice).  DC against BSP is reported, not gated;
10. serve while training: phase 4's continuous run of ``llama3.2-1b``
   reading its weights from a ``LiveParamDB`` (delays: ``groups`` 4,
   ``embed`` 1) into which phase 6's train engine (delta 2, packed ring,
   AdamW, batch 4 x 512) publishes one step every 3 decode steps (the
   path: launch counts reset just before, read just after).  Every
   served read within its group's delay, some stale, both delays seen,
   the Op history sequentially correct, staleness at most 4, launches
   exactly phase 4's plus the training steps', no plain version; a
   handle that never gets a publish serves phase 4's tokens;
11. the sharded parameter server (``repro_torch.pdb.server``): shard
   processes storing on the CPU, worker threads computing on the card.
   The card's free memory falls by less than 64 MiB across the first
   ``cluster.start()`` (no shard opens a CUDA context).  Phase 9's
   regression through the shards in f64 under deterministic algorithms
   (run right after phase 9, on its real-shape matrix): the synthetic set
   at 4 workers on 2 shards, GD, where dc, dc-array and bsp at delta 0 on
   both RPC paths and the kill-and-restart drill (shard 1 at iteration 4,
   from its snapshot, with retries) give theta bit for bit
   ``run_sequential``'s with complete, sequentially-correct merged
   histories, and SSP (slack 2) keeps its bound; the real shape at 8
   workers on 4 shards, GD at 20 iterations, dc and bsp bit for bit, dc
   at delta 2 to phase 9's gates, the walls of sequential, DC and BSP
   printed.  Then ``--backend server`` training: phase 5's narrow f32
   model on the card bit for bit its one-thread sequential replay
   (deterministic, both RPC paths; delta 1 within its bound), and
   ``llama3.2-1b`` at full width (f32 master, bf16 compute) with 2
   workers, 8 shards and 64 chunks (MAX_FRAME's 1 GiB forces the layout:
   a shard's read_batch carries 617.9 MB), batch 4 x 512, lr 1e-3, dc at
   delta 0, 3 steps (the server training path: launch counts reset just
   before, read just after; flash forward and backward exactly 96 each,
   nothing else, no plain version): finite losses, a complete and
   sequentially correct history at staleness 0, no frame near MAX_FRAME,
   worker 0's first loss within 1e-6 of phase 6's step 0; per step the
   wall and its parts (settle, read, copies, gradient, write) on the host
   clock, peak device memory, the host's peak RSS and the shards' RSS.
   Then phase 12; last, the clusters' forkserver and resource tracker are
   stopped and no shard and no child of this script may be left running;
12. the dense ring decode, remat and the chunked cross entropy, on
   ``llama3.2-1b`` at full width (bf16 compute, random weights from seed
   0) with the card otherwise free.  (a) B8 prompts of 128 tokens
   prefilled into the dense 544-slot ring, then 32 greedy
   ``decode_step``s at a scalar pos (the dense path: launch counts reset
   just before, read just after): ``decode_attention`` exactly 16 x 32
   launches, all in its gathered form (the JAX package's own), flash
   forward 16, nothing else, no plain version; every step's logits bit
   for bit those of the paged decode over pools filled from the same
   ring (pages of 16, an identity table), the greedy tokens equal; the
   decode-step host and wall p50 of both.  (b) One ``make_lm_grad_fn``
   call each at batch 4 x 512 (f32 master): remat ``none`` twice,
   ``full``, ``dots``, and ``none`` with ``REPRO_CHUNKED_CE=1``, the peak
   reset before each: the loss bit for bit across the remat policies,
   the chunked loss within 1e-4 relative; the gradients bit for bit the
   first call's when the two ``none`` calls agree bit for bit, else
   within a normalized 2e-2 (the line says which; chunked CE's always
   within 2e-2); flash forward 16 a call under ``none``, 32 under
   ``full`` and ``dots`` (the recomputation), backward 16; peaks ordered
   ``full`` < ``dots`` < ``none`` and chunked < unchunked; each call's
   peak and wall printed.  (c) ``examples/torch_quickstart.py``'s
   ``main`` on the card: 20 finite losses and 9 decoded ids;
13. the rest of the zoo, each model at full width and full depth in
   bf16 (random weights from seed 0, built leaf by leaf) and freed
   before the next.  ``olmo-1b``, ``gemma3-4b`` and ``musicgen-large``
   through ``ServeEngine`` (batch 4, page 16, 8 requests of 16 tokens;
   olmo and musicgen prompts 128 / 300 in a 544-slot cache, gemma3
   prompts 128 / 1100 in a 2048-slot cache, so its 1024-slot local rings
   wrap in prefill, chunks and decode): first-token logits against the
   plain route on the card within a normalized 2e-2; continuous, static
   and chunked (128) runs on the steps clock, each path's launch counts
   reset just before and read just after, exact for flash, decode and
   chunked-prefill attention (nothing else, no plain version);
   continuous == static; the decode step's host p50.  On one prompt
   (300 tokens; gemma3's 1100) in end-aligned chunks on a B1 paged
   cache then a decode step: at f32 compute the last chunk's and the
   decode step's logits, each from one cache state, within a normalized
   1e-4 of the plain route's and the chunk's of the whole prompt's; in
   bf16 every flash, chunked-prefill and decode call of that run held
   elementwise against the plain route on its own inputs at 2e-2.
   ``llama-3.2-vision-11b`` (40 layers, 8 xattn, 9.8 B parameters) with
   its xattn gates drawn in [0.5, 1.5) (they start at 0, which hides
   the layer): ``prefill`` of 2 prompts of 256 tokens with media (2 x
   1600 x 1280), then 12 ``decode_step``s with media on the dense ring
   (flash exactly 32 + 8 a prefill and 8 a step, decode attention 32 a
   step, nothing else, no plain version); the same at f32 compute on the
   same weights, every logit row within a normalized 1e-4 of the plain
   route's; in bf16 the kernel route no farther from the f32 plain route
   than 1.25x the plain bf16 route is (both ~0.02 there: the 40 layers'
   rounding), and every flash and decode call of a bf16 run (the xattn
   calls at B2 Sq256 and Sq1 against 1600 keys among them) held
   elementwise against the plain route on its own inputs at 2e-2;
   zeroing the gates moves the logits; the decode step's wall p50 and
   the peak memory.  Then
   ``gemma3-4b`` training at full width, depth 6 of 34 (one 5 local + 1
   global group, ``reduced``), f32 master and bf16 compute, through the
   train engine (AdamW, delta 2, packed ring) at batch 2 x 2048 with
   ``REPRO_CHUNKED_CE=1``, 3 steps: flash forward and backward exactly 6
   a step, the ring gather once a group and step, no plain version;
   finite losses, the first within 1e-4 relative of ``lm_loss`` on the
   plain route; step p50 and peak memory;
14. vision training: the vision smoke config's shapes at f32,
   xattn gates drawn in [0.5, 1.5), trained 3 steps through the train
   engine (SGD, delta 2, packed ring, batch 2 x 96 with media 2 x 8 x
   24) on the card (flash forward and backward exactly 5 a step, the
   xattn backward at Sq 96 against Sk 8) and on the CPU (plain
   versions): losses and the xattn layer's and ``frontend_proj``'s
   parameters within 1e-4; then ``llama-3.2-vision-11b`` at full width,
   depth 5 of 40 (one ``("attn",) * 4 + ("xattn",)`` group, ``reduced``),
   gates drawn non-zero (at 0 the xattn layer's dO would be exactly 0),
   f32 master and bf16 compute, through the train engine (SGD: AdamW's
   out-of-place update does not fit, ``VISION_TRAIN_REDUCED``; delta 2,
   packed ring) at batch 2 x 2048 with media 2 x 1600 x 1280 from
   ``make_lm_batch`` and ``REPRO_CHUNKED_CE=1``, 3 steps: flash forward
   and backward exactly 5 a step (4 self-attention, 1 xattn at Sq 2048
   against Sk 1600), the ring gather once a group and step, no plain
   version; finite losses, the first within 1e-4 relative of
   ``lm_loss`` on the plain route; then one more step, not counted, in
   which every backward kernel call is held against torch autograd of
   ``ref.attention`` on its own (q, k, v, dO) (f32 1e-4, bf16 a
   normalized 2e-2); step p50, peak memory and the parameter count.
15. the multi-device layer on one card: (a) ``llama3.2-1b`` at full
   width and depth (f32 master, bf16 compute, batch 4 x 512, remat none,
   AdamW) through ``steps.make_train_step`` on DTensor parameters placed
   by ``sharding.tree_shardings`` on a one-rank NCCL group and a (1, 1)
   ``data, model`` mesh, 2 steps in ``datacentric`` and 2 in ``bsp``,
   each against the unsharded step run first from the same seed: losses,
   parameters, m and v bit for bit (every collective is the identity on
   one rank), flash forward and backward exactly 16 a step (launch counts
   reset before each sharded run), no plain version; step seconds and the
   peak above each run's start beside the unsharded step's; (b) started
   before (a) as subprocesses on the host, ``python -m
   repro_torch.launch.dryrun`` for ``llama3.2-1b`` ``train_4k`` on 16 x 16
   (``datacentric``, ``bsp``) and 2 x 16 x 16 (``datacentric``): each exits
   0, the parameter bytes a device holds are the sharding rules'
   arithmetic, ``datacentric`` reduce-scatters and all-gathers, ``bsp``
   all-reduces, every number is finite; and the dry run of (a)'s own cell
   on a (1, 1) mesh, its predicted peak printed beside (a)'s measured one.
16. the multi-device layer of the MoE, recurrent and vision configs on
   one card: (a) ``mixtral-8x7b``, ``rwkv6-1.6b``, ``recurrentgemma-2b``
   and ``llama-3.2-vision-11b`` at full width, each at its training
   phase's depth, batch and optimizer (vision with its media and the
   chunked cross entropy), 2 ``datacentric`` steps (remat none) through
   ``steps.make_train_step`` on DTensor parameters on a one-rank NCCL
   group and a (1, 1) mesh, each against the unsharded step run first
   (its results kept on the host): losses, parameters and optimizer state
   bit for bit, the MoE FFN, WKV, RG-LRU and flash kernels' launches
   exact, no plain version; step seconds and peaks beside the unsharded
   step's; (b) the decode kernel's split-ring partial form
   (``decode_attention_partial``) on rings cut into 2 and 4 parts at
   decode's shapes, in bf16 and f32: each part's (acc, l, m) against
   ``ops._decode_partial`` (acc and l at 2e-2 / 1e-4, m at 1e-4) and
   ``ops.combine_parts`` of the parts against the whole-ring kernel,
   timed beside it (the ``split_ring`` and ``partial_ms`` fields of the
   ``decode_attention`` row; 0 launches on every one-card path); (c) the
   dry run of ``mixtral-8x7b`` and ``rwkv6-1.6b`` ``train_4k``
   (``datacentric``) and ``llama-3.2-vision-11b``'s (``bsp``) on 16 x 16,
   gated as (b) of phase 15.

The last two lines are the ``kernels`` JSON object (twelve rows; each
row's ``launches_by_path`` counts its launches on every path, the
recurrent serving, serve-while-train, server training, dense decode,
remat and the zoo's paths included)
and
``{"ok": true, "device": {...}}``.  float32 matmuls and convolutions run in
full f32 (TF32 off) throughout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SPIN_HZ = 2.0e9                 # at or above any H100 SM clock
SPIN_TRIES = 3                  # timed loops before an uncovered enqueue fails
L2_BYTES = 50 * 2 ** 20
BF16_TOL = 2e-2                 # rtol = atol, as tests/test_kernels.py
BWD_F32_TOL = 1e-4              # f32 backward vs autograd, rtol = atol
F32_TOL = 1e-4                  # f32 decode and chunked prefill, rtol = atol
BWD_BF16_NORM_TOL = 2e-2        # bf16 backward: max |err| / max |ref|
TRAIN_TOL = 1e-4                # small training run, CUDA vs CPU


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3,
            spin: bool = True) -> tuple[float, float]:
    """(device ms, host ms) of one call ``fn(i)``.  Device time comes from
    CUDA events around ``iters`` back-to-back calls; a spin kernel queued
    first keeps the card busy while the host enqueues them, so the host's
    per-call cost (Python, argument checks, ctypes) leaves no gaps between
    the launches.  Host time is that enqueue time per call.  ``i`` counts
    the calls, so ``fn`` can rotate through input copies (``rotation``).
    The spin is sized from calls made after the warmup: a first call's
    one-off set-up (a library loading its kernels) would stretch it to
    minutes.  ``spin=False`` times without the spin, for a call of more
    launches than the card's launch queue holds (the WKV plain versions,
    thousands of small kernels a call): the host cannot queue them ahead,
    so the device time includes the host's gaps and is the time a caller
    waits.

    The host shares its cores with other work, and a garbage
    collection can fall inside the timed loop, so one enqueue may stall
    past the spin.  The collector is off while the loop is timed, and a
    loop whose enqueue outlasted its spin is timed again behind a spin
    sized from that enqueue (twice it): up to ``SPIN_TRIES`` loops, and
    only a time whose enqueue the spin covered is returned."""
    import gc

    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t0) / warmup
    spin_s = 4 * per_call * iters + 5e-3 if spin else 0.0
    for attempt in range(SPIN_TRIES if spin else 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        gc.disable()
        try:
            if spin:
                torch.cuda._sleep(int(spin_s * SPIN_HZ))
            t0 = time.perf_counter()
            start.record()
            for i in range(iters):
                fn(i)
            end.record()
            host = time.perf_counter() - t0
        finally:
            gc.enable()
        torch.cuda.synchronize()
        if not spin or host <= spin_s:
            break
        print(f"time_ms: enqueue {host:.4f} s outlasted the spin "
              f"{spin_s:.4f} s (try {attempt + 1} of {SPIN_TRIES})",
              flush=True)
        if attempt + 1 < SPIN_TRIES:
            spin_s = 2 * host + 5e-3
    else:
        raise RuntimeError(f"enqueue {host:.4f} s outlasted the spin "
                           f"{spin_s:.4f} s in each of {SPIN_TRIES} tries: "
                           "device time would include gaps")
    return start.elapsed_time(end) / iters, host * 1e3 / iters


def rotation(tensors: tuple, cap: int = 64) -> list[tuple]:
    """Copies of ``tensors`` whose total exceeds twice the L2 cache, so a
    timed call cycling through them reads its inputs from device memory,
    as the serving path does (a layer's K/V pages and weights were last
    touched a whole decode step earlier)."""
    n = min(cap, max(2, -(-2 * L2_BYTES // nbytes(*tensors))))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# recurrentgemma-2b's local attention (10 q heads over 1 kv head of 256):
# the training shape, and one sequence past its 2048 window (B, S, window)
FLASH_HD256 = ((4, 512, 0), (1, 4096, 2048))
# the forward's shapes (B, S, H, KV, hd, window), all causal: llama3.2-1b's
# prompts, smollm-360m's heads (group 3), mixtral-8x7b's head dim 128,
# then recurrentgemma-2b's (training, past the window, and its serving
# prefills of 128, 300 and 512 tokens), then gemma3-4b's serving prefill of
# the zoo phase's long prompt (8 q heads over 4 kv heads of 256) in its
# local (window 1024) and global layers, then the zoo phase's prompts of
# 128 and 300 tokens at olmo-1b's heads (16 over 16 of 128) and
# musicgen-large's (32 over 32 of 64): a group of one
GEMMA3_LONG = 1100
GROUP1_HEADS = ((16, 128), (32, 64))         # (H = KV, hd)
FLASH_CASES = [(1, S, 32, 8, 64, 0) for S in (128, 300, 512, 1024)] \
    + [(1, 300, 15, 5, 64, 0), (1, 512, 32, 8, 128, 0)] \
    + [(B, S, 10, 1, 256, w) for B, S, w in FLASH_HD256] \
    + [(1, S, 10, 1, 256, 2048) for S in (128, 300, 512)] \
    + [(1, GEMMA3_LONG, 8, 4, 256, w) for w in (1024, 0)] \
    + [(1, S, H, H, hd, 0) for H, hd in GROUP1_HEADS for S in (128, 300)]
# the vision model's cross-attention (B, Sq, Sk, H, KV, hd), non-causal:
# llama-3.2-vision-11b's heads (32 over 8 of 128) against its 1600 media
# tokens at a 300-token prefill and a B8 decode step, then ragged key
# tails (1601: one key past a tile; 8: the smoke config's media), then the
# zoo phase's own shapes (its B2 prefill of 256 tokens and its B2 decode
# step)
XATTN_CASES = ((1, 300, 1600, 32, 8, 128), (8, 1, 1600, 32, 8, 128),
               (1, 300, 1601, 32, 8, 128), (2, 77, 8, 32, 8, 128),
               (2, 256, 1600, 32, 8, 128), (2, 1, 1600, 32, 8, 128))
# the backward's (B, S, H, KV, hd, causal, window): llama3.2-1b's training
# shape first (the main row), other lengths, smollm-360m's heads, a window,
# mixtral-8x7b's training shape (head dim 128, its 4096 window longer than
# the sequence), then recurrentgemma-2b's, then gemma3-4b's training heads
# at the zoo phase's batch 2 x 2048 (local window 1024, and global)
FLASH_BWD_CASES = [(4, 512, 32, 8, 64, True, 0), (4, 128, 32, 8, 64, True, 0),
                   (4, 1024, 32, 8, 64, True, 0), (4, 300, 15, 5, 64, True, 0),
                   (4, 512, 32, 8, 64, True, 128),
                   (4, 512, 32, 8, 128, True, 4096)] \
    + [(B, S, 10, 1, 256, True, w) for B, S, w in FLASH_HD256] \
    + [(2, 2048, 8, 4, 256, True, w) for w in (1024, 0)]
# the backward at Sq != Sk, non-causal (B, Sq, Sk, H, KV, hd): the vision
# training phase's xattn shape (2 x 2048 text rows against 2 x 1600 media
# tokens, 32 q over 8 kv heads of 128) first, then the CUDA tests' CROSS
# cases: a B8 decode row, a 300-token prompt, ragged tails on both sides
# (Sk 1601, 8 and 100; Sq 77, 130 and 65 past a 64-row tile)
XATTN_BWD_CASES = ((2, 2048, 1600, 32, 8, 128), (8, 1, 1600, 32, 8, 128),
                   (1, 300, 1600, 32, 8, 128), (2, 1, 1601, 8, 2, 128),
                   (2, 77, 8, 4, 2, 16), (1, 130, 100, 10, 1, 256),
                   (2, 65, 1601, 4, 4, 64))


def window_mask(torch, S: int, window: int):
    """The boolean (S, S) mask of a causal window, SDPA's ``attn_mask``."""
    qp = torch.arange(S, device="cuda")[:, None]
    kp = torch.arange(S, device="cuda")[None, :]
    return (kp <= qp) & (kp > qp - window)


def check_flash(torch, F, ref, gen):
    from repro_torch.kernels.flash_attention import flash_attention
    worst, rows = 0.0, []
    for B, S, H, KV, hd, window in FLASH_CASES:
        mk = lambda n: torch.randn((B, S, n, hd), generator=gen,
                                   device="cuda").to(torch.bfloat16)
        q, k, v = mk(H), mk(KV), mk(KV)
        got = flash_attention(q, k, v, causal=True, window=window)
        want = ref.attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=BF16_TOL, atol=BF16_TOL)
        worst = max(worst, err)
        flops = 4.0 * hd * H * B * _live_pairs(S, True, window)
        b_ms, b_by = bound(nbytes(q, k, v, got), flops, "bfloat16")
        sets = rotation((q, k, v))
        n = len(sets)
        lib_sets = [tuple(t.transpose(1, 2) for t in st) for st in sets]
        mask = window_mask(torch, S, window) if window > 0 else None
        ms, host_ms = time_ms(lambda i: flash_attention(
            *sets[i % n], causal=True, window=window), 20)
        row = dict(shape=[B, S, H, KV, hd], window=window, max_abs_err=err,
                   tolerance=BF16_TOL, ms=ms,
                   host_ms=host_ms,
                   plain_ms=time_ms(lambda i: ref.attention(
                       *sets[i % n], causal=True, window=window), 10)[0],
                   library_ms=time_ms(lambda i: F.scaled_dot_product_attention(
                       *lib_sets[i % n], is_causal=mask is None,
                       attn_mask=mask, enable_gqa=True), 20)[0],
                   bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        print("flash_attention", json.dumps(row), flush=True)
    main = next(r for r in rows if r["shape"] == [1, 512, 32, 8, 64])
    hd128 = next(r for r in rows if r["shape"][4] == 128)
    hd256 = [r for r in rows if r["shape"][4] == 256 and r["shape"][2] == 10]
    gemma3 = [r for r in rows if r["shape"][2:] == [8, 4, 256]]
    group1 = [r for r in rows if r["shape"][2] == r["shape"][3]]
    xattn = check_flash_cross(torch, F, ref, gen)
    worst = max([worst] + [r["max_abs_err"] for r in xattn
                           if r["dtype"] == "bfloat16"])
    return {**main, "max_abs_err": worst, "hd128": hd128, "hd256": hd256,
            "gemma3": gemma3, "group1": group1, "xattn": xattn}


def check_flash_cross(torch, F, ref, gen):
    """The forward at Sq != Sk, non-causal (the vision model's xattn),
    against ``ref.attention`` on the same inputs: bf16 at rtol/atol 2e-2,
    f32 at 1e-4, its log-sum-exp at 1e-4; timed in both dtypes beside
    its bound (every (query, key) pair live: 4 hd H B Sq Sk operations),
    the plain version and SDPA (no mask)."""
    from repro_torch.kernels.flash_attention import flash_attention
    rows = []
    for B, Sq, Sk, H, KV, hd in XATTN_CASES:
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            mk = lambda s, n: torch.randn((B, s, n, hd), generator=gen,  # noqa
                                          device="cuda").to(dtype)
            q, k, v = mk(Sq, H), mk(Sk, KV), mk(Sk, KV)
            got, lse = flash_attention(q, k, v, causal=False, with_lse=True)
            want = ref.attention(q, k, v, causal=False)
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                  k.float().repeat_interleave(H // KV, 2))
            want_lse = torch.logsumexp(scores * hd ** -0.5, -1)
            torch.cuda.synchronize()
            tol = BF16_TOL if dt == "bfloat16" else F32_TOL
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            torch.testing.assert_close(lse, want_lse, rtol=F32_TOL,
                                       atol=F32_TOL)
            b_ms, b_by = bound(nbytes(q, k, v, got),
                               4.0 * hd * H * B * Sq * Sk, dt)
            sets = rotation((q, k, v))
            n = len(sets)
            lib_sets = [tuple(t.transpose(1, 2) for t in st) for st in sets]
            reps = 20 if dt == "bfloat16" else 5
            ms, host_ms = time_ms(lambda i: flash_attention(
                *sets[i % n], causal=False), reps)
            row = dict(
                shape=[B, Sq, Sk, H, KV, hd], dtype=dt, causal=False,
                max_abs_err=err, tolerance=tol, ms=ms, host_ms=host_ms,
                plain_ms=time_ms(lambda i: ref.attention(
                    *sets[i % n], causal=False), reps)[0],
                library_ms=time_ms(lambda i: F.scaled_dot_product_attention(
                    *lib_sets[i % n], enable_gqa=True), reps)[0],
                bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            print("flash_attention xattn", json.dumps(row), flush=True)
            del sets, lib_sets
    return rows


# decode shapes (B, L, H, KV, hd, dtype): the serving run's ring (cache_len
# 544 = 34 pages of 16) and a 1024-slot ring at llama3.2-1b's heads,
# mixtral-8x7b's head dim 128 on the serving ring, then recurrentgemma-2b's
# local layers (10 q heads over 1 kv head of 256, its 2048-slot window
# ring) in bf16 and f32 and its serving ring (544 slots), then gemma3-4b's
# (8 q heads over 4 kv heads of 256) local ring (its 1024 window) and
# global ring (the zoo phase's cache_len 2048), then olmo-1b's and
# musicgen-large's heads (a group of one: one live row of the kernel's
# 16-row tile) on the zoo phase's B4 serving ring, olmo's in f32 too; the
# first is the one the main path gives the kernel
MAIN_L, RING_LENS = 544, (544, 1024)
DECODE_CASES = tuple((8, L, 32, 8, 64, "bfloat16") for L in RING_LENS) \
    + ((8, MAIN_L, 32, 8, 128, "bfloat16"),
       (8, 2048, 10, 1, 256, "bfloat16"), (8, 2048, 10, 1, 256, "float32"),
       (8, MAIN_L, 10, 1, 256, "bfloat16"),
       (8, 1024, 8, 4, 256, "bfloat16"), (8, 2048, 8, 4, 256, "bfloat16"),
       (4, MAIN_L, 16, 16, 128, "bfloat16"),
       (4, MAIN_L, 16, 16, 128, "float32"),
       (4, MAIN_L, 32, 32, 64, "bfloat16"))


def decode_pools(torch, gen, k, v):
    """The rings k, v (B, L, KV, hd) moved into pools of ``PAGE``-slot
    pages (B * n_pp + 1 of them, the last the junk page) under a shuffled
    table: (k_pool, v_pool, table).  Row 0 is idle as the engine makes it:
    its whole table on the junk page."""
    B, L, KV, hd = k.shape
    n_pp = L // PAGE
    P = B * n_pp + 1
    table = torch.randperm(P - 1, generator=gen, device="cuda")[:B * n_pp]
    table = table.reshape(B, n_pp).to(torch.int32)
    pools = []
    for ring in (k, v):
        pool = torch.randn((P, PAGE, KV, hd), generator=gen,
                           device="cuda").to(ring.dtype)
        pool[table.long()] = ring.reshape(B, n_pp, PAGE, KV, hd)
        pools.append(pool)
    table[0] = P - 1
    return pools[0], pools[1], table


def check_decode(torch, F, ref, gen):
    """The split decode kernel reading the ring in place from 16-slot page
    pools under a shuffled table (row 0 idle on the junk page), on ring
    masks as the engine makes them: bit for bit its gathered form over
    ``ref.page_gather``'s view, and the plain version within tolerance
    (bf16 2e-2, f32 1e-4); every row of the batch of 8 bit-identical to
    the same row run alone, in both forms, and two calls bit-identical.
    Timed (the paged form, the main path's) beside its bound, the gathered
    form alone, the gathered pair (two ``page_gather`` calls and the
    gathered form: what a layer's decode launched before the fold), the
    plain version (gathers included) and SDPA with a boolean mask over the
    gathered keys."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_paged, plan)
    from repro_torch.kernels.page_gather import page_gather
    # the pools draw from their own generator, so the phases after this
    # one see the numbers they saw before the pools were added
    pool_gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for B, L, H, KV, hd, dt in DECODE_CASES:
        dtype = getattr(torch, dt)
        mk = lambda s, n: torch.randn((B, s, n, hd), generator=gen,  # noqa
                                      device="cuda").to(dtype)
        q, k, v = mk(1, H), mk(L, KV), mk(L, KV)
        # ring masks as the engine makes them: row b holds positions < n_b
        n_live = torch.randint(1, L + 1, (B,), generator=gen, device="cuda")
        n_live[0] = 1                          # the idle row: slot 0 live
        n_live[1] = L
        valid = torch.arange(L, device="cuda")[None, :] < n_live[:, None]
        pk, pv, table = decode_pools(torch, pool_gen, k, v)
        k, v = ref.page_gather(pk, table), ref.page_gather(pv, table)
        got = decode_attention_paged(q, pk, pv, table, valid)
        view = decode_attention(q, k, v, valid)
        want = ref.attention_decode(q, k, v, valid)
        torch.cuda.synchronize()
        case = (B, L, H, KV, hd, dt)
        if not torch.equal(got, view):
            raise AssertionError(f"decode paged != gathered form at {case}")
        tol = BF16_TOL if dt == "bfloat16" else F32_TOL
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        if not torch.equal(got, decode_attention_paged(q, pk, pv, table,
                                                       valid)):
            raise AssertionError(f"decode_attention not deterministic at "
                                 f"{case}")
        for b in range(B):
            one = decode_attention_paged(q[b:b + 1], pk, pv, table[b:b + 1],
                                         valid[b:b + 1])
            one_view = decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                        valid[b:b + 1])
            if not (torch.equal(one, got[b:b + 1])
                    and torch.equal(one_view, got[b:b + 1])):
                raise AssertionError(f"decode_attention row {b} at B1 "
                                     f"differs from B{B} at {case}")
        live = int(valid.sum().item())
        need = nbytes(q, got, table) + B * L \
            + live * KV * hd * 2 * k.element_size()
        b_ms, b_by = bound(need, 4.0 * hd * H * live, dt)
        # the gathered form (the dense ring decode's) reads no table
        gb_ms, gb_by = bound(need - nbytes(table), 4.0 * hd * H * live, dt)
        del k, v
        sets = rotation((q, pk, pv, table, valid))
        n = len(sets)
        gsets = [(q_, ref.page_gather(pk_, t_), ref.page_gather(pv_, t_), m_)
                 for q_, pk_, pv_, t_, m_ in sets]
        lib_sets = [(q_.transpose(1, 2), k_.transpose(1, 2),
                     v_.transpose(1, 2), m_[:, None, None, :])
                    for q_, k_, v_, m_ in gsets]
        ms, host_ms = time_ms(lambda i: decode_attention_paged(
            *sets[i % n]), 200)
        g_ms, g_host = time_ms(lambda i: decode_attention(*gsets[i % n]),
                               200)
        pair = lambda st: decode_attention(  # noqa: E731
            st[0], page_gather(st[1], st[3]), page_gather(st[2], st[3]),
            st[4])
        pair_ms, pair_host = time_ms(lambda i: pair(sets[i % n]), 200)
        plain = lambda st: ref.attention_decode(  # noqa: E731
            st[0], ref.page_gather(st[1], st[3]),
            ref.page_gather(st[2], st[3]), st[4])
        reps = 200 if dt == "bfloat16" else 10   # f32 SDPA: ~2.5 ms a call
        rows[case] = dict(
            shape=[B, L, H, KV, hd], dtype=dt, page=PAGE,
            splits=plan(L, hd, dtype)["splits"], max_abs_err=err,
            tolerance=tol, paged_equals_gathered=True,
            batch_invariant=True, deterministic=True, ms=ms, paged_ms=ms,
            host_ms=host_ms, gathered_ms=g_ms, gathered_host_ms=g_host,
            gathered_pair_ms=pair_ms, gathered_pair_host_ms=pair_host,
            plain_ms=time_ms(lambda i: plain(sets[i % n]), reps // 4)[0],
            gathered_plain_ms=time_ms(lambda i: ref.attention_decode(
                *gsets[i % n]), reps // 4)[0],
            gathered_bound_ms=gb_ms, gathered_bound_by=gb_by,
            library_ms=time_ms(lambda i: F.scaled_dot_product_attention(
                *lib_sets[i % n][:3], attn_mask=lib_sets[i % n][3],
                enable_gqa=True), reps)[0],
            bound_ms=b_ms, bound_by=b_by)
        print("decode_attention", json.dumps(rows[case]), flush=True)
        del sets, gsets, lib_sets
    worst = max(r["max_abs_err"] for r in rows.values())
    return {**rows[8, MAIN_L, 32, 8, 64, "bfloat16"], "max_abs_err": worst,
            "hd128": rows[8, MAIN_L, 32, 8, 128, "bfloat16"],
            "hd256": [r for (_, _, H, _, hd, _), r in rows.items()
                      if hd == 256 and H == 10],
            "gemma3": [r for (_, _, H, _, hd, _), r in rows.items()
                       if hd == 256 and H == 8],
            "group1": [r for (_, _, H, KV, _, _), r in rows.items()
                       if H == KV]}


# page_gather's shapes (L, hd) at 8 kv heads, B8, page 16: the serving
# ring and a 1024-slot ring at llama3.2-1b's head dim, the serving ring at
# mixtral-8x7b's
GATHER_CASES = tuple((L, 64) for L in RING_LENS) + ((MAIN_L, 128),)


def check_page_gather(torch, ref, gen):
    """The gather bit for bit against ``ref.page_gather`` (it is the
    oracle of the gathered forms the in-place kernels are held to), timed
    beside its bound, the plain version and ``pool[idx]``.  No serving
    path launches it since decode reads the pages in place."""
    from repro_torch.kernels.page_gather import page_gather
    # the hd-128 case draws from its own generator, so the phases after
    # this one see the numbers they saw before it was added
    gens = {64: gen, 128: torch.Generator(device="cuda").manual_seed(2)}
    rows = {}
    for L, hd in GATHER_CASES:
        B, page, KV = 8, PAGE, 8
        n_pp = L // page
        P = B * n_pp + 1
        pool = torch.randn((P, page, KV, hd), generator=gens[hd],
                           device="cuda").to(torch.bfloat16)
        table = torch.randperm(P - 1, generator=gens[hd], device="cuda")
        table = table[:B * n_pp].reshape(B, n_pp).to(torch.int32)
        table[0, -1] = P - 1                   # an idle row's junk page
        got = page_gather(pool, table)
        want = ref.page_gather(pool, table)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("page_gather is not bit-exact")
        b_ms, b_by = bound(2 * nbytes(got) + nbytes(table), 0.0, "bfloat16")
        sets = rotation((pool, table))
        n = len(sets)
        idx = [t.long() for _, t in sets]
        ms, host_ms = time_ms(lambda i: page_gather(*sets[i % n]), 200)
        rows[L, hd] = dict(
            shape=[P, page, KV, hd, B, n_pp], max_abs_err=0.0,
            tolerance=0.0, ms=ms, host_ms=host_ms,
            plain_ms=time_ms(lambda i: ref.page_gather(*sets[i % n]),
                             200)[0],
            library_ms=time_ms(lambda i: sets[i % n][0][idx[i % n]],
                               200)[0],
            bound_ms=b_ms, bound_by=b_by)
        print("page_gather", json.dumps(rows[L, hd]), flush=True)
    return {**rows[MAIN_L, 64], "hd128": rows[MAIN_L, 128]}


# the full-width packed ring row of llama3.2-1b: 1,235,814,400 f32 parameters,
# a multiple of the engine's 128-element padding
RING_N = 1_235_814_400


def check_ring_gather(torch, ref, gen):
    """Bit for bit at the full-width f32 row (size 3, every index, so the
    64-bit offsets past 2^31 elements are exercised) and in bf16 at a
    smaller, odd length; timed at the full row; once more with the host
    sync detector set to raise."""
    from repro_torch.kernels.ring_gather import ring_gather
    idxs = [torch.tensor(i, dtype=torch.int32, device="cuda")
            for i in range(3)]
    small = torch.randn((3, 50_000_001), generator=gen,
                        device="cuda").to(torch.bfloat16)
    for idx in idxs:
        if not torch.equal(ring_gather(small, idx),
                           ref.ring_gather(small, idx)):
            raise AssertionError("ring_gather (bf16) is not bit-exact")
    del small
    hist = torch.empty((3, RING_N), dtype=torch.float32, device="cuda")
    for i in range(3):          # distinct rows, so a wrong row shows
        hist[i].normal_(generator=gen)
    for idx in idxs:
        got = ring_gather(hist, idx)
        want = ref.ring_gather(hist, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"ring_gather (f32, idx {int(idx)}) is "
                                 "not bit-exact")
        del got, want
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ring_gather(hist, idxs[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not torch.equal(out, hist[2]):
        raise AssertionError("ring_gather under the sync detector")
    del out
    b_ms, b_by = bound(2 * RING_N * 4, 0.0, "float32")
    ms, host_ms = time_ms(lambda i: ring_gather(hist, idxs[i % 3]), 12)
    row = dict(shape=[3, RING_N], dtype="float32", max_abs_err=0.0,
               tolerance=0.0, ms=ms, host_ms=host_ms,
               plain_ms=time_ms(lambda i: ref.ring_gather(hist, idxs[i % 3]),
                                12)[0],
               library_ms=time_ms(lambda i: torch.index_select(
                   hist, 0, idxs[i % 3].view(1)), 12)[0],
               bound_ms=b_ms, bound_by=b_by, host_sync_free=True)
    print("ring_gather", json.dumps(row), flush=True)
    del hist
    torch.cuda.empty_cache()
    return row


# AdamW's leaves: olmo-1b's (the tied embedding, then the attention and MLP
# weights stacked over its 16 layers: the counts of each shape) and a
# ragged size, at the benchmark cells' optimizer over three steps
ADAMW_LEAVES = (("embedding", (50304, 2048), 1), ("wq", (16, 2048, 2048), 4),
                ("wg", (16, 2048, 8192), 3), ("ragged", (1_000_003,), 0))
ADAMW_HYPER = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
ADAMW_STEPS = 3
ADAMW_SCALE = 0.3721            # a clip scale that bf16 rounds
ADAMW_ULPS = 0                  # kernel vs plain: round-to-nearest intrinsics


def _ulps(torch, a, b) -> int:
    """Largest distance in units of the last place between two tensors of
    one float type (their bit patterns as integers)."""
    it = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return int((a.view(it).long() - b.view(it).long()).abs().max())


def check_adamw(torch, gen):
    """The one-pass AdamW kernel against its plain version at olmo-1b's
    leaf shapes and a ragged size, f32 and bf16 leaves (p and g), with and
    without the clip, over three steps from one state (each side carries
    its own), and the ragged size through unaligned views (the kernel's
    element-at-a-time path); p, m and v within ``ADAMW_ULPS``.  Then: the
    functional contract (inputs unchanged), a refused non-contiguous CUDA
    leaf, no host sync, the count of updated elements, and each olmo shape
    timed beside its bound (28 bytes an f32 parameter), the plain version
    and ``torch._fused_adamw_`` (in place; timed only), with the peak the
    update adds above its inputs."""
    from repro_torch.kernels.adamw import (adamw, adamw_kernel, adamw_plain,
                                           counts)
    f32, bf16 = torch.float32, torch.bfloat16

    def draw(shape, dtype, s, offset=0):
        n = math.prod(shape)
        buf = torch.empty(n + offset, device="cuda")
        buf.normal_(generator=gen).mul_(s)
        return buf[offset:].view(shape).to(dtype)

    def bias(step):
        t = torch.tensor(float(step), device="cuda")
        return (1 - torch.pow(ADAMW_HYPER["b1"], t),
                1 - torch.pow(ADAMW_HYPER["b2"], t))

    cases, worst = [], 0
    for name, shape, _ in ADAMW_LEAVES:
        for dtype in (f32, bf16):
            for clip in (False, True):
                # f32 only unaligned: a bf16 draw is a copy, aligned again
                for offset in ((0, 1) if name == "ragged" and dtype == f32
                               else (0,)):
                    p = draw(shape, dtype, 0.02, offset)
                    m = draw(shape, f32, 1e-3, offset)
                    v = draw(shape, f32, 1e-3, offset).abs_()
                    scale = (torch.tensor(ADAMW_SCALE, device="cuda")
                             if clip else None)
                    kp, km, kv = p, m, v
                    pp, pm, pv = p, m, v
                    ulps = dict(p=0, m=0, v=0)
                    for step in range(1, ADAMW_STEPS + 1):
                        g = draw(shape, dtype, 1e-2, offset)
                        bc1, bc2 = bias(step)
                        given = (g, kp, km, kv)
                        kept = [x.clone() for x in given]
                        kp, km, kv = adamw_kernel(g, km, kv, kp, scale, bc1,
                                                  bc2, **ADAMW_HYPER)
                        if not all(map(torch.equal, kept, given)):
                            raise AssertionError("adamw wrote an input")
                        pp, pm, pv = adamw_plain(g, pm, pv, pp, scale, bc1,
                                                 bc2, **ADAMW_HYPER)
                        for k, a, b in (("p", kp, pp), ("m", km, pm),
                                        ("v", kv, pv)):
                            ulps[k] = max(ulps[k], _ulps(torch, a, b))
                        del g, given, kept
                    worst = max(worst, *ulps.values())
                    cases.append(dict(leaf=name, shape=list(shape),
                                      dtype=str(dtype).removeprefix("torch."),
                                      clip=clip, unaligned=bool(offset),
                                      max_ulps=ulps))
                    del p, m, v, kp, km, kv, pp, pm, pv
    torch.cuda.empty_cache()
    if worst > ADAMW_ULPS:
        raise AssertionError(f"adamw kernel vs plain: {worst} ulps > "
                             f"{ADAMW_ULPS}: {json.dumps(cases)}")
    # refusals and the sync detector
    x = torch.zeros((64, 32), device="cuda")
    one = torch.ones((), device="cuda")
    for what, args in (("non-contiguous p", (x, x, x, x.t().contiguous().t())),
                       ("non-contiguous g", (x.t().contiguous().t(), x, x, x))):
        try:
            adamw(*args, None, one, one, **ADAMW_HYPER)
        except ValueError:
            continue
        raise AssertionError(f"adamw took a {what}")
    counts.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        adamw(x, x, x, x, one, one, one, **ADAMW_HYPER)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if (counts.launches, counts.elements) != (1, x.numel()):
        raise AssertionError(f"adamw counts {counts.launches} launches, "
                             f"{counts.elements} elements")
    del x
    # timing at olmo's shapes, f32 leaves and the clip as the cells run it
    timed, step_ms, step_bound, step_plain, step_lib = [], 0.0, 0.0, 0.0, 0.0
    for name, shape, k in ADAMW_LEAVES:
        if not k:
            continue
        p, g = draw(shape, f32, 0.02), draw(shape, f32, 1e-2)
        m, v = draw(shape, f32, 1e-3), draw(shape, f32, 1e-3).abs_()
        scale = torch.tensor(ADAMW_SCALE, device="cuda")
        bc1, bc2 = bias(3)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        peaks = {}
        for side, fn in (("kernel", adamw_kernel), ("plain", adamw_plain)):
            torch.cuda.reset_peak_memory_stats()
            out = fn(g, m, v, p, scale, bc1, bc2, **ADAMW_HYPER)
            torch.cuda.synchronize()
            peaks[side] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            del out
        ms, host_ms = time_ms(lambda i: adamw_kernel(
            g, m, v, p, scale, bc1, bc2, **ADAMW_HYPER), 10)
        plain_ms = time_ms(lambda i: adamw_plain(
            g, m, v, p, scale, bc1, bc2, **ADAMW_HYPER), 5)[0]
        steps = [torch.tensor(3.0, device="cuda")]
        lib_ms = time_ms(lambda i: torch._fused_adamw_(
            [p], [g], [m], [v], [], steps, lr=ADAMW_HYPER["lr"],
            beta1=ADAMW_HYPER["b1"], beta2=ADAMW_HYPER["b2"],
            weight_decay=ADAMW_HYPER["weight_decay"],
            eps=ADAMW_HYPER["eps"], amsgrad=False, maximize=False), 10)[0]
        n = math.prod(shape)
        b_ms, b_by = bound(28 * n, 0.0, "float32")
        timed.append(dict(leaf=name, shape=list(shape), count=k, ms=ms,
                          host_ms=host_ms, bound_ms=b_ms, bound_by=b_by,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          roofline=b_ms / ms, peak_above_inputs_gib=peaks))
        step_ms += k * ms
        step_bound += k * b_ms
        step_plain += k * plain_ms
        step_lib += k * lib_ms
        del p, g, m, v
        torch.cuda.empty_cache()
    row = dict(shape="olmo-1b's leaves, f32", dtype="float32",
               max_abs_err=0.0, max_ulps=worst, tolerance=ADAMW_ULPS,
               ms=step_ms, bound_ms=step_bound, bound_by="bytes",
               plain_ms=step_plain, library_ms=step_lib,
               roofline=step_bound / step_ms, host_sync_free=True,
               parameters=sum(k * math.prod(s) for _, s, k in ADAMW_LEAVES),
               leaves=timed, cases=cases)
    print("adamw", json.dumps(row), flush=True)
    return row


def _live_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: the work of one head."""
    if not causal:
        return S * S if window <= 0 else sum(
            S - max(0, q - window + 1) for q in range(S))
    if window <= 0:
        return S * (S + 1) // 2
    return sum(min(q + 1, window) for q in range(S))


def check_flash_bwd(torch, F, ref, gen):
    """The backward kernel against torch autograd of the plain attention in
    f32 on the same inputs (f32 at rtol/atol 1e-4; bf16 to a normalized max
    error of 2e-2, since dS = P (dP - D) is a difference of nearly equal
    terms, rounded to bf16 relative to the tensor's scale); the forward's
    log-sum-exp against the plain one; timed in bf16 beside its bound,
    autograd of the plain version and SDPA's backward."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd)
    rows = []
    for B, S, H, KV, hd, causal, window in FLASH_BWD_CASES:
        mk = lambda n: torch.randn((B, S, n, hd), generator=gen,   # noqa
                                   device="cuda")
        q32, k32, v32, do32 = mk(H), mk(KV), mk(KV), mk(H)
        ins32 = [t.requires_grad_() for t in (q32, k32, v32)]
        want_o = ref.attention(*ins32, causal=causal, window=window)
        want = torch.autograd.grad(want_o, ins32, do32)
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = (t.detach().to(dt) for t in (q32, k32, v32, do32))
            if dt == torch.bfloat16:    # the plain version on the same
                ins = [t.float().requires_grad_() for t in (q, k, v)]
                ref_o = ref.attention(*ins, causal=causal, window=window)
                ref_g = torch.autograd.grad(ref_o, ins, do.float())
            else:
                ref_g = want
            o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                     with_lse=True)
            got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                      window=window)
            torch.cuda.synchronize()
            if dt == torch.float32:
                for g, w in zip(got, ref_g):
                    torch.testing.assert_close(g, w, rtol=BWD_F32_TOL,
                                               atol=BWD_F32_TOL)
                errs["float32"] = max((g - w).abs().max().item()
                                      for g, w in zip(got, ref_g))
                scores = torch.einsum(
                    "bqhd,bkhd->bhqk", q,
                    k.repeat_interleave(H // KV, dim=2)) * hd ** -0.5
                qp = torch.arange(S, device="cuda")[:, None]
                kp = torch.arange(S, device="cuda")[None, :]
                live = kp <= qp if causal else torch.ones_like(qp == kp)
                if window > 0:
                    live = live & (kp > qp - window)
                want_lse = torch.logsumexp(
                    scores.masked_fill(~live, float("-inf")), -1)
                torch.testing.assert_close(lse, want_lse, rtol=1e-5,
                                           atol=1e-5)
            else:
                norm = max(((g.float() - w).abs().max()
                            / w.abs().max()).item()
                           for g, w in zip(got, ref_g))
                if not norm <= BWD_BF16_NORM_TOL:
                    raise AssertionError(f"flash_attention_bwd bf16 "
                                         f"normalized error {norm}")
                errs["bfloat16_normalized"] = norm
                errs["bfloat16"] = max((g.float() - w).abs().max().item()
                                       for g, w in zip(got, ref_g))
        # timing in bf16, the training path's dtype
        q, k, v, do = (t.detach().to(torch.bfloat16)
                       for t in (q32, k32, v32, do32))
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 with_lse=True)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                         window=window)
        flops = 2.5 * 4.0 * hd * H * B * _live_pairs(S, causal, window)
        b_ms, b_by = bound(nbytes(q, k, v, o, do, lse, dq, dk, dv), flops,
                           "bfloat16")
        sets = rotation((q, k, v, o, do, lse))
        n = len(sets)
        ms, host_ms = time_ms(lambda i: flash_attention_bwd(
            *sets[i % n], causal=causal, window=window), 10)
        pin = [t.requires_grad_() for t in (q.clone(), k.clone(), v.clone())]
        pout = ref.attention(*pin, causal=causal, window=window)
        plain_ms = time_ms(lambda i: torch.autograd.grad(
            pout, pin, do, retain_graph=True), 5)[0]
        lin = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        mask = window_mask(torch, S, window) if window > 0 else None
        lout = F.scaled_dot_product_attention(
            *lin, is_causal=causal and mask is None, attn_mask=mask,
            enable_gqa=True)
        ldo = do.transpose(1, 2)
        library_ms = time_ms(lambda i: torch.autograd.grad(
            lout, lin, ldo, retain_graph=True), 10)[0]
        row = dict(shape=[B, S, H, KV, hd], causal=causal, window=window,
                   max_abs_err=errs["float32"], tolerance=BWD_F32_TOL,
                   bf16_max_abs_err=errs["bfloat16"],
                   bf16_normalized_err=errs["bfloat16_normalized"],
                   bf16_tolerance=BWD_BF16_NORM_TOL, ms=ms, host_ms=host_ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                   bound_by=b_by)
        rows.append(row)
        print("flash_attention_bwd", json.dumps(row), flush=True)
        del pin, pout, lin, lout, sets
    torch.cuda.empty_cache()
    main = rows[0]                  # the training shape, causal
    xattn = check_flash_cross_bwd(torch, F, ref, gen)
    return {**main, "max_abs_err": max(
        [r["max_abs_err"] for r in rows]
        + [r["max_abs_err"] for r in xattn if r["dtype"] == "float32"]),
            "hd128": [r for r in rows if r["shape"][4] == 128],
            "hd256": [r for r in rows if r["shape"][4] == 256
                      and r["shape"][2] == 10],
            "gemma3": [r for r in rows if r["shape"][2:] == [8, 4, 256]],
            "xattn_bwd": xattn}


def check_flash_cross_bwd(torch, F, ref, gen):
    """The backward at Sq != Sk, non-causal (the vision model's xattn),
    against torch autograd of ``ref.attention`` in f32 on the same inputs:
    f32 at rtol/atol 1e-4, bf16 at a normalized max error of 2e-2 per
    gradient (as the square backward); timed in both dtypes beside its
    bound (every (query, key) pair live: 2.5 x 4 hd H B Sq Sk operations),
    autograd of the plain version and SDPA's backward (no mask)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd)
    rows = []
    for B, Sq, Sk, H, KV, hd in XATTN_BWD_CASES:
        mk = lambda s, n: torch.randn((B, s, n, hd), generator=gen,  # noqa
                                      device="cuda")
        q32, k32, v32, do32 = mk(Sq, H), mk(Sk, KV), mk(Sk, KV), mk(Sq, H)
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            q, k, v, do = (t.to(dtype) for t in (q32, k32, v32, do32))
            ins = [t.float().requires_grad_() for t in (q, k, v)]
            want = torch.autograd.grad(ref.attention(*ins, causal=False),
                                       ins, do.float())
            o, lse = flash_attention(q, k, v, causal=False, with_lse=True)
            got = flash_attention_bwd(q, k, v, o, do, lse, causal=False)
            torch.cuda.synchronize()
            for g, t in zip(got, (q, k, v)):
                if g.shape != t.shape or g.dtype != dtype:
                    raise AssertionError(f"xattn backward: {g.shape} "
                                         f"{g.dtype} for {t.shape}")
            err = max((g.float() - w).abs().max().item()
                      for g, w in zip(got, want))
            if dt == "float32":
                tol, norm = BWD_F32_TOL, None
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, rtol=tol, atol=tol)
            else:
                tol = BWD_BF16_NORM_TOL
                norm = max(_norm_err(g, w) for g, w in zip(got, want))
                if not norm <= tol:
                    raise AssertionError(f"xattn backward {B, Sq, Sk} bf16 "
                                         f"normalized error {norm}")
            del ins, want
            flops = 2.5 * 4.0 * hd * H * B * Sq * Sk
            b_ms, b_by = bound(nbytes(q, k, v, o, do, lse, *got), flops, dt)
            sets = rotation((q, k, v, o, do, lse))
            n = len(sets)
            reps = 10 if dt == "bfloat16" else 3
            ms, host_ms = time_ms(lambda i: flash_attention_bwd(
                *sets[i % n], causal=False), reps)
            pin = [t.clone().requires_grad_() for t in (q, k, v)]
            pout = ref.attention(*pin, causal=False)
            plain_ms = time_ms(lambda i: torch.autograd.grad(
                pout, pin, do, retain_graph=True), 3)[0]
            lin = [t.transpose(1, 2).detach().requires_grad_()
                   for t in (q, k, v)]
            lout = F.scaled_dot_product_attention(*lin, enable_gqa=True)
            ldo = do.transpose(1, 2)
            library_ms = time_ms(lambda i: torch.autograd.grad(
                lout, lin, ldo, retain_graph=True), reps)[0]
            row = dict(shape=[B, Sq, Sk, H, KV, hd], dtype=dt, causal=False,
                       max_abs_err=err, normalized_err=norm, tolerance=tol,
                       ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            print("flash_attention_bwd xattn", json.dumps(row), flush=True)
            del pin, pout, lin, lout, sets, got, o, lse
        torch.cuda.empty_cache()
    return rows


# chunked prefill (C, L, start, window, dtype, head dim, H, KV): at
# llama3.2-1b's 32 heads over 8 kv heads an empty ring, dead slots (start <
# L), wrapped rings (start > L), windows and one f32 case; the main shape
# at mixtral-8x7b's head dim 128; recurrentgemma-2b's local layers (10
# heads over 1 kv head of 256, its 2048 window over a full 2048-slot ring)
# in bf16 and f32, and its serving ring of 544 slots (the third chunk of a
# 512-token prompt) in bf16; gemma3-4b's (8 heads over 4 kv heads of 256)
# local ring of 1024 slots wrapped by the zoo phase's long prompt (its
# 1024 window) and its global ring of 2048; the last chunk (start 172) of
# the zoo phase's 300-token prompt at olmo-1b's heads (16 over 16 of 128,
# bf16 and f32) and musicgen-large's (32 over 32 of 64).  PREFILL_MAIN,
# the third chunk of a 448-token prompt in the 544-slot ring, is the main
# path's shape.  The ring lives in pools of 16-slot pages under a
# shuffled table, as the serving cache holds it.
PREFILL_CASES = [(128, 544, 0, 0, "bfloat16", 64, 32, 8),
                 (128, 544, 256, 0, "bfloat16", 64, 32, 8),
                 (16, 544, 320, 0, "bfloat16", 64, 32, 8),
                 (128, 1024, 700, 0, "bfloat16", 64, 32, 8),
                 (128, 544, 900, 0, "bfloat16", 64, 32, 8),
                 (16, 1024, 1500, 128, "bfloat16", 64, 32, 8),
                 (128, 544, 300, 128, "bfloat16", 64, 32, 8),
                 (128, 544, 900, 0, "float32", 64, 32, 8),
                 (128, 544, 256, 0, "bfloat16", 128, 32, 8),
                 (128, 2048, 2176, 2048, "bfloat16", 256, 10, 1),
                 (128, 2048, 2176, 2048, "float32", 256, 10, 1),
                 (128, 544, 256, 2048, "bfloat16", 256, 10, 1),
                 (128, 1024, 972, 1024, "bfloat16", 256, 8, 4),
                 (128, 2048, 972, 0, "bfloat16", 256, 8, 4),
                 (128, 544, 172, 0, "bfloat16", 128, 16, 16),
                 (128, 544, 172, 0, "float32", 128, 16, 16),
                 (128, 544, 172, 0, "bfloat16", 64, 32, 32)]
PREFILL_MAIN = (128, 544, 256, 0, "bfloat16", 64, 32, 8)
PREFILL_HD128 = (128, 544, 256, 0, "bfloat16", 128, 32, 8)
PAGE = 16


def chunk_inputs(torch, gen, C, L, start, dtype, B=1, H=32, KV=8, hd=64):
    """A chunk at positions start..start+C-1 over a ring of L slots holding
    the positions before it, as ``attention_prefill_paged`` makes them."""
    from repro_torch.models.attention import ring_positions
    mk = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                device="cuda").to(dtype)
    ctx_pos = ring_positions(start, L, "cuda")[None].expand(B, L)
    q_pos = (start + torch.arange(C, dtype=torch.int32,
                                  device="cuda"))[None].expand(B, C)
    return (mk(B, C, H, hd), mk(B, L, KV, hd), mk(B, L, KV, hd),
            mk(B, C, KV, hd), mk(B, C, KV, hd), ctx_pos, q_pos)


def paged(torch, gen, ins, page=PAGE):
    """The context of ``chunk_inputs`` moved into pools of ``page``-slot
    pages (B * n_pp + 5 of them, the rest random) under a shuffled table:
    (q, k_pool, v_pool, table, k_new, v_new, ctx_pos, q_pos)."""
    q, k_ctx, v_ctx, k_new, v_new, ctx_pos, q_pos = ins
    B, L, KV, hd = k_ctx.shape
    n_pp = L // page
    P = B * n_pp + 5
    table = torch.randperm(P, generator=gen, device="cuda")[:B * n_pp]
    table = table.reshape(B, n_pp).to(torch.int32)
    if torch.equal(table.flatten().long(), torch.arange(B * n_pp,
                                                        device="cuda")):
        table = table.flip(1)
    pools = []
    for ctx in (k_ctx, v_ctx):
        pool = torch.randn((P, page, KV, hd), generator=gen,
                           device="cuda").to(ctx.dtype)
        pool[table.long()] = ctx.reshape(B, n_pp, page, KV, hd)
        pools.append(pool)
    return (q, pools[0], pools[1], table, k_new, v_new, ctx_pos, q_pos)


def check_prefill_page_attention(torch, F, ref, gen):
    """The chunked-prefill kernel reading the ring in place from pools under
    a shuffled page table, against ``ref.prefill_page_attention`` over
    ``ref.page_gather``; its gathered form (one page of L slots a row) on
    the same inputs against the plain version and bit-identical to the
    paged one; each case timed (the paged form, the main path's) beside
    its bound, the plain version (gather included), two ``page_gather``
    calls (the copies this kernel no longer needs) and SDPA with a boolean
    mask over the gathered keys (timed only)."""
    from repro_torch.kernels.page_gather import (
        page_gather, prefill_page_attention, prefill_page_attention_paged)
    rows = {}
    for case in PREFILL_CASES:
        C, L, start, window, dt, hd, H, KV = case
        dtype = getattr(torch, dt)
        ins = chunk_inputs(torch, gen, C, L, start, dtype, H=H, KV=KV, hd=hd)
        pins = paged(torch, gen, ins)
        q, pk, pv, table = pins[:4]
        got = prefill_page_attention_paged(*pins, window=window)
        view = prefill_page_attention(*ins, window=window)
        want = ref.prefill_page_attention(*ins, window=window)
        want_p = ref.prefill_page_attention(
            q, ref.page_gather(pk, table), ref.page_gather(pv, table),
            *ins[3:], window=window)
        torch.cuda.synchronize()
        tol = BF16_TOL if dt == "bfloat16" else F32_TOL
        err = max((got.float() - want_p.float()).abs().max().item(),
                  (view.float() - want.float()).abs().max().item())
        torch.testing.assert_close(got.float(), want_p.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(view.float(), want.float(), rtol=tol,
                                   atol=tol)
        if not torch.equal(got, view):
            raise AssertionError(f"prefill paged != gathered form at {case}")
        k_ctx, ctx_pos, q_pos = ins[1], ins[5], ins[6]
        mask = ref.prefill_mask(ctx_pos, q_pos, window)
        live = int(mask.sum().item())           # this run's (row, key) pairs
        # bytes: q, out, the positions and the table whole, K/V only for
        # the key slots some row of the chunk sees (the kernel loads no
        # other)
        keys = int(mask.any(1).sum().item())
        kv_bytes = 2 * keys * KV * hd * k_ctx.element_size()
        b_ms, b_by = bound(nbytes(q, got, ctx_pos, q_pos, table) + kv_bytes,
                           4.0 * hd * H * live, dt)
        sets = rotation(pins)
        n = len(sets)
        lib_sets = [(st[0].transpose(1, 2),
                     torch.cat([ref.page_gather(st[1], st[3]), st[4]],
                               1).transpose(1, 2),
                     torch.cat([ref.page_gather(st[2], st[3]), st[5]],
                               1).transpose(1, 2)) for st in sets]
        reps = 50 if dt == "bfloat16" else 5
        ms, host_ms = time_ms(lambda i: prefill_page_attention_paged(
            *sets[i % n], window=window), reps)
        gather_ms = time_ms(lambda i: (page_gather(sets[i % n][1],
                                                   sets[i % n][3]),
                                       page_gather(sets[i % n][2],
                                                   sets[i % n][3])), reps)[0]
        plain = lambda st: ref.prefill_page_attention(  # noqa: E731
            st[0], ref.page_gather(st[1], st[3]),
            ref.page_gather(st[2], st[3]), *st[4:], window=window)
        row = dict(
            shape=[1, C, L, H, KV, hd], start=start, window=window, dtype=dt,
            page=PAGE, live_pairs_per_head=live, live_keys=keys,
            max_abs_err=err, tolerance=tol, ms=ms, host_ms=host_ms,
            gather_ms=gather_ms,
            plain_ms=time_ms(lambda i: plain(sets[i % n]), 10)[0],
            library_ms=time_ms(lambda i: F.scaled_dot_product_attention(
                *lib_sets[i % n], attn_mask=mask[:, None],
                enable_gqa=True), reps)[0],
            bound_ms=b_ms, bound_by=b_by)
        rows[case] = row
        print("prefill_page_attention", json.dumps(row), flush=True)
        del sets, lib_sets
    worst = max(r["max_abs_err"] for r in rows.values())
    return {**rows[PREFILL_MAIN], "max_abs_err": worst,
            "hd128": rows[PREFILL_HD128],
            "hd256": [r for c, r in rows.items() if c[5] == 256
                      and c[6] == 10],
            "gemma3": [r for c, r in rows.items() if c[5] == 256
                       and c[6] == 8],
            "group1": [r for c, r in rows.items() if c[6] == c[7]]}


# moe_grouped_ffn at mixtral-8x7b's width (d 4096, f 14336, 8 experts,
# top-2, capacity factor 1.25), G routing groups of g tokens each: a decode
# batch (the shape the serving path launches most, so the main row), a
# 128-token chunk, whole prompts of 300 and 512 tokens, and the training
# shape (batch 4 x 512 in two groups of 1024: C 320, two slot tiles of 160)
MOE_SHAPES = (("decode", 1, 8), ("chunk", 1, 128), ("prompt300", 1, 300),
              ("prompt512", 1, 512), ("train", 2, 1024))
MOE_F32_TOL = 1e-4


def moe_route(torch, gen, cfg, g, G=1):
    """dispatch and combine for G groups of g tokens from random router
    logits, through the model's own routing (``models.moe.route``)."""
    import math
    from repro_torch.models.moe import route
    E = cfg.n_experts
    C = max(math.ceil(g * cfg.top_k * cfg.capacity_factor / E), 1)
    probs = torch.softmax(torch.randn((G, g, E), generator=gen,
                                      device="cuda"), -1)
    return route(probs, cfg.top_k, C)


def _moe_norm_err(torch, got, want) -> tuple[float, float]:
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def check_moe_grouped_ffn(torch, F, ref, gen):
    """The grouped MoE FFN kernel against its plain version at the mixtral
    shapes in bf16 (normalized max error <= 2e-2), the edge cases at the
    decode shape (an expert with no token, a token no expert takes, a
    random dispatch with two tokens in one slot), and one small f32 case
    at rtol/atol 1e-4.  Timed beside its bound over the live experts and
    slots, the plain version, and as a library yardstick the three expert
    products as ``torch.bmm`` (cuBLAS) on the gathered (E, C, d) input,
    with the SwiGLU between them and no dispatch or combine: no single
    PyTorch call computes the grouped FFN.  Only the small tensors are
    rotated past the L2 cache: the 2.8 GB of expert weights exceed it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_matmul import moe_grouped_ffn, plan
    cfg = get_config("mixtral-8x7b")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    E, d, f, bf = cfg.n_experts, cfg.d_model, cfg.d_ff, torch.bfloat16

    def weight(shape, fan_in):
        w = torch.randn(shape, generator=gen, device="cuda")
        return w.mul_(fan_in ** -0.5).to(bf)

    ws = (weight((E, d, f), d), weight((E, d, f), d), weight((E, f, d), f))
    torch.cuda.empty_cache()

    def gathered(dispatch, x):  # (E, G C, d): the bmm yardstick's input
        return torch.einsum("GgEC,Ggd->EGCd", dispatch.to(bf), x).flatten(
            1, 2).contiguous()

    def library(xin):
        h = F.silu(torch.bmm(xin, ws[0])) * torch.bmm(xin, ws[1])
        return torch.bmm(h, ws[2])

    rows = {}
    for name, G, g in MOE_SHAPES:
        dispatch, combine = moe_route(torch, gen, cfg, g, G)
        x = torch.randn((G, g, d), generator=gen, device="cuda").to(bf)
        got = moe_grouped_ffn(dispatch, combine, x, *ws)
        want = ref.moe_grouped_ffn(dispatch, combine, x, *ws)
        torch.cuda.synchronize()
        err, norm = _moe_norm_err(torch, got, want)
        if not norm <= BF16_TOL:
            raise AssertionError(f"moe_grouped_ffn {name}: normalized error "
                                 f"{norm}")
        slots = int(dispatch.any(1).sum().item())          # live (e, c)
        experts = int(dispatch.any(3).any(1).any(0).sum().item())
        need = experts * 3 * d * f * 2 + nbytes(dispatch, combine, x, got)
        b_ms, b_by = bound(need, 6.0 * d * f * slots, "bfloat16")
        sets = rotation((dispatch, combine, x))
        n = len(sets)
        lib_sets = [gathered(st[0], st[2]) for st in sets]
        iters = 40 if g <= 128 else 10
        ms, host_ms = time_ms(lambda i: moe_grouped_ffn(*sets[i % n], *ws),
                              iters)
        p = plan(G, g, E, dispatch.shape[-1], d, f, bf, n_sm)
        rows[name] = dict(
            case=name, shape=[G, g, E, dispatch.shape[-1], d, f],
            slot_tile=p["tile"], down_splits=p["ks"], live_experts=experts,
            live_slots=slots, max_abs_err=err, normalized_err=norm,
            tolerance=BF16_TOL, ms=ms, host_ms=host_ms,
            plain_ms=time_ms(lambda i: ref.moe_grouped_ffn(
                *sets[i % n], *ws), max(iters // 4, 3))[0],
            library_ms=time_ms(lambda i: library(lib_sets[i % n]), iters)[0],
            library="3 x torch.bmm + SwiGLU on the gathered (E, C, d) input",
            bound_ms=b_ms, bound_by=b_by)
        print("moe_grouped_ffn", json.dumps(rows[name]), flush=True)
        del sets, lib_sets
    print("moe_grouped_ffn ms by shape (kernel / bound / plain / bmm):",
          json.dumps({n: [r[k] for k in ("ms", "bound_ms", "plain_ms",
                                         "library_ms")]
                      for n, r in rows.items()}), flush=True)

    # edge cases at the decode shape
    dispatch, combine = moe_route(torch, gen, cfg, 8)
    dispatch[..., 0, :] = False                 # expert 0 gets no token
    combine[..., 0, :] = 0
    dispatch[:, 3] = False                      # token 3 is dropped
    combine[:, 3] = 0
    x = torch.randn((1, 8, d), generator=gen, device="cuda").to(bf)
    got = moe_grouped_ffn(dispatch, combine, x, *ws)
    edge = {"no_token_expert_and_dropped_token":
            _moe_norm_err(torch, got, ref.moe_grouped_ffn(
                dispatch, combine, x, *ws))[1]}
    if not torch.equal(got[:, 3], torch.zeros_like(got[:, 3])):
        raise AssertionError("moe_grouped_ffn: a dropped token is not 0")
    dispatch = torch.rand(dispatch.shape, generator=gen, device="cuda") < 0.2
    dispatch[0, 0, 1, 0] = dispatch[0, 1, 1, 0] = True   # two in one slot
    combine = torch.rand(dispatch.shape, generator=gen, device="cuda")
    edge["random_dispatch_two_in_one_slot"] = _moe_norm_err(
        torch, moe_grouped_ffn(dispatch, combine, x, *ws),
        ref.moe_grouped_ffn(dispatch, combine, x, *ws))[1]
    del ws
    torch.cuda.empty_cache()
    # one small f32 case
    small = dataclasses.replace(cfg, n_experts=4)
    dispatch, combine = moe_route(torch, gen, small, 16)
    x = torch.randn((1, 16, 256), generator=gen, device="cuda")
    w32 = [torch.randn(s, generator=gen, device="cuda") * s[1] ** -0.5
           for s in ((4, 256, 512), (4, 256, 512), (4, 512, 256))]
    got = moe_grouped_ffn(dispatch, combine, x, *w32)
    want = ref.moe_grouped_ffn(dispatch, combine, x, *w32)
    torch.testing.assert_close(got, want, rtol=MOE_F32_TOL, atol=MOE_F32_TOL)
    edge["float32_max_abs_err"] = (got - want).abs().max().item()
    print("moe_grouped_ffn edge cases:", json.dumps(dict(
        **edge, tolerance=BF16_TOL, float32_tolerance=MOE_F32_TOL)),
        flush=True)
    if not max(edge["no_token_expert_and_dropped_token"],
               edge["random_dispatch_two_in_one_slot"]) <= BF16_TOL:
        raise AssertionError(f"moe_grouped_ffn edge cases: {edge}")
    worst = max(r["max_abs_err"] for r in rows.values())
    return {**rows["decode"], "max_abs_err": worst, "shapes": rows,
            "edge_cases": edge}


MOE_BWD_NAMES = ("dx", "dcombine", "dwg", "dwu", "dwd")


def _moe_grads(torch, ref, dispatch, ins, dout, kernel):
    """(dx, dcombine, dwg, dwu, dwd) of sum(out * dout) through the
    kernels (``MoEGroupedFFN``), or autograd of the plain version in f32
    on the same values."""
    from repro_torch.kernels.moe_matmul import MoEGroupedFFN
    if kernel:
        leaves = [t.detach().clone().requires_grad_() for t in ins]
        g = torch.autograd.grad(MoEGroupedFFN.apply(dispatch, *leaves),
                                leaves, dout)
    else:
        leaves = [t.detach().float().requires_grad_() for t in ins]
        g = torch.autograd.grad(ref.moe_grouped_ffn(dispatch, *leaves),
                                leaves, dout.float())
    return (g[1], g[0], g[2], g[3], g[4])


def _moe_bwd_errs(torch, got, want) -> dict:
    """Each gradient's max |error| over max |reference|."""
    return {n: ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp(min=1e-30)).item()
            for n, a, b in zip(MOE_BWD_NAMES, got, want)}


# the bf16 backward's launches in order (moe_matmul.plan_bwd's names)
MOE_BWD_LAUNCHES = ("rows", "dy", "dh", "dxin", "dwd", "dwg_dwu", "dx",
                    "dcombine")
# an earlier version's csrc, unpacked here to be timed in turns with this
# one (optional; the MoE backward check skips it when absent)
MOE_PARENT_DIR = ROOT / "build" / "moe_parent"


def moe_bwd_bounds(G, g, E, C, d, f, slots: int, experts: int) -> dict:
    """The backward's least time at one shape: operations, six products of
    2 d f flops a live slot and dcombine's 2 d g a live slot, against the
    bytes it must move (each expert's weights read and their gradients
    written once, dout, dispatch, combine, the saved xin, H, a, b and
    bf16 y of each live slot, dx and dcombine).  ``bound_ms`` counts
    dcombine on the tensor cores in bf16 (the route it takes);
    ``bound_ms_dcombine_f32`` on the CUDA cores in f32."""
    tc, dc = 12.0 * d * f * slots, 2.0 * d * g * slots
    need = (experts * 3 * d * f * 2 * 2 + G * g * d * 2 * 2
            + G * g * E * C * (1 + 4 + 4) + slots * (d * 2 * 2 + 3 * f * 2))
    t_bytes = need / PEAK_BYTES_PER_S
    t_new = (tc + dc) / PEAK_FLOPS["bfloat16"]
    t_old = tc / PEAK_FLOPS["bfloat16"] + dc / PEAK_FLOPS["float32"]
    return dict(bound_ms=max(t_new, t_bytes) * 1e3,
                bound_by="operations" if t_new >= t_bytes else "bytes",
                bound_ms_dcombine_f32=max(t_old, t_bytes) * 1e3)


def launch_breakdown(fn, names, calls: int = 3) -> dict:
    """{launch name: mean device ms} of the kernels one call of ``fn(i)``
    makes, from a ``torch.profiler`` trace of the last ``calls`` of
    ``calls + 1`` calls (a call's kernels in their start order, named by
    ``names``), and their kernel names under ``"kernels"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    # one call more than is read: the trace can miss the first kernels of
    # its window, so the last ``calls`` calls' kernels are taken
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls + 1):
            fn(i)
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events()
                 if e.device_type.name == "CUDA" and "moe_" in e.name),
                key=lambda e: e.time_range.start)
    if len(ev) < calls * len(names) or len(ev) > (calls + 1) * len(names):
        raise RuntimeError(f"{len(ev)} kernels in {calls + 1} calls, want "
                           f"{len(names)} a call: "
                           f"{[e.name[:40] for e in ev[:12]]}")
    ev = ev[len(ev) - calls * len(names):]
    out = {n: sum(ev[c * len(names) + i].time_range.elapsed_us()
                  for c in range(calls)) / calls / 1e3
           for i, n in enumerate(names)}
    out["kernels"] = [re.sub(r"^.*?(moe_\w+).*$", r"\1", e.name)
                      for e in ev[:len(names)]]
    return out


def moe_parent_backward(dispatch, combine, x, ws, dout):
    """The backward of the version unpacked at ``MOE_PARENT_DIR`` (built
    with nvcc there, through ``tools/moe_compare.py``'s loader), as
    ``fn(i)``; None when no such version is there."""
    if not (MOE_PARENT_DIR / "moe_grouped_ffn.cu").exists():
        return None
    import importlib.util
    from repro_torch.kernels import _build
    spec = importlib.util.spec_from_file_location(
        "moe_compare", ROOT / "tools" / "moe_compare.py")
    mc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mc)
    lib = mc.load_other(MOE_PARENT_DIR, _build._nvcc(), _build.NVCC_FLAGS)
    return mc.other_backward(lib, dispatch, combine, x, ws, dout)


def check_moe_grouped_ffn_bwd(torch, F, ref, gen):
    """The grouped FFN's backward kernel (``moe_grouped_ffn_bwd``) against
    torch autograd of the plain version in f32 on the same inputs, at
    mixtral-8x7b's training shape in bf16 (each of dx, dcombine, dwg, dwu,
    dwd within a normalized max error of 2e-2), its edge cases at the
    decode shape (an expert with no token: exact-zero weight gradients; a
    dropped token: dx exactly 0; a random dispatch with two tokens in one
    slot and combine weights off the dispatch: 2e-2), one narrow f32 case
    at rtol/atol 1e-4, and two calls bit for bit.  Timed (the backward's
    launch alone, from one forward's saved tensors) beside its bound
    (``moe_bwd_bounds``: operations, with dcombine on the tensor cores as
    it runs, and beside it with dcombine on the CUDA cores), autograd of
    the plain version in bf16, and as a library yardstick torch autograd
    through three ``torch.bmm`` and SwiGLU on the gathered (E, G C, d)
    input (no dispatch, combine or their gradients: no single PyTorch
    call computes them); each launch's time from a profiler trace; and,
    when an earlier version's source is unpacked at ``MOE_PARENT_DIR``,
    that version's backward in turns (parent, this, this, parent)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_matmul import (
        launch_forward, moe_grouped_ffn_bwd, plan_bwd)
    cfg = get_config("mixtral-8x7b")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    E, d, f, bf = cfg.n_experts, cfg.d_model, cfg.d_ff, torch.bfloat16
    G, g = MOE_SHAPES[-1][1:]

    def weight(shape, fan_in):
        w = torch.randn(shape, generator=gen, device="cuda")
        return w.mul_(fan_in ** -0.5).to(bf)

    ws = (weight((E, d, f), d), weight((E, d, f), d), weight((E, f, d), f))
    torch.cuda.empty_cache()
    dispatch, combine = moe_route(torch, gen, cfg, g, G)
    C = dispatch.shape[-1]
    x = torch.randn((G, g, d), generator=gen, device="cuda").to(bf)
    dout = torch.randn((G, g, d), generator=gen, device="cuda").to(bf)
    got = _moe_grads(torch, ref, dispatch, (combine, x, *ws), dout, True)
    again = _moe_grads(torch, ref, dispatch, (combine, x, *ws), dout, True)
    bits = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    want = _moe_grads(torch, ref, dispatch, (combine, x, *ws), dout, False)
    torch.cuda.synchronize()
    errs = _moe_bwd_errs(torch, got, want)
    max_abs = max((a.float() - b).abs().max().item()
                  for a, b in zip(got, want))
    del got, want
    torch.cuda.empty_cache()
    if not bits:
        raise AssertionError("moe_grouped_ffn_bwd: two calls differ")
    if not max(errs.values()) <= BWD_BF16_NORM_TOL:
        raise AssertionError(f"moe_grouped_ffn_bwd bf16 normalized errors "
                             f"{errs}")

    # timing: the backward's launch alone, from one forward's tensors
    ins = (dispatch, combine, x, *ws)
    _, saved = launch_forward(ins, save=True)
    this = lambda i: moe_grouped_ffn_bwd(  # noqa: E731
        dout, dispatch, combine, *ws, saved)
    parent = moe_parent_backward(dispatch, combine, x, ws, dout)
    parent_ms = None
    if parent is None:
        ms, host_ms = time_ms(this, 10)
    else:   # in turns: parent, this, this, parent
        turns = [time_ms(fn, 10) for fn in (parent, this, this, parent)]
        ms, host_ms = turns[1]
        parent_ms = [turns[0][0], turns[3][0]]
        print("moe_grouped_ffn_bwd ms in turns (parent, this, this, "
              "parent):", json.dumps([t[0] for t in turns]), flush=True)
    breakdown = launch_breakdown(this, MOE_BWD_LAUNCHES)
    print("moe_grouped_ffn_bwd launches (ms):", json.dumps(breakdown),
          flush=True)
    del parent
    live = dispatch.any(1)                              # (G, E, C)
    slots = int(live.sum().item())
    experts = int(live.any(2).any(0).sum().item())
    bounds = moe_bwd_bounds(G, g, E, C, d, f, slots, experts)
    b_ms, b_by = bounds["bound_ms"], bounds["bound_by"]
    print("moe_grouped_ffn_bwd bounds:", json.dumps(dict(
        ms=ms, **bounds, share=bounds["bound_ms"] / ms,
        share_dcombine_f32=bounds["bound_ms_dcombine_f32"] / ms)),
        flush=True)
    del saved
    pin = [t.clone().requires_grad_() for t in (combine, x, *ws)]
    pout = ref.moe_grouped_ffn(dispatch, *pin)
    plain_ms = time_ms(lambda i: torch.autograd.grad(
        pout, pin, dout, retain_graph=True), 3)[0]
    del pin, pout
    lin = [torch.einsum("GgEC,Ggd->EGCd", dispatch.to(bf), x).flatten(
        1, 2).contiguous().requires_grad_()] + [
        w.clone().requires_grad_() for w in ws]
    lout = torch.bmm(F.silu(torch.bmm(lin[0], lin[1]))
                     * torch.bmm(lin[0], lin[2]), lin[3])
    ldo = torch.randn(lout.shape, generator=gen, device="cuda").to(bf)
    library_ms = time_ms(lambda i: torch.autograd.grad(
        lout, lin, ldo, retain_graph=True), 10)[0]
    del lin, lout, ldo
    torch.cuda.empty_cache()
    p = plan_bwd(G, g, E, C, d, f, bf, n_sm)

    # edge cases at the decode shape
    dispatch, combine = moe_route(torch, gen, cfg, 8)
    dispatch[..., 0, :] = False                 # expert 0 gets no token
    combine[..., 0, :] = 0
    dispatch[:, 3] = False                      # token 3 is dropped
    combine[:, 3] = 0
    xs = torch.randn((1, 8, d), generator=gen, device="cuda").to(bf)
    ds = torch.randn((1, 8, d), generator=gen, device="cuda").to(bf)
    eg = _moe_grads(torch, ref, dispatch, (combine, xs, *ws), ds, True)
    edge = {"no_token_expert_and_dropped_token": max(_moe_bwd_errs(
        torch, eg, _moe_grads(torch, ref, dispatch, (combine, xs, *ws), ds,
                              False)).values())}
    zeros = all(torch.equal(w[0], torch.zeros_like(w[0])) for w in eg[2:])
    dropped = torch.equal(eg[0][:, 3], torch.zeros_like(eg[0][:, 3]))
    if not (zeros and dropped):
        raise AssertionError(f"moe_grouped_ffn_bwd: idle expert's gradients "
                             f"zero {zeros}, dropped token's dx zero "
                             f"{dropped}")
    dispatch = torch.rand(dispatch.shape, generator=gen, device="cuda") < 0.2
    dispatch[0, 0, 1, 0] = dispatch[0, 1, 1, 0] = True   # two in one slot
    combine = torch.rand(dispatch.shape, generator=gen, device="cuda")
    edge["random_dispatch_two_in_one_slot"] = max(_moe_bwd_errs(
        torch, _moe_grads(torch, ref, dispatch, (combine, xs, *ws), ds, True),
        _moe_grads(torch, ref, dispatch, (combine, xs, *ws), ds,
                   False)).values())
    del ws, eg
    torch.cuda.empty_cache()
    # one narrow f32 case
    small = dataclasses.replace(cfg, n_experts=4)
    dispatch, combine = moe_route(torch, gen, small, 16)
    x32 = torch.randn((1, 16, 256), generator=gen, device="cuda")
    w32 = [torch.randn(s, generator=gen, device="cuda") * s[1] ** -0.5
           for s in ((4, 256, 512), (4, 256, 512), (4, 512, 256))]
    d32 = torch.randn((1, 16, 256), generator=gen, device="cuda")
    g32 = _moe_grads(torch, ref, dispatch, (combine, x32, *w32), d32, True)
    r32 = _moe_grads(torch, ref, dispatch, (combine, x32, *w32), d32, False)
    for a, b in zip(g32, r32):
        torch.testing.assert_close(a, b, rtol=BWD_F32_TOL, atol=BWD_F32_TOL)
    edge["float32_max_abs_err"] = max((a - b).abs().max().item()
                                      for a, b in zip(g32, r32))
    print("moe_grouped_ffn_bwd edge cases:", json.dumps(dict(
        **edge, idle_expert_grads_zero=zeros, dropped_token_dx_zero=dropped,
        tolerance=BWD_BF16_NORM_TOL, float32_tolerance=BWD_F32_TOL)),
        flush=True)
    if not max(edge["no_token_expert_and_dropped_token"],
               edge["random_dispatch_two_in_one_slot"]) <= BWD_BF16_NORM_TOL:
        raise AssertionError(f"moe_grouped_ffn_bwd edge cases: {edge}")
    row = dict(shape=[G, g, E, C, d, f], live_slots=slots,
               live_experts=experts, max_abs_err=max_abs,
               normalized_err=errs, tolerance=BWD_BF16_NORM_TOL,
               two_calls_bit_identical=bits, ms=ms, host_ms=host_ms,
               plain_ms=plain_ms, library_ms=library_ms,
               library="torch autograd through 3 x torch.bmm + SwiGLU on "
                       "the gathered (E, G C, d) input",
               bound_ms=b_ms, bound_by=b_by,
               bound_ms_dcombine_f32=bounds["bound_ms_dcombine_f32"],
               parent_ms=parent_ms, breakdown=breakdown,
               plan={k: p[k] for k in ("tile", "dh", "dxin", "dwd",
                                       "dwg_dwu", "dcombine")},
               edge_cases=edge)
    print("moe_grouped_ffn_bwd", json.dumps(row), flush=True)
    return row


# the WKV recurrence at rwkv6-1.6b's width on the training path (batch 4 x
# 512 tokens, 32 heads of 64), ragged T at the smoke and full head dims, and
# a ragged T past eight 64-step chunks
WKV_MAIN = (4, 512, 32, 64)
WKV_RAGGED = ((4, 77, 32, 16), (4, 77, 32, 64), (4, 513, 32, 64))
WKV_RAGGED_BWD = (4, 513, 32, 64)


def wkv_plan_fields(B, T, H, hd, fwd: bool) -> dict:
    """The chunk, the blocks a pass launches and the launch plan of the WKV
    kernels of one direction, for the timing rows."""
    from repro_torch.kernels.rwkv6_scan import plan
    p = plan(B, T, H, hd)
    names = ("fwd_sum", "fwd") if fwd else ("bwd_sum", "bwd_dv", "bwd",
                                            "du")
    return dict(chunk=p["chunk"], blocks={n: p[n]["blocks"] for n in names},
                plan={n: {k: p[n][k] for k in ("grid", "threads", "smem")}
                      for n in names})
WKV_LIBRARY = "none: no single PyTorch call computes the WKV recurrence"
WKV_PLAIN_TIMING = "events without the spin: host-bound, host gaps included"


def wkv_inputs(torch, gen, B, T, H, hd, dtype, decay_mean=0.0):
    """r, k, v in ``dtype``; w = exp(-exp(x)), x ~ N(decay_mean, 1), and u
    in f32, the range and types the model gives the kernel (decay_mean 2
    puts w near 0)."""
    r, k, v = (torch.randn((B, T, H, hd), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    x = torch.randn((B, T, H, hd), generator=gen, device="cuda")
    u = torch.randn((H, hd), generator=gen, device="cuda") * 0.1
    return r, k, v, torch.exp(-torch.exp(x + decay_mean)), u


def check_rwkv6_scan(torch, ref, gen):
    """The WKV forward against its plain version: at the training shape in
    bf16 (w from N(0, 1) and near 0 from N(2, 1)) at rtol/atol 2e-2, at a
    ragged T = 77 in f32 at 1e-4 (head dims 16 and 64) and at T = 513 (nine
    chunks, the last one step), and its checkpointed states against
    ``ref.rwkv6_stateful`` over the first chunks and the last, f32 at 1e-4.  Timed as the training path calls it (with its
    checkpoints) beside its bound, the serial floor of T dependent steps
    and the plain version; there is no library call to time."""
    from repro_torch.kernels.rwkv6_scan import chunk, rwkv6_scan
    B, T, H, hd = WKV_MAIN
    errs = {}
    for mean in (0.0, 2.0):
        ins = wkv_inputs(torch, gen, B, T, H, hd, torch.bfloat16, mean)
        got, want = rwkv6_scan(*ins), ref.rwkv6(*ins)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                                   atol=BF16_TOL)
        errs[f"bfloat16_decay_mean_{mean:g}"] = \
            (got.float() - want.float()).abs().max().item()
    for shape in WKV_RAGGED:
        ins = wkv_inputs(torch, gen, *shape, torch.float32)
        got, want = rwkv6_scan(*ins), ref.rwkv6(*ins)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
        errs[f"float32_T{shape[1]}_hd{shape[3]}"] = \
            (got - want).abs().max().item()
    ins = wkv_inputs(torch, gen, B, T, H, hd, torch.float32)
    _, ckpt = rwkv6_scan(*ins, with_state=True)
    S0 = torch.zeros((B, H, hd, hd), device="cuda")
    ck_err = 0.0
    for c in (0, 1, 2, 3, ckpt.shape[2] - 1):
        t = c * chunk()
        _, want = ref.rwkv6_stateful(*(x[:, :t] for x in ins[:4]), ins[4], S0)
        torch.testing.assert_close(ckpt[:, :, c], want, rtol=F32_TOL,
                                   atol=F32_TOL)
        ck_err = max(ck_err, (ckpt[:, :, c] - want).abs().max().item())
    errs["float32_checkpoints"] = ck_err
    del ckpt
    # timing in bf16, the training path's dtype, with its checkpoints
    ins = wkv_inputs(torch, gen, B, T, H, hd, torch.bfloat16)
    y, ckpt = rwkv6_scan(*ins, with_state=True)
    # the bound counts the function's own traffic (r, k, v, w, u in, y out);
    # the checkpoints are this kernel's design, reported apart
    b_ms, b_by = bound(nbytes(*ins, y), 5.0 * hd * hd * B * T * H,
                       "float32")
    sets = rotation(ins)
    n = len(sets)
    ms, host_ms = time_ms(lambda i: rwkv6_scan(*sets[i % n], with_state=True),
                          20)
    row = dict(shape=[B, T, H, hd], dtype="bfloat16 r/k/v, float32 w/u",
               max_abs_err=max(errs.values()), errors=errs,
               tolerance=BF16_TOL, f32_tolerance=F32_TOL, ms=ms,
               host_ms=host_ms, serial_steps=T, ms_per_step=ms / T,
               plain_ms=time_ms(lambda i: ref.rwkv6(*sets[i % n]), 3,
                                spin=False)[0],
               plain_timing=WKV_PLAIN_TIMING, library_ms=None,
               library=WKV_LIBRARY, bound_ms=b_ms, bound_by=b_by,
               checkpoint_bytes=nbytes(ckpt),
               **wkv_plan_fields(B, T, H, hd, fwd=True))
    print("rwkv6_scan", json.dumps(row), flush=True)
    del sets, y, ckpt
    torch.cuda.empty_cache()
    return row


def check_rwkv6_scan_bwd(torch, ref, gen):
    """The WKV backward against torch autograd of the plain version in f32
    on the same inputs (f32 at rtol/atol 1e-4, du against its closed form
    sum_{b,t} r k (v . dy) in f64; bf16 to a normalized max error of 2e-2,
    the plain version run on the bf16 inputs upcast), at the training
    shape with w from N(0, 1) and near 0 from N(2, 1), and in f32 at
    T = 513 (nine chunks, the last one step).
    Timed in bf16 beside its bound, the serial floor and autograd of the
    plain version; there is no library call to time."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_bwd
    B, T, H, hd = WKV_MAIN
    errs = {}
    # the training shape at both decays in f32 and bf16 on one draw each,
    # then the ragged T = 513 in f32
    cases = [(WKV_MAIN, 0.0, (torch.float32, torch.bfloat16)),
             (WKV_MAIN, 2.0, (torch.float32, torch.bfloat16)),
             (WKV_RAGGED_BWD, 0.0, (torch.float32,))]
    for shape, mean, dts in cases:
        ins32 = wkv_inputs(torch, gen, *shape, torch.float32, mean)
        dy32 = torch.randn(shape, generator=gen, device="cuda")
        for dt in dts:
            ins = [x.to(dt) for x in ins32[:3]] + list(ins32[3:])
            dy = dy32.to(dt)
            leaves = [x.float().requires_grad_() for x in ins]
            want = torch.autograd.grad(ref.rwkv6(*leaves), leaves,
                                       dy.float())
            del leaves
            _, ckpt = rwkv6_scan(*ins, with_state=True)
            got = rwkv6_scan_bwd(*ins, ckpt, dy)
            torch.cuda.synchronize()
            key = f"{str(dt)[6:]}_decay_mean_{mean:g}" + (
                "" if shape == WKV_MAIN else f"_T{shape[1]}")
            if dt == torch.float32:
                for g, w in zip(got[:4], want[:4]):
                    torch.testing.assert_close(g, w, rtol=BWD_F32_TOL,
                                               atol=BWD_F32_TOL)
                # du sums B*T = 2048 terms of ~|v.dy|: autograd's f32
                # running sum drifts ~1e-3 from the exact value, so du is
                # held to its closed form in f64 instead
                du = torch.einsum("bthi,bthi,bth->hi", ins[0].double(),
                                  ins[1].double(),
                                  (ins[2].double() * dy.double()).sum(-1))
                torch.testing.assert_close(got[4].double(), du,
                                           rtol=BWD_F32_TOL,
                                           atol=BWD_F32_TOL)
                errs[key] = max([(g - w).abs().max().item()
                                 for g, w in zip(got[:4], want[:4])]
                                + [(got[4].double() - du).abs().max().item()])
                errs[key + "_du_autograd_vs_exact"] = \
                    (want[4].double() - du).abs().max().item()
            else:
                norm = max(((g.float() - w).abs().max()
                            / w.abs().max()).item()
                           for g, w in zip(got, want))
                if not norm <= BWD_BF16_NORM_TOL:
                    raise AssertionError(f"rwkv6_scan_bwd bf16 normalized "
                                         f"error {norm}")
                errs[key + "_normalized"] = norm
            del got, want, ckpt
    torch.cuda.empty_cache()
    # timing in bf16, the training path's dtype
    ins = wkv_inputs(torch, gen, B, T, H, hd, torch.bfloat16)
    dy = torch.randn((B, T, H, hd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    _, ckpt = rwkv6_scan(*ins, with_state=True)
    grads = rwkv6_scan_bwd(*ins, ckpt, dy)
    # the function's own traffic: r, k, v, w, u, dy in, the five gradients
    # out; the checkpoints it reads are the forward's design, reported apart
    b_ms, b_by = bound(nbytes(*ins, dy, *grads),
                       14.0 * hd * hd * B * T * H, "float32")
    sets = rotation((*ins, ckpt, dy))
    n = len(sets)
    ms, host_ms = time_ms(lambda i: rwkv6_scan_bwd(*sets[i % n]), 10)
    leaves = [x.float().requires_grad_() for x in ins]
    out = ref.rwkv6(*leaves)
    plain_ms = time_ms(lambda i: torch.autograd.grad(
        out, leaves, dy.float(), retain_graph=True), 3, spin=False)[0]
    row = dict(shape=[B, T, H, hd], dtype="bfloat16 r/k/v/dy, float32 w/u",
               max_abs_err=max(v for k, v in errs.items()
                               if k.startswith("float32")
                               and not k.endswith("exact")),
               errors=errs, tolerance=BWD_F32_TOL,
               bf16_tolerance=BWD_BF16_NORM_TOL, ms=ms, host_ms=host_ms,
               serial_steps=T, ms_per_step=ms / T, plain_ms=plain_ms,
               plain_timing=WKV_PLAIN_TIMING, library_ms=None,
               library=WKV_LIBRARY, bound_ms=b_ms, bound_by=b_by,
               checkpoint_bytes=nbytes(ckpt),
               **wkv_plan_fields(B, T, H, hd, fwd=False))
    print("rwkv6_scan_bwd", json.dumps(row), flush=True)
    del sets, leaves, out, grads, ckpt
    torch.cuda.empty_cache()
    return row


# the RG-LRU recurrence at recurrentgemma-2b's width on the training path
# (batch 4 x 512 tokens, 2560 channels), a ragged shape, and a ragged T one
# step past the training shape's chunks
LRU_MAIN = (4, 512, 2560)
LRU_RAGGED = ((4, 77, 200), (4, 513, 200))
LRU_LIBRARY = "none: no single PyTorch call computes the RG-LRU recurrence"
LRU_FWD_FLOPS = 6.0             # a step: a^2, 1 - a^2, sqrt, 2 products, sum
LRU_BWD_FLOPS = 10.0            # the gate again, dh, dx, da, the carry


def lru_inputs(torch, gen, B, T, D, dtype, draw="model"):
    """x ~ N(0, 1) and the decay a in ``dtype``: ``model`` as recurrentgemma
    makes it, exp(-8 softplus(lam) sigmoid(z)) with lam ~ N(0, 0.5^2) per
    channel (the init scale of ``lam``) and z ~ N(0, 1); ``near1`` puts
    1 - a in [5e-4, 4e-3], which bf16 rounds to 1 (g = 0) or 1 - 2^-8."""
    x = torch.randn((B, T, D), generator=gen, device="cuda")
    z = torch.randn((B, T, D), generator=gen, device="cuda")
    if draw == "model":
        lam = 0.5 * torch.randn((D,), generator=gen, device="cuda")
        a = torch.exp(-8.0 * torch.nn.functional.softplus(lam)
                      * torch.sigmoid(z))
    else:
        a = 1.0 - (5e-4 + 3.5e-3 * torch.sigmoid(z))
    return x.to(dtype), a.to(dtype)


def lru_plan_fields(torch, B, T, D) -> dict:
    """The chunk (the dependent steps a thread walks), the threads a pass
    and the launch plan of the RG-LRU kernels at bf16, for the timing
    rows."""
    from repro_torch.kernels.rglru_scan import plan
    p = plan(B, T, D, torch.bfloat16)
    return dict(chunk=p["chunk"], serial_steps=p["chunk"],
                threads=p["threads_total"],
                plan={k: p[k] for k in ("grid", "threads", "slots", "lanes",
                                        "windows", "smem_fwd", "smem_bwd")})


def lru_chunk_ends(T: int) -> list[int]:
    """The step each RG-LRU checkpoint follows: each chunk's last."""
    from repro_torch.kernels.rglru_scan import chunk
    return [min(t + chunk(), T) - 1 for t in range(0, T, chunk())]


def check_rglru_scan(torch, ref, gen):
    """The RG-LRU forward against its plain version: at the training shape
    in bf16 (a from the model's map, and a near 1, where bf16 makes it 1 and
    g = 0) at rtol/atol 2e-2, at ragged T 77 and 513 (one step past the
    training shape's chunks), D 200 in f32 at 1e-4, and on strided inputs
    (x a slice of a wider tensor, a with a transposed batch layout) in f32
    at 1e-4; its checkpoints (the f32 state at each chunk's last step)
    against the plain version's states there in f32 at 1e-4.  Timed as the
    training path calls it (with its checkpoints) beside its bound and the
    plain version; there is no library call to time."""
    from repro_torch.kernels.rglru_scan import rglru_scan
    B, T, D = LRU_MAIN
    errs = {}
    for draw in ("model", "near1"):
        x, a = lru_inputs(torch, gen, B, T, D, torch.bfloat16, draw)
        got, want = rglru_scan(x, a), ref.rglru(x, a)[0]
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                                   atol=BF16_TOL)
        errs[f"bfloat16_{draw}"] = \
            (got.float() - want.float()).abs().max().item()
        if draw == "near1":
            errs["bfloat16_near1_saturated_share"] = \
                (a == 1.0).float().mean().item()
    for shape in LRU_RAGGED:
        x, a = lru_inputs(torch, gen, *shape, torch.float32)
        got, ck = rglru_scan(x, a, with_state=True)
        want = ref.rglru(x, a)[0]
        torch.cuda.synchronize()
        for name, t, w in (("", got, want), ("_checkpoints", ck,
                                             want[:, lru_chunk_ends(shape[1])])):
            torch.testing.assert_close(t, w, rtol=F32_TOL, atol=F32_TOL)
            errs[f"float32_T{shape[1]}_D{shape[2]}{name}"] = \
                (t - w).abs().max().item()
    x, a = lru_inputs(torch, gen, *LRU_RAGGED[0], torch.float32)
    want = ref.rglru(x, a)[0]
    xs = torch.cat([x, x], 2)[..., LRU_RAGGED[0][2]:]
    as_ = a.transpose(0, 1).contiguous().transpose(0, 1)
    got = rglru_scan(xs, as_)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    errs["float32_strided"] = (got - want).abs().max().item()
    # timing in bf16, the training path's dtype, with its checkpoints
    x, a = lru_inputs(torch, gen, B, T, D, torch.bfloat16)
    y, ck = rglru_scan(x, a, with_state=True)
    # the bound counts the function's own traffic (x, a in, h out); the f32
    # checkpoints are this kernel's design, reported apart
    b_ms, b_by = bound(nbytes(x, a, y), LRU_FWD_FLOPS * B * T * D,
                       "float32")
    sets = rotation((x, a))
    n = len(sets)
    ms, host_ms = time_ms(lambda i: rglru_scan(*sets[i % n],
                                               with_state=True), 20)
    row = dict(shape=[B, T, D], dtype="bfloat16", max_abs_err=max(
                   v for k, v in errs.items() if not k.endswith("share")),
               errors=errs, tolerance=BF16_TOL, f32_tolerance=F32_TOL,
               ms=ms, host_ms=host_ms,
               plain_ms=time_ms(lambda i: ref.rglru(*sets[i % n]), 3,
                                spin=False)[0],
               plain_timing=WKV_PLAIN_TIMING, library_ms=None,
               library=LRU_LIBRARY, bound_ms=b_ms, bound_by=b_by,
               state_bytes=nbytes(ck), **lru_plan_fields(torch, B, T, D))
    print("rglru_scan", json.dumps(row), flush=True)
    del sets, y, ck
    torch.cuda.empty_cache()
    return row


def check_rglru_scan_bwd(torch, ref, gen):
    """The RG-LRU backward against torch autograd of the plain version in
    f32 on the same inputs, where a < 1 (f32 at rtol/atol 1e-4; bf16 to a
    normalized max error of 2e-2, the plain version run on the bf16 inputs
    upcast) at the training shape, a from the model's map, and in f32 at
    T 513, D 200 (one step past the training shape's chunks); the value at
    g = 0 pinned (a band of steps with a = 1: dx = 0 and da = dh h_{t-1}
    exactly as its closed form from the plain version's states, and finite
    where autograd of the plain version is not); two runs bit for bit.
    Timed in bf16 beside its bound and autograd of the plain version; there
    is no library call to time."""
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
    B, T, D = LRU_MAIN
    errs = {}
    x32, a32 = lru_inputs(torch, gen, B, T, D, torch.float32)
    dy32 = torch.randn((B, T, D), generator=gen, device="cuda")
    xr, ar = lru_inputs(torch, gen, *LRU_RAGGED[1], torch.float32)
    dyr = torch.randn(LRU_RAGGED[1], generator=gen, device="cuda")
    for key, (x, a, dy) in (
            ("float32", (x32, a32, dy32)),
            ("bfloat16", (t.to(torch.bfloat16) for t in (x32, a32, dy32))),
            ("float32_T513", (xr, ar, dyr))):
        if not a.max().item() < 1.0:
            raise AssertionError("rglru_scan_bwd: the draw reached a = 1")
        leaves = [t.float().requires_grad_() for t in (x, a)]
        want = torch.autograd.grad(ref.rglru(*leaves)[0], leaves,
                                   dy.float())
        _, ck = rglru_scan(x, a, with_state=True)
        got = rglru_scan_bwd(x, a, ck, dy)
        torch.cuda.synchronize()
        if key.startswith("float32"):
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=BWD_F32_TOL,
                                           atol=BWD_F32_TOL)
            errs[key] = max((g - w).abs().max().item()
                            for g, w in zip(got, want))
        else:
            norm = max(((g.float() - w).abs().max() / w.abs().max()).item()
                       for g, w in zip(got, want))
            if not norm <= BWD_BF16_NORM_TOL:
                raise AssertionError(f"rglru_scan_bwd bf16 normalized "
                                     f"error {norm}")
            errs["bfloat16_normalized"] = norm
        del leaves, want, got, ck
    # the value at g = 0, in f32 (bf16 rounds a >= 0.998046875 to 1)
    n = min(64, T)
    x, a = x32[:, :n].contiguous(), a32[:, :n].clone()
    a[:, 8:n - 8:4] = 1.0
    dy = dy32[:, :n].contiguous()
    _, ck = rglru_scan(x, a, with_state=True)
    dx, da = rglru_scan_bwd(x, a, ck, dy)
    h = ref.rglru(x, a)[0]
    hprev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    dh, c = torch.empty_like(dy), torch.zeros_like(dy[:, 0])
    for t in range(n - 1, -1, -1):
        dh[:, t] = dy[:, t] + c
        c = a[:, t] * dh[:, t]
    sat = a == 1.0
    leaves = [t.clone().requires_grad_() for t in (x, a)]
    plain_da = torch.autograd.grad(ref.rglru(*leaves)[0], leaves, dy)[1]
    torch.cuda.synchronize()
    torch.testing.assert_close(da[sat], (dh * hprev)[sat], rtol=BWD_F32_TOL,
                               atol=BWD_F32_TOL)
    pinned = (torch.equal(dx[sat], torch.zeros_like(dx[sat]))
              and bool(torch.isfinite(da).all())
              and not bool(torch.isfinite(plain_da[sat]).all()))
    errs["g0_da_err"] = (da[sat] - (dh * hprev)[sat]).abs().max().item()
    if not pinned:
        raise AssertionError("rglru_scan_bwd: the g = 0 rule does not hold")
    del leaves, plain_da
    # two runs, bit for bit
    x, a, dy = x32.to(torch.bfloat16), a32.to(torch.bfloat16), \
        dy32.to(torch.bfloat16)
    _, ck = rglru_scan(x, a, with_state=True)
    first = rglru_scan_bwd(x, a, ck, dy)
    again = rglru_scan_bwd(x, a, ck, dy)
    if not all(torch.equal(p, q) for p, q in zip(first, again)):
        raise AssertionError("rglru_scan_bwd is not deterministic")
    # timing in bf16, the training path's dtype: the function's own traffic
    # (x, a, dy in, dx, da out); the f32 checkpoints it reads are the
    # forward's design, reported apart
    b_ms, b_by = bound(nbytes(x, a, dy, *first),
                       LRU_BWD_FLOPS * B * T * D, "float32")
    sets = rotation((x, a, ck, dy))
    n = len(sets)
    ms, host_ms = time_ms(lambda i: rglru_scan_bwd(*sets[i % n]), 20)
    leaves = [t.float().requires_grad_() for t in (x, a)]
    out = ref.rglru(*leaves)[0]
    plain_ms = time_ms(lambda i: torch.autograd.grad(
        out, leaves, dy.float(), retain_graph=True), 3, spin=False)[0]
    row = dict(shape=[B, T, D], dtype="bfloat16",
               max_abs_err=max(errs["float32"], errs["float32_T513"]),
               errors=errs,
               tolerance=BWD_F32_TOL, bf16_tolerance=BWD_BF16_NORM_TOL,
               g0_rule_pinned=pinned, deterministic=True, ms=ms,
               host_ms=host_ms, plain_ms=plain_ms,
               plain_timing=WKV_PLAIN_TIMING, library_ms=None,
               library=LRU_LIBRARY, bound_ms=b_ms, bound_by=b_by,
               state_bytes=nbytes(ck), **lru_plan_fields(torch, B, T, D))
    print("rglru_scan_bwd", json.dumps(row), flush=True)
    del sets, leaves, out, first, again, ck
    torch.cuda.empty_cache()
    return row


# serving's stateful recurrences (prefill, 128-token chunks, decode steps)
# from a carried state: recurrentgemma-2b's width (D 2560) and rwkv6-1.6b's
# heads (32 of 64), B1 at T 1, 37, 128, 300 (the serving phases' ragged
# prompt) and 512, recurrentgemma's B8 decode steps and rwkv6's B4 (the
# serving phase's batch) and B8
STATE_TS = (1, 37, 128, 300, 512)
LRU_STATE_SHAPES = tuple((1, T, LRU_MAIN[2]) for T in STATE_TS) \
    + ((8, 1, LRU_MAIN[2]),)
WKV_STATE_SHAPES = tuple((1, T, 32, 64) for T in STATE_TS) \
    + ((4, 1, 32, 64), (8, 1, 32, 64))


def _state_row(shape, errs, ms, host_ms, plain_ms, b):
    """A timing row of a stateful recurrence (bf16, its errors in both
    dtypes)."""
    return dict(shape=list(shape), dtype="bfloat16", errors=errs,
                max_abs_err=max(errs.values()), tolerance=BF16_TOL,
                f32_tolerance=F32_TOL, null_state_bits=True, ms=ms,
                host_ms=host_ms, plain_ms=plain_ms,
                plain_timing=WKV_PLAIN_TIMING, library_ms=None,
                bound_ms=b[0], bound_by=b[1])


def check_rglru_stateful(torch, ref, gen):
    """The RG-LRU forward from a carried state h0, as serving runs it
    (``ops.rglru_stateful``): at each of ``LRU_STATE_SHAPES`` in bf16 and
    f32 against ``ref.rglru(x, a, h0)``, the output and the final state
    (the last checkpoint; f32 at 1e-4, bf16 at 2e-2); h0 = None and h0 =
    zeros bit for bit the call without a state, output and every
    checkpoint (the training path's bits).  Timed in bf16 beside its bound
    (x, a, h0 in, h and the final state out) and the plain version; no
    library call computes the recurrence."""
    from repro_torch.kernels.rglru_scan import rglru_scan
    rows = []
    for B, T, D in LRU_STATE_SHAPES:
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            x, a = lru_inputs(torch, gen, B, T, D, dt)
            h0 = torch.randn((B, D), generator=gen, device="cuda")
            y, ck = rglru_scan(x, a, h0=h0, with_state=True)
            want, hT = ref.rglru(x, a, h0)
            torch.cuda.synchronize()
            tol = F32_TOL if dt == torch.float32 else BF16_TOL
            torch.testing.assert_close(y.float(), want.float(), rtol=tol,
                                       atol=tol)
            torch.testing.assert_close(ck[:, -1], hT, rtol=tol, atol=tol)
            key = str(dt)[6:]
            errs[key] = (y.float() - want.float()).abs().max().item()
            errs[key + "_final_state"] = (ck[:, -1] - hT).abs().max().item()
        y0, ck0 = rglru_scan(x, a, with_state=True)
        for s0 in (None, torch.zeros_like(h0)):
            y1, ck1 = rglru_scan(x, a, h0=s0, with_state=True)
            if not (torch.equal(y0, y1) and torch.equal(ck0, ck1)):
                raise AssertionError(f"rglru_scan: a null state changes the "
                                     f"bits at {(B, T, D)}")
        b = bound(nbytes(x, a, y, h0, hT), LRU_FWD_FLOPS * B * T * D,
                  "float32")
        sets = rotation((x, a, h0))
        n = len(sets)
        ms, host_ms = time_ms(lambda i: rglru_scan(
            sets[i % n][0], sets[i % n][1], h0=sets[i % n][2],
            with_state=True), 50)
        plain_ms = time_ms(lambda i: ref.rglru(*sets[i % n]), 3,
                           spin=False)[0]
        row = _state_row((B, T, D), errs, ms, host_ms, plain_ms, b)
        rows.append(row)
        print("rglru_scan stateful", json.dumps(row), flush=True)
        del sets
    return rows


def check_rwkv6_stateful(torch, ref, gen):
    """The WKV forward from a carried state S0 with the final state out,
    as serving runs it (``ops.rwkv6_stateful``): at each of
    ``WKV_STATE_SHAPES`` in bf16 and f32 against ``ref.rwkv6_stateful``, y
    and the final state (f32 at 1e-4, bf16 at 2e-2), checkpoint 0 equal
    to S0; S0 = None and S0 = zeros bit for bit the call without a state,
    y and every checkpoint (the training path's bits).  Timed in bf16
    beside its bound (r, k, v, w, u, S0 in, y and the final state out,
    5 hd^2 FLOPs a step) and the plain version; no library call computes
    the recurrence."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    rows = []
    for B, T, H, hd in WKV_STATE_SHAPES:
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            ins = wkv_inputs(torch, gen, B, T, H, hd, dt)
            S0 = 0.5 * torch.randn((B, H, hd, hd), generator=gen,
                                   device="cuda")
            y, ck, ST = rwkv6_scan(*ins, S0=S0, with_state=True)
            want, wT = ref.rwkv6_stateful(*ins, S0)
            torch.cuda.synchronize()
            tol = F32_TOL if dt == torch.float32 else BF16_TOL
            torch.testing.assert_close(y.float(), want.float(), rtol=tol,
                                       atol=tol)
            torch.testing.assert_close(ST, wT, rtol=tol, atol=tol)
            if not torch.equal(ck[:, :, 0], S0):
                raise AssertionError("rwkv6_scan: checkpoint 0 is not S0")
            key = str(dt)[6:]
            errs[key] = (y.float() - want.float()).abs().max().item()
            errs[key + "_final_state"] = (ST - wT).abs().max().item()
        y0, ck0 = rwkv6_scan(*ins, with_state=True)
        for s0 in (None, torch.zeros_like(S0)):
            y1, ck1 = rwkv6_scan(*ins, S0=s0, with_state=True)[:2]
            if not (torch.equal(y0, y1) and torch.equal(ck0, ck1)):
                raise AssertionError(f"rwkv6_scan: a null state changes the "
                                     f"bits at {(B, T, H, hd)}")
        b = bound(nbytes(*ins, y, S0, ST), 5.0 * hd * hd * B * T * H,
                  "float32")
        sets = rotation((*ins, S0))
        n = len(sets)
        ms, host_ms = time_ms(lambda i: rwkv6_scan(
            *sets[i % n][:5], S0=sets[i % n][5]), 50)
        plain_ms = time_ms(lambda i: ref.rwkv6_stateful(*sets[i % n]), 3,
                           spin=False)[0]
        row = _state_row((B, T, H, hd), errs, ms, host_ms, plain_ms, b)
        rows.append(row)
        print("rwkv6_scan stateful", json.dumps(row), flush=True)
        del sets
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: serving
# ---------------------------------------------------------------------------

def small_end_to_end(torch):
    """The serving path on a narrow f32 model: CUDA kernels on the card
    vs plain versions on the CPU, same params and requests."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs, prefill
    from repro_torch.serve import ServeConfig, ServeEngine, open_loop_requests
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), d_model=256,
                              n_heads=8, n_kv_heads=2, head_dim=64,
                              d_ff=512, dtype=torch.float32)
    params = paramlib.init_tree(model_specs(cfg),
                                torch.Generator().manual_seed(1))
    reqs = open_loop_requests(6, 1.0, cfg.vocab_size, prompt_lens=(8, 40),
                              gen_lens=(4, 12), seed=1)
    scfg = ServeConfig(batch_size=3, page_size=8, cache_len=56,
                       clock="steps")
    outs, logits = {}, {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        outs[dev] = ServeEngine(cfg, p, scfg).run(reqs).outputs
        toks = torch.tensor([reqs[1].prompt], device=dev)
        logits[dev] = prefill(p, toks, cfg, cache_len=56)[0].cpu()
    err = (logits["cpu"] - logits["cuda"]).abs().max().item()
    print(f"small f32 end to end: prefill logits max |cuda-cpu| {err:.3g}; "
          f"greedy tokens equal: {outs['cpu'] == outs['cuda']}", flush=True)
    if outs["cpu"] != outs["cuda"]:
        raise AssertionError(f"greedy tokens differ: {outs}")
    if not err <= 1e-3:
        raise AssertionError(f"prefill logits differ by {err}")
    small_chunked(torch, cfg, params)


# the four chunked configurations of the small f32 run; "pressure" evicts
# trie pages under a pool of one spare sequence
SMALL_CHUNKED = {"chunked": dict(prefill_chunk=8),
                 "prefix": dict(prefix_cache=True),
                 "pressure": dict(prefix_cache=True, prefix_seqs=1),
                 "sampled": dict(prefix_cache=True, temperature=0.8,
                                 top_p=0.9, sample_seed=7)}


def small_chunked(torch, cfg, params):
    """Chunked prefill, the prefix cache and sampling on the narrow f32
    model: greedy tokens CUDA == CPU and chunked == prefix-cached ==
    static whole-prompt on the card; sampled tokens the same under
    continuous + prefix cache and static on the card, and not greedy's."""
    from repro_torch.serve import (ServeConfig, ServeEngine,
                                   shared_prefix_requests)
    base = dict(batch_size=3, page_size=8, cache_len=56, clock="steps")
    reqs = shared_prefix_requests(10, 100.0, cfg.vocab_size, n_prefixes=3,
                                  prefix_len=16, suffix_lens=(4, 8),
                                  gen_lens=(2, 4, 8), seed=3)
    pressure = shared_prefix_requests(12, 100.0, cfg.vocab_size,
                                      n_prefixes=6, prefix_len=16,
                                      suffix_lens=(4, 8), gen_lens=(2, 4, 8),
                                      seed=9)
    sampling = {k: v for k, v in SMALL_CHUNKED["sampled"].items()
                if k != "prefix_cache"}
    reps = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        for name, kw in SMALL_CHUNKED.items():
            rq = pressure if name == "pressure" else reqs
            reps[name, dev] = ServeEngine(cfg, p, ServeConfig(
                **kw, **base)).run(rq)
        for name, kw, rq in (("static", {}, reqs),
                             ("static_pressure", {}, pressure),
                             ("static_sampled", sampling, reqs)):
            reps[name, dev] = ServeEngine(cfg, p, ServeConfig(
                continuous=False, **kw, **base)).run(rq)
    out = {k: r.outputs for k, r in reps.items()}
    checks = {
        "cuda_eq_cpu": all(out[n, "cuda"] == out[n, "cpu"]
                           for n, _ in reps if n not in ("sampled",
                                                         "static_sampled")),
        "chunked_eq_prefix_eq_static": out["chunked", "cuda"]
        == out["prefix", "cuda"] == out["static", "cuda"],
        "pressure_eq_static": out["pressure", "cuda"]
        == out["static_pressure", "cuda"],
        "sampled_schedule_invariant": out["sampled", "cuda"]
        == out["static_sampled", "cuda"],
        "sampled_ne_greedy": out["sampled", "cuda"] != out["static", "cuda"]}
    print("small f32 chunked / prefix / sampled:", json.dumps(dict(
        **checks, prefill_chunks={n: reps[n, "cuda"].prefill_chunks
                                  for n in SMALL_CHUNKED},
        prefix_hit_rate={n: reps[n, "cuda"].prefix_hit_rate
                         for n in SMALL_CHUNKED})), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"small chunked run: {checks}")


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


SERVING_KERNELS = ("flash_attention", "decode_attention")


def full_width(torch, ops, ref):
    from repro_torch.configs import get_config
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs, prefill
    from repro_torch.serve import (ServeConfig, ServeEngine,
                                   open_loop_requests, serving_params)
    cfg = get_config("llama3.2-1b")
    t0 = time.perf_counter()
    master = paramlib.init_tree(
        model_specs(cfg), torch.Generator(device="cuda").manual_seed(0),
        dtype=cfg.param_dtype)
    params = serving_params(master, cfg)
    del master
    torch.cuda.synchronize()
    print(f"llama3.2-1b: {paramlib.param_count(model_specs(cfg))} params "
          f"initialised in {time.perf_counter() - t0:.2f} s", flush=True)

    common = dict(batch_size=8, page_size=16, cache_len=MAIN_L)
    reqs = open_loop_requests(16, 0.5, cfg.vocab_size,
                              prompt_lens=(128, 300, 512), gen_lens=(16, 32),
                              seed=0)
    # a check that what comes out is right: finite logits of the right shape
    logits, _ = prefill(params, torch.tensor([reqs[0].prompt], device="cuda"),
                        cfg, cache_len=MAIN_L)
    if logits.shape != (1, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError("full-width prefill logits are not finite")

    reports, launches = {}, {}
    for cont in (True, False):
        eng = ServeEngine(cfg, params, ServeConfig(continuous=cont,
                                                   clock="steps", **common))
        ops.reset_launches()                 # the serving path starts here
        t0 = time.perf_counter()
        with plain_versions_counted(ref) as plain_calls:
            rep = eng.run(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[cont] = dict(ops.launches)  # ... and ends here
        reports[cont] = rep
        print(f"{rep.mode} (steps clock): {rep.total_tokens} tokens, "
              f"{rep.decode_steps} decode steps, utilization "
              f"{rep.utilization:.3f}, {dt:.2f} s host time; launches "
              f"{launches[cont]}; plain version calls {plain_calls}",
              flush=True)
        if any(plain_calls.values()):
            raise AssertionError(f"plain versions ran: {plain_calls}")
    for rep in reports.values():
        for r in reqs:
            toks = rep.outputs[r.rid]
            if len(toks) != r.gen_len or not all(
                    0 <= t < cfg.vocab_size for t in toks):
                raise AssertionError(f"request {r.rid}: bad output {toks}")
    if reports[True].outputs != reports[False].outputs:
        raise AssertionError("continuous and static greedy tokens differ")
    print("continuous == static greedy tokens: True", flush=True)
    for cont, counts in launches.items():
        if min(counts[k] for k in SERVING_KERNELS) <= 0:
            raise AssertionError(f"a kernel never launched: {counts}")
        # decode reads the pages in place: no gather on the path
        if counts["page_gather"] != 0:
            raise AssertionError(f"page_gather launched: {counts}")

    eng = ServeEngine(cfg, params, ServeConfig(continuous=True, clock="wall",
                                               **common))
    wreqs = open_loop_requests(16, 50.0, cfg.vocab_size,
                               prompt_lens=(128, 300, 512),
                               gen_lens=(16, 32), seed=0)
    rep = eng.run(wreqs)
    print("wall clock continuous:", json.dumps(dict(
        tokens=rep.total_tokens, duration_s=rep.duration,
        tok_per_s=rep.tokens_per_sec, latency_p50_s=rep.latency_p50,
        latency_p99_s=rep.latency_p99, ttft_p50_s=rep.ttft_p50,
        ttft_p99_s=rep.ttft_p99, decode_steps=rep.decode_steps,
        utilization=rep.utilization,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)),
        flush=True)
    where_time_goes(torch, cfg, params, common)
    return {"serving": launches[True],
            "chunked_serving": chunked_serving(torch, ops, ref, cfg, params,
                                               common)}, reports[True].outputs


def small_moe(torch):
    """The MoE serving path on a narrow f32 mixtral (4 experts, top-2,
    window 16, so the ring wraps): CUDA kernels on the card vs plain
    versions on the CPU, same params and requests, at capacity factor
    1.25 (whole prompt, chunked and prefix-cached: same greedy tokens,
    prefill logits within 1e-3); then at 4.0, where no token is dropped,
    continuous == static greedy tokens on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs, prefill
    from repro_torch.serve import (ServeConfig, ServeEngine,
                                   open_loop_requests, shared_prefix_requests)
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"), d_model=256,
                              n_heads=8, n_kv_heads=2, head_dim=64,
                              d_ff=512, dtype=torch.float32)
    params = paramlib.init_tree(model_specs(cfg),
                                torch.Generator().manual_seed(1))
    V = cfg.vocab_size
    reqs = open_loop_requests(6, 1.0, V, prompt_lens=(8, 40),
                              gen_lens=(4, 12), seed=1)
    shared = shared_prefix_requests(8, 100.0, V, n_prefixes=2, prefix_len=8,
                                    suffix_lens=(4, 8), gen_lens=(4, 8),
                                    seed=3)
    base = dict(batch_size=3, page_size=8, cache_len=56, clock="steps")
    runs = {"whole": ({}, reqs), "chunked": (dict(prefill_chunk=8), reqs),
            "prefix": (dict(prefix_cache=True), shared)}
    reps, logits = {}, {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        for name, (kw, rq) in runs.items():
            reps[name, dev] = ServeEngine(cfg, p, ServeConfig(
                **kw, **base)).run(rq)
        toks = torch.tensor([reqs[1].prompt], device=dev)
        logits[dev] = prefill(p, toks, cfg, cache_len=56)[0].cpu()
    err = (logits["cpu"] - logits["cuda"]).abs().max().item()
    same = {name: reps[name, "cpu"].outputs == reps[name, "cuda"].outputs
            for name in runs}
    wide = dataclasses.replace(cfg, capacity_factor=4.0)
    p = _to(params, "cuda")
    cont, static = (ServeEngine(wide, p, ServeConfig(
        continuous=c, **base)).run(reqs).outputs for c in (True, False))
    print("small f32 MoE:", json.dumps(dict(
        prefill_logits_max_abs_err_cuda_vs_cpu=err,
        greedy_tokens_cuda_eq_cpu=same,
        prefill_chunks={n: reps[n, "cuda"].prefill_chunks for n in runs},
        prefix_hit_rate=reps["prefix", "cuda"].prefix_hit_rate,
        continuous_eq_static_at_cf4=cont == static)), flush=True)
    if not all(same.values()):
        raise AssertionError(f"MoE greedy tokens differ CUDA vs CPU: {same}")
    if not err <= 1e-3:
        raise AssertionError(f"MoE prefill logits differ by {err}")
    if not reps["prefix", "cuda"].prefix_hit_rate > 0:
        raise AssertionError("the MoE prefix-cached run hit nothing")
    if cont != static:
        raise AssertionError("MoE continuous != static at capacity 4.0")


# mixtral-8x7b at full width, cut from 32 layers to MOE_DEPTH so its bf16
# weights (23.7 GB) fit one 80 GB card beside their f32 draw
MOE_DEPTH = 8


@contextlib.contextmanager
def plain_route(ops):
    """Send CUDA tensors through the plain versions while the block runs
    (the dispatch asks ``_on_cuda`` at each call)."""
    saved = ops._on_cuda
    ops._on_cuda = lambda t: False
    try:
        yield
    finally:
        ops._on_cuda = saved


@contextlib.contextmanager
def routing_traced(ops):
    """Record the ``dispatch`` of every MoE layer while the block runs."""
    seen, saved = [], ops.moe_grouped_ffn

    def spy(dispatch, *rest, **kw):
        seen.append(dispatch.clone())
        return saved(dispatch, *rest, **kw)
    ops.moe_grouped_ffn = spy
    try:
        yield seen
    finally:
        ops.moe_grouped_ffn = saved


def moe_serving(torch, ops, ref):
    """mixtral-8x7b at full width and depth 8 in bf16, random weights from
    seed 0, built leaf by leaf (each f32 leaf drawn, cast and freed): the
    MoE serving path.  Continuous and static runs on the steps clock
    (launch counts reset just before the continuous run, read just after;
    exact counts for the grouped FFN and the attention kernels, no plain
    version); the first-token logits of the kernels against the plain
    versions on the card; a wall-clock run; a chunked, prefix-cached run;
    and a device profile."""
    from repro_torch.configs import get_config
    from repro_torch.models import paramlib
    from repro_torch.models.config import BlockGroup
    from repro_torch.models.transformer import model_specs, prefill
    from repro_torch.serve import (ServeConfig, ServeEngine,
                                   open_loop_requests, serving_leaf,
                                   shared_prefix_requests)
    full = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(full, groups=(BlockGroup(("swa",),
                                                       MOE_DEPTH),))
    n_layers = MOE_DEPTH
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = paramlib.init_tree(
        model_specs(cfg), torch.Generator(device="cuda").manual_seed(0),
        dtype=cfg.param_dtype,
        leaf_fn=lambda k, t, spec: serving_leaf(k, t, cfg, spec))
    torch.cuda.synchronize()
    print(f"mixtral-8x7b depth {MOE_DEPTH} of {len(full.layer_kinds)}: "
          f"{paramlib.param_count(model_specs(cfg))} params (bf16 serving "
          f"copy, router f32) in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
          f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)

    V = cfg.vocab_size
    common = dict(batch_size=8, page_size=16, cache_len=MAIN_L)
    reqs = open_loop_requests(16, 0.5, V, prompt_lens=(128, 300, 512),
                              gen_lens=(16, 32), seed=0)
    toks = torch.tensor([reqs[0].prompt], device="cuda")
    with routing_traced(ops) as kernel_routes:
        got, _ = prefill(params, toks, cfg, cache_len=MAIN_L)
    with plain_route(ops), routing_traced(ops) as plain_routes:
        want, _ = prefill(params, toks, cfg, cache_len=MAIN_L)
    if got.shape != (1, V) or not torch.isfinite(got).all():
        raise AssertionError("mixtral prefill logits are not finite")
    norm = ((got - want).abs().max() / want.abs().max()).item()
    # bf16 rounds differently on the two paths (the kernel keeps f32 until
    # its output), and a token whose top-2 choice flips, or which another
    # flip pushes over an expert's capacity, takes other experts: the
    # share of tokens routed differently, layer by layer, says how far
    # the two paths' inputs have drifted apart
    moved = [(a.any(-1) != b.any(-1)).any(-1).float().mean().item()
             for a, b in zip(kernel_routes, plain_routes)]
    print("mixtral first-token logits, kernels vs plain versions on the "
          "card (bf16; not gated):", json.dumps(dict(
              prompt_len=len(reqs[0].prompt), normalized_err=norm,
              tokens_routed_differently_by_layer=moved)), flush=True)

    reports, launches = {}, {}
    n_prefills = len(reqs) + len({len(r.prompt) for r in reqs})  # + warmup
    for cont in (True, False):
        eng = ServeEngine(cfg, params, ServeConfig(continuous=cont,
                                                   clock="steps", **common))
        ops.reset_launches()                 # the MoE serving path starts
        t0 = time.perf_counter()
        with plain_versions_counted(ref) as plain_calls:
            rep = eng.run(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[cont] = dict(ops.launches)  # ... and ends here
        reports[cont] = rep
        steps = rep.decode_steps + 1         # + the warmup's decode step
        want_l = {"moe_grouped_ffn": n_layers * (n_prefills + steps),
                  "flash_attention": n_layers * n_prefills,
                  "decode_attention": n_layers * steps,
                  "page_gather": 0}
        print(f"mixtral {rep.mode} (steps clock): {rep.total_tokens} tokens, "
              f"{rep.decode_steps} decode steps, utilization "
              f"{rep.utilization:.3f}, {dt:.2f} s host time; launches "
              f"{launches[cont]}; expected {want_l}; plain version calls "
              f"{plain_calls}", flush=True)
        if any(launches[cont][k] != v for k, v in want_l.items()):
            raise AssertionError(f"launches {launches[cont]}, want {want_l}")
        if any(plain_calls.values()):
            raise AssertionError(f"plain versions ran: {plain_calls}")
        for r in reqs:
            out = rep.outputs[r.rid]
            if len(out) != r.gen_len or not all(0 <= t < V for t in out):
                raise AssertionError(f"request {r.rid}: bad output {out}")
    share = sum(reports[True].outputs[r.rid] == reports[False].outputs[r.rid]
                for r in reqs) / len(reqs)
    print("mixtral continuous vs static greedy requests equal (capacity "
          "1.25 drops depend on the batch; not gated):", share, flush=True)

    torch.cuda.reset_peak_memory_stats()
    wreqs = open_loop_requests(16, 50.0, V, prompt_lens=(128, 300, 512),
                               gen_lens=(16, 32), seed=0)
    rep = ServeEngine(cfg, params, ServeConfig(
        continuous=True, clock="wall", **common)).run(wreqs)
    print("mixtral wall clock continuous:", json.dumps(dict(
        tokens=rep.total_tokens, duration_s=rep.duration,
        tok_per_s=rep.tokens_per_sec, latency_p50_s=rep.latency_p50,
        latency_p99_s=rep.latency_p99, ttft_p50_s=rep.ttft_p50,
        ttft_p99_s=rep.ttft_p99, decode_steps=rep.decode_steps,
        utilization=rep.utilization,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)),
        flush=True)

    sreqs = shared_prefix_requests(16, 0.5, V, n_prefixes=4, prefix_len=256,
                                   suffix_lens=(64, 192), gen_lens=(16, 32),
                                   seed=0)
    eng = ServeEngine(cfg, params, ServeConfig(
        clock="steps", prefill_chunk=CHUNK, prefix_cache=True, **common))
    ops.reset_launches()
    with plain_versions_counted(ref) as plain_calls:
        rep = eng.run(sreqs)
    torch.cuda.synchronize()
    chunked = dict(ops.launches)
    want_c = {"prefill_page_attention": n_layers * (rep.prefill_chunks + 1),
              "moe_grouped_ffn": n_layers * (rep.prefill_chunks + 1
                                             + rep.decode_steps + 1),
              "page_gather": 0}
    print("mixtral chunked, prefix-cached (steps clock):", json.dumps(dict(
        tokens=rep.total_tokens, decode_steps=rep.decode_steps,
        prefill_chunks=rep.prefill_chunks,
        prefix_hit_rate=rep.prefix_hit_rate, launches=chunked,
        expected=want_c, plain_version_calls=plain_calls)), flush=True)
    if any(chunked[k] != v for k, v in want_c.items()):
        raise AssertionError(f"chunked launches {chunked}, want {want_c}")
    if any(plain_calls.values()) or not rep.prefix_hit_rate > 0.3:
        raise AssertionError(f"chunked run: plain {plain_calls}, hit rate "
                             f"{rep.prefix_hit_rate}")
    for r in sreqs:
        out = rep.outputs[r.rid]
        if len(out) != r.gen_len or not all(0 <= t < V for t in out):
            raise AssertionError(f"chunked request {r.rid}: bad {out}")
    where_time_goes(torch, cfg, params, common, label="mixtral profile")
    del params
    torch.cuda.empty_cache()
    return launches[True]


CHUNK = 128
CHUNKED_KERNELS = ("prefill_page_attention", "decode_attention")
LOGITS_NORM_TOL = 2e-2          # bf16 first-token logits: max |d| / max |l|


def chunked_serving(torch, ops, ref, cfg, params, common):
    """llama3.2-1b at full width through chunked prefill (chunk 128), the
    prefix cache and nucleus sampling, on 16 shared-prefix requests (4 hot
    256-token prefixes, suffixes 64/192, generations 16/32): the chunked
    serving path.  Launch counts are set to 0 before its three
    ``steps``-clock runs and read after them."""
    from repro_torch.serve import (ServeConfig, ServeEngine,
                                   shared_prefix_requests)
    V = cfg.vocab_size
    n_layers = sum(g.n * len(g.pattern) for g in cfg.groups)
    reqs = shared_prefix_requests(16, 0.5, V, n_prefixes=4, prefix_len=256,
                                  suffix_lens=(64, 192), gen_lens=(16, 32),
                                  seed=0)
    runs = {"chunked": dict(prefill_chunk=CHUNK),
            "prefix": dict(prefill_chunk=CHUNK, prefix_cache=True),
            "sampled": dict(prefill_chunk=CHUNK, prefix_cache=True,
                            temperature=0.8, top_p=0.9, sample_seed=7)}
    reps, per_run = {}, {}
    ops.reset_launches()                 # the chunked path starts here
    with plain_versions_counted(ref) as plain_calls:
        for name, kw in runs.items():
            eng = ServeEngine(cfg, params, ServeConfig(clock="steps", **kw,
                                                       **common))
            before = dict(ops.launches)
            t0 = time.perf_counter()
            reps[name] = rep = eng.run(reqs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            per_run[name] = {k: ops.launches[k] - before[k]
                             for k in ops.launches}
            # the warmup runs one chunk before the clock starts
            want = n_layers * (rep.prefill_chunks + 1)
            print(f"{name} (steps clock): {rep.total_tokens} tokens, "
                  f"{rep.decode_steps} decode steps, {rep.prefill_chunks} "
                  f"prefill chunks (+1 in the warmup), prefix hit rate "
                  f"{rep.prefix_hit_rate:.4f}, {dt:.2f} s host time; "
                  f"launches {per_run[name]}; prefill_page_attention "
                  f"expected {want}", flush=True)
            if per_run[name]["prefill_page_attention"] != want:
                raise AssertionError(f"{name}: prefill_page_attention "
                                     f"launched {per_run[name]}, want {want}")
            # the chunks and decode read the pools in place: no gather
            if per_run[name]["page_gather"] != 0:
                raise AssertionError(f"{name}: page_gather launched "
                                     f"{per_run[name]}, want 0")
            if min(per_run[name][k] for k in CHUNKED_KERNELS) <= 0:
                raise AssertionError(f"{name}: a kernel never launched")
    launches = dict(ops.launches)        # ... and ends here
    print(f"chunked path: launches {launches}; plain version calls "
          f"{plain_calls}", flush=True)
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran: {plain_calls}")
    for name, rep in reps.items():
        for r in reqs:
            toks = rep.outputs[r.rid]
            if len(toks) != r.gen_len or not all(0 <= t < V for t in toks):
                raise AssertionError(f"{name} request {r.rid}: bad output "
                                     f"{toks}")
    for name in ("prefix", "sampled"):
        if not reps[name].prefix_hit_rate > 0.3:
            raise AssertionError(f"{name}: prefix hit rate "
                                 f"{reps[name].prefix_hit_rate}")
    if not reps["prefix"].prefill_chunks < reps["chunked"].prefill_chunks:
        raise AssertionError("the prefix cache saved no chunk")
    if reps["sampled"].outputs == reps["prefix"].outputs:
        raise AssertionError("sampled tokens equal the greedy ones")
    static = ServeEngine(cfg, params, ServeConfig(
        continuous=False, clock="steps", **common)).run(reqs)
    share = {name: sum(reps[name].outputs[r.rid] == static.outputs[r.rid]
                       for r in reqs) / len(reqs)
             for name in ("chunked", "prefix")}
    print("greedy requests equal to the static whole-prompt run (bf16, "
          "not gated):", json.dumps(share), flush=True)
    first_token_logits(torch, cfg, params, reqs, common)

    wreqs = shared_prefix_requests(16, 50.0, V, n_prefixes=4,
                                   prefix_len=256, suffix_lens=(64, 192),
                                   gen_lens=(16, 32), seed=0)
    torch.cuda.reset_peak_memory_stats()
    rep = ServeEngine(cfg, params, ServeConfig(
        clock="wall", **runs["prefix"], **common)).run(wreqs)
    print("wall clock prefix-cached:", json.dumps(dict(
        tokens=rep.total_tokens, duration_s=rep.duration,
        tok_per_s=rep.tokens_per_sec, latency_p50_s=rep.latency_p50,
        latency_p99_s=rep.latency_p99, ttft_p50_s=rep.ttft_p50,
        ttft_p99_s=rep.ttft_p99, decode_steps=rep.decode_steps,
        prefill_chunks=rep.prefill_chunks,
        prefix_hit_rate=rep.prefix_hit_rate, utilization=rep.utilization,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)),
        flush=True)

    from torch.profiler import ProfilerActivity, profile
    preqs = [dataclasses.replace(r, arrival=0.0) for r in wreqs[:8]]
    eng = ServeEngine(cfg, params, ServeConfig(clock="steps", warmup=False,
                                               **runs["prefix"], **common))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = eng.run(preqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_profile(torch, prof, wall_ms, "chunked profile",
                   requests=len(preqs), decode_steps=rep.decode_steps,
                   prefill_chunks=rep.prefill_chunks,
                   prefix_hit_rate=rep.prefix_hit_rate,
                   tokens=rep.total_tokens)
    return launches


def first_token_logits(torch, cfg, params, reqs, common):
    """For the first request of each hot prefix (prefix + its suffix), the
    last logits of ``prefill_chunk`` over the engine's end-aligned chunk
    plan against the whole-prompt ``prefill``: max |d| / max |logit|."""
    from repro_torch.models.transformer import (init_chunk_carry, prefill,
                                                prefill_chunk)
    from repro_torch.serve import PageAllocator, init_paged_cache
    L, page = common["cache_len"], common["page_size"]
    seen, errs = set(), []
    for r in reqs:
        if r.prompt[:256] in seen:
            continue
        seen.add(r.prompt[:256])
        S = len(r.prompt)
        alloc = PageAllocator(cfg, 1, L, page)
        cache = init_paged_cache(cfg, 1, L, page, device="cuda")
        rows = {k: torch.from_numpy(v).cuda()
                for k, v in alloc.alloc(0).items()}
        carry = init_chunk_carry(cfg)
        for s0 in list(range(0, S - CHUNK, CHUNK)) + [S - CHUNK]:
            toks = torch.tensor([r.prompt[s0:s0 + CHUNK]], device="cuda")
            got, cache, carry = prefill_chunk(params, cache, toks, s0, rows,
                                              carry, cfg, L)
        want, _ = prefill(params, torch.tensor([r.prompt], device="cuda"),
                          cfg, cache_len=L)
        errs.append(((got.float() - want.float()).abs().max()
                     / want.float().abs().max()).item())
        del cache
    print("first-token logits, chunked vs whole prompt:", json.dumps(dict(
        prompts=len(errs), normalized_err=errs, tolerance=LOGITS_NORM_TOL)),
        flush=True)
    if len(errs) != 4 or not max(errs) <= LOGITS_NORM_TOL:
        raise AssertionError(f"first-token logits differ: {errs}")


KERNEL_GROUPS = (("flash_attention", "flash_fwd_kernel"),
                 ("flash_attention_bwd", "flash_bwd_"),
                 ("decode_attention", "decode_split_kernel"),
                 ("page_gather", "page_gather_kernel"),
                 ("ring_gather", "ring_gather_kernel"),
                 ("prefill_page_attention", "prefill_page_attention_kernel"),
                 ("moe_grouped_ffn_bwd", "moe_bwd_"),
                 ("moe_grouped_ffn", ("moe_dispatch_kernel",
                                      "moe_mma_kernel", "moe_gemm_kernel",
                                      "moe_combine_kernel",
                                      "moe_save_y_kernel")),
                 ("rwkv6_scan", ("rwkv6_fwd_sum_kernel", "rwkv6_fwd_kernel")),
                 ("rwkv6_scan_bwd", ("rwkv6_bwd_sum_kernel",
                                     "rwkv6_bwd_dv_kernel", "rwkv6_bwd_kernel",
                                     "rwkv6_du_kernel")),
                 ("rglru_scan", "rglru_fwd_kernel"),
                 ("rglru_scan_bwd", "rglru_bwd_kernel"),
                 ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "splitK")))


def device_profile(torch, prof, wall_ms: float, label: str, **extra):
    """Print device time by kernel group and the device's idle share of
    the host's wall time, then the top kernels and host operators."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for e in kernels:
        for name, keys in KERNEL_GROUPS:
            if any(k in e.key for k in (keys if isinstance(keys, tuple)
                                        else (keys,))):
                groups[name] += dev_us(e) / 1e3
                break
        else:
            if "rwkv6_" in e.key or "rglru_" in e.key:
                # every recurrence kernel belongs to its group
                raise AssertionError(f"{label}: {e.key} in no kernel group")
            groups["other"] += dev_us(e) / 1e3
    print(f"{label}:", json.dumps(dict(
        **extra, wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=1 - busy_ms / wall_ms if wall_ms else None,
        device_ms_by_group=groups)), flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        print(f"{label} kernel: {dev_us(e) / 1e3:9.3f} ms x{e.count:6d} "
              f"{e.key[:90]}", flush=True)
    # the host side, where a device idle most of the time waits: operators
    # and runtime calls by their own CPU time (profiler overhead included)
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:12]:
        print(f"{label} host: {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"x{e.count:6d} {e.key[:90]}", flush=True)


def where_time_goes(torch, cfg, params, common, label="profile"):
    """torch.profiler over one continuous run of 8 requests arriving
    together (8 whole-prompt prefills, then decode to the end): device
    time by kernel group and the device's idle share of the host's wall
    time (profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import (ServeConfig, ServeEngine,
                                   open_loop_requests)
    reqs = [dataclasses.replace(r, arrival=0.0) for r in open_loop_requests(
        8, 1.0, cfg.vocab_size, prompt_lens=(128, 300, 512),
        gen_lens=(16, 32), seed=2)]
    scfg = ServeConfig(continuous=True, clock="steps", warmup=False,
                       **common)
    # host clock per decode step: every step ends in a device sync (the
    # greedy tokens' host copy), and all 8 requests are admitted before
    # the first step, so the gaps between step hooks are pure decode steps
    stamps = []
    t0 = time.perf_counter()
    ServeEngine(cfg, params, scfg).run(
        reqs, step_hook=lambda _: stamps.append(time.perf_counter()))
    gaps = sorted(b - a for a, b in zip(stamps, stamps[1:]))
    step_ms = gaps[len(gaps) // 2] * 1e3
    print(f"{label} host clock:", json.dumps(dict(
        decode_step_p50_ms=step_ms,
        prefill_mean_ms=((stamps[0] - t0) * 1e3 - step_ms) / len(reqs),
        prompt_lens=[len(r.prompt) for r in reqs])), flush=True)

    eng = ServeEngine(cfg, params, scfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = eng.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_profile(torch, prof, wall_ms, label, requests=len(reqs),
                   decode_steps=rep.decode_steps, tokens=rep.total_tokens)


# ---------------------------------------------------------------------------
# phase 4c: recurrent serving
# ---------------------------------------------------------------------------

def small_recurrent(torch):
    """recurrentgemma-2b's smoke config in f32 through the serving engine
    on the card (CUDA kernels: the stateful RG-LRU forward, flash, decode
    and chunked-prefill attention) against the CPU (plain versions), same
    params and requests: greedy tokens equal whole-prompt, chunked (chunk
    8: non-overlapping chunks and a teacher-forced tail), prefix-cached
    (which adopts nothing: hit rate 0), static and sampled; and on the
    card whole == chunked == prefix-cached == static."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    from repro_torch.serve import ServeConfig, ServeEngine, open_loop_requests
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                              dtype=torch.float32)
    params = paramlib.init_tree(model_specs(cfg),
                                torch.Generator().manual_seed(1))
    reqs = open_loop_requests(8, 1.0, cfg.vocab_size, prompt_lens=(6, 13, 20),
                              gen_lens=(4, 9), seed=1)
    base = dict(batch_size=3, page_size=8, cache_len=32, clock="steps")
    runs = {"whole": {}, "chunked": dict(prefill_chunk=8),
            "prefix": dict(prefix_cache=True),
            "static": dict(continuous=False),
            "sampled": dict(temperature=0.8, top_p=0.9, sample_seed=7)}
    reps = {(name, dev): ServeEngine(cfg, _to(params, dev), ServeConfig(
        **kw, **base)).run(reqs) for dev in ("cpu", "cuda")
        for name, kw in runs.items()}
    out = {k: r.outputs for k, r in reps.items()}
    checks = {
        "cuda_eq_cpu": all(out[n, "cuda"] == out[n, "cpu"] for n in runs),
        "whole_eq_chunked_eq_prefix_eq_static": out["whole", "cuda"]
        == out["chunked", "cuda"] == out["prefix", "cuda"]
        == out["static", "cuda"],
        "sampled_ne_greedy": out["sampled", "cuda"] != out["whole", "cuda"],
        "prefix_hit_rate_0": reps["prefix", "cuda"].prefix_hit_rate == 0.0,
        "chunks_ran": reps["chunked", "cuda"].prefill_chunks > 0}
    print("small f32 recurrentgemma serving, CUDA vs CPU:", json.dumps(dict(
        **checks, prefill_chunks={n: reps[n, "cuda"].prefill_chunks
                                  for n in runs})), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"small recurrentgemma serving: {checks}")


def _rg_expected(cfg, rep, n_prefills: int, n_chunks: int) -> dict:
    """Exact launches of a recurrentgemma serving run: each local layer one
    flash forward a whole-prompt prefill, one chunked-prefill attention a
    chunk, one decode attention a decode step; each rglru layer one RG-LRU
    forward a prefill, a chunk and a decode step; the warmup's prefills,
    chunk and decode step included."""
    n_local = cfg.layer_kinds.count("local")
    n_lru = cfg.layer_kinds.count("rglru")
    steps = rep.decode_steps + 1              # + the warmup's decode step
    return {"flash_attention": n_local * n_prefills,
            "prefill_page_attention": n_local * n_chunks,
            "decode_attention": n_local * steps,
            "rglru_scan": n_lru * (n_prefills + n_chunks + steps),
            "page_gather": 0}


# recurrentgemma serving's depth cut (every width kept): 4 of the 8
# (rglru, rglru, local) groups and the tail, 14 of 26 layers, so that the
# whole script, phase 13 included, stays well inside its time limit (PR 29
# call 5: 907 s at full depth on a slow host); the kernels and shapes a
# layer runs are those of every layer
RG_SERVE_GROUPS = 4


def recurrent_serving(torch, ops, ref):
    """recurrentgemma-2b at full width, depth cut to ``RG_SERVE_GROUPS`` of
    its 8 (rglru, rglru, local) groups and the (rglru, rglru) tail, in bf16,
    random weights from seed 0 built leaf by leaf, batch 8, page 16, cache
    544, on llama3.2-1b's whole-prompt draw (16 requests, prompts 128 / 300
    / 512, generations 16 / 32): continuous and static whole-prompt runs
    and a chunked (128) run on the steps clock, each with launch counts
    reset just before it and read just after, exact for every kernel of
    the path, no plain version; continuous == static; the chunk plan's
    first-token logits against the whole prompt's; a wall-clock run and a
    profile."""
    from repro_torch.configs import get_config
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs, prefill
    from repro_torch.serve import (ServeConfig, ServeEngine,
                                   open_loop_requests, serving_leaf)
    full = get_config("recurrentgemma-2b")
    first, *rest = full.groups
    cfg = dataclasses.replace(full, groups=(
        dataclasses.replace(first, n=RG_SERVE_GROUPS), *rest))
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = paramlib.init_tree(
        model_specs(cfg), torch.Generator(device="cuda").manual_seed(0),
        dtype=cfg.param_dtype,
        leaf_fn=lambda k, t, spec: serving_leaf(k, t, cfg, spec))
    torch.cuda.synchronize()
    print(f"recurrentgemma-2b, {len(cfg.layer_kinds)} layers: "
          f"{paramlib.param_count(model_specs(cfg))} params (bf16 serving "
          f"copy, RG-LRU gates and norms f32) in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
          flush=True)
    V = cfg.vocab_size
    common = dict(batch_size=8, page_size=16, cache_len=MAIN_L)
    reqs = open_loop_requests(16, 0.5, V, prompt_lens=(128, 300, 512),
                              gen_lens=(16, 32), seed=0)
    n_prefills = len(reqs) + len({len(r.prompt) for r in reqs})  # + warmup
    runs = {"continuous": (dict(continuous=True), n_prefills, 0),
            "static": (dict(continuous=False), n_prefills, 0),
            "chunked": (dict(prefill_chunk=CHUNK), 0, None)}
    reports, launches = {}, {}
    for name, (kw, n_pre, n_chunks) in runs.items():
        eng = ServeEngine(cfg, params, ServeConfig(clock="steps", **kw,
                                                   **common))
        ops.reset_launches()                 # the path starts here
        t1 = time.perf_counter()
        with plain_versions_counted(ref) as plain_calls:
            rep = eng.run(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        launches[name] = dict(ops.launches)  # ... and ends here
        reports[name] = rep
        if n_chunks is None:                 # + the warmup's chunk
            n_chunks = rep.prefill_chunks + 1
        want = _rg_expected(cfg, rep, n_pre, n_chunks)
        print(f"recurrentgemma {name} (steps clock): {rep.total_tokens} "
              f"tokens, {rep.decode_steps} decode steps, "
              f"{rep.prefill_chunks} prefill chunks, prefix hit rate "
              f"{rep.prefix_hit_rate}, {dt:.2f} s host time; launches "
              f"{launches[name]}; expected {want}; plain version calls "
              f"{plain_calls}", flush=True)
        if any(launches[name][k] != v for k, v in want.items()):
            raise AssertionError(f"{name}: launches {launches[name]}, "
                                 f"want {want}")
        if any(plain_calls.values()):
            raise AssertionError(f"{name}: plain versions ran: "
                                 f"{plain_calls}")
        for r in reqs:
            toks = rep.outputs[r.rid]
            if len(toks) != r.gen_len or not all(0 <= t < V for t in toks):
                raise AssertionError(f"{name} request {r.rid}: bad output "
                                     f"{toks}")
    if reports["continuous"].outputs != reports["static"].outputs:
        raise AssertionError("recurrentgemma: continuous and static greedy "
                             "tokens differ")
    share = sum(reports["chunked"].outputs[r.rid]
                == reports["continuous"].outputs[r.rid]
                for r in reqs) / len(reqs)
    print("recurrentgemma continuous == static greedy tokens: True; chunked "
          f"requests equal to whole-prompt (bf16, not gated): {share}",
          flush=True)
    chunk_plan_logits(torch, cfg, params, reqs, common)

    wreqs = open_loop_requests(16, 50.0, V, prompt_lens=(128, 300, 512),
                               gen_lens=(16, 32), seed=0)
    rep = ServeEngine(cfg, params, ServeConfig(
        continuous=True, clock="wall", **common)).run(wreqs)
    print("recurrentgemma wall clock continuous:", json.dumps(dict(
        tokens=rep.total_tokens, duration_s=rep.duration,
        tok_per_s=rep.tokens_per_sec, latency_p50_s=rep.latency_p50,
        latency_p99_s=rep.latency_p99, ttft_p50_s=rep.ttft_p50,
        ttft_p99_s=rep.ttft_p99, decode_steps=rep.decode_steps,
        utilization=rep.utilization,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)),
        flush=True)
    where_time_goes(torch, cfg, params, common,
                    label="recurrentgemma profile")
    del params
    torch.cuda.empty_cache()
    return {"recurrentgemma_serving": launches["continuous"],
            "recurrentgemma_chunked": launches["chunked"]}


def chunk_plan_logits(torch, cfg, params, reqs, common):
    """For one prompt of each length, the first-token logits of the
    engine's chunk plan for a recurrent model (non-overlapping 128-token
    chunks with the carry, activation, then the remainder teacher-forced
    through ``decode_step`` one token at a time) against the whole-prompt
    ``prefill``'s: max |d| / max |logit|."""
    from repro_torch.models.transformer import (decode_step,
                                                init_chunk_carry, prefill,
                                                prefill_chunk)
    from repro_torch.serve import (PageAllocator, init_paged_cache,
                                   make_activate_fn)
    L, page = common["cache_len"], common["page_size"]
    errs = {}
    for r in reqs:
        S = len(r.prompt)
        if S in errs:
            continue
        alloc = PageAllocator(cfg, 1, L, page)
        cache = init_paged_cache(cfg, 1, L, page, device="cuda")
        rows = {k: torch.from_numpy(v).cuda()
                for k, v in alloc.alloc(0).items()}
        carry = init_chunk_carry(cfg, device="cuda")
        for s0 in range(0, S - CHUNK + 1, CHUNK):
            toks = torch.tensor([r.prompt[s0:s0 + CHUNK]], device="cuda")
            got, cache, carry = prefill_chunk(params, cache, toks, s0, rows,
                                              carry, cfg, L)
        cache = make_activate_fn(cfg, L, page)(cache, 0, rows, carry)
        for p in range(S // CHUNK * CHUNK, S):      # the tail
            got, cache = decode_step(
                params, cache, torch.tensor([[r.prompt[p]]], device="cuda"),
                torch.tensor([p], device="cuda"), cfg)
            got = got[:, -1]
        want, _ = prefill(params, torch.tensor([r.prompt], device="cuda"),
                          cfg, cache_len=L)
        errs[S] = ((got.float() - want.float()).abs().max()
                   / want.float().abs().max()).item()
        del cache
    print("recurrentgemma first-token logits, chunk plan vs whole prompt:",
          json.dumps(dict(normalized_err=errs, tolerance=LOGITS_NORM_TOL)),
          flush=True)
    if len(errs) != 3 or not max(errs.values()) <= LOGITS_NORM_TOL:
        raise AssertionError(f"first-token logits differ: {errs}")


RWKV_SERVE_B = 4
RWKV_STATE_TOL = 1e-3           # final f32 states, chunks vs whole, relative


def _rel(a, b) -> float:
    """max |a - b| / max |b|."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def _rwkv_chunks_vs_whole(torch, cfg, params, prompt):
    """A prompt through ``prefill_chunk`` in chunks of ``CHUNK`` with the
    carry and through one whole ``prefill``: the first-token logits' max
    |d| / max |logit|, and each final state leaf's relative max error,
    layer by layer."""
    from repro_torch.models.transformer import (init_chunk_carry, prefill,
                                                prefill_chunk)
    from repro_torch.serve import init_paged_cache
    cache = init_paged_cache(cfg, 1, MAIN_L, 16, device="cuda")
    carry = init_chunk_carry(cfg, device="cuda")
    for s0 in range(0, prompt.shape[1], CHUNK):
        got, cache, carry = prefill_chunk(params, cache,
                                          prompt[:, s0:s0 + CHUNK], s0, {},
                                          carry, cfg, MAIN_L)
    want, dense = prefill(params, prompt, cfg, cache_len=MAIN_L)
    return _rel(got, want), {
        name: [_rel(a, b) for a, b in zip(carry["g0"]["s0"][name],
                                          dense["g0"]["s0"][name])]
        for name in ("S", "x_last", "cx_last")}


@contextlib.contextmanager
def held_to_plain(ops, name, plain):
    """While the block runs, hold every call of ``ops.<name>`` (a stateful
    recurrence, -> (y, final state)) against ``plain`` on the same inputs:
    yields the list of (y, state) relative max errors, one a call."""
    errs, saved = [], getattr(ops, name)

    def spy(*args):
        y, S = saved(*args)
        want_y, want_S = plain(*args)
        errs.append((_rel(y, want_y), _rel(S, want_S)))
        return y, S
    setattr(ops, name, spy)
    try:
        yield errs
    finally:
        setattr(ops, name, saved)


def rwkv6_serving(torch, ops, ref):
    """rwkv6-1.6b at full width and full depth (24 layers) through the
    model-level serving functions (its engine refuses an attention-free
    model, as the JAX reference's fails on it), random weights from seed 0
    built leaf by leaf.  In bf16 (the serving path; launch counts reset
    just before and read just after: one WKV forward a layer a prefill, a
    decode step and a chunk, no plain version): 4 prompts (128, 300, 512,
    512 tokens) prefilled and joined into rows of a batch-4 cache, 16
    greedy decode steps, then the last prompt in 4 chunks of 128 with the
    carry.  Gated in bf16: one more decode step, the chunks and the whole
    prefill with every layer's WKV call held against the plain version on
    the same inputs (y and the final state within 2e-2 relative), and the
    chunks' layer-0 states against the whole prefill's (2e-2 relative).
    The chunks' logits and the states of later layers are held to the
    whole prefill in f32, the same weights at f32 compute (logits within a
    normalized 2e-2, states within 1e-3 relative): in bf16 these random
    weights carry a one-ulp difference of a layer's output into every
    layer after it (the kernels against the plain versions on one whole
    prefill differ as much as the chunks do), so the bf16 differences past
    layer 0 are reported beside, not gated."""
    from repro_torch.configs import get_config
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import (decode_step, model_specs,
                                                prefill)
    from repro_torch.serve import init_paged_cache, make_join_fn, serving_leaf

    def weights(cfg):
        return paramlib.init_tree(
            model_specs(cfg), torch.Generator(device="cuda").manual_seed(0),
            dtype=cfg.param_dtype,
            leaf_fn=lambda k, t, spec: serving_leaf(k, t, cfg, spec))

    cfg = get_config("rwkv6-1.6b")
    t0 = time.perf_counter()
    params = weights(cfg)
    torch.cuda.synchronize()
    print(f"rwkv6-1.6b, {len(cfg.layer_kinds)} layers: "
          f"{paramlib.param_count(model_specs(cfg))} params in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    L, V = MAIN_L, cfg.vocab_size
    n_layers, steps = len(cfg.layer_kinds), 16
    g = torch.Generator().manual_seed(0)
    prompts = [tuple(torch.randint(0, V, (S,), generator=g).tolist())
               for S in (128, 300, 512, 512)]
    prompt = torch.tensor([prompts[3]], device="cuda")
    cache = init_paged_cache(cfg, RWKV_SERVE_B, L, 16, device="cuda")
    join = make_join_fn(cfg, L, 16)
    ops.reset_launches()                 # the path starts here
    with plain_versions_counted(ref) as plain_calls:
        tok = torch.empty((RWKV_SERVE_B, 1), dtype=torch.int64,
                          device="cuda")
        for b, p in enumerate(prompts):
            logits, dense = prefill(params, torch.tensor([p], device="cuda"),
                                    cfg, cache_len=L)
            cache = join(cache, dense, b, {})
            tok[b, 0] = torch.argmax(logits[0])
        pos = torch.tensor([len(p) for p in prompts], device="cuda")
        step_s = []
        for _ in range(steps):
            t1 = time.perf_counter()
            logits, cache = decode_step(params, cache, tok, pos, cfg)
            tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            pos = pos + 1
        bf16_logits, bf16_states = _rwkv_chunks_vs_whole(torch, cfg, params,
                                                         prompt)
    launches = dict(ops.launches)        # ... and ends here
    n_pre, n_chunks = len(prompts) + 1, prompt.shape[1] // CHUNK
    expected = {"rwkv6_scan": n_layers * (n_pre + steps + n_chunks)}
    finite = bool(torch.isfinite(logits).all()) and bool(
        torch.isfinite(cache["g0"]["s0"]["S"]).all())
    with held_to_plain(ops, "rwkv6_stateful", ref.rwkv6_stateful) as held:
        decode_step(params, cache, tok, pos, cfg)
        n_step = len(held)
        _rwkv_chunks_vs_whole(torch, cfg, params, prompt)
    held_max = dict(decode_step=[max(e) for e in zip(*held[:n_step])],
                    chunks_and_whole=[max(e) for e in zip(*held[n_step:])])
    layer0 = {k: v[0] for k, v in bf16_states.items()}
    with plain_route(ops):
        plain, _ = prefill(params, prompt, cfg, cache_len=L)
    kernel, _ = prefill(params, prompt, cfg, cache_len=L)
    bf16_plain = _rel(kernel, plain)
    del params, cache
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = weights(cfg32)
    norm, state_err = _rwkv_chunks_vs_whole(torch, cfg32, params, prompt)
    state_err = {k: max(v) for k, v in state_err.items()}
    del params
    torch.cuda.empty_cache()
    step_p50 = sorted(step_s)[len(step_s) // 2]
    print("rwkv6 model-level serving:", json.dumps(dict(
        arch=cfg.name, layers=n_layers, batch=RWKV_SERVE_B,
        prompt_lens=[len(p) for p in prompts], decode_steps=steps,
        decode_step_p50_ms=step_p50 * 1e3, chunks=n_chunks, chunk=CHUNK,
        bfloat16_wkv_vs_plain_y_state=held_max,
        bfloat16_wkv_calls_held=len(held),
        bfloat16_layer0_chunks_vs_whole_states=layer0,
        bfloat16_tolerance=BF16_TOL,
        float32_first_token_logits_normalized_err=norm,
        logits_tolerance=LOGITS_NORM_TOL,
        float32_final_state_relative_err=state_err,
        state_tolerance=RWKV_STATE_TOL,
        bfloat16_not_gated=dict(
            chunks_vs_whole_logits=bf16_logits,
            chunks_vs_whole_states={k: max(v)
                                    for k, v in bf16_states.items()},
            kernels_vs_plain_whole_logits=bf16_plain),
        finite=finite, launches=launches, expected_launches=expected,
        plain_version_calls=plain_calls)), flush=True)
    if any(launches[k] != v for k, v in expected.items()) or \
            sum(launches.values()) != expected["rwkv6_scan"]:
        raise AssertionError(f"rwkv6 serving launches {launches}, want "
                             f"{expected}")
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran: {plain_calls}")
    if len(held) != n_layers * (2 + n_chunks) or not max(
            max(e) for e in held) <= BF16_TOL:
        raise AssertionError(f"rwkv6 bf16 WKV calls vs plain: {held_max} "
                             f"over {len(held)} calls")
    if not max(layer0.values()) <= BF16_TOL:
        raise AssertionError(f"rwkv6 bf16 layer-0 states, chunks vs whole: "
                             f"{layer0}")
    if not (finite and norm <= LOGITS_NORM_TOL
            and max(state_err.values()) <= RWKV_STATE_TOL):
        raise AssertionError(f"rwkv6 chunks vs whole (f32): logits {norm}, "
                             f"states {state_err}, finite {finite}")
    return launches


# ---------------------------------------------------------------------------
# phases 5 and 6: training
# ---------------------------------------------------------------------------

PLAIN_VERSIONS = ("attention", "attention_chunked", "attention_decode",
                  "page_gather", "ring_gather", "prefill_page_attention",
                  "moe_grouped_ffn", "rwkv6", "rwkv6_stateful", "rglru")


@contextlib.contextmanager
def plain_versions_counted(ref):
    """Count calls of the plain versions in ``kernels/ref.py`` while the
    block runs (the dispatch looks them up at each call)."""
    calls = dict.fromkeys(PLAIN_VERSIONS, 0)
    saved = {name: getattr(ref, name) for name in PLAIN_VERSIONS}

    def counted(name):
        def fn(*a, **kw):
            calls[name] += 1
            return saved[name](*a, **kw)
        return fn
    for name in PLAIN_VERSIONS:
        setattr(ref, name, counted(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ref, name, fn)


def _train_run(torch, cfg, params, opt_name, sync, batches, lr):
    from repro_torch.launch.steps import make_train_engine
    from repro_torch.optim import OptConfig, make_optimizer
    opt = make_optimizer(OptConfig(name=opt_name, lr=lr))
    eng = make_train_engine(cfg, opt, sync, params)
    state = eng.init_state()
    losses = []
    for b in batches:
        state, m = eng.step(state, b)
        losses.append(m["loss"])
    p = state["params"] if sync.delta == 0 else state.params
    return torch.stack(losses), p


def small_train_config(torch, arch: str):
    """The narrow f32 model of the small training run: llama3.2-1b's smoke
    config widened to d 256 and head dim 64; rwkv6-1.6b's,
    recurrentgemma-2b's and mixtral-8x7b's smoke configs as they are (d
    64, 4 heads of 16; recurrentgemma's and mixtral's windows of 16 wrap
    at the run's 96 tokens; mixtral's 4 experts, top-2, route 3 groups of
    64 tokens a step, capacity 40)."""
    from repro_torch.configs import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    if arch == "llama3.2-1b":
        cfg = dataclasses.replace(cfg, d_model=256, n_heads=8, n_kv_heads=2,
                                  head_dim=64, d_ff=512)
    return cfg


def small_training(torch, arch):
    """The training path on a narrow f32 model: CUDA kernels on the card vs
    plain versions on the CPU, then the engine's bit-identities on the
    card under deterministic algorithms."""
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import LMBatchSpec, make_lm_batch
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    from repro_torch.pdb import make_delayed_step, init_delayed_state
    from repro_torch.launch.steps import make_lm_grad_fn
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.tree import leaves_with_path
    cfg = small_train_config(torch, arch)
    params = paramlib.init_tree(model_specs(cfg),
                                torch.Generator().manual_seed(1))
    spec = LMBatchSpec(batch=2, seq_len=96, vocab_size=cfg.vocab_size,
                       seed=1)
    sync = SyncConfig(delta=2, remat="none", packed_ring=True)
    res = {}
    for opt_name in ("sgd", "adamw"):
        for dev in ("cpu", "cuda"):
            batches = [make_lm_batch(spec, t, dev) for t in range(4)]
            res[opt_name, dev] = _train_run(torch, cfg, _to(params, dev),
                                            opt_name, sync, batches, 0.05)
    loss_err = max((res[o, "cpu"][0] - res[o, "cuda"][0].cpu()).abs().max()
                   .item() / res[o, "cpu"][0].abs().max().item()
                   for o in ("sgd", "adamw"))
    param_err = max((a - b.cpu()).abs().max().item() for (_, a), (_, b) in zip(
        leaves_with_path(res["sgd", "cpu"][1]),
        leaves_with_path(res["sgd", "cuda"][1])))
    print("small f32 training, delta 2 packed, 4 steps:", json.dumps(dict(
        arch=arch, loss_rel_err_cuda_vs_cpu=loss_err,
        sgd_param_max_abs_err_cuda_vs_cpu=param_err,
        losses_cuda={o: res[o, "cuda"][0].tolist() for o in ("sgd", "adamw")},
        tolerance=TRAIN_TOL)), flush=True)
    if not (loss_err <= TRAIN_TOL and param_err <= TRAIN_TOL):
        raise AssertionError("small training run: CUDA and CPU differ")

    # bit-identities on the card, deterministic algorithms
    torch.use_deterministic_algorithms(True)
    try:
        p = _to(params, "cuda")
        batches = [make_lm_batch(spec, t, "cuda") for t in range(3)]
        grad_fn = make_lm_grad_fn(cfg, sync)
        opt = make_optimizer(OptConfig(name="adamw", lr=0.05))
        sync_p, sync_s = p, opt.init(p)
        for b in batches:
            _, g = grad_fn(sync_p, b)
            sync_p, sync_s = opt.update(g, sync_s, sync_p)
        step = make_delayed_step(grad_fn, opt.update, 0, packed=True)
        st = init_delayed_state(p, opt.init, 0, packed=True)
        for b in batches:
            st, _ = step(st, b)
        same0 = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            leaves_with_path(sync_p), leaves_with_path(st.params)))
        finals = {}
        for packed in (True, False):
            step = make_delayed_step(grad_fn, opt.update, 2, packed=packed)
            st = init_delayed_state(p, opt.init, 2, packed=packed)
            losses = []
            for b in batches:
                st, m = step(st, b)
                losses.append(m["loss"])
            finals[packed] = (torch.stack(losses), st.params)
        same_layout = torch.equal(finals[True][0], finals[False][0]) and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                leaves_with_path(finals[True][1]),
                leaves_with_path(finals[False][1])))
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"deterministic, on the card ({arch}): delta=0 == sync bit for "
          f"bit: {same0}; packed == tree at delta 2 bit for bit: "
          f"{same_layout}", flush=True)
    if not (same0 and same_layout):
        raise AssertionError("a bit-identity of the engine failed")


TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_DELTA = 4, 512, 8, 2
# per trained arch: the kernels a layer of each kind launches once per step
# (forward and backward), and per slot of the first group the projections
# of its layer 0 that must get a gradient
FLASH = ("flash_attention", "flash_attention_bwd")
MOE = ("moe_grouped_ffn", "moe_grouped_ffn_bwd")
TRAIN_RUNS = {
    "llama3.2-1b": ({"attn": FLASH}, {"s0": ("mix.wq", "mix.wk", "mix.wv")}),
    "rwkv6-1.6b": ({"rwkv6": ("rwkv6_scan", "rwkv6_scan_bwd")},
                   {"s0": ("mix.wr", "mix.wk", "mix.wv", "mix.decay_w1",
                           "mix.bonus_u")}),
    "recurrentgemma-2b": ({"rglru": ("rglru_scan", "rglru_scan_bwd"),
                           "local": FLASH},
                          {"s0": ("mix.wx", "mix.wa", "mix.wi", "mix.lam",
                                  "mix.conv_w"),
                           "s2": ("mix.wq", "mix.wk", "mix.wv")}),
    "mixtral-8x7b": ({"swa": FLASH + MOE},
                     {"s0": ("mix.wq", "mix.wk", "mix.wv", "ffn.router",
                             "ffn.wg", "ffn.wu", "ffn.wd")}),
}
# depth cuts, every width kept: recurrentgemma-2b's 26 layers (2,894,574,080
# parameters) need 69.5 GB of engine state at delta 2 (12 + 4 (delta + 1)
# bytes a parameter) plus 11.6 GB of f32 gradients, over the card's 80 GB.
# AdamW's update is out of place, so the step also holds a second copy of
# the parameters and moments (12 bytes a parameter) and the stale read:
# 4 of the 8 (rglru, rglru, local) groups and the (rglru, rglru) tail (14
# layers, 1,866,744,320 parameters) run out of memory in that update; 3
# groups and the tail are 11 layers, 1,609,786,880 parameters, 38.6 GB of
# state.  mixtral-8x7b: one layer (1,713,418,240 parameters) is ~70 GiB
# at the update's peak (44 bytes a parameter, as recurrentgemma-2b's 11
# layers measured), two (3.16 B) would need ~130 GiB
TRAIN_GROUPS = {"recurrentgemma-2b": 3, "mixtral-8x7b": 1}


def train_config(arch: str):
    """``arch``'s published config, its first group cut to
    ``TRAIN_GROUPS`` repeats where the card's memory forces a cut; and the
    ``reduced`` note for the printed result (None when nothing is cut)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch not in TRAIN_GROUPS:
        return cfg, None
    n = TRAIN_GROUPS[arch]
    full = len(cfg.layer_kinds)
    first, *rest = cfg.groups
    cut = dataclasses.replace(
        cfg, groups=(dataclasses.replace(first, n=n), *rest))
    return cut, (f"layers {full} -> {len(cut.layer_kinds)}: {n} of the "
                 f"{first.n} {first.pattern} groups and the groups after "
                 f"them; every width kept (the engine's delta-{TRAIN_DELTA} "
                 f"state and AdamW's update for all {full} layers exceed "
                 "the card's memory)")


def full_width_training(torch, ops, ref, arch):
    """``arch`` at full width through the train engine, at full depth or
    at its ``TRAIN_GROUPS`` cut: f32 master, bf16 compute, AdamW, delta 2
    on the packed ring."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import LMBatchSpec, make_lm_batch
    from repro_torch.kernels.adamw import counts as adamw_counts
    from repro_torch.launch.steps import make_lm_grad_fn
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.pdb import make_engine
    from repro_torch.tree import leaves
    cfg, reduced = train_config(arch)
    kind_kernels, watched = TRAIN_RUNS[arch]
    torch.cuda.empty_cache()            # the phase needs the whole card
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = paramlib.init_tree(
        model_specs(cfg), torch.Generator(device="cuda").manual_seed(0),
        dtype=cfg.param_dtype)
    sync = SyncConfig(delta=TRAIN_DELTA, remat="none", packed_ring=True)
    spec = LMBatchSpec(batch=TRAIN_B, seq_len=TRAIN_S,
                       vocab_size=cfg.vocab_size, seed=0)
    metrics = []                        # lm_loss's metrics, per step
    inner = make_lm_grad_fn(cfg, sync, on_metrics=metrics.append)
    watched_max = []

    def grad_fn(p, batch):              # the engine's grad_fn, watched
        loss, grads = inner(p, batch)
        g0 = grads["groups"]["g0"]
        watched_max.append(torch.stack([
            g0[slot][w.split(".")[0]][w.split(".")[1]][0].abs().max()
            for slot, names in watched.items() for w in names]))
        return loss, grads

    opt = make_optimizer(OptConfig(name="adamw", lr=3e-4))
    eng = make_engine(params, grad_fn, opt, sync)
    state = eng.init_state()
    del params
    torch.cuda.synchronize()
    print(f"{cfg.name} training state ready in "
          f"{time.perf_counter() - t0:.2f} s: ring "
          f"{ {k: list(v.shape) for k, v in state.hist.items()} }, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
          flush=True)
    batches = [make_lm_batch(spec, t, "cuda") for t in range(TRAIN_STEPS + 2)]

    stats = eng.telemetry.stats
    losses, step_s, ramp = [], [], []
    ops.reset_launches()                 # the training path starts here
    adamw_counts.reset()
    with plain_versions_counted(ref) as plain_calls:
        for b in batches[:TRAIN_STEPS]:
            before = stats.sum_staleness
            t1 = time.perf_counter()
            state, m = eng.step(state, b)
            losses.append(float(m["loss"]))       # syncs with the device
            step_s.append(time.perf_counter() - t1)
            ramp.append((stats.sum_staleness - before)
                        / len(eng.group_delays))
    launches = dict(ops.launches)        # ... and ends here
    adamw_run = dict(launches=adamw_counts.launches,
                     elements=adamw_counts.elements)
    n_groups = len(state.hist)
    n_layers = len(cfg.layer_kinds)
    want = {"ring_gather": n_groups * TRAIN_STEPS}
    for kind, names in kind_kernels.items():
        for k in names:
            want[k] = want.get(k, 0) \
                + cfg.layer_kinds.count(kind) * TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    grad_min = dict(zip(
        [f"g0.{slot}.{w}" for slot, names in watched.items()
         for w in names],
        torch.stack(watched_max).amin(0).tolist()))
    tele = eng.telemetry.summary()
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    router = {k: [float(m[k]) for m in metrics[:TRAIN_STEPS]]
              for k in (("lb_loss", "router_entropy") if cfg.is_moe else ())}
    if cfg.is_moe and [float(m["total_loss"]) for m in
                       metrics[:TRAIN_STEPS]] != losses:
        raise AssertionError("the engine's loss is not lm_loss's total")
    print("full-width training:", json.dumps(dict(
        arch=cfg.name, layers=n_layers, reduced=reduced,
        parameters=sum(t.numel() for t in leaves(state.params)),
        adamw_kernel=adamw_run, batch=TRAIN_B, seq=TRAIN_S,
        delta=TRAIN_DELTA, optimizer="adamw", steps=TRAIN_STEPS,
        losses=losses, step_s=step_s, step_s_p50_after_first=steady,
        tokens_per_s=TRAIN_B * TRAIN_S / steady, peak_mem_gib=peak,
        staleness_per_step=ramp, telemetry=tele, launches=launches,
        expected_launches=want, plain_version_calls=plain_calls,
        min_layer0_grad_max_abs=grad_min, router_metrics_per_step=router)),
        flush=True)
    if not all(map(lambda x: x == x and abs(x) < float("inf"),
                   losses + sum(router.values(), []))):
        raise AssertionError(f"non-finite training losses {losses} or "
                             f"router metrics {router}")
    if ramp != [min(i, TRAIN_DELTA) for i in range(TRAIN_STEPS)] or \
            tele["max_staleness"] != TRAIN_DELTA:
        raise AssertionError(f"staleness ramp {ramp}, telemetry {tele}")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"launches {launches}, expected {want}")
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran: {plain_calls}")
    adamw_want = dict(
        launches=len(leaves(state.params)) * TRAIN_STEPS,
        elements=sum(t.numel() for t in leaves(state.params)) * TRAIN_STEPS)
    if adamw_run != adamw_want:
        raise AssertionError(f"AdamW kernel {adamw_run}, expected "
                             f"{adamw_want}: a leaf took another route")
    if not min(grad_min.values()) > 0:
        raise AssertionError(f"a watched parameter got no gradient: "
                             f"{grad_min}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for b in batches[TRAIN_STEPS:]:
            state, m = eng.step(state, b)
            float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    device_profile(torch, prof, wall_ms, f"train profile {cfg.name}",
                   steps=2, tokens=2 * TRAIN_B * TRAIN_S)
    del state, eng, batches
    torch.cuda.empty_cache()
    return launches, losses


# ---------------------------------------------------------------------------
# phase 9: the paper's Sec-6 threaded regression
# ---------------------------------------------------------------------------

PAPER_WORKERS = 4               # the synthetic set's thread count
REAL_WORKERS = (4, 8)
REAL_GD_ITERS = 20              # GD at the real shape: iterations cut
PAPER_DELTA = 2                 # the relaxed GD run: dc at this delay ...
PAPER_LOSS_RATIO = 1.5          # ... within this factor of sequential's,
PAPER_PROGRESS = 0.1            # and within this share of GD's descent
PAPER_CPU_TOL = 1e-10           # card vs CPU sequential theta, relative
PAPER_TIMEOUT = 120.0           # a blocked store op, a thread's join
PAPER_PEAK_ABOVE_X = 1.1        # the runs' peak over X's bytes: no copy


def _wall(torch, fn):
    """(result, seconds) of ``fn()`` on the host clock, ending in a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _seq_runs(torch, T, H, task, workers, policies, record=True):
    """Sequential and threaded runs of one task: walls, and the gates that
    every threaded run at delta 0 is bit-identical to sequential with a
    complete, sequentially-correct history."""
    seq, seq_s = _wall(torch, lambda: T.run_sequential(task, workers))
    walls = {"sequential": seq_s}
    for policy in policies:
        st = T.run_parallel(task, workers, policy=policy,
                            record_history=record, timeout=PAPER_TIMEOUT)
        walls[policy] = st.wall_time
        if not torch.equal(st.theta, seq):
            raise AssertionError(
                f"{policy} at delta 0 ({task.mode}, {workers} workers): "
                "theta differs from sequential")
        if record and not (H.is_complete(st.history, workers, task.n_iters)
                           and H.is_sequentially_correct(st.history,
                                                         workers)):
            raise AssertionError(f"{policy} ({task.mode}): history not "
                                 "complete and sequentially correct")
    return seq, walls


def paper_regression(torch):
    """The paper's Sec-6 threaded regression on the card in f64: the
    synthetic set (960 x 5,000) at 4 workers, then the real dataset's
    shape (150,360 x 16,087, the sparse proxy densified on the card) at 4
    and 8 workers, under deterministic algorithms."""
    from repro_torch.configs import paper_lr
    from repro_torch.core import history as H
    from repro_torch.core import threaded as T
    from repro_torch.data.synthetic import (regression_dataset,
                                            sparse_regression_dataset)
    from repro_torch.pdb import (InProcessParameterDB, make_policy,
                                 run_interleaved, ssp_clock_bound_violations)
    out = {}
    syn = paper_lr.synthetic()
    X, y = regression_dataset(syn.n_examples, syn.n_features, seed=syn.seed,
                              device="cuda")
    Xc, yc = regression_dataset(syn.n_examples, syn.n_features,
                                seed=syn.seed, device="cpu")
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("gd", "sgd", "minibatch"):
            kw = dict(lr=syn.lr, n_iters=syn.n_iters, mode=mode,
                      batch_size=syn.batch_size, seed=syn.seed)
            task = T.LRTask(X, y, **kw)
            seq, walls = _seq_runs(torch, T, H, task, PAPER_WORKERS,
                                   ("dc", "dc-array", "bsp"))
            slices = T.chunk_slices(syn.n_features, PAPER_WORKERS)
            schedule = task.sample_schedule()
            for seed in range(3):
                db = InProcessParameterDB(
                    [torch.zeros(sl.stop - sl.start, dtype=torch.float64,
                                 device="cuda") for sl in slices],
                    PAPER_WORKERS, policy=make_policy("dc", PAPER_WORKERS),
                    record=True)
                theta = run_interleaved(
                    db, syn.n_iters, lambda i, s, a: T.chunk_update(
                        task, s, slices[i], a, schedule), seed=seed)
                if not (torch.equal(theta, seq) and
                        H.is_sequentially_correct(db.history,
                                                  PAPER_WORKERS)):
                    raise AssertionError(f"run_interleaved seed {seed} "
                                         f"({mode}) differs from sequential")
            cpu = T.run_sequential(T.LRTask(Xc, yc, **kw), PAPER_WORKERS)
            rel = ((seq.cpu() - cpu).abs().max()
                   / cpu.abs().max()).item()
            if not rel <= PAPER_CPU_TOL:
                raise AssertionError(f"card vs CPU sequential ({mode}): "
                                     f"{rel}")
            out[f"synthetic_{mode}"] = dict(
                wall_s=walls, loss=T.loss(task, seq),
                card_vs_cpu_rel=rel)
        task = T.LRTask(X, y, lr=syn.lr, n_iters=syn.n_iters, mode="gd")
        ssp = T.run_parallel(task, PAPER_WORKERS, policy="ssp",
                             delta=PAPER_DELTA, record_history=True,
                             timeout=PAPER_TIMEOUT)
        bad = ssp_clock_bound_violations(ssp.history, PAPER_WORKERS,
                                         PAPER_DELTA)
        if bad or not H.is_complete(ssp.history, PAPER_WORKERS,
                                    syn.n_iters):
            raise AssertionError(f"SSP clock bound violated: {bad[:4]}")
        out["synthetic_ssp"] = dict(wall_s=ssp.wall_time,
                                    staleness=ssp.staleness)
    finally:
        torch.use_deterministic_algorithms(False)
    print("paper regression, synthetic (960 x 5,000 f64, 4 workers, "
          f"{syn.n_iters} iterations): delta 0 bit-identical (dc, dc-array,"
          " bsp, run_interleaved seeds 0-2), histories sequentially "
          "correct, SSP bound held:", json.dumps(out), flush=True)
    del X, y, Xc, yc

    real = paper_lr.real_shape()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (X, y), build_s = _wall(torch, lambda: sparse_regression_dataset(
        real.n_examples, real.n_features, seed=real.seed, device="cuda"))
    build_peak = torch.cuda.max_memory_allocated() - base
    theta = torch.randn(real.n_features, dtype=torch.float64, device="cuda")
    mv_ms, _ = time_ms(lambda i: X @ theta, 10)
    # f64 operations (2 a matrix entry) take 0.14 ms at 34 TFLOP/s
    mv_bound = nbytes(X, theta, y) / PEAK_BYTES_PER_S * 1e3
    res = dict(shape=list(X.shape), x_gb=nbytes(X) / 1e9, build_s=build_s,
               build_peak_above_x=build_peak / nbytes(X), matvec_ms=mv_ms,
               matvec_bound_ms=mv_bound, matvec_bound_by="bytes")
    torch.cuda.reset_peak_memory_stats()
    torch.use_deterministic_algorithms(True)
    try:
        for mode, n_iters, policies in (("sgd", real.n_iters, ("dc", "bsp")),
                                        ("gd", REAL_GD_ITERS, ("dc", "bsp"))):
            task = T.LRTask(X, y, lr=real.lr, n_iters=n_iters, mode=mode,
                            seed=real.seed)
            for p in REAL_WORKERS:
                seq, walls = _seq_runs(torch, T, H, task, p, policies)
                res[f"{mode}_{p}"] = dict(iters=n_iters, wall_s=walls,
                                          loss=T.loss(task, seq))
        # delta 2 at 8 threads: GD gated; SGD reported (the config's lr
        # times a row's squared norm, ~451, is past 2: SGD diverges
        # sequentially too, and stale reads speed that up)
        p = REAL_WORKERS[-1]
        for mode, n_iters in (("gd", REAL_GD_ITERS), ("sgd", real.n_iters)):
            task = T.LRTask(X, y, lr=real.lr, n_iters=n_iters, mode=mode,
                            seed=real.seed)
            rel = T.run_parallel(task, p, policy="dc", delta=PAPER_DELTA,
                                 timeout=PAPER_TIMEOUT)
            res[f"{mode}_{p}_delta{PAPER_DELTA}"] = dict(
                wall_s=rel.wall_time, loss=T.loss(task, rel.theta),
                sequential_loss=res[f"{mode}_{p}"]["loss"],
                staleness=rel.staleness)
        res["loss_at_zero"] = T.loss(task, torch.zeros_like(theta))
    finally:
        torch.use_deterministic_algorithms(False)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # a copy of X's column slice (X[:, sl].T made contiguous) would add
    # 1 / workers of X per thread
    res["runs_peak_above_x"] = (torch.cuda.max_memory_allocated() - base) \
        / nbytes(X)
    print(f"paper regression, real shape ({real.n_features:,} x "
          f"{real.n_examples:,} f64 on the card; SGD {real.n_iters} and GD "
          f"{REAL_GD_ITERS} iterations; {smi()}):", json.dumps(res),
          flush=True)
    # GD at 20 iterations descends 224.19 -> 210.66 from theta = 0, well
    # inside the ratio window: the relaxed run must also descend as far,
    # give or take PAPER_PROGRESS of the descent, and have read stale
    gd = res[f"gd_{REAL_WORKERS[-1]}_delta{PAPER_DELTA}"]
    seq_loss, st = gd["sequential_loss"], gd["staleness"]
    if not (math.isfinite(gd["loss"]) and seq_loss / PAPER_LOSS_RATIO
            <= gd["loss"] <= seq_loss * PAPER_LOSS_RATIO
            and seq_loss < res["loss_at_zero"]
            and abs(gd["loss"] - seq_loss)
            <= PAPER_PROGRESS * (res["loss_at_zero"] - seq_loss)
            and st["stale_reads"] > 0
            and 0 <= st["max_staleness"] <= PAPER_DELTA):
        raise AssertionError(f"GD, dc at delta {PAPER_DELTA}: {gd}, "
                             f"loss at theta = 0 {res['loss_at_zero']}")
    if not res["runs_peak_above_x"] < PAPER_PEAK_ABOVE_X:
        raise AssertionError("the runs held more than X: a column slice "
                             "was copied")
    del theta
    return out | res, (X, y)       # the real shape's set, for phase 11


# ---------------------------------------------------------------------------
# phase 10: serve while training
# ---------------------------------------------------------------------------

SWT_EVERY = 3                   # one training step every 3 decode steps
SWT_GROUPS = (("groups", 4), ("embed", 1))
SWT_DELTA = 4


def serve_while_train(torch, ops, ref, static_outputs, static_launches):
    """llama3.2-1b at full width: the continuous serving run of phase 4,
    its weights read from a ``LiveParamDB`` into which the train engine
    (phase 6's: delta 2 packed ring, AdamW, batch 4 x 512) publishes one
    step every ``SWT_EVERY`` decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.core.history import is_sequentially_correct
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import LMBatchSpec, make_lm_batch
    from repro_torch.launch.steps import make_lm_grad_fn
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.pdb import make_engine
    from repro_torch.serve import (LiveParamDB, ServeConfig, ServeEngine,
                                   open_loop_requests)
    cfg = get_config("llama3.2-1b")
    torch.cuda.reset_peak_memory_stats()
    master = paramlib.init_tree(
        model_specs(cfg), torch.Generator(device="cuda").manual_seed(0),
        dtype=cfg.param_dtype)
    common = dict(batch_size=8, page_size=16, cache_len=MAIN_L)
    reqs = open_loop_requests(16, 0.5, cfg.vocab_size,
                              prompt_lens=(128, 300, 512), gen_lens=(16, 32),
                              seed=0)
    serve_sync = SyncConfig(delta=SWT_DELTA, group_delays=SWT_GROUPS)
    scfg = ServeConfig(continuous=True, clock="steps", **common)

    # a handle that never gets a publish serves phase 4's tokens
    rep = ServeEngine(cfg, LiveParamDB(master, serve_sync, cfg=cfg),
                      scfg).run(reqs)
    if rep.outputs != static_outputs:
        raise AssertionError("an unpublished LiveParamDB serves other "
                             "tokens than StaticParams")

    tsync = SyncConfig(delta=TRAIN_DELTA, remat="none", packed_ring=True)
    trainer = make_engine(master, make_lm_grad_fn(cfg, tsync),
                          make_optimizer(OptConfig(name="adamw", lr=3e-4)),
                          tsync)
    state = trainer.init_state()
    db = LiveParamDB(master, serve_sync, cfg=cfg)
    del master
    spec = LMBatchSpec(batch=TRAIN_B, seq_len=TRAIN_S,
                       vocab_size=cfg.vocab_size, seed=0)
    eng = ServeEngine(cfg, db, scfg)
    losses, train_s, publish_s, t_in, t_out = [], [], [], [], []

    def step_hook(step):
        nonlocal state
        t_in.append(time.perf_counter())
        if step % SWT_EVERY == 0:
            state, m = trainer.step(state, make_lm_batch(spec, len(losses),
                                                         "cuda"))
            losses.append(float(m["loss"]))        # syncs with the device
            t1 = time.perf_counter()
            train_s.append(t1 - t_in[-1])
            db.publish(state.params, len(losses))
            torch.cuda.synchronize()
            publish_s.append(time.perf_counter() - t1)
        t_out.append(time.perf_counter())

    ops.reset_launches()                 # the path starts here
    with plain_versions_counted(ref) as plain_calls:
        rep = eng.run(reqs, step_hook=step_hook)
    torch.cuda.synchronize()
    launches = dict(ops.launches)        # ... and ends here
    n = len(losses)
    want = dict(static_launches)
    for kind, names in TRAIN_RUNS["llama3.2-1b"][0].items():
        for k in names:
            want[k] += cfg.layer_kinds.count(kind) * n
    want["ring_gather"] += len(state.hist) * n
    decode_ms = sorted((a - b) * 1e3 for a, b in zip(t_in[1:], t_out))
    log = db.read_log
    tele = db.telemetry.summary()
    print("serve while train:", json.dumps(dict(
        arch=cfg.name, decode_steps=rep.decode_steps, publishes=db.version,
        train_steps=n, losses=losses,
        decode_step_ms_p50=decode_ms[len(decode_ms) // 2],
        train_step_s_p50=sorted(train_s)[n // 2],
        publish_s_p50=sorted(publish_s)[n // 2],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        reads=len(log), stale_reads=sum(r.staleness > 0 for r in log),
        staleness_by_delay={d: max(r.staleness for r in log if r.delay == d)
                            for d in sorted({r.delay for r in log})},
        telemetry=tele, launches=launches, expected_launches=want,
        plain_version_calls=plain_calls)), flush=True)
    for r in reqs:
        if len(rep.outputs[r.rid]) != r.gen_len:
            raise AssertionError(f"request {r.rid}: {rep.outputs[r.rid]}")
    if not all(map(math.isfinite, losses)) or n < 2:
        raise AssertionError(f"training losses {losses}")
    if not (log and all(0 <= r.staleness <= r.delay for r in log)
            and any(r.staleness > 0 for r in log)):
        raise AssertionError("a served read broke its group's delay, or "
                             "none was stale")
    if {r.delay for r in log} != {d for _, d in SWT_GROUPS}:
        raise AssertionError(f"delays seen: {sorted({r.delay for r in log})}")
    if not is_sequentially_correct(db.telemetry.history, db.n_chunks) or \
            tele["max_staleness"] > SWT_DELTA:
        raise AssertionError(f"history not sequentially correct, or "
                             f"staleness past {SWT_DELTA}: {tele}")
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran: {plain_calls}")
    del state, trainer, db, eng
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 11: the sharded parameter server
# ---------------------------------------------------------------------------

SERVER_SYN = (4, 2)             # the synthetic set: workers, shards
SERVER_REAL = (8, 4)            # the real shape: workers, shards
SERVER_KILL = (4, 1)            # the drill: iteration, shard
SERVER_CONTEXT_MIB = 64         # the card's free memory across start()
SERVER_DRILL_RETRIES = 30       # 53 s of backoff around the restart
SERVER_LOSS_REL = 1e-6          # worker 0's first loss vs phase 6's step 0
# llama3.2-1b through the server at full width: 1,235,814,400 f32 in 64
# chunks of 77.2 MB over 8 shards.  shard_of(c, 8) is c mod 8, so a shard
# owns 8 chunks and a read_batch response carries 617,907,200 bytes, under
# MAX_FRAME (1 GiB); the CLI's 2 shards x 4 chunks would send 2.47 GB
SERVER_LM = ["--arch", "llama3.2-1b", "--steps", "3", "--batch", "4",
             "--seq", "512", "--lr", "1e-3", "--backend", "server",
             "--shards", "8", "--workers", "2", "--param-chunks", "64",
             "--delta", "0", "--log-every", "1"]
# phase 5's narrow f32 model through the same path, on the card
SERVER_NARROW = ["--arch", "llama3.2-1b", "--smoke", "--steps", "3",
                 "--batch", "2", "--seq", "96", "--lr", "0.05", "--backend",
                 "server", "--shards", "2", "--workers", "2", "--log-every",
                 "100"]


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _delta0_gates(torch, H, res, seq, workers, n_iters, what):
    if not torch.equal(res.theta, seq.cpu()):
        raise AssertionError(f"{what}: theta differs from sequential")
    if not (H.is_complete(res.history, workers, n_iters)
            and H.is_sequentially_correct(res.history, workers)
            and res.staleness["max_staleness"] == 0):
        raise AssertionError(f"{what}: history not complete and "
                             f"sequentially correct: {res.staleness}")


def server_regression(torch, X, y):
    """The Sec-6 regression through shard processes (CPU storage), the
    workers on the card in f64 under deterministic algorithms: the
    synthetic set at 4 workers on 2 shards (GD; dc, dc-array, bsp at delta
    0 on both RPC paths, SSP, the kill-and-restart drill), then phase 9's
    real-shape ``X``, ``y`` at 8 workers on 4 shards (GD, 20 iterations:
    dc and bsp at delta 0, dc at delta 2 to phase 9's gates)."""
    import tempfile
    from repro_torch.configs import paper_lr
    from repro_torch.core import history as H
    from repro_torch.core import threaded as T
    from repro_torch.data.synthetic import regression_dataset
    from repro_torch.pdb import ssp_clock_bound_violations
    from repro_torch.pdb.server import ShardCluster, run_distributed_lr
    from repro_torch.runtime.fault import Backoff, ShardDeathPlan
    out = {}
    # the first start (the forkserver's too): no shard opens a context
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    cluster = ShardCluster([torch.zeros(240, dtype=torch.float64)] * 4,
                           4, 2).start()
    out["first_start_s"] = time.perf_counter() - t0
    free1 = torch.cuda.mem_get_info()[0]
    cluster.shutdown()
    out["start_free_drop_mib"] = (free0 - free1) / 2 ** 20
    if not out["start_free_drop_mib"] < SERVER_CONTEXT_MIB:
        raise AssertionError(f"the card lost {out['start_free_drop_mib']} "
                             "MiB across cluster.start(): a shard opened "
                             "a CUDA context")

    syn = paper_lr.synthetic()
    Xs, ys = regression_dataset(syn.n_examples, syn.n_features,
                                seed=syn.seed, device="cuda")
    task = T.LRTask(Xs, ys, lr=syn.lr, n_iters=syn.n_iters, mode="gd")
    W, S = SERVER_SYN
    kw = dict(timeout=PAPER_TIMEOUT)
    torch.use_deterministic_algorithms(True)
    try:
        seq, seq_s = _wall(torch, lambda: T.run_sequential(task, W))
        walls = {"sequential": seq_s}
        for batched in (False, True):
            rpc = "batched" if batched else "per-op"
            for policy in ("dc", "dc-array", "bsp"):
                res = run_distributed_lr(task, W, S, policy=policy, delta=0,
                                         batched=batched, **kw)
                _delta0_gates(torch, H, res, seq, W, syn.n_iters,
                              f"synthetic {policy} {rpc}")
                walls[f"{policy}_{rpc}"] = res.wall_time
        ssp = run_distributed_lr(task, W, S, policy="ssp", delta=PAPER_DELTA,
                                 **kw)
        bad = ssp_clock_bound_violations(ssp.history, W, PAPER_DELTA)
        if bad or not H.is_complete(ssp.history, W, syn.n_iters):
            raise AssertionError(f"server SSP clock bound: {bad[:4]}")
        plan = ShardDeathPlan(kill_at_step=SERVER_KILL[0],
                              shard=SERVER_KILL[1])
        with tempfile.TemporaryDirectory() as snap:
            drill = run_distributed_lr(
                task, W, S, policy="dc", delta=0, snapshot_dir=snap,
                death_plan=plan,
                backoff=Backoff(max_retries=SERVER_DRILL_RETRIES), **kw)
        _delta0_gates(torch, H, drill, seq, W, syn.n_iters, "drill")
        if not (plan.fired and drill.retries > 0
                and drill.staleness["retried_steps"] >= drill.retries):
            raise AssertionError(f"drill: fired {plan.fired}, retries "
                                 f"{drill.retries}")
        out["synthetic"] = dict(
            workers=W, shards=S, iters=syn.n_iters, wall_s=walls,
            ssp=dict(wall_s=ssp.wall_time, staleness=ssp.staleness),
            drill=dict(wall_s=drill.wall_time, retries=drill.retries))
        del Xs, ys, task

        W, S = SERVER_REAL
        real = paper_lr.real_shape()
        task = T.LRTask(X, y, lr=real.lr, n_iters=REAL_GD_ITERS, mode="gd",
                        seed=real.seed)
        seq, seq_s = _wall(torch, lambda: T.run_sequential(task, W))
        walls = {"sequential": seq_s}
        for policy in ("dc", "bsp"):
            res = run_distributed_lr(task, W, S, policy=policy, delta=0,
                                     **kw)
            _delta0_gates(torch, H, res, seq, W, REAL_GD_ITERS,
                          f"real shape {policy}")
            walls[policy] = res.wall_time
        rel = run_distributed_lr(task, W, S, policy="dc", delta=PAPER_DELTA,
                                 **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    gd = dict(loss=T.loss(task, rel.theta.cuda()),
              sequential_loss=T.loss(task, seq),
              loss_at_zero=T.loss(task, torch.zeros_like(seq)),
              wall_s=rel.wall_time, staleness=rel.staleness,
              cache=rel.cache)
    out["real_shape"] = dict(workers=W, shards=S, iters=REAL_GD_ITERS,
                             wall_s=walls, dc_delta2=gd)
    print(f"server regression (shards: CPU processes; workers on the card, "
          f"f64, deterministic; {smi()}): delta 0 bit-identical (dc, "
          "dc-array, bsp x per-op, batched; the drill), histories complete "
          "and sequentially correct, SSP bound held:", json.dumps(out),
          flush=True)
    seq_loss, st = gd["sequential_loss"], gd["staleness"]
    if not (math.isfinite(gd["loss"]) and seq_loss / PAPER_LOSS_RATIO
            <= gd["loss"] <= seq_loss * PAPER_LOSS_RATIO
            and seq_loss < gd["loss_at_zero"]
            and abs(gd["loss"] - seq_loss)
            <= PAPER_PROGRESS * (gd["loss_at_zero"] - seq_loss)
            and st["stale_reads"] > 0
            and 0 <= st["max_staleness"] <= PAPER_DELTA):
        raise AssertionError(f"server GD, dc at delta {PAPER_DELTA}: {gd}")
    return out


def _frames_recorded(P):
    """Patch the parent's ``send_msg``/``recv_msg`` (the clients' side of
    every frame) to record the largest header and payload each way."""
    seen = dict(sent=0, received=0, header=0)
    send, recv = P.send_msg, P.recv_msg

    def send_msg(sock, header, payload=b""):
        seen["sent"] = max(seen["sent"], len(payload))
        seen["header"] = max(seen["header"], len(json.dumps(header)))
        return send(sock, header, payload)

    def recv_msg(sock):
        header, payload = recv(sock)
        seen["received"] = max(seen["received"], len(payload))
        return header, payload
    return seen, send_msg, recv_msg


def _rss_gib(pid) -> dict:
    """A process's peak (VmHWM) and present (VmRSS) resident set in GiB;
    None where /proc does not report it (some container kernels give no
    VmHWM)."""
    out = {"VmHWM": None, "VmRSS": None}
    for line in Path(f"/proc/{pid}/status").read_text().splitlines():
        key = line.split(":")[0]
        if key in out:
            out[key] = int(line.split()[1]) / 2 ** 20
    return out


def server_training(torch, ops, ref, phase6_loss0):
    """``python -m repro_torch.launch.train --backend server`` on the card:
    phase 5's narrow f32 model bit for bit its one-thread sequential replay
    (deterministic algorithms, both RPC paths; delta 1 within its bound),
    then llama3.2-1b at full width through 8 shard processes (the server
    training path: launch counts reset just before, read just after)."""
    import resource
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.pdb.server import ShardCluster
    from repro_torch.pdb.server import protocol as P
    pulls = []

    def pull(self):
        pulls.append((real_pull(self), {
            s: _rss_gib(p.pid) for s, p in enumerate(self.procs)}))
        return pulls[-1][0]
    real_pull = ShardCluster.pull
    narrow = {}
    with patched(ShardCluster, "pull", pull), \
            patched(train, "get_smoke_config",
                    lambda arch: small_train_config(torch, arch)):
        torch.use_deterministic_algorithms(True)
        try:
            for rpc in ("batched", "per-op"):
                flags = SERVER_NARROW + ["--rpc", rpc, "--delta", "0"]
                r = train.main(flags)
                theta, losses = train.server_replay(train.parse_args(flags))
                narrow[rpc] = dict(
                    bit_identical=torch.equal(pulls[-1][0].theta(), theta),
                    losses=losses, telemetry=r["telemetry"],
                    seq_correct=r["sequentially_correct"])
            r = train.main(SERVER_NARROW + ["--delta", "1"])
            narrow["delta1"] = dict(telemetry=r["telemetry"],
                                    seq_correct=r["sequentially_correct"])
        finally:
            torch.use_deterministic_algorithms(False)
    print("server training, narrow f32 on the card (deterministic):",
          json.dumps(narrow), flush=True)
    for rpc in ("batched", "per-op"):
        n = narrow[rpc]
        if not (n["bit_identical"] and n["seq_correct"]
                and n["telemetry"]["max_staleness"] == 0):
            raise AssertionError(f"narrow server training ({rpc}): {n}")
    if not narrow["delta1"]["telemetry"]["max_staleness"] <= 1:
        raise AssertionError(f"narrow server training at delta 1: "
                             f"{narrow['delta1']}")

    seen, send_msg, recv_msg = _frames_recorded(P)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with patched(ShardCluster, "pull", pull), \
            patched(P, "send_msg", send_msg), \
            patched(P, "recv_msg", recv_msg):
        ops.reset_launches()                 # the path starts here
        with plain_versions_counted(ref) as plain_calls:
            t0 = time.perf_counter()
            r = train.main(SERVER_LM)
            wall = time.perf_counter() - t0
        launches = dict(ops.launches)        # ... and ends here
    steps = r["steps"]
    a = train.parse_args(SERVER_LM)
    want = dict.fromkeys(launches, 0)
    n_attn = get_config(a.arch).layer_kinds.count("attn")
    for k in FLASH:                          # layers x workers x steps
        want[k] = n_attn * a.workers * a.steps
    loss0 = next(s["loss"] for s in steps if s["worker"] == 0
                 and s["itr"] == 1)
    rel = abs(loss0 - phase6_loss0) / abs(phase6_loss0)
    per_step = {}
    for s in sorted(steps, key=lambda s: (s["itr"], s["worker"])):
        per_step.setdefault(s["itr"], []).append(
            {k: v for k, v in s.items() if k not in ("itr",)})
    res = dict(
        arch=a.arch, shards=a.shards, workers=a.workers,
        chunks=a.param_chunks, steps=a.steps, batch=a.batch, seq=a.seq,
        lr=a.lr, wall_s=wall, per_step=per_step,
        first_loss=r["first_loss"], final_loss=r["final_loss"],
        phase6_step0_loss=phase6_loss0, first_loss_rel=rel,
        first_loss_bit_identical=loss0 == phase6_loss0,
        telemetry=r["telemetry"], seq_correct=r["sequentially_correct"],
        max_payload_sent=seen["sent"], max_payload_received=seen["received"],
        max_header=seen["header"], max_frame=P.MAX_FRAME,
        peak_device_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        host_peak_rss_gib=resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
        shard_rss_gib_at_pull=pulls[-1][1], launches=launches,
        expected_launches=want, plain_version_calls=plain_calls)
    print(f"server training at full width ({smi()}):", json.dumps(res),
          flush=True)
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran: {plain_calls}")
    if not all(math.isfinite(s["loss"]) for s in steps) \
            or len(steps) != a.workers * a.steps:
        raise AssertionError(f"server training steps: {steps}")
    if not (r["sequentially_correct"]
            and r["telemetry"]["max_staleness"] == 0):
        raise AssertionError(f"server history: {r['telemetry']}")
    if not max(seen["sent"], seen["received"], seen["header"]) < P.MAX_FRAME:
        raise AssertionError(f"a frame reached MAX_FRAME: {seen}")
    if not rel <= SERVER_LOSS_REL:
        raise AssertionError(f"worker 0's first loss {loss0} vs phase 6's "
                             f"step 0 {phase6_loss0}")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 12: the dense ring decode, remat and the chunked cross entropy
# ---------------------------------------------------------------------------

DENSE_B, DENSE_PROMPT, DENSE_STEPS = 8, 128, 32
GRAD_NORM_TOL = 2e-2            # bf16 gradients: max |d| / max |g| per leaf
CHUNKED_REL = 1e-4              # chunked against unchunked loss, relative
# (remat, REPRO_CHUNKED_CE) of phase 12b's gradient calls, in order: the
# first is the reference the others are held to
REMAT_CALLS = (("none", False), ("none", False), ("full", False),
               ("dots", False), ("none", True))


def paged_from_dense(torch, cache: dict, page: int) -> dict:
    """A paged cache holding the dense cache's rings: row b's L slots as
    pages b * L / page onward of one pool (an identity table); recurrent
    rows copied."""
    out = {}
    for gkey, slots in cache.items():
        out[gkey] = {}
        for skey, c in slots.items():
            if "k" not in c:
                out[gkey][skey] = {k: t.clone() for k, t in c.items()}
                continue
            n, B, L, KV, hd = c["k"].shape
            npp = L // page
            pt = torch.arange(B * npp, dtype=torch.int32,
                              device=c["k"].device).view(1, B, npp)
            out[gkey][skey] = {
                "pk": c["k"].reshape(n, B * npp, page, KV, hd).clone(),
                "pv": c["v"].reshape(n, B * npp, page, KV, hd).clone(),
                "pt": pt.expand(n, B, npp).contiguous()}
    return out


def _decode_timed(torch, cfg, params, cache, tok, pos):
    """One decode step at ``pos``: (logits, next tokens, host seconds (the
    call's enqueue), wall seconds (ending in a sync))."""
    from repro_torch.models.transformer import decode_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = decode_step(params, cache, tok, pos, cfg)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return out, torch.argmax(out[:, -1], -1)[:, None], host, \
        time.perf_counter() - t0


def _greedy_decode(torch, cfg, params, cache, last, pos0: int):
    """DENSE_STEPS greedy decode steps at a scalar pos from ``last`` (B, V):
    (each step's logits, the tokens (B, DENSE_STEPS))."""
    pos = torch.arange(pos0, pos0 + DENSE_STEPS, device="cuda")
    tok = torch.argmax(last, -1)[:, None]
    logits, toks = [], []
    for i in range(DENSE_STEPS):
        out, tok, _, _ = _decode_timed(torch, cfg, params, cache, tok,
                                       pos[i])
        logits.append(out)
        toks.append(tok)
    return logits, torch.cat(toks, 1)


def _decode_turns(torch, cfg, params, caches: dict, toks: dict,
                  pos0: int) -> dict:
    """DENSE_STEPS more greedy steps of each cache, the two taken in turns
    (a, b, b, a, ...): {name: (host seconds, wall seconds) per step}."""
    pos = torch.arange(pos0, pos0 + DENSE_STEPS, device="cuda")
    times = {name: ([], []) for name in caches}
    names = list(caches)
    for i in range(DENSE_STEPS):
        for name in (names if i % 2 == 0 else names[::-1]):
            _, toks[name], host, wall = _decode_timed(
                torch, cfg, params, caches[name], toks[name], pos[i])
            times[name][0].append(host)
            times[name][1].append(wall)
    return times


def _p50(xs) -> float:
    return sorted(xs)[len(xs) // 2]


def dense_decode(torch, ops, ref, cfg, params) -> dict:
    """12a: llama3.2-1b's dense ring decode (the JAX package's own form:
    ``decode_attention`` over the gathered ring), B8 prompts of 128 in a
    544-slot ring, 32 greedy steps at a scalar pos, held bit for bit to
    the paged decode over pools filled from the same ring."""
    from repro_torch.models.transformer import prefill
    prompts = torch.randint(
        0, cfg.vocab_size, (DENSE_B, DENSE_PROMPT), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    forms = {"gathered": 0, "paged": 0}

    def counted(form, fn):
        def call(*a):
            forms[form] += 1
            return fn(*a)
        return call
    with torch.no_grad(), \
            patched(ops, "_decode_attention",
                    counted("gathered", ops._decode_attention)), \
            patched(ops, "_decode_paged",
                    counted("paged", ops._decode_paged)):
        ops.reset_launches()                # the dense path starts here
        with plain_versions_counted(ref) as plain:
            last, dense = prefill(params, prompts, cfg, cache_len=MAIN_L)
            paged = paged_from_dense(torch, dense, PAGE)
            d_logits, d_toks = _greedy_decode(torch, cfg, params, dense,
                                              last, DENSE_PROMPT)
        torch.cuda.synchronize()
        launches = dict(ops.launches)       # ... and ends here
        dense_forms = dict(forms)
        p_logits, p_toks = _greedy_decode(torch, cfg, params, paged, last,
                                          DENSE_PROMPT)
        paged_forms = {k: forms[k] - dense_forms[k] for k in forms}
        turns = _decode_turns(
            torch, cfg, params, {"dense": dense, "paged": paged},
            {"dense": d_toks[:, -1:], "paged": p_toks[:, -1:]},
            DENSE_PROMPT + DENSE_STEPS)
    n_layers = len(cfg.layer_kinds)
    bits = [bool(torch.equal(a, b)) for a, b in zip(d_logits, p_logits)]
    finite = all(bool(torch.isfinite(x).all()) for x in d_logits)
    print("dense ring decode:", json.dumps(dict(
        batch=DENSE_B, prompt=DENSE_PROMPT, cache_len=MAIN_L,
        steps=DENSE_STEPS, launches=launches, forms_dense=dense_forms,
        forms_paged=paged_forms, plain_version_calls=plain,
        logits_bit_for_bit_paged=all(bits), tokens_equal=bool(
            torch.equal(d_toks, p_toks)),
        # timed over DENSE_STEPS further steps of each, in turns
        decode_step_host_p50_ms=_p50(turns["dense"][0]) * 1e3,
        paged_decode_step_host_p50_ms=_p50(turns["paged"][0]) * 1e3,
        decode_step_wall_p50_ms=_p50(turns["dense"][1]) * 1e3,
        paged_decode_step_wall_p50_ms=_p50(turns["paged"][1]) * 1e3,
        first_tokens=d_toks[0, :8].tolist())), flush=True)
    if launches["decode_attention"] != n_layers * DENSE_STEPS or \
            dense_forms != {"gathered": n_layers * DENSE_STEPS, "paged": 0}:
        raise AssertionError(f"dense decode launches {launches} forms "
                             f"{dense_forms}: want {n_layers} x "
                             f"{DENSE_STEPS} in the gathered form")
    if launches["flash_attention"] != n_layers or \
            sum(launches.values()) != n_layers * (DENSE_STEPS + 1):
        raise AssertionError(f"dense path launches {launches}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran: {plain}")
    if paged_forms != {"gathered": 0, "paged": n_layers * DENSE_STEPS}:
        raise AssertionError(f"paged run's forms {paged_forms}")
    if not (finite and all(bits) and torch.equal(d_toks, p_toks)):
        raise AssertionError(f"dense decode != paged: logits bit for bit "
                             f"per step {bits}, finite {finite}")
    return launches


def _warm_checkpoint(torch) -> None:
    """The process's first ``torch.utils.checkpoint`` call pays a one-off
    set-up of seconds; take it here, outside the timed calls."""
    from functools import partial
    from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                        create_selective_checkpoint_contexts)
    x = torch.ones(8, device="cuda", requires_grad=True)
    recompute = partial(create_selective_checkpoint_contexts,
                        lambda *a, **k: CheckpointPolicy.PREFER_RECOMPUTE)
    for kw in ({}, {"context_fn": recompute}):
        checkpoint(torch.sin, x, use_reentrant=False, **kw).sum().backward()


def remat_and_chunked_ce(torch, ops, ref, cfg) -> dict:
    """12b: one ``make_lm_grad_fn`` call per ``REMAT_CALLS`` entry at
    llama3.2-1b's training shape (batch 4 x 512, f32 master, bf16
    compute): the loss bit for bit across the remat policies, chunked
    within CHUNKED_REL of it, gradients bit for bit the first call's when
    two ``none`` calls agree bit for bit (else within GRAD_NORM_TOL), flash
    launches exact, peaks ordered full < dots < none and chunked < none.
    The first call's gradients stay on the card through the later calls,
    so their peaks share that baseline; the allocator keeps its cache
    between the calls, so a wall times no fresh mapping of memory."""
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import LMBatchSpec, make_lm_batch
    from repro_torch.launch.steps import make_lm_grad_fn
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    from repro_torch.tree import leaves_with_path
    master = paramlib.init_tree(
        model_specs(cfg), torch.Generator(device="cuda").manual_seed(0),
        dtype=cfg.param_dtype)
    batch = make_lm_batch(LMBatchSpec(batch=TRAIN_B, seq_len=TRAIN_S,
                                      vocab_size=cfg.vocab_size, seed=0),
                          0, "cuda")
    n_layers = len(cfg.layer_kinds)
    rows, ref_grads, launches = [], None, dict.fromkeys(ops.launches, 0)
    _warm_checkpoint(torch)
    for remat, chunked in REMAT_CALLS:
        grad_fn = make_lm_grad_fn(cfg, SyncConfig(remat=remat))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launches()
        os.environ["REPRO_CHUNKED_CE"] = "1" if chunked else "0"
        try:
            with plain_versions_counted(ref) as plain:
                t0 = time.perf_counter()
                loss, grads = grad_fn(master, batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            del os.environ["REPRO_CHUNKED_CE"]
        n = dict(ops.launches)
        for k in launches:
            launches[k] += n[k]
        row = dict(remat=remat, chunked_ce=chunked, loss=float(loss),
                   wall_s=wall, base_gib=base / 2 ** 30,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   flash_fwd=n["flash_attention"],
                   flash_bwd=n["flash_attention_bwd"],
                   plain_version_calls=sum(plain.values()))
        g = dict(leaves_with_path(grads))
        del grads
        if ref_grads is None:
            ref_grads, ref_loss = g, loss
        else:
            row["grads_bit_for_bit"] = all(
                torch.equal(g[k], ref_grads[k]) for k in ref_grads)
            errs = {"/".join(k): (
                (g[k].float() - ref_grads[k].float()).abs().max()
                / ref_grads[k].float().abs().max().clamp(min=1e-30)).item()
                for k in ref_grads}
            row["grad_worst_leaf"] = max(errs, key=errs.get)
            row["grad_norm_err"] = errs[row["grad_worst_leaf"]]
            row["loss_bit_for_bit"] = bool(torch.equal(loss, ref_loss))
        del g
        rows.append(row)
        print("remat / chunked CE call:", json.dumps(row), flush=True)
    none2, full, dots, chunked = rows[1:]
    deterministic = none2["grads_bit_for_bit"]
    print("remat gates:", json.dumps(dict(
        none_calls_bit_for_bit=deterministic,
        gradients_held=("bit for bit" if deterministic else
                        f"normalized {GRAD_NORM_TOL}"),
        peaks_gib={r["remat"] + ("+chunked" if r["chunked_ce"] else ""):
                   r["peak_gib"] for r in rows[1:]},
        chunked_vs_none_peak_gib=none2["peak_gib"] - chunked["peak_gib"],
        chunked_loss_rel=abs(chunked["loss"] - none2["loss"])
        / abs(none2["loss"]))), flush=True)
    for r in rows:
        fwd = n_layers * (2 if r["remat"] in ("full", "dots") else 1)
        if (r["flash_fwd"], r["flash_bwd"]) != (fwd, n_layers):
            raise AssertionError(f"flash launches {r}: want {fwd} forward, "
                                 f"{n_layers} backward")
        if r["plain_version_calls"] or not math.isfinite(r["loss"]):
            raise AssertionError(f"remat call {r}")
    for r in (none2, full, dots):
        if not r["loss_bit_for_bit"]:
            raise AssertionError(f"loss differs across remat: {r}")
        if not (r["grads_bit_for_bit"] if deterministic
                else r["grad_norm_err"] <= GRAD_NORM_TOL):
            raise AssertionError(f"gradients differ: {r}")
    if abs(chunked["loss"] - none2["loss"]) > CHUNKED_REL * abs(none2["loss"]) \
            or not chunked["grad_norm_err"] <= GRAD_NORM_TOL:
        raise AssertionError(f"chunked CE: {chunked} vs {none2}")
    if not full["peak_gib"] < dots["peak_gib"] < none2["peak_gib"]:
        raise AssertionError(f"peaks not ordered full < dots < none: "
                             f"{[r['peak_gib'] for r in rows]}")
    if not chunked["peak_gib"] < none2["peak_gib"]:
        raise AssertionError("chunked CE peaks at or above unchunked")
    return launches


def quickstart_on_card(torch) -> None:
    """12c: ``examples/torch_quickstart.py``'s ``main`` on the card."""
    import importlib.util
    path = ROOT / "examples" / "torch_quickstart.py"
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cuda"])
    if len(out["losses"]) != 20 or not all(
            math.isfinite(v) for v in out["losses"]) or \
            len(out["decoded"]) != 9:
        raise AssertionError(f"quickstart on the card: {out}")


def dense_decode_and_remat(torch, ops, ref) -> dict:
    """Phase 12 on llama3.2-1b at full width with the card otherwise free:
    (a) the dense ring decode, (b) remat and the chunked cross entropy,
    (c) the quickstart example.  Returns the launches of (a) and (b)."""
    from repro_torch.configs import get_config
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    from repro_torch.serve import serving_params
    cfg = get_config("llama3.2-1b")
    torch.cuda.empty_cache()
    master = paramlib.init_tree(
        model_specs(cfg), torch.Generator(device="cuda").manual_seed(0),
        dtype=cfg.param_dtype)
    params = serving_params(master, cfg)
    del master
    paths = {"dense_decode": dense_decode(torch, ops, ref, cfg, params)}
    del params
    torch.cuda.empty_cache()
    paths["remat"] = remat_and_chunked_ce(torch, ops, ref, cfg)
    torch.cuda.empty_cache()
    quickstart_on_card(torch)
    return paths


# ---------------------------------------------------------------------------
# phase 13: the rest of the zoo
# ---------------------------------------------------------------------------

# the three text models served through the engine at full width and depth:
# arch -> (cache_len, prompt lengths).  gemma3-4b's cache passes its 1024
# window and one prompt length passes it too, so its local rings wrap in
# whole-prompt prefill, in chunked prefill and in decode
ZOO_TEXT = {"olmo-1b": (MAIN_L, (128, 300)),
            "gemma3-4b": (2048, (128, GEMMA3_LONG)),
            "musicgen-large": (MAIN_L, (128, 300))}
ZOO_REQUESTS, ZOO_GEN, ZOO_BATCH = 8, 16, 4
# the vision model through prefill / decode_step: batch, prompt, steps
VISION_B, VISION_S, VISION_STEPS = 2, 256, 12
# gemma3-4b training: one (5 local + 1 global) group of the 6, batch 2 x
# 2048 (the window masks), 3 steps, AdamW, delta 2, chunked cross entropy
GEMMA3_TRAIN_B, GEMMA3_TRAIN_S, GEMMA3_TRAIN_STEPS = 2, 2048, 3
ZOO_LOSS_REL = 1e-4             # bf16 loss, kernels vs plain route, relative
# the vision model's bf16 logits: the kernel route's distance from the f32
# route within this factor of the plain bf16 route's own (each ~0.02
# normalized at 40 layers: the activations' rounding, not the kernels;
# the two bf16 routes' noise adds, so they are not held to each other)
VISION_BF16_MARGIN = 1.25


def _n_self_attn(cfg) -> int:
    """The model's self-attention layers (each one flash launch a
    prefill, one decode launch a step)."""
    from repro_torch.models.transformer import SELF_ATTN_KINDS
    return sum(k in SELF_ATTN_KINDS for k in cfg.layer_kinds)


def _norm_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _serving_copy(torch, cfg):
    """``cfg``'s bf16 serving copy from seed 0, built leaf by leaf (the f32
    master never whole on the card)."""
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    from repro_torch.serve import serving_leaf
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = paramlib.init_tree(
        model_specs(cfg), torch.Generator(device="cuda").manual_seed(0),
        dtype=cfg.param_dtype,
        leaf_fn=lambda k, t, spec: serving_leaf(k, t, cfg, spec))
    torch.cuda.synchronize()
    print(f"{cfg.name}, {len(cfg.layer_kinds)} layers: "
          f"{paramlib.param_count(model_specs(cfg))} params (bf16 serving "
          f"copy) in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
          flush=True)
    return params


def _attn_expected(cfg, rep, n_prefills: int, n_chunks: int) -> dict:
    """Exact launches of an attention model's serving run: each
    self-attention layer one flash forward a whole-prompt prefill, one
    chunked-prefill attention a chunk, one decode attention a decode step
    (the warmup's prefills, chunk and decode step included)."""
    n = _n_self_attn(cfg)
    return {"flash_attention": n * n_prefills,
            "prefill_page_attention": n * n_chunks,
            "decode_attention": n * (rep.decode_steps + 1),
            "page_gather": 0}


@contextlib.contextmanager
def kernels_held(torch, ops, names):
    """While the block runs, hold every call of ``ops.<name>`` for each of
    ``names`` (on the card: its kernel) against the same function on the
    plain route, on the call's own inputs, elementwise at rtol = atol =
    BF16_TOL (bf16) or F32_TOL (f32): yields {name: [max |d| of each
    call]}; raises on leaving if a call disagrees.  Not for a counted
    path: the plain versions run too."""
    errs = {n: [] for n in names}
    bad, saved = [], {n: getattr(ops, n) for n in names}

    def spy_of(name):
        def spy(*args, **kw):
            got = saved[name](*args, **kw)
            with plain_route(ops):
                want = saved[name](*args, **kw)
            tol = F32_TOL if got.dtype == torch.float32 else BF16_TOL
            errs[name].append((got.float() - want.float()).abs().max()
                              .item())
            if not torch.allclose(got.float(), want.float(), rtol=tol,
                                  atol=tol):
                bad.append((name, list(args[0].shape), errs[name][-1]))
            return got
        return spy
    for n in names:
        setattr(ops, n, spy_of(n))
    try:
        yield errs
    finally:
        for n in names:
            setattr(ops, n, saved[n])
    if bad or not all(errs.values()):
        raise AssertionError(f"kernel calls vs plain route: {bad}, calls "
                             f"{ {n: len(e) for n, e in errs.items()} }")


def _chunked_prompt(torch, cfg, params, prompt, L):
    """``prompt`` through end-aligned chunks on a B1 paged cache up to its
    last chunk: (cache, page rows, carry, the last chunk's tokens, its
    start).  The last chunk overlaps the one before; that is sound while
    the chunks before it wrap no ring (checked), which the engine's plan
    asks of the whole prompt."""
    from repro_torch.models.transformer import init_chunk_carry, prefill_chunk
    from repro_torch.serve import PageAllocator, init_paged_cache
    S = len(prompt)
    cache = init_paged_cache(cfg, 1, L, PAGE, device="cuda")
    rows = {k: torch.from_numpy(v).cuda()
            for k, v in PageAllocator(cfg, 1, L, PAGE).alloc(0).items()}
    carry = init_chunk_carry(cfg)
    starts = list(range(0, S - CHUNK, CHUNK)) + [S - CHUNK]
    ring = min(c["pt"].shape[-1] * PAGE for slots in cache.values()
               for c in slots.values() if "pt" in c)
    if (len(starts) - 1) * CHUNK > ring:
        raise ValueError(f"{S} tokens: the chunks before the last wrap "
                         f"the {ring}-slot ring")
    for s0 in starts[:-1]:
        toks = torch.tensor([prompt[s0:s0 + CHUNK]], device="cuda")
        _, cache, carry = prefill_chunk(params, cache, toks, s0, rows, carry,
                                        cfg, L)
    s0 = starts[-1]
    return cache, rows, carry, torch.tensor([prompt[s0:]], device="cuda"), s0


def same_cache_logits(torch, ops, cfg, params, prompt, L) -> dict:
    """One prompt through the engine's chunk plan on a B1 paged cache, then
    one greedy decode step.  At f32 compute on the same weights: the last
    chunk's logits and the decode step's, each from one cache state,
    through the kernels against the plain route, and the last chunk's
    against the whole-prompt prefill's (normalized, within F32_TOL).  In
    bf16 (the served kernels): every kernel call of the same run and of
    the whole-prompt prefill held elementwise against the plain route on
    its own inputs (``kernels_held``)."""
    from repro_torch.models.transformer import (decode_step, prefill,
                                                prefill_chunk)
    from repro_torch.tree import tree_map
    clone = lambda tree: tree_map(torch.clone, tree)  # noqa: E731
    S, pos = len(prompt), torch.tensor([len(prompt)], device="cuda")
    whole_toks = torch.tensor([prompt], device="cuda")
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    cache, rows, carry, toks, s0 = _chunked_prompt(torch, f32, params,
                                                   prompt, L)
    got, cache_k, _ = prefill_chunk(params, clone(cache), toks, s0,
                                    rows, carry, f32, L)
    with plain_route(ops):
        want, _, _ = prefill_chunk(params, clone(cache), toks, s0,
                                   rows, carry, f32, L)
    whole, _ = prefill(params, whole_toks, f32, cache_len=L)
    tok = torch.argmax(got, -1).view(1, 1)
    d_got, _ = decode_step(params, clone(cache_k), tok, pos, f32)
    with plain_route(ops):
        d_want, _ = decode_step(params, clone(cache_k), tok, pos, f32)
    errs = dict(chunk_kernels_vs_plain=_norm_err(got, want),
                chunk_vs_whole_prompt=_norm_err(got, whole),
                decode_kernels_vs_plain=_norm_err(d_got[:, -1],
                                                  d_want[:, -1]))
    del cache, cache_k, whole
    names = ("attention", "prefill_page_attention_paged",
             "attention_decode_paged")
    with kernels_held(torch, ops, names) as held:
        cache, rows, carry, toks, s0 = _chunked_prompt(torch, cfg, params,
                                                       prompt, L)
        last, cache, _ = prefill_chunk(params, cache, toks, s0, rows, carry,
                                       cfg, L)
        decode_step(params, cache, torch.argmax(last, -1).view(1, 1), pos,
                    cfg)
        prefill(params, whole_toks, cfg, cache_len=L)
    return dict(f32_normalized_err=errs, f32_tolerance=F32_TOL,
                prompt=S, bf16_calls_held={n: len(e) for n, e in
                                           held.items()},
                bf16_max_abs_err={n: max(e) for n, e in held.items()},
                bf16_tolerance=BF16_TOL)


def zoo_text_serving(torch, ops, ref, arch):
    """``arch`` at full width and depth in bf16 through ``ServeEngine``:
    first-token logits of one prompt of each length against the plain
    route on the card; the longest prompt's chunks and a decode step held
    to the plain route on one cache (``same_cache_logits``); continuous,
    static and chunked (128) runs on the steps clock, each with exact
    launch counts (reset just before, read just after) and no plain
    version; continuous == static; the decode step's p50 on the host
    clock (between step hooks of the continuous run).  The share of
    chunked requests whose greedy tokens equal the whole prompt's is
    printed only: two correct bf16 runs that sum in another order may
    part at a near tie."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import prefill
    from repro_torch.serve import ServeConfig, ServeEngine, open_loop_requests
    cfg = get_config(arch)
    cache_len, plens = ZOO_TEXT[arch]
    params = _serving_copy(torch, cfg)
    V = cfg.vocab_size
    reqs = open_loop_requests(ZOO_REQUESTS, 0.5, V, prompt_lens=plens,
                              gen_lens=(ZOO_GEN,), seed=0)
    common = dict(batch_size=ZOO_BATCH, page_size=PAGE, cache_len=cache_len)
    errs = {}
    for S in sorted({len(r.prompt) for r in reqs}):
        toks = torch.tensor([next(r.prompt for r in reqs
                                  if len(r.prompt) == S)], device="cuda")
        got, _ = prefill(params, toks, cfg, cache_len=cache_len)
        with plain_route(ops):
            want, _ = prefill(params, toks, cfg, cache_len=cache_len)
        if got.shape != (1, V) or not torch.isfinite(got).all():
            raise AssertionError(f"{arch}: prefill logits not finite")
        errs[S] = _norm_err(got, want)
    print(f"{arch} first-token logits, kernels vs plain route:",
          json.dumps(dict(normalized_err=errs, tolerance=LOGITS_NORM_TOL)),
          flush=True)
    if not max(errs.values()) <= LOGITS_NORM_TOL:
        raise AssertionError(f"{arch}: first-token logits differ: {errs}")
    held = same_cache_logits(torch, ops, cfg, params,
                             max(reqs, key=lambda r: len(r.prompt)).prompt,
                             cache_len)
    print(f"{arch} chunks and decode on one cache, kernels vs plain route:",
          json.dumps(held), flush=True)
    if not max(held["f32_normalized_err"].values()) <= F32_TOL:
        raise AssertionError(f"{arch}: same-cache logits differ: {held}")
    n_prefills = len(reqs) + len({len(r.prompt) for r in reqs})  # + warmup
    runs = {"continuous": (dict(continuous=True), n_prefills, 0),
            "static": (dict(continuous=False), n_prefills, 0),
            "chunked": (dict(prefill_chunk=CHUNK), 0, None)}
    reports, launches, stamps = {}, {}, []
    for name, (kw, n_pre, n_chunks) in runs.items():
        eng = ServeEngine(cfg, params, ServeConfig(clock="steps", **kw,
                                                   **common))
        hook = (lambda _: stamps.append(time.perf_counter())) \
            if name == "continuous" else None
        ops.reset_launches()                 # the path starts here
        t1 = time.perf_counter()
        with plain_versions_counted(ref) as plain_calls:
            rep = eng.run(reqs, step_hook=hook)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        launches[name] = dict(ops.launches)  # ... and ends here
        reports[name] = rep
        if n_chunks is None:                 # + the warmup's chunk
            n_chunks = rep.prefill_chunks + 1
        want = _attn_expected(cfg, rep, n_pre, n_chunks)
        print(f"{arch} {name} (steps clock): {rep.total_tokens} tokens, "
              f"{rep.decode_steps} decode steps, {rep.prefill_chunks} "
              f"prefill chunks, {dt:.2f} s host time; launches "
              f"{launches[name]}; expected {want}; plain version calls "
              f"{plain_calls}", flush=True)
        if any(launches[name][k] != v for k, v in want.items()) or \
                sum(launches[name].values()) != sum(want.values()):
            raise AssertionError(f"{arch} {name}: launches "
                                 f"{launches[name]}, want {want}")
        if any(plain_calls.values()):
            raise AssertionError(f"{arch} {name}: plain versions ran: "
                                 f"{plain_calls}")
        for r in reqs:
            toks = rep.outputs[r.rid]
            if len(toks) != r.gen_len or not all(0 <= t < V for t in toks):
                raise AssertionError(f"{arch} {name} request {r.rid}: bad "
                                     f"output {toks}")
    if reports["continuous"].outputs != reports["static"].outputs:
        raise AssertionError(f"{arch}: continuous and static greedy tokens "
                             "differ")
    share = sum(reports["chunked"].outputs[r.rid]
                == reports["continuous"].outputs[r.rid]
                for r in reqs) / len(reqs)
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    print(f"{arch} serving:", json.dumps(dict(
        continuous_equals_static=True,
        chunked_requests_equal_to_whole_prompt=share,
        decode_steps=reports["continuous"].decode_steps,
        decode_step_host_ms_p50=_p50(step_ms),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)),
        flush=True)
    del params
    torch.cuda.empty_cache()
    key = arch.split("-")[0]
    return {f"{key}_serving": launches["continuous"],
            f"{key}_chunked": launches["chunked"]}


def _vision_run(torch, params, cfg, toks, media, cache_len):
    """prefill of toks[:, :VISION_S] with media, then VISION_STEPS
    teacher-forced ``decode_step``s on the dense ring: (the logits of
    each, decode-step wall ms)."""
    from repro_torch.models.transformer import decode_step, prefill
    last, cache = prefill(params, toks[:, :VISION_S], cfg,
                          cache_len=cache_len, media=media)
    out, step_ms = [last], []
    for t in range(VISION_STEPS):
        pos = VISION_S + t
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lg, cache = decode_step(params, cache, toks[:, pos:pos + 1],
                                torch.tensor(pos, device="cuda"), cfg,
                                media=media)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t1))
        out.append(lg[:, 0])
    return out, step_ms


def zoo_vision(torch, ops, ref):
    """llama-3.2-vision-11b at full width and depth (40 layers, 8 of them
    xattn) in bf16, its xattn gates drawn non-zero (they start at 0, which
    hides the layer): prefill of VISION_B prompts with media, then
    VISION_STEPS decode steps with media on the dense ring (the path:
    launch counts reset just before, read just after; flash 32 + 8 a
    prefill and 8 a step, decode attention 32 a step, no plain version);
    at f32 compute on the same weights, the kernel route's logits within
    1e-4 (normalized) of the plain route's; in bf16, every flash and
    decode call of a second run held elementwise against the plain route
    on its own inputs (``kernels_held``: the xattn layers' Sq != Sk calls
    among them), and the kernel route's logits no farther from the f32
    plain route than the plain bf16 route's are (times
    ``VISION_BF16_MARGIN``); the gates' effect (logits with the gates at
    0 differ); peak memory."""
    from repro_torch.configs import get_config
    cfg = get_config("llama-3.2-vision-11b")
    params = _serving_copy(torch, cfg)
    g = torch.Generator(device="cuda").manual_seed(1)
    gates = _draw_gates(torch, params, cfg, g)
    B, V = VISION_B, cfg.vocab_size
    toks = torch.randint(0, V, (B, VISION_S + VISION_STEPS), generator=g,
                         device="cuda")
    media = torch.randn((B, cfg.n_frontend_tokens, cfg.d_frontend),
                        generator=g, device="cuda")
    cache_len = VISION_S + VISION_STEPS
    n_self = _n_self_attn(cfg)
    n_x = cfg.layer_kinds.count("xattn")
    torch.cuda.synchronize()
    ops.reset_launches()                     # the path starts here
    t1 = time.perf_counter()
    with plain_versions_counted(ref) as plain_calls:
        got, step_ms = _vision_run(torch, params, cfg, toks, media,
                                   cache_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(ops.launches)            # ... and ends here
    want = {"flash_attention": n_self + n_x + n_x * VISION_STEPS,
            "decode_attention": n_self * VISION_STEPS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    routes = {}
    with torch.no_grad():
        with plain_route(ops):
            routes["plain_bf16"] = _vision_run(torch, params, cfg, toks,
                                               media, cache_len)[0]
            routes["plain_f32"] = _vision_run(torch, params, f32, toks,
                                              media, cache_len)[0]
        routes["kernels_f32"] = _vision_run(torch, params, f32, toks, media,
                                            cache_len)[0]
        # the served bf16 kernels on the path's own inputs, call by call:
        # the xattn layers' flash forward at B2 Sq256 and B2 Sq1 against
        # 1600 keys among them
        with kernels_held(torch, ops, ("attention",
                                       "attention_decode")) as held:
            _vision_run(torch, params, cfg, toks, media, cache_len)
    held_calls = {n: len(e) for n, e in held.items()}
    if held_calls != {"attention": want["flash_attention"],
                      "attention_decode": want["decode_attention"]}:
        raise AssertionError(f"vision: calls held {held_calls}, want {want}")

    def dist(a, b):
        return max(_norm_err(x, y) for x, y in zip(a, b))
    errs = dict(
        f32_kernels_vs_plain=dist(routes["kernels_f32"],
                                  routes["plain_f32"]),
        bf16_kernels_vs_f32=dist(got, routes["plain_f32"]),
        bf16_plain_vs_f32=dist(routes["plain_bf16"], routes["plain_f32"]),
        bf16_kernels_vs_plain=dist(got, routes["plain_bf16"]))
    del routes
    for gate in gates:
        gate.zero_()
    with torch.no_grad():
        ungated, _ = _vision_run(torch, params, cfg, toks, media, cache_len)
    gate_effect = max(_norm_err(a, b) for a, b in zip(ungated, got))
    print("llama-3.2-vision-11b serving:", json.dumps(dict(
        batch=B, prompt=VISION_S, media=list(media.shape),
        decode_steps=VISION_STEPS, launches=launches,
        expected_launches=want, plain_version_calls=plain_calls,
        normalized_err=errs, f32_tolerance=F32_TOL,
        bf16_margin=VISION_BF16_MARGIN, bf16_calls_held=held_calls,
        bf16_calls_max_abs_err={n: max(e) for n, e in held.items()},
        bf16_calls_tolerance=BF16_TOL,
        gates_zeroed_normalized_change=gate_effect,
        decode_step_wall_ms_p50=_p50(step_ms), wall_s=wall,
        peak_mem_gib=peak)), flush=True)
    if any(launches[k] != v for k, v in want.items()) or \
            sum(launches.values()) != sum(want.values()):
        raise AssertionError(f"vision launches {launches}, want {want}")
    if any(plain_calls.values()):
        raise AssertionError(f"vision: plain versions ran: {plain_calls}")
    if not all(torch.isfinite(x).all() for x in got) or \
            not errs["f32_kernels_vs_plain"] <= F32_TOL or \
            not errs["bf16_kernels_vs_f32"] <= VISION_BF16_MARGIN \
            * errs["bf16_plain_vs_f32"]:
        raise AssertionError(f"vision logits vs plain route: {errs}")
    if not gate_effect > 1e-3:
        raise AssertionError(f"the xattn layers change nothing: "
                             f"{gate_effect}")
    del params, gates, media, got, ungated
    torch.cuda.empty_cache()
    return {"vision_serving": launches}


def gemma3_training(torch, ops, ref):
    """gemma3-4b at full width, depth 6 of 34 (one 5 local + 1 global
    group), f32 master and bf16 compute, through the train engine: AdamW,
    delta 2 on the packed ring, batch 2 x 2048 (the 1024 window masks),
    ``REPRO_CHUNKED_CE=1`` (its 262,144-entry vocabulary), 3 steps (the
    path: launch counts reset just before, read just after; flash forward
    and backward 6 a step, the ring gather once a group and step, no plain
    version).  Losses finite; the first step's loss (the initial weights')
    against ``lm_loss`` on the plain route; step p50 and peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import LMBatchSpec, make_lm_batch
    from repro_torch.launch.steps import make_lm_grad_fn
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import lm_loss, model_specs
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.pdb import make_engine
    full = get_config("gemma3-4b")
    first = full.groups[0]
    cfg = dataclasses.replace(full, groups=(dataclasses.replace(first, n=1),))
    reduced = (f"layers {len(full.layer_kinds)} -> {len(cfg.layer_kinds)}: "
               f"one {first.pattern} group of the {first.n} and none of the "
               "4-local tail; every width kept (AdamW's update for all "
               f"{len(full.layer_kinds)} layers exceeds the card's memory)")
    saved_env = os.environ.get("REPRO_CHUNKED_CE")
    os.environ["REPRO_CHUNKED_CE"] = "1"
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = paramlib.init_tree(
            model_specs(cfg), torch.Generator(device="cuda").manual_seed(0),
            dtype=cfg.param_dtype)
        spec = LMBatchSpec(batch=GEMMA3_TRAIN_B, seq_len=GEMMA3_TRAIN_S,
                           vocab_size=cfg.vocab_size, seed=0)
        batches = [make_lm_batch(spec, t, "cuda")
                   for t in range(GEMMA3_TRAIN_STEPS)]
        with torch.no_grad(), plain_route(ops):
            plain_loss = float(lm_loss(params, batches[0], cfg)[0])
        sync = SyncConfig(delta=TRAIN_DELTA, remat="none", packed_ring=True)
        eng = make_engine(params, make_lm_grad_fn(cfg, sync),
                          make_optimizer(OptConfig(name="adamw", lr=3e-4)),
                          sync)
        state = eng.init_state()
        n_params = paramlib.param_count(model_specs(cfg))
        del params
        torch.cuda.synchronize()
        print(f"gemma3-4b training state ready in "
              f"{time.perf_counter() - t0:.2f} s: {n_params} params, "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
              flush=True)
        losses, step_s = [], []
        ops.reset_launches()                 # the path starts here
        with plain_versions_counted(ref) as plain_calls:
            for b in batches:
                t1 = time.perf_counter()
                state, m = eng.step(state, b)
                losses.append(float(m["loss"]))   # syncs with the device
                step_s.append(time.perf_counter() - t1)
        launches = dict(ops.launches)        # ... and ends here
    finally:
        if saved_env is None:
            os.environ.pop("REPRO_CHUNKED_CE", None)
        else:
            os.environ["REPRO_CHUNKED_CE"] = saved_env
    n_attn = _n_self_attn(cfg)
    want = {"flash_attention": n_attn * GEMMA3_TRAIN_STEPS,
            "flash_attention_bwd": n_attn * GEMMA3_TRAIN_STEPS,
            "ring_gather": len(state.hist) * GEMMA3_TRAIN_STEPS}
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print("gemma3-4b training:", json.dumps(dict(
        layers=len(cfg.layer_kinds), reduced=reduced, parameters=n_params,
        batch=GEMMA3_TRAIN_B, seq=GEMMA3_TRAIN_S, delta=TRAIN_DELTA,
        optimizer="adamw", chunked_ce=True, steps=GEMMA3_TRAIN_STEPS,
        losses=losses, first_loss_plain_route=plain_loss,
        first_loss_rel_err=rel, tolerance=ZOO_LOSS_REL, step_s=step_s,
        step_s_p50=_p50(step_s), launches=launches, expected_launches=want,
        plain_version_calls=plain_calls, telemetry=eng.telemetry.summary(),
        peak_mem_gib=peak)), flush=True)
    if not all(math.isfinite(x) for x in losses) or not rel <= ZOO_LOSS_REL:
        raise AssertionError(f"gemma3 losses {losses}, plain {plain_loss}")
    if any(launches[k] != v for k, v in want.items()) or \
            sum(launches.values()) != sum(want.values()):
        raise AssertionError(f"gemma3 training launches {launches}, want "
                             f"{want}")
    if any(plain_calls.values()):
        raise AssertionError(f"gemma3 training: plain versions ran: "
                             f"{plain_calls}")
    del state, eng, batches
    torch.cuda.empty_cache()
    return {"gemma3_training": launches}


# ---------------------------------------------------------------------------
# phase 14: vision training
# ---------------------------------------------------------------------------

# llama-3.2-vision-11b training: one ("attn",) * 4 + ("xattn",) group of
# the 8, batch 2 x 2048 text tokens against 2 x 1600 media tokens, 3
# steps, SGD, delta 2, chunked cross entropy (its 128,256-entry vocabulary)
VISION_TRAIN_B, VISION_TRAIN_S, VISION_TRAIN_STEPS = 2, 2048, 3
VISION_TRAIN_REDUCED = (
    "layers 40 -> 5: one ('attn', 'attn', 'attn', 'attn', 'xattn') group "
    "of the 8, every width kept; 2,146,480,129 parameters, 8.00 GiB an "
    "f32 copy: at delta 2 on the packed ring the engine holds the master "
    "(8), the 3-row ring (24), the stale read (8), the f32 gradients (8) "
    "and the new parameters (8), ~56 GiB before activations; AdamW's "
    "functional update adds m, v and their new copies (+32 GiB, ~88 GiB) "
    "past the card's 79.2 GiB, so SGD (AdamW waits for an in-place update, "
    "ROADMAP A9); deeper cuts add 8 GiB a layer group of 5 and more")


def _draw_gates(torch, params, cfg, generator) -> list:
    """Draw every xattn gate of ``params`` in [0.5, 1.5) in place (they
    start at 0, where tanh(0) hides the layer and its dO is exactly 0):
    the gate tensors."""
    gates = []
    for gi, grp in enumerate(cfg.groups):
        for si, kind in enumerate(grp.pattern):
            if kind == "xattn":
                gate = params["groups"][f"g{gi}"][f"s{si}"]["mix"]["gate"]
                with torch.no_grad():
                    gate.uniform_(0.5, 1.5, generator=generator)
                gates.append(gate)
    return gates


@contextlib.contextmanager
def backward_held(torch, ref):
    """While the block runs, hold every call of the flash backward kernel
    (``flash_attention_bwd``, as ``FlashAttention.backward`` looks it up
    at each call) against torch autograd of ``ref.attention`` in f32 on
    the call's own (q, k, v, dO): f32 at rtol = atol BWD_F32_TOL, bf16 at
    a normalized BWD_BF16_NORM_TOL per gradient, the backward's own
    gates.  Yields a list of {q, k, causal, window, err} a call; raises on
    leaving if a call disagrees or none ran.  Not for a counted path: the
    plain version runs too."""
    from repro_torch.kernels import flash_attention as fa
    saved = fa.flash_attention_bwd
    calls, bad = [], []

    def spy(q, k, v, o, do, lse, causal=True, window=0):
        got = saved(q, k, v, o, do, lse, causal=causal, window=window)
        with torch.enable_grad():
            ins = [t.detach().float().requires_grad_() for t in (q, k, v)]
            want = torch.autograd.grad(
                ref.attention(*ins, causal=causal, window=window), ins,
                do.float())
        if q.dtype == torch.float32:
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            ok = all(torch.allclose(g, w, rtol=BWD_F32_TOL, atol=BWD_F32_TOL)
                     for g, w in zip(got, want))
        else:
            err = max(_norm_err(g, w) for g, w in zip(got, want))
            ok = err <= BWD_BF16_NORM_TOL
        calls.append(dict(q=list(q.shape), k=list(k.shape), causal=causal,
                          window=window, err=err))
        if not ok:
            bad.append(calls[-1])
        return got
    fa.flash_attention_bwd = spy
    try:
        yield calls
    finally:
        fa.flash_attention_bwd = saved
    if bad or not calls:
        raise AssertionError(f"backward calls vs autograd of the plain "
                             f"version: {bad}, {len(calls)} calls")


def small_vision_training(torch, ops):
    """The vision smoke config at f32 (4 self-attention layers and one
    xattn layer at d 64, 4 heads of 16; media 8 x 24), gates drawn
    non-zero, 3 SGD steps through the train engine at delta 2 on the
    packed ring, batch 2 x 96: the card (CUDA kernels, launches counted)
    against the CPU (plain versions), losses and the xattn layer's and
    ``frontend_proj``'s parameters within TRAIN_TOL."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import LMBatchSpec, make_lm_batch
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    from repro_torch.tree import leaves_with_path
    cfg = dataclasses.replace(get_smoke_config("llama-3.2-vision-11b"),
                              dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    params = paramlib.init_tree(model_specs(cfg), g)
    _draw_gates(torch, params, cfg, g)
    spec = LMBatchSpec(batch=2, seq_len=96, vocab_size=cfg.vocab_size,
                       media_tokens=cfg.n_frontend_tokens,
                       media_dim=cfg.d_frontend, seed=1)
    sync = SyncConfig(delta=2, remat="none", packed_ring=True)
    res = {}
    for dev in ("cpu", "cuda"):
        batches = [make_lm_batch(spec, t, dev) for t in range(3)]
        ops.reset_launches()
        res[dev] = _train_run(torch, cfg, _to(params, dev), "sgd", sync,
                              batches, 0.05)
    launches = dict(ops.launches)            # the card's run
    want = {"flash_attention": 5 * 3, "flash_attention_bwd": 5 * 3}
    loss_err = ((res["cpu"][0] - res["cuda"][0].cpu()).abs().max().item()
                / res["cpu"][0].abs().max().item())
    held = {"/".join(p): (a, b) for (p, a), (_, b) in zip(
        leaves_with_path(res["cpu"][1]), leaves_with_path(res["cuda"][1]))
        if p[0] == "frontend_proj" or p[:3] == ("groups", "g0", "s4")}
    param_err = max((a - b.cpu()).abs().max().item()
                    for a, b in held.values())
    print("small f32 vision training, delta 2 packed, SGD, 3 steps:",
          json.dumps(dict(
              loss_rel_err_cuda_vs_cpu=loss_err,
              param_max_abs_err_cuda_vs_cpu=param_err,
              params_held=sorted(held), losses_cuda=res["cuda"][0].tolist(),
              launches_cuda=launches, expected_launches=want,
              tolerance=TRAIN_TOL)), flush=True)
    if not (loss_err <= TRAIN_TOL and param_err <= TRAIN_TOL):
        raise AssertionError("small vision training: CUDA and CPU differ")
    if any(launches[k] != v for k, v in want.items()) or any(
            c for k, c in launches.items()
            if k not in want and k != "ring_gather"):
        raise AssertionError(f"small vision training launches {launches}, "
                             f"want {want}")


def vision_training(torch, ops, ref):
    """llama-3.2-vision-11b at full width, depth 5 of 40, through the
    train engine (phase 14; ``VISION_TRAIN_REDUCED``): f32 master, bf16
    compute, SGD, delta 2 on the packed ring, batch 2 x 2048 with media 2
    x 1600 x 1280, ``REPRO_CHUNKED_CE=1``, the xattn gate drawn non-zero,
    3 steps (the path: launch counts reset just before, read just after;
    flash forward and backward 5 a step, the ring gather once a group and
    step, no plain version).  Losses finite; the first step's loss
    against ``lm_loss`` on the plain route; one more step, not counted,
    with every backward call held on its own inputs
    (``backward_held``); step p50, peak memory, parameter count."""
    from repro_torch.configs import get_config
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import LMBatchSpec, make_lm_batch
    from repro_torch.launch.steps import make_lm_grad_fn
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import lm_loss, model_specs
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.pdb import make_engine
    full = get_config("llama-3.2-vision-11b")
    first = full.groups[0]
    cfg = dataclasses.replace(full, groups=(dataclasses.replace(first, n=1),))
    saved_env = os.environ.get("REPRO_CHUNKED_CE")
    os.environ["REPRO_CHUNKED_CE"] = "1"
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = paramlib.init_tree(
            model_specs(cfg), torch.Generator(device="cuda").manual_seed(0),
            dtype=cfg.param_dtype)
        gates = _draw_gates(torch, params, cfg,
                            torch.Generator(device="cuda").manual_seed(1))
        spec = LMBatchSpec(batch=VISION_TRAIN_B, seq_len=VISION_TRAIN_S,
                           vocab_size=cfg.vocab_size,
                           media_tokens=cfg.n_frontend_tokens,
                           media_dim=cfg.d_frontend, seed=0)
        batches = [make_lm_batch(spec, t, "cuda")
                   for t in range(VISION_TRAIN_STEPS)]
        with torch.no_grad(), plain_route(ops):
            plain_loss = float(lm_loss(params, batches[0], cfg)[0])
        sync = SyncConfig(delta=TRAIN_DELTA, remat="none", packed_ring=True)
        eng = make_engine(params, make_lm_grad_fn(cfg, sync),
                          make_optimizer(OptConfig(name="sgd", lr=3e-4)),
                          sync)
        state = eng.init_state()
        n_params = paramlib.param_count(model_specs(cfg))
        gate_values = [x for g in gates for x in g.flatten().tolist()]
        del params, gates
        torch.cuda.synchronize()
        print(f"llama-3.2-vision-11b training state ready in "
              f"{time.perf_counter() - t0:.2f} s: {n_params} params, "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
              flush=True)
        losses, step_s = [], []
        ops.reset_launches()                 # the path starts here
        with plain_versions_counted(ref) as plain_calls:
            for b in batches:
                t1 = time.perf_counter()
                state, m = eng.step(state, b)
                losses.append(float(m["loss"]))   # syncs with the device
                step_s.append(time.perf_counter() - t1)
        launches = dict(ops.launches)        # ... and ends here
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # one more step, not counted: every backward call on its own inputs
        with backward_held(torch, ref) as held:
            state, m = eng.step(state, batches[0])
            held_loss = float(m["loss"])
    finally:
        if saved_env is None:
            os.environ.pop("REPRO_CHUNKED_CE", None)
        else:
            os.environ["REPRO_CHUNKED_CE"] = saved_env
    n_attn, n_x = _n_self_attn(cfg), cfg.layer_kinds.count("xattn")
    steps = VISION_TRAIN_STEPS
    want = {"flash_attention": (n_attn + n_x) * steps,
            "flash_attention_bwd": (n_attn + n_x) * steps,
            "ring_gather": len(state.hist) * steps}
    xattn_calls = [c for c in held if c["q"][1] != c["k"][1]]
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    print("llama-3.2-vision-11b training:", json.dumps(dict(
        layers=len(cfg.layer_kinds), reduced=VISION_TRAIN_REDUCED,
        parameters=n_params, batch=VISION_TRAIN_B, seq=VISION_TRAIN_S,
        media=[VISION_TRAIN_B, cfg.n_frontend_tokens, cfg.d_frontend],
        delta=TRAIN_DELTA, optimizer="sgd", chunked_ce=True, steps=steps,
        xattn_gates=gate_values, losses=losses,
        first_loss_plain_route=plain_loss, first_loss_rel_err=rel,
        tolerance=ZOO_LOSS_REL, step_s=step_s, step_s_p50=_p50(step_s),
        launches=launches, expected_launches=want,
        plain_version_calls=plain_calls, telemetry=eng.telemetry.summary(),
        peak_mem_gib=peak, held_step_loss=held_loss,
        backward_calls_held=held,
        backward_tolerance=dict(bf16_normalized=BWD_BF16_NORM_TOL,
                                f32=BWD_F32_TOL))), flush=True)
    if not all(math.isfinite(x) for x in losses + [held_loss]) or \
            not rel <= ZOO_LOSS_REL:
        raise AssertionError(f"vision losses {losses}, plain {plain_loss}")
    if any(launches[k] != v for k, v in want.items()) or \
            sum(launches.values()) != sum(want.values()):
        raise AssertionError(f"vision training launches {launches}, want "
                             f"{want}")
    if any(plain_calls.values()):
        raise AssertionError(f"vision training: plain versions ran: "
                             f"{plain_calls}")
    if len(held) != n_attn + n_x or len(xattn_calls) != n_x:
        raise AssertionError(f"vision training: {len(held)} backward calls "
                             f"held, {len(xattn_calls)} at Sq != Sk")
    del state, eng, batches
    torch.cuda.empty_cache()
    return {"vision_training": launches}


# ---------------------------------------------------------------------------
# phase 15: the multi-device layer on one card
# ---------------------------------------------------------------------------

SHARD_B, SHARD_S, SHARD_STEPS = 4, 512, 2
SHARD_REMAT = "none"
# (arch, mesh, mode) of the dry-run cells, all train_4k
DRYRUN_CELLS = (("llama3.2-1b", "single", "datacentric"),
                ("llama3.2-1b", "single", "bsp"),
                ("llama3.2-1b", "multi", "datacentric"))
DRYRUN_ONE_CARD = """
import json
from repro_torch.configs import get_config
from repro_torch.core.sync import SyncConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.shapes import ShapeCell
dryrun.fake_world(1)
r = dryrun.measure_cell(get_config("llama3.2-1b"),
                        ShapeCell("phase15", {S}, {B}, "train"),
                        make_test_mesh((1, 1)),
                        SyncConfig(mode="datacentric", remat="{remat}"))
print(json.dumps(r))
"""


def _dryrun_env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                CUDA_VISIBLE_DEVICES="")


def start_dryrun_cells(out_dir: Path, cells) -> dict:
    """The dry run's CLI on each (arch, mesh, mode) of ``cells``
    (``train_4k``), all started together as subprocesses on the host (no
    CUDA), while the phase runs on the card."""
    procs = {}
    for arch, mesh, mode in cells:
        out = out_dir / f"{arch}_{mesh}_{mode}"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", "train_4k", "--mesh", mesh,
               "--mode", mode, "--out", str(out)]
        procs[(arch, mesh, mode)] = subprocess.Popen(
            cmd, env=_dryrun_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    return procs


def start_dryruns(out_dir: Path) -> dict:
    """The dry-run subprocesses of phase 15 (b), all started together: the
    three ``DRYRUN_CELLS`` through the CLI, and (a)'s own shape on a (1, 1)
    mesh."""
    procs = start_dryrun_cells(out_dir, DRYRUN_CELLS)
    code = DRYRUN_ONE_CARD.format(S=SHARD_S, B=SHARD_B, remat=SHARD_REMAT)
    procs["one_card"] = subprocess.Popen(
        [sys.executable, "-c", code], env=_dryrun_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return procs


def _param_bytes_by_rules(mesh_axes: dict, mode: str,
                          arch: str = "llama3.2-1b") -> int:
    """``arch``'s f32 parameter bytes on one device, reckoned from the
    sync rules and the mesh's axis sizes alone."""
    from repro_torch.configs import get_config
    from repro_torch.core.sync import RULES
    from repro_torch.launch.sharding import local_shape, resolve_spec
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    return sum(4 * math.prod(local_shape(
        p.shape, resolve_spec(p.axes, p.shape, mesh_axes, RULES[mode]),
        mesh_axes)) for _, p in paramlib.leaves(
            model_specs(get_config(arch))))


def finish_dryruns(procs: dict, out_dir: Path, cells=DRYRUN_CELLS) -> dict:
    """Wait for the dry runs and gate them: each exits 0; the parameter
    bytes a device holds are the sharding arithmetic's; ``datacentric``
    reduce-scatters and all-gathers, ``bsp`` all-reduces; every number is
    finite.  Prints each cell; returns {key: its standard output}."""
    outs = {}
    try:
        for key, p in procs.items():
            out, err = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"dry run {key} exited {p.returncode}:"
                                     f" {(out or '')[-2000:]}"
                                     f" {(err or '')[-2000:]}")
            outs[key] = out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    sizes = {"single": {"data": 16, "model": 16},
             "multi": {"pod": 2, "data": 16, "model": 16}}
    for arch, mesh, mode in cells:
        files = list((out_dir / f"{arch}_{mesh}_{mode}").glob("*.json"))
        if len(files) != 1:
            raise AssertionError(f"dry run {arch} {mesh} {mode}: files "
                                 f"{files}")
        r = json.loads(files[0].read_text())
        mem, coll, rl = r["memory"], r["collectives"], r["roofline"]
        want = _param_bytes_by_rules(sizes[mesh], mode, arch)
        nums = [*mem.values(), *r["cost"].values(), rl["compute_s"],
                rl["memory_s"], rl["collective_s"],
                *coll.values(), r["collective_bytes_per_device"]]
        print("dry run:", json.dumps(dict(
            arch=r["arch"], shape=r["shape"], mesh=r["mesh"], mode=mode,
            remat=r["remat"], peak_bytes_per_device=mem[
                "peak_bytes_per_device"], memory=mem,
            flops_per_device=r["cost"]["flops_per_device"],
            bytes_per_device=r["cost"]["bytes_per_device"],
            collectives=coll, roofline=rl,
            useful_flops_ratio=r["useful_flops_ratio"],
            parameter_bytes_by_rules=want, trace_s=r["trace_s"],
            constants=r["device"])), flush=True)
        if mem["parameter_bytes_per_device"] != want:
            raise AssertionError(f"dry run {arch} {mesh} {mode}: parameter "
                                 f"bytes {mem['parameter_bytes_per_device']}"
                                 f", the rules give {want}")
        kinds = (("all-reduce",) if mode == "bsp"
                 else ("reduce-scatter", "all-gather"))
        if any(coll.get(k + "_count", 0) == 0 for k in kinds):
            raise AssertionError(f"dry run {arch} {mesh} {mode}: "
                                 f"collectives {coll}, want {kinds}")
        if not all(math.isfinite(v) for v in nums):
            raise AssertionError(f"dry run {arch} {mesh} {mode}: a number "
                                 f"is not finite: {r}")
    return outs


def _leaves_equal(torch, got, want) -> list:
    """Paths of the leaves of a (DTensor) tree whose local shard differs
    in any bit from the plain tree's leaf, on the plain leaf's device."""
    from repro_torch.tree import leaves_with_path
    return ["/".join(p) for (p, g), (_, w) in zip(leaves_with_path(got),
                                                  leaves_with_path(want))
            if not torch.equal((g.to_local() if hasattr(g, "to_local")
                                else g).to(w.device), w)]


def sharded_training(torch, ops, ref) -> dict:
    """Phase 15: (a) llama3.2-1b at full width through
    ``steps.make_train_step`` on DTensor parameters placed by
    ``sharding.tree_shardings`` on a one-rank NCCL group and a (1, 1)
    ``data, model`` mesh, 2 AdamW steps in ``datacentric`` and 2 in
    ``bsp``, held bit for bit to the unsharded step (each run's AdamW
    through its kernel, the DTensor leaves' local shards included, every
    parameter a step); (b) the dry run of
    llama3.2-1b ``train_4k`` on the production meshes, started as
    subprocesses before (a) and gated after it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import LMBatchSpec, make_lm_batch
    from repro_torch.kernels.adamw import counts as adamw_counts
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.dryrun import make_act_specs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim import OptConfig, make_optimizer
    out_dir = ROOT / "build" / "dryrun_phase15"
    if out_dir.exists():
        for f in out_dir.rglob("*.json"):
            f.unlink()
    procs = start_dryruns(out_dir)
    cfg = get_config("llama3.2-1b")
    specs = model_specs(cfg)
    opt = make_optimizer(OptConfig(name="adamw", lr=3e-4))
    spec = LMBatchSpec(batch=SHARD_B, seq_len=SHARD_S,
                       vocab_size=cfg.vocab_size, seed=0)
    batches = [make_lm_batch(spec, t, "cuda") for t in range(SHARD_STEPS)]
    n_layers = len(cfg.layer_kinds)
    n_params = paramlib.param_count(specs)

    def run(mesh, mode):
        """2 steps from seed 0's parameters: (losses, params, m, v, step
        seconds, peak GiB above the run's start, launches, plain calls)."""
        sync = SyncConfig(mode=mode, remat=SHARD_REMAT)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params = paramlib.init_tree(
            specs, torch.Generator(device="cuda").manual_seed(0),
            dtype=cfg.param_dtype)
        act = None
        if mesh is not None:
            params = sh.distribute_tree(params, sh.tree_shardings(
                paramlib.axes_tree(specs), params, mesh, sync.param_rules),
                mesh)
            act = make_act_specs(mesh)
        state = opt.init(params)
        step = make_train_step(cfg, opt, sync, act_specs=act)
        losses, step_s = [], []
        ops.reset_launches()
        adamw_counts.reset()
        with plain_versions_counted(ref) as plain:
            for b in batches:
                if mesh is not None:
                    b = sh.distribute_tree(b, sh.batch_shardings(
                        {k: ("batch", "seq") for k in b}, b, mesh), mesh)
                t1 = time.perf_counter()
                params, state, m = step(params, state, b)
                loss = m["loss"]
                losses.append(float(loss.to_local() if mesh is not None
                                    else loss))
                step_s.append(time.perf_counter() - t1)
        launches = dict(ops.launches)
        if adamw_counts.elements != n_params * SHARD_STEPS:
            raise AssertionError(f"AdamW kernel updated "
                                 f"{adamw_counts.elements} elements, "
                                 f"expected {n_params * SHARD_STEPS}")
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        return (losses, params, state["m"], state["v"], step_s, peak,
                launches, dict(plain))

    try:
        ref_losses, ref_p, ref_m, ref_v, ref_s, ref_peak, _, _ = run(
            None, "datacentric")
        torch.cuda.empty_cache()
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1,
                                device_id=torch.device("cuda", 0))
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        want = {"flash_attention": n_layers * SHARD_STEPS,
                "flash_attention_bwd": n_layers * SHARD_STEPS}
        results, launches = {}, {}
        for mode in ("datacentric", "bsp"):
            losses, p, m, v, step_s, peak, launches, plain = run(mesh, mode)
            differ = {name: _leaves_equal(torch, got, w) for name, got, w in
                      (("params", p, ref_p), ("m", m, ref_m),
                       ("v", v, ref_v))}
            results[mode] = dict(losses=losses, step_s=step_s,
                                 peak_gib=peak, launches=launches,
                                 plain_version_calls=plain,
                                 leaves_differing=differ)
            del p, m, v
            torch.cuda.empty_cache()
            if losses != ref_losses or any(differ.values()):
                raise AssertionError(f"sharded {mode} step is not the "
                                     f"unsharded one: losses {losses} vs "
                                     f"{ref_losses}, leaves {differ}")
            if {k: n for k, n in launches.items() if n} != want:
                raise AssertionError(f"sharded {mode} launches {launches}, "
                                     f"expected {want}")
            if any(plain.values()):
                raise AssertionError(f"plain versions ran: {plain}")
    except BaseException:
        for p in procs.values():
            p.kill()
            p.wait()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    one_card = json.loads(finish_dryruns(procs, out_dir)["one_card"]
                          .strip().splitlines()[-1])
    del ref_p, ref_m, ref_v
    torch.cuda.empty_cache()
    print("sharded training:", json.dumps(dict(
        arch=cfg.name, layers=n_layers,
        parameters=paramlib.param_count(specs), batch=SHARD_B, seq=SHARD_S,
        remat=SHARD_REMAT, optimizer="adamw", steps=SHARD_STEPS,
        mesh="1x1 data, model (one-rank NCCL group)",
        unsharded=dict(losses=ref_losses, step_s=ref_s, peak_gib=ref_peak),
        sharded=results, bit_identical=True,
        dry_run_one_card=dict(
            mesh=one_card["mesh"], memory=one_card["memory"],
            predicted_peak_gib=one_card["memory"]["peak_bytes_per_device"]
            / 2 ** 30, measured_peak_gib={
                "unsharded": ref_peak,
                **{k: r["peak_gib"] for k, r in results.items()}},
            flops_per_device=one_card["cost"]["flops_per_device"],
            roofline=one_card["roofline"]))), flush=True)
    return {"sharded_training": launches}


# ---------------------------------------------------------------------------
# phase 16: the multi-device layer of the MoE, recurrent and vision configs
# ---------------------------------------------------------------------------

# (a) per arch: its training phase (the cut, batch and optimizer it trains
# at there), the optimizer, and the kernels a layer of each kind launches
# once a step under remat none
SHARD_ZOO = {
    "mixtral-8x7b": ("moe_training", "adamw", TRAIN_RUNS["mixtral-8x7b"][0]),
    "rwkv6-1.6b": ("rwkv6_training", "adamw", TRAIN_RUNS["rwkv6-1.6b"][0]),
    "recurrentgemma-2b": ("recurrentgemma_training", "adamw",
                          TRAIN_RUNS["recurrentgemma-2b"][0]),
    "llama-3.2-vision-11b": ("vision_training", "sgd",
                             {"attn": FLASH, "xattn": FLASH}),
}
SHARD_ZOO_STEPS = 2
# (b) the split-ring partial form at decode's shapes (B, L, H, KV, hd):
# llama3.2-1b's serving ring, recurrentgemma-2b's local heads on the
# serving ring and the 2048-slot window ring, gemma3-4b's local (1024) and
# global (2048) rings; each in bf16 and f32, the ring cut into 2 and 4
# parts; the first shape, 2 parts, bf16 is the kernels line's row
SPLIT_RING_CASES = ((8, MAIN_L, 32, 8, 64), (8, MAIN_L, 10, 1, 256),
                    (8, 2048, 10, 1, 256), (8, 1024, 8, 4, 256),
                    (8, 2048, 8, 4, 256))
SPLIT_RING_PARTS = (2, 4)
# (c) the dry run's train_4k cells on 16 x 16
ZOO_DRYRUN_CELLS = (("mixtral-8x7b", "single", "datacentric"),
                    ("rwkv6-1.6b", "single", "datacentric"),
                    ("llama-3.2-vision-11b", "single", "bsp"))


def _zoo_train_setup(torch, arch):
    """(cfg, reduced, batches, optimizer name, chunked CE) of ``arch`` at
    its training phase's cut and batch: the engine phases' TRAIN_B x
    TRAIN_S, the vision phase's VISION_TRAIN_B x VISION_TRAIN_S with media
    and the chunked cross entropy."""
    from repro_torch.configs import get_config
    from repro_torch.data import LMBatchSpec, make_lm_batch
    if arch == "llama-3.2-vision-11b":
        full = get_config(arch)
        cfg = dataclasses.replace(full, groups=(dataclasses.replace(
            full.groups[0], n=1),))
        spec = LMBatchSpec(batch=VISION_TRAIN_B, seq_len=VISION_TRAIN_S,
                           vocab_size=cfg.vocab_size,
                           media_tokens=cfg.n_frontend_tokens,
                           media_dim=cfg.d_frontend, seed=0)
        reduced, chunked = VISION_TRAIN_REDUCED, True
    else:
        cfg, reduced = train_config(arch)
        spec = LMBatchSpec(batch=TRAIN_B, seq_len=TRAIN_S,
                           vocab_size=cfg.vocab_size, seed=0)
        chunked = False
    batches = [make_lm_batch(spec, t, "cuda") for t in range(SHARD_ZOO_STEPS)]
    return cfg, reduced, batches, SHARD_ZOO[arch][1], chunked


def sharded_zoo_step(torch, ops, ref, arch, mesh) -> dict:
    """(a) for one arch: ``SHARD_ZOO_STEPS`` steps of ``steps.
    make_train_step`` (remat none, ``datacentric``) on plain tensors, its
    results moved to the host and freed, then the same steps on DTensor
    parameters placed by ``sharding.tree_shardings`` on the one-rank
    ``mesh``: loss, parameters and optimizer state bit for bit; exact
    launches a step; no plain version."""
    from repro_torch.core.sync import SyncConfig
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.dryrun import make_act_specs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.tree import tree_map
    cfg, reduced, batches, opt_name, chunked = _zoo_train_setup(torch, arch)
    specs = model_specs(cfg)
    opt = make_optimizer(OptConfig(name=opt_name, lr=3e-4))
    sync = SyncConfig(mode="datacentric", remat="none")
    kind_kernels = SHARD_ZOO[arch][2]
    want = {}
    for kind, names in kind_kernels.items():
        for k in names:
            want[k] = want.get(k, 0) \
                + cfg.layer_kinds.count(kind) * SHARD_ZOO_STEPS

    def run(mesh):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params = paramlib.init_tree(
            specs, torch.Generator(device="cuda").manual_seed(0),
            dtype=cfg.param_dtype)
        if cfg.frontend == "vision":
            _draw_gates(torch, params, cfg,
                        torch.Generator(device="cuda").manual_seed(1))
        act, bs = None, batches
        if mesh is not None:
            params = sh.distribute_tree(params, sh.tree_shardings(
                paramlib.axes_tree(specs), params, mesh, sync.param_rules),
                mesh)
            act = make_act_specs(mesh)
            axes = {k: ("batch", "seq") if v.ndim == 2
                    else ("batch", None, None) for k, v in bs[0].items()}
            bs = [sh.distribute_tree(b, sh.batch_shardings(axes, b, mesh),
                                     mesh) for b in bs]
        state = opt.init(params)
        step = make_train_step(cfg, opt, sync, act_specs=act)
        losses, step_s = [], []
        ops.reset_launches()
        with plain_versions_counted(ref) as plain:
            for b in bs:
                t1 = time.perf_counter()
                params, state, m = step(params, state, b)
                loss = m["loss"]
                losses.append(float(loss.to_local() if mesh is not None
                                    else loss))
                step_s.append(time.perf_counter() - t1)
        launches = dict(ops.launches)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        return losses, params, state, step_s, peak, launches, dict(plain)

    saved_env = os.environ.get("REPRO_CHUNKED_CE")
    if chunked:
        os.environ["REPRO_CHUNKED_CE"] = "1"
    try:
        ref_losses, p, st, ref_s, ref_peak, _, _ = run(None)
        want_p, want_st = (tree_map(lambda t: t.detach().cpu(), t)
                           for t in (p, st))
        del p, st
        losses, p, st, step_s, peak, launches, plain = run(mesh)
        differ = {"params": _leaves_equal(torch, p, want_p),
                  "opt_state": _leaves_equal(torch, st, want_st)}
        del p, st, want_p, want_st
    finally:
        if saved_env is None:
            os.environ.pop("REPRO_CHUNKED_CE", None)
        else:
            os.environ["REPRO_CHUNKED_CE"] = saved_env
    torch.cuda.empty_cache()
    row = dict(arch=arch, training_phase=SHARD_ZOO[arch][0],
               layers=len(cfg.layer_kinds), reduced=reduced,
               parameters=paramlib.param_count(specs),
               batch=[batches[0]["tokens"].shape[0],
                      batches[0]["tokens"].shape[1]],
               media=(list(batches[0]["media"].shape)
                      if "media" in batches[0] else None),
               optimizer=opt_name, chunked_ce=chunked, remat="none",
               mode="datacentric", steps=SHARD_ZOO_STEPS,
               unsharded=dict(losses=ref_losses, step_s=ref_s,
                              peak_gib=ref_peak),
               sharded=dict(losses=losses, step_s=step_s, peak_gib=peak),
               launches={k: n for k, n in launches.items() if n},
               expected_launches=want, plain_version_calls=plain,
               leaves_differing=differ)
    print("sharded zoo step:", json.dumps(row), flush=True)
    if losses != ref_losses or any(differ.values()):
        raise AssertionError(f"{arch}: the sharded step is not the "
                             f"unsharded one: losses {losses} vs "
                             f"{ref_losses}, leaves {differ}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{arch}: losses {losses}")
    if {k: n for k, n in launches.items() if n} != want:
        raise AssertionError(f"{arch}: sharded launches {launches}, "
                             f"expected {want}")
    if any(plain.values()):
        raise AssertionError(f"{arch}: plain versions ran: {plain}")
    return launches


def check_split_ring(torch, ref, gen) -> dict:
    """(b) The decode kernel's partial form over each part of a ring cut
    into ``SPLIT_RING_PARTS`` (ring masks as the engine makes them, so
    some rows have parts with no live slot): each part's (acc, l, m)
    against ``ops._decode_partial`` on the same part (acc and l at BF16_TOL
    / F32_TOL, m at F32_TOL), and ``ops.combine_parts`` of the parts
    against the whole-ring kernel (BF16_TOL / F32_TOL).  Timed: one part
    of the partial form beside the whole ring's kernel and its bound."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_partial)
    from repro_torch.kernels.ops import _decode_partial, combine_parts
    rows = []
    for B, L, H, KV, hd in SPLIT_RING_CASES:
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            tol = BF16_TOL if dt == "bfloat16" else F32_TOL
            mk = lambda s, n: torch.randn(  # noqa: E731
                (B, s, n, hd), generator=gen, device="cuda").to(dtype)
            q, k, v = mk(1, H), mk(L, KV), mk(L, KV)
            n_live = torch.randint(1, L + 1, (B,), generator=gen,
                                   device="cuda")
            n_live[0], n_live[1] = 1, L
            valid = torch.arange(L, device="cuda")[None, :] \
                < n_live[:, None]
            whole = decode_attention(q, k, v, valid)
            whole_ms = time_ms(lambda i: decode_attention(q, k, v, valid),
                               100)[0]
            for n in SPLIT_RING_PARTS:
                Lp = L // n
                got, errs = [], dict(acc=0.0, l=0.0, m=0.0)
                for i in range(n):
                    sl = slice(i * Lp, (i + 1) * Lp)
                    part = (q, k[:, sl].contiguous(), v[:, sl].contiguous(),
                            valid[:, sl].contiguous())
                    g = decode_attention_partial(*part)
                    w = _decode_partial(*part)
                    for name, a, b, t in zip(("acc", "l", "m"), g, w,
                                             (tol, tol, F32_TOL)):
                        torch.testing.assert_close(a, b, rtol=t, atol=t)
                        fin = torch.isfinite(b)
                        errs[name] = max(errs[name], (a - b)[fin].abs()
                                         .max().item() if fin.any() else 0.0)
                    got.append(g)
                o, l, m = (torch.stack(t) for t in zip(*got))
                out = combine_parts(o, l, m,
                                    lambda t: t.amax(0, keepdim=True),
                                    lambda t: t.sum(0))
                torch.testing.assert_close(out.to(dtype).float(),
                                           whole.float(), rtol=tol, atol=tol)
                err = (out.to(dtype).float() - whole.float()).abs().max()
                live = int(valid[:, :Lp].sum().item())
                need = nbytes(q, valid[:, :Lp]) + 4 * B * H * (hd + 2) \
                    + live * KV * hd * 2 * k.element_size()
                b_ms, b_by = bound(need, 4.0 * hd * H * live, dt)
                sets = rotation((q, k[:, :Lp].contiguous(),
                                 v[:, :Lp].contiguous(),
                                 valid[:, :Lp].contiguous()))
                ms = time_ms(lambda i: decode_attention_partial(
                    *sets[i % len(sets)]), 100)[0]
                rows.append(dict(
                    shape=[B, L, H, KV, hd], dtype=dt, parts=n,
                    part_slots=Lp, part_errs=errs, tolerance=tol,
                    m_tolerance=F32_TOL, combined_max_abs_err=err.item(),
                    partial_ms=ms, partial_bound_ms=b_ms,
                    partial_bound_by=b_by, whole_ring_ms=whole_ms))
                print("decode split ring:", json.dumps(rows[-1]),
                      flush=True)
                del sets
    return {"partial_ms": rows[0]["partial_ms"],
            "partial_bound_ms": rows[0]["partial_bound_ms"],
            "whole_ring_ms": rows[0]["whole_ring_ms"],
            "launches_on_one_card_paths": 0, "cases": rows}


def sharded_zoo(torch, ops, ref, gen) -> tuple[dict, dict]:
    """Phase 16: (a) the sharded train steps of mixtral-8x7b, rwkv6-1.6b,
    recurrentgemma-2b and llama-3.2-vision-11b (``sharded_zoo_step``) on a
    one-rank NCCL group and a (1, 1) ``data, model`` mesh; (b) the split
    ring's partial decode form (``check_split_ring``); (c) the dry run's
    ``ZOO_DRYRUN_CELLS``, started as subprocesses before (a) and gated
    after it.  Returns (the launches of each step's run, (b)'s row)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    out_dir = ROOT / "build" / "dryrun_phase16"
    if out_dir.exists():
        for f in out_dir.rglob("*.json"):
            f.unlink()
    procs = start_dryrun_cells(out_dir, ZOO_DRYRUN_CELLS)
    paths = {}
    try:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1,
                                device_id=torch.device("cuda", 0))
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        for arch, (phase, _, _) in SHARD_ZOO.items():
            paths[f"sharded_{phase}"] = sharded_zoo_step(
                torch, ops, ref, arch, mesh)
    except BaseException:
        for p in procs.values():
            p.kill()
            p.wait()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    split = check_split_ring(torch, ref, gen)
    finish_dryruns(procs, out_dir, ZOO_DRYRUN_CELLS)
    return paths, split


def print_ptxas(source: str, log: str) -> dict[str, tuple[int, int]]:
    """One line per compiled kernel: its entry (the mangled name without
    the anonymous-namespace prefix, so the template arguments show, e.g.
    ``Li128E`` for head dim 128), registers, shared memory and spills.
    Returns {entry: (spill store bytes, spill load bytes)}."""
    entry, spills, out = "?", "", {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = re.sub(r"^_ZN\w*?_cu_[0-9a-f]{8}\d*", "", m.group(1))
        elif "spill" in line:
            spills = line.strip()
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out[entry] = (int(m.group(1)), int(m.group(2)))
        elif "registers" in line:
            print(f"ptxas {source} {entry[:60]}: "
                  f"{line.split(':', 1)[-1].strip()}; {spills}")
    return out


def check_flash_build(torch, spills: dict) -> None:
    """Gates on the built flash-attention library: no instantiation spills
    (``spills``, ptxas' report as ``print_ptxas`` returns it), and the
    wrapper's plan states the shared memory the CUDA source launches with,
    at every head dim and both element types."""
    from repro_torch.kernels.flash_attention import kernel_smem, plan
    if not spills or any(st or ld for st, ld in spills.values()):
        raise AssertionError(f"flash_attention spills (or no ptxas "
                             f"report): {spills}")
    for dt in (torch.float32, torch.bfloat16):
        for hd in (16, 32, 64, 128, 256):
            p = plan(512, 512, 8, 2, hd, dt)
            want = {k: p[k]["smem"] for k in ("fwd", "dkdv", "dq")}
            if kernel_smem(dt, hd) != want:
                raise AssertionError(f"flash plan vs kernel smem at {dt} hd "
                                     f"{hd}: {want} {kernel_smem(dt, hd)}")
    print(f"flash ptxas: {len(spills)} kernels, no spill stores or loads; "
          "plan == kernel shared memory", flush=True)


def check_moe_build(torch) -> None:
    """Gate: the grouped FFN wrapper's plan states the shared memory,
    stages and weight columns a block that the bf16 kernels are built
    with, at every slot tile; and ``plan_bwd`` the backward blocks'
    tiles, stages, shared memory and threads, in both types."""
    from repro_torch.kernels.moe_matmul import (
        BWD_TILE_KEYS, SLOT_TILES, TC_PRODUCTS, bwd_kernel_queues,
        bwd_kernel_tiles, kernel_tiles, plan, plan_bwd)
    bwd = bwd_kernel_tiles()
    shape = (2, 1024, 8, 320, 4096, 14336)
    pb = {dt: plan_bwd(*shape, dt, 132)
          for dt in (torch.bfloat16, torch.float32)}
    tb, sw = pb[torch.bfloat16], pb[torch.float32]
    want = dict(zip(BWD_TILE_KEYS, [
        tb["tile"][k] for k in ("bm", "bn", "bk", "stages", "smem",
                                "wg_stages", "wg_smem", "threads",
                                "producer_regs", "consumer_regs")] + [
        sw["tile"][k] for k in ("bm", "bn", "bk", "smem", "threads")] + [
        tb["rows"]["threads"]]))
    queues = bwd_kernel_queues(*shape)
    if bwd != want or tb["sw"]["smem"] != bwd["sw_smem"] or queues != {
            k: tb[k]["queue"] for k in TC_PRODUCTS}:
        raise AssertionError(f"moe plan_bwd vs kernels: {want} {bwd} "
                             f"{queues}")
    built = kernel_tiles()
    for nt in SLOT_TILES:
        p = plan(1, nt, 8, nt, 4096, 14336, torch.bfloat16, 132)
        want = {k: (p[k]["smem"], p[k]["stages"], p[k]["cols"])
                for k in ("up", "down")}
        got = {k: built[(nt, k)] for k in ("up", "down")}
        if p["tile"] != nt or got != want:
            raise AssertionError(f"moe plan vs kernels at slot tile {nt}: "
                                 f"{want} {got}")
    print(f"moe_grouped_ffn plan == kernel shared memory, stages and "
          f"columns at slot tiles {list(SLOT_TILES)}; plan_bwd == the "
          f"backward's tiles {json.dumps(bwd)}", flush=True)


def check_wkv_build() -> None:
    """Gate: the WKV wrapper's plan states the chunk and, for every kernel,
    the shared memory, threads and slice width the built library has, at
    both head dims."""
    from repro_torch.kernels.rwkv6_scan import KERNELS, kernel_tiles, plan
    for hd in (16, 64):
        built, p = kernel_tiles(hd), plan(*WKV_MAIN[:3], hd)
        want = {k: (p[k]["smem"], p[k]["threads"], p[k]["width"])
                for k in KERNELS}
        if built != dict(chunk=p["chunk"], **want):
            raise AssertionError(f"rwkv6 plan vs kernels at hd {hd}: "
                                 f"{want} chunk {p['chunk']}; {built}")
    print(f"rwkv6_scan plan == kernels: chunk {p['chunk']}, "
          f"{json.dumps(want)}", flush=True)


def check_lru_build(torch) -> None:
    """Gate: the RG-LRU wrapper's plan states the chunk and, for each
    direction, the shared memory, threads, chunk slots, lanes, channels a
    thread and the backward's piece the built library launches with, at
    the training shape (bf16), the smoke config's (f32, 96 tokens), ragged
    T 513 and 4096 tokens (windows of the block's chunks), and prints the
    blocks resident on an SM."""
    from repro_torch.kernels.rglru_scan import (kernel_tiles, plan,
                                                resident_blocks)
    for T, dt in ((LRU_MAIN[1], torch.bfloat16), (96, torch.float32),
                  (513, torch.float32), (4096, torch.bfloat16)):
        p, built = plan(4, T, LRU_MAIN[2], dt), kernel_tiles(T, dt)
        want = dict(chunk=p["chunk"], **{
            d: dict(smem=p[f"smem_{d}"], threads=p["threads"],
                    slots=p["slots"], lanes=p["lanes"], vec=p["vec"],
                    sub=p["sub"]) for d in ("fwd", "bwd")})
        if built != want:
            raise AssertionError(f"rglru plan vs kernels at T {T} {dt}: "
                                 f"{want}; {built}")
    resident = resident_blocks(LRU_MAIN[1], torch.bfloat16)
    print(f"rglru_scan plan == kernels: chunk {want['chunk']}, "
          f"{json.dumps(want['bwd'])}; bf16 blocks resident an SM at the "
          f"training shape (fwd, bwd) {resident}", flush=True)


def check_no_spill(spills: dict, sources: tuple) -> None:
    """Gate: ptxas reported every kernel of ``sources`` and none spills."""
    for name in sources:
        sp = spills.get(name, {})
        if not sp or any(st or ld for st, ld in sp.values()):
            raise AssertionError(f"{name} spills (or no ptxas report): {sp}")
        print(f"{name} ptxas: {len(sp)} kernels, no spill stores or loads",
              flush=True)


# (B, S, H, KV, hd) of the batch-invariance gate: llama3.2-1b's and
# recurrentgemma-2b's training shapes
FLASH_INVARIANCE = ((4, 512, 32, 8, 64), (4, 512, 10, 1, 256))


def check_flash_batch_invariance(torch, gen) -> None:
    """Each batch row alone gives the bits it gives inside the batch,
    forward and backward, bf16: the kernels' tiles and split come from a
    plan that never reads B, and the serving engine's continuous ==
    static gate relies on it."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd)
    for B, S, H, KV, hd in FLASH_INVARIANCE:
        mk = lambda n: torch.randn((B, S, n, hd), generator=gen,  # noqa
                                   device="cuda").to(torch.bfloat16)
        q, k, v, do = mk(H), mk(KV), mk(KV), mk(H)
        o, lse = flash_attention(q, k, v, with_lse=True)
        grads = flash_attention_bwd(q, k, v, o, do, lse)
        for b in range(B):
            one = [t[b:b + 1] for t in (q, k, v, do)]
            o1, lse1 = flash_attention(*one[:3], with_lse=True)
            g1 = flash_attention_bwd(*one[:3], o1, one[3], lse1)
            same = [torch.equal(o[b:b + 1], o1),
                    torch.equal(lse[b:b + 1], lse1)]
            same += [torch.equal(g[b:b + 1], x) for g, x in zip(grads, g1)]
            if not all(same):
                raise AssertionError(f"flash attention not batch-invariant "
                                     f"at {(B, S, H, KV, hd)} row {b}: "
                                     f"(o, lse, dq, dk, dv) {same}")
        print("flash batch invariance:", json.dumps(dict(
            shape=[B, S, H, KV, hd], rows=B, bit_identical=True)),
            flush=True)


def server_processes_stopped() -> None:
    """Phase 11's last gate: with the server phases done, the shard
    clusters' forkserver and resource tracker stop (``stop_forkserver``,
    which also runs at exit) and no process this script started is left:
    no shard alive and no child of this process in the process table."""
    from repro_torch.pdb.server import cluster
    cluster.stop_forkserver()
    shards = [p.pid for p in cluster._shards if p.is_alive()]
    me = str(os.getpid())
    children = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[1] == me and fields[0] != "Z":
            children.append(int(stat.parent.name))
    if shards or children:
        raise AssertionError(f"processes left after the server phases: "
                             f"shards {shards}, children {children}")
    print("server processes stopped:", json.dumps(dict(
        shards_alive=0, children_alive=0)), flush=True)


def main() -> int:
    # deterministic cuBLAS for the engine's bit-identity checks: read when
    # the first cuBLAS handle is made, so it is set before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # the caching allocator grows segments in place instead of splitting
    # fixed ones: mixtral-8x7b's training phase peaks at ~71 of the card's
    # 79 GiB, and after the earlier phases the fixed segments left 27 GiB
    # reserved in pieces too small for its 6.38 GiB packed row (read when
    # CUDA starts)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build, ops, ref
    except ImportError as e:
        print(f"chip_smoke: the port's sources are missing ({e})",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = smi()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" x{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"kernel build {time.perf_counter() - t0:.2f} s wall; per source "
          f"{json.dumps(secs)}", flush=True)
    spills = {}
    for name in _build.SOURCES:
        log = _build.library_path(name).with_name(
            _build.library_path(name).name + ".log")
        if log.exists():
            spills[name] = print_ptxas(name, log.read_text())
    check_flash_build(torch, spills.get("flash_attention", {}))
    check_no_spill(spills, ("decode_attention", "prefill_page_attention",
                            "moe_grouped_ffn", "rwkv6_scan", "rglru_scan"))
    check_moe_build(torch)
    check_wkv_build()
    check_lru_build(torch)

    gen = torch.Generator(device="cuda").manual_seed(0)
    phase_s = {}

    def timed(name, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t1
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    results = {name: timed(name, fn, *args) for name, fn, args in (
        ("flash_attention", check_flash, (torch, F, ref, gen)),
        ("page_gather", check_page_gather, (torch, ref, gen)),
        ("decode_attention", check_decode, (torch, F, ref, gen)),
        ("ring_gather", check_ring_gather, (torch, ref, gen)),
        ("flash_attention_bwd", check_flash_bwd, (torch, F, ref, gen)),
        ("prefill_page_attention", check_prefill_page_attention,
         (torch, F, ref, gen)),
        ("moe_grouped_ffn", check_moe_grouped_ffn, (torch, F, ref, gen)),
        ("moe_grouped_ffn_bwd", check_moe_grouped_ffn_bwd,
         (torch, F, ref, gen)),
        ("rwkv6_scan", check_rwkv6_scan, (torch, ref, gen)),
        ("rwkv6_scan_bwd", check_rwkv6_scan_bwd, (torch, ref, gen)),
        ("rglru_scan", check_rglru_scan, (torch, ref, gen)),
        ("rglru_scan_bwd", check_rglru_scan_bwd, (torch, ref, gen)))}
    # serving's forms of the recurrences, from a carried state
    stateful = {"rwkv6_scan": timed("rwkv6_stateful", check_rwkv6_stateful,
                                    torch, ref, gen),
                "rglru_scan": timed("rglru_stateful", check_rglru_stateful,
                                    torch, ref, gen)}
    timed("flash_batch_invariance", check_flash_batch_invariance, torch, gen)
    timed("adamw", check_adamw, torch, gen)
    timed("small_end_to_end", small_end_to_end, torch)
    paths, static_outputs = timed("full_width_serving", full_width, torch,
                                  ops, ref)
    torch.cuda.empty_cache()
    timed("small_moe", small_moe, torch)
    paths["moe_serving"] = timed("moe_serving", moe_serving, torch, ops, ref)
    timed("small_recurrentgemma_serving", small_recurrent, torch)
    paths.update(timed("recurrentgemma_serving", recurrent_serving, torch,
                       ops, ref))
    paths["rwkv6_serving"] = timed("rwkv6_serving", rwkv6_serving, torch,
                                   ops, ref)
    timed("small_training", small_training, torch, "llama3.2-1b")
    paths["training"], train_losses = timed(
        "full_width_training", full_width_training, torch, ops, ref,
        "llama3.2-1b")
    timed("small_rwkv6_training", small_training, torch, "rwkv6-1.6b")
    paths["rwkv6_training"], _ = timed("rwkv6_training", full_width_training,
                                       torch, ops, ref, "rwkv6-1.6b")
    timed("small_recurrentgemma_training", small_training, torch,
          "recurrentgemma-2b")
    paths["recurrentgemma_training"], _ = timed(
        "recurrentgemma_training", full_width_training, torch, ops, ref,
        "recurrentgemma-2b")
    timed("small_moe_training", small_training, torch, "mixtral-8x7b")
    paths["moe_training"], _ = timed("moe_training", full_width_training,
                                     torch, ops, ref, "mixtral-8x7b")
    _, real_xy = timed("paper_regression", paper_regression, torch)
    timed("server_regression", server_regression, torch, *real_xy)
    del real_xy
    torch.cuda.empty_cache()
    paths["serve_while_train"] = timed(
        "serve_while_train", serve_while_train, torch, ops, ref,
        static_outputs, paths["serving"])
    paths["server_training"] = timed(
        "server_training", server_training, torch, ops, ref,
        train_losses[0])
    paths.update(timed("dense_decode_and_remat", dense_decode_and_remat,
                       torch, ops, ref))
    for arch in ZOO_TEXT:
        paths.update(timed(f"{arch}_serving", zoo_text_serving, torch, ops,
                           ref, arch))
    paths.update(timed("vision_serving", zoo_vision, torch, ops, ref))
    paths.update(timed("gemma3_training", gemma3_training, torch, ops, ref))
    timed("small_vision_training", small_vision_training, torch, ops)
    paths.update(timed("vision_training", vision_training, torch, ops, ref))
    paths.update(timed("sharded_training", sharded_training, torch, ops,
                       ref))
    zoo_paths, split = timed("sharded_zoo", sharded_zoo, torch, ops, ref,
                             gen)
    paths.update(zoo_paths)
    results["decode_attention"].update(partial_ms=split["partial_ms"],
                                       split_ring=split)
    timed("server_processes_stopped", server_processes_stopped)
    print("phase seconds:", json.dumps(dict(
        phase_s, total=time.perf_counter() - t0)), flush=True)

    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:86",
                "page_gather": "src/repro/kernels/page_gather.py:35",
                # with the two page_gather calls before it
                # (src/repro/kernels/page_gather.py:35), read in place
                "decode_attention": "src/repro/kernels/decode_attention.py:70",
                "ring_gather": "src/repro/kernels/ring_gather.py:36",
                # the gradient of the kernel above: the TPU package has
                # none and trains through autodiff of its plain attention
                "flash_attention_bwd":
                    "src/repro/kernels/flash_attention.py:86",
                "prefill_page_attention":
                    "src/repro/kernels/page_gather.py:107",
                "moe_grouped_ffn": "src/repro/kernels/moe_matmul.py:64",
                # the gradient of the kernel above: the TPU package has
                # none and trains through autodiff of its plain version
                "moe_grouped_ffn_bwd": "src/repro/kernels/moe_matmul.py:64",
                "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:54",
                # the gradient of the kernel above: the TPU package has
                # none and trains through autodiff of its plain recurrence
                "rwkv6_scan_bwd": "src/repro/kernels/rwkv6_scan.py:54",
                "rglru_scan": "src/repro/kernels/rglru_scan.py:44",
                # the gradient of the kernel above: the TPU package has
                # none and trains through autodiff of its plain recurrence
                "rglru_scan_bwd": "src/repro/kernels/rglru_scan.py:44"}
    # page_gather is on no path since decode reads the pages in place:
    # its row stays, with 0 launches
    own_path = {"flash_attention": "serving", "page_gather": None,
                "decode_attention": "serving", "ring_gather": "training",
                "flash_attention_bwd": "training",
                "prefill_page_attention": "chunked_serving",
                "moe_grouped_ffn": "moe_serving",
                "moe_grouped_ffn_bwd": "moe_training",
                "rwkv6_scan": "rwkv6_training",
                "rwkv6_scan_bwd": "rwkv6_training",
                "rglru_scan": "recurrentgemma_training",
                "rglru_scan_bwd": "recurrentgemma_training"}
    kernels = []
    for name, row in results.items():
        source = name.removesuffix("_bwd")
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{source}.cu",
            replaces=replaces[name], path=own_path[name],
            launches=paths[own_path[name]][name] if own_path[name] else 0,
            launches_by_path={p: c[name] for p, c in paths.items()},
            max_abs_err=row["max_abs_err"], tolerance=row["tolerance"],
            ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            host_ms=row["host_ms"], shape=row["shape"],
            **{k: row[k] for k in ("hd128", "hd256", "gemma3", "group1",
                                   "xattn", "xattn_bwd",
                                   "shapes", "edge_cases",
                                   "library", "serial_steps", "state_bytes",
                                   "checkpoint_bytes", "chunk", "threads",
                                   "gathered_ms", "gathered_pair_ms",
                                   "gathered_plain_ms", "gathered_bound_ms",
                                   "partial_ms", "split_ring")
               if k in row},
            **({"stateful": stateful[name]} if name in stateful else {})))
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
