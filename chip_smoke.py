#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (paddle_tpu_torch) on one
card. Run from the repository root:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device line: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; build every kernel from csrc/ (one nvcc per source,
   in parallel — set-up time).
2. Kernels at the serving shape (M=8, K=768, N=50304) and three ragged
   shapes (K not a multiple of 16, K in segments, 17 x rows, N one past
   a table tile): B7 `dequant_matmul` against its plain version (rtol=
   atol=1e-5, f32, TF32 off), B8 `w8a8_matmul` bitwise in both table
   layouts; both repeating bit for bit at the serving shape, and their
   registers and blocks per SM there. Times (CUDA events, median of 50
   launches, L2 flushed before each) of the kernel, its plain version
   and the one-call PyTorch yardstick where one exists, beside the
   card's least time for the same bytes and operations.
3. The slice against its plain version: a tiny GPT with the same
   weights on cuda and on the CPU, three pinned prompts through the
   int8 and the w8a8 engines; greedy tokens must agree.
4. Full width: gpt2-small (vocab 50304, hidden 768, 12 layers, 12
   heads, max_seq_len 1024), random weights from seed 0, served by
   `Server(mode="generate")` with max_slots=8, block_size=16,
   prefill_chunk=64 in three legs (f32, int8, w8a8): 16 greedy
   requests, prompt lengths 32-256 from a seeded RNG, half of them
   sharing a 64-token prefix, 32 new tokens each. Kernel launch counts
   are set to 0 just before each leg and read just after it. After each
   leg (here and in 24-27) `Server.metrics_prometheus()` must parse as
   exposition text with the snapshot's served tokens, and the engine
   must end at `compile_counts` {"decode": 1, "cow": 1} (with "draft": 1
   when speculating) and compile nothing in a second `warmup()`.
5. Where a decode step's time goes: host step time, device kernel time
   and launches per step of the w8a8 engine, and the LM head's kernel
   time by name (B8 `w8a8_stream` must show), from the port's profiler
   (`profiler.start_trace` / `device_op_table`, torch.profiler
   underneath).
6. Flash attention: B1-B3 against their plain versions (f32 and bf16 at
   ragged shapes, sq != sk, head dims 32 / 64 / 128, causal and not; the
   ERNIE shape [32, 12, 512, 64] in f32 and bf16 with dropout 0.1; the
   Transformer-base shapes of 41-42: [24, 8, 128, 128, 64] in bf16 with
   dropout 0.1 and one query row against 1, 37 and 128 keys in f32 and
   bf16; the hybrid GPT's causal f32 calls of 48-49: [16, 16, 512, 64]
   at dropout 0.1 and 0, and the local shapes of 49's factorizations
   (8 heads, 8 rows, 4-row micro-batches); the dropout mask bit for bit; in bf16 B1-B3 run on the tensor
   cores), B2
   repeating bit for bit at the ERNIE shape, the registers and blocks
   per SM of every pass, then timed at the
   ERNIE shape in bf16 beside the plain versions, torch SDPA at dropout
   0 and 0.1 (the yardstick, never called by the port; the backend it
   ran is printed) and the card's least time.
7. The fused LM-head loss: B4-B6 against their plain versions (f32 at
   ragged shapes with vocab tails, heavy masking, every row ignored and
   plain chunks that do not divide V, within 1e-5; the ERNIE shape
   x [16384, 768], w [18000, 768] in bf16 within one bf16 ulp on dx and
   dw and 1e-3 relative on the loss, nll and lse within 1e-4; bf16 at
   ragged shapes with exact scores, B4 within 1e-4 and B5 / B6 within
   one bf16 ulp; B4 on warpgroup products in bf16 at every hidden size,
   B5 and B6 up to H 768), B4-B6 repeating bit for bit at the ERNIE
   shape, the registers and blocks per SM of every kernel, then timed at
   the ERNIE shape beside the plain versions, the library yardsticks
   (never called by the port: the unfused two-call composition for
   B4 / B6, and for B5 the same composition's backward asked for dx
   alone) and the card's least time.
8. The train step against its plain version: a tiny ERNIE on cuda and
   on the CPU, same weights and seeds, attention dropout 0.1,
   FLAGS_use_fused_lm_loss on (the cuda run goes through B1-B6); three
   AdamW losses agree.
9. Full width: ERNIE-1.0 pretraining as bench.py configures it (b32 x
   s512, dropout 0.1, bf16 auto_cast, AdamW) with
   FLAGS_use_fused_lm_loss on, its default; 10 timed steps with step
   time, tokens/s, MFU, peak memory, 12 launches per step of each of
   B1, B2, B3 and 1 of each of B4, B5, B6.
10. Where a train step of that leg goes, from the port's profiler: the
    device time a step by bucket (`observe.classify_kernel`: matmul,
    attention, collective, elementwise, other) with the kernel ids and
    library families under each, and the host<->device copies. The
    timed steps of 9 and the profiled ones run under
    `observe.no_retrace()`, and each training leg records exactly one
    ``train_step`` compile (its first warm-up step).
11. The same at the same width with the flag off (the tied bf16 matmul
    and an f32 cross_entropy over [16384, 18000] logits), for
    comparison, profiled as in 10 (the device time of the two legs is
    the comparison that repeats; the host clock varies between runs):
    its peak memory must be above the fused leg's.
12. recompute=True at full width, 3 steps: the losses equal the fused
    leg's first three (same seeds), and its peak memory.
13. Low-precision training against its plain version: the tiny ERNIE
    of 8 under FLAGS_lowp_matmul int8 and fp8, cuda against the CPU:
    losses within 2e-3 / 1e-2, the ScaleState's scales within 1e-3 /
    2e-2 and its counters equal, exactly the derived B9 launches.
14. Full width under FLAGS_lowp_matmul int8 and fp8 (delayed scaling):
    the leg of 9 with every Linear and every loss score chunk on B9;
    exactly the B9 launches derived from the model (69 a step), none of
    B4, 12 of each of B1-B3 and 1 of B5 / B6; every loss within rtol
    0.2 of the flag-off leg's (bench.py --lowp's gate); the ScaleState's
    clip rate and updates; the int8 leg profiled as in 10.
15. B9 against its plain version at every distinct call of that step
    (recorded from the int8 leg) and at ragged shapes, int8 bit for bit
    and fp8 within 4 K 2^-24 of the sum of the absolute products, then
    timed beside the plain version, the library yardstick (torch._int_mm
    or torch._scaled_mm with the same quantization; never called by the
    port) and the bound, each call's device time split by kernel into its
    quantise passes and its GEMM (torch.profiler's kernel events); summed
    over a step's calls; the GEMM's registers and blocks per SM.
16. The fused leg again with the flag off: its first three losses equal
    the fused leg's, and no lowp stat moved.
17. B10, the fused conv: the distinct convs of one ResNet-50 training
    step and one eval forward at batch 128 (bf16 under O1; the forward
    with the moments epilogue, the dx parity planes with none, the eval
    forward with the affine one, with and without the residual), each
    against its plain version (bf16 y within one bf16 ulp, the moments
    within 1e-4; f32 at three of them, within 1e-5 of the largest
    element, K up to 4608), then timed beside the plain version, cuDNN's
    bf16 F.conv2d on the same NCHW operands (the yardstick, never
    called by the port) and the bound; summed over a step's launches,
    in all and by class (1x1 / 3x3 at stride 1 and 2, the stem, the dx
    parity planes); the registers and blocks per SM of the bf16 kernel
    at each of its three tile widths.
18. A tiny ResNet-18 and a narrow bottleneck ResNet-50 on cuda against
    the same models on the CPU: eval logits, one Momentum step's loss,
    and each parameter's and running stat's change over the step.
19. Full width: ResNet-50 as bench.py trains it (s2d stem, b128 x 224,
    bf16 auto_cast, Momentum 0.1 / 0.9, weight decay 1e-4, bench's
    synthetic batch), 2 warm-up and 10 timed steps: finite losses and
    exactly the B10 launches derived from the model (114 a step), step
    time, images/s, MFU (bench.py's FLOP count), peak memory.
20. Where that step's time goes, as in 10.
21. model.eval() forwards at b128: the affine epilogue, 53 B10 launches
    a forward, images/s.
22. Checkpointing, leg A, resume after a preemption: the ERNIE-1.0 leg
    of 9 through `distributed.checkpoint.train_epoch_range` (async saves,
    max_to_keep 2, epochs of 2 steps) with FLAGS_simulate_preempt_at_step
    2: an emergency checkpoint, the PREEMPTED marker and PreemptedError;
    an engine of other seeds resumes at epoch 2, and the 8 losses repeat
    the fused leg's first 8 within rtol 1e-5. Bytes on disk per
    checkpoint, the snapshot's ms on the step thread, the background
    write's seconds, restore and verify seconds, whether the replay was
    bit for bit, B1-B6 launches over the leg.
23. Checkpointing, leg B, the anomaly guard's rollback: the ResNet-50
    leg of 19, guarded (FLAGS_anomaly_max_bad_steps 2, a read every
    step), 2 steps, a checkpoint, 2 steps poisoned by
    ``train.batch@3-4:nan``: one rollback to step 2, every restored leaf
    hashing to the manifest, 2 replayed steps within rtol 1e-5 of a
    clean guarded run; the rollback's ms, the guarded step's p50 beside
    an unguarded engine's timed in turns with it (and beside the
    unguarded p50 of 19), B10 launches over the leg. Both legs write
    into one temporary directory (~3.7 GB at the peak) that is removed
    at the end.

24-28 run after 5, on phase 4's gpt2-small, 16 prompts and server
shape, each leg's B7 / B8 counts set to 0 just before it and read just
after it:
24. The bf16 KV pool: the f32 and int8 legs with
    ``cache_dtype=torch.bfloat16``; the pool exactly half of phase 4's
    bytes; token agreement with phase 4's same leg. Then the bf16 pool's
    cost: an f32-pool and a bf16-pool engine decoding the same 8 slots,
    timed in turns on the host clock, each profiled for its device time
    and launches a step.
25. Speculative decoding, self-draft, k = 3, in the f32, int8 and w8a8
    legs: every leg drafts (rounds and drafted tokens above 0, no draft
    fault) and takes fewer steps than phase 4's; f32 and int8 accept
    every drafted token; the int8 leg's tokens bit for bit phase 4's,
    exactly 2 B7 launches a step (the last rows' head and the verify
    head over 8 x 4 rows; the w8a8 leg 2 of B8); acceptance, steps,
    tokens/s, step p50 / p99. Beside it, B7 and B8 at the verify head's
    32 rows against their 8-row calls (bit for bit) and their plain
    versions, both timed, and the launch grid each ran (from the
    profiler's trace): its y extent is the number of x tiles, each of
    which streams the whole table.
26. Batched LoRA: the int8 engine with 4 adapters of rank 8; the
    adapter-0 half of the prompts bit for bit phase 4's int8 leg, each
    adapter request's first-step logits within 1e-4 of B7's plus the
    plain delta; a second bank swapped in mid-traffic (no request
    fails, every later first step held to the new bank).
27. The SSD spill tier and KV migration (int8 engine): turn 1 on 8
    prompts of 256 tokens spilled to a temporary directory at drain,
    turn 2 extending each sequence restored from disk (every spilled
    block, no spill error) and bit for bit a cold engine's tokens (record bytes, restore ms, the re-prefill ms
    it saved); then an engine's cached prefixes exported, adopted by a
    second engine through a `KVMailbox`, and both continuations equal.
28. Batch mode: `Server(mode="batch", max_batch=32)` over ERNIE-1.0
    sequence classification (bench.py's widths, 2 classes, eval, bf16
    O1 entered by the batch function on the batcher's thread, s 512):
    the ladder 1-32 warmed, 64 samples from 8 threads; exactly 12 B1
    launches a forward; each output bit for bit its padded bucket's
    direct forward and within 2^-4 of the sample's bucket-1 forward;
    requests/s, occupancy, latency p50 / p99.

29-32 run right after 27, on the same gpt2-small, the fleet's replicas
built as recording engines (each keeps per prompt the logits row behind
each greedy pick, counts its steps and its B7 / B8 head calls); the B7 /
B8 counts are set to 0 just before each leg and read just after it, and
every leg of 29 and 30 holds B7 launches == steps + (re)builds exactly
(each build warms up with one B7 launch, each step launches one), with
two replica threads launching at once:
29. The fleet: `Router(replicas=2)` of int8 replicas (phase 4's engine
    settings, least-loaded placement) serves phase 4's 16 prompts; the
    tokens are held to one recording engine of phase 4's int8 leg under
    phase 3's near-tie rule; tokens/s of one replica and of two. Then a
    crash (``serving.replica_heartbeat[fleet.r0]@4:raise`` kills r0's
    thread mid-flight) and a hang (r0's third step sleeps 4 s, past the
    2 s liveness timeout): every request resolves exactly once, at
    least one is replayed, r0 is rebuilt; the abandoned engine is
    collected once its thread wakes and exits, and
    ``torch.cuda.memory_allocated()`` then is within one replica's KV
    pool and weight copy of its value before the kill (all three
    printed). Then `add_replica` under load (the newcomer steps) and
    `remove_replica(drain=True)` under load, nothing lost or duplicated.
30. Disaggregated prefill/decode on the w8a8 leg (a prefill replica of
    prefill_chunk 256, a decode replica of 16): B8 on both roles, the
    B7 / B8 counts equal to the two engines' head calls, every decode
    leg adopting migrated KV (16 migrations, no fault). Then a real
    `Autoscaler.tick` grows a one-replica int8 fleet under a backlog of
    16 requests and, after a quiet cooldown, one shrinks it again.
31. Rollout: v1 (phase 4's weights plus seeded noise, frozen int8) saved
    with `save_state`, loaded by `WeightRegistry.load_dir`; its golden
    chain launches B7 exactly 24 times (4 prompts x 6 tokens); each
    golden prompt's smallest top-2 margin and largest logit gap to the
    canary's served decode are printed; `RolloutController` rolls two
    int8 replicas from v0 to v1 under traffic and commits,
    `version_info()` shows v1 on both, a spilled v0 record is fenced; a
    v2 whose golden digests were made from other values is refused by
    the gate and the rollback serves v1's tokens bit for bit.
32. Tenancy: `Server(replicas=2, tenancy=...)` behind `http_front`, two
    tenants weighted 3:1, "b" budgeted at 150 tokens/s; a seeded
    `Scenario.swing` trace (tenant mix, shared 16-token user prefixes)
    replayed open loop, every other arrival through ``POST
    /v1/generate`` with ``X-Tenant``: every arrival resolves (tokens or
    a typed shed of "b"), at least one HTTP 429 carries "b"'s own
    Retry-After; each tenant's share of tokens, e2e p50 / p99 and
    ``GET /v1/version`` are printed.

33-36 read the runtime's own telemetry (observe/, profiler/):
33. Right after 10: `Engine.attribute_step(steps=3)` on the fused
    leg's engine (bf16 auto_cast, under `observe.no_retrace()`) and
    `overlap_report(steps=1)`: the five buckets in ms a step and the top
    rows. Gates: B1-B3 in attention and B4, B5 / B6 in matmul with
    exactly 12 / 12 / 12 / 1 / 2 launches a step; "other" holds no
    hand-written kernel; the bucket total within 3% of 10's counted
    rows (its busy time less its host copies); no collective time.
34. Right after 20, the same on the ResNet-50 engine: B10 in matmul
    with exactly its derived launches, the total within 3% of 20's.
35. In 29-32: `Router.compile_counts()` gives every live replica
    {"decode": 1, "cow": 1}; in 32, `metrics_prometheus()` parses as
    exposition with one ``paddle_serving_replica_state`` gauge per
    replica, and `http_front`'s ``/metrics`` asked for ``text/plain``
    serves the same families.
36. After 22-23 (the step timeline emptied before them): `goodput()`,
    whose checkpoint and restore seconds, the async writes' overlapped
    seconds and the productive seconds must be above 0.

37-40 run last, on gpt2-small at full width (vocab 50304, hidden 768, 12
layers, 12 heads, max_seq_len 1024, dropout 0.1 / 0.1, use_parallel
False), random weights from seed 0 that every leg starts from, b8 x
s1024 of seeded random tokens, bf16 O1; B1-B3 run causal. Each leg's
B1-B3 counts are set to 0 just before it and read just after it:
37. The train step as bench_attrib.py configures it: `Engine` with
    AdamW 1e-4, weight decay 0.01, `GPTPretrainingCriterion`; 2 warm-up
    and 10 timed steps on a fixed batch: exactly 12 launches a step of
    each of B1-B3, finite and falling losses, step p50 / p90, tokens/s,
    MFU (6 P + 12 L H S flops a token at the bf16 peak),
    `memory_analysis()` (peak > arguments > 0) and one
    `attribute_step` (B1-B3 in attention with 12 launches each).
38. recompute=True under FLAGS_remat_policy full, dots_saveable and
    none, 3 steps each: B1 24 a step under full and dots_saveable (the
    flash forward is replayed), 12 under none, B2 / B3 12; the first
    loss bit for bit equal in all three and to 37's; the step's peak
    memory ordered full < dots_saveable < none.
39. SGD, Adamax, Adagrad, Adadelta, RMSProp (centered, momentum 0.9),
    LarsMomentum, Lamb, Adam with L1Decay and a ParamAttr (lr 0.5,
    L2Decay 1e-4) on the embeddings, AdamW(lr_ratio=), Momentum with
    ClipGradByValue / ClipGradByNorm and a need_clip=False parameter: 3
    Engine steps each at full width (finite losses, 12 launches a step
    of each of B1-B3), then a tiny GPT taking the same 3 steps on the
    card and on the CPU in f32: losses within rtol 1e-5, each update
    within 1e-4 of the CPU's in norm (the rules that normalise the
    gradient turn rounding-level gradients into steps of up to lr).
40. (a) The eager loop ``loss.backward(); opt.step(); opt.clear_grad()``
    for 3 steps: its first loss bit for bit 37's. (b)
    `paddle_tpu_torch.Model` (AdamW on a cosine schedule, the criterion,
    `Accuracy(topk=(1, 5))`, amp O1): `fit` over 96 sequences (12
    steps, 2 loader workers, every batch arriving on the card) with 16
    evaluation sequences and the `ModelCheckpoint` and `LRScheduler`
    callbacks, `evaluate`, `save`, `load` into a fresh model and
    `evaluate` again, bit for bit the same; B1-B3 12 a training step
    (and B1 12 an evaluation batch); the fit's steps/s and the
    DataLoader's share of its host time.

41-43 run last, on Transformer-base (Vaswani et al. 2017, Table 3)
built in this script from public nn pieces: `nn.Transformer()` at its
defaults (d_model 512, 8 heads, 6 + 6 layers, FFN 2048, dropout 0.1,
ReLU, post-LN), one `nn.Embedding(37000, 512)` shared by source, target
and the pre-softmax projection, sinusoidal positions; weights from seed
0 (63 M parameters). B1-B3 counts are set to 0 just before each leg and
read just after it:
41. Training through `Engine.train_batch((src, tgt_in), (tgt,))`: the
    label-smoothed (0.1) soft-label cross entropy, Adam(0.9, 0.98, 1e-9)
    on NoamDecay(512, 4000), bf16 O1, 24 x 128 source and target tokens;
    2 warm-up and 10 timed steps: exactly 12 launches a step of each of
    B1-B3 (6 encoder self-attentions and 6 cross-attentions; the masked
    decoder self-attention takes the plain path), finite losses, the
    batch's eval-mode loss lower after the steps than before, one
    train_step compile; step p50 / p90, target tokens/s, device busy and
    idle share, peak memory, the profile and `attribute_step`'s buckets
    (their total within 6% of the profile's: two captures of this
    host-bound step differ by up to ~4% in device time).
42. Cached greedy decoding in eval: 8 sources of 128 tokens, 32 steps
    through `TransformerDecoder.gen_cache` / ``cache=`` (B1 at one query
    row against the growing self-attention keys and the 128 memory
    keys: exactly 6 + 12 a step). In f32 each step's logits within rtol
    / atol 1e-3 of the uncached forward over the same prefix (float
    causal mask, zero memory mask: the plain masked path) and token
    agreement 1.0; in bf16 O1 the agreements printed.
43. The nn sweep: every case of tests/torch_nn_cases.py (every public
    function of nn.functional and every layer class) on cuda against
    the same call on CPU tensors in f32, forward and backward (outputs,
    input and parameter gradients, the state after the call) within
    rtol 1e-4 / atol 1e-5; the random ops by their properties; LSTM,
    GRU and SimpleRNN (2 layers, bidirectional, hidden 256, b 16 x 64
    steps) within 1e-4; BeamSearchDecoder against brute force. Prints
    how many names were swept.

47-49 run last, distributed training on ``torch.distributed``:
47. The collectives over NCCL at world size 1 (`init_parallel_env(
    backend="nccl")` through a ``file://`` store): every call of
    `distributed.collective` once on CUDA tensors (all_reduce under each
    op, all_gather, all_gather_object, broadcast, reduce, reduce_scatter,
    scatter, alltoall, send / recv to itself in one batch_isend_irecv,
    barrier, wait), each leaving its input (a world of one) and nothing
    staged through the host; NCCL's version and each call's ms.
48. The hybrid GPT at world size 1 through `fleet.init` and
    `make_gpt_hybrid_engine`, as bench.py:445-447 configures it on a
    chip (b16 x s512, hidden 1024, 8 layers, 16 heads, vocab 50304,
    use_parallel and sequence_parallel on, SGD 0.01, weights from seed
    7, f32, dropout 0 and attention dropout at its default 0.1). First a
    reference pass of 2 steps at attention dropout 0, which 49 must
    repeat (its losses, and a set of parameters before and after).
    Then 2 + 8 steps, exactly 8 launches a step of each of B1-B3, step p50,
    tokens/s, MFU, the profile's busy time and idle share,
    `attribute_step`, peak memory; then the same engine from the same
    weights under FLAGS_lowp_matmul int8 and fp8 (bench.py:620-670 at
    this width): exactly 33 launches a step of B9 (the four linears of
    each block and the tied head), finite losses; then B9 against its
    plain version at every distinct call of the int8 step (f32
    activations at K 1024, the tied head's ``w.t()``, dynamic scales),
    int8 bit for bit and fp8 within the bound of 15.
49. Several ranks on this card over gloo, each a process on cuda:0 that
    loads the kernels 1 built: 2 ranks (dp2, mp2 with sequence
    parallelism, pp2 over 4 micro-batches, sharding2 under ZeRO 1, 2, 3
    and 3 with offload) and 4 ranks (dp2.mp2, pp2.mp2 with sequence
    parallelism, mp2.sharding2.z2) at 48's width from 48's initial
    weights at attention dropout 0, 2 steps each: losses within the
    sweep's rtol of 48's reference pass (2e-4; 1e-3 with pp), each
    parameter of a set gathered back (`weights.gather_values`) changed
    as in that pass (within 1e-3 of the change's largest element, or 4
    float32 spacings of the parameter's largest magnitude), every rank's B1-B3
    launches exactly as derived (8 a step; 16 under pp2), and the bytes
    a step each rank staged through the host.

50-51: ERNIE-1.0 pretraining across ranks (`phase_ernie_hybrid`,
`phase_ernie_multirank`).
52. ERNIE-1.0 across ranks surviving a planted rank death: the launcher's
    gang supervisor (`distributed.launch`) starts 2 gloo ranks on this
    card (this script with ``--gang-rank``) at ERNIE's widths with 2
    layers, b8 x s512, `Engine(mesh=)` at dp2 with ZeRO 2 over dp, bf16
    O1, dropout 0.1, AdamW with the global-norm clip, dynamic loss
    scaling and the guard; a `GangWorker` beat a step and a
    `GangCheckpointManager` commit every 2 steps. A clean leg of 6 steps
    and, at the same time, a kill leg: ``PADDLE_TPU_FAULTS`` crashes rank
    1 on the first attempt inside step 5's gradient all-reduce. Rank 0
    must leave it with a typed retriable error within
    FLAGS_dist_timeout_s, the supervisor restarts the gang once, both
    ranks restore step 4 from the GANG marker (digest-checked) and steps
    5-6 equal the clean leg's bit for bit; 1 restart, generation 2, the
    gang stats, each rank's B1-B3 launches (2 a step) and, on the
    restarted ranks, B1-B3 against their plain versions.
53. In this process, NCCL at world size 1: (a) 52's step-4 checkpoint
    (dp2, ZeRO 2) restored into `Engine(mesh=)` at world size 1, step 5
    within `GANG53_RTOL` of 52's; (b) `save_hybrid_state` /
    `load_hybrid_state` of 50's 12-layer hybrid ERNIE (run inside 50,
    before it is freed): a fresh engine restored takes the next step bit
    for bit, with the save and load times and bytes; (c) the guard's
    rollback of the meshed engine: 3 NaN steps (``train.batch``'s nan
    action on the batch's loss weights) roll it back to its newest
    checkpoint and the replay equals the clean steps bit for bit.

The last lines are the card line, one ``{"kernels": [...]}`` JSON line
and ``{"ok": true, "device": {...}}``. Without a CUDA card, or outside a
checkout of the repository, it exits with status 2 and prints no result.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's published peaks: memory bytes/s, f32 (non-tensor) flop/s,
# dense int8 tensor op/s, dense bf16 tensor flop/s; H100 SXM rates
# unless the name says otherwise
_PEAKS = (
    ("H200", (4.8e12, 67e12, 1979e12, 989e12)),
    ("H100 PCIe", (2.0e12, 51e12, 1513e12, 756e12)),
    ("H100 NVL", (3.9e12, 60e12, 1671e12, 835e12)),
    ("H100", (3.35e12, 67e12, 1979e12, 989e12)),
)


def _check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _peaks(name):
    for key, peaks in _PEAKS:
        if key in name:
            return peaks
    return _PEAKS[-1][1]


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _device_us(row):
    """A torch.profiler row's own device time (us), under either name
    torch has given the field."""
    return getattr(row, "self_device_time_total", None) \
        or getattr(row, "self_cuda_time_total", 0.0)


def _time_ms(fn, flush, n=50, spin=200_000):
    """Median device time of `fn` over `n` launches (CUDA events around
    each). Before every launch the 50 MB L2 is flushed by reading a
    128 MB buffer (in the serving step the layers between two heads
    evict the table), and the card then spins `spin` cycles (~0.1 ms by
    default) so that the host has enqueued the launch before the start
    event fires: the events time the device, not the wrapper's Python.
    A call through autograd needs a longer spin (`AUTOGRAD_SPIN`): its
    host dispatch outlasts 0.1 ms, and the events then time the host."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(n):
        flush.sum()
        torch.cuda._sleep(spin)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


AUTOGRAD_SPIN = 4_000_000     # ~2 ms of spinning


def _table(n, k, gen):
    """A frozen int8 table like the engine's: a N(0, 0.02) embedding
    quantized per tensor."""
    import torch

    from paddle_tpu_torch.quantization import quantize_state_int8

    w = torch.empty((n, k)).normal_(0.0, 0.02, generator=gen)
    frozen = quantize_state_int8({"w": w})
    return frozen["w"], frozen["w@scale"]


def phase_kernels(card):
    """Phase 2: B7 and B8 against their plain versions, then timed."""
    import torch

    from paddle_tpu_torch.ops import lowp, quant_ops

    gen = torch.Generator().manual_seed(0)
    errs = {"B7": 0.0, "B8": 0.0}
    # the serving head, then ragged shapes: K not a multiple of 16 (the
    # byte-load producer), 16 x rows with K in segments, two x tiles with
    # N one past a table tile
    shapes = [(8, 768, 50304), (3, 100, 333), (13, 2100, 777),
              (17, 1000, 129)]
    for m, k, n in shapes:
        q, s = (t.cuda() for t in _table(n, k, gen))
        x = torch.randn((m, k), generator=gen).cuda()
        per_row = (q.float().abs().amax(1) / 127.0 * s).cuda()
        for sc in (s, per_row):
            got = quant_ops.dequant_matmul(x, q, sc)
            want = quant_ops._dequant_matmul_plain(x, q, sc.reshape(-1))
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            errs["B7"] = max(errs["B7"], (got - want).abs().max().item())
        # the engine's frozen scale (the abs-max) and one that clips
        for sa in (x.abs().max(), x.abs().max() * 0.9):
            for table in (q.t(), q.t().contiguous()):
                got = lowp.w8a8_matmul(x, table, s, sa)
                want = lowp._w8a8_plain(x, table, s, sa)
                torch.cuda.synchronize()
                _check(torch.equal(got, want),
                       f"B8 differs from its plain version at {(m, k, n)}")
        print(f"kernels ok at M={m} K={k} N={n}", flush=True)
    # B8 on the rounding boundaries: x * (127 / sa) lands on k + 0.5
    sa = torch.tensor(3.7)
    x = ((torch.arange(-127, 127) + 0.5) * sa / 127.0).repeat(8, 1)
    q = torch.randint(-127, 128, (333, x.shape[1]), generator=gen,
                      dtype=torch.int8)
    x, q, sa = x.cuda(), q.cuda(), sa.cuda()
    s = torch.tensor(0.05, device="cuda")
    got = lowp.w8a8_matmul(x, q.t(), s, sa)
    want = lowp._w8a8_plain(x, q.t(), s, sa)
    torch.cuda.synchronize()
    _check(torch.equal(got, want), "B8 differs on the rounding boundaries")

    bw, f32_peak, int8_peak, _ = _peaks(card)
    m, k, n = shapes[0]
    q, s = (t.cuda() for t in _table(n, k, gen))
    x = torch.randn((m, k), generator=gen).cuda()
    sa = x.abs().max()
    sb, sa_c = torch.clamp_min(s, 1e-9), torch.clamp_min(sa, 1e-9)
    # both repeat bit for bit at the serving shape
    for fn in (lambda: quant_ops.dequant_matmul(x, q, s),
               lambda: lowp.w8a8_matmul(x, q.t(), sb, sa_c)):
        _check(torch.equal(fn(), fn()),
               "a serving head kernel did not repeat bit for bit")
    for key, occ in (("B7", quant_ops._occupancy(m, k)),
                     ("B8", lowp._w8a8_occupancy(m, k))):
        print(json.dumps({"serving_head_occupancy": key, "m": m, "k": k,
                          **occ}), flush=True)
    w_f32 = quant_ops.dequant_int8(q, s)        # yardstick's operand only
    flush = torch.empty(32 * 1024 * 1024, device="cuda")   # 128 MB
    table_t = q.t()
    lib_w8a8, lib_note = _int_mm_yardstick(x, table_t, sb, sa_c)
    rows = {
        "B7": dict(
            name="dequant_matmul", source="paddle_tpu_torch/csrc/quant_ops.cu",
            replaces="paddle_tpu/ops/quant_ops.py:231 (_dq_kernel)",
            ms=_time_ms(lambda: quant_ops._dequant_matmul_kernel(
                x, q, s.reshape(-1)), flush),
            plain_ms=_time_ms(lambda: quant_ops._dequant_matmul_plain(
                x, q, s.reshape(-1)), flush),
            library_ms=_time_ms(lambda: torch.matmul(x, w_f32.t()) * s,
                                flush),
            nbytes=m * k * 4 + n * k + 4 + m * n * 4,
            ops=2 * m * n * k, peak=f32_peak),
        "B8": dict(
            name="w8a8_matmul", source="paddle_tpu_torch/csrc/lowp.cu",
            replaces="paddle_tpu/ops/lowp.py:244 (_w8a8_kernel)",
            ms=_time_ms(lambda: lowp._w8a8_kernel(x, table_t, sb, sa_c),
                        flush),
            plain_ms=_time_ms(lambda: lowp._w8a8_plain(
                x, table_t, sb, sa_c), flush),
            library_ms=_time_ms(lib_w8a8, flush) if lib_w8a8 else None,
            library=lib_note,
            nbytes=m * k * 4 + n * k + 8 + m * n * 4,
            ops=2 * m * n * k, peak=int8_peak),
    }
    for key, row in rows.items():
        t_bytes = row.pop("nbytes") / bw * 1e3
        t_ops = row.pop("ops") / row.pop("peak") * 1e3
        row.update(route="cuda", max_abs_err=errs[key],
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        row["kernel_ms"] = row["ms"]
        print(json.dumps({"kernel": key, **row}), flush=True)
    return rows


def _int_mm_yardstick(x, table_t, sb, sa):
    """B8's library yardstick: the same w8a8 function through
    ``torch._int_mm`` (cuBLASLt int8, which needs M > 16): the
    activations quantized as B8 does, zero-padded from M rows to 32,
    the int32 product, its first M rows scaled by sa * sb / 127^2.
    Returns (callable, note); the callable's result must equal the plain
    version bit for bit. (None, reason) when no such call runs here."""
    import torch

    from paddle_tpu_torch.ops import lowp
    from paddle_tpu_torch.ops.quant_ops import true_div

    m, k = x.shape
    pad = torch.zeros((32 - m, k), dtype=torch.int8, device=x.device)
    scale = true_div(sa * sb, 127.0 * 127.0)
    want = lowp._w8a8_plain(x, table_t, sb, sa)
    reasons = []
    for table in (table_t, table_t.contiguous()):
        def run(table=table):
            xq = torch.cat([lowp.quant_int8(x, sa), pad])
            return torch._int_mm(xq, table)[:m].to(torch.float32) * scale
        try:
            got = run()
        except RuntimeError as e:    # a layout cuBLASLt refuses
            reasons.append(str(e).splitlines()[0][:120])
            continue
        _check(torch.equal(got, want),
               "torch._int_mm yardstick differs from the plain w8a8")
        layout = "column-major table" if table is table_t else \
            "row-major copy of the table"
        return run, (f"torch._int_mm, M padded 8 -> 32, {layout}, with "
                     "the activation quantization and the scale")
    return None, "torch._int_mm refused both layouts: " + "; ".join(reasons)


def _tiny_values(model, seed):
    """numpy weights at 0.1 scale for the tiny parity model (its own
    0.02 init makes a tiny random GPT repeat one token)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    vals = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if len(shape) >= 2:
            v = rng.randn(*shape) * 0.1
        elif "norm" in name and name.endswith("weight"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:
            v = 0.05 * rng.randn(*shape)
        vals[name] = v.astype(np.float32)
    return vals


def phase_slice():
    """Phase 3: int8 and w8a8 engines on cuda against the same engines
    on the CPU (the kernels' plain versions), same weights."""
    import numpy as np

    from paddle_tpu_torch import weights
    from paddle_tpu_torch.nlp.transformers import GPTConfig
    from paddle_tpu_torch.nlp.transformers import GPTForPretraining
    from paddle_tpu_torch.serving import SlotEngine

    class RecordingEngine(SlotEngine):
        """Keeps the logits row behind each greedy pick."""

        def _pick(self, slot):
            self.rows.append(slot.next_logits.copy())
            return super()._pick(slot)

    cfg = GPTConfig(vocab_size=97, hidden_size=64, num_layers=2,
                    num_heads=4, max_seq_len=64, dropout=0.0,
                    attn_dropout=0.0, use_parallel=False)
    models = {d: GPTForPretraining(cfg, device=d) for d in ("cuda", "cpu")}
    vals = _tiny_values(models["cpu"], 0)
    for m in models.values():
        weights.from_paddle_tpu_values(vals, m)
    prompts = [np.random.RandomState(s).randint(1, 97, (n,)).astype(
        np.int32) for s, n in ((3, 5), (50, 20), (9, 12))]
    for leg in (dict(quantize=True), dict(quantize=True, w8a8=True)):
        outs = {}
        for dev, model in models.items():
            eng = RecordingEngine(model, max_slots=2, block_size=8,
                                  prefill_chunk=8, device=dev, **leg)
            eng.rows = []
            eng.warmup()
            res = []
            for p in prompts:     # one at a time: rows stay in order
                fut = eng.submit(p, max_new_tokens=12, timeout=None)
                while True:
                    eng._admit()
                    if not eng.active:
                        break
                    eng._step()
                res.append(np.asarray(fut.result(60))[p.size:])
            outs[dev] = (res, eng)
        (cres, ceng), (pres, peng) = outs["cuda"], outs["cpu"]
        name = "w8a8" if leg.get("w8a8") else "int8"
        if leg.get("w8a8"):
            _check(ceng._act_frozen and peng._act_frozen,
                   "w8a8 activation scale did not freeze")
        # equal greedy tokens, except at a near-tie: where the two
        # devices' logits differ by at least half the CPU leg's top-2
        # margin, a flip is legitimate and the sequences part there
        worst = 0.0
        compared = total = i = 0
        for c, p in zip(cres, pres):
            stop = p.size
            for j in range(p.size):
                lc, lp = ceng.rows[i + j], peng.rows[i + j]
                dev = float(np.abs(lc - lp).max())
                if c[j] != p[j]:
                    top2 = np.sort(lp)[-2:]
                    _check(top2[1] - top2[0] <= 2 * dev,
                           f"{name}: cuda vs cpu token {j} differs at a "
                           f"margin of {top2[1] - top2[0]} with logits "
                           f"within {dev}: {c} vs {p}")
                    stop = j
                    break
                worst = max(worst, dev)
            compared, total, i = compared + stop, total + p.size, i + p.size
        _check(compared >= 0.75 * total,
               f"{name}: too many near-ties to compare ({compared}/{total})")
        # int8: the same f32 math summed in another order
        _check(name == "w8a8" or worst <= 1e-3,
               f"int8: cuda vs cpu logits differ by {worst}")
        print(json.dumps({"slice_vs_plain": name, "tokens_compared": compared,
                          "tokens": total, "max_logit_diff": worst}),
              flush=True)


SERVING_MAX_NEW = 32
# Server(max_slots=8, block_size=16, prefill_chunk=64), bench_serving.py
SERVING = dict(max_slots=8, block_size=16, prefill_chunk=64)


def _serving_prompts(vocab):
    """Phase 4's 16 prompts: lengths 32-256 from seed 0, the even ones
    sharing a 64-token prefix."""
    import numpy as np

    rng = np.random.RandomState(0)
    shared = rng.randint(1, vocab, (64,))
    prompts = []
    for i in range(16):
        n = int(rng.randint(32, 257))
        p = rng.randint(1, vocab, (n,))
        if i % 2 == 0:
            p[:64] = shared[:min(64, n)]
        prompts.append(p.astype(np.int32))
    return prompts


def phase_full_width():
    """Phase 4: gpt2-small served in three legs; returns per-leg launch
    counts, the model and each leg's generated tokens and pool bytes
    (what phases 24-26 are held to)."""
    import torch

    from paddle_tpu_torch.nlp.transformers import (
        GPTForPretraining, gpt_config,
    )

    cfg = gpt_config("gpt2-small", dropout=0.0, attn_dropout=0.0,
                     use_parallel=False)
    model = GPTForPretraining(cfg, device="cuda",
                              generator=torch.Generator().manual_seed(0))
    prompts = _serving_prompts(cfg.vocab_size)
    max_new = SERVING_MAX_NEW
    legs = {"f32": {}, "int8": dict(quantize=True),
            "w8a8": dict(quantize=True, w8a8=True)}
    results, launches, pool_bytes, n_steps = {}, {}, {}, {}
    for name, kw in legs.items():
        toks, snap, eng, wall, counts = _serve(model, prompts, max_new,
                                               **kw)
        b7, b8 = counts["B7"], counts["B8"]
        steps = snap["counters"]["steps"]
        if name == "f32":
            _check(b7 == 0 and b8 == 0, "f32 leg launched an int8 kernel")
        elif name == "int8":
            _check(b7 >= steps, f"int8: B7 ran {b7}x in {steps} steps")
        else:
            _check(b8 >= steps and b8 == steps,
                   f"w8a8: B8 ran {b8}x in {steps} steps")
            _check(eng._act_frozen, "w8a8 activation scale did not freeze")
        results[name] = toks
        launches[name] = counts
        pool_bytes[name] = eng.kv_pool_bytes
        n_steps[name] = steps
        step = snap["latency_s"]["step"]
        print(json.dumps({
            "leg": name, "requests": len(prompts), "max_new": max_new,
            "wall_s": wall, "tokens_per_s": len(prompts) * max_new / wall,
            "steps": steps, "step_p50_ms": step["p50"] * 1e3,
            "step_p99_ms": step["p99"] * 1e3,
            "kv_pool_bytes": eng.kv_pool_bytes,
            "prefix_hit_tokens": snap["counters"].get(
                "prefix_hit_tokens", 0),
            "launches": counts,
            "token_agreement_vs_f32": None if name == "f32" else
            _agreement(toks, results["f32"]),
            "act_scale": float(eng._act_scale) if eng.w8a8 else None,
        }), flush=True)
    return launches, model, {"tokens": results, "kv_pool_bytes": pool_bytes,
                             "steps": n_steps}


def _decode_engine(model, max_new=40, device="cuda", **kw):
    """A SlotEngine (phase 4's shape, `kw` added) with all 8 slots
    decoding: 8 seeded 64-token prompts admitted, then the prefill step
    and 3 decode steps taken."""
    import numpy as np

    from paddle_tpu_torch.serving import SlotEngine

    eng = SlotEngine(model, device=device, **SERVING, **kw)
    eng.warmup()
    rng = np.random.RandomState(1)
    for _ in range(8):
        eng.submit(rng.randint(1, model.config.vocab_size, (64,)),
                   max_new_tokens=max_new, timeout=None)
    eng._admit()
    for _ in range(4):                  # the prefill step + 3 decode steps
        eng._step()
    return eng


def _capture(fn, n):
    """`fn` run `n` times under the port's profiler capture
    (`profiler.start_trace` on the card, synchronised before it stops):
    the rows of `profiler.device_op_table` (kernels, memsets, device
    copies), the host<->device copies' us, the cudaLaunchKernel calls
    and the host seconds of the `n` runs, from the capture's trace."""
    import torch

    from paddle_tpu_torch import profiler

    logdir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        profiler.start_trace(logdir)
        try:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
        finally:
            path = profiler.stop_trace()
        _, rows = profiler.device_op_table(logdir)
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    copies = sum(e.get("dur", 0.0) for e in evs
                 if e.get("cat") == "gpu_memcpy" and "DtoD" not in e["name"])
    # less the empty spin kernels that open every CUDA capture
    launches = sum(1 for e in evs if e.get("cat") == "cuda_runtime" and
                   e["name"].startswith("cudaLaunchKernel")) - \
        profiler.WARMUP_SPINS
    return rows, copies, launches, host_s


def _profile_steps(eng, n=10):
    """`n` decode steps of `eng` under the port's profiler: the device's
    busy ms a step (kernels and copies), the launch calls a step, the
    kernel rows."""
    rows, copies, launches, _ = _capture(eng._step, n)
    busy_ms = (sum(r["total"] for r in rows) + copies) / 1e3 / n
    return busy_ms, launches / n, rows


def _top_kernels(kernels, n, k=6):
    return {r["name"][:60]: r["total"] / 1e3 / n for r in kernels[:k]}


def phase_profile(model):
    """Phase 5: where a decode step's time goes. A w8a8 engine with all
    8 slots decoding takes 10 steps on the host clock (each ends in the
    logits' copy to the host), then 10 more under the port's profiler
    for the device's kernel time by bucket, the launches and the
    costliest kernels."""
    import torch

    from paddle_tpu_torch import observe

    eng = _decode_engine(model, quantize=True, w8a8=True)
    n = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng._step()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    busy_ms, launches, kernels = _profile_steps(eng, n)
    _check(eng.metrics.get("failed") == 0, "profiled steps failed")
    _compiled_once(eng)
    # the LM head's device time by kernel name (B7 runs while the
    # activation scale calibrates, B8 once it is frozen)
    head = {key: sum(r["total"] for r in kernels if name in r["name"])
            / 1e3 / n for key, name in (("B7", "dq_stream"),
                                        ("B8", "w8a8_stream"))}
    _check(head["B8"] > 0, "the profile saw no B8 (w8a8_stream) time")
    buckets = observe.attribute_rows(kernels)["buckets"]
    print(json.dumps({
        "profile": "w8a8 decode step, 8 slots",
        "step_ms": host_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / host_ms),
        "launches_per_step": launches,
        "ms_per_step_by_bucket": {b: us / 1e3 / n
                                  for b, us in buckets.items()},
        "head_ms_per_step": head,
        "top_kernels_ms_per_step": _top_kernels(kernels, n),
    }), flush=True)


# ERNIE-1.0 pretraining as bench.py:255-315 configures it
ERNIE = dict(vocab_size=18000, hidden_size=768, num_layers=12, num_heads=12,
             ffn_hidden_size=3072, max_seq_len=512, dropout=0.1,
             attn_dropout=0.1, use_parallel=False)
ERNIE_BATCH, ERNIE_SEQ = 32, 512


def _packed_qkv(b, h, s, d, dtype, gen):
    """q, k, v as ERNIE's attention hands them over: [b, h, s, d] views
    of one packed [b, s, 3, h, d] projection."""
    import torch

    qkv = torch.randn((b, s, 3, h, d), generator=gen).to(dtype).cuda()
    return qkv.permute(2, 0, 3, 1, 4).unbind(0)


def _flash_vs_plain(q, k, v, do, causal, p, seed, bh_offset=None):
    """B1-B3 through `flash_attention` (forward and backward) against
    the plain versions on the same inputs (the dropout hash's global
    batch-head offset `bh_offset` on both); returns (kernel outputs,
    plain outputs) as (o, dq, dk, dv)."""
    import torch

    from paddle_tpu_torch.ops import fused_ops

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = fused_ops.flash_attention(*leaves, seed, is_causal=causal,
                                  dropout_p=p, bh_offset=bh_offset)
    o.backward(do)
    scale = 1.0 / q.shape[-1] ** 0.5
    to3 = fused_ops._to3
    args = [to3(t.detach()) for t in (q, k, v)]
    heads = q.shape[1]
    o_p, lse_p = fused_ops._flash_fwd_plain(*args, seed, scale, causal, p,
                                            heads, bh_offset)
    grads_p = fused_ops._flash_bwd_plain(*args, o_p, lse_p, to3(do), seed,
                                         scale, causal, p, heads, bh_offset)
    torch.cuda.synchronize()
    got = [o, *(t.grad for t in leaves)]
    return ([g.reshape(w.shape).float() for g, w in
             zip(got, (o_p, *grads_p))],
            [w.float() for w in (o_p, *grads_p)])


def _sdpa_backend(fn):
    """The SDPA backend that one call of `fn` ran (flash, efficient,
    cudnn or math), from the names of its kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [r.key for r in prof.key_averages()
             if r.device_type == torch.autograd.DeviceType.CUDA]
    for backend, keys in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                          ("efficient", ("fmha", "efficient", "cutlass"))):
        if any(k in n.lower() for n in names for k in keys):
            return backend
    return "math"


# the float16 gates of the kernel checks: the bf16 gates scaled by the
# ratio of the two formats' epsilons (2^-10 / 2^-7)
F16_OVER_BF16 = 2.0 ** -3


def phase_flash(card):
    """B1-B3 against their plain versions (f32 ragged shapes, then the
    ERNIE shape in bf16 and f32 with dropout, the hybrid GPT's causal f32
    shapes of phases 48-49, the mask bit for bit; the float16
    instantiation at ragged shapes and at the ERNIE and GPT-2 shapes,
    within the bf16 gate scaled by the epsilons), then timed at
    the ERNIE shape as the train step runs them, in bf16 and in f16
    (`_flash_times`), beside the plain versions and SDPA in the same
    dtype."""
    import torch

    from paddle_tpu_torch.ops import fused_ops

    gen = torch.Generator().manual_seed(1)
    seed = torch.tensor(20260101, device="cuda")
    errs = {"B1": 0.0, "B2": 0.0, "B3": 0.0}
    cases = [((1, 2, 70, 70, 32), c, p) for c in (False, True)
             for p in (0.0, 0.1)]
    cases += [((2, 3, 9, 21, 64), c, 0.0) for c in (False, True)]
    cases += [((2, 2, 21, 9, 128), True, 0.1), ((1, 2, 70, 70, 128), False,
                                                0.0)]
    b, h, s, d = ERNIE_BATCH, ERNIE["num_heads"], ERNIE_SEQ, 64
    # bf16 (B1 and B3 on the tensor cores) at ragged shapes, sq != sk
    # both ways (fully masked rows when sq > sk and causal)
    cases += [((1, 2, 70, 70, 32), True, 0.1, torch.bfloat16),
              ((2, 3, 9, 21, 64), False, 0.0, torch.bfloat16),
              ((2, 2, 21, 9, 128), True, 0.1, torch.bfloat16)]
    cases += [((b, h, s, s, d), False, 0.1, torch.float32),
              ((b, h, s, s, d), False, 0.1, torch.bfloat16)]
    # the hybrid GPT's calls (phases 48-49, f32, causal): world size 1 at
    # the source's attention dropout and at 0, then the local shapes of
    # 49's factorizations: mp2's 8 heads, dp2's 8 rows, pp2's 4-row
    # micro-batches, pp2.mp2's (sequence parallelism gathers the whole
    # sequence before attention)
    hb, hh, hs = HYBRID_BATCH, HYBRID["num_heads"], HYBRID_SEQ
    hybrid_cases = [((hb, hh, hs, hs, d), True, 0.1, torch.float32),
                    ((hb, hh, hs, hs, d), True, 0.0, torch.float32),
                    ((hb, hh // 2, hs, hs, d), True, 0.0, torch.float32),
                    ((hb // 2, hh, hs, hs, d), True, 0.0, torch.float32),
                    ((4, hh, hs, hs, d), True, 0.0, torch.float32),
                    ((4, hh // 2, hs, hs, d), True, 0.0, torch.float32)]
    cases += hybrid_cases
    # the Transformer-base path (phases 41-42): its train step's shape in
    # bf16 with dropout, and cached decoding's one query row against a
    # growing key length
    cases += [((TB_BATCH, 8, TB_SEQ, TB_SEQ, 64), False, 0.1,
               torch.bfloat16)]
    cases += [((TB_DECODE_BATCH, 8, 1, sk, 64), False, 0.0, dt)
              for sk in (1, 37, 128) for dt in (torch.float32,
                                                torch.bfloat16)]
    # float16 (the f16 instantiation of B1-B3): the bf16 ragged shapes,
    # the ERNIE shape (phase 44) and GPT-2 small's causal one (phase 45)
    f16 = torch.float16
    cases += [((1, 2, 70, 70, 32), True, 0.1, f16),
              ((2, 3, 9, 21, 64), False, 0.0, f16),
              ((2, 2, 21, 9, 128), True, 0.1, f16),
              ((b, h, s, s, d), False, 0.1, f16),
              ((GPT_BATCH, 12, GPT_SEQ, GPT_SEQ, 64), True, 0.1, f16)]
    # the meshed engines' calls: the dropout hash at a global batch-head
    # offset (rows 4-7 and heads 6-11 of 12: phase 51's dp2 x mp2
    # slice, f32), and ragged slices in bf16 and f16
    offset_cases = [((4, h // 2, s, s, d), False, 0.1, torch.float32,
                     (4, h // 2, h)),
                    ((2, 6, 70, 70, 64), False, 0.1, torch.bfloat16,
                     (3, 6, 12)),
                    ((2, 6, 70, 70, 64), True, 0.1, f16, (1, 0, 12))]
    cases += offset_cases
    err16 = {"B1": 0.0, "B2": 0.0, "B3": 0.0}
    err_h = {"B1": 0.0, "B2": 0.0, "B3": 0.0}
    for case in cases:
        (cb, ch, sq, sk, cd), causal, p = case[:3]
        dtype = case[3] if len(case) > 3 else torch.float32
        offset = case[4] if len(case) > 4 else None
        if sq == sk and sq in (s, GPT_SEQ):
            q, k, v = _packed_qkv(cb, ch, sq, cd, dtype, gen)
        else:
            q, k, v = (torch.randn((cb, ch, n, cd), generator=gen).to(
                dtype).cuda() for n in (sq, sk, sk))
        do = torch.randn((cb, sq, ch, cd), generator=gen).to(
            dtype).cuda().transpose(1, 2)
        got, want = _flash_vs_plain(q, k, v, do, causal, p, seed, offset)
        tol_o, tol_g = (1e-5, 2e-4) if dtype == torch.float32 else \
            (2e-2, 2e-2)
        if dtype == f16:
            tol_o, tol_g = tol_o * F16_OVER_BF16, tol_g * F16_OVER_BF16
        for i, (g, w) in enumerate(zip(got, want)):
            tol = tol_o if i == 0 else tol_g
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
        e = [(g - w).abs().max().item() for g, w in zip(got, want)]
        # the errors reported: ERNIE's shape (the main path's) and the
        # hybrid GPT's
        into = err_h if case in hybrid_cases else \
            (err16 if dtype == f16 else errs) if cb == b and sq == s else None
        if into is not None:
            into.update(B1=max(into["B1"], e[0]), B2=max(into["B2"], e[1]),
                        B3=max(into["B3"], e[2], e[3]))
        print(json.dumps({"flash_check": [cb, ch, sq, sk, cd],
                          "dtype": str(dtype), "causal": causal,
                          "dropout": p, "bh_offset": offset,
                          "max_abs_err": e}), flush=True)
        del q, k, v, do, got, want
    keep_k = fused_ops._keep_mask_kernel(seed, b * h, s, s, 0.1)
    keep_p = fused_ops._keep_mask(seed, b * h, s, s, 0.1)
    _check(torch.equal(keep_k, keep_p),
           "dropout mask of the kernels differs from the plain version's")
    # at a global batch-head offset: rows 4-7, heads 6-11 of 12
    part = (4, h // 2, h)
    keep_k = fused_ops._keep_mask_kernel(seed, 4 * (h // 2), s, s, 0.1,
                                         h // 2, part)
    keep_p = fused_ops._keep_mask(seed, 4 * (h // 2), s, s, 0.1, h // 2,
                                  part)
    _check(torch.equal(keep_k, keep_p),
           "dropout mask at a batch-head offset differs from the plain "
           "version's")
    keep_rate = keep_p.float().mean().item()
    del keep_k, keep_p
    print(json.dumps({"flash_mask_bitwise": True, "keep_rate": keep_rate}),
          flush=True)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for hd in fused_ops._HEAD_DIMS:
            for pass_, key in enumerate(("B1", "B2", "B3")):
                print(json.dumps({"flash_occupancy": key, "dtype": str(dtype),
                                  "head_dim": hd,
                                  **fused_ops._occupancy(pass_, dtype, hd)}),
                      flush=True)

    # timed as the train step runs them, in bf16 and in f16 (`fp16_*`)
    bw, _, _, bf16_peak = _peaks(card)
    flush = torch.empty(32 * 1024 * 1024, device="cuda")   # 128 MB
    times = {dt: _flash_times(dt, gen, seed, flush, b, h, s, d, 0.1)
             for dt in (torch.bfloat16, f16)}
    n_el, rows = b * h * s * d, b * h * s
    flops = 2 * b * h * s * s * d        # one [s, s] x d product
    rows_out = {
        "B1": dict(name="flash_attention_fwd",
                   replaces="paddle_tpu/ops/fused_ops.py:184 (_fwd_kernel)",
                   nbytes=4 * n_el * 2 + rows * 4, ops=2 * flops),
        "B2": dict(name="flash_attention_bwd_dq",
                   replaces="paddle_tpu/ops/fused_ops.py:319 "
                   "(_bwd_dq_kernel)",
                   nbytes=5 * n_el * 2 + 2 * rows * 4, ops=3 * flops),
        "B3": dict(name="flash_attention_bwd_dkv",
                   replaces="paddle_tpu/ops/fused_ops.py:363 "
                   "(_bwd_dkv_kernel)",
                   nbytes=6 * n_el * 2 + 2 * rows * 4, ops=4 * flops),
    }
    for key, row in rows_out.items():
        t_bytes = row.pop("nbytes") / bw * 1e3
        t_ops = row.pop("ops") / bf16_peak * 1e3
        row.update(times[torch.bfloat16][key])
        row.update(route="cuda", source="paddle_tpu_torch/csrc/flash_attn.cu",
                   max_abs_err=errs[key], bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   fp16_max_abs_err=err16[key],
                   hybrid_f32_max_abs_err=err_h[key],
                   **{f"fp16_{k}": v for k, v in times[f16][key].items()})
        print(json.dumps({"kernel": key, **row}), flush=True)
    return rows_out


def _flash_times(dtype, gen, seed, flush, b, h, s, d, p):
    """B1-B3 in `dtype` timed as the train step runs them (dropout `p`,
    q / k / v views of the packed projection, the output gradient in
    [b, s, h, d]; `dropout0_ms` the same launch without dropout, for the
    hash's share), beside the plain versions and SDPA forward and
    backward on the same operands at dropout 0 and `p` (the library
    yardstick, never called by the port). B2 owns its q tile (no
    atomics): two launches must agree bit for bit. Returns ``{key:
    {ms, dropout0_ms, plain_ms, library_ms, library_dropout_ms}}``."""
    import torch

    from paddle_tpu_torch.ops import fused_ops

    scale = 1.0 / d ** 0.5
    q, k, v = _packed_qkv(b, h, s, d, dtype, gen)
    do = torch.randn((b, s, h, d), generator=gen).to(dtype).cuda().transpose(
        1, 2)
    o, lse = fused_ops._flash_fwd_kernel(q, k, v, seed, scale, False, p)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dq, dk, dv = (torch.empty((b, h, s, d), dtype=dtype, device="cuda")
                  for _ in range(3))
    q3, k3, v3, o3, do3, lse3 = (fused_ops._to3(t) for t in
                                 (q, k, v, o, do, lse))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lq, lk, lv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o_lib = {dp: sdpa(lq, lk, lv, dropout_p=dp) for dp in (0.0, p)}
    lib = {
        "B1": {dp: _time_ms(lambda: sdpa(q, k, v, dropout_p=dp), flush)
               for dp in (0.0, p)},
        "B2": {dp: _time_ms(lambda: torch.autograd.grad(
            o_lib[dp], (lq, lk, lv), do, retain_graph=True), flush,
            spin=AUTOGRAD_SPIN) for dp in (0.0, p)}}
    lib["B3"] = lib["B2"]
    plain = {"B1": _time_ms(lambda: fused_ops._flash_fwd_plain(
        q3, k3, v3, seed, scale, False, p), flush, n=10)}
    plain["B2"] = plain["B3"] = _time_ms(lambda: fused_ops._flash_bwd_plain(
        q3, k3, v3, o3, lse3, do3, seed, scale, False, p), flush, n=10)
    fused_ops._launch_pass(1, q, k, v, do, dq, None, None, lse, delta, seed,
                           scale, False, p)
    first = dq.clone()
    fused_ops._launch_pass(1, q, k, v, do, dq, None, None, lse, delta, seed,
                           scale, False, p)
    _check(torch.equal(first, dq), f"B2 in {dtype} does not repeat bit for "
           "bit")
    print(json.dumps({"bitwise_repeat": "B2", "dtype": str(dtype),
                      "shape": [b, h, s, s, d], "dropout": p,
                      "equal": True}), flush=True)
    print(json.dumps({"sdpa_backend": {
        f"{what}@{dp}": _sdpa_backend(fn) for dp in (0.0, p)
        for what, fn in (
            ("fwd", lambda: sdpa(q, k, v, dropout_p=dp)),
            ("bwd", lambda: torch.autograd.grad(
                o_lib[dp], (lq, lk, lv), do, retain_graph=True)))},
        "dtype": str(dtype)}), flush=True)
    launch = {
        "B1": lambda dp: fused_ops._flash_fwd_kernel(q, k, v, seed, scale,
                                                     False, dp),
        "B2": lambda dp: fused_ops._launch_pass(
            1, q, k, v, do, dq, None, None, lse, delta, seed, scale, False,
            dp),
        "B3": lambda dp: fused_ops._launch_pass(
            2, q, k, v, do, dk, dv, None, lse, delta, seed, scale, False,
            dp)}
    return {key: dict(ms=_time_ms(lambda: fn(p), flush),
                      dropout0_ms=_time_ms(lambda: fn(0.0), flush),
                      plain_ms=plain[key], library_ms=lib[key][0.0],
                      library_dropout_ms=lib[key][p])
            for key, fn in launch.items()}


def _lce_case(n, h, v, masked, dtype, gen, x_std=0.5, w_std=0.1):
    """x [n, h], w [v, h] on the card, labels with a `masked` share of
    -100 and g = 1 / #valid on the valid rows (a mean's gradient)."""
    import torch

    x = (torch.randn((n, h), generator=gen) * x_std).to(dtype).cuda()
    w = (torch.randn((v, h), generator=gen) * w_std).to(dtype).cuda()
    lbl = torch.randint(0, v, (n,), generator=gen)
    lbl[torch.rand((n,), generator=gen) < masked] = -100
    valid = (lbl != -100).float()
    g = valid / valid.sum().clamp_min(1.0)
    return x, w, lbl.cuda(), g.cuda()


def _lce_exact_case(n, h, v, masked, gen, dtype=None):
    """bf16 (or `dtype`) x [n, h] in quarters and w [v, h] in sixteenths
    of -2..2, so every score is exact in f32 whatever the order of its
    sums: given one lse, the kernel and the plain version then round the
    same d to the operand dtype, and dx / dw differ only by their own f32
    sums (within one ulp of that dtype). Labels with a `masked` share of
    -100, g = 1 / #valid."""
    import torch

    dtype = dtype or torch.bfloat16
    x = (torch.randint(-2, 3, (n, h), generator=gen) / 4.0).to(dtype).cuda()
    w = (torch.randint(-2, 3, (v, h), generator=gen) / 16.0).to(
        dtype).cuda()
    lbl = torch.randint(0, v, (n,), generator=gen)
    lbl[torch.rand((n,), generator=gen) < masked] = -100
    valid = (lbl != -100).float()
    g = valid / valid.sum().clamp_min(1.0)
    return x, w, lbl.cuda(), g.cuda()


def _ulps(got, want, dtype=None):
    """Largest |got - want| in bf16 (or `dtype`: float16) ulps of each
    element (of the largest element's 2^-8 near 0; in float16 at least
    its subnormal spacing 2^-24)."""
    import torch

    got, want = got.float(), want.float()
    eps = 2.0 ** -10 if dtype == torch.float16 else 2.0 ** -7
    ulp = torch.maximum(want.abs(), want.abs().max() * 2 ** -8) * eps
    if dtype == torch.float16:
        ulp = ulp.clamp_min(2.0 ** -24)
    err = (got - want).abs()
    # an all-zero `want` (every row ignored) has no ulp: equal reads 0
    return float(torch.where(err == 0, 0.0, err / ulp).max())


def phase_fused_loss(card):
    """B4-B6 against their plain versions (f32 ragged shapes; bf16 and
    f16 at ragged shapes with exact scores; the ERNIE shape in bf16 and
    f16, `_lce_ernie`), then the ERNIE shape's times in both dtypes
    (`fp16_*` the f16 ones) beside the bound."""
    import torch

    from paddle_tpu_torch.ops import fused_loss as fl

    gen = torch.Generator().manual_seed(3)
    # (n, h, v, masked share, plain chunk): ragged against the kernels'
    # 16/32/64-row tiles, vocab tails, chunks that do not divide V
    cases = [(37, 64, 301, 0.3, 128), (130, 128, 1000, 0.85, 100),
             (300, 256, 777, 1.0, 128), (1000, 768, 18000, 0.85, 1000),
             (70, 1024, 513, 0.5, 256)]
    for n, h, v, masked, cv in cases:
        x, w, lbl, g = _lce_case(n, h, v, masked, torch.float32, gen)
        nll, lse = fl._fwd_kernel(x, w, lbl)
        dx, dw = fl._bwd_kernel(x, w, lbl, lse, g)
        nll_p, lse_p = fl._fwd_plain(x, w, lbl, cv)
        dx_p, dw_p = fl._bwd_plain(x, w, lbl, lse_p, g, cv)
        torch.cuda.synchronize()
        errs = []
        for got, want in ((nll, nll_p), (lse, lse_p), (dx, dx_p),
                          (dw, dw_p)):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            errs.append((got - want).abs().max().item())
        print(json.dumps({"fused_loss_check": [n, h, v], "dtype": "f32",
                          "masked": masked, "chunk": cv,
                          "max_abs_err": errs}), flush=True)

    # bf16 and f16 at ragged shapes against B4's 128-row and B6's 64-row
    # tiles (every hidden size, V and N not multiples of 64, every row
    # ignored): exact scores, B4 within 1e-4 (a label in the last,
    # partial vocab tile), the kernel's lse on both sides of B5 / B6,
    # within one ulp of the operand dtype
    for dtype in (torch.bfloat16, torch.float16):
        for n, h, v, masked in ((37, 64, 301, 0.3), (130, 128, 1000, 0.85),
                                (300, 256, 777, 1.0), (200, 512, 300, 0.5),
                                (129, 768, 65, 0.0), (257, 768, 4001, 0.5),
                                (70, 1024, 513, 0.5)):
            x, w, lbl, g = _lce_exact_case(n, h, v, masked, gen, dtype)
            if masked < 1.0:
                lbl[-1] = v - 1
            nll, lse = fl._fwd_kernel(x, w, lbl)
            nll_p, lse_p = fl._fwd_plain(x, w, lbl, 128)
            dx, dw = fl._bwd_kernel(x, w, lbl, lse, g)
            dx_p, dw_p = fl._bwd_plain(x, w, lbl, lse, g, 128)
            torch.cuda.synchronize()
            valid = lbl != -100
            torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(nll[valid], nll_p[valid], rtol=1e-4,
                                       atol=1e-4)
            ulps = {"B5": _ulps(dx, dx_p, dtype),
                    "B6": _ulps(dw, dw_p, dtype)}
            _check(all(u <= 1.0 for u in ulps.values()),
                   f"B5/B6 beyond one {dtype} ulp at {(n, h, v)}: {ulps}")
            print(json.dumps({"fused_loss_check": [n, h, v],
                              "dtype": str(dtype), "masked": masked,
                              "ulps": ulps, "B4_max_abs_err": max(
                                  (lse - lse_p).abs().max().item(),
                                  (nll - nll_p)[valid].abs().max().item()
                                  if bool(valid.any()) else 0.0)}),
                  flush=True)
    del x, w, lbl, g, nll, lse, nll_p, lse_p, dx, dw, dx_p, dw_p

    flush = torch.empty(32 * 1024 * 1024, device="cuda")   # 128 MB
    res = {dt: _lce_ernie(dt, gen, flush)
           for dt in (torch.bfloat16, torch.float16)}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for hd in fl._HIDDEN:
            for mode, key in enumerate(("B4", "B5", "B6")):
                print(json.dumps({"fused_loss_occupancy": key,
                                  "dtype": str(dtype), "hidden": hd,
                                  **fl._occupancy(mode, dtype, hd)}),
                      flush=True)
    n, h, v = ERNIE_BATCH * ERNIE_SEQ, ERNIE["hidden_size"], \
        ERNIE["vocab_size"]
    bw, _, _, bf16_peak = _peaks(card)
    xh, wh, row = n * h * 2, v * h * 2, n * 4
    flops = 2 * n * v * h               # one [N, V] x H product
    library = "two-call composition: torch.matmul in the operands' dtype " \
        "(bf16; fp16_* in f16), F.cross_entropy of its f32 upcast"
    rows_out = {
        "B4": dict(
            name="fused_lce_fwd",
            replaces="paddle_tpu/ops/fused_loss.py:177 (_fwd_kernel)",
            library=library + " (forward)",
            nbytes=xh + wh + row + 2 * row, ops=flops),
        "B5": dict(
            name="fused_lce_bwd_dx",
            replaces="paddle_tpu/ops/fused_loss.py:234 (_bwd_dx_kernel)",
            library=library + " (backward, dx only)",
            nbytes=xh + wh + 3 * row + xh, ops=2 * flops),
        "B6": dict(
            name="fused_lce_bwd_dw",
            replaces="paddle_tpu/ops/fused_loss.py:255 (_bwd_dw_kernel)",
            library=library + " (backward, dx and dw)",
            nbytes=xh + wh + 3 * row + wh, ops=2 * flops),
    }
    (errs, times), (errs16, times16) = res[torch.bfloat16], \
        res[torch.float16]
    for key, row in rows_out.items():
        t_bytes = row.pop("nbytes") / bw * 1e3
        t_ops = row.pop("ops") / bf16_peak * 1e3
        row.update(times[key])
        row.update(route="cuda", source="paddle_tpu_torch/csrc/fused_loss.cu",
                   max_abs_err=errs[key], bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   fp16_max_abs_err=errs16[key],
                   **{f"fp16_{k}": v for k, v in times16[key].items()})
        print(json.dumps({"kernel": key, **row}), flush=True)
    return rows_out


def _lce_bwd_sums(x, w, lbl, lse, g, d_dtype, cv=1024):
    """The fused loss's backward as `_bwd_plain` computes it but with d
    rounded to `d_dtype` (f32 sums, outputs in x's dtype), and the sums
    of the absolute products behind dx and dw, ``|d| @ |w|`` [N, H] and
    ``|d|^T @ |x|`` [V, H], with d rounded to x's dtype as the kernels
    round it, chunk by chunk. Returns (dx, dw, dx sums, dw sums)."""
    import torch

    xf = x.float()
    dx, dx_abs = torch.zeros_like(xf), torch.zeros_like(xf)
    dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    dw_abs = torch.empty_like(dw)
    for off in range(0, w.shape[0], cv):
        wk = w[off:off + cv].float()
        s = xf @ wk.t()
        col = torch.arange(off, off + s.shape[1], device=x.device)
        hit = (col[None, :] == lbl[:, None]).float()
        d = (torch.exp(s - lse[:, None]) - hit) * g[:, None]
        dr, da = d.to(d_dtype).float(), d.to(x.dtype).float().abs()
        dx += dr @ wk
        dw[off:off + cv] = dr.t() @ xf
        dx_abs += da @ wk.abs()
        dw_abs[off:off + cv] = da.t() @ xf.abs()
    return dx.to(x.dtype), dw.to(w.dtype), dx_abs, dw_abs


# the f16 gate's multiple of sqrt(k) 2^-24 of the absolute products' sum
F16_SUMS_K = 4.0


def _f16_gate(got, want, acc, k):
    """An f16 dx / dw against the f16 gate: one f16 ulp of each element
    (of the largest element's 2^-8 near 0, at least f16's smallest
    normal's), plus ``F16_SUMS_K * sqrt(k) * 2^-24`` of the sum of the
    absolute products `acc` behind it (f32 sums of `k` products an
    element in another order than the plain version's: independent
    roundings grow as sqrt(k)). Returns (the largest |got - want| over
    the gate, the least multiple of ``sqrt(k) * 2^-24 * acc`` beyond
    the ulp that `got` needs)."""
    import torch

    want = want.float()
    err = (got.float() - want).abs()
    ulp = torch.maximum(want.abs(), want.abs().max() * 2 ** -8).clamp_min(
        2.0 ** -14) * 2 ** -10
    sums = k ** 0.5 * 2.0 ** -24 * acc
    need = torch.where(err <= ulp, 0.0, (err - ulp) / sums)
    return (float((err / (ulp + F16_SUMS_K * sums)).max()),
            float(need.max()))


def _lce_ernie(dtype, gen, flush):
    """B4-B6 in `dtype` at the ERNIE shape as the train step runs them:
    x the head's [16384, 768] hidden states, w the tied table [18000,
    768], MLM labels at 15%, g the mean's gradient; in f16 times the
    engine's initial loss scale 2^15 (a float16 step's d: unscaled it
    would lie below f16's subnormals). Against the plain versions: the
    loss within 1e-3, nll and lse row by row within 1e-4; B5 / B6 in
    bf16 within one bf16 ulp of the plain backward on the plain lse; in
    f16 on B4's lse (the two lse differ in their last f32 bits, which
    f16's finer d carries past one ulp) within `_f16_gate`, which the
    plain backward with d rounded to bf16 instead (the control) must
    fail. B4-B6 own their rows (no atomics): two launches agree bit for
    bit. Then timed beside the plain versions and the two-call
    composition in `dtype` (forward; backward asked for dx, and for dx
    and dw; never called by the port). Returns ({key: max abs err},
    {key: {ms, plain_ms, library_ms}})."""
    import torch

    from paddle_tpu_torch.ops import fused_loss as fl

    f16 = dtype == torch.float16
    n, h, v = ERNIE_BATCH * ERNIE_SEQ, ERNIE["hidden_size"], \
        ERNIE["vocab_size"]
    x, w, lbl, g = _lce_case(n, h, v, 0.85, dtype, gen, 1.0, 0.02)
    if f16:
        g = g * 2.0 ** 15
    lbl32 = lbl.to(torch.int32)
    nll, lse = fl._fwd_kernel(x, w, lbl)
    dx, dw = fl._bwd_kernel(x, w, lbl, lse, g)
    nll_p, lse_p = fl._fwd_plain(x, w, lbl, 1024)
    dx_p, dw_p = fl._bwd_plain(x, w, lbl, lse if f16 else lse_p, g, 1024)
    torch.cuda.synchronize()
    valid = lbl != -100
    loss, loss_p = nll[valid].mean().item(), nll_p[valid].mean().item()
    _check(abs(loss - loss_p) <= 1e-3 * abs(loss_p),
           f"B4 {dtype} loss {loss} vs plain {loss_p}")
    # row by row: the mean alone would hide a wrong picked logit
    torch.testing.assert_close(nll[valid], nll_p[valid], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)
    _check(all(bool(torch.isfinite(t).all()) for t in (dx, dw)),
           f"B5/B6 {dtype} overflowed at the ERNIE shape")
    ulps = {"B5": _ulps(dx, dx_p, dtype), "B6": _ulps(dw, dw_p, dtype)}
    report = {}
    if f16:
        ctl_dx, ctl_dw, dx_abs, dw_abs = _lce_bwd_sums(
            x, w, lbl, lse, g, torch.bfloat16)
        for key, got, want, ctl, acc, k in (
                ("B5", dx, dx_p, ctl_dx, dx_abs, v),
                ("B6", dw, dw_p, ctl_dw, dw_abs, n)):
            (r, need), (r_ctl, need_ctl) = (_f16_gate(t, want, acc, k)
                                            for t in (got, ctl))
            report[key] = {"of_gate": r, "sums_k_needed": need,
                           "control_of_gate": r_ctl,
                           "control_sums_k_needed": need_ctl}
        del ctl_dx, ctl_dw, dx_abs, dw_abs
        print(json.dumps({"fused_loss_f16_gate": report,
                          "sums_k": F16_SUMS_K}), flush=True)
        for key, rep in report.items():
            _check(rep["of_gate"] <= 1.0,
                   f"f16 {key} at {rep['of_gate']} of its gate")
            _check(rep["control_of_gate"] > 1.0,
                   f"f16 {key}: the bf16-rounded control passes the gate "
                   f"({rep['control_of_gate']} of it)")
    else:
        _check(all(u <= 1.0 for u in ulps.values()),
               f"B5/B6 beyond one bf16 ulp of the plain version: {ulps}")
    errs = {"B4": max((nll - nll_p).abs().max().item(),
                      (lse - lse_p).abs().max().item()),
            "B5": (dx.float() - dx_p.float()).abs().max().item(),
            "B6": (dw.float() - dw_p.float()).abs().max().item()}
    print(json.dumps({"fused_loss_check": [n, h, v], "dtype": str(dtype),
                      "g_scale": 2.0 ** 15 if f16 else 1.0, "loss": loss,
                      "plain_loss": loss_p, "ulps": ulps, "gate": report,
                      "max_abs_err": errs}), flush=True)
    del dx_p, dw_p, nll_p, lse_p
    again = fl._fwd_kernel(x, w, lbl)
    _check(torch.equal(again[0], nll) and torch.equal(again[1], lse),
           f"B4 {dtype} does not repeat bit for bit")
    _check(torch.equal(fl._bwd_dx_kernel(x, w, lbl32, lse, g), dx),
           f"B5 {dtype} does not repeat bit for bit")
    _check(torch.equal(fl._bwd_dw_kernel(x, w, lbl32, lse, g), dw),
           f"B6 {dtype} does not repeat bit for bit")
    del again, dx, dw
    for key in ("B4", "B5", "B6"):
        print(json.dumps({"bitwise_repeat": key, "dtype": str(dtype),
                          "shape": [n, h, v], "equal": True}), flush=True)

    xl, wl = (t.detach().clone().requires_grad_(True) for t in (x, w))

    def lib_fwd():
        return torch.nn.functional.cross_entropy(
            torch.matmul(xl, wl.t()).float(), lbl, ignore_index=-100)

    lib_loss = lib_fwd()
    lib = {"B4": _time_ms(lib_fwd, flush, n=20, spin=AUTOGRAD_SPIN),
           # B5's own function in library calls: the same autograd
           # backward asked for dx alone (no dw GEMM)
           "B5": _time_ms(lambda: torch.autograd.grad(
               lib_loss, xl, retain_graph=True), flush, n=20,
               spin=AUTOGRAD_SPIN),
           "B6": _time_ms(lambda: torch.autograd.grad(
               lib_loss, (xl, wl), retain_graph=True), flush, n=20,
               spin=AUTOGRAD_SPIN)}
    del lib_loss
    plain_bwd = _time_ms(lambda: fl._bwd_plain(x, w, lbl, lse, g, 1024),
                         flush, n=5)
    plain = {"B4": _time_ms(lambda: fl._fwd_plain(x, w, lbl, 1024), flush,
                            n=5), "B5": plain_bwd, "B6": plain_bwd}
    ms = {"B4": _time_ms(lambda: fl._fwd_kernel(x, w, lbl), flush),
          "B5": _time_ms(lambda: fl._bwd_dx_kernel(x, w, lbl32, lse, g),
                         flush),
          "B6": _time_ms(lambda: fl._bwd_dw_kernel(x, w, lbl32, lse, g),
                         flush)}
    return errs, {key: dict(ms=ms[key], plain_ms=plain[key],
                            library_ms=lib[key]) for key in ms}


def _ernie_batch(vocab, batch, seq, seed=0):
    """bench.py's batch: random ids, MLM labels at 15% (else -100)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
    labels = ids.copy()
    labels[rng.rand(batch, seq) > 0.15] = -100
    return ids, labels


def _ernie_engine(cfg, device, weights_seed, engine_seed, lr, **kw):
    import torch

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.engine import Engine
    from paddle_tpu_torch.nlp.transformers import (
        ErnieForPretraining, ErniePretrainingCriterion,
    )

    model = ErnieForPretraining(
        cfg, device=device,
        generator=torch.Generator().manual_seed(weights_seed))
    crit = ErniePretrainingCriterion(cfg)
    opt = optimizer.AdamW(learning_rate=lr, parameters=model.parameters(),
                          weight_decay=0.01)
    return Engine(model, opt, lambda out, mlm: crit(out[0], out[1], mlm),
                  device=device, seed=engine_seed, **kw)


def phase_train_slice():
    """The train step on cuda against the same step on the CPU (the
    kernels' plain versions): a tiny ERNIE (head dim 32), one seed for
    weights and dropout on both, hidden dropout 0 and attention dropout
    0.1 (the shared mask drops the same elements on both), the fused
    LM-head loss on, 3 AdamW steps in f32; the losses agree within rtol
    1e-4 (f32 sums in other orders, magnified by Adam's normalised
    steps)."""
    import numpy as np

    from paddle_tpu_torch.nlp.transformers import ErnieConfig
    from paddle_tpu_torch.ops import fused_loss, fused_ops

    cfg = ErnieConfig(vocab_size=97, hidden_size=128, num_layers=2,
                      num_heads=4, ffn_hidden_size=256, max_seq_len=64,
                      dropout=0.0, attn_dropout=0.1)
    ids, labels = _ernie_batch(97, 2, 64, seed=3)
    losses = {}
    for dev in ("cuda", "cpu"):
        eng = _ernie_engine(cfg, dev, 5, 7, 1e-3)
        before = {**fused_ops.flash_attention.launches,
                  **fused_loss.launches}
        losses[dev] = [float(eng.train_batch(ids, labels)) for _ in range(3)]
        if dev == "cuda":
            after = {**fused_ops.flash_attention.launches,
                     **fused_loss.launches}
            want = dict(B1=6, B2=6, B3=6, B4=3, B5=3, B6=3)
            _check(all(after[n] - before[n] == c for n, c in want.items()),
                   f"tiny ERNIE: launches {before} -> {after}")
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    _check(losses["cuda"][-1] < losses["cuda"][0], "tiny ERNIE: no descent")
    print(json.dumps({"train_slice_vs_plain": losses}), flush=True)


def phase_train_full(card, fused, n=10, recompute=False, warm=2,
                     lowp="off", record=False):
    """ERNIE-1.0 at full width as bench.py trains it: b32 x s512,
    dropout 0.1 / 0.1, bf16 auto_cast, AdamW lr 1e-4 wd 0.01, random
    weights from seed 0, FLAGS_use_fused_lm_loss as `fused` and
    FLAGS_lowp_matmul as `lowp` (latched by the engine). `warm` warm-up
    steps (with `record`, the first one records the distinct B9 calls),
    then `n` steps timed on the host clock (each ends in a synchronise),
    the peak memory and the launch counts of B1-B6 and B9 set to 0 just
    before them and read just after. A flag-off leg must move no lowp
    stat."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp, observe
    from paddle_tpu_torch.engine import LOWP_SCALE_KEY
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.nlp.transformers import ErnieConfig
    from paddle_tpu_torch.ops import fused_loss, fused_ops
    from paddle_tpu_torch.ops import lowp as lowp_ops
    from paddle_tpu_torch.quantization import publish_scale_state

    set_flags({"FLAGS_use_fused_lm_loss": fused, "FLAGS_lowp_matmul": lowp})
    compiles0 = len(observe.compile_events("train_step"))
    cfg = ErnieConfig(**ERNIE, recompute=recompute)
    eng = _ernie_engine(cfg, "cuda", 0, 0, 1e-4)
    ids, labels = _ernie_batch(cfg.vocab_size, ERNIE_BATCH, ERNIE_SEQ)
    stats0 = monitor.stats("lowp.")

    def step():
        with amp.auto_cast(enable=True, dtype="bfloat16"):
            return eng.train_batch(ids, labels)

    calls = None
    if record:
        with _SmmRecorder() as rec:
            losses = [float(step())]
        calls = rec.calls
        losses += [float(step()) for _ in range(warm - 1)]
    else:
        losses = [float(step()) for _ in range(warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    fused_ops.flash_attention.launches.update(B1=0, B2=0, B3=0)
    fused_loss.launches.update(B4=0, B5=0, B6=0)
    lowp_ops.scaled_matmul.launches = 0
    # a leg without warm-up compiles its step in the first timed one
    with observe.no_retrace(allow=() if warm else ("train_step",)):
        for _ in range(n):
            t0 = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
    launches = {**fused_ops.flash_attention.launches, **fused_loss.launches,
                "B9": lowp_ops.scaled_matmul.launches}
    compiles = len(observe.compile_events("train_step")) - compiles0
    _check(compiles == 1, f"{compiles} train_step compiles in the leg")
    peak = torch.cuda.max_memory_allocated()
    _check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    _check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    # recompute reruns each block's forward (B1) in the backward; the
    # low-precision forward bypasses B4 for B9's score chunks
    b9 = _b9_per_step(eng.layer) if lowp != "off" else 0
    per_step = dict(B1=cfg.num_layers * (2 if recompute else 1),
                    B2=cfg.num_layers, B3=cfg.num_layers,
                    B4=int(fused and lowp == "off"), B5=int(fused),
                    B6=int(fused), B9=b9)
    _check(all(launches[k] == c * n for k, c in per_step.items()),
           f"launches over {n} steps: {launches}, derived {per_step}")
    scale_state = None
    if lowp == "off":
        _check(monitor.stats("lowp.") == stats0,
               f"a flag-off leg moved lowp stats: {monitor.stats('lowp.')}")
    else:
        if calls is not None:
            _check(sum(calls.values()) == b9,
                   f"recorded {sum(calls.values())} B9 calls, derived {b9}")
        st = eng.state.buffers[LOWP_SCALE_KEY]
        scale_state = {
            "clip_rate": publish_scale_state(st),
            "scale_updates": int(st.updates), "step": int(st.step),
            "slots_bound": int((st.history.amax(1) > 0).sum()),
            "matmul_calls": monitor.stat_get(f"lowp.matmuls_{lowp}") -
            stats0.get(f"lowp.matmuls_{lowp}", 0)}
        _check(scale_state["step"] == warm + n and
               scale_state["scale_updates"] == warm + n,
               f"ScaleState schedule: {scale_state}")
    n_params = sum(p.numel() for p in eng.state.params.values())
    flops_tok = 6.0 * n_params + 12.0 * cfg.num_layers * cfg.hidden_size * \
        ERNIE_SEQ
    step_s = float(np.median(times))
    tok_s = ERNIE_BATCH * ERNIE_SEQ / step_s
    bf16_peak = _peaks(card)[3]
    out = {
        "train": "ernie-1.0 b32 s512 bf16 dropout 0.1",
        "fused_lm_loss": fused, "recompute": recompute, "lowp": lowp,
        "steps": n,
        "step_ms_p50": step_s * 1e3,
        "step_ms_p90": float(np.percentile(times, 90)) * 1e3,
        "tokens_per_s": tok_s, "params": n_params,
        "mfu": flops_tok * tok_s / bf16_peak,
        "peak_mem_bytes": peak, "losses": losses,
        "launches_per_step": {k: c / n for k, c in launches.items()},
        "scale_state": scale_state, "train_step_compiles": compiles,
    }
    print(json.dumps(out), flush=True)
    if calls is not None:
        out["b9_calls"] = calls
    return out, eng, step


def phase_train_profile(step, label):
    """Where a train step's time goes: 3 steps under the port's profiler
    capture, under `observe.no_retrace()` (the leg compiled its one step
    in its warm-up). The device's time a step by bucket
    (`observe.classify_kernel`, the port's one table of kernel names),
    with the kernel ids and library families under each bucket, and the
    host<->device copies beside them. Returns {"busy_ms": kernels and
    copies, "kernel_ms": the counted rows alone} a step; device times
    repeat between runs where the host clock does not."""
    import torch

    from paddle_tpu_torch import observe

    n = 3
    torch.cuda.synchronize()
    with observe.no_retrace():
        rows, copies, launches, host_s = _capture(step, n)
    host_ms = host_s * 1e3 / n
    kernel_ms = sum(r["total"] for r in rows) / 1e3 / n
    busy_ms = kernel_ms + copies / 1e3 / n
    _check(busy_ms > 0, "the profiler saw no device time")
    buckets = {b: {"ms": 0.0, "kernels": {}} for b in observe.BUCKETS}
    for r in rows:
        bucket, kernel = observe.classify_kernel(r["name"])
        cell = buckets[bucket]
        cell["ms"] += r["total"] / 1e3 / n
        key = kernel or "other kernels"
        cell["kernels"][key] = cell["kernels"].get(key, 0.0) + \
            r["total"] / 1e3 / n
    print(json.dumps({
        "profile": label,
        "step_ms": host_ms, "device_busy_ms": busy_ms,
        "host_copy_ms": copies / 1e3 / n,
        "device_idle_share": max(0.0, 1.0 - busy_ms / host_ms),
        "kernels_per_step": sum(r["calls"] for r in rows) / n,
        "launch_calls_per_step": launches / n,
        "top_kernels_ms_per_step": {r["name"][:90]: r["total"] / 1e3 / n
                                    for r in rows[:8]},
        "ms_per_step_by_bucket": buckets,
    }), flush=True)
    return {"busy_ms": busy_ms, "kernel_ms": kernel_ms}


def _csrc_kernels():
    """Names of the __global__ functions in paddle_tpu_torch/csrc/."""
    import re

    pattern = (r"__global__\s+void\s+"
               r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    names = set()
    for path in (ROOT / "paddle_tpu_torch" / "csrc").glob("*.cu*"):
        names.update(re.findall(pattern, path.read_text()))
    return names


# the buckets the port's table gives the hand-written kernels of the
# training paths (kernel id -> bucket)
KERNEL_BUCKETS = {"B1": "attention", "B2": "attention", "B3": "attention",
                  "B4": "matmul", "B5-B6": "matmul", "B9": "matmul",
                  "B10": "matmul"}


def phase_attribute(eng, label, profile, calls, tol=0.03):
    """Phases 33-34: `Engine.attribute_step(steps=3)` replays the leg's
    last batch under the port's profiler (bf16 auto_cast, under
    `observe.no_retrace()`), then `Engine.overlap_report(steps=1)`.
    Gates: each hand-written kernel of `calls` ({kernel id: launches a
    step}) shows with exactly those launches and in its bucket of
    `KERNEL_BUCKETS`; "other" holds no hand-written kernel; the bucket
    total is within `tol` (3%; phase 41 6%) of the leg's profile
    (`phase_train_profile`'s counted rows, the device's busy time less
    its host copies); one card launches no collective. Prints the five
    buckets in ms a step and the top rows."""
    import re

    from paddle_tpu_torch import amp, observe

    n = 3
    logdir = tempfile.mkdtemp(prefix="chip_smoke_attrib_")
    try:
        with amp.auto_cast(enable=True, dtype="bfloat16"), \
                observe.no_retrace():
            t0 = time.monotonic()
            rep = eng.attribute_step(logdir=f"{logdir}/a", steps=n,
                                     top=1 << 30)
            attribute_s = time.monotonic() - t0
            ov = eng.overlap_report(logdir=f"{logdir}/o", steps=1)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    ids, other = {}, []
    hand = re.compile(r"\b(%s)\b" % "|".join(sorted(_csrc_kernels())))
    for r in rep["top_ops"]:
        _bucket, kid = observe.classify_kernel(r["name"])
        if kid in KERNEL_BUCKETS:
            _check(r["bucket"] == KERNEL_BUCKETS[kid],
                   f"{label}: {kid} row in {r['bucket']}: {r['name'][:90]}")
            ids[kid] = ids.get(kid, 0) + r["calls"]
        if r["bucket"] == "other":
            _check(not hand.search(r["name"]),
                   f"{label}: a hand-written kernel in other: {r['name']}")
            other.append(r)
    want = {k: c * n for k, c in calls.items()}
    _check(ids == want, f"{label}: kernel launches {ids}, want {want}")
    total_ms = rep["total_us"] / 1e3 / n
    dev = abs(total_ms - profile["kernel_ms"]) / profile["kernel_ms"]
    _check(dev <= tol, f"{label}: buckets {total_ms} ms a step against "
           f"the profile's {profile['kernel_ms']} ms")
    _check(ov["collective_us"] == 0.0, f"{label}: collectives {ov}")
    out = {
        "attribute": label, "steps": n, "attribute_s": attribute_s,
        "ms_per_step": {b: us / 1e3 / n for b, us in rep["buckets"].items()},
        "fractions": rep["fractions"], "total_ms_per_step": total_ms,
        "profile_kernel_ms": profile["kernel_ms"], "rel_dev": dev,
        "kernel_launches": ids,
        "top_rows": [{"name": r["name"][:90], "bucket": r["bucket"],
                      "ms_per_step": r["total"] / 1e3 / n}
                     for r in rep["top_ops"][:8]],
        "other_ms_per_step": {r["name"][:90]: r["total"] / 1e3 / n
                              for r in other[:5]},
        "overlap": ov,
        "train_step_compiles": len(observe.compile_events("train_step")),
    }
    print(json.dumps(out), flush=True)
    return out


def _b9_per_step(model):
    """B9 launches of one low-precision training step, derived from the
    model: one per Linear (each runs once in the forward) and one per
    vocab chunk of the fused loss's forward."""
    from paddle_tpu_torch.nn.layer.common import Linear
    from paddle_tpu_torch.ops import fused_loss

    linears = sum(isinstance(m, Linear) for m in model.modules())
    v = model.config.vocab_size
    cv = min(fused_loss._CHUNK_V, fused_loss._round_up(v, 128))
    return linears + -(-v // cv)


class _SmmRecorder:
    """Records the distinct calls that reach B9 (a's shape, dtype and
    row stride, b's shape, dtype and layout: a Linear weight [in, out]
    or a transposed vocab chunk) and how often each runs, by wrapping
    `lowp._smm` while it is on."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        from paddle_tpu_torch.ops import lowp

        self._orig = orig = lowp._smm

        def rec(a, b, sa, sb, qdtype):
            layout = "chunk" if b.stride(0) == 1 and b.shape[1] > 1 \
                else "weight"
            key = (a.shape[0], a.shape[1], b.shape[1], str(a.dtype)[6:],
                   a.stride(0), str(b.dtype)[6:], layout)
            self.calls[key] = self.calls.get(key, 0) + 1
            return orig(a, b, sa, sb, qdtype)

        lowp._smm = rec
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.ops import lowp

        lowp._smm = self._orig


# tolerances of the low-precision phase (cuda against the CPU): the
# quantized products are exact given their codes, but f32 noise between
# the matmuls (other sum orders on the two devices) can flip a code
# that sits on a rounding boundary; int8's flips move losses by < 1e-3
# and fp8's (3 mantissa bits) by < 1e-2 in the CPU tests against the
# reference (tests/test_torch_lowp_training.py). A scale is one
# activation's abs-max after two Adam steps, so it carries that
# element's f32 noise undamped: 1.6e-4 between the card and the CPU in
# int8 on an H100 (first run), held to 1e-3
LOWP_RTOL = {"int8": (2e-3, 1e-3), "fp8": (1e-2, 2e-2)}   # (loss, scale)


def phase_lowp_slice():
    """Low-precision training on cuda against the CPU: the tiny ERNIE of
    phase_train_slice under FLAGS_lowp_matmul int8 and fp8, 3 AdamW
    steps in f32 with the fused loss on. The cuda run goes through B9
    (exactly the derived launches, none of B4); losses and the
    ScaleState's scales within LOWP_RTOL, its step, updates and element
    count equal."""
    import numpy as np

    from paddle_tpu_torch.engine import LOWP_SCALE_KEY
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.nlp.transformers import ErnieConfig
    from paddle_tpu_torch.ops import fused_loss, lowp

    cfg = ErnieConfig(vocab_size=97, hidden_size=128, num_layers=2,
                      num_heads=4, ffn_hidden_size=256, max_seq_len=64,
                      dropout=0.0, attn_dropout=0.1)
    ids, labels = _ernie_batch(97, 2, 64, seed=3)
    out = {}
    try:
        for mode in ("int8", "fp8"):
            set_flags({"FLAGS_lowp_matmul": mode})
            losses, states = {}, {}
            for dev in ("cuda", "cpu"):
                eng = _ernie_engine(cfg, dev, 5, 7, 1e-3)
                b9, b4 = lowp.scaled_matmul.launches, fused_loss.launches["B4"]
                losses[dev] = [float(eng.train_batch(ids, labels))
                               for _ in range(3)]
                st = eng.state.buffers[LOWP_SCALE_KEY]
                states[dev] = {k: v.cpu().numpy()
                               for k, v in st._asdict().items()}
                if dev == "cuda":
                    want = 3 * _b9_per_step(eng.layer)
                    got = lowp.scaled_matmul.launches - b9
                    _check(got == want and fused_loss.launches["B4"] == b4,
                           f"tiny ERNIE {mode}: {got} B9 launches, derived "
                           f"{want}; B4 {fused_loss.launches['B4'] - b4}")
            loss_rtol, scale_rtol = LOWP_RTOL[mode]
            np.testing.assert_allclose(losses["cuda"], losses["cpu"],
                                       rtol=loss_rtol)
            _check(losses["cuda"][-1] < losses["cuda"][0],
                   f"tiny ERNIE {mode}: no descent")
            c, p = states["cuda"], states["cpu"]
            for k in ("step", "updates", "total"):
                _check(c[k] == p[k], f"{mode} ScaleState.{k}: {c[k]} {p[k]}")
            np.testing.assert_allclose(c["scale"], p["scale"],
                                       rtol=scale_rtol)
            out[mode] = {"losses": losses,
                         "clipped": [float(c["clipped"]),
                                     float(p["clipped"])],
                         "scale_max_rel_diff": float(np.max(
                             np.abs(c["scale"] - p["scale"]) /
                             np.abs(p["scale"])))}
    finally:
        set_flags({"FLAGS_lowp_matmul": "off"})
    print(json.dumps({"lowp_slice_vs_plain": out}), flush=True)


def _fp8_tol(a, b, sa, sb):
    """B9's fp8 tolerance against its plain version, per element: 4 K
    2^-24 of the sum of the absolute products, times the epilogue."""
    from paddle_tpu_torch.ops import lowp

    qa = lowp._quant_f8(a, sa).double().abs()
    qb = lowp._quant_f8(b, sb).double().abs()
    return 4 * a.shape[1] * 2.0 ** -24 * (qa @ qb) * (
        float(sa) * float(sb) / 448.0 ** 2)


def _smm_yardstick(a, b, sa, sb, qdtype, want, tol):
    """B9's library yardstick: the same function through one library
    GEMM: the operands quantized as B9 does, then ``torch._int_mm``
    (cuBLASLt int8) and the epilogue for int8, or ``torch._scaled_mm``
    (cuBLASLt e4m3, per-tensor scales s / 448) for fp8; M padded to 32
    and N to 16 with zero rows / columns where the library needs it.
    Returns (callable, note); the callable's result must equal the plain
    version (int8) or lie within `tol` of it (fp8). (None, reason) when
    the library refuses every layout."""
    import torch

    from paddle_tpu_torch.ops import lowp
    from paddle_tpu_torch.ops.quant_ops import true_div

    m, n = a.shape[0], b.shape[1]
    pm, pn = max(32, -(-m // 16) * 16) - m, -(-n // 16) * 16 - n
    reasons = []
    for col_major in (b.stride(0) == 1, not b.stride(0) == 1):
        def run(col_major=col_major):
            if qdtype == "int8":
                qa, qb = lowp.quant_int8(a, sa), lowp.quant_int8(b, sb)
            else:
                qa, qb = lowp._quant_f8(a, sa), lowp._quant_f8(b, sb)
            if pm:
                qa = torch.cat([qa, torch.zeros((pm, qa.shape[1]),
                                                dtype=qa.dtype,
                                                device=qa.device)])
            if pn:
                qb = torch.cat([qb, torch.zeros((qb.shape[0], pn),
                                                dtype=qb.dtype,
                                                device=qb.device)], 1)
            if col_major and qb.stride(0) != 1:
                qb = qb.t().contiguous().t()
            elif not col_major and qb.stride(1) != 1:
                qb = qb.contiguous()
            if qdtype == "int8":
                acc = torch._int_mm(qa.contiguous(), qb)[:m, :n]
                return acc.to(torch.float32) * true_div(sa * sb, 127.0 ** 2)
            return torch._scaled_mm(
                qa.contiguous(), qb, scale_a=true_div(sa, 448.0),
                scale_b=true_div(sb, 448.0),
                out_dtype=torch.float32)[:m, :n]
        try:
            got = run()
        except RuntimeError as e:      # a layout the library refuses
            reasons.append(str(e).splitlines()[0][:120])
            continue
        if qdtype == "int8":
            _check(torch.equal(got, want),
                   "torch._int_mm yardstick differs from the plain B9")
        else:
            # the library applies the two scales one after the other
            _check(bool(((got.double() - want.double()).abs() <=
                         tol + 4 * 2.0 ** -24 * want.double().abs()).all()),
                   "torch._scaled_mm yardstick beyond the fp8 tolerance")
        name = "torch._int_mm" if qdtype == "int8" else "torch._scaled_mm"
        layout = "column-major" if col_major else "row-major"
        return run, (f"{name}, {layout} b, with both quantizations and "
                     "the epilogue")
    return None, "library refused both layouts: " + "; ".join(reasons)


# ragged B9 checks beside the recorded shapes: (m, k, n, a dtype,
# b dtype, b layout) — every dtype pair and both layouts of b
B9_RAGGED = [(1, 100, 2, "float32", "float32", "weight"),
             (7, 100, 3, "bfloat16", "float32", "weight"),
             (33, 100, 333, "float32", "bfloat16", "chunk"),
             (33, 768, 333, "bfloat16", "bfloat16", "chunk"),
             (7, 768, 3, "bfloat16", "bfloat16", "weight"),
             (1, 3072, 333, "float32", "float32", "chunk"),
             (129, 129, 257, "float32", "float32", "weight"),
             (257, 200, 129, "bfloat16", "bfloat16", "chunk"),
             (129, 3000, 130, "bfloat16", "float32", "weight"),
             # float16 operands (float16 amp: f16 activations, and f16
             # weights after amp.decorate)
             (7, 100, 3, "float16", "float32", "weight"),
             (33, 768, 333, "float16", "float16", "chunk"),
             (257, 200, 129, "float32", "float16", "chunk"),
             (129, 3000, 130, "float16", "bfloat16", "weight")]


def _b9_operands(m, k, n, a_dtype, lda, b_dtype, layout, gen):
    """a [m, k] with row stride lda (a view of a wider buffer, as the
    pooler's first-token rows), b [k, n] as a Linear weight or as the
    transpose of a [n, k] vocab chunk, on the card."""
    import torch

    a = (torch.randn((m, lda), generator=gen) * 2.0).to(
        getattr(torch, a_dtype)).cuda()[:, :k]
    if layout == "chunk":
        b = (torch.randn((n, k), generator=gen) * 0.05).to(
            getattr(torch, b_dtype)).cuda().t()
    else:
        b = (torch.randn((k, n), generator=gen) * 0.05).to(
            getattr(torch, b_dtype)).cuda()
    return a, b


def _b9_split_ms(a, b, sa, sb, q, flush, n=10):
    """One B9 call's device time by kernel, from torch.profiler's kernel
    events over `n` calls (L2 flushed before each; after two calls
    outside the trace, as the profiler's schedule warms up): its two
    quantise passes (`quant_rows` / `quant_cols`) and its GEMM
    (`qmm_wg`), each the mean of the launches the trace kept (times two
    for the quantise passes). The trace has been seen to drop a few of
    these short kernels, so the launches it kept are returned too, and
    once to keep none of them: a trace that saw no kernel of a kind is
    taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from paddle_tpu_torch.ops import lowp

    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=1, warmup=1, active=n,
                                       repeat=1)) as prof:
            for _ in range(n + 2):
                flush.sum()
                lowp._smm_kernel(a, b, sa, sb, q)
                torch.cuda.synchronize()
                prof.step()
        us = {"quantise": 0.0, "gemm": 0.0}
        count = {"quantise": 0, "gemm": 0}
        for r in prof.key_averages():
            part = "gemm" if "qmm_wg" in r.key else "quantise" if any(
                t in r.key for t in ("quant_rows", "quant_cols")) else None
            if part and r.device_type == torch.autograd.DeviceType.CUDA:
                us[part] += _device_us(r)
                count[part] += r.count
        if all(count.values()) and all(us.values()):
            break
    _check(all(count.values()) and all(us.values()),
           f"B9's profile saw kernels {count}, device us {us}, for {n} calls")
    return {"quantise_ms": 2 * us["quantise"] / 1e3 / count["quantise"],
            "gemm_ms": us["gemm"] / 1e3 / count["gemm"],
            "profiled_launches": count}


def _b9_check(key, gen):
    """B9 against its plain version at one recorded call `key` (m, k, n,
    a dtype, a row stride, b dtype, b layout) on random operands: int8
    bit for bit, with the abs-max scale and with one that clips; fp8
    within `_fp8_tol`. Returns (a, b, sa, sb, fp8's largest error, its
    largest share of the bound)."""
    import torch

    from paddle_tpu_torch.ops import lowp

    a, b = _b9_operands(*key, gen)
    sa, sb = lowp.amax_of(a), lowp.amax_of(b)
    for s in (sa, sa * 0.7):
        got = lowp._smm_kernel(a, b, s, sb, "int8")
        _check(torch.equal(got, lowp._smm_plain(a, b, s, sb, "int8")),
               f"B9 int8 differs from its plain version at {key}")
        del got
    got = lowp._smm_kernel(a, b, sa, sb, "fp8").double()
    diff = (got - lowp._smm_plain(a, b, sa, sb, "fp8").double()).abs()
    del got
    of_bound = float((diff / (_fp8_tol(a, b, sa, sb) + 1e-30)).max())
    _check(of_bound <= 1.0, f"B9 fp8 beyond 4 K 2^-24 of sum |q q| at "
           f"{key}: {of_bound} of the bound")
    return a, b, sa, sb, float(diff.max()), of_bound


def phase_hybrid_b9(calls):
    """B9 against its plain version (`_b9_check`) at every distinct call
    of the hybrid GPT's int8 step (`calls`, recorded from phase 48's
    first int8 step): f32 activations at K 1024 into the blocks'
    weights (N 3072, 1024, 4096, and 4096 -> 1024) and into the tied
    head through ``w.t()`` (N 50304), with dynamic scales. Returns fp8's
    largest error."""
    import torch

    gen = torch.Generator().manual_seed(22)
    err = 0.0
    for key in sorted(calls):
        m, k, n, a_dt, lda, b_dt, layout = key
        a, b, _, _, fp8_err, of_bound = _b9_check(key, gen)
        err = max(err, fp8_err)
        print(json.dumps({"b9_check": dict(
            path="hybrid_48", m=m, k=k, n=n, a=a_dt, a_row_stride=lda,
            b=b_dt, b_layout=layout, calls_per_step=calls[key],
            fp8_max_abs_err=fp8_err, fp8_err_of_bound=of_bound)}),
            flush=True)
        del a, b
        torch.cuda.empty_cache()
    return err


def phase_lowp_kernels(card, calls):
    """B9 against its plain version, in int8 and fp8, at every distinct
    call of the full-width low-precision step (`calls`, recorded from
    the int8 leg's first step with its operands' dtypes, a's row stride
    and b's layout) and at B9_RAGGED: int8 bit for bit (with the
    abs-max scale and with one that clips), fp8 within `_fp8_tol`. Then
    each recorded shape timed in both modes (CUDA events, L2 flushed)
    beside the plain version, the library yardstick (never called by
    the port) and the bound; summed over a step's calls. Returns the B9
    row (int8 in the main fields, fp8 beside them)."""
    import torch

    from paddle_tpu_torch.ops import lowp

    bw, _, int8_peak, _ = _peaks(card)   # the fp8 dense peak equals int8's
    flush = torch.empty(32 * 1024 * 1024, device="cuda")   # 128 MB
    gen = torch.Generator().manual_seed(21)
    err = {"int8": 0.0, "fp8": 0.0}
    ragged = [(m, k, n, ad, k, bd, lay) for m, k, n, ad, bd, lay in B9_RAGGED]
    step = {q: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                    bound_bytes_ms=0.0, quantise_ms=0.0, gemm_ms=0.0)
            for q in ("int8", "fp8")}
    lib_notes = {}
    for key in sorted(calls) + ragged:
        m, k, n, a_dt, lda, b_dt, layout = key
        per_step = calls.get(key, 0)
        a, b, sa, sb, fp8_err, of_bound = _b9_check(key, gen)
        err["fp8"] = max(err["fp8"], fp8_err)
        row = dict(m=m, k=k, n=n, a=a_dt, a_row_stride=lda, b=b_dt,
                   b_layout=layout, calls_per_step=per_step,
                   fp8_err_of_bound=of_bound)
        if not per_step:
            print(json.dumps({"b9_check": row}), flush=True)
            continue
        nbytes = m * k * a.element_size() + k * n * b.element_size() + \
            m * n * 4
        t_bytes, t_ops = nbytes / bw * 1e3, 2.0 * m * n * k / int8_peak * 1e3
        for q in ("int8", "fp8"):
            want = lowp._smm_plain(a, b, sa, sb, q)
            lib, note = _smm_yardstick(a, b, sa, sb, q, want,
                                       _fp8_tol(a, b, sa, sb) if q == "fp8"
                                       else None)
            lib_notes.setdefault(q, set()).add(note)
            ms = _time_ms(lambda: lowp._smm_kernel(a, b, sa, sb, q), flush,
                          n=20)
            plain_ms = _time_ms(lambda: lowp._smm_plain(a, b, sa, sb, q),
                                flush, n=3)
            lib_ms = _time_ms(lib, flush, n=20) if lib else None
            row[q] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          **_b9_split_ms(a, b, sa, sb, q, flush))
            st = step[q]
            st["ms"] += per_step * ms
            st["quantise_ms"] += per_step * row[q]["quantise_ms"]
            st["gemm_ms"] += per_step * row[q]["gemm_ms"]
            st["plain_ms"] += per_step * plain_ms
            st["library_ms"] += per_step * (lib_ms or 0.0)
            st["bound_ms"] += per_step * max(t_bytes, t_ops)
            if t_bytes >= t_ops:
                st["bound_bytes_ms"] += per_step * t_bytes
            del want
        row.update(bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        print(json.dumps({"b9_shape": row}), flush=True)
        del a, b
    for q in ("int8", "fp8"):
        print(json.dumps({"scaled_matmul_occupancy": q,
                          **lowp._occupancy(q)}), flush=True)
    fp16_call = _b9_f16_call(calls, gen, flush)
    launches = sum(calls.values())
    print(json.dumps({"b9_per_step": step, "launches": launches,
                      "distinct_calls": len(calls),
                      "library": {q: sorted(v) for q, v in
                                  lib_notes.items()}}), flush=True)
    i8, f8 = step["int8"], step["fp8"]
    return dict(
        name="scaled_matmul", route="cuda",
        source="paddle_tpu_torch/csrc/lowp.cu",
        replaces="paddle_tpu/ops/lowp.py:227 (_qmm_kernel)",
        max_abs_err=max(err.values()), fp8_max_abs_err=err["fp8"],
        ms=i8["ms"], plain_ms=i8["plain_ms"], library_ms=i8["library_ms"],
        bound_ms=i8["bound_ms"],
        bound_by="bytes" if 2 * i8["bound_bytes_ms"] >= i8["bound_ms"]
        else "operations",              # the side that binds most of it
        fp8_ms=f8["ms"], fp8_plain_ms=f8["plain_ms"],
        fp8_library_ms=f8["library_ms"],
        library="; ".join(sorted(lib_notes.get("int8", ()))),
        per="one int8 training step's calls, summed (fp8_* the fp8 step's)",
        fp16_call=fp16_call)


def _b9_f16_call(calls, gen, flush):
    """The largest recorded B9 call with float16 operands (a and b as a
    float16 amp step hands them over) against the same call in bf16, in
    int8: bit for bit the plain version, timed beside the library
    yardstick (the codes through ``torch._int_mm``)."""
    import torch

    from paddle_tpu_torch.ops import lowp

    m, k, n, _a, lda, _b, layout = max(calls, key=lambda c: c[0] * c[1] *
                                       c[2])
    out = dict(m=m, k=k, n=n, b_layout=layout)
    for dt in ("float16", "bfloat16"):
        a, b = _b9_operands(m, k, n, dt, lda, dt, layout, gen)
        sa, sb = lowp.amax_of(a), lowp.amax_of(b)
        want = lowp._smm_plain(a, b, sa, sb, "int8")
        _check(torch.equal(lowp._smm_kernel(a, b, sa, sb, "int8"), want),
               f"B9 int8 differs from its plain version with {dt} operands")
        lib, _note = _smm_yardstick(a, b, sa, sb, "int8", want, None)
        key = "fp16" if dt == "float16" else "bf16"
        out[f"{key}_ms"] = _time_ms(
            lambda: lowp._smm_kernel(a, b, sa, sb, "int8"), flush, n=20)
        out[f"{key}_library_ms"] = _time_ms(lib, flush, n=20) if lib \
            else None
        del a, b, want
    print(json.dumps({"b9_f16_call": out}), flush=True)
    return out


# ResNet-50 training as bench.py:184-214 runs it
RESNET_BATCH, RESNET_HW = 128, 224


def _resnet50_fwd_flops(hw=224, num_classes=1000):
    """bench.py's analytic forward FLOPs of one ResNet-50 image (convs
    as 2*Kh*Kw*Cin*Cout*Hout*Wout, the vanilla 7x7 stem, the fc; BN,
    ReLU and pooling left out): 8.18e9 at 224."""
    f = 0.0
    h = hw // 2
    f += 2 * 7 * 7 * 3 * 64 * h * h
    h //= 2
    inplanes = 64
    for planes, blocks, stride in ((64, 3, 1), (128, 4, 2),
                                   (256, 6, 2), (512, 3, 2)):
        hin, h = h, h // stride
        width, out_c = planes, planes * 4
        f += 2 * inplanes * width * hin * hin
        f += 2 * 9 * width * width * h * h
        f += 2 * width * out_c * h * h
        f += 2 * inplanes * out_c * h * h
        inplanes = out_c
        for _ in range(blocks - 1):
            f += 2 * inplanes * width * h * h
            f += 2 * 9 * width * width * h * h
            f += 2 * width * out_c * h * h
    f += 2 * 512 * 4 * num_classes
    return f


def _b10_per_step(model):
    """B10 launches of one training step and of one eval forward,
    derived from the model: one forward launch per conv on the fused
    path, and in the backward one per input-parity plane that has taps
    (none for the stem, whose input, the images, needs no gradient)."""
    from paddle_tpu_torch.nn.layer.conv import Conv2D
    from paddle_tpu_torch.ops import fused_conv
    from paddle_tpu_torch.vision.models.resnet import SpaceToDepthStem

    stem = model.conv1.conv if isinstance(model.conv1, SpaceToDepthStem) \
        else model.conv1
    fwd = bwd = 0
    for conv in model.modules():
        if not isinstance(conv, Conv2D):
            continue
        _check(conv._is_plain_for_fusion(), f"{conv} is off the fused path")
        fwd += 1
        if conv is stem:
            continue
        s = conv._stride
        k, p = conv._kernel_size[0], conv._padding
        bwd += sum(fused_conv._taps_1d(k, s, a, p) is not None
                   and fused_conv._taps_1d(k, s, b, p) is not None
                   for a in range(s) for b in range(s))
    return fwd + bwd, fwd


class _ConvRecorder:
    """Records the distinct convs that reach B10 (the NCHW operands'
    shapes, stride, pads and epilogue) and how often each runs, by
    wrapping `fused_conv._fwd` while it is on."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        from paddle_tpu_torch.ops import fused_conv

        self._orig = orig = fused_conv._fwd

        def rec(x, w, s, pads, *, g=None, b=None, res=None,
                act="identity", moments=False):
            epi = "moments" if moments else (
                "affine" + ("+res" if res is not None else "") + f"+{act}"
                if g is not None else "none")
            key = (tuple(x.shape), tuple(w.shape), s,
                   tuple(map(tuple, pads)), epi)
            self.calls[key] = self.calls.get(key, 0) + 1
            return orig(x, w, s, pads, g=g, b=b, res=res, act=act,
                        moments=moments)

        fused_conv._fwd = rec
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.ops import fused_conv

        fused_conv._fwd = self._orig


def _resnet_model(device, depth=50, **kw):
    import torch

    from paddle_tpu_torch.vision.models import resnet as tresnet

    block = tresnet.BottleneckBlock if depth >= 50 else tresnet.BasicBlock
    return tresnet.ResNet(block, depth, device=device,
                          generator=torch.Generator().manual_seed(0), **kw)


def _resnet_values(model, seed):
    """numpy weights for the parity models: He-scaled conv / fc weights,
    BN scales near 1, small biases, running means near 0 and variances
    in [0.5, 1.5] (as tests/test_torch_resnet.py draws them)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    vals = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("_variance"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("_mean"):
            v = 0.1 * rng.randn(*shape)
        elif len(shape) >= 2:
            fan = np.prod(shape[1:]) if len(shape) == 4 else shape[0]
            v = rng.randn(*shape) * np.sqrt(2.0 / fan)
        elif name.endswith("weight"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:
            v = 0.05 * rng.randn(*shape)
        vals[name] = v.astype(np.float32)
    return vals


def _resnet_engine(model, device, lr=0.1, **kw):
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.engine import Engine

    crit = nn.CrossEntropyLoss()
    opt = optimizer.Momentum(learning_rate=lr, momentum=0.9,
                             parameters=model.parameters(), weight_decay=1e-4)
    return Engine(model, opt, lambda logits, labels: crit(logits, labels),
                  device=device, seed=0, **kw)


def _resnet_batch(batch, hw, classes=1000, seed=0):
    """bench.py's synthetic batch: rng.rand images, random labels."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return (rng.rand(batch, 3, hw, hw).astype(np.float32),
            rng.randint(0, classes, (batch,)).astype(np.int32))


def _conv_class(key):
    """The class of a recorded conv that B10's per-step sums are split
    by: 1x1 / 3x3 at stride 1 or 2, the 4x4 space-to-depth stem, and the
    1x2 / 2x1 / 2x2 dx parity planes of the stride-2 3x3 convs."""
    _xs, ws, s, _pads, _epi = key
    kh, kw = ws[2], ws[3]
    if kh == kw and kh in (1, 3):
        return f"{kh}x{kw} s{s}"
    return "stem 4x4" if kh == kw == 4 else "dx parity planes"


def _record_resnet_convs():
    """The distinct convs that reach B10 in one ResNet-50 training step
    and one eval forward at b128 (bf16 under O1), with how often each
    runs: two `_ConvRecorder.calls` dicts."""
    import torch

    from paddle_tpu_torch import amp

    model = _resnet_model("cuda", space_to_depth_stem=True)
    eng = _resnet_engine(model, "cuda")
    imgs, labels = _resnet_batch(RESNET_BATCH, RESNET_HW)
    with _ConvRecorder() as train_rec, \
            amp.auto_cast(enable=True, dtype="bfloat16"):
        eng.train_batch(imgs, labels)
    model.eval()
    x_img = torch.from_numpy(imgs).cuda()
    with _ConvRecorder() as eval_rec, torch.no_grad(), \
            amp.auto_cast(enable=True, dtype="bfloat16"):
        model(x_img)
    del eng, model, x_img
    torch.cuda.empty_cache()
    return train_rec.calls, eval_rec.calls


def _conv_operands(key, dtype, gen):
    """Random operands of a recorded conv on the card, lowered: (x, w,
    plan, xp, wk, epilogue kwargs of `_conv_kernel`)."""
    import torch

    from paddle_tpu_torch.ops import fused_conv

    xs, ws, s, pads, epi = key
    x = torch.randn(xs, generator=gen).to(dtype).cuda()
    w = (torch.randn(ws, generator=gen) /
         (ws[1] * ws[2] * ws[3]) ** 0.5).to(dtype).cuda()
    plan = fused_conv._plan(xs, ws, (s, s), pads)
    xp, wk = fused_conv._lower(x, w, plan)
    kw = dict(moments=epi == "moments")
    if epi.startswith("affine"):
        kw.update(g=torch.rand((ws[0],), generator=gen).cuda() + 0.5,
                  b=torch.randn((ws[0],), generator=gen).cuda() * 0.1,
                  act=epi.rsplit("+", 1)[1])
        if "+res" in epi:
            kw["res"] = torch.randn(
                (xs[0], plan.ho, plan.wo, ws[0]),
                generator=gen).to(dtype).cuda()
    return x, w, plan, xp, wk, kw


def phase_conv(card):
    """B10 against its plain version at every distinct conv of the
    ResNet-50 path at batch 128 (bf16 under O1), in bf16 and in f16:
    the training forward (moments epilogue), the dx parity planes
    (none), the eval forward (affine, with and without the residual,
    ReLU or identity), recorded from one training step and one eval
    forward of the real model; y within one ulp of the operand dtype,
    the moments within 1e-4; f32 at three of them. Each timed with CUDA
    events (L2 flushed, the long spin) beside the plain version,
    cuDNN's F.conv2d in the same dtype on the same NCHW operands (the
    yardstick, never called by the port) and the bound, summed over a
    step's launches in all and by class (`_conv_class`); the registers
    and blocks per SM of each tile. Returns the B10 row summed over one
    training step's launches (bf16; `fp16_*` f16)."""
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops import fused_conv
    from paddle_tpu_torch.ops.nn_ops import pad_nd

    train_calls, eval_calls = _record_resnet_convs()
    bw, _, _, bf16_peak = _peaks(card)
    flush = torch.empty(32 * 1024 * 1024, device="cuda")   # 128 MB
    gen = torch.Generator().manual_seed(10)
    half = (torch.bfloat16, torch.float16)
    shapes = []
    step = {dt: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
            for dt in half}
    by_class = {str(dt): {} for dt in half}
    err = {dt: 0.0 for dt in half}
    ulps_max = {dt: 0.0 for dt in half}
    keys = sorted(set(train_calls) | set(eval_calls))
    f32_keys = {max(keys, key=lambda k_: k_[1][1] * k_[1][2] * k_[1][3]),
                keys[0], keys[-1]}
    for key in keys:
        xs, ws, s, pads, epi = key
        per_step = train_calls.get(key, 0)
        for dtype in half + ((torch.float32,) if key in f32_keys else ()):
            x, w, plan, xp, wk, kw = _conv_operands(key, dtype, gen)
            got = fused_conv._conv_kernel(xp, wk, plan, **kw)
            want = fused_conv._conv_plain(xp, wk, plan, **kw)
            torch.cuda.synchronize()
            y, yw = got[0].float(), want[0].float()
            if dtype == torch.float32:
                torch.testing.assert_close(
                    y, yw, rtol=1e-5, atol=1e-5 * float(yw.abs().max()))
                mtol = 1e-5
            else:
                ulps = _ulps(y, yw, dtype)
                _check(ulps <= 1.0,
                       f"B10 {key}: {ulps} {dtype} ulps off plain")
                ulps_max[dtype] = max(ulps_max[dtype], ulps)
                err[dtype] = max(err[dtype], (y - yw).abs().max().item())
                mtol = 1e-4
            for gm, wm in zip(got[1:], want[1:]):
                torch.testing.assert_close(
                    gm, wm, rtol=mtol, atol=mtol * float(wm.abs().max()))
            if dtype == torch.float32:
                print(json.dumps({"conv_check_f32": list(key),
                                  "max_abs_err": (y - yw).abs().max().item()}),
                      flush=True)
                continue
            # the wrapper's host work (and the moments' two row sums)
            # can outlast the default spin: time the device after a long
            # one, cuDNN alike
            ms = _time_ms(lambda: fused_conv._conv_kernel(xp, wk, plan, **kw),
                          flush, n=20, spin=AUTOGRAD_SPIN)
            plain_ms = _time_ms(
                lambda: fused_conv._conv_plain(xp, wk, plan, **kw), flush,
                n=5)
            xpad = pad_nd(x, pads)
            lib_ms = _time_ms(lambda: tF.conv2d(xpad, w, stride=s), flush,
                              n=20, spin=AUTOGRAD_SPIN)
            m, o = xs[0] * plan.ho * plan.wo, ws[0]
            real = 2.0 * m * o * ws[1] * ws[2] * ws[3]
            lowered = 2.0 * m * o * fused_conv._CHUNK_K * len(
                fused_conv._live_chunks(plan, wk.shape[1]))
            nbytes = (xp.numel() + wk.numel() + m * o) * 2 + \
                (m * o * 2 if "res" in kw else 0) + \
                (2 * o * 4 if epi != "none" else 0)
            t_bytes, t_ops = nbytes / bw * 1e3, real / bf16_peak * 1e3
            row = dict(x=list(xs), w=list(ws), stride=s, pads=list(pads),
                       epilogue=epi, dtype=str(dtype),
                       launches_per_step=per_step,
                       eval_launches=eval_calls.get(key, 0), ms=ms,
                       plain_ms=plain_ms, cudnn_ms=lib_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       real_gflop=real / 1e9, lowered_gflop=lowered / 1e9,
                       ulps=ulps)
            if dtype == torch.bfloat16:
                shapes.append(row)
            print(json.dumps({"conv_shape": row}), flush=True)
            for k_, v in (("ms", ms), ("plain_ms", plain_ms),
                          ("library_ms", lib_ms),
                          ("bound_ms", row["bound_ms"])):
                step[dtype][k_] += per_step * v
            cls = by_class[str(dtype)].setdefault(_conv_class(key), dict(
                launches=0, ms=0.0, cudnn_ms=0.0, bound_ms=0.0))
            cls["launches"] += per_step
            for k_, v in (("ms", ms), ("cudnn_ms", lib_ms),
                          ("bound_ms", row["bound_ms"])):
                cls[k_] += per_step * v
            del x, w, xp, wk, got, want
    t_bytes = sum(r["launches_per_step"] * r["bound_ms"] for r in shapes
                  if r["bound_by"] == "bytes")
    bf16, f16 = step[torch.bfloat16], step[torch.float16]
    t_ops = bf16["bound_ms"] - t_bytes
    per_step_total = sum(train_calls.values())
    print(json.dumps({"b10_per_step": {str(dt): v for dt, v in step.items()},
                      "launches": per_step_total,
                      "distinct_shapes": len(keys),
                      "max_ulps": {str(dt): v for dt, v in
                                   ulps_max.items()}}), flush=True)
    print(json.dumps({"b10_per_step_by_class": by_class}), flush=True)
    for tile_n in (64, 128, 256):
        for dtype in half:
            print(json.dumps({"conv_occupancy": f"{dtype} tile_n {tile_n}",
                              **fused_conv._occupancy(tile_n, dtype)}),
                  flush=True)
    return dict(
        name="fused_conv2d_bn_act",
        route="cuda", source="paddle_tpu_torch/csrc/fused_conv.cu",
        replaces="paddle_tpu/ops/fused_conv.py:232 (_conv_kernel)",
        max_abs_err=err[torch.bfloat16], ms=bf16["ms"],
        plain_ms=bf16["plain_ms"], library_ms=bf16["library_ms"],
        bound_ms=bf16["bound_ms"],
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library="cuDNN F.conv2d in the operands' dtype (bf16; fp16_* in "
        "f16) on the NCHW operands, no epilogue",
        per="one training step's launches, summed",
        fp16_max_abs_err=err[torch.float16],
        fp16_max_ulps=ulps_max[torch.float16], fp16_ms=f16["ms"],
        fp16_plain_ms=f16["plain_ms"], fp16_library_ms=f16["library_ms"])


SLICE_MODELS = ((18, 64), (50, 16))     # (depth, width)
# (loss, change) gates of phase_resnet_slice. The CPU against itself,
# input moved by 1e-6 over 8 draws: loss 8.3e-6 / 1.58e-4 relative, a
# leaf's change 0.019 / 0.111 of its norm; with conv dx zeroed a leaf's
# change reads 1.0 in both models. ResNet-18's loss gate stays 1e-5; the
# others are about twice the spread.
SLICE_GATES = {(18, 64): (1e-5, 0.05), (50, 16): (3e-4, 0.3)}


def resnet_slice_step(depth, width, dev, imgs, labels):
    """One slice model (s2d stem, 4 classes, _resnet_values(model, 0)) on
    `dev`: its eval logits, B10's launches in that forward, then one
    Momentum step (lr 1e-3, f32): the loss and each parameter's and
    running stat's change over the step (host tensors)."""
    import torch

    from paddle_tpu_torch import weights
    from paddle_tpu_torch.ops import fused_conv

    model = _resnet_model(dev, depth, width=width, num_classes=4,
                          space_to_depth_stem=True)
    vals = _resnet_values(model, 0)
    weights.from_paddle_tpu_values(vals, model)
    model.eval()
    before = fused_conv.LAUNCHES
    with torch.no_grad():
        logits = model(torch.from_numpy(imgs).to(dev)).cpu()
    fwd_launches = fused_conv.LAUNCHES - before
    model.train()
    eng = _resnet_engine(model, dev, lr=1e-3)
    loss = float(eng.train_batch(imgs, labels))
    after = {**eng.state.params, **eng.state.buffers}
    delta = {k: after[k].detach().cpu() - torch.from_numpy(v)
             for k, v in vals.items()}
    return logits, loss, delta, fwd_launches, model


def slice_delta_err(got, want):
    """The worst leaf's |got - want| / |want| over one step's changes, L2
    norms over each leaf, and its name."""
    errs = {k: float((got[k] - w).norm() / w.norm().clamp_min(1e-30))
            for k, w in want.items()}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def phase_resnet_slice():
    """A tiny ResNet-18 and a narrow bottleneck ResNet-50 (width 16) on
    cuda against the same models on the CPU (B10's plain version), with
    the same random weights and running stats, f32, batch 4 x 3 x 64 x
    64: the eval logits within 1e-4 of their scale, then one Momentum
    step (lr 1e-3): the loss, and each parameter's and running stat's
    change over the step, in L2 norm relative to that change's own norm.
    The gates lie between the CPU's own spread when its input moves by
    1e-6 (8 draws) and the reading of a planted fault (conv dx zeroed on
    the CPU), both measured by `python tests/test_torch_resnet.py chip`:
    the gradient is discontinuous at every ReLU, and f32 noise flips the
    masks of pre-activations within ~5e-6 of 0. SLICE_GATES holds (loss,
    change) per model."""
    import torch

    imgs, labels = _resnet_batch(4, 64, classes=4, seed=4)
    for depth, width in SLICE_MODELS:
        loss_tol, delta_tol = SLICE_GATES[(depth, width)]
        lc, loss_c, dc, nc, model = resnet_slice_step(depth, width, "cuda",
                                                      imgs, labels)
        lp, loss_p, dp, npl, _ = resnet_slice_step(depth, width, "cpu",
                                                   imgs, labels)
        _check(nc == _b10_per_step(model)[1] and npl == 0,
               f"resnet{depth}: eval forward launched B10 {nc}x / {npl}x")
        torch.testing.assert_close(lc, lp, rtol=1e-4,
                                   atol=1e-4 * float(lp.abs().max()))
        loss_rel = abs(loss_c - loss_p) / abs(loss_p)
        worst, leaf = slice_delta_err(dc, dp)
        print(json.dumps({"resnet_slice_vs_plain": f"resnet{depth} w{width}",
                          "max_logit_diff": float((lc - lp).abs().max()),
                          "loss": [loss_c, loss_p], "loss_rel": loss_rel,
                          "worst_change_rel": worst, "worst_leaf": leaf,
                          "gates": [loss_tol, delta_tol]}), flush=True)
        _check(loss_rel <= loss_tol,
               f"resnet{depth}: loss {loss_c} vs {loss_p}")
        _check(worst <= delta_tol,
               f"resnet{depth}: {leaf}'s change off by {worst} of its norm")


def phase_resnet_full(card, n=10, warm=2):
    """ResNet-50 as bench.py trains it: resnet50(num_classes=1000,
    space_to_depth_stem=True), CrossEntropyLoss, Momentum(0.1, 0.9,
    weight_decay=1e-4), batch 128 x 3 x 224 x 224 rand images and
    random labels from RandomState(0), the same batch every step, bf16
    auto_cast O1. `warm` steps, then `n` timed on the host clock (each
    ending in a synchronise) with B10's launch count set to 0 just
    before them and read just after."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp, observe
    from paddle_tpu_torch.ops import fused_conv

    model = _resnet_model("cuda", space_to_depth_stem=True)
    eng = _resnet_engine(model, "cuda")
    imgs, labels = _resnet_batch(RESNET_BATCH, RESNET_HW)
    per_step, per_fwd = _b10_per_step(model)

    def step():
        with amp.auto_cast(enable=True, dtype="bfloat16"):
            return eng.train_batch(imgs, labels)

    losses = [float(step()) for _ in range(warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    fused_conv.LAUNCHES = 0
    with observe.no_retrace():
        for _ in range(n):
            t0 = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
    launches = fused_conv.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    _check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    _check(launches == per_step * n,
           f"B10 ran {launches}x in {n} steps, derived {per_step} a step")
    step_s = float(np.median(times))
    img_s = RESNET_BATCH / step_s
    out = {
        "train": "resnet-50 s2d b128 224 bf16 Momentum", "steps": n,
        "step_ms_p50": step_s * 1e3,
        "step_ms_p90": float(np.percentile(times, 90)) * 1e3,
        "images_per_s": img_s,
        "mfu": img_s * 3.0 * _resnet50_fwd_flops(RESNET_HW) / _peaks(card)[3],
        "peak_mem_bytes": peak, "losses": losses,
        "b10_launches_per_step": launches / n, "derived_per_step": per_step,
    }
    print(json.dumps(out), flush=True)
    return out, eng, model, step, per_fwd


def phase_resnet_eval(model, per_fwd, n=10, warm=2):
    """model.eval() forwards at batch 128 under bf16 auto_cast: the
    affine epilogue (BN folded into the conv); B10's launches per
    forward must equal the derived count."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import fused_conv

    model.eval()
    imgs, _ = _resnet_batch(RESNET_BATCH, RESNET_HW)
    x = torch.from_numpy(imgs).cuda()

    def fwd():
        with torch.no_grad(), amp.auto_cast(enable=True, dtype="bfloat16"):
            return model(x)

    for _ in range(warm):
        fwd()
    torch.cuda.synchronize()
    fused_conv.LAUNCHES = 0
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        logits = fwd()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = fused_conv.LAUNCHES
    _check(launches == per_fwd * n,
           f"eval: B10 ran {launches}x in {n} forwards, derived {per_fwd}")
    _check(bool(torch.isfinite(logits).all()) and
           tuple(logits.shape) == (RESNET_BATCH, 1000),
           "eval logits malformed")
    step_s = float(np.median(times))
    out = {"eval": "resnet-50 s2d b128 224 bf16", "forwards": n,
           "forward_ms_p50": step_s * 1e3,
           "images_per_s": RESNET_BATCH / step_s,
           "b10_launches_per_forward": launches / n}
    print(json.dumps(out), flush=True)
    return out

class _CkptTimes:
    """Times the checkpoint path from the outside: the async manager's
    snapshot on the step thread (`_to_host`, host clock) and its
    background write (`_write`: the wait for the device->host copies,
    hashing, the files and the commit), and each `load_state` (read,
    verify, host->device, synchronised), after which the restored leaves
    are re-hashed against the manifest (`verify_manifest`, timed on its
    own: it also checks the bytes that landed on the card)."""

    def __enter__(self):
        import torch

        from paddle_tpu_torch.distributed import checkpoint as ck

        self.times = {"snapshot_ms": [], "write_s": [], "restore_s": [],
                      "verify_s": []}
        cls = ck.AsyncCheckpointManager
        self._orig = (cls.__dict__["_to_host"], cls._write, ck.load_state)
        to_host, write, load_state = self._orig

        def timed_to_host(state):
            t0 = time.perf_counter()
            out = to_host.__func__(state)
            self.times["snapshot_ms"].append(
                (time.perf_counter() - t0) * 1e3)
            return out

        def timed_write(mgr, *args):
            t0 = time.perf_counter()
            write(mgr, *args)
            self.times["write_s"].append(time.perf_counter() - t0)

        def timed_load(path, template, **kw):
            t0 = time.perf_counter()
            out = load_state(path, template, **kw)
            torch.cuda.synchronize()
            self.times["restore_s"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            ck.verify_manifest(path, out)
            self.times["verify_s"].append(time.perf_counter() - t0)
            return out

        cls._to_host = staticmethod(timed_to_host)
        cls._write = timed_write
        ck.load_state = timed_load
        return self.times

    def __exit__(self, *exc):
        from paddle_tpu_torch.distributed import checkpoint as ck

        cls = ck.AsyncCheckpointManager
        cls._to_host, cls._write, ck.load_state = self._orig


def _dir_bytes(path):
    import os

    return sum(os.path.getsize(os.path.join(root, f))
               for root, _dirs, files in os.walk(path) for f in files)


def _rel_dev(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def phase_ckpt_resume(fused_leg, tmp):
    """Leg A, resume after a preemption, ERNIE-1.0 at full width as the
    fused leg of 9 builds it (b32 x s512, bf16 O1, AdamW, the fused loss,
    weight and engine seeds 0): `train_epoch_range` with async saves
    (max_to_keep 2), epochs of 2 steps and FLAGS_simulate_preempt_at_step
    2 must commit an emergency checkpoint after epoch 1, write the
    PREEMPTED marker and raise PreemptedError. An engine built from other
    weight and engine seeds (1, 1) then resumes at epoch 2 and runs
    epochs 2-3; all 8 losses must repeat the fused leg's first 8 within
    rtol 1e-5 (whether they repeat bit for bit is printed). B1-B6 launch
    counts are set to 0 before the leg and read after it."""
    import os

    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import checkpoint, preempt
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.nlp.transformers import ErnieConfig
    from paddle_tpu_torch.ops import fused_loss, fused_ops

    set_flags({"FLAGS_use_fused_lm_loss": True, "FLAGS_lowp_matmul": "off"})
    cfg = ErnieConfig(**ERNIE)
    ids, labels = _ernie_batch(cfg.vocab_size, ERNIE_BATCH, ERNIE_SEQ)

    def epochs(eng, max_epoch, losses):
        done = []
        for epoch in checkpoint.train_epoch_range(
                max_epoch, tmp, eng, async_save=True, max_to_keep=2):
            for _ in range(2):
                with amp.auto_cast(enable=True, dtype="bfloat16"):
                    losses.append(float(eng.train_batch(ids, labels)))
            done.append(epoch)
        return done

    fused_ops.flash_attention.launches.update(B1=0, B2=0, B3=0)
    fused_loss.launches.update(B4=0, B5=0, B6=0)
    saves0 = monitor.stat_get("preempt_emergency_saves")
    losses = []
    ckdir = os.path.join(tmp, "auto_ckpt")
    marker = os.path.join(ckdir, preempt.MARKER_NAME)
    with _CkptTimes() as times:
        eng = _ernie_engine(cfg, "cuda", 0, 0, 1e-4)
        set_flags({"FLAGS_simulate_preempt_at_step": 2})
        try:
            epochs(eng, 4, losses)
            preempted = False
        except preempt.PreemptedError:
            preempted = True
        finally:
            set_flags({"FLAGS_simulate_preempt_at_step": 0})
            preempt.uninstall()
        _check(preempted and len(losses) == 4 and os.path.exists(marker) and
               monitor.stat_get("preempt_emergency_saves") == saves0 + 1,
               f"the simulated preemption: raised {preempted}, "
               f"{len(losses)} steps, marker {os.path.exists(marker)}")
        ckpt_bytes = _dir_bytes(os.path.join(ckdir, "ckpt-1"))
        del eng
        torch.cuda.empty_cache()
        preempt.clear()
        eng = _ernie_engine(cfg, "cuda", 1, 1, 1e-4)
        try:
            done = epochs(eng, 4, losses)
        finally:
            preempt.uninstall()
    launches = {**fused_ops.flash_attention.launches, **fused_loss.launches}
    del eng
    torch.cuda.empty_cache()
    _check(done == [2, 3] and not os.path.exists(marker),
           f"resumed at epochs {done}, marker left: {os.path.exists(marker)}")
    want = fused_leg["losses"][:8]
    dev = _rel_dev(losses, want)
    _check(len(losses) == 8 and dev <= 1e-5,
           f"resumed losses {losses} vs uninterrupted {want}")
    _check(all(launches[k] > 0 for k in launches),
           f"leg A launches {launches}")
    out = {"ckpt_resume": "ernie-1.0 b32 s512 bf16, async, preempted "
                          "after epoch 1 of 2-step epochs",
           "ckpt_bytes": ckpt_bytes, "losses": losses,
           "uninterrupted_losses": want, "max_rel_dev": dev,
           "bitwise": losses == want, **times, "launches": launches}
    print(json.dumps(out), flush=True)
    return out


def phase_ckpt_rollback(resnet_leg, tmp, n=10):
    """Leg B, the anomaly guard's rollback, ResNet-50 as the leg of 19
    trains it (s2d stem, b128 x 224, bf16 O1, Momentum), guarded, with
    FLAGS_anomaly_max_bad_steps 2 and FLAGS_anomaly_check_interval 1. A
    clean guarded engine runs 4 steps; then it and an unguarded engine
    take `n` steps each in turns (the order alternating, each step timed
    on the host clock and ending in a synchronise): the two p50s and the
    median of the paired differences are the guard's cost, printed
    beside the unguarded p50 of 19. A second guarded engine, the same
    seeds, under
    ``train.batch@3-4:nan``: 2 steps, `CheckpointManager.save_engine`,
    2 poisoned steps; exactly one rollback must follow, to step 2, after
    which every parameter, velocity and running stat hashes to the saved
    manifest; 2 replayed steps must repeat the clean run's steps 3-4
    within rtol 1e-5 (bit for bit is printed). The rollback's host time
    is that of the `_check_anomaly` call that restored (synchronised).
    B10's launch count is set to 0 before the leg and read after it."""
    import os

    import numpy as np
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import checkpoint
    from paddle_tpu_torch.framework import faults, monitor
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.ops import fused_conv

    set_flags({"FLAGS_anomaly_max_bad_steps": 2,
               "FLAGS_anomaly_check_interval": 1})
    imgs, labels = _resnet_batch(RESNET_BATCH, RESNET_HW)

    def engine():
        model = _resnet_model("cuda", space_to_depth_stem=True)
        return _resnet_engine(model, "cuda", anomaly_guard=True)

    def step(eng):
        with amp.auto_cast(enable=True, dtype="bfloat16"):
            loss = eng.train_batch(imgs, labels)
        torch.cuda.synchronize()
        return float(loss)

    fused_conv.LAUNCHES = 0
    eng = engine()
    clean = [step(eng) for _ in range(4)]
    plain = _resnet_engine(_resnet_model("cuda", space_to_depth_stem=True),
                           "cuda")
    step(plain)
    step(plain)
    times = {"guarded": [], "unguarded": []}
    for i in range(n):
        pair = [("guarded", eng), ("unguarded", plain)]
        for name, e in pair if i % 2 == 0 else pair[::-1]:
            t0 = time.perf_counter()
            step(e)
            times[name].append(time.perf_counter() - t0)
    del eng, plain
    torch.cuda.empty_cache()

    eng = engine()
    mgr = checkpoint.CheckpointManager(os.path.join(tmp, "rollback"))
    eng.attach_checkpoint_manager(mgr)
    checks = []
    check_anomaly = eng._check_anomaly

    def timed_check():
        t0 = time.perf_counter()
        check_anomaly()
        torch.cuda.synchronize()
        checks.append(time.perf_counter() - t0)

    eng._check_anomaly = timed_check
    rollbacks0 = monitor.stat_get("anomaly_rollbacks")
    with faults.inject("train.batch@3-4:nan"):
        losses = [step(eng) for _ in range(2)]
        mgr.save_engine(2, eng)
        losses += [step(eng) for _ in range(2)]
    rollbacks = monitor.stat_get("anomaly_rollbacks") - rollbacks0
    _check(_rel_dev(losses[:2], clean[:2]) <= 1e-5 and
           bool(np.isnan(losses[2:]).all()),
           f"rollback leg losses {losses}, clean {clean}")
    _check(rollbacks == 1 and eng.state.step == 2,
           f"{rollbacks} rollbacks, engine at step {eng.state.step}")
    st = eng.state
    got = checkpoint.leaf_digests({"params": st.params,
                                   "opt_state": st.opt_state,
                                   "buffers": st.buffers})
    saved = {k: v["sha256"] for k, v in checkpoint.load_manifest(
        os.path.join(tmp, "rollback", "ckpt-2")).items()}
    _check(got == saved and "['buffers']['bn1._mean']" in got,
           f"restored leaves off the manifest: "
           f"{sorted(k for k in saved if got.get(k) != saved[k])[:8]}")
    replay = [step(eng) for _ in range(2)]
    launches = fused_conv.LAUNCHES
    del eng
    torch.cuda.empty_cache()
    dev = _rel_dev(replay, clean[2:4])
    _check(dev <= 1e-5, f"replayed losses {replay} vs clean {clean[2:4]}")
    _check(launches > 0, "leg B launched no B10")
    p50 = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
    pair_ms = float(np.median(np.subtract(times["guarded"],
                                          times["unguarded"]))) * 1e3
    out = {"ckpt_rollback": "resnet-50 s2d b128 224 bf16, guarded, "
                            "train.batch@3-4:nan",
           "rollbacks": rollbacks, "rollback_ms": max(checks) * 1e3,
           "ckpt_bytes": _dir_bytes(os.path.join(tmp, "rollback", "ckpt-2")),
           "leaves_checked": len(got), "replay_losses": replay,
           "clean_losses": clean, "max_rel_dev": dev,
           "bitwise": replay == clean[2:4],
           "guarded_step_ms_p50": p50["guarded"],
           "unguarded_in_turns_ms_p50": p50["unguarded"],
           "guard_cost_ms_median_pair": pair_ms,
           "unguarded_step_ms_p50": resnet_leg["step_ms_p50"],
           "b10_launches": launches}
    print(json.dumps(out), flush=True)
    return out


def phase_checkpoint(fused_leg, resnet_leg):
    """Phases 22-23 in one temporary directory, removed at the end (the
    flight recorder's dumps go there too); then phase 36, their goodput:
    the step timeline is emptied before the legs, and after them its
    checkpoint and restore categories, the async writes' overlapped
    seconds and the productive (device-step) seconds must be above 0."""
    import shutil
    import tempfile

    from paddle_tpu_torch import observe
    from paddle_tpu_torch.framework.flags import get_flags, set_flags

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    saved = get_flags(["FLAGS_flight_recorder_dir",
                       "FLAGS_anomaly_max_bad_steps",
                       "FLAGS_anomaly_check_interval"])
    set_flags({"FLAGS_flight_recorder_dir": tmp})
    observe.timeline.reset()
    try:
        resume = phase_ckpt_resume(fused_leg, tmp)
        rollback = phase_ckpt_rollback(resnet_leg, tmp)
    finally:
        set_flags(saved)
        shutil.rmtree(tmp, ignore_errors=True)
    gp = observe.goodput()
    cats = gp["categories_s"]
    _check(cats["checkpoint"] > 0 and cats["restore"] > 0 and
           gp["overlapped_s"] > 0 and cats["productive"] > 0,
           f"goodput of the checkpoint legs: {gp}")
    print(json.dumps({"phase": 36, "goodput": gp,
                      "phases": observe.timeline.aggregates()}), flush=True)
    return resume, rollback


# -- phases 24-28: serving features on one card ------------------------------


def _serve(model, prompts, max_new, device="cuda", adapters=None, **kw):
    """Serve `prompts` through `Server(**SERVING, **kw)` as phase 4 does
    (all submitted at once, greedy); the B7 / B8 counts are set to 0
    just before the server starts and read after it drains. `adapters`
    gives each prompt's adapter id. Returns (generated tokens, the
    snapshot, the engine, wall seconds, {"B7": n, "B8": n})."""
    import numpy as np

    from paddle_tpu_torch.ops import lowp, quant_ops
    from paddle_tpu_torch.serving import Server

    srv = Server(model, device=device, **SERVING, **kw)
    quant_ops.dequant_matmul.launches = 0
    lowp.w8a8_matmul.launches = 0
    srv.start()
    t0 = time.monotonic()
    futs = [srv.submit(p, max_new_tokens=max_new, timeout=600.0,
                       adapter_id=adapters[i] if adapters else 0)
            for i, p in enumerate(prompts)]
    outs = [np.asarray(f.result(600.0)) for f in futs]
    wall = time.monotonic() - t0
    srv.shutdown(drain=True)
    launches = {"B7": quant_ops.dequant_matmul.launches,
                "B8": lowp.w8a8_matmul.launches}
    snap = srv.snapshot()
    for p, o in zip(prompts, outs):
        _check(o.shape == (p.size + max_new,) and
               np.array_equal(o[:p.size], p) and
               o.min() >= 0 and o.max() < model.config.vocab_size,
               "malformed result")
    _check(snap["counters"]["completed"] == len(prompts) and
           snap["counters"].get("failed", 0) == 0,
           f"not every request completed: {snap['counters']}")
    _, samples = _exposition(srv.metrics_prometheus())
    _check(samples["paddle_serving_tokens_out_total"] ==
           snap["counters"]["tokens_out"],
           "the exposition's served tokens differ from the snapshot's")
    _compiled_once(srv.engine)
    return ([o[p.size:] for p, o in zip(prompts, outs)], snap, srv.engine,
            wall, launches)


# one line of Prometheus text exposition (a HELP / TYPE comment or a
# sample), as tests/test_torch_observe.py parses it
_PROM_LINE = (r"^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+"
              r"|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9].*)$")


def _exposition(text):
    """(family names, {series: value}) of Prometheus text; every line
    must parse as exposition."""
    import re

    fams, samples = set(), {}
    for ln in filter(None, text.splitlines()):
        _check(re.match(_PROM_LINE, ln), f"not exposition text: {ln!r}")
        if ln.startswith("# TYPE "):
            fams.add(ln.split()[2])
        elif not ln.startswith("#"):
            key, value = ln.rsplit(" ", 1)
            samples[key] = float(value)
    return fams, samples


def _compiled_once(eng):
    """The engine compiled each of its step functions once (at its
    warm-up: the unified step, the copy-on-write copy and, speculating,
    the draft step), and a second warm-up, which runs under
    `observe.no_retrace()`, compiles nothing."""
    want = dict(decode=1, cow=1, **({"draft": 1} if eng.spec_len else {}))
    _check(eng.compile_counts == want,
           f"{eng.name}: compile_counts {eng.compile_counts}, want {want}")
    _check(eng.warmup() == want, f"{eng.name}: a second warm-up compiled")


def _fleet_compiled_once(router):
    """`Router.compile_counts()`: every live replica's engine at one
    compile of each step function."""
    got = {k: v for k, v in router.compile_counts().items() if v}
    _check(got and all(v == {"decode": 1, "cow": 1} for v in got.values()),
           f"fleet compile_counts {got}")
    return got


def _agreement(a, b):
    """Share of equal generated tokens between two legs."""
    import numpy as np

    return sum(int(np.sum(x == y)) for x, y in zip(a, b)) / \
        sum(x.size for x in a)


def _leg_line(phase, name, snap, wall, n_tokens, launches, **extra):
    step = snap["latency_s"]["step"]
    print(json.dumps({
        "phase": phase, "leg": name, "wall_s": wall,
        "tokens_per_s": n_tokens / wall, "steps": snap["counters"]["steps"],
        "step_p50_ms": step["p50"] * 1e3, "step_p99_ms": step["p99"] * 1e3,
        "launches": launches, **extra}), flush=True)


def phase_bf16_pool(model, ref, device="cuda"):
    """Phase 24: the f32 and int8 legs of 4 with a bf16 KV pool. The
    pool bytes must be exactly half of phase 4's; token agreement with
    phase 4's same leg is printed. Returns the B7 launches."""
    import torch

    prompts = _serving_prompts(model.config.vocab_size)
    b7 = 0
    for name, kw in (("f32", {}), ("int8", dict(quantize=True))):
        toks, snap, eng, wall, launches = _serve(
            model, prompts, SERVING_MAX_NEW, device,
            cache_dtype=torch.bfloat16, **kw)
        want = ref["kv_pool_bytes"][name]
        _check(2 * eng.kv_pool_bytes == want,
               f"bf16 {name}: pool {eng.kv_pool_bytes} bytes, not half of "
               f"{want}")
        steps = snap["counters"]["steps"]
        _check(launches["B7"] == (steps + 1 if name == "int8" else 0) and
               launches["B8"] == 0,
               f"bf16 {name}: launches {launches} in {steps} steps")
        b7 += launches["B7"]
        _leg_line(24, f"bf16 pool, {name}", snap, wall,
                  len(prompts) * SERVING_MAX_NEW, launches,
                  kv_pool_bytes=eng.kv_pool_bytes, f32_pool_bytes=want,
                  token_agreement_vs_phase4=_agreement(
                      toks, ref["tokens"][name]))
    _pool_pair(model, device=device)
    return b7


def _pool_pair(model, rounds=10, steps=5, device="cuda"):
    """Phase 24's cost of the bf16 pool: an f32-pool and a bf16-pool
    engine (f32 weights), all 8 slots decoding the same prompts, take
    `steps` decode steps each in turns (the order alternating) for
    `rounds` rounds on the host clock; then 5 steps of each under
    torch.profiler for the device's kernel ms and the launch calls a
    step. The per-round ratio's median is the comparison."""
    import numpy as np
    import torch

    engs = {"f32": _decode_engine(model, 96, device),
            "bf16": _decode_engine(model, 96, device,
                                   cache_dtype=torch.bfloat16)}
    times = {key: [] for key in engs}
    for r in range(rounds):
        for key in (("f32", "bf16") if r % 2 == 0 else ("bf16", "f32")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                engs[key]._step()
            times[key].append((time.perf_counter() - t0) * 1e3 / steps)
    out = {"rounds": rounds, "steps_per_round": steps,
           "bf16_over_f32_p50": float(np.median(
               np.asarray(times["bf16"]) / np.asarray(times["f32"])))}
    for key, eng in engs.items():
        busy, launches, kernels = _profile_steps(eng, 5)
        live = sum(s is not None and s.state == "decode"
                   for s in eng._slots)
        _check(live == 8 and eng.metrics.get("failed") == 0,
               f"pool pair {key}: {live} slots decoding at the end")
        _compiled_once(eng)
        out[key] = {"step_ms_p50": float(np.median(times[key])),
                    "step_ms": times[key], "device_busy_ms": busy,
                    "launches_per_step": launches,
                    "top_kernels_ms_per_step": _top_kernels(kernels, 5)}
    print(json.dumps({"phase": 24, "pool_pair": out}), flush=True)
    del engs
    torch.cuda.empty_cache()


def phase_spec(model, ref, device="cuda"):
    """Phase 25: speculative decoding, self-draft, k = 3, in the f32,
    int8 (B7) and w8a8 (B8) legs of 4. Every leg must draft (rounds and
    drafted tokens above 0, no draft fault) and take fewer steps than
    phase 4's same leg; the f32 and int8 legs must accept every drafted
    token (the self-draft is the greedy model). The int8 leg's tokens
    must equal phase 4's int8 leg bit for bit, with exactly 2 B7
    launches a step (the last rows' head and the verify head over 8 x 4
    rows) and one step of warmup; the w8a8 leg 2 B8 launches a step
    after a B7 warmup. Acceptance, steps, tokens/s, step p50 / p99 and
    token agreement with phase 4's same leg are printed. Returns the B7
    and B8 launches."""
    prompts = _serving_prompts(model.config.vocab_size)
    total = {"B7": 0, "B8": 0}
    legs = {"f32": {}, "int8": dict(quantize=True),
            "w8a8": dict(quantize=True, w8a8=True)}
    for name, kw in legs.items():
        toks, snap, eng, wall, launches = _serve(
            model, prompts, SERVING_MAX_NEW, device, spec_len=3, **kw)
        steps = snap["counters"]["steps"]
        want = {"f32": {"B7": 0, "B8": 0},
                "int8": {"B7": 2 * (steps + 1), "B8": 0},
                "w8a8": {"B7": 2, "B8": 2 * steps}}[name]
        _check(launches == want,
               f"spec {name}: launches {launches}, want {want} "
               f"({steps} steps)")
        agree = _agreement(toks, ref["tokens"][name])
        if name == "int8":
            _check(agree == 1.0, f"spec int8: tokens differ from phase 4's "
                   f"int8 leg (agreement {agree})")
        spec = snap["speculative"]
        _check(spec["draft_faults"] == 0 and spec["rounds"] > 0 and
               spec["drafted_tokens"] > 0,
               f"spec {name}: the draft did not run: {spec}")
        _check(name == "w8a8" or spec["acceptance_rate"] == 1.0,
               f"spec {name}: acceptance {spec['acceptance_rate']}, not 1")
        _check(steps < ref["steps"][name],
               f"spec {name}: {steps} steps, phase 4 took "
               f"{ref['steps'][name]}")
        for key in total:
            total[key] += launches[key]
        _leg_line(25, f"spec k=3, {name}", snap, wall,
                  len(prompts) * SERVING_MAX_NEW, launches,
                  acceptance_rate=spec["acceptance_rate"],
                  rounds=spec["rounds"],
                  drafted_tokens=spec["drafted_tokens"],
                  kv_pool_bytes=eng.kv_pool_bytes,
                  token_agreement_vs_phase4=agree)
    return total


def phase_verify_head(card):
    """Phase 25, the kernels beside it: B7 and B8 at the verify head's
    32 rows (8 slots x 4 columns) against their 8-row calls on the same
    rows (bit for bit) and against the plain version (B7 within 1e-5,
    B8 bit for bit), then both calls timed as phase 2 times them, and
    the grid each launched at 32 rows read from the profiler's trace."""
    import torch

    from paddle_tpu_torch.ops import lowp, quant_ops

    gen = torch.Generator().manual_seed(3)
    q, s = (t.cuda() for t in _table(50304, 768, gen))
    x = torch.randn((32, 768), generator=gen).cuda()
    sa = x.abs().max()
    b7 = quant_ops.dequant_matmul(x, q, s)
    b8 = lowp.w8a8_matmul(x, q.t(), s, sa)
    for i in range(0, 32, 8):
        _check(torch.equal(b7[i:i + 8], quant_ops.dequant_matmul(
            x[i:i + 8], q, s)), "B7 at 32 rows differs from its 8-row call")
        _check(torch.equal(b8[i:i + 8], lowp.w8a8_matmul(
            x[i:i + 8], q.t(), s, sa)),
            "B8 at 32 rows differs from its 8-row call")
    want = quant_ops._dequant_matmul_plain(x, q, s.reshape(-1))
    torch.testing.assert_close(b7, want, rtol=1e-5, atol=1e-5)
    _check(torch.equal(b8, lowp._w8a8_plain(x, q.t(), s, sa)),
           "B8 at 32 rows differs from its plain version")
    flush = torch.empty(32 * 1024 * 1024, device="cuda")
    sc = s.reshape(-1)
    out = {"b7_max_abs_err_32": (b7 - want).abs().max().item()}
    for m in (8, 32):
        xm = x[:m]
        out[f"b7_ms_{m}"] = _time_ms(
            lambda: quant_ops._dequant_matmul_kernel(xm, q, sc), flush)
        out[f"b8_ms_{m}"] = _time_ms(
            lambda: lowp._w8a8_kernel(xm, q.t(), s, sa), flush)
    bw = _peaks(card)[0]
    out["table_bound_ms"] = q.numel() / bw * 1e3
    out["grid_32"] = _launch_grids(
        lambda: quant_ops._dequant_matmul_kernel(x, q, sc),
        lambda: lowp._w8a8_kernel(x, q.t(), s, sa))
    print(json.dumps({"phase": 25, "verify_head": out}), flush=True)
    return out


def _launch_grids(b7, b8, n=5):
    """The grid each of B7 (`dq_stream`) and B8 (`w8a8_stream`) launched
    with, read from torch.profiler's trace of `n` calls of `b7` and `b8`
    after two outside it, as the schedule warms up ({"B7": [x, y, z],
    ...}; y is the number of x tiles). The trace has been seen to keep
    none of these short kernels, so a trace without both is taken
    again, up to three times; every launch kept must show one grid."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _attempt in range(3):
        grids = {"B7": set(), "B8": set()}
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=1, warmup=1, active=n,
                                           repeat=1),
                         on_trace_ready=lambda p: p.export_chrome_trace(
                             str(path))) as prof:
                for _ in range(n + 2):
                    b7()
                    b8()
                    torch.cuda.synchronize()
                    prof.step()
            events = json.loads(path.read_text())["traceEvents"] \
                if path.exists() else []
        for ev in events:
            for key, name in (("B7", "dq_stream"), ("B8", "w8a8_stream")):
                grid = ev.get("args", {}).get("grid")
                if ev.get("cat") == "kernel" and name in ev.get("name", "") \
                        and grid:
                    grids[key].add(tuple(grid))
        if all(grids.values()):
            break
    _check(all(len(g) == 1 for g in grids.values()),
           f"the trace showed B7 / B8 launch grids {grids}")
    return {key: list(next(iter(g))) for key, g in grids.items()}


class _LoraRecorder:
    """Mixin of phase 26's engine: keeps, for each request, the hidden
    row and the logits behind its first pick, the adapter id and the
    step that made them, and the step count when a bank swap landed."""

    def _head(self, rows, quant):
        if rows.dim() == 2:
            self.last_rows = rows.detach().clone()
        return super()._head(rows, quant)

    def _step_plain(self):
        super()._step_plain()
        steps = self.metrics.get("steps")
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.state == "decode" \
                    and slot.produced == 0 and slot.req.id not in self.first:
                self.first[slot.req.id] = (
                    int(self._aid[i]), self.last_rows[i].cpu(),
                    slot.next_logits.copy(), steps)

    def _apply_adapter_swap(self, lora_a, lora_b, version):
        out = super()._apply_adapter_swap(lora_a, lora_b, version)
        self.swapped_at = self.metrics.get("steps")
        return out


def _lora_bank(seed, n, rank, hidden, vocab):
    """A seeded [n, r, H] / [n, V, r] bank, row 0 (base model) zero."""
    import numpy as np

    rng = np.random.RandomState(seed)
    la = (rng.randn(n, rank, hidden) * 0.02).astype(np.float32)
    lb = (rng.randn(n, vocab, rank) * 0.5).astype(np.float32)
    la[0] = 0.0
    lb[0] = 0.0
    return la, lb


# phase 26: first-step logits against B7's plus the plain delta; the
# delta is two f32 einsums (768 and 8 terms) summed on the card and on
# the CPU in other orders, ~1e-6 of logits of order 1
LORA_TOL = 1e-4


def phase_lora(model, ref, device="cuda"):
    """Phase 26: the int8 engine with max_adapters=4, lora_rank=8 under
    phase 4's traffic. The even prompts use adapter 0 and must equal
    phase 4's (bank-less) int8 leg bit for bit; the odd ones adapters
    1-3 of a seeded bank, and each one's first-step logits must equal
    B7's logits of its hidden row plus the plain delta within LORA_TOL.
    A second bank is swapped in mid-traffic from the caller's thread: no
    request fails, and every first step after the swap is held to the
    new bank. Returns the B7 launches."""
    import numpy as np
    import torch

    from paddle_tpu_torch.nlp.transformers.gpt import lora_logits_delta
    from paddle_tpu_torch.ops import lowp, quant_ops
    from paddle_tpu_torch.serving import SlotEngine

    class Engine(_LoraRecorder, SlotEngine):
        pass

    cfg = model.config
    prompts = _serving_prompts(cfg.vocab_size)
    adapters = [0 if i % 2 == 0 else 1 + (i // 2) % 3
                for i in range(len(prompts))]
    banks = [_lora_bank(s, 4, 8, cfg.hidden_size, cfg.vocab_size)
             for s in (1, 2)]
    # the engine Server builds, with the recorder mixed in
    eng = Engine(model, device=device, quantize=True, max_adapters=4,
                 lora_rank=8, **SERVING)
    eng.first, eng.swapped_at = {}, None
    eng.swap_adapters(*banks[0])
    quant_ops.dequant_matmul.launches = 0
    lowp.w8a8_matmul.launches = 0
    eng.warmup()
    eng.start()
    t0 = time.monotonic()
    futs = [eng.submit(p, max_new_tokens=SERVING_MAX_NEW, timeout=600.0,
                       adapter_id=a) for p, a in zip(prompts, adapters)]
    while eng.metrics.get("steps") < 8:
        time.sleep(0.002)
    version = eng.swap_adapters(*banks[1], timeout=60.0)
    outs = [np.asarray(f.result(600.0)) for f in futs]
    wall = time.monotonic() - t0
    eng.shutdown(drain=True)
    launches = {"B7": quant_ops.dequant_matmul.launches,
                "B8": lowp.w8a8_matmul.launches}
    snap = eng.metrics.snapshot()
    steps = snap["counters"]["steps"]
    _check(snap["counters"]["completed"] == len(prompts) and
           snap["counters"].get("failed", 0) == 0,
           f"lora: not every request completed: {snap['counters']}")
    _check(launches == {"B7": steps + 1, "B8": 0},
           f"lora: launches {launches} in {steps} steps")
    _compiled_once(eng)
    toks = [o[p.size:] for p, o in zip(prompts, outs)]
    for i in range(0, len(prompts), 2):
        _check(np.array_equal(toks[i], ref["tokens"]["int8"][i]),
               f"lora: adapter-0 request {i} differs from the bank-less "
               "int8 leg")
    qk, sk = eng._head_key
    q, s = eng._values[qk], eng._values[sk]
    worst, held = 0.0, {"old": 0, "new": 0}
    cpu_banks = [tuple(torch.from_numpy(t) for t in b) for b in banks]
    for aid, row, logits, step in eng.first.values():
        if aid == 0:
            continue
        which = "new" if step > eng.swapped_at else "old"
        la, lb = cpu_banks[1 if which == "new" else 0]
        base = quant_ops.dequant_matmul(row[None].to(device), q, s).cpu()
        want = base[0] + lora_logits_delta(
            row[None], torch.tensor([aid]), la, lb)[0]
        err = float((torch.from_numpy(logits) - want).abs().max())
        _check(err <= LORA_TOL, f"lora: adapter {aid}'s first-step logits "
               f"{err} from B7 + the plain delta ({which} bank)")
        worst = max(worst, err)
        held[which] += 1
    _check(held["old"] > 0 and held["new"] > 0,
           f"lora: first steps held to each bank: {held}")
    _leg_line(26, "lora int8, 4 adapters, rank 8", snap, wall,
              len(prompts) * SERVING_MAX_NEW, launches,
              adapter_version=version, swapped_at_step=eng.swapped_at,
              first_steps_held=held, max_abs_err=worst,
              token_agreement_vs_phase4=_agreement(
                  toks, ref["tokens"]["int8"]))
    return launches["B7"]


def phase_spill_migrate(model, tmp, device="cuda"):
    """Phase 27: the int8 engine's spill tier and KV migration. Turn 1
    serves 8 prompts of 256 tokens (32 new each); the drained server
    spills its radix cache to `tmp`. Turn 2, on a new server sharing the
    tier, extends each turn-1 sequence by 32 tokens: every spilled block
    must come back from disk (restored = spilled > 0, no spill error,
    fenced or corrupt read) and its tokens equal a cold engine's bit for
    bit. Migration: an engine that served turn 1
    exports each turn-2 prompt's cached blocks, a second engine on the
    card adopts them through a `KVMailbox`, and both continue alike.
    Record bytes, restore ms and the re-prefill ms it saved are
    printed. Returns the B7 launches."""
    import numpy as np

    from paddle_tpu_torch.serving import (
        KVMailbox, SlotEngine, migrate_prefix, payload_bytes,
        reset_spill_stores,
    )

    vocab = model.config.vocab_size
    rng = np.random.RandomState(27)
    turn1 = [rng.randint(1, vocab, (256,)).astype(np.int32)
             for _ in range(8)]
    n = SERVING_MAX_NEW
    b7 = 0
    first, snap1, eng1, _, l1 = _serve(model, turn1, n, device,
                                       quantize=True, spill_dir=tmp)
    store = eng1.spill_store
    stats = store.stats()
    b7 += l1["B7"]
    turn2 = [np.concatenate([p, t, rng.randint(1, vocab, (n,))]).astype(
        np.int32) for p, t in zip(turn1, first)]
    warm, snap2, eng2, wall2, l2 = _serve(model, turn2, n, device,
                                          quantize=True, spill_dir=tmp)
    cold, snap3, _, wall3, l3 = _serve(model, turn2, n, device,
                                       quantize=True)
    b7 += l2["B7"] + l3["B7"]
    spilled = snap1["counters"].get("kv_spilled_blocks", 0)
    restored = snap2["counters"].get("kv_restored_blocks", 0)
    _check(restored > 0, "spill: turn 2 restored nothing from disk")
    _check(restored == spilled,
           f"spill: {restored} blocks restored of {spilled} spilled")
    # the shared store counts its corrupt reads on turn 1's metrics
    errs = [snap["counters"].get(key, 0) for snap in (snap1, snap2)
            for key in ("kv_spill_errors", "kv_restore_fenced")]
    errs.append(store.metrics.get("kv_restore_corrupt"))
    _check(not any(errs), f"spill: errors, fenced and corrupt {errs}")
    for w, c in zip(warm, cold):
        _check(np.array_equal(w, c),
               "spill: the restored turn 2 differs from a cold engine")

    def total_ms(snap, kind):
        return snap["latency_s"].get(kind, {}).get("sum", 0.0) * 1e3

    print(json.dumps({
        "phase": 27, "spill": {
            "records": stats["records"], "file_bytes": stats["bytes"],
            "bytes_per_record": stats["bytes"] / max(stats["records"], 1),
            "spilled_blocks": spilled,
            "restored_blocks": restored,
            "restore_ms": total_ms(snap2, "kv_restore"),
            "prefill_ms_warm": total_ms(snap2, "prefill"),
            "prefill_ms_cold": total_ms(snap3, "prefill"),
            "reprefill_ms_saved": total_ms(snap3, "prefill")
            - total_ms(snap2, "prefill"),
            "prefill_tokens_warm": snap2["counters"].get("prefill_tokens"),
            "prefill_tokens_cold": snap3["counters"].get("prefill_tokens"),
            "turn2_wall_s_warm": wall2, "turn2_wall_s_cold": wall3,
            "launches": {"turn1": l1, "turn2_warm": l2, "turn2_cold": l3},
        }}), flush=True)
    reset_spill_stores()

    # migration: src serves turn 1 (its radix cache keeps the blocks),
    # dst adopts each turn-2 prompt's cached prefix and both continue
    src = SlotEngine(model, device=device, quantize=True, name="src",
                     **SERVING)
    dst = SlotEngine(model, device=device, quantize=True, name="dst",
                     **SERVING)
    for eng in (src, dst):
        eng.warmup()
    _drain(src, turn1[:4], n)
    box, adopted, moved, t_mig = KVMailbox(), [], 0, 0.0
    for p in turn2[:4]:
        t0 = time.monotonic()
        adopted.append(migrate_prefix(src, dst, p, mailbox=box))
        t_mig += time.monotonic() - t0
        moved += payload_bytes(src.export_prefix_blocks(p))
    _check(all(a > 0 for a in adopted), f"migration adopted {adopted}")
    want = _drain(src, turn2[:4], n)
    got = _drain(dst, turn2[:4], n)
    for w, g in zip(want, got):
        _check(np.array_equal(w, g),
               "migration: the adopting engine's continuation differs")
    _check(dst.metrics.get("prefix_hit_tokens") >= sum(adopted),
           "migration: the adopted blocks were not reused")
    for eng in (src, dst):
        _compiled_once(eng)
    print(json.dumps({"phase": 27, "migration": {
        "prompts": 4, "adopted_tokens": adopted, "payload_bytes": moved,
        "migrate_ms_total": t_mig * 1e3}}), flush=True)
    return b7


def _drain(eng, prompts, max_new):
    """Submit, then admit + step synchronously until every request is
    done (the serve loop without its thread); generated tokens."""
    import numpy as np

    futs = [eng.submit(p, max_new_tokens=max_new, timeout=None)
            for p in prompts]
    while True:
        eng._admit()
        if not eng.active:
            break
        eng._step()
    return [np.asarray(f.result(60))[p.size:] for p, f in zip(prompts, futs)]


# ---------------------------------------------------------------------------
# phases 29-32: the serving fleet on phase 4's gpt2-small
# ---------------------------------------------------------------------------

# phase 4's int8 engine settings, the fleet's replicas
FLEET = dict(SERVING, quantize=True)
# the liveness timeout of phase 29's fleet and the hang it must detect
LIVENESS_S = 2.0
HANG_S = 4.0


def _recording_cls():
    """A SlotEngine that counts its own steps and its B7 / B8 head
    calls and, while ``Recording.rows`` is a dict, keeps per prompt the
    logits row behind each greedy pick."""
    from paddle_tpu_torch.serving import SlotEngine

    class Recording(SlotEngine):
        rows = None     # {prompt bytes: [logits rows]} while recording
        keep = None     # record only these prompts' bytes (None = all)

        def __init__(self, *a, **kw):
            self.steps_run = 0
            self.head_calls = {"B7": 0, "B8": 0}
            super().__init__(*a, **kw)

        def _pick(self, slot):
            key = slot.req.payload.tobytes()
            if Recording.rows is not None and (
                    Recording.keep is None or key in Recording.keep):
                Recording.rows.setdefault(key, []).append(
                    slot.next_logits.copy())
            return super()._pick(slot)

        def _step(self):
            self.steps_run += 1
            return super()._step()

        def _head(self, rows, quant):
            self.head_calls["B8" if quant else "B7"] += 1
            return super()._head(rows, quant)

    return Recording


def _counts():
    from paddle_tpu_torch.ops import lowp, quant_ops

    return {"B7": quant_ops.dequant_matmul.launches,
            "B8": lowp.w8a8_matmul.launches}


def _zero_counts():
    from paddle_tpu_torch.ops import lowp, quant_ops

    quant_ops.dequant_matmul.launches = 0
    lowp.w8a8_matmul.launches = 0


def _fleet_submit(router, prompts, max_new):
    """Submit every prompt at once through `router` (greedy); the leg's
    state for `_fleet_collect`."""
    resolved = []
    m = router.metrics
    counts = (m.get("fleet_submitted"), m.get("fleet_completed"),
              m.get("fleet_failed"))
    t0 = time.monotonic()
    futs = []
    for p in prompts:
        f = router.submit(p, max_new_tokens=max_new, timeout=600.0)
        f.add_done_callback(lambda r: resolved.append(r.id))
        futs.append(f)
    return futs, resolved, counts, t0


def _fleet_leg(router, prompts, max_new):
    return _fleet_collect(router, prompts, max_new,
                          _fleet_submit(router, prompts, max_new))


def _fleet_collect(router, prompts, max_new, leg):
    """Wait for a submitted leg. Every client future must resolve
    exactly once (one done-callback each) with a well-formed result.
    Returns (generated tokens, wall seconds)."""
    import numpy as np

    futs, resolved, (sub0, done0, fail0), t0 = leg
    m = router.metrics
    outs = [np.asarray(f.result(600.0)) for f in futs]
    wall = time.monotonic() - t0
    vocab = router.replica_set.model.config.vocab_size
    for p, o in zip(prompts, outs):
        _check(o.shape == (p.size + max_new,) and
               np.array_equal(o[:p.size], p) and
               o.min() >= 0 and o.max() < vocab, "fleet: malformed result")
    _check(sorted(resolved) == sorted(f.id for f in futs),
           f"fleet: {len(resolved)} resolutions of {len(futs)} requests")
    _check(m.get("fleet_submitted") - sub0 == len(prompts) and
           m.get("fleet_completed") - done0 == len(prompts) and
           m.get("fleet_failed") == fail0,
           f"fleet: lost or failed requests {m.snapshot()['counters']}")
    return [o[p.size:] for p, o in zip(prompts, outs)], wall


def _near_ties(name, prompts, got, want, got_rows, want_rows):
    """Phase 3's rule: equal greedy tokens, except at a near-tie — a
    flip where the two runs' logits differ by at least half the
    reference row's top-2 margin is legitimate and the sequence is not
    compared past it. Anything else raises."""
    import numpy as np

    compared = total = flips = 0
    worst = 0.0
    for p, g, w in zip(prompts, got, want):
        rg, rw = got_rows[p.tobytes()], want_rows[p.tobytes()]
        stop = w.size
        for j in range(w.size):
            gap = float(np.abs(rg[j] - rw[j]).max())
            if g[j] != w[j]:
                top2 = np.sort(rw[j])[-2:]
                _check(top2[1] - top2[0] <= 2 * gap,
                       f"{name}: token {j} differs at a margin of "
                       f"{top2[1] - top2[0]} with logits within {gap}")
                stop, flips = j, flips + 1
                break
            worst = max(worst, gap)
        compared, total = compared + stop, total + w.size
    _check(compared >= 0.75 * total,
           f"{name}: too many near-ties to compare ({compared}/{total})")
    return {"tokens_compared": compared, "tokens": total,
            "near_tie_flips": flips, "max_logit_gap": worst}


def _wait_for(cond, what, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    _check(cond(), f"timed out waiting for {what}")


def _builds(router, gone=()):
    return sum(r.generation for r in
               list(router.replica_set.replicas) + list(gone))


def _accounting(router, before, what, gone=()):
    """Every B7 launch of an int8 fleet is a step of some replica or the
    warm-up of a (re)build: launches == steps + builds, exactly, since
    `before` = (launches, steps, builds). `gone`: replicas that left
    the membership during the leg (their builds count too)."""
    b7 = _counts()["B7"] - before[0]
    steps = router.metrics.get("steps") - before[1]
    builds = _builds(router, gone) - before[2]
    _check(b7 == steps + builds,
           f"{what}: {b7} B7 launches for {steps} steps + {builds} builds")
    _fleet_compiled_once(router)
    return {"B7": b7, "steps": steps, "builds": builds}


def _mark(router):
    return (_counts()["B7"], router.metrics.get("steps"), _builds(router))


def _allocated(device):
    """Bytes the caching allocator holds for live tensors on `device`
    after a collection (None off the card)."""
    import gc

    import torch

    gc.collect()
    if device != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def phase_fleet(model, card, Recording, device="cuda"):
    """Phase 29: `Router(replicas=2)` of int8 replicas on phase 4's
    prompts, held to one recording engine of phase 4's int8 leg under
    the near-tie rule; tokens/s of one replica and of two; a crash
    (``serving.replica_heartbeat`` raise kills r0's thread mid-flight),
    a hang (``serving.replica_step`` delay past the liveness timeout)
    with the memory gate on the abandoned engine, and a scale-up under
    load then a drained removal. Every request resolves exactly once in
    every leg; B7 launches == steps + builds in every leg. Returns the
    router (kept for nothing else: shut down here) and the B7
    launches."""
    import weakref

    import numpy as np

    from paddle_tpu_torch.framework import faults
    from paddle_tpu_torch.serving import Router

    prompts = _serving_prompts(model.config.vocab_size)
    n = SERVING_MAX_NEW
    b7 = 0
    # the reference: phase 4's int8 leg, served by one recording engine
    Recording.rows = want_rows = {}
    eng = Recording(model, device=device, **FLEET)
    eng.warmup()
    eng.start()
    futs = [eng.submit(p, max_new_tokens=n, timeout=600.0) for p in prompts]
    want = [np.asarray(f.result(600.0))[p.size:]
            for p, f in zip(prompts, futs)]
    eng.shutdown(drain=True)
    _compiled_once(eng)
    del eng
    out = {"phase": 29, "card": card, "tokens_per_s": {}}
    routers = {}
    for k, name in ((1, "one"), (2, "fleet")):
        Recording.rows = rows = {}
        _zero_counts()
        # least-loaded placement (no prefix affinity): every leg
        # spreads the same prompts over both replicas
        r = Router(model, replicas=k, engine_kw=FLEET, device=device,
                   hedge=False, liveness_timeout_s=LIVENESS_S,
                   backoff_base_s=0.05, prefix_affinity=False,
                   name=name).start()
        toks, wall = _fleet_leg(r, prompts, n)
        acc = _accounting(r, (0, 0, 0), f"{k} replica(s)")
        _check(all(x.engine.steps_run > 0 for x in r.replica_set.replicas),
               f"{k} replica(s): a replica took no step")
        b7 += acc["B7"]
        out["tokens_per_s"][f"{k}_replica"] = len(prompts) * n / wall
        out[f"leg_{k}_replica"] = dict(acc, wall_s=wall, **_near_ties(
            f"fleet x{k}", prompts, toks, want, rows, want_rows))
        routers[k] = r
    Recording.rows = None
    routers[1].shutdown(drain=True, timeout=60.0)
    router = routers[2]
    rs = router.replica_set
    m = router.metrics
    try:
        # a crash: r0's engine thread dies at its 4th heartbeat, mid-flight
        mark, replays = _mark(router), m.get("replays")
        with faults.inject("serving.replica_heartbeat[fleet.r0]@4:raise"):
            _fleet_leg(router, prompts, n)
        _wait_for(lambda: all(x.state == "healthy" for x in rs.replicas),
                  "the crashed replica's rebuild")
        _check(m.get("replays") > replays, "crash: no request was replayed")
        _check(rs.replicas[0].generation == 2,
               f"crash: r0 is at generation {rs.replicas[0].generation}")
        out["crash"] = dict(_accounting(router, mark, "crash"),
                            replays=m.get("replays") - replays,
                            deaths=m.get("replica_deaths"))
        b7 += out["crash"]["B7"]
        # a hang: r0's 3rd step sleeps past the liveness timeout
        victim = rs.replicas[0]
        old = victim.engine
        thread, ref = old._thread, weakref.ref(old)
        pool = old.kv_pool_bytes
        weight_bytes = sum(v.numel() * v.element_size()
                           for v in old._values.values())
        del old
        mem0 = _allocated(device)
        mark, replays = _mark(router), m.get("replays")
        with faults.inject(
                f"serving.replica_step[fleet.r0]@3:delay:{HANG_S}"):
            leg = _fleet_submit(router, prompts, n)
            _wait_for(lambda: victim.state == "healthy" and
                      victim.engine is not ref(), "the hung replica's "
                      "rebuild")
            mem1 = _allocated(device)
            hung_at_rebuild = thread.is_alive()
            _fleet_collect(router, prompts, n, leg)
        thread.join(60.0)
        _check(not thread.is_alive(), "hang: the hung thread never exited")
        del thread
        mem2 = _allocated(device)
        _check(ref() is None, "hang: the abandoned engine is still alive")
        _check(m.get("replays") > replays, "hang: no request was replayed")
        _check(device != "cuda" or mem2 - mem0 <= pool + weight_bytes,
               f"hang: memory {mem0} -> {mem2} after the hung thread "
               f"exited (one replica: {pool + weight_bytes} bytes)")
        out["hang"] = dict(_accounting(router, mark, "hang"),
                           replays=m.get("replays") - replays,
                           memory_allocated={"before_kill": mem0,
                                             "after_rebuild": mem1,
                                             "after_hung_exit": mem2},
                           hung_thread_alive_at_rebuild=hung_at_rebuild,
                           replica_bytes={"kv_pool": pool,
                                          "weights": weight_bytes})
        b7 += out["hang"]["B7"]
        # membership: a scale-up under load, then a drained removal
        mark = _mark(router)
        futs = [router.submit(p, max_new_tokens=n, timeout=600.0)
                for p in prompts]
        newcomer = router.add_replica()
        for f in futs:
            f.result(600.0)
        _check(newcomer.state == "healthy", "scale-up: newcomer not healthy")
        _fleet_leg(router, prompts, n)
        _check(newcomer.engine.steps_run > 0 and
               newcomer.engine.head_calls["B7"] > 1,
               "scale-up: the newcomer served no step")
        resolved = []
        futs = []
        for p in prompts:
            f = router.submit(p, max_new_tokens=n, timeout=600.0)
            f.add_done_callback(lambda q: resolved.append(q.id))
            futs.append(f)
        router.remove_replica(newcomer.name, drain=True)
        for f in futs:
            f.result(600.0)
        _check(sorted(resolved) == sorted(f.id for f in futs),
               "drain: a request was lost or duplicated")
        _wait_for(lambda: newcomer.name not in
                  [x.name for x in rs.replicas], "the drained eviction")
        out["membership"] = dict(_accounting(router, mark, "membership",
                                             gone=(newcomer,)),
                                 newcomer_steps=newcomer.engine.steps_run,
                                 replicas=[x.name for x in rs.replicas])
        b7 += out["membership"]["B7"]
        _check(m.get("fleet_failed") == 0,
               f"fleet: {m.get('fleet_failed')} requests failed")
    finally:
        router.shutdown(drain=True, timeout=60.0)
    print(json.dumps(out), flush=True)
    return b7


def phase_disagg_autoscale(model, card, Recording, device="cuda"):
    """Phase 30: disaggregated prefill/decode on the w8a8 leg (a prefill
    replica of prefill_chunk 256, a decode replica of 16): B8 on both
    roles, every decode leg adopting migrated KV. Then one real
    `Autoscaler.tick` grows a one-replica int8 fleet under a backlog and
    one shrinks it when idle. Returns the B7 and B8 launches."""
    from paddle_tpu_torch.serving import Autoscaler, Router

    prompts = _serving_prompts(model.config.vocab_size)
    n = SERVING_MAX_NEW
    out = {"phase": 30, "card": card}
    _zero_counts()
    router = Router(model, replicas=2, device=device, hedge=False,
                    engine_kw=dict(FLEET, w8a8=True), disagg=True,
                    roles=["prefill", "decode"],
                    role_kw={"prefill": dict(prefill_chunk=256),
                             "decode": dict(prefill_chunk=16)},
                    name="disagg").start()
    try:
        _toks, wall = _fleet_leg(router, prompts, n)
        pre, dec = (x.engine for x in router.replica_set.replicas)
        m = router.metrics
        got = _counts()
        heads = {"prefill": dict(pre.head_calls),
                 "decode": dict(dec.head_calls)}
        _check(pre.head_calls["B8"] > 0 and dec.head_calls["B8"] > 0,
               f"disagg: B8 did not run on both roles {heads}")
        _check(got["B8"] == pre.head_calls["B8"] + dec.head_calls["B8"]
               and got["B7"] == pre.head_calls["B7"] + dec.head_calls["B7"],
               f"disagg: launches {got} against head calls {heads}")
        _check(m.get("kv_migrations") == len(prompts) and
               not m.get("kv_migrate_faults"),
               f"disagg: {m.get('kv_migrations')} migrations, "
               f"{m.get('kv_migrate_faults')} faults for {len(prompts)}")
        out["disagg"] = {
            "wall_s": wall, "tokens_per_s": len(prompts) * n / wall,
            "launches": got, "head_calls": heads,
            "prefill_chunk": [pre.prefill_chunk, dec.prefill_chunk],
            "kv_migrations": m.get("kv_migrations"),
            "kv_migrate_bytes": m.get("kv_migrate_bytes"),
            "compile_counts": _fleet_compiled_once(router)}
    finally:
        router.shutdown(drain=True, timeout=60.0)
    launches = dict(got)
    # autoscaling: a backlog of 16 requests on one replica's 8 slots
    _zero_counts()
    clock = [0.0]
    router = Router(model, replicas=1, device=device, hedge=False,
                    engine_kw=FLEET, name="auto").start()
    asc = Autoscaler(router, min_replicas=1, max_replicas=2,
                     slo_p99_ms=600000.0, cooldown_s=1.0,
                     backlog_factor=1.5, clock=lambda: clock[0])
    router.autoscaler = None       # ticked here, not by the supervisor
    try:
        futs = [router.submit(p, max_new_tokens=n, timeout=600.0)
                for p in prompts]
        up = asc.tick()
        _check(up["overloaded"] and asc.decisions["up"] == 1,
               f"autoscale: no scale-up under a backlog {up}")
        asc._scale_thread.join(120.0)
        _check(not asc._scale_thread.is_alive() and
               router.replica_set.member_replicas() == 2,
               "autoscale: the scale-up did not land")
        for f in futs:
            f.result(600.0)
        surge = router.replica_set.replicas[-1]
        clock[0] = 10.0
        _check(asc.tick()["idle"], "autoscale: the drained fleet not idle")
        clock[0] = 11.5
        asc.tick()
        _check(asc.decisions["down"] == 1, "autoscale: no scale-down")
        _wait_for(lambda: len(router.replica_set.replicas) == 1,
                  "the autoscaler's drained eviction")
        acc = _accounting(router, (0, 0, 0), "autoscale", gone=(surge,))
        out["autoscale"] = dict(acc, pressure_at_up=up["pressure"],
                                decisions=dict(asc.decisions))
        launches["B7"] += acc["B7"]
    finally:
        asc.close()
        router.shutdown(drain=True, timeout=60.0)
    print(json.dumps(out), flush=True)
    return launches


def phase_rollout(model, card, Recording, tmp, device="cuda"):
    """Phase 31: v1 (phase 4's weights plus seeded noise, frozen int8)
    saved with the port's `save_state` and loaded through
    `WeightRegistry.load_dir`; its golden chain (24 B7 launches: 4
    prompts x 6 tokens) and each prompt's smallest top-2 margin and
    largest logit gap to the canary's served decode; a
    `RolloutController` rolls two int8 replicas from v0 to v1 under
    traffic (commit), v0's spilled KV is fenced; a v2 whose golden
    digests were made from other values is refused and the rollback
    serves v1's tokens bit for bit. Returns the B7 launches."""
    import threading

    import numpy as np
    import torch

    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.quantization import quantize_state_int8
    from paddle_tpu_torch.serving import (
        RolloutController, Router, Server, SpillFencedError, WeightRegistry,
        WeightVersion, golden_digests, reset_spill_stores, rollout,
    )

    out = {"phase": 31, "card": card}
    v0 = {k: v.detach() for k, v in model.state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(31)

    def noisy(scale):
        return quantize_state_int8({
            k: v + scale * torch.randn(v.shape, generator=gen, device=device)
            for k, v in v0.items()})

    mgr = ckpt.CheckpointManager(tmp, max_to_keep=4)
    mgr.save(1, noisy(0.004))
    reg = WeightRegistry(model, template=quantize_state_int8(v0))
    wv1 = reg.load_dir(f"{tmp}/ckpt-1")
    _check(wv1.version == 1 and wv1.quant, "rollout: v1 did not load")
    _zero_counts()
    router = Router(model, replicas=2, device=device, hedge=False,
                    engine_kw=dict(FLEET, spill_dir=f"{tmp}/spill"),
                    retry_budget=3, name="ro").start()
    try:
        ro = RolloutController(router, reg, canary_secs=0.5, wave_size=1,
                               poll_s=0.01, slo_p99_ms=600000.0)
        prompts = ro._prompts()
        Recording.rows = rows = {}
        Recording.keep = {np.asarray(p, np.int32).tobytes()
                          for p in prompts}
        # the golden chain, its B7 launches and margins
        before = _counts()["B7"]
        chains = [rollout.golden_logits(model, wv1.values, p,
                                        max_new=ro.golden_max_new)
                  for p in prompts]
        chain_b7 = _counts()["B7"] - before
        _check(chain_b7 == len(prompts) * ro.golden_max_new,
               f"rollout: the golden chain launched B7 {chain_b7}x")
        wv1.golden = {f"p{i}": rollout._digest_ids(t)
                      for i, (t, _) in enumerate(chains)}
        # v0 traffic, spilled to the tier before the commit
        probe = _serving_prompts(model.config.vocab_size)[:4]
        for p in probe:
            router.generate(p, max_new_tokens=8, timeout=600.0)
        for r in router.replica_set.replicas:
            r.engine.spill_cache()
        store = router.replica_set.replicas[0].engine.spill_store
        _check(len(store) > 0, "rollout: nothing spilled under v0")
        v0_key = next(iter(store._index))
        stop, errs = threading.Event(), []

        def traffic():
            i = 0
            while not stop.is_set():
                try:
                    router.generate(probe[i % 4], max_new_tokens=8,
                                    timeout=600.0)
                except Exception as e:  # noqa: BLE001 — gated below
                    errs.append(repr(e))
                i += 1

        t = threading.Thread(target=traffic, daemon=True)
        t0 = time.monotonic()
        t.start()
        try:
            ok = ro.roll_to(1)
        finally:
            stop.set()
            t.join(600.0)
        roll_s = time.monotonic() - t0
        margins = []
        for i, (p, (toks, crow)) in enumerate(zip(prompts, chains)):
            served = rows.get(np.asarray(p, np.int32).tobytes(), [])
            margins.append({
                "prompt": i,
                "min_top2_margin": min(float(np.diff(np.sort(r)[-2:])[0])
                                       for r in crow),
                "max_logit_gap": max((float(np.abs(a - b).max())
                                      for a, b in zip(crow, served)),
                                     default=None)})
        # printed before the gates, so a refusal shows its margins
        print(json.dumps({"phase": 31, "card": card, "golden": {
            "chain_b7": chain_b7, "margins": margins}}), flush=True)
        _check(ok, f"rollout: v1 did not commit: {ro.error}")
        _check(not errs, f"rollout: traffic failed {errs[:3]}")
        info = router.version_info()
        _check(set(info["replicas"].values()) == {1} and
               info["current"] == 1 and info["state"] == "committed",
               f"rollout: version_info {info}")
        try:
            store.get(v0_key)
            fenced = False
        except SpillFencedError:
            fenced = True
        _check(fenced, "rollout: v0's spilled KV was not fenced")
        pre = [np.asarray(router.generate(p, max_new_tokens=8,
                                          timeout=600.0)) for p in probe]
        # v2: golden digests from other values — the gate must refuse
        v2 = WeightVersion(2, noisy(0.004), golden=golden_digests(
            model, noisy(0.004), prompts, max_new=ro.golden_max_new))
        reg.add(v2)
        t0 = time.monotonic()
        refused = not ro.roll_to(2)
        refuse_s = time.monotonic() - t0
        _check(refused and "golden-prompt digest mismatch" in ro.error,
               f"rollout: v2 was not refused by the gate: {ro.state} "
               f"{ro.error}")
        post = [np.asarray(router.generate(p, max_new_tokens=8,
                                           timeout=600.0)) for p in probe]
        _check(all(np.array_equal(a, b) for a, b in zip(pre, post)),
               "rollout: the rollback does not serve v1's tokens")
        _check(set(router.version_info()["replicas"].values()) == {1},
               "rollout: the rollback left a replica off v1")
        out.update(commit_s=roll_s, refuse_s=refuse_s,
                   version_info=router.version_info(),
                   kv_invalidated_blocks=router.metrics.get(
                       "kv_invalidated_blocks"),
                   launches=_counts(),
                   compile_counts=_fleet_compiled_once(router))
    finally:
        Recording.rows = Recording.keep = None
        router.shutdown(drain=True, timeout=60.0)
        reset_spill_stores()
    print(json.dumps(out), flush=True)
    return out["launches"]["B7"]


def phase_tenancy(model, card, device="cuda"):
    """Phase 32: `Server(replicas=2, tenancy=...)` of int8 replicas, two
    tenants weighted 3:1, "b" budgeted, behind `http_front`; a seeded
    `Scenario.swing` trace (tenant mix, 16-token user prefixes) replayed
    open loop, every other arrival through ``POST /v1/generate`` with
    ``X-Tenant``. Gates: every arrival resolves (tokens or a typed
    shed), only "b" sheds, and at least one of its HTTP 429s carries
    its own Retry-After. Prints each tenant's share of tokens, e2e p50 /
    p99 and ``GET /v1/version``. Returns the B7 launches."""
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from paddle_tpu_torch.serving import (
        Scenario, Server, ServingError, TenantBudgetError, TenantDirectory,
        TenantSpec, http_front, replay,
    )

    vocab = model.config.vocab_size
    ten = TenantDirectory([
        TenantSpec("a", weight=3.0, slo_class="gold"),
        TenantSpec("b", weight=1.0, budget_tokens_per_s=150.0,
                   burst_s=1.0)])
    sc = Scenario.swing(low_rps=4.0, high_rps=32.0, low_s=1.0, high_s=2.0,
                        seed=32, vocab=vocab, n_users=16,
                        user_prefix_len=16, prompt_len=(16, 64),
                        max_new=(8, 24), tenants={"a": {"weight": 3.0},
                                                  "b": {"weight": 1.0}})
    trace = sc.trace()
    _zero_counts()
    srv = Server(model, replicas=2, device=device, tenancy=ten,
                 fleet=dict(hedge=False, name="tenants"), **FLEET).start()
    httpd = http_front(srv, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    pool = ThreadPoolExecutor(16)

    def post(arrival):
        req = urllib.request.Request(
            f"{url}/v1/generate", data=json.dumps({
                "prompt": arrival.prompt.tolist(),
                "max_new_tokens": arrival.max_new,
                "timeout": 600.0}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Tenant": arrival.tenant})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return 200, json.loads(r.read()), None
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read()), e.headers["Retry-After"]

    def submit(arrival):
        """Every other arrival over HTTP (on a pool thread, so the
        replay stays open loop), the rest in process."""
        if len(calls) % 2:
            calls.append("http")
            return "http", pool.submit(post, arrival)
        calls.append("local")
        return "local", srv.submit(arrival.prompt,
                                   max_new_tokens=arrival.max_new,
                                   timeout=600.0, tenant=arrival.tenant)

    calls = []
    try:
        t0 = time.monotonic()
        recs = replay(submit, trace)
        outcomes = {"ok": 0, "shed": {}, "http_429": []}
        for rec in recs:
            a, err = rec["arrival"], rec["error"]
            if err is None:
                kind, fut = rec["future"]
                if kind == "http":
                    code, body, retry_after = fut.result(600.0)
                    if code != 200:
                        _check(code == 429 and a.tenant == "b" and
                               body["type"] == "TenantBudgetError" and
                               float(retry_after) > 0,
                               f"tenancy: HTTP {code} {body} for "
                               f"{a.tenant}")
                        outcomes["http_429"].append(float(retry_after))
                        continue
                    ids = body["ids"]
                else:
                    try:
                        ids = np.asarray(fut.result(600.0))
                    except TenantBudgetError as e:
                        err = e
                if err is None:
                    _check(len(ids) == a.prompt.size + a.max_new,
                           "tenancy: malformed result")
                    outcomes["ok"] += 1
                    continue
            _check(isinstance(err, ServingError) and a.tenant == "b",
                   f"tenancy: {a.tenant} lost a request: {err!r}")
            outcomes["shed"][a.tenant] = outcomes["shed"].get(a.tenant, 0) + 1
        wall = time.monotonic() - t0
        _check(outcomes["http_429"],
               "tenancy: the budgeted tenant got no HTTP 429")
        with urllib.request.urlopen(f"{url}/v1/version", timeout=60) as r:
            version = json.loads(r.read())
        snap = srv.snapshot()
        tenants = snap["tenants"]
        total = sum(t["counters"].get("tokens_out", 0)
                    for t in tenants.values())
        out = {"phase": 32, "card": card, "arrivals": len(trace),
               "wall_s": wall, "outcomes": outcomes,
               "version": version, "launches": _counts(),
               "tenants": {
                   name: {"token_share": t["counters"].get(
                       "tokens_out", 0) / max(total, 1),
                       "completed": t["counters"].get("completed", 0),
                       "shed": t["counters"].get("shed", 0),
                       "e2e_p50_s": t.get("latency_s", {}).get("p50"),
                       "e2e_p99_s": t.get("latency_s", {}).get("p99")}
                   for name, t in tenants.items()}}
        _check(outcomes["ok"] + sum(outcomes["shed"].values()) +
               len(outcomes["http_429"]) == len(trace),
               "tenancy: an arrival did not resolve")
        out["prometheus"] = _tenancy_exposition(srv, url)
    finally:
        httpd.shutdown()
        httpd.server_close()
        pool.shutdown(wait=True)
        srv.shutdown(drain=True)
    print(json.dumps(out), flush=True)
    return out["launches"]["B7"]


def _tenancy_exposition(srv, url):
    """Phase 32's Prometheus export: `metrics_prometheus()` parses as
    exposition, with one state gauge per replica of the fleet, and
    `http_front`'s ``/metrics`` asked for ``text/plain`` serves the same
    families; the replicas' compile counters."""
    import urllib.request

    fams, samples = _exposition(srv.metrics_prometheus())
    req = urllib.request.Request(f"{url}/metrics",
                                 headers={"Accept": "text/plain"})
    with urllib.request.urlopen(req, timeout=60) as r:
        ctype = r.headers["Content-Type"]
        http_fams, _ = _exposition(r.read().decode())
    _check("text/plain" in ctype and http_fams == fams,
           f"tenancy: /metrics served {ctype} with "
           f"{sorted(fams ^ http_fams)} differing")
    states = [k for k in samples
              if k.startswith("paddle_serving_replica_state{")]
    replicas = srv.router.snapshot()["replicas"]
    _check(len(states) == len(replicas),
           f"tenancy: {len(states)} state gauges, {len(replicas)} replicas")
    return {"families": len(fams), "series": len(samples),
            "replica_state_gauges": len(states),
            "compile_counts": _fleet_compiled_once(srv.router)}


def phase_fleet_all(model, card, device="cuda"):
    """Phases 29-32 with the fleet's replicas built as recording engines
    (`_recording_cls`); returns each phase's B7 / B8 launches. A Router
    and its ReplicaSet reference each other (the death hook), so a shut
    fleet's engines, KV pools included, wait for the cycle collector:
    each phase ends with a collection, so later phases (and their peak
    memory) start clean."""
    import gc

    from paddle_tpu_torch.serving import fleet

    Recording = _recording_cls()
    saved, fleet.SlotEngine = fleet.SlotEngine, Recording
    launches = {"B7": {}, "B8": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rollout_")
    try:
        launches["B7"]["fleet"] = phase_fleet(model, card, Recording,
                                              device)
        gc.collect()
        got = phase_disagg_autoscale(model, card, Recording, device)
        launches["B7"]["disagg_autoscale"] = got["B7"]
        launches["B8"]["disagg"] = got["B8"]
        gc.collect()
        launches["B7"]["rollout"] = phase_rollout(model, card, Recording,
                                                  tmp, device)
        gc.collect()
        launches["B7"]["tenancy"] = phase_tenancy(model, card, device)
    finally:
        fleet.SlotEngine = saved
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
    return launches


# phase 28: a served sample's logits against its own bucket-1 forward.
# Both are bf16 O1 forwards of the same weights; cuBLAS picks its bf16
# GEMM by M, so the rounding of each layer's outputs differs with the
# bucket and 12 layers carry it to logits of order 1: held to 2^-4
# (8 bf16 ulps at 1.0)
BATCH_TOL = 2.0 ** -4


def phase_batch(card, device="cuda", cfg_kw=None, seq=None, n=64,
                threads=8):
    """Phase 28: `Server(mode="batch", max_batch=32)` over ERNIE-1.0
    sequence classification (bench.py's widths: vocab 18000, hidden
    768, 12 layers, 2 classes, random weights from seed 0), eval, bf16
    O1 entered by the batch function itself (the batcher's worker
    thread runs it), s 512. The ladder 1-32 is warmed, then 64 single
    samples arrive from 8 threads. Gates: B1 launches exactly 12 a
    forward; each output bitwise the direct forward of the same padded
    bucket, and within BATCH_TOL of the sample's bucket-1 forward.
    Prints requests/s, batch occupancy and latency p50 / p99. Returns
    the B1 launches of the serving run."""
    import threading

    import numpy as np
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nlp.transformers import (
        ErnieConfig, ErnieForSequenceClassification,
    )
    from paddle_tpu_torch.ops import fused_ops
    from paddle_tpu_torch.serving import Server

    cfg = ErnieConfig(**(cfg_kw or ERNIE))
    seq = seq or ERNIE_SEQ
    model = ErnieForSequenceClassification(
        cfg, num_classes=2, device=device,
        generator=torch.Generator().manual_seed(0))
    model.eval()
    flushes = []

    def forward(x):
        # autocast is thread-local: the batcher's worker enters it here
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return model(torch.from_numpy(x).to(device).long()).float()

    def classify(x):
        out = forward(x)
        flushes.append((x, out))
        return out

    rng = np.random.RandomState(28)
    samples = [rng.randint(1, cfg.vocab_size, (seq,)) for _ in range(n)]
    srv = Server(mode="batch", fn=classify, max_batch=32, max_wait_s=0.005)
    fused_ops.flash_attention.launches["B1"] = 0
    t0 = time.monotonic()
    counts = srv.batcher.warmup(samples[0])
    warm_s = time.monotonic() - t0
    b1 = fused_ops.flash_attention.launches["B1"]
    layers = cfg.num_layers
    _check(b1 == layers * len(counts),
           f"batch warmup: B1 ran {b1}x in {len(counts)} forwards")
    del flushes[:]
    fused_ops.flash_attention.launches["B1"] = 0
    srv.start()
    results = [None] * n

    def client(k):
        mine = list(range(k, n, threads))
        futs = [(i, srv.submit(samples[i], timeout=600.0)) for i in mine]
        for i, f in futs:
            results[i] = f.result(600.0)

    t0 = time.monotonic()
    pool = [threading.Thread(target=client, args=(k,))
            for k in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    wall = time.monotonic() - t0
    srv.shutdown(drain=True)
    b1 = fused_ops.flash_attention.launches["B1"]
    snap = srv.snapshot()
    batches = snap["counters"].get("batches", 0)
    _check(snap["counters"].get("completed") == n and
           not snap["counters"].get("failed"),
           f"batch: not every sample completed: {snap['counters']}")
    _check(b1 == layers * batches == layers * len(flushes),
           f"batch: B1 ran {b1}x in {batches} forwards")
    worst = 0.0
    with torch.no_grad():
        for x, out in flushes:
            _check(torch.equal(forward(x), out),
                   "batch: a flush's direct forward differs")
        for i, s in enumerate(samples):
            x, out = next((x, out) for x, out in flushes
                          if any(np.array_equal(r, s) for r in x))
            row = next(j for j, r in enumerate(x) if np.array_equal(r, s))
            _check(np.array_equal(results[i], out[row].cpu().numpy()),
                   "batch: a result differs from its flush's row")
            one = forward(s[None]).cpu().numpy()[0]
            err = float(np.abs(results[i] - one).max())
            _check(np.isfinite(results[i]).all() and err <= BATCH_TOL,
                   f"batch: sample {i} is {err} from its bucket-1 forward")
            worst = max(worst, err)
    lat = snap["latency_s"]["e2e"]
    print(json.dumps({
        "phase": 28, "batch_mode": "ernie-1.0 seq-cls, s512, bf16 O1",
        "samples": n, "threads": threads, "wall_s": wall,
        "requests_per_s": n / wall, "batches": batches,
        "occupancy_avg": snap["batch_occupancy"]["avg"],
        "e2e_p50_ms": lat["p50"] * 1e3, "e2e_p99_ms": lat["p99"] * 1e3,
        "warmup_s": warm_s, "buckets": sorted(counts),
        "b1_launches": b1, "max_abs_dev_vs_bucket1": worst}), flush=True)
    return b1


# -- phases 37-40: GPT-2 small training (engine, recompute, optimizers, the
# eager loop and hapi) --------------------------------------------------------

GPT_BATCH, GPT_SEQ = 8, 1024


def _gpt_batch(vocab, n, seq, seed=0):
    """Seeded random ids and their next tokens as labels."""
    import numpy as np

    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (n, seq + 1)).astype(np.int64)
    return ids[:, :-1].copy(), ids[:, 1:].copy()


def _flash_counts():
    from paddle_tpu_torch.ops import fused_ops

    return dict(fused_ops.flash_attention.launches)


def _zero_flash():
    from paddle_tpu_torch.ops import fused_ops

    fused_ops.flash_attention.launches.update(B1=0, B2=0, B3=0)


def _gpt_model():
    """gpt2-small at full width (vocab 50304, max_seq_len 1024, dropout
    0.1 / 0.1), random weights from seed 0, on the card, and a copy of
    its initial state there (every leg of 37-40 starts from it)."""
    import torch

    from paddle_tpu_torch.nlp.transformers import (
        GPTForPretraining, gpt_config,
    )

    cfg = gpt_config("gpt2-small", use_parallel=False)
    model = GPTForPretraining(cfg, device="cuda",
                              generator=torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return cfg, model, init


def _gpt_engine(model, init, opt, cfg, recompute=False, **kw):
    """`model` reset to `init`, with the config's recompute switch, under
    an `Engine` of engine seed 0 (the same dropout masks in every leg)."""
    from paddle_tpu_torch.engine import Engine
    from paddle_tpu_torch.nlp.transformers import GPTPretrainingCriterion

    model.set_state_dict(init)
    model.config.recompute = recompute
    model.train()
    return Engine(model, opt, GPTPretrainingCriterion(cfg), device="cuda",
                  seed=0, **kw)


def _bf16_step(eng, ids, labels):
    from paddle_tpu_torch import amp

    with amp.auto_cast(enable=True, dtype="bfloat16"):
        return eng.train_batch(ids, labels)


def phase_gpt_train(card):
    """Phase 37: GPT-2 small pretraining through `Engine.train_batch` as
    bench_attrib.py configures it (AdamW 1e-4, weight decay 0.01, bf16
    O1, b8 x s1024): 2 warm-up and 10 timed steps on a fixed batch (each
    ends in a synchronise); exactly 12 launches a step of each of B1-B3
    (causal, dropout 0.1); finite, falling losses; step p50 / p90,
    tokens/s, MFU by PERF.md's count (6 P + 12 L H S flops a token at
    the card's bf16 peak), `memory_analysis()` (peak > arguments > 0;
    measured on the first step as it ran, in bf16, so reading it takes no
    step), then one `attribute_step` (device time by bucket, B1-B3 in
    attention with their launches; it replays the last step under that
    step's own auto_cast policy)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import observe, optimizer

    cfg, model, init = _gpt_model()
    ids, labels = _gpt_batch(cfg.vocab_size, GPT_BATCH, GPT_SEQ)
    eng = _gpt_engine(model, init, optimizer.AdamW(
        1e-4, parameters=model.parameters(), weight_decay=0.01), cfg)
    losses = [float(_bf16_step(eng, ids, labels)) for _ in range(2)]
    torch.cuda.synchronize()
    _zero_flash()
    times = []
    n = 10
    with observe.no_retrace():
        for _ in range(n):
            t0 = time.perf_counter()
            loss = _bf16_step(eng, ids, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
    launches = _flash_counts()
    L = cfg.num_layers
    _check(launches == {"B1": L * n, "B2": L * n, "B3": L * n},
           f"gpt2-small: launches over {n} steps {launches}")
    _check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    _check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    step0 = eng.state.step
    mem = eng.memory_analysis()
    _check(mem["peak"] > mem["arguments"] > 0, f"memory_analysis {mem}")
    _check(eng.memory_analysis() == mem and eng.state.step == step0,
           "memory_analysis ran a step or changed its reading")
    n_params = sum(p.numel() for p in eng.state.params.values())
    flops_tok = 6.0 * n_params + 12.0 * L * cfg.hidden_size * GPT_SEQ
    step_s = float(np.median(times))
    tok_s = GPT_BATCH * GPT_SEQ / step_s
    logdir = tempfile.mkdtemp(prefix="chip_smoke_gpt_attrib_")
    try:
        with observe.no_retrace():
            rep = eng.attribute_step(logdir=logdir, steps=1, top=1 << 30)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    ids_seen = {}
    for r in rep["top_ops"]:
        _bucket, kid = observe.classify_kernel(r["name"])
        if kid in ("B1", "B2", "B3"):
            _check(r["bucket"] == "attention",
                   f"gpt2-small: {kid} in {r['bucket']}")
            ids_seen[kid] = ids_seen.get(kid, 0) + r["calls"]
    _check(ids_seen == {"B1": L, "B2": L, "B3": L},
           f"gpt2-small attribute_step: kernel launches {ids_seen}")
    out = {
        "train": "gpt2-small b8 s1024 bf16 dropout 0.1 AdamW", "card": card,
        "steps": n, "step_ms_p50": step_s * 1e3,
        "step_ms_p90": float(np.percentile(times, 90)) * 1e3,
        "tokens_per_s": tok_s, "params": n_params,
        "mfu": flops_tok * tok_s / _peaks(card)[3], "losses": losses,
        "launches_per_step": {k: c / n for k, c in launches.items()},
        "memory_analysis": mem,
        "attribute_ms_per_step": {b: us / 1e3
                                  for b, us in rep["buckets"].items()},
        "attribute_total_ms": rep["total_us"] / 1e3,
        "attribute_top_rows": [{"name": r["name"][:90],
                                "bucket": r["bucket"],
                                "ms": r["total"] / 1e3}
                               for r in rep["top_ops"][:8]],
    }
    print(json.dumps(out), flush=True)
    del eng
    torch.cuda.empty_cache()
    return out, (cfg, model, init, ids, labels)


def phase_gpt_recompute(card, gpt, first_loss):
    """Phase 38: recompute=True under FLAGS_remat_policy full,
    dots_saveable and none, 3 steps each from the same weights, seed and
    batch. B1 launches 24 a step under full and dots_saveable (the flash
    forward is not an aten matmul, so it is replayed in the backward) and
    12 under none; B2 / B3 12 a step. The first step's loss is bit for
    bit the same in all three and equal to phase 37's; the step's peak
    memory (`memory_analysis`, measured on each leg's first bf16 step) is
    ordered full < dots_saveable < none."""
    import numpy as np
    import torch

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework.flags import set_flags

    cfg, model, init, ids, labels = gpt
    L, n = cfg.num_layers, 3
    legs = {}
    try:
        for policy, b1 in (("full", 2 * L), ("dots_saveable", 2 * L),
                           ("none", L)):
            set_flags({"FLAGS_remat_policy": policy})
            eng = _gpt_engine(model, init, optimizer.AdamW(
                1e-4, parameters=model.parameters(), weight_decay=0.01), cfg,
                recompute=True)
            torch.cuda.synchronize()
            _zero_flash()
            t0 = time.perf_counter()
            losses = [float(_bf16_step(eng, ids, labels)) for _ in range(n)]
            wall = time.perf_counter() - t0
            launches = _flash_counts()
            want = {"B1": b1 * n, "B2": L * n, "B3": L * n}
            _check(launches == want,
                   f"recompute {policy}: launches {launches}, want {want}")
            _check(all(np.isfinite(losses)), f"{policy}: losses {losses}")
            mem = eng.memory_analysis()
            legs[policy] = {"losses": losses, "launches": launches,
                            "step_ms_mean": wall / n * 1e3,
                            "peak_bytes": mem["peak"],
                            "temps_bytes": mem["temps"]}
            del eng
            torch.cuda.empty_cache()
    finally:
        set_flags({"FLAGS_remat_policy": "auto"})
        model.config.recompute = False
    firsts = [leg["losses"][0] for leg in legs.values()]
    _check(all(f == first_loss for f in firsts),
           f"first-step losses {firsts} vs phase 37's {first_loss}")
    peaks = [legs[p]["peak_bytes"] for p in ("full", "dots_saveable",
                                             "none")]
    _check(peaks[0] < peaks[1] < peaks[2],
           f"peak memory not ordered full < dots_saveable < none: {peaks}")
    print(json.dumps({"gpt_recompute": legs, "card": card,
                      "first_loss_bitwise": True}), flush=True)
    return {k: sum(leg["launches"][k] for leg in legs.values())
            for k in ("B1", "B2", "B3")}


def _tiny_gpt_values(seed=3):
    """A tiny GPT's config (vocab 128, hidden 64 in 2 heads of 32, the
    flash kernels' smallest head, 2 layers, seq 16, dropout 0) and a
    batch of 4 sequences."""
    from paddle_tpu_torch.nlp.transformers import GPTConfig

    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_heads=2, max_seq_len=16, dropout=0.0,
                    attn_dropout=0.0, use_parallel=False)
    ids, labels = _gpt_batch(128, 4, 16, seed=seed)
    return cfg, ids, labels


TINY_LR = 1e-3


def _split_key_bias(name, a):
    """(the parameter without the key third of a qkv bias, that third or
    None)."""
    import numpy as np

    if not name.endswith("qkv_proj.bias"):
        return a, None
    h = a.shape[0] // 3
    return np.concatenate([a[:h], a[2 * h:]]), a[h:2 * h]


def _opt_cases():
    """(name, optimizer factory(params, lr), switch) for phase 39;
    `switch(model, on)` sets or clears the case's parameter attributes
    (the embeddings' ParamAttr, a need_clip=False parameter)."""
    from paddle_tpu_torch import ParamAttr, nn, optimizer as O
    from paddle_tpu_torch.clip import ClipGradByNorm, ClipGradByValue
    from paddle_tpu_torch.regularizer import L1Decay, L2Decay

    def embeddings_attr(model, on):
        """The embeddings rebuilt through `create_parameter` with a
        ParamAttr (lr 0.5, L2Decay 1e-4), their weights kept; off puts
        the plain ones back."""
        emb = model.gpt.embeddings
        if on:
            emb._plain = (emb.word_embeddings, emb.position_embeddings)
            for attr in ("word_embeddings", "position_embeddings"):
                old = getattr(emb, attr)
                new = nn.Embedding(*old.weight.shape, weight_attr=ParamAttr(
                    learning_rate=0.5, regularizer=L2Decay(1e-4)))
                new.to(old.weight.device).weight.data.copy_(old.weight)
                setattr(emb, attr, new)
        else:
            emb.word_embeddings, emb.position_embeddings = emb._plain

    def no_clip(model, on):
        model.gpt.final_norm.weight.need_clip = not on

    def none(model, on):
        pass

    return [
        ("SGD", lambda ps, lr: O.SGD(lr, parameters=ps), none),
        ("Adamax", lambda ps, lr: O.Adamax(lr, parameters=ps), none),
        ("Adagrad", lambda ps, lr: O.Adagrad(lr, parameters=ps), none),
        ("Adadelta", lambda ps, lr: O.Adadelta(lr, parameters=ps), none),
        ("RMSProp", lambda ps, lr: O.RMSProp(
            lr, centered=True, momentum=0.9, parameters=ps), none),
        ("LarsMomentum", lambda ps, lr: O.LarsMomentum(
            lr, parameters=ps), none),
        ("Lamb", lambda ps, lr: O.Lamb(lr, parameters=ps), none),
        ("Adam_L1_ParamAttr", lambda ps, lr: O.Adam(
            lr, parameters=ps, weight_decay=L1Decay(1e-4)), embeddings_attr),
        ("AdamW_lr_ratio", lambda ps, lr: O.AdamW(
            lr, parameters=ps, lr_ratio=lambda p: 0.5), none),
        ("Momentum_ClipGradByValue", lambda ps, lr: O.Momentum(
            lr, parameters=ps, grad_clip=ClipGradByValue(1e-3)), no_clip),
        ("Momentum_ClipGradByNorm", lambda ps, lr: O.Momentum(
            lr, parameters=ps, grad_clip=ClipGradByNorm(1e-2)), no_clip),
    ]


def phase_gpt_optimizers(card, gpt):
    """Phase 39: each remaining rule at full width, 3 Engine steps from
    the initial weights (bf16 O1, the same batch), finite losses and 12
    launches a step of each of B1-B3. Then a tiny GPT with the same
    weights takes the same 3 steps on the card and on the CPU in f32
    (TF32 off): losses within rtol 1e-5, and each parameter's update
    within 1e-4 of the CPU's in norm. Not elementwise at 1e-5 / 1e-6:
    the rules that normalise the gradient (Adam's family, Adagrad,
    Adadelta, RMSProp, LARS, Lamb) turn an element whose gradient is
    within rounding of 0 into a step of up to lr, and the card and the
    CPU round differently; the key third of each qkv bias, whose true
    gradient is 0, is held to 2 lr a step."""
    import numpy as np
    import torch

    from paddle_tpu_torch.engine import Engine
    from paddle_tpu_torch.nlp.transformers import (
        GPTForPretraining, GPTPretrainingCriterion,
    )

    cfg, model, init, ids, labels = gpt
    L = cfg.num_layers
    tcfg, tids, tlabels = _tiny_gpt_values()
    out, total = {}, {"B1": 0, "B2": 0, "B3": 0}
    for name, make, switch in _opt_cases():
        model.set_state_dict(init)
        switch(model, True)
        try:
            eng = _gpt_engine(model, init, make(model.parameters(), 1e-4),
                              cfg)
            _zero_flash()
            losses = [float(_bf16_step(eng, ids, labels)) for _ in range(3)]
            launches = _flash_counts()
            _check(launches == {"B1": 3 * L, "B2": 3 * L, "B3": 3 * L},
                   f"{name}: launches {launches}")
            _check(all(np.isfinite(losses)), f"{name}: losses {losses}")
            for k in total:
                total[k] += launches[k]
            del eng
        finally:
            switch(model, False)
        # the tiny model, card against CPU in f32
        params, tiny_losses = {}, {}
        for dev in ("cuda", "cpu"):
            tiny = GPTForPretraining(
                tcfg, device=dev, generator=torch.Generator().manual_seed(5))
            p0 = {k: p.detach().cpu().numpy().copy()
                  for k, p in tiny.named_parameters()}
            switch(tiny, True)
            eng = Engine(tiny, make(tiny.parameters(), TINY_LR),
                         GPTPretrainingCriterion(tcfg), device=dev, seed=0)
            tiny_losses[dev] = [float(eng.train_batch(tids, tlabels))
                                for _ in range(3)]
            switch(tiny, False)
            params[dev] = {k: p.detach().cpu().numpy()
                           for k, p in tiny.named_parameters()}
        np.testing.assert_allclose(tiny_losses["cuda"], tiny_losses["cpu"],
                                   rtol=1e-5, err_msg=name)
        err = rel = 0.0
        off = size = 0      # elements outside rtol 1e-5 / atol 1e-6
        for k, want in params["cpu"].items():
            (got, got_key), (want, want_key), (v0, _) = (
                _split_key_bias(k, a) for a in (params["cuda"][k], want,
                                                p0[k]))
            moved = np.linalg.norm(want - v0)
            dev_ = np.linalg.norm((got - v0) - (want - v0))
            _check(dev_ <= 1e-4 * moved + 1e-7,
                   f"{name}: {k}: the card's update is {dev_} off the "
                   f"CPU's (which moved {moved})")
            if want_key is not None:
                _check(np.abs(got_key - want_key).max() <=
                       2 * TINY_LR * 3 * 1.01, f"{name}: {k} key bias")
            err = max(err, float(np.abs(got - want).max()))
            rel = max(rel, float(dev_ / max(moved, 1e-30)))
            off += int(np.sum(~np.isclose(got, want, rtol=1e-5, atol=1e-6)))
            size += got.size
        out[name] = {"losses": losses, "tiny_losses": tiny_losses,
                     "tiny_max_abs_err": err, "tiny_max_update_rel_dev": rel,
                     "tiny_elements_off_1e-5": [off, size]}
    torch.cuda.empty_cache()
    print(json.dumps({"gpt_optimizers": out, "card": card}), flush=True)
    return total


def _fit_clock():
    """A hapi callback timing each training batch on the host clock."""
    from paddle_tpu_torch.callbacks import Callback

    class FitClock(Callback):
        def __init__(self):
            super().__init__()
            self.batch_s = []
            self._t0 = None

        def on_train_batch_begin(self, step, logs=None):
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.batch_s.append(time.perf_counter() - self._t0)

    return FitClock()


def _timed_loader_cls():
    """A DataLoader that times each batch handed out and checks that
    every leaf of it lies on the card."""
    import torch

    from paddle_tpu_torch.io import DataLoader

    class TimedLoader(DataLoader):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.wait_s = 0.0
            self.batches = 0

        def __iter__(self):
            it = super().__iter__()
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.wait_s += time.perf_counter() - t0
                self.batches += 1
                leaves = batch if isinstance(batch, (list, tuple)) \
                    else [batch]
                _check(all(isinstance(t, torch.Tensor) and t.is_cuda
                           for t in leaves),
                       "a DataLoader batch did not arrive on the card")
                yield batch

    return TimedLoader


def phase_gpt_eager_hapi(card, gpt, first_loss):
    """Phase 40: (a) the eager loop ``loss.backward(); opt.step();
    opt.clear_grad()`` for 3 steps from the initial weights (the
    engine's seed installed for dropout, bf16 O1): its first loss equals
    phase 37's bit for bit, the losses are finite, 12 launches a step of
    each of B1-B3. (b) `paddle_tpu_torch.Model` with AdamW (a cosine
    schedule), `GPTPretrainingCriterion`, `Accuracy(topk=(1, 5))` and
    amp O1: `fit` over 96 sequences (12 steps, batch 8, 2 workers, the
    batches double-buffered onto the card) with 16 evaluation sequences
    and the `ModelCheckpoint` and `LRScheduler` callbacks, then
    `evaluate`, `save`, `load` into a fresh model and `evaluate` again:
    the two evaluations equal bit for bit; B1-B3 12 a training step
    (B1 12 more per evaluation batch). Prints the fit's steps/s and the
    DataLoader's share of the fit's host time."""
    import numpy as np
    import torch

    from paddle_tpu_torch import Model, amp, optimizer
    from paddle_tpu_torch import callbacks as cbs
    from paddle_tpu_torch import load as pload
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nlp.transformers import (
        GPTForPretraining, GPTPretrainingCriterion,
    )

    cfg, model, init, ids, labels = gpt
    L = cfg.num_layers
    # (a) the eager loop
    model.set_state_dict(init)
    model.train()
    opt = optimizer.AdamW(1e-4, parameters=model.parameters(),
                          weight_decay=0.01)
    crit = GPTPretrainingCriterion(cfg)
    x = torch.as_tensor(ids, device="cuda")
    y = torch.as_tensor(labels, device="cuda")
    _zero_flash()
    eager = []
    with prandom.rng_scope(prandom.RngState(0, x.device)):
        for _ in range(3):
            with amp.auto_cast(enable=True, dtype="bfloat16"):
                loss = crit(model(x), y).float()
            loss.backward()
            opt.step()
            opt.clear_grad()
            eager.append(float(loss))
    eager_launches = _flash_counts()
    _check(eager_launches == {"B1": 3 * L, "B2": 3 * L, "B3": 3 * L},
           f"eager loop: launches {eager_launches}")
    _check(all(np.isfinite(eager)), f"eager losses {eager}")
    _check(eager[0] == first_loss,
           f"eager first loss {eager[0]} vs phase 37's {first_loss}")
    del opt, loss
    torch.cuda.empty_cache()

    # (b) hapi
    model.set_state_dict(init)
    n_train, n_eval = 96, 16
    train_ids, train_labels = _gpt_batch(cfg.vocab_size, n_train, GPT_SEQ,
                                         11)
    eval_ids, eval_labels = _gpt_batch(cfg.vocab_size, n_eval, GPT_SEQ, 12)
    Loader = _timed_loader_cls()
    train = Loader(TensorDataset([train_ids, train_labels]), places="cuda",
                   batch_size=GPT_BATCH, shuffle=True, num_workers=2)
    evald = TensorDataset([eval_ids, eval_labels])

    def prepared(net):
        sched = optimizer.lr.CosineAnnealingDecay(
            1e-4, T_max=n_train // GPT_BATCH)
        return Model(net).prepare(
            optimizer.AdamW(sched, parameters=net.parameters(),
                            weight_decay=0.01),
            GPTPretrainingCriterion(cfg), metrics=Accuracy(topk=(1, 5)),
            amp_configs="O1")

    hapi = prepared(model)
    clock = _fit_clock()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hapi_")
    try:
        _zero_flash()
        t0 = time.perf_counter()
        hapi.fit(train, eval_data=evald, batch_size=GPT_BATCH, epochs=1,
                 verbose=0, num_workers=2,
                 callbacks=[clock, cbs.ModelCheckpoint(save_dir=tmp),
                            cbs.LRScheduler()])
        fit_s = time.perf_counter() - t0
        fit_launches = _flash_counts()
        steps = len(clock.batch_s)
        _check(steps == n_train // GPT_BATCH == train.batches,
               f"fit took {steps} steps over {train.batches} batches")
        want = {"B1": L * (steps + n_eval // GPT_BATCH), "B2": L * steps,
                "B3": L * steps}
        _check(fit_launches == want,
               f"fit: launches {fit_launches}, want {want}")
        t0 = time.perf_counter()
        logs = hapi.evaluate(evald, batch_size=GPT_BATCH, verbose=0)
        eval_s = time.perf_counter() - t0
        path = f"{tmp}/gpt2"
        t0 = time.perf_counter()
        hapi.save(path)
        save_s = time.perf_counter() - t0
        fresh = GPTForPretraining(cfg, device="cuda",
                                  generator=torch.Generator().manual_seed(1))
        again = prepared(fresh)
        t0 = time.perf_counter()
        again.load(path)
        load_s = time.perf_counter() - t0
        logs2 = again.evaluate(evald, batch_size=GPT_BATCH, verbose=0)
        pdopt = sorted(pload(path + ".pdopt"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _check(set(logs) == {"eval_loss", "eval_acc_top1", "eval_acc_top5"},
           f"evaluate logs {logs}")
    _check(logs == logs2, f"evaluate after the reload {logs2} vs {logs}")
    _check(all(np.isfinite(list(logs.values()))), f"eval logs {logs}")
    train_s = sum(clock.batch_s)
    out = {"gpt_eager": {"losses": eager, "first_loss_bitwise": True,
                         "launches": eager_launches},
           "gpt_hapi": {
               "card": card, "fit_steps": steps, "fit_s": fit_s,
               "fit_steps_per_s": steps / train_s,
               "fit_step_ms_p50": float(np.median(clock.batch_s)) * 1e3,
               "loader_wait_s": train.wait_s,
               "loader_share_of_fit_host_time": train.wait_s / fit_s,
               "evaluate_s": eval_s, "save_s": save_s, "load_s": load_s,
               "eval_logs": logs, "eval_bitwise_after_reload": True,
               "pdopt_keys": pdopt, "launches": fit_launches}}
    print(json.dumps(out), flush=True)
    del hapi, again, fresh
    torch.cuda.empty_cache()
    return {k: eager_launches[k] + fit_launches[k] for k in eager_launches}


def phase_gpt_all(card):
    """Phases 37-40 on one gpt2-small; returns B1-B3's launches by
    phase."""
    leg, gpt = phase_gpt_train(card)
    first = leg["losses"][0]
    launches = {"train_37": {k: int(v * leg["steps"])
                             for k, v in leg["launches_per_step"].items()}}
    launches["recompute_38"] = phase_gpt_recompute(card, gpt, first)
    launches["optimizers_39"] = phase_gpt_optimizers(card, gpt)
    launches["eager_hapi_40"] = phase_gpt_eager_hapi(card, gpt, first)
    return launches



# -- Transformer-base (phases 41-43) ----------------------------------------

TB_VOCAB, TB_D, TB_BATCH, TB_SEQ = 37000, 512, 24, 128
TB_DECODE_BATCH, TB_DECODE_STEPS = 8, 32
# f32 cached decoding against the uncached forward (B1 at sq 1 in f32
# against the plain masked path, through 6 decoder layers and the tied
# [512 x 37000] projection)
TB_DECODE_RTOL, TB_DECODE_ATOL = 1e-3, 1e-3
# the nn sweep: CUDA against the CPU in f32 (TF32 off)
SWEEP_RTOL, SWEEP_ATOL = 1e-4, 1e-5
RNN_RTOL, RNN_ATOL = 1e-4, 1e-4


def _tb_model(seed=0, device="cuda"):
    """Transformer-base (Vaswani et al. 2017, Table 3) from public nn
    pieces: `nn.Transformer()` at its defaults (d_model 512, 8 heads, 6 +
    6 layers, FFN 2048, dropout 0.1, ReLU, post-LN) and one
    `nn.Embedding(37000, 512)` (N(0, 512^-0.5)) shared by source, target
    and the pre-softmax projection ``h @ emb.T``; embeddings scaled by
    sqrt(512) plus sinusoidal positions, then dropout 0.1. Weights from
    `seed`."""
    import math

    import numpy as np
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    pos = np.arange(1024)[:, None] / np.power(
        10000.0, 2 * (np.arange(TB_D)[None, :] // 2) / TB_D)
    pos = np.where(np.arange(TB_D) % 2 == 0, np.sin(pos), np.cos(pos))

    class TransformerBase(nn.Layer):
        def __init__(self, gen):
            super().__init__()
            self.emb = nn.Embedding(
                TB_VOCAB, TB_D, generator=gen,
                weight_attr=nn.initializer.Normal(0.0, TB_D ** -0.5))
            self.transformer = nn.Transformer(generator=gen)
            self.dropout = nn.Dropout(0.1)
            self.register_buffer("pos", torch.tensor(pos, dtype=torch.float32),
                                 persistent=False)

        def embed(self, ids, offset=0):
            x = self.emb(ids) * math.sqrt(TB_D) + \
                self.pos[offset:offset + ids.shape[1]]
            return self.dropout(x)

        def logits(self, h):
            return F.matmul(h, self.emb.weight, transpose_y=True)

        def forward(self, src, tgt_in):
            mask = self.transformer.generate_square_subsequent_mask(
                tgt_in.shape[1])
            return self.logits(self.transformer(
                self.embed(src), self.embed(tgt_in), tgt_mask=mask))

    return TransformerBase(torch.Generator().manual_seed(seed)).to(device)


def _tb_loss(logits, tgt):
    """Label-smoothed (0.1) soft-label cross entropy over the vocab."""
    from paddle_tpu_torch.nn import functional as F

    soft = F.label_smooth(F.one_hot(tgt, TB_VOCAB), epsilon=0.1)
    return F.cross_entropy(logits, soft, soft_label=True)


def _tb_batch(n, seq, seed):
    """Seeded source ids [n, seq] and target ids [n, seq + 1] (the
    decoder reads tgt[:, :-1] and predicts tgt[:, 1:])."""
    import numpy as np

    rng = np.random.RandomState(seed)
    src = rng.randint(1, TB_VOCAB, (n, seq)).astype(np.int64)
    tgt = rng.randint(1, TB_VOCAB, (n, seq + 1)).astype(np.int64)
    return src, tgt


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _tb_eval_loss(model, src, tgt_in, tgt_out, device):
    """The loss of the batch in eval mode (no dropout), bf16 O1."""
    import torch

    from paddle_tpu_torch import amp

    model.eval()
    try:
        with torch.no_grad(), amp.auto_cast(enable=True, dtype="bfloat16"):
            return float(_tb_loss(model(*(torch.tensor(a, device=device)
                                          for a in (src, tgt_in))),
                                  torch.tensor(tgt_out, device=device)))
    finally:
        model.train()


def phase_tb_train(card, device="cuda"):
    """Phase 41: Transformer-base training through `Engine.train_batch`:
    Adam(0.9, 0.98, 1e-9) on NoamDecay(512, 4000) (stepped after each
    train step), bf16 O1, 24 x 128 source and target tokens of seeded
    ids. 2 warm-up and 10 timed steps (each ends in a synchronise).
    Gates: finite losses; the batch's eval-mode loss (no dropout) lower
    after the 12 steps than before them (the train losses, drawn under
    dropout at a warm-up learning rate of ~1e-6, are printed with their
    slope); exactly 12 launches a step of each of B1-B3 (6 encoder
    self-attentions and 6 cross-attentions; the masked decoder
    self-attention takes the plain path); one train_step compile. Then
    the step's device time by bucket (`phase_train_profile`) and
    `attribute_step` (`phase_attribute`). With ``device="cpu"`` (a
    rehearsal at reduced sizes) the timing and the profiles are left
    out."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp, observe, optimizer
    from paddle_tpu_torch.engine import Engine
    from paddle_tpu_torch.optimizer import lr

    compiles0 = len(observe.compile_events("train_step"))
    model = _tb_model(device=device)
    sched = lr.NoamDecay(d_model=TB_D, warmup_steps=4000)
    opt = optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                         epsilon=1e-9, parameters=model.parameters())
    eng = Engine(model, opt, _tb_loss, device=device, seed=0)
    src, tgt = _tb_batch(TB_BATCH, TB_SEQ, 0)
    tgt_in, tgt_out = tgt[:, :-1], tgt[:, 1:]

    def step():
        with amp.auto_cast(enable=True, dtype="bfloat16"):
            loss = eng.train_batch((src, tgt_in), (tgt_out,))
        sched.step()
        return loss

    cuda = torch.device(device).type == "cuda"
    eval_before = _tb_eval_loss(model, src, tgt_in, tgt_out, device)
    losses = [float(step()) for _ in range(2)]
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _zero_flash()
    n, times = 10, []
    with observe.no_retrace():
        for _ in range(n):
            t0 = time.perf_counter()
            loss = step()
            _sync(device)
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
    launches = _flash_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    compiles = len(observe.compile_events("train_step")) - compiles0
    eval_after = _tb_eval_loss(model, src, tgt_in, tgt_out, device)
    per_step = 2 * len(model.transformer.encoder.layers) if cuda else 0
    _check(launches == {"B1": per_step * n, "B2": per_step * n,
                        "B3": per_step * n},
           f"transformer-base: launches over {n} steps {launches}")
    _check(compiles == 1, f"{compiles} train_step compiles")
    _check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    _check(eval_after < eval_before,
           f"the eval loss did not fall: {eval_before} -> {eval_after}")
    label = "transformer-base train step (b24 s128 bf16, Adam/Noam)"
    prof, att = {"busy_ms": float("nan")}, {"ms_per_step": None}
    if cuda:
        prof = phase_train_profile(step, label)
        # two captures of this host-bound step (idle ~0.85) differ in
        # device time by up to 3.7% on one card with every bucket scaled
        # alike (five interleaved pairs; 4.0% once in seven whole runs):
        # the gate allows 6%, which a replay in another precision exceeds
        att = phase_attribute(eng, label, prof, {"B1": per_step,
                                                 "B2": per_step,
                                                 "B3": per_step}, tol=0.06)
    n_params = sum(p.numel() for p in eng.state.params.values())
    step_s = float(np.median(times))
    host_ms = step_s * 1e3
    out = {
        "train": "transformer-base b24 s128 bf16 dropout 0.1 Adam/Noam",
        "card": card, "steps": n, "params": n_params,
        "step_ms_p50": host_ms,
        "step_ms_p90": float(np.percentile(times, 90)) * 1e3,
        "target_tokens_per_s": TB_BATCH * TB_SEQ / step_s,
        "device_busy_ms": prof["busy_ms"],
        "device_idle_share": max(0.0, 1.0 - prof["busy_ms"] / host_ms),
        "peak_mem_bytes": peak, "losses": losses,
        "train_loss_slope": float(np.polyfit(np.arange(len(losses)),
                                             losses, 1)[0]),
        "last_below_first": losses[-1] < losses[0],
        "eval_loss": [eval_before, eval_after],
        "lr_last": sched(), "launches_per_step": {
            k: c / n for k, c in launches.items()},
        "train_step_compiles": compiles,
        "attribute_ms_per_step": att["ms_per_step"],
    }
    print(json.dumps(out), flush=True)
    del eng, opt
    if cuda:
        torch.cuda.empty_cache()
    return out, model


def _tb_decode(model, src, steps, bf16):
    """Greedy cached decoding: the encoder once, then `steps` steps of one
    token through `TransformerDecoder.gen_cache` / ``cache=`` (B1 at sq 1
    in the self-attention against the growing key length and in the
    cross-attention against the 128 memory keys). Returns (tokens [b,
    steps], f32 logits [steps, b, V], memory, B1-B3 launches, seconds)."""
    import contextlib

    import torch

    from paddle_tpu_torch import amp

    tr = model.transformer
    ctx = amp.auto_cast(enable=True, dtype="bfloat16") if bf16 \
        else contextlib.nullcontext()
    _sync(src.device)
    _zero_flash()
    t0 = time.perf_counter()
    with torch.no_grad(), ctx:
        memory = tr.encoder(model.embed(src))
        cache = tr.decoder.gen_cache(memory)
        ids = torch.zeros((src.shape[0], 1), dtype=torch.long,
                          device=src.device)
        logits_all = []
        for t in range(steps):
            h, cache = tr.decoder(model.embed(ids[:, -1:], offset=t), memory,
                                  cache=cache)
            logits = model.logits(h)[:, -1].float()
            logits_all.append(logits)
            ids = torch.cat([ids, logits.argmax(-1, keepdim=True)], dim=1)
    _sync(src.device)
    seconds = time.perf_counter() - t0
    return (ids[:, 1:], torch.stack(logits_all), memory, _flash_counts(),
            seconds)


def _tb_uncached(model, memory, tokens, bf16):
    """The uncached forward's last-position logits for every prefix
    [BOS, tokens[:t]] under the float causal mask, with an all-zero
    memory mask: the plain masked path throughout."""
    import contextlib

    import torch

    from paddle_tpu_torch import amp

    tr = model.transformer
    ctx = amp.auto_cast(enable=True, dtype="bfloat16") if bf16 \
        else contextlib.nullcontext()
    prefix = torch.cat([torch.zeros_like(tokens[:, :1]), tokens[:, :-1]],
                       dim=1)
    mem_mask = torch.zeros((1, 1, 1, memory.shape[1]), device=memory.device)
    out = []
    with torch.no_grad(), ctx:
        for t in range(tokens.shape[1]):
            ids = prefix[:, :t + 1]
            h = tr.decoder(model.embed(ids), memory,
                           tgt_mask=tr.generate_square_subsequent_mask(t + 1),
                           memory_mask=mem_mask)
            out.append(model.logits(h)[:, -1].float())
    return torch.stack(out)


def phase_tb_decode(card, model, device="cuda"):
    """Phase 42: cached greedy decoding of Transformer-base in eval: 8
    sources of 128 seeded tokens, 32 steps. f32 gates: each step's logits
    within rtol / atol TB_DECODE_RTOL / TB_DECODE_ATOL of the uncached
    forward over the same prefix (the float causal mask, the plain masked
    path), token agreement 1.0 with the uncached forward's greedy picks;
    B1 launches exactly 6 (encoder) + 12 a step, B2 / B3 none. The same
    in bf16 O1: its token agreement with the f32 tokens and with its own
    uncached forward, printed."""
    import numpy as np
    import torch

    model.eval()
    src_np, _ = _tb_batch(TB_DECODE_BATCH, TB_SEQ, 1)
    src = torch.tensor(src_np, device=device)
    L = len(model.transformer.decoder.layers)
    want_b1 = len(model.transformer.encoder.layers) + 2 * L * TB_DECODE_STEPS
    if torch.device(device).type != "cuda":
        want_b1 = 0
    out = {"decode": "transformer-base greedy, 8 x 128 sources, 32 steps",
           "card": card}
    tokens = {}
    for bf16 in (False, True):
        key = "bf16" if bf16 else "f32"
        toks, logits, memory, launches, secs = _tb_decode(
            model, src, TB_DECODE_STEPS, bf16)
        _check(launches == {"B1": want_b1, "B2": 0, "B3": 0},
               f"decode {key}: launches {launches}, want B1 {want_b1}")
        full = _tb_uncached(model, memory, toks, bf16)
        agree = float((full.argmax(-1).T == toks).float().mean())
        err = float((logits - full).abs().max())
        tokens[key] = toks
        out[key] = {"launches": launches, "max_abs_err_vs_uncached": err,
                    "token_agreement_vs_uncached": agree,
                    "decode_s": secs,
                    "tokens_per_s": toks.numel() / secs}
        if not bf16:
            torch.testing.assert_close(logits, full, rtol=TB_DECODE_RTOL,
                                       atol=TB_DECODE_ATOL)
            _check(agree == 1.0, f"f32 token agreement {agree}")
    out["bf16"]["token_agreement_vs_f32"] = float(
        (tokens["bf16"] == tokens["f32"]).float().mean())
    print(json.dumps(out), flush=True)
    model.train()
    return {"B1": 2 * want_b1}


def _sweep_run(call, arrays, grad, device, layer=None):
    """(outputs, {name: grad}) of one sweep case on `device` (f32): the
    float inputs, and a layer's trainable parameters, differentiated
    against fixed cotangents."""
    import numpy as np
    import torch

    ts = [torch.tensor(a, device=device) for a in arrays]
    for t in ts:
        if grad and t.is_floating_point():
            t.requires_grad_(True)
    if layer is None:
        from paddle_tpu_torch.nn import functional as F

        out = call(F, *ts)
    else:
        out = call(layer, *ts) if call else layer(*ts)

    def flat(o):
        return [y for x in o for y in flat(x)] \
            if isinstance(o, (tuple, list)) else [o]

    outs = flat(out)
    got = [o.detach().cpu() for o in outs]
    grads = {}
    if grad:
        rng = np.random.default_rng(7)
        loss = sum((o * torch.tensor(rng.standard_normal(tuple(o.shape))
                                     .astype(np.float32), device=device))
                   .sum() for o in outs if o.is_floating_point())
        loss.backward()
        params = {f"in{i}": t for i, t in enumerate(ts)
                  if t.is_floating_point()}
        if layer is not None:
            params.update({k: p for k, p in layer.named_parameters()
                           if p.requires_grad})
        grads = {k: None if p.grad is None else p.grad.detach().cpu()
                 for k, p in params.items()}
    return got, grads


def _sweep_compare(got, want, what, rtol=SWEEP_RTOL, atol=SWEEP_ATOL):
    """Max abs error; raises beyond the tolerance."""
    import torch

    if isinstance(want, dict):
        _check(set(got) == set(want), f"{what}: names differ")
        got, want = [got[k] for k in sorted(want)], \
            [want[k] for k in sorted(want)]
    _check(len(got) == len(want), f"{what}: {len(got)} vs {len(want)}")
    err = 0.0
    for g, w in zip(got, want):
        if g is None or w is None:
            _check(g is None and w is None, f"{what}: a gradient is None")
            continue
        if w.is_floating_point():
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol,
                                       msg=lambda m: f"{what}: {m}")
            err = max(err, float((g - w).abs().max()) if g.numel() else 0.)
        else:
            _check(torch.equal(g, w), f"{what}: integer outputs differ")
    return err


def _sweep_random_ops(device):
    """The random ops on the card by their properties: the kept share,
    the scaling, whole channels, the one-hot rows."""
    import torch

    from paddle_tpu_torch.framework import random as trandom
    from paddle_tpu_torch.nn import functional as F

    with trandom.rng_scope(trandom.RngState(5, device)):
        x = torch.ones(512, 512, device=device)
        y = F.dropout(x, 0.3)
        kept = y != 0
        _check(abs(kept.float().mean().item() - 0.7) < 0.01, "dropout share")
        _check(bool(torch.isclose(y[kept], torch.tensor(1 / 0.7,
                                                        device=device))
                    .all()), "dropout scale")
        for fn, shape in ((F.dropout2d, (16, 64, 3, 3)),
                          (F.dropout3d, (8, 64, 2, 2, 2))):
            y = fn(torch.ones(shape, device=device), 0.4).flatten(2)
            _check(bool((y.amin(-1) == y.amax(-1)).all()),
                   f"{fn.__name__}: channels not whole")
            _check(abs((y[..., 0] != 0).float().mean().item() - 0.6) < 0.1,
                   f"{fn.__name__}: share")
        z = torch.randn(400, 500, device=device)
        a = F.alpha_dropout(z, 0.2)
        _check(abs(a.mean().item()) < 0.02 and abs(a.std().item() - 1) <
               0.02, "alpha_dropout moments")
        g = F.gumbel_softmax(torch.randn(64, 10, device=device), 0.5,
                             hard=True)
        _check(bool(((g > 0.5).sum(-1) == 1).all()), "gumbel_softmax hard")


def _sweep_beam(device):
    """BeamSearchDecoder / dynamic_decode on the card over a fixed-table
    cell (the logits depend on the previous token only): the best beam is
    the brute-force best path, every beam's score its path's score."""
    import itertools

    import numpy as np
    import torch

    from paddle_tpu_torch import nn

    vocab, end, steps = 5, 0, 4
    table = np.random.default_rng(0).standard_normal(
        (vocab, vocab)).astype(np.float32) * 2.0
    table[:, end] = -5.0

    def score(path):
        s, prev = 0.0, 1
        for tok in path:
            row = table[prev].astype(np.float64)
            s += row[tok] - np.log(np.exp(row).sum())
            prev = tok
        return s

    class FixedCell(nn.Layer):
        def __init__(self):
            super().__init__()
            self.table = torch.tensor(table, device=device)

        def forward(self, tokens, states):
            return self.table[tokens], states

    ids, scores = nn.dynamic_decode(
        nn.BeamSearchDecoder(FixedCell(), 1, end, 4),
        torch.zeros(2, 1, device=device), max_step_num=steps)
    best = max((p for p in itertools.product(range(vocab), repeat=steps)
                if end not in p), key=score)
    _check(ids[0, :, 0].tolist() == list(best), "beam search: best path")
    for b in range(2):
        for w in range(4):
            _check(abs(score(ids[b, :, w].tolist()) - float(scores[b, w]))
                   < 1e-4, "beam search: a beam's score")


def phase_nn_sweep(card, device="cuda"):
    """Phase 43: every case of tests/torch_nn_cases.py (every public
    function of nn.functional and every layer class) on CUDA against the
    same call on CPU tensors, f32, forward and (where differentiable)
    backward: outputs, the gradients of the float inputs and of every
    parameter, and the state after the call, within rtol SWEEP_RTOL /
    atol SWEEP_ATOL; the random ops by their properties; LSTM, GRU and
    SimpleRNN (2 layers, bidirectional, hidden 256, b 16 x 64 steps)
    within RNN_RTOL / RNN_ATOL; BeamSearchDecoder against brute force.
    Any mismatch raises."""
    import copy

    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    import torch_nn_cases as cases

    from paddle_tpu_torch import nn

    names, errs = set(), {}
    t0 = time.monotonic()
    for case in cases.F_CASES:
        arrays = case.inputs()
        want, want_g = _sweep_run(case.call, arrays, case.grad, "cpu")
        got, got_g = _sweep_run(case.call, arrays, case.grad, device)
        e = _sweep_compare(got, want, case.id)
        if case.grad:
            e = max(e, _sweep_compare(got_g, want_g, f"{case.id} grad"))
        errs[case.id] = e
        names.add(case.fn)
    _sweep_random_ops(device)
    names.update(cases.RANDOM_FUNCTIONS)
    rnn = [cases.Case(cls, (lambda r: (r.standard_normal((16, 64, 128))
                                       .astype("float32"),)),
                      ((lambda c: lambda m: getattr(m, c)(
                          128, 256, 2, direction="bidirect"))(cls), None))
           for cls in ("LSTM", "GRU", "SimpleRNN")]
    for case in cases.L_CASES + rnn:
        ctor, call = case.call
        cpu = ctor(nn)
        shapes = {k: tuple(v.shape) for k, v in cpu.state_dict().items()}
        cpu.set_state_dict(cases.layer_values(shapes))
        cpu.train() if case.train else cpu.eval()
        dev = copy.deepcopy(cpu).to(device)
        arrays = case.inputs()
        want, want_g = _sweep_run(call, arrays, case.grad, "cpu", cpu)
        got, got_g = _sweep_run(call, arrays, case.grad, device, dev)
        big = case in rnn
        tol = dict(rtol=RNN_RTOL, atol=RNN_ATOL) if big else {}
        cid = f"{case.id}-h256" if big else case.id
        e = _sweep_compare(got, want, cid, **tol)
        if case.grad:
            e = max(e, _sweep_compare(got_g, want_g, f"{cid} grad", **tol))
        e = max(e, _sweep_compare(
            {k: v.cpu() for k, v in dev.state_dict().items()},
            dict(cpu.state_dict()), f"{cid} state", **tol))
        errs[cid] = e
        names.add(case.fn)
    _sweep_beam(device)
    names.update(("BeamSearchDecoder", "dynamic_decode"))
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:8]
    out = {"nn_sweep": "cuda against cpu, f32", "card": card,
           "names_swept": len(names), "cases": len(errs),
           "seconds": time.monotonic() - t0,
           "largest_abs_err": dict(worst)}
    print(json.dumps(out), flush=True)
    return out


def phase_transformer_base(card):
    """Phases 41-43; returns B1-B3's launches by phase."""
    train, model = phase_tb_train(card)
    launches = {"train_41": {k: int(v * train["steps"])
                             for k, v in train["launches_per_step"].items()}}
    launches["decode_42"] = phase_tb_decode(card, model)
    del model
    phase_nn_sweep(card)
    return launches


# -- mixed precision complete (phases 44-46) ---------------------------------

def _b1_b6():
    from paddle_tpu_torch.ops import fused_loss, fused_ops

    return {**fused_ops.flash_attention.launches, **fused_loss.launches}


def _zero_b1_b6():
    from paddle_tpu_torch.ops import fused_loss, fused_ops

    fused_ops.flash_attention.launches.update(B1=0, B2=0, B3=0)
    fused_loss.launches.update(B4=0, B5=0, B6=0)


_DTYPE_NAMES = {0: "float32", 1: "bfloat16", 2: "float16"}
# where each kernel entry takes its dtype code (ops/_launch.dtype_code)
_DTYPE_ARG = {"flash_attn_fwd": ("B1", 1), "flash_attn_bwd_dq": ("B2", 1),
              "flash_attn_bwd_dkv": ("B3", 1), "fused_lce_fwd": ("B4", 1),
              "fused_lce_dx": ("B5", 1), "fused_lce_dw": ("B6", 1),
              "fused_conv": ("B10", 0),
              # B9's quantise passes read a and b each in its own dtype
              "scaled_matmul": ("B9", (1, 4))}


class _DtypeRecorder:
    """Which instantiation each launch of B1-B6, B9 and B10 took: counts
    by (kernel, dtype) of the calls through `ops._launch.launch` inside
    the block (the wrappers pass each kernel its dtype code; B9's key
    names a's and b's, "float16xfloat32")."""

    def __enter__(self):
        from paddle_tpu_torch.ops import _launch

        self.counts = {}
        self._orig = orig = _launch.launch

        def launch(lib, fn, what, device, *args):
            if what in _DTYPE_ARG:
                key, at = _DTYPE_ARG[what]
                k = (key, "x".join(_DTYPE_NAMES[args[i]] for i in at)
                     if isinstance(at, tuple) else _DTYPE_NAMES[args[at]])
                self.counts[k] = self.counts.get(k, 0) + 1
            return orig(lib, fn, what, device, *args)

        _launch.launch = launch
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.ops import _launch

        _launch.launch = self._orig

    def by_dtype(self):
        return {f"{k}/{dt}": n for (k, dt), n in sorted(self.counts.items())}


def _scale_rule_ok(before, after, cfg):
    """Whether one step's (scale, good, bad) transition is the
    reference's dynamic loss-scaling rule for a finite or a non-finite
    step (`engine.update_loss_scale`, the reference's in-graph rule)."""
    s, g, b = before
    finite = (s * cfg["incr_ratio"], 0, 0) if g + 1 >= \
        cfg["incr_every_n_steps"] else (s, g + 1, 0)
    bad = (s * cfg["decr_ratio"], 0, 0) if b + 1 >= \
        cfg["decr_every_n_nan_or_inf"] else (s, 0, b + 1)
    return after in (finite, bad), after == bad and after != finite


def phase_ernie_amp(card, n=3):
    """Phase 44: ERNIE-1.0 at bench.py's full width (b32 x s512, dropout
    0.1, AdamW, the fused LM loss on). (a) `n` steps of
    ``Engine(comm_dtype="bfloat16")``: O2 autocast over f32 parameters,
    then its profile (the device's busy time beside the O1 fused leg's).
    (b) `n` steps of float16 O1 with ``loss_scale="dynamic"``. (c) 2
    steps of (b) with ``FLAGS_lowp_matmul`` int8: B9's 69 launches a
    step, some with f16 activations, B4 bypassed. Each leg with the
    launch counts set to 0 just before it and read just after: 12 of
    each of B1-B3 and 1 of each of B4-B6 a step, every one of them in
    the leg's instantiation (bf16 in (a), f16 in (b) and (c)); finite
    losses; (b)'s scale, good and bad step buffers follow the
    reference's rule at every step. Returns (launches by leg, the
    report)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.engine import (
        BAD_STEPS_KEY, DEFAULT_SCALE_CONFIG, GOOD_STEPS_KEY, LOSS_SCALE_KEY,
    )
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.nlp.transformers import ErnieConfig
    from paddle_tpu_torch.ops import lowp as lowp_ops

    set_flags({"FLAGS_use_fused_lm_loss": True, "FLAGS_lowp_matmul": "off"})
    cfg = ErnieConfig(**ERNIE)
    ids, labels = _ernie_batch(cfg.vocab_size, ERNIE_BATCH, ERNIE_SEQ)
    L = cfg.num_layers
    per_step = {"B1": L, "B2": L, "B3": L, "B4": 1, "B5": 1, "B6": 1}
    out, launches = {"card": card}, {}
    for leg, dtype, kw, amp_kw in (
            ("comm_dtype_bf16", "bfloat16", {"comm_dtype": "bfloat16"},
             {"enable": False}),
            ("fp16_o1_dynamic", "float16", {"loss_scale": "dynamic"},
             {"enable": True, "dtype": "float16"})):
        eng = _ernie_engine(cfg, "cuda", 0, 0, 1e-4, **kw)
        bufs = eng.state.buffers
        losses, scales, times, skipped = [], [], [], 0
        _zero_b1_b6()
        with _DtypeRecorder() as rec:
            for _ in range(n):
                before = tuple(float(bufs[k]) if k in bufs else None for k in
                               (LOSS_SCALE_KEY, GOOD_STEPS_KEY,
                                BAD_STEPS_KEY))
                t0 = time.perf_counter()
                with amp.auto_cast(**amp_kw):
                    loss = eng.train_batch(ids, labels)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(float(loss))
                if LOSS_SCALE_KEY in bufs:
                    after = tuple(float(bufs[k]) for k in (
                        LOSS_SCALE_KEY, GOOD_STEPS_KEY, BAD_STEPS_KEY))
                    ok, bad = _scale_rule_ok(before, after,
                                             DEFAULT_SCALE_CONFIG)
                    _check(ok, f"{leg}: scale {before} -> {after} is not "
                           f"the reference's rule")
                    skipped += int(bad)
                    scales.append(after)
        got = _b1_b6()
        _check(got == {k: c * n for k, c in per_step.items()},
               f"{leg}: launches {got} over {n} steps, want {per_step} a "
               f"step")
        by_dtype = rec.by_dtype()
        _check(by_dtype == {f"{k}/{dtype}": c * n
                            for k, c in per_step.items()},
               f"{leg}: instantiations {by_dtype}")
        _check(all(np.isfinite(losses)), f"{leg}: losses {losses}")
        for p in eng.state.params.values():
            _check(p.dtype == torch.float32, f"{leg}: a {p.dtype} parameter")
        row = {"steps": n, "losses": losses,
               "step_ms_p50": float(np.median(times)) * 1e3,
               "launches_by_dtype": by_dtype}
        if scales:
            row.update(scale_buffers=scales, skipped_steps=skipped)
        if leg == "comm_dtype_bf16":
            def step():
                return eng.train_batch(ids, labels)

            # 3 more steps, profiled, read in the leg's counts
            row["device_busy_ms"] = phase_train_profile(
                step, "ernie-1.0 train step (b32 s512, comm_dtype bf16 O2, "
                "fused loss)")["busy_ms"]
            got = _b1_b6()
            _check(got == {k: c * (n + 3) for k, c in per_step.items()},
                   f"{leg}: launches {got} with the profiled steps")
        launches[leg] = got
        out[leg] = row
        del eng
        torch.cuda.empty_cache()
    # (c) float16 O1 with FLAGS_lowp_matmul int8: B9's quantise passes
    # take the f16 activations the reference hands them
    set_flags({"FLAGS_lowp_matmul": "int8"})
    try:
        eng = _ernie_engine(cfg, "cuda", 0, 0, 1e-4, loss_scale="dynamic")
        b9 = _b9_per_step(eng.layer)
        _zero_b1_b6()
        lowp_ops.scaled_matmul.launches = 0
        losses = []
        with _DtypeRecorder() as rec:
            for _ in range(2):
                with amp.auto_cast(enable=True, dtype="float16"):
                    losses.append(float(eng.train_batch(ids, labels)))
        torch.cuda.synchronize()
    finally:
        set_flags({"FLAGS_lowp_matmul": "off"})
    got = {**_b1_b6(), "B9": lowp_ops.scaled_matmul.launches}
    want = {**{k: c * 2 for k, c in per_step.items()}, "B4": 0, "B9": b9 * 2}
    _check(got == want, f"f16 lowp: launches {got}, want {want}")
    by_dtype = rec.by_dtype()
    f16_b9 = sum(c for k, c in by_dtype.items()
                 if k.startswith("B9/") and "float16" in k)
    _check(f16_b9 > 0 and sum(c for k, c in by_dtype.items()
                              if k.startswith("B9/")) == b9 * 2,
           f"f16 lowp: B9 instantiations {by_dtype}")
    _check(all(np.isfinite(losses)), f"f16 lowp: losses {losses}")
    launches["fp16_o1_lowp_int8"] = got
    out["fp16_o1_lowp_int8"] = {"steps": 2, "losses": losses,
                                "launches_by_dtype": by_dtype}
    del eng
    torch.cuda.empty_cache()
    print(json.dumps({"ernie_amp_44": out}), flush=True)
    return launches, out


def phase_gpt_amp(card, max_eager=24):
    """Phase 45: GPT-2 small (b8 x s1024, dropout 0.1). (a) `Model` with
    ``amp_configs={"level": "O2"}`` (bf16) through `fit` over 3 batches,
    then one `train_batch`: 12 launches a step of each of B1-B3
    (causal), all bf16, counted after `fit` and again after
    `train_batch`; a finite loss. (b) the eager float16 O2 loop:
    ``amp.decorate(model, opt, level="O2", dtype="float16")``,
    ``GradScaler(init_loss_scaling=2**24)``,
    ``scaler.scale(loss).backward(); scaler.unscale_(opt);
    scaler.step(opt)`` (`step` updates the scale, as the reference's
    does) under ``auto_cast(level="O2", dtype="float16")`` until two
    steps have gone through (at most `max_eager`): the first steps
    overflow in f16 and are skipped, the scale halving each time.
    Gates: at least one skip and one update, every parameter unchanged
    bit for bit on each skipped step, B1-B3 12 a step in f16. Returns
    B1-B3's launches by leg and the report."""
    import numpy as np
    import torch

    from paddle_tpu_torch import Model, amp, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.nlp.transformers import GPTPretrainingCriterion

    cfg, model, init = _gpt_model()
    L = cfg.num_layers
    out = {"card": card}
    # (a) hapi O2 through the engine
    n_train = 3 * GPT_BATCH
    ids, labels = _gpt_batch(cfg.vocab_size, n_train, GPT_SEQ, 21)
    hapi = Model(model).prepare(
        optimizer.AdamW(1e-4, parameters=model.parameters(),
                        weight_decay=0.01),
        GPTPretrainingCriterion(cfg), amp_configs={"level": "O2"})
    _zero_flash()
    with _DtypeRecorder() as rec:
        hapi.fit(TensorDataset([ids, labels]), batch_size=GPT_BATCH,
                 epochs=1, verbose=0)
        fit_launches = _flash_counts()
        loss = hapi.train_batch([ids[:GPT_BATCH]], [labels[:GPT_BATCH]])[0]
    hapi_launches = _flash_counts()
    steps = n_train // GPT_BATCH
    _check(fit_launches == {k: L * steps for k in ("B1", "B2", "B3")},
           f"hapi O2 fit: launches {fit_launches}")
    want = {k: L * (steps + 1) for k in ("B1", "B2", "B3")}
    _check(hapi_launches == want,
           f"hapi O2 fit and train_batch: launches {hapi_launches}")
    _check(rec.by_dtype() == {f"{k}/bfloat16": c for k, c in want.items()},
           f"hapi O2: instantiations {rec.by_dtype()}")
    _check(np.isfinite(loss), f"hapi O2 loss {loss}")
    out["hapi_o2"] = {"fit_steps": steps, "loss": loss,
                      "fit_launches": fit_launches,
                      "launches": hapi_launches}
    del hapi
    # (b) the eager float16 O2 loop with the eager GradScaler
    model.set_state_dict(init)
    model.train()
    opt = optimizer.AdamW(1e-4, parameters=model.parameters(),
                          weight_decay=0.01)
    amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 24)
    crit = GPTPretrainingCriterion(cfg)
    x = torch.as_tensor(ids[:GPT_BATCH], device="cuda")
    y = torch.as_tensor(labels[:GPT_BATCH], device="cuda")
    params = list(model.parameters())
    _check(all(p.dtype == torch.float16 for p in params),
           "decorate left a parameter out of f16")
    skipped = updated = 0
    losses, scales = [], []
    _zero_flash()
    with _DtypeRecorder() as rec, \
            prandom.rng_scope(prandom.RngState(0, x.device)):
        for i in range(max_eager):
            before = [p.detach().clone() for p in params]
            with amp.auto_cast(level="O2", dtype="float16"):
                loss = crit(model(x), y)
            scaler.scale(loss).backward()
            scaler.unscale_(opt)
            skip = scaler._found_inf
            scaler.step(opt)
            opt.clear_grad()
            same = all(torch.equal(a, p.detach()) for a, p in
                       zip(before, params))
            if skip:
                skipped += 1
                _check(same, f"eager step {i}: a skipped step moved a "
                       "parameter")
            else:
                updated += 1
                _check(not same, f"eager step {i}: nothing moved")
            losses.append(float(loss.detach()))
            scales.append(float(scaler.get_loss_scaling()))
            del before
            if updated >= 2:
                break
    eager_launches = _flash_counts()
    n_eager = len(losses)
    _check(skipped >= 1 and updated >= 1,
           f"eager f16 O2: {skipped} skipped, {updated} updated")
    _check(eager_launches == {k: L * n_eager for k in ("B1", "B2", "B3")},
           f"eager f16 O2: launches {eager_launches} in {n_eager} steps")
    _check(rec.by_dtype() == {f"{k}/float16": L * n_eager
                              for k in ("B1", "B2", "B3")},
           f"eager f16 O2: instantiations {rec.by_dtype()}")
    _check(all(np.isfinite(losses)), f"eager f16 O2 losses {losses}")
    out["eager_fp16_o2"] = {"steps": n_eager, "skipped": skipped,
                            "updated": updated, "final_scale": scales[-1],
                            "scales": scales, "losses": losses,
                            "launches": eager_launches}
    print(json.dumps({"gpt_amp_45": out}), flush=True)
    del model, opt, scaler, params
    torch.cuda.empty_cache()
    return {"hapi_o2": hapi_launches, "eager_fp16_o2": eager_launches}, out


def phase_resnet_amp(card, n=3):
    """Phase 46: ResNet-50 at b128 x 224 (s2d stem, Momentum). (a) `n`
    steps of float16 O1 with ``loss_scale="dynamic"``, then 3 profiled:
    B10 exactly the derived launches a step (114), every one the f16
    instantiation, finite losses, the scale buffers following the
    reference's rule.
    (b) the model decorated to bf16 (``amp.decorate`` O2) and one eval
    forward under O2: the derived eval launches in bf16, finite logits of
    the right shape. Returns B10's launches and the report."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.engine import (
        BAD_STEPS_KEY, DEFAULT_SCALE_CONFIG, GOOD_STEPS_KEY, LOSS_SCALE_KEY,
    )
    from paddle_tpu_torch.ops import fused_conv

    model = _resnet_model("cuda", space_to_depth_stem=True)
    eng = _resnet_engine(model, "cuda", loss_scale="dynamic")
    imgs, labels = _resnet_batch(RESNET_BATCH, RESNET_HW)
    per_step, per_fwd = _b10_per_step(model)
    bufs = eng.state.buffers
    keys = (LOSS_SCALE_KEY, GOOD_STEPS_KEY, BAD_STEPS_KEY)
    losses, scales, times = [], [], []
    fused_conv.LAUNCHES = 0
    with _DtypeRecorder() as rec:
        for _ in range(n):
            before = tuple(float(bufs[k]) for k in keys)
            t0 = time.perf_counter()
            with amp.auto_cast(enable=True, dtype="float16"):
                loss = eng.train_batch(imgs, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            after = tuple(float(bufs[k]) for k in keys)
            _check(_scale_rule_ok(before, after, DEFAULT_SCALE_CONFIG)[0],
                   f"resnet f16: scale {before} -> {after}")
            losses.append(float(loss))
            scales.append(after)
    _check(rec.by_dtype() == {"B10/float16": per_step * n},
           f"resnet f16: instantiations {rec.by_dtype()}")

    def step():
        with amp.auto_cast(enable=True, dtype="float16"):
            return eng.train_batch(imgs, labels)

    # 3 more steps, profiled, read in the leg's count
    busy = phase_train_profile(
        step, "resnet-50 train step (b128 224 s2d f16 O1, dynamic "
        "scaling)")["busy_ms"]
    train_launches = fused_conv.LAUNCHES
    _check(train_launches == per_step * (n + 3),
           f"resnet f16: B10 ran {train_launches}x in {n} + 3 steps, "
           f"derived {per_step} a step")
    _check(all(np.isfinite(losses)), f"resnet f16 losses {losses}")
    del eng
    model.eval()
    amp.decorate(model, level="O2", dtype="bfloat16")
    _check(all(t.dtype == torch.bfloat16 for t in model.state_dict().values()
               if t.is_floating_point()), "decorate left a leaf in f32")
    x = torch.from_numpy(imgs).cuda()
    fused_conv.LAUNCHES = 0
    with _DtypeRecorder() as rec, torch.no_grad(), \
            amp.auto_cast(level="O2", dtype="bfloat16"):
        logits = model(x)
    torch.cuda.synchronize()
    eval_launches = fused_conv.LAUNCHES
    _check(eval_launches == per_fwd and
           rec.by_dtype() == {"B10/bfloat16": per_fwd},
           f"resnet O2 eval: {eval_launches} launches, {rec.by_dtype()}")
    _check(logits.dtype == torch.bfloat16 and
           tuple(logits.shape) == (RESNET_BATCH, 1000) and
           bool(torch.isfinite(logits).all()), "O2 eval logits malformed")
    out = {"card": card,
           "fp16_o1_dynamic": {"steps": n, "losses": losses,
                               "scale_buffers": scales,
                               "step_ms_p50": float(np.median(times)) * 1e3,
                               "device_busy_ms": busy,
                               "b10_launches_per_step":
                                   train_launches / (n + 3)},
           "o2_bf16_eval": {"b10_launches": eval_launches}}
    print(json.dumps({"resnet_amp_46": out}), flush=True)
    del model, x, logits
    torch.cuda.empty_cache()
    return train_launches + eval_launches, out


# -- distributed training (phases 47-49) -------------------------------------

# the hybrid GPT of bench.py:445-447 on a chip (dropout 0; attention
# dropout at GPTConfig's default 0.1, which the source leaves on)
HYBRID = dict(vocab_size=50304, hidden_size=1024, num_layers=8, num_heads=16,
              max_seq_len=512, dropout=0.0, use_parallel=True,
              sequence_parallel=True)
# 48's reference pass and 49's factorizations: attention dropout 0 (the
# port draws each rank's masks from its own stream, so a factorization
# cannot repeat the single rank's)
HYBRID_REF = dict(HYBRID, attn_dropout=0.0)
HYBRID_BATCH, HYBRID_SEQ, HYBRID_LR, HYBRID_SEED = 16, 512, 0.01, 7
# B9 launches a step of the hybrid engine at world size 1 and one
# micro-batch: the four linears of each block (q/k/v, out_proj, fc1, fc2)
# and the tied head; the straight-through backward launches none
HYBRID_B9_PER_STEP = 4 * HYBRID["num_layers"] + 1


def _hybrid_probe():
    """The parameters gathered back after 49's steps and compared with
    48's: the first block's packed q / k / v, LayerNorms of the first
    and the last pipeline stage (their gradients summed over mp under
    sequence parallelism), the last block's fc2, the final norm, the
    tied word table (summed over pp) and the position table."""
    last = HYBRID["num_layers"] - 1
    return ("gpt.layers.0.attn.qkv_proj.weight",
            "gpt.layers.0.attn.qkv_proj.bias", "gpt.layers.1.norm1.weight",
            "gpt.layers.1.norm1.bias", f"gpt.layers.{last}.norm2.bias",
            f"gpt.layers.{last}.mlp.fc2.weight",
            f"gpt.layers.{last}.mlp.fc2.bias", "gpt.final_norm.weight",
            "gpt.final_norm.bias",
            "gpt.embeddings.word_embeddings.weight",
            "gpt.embeddings.position_embeddings.weight")
# a probe parameter's change over 49's steps against 48's: within
# HYBRID_DELTA_TOL of the largest element of 48's change, or within
# HYBRID_DELTA_ULPS float32 spacings at the parameter's largest
# magnitude (each SGD step rounds the parameter once, and a LayerNorm
# weight near 1 moves by a few hundred spacings in 2 steps). The CPU
# sweep's sound factorizations read <= 1.25e-5 of the change, and one
# that skips a gradient sum 0.78-1.41 (tests/test_torch_distributed.py)
HYBRID_DELTA_TOL, HYBRID_DELTA_ULPS = 1e-3, 4.0
# (name, dp, mp, pp, sharding, zero stage, offload, rtol): 49's
# factorizations, the sweep's tolerances (1e-3 with pp)
MULTIRANK = {
    2: (("dp2", 2, 1, 1, 1, 0, False, 2e-4),
        ("mp2.seqpar", 1, 2, 1, 1, 0, False, 2e-4),
        ("pp2", 1, 1, 2, 1, 0, False, 1e-3),
        ("sharding2.z1", 1, 1, 1, 2, 1, False, 2e-4),
        ("sharding2.z2", 1, 1, 1, 2, 2, False, 2e-4),
        ("sharding2.z3", 1, 1, 1, 2, 3, False, 2e-4),
        ("sharding2.z3.off", 1, 1, 1, 2, 3, True, 2e-4)),
    4: (("dp2.mp2.seqpar", 2, 2, 1, 1, 0, False, 2e-4),
        ("pp2.mp2.seqpar", 1, 2, 2, 1, 0, False, 1e-3),
        ("mp2.sharding2.z2", 1, 2, 1, 2, 2, False, 2e-4)),
}


def _fleet_init(dp=1, mp=1, pp=1, sharding=1, device="cuda:0"):
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                               "pp_degree": pp, "sharding_degree": sharding}
    strategy.sharding = sharding > 1
    fleet.init(is_collective=True, strategy=strategy, device=device)
    return fleet.get_hybrid_communicate_group()


def _hybrid_batch():
    return _gpt_batch(HYBRID["vocab_size"], HYBRID_BATCH, HYBRID_SEQ)


def phase_collectives(card, store, device="cuda:0", backend="nccl"):
    """Phase 47: every collective of `distributed.collective` once over
    NCCL at world size 1 (`init_parallel_env(backend="nccl")` with a
    ``file://`` store: one rank, so each result is its input) on CUDA
    tensors: all_reduce under each op, all_gather, all_gather_object,
    broadcast, reduce, reduce_scatter, scatter, alltoall, send / recv (to
    itself, one batch_isend_irecv), barrier, wait; the default group's
    backend must be nccl and nothing staged through the host. Prints
    NCCL's version and each call's host ms (synchronised)."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import parallel

    parallel.init_parallel_env(backend=backend, device=device,
                               init_method=f"file://{store}", rank=0,
                               world_size=1)
    C._reset_default_group()
    g = D.get_group()
    _check(g.backend == backend, f"default group backend {g.backend}")
    C.reset_staged_bytes()
    x = torch.arange(4096, dtype=torch.float32, device=device).reshape(64,
                                                                     64)
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    calls = {}

    def run(name, fn, want=None):
        sync()
        t0 = time.perf_counter()
        got = fn()
        sync()
        calls[name] = (time.perf_counter() - t0) * 1e3
        if want is not None:
            _check(torch.equal(got, want), f"{name} over NCCL changed the "
                   "tensor of a world of one")

    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        run(f"all_reduce_{op}", lambda op=op: D.all_reduce(
            x.clone(), getattr(D.ReduceOp, op)), x)
    run("all_gather", lambda: torch.stack(D.all_gather([], x)), x[None])
    run("all_gather_object", lambda: torch.tensor(
        D.all_gather_object([], 7)), torch.tensor([7]))
    run("broadcast", lambda: D.broadcast(x.clone(), src=0), x)
    run("reduce", lambda: D.reduce(x.clone(), dst=0), x)
    run("reduce_scatter", lambda: D.reduce_scatter(
        torch.empty_like(x), [x]), x)
    run("scatter", lambda: D.scatter(torch.empty_like(x), [x], src=0), x)
    run("alltoall", lambda: torch.stack(D.alltoall([x], [])), x[None])
    out = torch.empty_like(x)
    if backend == "nccl":   # gloo has no pair to itself (a CPU rehearsal)
        run("send_recv", lambda: (C.exchange(sends=[(x, 0)],
                                             recvs=[(out, 0)]), out)[1], x)
    run("barrier", lambda: D.barrier())
    run("wait", lambda: D.wait(x), x)
    _check(C.staged_bytes() == {"d2h": 0, "h2d": 0},
           f"NCCL staged through the host: {C.staged_bytes()}")
    rep = {"phase": 47, "card": card, "backend": g.backend,
           "nccl_version": _nccl_version() if x.is_cuda else None,
           "calls_ms": calls}
    print(json.dumps(rep), flush=True)
    return rep


def _nccl_version():
    import torch

    v = torch.cuda.nccl.version()
    return ".".join(map(str, v)) if isinstance(v, tuple) else str(v)


def _hybrid_engine(model, device, lr=HYBRID_LR):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.hybrid import make_gpt_hybrid_engine
    from paddle_tpu_torch.nlp.transformers import GPTPretrainingCriterion

    hcg = _fleet_init(device=device)
    crit = GPTPretrainingCriterion(model.config)
    opt = optimizer.SGD(lr, parameters=model.parameters())
    return make_gpt_hybrid_engine(model, crit, opt, hcg, device=device)


def phase_hybrid_gpt(card, init_dir, n=8, device="cuda:0"):
    """Phase 48: the hybrid GPT at world size 1 through `fleet.init` and
    `make_gpt_hybrid_engine`, as bench.py:445-447 configures it on a
    chip (b16 x s512, hidden 1024, 8 layers, 16 heads, vocab 50304,
    dropout 0 and attention dropout at its default 0.1,
    use_parallel and sequence_parallel on, SGD 0.01, weights from seed
    7, f32). First a reference pass of 2 steps from the same weights at
    attention dropout 0 (`HYBRID_REF`): its losses and the
    `_hybrid_probe()` parameters before and after them are 49's
    reference. Then the source's configuration: 2 + `n` timed steps:
    exactly 8 launches a step of each of B1-B3, finite losses, step p50,
    tokens/s, MFU (6 P + 12 L H S a token against the bf16 dense peak
    and the f32 one), peak memory, a profile (busy and idle share),
    `attribute_step`. Then the same engine from the same weights under
    FLAGS_lowp_matmul int8 and fp8 (bench.py:620-670 at this width): 1
    + 3 steps each, exactly `HYBRID_B9_PER_STEP` B9 launches a step,
    B1-B3 8, finite losses; the int8 leg's first step records its B9
    calls (`_SmmRecorder`) for `phase_hybrid_b9`. The initial weights
    are written to `init_dir` (one .npy a parameter) for 49. With a CPU
    `device` (a rehearsal at shrunk `HYBRID` widths) nothing launches
    and the launch gates, the profile and the memory reading are
    skipped. Returns (report, 49's reference, launches, B9 calls)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import observe, weights
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.nlp.transformers import (
        GPTConfig, GPTForPretraining,
    )
    from paddle_tpu_torch.ops import lowp

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    _fleet_init(device=device)
    cfg = GPTConfig(**HYBRID)
    model = GPTForPretraining(
        cfg, device=device, generator=torch.Generator().manual_seed(
            HYBRID_SEED))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for k, v in init.items():
        np.save(Path(init_dir) / f"{k}.npy", v.cpu().numpy())
    ids, labels = _hybrid_batch()
    L = cfg.num_layers
    per_step = L if on_card else 0

    # the reference pass, at attention dropout 0
    for layer in model.gpt.layers:
        layer.attn.attn_dropout = HYBRID_REF["attn_dropout"]
    eng = _hybrid_engine(model, device)
    _zero_flash()
    ref_losses = [float(eng.train_batch(ids, labels)) for _ in range(2)]
    ref = {"losses": ref_losses,
           "probe0": {k: init[k].cpu().numpy() for k in _hybrid_probe()},
           "probe": weights.gather_values(model, eng.hcg, _hybrid_probe())}
    _check(_flash_counts() == {k: 2 * per_step for k in ("B1", "B2", "B3")},
           f"hybrid gpt reference pass: launches {_flash_counts()}")
    _check(all(np.isfinite(ref_losses)), f"non-finite loss: {ref_losses}")
    del eng
    model.set_state_dict(init)
    for layer in model.gpt.layers:
        layer.attn.attn_dropout = cfg.attn_dropout

    eng = _hybrid_engine(model, device)
    _zero_flash()
    losses = [float(eng.train_batch(ids, labels)) for _ in range(2)]
    sync()
    before = _flash_counts()
    times = []
    with observe.no_retrace():
        for _ in range(n):
            t0 = time.perf_counter()
            loss = eng.train_batch(ids, labels)
            sync()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
    launches = {k: c - before[k] for k, c in _flash_counts().items()}
    _check(launches == {"B1": per_step * n, "B2": per_step * n,
                        "B3": per_step * n},
           f"hybrid gpt: launches over {n} steps {launches}")
    _check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    n_params = sum(p.numel() for p in model.parameters())
    flops_tok = 6.0 * n_params + 12.0 * L * cfg.hidden_size * HYBRID_SEQ
    step_s = float(np.median(times))
    tok_s = HYBRID_BATCH * HYBRID_SEQ / step_s
    prof, rep, mem = {"busy_ms": None}, {"buckets": {}}, {"peak": None}
    if on_card:
        prof = phase_train_profile(
            lambda: eng.train_batch(ids, labels),
            "hybrid gpt world 1 (b16 s512 h1024 L8, f32, SGD, attention "
            "dropout 0.1)")
        logdir = tempfile.mkdtemp(prefix="chip_smoke_hybrid_attrib_")
        try:
            with observe.no_retrace():
                rep = eng.attribute_step(logdir=logdir, steps=1,
                                         top=1 << 30)
        finally:
            shutil.rmtree(logdir, ignore_errors=True)
        mem = eng.memory_analysis()
    peaks = _peaks(card)
    out = {
        "phase": 48, "train": "hybrid gpt b16 s512 h1024 L8 f32 SGD 0.01, "
        f"attention dropout {cfg.attn_dropout}",
        "card": card, "steps": n, "params": n_params,
        "step_ms_p50": step_s * 1e3,
        "step_ms_p90": float(np.percentile(times, 90)) * 1e3,
        "tokens_per_s": tok_s, "mfu": flops_tok * tok_s / peaks[3],
        "mfu_f32_peak": flops_tok * tok_s / peaks[1],
        "device_busy_ms": prof["busy_ms"], "peak_mem_bytes": mem["peak"],
        "losses": losses, "reference_losses": ref_losses,
        "launches_per_step": {k: c / n for k, c in launches.items()},
        "attribute_ms_per_step": {b: us / 1e3
                                  for b, us in rep["buckets"].items()},
    }
    print(json.dumps(out), flush=True)
    # every launch of the flag-off leg: 2 reference steps, 2 + n steps,
    # 3 profiled, 1 attributed
    counts = {k: c + 2 * per_step for k, c in _flash_counts().items()}
    _check(counts == {k: per_step * (n + 8) for k in counts},
           f"hybrid gpt: flag-off leg launches {counts}")
    counts["B9"] = 0
    del eng
    lowp_legs, b9_calls = {}, {}
    for mode in ("int8", "fp8"):
        model.set_state_dict(init)
        set_flags({"FLAGS_lowp_matmul": mode})
        try:
            eng = _hybrid_engine(model, device)
            _zero_flash()
            lowp.scaled_matmul.launches = 0
            with _SmmRecorder() as rec:
                leg = [float(eng.train_batch(ids, labels))]
            if mode == "int8":
                b9_calls = rec.calls
            t0 = time.perf_counter()
            for _ in range(3):
                leg.append(float(eng.train_batch(ids, labels)))
            wall = time.perf_counter() - t0
            b9 = lowp.scaled_matmul.launches
            fl = _flash_counts()
        finally:
            set_flags({"FLAGS_lowp_matmul": "off"})
        del eng
        b9_step = HYBRID_B9_PER_STEP if on_card else 0
        _check(b9 == 4 * b9_step,
               f"hybrid gpt {mode}: {b9} B9 launches over 4 steps, want "
               f"{4 * b9_step}")
        _check(sum(rec.calls.values()) == HYBRID_B9_PER_STEP,
               f"hybrid gpt {mode}: recorded {rec.calls}")
        _check(fl == {k: 4 * per_step for k in ("B1", "B2", "B3")},
               f"hybrid gpt {mode}: flash launches {fl}")
        _check(all(np.isfinite(leg)), f"hybrid gpt {mode}: losses {leg}")
        lowp_legs[mode] = {"losses": leg, "step_ms": wall / 3 * 1e3,
                           "b9_per_step": b9 / 4}
        counts["B9"] += b9
        for k in ("B1", "B2", "B3"):
            counts[k] += fl[k]
    print(json.dumps({"phase": 48, "lowp_legs": lowp_legs,
                      "flag_off_losses": losses[:4]}), flush=True)
    model.set_state_dict(init)
    out["lowp_legs"] = lowp_legs
    del model, init
    if on_card:
        torch.cuda.empty_cache()
    return out, ref, counts, b9_calls


def _rank_main(rank, world, store, init_dir, configs, out_path, device):
    """One rank of phase 49 (a process of its own): gloo on cuda:0, each
    of `configs` from 48's initial weights for 2 steps."""
    import pickle
    import traceback

    try:
        result = (True, _rank_configs(rank, world, store, init_dir,
                                      configs, device))
    except Exception:
        result = (False, traceback.format_exc())
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def _rank_configs(rank, world, store, init_dir, configs, device):
    import numpy as np
    import torch

    from paddle_tpu_torch import optimizer, weights
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import parallel
    from paddle_tpu_torch.distributed.hybrid import make_gpt_hybrid_engine
    from paddle_tpu_torch.distributed.topology import (
        set_hybrid_communicate_group,
    )
    from paddle_tpu_torch.engine import Engine
    from paddle_tpu_torch.nlp.transformers import (
        GPTConfig, GPTForPretraining, GPTPretrainingCriterion,
    )

    parallel.init_parallel_env(backend="gloo", device=device,
                               init_method=f"file://{store}", rank=rank,
                               world_size=world)
    on_card = torch.device(device).type == "cuda"
    if not on_card:
        torch.set_num_threads(1)
    full = {p.stem: np.load(p, mmap_mode="r")
            for p in Path(init_dir).glob("*.npy")}
    ids, labels = _hybrid_batch()
    out = {}
    for name, dp, mp, pp, sh, zero, off, _rtol in configs:
        t0 = time.perf_counter()
        hcg = _fleet_init(dp, mp, pp, sh, device=device)
        cfg = GPTConfig(**HYBRID_REF)
        model = GPTForPretraining(cfg, device=device)
        weights.shard_values(full, model, hcg)
        crit = GPTPretrainingCriterion(cfg)
        opt = optimizer.SGD(HYBRID_LR, parameters=model.parameters())
        if pp > 1:
            eng = make_gpt_hybrid_engine(
                model, crit, opt, hcg, accumulate_steps=2 * pp,
                zero_stage=zero, offload=off, device=device)
            step = lambda: eng.train_batch(ids, labels)     # noqa: E731
        else:
            eng = Engine(model, opt, lambda o, y: crit(o, y),
                         device=device, seed=0, mesh=hcg.get_mesh(),
                         batch_spec=("dp",), zero_stage=zero,
                         sharding_axis="sharding" if sh > 1 else None,
                         offload=off)
            step = lambda: eng.train_batch((ids,), (labels,))  # noqa: E731
        setup_s = time.perf_counter() - t0
        _zero_flash()
        C.reset_staged_bytes()
        times, losses = [], []
        for _ in range(2):
            t1 = time.perf_counter()
            losses.append(float(step()))
            times.append(time.perf_counter() - t1)
        staged = C.staged_bytes()
        launches = _flash_counts()
        eng.sync_to_layer()
        probe = weights.gather_values(model, hcg, _hybrid_probe())
        per_step = HYBRID["num_layers"] // pp * (2 * pp if pp > 1 else 1) \
            if on_card else 0
        _check(launches == {k: 2 * per_step for k in ("B1", "B2", "B3")},
               f"{name} rank {rank}: flash launches {launches}, want "
               f"{2 * per_step} each")
        out[name] = {"losses": losses, "step_ms": [t * 1e3 for t in times],
                     "setup_s": setup_s, "launches": launches,
                     "staged_bytes_per_step": {k: v / 2 for k, v in
                                               staged.items()},
                     "peak_mem_bytes": torch.cuda.max_memory_allocated()
                     if on_card else None,
                     "probe": probe if rank == 0 else None}
        set_hybrid_communicate_group(None)
        del eng, model, opt, step
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return out


def _start_ranks(world, init_dir, configs, tmp, device, target=None,
                 tag=""):
    """Start `target` (`_rank_main` by default) on `world` processes, a
    store and result files under `tmp` named by `tag`; returns them."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    store = Path(tmp) / f"store{tag}{world}"
    procs = []
    for rank in range(world):
        p = ctx.Process(target=target or _rank_main, args=(
            rank, world, str(store), init_dir, configs,
            str(Path(tmp) / f"rank{tag}{world}_{rank}.pkl"), device))
        p.start()
        procs.append(p)
    return procs


def _join_ranks(world, procs, tmp, timeout, tag="", phase=49):
    """Wait for the processes of `_start_ranks` (killing any left after
    `timeout` s); their results by rank."""
    import pickle

    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for rank in range(world):
        path = Path(tmp) / f"rank{tag}{world}_{rank}.pkl"
        _check(path.exists(), f"phase {phase}: rank {rank} of {world} left "
               f"no result (exit {procs[rank].exitcode})")
        with open(path, "rb") as f:
            ok, value = pickle.load(f)
        _check(ok, f"phase {phase}: rank {rank} of {world} failed:\n{value}")
        results.append(value)
    return results


def phase_multirank(card, init_dir, ref, tmp, device="cuda:0"):
    """Phase 49: several ranks on the one card over gloo (NCCL refuses
    two ranks on one GPU), each rank its own process on cuda:0; one spawn
    of 2 ranks (dp2, mp2 with sequence parallelism, pp2 with 4
    micro-batches, sharding2 under ZeRO 1, 2, 3 and 3 with offload) and,
    at the same time, one of 4 (dp2.mp2, pp2.mp2 with sequence
    parallelism, mp2.sharding2.z2), at 48's width in f32 from 48's
    initial weights at attention dropout 0, 2 steps each. Against 48's
    reference pass (`ref`): each factorization's losses within the
    sweep's rtol (2e-4; 1e-3 with pp), and each `_hybrid_probe()`
    parameter's change over the steps, gathered back afterwards, within
    `HYBRID_DELTA_TOL` of the largest element of the reference's
    change, or within `HYBRID_DELTA_ULPS` float32 spacings at the
    parameter's largest magnitude; every rank's B1-B3 launches exactly
    the derived
    count (8 a step, 16 with pp2's 4 micro-batches on 4 layers). Prints
    the bytes a step each rank staged through the host (the price of
    gloo on one card, not a figure of NCCL)."""
    import numpy as np

    report = {}
    totals = {"B1": 0, "B2": 0, "B3": 0}
    # both spawns at once: their ranks wait mostly on gloo's host copies
    t0 = time.monotonic()
    procs = {world: _start_ranks(world, init_dir, configs, tmp, device)
             for world, configs in MULTIRANK.items()}
    results = {world: _join_ranks(world, ps, tmp, 600)
               for world, ps in procs.items()}
    print(json.dumps({"phase": 49, "wall_s": time.monotonic() - t0}),
          flush=True)
    for world, configs in MULTIRANK.items():
        res = results[world]
        for name, dp, mp, pp, sh, zero, off, rtol in configs:
            legs = [r[name] for r in res]
            got = legs[0]["losses"]
            for leg in legs[1:]:
                _check(leg["losses"] == got,
                       f"{name}: ranks disagree {[l['losses'] for l in legs]}")
            want_losses = ref["losses"]
            err = max(abs(a - b) / abs(b) for a, b in zip(got, want_losses))
            _check(err <= rtol, f"{name}: losses {got} vs {want_losses} "
                   f"(rel {err:.3g} > {rtol})")
            perr, ulps = {}, {}
            for k, want in ref["probe"].items():
                p0 = ref["probe0"][k]
                dw = want - p0
                off = float(np.max(np.abs(legs[0]["probe"][k] - p0 - dw)))
                perr[k] = off / max(float(np.max(np.abs(dw))), 1e-30)
                ulps[k] = off / float(np.spacing(max(
                    np.max(np.abs(p0)), np.max(np.abs(want)))))
            bad = {k: (perr[k], ulps[k]) for k in perr
                   if perr[k] > HYBRID_DELTA_TOL and
                   ulps[k] > HYBRID_DELTA_ULPS}
            _check(not bad, f"{name}: parameters changed off 48's change "
                   f"by (share of its largest element, float32 spacings) "
                   f"{bad} (> {HYBRID_DELTA_TOL}, {HYBRID_DELTA_ULPS})")
            worst = max(perr, key=perr.get)
            for leg in legs:
                for k in totals:
                    totals[k] += leg["launches"][k]
            report[name] = {
                "world": world, "losses": got, "max_rel_loss_err": err,
                "probe_delta_err": perr[worst], "probe_delta_worst": worst,
                "probe_delta_ulps": ulps[worst],
                "probe_delta_max_ulps": max(ulps.values()),
                "step_ms": [leg["step_ms"] for leg in legs],
                "setup_s": max(leg["setup_s"] for leg in legs),
                "launches_per_rank": legs[0]["launches"],
                "staged_bytes_per_step_per_rank":
                    [leg["staged_bytes_per_step"] for leg in legs],
                "peak_mem_bytes_per_rank":
                    [leg["peak_mem_bytes"] for leg in legs]}
            print(json.dumps({"phase": 49, "config": name, "card": card,
                              **report[name]}), flush=True)
    return report, totals


# -- ERNIE-1.0 pretraining across ranks (phases 50-51) -----------------------

# phase 50: ERNIE-1.0 at bench.py's settings with use_parallel, through
# make_ernie_hybrid_engine at world size 1 over NCCL (AdamW lr 1e-4 wd
# 0.01, ClipGradByGlobalNorm(1.0), dynamic loss scaling, the guard)
ERNIE50 = dict(ERNIE, use_parallel=True)
ERNIE50_BATCHES = (32, 16)      # the largest that fits
ERNIE50_LR, ERNIE50_CLIP = 1e-4, 1.0
# the dropout-0 check against the single-card Engine: 2 steps in bf16
# O1, the same kernels in the same order; the clip's global norm sums
# its squares in another order, so step 2 may move by a few bf16
# roundings of the activations
ERNIE50_CHECK_RTOL = 1e-3
# phase 51: ERNIE's widths at 2 layers, b8 x s512, f32, dropout and
# attention dropout 0.1, each leg against the same engine at world size
# 1; (vocab, hidden, layers, heads, ffn, seq, batch)
ERNIE51 = dict(vocab_size=18000, hidden_size=768, num_layers=2,
               num_heads=12, ffn_hidden_size=3072, max_seq_len=512,
               batch=8, seq=512)
ERNIE51_LR, ERNIE51_STEPS = 0.01, 2
# the features legs: SGD with a global-norm clip that binds (Adam would
# cancel a uniform clip factor), dynamic scaling that halves at one bad
# step, the guard, an inf planted on the last rank at step 2
ERNIE51_CLIP = 0.05
ERNIE51_SCALE = dict(init_loss_scaling=2.0 ** 15, decr_every_n_nan_or_inf=1,
                     incr_every_n_steps=1000)
ERNIE51_PLANT = ("ernie.encoder.0.fc1.weight", 2)
# (name, dp, mp, pp, sharding, zero stage, sequence parallel, kind):
# kind "sgd" (losses within 2e-4, 1e-3 with pp, and the probe
# parameters' changes), "features", "comm" (comm_dtype bfloat16, rtol
# 2e-2), "lowp" (int8, rtol 2e-3, B9 launches, codes bit-equal), and
# "hetero" (the sweep's GPT through PipelineEngine)
ERNIE51_LEGS = {
    2: (("dp2", 2, 1, 1, 1, 0, False, "sgd"),
        ("mp2.seqpar", 1, 2, 1, 1, 0, True, "sgd"),
        ("pp2", 1, 1, 2, 1, 0, False, "sgd"),
        ("sharding2.z2", 1, 1, 1, 2, 2, False, "sgd"),
        ("features.dp2", 2, 1, 1, 1, 0, False, "features"),
        ("features.mp2", 1, 2, 1, 1, 0, False, "features"),
        ("comm.dp2", 2, 1, 1, 1, 0, False, "comm"),
        ("lowp.mp2", 1, 2, 1, 1, 0, False, "lowp"),
        ("pp2.hetero", 1, 1, 2, 1, 0, False, "hetero")),
    4: (("dp2.sharding2.z2", 2, 1, 1, 2, 2, False, "sgd"),
        ("dp2.mp2.seqpar", 2, 2, 1, 1, 0, True, "sgd")),
}
ERNIE51_RTOL = {"sgd": 2e-4, "sgd.pp": 1e-3, "features": 2e-4,
                "comm": 2e-2, "lowp": 2e-3, "hetero": 1e-3}
# the probe parameters of the "sgd" legs (their changes against world
# size 1's, as phase 49's): the packed q / k / v, a LayerNorm whose
# gradient is summed over mp under sequence parallelism, fc2, the word
# table (tied to the MLM head) and the MLM transform's LayerNorm
ERNIE51_PROBE = ("ernie.encoder.0.self_attn.qkv_proj.weight",
                 "ernie.encoder.0.norm1.weight",
                 "ernie.encoder.1.fc2.weight",
                 "ernie.embeddings.word_embeddings.weight",
                 "cls.layer_norm.weight")
# the sweep's GPT (__graft_entry__.SWEEP_CONFIGS' model) for pp2.hetero,
# at hidden 128: its head dim 8 has no flash kernel (32 / 64 / 128), so
# 4 heads of 32
HETERO_GPT = dict(vocab_size=128, hidden_size=128, num_layers=4,
                  num_heads=4, max_seq_len=32, dropout=0.0,
                  attn_dropout=0.0, use_parallel=False)


def _ernie51_cfg(sizes, kind, dropout=0.1, sp=False):
    from paddle_tpu_torch.nlp.transformers import ErnieConfig

    keys = ("vocab_size", "hidden_size", "num_layers", "num_heads",
            "ffn_hidden_size", "max_seq_len")
    return ErnieConfig(**{k: sizes[k] for k in keys}, dropout=dropout,
                       attn_dropout=dropout, use_parallel=True,
                       sequence_parallel=sp)


def _ernie_hybrid(cfg, hcg, device, init, kind, pp=1, zero=0, **features):
    """A hybrid ERNIE engine of `init`'s weights (this rank's shards)."""
    from paddle_tpu_torch import clip, optimizer, weights
    from paddle_tpu_torch.distributed.hybrid import make_ernie_hybrid_engine
    from paddle_tpu_torch.nlp.transformers import (
        ErnieForPretraining, ErniePretrainingCriterion,
    )

    model = ErnieForPretraining(cfg, device=device)
    weights.shard_values(init, model, hcg)
    crit = ErniePretrainingCriterion(cfg)
    if kind == "adamw":
        opt = optimizer.AdamW(
            learning_rate=ERNIE50_LR, parameters=model.parameters(),
            weight_decay=0.01,
            grad_clip=clip.ClipGradByGlobalNorm(ERNIE50_CLIP))
    else:
        opt = optimizer.SGD(
            learning_rate=ERNIE51_LR, parameters=model.parameters(),
            grad_clip=clip.ClipGradByGlobalNorm(ERNIE51_CLIP)
            if kind == "features" else None)
    eng = make_ernie_hybrid_engine(
        model, crit, opt, hcg, accumulate_steps=2 * pp if pp > 1 else 1,
        zero_stage=zero, device=device, seed=0, **features)
    return model, eng


def _plant(model, rank, at_rank):
    """An inf in `ERNIE51_PLANT`'s gradient on rank `at_rank` (every rank
    when None) at its step."""
    import torch

    name, at = ERNIE51_PLANT
    p = dict(model.named_parameters())[name]
    seen = [0]

    def hook(g):
        seen[0] += 1
        if at_rank in (None, rank) and seen[0] == at:
            return torch.full_like(g, float("inf"))
        return g

    p.register_hook(hook)


def _hetero_layer(num_stages, device, values=None):
    """The sweep's GPT as the reference's heterogeneous PipelineLayer
    (``__graft_entry__._run_hetero_config``): the shared embeddings, the
    blocks, the final norm, the tied logits."""
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineLayer, SharedLayerDesc,
    )
    from paddle_tpu_torch.nlp.transformers import gpt as tgpt
    from paddle_tpu_torch.nn import functional as F

    cfg = tgpt.GPTConfig(**HETERO_GPT)
    crit = tgpt.GPTPretrainingCriterion(cfg)
    gen = torch.Generator().manual_seed(HYBRID_SEED)
    descs = [SharedLayerDesc("embed", tgpt.GPTEmbeddings, None, "weight",
                             cfg, gen)]
    descs += [tgpt.GPTDecoderLayer(cfg, gen) for _ in range(cfg.num_layers)]
    descs.append(nn.LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps))
    descs.append(SharedLayerDesc(
        "embed", tgpt.GPTEmbeddings,
        lambda base, x: F.matmul(x, base.word_embeddings.weight,
                                 transpose_y=True), "weight", cfg, gen))
    pl = PipelineLayer(descs, num_stages=num_stages,
                       loss_fn=lambda lg, lb: crit(lg, lb)).to(device)
    if values is not None:
        pl.set_state_dict(values)
    return pl


def _hetero_run(hcg, device, pp, values, steps):
    import warnings

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.pp_engine import PipelineEngine

    pl = _hetero_layer(pp, device, values)
    opt = optimizer.SGD(0.05, parameters=pl.parameters())
    eng = PipelineEngine(pl, opt, hcg, accumulate_steps=2 * pp,
                         device=device)
    ids, labels = _gpt_batch(HETERO_GPT["vocab_size"], 16, 16)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        losses = [float(eng.train_batch(ids, labels)) for _ in range(steps)]
    return {"losses": losses, "schedule": eng.schedule,
            "warnings": [str(w.message) for w in seen]}


def _ernie51_leg(name, grid, kind, sizes, init, device, rank, world,
                 hetero_init=None):
    """One leg of phase 51 (world size 1: `grid` all ones) on this
    rank: its losses and what its kind checks."""
    import numpy as np
    import torch

    from paddle_tpu_torch import engine as teng
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.distributed import sharding
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.ops import lowp

    dp, mp, pp, sh, zero, sp = grid
    hcg = _fleet_init(dp, mp, pp, sh, device=device)
    ids, labels = _ernie_batch(sizes["vocab_size"], sizes["batch"],
                               sizes["seq"], seed=1)
    out = {}
    if kind == "hetero":
        out.update(_hetero_run(hcg, device, pp, hetero_init, ERNIE51_STEPS))
        return out
    cfg = _ernie51_cfg(sizes, kind, sp=sp)
    features, flags = {}, {}
    if kind == "features":
        features = dict(loss_scale=ERNIE51_SCALE, anomaly_guard=True)
        flags = {"FLAGS_record_grad_norm": True}
    elif kind == "comm":
        features = dict(comm_dtype="bfloat16")
    elif kind == "lowp":
        flags = {"FLAGS_lowp_matmul": "int8"}
    set_flags(flags)
    reduced, real_ar = [], sharding.all_reduce

    def spy(t, *a, **k):
        reduced.append(str(t.dtype))
        return real_ar(t, *a, **k)

    try:
        model, eng = _ernie_hybrid(cfg, hcg, device, init, kind, pp, zero,
                                   **features)
        if kind == "features":
            _plant(model, rank, world - 1 if world > 1 else None)
        _zero_flash()
        lowp.scaled_matmul.launches = 0
        sharding.all_reduce = spy
        rows = []
        for _ in range(ERNIE51_STEPS + (kind == "features")):
            loss = float(eng.train_batch(ids, labels))
            row = [loss]
            if kind == "features":
                row += [float(eng.buffers[k]) for k in (
                    teng.LOSS_SCALE_KEY, teng.GOOD_STEPS_KEY,
                    teng.BAD_STEPS_KEY, teng.ANOMALY_BAD_STEPS_KEY,
                    teng.GRAD_NORM_KEY)]
            rows.append(row)
        sharding.all_reduce = real_ar
        out["rows"] = rows
        out["launches"] = dict(_flash_counts(),
                               B9=lowp.scaled_matmul.launches)
        out["comm_dtypes"] = sorted(set(reduced))
        if kind == "sgd":
            eng.sync_to_layer()
            out["probe"] = weights.gather_values(model, hcg, ERNIE51_PROBE)
        if kind == "lowp" and world > 1:
            out["codes"] = _lowp_codes(cfg, hcg, device, init)
    finally:
        sharding.all_reduce = real_ar
        set_flags({k: False if k == "FLAGS_record_grad_norm" else "off"
                   for k in flags})
    del eng, model
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def _lowp_codes(cfg, hcg, device, init):
    """Block 0's fc1 (column-parallel) and fc2 (row-parallel) at mp
    under int8 on this rank's shards of `init`, against the single
    rank's product of the whole weights on this rank: the scales B9
    took equal the whole tensors', bit for bit, and so do the int8
    codes of this rank's shards; the column-parallel output is the
    slice of the whole product, bit for bit. Returns the largest
    difference of the row-parallel output and the checks' verdicts
    (B9 launches made here for the comparison are taken back out of the
    count)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import weights
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpp
    from paddle_tpu_torch.ops import lowp

    before = lowp.scaled_matmul.launches
    h, f = cfg.hidden_size, cfg.ffn_hidden_size
    w1 = np.asarray(init["ernie.encoder.0.fc1.weight"])
    w2 = np.asarray(init["ernie.encoder.0.fc2.weight"])
    col = mpp.ColumnParallelLinear(h, f, gather_output=False,
                                   has_bias=False).to(device)
    row = mpp.RowParallelLinear(f, h, input_is_parallel=True,
                                has_bias=False).to(device)
    weights.shard_values({"weight": w1}, col, hcg)
    weights.shard_values({"weight": w2}, row, hcg)
    x = torch.randn((4, 64, h), generator=torch.Generator().manual_seed(3)
                    ).to(device)
    calls, real = [], lowp.scaled_matmul

    def rec(a, b, a_scale=None, b_scale=None, **kw):
        calls.append((a, b, a_scale, b_scale))
        return real(a, b, a_scale, b_scale, **kw)

    rec.launches = 0        # the wrapper counts on the name it calls
    lowp.scaled_matmul = rec
    try:
        with torch.no_grad():
            hc = col(x)
            y = row(hc)
    finally:
        lowp.scaled_matmul = real
    mp, r = hcg.get_model_parallel_world_size(), \
        hcg.get_model_parallel_rank()
    tw1 = torch.as_tensor(w1, device=device)
    tw2 = torch.as_tensor(w2, device=device)
    full_h = lowp.scaled_matmul(x, tw1, qdtype="int8")
    full_y = lowp.scaled_matmul(full_h, tw2, qdtype="int8")
    n, k = f // mp, f // mp
    q = lowp.quant_int8
    (ca, cb, csa, csb), (ra, rb, rsa, rsb) = calls
    checks = {
        "col_scales": bool(torch.equal(csa, lowp.amax_of(x)) and
                           torch.equal(csb, lowp.amax_of(tw1))),
        "row_scales": bool(torch.equal(rsa, lowp.amax_of(full_h)) and
                           torch.equal(rsb, lowp.amax_of(tw2))),
        "col_codes": bool(torch.equal(q(cb, csb),
                                      q(tw1, csb)[:, r * n:(r + 1) * n])),
        "row_codes": bool(torch.equal(q(ra, rsa),
                                      q(full_h, rsa)[..., r * k:(r + 1) * k])
                          and torch.equal(q(rb, rsb),
                                          q(tw2, rsb)[r * k:(r + 1) * k])),
        "col_out": bool(torch.equal(hc, full_h[..., r * n:(r + 1) * n])),
    }
    err = float((y - full_y).abs().max() / full_y.abs().max())
    lowp.scaled_matmul.launches = before
    return {"checks": checks, "row_rel_err": err}


def _ernie51_rank(rank, world, store, init_dir, legs, out_path, device):
    """One rank of phase 51 (a process of its own): gloo on `device`,
    each of `legs` = (legs, sizes, faults) for every fault of `faults`
    (None: as it is; "clip_sum": the global norm without its sums over
    the grid; "local_dropout": dropout masks at rank-local offsets, the
    planted faults of the rehearsal)."""
    import pickle
    import traceback

    try:
        result = (True, _ernie51_legs(rank, world, store, init_dir, legs,
                                      device))
    except Exception:
        result = (False, traceback.format_exc())
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def _fault(name):
    """Plant a fault of the rehearsal; returns its undo."""
    from paddle_tpu_torch.distributed import sharding
    from paddle_tpu_torch.framework import random as trandom

    if name == "clip_sum":
        real = sharding.MeshNorm.total_sq

        def local(self, sq):
            import torch

            parts = [sq[k].float() for k in sq]
            return torch.stack(parts).sum()

        sharding.MeshNorm.total_sq = local
        return lambda: setattr(sharding.MeshNorm, "total_sq", real)
    if name == "local_dropout":
        real = trandom.DropoutLayout.__init__

        def local(self, step_seed, **kw):
            real(self, step_seed, **dict(kw, row0=0, mp_rank=0))

        trandom.DropoutLayout.__init__ = local
        return lambda: setattr(trandom.DropoutLayout, "__init__", real)
    return lambda: None


def _ernie51_legs(rank, world, store, init_dir, legs, device):
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed import parallel
    from paddle_tpu_torch.distributed.topology import (
        set_hybrid_communicate_group,
    )

    legs, sizes, faults = legs
    parallel.init_parallel_env(backend="gloo", device=device,
                               init_method=f"file://{store}", rank=rank,
                               world_size=world)
    if torch.device(device).type != "cuda":
        torch.set_num_threads(1)
    init = {p.stem: np.load(p) for p in (Path(init_dir) / "ernie").glob(
        "*.npy")}
    hetero = {p.stem: torch.as_tensor(np.load(p)) for p in
              (Path(init_dir) / "hetero").glob("*.npy")}
    out = {}
    for fault in faults:
        undo = _fault(fault)
        try:
            for name, dp, mp, pp, sh, zero, sp, kind in legs:
                t0 = time.perf_counter()
                res = _ernie51_leg(name, (dp, mp, pp, sh, zero, sp), kind,
                                   sizes, init, device, rank, world, hetero)
                res["wall_s"] = time.perf_counter() - t0
                out[(fault, name)] = res
                set_hybrid_communicate_group(None)
        finally:
            undo()
    return out


def phase_ernie_hybrid(card, device="cuda:0", n=8, sizes=None, tmp=None):
    """Phase 50: ERNIE-1.0 at full width through
    `make_ernie_hybrid_engine` at world size 1 (`fleet.init` over the
    open NCCL world): vocab 18000, hidden 768, 12 layers, 12 heads, seq
    512, dropout and attention dropout 0.1, ``use_parallel=True`` (the
    fused LM-head loss off, as the reference's predicate has it), bf16
    O1, AdamW lr 1e-4 wd 0.01 with ClipGradByGlobalNorm(1.0), dynamic
    loss scaling and the anomaly guard, batch 32 (16 if 32 does not
    fit), random weights from seed 0. First the check: at dropout 0 and
    without scaling, 2 steps of this engine against the single-card
    `Engine` on the same weights (losses within `ERNIE50_CHECK_RTOL`).
    Then 2 warm-up steps and `n` timed ones (B1-B3 counted from 0 just
    before them: 12 each a step), step p50, tokens/s, peak memory, the
    guard's counter 0 and the scale finite, a profile (the device's
    idle share) and one call of the plain hidden-dropout hash at the
    block output's shape, timed with CUDA events. `sizes` shrinks the
    model for a CPU rehearsal (no launches, profile or timing there).
    Returns (report, B1-B3 launches)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp, clip, optimizer
    from paddle_tpu_torch.engine import (
        ANOMALY_BAD_STEPS_KEY, LOSS_SCALE_KEY, Engine,
    )
    from paddle_tpu_torch.framework import random as trandom
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.nlp.transformers import (
        ErnieConfig, ErnieForPretraining, ErniePretrainingCriterion,
    )
    from paddle_tpu_torch.ops import fused_ops

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    base = dict(ERNIE50, **(sizes or {}))
    batches = (sizes or {}).get("batches", ERNIE50_BATCHES)
    seq = base["max_seq_len"]
    base.pop("batches", None)
    hcg = _fleet_init(device=device)
    set_flags({"FLAGS_use_fused_lm_loss": False})
    L = base["num_layers"]

    def bf16():
        return amp.auto_cast(enable=True, dtype="bfloat16")

    # the check at dropout 0, no scaling: hybrid engine vs Engine
    cfg0 = ErnieConfig(**dict(base, dropout=0.0, attn_dropout=0.0))
    model = ErnieForPretraining(cfg0, device=device,
                                generator=torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ids, labels = _ernie_batch(base["vocab_size"], batches[-1], seq, seed=2)
    from paddle_tpu_torch.distributed.hybrid import make_ernie_hybrid_engine

    def adamw(m):
        return optimizer.AdamW(
            learning_rate=ERNIE50_LR, parameters=m.parameters(),
            weight_decay=0.01,
            grad_clip=clip.ClipGradByGlobalNorm(ERNIE50_CLIP))

    crit = ErniePretrainingCriterion(cfg0)
    eng = make_ernie_hybrid_engine(model, crit, adamw(model), hcg,
                                   device=device, seed=0)
    with bf16():
        hybrid = [float(eng.train_batch(ids, labels)) for _ in range(2)]
    del eng
    model.set_state_dict(init)
    eng = Engine(model, adamw(model), lambda out, y: crit(out[0], out[1], y),
                 device=device, seed=0)
    with bf16():
        single = [float(eng.train_batch(ids, labels)) for _ in range(2)]
    del eng, model, init
    if on_card:
        torch.cuda.empty_cache()
    check_err = max(abs(a - b) / abs(b) for a, b in zip(hybrid, single))
    _check(check_err <= ERNIE50_CHECK_RTOL,
           f"phase 50: the hybrid engine {hybrid} against the single-card "
           f"Engine {single} (rel {check_err:.3g} > {ERNIE50_CHECK_RTOL})")

    cfg = ErnieConfig(**base)
    out = None
    for batch in batches:
        model = ErnieForPretraining(
            cfg, device=device, generator=torch.Generator().manual_seed(0))
        eng = make_ernie_hybrid_engine(
            model, ErniePretrainingCriterion(cfg), adamw(model), hcg,
            device=device, seed=0, loss_scale="dynamic", anomaly_guard=True)
        ids, labels = _ernie_batch(base["vocab_size"], batch, seq)
        try:
            with bf16():
                losses = [float(eng.train_batch(ids, labels))
                          for _ in range(2)]
            break
        except torch.cuda.OutOfMemoryError:
            del eng, model
            torch.cuda.empty_cache()
            if batch == batches[-1]:
                raise
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _zero_flash()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        with bf16():
            loss = eng.train_batch(ids, labels)
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = _flash_counts()
    per_step = L if on_card else 0
    _check(launches == {k: per_step * n for k in ("B1", "B2", "B3")},
           f"phase 50: launches over {n} steps {launches}, want {per_step} "
           "each a step")
    _check(all(np.isfinite(losses)), f"phase 50: losses {losses}")
    bad = int(eng.buffers[ANOMALY_BAD_STEPS_KEY])
    scale = float(eng.buffers[LOSS_SCALE_KEY])
    _check(bad == 0 and np.isfinite(scale),
           f"phase 50: guard counter {bad}, scale {scale}")
    step_s = float(np.median(times))
    rep = {"phase": 50, "card": card,
           "train": f"ernie-1.0 use_parallel hybrid world 1 b{batch} "
           f"s{seq} bf16 O1, dropout 0.1, AdamW + global-norm clip 1.0, "
           "dynamic scaling, anomaly guard",
           "batch": batch, "steps": n, "step_ms_p50": step_s * 1e3,
           "step_ms_p90": float(np.percentile(times, 90)) * 1e3,
           "tokens_per_s": batch * seq / step_s,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()
           if on_card else None,
           "losses": losses, "loss_scale": scale, "guard_bad_steps": bad,
           "launches_per_step": {k: c / n for k, c in launches.items()},
           "check_hybrid_losses": hybrid, "check_engine_losses": single,
           "check_max_rel_err": check_err}
    total = dict(launches)
    if on_card:
        def step():
            with bf16():
                return eng.train_batch(ids, labels)

        _zero_flash()
        prof = phase_train_profile(step, "ernie-1.0 hybrid world 1 (b"
                                   f"{batch} s{seq} bf16, use_parallel)")
        for k, c in _flash_counts().items():
            total[k] += c
        rep["device_busy_ms"] = prof["busy_ms"]
        rep["device_idle_share"] = max(0.0, 1.0 - prof["busy_ms"] /
                                       (step_s * 1e3))
        # the plain hidden-dropout hash at a block output's shape
        x = torch.empty((batch, seq, base["hidden_size"]), device=device)
        lay = trandom.DropoutLayout(torch.tensor(7, device=device),
                                    seq_len=seq)
        thresh = fused_ops._thresh(0.1)
        for _ in range(3):
            lay.hidden_keep(x, thresh)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(10):
            lay.hidden_keep(x, thresh)
        e1.record()
        sync()
        rep["hidden_dropout_hash_ms"] = e0.elapsed_time(e1) / 10
        rep["hidden_dropout_sites_per_step"] = 1 + 2 * L
    if tmp is not None:
        # phase 53 (b): the hybrid checkpoint of this engine, before it
        # is freed
        def make():
            m = ErnieForPretraining(
                cfg, device=device,
                generator=torch.Generator().manual_seed(1))
            return make_ernie_hybrid_engine(
                m, ErniePretrainingCriterion(cfg), adamw(m), hcg,
                device=device, seed=0, loss_scale="dynamic",
                anomaly_guard=True)

        rep["hybrid_ckpt_53"] = phase_hybrid_ckpt(eng, make, ids, labels,
                                                  tmp, bf16, on_card)
    print(json.dumps(rep), flush=True)
    del eng, model
    if on_card:
        torch.cuda.empty_cache()
    set_flags({"FLAGS_use_fused_lm_loss": True})
    return rep, total


def phase_ernie_multirank(card, tmp, device="cuda:0", sizes=None,
                          faults=(None,)):
    """Phase 51: ERNIE's factorizations on 2 and 4 gloo ranks on the one
    card (one process a rank on `device`, both spawns at once), at
    ERNIE's widths with 2 layers (`ERNIE51`, b8 x s512, f32), dropout
    and attention dropout 0.1, each leg of `ERNIE51_LEGS` against the
    same engine at world size 1 from the same weights, run here first:
    dp2, mp2 with sequence parallelism, pp2 (4 micro-batches),
    sharding2 under ZeRO 2, dp2 x sharding2 under ZeRO 2 and dp2 x mp2
    with sequence parallelism (SGD: losses within 2e-4, 1e-3 with pp,
    and the `ERNIE51_PROBE` parameters' changes as phase 49's); at dp2
    and mp2 the global-norm clip, dynamic scaling with an inf planted in
    the last rank's gradient only at step 2 and the guard (every rank
    skips that step: the scale, its counters, the guard's counter and
    the recorded global norm equal world size 1's, where the same inf
    lands on the one rank); comm_dtype bfloat16 at dp2 (losses within
    2e-2, the dp reduction in bfloat16); FLAGS_lowp_matmul int8 at mp2
    (losses within 2e-3, exactly 4 L + 3 B9 launches a step on each
    rank, and block 0's column- and row-parallel products with scales
    and codes bit-equal to one rank's); and the sweep's pp2.hetero
    through `PipelineEngine` (its GPT at hidden 128, `HETERO_GPT`; the
    "hetero" schedule, no warning, losses within 1e-3 of the
    accumulation schedule at world size 1). Every
    rank's B1-B3 launches are the derived count. With `faults` the ranks
    also run every leg under each planted fault (`_fault`) and the
    checks of each fault's legs run in turn: a CPU rehearsal shows that
    they catch it. Returns (report, B1-B3 / B9 launches, {fault:
    failure or None})."""
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed.topology import (
        set_hybrid_communicate_group,
    )

    sizes = dict(ERNIE51, **(sizes or {}))
    on_card = torch.device(device).type == "cuda"
    init_dir = Path(tmp) / "init51"
    (init_dir / "ernie").mkdir(parents=True)
    (init_dir / "hetero").mkdir()
    model_cfg = _ernie51_cfg(sizes, "sgd")
    from paddle_tpu_torch.nlp.transformers import ErnieForPretraining

    init = ErnieForPretraining(model_cfg, device="cpu",
                               generator=torch.Generator().manual_seed(11))
    init = {k: v.detach().numpy() for k, v in init.state_dict().items()}
    for k, v in init.items():
        np.save(init_dir / "ernie" / f"{k}.npy", v)
    hetero = _hetero_layer(1, "cpu").state_dict()
    for k, v in hetero.items():
        np.save(init_dir / "hetero" / f"{k}.npy", v.detach().numpy())
    hetero = {k: v.detach() for k, v in hetero.items()}
    # world size 1: each kind once, here
    kinds = {}
    for legs in ERNIE51_LEGS.values():
        for leg in legs:
            kinds.setdefault((leg[-1], leg[6]), leg)
    refs = {}
    for (kind, sp), leg in kinds.items():
        res = _ernie51_leg("w1", (1, 1, 1, 1, 0, sp), kind, sizes, init,
                           device, 0, 1, hetero)
        res["probe_init"] = {k: init[k] for k in ERNIE51_PROBE}
        refs[(kind, sp)] = res
        set_hybrid_communicate_group(None)
    t0 = time.monotonic()
    procs = {world: _start_ranks(world, str(init_dir), (legs, sizes,
                                                       tuple(faults)),
                                 tmp, device, target=_ernie51_rank,
                                 tag="e")
             for world, legs in ERNIE51_LEGS.items()}
    results = {world: _join_ranks(world, ps, tmp, 900, tag="e", phase=51)
               for world, ps in procs.items()}
    wall = time.monotonic() - t0
    verdicts, report, totals = {}, {}, {"B1": 0, "B2": 0, "B3": 0, "B9": 0}
    for fault in faults:
        try:
            rep = _check_ernie51(results, refs, fault, sizes, on_card)
            verdicts[fault] = None
        except RuntimeError as e:
            if fault is None:
                raise
            verdicts[fault] = str(e)
            continue
        if fault is None:
            report = rep
            for world, res in results.items():
                for r in res:
                    for (f, name), leg in r.items():
                        if f is None and "launches" in leg:
                            for k in totals:
                                totals[k] += leg["launches"][k]
    print(json.dumps({"phase": 51, "card": card, "wall_s": wall,
                      "legs": report}), flush=True)
    return report, totals, verdicts


def _probe_errs(got, want, init):
    """Phase 49's rule on each probe parameter's change: (the ones off
    by more than `HYBRID_DELTA_TOL` of the change's largest element and
    more than `HYBRID_DELTA_ULPS` spacings, the worst (name, share,
    spacings))."""
    import numpy as np

    bad, worst = {}, (None, 0.0, 0.0)
    for k, w in want.items():
        p0 = np.asarray(init[k])
        off = float(np.max(np.abs(np.asarray(got[k]) - p0 - (w - p0))))
        share = off / max(float(np.max(np.abs(w - p0))), 1e-30)
        ulps = off / float(np.spacing(max(np.max(np.abs(p0)),
                                          np.max(np.abs(w)))))
        if share > HYBRID_DELTA_TOL and ulps > HYBRID_DELTA_ULPS:
            bad[k] = (share, ulps)
        if share >= worst[1]:
            worst = (k, share, ulps)
    return bad, worst


def _check_ernie51(results, refs, fault, sizes, on_card):
    """Phase 51's checks of the legs run under `fault`; raises on the
    first that fails. Returns the report of each leg."""
    import numpy as np

    report = {}
    L = sizes["num_layers"]
    for world, legs in ERNIE51_LEGS.items():
        res = results[world]
        for name, dp, mp, pp, sh, zero, sp, kind in legs:
            runs = [r[(fault, name)] for r in res]
            ref = refs[(kind, sp)]
            key = "losses" if kind == "hetero" else "rows"
            got = runs[0][key]
            for run in runs[1:]:
                _check(repr(run[key]) == repr(got),
                       f"{name}: ranks disagree {[r[key] for r in runs]}")
            want = ref[key]
            if kind == "hetero":
                _check(runs[0]["schedule"] == "hetero" and
                       not runs[0]["warnings"],
                       f"{name}: schedule {runs[0]['schedule']}, warnings "
                       f"{runs[0]['warnings']}")
                got_l, want_l = got, want
            else:
                got_l = [row[0] for row in got]
                want_l = [row[0] for row in want]
            rtol = ERNIE51_RTOL["sgd.pp" if kind == "sgd" and pp > 1
                                else kind]
            err = max(0.0 if (np.isnan(a) and np.isnan(b)) else
                      abs(a - b) / abs(b) for a, b in zip(got_l, want_l))
            _check(err <= rtol, f"{name}: losses {got_l} vs world size 1 "
                   f"{want_l} (rel {err:.3g} > {rtol})")
            rep = {"world": world, "losses": got_l, "max_rel_loss_err": err,
                   "wall_s": max(r["wall_s"] for r in runs)}
            if kind == "features":
                g, w = np.asarray(got), np.asarray(want)
                _check(np.array_equal(g[:, 1:5], w[:, 1:5]),
                       f"{name}: scale / counters {g[:, 1:5].tolist()} vs "
                       f"{w[:, 1:5].tolist()}")
                _check(g[1, 1] == w[0, 1] / 2 and g[1, 4] == 1,
                       f"{name}: step 2 was not skipped: {g.tolist()}")
                ok = np.isfinite(w[:, 5])
                nerr = float(np.max(np.abs(g[ok, 5] - w[ok, 5]) / w[ok, 5]))
                _check(nerr <= 1e-4, f"{name}: global norms {g[:, 5]} vs "
                       f"{w[:, 5]} (rel {nerr:.3g})")
                rep["grad_norm_rel_err"] = nerr
                rep["scale_trajectory"] = g[:, 1].tolist()
            if kind == "comm":
                _check("torch.bfloat16" in runs[0]["comm_dtypes"],
                       f"{name}: dp reduction dtypes "
                       f"{runs[0]['comm_dtypes']}")
            if kind == "sgd":
                bad, worst = _probe_errs(runs[0]["probe"], ref["probe"],
                                         ref["probe_init"])
                _check(not bad, f"{name}: parameters changed off world size "
                       "1's change by (share of its largest element, "
                       f"float32 spacings) {bad} (> {HYBRID_DELTA_TOL}, "
                       f"{HYBRID_DELTA_ULPS})")
                rep["probe_delta_worst"] = worst
            if on_card and kind != "hetero":
                micro = 2 * pp if pp > 1 else 1
                steps = len(got)
                per = {k: steps * (L // pp) * micro
                       for k in ("B1", "B2", "B3")}
                for run in runs:
                    _check({k: run["launches"][k] for k in per} == per,
                           f"{name}: flash launches {run['launches']}, "
                           f"want {per}")
                if kind == "lowp":
                    b9 = steps * (4 * L + 3)
                    _check(all(r["launches"]["B9"] == b9 for r in runs),
                           f"{name}: B9 launches "
                           f"{[r['launches']['B9'] for r in runs]}, want "
                           f"{b9}")
            if kind == "lowp":
                for run in runs:
                    _check(all(run["codes"]["checks"].values()),
                           f"{name}: int8 scales / codes off the single "
                           f"rank's: {run['codes']['checks']}")
                rep["row_parallel_rel_err"] = max(
                    r["codes"]["row_rel_err"] for r in runs)
            rep["launches_per_rank"] = runs[0].get("launches")
            report[name] = rep
    return report


# -- resilience across ranks (phases 52-53) ----------------------------------

# phase 52: ERNIE's widths at 2 layers (ERNIE51), b8 x s512 over dp2
GANG52_STEPS = 6
GANG52_SEED = 21            # the weights, the same on every rank
# rank 0 leaves a collective whose peer died within this (its typed
# error); the commit barrier waits on the slower rank's save, so it has
# a deadline of its own
GANG52_DEADLINE_S = 10.0
GANG52_BARRIER_S = 120.0
# rank 1's death on its first attempt: inside step 5's gradient
# all-reduce (after step 4 was committed) ...
GANG52_KILL = "dist.allreduce[grads]@5:crash"
# ... or, for the rehearsal's "newest local step" fault, before the
# rename of its step-6 checkpoint (rank 0 then holds a local step 6 that
# the gang never committed)
GANG52_COMMIT_KILL = "checkpoint.before_commit@3:crash"
# phase 53 (a): step 5 at world size 1 from 52's step-4 checkpoint
# against 52's step 5 (dp2): bf16 O1 forwards of b8 against two b4
# halves, the same kernels; cuBLAS may pick other bf16 GEMMs at the two
# row counts and the loss sums its rows in another order (phase 50's
# rule for a few bf16 roundings)
GANG53_RTOL = 1e-3
GANG53_BAD = 3              # FLAGS_anomaly_max_bad_steps of 53 (c)


def _gang_batch(sizes, step):
    """Step `step`'s global batch of phases 52-53."""
    return _ernie_batch(sizes["vocab_size"], sizes["batch"], sizes["seq"],
                        seed=100 + step)


def _gang_engine(cfg, hcg, device, weights_seed, mesh, loss_fn, **kw):
    """Phase 52's engine: `Engine(mesh=)` with AdamW (lr 1e-4, wd 0.01),
    the global-norm clip 1.0, dynamic loss scaling and the guard."""
    import torch

    from paddle_tpu_torch import clip, optimizer
    from paddle_tpu_torch.engine import Engine
    from paddle_tpu_torch.nlp.transformers import ErnieForPretraining

    model = ErnieForPretraining(
        cfg, device=device,
        generator=torch.Generator().manual_seed(weights_seed))
    opt = optimizer.AdamW(learning_rate=ERNIE50_LR,
                          parameters=model.parameters(), weight_decay=0.01,
                          grad_clip=clip.ClipGradByGlobalNorm(ERNIE50_CLIP))
    return Engine(model, opt, loss_fn, device=device, seed=0, mesh=mesh,
                  batch_spec=("dp",), loss_scale="dynamic",
                  anomaly_guard=True, **kw)


def _gang_plant(name, mgr, ckpt):
    """A planted fault of the rehearsal in a rank of phase 52:
    "newest_local" restores this rank's newest local step instead of the
    newest globally committed one; "skip_rng" restores everything but
    the engine's RngState."""
    if name == "newest_local":
        def restore(engine):
            step = mgr.local.latest_step()
            ckpt.load_train_state(mgr.local._path(step), engine)
            return step

        mgr.latest_committed_step = mgr.local.latest_step
        mgr.restore_engine = restore
    elif name == "skip_rng":
        real = ckpt.load_train_state

        def load(path, engine):
            keep = engine.rng.state_dict()
            real(path, engine)
            engine.rng.set_state_dict(keep)
            return engine

        ckpt.load_train_state = load


def _gang_rank_main():
    """One rank of phase 52, started by the gang supervisor (this script
    with ``--gang-rank``; the launcher's env contract and GANG_* below).
    Writes ``rank<r>.a<attempt>.json`` (its steps, commits, restore,
    launches, gang stats) after every step, ``losses.r<r>.log`` and, on
    a typed collective error, ``typed.r<r>.log`` (then exits 13)."""
    import os

    env = os.environ
    rank = int(env["PADDLE_TRAINER_ID"])
    attempt = int(env.get("PADDLE_GANG_ATTEMPT", "1"))
    if rank == 1 and attempt == 1 and env.get("GANG_KILL_FAULTS"):
        env["PADDLE_TPU_FAULTS"] = env["GANG_KILL_FAULTS"]
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.distributed import gang

    out = Path(env["GANG_OUT"])
    res = {"rank": rank, "attempt": attempt, "steps": [], "commits": []}
    t_step = [None]
    try:
        _gang_rank(rank, attempt, out, res, t_step)
    except (gang.CollectiveTimeoutError, gang.PeerGoneError) as e:
        took = time.perf_counter() - t_step[0] if t_step[0] else None
        with open(out / f"typed.r{rank}.log", "a") as f:
            f.write(json.dumps({"error": type(e).__name__,
                                "retriable": e.retriable,
                                "step_s": took, "message": str(e)[:400]})
                    + "\n")
        os._exit(13)
    # leave at once: the gloo world needs no teardown after the last step
    os._exit(0)


def _gang_rank(rank, attempt, out, res, t_step):
    import os

    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import checkpoint as ckpt, gang
    from paddle_tpu_torch.distributed.parallel import init_parallel_env
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.nlp.transformers import ErniePretrainingCriterion

    env = os.environ
    device = env.get("GANG_DEVICE", "cuda:0")
    sizes = json.loads(env["GANG_SIZES"])
    steps = int(env["GANG_STEPS"])
    on_card = torch.device(device).type == "cuda"
    if not on_card:
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    penv = init_parallel_env(backend="gloo", device=device)
    world = penv.world_size
    worker = gang.GangWorker()
    hcg = _fleet_init(dp=world, device=device)
    cfg = _ernie51_cfg(sizes, "adamw")
    crit = ErniePretrainingCriterion(cfg)
    eng = _gang_engine(cfg, hcg, device, GANG52_SEED, hcg.get_mesh(),
                       lambda o, y: crit(o[0], o[1], y), zero_stage=2,
                       sharding_axis="dp")
    mgr = ckpt.GangCheckpointManager(out / "ckpt", rank, world,
                                     barrier_timeout_s=GANG52_BARRIER_S)
    if env.get("GANG_PLANT"):
        _gang_plant(env["GANG_PLANT"], mgr, ckpt)
    res["setup_s"] = time.perf_counter() - t0
    if mgr.latest_committed_step() is not None:
        t1 = time.perf_counter()
        res["restored"] = mgr.restore_engine(eng)
        res["restore_s"] = time.perf_counter() - t1
    path = out / f"rank{rank}.a{attempt}.json"
    _zero_flash()
    lossf = open(out / f"losses.r{rank}.log", "a")
    while eng.state.step < steps:
        step = eng.state.step + 1
        worker.beat(step=step)
        ids, labels = _gang_batch(sizes, step)
        t_step[0] = time.perf_counter()
        with amp.auto_cast(enable=True, dtype="bfloat16"):
            loss = float(eng.train_batch((ids,), (labels,)))
        ms = (time.perf_counter() - t_step[0]) * 1e3
        lossf.write(f"{step} {loss.hex()}\n")
        lossf.flush()
        res["steps"].append({"step": step, "loss": loss.hex(), "ms": ms})
        if step % 2 == 0:
            t1 = time.perf_counter()
            mgr.save_engine(step, eng)
            res["commits"].append({"step": step, "ms": (
                time.perf_counter() - t1) * 1e3})
        res["launches"] = _flash_counts()
        res["stats"] = {k: monitor.stat_get(f"gang.{k}") for k in (
            "commits", "restores", "heartbeats", "collective_timeouts",
            "peer_gone")}
        path.write_text(json.dumps(res))
    if attempt > 1 and on_card:
        # a restarted rank's kernels against their plain versions at its
        # step's shape (dp slice, ERNIE's heads, seq 512, bf16, dropout
        # 0.1 at its global rows); these launches are not the path's
        rows = sizes["batch"] // world
        heads = sizes["num_heads"]
        d = sizes["hidden_size"] // heads
        gen = torch.Generator().manual_seed(52 + rank)
        q, k, v = _packed_qkv(rows, heads, sizes["seq"], d, torch.bfloat16,
                              gen)
        do = torch.randn((rows, sizes["seq"], heads, d), generator=gen).to(
            torch.bfloat16).cuda().transpose(1, 2)
        seed = torch.tensor(52, device=device)
        got, want = _flash_vs_plain(q, k, v, do, False, 0.1, seed,
                                    (rank * rows, 0, heads))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=2e-2, atol=2e-2)
        e = [(g - w).abs().max().item() for g, w in zip(got, want)]
        res["kernel_check_max_abs_err"] = {"B1": e[0], "B2": e[1],
                                           "B3": max(e[2], e[3])}
        path.write_text(json.dumps(res))
    lossf.close()


def _gang_results(out):
    """{(rank, attempt): result} of a leg's ranks."""
    got = {}
    for p in Path(out).glob("rank*.a*.json"):
        r = json.loads(p.read_text())
        got[(r["rank"], r["attempt"])] = r
    return got


def _gang_losses(out, rank=0):
    """{step: loss hex} of `rank` (the last execution of a step wins)."""
    got = {}
    p = Path(out) / f"losses.r{rank}.log"
    if p.exists():
        for line in p.read_text().split("\n"):
            if line.strip():
                step, val = line.split()
                got[int(step)] = val
    return got


def _check_gang_leg(name, leg, clean, layers, on_card, killed):
    """Phase 52's checks of one leg (`leg`: its code, snapshot, results,
    losses); raises on the first that fails."""
    _check(leg["code"] == 0, f"{name}: the gang exited {leg['code']}: "
           f"{leg['stderr'][-1500:]}")
    for rank in (0, 1):
        got = _gang_losses(leg["out"], rank)
        _check(got == clean[rank], f"{name}: rank {rank}'s losses "
               f"{got} differ from the clean leg's {clean[rank]}")
    res = leg["results"]
    for (rank, attempt), r in res.items():
        # 2 of each a step a rank (the steps it finished: its results
        # are written after each one)
        want = {k: layers * len(r["steps"]) if on_card else 0
                for k in ("B1", "B2", "B3")}
        _check(r["launches"] == want, f"{name}: rank {rank} attempt "
               f"{attempt} launches {r['launches']}, want {want}")
    if not killed:
        _check(leg["snapshot"]["restarts"] == 0,
               f"{name}: restarts {leg['snapshot']}")
        return
    snap = leg["snapshot"]
    _check(snap["restarts"] == 1 and snap["generation"] == 2,
           f"{name}: snapshot {snap}, want 1 restart and generation 2")
    typed = leg["typed"]
    _check(typed and typed[0]["error"] in ("PeerGoneError",
                                           "CollectiveTimeoutError")
           and typed[0]["retriable"]
           and typed[0]["step_s"] <= GANG52_DEADLINE_S,
           f"{name}: rank 0's error {typed} (want a typed retriable error "
           f"within {GANG52_DEADLINE_S} s)")
    for rank in (0, 1):
        r1, r2 = res.get((rank, 1)), res.get((rank, 2))
        _check(r1 is not None and r2 is not None,
               f"{name}: rank {rank} ran attempts {sorted(res)}")
        _check(r2.get("restored") == 4 and [s["step"] for s in r2["steps"]]
               == [5, 6], f"{name}: rank {rank} restored "
               f"{r2.get('restored')} and ran {[s['step'] for s in r2['steps']]}")
        _check(r1["stats"]["commits"] == 2 and r2["stats"]["commits"] == 1
               and r2["stats"]["restores"] == 1,
               f"{name}: rank {rank}'s gang stats {r1['stats']} / "
               f"{r2['stats']}")
        if on_card:
            _check("kernel_check_max_abs_err" in r2,
                   f"{name}: rank {rank}'s restarted kernels unchecked")


def phase_gang(card, tmp, device="cuda:0", sizes=None, plants=()):
    """Phase 52 (see the module docstring): the clean and the kill leg,
    and with `plants` a leg under each planted fault (`_gang_plant`;
    "newest_local" with `GANG52_COMMIT_KILL`), all gangs at once through
    the launcher's supervisor in this process. `sizes` shrinks the model
    for a CPU rehearsal (no launches or kernel checks there). Returns
    (report, B1-B3 launches, {plant: failure or None}, the clean leg's
    output directory)."""
    import os
    import threading

    import torch

    from paddle_tpu_torch.distributed import launch
    from paddle_tpu_torch.framework import monitor

    sizes = dict(ERNIE51, **(sizes or {}))
    on_card = torch.device(device).type == "cuda"
    legs = {"clean": {}, "kill": {"GANG_KILL_FAULTS": GANG52_KILL}}
    for plant in plants:
        legs[f"kill.{plant}"] = {
            "GANG_PLANT": plant, "GANG_KILL_FAULTS": GANG52_COMMIT_KILL
            if plant == "newest_local" else GANG52_KILL}
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("PADDLE_", "FLAGS_"))}
    lost0 = monitor.stat_get("gang.restart_lost_ms")
    runs, threads = {}, []
    t0 = time.monotonic()
    for name, extra in legs.items():
        out = Path(tmp) / f"gang52_{name}"
        out.mkdir(parents=True)
        env = dict(base, GANG_OUT=str(out), GANG_STEPS=str(GANG52_STEPS),
                   GANG_DEVICE=device, GANG_SIZES=json.dumps(sizes),
                   FLAGS_dist_timeout_s=str(GANG52_DEADLINE_S), **extra)
        args = launch.parse_args([
            "--nproc_per_node", "2", "--elastic_retries", "1",
            "--gang_dir", str(out / "gang"), "--log_dir", str(out / "logs"),
            "--poll_interval", "0.1", str(ROOT / "chip_smoke.py"),
            "--gang-rank"])
        sup = launch._supervisor(args, base_env=env)
        sup.stderr = open(out / "supervisor.log", "w")
        run = runs[name] = {"out": out, "sup": sup, "code": None}
        sup._spawn_all()

        def go(run=run):
            run["code"] = run["sup"].run()
            run["wall_s"] = time.monotonic() - t0

        threads.append(threading.Thread(target=go, daemon=True))
        threads[-1].start()
    for t in threads:
        t.join(max(600 - (time.monotonic() - t0), 1))
    wall = time.monotonic() - t0
    for run in runs.values():
        if run["code"] is None:
            run["sup"].terminate()
            run["code"] = "timed out"
        run["sup"].stderr.close()
        run["stderr"] = (run["out"] / "supervisor.log").read_text()
        run["snapshot"] = run["sup"].snapshot()
        run["results"] = _gang_results(run["out"])
        typed = run["out"] / "typed.r0.log"
        run["typed"] = [json.loads(x) for x in typed.read_text().split(
            "\n") if x.strip()] if typed.exists() else []
    layers = sizes["num_layers"]
    clean = {r: _gang_losses(runs["clean"]["out"], r) for r in (0, 1)}
    _check(sorted(clean[0]) == list(range(1, GANG52_STEPS + 1)) and
           clean[0] == clean[1], f"phase 52: the clean leg's losses "
           f"{clean} ({runs['clean']['stderr'][-1500:]})")
    _check_gang_leg("phase 52 clean", runs["clean"], clean, layers, on_card,
                    False)
    _check_gang_leg("phase 52 kill", runs["kill"], clean, layers, on_card,
                    True)
    verdicts = {}
    for plant in plants:
        try:
            _check_gang_leg(f"phase 52 {plant}", runs[f"kill.{plant}"],
                            clean, layers, on_card, True)
            verdicts[plant] = None
        except RuntimeError as e:
            verdicts[plant] = str(e)
    totals = {"B1": 0, "B2": 0, "B3": 0}
    for name in ("clean", "kill"):
        for r in runs[name]["results"].values():
            for k in totals:
                totals[k] += r.get("launches", {}).get(k, 0)
    kill = runs["kill"]["results"]
    rep = {"phase": 52, "card": card, "wall_s": wall,
           "train": f"ernie-1.0 {layers} layers hidden "
           f"{sizes['hidden_size']} b{sizes['batch']} s{sizes['seq']} dp2 "
           "gloo ranks on one card, Engine(mesh=) ZeRO 2 over dp, bf16 O1, "
           "dropout 0.1, AdamW + global-norm clip, dynamic scaling, guard",
           "legs_wall_s": {n: r.get("wall_s") for n, r in runs.items()},
           "kill_snapshot": {k: runs["kill"]["snapshot"][k] for k in (
               "generation", "restarts", "world")},
           "restart_lost_ms": monitor.stat_get("gang.restart_lost_ms")
           - lost0,
           "rank0_typed_error": runs["kill"]["typed"][:1],
           "losses": [float.fromhex(clean[0][s]) for s in sorted(clean[0])],
           "step_ms": {f"rank{r}.a{a}": [s["ms"] for s in v["steps"]]
                       for (r, a), v in sorted(kill.items())},
           "commit_ms": {f"rank{r}.a{a}": [c["ms"] for c in v["commits"]]
                         for (r, a), v in sorted(kill.items())},
           "restore_s": {f"rank{r}": kill[(r, 2)].get("restore_s")
                         for r in (0, 1) if (r, 2) in kill},
           "setup_s": {f"rank{r}.a{a}": v["setup_s"]
                       for (r, a), v in sorted(kill.items())},
           "restarted_kernel_check": {
               f"rank{r}": kill[(r, 2)].get("kernel_check_max_abs_err")
               for r in (0, 1) if (r, 2) in kill},
           "launches": totals}
    print(json.dumps(rep), flush=True)
    return rep, totals, verdicts, runs["clean"]["out"]


def phase_reshard_rollback(card, clean_out, clean_losses, tmp,
                           device="cuda:0", sizes=None):
    """Phase 53 (a) and (c) in this process (NCCL at world size 1, or
    the rehearsal's gloo world of one): 52's clean step-4 checkpoint
    (rank 0's, written at dp2 with ZeRO 2) restored into `Engine(mesh=)`
    at world size 1 from other weights; step 5 against 52's
    (`GANG53_RTOL`), step 6; then back to step 4 from a checkpoint of
    this engine, `GANG53_BAD` NaN steps (the ``train.batch`` nan action
    on the batch's per-row loss weights) roll it back, and the replayed
    steps 5-6 equal the clean ones bit for bit. Returns (report, B1-B3
    launches)."""
    import warnings

    import numpy as np
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.engine import ANOMALY_BAD_STEPS_KEY
    from paddle_tpu_torch.framework import faults
    from paddle_tpu_torch.framework.flags import get_flags, set_flags
    from paddle_tpu_torch.nlp.transformers import ErniePretrainingCriterion

    sizes = dict(ERNIE51, **(sizes or {}))
    on_card = torch.device(device).type == "cuda"
    hcg = _fleet_init(device=device)
    cfg = _ernie51_cfg(sizes, "adamw")
    crit = ErniePretrainingCriterion(cfg)
    # a loss weight a row (ones: the loss itself), the float leaf the
    # nan action poisons
    eng = _gang_engine(cfg, hcg, device, GANG52_SEED + 1, hcg,
                       lambda o, y, w: crit(o[0], o[1], y) * w.mean())

    def step(n):
        ids, labels = _gang_batch(sizes, n)
        w = np.ones(len(ids), np.float32)
        with amp.auto_cast(enable=True, dtype="bfloat16"):
            return float(eng.train_batch((ids,), (labels, w)))

    t0 = time.perf_counter()
    ckpt.load_train_state(Path(clean_out) / "ckpt" / "rank-0" / "ckpt-4",
                          eng)
    restore_s = time.perf_counter() - t0
    mgr = ckpt.CheckpointManager(Path(tmp) / "rollback53")
    mgr.save_engine(4, eng)
    _zero_flash()
    clean = [step(5), step(6)]
    want5 = float.fromhex(clean_losses[5])
    rel = abs(clean[0] - want5) / abs(want5)
    _check(eng.state.step == 6 and rel <= GANG53_RTOL,
           f"phase 53 (a): step 5 at world size 1 from 52's dp2 ZeRO-2 "
           f"checkpoint {clean[0]} vs 52's {want5} (rel {rel:.3g} > "
           f"{GANG53_RTOL})")
    mgr.restore_with(lambda p: ckpt.load_train_state(p, eng))
    eng.attach_checkpoint_manager(mgr)
    prev = get_flags(["FLAGS_anomaly_max_bad_steps",
                      "FLAGS_anomaly_check_interval"])
    set_flags({"FLAGS_anomaly_max_bad_steps": GANG53_BAD,
               "FLAGS_anomaly_check_interval": 1})
    try:
        with warnings.catch_warnings(record=True) as seen, \
                faults.inject(f"train.batch@1-{GANG53_BAD}:nan"):
            warnings.simplefilter("always")
            bad = [step(5 + i) for i in range(GANG53_BAD)]
        rolled = [str(w.message) for w in seen
                  if "anomaly guard" in str(w.message)]
        _check(all(np.isnan(bad)) and eng.state.step == 4 and
               int(eng.state.buffers[ANOMALY_BAD_STEPS_KEY]) == 0 and
               len(rolled) == 1,
               f"phase 53 (c): bad losses {bad}, engine step "
               f"{eng.state.step}, warnings {rolled}")
        replay = [step(5), step(6)]
    finally:
        set_flags(prev)
    _check(replay == clean, f"phase 53 (c): the replay {replay} after the "
           f"rollback differs from the clean steps {clean}")
    launches = _flash_counts()
    per = sizes["num_layers"] * (4 + GANG53_BAD) if on_card else 0
    _check(launches == {k: per for k in ("B1", "B2", "B3")},
           f"phase 53: launches {launches}, want {per} each")
    rep = {"phase": 53, "card": card,
           "reshard": {"from": "dp2 ZeRO 2 (52's step 4)",
                       "to": "Engine(mesh=) world size 1",
                       "restore_s": restore_s, "step5": clean[0],
                       "step5_dp2": want5, "rel_err": rel},
           "rollback": {"bad_losses": bad, "warning": rolled[0],
                        "clean": clean, "replay": replay},
           "launches": launches}
    print(json.dumps(rep), flush=True)
    del eng
    if on_card:
        torch.cuda.empty_cache()
    return rep, launches


def phase_hybrid_ckpt(eng, make, ids, labels, tmp, bf16, on_card):
    """Phase 53 (b), inside 50: `save_hybrid_state` of 50's hybrid
    engine, its next step, then a fresh engine (`make()`: other weights)
    restored with `load_hybrid_state` takes that step bit for bit. The
    save's and the load's wall time (synchronised) and bytes. Returns
    the report (with the two steps' B1-B3 launches)."""
    import torch

    from paddle_tpu_torch.distributed import checkpoint as ckpt

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    path = Path(tmp) / "hybrid53"
    sync()
    t0 = time.perf_counter()
    ckpt.save_hybrid_state(path, eng)
    save_s = time.perf_counter() - t0
    _zero_flash()
    with bf16():
        nxt = float(eng.train_batch(ids, labels))
    fresh = make()
    sync()
    t0 = time.perf_counter()
    ckpt.load_hybrid_state(path, fresh)
    sync()
    load_s = time.perf_counter() - t0
    with bf16():
        resumed = float(fresh.train_batch(ids, labels))
    _check(resumed == nxt, f"phase 53 (b): the restored hybrid engine's "
           f"step {resumed} != the original's {nxt}")
    rep = {"save_s": save_s, "load_s": load_s,
           "bytes": _dir_bytes(path), "next_loss": nxt,
           "resumed_loss": resumed, "launches": _flash_counts()}
    shutil.rmtree(path, ignore_errors=True)
    del fresh
    return rep


def main():
    if sys.argv[1:2] == ["--gang-rank"]:
        return _gang_rank_main()      # a rank of phase 52's gang
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not (ROOT / "paddle_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(paddle_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.ops import _build

    t_start = time.monotonic()
    card = _card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.monotonic()
    logs = _build.build_all()
    print(json.dumps({"build_s": time.monotonic() - t0}), flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{src}: {line.strip()}", flush=True)

    def timed(label, fn, *args, **kwargs):
        t0 = time.monotonic()
        out = fn(*args, **kwargs)
        print(json.dumps({f"phase_{label}_s": time.monotonic() - t0}),
              flush=True)
        return out

    rows = timed("kernels", phase_kernels, name)
    timed("slice", phase_slice)
    launches, model, ref = timed("full_width", phase_full_width)
    timed("profile", phase_profile, model)
    for key in ("B7", "B8"):
        rows[key]["launches"] = sum(leg[key] for leg in launches.values())

    # serving features on the same gpt2-small (phases 24-27), batch
    # mode over ERNIE-1.0 classification (28)
    extra = {"B7": {}, "B8": {}}
    extra["B7"]["bf16_pool"] = timed("bf16_pool", phase_bf16_pool, model,
                                     ref)
    spec = timed("spec", phase_spec, model, ref)
    for key in ("B7", "B8"):
        extra[key]["spec"] = spec[key]
    head = timed("verify_head", phase_verify_head, name)
    extra["B7"]["lora"] = timed("lora", phase_lora, model, ref)
    spill_dir = tempfile.mkdtemp(prefix="chip_smoke_spill_")
    try:
        extra["B7"]["spill_migrate"] = timed(
            "spill_migrate", phase_spill_migrate, model, spill_dir)
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)
    for key in ("B7", "B8"):
        rows[key]["launches"] += sum(extra[key].values())
        rows[key]["serving_feature_launches"] = extra[key]
        rows[key]["ms_32_rows"] = head[f"{key.lower()}_ms_32"]
    # the serving fleet on the same gpt2-small (phases 29-32)
    fleet = timed("fleet_29_32", phase_fleet_all, model, card)
    for key in ("B7", "B8"):
        rows[key]["launches"] += sum(fleet[key].values())
        rows[key]["fleet_launches"] = fleet[key]
    del model
    torch.cuda.empty_cache()
    b1_batch = timed("batch", phase_batch, name)
    torch.cuda.empty_cache()
    rows.update(timed("flash", phase_flash, name))
    rows.update(timed("fused_loss", phase_fused_loss, name))

    # the training path at the reference's default: the fused LM-head
    # loss on (B4-B6), then the unfused and recompute legs beside it
    set_flags({"FLAGS_use_fused_lm_loss": True})
    timed("train_slice", phase_train_slice)
    fused_leg, eng, step = timed("train_full", phase_train_full, name, True)
    prof = timed("train_profile", phase_train_profile, step,
                 "ernie-1.0 train step (b32 s512 bf16, fused loss)")
    fused_leg["device_busy_ms"] = prof["busy_ms"]
    # phase 33: the same step's device time by bucket, attribute_step
    timed("train_attribute", phase_attribute, eng,
          "ernie-1.0 train step (b32 s512 bf16, fused loss)", prof,
          {"B1": ERNIE["num_layers"], "B2": ERNIE["num_layers"],
           "B3": ERNIE["num_layers"], "B4": 1, "B5-B6": 2})
    for key in ("B1", "B2", "B3", "B4", "B5", "B6"):
        rows[key]["launches"] = int(fused_leg["launches_per_step"][key] *
                                    fused_leg["steps"])
    rows["B1"]["launches"] += b1_batch
    rows["B1"]["batch_mode_launches"] = b1_batch
    del eng, step
    torch.cuda.empty_cache()
    plain_leg, eng, step = timed("train_unfused", phase_train_full, name,
                                 False)
    plain_leg["device_busy_ms"] = timed(
        "train_unfused_profile", phase_train_profile, step,
        "ernie-1.0 train step (b32 s512 bf16, unfused)")["busy_ms"]
    del eng, step
    torch.cuda.empty_cache()
    _check(fused_leg["peak_mem_bytes"] < plain_leg["peak_mem_bytes"],
           "the fused LM-head loss did not lower the peak memory")
    print(json.dumps({"fused_vs_unfused": {
        k: [fused_leg[k], plain_leg[k]] for k in (
            "step_ms_p50", "step_ms_p90", "tokens_per_s", "mfu",
            "peak_mem_bytes", "device_busy_ms")}}), flush=True)
    remat_leg, eng, step = timed("train_recompute", phase_train_full, name,
                                 True, 3, True, 0)
    del eng, step
    torch.cuda.empty_cache()
    want = fused_leg["losses"][:3]
    _check(all(abs(a - b) <= 1e-5 * abs(b)
               for a, b in zip(remat_leg["losses"], want)),
           f"recompute changed the losses: {remat_leg['losses']} vs {want}")
    print(json.dumps({"recompute_vs_plain": {
        "losses": [round(v, 5) for v in remat_leg["losses"]],
        "plain_losses": [round(v, 5) for v in want],
        "peak_mem_bytes": [remat_leg["peak_mem_bytes"],
                           fused_leg["peak_mem_bytes"]]}}), flush=True)

    # low-precision training on B9: the tiny model against the CPU, the
    # int8 and fp8 legs at full width beside the fused flag-off leg
    # (bench.py --lowp's gate: every loss within rtol 0.2), B9 against its
    # plain version at the calls the int8 leg recorded, then a flag-off
    # leg that must repeat the fused leg's first losses
    timed("lowp_slice", phase_lowp_slice)
    lowp_legs = {}
    for mode in ("int8", "fp8"):
        leg, eng, step = timed(f"train_{mode}", phase_train_full, name, True,
                               lowp=mode, record=mode == "int8")
        if mode == "int8":
            leg["device_busy_ms"] = timed(
                "train_int8_profile", phase_train_profile, step,
                "ernie-1.0 train step (b32 s512 bf16, lowp int8)")["busy_ms"]
        del eng, step
        torch.cuda.empty_cache()
        dev = max(abs(a - b) / abs(b)
                  for a, b in zip(leg["losses"], fused_leg["losses"]))
        _check(dev <= 0.2, f"{mode} losses {leg['losses']} beyond rtol 0.2 "
               f"of the flag-off {fused_leg['losses']}")
        leg["max_rel_dev_vs_flag_off"] = dev
        lowp_legs[mode] = leg
    print(json.dumps({"lowp_vs_fused": {
        k: [lowp_legs["int8"].get(k), lowp_legs["fp8"].get(k),
            fused_leg.get(k)]
        for k in ("step_ms_p50", "step_ms_p90", "tokens_per_s", "mfu",
                  "peak_mem_bytes", "device_busy_ms",
                  "max_rel_dev_vs_flag_off")}}), flush=True)
    rows["B9"] = timed("lowp_kernels", phase_lowp_kernels, name,
                       lowp_legs["int8"].pop("b9_calls"))
    for mode, key in (("int8", "launches"), ("fp8", "fp8_launches")):
        leg = lowp_legs[mode]
        rows["B9"][key] = int(leg["launches_per_step"]["B9"] * leg["steps"])
    off_leg, eng, step = timed("train_flag_off_again", phase_train_full,
                               name, True, 1, False, 2)
    del eng, step
    torch.cuda.empty_cache()
    want = fused_leg["losses"][:3]
    _check(all(abs(a - b) <= 1e-5 * abs(b)
               for a, b in zip(off_leg["losses"], want)),
           f"flag off after the lowp legs: {off_leg['losses']} vs {want}")
    print(json.dumps({"flag_off_after_lowp": {
        "losses": off_leg["losses"], "fused_losses": want,
        "bitwise": off_leg["losses"] == want}}), flush=True)

    # ResNet-50 training as bench.py runs it, on B10
    rows["B10"] = timed("conv", phase_conv, name)
    timed("resnet_slice", phase_resnet_slice)
    resnet_leg, eng, model, step, per_fwd = timed("resnet_full",
                                                  phase_resnet_full, name)
    rows["B10"]["launches"] = int(resnet_leg["b10_launches_per_step"] *
                                  resnet_leg["steps"])
    prof = timed("resnet_profile", phase_train_profile, step,
                 "resnet-50 train step (b128 224 s2d bf16, Momentum)")
    resnet_leg["device_busy_ms"] = prof["busy_ms"]
    # phase 34: the same step by bucket
    timed("resnet_attribute", phase_attribute, eng,
          "resnet-50 train step (b128 224 s2d bf16, Momentum)", prof,
          {"B10": resnet_leg["derived_per_step"]})
    del eng, step
    torch.cuda.empty_cache()
    timed("resnet_eval", phase_resnet_eval, model, per_fwd)
    del model
    torch.cuda.empty_cache()

    # checkpointing on the training paths: ERNIE resumed after a
    # simulated preemption (B1-B6), ResNet-50 rolled back by the guard
    # (B10)
    resume, rollback = timed("checkpoint", phase_checkpoint, fused_leg,
                             resnet_leg)
    for key, n in resume["launches"].items():
        rows[key]["ckpt_leg_launches"] = n
    rows["B10"]["ckpt_leg_launches"] = rollback["b10_launches"]
    # GPT-2 small training: the engine, recompute, the optimizers, the
    # eager loop and hapi (phases 37-40)
    gpt_launches = timed("gpt_train", phase_gpt_all, card)
    for key in ("B1", "B2", "B3"):
        rows[key]["gpt_train_launches"] = {
            phase: leg[key] for phase, leg in gpt_launches.items()}
        rows[key]["launches"] += sum(leg[key] for leg in
                                     gpt_launches.values())
    # Transformer-base from the nn layers: training, cached decoding and
    # the nn sweep (phases 41-43)
    tb_launches = timed("transformer_base", phase_transformer_base, card)
    for key in ("B1", "B2", "B3"):
        rows[key]["transformer_base_launches"] = {
            phase: leg.get(key, 0) for phase, leg in tb_launches.items()}
        rows[key]["launches"] += sum(leg.get(key, 0) for leg in
                                     tb_launches.values())
    # mixed precision complete (phases 44-46): ERNIE-1.0 under
    # comm_dtype bf16 and f16 O1 with dynamic scaling, GPT-2 small under
    # hapi O2 and the eager f16 O2 loop with the GradScaler, ResNet-50 in
    # f16 O1 and a decorated bf16 O2 eval
    ernie_amp, _ = timed("ernie_amp_44", phase_ernie_amp, card)
    gpt_amp, _ = timed("gpt_amp_45", phase_gpt_amp, card)
    resnet_amp, _ = timed("resnet_amp_46", phase_resnet_amp, card)
    for key in ("B1", "B2", "B3", "B4", "B5", "B6"):
        legs = {f"ernie_44_{leg}": c[key] for leg, c in ernie_amp.items()
                if c[key]}
        if key in ("B1", "B2", "B3"):
            legs.update({f"gpt_45_{leg}": c[key]
                         for leg, c in gpt_amp.items()})
        rows[key]["amp_launches"] = legs
        rows[key]["launches"] += sum(legs.values())
    rows["B9"]["amp_launches"] = {
        "ernie_44_fp16_o1_lowp_int8": ernie_amp["fp16_o1_lowp_int8"]["B9"]}
    rows["B9"]["launches"] += ernie_amp["fp16_o1_lowp_int8"]["B9"]
    rows["B10"]["amp_launches"] = {"resnet_46": resnet_amp}
    rows["B10"]["launches"] += resnet_amp
    # distributed training (phases 47-49): the collectives over NCCL at
    # world size 1, the hybrid GPT at world size 1 (flag off, int8, fp8),
    # then 2 and 4 gloo ranks on this card against 48's trajectory
    dist_tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        timed("collectives_47", phase_collectives, card,
              str(Path(dist_tmp) / "store1"))
        init_dir = Path(dist_tmp) / "init"
        init_dir.mkdir()
        hybrid, ref, hybrid_counts, hybrid_b9 = timed(
            "hybrid_gpt_48", phase_hybrid_gpt, card, str(init_dir))
        rows["B9"]["hybrid_48_fp8_max_abs_err"] = timed(
            "hybrid_b9_48", phase_hybrid_b9, hybrid_b9)
        _, multirank = timed("multirank_49", phase_multirank, card,
                             str(init_dir), ref, dist_tmp)
        # ERNIE-1.0 pretraining across ranks (phases 50-51): the hybrid
        # ERNIE at full width at world size 1 with every step feature,
        # then its factorizations on 2 and 4 gloo ranks at 2 layers
        rep50, ernie50 = timed("ernie_hybrid_50", phase_ernie_hybrid,
                               card, tmp=dist_tmp)
        _, ernie51, _ = timed("ernie_multirank_51", phase_ernie_multirank,
                              card, dist_tmp)
        # resilience across ranks (phases 52-53): the gang surviving a
        # planted rank death, then the resharded restore and the meshed
        # guard's rollback here (53 (b) ran inside 50)
        _, gang52, _, clean_out = timed("gang_52", phase_gang, card,
                                        dist_tmp)
        _, reshard53 = timed("reshard_rollback_53", phase_reshard_rollback,
                             card, clean_out, _gang_losses(clean_out),
                             dist_tmp)
    finally:
        # the NCCL world first: its watchdog reads the store in dist_tmp
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(dist_tmp, ignore_errors=True)
    for key in ("B1", "B2", "B3", "B9"):
        rows[key]["hybrid_48_launches"] = hybrid_counts[key]
        rows[key]["launches"] += hybrid_counts[key]
    for key in ("B1", "B2", "B3"):
        rows[key]["multirank_49_launches"] = multirank[key]
        rows[key]["launches"] += multirank[key]
        rows[key]["ernie_hybrid_50_launches"] = ernie50[key]
        rows[key]["launches"] += ernie50[key]
    for key in ("B1", "B2", "B3", "B9"):
        rows[key]["ernie_multirank_51_launches"] = ernie51[key]
        rows[key]["launches"] += ernie51[key]
    hybrid53 = rep50["hybrid_ckpt_53"]["launches"]
    for key in ("B1", "B2", "B3"):
        rows[key]["gang_52_launches"] = gang52[key]
        rows[key]["phase_53_launches"] = reshard53[key] + hybrid53[key]
        rows[key]["launches"] += gang52[key] + reshard53[key] + \
            hybrid53[key]
    for key, row in rows.items():
        _check(row["launches"] > 0, f"{key} never ran on the path")
    print(json.dumps({"total_s": time.monotonic() - t_start}), flush=True)
    print(card)
    print(json.dumps({"kernels": [rows[k] for k in sorted(rows)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
