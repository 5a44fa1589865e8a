#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port.  Phases, in order:

  * ``build``: the conv (K1: FMA, sm90 bf16, sm90 3xTF32), wgrad (K2:
    FMA, sm90 bf16, sm90 3xTF32), the im2col staging kernel (K1 and
    K2), matmul (K3:
    FMA, sm90 bf16 and sm90 3xTF32) and attention (K4: FMA, sm90 bf16
    and sm90 3xTF32) kernels from the sources in this checkout, one nvcc
    each, all started together; ptxas registers, spills and shared
    memory;
  * ``check``, ``check_bwd``: K1 (f32 and bf16, each row with the
    route it took and its tile; also in its dgrad geometries, and at
    7x7 and 11x11 windows) and K2 (x and dy f32 and bf16, each row with
    the route it took and its plan) against their plain PyTorch
    versions; wrong results of K1's and K2's sm90 kernels (the halo
    read one row off) shown to fail the bf16 gate and ``WGRAD_TOL``,
    of K1's 3xTF32 kernel (the same fault) to fail ``TOL``, and K1's
    3xTF32 kernel without its lo terms to err at least 4x more than
    the route,
    of K1's im2col plane (one tap one column off) to fail the bf16 gate,
    of K2's im2col plane (one tap one column off) to fail ``WGRAD_TOL``
    by over 10x, and K2's 3xTF32 kernel without its lo terms (1xTF32)
    to err at least 4x more than the route; at a stride (ResNet-20/32's
    s2b0_a, f32) K1's forward, its dgrad by output phases and K2 on
    ``sm90_tf32``, with a halo read at stride 1 (K1, K2) and the
    fullest phase's taps one column off (the dgrad) shown to fail the
    gate and 1xTF32 to err at least 4x the route;
    one bf16 backward through K1 and K2 (both on sm90) against the
    plain autograd; the two
    backwards the kernels do not take (lhs-dilated, padding past full)
    against the plain autograd, with the library-rung tally;
  * ``check_matmul``, ``check_attention``: K3 and K4 through
    ``matmul_lb`` / ``flash_attention`` at every shape and type of the
    reference's sweeps (K3 also with a K-major ``w`` and at a ragged
    and a long-K shape, each row with the route it took, f32 on
    ``sm90_tf32`` where TMA describes the operands; K4 on every
    route that takes each case (f32 ``sm90_tf32`` and ``fma``, bf16
    ``sm90`` and ``fma``), also at head dims 20, 80, 96, 256, 320
    and 512, two long cases, the LM path's decode shapes: one query
    row against 1, 37 and 128 keys, and whisper-medium's encoder (1500
    x 1500, non-causal) and cross-decode (1 x 1500) shapes, and
    minitron-4b's training shapes, 24 heads over 8 at 8 x 128 and
    1 x 4096) and a fully
    masked row case, against their plain versions (``CARD_TOL``;
    deliberately wrong results, a dropped key tile and a bf16 output
    accumulator among them, are shown to fail the same gate; at
    whisper's shapes so is the plain attention with the reference's
    zero pad keys, 1500 keys padded to two 1024-key chunks), one launch
    per call;
  * ``vgg``, ``serve_bf16_vgg``, ``resnet``: VGG16/224 (full width, f32
    and bf16) and ResNet-20/32 served through
    ``repro_torch.serve.ImageServer``, every conv on K1, its launches by
    route exact (VGG: 12 convs a dispatch on the sm90 kernel in bf16 and
    the 3xTF32 kernel in f32, conv1_1 on ``sm90_im2col``: the plane,
    then that kernel as a 1x1 conv; ResNet: its 16 stride-1 and 4
    strided convs on the 3xTF32 kernel, the stem on the plane, none on
    FMA);
  * ``serve_loop``: VGG16/224 f32 through the fault-tolerant
    ``repro_torch.serve.ServingLoop``: on a virtual clock the reference
    benchmark's bursty trace, plain and under ``FaultPlan.random`` for
    two seeds, each rid's terminal state and attempts equal to the
    port's account-only run of the same schedule on the CPU; on the real
    clock ``run_sync`` and ``run_async(max_inflight=2)`` under injected
    failures, the breaker tripping to account-only and recovering; in
    every run 13 K1 launches a computed dispatch and none a degraded
    one, degraded results without logits, no library rung, computed
    logits within ``TOL`` of the plain forward (``serve_loop_summary``:
    goodput, shed fraction, latency, dispatch ms, retries, trips);
  * ``train_vgg``, ``train_resnet``: a few SGD steps with the backward
    on K1 (recompute, dgrad) and K2 (wgrad), K1's and K2's launches per
    route exact (f32 VGG: conv1_1 on ``sm90_im2col``, the 12 after it on
    ``sm90_tf32``, forward, recompute and dgrad; f32 ResNet: 60
    ``sm90_tf32`` and 2 ``sm90_im2col`` a step, the strided dgrads one
    launch each, none on FMA);
  * ``trace``: the traced path (``repro_torch.obs``): VGG16/224 at
    bucket 8 through ``ImageServer`` under an active tracer, three f32
    dispatches of the ``vgg`` phase's payload and one bf16, each conv a
    ``graph.layer`` span holding one ``kernel.conv2d_lb`` span with the
    port's ``plan_conv`` bytes and the card's time between CUDA events
    (``trace_layers``: per layer route, bytes, ``us``, ``device_us``,
    ``device_gbps``), the f32 logits bit for bit the untraced ones and
    K1's launches the untraced ones; one traced f32 SGD step (the loss
    and the K1/K2 launches of an untraced ``train_vgg`` step); and
    ``launch/serve_images.py --trace`` under ``random:7`` faults, its
    Perfetto file reconciled with its metrics;
  * ``matmul``, ``attention``: the two entry points at full width
    (phi3-medium-14b's projections at 4096 tokens, bf16 on the sm90
    kernel, f32 on the 3xTF32 kernel, and wq also with a K-major ``w``
    in both types, the 1xTF32 control (lo words dropped) shown to fail
    the f32 gate and err 4x more, the FMA kernel timed on the f32
    inputs through its own launcher; phi3-medium-14b's and
    mixtral-8x7b's attention, bf16 on the sm90 kernel, f32 on the
    3xTF32 kernel, each f32 call giving the same bits on a second
    launch, its 1xTF32 control erring 4x more and its transposers
    reading V one key off failing the f32 gate, the FMA kernel timed
    and gated on the f32 inputs through ``via="fma"``), f32 and bf16,
    held against the plain versions and timed beside their bounds, the
    host's enqueue and a library call;
  * ``lm_serve``, ``lm_attention``, ``lm_serve_f32``: phi3-medium-14b
    at full width and depth in bf16 served through
    ``repro_torch.launch.serve.BatchedServer`` (6 requests, 4 slots, 16
    new tokens, max_seq 128; weights drawn on the card, cast once):
    every request completes, 40 K4 launches a decode step on ``sm90``
    and no other kernel of K1-K4, no plain attention (patched to
    raise); each step replayed from a clone of its caches: every K4 call
    within ``CARD_TOL`` of the plain version on its own inputs, the
    logits within 2e-2 of max |plain| of the plain attention's, the
    decode gather without the newest slot shown to fail that gate; every layer's K4
    output on a 4096-token prefill and the decode step after it within
    ``CARD_TOL``; step and prefill times, tokens/s, peak memory, one
    step's enqueue, wall and profiled device time; K4 alone at the
    decode and prefill shapes beside its bound and SDPA; then 4 layers
    in f32 (``sm90_tf32``): the served logits, decode against prefill
    and a window-64 ring's wrap within ``TOL``;
  * ``lm_serve_moe``, ``lm_serve_moe_f32``: mixtral-8x7b at full width
    (8 experts, top-2, capacity factor 1.25, window 4096) and 20 of its
    32 blocks in bf16 through ``BatchedServer`` at the same defaults:
    every request completes, 20 K4 ``sm90`` launches a decode step and
    nothing else of K1-K4, no plain attention; each step replayed under
    the served routing (the MoE layers' choices recorded in the served
    step; the replay's own flips counted): every K4 call of every step
    within ``CARD_TOL`` of the plain version on its own inputs, the
    logits within 2e-2 of max |plain| of the plain replay's, the gather
    control failing that gate; the pairs the capacity dropped per
    step; every layer's K4 on an
    8192-token prefill (a 4096-slot ring) and the decode step after it
    within ``CARD_TOL``; step, prefill and tokens/s, one step's device
    time beside the byte bound of the weights it reads, peak memory; K4
    alone at mixtral's decode shape and its windowed 8192-token
    prefill; then 4 blocks in f32 as ``lm_serve_f32`` does;
  * ``lm_serve_ssm``: mamba2-1.3b at full width and depth in bf16
    through ``BatchedServer`` (no K1-K4 launch: attention-free), each
    served step replayed layer by layer, teacher-forced, in f32 from the
    same bf16-rounded weights and an f32 clone of its caches (each
    layer's output within ``LM_BF16_TOL`` of max |f32| and each mixer's
    own output within ``SSM_MIXER_TOL``, its state and conv tail handed
    to the next step bit for bit; the control, the SSM state reset to
    zero, must fail both; the whole f32 step's logits reported beside
    it), step time, tokens/s, peak; in f32 decode against a 600-token
    prefill (two 256-row chunks and a padded third) within ``TOL``;
  * ``lm_serve_hybrid``: jamba-1.5-large-398b at ``reduced()`` size in
    f32 (one full-width block is 88.1 GB): one K4 ``sm90_tf32`` launch
    a decode step, the served logits (under the served routing) and
    decode against prefill within ``TOL``;
  * ``lm_serve_encdec``: whisper-medium at full width and depth (24
    encoder and 24 decoder layers) in bf16 through ``BatchedServer``
    as the reference's server serves it (decode only, from
    ``init_cache``): every request completes, 48 K4 ``sm90`` launches a
    step (24 self, 24 cross over 1500 zero slots) and nothing else of
    K1-K4, each step replayed as ``lm_serve`` does, the gather control;
    the audio path (``lm_serve_encdec_audio``: 4 x 1500 frames and an
    8-token prompt through ``prefill``, 72 K4 launches, then 16 greedy
    decode steps) in bf16 and f32, the logits within 2e-2 (bf16) and
    ``TOL`` (f32) of the plain replay, every K4 call within
    ``CARD_TOL``, in f32 decode against prefill; encode, prefill and
    step times; K4 alone at whisper's encoder, cross-prefill and
    cross-decode shapes;
  * ``lm_serve_dense``, ``lm_serve_mqa``, ``lm_serve_dbrx``,
    ``lm_serve_vlm`` (each with its ``_f32`` row): deepseek-7b and
    minitron-4b at full size, granite-34b (48 query heads on one kv
    head) at 60 of its 88 layers, dbrx-132b (16 experts, top-4,
    capacity factor 1.25) at 9 of its 40 blocks and llava-next-34b at
    full size (text only) in bf16 through ``BatchedServer`` as
    ``lm_serve`` serves phi3, the logits gated at :func:`lm_bf16_tol`
    (2e-2, 3e-2 at 60 layers), dbrx under the served routing with its
    dropped pairs and flips; each config at 4 layers (dbrx 2 blocks) in
    f32; then llava's vision path (``lm_serve_vlm_prefix``): a prefill
    of 2 x 2944 tokens whose first 2880 positions are prefix embeddings
    and 16 decode steps at about 2.9k keys, each held to its plain
    replay and every K4 call to ``CARD_TOL``, the prefill without its
    prefix failing the gate;
  * ``lm_attention`` long rows, ``lm_long_dense``, ``lm_long_window``
    (each with its ``_f32`` row): the reference's long shapes
    (``prefill_32k``, ``decode_32k``, ``long_500k``).  K4 alone at
    phi3-medium-14b's 1 x 32768 causal prefill and 2 x 1 x 32768-key
    decode and mixtral-8x7b's windowed prefills of 1 x 32768 and
    1 x 524288 (q of 2^31 elements; bf16 only), each held to the plain
    version on fixed query panels (the first, middle and last 128 rows
    of every head) and timed beside its bound and SDPA (none at 524288:
    its window would be a 275 GB mask); then phi3 at full size over two
    32768-token prompts and 16 greedy decode steps over its 32784-slot
    cache, and mixtral at 20 of 32 blocks over one 32768-token prompt
    that fills its 4096-slot ring 8 times over and 16 steps: every K4
    call of the prefill within ``CARD_TOL`` on its panels and every
    decode call whole, the prefill and the steps repeating bit for bit,
    the logits within :func:`lm_bf16_tol` of the plain replay (a
    step's in f32), the controls (the causal mask one row off, the
    gather without the newest slot, ``cur_pos`` one off, mixtral's
    window one key wider) missing their gates; prefill and step times,
    tokens/s, peak memory, one profiled step; each at 4 layers in f32;
  * ``lm_train``: minitron-4b at full width and 24 of its 32 blocks,
    bf16 on f32 masters, trained through ``launch/train.py``'s
    ``make_trainer`` step in a plain loop at the reference driver's
    defaults (batch 8 x 128, 20 steps, peak lr 3e-4, warmup 2): at
    step 0 every K4 call (forward and recompute) within ``CARD_TOL`` of
    the plain version on its own inputs, and every gradient tensor
    within ``LM_TRAIN_GRAD_TOL`` of a plain replay's (``attn="plain"``),
    which a backward with its mask one key off and an attention with
    no gradient must each miss, and every ``attention_vjp`` call within
    ``TOL`` of autograd in f32; 48 K4 ``sm90`` launches a step (the
    forward and the remat recompute) and nothing else of K1-K4, no
    plain attention; step 0's loss and global gradient norm within 2e-2
    relative of the replay; finite every step; params unchanged by
    step 0 (lr 0) and changed by step 1; a 1 x 4096 step twice, and its
    K4 calls held as at step 0 (:func:`long_step_gate`); step ms,
    tokens/s, peak memory, one
    profiled step per shape (wall, device busy and idle share of that
    step, time by part: K4 forward, the attention backward, cuBLAS,
    AdamW) beside the step's FLOP and byte bounds;
  * ``lm_train_f32``: step 0 in f32 (K4 ``sm90_tf32``) of minitron-4b
    at 2 blocks, whisper-medium at 2 + 2 layers (K4 non-causal over
    1500 frames) and mixtral-8x7b at 2 blocks over 1 x 8192 tokens
    under its 4096 window (the replay under the K4 forward's expert
    choices) against the plain replay: the loss within ``TOL``, every
    gradient tensor within ``GRAD_TOL`` of its max; the control, a
    backward whose causal mask keeps key q + 1, must miss that gate;
    at mixtral each ``attention_vjp`` call within ``TOL`` of autograd,
    and a backward window one key wider must miss both gates;
    llava-next-34b at 2 layers over one batch of
    its prefix path and granite-34b at 2 layers, 8 x 128, the same;
  * ``lm_train_resilient``: ``examples/train_100m.py``'s 75.5M-parameter
    config in bf16 (batch 8 x 256, peak lr 1e-3), 30 steps through
    ``run_resilient`` with an asynchronous checkpoint every 10, clean
    and with a failure injected before step 15 (restored from step 10
    and replayed): the final params and moments equal bit for bit, the
    replayed losses equal, the loss falling; step and save times;
  * ``lm_train_moe``: mixtral-8x7b at full width and 2 of its 32
    blocks (3.03e9 parameters, 48.5 GB of state), bf16, trained as
    ``lm_train`` is: step 0's gradients within ``LM_TRAIN_GRAD_TOL`` of
    the plain replay under the K4 forward's expert choices (every
    router call of the forward and the remat recompute on them), each
    K4 call within ``CARD_TOL``, the two controls missing;
    ``value_and_grad`` repeated bit for bit; 4 K4 ``sm90`` launches a
    step; the pairs the 1.25 capacity dropped; a 1 x 8192 step twice,
    where the window bites: each ``attention_vjp`` call within ``TOL``
    of autograd, a backward window one key wider missing that gate
    (its distance from the right gradients, under the bf16 gate,
    printed);
  * ``lm_train_ssm``: mamba2-1.3b at full size in bf16, the same loop
    (finite, no launch of K1-K4), a 1 x 4096 step (16 SSD chunks), the
    bf16 loss beside an f32 replay's; then 2 layers at full width over
    1 x 1024 tokens in f32 on the card against the same step on the
    host's CPU (loss ``TOL``, gradients ``GRAD_TOL``), the scan with
    its carry between chunks dropped missing;
  * ``lm_train_hybrid``: jamba at ``reduced()`` in f32: step 0 against
    the plain replay under the K4 forward's routing (loss ``TOL``,
    gradients ``GRAD_TOL``, K4 ``sm90_tf32`` at ``CARD_TOL``, the
    one-key-off control missing), 20 steps at 2 K4 launches a step and
    a 1 x 1024 step across SSD chunks; each phase with step ms, tokens/s,
    peak memory, a profiled step by part and its bound;
  * ``lm_train_vlm``, ``lm_train_mqa``, ``lm_train_dbrx``,
    ``lm_train_dense``: the other decoder configs at full width, the
    depth cut, trained as ``lm_train_moe`` is (step 0 against the plain
    replay with its controls, ``2 x layers`` K4 ``sm90`` launches a
    step, step ms, tokens/s, peak memory, a profiled step): llava-next-
    34b at 5 of 60 layers through its vision prefix (2 x (2880 prefix
    embeddings + 64 tokens), the loss over the text; the step without
    its prefix and dk, dv summed into the wrong kv head must miss the
    gradient gate, and the one-key-off backward, which moves a step's
    gradients too little to miss it at 2944 keys, the gate of each
    ``attention_vjp`` call against autograd; 10 steps); granite-34b at
    5 of 88 (48 query heads on one kv head; dk, dv of one query head of
    the group must miss; 20 steps of 8 x 128, then 1 x 4096 twice, the
    long step's K4 calls held); dbrx-132b at 1 of 40 blocks
    (16 experts, top-4, under the K4 forward's routing, its dropped
    pairs; 20 steps); deepseek-7b at 14 of 30 and phi3-medium-14b at 8
    of 40 (5 steps each);
  * ``lm_train_mesh``: ``lm_train``'s 20 steps again through
    ``make_trainer(cfg, mesh, ...)`` on a one-rank NCCL group's (1, 1)
    mesh (the sharded step: FSDP gathers, tensor-parallel boundaries,
    vocab-parallel loss, gradient sync and the global norm across
    shards, every one on an axis of size 1): each step's loss and grad
    norm and every param's fingerprint after step 20 equal
    ``lm_train``'s bit for bit, 48 K4 ``sm90`` launches a step, no
    collective counted; step ms beside ``lm_train``'s;
  * ``lm_train_mesh_resilient``: ``lm_train_resilient``'s failed run on
    that mesh, its checkpoints sharded (whole leaves, rank 0 writing),
    ``on_restart`` building a fresh mesh from ``plan_remesh(1, 1, 8)``
    and resharding the restored state onto it: the final state and the
    step-10 checkpoint equal the clean mesh-free run's bit for bit;
  * ``mesh_attention``: K4's log-sum-exp output at the sharded decode's
    shapes (phi3's 4 x 40 heads over 10 and mixtral's 4 x 32 over 8,
    hd 128, one query against 4096 slots) on ``sm90`` (bf16),
    ``sm90_tf32`` (f32) and ``fma`` (``via="fma"``, both types): ``out``
    the same bits with and without ``lse``, ``lse`` within ``CARD_TOL``
    of the plain version's, the cache cut into 4 slot shards merged by
    ``combine_partials`` within ``CARD_TOL`` of K4 over the whole cache
    and of the plain version, an ``lse`` shifted by ln 2 and a dropped
    shard failing that gate, an empty shard moving nothing; K4 ``sm90``
    at phi3's decode shape timed with and without ``lse`` beside its
    bound and SDPA;
  * ``lm_serve_mesh``: phi3-medium-14b at full width and 40 layers in
    bf16 through ``BatchedServer(cfg, mesh)`` on a one-rank NCCL
    group's (1, 1) mesh, on the weights of a mesh-free server: tokens
    and logits equal to the mesh-free server's bit for bit, 40 K4
    ``sm90`` launches a step with their log-sum-exp, the collectives
    counted by op; then ``build(cfg, tp=4)`` without a mesh at full
    width (heads padded to 40 over 20): a prefill of 8 tokens and 16
    decode steps replayed against the plain attention within
    ``LM_BF16_TOL``, ``drop_newest_slot`` failing it; peak memory;
  * ``mesh_ssm``: the Mamba mixer's shards on a model axis of 4, 8 and
    16, emulated in one process at full width (mamba2-1.3b's mixer and
    one of jamba's, f32 and bf16, a 4096-token prefill and 4 decode
    steps): every output and cache against the whole mixer (f32 1e-5
    of max |whole|, bf16 ``CARD_TOL``); the reference's contiguous
    split read as whole heads must fail that gate;
  * ``lm_serve_mesh_ssm``: mamba2-1.3b at full size in bf16 and jamba
    at ``reduced()`` in f32 through the one-rank NCCL mesh, bit-equal
    to the mesh-free servers; jamba's K4 launches counted;
  * ``examples``: the sibling examples' paths.
    ``examples/accelerator_analysis_torch.py``'s ``main`` in-process at
    its defaults (B3, 128 -> 256, 56 x 56, 3 x 3) and at stride 2: the
    layer on K1 ``sm90_tf32`` (one launch, the route it printed the one
    whose counter rose, no ``fma``) within ``TOL`` of the plain version,
    the weights' window flipped missing it, K1 timed beside cuDNN and
    the bound; ``examples/serve_batched_torch.py``'s ``serve`` for
    reduced mixtral-8x7b and minitron-4b (f32, 8 requests, 4 slots, 12
    new tokens) through the one-rank NCCL mesh and mesh-free on the same
    params: tokens and logits bit-equal, K4 ``sm90_tf32`` launches
    exact (the mesh's with ``lse``), every step replayed at ``TOL`` and
    every K4 call within ``CARD_TOL``, ``drop_newest_slot`` missing;
  * ``dryrun``: the dry-run's meta cells (mamba2-1.3b x decode_32k and
    train_4k, phi3-medium-14b x decode_32k on (16, 16), and mamba2's
    decode_32k on (1, 1)), run on the CPU one after another at the
    lowest priority from just after ``build`` and printed here, then that (1, 1) cell run on the card
    through the one-rank NCCL mesh: its FLOPs equal to the meta run's,
    its params' and caches' bytes equal to the memory model's, its
    peak memory beside ``analytic_memory_gb``;
  * ``plan_audit``: the ``sm90`` legality profile
    (``repro_torch.analysis.plan_check``) on the card, running no
    kernel: the card's opt-in shared memory a block, SM count and
    registers an SM (``torch.cuda.get_device_properties``, else
    ``cudaDeviceGetAttribute``) equal to the constants the plans are
    sized by; every built kernel's REG, SHARED and LOCAL from
    ``cuobjdump --dump-resource-usage`` (LOCAL > 0 printed as a spill
    warning); ``audit_graph(target="sm90")`` over VGG16/224 and
    ResNet-20/32 at batches 1, 2, 4 and 8, training, f32 and bf16, every
    entry legal with those register counts and no traffic or bound
    mismatch; every K1 and K2 launch of the serving, training and traced
    phases (their launch caches' keys) the plan its shape-only core
    picks and an audited entry's, and every K3 and K4 launch plan of the
    ``matmul`` and ``attention`` phases legal; the control, a K1 3xTF32
    plan one weight stage past the fit, flagged ``sm90.smem`` and larger
    than the device's opt-in limit; under 10 s;
  * ``attention_head_dims``: K4 at head dims 80, 96 and 256, timed;
  * ``layers``, ``layers_bwd``: each kernel timed per VGG layer, f32
    and bf16, each row with its route and tile (K2: plan) and the
    host's time to enqueue one call (``host_us``; K1's forward and
    K2); K1's f32 rows (forward and dgrad), its conv1_1 bf16 row
    (``sm90_im2col``) and K2's rows also with the FMA kernel's time and
    error on the same inputs (``fma_ms``, ``fma_err``, gated like the
    route) and its bound (``fma_bound_ms``) beside the route's
    (``bound_ms``: f32 as 3xTF32, three products at the TF32 rate) and,
    at conv1_1, the im2col staging kernel's own time (``stage_ms``; K1
    also ``plane_bound_ms``, the bound with the plane's bytes);
  * ``layers_bwd_resnet``: K2 at ResNet-20/32's four strided wgrads at
    batch 8, f32 on ``sm90_tf32`` and bf16 on FMA (required), timed
    (``ms``, ``device_ms``, ``host_us``) beside cuDNN's
    ``conv2d_weight`` and the bound; f32 also the FMA kernel's time
    and error on the same inputs;
  * ``layers_resnet``: K1 at the same four strided convs, forward and
    dgrad as ``dgrad_lb`` runs it (f32: ``sm90_tf32``, the dgrad one
    launch by output phases; bf16: FMA, the dgrad lhs-dilated), timed
    the same three ways beside cuDNN's ``conv2d`` and
    ``conv2d_input`` and the bound; f32 also the FMA kernel's time and
    error on the same inputs; ``k1_k2_strided_targets`` sums the f32
    rows.

Times are CUDA events around one call, the L2 cache flushed before
it; a call shorter than the host's time to enqueue it is charged that
time too.  ``layers`` rows also give the host's time to enqueue one
call of the kernel and of the library (``host_us``,
``library_host_us``).

    python3 chip_smoke.py        # on a host with one NVIDIA H100

Every phase prints one JSON line; any failed check raises and the
script exits non-zero, except the LM paths' end-to-end logits gates:
a miss there is printed to stderr, the phases run on, and the script
exits non-zero after the kernels' line.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import ctypes
import dataclasses
import datetime
import importlib.util
import io
import json
import math
import os
import re
import shlex
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import tree as TREE  # noqa: E402
from repro_torch.analysis import plan_check as PC  # noqa: E402
from repro_torch.analysis.memory_model import (  # noqa: E402
    sharded_bytes_per_chip)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.hopper_adapter import (HBM_BYTES_PER_S,  # noqa: E402
                                             PEAK_BF16_FLOPS,
                                             PEAK_F32_FLOPS,
                                             PEAK_TF32_FLOPS, REGS_PER_SM,
                                             SM_COUNT, SMEM_PER_BLOCK,
                                             hbm_traffic_model)
from repro_torch.data.synthetic import (DataConfig,  # noqa: E402
                                        global_batch_at)
from repro_torch.kernels.attention_block import kernel as K4  # noqa: E402
from repro_torch.kernels.attention_block import backward as K4_BWD  # noqa: E402,E501
from repro_torch.kernels.attention_block import ops as K4_OPS  # noqa: E402
from repro_torch.kernels.attention_block.ops import (  # noqa: E402
    flash_attention, heads_first)
from repro_torch.kernels.attention_block import ref as K4_REF  # noqa: E402
from repro_torch.kernels.attention_block.ref import (  # noqa: E402
    attention_plain, attention_plain_panel)
from repro_torch.kernels.conv_lb import im2col as I  # noqa: E402
from repro_torch.kernels.conv_lb import kernel as K  # noqa: E402
from repro_torch.kernels.conv_lb import ops as conv_ops  # noqa: E402
from repro_torch.kernels.conv_lb import wgrad as W  # noqa: E402
from repro_torch.kernels.conv_lb.ops import (ConvArgs,  # noqa: E402
                                             conv2d_lb, dgrad_lb,
                                             relu_slope)
from repro_torch.kernels.matmul_lb import kernel as K3  # noqa: E402
from repro_torch.kernels.matmul_lb.ops import (accounted_block,  # noqa: E402
                                               matmul_lb)
from repro_torch.kernels.matmul_lb.ref import matmul_ref  # noqa: E402
from repro_torch.kernels.conv_lb.ref import (conv2d_ref, flip_w,  # noqa: E402
                                             im2col_ref, wgrad_ref)
from repro_torch.kernels.nvcc import (build_many,  # noqa: E402
                                      parse_ptxas_spills, resource_usage)
from repro_torch.launch import dryrun as DRY  # noqa: E402
from repro_torch.launch import serve_images  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch import steps as LM_STEPS  # noqa: E402
from repro_torch.launch import train_vgg as T  # noqa: E402
from repro_torch.launch.serve import BatchedServer  # noqa: E402
from repro_torch.launch.serve import Request as LmRequest  # noqa: E402
from repro_torch.launch.train import make_step, make_trainer  # noqa: E402
from repro_torch.launch.yardstick import WGRAD_TOL, within  # noqa: E402
from repro_torch.launch.yardstick import device_ms as _device_ms  # noqa: E402,E501
from repro_torch.launch.yardstick import time_ms as _time_ms  # noqa: E402
from repro_torch.models import attention as LM_A  # noqa: E402
from repro_torch.models import embedding as LM_EMB  # noqa: E402
from repro_torch.models import encdec as LM_E  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import transformer as LM_T  # noqa: E402
from repro_torch.models.api import build as build_lm  # noqa: E402
from repro_torch.models.layers import (decode_attention,  # noqa: E402
                                       rms_norm)
from repro_torch.models.cnn import (init_resnet, init_vgg,  # noqa: E402
                                    resnet_graph, vgg_graph,
                                    vgg_layer_dims)
from repro_torch.models.graph import (graph_logits,  # noqa: E402
                                      graph_plan_handles, graph_stages,
                                      graph_training_step_report)
from repro_torch.obs.tracer import Tracer  # noqa: E402
from repro_torch.optim import adamw as ADAMW  # noqa: E402
from repro_torch.parallel import collectives as COL  # noqa: E402
from repro_torch.parallel import sharding as SH  # noqa: E402
from repro_torch.runtime.elastic import plan_remesh  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    ResilienceConfig, run_resilient)
from repro_torch.serve import (FaultPlan, ImageServer,  # noqa: E402
                               ServingLoop, VirtualClock)

#: kernel vs plain version: sums run in another order over K <= 4608
TOL = 1e-4
#: training-step gradients vs plain autograd on the same ReLU masks and
#: pool maxima (``Decisions``): 13-21 layers of f32 sums in another
#: order, relative to each tensor's max |plain grad|
GRAD_TOL = 1e-3
TRAIN_STEPS = 3
#: SGD rates under which the loss falls over the steps from He init
#: (no normalization layers)
TRAIN_LR = {"vgg": 1e-4, "resnet": 1e-3}
SEED = 0
SOURCE = "src/repro_torch/kernels/conv_lb/csrc/conv_lb.cu"
CONV_SM90_SOURCE = "src/repro_torch/kernels/conv_lb/csrc/conv_lb_sm90.cu"
CONV_TF32_SOURCE = ("src/repro_torch/kernels/conv_lb/csrc/"
                    "conv_lb_sm90_tf32.cu")
REPLACES = "src/repro/kernels/conv_lb/kernel.py:116"
WGRAD_SOURCE = "src/repro_torch/kernels/conv_lb/csrc/wgrad_lb.cu"
WGRAD_SM90_SOURCE = "src/repro_torch/kernels/conv_lb/csrc/wgrad_lb_sm90.cu"
WGRAD_TF32_SOURCE = ("src/repro_torch/kernels/conv_lb/csrc/"
                     "wgrad_lb_sm90_tf32.cu")
WGRAD_IM2COL_SOURCE = "src/repro_torch/kernels/conv_lb/csrc/wgrad_im2col.cu"
WGRAD_REPLACES = "src/repro/kernels/conv_lb/wgrad.py:50"
MATMUL_SOURCE = "src/repro_torch/kernels/matmul_lb/csrc/matmul_lb.cu"
SM90_SOURCE = "src/repro_torch/kernels/matmul_lb/csrc/matmul_lb_sm90.cu"
MATMUL_TF32_SOURCE = ("src/repro_torch/kernels/matmul_lb/csrc/"
                      "matmul_lb_sm90_tf32.cu")
MATMUL_REPLACES = "src/repro/kernels/matmul_lb/kernel.py:23"
ATTN_SOURCE = ("src/repro_torch/kernels/attention_block/csrc/"
               "attention_block.cu")
ATTN_SM90_SOURCE = ("src/repro_torch/kernels/attention_block/csrc/"
                    "attention_block_sm90.cu")
ATTN_TF32_SOURCE = ("src/repro_torch/kernels/attention_block/csrc/"
                    "attention_block_sm90_tf32.cu")
ATTN_REPLACES = "src/repro/kernels/attention_block/kernel.py:22"
DTYPES = (torch.float32, torch.bfloat16)
PEAK = {torch.float32: PEAK_F32_FLOPS, torch.bfloat16: PEAK_BF16_FLOPS}


class SmokeFailure(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


#: the gates missed by :func:`expect`, each failing the smoke at its end
MISSED: list[str] = []


def expect(cond: bool, what: str) -> None:
    """A gate whose miss fails the smoke once every phase has run and
    the kernels' line is printed (not at once, as :func:`require`
    does), so that one end-to-end gate's miss leaves the other phases'
    readings whole."""
    if not cond:
        print(f"chip_smoke: gate missed: {what}", file=sys.stderr,
              flush=True)
        MISSED.append(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs err, max abs err / max |ref|)."""
    err = (out - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def phase_device() -> str:
    card = card_line()
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return card


def phase_build() -> list:
    """Every kernel, one nvcc each, all started together."""
    t0 = time.perf_counter()
    libs = build_many([K.SOURCE, K.SM90_SOURCE, K.TF32_SOURCE, W.SOURCE,
                       W.SM90_SOURCE, W.TF32_SOURCE, I.SOURCE, K3.SOURCE,
                       K3.SM90_SOURCE, K3.TF32_SOURCE, K4.SOURCE,
                       K4.SM90_SOURCE, K4.TF32_SOURCE])
    for lib, source in zip(libs, (SOURCE, CONV_SM90_SOURCE,
                                  CONV_TF32_SOURCE, WGRAD_SOURCE,
                                  WGRAD_SM90_SOURCE, WGRAD_TF32_SOURCE,
                                  WGRAD_IM2COL_SOURCE, MATMUL_SOURCE,
                                  SM90_SOURCE, MATMUL_TF32_SOURCE,
                                  ATTN_SOURCE, ATTN_SM90_SOURCE,
                                  ATTN_TF32_SOURCE)):
        emit({"phase": "build", "seconds": lib.seconds,
              "library": lib.path.name, "source": source,
              "ptxas": [ln.strip() for ln in lib.log.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "smem" in ln or "Compiling entry" in ln
                        or "Performance Loss" in ln]})
    emit({"phase": "build", "wall_seconds": time.perf_counter() - t0})
    return libs


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).cuda()


# name, batch, (h, w), ci, co, k, stride, pad, dilation, lhs_dilation,
# groups, bias, residual, relu, pool
CHECKS = [
    ("vgg_3x3_s1_p1_bias_relu_pool2_b8", 8, (28, 28), 64, 128, 3, 1, 1,
     1, 1, 1, True, False, True, 2),
    ("vgg_conv1_1_ci3_b1", 1, (224, 224), 3, 64, 3, 1, 1, 1, 1, 1, True,
     False, True, 1),
    ("stride2_b8", 8, (32, 32), 16, 32, 3, 2, 1, 1, 1, 1, True, False,
     True, 1),
    ("proj_1x1_s2_b8", 8, (32, 32), 16, 32, 1, 2, 0, 1, 1, 1, True, False,
     False, 1),
    ("rhs_dilation2", 2, (20, 20), 16, 16, 3, 1, 2, 2, 1, 1, True, False,
     True, 1),
    ("lhs_dilation2_dgrad", 2, (9, 9), 8, 8, 3, 1, 2, 1, 2, 1, False,
     False, False, 1),
    ("residual_relu_b8", 8, (16, 16), 32, 32, 3, 1, 1, 1, 1, 1, True,
     True, True, 1),
    ("residual_relu_pool2_b1", 1, (16, 16), 24, 40, 3, 1, 1, 1, 1, 1,
     True, True, True, 2),
    ("odd_plane_odd_channels_b3", 3, (15, 13), 7, 9, 3, 1, 1, 1, 1, 1,
     True, False, True, 1),
    ("groups2", 2, (16, 16), 8, 12, 3, 1, 1, 1, 1, 2, True, False, True,
     1),
    ("vgg_conv5_3_pool2_b8", 8, (14, 14), 512, 512, 3, 1, 1, 1, 1, 1,
     True, False, True, 2),
    # windows whose weight slice crowds shared memory: a 7x7/2 stem and
    # a 7x7 at dilation 2 (fewer pixels per CTA), and an 11x11/4 whose
    # slice alone exceeds it (staged a kernel row at a time)
    ("stem_7x7_s2_p3_b8", 8, (224, 224), 3, 64, 7, 2, 3, 1, 1, 1, True,
     False, True, 1),
    ("7x7_dilation2_b2", 2, (40, 40), 16, 64, 7, 1, 6, 2, 1, 1, True,
     False, True, 1),
    ("11x11_s4_b2", 2, (227, 227), 3, 64, 11, 4, 2, 1, 1, 1, True, False,
     True, 1),
]


def conv_route(x, w, bias=None, residual=None, **kw) -> tuple[str, list]:
    """The route :func:`K.plan_of` names for one group of a conv and the
    tile that route's kernel runs: ``[bb, ty, tx, bn, cib]`` (sm90),
    ``[cp, bb, ty, tx, bn, cib]`` (sm90_im2col: the plane's channels,
    then its 1x1 conv's tile) or ``cta_plan``'s ``[bb, ty, tx, tn,
    krows]`` (fma)."""
    def pair(v):
        return (v, v) if isinstance(v, int) else tuple(v)
    kw = {k: v if k == "pool" else pair(v) for k, v in kw.items()}
    rt, plan = K.plan_of(x, w, bias, residual, **kw)
    return rt, list(plan if rt == "fma" else plan.tile)


def wgrad_route(x, dy, geom) -> tuple[str, list]:
    """The route :func:`W.plan_of` names for one wgrad and the plan that
    route's kernel runs: ``[bn, nwc, cib, splits]`` (sm90, sm90_tf32),
    ``[cp, bn, nwc, cib, splits]`` (sm90_im2col: the plane's channels,
    then its 1x1 wgrad's tile) or ``wgrad_split``'s ``[tn, splits,
    chunks_per_split]`` (fma)."""
    rt, plan = W.plan_of(x, dy, geom)
    return rt, list(plan if rt == "fma" else plan.tile)


def want_wgrad_route(dtype, ci: int, co: int, k: int, s: int) -> str:
    """The route a wgrad must take on aligned operands: Co a multiple of
    the 16-byte pitch (8 bf16, 4 f32 channels) on the tensor cores, Ci a
    multiple of it directly (bf16 at stride 1, f32 at any stride), else
    at stride 1 a plane of at most 64 taps; all else on FMA."""
    pitch = 8 if dtype == torch.bfloat16 else 4
    if co % pitch or (s != 1 and dtype == torch.bfloat16):
        return "fma"
    if ci % pitch == 0:
        return "sm90" if dtype == torch.bfloat16 else "sm90_tf32"
    if s != 1:
        return "fma"
    return "sm90_im2col" if k * k * ci <= I.IM2COL_MAX else "fma"


def wgrad_launch(x, dy, geom, what: str):
    """One ``wgrad_lb`` call, required to launch the kernel of the route
    :func:`wgrad_route` names (once, on no other route): returns dW,
    the route and its plan."""
    rt, plan = wgrad_route(x, dy, geom)
    before = dict(W.wgrad_lb.launches_by_route)
    dw = W.wgrad_lb(x, dy, geom)
    launched = {r: W.wgrad_lb.launches_by_route[r] - before[r]
                for r in before}
    require(launched == dict.fromkeys(W.ROUTES, 0) | {rt: 1},
            f"{what}: wgrad launches {launched}, route {rt}")
    return dw, rt, plan


def phase_check() -> dict:
    """K1 at every geometry of :data:`CHECKS` in f32 (``TOL`` of max
    |plain|; on ``sm90_tf32`` or ``sm90_im2col`` where the route sends
    it) and in bf16 (the bf16 ``CARD_TOL``: both sum the same bf16 words
    in f32 and round once), against the plain version; each row with the
    route :func:`K.route` names and the launches it took.  Returns the
    1xTF32 control's error over the route's, by layer."""
    gen = torch.Generator().manual_seed(SEED)
    for (name, b, (h, w), ci, co, k, s, p, d, ld, g, has_bias,
         has_res, relu, pool) in CHECKS:
        x = _randn(gen, b, h, w, ci)
        wt = _randn(gen, k, k, ci // g, co, scale=(k * k * ci / g) ** -0.5)
        bias = _randn(gen, co) if has_bias else None
        hd, wd = (h - 1) * ld + 1, (w - 1) * ld + 1
        ho = (hd + 2 * p - ((k - 1) * d + 1)) // s + 1
        wo = (wd + 2 * p - ((k - 1) * d + 1)) // s + 1
        res = _randn(gen, b, ho, wo, co) if has_res else None
        kw = dict(stride=s, padding=p, dilation=d, lhs_dilation=ld,
                  groups=g, relu=relu, pool=pool)
        for dtype in DTYPES:
            args = [None if t is None else t.to(dtype)
                    for t in (x, wt, bias, res)]
            # the route of one group (the groups are alike)
            route, tile = conv_route(
                *[None if t is None else t[..., :t.shape[-1] // g]
                  .contiguous() for t in args],
                stride=s, padding=p, dilation=d, lhs_dilation=ld,
                pool=pool)
            before = dict(K.conv_lb.launches_by_route)
            out = conv2d_lb(*args, **kw)
            torch.cuda.synchronize()
            launched = {r: K.conv_lb.launches_by_route[r] - before[r]
                        for r in before}
            ref = conv2d_ref(*args, **kw)
            require(out.shape == ref.shape and out.dtype == dtype,
                    f"check {name} {dtype}: {out.dtype} "
                    f"{tuple(out.shape)} != {tuple(ref.shape)}")
            require(launched == dict.fromkeys(K.ROUTES, 0) | {route: g},
                    f"check {name} {dtype}: launches {launched}, route "
                    f"{route}")
            err, rel = rel_err(out.float(), ref.float())
            row = {"phase": "check", "geometry": name, "dtype": str(dtype),
                   "shape": list(out.shape), "max_abs_err": err,
                   "max_abs_err_over_max_ref": rel, "route": route,
                   "tile": tile, "launches_by_route": launched}
            if dtype == torch.float32:
                row["tol"] = TOL
                ok = rel <= TOL
            else:
                row.update(within(out, ref, dtype))
                ok = row["worst_over_tol"] <= 1.0
            emit(row)
            require(ok, f"check {name} {dtype}: kernel vs plain {row}")
    check_sm90_control(gen)
    tf32_controls = check_tf32_control(gen)
    check_im2col_conv_control(gen)
    return tf32_controls


# name, batch, plane, ci, co, pool: VGG16/224 layers at batch 8 on which
# a fault of the sm90 kernel is shown to fail the bf16 gate
SM90_CONTROLS = [("conv3_2", 8, 56, 256, 256, 1),
                 ("conv5_3", 8, 14, 512, 512, 2)]


def check_sm90_control(gen) -> None:
    """K1's sm90 kernel with one fault of its own: the centre window
    (1, 1) reads the halo one row off (its shift passed one halo row too
    far).  The right launch passes the unchanged bf16 gate; the faulty
    one must fail it."""
    bf = torch.bfloat16
    for name, b, h, ci, co, pool in SM90_CONTROLS:
        x = _randn(gen, b, h, h, ci).to(bf)
        w = _randn(gen, 3, 3, ci, co, scale=(9 * ci) ** -0.5).to(bf)
        bias = _randn(gen, co).to(bf)
        kw = dict(padding=(1, 1), relu=True, pool=pool)
        require(K.route(x, w, bias=bias, pool=pool) == "sm90",
                f"control sm90 {name}: route")
        plan = K.sm90_plan(b, h, h, co, ci, 3, 3, (1, 1))
        off = list(plan.win_off)
        off[4] += plan.sbo
        bad = dataclasses.replace(plan, win_off=tuple(off))
        right = K.conv_lb(x, w, bias, **kw)
        wrong = K._sm90(x, w, bias, None, h, h, (1, 1), True, pool, bad)
        plain = conv2d_ref(x, w, bias, **kw)
        torch.cuda.synchronize()
        gate = within(right, plain, bf)
        emit({"phase": "check", "geometry": f"sm90_control_{name}_b{b}",
              "dtype": str(bf), "route": "sm90",
              "tile": list(plan.tile),
              **gate, "control": control(
                  "centre window reads the halo one row off", wrong,
                  plain, bf)})
        require(gate["worst_over_tol"] <= 1.0,
                f"control sm90 {name}: the right launch {gate}")


def check_tf32_control(gen) -> dict:
    """K1's 3xTF32 kernel at the layers of :data:`SM90_CONTROLS` in f32:
    the route passes ``TOL`` and gives the same bits on a second launch;
    two faults of its own are shown to matter: the centre window (1, 1)
    reading the halo one row off must fail ``TOL``, and 1xTF32 (the lo
    words dropped, one launch of the same plan) must err at least 4x
    more than the route.  Returns 1xTF32's error over the route's, by
    layer."""
    over_route = {}
    for name, b, h, ci, co, pool in SM90_CONTROLS:
        x = _randn(gen, b, h, h, ci)
        w = _randn(gen, 3, 3, ci, co, scale=(9 * ci) ** -0.5)
        bias = _randn(gen, co)
        kw = dict(padding=(1, 1), relu=True, pool=pool)
        rt, plan = K.plan_of(x, w, bias, padding=(1, 1), pool=pool)
        require(rt == "sm90_tf32", f"control tf32 {name}: route {rt}")
        off = list(plan.win_off)
        off[4] += plan.sbo
        bad = dataclasses.replace(plan, win_off=tuple(off))
        right = K.conv_lb(x, w, bias, **kw)
        again = K.conv_lb(x, w, bias, **kw)
        args = (x, w, bias, None, h, h, (1, 1), True, pool)
        wrong = K._sm90_tf32(*args, bad)
        one = K._sm90_tf32(*args, plan, lo_terms=False)
        plain = conv2d_ref(x, w, bias, **kw)
        torch.cuda.synchronize()
        _, rel = rel_err(right, plain)
        _, wrel = rel_err(wrong, plain)
        _, orel = rel_err(one, plain)
        same = bool(torch.equal(right, again))
        emit({"phase": "check", "geometry": f"tf32_control_{name}_b{b}",
              "dtype": "torch.float32", "route": rt,
              "tile": list(plan.tile), "max_abs_err_over_max_ref": rel,
              "tol": TOL, "same_bits_second_launch": same,
              "control": {"what": "centre window reads the halo one row "
                                  "off", "max_abs_err_over_max_ref": wrel,
                          "over_tol": wrel / TOL},
              "control_1xtf32": {"what": "1xTF32: the lo words dropped",
                                 "max_abs_err_over_max_ref": orel,
                                 "over_route": orel / max(rel, 1e-30),
                                 "over_tol": orel / TOL}})
        require(rel <= TOL and same, f"control tf32 {name}: the right "
                                     f"launch {rel}, same bits {same}")
        require(wrel > TOL, f"control tf32 {name}: the faulty launch "
                            f"{wrel} passes {TOL}")
        require(orel >= 4 * rel, f"control tf32 {name}: 1xTF32 errs "
                f"{orel}, under 4x the route's {rel}")
        over_route[name] = orel / max(rel, 1e-30)
    return over_route


def check_im2col_conv_control(gen) -> None:
    """K1's route ``sm90_im2col`` at VGG16/224 conv1_1 (bf16, batch 8)
    with one fault of its own: the plane's centre tap read one column
    off.  The right launch passes the unchanged bf16 gate; the faulty
    one must fail it."""
    bf = torch.bfloat16
    x = _randn(gen, 8, 224, 224, 3).to(bf)
    w = _randn(gen, 3, 3, 3, 64, scale=27 ** -0.5).to(bf)
    bias = _randn(gen, 64).to(bf)
    kw = dict(padding=(1, 1), relu=True)
    rt, plan = K.plan_of(x, w, bias, padding=(1, 1))
    require(rt == "sm90_im2col", f"control im2col conv: route {rt}")
    taps = list(plan.taps)
    taps[4] = (taps[4][0], taps[4][1] + 1)
    bad = dataclasses.replace(plan, taps=tuple(taps))
    right = K.conv_lb(x, w, bias, **kw)
    wrong = K._im2col_sm90(x, w, bias, None, 224, 224, True, 1, bad)
    plain = conv2d_ref(x, w, bias, **kw)
    torch.cuda.synchronize()
    gate = within(right, plain, bf)
    emit({"phase": "check", "geometry": "im2col_control_conv1_1_b8",
          "dtype": str(bf), "route": rt, "tile": list(plan.tile), **gate,
          "control": control("centre tap one column off", wrong, plain,
                             bf)})
    require(gate["worst_over_tol"] <= 1.0,
            f"control im2col conv: the right launch {gate}")


def check_strided_controls(gen) -> dict:
    """K1's and K2's 3xTF32 kernels at a stride in f32, at ResNet-20/32's
    s2b0_a (3x3/2, 16 -> 32 channels on 32 x 32, batch 8): each route
    passes its gate (``TOL``, the wgrad ``WGRAD_TOL``) and gives the same
    bits on a second launch; three faults of their own are shown to
    matter: a plan whose halo boxes are loaded at stride 1 and read as if
    strided (K1's forward, K2) fails the gate; the fullest phase's taps
    one gy column
    off (K1's dgrad) fails it; 1xTF32 (the lo words dropped: K1's
    forward and dgrad, K2) errs at least 4x the route.  Returns each
    1xTF32 error over its route's."""
    b, h, ci, co, k, s, pad = 8, 32, 16, 32, 3, 2, 1
    ho = h // s
    x = _randn(gen, b, h, h, ci)
    w = _randn(gen, k, k, ci, co, scale=(k * k * ci) ** -0.5)
    bias = _randn(gen, co)
    gy = _randn(gen, b, ho, ho, co)
    st, pd = (s, s), (pad, pad)
    kw = dict(stride=st, padding=pd, relu=True)
    rt, plan = K.plan_of(x, w, bias, stride=st, padding=pd)
    args = (x, w, bias, None, ho, ho, pd, True, 1)
    dplan = K.sm90_tf32_dgrad_plan(b, h, h, ci, co, k, k, st, pd)

    def phased(p, lo_terms=True):
        return K.Tf32Launch((b, h, h, ci), K.tf32_args(
            gy.shape, w.shape, p, (h, h), (0, 0), False, 1,
            lo_terms))(gy, w, None, None)

    geom = W.WgradGeometry(hk=k, wk=k, stride=st, padding=pd)
    wplan = W.plan_of(x, gy, geom)[1]
    plain_d = _dgrad_plain(gy, w, x.shape, s, pad)
    plain_w = wgrad_ref(x, gy, k, k, stride=s, padding=pad)
    cases = {
        "forward": (rt, lambda: K.conv_lb(x, w, bias, **kw),
                    conv2d_ref(x, w, bias, **kw), TOL,
                    ("the halo boxes loaded at stride 1",
                     lambda: K._sm90_tf32(*args, K.halo_at_stride_one(plan))),
                    lambda: K._sm90_tf32(*args, plan, lo_terms=False)),
        "dgrad": (K.dgrad_route(gy, w, st, h, h, pd),
                  lambda: K.conv_lb_dgrad(gy, w, stride=st, padding=pd,
                                          h=h, wd=h), plain_d, TOL,
                  ("the fullest phase's taps one gy column off",
                   lambda: phased(K.dgrad_phase_shifted(dplan))),
                  lambda: phased(dplan, False)),
        "wgrad": (W.route(x, gy, geom), lambda: W.wgrad_lb(x, gy, geom),
                  plain_w, WGRAD_TOL,
                  ("the halo boxes loaded at stride 1",
                   lambda: W._sm90_tf32(x, gy, geom,
                                        K.halo_at_stride_one(wplan))),
                  lambda: W._sm90_tf32(x, gy, geom, wplan, lo_terms=False))}
    over_route = {}
    for op, (route, right, plain, tol, (what, fault),
             one_x) in cases.items():
        require(route == "sm90_tf32", f"control strided {op}: on {route}")
        out, again = right(), right()
        wrong, one = fault(), one_x()
        torch.cuda.synchronize()
        _, rel = rel_err(out, plain)
        _, wrel = rel_err(wrong, plain)
        _, orel = rel_err(one, plain)
        same = bool(torch.equal(out, again))
        emit({"phase": "check", "geometry": f"strided_control_{op}_s2b0_a_b8",
              "dtype": "torch.float32", "route": route,
              "max_abs_err_over_max_ref": rel, "tol": tol,
              "same_bits_second_launch": same,
              "control": {"what": what, "max_abs_err_over_max_ref": wrel,
                          "over_tol": wrel / tol},
              "control_1xtf32": {"what": "1xTF32: the lo words dropped",
                                 "max_abs_err_over_max_ref": orel,
                                 "over_route": orel / max(rel, 1e-30),
                                 "over_tol": orel / tol}})
        require(rel <= tol and same, f"control strided {op}: the route "
                                     f"{rel}, same bits {same}")
        require(wrel > tol, f"control strided {op}: the faulty launch {wrel} "
                            f"passes {tol}")
        require(orel >= 4 * rel, f"control strided {op}: 1xTF32 errs {orel}, "
                                 f"under 4x the route's {rel}")
        over_route[op] = orel / max(rel, 1e-30)
    return over_route


def _reset_k1() -> None:
    """Set K1's launch counts to 0 before a path is driven."""
    K.conv_lb.launches = 0
    K.conv_lb.launches_by_route = dict.fromkeys(K.ROUTES, 0)
    K.conv_lb.stage_launches = 0


#: K1's launches by route in one dispatch of each served model and type
SERVE_ROUTES = {
    ("vgg", torch.float32): {"sm90_tf32": 12, "sm90_im2col": 1},
    ("vgg", torch.bfloat16): {"sm90": 12, "sm90_im2col": 1},
    ("resnet", torch.float32): {"sm90_tf32": 20, "sm90_im2col": 1}}


def phase_serve(model: str, dtype: torch.dtype = torch.float32,
                keep: dict | None = None) -> dict:
    """Serve 16 requests of 1-8 images in ``dtype`` (bf16: the same
    weights rounded once); returns K1's launches by route.  ``keep``
    receives the weights, the payloads, the rids of the first bucket-8
    dispatch and every rid's logits, for the ``trace`` phase."""
    gen = torch.Generator().manual_seed(SEED)
    if model == "vgg":
        params = init_vgg(gen, device="cuda")
        graph, size = vgg_graph(params), 224
    else:
        graph = resnet_graph()
        params = init_resnet(gen, graph, device="cuda")
        size = 32
    params = {"convs": [{k: t.to(dtype) for k, t in p.items()}
                        for p in params["convs"]],
              "head": params["head"].to(dtype)}
    phase = model if dtype == torch.float32 else f"serve_bf16_{model}"
    n_convs = len(graph_stages(graph, size, size))
    sizes = np.random.default_rng(SEED).integers(1, 9, size=16)
    images = [torch.randn((int(n), size, size, 3), generator=gen)
              for n in sizes]
    tracer = Tracer()
    srv = ImageServer(params, size, size, graph=graph, device="cuda",
                      dtype=dtype, tracer=tracer)
    srv.warm()
    _reset_k1()
    results = []
    for im in images:
        srv.submit(im)
        results += srv.poll()
    results += srv.drain()
    launches = K.conv_lb.launches
    by_route = dict(K.conv_lb.launches_by_route)
    stages = K.conv_lb.stage_launches
    rids = sorted(r.rid for r in results)
    require(rids == list(range(len(images))),
            f"{phase}: rids answered {rids}")
    dispatches = srv.stats["dispatches"]
    require(launches == n_convs * dispatches,
            f"{phase}: {launches} kernel launches for {dispatches} "
            f"dispatches of {n_convs} convs")
    # VGG: conv1_2 ... conv5_3 on the tensor-core kernel of the type,
    # conv1_1 (Ci = 3) through the im2col plane onto it (one staging
    # launch each); ResNet (f32): its 16 stride-1 and 4 strided convs on
    # the 3xTF32 kernel, the stem on the plane, none on FMA
    want = dict.fromkeys(K.ROUTES, 0) | {
        rt: n * dispatches for rt, n in SERVE_ROUTES[model, dtype].items()}
    require(by_route == want, f"{phase}: launches by route {by_route}, "
                              f"want {want}")
    require(stages == want["sm90_im2col"],
            f"{phase}: {stages} staging launches for {dispatches} "
            f"dispatches")
    got = torch.cat([r.logits for r in sorted(results,
                                              key=lambda r: r.rid)])
    with torch.no_grad():
        plain = graph_logits(graph, params,
                             torch.cat(images).to("cuda", dtype),
                             conv=conv2d_ref)
    torch.cuda.synchronize()
    err, rel = rel_err(got.float(), plain.float())
    finite = bool(torch.isfinite(got).all().item())
    gate = ({"tol": TOL} if dtype == torch.float32
            else within(got, plain, dtype))
    dispatch_ms = [s.attrs["us"] / 1e3
                   for s in tracer.find("serve.execute")]
    b8_ms = [s.attrs["us"] / 1e3 for s in tracer.find("serve.execute")
             if s.attrs["bucket"] == 8]
    summary = srv.ledger.summary()
    if keep is not None:
        # a dispatch's rids: the serve.complete events after its
        # serve.execute span
        groups = []
        for rec in tracer.records:
            if rec.name == "serve.execute":
                groups.append((rec.attrs["bucket"], []))
            elif rec.name == "serve.complete":
                groups[-1][1].append(rec.attrs["rid"])
        keep.update(params=params, graph=graph, images=images,
                    group=next(rids for b, rids in groups if b == 8),
                    logits={r.rid: r.logits for r in results})
    emit({"phase": phase, "dtype": str(dtype), "logits_dtype":
          str(got.dtype), **gate, "requests": len(images),
          "images": int(sum(sizes)), "dispatches": dispatches,
          "convs_per_dispatch": n_convs, "kernel_launches": launches,
          "launches_by_route": by_route, "stage_launches": stages,
          "every_rid_answered_once": True,
          "logits_shape": list(got.shape), "logits_finite": finite,
          "max_abs_err_vs_plain": err, "max_rel_err_vs_plain": rel,
          "dispatch_ms": dispatch_ms,
          "dispatch_ms_b8_median": (float(np.median(b8_ms)) if b8_ms
                                    else None),
          "stats": srv.stats,
          "ledger": {k: summary[k] for k in (
              "bytes_per_image", "vs_bound_x", "w_amortization_x",
              "vs_serving_x", "dispatches", "padded_images")}})
    print(srv.ledger.format_summary(), flush=True)
    require(finite and got.dtype == dtype,
            f"{phase}: {got.dtype} logits, finite {finite}")
    if dtype == torch.float32:
        require(rel <= TOL, f"{phase}: logits vs plain {rel} > {TOL}")
    else:
        require(gate["worst_over_tol"] <= 1.0,
                f"{phase}: logits vs plain {gate}")
    return by_route


#: the reference benchmark's bursty trace (``benchmarks/serve_bench.py``
#: ``bench_serve_loop_bursty``): 6 bursts of 16 images 0.25 s apart, then
#: a storm of 24 requests (64 images), against a 0.3 s budget and 50 ms
#: of virtual service a dispatch
LOOP_BURSTS = ([(t * 0.25, (4, 2, 1, 1, 4, 2, 1, 1)) for t in range(6)]
               + [(6 * 0.25, (4, 4, 2, 2, 4, 1, 1, 2, 4, 2, 4, 2,
                              4, 4, 2, 2, 4, 1, 1, 2, 4, 2, 4, 2))])
LOOP_DEADLINE_S = 0.30
LOOP_SERVICE_S = 0.05
#: FaultPlan.random seeds on the bursty trace: the first two whose
#: schedules fire a fail, a delay and a skew on it
LOOP_SEEDS = (1, 2)
#: the real-clock runs' plan: the first three attempts fail, so two
#: consecutive failures trip the breaker before any success can land,
#: in ``run_async``'s order as in ``run_sync``'s
LOOP_REAL_PLAN = "fail@0,fail@1,fail@2,delay@5:0.02"
#: the real-clock runs serve the bursty trace's first three bursts
LOOP_REAL_REQUESTS = 24


def _k1_counts() -> dict:
    return {"launches": K.conv_lb.launches,
            "by_route": dict(K.conv_lb.launches_by_route),
            "stage": K.conv_lb.stage_launches}


def _loop_checks(what: str, loop, tracer: Tracer, results, k1: dict,
                 plain: dict) -> dict:
    """What every serving-loop run must show: each rid terminal once
    and the ledger reconciled; K1's launches 13 a computed dispatch
    (12 ``sm90_tf32`` + 1 ``sm90_im2col`` and its staging launch), none
    for a degraded one; degraded results without logits, counted in the
    ledger; no library rung; every computed logits tensor within
    ``TOL`` of the plain forward (``plain``: rid -> logits)."""
    led = loop.server.ledger
    c = loop.counters
    states = [t.state.value for t in loop.requests.values()]
    require(loop.all_terminal()
            and c["done"] + c["shed"] + c["failed"] == c["submitted"]
            == len(states) == led.submitted_requests,
            f"{what}: not every rid terminal once: {c}")
    require(sorted(r.rid for r in results)
            == sorted(rid for rid, t in loop.requests.items()
                      if t.state.value == "done"),
            f"{what}: results and DONE rids differ")
    s = led.summary()
    require((s["shed_requests"], s["failed_requests"],
             s["served_requests"]) == (c["shed"], c["failed"], c["done"]),
            f"{what}: ledger does not reconcile with {c}")
    attempts = tracer.find("dispatch.attempt")
    degraded = [sp for sp in attempts if sp.attrs.get("outcome") == "done"
                and sp.attrs["mode"] == "account-only"]
    require(len(degraded) == led.degraded_dispatches,
            f"{what}: {len(degraded)} degraded attempts, ledger "
            f"{led.degraded_dispatches}")
    computed = led.dispatches - led.degraded_dispatches
    want = dict.fromkeys(K.ROUTES, 0) | {"sm90_tf32": 12 * computed,
                                         "sm90_im2col": computed}
    require(k1["launches"] == 13 * computed and k1["by_route"] == want
            and k1["stage"] == computed,
            f"{what}: K1 {k1} for {computed} computed and "
            f"{led.degraded_dispatches} degraded dispatches")
    no_logits = {int(r) for sp in degraded
                 for r in sp.attrs["rids"].split(",")}
    require({r.rid for r in results if r.logits is None} == no_logits,
            f"{what}: results without logits are not the degraded ones")
    worst = 0.0
    for r in results:
        if r.logits is None:
            continue
        _, rel = rel_err(r.logits, plain[r.rid])
        worst = max(worst, rel)
    require(worst <= TOL, f"{what}: logits vs plain {worst} > {TOL}")
    require(s["exec_fallbacks"] == 0,
            f"{what}: {s['exec_fallbacks']} library-rung passes")
    return {"requests": c["submitted"], "done": c["done"],
            "shed": c["shed"], "failed": c["failed"],
            "retries": c["retries"], "trips": loop.breaker.trips,
            "recoveries": len(tracer.find("breaker.recover")),
            "degraded_dispatches": led.degraded_dispatches,
            "dispatches": led.dispatches, "computed_dispatches": computed,
            "k1_launches": k1["launches"], "k1_by_route": k1["by_route"],
            "peak_inflight": c["peak_inflight"],
            "max_rel_err_vs_plain": worst, "goodput": s["goodput"],
            "shed_frac": s["shed_frac"],
            "p50_latency_ms": s["p50_latency_s"] * 1e3,
            "p99_latency_ms": s["p99_latency_s"] * 1e3,
            "dispatch_ms": [sp.attrs["us"] / 1e3
                            for sp in tracer.find("serve.execute")],
            "exec_fallbacks": s["exec_fallbacks"]}


def _bursty(params, graph, device, plan, images=None, **kw):
    """The bursty trace through a ServingLoop on a VirtualClock:
    ``images`` (rid -> payload) on ``device`` at the kernel target, or
    account-only (``images=None``); returns (loop, tracer, results,
    the clock).  The tracer keeps real time: its ``serve.execute``
    spans time the card."""
    clock = VirtualClock()
    tracer = Tracer()
    srv = ImageServer(params, 224, 224, graph=graph, device=device,
                      clock=clock, wait_budget=0.02, tracer=tracer,
                      target="kernel" if images else "account-only")
    loop = ServingLoop(srv, deadline_s=LOOP_DEADLINE_S, fault_plan=plan,
                       service_estimate_s=LOOP_SERVICE_S, seed=SEED, **kw)
    results, rid = [], 0
    for at, sizes in LOOP_BURSTS:
        if clock.now < at:
            clock.sleep(at - clock.now)
        for n in sizes:
            if images:
                loop.submit(images[rid])
            else:
                loop.submit(n_images=n)
            rid += 1
        results += loop.pump()
    results += loop.run_sync(tick_s=0.01)
    return loop, tracer, results, clock


def phase_serve_loop(card: str) -> dict:
    """VGG16/224 f32 (full width, He weights from seed 0, buckets {1, 2,
    4, 8}) through the fault-tolerant ``ServingLoop`` on the card.

    Virtual clock: the reference benchmark's bursty trace, then the same
    trace under ``FaultPlan.random(seed)`` for two seeds (breaker
    threshold 2, so dispatches degrade to account-only): per-rid terminal
    states and attempts equal to the port's own account-only run of the
    same schedule on the CPU.  Real clock: ``run_sync``, then
    ``run_async(max_inflight=2)``, under ``LOOP_REAL_PLAN``: the breaker
    trips to account-only and recovers.  Every run passes
    ``_loop_checks``; returns K1's launches by route over the phase."""
    gen = torch.Generator().manual_seed(SEED)
    params = init_vgg(gen, device="cuda")
    graph = vgg_graph(params)
    sizes = [n for _, burst in LOOP_BURSTS for n in burst]
    images = [torch.randn((n, 224, 224, 3), generator=gen) for n in sizes]
    with torch.no_grad():
        plain = {rid: graph_logits(graph, params, x.cuda(), conv=conv2d_ref)
                 for rid, x in enumerate(images)}
    conv_ops.reset_fallback_counts()
    warm = ImageServer(params, 224, 224, graph=graph, device="cuda")
    warm.warm()
    total = dict.fromkeys(K.ROUTES, 0)
    rows = {}
    plans = [("bursty", lambda: FaultPlan(service_s=LOOP_SERVICE_S), {})]
    plans += [(f"random_{s}",
               lambda s=s: FaultPlan.random(s, service_s=LOOP_SERVICE_S),
               {"breaker_threshold": 2, "breaker_cooldown_s": 0.1})
              for s in LOOP_SEEDS]
    for name, plan, kw in plans:
        ref = _bursty(params, graph, "cpu", plan(), **kw)[0]
        _reset_k1()
        loop, tracer, results, clock = _bursty(params, graph, "cuda",
                                               plan(), images=images, **kw)
        k1 = _k1_counts()
        for rt, n in k1["by_route"].items():
            total[rt] += n
        row = _loop_checks(f"serve_loop {name}", loop, tracer, results,
                           k1, plain)
        got = {rid: (t.state.value, t.attempts)
               for rid, t in loop.requests.items()}
        want = {rid: (t.state.value, t.attempts)
                for rid, t in ref.requests.items()}
        require(got == want, f"serve_loop {name}: per-rid states and "
                             f"attempts differ from the account-only run")
        row.update(clock="virtual", same_as_account_only=True,
                   goodput_rps=row["done"] / clock.now,
                   p99_x_budget=row["p99_latency_ms"] / 1e3
                   / LOOP_DEADLINE_S)
        rows[name] = row
    for name in ("run_sync", "run_async"):
        tracer = Tracer()
        srv = ImageServer(params, 224, 224, graph=graph, device="cuda",
                          wait_budget=0.02, tracer=tracer)
        loop = ServingLoop(srv, deadline_s=None, breaker_threshold=2,
                           breaker_cooldown_s=0.01, max_inflight=2,
                           fault_plan=FaultPlan.parse(LOOP_REAL_PLAN),
                           seed=SEED)
        srv.warm()
        _reset_k1()
        t0 = time.perf_counter()
        results = []
        for x in images[:LOOP_REAL_REQUESTS]:
            loop.submit(x)
            if name == "run_sync":
                results += loop.pump()
        results += (loop.run_sync(tick_s=0.002) if name == "run_sync"
                    else asyncio.run(loop.run_async()))
        wall = time.perf_counter() - t0
        k1 = _k1_counts()
        for rt, n in k1["by_route"].items():
            total[rt] += n
        row = _loop_checks(f"serve_loop {name}", loop, tracer, results,
                           k1, plain)
        require(row["done"] == LOOP_REAL_REQUESTS and row["trips"] >= 1
                and row["recoveries"] >= 1 and loop.breaker.level == 0
                and row["degraded_dispatches"] >= 1,
                f"serve_loop {name}: the breaker did not trip to "
                f"account-only and recover: {row}")
        row.update(clock="real", wall_s=wall,
                   goodput_rps=row["done"] / wall)
        rows[name] = row
        print(srv.ledger.format_summary(), flush=True)
    for name, row in rows.items():
        emit({"phase": "serve_loop", "run": name, **row, "card": card})
    bursty, sync, asy = rows["bursty"], rows["run_sync"], rows["run_async"]
    emit({"phase": "serve_loop_summary", "card": card,
          "bursty_goodput_rps": bursty["goodput_rps"],
          "bursty_shed_frac": bursty["shed_frac"],
          "bursty_p99_x_budget": bursty["p99_x_budget"],
          "real_goodput_rps": {"run_sync": sync["goodput_rps"],
                               "run_async": asy["goodput_rps"]},
          "real_shed_frac": {"run_sync": sync["shed_frac"],
                             "run_async": asy["shed_frac"]},
          "real_p50_latency_ms": {"run_sync": sync["p50_latency_ms"],
                                  "run_async": asy["p50_latency_ms"]},
          "real_p99_latency_ms": {"run_sync": sync["p99_latency_ms"],
                                  "run_async": asy["p99_latency_ms"]},
          "dispatch_ms": {name: row["dispatch_ms"]
                          for name, row in rows.items()},
          "retries": {name: row["retries"] for name, row in rows.items()},
          "trips": {name: row["trips"] for name, row in rows.items()},
          "degraded_dispatches": {name: row["degraded_dispatches"]
                                  for name, row in rows.items()},
          "exec_fallbacks": {name: row["exec_fallbacks"]
                             for name, row in rows.items()}})
    return total


#: the ``trace`` phase's traced f32 dispatches of one bucket-8 group
TRACE_DISPATCHES = 3


def _children(tracer: Tracer) -> dict:
    """sid -> the records whose parent it is, in begin order."""
    out: dict[int, list] = {}
    for rec in tracer.records:
        out.setdefault(rec.parent, []).append(rec)
    return out


def _traced_dispatches(what: str, run: dict, dtype, n: int,
                       card: str) -> dict:
    """``n`` dispatches of ``run``'s first bucket-8 group (the ``vgg``
    or ``serve_bf16_vgg`` phase's weights, payloads and logits) under an
    active real-clock tracer: each one ``graph.forward`` under
    ``serve.execute``, 13 ``graph.layer`` spans in it and one
    ``kernel.conv2d_lb`` in each, with the port's own ``plan_conv``
    bytes and the card's time between CUDA events; K1's launches by
    route a dispatch the untraced ones.  Returns the per-layer rows
    (medians over the dispatches) and whether the logits kept their
    bits."""
    params, graph, images = run["params"], run["graph"], run["images"]
    group = run["group"]
    stages = graph_stages(graph, 224, 224)
    tracer = Tracer()
    srv = ImageServer(params, 224, 224, graph=graph, device="cuda",
                      dtype=dtype, tracer=tracer)
    with tracer.activate():
        # one traced dispatch first, then forgotten: the timed path's
        # plans and CUDA events exist before the measured ones
        for rid in group:
            srv.submit(images[rid])
        srv.drain()
        tracer.clear()
        _reset_k1()
        same = True
        for _ in range(n):
            of = {srv.submit(images[rid]): rid for rid in group}
            for r in srv.drain():
                same &= bool(torch.equal(r.logits, run["logits"][of[r.rid]]))
    k1 = _k1_counts()
    word = dtype.itemsize
    want_bytes, routes = [], []
    for p, st in zip(params["convs"], stages):
        nd = st.node
        pool = st.pool if st.fused_pool else 1
        plan = conv_ops.plan_conv(st.h, st.w, nd.ci, nd.co, nd.hk, nd.wk,
                                  batch=8, stride=(nd.stride,) * 2,
                                  padding=(nd.pad,) * 2, pool=pool,
                                  residual=st.residual, dtype_bytes=word)
        want_bytes.append(plan.traffic_bytes(8, word))
        x = torch.empty((8, st.h, st.w, nd.ci), dtype=dtype, device="cuda")
        routes.append(conv_route(x, p["w"], p.get("b"), None,
                                 stride=nd.stride, padding=nd.pad,
                                 pool=pool)[0])
    kids = _children(tracer)
    executes = tracer.find("serve.execute")
    require(len(executes) == n, f"{what}: {len(executes)} dispatches")
    per_layer = [[] for _ in stages]
    fwd_us, dev_sums = [], []
    for ex in executes:
        (fwd,) = [c for c in kids.get(ex.sid, [])
                  if c.name == "graph.forward"]
        layers = [c for c in kids.get(fwd.sid, [])
                  if c.name == "graph.layer"]
        require([sp.attrs["layer"] for sp in layers]
                == [st.node.name for st in stages],
                f"{what}: graph.layer spans {len(layers)}")
        dev = 0.0
        for i, sp in enumerate(layers):
            (kn,) = [c for c in kids.get(sp.sid, [])
                     if c.name == "kernel.conv2d_lb"]
            a = kn.attrs
            require(a["traffic_bytes"] == want_bytes[i],
                    f"{what}: {sp.attrs['layer']} traffic_bytes "
                    f"{a['traffic_bytes']} != plan_conv's {want_bytes[i]}")
            require(a["device_us"] > 0 and a["mode"] == "kernel",
                    f"{what}: {sp.attrs['layer']} {a}")
            dev += a["device_us"]
            per_layer[i].append(a)
        require(dev <= fwd.dur * 1e6, f"{what}: the layers' device time "
                                      f"{dev} us exceeds graph.forward's "
                                      f"{fwd.dur * 1e6} us")
        fwd_us.append(fwd.dur * 1e6)
        dev_sums.append(dev)
    want = dict.fromkeys(K.ROUTES, 0) | {
        rt: c * n for rt, c in SERVE_ROUTES["vgg", dtype].items()}
    require(k1["by_route"] == want and k1["stage"] == n
            and k1["launches"] == 13 * n,
            f"{what}: K1 {k1}, want {want} and {n} staging launches")

    def med(rows, key):
        return float(np.median([r[key] for r in rows]))

    rows = [{"layer": st.node.name, "route": rt,
             "traffic_bytes": want_bytes[i], "us": med(per_layer[i], "us"),
             "device_us": med(per_layer[i], "device_us"),
             "device_gbps": want_bytes[i] / med(per_layer[i], "device_us")
             / 1e3}
            for i, (st, rt) in enumerate(zip(stages, routes))]
    total_bytes = sum(want_bytes)
    out = {"phase": "trace_layers", "dtype": str(dtype), "bucket": 8,
           "dispatches": n, "group_rids": group, "rows": rows,
           "device_us_sum": dev_sums, "graph_forward_us": fwd_us,
           "serve_execute_us": [ex.attrs["us"] for ex in executes],
           "traffic_bytes_sum": total_bytes,
           "device_gbps_overall": [total_bytes / d / 1e3 for d in dev_sums],
           "k1_by_route": k1["by_route"], "k1_stage": k1["stage"],
           "logits_same_bits_as_untraced": same,
           "device_us_is": "CUDA events around one conv2d_lb call on a "
                           "stream the previous layer's wait left idle: "
                           "the call's kernels and its host work before "
                           "the first launch",
           "card": card}
    emit(out)
    return out


def phase_trace(card: str, vgg_run: dict, bf16_run: dict,
                train_vgg: dict) -> dict:
    """The traced path on the card.  (a) VGG16/224 f32 at bucket 8, the
    ``vgg`` phase's weights and payloads: ``TRACE_DISPATCHES`` dispatches
    under an active real-clock tracer, whose logits keep the untraced
    ``vgg`` phase's bits (K1 ``sm90_tf32`` sums each output word in one
    order); (b) one bf16 dispatch likewise; (c) one traced f32 VGG16/224
    batch-8 SGD step, whose loss is the untraced step 0's and whose K1
    and K2 launches are a ``train_vgg`` step's; (d)
    ``launch/serve_images.py --deadline 0.5 --fault-plan random:7
    --trace`` at VGG16/224: the trace file loads, its phases are X, i
    and M, one ``request.terminal`` per rid, and its ``done`` count is
    the metrics' ``serve_served``."""
    t0 = time.perf_counter()
    f32 = _traced_dispatches("trace f32", vgg_run, torch.float32,
                             TRACE_DISPATCHES, card)
    require(f32["logits_same_bits_as_untraced"],
            "trace f32: traced logits differ from the vgg phase's")
    bf16 = _traced_dispatches("trace bf16", bf16_run, torch.bfloat16, 1,
                              card)
    # (c) the step: the same weights and batch as train_vgg's
    gen = torch.Generator().manual_seed(SEED)
    graph, params = T.build_model("vgg", width_mult=1.0, n_classes=10,
                                  generator=gen, device="cuda")
    images, labels = T.make_batch(8, 224, 10, gen, "cuda")
    tracer = Tracer()
    _reset_k1()
    _reset_k2()
    with tracer.activate():
        (loss,) = T.train(graph, params, images, labels, steps=1,
                          lr=TRAIN_LR["vgg"])
    got = _k1_k2_launches()
    per_step = {k: {rt: c // TRAIN_STEPS for rt, c in train_vgg[k].items()}
                for k in ("conv_lb_by_route", "wgrad_lb_by_route")}
    (step,) = tracer.find("train.step")
    kernels = tracer.find("kernel.conv2d_lb")
    step_row = {"loss": loss, "untraced_loss_step0": train_vgg["losses"][0],
                "k1_by_route": got["conv_lb_by_route"],
                "k2_by_route": got["wgrad_lb_by_route"],
                "step_us": step.attrs["us"],
                "forward_layers": len(kernels),
                "forward_device_us": sum(k.attrs["device_us"]
                                         for k in kernels)}
    require(loss == train_vgg["losses"][0],
            f"trace step: loss {loss} != the untraced step 0's "
            f"{train_vgg['losses'][0]}")
    require(got["conv_lb_by_route"] == per_step["conv_lb_by_route"]
            and got["wgrad_lb_by_route"] == per_step["wgrad_lb_by_route"],
            f"trace step: launches {got} != a train_vgg step's {per_step}")
    require(len(kernels) == 13 and all(k.attrs["device_us"] > 0
                                       for k in kernels),
            f"trace step: {len(kernels)} timed forward layers")
    # (d) the serving CLI with --trace, real clock, on the card
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "serve.json"
        serve_images.main(["--deadline", "0.5", "--fault-plan", "random:7",
                           "--trace", str(path)])
        doc = json.loads(path.read_text())
        jsonl = [json.loads(line) for line in
                 Path(str(path) + ".jsonl").read_text().splitlines()]
    events = doc["traceEvents"]
    phases = {e["ph"] for e in events}
    terminals = [e for e in events if e["name"] == "request.terminal"]
    rids = sorted(e["args"]["rid"] for e in terminals)
    done = sum(e["args"]["state"] == "done" for e in terminals)
    served = doc["otherData"]["metrics"].get("serve_served", 0)
    cli = {"events": len(events), "jsonl_records": len(jsonl),
           "phases": sorted(phases), "requests": len(rids), "done": done,
           "serve_served": served,
           "layer_spans": sum(e["name"] == "graph.layer" for e in events),
           "dispatch_us": [e["args"]["us"] for e in events
                           if e["name"] == "serve.execute"]}
    require(phases <= {"X", "i", "M"}, f"trace cli: phases {phases}")
    require(rids == list(range(16)), f"trace cli: terminal rids {rids}")
    require(done == served, f"trace cli: {done} done, {served} served")
    require(cli["layer_spans"] == 0,
            "trace cli: a serving trace holds per-layer spans")
    row = {"phase": "trace", "f32_dispatch_device_us": f32["device_us_sum"],
           "f32_graph_forward_us": f32["graph_forward_us"],
           "bf16_dispatch_device_us": bf16["device_us_sum"],
           "bf16_logits_same_bits_as_untraced":
           bf16["logits_same_bits_as_untraced"],
           "step": step_row, "cli": cli,
           "seconds": time.perf_counter() - t0, "card": card}
    emit(row)
    return row


def _host_us(fn, calls: int = 20) -> float:
    """Mean host microseconds to enqueue one call of ``fn``, the stream
    held busy meanwhile (some 20 ms of spinning), so that the card's
    time is not in it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def phase_layers(card: str) -> list[dict]:
    """K1 per VGG16/224 layer at batch 8, f32 and bf16 (the same words
    rounded once), held against the plain version and timed beside its
    bound and ``F.conv2d`` (cuDNN, TF32 off) in the same type; also the
    host's time to enqueue one ``conv2d_lb`` call (``host_us``: at
    conv1_1 both of route ``sm90_im2col``'s enqueues, which is required
    there, with :func:`plane_fields`).  The f32 rows take the 3xTF32
    routes (required): ``bound_ms`` is their 3xTF32 bound,
    ``fma_bound_ms`` the FMA one, beside the FMA kernel's time and error
    on the same inputs (:func:`fma_fields`)."""
    batch = 8
    gen = torch.Generator().manual_seed(SEED)
    params = init_vgg(gen, device="cuda")
    graph = vgg_graph(params)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    rows = []
    for st, p in zip(graph_stages(graph, 224, 224), params["convs"]):
        node = st.node
        x32 = _randn(gen, batch, st.h, st.w, node.ci)
        b32 = _randn(gen, node.co, scale=0.1)
        pool = st.pool if st.fused_pool else 1
        kw = dict(stride=node.stride, padding=node.pad, relu=node.relu,
                  pool=pool)
        for dtype in DTYPES:
            x, w, b = (t.to(dtype) for t in (x32, p["w"], b32))
            x_nchw = x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            w_oihw = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            route, tile = conv_route(x, w, b, stride=node.stride,
                                     padding=node.pad, pool=pool)
            want = ("sm90_im2col" if node.ci == 3 else "sm90"
                    if dtype == torch.bfloat16 else "sm90_tf32")
            require(route == want, f"layer {node.name} {dtype}: on {route}, "
                                   f"want {want}")
            before = dict(K.conv_lb.launches_by_route)
            out = conv2d_lb(x, w, b, **kw)
            require(K.conv_lb.launches_by_route[route] == before[route] + 1,
                    f"layer {node.name} {dtype}: not on route {route}")
            ref = conv2d_ref(x, w, b, **kw)
            err, rel = rel_err(out.float(), ref.float())
            if dtype == torch.float32:
                gate = {"tol": TOL}
                require(rel <= TOL, f"layer {node.name}: kernel vs plain "
                                    f"{rel}")
            else:
                gate = within(out, ref, dtype)
                require(gate["worst_over_tol"] <= 1.0,
                        f"layer {node.name} {dtype}: {gate}")
            ms = _time_ms(lambda: conv2d_lb(x, w, b, **kw), flush)
            host_us = _host_us(lambda: conv2d_lb(x, w, b, **kw))
            plain_ms = _time_ms(lambda: conv2d_ref(x, w, b, **kw), flush)
            def library():
                return F.conv2d(x_nchw, w_oihw, b, stride=node.stride,
                                padding=node.pad)

            library_ms = _time_ms(library, flush)
            library_host_us = _host_us(library)
            flops = 2.0 * batch * st.ho * st.wo * node.co * node.ci * 9
            n_bytes = float(x.element_size() * (x.numel() + w.numel()
                                                + b.numel() + out.numel()))
            t_ops = ops_s(flops, dtype, route)
            t_bytes = n_bytes / HBM_BYTES_PER_S
            row = {"phase": "layers", "model": "vgg16", "layer": node.name,
                   "dtype": str(dtype), "batch": batch,
                   "in": [st.h, st.w, node.ci], "co": node.co,
                   "pool": pool, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   "bound_ms": max(t_ops, t_bytes) * 1e3,
                   "bound_by": "operations" if t_ops >= t_bytes
                   else "bytes", "flops": flops, "bytes": n_bytes,
                   "launches_per_dispatch": 1, "max_abs_err": err,
                   "max_abs_err_over_max_ref": rel, **gate,
                   "route": route, "tile": tile, "host_us": host_us,
                   "library_host_us": library_host_us, "card": card}
            if route == "sm90_im2col":
                row.update(plane_fields(x, w, n_bytes, flush))
            if dtype == torch.float32 or route == "sm90_im2col":
                row.update(fma_fields(x, w, b, pool, node.relu, ref, flush),
                           **fma_bound(flops, t_bytes))
            emit(row)
            rows.append(row)
    return rows


def ops_s(flops: float, dtype, route: str) -> float:
    """The least time the card takes for ``flops`` on the route's units:
    bf16 at the tensor cores' bf16 rate; f32 on the tensor cores as
    3xTF32 (three products a multiply-add at the TF32 rate), on FMA at
    the f32 rate."""
    if dtype == torch.bfloat16:
        return flops / PEAK_BF16_FLOPS
    if route == "fma":
        return flops / PEAK_F32_FLOPS
    return 3 * flops / PEAK_TF32_FLOPS


def fma_bound(flops: float, t_bytes: float) -> dict:
    """The FMA kernel's f32 bound beside a tensor-core row's."""
    t_ops = flops / PEAK_F32_FLOPS
    return {"fma_bound_ms": max(t_ops, t_bytes) * 1e3,
            "fma_bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def fma_fields(x, w, b, pool: int, relu: bool, ref,
               flush: torch.Tensor) -> dict:
    """K1's FMA kernel on the same inputs through its own launcher (a
    3x3, pad-1 conv: a VGG layer or its dgrad), its time, tile and error,
    gated like the route: f32 within ``TOL`` of max |plain| (``fma_err``
    that ratio), bf16 within the bf16 gate (``fma_err`` its worst |err|
    over tolerance)."""
    bsz, h, wd, _ = x.shape
    one = (1, 1)
    plan = K.cta_plan(bsz, h, wd, w.shape[-1], pool, 3, 3, one, one,
                      x.element_size())

    def fma():
        return K._fma(x, w, b, None, h, wd, one, one, one, one, relu, pool,
                      plan)

    out = fma()
    if x.dtype == torch.float32:
        abs_err, err = rel_err(out, ref)
        ok = err <= TOL
    else:
        gate = within(out, ref, x.dtype)
        abs_err, err = gate["max_abs_err"], gate["worst_over_tol"]
        ok = err <= 1.0
    require(ok, f"FMA kernel vs plain at {tuple(x.shape)} {x.dtype}: {err}")
    return {"fma_ms": _time_ms(fma, flush), "fma_err": err,
            "fma_max_abs_err": abs_err, "fma_tile": plan}


def plane_fields(x, w, n_bytes: float, flush: torch.Tensor) -> dict:
    """A 3x3, pad-1 conv's fields on route ``sm90_im2col``: the staging
    launch alone (its plane equal to the plain one bit for bit) beside
    its bound, and the bound with the plane's bytes (written once, read
    once)."""
    before = I.im2col_plane.stage_launches
    plane = I.im2col_plane(x, 3, 3, (1, 1))
    require(I.im2col_plane.stage_launches == before + 1,
            "im2col conv: no staging launch")
    require(torch.equal(plane, im2col_ref(x, 3, 3, padding=1,
                                          channels=plane.shape[-1])),
            "im2col conv: the plane differs from the plain one")
    plane_bytes = float(plane.numel() * plane.element_size())
    return {"stage_ms": _time_ms(lambda: I.im2col_plane(x, 3, 3, (1, 1)),
                                 flush),
            "stage_bound_ms": (x.numel() * x.element_size() + plane_bytes)
            / HBM_BYTES_PER_S * 1e3,
            "plane_bytes": plane_bytes,
            "plane_bound_ms": (n_bytes + 2 * plane_bytes)
            / HBM_BYTES_PER_S * 1e3}


# name, batch, (h, w), ci, co, k, stride, pad: the forward conv whose
# backward is checked
BWD_CHECKS = [
    ("vgg_3x3_s1_p1_conv4_b8", 8, (28, 28), 256, 512, 3, 1, 1),
    ("stride2_3x3_p1_b8", 8, (32, 32), 16, 32, 3, 2, 1),
    ("proj_1x1_s2_p0_b8", 8, (32, 32), 16, 32, 1, 2, 0),
    ("odd_plane_odd_channels_b3", 3, (15, 13), 7, 9, 3, 1, 1),
    ("odd_plane_s2_ci3_b2", 2, (15, 13), 3, 16, 3, 2, 1),
]
# wgrad only: the VGG layers with the longest and shortest reductions
WGRAD_ONLY = [
    ("vgg_conv1_1_b8", 8, (224, 224), 3, 64, 3, 1, 1),
    ("vgg_conv1_2_b8", 8, (224, 224), 64, 64, 3, 1, 1),
    ("vgg_conv5_3_b8", 8, (14, 14), 512, 512, 3, 1, 1),
]


def phase_check_bwd() -> float:
    """K1 in the dgrad geometry and K2 against their plain versions;
    the cropped dx also against the plain forward's autograd.  Returns
    K2's max abs error."""
    gen = torch.Generator().manual_seed(SEED + 1)
    worst = 0.0
    for (name, b, (h, w), ci, co, k, s, p) in BWD_CHECKS + WGRAD_ONLY:
        x = _randn(gen, b, h, w, ci)
        wt = _randn(gen, k, k, ci, co, scale=(k * k * ci) ** -0.5)
        ho = (h + 2 * p - k) // s + 1
        wo = (w + 2 * p - k) // s + 1
        gy = _randn(gen, b, ho, wo, co)
        row = {"phase": "check_bwd", "geometry": name}
        if (name, b, (h, w), ci, co, k, s, p) in BWD_CHECKS:
            # the dgrad conv itself: compact gy plane (+ one zero
            # row/col when strided), flipped weights, full padding
            gyp = F.pad(gy, (0, 0, 0, int(s > 1), 0, int(s > 1)))
            kw = dict(stride=1, padding=k - 1 - p, lhs_dilation=s)
            wf = flip_w(wt)
            route, tile = conv_route(gyp, wf, **kw)
            before = dict(K.conv_lb.launches_by_route)
            out = conv2d_lb(gyp, wf, **kw)
            ref = conv2d_ref(gyp, wf, **kw)
            torch.cuda.synchronize()
            launched = {r: K.conv_lb.launches_by_route[r] - before[r]
                        for r in before}
            require(launched == dict.fromkeys(K.ROUTES, 0) | {route: 1},
                    f"check_bwd {name}: dgrad launches {launched}, route "
                    f"{route}")
            require(out.shape == ref.shape, f"check_bwd {name}: dgrad "
                    f"shape {tuple(out.shape)} != {tuple(ref.shape)}")
            err, rel = rel_err(out, ref)
            require(rel <= TOL, f"check_bwd {name}: dgrad kernel vs "
                                f"plain {rel} > {TOL}")
            # the cropped dx against the plain forward's autograd
            args = ConvArgs(stride=(s, s), padding=(p, p),
                            dilation=(1, 1), lhs_dilation=(1, 1),
                            groups=1, relu=False, pool=1)
            gx = dgrad_lb(gy, wt, args, h, w)
            xg = x.clone().requires_grad_(True)
            (want,) = torch.autograd.grad(
                conv2d_ref(xg, wt, stride=s, padding=p), xg, gy)
            gerr, grel = rel_err(gx, want)
            require(gx.shape == want.shape and grel <= TOL,
                    f"check_bwd {name}: dx vs plain autograd {grel}")
            row.update(dgrad_shape=list(out.shape), dgrad_max_abs_err=err,
                       dgrad_max_abs_err_over_max_ref=rel,
                       dx_vs_autograd_over_max_ref=grel, dgrad_tol=TOL,
                       dgrad_route=route, dgrad_tile=tile,
                       dgrad_launches_by_route=launched)
        geom = W.WgradGeometry(hk=k, wk=k, stride=(s, s), padding=(p, p))
        dw, rt, plan = wgrad_launch(x, gy, geom, f"check_bwd {name}")
        want_rt = want_wgrad_route(torch.float32, ci, co, k, s)
        require(rt == want_rt, f"check_bwd {name}: f32 wgrad on {rt}, "
                               f"want {want_rt}")
        dw_ref = wgrad_ref(x, gy, k, k, stride=s, padding=p)
        torch.cuda.synchronize()
        require(dw.shape == dw_ref.shape, f"check_bwd {name}: wgrad shape")
        err, rel = rel_err(dw, dw_ref)
        require(rel <= WGRAD_TOL, f"check_bwd {name}: wgrad kernel vs "
                                  f"plain {rel} > {WGRAD_TOL}")
        worst = max(worst, err)
        row.update(wgrad_shape=list(dw.shape), wgrad_max_abs_err=err,
                   wgrad_max_abs_err_over_max_ref=rel, wgrad_route=rt,
                   wgrad_plan=plan, wgrad_tol=WGRAD_TOL)
        # bf16: K2 sums the same bf16 words as the plain version in f32
        # (WGRAD_TOL), on sm90 where the stride is 1 and TMA describes
        # the channels, through the im2col plane where the taps fit it;
        # K1's dgrad rounds once (bf16 gate)
        xb, gyb = x.to(torch.bfloat16), gy.to(torch.bfloat16)
        dwb, brt, bplan = wgrad_launch(xb, gyb, geom,
                                       f"check_bwd {name} bf16")
        _, brel = rel_err(dwb, wgrad_ref(xb, gyb, k, k, stride=s,
                                         padding=p))
        require(dwb.dtype == torch.float32 and brel <= WGRAD_TOL,
                f"check_bwd {name}: bf16 wgrad {dwb.dtype} {brel}")
        want_rt = want_wgrad_route(torch.bfloat16, ci, co, k, s)
        require(brt == want_rt, f"check_bwd {name}: bf16 wgrad on {brt}, "
                                f"want {want_rt}")
        row.update(wgrad_bf16_max_abs_err_over_max_ref=brel,
                   wgrad_bf16_route=brt, wgrad_bf16_plan=bplan,
                   wgrad_bf16_host_us=_host_us(
                       lambda: W.wgrad_lb(xb, gyb, geom)))
        if (name, b, (h, w), ci, co, k, s, p) in BWD_CHECKS:
            gypb, wfb = gyp.to(torch.bfloat16), wf.to(torch.bfloat16)
            gate = within(conv2d_lb(gypb, wfb, **kw),
                          conv2d_ref(gypb, wfb, **kw), torch.bfloat16)
            require(gate["worst_over_tol"] <= 1.0,
                    f"check_bwd {name}: bf16 dgrad {gate}")
            row.update(dgrad_bf16=gate)
        emit(row)
    check_wgrad_sm90_control(gen)
    check_wgrad_tf32_control(gen)
    check_wgrad_im2col_control(gen)
    check_library_bwd(gen)
    return worst


# name, batch, plane, ci, co: VGG16/224 layers at batch 8 on which a
# fault of K2's sm90 kernel is shown to fail WGRAD_TOL
WGRAD_SM90_CONTROLS = [("conv3_2", 8, 56, 256, 256),
                       ("conv5_3", 8, 14, 512, 512)]


def check_wgrad_sm90_control(gen) -> None:
    """K2's sm90 kernel with one fault of its own: the centre window
    (1, 1) reads the halo one row off (its shift passed one halo row too
    far).  The right launch passes ``WGRAD_TOL``; the faulty one must
    fail it by more than 10x."""
    bf = torch.bfloat16
    geom = W.WgradGeometry(hk=3, wk=3, padding=(1, 1))
    for name, b, h, ci, co in WGRAD_SM90_CONTROLS:
        x = _randn(gen, b, h, h, ci).to(bf)
        gy = _randn(gen, b, h, h, co).to(bf)
        right, rt, plan = wgrad_launch(x, gy, geom, f"control {name}")
        require(rt == "sm90", f"control wgrad sm90 {name}: route {rt}")
        p = W.sm90_wgrad_plan(b, h, h, ci, co, 3, 3, (1, 1))
        off = list(p.win_off)
        off[4] += p.sbo
        wrong = W._sm90(x, gy, geom, dataclasses.replace(
            p, win_off=tuple(off)))
        plain = wgrad_ref(x, gy, 3, 3, padding=1)
        torch.cuda.synchronize()
        _, rel = rel_err(right, plain)
        _, wrel = rel_err(wrong, plain)
        emit({"phase": "check_bwd", "geometry":
              f"wgrad_sm90_control_{name}_b{b}", "dtype": str(bf),
              "route": rt, "plan": plan,
              "max_abs_err_over_max_ref": rel, "tol": WGRAD_TOL,
              "control": {"what": "centre window reads the halo one row "
                                  "off", "max_abs_err_over_max_ref": wrel,
                          "over_tol": wrel / WGRAD_TOL}})
        require(rel <= WGRAD_TOL, f"control wgrad sm90 {name}: the right "
                                  f"launch {rel}")
        require(wrel > 10 * WGRAD_TOL, f"control wgrad sm90 {name}: the "
                f"faulty launch {wrel} fails the gate by less than 10x")


# name, batch, plane, ci, co: VGG16/224 layers at batch 8 on which the
# 3xTF32 kernel's lo terms are shown to matter
WGRAD_TF32_CONTROLS = [("conv1_2", 8, 224, 64, 64),
                       ("conv5_3", 8, 14, 512, 512)]


def check_wgrad_tf32_control(gen) -> None:
    """K2's 3xTF32 kernel with its lo words dropped (1xTF32, one launch
    of the same plan): the route passes ``WGRAD_TOL``; 1xTF32 must err
    at least 4x more on the same inputs (the small terms are real)."""
    geom = W.WgradGeometry(hk=3, wk=3, padding=(1, 1))
    for name, b, h, ci, co in WGRAD_TF32_CONTROLS:
        x = _randn(gen, b, h, h, ci)
        gy = _randn(gen, b, h, h, co)
        right, rt, plan = wgrad_launch(x, gy, geom, f"control {name}")
        require(rt == "sm90_tf32", f"control wgrad tf32 {name}: route {rt}")
        p = W.plan_of(x, gy, geom)[1]
        one = W._sm90_tf32(x, gy, geom, p, lo_terms=False)
        plain = wgrad_ref(x, gy, 3, 3, padding=1)
        torch.cuda.synchronize()
        _, rel = rel_err(right, plain)
        _, wrel = rel_err(one, plain)
        emit({"phase": "check_bwd", "geometry":
              f"wgrad_tf32_control_{name}_b{b}", "dtype": "torch.float32",
              "route": rt, "plan": plan, "max_abs_err_over_max_ref": rel,
              "tol": WGRAD_TOL,
              "control": {"what": "1xTF32: the lo words dropped",
                          "max_abs_err_over_max_ref": wrel,
                          "over_route": wrel / max(rel, 1e-30),
                          "over_tol": wrel / WGRAD_TOL}})
        require(rel <= WGRAD_TOL, f"control wgrad tf32 {name}: the route "
                                  f"{rel}")
        require(wrel >= 4 * rel, f"control wgrad tf32 {name}: 1xTF32 errs "
                f"{wrel}, under 4x the route's {rel}")


def check_wgrad_im2col_control(gen) -> None:
    """K2's im2col route with one fault of its own: the centre tap read
    one column off (its offset passed one too far), at VGG16's conv1_1,
    batch 8, in f32 and bf16.  The right launch passes ``WGRAD_TOL``;
    the faulty one must fail it by more than 10x."""
    geom = W.WgradGeometry(hk=3, wk=3, padding=(1, 1))
    x32 = _randn(gen, 8, 224, 224, 3)
    gy32 = _randn(gen, 8, 224, 224, 64)
    for dtype in DTYPES:
        x, gy = x32.to(dtype), gy32.to(dtype)
        right, rt, plan = wgrad_launch(x, gy, geom, "control im2col")
        require(rt == "sm90_im2col", f"control im2col {dtype}: route {rt}")
        p = W.plan_of(x, gy, geom)[1]
        taps = list(p.taps)
        taps[4] = (taps[4][0], taps[4][1] + 1)
        wrong = W._im2col_wgrad(x, gy, geom,
                                dataclasses.replace(p, taps=tuple(taps)))
        plain = wgrad_ref(x, gy, 3, 3, padding=1)
        torch.cuda.synchronize()
        _, rel = rel_err(right, plain)
        _, wrel = rel_err(wrong, plain)
        emit({"phase": "check_bwd", "geometry": "wgrad_im2col_control_"
              "conv1_1_b8", "dtype": str(dtype), "route": rt, "plan": plan,
              "max_abs_err_over_max_ref": rel, "tol": WGRAD_TOL,
              "control": {"what": "the centre tap one column off",
                          "max_abs_err_over_max_ref": wrel,
                          "over_tol": wrel / WGRAD_TOL}})
        require(rel <= WGRAD_TOL, f"control im2col {dtype}: the right "
                                  f"launch {rel}")
        require(wrel > 10 * WGRAD_TOL, f"control im2col {dtype}: the "
                f"faulty launch {wrel} fails the gate by less than 10x")


def check_bwd_bf16() -> dict:
    """One bf16 backward through the kernels (``conv2d_lb``'s autograd:
    K1's recompute and dgrad, K2's wgrad) at a VGG16 conv4 shape with a
    bias and no ReLU or pool (no discrete choice to flip between the
    two), held to the plain version's autograd at the bf16 gate: both
    sum in f32 and round each gradient once to bf16.  Returns the
    launches of the backward (K2's also by route: it must take sm90)."""
    gen = torch.Generator().manual_seed(SEED + 8)
    x = _randn(gen, 8, 28, 28, 256).to(torch.bfloat16)
    w = _randn(gen, 3, 3, 256, 512, scale=(9 * 256) ** -0.5).to(
        torch.bfloat16)
    bias = _randn(gen, 512).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    out = conv2d_lb(*leaves, padding=1)
    gy = _randn(gen, *out.shape).to(torch.bfloat16)
    K.conv_lb.launches = 0
    K.conv_lb.launches_by_route = dict.fromkeys(K.ROUTES, 0)
    W.wgrad_lb.launches = 0
    W.wgrad_lb.launches_by_route = dict.fromkeys(W.ROUTES, 0)
    got = torch.autograd.grad(out, leaves, gy)
    torch.cuda.synchronize()
    launches = {"conv_lb": K.conv_lb.launches,
                "wgrad_lb": W.wgrad_lb.launches}
    by_route = dict(K.conv_lb.launches_by_route)
    wgrad_by_route = dict(W.wgrad_lb.launches_by_route)
    plain = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    want = torch.autograd.grad(conv2d_ref(*plain, padding=1), plain, gy)
    rows = {n: within(a, b, torch.bfloat16)
            for n, a, b in zip(("dx", "dw", "db"), got, want)}
    emit({"phase": "check_bwd", "geometry": "bf16_conv4_b8",
          "dtypes": [str(t.dtype) for t in got], "launches": launches,
          "conv_lb_launches_by_route": by_route,
          "wgrad_lb_launches_by_route": wgrad_by_route, **rows})
    require(all(t.dtype == torch.bfloat16 for t in got),
            f"check_bwd bf16: gradient types {[t.dtype for t in got]}")
    # recompute + dgrad on K1 (both on its sm90 kernel), wgrad on K2
    require(launches == {"conv_lb": 2, "wgrad_lb": 1},
            f"check_bwd bf16: launches {launches}")
    require(by_route == dict.fromkeys(K.ROUTES, 0) | {"sm90": 2},
            f"check_bwd bf16: K1 launches by route {by_route}")
    require(wgrad_by_route == dict.fromkeys(W.ROUTES, 0) | {"sm90": 1},
            f"check_bwd bf16: K2 launches by route {wgrad_by_route}")
    for n, r in rows.items():
        require(r["worst_over_tol"] <= 1.0, f"check_bwd bf16 {n}: {r}")
    return launches | {"wgrad_lb_by_route": wgrad_by_route}


# name, forward kwargs, the (K1, K2) launches of the backward, the
# tally it adds: where the reference routes to lax the port routes to
# the library rung (cuDNN), loudly; the padding past full keeps its
# recompute on K1 and its wgrad on K2
LIBRARY_BWD = [
    ("lhs_dilated_b2", dict(padding=2, lhs_dilation=2, relu=True), (0, 0),
     {"bwd": 1}),
    ("padding_past_full_b2", dict(padding=3, relu=True), (1, 1),
     {"dgrad": 1}),
]


def check_library_bwd(gen) -> None:
    for name, kw, launches, tally in LIBRARY_BWD:
        x = _randn(gen, 2, 9, 9, 8)
        w = _randn(gen, 3, 3, 8, 16, scale=(9 * 8) ** -0.5)
        bias = _randn(gen, 16)
        leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
        out = conv2d_lb(*leaves, **kw)
        gy = torch.randn(out.shape, generator=gen).cuda()
        conv_ops.reset_fallback_counts()
        k1, k2 = K.conv_lb.launches, W.wgrad_lb.launches
        got = torch.autograd.grad(out, leaves, gy)
        torch.cuda.synchronize()
        ran = (K.conv_lb.launches - k1, W.wgrad_lb.launches - k2)
        counts = conv_ops.exec_fallback_counts()
        plain = [t.clone().requires_grad_(True) for t in (x, w, bias)]
        want = torch.autograd.grad(conv2d_ref(*plain, **kw), plain, gy)
        rels = [rel_err(a, b)[1] for a, b in zip(got, want)]
        emit({"phase": "check_bwd", "geometry": name,
              "route": "library rung (cuDNN)", "fallback_tally": counts,
              "kernel_launches_k1_k2": list(ran),
              "grad_max_abs_err_over_max_plain": rels, "tol": TOL})
        require(counts == tally, f"check_bwd {name}: tally {counts} != "
                                 f"{tally}")
        require(ran == launches, f"check_bwd {name}: K1/K2 launches {ran} "
                                 f"!= {launches}")
        require(max(rels) <= TOL, f"check_bwd {name}: grads vs plain "
                                  f"autograd {max(rels)} > {TOL}")


def control(what: str, wrong: torch.Tensor, plain: torch.Tensor,
            dtype) -> dict:
    """A deliberately wrong result held to the same gate: it must fail
    it, or the gate could not see that fault."""
    row = within(wrong, plain, dtype)
    require(row["worst_over_tol"] > 1.0,
            f"control {what} {dtype} passes the gate: {row}")
    return {"what": what, "worst_over_tol": row["worst_over_tol"],
            "max_abs_err": row["max_abs_err"]}


def matmul_control(x: torch.Tensor, w: torch.Tensor, chunk: int):
    """What K3 would give with one fault of its type: in bf16, the
    accumulator held in bf16 across the K sweep (rounded after every
    ``chunk`` of K); in f32, the product on TF32 tensor cores (the
    operands' mantissas cut to 10 bits)."""
    if x.dtype == torch.float32:
        def tf32(t):
            return (t.view(torch.int32) & -8192).view(torch.float32)
        return ("tf32 operands", tf32(x) @ tf32(w))
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=x.dtype,
                      device=x.device)
    for k0 in range(0, x.shape[1], chunk):
        acc = (acc.float() + x[:, k0:k0 + chunk].float()
               @ w[k0:k0 + chunk].float()).to(x.dtype)
    return (f"bf16 accumulator, rounded every {chunk} of K", acc)


MATMUL_SWEEP = [(64, 64, 64), (128, 256, 128), (300, 200, 150),
                (1000, 333, 77), (8, 8, 8), (257, 129, 511)]
#: beside the sweep, for the tensor-core kernels (sm90 in bf16,
#: sm90_tf32 in f32): a ragged edge in every dimension and a long K,
#: whose rows TMA can describe.  In f32 ``w`` is scaled by 1/sqrt(K), as
#: a projection's is: with unscaled N(0, 1) words at a K in the thousands
#: the sums cancel so far that two f32 orders of them, the plain
#: version's among them, approach the f32 gate from the float64 product
#: (``launch/tf32_promote.py --unscaled``)
MATMUL_EXTRA = [(1000, 328, 88), (520, 4104, 392)]
#: sweep shapes whose gate is also shown to fail a wrong result
MATMUL_CONTROLS = ((1000, 333, 77), (257, 129, 511))
#: the K depth K3 stages per step (``kBK`` in matmul_lb.cu)
MATMUL_K_STEP = 16


def phase_check_matmul() -> dict:
    """Every shape and type of the reference's matmul sweep through
    ``matmul_lb`` on the card, against the plain version (the path of
    the shapes TMA cannot describe, on ``fma``).  Returns the launches
    by route of the phase."""
    gen = torch.Generator().manual_seed(SEED + 3)
    K3.matmul_lb.launches_by_route = dict.fromkeys(K3.ROUTES, 0)
    for dtype in DTYPES:
        for m, k, n in MATMUL_SWEEP:
            x = _randn(gen, m, k).to(dtype)
            w = _randn(gen, k, n).to(dtype)
            before = K3.matmul_lb.launches
            route = K3.route(x, w)
            out = matmul_lb(x, w)
            torch.cuda.synchronize()
            launched = K3.matmul_lb.launches - before
            plain = matmul_ref(x, w)
            row = within(out, plain, dtype)
            if (m, k, n) in MATMUL_CONTROLS:
                row["control"] = control(*matmul_control(x, w, 1),
                                         plain, dtype)
            emit({"phase": "check_matmul", "shape": [m, k, n],
                  "dtype": str(dtype), "launches": launched, **row,
                  "route": route, "layout": "n-major"})
            require(launched == 1, f"check_matmul {m}x{k}x{n}: "
                                   f"{launched} launches")
            require(out.dtype == dtype and out.shape == (m, n),
                    f"check_matmul {m}x{k}x{n}: {out.dtype} {out.shape}")
            require(row["worst_over_tol"] <= 1.0,
                    f"check_matmul {m}x{k}x{n} {dtype}: {row}")
    check_matmul_layouts(gen)
    return dict(K3.matmul_lb.launches_by_route)


def check_matmul_layouts(gen) -> None:
    """The sweep with ``w`` K-major (``w.t()`` of a contiguous
    ``(N, K)``) and the extra shapes in both layouts, in both types:
    each row with its route and the copies it made; a product whose rows
    TMA describes must take ``sm90`` in bf16 and ``sm90_tf32`` in
    f32."""
    extra = [(sh, layout) for sh in MATMUL_EXTRA
             for layout in ("k-major", "n-major")]
    for dtype in DTYPES:
        for (m, k, n), layout in (
                [(sh, "k-major") for sh in MATMUL_SWEEP] + extra):
            x = _randn(gen, m, k).to(dtype)
            f32_extra = (dtype == torch.float32
                         and (m, k, n) in MATMUL_EXTRA)
            w = _randn(gen, k, n, scale=k ** -0.5 if f32_extra
                       else 1.0).to(dtype)
            if layout == "k-major":
                w = w.t().contiguous().t()
            route = K3.route(x, w)
            elt = x.element_size()
            tma = (elt * k) % 16 == 0 and (
                layout == "k-major" or (elt * n) % 16 == 0)
            tc = "sm90" if dtype == torch.bfloat16 else "sm90_tf32"
            before = dict(K3.matmul_lb.launches_by_route)
            copies = K3.matmul_lb.copies
            out = matmul_lb(x, w)
            torch.cuda.synchronize()
            launched = {r: K3.matmul_lb.launches_by_route[r] - before[r]
                        for r in before}
            plain = matmul_ref(x, w)
            row = within(out, plain, dtype)
            if (m, k, n) in MATMUL_EXTRA:
                row["control"] = control(*matmul_control(x, w, 1),
                                         plain, dtype)
            emit({"phase": "check_matmul", "shape": [m, k, n],
                  "dtype": str(dtype), "layout": layout, "route": route,
                  "launches_by_route": launched,
                  "copies": K3.matmul_lb.copies - copies, **row})
            where = f"check_matmul {m}x{k}x{n} {dtype} {layout}"
            require(route == (tc if tma else "fma"),
                    f"{where}: route {route}")
            # the FMA kernel takes a K-major w by one counted copy
            require(K3.matmul_lb.copies - copies
                    == int(route == "fma" and layout == "k-major"),
                    f"{where}: {K3.matmul_lb.copies - copies} copies")
            require(launched == dict.fromkeys(K3.ROUTES, 0) | {route: 1},
                    f"{where}: launches {launched}")
            require(out.dtype == dtype and out.shape == (m, n),
                    f"{where}: {out.dtype} {out.shape}")
            require(row["worst_over_tol"] <= 1.0, f"{where}: {row}")


def plain_budget() -> int:
    """The f32 scores :func:`plain_attention` holds at once: 4 GiB, or
    an eighth of the card's free memory (with what the caching allocator
    holds unused) where that is less.  The plain version holds its
    scores about three times over; beside llava's 68.8 GB of weights
    the card has some 15 GB left."""
    free, _ = torch.cuda.mem_get_info()
    unused = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    return min(4 << 30, (free + unused) // 8)


def plain_attention(q, k, v, *, window: int, causal: bool
                    ) -> torch.Tensor:
    """The plain version on (B, S, H, hd) tensors, run kv head group by
    kv head group so that no call's f32 scores exceed
    :func:`plain_budget`; a group whose own scores exceed it (granite's
    48 query heads on one kv head) a part of its query heads a call; a
    query head whose own scores exceed it (32768 or more keys) one head
    a call, in panels of query rows over only the keys their masks
    leave (:func:`attention_plain_panel`)."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf, kf, vf = (heads_first(t) for t in (q, k, v))
    max_bytes = plain_budget()
    per_head = 4 * sq * skv
    if g * per_head <= max_bytes:
        step = max_bytes // (g * per_head)
        outs = [attention_plain(qf[i * g:(i + step) * g], kf[i:i + step],
                                vf[i:i + step], groups=g, window=window,
                                causal=causal)
                for i in range(0, b * kv, step)]
    elif per_head <= max_bytes:
        part = max(1, max_bytes // per_head)
        outs = [attention_plain(qf[i * g + j:i * g + min(j + part, g)],
                                kf[i:i + 1], vf[i:i + 1],
                                groups=min(j + part, g) - j, window=window,
                                causal=causal)
                for i in range(b * kv) for j in range(0, g, part)]
    else:
        rows = max(1, max_bytes // (4 * skv))
        outs = [torch.cat([attention_plain_panel(
            qf[i:i + 1, r:r + rows], kf[i // g:i // g + 1],
            vf[i // g:i // g + 1], row0=r, groups=1, window=window,
            causal=causal) for r in range(0, sq, rows)], dim=1)
            for i in range(b * h)]
    return torch.cat(outs).reshape(b, h, sq, hd).transpose(1, 2)


def panel_rows(sq: int, rows: int = 128) -> list[tuple[int, int]]:
    """The query panels a long attention is held to, fixed before any
    run: the first ``rows`` rows, the ``rows`` around the middle and the
    last ``rows`` (``(row0, rows)``; one panel where Sq is that short)."""
    if sq <= rows:
        return [(0, sq)]
    return sorted({(0, rows), (sq // 2 - rows // 2, rows),
                   (sq - rows, rows)})


def panel_cut(t: torch.Tensor, panels) -> torch.Tensor:
    """The panels' rows of (B, S, H, hd) ``t``, in order, heads-first
    (B*H, rows, hd) as :func:`plain_panels` gives them."""
    return torch.cat([heads_first(t[:, r:r + n]) for r, n in panels], dim=1)


def plain_panels(q, k, v, *, window: int, causal: bool, panels,
                 row_off: int = 0) -> tuple[torch.Tensor, int]:
    """The plain version of the panels' rows of every head of (B, S, H,
    hd) q against k, v (:func:`attention_plain_panel`, a kv head group a
    call, its query heads split where their scores exceed
    :func:`plain_budget`), heads-first (B*H, rows, hd) as
    :func:`panel_cut` lays them out, and the rows a head.
    ``row_off``: the control, the masks read ``row_off`` rows off."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    kf, vf = (heads_first(t) for t in (k, v))
    max_bytes = plain_budget()
    outs = []
    for r0, n in panels:
        qp = heads_first(q[:, r0:r0 + n])
        lo, hi = K4_REF.key_span(r0 + row_off, n, k.shape[1], window,
                                 causal)
        part = max(1, min(g, max_bytes // max(1, 4 * n * (hi - lo))))
        outs.append(torch.cat([attention_plain_panel(
            qp[i * g + j:i * g + min(j + part, g)], kf[i:i + 1],
            vf[i:i + 1], row0=r0 + row_off, groups=min(j + part, g) - j,
            window=window, causal=causal)
            for i in range(b * kv) for j in range(0, g, part)]))
    return torch.cat(outs, dim=1), sum(n for _, n in panels)


# b, sq, skv, h, kv, hd, window, causal: the reference's sweep and a
# row with no unmasked key (q >= 20 + 8 - 1)
ATTN_SWEEP = [
    (2, 64, 64, 4, 2, 16, 0, True),
    (1, 100, 100, 8, 8, 32, 0, True),
    (2, 128, 128, 4, 1, 16, 32, True),
    (1, 48, 80, 4, 4, 16, 0, False),
    (1, 33, 65, 2, 1, 8, 16, True),
    (1, 64, 20, 2, 1, 16, 8, True),
]
#: head dims the kernels pad to their next width (80, 96: their own
#: width; 256: one K/V stage in f32, one consumer warpgroup on sm90;
#: 20: bf16 TMA cannot describe, so fma) and those above 256, which the
#: FMA kernel runs as 256-column chunks
ATTN_HEAD_DIMS = [
    (1, 150, 150, 4, 2, 80, 0, True),
    (1, 130, 130, 4, 1, 96, 32, True),
    (1, 100, 100, 2, 1, 256, 0, True),
    (1, 90, 90, 2, 1, 20, 16, True),
    (1, 70, 70, 2, 1, 320, 0, True),
    (1, 130, 100, 4, 2, 512, 16, True),
]
#: long enough (32 key tiles a row) that an output accumulator rounded
#: to bf16 once per key tile shows above the gate
ATTN_LONG = [
    (1, 2048, 2048, 4, 2, 128, 0, False),
    (1, 2048, 2048, 2, 2, 64, 0, False),
]
#: llava-next-34b's decode shape: 56 query heads over 8 kv heads, a
#: group of 7, which is not a power of two
ATTN_LLAVA_DECODE = (4, 1, 128, 56, 8, 128, 0, False)
#: the LM path's decode shapes (phi3-medium-14b at batch 4: one query
#: row against 1, 37 and 128 kept cache slots, no causal mask;
#: mixtral-8x7b's: 32 heads over 8 kv heads against 128 slots;
#: granite-34b's: 48 query heads on one kv head; and llava's)
ATTN_DECODE = [
    (4, 1, 1, 40, 10, 128, 0, False),
    (4, 1, 37, 40, 10, 128, 0, False),
    (4, 1, 128, 40, 10, 128, 0, False),
    (4, 1, 128, 32, 8, 128, 0, False),
    (4, 1, 128, 48, 1, 128, 0, False),
    ATTN_LLAVA_DECODE,
]
#: whisper-medium's encoder (1500 frames, non-causal) and
#: cross-attention decode shapes: 1500 is a multiple of no K4 tile, so
#: the last query and key tiles are ragged
ATTN_ENCDEC = [
    (1, 1500, 1500, 16, 16, 64, 0, False),
    (4, 1, 1500, 16, 16, 64, 0, False),
]
#: minitron-4b's training shapes (24 heads over 8 at head dim 128,
#: causal): the reference driver's 8 x 128 and the long step's 1 x 4096
ATTN_TRAIN = [
    (8, 128, 128, 24, 8, 128, 0, True),
    (1, 4096, 4096, 24, 8, 128, 0, True),
]
#: the reference's plain chunked attention pads the keys to a multiple
#: of its chunk (whisper's ``attn_chunk``) and lets a non-causal query
#: see the zero pad keys
ATTN_PAD_CHUNK = 1024


def tile_ranges(sq: int, skv: int, window: int, causal: bool,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """Each query row's visited key tiles ``[lo, hi)``: its 64-row query
    tile's :func:`K4.key_tile_range` (both kernels skip on 64 x 64
    tiles)."""
    lo = torch.empty(sq, dtype=torch.long)
    hi = torch.empty(sq, dtype=torch.long)
    for q0 in range(0, sq, K4.BQ):
        lo[q0:q0 + K4.BQ], hi[q0:q0 + K4.BQ] = K4.key_tile_range(
            q0, min(q0 + K4.BQ, sq), skv, window, causal, K4.BKV)
    return lo.to(device), hi.to(device)


def attention_fault(q, k, v, *, groups: int, window: int, causal: bool,
                    fault: str) -> torch.Tensor:
    """What K4 would give with one fault of its kind, on heads-first
    ``(B*H, S, hd)`` tensors: the kernels' tiled online softmax in f32
    over the visited key tiles, with ``fault`` ``"drop"`` (every query
    tile stops one visited key tile early) or ``"round_o"`` (the output
    sums rounded to bf16 after every key tile)."""
    bh, sq, hd = q.shape
    skv = k.shape[1]
    lo, hi = tile_ranges(sq, skv, window, causal, q.device)
    if fault == "drop":
        hi = torch.maximum(lo, hi - 1)
    qf = q.float()
    kx = k.float().repeat_interleave(groups, dim=0)
    vx = v.float().repeat_interleave(groups, dim=0)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((bh, sq, 1), -float("inf"), device=q.device)
    l = torch.zeros((bh, sq, 1), device=q.device)
    o = torch.zeros((bh, sq, hd), device=q.device)
    for t in range(-(-skv // K4.BKV)):
        rows = ((lo <= t) & (t < hi))[None, :, None]
        if not bool(rows.any()):
            continue
        k0, k1 = t * K4.BKV, min((t + 1) * K4.BKV, skv)
        k_pos = torch.arange(k0, k1, device=q.device)[None, :]
        keep = torch.ones((sq, k1 - k0), dtype=torch.bool, device=q.device)
        if causal:
            keep &= k_pos <= q_pos
        if window:
            keep &= k_pos > q_pos - window
        sc = torch.bmm(qf, kx[:, k0:k1].transpose(1, 2)) * hd ** -0.5
        sc = sc.masked_fill(~keep, -1e30)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        o_new = o * alpha + torch.bmm(p, vx[:, k0:k1])
        if fault == "round_o":
            o_new = o_new.to(torch.bfloat16).float()
        m = torch.where(rows, m_new, m)
        l = torch.where(rows, l_new, l)
        o = torch.where(rows, o_new, o)
    return (o / l.clamp_min(1e-30)).to(q.dtype)


def _fault(q, k, v, *, window: int, causal: bool, fault: str):
    """:func:`attention_fault` on (B, S, H, hd) tensors."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    out = attention_fault(*(heads_first(t) for t in (q, k, v)),
                          groups=h // kv, window=window, causal=causal,
                          fault=fault)
    return out.reshape(b, h, sq, hd).transpose(1, 2)


def attention_routes(q: torch.Tensor, hd: int) -> tuple[str, ...]:
    """The routes that take inputs of ``q``'s type at head dim ``hd``:
    the tensor-core route of its type where its width takes ``hd``, and
    ``fma``, which takes every input."""
    if q.dtype == torch.bfloat16 and K4.sm90_head_dim(hd) is not None:
        return ("sm90", "fma")
    if q.dtype == torch.float32 and K4.sm90_tf32_head_dim(hd) is not None:
        return ("sm90_tf32", "fma")
    return ("fma",)


def _attention_via(q, k, v, *, window: int, causal: bool, via: str):
    """``flash_attention``'s layout around ``K4.attention(via=...)``."""
    b, sq, h, hd = q.shape
    out = K4.attention(*(heads_first(t) for t in (q, k, v)),
                       groups=h // k.shape[2], window=window, causal=causal,
                       via=via)
    return out.reshape(b, h, sq, hd).transpose(1, 2)


def pad_keys(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, S, KV, hd) with zero keys appended up to a multiple of
    ``chunk``, as the reference's chunked attention pads them."""
    return F.pad(t, (0, 0, 0, 0, 0, -t.shape[1] % chunk))


def phase_check_attention() -> dict:
    """Every case and type of the reference's attention sweep, the head
    dims beside it (also above 256), the fully masked rows, two long
    cases, the LM path's decode shapes, whisper's encoder and
    cross-decode shapes and minitron's training shapes, on every route
    that takes each (the route :func:`K4.route` picks through
    ``flash_attention``, the other by ``via``: f32 on
    ``sm90_tf32`` and ``fma``, bf16 on ``sm90`` and ``fma``, where the
    tensor-core route's widths take the head dim), against the plain
    version.  Controls: a window off by one, the last visited key tile
    dropped (every case and route), the output accumulator rounded to
    bf16 once per key tile (sm90; it must fail on the long cases); at
    whisper's shapes, the plain attention with the reference's zero pad
    keys (1500 keys padded to two 1024-key chunks) against K4's output
    (it must fail: K4 attends over the real keys only); at llava's
    decode shape, the plain attention with each query head reading the
    next group's kv head against K4's output (it must fail).
    Returns the launches by route."""
    gen = torch.Generator().manual_seed(SEED + 4)
    by_route = dict.fromkeys(K4.ROUTES, 0)
    for dtype in DTYPES:
        for case in (ATTN_SWEEP + ATTN_HEAD_DIMS + ATTN_LONG
                     + ATTN_DECODE + ATTN_ENCDEC + ATTN_TRAIN):
            b, sq, skv, h, kv, hd, win, causal = case
            q = _randn(gen, b, sq, h, hd).to(dtype)
            k = _randn(gen, b, skv, kv, hd).to(dtype)
            v = _randn(gen, b, skv, kv, hd).to(dtype)
            plain = plain_attention(q, k, v, window=win, causal=causal)
            kw = dict(window=win, causal=causal)
            for rt in attention_routes(q, hd):
                before = dict(K4.attention.launches_by_route)
                if rt == K4.route(q, k, v):
                    out = flash_attention(q, k, v, **kw)
                else:
                    out = _attention_via(q, k, v, via=rt, **kw)
                torch.cuda.synchronize()
                launched = {r: K4.attention.launches_by_route[r] - before[r]
                            for r in before}
                by_route[rt] += launched[rt]
                row = within(out, plain, dtype)
                if win:
                    row["control"] = control(
                        "window off by one", plain_attention(
                            q, k, v, window=win + 1, causal=causal),
                        plain, dtype)
                row["control_drop"] = control(
                    "last visited key tile dropped",
                    _fault(q, k, v, fault="drop", **kw), plain, dtype)
                if case == ATTN_LLAVA_DECODE:
                    row["control_kv_head"] = control(
                        f"query head h reading kv head (h // {h // kv} + 1)"
                        f" % {kv}", plain_attention(
                            q, torch.roll(k, -1, 2), torch.roll(v, -1, 2),
                            **kw), out, dtype)
                if case in ATTN_ENCDEC:
                    row["control_pad_keys"] = control(
                        f"{-skv % ATTN_PAD_CHUNK} zero pad keys in the "
                        f"softmax", plain_attention(
                            q, pad_keys(k, ATTN_PAD_CHUNK),
                            pad_keys(v, ATTN_PAD_CHUNK), **kw), out, dtype)
                if rt == "sm90":
                    wrong = _fault(q, k, v, fault="round_o", **kw)
                    if case in ATTN_LONG:
                        row["control_round_o"] = control(
                            "output sums rounded to bf16 per key tile",
                            wrong, plain, dtype)
                    else:   # too few key tiles to show: reported only
                        row["round_o_worst_over_tol"] = within(
                            wrong, plain, dtype)["worst_over_tol"]
                if sq > skv + win - 1 and win:
                    # rows with no unmasked key: the mean of V over Skv
                    mean_v = v.float().mean(dim=1).repeat_interleave(
                        h // kv, dim=1)
                    row["masked_rows_vs_mean_v"] = within(
                        out[:, skv + win - 1:], mean_v[:, None].expand(
                            b, sq - skv - win + 1, h, hd), dtype)
                    require(row["masked_rows_vs_mean_v"]["worst_over_tol"]
                            <= 1.0, f"check_attention {case}: masked rows")
                emit({"phase": "check_attention", "case": list(case),
                      "dtype": str(dtype), "route": rt,
                      "launches_by_route": launched, **row})
                require(launched == dict.fromkeys(K4.ROUTES, 0) | {rt: 1},
                        f"check_attention {case} {rt}: {launched}")
                require(out.dtype == dtype and out.shape == q.shape,
                        f"check_attention {case}: {out.dtype} {out.shape}")
                require(row["worst_over_tol"] <= 1.0,
                        f"check_attention {case} {dtype} {rt}: {row}")
    return by_route


#: phi3-medium-14b (src/repro/configs/phi3_medium_14b.py: d_model 5120,
#: 40 heads, 10 kv heads, hd 128, d_ff 17920) at 4096 tokens
MATMUL_FULL = [("wq", 4096, 5120, 5120), ("wk", 4096, 5120, 1280),
               ("ffn_up", 4096, 5120, 17920),
               ("ffn_down", 4096, 17920, 5120)]


#: the K depth of the new bf16 control: an accumulator rounded to bf16
#: every 64 of K (the sm90 kernel's stage depth) must fail the gate too
MATMUL_K_STAGE = 64


#: the f32 projections whose 1xTF32 control (the 3xTF32 kernel without
#: its lo words, same tile) must fail the f32 gate and err 4x the route
MATMUL_TF32_CONTROLS = ("wq", "ffn_down")


def phase_matmul(card: str) -> tuple[dict, list[dict]]:
    """``matmul_lb`` at full width, f32 and bf16 (and wq again with a
    K-major ``w`` in both types): the main path run (launch counts by
    route: bf16 on ``sm90``, f32 on ``sm90_tf32``, none on ``fma``), then
    each call held against the plain version and timed alone beside its
    bound and ``torch.matmul``; f32 rows also with the FMA kernel on the
    same inputs through its own launcher (``fma_ms``, its error gated)
    beside its bound (``fma_bound_ms``; ``bound_ms`` is the 3xTF32
    bound, three products at the TF32 rate).  Weights are scaled by
    1/sqrt(K), as a projection's are."""
    gen = torch.Generator().manual_seed(SEED + 5)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    ops = [(name, m, k, n, dtype, "n-major",
            _randn(gen, m, k).to(dtype),
            _randn(gen, k, n, scale=k ** -0.5).to(dtype))
           for dtype in DTYPES for name, m, k, n in MATMUL_FULL]
    # wq's operands again, w K-major (w.t() of a contiguous (N, K))
    for i in (0, len(MATMUL_FULL)):
        name, m, k, n, dtype, _, x, w = ops[i]
        ops.append((name, m, k, n, dtype, "k-major", x,
                    w.t().contiguous().t()))
    K3.matmul_lb.launches = 0
    K3.matmul_lb.launches_by_route = dict.fromkeys(K3.ROUTES, 0)
    K3.matmul_lb.copies = 0
    outs = [matmul_lb(x, w) for *_, x, w in ops]
    torch.cuda.synchronize()
    launches = {"launches": K3.matmul_lb.launches,
                "by_route": dict(K3.matmul_lb.launches_by_route),
                "copies": K3.matmul_lb.copies}
    per_type = len(MATMUL_FULL) + 1
    require(launches["launches"] == len(ops),
            f"matmul: {launches} for {len(ops)} calls")
    require(launches["by_route"] == {"sm90": per_type,
                                     "sm90_tf32": per_type, "fma": 0}
            and launches["copies"] == 0,
            f"matmul: {launches}: every bf16 projection must take sm90 "
            f"and every f32 one sm90_tf32")
    rows = []
    for (name, m, k, n, dtype, layout, x, w), out in zip(ops, outs):
        route = K3.route(x, w)
        f32 = dtype == torch.float32
        require(route == ("sm90_tf32" if f32 else "sm90"),
                f"matmul {name} {dtype} {layout}: route {route}")
        plain = matmul_ref(x, w)
        chk = within(out, plain, dtype)
        require(chk["worst_over_tol"] <= 1.0 and
                bool(torch.isfinite(out).all()),
                f"matmul {name} {dtype}: {chk}")
        if name == "wq" and layout == "n-major":
            chk["control"] = control(*matmul_control(x, w, MATMUL_K_STEP),
                                     plain, dtype)
            if dtype == torch.bfloat16:
                chk["control_stage"] = control(
                    *matmul_control(x, w, MATMUL_K_STAGE), plain, dtype)
        elt = x.element_size()
        flops = 2.0 * m * n * k
        n_bytes = float((m * k + k * n + m * n) * elt)
        t_ops, t_bytes = flops / PEAK[dtype], n_bytes / HBM_BYTES_PER_S
        t_tc = (K3.TF32_PRODUCTS * flops / PEAK_TF32_FLOPS if f32
                else t_ops)
        extra = {}
        if f32:
            # no atomics: a second launch gives the same bits (a race
            # between a stage's last reads and its refill would not)
            require(torch.equal(K3._sm90_tf32(x, w), out),
                    f"matmul {name} {layout}: two launches differ")
        if f32 and layout == "n-major":
            if name in MATMUL_TF32_CONTROLS:
                one = K3._sm90_tf32(x, w, lo_terms=False)
                extra["control_1xtf32"] = control(
                    "1xTF32: lo words dropped, same tile", one, plain,
                    dtype)
                ratio = (extra["control_1xtf32"]["max_abs_err"]
                         / max(chk["max_abs_err"], 1e-30))
                extra["control_1xtf32"]["over_route"] = ratio
                require(ratio >= 4, f"matmul {name}: 1xTF32 errs only "
                                    f"{ratio}x the route")
                del one
            fma_gate = within(K3._fma(x, w), plain, dtype)
            require(fma_gate["worst_over_tol"] <= 1.0,
                    f"matmul {name}: FMA kernel vs plain {fma_gate}")
            extra.update(
                fma_ms=_time_ms(lambda: K3._fma(x, w), flush),
                fma_err=fma_gate["worst_over_tol"],
                fma_max_abs_err=fma_gate["max_abs_err"],
                fma_bound_ms=max(t_ops, t_bytes) * 1e3,
                fma_bound_by="operations" if t_ops >= t_bytes
                else "bytes", fma_cta_tn=K3.cta_tile(m, n))
        del plain
        blk = accounted_block(m, n, k, elt)
        row = {"phase": "matmul", "config": "phi3-medium-14b",
               "projection": name, "shape": [m, k, n],
               "dtype": str(dtype), "route": route, "layout": layout,
               **chk,
               "ms": _time_ms(lambda: matmul_lb(x, w), flush),
               "plain_ms": _time_ms(lambda: matmul_ref(x, w), flush),
               "library_ms": _time_ms(lambda: torch.matmul(x, w), flush),
               "bound_ms": max(t_tc, t_bytes) * 1e3,
               "bound_by": "operations" if t_tc >= t_bytes else "bytes",
               "peak_flops": PEAK_TF32_FLOPS / K3.TF32_PRODUCTS if f32
               else PEAK[dtype], "flops": flops,
               "bytes": n_bytes,
               "cta_tn": (K3.tf32_tile(m, n) if f32
                          else K3.sm90_tile(m, n)),
               **({"promote": K3.TF32_PROMOTE} if f32 else {}),
               **extra,
               "accounted_block": [blk.bm, blk.bn, blk.bk],
               "accounted_bytes": hbm_traffic_model(m, n, k, blk, elt),
               "card": card}
        emit(row)
        rows.append(row)
    return launches, rows


def unmasked_pairs(sq: int, skv: int, window: int, causal: bool) -> int:
    """(query, key) pairs that no mask hides, per head."""
    q = np.arange(sq)
    hi = np.minimum(q, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, int)
    return int(np.clip(hi - lo + 1, 0, None).sum())


# source config, b, s, h, kv, hd, window, causal
ATTN_FULL = [("phi3-medium-14b", 1, 4096, 40, 10, 128, 0, True),
             ("mixtral-8x7b", 1, 8192, 32, 8, 128, 4096, True)]


def _library_attention(qh, kh, vh, *, window: int, causal: bool):
    """``F.scaled_dot_product_attention`` on (B, H, S, hd): the time
    yardstick (never called by the port).  K and V of as many heads as
    q are passed without ``enable_gqa``, which SDPA's memory-efficient
    kernel does not take (at 32768 keys its math fallback would hold
    every score)."""
    sq, skv = qh.shape[2], kh.shape[2]
    gqa = {} if kh.shape[1] == qh.shape[1] else {"enable_gqa": True}
    if not window:
        return lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal, **gqa)
    q_pos = torch.arange(sq, device="cuda")[:, None]
    k_pos = torch.arange(skv, device="cuda")[None, :]
    mask = k_pos > q_pos - window
    if causal:
        mask &= k_pos <= q_pos
    return lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, **gqa)


def library_kernels(fn) -> list[str]:
    """The CUDA kernels one call of ``fn`` runs, by name, from
    ``torch.profiler`` (which SDPA backend it picked)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")})


def attention_bounds(flops: float, n_bytes: float, dtype, route: str
                     ) -> dict:
    """The least time the card takes for one attention call on
    ``route`` (``ops_s``: f32 on the tensor cores as 3xTF32), and for f32
    the FMA kernel's bound beside it."""
    t_ops, t_bytes = ops_s(flops, dtype, route), n_bytes / HBM_BYTES_PER_S
    row = {"bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if dtype == torch.float32 and route != "fma":
        row.update(fma_bound(flops, t_bytes))
    return row


def exact_attention(q, k, v, *, groups: int, window: int,
                    causal: bool) -> torch.Tensor:
    """float64 attention on heads-first tensors with the plain version's
    masks (a masked score -1e30), one kv head's group at a time: the
    yardstick the f32 routes' and the plain version's errors are read
    against (``err_over_max_exact``)."""
    sq, hd = q.shape[1], q.shape[2]
    skv = k.shape[1]
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        keep &= k_pos <= q_pos
    if window:
        keep &= k_pos > q_pos - window
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for i in range(k.shape[0]):
        rows = slice(i * groups, (i + 1) * groups)
        sc = q[rows].double() @ k[i].double().T * hd ** -0.5
        out[rows] = torch.softmax(sc.masked_fill(~keep, -1e30), dim=-1) \
            @ v[i].double()
    return out


def tf32_attention_controls(qf, kf, vf, plain, *, groups: int,
                            window: int, causal: bool, out) -> dict:
    """K4's 3xTF32 kernel on heads-first inputs it has already run:
    a second launch gives the same bits (``out``'s, required); 1xTF32
    (every lo word dropped, one launch of the same plan) errs at least
    4x the route (required), whether it fails the f32 gate reported;
    the transposers reading V one key off fail ``CARD_TOL`` (required).
    """
    plan = K4.sm90_tf32_plan(K4.sm90_tf32_head_dim(qf.shape[-1]))
    kw = dict(groups=groups, window=window, causal=causal)
    again = K4._sm90_tf32(qf, kf, vf, plan, **kw)
    one = K4._sm90_tf32(qf, kf, vf, plan, lo_terms=False, **kw)
    bad = K4._sm90_tf32(qf, kf, vf, dataclasses.replace(plan, v_key_off=1),
                        **kw)
    torch.cuda.synchronize()
    right = (out - plain).abs().max().item()
    one_gate = within(one, plain, torch.float32)
    row = {"same_bits_second_launch": bool(torch.equal(again, out)),
           "control_1xtf32": {
               "what": "1xTF32: every lo word dropped",
               "max_abs_err": one_gate["max_abs_err"],
               "over_route": one_gate["max_abs_err"] / max(right, 1e-30),
               "worst_over_tol": one_gate["worst_over_tol"],
               "fails_gate": one_gate["worst_over_tol"] > 1.0},
           "control_v_key_off": control(
               "the transposers read V one key off", bad, plain,
               torch.float32)}
    require(row["same_bits_second_launch"],
            "attention sm90_tf32: a second launch gave other bits")
    require(row["control_1xtf32"]["over_route"] >= 4,
            f"attention sm90_tf32: 1xTF32 errs {row['control_1xtf32']}, "
            f"under 4x the route's {right}")
    return row


def phase_attention(card: str) -> tuple[dict, list[dict]]:
    """``flash_attention`` at full width, f32 (route sm90_tf32) and bf16
    (route sm90), both required: the main path run (launches by route),
    then each call held against the plain version and the kernel timed
    alone beside its bound (f32: 3xTF32, with the FMA bound beside it),
    the pairs it visits against the unmasked ones, the host's time to
    enqueue one call (``host_us``) and
    ``F.scaled_dot_product_attention`` (whose kernels the profiler
    names); f32 also the FMA kernel through ``via="fma"`` on the same
    inputs (``fma_ms``, ``fma_err`` gated like the route), and the
    route's, the FMA kernel's and the plain version's errors against
    float64 (:func:`exact_attention`, reported).  Controls: kv head
    ``h % KV``; on sm90 the output sums rounded to bf16 once per key
    tile; on sm90_tf32 :func:`tf32_attention_controls`."""
    gen = torch.Generator().manual_seed(SEED + 6)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    cases = [(cfg, b, s, h, kv, hd, win, causal, dtype,
              _randn(gen, b, s, h, hd).to(dtype),
              _randn(gen, b, s, kv, hd).to(dtype),
              _randn(gen, b, s, kv, hd).to(dtype))
             for dtype in DTYPES
             for cfg, b, s, h, kv, hd, win, causal in ATTN_FULL]
    K4.attention.launches = 0
    K4.attention.launches_by_route = dict.fromkeys(K4.ROUTES, 0)
    outs = [flash_attention(*c[9:], window=c[6], causal=c[7])
            for c in cases]
    torch.cuda.synchronize()
    launches = {"launches": K4.attention.launches,
                "by_route": dict(K4.attention.launches_by_route)}
    require(launches["launches"] == len(cases)
            and launches["by_route"]["sm90"] == len(ATTN_FULL)
            and launches["by_route"]["sm90_tf32"] == len(ATTN_FULL),
            f"attention: {launches} for {len(cases)} calls: every bf16 "
            f"call must take sm90, every f32 call sm90_tf32")
    rows = []
    for (cfg, b, s, h, kv, hd, win, causal, dtype, q, k, v), out in zip(
            cases, outs):
        qf, kf, vf = (heads_first(t) for t in (q, k, v))
        rt = K4.route(qf, kf, vf)
        require(rt == ("sm90" if dtype == torch.bfloat16 else "sm90_tf32"),
                f"attention {cfg} {dtype}: route {rt}")
        g = h // kv
        kw = dict(groups=g, window=win, causal=causal)
        plain = plain_attention(q, k, v, window=win, causal=causal)
        chk = within(out, plain, dtype)
        require(chk["worst_over_tol"] <= 1.0 and
                bool(torch.isfinite(out).all()),
                f"attention {cfg} {dtype}: {chk}")
        # query head h on kv head h % KV instead of h // (H / KV)
        chk["control"] = control(
            "kv head h % KV", plain_attention(
                q, k.repeat(1, 1, g, 1), v.repeat(1, 1, g, 1),
                window=win, causal=causal), plain, dtype)
        if rt == "sm90":
            chk["control_round_o"] = control(
                "output sums rounded to bf16 per key tile",
                _fault(q, k, v, window=win, causal=causal,
                       fault="round_o"), plain, dtype)
        fma = {}
        if rt == "sm90_tf32":
            plain_hf = plain.transpose(1, 2).reshape(qf.shape)
            out_hf = heads_first(out)
            chk.update(tf32_attention_controls(qf, kf, vf, plain_hf,
                                               out=out_hf, **kw))
            fma_out = K4.attention(qf, kf, vf, via="fma", **kw)
            fma_gate = within(fma_out, plain_hf, dtype)
            require(fma_gate["worst_over_tol"] <= 1.0,
                    f"attention {cfg}: the FMA kernel {fma_gate}")
            exact = exact_attention(qf, kf, vf, **kw)
            top = exact.abs().max().item()
            chk["err_over_max_exact"] = {
                name: (t.double() - exact).abs().max().item() / top
                for name, t in (("route", out_hf), ("fma", fma_out),
                                ("plain", plain_hf))}
            del fma_out, plain_hf, out_hf, exact
            fma = {"fma_ms": _time_ms(lambda: K4.attention(
                       qf, kf, vf, via="fma", **kw), flush),
                   "fma_err": fma_gate["worst_over_tol"],
                   "fma_max_abs_err": fma_gate["max_abs_err"]}
        del plain
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = b * h * unmasked_pairs(s, s, win, causal)
        visited = b * h * K4.visited_pairs(s, s, win, causal)
        flops = 4.0 * hd * pairs
        n_bytes = float(2 * (q.numel() + k.numel()) * q.element_size())
        library = _library_attention(qh, kh, vh, window=win, causal=causal)

        def kernel():
            return K4.attention(qf, kf, vf, **kw)

        row = {"phase": "attention", "config": cfg,
               "shape": {"b": b, "s": s, "h": h, "kv": kv, "hd": hd},
               "window": win, "causal": causal, "dtype": str(dtype),
               "route": rt, **chk,
               "ms": _time_ms(kernel, flush),
               "entry_ms": _time_ms(lambda: flash_attention(
                   q, k, v, window=win, causal=causal), flush),
               "plain_ms": _time_ms(lambda: plain_attention(
                   q, k, v, window=win, causal=causal), flush, reps=3),
               "library_ms": _time_ms(library, flush),
               "library_kernels": library_kernels(library),
               "host_us": _host_us(kernel),
               **attention_bounds(flops, n_bytes, dtype, rt), **fma,
               "peak_flops": flops / ops_s(flops, dtype, rt),
               "unmasked_pairs": pairs,
               "visited_pairs": visited,
               "visited_over_unmasked": visited / pairs,
               "flops": flops, "bytes": n_bytes, "card": card}
        emit(row)
        rows.append(row)
    return launches, rows


# name, b, s, h, kv, hd, window, causal: head dims the configs do not
# use, at 4096 tokens (80 and 96 run at width 96 on sm90_tf32 in f32 and
# at their own width on sm90 in bf16; 256 on FMA with one K/V stage in
# f32, with one consumer warpgroup on sm90 in bf16)
ATTN_HEAD_DIM_FULL = [("hd80", 1, 4096, 32, 32, 80, 0, True),
                      ("hd96", 1, 4096, 32, 8, 96, 0, True),
                      ("hd256", 1, 4096, 16, 16, 256, 0, True)]


def phase_attention_head_dims(card: str) -> list[dict]:
    """K4 at head dims 80, 96 and 256, f32 and bf16, each on the route
    :func:`K4.route` gives it (f32 80 and 96 ``sm90_tf32``, 256 ``fma``;
    bf16 ``sm90``): each call held against the plain version and timed
    alone beside its route's bound and
    ``F.scaled_dot_product_attention``."""
    gen = torch.Generator().manual_seed(SEED + 7)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    rows = []
    for dtype in DTYPES:
        for name, b, s, h, kv, hd, win, causal in ATTN_HEAD_DIM_FULL:
            q, k, v = (_randn(gen, b, s, heads, hd).to(dtype)
                       for heads in (h, kv, kv))
            before = K4.attention.launches
            out = flash_attention(q, k, v, window=win, causal=causal)
            torch.cuda.synchronize()
            launched = K4.attention.launches - before
            plain = plain_attention(q, k, v, window=win, causal=causal)
            chk = within(out, plain, dtype)
            del plain
            require(launched == 1 and chk["worst_over_tol"] <= 1.0 and
                    bool(torch.isfinite(out).all()),
                    f"attention {name} {dtype}: {launched} launches, {chk}")
            qf, kf, vf = (heads_first(t) for t in (q, k, v))
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            rt = K4.route(qf, kf, vf)
            pairs = b * h * unmasked_pairs(s, s, win, causal)
            flops = 4.0 * hd * pairs
            n_bytes = float(2 * (q.numel() + k.numel()) * q.element_size())
            width = (K4.sm90_head_dim(hd) if rt == "sm90"
                     else K4.sm90_tf32_head_dim(hd) if rt == "sm90_tf32"
                     else K4.padded_head_dim(hd))
            row = {"phase": "attention_head_dims", "case": name,
                   "shape": {"b": b, "s": s, "h": h, "kv": kv, "hd": hd},
                   "route": rt, "width": width,
                   "window": win, "causal": causal, "dtype": str(dtype),
                   "launches": launched, **chk,
                   "ms": _time_ms(lambda: K4.attention(
                       qf, kf, vf, groups=h // kv, window=win,
                       causal=causal), flush),
                   "plain_ms": _time_ms(lambda: plain_attention(
                       q, k, v, window=win, causal=causal), flush, reps=3),
                   "library_ms": _time_ms(_library_attention(
                       qh, kh, vh, window=win, causal=causal), flush),
                   **attention_bounds(flops, n_bytes, dtype, rt),
                   "flops": flops, "bytes": n_bytes, "card": card}
            emit(row)
            rows.append(row)
    return rows


# --------------------------------------------------------------------------
# lm_serve: phi3-medium-14b served through BatchedServer, K4 on every
# attention
# --------------------------------------------------------------------------

LM_ARCH = "phi3-medium-14b"
#: the reference server's defaults (repro/launch/serve.py ``main``)
LM_REQUESTS, LM_SLOTS, LM_GEN, LM_MAX_SEQ, LM_PROMPT = 6, 4, 16, 128, 8
#: served bf16 logits against the plain replay of the same step, relative
#: to max |plain| (the reference's bf16-against-f32 tolerance): 40
#: layers of bf16 activations downstream of two attentions that round
#: their outputs in other orders
LM_BF16_TOL = 2e-2
#: the depth up to which :data:`LM_BF16_TOL` holds as it is
LM_BF16_DEPTH = 40
#: the per-layer check's prefill length (batch 1)
LM_PREFILL_S = 4096
#: the f32 run: phi3 at full width cut to 4 layers; the window of its
#: ring wrap; the decode-against-prefill length
LM_F32_LAYERS, LM_WINDOW, LM_S = 4, 64, 64
#: decode steps (by position) whose control drops the newest slot
LM_CONTROL_POS = (1, 8)
#: a K4 row or call longer than this many queries is held to the plain
#: version on its panels (:func:`panel_rows`), not whole
PANEL_MIN_S = 8192
#: the rows of each panel: the first, the middle and the last of a head
LONG_PANEL = 128
#: about how long a long row's back-to-back calls take in all (ms)
LONG_DEVICE_MS = 300.0
#: the largest (Sq, Skv) bool mask SDPA is handed for a window (4 GB)
LONG_MASK_BYTES = 1 << 32
#: every kernel's launch counter
LAUNCH_COUNTERS = (("conv_lb", K.conv_lb), ("wgrad_lb", W.wgrad_lb),
                   ("matmul_lb", K3.matmul_lb), ("attention", K4.attention))


@contextlib.contextmanager
def counted(into: dict):
    """Every kernel's launches by route (and K1's and K2's staging
    launches, and K4's launches that also wrote a log-sum-exp, as
    ``attention_lse``) set to 0 for the block, read into ``into`` after
    it, then added back onto the counts from before."""
    saved = {}
    for name, fn in LAUNCH_COUNTERS:
        saved[name] = (fn.launches, dict(fn.launches_by_route),
                       getattr(fn, "stage_launches", None))
        fn.launches = 0
        fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)
        if hasattr(fn, "stage_launches"):
            fn.stage_launches = 0
    lse = dict(K4.attention.lse_launches_by_route)
    K4.attention.lse_launches_by_route = dict.fromkeys(lse, 0)
    try:
        yield into
    finally:
        for name, fn in LAUNCH_COUNTERS:
            launches, by_route, stages = saved[name]
            into[name] = dict(fn.launches_by_route)
            if stages is not None:
                into[name]["stage"] = fn.stage_launches
                fn.stage_launches += stages
            fn.launches += launches
            fn.launches_by_route = {r: n + by_route[r] for r, n
                                    in fn.launches_by_route.items()}
        into["attention_lse"] = dict(K4.attention.lse_launches_by_route)
        K4.attention.lse_launches_by_route = {
            r: n + lse[r] for r, n in into["attention_lse"].items()}


def lm_bf16_tol(cfg) -> float:
    """The served bf16 logits' gate of ``cfg``, relative to max |plain|:
    :data:`LM_BF16_TOL` up to :data:`LM_BF16_DEPTH` attention layers,
    and linear in the layer count past them.  The replay's error grows
    with depth: on an H100, phi3's 40 layers read 1.9475e-2 against
    2e-2 and mixtral's 20 blocks 1.4996e-2, a ratio of 1.30 for twice
    the depth, close to the sqrt(2) of per-layer errors adding at
    random; linear is the worst case, errors that add.  So llava's and
    granite's 60 layers are gated at 3e-2 and every config of 40 layers
    or fewer at 2e-2, as before.  A function of the config's layer
    count only, never of a reading; every control must still fail it."""
    return LM_BF16_TOL * max(1.0, attention_layers(cfg) / LM_BF16_DEPTH)


def k4_only(counts: dict, route: str, n: int) -> bool:
    """``n`` K4 launches on ``route`` and nothing else of K1-K4, in the
    counts of a :func:`counted` block."""
    return (counts["attention"] == dict.fromkeys(K4.ROUTES, 0) | {route: n}
            and not any(v for name in ("conv_lb", "wgrad_lb", "matmul_lb")
                        for v in counts[name].values()))


@contextlib.contextmanager
def patched(*swaps):
    """``(module, name, value)``: each attribute replaced for the block."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, v in swaps:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def _refuse(*_args, **_kw):
    raise SmokeFailure("a plain attention ran on the lm_serve path")


def no_plain_attention():
    """Every plain attention the LM path could reach raises."""
    return patched((LM_A, "attention_chunked", _refuse),
                   (LM_A, "decode_attention", _refuse),
                   (K4, "attention_plain", _refuse))


def drop_newest_slot():
    """The control: decode's gather without its newest slot, the current
    token's own key."""
    kept = LM_A.kept_slots

    def without_newest(pos, cur_pos, window):
        idx = kept(pos, cur_pos, window)
        return idx[np.asarray(pos)[idx] != cur_pos]
    return patched((LM_A, "kept_slots", without_newest))


def clone_caches(caches: list) -> list:
    def clone(x):
        if isinstance(x, dict):
            return {n: clone(v) for n, v in x.items()}
        return x.clone() if isinstance(x, torch.Tensor) else x.copy()
    return [clone(block) for block in caches]


def lm_requests(cfg, seed: int) -> list:
    gen = torch.Generator().manual_seed(seed)
    return [LmRequest(rid=rid, prompt=torch.randint(
        0, cfg.vocab, (LM_PROMPT,), generator=gen).tolist(), max_new=LM_GEN)
        for rid in range(LM_REQUESTS)]


def serve_lm(server, reqs, k4_route: str, per_step: int):
    """``server`` over ``reqs`` until every request completes: each step
    from a clone of the caches it starts from, timed on the host clock (a step ends in the greedy
    choice's copy to the host), its K4 launches ``per_step`` on
    ``k4_route`` and none elsewhere, required.  Returns each step's
    (caches before, tokens, pos, logits) and its seconds."""
    for r in reqs:
        server.submit(r)
    steps, secs = [], []
    while (server.active or server.queue) and len(steps) < server.max_seq:
        before = clone_caches(server.caches)
        pos = server.pos
        k4 = dict(K4.attention.launches_by_route)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, logits = server.step()
        secs.append(time.perf_counter() - t0)
        launched = {r: K4.attention.launches_by_route[r] - k4[r] for r in k4}
        require(launched == dict.fromkeys(K4.ROUTES, 0) | {k4_route: per_step},
                f"lm_serve step at pos {pos}: K4 launches {launched}, want "
                f"{per_step} on {k4_route}")
        steps.append((before, tok, pos, logits))
    require(all(r.done and len(r.out) == r.max_new for r in reqs),
            f"lm_serve: requests left unfinished after {len(steps)} steps")
    return steps, secs


#: the port's own router, whatever a replay patches in its place
_ROUTER_TOP_K = MOE.router_top_k


class Routing:
    """Each served step's expert choices (:meth:`record`: every MoE
    layer's ``idx`` in call order, ``per_step`` a step), handed back in
    a replay of that step (:meth:`served`) with gates from the replay's
    own probabilities at them: with MoE, one bf16 ulp upstream can flip a
    near-tied top-k choice and move a token's FFN output in a jump,
    which would fail a replay for a reason that is not the attention's.
    ``flips`` counts the (token, layer) rows whose own top-k set differs
    from the served one."""

    def __init__(self, per_step: int):
        self.per_step = per_step
        self.calls: list[torch.Tensor] = []
        self.flips = 0
        self.rows = 0

    def record(self):
        def rec(x, router, top_k):
            gates, idx = _ROUTER_TOP_K(x, router, top_k)
            self.calls.append(idx)
            return gates, idx
        return patched((MOE, "router_top_k", rec))

    def step(self, i: int) -> list:
        return self.calls[i * self.per_step:(i + 1) * self.per_step]

    def served(self, i: int, count: bool = False):
        served = iter(self.step(i))

        def replay(x, router, top_k):
            want = next(served)
            probs = torch.softmax(x.to(torch.float32) @ router, dim=-1)
            if count:
                _, own = _ROUTER_TOP_K(x, router, top_k)
                self.flips += int((own.sort(-1).values
                                   != want.sort(-1).values).any(-1).sum())
                self.rows += own.shape[0]
            gates = probs.gather(-1, want)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
            return gates, want
        return patched((MOE, "router_top_k", replay))

    def dropped(self, i: int, n_experts: int, cap: int) -> int:
        """Pairs the capacity dropped in served step ``i``: per layer and
        expert, its choices past ``cap``."""
        return sum(int(torch.clamp(torch.bincount(
            idx.reshape(-1), minlength=n_experts) - cap, min=0).sum())
            for idx in self.step(i))


def _rel(out, ref, vocab: int) -> float:
    out, ref = out[..., :vocab].float(), ref[..., :vocab].float()
    return (out - ref).abs().max().item() / ref.abs().max().item()


def _recorded(routing):
    return routing.record() if routing else contextlib.nullcontext()


def _routed(routing, i: int, count: bool = False):
    return routing.served(i, count) if routing else contextlib.nullcontext()


def k4_against_plain(dtype, into: list):
    """A ``tap`` that holds each K4 call to the plain version on its own
    inputs at ``CARD_TOL``, appending its worst |err| / tolerance to
    ``into``."""
    def tap(layer, q, k, v, out, *, window, causal):
        into.append(within(out, plain_attention(
            q, k, v, window=window, causal=causal), dtype)["worst_over_tol"])
    return tap


def replay_plain(api, params, steps, tol: float, what: str,
                 routing: Routing | None = None) -> dict:
    """Each served step again from a clone of its caches (under the
    served routing, where there are experts; the replay's own flips
    counted):

      * with the plain attention: the served logits' max error over max
        |plain| against ``tol`` (:func:`expect`: a miss fails the smoke
        after its last phase);
      * the served path with a tap on every K4 call: each output held to
        the plain version on the same q/k/v at ``CARD_TOL`` (required:
        the kernel, teacher-forced at every call of every step), and the
        step's logits equal to the served ones bit for bit (required).

    Also the steps whose greedy tokens agree."""
    errs, per_call, agree = [], [], 0
    tap = k4_against_plain(api.cfg.compute_dtype, per_call)
    for i, (caches, tok, pos, logits) in enumerate(steps):
        with _routed(routing, i, count=True):
            plain, _ = api.decode_step(params, clone_caches(caches), tok,
                                       pos, attn="plain")
        with _routed(routing, i):
            again, _ = api.decode_step(params, clone_caches(caches), tok,
                                       pos, tap=tap)
        require(torch.equal(again, logits),
                f"{what}: the served step at pos {pos} did not repeat")
        errs.append(_rel(logits, plain, api.cfg.vocab))
        agree += bool(torch.equal(logits.argmax(-1), plain.argmax(-1)))
    require(len(per_call) == attention_layers(api.cfg) * len(steps)
            and max(per_call) <= 1.0,
            f"{what}: K4 calls against the plain version, worst "
            f"{max(per_call)} of CARD_TOL over {len(per_call)} calls")
    worst = max(errs)
    expect(worst <= tol, f"{what}: served logits err {worst} of max "
                         f"|plain| > {tol}")
    out = {"max_err_over_max_plain": worst, "gate": tol,
           "within_gate": worst <= tol, "err_over_max_plain_by_step": errs,
           "per_call_worst_over_card_tol": max(per_call),
           "per_call_calls": len(per_call),
           "steps_greedy_equal": agree, "steps": len(steps)}
    if routing:
        out.update(routing="served", routing_flips=routing.flips,
                   routing_rows=routing.rows)
    return out


def control_drop_newest(api, params, steps, tol: float,
                        routing: Routing | None = None,
                        positions: tuple = LM_CONTROL_POS) -> list:
    """The decode gather without the current token's own key, at the
    steps of ``positions``: each must fail ``tol``."""
    rows = []
    for i, (caches, tok, pos, _logits) in enumerate(steps):
        if pos not in positions:
            continue
        with _routed(routing, i):
            plain, _ = api.decode_step(params, clone_caches(caches), tok,
                                       pos, attn="plain")
        with drop_newest_slot(), _routed(routing, i):
            wrong, _ = api.decode_step(params, clone_caches(caches), tok,
                                       pos)
        err = _rel(wrong, plain, api.cfg.vocab)
        rows.append({"what": "decode gather without the newest slot",
                     "pos": pos, "err_over_max_plain": err, "gate": tol})
        require(err > tol, f"lm_serve control at pos {pos} passes: {err}")
    require(len(rows) == len(positions), f"lm_serve controls {rows}")
    return rows


def per_layer_k4(api, params, dtype, gen, length: int = LM_PREFILL_S
                 ) -> dict:
    """One prefill (batch 1, ``length`` tokens) and one decode step
    after it (max_seq ``length`` + 1: under a window shorter than that,
    a ring) with a tap on every K4 call: each layer's output held to
    the plain version on the same inputs (the window's, the causal
    mask's) at ``CARD_TOL``."""
    rows = {"prefill": [], "decode": []}

    def tap(kind):
        def check(layer, q, k, v, out, *, window, causal):
            r = within(out, plain_attention(q, k, v, window=window,
                                            causal=causal), dtype)
            rows[kind].append({"layer": layer, "skv": k.shape[1], **r})
        return check

    toks = torch.randint(0, api.cfg.vocab, (1, length + 1),
                         generator=gen).cuda()
    _, caches = api.prefill(params, {"tokens": toks[:, :-1]},
                            max_seq=length + 1, tap=tap("prefill"))
    api.decode_step(params, caches, toks[:, -1:], length,
                    tap=tap("decode"))
    out = {}
    for kind, rs in rows.items():
        out[kind] = {"layers": len(rs),
                     "worst_over_tol": max(r["worst_over_tol"] for r in rs),
                     "max_abs_err": max(r["max_abs_err"] for r in rs),
                     "skv": rs[0]["skv"]}
        require(len(rs) == api.cfg.n_layers
                and out[kind]["worst_over_tol"] <= 1.0,
                f"lm_serve per-layer K4 {kind}: {out[kind]}")
    return out


def _long_inputs(gen, b, sq, skv, h, kv, hd, dtype):
    """q, k, v of a long K4 row drawn on the card (a CUDA generator
    seeded from ``gen``): 2^31 elements drawn on the host would take
    minutes."""
    cgen = torch.Generator(device="cuda").manual_seed(
        int(torch.randint(2 ** 62, (1,), generator=gen)))
    return tuple(torch.randn(shape, generator=cgen, device="cuda",
                             dtype=dtype)
                 for shape in ((b, sq, h, hd), (b, skv, kv, hd),
                               (b, skv, kv, hd)))


def _sdpa_refused(sq: int, skv: int, window: int) -> str | None:
    """Why ``F.scaled_dot_product_attention`` cannot time a row, or
    ``None``: it takes a window only as a dense (Sq, Skv) mask."""
    if window and sq * skv > LONG_MASK_BYTES:
        return (f"SDPA takes the window only as a dense (Sq, Skv) mask: "
                f"{sq} x {skv} bools are {sq * skv / 1e9:.0f} GB")
    return None


def k4_lm_rows(cfg, dtype, gen, flush, card: str, shapes) -> list:
    """K4 alone at the LM path's shapes, ``(what, b, sq, skv, causal,
    window)``: held to the plain version, timed (one flushed call, and
    back to back on the card alone: ``device_ms``) beside its bound
    (the pairs the window and the causal mask leave), the plain version
    and ``F.scaled_dot_product_attention``, the host's enqueue.  A row
    longer than :data:`PANEL_MIN_S` queries is held to the plain version
    on its panels (:func:`panel_rows`: the first, middle and last
    :data:`LONG_PANEL` rows of every head) and ``plain_ms`` times those
    panels only; its inputs are drawn on the card, and its calls timed
    back to back are as many as fill about :data:`LONG_DEVICE_MS`."""
    rows = []
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for what, b, sq, skv, causal, window in shapes:
        long = max(sq, skv) > PANEL_MIN_S
        if long:
            q, k, v = _long_inputs(gen, b, sq, skv, h, kv, hd, dtype)
        else:
            q = _randn(gen, b, sq, h, hd).to(dtype)
            k, v = (_randn(gen, b, skv, kv, hd).to(dtype) for _ in range(2))
        kw = dict(window=window, causal=causal)
        held = {}
        if sq > PANEL_MIN_S:
            panels = panel_rows(sq, LONG_PANEL)
            ref, n_rows = plain_panels(q, k, v, panels=panels, **kw)
            chk = within(panel_cut(flash_attention(q, k, v, **kw), panels),
                         ref, dtype)
            del ref
            held = {"held_on": "panels", "panels": panels,
                    "rows_a_head": n_rows,
                    "last_panel_first_element":
                        ((b * h - 1) * sq + panels[-1][0]) * hd,
                    "plain_ms_is": f"the plain version on the panels' "
                                   f"{n_rows} rows of each of {b * h} "
                                   f"heads only"}

            def plain():
                return plain_panels(q, k, v, panels=panels, **kw)
        else:
            chk = within(flash_attention(q, k, v, **kw),
                         plain_attention(q, k, v, **kw), dtype)

            def plain():
                return plain_attention(q, k, v, **kw)
        require(chk["worst_over_tol"] <= 1.0,
                f"lm_attention {what} {dtype}: {chk}")
        qf, kf, vf = (heads_first(t) for t in (q, k, v))
        rt = K4.route(qf, kf, vf)
        pairs = b * h * unmasked_pairs(sq, skv, window, causal)
        flops = 4.0 * hd * pairs
        n_bytes = float(2 * (q.numel() + k.numel()) * q.element_size())
        refused = _sdpa_refused(sq, skv, window)
        if refused is None:
            # a long row's K and V repeated to every query head
            rep = h // kv if long else 1
            qh, kh, vh = (t.transpose(1, 2).repeat_interleave(
                1 if t is q else rep, dim=1).contiguous() for t in (q, k, v))
            library = _library_attention(qh, kh, vh, **kw)

        def kernel():
            return K4.attention(qf, kf, vf, groups=h // kv, **kw)

        reps = 3 if long else 10
        ms = _time_ms(kernel, flush, reps=reps)
        calls = max(3, min(100, round(LONG_DEVICE_MS / ms))) if long else 100
        row = {"phase": "lm_attention", "config": cfg.name, "what": what,
               "shape": {"b": b, "sq": sq, "skv": skv, "h": h, "kv": kv,
                         "hd": hd},
               "causal": causal, "window": window, "dtype": str(dtype),
               "route": rt, **chk, **held,
               "ms": ms, "device_ms": _device_ms(kernel, calls),
               "device_calls": calls,
               "plain_ms": _time_ms(plain, flush, reps=3),
               "host_us": _host_us(kernel, 5 if long else 20),
               **attention_bounds(flops, n_bytes, dtype, rt),
               "flops": flops, "bytes": n_bytes, "card": card}
        if refused is None:
            try:
                lib_ms = _time_ms(library, flush, reps=reps)
            except torch.OutOfMemoryError as e:
                if not long:
                    raise
                refused = f"SDPA ran out of memory: {str(e)[:120]}"
        if refused is None:
            lib_calls = max(3, min(100, round(LONG_DEVICE_MS / lib_ms))) \
                if long else 100
            row.update(library_ms=lib_ms,
                       library_device_ms=_device_ms(library, lib_calls),
                       library_kernels=library_kernels(library),
                       library_kv_heads=kh.shape[1])
            del qh, kh, vh, library
        else:
            row.update(library_ms=None, library_device_ms=None,
                       library_kernels=[], library_null_reason=refused)
            qh = kh = vh = library = None
            _free()
        emit(row)
        rows.append(row)
        del q, k, v, qf, kf, vf, plain
    return rows


def profile_decode_step(api, params, steps) -> dict:
    """The last served step again, on clones of its caches: once timed
    on the host clock (its enqueue until ``decode_step`` returns, and
    the wall time to the card's end), once under ``torch.profiler``:
    the card's busy time summed over its kernels, the idle share of the
    unprofiled wall time, the top kernels by device time, and the
    top-level ``aten`` ops the step runs on the host."""
    from torch.profiler import ProfilerActivity, profile
    caches, tok, pos, _ = steps[-1]
    run = clone_caches(caches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api.decode_step(params, run, tok, pos)
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del run     # one clone at a time: a long cache is 13.4 GB
    run = clone_caches(caches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        api.decode_step(params, run, tok, pos)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        # the port's ``record_function`` ranges (``moe_dispatch``, ...)
        # have device spans too, over the kernels they enqueue: not work
        if str(getattr(e, "device_type", "")).endswith("CUDA") \
                and e.key not in LM_TRAIN_RANGES:
            us = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0))
            kernels[e.key] = (us / 1e3, e.count)
    host_ops = sum(1 for e in prof.events() if e.cpu_parent is None
                   and e.name.startswith("aten::"))
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    return {"step_enqueue_ms": enqueue * 1e3, "step_wall_ms": wall * 1e3,
            "step_device_busy_ms": busy,
            "step_idle_share": max(0.0, 1 - busy / (wall * 1e3)),
            "step_kernels": sum(n for _, n in kernels.values()),
            "step_aten_ops": host_ops,
            "step_top_kernels": [{"kernel": k[:80], "ms": ms, "calls": n}
                                 for k, (ms, n) in top]}


def _median(xs: list) -> float:
    return float(np.median(xs))


def serve_bf16(card: str, flush, gen, cfg, phase: str, length: int):
    """``cfg`` in bf16 through ``repro_torch.launch.serve.BatchedServer``
    (the reference server's defaults: 6 requests of 8 prompt tokens, 4
    slots, 16 new tokens, max_seq 128), weights drawn on the card from
    the seed and cast once block by block: every request completes,
    every decode step launches K4 once a layer on ``sm90`` and nothing
    else of K1-K4, no plain attention runs (each raises); each step
    replayed from a clone of its caches (:func:`replay_plain`, with
    experts under the served routing): every K4 call within the bf16
    ``CARD_TOL``, the logits within :func:`lm_bf16_tol` of max |plain|
    of the plain attention's, and the control (the gather without the
    newest slot) failing that gate; every layer's K4 output on
    one ``length``-token prefill and one decode step after it within
    the bf16 ``CARD_TOL``; the median step, tokens/s, the host's and
    the card's time of one step beside the byte bound of the weights a
    step reads, the prefill's time, peak memory; K4 alone at the decode
    and prefill shapes.  Returns the phase's row, its launches and the
    K4 rows."""
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = BatchedServer(cfg, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                           device="cuda", seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = _nbytes(server.params)
    reqs = lm_requests(cfg, SEED + 12)
    routing = Routing(moe_layers(cfg)) if cfg.n_experts else None
    counts = {}
    with counted(counts), no_plain_attention(), _recorded(routing):
        steps, secs = serve_lm(server, reqs, "sm90", cfg.n_layers)
    serve_peak = torch.cuda.max_memory_allocated()
    require(k4_only(counts, "sm90", cfg.n_layers * len(steps)),
            f"{phase} launches {counts}")
    api, params = server.api, server.params
    extra = {}
    tol = lm_bf16_tol(cfg)
    teacher = replay_plain(api, params, steps, tol, phase, routing)
    if routing:
        cap = MOE.bin_capacity(LM_SLOTS, cfg.top_k, cfg.n_experts,
                               cfg.capacity_factor)
        dropped = [routing.dropped(i, cfg.n_experts, cap)
                   for i in range(len(steps))]
        extra = {"n_experts": cfg.n_experts, "top_k": cfg.top_k,
                 "capacity_factor": cfg.capacity_factor,
                 "decode_capacity": cap, "dropped_pairs_per_step": dropped,
                 "dropped_pairs": sum(dropped),
                 "block_weights_gb": _nbytes(params["blocks"]) / 1e9}
    controls = control_drop_newest(api, params, steps, tol, routing)
    timing = profile_decode_step(api, params, steps)
    generated = sum(len(r.out) for r in reqs)
    del steps, routing
    layers = per_layer_k4(api, params, cfg.compute_dtype, gen, length)
    toks = torch.randint(0, cfg.vocab, (1, length), generator=gen).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = api.prefill(params, {"tokens": toks}, max_seq=length)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    require(bool(torch.isfinite(logits[:, :cfg.vocab]).all()),
            f"{phase} prefill: logits not finite")
    del logits, caches
    peak = torch.cuda.max_memory_allocated()
    del server, api, params
    _free()
    # K4 alone at the decode shape, and at the prefill's where the
    # ``attention`` phase has not timed that shape (phi3's 4096 and
    # mixtral's windowed 8192 are its own rows)
    shapes = [("decode", LM_SLOTS, 1, LM_MAX_SEQ, False, 0)]
    if (cfg.name, 1, length, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.window, True) not in ATTN_FULL:
        shapes.append(("prefill", 1, length, length, True, cfg.window))
    k4_rows = k4_lm_rows(cfg, cfg.compute_dtype, gen, flush, card, shapes)
    row = {"phase": phase, "config": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab, "window": cfg.window,
           "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
           "dtype": str(cfg.compute_dtype), "requests": len(reqs),
           "completed": sum(r.done for r in reqs), "slots": LM_SLOTS,
           "gen": LM_GEN, "max_seq": LM_MAX_SEQ, "steps": len(secs),
           "generated_tokens": generated, "launches": counts,
           "k4_sm90_per_step": cfg.n_layers,
           "init_s": init_s, "weights_gb": weights / 1e9,
           "step_bound_ms": weights / HBM_BYTES_PER_S * 1e3,
           "step_bound_by": "bytes",
           "step_ms_median": _median(secs) * 1e3,
           "step_ms_min": min(secs) * 1e3, "step_ms_max": max(secs) * 1e3,
           "tokens_per_s": generated / sum(secs), **timing,
           "prefill_tokens": length,
           "prefill_ms": prefill_s * 1e3,
           "serve_peak_gb": serve_peak / 1e9, "peak_gb": peak / 1e9,
           "teacher_forced": teacher, "control_drop_newest": controls,
           "per_layer_k4": layers, **extra, "card": card}
    return row, counts, k4_rows


def phase_lm_serve(card: str) -> dict:
    """phi3-medium-14b at full width and depth in bf16
    (:func:`serve_bf16`: 40 K4 ``sm90`` launches a decode step, the
    served logits within :data:`LM_BF16_TOL` of max |plain| of the plain
    replay, the per-layer check on a 4096-token prefill).  Then the same
    config cut to 4 layers in f32 (:func:`lm_f32`).  Returns the
    launches of both runs."""
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    gen = torch.Generator().manual_seed(SEED + 11)
    row, counts, k4_rows = serve_bf16(card, flush, gen, get_config(LM_ARCH),
                                      "lm_serve", LM_PREFILL_S)
    emit(row)
    f32 = lm_f32(card, flush, gen)
    return {"bf16": counts, "f32": f32["launches"], "rows": k4_rows,
            "f32_rows": f32["rows"], "step_ms_median": row["step_ms_median"]}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _tensors(tree) -> list:
    return [t for t in TREE.leaves(tree) if isinstance(t, torch.Tensor)]


def attention_layers(cfg) -> int:
    """The attention sublayers a decode step runs (each one K4 call):
    the encoder-decoder's self- and cross-attention a decoder layer."""
    if cfg.family == "encdec":
        return 2 * cfg.n_layers
    return sum(mixer == "attn" for mixer, _ in LM_T.block_spec(cfg)) \
        * LM_T.n_blocks(cfg)


def moe_layers(cfg) -> int:
    """The MoE FFNs a decode step runs (each one ``router_top_k`` call)."""
    return sum(ffn == "moe" for _, ffn in LM_T.block_spec(cfg)) \
        * LM_T.n_blocks(cfg)


def no_drops(cfg):
    """``cfg`` with a capacity factor that drops no pair (the
    reference's decode-against-prefill tests' setting), where there are
    experts: a prefill and a decode step route different token counts
    into bins of different capacity."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))


def lm_f32(card: str, flush, gen, arch: str = LM_ARCH,
           phase: str = "lm_serve_f32", layers: int = LM_F32_LAYERS) -> dict:
    """``arch`` at full width cut to ``layers`` (4), f32 compute (K4 on
    ``sm90_tf32``): served through ``BatchedServer`` as the bf16 run is,
    4 K4 launches a step, every step's logits within ``TOL`` of the
    plain replay (under the served routing, where there are experts)
    and every K4 call within ``CARD_TOL`` (:func:`replay_plain`);
    decode against prefill (a prefill of S - 1 tokens and one decode
    step against a prefill of S) within ``TOL`` of max |logits|; with
    ``window`` 64, a 60-token prefill and 8 decode steps across the
    ring's wrap, each within ``TOL`` of its plain replay and the last of
    a 68-token prefill (these two with :func:`no_drops`)."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              compute_dtype=torch.float32)
    server = BatchedServer(cfg, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                           device="cuda", seed=SEED)
    reqs = lm_requests(cfg, SEED + 12)
    routing = Routing(moe_layers(cfg)) if cfg.n_experts else None
    counts = {}
    with counted(counts), no_plain_attention(), _recorded(routing):
        steps, secs = serve_lm(server, reqs, "sm90_tf32", cfg.n_layers)
    require(k4_only(counts, "sm90_tf32", cfg.n_layers * len(steps)),
            f"{phase} launches {counts}")
    params = server.params
    teacher = replay_plain(server.api, params, steps, TOL, phase, routing)
    del steps
    api = build_lm(no_drops(cfg))
    toks = torch.randint(0, cfg.vocab, (LM_SLOTS, LM_WINDOW + 8),
                         generator=gen).cuda()
    full, _ = api.prefill(params, {"tokens": toks[:, :LM_S]}, max_seq=LM_S)
    _, caches = api.prefill(params, {"tokens": toks[:, :LM_S - 1]},
                            max_seq=LM_S)
    dec, _ = api.decode_step(params, caches, toks[:, LM_S - 1:LM_S],
                             LM_S - 1)
    decode_vs_prefill = _rel(dec, full, cfg.vocab)
    require(decode_vs_prefill <= TOL, f"{phase}: decode against "
                                      f"prefill {decode_vs_prefill}")
    wapi = build_lm(dataclasses.replace(no_drops(cfg), window=LM_WINDOW))
    start = LM_WINDOW - 4
    _, caches = wapi.prefill(params, {"tokens": toks[:, :start]},
                             max_seq=LM_MAX_SEQ)
    ring = []
    for pos in range(start, LM_WINDOW + 4):
        before = clone_caches(caches)
        step = Routing(moe_layers(cfg)) if cfg.n_experts else None
        with _recorded(step):
            logits, caches = wapi.decode_step(params, caches,
                                              toks[:, pos:pos + 1], pos)
        with _routed(step, 0):
            plain, _ = wapi.decode_step(params, before,
                                        toks[:, pos:pos + 1], pos,
                                        attn="plain")
        ring.append(_rel(logits, plain, cfg.vocab))
    slots = caches[0]["sub0"]["pos"]
    full, _ = wapi.prefill(params, {"tokens": toks[:, :LM_WINDOW + 4]},
                           max_seq=LM_MAX_SEQ)
    wrap_vs_prefill = _rel(logits, full, cfg.vocab)
    require(max(ring) <= TOL and wrap_vs_prefill <= TOL,
            f"{phase} ring: {ring}, against prefill {wrap_vs_prefill}")
    require(len(slots) == LM_WINDOW and int(slots[0]) == LM_WINDOW,
            f"{phase} ring: slots {slots.tolist()} did not wrap")
    del server, api, params, caches
    torch.cuda.empty_cache()
    rows = k4_lm_rows(cfg, torch.float32, gen, flush, card,
                      (("decode", LM_SLOTS, 1, LM_MAX_SEQ, False, 0),))
    emit({"phase": phase, "config": arch,
          "layers": cfg.n_layers, "dtype": "torch.float32",
          "requests": len(reqs), "completed": sum(r.done for r in reqs),
          "steps": len(secs), "launches": counts,
          "k4_sm90_tf32_per_step": cfg.n_layers,
          "step_ms_median": _median(secs) * 1e3,
          "teacher_forced": teacher,
          "decode_vs_prefill": {"err_over_max": decode_vs_prefill,
                                "gate": TOL, "s": LM_S},
          "ring": {"window": LM_WINDOW, "positions": [start, LM_WINDOW + 3],
                   "err_over_max_plain": max(ring),
                   "last_vs_prefill": wrap_vs_prefill, "gate": TOL},
          "seconds": time.perf_counter() - t0, "card": card})
    return {"launches": counts, "rows": rows}


# --------------------------------------------------------------------------
# lm_serve_moe, lm_serve_ssm, lm_serve_hybrid: mixtral-8x7b (MoE FFN,
# window 4096), mamba2-1.3b (Mamba2 mixer) and jamba (both) through
# BatchedServer
# --------------------------------------------------------------------------

MOE_ARCH, SSM_ARCH, HYBRID_ARCH = ("mixtral-8x7b", "mamba2-1.3b",
                                   "jamba-1.5-large-398b")
#: mixtral at full width is cut to 20 of its 32 blocks (92.9 GB of bf16
#: blocks at full depth do not fit 80 GB)
MOE_LAYERS = 20
#: the windowed per-layer check's prefill: twice mixtral's 4096 window
MOE_PREFILL_S = 8192
#: mamba2's f32 decode-against-prefill prompt: two 256-row chunks and a
#: padded third
SSM_PROMPT = 600
#: mamba2's gate on one served bf16 mixer's own output against the same
#: mixer in f32 on the same input, over max |f32|: a fixed constant, set
#: from the first full-width readings (sound mixers 0.0377 at worst, the
#: reset-state control 0.59 on the residual).  On the CPU the port's bf16
#: mixer lies as far from f32 as the reference's own
#: (``tests/test_torch_ssm_bf16.py``).
SSM_MIXER_TOL = 0.1


def block_reckoning(cfg) -> dict:
    """One block's parameters from ``ModelConfig.param_count`` (the
    config at one block's layers, less the tied embedding and the final
    norm), its bytes in the compute type, the f32 embedding, and the
    whole depth's blocks."""
    per = len(LM_T.block_spec(cfg))
    one = dataclasses.replace(cfg, n_layers=per).param_count() \
        - cfg.vocab * cfg.d_model - cfg.d_model
    elt = torch.finfo(cfg.compute_dtype).bits // 8
    full = get_config(cfg.name)
    return {"block_params": one, "block_gb": one * elt / 1e9,
            "embed_gb_f32": cfg.vocab * cfg.d_model * 4 / 1e9,
            "blocks": LM_T.n_blocks(cfg),
            "blocks_gb": one * elt * LM_T.n_blocks(cfg) / 1e9,
            "full_depth_blocks": LM_T.n_blocks(full),
            "full_depth_blocks_gb": one * elt * LM_T.n_blocks(full) / 1e9}


def _free() -> None:
    """Return the cached blocks of freed tensors to the card before the
    next model is drawn."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def moe_cfg():
    """mixtral-8x7b at full width cut to :data:`MOE_LAYERS` blocks."""
    return dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)


def phase_lm_serve_moe(card: str, flush) -> dict:
    """mixtral-8x7b at full width (d_model 4096, 8 experts of d_ff 14336,
    top-2, capacity factor 1.25, window 4096) and 20 of its 32 blocks in
    bf16 through :func:`serve_bf16`: 20 K4 ``sm90`` launches a decode
    step; each step replayed under the served routing (the MoE layers'
    choices recorded in the served step; the replay's own flips
    counted) by :func:`replay_plain`: every K4 call of every step
    within ``CARD_TOL`` of the plain version on its own inputs, the
    served logits within :data:`LM_BF16_TOL` of max |plain| of the
    plain replay's; the control failing that gate; the pairs the capacity dropped per step; the per-layer check
    on an 8192-token prefill and the decode step after it (max_seq
    8193: a 4096-slot ring, the window masking keys at the prefill's
    end and at decode).  Then 4 blocks in f32 (:func:`lm_f32`)."""
    gen = torch.Generator().manual_seed(SEED + 21)
    cfg = moe_cfg()
    row, counts, k4_rows = serve_bf16(card, flush, gen, cfg, "lm_serve_moe",
                                      MOE_PREFILL_S)
    emit({**row, "full_depth_layers": get_config(MOE_ARCH).n_layers,
          "reduced": f"depth: {cfg.n_layers} of "
                     f"{get_config(MOE_ARCH).n_layers} blocks",
          "reckoning": block_reckoning(cfg)})
    f32 = lm_f32(card, flush, gen, MOE_ARCH, "lm_serve_moe_f32")
    return {"bf16": counts, "f32": f32["launches"], "rows": k4_rows,
            "f32_rows": f32["rows"], "step_ms_median": row["step_ms_median"]}


def _f32_caches(caches: list, zero_state: bool = False) -> list:
    """A clone of a step's caches in f32 (the conv tail widened from the
    compute type; the SSM state already f32), the state zeroed for the
    control."""
    out = clone_caches(caches)
    for block in out:
        for c in block.values():
            if "conv" in c:
                c["conv"] = c["conv"].float()
            if zero_state and "ssm" in c:
                c["ssm"] = torch.zeros_like(c["ssm"])
    return out


def _rel_max(out, ref) -> float:
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def ssm_f32_replay(cfg, params, steps) -> dict:
    """Each served bf16 step of mamba2 (every block one Mamba2 mixer)
    replayed layer by layer, teacher-forced: the step's own bf16 layers
    again from a clone of its caches (their logits equal to the served
    ones bit for bit, and each layer's new SSM state and conv tail equal
    to what the server holds for the next step, both required), and
    beside each layer the same layer in f32 on that layer's input
    widened, from the same bf16-rounded weights widened exactly and an
    f32 clone of its caches.  Each layer's output (the residual stream
    the next layer and the logits read) within :data:`LM_BF16_TOL` of
    max |f32|, and each mixer's own output within :data:`SSM_MIXER_TOL`
    of max |f32 mixer| (:func:`expect`); the control, the f32 layer's
    SSM state reset to zero at :data:`LM_CONTROL_POS`, must fail both
    gates.  (A plain-attention replay would repeat an attention-free
    model bit for bit.)  Reported beside it, not gated: each mixer's new
    state against the f32 layer's, and the whole step in f32 from the
    step's caches, whose logits carry 48 layers of bf16 rounding (the
    reference's own bf16 logits lie beyond 2e-2 of its f32 logits at 4
    layers: ``tests/test_torch_ssm_bf16.py``)."""
    require(LM_T.block_spec(cfg) == [("mamba", None)],
            f"ssm_f32_replay takes Mamba-only blocks, not "
            f"{LM_T.block_spec(cfg)}")
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    api = build_lm(f32)
    wide = TREE.tree_map(lambda t: t.float() if isinstance(t, torch.Tensor)
                         and t.is_floating_point() else t, params)
    table = params.get("lm_head", params["embed"])
    res_errs, out_errs, state_errs, logits_errs = [], [], [], []
    controls, handoff = [], True
    for t, (caches, tok, pos, logits) in enumerate(steps):
        wide_caches = _f32_caches(caches)
        zeroed = _f32_caches(caches, zero_state=True)
        nxt = steps[t + 1][0] if t + 1 < len(steps) else None
        h = LM_EMB.embed_tokens(params["embed"], tok).to(cfg.compute_dtype)
        res, outs, sts, ctrl, ctrl_mix = [], [], [], [], []
        for i, (bp, c) in enumerate(zip(params["blocks"], caches)):
            sub, sub32 = bp["sub0"], wide["blocks"][i]["sub0"]
            x = rms_norm(h, sub["ln1"], cfg.norm_eps)
            out, (st, conv) = SSM.mamba_decode(
                sub["mamba"], x, cfg, c["sub0"]["ssm"].clone(),
                c["sub0"]["conv"].clone())
            if nxt is not None:
                handoff &= bool(torch.equal(st, nxt[i]["sub0"]["ssm"])
                                and torch.equal(conv,
                                                nxt[i]["sub0"]["conv"]))
            x32 = rms_norm(h.float(), sub32["ln1"], cfg.norm_eps)
            out32, (st32, _c32) = SSM.mamba_decode(
                sub32["mamba"], x32, f32, wide_caches[i]["sub0"]["ssm"],
                wide_caches[i]["sub0"]["conv"])
            h_next = h + out
            res.append(_rel_max(h_next, h.float() + out32))
            outs.append(_rel_max(out, out32))
            sts.append(_rel_max(st, st32))
            if pos in LM_CONTROL_POS:
                wrong, _ = SSM.mamba_decode(
                    sub32["mamba"], x32, f32, zeroed[i]["sub0"]["ssm"],
                    zeroed[i]["sub0"]["conv"])
                ctrl.append(_rel_max(h_next, h.float() + wrong))
                ctrl_mix.append(_rel_max(out, wrong))
            h = h_next
        again = LM_EMB.lm_logits(rms_norm(h, params["final_ln"],
                                          cfg.norm_eps), table, cfg.vocab)
        require(torch.equal(again, logits),
                f"lm_serve_ssm: the layer-by-layer replay at pos {pos} "
                f"does not repeat the served step")
        whole, _ = api.decode_step(wide, wide_caches, tok, pos)
        res_errs.append(max(res))
        out_errs.append(max(outs))
        state_errs.append(max(sts))
        logits_errs.append(_rel(logits, whole, cfg.vocab))
        if ctrl:
            controls.append({"what": "SSM state reset to zero", "pos": pos,
                             "worst_layer_err_over_max_f32": max(ctrl),
                             "layers_over_gate": sum(
                                 e > LM_BF16_TOL for e in ctrl),
                             "gate": LM_BF16_TOL,
                             "worst_mixer_err_over_max_f32": max(ctrl_mix),
                             "mixers_over_gate": sum(
                                 e > SSM_MIXER_TOL for e in ctrl_mix),
                             "mixer_gate": SSM_MIXER_TOL})
            require(max(ctrl) > LM_BF16_TOL
                    and max(ctrl_mix) > SSM_MIXER_TOL,
                    f"lm_serve_ssm control at pos {pos} passes: layer "
                    f"{max(ctrl)}, mixer {max(ctrl_mix)}")
    require(handoff, "lm_serve_ssm: a layer's new state or conv tail is not "
                     "what the server holds for the next step")
    require(len(controls) == len(LM_CONTROL_POS),
            f"lm_serve_ssm controls {controls}")
    worst, worst_mix = max(res_errs), max(out_errs)
    expect(worst <= LM_BF16_TOL, f"lm_serve_ssm: a served bf16 layer's "
                                 f"output err {worst} of max |f32 replay| "
                                 f"> {LM_BF16_TOL}")
    expect(worst_mix <= SSM_MIXER_TOL,
           f"lm_serve_ssm: a served bf16 mixer's own output err "
           f"{worst_mix} of max |f32 mixer| > {SSM_MIXER_TOL}")
    del api, wide
    return {"max_layer_err_over_max_f32": worst, "gate": LM_BF16_TOL,
            "within_gate": worst <= LM_BF16_TOL,
            "layer_err_by_step": res_errs, "layers": cfg.n_layers,
            "max_mixer_err_over_max_f32": worst_mix,
            "mixer_gate": SSM_MIXER_TOL,
            "mixer_within_gate": worst_mix <= SSM_MIXER_TOL,
            "mixer_err_by_step": out_errs,
            "steps": len(steps), "state_handoff_bit_equal": handoff,
            "control_state_reset": controls,
            "ungated": {
                "state_err_max": max(state_errs),
                "state_err_by_step": state_errs,
                "logits_vs_whole_f32_step_max": max(logits_errs),
                "logits_vs_whole_f32_step_by_step": logits_errs}}


def phase_lm_serve_ssm(card: str) -> dict:
    """mamba2-1.3b (attention-free, 48 Mamba2 layers, d_model 2048, state
    128) at full width and depth in bf16 through ``BatchedServer`` at the
    reference server's defaults: every request completes, no launch of
    K1-K4; each step replayed layer by layer in f32
    (:func:`ssm_f32_replay`: every layer's output within
    :data:`LM_BF16_TOL` of max |f32| and every mixer's own output within
    :data:`SSM_MIXER_TOL`, the state handed to the next step bit for bit,
    the reset-state control failing both gates); the step
    time, tokens/s and peak memory.  Then at full width
    and depth in f32: a :data:`SSM_PROMPT`-token prefill's last logits
    against a prefill of one token fewer and one decode step, within
    ``TOL`` of max |logits| (the chunked scan over two full 256-row
    chunks and a padded third, its state handoff, and the recurrence)."""
    _free()
    cfg = get_config(SSM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    server = BatchedServer(cfg, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                           device="cuda", seed=SEED)
    weights = _nbytes(server.params)
    reqs = lm_requests(cfg, SEED + 12)
    counts = {}
    with counted(counts), no_plain_attention():
        steps, secs = serve_lm(server, reqs, "sm90", 0)
    require(not any(n for c in counts.values() for n in c.values()),
            f"lm_serve_ssm: a kernel launched on an attention-free path "
            f"{counts}")
    logits = steps[-1][3]
    require(bool(torch.isfinite(logits[:, :cfg.vocab]).all()),
            "lm_serve_ssm: logits not finite")
    serve_peak = torch.cuda.max_memory_allocated()
    generated = sum(len(r.out) for r in reqs)
    f32_replay = ssm_f32_replay(cfg, server.params, steps)
    del server, steps, logits
    _free()
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    api = build_lm(f32)
    params = api.init(torch.Generator(device="cuda").manual_seed(SEED))
    toks = torch.randint(0, cfg.vocab, (2, SSM_PROMPT),
                         generator=torch.Generator().manual_seed(
                             SEED + 31)).cuda()
    f32_counts = {}
    with counted(f32_counts):
        full, _ = api.prefill(params, {"tokens": toks}, max_seq=SSM_PROMPT)
        _, caches = api.prefill(params, {"tokens": toks[:, :-1]},
                                max_seq=SSM_PROMPT)
        dec, _ = api.decode_step(params, caches, toks[:, -1:],
                                 SSM_PROMPT - 1)
    decode_vs_prefill = _rel(dec, full, cfg.vocab)
    require(decode_vs_prefill <= TOL, f"lm_serve_ssm f32: decode against "
                                      f"prefill {decode_vs_prefill}")
    require(not any(n for c in f32_counts.values() for n in c.values()),
            f"lm_serve_ssm f32: launches {f32_counts}")
    del api, params, caches, full, dec
    _free()
    emit({"phase": "lm_serve_ssm", "config": SSM_ARCH,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "ssm_state": cfg.ssm_state, "ssm_heads": cfg.ssm_heads,
          "vocab": cfg.vocab, "dtype": str(cfg.compute_dtype),
          "weights_gb": weights / 1e9, "requests": len(reqs),
          "completed": sum(r.done for r in reqs), "steps": len(secs),
          "generated_tokens": generated, "launches": counts,
          "step_ms_median": _median(secs) * 1e3,
          "step_ms_min": min(secs) * 1e3, "step_ms_max": max(secs) * 1e3,
          "tokens_per_s": generated / sum(secs),
          "serve_peak_gb": serve_peak / 1e9, "f32_replay": f32_replay,
          "f32_decode_vs_prefill": {"err_over_max": decode_vs_prefill,
                                    "gate": TOL, "prompt": SSM_PROMPT,
                                    "chunks": -(-SSM_PROMPT // 256)},
          "card": card})
    return {"bf16": counts, "f32": f32_counts}


def phase_lm_serve_hybrid(card: str) -> dict:
    """jamba-1.5-large-398b at ``reduced()`` size in f32 (one block of 8
    sublayers: one attention and seven Mamba2 mixers, an MoE FFN on
    every odd sublayer) through ``BatchedServer``: every request
    completes, one K4 ``sm90_tf32`` launch a decode step per block and
    nothing else of K1-K4; each step's logits within ``TOL`` of the
    plain replay under the served routing; decode against prefill within
    ``TOL`` (:func:`no_drops`).  Full width does not fit the card: one
    8-sublayer block is 44.06e9 parameters, 88.1 GB in bf16."""
    _free()
    full = get_config(HYBRID_ARCH)
    cfg = reduced(full)
    server = BatchedServer(cfg, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                           device="cuda", seed=SEED)
    reqs = lm_requests(cfg, SEED + 12)
    routing = Routing(moe_layers(cfg))
    per_step = attention_layers(cfg)
    counts = {}
    with counted(counts), no_plain_attention(), routing.record():
        steps, secs = serve_lm(server, reqs, "sm90_tf32", per_step)
    require(k4_only(counts, "sm90_tf32", per_step * len(steps)),
            f"lm_serve_hybrid launches {counts}")
    params = server.params
    teacher = replay_plain(server.api, params, steps, TOL,
                           "lm_serve_hybrid", routing)
    api = build_lm(no_drops(cfg))
    toks = torch.randint(0, cfg.vocab, (LM_SLOTS, LM_S),
                         generator=torch.Generator().manual_seed(
                             SEED + 41)).cuda()
    full_logits, _ = api.prefill(params, {"tokens": toks}, max_seq=LM_S)
    _, caches = api.prefill(params, {"tokens": toks[:, :-1]}, max_seq=LM_S)
    dec, _ = api.decode_step(params, caches, toks[:, -1:], LM_S - 1)
    decode_vs_prefill = _rel(dec, full_logits, cfg.vocab)
    require(decode_vs_prefill <= TOL, f"lm_serve_hybrid: decode against "
                                      f"prefill {decode_vs_prefill}")
    del server, api, params, caches, steps
    _free()
    emit({"phase": "lm_serve_hybrid", "config": HYBRID_ARCH,
          "size": "reduced()", "blocks": LM_T.n_blocks(cfg),
          "block_spec": LM_T.block_spec(cfg), "d_model": cfg.d_model,
          "n_experts": cfg.n_experts, "dtype": "torch.float32",
          "why_reduced": "one full-width block of 8 sublayers is "
                         f"{block_reckoning(full)['block_params']:.4g} "
                         f"parameters, "
                         f"{block_reckoning(full)['block_gb']:.1f} GB in "
                         "bf16: more than the card's 80 GB; full width "
                         "waits for parallel/ on four cards",
          "requests": len(reqs), "completed": sum(r.done for r in reqs),
          "steps": len(secs), "launches": counts,
          "k4_sm90_tf32_per_step": per_step,
          "step_ms_median": _median(secs) * 1e3,
          "teacher_forced": teacher,
          "decode_vs_prefill": {"err_over_max": decode_vs_prefill,
                                "gate": TOL, "s": LM_S},
          "card": card})
    return {"f32": counts}


# --------------------------------------------------------------------------
# lm_serve_encdec: whisper-medium (the encoder-decoder) at full size
# --------------------------------------------------------------------------

ENCDEC_ARCH = "whisper-medium"
#: the audio path: frames drawn as the reference's ``make_batch`` draws
#: them (normal x 0.02), an 8-token prompt, then greedy decode steps
ENCDEC_FRAMES_SCALE, ENCDEC_STEPS = 0.02, 16
#: K4 alone at whisper's shapes: the encoder (non-causal 1500 x 1500),
#: the cross-attention prefill (8 x 1500) and decode (1 x 1500)
ENCDEC_K4_SHAPES = (
    ("encoder", LM_SLOTS, LM_E.ENC_FRAMES, LM_E.ENC_FRAMES, False, 0),
    ("cross_prefill", LM_SLOTS, LM_PROMPT, LM_E.ENC_FRAMES, False, 0),
    ("cross_decode", LM_SLOTS, 1, LM_E.ENC_FRAMES, False, 0))


def _merged(*counts: dict) -> dict:
    """Launch counts of several :func:`counted` blocks, summed."""
    return {name: {r: sum(c[name][r] for c in counts)
                   for r in counts[0][name]} for name in counts[0]}


def _once_ms(fn) -> float:
    """The host-clock ms of one call of ``fn``, ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def encdec_audio(api, params, gen, tol: float, what: str) -> dict:
    """whisper's audio path on ``params``: ``LM_SLOTS`` utterances of
    ``ENC_FRAMES`` frames and an ``LM_PROMPT``-token prompt through
    ``api.prefill`` (72 K4 launches on the route of the compute type:
    24 non-causal encoder, 24 causal self, 24 cross, and nothing else
    of K1-K4), then :data:`ENCDEC_STEPS` greedy ``decode_step``s from
    its caches (48 a step).  The prefill's logits and every step's
    within ``tol`` of max |plain| of the plain replay (:func:`expect`),
    every K4 call within ``CARD_TOL`` on its own inputs and each call
    repeating bit for bit (:func:`replay_plain`); in f32 also the last
    logits of a 9-token prefill against an 8-token prefill and one
    decode step, within ``TOL``.  Encode, prefill and step times."""
    cfg = api.cfg
    dtype = cfg.compute_dtype
    rt = "sm90" if dtype == torch.bfloat16 else "sm90_tf32"
    frames = _randn(gen, LM_SLOTS, LM_E.ENC_FRAMES, cfg.d_model,
                    scale=ENCDEC_FRAMES_SCALE)
    toks = torch.randint(0, cfg.vocab, (LM_SLOTS, LM_PROMPT + 1),
                         generator=gen).cuda()
    batch = {"tokens": toks[:, :LM_PROMPT], "frames": frames}
    prefill_counts, decode_counts = {}, {}
    with counted(prefill_counts), no_plain_attention():
        logits, caches = api.prefill(params, batch, max_seq=LM_MAX_SEQ)
        torch.cuda.synchronize()
    require(k4_only(prefill_counts, rt, 3 * cfg.n_layers),
            f"{what} prefill launches {prefill_counts}")
    plain, _ = api.prefill(params, batch, max_seq=LM_MAX_SEQ, attn="plain")
    per_call = []
    again, _ = api.prefill(params, batch, max_seq=LM_MAX_SEQ,
                           tap=k4_against_plain(dtype, per_call))
    require(torch.equal(again, logits), f"{what}: the prefill did not "
                                        f"repeat")
    require(len(per_call) == 3 * cfg.n_layers and max(per_call) <= 1.0,
            f"{what} prefill: K4 calls against the plain version, worst "
            f"{max(per_call)} of CARD_TOL over {len(per_call)} calls")
    prefill_err = _rel(logits, plain, cfg.vocab)
    expect(prefill_err <= tol, f"{what} prefill: logits err {prefill_err} "
                               f"of max |plain| > {tol}")
    del plain, again
    steps, secs = [], []
    tok = logits.argmax(-1, keepdim=True)
    with counted(decode_counts), no_plain_attention():
        for pos in range(LM_PROMPT, LM_PROMPT + ENCDEC_STEPS):
            before = clone_caches(caches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = api.decode_step(params, caches, tok, pos)
            nxt = logits.argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            steps.append((before, tok, pos, logits))
            tok = nxt
    require(k4_only(decode_counts, rt, 2 * cfg.n_layers * ENCDEC_STEPS),
            f"{what} decode launches {decode_counts}")
    teacher = replay_plain(api, params, steps, tol, what)
    del steps, caches
    out = {"frames": list(frames.shape), "prompt": LM_PROMPT,
           "k4_route": rt, "k4_per_prefill": 3 * cfg.n_layers,
           "k4_per_step": 2 * cfg.n_layers,
           "launches": _merged(prefill_counts, decode_counts),
           "prefill_err_over_max_plain": prefill_err,
           "prefill_per_call_worst_over_card_tol": max(per_call),
           "decode": teacher, "gate": tol,
           "encode_ms": _once_ms(lambda: LM_E.encode(params, frames, cfg)),
           "prefill_ms": _once_ms(
               lambda: api.prefill(params, batch, max_seq=LM_MAX_SEQ)),
           "step_ms_median": _median(secs) * 1e3,
           "step_ms_min": min(secs) * 1e3, "step_ms_max": max(secs) * 1e3}
    if dtype == torch.float32:
        full, _ = api.prefill(params, dict(batch, tokens=toks),
                              max_seq=LM_MAX_SEQ)
        _, caches = api.prefill(params, batch, max_seq=LM_MAX_SEQ)
        dec, _ = api.decode_step(params, caches, toks[:, LM_PROMPT:],
                                 LM_PROMPT)
        err = _rel(dec, full, cfg.vocab)
        require(err <= TOL, f"{what}: decode against prefill {err}")
        out["decode_vs_prefill"] = {"err_over_max": err, "gate": TOL,
                                    "s": LM_PROMPT + 1}
    return out


def phase_lm_serve_encdec(card: str, flush) -> dict:
    """whisper-medium at full width and depth (24 encoder and 24
    decoder layers, d_model 1024, 16 heads of 64, vocab 51865):

      * served in bf16 through ``BatchedServer`` at the reference
        server's defaults, as the reference's server serves it (decode
        only, from ``init_cache``: the cross-attention over 1500 zero
        slots adds 0): every request completes, 48 K4 ``sm90`` launches
        a step (24 self, 24 cross) and nothing else of K1-K4, no plain
        attention; each step replayed (:func:`replay_plain`) and the
        gather control (:func:`control_drop_newest`); step time,
        tokens/s, one profiled step beside the byte bound of what a step
        reads (the decoder's blocks, the table and the caches), peak;
      * the audio path (:func:`encdec_audio`) in bf16 on the served
        weights, then in f32 on weights drawn in f32;
      * K4 alone at :data:`ENCDEC_K4_SHAPES` in both types.

    Returns the launches by type and the K4 rows."""
    _free()
    gen = torch.Generator().manual_seed(SEED + 51)
    cfg = get_config(ENCDEC_ARCH)
    torch.cuda.reset_peak_memory_stats()
    server = BatchedServer(cfg, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                           device="cuda", seed=SEED)
    api, params = server.api, server.params
    weights = _nbytes(params)
    step_bytes = _nbytes([params["dec_blocks"], params["embed"],
                          params["final_ln"], server.caches])
    reqs = lm_requests(cfg, SEED + 12)
    per_step = attention_layers(cfg)
    counts = {}
    with counted(counts), no_plain_attention():
        steps, secs = serve_lm(server, reqs, "sm90", per_step)
    serve_peak = torch.cuda.max_memory_allocated()
    require(k4_only(counts, "sm90", per_step * len(steps)),
            f"lm_serve_encdec launches {counts}")
    teacher = replay_plain(api, params, steps, LM_BF16_TOL,
                           "lm_serve_encdec")
    controls = control_drop_newest(api, params, steps, LM_BF16_TOL)
    timing = profile_decode_step(api, params, steps)
    generated = sum(len(r.out) for r in reqs)
    n_steps, step_ms = len(steps), _median(secs) * 1e3
    del steps
    audio_bf16 = encdec_audio(api, params, gen, LM_BF16_TOL,
                              "lm_serve_encdec audio bf16")
    peak = torch.cuda.max_memory_allocated()
    del server, api, params
    _free()
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    f32_api = build_lm(f32)
    f32_params = f32_api.init(torch.Generator(device="cuda").manual_seed(
        SEED))
    audio_f32 = encdec_audio(f32_api, f32_params, gen, TOL,
                             "lm_serve_encdec audio f32")
    del f32_api, f32_params
    _free()
    rows = [r for dtype in DTYPES for r in k4_lm_rows(
        dataclasses.replace(cfg, compute_dtype=dtype), dtype, gen, flush,
        card, ENCDEC_K4_SHAPES)]
    emit({"phase": "lm_serve_encdec", "config": ENCDEC_ARCH,
          "enc_layers": cfg.enc_layers, "dec_layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": cfg.n_heads,
          "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
          "dtype": str(cfg.compute_dtype), "requests": len(reqs),
          "completed": sum(r.done for r in reqs), "slots": LM_SLOTS,
          "gen": LM_GEN, "max_seq": LM_MAX_SEQ, "steps": n_steps,
          "generated_tokens": generated, "launches": counts,
          "k4_sm90_per_step": per_step, "weights_gb": weights / 1e9,
          "step_gb": step_bytes / 1e9,
          "step_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
          "step_bound_by": "bytes", "step_ms_median": step_ms,
          "step_ms_min": min(secs) * 1e3, "step_ms_max": max(secs) * 1e3,
          "tokens_per_s": generated / sum(secs), **timing,
          "serve_peak_gb": serve_peak / 1e9, "peak_gb": peak / 1e9,
          "teacher_forced": teacher, "control_drop_newest": controls,
          "card": card})
    for dtype, audio in ((torch.bfloat16, audio_bf16),
                         (torch.float32, audio_f32)):
        emit({"phase": "lm_serve_encdec_audio", "config": ENCDEC_ARCH,
              "dtype": str(dtype), **audio, "card": card})
    return {"bf16": _merged(counts, audio_bf16["launches"]),
            "f32": audio_f32["launches"], "rows": rows,
            "step_ms_median": step_ms}


# --------------------------------------------------------------------------
# lm_serve_dense, lm_serve_mqa, lm_serve_dbrx, lm_serve_vlm: the decoder
# configs beyond phi3 and mixtral through BatchedServer
# --------------------------------------------------------------------------

DENSE_ARCHS = ("deepseek-7b", "minitron-4b")
MQA_ARCH, DBRX_ARCH, VLM_ARCH = "granite-34b", "dbrx-132b", "llava-next-34b"
#: the depth served where 80 GB forces a cut: granite's 88 layers hold
#: 93.3 GB of bf16 blocks, 60 of them 63.6 GB; dbrx's 40 blocks 260.7
#: GB, 9 of them 58.7 GB (llava's 60 layers, 66.9 GB, are served whole)
MQA_LAYERS, DBRX_LAYERS = 60, 9
#: dbrx's f32 row: 2 blocks (4 f32 blocks are 52 GB)
DBRX_F32_LAYERS = 2
#: llava's vision-prefix path: a batch of 2, its first ``frontend_len``
#: (2880) positions prefix embeddings drawn as the reference's tests
#: draw them (normal x 0.02), 64 text tokens after them, then 16 greedy
#: decode steps (max_seq 2960)
VLM_BATCH, VLM_TEXT, VLM_STEPS, VLM_PREFIX_SCALE = 2, 64, 16, 0.02


def depth_fields(cfg) -> dict:
    """The served depth beside the published one, ``reduced`` where
    it is cut, and the blocks' reckoning (:func:`block_reckoning`)."""
    full = get_config(cfg.name).n_layers
    cut = None if cfg.n_layers == full else \
        f"depth: {cfg.n_layers} of {full} " \
        f"{'blocks' if cfg.n_experts else 'layers'}"
    return {"full_depth_layers": full, "reduced": cut,
            "reckoning": block_reckoning(cfg)}


def serve_config(card: str, flush, gen, cfg, phase: str,
                 f32_layers: int = LM_F32_LAYERS) -> dict:
    """``cfg`` in bf16 through :func:`serve_bf16` (the per-layer check on
    a :data:`LM_PREFILL_S`-token prefill), its row with its depth
    (:func:`depth_fields`) and seconds, then ``f32_layers`` of it in f32
    (:func:`lm_f32`, phase ``<phase>_f32``)."""
    t0 = time.perf_counter()
    row, counts, k4_rows = serve_bf16(card, flush, gen, cfg, phase,
                                      LM_PREFILL_S)
    row.update(depth_fields(cfg), seconds=time.perf_counter() - t0)
    emit(row)
    f32 = lm_f32(card, flush, gen, cfg.name, f"{phase}_f32", f32_layers)
    return {"bf16": counts, "f32": f32["launches"], "rows": k4_rows,
            "f32_rows": f32["rows"]}


def _served(*runs: dict) -> dict:
    """Several :func:`serve_config` runs as one phase's launches and K4
    rows (each row's ``what`` prefixed by its config)."""
    def named(rows):
        return [dict(r, what=f"{r['config']} {r['what']}") for r in rows]
    return {"bf16": _merged(*(r["bf16"] for r in runs)),
            "f32": _merged(*(r["f32"] for r in runs)),
            "rows": [r for run in runs for r in named(run["rows"])],
            "f32_rows": [r for run in runs for r in named(run["f32_rows"])]}


def phase_lm_serve_dense(card: str, flush) -> dict:
    """deepseek-7b (30 layers, 32 heads on 32 kv heads: a group of 1)
    and minitron-4b (32 layers, 24 heads over 8, vocab 256000) at full
    size in bf16, each through :func:`serve_config`: one K4 ``sm90``
    launch a layer a step, the served logits within
    :func:`lm_bf16_tol` (2e-2) of the plain replay, every K4 call within
    ``CARD_TOL``, the gather control failing the gate, the per-layer
    check on a 4096-token prefill; then 4 layers of each in f32."""
    gen = torch.Generator().manual_seed(SEED + 61)
    return _served(*(serve_config(card, flush, gen, get_config(a),
                                  "lm_serve_dense") for a in DENSE_ARCHS))


def phase_lm_serve_mqa(card: str, flush) -> dict:
    """granite-34b at full width (48 query heads on one kv head: a group
    of 48) and 60 of its 88 layers in bf16 through :func:`serve_config`
    (gate 3e-2 at 60 layers), K4 alone at its decode shape (4 x 48 heads
    over 1, 128 keys) and its 4096-token prefill beside SDPA
    (``enable_gqa``) and the bound; then 4 layers in f32."""
    gen = torch.Generator().manual_seed(SEED + 62)
    cfg = dataclasses.replace(get_config(MQA_ARCH), n_layers=MQA_LAYERS)
    return _served(serve_config(card, flush, gen, cfg, "lm_serve_mqa"))


def phase_lm_serve_dbrx(card: str, flush) -> dict:
    """dbrx-132b at full width (16 experts of d_ff 10752, top-4,
    capacity factor 1.25; 48 heads over 8) and 9 of its 40 blocks in
    bf16 through :func:`serve_config`, each step replayed under the
    served routing (the replay's flips counted), the pairs the 2-row
    decode bins dropped per step, the per-layer check on a 4096-token
    prefill (16384 pairs into 1280-row bins); then 2 blocks in f32."""
    gen = torch.Generator().manual_seed(SEED + 63)
    cfg = dataclasses.replace(get_config(DBRX_ARCH), n_layers=DBRX_LAYERS)
    return _served(serve_config(card, flush, gen, cfg, "lm_serve_dbrx",
                                DBRX_F32_LAYERS))


def vlm_prefix(card: str, flush, gen, cfg) -> dict:
    """llava's vision path at full size through the model's own API, on
    the weights the server drew (the same seed): ``prefill`` of
    :data:`VLM_BATCH` x (2880 + 64) tokens whose first 2880 positions
    are prefix embeddings (one K4 ``sm90`` launch a layer and nothing
    else of K1-K4, no plain attention), then :data:`VLM_STEPS` greedy
    ``decode_step``s from its caches at max_seq 2960 (one a layer a
    step), each step replayed right after it is served from a clone of
    its caches (:func:`replay_plain`: one clone of 1.45 GB lives at a
    time).  The prefill's last-token logits and every step's within
    :func:`lm_bf16_tol` of max |plain| of the plain replay
    (``attn="plain"``), every K4 call of the prefill and of each step
    within ``CARD_TOL`` on its own inputs, each repeating bit for bit;
    the control, the same prefill without its prefix, must move the
    logits past the gate.  Prefill and step times; K4 alone at the
    prefix prefill's and the last step's shapes."""
    dtype, tol = cfg.compute_dtype, lm_bf16_tol(cfg)
    s = cfg.frontend_len + VLM_TEXT
    max_seq = s + VLM_STEPS
    api = build_lm(cfg)
    params = api.init(torch.Generator(device="cuda").manual_seed(SEED),
                      cast_blocks=True)
    toks = torch.randint(0, cfg.vocab, (VLM_BATCH, s), generator=gen).cuda()
    prefix = _randn(gen, VLM_BATCH, cfg.frontend_len, cfg.d_model,
                    scale=VLM_PREFIX_SCALE)
    batch = {"tokens": toks, "prefix_embeds": prefix}
    prefill_counts = {}
    with counted(prefill_counts), no_plain_attention():
        logits, caches = api.prefill(params, batch, max_seq=max_seq)
        torch.cuda.synchronize()
    require(k4_only(prefill_counts, "sm90", cfg.n_layers),
            f"lm_serve_vlm prefix prefill launches {prefill_counts}")
    per_call = []
    again, _ = api.prefill(params, batch, max_seq=max_seq,
                           tap=k4_against_plain(dtype, per_call))
    require(torch.equal(again, logits),
            "lm_serve_vlm: the prefix prefill did not repeat")
    require(len(per_call) == cfg.n_layers and max(per_call) <= 1.0,
            f"lm_serve_vlm prefix prefill: K4 calls against the plain "
            f"version, worst {max(per_call)} of CARD_TOL over "
            f"{len(per_call)} calls")
    del again, _
    plain, _ = api.prefill(params, batch, max_seq=max_seq, attn="plain")
    del _
    prefill_err = _rel(logits, plain, cfg.vocab)
    expect(prefill_err <= tol, f"lm_serve_vlm prefix prefill: logits err "
                               f"{prefill_err} of max |plain| > {tol}")
    bare, _ = api.prefill(params, {"tokens": toks}, max_seq=max_seq)
    del _
    control_err = _rel(bare, plain, cfg.vocab)
    require(control_err > tol, f"lm_serve_vlm control: the prefill without "
                               f"its prefix passes, {control_err}")
    del bare, plain
    prefill_ms = _once_ms(lambda: api.prefill(params, batch,
                                              max_seq=max_seq))
    decode_counts, teacher, secs = [], [], []
    tok = logits[..., :cfg.vocab].argmax(-1).reshape(VLM_BATCH, 1)
    for pos in range(s, max_seq):
        before = clone_caches(caches)
        counts = {}
        with counted(counts), no_plain_attention():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = api.decode_step(params, caches, tok, pos)
            nxt = logits[..., :cfg.vocab].argmax(-1).reshape(VLM_BATCH, 1)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        require(k4_only(counts, "sm90", cfg.n_layers),
                f"lm_serve_vlm decode at pos {pos}: launches {counts}")
        decode_counts.append(counts)
        teacher.append(replay_plain(api, params, [(before, tok, pos, logits)],
                                    tol, "lm_serve_vlm decode"))
        del before
        tok = nxt
    del caches, params, api
    _free()
    k4_rows = k4_lm_rows(cfg, dtype, gen, flush, card, (
        ("prefix_prefill", VLM_BATCH, s, s, True, 0),
        ("prefix_decode", VLM_BATCH, 1, max_seq, False, 0)))
    errs = [t["max_err_over_max_plain"] for t in teacher]
    return {"launches": _merged(prefill_counts, *decode_counts),
            "rows": k4_rows,
            "row": {"batch": VLM_BATCH, "prefix": cfg.frontend_len,
                    "text_tokens": VLM_TEXT, "prefill_tokens": s,
                    "max_seq": max_seq, "decode_keys": [s + 1, max_seq],
                    "k4_sm90_per_prefill": cfg.n_layers,
                    "k4_sm90_per_step": cfg.n_layers, "gate": tol,
                    "prefill_replayed": prefill_err is not None,
                    "prefill_err_over_max_plain": prefill_err,
                    "prefill_per_call_worst_over_card_tol": max(per_call),
                    "control_no_prefix": {
                        "what": "the prefill without its prefix embeddings",
                        "err_over_max_plain": control_err, "gate": tol},
                    "decode_max_err_over_max_plain": max(errs),
                    "decode_err_over_max_plain_by_step": errs,
                    "decode_per_call_worst_over_card_tol": max(
                        t["per_call_worst_over_card_tol"] for t in teacher),
                    "decode_steps_greedy_equal": sum(
                        t["steps_greedy_equal"] for t in teacher),
                    "steps": len(secs),
                    "prefill_ms": prefill_ms,
                    "step_ms_median": _median(secs) * 1e3,
                    "step_ms_min": min(secs) * 1e3,
                    "step_ms_max": max(secs) * 1e3}}


def phase_lm_serve_vlm(card: str, flush) -> dict:
    """llava-next-34b at full size (60 layers, 56 heads over 8: a group
    of 7, vocab 64000) in bf16: text only through :func:`serve_config`,
    as the reference's server serves the VLM (gate 3e-2 at 60 layers),
    4 layers in f32; then its vision-prefix path (:func:`vlm_prefix`,
    row ``lm_serve_vlm_prefix``)."""
    gen = torch.Generator().manual_seed(SEED + 64)
    cfg = get_config(VLM_ARCH)
    run = serve_config(card, flush, gen, cfg, "lm_serve_vlm")
    t0 = time.perf_counter()
    _free()
    torch.cuda.reset_peak_memory_stats()
    prefix = vlm_prefix(card, flush, gen, cfg)
    emit({"phase": "lm_serve_vlm_prefix", "config": cfg.name,
          "layers": cfg.n_layers, "dtype": str(cfg.compute_dtype),
          "launches": prefix["launches"], **prefix["row"],
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0, "card": card})
    run["bf16"] = _merged(run["bf16"], prefix["launches"])
    run["rows"] = run["rows"] + prefix["rows"]
    return _served(run)


# --------------------------------------------------------------------------
# lm_long_dense, lm_long_window: the reference's long shapes (its
# ``configs/base.py`` SHAPES: prefill_32k, decode_32k, long_500k) through
# the LM entry points and K4 alone
# --------------------------------------------------------------------------

#: prefill_32k's and decode_32k's length, and long_500k's
LONG_S, LONG_500K = 32768, 524288
#: greedy decode steps after the long prefill (bf16; the f32 rows')
LONG_STEPS, LONG_F32_STEPS = 16, 4
#: phi3's batch (the reference's 32 to prefill and 128 to decode, cut to
#: fit one card: 28.7 GB of weights and a 13.4 GB cache at 2 rows) and
#: mixtral's (20 of 32 blocks are 58 GB)
LONG_DENSE_BATCH, LONG_WINDOW_BATCH = 2, 1
#: the f32 rows' depth
LONG_F32_LAYERS = 4
#: the decode steps (by index) whose controls run
LONG_CONTROL_STEPS = (0, 8)


def panel_tap(dtype, into: list, controls: dict):
    """A ``tap`` that holds each K4 call of a long prefill to the plain
    version on its panels (:func:`plain_panels`) at ``CARD_TOL``,
    appending its worst |err| / tolerance to ``into``; and, on the same
    call, each control of ``controls`` (``"row_off"``: the causal mask
    one row off; ``"window_wider"``: the window one key wider), whose
    reading it appends to the control's list."""
    def tap(layer, q, k, v, out, *, window, causal):
        panels = panel_rows(q.shape[1], LONG_PANEL)
        got = panel_cut(out, panels)
        ref, _ = plain_panels(q, k, v, window=window, causal=causal,
                              panels=panels)
        into.append(within(got, ref, dtype)["worst_over_tol"])
        del ref
        for name, readings in controls.items():
            wider = name == "window_wider"
            wrong, _ = plain_panels(
                q, k, v, window=window + 1 if wider else window,
                causal=causal, panels=panels,
                row_off=0 if wider else 1)
            readings.append(within(got, wrong, dtype)["worst_over_tol"])
    return tap


def decode_tap(dtype, caches: list, cur_pos: int, cfg, into: list,
               outside: list | None = None):
    """A ``tap`` that holds each K4 call of a decode step, whole (one
    query row), to the model's own plain decode attention over the
    layer's cache (:func:`decode_attention` in one chunk: every slot its
    mask keeps, read by position, not K4's gathered inputs) at
    ``CARD_TOL``,
    appending its worst |err| / tolerance to ``into``.  ``outside``:
    the control, each layer's (k, v) of the position one outside the
    window (the slot the step overwrote, as it held it before), the
    reference over K4's own keys and that one."""
    def tap(layer, q, k, v, out, *, window, causal):
        if outside is None:
            c = caches[layer]["sub0"]
            ref = decode_attention(q, c["k"], c["v"], c["pos"], cur_pos,
                                   window=cfg.window, chunk=c["k"].shape[1])
        else:
            k_old, v_old = outside[layer]
            ref = plain_attention(q, torch.cat([k, k_old], 1),
                                  torch.cat([v, v_old], 1), window=0,
                                  causal=False)
        into.append(within(out, ref, dtype)["worst_over_tol"])
    return tap


def written_slot(cache: dict, cur_pos: int, window: int) -> int | None:
    """The slot of an attention cache a decode step at ``cur_pos``
    writes (its ring's under a window), or ``None`` past the last."""
    slots = cache["k"].shape[1]
    slot = cur_pos % slots if window else cur_pos
    return slot if slot < slots else None


class SlotState:
    """The cache slots that decode steps at ``positions`` write, saved
    for every attention layer (K, V and position), so that a long step
    can be undone and replayed in place: at 32768 slots a clone of phi3's
    caches is 13.4 GB.  :meth:`put` writes them back."""

    def __init__(self, caches: list, positions, window: int):
        self.caches = caches
        self.saved = []
        for block in caches:
            c = block["sub0"]
            idx = sorted({s for p in positions if (s := written_slot(
                c, p, window)) is not None})
            t = torch.as_tensor(idx, dtype=torch.long, device=c["k"].device)
            self.saved.append((idx, t, c["k"][:, t].clone(),
                               c["v"][:, t].clone(), c["pos"][idx].copy()))

    def put(self) -> list:
        for block, (idx, t, k, v, pos) in zip(self.caches, self.saved):
            c = block["sub0"]
            c["k"][:, t] = k
            c["v"][:, t] = v
            c["pos"][idx] = pos
        return self.caches

    def slot(self, layer: int, slot: int) -> tuple:
        """Layer ``layer``'s saved (k, v), (B, 1, KV, hd), of ``slot``,
        and the position it held."""
        idx, _, k, v, pos = self.saved[layer]
        i = idx.index(slot)
        return k[:, i:i + 1], v[:, i:i + 1], int(pos[i])


@contextlib.contextmanager
def gather_routes(into: dict):
    """Each decode gather of the block (``models/attention.py``
    ``_gather``) counted by what it runs: ``slice`` (the kept slots
    are the cache's first) or ``index_select``."""
    gather = LM_A._gather

    def counting(c, idx):
        n = len(idx)
        into["slice" if n and idx[-1] == n - 1 else "index_select"] += 1
        return gather(c, idx)
    with patched((LM_A, "_gather", counting)):
        yield into


def widen(tree, dtype):
    """Every floating leaf of ``tree`` in ``dtype``: the f32 replay's
    cast of a bf16 block's params, one block at a time (in place of
    ``cast_params_for_compute``, which only narrows)."""
    if isinstance(tree, dict):
        return {k: widen(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [widen(v, dtype) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def f32_replay(api, params, before: SlotState, tok, pos: int,
               routing: Routing | None):
    """The logits of a decode step replayed with the plain attention in
    f32 from the caches as they were before it (``api`` built at f32
    compute; each bf16 block widened as it runs, the bf16 cache read in
    f32), under the served routing where there are experts."""
    with _routed(routing, 0), patched((LM_T, "cast_params_for_compute",
                                       widen)):
        return api.decode_step(params, before.put(), tok, pos,
                               attn="plain")[0]


def long_step(api, replay_api, params, before: SlotState, tok, pos: int,
              logits, exact, tol: float, what: str,
              routing: Routing | None) -> dict:
    """A served long decode step again from the caches as they were
    before it (``before``, written back for each run), under the served
    routing where there are experts: the logits' error over max |exact|
    of the plain replay in f32 (``exact``, :func:`f32_replay`; in an f32
    row the plain replay itself) against ``tol`` (:func:`expect`); with
    the plain attention in the compute type (``replay_api``; reported
    beside it: two bf16 computations each carry their own rounding);
    and the served
    path with :func:`decode_tap` on every K4 call (each within
    ``CARD_TOL``, and the logits equal to the served ones bit for bit:
    the step repeats)."""
    cfg = api.cfg
    plain = exact
    if cfg.compute_dtype == torch.bfloat16:
        with _routed(routing, 0, count=True):
            plain = replay_api.decode_step(params, before.put(), tok, pos,
                                           attn="plain")[0]
    per_call = []
    run = before.put()
    with _routed(routing, 0):
        again = api.decode_step(params, run, tok, pos, tap=decode_tap(
            cfg.compute_dtype, run, pos, cfg, per_call))[0]
    require(torch.equal(again, logits),
            f"{what}: the decode step at pos {pos} did not repeat")
    require(len(per_call) == attention_layers(cfg) and max(per_call) <= 1.0,
            f"{what} decode at pos {pos}: K4 calls against the plain "
            f"decode attention, worst {max(per_call)} of CARD_TOL over "
            f"{len(per_call)} calls")
    err = _rel(logits, exact, cfg.vocab)
    expect(err <= tol, f"{what} decode at pos {pos}: logits err {err} of "
                       f"max |f32 plain| > {tol}")
    return {"err": err, "per_call": max(per_call),
            "bf16_plain_err": _rel(logits, plain, cfg.vocab),
            "bf16_plain_vs_f32": _rel(plain, exact, cfg.vocab),
            "greedy_equal": bool(torch.equal(logits[..., :cfg.vocab].argmax(
                -1), exact[..., :cfg.vocab].argmax(-1)))}


def long_step_controls(api, params, before: SlotState, tok, pos: int, exact,
                       routing: Routing | None) -> dict:
    """The decode controls at one long step, each from the caches as
    they were before it under the served routing, their logits against
    the step's f32 plain replay ``exact``: the gather without the newest
    slot (the logits' error, and the worst K4 call against
    :func:`decode_tap`'s reference, which keeps it); ``cur_pos`` one off
    (RoPE at the wrong position; the logits); under a window, each K4
    call against the reference over its keys and the position one
    outside the window (:func:`decode_tap` with ``outside``)."""
    cfg = api.cfg
    dtype = cfg.compute_dtype
    per_call = []
    run = before.put()
    with drop_newest_slot(), _routed(routing, 0):
        wrong = api.decode_step(params, run, tok, pos, tap=decode_tap(
            dtype, run, pos, cfg, per_call))[0]
    out = {"pos": pos,
           "drop_newest": {"err_over_max_plain": _rel(wrong, exact,
                                                      cfg.vocab),
                           "per_call_worst_over_card_tol": max(per_call),
                           "held_to": "the per-call gate"}}
    with _routed(routing, 0):
        wrong = api.decode_step(params, before.put(), tok, pos + 1)[0]
    out["wrong_pos"] = {"err_over_max_plain": _rel(wrong, exact, cfg.vocab)}
    if cfg.window:
        outside, extra = [], []
        for i, block in enumerate(before.caches):
            slot = written_slot(block["sub0"], pos, cfg.window)
            k_old, v_old, held = before.slot(i, slot)
            require(held == pos - cfg.window,
                    f"the ring's slot {slot} held {held}, not "
                    f"{pos - cfg.window}")
            outside.append((k_old, v_old))
        with _routed(routing, 0):
            api.decode_step(params, before.put(), tok, pos,
                            tap=decode_tap(dtype, None, pos, cfg, extra,
                                           outside))
        out["window_wider"] = {"per_call_worst_over_card_tol": max(extra),
                               "per_call_min_over_card_tol": min(extra)}
    return out


def prefill_replayed(cfg) -> bool:
    """Is the long prefill's last-token logits gate run (the whole-model
    plain replay, ``attn="plain"``)?  Under a window (mixtral: 150 of
    the 1024 chunk pairs of a 32768-token prefill run) and at the f32
    rows' 4 layers it is cheap; phi3's 40 causal bf16 layers took
    62.44 s for 2 x 32768 tokens on an H100 (about 7% of the smoke's
    time), so there every K4 call is held on its panels and the f32 row
    holds the whole-model replay."""
    return bool(cfg.window) or cfg.compute_dtype == torch.float32


def long_context(card: str, cfg, phase: str, b: int, steps: int, gen
                 ) -> dict:
    """``cfg`` through its LM entry points at the reference's long
    shapes: ``prefill`` of ``b`` distinct prompts of :data:`LONG_S`
    tokens from the seed (max_seq ``LONG_S + steps``; under a window a
    ring the prefill fills ``LONG_S / window`` times over), then
    ``steps`` greedy ``decode_step``s over that cache.  Required: one K4
    launch an attention layer on the type's tensor-core route
    (``sm90``, f32 ``sm90_tf32``) and nothing else of K1-K4, no plain
    attention; every K4 call of the prefill within ``CARD_TOL`` on its
    panels (a tapped repeat whose logits equal the served ones bit for
    bit), and the controls on the same calls (the causal mask one row
    off; under a window the window one key wider) missing it; every
    decode step repeated bit for bit and each of its K4 calls within
    ``CARD_TOL`` whole (:func:`long_step`).  Gated by :func:`expect`,
    each within the type's gate (bf16 :func:`lm_bf16_tol`, f32 ``TOL``)
    of max |plain| of the whole-model plain replay (``attn="plain"``;
    with experts under the served routing): the prefill's last-token
    logits against the replay in the compute type (where
    :func:`prefill_replayed`), every step's
    against the replay in f32 (:func:`f32_replay`: at 32768 keys two
    bf16 computations of the step, each with its own rounding, lie as
    far apart as the gate; ``probes/long_replay_floor.py``), the bf16
    replay's reading beside it.  The decode controls
    (:func:`long_step_controls`) at :data:`LONG_CONTROL_STEPS`.
    Recorded: the prefill's and the plain replay's seconds, each
    step's, tokens/s, the peak memory, the decode gathers by route, one
    profiled step, the phase's seconds by part."""
    t_phase = time.perf_counter()
    dtype = cfg.compute_dtype
    bf16 = dtype == torch.bfloat16
    tol, route = (lm_bf16_tol(cfg), "sm90") if bf16 else (TOL, "sm90_tf32")
    n_attn = attention_layers(cfg)
    s, max_seq = LONG_S, LONG_S + steps
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api = build_lm(cfg)
    # the decode replays' plain attention in one chunk over every slot
    # (the model's chunk, 1024, walks phi3's 32784 slots in 33)
    replay_api = build_lm(dataclasses.replace(cfg, attn_chunk=max_seq))
    exact_api = build_lm(dataclasses.replace(
        cfg, compute_dtype=torch.float32, attn_chunk=max_seq))
    params = api.init(torch.Generator(device="cuda").manual_seed(SEED),
                      cast_blocks=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = _nbytes(params)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen).cuda()
    require(b == 1 or not torch.equal(toks[0], toks[1]),
            f"{phase}: the prompts are not distinct")
    batch = {"tokens": toks}
    routing = Routing(moe_layers(cfg)) if cfg.n_experts else None
    prefill_counts = {}
    with counted(prefill_counts), no_plain_attention(), _recorded(routing):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = api.prefill(params, batch, max_seq=max_seq)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    require(k4_only(prefill_counts, route, n_attn),
            f"{phase} prefill launches {prefill_counts}")
    require(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
            f"{phase} prefill: logits not finite")
    cache_bytes = _nbytes(caches)
    prefill_peak = torch.cuda.max_memory_allocated()
    per_call = []
    controls = {"row_off": []} | ({"window_wider": []} if cfg.window else {})
    t0 = time.perf_counter()
    again = api.prefill(params, batch, max_seq=max_seq,
                        tap=panel_tap(dtype, per_call, controls))[0]
    require(torch.equal(again, logits),
            f"{phase}: the prefill did not repeat")
    del again
    require(len(per_call) == n_attn and max(per_call) <= 1.0,
            f"{phase} prefill: K4 calls against the plain version on their "
            f"panels, worst {max(per_call)} of CARD_TOL over "
            f"{len(per_call)} calls")
    for name, readings in controls.items():
        require(len(readings) == n_attn and max(readings) > 1.0,
                f"{phase} prefill control {name} passes the per-call gate: "
                f"{readings}")
    parts = {"init": init_s, "prefill": prefill_s,
             "prefill_tapped": time.perf_counter() - t0}
    prefill_err = plain_prefill_s = prefill_flips = None
    if prefill_replayed(cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _routed(routing, 0, count=True):
            plain = api.prefill(params, batch, max_seq=max_seq,
                                attn="plain")[0]
        torch.cuda.synchronize()
        plain_prefill_s = parts["prefill_replay"] = time.perf_counter() - t0
        prefill_err = _rel(logits, plain, cfg.vocab)
        expect(prefill_err <= tol, f"{phase} prefill: logits err "
                                   f"{prefill_err} of max |plain| > {tol}")
        prefill_flips = (routing.flips, routing.rows) if routing else None
        del plain
    t_decode = time.perf_counter()
    gathers = {"slice": 0, "index_select": 0}
    step_counts, teacher, step_controls, secs = [], [], [], []
    timing = {}
    tok = logits[..., :cfg.vocab].argmax(-1).reshape(b, 1)
    def lap(part: str, t: float) -> float:
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[part] = parts.get(part, 0.0) + now - t
        return now

    for i, pos in enumerate(range(s, max_seq)):
        # the slots this step writes, and the control at pos + 1 would
        before = SlotState(caches, (pos, pos + 1), cfg.window)
        step_routing = Routing(moe_layers(cfg)) if cfg.n_experts else None
        c = {}
        with counted(c), no_plain_attention(), _recorded(step_routing), \
                gather_routes(gathers):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = api.decode_step(params, caches, tok, pos)
            nxt = logits[..., :cfg.vocab].argmax(-1).reshape(b, 1)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        require(k4_only(c, route, n_attn),
                f"{phase} decode at pos {pos}: launches {c}")
        step_counts.append(c)
        served = SlotState(caches, (pos, pos + 1), cfg.window)
        t = time.perf_counter()
        if bf16:
            exact = f32_replay(exact_api, params, before, tok, pos,
                               step_routing)
        else:
            with _routed(step_routing, 0, count=True):
                exact = replay_api.decode_step(params, before.put(), tok,
                                               pos, attn="plain")[0]
        t = lap("decode_f32_replay", t)
        teacher.append(long_step(api, replay_api, params, before, tok, pos,
                                 logits, exact, tol, phase, step_routing))
        t = lap("decode_replays", t)
        if i in LONG_CONTROL_STEPS:
            step_controls.append(long_step_controls(
                api, params, before, tok, pos, exact, step_routing))
            t = lap("decode_controls", t)
        del exact
        if i == steps - 1 and bf16:
            timing = profile_decode_step(api, params,
                                         [(before.put(), tok, pos, logits)])
            t = lap("decode_profile", t)
        served.put()
        del before, served
        tok = nxt
    for ctl in step_controls:
        require(ctl["wrong_pos"]["err_over_max_plain"] > tol,
                f"{phase} control: cur_pos one off passes the gate {ctl}")
        # one key of 32769 moves the bf16 logits less than the replay's
        # own noise: the newest slot's loss must miss the per-call gate
        require(ctl["drop_newest"]["per_call_worst_over_card_tol"] > 1,
                f"{phase} control: the gather without the newest slot "
                f"passes the per-call gate {ctl}")
        if cfg.window:
            require(ctl["window_wider"]["per_call_worst_over_card_tol"] > 1,
                    f"{phase} control: the window one wider passes the "
                    f"per-call gate {ctl}")
    parts["decode"] = time.perf_counter() - t_decode
    parts["decode_served"] = sum(secs)
    peak = torch.cuda.max_memory_allocated()
    slots = caches[0]["sub0"]["pos"]
    ring = {"slots": len(slots), "first_slot_pos": int(slots[0]),
            "wraps_at_prefill": s / len(slots)}
    if cfg.window:
        require(len(slots) == cfg.window
                and sorted(slots.tolist()) == list(range(
                    max_seq - cfg.window, max_seq)),
                f"{phase}: the ring holds {slots.min()}..{slots.max()}, "
                f"not the last {cfg.window} positions")
    del caches, params, api, logits
    _free()
    errs = [t["err"] for t in teacher]
    generated = b * steps
    return {"launches": _merged(prefill_counts, *step_counts),
            "row": {"phase": phase, "config": cfg.name,
                    "layers": cfg.n_layers, "d_model": cfg.d_model,
                    "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
                    "window": cfg.window, "dtype": str(dtype),
                    **depth_fields(cfg), "batch": b, "prefill_tokens": s,
                    "max_seq": max_seq, "steps": steps,
                    "launches": _merged(prefill_counts, *step_counts),
                    f"k4_{route}_per_prefill": n_attn,
                    f"k4_{route}_per_step": n_attn,
                    "gate": tol, "init_s": init_s,
                    "weights_gb": weights / 1e9,
                    "cache_gb": cache_bytes / 1e9,
                    "prefill_ms": prefill_s * 1e3,
                    "prefill_tokens_per_s": b * s / prefill_s,
                    "plain_prefill_ms": plain_prefill_s and
                    plain_prefill_s * 1e3,
                    "prefill_replayed": prefill_err is not None,
                    "prefill_err_over_max_plain": prefill_err,
                    "prefill_per_call_worst_over_card_tol": max(per_call),
                    "prefill_panels": panel_rows(s, LONG_PANEL),
                    "prefill_controls_per_call_worst_over_card_tol": {
                        name: {"max": max(r), "min": min(r),
                               "calls_missed": sum(x > 1 for x in r)}
                        for name, r in controls.items()},
                    "prefill_routing_flips": prefill_flips,
                    "decode_held_to": "the plain replay in f32",
                    "decode_err_over_max_plain_by_step": errs,
                    "decode_max_err_over_max_plain": max(errs),
                    "decode_bf16_plain_err_by_step": [
                        t["bf16_plain_err"] for t in teacher],
                    "bf16_plain_vs_f32_by_step": [
                        t["bf16_plain_vs_f32"] for t in teacher],
                    "decode_per_call_worst_over_card_tol": max(
                        t["per_call"] for t in teacher),
                    "decode_steps_greedy_equal": sum(
                        t["greedy_equal"] for t in teacher),
                    "decode_controls": step_controls,
                    "decode_gathers": gathers, "ring": ring,
                    "step_ms_median": _median(secs) * 1e3,
                    "step_ms": [t * 1e3 for t in secs],
                    "tokens_per_s": generated / sum(secs),
                    "step_bound_ms": (weights + cache_bytes)
                    / HBM_BYTES_PER_S * 1e3, "step_bound_by": "bytes",
                    **timing, "prefill_peak_gb": prefill_peak / 1e9,
                    "peak_gb": peak / 1e9,
                    "seconds": time.perf_counter() - t_phase,
                    "seconds_by_part": parts, "card": card}}


def long_phase(card: str, cfg, phase: str, b: int, gen) -> dict:
    """:func:`long_context` of ``cfg`` in bf16 (:data:`LONG_STEPS`
    steps), then at :data:`LONG_F32_LAYERS` in f32 (phase
    ``<phase>_f32``, :data:`LONG_F32_STEPS` steps)."""
    run = long_context(card, cfg, phase, b, LONG_STEPS, gen)
    emit(run["row"])
    f32_cfg = dataclasses.replace(cfg, n_layers=LONG_F32_LAYERS,
                                  compute_dtype=torch.float32)
    f32 = long_context(card, f32_cfg, f"{phase}_f32", b, LONG_F32_STEPS, gen)
    emit(f32["row"])
    return {"bf16": run["launches"], "f32": f32["launches"]}


def phase_lm_attention_long(card: str) -> dict:
    """K4 alone at the reference's long shapes (:func:`k4_lm_rows`, rows
    ``lm_attention``), each held to the plain version on its panels (a
    decode whole) and timed beside its bound and SDPA: phi3-medium-14b's
    causal prefill of 1 x 32768 (40 heads over 10) and its decode, 2 x 1
    query against 32768 keys; mixtral-8x7b's windowed causal prefill of
    1 x 32768 under 4096 and long_500k's 1 x 524288 (q of 2^31
    elements; bf16 only, SDPA refused).  bf16 on ``sm90``, f32 on
    ``sm90_tf32``.  Returns the rows by type."""
    gen = torch.Generator().manual_seed(SEED + 70)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    _free()
    dense, window = get_config(LM_ARCH), moe_cfg()
    w = window.window
    phi3 = (("long_prefill", 1, LONG_S, LONG_S, True, 0),
            ("long_decode", LONG_DENSE_BATCH, 1, LONG_S, False, 0))
    mixtral = (("long_prefill", 1, LONG_S, LONG_S, True, w),
               ("long_500k", 1, LONG_500K, LONG_500K, True, w))
    rows = {"bf16": [], "f32": []}
    for cfg, shapes in ((dense, phi3), (window, mixtral)):
        rows["bf16"] += k4_lm_rows(cfg, torch.bfloat16, gen, flush, card,
                                   shapes)
        rows["f32"] += k4_lm_rows(cfg, torch.float32, gen, flush, card,
                                  shapes[:1] if cfg is window else shapes)
    for dtype, rs in rows.items():
        want = "sm90" if dtype == "bf16" else "sm90_tf32"
        require(all(r["route"] == want for r in rs),
                f"lm_attention long rows: routes {[r['route'] for r in rs]}")
    del flush
    _free()
    return {"rows": [dict(r, what=f"{r['config']} {r['what']}")
                     for r in rows["bf16"]],
            "f32_rows": [dict(r, what=f"{r['config']} {r['what']}")
                         for r in rows["f32"]]}


def phase_lm_long_dense(card: str) -> dict:
    """phi3-medium-14b at full width and depth, bf16, batch 2 (cut from
    the reference's 32 and 128): :func:`long_context` over two 32768-token
    prompts and 16 decode steps (40 K4 ``sm90`` launches a prefill and a
    step), then 4 layers in f32 (``sm90_tf32``)."""
    gen = torch.Generator().manual_seed(SEED + 71)
    return long_phase(card, get_config(LM_ARCH), "lm_long_dense",
                      LONG_DENSE_BATCH, gen)


def phase_lm_long_window(card: str) -> dict:
    """mixtral-8x7b at full width and 20 of its 32 blocks (as
    ``lm_serve_moe``), bf16, batch 1: :func:`long_context` over a
    32768-token prompt under its 4096 window (the ring filled 8 times
    over) and 16 decode steps, the replays under the served routing;
    then 4 blocks in f32."""
    gen = torch.Generator().manual_seed(SEED + 72)
    return long_phase(card, moe_cfg(), "lm_long_window",
                      LONG_WINDOW_BATCH, gen)


# --------------------------------------------------------------------------
# LM training
# --------------------------------------------------------------------------

LM_TRAIN_ARCH = "minitron-4b"
#: minitron-4b on the card: full width, 24 of its 32 blocks (full depth
#: is 4.31e9 parameters, 69.0 GB of f32 params, grads and both moments at
#: 16 bytes a parameter; 24 blocks are 3.43e9, 54.9 GB)
LM_TRAIN_BLOCKS = 24
#: the reference driver's defaults (``repro/launch/train.py`` ``main``):
#: batch, sequence, steps, peak lr, and its warmup max(1, steps // 10)
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_N, LM_TRAIN_LR = 8, 128, 20, 3e-4
LM_TRAIN_WARMUP = max(1, LM_TRAIN_N // 10)
#: the long step: one sequence of 4096 tokens
LM_TRAIN_LONG_S = 4096
#: minitron's bf16 step-0 gradients against the plain replay's: each
#: tensor's max |err| over its max |plain|.  On an H100 the worst tensor
#: read 0.031 (an ln2; wq, wk, wv 0.021-0.029), the backward with its
#: mask one key off 0.76 and an attention with no gradient 1.10
LM_TRAIN_GRAD_TOL = 0.1
#: ``lm_train_resilient``: ``examples/train_100m.py``'s config, batch,
#: sequence and peak lr; 30 steps, a checkpoint every 10, a failure
#: injected before step 15
RESILIENT_CUT = dict(n_layers=8, d_model=768, n_heads=12, n_kv_heads=4,
                     d_ff=2048, vocab=32768, head_dim=64, attn_chunk=256)
RESILIENT_B, RESILIENT_S, RESILIENT_LR = 8, 256, 1e-3
RESILIENT_N, RESILIENT_EVERY, RESILIENT_FAIL = 30, 10, 15
#: kernel names of the parts of a profiled training step
K4_KERNELS = ("attention_sm90", "attention_kernel", "attention_wide_kernel")
CUBLAS_KERNELS = ("gemm", "nvjet", "xmma", "cutlass", "gemv", "dot_kernel",
                  "splitk", "cublas")
#: the host ranges the port marks a step's parts with, and the part
#: each names (the SSD scan's and the MoE dispatch's cover their forward
#: and remat recompute; their autograd backward falls to cuBLAS and
#: "other" by kernel name)
LM_TRAIN_RANGES = ("attention_vjp", "adamw.update", "ssd_chunked",
                   "moe_dispatch", "moe_combine")
LM_TRAIN_PARTS = ("attention_backward", "adamw", "ssd_scan",
                  "moe_dispatch", "moe_dispatch")


def _cuda_batch(batch: dict) -> dict:
    return {k: v.cuda() for k, v in batch.items()}


def _pairs(b: int, s: int, window: int) -> int:
    """The causal (query, key) pairs of ``b`` sequences of ``s`` tokens,
    each query keeping at most ``window`` keys (every earlier one at
    0)."""
    w = window or s
    if s <= w:
        return b * s * (s + 1) // 2
    return b * (w * (w + 1) // 2 + (s - w) * w)


def _ssd_flops(cfg, b: int, s: int) -> int:
    """One Mamba2 mixer's SSD products at ``b`` x ``s`` (f32, 256-row
    chunks): within each chunk C B^T and the weighted sums of x over its
    causal pairs, across chunks the state's read (C h) and write
    (B^T x)."""
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    q = min(256, s)
    pairs = sum(min(q, s - c) * (min(q, s - c) + 1) // 2
                for c in range(0, s, q))
    return b * (2 * pairs * (n + h * p) + 4 * s * h * p * n)


def train_bounds(cfg, b: int, s: int, n_params: int) -> dict:
    """The least time of one training step of the decoder ``cfg`` at
    ``b`` x ``s`` tokens: the FLOPs of the forward and the backward (3x
    the forward's products, no recompute), each block's sublayers by
    ``block_spec`` at the compute type's peak: attention's projections
    and its causal pairs, limited to the window; a Mamba2 mixer's in and
    out projections; a dense FFN, or ``top_k`` of the experts' products
    a token (not the capacity's padded rows).  At the f32 FMA peak: the
    SSD's products (:func:`_ssd_flops`), the routers and the loss head.
    The bytes of the f32 params and both moments, each read once and
    written once (24 a parameter: the gradients need not leave the
    chip)."""
    t, d, hd = b * s, cfg.d_model, cfg.head_dim
    nh, nkv = cfg.padded_heads(1)
    low = f32 = 0       # one block's forward FLOPs, compute type and f32
    for mixer, ffn in LM_T.block_spec(cfg):
        if mixer == "attn":
            low += (2 * t * (2 * d * nh * hd + 2 * d * nkv * hd)
                    + 4 * _pairs(b, s, cfg.window) * nh * hd)
        else:
            proj = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
            low += 2 * t * (d * proj + cfg.d_inner * d)
            f32 += _ssd_flops(cfg, b, s)
        if ffn == "moe":
            low += 2 * t * cfg.top_k * 3 * d * cfg.d_ff
            f32 += 2 * t * d * cfg.n_experts
        elif ffn == "dense":
            low += 2 * t * 3 * d * cfg.d_ff
    n_blocks = LM_T.n_blocks(cfg)
    head_flops = 3 * 2 * t * cfg.padded_vocab(1) * d
    flop_ms = (3 * n_blocks * low / PEAK[cfg.compute_dtype]
               + (3 * n_blocks * f32 + head_flops) / PEAK_F32_FLOPS) * 1e3
    byte_ms = 24 * n_params / HBM_BYTES_PER_S * 1e3
    return {"flops": 3 * n_blocks * (low + f32) + head_flops,
            "bytes": 24 * n_params, "flop_bound_ms": flop_ms,
            "byte_bound_ms": byte_ms, "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}


def _train_part(kernel: str, event) -> str:
    """Which part of a training step a device span belongs to: K4's
    forward by name; the attention backward, AdamW, the SSD scan and
    the MoE dispatch and combine by the host range the launching op
    (``event``) sits in (:data:`LM_TRAIN_RANGES`); cuBLAS's products by
    name."""
    if any(n in kernel for n in K4_KERNELS):
        return "k4_forward"
    e = event
    parts = dict(zip(LM_TRAIN_RANGES, LM_TRAIN_PARTS))
    while e is not None:
        if e.name in parts:
            return parts[e.name]
        e = e.cpu_parent
    if any(n in kernel.lower() for n in CUBLAS_KERNELS):
        return "cublas"
    return "other"


def _device_spans(prof) -> list[tuple]:
    """The card's kernels, copies and fills in a profile, from the
    profiler's own records: (name, start us, end us, stream, the id of
    the host op that launched it), without the device-side spans of
    host ranges (which cover the kernels inside them)."""
    def read(k, what: str, default):
        # not every torch release has every one of these readers
        return getattr(k, what, lambda: default)()
    out = []
    for k in prof.profiler.kineto_results.events():
        if not str(k.device_type()).endswith("CUDA"):
            continue
        name = k.name()
        if (read(k, "is_user_annotation", False) or name in LM_TRAIN_RANGES
                or "annotation" in str(read(k, "activity_type", ""))):
            continue
        t0 = k.start_ns() / 1e3
        out.append((name, t0, t0 + k.duration_ns() / 1e3,
                    read(k, "device_resource_id", -1),
                    read(k, "linked_correlation_id", 0)))
    return out


def profile_train_step(run_step, state, batch: dict):
    """One step under ``torch.profiler``, and of that same step: its
    wall on the host clock, from the call (after a synchronize) to the
    card's end, and the call's own return (``step_enqueue_ms``); the
    card's busy time, the union of its kernels', copies' and fills'
    spans, and their plain sum (above the union by what ran at once, on
    another stream); the idle share of the wall (the phase fails where
    busy exceeds the wall); each span's time by part (:func:`_train_part`,
    through the host op it is linked to) and by stream.  Beside them the
    sum of the profiler's per-op kernel lists (``ops_kernels_ms``, what
    an earlier version of this phase summed by part), the kernel names
    those lists hold more time of than the spans, and the host op ids
    that more than one host event carries (the profiler lists such a
    span under each of them).  Returns (state, readings)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = run_step(state, batch)
        enqueue = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = _device_spans(prof)
    host = collections.defaultdict(list)
    listed = collections.Counter()
    for e in prof.events():
        if not str(e.device_type).endswith("CUDA"):
            host[e.id].append(e)
            for k in getattr(e, "kernels", ()):
                listed[k.name] += k.duration / 1e3
    busy, end = 0.0, None
    for _, t0, t1, _, _ in sorted(spans, key=lambda x: x[1]):
        if end is None or t0 >= end:
            busy, end = busy + t1 - t0, t1
        elif t1 > end:
            busy, end = busy + t1 - end, t1
    busy /= 1e3
    parts, calls, streams, by_name = (collections.Counter()
                                      for _ in range(4))
    unlinked, shared = 0, {}
    for name, t0, t1, stream, link in spans:
        ops = host.get(link, [])
        unlinked += not ops
        if len(ops) > 1:
            shared[link] = [e.name for e in ops]
        ms = (t1 - t0) / 1e3
        # an id an op shares with a runtime call or an overhead record:
        # the op's own event, whose parents hold the step's ranges
        ops = sorted(ops, key=lambda e: not e.name.startswith("aten::"))
        part = _train_part(name, ops[0] if ops else None)
        parts[part] += ms
        calls[part] += 1
        streams[str(stream)] += ms
        by_name[name] += ms
    span_sum = sum(by_name.values())
    extra = {n: listed[n] - by_name[n] for n in listed
             if listed[n] - by_name[n] > 1e-3}
    require(busy <= wall, f"profiled step: the card busy {busy} ms in a "
                          f"{wall} ms wall")
    return state, {
        "step_enqueue_ms": enqueue, "step_wall_ms": wall,
        "step_device_busy_ms": busy, "step_idle_share": 1 - busy / wall,
        "device_spans": len(spans), "device_span_sum_ms": span_sum,
        "device_overlap_ms": span_sum - busy, "by_stream_ms": dict(streams),
        "spans_without_host_op": unlinked,
        "by_part_ms": dict(parts), "by_part_kernels": dict(calls),
        "ops_kernels_ms": sum(listed.values()),
        "ops_kernels_extra_ms": dict(sorted(
            extra.items(), key=lambda x: -x[1])[:8]),
        "ops_kernels_extra_names": len(extra),
        "host_ids_shared": len(shared),
        "host_ids_shared_names": list(shared.values())[:5]}


def _key_range_all(q0, q1, skv, window, causal):
    return 0, skv


def _mask_one_key_off(q0, q1, lo, hi, *, window, causal, device):
    """The control's backward mask: under ``causal`` key k kept up to
    query q + 1, one key past the forward's."""
    mask = _PANEL_MASK(q0, q1, lo, hi, window=window, causal=False,
                       device=device)
    if causal:
        mask &= (torch.arange(lo, hi, device=device)[None, :]
                 <= torch.arange(q0, q1, device=device)[:, None] + 1)
    return mask


_PANEL_MASK = K4_BWD.panel_mask


def one_key_off_backward():
    """The control: the attention backward (``backward.py``) with its
    causal mask one key off, the forward unchanged."""
    return patched((K4_BWD, "panel_mask", _mask_one_key_off),
                   (K4_BWD, "_key_range", _key_range_all))


def _zero_vjp(q, k, v, dout, **_kw):
    return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)


def no_attention_gradient():
    """The control: the trap of a K4 launch autograd cannot see, an
    attention that passes no gradient to q, k and v."""
    return patched((K4_OPS, "attention_vjp", _zero_vjp))


def _grad_gate(grads, plain) -> float:
    """The worst gradient tensor's max |err| over ``GRAD_TOL`` x its max
    |plain| (the gate is <= 1)."""
    return max((a - b).abs().max().item()
               / (GRAD_TOL * max(b.abs().max().item(), 1e-30))
               for a, b in zip(TREE.leaves(grads), TREE.leaves(plain)))


def _leaf_errs(grads, plain: list) -> dict:
    """Each gradient tensor's max |err| over its max |plain|, by path;
    ``plain`` the replay's leaves (on the host) in flattening order."""
    errs = {}
    for (path, g), p in zip(TREE.leaves_with_paths(grads), plain):
        p = p.to(g.device)
        errs[path] = ((g - p).abs().max()
                      / p.abs().max().clamp_min(1e-30)).item()
    return errs


def _by_kind(errs: dict) -> dict:
    """The worst reading of each kind of tensor (a path's last part:
    wq, wk, ..., embed)."""
    out = {}
    for path, e in errs.items():
        kind = path.rsplit("/", 1)[-1]
        out[kind] = max(out.get(kind, 0.0), e)
    return out


def _detached(tap):
    """``tap`` on detached tensors under ``no_grad``: in training it sees
    each K4 call of the forward and of the remat recompute and adds
    nothing to the graph."""
    def run(layer, q, k, v, out, **kw):
        with torch.no_grad():
            tap(layer, q.detach(), k.detach(), v.detach(), out.detach(),
                **kw)
    return run


class TrainRouting:
    """The expert choices of one K4-path forward of ``batch`` (no
    gradient, no recompute), by MoE layer: a layer's router is the same
    f32 tensor in the forward and in the remat recompute, so its
    ``data_ptr`` names the layer in both.  :meth:`check` counts a
    ``value_and_grad``'s router calls, ``2 x moe_layers`` (the forward
    and the recompute), and those whose choice is not the recorded
    forward's; :meth:`replay` hands every call, the recompute's too,
    its layer's recorded choice with gates from the replay's own
    probabilities there (the ``Routing`` of serving, by layer), the
    replay's own flips counted."""

    def __init__(self, api, params, batch: dict):
        self.by_layer: dict[int, torch.Tensor] = {}

        def rec(x, router, top_k):
            gates, idx = _ROUTER_TOP_K(x, router, top_k)
            self.by_layer[router.data_ptr()] = idx
            return gates, idx
        with torch.no_grad(), patched((MOE, "router_top_k", rec)), \
                counted({}), no_plain_attention():
            api.train_loss(params, batch)
        require(len(self.by_layer) == moe_layers(api.cfg),
                f"routing: {len(self.by_layer)} layers recorded, want "
                f"{moe_layers(api.cfg)}")
        self.calls = self.off = self.flips = self.rows = 0

    @contextlib.contextmanager
    def check(self):
        self.calls = self.off = 0

        def own(x, router, top_k):
            gates, idx = _ROUTER_TOP_K(x, router, top_k)
            self.calls += 1
            want = self.by_layer[router.data_ptr()]
            self.off += not torch.equal(idx, want)
            return gates, idx
        with patched((MOE, "router_top_k", own)):
            yield

    def replay(self):
        def replay(x, router, top_k):
            want = self.by_layer[router.data_ptr()]
            probs = torch.softmax(x.to(torch.float32) @ router, dim=-1)
            _, idx = _ROUTER_TOP_K(x, router, top_k)
            self.flips += int((idx.sort(-1).values
                               != want.sort(-1).values).any(-1).sum())
            self.rows += idx.shape[0]
            gates = probs.gather(-1, want)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
            return gates, want
        return patched((MOE, "router_top_k", replay))


def train_routing(api, params, batch: dict) -> TrainRouting | None:
    return TrainRouting(api, params, batch) if api.cfg.n_experts else None


def _checked(routing):
    return routing.check() if routing else contextlib.nullcontext()


def _replayed(routing):
    return routing.replay() if routing else contextlib.nullcontext()


def _vjp_ref(q, k, v, dout, *, window: int,
             causal: bool) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv) in f32 by autograd through a plain masked softmax
    attention, one kv head's group of query heads at a time (keys at
    positions from 0, as training calls it): independent of
    ``backward.py``."""
    sq, skv, kv = q.shape[1], k.shape[1], k.shape[2]
    g = q.shape[2] // kv
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    for j in range(kv):
        heads = slice(j * g, (j + 1) * g)
        with torch.enable_grad():
            qj = q[:, :, heads].float().requires_grad_(True)
            kj = k[:, :, j].float().requires_grad_(True)
            vj = v[:, :, j].float().requires_grad_(True)
            sc = torch.einsum("bqgd,bkd->bgqk", qj, kj) / math.sqrt(
                q.shape[3])
            p = torch.softmax(sc.masked_fill(~keep, float("-inf")), dim=-1)
            out = torch.einsum("bgqk,bkd->bqgd", p, vj)
            dq[:, :, heads], dk[:, :, j], dv[:, :, j] = torch.autograd.grad(
                out, (qj, kj, vj), dout[:, :, heads].float())
        del sc, p, out
    return dq, dk, dv


@contextlib.contextmanager
def vjp_tapped(into: list | None):
    """``attention_vjp`` (whatever is installed when the block starts: a
    control's too) with each call held to :func:`_vjp_ref`: the call
    again on f32 copies of its inputs (it works in f32, so the model's
    call must be that one rounded to the input type, bit for bit), its
    dq, dk and dv within ``TOL`` of max |ref|; each call's worst err
    over that gate appended to ``into``.  The gradient gate compares a
    whole step's tensors at :data:`LM_TRAIN_GRAD_TOL`; at thousands of
    keys a backward with its mask one key off moves them by a few
    percent only, and this gate sees it (and a window one key wider,
    which touches only the rows past the window).  ``None``: nothing
    tapped."""
    if into is None:
        yield
        return
    inner = K4_OPS.attention_vjp

    def run(q, k, v, dout, *, window=0, causal=True):
        got = inner(q, k, v, dout, window=window, causal=causal)
        with torch.no_grad():
            f32 = inner(q.float(), k.float(), v.float(), dout.float(),
                        window=window, causal=causal)
            require(all(torch.equal(a, b.to(a.dtype))
                        for a, b in zip(got, f32)),
                    "vjp tap: attention_vjp in f32 gave other bits")
            ref = _vjp_ref(q, k, v, dout, window=window, causal=causal)
            into.append(max(((a - r).abs().max()
                             / (TOL * r.abs().max().clamp_min(1e-30))).item()
                            for a, r in zip(f32, ref)))
            del f32, ref
        return got
    with patched((K4_OPS, "attention_vjp", run)):
        yield


def window_one_key_wider():
    """The control: the attention backward (``attention_vjp``) under a
    window one key wider than the forward's."""
    inner = K4_OPS.attention_vjp

    def wider(q, k, v, dout, *, window=0, causal=True):
        return inner(q, k, v, dout, window=window + 1 if window else 0,
                     causal=causal)
    return patched((K4_OPS, "attention_vjp", wider))


def wrong_kv_head():
    """The control: ``check_attention``'s kv-head control carried to the
    backward, each kv head's dk and dv summed into the next kv head
    (j into j + 1 mod KV)."""
    inner = K4_OPS.attention_vjp

    def rolled(q, k, v, dout, **kw):
        dq, dk, dv = inner(q, k, v, dout, **kw)
        return dq, torch.roll(dk, 1, 2), torch.roll(dv, 1, 2)
    return patched((K4_OPS, "attention_vjp", rolled))


def group_sum_dropped():
    """The control: each kv head's dk and dv from the first query head of
    its group alone, not summed over the group (at one kv head the
    wrong-kv-head control is the identity; this is its MQA form)."""
    inner = K4_OPS.attention_vjp

    def one_head(q, k, v, dout, **kw):
        dq, _, _ = inner(q, k, v, dout, **kw)
        g = q.shape[2] // k.shape[2]
        _, dk, dv = inner(q[:, :, ::g], k, v, dout[:, :, ::g], **kw)
        return dq, dk, dv
    return patched((K4_OPS, "attention_vjp", one_head))


def _no_prefix(h, prefix, sp):
    return h


def no_prefix():
    """The control: the step without its prefix embeddings (the token
    embeddings kept at the prefix's positions)."""
    return patched((LM_T, "_with_prefix", _no_prefix))


#: the gradient controls by name
GRAD_CONTROLS = {"one_key_off": one_key_off_backward,
                 "no_attention_gradient": no_attention_gradient,
                 "window_one_key_wider": window_one_key_wider,
                 "wrong_kv_head": wrong_kv_head,
                 "group_sum_dropped": group_sum_dropped,
                 "no_prefix": no_prefix}
#: step 0's controls of every config
STEP0_CONTROLS = ("one_key_off", "no_attention_gradient")


def tapped_value_and_grad(api, params, batch, per_step: int, what: str,
                          route: str = "sm90", routing=None,
                          vjp: list | None = None):
    """``value_and_grad`` on the K4 path with every K4 call (forward and
    recompute, ``per_step`` of them, on ``route``) held to the plain
    version on its own inputs at ``CARD_TOL`` (required); with
    ``routing`` (:class:`TrainRouting`) every router call, the
    recompute's too, the recorded forward's choice (required); with
    ``vjp`` (a list) each backward call held by :func:`vjp_tapped`
    (required).  Returns (loss, grads, readings)."""
    per_call, c = [], {}
    tap = _detached(k4_against_plain(api.cfg.compute_dtype, per_call))
    with counted(c), no_plain_attention(), _checked(routing), \
            vjp_tapped(vjp):
        loss, grads = LM_STEPS.value_and_grad(api, params, batch, tap=tap)
    require(k4_only(c, route, per_step) and len(per_call) == per_step
            and max(per_call) <= 1.0,
            f"{what}: launches {c}, K4 calls against the plain version "
            f"worst {max(per_call, default=None)} of CARD_TOL over "
            f"{len(per_call)} calls (want {per_step})")
    row = {"k4_calls": len(per_call), "k4_worst_over_card_tol":
           max(per_call), "launches": c}
    if routing:
        require(routing.calls == 2 * moe_layers(api.cfg)
                and routing.off == 0,
                f"{what}: {routing.calls} router calls, {routing.off} off "
                f"the forward's choice (want "
                f"{2 * moe_layers(api.cfg)}, 0)")
        row.update(router_calls=routing.calls,
                   router_calls_off_forward=routing.off)
    if vjp is not None:
        require(len(vjp) == attention_layers(api.cfg) and max(vjp) <= 1,
                f"{what}: attention_vjp against autograd {vjp} of TOL")
        row["vjp_worst_over_tol"] = max(vjp)
    return loss, grads, row


def lm_train_step0(api, params, batch: dict, per_step: int, *,
                   route: str = "sm90", tol: float = LM_TRAIN_GRAD_TOL,
                   loss_tol: float | None = None,
                   controls=STEP0_CONTROLS, backward_gated=(),
                   what: str = "lm_train step 0",
                   phase: str = "lm_train_step0") -> dict:
    """Step 0's loss and gradients on the same weights and batch: the
    plain replay (``attn="plain"``; with experts under the K4 path's
    routing, :class:`TrainRouting`), kept on the host; the K4 path with
    each K4 call on ``route`` tapped (:func:`tapped_value_and_grad`),
    each gradient tensor within ``tol`` of its max |plain| (required;
    with ``loss_tol`` the loss within it relative, required), every
    attention backward call also held to autograd (:func:`vjp_tapped`,
    required); and the ``controls`` of the gradient gate
    (:data:`GRAD_CONTROLS`), each of which must miss it, but those in
    ``backward_gated``: a change too small for a step's gradients at
    this shape, which must miss the backward's gate in every call
    instead (both readings printed)."""
    routing = train_routing(api, params, batch)
    with _replayed(routing):
        plain_loss, grads = LM_STEPS.value_and_grad(api, params, batch,
                                                    attn="plain")
    plain_gnorm = float(ADAMW.global_norm(grads))
    plain = [g.cpu() for g in TREE.leaves(grads)]
    del grads
    _free()
    loss, grads, row = tapped_value_and_grad(api, params, batch, per_step,
                                             what, route, routing,
                                             vjp=[])
    errs = _leaf_errs(grads, plain)
    gnorm = float(ADAMW.global_norm(grads))
    row.update(loss=float(loss), gnorm=gnorm,
               plain_loss=float(plain_loss), plain_gnorm=plain_gnorm,
               loss_rel_err=abs(float(loss) - float(plain_loss))
               / abs(float(plain_loss)),
               gnorm_rel_err=abs(gnorm - plain_gnorm) / plain_gnorm,
               grad_leaves=len(errs), grad_worst=max(errs.values()),
               grad_worst_leaf=max(errs, key=errs.get),
               grad_by_kind=_by_kind(errs), grad_tol=tol)
    if routing:
        row.update(routing="the K4 path's forward",
                   replay_flips=routing.flips, replay_rows=routing.rows)
    del grads
    _free()
    for name in controls:
        bad_vjp = [] if name in backward_gated else None
        with counted({}), GRAD_CONTROLS[name](), _checked(routing), \
                vjp_tapped(bad_vjp):
            _, wrong = LM_STEPS.value_and_grad(api, params, batch)
        if routing:
            require(routing.off == 0,
                    f"{what}: the {name} control routed {routing.off} "
                    f"calls off the forward's choice")
        bad = _leaf_errs(wrong, plain)
        del wrong
        _free()
        row[f"control_{name}"] = {"grad_worst": max(bad.values()),
                                  "grad_by_kind": _by_kind(bad)}
        if bad_vjp is not None:
            row[f"control_{name}"].update(
                vjp_calls=len(bad_vjp), vjp_least_over_tol=min(bad_vjp))
    del plain
    emit({"phase": phase, **row})
    require(row["grad_worst"] <= tol,
            f"{what}: gradient {row['grad_worst_leaf']} at "
            f"{row['grad_worst']} of max |plain| > {tol}")
    if loss_tol is not None:
        require(row["loss_rel_err"] <= loss_tol,
                f"{what}: loss {row['loss_rel_err']} relative > "
                f"{loss_tol}")
    for name in controls:
        ctl = row[f"control_{name}"]
        if name in backward_gated:
            require(ctl["vjp_calls"] == attention_layers(api.cfg)
                    and ctl["vjp_least_over_tol"] > 1,
                    f"{what}: the {name} control passed the backward's "
                    f"gate ({ctl})")
        else:
            require(ctl["grad_worst"] > tol,
                    f"{what}: the {name} control passed the gradient gate "
                    f"({ctl})")
    return row


def _trainer(cfg, b: int = LM_TRAIN_B, s: int = LM_TRAIN_S,
             n: int = LM_TRAIN_N):
    """``make_trainer``'s step and state for ``cfg`` on the card at the
    reference trainer's defaults (``repro/launch/train.py``: peak lr,
    warmup, a schedule of :data:`LM_TRAIN_N` steps), and ``n`` batches
    of ``b`` x ``s`` tokens of the synthetic stream; the peak memory
    counted from here."""
    _free()
    torch.cuda.reset_peak_memory_stats()
    run_step, state, api, _rules = make_trainer(
        cfg, global_batch=b, seq_len=s, peak_lr=LM_TRAIN_LR,
        total_steps=LM_TRAIN_N, warmup=LM_TRAIN_WARMUP, device="cuda")
    dc = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=SEED)
    return run_step, state, api, [global_batch_at(dc, i) for i in range(n)]


def _long_batch(cfg, s: int) -> dict:
    dc = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=1, seed=SEED)
    return _cuda_batch(global_batch_at(dc, LM_TRAIN_N))


def _probe_leaf(params) -> torch.Tensor:
    """The first matrix of the first block, in flattening order."""
    return next(t for t in TREE.leaves(params["blocks"][0]) if t.dim() >= 2)


def train_loop(run_step, state, batches, per_step: int, route: str,
               what: str, cfg, moved: bool = True):
    """Each batch through ``run_step`` in a plain loop, each step timed
    on the host clock to the card's end: its K4 launches ``per_step`` on
    ``route`` and nothing else of K1-K4 (required; 0: none), no plain
    attention, loss and grad norm finite (required); with experts
    ``2 x moe_layers`` router calls (the forward and the remat
    recompute, required) and the pairs the capacity dropped in the
    forward (:meth:`Routing.dropped` over its first calls); with
    ``moved`` the params unchanged by the first step (lr 0: a block's
    first matrix and the embedding's first rows) and that matrix
    changed by the second (required).  Returns (state, readings)."""
    out = {"counts": [], "losses": [], "grad_norms": [], "secs": [],
           "dropped_pairs": []}
    probe = _probe_leaf(state.params)
    before = (probe.clone(), state.params["embed"][:256].clone())
    for i, batch in enumerate(batches):
        c, routing = {}, Routing(moe_layers(cfg))
        with counted(c), no_plain_attention(), routing.record():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = run_step(state, batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            out["secs"].append(time.perf_counter() - t0)
        require(k4_only(c, route, per_step),
                f"{what} step {i} launches {c}, want {per_step} on {route}")
        require(np.isfinite(loss) and np.isfinite(gnorm),
                f"{what} step {i}: loss {loss}, grad norm {gnorm}")
        require(len(routing.calls) == 2 * moe_layers(cfg),
                f"{what} step {i}: {len(routing.calls)} router calls, want "
                f"{2 * moe_layers(cfg)}")
        if cfg.n_experts:
            out["dropped_pairs"].append(routing.dropped(
                0, cfg.n_experts, MOE.bin_capacity(
                    batch["tokens"].numel(), cfg.top_k, cfg.n_experts,
                    cfg.capacity_factor)))
        out["counts"].append(c)
        out["losses"].append(loss)
        out["grad_norms"].append(gnorm)
        if moved and i == 0:
            require(torch.equal(probe, before[0]) and torch.equal(
                state.params["embed"][:256], before[1]),
                f"{what}: step 0 (lr 0) moved a parameter")
        if moved and i == 1:
            require(not torch.equal(probe, before[0]),
                    f"{what}: step 1 left the first block's first matrix "
                    f"unchanged")
    out["launches"] = _merged(*out.pop("counts"))
    return state, out


def _loop_fields(loop: dict, tokens: int) -> dict:
    secs = loop["secs"]
    return {"losses": loop["losses"], "grad_norms": loop["grad_norms"],
            "step_ms": [x * 1e3 for x in secs],
            "step_ms_median": _median(secs) * 1e3,
            "step_ms_min": min(secs) * 1e3, "step_ms_max": max(secs) * 1e3,
            "tokens_per_s": tokens / _median(secs),
            "launches": loop["launches"],
            **({"dropped_pairs": loop["dropped_pairs"]}
               if loop["dropped_pairs"] else {})}


def _size_fields(cfg, n_params: int, b: int = LM_TRAIN_B,
                 s: int = LM_TRAIN_S, n: int = LM_TRAIN_N) -> dict:
    return {"config": cfg.name, "layers": cfg.n_layers,
            "blocks": LM_T.n_blocks(cfg),
            "full_depth_blocks": LM_T.n_blocks(get_config(cfg.name)),
            "d_model": cfg.d_model, "vocab": cfg.vocab,
            "dtype": str(cfg.compute_dtype), "params": n_params,
            "state_gb": 16 * n_params / 1e9, "batch": b, "seq": s,
            "steps": n, "peak_lr": LM_TRAIN_LR, "warmup": LM_TRAIN_WARMUP}


def _bounds(cfg, b: int, s: int, n_params: int) -> dict:
    return {f"bound_{k}": v
            for k, v in train_bounds(cfg, b, s, n_params).items()}


def bit_repeat(api, params, batch: dict, what: str) -> dict:
    """``value_and_grad`` on the K4 path twice on the same weights and
    batch: the loss and every gradient leaf equal bit for bit
    (required).  The first run's gradients wait on the host while the
    second runs: one set on the card at a time (dbrx's block leaves
    room for no more)."""
    with counted({}), no_plain_attention():
        l1, g1 = LM_STEPS.value_and_grad(api, params, batch)
        g1 = TREE.tree_map(lambda t: t.cpu(), g1)
        _free()
        l2, g2 = LM_STEPS.value_and_grad(api, params, batch)
    differ = [p for (p, a), b in zip(TREE.leaves_with_paths(g1),
                                     TREE.leaves(g2))
              if not torch.equal(a.to(b.device), b)]
    out = {"loss_equal": bool(torch.equal(l1, l2)),
           "grad_leaves": len(TREE.leaves(g1)),
           "grad_leaves_differing": len(differ), "differing": differ[:8]}
    del g1, g2
    _free()
    require(out["loss_equal"] and not differ,
            f"{what}: value_and_grad did not repeat bit for bit {out}")
    return out


def phase_lm_train(card: str) -> dict:
    """minitron-4b at full width (d_model 3072, 24 heads over 8 at head
    dim 128, d_ff 9216, vocab 256000) and 24 of its 32 blocks, trained
    through :func:`train_config` at the reference driver's defaults
    (batch 8 x 128 tokens of the synthetic stream, 20 steps, peak lr
    3e-4, warmup 2): step 0 against the plain replay with the
    one-key-off and no-gradient controls, 48 K4 ``sm90`` launches a step
    (24 forward, 24 in the remat recompute), then one step at 1 x 4096
    tokens twice and its K4 calls tapped (:func:`long_step_gate`);
    after step 20 every param leaf's fingerprint
    (:func:`param_fingerprint`), which ``lm_train_mesh`` is held to with
    each step's loss and grad norm."""
    cfg = dataclasses.replace(get_config(LM_TRAIN_ARCH),
                              n_layers=LM_TRAIN_BLOCKS)
    run = train_config(card, cfg, "lm_train", long_s=LM_TRAIN_LONG_S)
    return {"bf16": run["bf16"], "fingerprint": run["fingerprint"],
            **{k: run["row"][k] for k in ("step_ms_median", "losses",
                                          "grad_norms", "peak_gb")}}


def phase_lm_train_f32(card: str) -> dict:
    """Step 0 of training in f32 at full width, the depth cut: K4 on
    ``sm90_tf32`` forward, the reference's VJP backward, against a plain
    replay (``attn="plain"``: PyTorch's autograd through the chunked
    attention; with experts under the K4 forward's routing,
    :class:`TrainRouting`) on the same weights and batch: the loss
    within ``TOL`` relative, every gradient tensor within ``GRAD_TOL``
    of its max |plain|.

      * minitron-4b, 2 blocks, batch 8 x 128: 4 K4 launches (2 forward,
        2 recompute); the control, a backward whose causal mask keeps
        key q + 1, must miss the gradient gate;
      * whisper-medium, 2 encoder and 2 decoder layers, 2 x 1500 frames
        and 64 tokens: 12 K4 launches (the encoder's non-causal 1500 x
        1500 with a ragged last tile, the decoder's causal self- and
        non-causal cross-attention, each twice);
      * mixtral-8x7b, 2 blocks, 1 x 8192 tokens under its 4096 window:
        4 K4 launches, every router call on the forward's choice, each
        ``attention_vjp`` call within ``TOL`` of autograd
        (:func:`vjp_tapped`); the one-key-off control and a backward
        window one key wider (:func:`window_one_key_wider`) must each
        miss the gradient gate, the second also the backward's;
      * llava-next-34b, 2 layers, one batch of its prefix path (2 x
        (2880 prefix embeddings + 64 tokens), the labels -1 over the
        prefix; 56 heads over 8) and granite-34b, 2 layers, 8 x 128 (48
        heads on one): 4 K4 launches each, the one-key-off control
        missing."""
    f32 = torch.float32
    out, counts = {}, []
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    for arch, cut in (("minitron-4b", dict(n_layers=2)),
                      ("whisper-medium", dict(n_layers=2, enc_layers=2)),
                      (MOE_ARCH, dict(n_layers=2)),
                      (VLM_ARCH, dict(n_layers=2)),
                      (MQA_ARCH, dict(n_layers=2))):
        _free()
        t_row = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), compute_dtype=f32, **cut)
        api = build_lm(cfg)
        params = api.init(torch.Generator(device="cuda").manual_seed(SEED))
        if cfg.family == "encdec":
            b, s = 2, 64
            batch = {"frames": torch.randn(
                (b, LM_E.ENC_FRAMES, cfg.d_model), generator=gen,
                device="cuda") * ENCDEC_FRAMES_SCALE}
            calls = cfg.enc_layers + 2 * cfg.n_layers
        elif cfg.frontend == "vision_stub":
            b, s = VLM_BATCH, cfg.frontend_len + VLM_TEXT
            batch = {"prefix_embeds": torch.randn(
                (b, cfg.frontend_len, cfg.d_model), generator=gen,
                device="cuda") * VLM_PREFIX_SCALE}
            calls = attention_layers(cfg)
        else:
            b, s = (1, MOE_TRAIN_LONG_S) if cfg.window else (LM_TRAIN_B,
                                                              LM_TRAIN_S)
            batch = {}
            calls = attention_layers(cfg)
        toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen,
                             device="cuda")
        batch.update(tokens=toks[:, :-1], labels=toks[:, 1:].clone())
        if "prefix_embeds" in batch:
            batch["labels"][:, :cfg.frontend_len] = -1
        routing = train_routing(api, params, batch)
        with _replayed(routing):
            plain_loss, plain = LM_STEPS.value_and_grad(api, params, batch,
                                                        attn="plain")
        vjp = [] if cfg.window else None
        c = {}
        with counted(c), no_plain_attention(), _checked(routing), \
                vjp_tapped(vjp):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = LM_STEPS.value_and_grad(api, params, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        require(k4_only(c, "sm90_tf32", 2 * calls),
                f"lm_train_f32 {arch} launches {c}")
        counts.append(c)
        loss_err = abs(float(loss) - float(plain_loss)) / abs(
            float(plain_loss))
        gate = _grad_gate(grads, plain)
        require(loss_err <= TOL and gate <= 1.0,
                f"lm_train_f32 {arch}: loss {loss_err} of TOL {TOL}, "
                f"worst gradient {gate} of GRAD_TOL")
        row = {"config": arch, "blocks": cut, "batch": b, "seq": s,
               "k4_sm90_tf32": 2 * calls, "loss": float(loss),
               "plain_loss": float(plain_loss), "loss_rel_err": loss_err,
               "grad_worst_over_gate": gate, "grad_leaves":
               len(TREE.leaves(grads)), "value_and_grad_ms": ms}
        if routing:
            require(routing.calls == 2 * moe_layers(cfg)
                    and not routing.off,
                    f"lm_train_f32 {arch}: {routing.calls} router calls, "
                    f"{routing.off} off the forward's choice")
            row.update(window=cfg.window, router_calls=routing.calls,
                       replay_flips=routing.flips,
                       replay_rows=routing.rows)
        if vjp is not None:
            require(len(vjp) == calls and max(vjp) <= 1.0,
                    f"lm_train_f32 {arch}: attention_vjp against autograd "
                    f"{vjp} of TOL")
            row.update(vjp_worst_over_tol=max(vjp),
                       value_and_grad_ms_with_vjp_tap=True)
        del grads
        if cfg.family != "encdec":
            controls = ["one_key_off"] + (["window_one_key_wider"]
                                          if cfg.window else [])
            for name in controls:
                wrong_vjp = [] if name == "window_one_key_wider" else None
                with counted({}), GRAD_CONTROLS[name](), \
                        _checked(routing), vjp_tapped(wrong_vjp):
                    _, wrong = LM_STEPS.value_and_grad(api, params, batch)
                key = ("control_mask_one_key_off_over_gate"
                       if name == "one_key_off"
                       else f"control_{name}_over_gate")
                row[key] = _grad_gate(wrong, plain)
                require(row[key] > 1.0,
                        f"lm_train_f32 {arch}: the {name} control passed "
                        f"the gradient gate ({row})")
                if wrong_vjp is not None:
                    row["control_window_one_key_wider_vjp_over_tol"] = \
                        min(wrong_vjp)
                    require(min(wrong_vjp) > 1.0,
                            f"lm_train_f32 {arch}: the window_one_key_wider "
                            f"control passed the backward's gate "
                            f"{wrong_vjp}")
                del wrong
        row["seconds"] = time.perf_counter() - t_row
        out[arch] = row
        del plain, params, api
    emit({"phase": "lm_train_f32", "dtype": str(f32), "gate_loss": TOL,
          "gate_grad": GRAD_TOL, "rows": out, "card": card})
    _free()
    return {"f32": _merged(*counts)}


# --------------------------------------------------------------------------
# lm_train_moe, lm_train_ssm, lm_train_hybrid: mixtral-8x7b (MoE FFN,
# window 4096), mamba2-1.3b (Mamba2 mixer) and jamba (both) trained
# through make_trainer
# --------------------------------------------------------------------------

#: mixtral-8x7b trained at full width, 2 of its 32 blocks: 3.03e9
#: parameters, 48.5 GB of f32 params, grads and both moments at 16
#: bytes a parameter (3 blocks would be 71 GB)
MOE_TRAIN_BLOCKS = 2
#: the windowed step: one sequence of twice mixtral's 4096-token window
MOE_TRAIN_LONG_S = 8192
#: mamba2-1.3b's long step: one sequence of 4096 tokens, 16 SSD chunks
SSM_TRAIN_LONG_S = 4096
#: the f32 gate of the scan under autograd: 2 of mamba2's 48 layers at
#: full width, one sequence of 1024 tokens (4 chunks), on the card and
#: on the host's CPU
SSM_GATE_LAYERS, SSM_GATE_S = 2, 1024
#: jamba's long step: one sequence of 1024 tokens across 4 SSD chunks
HYBRID_TRAIN_LONG_S = 1024


def long_step_gate(api, params, batch: dict, per_step: int,
                   what: str) -> dict:
    """One long sequence on the K4 path: every K4 call of the forward and
    the recompute held to the plain version and every router call on
    the forward's choice (:func:`tapped_value_and_grad`); where the
    window bites, every ``attention_vjp`` call within ``TOL`` of
    autograd (:func:`vjp_tapped`), then :func:`window_one_key_wider`
    under the same taps, which every call must miss, and the distance
    of its gradients from the K4 path's (the worst leaf's max |err|
    over max |K4 path|)."""
    windowed = 0 < api.cfg.window < batch["tokens"].shape[1]
    routing = train_routing(api, params, batch)
    loss, grads, row = tapped_value_and_grad(
        api, params, batch, per_step, what, "sm90", routing,
        [] if windowed else None)
    row["loss"] = float(loss)
    if windowed:
        wrong_vjp = []
        with counted({}), window_one_key_wider(), vjp_tapped(wrong_vjp), \
                _checked(routing):
            _, wrong = LM_STEPS.value_and_grad(api, params, batch)
        moved = max(((w - g).abs().max()
                     / g.abs().max().clamp_min(1e-30)).item()
                    for w, g in zip(TREE.leaves(wrong), TREE.leaves(grads)))
        del wrong
        row["control_window_one_key_wider"] = {
            "vjp_worst_over_tol": max(wrong_vjp),
            "vjp_least_over_tol": min(wrong_vjp),
            "grad_worst_against_k4_path": moved}
        require(len(wrong_vjp) == attention_layers(api.cfg)
                and min(wrong_vjp) > 1.0,
                f"{what}: the window_one_key_wider control passed the "
                f"backward's gate ({wrong_vjp})")
    del grads
    _free()
    return row


def phase_lm_train_moe(card: str) -> dict:
    """mixtral-8x7b at full width (d_model 4096, 32 heads over 8, 8
    experts of d_ff 14336, top-2, capacity factor 1.25, window 4096) and
    :data:`MOE_TRAIN_BLOCKS` of its 32 blocks, trained through
    :func:`train_config` at the reference trainer's defaults (batch 8 x
    128, 20 steps, peak lr 3e-4, warmup 2): step 0 under the K4
    forward's routing (:class:`TrainRouting`) with the one-key-off and
    no-gradient controls, ``value_and_grad`` twice bit for bit
    (:func:`bit_repeat`: the MoE backward's index ops), the pairs each
    step dropped; then 1 x 8192 tokens, where the window bites, twice,
    and :func:`long_step_gate` on it: every ``attention_vjp`` call
    within ``TOL`` of autograd, a backward window one key wider
    missing."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_TRAIN_BLOCKS)
    return train_config(card, cfg, "lm_train_moe", repeat=True,
                        long_s=MOE_TRAIN_LONG_S)


_CHUNK_STEP = SSM._chunk_step


def _no_carry(state, *args):
    return _CHUNK_STEP(torch.zeros_like(state), *args)


def dropped_carry():
    """The control: the SSD scan with the state carried between chunks
    dropped (each chunk starts from zeros)."""
    return patched((SSM, "_chunk_step", _no_carry))


def ssm_card_against_cpu(cfg) -> dict:
    """The scan under autograd in f32: :data:`SSM_GATE_LAYERS` layers of
    ``cfg`` at full width, one sequence of :data:`SSM_GATE_S` tokens
    (4 chunks): step 0's loss and gradients on the card against the
    same step on the host's CPU, on the same weights and batch (the
    CPU path is held to the reference by ``tests/test_torch_lm_train.
    py``): the loss within ``TOL`` relative, every gradient tensor
    within ``GRAD_TOL`` of its max |CPU| (required), no launch of
    K1-K4; the control, :func:`dropped_carry`, must miss the gradient
    gate."""
    gcfg = dataclasses.replace(cfg, n_layers=SSM_GATE_LAYERS,
                               compute_dtype=torch.float32)
    api = build_lm(gcfg)
    params = api.init(torch.Generator(device="cuda").manual_seed(SEED))
    toks = torch.randint(0, cfg.vocab, (1, SSM_GATE_S + 1),
                         generator=torch.Generator().manual_seed(SEED + 71))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    c = {}
    with counted(c):
        loss, grads = LM_STEPS.value_and_grad(api, params,
                                              _cuda_batch(batch))
    require(not any(n for v in c.values() for n in v.values()),
            f"lm_train_ssm f32: launches {c}")
    host = TREE.tree_map(lambda t: t.cpu(), params)
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = LM_STEPS.value_and_grad(api, host, batch)
    cpu_s = time.perf_counter() - t0
    ref = TREE.leaves(cpu_grads)
    errs = _leaf_errs(grads, ref)
    loss_err = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    del grads
    with counted({}), dropped_carry():
        wrong_loss, wrong = LM_STEPS.value_and_grad(api, params,
                                                    _cuda_batch(batch))
    bad = _leaf_errs(wrong, ref)
    del wrong, params, host, cpu_grads, ref
    _free()
    row = {"layers": SSM_GATE_LAYERS, "seq": SSM_GATE_S,
           "chunks": -(-SSM_GATE_S // 256), "dtype": "torch.float32",
           "loss": float(loss), "cpu_loss": float(cpu_loss),
           "loss_rel_err": loss_err, "gate_loss": TOL,
           "grad_worst": max(errs.values()),
           "grad_worst_leaf": max(errs, key=errs.get), "gate_grad": GRAD_TOL,
           "cpu_s": cpu_s, "control_dropped_carry": {
               "loss_rel_err": abs(float(wrong_loss) - float(cpu_loss))
               / abs(float(cpu_loss)),
               "grad_worst": max(bad.values()),
               "grad_by_kind": _by_kind(bad)}, "launches": c}
    require(loss_err <= TOL and row["grad_worst"] <= GRAD_TOL,
            f"lm_train_ssm f32 against the CPU: {row}")
    require(row["control_dropped_carry"]["grad_worst"] > GRAD_TOL,
            f"lm_train_ssm: the dropped-carry control passed {row}")
    return row


def phase_lm_train_ssm(card: str) -> dict:
    """mamba2-1.3b (48 Mamba2 layers, d_model 2048, state 128, 64 heads)
    at full size, bf16 compute on f32 masters, trained through
    ``make_trainer``'s step as :func:`phase_lm_train_moe` is: every step
    finite, no launch of K1-K4, no param moved by step 0 and moved by
    step 1; then one step at 1 x 4096 tokens (16 SSD chunks), its peak
    memory; step 0's bf16 loss beside an f32 replay's (printed, no gate:
    no yardstick rounds as the bf16 SSM path does); one profiled step at
    8 x 128 (a 1 x 4096 step holds some 10^5 host ops, whose profile
    takes longer to read than the step) and each shape's bound; then
    :func:`ssm_card_against_cpu`."""
    t0 = time.perf_counter()
    cfg = get_config(SSM_ARCH)
    run_step, state, api, batches = _trainer(cfg)
    n_params = sum(t.numel() for t in TREE.leaves(state.params))
    with torch.no_grad(), counted({}):
        f32_loss = float(build_lm(dataclasses.replace(
            cfg, compute_dtype=torch.float32)).train_loss(
            state.params, _cuda_batch(batches[0])))
    state, loop = train_loop(run_step, state, batches, 0, "sm90",
                             "lm_train_ssm", cfg)
    state, short_profile = profile_train_step(run_step, state,
                                              _cuda_batch(batches[-1]))
    loop_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, long = train_loop(run_step, state,
                             [_long_batch(cfg, SSM_TRAIN_LONG_S)], 0, "sm90",
                             "lm_train_ssm 1 x 4096", cfg, moved=False)
    long_peak = torch.cuda.max_memory_allocated()
    peak = max(loop_peak, long_peak)
    del state, run_step, api
    _free()
    gate = ssm_card_against_cpu(cfg)
    emit({"phase": "lm_train_ssm", "seconds": time.perf_counter() - t0,
          **_size_fields(cfg, n_params),
          "ssm_state": cfg.ssm_state, "ssm_heads": cfg.ssm_heads,
          **_loop_fields(loop, LM_TRAIN_B * LM_TRAIN_S),
          "step0_loss_bf16": loop["losses"][0], "step0_loss_f32": f32_loss,
          "profile": short_profile,
          **_bounds(cfg, LM_TRAIN_B, LM_TRAIN_S, n_params),
          "long": {"batch": 1, "seq": SSM_TRAIN_LONG_S,
                   "chunks": SSM_TRAIN_LONG_S // 256,
                   **_loop_fields(long, SSM_TRAIN_LONG_S),
                   "peak_gb": long_peak / 1e9,
                   **_bounds(cfg, 1, SSM_TRAIN_LONG_S, n_params)},
          "f32_against_cpu": gate, "peak_gb": peak / 1e9, "card": card})
    return {"bf16": _merged(loop["launches"], long["launches"]),
            "f32": gate["launches"]}


def phase_lm_train_hybrid(card: str) -> dict:
    """jamba-1.5-large-398b at ``reduced()`` size in f32 (one block of 8
    sublayers: one attention, seven Mamba2 mixers, an MoE FFN on every
    odd sublayer), as ``lm_serve_hybrid`` serves it, trained through
    ``make_trainer``'s step: step 0 (:func:`lm_train_step0`) with K4 on
    ``sm90_tf32``, the loss within ``TOL`` and every gradient within
    ``GRAD_TOL`` of the plain replay under the K4 forward's routing,
    each K4 call within ``CARD_TOL``, the one-key-off control missing;
    20 steps at 8 x 128 (2 K4 ``sm90_tf32`` launches a step, nothing
    else), then 1 x 1024 tokens across 4 SSD chunks.  Full width does
    not fit: one 8-sublayer block is 44.6e9 parameters, about 713 GB of
    training state."""
    t0 = time.perf_counter()
    full = get_config(HYBRID_ARCH)
    cfg = reduced(full)
    run_step, state, api, batches = _trainer(cfg)
    n_params = sum(t.numel() for t in TREE.leaves(state.params))
    per_step = 2 * attention_layers(cfg)
    step0 = lm_train_step0(api, state.params, _cuda_batch(batches[0]),
                           per_step, route="sm90_tf32", tol=GRAD_TOL,
                           loss_tol=TOL, controls=("one_key_off",),
                           what="lm_train_hybrid step 0",
                           phase="lm_train_hybrid_step0")
    state, loop = train_loop(run_step, state, batches, per_step,
                             "sm90_tf32", "lm_train_hybrid", cfg)
    state, short_profile = profile_train_step(run_step, state,
                                              _cuda_batch(batches[-1]))
    state, long = train_loop(run_step, state,
                             [_long_batch(cfg, HYBRID_TRAIN_LONG_S)],
                             per_step, "sm90_tf32",
                             "lm_train_hybrid 1 x 1024", cfg, moved=False)
    peak = torch.cuda.max_memory_allocated()
    one = block_reckoning(full)
    emit({"phase": "lm_train_hybrid", "seconds": time.perf_counter() - t0,
          **_size_fields(cfg, n_params),
          "size": "reduced()", "block_spec": LM_T.block_spec(cfg),
          "experts": cfg.n_experts,
          "why_reduced": f"one full-width block of 8 sublayers is "
                         f"{one['block_params']:.4g} parameters, "
                         f"{16 * one['block_params'] / 1e9:.0f} GB of "
                         "training state at 16 bytes a parameter",
          "k4_sm90_tf32_per_step": per_step,
          **_loop_fields(loop, LM_TRAIN_B * LM_TRAIN_S),
          "step0_loss_rel_err": step0["loss_rel_err"],
          "step0_grad_worst": step0["grad_worst"], "profile": short_profile,
          **_bounds(cfg, LM_TRAIN_B, LM_TRAIN_S, n_params),
          "long": {"batch": 1, "seq": HYBRID_TRAIN_LONG_S,
                   **_loop_fields(long, HYBRID_TRAIN_LONG_S),
                   **_bounds(cfg, 1, HYBRID_TRAIN_LONG_S, n_params)},
          "peak_gb": peak / 1e9, "card": card})
    del state, run_step, api
    _free()
    return {"f32": _merged(loop["launches"], long["launches"])}


# --------------------------------------------------------------------------
# lm_train_vlm, lm_train_mqa, lm_train_dbrx, lm_train_dense: the decoder
# configs beyond minitron and mixtral trained through make_trainer
# --------------------------------------------------------------------------

#: the depth each is trained at, full width: f32 params, grads and both
#: moments at 16 bytes a parameter (by ``param_count``): llava-next-34b
#: 5 of 60 layers (3.25e9 parameters, 52.0 GB), granite-34b 5 of 88
#: (2.95e9, 47.2 GB), dbrx-132b 1 of 40 blocks (3.88e9, 62.0 GB: its
#: block alone is 3.26e9), deepseek-7b 14 of 30 (3.25e9, 52.0 GB),
#: phi3-medium-14b 8 of 40 (3.24e9, 51.8 GB)
VLM_TRAIN_LAYERS, MQA_TRAIN_LAYERS, DBRX_TRAIN_LAYERS = 5, 5, 1
DENSE_TRAIN = (("deepseek-7b", 14), ("phi3-medium-14b", 8))
#: llava's steps, each a batch of :data:`VLM_BATCH` x (2880 prefix rows
#: + :data:`VLM_TEXT` tokens); the dense configs' steps of 8 x 128
VLM_TRAIN_STEPS, DENSE_TRAIN_STEPS = 10, 5
#: granite's long step: one sequence of 4096 tokens
MQA_TRAIN_LONG_S = 4096


def vlm_batches(cfg, n: int) -> list[dict]:
    """``n`` training batches of llava's prefix path: :data:`VLM_BATCH`
    sequences of ``frontend_len`` + :data:`VLM_TEXT` positions, tokens
    and labels from the synthetic stream, the labels -1 over the prefix
    (the loss runs over the text), and prefix embeddings drawn from the
    seed as N(0, 1) x :data:`VLM_PREFIX_SCALE`, on the host as a loader
    hands them over (each step copies its 165 MB to the card)."""
    s = cfg.frontend_len + VLM_TEXT
    dc = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=VLM_BATCH,
                    seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 65)
    out = []
    for i in range(n):
        batch = global_batch_at(dc, i)
        batch["labels"][:, :cfg.frontend_len] = -1
        batch["prefix_embeds"] = torch.randn(
            (VLM_BATCH, cfg.frontend_len, cfg.d_model),
            generator=gen) * VLM_PREFIX_SCALE
        out.append(batch)
    return out


def train_config(card: str, cfg, phase: str, *, steps: int = LM_TRAIN_N,
                 controls: tuple = STEP0_CONTROLS, backward_gated=(),
                 repeat: bool = False, long_s: int = 0) -> dict:
    """``cfg`` (full width, the depth cut) trained through
    ``make_trainer``'s step in a plain loop, bf16 compute on f32
    masters: batches of 8 x 128 from the synthetic stream, or with a
    vision prefix :func:`vlm_batches`;

      * step 0 (:func:`lm_train_step0`): every K4 call of the forward
        and the recompute within ``CARD_TOL`` of the plain version,
        every gradient tensor within :data:`LM_TRAIN_GRAD_TOL` of the
        plain replay's (with experts under the K4 forward's routing),
        every attention backward call within ``TOL`` of autograd in f32
        (:func:`vjp_tapped`), each of ``controls`` missing the gradient
        gate (those in ``backward_gated`` the backward's); with
        ``repeat`` ``value_and_grad`` twice, bit for bit
        (:func:`bit_repeat`);
      * ``steps`` steps, each ``2 x attention_layers`` K4 ``sm90``
        launches and nothing else of K1-K4, no plain attention, finite;
        the params unchanged by step 0 (lr 0) and changed by step 1;
        step 0's loss and grad norm within :data:`LM_BF16_TOL` of the
        replay's; with experts the pairs each step dropped;
      * with ``long_s`` one sequence of ``long_s`` tokens twice,
        launches exact, then :func:`long_step_gate` on it;
      * step ms, tokens/s (positions a step over its median), the peak
        memory of step 0's checks and of the steps, a profiled step at
        each shape beside its bound (:func:`train_bounds`).

    Emits the row ``phase`` and returns the launches, the row and every
    param leaf's fingerprint after the steps (:func:`param_fingerprint`)."""
    t0 = time.perf_counter()
    vlm = cfg.frontend == "vision_stub"
    b, s = (VLM_BATCH, cfg.frontend_len + VLM_TEXT) if vlm \
        else (LM_TRAIN_B, LM_TRAIN_S)
    run_step, state, api, batches = _trainer(cfg, b, s,
                                             0 if vlm else steps)
    if vlm:
        batches = vlm_batches(cfg, steps)
    n_params = sum(t.numel() for t in TREE.leaves(state.params))
    per_step = 2 * attention_layers(cfg)
    b0 = _cuda_batch(batches[0])
    step0 = lm_train_step0(api, state.params, b0, per_step,
                           controls=controls, backward_gated=backward_gated,
                           what=f"{phase} step 0", phase=f"{phase}_step0")
    rep = bit_repeat(api, state.params, b0,
                     f"{phase} step 0") if repeat else None
    del b0
    step0_peak = torch.cuda.max_memory_allocated()
    _free()
    torch.cuda.reset_peak_memory_stats()
    state, loop = train_loop(run_step, state, batches, per_step, "sm90",
                             phase, cfg)
    fingerprint = param_fingerprint(state.params)
    loss_err = (abs(loop["losses"][0] - step0["plain_loss"])
                / abs(step0["plain_loss"]))
    gnorm_err = (abs(loop["grad_norms"][0] - step0["plain_gnorm"])
                 / abs(step0["plain_gnorm"]))
    expect(loss_err <= LM_BF16_TOL and gnorm_err <= LM_BF16_TOL,
           f"{phase} {cfg.name} step 0: loss {loss_err}, grad norm "
           f"{gnorm_err} relative to the plain replay > {LM_BF16_TOL}")
    state, profile = profile_train_step(run_step, state,
                                        _cuda_batch(batches[-1]))
    loop_peak = torch.cuda.max_memory_allocated()
    counts = [loop["launches"]]
    row = {"phase": phase, **_size_fields(cfg, n_params, b, s, steps),
           "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
           "group": cfg.n_heads // cfg.n_kv_heads,
           "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "window": cfg.window,
           **depth_fields(cfg), "k4_sm90_per_step": per_step,
           **_loop_fields(loop, b * s),
           "step0_plain_loss": step0["plain_loss"],
           "step0_plain_grad_norm": step0["plain_gnorm"],
           "step0_grad_worst": step0["grad_worst"],
           "step0_grad_worst_leaf": step0["grad_worst_leaf"],
           "step0_k4_worst_over_card_tol": step0["k4_worst_over_card_tol"],
           "step0_vjp_worst_over_tol": step0["vjp_worst_over_tol"],
           "step0_controls": {n: {k: v for k, v in step0[
               f"control_{n}"].items() if k != "grad_by_kind"}
               for n in controls},
           "step0_loss_rel_err": loss_err,
           "step0_grad_norm_rel_err": gnorm_err, "gate": LM_BF16_TOL,
           "grad_gate": LM_TRAIN_GRAD_TOL, "profile": profile,
           **_bounds(cfg, b, s, n_params),
           "step0_peak_gb": step0_peak / 1e9, "peak_gb": loop_peak / 1e9}
    if rep is not None:
        row["step0_repeat"] = rep
    if vlm:
        row.update(prefix=cfg.frontend_len, text_tokens=VLM_TEXT,
                   labelled_tokens_per_step=b * VLM_TEXT,
                   prefix_scale=VLM_PREFIX_SCALE)
    if cfg.n_experts:
        row.update(experts=cfg.n_experts, top_k=cfg.top_k,
                   capacity_factor=cfg.capacity_factor,
                   bin_rows=MOE.bin_capacity(b * s, cfg.top_k,
                                             cfg.n_experts,
                                             cfg.capacity_factor),
                   step0_replay_flips=step0["replay_flips"],
                   step0_replay_rows=step0["replay_rows"])
    if long_s:
        long_batch = _long_batch(cfg, long_s)
        what = f"{phase} 1 x {long_s}"
        torch.cuda.reset_peak_memory_stats()
        state, long = train_loop(run_step, state, [long_batch] * 2,
                                 per_step, "sm90", what, cfg, moved=False)
        long_peak = torch.cuda.max_memory_allocated()
        gate = long_step_gate(api, state.params, long_batch, per_step, what)
        state, long_profile = profile_train_step(run_step, state,
                                                 long_batch)
        counts.append(long["launches"])
        row["long"] = {"batch": 1, "seq": long_s,
                       **_loop_fields(long, long_s),
                       "peak_gb": long_peak / 1e9, "tapped": gate,
                       "profile": long_profile,
                       **_bounds(cfg, 1, long_s, n_params)}
    row.update(seconds=time.perf_counter() - t0, card=card)
    emit(row)
    del state, run_step, api, batches
    _free()
    return {"bf16": _merged(*counts), "row": row,
            "fingerprint": fingerprint}


def phase_lm_train_vlm(card: str) -> dict:
    """llava-next-34b at full width (d_model 7168, 56 heads over 8 at
    head dim 128, d_ff 20480, vocab 64000) and
    :data:`VLM_TRAIN_LAYERS` of its 60 layers, trained through its
    vision-prefix path (:func:`train_config`): each batch 2 x (2880
    prefix embeddings + 64 tokens), the prefix written over the first
    2880 positions inside the differentiated forward, the loss over the
    text; step 0's controls the no-gradient backward, the step without
    its prefix and dk, dv summed into the wrong kv head, each of which
    must miss the gradient gate, and the one-key-off backward, which at
    2944 keys moves a step's gradients by less than that gate and must
    miss the gate of every ``attention_vjp`` call against autograd
    instead; ``value_and_grad`` twice bit for bit;
    :data:`VLM_TRAIN_STEPS` steps."""
    cfg = dataclasses.replace(get_config(VLM_ARCH),
                              n_layers=VLM_TRAIN_LAYERS)
    return train_config(card, cfg, "lm_train_vlm", steps=VLM_TRAIN_STEPS,
                        controls=STEP0_CONTROLS + ("no_prefix",
                                                   "wrong_kv_head"),
                        backward_gated=("one_key_off",), repeat=True)


def phase_lm_train_mqa(card: str) -> dict:
    """granite-34b at full width (d_model 6144, 48 query heads on one kv
    head: the backward sums 48 heads' dk and dv into it; d_ff 24576,
    vocab 49152) and :data:`MQA_TRAIN_LAYERS` of its 88 layers
    (:func:`train_config`): step 0 with the one-key-off and no-gradient
    controls and :func:`group_sum_dropped` (dk and dv of one query head
    of the group), each of which must miss the gradient gate; 20 steps
    of 8 x 128, then 1 x 4096 twice with its K4 calls tapped
    (:func:`long_step_gate`)."""
    cfg = dataclasses.replace(get_config(MQA_ARCH),
                              n_layers=MQA_TRAIN_LAYERS)
    return train_config(card, cfg, "lm_train_mqa",
                        controls=STEP0_CONTROLS + ("group_sum_dropped",),
                        long_s=MQA_TRAIN_LONG_S)


def phase_lm_train_dbrx(card: str) -> dict:
    """dbrx-132b at full width (d_model 6144, 48 heads over 8, 16
    experts of d_ff 10752, top-4, capacity factor 1.25: 320-row bins for
    the 4096 pairs of 8 x 128 tokens, vocab 100352) and
    :data:`DBRX_TRAIN_LAYERS` of its 40 blocks (:func:`train_config`):
    step 0 under the K4 forward's routing (:class:`TrainRouting`; the
    replay's flips), ``value_and_grad`` twice bit for bit (the MoE
    backward's index ops), 20 steps of 8 x 128 with the pairs each
    dropped."""
    cfg = dataclasses.replace(get_config(DBRX_ARCH),
                              n_layers=DBRX_TRAIN_LAYERS)
    return train_config(card, cfg, "lm_train_dbrx", repeat=True)


def phase_lm_train_dense(card: str) -> dict:
    """deepseek-7b (32 heads on 32: a group of 1 in the backward) at
    :data:`DENSE_TRAIN` depth, then phi3-medium-14b (40 heads over 10),
    each at full width through :func:`train_config`: step 0 with its
    controls, then :data:`DENSE_TRAIN_STEPS` steps of 8 x 128."""
    runs = [train_config(card, dataclasses.replace(get_config(arch),
                                                   n_layers=layers),
                         "lm_train_dense", steps=DENSE_TRAIN_STEPS)
            for arch, layers in DENSE_TRAIN]
    return {"bf16": _merged(*(r["bf16"] for r in runs)),
            "rows": [r["row"] for r in runs]}


def phase_lm_train_resilient(card: str) -> dict:
    """``examples/train_100m.py``'s config (8 layers, d_model 768, 12
    heads over 4 at head dim 64, vocab 32768) in bf16 at its batch 8 x
    256 tokens and peak lr 1e-3, 30 steps through ``run_resilient`` with
    a checkpoint every 10 steps (asynchronous) into a temporary
    directory removed after the run: once without a failure, once with
    a ``failure_hook`` raising before step 15, which restores step 10
    and replays (16 K4 ``sm90`` launches a step: 480 and 560).  The two
    runs' final params and moments equal bit for bit, the replayed
    steps' losses equal the first pass's, and the loss at step 29 below
    step 0's.  Step times on the host clock (one step's end to the
    next's, the batch drawn included), the loop's own step times (to
    the step's return) and the worker's save times.  The clean run's
    final state and its checkpoint directory are handed on to
    ``lm_train_mesh_resilient`` (which removes the directory)."""
    cfg = dataclasses.replace(get_config(LM_TRAIN_ARCH), **RESILIENT_CUT)
    dc = DataConfig(vocab=cfg.vocab, seq_len=RESILIENT_S,
                    global_batch=RESILIENT_B, seed=SEED)
    per_step = 2 * attention_layers(cfg)
    runs = {}
    clean_dir = tempfile.mkdtemp(prefix="lm_train_resilient_")
    for name, fail_at in (("clean", None), ("failed", RESILIENT_FAIL)):
        _free()
        run_step, state, _api, _rules = make_trainer(
            cfg, global_batch=RESILIENT_B, seq_len=RESILIENT_S,
            peak_lr=RESILIENT_LR, total_steps=RESILIENT_N, device="cuda")
        seen, ends = [], [time.perf_counter()]
        fired = []

        def hook(step, fail_at=fail_at, fired=fired):
            if step == fail_at and not fired:
                fired.append(step)
                raise RuntimeError("injected node failure")

        def cb(step, m, seen=seen, ends=ends):
            seen.append((step, float(m["loss"])))
            ends.append(time.perf_counter())
        c = {}
        with contextlib.ExitStack() as stack:
            d = clean_dir if fail_at is None else stack.enter_context(
                tempfile.TemporaryDirectory())
            with counted(c), no_plain_attention():
                report = run_resilient(
                    state, run_step, lambda s: global_batch_at(dc, s),
                    RESILIENT_N, ResilienceConfig(
                        ckpt_dir=d, ckpt_every=RESILIENT_EVERY),
                    failure_hook=hook, metrics_cb=cb)
            saved = sorted(os.listdir(d))
        runs[name] = {"report": report, "seen": seen, "counts": c,
                      "saved": saved, "secs": np.diff(ends)}
        del state, run_step
    clean, failed = runs["clean"], runs["failed"]
    a, b = clean["report"], failed["report"]
    require(a.steps_done == b.steps_done == RESILIENT_N and a.restarts == 0
            and b.restarts == 1 and a.failures == []
            and b.failures == [(RESILIENT_FAIL,
                                "RuntimeError('injected node failure')")],
            f"lm_train_resilient: steps {a.steps_done}/{b.steps_done}, "
            f"restarts {a.restarts}/{b.restarts}, failures {b.failures}")
    replayed = RESILIENT_FAIL - RESILIENT_FAIL // RESILIENT_EVERY \
        * RESILIENT_EVERY
    for run, steps in ((clean, RESILIENT_N),
                       (failed, RESILIENT_N + replayed)):
        require(k4_only(run["counts"], "sm90", per_step * steps),
                f"lm_train_resilient launches {run['counts']}, want "
                f"{per_step} x {steps}")
    unequal = [p for part in ("params", "opt") for (p, x), (_, y) in zip(
        TREE.leaves_with_paths(getattr(a.final_state, part)),
        TREE.leaves_with_paths(getattr(b.final_state, part)))
        if not torch.equal(x, y)]
    require(not unequal, f"lm_train_resilient: the resumed run's final "
                         f"state differs from the clean run's at "
                         f"{unequal[:5]} ({len(unequal)} leaves)")
    first = dict(clean["seen"])
    replay_equal = all(first[s] == v for s, v in failed["seen"])
    require(replay_equal, "lm_train_resilient: a replayed step's loss "
                          "differs from the clean run's")
    require(first[RESILIENT_N - 1] < first[0],
            f"lm_train_resilient: loss {first[0]} -> "
            f"{first[RESILIENT_N - 1]}")
    n_params = sum(t.numel() for t in TREE.leaves(a.final_state.params))
    emit({"phase": "lm_train_resilient", "config": "train_100m",
          "cut": RESILIENT_CUT, "params": n_params,
          "dtype": str(cfg.compute_dtype), "batch": RESILIENT_B,
          "seq": RESILIENT_S, "steps": RESILIENT_N,
          "peak_lr": RESILIENT_LR, "ckpt_every": RESILIENT_EVERY,
          "fail_before_step": RESILIENT_FAIL,
          "restarts": [a.restarts, b.restarts],
          "failures": b.failures, "steps_replayed": replayed,
          "launches": {k: v["counts"] for k, v in runs.items()},
          "final_state_bit_equal": not unequal,
          "state_leaves": len(TREE.leaves(a.final_state)),
          "replayed_losses_equal": replay_equal,
          "loss_first_last": [first[0], first[RESILIENT_N - 1]],
          "saved_dirs": {k: v["saved"] for k, v in runs.items()},
          "step_ms_median": {k: float(np.median(v["secs"])) * 1e3
                             for k, v in runs.items()},
          "loop_step_ms_median": {
              k: float(np.median(v["report"].step_times)) * 1e3
              for k, v in runs.items()},
          "save_s": {k: v["report"].save_seconds for k, v in runs.items()},
          "tokens_per_s": RESILIENT_B * RESILIENT_S
          / float(np.median(clean["secs"])),
          "card": card})
    del runs, b
    _free()
    return {"bf16": _merged(clean["counts"], failed["counts"]),
            "clean_state": a.final_state, "clean_dir": clean_dir,
            "clean_losses": first}


#: ``mesh_attention``: the decode shapes whose cache is cut into slot
#: shards, ``(config, batch, heads, kv heads, head dim, slots)``: phi3's
#: (a 4096-slot cache) and mixtral's (its 4096-slot window's ring, full)
MESH_ATTN_SHAPES = (("phi3-medium-14b", 4, 40, 10, 128, 4096),
                    ("mixtral-8x7b", 4, 32, 8, 128, 4096))
MESH_SHARDS = 4
#: the merge also read at the production model axis's 8 and 16 shards
#: (bf16 partials are rounded before the merge, f32 ones are not)
MESH_SHARDS_MORE = (8, 16)
#: each route with its type: bf16 on sm90, f32 on sm90_tf32, and the FMA
#: kernel through ``via="fma"`` in both
MESH_ROUTES = (("sm90", torch.bfloat16), ("sm90_tf32", torch.float32),
               ("fma", torch.bfloat16), ("fma", torch.float32))
#: the one-rank NCCL group's rendezvous file (``build/`` is not committed)
MESH_RENDEZVOUS = Path(__file__).resolve().parent / "build" / \
    "nccl_rendezvous"
#: ``lm_serve_mesh``: the tensor-parallel degree of the mesh-free padded
#: model (phi3's 40 query heads over 10 kv heads pad to 40 over 20)
MESH_TP = 4


def _shard_partials(q, k, v, rt: str, groups: int,
                    shards: int = MESH_SHARDS):
    """K4 with its log-sum-exp on each of ``shards`` slot shards of (q,
    k, v) in the kernel layout: the stacked outputs and log-sum-exps."""
    n = k.shape[1] // shards
    parts = [K4.attention(q, k[:, i * n:(i + 1) * n].contiguous(),
                          v[:, i * n:(i + 1) * n].contiguous(),
                          groups=groups, causal=False, via=rt, lse=True)
             for i in range(shards)]
    return (torch.stack([o for o, _ in parts]),
            torch.stack([l for _, l in parts]))


def phase_mesh_attention(card: str, flush) -> dict:
    """K4's log-sum-exp at the sharded decode's shapes
    (:data:`MESH_ATTN_SHAPES`), on every route (:data:`MESH_ROUTES`):
    (a) ``out`` with ``lse`` equal to ``out`` without it, bit for bit;
    (b) ``lse`` within ``CARD_TOL`` of the plain version's; (c) the cache
    cut into 4 slot shards of 1024, K4 with ``lse`` on each and
    ``combine_partials`` merging them: within ``CARD_TOL`` of K4 over the
    whole cache and of the plain version, and so at 8 and 16 shards (the
    production model axis; a bf16 partial is rounded to bf16 before the
    merge, where the reference merges f32 partials); (d) the controls,
    one shard's ``lse`` shifted by ln 2 and one shard dropped, must fail
    that gate;
    (e) a fifth shard that keeps no slot (``lse`` -inf) changes the merge
    by nothing.  Then K4 ``sm90`` at phi3's decode shape timed with and
    without ``lse`` (flushed and back to back) beside its bound and
    SDPA's time.  Returns the phase's launches."""
    gen = torch.Generator().manual_seed(SEED + 41)
    rows, timing = [], {}
    counts = {}
    with counted(counts):
        for config, b, h, kv, hd, slots in MESH_ATTN_SHAPES:
            q32 = _randn(gen, b, 1, h, hd)
            k32, v32 = (_randn(gen, b, slots, kv, hd) for _ in range(2))
            for rt, dtype in MESH_ROUTES:
                qf, kf, vf = (heads_first(t.to(dtype))
                              for t in (q32, k32, v32))
                kw = dict(groups=h // kv, window=0, causal=False)
                alone = K4.attention(qf, kf, vf, via=rt, **kw)
                out, lse = K4.attention(qf, kf, vf, via=rt, lse=True, **kw)
                plain, plain_lse = attention_plain(qf, kf, vf,
                                                   return_lse=True, **kw)
                require(torch.equal(out, alone),
                        f"mesh_attention {config} {rt} {dtype}: out "
                        f"changes when lse is asked for")
                lse_chk = within(lse, plain_lse, dtype)
                require(lse_chk["worst_over_tol"] <= 1.0,
                        f"mesh_attention {config} {rt} {dtype}: lse "
                        f"{lse_chk}")
                outs, lses = _shard_partials(qf, kf, vf, rt, kw["groups"])
                merged = K4_OPS.combine_partials(outs, lses)
                vs_whole = within(merged, out, dtype)
                vs_plain = within(merged, plain, dtype)
                require(max(vs_whole["worst_over_tol"],
                            vs_plain["worst_over_tol"]) <= 1.0,
                        f"mesh_attention {config} {rt} {dtype}: the merge "
                        f"against the whole {vs_whole}, the plain "
                        f"{vs_plain}")
                more = {}
                for n in MESH_SHARDS_MORE:
                    m = K4_OPS.combine_partials(*_shard_partials(
                        qf, kf, vf, rt, kw["groups"], n))
                    more[n] = {"vs_whole": within(m, out, dtype),
                               "vs_plain": within(m, plain, dtype)}
                    require(max(more[n]["vs_whole"]["worst_over_tol"],
                                more[n]["vs_plain"]["worst_over_tol"])
                            <= 1.0,
                            f"mesh_attention {config} {rt} {dtype}: the "
                            f"merge of {n} shards {more[n]}")
                shifted = lses.clone()
                shifted[1] += math.log(2.0)
                c_shift = within(K4_OPS.combine_partials(outs, shifted),
                                 out, dtype)
                c_drop = within(K4_OPS.combine_partials(outs[1:], lses[1:]),
                                out, dtype)
                require(c_shift["worst_over_tol"] > 1.0
                        and c_drop["worst_over_tol"] > 1.0,
                        f"mesh_attention {config} {rt} {dtype}: a control "
                        f"passes: shifted {c_shift}, dropped {c_drop}")
                empty = K4_OPS.combine_partials(
                    torch.cat([outs, outs[:1]]),
                    torch.cat([lses, torch.full_like(lses[:1],
                                                     -torch.inf)]))
                moved = (empty.float() - merged.float()).abs().max().item()
                require(moved <= 1e-6 * merged.float().abs().max().item(),
                        f"mesh_attention {config} {rt} {dtype}: an empty "
                        f"shard moved the merge by {moved}")
                row = {"phase": "mesh_attention", "config": config,
                       "route": rt, "dtype": str(dtype),
                       "shape": {"b": b, "h": h, "kv": kv, "hd": hd,
                                 "slots": slots, "shards": MESH_SHARDS},
                       "out_bit_equal_with_lse": True,
                       "lse_vs_plain": lse_chk, "merge_vs_whole": vs_whole,
                       "merge_vs_plain": vs_plain,
                       "merge_more_shards": more,
                       "control_lse_shift_ln2": c_shift,
                       "control_shard_dropped": c_drop,
                       "empty_shard_moved": moved,
                       "empty_shard_bit_equal": bool(torch.equal(empty,
                                                                 merged)),
                       "card": card}
                emit(row)
                rows.append(row)
                if config == LM_ARCH and rt == "sm90":
                    timing = {"qf": qf, "kf": kf, "vf": vf, "kw": kw,
                              "dtype": dtype, "q": q32, "k": k32, "v": v32}
    # the timing launches are not the checks'
    qf, kf, vf, kw, dtype = (timing[n] for n in ("qf", "kf", "vf", "kw",
                                                 "dtype"))
    qh, kh, vh = (t.to(dtype).transpose(1, 2).contiguous()
                  for t in (timing["q"], timing["k"], timing["v"]))
    library = _library_attention(qh, kh, vh, window=0, causal=False)

    def without():
        return K4.attention(qf, kf, vf, **kw)

    def with_lse():
        return K4.attention(qf, kf, vf, lse=True, **kw)
    flops = 4.0 * qf.shape[-1] * qf.shape[0] * kf.shape[1]
    n_bytes = float((2 * qf.numel() + kf.numel() + vf.numel())
                    * qf.element_size())
    time_row = {"phase": "mesh_attention_time", "config": LM_ARCH,
                "route": "sm90", "dtype": str(dtype),
                "shape": dict(rows[0]["shape"]),
                "ms": _time_ms(without, flush),
                "ms_lse": _time_ms(with_lse, flush),
                "device_ms": _device_ms(without),
                "device_ms_lse": _device_ms(with_lse),
                "library_ms": _time_ms(library, flush),
                "library_device_ms": _device_ms(library),
                "library_kernels": library_kernels(library),
                **attention_bounds(flops, n_bytes, dtype, "sm90"),
                "lse_bytes": qf.shape[0] * qf.shape[1] * 4, "flops": flops,
                "bytes": n_bytes, "card": card}
    emit(time_row)
    require(counts["attention_lse"] == {
        rt: len(MESH_ATTN_SHAPES) * (1 + MESH_SHARDS + sum(MESH_SHARDS_MORE))
        * sum(r == rt for r, _ in MESH_ROUTES)
        for rt in K4.ROUTES},
        f"mesh_attention: lse launches {counts['attention_lse']}")
    return {"checks": counts, "time": time_row}


@contextlib.contextmanager
def one_rank_nccl():
    """A one-rank NCCL process group (rendezvous through a file under
    ``build/``, collectives timing out after 60 s) and its (1, 1) host
    mesh; the group is destroyed on the way out, an error passed on."""
    import torch.distributed as dist
    MESH_RENDEZVOUS.parent.mkdir(parents=True, exist_ok=True)
    MESH_RENDEZVOUS.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"file://{MESH_RENDEZVOUS}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield make_host_mesh("cuda")
    finally:
        dist.destroy_process_group()
        MESH_RENDEZVOUS.unlink(missing_ok=True)


def param_fingerprint(params) -> list:
    """Every leaf's f64 sum and sum of squares, in flattening order, each
    taken over slices of 2^26 elements (no f64 copy of a whole leaf)."""
    out = []
    for t in TREE.leaves(params):
        flat = t.detach().reshape(-1)
        total = squares = 0.0
        for i in range(0, flat.numel(), 1 << 26):
            x = flat[i:i + (1 << 26)].to(torch.float64)
            total += float(x.sum())
            squares += float(x.square().sum())
        out.append((total, squares))
    return out


def phase_lm_train_mesh(card: str, mesh, train: dict) -> dict:
    """``lm_train``'s run through ``make_trainer(cfg, mesh, ...)`` on the
    one-rank NCCL group's (1, 1) mesh: minitron-4b at full width and 24
    blocks, bf16 compute on f32 masters, the same 20 batches and
    schedule (8 x 128, peak lr 3e-4, warmup 2), after ``lm_train``'s
    state is freed (two 55 GB states do not fit).  Gated bit for bit
    against ``lm_train``'s recorded mesh-free run: each step's loss and
    grad norm, and after step 20 every param leaf's fingerprint.  Also
    gated: 48 K4 ``sm90`` launches a step and nothing else of K1-K4, no
    plain attention, and no collective counted (every axis has size 1:
    the mesh path's boundaries, gathers, gradient sync and shard-aware
    norm are all no-ops).  Step ms beside ``lm_train``'s, tokens/s and
    peak memory."""
    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(LM_TRAIN_ARCH),
                              n_layers=LM_TRAIN_BLOCKS)
    COL.reset()
    run_step, state, _api, rules = make_trainer(
        cfg, mesh, global_batch=LM_TRAIN_B, seq_len=LM_TRAIN_S,
        peak_lr=LM_TRAIN_LR, total_steps=LM_TRAIN_N, warmup=LM_TRAIN_WARMUP)
    dc = DataConfig(vocab=cfg.vocab, seq_len=LM_TRAIN_S,
                    global_batch=LM_TRAIN_B, seed=SEED)
    per_step = 2 * attention_layers(cfg)
    counts, losses, gnorms, secs = [], [], [], []
    for i in range(LM_TRAIN_N):
        batch = global_batch_at(dc, i)
        c = {}
        with counted(c), no_plain_attention():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = run_step(state, batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        require(k4_only(c, "sm90", per_step),
                f"lm_train_mesh step {i} launches {c}")
        counts.append(c)
        losses.append(loss)
        gnorms.append(gnorm)
    fingerprint = param_fingerprint(state.params)
    collectives = COL.counts_by_op()
    peak = torch.cuda.max_memory_allocated()
    losses_equal = losses == train["losses"]
    gnorms_equal = gnorms == train["grad_norms"]
    params_equal = fingerprint == train["fingerprint"]
    require(losses_equal and gnorms_equal and params_equal,
            f"lm_train_mesh against lm_train: losses equal {losses_equal}, "
            f"grad norms equal {gnorms_equal}, params equal {params_equal} "
            f"(losses {losses} vs {train['losses']})")
    require(not collectives, f"lm_train_mesh: collectives counted on a "
                             f"(1, 1) mesh: {collectives}")
    step_ms = _median(secs) * 1e3
    emit({"phase": "lm_train_mesh", "config": LM_TRAIN_ARCH,
          "blocks": LM_TRAIN_BLOCKS, "mesh": dict(mesh.shape),
          "backend": torch.distributed.get_backend(),
          "rules": {k: v for k, v in rules.items()},
          "dtype": str(cfg.compute_dtype), "batch": LM_TRAIN_B,
          "seq": LM_TRAIN_S, "steps": LM_TRAIN_N, "peak_lr": LM_TRAIN_LR,
          "warmup": LM_TRAIN_WARMUP, "k4_sm90_per_step": per_step,
          "launches": _merged(*counts), "collectives": collectives,
          "losses": losses, "grad_norms": gnorms,
          "losses_bit_equal": losses_equal,
          "grad_norms_bit_equal": gnorms_equal,
          "param_fingerprints_equal": params_equal,
          "param_leaves": len(fingerprint),
          "step_ms_median": step_ms, "step_ms_min": min(secs) * 1e3,
          "step_ms_max": max(secs) * 1e3,
          "step_ms_median_mesh_free": train["step_ms_median"],
          "tokens_per_s": LM_TRAIN_B * LM_TRAIN_S / _median(secs),
          "peak_gb": peak / 1e9, "peak_gb_mesh_free": train["peak_gb"],
          "card": card})
    del state, run_step, _api
    _free()
    return {"bf16": _merged(*counts), "step_ms_median": step_ms}


def _read_checkpoint(d: str, step: int) -> tuple[dict, dict]:
    """A checkpoint step's manifest (less its time) and its arrays."""
    path = os.path.join(d, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    manifest.pop("time")
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        return manifest, {k: data[k] for k in data.files}


def phase_lm_train_mesh_resilient(card: str, mesh, resilient: dict) -> dict:
    """``lm_train_resilient``'s failed run on the one-rank NCCL group's
    (1, 1) mesh: the 75.5M ``train_100m`` config in bf16, 30 steps of
    8 x 256 through ``make_trainer(cfg, mesh, ...)`` and
    ``run_resilient``, sharded checkpoints (whole leaves, written by
    rank 0) every 10 steps, a failure before step 15; ``on_restart``
    builds a fresh mesh from ``plan_remesh(1, 1, 8)`` and returns its
    step (``make_step``), onto which the restored whole leaves are
    resharded.  Gated: the final params and moments equal the clean
    mesh-free run's bit for bit; the step-10 checkpoint's manifest and
    leaves equal the clean mesh-free run's; 16 K4 ``sm90`` launches a
    step (35 steps); no collective counted.  Removes the clean run's
    checkpoint directory."""
    cfg = dataclasses.replace(get_config(LM_TRAIN_ARCH), **RESILIENT_CUT)
    dc = DataConfig(vocab=cfg.vocab, seq_len=RESILIENT_S,
                    global_batch=RESILIENT_B, seed=SEED)
    per_step = 2 * attention_layers(cfg)
    kw = dict(global_batch=RESILIENT_B, seq_len=RESILIENT_S,
              peak_lr=RESILIENT_LR, total_steps=RESILIENT_N)
    _free()
    COL.reset()
    run_step, state, _api, _rules = make_trainer(cfg, mesh, **kw)
    fired, meshes, seen = [], [], []

    def hook(step):
        if step == RESILIENT_FAIL and not fired:
            fired.append(step)
            raise RuntimeError("injected node failure")

    def on_restart(restarts):
        plan = plan_remesh(1, 1, RESILIENT_B)
        new = plan.build_mesh("cuda")
        meshes.append((plan.shape, plan.global_batch, dict(new.shape)))
        return make_step(cfg, new, **dict(kw, global_batch=plan.global_batch))

    c = {}
    clean_dir = resilient["clean_dir"]
    try:
        with tempfile.TemporaryDirectory() as d:
            with counted(c), no_plain_attention():
                report = run_resilient(
                    state, run_step, lambda s: global_batch_at(dc, s),
                    RESILIENT_N, ResilienceConfig(
                        ckpt_dir=d, ckpt_every=RESILIENT_EVERY),
                    failure_hook=hook, on_restart=on_restart,
                    metrics_cb=lambda i, m: seen.append((i, float(
                        m["loss"]))))
            saved = sorted(os.listdir(d))
            mine = _read_checkpoint(d, RESILIENT_EVERY)
        theirs = _read_checkpoint(clean_dir, RESILIENT_EVERY)
    finally:
        shutil.rmtree(clean_dir, ignore_errors=True)
    collectives = COL.counts_by_op()
    replayed = RESILIENT_FAIL - RESILIENT_FAIL // RESILIENT_EVERY \
        * RESILIENT_EVERY
    require(report.steps_done == RESILIENT_N and report.restarts == 1
            and report.failures == [(RESILIENT_FAIL,
                                     "RuntimeError('injected node failure')")]
            and len(meshes) == 1 and meshes[0][0] == (1, 1),
            f"lm_train_mesh_resilient: steps {report.steps_done}, restarts "
            f"{report.restarts}, failures {report.failures}, meshes "
            f"{meshes}")
    require(k4_only(c, "sm90", per_step * (RESILIENT_N + replayed)),
            f"lm_train_mesh_resilient launches {c}, want {per_step} x "
            f"{RESILIENT_N + replayed}")
    require(not collectives, f"lm_train_mesh_resilient: collectives "
                             f"counted on a (1, 1) mesh: {collectives}")
    clean = resilient["clean_state"]
    unequal = [p for part in ("params", "opt") for (p, x), (_, y) in zip(
        TREE.leaves_with_paths(getattr(clean, part)),
        TREE.leaves_with_paths(getattr(report.final_state, part)))
        if not torch.equal(x, y)]
    require(not unequal, f"lm_train_mesh_resilient: the final state differs "
                         f"from the clean mesh-free run's at {unequal[:5]} "
                         f"({len(unequal)} leaves)")
    ckpt_equal = mine[0] == theirs[0] and mine[1].keys() == theirs[1].keys() \
        and all(np.array_equal(v, theirs[1][k]) for k, v in mine[1].items())
    require(ckpt_equal, f"lm_train_mesh_resilient: the step-"
                        f"{RESILIENT_EVERY} checkpoint differs from the "
                        f"clean mesh-free run's")
    losses = resilient["clean_losses"]
    replay_equal = all(losses[i] == v for i, v in seen)
    require(replay_equal, "lm_train_mesh_resilient: a step's loss differs "
                          "from the clean mesh-free run's")
    emit({"phase": "lm_train_mesh_resilient", "config": "train_100m",
          "cut": RESILIENT_CUT, "mesh": dict(mesh.shape),
          "dtype": str(cfg.compute_dtype), "batch": RESILIENT_B,
          "seq": RESILIENT_S, "steps": RESILIENT_N,
          "ckpt_every": RESILIENT_EVERY, "fail_before_step": RESILIENT_FAIL,
          "restarts": report.restarts, "failures": report.failures,
          "remesh": [{"plan": list(p), "global_batch": gb, "mesh": m}
                     for p, gb, m in meshes],
          "steps_replayed": replayed, "launches": c,
          "collectives": collectives,
          "final_state_bit_equal_clean": not unequal,
          "ckpt_step_leaves": len(mine[1]),
          "ckpt_bit_equal_clean": ckpt_equal,
          "losses_equal_clean": replay_equal, "saved_dirs": saved,
          "loop_step_ms_median": float(np.median(report.step_times)) * 1e3,
          "save_s": report.save_seconds, "card": card})
    del report, state, run_step
    resilient.pop("clean_state")
    _free()
    return {"bf16": c}


def phase_lm_serve_mesh(card: str) -> dict:
    """phi3-medium-14b at full width and its 40 layers in bf16 through
    ``BatchedServer(cfg, mesh, ...)`` on a one-rank NCCL group's (1, 1)
    mesh, holding the weights of a mesh-free ``BatchedServer`` (the same
    tensors), at the reference server's defaults: its tokens and each
    step's logits equal the mesh-free server's bit for bit; 40 K4
    ``sm90`` launches a step, each with its log-sum-exp (the sharded
    decode's merge over one shard); the collectives it counted, by op.
    Then without a mesh ``build(cfg, tp=4)`` at full width: heads padded
    to 40 over 20 (K4 sees that shape), a prefill of 8 tokens in 4 rows
    and 16 greedy decode steps, each replayed (:func:`replay_plain`:
    every K4 call within ``CARD_TOL``, the logits within
    :data:`LM_BF16_TOL` of max |plain|), the ``drop_newest_slot``
    control failing that gate.  Peak memory of each part."""
    cfg = get_config(LM_ARCH)
    _free()
    torch.cuda.reset_peak_memory_stats()
    free = BatchedServer(cfg, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                         device="cuda", seed=SEED)
    reqs_free = lm_requests(cfg, SEED + 12)
    c_free = {}
    with counted(c_free), no_plain_attention():
        steps_free, secs_free = serve_lm(free, reqs_free, "sm90",
                                         cfg.n_layers)
    logits_free = [s[3] for s in steps_free]
    del steps_free
    with one_rank_nccl() as mesh:
        server = BatchedServer(cfg, mesh, slots=LM_SLOTS,
                               max_seq=LM_MAX_SEQ, params=free.params)
        same = all(a is b for a, b in zip(TREE.leaves(server.params),
                                          TREE.leaves(free.params)))
        require(same, "lm_serve_mesh: the mesh server's weights are not "
                      "the mesh-free server's tensors")
        reqs = lm_requests(cfg, SEED + 12)
        COL.reset()
        c_mesh = {}
        with counted(c_mesh), no_plain_attention():
            steps, secs = serve_lm(server, reqs, "sm90", cfg.n_layers)
        collectives = COL.counts_by_op()
        mesh_shape = dict(mesh.shape)
        backend = torch.distributed.get_backend()
    logits = [s[3] for s in steps]
    del steps
    tokens_equal = [r.out for r in reqs] == [r.out for r in reqs_free]
    logits_equal = len(logits) == len(logits_free) and all(
        torch.equal(a, b) for a, b in zip(logits, logits_free))
    require(tokens_equal and logits_equal,
            f"lm_serve_mesh: the mesh server's tokens equal "
            f"{tokens_equal}, logits equal {logits_equal}")
    n = cfg.n_layers * len(secs)
    require(k4_only(c_mesh, "sm90", n)
            and c_mesh["attention_lse"] == dict.fromkeys(K4.ROUTES, 0)
            | {"sm90": n}, f"lm_serve_mesh launches {c_mesh}")
    serve_peak = torch.cuda.max_memory_allocated()
    generated = sum(len(r.out) for r in reqs)
    del server, free, logits, logits_free
    _free()

    # the padded-head model, whole on the card
    torch.cuda.reset_peak_memory_stats()
    api = build_lm(cfg, tp=MESH_TP)
    heads = cfg.padded_heads(MESH_TP)
    params = api.init(torch.Generator(device="cuda").manual_seed(SEED + 51),
                      cast_blocks=True)
    gen = torch.Generator().manual_seed(SEED + 52)
    toks = torch.randint(0, cfg.vocab, (LM_SLOTS, LM_PROMPT),
                         generator=gen).cuda()
    seen = set()

    def shape(layer, q, k, v, out, *, window, causal):
        seen.add((q.shape[2], k.shape[2]))
    c_tp = {}
    steps = []
    with counted(c_tp), no_plain_attention():
        lg, caches = api.prefill(params, {"tokens": toks},
                                 max_seq=LM_PROMPT + LM_GEN, tap=shape)
        tok = lg.argmax(-1, keepdim=True)
        for i in range(LM_GEN):
            before = clone_caches(caches)
            lg, caches = api.decode_step(params, caches, tok, LM_PROMPT + i,
                                         tap=shape)
            steps.append((before, tok, LM_PROMPT + i, lg))
            tok = lg.argmax(-1, keepdim=True)
    require(heads == (40, 20) and seen == {heads},
            f"lm_serve_mesh tp={MESH_TP}: heads {heads}, K4 saw {seen}")
    require(k4_only(c_tp, "sm90", cfg.n_layers * (1 + LM_GEN)),
            f"lm_serve_mesh tp={MESH_TP} launches {c_tp}")
    teacher = replay_plain(api, params, steps, LM_BF16_TOL,
                           f"lm_serve_mesh tp={MESH_TP}")
    controls = control_drop_newest(
        api, params, steps, LM_BF16_TOL,
        positions=tuple(LM_PROMPT + p for p in LM_CONTROL_POS))
    tp_peak = torch.cuda.max_memory_allocated()
    weights = _nbytes(params)
    del api, params, caches, steps
    _free()
    emit({"phase": "lm_serve_mesh", "config": LM_ARCH,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "dtype": str(cfg.compute_dtype), "mesh": mesh_shape,
          "backend": backend, "requests": len(reqs), "steps": len(secs),
          "generated_tokens": generated, "tokens_equal": tokens_equal,
          "logits_bit_equal": logits_equal, "launches": c_mesh,
          "k4_sm90_per_step": cfg.n_layers, "collectives": collectives,
          "step_ms_median": _median(secs) * 1e3,
          "step_ms_median_mesh_free": _median(secs_free) * 1e3,
          "tokens_per_s": generated / sum(secs), "serve_peak_gb":
          serve_peak / 1e9,
          "tp4": {"tp": MESH_TP, "heads": list(heads),
                  "weights_gb": weights / 1e9, "prefill_tokens": LM_PROMPT,
                  "rows": LM_SLOTS, "decode_steps": LM_GEN,
                  "launches": c_tp, "teacher_forced": teacher,
                  "control_drop_newest": controls,
                  "peak_gb": tp_peak / 1e9},
          "card": card})
    return {"bf16": _merged(c_mesh, c_tp), "mesh_lse": c_mesh[
        "attention_lse"]}


# --------------------------------------------------------------------------
# the Mamba mixer on a "model" axis above 1, and the dry-run
# --------------------------------------------------------------------------

#: ``mesh_ssm``: the model-axis sizes the shards are emulated at, the
#: prefill's tokens and the decode steps after it
MESH_SSM_SHARDS = (4, 8, 16)
MESH_SSM_PROMPT, MESH_SSM_STEPS = 4096, 4
#: the f32 gate: every output and cache within this of max |whole|
MESH_SSM_F32_TOL = 1e-5
#: ``dryrun``: the meta cells, each ``(arch, shape, mesh)`` (a mesh
#: ``--mesh-shape``; ``None`` the production (16, 16)); the last is the
#: (1, 1) cell the card's decode step is held to
DRYRUN_CELLS = (("mamba2-1.3b", "decode_32k", None),
                ("mamba2-1.3b", "train_4k", None),
                ("phi3-medium-14b", "decode_32k", None),
                ("mamba2-1.3b", "decode_32k", "1x1"))
DRYRUN_OUT = Path(__file__).resolve().parent / "build" / "dryrun_torch"


def contiguous_cut(cfg, r: int, mp: int):
    """The control: rank ``r``'s conv channels read at its contiguous
    block of ``conv_dim`` (the reference's split of ``conv_w``) as if
    they were its heads'."""
    cut = SSM.heads_cut(cfg, r, mp)
    block = (cfg.d_inner + 2 * cfg.ssm_state) // mp
    return SSM.Cut(z=cut.z, x=(r * block, r * block + cut.x[1] - cut.x[0]),
                   dt=cut.dt)


def _mixer_params(cfg, dtype, gen):
    """One Mamba2 mixer at full width drawn on the card, its matrices in
    ``dtype``; ``A_log``, ``dt_bias``, ``D`` and ``norm_w`` (f32) drawn
    away from their init so that every head differs."""
    p = SSM.init_mamba(gen, cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim,
                       cfg.ssm_expand, cfg.ssm_conv, torch.float32)
    h = cfg.ssm_heads
    p["A_log"] = torch.randn(h, generator=gen, device="cuda") * 0.5
    p["dt_bias"] = torch.randn(h, generator=gen, device="cuda") * 0.5
    p["D"] = torch.randn(h, generator=gen, device="cuda")
    p["norm_w"] = 1 + 0.1 * torch.randn(cfg.d_inner, generator=gen,
                                        device="cuda")
    return {k: v.to(dtype) if v.dim() == 2 else v for k, v in p.items()}


def _mixer_run(p, x, steps, cfg, mp=None, cut=SSM.heads_cut):
    """The prefill of ``x`` and a decode step of each of ``steps``:
    whole (``mp`` None) or as ``mp`` shards (:func:`SSM.run_shards`).
    Returns every output, then the final SSM state and conv tail."""
    if mp is None:
        y, (st, tail) = SSM.mamba_forward(p, x, cfg)
    else:
        y, (st, tail) = SSM.run_shards(p, x, cfg, mp, cut=cut)
    outs = [y]
    for xt in steps:
        if mp is None:
            y, (st, tail) = SSM.mamba_decode(p, xt, cfg, st, tail)
        else:
            y, (st, tail) = SSM.run_shards(p, xt, cfg, mp, caches=(st, tail),
                                           cut=cut)
        outs.append(y)
    return outs + [st, tail]


def _mixer_gate(got: list, whole: list, dtype) -> dict:
    """Each of ``got`` against ``whole``: f32 within
    :data:`MESH_SSM_F32_TOL` of max |whole|, bf16 within ``CARD_TOL``;
    the worst of them, over its gate (<= 1 passes)."""
    worst = 0.0
    for a, b in zip(got, whole):
        if dtype == torch.float32:
            err = (a.float() - b.float()).abs().max().item()
            top = b.float().abs().max().item()
            worst = max(worst, err / (MESH_SSM_F32_TOL * max(top, 1e-30)))
        else:
            worst = max(worst, within(a, b, dtype)["worst_over_tol"])
    return {"worst_over_gate": worst}


def phase_mesh_ssm(card: str) -> dict:
    """The Mamba mixer's shards at full width, emulated in one process:
    mamba2-1.3b's (d_model 2048, 64 heads) and one of jamba's (d_model
    8192, 256 heads), in f32 and bf16, a :data:`MESH_SSM_PROMPT`-token
    prefill and :data:`MESH_SSM_STEPS` decode steps.  At each model-axis
    size of :data:`MESH_SSM_SHARDS`, shard r runs its body
    (:func:`SSM.mix`/``mix_decode``) on its contiguous ``in_proj``
    columns and its cache blocks, the gather and the sums done in the
    process (:func:`SSM.run_shards`): every output, the SSM state and
    the conv tail against the whole mixer's, gated (f32
    :data:`MESH_SSM_F32_TOL` of max |whole|, bf16 ``CARD_TOL``).  The
    control, the reference's contiguous split read as whole heads
    (:func:`contiguous_cut`), must fail the gate.  No kernel of K1-K4
    runs here."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 71)
    rows, counts = [], {}
    with counted(counts):
        for arch in (SSM_ARCH, HYBRID_ARCH):
            cfg = get_config(arch)
            for dtype in DTYPES:
                p = _mixer_params(cfg, dtype, gen)
                x = torch.randn((1, MESH_SSM_PROMPT, cfg.d_model),
                                generator=gen, device="cuda").to(dtype)
                steps = [torch.randn((1, 1, cfg.d_model), generator=gen,
                                     device="cuda").to(dtype)
                         for _ in range(MESH_SSM_STEPS)]
                with torch.no_grad():
                    whole = _mixer_run(p, x, steps, cfg)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    whole = _mixer_run(p, x, steps, cfg)
                    torch.cuda.synchronize()
                    whole_s = time.perf_counter() - t0
                    gates = {}
                    for mp in MESH_SSM_SHARDS:
                        gates[mp] = _mixer_gate(
                            _mixer_run(p, x, steps, cfg, mp), whole, dtype)
                        require(gates[mp]["worst_over_gate"] <= 1.0,
                                f"mesh_ssm {arch} {dtype} at {mp} shards: "
                                f"{gates[mp]}")
                    ctl = _mixer_gate(_mixer_run(
                        p, x, steps, cfg, MESH_SSM_SHARDS[0],
                        cut=contiguous_cut)[:1], whole[:1], dtype)
                require(ctl["worst_over_gate"] > 1.0,
                        f"mesh_ssm {arch} {dtype}: the contiguous-split "
                        f"control passes {ctl}")
                row = {"phase": "mesh_ssm", "config": arch,
                       "dtype": str(dtype), "d_model": cfg.d_model,
                       "ssm_heads": cfg.ssm_heads, "prompt": MESH_SSM_PROMPT,
                       "decode_steps": MESH_SSM_STEPS,
                       "shards": {str(mp): g for mp, g in gates.items()},
                       "control_contiguous_split": ctl,
                       "whole_s": whole_s, "card": card}
                emit(row)
                rows.append(row)
                del p, x, steps, whole
                _free()
    require(not any(n for c in counts.values() for n in c.values()),
            f"mesh_ssm: a kernel launched {counts}")
    return {"f32": counts}


def phase_lm_serve_mesh_ssm(card: str) -> dict:
    """The Mamba families through a one-rank NCCL group's (1, 1) mesh
    (``BatchedServer(cfg, mesh, ...)``, holding a mesh-free server's
    weights): mamba2-1.3b at full size in bf16, its tokens and every
    step's logits equal to the mesh-free server's bit for bit, no launch
    of K1-K4; jamba at ``reduced()`` in f32 likewise, one K4
    ``sm90_tf32`` launch a step per attention layer and nothing else,
    no plain attention."""
    runs, out = {}, {}
    for arch, cfg, route in (
            (SSM_ARCH, get_config(SSM_ARCH), "sm90"),
            (HYBRID_ARCH, reduced(get_config(HYBRID_ARCH)), "sm90_tf32")):
        _free()
        per_step = attention_layers(cfg) if cfg.family == "hybrid" else 0
        free = BatchedServer(cfg, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                             device="cuda", seed=SEED)
        reqs_free = lm_requests(cfg, SEED + 12)
        c_free = {}
        with counted(c_free), no_plain_attention():
            steps_free, secs_free = serve_lm(free, reqs_free, route,
                                             per_step)
        logits_free = [s[3] for s in steps_free]
        del steps_free
        with one_rank_nccl() as mesh:
            server = BatchedServer(cfg, mesh, slots=LM_SLOTS,
                                   max_seq=LM_MAX_SEQ, params=free.params)
            reqs = lm_requests(cfg, SEED + 12)
            COL.reset()
            c_mesh = {}
            with counted(c_mesh), no_plain_attention():
                steps, secs = serve_lm(server, reqs, route, per_step)
            collectives = COL.counts_by_op()
        logits = [s[3] for s in steps]
        del steps
        tokens_equal = [r.out for r in reqs] == [r.out for r in reqs_free]
        logits_equal = len(logits) == len(logits_free) and all(
            torch.equal(a, b) for a, b in zip(logits, logits_free))
        require(tokens_equal and logits_equal,
                f"lm_serve_mesh_ssm {arch}: tokens equal {tokens_equal}, "
                f"logits equal {logits_equal}")
        n = per_step * len(secs)
        require(k4_only(c_mesh, route, n),
                f"lm_serve_mesh_ssm {arch} launches {c_mesh}")
        runs[arch] = c_mesh
        out[arch] = {"dtype": str(cfg.compute_dtype),
                     "size": "full" if arch == SSM_ARCH else "reduced()",
                     "steps": len(secs), "tokens_equal": tokens_equal,
                     "logits_bit_equal": logits_equal, "launches": c_mesh,
                     "k4_per_step": {route: per_step},
                     "collectives": collectives,
                     "step_ms_median": _median(secs) * 1e3,
                     "step_ms_median_mesh_free": _median(secs_free) * 1e3}
        del server, free, logits, logits_free
    _free()
    emit({"phase": "lm_serve_mesh_ssm", "runs": out, "card": card})
    return {"bf16": runs[SSM_ARCH], "f32": runs[HYBRID_ARCH]}


# --------------------------------------------------------------------------
# examples: the sibling examples' paths on the card
# --------------------------------------------------------------------------

EXAMPLES = Path(__file__).resolve().parent / "examples"
#: the analysed layers: the sibling's defaults (B3, 128 -> 256, 56 x 56,
#: 3 x 3, stride 1) and the same at stride 2
ANALYSIS_ARGV = ((), ("--stride", "2"))
#: the served archs: the sibling's default and the reference test's
EXAMPLE_ARCHS = ("mixtral-8x7b", "minitron-4b")


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_analysis(card: str, flush) -> tuple[list, dict]:
    """``examples/accelerator_analysis_torch.py``'s ``main`` in-process
    for each of :data:`ANALYSIS_ARGV`, on the card: the layer's K1
    output within ``TOL`` of max |plain| of the plain version on the
    same inputs; the route the sibling printed the one whose counter
    rose, the route it planned, once, and nothing else of K1-K4 (no
    ``fma``); the control, the same call with the weights' kernel window
    flipped, missing ``TOL``.  K1 on the layer timed (flushed, and back
    to back as ``device_ms``) beside the plain version, ``F.conv2d``
    (cuDNN, TF32 off) and its 3xTF32 bound."""
    mod = load_example("accelerator_analysis_torch")
    rows, total = [], collections.Counter()
    for argv in ANALYSIS_ARGV:
        c, buf = {}, io.StringIO()
        with counted(c), contextlib.redirect_stdout(buf):
            got = mod.main(list(argv))
            torch.cuda.synchronize()
        printed = buf.getvalue().splitlines()
        (ran,) = [line for line in printed if line.startswith(mod.RAN)]
        shown = re.search(r": route (\S+), out ", ran).group(1)
        rose = {rt: n for rt, n in c["conv_lb"].items() if n}
        require(shown == got["ran"] == got["route"]
                and rose == {shown: 1} and c["conv_lb"]["fma"] == 0
                and not any(n for name in ("wgrad_lb", "matmul_lb",
                                           "attention")
                            for n in c[name].values()),
                f"examples analysis {argv}: printed {shown}, planned "
                f"{got['route']}, launched {c}")
        total.update(c["conv_lb"])
        x, w, out = got["x"], got["w"], got["out"]
        kw = dict(stride=got["stride"], padding=got["padding"])
        plain = conv2d_ref(x, w, **kw)
        abs_err, err = rel_err(out, plain)
        require(err <= TOL, f"examples analysis {argv}: K1 vs plain {err}")
        wrong = conv2d_lb(x, w.flip(0, 1).contiguous(), **kw)
        _, control = rel_err(wrong, plain)
        require(control > TOL, f"examples analysis {argv}: the flipped "
                               f"window passes, {control}")
        x_nchw = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        layer = got["layer"]
        flops = 2.0 * layer.macs
        n_bytes = 4.0 * (x.numel() + w.numel() + out.numel())
        t_ops = ops_s(flops, torch.float32, shown)
        t_bytes = n_bytes / HBM_BYTES_PER_S
        row = {"phase": "examples_analysis", "argv": list(argv),
               "layer": str(layer), "out": list(out.shape),
               "block": [got["block"].bm, got["block"].bn,
                         got["block"].bk],
               "plan_words": got["plan"].traffic(layer.batch).total,
               "eq15_words": got["plan"].bound_words(layer),
               "route_printed": shown, "launches": c["conv_lb"],
               "max_abs_err": abs_err, "max_abs_err_over_max_plain": err,
               "tol": TOL, "control_flipped_window_over_max_plain": control,
               "ms": _time_ms(lambda: conv2d_lb(x, w, **kw), flush),
               "device_ms": _device_ms(lambda: conv2d_lb(x, w, **kw)),
               "plain_ms": _time_ms(lambda: conv2d_ref(x, w, **kw), flush),
               "library_ms": _time_ms(lambda: F.conv2d(
                   x_nchw, w_oihw, **kw), flush),
               "library_device_ms": _device_ms(lambda: F.conv2d(
                   x_nchw, w_oihw, **kw)),
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "lines": printed[-4:], "card": card}
        emit(row)
        rows.append(row)
    return rows, dict(total)


def example_serve(arch: str, mesh, mod) -> dict:
    """``examples/serve_batched_torch.py``'s ``serve`` for ``arch`` at
    its defaults (``reduced(..., capacity_factor=8.0)``, f32, 8 requests
    of 6 tokens, 4 slots, 12 new tokens, 96 cache slots) on the card,
    through ``mesh`` and mesh-free on the same params: every request
    completes with its tokens; the mesh's tokens and every step's logits
    equal the mesh-free server's bit for bit; K4 ``sm90_tf32`` launches
    the attention layers x the steps in each run and nothing else of
    K1-K4, the mesh's each with its log-sum-exp, no plain attention;
    every mesh-free step replayed by :func:`replay_plain` at ``TOL``
    (every K4 call within ``CARD_TOL``, the experts under the served
    routing) and the ``drop_newest_slot`` control missing it."""
    cfg = reduced(get_config(arch), capacity_factor=8.0)
    params = build_lm(cfg).init(
        torch.Generator(device="cuda").manual_seed(SEED), cast_blocks=True)
    kw = dict(slots=4, device="cuda", log=lambda *_: None)
    per_step = attention_layers(cfg)
    routing = Routing(moe_layers(cfg)) if cfg.n_experts else None
    lines, c_free, c_mesh, free, trace = [], {}, {}, [], []
    reqs_free = mod.make_requests(cfg, 8, 12)
    t0 = time.perf_counter()
    with counted(c_free), no_plain_attention(), _recorded(routing):
        mod.serve(cfg, None, params, reqs_free, trace=free, **kw)
    secs_free = time.perf_counter() - t0
    reqs = mod.make_requests(cfg, 8, 12)
    t0 = time.perf_counter()
    with counted(c_mesh), no_plain_attention():
        mod.serve(cfg, mesh, params, reqs, trace=trace,
                  **(kw | {"log": lines.append}))
    secs = time.perf_counter() - t0
    tokens_equal = [r.out for r in reqs] == [r.out for r in reqs_free]
    logits_equal = len(trace) == len(free) and all(
        torch.equal(a[3], b[3]) for a, b in zip(trace, free))
    require(tokens_equal and logits_equal
            and all(r.done and len(r.out) == r.max_new for r in reqs),
            f"examples serve {arch}: tokens equal {tokens_equal}, logits "
            f"equal {logits_equal}, done {[len(r.out) for r in reqs]}")
    n = per_step * len(trace)
    require(k4_only(c_free, "sm90_tf32", n) and k4_only(c_mesh, "sm90_tf32", n)
            and c_mesh["attention_lse"] == dict.fromkeys(K4.ROUTES, 0)
            | {"sm90_tf32": n},
            f"examples serve {arch}: launches {c_free}, {c_mesh}, want "
            f"{n} on sm90_tf32")
    del trace
    api = build_lm(cfg)
    teacher = replay_plain(api, params, free, TOL, f"examples serve {arch}",
                           routing)
    controls = control_drop_newest(api, params, free, TOL, routing)
    generated = sum(len(r.out) for r in reqs)
    return {"config": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": str(cfg.compute_dtype), "requests": len(reqs),
            "steps": len(free), "generated_tokens": generated,
            "tokens_equal": tokens_equal, "logits_bit_equal": logits_equal,
            "launches": c_mesh, "launches_mesh_free": c_free,
            "k4_sm90_tf32_per_step": per_step, "teacher_forced": teacher,
            "control_drop_newest": controls, "serve_s": secs,
            "serve_s_mesh_free": secs_free, "tokens_per_s": generated / secs,
            "summary": lines[-4].strip()}


def phase_examples(card: str) -> dict:
    """The sibling examples' paths on the card (:func:`example_analysis`,
    then :func:`example_serve` for each of :data:`EXAMPLE_ARCHS` on a
    one-rank NCCL group's (1, 1) mesh); the phase's seconds."""
    t0 = time.perf_counter()
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    rows, k1 = example_analysis(card, flush)
    del flush
    mod = load_example("serve_batched_torch")
    with one_rank_nccl() as mesh:
        served = [example_serve(arch, mesh, mod) for arch in EXAMPLE_ARCHS]
    counts = _merged(*(s[key] for s in served
                       for key in ("launches", "launches_mesh_free")))
    emit({"phase": "examples", "served": served, "k1_launches": k1,
          "seconds": time.perf_counter() - t0, "card": card})
    return {"k1": k1, "f32": counts, "rows": rows}


def start_dryrun() -> list:
    """The dry-run's :data:`DRYRUN_CELLS` on the ``meta`` device, one
    process each (one ``"fake"`` group each), run one after another at
    the lowest CPU priority in one shell, so that the host-bound phases
    beside them keep their cores; :func:`phase_dryrun` waits for it."""
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent
                                           / "src"),
           "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    cmds = []
    for arch, shape, dims in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--json", "--out", str(DRYRUN_OUT)]
        cmd += ["--mesh-shape", dims] if dims else ["--mesh", "single"]
        cmds.append(" ".join(shlex.quote(c) for c in cmd))
    return [subprocess.Popen(["nice", "-n", "19", "sh", "-c",
                              " && ".join(cmds)], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)]


def stop(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def phase_dryrun(card: str, procs: list) -> dict:
    """The meta cells of :func:`start_dryrun` (each record printed on a
    line), then mamba2-1.3b x decode_32k at full shape on the card
    through a one-rank NCCL group's (1, 1) mesh (``launch.dryrun.
    run_cell``: f32 params drawn on the card, the inputs and caches from
    ``make_batch``, one decode step under the same counters):
    ``sharded_bytes_per_chip`` of its params and caches equal to the
    bytes allocated for them, and the FLOPs counted on the card equal to
    the meta run's of the (1, 1) cell; the card's peak memory beside
    ``analytic_memory_gb``, ungated."""
    (proc,) = procs
    try:
        text, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        stop(procs)
        raise SmokeFailure("dryrun: the meta cells gave no result in time")
    recs = [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]
    require(proc.returncode == 0 and len(recs) == len(DRYRUN_CELLS),
            f"dryrun: rc {proc.returncode}, {len(recs)} records, "
            f"{text[-2000:]}")
    require(all((r["arch"], r["shape"]) == (a, sh)
                for (a, sh, _d), r in zip(DRYRUN_CELLS, recs)),
            f"dryrun: records out of order {[r['arch'] for r in recs]}")
    records = dict(zip(DRYRUN_CELLS, recs))
    for rec in recs:
        emit({"phase": "dryrun_meta", **rec, "card": card})
    arch, shape_name, dims = DRYRUN_CELLS[-1]
    meta = records[DRYRUN_CELLS[-1]]
    cfg, shape = DRY.cell_config(arch, shape_name)
    _free()
    torch.cuda.reset_peak_memory_stats()
    with one_rank_nccl() as mesh:
        api = build_lm(cfg, tp=1)
        rules = SH.axis_rules(mesh, shape.global_batch, shape.seq_len)
        launches = {}
        with counted(launches), torch.no_grad():
            t0 = time.perf_counter()
            counts, memo, params, caches = DRY.run_cell(
                api, shape, mesh, rules,
                key=torch.Generator(device="cuda").manual_seed(SEED + 81))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        allocated = sum(t.numel() * t.element_size()
                        for t in TREE.leaves((params, caches))
                        if isinstance(t, torch.Tensor))
        analytic = sum(sharded_bytes_per_chip(tree, specs, mesh)
                       for tree, specs in memo.values())
    peak = torch.cuda.max_memory_allocated()
    require(allocated == analytic,
            f"dryrun: {allocated} bytes allocated for the params and "
            f"caches, the memory model says {analytic}")
    require(counts["flops"] == meta["flops_per_chip"],
            f"dryrun: {counts['flops']} FLOPs counted on the card, "
            f"{meta['flops_per_chip']} on meta")
    del params, caches, memo
    _free()
    row = {"phase": "dryrun_card", "config": arch, "shape": shape_name,
           "mesh": "1x1", "global_batch": shape.global_batch,
           "seq_len": shape.seq_len, "state_bytes": allocated,
           "state_bytes_memory_model": analytic,
           "flops": counts["flops"], "flops_meta": meta["flops_per_chip"],
           "bytes_counted": counts["bytes"],
           "bytes_counted_meta": meta["hbm_bytes_per_chip"],
           "max_memory_allocated_gb": peak / 1e9,
           "analytic_memory_gb": meta["analytic_memory_gb"],
           "step_with_setup_s": secs, "launches": launches, "card": card}
    emit(row)
    return {"f32": launches}


class Decisions:
    """The discrete choices of a forward, shared between two runs.

    A ReLU keeps a pixel where its pre-activation is positive, and a
    max-pool routes a window's gradient to its maximum.  The kernel and
    the plain version sum in different orders, so a pre-activation
    within ~1e-6 of zero, or two pixels of a window within ~1e-6 of
    each other, can go one way in one and the other way in the other;
    the gradient then flows through another pixel, and the difference
    spreads through every layer below.  ``record`` is a conv for
    ``graph_forward`` that runs the port's conv and keeps the choices
    the port's backward makes (from the kernel's own pre-epilogue
    sums); ``replay`` is the plain version with those choices, whose
    autograd then differs from the port's only by the order of the
    sums.  ``flips`` counts where the plain version's own choices
    differ."""

    def __init__(self):
        self.masks, self.argmax = [], []
        self.flips = {"relu": 0, "pool": 0}
        self._i = 0

    @staticmethod
    def _windows(a: torch.Tensor, pool: int) -> torch.Tensor:
        b, h, w, c = a.shape
        return (a.reshape(b, h // pool, pool, w // pool, pool, c)
                .permute(0, 1, 3, 5, 2, 4)
                .reshape(b, h // pool, w // pool, c, pool * pool))

    def record(self, x, w, bias=None, residual=None, *, relu, pool,
               **kw):
        with torch.no_grad():
            z = conv2d_lb(x, w, **kw)
            if bias is not None:
                z = z + bias
            if residual is not None:
                z = z + residual
            self.masks.append(relu_slope(z) if relu else None)
            a = torch.clamp_min(z, 0.0) if relu else z
            self.argmax.append(self._windows(a, pool).argmax(
                dim=-1, keepdim=True) if pool > 1 else None)
        return conv2d_lb(x, w, bias, residual, relu=relu, pool=pool, **kw)

    def replay(self, x, w, bias=None, residual=None, *, relu, pool,
               **kw):
        mask, idx = self.masks[self._i], self.argmax[self._i]
        self._i += 1
        z = conv2d_ref(x, w, bias, residual, **kw)
        if relu:
            self.flips["relu"] += int((relu_slope(z.detach()) != mask)
                                      .sum())
            z = z * mask
        if pool > 1:
            win = self._windows(z, pool)
            own = win.detach().argmax(dim=-1, keepdim=True)
            self.flips["pool"] += int((own != idx).sum())
            z = win.gather(-1, idx).squeeze(-1)
        return z


#: K1's launches by route in one f32 SGD step (forward, the backward's
#: recompute, and the dgrad of every conv but the first): VGG16/224's
#: 12 stride-1 convs and conv1_1's plane; ResNet-20/32's 16 stride-1 and
#: 4 strided convs (their dgrads one launch each, by output phases) and
#: its stem's plane; none on FMA
TRAIN_ROUTES = {"vgg": {"sm90_tf32": 36, "sm90_im2col": 2},
                "resnet": {"sm90_tf32": 60, "sm90_im2col": 2}}


def phase_train(model: str) -> dict:
    """A few SGD steps at full width, batch 8, through
    ``launch/train_vgg.py``'s step on the card; step 0's gradients held
    against the plain version's autograd on the same weights, batch,
    ReLU masks and pool maxima (:class:`Decisions`), and reported
    against its autograd on its own choices.  Returns the launches of
    the run."""
    gen = torch.Generator().manual_seed(SEED)
    size = 224 if model == "vgg" else 32
    graph, params = T.build_model(model, width_mult=1.0, n_classes=10,
                                  generator=gen, device="cuda")
    images, labels = T.make_batch(8, size, 10, gen, "cuda")
    stages = graph_stages(graph, size, size)
    n_convs = len(stages)
    # every conv's wgrad takes the route of its geometry, f32
    want_routes = dict.fromkeys(W.ROUTES, 0)
    for st in stages:
        n = st.node
        want_routes[want_wgrad_route(torch.float32, n.ci, n.co, n.hk,
                                     n.stride)] += TRAIN_STEPS
    plain_loss, plain = T.loss_and_grads(graph, params, images, labels,
                                         conv=conv2d_ref)
    dec = Decisions()
    with torch.no_grad():
        graph_logits(graph, params, images, conv=dec.record)
    _, aligned = T.loss_and_grads(graph, params, images, labels,
                                  conv=dec.replay)
    torch.cuda.synchronize()
    rep = graph_training_step_report(graph, size, size, batch=8,
                                     vmem_budget=1 << 20)
    per_step, errs, own = [], [], []

    def check(i, loss, grads):
        per_step.append((K.conv_lb.launches, W.wgrad_lb.launches))
        if i == 0:
            errs.extend(rel_err(g, want)[1]
                        for g, want in zip(grads, aligned))
            own.extend(rel_err(g, want)[1] for g, want in zip(grads, plain))
            errs.append(abs(float(loss) - float(plain_loss))
                        / abs(float(plain_loss)))

    # the steps' spans only: the tracer is not made ambient, so the
    # forward records no per-layer spans and waits for no layer (the
    # ``trace`` phase drives a traced step)
    tracer = Tracer()
    _reset_k1()
    _reset_k2()
    losses = T.train(graph, params, images, labels, steps=TRAIN_STEPS,
                     lr=TRAIN_LR[model], traffic_bytes=rep["bytes_per_step"],
                     on_step=check, tracer=tracer)
    launches = _k1_k2_launches()
    k1 = [c - p for (c, _), (p, _) in zip(per_step, [(0, 0)] + per_step)]
    k2 = [c - p for (_, c), (_, p) in zip(per_step, [(0, 0)] + per_step)]
    step_ms = [sp.attrs["us"] / 1e3 for sp in tracer.find("train.step")]
    # forward + recompute through K1 for every conv; dgrad for every
    # conv but the first (the images need no gradient)
    want_k1 = 3 * n_convs - 1
    row = {"phase": f"train_{model}", "batch": 8, "image": size,
           "convs": n_convs, "steps": TRAIN_STEPS, "lr": TRAIN_LR[model],
           "losses": losses, "plain_loss_step0": float(plain_loss),
           "grad_max_err_over_max_plain": max(errs[:-1]),
           "grad_tol": GRAD_TOL,
           "grad_max_err_over_max_plain_own_choices": max(own),
           "grad_err_per_tensor_own_choices": own,
           "plain_own_choices_flipped": dec.flips,
           "loss_rel_err_step0": errs[-1],
           "conv_lb_launches_per_step": k1,
           "wgrad_lb_launches_per_step": k2, "launches": launches,
           "step_ms": step_ms,
           "bytes_per_step": rep["bytes_per_step"],
           "train_vs_bound_x": rep["train_vs_bound_x"]}
    emit(row)
    require(all(np.isfinite(losses)), f"train_{model}: loss not finite")
    require(max(errs[:-1]) <= GRAD_TOL, f"train_{model}: step-0 grads vs "
            f"plain {max(errs[:-1])} > {GRAD_TOL}")
    require(errs[-1] <= TOL, f"train_{model}: step-0 loss vs plain "
                             f"{errs[-1]}")
    require(k1 == [want_k1] * TRAIN_STEPS,
            f"train_{model}: K1 launches per step {k1} != {want_k1}")
    require(k2 == [n_convs] * TRAIN_STEPS,
            f"train_{model}: K2 launches per step {k2} != {n_convs}")
    want_k1_routes = dict.fromkeys(K.ROUTES, 0) | {
        rt: n * TRAIN_STEPS for rt, n in TRAIN_ROUTES[model].items()}
    require(launches["conv_lb_by_route"] == want_k1_routes,
            f"train_{model}: K1 launches by route "
            f"{launches['conv_lb_by_route']} != {want_k1_routes}")
    require(launches["conv_stage"] == want_k1_routes["sm90_im2col"],
            f"train_{model}: K1 staging launches {launches['conv_stage']}")
    require(launches["wgrad_lb_by_route"] == want_routes,
            f"train_{model}: K2 launches by route "
            f"{launches['wgrad_lb_by_route']} != {want_routes}")
    require(launches["wgrad_stage"] == want_routes["sm90_im2col"],
            f"train_{model}: im2col staging launches "
            f"{launches['wgrad_stage']}")
    return launches | {"losses": losses}


def _reset_k2() -> None:
    """Set K2's launch counts to 0 before a path is driven."""
    W.wgrad_lb.launches = 0
    W.wgrad_lb.launches_by_route = dict.fromkeys(W.ROUTES, 0)
    W.wgrad_lb.reduce_launches = 0
    W.wgrad_lb.stage_launches = 0


def _k1_k2_launches() -> dict:
    return {"conv_lb": K.conv_lb.launches,
            "conv_lb_by_route": dict(K.conv_lb.launches_by_route),
            "conv_stage": K.conv_lb.stage_launches,
            "wgrad_lb": W.wgrad_lb.launches,
            "wgrad_lb_by_route": dict(W.wgrad_lb.launches_by_route),
            "wgrad_reduce": W.wgrad_lb.reduce_launches,
            "wgrad_stage": W.wgrad_lb.stage_launches}


# --------------------------------------------------------------------------
# plan_audit: the sm90 legality profile against the card and the launches
# --------------------------------------------------------------------------

#: the card facts the plans are sized by: the constant, the field of
#: ``torch.cuda.get_device_properties`` and the ``cudaDeviceAttr`` that
#: read it where torch lacks the field
CARD_FACTS = (("SMEM_PER_BLOCK", SMEM_PER_BLOCK,
               "shared_memory_per_block_optin", 97),
              ("SM_COUNT", SM_COUNT, "multi_processor_count", 16),
              ("REGS_PER_SM", REGS_PER_SM, "regs_per_multiprocessor", 82))
#: the audit's batches (the serving buckets; training runs at 8)
AUDIT_BATCHES = (1, 2, 4, 8)


def _cuda_attribute(attr: int) -> int:
    """``cudaDeviceGetAttribute(attr, 0)`` through the CUDA runtime."""
    for name in ("libcudart.so", "libcudart.so.12",
                 "/usr/local/cuda/lib64/libcudart.so"):
        try:
            rt = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        raise SmokeFailure("plan_audit: no CUDA runtime library to read "
                           "the card's attributes")
    value = ctypes.c_int()
    err = rt.cudaDeviceGetAttribute(ctypes.byref(value), attr, 0)
    require(err == 0, f"plan_audit: cudaDeviceGetAttribute({attr}) = {err}")
    return value.value


def card_facts() -> dict:
    """``{constant: (the device's value, where it was read)}``."""
    props = torch.cuda.get_device_properties(0)
    facts = {}
    for name, _, field, attr in CARD_FACTS:
        value = getattr(props, field, None)
        facts[name] = ((int(value), f"torch:{field}") if value is not None
                       else (_cuda_attribute(attr),
                             f"cudaDeviceGetAttribute:{attr}"))
    return facts


def _dtype_of(*keys):
    """The one type of the operands whose launch-cache keys these are
    (``None`` where they differ), and whether every base is aligned."""
    keys = [k for k in keys if k is not None]
    types = {k[1] for k in keys}
    return (types.pop() if len(types) == 1 else None,
            all(k[4] for k in keys))


def _k3_launch(rt: str, x, w) -> tuple:
    m, k = x.shape
    n = w.shape[1]
    kmajor = K3.w_layout(w) == "k-major"
    ldb = w.stride(1) if kmajor else w.stride(0)
    return ("matmul_lb", rt, K3.tile_of(rt, m, n),
            (m, n, k, kmajor, x.stride(0), ldb), x.dtype)


class LaunchLog:
    """Every K1 and K2 launch-cache entry looked up, and every K3 and K4
    launch plan asked for, while the respective recorder is on."""

    def __init__(self):
        self.k1: dict = {}
        self.k2: dict = {}
        self.dense: set = set()

    @contextlib.contextmanager
    def conv(self):
        """Record K1's and K2's launch-cache lookups (one per launch)."""
        def recording(get, into):
            def get_and_record(key, make):
                entry, fresh = get(key, make)
                into[key] = entry
                return entry, fresh
            return get_and_record

        K.launch_cache.get = recording(K.launch_cache.get, self.k1)
        W.launch_cache.get = recording(W.launch_cache.get, self.k2)
        try:
            yield self
        finally:
            del K.launch_cache.get, W.launch_cache.get

    @contextlib.contextmanager
    def matmul_attention(self):
        """Record K3's and K4's launch plans: K3's ``route`` and K4's
        ``plan_of`` (one per routed call) and the launchers the smoke
        calls directly."""
        saved = {(m, n): getattr(m, n) for m, n in (
            (K3, "route"), (K3, "_sm90_tf32"), (K3, "_fma"),
            (K4, "plan_of"), (K4, "_sm90_tf32"))}
        k3_route, k4_plan = saved[K3, "route"], saved[K4, "plan_of"]
        k4_tf32 = saved[K4, "_sm90_tf32"]

        def k3_route_of(x, w):
            rt = k3_route(x, w)
            self.dense.add(_k3_launch(rt, x, w))
            return rt

        def k3_direct(rt, launch):
            def launch_and_record(x, w, **kw):
                self.dense.add(_k3_launch(rt, x, w))
                return launch(x, w, **kw)
            return launch_and_record

        def k4_shape(q, k):
            return (q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                    q.shape[0] // k.shape[0])

        def k4_plan_of(q, k, v, via=None):
            rt, plan = k4_plan(q, k, v, via)
            if plan is not None:
                self.dense.add(("attention", rt, plan, k4_shape(q, k),
                                q.dtype))
            return rt, plan

        def k4_sm90_tf32(q, k, v, plan, **kw):
            self.dense.add(("attention", "sm90_tf32", plan,
                            k4_shape(q, k), q.dtype))
            return k4_tf32(q, k, v, plan, **kw)

        K3.route, K4.plan_of = k3_route_of, k4_plan_of
        K3._sm90_tf32 = k3_direct("sm90_tf32", saved[K3, "_sm90_tf32"])
        K3._fma = k3_direct("fma", saved[K3, "_fma"])
        K4._sm90_tf32 = k4_sm90_tf32
        try:
            yield self
        finally:
            for (m, n), fn in saved.items():
                setattr(m, n, fn)


def _registers(libs) -> tuple[dict, list[dict]]:
    """Each built library's kernels' REG, SHARED, LOCAL and STACK
    (``cuobjdump --dump-resource-usage`` of the toolkit that built
    them) beside the spill stores and loads ``ptxas -v`` printed for
    them, and ``{source: {kernel: REG}}``."""
    regs, rows = {}, []
    for lib in libs:
        stem = lib.path.stem.rsplit("-", 1)[0]
        usage = resource_usage(lib)
        require(usage, f"plan_audit: cuobjdump read no kernel of {stem}")
        spills = parse_ptxas_spills(lib.log)
        regs[stem] = {fn: u["REG"] for fn, u in usage.items()}
        for fn, u in usage.items():
            sp = spills.get(fn, {})
            rows.append({"source": stem, "function": fn, "REG": u["REG"],
                         "SHARED": u.get("SHARED", 0),
                         "LOCAL": u.get("LOCAL", 0),
                         "STACK": u.get("STACK", 0),
                         "spill_stores": sp.get("spill_stores"),
                         "spill_loads": sp.get("spill_loads")})
    return regs, rows


def _k4_instances() -> list[tuple]:
    """A legal launch of every instantiation K4's kernels carry (the
    phases launch only some widths): ``check_launch_plan``'s
    arguments."""
    out = [("attention", "sm90", w, (1, 128, 128, w, 1), torch.bfloat16)
           for w in K4.SM90_HEAD_DIMS]
    out += [("attention", "sm90_tf32", K4.sm90_tf32_plan(w),
             (1, 128, 128, w, 1), torch.float32) for w in K4.TF32_HEAD_DIMS]
    out += [("attention", "fma", K4.padded_head_dim(hd), (1, 128, 128, hd, 1),
             dt) for hd in K4.HEAD_DIMS + (512,) for dt in DTYPES]
    return out


def phase_plan_audit(card: str, libs, log: LaunchLog) -> dict:
    """The ``sm90`` profile on the card: its facts against the
    constants the plans are sized by; each built kernel's registers and
    local memory (spills); ``audit_graph(target="sm90")`` over VGG16/224
    and ResNet-20/32, batches 1-8, training, f32 and bf16, every entry
    legal with the real register counts; every K1 and K2 launch the
    serving, training and traced phases made the plan its shape-only
    core picks and an audited entry's, and every K3 and K4 launch of
    the matmul and attention phases legal; the control: a K1 3xTF32
    plan one weight stage past the fit, flagged ``sm90.smem`` and over
    the device's opt-in limit.  Runs no kernel."""
    t0 = time.perf_counter()
    facts = card_facts()
    emit({"phase": "plan_audit", "card": card,
          "device": {n: v for n, (v, _) in facts.items()},
          "read_by": {n: how for n, (_, how) in facts.items()}})
    for name, want, *_ in CARD_FACTS:
        require(facts[name][0] == want, f"plan_audit: the card's {name} is "
                f"{facts[name][0]}, the plans assume {want}")
    regs, usage = _registers(libs)
    spills = [u for u in usage if u["LOCAL"] > 0 or u["spill_stores"]]
    emit({"phase": "plan_audit", "registers": usage, "card": card})
    for u in spills:
        print(f"plan_audit: spill warning: {u['source']} {u['function']} "
              f"LOCAL {u['LOCAL']} B, stack {u['STACK']} B, spill stores "
              f"{u['spill_stores']} B at REG {u['REG']}", flush=True)
    checked = set()         # (source, function) of every launch checked

    def check(launch, what: str) -> None:
        diags = PC.errors(PC.check_launch_plan(*launch, regs=regs))
        require(not diags, f"plan_audit: {what}: {diags}")
        checked.update((f.source, f.function)
                       for f in PC.launch_facts(*launch))

    shapes = {"convs": [{"w": torch.empty((3, 3, ci, co), device="meta")}
                        for _, ci, co, *_ in vgg_layer_dims()]}
    nets = {"vgg": (vgg_graph(shapes), 224), "resnet": (resnet_graph(), 32)}
    audited = {"conv_lb": set(), "wgrad_lb": set()}
    for net, (graph, size) in nets.items():
        for dtype in DTYPES:
            n_plans = n_legal = 0
            by_route = collections.Counter()
            for batch in AUDIT_BATCHES:
                audit = PC.audit_graph(graph, size, size, batch=batch,
                                       training=True, target="sm90",
                                       dtype=dtype, regs=regs)
                require(audit.n_legal == audit.n_plans
                        and audit.traffic_mismatches == 0
                        and audit.bound_mismatches == 0,
                        f"plan_audit: {net} {dtype} batch {batch}:\n"
                        f"{audit.report()}")
                n_plans += audit.n_plans
                n_legal += audit.n_legal
                for e in audit.entries:
                    by_route[e.route] += 1
                    kind = "wgrad_lb" if e.name.endswith("/wgrad") \
                        else "conv_lb"
                    audited[kind].add((e.route, e.launch))
                for layer, handle in graph_plan_handles(
                        graph, size, size, batch=batch, training=True):
                    for launch in PC.sm90_launches(
                            layer, handle, batch=batch,
                            dtype=dtype).values():
                        if launch[0] is not None:
                            check(launch, f"{net} {layer.name}")
            emit({"phase": "plan_audit", "net": net, "dtype": str(dtype),
                  "batches": list(AUDIT_BATCHES), "training": True,
                  "n_plans": n_plans, "n_legal": n_legal,
                  "entries_by_route": dict(by_route)})

    # every K1 and K2 launch of the serving, training and traced phases
    matched = collections.Counter()
    for key, entry in log.k1.items():
        if key[0] == "dgrad":
            _, gyk, wk, stride, padding, dilation, h, wd = key
            if entry.plan is None:      # composed: its conv_lb launch
                continue                # is a key of its own
            dtype, aligned = _dtype_of(gyk, wk)
            plan = K.dgrad_plan(dtype, tuple(gyk[0]), tuple(wk[0]), stride,
                                padding, dilation, h, wd, aligned)
            launch = ("conv_lb_dgrad", "sm90_tf32", plan,
                      (tuple(gyk[0]), tuple(wk[0]), stride, padding,
                       dilation, h, wd), dtype)
        else:
            xk, wk, bk, rk, stride, padding, dilation, lhs, _, pool = key
            dtype, aligned = _dtype_of(xk, wk, bk, rk)
            conv = (tuple(xk[0]), tuple(wk[0]), stride, padding, dilation,
                    lhs, pool)
            rt, plan = K.launch_plan(dtype, *conv, aligned)
            launch = ("conv_lb", rt, plan, conv, dtype)
        require((launch[1], launch[2]) == (entry.route, entry.plan),
                f"plan_audit: K1 launched {entry.route} {entry.plan} where "
                f"its core picks {launch[1]} {launch[2]} ({key})")
        require((entry.route, entry.plan) in audited["conv_lb"],
                f"plan_audit: K1 launch {entry.route} {entry.plan} is no "
                f"audited entry's ({key})")
        check(launch, f"K1 launch {key}")
        matched[f"conv_lb:{entry.route}"] += 1
    for key, entry in log.k2.items():
        xk, dyk, geom = key
        dtype, aligned = _dtype_of(xk, dyk)
        rt, plan = W.launch_plan(dtype, tuple(xk[0]), dyk[0][-1], geom,
                                 aligned)
        require((rt, plan) == (entry.route, entry.plan),
                f"plan_audit: K2 launched {entry.route} where its core "
                f"picks {rt} ({key})")
        require((rt, plan) in audited["wgrad_lb"],
                f"plan_audit: K2 launch {rt} {plan} is no audited entry's "
                f"({key})")
        check(("wgrad_lb", rt, plan, (tuple(xk[0]), tuple(dyk[0]), geom),
               dtype), f"K2 launch {key}")
        matched[f"wgrad_lb:{rt}"] += 1
    require(matched and log.k2, "plan_audit: no K1 or K2 launch recorded")
    # every K3 and K4 launch of the matmul and attention phases
    dense = collections.Counter()
    for launch in sorted(log.dense, key=str):
        check(launch, f"{launch[0]} {launch[1]} at {launch[3]}")
        dense[f"{launch[0]}:{launch[1]}"] += 1
    require(dense, "plan_audit: no K3 or K4 launch recorded")
    # sm90.regs held with every built kernel's registers: K4's widths
    # the phases do not launch are checked at a legal shape
    for launch in _k4_instances():
        check(launch, f"attention {launch[1]} at {launch[3]}")
    unchecked = sorted((src, fn) for src, fns in regs.items() for fn in fns
                       if not any(s == src and f in fn for s, f in checked))
    require(not unchecked, f"plan_audit: no checked launch of {unchecked}")
    # the control: one weight stage past the fit
    conv = ((8, 56, 56, 128), (3, 3, 128, 256), (1, 1), (1, 1), (1, 1),
            (1, 1), 1)
    rt, plan = K.launch_plan(torch.float32, *conv)
    over = K.tf32_overfull(plan, 3, 3)
    rules = {d.rule for d in PC.errors(PC.check_launch_plan(
        "conv_lb", rt, over, conv, torch.float32, regs=regs))}
    require(rt == "sm90_tf32" and rules == {"sm90.smem"}
            and over.smem_bytes > facts["SMEM_PER_BLOCK"][0],
            f"plan_audit: control {over.smem_bytes} B flagged {rules}")
    seconds = time.perf_counter() - t0
    out = {"phase": "plan_audit", "launch_geometries": dict(matched),
           "k1_k2_launches_all_audited": True,
           "k3_k4_launch_plans": dict(dense),
           "kernels_checked_with_registers": sum(map(len, regs.values())),
           "spills": [{k: u[k] for k in ("source", "function", "LOCAL",
                                         "STACK", "spill_stores", "REG")}
                      for u in spills],
           "control": {"route": rt, "tile": list(plan.tile),
                       "smem_bytes": over.smem_bytes,
                       "device_optin": facts["SMEM_PER_BLOCK"][0],
                       "flagged": sorted(rules)},
           "seconds": seconds, "card": card}
    emit(out)
    require(seconds < 10, f"plan_audit took {seconds} s")
    return out


def _library_conv2d_input(*args, **kw) -> torch.Tensor:
    """cuDNN's data gradient, timed beside K1's (``library_ms``): the
    library call of a measurement, on no gradient path."""
    return torch.nn.grad.conv2d_input(*args, **kw)


def _library_conv2d_weight(*args, **kw) -> torch.Tensor:
    """cuDNN's weight gradient, timed beside K2's (``library_ms``): the
    library call of a measurement, on no gradient path."""
    return torch.nn.grad.conv2d_weight(*args, **kw)


def phase_layers_bwd(card: str) -> tuple[list[dict], list[dict]]:
    """dgrad (K1) and wgrad (K2) per VGG16/224 layer at batch 8, f32
    and bf16 (the same words rounded once; K2's dW is f32 in both),
    each timed beside its bound and cuDNN's in the same type; each
    wgrad row with its route (required: conv1_1 ``sm90_im2col``, the
    12 after it ``sm90`` in bf16 and ``sm90_tf32`` in f32), its plan,
    the host's time to enqueue one call, the FMA kernel's time, error
    (gated) and bound on the same inputs through its own launcher, the
    route's tensor-core bound (f32: 3xTF32), and at conv1_1 the staging
    kernel's time."""
    batch = 8
    gen = torch.Generator().manual_seed(SEED + 2)
    params = init_vgg(gen, device="cuda")
    graph = vgg_graph(params)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    dgrad_rows, wgrad_rows = [], []
    for i, (st, p) in enumerate(zip(graph_stages(graph, 224, 224),
                                    params["convs"])):
        node = st.node
        ci, co = node.ci, node.co
        x32 = _randn(gen, batch, st.h, st.w, ci)
        gy32 = _randn(gen, batch, st.ho, st.wo, co)
        flops = 2.0 * batch * st.ho * st.wo * co * ci * 9
        for dtype in DTYPES:
            x, gy, w = (t.to(dtype) for t in (x32, gy32, p["w"]))
            elt = x.element_size()
            t_ops = flops / PEAK[dtype]
            cl = torch.channels_last
            x_nchw = x.permute(0, 3, 1, 2).contiguous(memory_format=cl)
            gy_nchw = gy.permute(0, 3, 1, 2).contiguous(memory_format=cl)
            w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=cl)
            base = {"model": "vgg16", "layer": node.name, "batch": batch,
                    "dtype": str(dtype), "in": [st.h, st.w, ci], "co": co,
                    "flops": flops, "peak_flops": PEAK[dtype],
                    "card": card}
            if i > 0:      # conv1_1's dgrad is never needed
                wf = flip_w(w)
                kw = dict(stride=(1, 1), padding=(1, 1))
                route, tile = conv_route(gy, wf, padding=1)
                want = "sm90" if dtype == torch.bfloat16 else "sm90_tf32"
                require(route == want, f"dgrad {node.name} {dtype}: on "
                                       f"{route}, want {want}")
                before = dict(K.conv_lb.launches_by_route)
                out = K.conv_lb(gy, wf, **kw)
                require(K.conv_lb.launches_by_route[route]
                        == before[route] + 1,
                        f"dgrad {node.name} {dtype}: not on route {route}")
                ref = conv2d_ref(gy, wf, **kw)
                err, rel = rel_err(out.float(), ref.float())
                if dtype == torch.float32:
                    gate = {"tol": TOL}
                    require(rel <= TOL, f"dgrad {node.name}: kernel vs "
                                        f"plain {rel}")
                else:
                    gate = within(out, ref, dtype)
                    require(gate["worst_over_tol"] <= 1.0,
                            f"dgrad {node.name} {dtype}: {gate}")
                    del gate["max_abs_err"]
                n_bytes = float(elt * (gy.numel() + wf.numel()
                                       + out.numel()))
                t_bytes = n_bytes / HBM_BYTES_PER_S
                t_route = ops_s(flops, dtype, route)
                fma = ({} if dtype == torch.bfloat16 else
                       dict(fma_fields(gy, wf, None, 1, False, ref, flush),
                            **fma_bound(flops, t_bytes)))
                row = dict(base, phase="layers_bwd", op="dgrad",
                           ms=_time_ms(lambda: K.conv_lb(gy, wf, **kw),
                                       flush),
                           plain_ms=_time_ms(
                               lambda: conv2d_ref(gy, wf, **kw), flush),
                           library_ms=_time_ms(
                               lambda: _library_conv2d_input(
                                   x_nchw.shape, w_oihw, gy_nchw,
                                   padding=1), flush),
                           bound_ms=max(t_route, t_bytes) * 1e3,
                           bound_by="operations" if t_route >= t_bytes
                           else "bytes", bytes=n_bytes,
                           max_abs_err=err, max_abs_err_over_max_ref=rel,
                           **gate, route=route, tile=tile,
                           host_us=_host_us(lambda: K.conv_lb(gy, wf, **kw)),
                           **fma)
                emit(row)
                dgrad_rows.append(row)
            geom = W.WgradGeometry(hk=3, wk=3, stride=(1, 1),
                                   padding=(1, 1))
            dw, rt, plan = wgrad_launch(x, gy, geom,
                                        f"wgrad {node.name} {dtype}")
            # conv1_1 (Ci = 3) through the im2col plane; the 12 after it
            # on the tensor cores of their type
            want_rt = ("sm90_im2col" if i == 0 else "sm90"
                       if dtype == torch.bfloat16 else "sm90_tf32")
            require(rt == want_rt, f"wgrad {node.name} {dtype}: on {rt}, "
                                   f"want {want_rt}")
            dw_ref = wgrad_ref(x, gy, 3, 3, padding=1)
            err, rel = rel_err(dw, dw_ref)
            require(rel <= WGRAD_TOL, f"wgrad {node.name} {dtype}: kernel "
                                      f"vs plain {rel}")
            fma_plan = W.wgrad_split(9 * ci, co, batch * st.ho * st.wo)
            fma_abs, fma_err = rel_err(W._fma(x, gy, geom, fma_plan),
                                       dw_ref)
            require(fma_err <= WGRAD_TOL, f"wgrad {node.name} {dtype}: FMA "
                                          f"kernel vs plain {fma_err}")

            def library():
                return _library_conv2d_weight(
                    x_nchw, w_oihw.shape, gy_nchw, padding=1)

            # x and dy read in their type, dW written in f32; on the
            # tensor cores f32 takes three TF32 products a multiply-add
            # (bound_ms: every row here is on the tensor cores);
            # fma_bound_ms is the FMA kernel's
            n_bytes = float(elt * (x.numel() + gy.numel())
                            + 4 * dw.numel())
            t_bytes = n_bytes / HBM_BYTES_PER_S
            t_tc = (flops / PEAK_BF16_FLOPS if dtype == torch.bfloat16
                    else 3 * flops / PEAK_TF32_FLOPS)
            stage = phase_stage(x, geom, flush) if i == 0 else {}
            row = dict(base, phase="layers_bwd", op="wgrad",
                       ms=_time_ms(lambda: W.wgrad_lb(x, gy, geom), flush),
                       plain_ms=_time_ms(
                           lambda: wgrad_ref(x, gy, 3, 3, padding=1),
                           flush),
                       library_ms=_time_ms(library, flush),
                       bound_ms=max(t_tc, t_bytes) * 1e3,
                       bound_by="operations" if t_tc >= t_bytes
                       else "bytes",
                       bytes=n_bytes, max_abs_err=err,
                       max_abs_err_over_max_ref=rel, tol=WGRAD_TOL,
                       route=rt, plan=plan,
                       host_us=_host_us(lambda: W.wgrad_lb(x, gy, geom)),
                       library_host_us=_host_us(library),
                       fma_ms=_time_ms(lambda: W._fma(x, gy, geom,
                                                      fma_plan), flush),
                       fma_err=fma_err, fma_max_abs_err=fma_abs,
                       fma_plan=list(fma_plan),
                       fma_bound_ms=max(t_ops, t_bytes) * 1e3,
                       fma_bound_by="operations" if t_ops >= t_bytes
                       else "bytes", **stage)
            emit(row)
            wgrad_rows.append(row)
    return dgrad_rows, wgrad_rows


def phase_stage(x: torch.Tensor, geom, flush: torch.Tensor) -> dict:
    """The im2col staging kernel alone on conv1_1's input: its plane
    against the plain version's (a copy: equal bits), its time beside its
    bound (x read once, the plane written once) and the plain
    version's."""
    before = I.im2col_plane.stage_launches
    plane = I.im2col_plane(x, geom.hk, geom.wk, geom.padding)
    require(I.im2col_plane.stage_launches == before + 1, "im2col: no launch")
    cp = plane.shape[-1]
    plain = im2col_ref(x, geom.hk, geom.wk, padding=geom.padding,
                       channels=cp)
    err = (plane.float() - plain.float()).abs().max().item()
    require(err == 0.0, f"im2col {x.dtype}: plane vs plain {err}")
    n_bytes = float(x.element_size() * (x.numel() + plane.numel()))
    def stage():
        return I.im2col_plane(x, geom.hk, geom.wk, geom.padding)

    return {"stage_ms": _time_ms(stage, flush),
            "stage_plain_ms": _time_ms(
                lambda: im2col_ref(x, geom.hk, geom.wk,
                                   padding=geom.padding, channels=cp),
                flush),
            "stage_bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "stage_bytes": n_bytes, "stage_max_abs_err": err,
            "stage_host_us": _host_us(stage)}


def phase_layers_bwd_resnet(card: str) -> list[dict]:
    """K2 at the inputs its main path gives it: ResNet-20/32's four
    strided wgrads at batch 8 (the two stride-2 3x3 convs and the two
    1x1/2 projections), f32 (the training step's type) on route
    ``sm90_tf32`` and bf16 on ``fma`` (required), held to ``WGRAD_TOL``
    and timed beside their bound and cuDNN's ``conv2d_weight`` in the
    same type (TF32 off): ``ms`` (one call, L2 flushed: a call shorter
    than its enqueue is charged the enqueue), ``device_ms`` (the
    kernels' own time, back to back), ``host_us``; the f32 rows also the
    FMA kernel's time, error (gated) and bound on the same inputs
    through its own launcher."""
    batch = 8
    gen = torch.Generator().manual_seed(SEED + 6)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    rows = []
    for st in graph_stages(resnet_graph(), 32, 32):
        node = st.node
        if node.stride == 1:
            continue
        ci, co, k = node.ci, node.co, node.hk
        x32 = _randn(gen, batch, st.h, st.w, ci)
        gy32 = _randn(gen, batch, st.ho, st.wo, co)
        geom = W.WgradGeometry(hk=k, wk=k, stride=(node.stride,) * 2,
                               padding=(node.pad,) * 2)
        flops = 2.0 * batch * st.ho * st.wo * co * ci * k * k
        for dtype in DTYPES:
            x, gy = x32.to(dtype), gy32.to(dtype)
            dw, rt, plan = wgrad_launch(x, gy, geom,
                                        f"resnet wgrad {node.name} {dtype}")
            want = "fma" if dtype == torch.bfloat16 else "sm90_tf32"
            require(rt == want, f"resnet wgrad {node.name} {dtype}: on {rt}, "
                                f"want {want}")
            kw = dict(stride=node.stride, padding=node.pad)
            dw_ref = wgrad_ref(x, gy, k, k, **kw)
            err, rel = rel_err(dw, dw_ref)
            require(rel <= WGRAD_TOL, f"resnet wgrad {node.name} {dtype}: "
                                      f"kernel vs plain {rel}")
            cl = torch.channels_last
            x_nchw = x.permute(0, 3, 1, 2).contiguous(memory_format=cl)
            gy_nchw = gy.permute(0, 3, 1, 2).contiguous(memory_format=cl)
            w_shape = (co, ci, k, k)

            def library():
                return _library_conv2d_weight(x_nchw, w_shape, gy_nchw, **kw)

            def kernel():
                return W.wgrad_lb(x, gy, geom)

            n_bytes = float(x.element_size() * (x.numel() + gy.numel())
                            + 4 * dw.numel())
            t_ops = ops_s(flops, dtype, rt)
            t_bytes = n_bytes / HBM_BYTES_PER_S
            row = {"phase": "layers_bwd_resnet", "model": "resnet20",
                   "layer": node.name, "op": "wgrad", "dtype": str(dtype),
                   "batch": batch, "in": [st.h, st.w, ci], "co": co,
                   "k": k, "stride": node.stride, "route": rt,
                   "plan": plan,
                   "ms": _time_ms(kernel, flush),
                   "device_ms": _device_ms(kernel),
                   "plain_ms": _time_ms(lambda: wgrad_ref(x, gy, k, k, **kw),
                                        flush),
                   "library_ms": _time_ms(library, flush),
                   "library_device_ms": _device_ms(library),
                   "bound_ms": max(t_ops, t_bytes) * 1e3,
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "flops": flops, "bytes": n_bytes,
                   "peak_flops": PEAK[dtype], "max_abs_err": err,
                   "max_abs_err_over_max_ref": rel, "tol": WGRAD_TOL,
                   "host_us": _host_us(kernel),
                   "library_host_us": _host_us(library), "card": card}
            if dtype == torch.float32:
                fma_plan = W.wgrad_split(k * k * ci, co,
                                         batch * st.ho * st.wo)

                def fma():
                    return W._fma(x, gy, geom, fma_plan)

                fma_abs, fma_err = rel_err(fma(), dw_ref)
                require(fma_err <= WGRAD_TOL, f"resnet wgrad {node.name}: "
                        f"FMA kernel vs plain {fma_err}")
                row.update(fma_ms=_time_ms(fma, flush),
                           fma_device_ms=_device_ms(fma), fma_err=fma_err,
                           fma_max_abs_err=fma_abs,
                           fma_plan=list(fma_plan),
                           **fma_bound(flops, t_bytes))
            emit(row)
            rows.append(row)
    require(len(rows) == 8, f"layers_bwd_resnet: {len(rows)} rows, want "
                            f"4 layers x 2 types")
    return rows


def _gate(out, ref, dtype) -> dict:
    """K1's gate: f32 within ``TOL`` of max |plain|, bf16 within the bf16
    card gate; required."""
    if dtype == torch.float32:
        err, rel = rel_err(out, ref)
        return {"max_abs_err": err, "max_abs_err_over_max_ref": rel,
                "tol": TOL, "ok": rel <= TOL}
    gate = within(out, ref, dtype)
    return dict(gate, ok=gate["worst_over_tol"] <= 1.0)


def phase_layers_resnet(card: str) -> list[dict]:
    """K1 at the inputs its main path gives it: ResNet-20/32's four
    strided convs at batch 8 (the two stride-2 3x3 convs and the two
    1x1/2 projections), forward (bias, and ReLU where the layer has one)
    and dgrad as ``dgrad_lb`` runs it (``conv_lb_dgrad``: f32 one launch
    by output phases, route ``sm90_tf32``, required; bf16 dy with one
    zero row and column appended, lhs-dilated by the stride against the
    flipped weights on ``fma``, then cropped), f32 forward on
    ``sm90_tf32`` and bf16 on ``fma`` (required), held to ``TOL`` (f32)
    or the bf16 card gate, and timed beside their bound, cuDNN in the
    same type (``F.conv2d``, ``conv2d_input``; TF32 off): ``ms`` (one
    call, L2 flushed, charged at least its enqueue), ``device_ms`` (the
    kernels' own time, back to back) and ``host_us`` (the enqueue), each
    also for cuDNN; the f32 rows also the FMA kernel's time and error
    (gated) on the same inputs through its own launcher (the dgrad: the
    lhs-dilated conv on the padded dy and flipped weights) and its
    bound."""
    batch = 8
    gen = torch.Generator().manual_seed(SEED + 8)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    rows = []
    for st in graph_stages(resnet_graph(), 32, 32):
        node = st.node
        if node.stride == 1:
            continue
        ci, co, k, s, pad = node.ci, node.co, node.hk, node.stride, node.pad
        x32 = _randn(gen, batch, st.h, st.w, ci)
        w32 = _randn(gen, k, k, ci, co, scale=(k * k * ci) ** -0.5)
        b32 = _randn(gen, co, scale=0.1)
        gy32 = _randn(gen, batch, st.ho, st.wo, co)
        flops = 2.0 * batch * st.ho * st.wo * co * ci * k * k
        for dtype in DTYPES:
            x, w, b, gy = (t.to(dtype) for t in (x32, w32, b32, gy32))
            cl = torch.channels_last
            x_nchw = x.permute(0, 3, 1, 2).contiguous(memory_format=cl)
            w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=cl)
            gy_nchw = gy.permute(0, 3, 1, 2).contiguous(memory_format=cl)
            want = "fma" if dtype == torch.bfloat16 else "sm90_tf32"
            fwd_kw = dict(stride=(s, s), padding=(pad, pad), relu=node.relu)
            dgrad_kw = dict(stride=(s, s), padding=(pad, pad), h=st.h,
                            wd=st.w)
            # the FMA kernel's own inputs: the forward's, and the
            # lhs-dilated conv of the dgrad's composed form
            gyp = F.pad(gy, (0, 0, 0, 1, 0, 1))
            wf = flip_w(w)
            one = (1, 1)
            fma_args = {
                "forward": (x, w, b, (s, s), (pad, pad), one, node.relu,
                            st.ho, st.wo),
                "dgrad": (gyp, wf, None, one, (k - 1 - pad,) * 2, (s, s),
                          False, *K._out_plane(
                              gyp.shape[1], gyp.shape[2], k, k, one,
                              (k - 1 - pad,) * 2, one, (s, s)))}
            calls = {
                "forward": (
                    lambda: K.conv_lb(x, w, b, **fwd_kw),
                    lambda: conv2d_ref(x, w, b, **fwd_kw),
                    K.route(x, w, (s, s), bias=b, padding=(pad, pad)),
                    lambda: F.conv2d(x_nchw, w_oihw, b, stride=s,
                                     padding=pad),
                    x.numel() + w.numel() + b.numel()
                    + batch * st.ho * st.wo * co),
                "dgrad": (
                    lambda: K.conv_lb_dgrad(gy, w, **dgrad_kw),
                    lambda: _dgrad_plain(gy, w, x.shape, s, pad),
                    K.dgrad_route(gy, w, (s, s), st.h, st.w, (pad, pad)),
                    lambda: torch.nn.grad.conv2d_input(
                        x_nchw.shape, w_oihw, gy_nchw, stride=s,
                        padding=pad),
                    gy.numel() + w.numel() + x.numel())}
            for op, (kernel, plain, rt, library, words) in calls.items():
                # the dgrad's bf16 route composes an lhs-dilated conv on
                # conv_lb's route for it
                asked = ("composed" if op == "dgrad"
                         and dtype == torch.bfloat16 else want)
                require(rt == asked, f"resnet {op} {node.name} {dtype}: "
                                     f"on {rt}, want {asked}")
                rt = want
                before = K.conv_lb.launches_by_route[rt]
                out = kernel()
                launched = K.conv_lb.launches_by_route[rt] - before
                require(launched == 1, f"resnet {op} {node.name} {dtype}: "
                                       f"{launched} launches on {rt}")
                ref = plain()
                gate = _gate(out.float(), ref.float(), dtype)
                require(gate.pop("ok"), f"resnet {op} {node.name} {dtype}: "
                                        f"kernel vs plain {gate}")
                n_bytes = float(x.element_size() * words)
                t_ops = ops_s(flops, dtype, rt)
                t_bytes = n_bytes / HBM_BYTES_PER_S
                row = {"phase": "layers_resnet", "model": "resnet20",
                       "layer": node.name, "op": op, "dtype": str(dtype),
                       "batch": batch, "in": [st.h, st.w, ci], "co": co,
                       "k": k, "stride": s, "route": rt,
                       "ms": _time_ms(kernel, flush),
                       "device_ms": _device_ms(kernel),
                       "plain_ms": _time_ms(plain, flush),
                       "library_ms": _time_ms(library, flush),
                       "library_device_ms": _device_ms(library),
                       "bound_ms": max(t_ops, t_bytes) * 1e3,
                       "bound_by": "operations" if t_ops >= t_bytes
                       else "bytes", "flops": flops, "bytes": n_bytes,
                       "peak_flops": PEAK[dtype], **gate,
                       "host_us": _host_us(kernel),
                       "library_host_us": _host_us(library), "card": card}
                if dtype == torch.float32:
                    fx, fw, fb, fs, fp, fl, frelu, fho, fwo = fma_args[op]
                    plan = K.cta_plan(batch, fho, fwo, fw.shape[-1], 1, k,
                                      k, fs, one, 4)

                    def fma():
                        return K._fma(fx, fw, fb, None, fho, fwo, fs, fp,
                                      one, fl, frelu, 1, plan)

                    fout = fma()
                    if op == "dgrad":
                        fout = fout[:, :st.h, :st.w]
                    fma_abs, fma_err = rel_err(fout, ref)
                    require(fma_err <= TOL, f"resnet {op} {node.name}: FMA "
                                            f"kernel vs plain {fma_err}")
                    row.update(fma_ms=_time_ms(fma, flush),
                               fma_device_ms=_device_ms(fma),
                               fma_err=fma_err, fma_max_abs_err=fma_abs,
                               fma_tile=list(plan),
                               **fma_bound(flops, t_bytes))
                emit(row)
                rows.append(row)
    require(len(rows) == 16, f"layers_resnet: {len(rows)} rows, want 4 "
                             f"layers x forward and dgrad x 2 types")
    return rows


def _dgrad_plain(gy, w, x_shape, s: int, pad: int) -> torch.Tensor:
    """dx of the plain forward conv, by its autograd."""
    xg = torch.zeros(x_shape, dtype=gy.dtype, device=gy.device,
                     requires_grad=True)
    with torch.enable_grad():
        (dx,) = torch.autograd.grad(conv2d_ref(xg, w, stride=s,
                                               padding=pad), xg, gy)
    return dx


def _sums(rows: list[dict]) -> dict:
    ops_ms = sum(r["bound_ms"] for r in rows
                 if r["bound_by"] == "operations")
    bound = sum(r["bound_ms"] for r in rows)
    return {"ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": bound,
            "bound_by": "operations" if 2 * ops_ms >= bound else "bytes",
            "library_ms": sum(r["library_ms"] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


def _by_dtype(rows: list[dict]) -> dict:
    return {str(d): _sums([r for r in rows if r["dtype"] == str(d)])
            for d in DTYPES}


def _of(rows: list[dict], dtype: torch.dtype) -> list[dict]:
    return [r for r in rows if r["dtype"] == str(dtype)]


def _fma_of(rows: list[dict]) -> list[dict]:
    """wgrad rows as the FMA kernel timed them on the same inputs, beside
    its own bound."""
    return [dict(r, ms=r["fma_ms"], max_abs_err=r["fma_max_abs_err"],
                 bound_ms=r["fma_bound_ms"], bound_by=r["fma_bound_by"])
            for r in rows]


def _stage_of(row: dict) -> dict:
    """conv1_1's staging-kernel fields as a kernel's sums."""
    return {"ms": row["stage_ms"], "plain_ms": row["stage_plain_ms"],
            "bound_ms": row["stage_bound_ms"], "bound_by": "bytes",
            "library_ms": None, "max_abs_err": row["stage_max_abs_err"],
            "host_us": row["stage_host_us"]}


def counter_of(kernel: dict) -> str:
    """The launch counter a kernels-line entry reads."""
    return next(c for c in ("conv_lb", "wgrad", "matmul", "attention")
                if kernel["name"].startswith(c))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = phase_device()
    libs = phase_build()
    dry_procs = start_dryrun()
    try:
        return _main(card, libs, dry_procs, t0)
    finally:
        stop(dry_procs)


def _main(card: str, libs: list, dry_procs: list, t0: float) -> int:
    k1_before = dict(K.conv_lb.launches_by_route)
    k2_before = dict(W.wgrad_lb.launches_by_route)
    tf32_controls = phase_check()
    strided_controls = check_strided_controls(
        torch.Generator().manual_seed(SEED + 9))
    phase_check_bwd()
    # the FMA kernels' launches off the main paths: the checks' bf16
    # strides, lhs dilation and what TMA cannot describe
    k1_check_fma = K.conv_lb.launches_by_route["fma"] - k1_before["fma"]
    k2_check_fma = W.wgrad_lb.launches_by_route["fma"] - k2_before["fma"]
    bwd_bf16 = check_bwd_bf16()
    check_matmul_by_route = phase_check_matmul()
    check_attn_by_route = phase_check_attention()
    vgg_run, bf16_run = {}, {}
    log = LaunchLog()
    with log.conv():
        vgg_f32 = phase_serve("vgg", keep=vgg_run)
        vgg_bf16 = phase_serve("vgg", torch.bfloat16, keep=bf16_run)
        resnet_f32 = phase_serve("resnet")
        serve_loop = phase_serve_loop(card)
        train_vgg = phase_train("vgg")
        train_resnet = phase_train("resnet")
        phase_trace(card, vgg_run, bf16_run, train_vgg)
    del vgg_run, bf16_run
    with log.matmul_attention():
        matmul_launches, matmul_all = phase_matmul(card)
        attn_launches, attn_rows = phase_attention(card)
    lm = phase_lm_serve(card)
    lm_flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    moe = phase_lm_serve_moe(card, lm_flush)
    ssm = phase_lm_serve_ssm(card)
    hybrid = phase_lm_serve_hybrid(card)
    encdec = phase_lm_serve_encdec(card, lm_flush)
    dense = phase_lm_serve_dense(card, lm_flush)
    mqa = phase_lm_serve_mqa(card, lm_flush)
    dbrx = phase_lm_serve_dbrx(card, lm_flush)
    vlm = phase_lm_serve_vlm(card, lm_flush)
    del lm_flush
    long_attn = phase_lm_attention_long(card)
    long_dense = phase_lm_long_dense(card)
    long_window = phase_lm_long_window(card)
    train = phase_lm_train(card)
    train_f32 = phase_lm_train_f32(card)
    resilient = phase_lm_train_resilient(card)
    lm_train = {"bf16": _merged(train["bf16"], resilient["bf16"]),
                "f32": train_f32["f32"]}
    train_moe = phase_lm_train_moe(card)
    train_ssm = phase_lm_train_ssm(card)
    train_hybrid = phase_lm_train_hybrid(card)
    new_train = {"lm_train_vlm": phase_lm_train_vlm(card),
                 "lm_train_mqa": phase_lm_train_mqa(card),
                 "lm_train_dbrx": phase_lm_train_dbrx(card),
                 "lm_train_dense": phase_lm_train_dense(card)}
    with one_rank_nccl() as mesh:
        train_mesh = phase_lm_train_mesh(card, mesh, train)
        train_mesh_resilient = phase_lm_train_mesh_resilient(card, mesh,
                                                             resilient)
    lm_train_mesh = {"bf16": _merged(train_mesh["bf16"],
                                     train_mesh_resilient["bf16"])}
    mesh_flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    mesh_attn = phase_mesh_attention(card, mesh_flush)
    del mesh_flush
    lm_mesh = phase_lm_serve_mesh(card)
    mesh_ssm = phase_mesh_ssm(card)
    lm_mesh_ssm = phase_lm_serve_mesh_ssm(card)
    examples = phase_examples(card)
    dryrun = phase_dryrun(card, dry_procs)
    phase_plan_audit(card, libs, log)
    # the sums: the four projections per type, w N-major
    matmul_rows = [r for r in matmul_all if r["layout"] == "n-major"]
    sm90_rows = [r for r in matmul_rows if r["route"] == "sm90"]
    tf32_rows = [r for r in matmul_rows if r["route"] == "sm90_tf32"]
    phase_attention_head_dims(card)
    rows = phase_layers(card)
    dgrad_rows, wgrad_rows = phase_layers_bwd(card)
    resnet_wgrad = phase_layers_bwd_resnet(card)
    resnet_k1 = phase_layers_resnet(card)
    k1_fwd = [r for r in resnet_k1 if r["op"] == "forward"]
    k1_dgrad = [r for r in resnet_k1 if r["op"] == "dgrad"]
    f32 = torch.float32
    strided = {"forward": _of(k1_fwd, f32), "dgrad": _of(k1_dgrad, f32),
               "wgrad": _of(resnet_wgrad, f32)}
    emit({"phase": "k1_k2_strided_targets",
          **{f"{op}_4_{key}": sum(r[key] for r in rows)
             for op, rows in strided.items()
             for key in ("ms", "device_ms", "host_us", "bound_ms",
                         "library_ms", "library_device_ms",
                         "library_host_us", "fma_ms", "fma_device_ms",
                         "fma_bound_ms")},
          "routes": {op: sorted({r["route"] for r in rows})
                     for op, rows in strided.items()},
          "forward_asked_over_library_at_most": 1,
          "control_1xtf32_over_route": strided_controls, "card": card})
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    dgrad = {str(d): {k: v for k, v in _sums(_of(dgrad_rows, d)).items()
                      if k in keys} for d in DTYPES}
    bf16_rows = _of(rows, torch.bfloat16)
    bf16_dgrad = _of(dgrad_rows, torch.bfloat16)
    sm90_fwd = [r for r in bf16_rows if r["route"] == "sm90"]
    sm90_dgrad = [r for r in bf16_dgrad if r["route"] == "sm90"]
    require(len(sm90_fwd) == 12 and len(sm90_dgrad) == 12,
            f"layers: {len(sm90_fwd)} forward and {len(sm90_dgrad)} dgrad "
            f"bf16 layers on sm90, want 12 and 12")
    (plane_fwd,) = [r for r in bf16_rows if r["route"] == "sm90_im2col"]
    f32_rows = _of(rows, torch.float32)
    f32_dgrad = _of(dgrad_rows, torch.float32)
    tf32_fwd = [r for r in f32_rows if r["route"] == "sm90_tf32"]
    tf32_dgrad = [r for r in f32_dgrad if r["route"] == "sm90_tf32"]
    require(len(tf32_fwd) == 12 and len(tf32_dgrad) == 12,
            f"layers: {len(tf32_fwd)} forward and {len(tf32_dgrad)} dgrad "
            f"f32 layers on sm90_tf32, want 12 and 12")
    (plane_f32,) = [r for r in f32_rows if r["route"] == "sm90_im2col"]
    k1_f32, k1_f32_dgrad = _sums(f32_rows), _sums(f32_dgrad)
    emit({"phase": "k1_f32_targets",
          "forward_13_ms": k1_f32["ms"],
          "forward_13_fma_ms": sum(r["fma_ms"] for r in f32_rows),
          "forward_13_library_ms": k1_f32["library_ms"],
          "forward_13_bound_ms": k1_f32["bound_ms"],
          "forward_13_fma_bound_ms": sum(r["fma_bound_ms"] for r in f32_rows),
          "dgrad_12_ms": k1_f32_dgrad["ms"],
          "dgrad_12_fma_ms": sum(r["fma_ms"] for r in f32_dgrad),
          "dgrad_12_library_ms": k1_f32_dgrad["library_ms"],
          "dgrad_12_bound_ms": k1_f32_dgrad["bound_ms"],
          "dgrad_12_fma_bound_ms": sum(r["fma_bound_ms"] for r in f32_dgrad),
          "forward_over_bound": k1_f32["ms"] / k1_f32["bound_ms"],
          "dgrad_over_bound": k1_f32_dgrad["ms"] / k1_f32_dgrad["bound_ms"],
          "card": card})
    bf16_wgrad = _of(wgrad_rows, torch.bfloat16)
    f32_wgrad = _of(wgrad_rows, torch.float32)
    sm90_wgrad = [r for r in bf16_wgrad if r["route"] == "sm90"]
    tf32_wgrad = [r for r in f32_wgrad if r["route"] == "sm90_tf32"]
    plane_wgrad = {r["dtype"]: r for r in wgrad_rows
                   if r["route"] == "sm90_im2col"}
    require(len(sm90_wgrad) == 12 and len(tf32_wgrad) == 12
            and len(plane_wgrad) == 2,
            f"layers_bwd: {len(sm90_wgrad)} bf16 wgrad layers on sm90, "
            f"{len(tf32_wgrad)} f32 on sm90_tf32, {len(plane_wgrad)} "
            f"conv1_1 rows on sm90_im2col, want 12, 12 and 2")
    c11 = plane_wgrad[str(torch.bfloat16)]
    tf32_sums = _sums(tf32_wgrad)
    emit({"phase": "k2_targets",
          "conv1_1_bf16_ms": c11["ms"],
          "conv1_1_bf16_library_ms": c11["library_ms"],
          "conv1_1_bf16_over_library": c11["ms"] / c11["library_ms"],
          "conv1_1_bf16_fma_ms": c11["fma_ms"], "conv1_1_asked_at_most": 2,
          "f32_12_ms": tf32_sums["ms"],
          "f32_12_library_ms": tf32_sums["library_ms"],
          "f32_12_over_library": tf32_sums["ms"] / tf32_sums["library_ms"],
          "f32_12_fma_ms": sum(r["fma_ms"] for r in tf32_wgrad),
          "f32_12_fma_bound_ms": sum(r["fma_bound_ms"] for r in tf32_wgrad),
          "f32_12_bound_ms": tf32_sums["bound_ms"],
          "f32_12_asked_at_most": 1, "card": card})
    k3_sums = _sums(tf32_rows)
    emit({"phase": "k1_k3_targets",
          "conv1_1_bf16_ms": plane_fwd["ms"],
          "conv1_1_bf16_fma_ms": plane_fwd["fma_ms"],
          "conv1_1_bf16_library_ms": plane_fwd["library_ms"],
          "conv1_1_bf16_over_library":
          plane_fwd["ms"] / plane_fwd["library_ms"],
          "conv1_1_asked_at_most": 1.2,
          "conv1_1_bf16_host_us": plane_fwd["host_us"],
          "k3_f32_ms": k3_sums["ms"],
          "k3_f32_library_ms": k3_sums["library_ms"],
          "k3_f32_over_library": k3_sums["ms"] / k3_sums["library_ms"],
          "k3_f32_asked_at_most": 1,
          "k3_f32_fma_ms": sum(r["fma_ms"] for r in tf32_rows),
          "k3_f32_bound_ms": k3_sums["bound_ms"],
          "k3_f32_fma_bound_ms": sum(r["fma_bound_ms"] for r in tf32_rows),
          "card": card})
    attn_sums = {rt: _sums([r for r in attn_rows if r["route"] == rt])
                 for rt in ("sm90", "sm90_tf32")}
    tf32_attn = [r for r in attn_rows if r["route"] == "sm90_tf32"]
    emit({"phase": "k4_targets",
          "f32_ms": attn_sums["sm90_tf32"]["ms"],
          "f32_bound_ms": attn_sums["sm90_tf32"]["bound_ms"],
          "f32_fma_bound_ms": sum(r["fma_bound_ms"] for r in tf32_attn),
          "f32_fma_ms": sum(r["fma_ms"] for r in tf32_attn),
          "f32_library_ms": attn_sums["sm90_tf32"]["library_ms"],
          "f32_over_bound": attn_sums["sm90_tf32"]["ms"]
          / attn_sums["sm90_tf32"]["bound_ms"],
          "predicted_ms": [7, 11], "card": card})
    vgg_times = "sums over the 13 VGG16/224 convs at batch 8"
    kernels = [
        dict(_sums(_fma_of(strided["forward"])), name="conv_lb",
             route="cuda", kernel_route="fma", source=SOURCE,
             replaces=REPLACES,
             launches=resnet_f32["fma"], on_main_path=False,
             launches_off_path=k1_check_fma,
             launches_train_resnet=train_resnet["conv_lb_by_route"]["fma"],
             launches_serve_by_route={"vgg_f32": vgg_f32,
                                      "vgg_bf16": vgg_bf16,
                                      "resnet_f32": resnet_f32},
             launches_train_vgg_by_route=train_vgg["conv_lb_by_route"],
             launches_train_resnet_by_route=train_resnet["conv_lb_by_route"],
             launches_bwd_bf16=bwd_bf16["conv_lb"],
             dgrad=_sums(_fma_of(strided["dgrad"])),
             device_ms=sum(r["fma_device_ms"] for r in strided["forward"]),
             dgrad_device_ms=sum(r["fma_device_ms"]
                                 for r in strided["dgrad"]),
             bf16_strided=_sums(_of(k1_fwd, torch.bfloat16)),
             bf16_strided_dgrad=_sums(_of(k1_dgrad, torch.bfloat16)),
             vgg_inputs=_sums(_fma_of(f32_rows)),
             vgg_inputs_dgrad=_sums(_fma_of(f32_dgrad)),
             route_by_dtype=_by_dtype(rows), route_dgrad_by_dtype=dgrad,
             bf16_by_route={
                 rt: {"layers": [r["layer"] for r in bf16_rows
                                 if r["route"] == rt],
                      "forward": _sums([r for r in bf16_rows
                                        if r["route"] == rt]) if any(
                          r["route"] == rt for r in bf16_rows) else None,
                      "dgrad": _sums([r for r in bf16_dgrad
                                      if r["route"] == rt]) if any(
                          r["route"] == rt for r in bf16_dgrad) else None}
                 for rt in K.ROUTES},
             times_are="the FMA kernel through its own launcher on the f32 "
                       "inputs of ResNet-20/32's four strided convs at "
                       "batch 8, which take sm90_tf32 (dgrad: the "
                       "lhs-dilated conv of the composed form, dy padded "
                       "against the flipped weights; bound_ms: f32 at the "
                       "FMA rate; device_ms: back to back); bf16_strided, "
                       "bf16_strided_dgrad: its own route on the bf16 "
                       "inputs (bf16 strides, on no main path); "
                       "vgg_inputs: the FMA kernel through its own "
                       f"launcher on the f32 inputs of the {vgg_times} "
                       "(dgrad: the 12 a step runs); route_by_dtype: every "
                       "VGG layer on the route it takes, f32 and bf16; "
                       "bf16_by_route: split by route; launches: the f32 "
                       "ResNet serving run, which no longer runs this "
                       "kernel (launches_train_resnet: its training run); "
                       "launches_off_path: the check phase's FMA rows "
                       "(bf16 strides, lhs dilation, what TMA cannot "
                       "describe)",
             card=card),
        dict(k1_f32, name="conv_lb_sm90_tf32", route="cuda",
             kernel_route="sm90_tf32", source=CONV_TF32_SOURCE,
             replaces=REPLACES, dtype="f32",
             launches=vgg_f32["sm90_tf32"] + vgg_f32["sm90_im2col"],
             launches_serve_resnet=(resnet_f32["sm90_tf32"]
                                    + resnet_f32["sm90_im2col"]),
             launches_serve_loop=(serve_loop["sm90_tf32"]
                                  + serve_loop["sm90_im2col"]),
             launches_train_vgg=(
                 train_vgg["conv_lb_by_route"]["sm90_tf32"]
                 + train_vgg["conv_lb_by_route"]["sm90_im2col"]),
             launches_train_resnet=(
                 train_resnet["conv_lb_by_route"]["sm90_tf32"]
                 + train_resnet["conv_lb_by_route"]["sm90_im2col"]),
             dgrad=k1_f32_dgrad,
             fma_ms=sum(r["fma_ms"] for r in f32_rows),
             fma_bound_ms=sum(r["fma_bound_ms"] for r in f32_rows),
             dgrad_fma_ms=sum(r["fma_ms"] for r in f32_dgrad),
             dgrad_fma_bound_ms=sum(r["fma_bound_ms"] for r in f32_dgrad),
             host_us=sum(r["host_us"] for r in f32_rows),
             library_host_us=sum(r["library_host_us"] for r in f32_rows),
             conv1_1_plane=_sums([plane_f32]),
             resnet_strided=_sums(strided["forward"]),
             resnet_strided_dgrad=_sums(strided["dgrad"]),
             resnet_strided_device_ms=sum(r["device_ms"]
                                          for r in strided["forward"]),
             resnet_strided_dgrad_device_ms=sum(r["device_ms"]
                                                for r in strided["dgrad"]),
             resnet_strided_host_us=sum(r["host_us"]
                                        for r in strided["forward"]),
             resnet_strided_dgrad_host_us=sum(r["host_us"]
                                              for r in strided["dgrad"]),
             promote=K.TF32_PROMOTE,
             control_1xtf32_over_route=tf32_controls,
             control_strided_1xtf32_over_route=strided_controls,
             times_are=f"f32 {vgg_times} (12 on sm90_tf32, conv1_1 on "
                       f"sm90_im2col: the plane, then this kernel as a 1x1 "
                       f"conv; bound_ms: three TF32 products a multiply-add "
                       f"at 495 TFLOP/s; fma_bound_ms: one at the FMA rate, "
                       f"67; fma_ms: conv_lb.cu on the same inputs); dgrad: "
                       f"the 12 a step runs; resnet_strided(_dgrad): "
                       f"ResNet-20/32's four strided convs at batch 8 (the "
                       f"dgrad one launch by output phases); launches: the "
                       f"f32 VGG serving run (sm90_tf32 and sm90_im2col "
                       f"layers; launches_serve_loop: the serve_loop "
                       f"phase's)",
             card=card),
        dict(_sums([plane_fwd]), name="conv_lb_sm90_im2col", route="cuda",
             kernel_route="sm90_im2col", source=CONV_SM90_SOURCE,
             staging_source=WGRAD_IM2COL_SOURCE, replaces=REPLACES,
             dtype="bf16", launches=vgg_bf16["sm90_im2col"],
             launches_f32=vgg_f32["sm90_im2col"], f32=_sums([plane_f32]),
             launches_serve_loop=serve_loop["sm90_im2col"],
             host_us=plane_fwd["host_us"],
             library_host_us=plane_fwd["library_host_us"],
             stage_ms=plane_fwd["stage_ms"],
             stage_bound_ms=plane_fwd["stage_bound_ms"],
             plane_bound_ms=plane_fwd["plane_bound_ms"],
             fma_ms=plane_fwd["fma_ms"], fma_err=plane_fwd["fma_err"],
             times_are="bf16 VGG16/224 conv1_1 at batch 8 (the plane, then "
                       "the sm90 kernel as a 1x1 conv; bound_ms: x, w, "
                       "bias and out; plane_bound_ms: with the plane "
                       "written and read; stage_ms: the staging launch "
                       "alone; fma_ms: conv_lb.cu on the same inputs); "
                       "f32: the same layer onto conv_lb_sm90_tf32.cu; "
                       "launches: the bf16 serving run (launches_f32: the "
                       "f32 one; launches_serve_loop: the serve_loop "
                       "phase's)",
             card=card),
        dict(_sums(sm90_fwd), name="conv_lb_sm90", route="cuda",
             kernel_route="sm90", source=CONV_SM90_SOURCE,
             replaces=REPLACES, dtype="bf16",
             launches=vgg_bf16["sm90"],
             launches_bwd_bf16=bwd_bf16["conv_lb"],
             dgrad=_sums(sm90_dgrad),
             times_are=f"bf16 sums over the 12 VGG16/224 convs after "
                       f"conv1_1 at batch 8 (dgrad: the same 12 layers' "
                       f"dgrads); launches: the bf16 serving run",
             card=card),
        dict(_sums(_fma_of(strided["wgrad"])), name="wgrad_lb",
             route="cuda", kernel_route="fma", source=WGRAD_SOURCE,
             replaces=WGRAD_REPLACES,
             launches=(train_vgg["wgrad_lb_by_route"]["fma"]
                       + train_resnet["wgrad_lb_by_route"]["fma"]),
             on_main_path=False, launches_off_path=k2_check_fma,
             launches_train_vgg_by_route=train_vgg["wgrad_lb_by_route"],
             launches_train_resnet_by_route=train_resnet[
                 "wgrad_lb_by_route"],
             reduce_launches=train_vgg["wgrad_reduce"],
             device_ms=sum(r["fma_device_ms"] for r in strided["wgrad"]),
             bf16_strided=_sums(_of(resnet_wgrad, torch.bfloat16)),
             vgg_inputs_by_dtype={str(d): _sums(_fma_of(_of(wgrad_rows, d)))
                                  for d in DTYPES},
             route_by_dtype={str(d): _sums(_of(wgrad_rows, d))
                             for d in DTYPES},
             times_are="the FMA kernel through its own launcher on the f32 "
                       "inputs of ResNet-20/32's four strided wgrads at "
                       "batch 8 (the two stride-2 3x3 convs and the two "
                       "1x1/2 projections), which take sm90_tf32 "
                       "(device_ms: back to back); bf16_strided: its own "
                       "route on the bf16 inputs (on no main path); "
                       "vgg_inputs_by_dtype: the FMA kernel through its "
                       f"own launcher on the inputs of every VGG wgrad "
                       f"row ({vgg_times}), which take the tensor-core "
                       "routes (route_by_dtype); launches: the FMA route "
                       "in the VGG and ResNet training runs, none; "
                       "launches_off_path: the backward checks' FMA rows "
                       "(bf16 strides, what no tensor-core route takes)",
             card=card),
        dict(_sums(sm90_wgrad), name="wgrad_lb_sm90", route="cuda",
             kernel_route="sm90", source=WGRAD_SM90_SOURCE,
             replaces=WGRAD_REPLACES, dtype="bf16",
             launches=bwd_bf16["wgrad_lb_by_route"]["sm90"],
             host_us=sum(r["host_us"] for r in sm90_wgrad),
             library_host_us=sum(r["library_host_us"] for r in sm90_wgrad),
             times_are="bf16 sums over the 12 VGG16/224 layers after "
                       "conv1_1 at batch 8 (x and dy bf16, dW f32); "
                       "launches: the bf16 backward",
             card=card),
        dict(tf32_sums, name="wgrad_lb_sm90_tf32", route="cuda",
             kernel_route="sm90_tf32", source=WGRAD_TF32_SOURCE,
             replaces=WGRAD_REPLACES, dtype="f32",
             launches=(train_vgg["wgrad_lb_by_route"]["sm90_tf32"]
                       + train_vgg["wgrad_lb_by_route"]["sm90_im2col"]),
             launches_train_resnet=(
                 train_resnet["wgrad_lb_by_route"]["sm90_tf32"]
                 + train_resnet["wgrad_lb_by_route"]["sm90_im2col"]),
             fma_bound_ms=sum(r["fma_bound_ms"] for r in tf32_wgrad),
             fma_ms=sum(r["fma_ms"] for r in tf32_wgrad),
             host_us=sum(r["host_us"] for r in tf32_wgrad),
             library_host_us=sum(r["library_host_us"] for r in tf32_wgrad),
             conv1_1_plane=_sums([plane_wgrad[str(torch.float32)]]),
             resnet_strided=_sums(strided["wgrad"]),
             resnet_strided_device_ms=sum(r["device_ms"]
                                          for r in strided["wgrad"]),
             resnet_strided_host_us=sum(r["host_us"]
                                        for r in strided["wgrad"]),
             times_are="f32 sums over the 12 VGG16/224 layers after "
                       "conv1_1 at batch 8 (bound_ms: three TF32 products "
                       "a multiply-add at 495 TFLOP/s; fma_bound_ms: one at "
                       "the FMA rate, 67); "
                       "conv1_1_plane: conv1_1's whole route (plane + 1x1 "
                       "on this kernel); resnet_strided: ResNet-20/32's four "
                       "strided wgrads at batch 8; launches: the f32 VGG "
                       "training run (sm90_tf32 and sm90_im2col layers)",
             card=card),
        dict(_stage_of(plane_wgrad[str(torch.float32)]),
             name="wgrad_im2col", route="cuda", kernel_route="sm90_im2col",
             source=WGRAD_IM2COL_SOURCE, replaces=WGRAD_REPLACES,
             launches=train_vgg["wgrad_stage"],
             launches_train_resnet=train_resnet["wgrad_stage"],
             by_dtype={d: _stage_of(r) for d, r in plane_wgrad.items()},
             route_by_dtype={d: _sums([r]) for d, r in plane_wgrad.items()},
             times_are="the staging kernel alone on VGG16/224 conv1_1's "
                       "input at batch 8, f32 (by_dtype: f32 and bf16; "
                       "route_by_dtype: conv1_1's whole wgrad on "
                       "sm90_im2col); no PyTorch call builds this plane in "
                       "this layout; launches: the f32 VGG training run",
             card=card),
        dict(_sums(_fma_of(tf32_rows)), name="matmul_lb", route="cuda",
             kernel_route="fma", source=MATMUL_SOURCE,
             replaces=MATMUL_REPLACES,
             launches=matmul_launches["by_route"]["fma"],
             on_main_path=False,
             launches_off_path=check_matmul_by_route["fma"],
             launches_check_matmul_by_route=check_matmul_by_route,
             launches_matmul_by_route=matmul_launches["by_route"],
             copies=matmul_launches["copies"],
             by_dtype=_by_dtype(matmul_rows),
             times_are="the FMA kernel through its own launcher on "
                       "phi3-medium-14b's f32 wq, wk, FFN up and FFN down "
                       "at 4096 tokens (which take sm90_tf32); by_dtype: "
                       "matmul_lb as it routes them, f32 and bf16; "
                       "launches: the matmul path, which no longer runs "
                       "this kernel (every projection takes a tensor-core "
                       "route); launches_check_matmul_by_route: the "
                       "reference's sweep through matmul_lb, whose shapes "
                       "TMA cannot describe run here",
             card=card),
        dict(k3_sums, name="matmul_lb_sm90_tf32", route="cuda",
             kernel_route="sm90_tf32", source=MATMUL_TF32_SOURCE,
             replaces=MATMUL_REPLACES, dtype="f32",
             launches=matmul_launches["by_route"]["sm90_tf32"],
             launches_check_matmul=check_matmul_by_route["sm90_tf32"],
             fma_bound_ms=sum(r["fma_bound_ms"] for r in tf32_rows),
             fma_ms=sum(r["fma_ms"] for r in tf32_rows),
             promote=K3.TF32_PROMOTE,
             control_1xtf32_over_route={
                 r["projection"]: r["control_1xtf32"]["over_route"]
                 for r in tf32_rows if "control_1xtf32" in r},
             k_major_wq_ms=[r["ms"] for r in matmul_all
                            if r["layout"] == "k-major"
                            and r["route"] == "sm90_tf32"][0],
             times_are="sums over phi3-medium-14b's wq, wk, FFN up and "
                       "FFN down at 4096 tokens, f32, w N-major (bound_ms: "
                       "three TF32 products a multiply-add at 495 "
                       "TFLOP/s; fma_bound_ms: one at the FMA rate, 67); "
                       "launches: the matmul path (also wq with w "
                       "K-major)",
             card=card),
        dict(_sums(sm90_rows), name="matmul_lb_sm90", route="cuda",
             kernel_route="sm90", source=SM90_SOURCE,
             replaces=MATMUL_REPLACES,
             launches=matmul_launches["by_route"]["sm90"],
             k_major_wq_ms=[r["ms"] for r in matmul_all
                            if r["layout"] == "k-major"
                            and r["route"] == "sm90"][0],
             times_are="sums over phi3-medium-14b's wq, wk, FFN up and "
                       "FFN down at 4096 tokens, bf16, w N-major "
                       "(launches: also wq with w K-major)",
             card=card),
        dict(_sums(_fma_of(tf32_attn)), name="attention", route="cuda",
             kernel_route="fma", source=ATTN_SOURCE,
             replaces=ATTN_REPLACES,
             launches=attn_launches["by_route"]["fma"],
             on_main_path=False,
             launches_off_path=check_attn_by_route["fma"],
             launches_check_attention_by_route=check_attn_by_route,
             launches_attention_by_route=attn_launches["by_route"],
             times_are="the FMA kernel through via='fma' on "
                       "phi3-medium-14b's (S 4096, causal) and "
                       "mixtral-8x7b's (S 8192, causal, window 4096) f32 "
                       "attention (which take sm90_tf32; bound_ms: one "
                       "multiply-add at the FMA rate); launches: the "
                       "attention path, which no longer runs this kernel; "
                       "launches_check_attention_by_route: the reference's "
                       "sweep and the head dims beside it, each case on "
                       "every route that takes it",
             card=card),
        dict(attn_sums["sm90_tf32"], name="attention_sm90_tf32",
             route="cuda", kernel_route="sm90_tf32", source=ATTN_TF32_SOURCE,
             replaces=ATTN_REPLACES, dtype="f32",
             launches=attn_launches["by_route"]["sm90_tf32"],
             launches_check_attention=check_attn_by_route["sm90_tf32"],
             fma_bound_ms=sum(r["fma_bound_ms"] for r in tf32_attn),
             fma_ms=sum(r["fma_ms"] for r in tf32_attn),
             host_us=sum(r["host_us"] for r in tf32_attn),
             control_1xtf32_over_route={
                 r["config"]: r["control_1xtf32"]["over_route"]
                 for r in tf32_attn},
             control_1xtf32_fails_gate={
                 r["config"]: r["control_1xtf32"]["fails_gate"]
                 for r in tf32_attn},
             control_v_key_off_worst_over_tol={
                 r["config"]: r["control_v_key_off"]["worst_over_tol"]
                 for r in tf32_attn},
             times_are="sums over phi3-medium-14b's (S 4096, causal) and "
                       "mixtral-8x7b's (S 8192, causal, window 4096) "
                       "attention, f32 (bound_ms: three TF32 products a "
                       "multiply-add at 495 TFLOP/s; fma_bound_ms: one at "
                       "the FMA rate, 67; fma_ms: attention_block.cu on the "
                       "same inputs)",
             card=card),
        dict(attn_sums["sm90"], name="attention_sm90", route="cuda",
             kernel_route="sm90", source=ATTN_SM90_SOURCE,
             replaces=ATTN_REPLACES,
             launches=attn_launches["by_route"]["sm90"],
             launches_check_attention=check_attn_by_route["sm90"],
             host_us=sum(r["host_us"] for r in attn_rows
                         if r["route"] == "sm90"),
             times_are="sums over phi3-medium-14b's (S 4096, causal) and "
                       "mixtral-8x7b's (S 8192, causal, window 4096) "
                       "attention, bf16",
             card=card)]
    lm_rows = {(r["dtype"], r["what"]): r
               for r in lm["rows"] + lm["f32_rows"]}
    moe_rows = {(r["dtype"], r["what"]): r
                for r in moe["rows"] + moe["f32_rows"]}
    encdec_rows = {(r["dtype"], r["what"]): r for r in encdec["rows"]}
    #: the configs beyond phi3 and mixtral: each phase's rows
    new_serve = {"lm_serve_dense": dense, "lm_serve_mqa": mqa,
                 "lm_serve_dbrx": dbrx, "lm_serve_vlm": vlm}
    #: each LM phase's launch counts, by part
    lm_runs = {"launches_lm_serve": lm, "launches_lm_serve_moe": moe,
               "launches_lm_serve_ssm": ssm,
               "launches_lm_serve_hybrid": hybrid,
               "launches_lm_serve_encdec": encdec,
               **{f"launches_{k}": run for k, run in new_serve.items()},
               "launches_lm_long_dense": long_dense,
               "launches_lm_long_window": long_window,
               "launches_lm_train": lm_train,
               "launches_lm_train_moe": train_moe,
               "launches_lm_train_ssm": train_ssm,
               "launches_lm_train_hybrid": train_hybrid,
               **{f"launches_{k}": run for k, run in new_train.items()},
               "launches_lm_train_mesh": lm_train_mesh,
               "launches_lm_serve_mesh": lm_mesh,
               "launches_mesh_ssm": mesh_ssm,
               "launches_lm_serve_mesh_ssm": lm_mesh_ssm,
               "launches_examples_serve": examples,
               "launches_dryrun": dryrun}
    for k in kernels:
        counter = counter_of(k)
        for key, run in lm_runs.items():
            parts = [run[part] for part in ("bf16", "f32") if part in run]
            if counter == "attention":
                k[key] = sum(c["attention"][k["kernel_route"]]
                             for c in parts)
            else:   # K1-K3 run nowhere on the LM paths: none required
                k[key] = sum(n for c in parts for name in (
                    "conv_lb", "wgrad_lb", "matmul_lb")
                    if name.startswith(counter) for n in c[name].values())
                require(k[key] == 0, f"{k['name']}: launched on the "
                                     f"{key.removeprefix('launches_')} "
                                     f"path")
    by_name = {k["name"]: k for k in kernels}
    for k in kernels:
        # the analysed layers of examples/accelerator_analysis_torch.py
        k["launches_examples_analysis"] = (
            examples["k1"].get(k["kernel_route"], 0)
            if counter_of(k) == "conv_lb" else 0)
    by_name["conv_lb_sm90_tf32"]["examples_analysis"] = [
        {f: r[f] for f in ("argv", "layer", "ms", "device_ms", "plain_ms",
                           "library_ms", "library_device_ms", "bound_ms",
                           "bound_by", "max_abs_err")}
        for r in examples["rows"]]
    require(by_name["conv_lb_sm90_tf32"]["launches_examples_analysis"] > 0
            and not any(k["launches_examples_analysis"] for k in kernels
                        if k["name"] != "conv_lb_sm90_tf32"),
            f"examples: K1's launches by route {examples['k1']}")
    example_runs = {n: by_name[n]["launches_examples_serve"]
                    for n in ("attention_sm90", "attention",
                              "attention_sm90_tf32")}
    require(example_runs["attention_sm90_tf32"] > 0
            and example_runs["attention"] == 0
            and example_runs["attention_sm90"] == 0,
            f"examples: K4's launches by route {example_runs}")
    require(by_name["attention"]["launches_lm_serve"] == 0
            and by_name["attention_sm90"]["launches_lm_serve"] > 0
            and by_name["attention_sm90_tf32"]["launches_lm_serve"] > 0,
            "lm_serve: K4's launches by route")
    require(by_name["attention"]["launches_lm_serve_moe"] == 0
            and by_name["attention_sm90"]["launches_lm_serve_moe"] > 0
            and by_name["attention_sm90_tf32"]["launches_lm_serve_moe"] > 0,
            "lm_serve_moe: K4's launches by route")
    require(all(by_name[n]["launches_lm_serve_ssm"] == 0
                for n in ("attention", "attention_sm90",
                          "attention_sm90_tf32")),
            "lm_serve_ssm: K4 launched on an attention-free path")
    require(by_name["attention_sm90_tf32"]["launches_lm_serve_hybrid"] > 0
            and by_name["attention"]["launches_lm_serve_hybrid"] == 0
            and by_name["attention_sm90"]["launches_lm_serve_hybrid"] == 0,
            "lm_serve_hybrid: K4's launches by route")
    require(by_name["attention_sm90"]["launches_lm_serve_encdec"] > 0
            and by_name["attention_sm90_tf32"]["launches_lm_serve_encdec"] > 0
            and by_name["attention"]["launches_lm_serve_encdec"] == 0,
            "lm_serve_encdec: K4's launches by route")
    for key in new_serve:
        require(by_name["attention_sm90"][f"launches_{key}"] > 0
                and by_name["attention_sm90_tf32"][f"launches_{key}"] > 0
                and by_name["attention"][f"launches_{key}"] == 0,
                f"{key}: K4's launches by route")
    for key in ("lm_long_dense", "lm_long_window"):
        require(by_name["attention_sm90"][f"launches_{key}"] > 0
                and by_name["attention_sm90_tf32"][f"launches_{key}"] > 0
                and by_name["attention"][f"launches_{key}"] == 0,
                f"{key}: K4's launches by route")
    require(by_name["attention_sm90"]["launches_lm_train"] > 0
            and by_name["attention_sm90_tf32"]["launches_lm_train"] > 0
            and by_name["attention"]["launches_lm_train"] == 0,
            "lm_train: K4's launches by route")
    new_runs = {n: {k: by_name[n][f"launches_lm_train_{k}"]
                    for k in ("moe", "ssm", "hybrid")}
                for n in ("attention_sm90", "attention",
                          "attention_sm90_tf32")}
    require(new_runs["attention_sm90"]["moe"] > 0
            and new_runs["attention_sm90_tf32"]["hybrid"] > 0
            and not any(new_runs["attention"].values())
            and not any(new_runs["attention_sm90"][k] for k in ("ssm",
                                                                 "hybrid"))
            and not any(new_runs["attention_sm90_tf32"][k]
                        for k in ("moe", "ssm")),
            f"lm_train_moe, lm_train_ssm, lm_train_hybrid: K4's launches "
            f"by route {new_runs}")
    for key in new_train:
        require(by_name["attention_sm90"][f"launches_{key}"] > 0
                and by_name["attention_sm90_tf32"][f"launches_{key}"] == 0
                and by_name["attention"][f"launches_{key}"] == 0,
                f"{key}: K4's launches by route")
    train_mesh_runs = {n: by_name[n]["launches_lm_train_mesh"]
                       for n in ("attention_sm90", "attention",
                                 "attention_sm90_tf32")}
    require(train_mesh_runs["attention_sm90"] > 0
            and train_mesh_runs["attention"] == 0
            and train_mesh_runs["attention_sm90_tf32"] == 0,
            f"lm_train_mesh: K4's launches by route {train_mesh_runs}")
    ssm_runs = {n: (by_name[n]["launches_mesh_ssm"],
                    by_name[n]["launches_lm_serve_mesh_ssm"],
                    by_name[n]["launches_dryrun"])
                for n in ("attention_sm90", "attention",
                          "attention_sm90_tf32")}
    require(ssm_runs["attention_sm90_tf32"][1] > 0
            and not any(ssm_runs["attention_sm90_tf32"][0::2])
            and not any(ssm_runs["attention_sm90"] + ssm_runs["attention"]),
            f"mesh_ssm, lm_serve_mesh_ssm, dryrun: K4's launches by route "
            f"{ssm_runs}")
    mesh_runs = {n: by_name[n]["launches_lm_serve_mesh"]
                 for n in ("attention_sm90", "attention",
                           "attention_sm90_tf32")}
    require(mesh_runs["attention_sm90"] > 0 and mesh_runs["attention"] == 0
            and mesh_runs["attention_sm90_tf32"] == 0,
            f"lm_serve_mesh: K4's launches by route {mesh_runs}")
    for k in kernels:
        if counter_of(k) == "attention":
            rt = k["kernel_route"]
            # the launches that also wrote each row's log-sum-exp
            k["lse_launches"] = {
                "mesh_attention": mesh_attn["checks"]["attention_lse"][rt],
                "lm_serve_mesh": lm_mesh["mesh_lse"][rt]}
            require(k["lse_launches"]["mesh_attention"] > 0,
                    f"{k['name']}: no lse launch in mesh_attention")
    by_name["attention_sm90"]["mesh_decode_lse"] = {
        f: mesh_attn["time"][f] for f in (
            "ms", "ms_lse", "device_ms", "device_ms_lse", "bound_ms",
            "bound_by", "library_ms", "library_device_ms", "shape")}
    for name, dtype in (("attention_sm90", "torch.bfloat16"),
                        ("attention_sm90_tf32", "torch.float32")):
        # the reference's long shapes, held on their panels (plain_ms:
        # the panels only; library_ms null where SDPA cannot take them)
        by_name[name]["lm_attention_long"] = {
            r["what"]: {f: r.get(f) for f in (
                "ms", "device_ms", "bound_ms", "bound_by", "plain_ms",
                "plain_ms_is", "library_ms", "library_device_ms",
                "library_null_reason", "host_us", "max_abs_err",
                "worst_over_tol", "held_on", "shape", "window")}
            for r in long_attn["rows"] + long_attn["f32_rows"]
            if r["dtype"] == dtype}
    for key, rows in (("lm_serve", lm_rows), ("lm_serve_moe", moe_rows),
                      ("lm_serve_encdec", encdec_rows),
                      *((key, {(r["dtype"], r["what"]): r
                               for r in run["rows"] + run["f32_rows"]})
                        for key, run in new_serve.items())):
        for name, dtype in (("attention_sm90", "torch.bfloat16"),
                            ("attention_sm90_tf32", "torch.float32")):
            by_name[name][key] = {
                what: {f: r[f] for f in ("ms", "device_ms", "bound_ms",
                                         "bound_by", "plain_ms",
                                         "library_ms", "library_device_ms",
                                         "host_us", "max_abs_err", "shape",
                                         "window")}
                for (dt, what), r in rows.items() if dt == dtype}
    for k in kernels:
        if k.get("on_main_path", True):
            require(k["launches"] > 0, f"{k['name']}: no launch on its path")
        else:   # left its path: it runs only where a sweep sends it
            require(k["launches"] == 0 and k["launches_off_path"] > 0,
                    f"{k['name']}: launched on the main path, or never")
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(card, flush=True)
    emit({"kernels": kernels})
    require(not MISSED, f"gates missed: {MISSED}")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
