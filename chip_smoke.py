#!/usr/bin/env python3
"""Drive the PyTorch port of Biathlon on one CUDA card and check what it does.

Run from the root of a checkout, with no arguments:

    PYTHONPATH=src python3 chip_smoke.py

Phases (any failure exits non-zero before the result line is printed):

1. print the card (``nvidia-smi`` name and power limit) and build the
   CUDA sources under ``src/repro_torch/kernels/csrc`` (one ``nvcc`` each,
   in parallel), with their build time;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, and time both with CUDA events;
   ``sobol_points`` at the executors' one-launch grids of all eight
   pipelines and the LM head, and at (65536, 64), each at skip 0, 12345 and
   2^32 - 50 (the index wraps): points, uniforms and its direct path (the
   earlier design, ``earlier_ms``) bitwise the plain version's, and
   ``SobolEngine``'s points (timed with the copy to the card as
   ``library_ms``), every run length on one grid;
   ``prefix_power_sums`` at (9, 32768) and the LM head's (3, 65536) also
   launched twice (bitwise equal), against its emulation in PyTorch
   (bitwise) and through its rows path (the earlier design, timed as
   ``earlier_ms``); ``ensemble_sum`` on the turbofan forest (40 × 511) and a
   60 × 63 boosted model at every served megabatch, bitwise equal to the
   plain version on both of its paths, its global path (the earlier
   design) timed as ``earlier_ms``;
   ``sampled_moments`` on (9, 32768) at random z, on request 0's z⁰ and
   over z = 1051 and full prefixes at (9, 32768) and (3, 65536): launched
   twice (bitwise equal), bitwise equal to its emulation in PyTorch, its
   rows path (the earlier design, ``earlier_ms``) and it within the tables'
   tolerance of the plain version; all five must take their redesigned
   path (``build.PATHS``) there and on every served run below;
3. build the full-width ``turbofan`` bundle (20000 rows per group, 400
   train groups, 24 serve groups; random forest of 40 trees, depth 8) and
   serve 8 requests with ``BiathlonConfig()`` under ``afc_backend="auto"``
   (incremental AFC), under ``"ref"`` (the rescan) and through the plain
   versions on the card; launch counts are reset just before each run and
   read just after, and every kernel of a run's path must have launched;
4. the same at ``rows_per_group=500``, where "auto" takes the rescan path;
5. the holistic pipeline ``sensor_health`` (five aggregates, three of them
   MEDIAN/QUANTILE; gradient boosting, 60 trees of depth 5) at full width:
   ``masked_select_ranks`` against its plain version on request 0's own
   holistic buffers, its plan z⁰ and the 1 + 256 rank targets of its z⁰
   evaluation, and over z = 4096, 16384, 32768 and 65536 (int32 bits, two
   launches, the radix path; the rank path, the earlier design, too),
   timed beside the rank path (``earlier_ms``) and ``torch.sort`` plus a
   gather; then 8 requests under "auto" (incremental: the
   rank index, no ``masked_select_ranks``), "ref" (the rescan through
   ``masked_select_ranks``) and the plain versions, and under "auto" and
   plain at 0.3 × δ so that the loop is entered; then the same kernel
   check and 4 requests at ``rows_per_group=500``, where "auto" rescans;
   then the rescan against the incremental AFC per cap bucket, 512 to
   65536, on synthetic buffers of both pipelines' shapes (host wall time
   of the incremental set-up and of an evaluation on each path);
6. the six other paper pipelines at full width (``make_pipeline``
   defaults): ``trip_fare``, ``tick_price`` (linear), ``battery``,
   ``bearing_imbalance`` (MLP classifier), ``fraud_detection`` and
   ``student_qa`` (classifiers), 4 requests each under "auto" and through
   the plain versions, at δ and at 0.3·δ (regression) or τ = 0.99
   (classification): equal plans, iterations and classes, every kernel of
   the path launched (``ensemble_sum`` on the four tree pipelines), one
   ``sobol_points`` launch an executor build; ``student_qa``'s forest held
   bitwise and timed at its 6889-row megabatch, ``fraud_detection``'s at
   2281; the busiest tight classification request profiled; then
   ``make_pipeline_median("trip_fare")`` under "ref" (``masked_select_ranks``);
7. the host-loop server (``BiathlonServer(mode="host")``, the reference's
   paper-faithful executor) on the eight pipelines above at full width,
   through the kernels and through the plain versions, and the fused server
   on the same requests: ``serve_all(compare_exact=True)`` over 4 requests
   after a warm-up (keys ``PRNGKey(i)``), equal plans, iterations, classes
   and exact answers, ``ServerStats.summary`` printed per pipeline and mode
   (mean and p95 latency, exact latency, speedup, sample fraction,
   guarantee rate); ``sobol_points`` (every QMC grid), ``ensemble_sum`` (the
   tree models) and ``masked_select_ranks`` (sensor_health's holistic
   estimates) launched on the host path, the fused-path kernels not; tight
   host requests on turbofan and sensor_health, the busiest profiled; then
   ``masked_select_ranks`` at the bootstrap's (256, cap) rows with one target
   each (sensor_health request 0's z⁰, a full 32768 prefix, z = 1, 352 and
   353) and ``ensemble_sum`` at the host loop's m + 1 and (k+2)·m_sobol rows,
   bitwise the plain versions', timed under graph replay and eagerly beside
   sort plus gather;
8. the batched server (``BatchedFusedServer``, 8 lanes) at full width:
   each kernel of its path held to its plain version at the shapes 8 lanes
   give it and timed (``prefix_power_sums`` on each batched pipeline's
   (8·k, cap) rows at every incremental cap its fills serve,
   ``sampled_moments`` and ``masked_select_ranks`` on sensor_health's (40,
   cap) and (24, cap) rows at z⁰, ``ensemble_sum`` on each batched
   pipeline's forest at its z⁰, Saltelli and step megabatches, e.g. 8 ×
   1001, 8 × 2816 and 8 × 3817 rows for turbofan); then turbofan,
   sensor_health, fraud_detection and ``student_qa`` at δ and at the tight
   setting, at fill 8, 3 and 1, and sensor_health under "ref" (the rescan)
   at fill 8: the captured graphs (the main path: launch counts reset just
   before the captured server's build and each captured batch, read just
   after, the comparison servers' builds not counted) bitwise equal to the eager programs, the plain versions' plans equal,
   one capture a cap bucket; captured and eager timed in turns (p50 a
   batch, requests/s), the tight fill-8 batches profiled both ways (device
   busy and idle share, host operators, launches); every kernel of the
   path launched.  The single-request server (the one-lane case, captured
   since this phase was added) is profiled eagerly too on the tight
   turbofan and sensor_health requests of phases 3 and 5;
9. the hot-group feature cache (``cache_size=64``) on full-width turbofan
   and sensor_health over deep copies of their stores: batches of 8 at δ
   and at the tight setting and 8 single requests, a miss pass and a hit
   pass, each bitwise the uncached captured server's (the main path of
   this phase: counts reset just before each pass and read just after);
   a miss batch makes one ``prefix_power_sums`` launch, a hit none and no
   slot; 3 appends into each of two served groups on the cached store and
   an oracle copy (refreshes counted, plans equal, ŷ within
   1e-3·max(1, |y|)); an append into a new group (j = 0) rebuilt by
   ``cold``; sensor_health cached under "ref" (the rescan kernels) and
   turbofan cached at 500 rows a group (``prefix_power_sums`` at cap 512,
   plans equal to the uncached rescan's); p50 per batch and per request
   uncached, miss and hit in turns, the gather, the copy to the card from
   pageable and pinned memory, the slot's device-to-device copy, ``cold``
   and one ``refresh``, and a profiled hit batch; ``prefix_power_sums``
   also held to its plain version at (9, 512) and (72, 512);
10. ``flash_attention`` against its plain version: the LM-head prompt
   (1, 16, 48, 64) and (1, 16, 4096, 64) and (1, 16, 4096, 128) prefills
   in bf16, causal (the tensor-core kernel); a float32 non-causal case (the
   scalar kernel); Sq ≠ Sk; 4096 × 16 = 65536 batch·heads on three
   inputs; GQA through ``ops.attention``; every bf16 output also within one
   bf16 ulp of its emulated roundings plus its tie slack; the three bf16
   shapes timed beside ``F.scaled_dot_product_attention`` (a yardstick the
   port never calls), with the ratio to it, the share of the bound and
   each bf16 instance's registers and spills from the build log;
11. the LM-head pipeline (``repro_torch.examples.serve_lm_head``) with a
   full-width ``qwen1.5-0.5b`` backbone (24 layers, d 1024, random weights
   from a seed): 6 requests through the kernels, exactly 24
   ``flash_attention`` launches and one ``prefix_power_sums`` per request
   (and one in the eager pass before its bucket's capture);
   the same requests under ``use_kernel=False`` (no launch), pooled states
   within bf16 tolerance of the kernel path's, and equal plans when both
   executors are fed the same pooled state; a profile of one request;
12. one 1 × 4096-token backbone forward, profiled: its latency,
   ``flash_attention``'s share of device time and the device's idle share;
13. continuous batching and the arrival-driven runtimes at full width:
   ``ContinuousBatchedServer`` (8 lanes, ``chunk_iters=4``) at the tight
   setting on turbofan, sensor_health under "auto" and "ref" and
   fraud_detection, a 64-request Poisson trace at 2× and 0.25× the
   requests/s phase 8 measured for the captured fixed-lane server's tight
   fill-8 batch; the main path (launch counts reset just before the
   table's build, read after its two measured runs) compared in turns with
   ``ServingRuntime`` over the fixed-lane server (throughput, p50 / p99
   latency, queue delay, lane occupancy, recycles, ``chunked_straggler_report``'s
   ``wasted_frac`` beside the batches' ``straggler_report`` waste); every
   request's plan and iterations those of its run on a one-lane server (ŷ,
   prob within 1e-5); on the trace at t = 0, the same run twice, the eager
   table (``capture=False``) and the cached table bitwise, the plain
   versions' plans equal; two slots a bucket throughout; on turbofan and
   sensor_health a cached miss launches one ``prefix_power_sums`` and a hit
   none, a fault storm (chunk and refill failures, poisoned lanes) replays
   identically twice and serves each request bitwise its fault-free run,
   and one refill and one chunk are timed (wall, device, profiled; the
   Saltelli block a refill replays; a chunk that reads the flags before each
   replay beside ``chunk_iters`` replays read once); ``ServingRuntime`` with
   a ``DegradationController`` at 4× the saturating rate sheds some requests
   and serves the rest; ``repro_torch.launch.serve.main`` runs
   ``fused-batched`` and ``fused-continuous`` in process;
14. lanes sharded over a serving mesh (``launch/mesh.py``) at full width:
   ``BatchedFusedServer(mesh=make_serving_mesh())`` over every visible card
   and over 2 and 4 shards simulated on the card, turbofan and
   sensor_health at the tight setting, fills 8, 3 and 1 (sensor_health
   also under "ref" over 2 shards, fill 8), against the unsharded captured
   server: the card mesh bitwise (on one card it is one shard), simulated
   shards with equal plans and iterations, ŷ and prob within 1e-5, bitwise
   run to run; one slot a bucket on every shard, each shard's
   ``sobol_points`` at its build and ``prefix_power_sums`` at its capture
   and every z⁰ replay (the main path: counts reset just before the mesh
   servers' builds, read after their batches); ``straggler_report``'s
   per-shard fields; one tight fill-8 turbofan batch unsharded and over 2
   and 4 shards in turns (wall p50), each profiled (device busy by stream,
   the streams' overlap, idle share); ``ContinuousBatchedServer`` over 2
   shards on phase 13's 64 turbofan requests at t = 0 (plans and
   iterations those of the unsharded table, phase 13's fault storm twice
   alike and bitwise its fault-free sharded run, two slots a bucket on
   every shard); the launcher's ``fused-sharded`` and ``fused-continuous
   --devices 1``; ``python -m repro_torch.analysis.check`` on the card (no
   finding, the facts of ``baseline.json``'s cuda section) and its
   ``--mutation-test`` (all nine caught);
15. LM serving (``LM.prefill`` / ``decode_step``, the KV cache) for the
    seven ported configs at full published width, one model on the card
    at a time: qwen1.5-0.5b, qwen3-8b, qwen3-14b (48 query heads padded
    from 40 on 8 KV heads), gemma-7b (head dim 256), internvl2-1b (256
    frontend tokens, 16 query heads padded from 14 on 2), granite-moe-1b-a400m
    and deepseek-v2-236b (MLA, q/k 192 and v 128; cut to 3 layers: its
    dense layer and two MoE layers of 160 experts, ≈ 18.5 GB); seeded
    random weights.  B = 2 prompts of 1024 positions, 16 teacher-forced
    decode steps (``flash_attention`` first checked and timed at gemma's
    (2, 16, 1024, 256) and MLA's (2, 128, 1024, 192 / 128) beside its
    plain version and SDPA), through the kernel and through the plain path (the MoE
    configs' plain run on the kernel run's expert choices,
    ``RoutingReplay``): logits and caches within ``STATE_REL_TOL``;
    ``flash_attention`` once a layer a prefill (the main path of this
    phase: counts reset just before each prefill), never in decode, its
    paths by head dim; decode of the last token against the full prefill
    on the kernel path (one prompt; MoE dropless and sorted), the reference
    test's tolerance; the capacity guard; granite's sorted MoE backend
    bitwise run to run and against the einsum backend; parameter, cache
    and peak bytes; for qwen3-8b and granite the prefill time and decode
    ms a step at B = 1 and 8;
16. LM serving for the SSM, hybrid and audio families at full published
    width, one model on the card at a time, seeded random bf16 weights:
    ``flash_attention`` first checked (plain version, emulated roundings)
    and timed beside its plain version, SDPA (with the window's boolean
    mask) and its bound at zamba2's windowed (1, 32, 8192, 80), window
    4096, and seamless's cross (2, 16, 256 on 1024, 64); then zamba2-2.7b
    at B = 1 × 8192 (S % 4096 = 0; the 16 decode steps wrap the ring) and
    B = 2 × 1024 (below the window), seamless-m4t-large-v2 at B = 2, 1024
    frontend frames and a 256-token prompt, xlstm-1.3b at B = 2 × 1024,
    each prefill and 16 teacher-forced decode steps through the kernel and
    through the plain path, and (zamba2, seamless) through the plain path
    in float32 on the same weights: the kernel path's logits and every
    cache leaf no further from the float32 run than ``ANCHOR_FACTOR`` times
    the bf16 plain path's (xlstm, with no attention: bitwise the plain
    path); ``flash_attention`` launches a prefill by kind and
    head dim (zamba2 9, all windowed at head dim 80; seamless 24
    bidirectional encoder, 24 causal decoder and 24 cross, Sq ≠ Sk; xlstm
    none), none in decode, all on the TMA path; on zamba2 at 8192 the
    last decode step (position 8207, the ring wrapped) against the prefill
    of all 8208 tokens, the reference test's tolerance; parameter, cache
    and peak bytes, the
    prefill time and decode ms a step at B = 1 and 8;
17. LM training: (a) the two backward kernels of ``flash_attention``
    (``flash_attention_bwd_dq``, ``flash_attention_bwd_dkv``) against the
    plain backward (``ref.flash_attention_bwd_ref``, KV head by KV head
    where it would not fit) on the forward kernel's output and row
    log-sum-exp at qwen1.5-0.5b's (4, 16, 1024, 64) causal, qwen3-8b's
    (1, 32 on 8, 1024, 128), MLA's (2, 128, 1024, 192 / 128), zamba2's
    (1, 32, 8192, 80) with window 4096, seamless's bidirectional
    (2, 16, 1024, 64) and cross (2, 16, 256 on 1024, 64), gemma's
    (2, 16, 1024, 256) and one float32 case, every bf16 launch on the
    tensor-core kernels fed by TMA and the float32 one on the scalar
    kernels (``build.PATHS``), each kernel timed beside its
    bound, the plain backward and SDPA's autograd backward; (b)
    full-width qwen1.5-0.5b (bf16, float32 Adam moments, remat), cut to 12
    of its 24 layers since phase 20 joined, through
    ``Trainer`` at B = 4 x 1024 for 5 steps, the main path of the phase
    (counts reset just before, read just after): the step-0 loss within
    1.5 of ln V, 12 launches of each backward kernel (every one on the
    TMA path) and 24 forward launches a step, a checkpoint at step 3 from which a fresh ``Trainer``
    gives steps 4 and 5 bitwise, one step profiled, step 0 against the
    plain path (``use_kernel=False``) within ``TRAIN_REL_TOL`` and each
    attention projection's gradient, layer by layer, within
    ``ATTN_GRAD_TOL``, which a planted fault (``dq`` or ``dk`` zeroed)
    must pass; step wall ms, tokens/s, peak bytes and each save's host
    snapshot ms; (c) one train step of each of the ten configs at
    ``.reduced()``, kernel path against plain path, with the same
    attention-gradient check;
18. the LM tensor-parallel over a mesh of shards (``models/lm/sharding.py``):
    (a) float32 qwen3-8b at full width, 4 layers, B = 2 x 256, TF32 off, on
    meshes (1, 4) and (2, 2) of shards simulated on the card against the
    unsharded port on the same weights: the last logits (``prefill_logits``)
    within 1e-4, ``train_loss`` within 1e-5 and every gradient leaf,
    gathered, within 1e-4 (max-normalised); on (1, 16), where the 8 KV
    heads are replicated and the 32 query heads split, the logits again; a
    planted fault each (the last shard's partial dropped from the blocks'
    all-reduces; KV heads of the first group) beyond the bound; the sharded
    kernel path against the sharded plain path (``use_kernel=False``) on
    the same placed weights, logits and every gradient leaf within the same
    bounds (a zeroed ``dq`` beyond them); where two cards or more are
    visible, the same over real cards; (b) bf16 qwen3-8b at full width, cut
    to 12 of its 36 layers (full depth until the script's run passed 600 s
    with phase 19), B = 2 x 1024, the sharded forward at tp 4 (a main path:
    counts reset just before, read just after) within ``STATE_REL_TOL`` of
    the unsharded kernel path (backbone and last logits, no cache) and of the
    sharded plain path, 48 ``flash_attention`` launches, all TMA, at (2, 8
    on 2, 1024, 128), wall ms and the span between two events, parameter
    and peak bytes, and a dropped partial beyond the bound; (c) bf16
    qwen1.5-0.5b at full width, B = 4 x 1024, three ``build_train_step``
    steps on (1, 4) with the vocab-sharded loss (a main path): step 0
    within ``TRAIN_REL_TOL`` of the unsharded step, the block weights'
    gradients within ``ATTN_GRAD_TOL`` layer by layer (a dropped partial
    beyond it), the attention gradients of the sharded kernel path against
    the sharded plain path within ``ATTN_GRAD_TOL`` (a zeroed ``dq`` or
    ``dk`` beyond it), the forward and backward launches a step by path,
    step wall ms and event spans, tokens/s, peak bytes and the collectives'
    bytes from ``collectives.STATS``; and each attention shape that (a),
    (b) and (c) launched at the shards' head counts, the forward and both
    backward kernels against their plain versions through their wrappers;
19. the MoE family tensor-parallel over a mesh of shards (the reference's
    rules: every shard holds every expert and a slice of ``d_ff_expert``;
    one all-reduce over "model" a MoE layer): (a) float32, TF32 off,
    against the unsharded port on the same weights, granite-moe-1b-a400m
    at full width, 4 layers, B = 2 x 256 on (1, 4), (2, 2) and (1, 16)
    (the 8 KV heads replicated, ``d_ff_expert`` split 16 ways), the last
    logits within ``TP_LOGITS_TOL``, ``train_loss`` within
    ``TP_LOSS_TOL`` and every gradient leaf within ``TP_GRAD_TOL``, and
    deepseek-v2-236b at full width cut to its dense layer and one MoE layer
    (≈ 21.5 GB of float32 weights), B = 2 x 128 on (1, 4) and (2, 2) (its
    one einsum group of 256 tokens straddles the two data shards), the
    logits; both MoE backends on (2, 2); planted faults beyond the bound
    (one shard's partial dropped from granite's MoE all-reduce; local
    capacity on deepseek's sorted backend); (b) bf16 deepseek-v2-236b at
    full width, 3 layers (as in phase 15), B = 2 x 1024, the sharded
    forward at tp 4 (a main path: counts reset just before, read just
    after) within ``STATE_REL_TOL`` of the unsharded kernel path and of
    the sharded plain path on the unsharded run's expert choices
    (``RoutingReplay`` over the shards, with the count of shard-tokens
    whose own choice differed), 12 ``flash_attention`` launches, all TMA,
    at (2, 32, 1024, 192 / 128), wall ms and the span between two events,
    parameter and peak bytes; (c) bf16 granite-moe-1b-a400m at full width,
    B = 4 x 1024, three ``build_train_step`` steps on (1, 4) (a main path):
    step 0 within ``TRAIN_REL_TOL`` of the unsharded step and the block
    weights' gradients (the router's too) within ``ATTN_GRAD_TOL`` layer
    by layer, on its expert choices, the forward and backward launches a
    step by path at (4, 4 on 2, 1024, 64), step wall ms, tokens/s, peak
    bytes and the collectives' bytes; and each attention shape that (a)-(c)
    launched, the forward (and where a gradient was taken both backward
    kernels) against the plain versions through the wrappers;
20. the SSM, hybrid and audio families tensor-parallel over a mesh of
    shards (the reference's rules: Mamba2's ``in_proj`` products
    all-gathered over "model" and each shard's heads run on its block of the
    inner width, its RMS norm's sums of squares all-reduced; the mLSTM on
    whole heads, or on the all-gathered q, k, v where a shard holds part of
    a head; the sLSTM's input part all-gathered and its scan run on every
    shard, its output MLP split where the guard splits it; the audio
    encoder over the replicated frontend and the cross attention over each
    shard's heads): (a) float32, TF32 off, against the unsharded port on the
    same weights at full width and cut depth, B = 2 x 256: zamba2-2.7b's
    first group (six Mamba2 blocks and the windowed shared block) on (1, 4),
    (2, 2) and (1, 16); xlstm-1.3b's first group (seven mLSTM blocks and an
    sLSTM) and a cut to one mLSTM and one sLSTM block, each on (1, 2)
    (``up``/``down`` split), (1, 4) (whole heads, ``up``/``down``
    replicated) and (1, 8) (a head's P over two shards);
    seamless-m4t-large-v2 at 2 encoder and 2 decoder layers over 1024
    frames on (1, 4), (2, 2) and (1, 16): the last logits within
    ``TP_LOGITS_TOL``, ``train_loss`` within ``TP_LOSS_TOL`` and every
    gradient leaf within ``TP_GRAD_TOL`` (zamba2's gradient is NaN at init
    in both packages, ROADMAP Queue 3: the shards' NaNs at the unsharded
    port's elements, the finite rest within the bound; xlstm's 8-layer
    group's logits and gradients within ``FAM_REORDER_FACTOR`` times the
    unsharded port's own gap when its weights move one ulp; the same group
    in float64 (``FAM_FLOAT64``), where that amplified rounding is gone, at
    the bounds above, the float32 runs' distances from it recorded);
    planted faults (``tests/torch_tp_probes.py``, shared with the CPU
    tests) beyond the gradient bound (Mamba2's and the mLSTM's norm over the
    shard's slice alone, the mLSTM at tp 8 without the gather, a replicated
    leaf's gradient summed over "model"), in xlstm's group in float64;
    (b) bf16
    at full width, the sharded forward at tp 4 (a main path: counts reset
    just before each, read just after): zamba2 one group at B = 1 x 8192
    (4 windowed ``flash_attention`` launches at (1, 8, 8192, 80), window
    4096), seamless 4 + 4 layers at B = 2 x 256 over 1024 frames (16
    bidirectional at (2, 4, 1024, 64), 16 causal at (2, 4, 256, 64) and 16
    cross at (2, 4, 256 on 1024, 64)), xlstm one group at B = 2 x 512 (no
    attention), all TMA, each within ``STATE_REL_TOL`` of the sharded plain
    path and no further from a float32 run of the same weights than
    ``ANCHOR_FACTOR`` times the unsharded kernel path, zamba2 and seamless
    within ``STATE_REL_TOL`` of the unsharded kernel path too (xlstm's bf16
    runs lie 0.28 from float32, ``FAM_REORDER_SENSITIVE``), wall ms and the
    span between two events, parameter and peak bytes; (c) bf16
    ``build_train_step`` at
    tp 4, three steps each (a main path): seamless 4 + 4 layers at B = 4 x
    256 over 1024 frames and zamba2 one group at B = 2 x 1024, step 0 within
    ``TRAIN_REL_TOL`` of the unsharded step and the block weights'
    gradients within ``ATTN_GRAD_TOL`` layer by layer (zamba2's NaNs at the
    unsharded step's elements; its later losses NaN, as the unsharded
    step's gradient is, and its steps 1-2 timed on NaN parameters, which
    its record and line say), the forward and backward launches a step at the
    shards' shapes, step wall ms, tokens/s, peak bytes and the collectives'
    bytes; and each attention shape that (a)-(c) launched (causal,
    bidirectional, cross or windowed) against the plain versions through
    the wrappers, the forward and, for (c), both backward kernels;
21. LM decode over a mesh of shards (the cache placed leaf for leaf by
    ``cache_pspecs``: the batch on the data axes, the cached sequence of every
    k, v and MLA latent on "model", each decode step's attention a split-K
    reduce over "model"; the cached prefill is the sharded forward with a
    cache sink): (a) float32, TF32 off, against the unsharded port on the
    same weights at full width and cut depth: qwen3-8b (4 layers) on (1, 4),
    (2, 2) and (1, 16) (its 8 KV heads replicated), deepseek-v2-236b (its
    dense layer and one MoE layer, MLA) and xlstm-1.3b (one mLSTM and one
    sLSTM block) and seamless-m4t-large-v2 (2 + 2 layers over 1024 frames)
    on (1, 4) and (2, 2), a cached prefill of B = 2 x 256 and 8
    teacher-forced decode steps; zamba2-2.7b's first group at B = 1 x 4096
    (its window: the steps wrap the ring; on (2, 2) the row is on no data
    axis), every step's logits and every gathered cache leaf within
    ``TP_LOGITS_TOL``; (c) on qwen3-8b (1, 4) the planted faults of
    ``tests/torch_tp_probes.py`` beyond it (the combine with each shard's own
    maximum, a shard's partial dropped, the new key written by every
    shard); (b) bf16 qwen3-8b at full width, 12 layers, over (1, 4) shards
    (a main path: counts reset just before the prefill, read after the last
    step), at B = 2 and B = 8 a 1024-token cached prefill (48
    ``flash_attention`` launches, all TMA, at the shards' (B, 8 on 2, 1024,
    128), none in decode) and 16 decode steps within ``STATE_REL_TOL`` of
    the unsharded kernel path, the steps of the two timed in turns (wall ms
    and the span between two events), the cache bytes a shard (a quarter of
    the unsharded k and v), the collectives a step and ``launch/cost.py``'s
    count of the same step; (d) each attention shape that (a) and (b)
    launched against the plain version through the wrapper;
22. print the run's total seconds, one ``{"kernels": [...]}`` line, then the
    result line ``{"ok": true, "device": {...}}``.

It refuses to run without a CUDA device, and imports nothing of JAX or of
the JAX package.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16, dense tensor cores
N_SERVE = 8
N_LM_REQ = 6
TABLE_TOL = dict(rtol=3e-5, atol=1e-3)
# flash_attention vs its plain version: float32 differs in summation order
# only; bf16 outputs are the float32 results rounded once (one bf16 ulp)
ATTN_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
# pooled states of the kernel and plain LM paths, max |diff| over max |state|:
# one bf16 ulp in an attention output moves later layers' bf16 roundings
STATE_REL_TOL = 3e-2
# the bf16 flash_attention kernel against its roundings emulated in PyTorch
# (kernels/flash_attention/emulation.py): both outputs are bf16, so one ulp
# (2^-7 relative) of the rounding apart at most, plus each output's slack
# from p's that the kernel may round to the other side of a bf16 tie
EMULATION_TOL = dict(rtol=2 ** -7, atol=2 ** -8)


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _events_ms(run, reps: int) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_ms(fn, reps: int = 20) -> tuple[float, float]:
    """``(device ms, eager ms)`` per call of ``fn`` (L2 warm).

    Device time: ``reps`` calls captured in one CUDA graph and replayed, so
    host launch overhead is out of the measurement.  Eager time: the same
    calls launched back to back from Python, as the serving loop launches
    them (for a tiny kernel this is the launch rate, not the kernel).
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    device = _events_ms(graph.replay, 5) / reps
    return device, _events_ms(fn, reps)


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over HBM rate vs ops over the type's peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def heavy_tailed(n=60000, seed=7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.normal(1.25, 0.12, n).astype(np.float32)
    v[0] = 100.0
    return v


def timings(kernel, plain) -> dict:
    (ms, eager_ms), (plain_ms, _) = time_ms(kernel), time_ms(plain)
    return dict(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms)


# ------------------------------------------------------------------ phase 2
def moments_work(z: torch.Tensor) -> tuple[float, str]:
    """Bound of one ``sampled_moments`` call: the live values read once, z
    and the shift read, (k, 5) written; 8 operations a live value."""
    k, live = z.shape[0], int(z.sum())
    return bound(live * 4 + k * 8 + k * 20, live * 8)


def moments_check(vals, z, shift, name: str) -> tuple[torch.Tensor, float]:
    """``sampled_moments`` through the executor's entry point: on the cluster
    path, bitwise equal to the launch before and to its emulation in PyTorch,
    its rows path (the earlier design) and it within the tables' tolerance of
    the plain version.  Returns the output and max |kernel - plain|."""
    from repro_torch.kernels import build
    from repro_torch.kernels.sampled_agg import ops
    from repro_torch.kernels.sampled_agg.emulation import clustered_sampled_moments
    from repro_torch.kernels.sampled_agg.sampled_agg import moment_blocks, sampled_moments

    build.reset_launch_counts()
    got, again = ops.moments(vals, z, shift), ops.moments(vals, z, shift)
    require(build.PATHS == {"sampled_moments.cluster": 2},
            f"sampled_moments {name} took {dict(build.PATHS)}, expected the cluster path")
    require(torch.equal(got, again), f"sampled_moments {name}: two launches differ")
    emulated = clustered_sampled_moments(vals, z, shift, blocks=moment_blocks(vals.shape[1]))
    require(torch.equal(got, emulated), f"sampled_moments {name} differs from its emulation")
    want = ops.moments(vals, z, shift, use_kernel=False)
    torch.testing.assert_close(got, want, **TABLE_TOL)
    torch.testing.assert_close(sampled_moments(vals, z, shift, blocks=0), want, **TABLE_TOL)
    return got, float((got - want).abs().max())


def moments_timed(vals, z, shift) -> dict:
    """The cluster path, its rows path (``earlier_ms``) and the plain
    version timed on one input, with the bound."""
    from repro_torch.kernels.sampled_agg import ops
    from repro_torch.kernels.sampled_agg.sampled_agg import moment_blocks, sampled_moments

    b = moments_work(z)
    return dict(
        **timings(lambda: ops.moments(vals, z, shift),
                  lambda: ops.moments(vals, z, shift, use_kernel=False)),
        earlier_ms=time_ms(lambda: sampled_moments(vals, z, shift, blocks=0))[0],
        blocks=vals.shape[0] * moment_blocks(vals.shape[1]), bound_ms=b[0], bound_by=b[1],
    )


def moments_record(bundle, dev, alpha: float) -> dict:
    """``sampled_moments`` on the inputs of the rescan's first evaluation.

    Request 0 of ``bundle`` is gathered as the server gathers it (its
    power-of-two cap bucket) with the plan z⁰ = ceil(α·n): the shape and data
    each rescan evaluation of that path gives the kernel.  Checked
    (:func:`moments_check`), timed beside the rows path and bounded by the
    live columns it must read.
    """
    from repro_torch.core.planner import initial_plan
    from repro_torch.data.store import bucket_size

    p, req = bundle.pipeline, bundle.requests[0]
    cap = bucket_size(int(max(p.group_sizes(bundle.store, req).max(), 1)))
    vals, sizes = bundle.store.request_buffers(p.agg_specs(req), cap, dev)
    z = initial_plan(sizes, alpha)
    shift = vals[:, 0].contiguous()
    _, err = moments_check(vals, z, shift, f"request 0 ({vals.shape[0]}, {cap})")
    return dict(shape=[vals.shape[0], cap], z=z.cpu().tolist(), max_abs_err=err,
                **moments_timed(vals, z, shift))


def moments_sweep(dev, rng) -> list:
    """The cluster kernel over the prefixes the paths give it: turbofan's
    z⁰ = 1051 and full prefix at (9, 32768), the LM head's full (3, 65536)."""
    out = []
    for k, cap, zr in ((9, 32768, 1051), (9, 32768, 32768), (3, 65536, 65536)):
        vals = torch.from_numpy(rng.normal(1.0, 3.0, (k, cap)).astype(np.float32)).to(dev)
        z = torch.full((k,), zr, dtype=torch.int32, device=dev)
        shift = vals[:, 0].contiguous()
        _, err = moments_check(vals, z, shift, f"({k}, {cap}) at z = {zr}")
        out.append(dict(shape=[k, cap], z=zr, max_abs_err=err, **moments_timed(vals, z, shift)))
    return out


def prefix_work(k: int, cap: int) -> tuple[float, str]:
    """Bound of one (k, cap) table: values read once, the shift read, (k, cap,
    4) written; 8 operations a value (four powers, four compensated sums)."""
    return bound(k * cap * 4 + k * 4 + k * cap * 16, k * cap * 8)


def prefix_record(vals, shift, *, full: bool = True) -> dict:
    """``prefix_power_sums`` on one (k, cap) input, held to its plain version,
    timed beside the rows path (the earlier design, ``earlier_ms``).  ``full``
    also holds two launches bitwise equal, the chunked kernel bitwise equal
    to its emulation, and the rows path to the plain version."""
    from repro_torch.kernels import build
    from repro_torch.kernels.sampled_agg import ops
    from repro_torch.kernels.sampled_agg.emulation import chunked_prefix_power_sums
    from repro_torch.kernels.sampled_agg.prefix_stats import chunk_threads, prefix_power_sums

    k, cap = vals.shape
    threads = chunk_threads(k, cap)
    build.reset_launch_counts()
    got = ops.prefix_power_sums(vals, shift)
    require(build.PATHS == {"prefix_power_sums.chunks": 1},
            f"prefix_power_sums ({k}, {cap}) took {dict(build.PATHS)}, expected chunks")
    want = ops.prefix_power_sums(vals, shift, use_kernel=False)
    torch.testing.assert_close(got, want, **TABLE_TOL)
    if full:
        require(torch.equal(got, ops.prefix_power_sums(vals, shift)),
                f"prefix_power_sums ({k}, {cap}): two launches differ")
        require(torch.equal(got, chunked_prefix_power_sums(vals, shift, threads=threads)),
                f"prefix_power_sums ({k}, {cap}) differs from its emulation")
        torch.testing.assert_close(prefix_power_sums(vals, shift, threads=0), want, **TABLE_TOL)
    b = prefix_work(k, cap)
    return dict(
        shape=[k, cap], chunk=4 * threads, blocks=k * -(-cap // (4 * threads)),
        max_abs_err=float((got - want).abs().max()),
        **timings(lambda: ops.prefix_power_sums(vals, shift),
                  lambda: ops.prefix_power_sums(vals, shift, use_kernel=False)),
        earlier_ms=time_ms(lambda: prefix_power_sums(vals, shift, threads=0))[0],
        bound_ms=b[0], bound_by=b[1],
    )


def request_tables_record(bundle, dev) -> dict:
    """``prefix_power_sums`` on request 0's buffers at its cap bucket, with
    the shift the executor takes: the shape the incremental path gives it."""
    from repro_torch.data.store import bucket_size

    p, req = bundle.pipeline, bundle.requests[0]
    cap = bucket_size(int(max(p.group_sizes(bundle.store, req).max(), 1)))
    vals, _ = bundle.store.request_buffers(p.agg_specs(req), cap, dev)
    return prefix_record(vals, vals[:, 0].contiguous(), full=False)


def tree_tables(ens) -> tuple:
    return ens.feature, ens.threshold, ens.left, ens.right, ens.value


def tree_check(ens, ms, dev, rng, n_feat: int = 9) -> float:
    """``ensemble_sum`` on random (m, n_feat) rows for each m of ``ms``: the
    smem path twice (bitwise equal), the global path (the earlier design),
    both bitwise the plain version's.  Returns max |kernel - plain|."""
    from repro_torch.kernels import build
    from repro_torch.kernels.tree_qmc.ops import predict_sum
    from repro_torch.kernels.tree_qmc.tree_qmc import Plan, ensemble_sum

    err = 0.0
    for m in ms:
        x = torch.from_numpy(rng.normal(0, 1, (m, n_feat)).astype(np.float32)).to(dev)
        build.reset_launch_counts()
        a, a2 = predict_sum(ens, x), predict_sum(ens, x)
        g = ensemble_sum(*tree_tables(ens), x, depth=ens.depth, launch=Plan(0, 0, 0, 0))
        want = predict_sum(ens, x, use_kernel=False)
        require(build.PATHS == {"ensemble_sum.smem": 2, "ensemble_sum.global": 1},
                f"ensemble_sum at m={m}: took {dict(build.PATHS)}, expected the smem path")
        require(torch.equal(a, a2), f"ensemble_sum not bitwise stable at m={m}")
        require(torch.equal(a, want), f"ensemble_sum differs from plain at m={m}")
        require(torch.equal(g, want), f"ensemble_sum global path differs from plain at m={m}")
        err = max(err, float((a - want).abs().max()), float((g - want).abs().max()))
    build.reset_launch_counts()
    return err


def tree_record(ens, m: int, dev, rng, n_feat: int = 9) -> dict:
    """``ensemble_sum`` on m rows: the smem path timed beside the global path
    (the earlier design, ``earlier_ms``) and the plain version; bounded by the
    bytes it must move (x and the five tables read, the sums written) and by
    m·T·(2·depth + 1) operations, beside its m·T·depth node visits."""
    from repro_torch.kernels.tree_qmc.ops import predict_sum
    from repro_torch.kernels.tree_qmc.tree_qmc import Plan, ensemble_sum, plan

    (T, M), F = ens.feature.shape, n_feat
    x = torch.from_numpy(rng.normal(0, 1, (m, F)).astype(np.float32)).to(dev)
    p = plan(T, M, F, m, torch.cuda.get_device_properties(dev).multi_processor_count)
    require(p.path == "smem", f"ensemble_sum {T}x{M} at m={m} is not planned on the smem path")
    b = bound(m * F * 4 + 5 * T * M * 4 + m * 4, m * T * (2 * ens.depth + 1))
    return dict(
        shape=[m, F, T, M], depth=ens.depth, node_visits=m * T * ens.depth,
        plan=dict(p._asdict(), blocks=p.cluster * p.clusters),
        **timings(lambda: predict_sum(ens, x), lambda: predict_sum(ens, x, use_kernel=False)),
        earlier_ms=time_ms(lambda: ensemble_sum(*tree_tables(ens), x, depth=ens.depth,
                                                launch=Plan(0, 0, 0, 0)))[0],
        bound_ms=b[0], bound_by=b[1],
    )


# the executors' one-launch QMC grids (max(m, m_sobol), 2k) at BiathlonConfig()'s
# m = 1000, m_sobol = 256 (k = 3 trip_fare, fraud_detection; 1 tick_price; 10
# battery; 9 turbofan; 8 bearing_imbalance; 21 student_qa; 5 sensor_health)
# and the LM head's (m = 400, m_sobol = 96, k = 3); then a grid where the
# arithmetic shows
SOBOL_GRIDS = [(1000, 18), (1000, 6), (1000, 2), (1000, 20), (1000, 16), (1000, 42),
               (1000, 10), (400, 6), (65536, 64)]
SOBOL_SKIPS = (0, 12345, 2**32 - 50)   # the last wraps the index past 2^32


def sobol_engine_points(m: int, d: int) -> torch.Tensor:
    """(m, d) uint32 points (int64) from ``torch.quasirandom.SobolEngine``, a
    yardstick the port never calls: ``draw`` gives x·2^-32 exactly in float64."""
    draw = torch.quasirandom.SobolEngine(d, scramble=False).draw(m, dtype=torch.float64)
    return (draw * 2.0**32).to(torch.int64)


def sobol_record(dev) -> dict:
    """``sobol_points`` at every served grid and at (65536, 64).

    Each grid at each of :data:`SOBOL_SKIPS`: the points (the runs path at
    its planned run length), the uniforms written in the same pass and the
    direct path (the earlier design) bitwise the plain version's; at 0 also
    ``SobolEngine``'s points; on (1000, 42) near 2^32 every run length.
    Timed at skip 0 as the executor calls it (uniforms): graph replay,
    eager, the direct path (``earlier_ms``), the plain version, and
    ``SobolEngine(d).draw(m)`` plus the copy to the card (``library_ms``,
    host wall time of the two, as a caller pays them); bounded by 4 bytes a
    value written and the direction numbers read once, two operations (an
    XOR, a ctz) a value.
    """
    from repro_torch.kernels import build
    from repro_torch.kernels.sobol.ops import points, to_uniforms, uniforms
    from repro_torch.kernels.sobol.sobol import MAX_RUN, plan, sobol_points

    grids, err = [], 0
    for m, d in SOBOL_GRIDS:
        for skip in SOBOL_SKIPS:
            build.reset_launch_counts()
            got, u = points(m, d, skip, device=dev), uniforms(m, d, skip, device=dev)
            direct = sobol_points(m, d, skip, device=dev, run=0)
            require(build.PATHS == {"sobol_points.runs": 2, "sobol_points.direct": 1},
                    f"sobol_points {(m, d, skip)} took {dict(build.PATHS)}")
            want = points(m, d, skip, device=dev, use_kernel=False)
            err = max(err, int((got - want).abs().max()))
            require(torch.equal(got, want), f"sobol_points differs from plain at {(m, d, skip)}")
            require(torch.equal(direct, want), f"sobol_points direct path differs at {(m, d, skip)}")
            require(torch.equal(bits(u), bits(to_uniforms(want))),
                    f"sobol_points uniforms differ from plain at {(m, d, skip)}")
        require(torch.equal(sobol_engine_points(m, d),
                            points(m, d, 0, device=dev, use_kernel=False).cpu()),
                f"SobolEngine's points differ from the plain version's at {(m, d)}")
        b = bound(m * d * 4 + d * 32 * 4, m * d * 2)
        library = lambda: sobol_engine_points(m, d).to(dev)  # noqa: E731
        library()
        grids.append(dict(
            shape=[m, d], run=plan(m, d),
            **timings(lambda: uniforms(m, d, device=dev),
                      lambda: uniforms(m, d, device=dev, use_kernel=False)),
            earlier_ms=time_ms(lambda: sobol_points(m, d, device=dev, run=0))[0],
            library_ms=wall_ms({"library": library})["library"],
            bound_ms=b[0], bound_by=b[1]))
    m, d, skip = 1000, 42, 2**32 - 50
    want = points(m, d, skip, device=dev, use_kernel=False)
    for run in range(1, MAX_RUN + 1):
        got = sobol_points(m, d, skip, device=dev, run=run).to(torch.int64) & 0xFFFFFFFF
        require(torch.equal(got, want), f"sobol_points run {run} differs at {(m, d, skip)}")
    build.reset_launch_counts()
    return dict(grids[0], grids=grids[1:], max_abs_err=float(err),
                phases=["bitwise_points_uniforms_direct_9_grids_3_skips", "skip_wraps_2^32",
                        "sobol_engine_bitwise", "every_run_length_1000x42"])


def check_kernels(dev, bundle, alpha: float) -> dict:
    """Each kernel against its plain version; returns per-kernel records."""
    from repro_torch.kernels import build
    from repro_torch.kernels.sampled_agg import ops
    from repro_torch.models.tabular.trees import GradientBoosting

    rf_ensemble = bundle.pipeline.model.ensemble
    rec = {}
    rng = np.random.default_rng(0)

    rec["sobol_points"] = sobol_record(dev)

    # prefix_power_sums / sampled_moments at 60k heavy-tailed rows vs float64
    v = heavy_tailed()
    t = torch.from_numpy(v[None]).to(dev)
    want64 = np.stack([(v.astype(np.float64) ** p).cumsum() for p in range(1, 5)], axis=-1)
    build.reset_launch_counts()
    tab = ops.prefix_power_sums(t)[0].cpu().numpy()
    require(build.PATHS == {"prefix_power_sums.chunks": 1},
            f"prefix_power_sums at 60k rows took {dict(build.PATHS)}, expected chunks")
    require((np.abs(tab - want64) / np.abs(want64)).max() < 1e-6,
            "prefix_power_sums: 60k heavy-tailed row not within 1e-6 of float64")
    build.reset_launch_counts()
    mom = ops.moments(t, torch.tensor([v.size], device=dev))[0].cpu().numpy()
    require(build.PATHS == {"sampled_moments.cluster": 1},
            f"sampled_moments at 60k rows took {dict(build.PATHS)}, expected the cluster path")
    require((np.abs(mom[1:] - want64[-1]) / np.abs(want64[-1])).max() < 1e-6
            and mom[0] == v.size,
            "sampled_moments: 60k heavy-tailed row not within 1e-6 of float64")

    # the serving shapes: k = 9, cap 32768 (incremental) and random z (rescan)
    k, cap = 9, 32768
    vals = torch.from_numpy(rng.normal(1.0, 3.0, (k, cap)).astype(np.float32)).to(dev)
    shift = vals[:, 0].contiguous()
    rec["prefix_power_sums"] = dict(prefix_record(vals, shift), phases=[
        "f64_60k", "plain_9x32768", "bitwise_stable", "emulation_bitwise", "rows_path_plain",
        "plain_3x65536_lm_head", "plain_sensor_health_request_0"])
    # the LM head's (3, 65536) tables
    lm = torch.from_numpy(rng.normal(1.0, 3.0, (3, 65536)).astype(np.float32)).to(dev)
    rec["prefix_power_sums"]["lm_head"] = prefix_record(lm, lm[:, 0].contiguous())
    z = torch.from_numpy(rng.integers(0, cap + 1, k).astype(np.int32)).to(dev)
    z[0] = 0
    got, err = moments_check(vals, z, shift, "(9, 32768) at random z")
    require(bool((got[0] == 0).all()), "sampled_moments: a z = 0 row is not all-zero")
    rec["sampled_moments"] = dict(
        moments_record(bundle, dev, alpha), sweep=moments_sweep(dev, rng),
        phases=["f64_60k", "plain_9x32768_random_z", "zero_rows", "request_0_z0",
                "bitwise_stable", "emulation_bitwise", "rows_path_plain",
                "sweep_z1051_full_9x32768_full_3x65536"],
    )
    rec["sampled_moments"]["max_abs_err"] = max(
        [err, rec["sampled_moments"]["max_abs_err"]]
        + [r["max_abs_err"] for r in rec["sampled_moments"]["sweep"]])

    # ensemble_sum: the turbofan forest and a 60 x 63 (depth 5) boosted model
    X = rng.normal(0, 1, (2000, 9)).astype(np.float32)
    gbm = GradientBoosting(n_trees=60, max_depth=5, learning_rate=0.15).fit(
        X, X[:, 0] * 2 + np.sin(3 * X[:, 1])).to(dev)
    require(tuple(gbm.ensemble.feature.shape) == (60, 63), "GBM shape is not 60 x 63")
    require(tuple(rf_ensemble.feature.shape) == (40, 511) and rf_ensemble.depth == 8,
            "turbofan forest is not 40 x 511, depth 8")
    # every served megabatch (z⁰, the Saltelli block, an iteration: turbofan
    # 1001 / 2816 / 3817, sensor_health 1001 / 1792 / 2793, trip_fare and
    # fraud_detection 1280 / 2281, battery 3072 / 4073) and more; student_qa's
    # own forest (21 features, up to 6889 rows) is checked in its phase
    err = max(tree_check(ens, (4073, 3817, 3072, 2816, 2793, 2281, 1792, 1280, 1001, 881, 1),
                         dev, rng)
              for ens in (rf_ensemble, gbm.ensemble))
    rec["ensemble_sum"] = dict(
        tree_record(rf_ensemble, 3817, dev, rng),
        gbm=tree_record(gbm.ensemble, 2793, dev, rng),
        max_abs_err=err,
        phases=["rf_40x511", "gbm_60x63",
                "m_4073_3817_3072_2816_2793_2281_1792_1280_1001_881_1", "bitwise_stable",
                "bitwise_plain", "global_path_bitwise_plain"],
    )
    return rec


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bits, so that −0.0 and +0.0 (or two NaNs) differ."""
    return t.view(torch.int32)


def select_check(vh, z, targets, name: str) -> tuple[torch.Tensor, float]:
    """``masked_select_ranks`` through the executor's entry point: on the
    radix path, its int32 bits equal to the launch before's and to the plain
    version's, and the rank path's (the earlier design) too.  Returns the
    output and max |kernel - plain| over the outputs whose bits differ."""
    from repro_torch.kernels import build
    from repro_torch.kernels.sampled_agg import ops
    from repro_torch.kernels.sampled_agg.quantile_select import Plan, masked_select_ranks

    build.reset_launch_counts()
    got, again = ops.select_ranks(vh, z, targets), ops.select_ranks(vh, z, targets)
    require(build.PATHS == {"masked_select_ranks.radix": 2},
            f"masked_select_ranks {name} took {dict(build.PATHS)}, expected the radix path")
    plain = ops.select_ranks(vh, z, targets, use_kernel=False)
    same = bits(got) == bits(plain)
    err = float(torch.where(same, 0.0, (got - plain).abs()).max())
    require(bool(same.all()), f"masked_select_ranks {name} differs from plain (max |err| {err})")
    require(torch.equal(bits(again), bits(got)), f"masked_select_ranks {name}: two launches differ")
    earlier = masked_select_ranks(vh, z, targets, launch=Plan(0, 0))
    require(torch.equal(bits(earlier), bits(plain)),
            f"masked_select_ranks {name}: rank path differs")
    return got, err


def select_timed(vh, z, targets, reps: int = 20) -> dict:
    """The radix path, the rank path (``earlier_ms``), the plain version and
    ``torch.sort`` + ``take_along_dim`` (a yardstick of two calls that the
    port never makes, checked bitwise) timed on one input, with the bound."""
    from repro_torch.kernels.sampled_agg import ops
    from repro_torch.kernels.sampled_agg.quantile_select import Plan, masked_select_ranks, plan

    h, cap = vh.shape
    r = targets.shape[1]
    cols = torch.arange(cap, device=vh.device)
    padded = torch.where(cols[None, :] < z[:, None], vh, torch.inf)
    clipped = torch.clamp(targets.to(torch.int64), 0, cap - 1)
    sort_gather = lambda: torch.take_along_dim(  # noqa: E731
        torch.sort(padded, dim=1, stable=True).values, clipped, dim=1)
    require(torch.equal(bits(sort_gather()), bits(ops.select_ranks(vh, z, targets))),
            "sort + gather disagrees with the kernel")
    # live prefix, z and targets read once, (h, R) written; a selection does no arithmetic
    b = bound(int(z.sum()) * 4 + h * 4 + h * r * 4 + h * r * 4, 0)
    return dict(
        **timings(lambda: ops.select_ranks(vh, z, targets),
                  lambda: ops.select_ranks(vh, z, targets, use_kernel=False)),
        earlier_ms=time_ms(lambda: masked_select_ranks(vh, z, targets, launch=Plan(0, 0)),
                           reps)[0],
        sort_gather_ms=time_ms(sort_gather, reps)[0], plan=list(plan(cap)),
        bound_ms=b[0], bound_by=b[1],
    )


def select_record(bundle, dev, cfg) -> dict:
    """``masked_select_ranks`` on the inputs of the rescan's z⁰ evaluation.

    Request 0's holistic buffers at its cap bucket, the plan z⁰ and the
    (h, 1 + B) rank targets that evaluation draws (key ``fold_in(PRNGKey(0),
    0)``).  Checked bitwise (:func:`select_check`) and timed
    (:func:`select_timed`).
    """
    from repro_torch.core import threefry
    from repro_torch.core.executor_fused import pipeline_executor_kwargs
    from repro_torch.core.planner import initial_plan
    from repro_torch.data.store import bucket_size
    from repro_torch.kernels.sampled_agg import ops

    p, req = bundle.pipeline, bundle.requests[0]
    cap = bucket_size(int(max(p.group_sizes(bundle.store, req).max(), 1)))
    vals, sizes = bundle.store.request_buffers(p.agg_specs(req), cap, dev)
    kw = pipeline_executor_kwargs(p.agg_features, dev)
    hol = torch.tensor(kw["holistic"], device=dev)
    qs = torch.tensor(kw["quantiles"], dtype=torch.float32, device=dev)
    vh = vals[hol]
    z = initial_plan(sizes, cfg.alpha)[hol]
    key = threefry.fold_in(threefry.PRNGKey(0), 0)
    targets = ops.bootstrap_rank_targets(z, qs, key, cfg.n_bootstrap)
    got, err = select_check(vh, z, targets, f"request 0 at cap {cap}")
    require(bool(torch.isfinite(got).all()), "masked_select_ranks: a z⁰ target selected +inf")
    h, r = targets.shape
    return dict(shape=[h, cap, r], z=z.cpu().tolist(), max_abs_err=err,
                **select_timed(vh, z, targets))


def select_sweep(dev, h: int = 3, r: int = 257) -> list:
    """The kernel over longer prefixes than z⁰: 4096 and 16384 at
    sensor_health's cap 16384, full 32768 and full 65536 (the LM head's
    bucket), values with ties and targets inside the prefix."""
    out = []
    for cap, zr in ((16384, 4096), (16384, 16384), (32768, 32768), (65536, 65536)):
        rng = np.random.default_rng(cap + zr)
        v = torch.from_numpy(np.round(rng.normal(0, 2, (h, cap)), 2).astype(np.float32)).to(dev)
        z = torch.full((h,), zr, dtype=torch.int32, device=dev)
        t = torch.from_numpy(rng.integers(0, zr, (h, r)).astype(np.int32)).to(dev)
        _, err = select_check(v, z, t, f"at cap {cap}, z {zr}")
        out.append(dict(shape=[h, cap, r], z=zr, max_abs_err=err,
                        **select_timed(v, z, t, 5 if zr > 16384 else 20)))
    return out


def wall_ms(fns: dict, reps: int = 10) -> dict:
    """Median host wall time (ms) of one call of each of ``fns`` followed by
    a synchronize, as a planner evaluation pays it before its predicate is
    read back (the operators' dispatch and their device time); the calls
    run in turns (each name, then the names in reverse), ``reps`` a turn,
    after one warm-up call each."""
    times = {name: [] for name in fns}
    for name, fn in fns.items():
        fn()
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[name]()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def afc_crossover(dev, cfg) -> list:
    """The rescan against the incremental AFC, per cap bucket, on synthetic
    buffers of the two pipelines' shapes (k = 9 parametric features;
    k = 5 of which 3 holistic, a median, a median and a p90), group sizes
    drawn in (cap/2, cap], at the plan z⁰: the incremental path's set-up
    once a request (``prefix_power_sums`` and, for holistic features, the
    rank index over the plan ladder) and its cost an evaluation, against the
    rescan's cost an evaluation (``sampled_moments``, ``masked_select_ranks``
    and the bootstrap), host wall times (:func:`wall_ms`), and device times
    under graph replay (:func:`time_ms`; what a captured program pays, the
    bootstrap keyed by a device tensor as the executor keys it).
    ``crossover_evals`` (``crossover_evals_device``): the evaluations a
    request above which the incremental path costs less (None: never)."""
    from repro_torch.core import threefry
    from repro_torch.core.planner import gamma_abs, initial_plan
    from repro_torch.data.aggregates import estimates_from_power_sums
    from repro_torch.kernels.sampled_agg import ops
    from repro_torch.kernels.sampled_agg.prefix_stats import (
        build_rank_index,
        prefix_moments_at,
        select_ranks_indexed,
    )

    rng = np.random.default_rng(17)
    key = torch.from_numpy(ops.mt_keys(threefry.fold_in(threefry.PRNGKey(0), 1))
                           .astype(np.int64)).to(dev)
    out = []
    for name, k, h in (("parametric", 9, 0), ("holistic", 5, 3)):
        for cap in (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536):
            vals = torch.from_numpy(rng.normal(1.0, 3.0, (k, cap)).astype(np.float32)).to(dev)
            n = torch.from_numpy(rng.integers(cap // 2 + 1, cap + 1, k).astype(np.int32)).to(dev)
            agg = torch.zeros((k,), dtype=torch.int32, device=dev)    # AVG; the sums are the same
            z = initial_plan(n, cfg.alpha)
            shift = vals[:, 0].contiguous()
            vh, nh, zh = vals[:h].contiguous(), n[:h], z[:h]
            qs = torch.tensor([0.5, 0.5, 0.9][:h], dtype=torch.float32, device=dev)
            ladder = torch.arange(cfg.max_iters + 1, dtype=torch.int32, device=dev)
            zcand = torch.minimum(z[:h, None] + ladder[None, :] * gamma_abs(n, cfg.gamma),
                                  nh[:, None])

            def setup():
                ptab = ops.prefix_power_sums(vals, shift)
                return ptab, build_rank_index(vh, nh, zcand) if h else None

            ptab, rindex = setup()

            def incremental():
                estimates_from_power_sums(prefix_moments_at(ptab, z), z, n, agg, shift)
                if h:
                    t = ops.bootstrap_rank_targets(zh, qs, key, cfg.n_bootstrap)
                    ops.finish_quantile_estimates(select_ranks_indexed(rindex, zh, t), zh, nh)

            def rescan():
                ops.masked_estimates(vals, z, n, agg)
                if h:
                    ops.masked_quantile_estimates(vh, zh, nh, qs, key, cfg.n_bootstrap)

            fns = {"setup": setup, "incremental": incremental, "rescan": rescan}
            t = wall_ms(fns)
            r = dict(pipeline=name, k=k, holistic=h, cap=cap, z0_max=int(z.max()),
                     setup_ms=t["setup"], incremental_eval_ms=t["incremental"],
                     rescan_eval_ms=t["rescan"])
            gain = r["rescan_eval_ms"] - r["incremental_eval_ms"]
            r["crossover_evals"] = r["setup_ms"] / gain if gain > 0 else None
            dt = {n: time_ms(fn, 5)[0] for n, fn in fns.items()}
            r.update(setup_device_ms=dt["setup"], incremental_eval_device_ms=dt["incremental"],
                     rescan_eval_device_ms=dt["rescan"])
            gain = dt["rescan"] - dt["incremental"]
            r["crossover_evals_device"] = dt["setup"] / gain if gain > 0 else None
            out.append(r)
    return out


# ---------------------------------------------------------------- phase 3/4
def serve_run(bundle, cfg, dev, *, afc_backend, use_kernel, n_req):
    """Build a server and serve ``n_req`` requests after a warm-up pass over
    the same requests (each cap bucket's graphs are captured at its first
    request, a set-up cost kept out of the timed pass).

    Returns (outputs, p50 latency seconds, launch counts of the whole run,
    launch counts of the server's construction alone).  The counts are
    reset once, before the server is built; the construction's are read
    when it returns, the whole run's after the last request.  The run's
    counts hold each kernel path's launches too (``build.PATHS``).
    """
    from repro_torch.kernels import build
    from repro_torch.serving import BiathlonServer

    torch.cuda.synchronize()
    build.reset_launch_counts()
    srv = BiathlonServer(bundle, cfg, afc_backend=afc_backend, device=dev,
                         use_kernel=use_kernel)
    at_build = dict(build.LAUNCHES)
    reqs = bundle.requests[:n_req]
    for r in reqs:  # warm-up
        srv.serve(r)
    outs = [srv.serve(r) for r in reqs]
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES) | dict(build.PATHS)
    return outs, statistics.median(o["latency"] for o in outs), launches, at_build


def profile_rows(prof, path: Path) -> tuple[list, list]:
    """``(all rows, device rows)`` of a profile, each ``(device us, name, count,
    host us)`` sorted by device time; the table is written to ``path``."""
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((float(dev_us), e.key, int(e.count), float(e.self_cpu_time_total)))
    rows.sort(reverse=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("self_device_us  count  self_cpu_us  name\n" + "\n".join(
        f"{d:14.1f} {c:6d} {h:12.1f}  {k}" for d, k, c, h in rows))
    # device activity (kernels, copies) has no host time of its own; host
    # operators carry their kernels' time too, so only the former is summed
    return rows, [r for r in rows if r[3] == 0.0 and r[0] > 0.0]


# the port's kernels by their symbols in a profile (the earlier designs' rows
# kernels left out)
KERNEL_SYMBOLS = {"::chunked_kernel<": "prefix_power_sums", "::cluster_kernel": "sampled_moments",
                  "::radix_kernel": "masked_select_ranks", "::smem_kernel(": "ensemble_sum",
                  "::global_kernel(": "ensemble_sum", "sobol_runs_kernel": "sobol_points",
                  "flash_attention_kernel": "flash_attention"}


def profile_served(serve_once, path: Path) -> dict:
    """Device time of one served request by kernel, from ``torch.profiler``.

    ``serve_once()`` serves the request and returns its output dict; it is
    called once to warm up, then once under the profiler.  Writes the table
    to ``path``; returns the device-busy total, the device time of the
    flash_attention kernel and the top entries.  The profiled latency
    carries the profiler's own overhead.
    """
    from torch.profiler import ProfilerActivity, profile

    serve_once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = serve_once()
        torch.cuda.synchronize()
    rows, device = profile_rows(prof, path)
    ours = {}
    for d_us, key, count, _ in device:
        kname = next((n for sym, n in KERNEL_SYMBOLS.items() if sym in key), None)
        if kname:
            ms, c = ours.get(kname, (0.0, 0))
            ours[kname] = (ms + d_us / 1e3, c + count)
    return dict(device_busy_ms=sum(r[0] for r in device) / 1e3,
                kernels_device=({n: dict(ms=ms, launches=c, ms_per_launch=ms / c)
                                 for n, (ms, c) in ours.items()}),
                device_launches=sum(r[2] for r in device),
                host_ops=sum(r[2] for r in rows if r[3] > 0.0), iters=out["iters"],
                flash_attention_device_ms=sum(r[0] for r in device
                                              if "flash_attention" in r[1]) / 1e3,
                profiled_latency_ms=out["latency"] * 1e3,
                top_device=[[k[:60], d / 1e3, c] for d, k, c, _ in device[:6]])


def profile_request(bundle, cfg, dev, request, path: Path, **kw) -> dict:
    """:func:`profile_served` of one request of a fresh server (``kw``:
    ``capture=False`` profiles the eager programs)."""
    from repro_torch.serving import BiathlonServer

    srv = BiathlonServer(bundle, cfg, device=dev, **kw)
    return profile_served(lambda: srv.serve(request), path)


def compare_runs(name, base, other, cfg):
    for i, (a, b) in enumerate(zip(base, other)):
        require(a["iters"] == b["iters"] and (a["z"] == b["z"]).all(),
                f"{name}: request {i} plan differs: {a['z']} x{a['iters']} vs "
                f"{b['z']} x{b['iters']}")
        require(abs(a["y_hat"] - b["y_hat"]) <= 1e-4 * max(1.0, abs(a["y_hat"])),
                f"{name}: request {i} y_hat {a['y_hat']} vs {b['y_hat']}")
    for i, o in enumerate(other):
        require(np.isfinite(o["y_hat"]), f"{name}: request {i} y_hat not finite")
        done = o["prob"] >= cfg.tau or (o["z"] == o["n"]).all() or o["iters"] == cfg.max_iters
        require(done, f"{name}: request {i} stopped with prob {o['prob']} < tau, plan left")


# the path every launch of a redesigned kernel must take on the served shapes
SERVED_PATHS = {"ensemble_sum": "smem", "prefix_power_sums": "chunks",
                "sampled_moments": "cluster", "masked_select_ranks": "radix",
                "sobol_points": "runs"}


def expect_launched(name, launches, kernels, absent=()):
    for kname in kernels:
        require(launches.get(kname, 0) > 0, f"{name}: kernel {kname} never launched")
    for kname in absent:
        require(launches.get(kname, 0) == 0, f"{name}: kernel {kname} launched off its path")
    for kname, path in SERVED_PATHS.items():
        require(launches.get(f"{kname}.{path}", 0) == launches.get(kname, 0),
                f"{name}: {kname} took {launches}, expected the {path} path on every launch")


# ------------------------------------------------------------------ phase 6
# the six other paper pipelines: model kind, task, and whether a tree
# ensemble (ensemble_sum) serves it
PAPER_PIPELINES = {
    "trip_fare": ("gradient boosting", "regression", True),
    "tick_price": ("linear", "regression", False),
    "battery": ("gradient boosting", "regression", True),
    "bearing_imbalance": ("MLP", "classification", False),
    "fraud_detection": ("gradient boosting", "classification", True),
    "student_qa": ("random forest", "classification", True),
}
N_PAPER = 4


def tight_config(pipeline):
    """The setting at which requests enter the planner loop: 0.3·δ for
    regression, τ = 0.99 for classification."""
    from repro_torch.core.executor import BiathlonConfig

    if pipeline.task == "classification":
        return BiathlonConfig(tau=0.99)
    return BiathlonConfig(delta=pipeline.delta_default * 0.3)


def paper_pipelines_phase(dev, cfg, card: str, rng) -> dict:
    """Each of the six other paper pipelines at full width (``make_pipeline``
    defaults), 4 requests through the kernels ("auto": incremental at these
    caps) and through the plain versions, at δ and at the tight setting:
    equal plans, iteration counts and classes; every kernel of the path
    launched on its redesigned path, none on the plain runs.  Then
    ``make_pipeline_median("trip_fare")`` under "ref" (the holistic rescan
    through ``masked_select_ranks``) against the plain versions.
    ``student_qa``'s forest (21 features) is held bitwise at its served
    megabatches and timed at 6889 rows, ``fraud_detection``'s boosted model
    at 2281; the tight classification request that iterated most is
    profiled."""
    from repro_torch.data.synthetic import make_pipeline, make_pipeline_median

    runs = {"auto": dict(afc_backend="auto", use_kernel=True),
            "plain": dict(afc_backend="auto", use_kernel=False)}
    out = {"serve": {}, "trees": {}}
    bundles = {}
    for name, (kind, task, trees) in PAPER_PIPELINES.items():
        t0 = time.perf_counter()
        bundle = bundles[name] = make_pipeline(name, device=dev)
        p = bundle.pipeline
        require(p.task == task, f"{name}: task {p.task}, expected {task}")
        build_s = time.perf_counter() - t0
        tight = tight_config(p)
        res = {key: serve_run(bundle, cfg, dev, n_req=N_PAPER, **kw) for key, kw in runs.items()}
        res.update({f"{key}_tight": serve_run(bundle, tight, dev, n_req=N_PAPER, **kw)
                    for key, kw in runs.items()})
        caps = sorted({o["cap"] for o in res["auto"][0]})
        require(min(caps) > 1024, f"{name}: caps {caps} do not take the incremental path")
        kernels = ["prefix_power_sums", "sobol_points"] + (["ensemble_sum"] if trees else [])
        absent = ["sampled_moments", "masked_select_ranks"] + ([] if trees else ["ensemble_sum"])
        for key in ("auto", "auto_tight"):
            expect_launched(f"{name} {key}", res[key][2], kernels, absent)
            require(res[key][3].get("sobol_points", 0) == 1,
                    f"{name} {key}: {res[key][3]} at the executor build, expected one "
                    "sobol_points launch")
        for key in ("plain", "plain_tight"):
            require(not res[key][2], f"{name} {key} launched kernels {res[key][2]}")
        compare_runs(f"{name} auto vs plain", res["plain"][0], res["auto"][0], cfg)
        compare_runs(f"{name} tight auto vs plain", res["plain_tight"][0],
                     res["auto_tight"][0], tight)
        if task == "classification":
            for o in res["auto"][0] + res["auto_tight"][0]:
                require(o["y_hat"] in (0.0, 1.0), f"{name}: y_hat {o['y_hat']} is not a class")
        for key, (outs, p50, launches, _) in res.items():
            print(f"serve {name} {key}: p50 {p50 * 1e3:.3f} ms over {len(outs)} requests, "
                  f"iters {[o['iters'] for o in outs]}, caps {sorted({o['cap'] for o in outs})}, "
                  f"launches {launches} [{card}]", flush=True)
        out["serve"][name] = dict(
            model=kind, task=task, k=p.k, rows=bundle.table_rows, build_s=build_s,
            megabatch=cfg.m + 1 + (p.k + 2) * cfg.m_sobol,
            **{key: dict(p50_ms=p50 * 1e3, iters=[o["iters"] for o in outs], launches=launches)
               for key, (outs, p50, launches, _) in res.items()})

    student = bundles["student_qa"].pipeline.model.ensemble
    require(tuple(student.feature.shape) == (40, 511), "student_qa forest is not 40 x 511")
    out["trees"]["student_qa"] = dict(
        tree_record(student, 6889, dev, rng, n_feat=21),
        max_abs_err=tree_check(student, (6889, 5888, 1001, 1), dev, rng, n_feat=21))
    fraud = bundles["fraud_detection"].pipeline.model.ensemble
    out["trees"]["fraud_detection"] = dict(
        tree_record(fraud, 2281, dev, rng, n_feat=9),
        max_abs_err=tree_check(fraud, (2281, 1280, 1001), dev, rng, n_feat=9))

    # the tight classification request that iterated most
    name, busiest = max(
        ((n, i) for n, (_, task, _) in PAPER_PIPELINES.items() if task == "classification"
         for i in range(N_PAPER)),
        key=lambda ni: out["serve"][ni[0]]["auto_tight"]["iters"][ni[1]])
    tight = tight_config(bundles[name].pipeline)
    out["profile_classification"] = dict(
        profile_request(bundles[name], tight, dev, bundles[name].requests[busiest],
                        ROOT / "build" / "chip_smoke_profile_classification.txt"),
        pipeline=name, request=busiest, tau=tight.tau)
    print(f"profile of {name} tight request {busiest}: "
          f"{json.dumps(out['profile_classification'])} [{card}]", flush=True)

    median = make_pipeline_median("trip_fare", device=dev)
    res = {"ref": serve_run(median, cfg, dev, afc_backend="ref", use_kernel=True, n_req=N_PAPER),
           "plain": serve_run(median, cfg, dev, afc_backend="ref", use_kernel=False,
                              n_req=N_PAPER)}
    expect_launched("trip_fare_median ref", res["ref"][2],
                    ["masked_select_ranks", "sampled_moments", "ensemble_sum", "sobol_points"],
                    ["prefix_power_sums"])
    require(not res["plain"][2], f"trip_fare_median plain launched kernels {res['plain'][2]}")
    compare_runs("trip_fare_median ref vs plain", res["plain"][0], res["ref"][0], cfg)
    for key, (outs, p50, launches, _) in res.items():
        print(f"serve trip_fare_median {key}: p50 {p50 * 1e3:.3f} ms over {len(outs)} requests, "
              f"iters {[o['iters'] for o in outs]}, caps {sorted({o['cap'] for o in outs})}, "
              f"launches {launches} [{card}]", flush=True)
    out["serve"]["trip_fare_median"] = {
        key: dict(p50_ms=p50 * 1e3, iters=[o["iters"] for o in outs], launches=launches)
        for key, (outs, p50, launches, _) in res.items()}
    out["bundles"] = bundles
    return out


# ------------------------------------------------------------------ phase 8
BATCH_LANES = 8
BATCH_PIPELINES = ("turbofan", "sensor_health", "fraud_detection", "student_qa")
BATCH_FILLS = (8, 3, 1)
BATCH_REPS = 3


def batch_knobs(pipeline, tight: bool, fill: int):
    """Per-lane knobs of a batch: none (the config's δ and τ) at δ; at the
    tight setting (:func:`tight_config`) every lane's."""
    if not tight:
        return None
    t = tight_config(pipeline)
    delta = pipeline.delta_default if t.delta is None else t.delta
    return [SimpleNamespace(delta=delta, tau=t.tau, iter_cap=t.max_iters)] * fill


def timed_batch(srv, reqs, knobs):
    """``(BatchResult, host seconds)`` of one ``serve_batch``, which returns
    once its results are on the host."""
    t0 = time.perf_counter()
    res = srv.serve_batch(reqs, knobs=knobs)
    return res, time.perf_counter() - t0


def compare_batches(name, base, other, *, bitwise: bool) -> None:
    """Equal plans and iterations; ŷ and prob bitwise, or ŷ within
    1e-4·max(1, |y|) and prob within 1e-4."""
    require((base.z == other.z).all() and (base.iters == other.iters).all(),
            f"{name}: plans differ: {base.z.tolist()} x{base.iters.tolist()} vs "
            f"{other.z.tolist()} x{other.iters.tolist()}")
    for field in ("y_hat", "prob"):
        a, b = getattr(base, field), getattr(other, field)
        if bitwise:
            same = np.array_equal(np.asarray(a, np.float32).view(np.int32),
                                  np.asarray(b, np.float32).view(np.int32))
        else:
            tol = 1e-4 * np.maximum(1.0, np.abs(a)) if field == "y_hat" else 1e-4
            same = bool((np.abs(a - b) <= tol).all())
        require(same, f"{name}: {field} {a.tolist()} vs {b.tolist()}")
    require(np.isfinite(other.y_hat).all(), f"{name}: y_hat not finite")


def profile_batch(srv, reqs, knobs, path: Path) -> dict:
    """:func:`profile_served` of one batch (warm)."""
    def once():
        res, dt = timed_batch(srv, reqs, knobs)
        return dict(iters=res.batch_iters, latency=dt)

    return profile_served(once, path)


def batched_servers(bundle, cfg, dev, afc_backend="auto") -> tuple[dict, dict]:
    """The batched server captured through the kernels (the main path), the
    same eagerly (``capture=False``) and captured through the plain versions;
    with the launches of the main path's build alone (counts reset just
    before it and read just after, before the comparison servers' builds)."""
    from repro_torch.kernels import build
    from repro_torch.serving import BatchedFusedServer

    kw = dict(batch_size=BATCH_LANES, afc_backend=afc_backend, device=dev)
    build.reset_launch_counts()
    srv = {"captured": BatchedFusedServer(bundle, cfg, **kw)}
    sync(dev)
    at_build = dict(build.LAUNCHES)
    srv["eager"] = BatchedFusedServer(bundle, cfg, capture=False, **kw)
    srv["plain"] = BatchedFusedServer(bundle, cfg, use_kernel=False, **kw)
    return srv, at_build


def batch_cell(name, srv, reqs, knobs, dev, card) -> dict:
    """One batch through the three servers of :func:`batched_servers`: each
    warmed at its bucket first; launch counts reset just before the captured
    kernel run and read just after; captured and eager bitwise equal, the
    plain versions' plans equal; then captured and eager timed in turns
    (captured, eager, eager, captured; :data:`BATCH_REPS` batches a turn)."""
    from repro_torch.kernels import build
    from repro_torch.serving import straggler_report

    _, first = timed_batch(srv["captured"], reqs, knobs)   # captures a new bucket
    for s in ("eager", "plain"):
        srv[s].serve_batch(reqs, knobs=knobs)
    sync(dev)
    build.reset_launch_counts()
    a, _ = timed_batch(srv["captured"], reqs, knobs)
    sync(dev)
    launches = dict(build.LAUNCHES) | dict(build.PATHS)
    b, _ = timed_batch(srv["eager"], reqs, knobs)
    c, _ = timed_batch(srv["plain"], reqs, knobs)
    compare_batches(f"{name} captured vs eager", b, a, bitwise=True)
    compare_batches(f"{name} kernels vs plain", c, a, bitwise=False)
    times = {"captured": [], "eager": []}
    for turn in ("captured", "eager", "eager", "captured"):
        for _ in range(BATCH_REPS):
            times[turn].append(timed_batch(srv[turn], reqs, knobs)[1])
    again, _ = timed_batch(srv["captured"], reqs, knobs)
    compare_batches(f"{name} captured after {4 * BATCH_REPS} more batches", a, again,
                    bitwise=True)
    fill = len(reqs)
    rec = dict(fill=fill, cap=a.cap, iters=a.iters.tolist(), batch_iters=a.batch_iters,
               first_captured_ms=first * 1e3,
               wasted_frac=straggler_report(a)["wasted_frac"], launches=launches)
    for turn, ts in times.items():
        p50 = statistics.median(ts)
        rec[f"{turn}_p50_ms"] = p50 * 1e3
        rec[f"{turn}_requests_per_s"] = fill / p50
    print(f"batched {name}: cap {a.cap}, iters {a.iters.tolist()}, p50 captured "
          f"{rec['captured_p50_ms']:.3f} ms ({rec['captured_requests_per_s']:.1f} req/s), eager "
          f"{rec['eager_p50_ms']:.3f} ms ({rec['eager_requests_per_s']:.1f} req/s), launches "
          f"{launches} [{card}]", flush=True)
    return rec


def lane_tree_check(ens, ms, dev, rng, n_feat: int) -> tuple[float, dict]:
    """``ensemble_sum`` on random (m, n_feat) rows for each m of ``ms``, on
    the path its plan picks for m: twice, bitwise equal, and bitwise the
    plain version.  Returns max |kernel - plain| and each m's path."""
    from repro_torch.kernels import build
    from repro_torch.kernels.tree_qmc.ops import predict_sum
    from repro_torch.kernels.tree_qmc.tree_qmc import plan

    (T, M), sms = ens.feature.shape, torch.cuda.get_device_properties(dev).multi_processor_count
    err, paths = 0.0, {}
    for m in ms:
        x = torch.from_numpy(rng.normal(0, 1, (m, n_feat)).astype(np.float32)).to(dev)
        p = plan(T, M, n_feat, m, sms)
        build.reset_launch_counts()
        a, a2 = predict_sum(ens, x), predict_sum(ens, x)
        require(build.PATHS == {f"ensemble_sum.{p.path}": 2},
                f"ensemble_sum {T}x{M} at m={m} took {dict(build.PATHS)}, expected {p.path}")
        want = predict_sum(ens, x, use_kernel=False)
        require(torch.equal(a, a2) and torch.equal(a, want),
                f"ensemble_sum {T}x{M} at the lanes' m={m} differs from plain or between launches")
        err, paths[str(m)] = max(err, float((a - want).abs().max())), p.path
    build.reset_launch_counts()
    return err, paths


def lane_tree_record(ens, m: int, dev, rng, n_feat: int) -> dict:
    """``ensemble_sum`` at a batch's megabatch of m rows, timed on its
    planned path and bounded as :func:`tree_record`."""
    from repro_torch.kernels.tree_qmc.ops import predict_sum
    from repro_torch.kernels.tree_qmc.tree_qmc import plan

    (T, M), F = ens.feature.shape, n_feat
    x = torch.from_numpy(rng.normal(0, 1, (m, F)).astype(np.float32)).to(dev)
    p = plan(T, M, F, m, torch.cuda.get_device_properties(dev).multi_processor_count)
    b = bound(m * F * 4 + 5 * T * M * 4 + m * 4, m * T * (2 * ens.depth + 1))
    return dict(shape=[m, F, T, M], path=p.path, plan=p._asdict(),
                **timings(lambda: predict_sum(ens, x),
                          lambda: predict_sum(ens, x, use_kernel=False)),
                bound_ms=b[0], bound_by=b[1])


def lane_inputs(bundle, dev, fill: int = BATCH_LANES):
    """The (8, k, cap) buffers and (8, k) sizes that ``serve_batch`` gathers
    for the bundle's first ``fill`` requests at their batch's cap: zeros in
    the pad lanes."""
    from repro_torch.data.store import HostStaging, bucket_size
    from repro_torch.serving import gather_lanes

    p, reqs = bundle.pipeline, bundle.requests[:fill]
    cap = bucket_size(max(int(p.group_sizes(bundle.store, r).max()) for r in reqs))
    vals, sizes, _ = gather_lanes(p, bundle.store, reqs, cap, BATCH_LANES, HostStaging(dev),
                                  policy="reject")
    return vals.to(dev), torch.from_numpy(sizes).to(dev)


#: lane_kernels' records keyed by case (pipeline, or pipeline_cap)
LANE_SHAPES_BY_CASE = ("prefix_power_sums", "ensemble_sum")


def lane_kernels(dev, bundles: dict, cfg, rng) -> dict:
    """Each kernel of the batched path at the shapes 8 lanes give it, held to
    its plain version and timed: ``prefix_power_sums`` on each batched
    pipeline's (8·k, cap) rows at the cap of each served fill where "auto"
    takes the incremental path (keyed by pipeline and cap); ``sampled_moments``
    on sensor_health's (40, cap) rows at z⁰; ``masked_select_ranks`` on its
    (24, cap) holistic rows at z⁰ with the (24, 257) targets of the lanes' z⁰
    keys; ``ensemble_sum`` on each batched pipeline's own forest at its z⁰
    evaluation 8·(m+1), its Saltelli block 8·(k+2)·m_sobol and its step
    megabatch 8·(m+1+(k+2)·m_sobol) rows (turbofan 8 × 3817 = 30536,
    student_qa 8 × 6889 = 55112), timed at the step megabatch."""
    from repro_torch.core import threefry
    from repro_torch.core.executor_fused import pipeline_executor_kwargs
    from repro_torch.core.planner import initial_plan
    from repro_torch.kernels.sampled_agg import ops

    out = {"prefix_power_sums": {}, "ensemble_sum": {}}
    for name in BATCH_PIPELINES:
        seen = set()
        for fill in BATCH_FILLS:
            vals, _ = lane_inputs(bundles[name], dev, fill)
            cap = vals.shape[-1]
            if cap in seen or not ops.resolve_afc_plan("auto", cap):
                continue
            seen.add(cap)
            rows = vals.reshape(-1, cap).contiguous()
            out["prefix_power_sums"][f"{name}_{cap}"] = prefix_record(rows, rows[:, 0].contiguous())
    prefix = out["prefix_power_sums"]
    require(prefix, "batched path: no pipeline takes the incremental path at a served cap")

    health = bundles["sensor_health"]
    vals, sizes = lane_inputs(health, dev)
    lanes, k, cap = vals.shape
    z = initial_plan(sizes, cfg.alpha)
    rows, zr = vals.reshape(lanes * k, cap).contiguous(), z.reshape(-1)
    shift = rows[:, 0].contiguous()
    _, err = moments_check(rows, zr, shift, f"lanes ({lanes * k}, {cap})")
    out["sampled_moments"] = dict(shape=[lanes * k, cap], max_abs_err=err,
                                  **moments_timed(rows, zr, shift))
    kw = pipeline_executor_kwargs(health.pipeline.agg_features, dev)
    hol = torch.tensor(kw["holistic"], device=dev)
    qs = torch.tensor(kw["quantiles"], dtype=torch.float32, device=dev)
    keys = torch.from_numpy(ops.mt_keys(threefry.fold_in(threefry.PRNGKey(0), 0))
                            .astype(np.int64)).to(dev).expand(lanes, 2, 4, 2, 2)
    targets = ops.bootstrap_rank_targets(z[:, hol], qs, keys, cfg.n_bootstrap)
    vh = vals[:, hol].reshape(-1, cap).contiguous()
    zh, th = z[:, hol].reshape(-1), targets.reshape(vh.shape[0], -1)
    _, err = select_check(vh, zh, th, f"lanes ({vh.shape[0]}, {cap})")
    out["masked_select_ranks"] = dict(shape=[vh.shape[0], cap, th.shape[1]], max_abs_err=err,
                                      **select_timed(vh, zh, th))
    for name in BATCH_PIPELINES:
        p = bundles[name].pipeline
        ens, n_feat = p.model.ensemble, p.k + len(p.exact_features)
        z0, sobol = BATCH_LANES * (cfg.m + 1), BATCH_LANES * (p.k + 2) * cfg.m_sobol
        err, paths = lane_tree_check(ens, (z0, sobol, z0 + sobol), dev, rng, n_feat)
        out["ensemble_sum"][name] = dict(lane_tree_record(ens, z0 + sobol, dev, rng, n_feat),
                                         max_abs_err=err, checked=paths)
    for kname, recs in out.items():
        for name, r in (recs.items() if kname in LANE_SHAPES_BY_CASE else [("", recs)]):
            print(f"lane shapes {kname} {name} {r['shape']}: {r['ms']:.5f} ms (eager "
                  f"{r['eager_ms']:.4f}, plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.6f}) "
                  f"[{dev}]", flush=True)
    return out


def batched_phase(dev, bundles: dict, cfg, card: str) -> dict:
    """``BatchedFusedServer`` (8 lanes) at full width on turbofan,
    sensor_health, fraud_detection and student_qa, at δ and at the tight
    setting, at fill 8, 3 and 1 (:func:`batch_cell`): captured and eager
    bitwise equal, the plain versions' plans equal, one capture a cap
    bucket; the tight fill-8 batch profiled captured and eager.  Then
    sensor_health under "ref" (the rescan: ``sampled_moments`` and
    ``masked_select_ranks``) at fill 8, tight.  Every kernel of the path
    must launch in the main path: the captured kernel server's build (the
    comparison servers' builds not counted) or its captured batches."""
    out, launched = {}, collections.Counter()
    cases = [(name, "auto") for name in BATCH_PIPELINES] + [("sensor_health", "ref")]
    for name, afc in cases:
        bundle = bundles[name]
        p = bundle.pipeline
        srv, at_build = batched_servers(bundle, cfg, dev, afc)
        rec = {"launches_at_build": at_build}
        launched.update(at_build)
        settings = ((True, 8),) if afc == "ref" else [(t, f) for t in (False, True)
                                                       for f in BATCH_FILLS]
        for tight, fill in settings:
            key = f"{'tight' if tight else 'delta'}_fill{fill}"
            cell = batch_cell(f"{name} {afc} {key}", srv, bundle.requests[:fill],
                              batch_knobs(p, tight, fill), dev, card)
            launched.update({kk: v for kk, v in cell["launches"].items() if "." not in kk})
            rec[key] = cell
        for s in srv.values():
            s.check_compile_contract()
        rec["buckets"] = srv["captured"].compiled_buckets
        if afc == "auto":
            for turn in ("captured", "eager"):
                prof = profile_batch(
                    srv[turn], bundle.requests[:BATCH_LANES],
                    batch_knobs(p, True, BATCH_LANES),
                    ROOT / "build" / f"chip_smoke_profile_batched_{name}_{turn}.txt")
                prof["idle_share"] = 1.0 - prof["device_busy_ms"] / prof["profiled_latency_ms"]
                rec[f"profile_{turn}"] = prof
                print(f"profile of batched {name} tight fill 8 {turn}: {json.dumps(prof)} "
                      f"[{card}]", flush=True)
        out[name if afc == "auto" else f"{name}_{afc}"] = rec
    for kname in ("prefix_power_sums", "sampled_moments", "masked_select_ranks",
                  "ensemble_sum", "sobol_points"):
        require(launched.get(kname, 0) > 0, f"batched path: {kname} never launched")
    out["launches"] = dict(launched)
    return out


# ------------------------------------------------------------------ phase 9
CACHE_SIZE = 64
CACHE_PIPELINES = ("turbofan", "sensor_health")
CACHE_REPS = 3


def with_store_copy(bundle):
    """The bundle over a deep copy of its store, so appends leave the
    original as it is."""
    return dataclasses.replace(bundle, store=copy.deepcopy(bundle.store))


def append_rows(table, gid, n: int, scale: float, src=None) -> None:
    """``n`` rows into group ``gid``: copies of the first rows of group
    ``src`` (default: ``gid``), float columns scaled."""
    start = int(table.group_ptr[table.group_ids[gid if src is None else src]])
    table.append({c: v[table.perm[start:start + n]] * (scale if v.dtype.kind == "f" else 1)
                  for c, v in table.columns.items()}, group_key=[gid] * n)


def served_launches(dev, fn) -> tuple:
    """``(fn(), launch counts)``: counts reset just before, read just after."""
    from repro_torch.kernels import build

    sync(dev)
    build.reset_launch_counts()
    out = fn()
    sync(dev)
    return out, dict(build.LAUNCHES) | dict(build.PATHS)


def cache_timings(dev, srv, single, plain_batch, plain_single, reqs, card) -> dict:
    """Per batch and per request: uncached, miss (the cache emptied first)
    and hit, in turns; then the pieces of a miss and a hit apart: the host
    gather into the pinned buffer, the copy to the card from pageable and
    from pinned memory, the slot's device-to-device copy of 8 entries,
    ``cold`` on 8 requests, the copy of its rows into 8 entries and one
    ``refresh`` event."""
    from repro_torch.data.store import HostStaging
    from repro_torch.serving.feature_cache import entry_rows

    p, store = srv.bundle.pipeline, srv.bundle.store
    cap = srv.batch_cap(reqs)

    def miss_batch():
        srv.cache._entries.clear()
        srv.serve_batch(reqs)

    def miss_single():
        single.cache._entries.clear()
        single.serve(reqs[0])

    out = {"batch_ms": wall_ms({"uncached": lambda: plain_batch.serve_batch(reqs),
                                "miss": miss_batch, "hit": lambda: srv.serve_batch(reqs)},
                               reps=CACHE_REPS),
           "request_ms": wall_ms({"uncached": lambda: plain_single.serve(reqs[0]),
                                  "miss": miss_single, "hit": lambda: single.serve(reqs[0])},
                                 reps=CACHE_REPS)}
    specs = [p.agg_specs(r) for r in reqs]
    staging = HostStaging(dev)
    buf = staging.gather(store, specs, cap, rows=BATCH_LANES)
    pageable = buf.numpy().copy()
    dst = torch.empty(buf.shape, device=dev)
    out.update(wall_ms({
        "gather": lambda: staging.release(staging.gather(store, specs, cap, rows=BATCH_LANES)),
        "h2d_pageable": lambda: dst.copy_(torch.from_numpy(pageable)),
        "h2d_pinned": lambda: dst.copy_(buf, non_blocking=True)}, reps=CACHE_REPS))
    out["h2d_bytes"] = buf.numel() * 4
    entries = srv.cache.get_many(specs, cap)
    ex = srv._run
    (slot,) = [s for key, s in ex._slots.items() if key[:2] == (BATCH_LANES, cap)]
    vals, ns, tables = ([e.vals for e in entries], [e.n for e in entries],
                        [e.tables for e in entries])
    out["slot_copy_ms"] = _events_ms(lambda: ex._load(slot, vals, ns, tables), 10)
    out["slot_copy_bytes"] = sum(t.numel() * t.element_size() for e in entries
                                 for t in (e.vals, e.n, e.tables.ptab, e.tables.shift,
                                           *e.tables.rindex))
    stacked, sizes = torch.stack(vals), torch.stack(ns)
    out["cold_ms"] = _events_ms(lambda: srv.cache.cold(stacked, sizes), 5)
    # a miss batch's entries copy their rows out of its tensors (device to device)
    built = srv.cache.cold(stacked, sizes)
    out["entry_copy_ms"] = _events_ms(lambda: entry_rows(stacked, sizes, built), 5)
    aff = np.ones(p.k, bool)
    x = np.ones(p.k, np.float32)
    e0 = entries[0]
    out["refresh_ms"] = _events_ms(
        lambda: srv.cache.refresh(e0.vals, e0.n, e0.tables, 7, x, aff), 5)
    print(f"feature cache {p.name} timings: {json.dumps(out)} [{card}]", flush=True)
    return out


def feature_cache_phase(dev, bundles: dict, small, cfg, card: str) -> dict:
    """The hot-group feature cache (``cache_size=64``) on full-width turbofan
    and sensor_health, each over a deep copy of its store: batches of 8 at δ
    and at the tight setting and 8 single requests, a miss pass then a hit
    pass, each bitwise the uncached captured server's; a hit launches no
    ``prefix_power_sums`` and builds no slot, a miss batch launches it once.
    Then 3 appends into each of two served groups, on the cached store and
    on an oracle copy: refreshes counted, plans equal to the oracle's and ŷ
    within 1e-3·max(1, |y|); an append into a new group (j = 0) rebuilt by
    ``cold``.  Then sensor_health cached under "ref" (the rescan kernels
    launch) and turbofan cached at 500 rows a group (``prefix_power_sums``
    at cap 512; plans equal to the uncached rescan's).  Timings in turns."""
    from repro_torch.serving import BatchedFusedServer, BiathlonServer

    out, launched = {}, collections.Counter()
    for name in CACHE_PIPELINES:
        cached_b, oracle_b = with_store_copy(bundles[name]), with_store_copy(bundles[name])
        p, reqs = cached_b.pipeline, cached_b.requests[:BATCH_LANES]
        plain = BatchedFusedServer(oracle_b, cfg, batch_size=BATCH_LANES, device=dev)
        plain_single = BiathlonServer(oracle_b, cfg, device=dev)
        (srv, single), at_build = served_launches(dev, lambda: (
            BatchedFusedServer(cached_b, cfg, batch_size=BATCH_LANES, cache_size=CACHE_SIZE,
                               device=dev),
            BiathlonServer(cached_b, cfg, cache_size=CACHE_SIZE, device=dev)))
        launched.update(at_build)
        rec = {}
        for tight in (False, True):
            knobs = batch_knobs(p, tight, BATCH_LANES)
            want = plain.serve_batch(reqs, knobs=knobs)
            srv.cache._entries.clear()
            slots = srv.compile_count
            miss, l_miss = served_launches(dev, lambda: srv.serve_batch(reqs, knobs=knobs))
            built = srv.compile_count - slots
            hit, l_hit = served_launches(dev, lambda: srv.serve_batch(reqs, knobs=knobs))
            key = "tight" if tight else "delta"
            for turn, res in (("miss", miss), ("hit", hit)):
                compare_batches(f"feature cache {name} {key} {turn} vs uncached", want, res,
                                bitwise=True)
            require(l_miss.get("prefix_power_sums", 0) == 1,
                    f"{name} {key}: a miss batch made {l_miss} prefix launches, not 1")
            require(l_hit.get("prefix_power_sums", 0) == 0
                    and srv.compile_count == slots + built,
                    f"{name} {key}: a hit batch launched {l_hit} or built a slot")
            expect_launched(f"feature cache {name} {key} miss", l_miss,
                            ["prefix_power_sums", "ensemble_sum"],
                            ["sampled_moments", "masked_select_ranks"])
            for lc in (l_miss, l_hit):
                launched.update({k: v for k, v in lc.items() if "." not in k})
            rec[key] = dict(iters=hit.iters.tolist(), cap=hit.cap, launches_miss=l_miss,
                            launches_hit=l_hit)
        # single requests: a miss pass, then a hit pass, each the uncached server's bits
        want = [plain_single.serve(r) for r in reqs]
        for turn in ("miss", "hit"):
            slots = single.compile_count
            got, lc = served_launches(dev, lambda: [single.serve(r) for r in reqs])
            compare_runs(f"feature cache {name} single {turn}", want, got, cfg)
            require(all(a["y_hat"] == b["y_hat"] and a["prob"] == b["prob"]
                        for a, b in zip(want, got)),
                    f"feature cache {name} single {turn}: not bitwise the uncached server")
            if turn == "hit":
                require(lc.get("prefix_power_sums", 0) == 0 and single.compile_count == slots,
                        f"{name} single hit pass launched {lc} or built a slot")
            launched.update({k: v for k, v in lc.items() if "." not in k})
        rec["single_stats"] = single.cache.stats
        rec["timings"] = cache_timings(dev, srv, single, plain, plain_single, reqs, card)
        prof = profile_batch(srv, reqs, None, ROOT / "build" /
                             f"chip_smoke_profile_feature_cache_{name}_hit.txt")
        prof["idle_share"] = 1.0 - prof["device_busy_ms"] / prof["profiled_latency_ms"]
        rec["profile_hit"] = prof
        print(f"profile of feature cache {name} hit batch: {json.dumps(prof)} [{card}]",
              flush=True)
        # appends: 3 rows into each of two served groups, on both stores
        f = p.agg_features[0]
        groups = list(dict.fromkeys(int(r[f.group_field]) for r in reqs))[:2]
        for store in (cached_b.store, oracle_b.store):
            for g in groups:
                append_rows(store[f.table], g, 3, 1.25)
        before = dict(srv.cache.stats)
        want = plain.serve_batch(reqs)
        got = srv.serve_batch(reqs)
        compare_batches(f"feature cache {name} after appends", want, got, bitwise=False)
        refreshed = srv.cache.refreshes - before["refreshes"]
        require(refreshed >= 1, f"{name}: appends refreshed nothing: {srv.cache.stats}")
        # an append into a new group draws j = 0: rebuilt by cold, not refreshed
        table = cached_b.store[f.table]
        new_gid = max(table.group_ids) + 1
        specs = [(t, c, new_gid) for t, c, _ in p.agg_specs(reqs[0]) if t == f.table]
        table.add_group(new_gid)
        srv.cache.get(specs, 64)                  # the empty group's all-pad entry
        append_rows(table, new_gid, 1, 1.0, src=groups[0])
        require(table.events_since(new_gid, 0)[0][0] == 0, f"{name}: the event is not j = 0")
        misses, refreshes = srv.cache.misses, srv.cache.refreshes
        entry = srv.cache.get(specs, 64)
        want_vals, want_n = cached_b.store.request_buffers(specs, 64, dev)
        require(srv.cache.misses == misses + 1 and srv.cache.refreshes == refreshes
                and torch.equal(entry.vals, want_vals) and torch.equal(entry.n, want_n),
                f"{name}: the j = 0 event was not rebuilt by cold: {srv.cache.stats}")
        rec.update(refreshed=refreshed, stats=srv.cache.stats, appended_groups=groups)
        shown = {k: v for k, v in rec.items() if k != "timings"}
        print(f"feature cache {name}: {json.dumps(shown)} [{card}]", flush=True)
        out[name] = rec
    # sensor_health cached under "ref": the rescan kernels read the cached buffers
    health = with_store_copy(bundles["sensor_health"])
    reqs, knobs = health.requests[:BATCH_LANES], batch_knobs(health.pipeline, True, BATCH_LANES)
    want = BatchedFusedServer(health, cfg, batch_size=BATCH_LANES, afc_backend="ref",
                              device=dev).serve_batch(reqs, knobs=knobs)
    ref_srv = BatchedFusedServer(health, cfg, batch_size=BATCH_LANES, afc_backend="ref",
                                 cache_size=CACHE_SIZE, device=dev)
    got, lr = served_launches(dev, lambda: ref_srv.serve_batch(reqs, knobs=knobs))
    compare_batches("feature cache sensor_health ref vs uncached ref", want, got, bitwise=True)
    expect_launched("feature cache sensor_health ref", lr,
                    ["sampled_moments", "masked_select_ranks", "prefix_power_sums"])
    launched.update({k: v for k, v in lr.items() if "." not in k})
    out["sensor_health_ref"] = dict(iters=got.iters.tolist(), launches=lr)
    # turbofan at 500 rows a group: cached, "auto" is incremental at cap 512
    from repro_torch.data.store import bucket_size

    small_c = with_store_copy(small)
    sp = small_c.pipeline
    reqs = [r for r in small_c.requests
            if bucket_size(int(sp.group_sizes(small_c.store, r).max())) == 512][:BATCH_LANES]
    require(reqs, "no reduced-depth request in the 512 bucket")
    want = BatchedFusedServer(small_c, cfg, batch_size=BATCH_LANES,
                              device=dev).serve_batch(reqs)
    sm_srv = BatchedFusedServer(small_c, cfg, batch_size=BATCH_LANES, cache_size=CACHE_SIZE,
                                device=dev)
    got, ls = served_launches(dev, lambda: sm_srv.serve_batch(reqs))
    require(got.cap == 512, f"reduced-depth cached cap {got.cap}, expected 512")
    compare_batches("feature cache reduced turbofan vs uncached rescan", want, got,
                    bitwise=False)
    expect_launched("feature cache reduced turbofan", ls, ["prefix_power_sums", "ensemble_sum"],
                    ["sampled_moments"])
    launched.update({k: v for k, v in ls.items() if "." not in k})
    out["turbofan_reduced"] = dict(iters=got.iters.tolist(), cap=got.cap, launches=ls,
                                   requests=reqs)
    out["launches"] = dict(launched)
    print(f"feature cache launches: {out['launches']} [{card}]", flush=True)
    return out


# ------------------------------------------------------------------ phase 7
N_HOST = 4
HOST_PIPELINES = ("turbofan", "sensor_health") + tuple(PAPER_PIPELINES)


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def host_serve_run(bundle, cfg, dev, *, mode="host", use_kernel=True, n_req=N_HOST,
                   compare_exact=True):
    """One warm-up request (and its exact baseline) in host mode, or in
    fused mode each request once (its cap bucket's graphs are captured at
    the bucket's first request, a set-up cost kept out of the measured
    pass), then ``serve_all(requests[:n_req], compare_exact)`` through the
    server's own entry point.  Returns ``(ServerStats, outputs of serve, launch counts)``:
    the counts are reset just before the server is built and read after the
    last request; the outputs are recorded by wrapping ``serve``."""
    from repro_torch.core import threefry
    from repro_torch.core.executor import run_exact
    from repro_torch.kernels import build
    from repro_torch.serving import BiathlonServer

    sync(dev)
    build.reset_launch_counts()
    srv = BiathlonServer(bundle, cfg, mode=mode, device=dev, use_kernel=use_kernel)
    reqs = bundle.requests[:n_req]
    for r in reqs if mode == "fused" else reqs[:1]:
        srv.serve(r, threefry.PRNGKey(99))
    if compare_exact:
        run_exact(bundle.store, bundle.pipeline, reqs[0], device=dev, use_kernel=use_kernel)
    outs, serve = [], srv.serve
    srv.serve = lambda req, key=None: outs.append(serve(req, key)) or outs[-1]
    stats = srv.serve_all(reqs, compare_exact=compare_exact)
    sync(dev)
    return stats, outs, dict(build.LAUNCHES) | dict(build.PATHS)


def compare_host_runs(name, plain, kernel, cfg, task):
    """Equal plans, iterations and classes (y_hat within 1e-4·max(1, |y|)),
    and equal exact answers, between the plain and the kernel path."""
    (ps, po, _), (ks, ko, _) = plain, kernel
    for i, (a, b) in enumerate(zip(po, ko)):
        require(a["iters"] == b["iters"] and (a["z"] == b["z"]).all(),
                f"{name}: request {i} plan differs: {a['z']} x{a['iters']} vs "
                f"{b['z']} x{b['iters']}")
        same = (a["y_hat"] == b["y_hat"] if task == "classification"
                else abs(a["y_hat"] - b["y_hat"]) <= 1e-4 * max(1.0, abs(a["y_hat"])))
        require(same, f"{name}: request {i} y_hat {a['y_hat']} vs {b['y_hat']}")
        require(np.isfinite(b["y_hat"]) and 0.0 <= b["prob"] <= 1.0,
                f"{name}: request {i} y_hat {b['y_hat']} prob {b['prob']}")
        done = b["prob"] >= cfg.tau or (b["z"] == b["n"]).all() or b["iters"] == cfg.max_iters
        require(done, f"{name}: request {i} stopped at prob {b['prob']} with plan left")
    for i, (a, b) in enumerate(zip(ps.y_exacts, ks.y_exacts)):
        require(abs(a - b) <= 1e-4 * max(1.0, abs(a)),
                f"{name}: request {i} exact answer {a} vs {b}")


def host_select_record(vals: torch.Tensor, z: int, q: float, key, reps: int = 20) -> dict:
    """``masked_select_ranks`` at the host loop's bootstrap shape: the 256
    resampled rows of one holistic feature's buffer (drawn as
    ``aggregates._bootstrap_replicates`` draws them), one target a row.
    Bitwise (int32 views) the plain version's and the launch before's, on the
    radix path; timed under graph replay and eagerly beside the plain version
    and ``torch.sort`` + ``take_along_dim`` (two calls the port never makes),
    with the bound: the live prefixes read once, z, targets and outputs."""
    from repro_torch.core import threefry
    from repro_torch.data.aggregates import _quantile_rank
    from repro_torch.kernels import build
    from repro_torch.kernels.sampled_agg import ops
    from repro_torch.kernels.sampled_agg.quantile_select import plan

    cap = vals.shape[0]
    zt = torch.full((), z, dtype=torch.int32, device=vals.device)
    u = threefry.uniform(key, (256, cap), device=vals.device)
    rows = vals[torch.floor(u * float(z)).to(torch.int64)]
    zr = zt.expand(256).contiguous()
    t = _quantile_rank(zt, q).expand(256, 1).contiguous()
    build.reset_launch_counts()
    got, again = ops.select_ranks(rows, zr, t), ops.select_ranks(rows, zr, t)
    require(build.PATHS == {"masked_select_ranks.radix": 2},
            f"masked_select_ranks (256, {cap}) z {z} took {dict(build.PATHS)}")
    plain = ops.select_ranks(rows, zr, t, use_kernel=False)
    same = bits(got) == bits(plain)
    err = float(torch.where(same, 0.0, (got - plain).abs()).max())
    require(bool(same.all()), f"masked_select_ranks (256, {cap}) z {z} differs from plain")
    require(torch.equal(bits(again), bits(got)), f"masked_select_ranks (256, {cap}): unstable")
    cols = torch.arange(cap, device=vals.device)
    padded = torch.where(cols[None, :] < zr[:, None], rows, torch.inf)
    clipped = torch.clamp(t.to(torch.int64), 0, cap - 1)
    sort_gather = lambda: torch.take_along_dim(  # noqa: E731
        torch.sort(padded, dim=1, stable=True).values, clipped, dim=1)
    require(torch.equal(bits(sort_gather()), bits(got)), "sort + gather disagrees with the kernel")
    b = bound(256 * z * 4 + 256 * 4 * 3, 0)
    build.reset_launch_counts()
    return dict(shape=[256, cap, 1], z=z, max_abs_err=err, plan=list(plan(cap)),
                **timings(lambda: ops.select_ranks(rows, zr, t),
                          lambda: ops.select_ranks(rows, zr, t, use_kernel=False)),
                sort_gather_ms=time_ms(sort_gather, reps)[0], bound_ms=b[0], bound_by=b[1])


def host_sobol_record(dev, m: int, d: int, key, reps: int = 20) -> dict:
    """``sobol_points`` at one of the host loop's grids, as it calls it:
    ``points(m, d, 0)`` (the runs path, rebuilt at every call), bitwise the
    plain version's as int64 and the launch before's; the keyed uniforms
    ``to_uniforms(digital_shift(key, points))`` bitwise (int32 views) the
    plain version's, and so is ``qmc_uniforms(m, d, key)``, the executor's
    call.  Timed under graph replay and eagerly beside the plain version
    (``points``), and the keyed chain eagerly beside its plain version;
    bounded as :func:`sobol_record` bounds a grid."""
    from repro_torch.core.propagation import qmc_uniforms
    from repro_torch.core.qmc import digital_shift
    from repro_torch.kernels import build
    from repro_torch.kernels.sobol.ops import points, to_uniforms
    from repro_torch.kernels.sobol.sobol import plan

    build.reset_launch_counts()
    got, again = points(m, d, 0, device=dev), points(m, d, 0, device=dev)
    u = qmc_uniforms(m, d, key, device=dev)
    require(build.PATHS == {"sobol_points.runs": 3},
            f"sobol_points {(m, d)} took {dict(build.PATHS)}, expected the runs path")
    want = points(m, d, 0, device=dev, use_kernel=False)
    require(torch.equal(got, want), f"sobol_points differs from plain at host grid {(m, d)}")
    require(torch.equal(again, got), f"sobol_points not bitwise stable at host grid {(m, d)}")
    shifted = bits(to_uniforms(digital_shift(key, want)))
    require(torch.equal(bits(to_uniforms(digital_shift(key, got))), shifted),
            f"shifted uniforms of the kernel's points differ from plain at {(m, d)}")
    keyed_plain = lambda: qmc_uniforms(m, d, key, device=dev, use_kernel=False)  # noqa: E731
    require(torch.equal(bits(keyed_plain()), shifted), f"plain qmc_uniforms differs at {(m, d)}")
    require(torch.equal(bits(u), shifted), f"qmc_uniforms with a key differs at {(m, d)}")
    b = bound(m * d * 4 + d * 32 * 4, m * d * 2)
    rec = dict(shape=[m, d], run=plan(m, d), max_abs_err=float((got - want).abs().max()),
               **timings(lambda: points(m, d, 0, device=dev),
                         lambda: points(m, d, 0, device=dev, use_kernel=False)),
               keyed_eager_ms=_events_ms(lambda: qmc_uniforms(m, d, key, device=dev), reps),
               keyed_plain_eager_ms=_events_ms(keyed_plain, reps),
               bound_ms=b[0], bound_by=b[1])
    build.reset_launch_counts()
    return rec


def host_phase(dev, bundles: dict, cfg, card: str, rng) -> dict:
    """The host-loop server (``mode="host"``) on the eight pipelines at full
    width, through the kernels and the plain versions, and the fused server
    on the same requests, each ``serve_all(compare_exact=True)`` over 4
    requests after a warm-up: equal plans, iterations, classes and exact
    answers; ``ServerStats.summary`` printed per pipeline and mode.  Then
    tight host requests on turbofan and sensor_health, the busiest profiled,
    and the kernels at the host loop's shapes: ``masked_select_ranks`` on
    the (256, cap) bootstrap rows, ``sobol_points`` at every pipeline's
    (m, k) and (m_sobol, 2k), ``ensemble_sum`` on every tree pipeline's
    forest at m + 1, (k + 2)·m_sobol and 1 row (``run_exact``)."""
    from repro_torch.core import threefry
    from repro_torch.core.planner import initial_plan
    from repro_torch.data.store import bucket_size
    from repro_torch.models.tabular.trees import TreeModel
    from repro_torch.serving import BiathlonServer

    out = {"serve": {}, "launches": {}}
    total = {}
    for name in HOST_PIPELINES:
        bundle, p = bundles[name], bundles[name].pipeline
        delta = cfg.delta if cfg.delta is not None else p.delta_default
        trees = name in ("turbofan", "sensor_health") or PAPER_PIPELINES[name][2]
        runs = {"host": host_serve_run(bundle, cfg, dev),
                "host_plain": host_serve_run(bundle, cfg, dev, use_kernel=False),
                "fused": host_serve_run(bundle, cfg, dev, mode="fused")}
        compare_host_runs(f"{name} host", runs["host_plain"], runs["host"], cfg, p.task)
        kernels = ["sobol_points"] + (["ensemble_sum"] if trees else [])
        kernels += ["masked_select_ranks"] if name == "sensor_health" else []
        absent = ["prefix_power_sums", "sampled_moments"] + (
            [] if name == "sensor_health" else ["masked_select_ranks"])
        expect_launched(f"{name} host", runs["host"][2], kernels, absent)
        require(not runs["host_plain"][2], f"{name} host plain launched {runs['host_plain'][2]}")
        for kname, count in runs["host"][2].items():
            total[kname] = total.get(kname, 0) + count
        out["serve"][name] = {}
        for mode in ("host", "fused"):
            stats, outs, launches = runs[mode]
            s = stats.summary(delta, p.task)
            out["serve"][name][mode] = dict(s, iters=[o["iters"] for o in outs],
                                            launches=launches)
            print(f"host phase {name} {mode}: mean {s['mean_latency_s'] * 1e3:.3f} ms, p95 "
                  f"{s['p95_latency_s'] * 1e3:.3f} ms, exact {s['mean_exact_latency_s'] * 1e3:.3f}"
                  f" ms, speedup {s['speedup']:.3f}, sample fraction {s['mean_sample_frac']:.4f}"
                  f", guarantee rate {s['guarantee_rate']:.2f}, iters "
                  f"{[o['iters'] for o in outs]} [{card}]", flush=True)
    out["launches"] = total
    print(f"host phase launches through the kernels: {total} [{card}]", flush=True)

    # tight requests: turbofan and sensor_health iterate there
    out["tight"] = {}
    for name in ("turbofan", "sensor_health"):
        bundle = bundles[name]
        tight = tight_config(bundle.pipeline)
        runs = {key: host_serve_run(bundle, tight, dev, use_kernel=key == "host",
                                    compare_exact=False) for key in ("host", "host_plain")}
        compare_host_runs(f"{name} host tight", runs["host_plain"], runs["host"], tight,
                          bundle.pipeline.task)
        outs = runs["host"][1]
        busiest = max(range(N_HOST), key=lambda i: outs[i]["iters"])
        srv_prof = BiathlonServer(bundle, tight, mode="host", device=dev)
        prof = profile_served(
            lambda: srv_prof.serve(bundle.requests[busiest], threefry.PRNGKey(busiest)),
            ROOT / "build" / f"chip_smoke_profile_host_{name}.txt")
        lat = outs[busiest]["latency"] * 1e3
        prof.update(latency_ms=lat, request=busiest,
                    device_idle_share=max(0.0, 1.0 - prof["device_busy_ms"] / lat))
        out["tight"][name] = dict(iters=[o["iters"] for o in outs],
                                  latency_ms=[o["latency"] * 1e3 for o in outs],
                                  launches=runs["host"][2], profile=prof)
        print(f"host phase {name} tight: iters {[o['iters'] for o in outs]}, latency ms "
              f"{[round(o['latency'] * 1e3, 3) for o in outs]}; profile of request {busiest}: "
              f"{json.dumps(prof)} [{card}]", flush=True)

    # the kernels at the host loop's shapes
    health = bundles["sensor_health"]
    p, req = health.pipeline, health.requests[0]
    n = p.group_sizes(health.store, req)
    z0 = initial_plan(torch.from_numpy(n.astype(np.int32)), cfg.alpha).numpy()
    cap0 = bucket_size(int(z0.max()))
    hol = [j for j, f in enumerate(p.agg_features) if f.agg in ("median", "quantile")]
    f = p.agg_features[hol[-1]]
    q = 0.5 if f.agg == "median" else f.quantile
    key = threefry.PRNGKey(0)
    vals0 = torch.from_numpy(health.store[f.table].sample_prefix(
        f.column, int(req[f.group_field]), cap0)).to(dev)
    full = torch.from_numpy(health.store[f.table].sample_prefix(
        f.column, int(req[f.group_field]), 32768)).to(dev)
    full_z = min(int(n[hol[-1]]), 32768)
    select = dict(host_select_record(vals0, int(z0[hol[-1]]), q, key),
                  full=host_select_record(full, full_z, q, key, reps=5),
                  counting_edge=[host_select_record(full, zz, q, key, reps=5)
                                 for zz in (1, 352, 353)])
    shapes = sorted({(m, d) for name in HOST_PIPELINES for k in [bundles[name].pipeline.k]
                     for m, d in ((cfg.m, k), (cfg.m_sobol, 2 * k))})
    sobol = {f"{m}x{d}": host_sobol_record(dev, m, d, threefry.PRNGKey(7)) for m, d in shapes}
    trees = {}
    for name in HOST_PIPELINES:
        p = bundles[name].pipeline
        if not isinstance(p.model, TreeModel):
            continue
        ens, n_feat = p.model.ensemble, p.k + len(p.exact_features)
        trees[name] = {str(m): dict(tree_record(ens, m, dev, rng, n_feat=n_feat),
                                    max_abs_err=tree_check(ens, (m,), dev, rng, n_feat=n_feat))
                       for m in (cfg.m + 1, (p.k + 2) * cfg.m_sobol)}
        trees[name]["1"] = dict(max_abs_err=tree_check(ens, (1,), dev, rng, n_feat=n_feat))
    out["kernels"] = dict(masked_select_ranks=select, sobol_points=sobol, ensemble_sum=trees)
    print(f"host phase kernels: {json.dumps(out['kernels'])} [{card}]", flush=True)
    return out


# ----------------------------------------------------------------- phase 13
CONT_LANES = 8
CONT_CHUNK = 4
CONT_N = 64
CONT_CASES = (("turbofan", "auto"), ("sensor_health", "auto"), ("sensor_health", "ref"),
              ("fraud_detection", "auto"))
STORM = dict(seed=11, chunk_fail_prob=0.25, refill_fail_prob=0.15, poison_prob=0.2)


def record_key(r) -> tuple:
    """A runtime record's outcome, floats as their bits: what two runs of one
    trace must agree on bitwise."""
    bits = np.array([r.y_hat, r.prob], np.float32).view(np.int32).tolist()
    return (r.req_id, r.disposition, r.z, r.iters, tuple(bits))


def by_request(stats) -> dict:
    return {r.req_id: r for r in stats.records}


def fixed_lane_waste(stats) -> float:
    """``straggler_report``'s ``wasted_frac`` over a fixed-lane run's batches:
    the lane-iterations each batch charged past its requests' own, over all
    it charged."""
    batches = collections.defaultdict(list)
    for r in stats.records:
        if r.batch_id >= 0 and r.disposition == "ok":
            batches[r.batch_id].append(r.iters)
    wasted = sum(max(it) * len(it) - sum(it) for it in batches.values())
    return wasted / max(sum(max(it) * len(it) for it in batches.values()), 1)


def runtime_row(stats, fixed: bool) -> dict:
    s = stats.summary()
    row = {key: s[key] for key in ("n", "throughput_rps", "p50_latency_ms", "p99_latency_ms",
                                   "mean_queue_delay_ms", "p99_queue_delay_ms",
                                   "mean_batch_fill", "utilization", "n_batches",
                                   "guarantee_rate", "compile_count")}
    if fixed:
        row["wasted_frac"] = fixed_lane_waste(stats)
    else:
        row.update(lane_occupancy=s["lane_occupancy"], n_recycles=s["n_recycles"],
                   n_chunks=s["n_chunks"], wasted_frac=s["chunk_wasted_frac"])
    return row


def refill_chunk_timings(srv, bundle, knobs, card, path_stem: str) -> dict:
    """One refill and one chunk of a table that iterates, wall (host clock
    around the call and its read-back, median of 10) and device (a profile
    of one: device busy, idle share, host operators, launches); the
    Saltelli block a refill always replays (device time, CUDA events over
    10 graph replays); a chunk that reads the lanes' flags before each
    replay against ``chunk_iters`` replays read once, from one checkpoint."""
    exe = srv._exe
    reqs = bundle.requests[:CONT_LANES]
    cap = srv.trace_cap(reqs)
    table = srv.new_table(cap)
    srv.admit(table, cap, [(lane, reqs[lane], knobs) for lane in range(CONT_LANES)])
    srv.readback(table)
    ckpt = srv.snapshot(table)

    def refill():
        t0 = time.perf_counter()
        srv.admit(table, cap, [(0, reqs[0], knobs)])
        srv.readback(table)
        return dict(iters=0, latency=time.perf_counter() - t0)

    def chunk():
        srv.restore(table, ckpt)
        t0 = time.perf_counter()
        out = srv.readback(srv.run_chunk(table))
        return dict(iters=int(out["it"].max()), latency=time.perf_counter() - t0)

    def blind():
        srv.restore(table, ckpt)
        t0 = time.perf_counter()
        for _ in range(CONT_CHUNK):
            exe._launch(table, 0)
        srv.readback(table)
        return dict(iters=CONT_CHUNK, latency=time.perf_counter() - t0)

    out = {}
    for name, fn in (("refill", refill), ("chunk", chunk), ("chunk_blind", blind)):
        fn()
        out[f"{name}_wall_ms"] = statistics.median(fn()["latency"] for _ in range(10)) * 1e3
    for name, fn in (("refill", refill), ("chunk", chunk)):
        prof = profile_served(fn, ROOT / "build" / f"chip_smoke_profile_{path_stem}_{name}.txt")
        prof["idle_share"] = 1.0 - prof["device_busy_ms"] / prof["profiled_latency_ms"]
        out[f"{name}_profile"] = prof
    chunk_out = chunk()
    out["chunk_iters_run"] = chunk_out["iters"]
    out["saltelli_ms"] = _events_ms(lambda: exe._launch(table.src, 1), 10)
    srv.restore(table, ckpt)
    print(f"continuous {path_stem} timings: refill wall {out['refill_wall_ms']:.3f} ms, device "
          f"{out['refill_profile']['device_busy_ms']:.4f} ms (Saltelli block "
          f"{out['saltelli_ms']:.4f}); chunk wall {out['chunk_wall_ms']:.3f} ms, device "
          f"{out['chunk_profile']['device_busy_ms']:.4f} ms, {CONT_CHUNK} blind replays "
          f"{out['chunk_blind_wall_ms']:.3f} ms; profiles {json.dumps(out['refill_profile'])} "
          f"{json.dumps(out['chunk_profile'])} [{card}]", flush=True)
    return out


def continuous_case(name, afc, bundle, fixed_rps, dev, card, *, full: bool) -> dict:
    """One pipeline under one AFC strategy: the main path (the captured
    kernel table, built with launch counts reset and read after its two
    measured runs, at 2× and 0.25× the fixed-lane server's tight fill-8
    requests/s), compared in turns with ``ServingRuntime`` over the fixed-
    lane server on the same traces; then every request against its own
    one-lane run, the eager table bitwise, the plain versions' plans, the
    same trace twice bitwise (arrivals at t = 0, so no decision depends on
    wall time), two slots for the bucket throughout; with ``full`` also the
    cached table (a hit launches no ``prefix_power_sums``), a fault storm
    (twice, bitwise; every request served bitwise its fault-free run), and
    timings and profiles of a refill and a chunk."""
    from repro_torch.data.synthetic import poisson_arrivals
    from repro_torch.kernels import build
    from repro_torch.serving import (
        BatchedFusedServer,
        ContinuousBatchedServer,
        ContinuousServingRuntime,
        FaultProfile,
        FaultyContinuousServer,
        LaneKnobs,
        ServingRuntime,
    )

    p = bundle.pipeline
    cfg = tight_config(p)
    delta = p.delta_default if cfg.delta is None else cfg.delta
    kw = dict(batch_size=CONT_LANES, chunk_iters=CONT_CHUNK, afc_backend=afc, device=dev)
    fixed = BatchedFusedServer(bundle, cfg, batch_size=CONT_LANES, afc_backend=afc, device=dev)
    rates = {"saturating": 2.0 * fixed_rps, "light": 0.25 * fixed_rps}
    traces = {rate: poisson_arrivals(bundle.requests, rps, n=CONT_N, seed=5)
              for rate, rps in rates.items()}
    at_zero = [(0.0, req) for _, req in traces["saturating"]]
    ServingRuntime(fixed).warmup([a[1] for a in at_zero])
    # the main path: counts reset just before the table's build, read after
    sync(dev)
    build.reset_launch_counts()
    srv = ContinuousBatchedServer(bundle, cfg, **kw)
    ContinuousServingRuntime(srv).warmup([a[1] for a in at_zero])
    runs = {rate: [ContinuousServingRuntime(srv).run(tr, warmup=False)]
            for rate, tr in traces.items()}
    sync(dev)
    launches = dict(build.LAUNCHES)
    rec = dict(cap=srv.compiled_buckets, rates_rps=rates, launches=launches)
    # continuous and fixed lanes in turns on each trace (continuous first)
    for rate, tr in traces.items():
        fx = [ServingRuntime(fixed, max_wait_s=0.002).run(tr) for _ in range(2)]
        runs[rate].append(ContinuousServingRuntime(srv).run(tr, warmup=False))
        cont_rows = [runtime_row(s, False) for s in runs[rate]]
        fixed_rows = [runtime_row(s, True) for s in fx]
        for s in runs[rate] + fx:
            require(s.summary()["n"] == CONT_N and s.compile_count == 0,
                    f"continuous {name} {afc} {rate}: {s.summary()}")
        require(cont_rows[0]["n_recycles"] > 0, f"continuous {name} {afc} {rate}: no recycling")
        rec[rate] = dict(continuous=cont_rows, fixed=fixed_rows)
        c, f = cont_rows[0], fixed_rows[0]
        print(f"continuous {name} {afc} {rate} ({rates[rate]:.1f} req/s, {CONT_N} requests, "
              f"{CONT_LANES} lanes, chunk {CONT_CHUNK}): continuous / fixed-lane, in turns: "
              f"throughput {c['throughput_rps']:.1f}, {cont_rows[1]['throughput_rps']:.1f} / "
              f"{f['throughput_rps']:.1f}, {fixed_rows[1]['throughput_rps']:.1f} req/s; p50 "
              f"{c['p50_latency_ms']:.3f} / {f['p50_latency_ms']:.3f} ms; p99 "
              f"{c['p99_latency_ms']:.3f} / {f['p99_latency_ms']:.3f} ms; queue delay "
              f"{c['mean_queue_delay_ms']:.3f} / {f['mean_queue_delay_ms']:.3f} ms; lane "
              f"occupancy {c['lane_occupancy']:.3f}, recycles {c['n_recycles']}, chunks "
              f"{c['n_chunks']}; wasted_frac chunked {c['wasted_frac']:.4f} / straggler "
              f"{f['wasted_frac']:.4f} [{card}]", flush=True)
    # 1. every request against its own run on the captured one-lane server
    single = BatchedFusedServer(bundle, cfg, batch_size=1, afc_backend=afc, device=dev)
    for s in runs["saturating"][:1]:
        for r in s.records:
            one = single.serve_batch([traces["saturating"][r.req_id][1]])
            require(r.z == tuple(int(x) for x in one.z[0]) and r.iters == int(one.iters[0]),
                    f"continuous {name} {afc}: request {r.req_id} {r.z} x{r.iters} vs one lane "
                    f"{one.z[0].tolist()} x{int(one.iters[0])}")
            y = float(one.y_hat[0])
            require(abs(r.y_hat - y) <= 1e-5 * max(1.0, abs(y))
                    and abs(r.prob - float(one.prob[0])) <= 1e-5,
                    f"continuous {name} {afc}: request {r.req_id} y {r.y_hat} vs {y}, prob "
                    f"{r.prob} vs {float(one.prob[0])}")
    # 2.-4. the t = 0 trace: twice bitwise, eager bitwise, the plain plans
    free = ContinuousServingRuntime(srv).run(at_zero, warmup=False)
    want = [record_key(r) for r in sorted(free.records, key=lambda r: r.req_id)]
    require([record_key(r) for r in sorted(ContinuousServingRuntime(srv).run(
        at_zero, warmup=False).records, key=lambda r: r.req_id)] == want,
        f"continuous {name} {afc}: the same trace twice differs")
    eager = ContinuousBatchedServer(bundle, cfg, capture=False, **kw)
    got = ContinuousServingRuntime(eager).run(at_zero)
    require([record_key(r) for r in sorted(got.records, key=lambda r: r.req_id)] == want,
            f"continuous {name} {afc}: captured and eager tables differ")
    plain = ContinuousBatchedServer(bundle, cfg, use_kernel=False, **kw)
    got = by_request(ContinuousServingRuntime(plain).run(at_zero))
    for r in free.records:
        g = got[r.req_id]
        require(g.z == r.z and g.iters == r.iters
                and abs(g.y_hat - r.y_hat) <= 1e-4 * max(1.0, abs(r.y_hat)),
                f"continuous {name} {afc}: request {r.req_id} kernels {r.z} x{r.iters} vs "
                f"plain {g.z} x{g.iters}")
    rec["iters"] = [r.iters for r in sorted(free.records, key=lambda r: r.req_id)]
    if full:
        # 6. the cached table: a miss builds the entry, a hit launches nothing
        cached = ContinuousBatchedServer(bundle, cfg, cache_size=CACHE_SIZE, **kw)
        ContinuousServingRuntime(cached).warmup([a[1] for a in at_zero])
        cap = cached.trace_cap([a[1] for a in at_zero])
        table = cached.new_table(cap)
        cached.cache._entries.clear()
        counts = [served_launches(dev, lambda lane=lane: cached.readback(cached.admit(
            table, cap, [(lane, at_zero[3][1], None)])[0]))[1].get("prefix_power_sums", 0)
            for lane in (1, 2)]
        require(counts == [1, 0], f"continuous {name}: miss and hit launched {counts} "
                "prefix_power_sums")
        got = ContinuousServingRuntime(cached).run(at_zero, warmup=False)
        require([record_key(r) for r in sorted(got.records, key=lambda r: r.req_id)] == want,
                f"continuous {name} {afc}: the cached table differs from the uncached")
        rec["cached"] = dict(stats=cached.cache.stats, slots=cached.compile_count)
        cached.check_compile_contract()
        # 8. a fault storm, twice
        storms = []
        for _ in range(2):
            fs = FaultyContinuousServer(srv, FaultProfile(**STORM))
            st = ContinuousServingRuntime(fs, backoff_s=0.001, max_retries=2,
                                          poison_retries=1).run(at_zero, warmup=False)
            storms.append((fs.events, [record_key(r) for r in sorted(
                st.records, key=lambda r: r.req_id)], st.n_rollbacks, st.n_poisoned))
        require(storms[0] == storms[1], f"continuous {name}: the fault storm replays differently")
        kinds = collections.Counter(kind.split(":")[0] for _, kind in storms[0][0])
        served_ok = [k for k in storms[0][1] if k[1] == "ok"]
        differ = [(k, want[k[0]]) for k in served_ok if k != want[k[0]]]
        require(not differ, f"continuous {name}: {len(differ)} requests served in the storm "
                f"differ from their fault-free runs, first {differ[:1]}")
        require(sum(kinds.values()) > 0, f"continuous {name}: the storm injected nothing")
        rec["storm"] = dict(events=dict(kinds), served=len(served_ok), rollbacks=storms[0][2],
                            poisoned=storms[0][3])
        print(f"continuous {name} fault storm: {json.dumps(rec['storm'])}, each served request "
              f"bitwise its fault-free run, replayed identically [{card}]", flush=True)
        rec["timings"] = refill_chunk_timings(
            srv, bundle, LaneKnobs(delta, cfg.tau, cfg.max_iters), card, f"continuous_{name}")
    # 5. two slots for the bucket, whatever was admitted, restored or cleared
    for s in (srv, eager, plain):
        s.check_compile_contract()
        require(len(s.compiled_buckets) == 1, f"continuous {name} {afc}: {s.compiled_buckets}")
    return rec


def degrade_check(bundle, fixed_rps, dev, card) -> dict:
    """``ServingRuntime`` over the captured fixed-lane server with a
    ``DegradationController`` at 4× its saturating rate and a deadline of
    three batches: some requests are shed, the rest served, nothing built."""
    from repro_torch.data.synthetic import poisson_arrivals
    from repro_torch.serving import (
        BatchedFusedServer,
        DegradationController,
        ServingRuntime,
        default_tiers,
    )

    cfg = tight_config(bundle.pipeline)
    srv = BatchedFusedServer(bundle, cfg, batch_size=CONT_LANES, device=dev)
    batch_s = CONT_LANES / fixed_rps
    trace = poisson_arrivals(bundle.requests, 4.0 * fixed_rps, n=CONT_N, seed=6)
    ServingRuntime(srv).warmup([a[1] for a in trace])
    before = srv.compile_count
    ctl = DegradationController(default_tiers(cfg.tau, cfg.max_iters), service_est_s=batch_s,
                                lanes=CONT_LANES)
    stats = ServingRuntime(srv, max_wait_s=0.002, slo_s=3.0 * batch_s, controller=ctl).run(
        trace, warmup=False)
    s = stats.summary()
    require(0 < stats.n_shed < CONT_N and s["n"] > 0 and srv.compile_count == before,
            f"degradation: {s}")
    out = {key: s[key] for key in ("n", "n_shed", "shed_rate", "mean_tier", "max_tier",
                                   "p99_latency_ms", "deadline_met_rate", "guarantee_rate")}
    print(f"continuous degradation turbofan at {4.0 * fixed_rps:.1f} req/s, slo "
          f"{3.0 * batch_s * 1e3:.2f} ms: {json.dumps(out)} [{card}]", flush=True)
    return out


def launcher_check(dev, card) -> dict:
    """``python -m repro_torch.launch.serve`` in process, fused-batched and
    fused-continuous, on turbofan at 2000 rows a group."""
    import contextlib
    import io

    from repro_torch.launch.serve import main as serve_main

    out = {}
    for mode in ("fused-batched", "fused-continuous"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            s = serve_main(["--pipeline", "turbofan", "--mode", mode, "--device", str(dev),
                            "--rows-per-group", "2000", "--requests", "32", "--arrival-rate",
                            "400", "--slo-ms", "500", "--degrade"])
        require(f"mode={mode}" in buf.getvalue() and s["n"] + s["n_shed"] == 32,
                f"launcher {mode}: {buf.getvalue()[-400:]}")
        out[mode] = {key: s[key] for key in ("n", "throughput_rps", "p50_latency_ms",
                                             "p99_latency_ms", "guarantee_rate")}
    print(f"continuous launcher: {json.dumps(out)} [{card}]", flush=True)
    return out


def continuous_phase(dev, bundles: dict, batched: dict, card: str) -> dict:
    """Continuous batching and the arrival-driven runtimes at full width
    (:func:`continuous_case` on turbofan, sensor_health under "auto" and
    "ref", and fraud_detection; the cached table, the storm and the
    timings on turbofan and sensor_health "auto"), the degradation check and
    the launcher.  Every kernel of the path must launch in the cases' main
    paths."""
    t0 = time.perf_counter()
    out, launched = {}, collections.Counter()
    for name, afc in CONT_CASES:
        cell = batched[name if afc == "auto" else f"{name}_{afc}"]["tight_fill8"]
        rec = continuous_case(name, afc, bundles[name], cell["captured_requests_per_s"], dev,
                              card, full=afc == "auto" and name != "fraud_detection")
        launched.update(rec["launches"])
        out[name if afc == "auto" else f"{name}_{afc}"] = rec
    for kname in ("prefix_power_sums", "sampled_moments", "masked_select_ranks",
                  "ensemble_sum", "sobol_points"):
        require(launched.get(kname, 0) > 0, f"continuous path: {kname} never launched")
    out["launches"] = dict(launched)
    out["degradation"] = degrade_check(
        bundles["turbofan"], batched["turbofan"]["tight_fill8"]["captured_requests_per_s"], dev,
        card)
    out["launcher"] = launcher_check(dev, card)
    out["seconds"] = time.perf_counter() - t0
    print(f"continuous phase: {out['seconds']:.1f} s, launches {json.dumps(out['launches'])} "
          f"[{card}]", flush=True)
    return out


# ----------------------------------------------------------------- phase 14
SHARD_COUNTS = (2, 4)
SHARD_PIPELINES = ("turbofan", "sensor_health")
SHARD_REPS = 3
# a shard of L/D lanes against the unsharded L: plans and iterations equal,
# y_hat and prob within this (a slot of another lane count may round apart)
SHARD_TOL = 1e-5


def compare_sharded(name, base, other) -> dict:
    """Equal plans and iterations, ŷ within SHARD_TOL·max(1, |y|) and prob
    within SHARD_TOL; returns the largest differences."""
    require((base.z == other.z).all() and (base.iters == other.iters).all(),
            f"{name}: plans differ: {base.z.tolist()} x{base.iters.tolist()} vs "
            f"{other.z.tolist()} x{other.iters.tolist()}")
    dy = np.abs(base.y_hat - other.y_hat) / np.maximum(1.0, np.abs(base.y_hat))
    dp = np.abs(base.prob - other.prob)
    require(bool((dy <= SHARD_TOL).all() and (dp <= SHARD_TOL).all()),
            f"{name}: y_hat {base.y_hat.tolist()} vs {other.y_hat.tolist()}, prob "
            f"{base.prob.tolist()} vs {other.prob.tolist()}")
    return dict(max_rel_dy=float(dy.max(initial=0.0)), max_dprob=float(dp.max(initial=0.0)))


def stream_overlap(trace: Path) -> dict:
    """Device activity (kernels, copies, sets) of a profiler's chrome trace by
    stream: each stream's busy time, the busy time of all streams together
    (their union) and the overlap, the time two streams ran at once (the sum
    of the streams' busy times less the union)."""
    def union(iv) -> float:
        total, end = 0.0, -1.0
        for a, b in sorted(iv):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    per = collections.defaultdict(list)
    for e in json.loads(trace.read_text()).get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            per[str(e.get("args", {}).get("stream"))].append((e["ts"], e["ts"] + e["dur"]))
    busy = {s: union(iv) / 1e3 for s, iv in per.items()}
    together = union([x for iv in per.values() for x in iv]) / 1e3
    return dict(streams=len(per), busy_ms_by_stream=busy, busy_union_ms=together,
                overlap_ms=sum(busy.values()) - together)


def profile_overlap(fn, path: Path) -> dict:
    """:func:`profile_served` of ``fn`` with its chrome trace kept, read by
    :func:`stream_overlap`: the idle share is 1 − the union of the streams'
    busy time over the profiled latency."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    rows, device = profile_rows(prof, path)
    trace = path.with_suffix(".json")
    prof.export_chrome_trace(str(trace))
    ov = stream_overlap(trace)
    trace.unlink()
    return dict(device_busy_ms=sum(r[0] for r in device) / 1e3,
                device_launches=sum(r[2] for r in device),
                host_ops=sum(r[2] for r in rows if r[3] > 0.0),
                profiled_latency_ms=out["latency"] * 1e3,
                idle_share=1.0 - ov["busy_union_ms"] / (out["latency"] * 1e3), **ov)


def sharded_batches(name, bundle, cfg, dev, meshes, card, afc="auto") -> dict:
    """One pipeline's batches at the tight setting, fills 8, 3 and 1, through
    the unsharded captured server (the yardstick, outside the counts) and a
    server on each mesh (the main path: counts reset just before their
    builds, read after their batches): a mesh over every visible card bitwise
    the unsharded server, simulated shards within :data:`SHARD_TOL` and
    bitwise run to run; one slot a bucket on every shard; each shard's
    ``sobol_points`` at its build and ``prefix_power_sums`` at its capture and
    each z⁰ replay (incremental)."""
    from repro_torch.kernels import build
    from repro_torch.serving import BatchedFusedServer, straggler_report

    p = bundle.pipeline
    fills = BATCH_FILLS if afc == "auto" else (BATCH_LANES,)
    base = BatchedFusedServer(bundle, cfg, batch_size=BATCH_LANES, afc_backend=afc, device=dev)
    want = {}
    for fill in fills:
        base.serve_batch(bundle.requests[:fill], knobs=batch_knobs(p, True, fill))
        want[fill] = base.serve_batch(bundle.requests[:fill], knobs=batch_knobs(p, True, fill))
    sync(dev)
    build.reset_launch_counts()
    servers = {m: BatchedFusedServer(bundle, cfg, batch_size=BATCH_LANES, mesh=mesh,
                                     afc_backend=afc) for m, mesh in meshes.items()}
    got = {m: {fill: srv.serve_batch(bundle.requests[:fill], knobs=batch_knobs(p, True, fill))
               for fill in fills} for m, srv in servers.items()}
    again = {m: srv.serve_batch(bundle.requests[:BATCH_LANES],
                                knobs=batch_knobs(p, True, BATCH_LANES))
             for m, srv in servers.items()}
    sync(dev)
    launches = dict(build.LAUNCHES) | dict(build.PATHS)
    rec = dict(launches=launches, cases={})
    shards = sum(len(mesh.devices) for mesh in meshes.values())
    require(launches.get("sobol_points", 0) == shards,
            f"sharded {name}: {launches.get('sobol_points', 0)} sobol_points for {shards} shards")
    if afc == "auto":
        # each shard: one launch in the eager pass before each capture, one a z⁰ replay
        want_pps = sum(len(mesh.devices) * (len(servers[m].compiled_buckets) + len(fills) + 1)
                       for m, mesh in meshes.items())
        require(launches.get("prefix_power_sums", 0) == want_pps,
                f"sharded {name}: {launches.get('prefix_power_sums', 0)} prefix_power_sums, "
                f"{want_pps} expected (every shard's capture and z0 replays)")
    if afc == "ref":
        for kname in ("sampled_moments", "masked_select_ranks"):
            require(launches.get(kname, 0) >= shards,
                    f"sharded {name} ref: {launches.get(kname, 0)} {kname} for {shards} shards")
    for m, srv in servers.items():
        srv.check_compile_contract()
        d = len(meshes[m].devices)
        require(srv.shard_compile_counts == [len(srv.compiled_buckets)] * d,
                f"sharded {name} {m}: shard slots {srv.shard_compile_counts}")
        case = {}
        for fill in fills:
            a, b = want[fill], got[m][fill]
            if m == "cards" and d == 1:
                compare_batches(f"sharded {name} {m} fill {fill}", a, b, bitwise=True)
                case[f"fill{fill}"] = dict(bitwise=True)
            else:
                case[f"fill{fill}"] = compare_sharded(f"sharded {name} {m} fill {fill}", a, b)
        compare_batches(f"sharded {name} {m} twice", got[m][BATCH_LANES], again[m],
                        bitwise=True)
        rep = straggler_report(got[m][BATCH_LANES])
        case.update(shards=d, buckets=srv.compiled_buckets, iters=got[m][BATCH_LANES].iters.tolist(),
                    per_device_fill=rep["per_device_fill"].tolist(),
                    lane_imbalance=rep["lane_imbalance"], wasted_frac=rep["wasted_frac"],
                    wasted_frac_unsharded=straggler_report(want[BATCH_LANES])["wasted_frac"])
        rec["cases"][m] = case
        print(f"sharded {name} {afc} {m} ({d} shards): {json.dumps(case)} [{card}]", flush=True)
    rec["servers"] = servers
    rec["base"] = base
    return rec


def sharded_timings(bundle, cfg, dev, servers: dict, card) -> dict:
    """One tight fill-8 batch unsharded and over 2 and 4 simulated shards, in
    turns (unsharded, 2, 4, 4, 2, unsharded; :data:`SHARD_REPS` batches a
    turn): wall p50; then each profiled, device busy time by stream, the
    overlap of the shards' streams and the idle share."""
    p = bundle.pipeline
    reqs, knobs = bundle.requests[:BATCH_LANES], batch_knobs(p, True, BATCH_LANES)
    times = collections.defaultdict(list)
    for turn in ("unsharded", "sim2", "sim4", "sim4", "sim2", "unsharded"):
        for _ in range(SHARD_REPS):
            times[turn].append(timed_batch(servers[turn], reqs, knobs)[1])
    out = {}
    for turn, srv in servers.items():
        def once(srv=srv):
            res, dt = timed_batch(srv, reqs, knobs)
            return dict(iters=res.batch_iters, latency=dt)

        prof = profile_overlap(once, ROOT / "build" / f"chip_smoke_profile_sharded_{turn}.txt")
        out[turn] = dict(p50_ms=statistics.median(times[turn]) * 1e3,
                         **{k: v for k, v in prof.items() if k != "busy_ms_by_stream"},
                         busy_ms_by_stream=sorted(prof["busy_ms_by_stream"].values()))
        print(f"sharded timing turbofan tight fill 8 {turn}: {json.dumps(out[turn])} [{card}]",
              flush=True)
    return out


def sharded_continuous(bundle, fixed_rps, dev, mesh, card) -> dict:
    """``ContinuousBatchedServer`` over 2 shards simulated on the card, on phase
    13's 64-request turbofan trace at t = 0: every request's plan and
    iterations those of the unsharded table; the fault storm of phase 13
    twice alike, each request it serves bitwise its fault-free sharded run;
    two slots a bucket on every shard.  Returns the counts of the main path
    (the sharded table's build and runs)."""
    from repro_torch.data.synthetic import poisson_arrivals
    from repro_torch.kernels import build
    from repro_torch.serving import (
        ContinuousBatchedServer,
        ContinuousServingRuntime,
        FaultProfile,
        FaultyContinuousServer,
    )

    cfg = tight_config(bundle.pipeline)
    kw = dict(batch_size=CONT_LANES, chunk_iters=CONT_CHUNK)
    at_zero = [(0.0, req) for _, req in poisson_arrivals(bundle.requests, 2.0 * fixed_rps,
                                                         n=CONT_N, seed=5)]
    plain = ContinuousBatchedServer(bundle, cfg, device=dev, **kw)
    ContinuousServingRuntime(plain).warmup([a[1] for a in at_zero])
    want = by_request(ContinuousServingRuntime(plain).run(at_zero, warmup=False))
    sync(dev)
    build.reset_launch_counts()
    srv = ContinuousBatchedServer(bundle, cfg, mesh=mesh, **kw)
    ContinuousServingRuntime(srv).warmup([a[1] for a in at_zero])
    free = ContinuousServingRuntime(srv).run(at_zero, warmup=False)
    storms = []
    for _ in range(2):
        fs = FaultyContinuousServer(srv, FaultProfile(**STORM))
        st = ContinuousServingRuntime(fs, backoff_s=0.001, max_retries=2,
                                      poison_retries=1).run(at_zero, warmup=False)
        storms.append((fs.events, [record_key(r) for r in sorted(
            st.records, key=lambda r: r.req_id)], st.n_rollbacks, st.n_poisoned))
    sync(dev)
    launches = dict(build.LAUNCHES)
    dy = 0.0
    for r in free.records:
        w = want[r.req_id]
        require(r.z == w.z and r.iters == w.iters,
                f"sharded table: request {r.req_id} {r.z} x{r.iters} vs unsharded {w.z} "
                f"x{w.iters}")
        dy = max(dy, abs(r.y_hat - w.y_hat) / max(1.0, abs(w.y_hat)))
    keys = {r.req_id: record_key(r) for r in free.records}
    require(storms[0] == storms[1], "sharded table: the fault storm replays differently")
    served = [k for k in storms[0][1] if k[1] == "ok"]
    differ = [k for k in served if k != keys[k[0]]]
    require(not differ, f"sharded table: {len(differ)} requests of the storm differ from their "
            f"fault-free runs, first {differ[:1]}")
    kinds = collections.Counter(kind.split(":")[0] for _, kind in storms[0][0])
    require(sum(kinds.values()) > 0, "sharded table: the storm injected nothing")
    srv.check_compile_contract()
    require(srv.shard_compile_counts == [2 * len(srv.compiled_buckets)] * len(mesh.devices),
            f"sharded table: shard slots {srv.shard_compile_counts}")
    out = dict(shards=len(mesh.devices), n=len(free.records), max_rel_dy=dy,
               storm=dict(events=dict(kinds), served=len(served), rollbacks=storms[0][2],
                          poisoned=storms[0][3]),
               shard_slots=srv.shard_compile_counts, launches=launches,
               throughput_rps=free.summary()["throughput_rps"],
               lane_occupancy=free.summary()["lane_occupancy"],
               chunk_wasted_frac=free.summary()["chunk_wasted_frac"])
    print(f"sharded continuous turbofan: {json.dumps(out)} [{card}]", flush=True)
    return out


def sharded_launcher(dev, card) -> dict:
    """``repro_torch.launch.serve.main`` in process: ``fused-sharded`` over
    every visible card and ``fused-continuous --devices 1``, on turbofan at
    2000 rows a group."""
    import contextlib
    import io

    from repro_torch.launch.serve import main as serve_main

    out = {}
    for mode, extra in (("fused-sharded", []), ("fused-continuous", ["--devices", "1"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            s = serve_main(["--pipeline", "turbofan", "--mode", mode, "--device", str(dev),
                            "--rows-per-group", "2000", "--requests", "32", "--arrival-rate",
                            "400"] + extra)
        require(f"mode={mode}" in buf.getvalue() and s["n"] == 32
                and s["n_devices"] == (torch.cuda.device_count() if not extra else 1),
                f"launcher {mode}: {buf.getvalue()[-400:]}")
        out[mode] = {key: s[key] for key in ("n", "n_devices", "throughput_rps",
                                             "p50_latency_ms", "guarantee_rate")}
    print(f"sharded launcher: {json.dumps(out)} [{card}]", flush=True)
    return out


def checker_on_card(card) -> dict:
    """``python -m repro_torch.analysis.check`` in process on the card: no
    finding and the facts of ``baseline.json``'s cuda section; then
    ``--mutation-test``, every seeded violation caught."""
    import contextlib
    import gc
    import io

    from repro_torch.analysis import check

    t0 = time.perf_counter()
    gc.collect()
    out = {"gc": dict(objects=len(gc.get_objects()), collect_s=time.perf_counter() - t0)}
    for name, argv in (("check", ["--device", "cuda"]),
                       ("mutation_test", ["--device", "cuda", "--mutation-test"])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = check.main(argv)
        text = buf.getvalue()
        (ROOT / "build" / f"chip_smoke_{name}.txt").write_text(text)
        require(rc == 0, f"checker {name} on the card: rc {rc}: {text[-1500:]}")
        lines = text.strip().splitlines()
        out[name] = dict(seconds=time.perf_counter() - t0, last=lines[-1],
                         by_check=next((x for x in lines if x.startswith("seconds by")), None))
    require("all seeded mutations caught" in out["mutation_test"]["last"],
            f"mutation test: {out['mutation_test']['last']}")
    print(f"sharded checker: {json.dumps(out)} [{card}]", flush=True)
    return out


def sharded_phase(dev, bundles: dict, cfg, batched: dict, card: str) -> dict:
    """Lanes over a serving mesh at full width (:func:`sharded_batches` on
    turbofan and sensor_health over every visible card and over 2 and 4
    shards simulated on the card, sensor_health under "ref" over 2; the
    timings; :func:`sharded_continuous`), the launcher and the checker.
    Every kernel of the path must launch in the cases' main paths."""
    from repro_torch.launch.mesh import make_serving_mesh, simulated_devices

    t0 = time.perf_counter()
    parts = {}

    def part(key):
        parts[key] = time.perf_counter() - t0 - sum(parts.values())

    meshes = {"cards": make_serving_mesh(),
              **{f"sim{d}": make_serving_mesh(devices=simulated_devices(d, dev))
                 for d in SHARD_COUNTS}}
    out, launched = {}, collections.Counter()
    for name in SHARD_PIPELINES:
        rec = sharded_batches(name, bundles[name], cfg, dev, meshes, card)
        launched.update({k: v for k, v in rec["launches"].items() if "." not in k})
        part(name)
        if name == "turbofan":
            servers = {"unsharded": rec["base"], "sim2": rec["servers"]["sim2"],
                       "sim4": rec["servers"]["sim4"]}
            out["timings"] = sharded_timings(bundles[name], cfg, dev, servers, card)
            part("timings")
        out[name] = {k: v for k, v in rec.items() if k not in ("servers", "base")}
    rec = sharded_batches("sensor_health", bundles["sensor_health"], cfg, dev,
                          {"sim2": meshes["sim2"]}, card, afc="ref")
    launched.update({k: v for k, v in rec["launches"].items() if "." not in k})
    out["sensor_health_ref"] = {k: v for k, v in rec.items() if k not in ("servers", "base")}
    part("sensor_health_ref")
    cont = sharded_continuous(bundles["turbofan"],
                              batched["turbofan"]["tight_fill8"]["captured_requests_per_s"],
                              dev, meshes["sim2"], card)
    launched.update(cont["launches"])
    out["continuous"] = cont
    part("continuous")
    for kname in ("prefix_power_sums", "sampled_moments", "masked_select_ranks",
                  "ensemble_sum", "sobol_points"):
        require(launched.get(kname, 0) > 0, f"sharded path: {kname} never launched")
    out["launches"] = dict(launched)
    out["launcher"] = sharded_launcher(dev, card)
    part("launcher")
    out["checker"] = checker_on_card(card)
    part("checker")
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    print(f"sharded phase: {out['seconds']:.1f} s ({json.dumps(parts)}), launches "
          f"{json.dumps(out['launches'])} [{card}]", flush=True)
    return out


# --------------------------------------------------------------- phase 10-12
def attention_work(b, h, hkv, sq, sk, d, dv, causal: bool, itemsize: int,
                   window: int = 0) -> tuple[int, int]:
    """(bytes, FLOPs) of one attention call: q, k, v read once and o written
    once; 2·D + 2·Dv FLOPs per live (q, k) pair (top-left causal mask; with
    a window W, only the keys above q − W count)."""
    pairs = live_pairs(sq, sk, causal, window)
    nbytes = itemsize * (b * h * sq * d + b * hkv * sk * (d + dv) + b * h * sq * dv)
    return nbytes, b * h * pairs * (2 * d + 2 * dv)


def live_pairs(sq, sk, causal: bool, window: int) -> int:
    """(q, k) pairs a causal / windowed mask leaves live (top-left aligned)."""
    rows = np.arange(sq)
    hi = np.minimum(rows, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(rows - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def attention_check(dev, name, shape, dtype, causal, seed, window: int = 0):
    """The kernel against its plain version on seeded inputs (``window`` > 0:
    a sliding window); returns (inputs, max |err|), failing beyond
    ``ATTN_TOL``.  A bf16 call must have taken the TMA path and be within
    ``EMULATION_TOL`` of its emulated roundings plus, for each output, the
    slack of the p's that the kernel may round to the other side of a bf16
    tie (``emulation.bf16_path``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.emulation import beyond, bf16_path, key_tile
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    b, h, hkv, sq, sk, d, dv = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(dev, dtype)
               for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv)))
    build.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal, window=window)
    path = "tma" if dtype == torch.bfloat16 else "simt"
    require(build.PATHS == {f"flash_attention.{path}": 1},
            f"flash_attention {name}: took {dict(build.PATHS)}, expected the {path} path")
    rep = h // hkv
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    want = flash_attention_ref(q, kr, vr, causal=causal, window=window)
    err = float((got.float() - want.float()).abs().max())
    require(torch.allclose(got.float(), want.float(), **ATTN_TOL[dtype]),
            f"flash_attention {name}: max |err| {err} beyond {ATTN_TOL[dtype]}")
    line = f"flash_attention {name} ({path}): max |err| {err:.3g} (tolerance {ATTN_TOL[dtype]})"
    if dtype == torch.bfloat16:
        emulated, slack = bf16_path(q, kr, vr, causal=causal, block_k=key_tile(d, dv), slack=True,
                                    window=window)
        em_err = float((got.float() - emulated.float()).abs().max())
        n_beyond = int(beyond(got, emulated, slack, **EMULATION_TOL).sum())
        past_ulp = int(beyond(got, emulated, torch.zeros_like(slack), **EMULATION_TOL).sum())
        require(n_beyond == 0,
                f"flash_attention {name}: {n_beyond} outputs beyond {EMULATION_TOL} plus their "
                f"tie slack from the emulated roundings (max |err| {em_err})")
        line += (f"; from the emulated roundings {em_err:.3g} ({past_ulp} of {got.numel()} "
                 f"past {EMULATION_TOL}, none past it plus their tie slack, at most "
                 f"{float(slack.max()):.3g}; {int((slack > 0).sum())} outputs with slack)")
        del emulated, slack
    print(line, flush=True)
    return (q, k, v), err


def attention_timings(dev, qkv, causal: bool, reps: int, window: int = 0) -> dict:
    """Kernel, plain version and ``F.scaled_dot_product_attention`` on one
    input; with a window, SDPA takes the equivalent boolean mask."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref, live_keys

    q, k, v = qkv
    b, h, sq, d = q.shape
    _, hkv, sk, dv = v.shape
    kw = dict(causal=causal, window=window)
    mask = live_keys(sq, sk, causal, window, q.device) if window else None
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, is_causal=causal and mask is None)
    ms, eager_ms = time_ms(lambda: flash_attention(q, k, v, **kw), reps)
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, **kw), reps)[0]
    library_ms = time_ms(sdpa, reps)[0]
    lib_err = float((sdpa().float() - flash_attention_ref(q, k, v, **kw).float()).abs().max())
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    b_ms, b_by = bound(*attention_work(b, h, hkv, sq, sk, d, dv, causal, q.element_size(),
                                       window), ops_per_s=peak)
    return dict(shape=[b, h, sq, d], sk=sk, dtype=str(q.dtype).removeprefix("torch."),
                causal=causal, window=window, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_max_abs_err=lib_err, bound_ms=b_ms, bound_by=b_by)


def ptxas_report(name: str) -> dict:
    """Registers and spill bytes of each bf16 ``flash_attention`` instance
    (``sm90::flash_attention_kernel<DP, kWindow>``), from the ``-Xptxas -v`` log of
    the library that was loaded, with any ``setmaxnreg`` warning of the
    compiler."""
    from repro_torch.kernels import build

    out, entry = {}, None
    for line in build.log_path(name).read_text().splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"4sm90\w*flash_attention_kernelILi(\d+)ELb([01])E", line)
            entry = f"dp{m.group(1)}" + ("_window" if m.group(2) == "1" else "") if m else None
            if entry:
                out[entry] = {}
        elif entry and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            out[entry].update(spill_store_bytes=int(m.group(1)), spill_load_bytes=int(m.group(2)))
        elif entry and "Used" in line and "registers" in line:
            out[entry]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
        if "setmaxnreg" in line:
            out.setdefault("warnings", []).append(line.strip())
    require(out, f"{build.log_path(name)} lists no bf16 flash_attention instance")
    return out


def flash_record(dev) -> dict:
    """``flash_attention`` against its plain version at every listed shape, timed."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as attn_ops

    bf16, f32 = torch.bfloat16, torch.float32
    errors = {}
    inputs = {}
    for i, (name, shape, dtype, causal) in enumerate([
        ("lm_head_1x16x48x64_bf16_causal", (1, 16, 16, 48, 48, 64, 64), bf16, True),
        ("prefill_1x16x4096x64_bf16_causal", (1, 16, 16, 4096, 4096, 64, 64), bf16, True),
        ("f32_1x16x512x64_noncausal", (1, 16, 16, 512, 512, 64, 64), f32, False),
        ("sq100_sk260_bf16_causal", (1, 16, 16, 100, 260, 64, 64), bf16, True),
        ("prefill_1x16x4096x128_bf16_causal", (1, 16, 16, 4096, 4096, 128, 128), bf16, True),
    ] + [
        # 65536 batch·heads (past a grid's y axis) on three inputs
        (f"batch_heads_65536_4096x16x16x64_bf16_causal_seed{seed}",
         (4096, 16, 16, 16, 16, 64, 64), bf16, True) for seed in (5, 6, 7)
    ]):
        inputs[name], errors[name] = attention_check(dev, name, shape, dtype, causal, seed=i)
    # GQA through the model-layout entry point: 16 query heads on 4 KV heads
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(dev, bf16)
               for s in ((1, 256, 16, 64), (1, 256, 4, 64), (1, 256, 4, 64)))
    got, want = attn_ops.attention(q, k, v), attn_ops.attention(q, k, v, use_kernel=False)
    errors["gqa_ops_1x256x16on4x64_bf16_causal"] = err = float((got - want).float().abs().max())
    require(torch.allclose(got.float(), want.float(), **ATTN_TOL[bf16]),
            f"flash_attention GQA through ops.attention: max |err| {err}")
    print(f"flash_attention gqa_ops: max |err| {err:.3g} (tolerance {ATTN_TOL[bf16]})",
          flush=True)
    rec = attention_timings(dev, inputs["prefill_1x16x4096x64_bf16_causal"], True, reps=5)
    rec["lm_head_shape"] = attention_timings(dev, inputs["lm_head_1x16x48x64_bf16_causal"],
                                             True, reps=20)
    rec["prefill_d128"] = attention_timings(dev, inputs["prefill_1x16x4096x128_bf16_causal"],
                                            True, reps=5)
    for r in (rec, rec["lm_head_shape"], rec["prefill_d128"]):
        r.update(ratio_to_library=r["ms"] / r["library_ms"], bound_share=r["bound_ms"] / r["ms"])
    rec.update(max_abs_err=max(errors.values()), errors=errors, phases=list(errors),
               instances=ptxas_report("flash_attention"))
    build.reset_launch_counts()
    return rec


def lm_head_phase(dev, card: str) -> dict:
    """The LM-head pipeline at full qwen1.5-0.5b width, kernel path and plain path."""
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_lm_head as ex
    from repro_torch.kernels import build
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config("qwen1.5-0.5b")
    t0 = time.perf_counter()
    sc = ex.build(cfg, dev)
    leaves = tree_leaves(sc.params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"lm_head: {cfg.arch_id} backbone {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{n_params} parameters, {n_bytes} bytes ({leaves[0].dtype}); event store "
          f"{sc.store['events'].n_rows} rows; built with the head in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    requests = ex.draw_requests(sc, N_LM_REQ)
    runs = {}
    for use_kernel in (True, False):
        torch.cuda.synchronize()
        build.reset_launch_counts()
        executor = ex.make_executor(sc, use_kernel=use_kernel)
        at_build = dict(build.LAUNCHES)
        paths_at_build = dict(build.PATHS)
        outs = ex.serve(sc, executor, requests, use_kernel=use_kernel)
        torch.cuda.synchronize()
        paths = {n: c - paths_at_build.get(n, 0) for n, c in build.PATHS.items()
                 if c > paths_at_build.get(n, 0)}
        runs[use_kernel] = (outs, dict(build.LAUNCHES) | dict(build.PATHS), at_build, executor,
                            paths)
    outs, launches, at_build, _, paths = runs[True]
    served = {n: launches.get(n, 0) - at_build.get(n, 0) for n in launches}
    require(served.get("flash_attention", 0) == cfg.n_layers * N_LM_REQ,
            f"lm_head: {served.get('flash_attention', 0)} flash_attention launches for "
            f"{N_LM_REQ} requests, expected {cfg.n_layers} per request")
    # the executor's one cap bucket (65536) is captured at the first request,
    # after one eager pass of its programs: one more prefix_power_sums launch
    require(paths == {"flash_attention.tma": cfg.n_layers * N_LM_REQ,
                      "prefix_power_sums.chunks": N_LM_REQ + 1},
            f"lm_head: took {paths}, expected the TMA path on every flash_attention launch "
            "and the chunked prefix_power_sums")
    require(served.get("prefix_power_sums", 0) == N_LM_REQ + 1,
            f"lm_head: prefix_power_sums launched {served.get('prefix_power_sums', 0)} times "
            f"for {N_LM_REQ} requests, expected once per request and once at the capture")
    expect_launched("lm_head", launches, ["sobol_points"], ["sampled_moments"])
    plain_outs, plain_launches = runs[False][0], runs[False][1]
    require(not plain_launches, f"lm_head plain run launched kernels {plain_launches}")
    state_err = 0.0
    for i, (a, b) in enumerate(zip(outs, plain_outs)):
        require(bool(torch.isfinite(a["state"]).all()) and a["state"].shape == (cfg.d_model,),
                f"lm_head: request {i} pooled state not finite of shape ({cfg.d_model},)")
        err = float((a["state"] - b["state"]).abs().max() / b["state"].abs().max())
        require(err < STATE_REL_TOL, f"lm_head: request {i} pooled states differ by {err}")
        state_err = max(state_err, err)
    # both executors fed the kernel path's pooled states
    fed = ex.serve(sc, runs[False][3], requests, use_kernel=False,
                   states=[o["state"] for o in outs])
    for i, (a, b) in enumerate(zip(outs, fed)):
        require(np.isfinite(a["y_hat"]) and 0.0 <= a["prob"] <= 1.0,
                f"lm_head: request {i} y_hat {a['y_hat']} prob {a['prob']}")
        require(a["iters"] == b["iters"] and (a["z"] == b["z"]).all(),
                f"lm_head: request {i} plan {a['z']} x{a['iters']} vs plain {b['z']} "
                f"x{b['iters']}")
        require(abs(a["y_hat"] - b["y_hat"]) <= 1e-4 * max(1.0, abs(a["y_hat"])),
                f"lm_head: request {i} y_hat {a['y_hat']} vs plain {b['y_hat']}")
        done = a["prob"] >= 0.95 or a["iters"] == 32 or (a["frac"] == 1.0)
        require(done, f"lm_head: request {i} stopped at prob {a['prob']} with plan left")
    result = {}
    for name, group in (("kernel", outs), ("plain", plain_outs)):
        for o in group:
            print(f"lm_head {name} user {o['user']:>3}: latency {o['latency'] * 1e3:.3f} ms, "
                  f"iters {o['iters']}, frac {o['frac']:.4f}, y_hat {o['y_hat']:.5f}, "
                  f"prob {o['prob']:.4f}", flush=True)
        p50 = statistics.median(o["latency"] for o in group) * 1e3
        print(f"lm_head {name}: p50 {p50:.3f} ms over {len(group)} requests [{card}]",
              flush=True)
        result[name] = dict(p50_ms=p50, latency_ms=[o["latency"] * 1e3 for o in group],
                            iters=[o["iters"] for o in group],
                            frac=[o["frac"] for o in group],
                            y_hat=[o["y_hat"] for o in group], prob=[o["prob"] for o in group])
    result.update(params=n_params, param_bytes=n_bytes, launches=launches,
                  launches_at_build=at_build,
                  flash_attention_paths={n: c for n, c in paths.items()
                                         if n.startswith("flash_attention.")},
                  state_max_rel_err=state_err)
    prof = profile_served(lambda: ex.serve(sc, runs[True][3], requests[:1])[0],
                          ROOT / "build" / "chip_smoke_profile_lm_head.txt")
    prof["device_idle_share"] = max(0.0, 1.0 - prof["device_busy_ms"] / result["kernel"]["p50_ms"])
    print(f"profile of lm_head request 0: {json.dumps(prof)} [{card}]", flush=True)
    result["profile"] = prof
    return result, sc


def backbone_profile(sc, dev, path: Path) -> dict:
    """One 1 × 4096-token backbone forward: latency and a device-time profile."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build
    from repro_torch.models.lm import LM

    cfg = sc.cfg
    tokens = torch.from_numpy(np.random.default_rng(4096).integers(0, cfg.vocab, (1, 4096)))
    tokens = tokens.to(dev)
    lat = {}
    with torch.no_grad():
        for use_kernel in (True, False):
            lm = LM(cfg, use_kernel=use_kernel)
            fwd = lambda: lm._backbone(sc.params, lm.embed(sc.params, tokens))  # noqa: E731
            h = fwd()
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                h = fwd()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            require(bool(torch.isfinite(h).all()), "4096-token forward is not finite")
            lat[use_kernel] = statistics.median(times)
        lm = LM(cfg)
        build.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lm._backbone(sc.params, lm.embed(sc.params, tokens))
            torch.cuda.synchronize()
        launches = build.LAUNCHES["flash_attention"]
        tma = build.PATHS["flash_attention.tma"]
    require(launches == cfg.n_layers,
            f"4096-token forward: {launches} flash_attention launches, expected {cfg.n_layers}")
    require(tma == launches, f"4096-token forward: {tma} of {launches} flash_attention "
                             "launches took the TMA path")
    _, device = profile_rows(prof, path)
    busy_ms = sum(r[0] for r in device) / 1e3
    flash_ms = sum(r[0] for r in device if "flash_attention" in r[1]) / 1e3
    require(flash_ms > 0.0, "profile shows no flash_attention device time")
    return dict(tokens=4096, latency_ms=lat[True], plain_latency_ms=lat[False],
                flash_attention_launches=launches, device_busy_ms=busy_ms,
                flash_attention_device_ms=flash_ms, flash_attention_share=flash_ms / busy_ms,
                device_idle_share=max(0.0, 1.0 - busy_ms / lat[True]),
                top_device=[[k[:60], d / 1e3, c] for d, k, c, _ in device[:6]])


# ------------------------------------------------------------------ phase 15
LM_SERVE_ARCHS = ("qwen1.5-0.5b", "qwen3-8b", "qwen3-14b", "gemma-7b", "internvl2-1b",
                  "granite-moe-1b-a400m", "deepseek-v2-236b")
# the one depth cut: 472 GB of bf16 weights at 60 layers; 3 keep the dense
# layer and two MoE layers (160 experts, top-6, MLA at kv_lora 512)
LM_SERVE_DEPTH = {"deepseek-v2-236b": 3}
LM_SERVE_B, LM_SERVE_LEN, LM_SERVE_STEPS = 2, 1024, 16
LM_SERVE_TIMED = ("qwen3-8b", "granite-moe-1b-a400m")
LM_DECODE_BATCHES, LM_DECODE_TIMED_STEPS = (1, 8), 32
# the reference test's prefill/decode consistency tolerance (bf16)
CONSISTENCY_TOL = dict(rtol=5e-2, atol=5e-1)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| over max |b|, in float32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def lm_inputs(cfg, dev, b: int, seed: int):
    """``b`` prompts of ``LM_SERVE_LEN`` positions (the VLM's 256 frontend
    tokens among them) and ``LM_SERVE_STEPS`` teacher-forced decode tokens."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_front = cfg.n_frontend_tokens if cfg.frontend else 0
    tokens = torch.randint(0, cfg.vocab, (b, LM_SERVE_LEN - n_front), generator=gen, device=dev)
    steps = torch.randint(0, cfg.vocab, (LM_SERVE_STEPS, b, 1), generator=gen, device=dev)
    fe = (torch.randn((b, n_front, cfg.d_model), generator=gen, device=dev)
          if cfg.frontend else None)
    return tokens, steps, fe


class RoutingReplay:
    """Patches ``moe._router`` to record the expert choices of one run and
    hand them, call by call, to a second run, which takes its own gates at
    those experts (renormalised) and counts the tokens whose own top-k set
    differs.  A top-k choice within a bf16 rounding of a tie goes either
    way, and one different expert moves a token's state by a gate's share
    of an expert's output: two paths that round differently are compared
    on the same choices, and the count says how many of them their own
    routers would have changed.

    ``calls`` starts from another replay's record.  ``shards``, for a replay
    over a mesh, is each shard's (data index, data size) in the mesh's
    order: there the shards call the router one after another on their data
    slices, so each recorded call serves ``len(shards)`` calls, each its
    shard's slice of the recorded rows (the model shards of a data group
    take the same slice)."""

    def __init__(self, calls=None, shards=None):
        self.calls, self.mode, self.at = list(calls or []), None, 0
        self.shards = shards
        self.tokens = 0
        self._differing = []

    @property
    def differing(self) -> int:
        return int(sum(int(d) for d in self._differing))

    @property
    def expected(self) -> int:
        """The router calls that replay every recorded call once."""
        return len(self.calls) * (len(self.shards) if self.shards else 1)

    def _wanted(self):
        if not self.shards:
            return self.calls[self.at]
        full = self.calls[self.at // len(self.shards)]
        d, dp = self.shards[self.at % len(self.shards)]
        rows = full.shape[0] // dp
        return full[d * rows:(d + 1) * rows]

    def run(self, mode: str):
        import contextlib

        from repro_torch.models.lm import moe as moe_lib

        @contextlib.contextmanager
        def patched():
            orig = moe_lib._router

            def router(p, x_flat, cfg):
                gates, idx = orig(p, x_flat, cfg)
                if self.mode == "record":
                    self.calls.append(idx)
                    return gates, idx
                want = self._wanted()
                self.at += 1
                self.tokens += idx.shape[0]
                # summed on the device: no host sync inside the run
                self._differing.append((idx.sort(-1).values != want.sort(-1).values)
                                       .any(-1).sum())
                probs = torch.softmax(x_flat.to(torch.float32) @ p["router"], dim=-1)
                g = probs.gather(-1, want)
                return g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9), want

            self.mode = mode
            moe_lib._router = router
            try:
                yield self
            finally:
                moe_lib._router = orig
                self.mode = None

        return patched()


def lm_serve_run(lm, params, tokens, steps, fe, max_seq: int) -> dict:
    """Prefill then teacher-forced decode steps; the flash_attention launches
    (counts reset just before the prefill) of the prefill and of each step."""
    from repro_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_launch_counts()
    logits, cache = lm.prefill(params, tokens, fe, max_seq=max_seq)
    torch.cuda.synchronize()
    prefill_launches, paths = build.LAUNCHES["flash_attention"], dict(build.PATHS)
    out = [logits]
    for tok in steps:
        logits, cache = lm.decode_step(params, cache, tok)
        out.append(logits)
    torch.cuda.synchronize()
    return dict(logits=out, cache=cache, prefill_launches=prefill_launches, paths=paths,
                decode_launches=build.LAUNCHES["flash_attention"] - prefill_launches)


def lm_timings(cfg, params, card: str) -> dict:
    """Prefill of the phase's (B, 1024) prompts (CUDA events, median of 5)
    and decode ms a step at B = 1 and 8 after 1024-position prompts."""
    from repro_torch.models.lm import LM

    lm, dev = LM(cfg), params["embed"].device
    tokens, _, fe = lm_inputs(cfg, dev, LM_SERVE_B, seed=11)
    max_seq = LM_SERVE_LEN + LM_DECODE_TIMED_STEPS + 1  # one more step is profiled
    out = {}
    lm.prefill(params, tokens, fe, max_seq=max_seq)
    times = []
    for _ in range(5):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        lm.prefill(params, tokens, fe, max_seq=max_seq)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    out["prefill_ms"] = statistics.median(times)
    out["prefill_tokens"] = LM_SERVE_B * LM_SERVE_LEN
    for b in LM_DECODE_BATCHES:
        tokens, _, fe = lm_inputs(cfg, dev, b, seed=12)
        steps = torch.randint(0, cfg.vocab, (LM_DECODE_TIMED_STEPS, b, 1), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(13))
        _, cache = lm.prefill(params, tokens, fe, max_seq=max_seq)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(LM_DECODE_TIMED_STEPS + 1)]
        events[0].record()
        for i, tok in enumerate(steps):
            lm.decode_step(params, cache, tok)
            events[i + 1].record()
        torch.cuda.synchronize()
        per_step = [a.elapsed_time(z) for a, z in zip(events, events[1:])]
        out[f"decode_b{b}_ms_per_step"] = statistics.median(per_step)
        out[f"decode_b{b}_ms_mean"] = sum(per_step) / len(per_step)
        if b == 1:
            out["decode_b1_profile"] = decode_profile(lm, params, cache, steps[0], cfg.arch_id)
        del cache
    print(f"lm serving {cfg.arch_id} timings: prefill {LM_SERVE_B}x{LM_SERVE_LEN} "
          f"{out['prefill_ms']:.3f} ms (median of 5); decode "
          + ", ".join(f"B={b} {out[f'decode_b{b}_ms_per_step']:.3f} ms a step (median, mean "
                      f"{out[f'decode_b{b}_ms_mean']:.3f}, {LM_DECODE_TIMED_STEPS} steps)"
                      for b in LM_DECODE_BATCHES) + f"; one B=1 step profiled: "
          f"{json.dumps(out['decode_b1_profile'])} [{card}]", flush=True)
    return out


# The profiled B = 1 decode step before the forward was one body (commit
# 5c40f32; NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's:
# device launches and host operators as this phase counted them, and the
# host's launch and copy calls (``lm_forward_ab.py decode-launches``).  The
# profiler's device rows drop some launches in some steps (3652-3726 for one
# tree's qwen3-8b steps), so the host's calls are the exact count.
EARLIER_DECODE_B1 = {
    "qwen3-8b": dict(device_launches=3714, host_operators=12651, launch_calls=3726),
    "granite-moe-1b-a400m": dict(device_launches=2668, host_operators=11739, launch_calls=2681),
}
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")


def decode_profile(lm, params, cache, tok, arch: str) -> dict:
    """One decode step under ``torch.profiler``: its host wall time, device
    busy time, host operators, launch calls and the device's top entries (and
    the earlier figures of ``EARLIER_DECODE_B1``, where the config has them)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lm.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, device = profile_rows(prof, ROOT / "build" / f"chip_smoke_profile_decode_{arch}.txt")
    busy_ms = sum(r[0] for r in device) / 1e3
    earlier = EARLIER_DECODE_B1.get(arch, {})
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                device_launches=sum(r[2] for r in device),
                host_operators=sum(r[2] for r in rows if r[3] > 0.0 and r[1].startswith("aten::")),
                launch_calls=sum(r[2] for r in rows if r[1].startswith(LAUNCH_CALLS)),
                **{f"earlier_{k}": v for k, v in earlier.items()},
                top_device=[[k[:60], d / 1e3, c] for d, k, c, _ in device[:5]],
                top_host=[[k[:40], h / 1e3, c] for _, k, c, h in
                          sorted(rows, key=lambda r: -r[3])[:5]])


def lm_serve_config(arch: str, dev, card: str) -> dict:
    """One config at full width: kernel path against plain path, prefill /
    decode consistency, the capacity guard, and for granite the sorted MoE
    backend run to run and against the einsum backend."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.models.lm.cache import DECODE_RESERVE
    from repro_torch.models.lm.moe import dropless
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config(arch)
    rec = dict(arch=arch, family=cfg.family, d_model=cfg.d_model, n_layers=cfg.n_layers)
    if arch in LM_SERVE_DEPTH:
        cut = LM_SERVE_DEPTH[arch]
        print(f"lm serving {arch}: depth cut from {cfg.n_layers} to {cut} layers "
              f"({cfg.dense_layers} dense, {cut - cfg.dense_layers} MoE); full width", flush=True)
        rec["depth_cut_from"] = cfg.n_layers
        cfg = dataclasses.replace(cfg, n_layers=cut)
        rec["n_layers"] = cut
    torch.cuda.reset_peak_memory_stats()
    rec["allocated_before"] = torch.cuda.memory_allocated()  # earlier phases' tensors
    t0 = time.perf_counter()
    params = LM(cfg).init(torch.Generator(device=dev).manual_seed(0))
    leaves = tree_leaves(params)
    rec["param_bytes"] = sum(t.numel() * t.element_size() for t in leaves)
    rec["params"] = sum(t.numel() for t in leaves)
    rec["init_s"] = time.perf_counter() - t0
    max_seq = LM_SERVE_LEN + DECODE_RESERVE
    tokens, steps, fe = lm_inputs(cfg, dev, LM_SERVE_B, seed=1)
    runs = {}
    replay = RoutingReplay()
    with torch.no_grad():
        for use_kernel, mode in ((True, "record"), (False, "replay")):
            with replay.run(mode) if cfg.moe else contextlib.nullcontext():
                runs[use_kernel] = lm_serve_run(LM(cfg, use_kernel=use_kernel), params, tokens,
                                                steps, fe, max_seq)
        kernel, plain = runs[True], runs[False]
        if cfg.moe:
            require(replay.at == len(replay.calls), f"{arch}: {replay.at} of "
                    f"{len(replay.calls)} recorded routings replayed")
            rec["routing_replayed"] = dict(tokens=replay.tokens, own_choice_differs=replay.differing)
        require(kernel["prefill_launches"] == cfg.n_layers,
                f"{arch}: {kernel['prefill_launches']} flash_attention launches in prefill, "
                f"expected {cfg.n_layers}")
        require(kernel["decode_launches"] == 0 and plain["prefill_launches"] == 0
                and plain["decode_launches"] == 0,
                f"{arch}: flash_attention launched in decode or on the plain path")
        vocab = cfg.vocab
        errs = [rel_err(a[:, :vocab], b[:, :vocab])
                for a, b in zip(kernel["logits"], plain["logits"])]
        cache_errs = {n: rel_err(kernel["cache"][n], plain["cache"][n])
                      for n in kernel["cache"] if n != "pos"}
        for a in kernel["logits"]:
            require(bool(torch.isfinite(a[:, :vocab]).all()), f"{arch}: logits not finite")
        require(max(errs) < STATE_REL_TOL and max(cache_errs.values()) < STATE_REL_TOL,
                f"{arch}: kernel path against plain path: logits {errs}, cache {cache_errs} "
                f"beyond {STATE_REL_TOL}")
        require(kernel["cache"]["pos"] == LM_SERVE_LEN + LM_SERVE_STEPS,
                f"{arch}: cache pos {kernel['cache']['pos']}")
        if cfg.mla:
            d, dv = cfg.mla.nope_dim + cfg.mla.rope_dim, cfg.mla.v_dim
        else:
            d = dv = cfg.resolved_head_dim
        rec.update(prefill_logits_rel_err=errs[0], decode_logits_rel_err=max(errs[1:]),
                   cache_rel_err=cache_errs, flash_attention_launches=kernel["prefill_launches"],
                   head_dims=[d, dv], paths={n: c for n, c in kernel["paths"].items()
                                             if n.startswith("flash_attention.")},
                   cache_bytes=sum(t.numel() * t.element_size()
                                   for n, t in kernel["cache"].items() if n != "pos"))
        del runs, kernel, plain

        # prefill / decode consistency on the kernel path, one prompt; MoE
        # dropless and sorted (an expert's capacity follows the token count,
        # and the einsum groups do not divide 1023 tokens)
        ccfg = dropless(cfg) if cfg.moe else cfg
        lm = LM(ccfg, moe_backend="sorted" if cfg.moe else "einsum")
        t1, _, fe1 = lm_inputs(cfg, dev, 1, seed=2)
        full, _ = lm.prefill(params, t1, fe1)
        _, cache = lm.prefill(params, t1[:, :-1], fe1)
        step, _ = lm.decode_step(params, cache, t1[:, -1:])
        full, step = full[:, :vocab], step[:, :vocab]
        gap = float((step - full).abs().max())
        require(torch.allclose(step, full, **CONSISTENCY_TOL),
                f"{arch}: decode(prefill(t[:-1]), t[-1]) against prefill(t): max |diff| {gap}")
        rec["consistency_max_abs_diff"] = gap
        del cache

        # the capacity guard: a cache of 9 positions after an 8-token prompt
        lm = LM(cfg)
        _, cache = lm.prefill(params, tokens[:1, :8], fe[:1] if fe is not None else None,
                              max_seq=9 + (cfg.n_frontend_tokens if cfg.frontend else 0))
        lm.decode_step(params, cache, tokens[:1, :1])
        try:
            lm.decode_step(params, cache, tokens[:1, :1])
            require(False, f"{arch}: decode past max_seq did not raise")
        except ValueError as e:
            require("KV cache exhausted" in str(e), f"{arch}: guard raised {e}")
        del cache

        if arch == "granite-moe-1b-a400m":
            rec["sorted_backend"] = sorted_backend_check(cfg, params, tokens, fe, max_seq)
        if arch in LM_SERVE_TIMED:
            rec["timings"] = lm_timings(cfg, params, card)
    torch.cuda.synchronize()
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    rec["seconds"] = time.perf_counter() - t0
    del params, leaves
    return rec


def sorted_backend_check(cfg, params, tokens, fe, max_seq) -> dict:
    """The sorted MoE backend's prefill twice (bitwise equal), and against the
    einsum backend's on the sorted run's expert choices (``RoutingReplay``),
    both dropless (their capacities differ by design: per group of 256
    tokens against the whole call)."""
    from repro_torch.models.lm import LM
    from repro_torch.models.lm.moe import dropless

    lm = LM(cfg, moe_backend="sorted")
    (a, ca), (b, cb) = (lm.prefill(params, tokens, fe, max_seq=max_seq) for _ in range(2))
    require(torch.equal(a, b) and all(torch.equal(ca[n], cb[n]) for n in ca if n != "pos"),
            "granite: the sorted MoE backend is not bitwise equal run to run")
    del ca, cb
    replay = RoutingReplay()
    with replay.run("record"):
        s_log, s_cache = LM(dropless(cfg), moe_backend="sorted").prefill(params, tokens, fe,
                                                                          max_seq=max_seq)
    with replay.run("replay"):
        e_log, e_cache = LM(dropless(cfg), moe_backend="einsum").prefill(params, tokens, fe,
                                                                          max_seq=max_seq)
    vocab = cfg.vocab
    out = dict(bitwise_run_to_run=True,
               routing_replayed=dict(tokens=replay.tokens, own_choice_differs=replay.differing),
               logits_rel_err=rel_err(s_log[:, :vocab], e_log[:, :vocab]),
               cache_rel_err={n: rel_err(s_cache[n], e_cache[n]) for n in s_cache if n != "pos"})
    require(out["logits_rel_err"] < STATE_REL_TOL
            and max(out["cache_rel_err"].values()) < STATE_REL_TOL,
            f"granite: sorted against einsum backend (dropless): {out}")
    return out


# flash_attention at head dims the LM-head phases do not reach: gemma-7b's
# 256 and deepseek-v2-236b's MLA (q/k 192, v 128), one 2 x 1024 prefill each
LM_SERVE_ATTENTION = {
    "gemma_7b_2x16x1024x256": (2, 16, 16, 1024, 1024, 256, 256),
    "deepseek_mla_2x128x1024x192_v128": (2, 128, 128, 1024, 1024, 192, 128),
}


def lm_serving_attention(dev, card: str) -> dict:
    """The kernel against its plain version (and its emulated roundings) at
    the new served head dims, timed beside the plain version and SDPA."""
    out = {}
    for i, (name, shape) in enumerate(LM_SERVE_ATTENTION.items()):
        qkv, err = attention_check(dev, name, shape, torch.bfloat16, True, seed=100 + i)
        out[name] = dict(attention_timings(dev, qkv, True, reps=5), max_abs_err=err)
        r = out[name]
        print(f"flash_attention {name}: {r['ms']:.5f} ms (eager {r['eager_ms']:.4f}, plain "
              f"{r['plain_ms']:.4f}, SDPA {r['library_ms']:.5f}, bound {r['bound_ms']:.5f} "
              f"by {r['bound_by']}) [{card}]", flush=True)
        del qkv
    return out


def lm_serving_phase(dev, card: str) -> dict:
    """Phase 15: LM serving (prefill, decode, the KV cache) for the seven
    ported configs at full width, one model on the card at a time."""
    import gc

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    out, launches = {"attention": lm_serving_attention(dev, card)}, collections.Counter()
    for arch in LM_SERVE_ARCHS:
        rec = lm_serve_config(arch, dev, card)
        launches["flash_attention"] += rec["flash_attention_launches"]
        print(f"lm serving {arch}: {rec['n_layers']} layers, d {rec['d_model']}, "
              f"{rec['params']} parameters ({rec['param_bytes']} bytes), cache "
              f"{rec['cache_bytes']} bytes at B={LM_SERVE_B} x {LM_SERVE_LEN + 64}, peak "
              f"{rec['max_memory_allocated']} bytes allocated ("
              f"{rec['max_memory_allocated'] - rec['allocated_before']} above the "
              f"{rec['allocated_before']} held before the model); flash_attention "
              f"{rec['flash_attention_launches']} launches a prefill, 0 a decode step, head dims "
              f"q/k {rec['head_dims'][0]} v {rec['head_dims'][1]}: {json.dumps(rec['paths'])}; "
              f"kernel vs plain: prefill logits {rec['prefill_logits_rel_err']:.3g}, decode "
              f"logits {rec['decode_logits_rel_err']:.3g}, cache "
              f"{json.dumps({n: round(e, 5) for n, e in rec['cache_rel_err'].items()})}; "
              f"consistency max |diff| {rec['consistency_max_abs_diff']:.3g}; "
              f"{rec['seconds']:.1f} s [{card}]", flush=True)
        if "routing_replayed" in rec:
            print(f"lm serving {arch}: the plain path took the kernel path's expert choices; "
                  f"its own router chose other experts for {rec['routing_replayed']['own_choice_differs']} "
                  f"of {rec['routing_replayed']['tokens']} routed tokens", flush=True)
        if "sorted_backend" in rec:
            print(f"lm serving {arch} sorted MoE backend: {json.dumps(rec['sorted_backend'])}",
                  flush=True)
        out[arch] = rec
        gc.collect()
        torch.cuda.empty_cache()
    build.reset_launch_counts()
    out["launches"] = dict(launches)
    out["seconds"] = time.perf_counter() - t0
    print(f"lm serving phase: {out['seconds']:.1f} s, flash_attention launches "
          f"{launches['flash_attention']} in kernel-path prefills [{card}]", flush=True)
    return out


# ------------------------------------------------------------------ phase 16
# (name, arch, batch, prompt positions): zamba2 past its 4096 window (8192 =
# 2 W, so S % W = 0 and the 16 decode steps wrap the ring) and below it;
# seamless's 256-token decoder prompts over 1024 frontend frames; xlstm
FAMILY_CASES = (("zamba2_b1x8192", "zamba2-2.7b", 1, 8192),
                ("zamba2_b2x1024", "zamba2-2.7b", 2, 1024),
                ("seamless_b2x256", "seamless-m4t-large-v2", 2, 256),
                ("xlstm_b2x1024", "xlstm-1.3b", 2, 1024))
FAMILY_STEPS = 16
# A family with attention is held to the float32 run of its weights (plain
# path): the kernel path no further from it than this factor times the bf16
# plain path's own distance.  At full depth zamba2's two bf16 paths lie
# 6.5-7% from the float32 run and 3.7% from each other (NVIDIA H100 80GB
# HBM3, 700 W; PERF.md §6), past STATE_REL_TOL; xlstm, with no attention,
# is bitwise.
ANCHOR_FACTOR = 1.5
# flash_attention at the shapes these families give it, before the models:
# zamba2's shared block at 8192 positions (head dim 80, window 4096) and
# seamless's cross attention (256 decoder positions on 1024 frames)
FAMILY_ATTENTION = {
    "zamba2_window_1x32x8192x80_w4096": ((1, 32, 32, 8192, 8192, 80, 80), True, 4096),
    "seamless_cross_2x16x256on1024x64": ((2, 16, 16, 256, 1024, 64, 64), False, 0),
}


def family_inputs(cfg, dev, b: int, s: int, seed: int):
    """``b`` prompts of ``s`` tokens, ``FAMILY_STEPS`` teacher-forced decode
    tokens and, for the audio family, ``n_frontend_tokens`` frames."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    steps = torch.randint(0, cfg.vocab, (FAMILY_STEPS, b, 1), generator=gen, device=dev)
    fe = (torch.randn((b, cfg.n_frontend_tokens, cfg.d_model), generator=gen, device=dev)
          if cfg.frontend else None)
    return tokens, steps, fe


@contextlib.contextmanager
def attention_kinds():
    """Counts each ``flash_attention`` launch that ``ops.attention`` makes by
    (kind, head dim): ``window``, ``causal``, ``bidirectional`` or ``cross``
    (non-causal, Sq ≠ Sk)."""
    from repro_torch.kernels.flash_attention import ops as attn_ops

    orig, kinds = attn_ops.flash_attention, collections.Counter()

    def spy(q, k, v, *, causal=True, window=0):
        out = orig(q, k, v, causal=causal, window=window)
        kind = ("window" if window else "causal" if causal
                else "cross" if q.shape[2] != k.shape[2] else "bidirectional")
        kinds[f"{kind}_d{q.shape[-1]}"] += 1
        return out

    attn_ops.flash_attention = spy
    try:
        yield kinds
    finally:
        attn_ops.flash_attention = orig


def family_timings(cfg, params, s: int, card: str) -> dict:
    """Prefill of (2, s) prompts (CUDA events, median of 3; the case runs
    before warmed it up) and decode ms a step at B = 1 and 8 after
    s-position prompts (median of 16 steps)."""
    from repro_torch.models.lm import LM

    lm, dev = LM(cfg), params["embed"].device
    out = {}
    tokens, _, fe = family_inputs(cfg, dev, 2, s, seed=11)
    times = []
    for _ in range(3):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        lm.prefill(params, tokens, fe)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    out["prefill_ms"] = statistics.median(times)
    out["prefill_shape"] = [2, s]
    for b in LM_DECODE_BATCHES:
        tokens, steps, fe = family_inputs(cfg, dev, b, s, seed=12)
        _, cache = lm.prefill(params, tokens, fe)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(FAMILY_STEPS + 1)]
        events[0].record()
        for i, tok in enumerate(steps):
            lm.decode_step(params, cache, tok)
            events[i + 1].record()
        torch.cuda.synchronize()
        per_step = [a.elapsed_time(z) for a, z in zip(events, events[1:])]
        out[f"decode_b{b}_ms_per_step"] = statistics.median(per_step)
        del cache
    print(f"lm families {cfg.arch_id} timings: prefill 2x{s} {out['prefill_ms']:.3f} ms "
          f"(median of 3); decode " + ", ".join(
              f"B={b} {out[f'decode_b{b}_ms_per_step']:.3f} ms a step" for b in LM_DECODE_BATCHES)
          + f" (median of {FAMILY_STEPS}) [{card}]", flush=True)
    return out


def _run_errors(a: dict, b: dict, vocab: int) -> dict:
    """Relative errors of run a against run b: logits (max over the prefill
    and the decode steps) and each cache leaf."""
    return dict(logits=max(rel_err(x[:, :vocab], y[:, :vocab])
                           for x, y in zip(a["logits"], b["logits"])),
                **{k: rel_err(a["cache"][k], b["cache"][k]) for k in a["cache"] if k != "pos"})


def _float32(tree):
    return ({k: _float32(v) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.float())


def family_case(name, cfg, params, b, s, dev, card) -> dict:
    """One case, kernel path against plain path: prefill then
    ``FAMILY_STEPS`` teacher-forced decode steps; with attention, both
    against the float32 plain run of the same weights (``ANCHOR_FACTOR``),
    without, bitwise."""
    from repro_torch.models.lm import LM

    tokens, steps, fe = family_inputs(cfg, dev, b, s, seed=1)
    hd = cfg.resolved_head_dim
    expected = {"hybrid": {f"window_d{hd}": cfg.n_layers // max(cfg.attn_every, 1)},
                "audio": {f"bidirectional_d{hd}": cfg.enc_layers, f"causal_d{hd}": cfg.n_layers,
                          f"cross_d{hd}": cfg.n_layers},
                "ssm": {}}[cfg.family]
    runs = {}
    for use_kernel in (True, False):
        with attention_kinds() as kinds:
            t0 = time.perf_counter()
            runs[use_kernel] = lm_serve_run(LM(cfg, use_kernel=use_kernel), params, tokens,
                                            steps, fe, max_seq=None)
            runs[use_kernel]["seconds"] = time.perf_counter() - t0
            runs[use_kernel]["kinds"] = dict(kinds)
    kernel, plain = runs[True], runs[False]
    n = sum(expected.values())
    require(kernel["prefill_launches"] == n and kernel["kinds"] == expected,
            f"{name}: flash_attention launches {kernel['prefill_launches']} in prefill, "
            f"{kernel['kinds']}, expected {expected}")
    require(kernel["decode_launches"] == 0 and plain["prefill_launches"] == 0
            and plain["decode_launches"] == 0 and not plain["kinds"],
            f"{name}: flash_attention launched in decode or on the plain path")
    paths = {k: c for k, c in kernel["paths"].items() if k.startswith("flash_attention.")}
    require(paths == ({"flash_attention.tma": n} if n else {}),
            f"{name}: flash_attention paths {paths}")
    vocab = cfg.vocab
    errs = [rel_err(a[:, :vocab], b_[:, :vocab]) for a, b_ in zip(kernel["logits"], plain["logits"])]
    cache_errs = {k: rel_err(kernel["cache"][k], plain["cache"][k])
                  for k in kernel["cache"] if k != "pos"}
    for a in kernel["logits"]:
        require(bool(torch.isfinite(a[:, :vocab]).all()), f"{name}: logits not finite")
    require(kernel["cache"]["pos"] == s + FAMILY_STEPS, f"{name}: cache pos")
    anchor = {}
    if n:
        wide = _float32(params)
        f32 = lm_serve_run(LM(dataclasses.replace(cfg, dtype="float32"), use_kernel=False), wide,
                           tokens, steps, fe, max_seq=None)
        del wide
        anchor = {"kernel": _run_errors(kernel, f32, vocab), "plain": _run_errors(plain, f32, vocab)}
        del f32
        far = {k: (e, anchor["plain"][k]) for k, e in anchor["kernel"].items()
               if not e <= ANCHOR_FACTOR * anchor["plain"][k]}
        require(not far, f"{name}: kernel path further from the float32 run than {ANCHOR_FACTOR}x "
                f"the plain path: (kernel, plain) {far}")
    else:
        require(all(torch.equal(a, b_) for a, b_ in zip(kernel["logits"], plain["logits"]))
                and all(torch.equal(kernel["cache"][k], plain["cache"][k]) for k in cache_errs),
                f"{name}: no attention, yet the kernel and plain paths differ")
    rec = dict(shape=[b, s], prefill_logits_rel_err=errs[0], decode_logits_rel_err=max(errs[1:]),
               cache_rel_err=cache_errs, from_float32=anchor,
               flash_attention_launches=kernel["prefill_launches"],
               kinds=kernel["kinds"], paths=paths, head_dim=cfg.resolved_head_dim,
               kernel_run_s=kernel["seconds"], plain_run_s=plain["seconds"],
               cache_bytes=sum(t.numel() * t.element_size()
                               for k, t in kernel["cache"].items() if k != "pos"))
    if cfg.family == "hybrid":
        rec["ring_slots"] = kernel["cache"]["k"].shape[2]
    if name == "zamba2_b1x8192":
        # the last decode step (position 8207, after 16 writes that wrapped
        # the aligned ring's slots 0-15) against the prefill of all 8208
        # tokens, on the kernel path (8208 = 36 chunks of 228; 8193 would
        # run 2731 chunks of 3)
        full, _ = LM(cfg).prefill(params, torch.cat([tokens, *steps], dim=1))
        step, full = kernel["logits"][-1][:, :vocab], full[:, :vocab]
        rec["consistency_max_abs_diff"] = gap = float((step - full).abs().max())
        require(torch.allclose(step, full, **CONSISTENCY_TOL),
                f"{name}: the last decode step against prefill(t + steps): max |diff| {gap}")
    print(f"lm families {name}: B={b} x {s}, flash_attention {rec['flash_attention_launches']} "
          f"launches a prefill {json.dumps(rec['kinds'])}, 0 a decode step, paths "
          f"{json.dumps(paths)}; kernel vs plain: prefill logits {errs[0]:.3g}, decode logits "
          f"{rec['decode_logits_rel_err']:.3g}, cache "
          f"{json.dumps({k: round(e, 5) for k, e in cache_errs.items()})}"
          + (f"; from the float32 run, kernel "
             f"{json.dumps({k: round(e, 5) for k, e in anchor['kernel'].items()})}, plain "
             f"{json.dumps({k: round(e, 5) for k, e in anchor['plain'].items()})}"
             if anchor else "; bitwise (no attention)")
          + (f"; consistency max |diff| {rec['consistency_max_abs_diff']:.3g}"
             if "consistency_max_abs_diff" in rec else "")
          + f"; cache {rec['cache_bytes']} bytes; prefill + {FAMILY_STEPS} steps "
          f"{kernel['seconds']:.2f} s kernel, {plain['seconds']:.2f} s plain [{card}]",
          flush=True)
    return rec


def lm_families_attention(dev, card: str) -> dict:
    """The kernel against its plain version (and its emulated roundings) at
    the shapes the SSM, hybrid and audio families give it, timed beside the
    plain version and SDPA (with the window's boolean mask)."""
    out = {}
    for i, (name, (shape, causal, window)) in enumerate(FAMILY_ATTENTION.items()):
        qkv, err = attention_check(dev, name, shape, torch.bfloat16, causal, seed=200 + i,
                                   window=window)
        out[name] = r = dict(attention_timings(dev, qkv, causal, reps=5, window=window),
                             max_abs_err=err)
        print(f"flash_attention {name}: {r['ms']:.5f} ms (eager {r['eager_ms']:.4f}, plain "
              f"{r['plain_ms']:.4f}, SDPA {r['library_ms']:.5f}, bound {r['bound_ms']:.5f} "
              f"by {r['bound_by']}) [{card}]", flush=True)
        del qkv
    return out


def lm_families_phase(dev, card: str) -> dict:
    """Phase 16: LM serving for the SSM, hybrid and audio families at full
    published width, one model on the card at a time."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import tree_leaves

    t0 = time.perf_counter()
    out, launches = {"attention": lm_families_attention(dev, card)}, collections.Counter()
    gc.collect()
    torch.cuda.empty_cache()
    for arch in dict.fromkeys(a for _, a, _, _ in FAMILY_CASES):
        cfg = get_config(arch)
        t1 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        with torch.no_grad():
            params = LM(cfg).init(torch.Generator(device=dev).manual_seed(0))
            leaves = tree_leaves(params)
            rec = dict(family=cfg.family, n_layers=cfg.n_layers, d_model=cfg.d_model,
                       params=sum(t.numel() for t in leaves),
                       param_bytes=sum(t.numel() * t.element_size() for t in leaves),
                       allocated_before=before, cases={})
            del leaves
            for name, a, b, s in FAMILY_CASES:
                if a == arch:
                    rec["cases"][name] = family_case(name, cfg, params, b, s, dev, card)
                    launches["flash_attention"] += rec["cases"][name]["flash_attention_launches"]
            rec["timings"] = family_timings(cfg, params, min(s for _, a, _, s in FAMILY_CASES
                                                             if a == arch), card)
        torch.cuda.synchronize()
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        rec["seconds"] = time.perf_counter() - t1
        print(f"lm families {arch}: {cfg.family}, {cfg.n_layers} layers, d {cfg.d_model}, "
              f"{rec['params']} parameters ({rec['param_bytes']} bytes), peak "
              f"{rec['max_memory_allocated']} bytes allocated ({before} held before the "
              f"model); {rec['seconds']:.1f} s [{card}]", flush=True)
        out[arch] = rec
        del params
        gc.collect()
        torch.cuda.empty_cache()
    build.reset_launch_counts()
    out["launches"] = dict(launches)
    out["seconds"] = time.perf_counter() - t0
    print(f"lm families phase: {out['seconds']:.1f} s, flash_attention launches "
          f"{launches['flash_attention']} in kernel-path prefills [{card}]", flush=True)
    return out


# ------------------------------------------------------------------ phase 17
# the backward kernels at the shapes of the training path:
# name -> ((b, h, hkv, sq, sk, d, dv), causal, window, dtype)
BWD_SHAPES = {
    "qwen05b_4x16x1024x64_causal": ((4, 16, 16, 1024, 1024, 64, 64), True, 0, torch.bfloat16),
    "qwen3_8b_1x32on8x1024x128_causal": ((1, 32, 8, 1024, 1024, 128, 128), True, 0,
                                         torch.bfloat16),
    "mla_2x128x1024x192v128_causal": ((2, 128, 128, 1024, 1024, 192, 128), True, 0,
                                      torch.bfloat16),
    "zamba2_1x32x8192x80_window4096": ((1, 32, 32, 8192, 8192, 80, 80), True, 4096,
                                       torch.bfloat16),
    "seamless_2x16x1024x64_bidirectional": ((2, 16, 16, 1024, 1024, 64, 64), False, 0,
                                            torch.bfloat16),
    "seamless_cross_2x16x256on1024x64": ((2, 16, 16, 256, 1024, 64, 64), False, 0,
                                         torch.bfloat16),
    "gemma_2x16x1024x256_causal": ((2, 16, 16, 1024, 1024, 256, 256), True, 0, torch.bfloat16),
    "f32_1x16x512x64_causal": ((1, 16, 16, 512, 512, 64, 64), True, 0, torch.float32),
}
# the backward kernels against the plain backward, max |Δ| over max |plain|
# of each gradient: float32 differs in summation order only; bf16 gradients
# are float32 sums rounded once to bf16 (2^-8 relative)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# full-width training: qwen1.5-0.5b through Trainer, B x S tokens a step;
# 12 of its 24 layers since phase 20 joined, to keep the script near 600 s
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_SAVE = "qwen1.5-0.5b", 4, 1024, 5, 3
TRAIN_LAYERS = 12
# kernel path against plain path on one bf16 step, loss and grad norm
# relative: one bf16 ulp in an attention output moves later layers' bf16
# roundings (the LM paths' STATE_REL_TOL)
TRAIN_REL_TOL = STATE_REL_TOL
# the reference smoke test's bound on the step-0 loss around ln(vocab)
LOSS_AT_INIT_TOL = 1.5
# the attention projections' step-0 gradients, kernel path against plain
# path: max |g_kernel - g_plain| / max |g_plain| of each leaf, layer by layer
# (not the key bias: softmax over keys is blind to it, so its gradient is
# rounding noise on both paths).  In bf16 the sound paths read 0.0355 at
# full-width qwen1.5-0.5b and 0.0145-0.0347 on the nine configs with
# attention at .reduced() (MoE routing replayed), a zeroed dq or dk
# 0.908-1.0 (NVIDIA H100 80GB HBM3, 700 W)
ATTN_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bv", "wq_a", "wq_b", "wkv_a", "wkv_b")
ATTN_GRAD_TOL = 0.1


def bwd_work(shape, causal, window, itemsize) -> dict:
    """(bytes, operations) of each backward kernel and of the whole backward.

    The whole backward's function needs five products of the live pairs'
    size (S = QKᵀ, dP = dO·Vᵀ, dQ, dK, dV): 2.5 times the forward's two;
    q, k, v, o, dO and the row log-sum-exp read once, dq, dk, dv written
    once.  Alone, the dQ kernel's function needs S, dP and dQ (reading q, k,
    v, o, dO and L, writing dq and Δ), the dK/dV kernel's S, dP, dK and dV
    (reading q, k, v, dO, L and Δ, writing dk and dv)."""
    b, h, hkv, sq, sk, d, dv = shape
    pairs = b * h * live_pairs(sq, sk, causal, window)
    q, o = b * h * sq * d, b * h * sq * dv
    k, v = b * hkv * sk * d, b * hkv * sk * dv
    rows = b * h * sq * 4
    return {
        "backward": (itemsize * (2 * q + 2 * k + 2 * v + 2 * o) + rows,
                     2.5 * pairs * (2 * d + 2 * dv)),
        "flash_attention_bwd_dq": (itemsize * (2 * q + k + v + 2 * o) + 2 * rows,
                                   pairs * (4 * d + 2 * dv)),
        "flash_attention_bwd_dkv": (itemsize * (q + 2 * k + 2 * v + o) + 2 * rows,
                                    pairs * (4 * d + 4 * dv)),
    }


def plain_backward(q, k, v, o, do, causal, window):
    """The plain backward, KV head by KV head (with its query heads) where
    one call's (B, H, Sq, Sk) float32 matrices would pass 4 GiB."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    b, h, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if b * h * sq * sk * 4 <= 4 << 30:
        return flash_attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
    g = h // hkv
    parts = [flash_attention_bwd_ref(q[:, j * g:(j + 1) * g], k[:, j:j + 1], v[:, j:j + 1],
                                     o[:, j * g:(j + 1) * g], do[:, j * g:(j + 1) * g],
                                     causal=causal, window=window) for j in range(hkv)]
    return tuple(torch.cat([p[i] for p in parts], dim=1) for i in range(3))


def sdpa_backward_ms(q, k, v, do, causal, window, reps) -> float | None:
    """Device ms of autograd's backward of ``F.scaled_dot_product_attention``
    on the same inputs (the window as a boolean mask), or None where SDPA
    refuses the shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import live_keys

    h, hkv = q.shape[1], k.shape[1]
    mask = live_keys(q.shape[2], k.shape[2], causal, window, q.device) if window else None
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    try:
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                             is_causal=causal and mask is None,
                                             enable_gqa=hkv != h)
        run = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)  # noqa: E731
        run()
        return _events_ms(run, reps)
    except (RuntimeError, TypeError):  # a shape no SDPA backend takes, or no enable_gqa
        return None


def backward_case(dev, name, shape, causal, window, dtype, seed, card) -> dict:
    """The two backward kernels against the plain backward on seeded inputs
    (the forward's output and row log-sum-exp from the kernel), each kernel
    timed (CUDA-graph replay) beside its bound, the plain backward and
    SDPA's autograd backward."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import backward as bwd
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention

    b, h, hkv, sq, sk, d, dv = shape
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(dev, dtype)
                   for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv), (b, h, sq, dv)))
    out, lse = flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    build.reset_launch_counts()
    got = bwd.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    require(build.LAUNCHES == {bwd.DQ: 1, bwd.DKV: 1},
            f"backward {name}: launches {dict(build.LAUNCHES)}")
    # bf16 on the tensor cores fed by TMA, float32 on the scalar kernels
    path = "tma" if dtype == torch.bfloat16 else "simt"
    require(build.PATHS == {f"{bwd.DQ}.{path}": 1, f"{bwd.DKV}.{path}": 1},
            f"backward {name}: paths {dict(build.PATHS)}, expected {path}")
    want = plain_backward(q, k, v, out, do, causal, window)
    errs, abs_errs = {}, {}
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        require(g.dtype == dtype and g.shape == w.shape and bool(torch.isfinite(g).all()),
                f"backward {name}: {what} {g.dtype} {tuple(g.shape)} or not finite")
        abs_errs[what] = float((g.float() - w.float()).abs().max())
        errs[what] = abs_errs[what] / float(w.float().abs().max())
        require(errs[what] < BWD_TOL[dtype],
                f"backward {name}: {what} max |err| / max |plain| {errs[what]} beyond "
                f"{BWD_TOL[dtype]}")
    del want
    prepared = bwd.prepare(q, k, v, out, lse, do, causal=causal, window=window)
    bwd.launch(bwd.DQ, prepared)
    reps = 3 if sq * sk > 1 << 24 else 10
    times = {n: time_ms(lambda n=n: bwd.launch(n, prepared), reps) for n in (bwd.DQ, bwd.DKV)}
    build.reset_launch_counts()
    plain_ms = _events_ms(lambda: plain_backward(q, k, v, out, do, causal, window), 2)
    library_ms = sdpa_backward_ms(q, k, v, do, causal, window, 3)
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    work = bwd_work(shape, causal, window, q.element_size())
    bounds = {n: bound(*w, ops_per_s=peak) for n, w in work.items()}
    rec = dict(shape=[b, h, hkv, sq, sk, d, dv], causal=causal, window=window,
               dtype=str(dtype).removeprefix("torch."), path=path, rel_err=errs,
               max_abs_err=abs_errs,
               plain_ms=plain_ms, library_ms=library_ms,
               backward_bound_ms=bounds["backward"][0], backward_bound_by=bounds["backward"][1],
               kernels={n: dict(ms=times[n][0], eager_ms=times[n][1], bound_ms=bounds[n][0],
                                bound_by=bounds[n][1]) for n in (bwd.DQ, bwd.DKV)})
    total = sum(r["ms"] for r in rec["kernels"].values())
    print(f"flash_attention backward {name} ({path}): dq {times[bwd.DQ][0]:.4f} ms (bound "
          f"{bounds[bwd.DQ][0]:.4f} by {bounds[bwd.DQ][1]}), dkv {times[bwd.DKV][0]:.4f} ms "
          f"(bound {bounds[bwd.DKV][0]:.4f} by {bounds[bwd.DKV][1]}), both {total:.4f} ms "
          f"against the whole backward's bound {bounds['backward'][0]:.4f} ms; plain "
          f"{plain_ms:.3f} ms, SDPA autograd "
          + ("refused" if library_ms is None else f"{library_ms:.4f} ms")
          + f"; max |err| / max |plain| {json.dumps({k: round(e, 6) for k, e in errs.items()})}"
          f" [{card}]", flush=True)
    return rec


def attn_grads(model, params, batch) -> dict:
    """The step-0 gradients of the attention projections: leaf path ->
    float32 tensor."""
    from repro_torch.models.lm.sharding import active_rules, gather_params
    from repro_torch.train.step import loss_and_grads

    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for key, sub in tree.items():
                walk(sub, path + (key,))
        elif isinstance(tree, (list, tuple)):
            for i, sub in enumerate(tree):
                walk(sub, path + (str(i),))
        elif path[-1] in ATTN_LEAVES:
            out["/".join(path)] = tree.float()

    grads = loss_and_grads(model, params, batch)[2]
    if active_rules() is not None:  # Sharded leaves over the mesh of the rules
        grads = gather_params(grads)
    walk(grads, ())
    return out


def attn_grad_errs(got: dict, want: dict) -> dict:
    """max |got - want| / max |want| of each attention leaf; a leaf stacked
    over layers (under ``blocks``, ``enc_blocks``, ``dec_blocks``) layer by
    layer, its largest kept."""
    errs = {}
    for name, w in want.items():
        g = got[name]
        if not name.split("/")[0].endswith("blocks"):
            g, w = g[None], w[None]
        worst = 0.0
        for a, b in zip(g, w):
            diff, den = float((a - b).abs().max()), float(b.abs().max())
            worst = max(worst, diff / den if den else (0.0 if diff == 0.0 else math.inf))
        errs[name] = worst
    return errs


@contextlib.contextmanager
def planted_backward_fault(which: str):
    """The attention backward with its ``dq`` or ``dk`` zeroed: the fault
    that the gradient check must catch."""
    from repro_torch.kernels.flash_attention import autograd

    real, slot = autograd.flash_attention_bwd, ("dq", "dk").index(which)

    def faulty(*args, **kwargs):
        grads = list(real(*args, **kwargs))
        grads[slot] = torch.zeros_like(grads[slot])
        return tuple(grads)

    autograd.flash_attention_bwd = faulty
    try:
        yield
    finally:
        autograd.flash_attention_bwd = real


def attn_grad_check(kernel_lm, plain_lm, params, batch, what: str) -> dict:
    """The attention leaves' step-0 gradients of the kernel path against the
    plain path within ``ATTN_GRAD_TOL``, and each planted fault beyond it.
    A MoE config's kernel-path runs replay the plain path's expert choices
    (``RoutingReplay``)."""
    replay = RoutingReplay()

    def grads(lm, mode):
        if not lm.cfg.moe:
            return attn_grads(lm, params, batch)
        replay.at = 0
        with replay.run(mode):
            out = attn_grads(lm, params, batch)
        require(mode == "record" or replay.at == len(replay.calls), f"{what}: {replay.at} of "
                f"{len(replay.calls)} recorded routings replayed")
        return out

    want = grads(plain_lm, "record")
    sound = attn_grad_errs(grads(kernel_lm, "replay"), want)
    faults = {}
    for which in ("dq", "dk"):
        with planted_backward_fault(which):
            faults[which] = max(attn_grad_errs(grads(kernel_lm, "replay"), want).values())
    require(max(sound.values()) <= ATTN_GRAD_TOL,
            f"{what}: attention gradients, kernel path against plain path, {sound} beyond "
            f"{ATTN_GRAD_TOL}")
    require(min(faults.values()) > ATTN_GRAD_TOL,
            f"{what}: a planted backward fault reads {faults}, within {ATTN_GRAD_TOL}")
    return dict(worst=max(sound.values()), leaves=sound, planted=faults)


def train_step_profile(step_fn, params, opt, batch, path: Path) -> dict:
    """One train step under ``torch.profiler``: device-busy ms, the
    flash_attention forward and backward kernels' device ms, top entries."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step_fn(params, opt, batch, 0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    del out
    _, device = profile_rows(prof, path)
    busy = sum(r[0] for r in device) / 1e3
    fwd = sum(r[0] for r in device if "flash_attention_kernel" in r[1]) / 1e3
    bwd = sum(r[0] for r in device if "dq_kernel" in r[1] or "dkv_kernel" in r[1]) / 1e3
    require(fwd > 0.0 and bwd > 0.0, "train-step profile shows no flash_attention forward or "
                                     "backward device time")
    return dict(profiled_wall_ms=wall, device_busy_ms=busy, device_idle_share=max(
        0.0, 1.0 - busy / wall), flash_attention_fwd_ms=fwd, flash_attention_bwd_ms=bwd,
        device_launches=sum(r[2] for r in device),
        top_device=[[k[:70], d / 1e3, c] for d, k, c, _ in device[:8]])


def full_width_training(dev, card) -> dict:
    """Phase 17(b): full-width qwen1.5-0.5b through ``Trainer`` (bf16,
    float32 moments, remat), the main path of this phase."""
    import gc
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    tc = TrainerConfig(batch_size=TRAIN_B, seq_len=TRAIN_S, total_steps=TRAIN_STEPS + 1,
                       save_every=TRAIN_SAVE, lr=3e-4, warmup=2)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(LM(cfg, remat=True), str(root / "run"), tc, device=dev)
    params, opt = trainer.init_state()
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(opt.nu))
    n_params = sum(t.numel() for t in tree_leaves(params))
    # the host snapshot that a save takes on the training thread, between
    # one step's dt and the next step's start
    save_ms, real_save = [], trainer.manager.save

    def timed_save(*args, **kwargs):
        t = time.perf_counter()
        real_save(*args, **kwargs)
        save_ms.append((time.perf_counter() - t) * 1e3)

    trainer.manager.save = timed_save
    # the main path: counts set to 0 just before, read just after
    build.reset_launch_counts()
    t0 = time.perf_counter()
    (params, opt), hist = trainer.run(steps=TRAIN_STEPS, state=(params, opt))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    paths = dict(build.PATHS)
    peak = torch.cuda.max_memory_allocated()
    require([h["step"] for h in hist] == list(range(TRAIN_STEPS)), f"training steps {hist}")
    require(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist),
            f"training: a loss or grad norm is not finite: {hist}")
    ln_v = math.log(cfg.vocab)
    require(abs(hist[0]["loss"] - ln_v) < LOSS_AT_INIT_TOL,
            f"step-0 loss {hist[0]['loss']} not within {LOSS_AT_INIT_TOL} of ln V = {ln_v}")
    require(trainer.manager.steps() == [TRAIN_SAVE],
            f"checkpoints {trainer.manager.steps()}, expected [{TRAIN_SAVE}]")
    per_step = {n: c / TRAIN_STEPS for n, c in launches.items()}
    require(per_step.get("flash_attention_bwd_dq") == per_step.get("flash_attention_bwd_dkv")
            == cfg.n_layers and per_step.get("flash_attention") == 2 * cfg.n_layers,
            f"launches a step {per_step}: expected {cfg.n_layers} of each backward kernel and "
            f"{2 * cfg.n_layers} forward (remat recomputes each layer's)")
    for kname in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        require(paths.get(f"{kname}.tma") == launches.get(kname),
                f"training: {kname} launched {launches.get(kname)} times, {paths} by path: "
                f"every bf16 backward launch must take the tensor cores fed by TMA")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()

    # a fresh Trainer resumes from the step-3 checkpoint: steps 4 and 5 bitwise
    t1 = time.perf_counter()
    resumed = Trainer(LM(cfg, remat=True), str(root / "run"), tc, device=dev)
    (params, opt), hist2 = resumed.run(steps=TRAIN_STEPS - TRAIN_SAVE)
    resume_s = time.perf_counter() - t1
    want = [(h["step"], h["loss"], h["grad_norm"]) for h in hist[TRAIN_SAVE:]]
    got = [(h["step"], h["loss"], h["grad_norm"]) for h in hist2]
    require(got == want, f"resumed steps {got} are not bitwise the uninterrupted run's {want}")
    ckpt_bytes = (root / "run" / f"step_{TRAIN_SAVE:08d}.ckpt").stat().st_size

    # profile one more step (the resumed state) for where the time goes
    batch = resumed._batch(TRAIN_STEPS)
    prof = train_step_profile(resumed.step_fn, params, opt, batch,
                              ROOT / "build" / "chip_smoke_profile_train.txt")
    del params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()

    # the plain path at step 0 from the same initial weights
    plain = Trainer(LM(cfg, remat=True, use_kernel=False), str(root / "plain"), tc, device=dev)
    build.reset_launch_counts()
    _, plain_hist = plain.run(steps=1)
    require(not build.LAUNCHES, f"plain-path training launched {dict(build.LAUNCHES)}")
    errs = {key: abs(hist[0][key] - plain_hist[0][key]) / abs(plain_hist[0][key])
            for key in ("loss", "grad_norm")}
    require(all(e <= TRAIN_REL_TOL for e in errs.values()),
            f"step 0, kernel path against plain path: relative {errs} beyond {TRAIN_REL_TOL}")
    params, _ = plain.init_state()
    grads = attn_grad_check(LM(cfg, remat=True), plain.model, params, plain._batch(0),
                            f"{TRAIN_ARCH} step 0")
    del params
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    walls = [h["dt"] * 1e3 for h in hist]
    # steps 1 .. TRAIN_SAVE - 1: after the first (cuBLAS and allocator
    # warm-up) and before the checkpoint's writer threads share the host
    steady = statistics.median(walls[1:TRAIN_SAVE])
    rec = dict(arch=TRAIN_ARCH, layers=cfg.n_layers, batch=TRAIN_B, seq=TRAIN_S, params=n_params,
               state_bytes=state_bytes, peak_bytes=peak, losses=[h["loss"] for h in hist],
               grad_norms=[h["grad_norm"] for h in hist], step_wall_ms=walls,
               step_wall_ms_median=steady, tokens_per_s=TRAIN_B * TRAIN_S / (steady / 1e3),
               plain_step0=dict(loss=plain_hist[0]["loss"], grad_norm=plain_hist[0]["grad_norm"],
                                wall_ms=plain_hist[0]["dt"] * 1e3),
               kernel_vs_plain_rel=errs, attn_grads=grads, save_snapshot_ms=save_ms,
               resumed=got, checkpoint_bytes=ckpt_bytes,
               run_s=run_s, resume_s=resume_s, profile=prof, launches=launches, paths=paths,
               launches_per_step=per_step)
    print(f"lm training {TRAIN_ARCH} {cfg.n_layers} layers: B={TRAIN_B} x {TRAIN_S}, "
          f"{n_params} parameters, "
          f"{TRAIN_STEPS} steps, losses {[round(x, 4) for x in rec['losses']]}, step wall ms "
          f"{[round(w, 1) for w in walls]} (steps 1-{TRAIN_SAVE - 1}, no save in flight: median "
          f"{steady:.1f}, "
          f"{rec['tokens_per_s']:.0f} tokens/s), device busy {prof['device_busy_ms']:.1f} ms "
          f"a profiled step (idle {prof['device_idle_share']:.3f}; flash_attention forward "
          f"{prof['flash_attention_fwd_ms']:.2f} ms, backward {prof['flash_attention_bwd_ms']:.2f}"
          f" ms), peak {peak} bytes allocated ({state_bytes} of parameters and Adam moments); "
          f"launches a step {json.dumps(per_step)}, by path {json.dumps(paths)}; resumed at "
          f"step {TRAIN_SAVE} from a "
          f"{ckpt_bytes}-byte checkpoint: steps {[g[0] for g in got]} bitwise; kernel vs plain "
          f"at step 0: loss {errs['loss']:.3g}, grad norm {errs['grad_norm']:.3g} relative, "
          f"attention leaves {grads['worst']:.4g} at worst (planted faults "
          f"{json.dumps(grads['planted'])}); save snapshot ms {[round(t, 1) for t in save_ms]}"
          f" (outside every step's dt); "
          f"the 5-step run {run_s:.1f} s (its save included), the resumed run {resume_s:.1f} s "
          f"(restore included) [{card}]", flush=True)
    return rec


def config_train_steps(dev, card) -> dict:
    """Phase 17(c): one bf16 train step of every config at ``.reduced()``,
    kernel path against plain path from the same weights and batch."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels import build
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import build_train_step, synthetic_batch

    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        params = LM(cfg).init(torch.Generator(device=dev).manual_seed(0))
        runs, lms = {}, {}
        for use_kernel in (True, False):
            lm = lms[use_kernel] = LM(cfg, use_kernel=use_kernel, remat=True, loss_chunk=64)
            batch = synthetic_batch(lm, 2, 128, 0, 0, device=dev)
            build.reset_launch_counts()
            _, _, m = build_train_step(lm)(params, adamw_init(params), batch, 0)
            torch.cuda.synchronize()
            runs[use_kernel] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                                    launches=dict(build.LAUNCHES), paths=dict(build.PATHS))
        k, p = runs[True], runs[False]
        attn = cfg.family != "ssm"
        require(not p["launches"] and (k["launches"].get("flash_attention_bwd_dq", 0) > 0) == attn
                and k["launches"].get("flash_attention_bwd_dq") == k["launches"].get(
                    "flash_attention_bwd_dkv"),
                f"{arch} train step: launches kernel {k['launches']}, plain {p['launches']}")
        if cfg.dtype == "bfloat16":  # every bf16 backward launch on the tensor cores
            for kname in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                require(k["paths"].get(f"{kname}.simt", 0) == 0,
                        f"{arch} train step: {kname} paths {k['paths']}")
        errs = {key: abs(k[key] - p[key]) / abs(p[key]) for key in ("loss", "grad_norm")}
        require(all(math.isfinite(k[key]) for key in errs)
                and all(e <= TRAIN_REL_TOL for e in errs.values()),
                f"{arch} train step, kernel against plain: {k} {p}")
        grads = attn_grad_check(lms[True], lms[False], params, batch,
                                f"{arch} train step") if attn else None
        out[arch] = dict(kernel=k, plain=p, rel_err=errs, attn_grads=grads)
        print(f"lm training reduced {arch}: loss {k['loss']:.5f} (plain {p['loss']:.5f}), grad "
              f"norm {k['grad_norm']:.5f} (plain {p['grad_norm']:.5f})"
              + ("" if grads is None else
                 f", attention leaves {grads['worst']:.4g} at worst (planted faults "
                 f"{json.dumps(grads['planted'])})")
              + f"; launches {json.dumps(k['launches'])}, by path {json.dumps(k['paths'])} "
              f"[{card}]", flush=True)
        del params
    return out


def lm_training_phase(dev, card: str) -> dict:
    """Phase 17: LM training, the backward kernels first."""
    import gc

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    out = {"backward": {}}
    for i, (name, (shape, causal, window, dtype)) in enumerate(BWD_SHAPES.items()):
        out["backward"][name] = backward_case(dev, name, shape, causal, window, dtype,
                                              seed=300 + i, card=card)
        gc.collect()
        torch.cuda.empty_cache()
    out["qwen"] = full_width_training(dev, card)
    out["configs"] = config_train_steps(dev, card)
    build.reset_launch_counts()
    out["launches"] = out["qwen"]["launches"]
    out["seconds"] = time.perf_counter() - t0
    print(f"lm training phase: {out['seconds']:.1f} s, launches on the main path "
          f"{json.dumps(out['launches'])} [{card}]", flush=True)
    return out


# phase 18: the LM over a mesh of tensor-parallel shards
TP_PROBE_ARCH, TP_PROBE_LAYERS, TP_PROBE_B, TP_PROBE_S = "qwen3-8b", 4, 2, 256
TP_PROBE_MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
# 16 shards: qwen3-8b's 32 query heads split, its 8 KV heads replicated
TP_KV_MESH = (1, 16)
# 12 of qwen3-8b's 36 layers: the whole script stays near 600 s
TP_FWD_ARCH, TP_FWD_LAYERS, TP_FWD_B, TP_FWD_S, TP_FWD_MESH = "qwen3-8b", 12, 2, 1024, (1, 4)
TP_TRAIN_ARCH, TP_TRAIN_B, TP_TRAIN_S, TP_TRAIN_STEPS = "qwen1.5-0.5b", 4, 1024, 3
TP_TRAIN_MESH = (1, 4)
# float32 over shards against the unsharded port on the same weights, TF32
# off: the shards sum the heads' and d_ff's partials in another order
TP_LOGITS_TOL, TP_LOSS_TOL, TP_GRAD_TOL = 1e-4, 1e-5, 1e-4
# the block weights' gradients checked layer by layer on the bf16 train step
TP_GRAD_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@contextlib.contextmanager
def attention_shapes():
    """Counts ``ops.attention``'s calls by their shards' own shapes and
    kinds, (B, H, Hkv, Sq, Sk, D, Dv, causal, window) (``attention_key``),
    while active."""
    from repro_torch.kernels.flash_attention import ops

    seen, real = collections.Counter(), ops.attention

    def recorded(q, k, v, *, causal=True, window=0, **kwargs):
        seen[attention_key(q.shape[0], q.shape[2], k.shape[2], q.shape[1], q.shape[3],
                           sk=k.shape[1], dv=v.shape[3], causal=causal, window=window)] += 1
        return real(q, k, v, causal=causal, window=window, **kwargs)

    ops.attention = recorded
    try:
        yield seen
    finally:
        ops.attention = real


def attention_key(b, h, hkv, sq, d, *, sk=None, dv=None, causal=True, window=0) -> tuple:
    """(B, H, Hkv, Sq, Sk, D, Dv, causal, window): Sk and Dv default to Sq and D."""
    return (b, h, hkv, sq, sq if sk is None else sk, d, d if dv is None else dv, causal, window)


def attention_kind(key) -> str:
    *_, sq, sk, _, _, causal, window = key
    return ("window" if window else "causal" if causal
            else "cross" if sq != sk else "bidirectional")


@contextlib.contextmanager
def planted_tp_fault(which: str):
    """``partial``: the last shard's partial dropped from every block's
    all-reduce over "model"; ``kv_group``: each shard's query heads read the
    KV heads of the first group instead of their own."""
    from repro_torch.models.lm import collectives, layers

    if which == "partial":
        module, name, real = collectives, "all_reduce_sum", collectives.all_reduce_sum

        def faulty(xs, mesh, axis, **kwargs):
            xs = list(xs)
            xs[-1] = torch.zeros_like(xs[-1])
            return real(xs, mesh, axis, **kwargs)
    else:
        module, name, real = layers, "kv_heads_of", layers.kv_heads_of

        def faulty(first, n, group):
            return real(0, n, group)

    setattr(module, name, faulty)
    try:
        yield
    finally:
        setattr(module, name, real)


def tp_profile(fn, path: Path) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall ms, device-busy ms and
    idle share, device launches, and the top entries by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _, device = profile_rows(prof, path)
    busy = sum(r[0] for r in device) / 1e3
    return dict(profiled_wall_ms=wall, device_busy_ms=busy,
                device_idle_share=max(0.0, 1.0 - busy / wall),
                device_launches=sum(r[2] for r in device),
                top_device=[[k[:70], d / 1e3, c] for d, k, c, _ in device[:6]])


def tp_rules(cfg, dims, devices):
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.lm.sharding import ShardingRules

    return ShardingRules(make_lm_mesh(dims, devices=devices), cfg)


def tp_leaves(tree, keep=None) -> dict:
    """'/'-joined leaf path -> tensor of a gathered tree (only the ``keep`` names)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for key, sub in t.items():
                walk(sub, path + (key,))
        elif isinstance(t, (list, tuple)):
            for i, sub in enumerate(t):
                walk(sub, path + (str(i),))
        elif keep is None or path[-1] in keep:
            out["/".join(path)] = t

    walk(tree, ())
    return out


def tp_kernel_checks(dev, shapes, dtype, card: str, backward: bool = True) -> dict:
    """The attention shapes that a tensor-parallel main path launched (each
    shard's own head counts, causal or not, windowed or not, Sq ≠ Sk: the
    keys of ``attention_shapes``), the kernels against their plain versions
    through their wrappers on seeded inputs: the forward
    (``attention_check``) and, with ``backward``, both backward kernels
    (``backward_case``), each within its phase-15 or phase-17 tolerance."""
    out = {}
    for i, key in enumerate(sorted(shapes)):
        b, h, hkv, sq, sk, d, dv, causal, window = key
        shape = (b, h, hkv, sq, sk, d, dv)
        kind = attention_kind(key)
        name = (f"tp_{b}x{h}on{hkv}x{sq}" + (f"on{sk}" if sk != sq else "") + f"x{d}"
                + (f"_v{dv}" if dv != d else "")
                + (f"_w{window}" if window else "" if kind == "causal" else f"_{kind}")
                + f"_{str(dtype).removeprefix('torch.')}")
        _, err = attention_check(dev, name, shape, dtype, causal, 180 + i, window)
        out[name] = dict(shape=list(shape), causal=causal, window=window,
                         forward_max_abs_err=err)
        if backward:
            bwd = backward_case(dev, name, shape, causal, window, dtype, 190 + i, card)
            out[name].update(backward_rel_err=bwd["rel_err"], backward_max_abs_err=bwd["max_abs_err"],
                             backward_path=bwd["path"])
    return out


def cache_free_logits(lm, params, tokens, frontend=None) -> torch.Tensor:
    """The unsharded counterpart of the sharded ``prefill_logits``: the
    backbone (the audio family's encoder over ``frontend`` and its decoder)
    and the last position's logits, with no cache built."""
    from repro_torch.models.lm.layers import rms_norm

    x = lm.embed(params, tokens)
    if lm.cfg.family == "audio":
        x = lm._decoder(params, x, lm._encode(params, frontend))
    else:
        x = lm._backbone(params, x)
    return lm.logits_last(params, rms_norm(x[:, -1], params["final_norm"], lm.cfg.norm_eps))


def tp_float32_check(dev, devices_for, card: str, what: str) -> dict:
    """Phase 18(a): float32 qwen3-8b at full width, 4 layers, TF32 off: the
    sharded port against the unsharded one on the same weights (logits of
    ``logits_last`` through ``prefill_logits``, ``train_loss``, every
    gradient leaf gathered), the sharded kernel path against the sharded
    plain path (``use_kernel=False``) on the same placed weights, the three
    planted faults, and the kernels at the shards' shapes against their
    plain versions (on the simulated mesh)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.models.lm.sharding import gather_params, shard_params, use_rules
    from repro_torch.train import synthetic_batch
    from repro_torch.train.step import loss_and_grads
    from torch_tp_probes import planted

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(TP_PROBE_ARCH), n_layers=TP_PROBE_LAYERS, dtype="float32")
    lm = LM(cfg, remat=False, loss_chunk=TP_PROBE_S)
    lm_plain = LM(cfg, remat=False, loss_chunk=TP_PROBE_S, use_kernel=False)
    params = lm.init(torch.Generator(device=dev).manual_seed(18))
    batch = synthetic_batch(lm, TP_PROBE_B, TP_PROBE_S, 18, 0, device=dev)
    prompt = batch["tokens"][:, :-1]
    live = slice(0, cfg.vocab)
    try:
        with torch.no_grad():
            want_logits = lm.prefill_logits(params, prompt)[:, live]
        want_loss, want_m, want_g = loss_and_grads(lm, params, batch)
        want_g = tp_leaves(want_g)
        out = {}
        meshes = dict(TP_PROBE_MESHES, **{"1x16_kv_replicated": TP_KV_MESH})
        shapes = collections.Counter()
        for name, dims in meshes.items():
            rules = tp_rules(cfg, dims, devices_for(dims))
            placed = shard_params(rules, params)
            with use_rules(rules):
                with torch.no_grad():
                    with attention_shapes() as seen:
                        logits = lm.prefill_logits(placed, prompt)[:, live].to(dev)
                    shapes.update(seen)
                    plain = lm_plain.prefill_logits(placed, prompt)[:, live].to(dev)
                rec = dict(logits_rel=rel_err(logits, want_logits),
                           kernel_vs_plain_logits_rel=rel_err(logits, plain))
                if name in TP_PROBE_MESHES:
                    with attention_shapes() as seen:
                        loss, m, grads = loss_and_grads(lm, placed, batch)
                    shapes.update(seen)
                    got = tp_leaves(gather_params(grads))
                    rec["loss_rel"] = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
                    rec["acc_equal"] = float(m["acc"]) == float(want_m["acc"])
                    rec["grad_rel"] = {p: rel_err(got[p].to(dev), want_g[p]) for p in want_g}
                    rec["grad_rel_max"] = max(rec["grad_rel"].values())
                    del grads
                    _, _, grads = loss_and_grads(lm_plain, placed, batch)
                    plain_g = tp_leaves(gather_params(grads))
                    rec["kernel_vs_plain_grad_rel_max"] = max(rel_err(got[p], plain_g[p])
                                                              for p in got)
                    del grads, got
                if name == "1x4":
                    with planted_tp_fault("partial"), torch.no_grad():
                        bad, _ = lm.train_loss(placed, batch)
                    rec["planted_partial_loss_rel"] = abs(float(bad) - float(want_loss)) / abs(
                        float(want_loss))
                    with planted_backward_fault("dq"):
                        _, _, grads = loss_and_grads(lm, placed, batch)
                    bad_g = tp_leaves(gather_params(grads))
                    rec["planted_dq_grad_rel_max"] = max(rel_err(bad_g[p], plain_g[p])
                                                         for p in bad_g)
                    del grads, bad_g
                if name in TP_PROBE_MESHES:
                    del plain_g
                if name.startswith("1x16"):
                    with planted_tp_fault("kv_group"), torch.no_grad():
                        bad = lm.prefill_logits(placed, prompt)[:, live].to(dev)
                    rec["planted_kv_group_logits_rel"] = rel_err(bad, want_logits)
            del placed
            gc.collect()
            torch.cuda.empty_cache()
            require(rec["logits_rel"] <= TP_LOGITS_TOL,
                    f"{what} {name}: sharded logits {rec['logits_rel']} beyond {TP_LOGITS_TOL}")
            require(rec["kernel_vs_plain_logits_rel"] <= TP_LOGITS_TOL,
                    f"{what} {name}: sharded logits, kernel path against plain path, "
                    f"{rec['kernel_vs_plain_logits_rel']} beyond {TP_LOGITS_TOL}")
            if "kernel_vs_plain_grad_rel_max" in rec:
                require(rec["kernel_vs_plain_grad_rel_max"] <= TP_GRAD_TOL,
                        f"{what} {name}: sharded gradients, kernel path against plain path, "
                        f"{rec['kernel_vs_plain_grad_rel_max']} beyond {TP_GRAD_TOL}")
            if "planted_dq_grad_rel_max" in rec:
                require(rec["planted_dq_grad_rel_max"] > TP_GRAD_TOL,
                        f"{what} {name}: a zeroed dq reads {rec['planted_dq_grad_rel_max']}")
            if "loss_rel" in rec:
                require(rec["loss_rel"] <= TP_LOSS_TOL and rec["acc_equal"],
                        f"{what} {name}: sharded train_loss {rec['loss_rel']} beyond {TP_LOSS_TOL}")
                require(rec["grad_rel_max"] <= TP_GRAD_TOL,
                        f"{what} {name}: gradient leaves {rec['grad_rel']} beyond {TP_GRAD_TOL}")
            if "planted_partial_loss_rel" in rec:
                require(rec["planted_partial_loss_rel"] > TP_LOSS_TOL,
                        f"{what} {name}: a dropped partial reads {rec['planted_partial_loss_rel']}")
            if "planted_kv_group_logits_rel" in rec:
                require(rec["planted_kv_group_logits_rel"] > TP_LOGITS_TOL,
                        f"{what} {name}: KV heads of the wrong group read "
                        f"{rec['planted_kv_group_logits_rel']}")
            out[name] = rec
            print(f"lm tensor parallel float32 {what} {TP_PROBE_ARCH} {TP_PROBE_LAYERS} layers "
                  f"{name}: logits {rec['logits_rel']:.3g}"
                  + (f", train_loss {rec['loss_rel']:.3g}, gradient leaves "
                     f"{rec['grad_rel_max']:.3g} at worst" if "loss_rel" in rec else "")
                  + " from the unsharded port; kernel path against plain path: logits "
                  f"{rec['kernel_vs_plain_logits_rel']:.3g}"
                  + (f", gradient leaves {rec['kernel_vs_plain_grad_rel_max']:.3g} at worst"
                     if "kernel_vs_plain_grad_rel_max" in rec else "")
                  + "".join(f", {k} {rec[k]:.3g}" for k in rec if k.startswith("planted"))
                  + f" relative [{card}]", flush=True)
        if what == "simulated":
            out["kernels"] = tp_kernel_checks(dev, shapes, torch.float32, card)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        del params
        gc.collect()
        torch.cuda.empty_cache()


def tp_forward(dev, card: str) -> dict:
    """Phase 18(b): bf16 qwen3-8b at full width, 12 layers, B = 2 x 1024,
    sharded forward at tp 4 (a main path of the phase) against the unsharded
    kernel path (the backbone and last logits, no cache: the same work) and
    against the sharded plain path on the same placed weights."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import simulated_devices
    from repro_torch.models.lm import LM
    from repro_torch.models.lm.sharding import shard_params, use_rules
    from repro_torch.optim.adamw import tree_leaves

    cfg = dataclasses.replace(get_config(TP_FWD_ARCH), n_layers=TP_FWD_LAYERS)
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(19))
    tokens = torch.randint(0, cfg.vocab, (TP_FWD_B, TP_FWD_S), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(20))
    with torch.no_grad():
        want = cache_free_logits(lm, params, tokens)[:, :cfg.vocab]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache_free_logits(lm, params, tokens)
        torch.cuda.synchronize()
        unsharded_wall = (time.perf_counter() - t0) * 1e3
    n = TP_FWD_MESH[0] * TP_FWD_MESH[1]
    rules = tp_rules(cfg, TP_FWD_MESH, simulated_devices(n, dev))
    placed = shard_params(rules, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(placed))
    with use_rules(rules), torch.no_grad():
        lm.prefill_logits(placed, tokens)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with attention_shapes() as shapes:
            build.reset_launch_counts()  # the main path: counts set to 0 just before
            t0 = time.perf_counter()
            start.record()
            logits = lm.prefill_logits(placed, tokens)
            stop.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            launches, paths = dict(build.LAUNCHES), dict(build.PATHS)
    peak = torch.cuda.max_memory_allocated()
    err = rel_err(logits[:, :cfg.vocab], want)
    n_launch = cfg.n_layers * n
    h_loc, kv_loc = cfg.n_heads // n, cfg.n_kv_heads // n
    shape = attention_key(TP_FWD_B, h_loc, kv_loc, TP_FWD_S, cfg.resolved_head_dim)
    require(bool(torch.isfinite(logits[:, :cfg.vocab]).all()) and err <= STATE_REL_TOL,
            f"tp forward {TP_FWD_ARCH}: sharded logits {err} beyond {STATE_REL_TOL}")
    require(launches == {"flash_attention": n_launch}
            and paths == {"flash_attention.tma": n_launch} and dict(shapes) == {shape: n_launch},
            f"tp forward {TP_FWD_ARCH}: launches {launches}, paths {paths}, shapes {dict(shapes)};"
            f" expected {n_launch} on the TMA path at {shape}")
    with use_rules(rules), torch.no_grad():
        plain = LM(cfg, use_kernel=False).prefill_logits(placed, tokens)[:, :cfg.vocab]
    plain_err = rel_err(logits[:, :cfg.vocab], plain)
    del plain
    require(plain_err <= STATE_REL_TOL,
            f"tp forward {TP_FWD_ARCH}: sharded logits, kernel path against plain path, "
            f"{plain_err} beyond {STATE_REL_TOL}")
    rec = dict(arch=TP_FWD_ARCH, mesh=list(TP_FWD_MESH), batch=TP_FWD_B, seq=TP_FWD_S,
               logits_rel=err, kernel_vs_plain_logits_rel=plain_err, launches=launches,
               paths=paths, shapes={str(k): v for k, v in shapes.items()}, wall_ms=wall,
               event_span_ms=start.elapsed_time(stop), unsharded_wall_ms=unsharded_wall,
               param_bytes=param_bytes, peak_bytes=peak)
    with use_rules(rules), torch.no_grad():
        rec["profile"] = tp_profile(lambda: lm.prefill_logits(placed, tokens),
                                    ROOT / "build" / "chip_smoke_profile_tp_forward.txt")
    with planted_tp_fault("partial"), use_rules(rules), torch.no_grad():
        rec["planted_partial_logits_rel"] = rel_err(
            lm.prefill_logits(placed, tokens)[:, :cfg.vocab], want)
    require(rec["planted_partial_logits_rel"] > STATE_REL_TOL,
            f"tp forward: a dropped partial reads {rec['planted_partial_logits_rel']}")
    rec["kernels"] = tp_kernel_checks(dev, shapes, torch.bfloat16, card)
    print(f"lm tensor parallel forward {TP_FWD_ARCH} bf16 {cfg.n_layers} layers over "
          f"{TP_FWD_MESH} shards on one card: B={TP_FWD_B} x {TP_FWD_S}, logits {err:.4g} from "
          f"the unsharded kernel path (planted dropped partial "
          f"{rec['planted_partial_logits_rel']:.3g}), {plain_err:.4g} from the sharded plain "
          f"path; {n_launch} flash_attention launches, all TMA, at {shape}; wall {wall:.1f} ms, "
          f"{rec['event_span_ms']:.1f} ms between events (unsharded backbone and logits, no "
          f"cache: wall {unsharded_wall:.1f} ms); profiled: {json.dumps(rec['profile'])}; "
          f"{param_bytes} parameter bytes, peak {peak} bytes [{card}]",
          flush=True)
    del placed, logits, want
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def tp_training(dev, card: str) -> dict:
    """Phase 18(c): bf16 qwen1.5-0.5b at full width, B = 4 x 1024: three
    ``build_train_step`` steps under rules on (1, 4) with the vocab-sharded
    loss (a main path of the phase), step 0 against the unsharded step, and
    the sharded step-0 attention gradients of the kernel path against the
    sharded plain path (``attn_grad_check``, with its planted faults)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import simulated_devices
    from repro_torch.models.lm import LM, collectives
    from repro_torch.models.lm.sharding import gather_params, shard_params, use_rules
    from repro_torch.optim.adamw import adamw_init, linear_warmup_cosine, tree_leaves
    from repro_torch.train import build_train_step, synthetic_batch
    from repro_torch.train.step import loss_and_grads

    cfg = get_config(TP_TRAIN_ARCH)
    lm = LM(cfg, remat=True)
    params = lm.init(torch.Generator(device=dev).manual_seed(21))
    batches = [synthetic_batch(lm, TP_TRAIN_B, TP_TRAIN_S, 21, s, device=dev)
               for s in range(TP_TRAIN_STEPS)]
    step_fn = build_train_step(lm, lr_schedule=linear_warmup_cosine(3e-4, 2, 10))
    unsharded_ms = []
    for _ in range(2):  # the second after the first's warm-up
        t0 = time.perf_counter()
        _, _, want = step_fn(params, adamw_init(params), batches[0], 0)
        torch.cuda.synchronize()
        unsharded_ms.append((time.perf_counter() - t0) * 1e3)
    want = {k: float(v) for k, v in want.items()}
    _, _, want_g = loss_and_grads(lm, params, batches[0])
    want_g = tp_leaves(want_g, TP_GRAD_LEAVES)
    n = TP_TRAIN_MESH[0] * TP_TRAIN_MESH[1]
    rules = tp_rules(cfg, TP_TRAIN_MESH, simulated_devices(n, dev))
    placed = shard_params(rules, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with use_rules(rules):
        _, _, grads = loss_and_grads(lm, placed, batches[0])
        grad_errs = attn_grad_errs({p: t.float() for p, t in tp_leaves(
            gather_params(grads), TP_GRAD_LEAVES).items()},
            {p: t.float() for p, t in want_g.items()})
        with planted_tp_fault("partial"):
            _, _, grads = loss_and_grads(lm, placed, batches[0])
        planted = attn_grad_errs({p: t.float() for p, t in tp_leaves(
            gather_params(grads), TP_GRAD_LEAVES).items()},
            {p: t.float() for p, t in want_g.items()})
        del grads
        vs_plain = attn_grad_check(lm, LM(cfg, remat=True, use_kernel=False), placed,
                                   batches[0], "tp training")
        opt = adamw_init(placed)
        state_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(placed) + tree_leaves(opt.mu) + tree_leaves(opt.nu))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        collectives.reset_stats()
        hist = []
        with attention_shapes() as shapes:
            build.reset_launch_counts()  # the main path: counts set to 0 just before
            for s, b in enumerate(batches):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                placed, opt, m = step_fn(placed, opt, b, s)
                stop.record()
                torch.cuda.synchronize()
                hist.append(dict(step=s, wall_ms=(time.perf_counter() - t0) * 1e3,
                                 event_span_ms=start.elapsed_time(stop),
                                 **{k: float(v) for k, v in m.items()}))
            launches, paths = dict(build.LAUNCHES), dict(build.PATHS)
        coll = collectives.STATS.as_dict()
        peak = torch.cuda.max_memory_allocated()
        prof = tp_profile(lambda: step_fn(placed, opt, batches[0], TP_TRAIN_STEPS),
                          ROOT / "build" / "chip_smoke_profile_tp_train.txt")
    errs = {k: abs(hist[0][k] - want[k]) / abs(want[k]) for k in ("loss", "grad_norm")}
    per_step = {k: c / TP_TRAIN_STEPS for k, c in launches.items()}
    fwd, bwd = 2 * cfg.n_layers * n, cfg.n_layers * n
    require(all(math.isfinite(h["loss"]) for h in hist)
            and all(e <= TRAIN_REL_TOL for e in errs.values()),
            f"tp training: step 0 sharded {hist[0]} against unsharded {want}: {errs}")
    require(max(grad_errs.values()) <= ATTN_GRAD_TOL,
            f"tp training: block gradients {grad_errs} beyond {ATTN_GRAD_TOL}")
    require(max(planted.values()) > ATTN_GRAD_TOL,
            f"tp training: a dropped partial reads {planted}, within {ATTN_GRAD_TOL}")
    require(per_step == {"flash_attention": fwd, "flash_attention_bwd_dq": bwd,
                         "flash_attention_bwd_dkv": bwd},
            f"tp training: launches a step {per_step}; expected {fwd} forward (remat) and {bwd} "
            "of each backward kernel")
    for kname in ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        require(paths.get(f"{kname}.tma") == launches.get(kname),
                f"tp training: {kname} paths {paths}: every bf16 launch on the TMA path")
    walls = [h["wall_ms"] for h in hist]
    steady = statistics.median(walls[1:])
    rec = dict(arch=TP_TRAIN_ARCH, mesh=list(TP_TRAIN_MESH), batch=TP_TRAIN_B, seq=TP_TRAIN_S,
               steps=hist, unsharded_step0=want, unsharded_step_wall_ms=unsharded_ms[1],
               step0_rel=errs, grad_rel=grad_errs, kernel_vs_plain_attn_grads=vs_plain,
               planted_partial_grad_rel=planted, launches=launches, launches_per_step=per_step,
               paths=paths, shapes={str(k): v for k, v in shapes.items()},
               step_wall_ms_median=steady, tokens_per_s=TP_TRAIN_B * TP_TRAIN_S / (steady / 1e3),
               state_bytes=state_bytes, peak_bytes=peak, collectives=coll, profile=prof,
               collective_link_bytes_per_step=coll["link_bytes"] / TP_TRAIN_STEPS)
    print(f"lm tensor parallel training {TP_TRAIN_ARCH} bf16 over {TP_TRAIN_MESH} shards on one "
          f"card: B={TP_TRAIN_B} x {TP_TRAIN_S}, losses {[round(h['loss'], 4) for h in hist]}, "
          f"step 0 against unsharded: loss {errs['loss']:.3g}, grad norm {errs['grad_norm']:.3g} "
          f"relative; block gradients {max(grad_errs.values()):.4g} at worst (planted dropped "
          f"partial {max(planted.values()):.3g}); sharded attention gradients, kernel path "
          f"against plain path, {vs_plain['worst']:.4g} at worst (planted zeroed dq, dk "
          f"{json.dumps(vs_plain['planted'])}); step wall ms {[round(w, 1) for w in walls]} "
          f"(median of steps 1-{TP_TRAIN_STEPS - 1} {steady:.1f}, {rec['tokens_per_s']:.0f} "
          f"tokens/s; unsharded {unsharded_ms[1]:.1f}), ms between events "
          f"{[round(h['event_span_ms'], 1) for h in hist]}; launches a step "
          f"{json.dumps(per_step)}, shapes {json.dumps(rec['shapes'])}; collectives "
          f"{json.dumps(coll)} over {TP_TRAIN_STEPS} steps; one more step profiled: "
          f"{json.dumps(prof)}; peak {peak} bytes ({state_bytes} of "
          f"parameters and moments) [{card}]", flush=True)
    rec["kernels"] = tp_kernel_checks(dev, shapes, torch.bfloat16, card)
    del placed, opt
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def lm_tensor_parallel_phase(dev, card: str) -> dict:
    """Phase 18: the LM tensor-parallel over a mesh of shards."""
    from repro_torch.launch.mesh import simulated_devices

    t0 = time.perf_counter()
    out = {"float32": tp_float32_check(
        dev, lambda dims: simulated_devices(dims[0] * dims[1], dev), card, "simulated")}
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        cards = 4 if n_cards >= 4 else 2
        meshes = [torch.device("cuda", i) for i in range(cards)]
        out["float32_cards"] = tp_float32_check(
            dev, lambda dims: (meshes * 16)[:dims[0] * dims[1]], card, f"on {cards} cards")
    else:
        print(f"lm tensor parallel: one card visible, so the float32 check ran on simulated "
              f"shards only (no real-card mesh) [{card}]", flush=True)
    out["forward"] = tp_forward(dev, card)
    out["training"] = tp_training(dev, card)
    out["launches"] = {k: out["forward"]["launches"].get(k, 0) + out["training"]["launches"].get(
        k, 0) for k in set(out["forward"]["launches"]) | set(out["training"]["launches"])}
    out["vs_plain"] = dict(
        kernels={**out["float32"]["kernels"], **out["forward"]["kernels"],
                 **out["training"]["kernels"]},
        float32={k: {m: r[m] for m in r if m.startswith("kernel_vs_plain")}
                 for k, r in out["float32"].items() if k != "kernels"},
        forward_logits_rel=out["forward"]["kernel_vs_plain_logits_rel"],
        training_attn_grads_worst=out["training"]["kernel_vs_plain_attn_grads"]["worst"])
    out["seconds"] = time.perf_counter() - t0
    print(f"lm tensor parallel phase: {out['seconds']:.1f} s, launches on the main path "
          f"{json.dumps(out['launches'])} [{card}]", flush=True)
    return out

# phase 19: the MoE family over a mesh of tensor-parallel shards
# (a) float32 at full width against the unsharded port on the same weights:
# arch -> (layers, B, S, meshes, gradients checked)
MOE_PROBE = {
    "granite-moe-1b-a400m": (4, 2, 256, {"1x4": (1, 4), "2x2": (2, 2),
                                         "1x16_kv_replicated": (1, 16)}, True),
    # its dense layer and one MoE layer (160 experts): ~21.5 GB of float32
    "deepseek-v2-236b": (2, 2, 128, {"1x4": (1, 4), "2x2": (2, 2)}, False),
}
MOE_SORTED_MESH = "2x2"
MOE_FWD_ARCH, MOE_FWD_LAYERS, MOE_FWD_B, MOE_FWD_S, MOE_FWD_MESH = (
    "deepseek-v2-236b", 3, 2, 1024, (1, 4))
MOE_TRAIN_ARCH, MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS = "granite-moe-1b-a400m", 4, 1024, 3
MOE_TRAIN_MESH = (1, 4)
MOE_GRAD_LEAVES = TP_GRAD_LEAVES + ("router",)


@contextlib.contextmanager
def planted_moe_fault(which: str):
    """``partial``: the last shard's partial dropped from the MoE layers'
    all-reduce over "model" (the attention's untouched); ``local_capacity``:
    each data shard queues its tokens against its own capacity, as if it
    held the whole batch (no offsets from the earlier data shards)."""
    from repro_torch.models.lm import collectives
    from repro_torch.models.lm import moe as moe_lib

    if which == "partial":
        name, real = "moe_ffn_shards", moe_lib.moe_ffn_shards
        real_sum = collectives.all_reduce_sum

        def faulty_sum(xs, mesh, axis, **kwargs):
            xs = list(xs)
            xs[-1] = torch.zeros_like(xs[-1])
            return real_sum(xs, mesh, axis, **kwargs)

        def faulty(*args, **kwargs):
            collectives.all_reduce_sum = faulty_sum
            try:
                return real(*args, **kwargs)
            finally:
                collectives.all_reduce_sum = real_sum
    else:
        name, real = "_sorted_shards", moe_lib._sorted_shards

        def faulty(rules, leaves, hs, cfg, batch_split):
            return real(rules, leaves, hs, cfg, False)

    setattr(moe_lib, name, faulty)
    try:
        yield
    finally:
        setattr(moe_lib, name, real)


def replay_shards(rules) -> list:
    """Each shard's (data index, data size) for ``RoutingReplay`` over the
    mesh of ``rules`` (the batch split over the data axes)."""
    axis = rules.axis("batch")
    return [(rules.mesh.axis_index(c, axis), rules.dp()) for c in rules.mesh.coords]


def moe_float32_check(dev, card: str) -> dict:
    """Phase 19(a): float32 granite-moe-1b-a400m (4 layers) and
    deepseek-v2-236b (its dense layer and one MoE layer) at full width, TF32
    off, over simulated shards against the unsharded port on the same
    weights: the last logits, and for granite ``train_loss`` and every
    gradient leaf; both MoE backends on (2, 2); the planted faults."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import simulated_devices
    from repro_torch.models.lm import LM
    from repro_torch.models.lm.sharding import gather_params, shard_params, use_rules
    from repro_torch.train import synthetic_batch
    from repro_torch.train.step import loss_and_grads
    from torch_tp_probes import planted

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out, fwd_shapes, grad_shapes = {}, collections.Counter(), collections.Counter()
    try:
        for arch, (layers, b, s, meshes, with_grads) in MOE_PROBE.items():
            cfg = dataclasses.replace(get_config(arch), n_layers=layers, dtype="float32")
            params = LM(cfg).init(torch.Generator(device=dev).manual_seed(29))
            batch = synthetic_batch(LM(cfg), b, s, 29, 0, device=dev)
            prompt, live = batch["tokens"][:, :-1], slice(0, cfg.vocab)
            for backend in ("einsum", "sorted"):
                lm = LM(cfg, remat=False, loss_chunk=s, moe_backend=backend)
                with torch.no_grad():
                    want_logits = cache_free_logits(lm, params, prompt)[:, live]
                if with_grads:
                    want_loss, want_m, want_g = loss_and_grads(lm, params, batch)
                    want_g = tp_leaves(want_g)
                todo = meshes if backend == "einsum" else {MOE_SORTED_MESH: meshes[MOE_SORTED_MESH]}
                for name, dims in todo.items():
                    rules = tp_rules(cfg, dims, simulated_devices(dims[0] * dims[1], dev))
                    placed = shard_params(rules, params)
                    with use_rules(rules):
                        with torch.no_grad(), attention_shapes() as seen:
                            logits = lm.prefill_logits(placed, prompt)[:, live].to(dev)
                        fwd_shapes.update(seen)
                        rec = dict(logits_rel=rel_err(logits, want_logits))
                        if with_grads:
                            with attention_shapes() as seen:
                                loss, m, grads = loss_and_grads(lm, placed, batch)
                            grad_shapes.update(seen)
                            got = tp_leaves(gather_params(grads))
                            del grads
                            rec["loss_rel"] = abs(float(loss) - float(want_loss)) / abs(
                                float(want_loss))
                            rec["acc_equal"] = float(m["acc"]) == float(want_m["acc"])
                            rec["grad_rel"] = {p: rel_err(got[p].to(dev), want_g[p])
                                               for p in want_g}
                            rec["grad_rel_max"] = max(rec["grad_rel"].values())
                            del got
                        # granite's 1 x 4 with each MoE partial; deepseek's queues (cap 12
                        # for 256 tokens, 6 for a data shard's 128) with local capacity
                        fault = ("partial" if (arch, backend, name) == (
                                     "granite-moe-1b-a400m", "einsum", "1x4") else
                                 "local_capacity" if (arch, backend) == (
                                     "deepseek-v2-236b", "sorted") else None)
                        if fault and with_grads:
                            with planted_moe_fault(fault), torch.no_grad():
                                bad, _ = lm.train_loss(placed, batch)
                            rec[f"planted_{fault}_loss_rel"] = abs(
                                float(bad) - float(want_loss)) / abs(float(want_loss))
                        elif fault:
                            with planted_moe_fault(fault), torch.no_grad():
                                bad = lm.prefill_logits(placed, prompt)[:, live].to(dev)
                            rec[f"planted_{fault}_logits_rel"] = rel_err(bad, want_logits)
                    del placed
                    gc.collect()
                    torch.cuda.empty_cache()
                    key = f"{arch} {backend} {name}"
                    require(rec["logits_rel"] <= TP_LOGITS_TOL,
                            f"moe float32 {key}: sharded logits {rec['logits_rel']} beyond "
                            f"{TP_LOGITS_TOL}")
                    if with_grads:
                        require(rec["loss_rel"] <= TP_LOSS_TOL and rec["acc_equal"],
                                f"moe float32 {key}: train_loss {rec['loss_rel']} beyond "
                                f"{TP_LOSS_TOL}")
                        require(rec["grad_rel_max"] <= TP_GRAD_TOL,
                                f"moe float32 {key}: gradient leaves beyond {TP_GRAD_TOL}: "
                                f"{ {p: e for p, e in rec['grad_rel'].items() if e > TP_GRAD_TOL} }")
                    for k in rec:
                        if k.startswith("planted"):
                            bound = TP_LOSS_TOL if k.endswith("loss_rel") else TP_LOGITS_TOL
                            require(rec[k] > bound, f"moe float32 {key}: {k} reads {rec[k]}")
                    out[key] = rec
                    print(f"lm moe tensor parallel float32 {arch} {layers} layers B={b} x {s} "
                          f"{backend} {name}: logits {rec['logits_rel']:.3g}"
                          + (f", train_loss {rec['loss_rel']:.3g}, gradient leaves "
                             f"{rec['grad_rel_max']:.3g} at worst" if with_grads else "")
                          + " from the unsharded port"
                          + "".join(f", {k} {rec[k]:.3g}" for k in rec if k.startswith("planted"))
                          + f" relative [{card}]", flush=True)
                if with_grads:
                    del want_g
            del params
            gc.collect()
            torch.cuda.empty_cache()
        out["kernels"] = tp_kernel_checks(dev, grad_shapes, torch.float32, card)
        out["kernels"].update(tp_kernel_checks(
            dev, [k for k in fwd_shapes if k not in grad_shapes], torch.float32, card,
            backward=False))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        gc.collect()
        torch.cuda.empty_cache()


def moe_forward(dev, card: str) -> dict:
    """Phase 19(b): bf16 deepseek-v2-236b at full width, 3 layers (its dense
    layer and two MoE layers, as in phase 15), B = 2 x 1024, the sharded
    forward at tp 4 (a main path of the phase) against the unsharded kernel
    path and the sharded plain path, all on the unsharded run's expert
    choices (``RoutingReplay`` over the shards)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import simulated_devices
    from repro_torch.models.lm import LM
    from repro_torch.models.lm.sharding import shard_params, use_rules
    from repro_torch.optim.adamw import tree_leaves

    cfg = dataclasses.replace(get_config(MOE_FWD_ARCH), n_layers=MOE_FWD_LAYERS)
    vocab = cfg.vocab
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(30))
    tokens = torch.randint(0, vocab, (MOE_FWD_B, MOE_FWD_S), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(31))
    record = RoutingReplay()
    with torch.no_grad():
        with record.run("record"):
            want = cache_free_logits(lm, params, tokens)[:, :vocab]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache_free_logits(lm, params, tokens)
        torch.cuda.synchronize()
        unsharded_wall = (time.perf_counter() - t0) * 1e3
    n = MOE_FWD_MESH[0] * MOE_FWD_MESH[1]
    rules = tp_rules(cfg, MOE_FWD_MESH, simulated_devices(n, dev))
    placed = shard_params(rules, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(placed))
    replay = RoutingReplay(record.calls, replay_shards(rules))
    with use_rules(rules), torch.no_grad():
        lm.prefill_logits(placed, tokens)  # warm-up, its own routing
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with attention_shapes() as shapes, replay.run("replay"):
            build.reset_launch_counts()  # the main path: counts set to 0 just before
            t0 = time.perf_counter()
            start.record()
            logits = lm.prefill_logits(placed, tokens)
            stop.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            launches, paths = dict(build.LAUNCHES), dict(build.PATHS)
    peak = torch.cuda.max_memory_allocated()
    require(replay.at == replay.expected,
            f"moe forward: {replay.at} of {replay.expected} routings replayed")
    err = rel_err(logits[:, :vocab], want)
    n_launch = cfg.n_layers * n
    m = cfg.mla
    shape = attention_key(MOE_FWD_B, cfg.n_heads // n, cfg.n_heads // n, MOE_FWD_S,
                          m.nope_dim + m.rope_dim, dv=m.v_dim)
    require(bool(torch.isfinite(logits[:, :vocab]).all()) and err <= STATE_REL_TOL,
            f"moe forward {MOE_FWD_ARCH}: sharded logits {err} beyond {STATE_REL_TOL}")
    require(launches == {"flash_attention": n_launch}
            and paths == {"flash_attention.tma": n_launch} and dict(shapes) == {shape: n_launch},
            f"moe forward {MOE_FWD_ARCH}: launches {launches}, paths {paths}, shapes "
            f"{dict(shapes)}; expected {n_launch} on the TMA path at {shape}")
    plain_replay = RoutingReplay(record.calls, replay_shards(rules))
    with use_rules(rules), torch.no_grad(), plain_replay.run("replay"):
        plain = LM(cfg, use_kernel=False).prefill_logits(placed, tokens)[:, :vocab]
    plain_err = rel_err(logits[:, :vocab], plain)
    del plain
    require(plain_err <= STATE_REL_TOL,
            f"moe forward {MOE_FWD_ARCH}: sharded logits, kernel path against plain path, "
            f"{plain_err} beyond {STATE_REL_TOL}")
    rec = dict(arch=MOE_FWD_ARCH, layers=cfg.n_layers, mesh=list(MOE_FWD_MESH), batch=MOE_FWD_B,
               seq=MOE_FWD_S, logits_rel=err, kernel_vs_plain_logits_rel=plain_err,
               routing_replayed=dict(tokens=replay.tokens, own_choice_differs=replay.differing),
               launches=launches, paths=paths, shapes={str(k): v for k, v in shapes.items()},
               wall_ms=wall, event_span_ms=start.elapsed_time(stop),
               unsharded_wall_ms=unsharded_wall, param_bytes=param_bytes, peak_bytes=peak)
    rec["kernels"] = tp_kernel_checks(dev, shapes, torch.bfloat16, card, backward=False)
    print(f"lm moe tensor parallel forward {MOE_FWD_ARCH} bf16 {cfg.n_layers} layers over "
          f"{MOE_FWD_MESH} shards on one card: B={MOE_FWD_B} x {MOE_FWD_S}, logits {err:.4g} from "
          f"the unsharded kernel path, {plain_err:.4g} from the sharded plain path, on the "
          f"unsharded run's expert choices ({replay.differing} of {replay.tokens} shard-tokens "
          f"would have chosen otherwise); {n_launch} flash_attention launches, all TMA, at "
          f"{shape}; wall {wall:.1f} ms, {rec['event_span_ms']:.1f} ms between events "
          f"(unsharded backbone and logits: wall {unsharded_wall:.1f} ms); {param_bytes} "
          f"parameter bytes, peak {peak} bytes [{card}]", flush=True)
    del placed, logits, want, record, replay, plain_replay
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def moe_training(dev, card: str) -> dict:
    """Phase 19(c): bf16 granite-moe-1b-a400m at full width, B = 4 x 1024:
    three ``build_train_step`` steps under rules on (1, 4) (a main path of
    the phase); step 0 and the block weights' gradients against the
    unsharded step's, on its expert choices."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import simulated_devices
    from repro_torch.models.lm import LM, collectives
    from repro_torch.models.lm.sharding import gather_params, shard_params, use_rules
    from repro_torch.optim.adamw import adamw_init, linear_warmup_cosine, tree_leaves
    from repro_torch.train import build_train_step, synthetic_batch
    from repro_torch.train.step import loss_and_grads

    cfg = get_config(MOE_TRAIN_ARCH)
    lm = LM(cfg, remat=True)
    params = lm.init(torch.Generator(device=dev).manual_seed(32))
    batches = [synthetic_batch(lm, MOE_TRAIN_B, MOE_TRAIN_S, 32, s, device=dev)
               for s in range(MOE_TRAIN_STEPS)]
    step_fn = build_train_step(lm, lr_schedule=linear_warmup_cosine(3e-4, 2, 10))
    record = RoutingReplay()
    with record.run("record"):  # the forward and the remat's recomputation, layer by layer
        _, _, want = step_fn(params, adamw_init(params), batches[0], 0)
    want = {k: float(v) for k, v in want.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_fn(params, adamw_init(params), batches[0], 0)
    torch.cuda.synchronize()
    unsharded_ms = (time.perf_counter() - t0) * 1e3
    _, _, want_g = loss_and_grads(lm, params, batches[0])
    want_g = {p: t.float() for p, t in tp_leaves(want_g, MOE_GRAD_LEAVES).items()}
    n = MOE_TRAIN_MESH[0] * MOE_TRAIN_MESH[1]
    rules = tp_rules(cfg, MOE_TRAIN_MESH, simulated_devices(n, dev))
    placed = shard_params(rules, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with use_rules(rules):
        replay = RoutingReplay(record.calls, replay_shards(rules))
        with replay.run("replay"):
            _, _, grads = loss_and_grads(lm, placed, batches[0])
        grad_errs = attn_grad_errs({p: t.float() for p, t in tp_leaves(
            gather_params(grads), MOE_GRAD_LEAVES).items()}, want_g)
        del grads
        opt = adamw_init(placed)
        state_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(placed) + tree_leaves(opt.mu) + tree_leaves(opt.nu))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        collectives.reset_stats()
        step_replay = RoutingReplay(record.calls, replay_shards(rules))
        hist = []
        with attention_shapes() as shapes:
            build.reset_launch_counts()  # the main path: counts set to 0 just before
            for s, b in enumerate(batches):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                with step_replay.run("replay") if s == 0 else contextlib.nullcontext():
                    t0 = time.perf_counter()
                    start.record()
                    placed, opt, m = step_fn(placed, opt, b, s)
                    stop.record()
                    torch.cuda.synchronize()
                hist.append(dict(step=s, wall_ms=(time.perf_counter() - t0) * 1e3,
                                 event_span_ms=start.elapsed_time(stop),
                                 **{k: float(v) for k, v in m.items()}))
            launches, paths = dict(build.LAUNCHES), dict(build.PATHS)
        coll = collectives.STATS.as_dict()
        peak = torch.cuda.max_memory_allocated()
    for r in (replay, step_replay):
        require(r.at == r.expected, f"moe training: {r.at} of {r.expected} routings replayed")
    errs = {k: abs(hist[0][k] - want[k]) / abs(want[k]) for k in ("loss", "grad_norm")}
    per_step = {k: c / MOE_TRAIN_STEPS for k, c in launches.items()}
    fwd, bwd = 2 * cfg.n_layers * n, cfg.n_layers * n
    shape = attention_key(MOE_TRAIN_B, cfg.n_heads // n, cfg.n_kv_heads // n, MOE_TRAIN_S,
                          cfg.resolved_head_dim)
    require(all(math.isfinite(h["loss"]) for h in hist)
            and all(e <= TRAIN_REL_TOL for e in errs.values()),
            f"moe training: step 0 sharded {hist[0]} against unsharded {want}: {errs}")
    require(max(grad_errs.values()) <= ATTN_GRAD_TOL,
            f"moe training: block gradients {grad_errs} beyond {ATTN_GRAD_TOL}")
    require(per_step == {"flash_attention": fwd, "flash_attention_bwd_dq": bwd,
                         "flash_attention_bwd_dkv": bwd} and set(shapes) == {shape},
            f"moe training: launches a step {per_step} at {dict(shapes)}; expected {fwd} forward "
            f"(remat) and {bwd} of each backward kernel at {shape}")
    for kname in ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        require(paths.get(f"{kname}.tma") == launches.get(kname),
                f"moe training: {kname} paths {paths}: every bf16 launch on the TMA path")
    walls = [h["wall_ms"] for h in hist]
    steady = statistics.median(walls[1:])
    rec = dict(arch=MOE_TRAIN_ARCH, mesh=list(MOE_TRAIN_MESH), batch=MOE_TRAIN_B,
               seq=MOE_TRAIN_S, steps=hist, unsharded_step0=want, unsharded_step_wall_ms=unsharded_ms,
               step0_rel=errs, grad_rel=grad_errs,
               routing_replayed=dict(tokens=step_replay.tokens,
                                     own_choice_differs=step_replay.differing),
               launches=launches, launches_per_step=per_step, paths=paths,
               shapes={str(k): v for k, v in shapes.items()}, step_wall_ms_median=steady,
               tokens_per_s=MOE_TRAIN_B * MOE_TRAIN_S / (steady / 1e3), state_bytes=state_bytes,
               peak_bytes=peak, collectives=coll,
               collective_link_bytes_per_step=coll["link_bytes"] / MOE_TRAIN_STEPS)
    print(f"lm moe tensor parallel training {MOE_TRAIN_ARCH} bf16 over {MOE_TRAIN_MESH} shards on "
          f"one card: B={MOE_TRAIN_B} x {MOE_TRAIN_S}, losses {[round(h['loss'], 4) for h in hist]},"
          f" step 0 against unsharded (its expert choices; {step_replay.differing} of "
          f"{step_replay.tokens} shard-tokens would have chosen otherwise): loss "
          f"{errs['loss']:.3g}, grad norm {errs['grad_norm']:.3g} relative; block gradients "
          f"{max(grad_errs.values()):.4g} at worst; step wall ms {[round(w, 1) for w in walls]} "
          f"(median of steps 1-{MOE_TRAIN_STEPS - 1} {steady:.1f}, {rec['tokens_per_s']:.0f} "
          f"tokens/s; unsharded {unsharded_ms:.1f}), ms between events "
          f"{[round(h['event_span_ms'], 1) for h in hist]}; launches a step "
          f"{json.dumps(per_step)}, shapes {json.dumps(rec['shapes'])}; collectives "
          f"{json.dumps(coll)} over {MOE_TRAIN_STEPS} steps; peak {peak} bytes ({state_bytes} of "
          f"parameters and moments) [{card}]", flush=True)
    rec["kernels"] = tp_kernel_checks(dev, shapes, torch.bfloat16, card)
    del placed, opt, record, replay, step_replay
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def lm_moe_tensor_parallel_phase(dev, card: str) -> dict:
    """Phase 19: the MoE family tensor-parallel over a mesh of shards."""
    t0 = time.perf_counter()
    out = {"float32": moe_float32_check(dev, card)}
    out["forward"] = moe_forward(dev, card)
    out["training"] = moe_training(dev, card)
    out["launches"] = {k: out["forward"]["launches"].get(k, 0) + out["training"]["launches"].get(
        k, 0) for k in set(out["forward"]["launches"]) | set(out["training"]["launches"])}
    out["vs_plain"] = dict(
        kernels={**out["float32"]["kernels"], **out["forward"]["kernels"],
                 **out["training"]["kernels"]},
        forward_logits_rel=out["forward"]["kernel_vs_plain_logits_rel"])
    out["seconds"] = time.perf_counter() - t0
    print(f"lm moe tensor parallel phase: {out['seconds']:.1f} s, launches on the main path "
          f"{json.dumps(out['launches'])} [{card}]", flush=True)
    return out


# phase 20: the SSM, hybrid and audio families over a mesh of tensor-parallel shards
# (a) float32 at full width and cut depth against the unsharded port on the
# same weights: case -> (arch, config changes, B, S, meshes)
XLSTM_MESHES = {"1x2": (1, 2), "1x4": (1, 4), "1x8": (1, 8)}
FAM_PROBE = {
    # one group: six Mamba2 blocks, then the shared block (window 4096)
    "zamba2-2.7b": ("zamba2-2.7b", dict(n_layers=6), 2, 256,
                    {"1x4": (1, 4), "2x2": (2, 2), "1x16": (1, 16)}),
    # one group: seven mLSTM blocks and one sLSTM (H = 4, P = 1024; the
    # sLSTM's 2730 hidden units): up/down split at tp 2, replicated at 4;
    # whole heads at tp 2 and 4, a head's P split over two shards at 8
    "xlstm-1.3b": ("xlstm-1.3b", dict(n_layers=8), 2, 256, XLSTM_MESHES),
    # the same group in float64 (FAM_FLOAT64)
    "xlstm-1.3b float64": ("xlstm-1.3b", dict(n_layers=8), 2, 256, XLSTM_MESHES),
    # one mLSTM block and one sLSTM: the same splits at a depth where the
    # model is well conditioned (FAM_REORDER_SENSITIVE)
    "xlstm-1.3b 1+1": ("xlstm-1.3b", dict(n_layers=2, slstm_every=2), 2, 256, XLSTM_MESHES),
    # two encoder and two decoder layers, 256 text positions over 1024 frames
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2", dict(n_layers=2, enc_layers=2), 2, 256,
                              {"1x4": (1, 4), "2x2": (2, 2), "1x16": (1, 16)}),
}
# the planted faults (tests/torch_tp_probes.py, shared with the CPU tests),
# each on one (case, mesh) of (a)
FAM_FAULTS = {("zamba2-2.7b", "1x4"): ("norm_over_own_slice", "replicated_grad_summed"),
              ("xlstm-1.3b float64", "1x4"): ("norm_over_own_slice", "replicated_grad_summed"),
              ("xlstm-1.3b float64", "1x8"): ("p_split_without_gather",),
              ("xlstm-1.3b 1+1", "1x8"): ("p_split_without_gather",)}
# replicated leaves whose gradient the summed-over-"model" fault inflates
FAM_REPLICATED = {"hybrid": ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip"),
                  "ssm": ("w_i", "w_f", "b_i", "b_f", "r", "b", "out_norm")}
# Full-width xlstm on random weights amplifies any change of rounding
# (exponential gating), the more the deeper: (a) measures that its unsharded
# port with every weight moved by one float32 ulp moves its own 8-layer
# logits 1.1e-4 and gradients 1.7e-3 (NVIDIA H100 80GB HBM3, 700.00 W), past
# TP_LOGITS_TOL and TP_GRAD_TOL, which no order of the shards' sums could
# then meet, and (b) that its bf16 run lies 0.28 from a float32 run of the
# same weights, so STATE_REL_TOL from the unsharded bf16 run says nothing.
# So (a) also runs a cut to one mLSTM and one sLSTM block at the bounds
# above, and holds the 8-layer group's float32 logits and gradients within
# FAM_REORDER_FACTOR times the one-ulp gap, measured in the same run.  The
# independent witness is the same group in float64 (``float64_port``, the
# same code rounding at float64), where the amplified rounding is gone: the
# sharded port against the unsharded port at the bounds above, and every
# planted fault of the group beyond them.  The float32 runs' distances from
# the float64 run are recorded beside (sharded and unsharded).  (b) holds
# xlstm by the float32 anchor that every family of (b) also meets (phase
# 16's ANCHOR_FACTOR).
FAM_REORDER_SENSITIVE = ("xlstm-1.3b",)
FAM_REORDER_FACTOR = 8.0
FAM_FLOAT64 = ("xlstm-1.3b float64",)
# (b) bf16 sharded forward at tp 4: arch -> (config changes, B, S); zamba2 at
# 8192 positions so that its 4096 window binds
FAM_FWD = {
    "zamba2-2.7b": (dict(n_layers=6), 1, 8192),
    "seamless-m4t-large-v2": (dict(n_layers=4, enc_layers=4), 2, 256),
    "xlstm-1.3b": (dict(n_layers=8), 2, 512),
}
FAM_MESH = (1, 4)
# (c) bf16 train steps at tp 4
FAM_TRAIN = {
    "seamless-m4t-large-v2": (dict(n_layers=4, enc_layers=4), 4, 256),
    "zamba2-2.7b": (dict(n_layers=6), 2, 1024),
}
FAM_TRAIN_STEPS = 3
FAM_GRAD_LEAVES = TP_GRAD_LEAVES + ("in_proj", "out_proj")
# leading layer axes of a stacked tree, by its top-level key
FAM_LEAD = {"enc_blocks": 1, "dec_blocks": 1, "blocks": 1, "mamba": 2, "mlstm": 2, "slstm": 1}


def nan_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """``rel_err`` over the elements where ``b`` is finite (in float64 where
    either is), and inf unless ``a`` is NaN at exactly ``b``'s NaN
    elements.  Full-width zamba2's gradient is NaN at init (each
    256-position chunk's decay overflows, ROADMAP Queue 3): the shards must
    reproduce it."""
    dt = torch.float64 if torch.float64 in (a.dtype, b.dtype) else torch.float32
    a, b = a.to(dt), b.to(dt)
    nan = torch.isnan(b)
    if not torch.equal(torch.isnan(a), nan):
        return math.inf
    if bool(nan.all()):
        return 0.0
    fin = ~nan
    return float((a[fin] - b[fin]).abs().max() / b[fin].abs().max().clamp(min=1e-30))


def scalar_rel(a: float, b: float) -> float:
    """|a − b| / |b|; 0 where both are NaN, inf where one is."""
    if math.isnan(a) or math.isnan(b):
        return 0.0 if math.isnan(a) and math.isnan(b) else math.inf
    return abs(a - b) / abs(b)


def family_cfg(arch: str, changes: dict, dtype: str | None = None):
    """``arch``'s config with ``changes`` (``slstm_every`` goes to its SSM
    config) and, if given, ``dtype``."""
    from repro_torch.configs import get_config

    changes = dict(changes)
    cfg = get_config(arch)
    if "slstm_every" in changes:
        changes["ssm"] = dataclasses.replace(cfg.ssm, slstm_every=changes.pop("slstm_every"))
    cfg = dataclasses.replace(cfg, **changes)
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def ulp_gaps(lm, params, batch, want_logits, want_g) -> dict:
    """The unsharded port with every weight moved by one float32 ulp (a
    seeded sign an element) against its run on the weights as they are: the
    last logits' distance and the gradient leaves' largest."""
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train.step import loss_and_grads

    gen = torch.Generator(device=want_logits.device).manual_seed(1)
    moved = tree_map(lambda t: t * (1 + 2.0 ** -23 * torch.sign(
        torch.randn(t.shape, generator=gen, device=t.device))), params)
    with torch.no_grad():
        logits = cache_free_logits(lm, moved, batch["tokens"][:, :-1], batch.get("frontend"))
    _, _, grads = loss_and_grads(lm, moved, batch)
    grads = tp_leaves(grads)
    return dict(logits_rel=rel_err(logits[:, :want_logits.shape[-1]], want_logits),
                grad_rel_max=max(nan_rel_err(grads[p], want_g[p]) for p in want_g))


def float64_run(lm, params, batch, live) -> tuple:
    """The unsharded port in float64 (``float64_port``) on ``params`` cast to
    float64: the last logits and the gradient leaves."""
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train.step import loss_and_grads
    from torch_tp_probes import float64_port

    p64 = tree_map(lambda t: t.double(), params)
    with float64_port(lm):
        with torch.no_grad():
            logits = cache_free_logits(lm, p64, batch["tokens"][:, :-1], batch.get("frontend"))
        _, _, grads = loss_and_grads(lm, p64, batch)
    return logits[:, live], tp_leaves(grads)


def far_from(witness, logits, grads) -> dict:
    """How far a float32 run's last logits and gradient leaves lie from the
    float64 ``witness``: the logits', each leaf's and the worst leaf's
    relative distance."""
    logits64, g64 = witness
    leaves = {p: nan_rel_err(grads[p].to(g64[p].device), g64[p]) for p in grads}
    out = dict(grads=max(leaves.values()), leaves=leaves)
    if logits is not None:
        out["logits"] = nan_rel_err(logits, logits64)
    return out


def family_probe_case(dev, card: str, case: str, calls) -> dict:
    """One case of phase 20(a) (``FAM_PROBE``), in float64 where the case is
    in ``FAM_FLOAT64``: its meshes against the unsharded port on the same
    weights, its planted faults; the attention calls added to ``calls``."""
    import gc

    from repro_torch.launch.mesh import simulated_devices
    from repro_torch.models.lm import LM
    from repro_torch.models.lm.sharding import gather_params, shard_params, use_rules
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import synthetic_batch
    from repro_torch.train.step import loss_and_grads
    from torch_tp_probes import float64_port, planted

    arch, changes, b, s, meshes = FAM_PROBE[case]
    cfg = family_cfg(arch, changes, "float32")
    lm = LM(cfg, remat=False, loss_chunk=s)
    params = lm.init(torch.Generator(device=dev).manual_seed(40))
    batch = synthetic_batch(lm, b, s, 40, 0, device=dev)
    prompt, fe, live = batch["tokens"][:, :-1], batch.get("frontend"), slice(0, cfg.vocab)
    wide = case in FAM_FLOAT64
    if wide:
        params = tree_map(lambda t: t.double(), params)
    out = {}
    with float64_port(lm) if wide else contextlib.nullcontext():
        with torch.no_grad():
            want_logits = cache_free_logits(lm, params, prompt, fe)[:, live]
        want_loss, want_m, want_g = loss_and_grads(lm, params, batch)
        want_g = tp_leaves(want_g)
        nans = {p: int(torch.isnan(g).sum()) for p, g in want_g.items()}
        nans = dict(leaves=sum(c > 0 for c in nans.values()), of_leaves=len(nans),
                    elements=sum(nans.values()),
                    of_elements=sum(g.numel() for g in want_g.values()))
        logits_tol, grad_tol, witness = TP_LOGITS_TOL, TP_GRAD_TOL, None
        if case in FAM_REORDER_SENSITIVE:
            gaps = ulp_gaps(lm, params, batch, want_logits, want_g)
            logits_tol = max(logits_tol, FAM_REORDER_FACTOR * gaps["logits_rel"])
            grad_tol = max(grad_tol, FAM_REORDER_FACTOR * gaps["grad_rel_max"])
            witness = float64_run(lm, params, batch, live)
            unsharded_far = far_from(witness, want_logits, want_g)
            out["one ulp"] = dict(gaps, logits_tol=logits_tol, grad_tol=grad_tol,
                                  unsharded_from_float64=unsharded_far)
            print(f"lm family tensor parallel float32 {case} {changes}: the unsharded port "
                  f"with every weight moved one ulp: logits {gaps['logits_rel']:.3g}, "
                  f"gradient leaves {gaps['grad_rel_max']:.3g} at worst from its own run; the "
                  f"shards held within {logits_tol:.3g} and {grad_tol:.3g}; the unsharded "
                  f"float32 run from the float64 run: logits {unsharded_far['logits']:.3g}, "
                  f"gradient leaves {unsharded_far['grads']:.3g} at worst [{card}]", flush=True)
        for name, dims in meshes.items():
            rules = tp_rules(cfg, dims, simulated_devices(dims[0] * dims[1], dev))
            placed = shard_params(rules, params)
            with use_rules(rules):
                with torch.no_grad(), attention_shapes() as seen:
                    logits = lm.prefill_logits(placed, prompt, fe)[:, live].to(dev)
                calls.update(seen)
                with attention_shapes() as seen:
                    loss, m, grads = loss_and_grads(lm, placed, batch)
                calls.update(seen)
                got = tp_leaves(gather_params(grads))
                del grads
                rec = dict(logits_rel=nan_rel_err(logits, want_logits),
                           loss_rel=abs(float(loss) - float(want_loss)) / abs(float(want_loss)),
                           acc_equal=float(m["acc"]) == float(want_m["acc"]),
                           grad_rel={p: nan_rel_err(got[p].to(dev), want_g[p]) for p in want_g},
                           unsharded_grad_nans=nans)
                rec["grad_rel_max"] = max(rec["grad_rel"].values())
                if witness is not None:  # recorded, not held: see FAM_FLOAT64
                    rec["from_float64"] = far_from(witness, logits, got)
                    rec["from_float64_ratio"] = {k: rec["from_float64"][k] / unsharded_far[k]
                                                 for k in ("grads", "logits")}
                    rec["from_float64_leaf_ratio"] = {
                        p: d / unsharded_far["leaves"][p]
                        for p, d in rec["from_float64"]["leaves"].items()}
                del got
                for fault in FAM_FAULTS.get((case, name), ()):
                    # held to the gradient bound: at init a block's output is small
                    # beside the residual, so a fault can move the loss less than
                    # TP_LOSS_TOL (its loss is recorded beside it)
                    with planted(fault):
                        bad_loss, _, grads = loss_and_grads(lm, placed, batch)
                    bad = tp_leaves(gather_params(grads), FAM_REPLICATED[cfg.family] if
                                    fault == "replicated_grad_summed" else None)
                    rec[f"planted_{fault}_grad_rel"] = max(
                        nan_rel_err(bad[p].to(dev), want_g[p]) for p in bad)
                    rec[f"planted_{fault}_loss_rel"] = abs(
                        float(bad_loss) - float(want_loss)) / abs(float(want_loss))
                    del grads, bad
            del placed
            gc.collect()
            torch.cuda.empty_cache()
            key = f"{case} {name}"
            require(rec["logits_rel"] <= logits_tol,
                    f"family float32 {key}: sharded logits {rec['logits_rel']} beyond {logits_tol}")
            require(rec["loss_rel"] <= TP_LOSS_TOL and rec["acc_equal"],
                    f"family float32 {key}: train_loss {rec['loss_rel']} beyond {TP_LOSS_TOL}")
            require(rec["grad_rel_max"] <= grad_tol,
                    f"family float32 {key}: gradient leaves beyond {grad_tol}: "
                    f"{ {p: e for p, e in rec['grad_rel'].items() if e > grad_tol} }")
            for k in rec:
                if k.startswith("planted") and k.endswith("grad_rel"):
                    require(rec[k] > grad_tol, f"family float32 {key}: {k} reads {rec[k]}")
            out[name] = rec
            print(f"lm family tensor parallel {'float64' if wide else 'float32'} {case} {changes} "
                  f"B={b} x {s} {name}: logits {rec['logits_rel']:.3g}, train_loss "
                  f"{rec['loss_rel']:.3g}, gradient leaves {rec['grad_rel_max']:.3g} at worst from "
                  f"the unsharded port (its gradient NaN in {nans['leaves']} of "
                  f"{nans['of_leaves']} leaves, {nans['elements']} of {nans['of_elements']} "
                  "elements; the shards' NaNs at the same elements)"
                  + (f"; from the float64 run: logits {rec['from_float64']['logits']:.3g}, "
                     f"gradient leaves {rec['from_float64']['grads']:.3g} at worst, "
                     f"{json.dumps(rec['from_float64_ratio'])} times the unsharded float32 "
                     "run's; leaves furthest beyond it "
                     + json.dumps({p: round(r, 2) for p, r in sorted(
                         rec["from_float64_leaf_ratio"].items(), key=lambda kv: -kv[1])[:4]})
                     if witness is not None else "")
                  + "".join(f", {k} {rec[k]:.3g}" for k in rec if k.startswith("planted"))
                  + f" relative [{card}]", flush=True)
    return out


def family_tp_float32_check(dev, card: str) -> dict:
    """Phase 20(a): float32 zamba2-2.7b, xlstm-1.3b and seamless-m4t-large-v2
    at full width and cut depth, TF32 off, over simulated shards against the
    unsharded port on the same weights: the last logits, ``train_loss`` and
    every gradient leaf gathered; the planted faults; xlstm's 8-layer group
    also in float64."""
    import gc

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out, calls = {}, collections.Counter()
    try:
        for case in FAM_PROBE:
            for name, rec in family_probe_case(dev, card, case, calls).items():
                out[f"{case} {name}"] = rec
            gc.collect()
            torch.cuda.empty_cache()
        out["kernels"] = tp_kernel_checks(dev, calls, torch.float32, card, backward=False)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        gc.collect()
        torch.cuda.empty_cache()


def family_expected_calls(cfg, b: int, s: int, n: int) -> dict:
    """The attention calls a forward of ``cfg`` over ``n`` model shards
    makes: zamba2's windowed shared block once a group; seamless's
    bidirectional encoder, causal decoder and cross attention once a layer
    each (over ``n_frontend_tokens`` frames); none for xlstm."""
    h, hkv, d = cfg.n_heads // n, cfg.n_kv_heads // n, cfg.resolved_head_dim
    if cfg.family == "hybrid":
        return {attention_key(b, h, hkv, s, d, window=cfg.sliding_window):
                n * cfg.n_layers // cfg.attn_every}
    if cfg.family == "audio":
        f = cfg.n_frontend_tokens
        return {attention_key(b, h, hkv, f, d, causal=False): n * cfg.enc_layers,
                attention_key(b, h, hkv, s, d): n * cfg.n_layers,
                attention_key(b, h, hkv, s, d, sk=f, causal=False): n * cfg.n_layers}
    return {}


def family_tp_forward(dev, card: str) -> dict:
    """Phase 20(b): bf16 zamba2-2.7b (one group at B = 1 x 8192), seamless
    (4 + 4 layers, B = 2 x 256 over 1024 frames) and xlstm-1.3b (one group,
    B = 2 x 512) at full width, the sharded forward at tp 4 (a main path of
    the phase: counts reset just before each, read just after) against the
    unsharded kernel path and the sharded plain path on the same weights."""
    import gc

    from repro_torch.kernels import build
    from repro_torch.launch.mesh import simulated_devices
    from repro_torch.models.lm import LM
    from repro_torch.models.lm.sharding import shard_params, use_rules
    from repro_torch.optim.adamw import tree_leaves, tree_map

    out, launches, calls = {}, collections.Counter(), collections.Counter()
    n = FAM_MESH[0] * FAM_MESH[1]
    for i, (arch, (changes, b, s)) in enumerate(FAM_FWD.items()):
        cfg = family_cfg(arch, changes)
        vocab = cfg.vocab
        lm = LM(cfg)
        params = lm.init(torch.Generator(device=dev).manual_seed(50 + i))
        gen = torch.Generator(device=dev).manual_seed(60 + i)
        tokens = torch.randint(0, vocab, (b, s), device=dev, generator=gen)
        fe = (torch.randn((b, cfg.n_frontend_tokens, cfg.d_model), generator=gen, device=dev)
              if cfg.frontend else None)
        with torch.no_grad():
            want = cache_free_logits(lm, params, tokens, fe)[:, :vocab]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache_free_logits(lm, params, tokens, fe)
            torch.cuda.synchronize()
            unsharded_wall = (time.perf_counter() - t0) * 1e3
            # the float32 anchor: the unsharded plain path in float32 on the same weights
            params32 = tree_map(lambda t: t.float(), params)
            lm32 = LM(family_cfg(arch, changes, "float32"), use_kernel=False)
            anchor = cache_free_logits(lm32, params32, tokens, fe)[:, :vocab]
            del params32
        rules = tp_rules(cfg, FAM_MESH, simulated_devices(n, dev))
        placed = shard_params(rules, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(placed))
        with use_rules(rules), torch.no_grad():
            lm.prefill_logits(placed, tokens, fe)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with attention_shapes() as seen:
                build.reset_launch_counts()  # the main path: counts set to 0 just before
                t0 = time.perf_counter()
                start.record()
                logits = lm.prefill_logits(placed, tokens, fe)
                stop.record()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                got_launches, paths = dict(build.LAUNCHES), dict(build.PATHS)
        peak = torch.cuda.max_memory_allocated()
        err = rel_err(logits[:, :vocab], want)
        anchored = dict(sharded=rel_err(logits[:, :vocab], anchor), unsharded=rel_err(want, anchor))
        del anchor
        expected = family_expected_calls(cfg, b, s, n)
        n_launch = sum(expected.values())
        require(bool(torch.isfinite(logits[:, :vocab]).all())
                and (err <= STATE_REL_TOL or arch in FAM_REORDER_SENSITIVE),
                f"family forward {arch}: sharded logits {err} beyond {STATE_REL_TOL}")
        require(anchored["sharded"] <= ANCHOR_FACTOR * anchored["unsharded"],
                f"family forward {arch}: from the float32 run, sharded {anchored['sharded']} "
                f"against unsharded {anchored['unsharded']}: beyond {ANCHOR_FACTOR} times")
        require(dict(seen) == expected
                and got_launches == ({"flash_attention": n_launch} if n_launch else {})
                and paths == ({"flash_attention.tma": n_launch} if n_launch else {}),
                f"family forward {arch}: launches {got_launches}, paths {paths}, calls "
                f"{dict(seen)}; expected {expected}, all on the TMA path")
        with use_rules(rules), torch.no_grad():
            plain = LM(cfg, use_kernel=False).prefill_logits(placed, tokens, fe)[:, :vocab]
        plain_err = rel_err(logits[:, :vocab], plain)
        del plain
        require(plain_err <= STATE_REL_TOL,
                f"family forward {arch}: sharded logits, kernel path against plain path, "
                f"{plain_err} beyond {STATE_REL_TOL}")
        launches.update(got_launches)
        calls.update(seen)
        kinds = {attention_kind(k): c for k, c in seen.items()}
        rec = dict(arch=arch, changes=changes, mesh=list(FAM_MESH), batch=b, seq=s,
                   logits_rel=err, kernel_vs_plain_logits_rel=plain_err,
                   from_float32=anchored, launches=got_launches,
                   paths=paths, shapes={str(k): c for k, c in seen.items()}, kinds=kinds,
                   wall_ms=wall, event_span_ms=start.elapsed_time(stop),
                   unsharded_wall_ms=unsharded_wall, param_bytes=param_bytes, peak_bytes=peak)
        out[arch] = rec
        print(f"lm family tensor parallel forward {arch} bf16 {changes} over {FAM_MESH} shards on "
              f"one card: B={b} x {s}, logits {err:.4g} from the unsharded kernel path, "
              f"{plain_err:.4g} from the sharded plain path; from a float32 run of the same "
              f"weights sharded {anchored['sharded']:.4g}, unsharded {anchored['unsharded']:.4g};"
              f" flash_attention launches "
              f"{json.dumps(kinds)}, all TMA, at {sorted(seen)}; wall {wall:.1f} ms, "
              f"{rec['event_span_ms']:.1f} ms between events (unsharded, no cache: wall "
              f"{unsharded_wall:.1f} ms); {param_bytes} parameter bytes, peak {peak} bytes "
              f"[{card}]", flush=True)
        del placed, logits, want
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = dict(launches)
    out["shapes"] = {str(k): c for k, c in calls.items()}
    out["kernels"] = tp_kernel_checks(dev, calls, torch.bfloat16, card, backward=False)
    return out


def layer_errs(got: dict, want: dict) -> dict:
    """``nan_rel_err`` of each leaf, a stacked leaf layer by layer (its
    leading axes by ``FAM_LEAD``), its largest kept."""
    errs = {}
    for name, w in want.items():
        lead = FAM_LEAD.get(name.split("/")[0], 0)
        g = got[name].reshape(-1, *w.shape[lead:])
        errs[name] = max(nan_rel_err(a, c) for a, c in zip(g, w.reshape(-1, *w.shape[lead:])))
    return errs


def family_tp_training(dev, card: str) -> dict:
    """Phase 20(c): bf16 seamless (4 + 4 layers, B = 4 x 256 over 1024
    frames) and zamba2-2.7b (one group, B = 2 x 1024) at full width: three
    ``build_train_step`` steps each under rules at tp 4 (a main path of the
    phase), step 0 against the unsharded step and the block weights'
    gradients layer by layer."""
    import gc

    from repro_torch.kernels import build
    from repro_torch.launch.mesh import simulated_devices
    from repro_torch.models.lm import LM, collectives
    from repro_torch.models.lm.sharding import gather_params, shard_params, use_rules
    from repro_torch.optim.adamw import adamw_init, linear_warmup_cosine, tree_leaves
    from repro_torch.train import build_train_step, synthetic_batch
    from repro_torch.train.step import loss_and_grads

    out, launches, calls = {}, collections.Counter(), collections.Counter()
    n = FAM_MESH[0] * FAM_MESH[1]
    for i, (arch, (changes, b, s)) in enumerate(FAM_TRAIN.items()):
        cfg = family_cfg(arch, changes)
        lm = LM(cfg, remat=True)
        params = lm.init(torch.Generator(device=dev).manual_seed(70 + i))
        batches = [synthetic_batch(lm, b, s, 70 + i, st, device=dev)
                   for st in range(FAM_TRAIN_STEPS)]
        step_fn = build_train_step(lm, lr_schedule=linear_warmup_cosine(3e-4, 2, 10))
        unsharded_ms = []
        for _ in range(2):  # the second after the first's warm-up
            t0 = time.perf_counter()
            _, _, want = step_fn(params, adamw_init(params), batches[0], 0)
            torch.cuda.synchronize()
            unsharded_ms.append((time.perf_counter() - t0) * 1e3)
        want = {k: float(v) for k, v in want.items()}
        _, _, want_g = loss_and_grads(lm, params, batches[0])
        want_g = {p: t.float() for p, t in tp_leaves(want_g, FAM_GRAD_LEAVES).items()}
        grad_nans = sum(int(torch.isnan(g).sum()) for g in want_g.values())
        rules = tp_rules(cfg, FAM_MESH, simulated_devices(n, dev))
        placed = shard_params(rules, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        with use_rules(rules):
            _, _, grads = loss_and_grads(lm, placed, batches[0])
            grad_errs = layer_errs(tp_leaves(gather_params(grads), FAM_GRAD_LEAVES), want_g)
            del grads
            opt = adamw_init(placed)
            state_bytes = sum(t.numel() * t.element_size() for t in
                              tree_leaves(placed) + tree_leaves(opt.mu) + tree_leaves(opt.nu))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            collectives.reset_stats()
            hist = []
            with attention_shapes() as seen:
                build.reset_launch_counts()  # the main path: counts set to 0 just before
                for st, bt in enumerate(batches):
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    t0 = time.perf_counter()
                    start.record()
                    placed, opt, m = step_fn(placed, opt, bt, st)
                    stop.record()
                    torch.cuda.synchronize()
                    hist.append(dict(step=st, wall_ms=(time.perf_counter() - t0) * 1e3,
                                     event_span_ms=start.elapsed_time(stop),
                                     **{k: float(v) for k, v in m.items()}))
                got_launches, paths = dict(build.LAUNCHES), dict(build.PATHS)
            coll = collectives.STATS.as_dict()
            peak = torch.cuda.max_memory_allocated()
        errs = {k: scalar_rel(hist[0][k], want[k]) for k in ("loss", "grad_norm")}
        per_step = {k: c / FAM_TRAIN_STEPS for k, c in got_launches.items()}
        expected = family_expected_calls(cfg, b, s, n)
        # a NaN gradient (zamba2's, mirrored) makes every later parameter and loss NaN
        finite_grads = math.isfinite(want["grad_norm"])
        calls_once = sum(expected.values())
        # remat recomputes each encoder and decoder block's attention; zamba2's
        # shared block is never recomputed (the reference's sites)
        fwd = calls_once * (2 if cfg.family == "audio" else 1)
        require(math.isfinite(hist[0]["loss"])
                and all(math.isfinite(h["loss"]) == finite_grads for h in hist[1:])
                and all(e <= TRAIN_REL_TOL for e in errs.values()),
                f"family training {arch}: step 0 sharded {hist[0]} against unsharded {want}: "
                f"{errs}; losses {[h['loss'] for h in hist]}")
        require(max(grad_errs.values()) <= ATTN_GRAD_TOL,
                f"family training {arch}: block gradients {grad_errs} beyond {ATTN_GRAD_TOL}")
        require(per_step == {"flash_attention": fwd, "flash_attention_bwd_dq": calls_once,
                             "flash_attention_bwd_dkv": calls_once}
                and set(seen) == set(expected),
                f"family training {arch}: launches a step {per_step} at {dict(seen)}; expected "
                f"{fwd} forward and {calls_once} of each backward kernel at {expected}")
        for kname in ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            require(paths.get(f"{kname}.tma") == got_launches.get(kname),
                    f"family training {arch}: {kname} paths {paths}: every bf16 launch on TMA")
        launches.update(got_launches)
        calls.update(seen)
        walls = [h["wall_ms"] for h in hist]
        steady = statistics.median(walls[1:])
        rec = dict(arch=arch, changes=changes, mesh=list(FAM_MESH), batch=b, seq=s, steps=hist,
                   unsharded_step0=want, unsharded_step_wall_ms=unsharded_ms[1], step0_rel=errs,
                   later_steps_on_nan_state=not finite_grads,
                   grad_rel=grad_errs, unsharded_block_grad_nan_elements=grad_nans,
                   launches=got_launches, launches_per_step=per_step,
                   paths=paths, shapes={str(k): c for k, c in seen.items()},
                   step_wall_ms_median=steady, tokens_per_s=b * s / (steady / 1e3),
                   state_bytes=state_bytes, peak_bytes=peak, collectives=coll,
                   collective_link_bytes_per_step=coll["link_bytes"] / FAM_TRAIN_STEPS)
        out[arch] = rec
        print(f"lm family tensor parallel training {arch} bf16 {changes} over {FAM_MESH} shards "
              f"on one card: B={b} x {s}, losses {[round(h['loss'], 4) for h in hist]}, step 0 "
              f"against unsharded: loss {errs['loss']:.3g}, grad norm {errs['grad_norm']:.3g} "
              f"relative; block gradients {max(grad_errs.values()):.4g} at worst ({grad_nans} "
              f"NaN elements in the unsharded step's, the shards' at the same); step wall ms "
              f"{[round(w, 1) for w in walls]} (median of steps 1-{FAM_TRAIN_STEPS - 1} "
              f"{steady:.1f}, {rec['tokens_per_s']:.0f} tokens/s; unsharded "
              f"{unsharded_ms[1]:.1f}"
              + ("" if finite_grads else "; steps 1-2 on the NaN parameters of step 0's NaN "
                 "gradient") + "), ms between events "
              f"{[round(h['event_span_ms'], 1) for h in hist]}; launches a step "
              f"{json.dumps(per_step)} at {sorted(seen)}; collectives {json.dumps(coll)} over "
              f"{FAM_TRAIN_STEPS} steps; peak {peak} bytes ({state_bytes} of parameters and "
              f"moments) [{card}]", flush=True)
        del placed, opt
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = dict(launches)
    out["shapes"] = {str(k): c for k, c in calls.items()}
    out["kernels"] = tp_kernel_checks(dev, calls, torch.bfloat16, card, backward=True)
    return out


def lm_family_tensor_parallel_phase(dev, card: str) -> dict:
    """Phase 20: the SSM, hybrid and audio families tensor-parallel over a
    mesh of shards."""
    t0 = time.perf_counter()
    out = {"float32": family_tp_float32_check(dev, card)}
    out["forward"] = family_tp_forward(dev, card)
    out["training"] = family_tp_training(dev, card)
    out["launches"] = {k: out["forward"]["launches"].get(k, 0) + out["training"]["launches"].get(
        k, 0) for k in set(out["forward"]["launches"]) | set(out["training"]["launches"])}
    out["vs_plain"] = dict(
        kernels={**out["float32"]["kernels"], **out["forward"]["kernels"],
                 **out["training"]["kernels"]},
        forward_logits_rel={a: r["kernel_vs_plain_logits_rel"]
                            for a, r in out["forward"].items() if a in FAM_FWD})
    out["seconds"] = time.perf_counter() - t0
    print(f"lm family tensor parallel phase: {out['seconds']:.1f} s, launches on the main path "
          f"{json.dumps(out['launches'])} [{card}]", flush=True)
    return out


# phase 21: LM decode over a mesh of shards (the cache placed by
# ``cache_pspecs``, each step's attention a split-K reduce over "model")
# (a) float32 at full width and cut depth, TF32 off, against the unsharded
# port on the same weights: case -> (arch, config changes, B, S, meshes)
DEC_PROBE = {
    "qwen3-8b": ("qwen3-8b", dict(n_layers=4), 2, 256,
                 {"1x4": (1, 4), "2x2": (2, 2), "1x16": (1, 16)}),
    # its dense layer and one MoE layer, MLA's latent cache
    "deepseek-v2-236b": ("deepseek-v2-236b", dict(n_layers=2), 2, 256,
                         {"1x4": (1, 4), "2x2": (2, 2)}),
    # the first group at B = 1 x 4096 (the window): the 8 steps wrap the ring;
    # on (2, 2) the one row is on no data axis, as long_500k's
    "zamba2-2.7b": ("zamba2-2.7b", dict(n_layers=6), 1, 4096, {"1x4": (1, 4), "2x2": (2, 2)}),
    "xlstm-1.3b": ("xlstm-1.3b", dict(n_layers=2, slstm_every=2), 2, 256,
                   {"1x4": (1, 4), "2x2": (2, 2)}),
    # two encoder and two decoder layers over 1024 frames
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2", dict(n_layers=2, enc_layers=2), 2, 256,
                              {"1x4": (1, 4), "2x2": (2, 2)}),
}
DEC_STEPS = 8
# (c) the planted faults (tests/torch_tp_probes.py) on one case of (a): the
# 320-slot cache splits 80 a shard, so the steps' slots 256-263 are the last
# shard's and a key written by every shard lands on live slots of the others
DEC_FAULT_CASE = ("qwen3-8b", "1x4")
DEC_FAULTS = ("split_k_own_max", "split_k_dropped_partial", "new_key_on_every_shard")
# (b) bf16 qwen3-8b, 12 of its 36 layers, tp 4: a 1024-token prefill, then
# 16 decode steps, at B = 2 and B = 8
DEC_FWD_ARCH, DEC_FWD_LAYERS, DEC_FWD_S, DEC_FWD_MESH = "qwen3-8b", 12, 1024, (1, 4)
DEC_FWD_BATCHES, DEC_FWD_STEPS = (2, 8), 16


def decode_run(lm, params, tokens, fe, s: int, steps: int):
    """``lm.prefill`` of ``tokens[:, :s]`` (placed parameters under active
    rules), then ``steps`` teacher-forced decode steps: (each step's logits,
    the cache after the last)."""
    with torch.no_grad():
        logits, cache = lm.prefill(params, tokens[:, :s], fe)
        out = [logits]
        for i in range(steps):
            logits, cache = lm.decode_step(params, cache, tokens[:, s + i:s + i + 1])
            out.append(logits)
    return out, cache


def decode_errors(logits, cache, want_logits, want_cache, vocab: int) -> dict:
    """Each step's logits and every gathered cache leaf against the
    unsharded run: their ``rel_err``, the worst of each."""
    from repro_torch.models.lm.sharding import gather_cache

    whole = gather_cache(cache)
    require(whole["pos"] == want_cache["pos"], f"pos {whole['pos']} != {want_cache['pos']}")
    steps = [rel_err(g[:, :vocab].to(w.device), w[:, :vocab]) for g, w in zip(logits, want_logits)]
    leaves = {k: rel_err(whole[k].to(w.device), w) for k, w in want_cache.items() if k != "pos"}
    return dict(steps=steps, logits_rel=max(steps), leaves=leaves,
                cache_rel=max(leaves.values()))


def decode_float32_check(dev, card: str) -> dict:
    """Phase 21(a) and (c): the cases of ``DEC_PROBE`` in float32, TF32 off,
    over simulated shards against the unsharded port on the same weights;
    the planted faults on ``DEC_FAULT_CASE``."""
    import gc

    from repro_torch.launch.mesh import simulated_devices
    from repro_torch.models.lm import LM
    from repro_torch.models.lm.sharding import shard_params, use_rules
    from torch_tp_probes import planted

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out, shapes = {}, collections.Counter()
    try:
        for i, (case, (arch, changes, b, s, meshes)) in enumerate(DEC_PROBE.items()):
            t0 = time.perf_counter()
            cfg = family_cfg(arch, changes, "float32")
            lm = LM(cfg, remat=False)
            params = lm.init(torch.Generator(device=dev).manual_seed(70 + i))
            gen = torch.Generator(device=dev).manual_seed(80 + i)
            tokens = torch.randint(0, cfg.vocab, (b, s + DEC_STEPS), device=dev, generator=gen)
            fe = (torch.randn((b, cfg.n_frontend_tokens, cfg.d_model), generator=gen, device=dev)
                  if cfg.frontend else None)
            want_logits, want_cache = decode_run(lm, params, tokens, fe, s, DEC_STEPS)
            for name, dims in meshes.items():
                rules = tp_rules(cfg, dims, simulated_devices(dims[0] * dims[1], dev))
                placed = shard_params(rules, params)
                with use_rules(rules), attention_shapes() as seen:
                    logits, cache = decode_run(lm, placed, tokens, fe, s, DEC_STEPS)
                shapes.update(seen)
                rec = decode_errors(logits, cache, want_logits, want_cache, cfg.vocab)
                del cache
                require(rec["logits_rel"] <= TP_LOGITS_TOL and rec["cache_rel"] <= TP_LOGITS_TOL,
                        f"decode float32 {case} {name}: steps {rec['steps']}, cache leaves "
                        f"{rec['leaves']} beyond {TP_LOGITS_TOL}")
                if (case, name) == DEC_FAULT_CASE:
                    for fault in DEC_FAULTS:
                        with planted(fault), use_rules(rules):
                            bad = decode_errors(*decode_run(lm, placed, tokens, fe, s, DEC_STEPS),
                                                want_logits, want_cache, cfg.vocab)
                        rec[f"planted_{fault}"] = max(bad["steps"][1:])
                        require(rec[f"planted_{fault}"] > TP_LOGITS_TOL,
                                f"decode float32 {case} {name}: the planted {fault} reads "
                                f"{rec[f'planted_{fault}']}, within {TP_LOGITS_TOL}")
                out[f"{case} {name}"] = rec
                print(f"lm decode tensor parallel float32 {case} {changes} {name}: B={b}, a "
                      f"{s}-token prefill and {DEC_STEPS} decode steps: logits "
                      f"{rec['logits_rel']:.3g} at worst over the steps, cache leaves "
                      f"{rec['cache_rel']:.3g} at worst "
                      f"({json.dumps({k: float(f'{v:.3g}') for k, v in rec['leaves'].items()})})"
                      " from the unsharded port"
                      + "".join(f", {k} {rec[k]:.3g}" for k in rec if k.startswith("planted"))
                      + f" relative [{card}]", flush=True)
                del placed
                gc.collect()
                torch.cuda.empty_cache()
            out[f"{case} seconds"] = time.perf_counter() - t0
            del params, want_logits, want_cache
            gc.collect()
            torch.cuda.empty_cache()
        out["shapes"] = {str(k): c for k, c in shapes.items()}
        out["kernels"] = tp_kernel_checks(dev, shapes, torch.float32, card, backward=False)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def decode_step_cost(cfg, b: int, cap: int, pos: int) -> dict:
    """``launch/cost.py``'s count of one sharded decode step of ``cfg`` at
    batch ``b`` on a cache of ``cap`` slots at ``pos``, over (1, 4) meta
    shards: per-shard FLOPs, bytes and link bytes, and the step's bound on
    one card from ``cost.HW`` (the 4 shards share it)."""
    from repro_torch.launch import cost
    from repro_torch.launch.mesh import simulated_devices
    from repro_torch.models.lm import LM
    from repro_torch.models.lm.sharding import shard_cache, shard_params, use_rules

    meta = torch.device("meta")
    lm = LM(cfg)
    n = DEC_FWD_MESH[0] * DEC_FWD_MESH[1]
    rules = tp_rules(cfg, DEC_FWD_MESH, simulated_devices(n, meta))
    params = shard_params(rules, lm.init_shapes())
    cache = shard_cache(rules, lm.init_cache(b, cap, meta))
    cache["pos"] = pos
    with use_rules(rules):
        _, spent = cost.count(lm.decode_step, params, cache,
                              torch.zeros((b, 1), dtype=torch.int64, device=meta))
    hw = cost.HW
    return dict(flops_per_shard=spent.flops / n, bytes_per_shard=spent.bytes / n,
                link_bytes=spent.collectives["link_bytes"],
                bound_ms_one_card=max(spent.flops / hw["peak_flops"],
                                      spent.bytes / hw["hbm_bw"]) * 1e3,
                peaks=hw["card"])


def decode_forward(dev, card: str) -> dict:
    """Phase 21(b): bf16 qwen3-8b at full width, 12 layers, over (1, 4)
    shards on one card: at B = 2 and 8, the sharded cached prefill and 16
    decode steps (a main path: counts reset just before the prefill, read
    after the last step), against the unsharded kernel path; the steps of
    the two timed in turns."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import simulated_devices
    from repro_torch.models.lm import LM, collectives
    from repro_torch.models.lm.sharding import shard_params, use_rules

    cfg = dataclasses.replace(get_config(DEC_FWD_ARCH), n_layers=DEC_FWD_LAYERS)
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(90))
    n = DEC_FWD_MESH[0] * DEC_FWD_MESH[1]
    rules = tp_rules(cfg, DEC_FWD_MESH, simulated_devices(n, dev))
    placed = shard_params(rules, params)
    out, calls, launches = {}, collections.Counter(), collections.Counter()
    h_loc, kv_loc = cfg.n_heads // n, cfg.n_kv_heads // n
    for b in DEC_FWD_BATCHES:
        tokens = torch.randint(0, cfg.vocab, (b, DEC_FWD_S + DEC_FWD_STEPS), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(91 + b))
        shape = attention_key(b, h_loc, kv_loc, DEC_FWD_S, cfg.resolved_head_dim)
        with torch.no_grad():
            want, want_cache = lm.prefill(params, tokens[:, :DEC_FWD_S])
            with use_rules(rules), attention_shapes() as seen:
                build.reset_launch_counts()  # the main path: counts set to 0 just before
                got, cache = lm.prefill(placed, tokens[:, :DEC_FWD_S])
                torch.cuda.synchronize()
                prefill_launches, prefill_paths = dict(build.LAUNCHES), dict(build.PATHS)
            errs = [rel_err(got[:, :cfg.vocab], want[:, :cfg.vocab])]
            collectives.reset_stats()
            timed = {"sharded": [], "unsharded": []}
            for i in range(DEC_FWD_STEPS):  # in turns: the unsharded step, then the sharded
                tok = tokens[:, DEC_FWD_S + i:DEC_FWD_S + i + 1]
                for name in ("unsharded", "sharded"):
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    start.record()
                    if name == "sharded":
                        with use_rules(rules):
                            got, cache = lm.decode_step(placed, cache, tok)
                    else:
                        want, want_cache = lm.decode_step(params, want_cache, tok)
                    stop.record()
                    torch.cuda.synchronize()
                    timed[name].append(((time.perf_counter() - t0) * 1e3, start.elapsed_time(stop)))
                errs.append(rel_err(got[:, :cfg.vocab], want[:, :cfg.vocab]))
            got_launches, paths = dict(build.LAUNCHES), dict(build.PATHS)
        coll = collectives.STATS.as_dict()
        kv_bytes = sum(want_cache[k].numel() * want_cache[k].element_size() for k in ("k", "v"))
        shard_bytes = [sum(blk.numel() * blk.element_size()
                           for blk in (cache["k"].own()[m], cache["v"].own()[m]))
                       for m in range(n)]
        cap = cache["k"].shape[2]
        require(all(math.isfinite(e) for e in errs) and max(errs) <= STATE_REL_TOL,
                f"decode forward B={b}: sharded logits {errs} beyond {STATE_REL_TOL}")
        require(prefill_launches == got_launches == {"flash_attention": cfg.n_layers * n}
                and prefill_paths == paths == {"flash_attention.tma": cfg.n_layers * n}
                and dict(seen) == {shape: cfg.n_layers * n},
                f"decode forward B={b}: launches {prefill_launches} in the prefill, "
                f"{got_launches} after the decode steps, paths {paths}, shapes {dict(seen)}; "
                f"expected {cfg.n_layers * n} on the TMA path at {shape} and none in decode")
        require(all(x * n == kv_bytes for x in shard_bytes) and cap % n == 0,
                f"decode forward B={b}: cache bytes a shard {shard_bytes}, unsharded {kv_bytes}")
        calls.update(seen)
        launches.update(got_launches)
        med = {name: dict(wall_ms=statistics.median(w for w, _ in rows[1:]),
                          event_span_ms=statistics.median(e for _, e in rows[1:]))
               for name, rows in timed.items()}
        rec = dict(arch=DEC_FWD_ARCH, layers=cfg.n_layers, mesh=list(DEC_FWD_MESH), batch=b,
                   prefill=DEC_FWD_S, steps=DEC_FWD_STEPS, logits_rel=errs, launches=got_launches,
                   paths=paths, shapes={str(k): c for k, c in seen.items()},
                   step_ms=med, step_ms_all={k: [list(r) for r in v] for k, v in timed.items()},
                   cache_bytes_per_shard=shard_bytes[0], unsharded_kv_bytes=kv_bytes,
                   collectives_per_step=dict(
                       link_bytes=coll["link_bytes"] / DEC_FWD_STEPS,
                       **{k: {o: c / DEC_FWD_STEPS for o, c in coll[k].items()}
                          for k in ("per_op_bytes", "per_op_count")}),
                   cost=decode_step_cost(cfg, b, cap, DEC_FWD_S + DEC_FWD_STEPS // 2))
        out[f"b{b}"] = rec
        print(f"lm decode tensor parallel bf16 {DEC_FWD_ARCH} {cfg.n_layers} layers over "
              f"{DEC_FWD_MESH} shards on one card: B={b}, a {DEC_FWD_S}-token prefill and "
              f"{DEC_FWD_STEPS} decode steps, logits {max(errs):.4g} at worst from the unsharded "
              f"kernel path; {cfg.n_layers * n} flash_attention launches in the prefill, all "
              f"TMA, at {shape}, none in decode; a decode step (median of steps 2-"
              f"{DEC_FWD_STEPS}, in turns) sharded {med['sharded']['wall_ms']:.2f} ms wall, "
              f"{med['sharded']['event_span_ms']:.2f} ms between events; unsharded "
              f"{med['unsharded']['wall_ms']:.2f} ms wall, "
              f"{med['unsharded']['event_span_ms']:.2f} ms between events; cache "
              f"{shard_bytes[0]} bytes a shard of {kv_bytes} ({cap} slots); collectives a step "
              f"{json.dumps(rec['collectives_per_step'])}; launch/cost.py's count of the step: "
              f"{json.dumps(rec['cost'])} [{card}]", flush=True)
        del cache, want_cache
        gc.collect()
        torch.cuda.empty_cache()
    del placed, params
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = dict(launches)
    out["shapes"] = {str(k): c for k, c in calls.items()}
    out["kernels"] = tp_kernel_checks(dev, calls, torch.bfloat16, card, backward=False)
    return out


def lm_decode_tensor_parallel_phase(dev, card: str) -> dict:
    """Phase 21: LM decode over a mesh of shards."""
    t0 = time.perf_counter()
    out = {"float32": decode_float32_check(dev, card)}
    out["forward"] = decode_forward(dev, card)
    out["launches"] = out["forward"]["launches"]
    out["vs_plain"] = dict(kernels={**out["float32"]["kernels"], **out["forward"]["kernels"]})
    out["seconds"] = time.perf_counter() - t0
    print(f"lm decode tensor parallel phase: {out['seconds']:.1f} s, launches on the main path "
          f"{json.dumps(out['launches'])} [{card}]", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.append(str(ROOT / "tests"))  # torch_tp_probes: the probes shared with the CPU tests
    from repro_torch.core.executor import BiathlonConfig
    from repro_torch.core.guarantee import guarantee_prob
    from repro_torch.data.synthetic import make_pipeline
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    build_s = build.build_all()["total"]
    print(f"build: {build_s:.2f} s for {len(build.SOURCES)} kernels (nvcc, sm_90a)", flush=True)

    # degenerate sigma: a float32-subnormal bias is not within delta = 0
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    require(float(guarantee_prob(f(0.0), f(1e-38), f(0.0), f(0.0))) == 0.0,
            "guarantee_prob: subnormal bias accepted at delta = 0")

    t0 = time.perf_counter()
    full = make_pipeline("turbofan", device=dev)
    print(f"turbofan bundle: {full.table_rows} rows, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cfg = BiathlonConfig()
    rec = check_kernels(dev, full, cfg.alpha)
    rec["flash_attention"] = flash_record(dev)
    print("kernels vs plain: ok", flush=True)

    results = {}
    runs = {
        "auto": dict(afc_backend="auto", use_kernel=True),
        "ref": dict(afc_backend="ref", use_kernel=True),
        "plain": dict(afc_backend="auto", use_kernel=False),
    }
    for name, kw in runs.items():
        results[name] = serve_run(full, cfg, dev, n_req=N_SERVE, **kw)
    # a tighter error bound makes full-width requests enter the planner loop
    tight = BiathlonConfig(delta=full.pipeline.delta_default * 0.3)
    for name in ("auto", "plain"):
        results[f"{name}_tight"] = serve_run(full, tight, dev, n_req=N_SERVE, **runs[name])
    compare_runs("tight auto vs plain", results["plain_tight"][0],
                 results["auto_tight"][0], tight)
    caps = sorted({o["cap"] for o in results["auto"][0]})
    require(min(caps) > 1024, f"full-width caps {caps} do not take the incremental path")
    expect_launched("auto", results["auto"][2],
                    ["prefix_power_sums", "ensemble_sum", "sobol_points"], ["sampled_moments"])
    expect_launched("ref", results["ref"][2],
                    ["sampled_moments", "ensemble_sum", "sobol_points"], ["prefix_power_sums"])
    require(not results["plain"][2], f"plain run launched kernels {results['plain'][2]}")
    expect_launched("auto tight", results["auto_tight"][2],
                    ["prefix_power_sums", "ensemble_sum", "sobol_points"], ["sampled_moments"])
    compare_runs("auto vs plain", results["plain"][0], results["auto"][0], cfg)
    compare_runs("ref vs plain", results["plain"][0], results["ref"][0], cfg)
    for name, (outs, p50, launches, _) in results.items():
        print(f"serve {name}: p50 {p50 * 1e3:.3f} ms over {len(outs)} requests, "
              f"iters {[o['iters'] for o in outs]}, caps {sorted({o['cap'] for o in outs})}, "
              f"launches {launches} [{card}]", flush=True)

    outs = results["auto_tight"][0]
    busiest = max(range(N_SERVE), key=lambda i: outs[i]["iters"])
    prof = profile_request(full, tight, dev, full.requests[busiest],
                           ROOT / "build" / "chip_smoke_profile.txt")
    prof["latency_ms"] = outs[busiest]["latency"] * 1e3
    print(f"profile of tight request {busiest}: {json.dumps(prof)} [{card}]", flush=True)
    prof["eager"] = profile_request(full, tight, dev, full.requests[busiest],
                                    ROOT / "build" / "chip_smoke_profile_eager.txt",
                                    capture=False)
    print(f"profile of tight request {busiest}, eager: {json.dumps(prof['eager'])} [{card}]",
          flush=True)

    small = make_pipeline("turbofan", rows_per_group=500, device=dev)
    sm = {name: serve_run(small, cfg, dev, n_req=4, **kw)
          for name, kw in (("auto", runs["auto"]), ("plain", runs["plain"]))}
    require(max(o["cap"] for o in sm["auto"][0]) <= 1024, "reduced-depth caps exceed 1024")
    expect_launched("reduced auto", sm["auto"][2],
                    ["sampled_moments", "ensemble_sum", "sobol_points"], ["prefix_power_sums"])
    compare_runs("reduced auto vs plain", sm["plain"][0], sm["auto"][0], cfg)
    for name, (outs, p50, launches, _) in sm.items():
        print(f"serve reduced {name}: p50 {p50 * 1e3:.3f} ms over {len(outs)} requests, "
              f"iters {[o['iters'] for o in outs]}, launches {launches} [{card}]", flush=True)

    # sensor_health: the holistic path
    t0 = time.perf_counter()
    health = make_pipeline("sensor_health", device=dev)
    print(f"sensor_health bundle: {health.table_rows} rows, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rec["masked_select_ranks"] = select_record(health, dev, cfg)
    rec["prefix_power_sums"]["sensor_health"] = request_tables_record(health, dev)
    rec["masked_select_ranks"]["sweep"] = select_sweep(dev)
    rec["masked_select_ranks"]["max_abs_err"] = max(
        [rec["masked_select_ranks"]["max_abs_err"]]
        + [r["max_abs_err"] for r in rec["masked_select_ranks"]["sweep"]])
    hs = {name: serve_run(health, cfg, dev, n_req=N_SERVE, **kw) for name, kw in runs.items()}
    h_tight = BiathlonConfig(delta=health.pipeline.delta_default * 0.3)
    for name in ("auto", "plain"):
        hs[f"{name}_tight"] = serve_run(health, h_tight, dev, n_req=N_SERVE, **runs[name])
    caps = sorted({o["cap"] for o in hs["auto"][0]})
    require(min(caps) > 1024, f"sensor_health caps {caps} do not take the incremental path")
    expect_launched("sensor_health ref", hs["ref"][2],
                    ["masked_select_ranks", "sampled_moments", "ensemble_sum"],
                    ["prefix_power_sums"])
    for name in ("auto", "auto_tight"):
        expect_launched(f"sensor_health {name}", hs[name][2],
                        ["prefix_power_sums", "ensemble_sum"],
                        ["masked_select_ranks", "sampled_moments"])
    for name in ("plain", "plain_tight"):
        require(not hs[name][2], f"sensor_health {name} launched kernels {hs[name][2]}")
    compare_runs("sensor_health auto vs plain", hs["plain"][0], hs["auto"][0], cfg)
    compare_runs("sensor_health ref vs plain", hs["plain"][0], hs["ref"][0], cfg)
    compare_runs("sensor_health tight auto vs plain", hs["plain_tight"][0],
                 hs["auto_tight"][0], h_tight)
    for name, (outs, p50, launches, _) in hs.items():
        print(f"serve sensor_health {name}: p50 {p50 * 1e3:.3f} ms over {len(outs)} requests, "
              f"iters {[o['iters'] for o in outs]}, caps {sorted({o['cap'] for o in outs})}, "
              f"launches {launches} [{card}]", flush=True)
    outs = hs["auto_tight"][0]
    busiest = max(range(N_SERVE), key=lambda i: outs[i]["iters"])
    h_prof = profile_request(health, h_tight, dev, health.requests[busiest],
                             ROOT / "build" / "chip_smoke_profile_sensor_health.txt")
    h_prof["latency_ms"] = outs[busiest]["latency"] * 1e3
    print(f"profile of sensor_health tight request {busiest}: {json.dumps(h_prof)} [{card}]",
          flush=True)
    h_prof["eager"] = profile_request(
        health, h_tight, dev, health.requests[busiest],
        ROOT / "build" / "chip_smoke_profile_sensor_health_eager.txt", capture=False)
    print(f"profile of sensor_health tight request {busiest}, eager: "
          f"{json.dumps(h_prof['eager'])} [{card}]", flush=True)

    h_small = make_pipeline("sensor_health", rows_per_group=500, device=dev)
    hsm = {name: serve_run(h_small, cfg, dev, n_req=4, **kw)
           for name, kw in (("auto", runs["auto"]), ("plain", runs["plain"]))}
    require(max(o["cap"] for o in hsm["auto"][0]) <= 1024,
            "sensor_health reduced-depth caps exceed 1024")
    expect_launched("sensor_health reduced auto", hsm["auto"][2],
                    ["masked_select_ranks", "sampled_moments", "ensemble_sum"],
                    ["prefix_power_sums"])
    require(not hsm["plain"][2], f"sensor_health reduced plain launched {hsm['plain'][2]}")
    compare_runs("sensor_health reduced auto vs plain", hsm["plain"][0], hsm["auto"][0], cfg)
    for name, (outs, p50, launches, _) in hsm.items():
        print(f"serve sensor_health reduced {name}: p50 {p50 * 1e3:.3f} ms over {len(outs)} "
              f"requests, iters {[o['iters'] for o in outs]}, launches {launches} [{card}]",
              flush=True)

    paper = paper_pipelines_phase(dev, cfg, card, np.random.default_rng(1))
    rec["ensemble_sum"].update(paper["trees"])
    rec["ensemble_sum"]["max_abs_err"] = max(
        [rec["ensemble_sum"]["max_abs_err"]] + [r["max_abs_err"] for r in paper["trees"].values()])

    all_bundles = dict(paper["bundles"], turbofan=full, sensor_health=health)
    host = host_phase(dev, all_bundles, cfg, card, np.random.default_rng(2))
    rec["masked_select_ranks"]["max_abs_err"] = max(
        [rec["masked_select_ranks"]["max_abs_err"], host["kernels"]["masked_select_ranks"][
            "max_abs_err"], host["kernels"]["masked_select_ranks"]["full"]["max_abs_err"]]
        + [r["max_abs_err"] for r in host["kernels"]["masked_select_ranks"]["counting_edge"]])
    rec["ensemble_sum"]["max_abs_err"] = max(
        [rec["ensemble_sum"]["max_abs_err"]]
        + [r["max_abs_err"] for pipe in host["kernels"]["ensemble_sum"].values()
           for r in pipe.values()])
    rec["sobol_points"]["max_abs_err"] = max(
        [rec["sobol_points"]["max_abs_err"]]
        + [r["max_abs_err"] for r in host["kernels"]["sobol_points"].values()])

    lanes = lane_kernels(dev, all_bundles, cfg, np.random.default_rng(3))
    batched = batched_phase(dev, all_bundles, cfg, card)
    for kname, recs in lanes.items():
        recs = recs.values() if kname in LANE_SHAPES_BY_CASE else [recs]
        rec[kname]["max_abs_err"] = max([rec[kname]["max_abs_err"]]
                                        + [r["max_abs_err"] for r in recs])
    cache = feature_cache_phase(dev, all_bundles, small, cfg, card)
    # the reduced-depth requests the cached phase served at cap 512
    rows512 = torch.cat([small.store.request_buffers(small.pipeline.agg_specs(r), 512, dev)[0]
                         for r in cache["turbofan_reduced"]["requests"]])
    rec["prefix_power_sums"]["cap_512"] = {
        f"{r}x512": prefix_record(rows512[:r].contiguous(), rows512[:r, 0].contiguous())
        for r in (small.pipeline.k, rows512.shape[0])}
    rec["prefix_power_sums"]["max_abs_err"] = max(
        [rec["prefix_power_sums"]["max_abs_err"]]
        + [r["max_abs_err"] for r in rec["prefix_power_sums"]["cap_512"].values()])
    for key, r in rec["prefix_power_sums"]["cap_512"].items():
        print(f"prefix_power_sums {key}: {r['ms']:.5f} ms (eager {r['eager_ms']:.4f}, plain "
              f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.6f}) [{card}]", flush=True)
    crossover = afc_crossover(dev, cfg)
    for r in crossover:
        print(f"afc crossover {r['pipeline']} cap {r['cap']}: set-up {r['setup_ms']:.4f} ms, "
              f"an evaluation incremental {r['incremental_eval_ms']:.4f} ms, rescan "
              f"{r['rescan_eval_ms']:.4f} ms, crossover {r['crossover_evals']} evaluations; "
              f"device: set-up {r['setup_device_ms']:.4f} ms, incremental "
              f"{r['incremental_eval_device_ms']:.4f}, rescan {r['rescan_eval_device_ms']:.4f}, "
              f"crossover {r['crossover_evals_device']} [{card}]", flush=True)

    lm_head, lm_scenario = lm_head_phase(dev, card)
    backbone = backbone_profile(lm_scenario, dev,
                                ROOT / "build" / "chip_smoke_profile_backbone4096.txt")
    print(f"backbone 1x4096 forward: {json.dumps(backbone)} [{card}]", flush=True)
    cont = continuous_phase(dev, all_bundles, batched, card)
    shard = sharded_phase(dev, all_bundles, cfg, batched, card)
    lm_serving = lm_serving_phase(dev, card)
    lm_families = lm_families_phase(dev, card)
    lm_training = lm_training_phase(dev, card)
    lm_tp = lm_tensor_parallel_phase(dev, card)
    lm_moe_tp = lm_moe_tensor_parallel_phase(dev, card)
    lm_fam_tp = lm_family_tensor_parallel_phase(dev, card)
    lm_dec_tp = lm_decode_tensor_parallel_phase(dev, card)

    def per_request(run, kname, n_req):
        """Launches of a run's requests (its warm-up pass and the eager pass
        before each capture included), apart from its build."""
        _, _, launches, at_build = run
        return (launches.get(kname, 0) - at_build.get(kname, 0)) / (2 * n_req)

    path_run = {"prefix_power_sums": "auto", "sampled_moments": "ref",
                "ensemble_sum": "auto", "sobol_points": "auto", "masked_select_ranks": "ref"}
    # the rescan as "auto" serves it at reduced depth: its own inputs and counts
    rec["sampled_moments"]["reduced_depth"] = dict(
        moments_record(small, dev, cfg.alpha),
        launches=sm["auto"][2].get("sampled_moments", 0),
        launches_per_request=per_request(sm["auto"], "sampled_moments", 4))
    rec["masked_select_ranks"]["reduced_depth"] = dict(
        select_record(h_small, dev, cfg),
        launches=hsm["auto"][2].get("masked_select_ranks", 0),
        launches_per_request=per_request(hsm["auto"], "masked_select_ranks", 4))
    rec["masked_select_ranks"]["phases"] = [
        "request_0_z0_bitwise", "bitwise_stable", "rank_path_bitwise", "sort_gather_bitwise",
        "sweep_4096_16384_32768_65536_bitwise", "reduced_depth_request_0_z0_bitwise"]
    sources = {
        "prefix_power_sums": ("prefix_stats.cu", "src/repro/kernels/sampled_agg/prefix_stats.py:124"),
        "sampled_moments": ("sampled_agg.cu", "src/repro/kernels/sampled_agg/sampled_agg.py:74"),
        "ensemble_sum": ("tree_qmc.cu", "src/repro/kernels/tree_qmc/tree_qmc.py:62"),
        "sobol_points": ("sobol.cu", "src/repro/kernels/sobol/sobol.py:38"),
        "masked_select_ranks": ("quantile_select.cu",
                                "src/repro/kernels/sampled_agg/quantile_select.py:81"),
    }
    kernels = []
    for kname, (src, replaces) in sources.items():
        r = rec[kname]
        # the turbofan runs, or for masked_select_ranks the sensor_health runs
        runs_k = hs if kname == "masked_select_ranks" else results
        path = runs_k[path_run[kname]]
        kernels.append(dict(
            name=kname, route="cuda", source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=replaces,
            launches=runs_k["auto"][2].get(kname, 0) + runs_k["ref"][2].get(kname, 0),
            launches_per_request=per_request(path, kname, N_SERVE),
            launches_per_executor_build=path[3].get(kname, 0),
            max_abs_err=r["max_abs_err"], ms=r["ms"], eager_ms=r["eager_ms"],
            plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r.get("library_ms"),
            shape=r["shape"], phases=r["phases"],
            **{key: r[key] for key in ("z", "reduced_depth", "sort_gather_ms", "sweep",
                                       "earlier_ms", "depth", "node_visits", "plan", "chunk",
                                       "blocks", "gbm", "lm_head", "sensor_health", "run",
                                       "grids", "student_qa", "fraud_detection", "cap_512")
               if key in r},
            launches_paper_pipelines=sum(
                v.get("launches", {}).get(kname, 0) for pipe in paper["serve"].values()
                for v in pipe.values() if isinstance(v, dict)),
            launches_host_path=host["launches"].get(kname, 0),
            launches_batched=batched["launches"].get(kname, 0),
            launches_feature_cache=cache["launches"].get(kname, 0),
            launches_continuous=cont["launches"].get(kname, 0),
            launches_sharded=shard["launches"].get(kname, 0),
            **({"lane_shapes": lanes[kname]} if kname in lanes else {}),
            **({"host_shapes": host["kernels"][kname]} if kname in host["kernels"] else {}),
        ))
        if kname in SERVED_PATHS:
            kernels[-1]["paths"] = {
                n: runs_k["auto"][2].get(n, 0) + runs_k["ref"][2].get(n, 0)
                for n in set(runs_k["auto"][2]) | set(runs_k["ref"][2])
                if n.startswith(kname + ".")}
    fa = rec["flash_attention"]
    fa["max_abs_err"] = max([fa["max_abs_err"]]
                            + [r["max_abs_err"] for r in lm_serving["attention"].values()]
                            + [r["max_abs_err"] for r in lm_families["attention"].values()])
    fa["phases"] = fa["phases"] + list(lm_serving["attention"]) + list(lm_families["attention"])
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:74",
        launches=lm_head["launches"].get("flash_attention", 0),
        launches_per_request=(lm_head["launches"].get("flash_attention", 0)
                              - lm_head["launches_at_build"].get("flash_attention", 0))
        / N_LM_REQ,
        launches_per_executor_build=lm_head["launches_at_build"].get("flash_attention", 0),
        paths=lm_head["flash_attention_paths"],
        **{key: fa[key] for key in ("max_abs_err", "ms", "eager_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "library_max_abs_err", "shape",
                                    "dtype", "causal", "phases", "errors", "lm_head_shape",
                                    "prefill_d128", "ratio_to_library",
                                    "bound_share", "instances")},
        backbone_4096_launches=backbone["flash_attention_launches"],
        launches_continuous=cont["launches"].get("flash_attention", 0),
        launches_sharded=shard["launches"].get("flash_attention", 0),
        launches_lm_serving=lm_serving["launches"].get("flash_attention", 0),
        lm_serving_shapes=lm_serving["attention"],
        launches_lm_families=lm_families["launches"].get("flash_attention", 0),
        lm_families_shapes=lm_families["attention"],
        launches_lm_training=lm_training["launches"].get("flash_attention", 0),
        lm_training_lse="on the training path each launch also writes the row log-sum-exp",
        launches_lm_tensor_parallel=lm_tp["launches"].get("flash_attention", 0),
        lm_tensor_parallel_shapes=dict(forward=lm_tp["forward"]["shapes"],
                                       training=lm_tp["training"]["shapes"]),
        lm_tensor_parallel_vs_plain=lm_tp["vs_plain"],
        launches_lm_moe_tensor_parallel=lm_moe_tp["launches"].get("flash_attention", 0),
        lm_moe_tensor_parallel_shapes=dict(forward=lm_moe_tp["forward"]["shapes"],
                                           training=lm_moe_tp["training"]["shapes"]),
        lm_moe_tensor_parallel_vs_plain=lm_moe_tp["vs_plain"],
        launches_lm_family_tensor_parallel=lm_fam_tp["launches"].get("flash_attention", 0),
        lm_family_tensor_parallel_shapes=dict(forward=lm_fam_tp["forward"]["shapes"],
                                              training=lm_fam_tp["training"]["shapes"]),
        lm_family_tensor_parallel_vs_plain=lm_fam_tp["vs_plain"],
        launches_lm_decode_tensor_parallel=lm_dec_tp["launches"].get("flash_attention", 0),
        lm_decode_tensor_parallel_shapes=dict(float32=lm_dec_tp["float32"]["shapes"],
                                              forward=lm_dec_tp["forward"]["shapes"]),
        lm_decode_tensor_parallel_vs_plain=lm_dec_tp["vs_plain"],
    ))
    qwen_case = lm_training["backward"]["qwen05b_4x16x1024x64_causal"]
    for kname, what in (("flash_attention_bwd_dq", "dq"), ("flash_attention_bwd_dkv", "dk dv")):
        kernels.append(dict(
            name=kname, route="cuda", source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            replaces="none: the Pallas kernel (src/repro/kernels/flash_attention/"
                     "flash_attention.py:98) has no backward; the reference differentiates "
                     "src/repro/models/lm/layers.py:98 by XLA autodiff",
            launches=lm_training["launches"].get(kname, 0),
            launches_per_step=lm_training["qwen"]["launches_per_step"].get(kname, 0),
            launches_lm_tensor_parallel=lm_tp["launches"].get(kname, 0),
            lm_tensor_parallel_vs_plain={n: dict(shape=r["shape"], path=r["backward_path"],
                                                 rel_err=r["backward_rel_err"])
                                         for n, r in lm_tp["vs_plain"]["kernels"].items()},
            launches_lm_moe_tensor_parallel=lm_moe_tp["launches"].get(kname, 0),
            lm_moe_tensor_parallel_vs_plain={
                n: dict(shape=r["shape"], path=r["backward_path"], rel_err=r["backward_rel_err"])
                for n, r in lm_moe_tp["vs_plain"]["kernels"].items() if "backward_path" in r},
            launches_lm_family_tensor_parallel=lm_fam_tp["launches"].get(kname, 0),
            lm_family_tensor_parallel_vs_plain={
                n: dict(shape=r["shape"], path=r["backward_path"], rel_err=r["backward_rel_err"])
                for n, r in lm_fam_tp["vs_plain"]["kernels"].items() if "backward_path" in r},
            paths={n: c for n, c in lm_training["qwen"]["paths"].items()
                   if n.startswith(kname + ".")},
            max_abs_err=max(max(r["max_abs_err"][g] for g in what.split())
                            for r in lm_training["backward"].values()),
            ms=qwen_case["kernels"][kname]["ms"], eager_ms=qwen_case["kernels"][kname]["eager_ms"],
            plain_ms=qwen_case["plain_ms"], bound_ms=qwen_case["kernels"][kname]["bound_ms"],
            bound_by=qwen_case["kernels"][kname]["bound_by"], library_ms=qwen_case["library_ms"],
            shape=qwen_case["shape"], dtype=qwen_case["dtype"],
            note="plain_ms and library_ms are the whole backward's (the plain version and "
                 "SDPA's autograd compute dq, dk and dv in one call)",
            shapes={n: dict(path=r["path"], ms=r["kernels"][kname]["ms"],
                            eager_ms=r["kernels"][kname]["eager_ms"],
                            bound_ms=r["kernels"][kname]["bound_ms"],
                            bound_by=r["kernels"][kname]["bound_by"], plain_ms=r["plain_ms"],
                            library_ms=r["library_ms"], rel_err=r["rel_err"])
                    for n, r in lm_training["backward"].items()},
        ))
    serve = {name: dict(p50_ms=p50 * 1e3, iters=[o["iters"] for o in outs])
             for name, (outs, p50, *_) in results.items()}
    serve.update({f"reduced_{name}": dict(p50_ms=p50 * 1e3, iters=[o["iters"] for o in outs])
                  for name, (outs, p50, *_) in sm.items()})
    for prefix, group in (("sensor_health_", hs), ("sensor_health_reduced_", hsm)):
        serve.update({f"{prefix}{name}": dict(p50_ms=p50 * 1e3, iters=[o["iters"] for o in outs],
                                              launches=launches)
                      for name, (outs, p50, launches, _) in group.items()})
    serve["lm_head"] = {key: val for key, val in lm_head.items()
                        if key not in ("launches", "launches_at_build")}
    serve["paper_pipelines"] = paper["serve"]
    serve["host"] = {key: val for key, val in host.items() if key != "kernels"}
    serve["batched"] = batched
    serve["feature_cache"] = cache
    serve["continuous"] = cont
    serve["sharded"] = shard
    serve["lm_serving"] = lm_serving
    serve["lm_families"] = lm_families
    serve["lm_training"] = lm_training
    serve["lm_tensor_parallel"] = lm_tp
    serve["lm_moe_tensor_parallel"] = lm_moe_tp
    serve["lm_family_tensor_parallel"] = lm_fam_tp
    serve["lm_decode_tensor_parallel"] = lm_dec_tp
    seconds = time.perf_counter() - t_start
    print(json.dumps({"card": card, "build_s": build_s, "serve": serve, "profile": prof,
                      "afc_crossover": crossover,
                      "profile_sensor_health": h_prof,
                      "profile_classification": paper["profile_classification"],
                      "backbone_4096": backbone, "seconds": seconds}), flush=True)
    print(f"chip_smoke: {seconds:.1f} s in all, build included [{card}]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, AssertionError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
