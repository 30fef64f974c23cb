#!/usr/bin/env python3
"""On-card smoke test of ``repro_torch``, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero):

1. print the card and build the CUDA kernels from ``src/repro_torch``
   (``nvcc``, ``sm_90a``, one process per source, started together),
   with each kernel's registers and spills, for the ticks' sweep its
   resident warps an SM and SASS instructions a cell, for K7 its SASS
   and store counts and for K9 f32 and its backward their HGMMA counts;
2. hold K1, the scored streaming tick, against its plain PyTorch version
   on the card: bitwise on dyadic-grid data, and on smooth data within
   the stated tolerance, at chunk widths 1-32 and banks of 1, 7 and 133
   references (``tick_cases``);
3. the same for K2, the verdict scorer (a warp per pair sweeping the DP
   as a wavefront of 32 strips), on ragged banks and on banks with
   references of 1 and 5 columns (shorter than a strip) and longer than
   one 384-column panel, queries of 0-2 rows and shorter than the 32
   lanes, and a band of 2 (narrower than a strip);
4. the same for K4, the probabilistic tick, with six channels (exact)
   and four (approx), dyadic variances on dyadic data, on the same
   shapes; probabilities within PROB_TOL;
5. the same for K5 and K6, the exact and approx probabilistic verdict
   scorers, on phase 3's shapes, and at zero variance their
   probabilities bitwise in {0, 1};
6. the paper scenario: the point-mode ``TuningService`` matches exim
   traces against a wordcount/terasort bank while they run; every final
   verdict must be ``wordcount`` and every early decision must come at
   the reference's fraction; then the same scenario in probabilistic
   mode at zero variance, with both ``prob_mode``s, must decide exactly
   as point mode did, every probability in {0, 1};
7. the full-width runs: S=256 in-flight jobs against a K=256 bank
   (M=360) for 24 ticks of 16 samples, then one batched verdict of 32
   jobs — in point mode (K1, K2), exact probabilistic mode (K4 with six
   channels, K5) and approx probabilistic mode (K4 with four channels,
   K5, and K6 through ``dtw_score_bank_many(prob_mode="approx")``).
   Each run sets every launch count to 0 just before it and checks them
   against the service's dispatch counters just after; one tick is held
   against the plain version, and each kernel is timed beside its plain
   version and its bound, the tick kernel also as a share of the median
   tick;
8. K3, the distance-only tick, against its plain version (bitwise on
   dyadic data, SMOOTH_TOL on smooth data) and against K1's rows on the
   same inputs (bitwise on any data), on phase 2's shapes;
9. the paper scenario degraded: distance-only (``score_in_flight=
   False``: K3, K2) and point mode pinned at the overload ladder's rung
   3 by ``latency=`` overrides; both make no early decision and render
   point mode's finals;
10. the full-width distance-only run (S=256, K=256, M=360, 24 ticks of
    16 samples, a verdict of 32: K3 and K2), its rows bitwise the point
    run's and its verdicts the point run's; then the full-width ladder:
    the exact-probability run of phase 7 walked through rungs 0, 1, 2
    and 3 by ``latency=`` overrides, six ticks a rung, launching K4 with
    six channels, K4 with four over ``moms[:4]``, K1 over ``moms[:3]``
    and K3 once a tick of each rung; its 32 verdicts are bitwise phase
    7's and its early decisions a subset of phase 7's; each rung's tick
    kernel is printed as a share of the rung's median tick;
11. retry, breaker and chaos at the paper scenario's size: a fault plan
    that fails every dispatch trips the breaker, the fallback (the same
    dispatch without the chaos consult) serves through K1, whose
    launches must equal the service's ``dispatch_count`` across the
    burst, and after the burst the breaker re-closes; decisions bitwise
    the fault-free run's;
12. the multi-tenant front over the paper bank's two halves: decisions
    equal to two separate services', dispatches their sum;
13. (run with the kernel checks, right after phase 8) K7, the DTW
    matrix, against its plain version, bitwise on dyadic and smooth data:
    the bank and pairs forms, banded, ragged, a 1100-row chunk,
    references of up to 1000 columns (three 384-column panels), resumed
    from a carried row in chunks of 16 and of one row (bitwise the
    one-shot matrix); its rows against K3's and its endpoints against
    K2's distances, bitwise; the ``kernels.dtw.ops`` API bitwise the
    wrapper; and K2 pairs against its plain version and against K2 on
    the same pairs;
14. the offline matching phase at the paper's size: Table 1 through the
    scalar ``similarity`` (K7) and both ``similarity_bank`` engines (K2;
    K7 and host backtracks), each within 2e-3 of
    ``tests/golden/table1_similarity.json``; ``match_application``
    through one K2 pairs launch (every count set to 0 just before it,
    read just after; K2 pairs' bound counts the band's cells); the
    quickstart scenario (``AutoTuner``
    matches exim to wordcount and transfers its config);
15. the offline matching phase at full width: 8 queries of 384 samples
    against the K=256, M=360 bank through ``similarity_bank(
    matrix_path=True)`` (one K7 launch each), within 5e-3 of the
    matrix-free scores; one ``OnlineMatcher(collect_rows=True)`` job in
    24 chunks of 16 (24 K7 launches), its rows bitwise the one-shot
    matrix; K7 timed (the full matrix, a resumed chunk, the last row
    only; back-to-back calls from CUDA events and the kernel's own device
    time from the profiler) beside its plain version, its bound and the
    parent's times, and the host backtrack timed;
16. K8, the batched IIR filter, against its plain version on the
    reference's IIR test shapes and every order 1-8 (bitwise expected,
    differing elements counted, each within IIR_TOL), then the paper's
    order-6 de-noise over a reference DB of B=8192 series x T=3600
    samples through ``kernels.iir.lfilter_batched`` (one launch), held
    to the plain version and, on 64 series, both to the float64 oracle
    within IIR_ORACLE_TOL;
    timed beside its plain version and bound;
17. K9, flash attention, against its plain version on the reference's
    test shapes (f32 within ATTN_F32_TOL, bf16 within ATTN_BF16_TOL and
    one bf16 step), S != T, dh 96 and 128, ragged tiles, and in bf16 head
    dims padded in shared memory (dh 24 / dv 48, dh 20 / dv 12); bf16
    launches the bf16 ``wgmma`` kernel, f32 the split-TF32 one, also at
    dh 18 / dv 10 and on inputs one element into their storage (its
    element-wise loads); then
    granite-20b's causal prefill layer (48 heads, kv 1, dh 128,
    S=T=4096) through ``kernels.attention.flash_attention`` in bf16 and
    in f32 (one launch each), held to the plain version, each timed
    beside it, its bound (f32: three TF32 products) and
    ``scaled_dot_product_attention``, with the HGMMA counts of both
    kernels' SASS;
    phi3-mini's MHA (32 heads, dh 96, S=4096) checked the same way,
    untimed;
18. K10, the GLA chunked scan, against its plain version on the
    reference's test shapes (rtol GLA_RTOL, atol GLA_ATOL), then
    zamba2-7b's SSD scan (112 heads of 64, state 64, chunk 256, S=4096,
    bf16) through ``kernels.gla.gla_scan`` (one launch), held to the
    plain version (the float32 state within the tolerance, the bf16
    output within one bf16 ulp besides, and the same inputs in float32
    within the tolerance), timed beside its plain version and bound;
19. the wavelet prefilter at the paper's size: each golden trace (exim,
    wordcount, terasort) against the 12-reference golden bank (band 16,
    denoise, chunks of 8) by an unpruned and a ``prefilter_top=4``
    service side by side, in point mode (K1, K2) and exact probabilistic
    mode at zero variance (K4 with six channels, K5): decisions and
    finals equal tick for tick, the pruned scores on each tick's live
    columns bitwise the unpruned ones, one tick launch a dispatch; the
    quickstart through ``AutoTuner(band=8, wavelet_prefilter=1)``
    (wordcount, one K2 launch);
20. the pruned scored tick at full width: the bench's diverse bank (K =
    256 distinct workloads, M = 360), S = 256 jobs (16 workloads x 16
    instances), 16 ticks of 16 samples, by distance-only, unpruned and
    pruned (``prefilter_top=2``, margin 0, engaged at 10%) services:
    true references survive, leaders and a 32-job verdict equal the
    unpruned run's, live-column scores bitwise on every tick, at least
    one re-pack to fewer than 256 columns, launches equal to dispatches;
    each run's median ms/tick, the packed widths, the re-pack times and
    ``_update_prefilter``'s host time printed, and K1 at the final packed
    width held against its plain version and timed beside it and its
    bound (the table's K1-pruned row);
21. recovery on the card: phase 20's pruned run journaled
    (``RecoverableTuningService``), checkpointed after tick 8, run to
    tick 16 and recovered into a fresh object: the replayed ticks launch
    K1 once each, and the packed columns, live sets, scores, rows, moment
    slabs and 32 verdicts are bitwise the uninterrupted run's (the
    snapshot's bytes, save and restore-plus-replay times printed); then
    the reference's kill-and-recover command tape in child processes on
    the card (a serving child SIGKILLs itself after command 19, a second
    recovers): decisions bitwise a golden child's;
22. bank sharding (``mesh=``) on the card, its meshes naming the one
    card more than once: the reference sharded test's drive (K = 11
    over 8 shards, 2 columns a shard, the last shards all padding;
    ragged chunks; point, exact, approx, distance-only and pruned, one
    column a shard) bitwise the unsharded runs, and each tick kernel on
    a 2- and a 1-column shard against its plain version; a mesh of one
    bitwise ``mesh=None``; phase 7's point, exact and distance-only
    runs on 4 shards, bitwise phase 7's (rows, moments, scores,
    earlies, 32 verdicts; every shard's folds equal), the tick kernel
    launched 4 times a dispatch, each run's median ms/tick beside phase
    7's and each shard's K1 timed beside the unsharded K1; the point
    schedule on an unsharded and a 4-shard service side by side, ticks
    interleaved, each tick's and dispatch's host time; the point run
    rescaled 4 -> None -> 2 mid-run, and its 4-shard snapshot restored
    onto None and onto 2 shards, all bitwise phase 7's; phase 20's
    pruned run on 4 shards, bitwise phase 20's record.
23. model serving on the card (``repro_torch.models``, ``serve.engine``):
    first K9 and K10 against their plain versions at the shapes the
    model path gives them; then zamba2-7b at full width and depth (81
    layers, random bf16 weights from a seeded generator) serving 4
    prompts of 4096 tokens for 32 new tokens through
    ``ServeEngine.generate``: K9 launched 13 times and K10 68 times, all
    in the prefill, none in a decode step; the prefill's last logits
    against ``forward``'s at S - 1 and the first decode step's against
    ``forward`` over S + 1 tokens at S (MODEL_BF16_REL); the prefill's
    ms and tokens/s, the decode's median ms a step, K9's and K10's
    share of the prefill and the peak memory.  granite-20b at full width
    cut to 8 layers the same way (2 prompts, 16 new tokens, K9 8 times
    a prefill).  Last the card held to the CPU in float32: zamba2 (one
    period, 6 layers) and granite (2 layers) at full width, one prompt
    of 320 tokens: prefill logits, every cache and three decode steps
    of the same weights on the card (K9 f32, K10) and on the CPU (the
    plain versions) within MODEL_F32_RTOL / MODEL_F32_ATOL.
24. MoE/MLA serving on the card (``models.attention.MLAttention``,
    ``models.moe``): (a) K9 at MLA's head (q and k 192 wide, v 128: bf16
    on ``flash_mla_kernel``, f32 on ``flash_tf32_mla_kernel``, both
    warp-specialized and persistent) against its plain version at
    deepseek-v2's (B 4, 128 heads, S 4096) and kimi-k2's (B 2, 64 heads)
    bf16 prefill shapes and at deepseek's f32 one (S 384), one launch
    each, timed beside the plain version, the bound and SDPA, with the
    persistent blocks' share of the causal kv tiles; the f32 kernel also
    at MLA_F32_EDGES (S != T both ways, S = T = 96, a GQA group of 2,
    non-causal, dh 130 / dv 10 on the element-wise loads, q, k and v one
    element into their storage) within ATTN_F32_TOL, one launch each;
    (b) deepseek-v2-236b at full width cut to 5 layers (1 dense + 4 MoE,
    random bf16 weights) serving 4 prompts of 4096 tokens for 32 new
    tokens through ``ServeEngine.generate``: K9 5 times a prefill, 0 a
    decode step; prefill and decode held to ``forward`` (MODEL_BF16_REL)
    on the batch rows where both compute the same function; each MoE
    layer's dropped assignments and the decode step's routing against
    forward's; prefill and decode timed and traced, the peak memory;
    (c) kimi-k2-1t-a32b cut to 2 layers (1 dense + 1 MoE), 2 x 4096 + 16,
    K9 2 times a prefill, the same checks; (d) deepseek-v2 cut to 2
    layers in float32, card against CPU (K9 f32 2 times): logits and
    caches within MODEL_F32_RTOL / _ATOL, the routing equal in every MoE
    call but at near-ties within ROUTE_TIE (each witnessed); (e) one
    deepseek MoE layer run twice on the same input on the card, bitwise
    equal, timed at the prefill's and a decode step's token counts, and
    at each making no host sync (``host_syncs``); (f) that block's
    experts mapped over a (2, 4) (data, model) mesh of cuda:0 by EP and
    by expert-TP, bf16 and f32, at the dropless capacity factor 8.0:
    each expert shard's routing the unmapped block's (near-ties
    witnessed), no drop on either path, outputs within MOE_MAPPED_REL of
    the unmapped block's, two calls bitwise, no host sync, timed beside
    the unmapped block with the memory each allocates; (g) (b)'s model
    served on that mesh: the 4 x 4096 prefill through
    ``make_prefill_step(mesh=)`` in EP (K9 5) and 32 decode steps
    through ``make_decode_step(mesh=)`` under expert-TP, timed with the
    peak memory beside (b)'s; then mapped against unmapped at capacity
    factor 8.0 on 4 x 1024 tokens, no drop on either path, prefill and
    two decode steps' logits within MODEL_BF16_REL.
25. xLSTM serving on the card (``models.ssm.MLSTM``, ``SLSTM``): (a) K10
    on mLSTM's 1024-wide heads at xlstm-1p3b's prefill shape (B 4, H 4,
    S 4096, chunk 256, bf16) as a layer runs it: the numerator and the
    normalizer as one scan of 1025 value columns through
    ``kernels.gla.gla_scan``, which takes them whole on the wide route
    (``gla_wide_scores_kernel``, then ``gla_wide_kernel``: 2 launches,
    counted as K10-mlstm) against the undivided plain version; beside it
    the blocked route it replaces (``gla_blocked``: 8 launches on
    128-wide blocks with float32 partial outputs, and 1 for the
    normalizer), held the same way and in f32, a state block bitwise one
    K10 launch on its own blocks; both timed beside the plain version,
    the un-blocked scan's bound and the look-back's state-traffic floor;
    the zero-state term a prefill from an empty cache adds, timed; (b)
    the sLSTM scan kernel at
    full width (B 4, S 4096, D 2048; bf16 and f32 zifo) against its plain
    version (bitwise expected; a difference witnessed, within SLSTM_TOL),
    timed beside its byte bound, then at SLSTM_EDGES from a nonzero state
    (S 1, 7 and 129, B D off the 64-channel block, blocks that cannot
    stage their gates), each held the same way with its count of
    differing elements, and one S = 1 launch at the decode shape timed
    on the device beside the kernel's before the redesign; (c)
    xlstm-1p3b at full width and depth
    (48 layers, random bf16 weights) serving 4 prompts of 4096 tokens for
    32 new tokens through ``ServeEngine.generate``: the wide route's two
    kernels once each an mLSTM layer (K10-mlstm 84) and the sLSTM scan 6
    times a prefill, the sLSTM scan 6 times a decode step;
    prefill and decode held to ``forward`` (MODEL_BF16_REL), timed and
    traced (GEMMs, K10, the sLSTM scan, the zero-state product, the
    rest), the peak memory; (d) xlstm cut to one period (7 mLSTM + 1
    sLSTM) in float32, card against CPU (K10 63 on 128-wide blocks, the
    sLSTM scan 4 times):
    logits and caches within MODEL_F32_RTOL / _ATOL.
26. workload signatures (``core.signatures``, ``core.tuner``), the path
    of ``benchmarks/bench_autotune.py`` on the port: (a) all ten archs
    built on the ``meta`` device at their published configs, each
    one's ``loss_fn`` at 4 x 512 tokens walked by ``OpWalker`` (op
    count, seconds, total flops and bytes printed), every count set to
    0 just before and read just after: no kernel launched, no plain
    version called, each K9, K10 and sLSTM-scan call one operation;
    (b) at the reference's chip spec and at the H100's, the six
    profiled archs' 2048-sample series in a ``ReferenceDB`` and
    kimi-k2 matched by ``AutoTuner(device="cuda")`` at band 32,
    threshold 0.85: one K2 launch a match, the decision and config the
    CPU tuner's on the same series, every score within SIG_TOL; at the
    reference's spec the reference's decision (bench_autotune's golden
    assertions): deepseek-v2 matched at corr >= 0.85, phi3 more than 0.1
    below it, deepseek-v2's config transferred; (c) K2
    against its plain version at the match's length (references of
    1-2049 samples, queries of 0-2048, band 32 and None, dyadic and
    smooth data), then timed at the match's shape (2048 x 2048, 6
    references, band 32) beside the plain version and its bound, and
    the match timed.
27. training on the card (``train.step``, ``launch.train``): (a) K9
    f32's backward kernel (``flash_f32_bwd.cu``: split TF32 on ``wgmma``,
    HGMMA counted in its SASS) against
    ``flash_backward_plain`` on K9_BWD_CASES (minitron-4b's layer, B 1,
    H 24, KV 8, S 4096, dh 128; the 100M LM's, B 8, H 12, KV 6, S 256,
    dh 64; S != T both ways, non-causal, dh 96, dh 18 / dv 10 on the
    element-wise loads, inputs one element into their storage) within
    K9_BWD_REL of max |plain|, two launches bitwise; the forward's o
    bitwise with and without its lse, the lse within K9_LSE_TOL of the
    plain version's; S = 200 through ``models.attention._flash`` (padded
    to 256) card against CPU; the two layers timed beside the plain
    version, SDPA's backward and the bound; (b) minitron-4b at full
    width in float32 cut to 8 layers (remat "full", its ``train_4k``
    exec) trained 3 steps on 1 x 4096 tokens: K9 f32 16 and its backward
    8 launches a step, ms a step, tokens/s, peak memory, losses and grad
    norms, one step traced (GEMMs, K9 forward, K9 backward, the rest);
    (c) the 100M LM cut to 2 layers, card against CPU from the same
    weights (first gradients, two steps: TRAIN_LOSS_REL, TRAIN_GRAD_REL,
    TRAIN_PARAM_ATOL); (d) ``python -m repro_torch.launch.train --steps
    60 --ckpt-every 30 --tuner-db ...``: exit 0 with a falling loss, a
    ``--resume`` from step 30 on the same parameters within 1e-6 (bitwise
    or not, printed), the DB holding the run's signature; ((e), what
    raises without a backward kernel, is phase 29 (d));
    (f) sharded training on SHARD_MESH of the one card
    (``make_train_step(mesh=, shard=make_shard_fn(...))``): minitron-4b
    (8 layers, full width, float32, remat "full") on 2 x 4096 tokens, a
    data shard 1 x 4096, against the one-device step with ``microbatch``
    2 from the same weights (loss and ce SHARD_LOSS_REL, each gradient
    leaf SHARD_GRAD_REL of its largest, every parameter within
    SHARD_RTOL / SHARD_ATOL), K9 f32 32
    and its backward 16 launches a step on both, no plain call, no host
    sync, peak memory within SHARD_PEAK_GB of the one-device step's, ms
    a step (median of 4) beside it; then deepseek-v2's MoE block at full
    width in float32, forward and backward mapped over SHARD_MESH by EP
    against the unmapped block at MOE_DROPLESS_CF on SHARD_MOE_TOKENS
    (every gradient within SHARD_MOE_GRAD_REL of its largest, no drop on
    either path, two mapped runs bitwise, ms and peak memory of each).
    Besides, for the Mamba2 and MLA archs: (a) K9 f32's backward at
    MLA's head (``flash_f32_bwd_mla.cu``, split TF32 on ``wgmma`` at
    16-row steps, HGMMA asserted in its SASS) against
    ``flash_backward_plain`` on K9_MLA_BWD_CASES (deepseek-v2's layer, B
    1, H = KV = 128, S 4096, dh 192 / dv 128; kimi-k2's, 64 heads; S
    328, not whole tiles; non-causal with S < T and G 2; dh 130 / dv 66
    on element-wise loads; one element into storage) and K10 f32's
    backward (``gla_bwd.cu``, split TF32 on ``wgmma``, HGMMA asserted)
    against
    ``gla_chunks_backward_plain`` on K10_BWD_CASES (zamba2-7b's layer, B
    1, 112 heads, S 4096, dk = dv = 64, chunk 256; dk = dv = 128 at chunk
    64; chunk 24; one chunk; gradients of the final state), each within
    K9_BWD_REL / K10_BWD_REL of max |plain| per gradient and bitwise
    across two launches (the MLA forward's o bitwise with and without
    its lse), S = 1000 through ``models.ssm.gla_chunked`` card against
    CPU, zamba2's shared attention (dh 112) in K9_BWD_CASES, the two
    layers timed beside the plain version and the bound (K9's beside
    SDPA's backward), and K9 f32's forward with its lse at the three
    training layers (minitron-4b's, zamba2-7b's shared attention,
    deepseek-v2's) and K10 f32's forward at zamba2's, beside their bounds
    (and SDPA's f32 forward for K9); (b) zamba2-7b (12 of 81 layers: the pattern
    twice) and deepseek-v2 (its first, dense layer) at full width in
    float32 trained 3 steps on 1 x 4096 tokens (their ``train_4k``
    execs, remat "full"), each step's launches asserted (K10 2 and its
    backward 1 a Mamba2 layer, K9 f32 2 and a backward 1 an attention
    layer or shared-attention occurrence), one step traced; (c) both at
    full width cut to 6 and 1 layers, card against CPU on 1 x 512 and 1
    x 128 tokens, one step (TRAIN_*).
    Besides, for xlstm-1p3b: (a) the sLSTM scan's backward
    (``slstm_bwd.cu``: a scan over chunks of 64 steps of its affine
    adjoint, from the forward's records: the chunks' maps, their carries,
    the replay, r's gradient; four kernels a call, counted as one launch)
    against ``slstm_scan_backward_plain`` on SLSTM_BWD_CASES (xlstm's
    training layer, B 1, S 4096, D 2048; its prefill shape, B 4, from the
    zero state and from a nonzero one with final-state gradients; S 1, 7,
    65 and 129; D off the 128-channel block; a nonzero initial state;
    the final state's gradients; dyadic ties at n == 1 and f + m == i),
    bitwise expected, any difference witnessed and within SLSTM_BWD_REL,
    two launches bitwise, the forward's hs and final state bitwise with
    and without its records; the training layer and the prefill shape
    timed beside the plain backward and the bound, each phase alone
    besides; K10 f32's backward at xlstm's blocked shapes in
    K10_BWD_CASES (32 heads of 128, chunk 256, dv 128 and 1); (b)
    xlstm-1p3b at full width cut to 8 layers (one period: 7 mLSTM, 1
    sLSTM) trained 3 f32 steps on 1 x 4096 tokens (``train_4k``, remat
    "full"): K10 18 and its backward 9 an mLSTM layer (9 value blocks),
    the sLSTM scan 2 and its backward 1 an sLSTM layer (one call of its
    four kernels), one step traced; (c) the same 8 layers card against
    CPU on 1 x 512 tokens, one step (TRAIN_*; a leaf's first gradients
    within TRAIN_NOISE_X times the two sides' own change under a
    one-rounding weight perturbation where that exceeds TRAIN_GRAD_REL);
    (d) ``--arch xlstm-1p3b --smoke --steps 10`` exits 0 with finite
    losses;
28. the dry-run (``launch.dryrun``) against phase 27: minitron-4b's
    phase-27 train step (8 of 32 layers, float32, remat "full") built on
    ``meta`` and walked on a 1 x 1 mesh, at 1 x 4096 and at
    ``microbatch=2`` on 2 x 4096: the walk's K9 and K9_bwd op counts
    equal to the K9 f32 and backward launches phase 27 counted on the
    card for the same steps (16 / 8, 32 / 16); the walk's largest
    roofline term printed against phase 27's measured ms a step, and its
    argument + temp bytes against the measured peak (ratios recorded,
    not checked).  Host work only; the step is not run again.
29. bfloat16 training on the card: (a) K9 bf16's backward kernels
    (``flash_bf16_bwd.cu`` at dh, dv <= 128, ``flash_bf16_bwd_mla.cu`` at
    MLA's head; warp-specialized, TMA producers and ``wgmma`` consumers:
    HGMMA and UTMALDG asserted in their SASS, no wgmma pipeline
    serialized by ptxas; registers, spills and each kernel's device time
    at the two training layers printed) against
    ``flash_backward_plain`` on K9_BF16_BWD_CASES (minitron-4b's,
    deepseek-v2's MLA, phi3-mini's (dh 96), zamba2-7b's shared
    attention (dh 112), the 100M LM's and kimi-k2's layers; S != T both
    ways, non-causal, element-wise loads, inputs one element into their
    storage, at both heads), each gradient element within one bf16
    rounding of the plain element plus K9_BF16_BWD_REL of max |plain|,
    two launches bitwise, the bf16 forward's o bitwise with and without
    its lse, the lse within K9_BF16_LSE_TOL of the plain version's; the
    six training layers timed beside the plain version, SDPA's bf16
    backward, SDPA's bf16 forward and the bound; (b) minitron-4b (8
    layers) and deepseek-v2 (its dense layer) at full width in bfloat16
    (``train_4k``, remat "full") trained 3 steps on 1 x 4096 tokens: K9
    bf16 forward 2 and its backward 1 an attention layer, no float32 K9
    launch, no plain call, ms a step, tokens/s and peak beside phase
    27's float32 step, one step traced; (c) both card against CPU in
    bfloat16 (2 layers on 1 x 512 tokens, 1 layer on 1 x 128), the first
    batch's loss and gradients held by TRAIN_NOISE_X times the two sides'
    own change under a one-rounding (2^-8) weight perturbation; (d) what
    still raises NotImplementedError without a backward kernel, launching
    nothing and calling no plain version: zamba2-7b's bf16 SMOKE train
    step (K10's backward) and a bf16 sLSTM scan with a gradient.

It prints the kernel table as one JSON line (K9's, K9 f32's and K10's
rows with their launches on phases 23-25's model paths besides, K2's
with its launches on phase 26's matches, K9's two rows at MLA's head,
K10's row on mLSTM's whole heads, the sLSTM scan's and K9 f32's
backward's, with its launches on phase 27's minitron-4b step and its
sharded step (K9 f32's forward row too), and the
backwards of K9 f32 at MLA's head and of K10 f32 with theirs on phase
27's deepseek-v2 and zamba2-7b steps, the sLSTM scan's backward
with its launches on phase 27's xlstm-1p3b step, and K9 bf16's two
backwards with theirs on phase 29's bf16 steps), the
card's name
and power limit, and last ``{"ok": true, "device": {...}}``.  It needs
no network and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings
from fractions import Fraction

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: Tolerances of the kernel-vs-plain checks.  Both sides do the same
#: IEEE float32 operations per cell (the kernels are built without FMA
#: contraction), so every DP check is expected to be exact; the
#: smooth-data tolerance only allows for a rounding difference in the
#: score tail.
DYADIC_TOL = 0.0
SMOOTH_TOL = 1e-5
#: Probabilities: the kernels' erfcf and the plain version's float64
#: erfc differ in the last bits; the tail's other operations are the
#: same in the same order.
PROB_TOL = 2e-6

#: Table 1 against tests/golden/table1_similarity.json: the reference's
#: own golden tolerance (tests/test_paper_table1_golden.py).
TABLE1_TOL = 2e-3
#: Matrix path against the matrix-free scorer on smooth data: the
#: reference's warp-path-tie tolerance (tests/test_scored_matching.py).
MATRIX_FREE_TOL = 5e-3
#: OnlineMatcher.final_scores (one-pass float64 moments along the
#: backtracked path) against the matrix path's two-pass float64
#: correlation of the same path: the two formulas round differently.
FINAL_TOL = 1e-9

#: K8 against its plain version and the float64 oracle: the reference's
#: tolerance for the order-6 filter (tests/test_kernels.py).  The two
#: versions are expected bitwise but for the plain version's double
#: rounding of its fused multiply-adds, which is counted.
IIR_TOL = 5e-3
#: Both versions against the float64 oracle over the full width's 3600
#: samples: float32 arithmetic on this ill-conditioned filter drifts from
#: the exact recurrence by up to ~6e-3 over that length (on the CPU, the
#: reference's recurrence bitwise alike), beyond IIR_TOL, which the
#: reference set on series of 64 to 512 samples.
IIR_ORACLE_TOL = 1e-2
#: One bfloat16 step, relative: a bfloat16 output may round to the other
#: side of a step where the float32 sums differ in their last bit.
BF16_ULP = 2.0 ** -7
#: K9 against its plain version: the reference's tolerances
#: (tests/test_kernels.py), float32 and bfloat16.  The reference set the
#: bfloat16 one at S <= 256, where |o| is ~0.2; at S = 4096 a typical |o|
#: is ~0.03, below it, so a bfloat16 output is also held within one
#: bfloat16 step (BF16_ULP relative) plus ATTN_F32_TOL of the plain
#: version's, and the same inputs in float32 within ATTN_F32_TOL.
ATTN_F32_TOL = 1e-5
ATTN_BF16_TOL = 5e-2
#: K10 against its plain version: the reference's kernel-against-model-
#: path tolerance (tests/test_kernels.py); a bfloat16 output within one
#: bfloat16 step besides.
GLA_RTOL, GLA_ATOL = 1e-4, 1e-5

#: Phase 23, bf16 at full width: the prefill's last logits against
#: ``forward``'s at S - 1, and the first decode step's against ``forward``
#: over S + 1 tokens at S, held to max |a - b| <= MODEL_BF16_REL max |b|.
#: The two sides take different bf16 roundings (the decode's plain
#: attention rounds its scores to bf16, K9 keeps them in float32; the
#: GEMMs differ in shape), which grow over depth: zamba2's 81 layers in
#: bf16 on the CPU (width cut to 512, S = 300, the plain versions) gave
#: 0.024, granite's 8 layers 0.009; a wrong cache, offset or state would
#: give O(1).  Stated before phase 23's first run.
MODEL_BF16_REL = 0.1
#: Phase 23, float32: the card (K9 f32 as split TF32, K10 f32, cuBLAS
#: without TF32) against the CPU (the plain versions) on the same
#: weights, for logits and caches: |a - b| <= ATOL + RTOL |b|.  Each side
#: sums in its own order (relative ~1e-6 a product); six layers at full
#: width, |logits| ~ 1.  Stated before phase 23's first run.
MODEL_F32_RTOL, MODEL_F32_ATOL = 1e-3, 1e-3
#: Phase 24, float32 card vs CPU: a token's chosen experts may differ
#: only where the CPU's router probabilities at the first differing rank
#: and the next lie within ROUTE_TIE of each other (a near-tie that the
#: two sides' summation orders may break either way).  Stated before
#: phase 24's first run.
ROUTE_TIE = 1e-6
#: Phase 24 (f), (g): the (data, model) mesh the MoE layers' experts are
#: mapped over (the reference's test mesh), every shard on the one card.
MOE_MESH = (2, 4)
#: Phase 24 (f), (g): the capacity factor at which the mapped and the
#: unmapped MoE are compared: the reference's own dropless EP test's
#: (tests/test_multidevice.py).  An EP shard takes its capacity from its
#: own tokens, so where an expert overflows the two paths would drop
#: different assignments; both paths' drops are counted and must be 0.
MOE_DROPLESS_CF = 8.0
#: Phase 24 (f): the mapped block's output against the unmapped block's,
#: max |mapped - unmapped| <= REL x max |unmapped| by dtype.  The mapped
#: combine rounds each shard's partial sum (and under expert-TP each
#: FFN half's) before the sum over shards, so at top 6 the two differ by
#: a few roundings in x's dtype (a CPU run of the same block at d_model
#: 1024: bf16 0.0045, f32 1.4e-7).  Stated before (f)'s first run.
MOE_MAPPED_REL = {torch.bfloat16: 2.0 ** -5, torch.float32: 1e-5}
#: Phase 24 (f): an EP shard routes its own rows (a router product of
#: another row count, which cuBLAS may sum in another order), so a
#: token's experts may differ from the unmapped block's only at a
#: near-tie: the unmapped probabilities at the first differing rank and
#: the next within ROUTE_TIE (f32) or within this share of the larger
#: (bf16: a bf16 logit's rounding step at |logit| ~4).  Each such token
#: is printed and left out of the output check.  Stated before (f)'s
#: first run.
MOE_ROUTE_TIE_BF16 = 2.0 ** -5
#: Phase 24 (g): the prompt length of the mapped-against-unmapped check
#: at MOE_DROPLESS_CF (the unmapped expert buffer there holds [160, C,
#: D] with C = 0.3 T: 2 GB at 4 x 1024 tokens).
MOE_MAPPED_S = 1024

#: The earlier designs' times of K7, K9 f32, K8 and K10 (ms; PERF.md's
#: kernel table, NVIDIA H100 80GB HBM3, 700.00 W; CUDA-event means): K7's
#: full matrix (K=256, N=384, M=360), one resumed 16-row chunk and the
#: last row only; K9 f32 at granite's layer; K8 at the 8192 x 3600
#: de-noise and K10 at zamba2's scan (PR 18's call J).  Printed beside
#: this run's times.
PARENT_MS = {"K7": 0.8538, "K7-chunk": 0.0667, "K7-last": 0.2104,
             "K9-f32": 8.0395, "K8": 0.2960, "K10": 2.4236}

#: Early-decision fractions of the reference on the paper scenario
#: (BENCH_streaming.json rows stream_early_p0..p3).
REF_EARLY = (0.44, 0.50, 0.47, 0.75)

#: f32 arithmetic and compare operations per DP cell in csrc/dtw_sweep.cuh
#: for NCH moment channels (cost: sub, abs; recurrence: 3 min, add;
#: selection: min, 2 compares; moments: 2 adds a channel, 2 muls a
#: product channel), selects not counted: 17, 21, 29 for 3, 4, 6.
def ops_per_cell(nch: int) -> int:
    return 5 + 4 * nch


def dtw_op_rate(name: str) -> float:
    """f32 operations a second for the DTW cells (``ops_per_cell``): the
    kernels are built with ``-fmad=false`` and a cell has no fused
    multiply-add, so each add, multiply, min and compare is one
    instruction a lane, half ``card_peaks``' FMA-counted f32 rate."""
    return card_peaks(name)[1] / 2


#: The kernels of the table, in order, with their sources and the TPU
#: kernel each replaces.
_DTW = "src/repro_torch/kernels/dtw/csrc/"
KERNELS = {
    "K1": ("K1 scored streaming tick", _DTW + "stream.cu",
           "src/repro/kernels/dtw/stream.py:136"),
    "K1-pruned": ("K1 scored streaming tick on the prefilter's packed bank",
                  _DTW + "stream.cu", "src/repro/kernels/dtw/stream.py:136"),
    "K2": ("K2 verdict scorer", _DTW + "score.cu",
           "src/repro/kernels/dtw/score.py:42"),
    "K3": ("K3 distance-only streaming tick", _DTW + "stream.cu",
           "src/repro/kernels/dtw/stream.py:82"),
    "K4-exact": ("K4 probabilistic tick, 6 channels (exact)",
                 _DTW + "stream.cu", "src/repro/kernels/dtw/stream.py:136"),
    "K4-approx": ("K4 probabilistic tick, 4 channels (approx)",
                  _DTW + "stream.cu", "src/repro/kernels/dtw/stream.py:136"),
    "K5": ("K5 exact probabilistic verdict scorer", _DTW + "score.cu",
           "src/repro/kernels/dtw/score.py:179"),
    "K6": ("K6 approx probabilistic verdict scorer", _DTW + "score.cu",
           "src/repro/kernels/dtw/score.py:179"),
    "K7": ("K7 DTW accumulated-cost matrix", _DTW + "matrix.cu",
           "src/repro/kernels/dtw/kernel.py:54"),
    "K2-pairs": ("K2 pairs verdict scorer", _DTW + "score.cu",
                 "src/repro/kernels/dtw/score.py:42"),
    "K8": ("K8 batched IIR filter",
           "src/repro_torch/kernels/iir/csrc/iir.cu",
           "src/repro/kernels/iir/kernel.py:26"),
    "K9": ("K9 causal GQA flash attention, bf16 (wgmma)",
           "src/repro_torch/kernels/attention/csrc/flash_wgmma.cu",
           "src/repro/kernels/attention/kernel.py:26"),
    "K9-f32": ("K9 causal GQA flash attention, f32 (split TF32, wgmma)",
               "src/repro_torch/kernels/attention/csrc/flash_tf32.cu",
               "src/repro/kernels/attention/kernel.py:26"),
    "K9-mla": ("K9 causal flash attention at MLA's head (dh 192, dv 128), "
               "bf16 (flash_mla_kernel: TMA producer, two wgmma consumers, "
               "persistent)",
               "src/repro_torch/kernels/attention/csrc/flash_wgmma.cu",
               "src/repro/kernels/attention/kernel.py:26"),
    "K9-f32-mla": ("K9 causal flash attention at MLA's head (dh 192, dv "
                   "128), f32 (split TF32, wgmma; flash_tf32_mla_kernel: "
                   "TMA producer splitting the parts, one wgmma consumer, "
                   "persistent)",
                   "src/repro_torch/kernels/attention/csrc/flash_tf32.cu",
                   "src/repro/kernels/attention/kernel.py:26"),
    "K9-f32-bwd": ("K9 f32 backward (dq, dk, dv; split TF32, wgmma; "
                   "not a TPU kernel: the reference differentiates jnp "
                   "attention)",
                   "src/repro_torch/kernels/attention/csrc/flash_f32_bwd.cu",
                   "src/repro/models/attention.py:121 (jax.grad of jnp "
                   "attention; no Pallas kernel)"),
    "K9-f32-mla-bwd": ("K9 f32 backward at MLA's head (dh 192, dv 128; "
                       "dq, dk, dv; split TF32, wgmma, 16-row steps; not a "
                       "TPU kernel: the reference differentiates jnp "
                       "attention under MLA)",
                       "src/repro_torch/kernels/attention/csrc/"
                       "flash_f32_bwd_mla.cu",
                       "src/repro/models/attention.py:229 (jax.grad of jnp "
                       "attention in mla_apply; no Pallas kernel)"),
    "K9-bf16-bwd": ("K9 bf16 backward (dq, dk, dv; warp-specialized, TMA "
                    "producers and wgmma consumers, P and dS in two bf16 "
                    "parts; not a TPU kernel: the reference "
                    "differentiates jnp attention)",
                    "src/repro_torch/kernels/attention/csrc/"
                    "flash_bf16_bwd.cu",
                    "src/repro/models/attention.py:121 (jax.grad of jnp "
                    "attention; no Pallas kernel)"),
    "K9-bf16-mla-bwd": ("K9 bf16 backward at MLA's head (dh 192, dv 128; "
                        "dq, dk, dv; warp-specialized, TMA producers and "
                        "wgmma consumers, no zero-padded product, P and dS "
                        "in two bf16 parts; not a TPU kernel: the "
                        "reference differentiates jnp attention under "
                        "MLA)",
                        "src/repro_torch/kernels/attention/csrc/"
                        "flash_bf16_bwd_mla.cu",
                        "src/repro/models/attention.py:229 (jax.grad of "
                        "jnp attention in mla_apply; no Pallas kernel)"),
    "K10": ("K10 chunked GLA scan",
            "src/repro_torch/kernels/gla/csrc/gla.cu",
            "src/repro/kernels/gla/kernel.py:22"),
    "K10-mlstm": ("K10 on mLSTM's 1024-wide heads, whole, bf16 "
                  "(gla_wide_scores_kernel, then gla_wide_kernel)",
                  "src/repro_torch/kernels/gla/csrc/gla.cu",
                  "src/repro/kernels/gla/kernel.py:22"),
    "K10-f32-bwd": ("K10 f32 backward (dq, dk, dv, dg; split TF32, "
                    "wgmma; not a TPU kernel: the reference differentiates "
                    "its jnp chunked scan)",
                    "src/repro_torch/kernels/gla/csrc/gla_bwd.cu",
                    "src/repro/models/ssm.py:44 (jax.grad of jnp "
                    "gla_chunked; no Pallas kernel)"),
    "sLSTM": ("sLSTM scan (jnp lax.scan in the reference, not a Pallas "
              "kernel)", "src/repro_torch/kernels/slstm/csrc/slstm.cu",
              "src/repro/models/ssm.py:329"),
    "sLSTM-bwd": ("sLSTM scan backward, f32 (dzifo, dr, the initial "
                  "state's gradients; not a TPU kernel: the reference "
                  "differentiates its jnp scan)",
                  "src/repro_torch/kernels/slstm/csrc/slstm_bwd.cu",
                  "src/repro/models/ssm.py:329 (jax.grad of slstm_apply's "
                  "jnp lax.scan; no Pallas kernel)"),
}


def band_cells(qlens, rlens, band) -> int:
    """DP cells inside the Sakoe-Chiba band, summed over (query,
    reference) pairs of true lengths ``qlens[p]`` x ``rlens[p]`` (every
    cell with ``band`` None); row i of a pair is centred on column
    i * (rlen - 1) // max(qlen - 1, 1), as in the kernels."""
    total = 0
    for q, r in zip(np.asarray(qlens).tolist(), np.asarray(rlens).tolist()):
        if band is None:
            total += q * r
            continue
        centre = np.arange(q) * (r - 1) // max(q - 1, 1)
        lo = np.maximum(centre - band, 0)
        hi = np.minimum(centre + band, r - 1)
        total += int(np.maximum(hi - lo + 1, 0).sum())
    return total


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def card_peaks(name: str):
    """(memory bytes/s, f32 FLOP/s, dense bf16 and dense TF32 tensor-core
    FLOP/s) of the named card (NVIDIA data sheets; the SXM part's figures
    for an unrecognised H100)."""
    if "PCIe" in name:
        return 2.0e12, 51.2e12, 756e12, 378e12
    if "NVL" in name:
        return 3.9e12, 60.0e12, 835e12, 417.5e12
    return 3.35e12, 67.0e12, 989e12, 494.7e12


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (after one warm-up
    call), from CUDA events."""
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


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn`` without the host's launch path:
    ``reps`` calls captured in one CUDA graph (after one warm-up call),
    a replay timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, kernel: str):
    """Mean device time of one launch of the CUDA kernel whose name holds
    ``kernel`` over ``reps`` calls of ``fn`` (after one warm-up call),
    from ``torch.profiler``'s kernel records: the kernel alone, without
    the host's launch path that back-to-back calls timed by ``cuda_ms``
    include.  Returns (ms, launches recorded), or (None, 0) when the
    profiler recorded no such kernel in two tries (a session on the H100
    has come back without the kernels' records, or short of some)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for ev in prof.key_averages():
            if kernel in ev.key:
                t = getattr(ev, "self_device_time_total", None)
                us += ev.self_cuda_time_total if t is None else t
                n += ev.count
        if n and us > 0:
            return us / n / 1e3, n
    return None, 0


def _dev_str(dev_ms) -> str:
    ms, n = dev_ms
    return "not measured (no kernel record)" if ms is None \
        else f"{ms:.4f} ms ({n} launches)"


def counts() -> dict:
    """Every kernel's launch count, by table key."""
    from repro_torch.kernels import attention, gla, iir, slstm
    from repro_torch.kernels.dtw import matrix, score, stream
    return {"K1": stream.LIB.launches, "K2": score.LIB.launches,
            "K3": stream.DIST_LAUNCHES,
            "K4-exact": stream.VAR_LAUNCHES[6],
            "K4-approx": stream.VAR_LAUNCHES[4],
            "K5": score.VAR_LAUNCHES[6], "K6": score.VAR_LAUNCHES[4],
            "K7": matrix.LIB.launches, "K2-pairs": score.PAIRS_LAUNCHES,
            "K8": iir.kernel.LIB.launches,
            "K9": attention.kernel.BF16_LIB.launches,
            "K9-f32": attention.kernel.LIB.launches,
            "K9-f32-bwd": attention.kernel.BWD_LIB.launches,
            "K9-f32-mla-bwd": attention.kernel.BWD_MLA_LIB.launches,
            "K9-bf16-bwd": attention.kernel.BF16_BWD_LIB.launches,
            "K9-bf16-mla-bwd": attention.kernel.BF16_BWD_MLA_LIB.launches,
            "K10": gla.kernel.LIB.launches,
            "K10-f32-bwd": gla.kernel.BWD_LIB.launches,
            "K10-mlstm": gla.kernel.WIDE_LAUNCHES,
            "sLSTM": slstm.kernel.LIB.launches,
            "sLSTM-bwd": slstm.kernel.BWD_LIB.launches}


def reset_counts() -> None:
    from repro_torch.kernels import attention, gla, iir, slstm
    from repro_torch.kernels.dtw import matrix, score, stream
    stream.LIB.launches = score.LIB.launches = matrix.LIB.launches = 0
    iir.kernel.LIB.launches = attention.kernel.LIB.launches = 0
    attention.kernel.BF16_LIB.launches = 0
    attention.kernel.BWD_LIB.launches = 0
    attention.kernel.BWD_MLA_LIB.launches = 0
    attention.kernel.BF16_BWD_LIB.launches = 0
    attention.kernel.BF16_BWD_MLA_LIB.launches = 0
    gla.kernel.LIB.launches = slstm.kernel.LIB.launches = 0
    gla.kernel.BWD_LIB.launches = slstm.kernel.BWD_LIB.launches = 0
    gla.kernel.WIDE_LAUNCHES = 0
    stream.DIST_LAUNCHES = score.PAIRS_LAUNCHES = 0
    for d in (stream.VAR_LAUNCHES, score.VAR_LAUNCHES):
        for key in d:
            d[key] = 0


def launched(before: dict, **want) -> None:
    """Raise unless exactly the named kernels launched the named number
    of times since ``before``."""
    now = counts()
    got = {key: now[key] - before[key] for key in now}
    exp = {key: want.get(key.replace("-", "_"), 0) for key in now}
    assert got == exp, f"launches {got} != expected {exp}"


class ErrLog:
    """Largest absolute kernel-vs-plain difference seen per kernel."""

    def __init__(self) -> None:
        self.err = {key: 0.0 for key in KERNELS}

    def diff(self, kernel: str, got: torch.Tensor, want: torch.Tensor,
             mask=None) -> float:
        g, w = got.double(), want.double()
        if mask is not None:
            g, w = g[mask], w[mask]
        e = float((g - w).abs().max()) if g.numel() else 0.0
        self.err[kernel] = max(self.err[kernel], e)
        return e


def _series(rng, n: int, dyadic: bool) -> np.ndarray:
    if dyadic:
        return (rng.integers(0, 9, n) / 8.0).astype(np.float32)
    t = np.linspace(0, 1, n)
    return np.clip(0.5 + 0.3 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
                   + 0.05 * rng.normal(size=n), 0, 1).astype(np.float32)


def _vars(rng, shape, dyadic: bool) -> np.ndarray:
    if dyadic:
        return (rng.integers(0, 5, shape) / 64.0).astype(np.float32)
    return (0.01 * rng.random(shape)).astype(np.float32)


def _bank(rng, k: int, lo: int, hi: int, dyadic: bool):
    from repro_torch.core.database import pack_series
    return pack_series([_series(rng, int(rng.integers(lo, hi + 1)), dyadic)
                        for _ in range(k)])


#: Reference lengths that the verdict scorers' wavefront treats apart
#: (32 lanes of up to 12 columns): one column, shorter than a strip, and
#: longer than one 384-column panel (two and three panels).
WAVEFRONT_LENGTHS = (1, 5, 11, 385, 500, 800, 1000)


def tick_cases():
    """The tick checks' cases (dyadic, band, chunk width C, bank size K):
    first C = 8, 16 and 32 (32 takes two 16-sample passes) at K = 133
    (not a multiple of a block), then chunks that do not fill the
    sweep's split of 16 rows over a group of threads (C = 1, 12 and 24)
    and banks of fewer references than a warp (K = 1 and 7)."""
    first = [(dy, band, c, 133) for dy in (True, False)
             for band in (None, 6) for c in (8, 16, 32)]
    edges = [(c, 133) for c in (1, 12, 24)] + [
        (c, k) for k in (1, 7) for c in (12, 16, 24)]
    return first + [(dy, band, c, k) for dy in (True, False)
                    for band in (None, 6) for c, k in edges]


def _bank_shapes(rng, k: int, dyadic: bool, panels: bool):
    """A ragged bank of k references of 10-60 samples; with ``panels``,
    its first references take WAVEFRONT_LENGTHS."""
    from repro_torch.core.database import pack_series
    lens = [int(rng.integers(10, 61)) for _ in range(k)]
    if panels:
        lens[:len(WAVEFRONT_LENGTHS)] = WAVEFRONT_LENGTHS
    return pack_series([_series(rng, n, dyadic) for n in lens])


_KERNEL_RE = re.compile(r"(stream_scored_kernel|score_pairs_kernel|"
                        r"score_kernel|dtw_matrix_kernel|iir_kernel|"
                        r"flash_tf32_kernel|flash_tf32_mla_kernel|"
                        r"flash_bwd_dot_kernel|flash_bwd_dkdv_kernel|"
                        r"flash_bwd_dq_kernel|flash_bwd_mla_dot_kernel|"
                        r"flash_bwd_mla_dkdv_kernel|flash_bwd_mla_dq_kernel|"
                        r"flash_bf16_bwd_dot_kernel|"
                        r"flash_bf16_bwd_dkdv_kernel|flash_bf16_bwd_dq_kernel|"
                        r"flash_wgmma_kernel|"
                        r"flash_mla_kernel|gla_wide_scores_kernel|"
                        r"gla_wide_kernel|"
                        r"gla_mma_kernel|gla_ws_kernel|gla_fma_kernel|"
                        r"gla_bwd_u_kernel|gla_bwd_scan_kernel|"
                        r"gla_bwd_dkdv_kernel|gla_bwd_dq_kernel|"
                        r"slstm_scan_kernel|slstm_bwd_map_kernel|"
                        r"slstm_bwd_carry_kernel|slstm_bwd_replay_kernel|"
                        r"slstm_bwd_dr_kernel)"
                        r"(?:I(.*?)EE)?")

def kernel_name(mangled: str):
    """A kernel's name with its template arguments (``Li6`` -> 6,
    ``fLi128`` -> f32,128, ``Lb1`` -> band) from a mangled symbol, or
    None for another symbol."""
    m = _KERNEL_RE.search(mangled)
    if not m:
        return None
    targs = (m.group(2) or "").replace("13__nv_bfloat16", "bf16,")
    targs = re.sub(r"^f(?=Li|$)", "f32,", targs)
    targs = re.sub(r"Lb([01])", lambda b: ("no band", "band")[
        int(b.group(1))], targs)
    targs = targs.replace("Li", "").replace("E", ",").rstrip(",")
    return m.group(1) + (f"<{targs}>" if targs else "")


def sass(lib) -> str:
    """The SASS of a built kernel library (``cuobjdump -sass``)."""
    from repro_torch.kernels import common
    tool = os.path.join(os.path.dirname(common._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", lib.path()], check=True,
                          capture_output=True, text=True,
                          timeout=120).stdout


def sass_functions(lib, kernel: str) -> dict:
    """Each instantiation of ``kernel`` in the SASS of a built library
    (``cuobjdump -sass``): {name: [(address, instruction), ...]}."""
    funcs, cur = {}, None
    for line in sass(lib).splitlines():
        if "Function :" in line:
            name = kernel_name(line.split("Function :", 1)[1].strip())
            cur = funcs.setdefault(name, []) if name and (
                name == kernel or name.startswith(kernel + "<")) else None
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def _opcode(text: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]


def sass_ops(lib, kernel: str, ops) -> dict:
    """{name: "N SASS, k OP, ..."} for each instantiation of ``kernel``:
    its instruction count and the count of each opcode prefix in
    ``ops``."""
    return {name: ", ".join([f"{len(ins)} SASS"] + [
        f"{sum(_opcode(t).startswith(op) for _, t in ins)} {op}"
        for op in ops]) for name, ins in sass_functions(lib, kernel).items()}


def sass_cell_loops(lib, kernel: str) -> dict:
    """The innermost loops of each instantiation of ``kernel`` in the
    SASS of a built library (``cuobjdump -sass``) that hold DP cells:
    {name: [(instructions, cells), ...]} in address order.  A loop is
    the span from a backward branch's target to the branch; its cells
    are its FMNMX instructions over 3 (``dp_cell``'s min(vert, horiz),
    min(diag, .) and the 3e38 clamp)."""
    loops = {}
    for name, ins in sass_functions(lib, kernel).items():
        spans = []
        for addr, text in ins:
            op = _opcode(text)
            hexes = re.findall(r"0x([0-9a-f]+)", text)
            if op.startswith("BRA") and hexes and int(hexes[-1], 16) < addr:
                spans.append((int(hexes[-1], 16), addr))
        inner = [a for a in spans if not any(
            b != a and a[0] <= b[0] and b[1] <= a[1] for b in spans)]
        found = []
        for lo, hi in sorted(inner):
            body = [t for a, t in ins if lo <= a <= hi]
            nmin = sum(re.search(r"\bFMNMX\b", t) is not None
                       for t in body)
            if nmin >= 3:
                found.append((len(body), nmin // 3))
        loops[name] = found
    return loops


def occupancy(regs: int, threads: int) -> int:
    """Resident warps an SM for a kernel of ``regs`` registers a thread
    in blocks of ``threads`` (65,536 registers an SM, allocated 256 a
    warp; at most 64 warps and 32 blocks; shared memory not counted: the
    sweep's 9-23 KB a block never sets the limit)."""
    per_warp = -(-regs * 32 // 256) * 256
    wpb = -(-threads // 32)
    blocks = min(65536 // (per_warp * wpb), 64 // wpb, 32)
    return blocks * wpb


def build_report(libs) -> None:
    """One line per kernel: its registers, stack and spills as ptxas -v
    reported them; for the ticks' sweep (``stream_scored_kernel``), also
    its resident warps an SM and the SASS instructions per cell of each
    of its cell loops; for K7 (``dtw_matrix_kernel``) and K9 f32
    (``flash_tf32_kernel``), its SASS instructions and the count of the
    opcodes that carry its work (K7: FMNMX, three a cell; shuffles;
    global stores; K9 f32: HGMMA), for K9 at MLA's head
    (``flash_mla_kernel``) its HGMMA, asynchronous copies (LDGSTS) and
    TMA loads (UTMALDG), for K9 f32 there (``flash_tf32_mla_kernel``)
    its HGMMA and UTMALDG, for K9 f32's backward
    (``flash_bwd_dkdv_kernel``, ``flash_bwd_dq_kernel``) and at MLA's
    head (``flash_bwd_mla_dkdv_kernel``, ``flash_bwd_mla_dq_kernel``)
    their HGMMA, for K9 bf16's backward (``flash_bf16_bwd_dkdv_kernel``,
    ``flash_bf16_bwd_dq_kernel``, at both heads) their HGMMA and TMA
    loads (UTMALDG), for K10 f32's
    backward (``gla_bwd_u_kernel``, ``gla_bwd_dkdv_kernel``,
    ``gla_bwd_dq_kernel``) theirs, for
    K10's bf16 kernels (``gla_ws_kernel``,
    ``gla_mma_kernel``, ``gla_wide_scores_kernel``, ``gla_wide_kernel``)
    their warpgroup-MMA count, HGMMA, and for K8 (``iir_kernel``) its
    asynchronous copies, LDGSTS.  Every compiler warning is printed
    (ptxas says so when it serializes a kernel's wgmma pipeline)."""
    from repro_torch.kernels import gla, iir
    from repro_torch.kernels.attention import kernel as attn
    from repro_torch.kernels.dtw import matrix, stream
    for lib in libs:
        name = "?"
        props = ""
        loops = sass_cell_loops(lib, "stream_scored_kernel") \
            if lib is stream.LIB else {}
        ops = {}
        if lib is matrix.LIB:
            ops = sass_ops(lib, "dtw_matrix_kernel",
                           ("FMNMX", "SHFL", "STG"))
        elif lib is attn.LIB:
            ops = {**sass_ops(lib, "flash_tf32_kernel", ("HGMMA",)),
                   **sass_ops(lib, "flash_tf32_mla_kernel",
                              ("HGMMA", "UTMALDG"))}
        elif lib is attn.BWD_LIB:
            ops = {**sass_ops(lib, "flash_bwd_dkdv_kernel", ("HGMMA",)),
                   **sass_ops(lib, "flash_bwd_dq_kernel", ("HGMMA",))}
        elif lib is attn.BWD_MLA_LIB:
            ops = {**sass_ops(lib, "flash_bwd_mla_dkdv_kernel", ("HGMMA",)),
                   **sass_ops(lib, "flash_bwd_mla_dq_kernel", ("HGMMA",))}
        elif lib in (attn.BF16_BWD_LIB, attn.BF16_BWD_MLA_LIB):
            ops = {**sass_ops(lib, "flash_bf16_bwd_dkdv_kernel",
                              ("HGMMA", "UTMALDG")),
                   **sass_ops(lib, "flash_bf16_bwd_dq_kernel",
                              ("HGMMA", "UTMALDG"))}
        elif lib is gla.kernel.BWD_LIB:
            ops = {**sass_ops(lib, "gla_bwd_u_kernel", ("HGMMA",)),
                   **sass_ops(lib, "gla_bwd_dkdv_kernel", ("HGMMA",)),
                   **sass_ops(lib, "gla_bwd_dq_kernel", ("HGMMA",))}
        elif lib is attn.BF16_LIB:
            ops = {**sass_ops(lib, "flash_wgmma_kernel", ("HGMMA",)),
                   **sass_ops(lib, "flash_mla_kernel",
                              ("HGMMA", "LDGSTS", "UTMALDG"))}
        elif lib is gla.kernel.LIB:
            ops = {**sass_ops(lib, "gla_ws_kernel", ("HGMMA",)),
                   **sass_ops(lib, "gla_mma_kernel", ("HGMMA",)),
                   **sass_ops(lib, "gla_wide_scores_kernel", ("HGMMA",)),
                   **sass_ops(lib, "gla_wide_kernel", ("HGMMA",))}
        elif lib is iir.kernel.LIB:
            ops = sass_ops(lib, "iir_kernel", ("LDGSTS",))
        for line in lib.build_log.splitlines():
            m = re.search(r"entry function '(.*?)'", line)
            if "warning" in line.lower():
                # e.g. ptxas serializing a kernel's wgmma pipeline
                print(f"[build] {lib.name}: {line.strip()}")
            if m:
                name = kernel_name(m.group(1)) or "?"
            elif "spill" in line:
                props = line.strip()
            elif "registers" in line:
                used = line.split(":", 1)[-1].strip()
                extra = ""
                if name in loops:
                    regs = int(re.search(r"(\d+) registers", used).group(1))
                    extra = (f"; {occupancy(regs, stream.BLOCK)} warps an "
                             f"SM at {stream.BLOCK} threads a block; cell "
                             f"loops " + ", ".join(
                                 f"{n} SASS / {c} cells = {n / c:.2f} a cell"
                                 for n, c in loops[name]))
                if name in ops:
                    extra = f"; {ops[name]}"
                print(f"[build] {lib.name} {name}: {used}; {props}{extra}")


def check_k1(dev, errs: ErrLog) -> None:
    """K1 against its plain version on ``tick_cases()``: ragged banks,
    ragged nvalid including 0, band None and 6, four consecutive ticks
    each."""
    from repro_torch.core import dtw
    for i, (dyadic, band, c, k) in enumerate(tick_cases()):
        rng = np.random.default_rng(100 + i)
        s = 5
        bank = _bank(rng, k, 12, 60, dyadic)
        m = bank.series.shape[1]
        bank_t = torch.tensor(bank.series.T.copy(), device=dev)
        lengths = torch.tensor(bank.lengths, device=dev)
        qlens = torch.full((s,), 4 * c, dtype=torch.int32, device=dev)
        state = dtw.tick_state_from_numpy(
            np.full((s, m, k), dtw._INF, np.float32),
            np.zeros((3, s, m, k), np.float32), np.zeros(s, np.int32),
            np.zeros(s, np.float32), np.zeros(s, np.float32), dev)
        st_k, st_p = state, tuple(t.clone() for t in state)
        tol = DYADIC_TOL if dyadic else SMOOTH_TOL
        for tick in range(4):
            nv = rng.integers(0, c + 1, size=s).astype(np.int32)
            nv[tick % s] = 0
            nv[(tick + 1) % s] = c
            ch = np.stack([_series(rng, c, dyadic) for _ in range(s)])
            args = (bank_t, lengths, torch.tensor(ch, device=dev),
                    torch.tensor(nv, device=dev), qlens)
            before = counts()
            out_k = dtw.bank_extend_tick_scored_dispatch(*st_k, *args,
                                                         band=band)
            out_p = dtw.bank_extend_tick_scored(*st_p, *args, band=band)
            torch.cuda.synchronize()
            launched(before, K1=1)
            fin = out_p[0] < 1e37
            assert torch.equal(fin, out_k[0] < 1e37), \
                f"K1 case {i} tick {tick}: saturated cells differ"
            e = max(errs.diff("K1", out_k[0], out_p[0], fin),
                    errs.diff("K1", out_k[1], out_p[1],
                              fin[None].expand_as(out_p[1])),
                    errs.diff("K1", out_k[5], out_p[5]))
            for a, b in zip(out_k[2:5], out_p[2:5]):
                assert torch.equal(a, b), "K1: ns/sx/sxx differ"
            assert e <= tol, (f"K1 case {i} (dyadic={dyadic}, band={band},"
                              f" C={c}, K={k}) tick {tick}: max abs err {e}")
            st_k, st_p = out_k[:5], out_p[:5]
        print(f"[K1] dyadic={dyadic!s:5} band={band!s:4} C={c:2d} "
              f"K={k:3d}: 4 ticks agree (max abs err {errs.err['K1']:.3g}, "
              f"tol {tol:g})")


def check_k2(dev, errs: ErrLog) -> None:
    """K2 against its plain version: ragged banks, ragged query lengths
    (0, 1, 2, < N and N: all but N = 70 shorter than the 32 lanes), band
    None, 6 and 2 (narrower than a strip); and banks with references of
    1 and 5 columns (shorter than a strip) and longer than one panel
    (WAVEFRONT_LENGTHS)."""
    from repro_torch.core import dtw
    from repro_torch.kernels.dtw import score
    cases = [(dy, band, n, pan) for pan in (False, True)
             for dy in (True, False) for band in (None, 6, 2)
             for n in (12, 70)]
    for i, (dyadic, band, n, panels) in enumerate(cases):
        rng = np.random.default_rng(200 + i)
        j, k = 6, 133
        bank = _bank_shapes(rng, k, dyadic, panels)
        xlens = np.asarray([0, 1, n, n - 3, n // 2, 2], np.int32)
        xs = np.zeros((j, n), np.float32)
        for q, l in enumerate(xlens):
            xs[q, :l] = _series(rng, int(l), dyadic)
        folds = [dtw.query_moments(xs[q, :xlens[q]]) for q in range(j)]
        args = (torch.tensor(xs, device=dev),
                torch.tensor(xlens, device=dev),
                torch.tensor(bank.series.T.copy(), device=dev),
                torch.tensor(bank.lengths, device=dev),
                torch.tensor([f[0] for f in folds], device=dev),
                torch.tensor([f[1] for f in folds], device=dev))
        before = counts()
        sk, dk = score.score_bank_offline(*args, band=band)
        sp, dp = score.score_bank_offline_plain(*args, band=band)
        torch.cuda.synchronize()
        launched(before, K2=1)
        e = max(errs.diff("K2", sk, sp), errs.diff("K2", dk, dp))
        tol = DYADIC_TOL if dyadic else SMOOTH_TOL
        assert e <= tol, (f"K2 case {i} (dyadic={dyadic}, band={band}, "
                          f"N={n}, panels={panels}): max abs err {e}")
        print(f"[K2] dyadic={dyadic!s:5} band={band!s:4} N={n:2d} "
              f"M={bank.series.shape[1]:4d}: scores and distances agree "
              f"(max abs err {e:.3g}, tol {tol:g})")


def check_k4(dev, errs: ErrLog) -> None:
    """K4 against its plain version, six channels and four, on
    ``tick_cases()``: ragged banks, ragged nvalid including 0, band None
    and 6, four consecutive ticks each; dyadic samples with dyadic
    variances, and smooth samples with continuous variances."""
    from repro_torch.core import dtw
    first = [(nch, *case) for nch in (6, 4) for case in tick_cases()[:12]]
    cases = first + [(nch, *case) for nch in (6, 4)
                     for case in tick_cases()[12:]]
    for i, (nch, dyadic, band, c, k) in enumerate(cases):
        key = "K4-exact" if nch == 6 else "K4-approx"
        kern = dtw.bank_extend_tick_scored_var_dispatch if nch == 6 \
            else dtw.bank_extend_tick_scored_var_approx_dispatch
        plain = dtw.bank_extend_tick_scored_var if nch == 6 \
            else dtw.bank_extend_tick_scored_var_approx
        rng = np.random.default_rng(400 + i)
        s = 5
        bank = _bank(rng, k, 12, 60, dyadic)
        m = bank.series.shape[1]
        bank_t = torch.tensor(bank.series.T.copy(), device=dev)
        lengths = torch.tensor(bank.lengths, device=dev)
        qlens = torch.full((s,), 4 * c, dtype=torch.int32, device=dev)
        state = dtw.tick_state_from_numpy(
            np.full((s, m, k), dtw._INF, np.float32),
            np.zeros((nch, s, m, k), np.float32), np.zeros(s, np.int32),
            np.zeros(s, np.float32), np.zeros(s, np.float32), dev,
            vstats=np.zeros((s, 3), np.float32))
        st_k, st_p = state, tuple(t.clone() for t in state)
        tol = DYADIC_TOL if dyadic else SMOOTH_TOL
        ep = 0.0
        for tick in range(4):
            nv = rng.integers(0, c + 1, size=s).astype(np.int32)
            nv[tick % s] = 0
            nv[(tick + 1) % s] = c
            ch = np.stack([_series(rng, c, dyadic) for _ in range(s)])
            vch = _vars(rng, (s, c), dyadic)
            args = (bank_t, lengths, torch.tensor(ch, device=dev),
                    torch.tensor(vch, device=dev),
                    torch.tensor(nv, device=dev), qlens)
            before = counts()
            out_k = kern(*st_k, *args, band=band, threshold=0.85)
            out_p = plain(*st_p, *args, band=band, threshold=0.85)
            torch.cuda.synchronize()
            launched(before, **{key.replace("-", "_"): 1})
            fin = out_p[0] < 1e37
            assert torch.equal(fin, out_k[0] < 1e37), \
                f"{key} case {i} tick {tick}: saturated cells differ"
            e = max(errs.diff(key, out_k[0], out_p[0], fin),
                    errs.diff(key, out_k[1], out_p[1],
                              fin[None].expand_as(out_p[1])),
                    errs.diff(key, out_k[5], out_p[5]))
            ep = max(ep, errs.diff(key, out_k[7], out_p[7]))
            for a, b in zip(out_k[2:5] + (out_k[6],),
                            out_p[2:5] + (out_p[6],)):
                assert torch.equal(a, b), f"{key}: ns/sx/sxx/vstats differ"
            assert e <= tol, (f"{key} case {i} (dyadic={dyadic}, "
                              f"band={band}, C={c}, K={k}) tick {tick}: "
                              f"max abs err {e}")
            assert ep <= PROB_TOL, f"{key} case {i}: probability err {ep}"
            st_k = out_k[:5] + (out_k[6],)
            st_p = out_p[:5] + (out_p[6],)
        print(f"[{key}] dyadic={dyadic!s:5} band={band!s:4} C={c:2d} "
              f"K={k:3d}: 4 ticks agree (state/score max abs err {e:.3g}, "
              f"tol {tol:g}; probability {ep:.3g}, tol {PROB_TOL:g})")


def check_k56(dev, errs: ErrLog) -> None:
    """K5 and K6 against their plain versions: ragged banks, ragged
    query lengths (0, 1, < N and N), one-pass and multi-pass queries,
    band None and 6; and at zero variance, probabilities bitwise the
    plain version's, in {0, 1} and equal to 1{score >= threshold}."""
    from repro_torch.core import dtw
    from repro_torch.kernels.dtw import score
    cases = [(ap, dy, band, n, pan) for pan in (False, True)
             for ap in (False, True) for dy in (True, False)
             for band in (None, 6, 2) for n in (12, 70)]
    for i, (approx, dyadic, band, n, panels) in enumerate(cases):
        key = "K6" if approx else "K5"
        rng = np.random.default_rng(500 + i)
        j, k = 6, 133
        bank = _bank_shapes(rng, k, dyadic, panels)
        xlens = np.asarray([0, 1, n, n - 3, n // 2, 2], np.int32)
        xs = np.zeros((j, n), np.float32)
        xv = np.zeros((j, n), np.float32)
        for q, l in enumerate(xlens):
            xs[q, :l] = _series(rng, int(l), dyadic)
            xv[q, :l] = _vars(rng, int(l), dyadic)
        folds = [dtw.query_moments(xs[q, :xlens[q]]) for q in range(j)]
        vst = np.asarray([dtw.query_var_moments(xs[q, :xlens[q]],
                                                xv[q, :xlens[q]])
                          for q in range(j)], np.float32)
        t = {name: torch.tensor(a, device=dev) for name, a in (
            ("xs", xs), ("xl", xlens), ("bank", bank.series.T.copy()),
            ("len", bank.lengths), ("vst", vst),
            ("sx", np.asarray([f[0] for f in folds], np.float32)),
            ("sxx", np.asarray([f[1] for f in folds], np.float32)))}
        tol = DYADIC_TOL if dyadic else SMOOTH_TOL
        for var in (xv, np.zeros_like(xv)):
            args = (t["xs"], torch.tensor(var, device=dev), t["xl"],
                    t["bank"], t["len"], t["sx"], t["sxx"],
                    t["vst"] if var is xv else torch.zeros_like(t["vst"]))
            before = counts()
            sk, pk, dk = score.score_bank_offline_var(
                *args, band=band, threshold=0.85, approx=approx)
            sp, pp, dp = score.score_bank_offline_var_plain(
                *args, band=band, threshold=0.85, approx=approx)
            torch.cuda.synchronize()
            launched(before, **{key: 1})
            e = max(errs.diff(key, sk, sp), errs.diff(key, dk, dp))
            ep = errs.diff(key, pk, pp)
            assert e <= tol, (f"{key} case {i} (dyadic={dyadic}, "
                              f"band={band}, N={n}): max abs err {e}")
            assert ep <= PROB_TOL, f"{key} case {i}: probability err {ep}"
            assert bool(torch.isfinite(pk).all())
            if var is not xv:
                assert torch.equal(pk, pp), f"{key}: zero-variance probs"
                assert torch.equal(pk, (sk >= 0.85).float())
        print(f"[{key}] dyadic={dyadic!s:5} band={band!s:4} N={n:2d} "
              f"M={bank.series.shape[1]:4d}: scores and distances agree "
              f"(max abs err {e:.3g}, tol {tol:g}); probabilities {ep:.3g} (tol {PROB_TOL:g}); zero "
              f"variance bitwise the point rule")


def check_k3(dev, errs: ErrLog) -> None:
    """K3 against its plain version on ``tick_cases()``: ragged banks,
    ragged nvalid including 0, band None and 6, four consecutive ticks
    each; and against K1's rows, advanced in lockstep from the same
    state, bitwise on any data (the distances never read the
    moments)."""
    from repro_torch.core import dtw
    from repro_torch.kernels.dtw import stream
    for i, (dyadic, band, c, k) in enumerate(tick_cases()):
        rng = np.random.default_rng(300 + i)
        s = 5
        bank = _bank(rng, k, 12, 60, dyadic)
        m = bank.series.shape[1]
        bank_t = torch.tensor(bank.series.T.copy(), device=dev)
        lengths = torch.tensor(bank.lengths, device=dev)
        qlens = torch.full((s,), 4 * c, dtype=torch.int32, device=dev)
        rows_k = torch.full((s, m, k), dtw._INF, device=dev)
        ns_k = torch.zeros(s, dtype=torch.int32, device=dev)
        rows_p, ns_p = rows_k.clone(), ns_k.clone()
        moms1 = torch.zeros((3, s, m, k), device=dev)
        rows1 = rows_k.clone()
        tol = DYADIC_TOL if dyadic else SMOOTH_TOL
        for tick in range(4):
            nv = rng.integers(0, c + 1, size=s).astype(np.int32)
            nv[tick % s] = 0
            nv[(tick + 1) % s] = c
            ch = np.stack([_series(rng, c, dyadic) for _ in range(s)])
            args = (bank_t, lengths, torch.tensor(ch, device=dev),
                    torch.tensor(nv, device=dev), qlens)
            before = counts()
            rows_k, ns_k2 = dtw.bank_extend_tick_dispatch(rows_k, ns_k,
                                                          *args, band=band)
            rows1, moms1 = stream.stream_bank_extend_scored(
                rows1, moms1, ns_k, *args, band=band)
            rows_p, ns_p = dtw.bank_extend_tick(rows_p, ns_p, *args,
                                                band=band)
            torch.cuda.synchronize()
            launched(before, K3=1, K1=1)
            ns_k = ns_k2
            fin = rows_p < 1e37
            assert torch.equal(fin, rows_k < 1e37), \
                f"K3 case {i} tick {tick}: saturated cells differ"
            e = errs.diff("K3", rows_k, rows_p, fin)
            assert torch.equal(ns_k, ns_p), "K3: ns differ"
            assert e <= tol, (f"K3 case {i} (dyadic={dyadic}, band={band},"
                              f" C={c}, K={k}) tick {tick}: max abs err {e}")
            assert torch.equal(rows_k, rows1), \
                f"K3 case {i} tick {tick}: rows differ from K1's"
        print(f"[K3] dyadic={dyadic!s:5} band={band!s:4} C={c:2d} "
              f"K={k:3d}: 4 ticks agree (max abs err {errs.err['K3']:.3g}, "
              f"tol {tol:g}); rows bitwise K1's")


def check_k7(dev, errs: ErrLog) -> None:
    """K7 against its plain version, bitwise on dyadic and smooth data
    (the DP is min and add only): the bank form (one
    query, ragged references) and the pairs form (ragged queries), band
    None and 6, chunks of 12, 40 and 70 rows and one of 1100; references
    longer than one 384-column panel (385-1000 columns) and shorter than a
    strip; chunks of one row (C = 1); resumed from a carried row in
    chunks of 16 and of 1, bitwise the one-shot matrix; K7's rows against
    K3's rows advanced from the same state (bitwise on any data), and
    K7's matrix at (xlen - 1, len_k - 1) against K2's endpoint distances;
    the ``ops`` API bitwise ``dtw_rows``."""
    from repro_torch.core import dtw
    from repro_torch.core.database import pack_series
    from repro_torch.kernels.dtw import matrix, ops, score, stream
    cases = [(dy, band, n) for dy in (True, False) for band in (None, 6)
             for n in (12, 40, 70)]
    for i, (dyadic, band, n) in enumerate(cases):
        rng = np.random.default_rng(700 + i)
        k = 37
        bank = _bank(rng, k, 10, 60, dyadic)
        m = bank.series.shape[1]
        ys = torch.tensor(bank.series, device=dev)
        lens = torch.tensor(bank.lengths, device=dev)
        x = torch.tensor(_series(rng, n, dyadic), device=dev)
        qn = torch.full((k,), n, dtype=torch.int32, device=dev)
        before = counts()
        rk, lk = matrix.dtw_rows(x, ys, qn, lens, band=band)
        rp, lp = matrix.dtw_rows_plain(x, ys, qn, lens, band=band)
        # the pairs form: ragged queries, band centred on their lengths
        xs = torch.tensor(np.stack([_series(rng, n, dyadic)
                                    for _ in range(k)]), device=dev)
        xl = torch.tensor(rng.integers(1, n + 1, k).astype(np.int32),
                          device=dev)
        pk, _ = matrix.dtw_rows(xs, ys, xl, lens, band=band)
        pp, _ = matrix.dtw_rows_plain(xs, ys, xl, lens, band=band)
        # resumed: chunks of 16 from the carried row, rows collected
        st = dtw.dtw_bank_init(bank.series, bank.lengths, band=band,
                               query_len=n, device=dev)
        parts = []
        for lo in range(0, n, 16):
            st, rows = dtw.dtw_bank_extend(st, x[lo:lo + 16],
                                           collect_rows=True)
            parts.append(rows)
        torch.cuda.synchronize()
        launched(before, K7=2 + (n + 15) // 16)
        for a, b in ((rk, rp), (lk, lp), (pk, pp)):
            errs.diff("K7", a, b)
            assert torch.equal(a, b), f"K7 case {i}: kernel != plain"
        assert torch.equal(torch.cat(parts).transpose(0, 1), rk), \
            f"K7 case {i}: resumed rows differ from the one-shot matrix"
        assert torch.equal(st.row, rk[:, -1]), f"K7 case {i}: carried row"
        # K3's rows from the same (fresh) state, one tick of n samples
        rows3 = stream.stream_bank_extend(
            torch.full((1, m, k), dtw._INF, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            ys.t().contiguous(), lens, x[None].contiguous(),
            torch.full((1,), n, dtype=torch.int32, device=dev),
            torch.full((1,), n, dtype=torch.int32, device=dev), band)
        assert torch.equal(rows3[0].t(), rk[:, -1]), \
            f"K7 case {i}: last row differs from K3's"
        # K2's endpoint distances: query q of the pairs form vs every
        # reference, read from K7's pairs matrix at (xlen - 1, len_k - 1)
        xlc = xl.cpu().numpy()
        xsn = xs.cpu().numpy()
        folds = [dtw.query_moments(xsn[q, :xlc[q]]) for q in range(k)]
        _, d2 = score.score_bank_offline(
            xs, xl, ys.t().contiguous(), lens,
            torch.tensor([f[0] for f in folds], device=dev),
            torch.tensor([f[1] for f in folds], device=dev), band)
        kk = torch.arange(k, device=dev)
        d7 = pk[kk, xl.long() - 1, lens.long() - 1]
        assert torch.equal(d2[kk, kk], d7), \
            f"K7 case {i}: endpoints differ from K2's distances"
        print(f"[K7] dyadic={dyadic!s:5} band={band!s:4} N={n:2d}: bank "
              f"and pairs forms bitwise the plain version; resumed in "
              f"chunks of 16 bitwise the one-shot matrix; last row "
              f"bitwise K3's; endpoints bitwise K2's distances")
    # the ops API (the reference's entry points to K7): one launch each,
    # bitwise dtw_rows on the same inputs
    rng = np.random.default_rng(798)
    k, n = 37, 40
    bank = _bank(rng, k, 10, 60, False)
    m = bank.series.shape[1]
    ys = torch.tensor(bank.series, device=dev)
    lens = torch.tensor(bank.lengths, device=dev)
    x = torch.tensor(_series(rng, n, False), device=dev)
    xs = torch.tensor(np.stack([_series(rng, n, False) for _ in range(k)]),
                      device=dev)
    xl = torch.tensor(rng.integers(1, n + 1, k).astype(np.int32), device=dev)
    before = counts()
    db = ops.dtw_batched(x, ys, dev)
    dbp = ops.dtw_batched_pairs(xs, ys, dev)
    dd = ops.dtw_distances(x, ys, dev, lengths=lens)
    ddp = ops.dtw_distances_pairs(xs, ys, xl, lens, device=dev)
    torch.cuda.synchronize()
    launched(before, K7=4)
    qn = torch.full((k,), n, dtype=torch.int32, device=dev)
    full = torch.full((k,), m, dtype=torch.int32, device=dev)
    rb, _ = matrix.dtw_rows(x, ys, qn, full)
    rpp, _ = matrix.dtw_rows(xs, ys, qn, full)
    kk = torch.arange(k, device=dev)
    assert torch.equal(db, rb) and torch.equal(dbp, rpp), "ops matrices"
    assert torch.equal(dd, rb[kk, -1, lens.long() - 1]), "ops distances"
    assert torch.equal(ddp, rpp[kk, xl.long() - 1, lens.long() - 1]), \
        "ops pair distances"
    print("[K7] ops.dtw_batched, dtw_batched_pairs, dtw_distances and "
          "dtw_distances_pairs: one launch each, bitwise dtw_rows")
    # a chunk of 1100 rows
    rng = np.random.default_rng(799)
    bank = _bank(rng, 3, 40, 50, False)
    ys = torch.tensor(bank.series, device=dev)
    lens = torch.tensor(bank.lengths, device=dev)
    x = torch.tensor(_series(rng, 1100, False), device=dev)
    qn = torch.full((3,), 1100, dtype=torch.int32, device=dev)
    for band in (None, 6):
        for collect in (True, False):
            rp, lp = matrix.dtw_rows_plain(x, ys, qn, lens, band=band,
                                           collect_rows=collect)
            rk, lk = matrix.dtw_rows(x, ys, qn, lens, band=band,
                                     collect_rows=collect)
            assert torch.equal(lk, lp) and (not collect or
                                            torch.equal(rk, rp))
    # edge shapes: one row, one column, band 0
    for n, m, band in ((1, 1, None), (1, 7, None), (7, 1, None),
                       (9, 13, 0), (13, 9, 0)):
        ys = torch.tensor(_series(rng, 3 * m, False).reshape(3, m),
                          device=dev)
        x = torch.tensor(_series(rng, n, False), device=dev)
        ln = torch.full((3,), m, dtype=torch.int32, device=dev)
        qn = torch.full((3,), n, dtype=torch.int32, device=dev)
        rp, lp = matrix.dtw_rows_plain(x, ys, qn, ln, band=band)
        rk, lk = matrix.dtw_rows(x, ys, qn, ln, band=band)
        assert torch.equal(rk, rp) and torch.equal(lk, lp), (n, m, band)
    # panels and one-row chunks: references of 1-1000 columns (up to three
    # 384-column panels), the bank and pairs forms, with and without the
    # rows; then the same query resumed a row at a time
    lens_p = (1, 5, 11, 385, 500, 800, 1000, 40)
    for j, (dyadic, band) in enumerate((d, b) for d in (True, False)
                                       for b in (None, 6)):
        rng = np.random.default_rng(780 + j)
        bank = pack_series([_series(rng, n, dyadic) for n in lens_p])
        k, m = bank.series.shape
        ys = torch.tensor(bank.series, device=dev)
        lens = torch.tensor(bank.lengths, device=dev)
        n = 45
        x = torch.tensor(_series(rng, n, dyadic), device=dev)
        xs = torch.tensor(np.stack([_series(rng, n, dyadic)
                                    for _ in range(k)]), device=dev)
        qn = torch.full((k,), n, dtype=torch.int32, device=dev)
        rp, lp = matrix.dtw_rows_plain(x, ys, qn, lens, band=band)
        pp, _ = matrix.dtw_rows_plain(xs, ys, qn, lens, band=band)
        for collect in (True, False):
            rk, lk = matrix.dtw_rows(x, ys, qn, lens, band=band,
                                     collect_rows=collect)
            assert torch.equal(lk, lp) and (
                not collect or torch.equal(rk, rp)), j
        pk, _ = matrix.dtw_rows(xs, ys, qn, lens, band=band)
        assert torch.equal(pk, pp), j
        row = None
        for i in range(n):
            ck, row = matrix.dtw_rows(x[i:i + 1], ys, qn, lens, row=row,
                                      n0=i, band=band)
            assert torch.equal(ck[:, 0], rp[:, i]), (j, i)
        assert torch.equal(row, lp)
    print("[K7] N=1100, band None and 6, with and without the rows; N x M "
          "= 1 x 1, 1 x 7, 7 x 1, and band 0; references of 1-1000 "
          "columns (three panels), bank and pairs forms, resumed a row "
          "(C = 1) at a time: bitwise the plain version")


def check_k2_pairs(dev, errs: ErrLog) -> None:
    """K2 pairs against its plain version (bitwise on dyadic data,
    SMOOTH_TOL on smooth data) and against K2 on the same pairs (the
    diagonal of a P x P verdict; bitwise on any data): ragged query
    lengths (0, 1, < N and N), reference lengths 10-60 and
    WAVEFRONT_LENGTHS (shorter than a strip, longer than a panel), band
    None, 6 and 2."""
    from repro_torch.core import dtw
    from repro_torch.kernels.dtw import score
    cases = [(dy, band, n) for dy in (True, False) for band in (None, 6, 2)
             for n in (12, 70)]
    for i, (dyadic, band, n) in enumerate(cases):
        rng = np.random.default_rng(800 + i)
        p = 70
        bank = _bank_shapes(rng, p, dyadic, panels=True)
        xlens = rng.integers(0, n + 1, p).astype(np.int32)
        xlens[:3] = (0, 1, n)
        xs = np.zeros((p, n), np.float32)
        for q, l in enumerate(xlens):
            xs[q, :l] = _series(rng, int(l), dyadic)
        folds = [dtw.query_moments(xs[q, :xlens[q]]) for q in range(p)]
        args = (torch.tensor(xs, device=dev),
                torch.tensor(xlens, device=dev),
                torch.tensor(bank.series.T.copy(), device=dev),
                torch.tensor(bank.lengths, device=dev),
                torch.tensor([f[0] for f in folds], device=dev),
                torch.tensor([f[1] for f in folds], device=dev))
        before = counts()
        sk, dk = score.score_pairs(*args, band=band)
        sp, dp = score.score_pairs_plain(*args, band=band)
        s2, d2 = score.score_bank_offline(*args, band=band)
        torch.cuda.synchronize()
        launched(before, K2_pairs=1, K2=1)
        e = max(errs.diff("K2-pairs", sk, sp), errs.diff("K2-pairs", dk, dp))
        tol = DYADIC_TOL if dyadic else SMOOTH_TOL
        assert e <= tol, (f"K2 pairs case {i} (dyadic={dyadic}, band="
                          f"{band}, N={n}): max abs err {e}")
        kk = torch.arange(p, device=dev)
        assert torch.equal(sk, s2[kk, kk]) and torch.equal(dk, d2[kk, kk]), \
            f"K2 pairs case {i}: differs from K2 on the same pairs"
        print(f"[K2 pairs] dyadic={dyadic!s:5} band={band!s:4} N={n:2d}: "
              f"scores and distances agree (max abs err {e:.3g}, tol "
              f"{tol:g}); bitwise K2's on the same pairs")


def paper_bank():
    from repro_torch import mrsim
    from repro_torch.core.database import SeriesBank, pack_series
    from repro_torch.core.filters import preprocess_bank
    series, labels = [], []
    for app in ("wordcount", "terasort"):
        for p in mrsim.paper_param_sets():
            series.append(mrsim.simulate_cpu_series(app, p, dt=0.25))
            labels.append(app)
    packed = pack_series(series, labels=labels)
    return SeriesBank(preprocess_bank(packed.series, packed.lengths),
                      packed.lengths, packed.labels)


def paper_scenario(dev, bank, prob_mode=None, point=None) -> list:
    """The reference's paper scenario (benchmarks/bench_streaming.py):
    exim traces matched WHILE they run against a preprocessed
    wordcount/terasort bank (2 apps x 4 parameter sets), monitored at
    4 Hz in 8-sample chunks.  With ``prob_mode`` the service is
    probabilistic and every push carries zero variance; it must then
    decide exactly as the point run ``point`` did."""
    from repro_torch import mrsim
    from repro_torch.serve.tuning import TuningService
    kw = {} if prob_mode is None else dict(min_probability=0.5,
                                           prob_mode=prob_mode)
    tag = "point" if prob_mode is None else f"prob {prob_mode}"
    runs = []
    for j, p in enumerate(mrsim.paper_param_sets()):
        svc = TuningService(bank, band=16, threshold=0.85, margin=0.02,
                            stable_ticks=3, min_fraction=0.15,
                            denoise=True, device=dev, **kw)
        q = mrsim.simulate_cpu_series("exim", p, run=1, dt=0.25)
        before = counts()
        svc.submit("exim", expected_len=len(q))
        early = None
        for chunk in mrsim.iter_cpu_series("exim", p, run=1, chunk=8,
                                           dt=0.25):
            if prob_mode is None:
                svc.push("exim", chunk)
            else:
                svc.push("exim", chunk, variance=np.zeros_like(chunk))
            d = svc.tick().get("exim")
            early = early or d
        final = svc.finish("exim")
        assert svc.dispatch_count == svc.ticks
        if prob_mode is None:
            launched(before, K1=svc.ticks, K2=1)
        else:
            launched(before, K5=1, **{"K4_" + prob_mode: svc.ticks})
        frac = early.fraction_seen if early is not None else 1.0
        print(f"[paper {tag}] pset{j}: early="
              f"{early.matched if early else None}@{frac:.2f} (reference "
              f"{REF_EARLY[j]:.2f}) final={final.matched} "
              f"wc={final.scores['wordcount']:.4f} "
              f"ts={final.scores['terasort']:.4f} "
              f"p={final.probability}")
        assert final.matched == "wordcount", final.scores
        assert early is not None and early.matched == "wordcount"
        assert round(frac, 2) == REF_EARLY[j], (frac, REF_EARLY[j])
        if point is not None:
            pe, pf = point[j]
            assert (early.matched, early.corr, early.decided_at_fraction) \
                == (pe.matched, pe.corr, pe.decided_at_fraction)
            assert (final.matched, final.corr, final.scores) == \
                (pf.matched, pf.corr, pf.scores)
            assert early.probability == 1.0
            assert final.probability in (0.0, 1.0)
            assert (final.probability == 1.0) == (final.corr >= 0.85)
        runs.append((early, final))
    return runs


def paper_degraded(dev, bank, point) -> None:
    """The paper scenario in distance-only mode (``score_in_flight=
    False``), then in point mode pinned at the overload ladder's rung 3
    (``distance_only``) by ``latency=`` overrides before the job starts,
    as the reference's overload tests pre-heat a service.  Both must make
    no early decision and render point mode's final verdicts bitwise,
    through K3 and K2 alone."""
    from repro_torch import mrsim
    from repro_torch.serve.overload import OverloadConfig
    from repro_torch.serve.tuning import TuningService
    cfg = OverloadConfig(target_p99=0.01, patience=1, cooldown=1000,
                         window=64, max_rung=3)
    for tag, kw in (("distance-only", dict(score_in_flight=False)),
                    ("rung 3", dict(overload=cfg))):
        for j, p in enumerate(mrsim.paper_param_sets()):
            svc = TuningService(bank, band=16, threshold=0.85, margin=0.02,
                                stable_ticks=3, min_fraction=0.15,
                                denoise=True, device=dev, **kw)
            for _ in range(5):
                svc.tick(latency=10.0)
            q = mrsim.simulate_cpu_series("exim", p, run=1, dt=0.25)
            before = counts()
            svc.submit("exim", expected_len=len(q))
            earlies = 0
            for chunk in mrsim.iter_cpu_series("exim", p, run=1, chunk=8,
                                               dt=0.25):
                svc.push("exim", chunk)
                earlies += svc.tick().get("exim") is not None
            final = svc.finish("exim")
            launched(before, K3=svc.dispatch_count, K2=1)
            assert svc.dispatch_count == svc.ticks - 5
            if "overload" in kw:
                assert svc.rung == 3 and svc.worst_rung == 3
            pf = point[j][1]
            assert earlies == 0, f"{tag} pset{j}: early decisions"
            assert (final.matched, final.corr, final.scores) == \
                (pf.matched, pf.corr, pf.scores), f"{tag} pset{j}"
            assert final.decided_at_fraction == 1.0
            print(f"[paper {tag}] pset{j}: no early decision, final="
                  f"{final.matched} wc={final.scores['wordcount']:.4f} "
                  f"(point mode's, bitwise); K3 launches "
                  f"{svc.dispatch_count}")


def throughput_bank(rng, k: int):
    """The reference's throughput bank (bench_streaming._throughput_bank):
    K sinusoid+noise references with lengths drawn from six buckets up to
    360 samples."""
    from repro_torch.core.database import pack_series
    buckets = (180, 220, 256, 300, 330, 360)
    series = []
    for i in range(k):
        n = buckets[int(rng.integers(len(buckets)))]
        t = np.linspace(0, 1, n, dtype=np.float32)
        s = (0.5 + 0.3 * np.sin(2 * np.pi * (2 + i % 5) * t)
             + 0.1 * rng.normal(size=n).astype(np.float32))
        series.append(np.clip(s, 0, 1).astype(np.float32))
    return pack_series(series, labels=[f"w{i % 16}" for i in range(k)])


def _row(key, launches, errs, ms, plain_ms, bounds, library_ms=None):
    name, src, replaces = KERNELS[key]
    return dict(name=name, route="cuda",
                source=src,
                replaces=replaces, launches=launches,
                max_abs_err=errs.err[key], ms=ms, plain_ms=plain_ms,
                bound_ms=max(bounds),
                bound_by="bytes" if bounds[0] >= bounds[1] else "operations",
                library_ms=library_ms)


def full_inputs(mode: str, s_jobs: int, k: int, qlen: int, seed: int):
    """The full-width runs' bank, queries [S, qlen] and variances (None
    outside the probabilistic modes), from ``seed``.

    The point and distance-only modes stream sinusoid+noise queries (the
    same ones for the same seed); the probabilistic modes stream mrsim's
    heteroscedastic traces (``simulate_cpu_series_uncertain`` at dt =
    1/16 s, noise 0.05) with their true per-sample variances."""
    from repro_torch import mrsim
    rng = np.random.default_rng(seed)
    bank = throughput_bank(rng, k)
    if mode in ("exact", "approx"):
        apps = list(mrsim.APPS)
        traces = [mrsim.simulate_cpu_series_uncertain(
            apps[i % 3], mrsim.paper_param_sets()[i % 4], run=i, dt=1 / 16,
            noise=0.05) for i in range(s_jobs)]
        return (bank, np.stack([q[:qlen] for q, _ in traces]),
                np.stack([v[:qlen] for _, v in traces]))
    queries = np.stack([np.clip(
        0.5 + 0.3 * np.sin(2 * np.pi * rng.uniform(1, 7)
                           * np.linspace(0, 1, qlen))
        + 0.1 * rng.normal(size=qlen), 0, 1) for _ in range(s_jobs)]
    ).astype(np.float32)
    return bank, queries, None


def _verdict_key(d):
    """What a verdict must reproduce across runs of the same jobs."""
    return (d.matched, d.corr, d.scores, d.probability)


def full_width(dev, errs: ErrLog, name: str, mode: str, s_jobs: int = 256,
               k: int = 256, n_fin: int = 32, seed: int = 0):
    """S=256 jobs x K=256 references (M=360), 24 ticks of 16 samples,
    then one batched verdict of 32 jobs, in ``mode`` "point", "exact",
    "approx" or "distance" (``score_in_flight=False``).  Returns the
    kernel table rows of the run's kernels and a record of the run
    (early decisions, verdicts, the DP rows before the verdict)."""
    from repro_torch.core import dtw
    from repro_torch.kernels.dtw import score, stream
    from repro_torch.serve.tuning import TuningService
    prob = mode in ("exact", "approx")
    nch = {"point": 3, "exact": 6, "approx": 4, "distance": 0}[mode]
    tick_key = {"point": "K1", "exact": "K4-exact", "approx": "K4-approx",
                "distance": "K3"}[mode]
    verdict_key = "K5" if prob else "K2"
    c, n_ticks = 16, 24
    qlen = n_ticks * c
    bank, queries, variances = full_inputs(mode, s_jobs, k, qlen, seed)
    m = bank.series.shape[1]
    assert m == 360, m
    kw = {"point": {}, "distance": dict(score_in_flight=False)}.get(
        mode, dict(min_probability=0.5, prob_mode=mode))
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    svc = TuningService(bank, slots=s_jobs, device=dev, **kw)
    for i in range(s_jobs):
        svc.submit(f"job{i}", expected_len=qlen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tick_s = []
    earlies = {}
    for t in range(n_ticks):
        for i in range(s_jobs):
            sl = slice(t * c, (t + 1) * c)
            if prob:
                svc.push(f"job{i}", queries[i, sl], variance=variances[i, sl])
            else:
                svc.push(f"job{i}", queries[i, sl])
        if t == n_ticks // 2:
            slot_of = [svc._jobs[f"job{i}"].slot for i in range(s_jobs)]
            snap = (svc._rows.clone(),
                    None if svc._moms is None else svc._moms.clone(),
                    svc._ns.clone(), svc._sx.clone(), svc._sxx.clone())
            if prob:
                snap += (svc._vstats.clone(),)
        t0 = time.perf_counter()
        out = svc.tick()
        torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t0)
        earlies.update({j: (d.matched, d.corr, d.decided_at_fraction)
                        for j, d in out.items() if d is not None})
        if t == n_ticks // 2:
            jobs = [svc._jobs[f"job{i}"] for i in range(s_jobs)]
            after = (svc._rows.clone(),
                     None if svc._moms is None else svc._moms.clone(),
                     None if mode == "distance"
                     else np.stack([j.last_sims for j in jobs]),
                     np.stack([j.last_probs for j in jobs]) if prob
                     else None)
    rows_before_verdict = svc._rows.clone()
    # the rest of the state phase 22's sharded runs are held to
    moms_before_verdict = None if svc._moms is None else svc._moms.clone()
    sims_before_verdict = None if mode == "distance" else np.stack(
        [svc._jobs[f"job{i}"].last_sims for i in range(s_jobs)])
    fin_ids = [f"job{i}" for i in range(n_fin)]
    t0 = time.perf_counter()
    verdicts = svc.finish_many(fin_ids)
    torch.cuda.synchronize()
    verdict_s = time.perf_counter() - t0
    # the approx mode's offline oracle: dtw_score_bank_many(prob_mode=
    # "approx") over the finished jobs, through K6
    npad = dtw._pad_pow2(qlen)
    xs_np = np.zeros((n_fin, npad), np.float32)
    xs_np[:, :qlen] = queries[:n_fin]
    xv_np = np.zeros((n_fin, npad), np.float32)
    if prob:
        xv_np[:, :qlen] = variances[:n_fin]
    xl_np = np.full((n_fin,), qlen, np.int32)
    if mode == "approx":
        oracle = dtw.dtw_score_bank_many(
            xs_np, bank.series, bank.lengths, xlens=xl_np, xvars=xv_np,
            prob_mode="approx", plan=bank.score_plan(dev))
        torch.cuda.synchronize()
    got = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    in_use_gb = torch.cuda.memory_allocated() / 1e9
    want = {key: 0 for key in got}
    want[tick_key] = svc.dispatch_count
    want[verdict_key] = svc.offline_dispatch_count
    if mode == "approx":
        want["K6"] = 1
    assert got == want, (mode, got, want)
    assert (svc.dispatch_count, svc.offline_dispatch_count) == (n_ticks, 1)
    if mode == "distance":
        assert not earlies, "distance-only run made early decisions"
    for v in verdicts.values():
        assert np.isfinite(v.corr) and len(v.scores) == 16
        assert (v.probability is not None) == prob
        if prob:
            assert 0.0 <= v.probability <= 1.0
    ms_tick = 1e3 * float(np.median(tick_s))
    print(f"[full {mode}] {s_jobs} jobs x K={k} x M={m}, C={c}: median "
          f"{ms_tick:.3f} ms/tick over {n_ticks} ticks (first "
          f"{1e3 * tick_s[0]:.3f} ms); verdict of {n_fin} jobs "
          f"{1e3 * verdict_s:.3f} ms; device memory in use "
          f"{in_use_gb:.3f} GB, peak {peak_gb:.3f} GB ({base_gb:.3f} GB "
          f"in use before the run); launches "
          f"{ {key: n for key, n in got.items() if n} }; "
          f"{len(earlies)} early decisions [{name}]")

    # one full-width tick against the plain version on the same inputs
    t = n_ticks // 2
    sl = slice(t * c, (t + 1) * c)
    chunks = torch.zeros((svc.slot_capacity, c), device=dev)
    vchunks = torch.zeros((svc.slot_capacity, c), device=dev)
    for i in range(s_jobs):
        chunks[slot_of[i]] = torch.tensor(queries[i, sl])
        if prob:
            vchunks[slot_of[i]] = torch.tensor(variances[i, sl])
    nvalid = torch.full((s_jobs,), c, dtype=torch.int32, device=dev)
    qlens = torch.full((s_jobs,), qlen, dtype=torch.int32, device=dev)
    bank_t, lengths = svc._bank_t, svc._lengths
    if mode == "distance":
        plain = dtw.bank_extend_tick(snap[0], snap[2], bank_t, lengths,
                                     chunks, nvalid, qlens)
    elif mode == "point":
        plain = dtw.bank_extend_tick_scored(*snap, bank_t, lengths, chunks,
                                            nvalid, qlens)
    else:
        fn = dtw.bank_extend_tick_scored_var if mode == "exact" \
            else dtw.bank_extend_tick_scored_var_approx
        plain = fn(*snap, bank_t, lengths, chunks, vchunks, nvalid, qlens,
                   threshold=svc.threshold)
    fin = plain[0] < 1e37
    assert torch.equal(fin, after[0] < 1e37)
    e = errs.diff(tick_key, after[0], plain[0], fin)
    if mode != "distance":
        sims = torch.tensor(after[2], device=dev)
        e = max(e, errs.diff(tick_key, after[1], plain[1],
                             fin[None].expand_as(plain[1])),
                errs.diff(tick_key, sims, plain[5][slot_of]))
    assert e <= SMOOTH_TOL, f"full-width {mode} tick: max abs err {e}"
    ep = 0.0
    if prob:
        ep = errs.diff(tick_key, torch.tensor(after[3], device=dev),
                       plain[7][slot_of])
        assert ep <= PROB_TOL, f"full-width {mode} tick: probability {ep}"
    print(f"[full {mode}] tick {t} held against the plain version: max abs "
          f"err {e:.3g} (tol {SMOOTH_TOL:g}), probabilities {ep:.3g} (tol "
          f"{PROB_TOL:g})")

    # timings at the main path's shapes, kernel beside plain version
    mem_bps, dtw_ops = card_peaks(name)[0], dtw_op_rate(name)
    cells = int(nvalid.sum()) * m * k
    tbytes = 2 * 4 * (1 + nch) * s_jobs * m * k + 4 * (
        m * k + k + (2 if prob else 1) * s_jobs * c + 3 * s_jobs)
    tb = (1e3 * tbytes / mem_bps, 1e3 * ops_per_cell(nch) * cells / dtw_ops)
    if mode == "distance":
        targs = (snap[0], snap[2], bank_t, lengths, chunks, nvalid, qlens)
        tk = lambda: stream.stream_bank_extend(*targs)  # noqa: E731
        tp = lambda: stream.stream_bank_extend_plain(*targs)  # noqa: E731
    else:
        targs = (*snap[:3], bank_t, lengths, chunks)
        if prob:
            tk = lambda: stream.stream_bank_extend_scored_var(  # noqa: E731
                *targs, vchunks, nvalid, qlens)
            tp = lambda: stream.stream_bank_extend_scored_var_plain(  # noqa
                *targs, vchunks, nvalid, qlens)
        else:
            tk = lambda: stream.stream_bank_extend_scored(  # noqa: E731
                *targs, nvalid, qlens)
            tp = lambda: stream.stream_bank_extend_scored_plain(  # noqa
                *targs, nvalid, qlens)
    t_ms = cuda_ms(tk, 20)
    t_plain = cuda_ms(tp, 2)
    rows = [_row(tick_key, got[tick_key], errs, t_ms, t_plain, tb)]
    print(f"[full {mode}] tick kernel {tick_key} {t_ms:.4f} ms: "
          f"{100 * t_ms / ms_tick:.2f}% of the median tick "
          f"({ms_tick:.3f} ms) [{name}]")
    record = dict(earlies=earlies, rows=rows_before_verdict,
                  moms=moms_before_verdict, sims=sims_before_verdict,
                  verdicts={j: _verdict_key(d) for j, d in verdicts.items()},
                  ms_tick=ms_tick)
    if mode == "distance":
        # the verdict kernel's row comes from the point run
        print(f"[full {mode}] K3 {t_ms:.4f} ms (plain {t_plain:.2f} ms, "
              f"bound {max(tb):.4f} ms) [{name}]")
        return rows, record

    xs = torch.tensor(xs_np, device=dev)
    xv = torch.tensor(xv_np, device=dev)
    xlens = torch.tensor(xl_np, device=dev)
    folds = [dtw.query_moments(q) for q in queries[:n_fin]]
    sx = torch.tensor([f[0] for f in folds], device=dev)
    sxx = torch.tensor([f[1] for f in folds], device=dev)
    vst = torch.tensor(np.asarray(
        [dtw.query_var_moments(queries[i], variances[i]) for i in
         range(n_fin)] if prob else np.zeros((n_fin, 3)), np.float32),
        device=dev)
    labels = np.asarray(bank.labels)
    cells2 = int(xlens.sum()) * int(lengths.sum())
    verdict_keys = [verdict_key] + (["K6"] if mode == "approx" else [])
    for key in verdict_keys:
        vn = {"K2": 3, "K5": 6, "K6": 4}[key]
        if key == "K2":
            vargs = (xs, xlens, bank_t, lengths, sx, sxx)
            vk = lambda: score.score_bank_offline(*vargs)  # noqa: E731
            vp = lambda: score.score_bank_offline_plain(  # noqa: E731
                *vargs)
        else:
            vargs = (xs, xv, xlens, bank_t, lengths, sx, sxx, vst)
            ap = key == "K6"
            vk = lambda: score.score_bank_offline_var(  # noqa: E731
                *vargs, threshold=svc.threshold, approx=ap)
            vp = lambda: score.score_bank_offline_var_plain(  # noqa: E731
                *vargs, threshold=svc.threshold, approx=ap)
        outk, outp = vk(), vp()
        e2 = max(errs.diff(key, outk[0], outp[0]),
                 errs.diff(key, outk[-1], outp[-1]))
        assert e2 <= SMOOTH_TOL, f"full-width {key}: max abs err {e2}"
        if key != "K2":
            ep2 = errs.diff(key, outk[1], outp[1])
            assert ep2 <= PROB_TOL, f"full-width {key}: probability {ep2}"
        if key == verdict_key:
            # the service's verdicts are the per-workload maxima of the
            # verdict kernel's scores, and its probability the leader's
            for i in range(n_fin):
                row = outk[0][i].double().cpu().numpy()
                dec = verdicts[f"job{i}"]
                for w, v in dec.scores.items():
                    assert v == row[labels == w].max(), (i, w)
                if prob:
                    pr = outk[1][i].double().cpu().numpy()
                    lead = max(dec.scores, key=dec.scores.get)
                    assert dec.probability == pr[labels == lead].max()
        else:
            assert torch.equal(oracle[0], outk[0])
            assert torch.equal(oracle[1], outk[1])
        v_ms = cuda_ms(vk, 5)
        v_plain = cuda_ms(vp, 1)
        vbytes = 4 * ((2 if key != "K2" else 1) * n_fin * npad
                      + (6 if key != "K2" else 3) * n_fin + m * k + k
                      + (3 if key != "K2" else 2) * n_fin * k)
        vb = (1e3 * vbytes / mem_bps,
              1e3 * ops_per_cell(vn) * cells2 / dtw_ops)
        rows.append(_row(key, got[key], errs, v_ms, v_plain, vb))
    print(f"[full {mode}] " + "; ".join(
        f"{r['name'].split()[0]} {r['ms']:.4f} ms (plain "
        f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.4f} ms)"
        for r in rows) + f" [{name}]")
    return rows, record


def ladder(dev, name: str, exact: dict, tick_ms: dict, s_jobs: int = 256,
           k: int = 256, n_fin: int = 32, seed: int = 0,
           per_rung: int = 6) -> None:
    """The full-width exact-probability run of phase 7 (same traces,
    seed and shapes) under the overload ladder: ``latency=`` overrides
    walk it up one rung after every ``per_rung`` ticks (window 1, EWMA
    alpha 1, patience 1, no cool-down), through rungs 0 (K4, six
    channels), 1 (``approx_prob``: K4 with four channels over
    ``moms[:4]``), 2 (``exact_score``: K1 over ``moms[:3]``) and 3
    (``distance_only``: K3).  Each kernel must launch once a tick of its
    rung; the 32 verdicts (K5) must be bitwise the unloaded run's
    ``exact`` and the early decisions a subset of its.  ``tick_ms``
    holds the four tick kernels' times (phases 7 and 10, by table key):
    each rung's kernel is printed as a share of the rung's median
    tick."""
    from repro_torch.serve.overload import OverloadConfig
    from repro_torch.serve.tuning import TuningService
    c, n_ticks = 16, 4 * per_rung
    qlen = n_ticks * c
    bank, queries, variances = full_inputs("exact", s_jobs, k, qlen, seed)
    cfg = OverloadConfig(target_p99=1.0, window=1, ewma_alpha=1.0,
                         patience=1, cooldown=10 ** 6, max_rung=3)
    svc = TuningService(bank, slots=s_jobs, device=dev, min_probability=0.5,
                        prob_mode="exact", overload=cfg)
    for i in range(s_jobs):
        svc.submit(f"job{i}", expected_len=qlen)
    torch.cuda.synchronize()
    reset_counts()
    rungs, tick_s, earlies = [], [], {}
    for t in range(n_ticks):
        for i in range(s_jobs):
            sl = slice(t * c, (t + 1) * c)
            svc.push(f"job{i}", queries[i, sl], variance=variances[i, sl])
        rungs.append(svc.rung)
        t0 = time.perf_counter()
        out = svc.tick(latency=10.0 if t % per_rung == per_rung - 1
                       else 0.0)
        torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t0)
        earlies.update({j: (d.matched, d.corr, d.decided_at_fraction)
                        for j, d in out.items() if d is not None})
    verdicts = svc.finish_many([f"job{i}" for i in range(n_fin)])
    torch.cuda.synchronize()
    got = counts()
    assert rungs == [r for r in range(4) for _ in range(per_rung)], rungs
    want = {key: 0 for key in got}
    want.update({"K4-exact": per_rung, "K4-approx": per_rung,
                 "K1": per_rung, "K3": per_rung, "K5": 1})
    assert got == want, ("ladder", got, want)
    assert svc.dispatch_count == n_ticks and svc.worst_rung == 3
    assert svc.overload_ticks == 3 * per_rung
    assert all(j.degraded_level == 2 for j in svc._jobs.values())
    for jid, d in verdicts.items():
        assert _verdict_key(d) == exact["verdicts"][jid], jid
    assert set(earlies.items()) <= set(exact["earlies"].items())
    ms = [1e3 * float(np.median(tick_s[r * per_rung:(r + 1) * per_rung]))
          for r in range(4)]
    print(f"[ladder] exact service, {s_jobs} jobs x K={k} x M=360: rungs "
          f"0-3 x {per_rung} ticks, median ms/tick by rung "
          + " / ".join(f"{v:.3f}" for v in ms)
          + f"; launches { {key: n for key, n in got.items() if n} }; "
          f"{len(earlies)} early decisions (unloaded: "
          f"{len(exact['earlies'])}, a superset); {n_fin} verdicts bitwise "
          f"the unloaded run's [{name}]")
    rung_keys = ("K4-exact", "K4-approx", "K1", "K3")
    print("[ladder] tick kernel share of the median tick by rung: "
          + "; ".join(f"{r} {key} {tick_ms[key]:.4f} / {v:.3f} ms = "
                      f"{100 * tick_ms[key] / v:.2f}%"
                      for r, (key, v) in enumerate(zip(rung_keys, ms)))
          + f" [{name}]")


def chaos_phase(dev, bank, point) -> None:
    """Retry, breaker and chaos at the paper scenario's size: exim (first
    parameter set) against the paper bank, with a fault plan that fails
    every dispatch for the first ``burst`` ticks, a retry policy that
    never sleeps and a circuit breaker.  While the faults last the
    breaker opens (its half-open probes fail) and the fallback serves:
    the same dispatch without the chaos consult, so K1 launches once for
    every dispatch the service counts, degraded or not, and no plain
    version runs on the card.  Once the plan is removed the breaker
    re-closes.  Decisions, early and final, must be bitwise the
    fault-free run's (phase 6)."""
    from repro_torch import mrsim
    from repro_torch.runtime.chaos import FaultPlan
    from repro_torch.runtime.retry import CircuitBreaker, RetryPolicy
    from repro_torch.serve.tuning import TuningService
    burst = 8
    p = mrsim.paper_param_sets()[0]
    br = CircuitBreaker(fail_threshold=2, cooldown=2, probe_interval=2,
                        seed=0)
    plan = FaultPlan(seed=0, dispatch_fail_rate=1.0)
    svc = TuningService(bank, band=16, threshold=0.85, margin=0.02,
                        stable_ticks=3, min_fraction=0.15, denoise=True,
                        device=dev, breaker=br, chaos=plan,
                        retry_policy=RetryPolicy(max_retries=1,
                                                 base_delay=0.0, seed=0,
                                                 sleep=lambda s: None))
    q = mrsim.simulate_cpu_series("exim", p, run=1, dt=0.25)
    reset_counts()
    svc.submit("exim", expected_len=len(q))
    early, walk = None, []
    for t, chunk in enumerate(mrsim.iter_cpu_series("exim", p, run=1,
                                                    chunk=8, dt=0.25)):
        if t == burst:
            assert br.engaged and br.opened_count >= 1 and svc.degraded
            assert counts()["K1"] == svc.dispatch_count \
                == svc.degraded_dispatch_count == burst
            svc.chaos = None
        svc.push("exim", chunk)
        d = svc.tick().get("exim")
        early = early or d
        walk.append(br.state[0])
    final = svc.finish("exim")
    k1_after = counts()["K1"] - burst
    assert br.state == br.CLOSED and br.reclosed_count >= 1
    assert not svc.degraded and k1_after > 0 and counts()["K2"] == 1
    assert counts()["K1"] == svc.dispatch_count
    pe, pf = point[0]
    assert (early.matched, early.corr, early.decided_at_fraction) == \
        (pe.matched, pe.corr, pe.decided_at_fraction)
    assert (final.matched, final.corr, final.scores) == \
        (pf.matched, pf.corr, pf.scores)
    print(f"[chaos] {plan.injected_failures} injected failures, "
          f"{svc.retry_count} retries; breaker opened {br.opened_count}x, "
          f"re-closed {br.reclosed_count}x (states by tick: "
          f"{''.join(walk)}); {svc.degraded_dispatch_count} degraded "
          f"dispatches served by K1, {k1_after} K1 launches after the "
          f"burst, {svc.dispatch_count} dispatches in all; early "
          f"{early.matched}@{early.fraction_seen:.2f} and final "
          f"{final.matched} bitwise the fault-free run's")


def multitenant_phase(dev, bank) -> None:
    """Two tenants over the paper bank's halves (the wordcount and the
    terasort references), each streaming exim at every paper parameter
    set: every decision equals that of a separate service over the
    tenant's half, and the front's dispatches are their sum."""
    from repro_torch import mrsim
    from repro_torch.core.database import SeriesBank
    from repro_torch.serve.tuning import MultiTenantTuningService, \
        TuningService
    h = len(bank) // 2
    halves = {"A": SeriesBank(bank.series[:h], bank.lengths[:h],
                              bank.labels[:h]),
              "B": SeriesBank(bank.series[h:], bank.lengths[h:],
                              bank.labels[h:])}
    kw = dict(band=16, threshold=0.85, margin=0.02, stable_ticks=3,
              min_fraction=0.15, denoise=True, device=dev)
    reset_counts()
    front = MultiTenantTuningService(halves, **kw)
    solo = {t: TuningService(b, **kw) for t, b in halves.items()}
    streams = {}
    for j, p in enumerate(mrsim.paper_param_sets()):
        q = mrsim.simulate_cpu_series("exim", p, run=1, dt=0.25)
        for t in halves:
            jid = f"{t}{j}"
            front.submit(jid, expected_len=len(q), tenant=t)
            solo[t].submit(jid, expected_len=len(q))
            streams[jid] = mrsim.iter_cpu_series("exim", p, run=1, chunk=8,
                                                 dt=0.25)
    n_ticks = 0
    while streams:
        done = []
        for jid, it in streams.items():
            chunk = next(it, None)
            if chunk is None:
                done.append(jid)
            else:
                front.push(jid, chunk)
                solo[jid[0]].push(jid, chunk)
        if done:
            got = front.finish_many(done)
            for jid in done:
                want = solo[jid[0]].finish(jid)
                assert got[jid] == want, jid
                del streams[jid]
        got = front.tick()
        want = {}
        for svc in solo.values():
            want.update(svc.tick())
        assert got == want
        n_ticks += 1
    assert front.dispatch_count == sum(s.dispatch_count
                                       for s in solo.values())
    assert front.engine("A").dispatch_count == solo["A"].dispatch_count
    c = counts()
    assert c["K1"] == 2 * front.dispatch_count
    print(f"[multi-tenant] 2 tenants x 4 exim jobs over {n_ticks} ticks: "
          f"decisions equal to separate services', dispatches "
          f"{front.dispatch_count} = "
          f"{' + '.join(str(s.dispatch_count) for s in solo.values())}")


def paper_matching(dev, errs: ErrLog, name: str):
    """The offline matching phase at the paper's size (phase 14): Table 1
    (``tests/golden/table1_similarity.json``, a data file) through the
    scalar ``similarity`` (K7 with K = 1 and a host backtrack) and both
    ``similarity_bank`` engines (K2; K7 and host backtracks), each within
    TABLE1_TOL of the golden; ``match_application`` on the same series
    through one K2 pairs launch, its scores bitwise K2's Table-1 diagonal;
    and the quickstart scenario (``AutoTuner(band=8)``, wordcount and
    terasort profiled over the paper's parameter sets, exim run 1
    matched), which must match wordcount and transfer its config.
    Returns K2 pairs' kernel table row, timed on the match's inputs (the
    kernel's device time, from the profiler)."""
    from repro_torch import mrsim
    from repro_torch.core import AutoTuner, ReferenceDB
    from repro_torch.core import dtw
    from repro_torch.core.database import pack_series
    from repro_torch.core.similarity import (match_application, similarity,
                                             similarity_bank)
    from repro_torch.kernels.dtw import score
    with open(os.path.join(ROOT, "tests", "golden",
                           "table1_similarity.json")) as f:
        golden = json.load(f)
    band = golden["band"]
    psets = mrsim.paper_param_sets()
    assert [p.as_dict() for p in psets] == golden["param_sets"]
    queries = [mrsim.simulate_cpu_series(golden["query_app"], p,
                                         run=golden["query_run"])
               for p in psets]
    refs = {app: [mrsim.simulate_cpu_series(app, p) for p in psets]
            for app in golden["similarity"]}
    n = len(psets)
    before = counts()
    tables = {"scalar": {}, "K2": {}, "K7": {}}
    for app, rs in refs.items():
        tables["scalar"][app] = [[similarity(queries[j], rs[i],
                                             preprocess=True, band=band,
                                             device=dev)
                                  for j in range(n)] for i in range(n)]
        for key, mp in (("K2", False), ("K7", True)):
            cols = [similarity_bank(queries[j], rs, preprocess=True,
                                    band=band, matrix_path=mp, device=dev)
                    for j in range(n)]
            tables[key][app] = [[float(cols[j][i]) for j in range(n)]
                                for i in range(n)]
    torch.cuda.synchronize()
    napps = len(refs)
    launched(before, K7=napps * n * n + napps * n, K2=napps * n)
    engines = {"scalar": "similarity (K7, K=1)",
               "K2": "similarity_bank (K2)",
               "K7": "similarity_bank(matrix_path=True) (K7)"}
    for key, table in tables.items():
        err = max(float(np.abs(np.asarray(table[app])
                               - np.asarray(golden["similarity"][app])).max())
                  for app in table)
        assert err <= TABLE1_TOL, f"Table 1 through {key}: max err {err}"
        print(f"[paper matching] Table 1 through {engines[key]}: max abs "
              f"err {err:.3g} against the golden (tol {TABLE1_TOL:g})")
    reset_counts()
    res = match_application(queries, refs, band=band, device=dev)
    torch.cuda.synchronize()
    pairs_launches = counts()["K2-pairs"]
    launched({key: 0 for key in KERNELS}, K2_pairs=1)
    for app in refs:
        diag = [tables["K2"][app][j][j] for j in range(n)]
        assert res.scores[app] == diag, (app, res.scores[app], diag)
    assert res.best == "wordcount", res
    print(f"[paper matching] match_application (one K2 pairs launch): "
          f"best={res.best} wins={dict(res.wins)}; scores bitwise K2's "
          f"Table-1 diagonal")
    # the quickstart scenario (examples/quickstart.py)
    db = ReferenceDB()
    tuner = AutoTuner(db, band=8, device=dev)
    for app in ("wordcount", "terasort"):
        for p in psets:
            tuner.profile(app, p.as_dict(), mrsim.simulate_cpu_series(app, p))
    db.set_best_config("wordcount", {"mappers": 21, "reducers": 30,
                                     "split_mb": 10, "input_mb": 80}, 1.0)
    db.set_best_config("terasort", {"mappers": 42, "reducers": 33,
                                    "split_mb": 20, "input_mb": 60}, 1.0)
    before = counts()
    dec = tuner.match("exim-mainlog", mrsim.simulate_cpu_series(
        "exim", psets[0], run=1))
    torch.cuda.synchronize()
    launched(before, K2=1)
    assert dec.matched == "wordcount" and dec.corr >= 0.9, dec
    assert dec.config == db.best_config("wordcount"), dec.config
    print(f"[paper matching] quickstart: matched={dec.matched} "
          f"corr={dec.corr:.6f}, config {dec.config} transferred")

    # K2 pairs timed on the match's own inputs (P = 8 pairs)
    qbank = pack_series(queries).preprocessed()
    names = list(refs)
    rbank = pack_series([refs[a][j] for a in names for j in range(n)]
                        ).preprocessed()
    qidx = np.tile(np.arange(n), len(names))
    xs, xl = qbank.series[qidx], qbank.lengths[qidx]
    folds = [dtw.query_moments(xs[i, :xl[i]]) for i in range(len(qidx))]
    args = (torch.tensor(xs, device=dev), torch.tensor(xl, device=dev),
            torch.tensor(rbank.series.T.copy(), device=dev),
            torch.tensor(rbank.lengths, device=dev),
            torch.tensor([f[0] for f in folds], device=dev),
            torch.tensor([f[1] for f in folds], device=dev))
    outk = score.score_pairs(*args, band=band)
    outp = score.score_pairs_plain(*args, band=band)
    e = max(errs.diff("K2-pairs", outk[0], outp[0]),
            errs.diff("K2-pairs", outk[1], outp[1]))
    assert e <= SMOOTH_TOL, f"K2 pairs on the match's inputs: {e}"
    assert torch.equal(outk[0].double().cpu(),
                       torch.tensor([res.scores[a][j] for a in names
                                     for j in range(n)],
                                    dtype=torch.float64))
    mem_bps, dtw_ops = card_peaks(name)[0], dtw_op_rate(name)
    p_, nq = xs.shape
    m = rbank.series.shape[1]
    cells = band_cells(xl, rbank.lengths, band)
    pbytes = 4 * (p_ * nq + p_ + m * p_ + p_ + 2 * p_ + 2 * p_)
    pb = (1e3 * pbytes / mem_bps, 1e3 * ops_per_cell(3) * cells / dtw_ops)
    # an 8-pair launch: back-to-back calls measure the host's launch path
    # as much as the kernel, so the row takes the kernel's device time
    t_ev = cuda_ms(lambda: score.score_pairs(*args, band=band), 20)
    t_dev = device_ms(lambda: score.score_pairs(*args, band=band), 20,
                      "score_pairs_kernel")
    t_plain = cuda_ms(lambda: score.score_pairs_plain(*args, band=band), 2)
    t_ms = t_ev if t_dev[0] is None else t_dev[0]
    print(f"[paper matching] K2 pairs (P={p_}, N={nq}, M={m}, band {band}) "
          f"device time a launch (profiler) {_dev_str(t_dev)}, back-to-back "
          f"calls (CUDA events) {t_ev:.4f} ms (plain {t_plain:.2f} ms, "
          f"bound {max(pb):.5f} ms) [{name}]")
    return _row("K2-pairs", pairs_launches, errs, t_ms, t_plain, pb)


def full_matching(dev, errs: ErrLog, name: str, n_q: int = 8, k: int = 256,
                  qlen: int = 384, seed: int = 0):
    """The offline matching phase at full width (phase 15): the
    throughput bank (K = 256, M = 360) and ``n_q`` 384-sample queries of
    the point-mode run.  ``similarity_bank(matrix_path=True)`` for each
    query (one K7 launch and 256 host backtracks each) must lie within
    MATRIX_FREE_TOL of the matrix-free K2 scores; one
    ``OnlineMatcher(collect_rows=True)`` job streams query 0 in 24 chunks
    of 16 (24 K7 launches, each resumed from the carried row): its rows
    must be bitwise the one-shot K7 matrix, and its ``final_scores``
    (the host backtrack of those rows, one-pass moments) within
    FINAL_TOL of the matrix path's two-pass score.  Launch counts are
    audited around the run; K7 is then timed (the full matrix and one
    16-row chunk) beside its plain version and its bound, and the host
    backtrack of one query is timed.  Returns K7's kernel table row."""
    from repro_torch.core import dtw
    from repro_torch.core.similarity import _warp_corr, similarity_bank
    from repro_torch.core.tuner import OnlineMatcher
    from repro_torch.kernels.dtw import matrix
    bank, queries, _ = full_inputs("point", n_q, k, qlen, seed)
    m = bank.series.shape[1]
    assert m == 360, m
    c = 16
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    mat = np.stack([similarity_bank(q, bank, matrix_path=True, device=dev)
                    for q in queries])
    mat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    free = np.stack([similarity_bank(q, bank, device=dev) for q in queries])
    free_s = time.perf_counter() - t0
    om = OnlineMatcher(bank, collect_rows=True, device=dev)
    t0 = time.perf_counter()
    for lo in range(0, qlen, c):
        om.extend(queries[0, lo:lo + c])
    stream_s = time.perf_counter() - t0
    final = om.final_scores()
    torch.cuda.synchronize()
    got = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {key: 0 for key in got}
    want.update(K7=n_q + qlen // c, K2=n_q)
    assert got == want, ("full matching", got, want)
    e_free = float(np.abs(mat - free).max())
    assert e_free <= MATRIX_FREE_TOL, f"matrix path vs K2: {e_free}"
    D = dtw.dtw_matrix_bank(queries[0], bank.series, bank.lengths,
                            device=dev)
    Dh = D.cpu().numpy()
    rows = om._rows.view()
    assert np.array_equal(rows, Dh.transpose(1, 0, 2)), \
        "streamed rows differ from the one-shot matrix"
    e_fin = float(np.abs(final - mat[0]).max())
    assert e_fin <= FINAL_TOL, f"final_scores vs matrix path: {e_fin}"
    # the host backtrack of one query's 256 matrices, alone
    t0 = time.perf_counter()
    for r in range(k):
        l = int(bank.lengths[r])
        _warp_corr(queries[0], bank.series[r, :l], Dh[r, :, :l])
    bt_s = time.perf_counter() - t0
    print(f"[full matching] {n_q} queries x K={k} x M={m}, N={qlen}: "
          f"matrix path {1e3 * mat_s / n_q:.1f} ms a query (one K7 launch, "
          f"host backtracks {1e3 * bt_s:.1f} ms of it), matrix-free "
          f"{1e3 * free_s / n_q:.2f} ms a query; scores within "
          f"{e_free:.3g} (tol {MATRIX_FREE_TOL:g}); OnlineMatcher "
          f"{qlen // c} chunks of {c} in {1e3 * stream_s:.1f} ms, rows "
          f"bitwise the one-shot matrix, final_scores within {e_fin:.3g} "
          f"of the matrix path (tol {FINAL_TOL:g}); device memory peak "
          f"{peak_gb:.3f} GB ({base_gb:.3f} GB in use before); launches "
          f"{ {key: v for key, v in got.items() if v} } [{name}]")

    ys = torch.tensor(bank.series, device=dev)
    lens = torch.tensor(bank.lengths, device=dev)
    x = torch.tensor(queries[0], device=dev)
    qn = torch.full((k,), qlen, dtype=torch.int32, device=dev)
    rk, _ = matrix.dtw_rows(x, ys, qn, lens)
    rp, _ = matrix.dtw_rows_plain(x, ys, qn, lens)
    errs.diff("K7", rk, rp)
    assert torch.equal(rk, rp) and torch.equal(rk, D), "full-width K7"
    row = rk[:, qlen // 2 - 1].contiguous()
    xc = x[qlen // 2: qlen // 2 + c].contiguous()
    ck, lk = matrix.dtw_rows(xc, ys, qn, lens, row=row, n0=qlen // 2)
    assert torch.equal(ck, rk[:, qlen // 2: qlen // 2 + c])
    assert torch.equal(lk, rk[:, qlen // 2 + c - 1])
    mem_bps, dtw_ops = card_peaks(name)[0], dtw_op_rate(name)
    kbytes = 4 * (k * qlen * m + qlen + k * m + 2 * k)
    kb = (1e3 * kbytes / mem_bps, 1e3 * ops_per_cell(0) * k * qlen * m
          / dtw_ops)
    # the full matrix, one resumed 16-row chunk, the last row only
    calls = (lambda: matrix.dtw_rows(x, ys, qn, lens),
             lambda: matrix.dtw_rows(xc, ys, qn, lens, row=row,
                                     n0=qlen // 2),
             lambda: matrix.dtw_rows(x, ys, qn, lens, collect_rows=False))
    t_ms, t_chunk, t_last = (cuda_ms(f, 20) for f in calls)
    d_ms, d_chunk, d_last = (device_ms(f, 20, "dtw_matrix_kernel")
                             for f in calls)
    t_plain = cuda_ms(lambda: matrix.dtw_rows_plain(x, ys, qn, lens), 1)
    print(f"[full matching] K7 full matrix {t_ms:.4f} ms (plain "
          f"{t_plain:.2f} ms, bound {max(kb):.4f} ms by "
          f"{'bytes' if kb[0] >= kb[1] else 'operations'}); the same "
          f"writing the last row only {t_last:.4f} ms; one resumed 16-row "
          f"chunk {t_chunk:.4f} ms (back-to-back calls, CUDA events); "
          f"device time a launch (profiler): full {_dev_str(d_ms)}, chunk "
          f"{_dev_str(d_chunk)}, last row {_dev_str(d_last)}; the parent's "
          f"kernel (PERF.md): full {PARENT_MS['K7']}, chunk "
          f"{PARENT_MS['K7-chunk']}, last row {PARENT_MS['K7-last']} ms; "
          f"the matrix path's query {1e3 * mat_s / n_q:.1f} ms, K7 "
          f"{100 * t_ms / (1e3 * mat_s / n_q):.2f}% of it [{name}]")
    return _row("K7", got["K7"], errs, t_ms, t_plain, kb)


def _close(got: torch.Tensor, want: torch.Tensor, rtol: float,
           atol: float) -> bool:
    """|got - want| <= atol + rtol |want| elementwise (float64)."""
    g, w = got.double(), want.double()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


def check_k8(dev, errs: ErrLog) -> None:
    """K8 against its plain version (and both against the float64
    oracle) on the reference's IIR test shapes (tests/test_kernels.py),
    the paper's order 6 at 130 x 512, and every order 1-8 (each a
    template instantiation); then the ring's edges: one series (B = 1) of
    3600 samples, T = 1, T shorter than a 64-sample tile (40: whole
    16-byte copies; 13: 4-byte copies) and x one element into its storage
    (4-byte copies at T = 512): bitwise expected, the differing elements
    counted, every difference within IIR_TOL."""
    from repro_torch.core.filters import cheby1_design
    from repro_torch.kernels.iir import kernel, lfilter_ref
    cases = [(6, 0.125, 3, 100, False), (4, 0.3, 130, 64, False),
             (2, 0.5, 1, 257, False), (6, 0.125, 130, 512, False)]
    cases += [(order, 0.3, 37, 70, False) for order in range(1, 9)]
    cases += [(6, 0.125, 1, 3600, False), (6, 0.125, 37, 1, False),
              (4, 0.3, 37, 40, False), (4, 0.3, 5, 13, False),
              (6, 0.125, 130, 512, True)]
    for order, cutoff, bsz, t, at_offset in cases:
        b, a = cheby1_design(order, 1.0, cutoff)
        x = np.random.default_rng(bsz * t).normal(size=(bsz, t)) \
            .astype(np.float32)
        bt, at = kernel.coeffs(b, a, dev)
        xt = torch.tensor(x, device=dev)
        if at_offset:
            xt = _at_offset(xt)
        before = counts()
        yk = kernel.iir_filter(bt, at, xt)
        torch.cuda.synchronize()
        launched(before, K8=1)
        yp = kernel.iir_filter_plain(bt, at, xt)
        e = errs.diff("K8", yk, yp)
        nd = int((yk != yp).sum())
        e_ref = float(np.abs(yk.cpu().numpy() - lfilter_ref(b, a, x)).max())
        assert e <= IIR_TOL and e_ref <= IIR_TOL, \
            f"K8 order {order} {bsz}x{t}: {e} vs plain, {e_ref} vs oracle"
        print(f"[K8] order {order} cutoff {cutoff} B={bsz} T={t}"
              f"{' (one element into storage)' if at_offset else ''}: {nd} of "
              f"{yk.numel()} elements differ from the plain version (max "
              f"{e:.3g}), oracle within {e_ref:.3g} (tol {IIR_TOL:g})")


def _f32_once(exact: Fraction) -> np.float32:
    """The float32 nearest the rational ``exact``, ties to even: one
    rounding (normal range)."""
    if exact == 0:
        return np.float32(0.0)
    mag = abs(exact)
    e = mag.numerator.bit_length() - mag.denominator.bit_length()
    if Fraction(2) ** e > mag:
        e -= 1                              # 2^e <= |exact| < 2^(e + 1)
    unit = Fraction(2) ** (e - 23)          # the float32 spacing there
    return np.float32(math.copysign(float(round(mag / unit) * unit), exact))


def _df2t_witness(b, a, x):
    """df2t's recurrence (kernels/iir/kernel.py) on one float32 series,
    step by step on the host, two ways: each fused multiply-add rounded
    once from the exact rational (``__fmaf_rn``, K8's) and through
    float64 (``_fma``, the plain version's).  Returns (y once, y through
    float64, the first fma whose two roundings differ: (t, which, p, q,
    r, once, float64) or None)."""
    order = len(b) - 1
    zero = np.float32(0.0)
    out, first = [], None
    for twice in (False, True):
        z = [zero] * order
        y = np.empty(len(x), np.float32)
        for t, xt in enumerate(x):
            def fma(p, q, r, which):
                nonlocal first
                f64 = np.float32(np.float64(p) * np.float64(q)
                                 + np.float64(r))
                if twice:
                    return f64
                once = _f32_once(Fraction(float(p)) * Fraction(float(q))
                                 + Fraction(float(r)))
                if first is None and once != f64:
                    first = (t, which, p, q, r, once, f64)
                return once
            yt = fma(b[0], xt, z[0], "y")
            z = [fma(b[i + 1], xt, -(a[i + 1] * yt), f"z{i}")
                 + (z[i + 1] if i + 1 < order else zero)
                 for i in range(order)]
            y[t] = yt
        out.append(y)
    return out[0], out[1], first


def full_iir(dev, errs: ErrLog, name: str, bsz: int = 8192, t: int = 3600,
             seed: int = 16):
    """K8 at full width (phase 16): the paper's order-6 Chebyshev
    de-noise (1 dB ripple, cutoff 0.125) over a reference DB of ``bsz``
    series x ``t`` samples (an hour of 1 Hz CPU utilization per profiled
    run) through ``kernels.iir.lfilter_batched``: one launch, held to the
    plain version (differing elements counted, each within IIR_TOL) and,
    on 64 series, both to the float64 oracle within IIR_ORACLE_TOL; timed
    beside the plain version, the bound and the parent's time, with a
    launch's device time from ``torch.profiler``; its SASS must hold
    asynchronous copies (LDGSTS).  Returns K8's kernel table row."""
    from repro_torch.core import filters
    from repro_torch.kernels.iir import kernel, lfilter_batched, lfilter_ref
    b, a = filters.cheby1_design(filters.DEFAULT_ORDER,
                                 filters.DEFAULT_RIPPLE_DB,
                                 filters.DEFAULT_CUTOFF)
    order = len(b) - 1
    # utilization-like: a per-series level and phase swing, square-ish
    # map/reduce waves, sampling noise; clipped to [0, 1]
    rng = np.random.default_rng(seed)
    tt = np.arange(t, dtype=np.float32)[None, :]
    level = rng.uniform(0.2, 0.7, (bsz, 1)).astype(np.float32)
    period = rng.uniform(120, 900, (bsz, 1)).astype(np.float32)
    wave = np.sign(np.sin(2 * np.pi * tt / period)).astype(np.float32)
    x = np.clip(level + 0.2 * wave + 0.08 * rng.standard_normal(
        (bsz, t), dtype=np.float32), 0, 1).astype(np.float32)
    xt = torch.tensor(x, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    y = lfilter_batched(b, a, xt, device=dev)
    torch.cuda.synchronize()
    got = counts()
    assert got == {**{key: 0 for key in got}, "K8": 1}, got
    bt, at = kernel.coeffs(b, a, dev)
    yp = kernel.iir_filter_plain(bt, at, xt)
    e = errs.diff("K8", y, yp)
    nd = int((y != yp).sum())
    nrows = int((y != yp).any(dim=1).sum())
    assert e <= IIR_TOL, f"full-width K8 vs plain: {e}"
    # witness the differing series (up to 4): K8's row must be the
    # recurrence with each fma rounded once, the plain version's the one
    # rounded through float64, and the two must part at a double rounding
    bn, an = bt.cpu().numpy(), at.cpu().numpy()
    for i in torch.nonzero((y != yp).any(dim=1)).flatten().tolist()[:4]:
        once, twice, first = _df2t_witness(bn, an, x[i])
        yi, ypi = y[i].cpu().numpy(), yp[i].cpu().numpy()
        t_out = int(np.flatnonzero(yi != ypi)[0])
        assert first is not None and first[0] <= t_out, (i, first, t_out)
        assert np.array_equal(yi, once), f"K8 series {i}: not fmaf's"
        assert np.array_equal(ypi, twice), f"plain series {i}: not _fma's"
        t_fma, which, p, q, r, f_once, f_f64 = first
        print(f"[full IIR] series {i}: at t={t_fma} the fma of {which} "
              f"({float(p)!r} * {float(q)!r} + {float(r)!r}) rounds to "
              f"{float(f_once)!r} once and to {float(f_f64)!r} through "
              f"float64; outputs part at t={t_out}; K8's row is bitwise "
              f"the recurrence rounded once, the plain version's the one "
              f"through float64")
    sub = lfilter_ref(b, a, x[:64])
    e_ref = max(float(np.abs(y[:64].cpu().numpy() - sub).max()),
                float(np.abs(yp[:64].cpu().numpy() - sub).max()))
    assert e_ref <= IIR_ORACLE_TOL, f"full-width K8 vs the oracle: {e_ref}"
    assert torch.isfinite(y).all()
    mem_bps, f32_flops, _, _ = card_peaks(name)
    kb = (1e3 * 4 * (2 * bsz * t + 2 * (order + 1)) / mem_bps,
          1e3 * (2 + 4 * order) * bsz * t / f32_flops)
    ldgsts = sass_count(kernel.LIB, "LDGSTS")
    assert ldgsts > 0, "no LDGSTS (cp.async) in K8's SASS"
    t_ms = cuda_ms(lambda: kernel.iir_filter(bt, at, xt), 20)
    t_dev = device_ms(lambda: kernel.iir_filter(bt, at, xt), 20,
                      "iir_kernel")
    t_plain = cuda_ms(lambda: kernel.iir_filter_plain(bt, at, xt), 1)
    print(f"[full IIR] order {order}, B={bsz} x T={t}: one launch; {nd} of "
          f"{y.numel()} elements, in {nrows} of {bsz} series, differ from "
          f"the plain version (max {e:.3g}, tol {IIR_TOL:g}); 64 series "
          f"within {e_ref:.3g} of the float64 oracle (tol "
          f"{IIR_ORACLE_TOL:g}); K8 ({ldgsts} LDGSTS in its SASS) "
          f"{t_ms:.4f} ms, device {_dev_str(t_dev)} (the parent's "
          f"{PARENT_MS['K8']} ms, PERF.md; plain {t_plain:.2f} ms, "
          f"bound {max(kb):.4f} ms by "
          f"{'bytes' if kb[0] >= kb[1] else 'operations'}) [{name}]")
    return _row("K8", got["K8"], errs, t_ms, t_plain, kb)


def _attn_inputs(gen, dev, b, h, kv, s, t, dh, dv, dtype):
    return (torch.randn((b, h, s, dh), generator=gen, device=dev).to(dtype),
            torch.randn((b, kv, t, dh), generator=gen, device=dev).to(dtype),
            torch.randn((b, kv, t, dv), generator=gen, device=dev).to(dtype))


def _at_offset(x: torch.Tensor) -> torch.Tensor:
    """x's values in a contiguous view that starts one element into its
    storage (not 16-byte aligned): the element-wise loads of K9 and K10,
    K8's 4-byte copies."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:].copy_(x.reshape(-1))
    return buf[1:].view(x.shape)


def _k9_key(dtype) -> str:
    """The kernel a K9 input dtype launches: bf16 the bf16 ``wgmma``
    one, f32 the split-TF32 one."""
    return "K9" if dtype == torch.bfloat16 else "K9-f32"


def check_k9(dev, errs: ErrLog) -> None:
    """K9 against its plain version on the reference's test shapes
    (tests/test_kernels.py: four f32 and bf16 cases, non-causal), S != T
    both ways (the top-left mask), dv != dh, dh 96 and 128, and tiles
    ragged against the kernels' 64 x 64 (S = T = 96); in bf16 also head
    dims padded in shared memory (dh 24, dv 48; dh 20, dv 12, whose rows
    are not whole 16-byte chunks), dh 128 and S != T non-causal; in f32
    also rows that are not whole 16-byte chunks (dh 18, dv 10, S != T
    both ways) and q, k, v that start one element into their storage
    (dh 64 and 18), which take the element-wise loads.  Each call
    launches the kernel of its dtype once."""
    from repro_torch.kernels.attention import kernel
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(1, 2, 2, 128, 128, 32, 32, 64, 64, True, f32),
             (2, 4, 2, 256, 256, 32, 32, 128, 128, True, f32),
             (1, 8, 1, 128, 128, 64, 64, 32, 64, True, f32),
             (2, 4, 4, 128, 128, 16, 16, 64, 32, True, bf16),
             (1, 2, 2, 64, 64, 16, 16, 32, 32, False, f32),
             (1, 4, 2, 64, 128, 16, 24, 32, 32, True, f32),
             (1, 4, 2, 128, 64, 16, 24, 64, 32, True, f32),
             (1, 4, 4, 256, 256, 96, 96, 128, 128, True, bf16),
             (1, 6, 2, 256, 256, 128, 128, 128, 128, True, f32),
             (1, 2, 1, 96, 96, 64, 48, 32, 32, True, f32),
             (1, 2, 1, 96, 96, 64, 64, 32, 32, False, bf16),
             (1, 4, 2, 128, 192, 24, 48, 64, 64, True, bf16),
             (1, 2, 1, 96, 96, 20, 12, 32, 32, True, bf16),
             (1, 6, 2, 256, 256, 128, 128, 128, 128, True, bf16),
             (1, 2, 2, 128, 320, 128, 128, 64, 64, False, bf16),
             (1, 2, 1, 96, 160, 18, 10, 32, 32, True, f32),
             (1, 4, 2, 128, 64, 18, 10, 64, 32, True, f32),
             # MLA's head (q, k 192 wide, v 128): ragged S = T, S != T
             # both ways, a GQA group and non-causal
             (1, 2, 2, 96, 96, 192, 128, 32, 32, True, bf16),
             (1, 2, 2, 96, 96, 192, 128, 32, 32, True, f32),
             (1, 4, 2, 128, 192, 192, 128, 64, 64, True, bf16),
             (1, 4, 2, 192, 128, 192, 128, 64, 64, True, f32),
             (1, 2, 2, 128, 128, 192, 128, 64, 64, False, bf16),
             (1, 2, 2, 128, 128, 136, 72, 64, 64, True, bf16),
             (1, 2, 2, 64, 64, 190, 126, 32, 32, True, bf16),
             (1, 2, 2, 64, 64, 190, 126, 32, 32, True, f32)]
    # f32 inputs one element into their storage
    offset = [(1, 4, 2, 128, 192, 64, 64, 64, 64, True, f32),
              (1, 2, 1, 96, 160, 18, 10, 32, 32, True, f32)]
    gen = torch.Generator(device=dev).manual_seed(17)
    for (b, h, kv, s, t, dh, dv, bq, bk, causal, dtype), at in \
            [(c, False) for c in cases] + [(c, True) for c in offset]:
        q, k, v = _attn_inputs(gen, dev, b, h, kv, s, t, dh, dv, dtype)
        if at:
            q, k, v = (_at_offset(x) for x in (q, k, v))
        before = counts()
        ok = kernel.flash_forward(q, k, v, bq, bk, causal)
        torch.cuda.synchronize()
        launched(before, **{_k9_key(dtype).replace("-", "_"): 1})
        assert ok.dtype == dtype
        op = kernel.flash_forward_plain(q, k, v, bq, bk, causal)
        e = _attn_diff(errs, ok, op,
                       f"K9 {(b, h, kv, s, t, dh, dv, causal, dtype, at)}")
        print(f"[K9] B={b} H={h} KV={kv} S={s} T={t} dh={dh} dv={dv} "
              f"causal={causal!s:5} {str(dtype)[6:]}"
              f"{' (one element into storage)' if at else ''}: max abs err "
              f"{e:.3g} ({_attn_limit(ok)}; mean |o| "
              f"{float(op.abs().mean()):.3g})")
    # the wrapper's limits: dh over 192 or dv over 128 raise, naming the
    # limit, and launch nothing
    for dh, dv, which in ((200, 128, "dh"), (192, 136, "dv")):
        q, k, v = _attn_inputs(gen, dev, 1, 2, 2, 64, 64, dh, dv,
                               torch.bfloat16)
        before = counts()
        try:
            kernel.flash_forward(q, k, v, 64, 64)
        except ValueError as err:
            assert f"head dim {which}" in str(err), str(err)
        else:
            raise AssertionError(f"K9 took dh = {dh}, dv = {dv}")
        launched(before)
        print(f"[K9] dh={dh} dv={dv}: refused ({which} over its limit)")


def _attn_limit(o: torch.Tensor) -> str:
    if o.dtype == torch.float32:
        return f"tol {ATTN_F32_TOL:g}"
    return (f"tol {ATTN_BF16_TOL:g} and one bf16 step: {BF16_ULP:g} |o| + "
            f"{ATTN_F32_TOL:g}")


def _attn_diff(errs: ErrLog, got, want, what: str, key=None) -> float:
    """Hold K9's o to the plain version's: float32 within ATTN_F32_TOL;
    bfloat16 within ATTN_BF16_TOL and within one bfloat16 step
    (BF16_ULP |o| + ATTN_F32_TOL).  The error goes to the table row
    ``key`` (the dtype's K9 row by default).  Returns the max abs err."""
    e = errs.diff(key or _k9_key(got.dtype), got, want)
    if got.dtype == torch.float32:
        ok = e <= ATTN_F32_TOL
    else:
        ok = e <= ATTN_BF16_TOL and _close(got, want, BF16_ULP, ATTN_F32_TOL)
    assert ok, f"{what}: max abs err {e} beyond {_attn_limit(got)}"
    return e


def _attn_layer(dev, q, k, v, what: str):
    """One layer through ``kernels.attention.flash_attention`` in bf16,
    then the same inputs in float32, each call with every count set to 0
    just before it and read just after (one launch of the dtype's
    kernel).  Returns (o, o32, bf16 counts, f32 counts)."""
    from repro_torch.kernels.attention import flash_attention
    torch.cuda.synchronize()
    outs = []
    for x in ((q, k, v), (q.float(), k.float(), v.float())):
        reset_counts()
        o = flash_attention(*x, device=dev)
        torch.cuda.synchronize()
        got = counts()
        key = _k9_key(x[0].dtype)
        assert got == {**{n: 0 for n in got}, key: 1}, (what, got)
        assert o.shape == x[0].shape[:3] + (x[2].shape[-1],)
        assert o.dtype == x[0].dtype and torch.isfinite(o.float()).all()
        outs += [o, got]
    return outs[0], outs[2], outs[1], outs[3]


def _attn_full(errs: ErrLog, q, k, v, o, o32, what: str) -> str:
    """A full-width bf16 K9 output ``o`` of (q, k, v) held to the plain
    version, and ``o32``, the same inputs through K9 in float32, held to
    the plain version in float32; returns the report."""
    from repro_torch.kernels.attention import kernel
    op = kernel.flash_forward_plain(q, k, v)
    e = _attn_diff(errs, o, op, what)
    mean = float(op.float().abs().mean())
    del op
    e32 = _attn_diff(errs, o32, kernel.flash_forward_plain(
        q.float(), k.float(), v.float()), what + " (f32)")
    return (f"max abs err {e:.3g} vs plain ({_attn_limit(o)}; mean |o| "
            f"{mean:.3g}); the same inputs in f32 {e32:.3g} "
            f"({_attn_limit(o32)})")


def _sdpa(q, k, v):
    """The one PyTorch call that computes K9's function (a yardstick,
    never on the port's path)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)


def sass_count(lib, opcode: str) -> int:
    """Instructions of ``opcode`` in the SASS of a built kernel
    library."""
    return sum(opcode in line for line in sass(lib).splitlines())


def full_attention(dev, errs: ErrLog, name: str, s: int = 4096,
                   seed: int = 17):
    """K9 at full width (phase 17): one layer of granite-20b's causal
    prefill (configs/granite_20b.py: 48 heads, kv 1, head dim 128) at
    B = 1, S = T = 4096 through ``kernels.attention.flash_attention`` in
    bf16 (one launch) and in float32 (the split-TF32 kernel, one
    launch), held to the plain version (bf16 within ATTN_BF16_TOL and one
    bf16 step, f32 within ATTN_F32_TOL), each timed beside the plain
    version, its bound and ``scaled_dot_product_attention`` on the same
    inputs; both kernels' SASS must hold HGMMA.  Then
    phi3-mini's MHA (configs/phi3_mini_3p8b.py: 32 heads, head dim 96) at
    S = 4096, checked the same way, untimed.  Returns the two kernel table
    rows."""
    from repro_torch.kernels.attention import kernel
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, h, kv, dh = 1, 48, 1, 128
    q, k, v = _attn_inputs(gen, dev, b, h, kv, s, s, dh, dh, torch.bfloat16)
    o, o32, got, got32 = _attn_layer(dev, q, k, v, "granite")
    report = _attn_full(errs, q, k, v, o, o32, "full-width K9")
    e_lib = float((_sdpa(q, k, v).double() - o.double()).abs().max())
    hgmma = sass_count(kernel.BF16_LIB, "HGMMA")
    assert hgmma > 0, "no HGMMA in the bf16 K9's SASS"
    hgmma32 = sass_count(kernel.LIB, "HGMMA")
    assert hgmma32 > 0, "no HGMMA in the f32 K9's SASS"
    pairs = s * (s + 1) // 2
    flops = 2 * (dh + dh) * pairs * b * h
    mem_bps, f32_flops, bf16_flops, tf32_flops = card_peaks(name)
    rows = []
    for x, key in (((q, k, v), "K9"),
                   ((q.float(), k.float(), v.float()), "K9-f32")):
        width = x[0].element_size()
        # f32: the three TF32 products of the split at the TF32 peak
        kb = (1e3 * width * (2 * b * h * s * dh + 2 * b * kv * s * dh)
              / mem_bps,
              1e3 * flops / bf16_flops if key == "K9"
              else 1e3 * 3 * flops / tf32_flops)
        t_ms = cuda_ms(lambda: kernel.flash_forward(*x), 5)
        t_plain = cuda_ms(lambda: kernel.flash_forward_plain(*x), 1)
        t_lib = cuda_ms(lambda: _sdpa(*x), 20)
        rows.append(_row(key, (got if key == "K9" else got32)[key], errs,
                         t_ms, t_plain, kb, library_ms=t_lib))
        del x
    r16, r32 = rows
    print(f"[full attention] granite-20b layer, H={h} KV={kv} S=T={s} "
          f"dh={dh}, causal: one launch a dtype; {report}; {e_lib:.3g} vs "
          f"SDPA; bf16 K9 (wgmma, {hgmma} HGMMA in its SASS) "
          f"{r16['ms']:.4f} ms (plain {r16['plain_ms']:.2f} ms, SDPA "
          f"{r16['library_ms']:.4f} ms, bound {r16['bound_ms']:.4f} ms by "
          f"{r16['bound_by']}, {1.5 * r16['bound_ms']:.4f} ms with the "
          f"split P's second PV product); f32 K9 (split TF32, {hgmma32} "
          f"HGMMA in its SASS) {r32['ms']:.4f} ms (plain "
          f"{r32['plain_ms']:.2f} ms, SDPA f32 {r32['library_ms']:.4f} ms, "
          f"bound {r32['bound_ms']:.4f} ms by {r32['bound_by']}: three "
          f"TF32 products at {tf32_flops / 1e12:g} TFLOP/s; the f32 "
          f"CUDA-core floor {1e3 * flops / f32_flops:.3f} ms; the parent's "
          f"CUDA-core kernel {PARENT_MS['K9-f32']} ms, PERF.md) [{name}]")
    del q, k, v, o, o32
    # phi3-mini's MHA, checked untimed
    h, dh = 32, 96
    q, k, v = _attn_inputs(gen, dev, 1, h, h, s, s, dh, dh, torch.bfloat16)
    o, o32, _, _ = _attn_layer(dev, q, k, v, "phi3-mini")
    report = _attn_full(errs, q, k, v, o, o32, "phi3-mini K9")
    print(f"[full attention] phi3-mini layer, H=KV={h} S=T={s} dh={dh}: "
          f"one launch a dtype; {report}")
    return rows


def _gla_inputs(gen, dev, b, h, s, dk, dv, dtype):
    rn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return (rn(b, h, s, dk).to(dtype), (0.3 * rn(b, h, s, dk)).to(dtype),
            rn(b, h, s, dv).to(dtype), -(0.2 * rn(b, h, s)).abs())


def _gla_diff(errs: ErrLog, got, want, bf16: bool, key: str = "K10") -> int:
    """Hold K10's (o, state) to the plain version's: the state and a
    float32 o within GLA_RTOL / GLA_ATOL; a bf16 o within one bf16 ulp
    besides.  Returns the count of o's elements that differ."""
    (ok, sk), (op, sp) = got, want
    errs.diff(key, ok, op)
    errs.diff(key, sk, sp)
    assert _close(sk, sp, GLA_RTOL, GLA_ATOL), "K10 state"
    assert _close(ok, op, GLA_RTOL + (BF16_ULP if bf16 else 0.0),
                       GLA_ATOL), "K10 output"
    return int((ok != op).sum())


def gla_bound(name: str, b: int, h: int, s: int, dk: int, dv: int,
              chunk: int, f32: bool = False):
    """(bytes ms, operations ms) of a bf16 chunked scan on the card: q, k,
    v read and o written once in bf16, log a and the state in float32;
    the causal half of each chunk's scores and their products, the
    inter-chunk read and the state update at the bf16 tensor peak.  With
    ``f32``, of the float32 scan: q, k, v and o in float32, the work at
    the f32 CUDA-core peak its kernel runs on."""
    flops = b * h * (s // chunk) * (chunk * (chunk + 1) // 2 * 2 * (dk + dv)
                                    + 2 * 2 * chunk * dk * dv)
    width = 4 if f32 else 2
    nbytes = width * b * h * s * (2 * dk + 2 * dv) + 4 * b * h * (s + dk * dv)
    mem_bps, f32_flops, bf16_flops, _ = card_peaks(name)
    return (1e3 * nbytes / mem_bps,
            1e3 * flops / (f32_flops if f32 else bf16_flops))


def check_k10(dev, errs: ErrLog) -> None:
    """K10 against its plain version on the reference's test shapes
    (tests/test_kernels.py: three, and the model-path case), dk = 128,
    chunks of 256 (four 64-row tiles) and of 24 (a ragged tile), bf16;
    then the chunk-parallel kernels' edges, in bf16 (the tensor-core
    kernel) and f32: chunk 24, dk 128 / dv 96, one chunk a head (nc = 1,
    no predecessor), a long look-back chain (chunk 8, nc = 64), head dims
    that are not whole 16-byte rows (dk 8 / dv 4, dk 20 / dv 12), chunks
    of 192 and 512 (passes of 128 query rows, one of them partial), and
    q, k, v one element into their storage (the element-wise loads)."""
    from repro_torch.kernels.gla import kernel
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(1, 2, 32, 8, 8, 8, f32), (2, 3, 64, 16, 8, 16, f32),
             (1, 1, 128, 64, 64, 32, f32), (1, 2, 64, 8, 4, 16, f32),
             (1, 2, 256, 128, 96, 64, f32), (1, 3, 512, 64, 64, 256, f32),
             (2, 2, 96, 32, 16, 24, f32), (1, 3, 512, 64, 64, 256, bf16)]
    cases = [c + (False,) for c in cases] + [
        (2, 2, 96, 32, 16, 24, bf16, False),
        (1, 2, 256, 128, 96, 64, bf16, False),
        (1, 2, 64, 64, 64, 64, bf16, False),
        (1, 2, 64, 64, 64, 64, f32, False),
        (1, 3, 512, 16, 16, 8, bf16, False),
        (1, 3, 512, 16, 16, 8, f32, False),
        (1, 2, 64, 8, 4, 16, bf16, False),
        (1, 2, 160, 20, 12, 32, bf16, False),
        (1, 2, 384, 64, 64, 192, bf16, False),
        (1, 1, 1024, 128, 128, 512, bf16, False),
        (1, 3, 512, 64, 64, 256, bf16, True),
        (2, 2, 96, 32, 16, 24, bf16, True),
        (2, 2, 96, 32, 16, 24, f32, True)]
    gen = torch.Generator(device=dev).manual_seed(18)
    for (b, h, s, dk, dv, chunk, dtype, at) in cases:
        q, k, v, la = _gla_inputs(gen, dev, b, h, s, dk, dv, dtype)
        if at:
            q, k, v = (_at_offset(x) for x in (q, k, v))
        g = kernel.chunk_cumsum(la, chunk)
        before = counts()
        res = kernel.gla_chunks(q, k, v, g, chunk)
        torch.cuda.synchronize()
        launched(before, K10=1)
        nd = _gla_diff(errs, res, kernel.gla_chunks_plain(q, k, v, g, chunk),
                       dtype == bf16)
        print(f"[K10] B={b} H={h} S={s} dk={dk} dv={dv} chunk={chunk} "
              f"{str(dtype)[6:]}{' (one element into storage)' if at else ''}"
              f": within rtol {GLA_RTOL:g} / atol "
              f"{GLA_ATOL:g} of the plain version ({nd} output elements "
              f"differ)")


def full_gla(dev, errs: ErrLog, name: str, s: int = 4096, seed: int = 18):
    """K10 at full width (phase 18): zamba2-7b's SSD scan
    (configs/zamba2_7b.py: d_inner 7168 = 112 heads of 64, ssm_state 64,
    gla_chunk 256; models/ssm.py) at B = 1, S = 4096 in bf16 through
    ``kernels.gla.gla_scan``: one launch, held to the plain version on
    the same cumsum, and the same inputs in float32 held to it too;
    timed beside the plain version, the bound and the parent's time, with
    a launch's device time from ``torch.profiler``; the bf16 kernel's
    SASS must hold warpgroup-MMA instructions (HGMMA).  Returns K10's
    kernel table row."""
    from repro_torch.kernels.gla import gla_scan, kernel
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, h, dk, dv, chunk = 1, 112, 64, 64, 256
    q, k, v, la = _gla_inputs(gen, dev, b, h, s, dk, dv, torch.bfloat16)
    torch.cuda.synchronize()
    reset_counts()
    o, st = gla_scan(q, k, v, la, chunk=chunk, device=dev)
    torch.cuda.synchronize()
    got = counts()
    assert got == {**{key: 0 for key in got}, "K10": 1}, got
    assert o.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert torch.isfinite(o.float()).all() and torch.isfinite(st).all()
    g = kernel.chunk_cumsum(la, chunk)
    nd = _gla_diff(errs, (o, st), kernel.gla_chunks_plain(q, k, v, g, chunk),
                   True)
    q32, k32, v32 = q.float(), k.float(), v.float()
    nd32 = _gla_diff(errs, kernel.gla_chunks(q32, k32, v32, g, chunk),
                     kernel.gla_chunks_plain(q32, k32, v32, g, chunk), False)
    nc = s // chunk
    kb = gla_bound(name, b, h, s, dk, dv, chunk)
    hgmma = sass_count(kernel.LIB, "HGMMA")
    assert hgmma > 0, "no HGMMA in K10's SASS"
    t_ms = cuda_ms(lambda: kernel.gla_chunks(q, k, v, g, chunk), 10)
    t_dev = device_ms(lambda: kernel.gla_chunks(q, k, v, g, chunk), 10,
                      "gla_ws_kernel")
    t_plain = cuda_ms(lambda: kernel.gla_chunks_plain(q, k, v, g, chunk), 2)
    print(f"[full GLA] zamba2-7b scan, H={h} S={s} dk=dv={dk} chunk="
          f"{chunk} bf16: one launch; state within rtol {GLA_RTOL:g} / atol "
          f"{GLA_ATOL:g} of the plain version, output within one bf16 ulp "
          f"({nd} of {o.numel()} elements differ); the same inputs in f32 "
          f"within the tolerance ({nd32} differ); K10 ({hgmma} HGMMA in its "
          f"SASS) {t_ms:.4f} ms, device {_dev_str(t_dev)} (the parent's "
          f"{PARENT_MS['K10']} ms, PERF.md; plain {t_plain:.2f} ms, bound "
          f"{max(kb):.4f} ms by "
          f"{'bytes' if kb[0] >= kb[1] else 'operations'}; {b * h * nc} "
          f"(head, chunk) units on "
          f"{torch.cuda.get_device_properties(dev).multi_processor_count}"
          f" SMs) [{name}]")
    return _row("K10", got["K10"], errs, t_ms, t_plain, kb)


# ---------------------------------------------------------------------------
# phases 19-21: the wavelet prefilter and crash recovery
# ---------------------------------------------------------------------------

def golden_bank():
    """The reference's golden-trace bank (tests/test_streaming.py
    ``golden_bank``): every mrsim app x the paper's parameter sets,
    preprocessed."""
    from repro_torch import mrsim
    from repro_torch.core.database import SeriesBank, pack_series
    from repro_torch.core.filters import preprocess_bank
    series, labels = [], []
    for app in mrsim.APPS:
        for p in mrsim.paper_param_sets():
            series.append(mrsim.simulate_cpu_series(app, p, dt=0.25))
            labels.append(app)
    packed = pack_series(series, labels=labels)
    return SeriesBank(preprocess_bank(packed.series, packed.lengths),
                      packed.lengths, packed.labels)


def _live(job, k: int) -> np.ndarray:
    """A job's live-reference mask over the full bank (a copy)."""
    return np.ones(k, bool) if job.allowed is None else job.allowed.copy()


def prefilter_paper(dev) -> None:
    """Phase 19: the prefilter at the paper's size.  Each golden trace
    (exim, wordcount, terasort; first parameter set, run 1) streamed in
    8-sample chunks against the golden bank (band 16, denoise) by an
    unpruned and a pruned (``prefilter_top=4``) service side by side, in
    point mode (K1, K2) and in exact probabilistic mode at zero variance
    (K4 with six channels, K5): every in-flight decision and every final
    equal, tick for tick; on every tick the pruned scores (and
    probabilities) on the job's live columns bitwise the unpruned ones;
    one tick launch a tick in each run.  Then the quickstart through
    ``AutoTuner(band=8, wavelet_prefilter=1)``: it must match wordcount
    with ``used_wavelet_prefilter`` set, through one K2 launch."""
    from repro_torch import mrsim
    from repro_torch.core import AutoTuner, ReferenceDB
    from repro_torch.serve.tuning import TuningService
    bank = golden_bank()
    k = len(bank)
    p = mrsim.paper_param_sets()[0]
    kw = dict(band=16, threshold=0.85, margin=0.02, stable_ticks=3,
              min_fraction=0.15, denoise=True, device=dev)
    for mode, tick_key, verdict_key in (("point", "K1", "K2"),
                                        ("exact", "K4-exact", "K5")):
        mkw = dict(kw) if mode == "point" else dict(kw, min_probability=0.5)
        for app in sorted(mrsim.APPS):
            q = mrsim.simulate_cpu_series(app, p, run=1, dt=0.25)
            runs = [TuningService(bank, prefilter_top=pf, **mkw)
                    for pf in (None, 4)]
            for svc in runs:
                svc.submit(app, expected_len=len(q))
            reset_counts()
            ticks, early, narrowest = [0, 0], None, k
            for chunk in mrsim.iter_cpu_series(app, p, run=1, chunk=8,
                                               dt=0.25):
                live = _live(runs[1]._jobs[app], k)
                outs = []
                for i, svc in enumerate(runs):
                    before = counts()[tick_key]
                    if mode == "point":
                        svc.push(app, chunk)
                    else:
                        svc.push(app, chunk, variance=np.zeros_like(chunk))
                    d = svc.tick().get(app)
                    ticks[i] += counts()[tick_key] - before
                    outs.append(None if d is None else
                                (d.matched, d.corr, d.decided_at_fraction,
                                 d.probability))
                assert outs[0] == outs[1], (mode, app, outs)
                early = early or outs[1]
                narrowest = min(narrowest, len(runs[1]._packed_idx))
                un, pr = runs[0]._jobs[app], runs[1]._jobs[app]
                assert np.array_equal(pr.last_sims[live], un.last_sims[live])
                assert np.isneginf(pr.last_sims[~live]).all()
                if mode != "point":
                    assert np.array_equal(pr.last_probs[live],
                                          un.last_probs[live])
            finals = [svc.finish(app) for svc in runs]
            assert _verdict_key(finals[0]) == _verdict_key(finals[1])
            assert finals[0].decided_at_fraction == \
                finals[1].decided_at_fraction
            for svc, n in zip(runs, ticks):
                assert svc.dispatch_count == svc.ticks == n
            launched({key: 0 for key in KERNELS},
                     **{tick_key.replace("-", "_"): sum(ticks),
                        verdict_key: 2})
            print(f"[prefilter paper {mode}] {app}: {runs[1].ticks} ticks, "
                  f"early {None if early is None else early[0]} at "
                  f"{None if early is None else early[2]}, final "
                  f"{finals[1].matched} (corr {finals[1].corr:.6f}); "
                  f"pruned and unpruned equal tick for tick; pack "
                  f"narrowed to {narrowest} of {k} references, "
                  f"{runs[1].repack_count} re-packs; {tick_key} launches "
                  f"{ticks[1]} + {ticks[0]}, the two runs' dispatches")
    # the quickstart scenario, narrowed by the wavelet prefilter
    db = ReferenceDB()
    tuner = AutoTuner(db, band=8, wavelet_prefilter=1, device=dev)
    psets = mrsim.paper_param_sets()
    for app in ("wordcount", "terasort"):
        for ps in psets:
            tuner.profile(app, ps.as_dict(),
                          mrsim.simulate_cpu_series(app, ps))
    db.set_best_config("wordcount", {"mappers": 21, "reducers": 30,
                                     "split_mb": 10, "input_mb": 80}, 1.0)
    db.set_best_config("terasort", {"mappers": 42, "reducers": 33,
                                    "split_mb": 20, "input_mb": 60}, 1.0)
    reset_counts()
    dec = tuner.match("exim-mainlog", mrsim.simulate_cpu_series(
        "exim", psets[0], run=1))
    torch.cuda.synchronize()
    launched({key: 0 for key in KERNELS}, K2=1)
    assert dec.used_wavelet_prefilter and list(dec.scores) == ["wordcount"]
    assert dec.matched == "wordcount" and dec.corr >= 0.9, dec
    assert dec.config == db.best_config("wordcount"), dec.config
    print(f"[prefilter paper] quickstart with wavelet_prefilter=1: "
          f"candidates narrowed to {list(dec.scores)}, matched="
          f"{dec.matched} corr={dec.corr:.6f}, one K2 launch")


def diverse_bank(rng, k: int):
    """The reference bench's diverse bank (bench_streaming.py
    ``_diverse_bank``): one distinct workload a reference, lengths from
    six buckets up to 360 samples; the large-K regime the prefilter is
    for."""
    from repro_torch.core.database import pack_series
    buckets = (180, 220, 256, 300, 330, 360)
    series = []
    for i in range(k):
        n = buckets[int(rng.integers(len(buckets)))]
        t = np.linspace(0, 1, n, dtype=np.float32)
        f = 1.5 + 0.07 * i
        s = (0.5 + 0.28 * np.sin(2 * np.pi * f * t + 0.37 * i)
             + 0.12 * np.sin(2 * np.pi * 3.1 * f * t)
             + 0.06 * rng.normal(size=n).astype(np.float32))
        series.append(np.clip(s, 0, 1).astype(np.float32))
    return pack_series(series)


#: Phase 20's pruned service: the bench's prefilter settings
#: (bench_streaming.py PRUNED_TOP, PRUNED_MIN_FRACTION, margin 0).
PRUNED_KW = dict(prefilter_top=2, prefilter_margin=0.0,
                 prefilter_min_fraction=0.1)


def pruned_inputs(s_jobs: int = 256, k: int = 256, qlen: int = 256,
                  seed: int = 7):
    """Phase 20's bank, the S jobs' target references and their queries:
    16 workloads, S / 16 concurrent instances each, every target at least
    qlen + 8 samples long, its first qlen samples plus noise 0.05."""
    bank = diverse_bank(np.random.default_rng(seed), k)
    long_refs = [i for i in range(k) if bank.lengths[i] >= qlen + 8]
    step = len(long_refs) // 16
    per = s_jobs // 16
    targets = [long_refs[(j // per) * step] for j in range(s_jobs)]
    r = np.random.default_rng(1)
    queries = np.stack([np.clip(bank.row(t)[:qlen]
                                + 0.05 * r.normal(size=qlen), 0, 1)
                        for t in targets]).astype(np.float32)
    return bank, targets, queries


def prefilter_full(dev, errs: ErrLog, name: str, s_jobs: int = 256,
                   k: int = 256, n_ticks: int = 16, c: int = 16,
                   n_fin: int = 32):
    """Phase 20: the pruned scored tick at full width.  The bench's
    diverse bank (K = 256, M = 360) and S = 256 jobs (16 workloads, 16
    instances each) streamed in 16 ticks of 16 samples by a
    distance-only, an unpruned scored and a pruned scored service
    (``PRUNED_KW``) on the same queries; the unpruned and pruned services
    tick side by side.  Checks: every job's true reference survives, each
    job's leader is the unpruned run's, one dispatch a tick, at least one
    re-pack, fewer than K packed columns, on every tick the pruned scores
    on each job's live columns bitwise the unpruned ones, a verdict of 32
    jobs bitwise the unpruned run's, and K1's (K3's) launches equal to
    each run's dispatches.  Prints each run's median ms/tick, the packed
    width after each re-pack, each re-pack's time and the host time of
    ``_update_prefilter`` a tick; times K1 at the final packed width
    beside its plain version and bound.  Returns the K1-pruned kernel
    table row and the pruned run's record for phase 21."""
    from repro_torch.kernels.dtw import stream
    from repro_torch.serve.tuning import TuningService
    bank, targets, queries = pruned_inputs(s_jobs, k, n_ticks * c)
    m = bank.series.shape[1]
    assert m == 360, m
    qlen = n_ticks * c

    def push(svc, t):
        for j in range(s_jobs):
            svc.push(f"job{j}", queries[j, t * c:(t + 1) * c])

    def timed_tick(svc):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.tick()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # distance-only, alone
    dist = TuningService(bank, slots=s_jobs, device=dev,
                         score_in_flight=False)
    for j in range(s_jobs):
        dist.submit(f"job{j}", expected_len=qlen)
    reset_counts()
    dist_s = []
    for t in range(n_ticks):
        push(dist, t)
        dist_s.append(timed_tick(dist))
    launched({key: 0 for key in KERNELS}, K3=dist.dispatch_count)
    assert dist.dispatch_count == n_ticks

    runs = {"unpruned": TuningService(bank, slots=s_jobs, device=dev),
            "pruned": TuningService(bank, slots=s_jobs, device=dev,
                                    **PRUNED_KW)}
    pr = runs["pruned"]
    for svc in runs.values():
        for j in range(s_jobs):
            svc.submit(f"job{j}", expected_len=qlen)
    repack_ms, update_ms, widths = [], [], []
    inner_repack, inner_update = pr._maybe_repack, pr._update_prefilter

    def timed_repack():
        before = pr.repack_count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner_repack()
        torch.cuda.synchronize()
        if pr.repack_count != before:
            repack_ms.append(1e3 * (time.perf_counter() - t0))
            widths.append((pr.ticks, len(pr._packed_idx), pr._kp))

    def timed_update(pending):
        t0 = time.perf_counter()
        inner_update(pending)
        update_ms.append(1e3 * (time.perf_counter() - t0))

    pr._maybe_repack, pr._update_prefilter = timed_repack, timed_update
    reset_counts()
    tick_s = {key: [] for key in runs}
    k1 = {key: 0 for key in runs}
    for t in range(n_ticks):
        live = [_live(pr._jobs[f"job{j}"], k) for j in range(s_jobs)]
        for key, svc in runs.items():
            push(svc, t)
            before = counts()["K1"]
            tick_s[key].append(timed_tick(svc))
            k1[key] += counts()["K1"] - before
        for j in range(s_jobs):
            un = runs["unpruned"]._jobs[f"job{j}"].last_sims
            pj = pr._jobs[f"job{j}"].last_sims
            assert np.array_equal(pj[live[j]], un[live[j]]), (t, j)
            assert np.isneginf(pj[~live[j]]).all(), (t, j)
    got = counts()
    assert got == {**{key: 0 for key in got},
                   "K1": sum(k1.values())}, got
    for key, svc in runs.items():
        assert svc.dispatch_count == svc.ticks == k1[key] == n_ticks, key
    assert pr.repack_count >= 1 and len(pr._packed_idx) < k
    for j, tj in enumerate(targets):
        job = pr._jobs[f"job{j}"]
        assert tj in pr._packed_idx and (job.allowed is None
                                         or job.allowed[tj]), \
            f"the prefilter dropped job{j}'s true reference {tj}"
        lead_p = int(np.argmax(job.last_sims))
        lead_u = int(np.argmax(runs["unpruned"]._jobs[f"job{j}"].last_sims))
        assert lead_p == lead_u, (j, lead_p, lead_u)
    # the uninterrupted run's state at tick 16, for phase 21
    k_live = len(pr._packed_idx)
    record = dict(
        bank=bank, queries=queries, packed_idx=pr._packed_idx.copy(),
        allowed={jid: None if job.allowed is None else job.allowed.copy()
                 for jid, job in pr._jobs.items()},
        last_sims={jid: job.last_sims.copy() for jid, job in pr._jobs.items()},
        rows=pr._rows[:, :, :k_live].clone(),
        moms=pr._moms[..., :k_live].clone(),
        slots={jid: job.slot for jid, job in pr._jobs.items()})

    fin_ids = [f"job{j}" for j in range(n_fin)]
    reset_counts()
    verdicts = {key: svc.finish_many(fin_ids) for key, svc in runs.items()}
    launched({key: 0 for key in KERNELS}, K2=2)
    for jid in fin_ids:
        assert _verdict_key(verdicts["pruned"][jid]) == \
            _verdict_key(verdicts["unpruned"][jid]), jid
    record["finals"] = {jid: _verdict_key(d)
                        for jid, d in verdicts["pruned"].items()}
    med = {key: 1e3 * float(np.median(v)) for key, v in tick_s.items()}
    med["distance"] = 1e3 * float(np.median(dist_s))
    print(f"[prefilter full] {s_jobs} jobs x K={k} x M={m}, C={c}, "
          f"{n_ticks} ticks: median ms/tick pruned {med['pruned']:.3f}, "
          f"unpruned {med['unpruned']:.3f}, distance-only "
          f"{med['distance']:.3f} [{name}]")
    print(f"[prefilter full] packed width after each re-pack (tick, live, "
          f"padded): {widths}; re-pack ms {[round(x, 3) for x in repack_ms]}"
          f"; _update_prefilter host ms a tick: median "
          f"{float(np.median(update_ms)):.3f}, max {max(update_ms):.3f}, "
          f"total {sum(update_ms):.3f} over {len(update_ms)} ticks "
          f"({100 * sum(update_ms) / (1e3 * sum(tick_s['pruned'])):.1f}% of "
          f"the pruned ticks' time) [{name}]")
    print(f"[prefilter full] every job's true reference survived, leaders "
          f"the unpruned run's; pruned scores on live columns bitwise the "
          f"unpruned ones on all {n_ticks} ticks; {n_fin} verdicts bitwise; "
          f"K1 launches {k1['pruned']} pruned + {k1['unpruned']} unpruned, "
          f"K3 {dist.dispatch_count}")

    # K1 at the final packed width, on the pruned run's state and its
    # last chunk (the state after the verdict's slots were freed is the
    # same tensors: no tick ran since)
    kp = pr._kp
    s_cap = pr.slot_capacity
    chunks = torch.zeros((s_cap, c), device=dev)
    last = slice((n_ticks - 1) * c, n_ticks * c)
    for j in range(s_jobs):
        chunks[record["slots"][f"job{j}"]] = torch.tensor(queries[j, last])
    nvalid = torch.full((s_cap,), c, dtype=torch.int32, device=dev)
    qlens = torch.full((s_cap,), qlen, dtype=torch.int32, device=dev)
    args = (pr._rows, pr._moms, pr._ns, pr._bank_t, pr._lengths, chunks,
            nvalid, qlens)
    outk = stream.stream_bank_extend_scored(*args)
    outp = stream.stream_bank_extend_scored_plain(*args)
    fin = outp[0] < 1e37
    assert torch.equal(fin, outk[0] < 1e37)
    e = max(errs.diff("K1-pruned", outk[0], outp[0], fin),
            errs.diff("K1-pruned", outk[1], outp[1],
                      fin[None].expand_as(outp[1])))
    assert e <= SMOOTH_TOL, f"K1 at the packed width: max abs err {e}"
    mem_bps, dtw_ops = card_peaks(name)[0], dtw_op_rate(name)
    tbytes = 2 * 4 * (1 + 3) * s_cap * m * kp + 4 * (
        m * kp + kp + s_cap * c + 3 * s_cap)
    tb = (1e3 * tbytes / mem_bps,
          1e3 * ops_per_cell(3) * int(nvalid.sum()) * m * kp / dtw_ops)
    t_ms = cuda_ms(lambda: stream.stream_bank_extend_scored(*args), 20)
    t_dev = device_ms(lambda: stream.stream_bank_extend_scored(*args), 10,
                      "stream_scored_kernel")
    t_plain = cuda_ms(lambda: stream.stream_bank_extend_scored_plain(*args),
                      2)
    print(f"[prefilter full] K1 at the packed width kp={kp} ({k_live} live "
          f"of {k}; S={s_cap}, M={m}): held against the plain version, max "
          f"abs err {e:.3g} (tol {SMOOTH_TOL:g}); {t_ms:.4f} ms (CUDA "
          f"events), device {_dev_str(t_dev)}, plain {t_plain:.2f} ms, "
          f"bound {max(tb):.4f} ms by "
          f"{'bytes' if tb[0] >= tb[1] else 'operations'}; "
          f"{100 * t_ms / med['pruned']:.2f}% of the median pruned tick "
          f"[{name}]")
    return _row("K1-pruned", k1["pruned"], errs, t_ms, t_plain, tb), record


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def recovery_full(dev, name: str, record: dict, ckpt_tick: int = 8,
                  n_ticks: int = 16, c: int = 16, n_fin: int = 32) -> None:
    """Phase 21, first half: phase 20's pruned run again as a
    ``RecoverableTuningService`` on the card under a temporary directory,
    checkpointed after tick ``ckpt_tick`` and run to tick 16, then
    recovered into a fresh object from the same root.  The journal tail
    must replay (``replayed`` > 0) with one K1 launch for each replayed
    tick, and the recovered service's packed columns, every job's live
    set and scores, the live columns of its rows and moment slabs, and
    its 32 verdicts must be bitwise phase 20's uninterrupted run's."""
    import tempfile
    from repro_torch.serve.recovery import RecoverableTuningService
    bank, queries = record["bank"], record["queries"]
    s_jobs = queries.shape[0]
    with tempfile.TemporaryDirectory() as root:
        live = RecoverableTuningService(bank, root=root, device=dev,
                                        slots=s_jobs, **PRUNED_KW)
        for j in range(s_jobs):
            live.submit(f"job{j}", expected_len=n_ticks * c)
        t0 = time.perf_counter()
        for t in range(n_ticks):
            for j in range(s_jobs):
                live.push(f"job{j}", queries[j, t * c:(t + 1) * c])
            live.tick()
            if t + 1 == ckpt_tick:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                step = live.checkpoint()
                save_ms = 1e3 * (time.perf_counter() - t1)
                ckpt_bytes = _dir_bytes(os.path.join(
                    root, "ckpt", f"step_{step:06d}"))
                ckpt_width = len(live.svc._packed_idx)
        torch.cuda.synchronize()
        journaled_s = time.perf_counter() - t0
        wal_bytes = _dir_bytes(os.path.join(root, "wal"))
        del live
        reset_counts()
        t0 = time.perf_counter()
        rec = RecoverableTuningService.recover(bank, root=root, device=dev)
        torch.cuda.synchronize()
        recover_ms = 1e3 * (time.perf_counter() - t0)
        replayed_ticks = rec.dispatch_count - ckpt_tick
        assert rec.replayed > 0 and replayed_ticks == n_ticks - ckpt_tick
        launched({key: 0 for key in KERNELS}, K1=replayed_ticks)
        svc = rec.svc
        assert np.array_equal(svc._packed_idx, record["packed_idx"])
        k_live = len(svc._packed_idx)
        for jid, job in svc._jobs.items():
            want = record["allowed"][jid]
            assert (job.allowed is None) == (want is None), jid
            assert want is None or np.array_equal(job.allowed, want), jid
            assert np.array_equal(job.last_sims, record["last_sims"][jid])
            assert job.slot == record["slots"][jid]
        assert torch.equal(svc._rows[:, :, :k_live], record["rows"])
        assert torch.equal(svc._moms[..., :k_live], record["moms"])
        verdicts = rec.finish_many([f"job{j}" for j in range(n_fin)])
        for jid, d in verdicts.items():
            assert _verdict_key(d) == record["finals"][jid], jid
    print(f"[recovery full] {s_jobs} jobs, K={len(bank)}, pruned: 16 "
          f"journaled ticks in {journaled_s:.2f} s (WAL {wal_bytes} bytes); "
          f"snapshot after tick {ckpt_tick} ({ckpt_width} packed columns): "
          f"{ckpt_bytes} bytes, saved in {save_ms:.1f} ms; restore + replay "
          f"of {rec.replayed} journal records ({replayed_ticks} ticks, "
          f"{replayed_ticks} K1 launches) {recover_ms:.1f} ms; packed "
          f"columns, live sets, scores, rows, moments and {n_fin} verdicts "
          f"bitwise the uninterrupted run's [{name}]")


#: The kill-and-recover child (the reference's
#: tests/test_crash_recovery.py command tape, on the card): ``golden``
#: runs the tape on a plain service; ``serve`` runs it journaled,
#: checkpoints after command 11 and SIGKILLs itself after command 19;
#: ``recover`` rebuilds from snapshot + journal tail and resumes at
#: ``wal.next_seq``.  Each prints its decisions (float-hex scores) by
#: command index; ``recover`` also its K1 launches and replayed ticks.
CRASH_CHILD = r'''
import json, os, signal, sys
import numpy as np
from repro_torch.core.database import pack_series
from repro_torch.kernels.dtw import stream
from repro_torch.runtime.chaos import FaultPlan
from repro_torch.serve.recovery import RecoverableTuningService
from repro_torch.serve.tuning import TuningService

MODE, ROOT, CKPT_AT = sys.argv[1], sys.argv[2], 11
rng = np.random.default_rng(7)
series = [np.abs(np.cumsum(rng.normal(size=int(n)))).astype(np.float32)
          for n in rng.integers(40, 90, size=6)]
bank = pack_series(series, labels=[f"w{i}" for i in range(6)])
streams = {f"j{i}": np.abs(np.cumsum(rng.normal(size=64)))
           .astype(np.float32) for i in range(3)}
cmds = [("submit", j) for j in streams]
for t in range(8):
    cmds += [("push", j, t) for j in streams] + [("tick", float(t))]
cmds += [("finish", sorted(streams))]


def keyd(decisions):
    return [[j, None] if d is None else
            [j, d.matched, float(d.corr).hex(), d.final,
             sorted([k, float(v).hex()] for k, v in d.scores.items())]
            for j, d in sorted(decisions.items())]


def run_cmd(svc, cmd):
    if cmd[0] == "submit":
        svc.submit(cmd[1], 64)
    elif cmd[0] == "push":
        j, t = cmd[1], cmd[2]
        svc.push(j, streams[j][t * 8:(t + 1) * 8], now=float(t))
    elif cmd[0] == "tick":
        return keyd(svc.tick(now=cmd[1]))
    elif cmd[0] == "finish":
        return keyd(svc.finish_many(cmd[1]))


KW = dict(threshold=0.5, margin=0.01, stable_ticks=2, min_fraction=0.2,
          slots=4, device="cuda")
if MODE == "golden":
    svc = TuningService(bank, **KW)
    out = {str(i): d for i, cmd in enumerate(cmds)
           if (d := run_cmd(svc, cmd)) is not None}
    print("GOLDEN " + json.dumps(out), flush=True)
elif MODE == "serve":
    svc = RecoverableTuningService(bank, root=ROOT, **KW)
    plan = FaultPlan(seed=0, kill_every=20)
    for i, cmd in enumerate(cmds):
        run_cmd(svc, cmd)
        print(f"ACK {i}", flush=True)
        if i == CKPT_AT:
            svc.checkpoint()
            print(f"CKPT {i}", flush=True)
        if plan.should_kill(i):
            os.kill(os.getpid(), signal.SIGKILL)
    print("SERVE_DONE", flush=True)
else:
    svc = RecoverableTuningService.recover(bank, root=ROOT, **KW)
    ticks = svc.dispatch_count - sum(c[0] == "tick"
                                     for c in cmds[:CKPT_AT + 1])
    print(f"RESUMED_AT {svc.wal.next_seq} REPLAYED {svc.replayed} "
          f"K1 {stream.LIB.launches} TICKS {ticks}", flush=True)
    out = {str(i): d for i in range(svc.wal.next_seq, len(cmds))
           if (d := run_cmd(svc, cmds[i])) is not None}
    print("RECOVERED " + json.dumps(out), flush=True)
'''


def recovery_kill() -> None:
    """Phase 21, second half: kill and recover at the paper's size, in
    child processes on the card.  A serving child runs the reference's
    crash-recovery command tape journaled, checkpoints after command 11
    and SIGKILLs itself after command 19 (the fault plan's kill point);
    a second child recovers from snapshot + journal tail (one K1 launch
    a replayed tick) and resumes the tape; every decision it emits must
    equal a golden child's at the same command index, bitwise."""
    import signal
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def child(mode, root):
        return subprocess.run([sys.executable, "-c", CRASH_CHILD, mode,
                               root], env=env, cwd=ROOT, capture_output=True,
                              text=True, timeout=300)

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "svc")
        t0 = time.perf_counter()
        g = child("golden", root)
        assert g.returncode == 0, g.stdout + g.stderr
        golden = json.loads(g.stdout.split("GOLDEN ", 1)[1].splitlines()[0])
        s = child("serve", root)
        assert s.returncode == -signal.SIGKILL, (s.returncode, s.stdout,
                                                 s.stderr)
        assert "CKPT 11" in s.stdout and "ACK 19" in s.stdout
        assert "ACK 20" not in s.stdout and "SERVE_DONE" not in s.stdout
        r = child("recover", root)
        assert r.returncode == 0, r.stdout + r.stderr
        head = r.stdout.split("RESUMED_AT ", 1)[1].split()
        resume, replayed, k1, ticks = (int(head[0]), int(head[2]),
                                       int(head[4]), int(head[6]))
        assert (resume, replayed) == (20, 20 - 1 - 11), head
        assert k1 == ticks > 0, head
        recovered = json.loads(
            r.stdout.split("RECOVERED ", 1)[1].splitlines()[0])
        assert recovered and str(3 + 8 * 4) in recovered
        for i, dec in recovered.items():
            assert int(i) >= resume and dec == golden[i], (i, dec)
    print(f"[recovery kill] the serving child died by SIGKILL after "
          f"command 19 (checkpoint after 11); the recovering child replayed "
          f"{replayed} journal records ({ticks} ticks, {k1} K1 launches), "
          f"resumed at command {resume}, and its {len(recovered)} decision "
          f"sets equal the golden child's bitwise; three children in "
          f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 22: bank sharding
# ---------------------------------------------------------------------------

def card_mesh(n):
    """A bank mesh of ``n`` shards, all on the one card (the counterpart
    of the reference's forced host devices); None for ``n`` None."""
    from repro_torch.sharding import make_mesh
    return None if n is None else make_mesh(n, devices=["cuda:0"] * n)


#: Each mode's tick kernel and verdict kernel, by table key.
TICK_KEYS = {"point": ("K1", "K2"), "exact": ("K4-exact", "K5"),
             "approx": ("K4-approx", "K5"), "distance": ("K3", "K2")}


def _final_state(svc, mode: str, s_jobs: int) -> dict:
    """What a run must reproduce before its verdict: the DP rows and
    moment slab (gathered from the shards), every job's scores and early
    decision."""
    jobs = [svc._jobs[f"job{i}"] for i in range(s_jobs)]
    return dict(
        rows=svc._rows.clone(),
        moms=None if svc._moms is None else svc._moms.clone(),
        sims=None if mode == "distance"
        else np.stack([j.last_sims for j in jobs]),
        earlies={j.job_id: (j.early.matched, j.early.corr,
                            j.early.decided_at_fraction)
                 for j in jobs if j.early is not None})


def _hold_full(got: dict, want: dict, what: str) -> None:
    """A sharded (rescaled, restored) full-width run against phase 7's
    run of the same mode: rows, moment slab, scores, early decisions and
    the 32 verdicts bitwise."""
    assert torch.equal(got["rows"], want["rows"]), what
    assert (got["moms"] is None) == (want["moms"] is None), what
    assert got["moms"] is None or torch.equal(got["moms"], want["moms"]), \
        what
    assert (got["sims"] is None) == (want["sims"] is None), what
    assert got["sims"] is None or np.array_equal(got["sims"],
                                                 want["sims"]), what
    assert got["earlies"] == want["earlies"], what
    assert got["verdicts"] == want["verdicts"], what


def drive_full(svc, mode: str, ticks, at=None, s_jobs: int = 256,
               k: int = 256, n_fin: int = 32, c: int = 16, seed: int = 0):
    """Phase 7's schedule on ``svc`` for the given tick indices: every
    job's 16 samples of the tick, then one tick; ``at`` maps a tick index
    to a callable run before that tick (a rescale, a snapshot).  Then the
    state before the verdict and the verdict of 32 jobs.  Returns the
    run's record and its tick times (host clock + synchronise)."""
    _, queries, variances = full_inputs(mode, s_jobs, k, 24 * c, seed)
    prob = mode in ("exact", "approx")
    tick_s = []
    for t in ticks:
        if at and t in at:
            at[t]()
        for i in range(s_jobs):
            sl = slice(t * c, (t + 1) * c)
            if prob:
                svc.push(f"job{i}", queries[i, sl], variance=variances[i, sl])
            else:
                svc.push(f"job{i}", queries[i, sl])
        t0 = time.perf_counter()
        svc.tick()
        torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t0)
    record = _final_state(svc, mode, s_jobs)
    verdicts = svc.finish_many([f"job{i}" for i in range(n_fin)])
    record["verdicts"] = {j: _verdict_key(d) for j, d in verdicts.items()}
    return record, tick_s


def _full_service(mode: str, mesh, s_jobs: int = 256, k: int = 256,
                  seed: int = 0, dev=None):
    from repro_torch.serve.tuning import TuningService
    bank = full_inputs(mode, 1, k, 16, seed)[0]
    kw = {"point": {}, "distance": dict(score_in_flight=False)}.get(
        mode, dict(min_probability=0.5, prob_mode=mode))
    svc = TuningService(bank, slots=s_jobs, mesh=mesh, device=dev, **kw)
    for i in range(s_jobs):
        svc.submit(f"job{i}", expected_len=24 * 16)
    return svc


def sharded_full(dev, errs: ErrLog, name: str, runs: dict, k1_ms: float,
                 n: int = 4, s_jobs: int = 256, k: int = 256) -> None:
    """Phase 22, first part: phase 7's point, exact and distance-only
    runs again on ``n`` shards of the card.  Each must be bitwise phase
    7's run (rows, moment slab, scores, earlies, 32 verdicts), every
    shard's ``ns``, ``sx`` and ``sxx`` bitwise the others', and its tick
    kernel must launch ``n`` times a dispatch (the verdict kernel once a
    verdict).  Prints each run's median ms/tick beside phase 7's, and in
    point mode each shard's K1 launch timed beside the unsharded K1."""
    from repro_torch.kernels.dtw import stream
    med = {}
    for mode in ("point", "exact", "distance"):
        tick_key, verdict_key = TICK_KEYS[mode]
        svc = _full_service(mode, card_mesh(n), s_jobs, k)
        assert len(svc._shards) == n and svc._kp == k
        reset_counts()
        got, tick_s = drive_full(svc, mode, range(24), s_jobs=s_jobs, k=k)
        c = counts()
        want = {key: 0 for key in c}
        want[tick_key] = n * svc.dispatch_count
        want[verdict_key] = svc.offline_dispatch_count
        assert c == want and svc.dispatch_count == 24, (mode, c, want)
        _hold_full(got, runs[mode], f"{n}-shard {mode}")
        for sh in svc._shards[1:]:
            for f in ("ns", "sx", "sxx", "vstats"):
                a, b = getattr(sh, f), getattr(svc._shards[0], f)
                assert (a is None) == (b is None) and (
                    a is None or torch.equal(a, b)), (mode, f)
            assert sh.rows.shape[2] == k // n and sh.rows.is_contiguous()
        med[mode] = 1e3 * float(np.median(tick_s))
        print(f"[sharding full {mode}] {s_jobs} jobs x K={k} over {n} "
              f"shards of the card: median {med[mode]:.3f} ms/tick "
              f"(unsharded, phase 7: {runs[mode]['ms_tick']:.3f}); "
              f"{tick_key} {c[tick_key]} launches = {n} x "
              f"{svc.dispatch_count} dispatches; rows, moments, scores, "
              f"{len(got['earlies'])} earlies and 32 verdicts bitwise "
              f"phase 7's [{name}]")
        if mode != "point":
            continue
        # each shard's K1 at its [S, M, K / n] slice, on its state and
        # phase 7's tick-12 chunk, beside the unsharded K1
        _, queries, _ = full_inputs("point", s_jobs, k, 384, 0)
        s_cap = svc.slot_capacity
        assert s_cap == s_jobs
        chunks = torch.tensor(queries[:, 12 * 16:13 * 16], device=dev)
        nvalid = torch.full((s_cap,), 16, dtype=torch.int32, device=dev)
        qlens = torch.full((s_cap,), 384, dtype=torch.int32, device=dev)
        launches = [
            (lambda sh=sh: stream.stream_bank_extend_scored(
                sh.rows, sh.moms, sh.ns, sh.bank_t, sh.lengths, chunks,
                nvalid, qlens)) for sh in svc._shards]
        for sh, fn in zip(svc._shards, launches):
            outk = fn()
            outp = stream.stream_bank_extend_scored_plain(
                sh.rows, sh.moms, sh.ns, sh.bank_t, sh.lengths, chunks,
                nvalid, qlens)
            fin = outp[0] < 1e37
            assert torch.equal(fin, outk[0] < 1e37)
            e = max(errs.diff("K1", outk[0], outp[0], fin),
                    errs.diff("K1", outk[1], outp[1],
                              fin[None].expand_as(outp[1])))
            assert e <= SMOOTH_TOL, f"K1 on a {k // n}-column shard: {e}"
        shard_ms = [cuda_ms(fn, 20) for fn in launches]
        all_ms = cuda_ms(lambda: [fn() for fn in launches], 20)
        shard_dev = device_ms(launches[0], 10, "stream_scored_kernel")
        print(f"[sharding full point] K1 a shard ([{s_cap}, 360, "
              f"{k // n}]): {', '.join(f'{x:.4f}' for x in shard_ms)} ms "
              f"(CUDA events; shard 0 device {_dev_str(shard_dev)}); the "
              f"{n} launches back to back {all_ms:.4f} ms, "
              f"{all_ms / k1_ms:.2f}x the unsharded K1 ({k1_ms:.4f} ms); "
              f"each held against the plain version [{name}]")
    print(f"[sharding full] median ms/tick over {n} shards against "
          f"unsharded: " + ", ".join(
              f"{m} {med[m]:.3f} / {runs[m]['ms_tick']:.3f}" for m in med)
          + f" [{name}]")


def rescale_full(dev, name: str, runs: dict, n_ticks: int = 24,
                 s_jobs: int = 256, k: int = 256) -> None:
    """Phase 22, second part: phase 7's point run started on 4 shards,
    snapshotted before tick 8, rescaled onto the one device (``None``)
    before tick 8 and onto 2 shards before tick 16; then the 4-shard
    snapshot restored onto ``None`` and onto 2 shards, each run on from
    tick 8.  All three bitwise phase 7's run; K1 launches follow each
    run's shard count."""
    from repro_torch.serve.recovery import restore_service, snapshot_service
    want = runs["point"]
    svc = _full_service("point", card_mesh(4), s_jobs, k)
    snap = {}

    def to_none():
        snap["tree"] = snapshot_service(svc)
        svc.rescale(None)

    reset_counts()
    t0 = time.perf_counter()
    got, _ = drive_full(svc, "point", range(n_ticks),
                        at={8: to_none, 16: lambda: svc.rescale(
                            card_mesh(2))}, s_jobs=s_jobs, k=k)
    total_s = time.perf_counter() - t0
    assert svc.rescale_count == 2 and len(svc._shards) == 2
    assert counts()["K1"] == 4 * 8 + 8 + 2 * 8, counts()["K1"]
    _hold_full(got, want, "rescaled 4 -> None -> 2")
    bank = svc.bank
    restored_ms = {}
    for n in (None, 2):
        t1 = time.perf_counter()
        twin = restore_service(snap["tree"], bank, mesh=card_mesh(n),
                               device=dev if n is None else None)
        torch.cuda.synchronize()
        restored_ms[n] = 1e3 * (time.perf_counter() - t1)
        assert len(twin._shards) == (n or 1) and twin.dispatch_count == 8
        reset_counts()
        got, _ = drive_full(twin, "point", range(8, n_ticks),
                            s_jobs=s_jobs, k=k)
        assert counts()["K1"] == (n or 1) * (n_ticks - 8)
        _hold_full(got, want, f"4-shard snapshot restored onto {n}")
    rows = snap["tree"]["device"]["rows"]
    print(f"[sharding rescale] point run of {s_jobs} jobs: 4 shards, "
          f"rescaled "
          f"onto None before tick 8 and onto 2 shards before tick 16 "
          f"({n_ticks} ticks and the verdict in {total_s:.2f} s); the "
          f"4-shard snapshot before tick 8 (rows {tuple(rows.shape)}) "
          f"restored onto None in {restored_ms[None]:.1f} ms and onto 2 "
          f"shards in {restored_ms[2]:.1f} ms: all three runs bitwise "
          f"phase 7's [{name}]")


def pruned_sharded(name: str, record: dict, n: int = 4, n_ticks: int = 16,
                   c: int = 16, n_fin: int = 32) -> None:
    """Phase 22, third part: phase 20's pruned run on ``n`` shards of the
    card: the packed columns, live sets, scores, live rows and moment
    slab after 16 ticks and the 32 verdicts bitwise phase 20's record,
    every packed width a multiple of ``n``, and K1 launched ``n`` times a
    dispatch."""
    from repro_torch.serve.tuning import TuningService
    bank, queries = record["bank"], record["queries"]
    s_jobs = queries.shape[0]
    svc = TuningService(bank, slots=s_jobs, mesh=card_mesh(n), **PRUNED_KW)
    for j in range(s_jobs):
        svc.submit(f"job{j}", expected_len=n_ticks * c)
    reset_counts()
    kps, tick_s = set(), []
    for t in range(n_ticks):
        for j in range(s_jobs):
            svc.push(f"job{j}", queries[j, t * c:(t + 1) * c])
        t0 = time.perf_counter()
        svc.tick()
        torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t0)
        kps.add(svc._kp)
    assert counts()["K1"] == n * svc.dispatch_count == n * n_ticks
    assert all(kp % n == 0 for kp in kps) and svc.repack_count >= 1
    assert np.array_equal(svc._packed_idx, record["packed_idx"])
    k_live = len(svc._packed_idx)
    for jid, job in svc._jobs.items():
        want = record["allowed"][jid]
        assert (job.allowed is None) == (want is None), jid
        assert want is None or np.array_equal(job.allowed, want), jid
        assert np.array_equal(job.last_sims, record["last_sims"][jid]), jid
        assert job.slot == record["slots"][jid], jid
    assert torch.equal(svc._rows[:, :, :k_live], record["rows"])
    assert torch.equal(svc._moms[..., :k_live], record["moms"])
    verdicts = svc.finish_many([f"job{j}" for j in range(n_fin)])
    for jid, d in verdicts.items():
        assert _verdict_key(d) == record["finals"][jid], jid
    print(f"[sharding pruned] phase 20's pruned run over {n} shards: "
          f"packed widths {sorted(kps)} ({k_live} live at the end, "
          f"{svc._kp // n} columns a shard), {svc.repack_count} re-packs; "
          f"median {1e3 * float(np.median(tick_s)):.3f} ms/tick; K1 "
          f"{n} x {svc.dispatch_count} launches; packed columns, live sets, "
          f"scores, rows, moments and {n_fin} verdicts bitwise phase 20's "
          f"[{name}]")


def k11_bank(rng):
    """The reference sharded test's bank (tests/test_streaming_sharded.py):
    K = 11 references of 18-40 samples, four workloads."""
    from repro_torch.core.database import pack_series
    series = []
    for i in range(11):
        n = int(rng.integers(18, 40))
        t = np.linspace(0, 1, n, dtype=np.float32)
        s = 0.5 + 0.3 * np.sin(2 * np.pi * (1.5 + 0.7 * i) * t) \
            + 0.04 * rng.normal(size=n)
        series.append(np.clip(s, 0, 1).astype(np.float32))
    return pack_series(series, labels=[f"w{i % 4}" for i in range(11)])


def small_sharded(dev, errs: ErrLog, name: str) -> None:
    """Phase 22, fourth part: the reference sharded test's drive on the
    card.  K = 11 references over 8 shards of the card (16 padded
    columns, 2 a shard, the last shards all padding), three jobs pushing
    ragged chunks (7, 3, 9, 0, 5 samples, drifting), band None and 6, in
    point, exact, approx and distance-only mode, and the pruned service
    (``prefilter_top=2``: 8 packed columns, one a shard): every tick's
    scores, probabilities and DP rows, the decisions and the finals
    bitwise the unsharded run on the card, the tick kernel launched 8
    times a dispatch.  A mesh of one (``make_mesh(1)``) bitwise
    ``mesh=None``.  Then each mode's kernel on a 2-column and a
    1-column shard held against its plain version."""
    from repro_torch.kernels.dtw import stream
    from repro_torch.serve.tuning import TuningService
    from repro_torch.sharding import make_mesh
    bank = k11_bank(np.random.default_rng(0))
    rng = np.random.default_rng(100)
    queries = {}
    for j in range(3):
        t = np.linspace(0, 1, 42, dtype=np.float32)
        q = 0.5 + 0.3 * np.sin(2 * np.pi * (1.5 + 0.7 * j) * t) \
            + 0.04 * rng.normal(size=42)
        queries[f"job{j}"] = np.clip(q, 0, 1).astype(np.float32)
    vrs = {j: (0.01 * np.abs(rng.normal(size=42))).astype(np.float32)
           for j in queries}
    kw = dict(threshold=0.5, margin=0.01, stable_ticks=2, min_fraction=0.2,
              slots=4)
    modes = {"point": {}, "exact": dict(min_probability=0.5),
             "approx": dict(min_probability=0.5, prob_mode="approx"),
             "distance": dict(score_in_flight=False),
             "pruned": dict(prefilter_top=2, prefilter_margin=0.02)}

    def drive(svc, prob):
        out, pos = [], {j: 0 for j in queries}
        sizes = {j: (7, 3, 9, 0, 5)[i:] + (7, 3, 9, 0, 5)[:i]
                 for i, j in enumerate(queries)}
        t = 0
        while any(pos[j] < 42 for j in queries):
            for j, q in queries.items():
                sl = slice(pos[j], pos[j] + sizes[j][t % 5])
                if prob:
                    svc.push(j, q[sl], variance=vrs[j][sl])
                else:
                    svc.push(j, q[sl])
                pos[j] = min(sl.stop, 42)
            dec = svc.tick()
            t += 1
            out.append((
                sorted((j, d.matched, d.corr, d.probability)
                       for j, d in dec.items() if d is not None),
                [(j, None if job.last_sims is None
                  else job.last_sims.tolist(),
                  None if job.last_probs is None
                  else job.last_probs.tolist())
                 for j, job in svc._jobs.items()],
                svc._rows[:, :, :len(svc._packed_idx)].cpu()))
        return out, svc

    def same(a, b):
        assert len(a) == len(b)
        for (da, sa, ra), (db, sb, rb) in zip(a, b):
            assert da == db and sa == sb and torch.equal(ra, rb)

    n_runs, widths = 0, {}
    for mode, extra in modes.items():
        prob = "min_probability" in extra
        key = {"point": "K1", "pruned": "K1", "exact": "K4-exact",
               "approx": "K4-approx", "distance": "K3"}[mode]
        for band in ((None, 6) if mode in ("point", "pruned") else (6,)):
            runs = {}
            for n in (None, 8):
                svc = TuningService(bank, band=band, device=dev,
                                    mesh=card_mesh(n), **kw, **extra)
                for j, q in queries.items():
                    svc.submit(j, expected_len=len(q))
                reset_counts()
                trace, svc = drive(svc, prob)
                assert counts()[key] == (n or 1) * svc.dispatch_count
                assert svc.dispatch_count == svc.ticks
                fin = svc.finish_many(list(queries))
                runs[n] = (trace, {j: _verdict_key(d)
                                   for j, d in fin.items()}, svc)
                n_runs += 1
            same(runs[None][0], runs[8][0])
            assert runs[None][1] == runs[8][1], (mode, band)
            svc = runs[8][2]
            assert svc.repack_count == runs[None][2].repack_count
            widths[(mode, band)] = svc._kp // 8
            # the tick kernel on the first shard (2 or 1 real columns) and
            # the last (all padding), against its plain version
            s_cap = svc.slot_capacity
            g = torch.Generator().manual_seed(3)
            chunks = torch.rand((s_cap, 9), generator=g).to(dev)
            vch = (0.01 * torch.rand((s_cap, 9), generator=g)).to(dev)
            nvalid = torch.tensor(([9, 4, 0, 7] * s_cap)[:s_cap],
                                  dtype=torch.int32, device=dev)
            qlens = torch.full((s_cap,), 42, dtype=torch.int32, device=dev)
            for sh in (svc._shards[0], svc._shards[-1]):
                if mode == "distance":
                    args = (sh.rows, sh.ns, sh.bank_t, sh.lengths, chunks,
                            nvalid, qlens)
                    outk = (stream.stream_bank_extend(*args, band=band),)
                    outp = (stream.stream_bank_extend_plain(*args,
                                                            band=band),)
                elif prob:
                    args = (sh.rows, sh.moms, sh.ns, sh.bank_t, sh.lengths,
                            chunks, vch, nvalid, qlens)
                    outk = stream.stream_bank_extend_scored_var(*args,
                                                                band=band)
                    outp = stream.stream_bank_extend_scored_var_plain(
                        *args, band=band)
                else:
                    args = (sh.rows, sh.moms, sh.ns, sh.bank_t, sh.lengths,
                            chunks, nvalid, qlens)
                    outk = stream.stream_bank_extend_scored(*args,
                                                            band=band)
                    outp = stream.stream_bank_extend_scored_plain(
                        *args, band=band)
                # cells still at +inf (slots that never took a sample)
                # must agree, and the rest within the tolerance
                fin = outp[0] < 1e37
                assert torch.equal(fin, outk[0] < 1e37), (mode, band)
                e = errs.diff(key, outk[0], outp[0], fin)
                if len(outk) > 1:
                    e = max(e, errs.diff(key, outk[1], outp[1],
                                         fin[None].expand_as(outp[1])))
                assert e <= SMOOTH_TOL, (mode, band, e)
    # a mesh of one is mesh=None
    one = {}
    for mesh in (None, make_mesh(1)):
        svc = TuningService(bank, band=6, device=dev, mesh=mesh, **kw)
        for j, q in queries.items():
            svc.submit(j, expected_len=len(q))
        trace, svc = drive(svc, False)
        one[mesh is None] = (trace, {j: _verdict_key(d) for j, d in
                                     svc.finish_many(list(queries)).items()})
    same(one[True][0], one[False][0])
    assert one[True][1] == one[False][1]
    print(f"[sharding small] K = 11 over 8 shards of the card, {n_runs} "
          f"runs (point and pruned at band None and 6; exact, approx, "
          f"distance-only at band 6): scores, probabilities, rows, "
          f"decisions and finals bitwise the unsharded runs, the tick "
          f"kernel 8 launches a dispatch; columns a shard "
          f"{sorted(set(widths.values()))}; each tick kernel on a first "
          f"and a last (all-padding) shard within {SMOOTH_TOL:g} of its "
          f"plain version; make_mesh(1) bitwise mesh=None")


def interleaved_point(dev, name: str, n: int = 4, s_jobs: int = 256,
                      k: int = 256, n_ticks: int = 24) -> None:
    """Phase 22, the sharded tick's cost: phase 7's point schedule on an
    unsharded and an ``n``-shard service side by side, their ticks
    interleaved (the order swapped every tick) so that both see the same
    host; every tick's scores bitwise the other's.  Prints each
    service's median ms/tick (host clock + synchronise) and the median
    host time of its dispatch (``_fan_out``: the launches and the tick
    tails enqueued, no synchronise) beside the rest of the tick."""
    _, queries, _ = full_inputs("point", s_jobs, k, n_ticks * 16, 0)
    svcs = {1: _full_service("point", None, s_jobs, k, dev=dev),
            n: _full_service("point", card_mesh(n), s_jobs, k)}
    fan_s = {key: [] for key in svcs}
    for key, svc in svcs.items():
        inner = svc._fan_out

        def timed(*args, _inner=inner, _key=key):
            t0 = time.perf_counter()
            out = _inner(*args)
            fan_s[_key].append(time.perf_counter() - t0)
            return out
        svc._fan_out = timed
    tick_s = {key: [] for key in svcs}
    for t in range(n_ticks):
        order = list(svcs) if t % 2 == 0 else list(svcs)[::-1]
        for key in order:
            svc = svcs[key]
            for i in range(s_jobs):
                svc.push(f"job{i}", queries[i, t * 16:(t + 1) * 16])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc.tick()
            torch.cuda.synchronize()
            tick_s[key].append(time.perf_counter() - t0)
        for i in range(s_jobs):
            assert np.array_equal(svcs[1]._jobs[f"job{i}"].last_sims,
                                  svcs[n]._jobs[f"job{i}"].last_sims)
    med = {key: 1e3 * float(np.median(v)) for key, v in tick_s.items()}
    fan = {key: 1e3 * float(np.median(v)) for key, v in fan_s.items()}
    print(f"[sharding interleaved] point, {s_jobs} jobs x K={k}, "
          f"{n_ticks} ticks each, interleaved: median ms/tick unsharded "
          f"{med[1]:.3f}, {n} shards {med[n]:.3f} ({med[n] - med[1]:+.3f}); "
          f"dispatch host time (launches and tails enqueued) unsharded "
          f"{fan[1]:.3f}, {n} shards {fan[n]:.3f} ms; the rest of the tick "
          f"{med[1] - fan[1]:.3f} / {med[n] - fan[n]:.3f} ms; scores bitwise "
          f"on every tick [{name}]")


def sharding_phase(dev, errs: ErrLog, name: str, runs: dict, record: dict,
                   k1_ms: float) -> None:
    """Phase 22: bank sharding on the card (see the module docstring)."""
    small_sharded(dev, errs, name)
    sharded_full(dev, errs, name, runs, k1_ms)
    interleaved_point(dev, name)
    rescale_full(dev, name, runs)
    pruned_sharded(name, record)


# ---------------------------------------------------------------------------
# phase 23: model serving on the card
# ---------------------------------------------------------------------------

#: The shapes phase 23's model path gives K9 and K10 (configs/zamba2_7b.py:
#: 32 heads of 3584 / 32 = 112, 112 SSD heads of 64, state 64, chunk 256;
#: configs/granite_20b.py: 48 heads, kv 1, dh 128), bf16 at S = 4096 and
#: float32 at S = 320, padded as the model pads them (64 for K9, the chunk
#: for K10): (B, H, KV, S, dh) and (B, H, S, dk, dv, chunk).
MODEL_K9 = ((4, 32, 32, 4096, 112, torch.bfloat16),
            (2, 48, 1, 4096, 128, torch.bfloat16),
            (1, 32, 32, 384, 112, torch.float32),
            (1, 48, 1, 384, 128, torch.float32))
MODEL_K10 = ((4, 112, 4096, 64, 64, 256, torch.bfloat16),
             (1, 112, 512, 64, 64, 256, torch.float32))


def check_model_kernels(dev, errs: ErrLog, name: str) -> dict:
    """K9 and K10 at the shapes of phase 23's model path against their
    plain versions (one launch each), each bf16 shape timed by CUDA
    events.  Returns {"K9": ms, "K9-granite": ms, "K10": ms}."""
    from repro_torch.kernels.attention import kernel as k9
    from repro_torch.kernels.gla import kernel as k10
    gen = torch.Generator(device=dev).manual_seed(23)
    ms = {}
    for (b, h, kv, s, dh, dtype), key in zip(
            MODEL_K9, ("K9", "K9-granite", None, None)):
        q, k, v = _attn_inputs(gen, dev, b, h, kv, s, s, dh, dh, dtype)
        before = counts()
        o = k9.flash_forward(q, k, v, 64, 64)
        torch.cuda.synchronize()
        launched(before, **{_k9_key(dtype).replace("-", "_"): 1})
        e = _attn_diff(errs, o, k9.flash_forward_plain(q, k, v),
                       f"model-path K9 {(b, h, kv, s, dh, dtype)}")
        line = (f"[model K9] B={b} H={h} KV={kv} S={s} dh={dh} "
                f"{str(dtype)[6:]}: max abs err {e:.3g} ({_attn_limit(o)})")
        if key:
            ms[key] = cuda_ms(lambda: k9.flash_forward(q, k, v, 64, 64), 5)
            line += f"; {ms[key]:.4f} ms [{name}]"
        print(line)
        del q, k, v, o
    for b, h, s, dk, dv, chunk, dtype in MODEL_K10:
        q, k, v, la = _gla_inputs(gen, dev, b, h, s, dk, dv, dtype)
        g = k10.chunk_cumsum(la, chunk)
        before = counts()
        res = k10.gla_chunks(q, k, v, g, chunk)
        torch.cuda.synchronize()
        launched(before, K10=1)
        nd = _gla_diff(errs, res, k10.gla_chunks_plain(q, k, v, g, chunk),
                       dtype == torch.bfloat16)
        line = (f"[model K10] B={b} H={h} S={s} dk={dk} dv={dv} chunk="
                f"{chunk} {str(dtype)[6:]}: within rtol {GLA_RTOL:g} / "
                f"atol {GLA_ATOL:g} ({nd} output elements differ)")
        if dtype == torch.bfloat16:
            ms["K10"] = cuda_ms(lambda: k10.gla_chunks(q, k, v, g, chunk), 5)
            line += f"; {ms['K10']:.4f} ms [{name}]"
        print(line)
        del q, k, v, la, g, res
    return ms


def _model(arch: str, dev, seed: int, **over):
    """``arch``'s published config (``over`` replaced) with random weights
    drawn on ``dev`` from a generator seeded ``seed``."""
    from repro_torch import configs, models
    cfg = dataclasses.replace(configs.get(arch), **over)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, models.init(cfg, generator=gen, device=dev)


def _prompts(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _only(got: dict, **want) -> bool:
    return got == {**{key: 0 for key in got}, **want}


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| (float64)."""
    g, w = got.double(), want.double()
    return float((g - w).abs().max() / w.abs().max())


#: cuBLAS's kernel names (the GEMMs of every projection and MLP).
GEMM_NAMES = ("nvjet", "gemm", "gemv", "cutlass", "xmma")


#: K9's bf16 kernels (``flash_wgmma.cu``) and K10's (``gla.cu``).
K9_NAMES = ("flash_wgmma_kernel", "flash_mla_kernel")
K10_NAMES = ("gla_ws_kernel", "gla_mma_kernel", "gla_fma_kernel",
             "gla_wide_scores_kernel", "gla_wide_kernel")


def _kernel_times(prof) -> list:
    """[(name, device ms, launches)] of a CUDA-only profile."""
    out = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        out.append((ev.key, (ev.self_cuda_time_total if t is None else t)
                    / 1e3, ev.count))
    return out


def gemm_names(fn) -> set:
    """The names of the cuBLAS kernels (GEMM_NAMES) a call of ``fn``
    launches (a ``torch.profiler`` trace of three calls), to find them in
    a larger trace; three tries, as a session may come back without
    records (``device_ms``; a session's first launch has gone missing)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        names = {key for key, ms, _ in _kernel_times(prof)
                 if ms > 0 and any(g in key for g in GEMM_NAMES)}
        if names:
            return names
    return set()


def traced_ms(fn, top: int = 6, named=frozenset()) -> dict:
    """Device time of one call of ``fn``, from ``torch.profiler``: "all"
    (every kernel and copy), "K9", "K10" and "sLSTM" (theirs), "gemm"
    (cuBLAS's, GEMM_NAMES, less "named"), "named" (the kernels whose
    names are in ``named``), "wall" (the call's host-clock ms under the
    profiler) and "top" (the ``top`` kernels by device time: [(name, ms,
    launches)])."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    out = {"all": 0.0, "K9": 0.0, "K10": 0.0, "sLSTM": 0.0, "gemm": 0.0,
           "named": 0.0, "wall": wall}
    by = []
    for key, ms, count in _kernel_times(prof):
        out["all"] += ms
        by.append((key[:60], ms, count))
        if any(k in key for k in K9_NAMES):
            out["K9"] += ms
        if any(k in key for k in K10_NAMES):
            out["K10"] += ms
        if "slstm_scan_kernel" in key:
            out["sLSTM"] += ms
        if key in named:
            out["named"] += ms
        elif any(g in key for g in GEMM_NAMES):
            out["gemm"] += ms
    out["top"] = sorted(by, key=lambda e: -e[1])[:top]
    return out


def _top_str(tr: dict) -> str:
    return "; ".join(f"{n} {ms:.1f} ms x{c}" for n, ms, c in tr["top"])


class MoeRouting:
    """While open, records the routing of every MoE block call of
    ``model`` through forward hooks: (layer, top_e [T, K], the top K + 1
    probabilities in descending order [T, K + 1], each token's dropped
    assignments [T]), on the CPU.  The hook recomputes the routing from
    the block's input with ``models.moe.route`` and ``dispatch``, the
    block's own functions; it is removed on close, so timed runs carry
    none of it."""

    def __init__(self, model) -> None:
        self.model, self.calls, self.handles = model, [], []

    def __enter__(self):
        for i, layer in enumerate(self.model.layers):
            if hasattr(layer, "moe"):
                self.handles.append(
                    layer.moe.register_forward_hook(self._hook(i)))
        return self

    def __exit__(self, *exc) -> None:
        for h in self.handles:
            h.remove()

    def _hook(self, layer: int):
        def hook(mod, args, out):
            from repro_torch.models import moe
            x, cfg = args[0], args[1]
            x2d = x.reshape(-1, x.shape[-1])
            probs, _, top_e = moe.route(x2d, mod.router.w, cfg)
            _, keep = moe.dispatch(top_e, 0, cfg.num_experts,
                                   moe._capacity(x2d.shape[0], cfg))
            top = torch.sort(probs, dim=-1, descending=True,
                             stable=True).values[:, :cfg.top_k + 1]
            self.calls.append((layer, top_e.cpu(), top.cpu(),
                               (~keep).reshape(top_e.shape).sum(1).cpu()))
        return hook


def _experts(call, shape, at: int) -> torch.Tensor:
    """The sorted experts chosen for the tokens at position ``at`` of each
    row of a recorded MoE call (``MoeRouting``) whose T tokens are
    ``shape`` (rows, positions)."""
    return torch.sort(call[1].reshape(*shape, -1)[:, at], 1).values


def model_launches(cfg, decode: bool = False) -> dict:
    """The kernel launches of one prefill (or ``decode`` step) of ``cfg``
    by table key, from its block kinds: K9 once an attention layer and
    K10 once a Mamba2 layer in the prefill; an mLSTM layer's one scan (the
    numerator and the normalizer as dh + 1 columns of v) launches K10
    once, or the wide route's two kernels (K10-mlstm) when dh + 1 is over
    128 (a bf16 model); the sLSTM scan once an sLSTM layer in the prefill
    and in a decode step."""
    from repro_torch.models.model import block_kinds
    kinds = block_kinds(cfg)
    dh = cfg.ssm_expand * cfg.d_model // cfg.num_heads
    n_mlstm = kinds.count("mlstm")
    wide = dh + 1 > 128
    want = {"sLSTM": kinds.count("slstm")}
    if not decode:
        want.update(
            K9=sum(kinds.count(k) for k in ("attn", "attn_dense",
                                             "attn_moe", "shared_attn")),
            K10=kinds.count("mamba2") + (0 if wide else n_mlstm),
            K10_mlstm=2 * n_mlstm if wide else 0)
    return {key.replace("_", "-"): n for key, n in want.items() if n}


def _trio(model, cfg, toks: torch.Tensor, dev, pre: dict, dec: dict):
    """One prefill of ``toks`` [b, s], a greedy decode step at s and
    ``forward`` over the s + 1 tokens, every count set to 0 just before
    each and read just after (``pre``: the launches by table key in the
    prefill and in forward; ``dec``: in the step), the MoE routing of
    all three recorded.  Returns (prefill logits, step logits, forward
    logits, forward's aux, the routing calls)."""
    from repro_torch import models
    b, s = toks.shape
    with torch.inference_mode(), MoeRouting(model) as routing:
        cache = models.make_cache(cfg, b, s + 1, concrete=True, device=dev)
        reset_counts()
        last, cache = models.prefill(model, toks, cache, cfg)
        torch.cuda.synchronize()
        assert _only(counts(), **pre), counts()
        nxt = last.argmax(-1)
        reset_counts()
        step, cache = models.decode_step(model, nxt, cache, s, cfg)
        torch.cuda.synchronize()
        assert _only(counts(), **dec), counts()
        del cache
        reset_counts()
        full, aux = models.forward(model, torch.cat([toks, nxt[:, None]], 1),
                                   cfg)
        torch.cuda.synchronize()
        assert _only(counts(), **pre), counts()
    assert torch.isfinite(full.float()).all() and torch.isfinite(aux)
    return last, step, full, aux, routing.calls


#: Phase 24: the prompt length of the dropless decode check (its capacity
#: C = T holds [E, b (s + 1), D] expert inputs: 1.7 GB for deepseek-v2 at
#: b = 4).
DROPLESS_S = 256


def _moe_checks(model, cfg, toks: torch.Tensor, dev, pre: dict,
                last: torch.Tensor, calls: list, n_moe: int) -> dict:
    """The MoE arch's checks against ``forward`` (phase 24 (b), (c)).

    An MoE layer's capacity C is taken over the call's tokens and drops
    assignments in flat token order, so a prefill of s tokens, forward
    over s + 1 and a decode step (T = b, never full) drop differently
    wherever an expert overflows.  So: the prefill is held to forward over
    the same s tokens (the same C, order and drops); the decode step is
    held to forward over s + 1 tokens where no assignment is dropped, at
    the capacity factor E / top_k (C = T) on the prompts cut to
    DROPLESS_S, on the rows whose decode token the two route alike in
    every layer (at least one).  ``calls``: the published config's trio
    (``_trio``); its drops per layer, the busiest expert's load against
    the mean, forward's drops of the decode token and the decode
    step's routing against forward's are returned for the report."""
    from repro_torch import models
    b, s = toks.shape
    E, K = cfg.num_experts, cfg.top_k
    pre_c, dec_c = calls[:n_moe], calls[n_moe:2 * n_moe]
    fwd_c = calls[2 * n_moe:]
    assert sum(int(c[3].sum()) for c in dec_c) == 0, "decode drops"
    with torch.inference_mode(), MoeRouting(model) as same:
        reset_counts()
        full_s, _ = models.forward(model, toks, cfg)
        torch.cuda.synchronize()
        assert _only(counts(), **pre), counts()
    e_pre = _rel(last, full_s[:, s - 1])
    del full_s
    rec = dict(
        e_pre=e_pre,
        same_route=sum(int((c[1] != p[1]).any(1).sum())
                       for c, p in zip(same.calls, pre_c)),
        drops=[int(c[3].sum()) for c in pre_c],
        hot=[round(float(torch.bincount(c[1].reshape(-1), minlength=E).max())
                   / (b * s * K / E), 2) for c in pre_c],
        fwd_drops=[int(c[3].sum()) for c in fwd_c],
        last_drops=sum(int(f[3].reshape(b, s + 1)[:, s].sum())
                       for f in fwd_c),
        route_diff=sum(int((_experts(d, (b, 1), 0) != _experts(
            f, (b, s + 1), s)).any(1).sum()) for d, f in zip(dec_c, fwd_c)))
    cfg_d = dataclasses.replace(cfg, capacity_factor=E / K)
    sd = min(DROPLESS_S, s)
    last_d, step_d, full_d, _, calls_d = _trio(
        model, cfg_d, toks[:, :sd].contiguous(), dev, pre, {})
    assert all(int(c[3].sum()) == 0 for c in calls_d), "dropless drops"
    flips = torch.zeros(b, dtype=torch.bool)
    for d, f in zip(calls_d[n_moe:2 * n_moe], calls_d[2 * n_moe:]):
        flips |= (_experts(d, (b, 1), 0)
                  != _experts(f, (b, sd + 1), sd)).any(1)
    rows = (~flips).nonzero()[:, 0].to(dev)
    assert len(rows), "every row's decode token routed otherwise"
    rec.update(e_pre_dropless=_rel(last_d, full_d[:, sd - 1]),
               e_dec_dropless=_rel(step_d[rows], full_d[rows, sd]),
               rows_dropless=len(rows), dropless_s=sd)
    del full_d
    for key in ("e_pre", "e_pre_dropless", "e_dec_dropless"):
        assert rec[key] <= MODEL_BF16_REL, (cfg.name, key, rec[key])
    return rec


def _launch_str(want: dict) -> str:
    return ", ".join(f"{key} {n}" for key, n in want.items() if n) \
        or "nothing"


def serve_full(dev, name: str, arch: str, b: int, s: int, new: int,
               pre: dict, kernel_ms: dict, named=frozenset(),
               named_what: str = "", after=None, **over) -> dict:
    """Phase 23 (a) and (b), phase 24 (b) and (c), phase 25 (c): ``arch``
    at full width (``over`` cuts its depth) with random bf16 weights
    serves ``b`` prompts of ``s`` tokens for ``new`` tokens through
    ``ServeEngine.generate``, every count set to 0 just before and read
    just after: ``pre`` (launches by table key, which must be
    ``model_launches``' count for the arch) in the prefill and
    ``model_launches(decode=True)`` in each decode step (K9 and K10
    none).  Then one prefill (the same launches) and one decode step are
    held to ``forward`` over s + 1 tokens within MODEL_BF16_REL (an MoE
    arch as ``_moe_checks`` says); the prefill and the decode step are
    timed on the host clock around a synchronised call (prefill: median
    of 3, each on a fresh cache; decode: median of 16 steps) and one
    prefill and one decode step are traced by ``torch.profiler``.  Each
    kernel's share of the prefill: ``kernel_ms[key]``, the CUDA-event
    time of its launches in one prefill at the same shapes
    (``check_model_kernels``, ``check_mla_kernels``,
    ``check_mlstm_kernels``).  The traced prefill's kernels named in
    ``named`` are split out of the GEMMs as ``named_what``.  An MoE
    arch's routing is recorded (``MoeRouting``) in the checked prefill,
    decode step and forward (``_moe_checks``).  ``after(model, cfg,
    toks, rec)``, when given, runs on the same model last and adds its
    numbers.  Returns the numbers it prints."""
    from repro_torch import models
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.model import block_kinds
    from repro_torch.serve import ServeEngine
    cfg, model = _model(arch, dev, 23, **over)
    n_par = models.param_count(model)
    kinds = block_kinds(cfg)
    assert pre == model_launches(cfg), (arch, pre, model_launches(cfg))
    dec = model_launches(cfg, decode=True)
    gen = {key: n + (new - 1) * dec.get(key, 0) for key, n in pre.items()}
    n_moe = kinds.count("attn_moe")
    prompts = _prompts(cfg, b, s, 23)
    engine = ServeEngine(model, cfg, max_len=s + new)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new=new)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    assert _only(got, **gen), (arch, got, gen)
    assert out.shape == (b, new) and out.dtype == np.int32
    assert ((out >= 0) & (out < cfg.vocab_size)).all()
    toks = torch.as_tensor(prompts, device=dev)
    last, step, full, aux, calls = _trio(model, cfg, toks, dev, pre, dec)
    assert (float(aux) > 0) == (n_moe > 0), (arch, float(aux))
    e_dec = _rel(step, full[:, s])
    if not n_moe:
        e_pre = _rel(last, full[:, s - 1])
        del full
        assert e_pre <= MODEL_BF16_REL and e_dec <= MODEL_BF16_REL, \
            (arch, e_pre, e_dec)
        moe_rec = {}
    else:
        del full
        moe_rec = _moe_checks(model, cfg, toks, dev, pre, last, calls,
                              n_moe)
        e_pre = moe_rec["e_pre"]
        del step
    with torch.inference_mode():

        def fresh():
            return models.make_cache(cfg, b, s + new, concrete=True,
                                     device=dev)

        pre_times = []
        for _ in range(3):
            cache = fresh()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, cache = models.prefill(model, toks, cache, cfg)
            torch.cuda.synchronize()
            pre_times.append(1e3 * (time.perf_counter() - t0))
        tok, dec_times = last.argmax(-1), []
        for i in range(16):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = models.decode_step(model, tok, cache, s + i, cfg)
            tok = logits.argmax(-1)
            torch.cuda.synchronize()
            dec_times.append(1e3 * (time.perf_counter() - t0))
        dec_tr = traced_ms(
            lambda: models.decode_step(model, tok, cache, s + 16, cfg))
        del cache
        cache = fresh()
        dev_ms = traced_ms(lambda: models.prefill(model, toks, cache, cfg),
                           named=named)
        del cache
    t_pre, t_dec = float(np.median(pre_times)), float(np.median(dec_times))
    rec = dict(arch=arch, layers=cfg.num_layers, params=n_par, B=b, S=s,
               new=new, generate_s=t_gen, prefill_ms=t_pre,
               prefill_tok_s=b * s / (t_pre / 1e3), decode_ms=t_dec,
               decode_tok_s=b / (t_dec / 1e3), peak_gb=peak / 1e9,
               e_prefill=e_pre, e_decode=e_dec, traced=dev_ms,
               traced_decode=dec_tr, launches=got, **moe_rec,
               shares={key: ms / t_pre for key, ms in kernel_ms.items()})
    kinds_str = ", ".join(f"{kinds.count(k)} {k}" for k in dict.fromkeys(
        kinds))
    parts = {"GEMMs": dev_ms["gemm"], "K9": dev_ms["K9"],
             "K10": dev_ms["K10"], "sLSTM": dev_ms["sLSTM"]}
    if named_what:
        parts[named_what] = dev_ms["named"]
    rest = dev_ms["all"] - sum(parts.values())
    print(f"[serve {arch}] {cfg.num_layers} layers ({kinds_str}), "
          f"{n_par / 1e9:.3f} B params bf16; "
          f"ServeEngine.generate {b} x {s} tokens + {new} new: "
          f"{t_gen:.2f} s, launches {_launch_str(got)} (a prefill "
          f"{_launch_str(pre)}, a decode step {_launch_str(dec)}); "
          f"prefill {t_pre:.1f} ms (median of 3; "
          f"{rec['prefill_tok_s']:.0f} tokens/s), decode {t_dec:.2f} ms a "
          f"step (median of 16; {rec['decode_tok_s']:.1f} tokens/s), peak "
          f"memory {rec['peak_gb']:.2f} GB; "
          + "; ".join(f"{key}"
                      f"{f' ({pre[key]} launches)' if key in pre else ''} "
                      f"{ms:.4f} ms = {100 * ms / t_pre:.2f}%"
                      for key, ms in kernel_ms.items())
          + f" of the prefill (CUDA events); one traced prefill: kernels "
          f"{dev_ms['all']:.1f} ms device "
          f"({100 * dev_ms['all'] / t_pre:.1f}% of the median prefill): "
          + ", ".join(f"{key} {ms:.2f}" for key, ms in parts.items())
          + f", the rest (elementwise, copies) {rest:.1f}"
          f" ms; prefill logits vs forward's at S - 1 "
          f"{e_pre:.3g}, decode step's vs forward's at S {e_dec:.3g} "
          f"(relative max, limit {MODEL_BF16_REL:g}"
          f"{'; MoE: as below' if n_moe else ''}) [{name}]")
    print(f"[serve {arch}] the traced prefill's top kernels: "
          f"{_top_str(dev_ms)}")
    if n_moe:
        m = moe_rec
        print(f"[serve {arch}] MoE routing: assignments dropped by the "
              f"prefill's capacity C = {moe_lib._capacity(b * s, cfg)} "
              f"({b * s} tokens x top {cfg.top_k} over {cfg.num_experts} "
              f"experts) in each of the {n_moe} MoE layers: {m['drops']} "
              f"(the busiest expert {m['hot']} x the mean load); forward "
              f"over the same {s} tokens routes {m['same_route']} tokens "
              f"otherwise and gives the prefill's logits within "
              f"{m['e_pre']:.3g}; forward over S + 1 (C = "
              f"{moe_lib._capacity(b * (s + 1), cfg)}) drops {m['fwd_drops']}"
              f", {m['last_drops']} of them the decode token's, so the "
              f"decode step (T = {b}, nothing dropped) computes another "
              f"function there: decode vs forward at S {e_dec:.3g}, not "
              f"held; (token, layer) routings that differ between them: "
              f"{m['route_diff']} of {b * n_moe}. Dropless (capacity "
              f"factor {cfg.num_experts / cfg.top_k:g}) on the prompts cut "
              f"to {m['dropless_s']}: prefill vs forward "
              f"{m['e_pre_dropless']:.3g}"
              f", decode vs forward {m['e_dec_dropless']:.3g} on "
              f"{m['rows_dropless']} of {b} rows (the others routed the "
              f"decode token otherwise in some layer) (limit "
              f"{MODEL_BF16_REL:g}); forward's aux loss {float(aux):.6g}")
    print(f"[serve {arch}] one traced decode step: {dec_tr['wall']:.2f} ms "
          f"wall, kernels {dec_tr['all']:.2f} ms device "
          f"({100 * dec_tr['all'] / dec_tr['wall']:.1f}% busy; GEMMs "
          f"{dec_tr['gemm']:.2f} ms); top: "
          f"{_top_str(dec_tr)}")
    del engine
    if after is not None:
        rec.update(after(model, cfg, toks, rec))
    del model
    torch.cuda.empty_cache()
    return rec


def _cache_cpu(cache: dict) -> list:
    return [{n: t.detach().to("cpu", copy=True) for n, t in layer.items()}
            for layer in cache["layers"]]


def _serve_steps(model, cfg, toks: torch.Tensor, tokens, dev):
    """One prefill of ``toks`` and a decode step for each of ``tokens``
    (None: take the greedy ones) on ``dev``; the logits, the caches after
    the prefill and after the last step (on the CPU), and the tokens."""
    from repro_torch import models
    b, s = toks.shape
    n = 3 if tokens is None else len(tokens)
    with torch.inference_mode():
        cache = models.make_cache(cfg, b, s + n, concrete=True, device=dev)
        last, cache = models.prefill(model, toks.to(dev), cache, cfg)
        logits, pre_cache, fed = [last.cpu()], _cache_cpu(cache), []
        for i in range(n):
            tok = last.argmax(-1) if tokens is None else tokens[i].to(dev)
            last, cache = models.decode_step(model, tok, cache, s + i, cfg)
            fed.append(tok.cpu())
            logits.append(last.cpu())
        return logits, pre_cache, _cache_cpu(cache), fed


def f32_card_vs_cpu(dev, name: str, arch: str, layers: int,
                    expect: dict, s: int = 320) -> dict:
    """Phase 23 (c), 24 (d), 25 (d): ``arch`` at full width cut to
    ``layers`` layers in float32, one prompt of ``s`` tokens: the prefill,
    its caches and three greedy decode steps on the card (``expect``:
    their launches by table key), then the same weights moved to the CPU fed the
    same
    tokens (the plain versions, which the CPU tests hold to the JAX
    package): logits and every cache within MODEL_F32_RTOL /
    MODEL_F32_ATOL.  An MoE arch's routing (``MoeRouting``) on the card
    must equal the CPU's in every MoE call (the prefill and each step),
    token for token; a token may differ only where the CPU's
    probabilities at the first differing rank and the next are within
    ROUTE_TIE of each other, and each such token is printed as a
    witness."""
    cfg, model = _model(arch, dev, 23, num_layers=layers,
                        param_dtype="float32", dtype="float32")
    toks = torch.as_tensor(_prompts(cfg, 1, s, 23))
    reset_counts()
    with MoeRouting(model) as card_routing:
        card = _serve_steps(model, cfg, toks, None, dev)
    torch.cuda.synchronize()
    launches = counts()
    assert _only(launches, **expect), (launches, expect)
    model.to("cpu")
    torch.cuda.empty_cache()
    with MoeRouting(model) as host_routing:
        host = _serve_steps(model, cfg, toks, card[3], torch.device("cpu"))
    n_routed, witnesses = 0, []
    assert len(card_routing.calls) == len(host_routing.calls)
    for (layer, e_card, _, _), (layer_h, e_host, p_host, _) in zip(
            card_routing.calls, host_routing.calls):
        assert layer == layer_h and e_card.shape == e_host.shape
        n_routed += e_card.shape[0]
        for t in (e_card != e_host).any(1).nonzero()[:, 0].tolist():
            j = int((e_card[t] != e_host[t]).nonzero()[0, 0])
            gap = float(p_host[t, j] - p_host[t, j + 1])
            witnesses.append((layer, t, j, gap))
            assert gap <= ROUTE_TIE, (arch, layer, t, j, gap)
    if cfg.is_moe:
        print(f"[serve f32] {arch}: routing card vs CPU over "
              f"{len(card_routing.calls)} MoE calls, {n_routed} tokens: "
              f"{len(witnesses)} differ"
              + "".join(f"; layer {lay} token {t} rank {j}: the CPU's "
                        f"probabilities there {gap:.3g} apart"
                        for lay, t, j, gap in witnesses))
    errs = {}
    for what, got, want in (("logits", card[0], host[0]),
                            ("prefill caches",
                             [t for c in card[1] for t in c.values()],
                             [t for c in host[1] for t in c.values()]),
                            ("final caches",
                             [t for c in card[2] for t in c.values()],
                             [t for c in host[2] for t in c.values()])):
        errs[what] = max(float((g.double() - w.double()).abs().max())
                         for g, w in zip(got, want))
        assert all(torch.isfinite(g).all() for g in got), (arch, what)
        assert all(_close(g, w, MODEL_F32_RTOL, MODEL_F32_ATOL)
                   for g, w in zip(got, want)), (arch, what, errs[what])
    errs["launches"] = launches
    print(f"[serve f32] {arch}, {layers} layers at full width, S={s}: "
          f"card ({_launch_str(expect)}) vs CPU on the same weights: "
          f"max abs err logits (prefill and 3 decode steps) "
          f"{errs['logits']:.3g}, caches after the prefill "
          f"{errs['prefill caches']:.3g}, after the last step "
          f"{errs['final caches']:.3g} (rtol {MODEL_F32_RTOL:g}, atol "
          f"{MODEL_F32_ATOL:g})")
    del model
    return errs


def model_phase(dev, errs: ErrLog, name: str) -> dict:
    """Phase 23: model serving on the card (see the module docstring).
    Returns the model path's launches, by table key and run."""
    t0 = time.perf_counter()
    kernel_ms = check_model_kernels(dev, errs, name)
    serve_full(dev, name, "zamba2-7b", 4, 4096, 32, {"K9": 13, "K10": 68},
               {"K9": 13 * kernel_ms["K9"], "K10": 68 * kernel_ms["K10"]})
    serve_full(dev, name, "granite-20b", 2, 4096, 16, {"K9": 8},
               {"K9": 8 * kernel_ms["K9-granite"]}, num_layers=8)
    f32_card_vs_cpu(dev, name, "zamba2-7b", 6, {"K9-f32": 1, "K10": 5})
    f32_card_vs_cpu(dev, name, "granite-20b", 2, {"K9-f32": 2})
    print(f"[models] phase 23 in {time.perf_counter() - t0:.1f} s [{name}]")
    return {"K9": {"zamba2-7b prefill (81 layers)": 13,
                   "granite-20b prefill (8 of 52 layers)": 8},
            "K9-f32": {"zamba2-7b f32 prefill (6 layers)": 1,
                       "granite-20b f32 prefill (2 layers)": 2},
            "K10": {"zamba2-7b prefill (81 layers)": 68,
                    "zamba2-7b f32 prefill (6 layers)": 5}}


# ---------------------------------------------------------------------------
# phase 24: MoE/MLA serving on the card
# ---------------------------------------------------------------------------

#: The shapes phase 24's model path gives K9 (configs/deepseek_v2_236b.py:
#: 128 heads, q and k 128 + 64 wide, v 128, H = KV; configs/
#: kimi_k2_1t_a32b.py: 64 heads): (B, H, KV, S, dh, dv, dtype, table key,
#: what).  bf16 at S = 4096, float32 at S = 384 (320 padded to 64).
MLA_K9 = ((4, 128, 128, 4096, 192, 128, torch.bfloat16, "K9-mla",
           "deepseek"),
          (2, 64, 64, 4096, 192, 128, torch.bfloat16, None, "kimi"),
          (1, 128, 128, 384, 192, 128, torch.float32, "K9-f32-mla",
           "deepseek f32"))


#: The f32 MLA kernel's edges (``flash_tf32_mla_kernel``): (B, H, KV, S,
#: T, dh, dv, causal, q, k, v one element into their storage).  S != T
#: both ways, S = T = 96 (ragged against the 64-row query and 32-row kv
#: tiles), a GQA group of 2, non-causal, rows that are not whole 16-byte
#: chunks (dh 130, dv 10: the producer's element-wise loads) and storage
#: that is not 16-byte aligned.
MLA_F32_EDGES = ((1, 2, 2, 128, 192, 192, 128, True, False),
                 (1, 2, 2, 192, 128, 192, 128, True, False),
                 (1, 2, 2, 96, 96, 192, 128, True, False),
                 (1, 4, 2, 128, 128, 192, 128, True, False),
                 (1, 2, 2, 128, 128, 192, 128, False, False),
                 (1, 2, 2, 128, 96, 130, 10, True, False),
                 (1, 2, 2, 128, 96, 192, 128, True, True),
                 (1, 2, 2, 96, 128, 130, 10, False, True))


def _sdpa_ms(q, k, v) -> float:
    """``scaled_dot_product_attention``'s CUDA-event ms on (q, k, v)
    through its fused backends (the math backend would hold the [S, T]
    weights: 17 GB at MLA's bf16 shape).  A yardstick only: the port
    never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION]
    with sdpa_kernel(backends):
        return cuda_ms(lambda: _sdpa(q, k, v), 5)


def check_mla_kernels(dev, errs: ErrLog, name: str):
    """Phase 24 (a): K9 at MLA's shapes (MLA_K9) against its plain version,
    one launch each (bf16: ``flash_mla_kernel``, f32:
    ``flash_tf32_mla_kernel``), timed by CUDA events (and a launch's
    device time from the profiler) beside the plain version, the bound
    (2 (dh + dv) FLOPs a causal query-key pair: bf16 at the bf16 tensor
    peak, f32 as three TF32 products at the TF32 peak; each input read
    and the output written once) and SDPA; for each shape, how evenly
    the persistent blocks' work list (``kernel.mla_tiles``) spreads the
    causal kv tiles.  Then the f32 kernel at MLA_F32_EDGES, one launch
    each within ATTN_F32_TOL.  Returns (the two table rows, {what: ms})."""
    from repro_torch.kernels.attention import kernel as k9
    gen = torch.Generator(device=dev).manual_seed(24)
    mem_bps, _, bf16_flops, tf32_flops = card_peaks(name)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, ms = [], {}
    for b, h, kv, s, dh, dv, dtype, key, what in MLA_K9:
        q, k, v = _attn_inputs(gen, dev, b, h, kv, s, s, dh, dv, dtype)
        before = counts()
        o = k9.flash_forward(q, k, v, 64, 64)
        torch.cuda.synchronize()
        launched(before, **{_k9_key(dtype).replace("-", "_"): 1})
        assert o.shape == (b, h, s, dv) and torch.isfinite(o.float()).all()
        op = k9.flash_forward_plain(q, k, v, 64, 64)
        e = _attn_diff(errs, o, op, f"MLA K9 {what}",
                       key or "K9-mla")
        mean = float(op.float().abs().mean())
        del o, op
        ms[what] = cuda_ms(lambda: k9.flash_forward(q, k, v, 64, 64), 5)
        dev_ms = device_ms(lambda: k9.flash_forward(q, k, v, 64, 64), 5,
                           "flash_tf32_mla_kernel"
                           if dtype == torch.float32 else "flash_mla_kernel")
        pairs = b * h * s * (s + 1) // 2
        flops = 2 * (dh + dv) * pairs
        width = q.element_size()
        kb = (1e3 * width * (b * h * s * (dh + dv) + b * kv * s * (dh + dv))
              / mem_bps,
              1e3 * flops / bf16_flops if dtype == torch.bfloat16
              else 1e3 * 3 * flops / tf32_flops)
        line = (f"[MLA K9] {what}: B={b} H={h} KV={kv} S=T={s} dh={dh} "
                f"dv={dv} {str(dtype)[6:]}, causal: max abs err {e:.3g} "
                f"({_attn_limit(q)}; mean |o| {mean:.3g}); {ms[what]:.4f} "
                f"ms (device {_dev_str(dev_ms)})")
        # the persistent kernel's work list: bf16 128-row query tiles over
        # 64-row kv tiles, f32 64-row query tiles over 32-row kv tiles
        bm, bk = (k9.MLA_BM, 64) if dtype == torch.bfloat16 \
            else (k9.MLA_F32_BM, 32)
        ntiles = b * h * -(-s // bm)
        per = [sum(min(-(-s // bk), -(-(qt * bm + bm) // bk))
                   for _, qt in lst)
               for lst in k9.mla_tiles(b * h, s, min(ntiles, sms), bm)]
        line += (f"; {ntiles} query tiles of {bm} rows on {len(per)} "
                 f"persistent blocks, causal kv tiles a block "
                 f"{min(per)}-{max(per)} (mean {sum(per) / len(per):.1f})")
        if key:
            t_plain = cuda_ms(lambda: k9.flash_forward_plain(q, k, v, 64,
                                                             64), 1)
            t_lib = _sdpa_ms(q, k, v)
            row = _row(key, 1, errs, ms[what], t_plain, kb, library_ms=t_lib)
            rows.append(row)
            split = (2 * dh + 4 * dv) / (2 * (dh + dv))
            line += (f" (plain {t_plain:.2f} ms, SDPA {t_lib:.4f} ms, "
                     f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}"
                     + (f", {split * row['bound_ms']:.4f} ms with the split "
                        f"P's second PV product" if dtype == torch.bfloat16
                        else ": three TF32 products") + ")")
        print(line + f" [{name}]")
        del q, k, v
    for b, h, kv, s, t, dh, dv, causal, at in MLA_F32_EDGES:
        q, k, v = _attn_inputs(gen, dev, b, h, kv, s, t, dh, dv,
                               torch.float32)
        if at:
            q, k, v = (_at_offset(x) for x in (q, k, v))
        before = counts()
        o = k9.flash_forward(q, k, v, 32, 32, causal)
        torch.cuda.synchronize()
        launched(before, K9_f32=1)
        e = _attn_diff(errs, o, k9.flash_forward_plain(q, k, v, 32, 32,
                                                       causal),
                       f"MLA K9 f32 edge {(b, h, kv, s, t, dh, dv, causal)}",
                       "K9-f32-mla")
        print(f"[MLA K9] f32 edge: B={b} H={h} KV={kv} S={s} T={t} dh={dh} "
              f"dv={dv} causal={causal!s:5}"
              f"{' (one element into storage)' if at else ''}: max abs "
              f"err {e:.3g} ({_attn_limit(o)})")
    torch.cuda.empty_cache()
    return rows, ms


def moe_layer(dev, name: str, arch: str = "deepseek-v2-236b", b: int = 4,
              s: int = 4096) -> dict:
    """Phase 24 (e): one MoE block of ``arch`` at full width (random bf16
    weights) run twice on the same [b, s] input: the two outputs and aux
    losses bitwise equal (the combine adds in a fixed order, no
    atomics); a call at that token count and at a decode step's makes
    no host sync (static shapes: no ``bincount``, no boolean-mask
    indexing, no host-to-device copy).  Also its CUDA-event ms at that token count and at a decode
    step's b tokens, beside the bytes of its expert weights over the
    card's memory rate (a decode step reads every expert).  Then phase
    24 (f) on the same block (``mapped_block``)."""
    from repro_torch import configs
    from repro_torch.models import moe
    cfg = configs.get(arch)
    gen = torch.Generator(device=dev).manual_seed(24)
    mod = moe.MoE(cfg, generator=gen, device=dev)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev
                    ).bfloat16()
    with torch.inference_mode():
        out1, aux1 = moe.moe_apply(mod, x, cfg)
        out2, aux2 = moe.moe_apply(mod, x, cfg)
        torch.cuda.synchronize()
        assert torch.equal(out1, out2) and torch.equal(aux1, aux2), \
            "MoE layer not deterministic"
        assert torch.isfinite(out1.float()).all()
        _, _, top_e = moe.route(x.reshape(-1, cfg.d_model), mod.router.w,
                                cfg)
        _, keep = moe.dispatch(top_e, 0, cfg.num_experts,
                               moe._capacity(b * s, cfg))
        del out1, out2
        t_pre = cuda_ms(lambda: moe.moe_apply(mod, x, cfg), 3)
        xd = x[:, :1].contiguous()
        t_dec = cuda_ms(lambda: moe.moe_apply(mod, xd, cfg), 10)
        syncs = {what: host_syncs(lambda: moe.moe_apply(mod, xin, cfg))
                 for what, xin in (("prefill", x), ("decode", xd))}
    assert syncs == {"prefill": 0, "decode": 0}, \
        f"host syncs in a MoE layer call: {syncs}"
    routed = sum(p.numel() * p.element_size()
                 for p in mod.experts.parameters())
    floor = 1e3 * routed / card_peaks(name)[0]
    print(f"[MoE layer] {arch}: one MoE block ({cfg.num_experts} experts, "
          f"top {cfg.top_k}, {cfg.num_shared_experts} shared) on {b} x {s} "
          f"tokens twice: outputs and aux bitwise equal; dropped "
          f"{int((~keep).sum())} of {b * s * cfg.top_k} assignments; "
          f"{t_pre:.2f} ms a call (CUDA events); at a decode step's {b} "
          f"tokens {t_dec:.3f} ms, its {routed / 1e9:.2f} GB of routed "
          f"experts {floor:.3f} ms at the memory rate; host syncs a call "
          f"(CUDA sync debug mode): {syncs} [{name}]")
    del x
    mapped = mapped_block(dev, name, mod, cfg)
    del mod
    torch.cuda.empty_cache()
    return {"prefill_ms": t_pre, "decode_ms": t_dec, "floor_ms": floor,
            "mapped": mapped}


def moe_mesh():
    """MOE_MESH's (data, model) mesh, every shard on the one card."""
    from repro_torch.sharding import make_mesh
    return make_mesh(MOE_MESH, ("data", "model"),
                     devices=["cuda:0"] * math.prod(MOE_MESH))


class DispatchSpy:
    """While open, records every ``models.moe.dispatch`` call (one an
    expert shard and MoE call) as (top_e, e_offset, e_loc, keep), on
    the device: no host sync.  ``drops()`` counts the assignments to a
    call's own experts that it did not keep."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.calls = moe, moe.dispatch, []

        def spy(top_e, e_offset, e_loc, capacity):
            slot, keep = self.real(top_e, e_offset, e_loc, capacity)
            self.calls.append((top_e, e_offset, e_loc, keep))
            return slot, keep

        moe.dispatch = spy
        return self

    def __exit__(self, *exc) -> None:
        self.moe.dispatch = self.real

    def drops(self) -> int:
        total = 0
        for top_e, off, e_loc, keep in self.calls:
            mine = ((top_e >= off) & (top_e < off + e_loc)).reshape(-1)
            total += int((mine & ~keep).sum())
        return total


def _peak_extra(fn) -> float:
    """GB allocated above what is held before, at the peak of one call
    of ``fn``."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def mapped_block(dev, name: str, mod, cfg) -> dict:
    """Phase 24 (f): the full-width MoE block ``mod`` (deepseek-v2's,
    random weights) mapped over MOE_MESH of the one card by EP and by
    expert-TP, in bf16 on 4 x 1024 tokens and then, the block cast in
    place, in float32 on 4 x 512, at MOE_DROPLESS_CF, against the
    unmapped block on the same input: every expert shard's routing
    (``DispatchSpy``: dp x ep dispatches a call) the unmapped block's on
    its rows but at witnessed near-ties (MOE_ROUTE_TIE_BF16, ROUTE_TIE),
    no assignment dropped on either path, the outputs on the other
    tokens within MOE_MAPPED_REL, two mapped calls bitwise equal and no
    host sync in a mapped call (``host_syncs``).  Each call timed by
    CUDA events at that shape and at a decode step's 4 tokens, beside
    the unmapped block, with the memory it allocates above the weights
    at its peak.  Returns {(dtype, mode): numbers}."""
    from repro_torch.models import moe
    mesh = moe_mesh()
    dp, ep = MOE_MESH
    cfg = dataclasses.replace(cfg, capacity_factor=MOE_DROPLESS_CF)
    gen = torch.Generator(device=dev).manual_seed(241)
    out = {}
    for dtype, (b, s) in ((torch.bfloat16, (4, 1024)),
                          (torch.float32, (4, 512))):
        if dtype == torch.float32:
            mod.float()
        T = b * s
        x = torch.randn((b, s, cfg.d_model), generator=gen,
                        device=dev).to(dtype)
        xd = x[:, :1].contiguous()
        with torch.inference_mode():
            with DispatchSpy() as plain_spy:
                want, want_aux = moe.moe_apply(mod, x, cfg)
            top_e = plain_spy.calls[0][0]
            probs = torch.sort(moe.route(x.reshape(T, -1), mod.router.w,
                                         cfg)[0], dim=-1,
                               descending=True, stable=True).values
            t_plain = cuda_ms(lambda: moe.moe_apply(mod, x, cfg), 3)
            t_plain_dec = cuda_ms(lambda: moe.moe_apply(mod, xd, cfg), 10)
            mem_plain = _peak_extra(lambda: moe.moe_apply(mod, x, cfg))
            mem_plain_dec = _peak_extra(lambda: moe.moe_apply(mod, xd, cfg))
            for tp in (False, True):
                mode = "expert-TP" if tp else "EP"

                def call(xin=x, tp=tp):
                    return moe.moe_apply(mod, xin, cfg, mesh=mesh,
                                         expert_tp=tp)

                with DispatchSpy() as spy:
                    got, aux = call()
                got2, aux2 = call()
                torch.cuda.synchronize()
                assert torch.equal(got, got2) and torch.equal(aux, aux2), \
                    f"mapped MoE ({mode}) not deterministic"
                assert len(spy.calls) == dp * ep, len(spy.calls)
                drops = (spy.drops(), plain_spy.drops())
                assert drops == (0, 0), (mode, drops)
                ties = []
                for i, (te, _, _, _) in enumerate(spy.calls):
                    lo = 0 if tp else (i // ep) * T // dp
                    diff = (te != top_e[lo:lo + te.shape[0]]).any(1)
                    for t in (diff.nonzero()[:, 0] + lo).tolist():
                        row = te[t - lo]
                        j = int((row != top_e[t]).nonzero()[0, 0])
                        gap = float(probs[t, j] - probs[t, j + 1])
                        bound = ROUTE_TIE if dtype == torch.float32 \
                            else MOE_ROUTE_TIE_BF16 * float(probs[t, j])
                        assert gap <= bound, (mode, t, j, gap, bound)
                        ties.append((t, j, gap))
                rows = torch.ones(T, dtype=torch.bool, device=dev)
                for t, _, _ in ties:
                    rows[t] = False
                g2, w2 = got.reshape(T, -1)[rows], want.reshape(T, -1)[rows]
                e_abs = float((g2.double() - w2.double()).abs().max())
                e_rel = e_abs / float(w2.double().abs().max())
                assert e_rel <= MOE_MAPPED_REL[dtype], (mode, dtype, e_rel)
                syncs = {what: host_syncs(lambda xin=xin: call(xin))
                         for what, xin in (("check", x), ("decode", xd))}
                assert syncs == {"check": 0, "decode": 0}, (mode, syncs)
                t_map = cuda_ms(call, 3)
                t_map_dec = cuda_ms(lambda: call(xd), 10)
                mem = _peak_extra(call)
                mem_dec = _peak_extra(lambda: call(xd))
                rec = dict(e_rel=e_rel, e_abs=e_abs, ties=len(ties),
                           aux=float(aux), aux_plain=float(want_aux),
                           ms=t_map, plain_ms=t_plain, dec_ms=t_map_dec,
                           plain_dec_ms=t_plain_dec, mem_gb=mem,
                           plain_mem_gb=mem_plain, dec_mem_gb=mem_dec,
                           plain_dec_mem_gb=mem_plain_dec)
                out[(str(dtype)[6:], mode)] = rec
                print(f"[MoE mapped] deepseek-v2-236b block, {mode} on a "
                      f"{MOE_MESH} (data, model) mesh of cuda:0, "
                      f"{str(dtype)[6:]}, {b} x {s} tokens, capacity factor "
                      f"{MOE_DROPLESS_CF:g}: {dp * ep} expert shards a call, "
                      f"drops mapped / unmapped {drops[0]} / {drops[1]}; "
                      f"routing the unmapped block's but {len(ties)} "
                      f"witnessed near-ties"
                      + "".join(f" (token {t} rank {j} gap {gap:.3g})"
                                for t, j, gap in ties[:4])
                      + f"; out vs unmapped max abs {e_abs:.3g} = "
                      f"{e_rel:.3g} of max |out| (limit "
                      f"{MOE_MAPPED_REL[dtype]:g}); aux {float(aux):.7g} "
                      f"(unmapped {float(want_aux):.7g}: each shard's "
                      f"statistics over its own tokens); two calls bitwise "
                      f"equal; host syncs a call {syncs}; {t_map:.3f} ms a "
                      f"call (unmapped {t_plain:.3f}), at a decode step's "
                      f"{b} tokens {t_map_dec:.3f} ms (unmapped "
                      f"{t_plain_dec:.3f}) (CUDA events); memory above the "
                      f"weights at the peak {mem:.3f} GB (unmapped "
                      f"{mem_plain:.3f}), at the decode shape "
                      f"{mem_dec:.4f} GB (unmapped {mem_plain_dec:.4f}) "
                      f"[{name}]")
                del got, got2
        del x, xd, want
    return out


def mapped_serving(dev, name: str, model, cfg, toks, rec: dict) -> dict:
    """Phase 24 (g), on phase 24 (b)'s model (deepseek-v2 cut to 5
    layers, 4 MoE): a prefill of the 4 x 4096 prompts through
    ``make_prefill_step(cfg, mesh=)`` in EP on MOE_MESH (median of 3, each
    on a fresh cache; K9 5 launches a prefill, every count set to 0 just
    before and read just after) and 32 decode steps through
    ``make_decode_step`` under ``moe_expert_tp=True`` (decode_32k's
    setting; median of 32; no launch), at the config's capacity, with
    the peak memory, beside (b)'s unmapped numbers.  Then the mapped and
    the unmapped path at MOE_DROPLESS_CF on the prompts cut to
    MOE_MAPPED_S: the prefill and two decode steps fed the unmapped
    path's greedy tokens, no drop on either path (``DispatchSpy``: one
    dispatch a MoE layer and call unmapped, dp x ep mapped), logits
    within MODEL_BF16_REL of the unmapped path's."""
    from repro_torch import models
    from repro_torch.serve import make_decode_step, make_prefill_step
    mesh = moe_mesh()
    dp, ep = MOE_MESH
    b, s = toks.shape
    new = 32
    n_moe = sum(hasattr(layer, "moe") for layer in model.layers)
    tp = dataclasses.replace(cfg, moe_expert_tp=True)
    pre_step = make_prefill_step(cfg, mesh=mesh)
    dec_step = make_decode_step(tp, mesh=mesh)
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pre_times = []
        for _ in range(3):
            cache = models.make_cache(cfg, b, s + new, concrete=True,
                                      device=dev)
            reset_counts()
            t0 = time.perf_counter()
            last, cache = pre_step(model, toks, cache)
            torch.cuda.synchronize()
            pre_times.append(1e3 * (time.perf_counter() - t0))
            assert _only(counts(), K9=5), counts()
        tok, dec_times = last.argmax(-1), []
        reset_counts()
        for i in range(new):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = dec_step(model, tok, cache, s + i)
            tok = logits.argmax(-1)
            torch.cuda.synchronize()
            dec_times.append(1e3 * (time.perf_counter() - t0))
        assert _only(counts()), counts()
        assert torch.isfinite(logits.float()).all()
        peak = torch.cuda.max_memory_allocated() / 1e9
        del cache, logits, last

        # the mapped path against the unmapped at a dropless capacity
        sd = MOE_MAPPED_S
        cfg_d = dataclasses.replace(cfg, capacity_factor=MOE_DROPLESS_CF)
        tp_d = dataclasses.replace(cfg_d, moe_expert_tp=True)
        part = toks[:, :sd].contiguous()
        runs, fed = {}, []
        for mapped in (False, True):
            if mapped:
                prefill = make_prefill_step(cfg_d, mesh=mesh)
                step = make_decode_step(tp_d, mesh=mesh)
            else:
                prefill = lambda m, t, c: models.prefill(m, t, c, cfg_d)
                step = lambda m, t, c, pos: models.decode_step(m, t, c, pos,
                                                              cfg_d)
            with DispatchSpy() as spy:
                cache = models.make_cache(cfg, b, sd + 2, concrete=True,
                                          device=dev)
                reset_counts()
                last, cache = prefill(model, part, cache)
                torch.cuda.synchronize()
                assert _only(counts(), K9=5), counts()
                logits = [last]
                for i in range(2):
                    if not mapped:
                        fed.append(logits[-1].argmax(-1))
                    lg, cache = step(model, fed[i], cache, sd + i)
                    logits.append(lg)
                torch.cuda.synchronize()
            runs[mapped] = (logits, spy.drops(), len(spy.calls))
            del cache
    calls = {m: r[2] for m, r in runs.items()}
    assert calls == {False: 3 * n_moe, True: 3 * n_moe * dp * ep}, calls
    drops = {m: r[1] for m, r in runs.items()}
    assert drops == {False: 0, True: 0}, drops
    errs = [_rel(g, w) for g, w in zip(runs[True][0], runs[False][0])]
    e_abs = max(float((g.double() - w.double()).abs().max())
                for g, w in zip(runs[True][0], runs[False][0]))
    assert all(e <= MODEL_BF16_REL for e in errs), errs
    t_pre, t_dec = float(np.median(pre_times)), float(np.median(dec_times))
    out = dict(mapped_prefill_ms=t_pre, mapped_prefill_tok_s=b * s
               / (t_pre / 1e3), mapped_decode_ms=t_dec,
               mapped_peak_gb=peak, mapped_errs=errs, mapped_abs=e_abs)
    print(f"[serve mapped] deepseek-v2-236b, {cfg.num_layers} layers "
          f"({n_moe} MoE), on a {MOE_MESH} (data, model) mesh of cuda:0: "
          f"make_prefill_step(mesh=) in EP on {b} x {s} tokens "
          f"{t_pre:.1f} ms (median of 3; {out['mapped_prefill_tok_s']:.0f} "
          f"tokens/s; unmapped {rec['prefill_ms']:.1f}, "
          f"{rec['prefill_tok_s']:.0f} tokens/s), K9 5 launches a prefill; "
          f"{new} decode steps by make_decode_step(mesh=) under expert-TP "
          f"{t_dec:.2f} ms a step (median of {new}; unmapped "
          f"{rec['decode_ms']:.2f}, median of 16), no launch; peak memory "
          f"{peak:.2f} GB (unmapped generate {rec['peak_gb']:.2f}); at "
          f"capacity factor {MOE_DROPLESS_CF:g} on {b} x {sd} tokens, "
          f"drops mapped / unmapped {drops[True]} / {drops[False]} "
          f"({calls[True]} / {calls[False]} expert-shard dispatches in a "
          f"prefill and 2 decode steps), mapped vs unmapped logits "
          f"(prefill, step 1, step 2) "
          + ", ".join(f"{e:.3g}" for e in errs)
          + f" relative max (limit {MODEL_BF16_REL:g}), largest absolute "
          f"difference {e_abs:.3g} [{name}]")
    return out


def host_syncs(fn) -> int:
    """The synchronizing CUDA operations one call of ``fn`` makes, as
    ``torch.cuda``'s sync debug mode reports them."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def _host_free_gb() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 1e6
    return float("nan")


def moe_phase(dev, errs: ErrLog, name: str):
    """Phase 24: MoE/MLA serving on the card (see the module docstring).
    Returns (the K9-mla and K9-f32-mla table rows, the MLA path's
    launches by table key and run)."""
    t0 = time.perf_counter()
    rows, k9_ms = check_mla_kernels(dev, errs, name)
    ds = serve_full(dev, name, "deepseek-v2-236b", 4, 4096, 32, {"K9": 5},
                    {"K9": 5 * k9_ms["deepseek"]}, num_layers=5,
                    after=lambda *a: mapped_serving(dev, name, *a))
    serve_full(dev, name, "kimi-k2-1t-a32b", 2, 4096, 16, {"K9": 2},
               {"K9": 2 * k9_ms["kimi"]}, num_layers=2)
    free = _host_free_gb()
    print(f"[serve f32] host memory available: {free:.1f} GB (deepseek-v2 "
          f"cut to 2 layers holds 21.4 GB of float32 weights)")
    assert free > 32, "the host lacks memory for the float32 CPU run"
    f32 = f32_card_vs_cpu(dev, name, "deepseek-v2-236b", 2, {"K9-f32": 2})
    moe_layer(dev, name)
    rows[0]["launches"] = ds["launches"]["K9"]
    rows[1]["launches"] = f32["launches"]["K9-f32"]
    print(f"[models] phase 24 in {time.perf_counter() - t0:.1f} s; "
          f"deepseek peak {ds['peak_gb']:.2f} GB [{name}]")
    paths = {"deepseek-v2-236b prefill (5 of 60 layers)": 5,
             "deepseek-v2-236b mapped prefill (5 of 60 layers, EP on a "
             "(2, 4) mesh)": 5,
             "kimi-k2-1t-a32b prefill (2 of 61 layers)": 2}
    f32_paths = {"deepseek-v2-236b f32 prefill (2 layers)": 2}
    return rows, {"K9": paths, "K9-mla": paths, "K9-f32": f32_paths,
                  "K9-f32-mla": f32_paths}


# ---------------------------------------------------------------------------
# phase 25: xLSTM serving on the card
# ---------------------------------------------------------------------------

#: The sLSTM scan against its plain version: both round every operation
#: alike (-fmad=false; the same exp, tanh and IEEE divisions, in the same
#: order), so they are expected bitwise.  A difference is witnessed and
#: held within SLSTM_TOL: hs (a bf16 hs within one bf16 step besides) and
#: h absolute (|h| <= 1), c, n and m relative besides (they grow with S: m
#: sums raw forget pre-activations).  Stated before phase 25's first run.
SLSTM_TOL = 1e-5
#: xlstm-1p3b's prefill scans (configs/xlstm_1p3b.py: d_model 2048,
#: ssm_expand 2, 4 heads of dh 1024, gla_chunk 256) at 4 prompts of 4096:
#: (B, H, S, dh, chunk); and its sLSTM scan: (B, S, D).
XLSTM_SCAN = (4, 4, 4096, 1024, 256)
SLSTM_SCAN = (4, 4096, 2048)
#: The sLSTM scan's edges, each from a nonzero state in bf16 and f32: (B,
#: S, D, c kept at 0 on half the channels).  S 1 (a decode step), 7 and
#: 129 (one stage, a stage and a ragged one), B D not a multiple of the
#: kernel's 64-channel block, blocks that straddle two sequences or whose
#: rows are not whole 16-byte copies (D 100, 70), and channels whose c
#: stays 0, so a quotient falls outside the fast division's window.
SLSTM_EDGES = ((4, 1, 2048, False), (4, 7, 2048, False),
               (3, 7, 100, False), (2, 129, 70, False),
               (3, 129, 128, False), (2, 300, 128, True))
#: One S = 1 launch at the decode shape (B 4, D 2048) on the device before
#: the redesign of the sLSTM scan, bf16 and f32 gates (ms; PERF.md's
#: kernel table, NVIDIA H100 80GB HBM3, 700 W).
PARENT_SLSTM_DECODE_MS = {"bfloat16": 0.0016, "float32": 0.0015}
#: Phase 25's launches: an xlstm-1p3b prefill (42 mLSTM layers, each one
#: scan of dh + 1 = 1025 value columns, the numerator's and the
#: normalizer's, on the wide route's two kernels; 6 sLSTM layers) and the
#: float32 run at one period (7 + 1 layers; a prefill and 3 decode steps:
#: each mLSTM scan on 128-wide blocks, 9 launches).
XLSTM_PREFILL = {"K10-mlstm": 84, "sLSTM": 6}
XLSTM_F32 = {"K10": 63, "sLSTM": 4}
#: The blocked route's time for a layer's two scans at XLSTM_SCAN before
#: the wide route took them (PERF.md's kernel table: 15.0693 ms the
#: numerator, 1.6652 ms the normalizer).
PARENT_MLSTM_MS = 15.0693 + 1.6652


def check_mlstm_kernels(dev, errs: ErrLog, name: str):
    """Phase 25 (a): K10 on mLSTM's heads at xlstm-1p3b's prefill shape
    (XLSTM_SCAN, bf16) as a mLSTM layer runs it: one scan of v = [v_num |
    v_den] (dv = 1025) through ``kernels.gla.gla_scan``, which takes the
    wide route (``kernel.gla_wide``: the scores, then the scan; two
    launches counted under K10-mlstm), held to the undivided plain
    version (GLA_RTOL / GLA_ATOL, a bf16 o within one bf16 step besides).
    Beside it the blocked route it replaces (``gla_blocked``, which
    float32 still takes): the numerator (8 launches) and the normalizer
    (1) held to the plain version, state block (7, 3) bitwise one K10
    launch on its own blocks, and the same inputs in float32.  Timed by
    CUDA events: the wide route, the blocked route's two scans, the plain
    version; the wide kernels' device times from the profiler; the bound
    of the un-blocked scan (``gla_bound``) and the floor of the
    look-back's state traffic (each S_c written and read once at the
    memory rate).  Also the zero-state term that ``models.ssm.
    gla_chunked`` adds to a prefill from an empty cache (a layer's scan
    with and without a zero initial state) and the names of its float32
    GEMM's kernels.  Returns (the K10-mlstm row, {the prefill's K10 ms,
    zero-state ms, names})."""
    from repro_torch.kernels.gla import gla_scan, kernel, ops
    from repro_torch.models.ssm import gla_chunked
    b, h, s, dh, chunk = XLSTM_SCAN
    gen = torch.Generator(device=dev).manual_seed(25)
    rn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    # the mLSTM's scales: q, k times dh^-0.5, v times the input gate,
    # log a = log sigmoid(f~)
    q = (rn(b, h, s, dh) * dh ** -0.5).bfloat16()
    k = (rn(b, h, s, dh) * dh ** -0.5).bfloat16()
    i_g = torch.sigmoid(rn(b, h, s))
    v = (rn(b, h, s, dh) * i_g[..., None]).bfloat16()
    vd = i_g[..., None].bfloat16()
    vm = torch.cat([v, vd], dim=-1)
    la = torch.nn.functional.logsigmoid(rn(b, h, s))
    g = kernel.chunk_cumsum(la, chunk)
    # the wide route, as the layer calls it
    before = counts()
    o, st = gla_scan(q, k, vm, la, chunk=chunk, device=dev)
    torch.cuda.synchronize()
    launched(before, K10_mlstm=2)
    assert o.dtype == torch.bfloat16 and torch.isfinite(o.float()).all()
    assert o.shape == (b, h, s, dh + 1) and st.shape == (b, h, dh, dh + 1)
    want = kernel.gla_chunks_plain(q, k, vm, g, chunk)
    ndw = _gla_diff(errs, (o, st), want, True, "K10-mlstm")
    del o, st, want
    # the blocked route
    nblk = dh // kernel.MAX_HEAD_DIM
    before = counts()
    o, st = ops.gla_blocked(q, k, v, g, chunk)
    torch.cuda.synchronize()
    launched(before, K10=nblk)
    nd = _gla_diff(errs, (o, st), kernel.gla_chunks_plain(q, k, v, g, chunk),
                   True, "K10")
    n = kernel.MAX_HEAD_DIM
    bi, bj = nblk - 1, nblk // 2 - 1
    blk = lambda x, i: x[..., n * i:n * i + n].contiguous()
    _, st_ij = kernel.gla_chunks(blk(q, bi), blk(k, bi), blk(v, bj), g,
                                 chunk, out_dtype=torch.float32)
    assert torch.equal(st_ij, st[:, :, n * bi:n * bi + n,
                                 n * bj:n * bj + n]), "state copy-out"
    del o, st, st_ij
    before = counts()
    od, sd = ops.gla_blocked(q, k, vd, g, chunk)
    torch.cuda.synchronize()
    launched(before, K10=1)
    ndd = _gla_diff(errs, (od, sd),
                    kernel.gla_chunks_plain(q, k, vd, g, chunk), True, "K10")
    del od, sd
    q32, k32, v32 = q.float(), k.float(), v.float()
    nd32 = _gla_diff(errs, ops.gla_blocked(q32, k32, v32, g, chunk),
                     kernel.gla_chunks_plain(q32, k32, v32, g, chunk), False,
                     "K10")
    del q32, k32, v32
    torch.cuda.empty_cache()
    t_wide = cuda_ms(lambda: kernel.gla_wide(q, k, vm, g, chunk), 5)
    t_blk = cuda_ms(lambda: (ops.gla_blocked(q, k, v, g, chunk),
                             ops.gla_blocked(q, k, vd, g, chunk)), 3)
    t_sc = device_ms(lambda: kernel.gla_wide(q, k, vm, g, chunk), 3,
                     "gla_wide_scores_kernel")
    t_scan = device_ms(lambda: kernel.gla_wide(q, k, vm, g, chunk), 3,
                       "gla_wide_kernel")
    t_plain = cuda_ms(lambda: kernel.gla_chunks_plain(q, k, vm, g, chunk), 1)
    kb = gla_bound(name, b, h, s, dh, dh + 1, chunk)
    nc = s // chunk
    floor = 1e3 * 2 * 4 * b * h * (nc - 1) * dh * (dh + 1) \
        / card_peaks(name)[0]
    s0 = torch.zeros((b, h, dh, dh + 1), device=dev)

    def layer(zero_state: bool):
        """A mLSTM layer's scan, as its prefill runs it."""
        gla_chunked(q, k, vm, la, chunk,
                    **({"initial_state": s0} if zero_state else {}))

    t_with, t_without = cuda_ms(lambda: layer(True), 3), \
        cuda_ms(lambda: layer(False), 3)
    q32 = q.float()
    zs_names = gemm_names(lambda: torch.matmul(q32, s0))
    t_zs = cuda_ms(lambda: torch.matmul(q32, s0), 3)
    del q32
    flops_zs = 2 * b * h * s * dh * (dh + 1)
    print(f"[mLSTM K10] xlstm-1p3b's prefill scan, B={b} H={h} S={s} dh="
          f"{dh} chunk={chunk} bf16, numerator and normalizer as one scan "
          f"(dv {dh + 1}) on the wide route (2 launches): within rtol "
          f"{GLA_RTOL:g} / atol {GLA_ATOL:g} of the undivided plain version "
          f"and one bf16 step ({ndw} of {b * h * s * (dh + 1)} output "
          f"elements differ); {t_wide:.4f} ms (device: scores "
          f"{_dev_str(t_sc)}, scan {_dev_str(t_scan)}; plain {t_plain:.2f} "
          f"ms; bound {max(kb):.4f} ms by "
          f"{'bytes' if kb[0] >= kb[1] else 'operations'}; the look-back's "
          f"state traffic {floor:.4f} ms at the memory rate). The blocked "
          f"route it replaces: numerator ({nblk} launches) and normalizer "
          f"(1) {t_blk:.4f} ms (before the wide route: {PARENT_MLSTM_MS:.4f} "
          f"ms, PERF.md), "
          f"within the tolerance ({nd} and {ndd} elements differ; f32 "
          f"{nd32}); state block ({bi}, {bj}) bitwise a launch on its own "
          f"blocks [{name}]")
    print(f"[mLSTM K10] the zero-state term of a prefill from an empty "
          f"cache: a layer's scan {t_with:.4f} ms with a zero initial "
          f"state, {t_without:.4f} ms without; its float32 product "
          f"[{b}, {h}, {s}, {dh}] x [{dh}, {dh + 1}] ({flops_zs / 1e9:.1f} "
          f"GFLOP) {t_zs:.4f} ms ({flops_zs / t_zs / 1e9:.1f} TFLOP/s), "
          f"kernels {sorted(zs_names)} [{name}]")
    row = _row("K10-mlstm", 0, errs, t_wide, t_plain, kb)
    del q, k, v, vd, vm, la, g, s0
    torch.cuda.empty_cache()
    return row, {"K10": t_wide, "zero": t_with - t_without,
                 "zero_names": frozenset(zs_names)}


def _slstm_diff(got, want, bf16: bool, what: str) -> int:
    """Hold the sLSTM kernel's (hs, (h, c, n, m)) to the plain version's
    within SLSTM_TOL (module note); print a witness of the first
    difference.  Returns the count of elements that differ."""
    (hs, st), (hp, sp) = got, want
    n_diff = int((hs != hp).sum()) + sum(int((a != b).sum())
                                         for a, b in zip(st, sp))
    assert _close(hs, hp, BF16_ULP if bf16 else 0.0, SLSTM_TOL), what
    for key, a, b_ in zip("hcnm", st, sp):
        assert _close(a, b_, 0.0 if key == "h" else SLSTM_TOL, SLSTM_TOL), \
            (what, key)
    if n_diff:
        idx = (hs != hp).nonzero()
        at = tuple(idx[0].tolist()) if len(idx) else None
        print(f"[sLSTM] {what}: {n_diff} elements differ; the first in hs "
              f"at (b, t, d) = {at}"
              + (f": {float(hs[at]):.9g} against {float(hp[at]):.9g}"
                 if at else ""))
    return n_diff


def check_slstm(dev, errs: ErrLog, name: str):
    """Phase 25 (b): the sLSTM scan at xlstm-1p3b's prefill (B 4, S 4096,
    D 2048), zifo in bf16 and in f32, r as ``slstm_init`` draws it (0.02
    N(0, 1), bf16 values), from the zero state: one launch each, held to
    the plain version (``_slstm_diff``), timed by CUDA events beside the
    plain version and its bound (bytes: zifo read, hs written, r and the
    states once; operations: ``kernel.OPS_PER_STEP`` a channel a step at
    the non-FMA f32 rate), a launch's device time from the profiler.
    Returns (the sLSTM row, the bf16 launch's ms)."""
    from repro_torch.kernels.slstm import kernel
    b, s, d = SLSTM_SCAN
    gen = torch.Generator(device=dev).manual_seed(25)
    zifo = torch.randn((b, s, 4 * d), generator=gen, device=dev).bfloat16()
    r = (0.02 * torch.randn((4, d), generator=gen, device=dev)
         ).bfloat16().float()
    zeros = [torch.zeros((b, d), device=dev) for _ in range(4)]
    nd = {}
    for z in (zifo, zifo.float()):
        bf = z.dtype == torch.bfloat16
        before = counts()
        got = kernel.slstm_scan(z, r, *zeros)
        torch.cuda.synchronize()
        launched(before, sLSTM=1)
        assert got[0].dtype == z.dtype and torch.isfinite(got[0].float()).all()
        want = kernel.slstm_scan_plain(z, r, *zeros)
        errs.diff("sLSTM", got[0], want[0])
        for a, b_ in zip(got[1], want[1]):
            errs.diff("sLSTM", a, b_)
        nd[str(z.dtype)[6:]] = _slstm_diff(got, want, bf,
                                           f"{str(z.dtype)[6:]} zifo")
        del got, want
    t_ms = cuda_ms(lambda: kernel.slstm_scan(zifo, r, *zeros), 5)
    t_dev = device_ms(lambda: kernel.slstm_scan(zifo, r, *zeros), 3,
                      "slstm_scan_kernel")
    t_plain = cuda_ms(lambda: kernel.slstm_scan_plain(zifo, r, *zeros), 1)
    nbytes = 2 * b * s * 5 * d + 4 * 4 * d + 8 * 4 * b * d
    kb = (1e3 * nbytes / card_peaks(name)[0],
          1e3 * kernel.OPS_PER_STEP * b * s * d / dtw_op_rate(name))
    print(f"[sLSTM] xlstm-1p3b's sLSTM scan, B={b} S={s} D={d}, from the "
          f"zero state: one launch each; against the plain version "
          f"elements that differ: {nd} (hs and the final h, c, n, m); "
          f"{t_ms:.4f} ms bf16 (device {_dev_str(t_dev)}; plain "
          f"{t_plain:.1f} ms, {s} steps of ~25 PyTorch kernels; bound "
          f"{max(kb):.4f} ms by {'bytes' if kb[0] >= kb[1] else 'operations'}"
          f"; {b * d} channels, one thread each, on "
          f"{-(-b * d // 64)} blocks of 64) [{name}]")
    row = _row("sLSTM", 0, errs, t_ms, t_plain, kb)
    del zifo, zeros
    for bb, ss, dd, zero_c in SLSTM_EDGES:
        zf = torch.randn((bb, ss, 4 * dd), generator=gen, device=dev)
        zf[..., 2 * dd:3 * dd] += 0.5
        rr = 0.5 * torch.randn((4, dd), generator=gen, device=dev)
        st = [torch.randn((bb, dd), generator=gen, device=dev)
              for _ in range(4)]
        st[2] = st[2].abs() + 0.5
        if zero_c:
            zf[..., :dd // 2] = 0
            rr[0, :dd // 2] = 0
            st[1][:, :dd // 2] = 0
        for z in (zf.bfloat16(), zf):
            bf = z.dtype == torch.bfloat16
            what = (f"B={bb} S={ss} D={dd}{' c kept 0' if zero_c else ''} "
                    f"{str(z.dtype)[6:]}")
            before = counts()
            got = kernel.slstm_scan(z, rr, *st)
            torch.cuda.synchronize()
            launched(before, sLSTM=1)
            want = kernel.slstm_scan_plain(z, rr, *st)
            errs.diff("sLSTM", got[0], want[0])
            n_diff = _slstm_diff(got, want, bf, what)
            line = (f"[sLSTM] {what}, from a nonzero state: one launch; "
                    f"elements that differ from the plain version {n_diff}")
            if ss == 1 and dd == 2048:
                key = str(z.dtype)[6:]
                t1 = cuda_ms(lambda: kernel.slstm_scan(z, rr, *st), 200)
                d1 = device_ms(lambda: kernel.slstm_scan(z, rr, *st), 50,
                               "slstm_scan_kernel")
                line += (f"; a decode step's launch {t1:.4f} ms back to back "
                         f"(the host's launch path), device {_dev_str(d1)} "
                         f"(before the redesign "
                         f"{PARENT_SLSTM_DECODE_MS[key]:.4f} ms)")
            print(line + f" [{name}]")
    return row, t_ms


def xlstm_phase(dev, errs: ErrLog, name: str):
    """Phase 25: xLSTM serving on the card (see the module docstring).
    Returns (the K10-mlstm and sLSTM table rows, the xLSTM path's
    launches by table key and run)."""
    from repro_torch import configs
    from repro_torch.models.model import block_kinds
    t0 = time.perf_counter()
    row_k10, ms = check_mlstm_kernels(dev, errs, name)
    row_slstm, slstm_ms = check_slstm(dev, errs, name)
    kinds = block_kinds(configs.get("xlstm-1p3b"))
    n_mlstm, n_slstm = kinds.count("mlstm"), kinds.count("slstm")
    rec = serve_full(
        dev, name, "xlstm-1p3b", 4, 4096, 32, XLSTM_PREFILL,
        {"K10-mlstm": n_mlstm * ms["K10"], "sLSTM": n_slstm * slstm_ms,
         "zero-state term": n_mlstm * ms["zero"]},
        named=ms["zero_names"], named_what="zero-state product")
    f32 = f32_card_vs_cpu(dev, name, "xlstm-1p3b",
                          len(configs.get("xlstm-1p3b").block_pattern),
                          XLSTM_F32)
    row_k10["launches"] = rec["launches"]["K10-mlstm"]
    row_slstm["launches"] = rec["launches"]["sLSTM"]
    print(f"[models] phase 25 in {time.perf_counter() - t0:.1f} s; xlstm "
          f"peak {rec['peak_gb']:.2f} GB [{name}]")
    return [row_k10, row_slstm], {
        "K10-mlstm": {"xlstm-1p3b prefill (48 layers, dh 1024 whole)":
                      XLSTM_PREFILL["K10-mlstm"]},
        "K10": {"xlstm-1p3b f32 prefill (8 layers, dh 1024 in 128-wide "
                "blocks)": f32["launches"]["K10"]},
        "sLSTM": {"xlstm-1p3b prefill (48 layers)": n_slstm,
                  "xlstm-1p3b decode step": n_slstm,
                  "xlstm-1p3b f32 prefill and 3 decode steps (8 layers)":
                      f32["launches"]["sLSTM"]}}


# ---------------------------------------------------------------------------
# phase 26: workload signatures
# ---------------------------------------------------------------------------

#: bench_autotune's experiment (benchmarks/bench_autotune.py:20-46): the
#: profiled archs, the query, the profiling shape, the series' samples,
#: the DTW band and the match threshold.
SIG_PROFILE = ("deepseek-v2-236b", "phi3-mini-3p8b", "starcoder2-15b",
               "granite-20b", "minitron-4b", "zamba2-7b")
SIG_QUERY = "kimi-k2-1t-a32b"
SIG_B, SIG_S, SIG_SAMPLES, SIG_BAND, SIG_THRESHOLD = 4, 512, 2048, 32, 0.85
#: The card's match scores against the CPU tuner's on the same series:
#: the same float32 DTW and float64 correlation (the port's CPU test
#: holds the CPU tuner to the reference's within the same).  Stated
#: before phase 26's first run.
SIG_TOL = 1e-5


@contextlib.contextmanager
def counting_plain(blocked: bool = True):
    """Within the block, every call of the model path's plain versions
    (K9's and its backward's, K10's, its backward's and, with
    ``blocked``, its blocked route, the sLSTM scan's and its backward's)
    is counted in the dict yielded, under "calls".  The blocked route
    runs K10's kernel on 128-wide blocks: a float32 mLSTM takes it on the
    card, the serving path's bfloat16 one never does."""
    from repro_torch.kernels.attention import kernel as k9
    from repro_torch.kernels.gla import kernel as k10
    from repro_torch.kernels.gla import ops as gla_ops
    from repro_torch.kernels.slstm import kernel as k_slstm
    seen = {"calls": 0}
    saved = [(mod, fn, getattr(mod, fn)) for mod, fn in (
        (k9, "flash_forward_plain"), (k9, "flash_backward_plain"),
        (k10, "gla_chunks_plain"), (k10, "gla_chunks_backward_plain"),
        (k_slstm, "slstm_scan_plain"),
        (k_slstm, "slstm_scan_backward_plain"))
        + ((gla_ops, "gla_blocked"),) * blocked]

    def counted(orig):
        def call(*args, **kwargs):
            seen["calls"] += 1
            return orig(*args, **kwargs)
        return call

    for mod, fn, orig in saved:
        setattr(mod, fn, counted(orig))
    try:
        yield seen
    finally:
        for mod, fn, orig in saved:
            setattr(mod, fn, orig)


def walk_arch(arch: str):
    """``arch`` built on ``meta`` at its published config, its loss at
    SIG_B x SIG_S tokens walked: (the walker, seconds, model build
    included)."""
    from repro_torch import configs
    from repro_torch.core.signatures import OpWalker
    from repro_torch.models import model as tmodel
    cfg = configs.get(arch)
    t0 = time.perf_counter()
    model = tmodel.DecoderLM(cfg, generator=torch.Generator().manual_seed(0),
                             device="meta").eval()
    shape = (SIG_B, SIG_S) if cfg.num_codebooks == 1 \
        else (SIG_B, SIG_S, cfg.num_codebooks)
    batch = {key: torch.zeros(shape, dtype=torch.int32, device="meta")
             for key in ("tokens", "labels")}
    walker = OpWalker()
    with torch.no_grad(), walker:
        loss, _ = tmodel.loss_fn(model, batch, cfg)
    assert (loss.shape, loss.device.type) == ((), "meta"), arch
    kinds = tmodel.block_kinds(cfg)
    want = {"K9": sum(k in tmodel.ATTN_KINDS + ("shared_attn",)
                      for k in kinds),
            "K10": sum(k in ("mamba2", "mlstm") for k in kinds),
            "sLSTM": kinds.count("slstm")}
    assert walker.kernels == {k: n for k, n in want.items() if n}, \
        (arch, walker.kernels, want)
    return walker, time.perf_counter() - t0


def _sig_tuner(series: dict, device: str):
    from repro_torch.core import AutoTuner, ReferenceDB
    db = ReferenceDB()
    tuner = AutoTuner(db, band=SIG_BAND, threshold=SIG_THRESHOLD,
                      device=device)
    for arch in SIG_PROFILE:
        tuner.profile(arch, {"B": SIG_B, "S": SIG_S}, series[arch])
        db.set_best_config(arch, {"arch": arch}, 1.0)
    return tuner


def _k2_args(dev, queries, xlens, bank):
    from repro_torch.core import dtw
    xs = np.zeros((len(queries), max(1, int(max(xlens)))), np.float32)
    for i, (q, n) in enumerate(zip(queries, xlens)):
        xs[i, :n] = q[:n]
    folds = [dtw.query_moments(xs[i, :n]) for i, n in enumerate(xlens)]
    return (torch.tensor(xs, device=dev),
            torch.tensor(np.asarray(xlens, np.int32), device=dev),
            torch.tensor(bank.series.T.copy(), device=dev),
            torch.tensor(bank.lengths, device=dev),
            torch.tensor([f[0] for f in folds], device=dev),
            torch.tensor([f[1] for f in folds], device=dev))


def check_k2_long(dev, errs: ErrLog, name: str) -> None:
    """K2 against its plain version at the signatures' length: references
    of 2049, 2048, 2047, 1000, 5 and 1 samples, queries of 2048, 2047, 1
    and 0, band SIG_BAND and None, dyadic data bitwise and smooth data
    within SMOOTH_TOL; one launch each."""
    from repro_torch.core.database import pack_series
    from repro_torch.kernels.dtw import score
    for i, (dyadic, band) in enumerate([(d, b) for d in (True, False)
                                        for b in (SIG_BAND, None)]):
        rng = np.random.default_rng(260 + i)
        bank = pack_series([_series(rng, n, dyadic)
                            for n in (2049, 2048, 2047, 1000, 5, 1)])
        xlens = [2048, 2047, 1, 0]
        queries = [_series(rng, 2048, dyadic) for _ in xlens]
        args = _k2_args(dev, queries, xlens, bank)
        before = counts()
        sk, dk = score.score_bank_offline(*args, band=band)
        torch.cuda.synchronize()
        launched(before, K2=1)
        sp, dp = score.score_bank_offline_plain(*args, band=band)
        e = max(errs.diff("K2", sk, sp), errs.diff("K2", dk, dp))
        tol = DYADIC_TOL if dyadic else SMOOTH_TOL
        assert e <= tol, (f"K2 at 2048 (dyadic={dyadic}, band={band}): max "
                          f"abs err {e}")
        print(f"[signatures K2] dyadic={dyadic!s:5} band={band!s:4} "
              f"N<=2048 M<=2049: scores and distances agree (max abs err "
              f"{e:.3g}, tol {tol:g}) [{name}]")


def signature_phase(dev, errs: ErrLog, name: str) -> dict:
    """Phase 26: workload signatures (see the module docstring).  Returns
    the matches' K2 launches by path."""
    from repro_torch import configs
    from repro_torch.core import signatures as sig
    from repro_torch.kernels.dtw import score
    t0 = time.perf_counter()
    costs = {}
    reset_counts()
    with counting_plain() as plain:
        for arch in configs.ARCHS:
            walker, secs = walk_arch(arch)
            costs[arch] = walker.costs
            print(f"[signatures] {arch}: {len(walker.costs)} ops (kernel "
                  f"calls {walker.kernels}), walked in {secs:.2f} s; "
                  f"{sum(c.flops for c in walker.costs):.6g} flops, "
                  f"{sum(c.bytes for c in walker.costs):.6g} bytes")
    got = counts()
    assert _only(got), f"launches during the walks: {got}"
    assert plain["calls"] == 0, f"{plain['calls']} plain-version calls"
    print(f"[signatures] ten archs walked on meta at {SIG_B} x {SIG_S} "
          f"tokens: no kernel launched, no plain version called")
    paths, tuners = {}, {}
    for chip in (sig.TPU_V5E, sig.H100):
        series = {a: sig.utilization_series(costs[a], SIG_SAMPLES, chip)
                  for a in SIG_PROFILE + (SIG_QUERY,)}
        tuner = _sig_tuner(series, "cuda")
        reset_counts()
        d = tuner.match(SIG_QUERY, series[SIG_QUERY])
        torch.cuda.synchronize()
        got = counts()
        assert _only(got, K2=1), f"launches in a match: {got}"
        paths[f"kimi-k2 match, {chip.name} spec (phase 26)"] = got["K2"]
        want = _sig_tuner(series, "cpu").match(SIG_QUERY, series[SIG_QUERY])
        assert (d.matched, d.config) == (want.matched, want.config), \
            (chip.name, d, want)
        assert d.scores.keys() == want.scores.keys()
        e = max(abs(d.scores[a] - want.scores[a]) for a in want.scores)
        assert e <= SIG_TOL and abs(d.corr - want.corr) <= SIG_TOL, \
            (chip.name, d.scores, want.scores)
        if chip is sig.TPU_V5E:
            golden = SIG_PROFILE[0]
            assert (d.matched, d.config) == (golden, {"arch": golden}) \
                and d.corr >= SIG_THRESHOLD, d
            assert d.scores["phi3-mini-3p8b"] < d.corr - 0.1, d.scores
        ranked = sorted(d.scores.items(), key=lambda kv: -kv[1])
        print(f"[signatures] {chip.name} spec: kimi-k2 -> matched "
              f"{d.matched} (corr {d.corr:.4f}, threshold "
              f"{SIG_THRESHOLD}; config {d.config}); scores "
              + ", ".join(f"{a} {v:.4f}" for a, v in ranked)
              + f"; one K2 launch; the CPU tuner's decision, scores within "
              f"{e:.3g} (tol {SIG_TOL:g}) [{name}]")
        tuners[chip.name] = (tuner, series[SIG_QUERY])
    check_k2_long(dev, errs, name)
    tuner, query = tuners[sig.H100.name]
    match_ms = cuda_ms(lambda: tuner.match(SIG_QUERY, query), 5)
    t1 = time.perf_counter()
    for _ in range(5):
        tuner.preprocess(query)
    denoise_ms = (time.perf_counter() - t1) / 5 * 1e3
    bank = tuner.db.bank(workloads=list(SIG_PROFILE))
    q = tuner.preprocess(query)
    args = _k2_args(dev, [q], [len(q)], bank)
    t_ms = cuda_ms(lambda: score.score_bank_offline(*args, band=SIG_BAND),
                   20)
    t_plain = cuda_ms(
        lambda: score.score_bank_offline_plain(*args, band=SIG_BAND), 1)
    cells = band_cells([len(q)] * len(bank), bank.lengths, SIG_BAND)
    m, k = bank.series.shape[1], len(bank)
    kb = (1e3 * 4 * (len(q) + 3 + m * k + k + 2 * k) / card_peaks(name)[0],
          1e3 * ops_per_cell(3) * cells / dtw_op_rate(name))
    print(f"[signatures] a match (host de-noise, bank upload, one K2 "
          f"launch) {match_ms:.4f} ms, the query's host de-noise alone "
          f"{denoise_ms:.4f} ms (host clock); K2 at 1 x {len(q)} against "
          f"{k} x {m}, band {SIG_BAND}: {t_ms:.4f} ms (plain "
          f"{t_plain:.2f} ms, bound {max(kb):.6f} ms by "
          f"{'bytes' if kb[0] >= kb[1] else 'operations'}, {cells} cells) "
          f"[{name}]")
    print(f"[signatures] phase 26 in {time.perf_counter() - t0:.1f} s "
          f"[{name}]")
    return paths


# ---------------------------------------------------------------------------
# phase 27: training on the card
# ---------------------------------------------------------------------------

#: Phase 27 (a): K9 f32's backward against ``flash_backward_plain`` on the
#: same inputs (the kernel's own o and lse): max |kernel - plain| <=
#: K9_BWD_REL max |plain|, for each of dq, dk and dv.  Both sum in float32,
#: in other orders (the kernel as three TF32 products a product on the
#: tensor cores, each 32-row step's sum added in float32; the plain version
#: through torch.matmul), a kv row's dk and dv over up to G S = 12,288
#: query rows at minitron-4b's layer: relative errors of ~1e-6 expected.
#: Stated before the first run.
K9_BWD_REL = 1e-4
#: The forward's lse against the plain version's, absolute (|lse| up to
#: ~15 at S = 4096: a float32 step there is ~1e-6; the kernel's scores are
#: split-TF32 products).  Stated before the first run.
K9_LSE_TOL = 1e-4
#: (a)'s shapes: (what, B, H, KV, S, T, dh, dv, causal, unaligned).
K9_BWD_CASES = (
    ("minitron-4b layer", 1, 24, 8, 4096, 4096, 128, 128, True, False),
    ("lm-768x12 layer", 8, 12, 6, 256, 256, 64, 64, True, False),
    ("zamba2-7b shared attention", 1, 32, 32, 4096, 4096, 112, 112, True,
     False),
    ("dh 96 (phi3-mini's head)", 2, 4, 4, 256, 256, 96, 96, True, False),
    ("S 128 < T 256", 1, 4, 2, 128, 256, 64, 64, True, False),
    ("S 256 > T 128", 1, 4, 2, 256, 128, 128, 64, True, False),
    ("non-causal, dv 32 < dh", 2, 4, 1, 128, 192, 64, 32, False, False),
    ("dh 18 / dv 10, element-wise loads", 1, 2, 1, 128, 128, 18, 10, True,
     False),
    ("one element into storage", 1, 4, 2, 128, 128, 64, 64, True, True),
)


def k9_bwd_case(dev, errs: ErrLog, what: str, b, h, kv, s, t, dh, dv,
                causal: bool, unaligned: bool, seed: int, tile: int = 64):
    """One shape of (a): o bitwise with and without the lse, the lse
    within K9_LSE_TOL of the plain version's, the backward within
    K9_BWD_REL of the plain version and bitwise across two launches (at
    MLA's head, dh over 128, its own backward kernel).  ``tile`` is the
    wrappers' bq = bk (S and T multiples of it; the kernels tile by 64
    whatever it is).  Returns (q, k, v, o, do, lse) for timing."""
    from repro_torch.kernels.attention import kernel as k9
    key = "K9-f32-mla-bwd" if dh > k9.MAX_BWD_D else "K9-f32-bwd"
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = _attn_inputs(gen, dev, b, h, kv, s, t, dh, dv, torch.float32)
    do = torch.randn((b, h, s, dv), generator=gen, device=dev)
    if unaligned:
        q, k, v, do = (_at_offset(x) for x in (q, k, v, do))
    reset_counts()
    o0, none = k9._launch_forward(q, k, v, causal, with_lse=False)
    o, lse = k9._launch_forward(q, k, v, causal, with_lse=True)
    dq, dk, dv_ = k9.flash_backward(q, k, v, o, do, lse, tile, tile, causal)
    again = k9.flash_backward(q, k, v, o, do, lse, tile, tile, causal)
    torch.cuda.synchronize()
    launched({k: 0 for k in counts()}, K9_f32=2, **{key.replace("-", "_"): 2})
    assert none is None and torch.equal(o0, o), \
        f"{what}: o with the lse is not bitwise o without it"
    assert all(torch.equal(x, y) for x, y in zip((dq, dk, dv_), again)), \
        f"{what}: two backward launches differ"
    _, lse_p = k9.flash_forward_plain(q, k, v, tile, tile, causal,
                                      with_lse=True)
    e_lse = float((lse - lse_p).abs().max())
    plain = k9.flash_backward_plain(q, k, v, o, do, lse, tile, tile, causal)
    rel = [_rel(x, y) for x, y in zip((dq, dk, dv_), plain)]
    for x, y in zip((dq, dk, dv_), plain):
        errs.diff(key, x, y)
        assert torch.isfinite(x).all()
    assert e_lse <= K9_LSE_TOL, f"{what}: lse err {e_lse} > {K9_LSE_TOL}"
    assert max(rel) <= K9_BWD_REL, \
        f"{what}: rel err dq, dk, dv {rel} beyond {K9_BWD_REL}"
    print(f"[{'MLA K9' if dh > k9.MAX_BWD_D else 'K9'} bwd] {what} (B {b}, "
          f"H {h}, KV {kv}, S {s}, T {t}, dh {dh}, "
          f"dv {dv}{', causal' if causal else ''}): rel err dq "
          f"{rel[0]:.3g}, dk {rel[1]:.3g}, dv {rel[2]:.3g} (tol "
          f"{K9_BWD_REL:g} of max |plain|); lse max abs err {e_lse:.3g} "
          f"(tol {K9_LSE_TOL:g}); o bitwise with and without the lse; "
          f"two backward launches bitwise")
    return q, k, v, o, do, lse


def k9_bwd_padded(dev, errs: ErrLog, s: int = 200, seed: int = 271) -> None:
    """(a) through ``models.attention._flash`` at an S that is not a
    multiple of 64 (padded to 256, the output sliced): autograd's dq,
    dk, dv on the card (K9 f32 with the lse, then the backward kernel:
    nothing non-contiguous reaches it, or its checks raise) against the
    same call on the CPU (the plain versions), within K9_BWD_REL."""
    from repro_torch.models import attention as mattn
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, h, kv, dh = 2, 6, 2, 64
    q = torch.randn((b, s, h, dh), generator=gen, device=dev)
    k = torch.randn((b, s, kv, dh), generator=gen, device=dev)
    v = torch.randn((b, s, kv, dh), generator=gen, device=dev)
    do = torch.randn((b, s, h, dh), generator=gen, device=dev)
    grads = []
    for d in (dev, torch.device("cpu")):
        xs = [x.detach().to(d).requires_grad_() for x in (q, k, v)]
        reset_counts()
        o = mattn._flash(*xs)
        grads.append(torch.autograd.grad(o, xs, do.to(d)))
        if d.type == "cuda":
            torch.cuda.synchronize()
            got = counts()
            assert got == {**{n: 0 for n in got}, "K9-f32": 1,
                           "K9-f32-bwd": 1}, got
    rel = [_rel(x.cpu(), y) for x, y in zip(*grads)]
    for x, y in zip(*grads):
        errs.diff("K9-f32-bwd", x.cpu(), y)
    assert max(rel) <= K9_BWD_REL, rel
    print(f"[K9 bwd] models.attention._flash at S {s} (padded to "
          f"{s + (-s) % 64}; B {b}, H {h}, KV {kv}, dh {dh}): card vs CPU "
          f"rel err dq {rel[0]:.3g}, dk {rel[1]:.3g}, dv {rel[2]:.3g}; one "
          f"forward and one backward launch")


def k9_bwd_bound(name: str, b, h, kv, s, t, dh, dv, causal=True):
    """(bytes ms, operations ms, f32 CUDA-core operations ms) of K9's
    backward: q, k, v, o, do, lse, dq, dk, dv once each at the card's
    memory rate; the least work, 2 (3 dh + 2 dv) FLOPs a query-key pair
    under the mask, taken as the kernel takes it, three TF32 products, at
    the dense TF32 tensor-core peak (the row's bound), and once at the f32
    CUDA-core peak (printed beside it)."""
    from repro_torch.kernels.attention.kernel import causal_pairs
    mem, f32, _, tf32 = card_peaks(name)
    nbytes = 4 * (2 * b * h * s * (dh + dv) + 2 * b * kv * t * (dh + dv)
                  + b * h * s)
    flops = 2 * (3 * dh + 2 * dv) * b * h * causal_pairs(s, t, causal)
    return nbytes / mem * 1e3, 3 * flops / tf32 * 1e3, flops / f32 * 1e3


def k9_fwd_bound(name: str, b, h, kv, s, t, dh, dv, causal=True):
    """(bytes ms, operations ms) of K9 f32's forward with its lse, by the
    K9 f32 row's rule: q, k, v read and o and the lse written once at the
    card's memory rate; 2 (dh + dv) FLOPs a query-key pair under the mask
    as three TF32 products at the dense TF32 tensor-core peak."""
    from repro_torch.kernels.attention.kernel import causal_pairs
    mem, _, _, tf32 = card_peaks(name)
    nbytes = 4 * (b * h * s * (dh + dv + 1) + b * kv * t * (dh + dv))
    flops = 2 * (dh + dv) * b * h * causal_pairs(s, t, causal)
    return nbytes / mem * 1e3, 3 * flops / tf32 * 1e3


def k9_fwd_line(name: str, what: str, q, k, v, causal, fwd_ms) -> str:
    """The ``[K9 f32 fwd]`` line of a training layer: the forward with its
    lse (``fwd_ms``) beside its bound, its plain version and SDPA's
    float32 forward on the same inputs, timed now."""
    from repro_torch.kernels.attention import kernel as k9
    b, h, s, dh = q.shape
    kv, t, dv = k.shape[1], k.shape[2], v.shape[-1]
    bounds = k9_fwd_bound(name, b, h, kv, s, t, dh, dv, causal)
    plain_ms = cuda_ms(lambda: k9.flash_forward_plain(
        q, k, v, 64, 64, causal, with_lse=True), 1)
    lib_ms = cuda_ms(lambda: _sdpa(q, k, v), 3)
    return (f"[K9 f32 fwd] {what} (B {b}, H {h}, KV {kv}, S {s}, dh {dh}, "
            f"dv {dv}): the forward with its lse {fwd_ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms, SDPA's "
            f"f32 forward {lib_ms:.3f} ms, bound {max(bounds):.3f} ms by "
            f"{'bytes' if bounds[0] >= bounds[1] else 'operations'} (bytes "
            f"{bounds[0]:.3f}, three TF32 products {bounds[1]:.3f}) [{name}]")


def _sdpa_bwd_ms(q, k, v, do) -> float:
    """The library yardstick: autograd of scaled_dot_product_attention
    (causal, GQA) in float32, its backward alone."""
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o = _sdpa(*xs)
    return cuda_ms(lambda: torch.autograd.grad(o, xs, do,
                                               retain_graph=True), 3)


def check_k9_bwd(dev, errs: ErrLog, name: str):
    """Phase 27 (a): the backward's SASS holds HGMMA (its products on the
    tensor cores); every K9_BWD_CASES shape and the padded model call
    held as above; the first two (the two training paths' layers) timed
    beside the plain version, SDPA's backward and the bound.  Returns
    {what: (ms, plain ms, library ms, (bytes ms, operations ms))}."""
    from repro_torch.kernels.attention import kernel as k9
    for kern in ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"):
        ops = sass_ops(k9.BWD_LIB, kern, ("HGMMA",))
        assert ops and all(not o.endswith(" 0 HGMMA") for o in ops.values()), \
            f"no HGMMA in {kern}'s SASS: {ops}"
    times = {}
    for i, case in enumerate(K9_BWD_CASES):
        what, b, h, kv, s, t, dh, dv, causal, unaligned = case
        q, k, v, o, do, lse = k9_bwd_case(dev, errs, *case, seed=270 + i)
        if i >= 3:
            continue
        args = (q, k, v, o, do, lse, 64, 64, causal)
        ms = cuda_ms(lambda: k9.flash_backward(*args), 3)
        plain_ms = cuda_ms(lambda: k9.flash_backward_plain(*args), 1)
        lib_ms = _sdpa_bwd_ms(q, k, v, do)
        *bounds, f32_ms = k9_bwd_bound(name, b, h, kv, s, t, dh, dv, causal)
        fwd_ms = cuda_ms(lambda: k9._launch_forward(q, k, v, causal,
                                                    with_lse=True), 3)
        times[what] = (ms, plain_ms, lib_ms, tuple(bounds))
        print(f"[K9 bwd] {what}: {ms:.3f} ms a launch (plain {plain_ms:.1f} "
              f"ms, SDPA's backward {lib_ms:.3f} ms, bound "
              f"{max(bounds):.3f} ms by "
              f"{'bytes' if bounds[0] >= bounds[1] else 'operations'}: "
              f"bytes {bounds[0]:.3f}, three TF32 products "
              f"{bounds[1]:.3f}, f32 CUDA-core operations {f32_ms:.3f}; "
              f"the forward with the lse {fwd_ms:.3f} ms) [{name}]")
        print(k9_fwd_line(name, what, q, k, v, causal, fwd_ms))
        del q, k, v, o, do, lse, args
        torch.cuda.empty_cache()
    k9_bwd_padded(dev, errs)
    return times


#: Phase 27 (a): K9 f32's backward at MLA's head (``flash_f32_bwd_mla.cu``,
#: split TF32 on the tensor cores at 16-row steps: three TF32 products a
#: product, each step's product added to float32 sums on CUDA cores, S
#: summed from three partial chains) held as K9_BWD_CASES are, within
#: K9_BWD_REL: a kv row's dk and dv sum over G S = 4096 query rows at
#: deepseek-v2's layer, dq over up to 4096 keys; relative errors of ~1e-6
#: to 2e-6 expected, as K9 f32's backward at minitron's layer.  The
#: tolerance was stated before the first run of the CUDA-core kernel.
#: (what, B, H, KV, S, T, dh, dv, causal, unaligned, the wrappers' tile).
K9_MLA_BWD_CASES = (
    ("deepseek-v2 layer", 1, 128, 128, 4096, 4096, 192, 128, True, False,
     64),
    ("kimi-k2 layer (64 heads)", 1, 64, 64, 4096, 4096, 192, 128, True,
     False, 64),
    ("S = T = 328, not whole 64-row tiles", 1, 4, 2, 328, 328, 192, 128,
     True, False, 8),
    ("non-causal, S 128 < T 256, G 2", 2, 4, 2, 128, 256, 192, 128, False,
     False, 64),
    ("dh 130 / dv 66, element-wise loads", 1, 2, 1, 128, 128, 130, 66, True,
     False, 64),
    ("one element into storage", 1, 4, 2, 128, 128, 192, 128, True, True,
     64),
)


def check_k9_mla_bwd(dev, errs: ErrLog, name: str):
    """Phase 27 (a) at MLA's head: every K9_MLA_BWD_CASES shape held as
    ``k9_bwd_case`` holds it; deepseek-v2's layer timed beside the plain
    version, SDPA's backward and the bound.  Returns (ms, plain ms,
    library ms, (bytes ms, operations ms)) of that layer.  Its SASS must
    hold HGMMA (its products on the tensor cores)."""
    from repro_torch.kernels.attention import kernel as k9
    for kern in ("flash_bwd_mla_dkdv_kernel", "flash_bwd_mla_dq_kernel"):
        ops = sass_ops(k9.BWD_MLA_LIB, kern, ("HGMMA",))
        assert ops and all(not o.endswith(" 0 HGMMA") for o in ops.values()), \
            f"no HGMMA in {kern}'s SASS: {ops}"
    out = None
    for i, case in enumerate(K9_MLA_BWD_CASES):
        what, b, h, kv, s, t, dh, dv, causal, unaligned, tile = case
        q, k, v, o, do, lse = k9_bwd_case(dev, errs, *case[:-1],
                                          seed=2700 + i, tile=tile)
        if i == 0:
            args = (q, k, v, o, do, lse, 64, 64, causal)
            ms = cuda_ms(lambda: k9.flash_backward(*args), 3)
            plain_ms = cuda_ms(lambda: k9.flash_backward_plain(*args), 1)
            lib_ms = _sdpa_bwd_ms(q, k, v, do)
            *bounds, f32_ms = k9_bwd_bound(name, b, h, kv, s, t, dh, dv,
                                           causal)
            fwd_ms = cuda_ms(lambda: k9._launch_forward(
                q, k, v, causal, with_lse=True), 3)
            out = (ms, plain_ms, lib_ms, tuple(bounds))
            print(f"[MLA K9 bwd] {what}: {ms:.3f} ms a launch (plain "
                  f"{plain_ms:.1f} ms, SDPA's backward {lib_ms:.3f} ms, bound "
                  f"{max(bounds):.3f} ms by "
                  f"{'bytes' if bounds[0] >= bounds[1] else 'operations'}: "
                  f"bytes {bounds[0]:.3f}, three TF32 products "
                  f"{bounds[1]:.3f}, f32 CUDA-core operations {f32_ms:.3f}; "
                  f"the forward with the lse {fwd_ms:.3f} ms) [{name}]")
            print(k9_fwd_line(name, what, q, k, v, causal, fwd_ms))
            del args
        del q, k, v, o, do, lse
        torch.cuda.empty_cache()
    return out


#: Phase 27 (a): K10 f32's backward (``gla_bwd.cu``, split TF32 on the
#: tensor cores: three TF32 products a product, each step's product added
#: to float32 sums on CUDA cores) against ``gla_chunks_backward_plain`` on
#: the same inputs (the forward kernel's chunk states): max |kernel -
#: plain| <= K10_BWD_REL max |plain| for each of dq, dk, dv and dg.  Both
#: sum in float32 in other orders over a chunk's rows, the state's gradient
#: over up to 64 chunks; dg = q . dq - k . dk differences terms of the
#: gradients' size: relative errors of ~1e-6 expected (the emulation in
#: tests/test_torch_train_bwd.py: 2e-7 to 9e-7), no longer bitwise the
#: plain version as the CUDA-core kernel was.  The tolerance was stated
#: before the first run of the CUDA-core kernel.
K10_BWD_REL = 1e-4
#: (a)'s shapes: (what, B, H, S, dk, dv, chunk, a final-state gradient).
K10_BWD_CASES = (
    ("zamba2-7b layer", 1, 112, 4096, 64, 64, 256, False),
    ("dk = dv = 128, chunk 64", 1, 8, 1024, 128, 128, 64, True),
    ("64 chunks of 64, a final-state gradient", 2, 4, 4096, 64, 64, 64,
     True),
    ("dk 64 / dv 32, chunk 24 (not whole 64-row tiles)", 1, 3, 240, 64, 32,
     24, True),
    ("dk 16 / dv 8, one chunk", 2, 2, 128, 16, 8, 128, False),
    ("xlstm-1p3b mLSTM layer, a 128-wide value block (gla_blocked: dk 1024 "
     "as 8 heads of 128)", 1, 32, 4096, 128, 128, 256, False),
    ("xlstm-1p3b mLSTM layer, the 1-wide value block (the normalizer)", 1,
     32, 4096, 128, 1, 256, False),
)


def _gla_bwd_inputs(gen, dev, b, h, s, dk, dv):
    """q, k, v, log_a (<= 0), do as ``tests/test_torch_gla.py`` draws
    them, on the card."""
    q = torch.randn((b, h, s, dk), generator=gen, device=dev)
    k = 0.3 * torch.randn((b, h, s, dk), generator=gen, device=dev)
    v = torch.randn((b, h, s, dv), generator=gen, device=dev)
    la = -0.2 * torch.randn((b, h, s), generator=gen, device=dev).abs()
    do = torch.randn((b, h, s, dv), generator=gen, device=dev)
    return q, k, v, la, do


def k10_bwd_bound(name: str, b, h, s, dk, dv, chunk):
    """(bytes ms, operations ms, f32 CUDA-core operations ms) of K10's
    backward: q, k, v, g, the chunk states, do, dq, dk, dv and dg once
    each at the card's memory rate; the least work, a chunk's causal
    pairs, L (L + 1) / 2, at 2 (3 dk + 2 dv) FLOPs (A = do v^T, B = q k^T
    and their products with q, do and k) and 8 L dk dv more (U, the two
    state terms, the inter-chunk term), taken as the kernel takes it,
    three TF32 products, at the dense TF32 tensor-core peak (the row's
    bound), and once at the f32 CUDA-core peak (printed beside it)."""
    mem, f32, _, tf32 = card_peaks(name)
    nc = s // chunk
    nbytes = 4 * b * h * (s * (4 * dk + 3 * dv + 2) + nc * dk * dv)
    flops = b * h * nc * (chunk * (chunk + 1) * (3 * dk + 2 * dv)
                          + 8 * chunk * dk * dv)
    return nbytes / mem * 1e3, 3 * flops / tf32 * 1e3, flops / f32 * 1e3


def k10_bwd_case(dev, errs: ErrLog, what: str, b, h, s, dk, dv, chunk,
                 with_dstate: bool, seed: int):
    """One shape of (a): the forward kernel's chunk states within
    GLA_RTOL / GLA_ATOL of the plain forward's, the backward within
    K10_BWD_REL of the plain version per gradient and bitwise across two
    launches.  Returns the backward's arguments for timing."""
    from repro_torch.kernels.gla import kernel as k10
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, la, do = _gla_bwd_inputs(gen, dev, b, h, s, dk, dv)
    dst = torch.randn((b, h, dk, dv), generator=gen, device=dev) \
        if with_dstate else None
    g = k10.chunk_cumsum(la, chunk)
    reset_counts()
    o, state, states = k10._launch_forward(q, k, v, g, chunk, torch.float32)
    states[:, :, -1] = state
    args = (q, k, v, g, states, do, dst, chunk)
    grads = k10.gla_chunks_backward(*args)
    again = k10.gla_chunks_backward(*args)
    torch.cuda.synchronize()
    launched({n: 0 for n in counts()}, K10=1, K10_f32_bwd=2)
    assert all(torch.equal(x, y) for x, y in zip(grads, again)), \
        f"{what}: two backward launches differ"
    _, _, st_p = k10.gla_chunks_plain(q, k, v, g, chunk, with_states=True)
    assert torch.allclose(states, st_p, rtol=GLA_RTOL, atol=GLA_ATOL), \
        f"{what}: chunk states"
    plain = k10.gla_chunks_backward_plain(*args)
    rel = [_rel(x, y) for x, y in zip(grads, plain)]
    for x, y in zip(grads, plain):
        errs.diff("K10-f32-bwd", x, y)
        assert torch.isfinite(x).all()
    assert max(rel) <= K10_BWD_REL, \
        f"{what}: rel err dq, dk, dv, dg {rel} beyond {K10_BWD_REL}"
    print(f"[K10 bwd] {what} (B {b}, H {h}, S {s}, dk {dk}, dv {dv}, chunk "
          f"{chunk}{', final-state gradient' if with_dstate else ''}): rel "
          f"err dq {rel[0]:.3g}, dk {rel[1]:.3g}, dv {rel[2]:.3g}, dg "
          f"{rel[3]:.3g} (tol {K10_BWD_REL:g} of max |plain|); chunk states "
          f"within rtol {GLA_RTOL:g} / atol {GLA_ATOL:g} of the plain "
          f"forward's; two backward launches bitwise")
    return args


def gla_bwd_padded(dev, errs: ErrLog, s: int = 1000, seed: int = 2750):
    """(a) through ``models.ssm.gla_chunked`` at an S that is not a
    multiple of the chunk (1000, padded to 1024 at chunk 256), with a
    final-state gradient: autograd's dq, dk, dv and d log_a on the card
    (K10 f32, then the backward kernel, through ``GlaChunks``) against
    the same call on the CPU (the plain versions), within K10_BWD_REL."""
    from repro_torch.models import ssm
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, h, dk, dv, chunk = 1, 8, 64, 64, 256
    q, k, v, la, do = _gla_bwd_inputs(gen, dev, b, h, s, dk, dv)
    dst = torch.randn((b, h, dk, dv), generator=gen, device=dev)
    grads = []
    for d in (dev, torch.device("cpu")):
        xs = [x.detach().to(d).requires_grad_() for x in (q, k, v, la)]
        reset_counts()
        o, st = ssm.gla_chunked(*xs, chunk)
        grads.append(torch.autograd.grad(
            (o * do.to(d)).sum() + (st * dst.to(d)).sum(), xs))
        if d.type == "cuda":
            torch.cuda.synchronize()
            launched({n: 0 for n in counts()}, K10=1, K10_f32_bwd=1)
    rel = [_rel(x.cpu(), y) for x, y in zip(*grads)]
    for x, y in zip(grads[0][:3], grads[1][:3]):
        errs.diff("K10-f32-bwd", x.cpu(), y)
    assert max(rel) <= K10_BWD_REL, rel
    print(f"[K10 bwd] models.ssm.gla_chunked at S {s} (padded to "
          f"{s + (-s) % chunk}; B {b}, H {h}, dk {dk}, dv {dv}, chunk "
          f"{chunk}, final-state gradient): card vs CPU rel err dq "
          f"{rel[0]:.3g}, dk {rel[1]:.3g}, dv {rel[2]:.3g}, dlog_a "
          f"{rel[3]:.3g}; one forward and one backward launch")


def check_k10_bwd(dev, errs: ErrLog, name: str):
    """Phase 27 (a) for K10: every K10_BWD_CASES shape and the padded
    model call held as above; zamba2-7b's layer and xlstm-1p3b's two
    blocked shapes timed beside the plain version and the bound, and the
    f32 forward there beside its bound.  Its SASS must hold HGMMA (its
    products on the tensor cores).  Returns (ms, plain ms, None, (bytes
    ms, operations ms)) of zamba2's layer."""
    from repro_torch.kernels.gla import kernel as k10
    for kern in ("gla_bwd_u_kernel", "gla_bwd_dkdv_kernel",
                 "gla_bwd_dq_kernel"):
        ops = sass_ops(k10.BWD_LIB, kern, ("HGMMA",))
        assert ops and all(not o.endswith(" 0 HGMMA") for o in ops.values()), \
            f"no HGMMA in {kern}'s SASS: {ops}"
    out = None
    for i, case in enumerate(K10_BWD_CASES):
        what, b, h, s, dk, dv, chunk, with_dstate = case
        args = k10_bwd_case(dev, errs, *case, seed=2760 + i)
        if i == 0 or what.startswith("xlstm"):
            ms = cuda_ms(lambda: k10.gla_chunks_backward(*args), 3)
            plain_ms = cuda_ms(lambda: k10.gla_chunks_backward_plain(*args),
                               1)
            fwd_ms = cuda_ms(lambda: k10._launch_forward(
                *args[:4], chunk, torch.float32), 3)
            *bounds, f32_ms = k10_bwd_bound(name, b, h, s, dk, dv, chunk)
            if i == 0:
                out = (ms, plain_ms, None, tuple(bounds))
            fb = gla_bound(name, b, h, s, dk, dv, chunk, f32=True)
            print(f"[K10 bwd] {what}: {ms:.3f} ms a launch (plain "
                  f"{plain_ms:.1f} ms, no library call, bound "
                  f"{max(bounds):.3f} ms by "
                  f"{'bytes' if bounds[0] >= bounds[1] else 'operations'}: "
                  f"bytes {bounds[0]:.3f}, three TF32 products "
                  f"{bounds[1]:.3f}, f32 CUDA-core operations "
                  f"{f32_ms:.3f}; the f32 forward {fwd_ms:.3f} ms, its "
                  f"bound {max(fb):.3f} ms by "
                  f"{'bytes' if fb[0] >= fb[1] else 'operations'}: bytes "
                  f"{fb[0]:.3f}, f32 CUDA-core operations {fb[1]:.3f}) "
                  f"[{name}]")
        del args
        torch.cuda.empty_cache()
    gla_bwd_padded(dev, errs)
    return out


#: Phase 27 (a) for the sLSTM scan's backward: the kernels against
#: ``slstm_scan_backward_plain`` on the same inputs (the forward kernel's
#: own records).  Both take the same operations in the same order, each
#: rounded on its own (-fmad=false, IEEE division, the forward's step
#: recomputed by the same code, the chunks' maps composed and applied in
#: one order), so bitwise is expected; a difference is witnessed (counted,
#: the first printed) and must stay within SLSTM_BWD_REL of max |plain|
#: for each gradient, the initial state's within SLSTM_BWD_REL relative
#: besides.  Stated before the first run.
SLSTM_BWD_REL = 1e-5
#: (what, B, S, D, a nonzero initial state, the final state's gradients,
#: the dyadic ties of ``tests/test_torch_slstm_bwd.py``).  The chunk is
#: ``slstm.kernel.K_CHUNK`` = 64 steps; the phases' blocks are 128
#: channels of d, the carries' 32 channels of (b, d).
SLSTM_BWD_CASES = (
    ("xlstm-1p3b training layer", 1, 4096, 2048, False, False, False),
    ("xlstm-1p3b prefill shape", 4, 4096, 2048, False, False, False),
    ("xlstm-1p3b prefill shape from a nonzero state", 4, 4096, 2048, True,
     True, False),
    ("S 1 (a decode step)", 4, 1, 2048, True, True, False),
    ("S 7", 2, 7, 2048, True, True, False),
    ("S 129 (two chunks and a step), D 100 off the 128-channel block, B "
     "D 300 off the 32-channel one", 3, 129, 100, True, True, False),
    ("S 65 (a chunk and a step)", 3, 65, 2048, True, True, False),
    ("dyadic ties at step 0 (n == 1; f + m == i in one channel)", 2, 6, 8,
     False, False, True),
)
#: float32 operations a channel a step of the backward as a function, each
#: counted as one, what its bound counts: the forward's step recomputed
#: (``slstm.kernel.OPS_PER_STEP``) and its adjoint (``slstm_bwd.cu``'s
#: ``recompute``'s 6 compares for the tie weights; ``adjoint``'s 1
#: division, 22 multiplies and 15 adds, subtracts and negations; r's 4
#: sums of a multiply and an add).
SLSTM_BWD_OPS = 27 + 6 + 1 + 22 + 15 + 8
#: The chunked scan's own operations: a step of a mapped chunk (phase 1:
#: the recompute, the tie weights and five adjoints), a step of the replay
#: (phase 3: SLSTM_BWD_OPS) and a chunk's carry (phase 2: 16 multiplies
#: and 16 adds a channel).
SLSTM_MAP_OPS = 27 + 6 + 5 * (1 + 22 + 15)
SLSTM_CARRY_OPS = 32


def _slstm_bwd_inputs(gen, dev, b, s, d, state, final, tie):
    """zifo, r, the initial state, dhs and the final state's gradients
    (None when not asked for) on the card: as ``tests/test_torch_slstm.py``
    draws them (forget pre-activations 0.5 up), r 0.02 N(0, 1) at the
    model's shapes (``slstm_init``'s) and 0.5 N(0, 1) at the edges; with
    ``tie``, ``tests/test_torch_slstm_bwd.py``'s dyadic construction from
    the zero state (i >= f at step 0, so n == 1 there; f == i in channel 3
    of sequence 0)."""
    rn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    if tie:
        dy = lambda *shape: torch.randint(-8, 9, shape, generator=gen,
                                          device=dev).float() / 8
        zifo, r, dhs = dy(b, s, 4 * d), dy(4, d) / 2, dy(b, s, d)
        zifo[:, 0, d:2 * d] = zifo[:, 0, d:2 * d].abs()
        zifo[:, 0, 2 * d:3 * d] = -zifo[:, 0, 2 * d:3 * d].abs()
        zifo[0, 0, 2 * d + 3] = zifo[0, 0, d + 3] = 0.25
        zifo[0, 0, 3] = dhs[0, 0, 3] = 0.5
    else:
        zifo, dhs = rn(b, s, 4 * d), rn(b, s, d)
        zifo[..., 2 * d:3 * d] += 0.5
        r = (0.02 if s >= 4096 else 0.5) * rn(4, d)
    st = [torch.zeros((b, d), device=dev) for _ in range(4)]
    if state:
        st = [rn(b, d) for _ in range(4)]
        st[2] = st[2].abs() + 0.5
    fin = [rn(b, d) for _ in range(4)] if final else [None] * 4
    return zifo, r, st, dhs, fin


def slstm_bwd_bound(name: str, b, s, d):
    """(bytes ms, operations ms) of the sLSTM scan's backward as a
    function: zifo, hs, the three records and dhs read once, dzifo written
    once (the [B, D] states and r besides), at the card's memory rate;
    SLSTM_BWD_OPS float32 operations a channel a step at the non-FMA
    rate."""
    nbytes = 4 * (b * s * (8 * d + 5 * d) + 9 * b * d + 8 * d)
    return (nbytes / card_peaks(name)[0] * 1e3,
            SLSTM_BWD_OPS * b * s * d / dtw_op_rate(name) * 1e3)


def slstm_bwd_floor(name: str, b, s, d, chunk: int):
    """(bytes ms, operations ms) of the chunked scan's own work: phase 1
    reads the inputs of chunks 1 .. nc - 1 and writes their maps (20
    floats a channel), phase 2 reads them and writes the carries (4),
    phase 3 reads every input and the carries and writes dzifo and r's
    chunk sums (4), phase 4 reads those; SLSTM_MAP_OPS a mapped step,
    SLSTM_CARRY_OPS a carry and SLSTM_BWD_OPS a replayed step."""
    nc = -(-s // chunk)
    mapped = s - min(s, chunk)
    inputs = 4 * b * d * 9  # a step's gates, previous state and dhs
    nbytes = (inputs * (mapped + s) + 4 * b * s * 4 * d
              + 4 * b * (nc - 1) * d * (20 + 20 + 4 + 4)
              + 4 * b * nc * d * (4 + 4))
    ops = b * d * (SLSTM_MAP_OPS * mapped + SLSTM_CARRY_OPS * (nc - 1)
                   + SLSTM_BWD_OPS * s)
    return (nbytes / card_peaks(name)[0] * 1e3,
            ops / dtw_op_rate(name) * 1e3)


def slstm_bwd_case(dev, errs: ErrLog, what: str, b, s, d, state, final, tie,
                   seed: int):
    """One shape of (a): the forward's hs and final state bitwise with and
    without its records (and at S <= 129 the records bitwise
    ``slstm_scan_plain``'s), the backward held to
    ``slstm_scan_backward_plain`` as SLSTM_BWD_REL says and bitwise across
    two launches.  Returns the backward's arguments for timing."""
    from repro_torch.kernels.slstm import kernel as ks
    gen = torch.Generator(device=dev).manual_seed(seed)
    zifo, r, st, dhs, fin = _slstm_bwd_inputs(gen, dev, b, s, d, state,
                                              final, tie)
    reset_counts()
    hs0, fin0, _ = ks._launch_forward(zifo, r, *st, False)
    hs, out, recs = ks._launch_forward(zifo, r, *st, True)
    args = (zifo, r, *st, hs, *recs, dhs, *fin)
    grads = ks.slstm_scan_backward(*args)
    again = ks.slstm_scan_backward(*args)
    torch.cuda.synchronize()
    # BWD_LIB.launches counts calls of the backward, each of up to four
    # kernels (the maps, the carries, the replay, r's gradient)
    launched({n: 0 for n in counts()}, sLSTM=2, sLSTM_bwd=2)
    assert torch.equal(hs, hs0) and all(
        torch.equal(x, y) for x, y in zip(out, fin0)), \
        f"{what}: the forward differs with its records"
    assert all(torch.equal(x, y) for x, y in zip(grads, again)), \
        f"{what}: two backward launches differ"
    if s <= 129:
        _, _, precs = ks.slstm_scan_plain(zifo, r, *st, with_states=True)
        assert all(torch.equal(x, y) for x, y in zip(recs, precs)), \
            f"{what}: records differ from the plain forward's"
    plain = ks.slstm_scan_backward_plain(*args)
    names = ("dzifo", "dr", "dh0", "dc0", "dn0", "dm0")
    rel, n_diff, first = [], 0, ""
    for nm, x, y in zip(names, grads, plain):
        assert torch.isfinite(x).all(), f"{what}: {nm} not finite"
        errs.diff("sLSTM-bwd", x, y)
        rel.append(_rel(x, y) if y.abs().max() > 0 else 0.0)
        bad = x != y
        if bad.any():
            n_diff += int(bad.sum())
            if not first:
                at = tuple(int(i) for i in bad.nonzero()[0])
                first = (f"; the first in {nm} at {at}: {float(x[at])!r} "
                         f"against {float(y[at])!r}")
        if nm in names[2:]:
            assert bool(((x - y).abs() <= SLSTM_BWD_REL * (
                y.abs().max() + y.abs())).all()), (what, nm)
    assert max(rel) <= SLSTM_BWD_REL, \
        f"{what}: rel err {dict(zip(names, rel))} beyond {SLSTM_BWD_REL}"
    print(f"[sLSTM bwd] {what} (B {b}, S {s}, D {d}"
          f"{', a nonzero initial state' if state else ''}"
          f"{', final-state gradients' if final else ''}): "
          + ("bitwise the plain backward" if n_diff == 0 else
             f"{n_diff} elements differ from the plain backward{first}")
          + f"; rel err " + ", ".join(f"{nm} {e:.3g}"
                                      for nm, e in zip(names, rel))
          + f" (tol {SLSTM_BWD_REL:g} of max |plain|); two launches "
          f"bitwise; the forward's hs and final state bitwise with and "
          f"without its records")
    return args


def check_slstm_bwd(dev, errs: ErrLog, name: str):
    """Phase 27 (a) for the sLSTM scan: every SLSTM_BWD_CASES shape held
    as above; at the training layer and the prefill shape the backward
    timed (CUDA events; on the device alone by ``graph_ms``) beside the
    bound and the chunked scan's own floor (``slstm_bwd_floor``), each
    phase alone on the device on what the phases before it left in the
    scratch, and at the training layer beside the plain
    backward (once) and the forward with its records and without.
    Returns (ms, plain ms, None, (bytes ms, operations ms)) of the
    training layer."""
    from repro_torch.kernels.slstm import kernel as ks
    assert {c[2] for c in SLSTM_BWD_CASES} >= {ks.K_CHUNK + 1,
                                               2 * ks.K_CHUNK + 1}
    out = None
    phases = ("maps", "carries", "replay", "dr")
    for i, case in enumerate(SLSTM_BWD_CASES):
        what, b, s, d = case[:4]
        args = slstm_bwd_case(dev, errs, *case, seed=2790 + i)
        if i < 2:
            ms = cuda_ms(lambda: ks.slstm_scan_backward(*args), 20)
            res = ks._launch_backward(ks.BWD_LIB, ks.K_CHUNK, *args)
            run = lambda p: ks._launch_backward(
                ks.BWD_LIB, ks.K_CHUNK, *args, phases=p, out=res)
            dev_ms = graph_ms(lambda: run(ks.BWD_PHASES), 20)
            alone = [graph_ms(lambda: run(1 << p), 20) for p in range(4)]
            bounds = slstm_bwd_bound(name, b, s, d)
            floor = slstm_bwd_floor(name, b, s, d, ks.K_CHUNK)
            line = (f"[sLSTM bwd] {what}: {ms:.4f} ms a launch (device "
                    f"{dev_ms:.4f}; each phase alone on the device: "
                    + ", ".join(
                        f"{n} {t:.4f}" for n, t in zip(phases, alone))
                    + f" ms); bound {max(bounds):.4f} ms by "
                    f"{'bytes' if bounds[0] >= bounds[1] else 'operations'}"
                    f" (bytes {bounds[0]:.4f}, f32 operations "
                    f"{bounds[1]:.4f}); the chunked scan's own floor "
                    f"{max(floor):.4f} ms (bytes {floor[0]:.4f}: the inputs "
                    f"read twice; f32 operations {floor[1]:.4f})")
            if i == 0:
                plain_ms = cuda_ms(
                    lambda: ks.slstm_scan_backward_plain(*args), 1)
                fwd = [cuda_ms(lambda: ks._launch_forward(*args[:6], rec), 5)
                       for rec in (False, True)]
                out = (ms, plain_ms, None, bounds)
                line += (f"; plain {plain_ms:.1f} ms, no library call; the "
                         f"f32 forward {fwd[0]:.4f} ms, with its records "
                         f"{fwd[1]:.4f} ms")
            print(line + f" [{name}]")
            del res
        del args
    torch.cuda.empty_cache()
    return out


#: Phase 27 (c): the card's two train steps against the CPU's from the
#: same weights.  The losses within TRAIN_LOSS_REL relative (float32 sums
#: in other orders through two layers: ~1e-6 expected).  The first
#: batch's gradients, each leaf within TRAIN_GRAD_REL of its largest
#: element (both sides differentiate the same function; K9's backward
#: kernel and cuBLAS against the plain versions and the CPU's GEMMs).  The
#: parameters after the two steps within rtol 1e-4 / atol TRAIN_PARAM_ATOL
#: = 2 lr: AdamW moves a weight by lr g / (|g| + eps), whose size does not
#: shrink with |g|, so where a gradient element is float32 noise the two
#: sides may step it in opposite directions, by up to lr a step.  Stated
#: before the first run.
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL = 1e-4
TRAIN_PARAM_ATOL = 2 * 3e-4
#: xlstm-1p3b's first gradients (8 layers at full width, 1 x 512 tokens)
#: carry more float32 noise than TRAIN_GRAD_REL: weights moved by one
#: rounding (half the weights' machine epsilon: 2^-24 in float32, 2^-8 in
#: bfloat16) move some leaves' gradients past it on the card alone, and
#: the CPU's as far as the card's differ from them (the sLSTM layer's
#: input projection first; PERF.md §6).  So where asked (``self_noise``),
#: each leaf is held within max(TRAIN_GRAD_REL, TRAIN_NOISE_X (the card's
#: own change + the CPU's own change)) under such a perturbation,
#: measured in the same run: two evaluations of one function differ by
#: about the sum of their rounding noise, and the factor 2 covers the
#: spread of a maximum over a leaf.  Phase 29 holds its bfloat16 first
#: batch so, the loss too, and takes no step.
TRAIN_NOISE_X = 2.0


def _rounding_perturbed(model, seed: int):
    """A copy of ``model`` with every weight w moved to w (1 + eps N(0,
    1)), eps half its dtype's machine epsilon, rounded: each weight stays
    or moves to a neighbouring value of its dtype."""
    out = copy.deepcopy(model)
    dev = next(out.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for p in out.parameters():
            p.mul_(1 + torch.finfo(p.dtype).eps / 2 * torch.randn(
                p.shape, generator=gen, device=dev))
    return out


def _train_cfg(arch: str, layers: int, remat: str = "none",
               dtype: str = "float32"):
    from repro_torch import configs
    return dataclasses.replace(configs.get(arch), num_layers=layers,
                               param_dtype=dtype, dtype=dtype, remat=remat)


def _train_launches(cfg, remat: int) -> dict:
    """The kernel launches one train step of ``cfg`` makes (``remat``
    forwards a layer: 2 under remat "full", the forward and its
    recompute, else 1): K9 of the config's dtype (f32 or bf16) a forward
    and a backward an attention layer or shared-attention occurrence (the
    backward at MLA's head its own kernel), K10 a forward and a backward
    a Mamba2 layer, and a forward and a backward a 128-wide value block
    of an mLSTM layer's dh
    + 1 (``gla_blocked``; dh 1024: 9 blocks), the sLSTM scan and its
    backward an sLSTM layer (``BWD_LIB.launches`` counts the backward's
    calls: one a layer, of four kernels at S 4096)."""
    want: dict = {}

    def add(key, n):
        want[key] = want.get(key, 0) + n
    for kind in cfg.layer_kinds():
        if kind == "mamba2":
            add("K10", remat)
            add("K10_f32_bwd", 1)
        elif kind == "mlstm":
            dh = cfg.ssm_expand * cfg.d_model // cfg.num_heads
            blocks = -(-(dh + 1) // 128)
            add("K10", remat * blocks)
            add("K10_f32_bwd", blocks)
        elif kind == "slstm":
            add("sLSTM", remat)
            add("sLSTM_bwd", 1)
        else:
            dt = "bf16" if cfg.dtype == "bfloat16" else "f32"
            add("K9" if dt == "bf16" else "K9_f32", remat)
            mla = cfg.attn_kind == "mla" and kind != "shared_attn"
            add(f"K9_{dt}_mla_bwd" if mla else f"K9_{dt}_bwd", 1)
    return want


def train_full(dev, name: str, arch: str = "minitron-4b", layers: int = 8,
               b: int = 1, s: int = 4096, steps: int = 4,
               dtype: str = "float32") -> dict:
    """Phase 27 (b) (and phase 29 (b) in bfloat16): ``arch`` at full
    width in ``dtype``, depth cut to ``layers``, its ``train_4k`` exec
    (remat "full"), trained ``steps`` steps on B x S tokens of the port's
    SyntheticCorpus through ``train.step.make_train_step``, each step's
    counts set to 0 just before it and read just after
    (``_train_launches``: K9 of the dtype forward 2 an attention layer,
    the forward and remat's recompute, its backward 1; K10 2 and its
    backward 1 a Mamba2 layer), no plain version called; ms a step
    (median), tokens/s, peak memory, each step's loss and grad norm
    (finite); then one more step traced.  Returns {"launches": per step
    by key, "ms": ...}."""
    from repro_torch import configs, models
    from repro_torch.data import DataPipeline, SyntheticCorpus
    from repro_torch.train import (AdamWConfig, adamw_init, cosine_schedule,
                                   make_train_step)
    ex = configs.exec_default(arch, "train_4k")
    cfg = _train_cfg(arch, layers, ex.remat, dtype)
    assert cfg.remat == "full", cfg.remat
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = models.init(cfg, generator=torch.Generator(
        device=dev).manual_seed(27), device=dev)
    opt_cfg = AdamWConfig(lr=3e-4)
    opt = adamw_init(model, opt_cfg)
    n_params = models.param_count(model)
    # the train driver's schedule: cosine, warmup 20
    step = make_train_step(cfg, ex, opt_cfg, lr_schedule=lambda c: (
        cosine_schedule(c, peak_lr=3e-4, warmup=20, total=100)))
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=27), s, b)
    print(f"[train full] {arch} at full width, {layers} of "
          f"{configs.get(arch).num_layers} layers, {dtype}, remat "
          f"{cfg.remat}: {n_params / 1e9:.3f} B parameters, weights and "
          f"AdamW state {torch.cuda.memory_allocated() / 2**30:.1f} GiB, "
          f"built in {time.perf_counter() - t0:.1f} s")
    want = _train_launches(cfg, 2)
    times, rows = [], []
    blocked = "mlstm" not in cfg.layer_kinds()
    for i in range(steps):
        batch = pipe.batch_at(i)
        torch.cuda.synchronize()
        reset_counts()
        with counting_plain(blocked) as seen:
            t1 = time.perf_counter()
            opt, met = step(model, opt, batch)
            loss, gn = float(met["loss"]), float(met["grad_norm"])
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t1))
        launched({k: 0 for k in counts()}, **want)
        assert seen["calls"] == 0, seen
        assert math.isfinite(loss) and math.isfinite(gn), (loss, gn)
        rows.append((loss, gn))
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = float(np.median(times))
    print(f"[train full] {arch}: {steps} steps of {b} x {s} tokens: "
          + "; ".join(f"step {i} loss {l:.4f} grad norm {g:.4f}"
                      for i, (l, g) in enumerate(rows)))
    print(f"[train full] {arch} ({dtype}): ms a step (median of {steps}) "
          f"{ms:.1f} "
          f"(each " + ", ".join(f"{t:.1f}" for t in times)
          + f"); {b * s / ms * 1e3:.0f} tokens/s; peak memory {peak:.1f} "
          f"GiB; launches a step: "
          + ", ".join(f"{k} {n}" for k, n in want.items())
          + f"; no plain version called [{name}]")
    from torch.profiler import ProfilerActivity, profile
    batch = pipe.batch_at(steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(model, opt, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t1)
    split = {"gemm": 0.0, "K9 forward": 0.0, "K9 backward": 0.0,
             "K10 forward": 0.0, "K10 backward": 0.0, "sLSTM forward": 0.0,
             "sLSTM backward": 0.0, "rest": 0.0}
    by = []
    for key, kms, n in _kernel_times(prof):
        by.append((key[:60], kms, n))
        if "slstm_scan_kernel" in key:
            split["sLSTM forward"] += kms
        elif "slstm_bwd_" in key:
            split["sLSTM backward"] += kms
        elif "flash_tf32" in key or any(k in key for k in K9_NAMES):
            split["K9 forward"] += kms
        elif "flash_bwd_" in key or "flash_bf16_bwd_" in key:
            split["K9 backward"] += kms
        elif "gla_fma_kernel" in key:
            split["K10 forward"] += kms
        elif "gla_bwd_" in key:
            split["K10 backward"] += kms
        elif any(g in key for g in GEMM_NAMES):
            split["gemm"] += kms
        else:
            split["rest"] += kms
    total = sum(split.values())
    top = sorted(by, key=lambda e: -e[1])[:6]
    print(f"[train full] {arch} ({dtype}) traced step: device {total:.1f} ms "
          f"of "
          f"{wall:.1f} ms wall, "
          + ", ".join(f"{k} {v:.1f} ms ({100 * v / max(total, 1e-9):.1f}%)"
                      for k, v in split.items())
          + "; top kernels: " + "; ".join(f"{k} {v:.1f} ms x {n}"
                                          for k, v, n in top))
    del model, opt, step
    torch.cuda.empty_cache()
    return {"launches": want, "ms": ms, "split": split,
            "peak_gb": peak * 2**30 / 1e9, "tokens_s": b * s / ms * 1e3}


def train_card_vs_cpu(dev, name: str, layers: int = 2, b: int = 2,
                      s: int = 128, steps: int = 2,
                      arch: str = "", self_noise: bool = False,
                      dtype: str = "float32") -> None:
    """Phase 27 (c) (and phase 29 (c) in bfloat16): the driver's default
    LM (lm-768x12), or ``arch`` at full width in ``dtype``, cut to
    ``layers`` layers, weights drawn once from a seeded generator (the
    LM's on the CPU, copied to the card; an arch's on the card, copied to
    the host, whose generator is slow at a billion weights); the first
    batch's loss and gradients, then ``steps`` train steps (AdamW lr
    3e-4) on each device: losses, gradients and parameters held as
    TRAIN_* say; the card's steps launch what ``_train_launches`` says
    (remat "none").  With ``self_noise``, each side's first loss and
    gradients are taken again from weights moved by one rounding
    (``_rounding_perturbed``, one copy drawn on the card for both
    sides), and a leaf's gradients (in bfloat16 the loss too) are held
    as TRAIN_NOISE_X says; bfloat16 takes no step.  The host's seconds
    are printed apart."""
    from repro_torch import models
    from repro_torch.data import DataPipeline, SyntheticCorpus
    from repro_torch.launch import train as tlaunch
    from repro_torch.sharding.rules import ExecConfig
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    t0 = time.perf_counter()
    bf16 = dtype == "bfloat16"
    assert not bf16 or (self_noise and not steps), \
        "bfloat16 is held by its own noise, on the first batch alone"
    cfg = _train_cfg(arch, layers, dtype=dtype) if arch else \
        tlaunch.build_config(tlaunch.parse_args(["--layers", str(layers)]))
    if arch:
        card = models.init(cfg, generator=torch.Generator(
            device=dev).manual_seed(270), device=dev)
        cpu = copy.deepcopy(card).to("cpu")
    else:
        cpu = models.init(cfg, generator=torch.Generator().manual_seed(270),
                          device="cpu")
        card = models.init(cfg, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        card.load_state_dict(cpu.state_dict())
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=270), s, b)
    firsts, host_s = [], 0.0

    def first_grads(m):
        m.requires_grad_(True)
        loss, _ = models.loss_fn(m, pipe.batch_at(0), cfg)
        return float(loss.detach()), dict(zip(
            [n for n, _ in m.named_parameters()],
            torch.autograd.grad(loss, list(m.parameters()))))
    for m in (card, cpu):
        t1 = time.perf_counter()
        firsts.append(first_grads(m))
        if m is cpu:
            host_s += time.perf_counter() - t1
    (loss0, grads0), (loss1, grads1) = firsts
    # compared on the card: the host's elementwise passes over a billion
    # weights take tens of seconds
    leaf = {k: _rel(grads0[k], w.to(dev))
            for k, w in grads1.items() if w.abs().max() > 0}
    g_err = max(leaf.values())
    bound = dict.fromkeys(leaf, TRAIN_GRAD_REL)
    first_l = abs(loss0 - loss1) / abs(loss1)
    l_bound = TRAIN_LOSS_REL
    noise_str = ""
    if self_noise:
        # one perturbed copy, drawn on the card, then moved to the host:
        # both sides take the same moved weights
        own, own_l = [], []
        moved = _rounding_perturbed(card, 271)
        for i, where in enumerate((dev, "cpu")):
            t1 = time.perf_counter()
            loss_p, again = first_grads(moved.to(where))
            own.append({k: _rel(again[k].to(dev), firsts[i][1][k].to(dev))
                        for k in leaf})
            own_l.append(abs(loss_p - firsts[i][0]) / abs(firsts[i][0]))
            del again
            if where == "cpu":
                host_s += time.perf_counter() - t1
        del moved
        bound = {k: max(TRAIN_GRAD_REL, TRAIN_NOISE_X * (own[0][k]
                                                         + own[1][k]))
                 for k in leaf}
        if bf16:
            l_bound = max(TRAIN_LOSS_REL, TRAIN_NOISE_X * sum(own_l))
        worst = sorted(leaf, key=lambda k: -leaf[k] / bound[k])[:3]
        noise_str = (f"; with weights moved by one rounding the card's own "
                     f"gradients move by up to {max(own[0].values()):.3g}, "
                     f"the CPU's by {max(own[1].values()):.3g} (the loss "
                     f"{own_l[0]:.3g}, {own_l[1]:.3g}); tightest leaves "
                     + ", ".join(
                         f"{k} {leaf[k]:.3g} (bound {bound[k]:.3g}: card "
                         f"{own[0][k]:.3g}, CPU {own[1][k]:.3g})"
                         for k in worst))
    g_ok = all(leaf[k] <= bound[k] for k in leaf)
    del firsts, grads0, grads1
    losses, opt_cfg = [[], []], AdamWConfig(lr=3e-4)
    reset_counts()
    for m, run in zip((card, cpu), losses) if steps else ():
        t1 = time.perf_counter()
        step, opt = make_train_step(cfg, ExecConfig(), opt_cfg), \
            adamw_init(m, opt_cfg)
        for i in range(steps):
            opt, met = step(m, opt, pipe.batch_at(i))
            run.append(float(met["loss"]))
        if m is cpu:
            host_s += time.perf_counter() - t1
    torch.cuda.synchronize()
    want_n = {k: n * steps for k, n in _train_launches(cfg, 1).items()}
    launched({k: 0 for k in counts()}, **want_n)
    l_err = max([first_l] + [abs(a - c) / abs(c) for a, c in zip(*losses)])

    p_abs, beyond, n, ok = 0.0, 0, 0, True
    for p, q in zip(card.parameters(), cpu.parameters()) if steps else ():
        got, want = p.detach().float(), q.detach().to(dev).float()
        p_abs = max(p_abs, float((got - want).abs().max()))
        beyond += int(((got - want).abs() > 1e-5 + 1e-4 * want.abs()).sum())
        n += want.numel()
        ok &= bool(((got - want).abs()
                    <= TRAIN_PARAM_ATOL + 1e-4 * want.abs()).all())
    params_str = (f"parameters max abs diff {p_abs:.3g} (tol "
                  f"{TRAIN_PARAM_ATOL:g} + 1e-4 |p|), "
                  f"{beyond} of {n} beyond 1e-5 + 1e-4 |p|") if steps \
        else "no step taken"
    print(f"[train card vs cpu] {cfg.name} cut to {layers} layers, "
          f"{dtype}, {b} x {s} tokens, {steps} steps: losses card "
          f"{losses[0]} CPU {losses[1]} (first batch {loss0} / {loss1}; rel "
          f"err {l_err:.3g}, tol {l_bound:.3g}); first batch's gradients "
          f"rel err {g_err:.3g} of a leaf's max (tol {TRAIN_GRAD_REL:g}"
          + (f" or {TRAIN_NOISE_X:g} x the two sides' own noise"
             if self_noise else "") + f"{noise_str}); {params_str}; "
          f"launches on the card "
          + ", ".join(f"{k} {n}" for k, n in want_n.items())
          + f"; {time.perf_counter() - t0:.1f} s, the host's steps "
          f"{host_s:.1f} s")
    assert l_err <= l_bound and g_ok and ok


def _copy_step(src: str, dst: str, step: int) -> None:
    """A checkpoint directory holding only ``src``'s step ``step``."""
    import shutil
    os.makedirs(dst)
    shutil.copytree(os.path.join(src, f"step_{step:06d}"),
                    os.path.join(dst, f"step_{step:06d}"))
    with open(os.path.join(dst, "LATEST"), "w") as f:
        f.write(f"step_{step:06d}")


def _run_driver(args, what: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    lines = [l for l in out.stdout.splitlines() if l.startswith("[train]")]
    for l in lines[-3:]:
        print(f"[train driver] {what}: {l}")
    assert out.returncode == 0, (what, out.returncode, out.stdout[-2000:],
                                 out.stderr[-4000:])
    print(f"[train driver] {what}: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s")
    return out.stdout


def train_driver(steps: int = 60, every: int = 30) -> None:
    """Phase 27 (d): ``python -m repro_torch.launch.train`` at its
    defaults (lm-768x12, seq 256, batch 8) for ``steps`` steps on the
    card, checkpointing every ``every``, recording into a tuner DB: exits
    0 (its own assert: the last loss below the first); a ``--resume``
    from step ``every`` ends on the same parameters and optimizer state
    within 1e-6 (bitwise or not, printed); the DB holds the workload's
    signature."""
    import tempfile
    from repro_torch.core.database import ReferenceDB
    with tempfile.TemporaryDirectory() as tmp:
        a, b, db = (os.path.join(tmp, n) for n in ("a", "b", "db"))
        base = ["--steps", str(steps), "--ckpt-every", str(every),
                "--log-every", "10"]
        out = _run_driver(base + ["--ckpt-dir", a, "--tuner-db", db],
                          "uninterrupted")
        first = re.search(r"loss ([\d.]+) -> ([\d.]+)", out)
        _copy_step(a, b, every)
        _run_driver(base + ["--ckpt-dir", b, "--resume"],
                    f"resumed from step {every}")
        worst, bitwise = 0.0, True
        za = np.load(os.path.join(a, f"step_{steps:06d}", "arrays.npz"))
        zb = np.load(os.path.join(b, f"step_{steps:06d}", "arrays.npz"))
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            x, y = za[key], zb[key]
            bitwise &= np.array_equal(x, y)
            if x.dtype.kind == "f":
                worst = max(worst, float(np.abs(x.astype(np.float64)
                                                - y).max()))
        assert worst <= 1e-6, worst
        rdb = ReferenceDB.load(db)
        (entry,) = rdb.series_for("lm-768x12/train_256x8")
        assert rdb.workloads() == ["lm-768x12/train_256x8"]
        assert entry.series.shape == (512,) and np.isfinite(
            entry.series).all()
        print(f"[train driver] loss {first.group(1)} -> {first.group(2)} "
              f"over {steps} steps; the resumed run's step-{steps} "
              f"parameters and AdamW state "
              f"{'bitwise' if bitwise else 'not bitwise'} the "
              f"uninterrupted run's (max abs diff {worst:.3g}, tol 1e-6); "
              f"the tuner DB holds lm-768x12/train_256x8 with its "
              f"{entry.series.shape[0]}-sample signature")


def train_no_fallback(dev) -> None:
    """Phase 29 (d): a bf16 train step of zamba2-7b's SMOKE config raises
    NotImplementedError naming K10's missing backward, launching no
    kernel (its first layer is Mamba2's); a bf16 sLSTM scan with a
    gradient asked for (xlstm-1p3b's width, 64 steps) raises naming the
    sLSTM scan's, launching nothing.  Neither calls a plain version.
    (minitron-4b's bf16 step, which raised here before K9 bf16 had its
    backward, trains in phase 29 (b).)"""
    from repro_torch import configs, models
    from repro_torch.kernels.slstm import kernel as ks
    from repro_torch.sharding.rules import ExecConfig
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    cfg = dataclasses.replace(configs.smoke_config("zamba2-7b"),
                              param_dtype="bfloat16", dtype="bfloat16")
    m = models.init(cfg, generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    step = make_train_step(cfg, ExecConfig(), AdamWConfig())
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)
    d = configs.get("xlstm-1p3b").d_model
    zifo = torch.zeros((1, 64, 4 * d), dtype=torch.bfloat16, device=dev,
                       requires_grad=True)
    st = [torch.zeros((1, d), device=dev) for _ in range(4)]
    cases = (("zamba2-7b SMOKE train step in bfloat16", "K10 backward",
              lambda: step(m, adamw_init(m, AdamWConfig()),
                           {"tokens": toks, "labels": toks})),
             ("xlstm-1p3b's sLSTM scan in bfloat16 with a gradient",
              "the sLSTM scan backward",
              lambda: ks.slstm_scan(zifo, torch.zeros((4, d), device=dev),
                                    *st)))
    for what, want, call in cases:
        reset_counts()
        with counting_plain() as seen:
            try:
                call()
            except NotImplementedError as e:
                msg = str(e)
            else:
                raise AssertionError(f"{what} ran on the card")
        torch.cuda.synchronize()
        launched({k: 0 for k in counts()})
        assert want in msg and seen["calls"] == 0, (msg, seen)
        print(f"[train no fallback] {what}: NotImplementedError ({msg}); "
              f"no kernel launched, no plain version called")


#: Phase 27 (f): the sharded train step on SHARD_MESH of the one card
#: against the one-device step with microbatch 2 on the same 2 x 4096
#: batch from the same weights.  Loss and ce within SHARD_LOSS_REL
#: relative; each gradient leaf (caught before AdamW) within
#: SHARD_GRAD_REL of its largest element (the same function, its sums
#: split at the data shards instead of the microbatches); parameters
#: after one step at SHARD_LR within tests/test_torch_train_archs.py's
#: rtol / atol, every element.  Peak memory within SHARD_PEAK_GB
#: of the one-device step's (the shards are views).  Stated before the
#: first run.
SHARD_MESH = (2, 4)
SHARD_LR = 1e-3
SHARD_LOSS_REL = 1e-5
SHARD_GRAD_REL = 1e-4
SHARD_RTOL, SHARD_ATOL = 1e-4, 2e-4
SHARD_PEAK_GB = 1.0
#: Phase 27 (f): deepseek-v2's MoE block, forward and backward, mapped
#: by EP against unmapped at MOE_DROPLESS_CF on B x S tokens sized so
#: that the float32 weights (15.3 GB), two sets of their gradients and a
#: run's dispatch buffers (48 T slots of ~86 KB) fit the card.  Every
#: gradient (the input's, each weight's) within SHARD_MOE_GRAD_REL of
#: its largest element: the mapped path sums an expert's weight gradient
#: over its two data shards' slots, the unmapped over one buffer, and
#: combines each token's outputs per shard first.  Stated before the
#: first run.
SHARD_MOE_TOKENS = (2, 1024)
SHARD_MOE_GRAD_REL = 1e-5


class GradCatch:
    """While open, every AdamW update of ``repro_torch.train.step`` (the
    one-device step's and the sharded step's) hands its gradients to
    ``fn(grads)`` first."""

    def __init__(self, fn) -> None:
        self.fn = fn

    def __enter__(self):
        from repro_torch.train import step
        self.step = step
        self.real = real = step.adamw_update

        def update(grads, *args, **kwargs):
            self.fn(grads)
            return real(grads, *args, **kwargs)

        step.adamw_update = update
        return self

    def __exit__(self, *exc) -> None:
        self.step.adamw_update = self.real


def _leaf_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in float32 (one temporary the
    size of a leaf)."""
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def train_sharded(dev, name: str, layers: int = 8, b: int = 2,
                  s: int = 4096, steps: int = 4) -> dict:
    """Phase 27 (f), its first half: minitron-4b (``layers`` layers at
    full width, float32, its ``train_4k`` exec) on SHARD_MESH (``cuda:0``
    eight times), one step of the sharded step and one of the one-device
    step with microbatch 2 from the same weights on the same B x S
    SyntheticCorpus batch (the weights kept on the host between them),
    held to each other (SHARD_*); then ``steps`` steps of each, timed,
    their launches (K9 f32 2 x 2 ``layers``, its backward 2 ``layers``)
    and peak memory, and one sharded step's host syncs.  Returns
    {"launches", "ms", "plain_ms", ...}."""
    from repro_torch import configs, models
    from repro_torch.data import DataPipeline, SyntheticCorpus
    from repro_torch.sharding import make_mesh
    from repro_torch.sharding.rules import make_shard_fn
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    ex = configs.exec_default("minitron-4b", "train_4k")
    cfg = _train_cfg("minitron-4b", layers, ex.remat)
    mesh = make_mesh(SHARD_MESH, ("data", "model"),
                     devices=["cuda:0"] * math.prod(SHARD_MESH))
    ex_one = dataclasses.replace(ex, microbatch=2)
    ex_shd = dataclasses.replace(ex, microbatch=1)
    opt_cfg = AdamWConfig(lr=SHARD_LR)
    one = make_train_step(cfg, ex_one, opt_cfg)
    shd = make_train_step(cfg, ex_shd, opt_cfg, mesh=mesh,
                          shard=make_shard_fn(mesh, ex_shd, b))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = models.init(cfg, generator=torch.Generator(
        device=dev).manual_seed(27), device=dev)
    params = dict(model.named_parameters())
    w0 = {k: p.detach().to("cpu", copy=True) for k, p in params.items()}
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=27), s, b)
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in pipe.batch_at(i).items()}
               for i in range(steps + 1)]
    # the one-device step: its gradients and its parameters after, on
    # the host
    g_one: dict = {}
    with GradCatch(lambda g: g_one.update(
            {k: t.detach().to("cpu", copy=True) for k, t in g.items()})):
        opt, m_one = one(model, adamw_init(model, opt_cfg), batches[0])
    del opt
    p_one = {k: p.detach().to("cpu", copy=True) for k, p in params.items()}
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(w0[k])
    del w0
    # the sharded step from the same weights, held to it
    errs: dict = {}

    def check(grads):
        for k, g in grads.items():
            errs[k] = _leaf_rel(g, g_one[k].to(dev))
    with GradCatch(check):
        opt, m_shd = shd(model, adamw_init(model, opt_cfg), batches[0])
    del opt
    rel = {k: abs(float(m_shd[k]) - float(m_one[k])) / abs(float(m_one[k]))
           for k in ("loss", "ce")}
    assert max(rel.values()) <= SHARD_LOSS_REL, rel
    worst = max(errs, key=errs.get)
    assert errs[worst] <= SHARD_GRAD_REL, (worst, errs[worst])
    p_err = 0.0
    with torch.no_grad():
        for k, p in params.items():
            want = p_one[k].to(dev)
            diff = (p - want).abs()
            p_err = max(p_err, float(diff.max()))
            bad = diff > SHARD_ATOL + SHARD_RTOL * want.abs()
            assert not bool(bad.any()), (k, float(diff.max()))
            del want, diff, bad
    del g_one, p_one
    print(f"[train sharded] minitron-4b, {layers} layers at full width, "
          f"f32, remat {cfg.remat}, on a {SHARD_MESH} (data, model) mesh of "
          f"cuda:0, {b} x {s} tokens (a data shard {b // SHARD_MESH[0]} x "
          f"{s}) against the one-device step with microbatch 2 from the "
          f"same weights (built in {time.perf_counter() - t0:.1f} s): loss "
          f"{float(m_shd['loss']):.7f} / {float(m_one['loss']):.7f}, "
          f"relative {rel['loss']:.3g}, ce {rel['ce']:.3g} (limit "
          f"{SHARD_LOSS_REL:g}); grad norm {float(m_shd['grad_norm']):.7g} "
          f"/ {float(m_one['grad_norm']):.7g}; gradients within "
          f"{errs[worst]:.3g} of a leaf's largest (worst {worst}; limit "
          f"{SHARD_GRAD_REL:g}); parameters after the step within "
          f"{p_err:.3g} (rtol {SHARD_RTOL:g}, atol {SHARD_ATOL:g}, every "
          f"element) [{name}]")
    want = {k: 2 * n for k, n in _train_launches(cfg, 2).items()}
    times: dict = {"one": [], "sharded": []}
    peaks: dict = {"one": 0.0, "sharded": 0.0}
    for key, fn in (("one", one), ("sharded", shd)):
        # each from a fresh optimizer state, one state on the card at a
        # time
        opt = adamw_init(model, opt_cfg)
        for i in range(steps):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            with counting_plain() as seen:
                t1 = time.perf_counter()
                opt, met = fn(model, opt, batches[i + 1])
                torch.cuda.synchronize()
                times[key].append(1e3 * (time.perf_counter() - t1))
            peaks[key] = max(peaks[key],
                             torch.cuda.max_memory_allocated() / 1e9)
            launched({k: 0 for k in counts()}, **want)
            assert seen["calls"] == 0, seen
            assert math.isfinite(float(met["loss"])), met
        if key == "sharded":
            syncs = host_syncs(lambda: shd(model, opt, batches[0]))
        del opt, met
    ms = {k: float(np.median(v)) for k, v in times.items()}
    assert peaks["sharded"] <= peaks["one"] + SHARD_PEAK_GB, peaks
    assert syncs == 0, f"host syncs in a sharded step: {syncs}"
    print(f"[train sharded] minitron-4b: ms a step (median of {steps}) "
          f"sharded {ms['sharded']:.1f} (each "
          + ", ".join(f"{t:.1f}" for t in times["sharded"])
          + f"), one-device microbatch 2 {ms['one']:.1f} (each "
          + ", ".join(f"{t:.1f}" for t in times["one"])
          + f"); {b * s / ms['sharded'] * 1e3:.0f} tokens/s sharded; peak "
          f"memory {peaks['sharded']:.2f} GB sharded, {peaks['one']:.2f} "
          f"GB one-device (limit +{SHARD_PEAK_GB:g}); launches a step on "
          f"both: " + ", ".join(f"{k} {n}" for k, n in want.items())
          + f"; no plain version called; host syncs in a sharded step "
          f"{syncs} [{name}]")
    del model, params, one, shd, batches
    torch.cuda.empty_cache()
    return {"launches": want, "ms": ms["sharded"], "plain_ms": ms["one"],
            "peak_gb": peaks}


def moe_block_backward(dev, name: str) -> dict:
    """Phase 27 (f), its second half: deepseek-v2's MoE block at full
    width in float32 (random weights), forward and backward of ``sum(out
    * cot)`` on SHARD_MOE_TOKENS: unmapped, then mapped over SHARD_MESH
    by EP, twice, at MOE_DROPLESS_CF.  Every gradient within
    SHARD_MOE_GRAD_REL of the unmapped one's largest element, no drop on
    either path (``DispatchSpy``), the two mapped runs bitwise equal;
    each path's ms (CUDA events, a forward and a backward) and the
    memory it allocates above the weights at its peak."""
    from repro_torch import configs
    from repro_torch.models import moe
    cfg = dataclasses.replace(configs.get("deepseek-v2-236b"),
                              param_dtype="float32", dtype="float32",
                              capacity_factor=MOE_DROPLESS_CF)
    mesh = moe_mesh()
    gen = torch.Generator(device=dev).manual_seed(275)
    mod = moe.MoE(cfg, generator=gen, device=dev).requires_grad_(True)
    names = [n for n, _ in mod.named_parameters()]
    b, s = SHARD_MOE_TOKENS
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    cot = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)

    def run(mapped: bool):
        xr = x.detach().requires_grad_(True)
        out, aux = moe.moe_apply(mod, xr, cfg,
                                 mesh=mesh if mapped else None)
        grads = torch.autograd.grad(
            torch.sum(out * cot), [xr] + [mod.get_parameter(n)
                                          for n in names])
        return out.detach(), aux.detach(), dict(zip(["x"] + names, grads))

    with DispatchSpy() as plain_spy:
        want_out, want_aux, want = run(False)
    with DispatchSpy() as spy:
        out, aux, got = run(True)
    drops = (spy.drops(), plain_spy.drops())
    assert drops == (0, 0), drops
    errs = {k: _leaf_rel(got[k], want[k]) for k in want}
    out_rel = _leaf_rel(out, want_out)
    del want, want_out
    _, _, again = run(True)
    bitwise = all(torch.equal(got[k], again[k]) for k in got)
    assert bitwise, "mapped MoE backward not deterministic"
    worst = max(errs, key=errs.get)
    assert errs[worst] <= SHARD_MOE_GRAD_REL, (worst, errs[worst])
    del got, again
    t_plain = cuda_ms(lambda: run(False), 2)
    t_map = cuda_ms(lambda: run(True), 2)
    mem_plain = _peak_extra(lambda: run(False))
    mem_map = _peak_extra(lambda: run(True))
    weights = sum(p.numel() * p.element_size() for p in mod.parameters())
    print(f"[train sharded] deepseek-v2-236b MoE block at full width, f32 "
          f"({weights / 1e9:.2f} GB of weights), forward and backward on "
          f"{b} x {s} tokens, EP on a {SHARD_MESH} mesh of cuda:0 against "
          f"unmapped at capacity factor {MOE_DROPLESS_CF:g}: drops mapped / "
          f"unmapped {drops[0]} / {drops[1]}; aux {float(aux):.7g} / "
          f"{float(want_aux):.7g}; out within {out_rel:.3g} of max |out|; "
          f"gradients within {errs[worst]:.3g} of a leaf's largest (worst "
          f"{worst}; x {errs['x']:.3g}, router {errs['router.w']:.3g}; limit "
          f"{SHARD_MOE_GRAD_REL:g}); two mapped runs bitwise; {t_map:.2f} "
          f"ms mapped, {t_plain:.2f} unmapped (CUDA events, forward and "
          f"backward); memory above the weights at the peak {mem_map:.2f} "
          f"GB mapped, {mem_plain:.2f} unmapped [{name}]")
    del mod, x, cot
    torch.cuda.empty_cache()
    return {"ms": t_map, "plain_ms": t_plain, "mem_gb": mem_map,
            "plain_mem_gb": mem_plain, "grad_rel": errs[worst]}


def train_driver_xlstm(steps: int = 10) -> None:
    """Phase 27 (d) for xlstm-1p3b: ``python -m repro_torch.launch.train
    --arch xlstm-1p3b --smoke --steps 10`` on the card exits 0 (its own
    assert: the last loss below the first), every loss it prints
    finite."""
    out = _run_driver(["--arch", "xlstm-1p3b", "--smoke", "--steps",
                       str(steps), "--log-every", "1"], "xlstm-1p3b SMOKE")
    losses = [float(x) for x in re.findall(r"step +\d+ loss (\S+)", out)]
    assert len(losses) == steps and all(map(math.isfinite, losses)), losses
    print(f"[train driver] xlstm-1p3b SMOKE on the card: {steps} finite "
          f"losses, {losses[0]:.4f} -> {losses[-1]:.4f}")


#: The sharded step's path in the kernel table's launch counts.
SHARDED_PATH = "minitron-4b sharded train step (8 layers, (2, 4) mesh, " \
    "2 x 4096)"


def train_phase(dev, errs: ErrLog, name: str):
    """Phase 27: (a) K9 f32's backward kernels (dh <= 128 and MLA's head),
    K10 f32's and the sLSTM scan's, (b) minitron-4b, zamba2-7b,
    deepseek-v2 and xlstm-1p3b trained at full width, (c) the card
    against the CPU, (d) the train driver, (f) sharded training ((e),
    no fallback, moved to phase 29 (d) with bf16 training).  Returns the
    four backward kernels' table rows, the forward kernels' launches on
    the sharded step ({key: {path: n}}), the minitron-4b steps'
    measurements phase 28 reads ({"1 x 4096": (launches, ms, peak GB),
    "microbatch=2": ...}) and (b)'s float32 steps by arch, which phase
    29 prints its bf16 steps beside."""
    t0 = time.perf_counter()
    times = check_k9_bwd(dev, errs, name)
    mla = check_k9_mla_bwd(dev, errs, name)
    gla = check_k10_bwd(dev, errs, name)
    slstm = check_slstm_bwd(dev, errs, name)
    print(f"[train] phase 27 (a) in {time.perf_counter() - t0:.1f} s")
    # (b) at 3 steps (was 4): phase 29's bf16 training fits the script's
    # time
    full = {arch: train_full(dev, name, arch, layers, steps=3)
            for arch, layers in (("minitron-4b", 8), ("zamba2-7b", 12),
                                 ("deepseek-v2-236b", 1), ("xlstm-1p3b", 8))}
    train_card_vs_cpu(dev, name)
    train_card_vs_cpu(dev, name, layers=6, b=1, s=512, steps=1,
                      arch="zamba2-7b")
    train_card_vs_cpu(dev, name, layers=1, b=1, s=128, steps=1,
                      arch="deepseek-v2-236b")
    train_card_vs_cpu(dev, name, layers=8, b=1, s=512, steps=1,
                      arch="xlstm-1p3b", self_noise=True)
    train_driver()
    train_driver_xlstm()
    t1 = time.perf_counter()
    sharded = train_sharded(dev, name)
    moe_block_backward(dev, name)
    print(f"[train] phase 27 (f) in {time.perf_counter() - t1:.1f} s")
    paths = {"minitron-4b": "minitron-4b train step (8 layers)",
             "zamba2-7b": "zamba2-7b train step (12 layers)",
             "deepseek-v2-236b": "deepseek-v2 train step (1 dense layer)",
             "xlstm-1p3b": "xlstm-1p3b train step (8 layers)"}
    rows = []
    for key, count, (ms, plain_ms, lib_ms, bounds), main in (
            ("K9-f32-bwd", "K9_f32_bwd", times["minitron-4b layer"],
             "minitron-4b"),
            ("K9-f32-mla-bwd", "K9_f32_mla_bwd", mla, "deepseek-v2-236b"),
            ("K10-f32-bwd", "K10_f32_bwd", gla, "zamba2-7b"),
            ("sLSTM-bwd", "sLSTM_bwd", slstm, "xlstm-1p3b")):
        row = _row(key, full[main]["launches"][count], errs, ms, plain_ms,
                   bounds, lib_ms)
        row["model_launches"] = {paths[a]: f["launches"][count]
                                 for a, f in full.items()
                                 if count in f["launches"]}
        if count in sharded["launches"]:
            row["model_launches"][SHARDED_PATH] = \
                sharded["launches"][count]
        rows.append(row)
    print(f"[train] phase 27 in {time.perf_counter() - t0:.1f} s")
    mini = full["minitron-4b"]
    measured = {"1 x 4096": (mini["launches"], mini["ms"], mini["peak_gb"]),
                "microbatch=2": (sharded["launches"], sharded["plain_ms"],
                                 sharded["peak_gb"]["one"])}
    return rows, {"K9-f32": {SHARDED_PATH: sharded["launches"]["K9_f32"]}}, \
        measured, full


# ---------------------------------------------------------------------------
# phase 28: the dry-run against phase 27
# ---------------------------------------------------------------------------

def dryrun_phase(name: str, measured: dict) -> None:
    """Phase 28: minitron-4b's phase-27 train step walked on ``meta`` by
    ``launch.dryrun`` on a 1 x 1 mesh (8 of 32 layers, float32, its
    ``train_4k`` exec, remat "full"), at 1 x 4096 and at microbatch 2 on
    2 x 4096.  The walk's K9 and K9_bwd op counts must equal the K9 f32
    forward and backward launches phase 27 counted on the card for the
    same step (``measured``: {label: (launches, ms, peak GB)}); its
    largest roofline term and its argument + temp bytes are printed
    against the measured ms a step and peak, as ratios."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.sharding import make_mesh
    t0 = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"), devices=["meta"])
    ex = configs.exec_default("minitron-4b", "train_4k")
    cfg = _train_cfg("minitron-4b", 8, ex.remat)
    for label, micro, b in (("1 x 4096", 1, 1), ("microbatch=2", 2, 2)):
        launches, ms, peak_gb = measured[label]
        exm = dataclasses.replace(ex, microbatch=micro)
        spec = configs.ShapeSpec("train_4k", 4096, b, "train")
        fn, args, meta, walker = dryrun.build_cell(
            "minitron-4b", spec, mesh, exm, cfg=cfg)
        rec = dryrun.walk_cell(fn, args, meta, walker, exm)
        walked = rec["walk"]["kernels"]
        want = {"K9": launches["K9_f32"], "K9_bwd": launches["K9_f32_bwd"]}
        assert walked == want, (label, walked, want)
        rf = rec["roofline"]
        terms = rf["terms_seconds"]
        top = rf["dominant"]
        mem = rec["memory_analysis"]
        walk_gb = (mem["argument_size_in_bytes"]
                   + mem["temp_size_in_bytes"]) / 1e9
        print(f"[dryrun] minitron-4b 8 layers, {b} x 4096, microbatch "
              f"{micro}: walk K9 {walked['K9']} / K9_bwd "
              f"{walked['K9_bwd']} ops = phase 27's launches; terms "
              + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in terms.items())
              + f"; largest ({top}) {1e3 * terms[top]:.1f} ms against "
              f"{ms:.1f} ms measured, ratio {1e3 * terms[top] / ms:.3f}; "
              f"argument {mem['argument_size_in_bytes'] / 1e9:.2f} + temp "
              f"{mem['temp_size_in_bytes'] / 1e9:.2f} = {walk_gb:.2f} GB "
              f"against a {peak_gb:.2f} GB peak, ratio "
              f"{walk_gb / peak_gb:.3f}; {rec['walk']['ops']} ops [{name}]")
    print(f"[dryrun] phase 28 in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 29: bfloat16 training on the card
# ---------------------------------------------------------------------------

#: Phase 29 (a): K9 bf16's backward (``flash_bf16_bwd.cu`` at dh, dv <= 128,
#: ``flash_bf16_bwd_mla.cu`` at MLA's head) against ``flash_backward_plain``
#: on the same inputs (the bf16 forward's own o and lse): every element of
#: dq, dk and dv within one bf16 rounding of the plain element
#: (``_bf16_step``: both sides round a float32 sum once, so a sum near a
#: rounding boundary may land on either neighbour) plus K9_BF16_BWD_REL of
#: the gradient's max |plain| (the kernel's float32 sums in another order,
#: P and dS in two bf16 parts, ~2^-17 of each).  Stated before the first
#: run.
K9_BF16_BWD_REL = 1e-4
#: The bf16 forward's lse against the plain version's, absolute (|lse| up
#: to ~12 at S = 4096: a float32 step there is ~1e-6; the scores are exact
#: bf16 products summed in float32).  Stated before the first run.
K9_BF16_LSE_TOL = 1e-5
#: (a)'s shapes: (what, B, H, KV, S, T, dh, dv, causal, unaligned, the
#: wrappers' tile); the first six (the training layers) timed.
K9_BF16_BWD_CASES = (
    ("minitron-4b layer", 1, 24, 8, 4096, 4096, 128, 128, True, False, 64),
    ("deepseek-v2 MLA layer", 1, 128, 128, 4096, 4096, 192, 128, True,
     False, 64),
    ("phi3-mini layer (dh 96)", 1, 32, 32, 4096, 4096, 96, 96, True, False,
     64),
    ("zamba2-7b shared attention (dh 112)", 1, 32, 32, 4096, 4096, 112,
     112, True, False, 64),
    ("lm-768x12 layer (dh 64)", 8, 12, 6, 256, 256, 64, 64, True, False, 64),
    ("kimi-k2 MLA layer (64 heads)", 1, 64, 64, 4096, 4096, 192, 128, True,
     False, 64),
    ("S 128 < T 256", 1, 4, 2, 128, 256, 64, 64, True, False, 64),
    ("S 256 > T 128", 1, 4, 2, 256, 128, 128, 64, True, False, 64),
    ("non-causal, dv 32 < dh", 2, 4, 1, 128, 192, 64, 32, False, False, 64),
    ("dh 18 / dv 10, element-wise loads", 1, 2, 1, 128, 128, 18, 10, True,
     False, 64),
    ("one element into storage", 1, 4, 2, 128, 128, 64, 64, True, True, 64),
    ("MLA, S = T = 328, not whole 64-row tiles", 1, 4, 2, 328, 328, 192,
     128, True, False, 8),
    ("MLA, dh 130 / dv 66, element-wise loads", 1, 2, 1, 128, 128, 130, 66,
     True, False, 64),
    ("MLA, one element into storage", 1, 4, 2, 128, 128, 192, 128, True,
     True, 64),
)


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """One bf16 rounding at each element of x: the spacing of bfloat16 at
    |x| (2^(e - 8) for |x| in [2^(e-1), 2^e)), 0 at 0."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8) * (
        x != 0)


def k9_bf16_bwd_bound(name: str, b, h, kv, s, t, dh, dv, causal=True):
    """(bytes ms, operations ms, operations ms with P and dS in two parts)
    of K9 bf16's backward: q, k, v, o, do read and dq, dk, dv written once
    in bf16, the lse in float32, at the card's memory rate; the least work,
    2 (3 dh + 2 dv) FLOPs a query-key pair under the mask, at the dense
    bf16 tensor-core peak (the row's bound), and 2 (5 dh + 3 dv) a pair,
    dV, dK and dQ each taken as two bf16 products (printed beside)."""
    from repro_torch.kernels.attention.kernel import causal_pairs
    mem, _, bf16, _ = card_peaks(name)
    nbytes = 2 * (2 * b * h * s * (dh + dv) + 2 * b * kv * t * (dh + dv)) \
        + 4 * b * h * s
    pairs = b * h * causal_pairs(s, t, causal)
    return (nbytes / mem * 1e3, 2 * (3 * dh + 2 * dv) * pairs / bf16 * 1e3,
            2 * (5 * dh + 3 * dv) * pairs / bf16 * 1e3)


def k9_bf16_bwd_case(dev, errs: ErrLog, what: str, b, h, kv, s, t, dh, dv,
                     causal: bool, unaligned: bool, tile: int, seed: int):
    """One shape of (a): o bitwise with and without the lse, the lse
    within K9_BF16_LSE_TOL of the plain version's, each gradient element
    within one bf16 rounding of the plain element plus K9_BF16_BWD_REL of
    the gradient's max |plain|, two backward launches bitwise.  Returns
    (q, k, v, o, do, lse) for timing."""
    from repro_torch.kernels.attention import kernel as k9
    key = "K9-bf16-mla-bwd" if dh > k9.MAX_BWD_D else "K9-bf16-bwd"
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = _attn_inputs(gen, dev, b, h, kv, s, t, dh, dv, torch.bfloat16)
    do = torch.randn((b, h, s, dv), generator=gen, device=dev).bfloat16()
    if unaligned:
        q, k, v, do = (_at_offset(x) for x in (q, k, v, do))
    reset_counts()
    o0, none = k9._launch_forward(q, k, v, causal, with_lse=False)
    o, lse = k9._launch_forward(q, k, v, causal, with_lse=True)
    grads = k9.flash_backward(q, k, v, o, do, lse, tile, tile, causal)
    again = k9.flash_backward(q, k, v, o, do, lse, tile, tile, causal)
    torch.cuda.synchronize()
    launched({k: 0 for k in counts()}, K9=2, **{key.replace("-", "_"): 2})
    assert none is None and torch.equal(o0, o), \
        f"{what}: o with the lse is not bitwise o without it"
    assert all(torch.equal(x, y) for x, y in zip(grads, again)), \
        f"{what}: two backward launches differ"
    _, lse_p = k9.flash_forward_plain(q, k, v, tile, tile, causal,
                                      with_lse=True)
    e_lse = float((lse - lse_p).abs().max())
    plain = k9.flash_backward_plain(q, k, v, o, do, lse, tile, tile, causal)
    worst = []
    for x, y in zip(grads, plain):
        errs.diff(key, x, y)
        assert torch.isfinite(x).all()
        tol = _bf16_step(y) + K9_BF16_BWD_REL * y.float().abs().max()
        worst.append(float(((x.float() - y.float()).abs() / tol).max()))
    rel = [_rel(x, y) for x, y in zip(grads, plain)]
    assert e_lse <= K9_BF16_LSE_TOL, \
        f"{what}: lse err {e_lse} > {K9_BF16_LSE_TOL}"
    assert max(worst) <= 1.0, \
        f"{what}: dq, dk, dv at {worst} of one bf16 rounding + " \
        f"{K9_BF16_BWD_REL:g} max |plain|"
    print(f"[K9 bf16 bwd] {what} (B {b}, H {h}, KV {kv}, S {s}, T {t}, dh "
          f"{dh}, dv {dv}{', causal' if causal else ''}): dq, dk, dv at "
          + ", ".join(f"{w:.3f}" for w in worst) + f" of one bf16 rounding "
          f"+ {K9_BF16_BWD_REL:g} max |plain| (rel err " + ", ".join(
              f"{r:.3g}" for r in rel) + f"); lse max abs err {e_lse:.3g} "
          f"(tol {K9_BF16_LSE_TOL:g}); o bitwise with and without the lse; "
          f"two backward launches bitwise")
    return q, k, v, o, do, lse


def ptxas_logs(libs) -> dict:
    """{library name: its build log with ``ptxas -v``'s lines}: the log of
    this process's build where there was one, else that of a build of the
    same source with the same flags into a scratch folder of the build
    directory (one ``nvcc`` a library, all started together), so that a
    library loaded from the build cache is never checked on an empty
    log."""
    import shutil
    import tempfile
    from repro_torch.kernels import common
    out = {lib.name: lib.build_log for lib in libs if lib.build_log}
    todo = [lib for lib in libs if lib.name not in out]
    if not todo:
        return out
    os.makedirs(common.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=common.BUILD_DIR)
    try:
        procs = [(lib, subprocess.Popen(
            [common._nvcc(), *common.NVCC_FLAGS, "-o",
             os.path.join(tmp, f"{lib.name}.so"), lib.source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for lib in todo]
        for lib, p in procs:
            out[lib.name] = p.communicate()[0]
            assert p.returncode == 0, \
                f"nvcc failed for {lib.source}: {out[lib.name]}"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def ptxas_kernels(log: str) -> dict:
    """{kernel: (registers, spill stores, spill loads)} from the ``ptxas
    -v`` lines of a build log."""
    out, kern, spill = {}, None, (None, None)
    for line in log.splitlines():
        m = re.search(r"entry function '(.*?)'", line)
        if m:
            kern = kernel_name(m.group(1))
        elif "spill stores" in line:
            spill = tuple(int(x) for x in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
        elif "Used" in line and "registers" in line and kern:
            out[kern] = (int(re.search(r"Used (\d+) registers",
                                       line).group(1)), *spill)
    return out


def sass_spills_by_side(lib, kernel: str) -> dict:
    """{instantiation: (before, consumers, producer)}: the local-memory
    loads and stores (LDL, STL) of a warp-specialized kernel's SASS before
    the consumers' register raise (USETMAXREG.TRY_ALLOC), from it to the
    producer's lowering (USETMAXREG.DEALLOC) and after, in address order
    (ptxas lays the consumers' code out before the producer's)."""
    out = {}
    for name, ins in sass_functions(lib, kernel).items():
        side, n = 0, [0, 0, 0]
        for _, text in ins:
            op = _opcode(text)
            if op.startswith("USETMAXREG.TRY_ALLOC"):
                side = max(side, 1)
            elif op.startswith("USETMAXREG.DEALLOC"):
                side = 2
            elif op.startswith(("LDL", "STL")):
                n[side] += 1
        out[name] = tuple(n)
    return out


#: K9 bf16 backward's three kernels, in launch order.
K9_BF16_BWD_KERNELS = ("flash_bf16_bwd_dot_kernel",
                       "flash_bf16_bwd_dkdv_kernel",
                       "flash_bf16_bwd_dq_kernel")


def check_k9_bf16_bwd(dev, errs: ErrLog, name: str) -> dict:
    """Phase 29 (a): both warp-specialized kernels' SASS holds HGMMA (the
    products on the tensor cores) and UTMALDG (the producer's TMA loads)
    at every instantiation, and ptxas serialized none of their wgmma
    pipelines; each kernel's registers, spills (and the local loads and
    stores on the consumers' and the producer's side of the register
    hand-over) printed; every K9_BF16_BWD_CASES shape held as
    ``k9_bf16_bwd_case`` holds it; the first six timed beside the plain
    version, SDPA's bf16 backward and the bound, the first two also
    kernel by kernel on the device.  Returns {what: (ms, plain ms,
    library ms, (bytes ms, operations ms))}."""
    from repro_torch.kernels.attention import kernel as k9
    libs = (k9.BF16_BWD_LIB, k9.BF16_BWD_MLA_LIB)
    logs = ptxas_logs(libs)
    for lib in libs:
        regs = ptxas_kernels(logs[lib.name])
        for kern in K9_BF16_BWD_KERNELS[1:]:
            ops = sass_ops(lib, kern, ("HGMMA", "UTMALDG"))
            assert ops and all(
                not o.endswith(" 0 HGMMA") and " 0 UTMALDG" not in o
                for o in ops.values()), \
                f"no HGMMA or no UTMALDG in {kern}'s SASS: {ops}"
            sides = sass_spills_by_side(lib, kern)
            for inst, op in ops.items():
                r = regs.get(inst)
                assert r, f"no ptxas -v line for {inst} in {lib.name}'s log"
                print(f"[K9 bf16 bwd] {lib.name} {inst}: {op}; {r[0]} "
                      f"registers at launch, {r[1]} bytes spill stores, "
                      f"{r[2]} bytes spill loads; local loads and stores "
                      "before / on the consumers' side / on the producer's "
                      "side of the hand-over " + " / ".join(
                          str(x) for x in sides.get(inst, ())))
        serial = [line.strip() for line in logs[lib.name].splitlines()
                  if "serialized" in line]
        assert not serial, f"ptxas serialized wgmma in {lib.name}: {serial}"
    times = {}
    for i, case in enumerate(K9_BF16_BWD_CASES):
        what, b, h, kv, s, t, dh, dv, causal, unaligned, tile = case
        q, k, v, o, do, lse = k9_bf16_bwd_case(dev, errs, *case,
                                               seed=2900 + i)
        if i < 6:
            args = (q, k, v, o, do, lse, 64, 64, causal)
            ms = cuda_ms(lambda: k9.flash_backward(*args), 3)
            plain_ms = cuda_ms(lambda: k9.flash_backward_plain(*args), 1)
            lib_ms = _sdpa_bwd_ms(q, k, v, do)
            *bounds, parts_ms = k9_bf16_bwd_bound(name, b, h, kv, s, t, dh,
                                                  dv, causal)
            fwd_ms = cuda_ms(lambda: k9._launch_forward(
                q, k, v, causal, with_lse=True), 3)
            times[what] = (ms, plain_ms, lib_ms, tuple(bounds))
            print(f"[K9 bf16 bwd] {what}: {ms:.3f} ms a launch (plain "
                  f"{plain_ms:.1f} ms, SDPA's bf16 backward {lib_ms:.3f} ms, "
                  f"bound {max(bounds):.3f} ms by "
                  f"{'bytes' if bounds[0] >= bounds[1] else 'operations'}: "
                  f"bytes {bounds[0]:.3f}, bf16 operations {bounds[1]:.3f}, "
                  f"with P and dS in two parts {parts_ms:.3f}; the bf16 "
                  f"forward with the lse {fwd_ms:.3f} ms, SDPA's bf16 "
                  f"forward {cuda_ms(lambda: _sdpa(q, k, v), 3):.3f} ms) "
                  f"[{name}]")
            if i < 2:
                per = [(kern, device_ms(lambda: k9.flash_backward(*args), 3,
                                        kern)) for kern in K9_BF16_BWD_KERNELS]
                print(f"[K9 bf16 bwd] {what}, device time a launch: "
                      + ", ".join(f"{kern} {_dev_str(d)}" for kern, d in per)
                      + f" [{name}]")
            del args
        del q, k, v, o, do, lse
        torch.cuda.empty_cache()
    return times


def bf16_train_phase(dev, errs: ErrLog, name: str, f32_full: dict):
    """Phase 29: (a) K9 bf16's backward kernels against their plain
    versions and timed, (b) minitron-4b (8 layers) and deepseek-v2 (its
    dense layer) trained 3 bf16 steps at full width beside phase 27's
    float32 steps (``f32_full``), (c) both against the CPU in bf16, (d)
    what still raises.  Returns the two kernels' table rows and the bf16
    forwards' launches on the two steps ({key: {path: n}})."""
    t0 = time.perf_counter()
    times = check_k9_bf16_bwd(dev, errs, name)
    print(f"[train bf16] phase 29 (a) in {time.perf_counter() - t0:.1f} s")
    full = {arch: train_full(dev, name, arch, layers, steps=3,
                             dtype="bfloat16")
            for arch, layers in (("minitron-4b", 8), ("deepseek-v2-236b", 1))}
    for arch, got in full.items():
        f32 = f32_full[arch]
        print(f"[train bf16] {arch}: bf16 {got['ms']:.1f} ms a step, "
              f"{got['tokens_s']:.0f} tokens/s, peak {got['peak_gb']:.2f} "
              f"GB against phase 27's float32 step at the same depth "
              f"{f32['ms']:.1f} ms, {f32['tokens_s']:.0f} tokens/s, peak "
              f"{f32['peak_gb']:.2f} GB [{name}]")
    t1 = time.perf_counter()
    # the first batch's loss and gradients only: a step's host AdamW over
    # the 1.4-1.8 B host weights would not fit the script's time
    train_card_vs_cpu(dev, name, layers=2, b=1, s=512, steps=0,
                      arch="minitron-4b", self_noise=True, dtype="bfloat16")
    train_card_vs_cpu(dev, name, layers=1, b=1, s=128, steps=0,
                      arch="deepseek-v2-236b", self_noise=True,
                      dtype="bfloat16")
    print(f"[train bf16] phase 29 (c) in {time.perf_counter() - t1:.1f} s")
    train_no_fallback(dev)
    paths = {"minitron-4b": "minitron-4b bf16 train step (8 layers)",
             "deepseek-v2-236b": "deepseek-v2 bf16 train step (1 dense "
                                 "layer)"}
    rows = []
    for key, count, what, main in (
            ("K9-bf16-bwd", "K9_bf16_bwd", "minitron-4b layer",
             "minitron-4b"),
            ("K9-bf16-mla-bwd", "K9_bf16_mla_bwd", "deepseek-v2 MLA layer",
             "deepseek-v2-236b")):
        ms, plain_ms, lib_ms, bounds = times[what]
        row = _row(key, full[main]["launches"][count], errs, ms, plain_ms,
                   bounds, lib_ms)
        row["model_launches"] = {paths[main]: full[main]["launches"][count]}
        rows.append(row)
    # the bf16 forwards' launches on the two steps, by table row
    fwd_paths = {key: {paths[a]: full[a]["launches"]["K9"]} for key, a in (
        ("K9", "minitron-4b"), ("K9-mla", "deepseek-v2-236b"))}
    print(f"[train bf16] phase 29 in {time.perf_counter() - t0:.1f} s")
    return rows, fwd_paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import attention, common, gla, iir, slstm
    from repro_torch.kernels.dtw import matrix, score, stream
    name = card_line()
    print(f"[card] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    libs = [stream.LIB, score.LIB, matrix.LIB, iir.kernel.LIB,
            attention.kernel.LIB, attention.kernel.BF16_LIB,
            attention.kernel.BWD_LIB, attention.kernel.BWD_MLA_LIB,
            attention.kernel.BF16_BWD_LIB, attention.kernel.BF16_BWD_MLA_LIB,
            gla.kernel.LIB, gla.kernel.BWD_LIB, slstm.kernel.LIB,
            slstm.kernel.BWD_LIB]
    common.build(libs)
    print(f"[build] {len(libs)} kernel sources in "
          f"{time.perf_counter() - t0:.1f} s")
    build_report(libs)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = ErrLog()
    for check in (check_k1, check_k2, check_k4, check_k56, check_k3,
                  check_k7, check_k2_pairs):
        check(dev, errs)
    bank = paper_bank()
    point = paper_scenario(dev, bank)
    for mode in ("exact", "approx"):
        paper_scenario(dev, bank, mode, point)
    paper_degraded(dev, bank, point)
    rows, runs = {}, {}
    for mode in ("point", "exact", "approx", "distance"):
        mode_rows, runs[mode] = full_width(dev, errs, name, mode)
        for row in mode_rows:
            # K5 serves both probabilistic runs' verdicts: its row is the
            # exact run's
            rows.setdefault(row["name"], row)
    # the distance-only run streamed the point run's queries: the same
    # DP rows (K3's against K1's, bitwise) and the same verdicts
    assert torch.equal(runs["distance"]["rows"], runs["point"]["rows"])
    assert runs["distance"]["verdicts"] == runs["point"]["verdicts"]
    print("[full distance] DP rows before the verdict and all 32 verdicts "
          "bitwise the point run's")
    ladder(dev, name, runs["exact"],
           {key: rows[KERNELS[key][0]]["ms"]
            for key in ("K4-exact", "K4-approx", "K1", "K3")})
    chaos_phase(dev, bank, point)
    multitenant_phase(dev, bank)
    for row in (paper_matching(dev, errs, name),
                full_matching(dev, errs, name)):
        rows[row["name"]] = row
    for check, full in ((check_k8, full_iir), (check_k9, full_attention),
                        (check_k10, full_gla)):
        check(dev, errs)
        out = full(dev, errs, name)
        for row in out if isinstance(out, list) else [out]:
            rows[row["name"]] = row
    prefilter_paper(dev)
    row, record = prefilter_full(dev, errs, name)
    rows[row["name"]] = row
    recovery_full(dev, name, record)
    recovery_kill()
    sharding_phase(dev, errs, name, runs, record,
                   rows[KERNELS["K1"][0]]["ms"])
    for key, paths in model_phase(dev, errs, name).items():
        row = rows[KERNELS[key][0]]
        row["model_launches"] = paths
    mla_rows, mla_paths = moe_phase(dev, errs, name)
    for row in mla_rows:
        rows[row["name"]] = row
    for key, paths in mla_paths.items():
        rows[KERNELS[key][0]].setdefault("model_launches", {}).update(paths)
    xl_rows, xl_paths = xlstm_phase(dev, errs, name)
    for row in xl_rows:
        rows[row["name"]] = row
    for key, paths in xl_paths.items():
        rows[KERNELS[key][0]].setdefault("model_launches", {}).update(paths)
    rows[KERNELS["K2"][0]].setdefault("model_launches", {}).update(
        signature_phase(dev, errs, name))
    train_rows, train_paths, measured, f32_full = train_phase(dev, errs, name)
    dryrun_phase(name, measured)
    bf16_rows, bf16_paths = bf16_train_phase(dev, errs, name, f32_full)
    for row in train_rows + bf16_rows:
        rows[row["name"]] = row
    for key in ("K9", "K9-f32"):
        # the serving phases assert these counts; phase 27 changed no
        # forward launch of theirs
        print(f"[train] {key} forward launches on the serving paths, as "
              f"before: {rows[KERNELS[key][0]]['model_launches']}")
    for key, paths in train_paths.items():
        rows[KERNELS[key][0]].setdefault("model_launches", {}).update(paths)
    for key, paths in bf16_paths.items():
        rows[KERNELS[key][0]].setdefault("model_launches", {}).update(paths)
    for key in ("K2", "K9", "K9-f32", "K9-mla", "K9-f32-mla", "K9-f32-bwd",
                "K9-f32-mla-bwd", "K9-bf16-bwd", "K9-bf16-mla-bwd", "K10",
                "K10-mlstm", "K10-f32-bwd", "sLSTM", "sLSTM-bwd"):
        rows[KERNELS[key][0]]["max_abs_err"] = errs.err[key]
    table = [rows[KERNELS[key][0]] for key in KERNELS]
    print(json.dumps({"kernels": table}))
    print(name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
