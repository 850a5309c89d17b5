#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # all phases, one card
    python3 chip_smoke.py --phases 1,6,7  # a subset (no result lines)
    python3 chip_smoke.py --phases 3,16,18,19,20  # the gpt options
    python3 chip_smoke.py --phases 21,22,23  # the reference's workloads
    python3 chip_smoke.py --phases 1,7,24,25,26  # the north-star zoo
    python3 chip_smoke.py --phases 1,7,27,28,29  # model and pipeline modes
    python3 chip_smoke.py --phases 1,2,7,30  # moe
    python3 chip_smoke.py --phases 1,7,31  # sharded state
    python3 chip_smoke.py --phases 1,6,7,32  # compressed collectives, ring
    python3 chip_smoke.py --phases 1,7,33,34  # pipeline grid, resilience
    python3 chip_smoke.py --phases 1,35  # serving resilience and the fleet
    python3 chip_smoke.py --phases 1,36,37  # disaggregation, observability
    python3 chip_smoke.py --phases 1,38,39,40  # remat, tuning, resharding
    python3 chip_smoke.py --phases 1,41  # the scripts and examples
    python3 chip_smoke.py --phases 1,2,3 --waves 4  # another split rule

Phases, in order; any failure raises and exits non-zero:

1. device: the card's name and power limit as ``nvidia-smi`` reports them;
   no visible CUDA card is a failure;
2. build: compile the kernels from the sources in the checkout, one
   ``nvcc`` per source, all started together; prints the paged
   flash-decode library's build time and ``ptxas`` register report;
3. kernel vs plain: ``paged_flash_decode`` against ``paged_decode_reference``
   on the card at the serving path's decode shape, plus GQA, bf16, int8,
   ``valid_pool`` holes, an empty slot, a slot ending on a split boundary,
   a slot shorter than one split beside long ones, two full-length slots
   (``f32_long``, the few-slots case split-K is for), phase 15's shape
   (``bf16_serve``: bf16 queries and pools, 128 blocks a slot, 2-24 live
   positions, the split count that shape gives), a sliding window of 256
   at the 8-slot shape (``window``, phase 20's) and int8 pools quantized
   by the engines' rule at phase 18's shape (``int8_serve``); median times
   of the kernel, the plain version and ``scaled_dot_product_attention``
   on pre-gathered K/V (a yardstick the port never calls), beside the
   bytes bound, at the 8-slot shape, at ``f32_long`` and ``window``; the
   kernel's
   device time with no host cost in it at both, and the host's cost of
   one wrapper call at the 8-slot shape;
4. the serving slice at full width (GPT-2-small shape, vocab 32768): the
   paged engine serves a seeded Poisson load with a shared prefix, its
   decode tick captured once in a CUDA graph and replayed; checks errors,
   token budgets and ranges, prefix hits, one capture, finite outputs and
   that every decode tick launched the kernel once per layer; prints the
   mean tick time;
5. the same trace with the decode attention switched to the plain
   version: first tokens must agree, and the overall greedy agreement is
   printed;
6. the flash-attention library's build time and ``ptxas`` report, with
   the registers, stack frame and spill bytes of every instantiation of
   the three tensor-core kernels (forward, dQ, dK/dV) and of the paged
   decode kernels (split and combine); a missing instantiation, or a
   stack frame or spill in a tensor-core kernel, fails;
7. flash forward, dQ and dK/dV kernels against their plain versions at
   the training shape (B 4, H 12, T 2048, D 64, causal, key_valid given),
   f32 and bf16, plus padding with a fully padded row, GQA, a sliding
   window, a ragged T, a non-causal cross shape, a query offset (ring
   attention's visiting blocks: 2048 under a window of 1024, and 512,
   each in f32 and bf16; the rows the band leaves without a key are not
   compared) and head dims 16, 32 and
   128 in both dtypes (B 1, H 2, T 512), and the shapes phases 25, 26 and
   30 drive, each timed against SDPA: the training shape non-causal in
   bf16, BERT-base's (B 8, H 12, T 512, non-causal, padded keys with a
   fully padded row), the seq2seq cross-attention's (B 8, H 8, Tq 256, Tk
   255, non-causal, padded source), the synthetic twins' T 32 (B 4, H 8,
   causal and non-causal, padded) and moe's (H 4, non-causal: the MLM
   twin's B 32, T 64, no pads; the BERT rows' B 8, T 512, padded keys with
   a fully padded row), each in f32 and bf16; median times of
   each kernel, its
   plain version and ``scaled_dot_product_attention`` (forward, and
   forward plus backward: a yardstick the port never calls) beside the
   operations bound (f32: three TF32 products at the TF32 rate, with the
   f32-unit figure beside it), and a backward-total line (delta + dQ +
   dK/dV against SDPA's whole backward);
8. training at full width through the CLI entry point:
   ``gpt -m sequential -l 12 -s 768 -e 1 -b 4 --attention flash`` on a
   seeded ``tokens.npy`` of 48 rows of 2049 ids (vocab 32768): finite
   losses, the last train step's below the first's, and every layer of
   every step through the kernels (forward per train/val/test step, dQ and
   dK/dV per train step);
9. the same run with ``--attention dense``: the first step's loss within
   1e-4 and the epoch's train loss within 1e-2 of the flash run;
10. phase 8's run in bf16 (``--dtype bfloat16``): finite losses falling
    from the first train step to the last, every kernel launch on the bf16
    instantiations at phase 8's counts, the first step's loss within 2e-2
    of phase 8's;
11. ``-m data --dtype bfloat16`` at world 1 on NCCL (DDP): the first loss
    within 1e-6 of phase 10's; then with ``--remat`` under the policies
    ``nothing`` and ``dots`` (the forward launched twice a layer a train
    step: (2 x train + eval steps) x 12, the first loss within 1e-6, peak
    memory beside phase 10's); then with ``--grad-accum 2`` (epoch loss
    within 1e-2 of phase 10's, and each train step's loss within
    ``ACCUM_STEP_TOL`` of the plain ``-m data`` run's), and once more with
    a planted fault (the second microbatch's gradient dropped), which
    this check must fail;
12. ``-m data --dtype bfloat16 --dropout 0.1 --checkpoint-every 4`` into a
    ``--checkpoint-dir`` under ``build/``: the final step removed, a
    ``--resume`` run continues from batch 4 and its steps 5-8 give the
    losses of the run that was never stopped within 1e-6; the final step's
    manifest (CRC32 of every leaf) verifies;
13. phase 4's trace through ``PagedEngine`` with its decode tick eager
    (``DecodeTick.graphed`` set false: the same body, no capture), in
    turns with the graphed tick (eager, graphed, graphed, eager): greedy
    tokens identical to phase 4's for every request in every run (the
    proof that the graph recorded the ``ctypes`` kernel launches), one
    kernel launch per layer per tick; tokens/s, tick time, ITL and TTFT of
    each run; each graphed engine's captured tick, and a slot engine's,
    replayed alone between CUDA events: its device time beside its host
    tick; every engine's device memory freed when it is dropped;
14. the slot engine at full width on phase 4's trace (the bench's
    comparison leg, run in phase 4's call): no errors, every budget met,
    tokens in [1, vocab), one capture, first tokens equal to phase 4's;
    greedy agreement, tokens/s, TTFT, ITL and KV bytes beside phase 4's;
15. post-train serving through the CLI, riding on earlier runs: phase
    10's run gains ``--generate 16 --serve --paged --prefill-chunk 64``
    (bf16 queries and pools through the kernel) and phase 11's plain
    ``-m data`` run ``--serve`` (the slot engine on bf16 weights); their
    logged ``generate``, ``serve(paged):`` and ``serve:`` lines must show
    two 16-token continuations, every request served, one decode capture
    and one kernel launch per layer per tick.  What each run served is
    held too, right after it: every budget met, tokens in [1, vocab), each
    greedy token within one bf16 step (2^-8 of max|logit|) of the plain
    forward's argmax on its own prefix; the paged engine's geometry is
    phase 3's ``bf16_serve`` case, and its trace replayed with the plain
    decode attention gives the same first tokens (the greedy agreement
    printed) within the same limit, which a planted fault (each slot
    reading its neighbour's blocks) must break.  Phase 10's run is made
    once more with a second post-train leg, ``--serve --paged --draft 6
    --spec-k 4 --kv-dtype int8 --weight-dtype int8``: its logged line shows
    every request served, the draft round and the verify captured once,
    the decode tick never, and 6 x 5 kernel launches a tick; what it served
    is held against the plain forward of the engine's int8 weights within
    the same limit;
16. the fused head (``CausalLM.loss``) against the logits path at the
    training shape (B 4, T 2048, V 32768, d 768), f32 and bf16 hidden
    states: the loss within 1e-5 (relative), each gradient within 1e-4 of
    its largest element (bf16 dh within one bf16 step), peak memory and
    time of each; then 8 bf16 train steps of the 12-layer model through
    ``loss``, their step time and peak beside phase 10's;
17. phase 10's run with ``--optimizer lamb`` and with ``--optimizer
    adafactor`` (``--lr 1e-2``): finite losses that fall, phase 10's kernel
    launches, step time, peak and optimizer state beside AdamW's
    (Adafactor's must be smaller);
18. phase 4's trace through ``PagedEngine`` with int8 KV, bf16 KV and int8
    weights over int8 KV, and through the slot engine with bf16 KV: no
    errors, every budget met, tokens in [1, vocab), one capture, one kernel
    launch a layer a tick on the paged engine; each int8 run replayed with
    the plain decode attention gives the same first tokens; agreement,
    tokens/s, tick, a replay's device time, KV and weight bytes beside
    phase 4's;
19. phase 4's trace with a 2-layer draft proposing 4 tokens a round: first
    tokens equal to phase 4's, every token within ``SPEC_GAP_TOL`` of the
    plain forward's argmax on its prefix, one capture each of the draft
    round and the verify and none of the decode tick, draft launches
    ``ticks x (spec_k + 1) x draft_layers``; acceptance and tokens/s beside
    phase 4's;
20. phase 4's trace on the model with a 256-position sliding window: the
    kernel against the plain decode (first tokens identical, agreement
    printed), one launch a layer a tick;
21. the reference's workloads through the CLI on the card: ``mlp``,
    ``lstm``, ``mnist`` and ``cnn`` at their CLI default ``-l/-s``
    (DenseNet-BC 2 blocks x 6 layers, growth 32, bn_size 4, on 64x64
    crops; the CNN-LSTM at hidden 128), f32, ``-b 32``, 2 epochs of the
    synthetic twins, with cuDNN's TF32 switched on before each run (torch's
    default), which the f32 run must switch off itself: each epoch's train
    loss below the last, the classifiers' train accuracy rising, and the
    first train step's loss within 1e-4 (relative) of the same step on the
    CPU from the same seed; step time, examples/s and peak memory of each,
    8 more steps under ``torch.profiler`` (the card's kernel time a step
    against the synchronised host clock: its idle share), whether the
    host-data library loaded, and the four kernels' launches (none: no
    attention on this path);
22. ``cnn --dtype bfloat16`` (first loss within 2e-2 of phase 21's),
    ``cnn -m data`` at world 1 on NCCL (within 1e-6), ``mlp
    --double-softmax`` (losses finite and falling) and ``cnn --remat``
    (within 1e-6, peak memory beside phase 21's);
23. ``cnn`` with a ``--checkpoint-dir`` under ``build/``, then ``--resume``
    past its last epoch (the final test only): the restored model's test
    loss and accuracy equal the saved model's (1e-6) and its BatchNorm
    running statistics the saved ones;
24. ``resnet`` through the CLI: (a) its default ResNet-18 on the CIFAR-10
    twin, f32 (the run must switch cuDNN's TF32 off itself), ``-b 128``, 1
    epoch: the train loss falls and the first step's loss lies within
    1e-4 of the CPU's; (b) ResNet-50 at 224 px (stages 3-4-6-3, width 64)
    from a ``--packed-cache`` of 512 seeded ImageNet-twin images packed
    under ``build/`` by the port's ``pack_dataset``, ``--dtype bfloat16
    -b 32``, 1 epoch, with ``--stem-s2d`` and with the 7×7 stem; in f32 the
    first step's forward of the two at mapped stem weights agrees within
    1e-4 of max|logit|; no run launches a flash kernel;
25. ``transformer`` (transformer-base: 6 + 6 layers, d 512, 8 heads, MLP
    2048) through the CLI on a seeded ``tokens.npy`` of 96 rows of 512 ids
    (vocabulary 32000, a ragged pad tail in each half), ``-b 8``, 1 epoch:
    ``--attention flash`` in f32, ``dense`` in f32 (first loss within 1e-4
    of flash's) and flash in bf16 (within 2e-2); the flash runs launch
    exactly 18 forwards a step (6 encoder, 6 decoder self- and 6
    cross-attentions) and 18 dQ and 18 dK/dV a train step, the dense run
    none;
26. ``bert`` (BERT-base: 12 layers, d 768, 12 heads, MLP 3072) the same
    way on 96 rows of 512 ids (vocabulary 30522, ragged pad tails): 12
    forwards a step and 12 dQ and 12 dK/dV a train step;
27. the staged modes of the reference's workloads (``mlp``, ``cnn``,
    ``lstm``, ``mnist`` at their CLI defaults) and ``resnet -s 18`` on
    the CIFAR twin, f32, ``-b 32``: ``-m model --nstages 2``'s first
    train step from the sequential model's weights mapped through
    ``split_state_dict`` within 1e-5 of ``-m sequential``'s (and how far
    the seeded staged init lies from those weights), ``-m pipeline
    --nstages 2 -p 8``'s first step within 1e-4 of the same step on the
    CPU; one CLI epoch of each mode with its step time, examples/s and
    peak memory, no kernel launched;
28. the pipelined trunk at full width: ``gpt -l 12 -s 768`` on phase 8's
    rows (T 2048), ``-m pipeline --nstages 4 -b 8 -p 1`` (8 microbatches,
    every stage on the card) under ``gpipe``, ``1f1b`` and ``interleaved
    --virtual-stages 3`` in f32 and ``1f1b`` in bf16: one train step of
    each from the same seeded weights (checked equal layer by layer):
    the f32 losses within 1e-5 of each other and of the unpipelined
    ``apply_sequential`` walk, within 1e-4 of that walk with dense
    attention (no flash kernel), the trunk gradients within 1e-3 of
    max|g| of gpipe's, bf16's loss within 2e-2 of f32's and its trunk
    gradients within ``PIPE_BF16_GRAD_TOL`` of 1F1B f32's (a planted
    bf16 step that drops the last microbatch's gradient must lie beyond
    it), the flash kernels' launches exact (forward L·M under gpipe,
    (2 − 1/(S·V))·L·M under 1F1B and interleaved, which compute each
    block again in the backward but for the last virtual stage's; dQ
    and dK/dV L·M), 1F1B's and interleaved's peak memory below gpipe's;
    then a CLI epoch
    of each with its launches, step time, tokens/s and peak, and a
    profiler window's kernel time and idle share;
29. ``bert`` (BERT-base, ``--nstages 4``) and ``transformer``
    (transformer-base's 6 layers as the decoder-only pipelined LM over
    source⊕target, ``--nstages 2``) under ``-m pipeline`` (gpipe, ``-p
    2``) on phases 25-26's rows: finite losses, the flash kernels'
    launches exact (L·M forwards a step; non-causal for BERT, no key
    mask: the trunk attends pads, as JAX's); ``gpt -m model --nstages 2``
    on phase 8's rows: dense attention, as in JAX, no launch;
30. ``moe`` (the GShard top-2 MoELM at the CLI default: 4 layers, 1 and
    3 routed over 8 experts, d 256, 4 heads, MLP 1024) through the CLI,
    1 epoch, on (a) the synthetic MLM twin at ``-b 32`` (T 64: 2048
    tokens a step, capacity 512) and (b) phase 26's 96 BERT rows of 512
    ids at ``-b 8`` (4096 tokens, capacity 1024; ragged pad tails), each
    in f32 and bf16: the flash kernels' launches exact (4 forwards a step,
    4 dQ and 4 dK/dV a train step); the first step's forward on the card
    from the run's seeded init: its task loss equals the logged first
    loss (1e-6: the load-balance term, which must be finite and positive,
    is added to the objective only), each routed layer's dropped share,
    the ``(G, E, C)`` dispatch shape and one gating call's peak memory;
    the f32 first loss within 1e-4 of the CPU's, bf16's within 2e-2 of
    f32's, and ``-m data`` at world 1 within 1e-6 of ``-m sequential``;
    step time, tokens/s, peak and a profiler window's idle share (the
    ``-m data`` run's window through ``DistributedDataParallel``);
31. sharded state: ``gpt`` at phase 8's width (12 x 768, T 2048, V
    32768) on 24 of its rows (4 train steps and a test step a run) under
    ``-m data`` at world 1, plain, ``--zero 1`` and ``--zero fsdp``, in
    f32 and bf16: the flash kernels' launches exact, each sharded run's
    first loss within 1e-6 of the plain run's from the same weights, step
    time, peak memory and the optimizer state and parameter bytes a rank
    holds beside the plain run's (and phase 11's, when it ran); profiler
    windows of 4 bf16 steps, plain and ``--zero fsdp`` (the card's busy
    time against the wall clock); then two ranks on the one card in a
    gloo group the smoke makes (NCCL gives no two ranks one card), after
    a probe of the collectives the modes need on CUDA tensors (a failing
    op fails the phase): ``gpt --mesh model=2`` (f32, the same rows) and
    ``moe --mesh expert=2`` (phase 30's MLM twin, 4 train steps), each
    rank's first
    loss within 1e-5 of the world-1 run's, every flash launch on ``H/2``
    heads for gpt (all ``H`` for moe, whose attention is replicated),
    launches exact, and the step time;
32. compressed collectives and context parallelism: phase 31's ``gpt`` on
    its 24 rows at world 1 under ``-m data --grad-compress bf16`` and
    ``int8`` (each history within 1e-6 of plain ``-m data``'s: one rank
    compresses nothing); a probe of the explicit collectives' seven ops
    on CUDA tensors as the port calls them (values checked; the one that
    crosses through host memory, send/recv, marked); two ranks on the one card over
    gloo, ``--grad-compress int8``, ``--zero fsdp --comm int8
    --comm-overlap`` and ``--zero fsdp --comm bf16``: each rank's first
    loss within 1e-5 of world 1's under ``--grad-compress`` (it touches
    only the gradients; ``--comm``'s first forward reads the parameters
    through the quantized gather, so there the first loss is held as the
    later ones), each later one within 5e-2 (JAX's int8 tolerance), the
    int8 residual finite and nonzero, the flash
    launches exact, the step time; then ring attention and Ulysses (the
    flash kernels inside) over the two ranks at B 2, H 12, D 64, T 4096
    (T 2048 a rank), causal f32 and bf16, causal with a window of 1024,
    and non-causal with padded keys and a fully padded row: O and dQ,
    dK, dV against single-rank ``flash_attention`` on the whole sequence
    (phase 7's tolerances; the ring's fully padded row exactly 0), each
    rank's launches equal to the hops it runs (``ring_hops``: causal,
    rank 0 one and rank 1 two), and each scheme's forward+backward time
    beside single-rank flash's;
33. ``-m pipeline`` over a data x stage grid of ranks, one rank a stage:
    phase 28's ``gpt`` (12 x 768, T 2048) on phase 8's rows, ``-b 8 -p
    2`` over 2 stages (M 4), the ranks sharing the card over gloo as in
    phase 31 (boundary tensors staged through pinned host memory): 2
    ranks under 1F1B, interleaved (V 2) and GPipe in f32 and 1F1B in
    bf16, 4 ranks (data 2 x stage 2) under 1F1B in f32, each as the CLI
    builds it; against one process walking every stage from the same
    weights (phase 28's tolerances: the first loss of every rank within
    1e-5, or 2e-2 in bf16; the trunk gradients, gathered from the stage
    ranks, within 1e-3 of max|g|, or 5e-2 in bf16), each rank's flash
    launches exact for its stage (``grid_launches``) and data coordinate
    0's stages summing to one process's; a step's time (the slowest
    rank's), the peak a rank and the bytes a rank sends a step;
34. training resilience on phase 31's bf16 ``gpt`` (24 rows, 4 train
    steps) under ``-m data`` at world 1: ``check_step_determinism`` (one
    step twice from one state, bit-identical), then ``--sentinel skip``
    with NaN activations on step 3 (the one NONFINITE verdict; the final
    state bit-identical to the run that skips the step), the logits
    scaled 1e3 on step 3 (GRAD_SPIKE), ``--sentinel halt`` (raises within
    one step), the sentinel's step time against none, asynchronous saves
    of the whole state, the first and a warm one, each with train steps
    at once (the file equal to the state at the save; training stopped,
    ``save()``'s return plus the next steps' time over plain steps,
    against ``wait=True``), the planted race (the save's copy held back
    on its stream: the file equal to the state at the save with the
    fence, differing without it),
    ``--sentinel rollback`` under the elastic loop (bit-identical to the
    replay), ``--elastic --checkpoint-every 2`` through the CLI with
    ``DDL_INJECT_STEP_FAILURE=0:3`` (one restart, the final state
    bit-identical to an uninterrupted run's, the launches the
    uninterrupted run's plus the replayed step's, the time from the
    failure to completion) and its latest save truncated (quarantined,
    the older step restored);
35. serving resilience and the fleet on phase 4's model and the first 8
    requests of its trace (run beside phase 4, before its model leaves
    the card): the fault-free supervised run, whose ticks' logits give
    the near-tie limit (twice the largest |logit difference| between the
    chunk prefill and the decode tick at the same positions); each
    ``SERVE_KIND`` under the supervisor, twice (detection ticks, restart
    and replay cost; zero lost, committed tokens kept, a parted request
    first parting at a near-tie, the two runs alike; ``slow_tick``
    exact); hot reload through publish, watch, verify and canary (the
    live weights promoted, zeroed weights rolled back, a NaN publication
    quarantined; publish, load and in-place swap times, decode captures 1
    and the canary's tick captured once); the admission ladder shedding
    priority >= 1; priority preemption on a 2-slot engine with the host
    and the device wire (exact against uncontended runs) and
    ``migrate_drop`` (the digest trips, the ledger replays); a slot
    move's bytes, digest and copy times; two replicas behind the router
    under ``replica_crash``, an evacuation and one with ``evac_drop``
    (blocks moved at rest, digest-verified; bytes, digest and copy
    times), the autoscaler growing by one at the launch geometry and
    draining back; then the CLI, twice a few training steps of phase 8's
    ``gpt`` and ``--serve --paged --priority-classes ...
    --serve-deadline-ms ... --admission ... --migrate device
    --reload-watch ...`` (the ``serve(supervised)`` line), again with
    ``--replicas 2 --evacuate-on degraded --autoscale ...`` (the
    ``serve(fleet)`` line).  Every leg's decode launches equal its decode
    ticks (the canary's included) x layers.
36. disaggregated serving on phase 35's model and trace, a prefill pool
    (4 rows a batched chunk) and a decode pool both on card 0: each wire
    (``at_rest``, ``int8``) served warm and then timed, its decode
    launches equal to its ticks x layers; each run's tokens held to the
    determinism rule against the unified engine under a limit read apart
    from it: the at-rest wire's largest |dlogit| at the same positions
    (up to the first parting) at most twice the unified engine's chunk
    prefill against its decode tick, the int8 wire's at most
    ``INT8_WIRE_DLOGIT``, and every parting first at a near-tie; a
    handoff of one slot's blocks with digests (bytes, digest ms, copy
    ms); ``reassign`` both ways on a third worker; the CLI's refusal of
    ``--disagg`` on one card; ``disagg_serving_bench``'s record (speedup
    against the unified engine, ITL p99s, migration GiB/s, agreement,
    ``prefill_util``).
37. observability: phase 31's bf16 ``gpt`` on 32 rows through the CLI
    with ``--obs --obs-trace --obs-blackbox --metrics-file
    --profile-dir``, and again without: the losses equal bit for bit, the
    flash launches those of the epoch (its first train step counted); the
    MFU record against the card's peak from ``obs/mfu.py``'s table; the
    step's FLOPs with ``--attention dense`` within 1% of flash's; the
    profiler trace naming the flash kernels, and the card's idle share
    over train steps 2-4; ``overhead_bench`` and ``trace_overhead_bench``
    with their quartiles, and the loop's instruments' host cost; phase
    35's 8 requests served under telemetry, a tracer and a recorder, a
    planted SLO breach tripping it; a captured decode tick replayed under
    the profiler (its idle share).
38. remat on the conv models: ResNet-18 f32 at phase 24's shape, three
    train steps each without remat and under ``--remat-policy nothing``,
    ``dots`` and ``dots_no_batch`` (losses, step time, peak): every
    policy's losses within ``REMAT_TOL`` of the run without remat, the
    ``dots`` peak below it; one ``dots`` run each of ``mlp``, ``lstm``,
    ``mnist`` and ``cnn`` at phase 21's settings held to its run without
    remat the same way.
39. tuning on phase 8's ``gpt``: ``--autotune --plan FILE`` through the
    CLI at world 1 over the one-device lattice (trials, rungs, steps/s),
    then ``--plan FILE``, whose losses equal the searched run's bit for
    bit; flash launches equal the trials' step calls times each plan's
    kernels a step, plus the epoch's.  A real OOM: ``run_search`` with
    ``--attention dense`` at ``TUNE_OOM_BATCH`` over the one-device
    lattice's four remat corners, the analytic model told to prune
    nothing: the allocator refuses the plan without remat,
    ``memory_allocated`` after the search is what it was before, a remat
    plan is chosen.  ``run_calibration``: each
    corner's fitted activation fraction and recompute cost against JAX's
    priors, analytic against calibrated error.
40. resharding, after phases 37-39: phase 31's ``gpt`` (f32) on 36
    rows (two train steps an epoch) at ``-b 12`` on gloo ranks sharing
    card 0: ``--zero 1`` on 4 ranks
    trains 2 epochs, saving each; from epoch 1's checkpoint, the two
    legs side by side: (a) ``-r 3 --reshard --resume`` re-plans onto
    ``data=3``, (b) ``-r 2 --reshard --resume --target-mesh fsdp=2 --zero
    fsdp``.  Each leg: every rank restores ``chunked``, its part of every
    leaf equal to the same part of the saved tensors bit for bit, every
    epoch-2 loss within ``REMAT_TOL`` of the 4 ranks' second epoch, the
    flash launches exact; restore seconds, bytes copied to each rank's
    card and each rank's peaks printed;
41. the scripts and examples (``distributed_deep_learning_tpu_torch.
    scripts``/``examples``) on the card, each through its ``main(argv)``:
    ``serve_bench --paged --obs --obs-trace`` at phase 4's width with the
    flags nearest phase 4's load (``P41_SERVE``), its tokens equal to a
    direct ``paged_serving_bench`` call on the load it built, the decode
    launches of each its ``decode_ticks`` x 12; ``obs_report --trace`` and ``--window`` over
    the stream that run wrote (one request trace a request served);
    ``disagg_bench --requests 8`` on card 0 twice; ``autotune gpt -l 12
    -s 768 -b 4 --dry-run`` against the card's memory; ``data_soak
    --small --only mqtt`` onto the card; examples 01, 04, 06 and 08; then,
    as two ranks sharing card 0 over gloo, ``comm_bench`` and examples
    02, 03, 05 and 07 in turn (ring exactness, FSDP parity within JAX's
    1e-5, a falling int8 loss; each pass line).  Every call exits 0 and
    its flash and decode launches are the ones its calls predict (the
    disaggregation bench's: the decode ticks of both arms' warm and timed
    runs, counted as they are called, x its model's layers).
    ``chaos_drill``, ``pack_dataset``, ``feed_bench`` and
    ``obs_report``'s JSON-only modes are host code or phases 35 and 40's
    calls, and do not run here.

Phases 31, 32, 33 and 41's rank work runs in one launch of ranks a
world (``start_ranks``: two ranks, and four for phase 33's four-rank
case), started before phase 23, whose timings no one reads: the ranks
import, make their group and wait at a gate file that the first phase
to read their records opens (``rank_records``), then run the jobs of the
phases asked for in turn.  Every set of ranks rendezvouses through a
store that this process holds on a port the OS picks
(``runtime.bootstrap.host_store``).

Phases 21 and 24 also run item 18's A/B (``prefetch_ab``) on one
workload each (``cnn``; ResNet-50 from the packed cache): the train
loader unwrapped (the runner's default) and two batches deep, in turns,
with the step time and the idle share while the loader forms the
batches.

Phases 8-12, 16, 17, 21, 22 and 24-33 print step time, throughput and
peak memory; phases 21, 24-26, 28 and 30 a profiler window's kernel time
and idle share, 24-26 and 30 also the flash kernels' time and the step's
operations against the bf16 tensor-core rate (``step_operations``).  The
line before the last is ``{"kernels": [...]}`` (the flash entries with
phase 32's launches: ``comm_launches`` a two-rank leg, ``seq_launches`` a
context-parallel case and rank); the last line is
``{"ok": true, "device": {...}}``.  Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from fractions import Fraction
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

#: NVIDIA H100 SXM data sheet: HBM3 rate, f32 rate outside the tensor
#: cores, bf16 and TF32 dense tensor-core rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
KERNEL_SOURCE = "distributed_deep_learning_tpu_torch/csrc/paged_decode.cu"
DECODE_KERNELS = ("paged_decode_kernel", "paged_combine_kernel")
FLASH_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")
KERNEL_REPLACES = ("distributed_deep_learning_tpu/ops/paged_decode_pallas.py"
                   ":66 (_decode_kernel)")
FLASH_SOURCE = "distributed_deep_learning_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_forward": "distributed_deep_learning_tpu/ops/attention_pallas.py"
                     ":97 (_fwd_kernel, pallas_call :192)",
    "flash_backward_dq": "distributed_deep_learning_tpu/ops/"
                         "attention_pallas.py:213 (_dq_kernel, pallas_call "
                         ":331)",
    "flash_backward_dkv": "distributed_deep_learning_tpu/ops/"
                          "attention_pallas.py:248 (_dkv_kernel, "
                          "pallas_call :354)",
}

#: the serving slice's decode shape: 8 slots, GPT-2-small heads, 1024-token
#: slots in 16-position blocks, pools sized as the engine sizes them
DECODE_SHAPE = dict(B=8, Hkv=12, G=1, D=64, bs=16, Bps=64,
                    N=2 * 8 * 64 + 1)
TOL = {"f32": 1e-4, "int8": 1e-4, "int8_serve": 1e-4, "bf16": 2e-2}
#: phase 20's sliding window, held in phase 3 at the 8-slot shape
SERVE_WINDOW = 256


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    return line


def start_builds():
    """Start one ``nvcc`` per kernel source, all together; returns
    futures of ``(path, log, seconds)`` by source name."""
    from distributed_deep_learning_tpu_torch.ops import attention
    from distributed_deep_learning_tpu_torch.ops import paged_decode

    def timed(build):
        t0 = time.perf_counter()
        path, log = build()
        return path, log, time.perf_counter() - t0

    pool = ThreadPoolExecutor(2)
    futures = {"paged_decode": pool.submit(timed, paged_decode.build),
               "flash_attention": pool.submit(timed, attention.build)}
    pool.shutdown(wait=False)
    return futures


def phase_build(future, label="build"):
    """Wait for one library's build and print its time and ptxas report;
    returns the report."""
    path, log, seconds = future.result()
    print(f"{label}: {seconds:.2f}s -> {path.relative_to(ROOT)}")
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print(f"  ptxas {ln.strip()}")
    return log


#: one template argument of a mangled kernel name: a type or an integer
_TEMPLATE_ARG = re.compile(r"f|a|13__nv_bfloat16|S\d*_|Li(\d+)E")


def _template_args(text):
    """The template arguments of a mangled name, ``text`` starting just
    after its ``I``: types as ``f32``, ``int8`` or ``bf16`` (the one class
    type, so a substitution ``S.._`` names it too), integers as ints."""
    args, i = [], 0
    while i < len(text) and text[i] != "E":
        m = _TEMPLATE_ARG.match(text, i)
        if m is None:
            break
        args.append(int(m.group(1)) if m.group(1) is not None
                    else {"f": "f32", "a": "int8"}.get(m.group(0), "bf16"))
        i = m.end()
    return tuple(args)


def ptxas_summary(log, kernels):
    """``{(kernel, *template args): (registers, stack frame bytes, spill
    store bytes, spill load bytes)}`` for the named kernels, from ``nvcc
    -Xptxas=-v`` output; a flash kernel's key is ``(kernel, dtype, D)``."""
    name_re = re.compile(r"(" + "|".join(kernels) + r")I")
    out, key, spill = {}, None, (0, 0, 0)
    for ln in log.splitlines():
        m = name_re.search(ln)
        if m and ("Compiling entry" in ln or "Function properties" in ln):
            key = (m.group(1), *_template_args(ln[m.end():]))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and key:
            spill = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and key:
            out[key] = (int(m.group(1)), *spill)
            key, spill = None, (0, 0, 0)
    return out


#: instantiations phase 6 must find: 3 flash kernels x 2 dtypes x 4 head
#: dims; the decode's 2 x 3 x 3 split kernels and 2 combines
FLASH_INSTANTIATIONS, DECODE_INSTANTIATIONS = 24, 20


def check_ptxas(flash_log, decode_log):
    """Print registers, stack frame and spills of every instantiation;
    raise if either library has fewer than expected or a tensor-core flash
    kernel has a stack frame or spill (the decode kernels' small spill is
    printed, not held against them)."""
    for label, found, want, strict in (
            ("flash tensor-core", ptxas_summary(flash_log, FLASH_KERNELS),
             FLASH_INSTANTIATIONS, True),
            ("paged decode", ptxas_summary(decode_log, DECODE_KERNELS),
             DECODE_INSTANTIATIONS, False)):
        for (kname, *args), (regs, frame, st, ld) in sorted(found.items()):
            what = " ".join(f"D{a}" if isinstance(a, int) else a
                            for a in args)
            print(f"ptxas {kname} {what}: {regs} registers, stack frame "
                  f"{frame} B, spill stores {st} B, spill loads {ld} B")
        spilled = [k for k, (_, frame, st, ld) in found.items()
                   if frame or st or ld]
        print(f"ptxas {label}: {len(found)} of {want} instantiations "
              f"parsed, {len(spilled)} with a stack frame or spill")
        if len(found) < want:
            raise RuntimeError(f"ptxas {label}: {len(found)} of {want} "
                               "instantiations found in the build log")
        if strict and spilled:
            raise RuntimeError(f"ptxas {label}: stack frame or spill in "
                               f"{sorted(spilled)}")


def phase_ptxas(builds):
    """Phase 6: the flash library's build, then :func:`check_ptxas` on both
    libraries' reports."""
    log = phase_build(builds["flash_attention"], label="build flash")
    _, decode_log, _ = builds["paged_decode"].result()
    check_ptxas(log, decode_log)


# --- phase 3 ---------------------------------------------------------------


def _decode_case(*, B, Hkv, G, D, bs, Bps, N, lens, kv="f32", holes=False,
                 window=None, seed=0, device="cuda"):
    """Seeded decode inputs on the card: pools of N blocks (block 0 the
    trash block), each slot's live blocks at distinct random physical ids,
    table tails trash-padded.  ``kv="int8_serve"``: int8 pools quantized
    by the serving engines' rule (``serve.quant.quantize_rows``)."""
    import torch

    from distributed_deep_learning_tpu_torch.serve import quant

    gen = torch.Generator().manual_seed(seed)
    dev = torch.device(device)
    need = [-(-n // bs) for n in lens]
    ids = (torch.randperm(N - 1, generator=gen) + 1).tolist()
    tables = torch.zeros(B, Bps, dtype=torch.int32)
    for b, nb in enumerate(need):
        tables[b, :nb] = torch.tensor(ids[:nb], dtype=torch.int32)
        ids = ids[nb:]
    qdt = torch.bfloat16 if kv == "bf16" else torch.float32
    q = torch.randn(B, Hkv, G, D, generator=gen).to(qdt)
    k = torch.randn(N, bs, Hkv, D, generator=gen)
    v = torch.randn(N, bs, Hkv, D, generator=gen)
    scales = {}
    if kv == "int8":
        def quantize(x):
            s = x.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
            return torch.round(x / s).clamp(-127, 127).to(torch.int8), s
        k, scales["k_scale"] = quantize(k)
        v, scales["v_scale"] = quantize(v)
    elif kv == "int8_serve":
        (k, scales["k_scale"]), (v, scales["v_scale"]) = (
            (qt.q, qt.s) for qt in (quant.quantize_rows(k),
                                    quant.quantize_rows(v)))
    elif kv == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    valid = torch.ones(N, bs, dtype=torch.bool)
    if holes:
        valid = torch.rand(N, bs, generator=gen) > 0.2
        for b, n in enumerate(lens):   # the query's own position is valid
            if n:
                valid[tables[b, (n - 1) // bs], (n - 1) % bs] = True
    args = [q, k, v, tables, torch.tensor(lens, dtype=torch.int32)]
    kw = {"valid_pool": valid, **scales}
    return ([a.to(dev) for a in args],
            {**{name: t.to(dev) for name, t in kw.items()},
             **({"window": window} if window is not None else {})})


#: GPU clock cycles (~50 ms on an H100) the card sleeps while the host
#: enqueues a span of :func:`_time_ms` (``head_start``) or :func:`_host_us`
HEAD_START_CYCLES = 100_000_000


def _time_ms(fn, reps=20, rounds=5, head_start=False):
    """Device time of one call of ``fn`` with a cold L2 (the decode reads
    pools that the other layers pushed out): each round times ``reps``
    pairs of (256 MiB write, call) and ``reps`` writes alone between CUDA
    events; the call's time is the difference over ``reps``, median over
    rounds.  The write keeps the card busy while the host enqueues the
    next call, so host launch cost is hidden unless a call's host cost
    exceeds the write (then it is counted, as for a many-op plain call).
    ``head_start``: each span waits behind a device-side sleep until the
    host has enqueued all of it, so no host cost is timed at all."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()

    def span(call):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if head_start:
            torch.cuda._sleep(HEAD_START_CYCLES)
        a.record()
        for _ in range(reps):
            flush.zero_()
            if call:
                fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    return statistics.median((span(True) - span(False)) / reps
                             for _ in range(rounds))


def _host_us(fn, calls=100, rounds=10):
    """Host cost of one call of ``fn`` in microseconds: the host clock
    around ``calls`` calls enqueued while the card sleeps, so the launch
    queue neither drains nor fills and only the host's work (Python,
    allocation, launches) is timed; median over ``rounds``."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(HEAD_START_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def decode_costs():
    """The decode kernel's device ms at each timed case (``head_start``:
    no host cost) and the host's us for one wrapper call at the 8-slot
    shape, from whichever copy of the package is first on ``sys.path``, so
    a parent commit's wrapper is timed the same way."""
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode

    out = {}
    for name, spec in _timed_decode_specs().items():
        args, kw = _decode_case(seed=len(name), **spec)
        out[name] = _time_ms(lambda: paged_flash_decode(*args, **kw),
                             head_start=True)
        if name == "f32":
            out["host_us"] = _host_us(lambda: paged_flash_decode(*args, **kw))
    return out


def _timed_decode_specs():
    """The timed decode cases: the serving shape with 8 slots of 1-600
    positions, and ``f32_long``, 2 slots of the engine's 1024."""
    import numpy as np

    full = DECODE_SHAPE["Bps"] * DECODE_SHAPE["bs"]
    spread = [int(x) for x in np.linspace(1, 600, DECODE_SHAPE["B"])]
    return {"f32": dict(DECODE_SHAPE, lens=spread),
            "f32_long": dict(DECODE_SHAPE, B=2, lens=[full, full])}


def _bound_ms(args, kw):
    """Least time for the work: each input byte the function needs read
    once, the output written once, over HBM; its flops over the f32 rate."""
    q, k, _, tables, lens = args
    B, Hkv, G, D = q.shape
    bs = k.shape[1]
    window = kw.get("window")
    spans = [(max(0, x - window) if window else 0, x)
             for x in (int(y) for y in lens.tolist())]
    pos = sum(hi - lo for lo, hi in spans)
    blocks = sum(-(-hi // bs) - lo // bs for lo, hi in spans if hi > lo)
    nbytes = 2 * q.numel() * q.element_size()               # q in, out
    nbytes += 2 * pos * Hkv * D * k.element_size()         # live K and V
    if "k_scale" in kw:
        nbytes += 2 * pos * Hkv * 4
    if kw.get("valid_pool") is not None:
        nbytes += pos
    nbytes += blocks * 4 + B * 4                             # tables, lens
    flops = 4 * pos * Hkv * G * D                            # q.k and p.v
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def _library_ms(args, kw):
    """``scaled_dot_product_attention`` over K/V gathered beforehand (the
    gather is not timed): one PyTorch call computing the same function."""
    import torch
    import torch.nn.functional as F

    q, k, v, tables, lens = args
    B, Hkv, G, D = q.shape
    T = tables.shape[1] * k.shape[1]
    t = tables.long()
    kd = k[t].reshape(B, T, Hkv, D).repeat_interleave(G, 2).transpose(1, 2)
    vd = v[t].reshape(B, T, Hkv, D).repeat_interleave(G, 2).transpose(1, 2)
    kd, vd = kd.contiguous(), vd.contiguous()
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = kpos < lens.long()[:, None]
    if kw.get("window"):
        mask = mask & (kpos >= lens.long()[:, None] - kw["window"])
    mask = mask & kw["valid_pool"][t].reshape(B, T)
    q4 = q.reshape(B, Hkv * G, 1, D)
    return _time_ms(lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask[:, None, None, :]))


def _decode_timing(args, kw, err):
    """Median cold-L2 ms of the kernel, the plain version and SDPA on
    these inputs, beside the bytes bound."""
    from distributed_deep_learning_tpu_torch.ops.paged_decode import (
        paged_decode_reference, paged_flash_decode)

    rec = dict(max_abs_err=err,
               ms=_time_ms(lambda: paged_flash_decode(*args, **kw)),
               plain_ms=_time_ms(lambda: paged_decode_reference(*args, **kw)),
               library_ms=_library_ms(args, kw))
    rec["bound_ms"], rec["bound_by"] = _bound_ms(args, kw)
    return rec


def _print_splits(label, shape):
    """The split-K count the decode's rule gives at ``shape``; returns the
    count and the positions a split covers."""
    import torch

    from distributed_deep_learning_tpu_torch.ops.paged_decode import (
        decode_splits, sm_count)

    splits, per = decode_splits(shape["B"], shape["Hkv"], shape["Bps"],
                                shape["bs"], sm_count(torch.device("cuda")))
    print(f"kernel split-K at {label}: {splits} splits of {per} blocks "
          f"({per * shape['bs']} positions) per (slot, kv head), "
          f"{shape['B'] * shape['Hkv'] * splits} blocks")
    return splits, per * shape["bs"]


def phase_kernel():
    import numpy as np
    import torch

    from distributed_deep_learning_tpu_torch.ops.paged_decode import (
        paged_decode_reference, paged_flash_decode)

    shape = DECODE_SHAPE
    full = shape["Bps"] * shape["bs"]
    splits, run = _print_splits(f"the {shape['B']}-slot shape", shape)
    _print_splits("phase 15's shape", SERVE_BF16_SHAPE)
    timed = _timed_decode_specs()
    spread = timed["f32"]["lens"]
    long_tail = [full - 13 * i for i in range(1, shape["B"])]
    cases = [
        ("f32", timed["f32"]),
        ("gqa_g4", dict(shape, Hkv=3, G=4, lens=spread)),
        ("bf16", dict(shape, lens=spread, kv="bf16")),
        ("int8", dict(shape, lens=spread, kv="int8")),
        ("valid_holes", dict(shape, lens=spread, holes=True)),
        ("empty_slot", dict(shape, lens=[0] + spread[1:])),
        ("split_boundary", dict(shape, lens=[run * max(1, splits // 2)]
                                + spread[1:])),
        ("short_slot", dict(shape, lens=[max(1, run // 3)] + long_tail)),
        ("f32_long", timed["f32_long"]),
        ("bf16_serve", dict(SERVE_BF16_SHAPE, kv="bf16", lens=[
            int(x) for x in np.linspace(*SERVE_BF16_LENS,
                                        SERVE_BF16_SHAPE["B"])])),
        ("window", dict(shape, lens=[full - 7] + spread[1:],
                        window=SERVE_WINDOW)),
        ("int8_serve", dict(shape, kv="int8_serve", lens=[
            int(x) for x in np.linspace(1, full, shape["B"])])),
    ]
    main, errs = None, {}
    for name, spec in cases:
        args, kw = _decode_case(seed=len(name), **spec)
        out = paged_flash_decode(*args, **kw)
        torch.cuda.synchronize()
        ref = paged_decode_reference(*args, **kw)
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"kernel case {name}: non-finite output")
        rows = torch.as_tensor(spec["lens"], device=out.device) > 0
        err = float((out.float() - ref.float())[rows].abs().max())
        tol = TOL[spec.get("kv", "f32")]
        print(f"kernel {name}: max_abs_err {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise RuntimeError(f"kernel case {name}: error {err} > {tol}")
        errs[name] = err
        if name in ("f32", "f32_long", "window"):
            rec = _decode_timing(args, kw, err)
            print(f"kernel {name} timing: kernel {rec['ms']:.4f} ms, plain "
                  f"{rec['plain_ms']:.4f} ms, sdpa {rec['library_ms']:.4f}"
                  f" ms, bound {rec['bound_ms']:.4f} ms "
                  f"({rec['bound_by']}), {rec['bound_ms'] / rec['ms']:.1%}"
                  " of bound")
            if name == "f32":
                main = rec
            else:
                main[name] = rec
    main["bf16_serve_max_abs_err"] = errs["bf16_serve"]
    main["int8_serve_max_abs_err"] = errs["int8_serve"]
    costs = decode_costs()
    main["device_ms"] = costs["f32"]
    main["f32_long"]["device_ms"] = costs["f32_long"]
    main["host_us"] = costs["host_us"]
    print(f"kernel device time, no host cost: f32 {costs['f32']:.4f} ms, "
          f"f32_long {costs['f32_long']:.4f} ms; host "
          f"{costs['host_us']:.1f} us a wrapper call at the 8-slot shape")
    return main


# --- phases 4, 5, 13 and 14: serving ----------------------------------------

#: the ``gpt`` CLI default (-l 12 -s 768: 12 heads of 64, MLP 3072) with the
#: bench ``lm`` vocabulary, 1024 positions, f32, random weights from seed 0
FULL_MODEL = dict(vocab_size=32768, num_layers=12, d_model=768,
                  num_heads=12, mlp_dim=3072, max_len=1024)
FULL_LOAD = dict(n_requests=16, arrival="poisson", prompt_short=(16, 64),
                 prompt_long=(256, 512), long_frac=0.3,
                 shared_prefix_len=64, shared_frac=0.6, new_tokens=(16, 64))
FULL_ENGINE = dict(max_slots=8, kv_block_size=16, prefill_chunk=64)


def _serve(label, *, compare_engine=False):
    """Phase 4's bench call with the decode attention ``label`` ("kernel"
    or "plain")."""
    from distributed_deep_learning_tpu_torch.serve.bench import \
        paged_serving_bench

    t0 = time.perf_counter()
    rec = paged_serving_bench(seed=0, device="cuda", load_kw=FULL_LOAD,
                              model_kw=FULL_MODEL,
                              decode_attention=label,
                              compare_engine=compare_engine, **FULL_ENGINE)
    pe = rec["paged_engine"]
    print(f"serve[{label}]: {pe['generated_tokens']} tokens at "
          f"{pe['tokens_per_sec']:.1f} tok/s ({pe['total_seconds']:.2f} s "
          f"serving, {time.perf_counter() - t0:.1f} s with model build), "
          f"decode {pe['decode_seconds']:.3f} s over {pe['decode_ticks']} "
          f"ticks ({_tick_ms(pe):.3f} ms a tick, decode captures "
          f"{pe['decode_captures']}), prefill {pe['prefill_seconds']:.3f} s"
          f" over {pe['prefill_chunks']} chunks")
    print(f"serve[{label}]: {_latency_text(pe)} | prefix_hit_rate "
          f"{pe['prefix_hit_rate']:.4f}")
    return rec


def _tick_ms(rec):
    return rec["decode_seconds"] / rec["decode_ticks"] * 1e3


def _latency_text(rec):
    lat = rec["latency"]
    return (f"ttft p50 {lat['ttft_p50_s']:.4f} s p99 {lat['ttft_p99_s']:.4f}"
            f" s | itl p50 {lat['itl_p50_s']:.5f} s p99 "
            f"{lat['itl_p99_s']:.5f} s | e2e p50 {lat['e2e_p50_s']:.4f} s "
            f"p99 {lat['e2e_p99_s']:.4f} s | kv_cache_bytes "
            f"{rec['kv_cache_bytes']} | mean occupancy "
            f"{rec['mean_slot_occupancy']:.3f}")


def _check_results(label, results, budgets, vocab=FULL_MODEL["vocab_size"]):
    """Every request served to its budget, every token in [1, vocab)."""
    for uid, budget in budgets.items():
        toks = results.get(uid, [])
        if len(toks) != budget:
            raise RuntimeError(f"{label}: request {uid}: {len(toks)} tokens "
                               f"of {budget}")
        if not all(1 <= t < vocab for t in toks):
            raise RuntimeError(f"{label}: request {uid}: token outside "
                               f"[1, {vocab})")


def _check_tick(label, rec, captures):
    if rec["decode_captures"] != captures or rec["nonfinite_tokens"]:
        raise RuntimeError(f"{label}: decode captures "
                           f"{rec['decode_captures']} (expected {captures}),"
                           f" {rec['nonfinite_tokens']} non-finite tokens")


def _agreement(a, b, label):
    """Greedy agreement of two result maps; raises unless every first
    token agrees."""
    same = total = 0
    for uid, toks in a.items():
        other = b[uid]
        if toks[0] != other[0]:
            raise RuntimeError(f"{label}: request {uid}: first token "
                               f"{toks[0]} vs {other[0]}")
        same += sum(x == y for x, y in zip(toks, other))
        total += len(toks)
    print(f"{label}: first tokens identical for {len(a)} requests; greedy "
          f"agreement {same}/{total} = {same / total:.4f}")
    return same / total


def phase_serve(compare_engine=False):
    """The main path at full width, its decode tick graphed; returns its
    record and the kernel launches counted during it (the count is zeroed
    just before).  ``compare_engine``: the slot engine serves the same
    trace after it (phase 14's run), launching no kernel."""
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode

    paged_flash_decode.launches = 0
    rec = _serve("kernel", compare_engine=compare_engine)
    launches = paged_flash_decode.launches
    pe = rec["paged_engine"]
    if rec["errors"]:
        raise RuntimeError(f"serving: {rec['errors']} requests rejected")
    _check_results("serving", rec["results"], rec["budgets"])
    _check_tick("serving", pe, captures=1)
    if not pe["prefix_hit_rate"] > 0:
        raise RuntimeError("serving: no prefix-cache hit")
    want = pe["decode_ticks"] * FULL_MODEL["num_layers"]
    print(f"serve: paged_flash_decode launches {launches} (stats "
          f"{pe['paged_decode_launches']}), decode_ticks x layers {want}")
    if not launches == pe["paged_decode_launches"] == want:
        raise RuntimeError("serving: the decode did not launch the kernel "
                           "once per layer per tick")
    return rec, launches


def phase_plain_replay(rec):
    """The same trace with the plain decode attention: first tokens must
    agree; returns the overall greedy agreement."""
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode

    before = paged_flash_decode.launches
    plain = _serve("plain")
    if paged_flash_decode.launches != before:
        raise RuntimeError("plain replay launched the kernel")
    if plain["errors"]:
        raise RuntimeError(f"plain replay: {plain['errors']} rejected")
    _check_tick("plain replay", plain["paged_engine"], captures=1)
    return _agreement(rec["results"], plain["results"], "plain replay")


#: phase 13's paged runs once the process is warm (phase 4 pays its
#: first-use costs inside its prefill): the tick eager and graphed in turns
EAGER_AB = (False, True, True, False)


@functools.cache
def _full_width():
    """Phase 4's model (seed 0), trace and paged capacity, built once for
    the engines of phases 13 and 18-20."""
    from distributed_deep_learning_tpu_torch.serve.bench import (
        DEFAULT_LOAD, build_model, paged_max_len)
    from distributed_deep_learning_tpu_torch.serve.load import (LoadSpec,
                                                                make_load)

    model = build_model(0, "cuda", **FULL_MODEL)
    trace = make_load(LoadSpec(**{**DEFAULT_LOAD, **FULL_LOAD}),
                      vocab_size=model.vocab_size, seed=0)
    return model, trace, paged_max_len(model.max_len,
                                       FULL_ENGINE["kv_block_size"])


def _replay_ms(graph, reps=50):
    """Device ms of one replay of a captured tick: ``reps`` replays back to
    back between CUDA events, on the tick's last staged inputs (the K/V
    writes repeat in place).  A replay is enqueued in microseconds, so the
    events time the card alone."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _engine_lifetime(make, trace, label, graphed=True):
    """One engine's lifetime over ``trace``: ``make()`` builds it, its tick
    graphed or eager (``DecodeTick.graphed``).  Returns the run's output
    and, graphed, the device ms of a replay of its captured tick.  The
    device memory allocated before the engine is built and after it is
    dropped (no cyclic collection between) must agree within a tenth of
    its KV cache: a dropped engine frees its caches and its graph."""
    import torch

    before = torch.cuda.memory_allocated()
    engine = make()
    engine._tick.graphed = graphed
    out = engine.run(trace)
    replay = _replay_ms(engine._tick._graph) if graphed else None
    kv = engine.kv_cache_bytes
    del engine
    after = torch.cuda.memory_allocated()
    print(f"{label}: device memory allocated {before / 2**20:.1f} MiB "
          f"before the engine, {after / 2**20:.1f} MiB after it is dropped "
          f"(its KV cache {kv / 2**20:.1f} MiB)")
    if after - before > kv / 10:
        raise RuntimeError(f"{label}: a dropped engine kept "
                           f"{(after - before) / 2**20:.1f} MiB")
    return out, replay


def _print_replay(name, replay, stats):
    print(f"graphed tick [{name}]: {replay:.3f} ms on the card a replay, "
          f"{_tick_ms(stats):.3f} ms a tick on the host clock (replay / "
          f"host tick {replay / _tick_ms(stats):.1%}: an estimate from "
          "back-to-back replays on fixed inputs, not a trace)")


def phase_eager_replay(rec):
    """Phase 13: phase 4's trace through ``PagedEngine`` with the decode
    tick eager and graphed in turns (``EAGER_AB``); every run's greedy
    tokens must be phase 4's, request for request, and its kernel
    launches one per layer per tick.  Each graphed run, and a slot engine
    on the same trace, then replays its captured tick alone; every engine
    must free its device memory when dropped."""
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode
    from distributed_deep_learning_tpu_torch.serve.engine import (
        PagedEngine, ServeEngine)

    model, trace, cap = _full_width()
    runs = {"graphed": [], "eager": []}
    for graphed in EAGER_AB:
        name = "graphed" if graphed else "eager"
        paged_flash_decode.launches = 0
        r, replay = _engine_lifetime(
            lambda: PagedEngine(model, max_len=cap, **FULL_ENGINE), trace,
            f"graph vs eager [{name}]", graphed=graphed)
        launches, pe = paged_flash_decode.launches, r["stats"]
        if r["errors"]:
            raise RuntimeError(f"{name} replay: {r['errors']} rejected")
        _check_tick(f"{name} replay", pe, captures=int(graphed))
        want = pe["decode_ticks"] * FULL_MODEL["num_layers"]
        if not launches == pe["paged_decode_launches"] == want:
            raise RuntimeError(f"{name} replay: {launches} kernel launches,"
                               f" expected {want}")
        differ = [uid for uid, toks in rec["results"].items()
                  if list(r["results"][uid]) != toks]
        if differ:
            raise RuntimeError(f"graph vs eager: {name} requests {differ} "
                               "differ from phase 4's")
        runs[name].append(pe)
        if graphed:
            _print_replay("paged", replay, pe)
    print(f"graph vs eager: greedy tokens identical to phase 4's for all "
          f"{len(rec['results'])} requests in {len(EAGER_AB)} runs, one "
          "launch per layer per tick in each")
    for name, rs in runs.items():
        for r in rs:
            lat = r["latency"]
            print(f"graph vs eager [{name}]: {r['tokens_per_sec']:.1f} "
                  f"tok/s, tick {_tick_ms(r):.3f} ms, itl p50 "
                  f"{lat['itl_p50_s']:.5f} s p99 {lat['itl_p99_s']:.5f} s, "
                  f"ttft p50 {lat['ttft_p50_s']:.4f} s p99 "
                  f"{lat['ttft_p99_s']:.4f} s, decode "
                  f"{r['decode_seconds']:.3f} s, prefill "
                  f"{r['prefill_seconds']:.3f} s")
    slot, replay = _engine_lifetime(
        lambda: ServeEngine(model, max_slots=FULL_ENGINE["max_slots"]),
        trace, "slot engine")
    _print_replay("slot", replay, slot["stats"])


def phase_slot_engine(rec):
    """Phase 14: the slot engine's leg of phase 4's bench call."""
    v1, pe = rec.get("engine_v1"), rec["paged_engine"]
    if v1 is None:
        raise RuntimeError("slot engine: phase 4 ran without its "
                           "comparison leg")
    if v1["errors"]:
        raise RuntimeError(f"slot engine: {v1['errors']} rejected")
    _check_results("slot engine", rec["results_v1"], rec["budgets"])
    _check_tick("slot engine", v1, captures=1)
    _agreement(rec["results"], rec["results_v1"], "slot vs paged")
    for name, r in (("paged", pe), ("slot", v1)):
        print(f"slot vs paged [{name}]: {r['tokens_per_sec']:.1f} tok/s, "
              f"tick {_tick_ms(r):.3f} ms over {r['decode_ticks']} ticks, "
              f"prefill {r['prefill_seconds']:.3f} s | {_latency_text(r)}")
    print(f"slot vs paged: speedup_vs_v1 {rec['speedup_vs_v1']:.3f}, "
          f"prefill tokens computed paged "
          f"{pe['paged']['prefill_tokens_computed']} vs slot "
          f"{v1['prefill_tokens_computed']} (saved fraction "
          f"{rec['prefill_tokens_saved_frac']:.4f})")


# --- phases 6 and 7: the flash-attention kernels ---------------------------

#: the training path's attention shape: 4 rows of 2048 tokens, 12 heads of 64
TRAIN_SHAPE = dict(B=4, H=12, Hkv=12, Tq=2048, Tk=2048, D=64)
#: the shapes phases 25-26 and 30 drive, each timed against SDPA:
#: BERT-base's (padded keys, a fully padded row), the seq2seq
#: cross-attention's (Tk = Tq - 1, as an odd tokens.npy row gives it), the
#: synthetic twins' T 32, and moe's 4 heads of 64 on the MLM twin (b 32 of
#: 64 ids, no pads) and on the BERT rows (b 8 of 512, ragged pad tails),
#: each in f32 and bf16
ZOO_FLASH_CASES = [
    ("noncausal_bf16", {"causal": False, "dtype": "bf16"}),
    *((f"bert_shape_{dt}", {"B": 8, "H": 12, "Hkv": 12, "Tq": 512,
                            "Tk": 512, "causal": False, "pad": 300,
                            "dtype": dt}) for dt in ("f32", "bf16")),
    *((f"seq2seq_cross_{dt}", {"B": 8, "H": 8, "Hkv": 8, "Tq": 256,
                               "Tk": 255, "causal": False, "pad": 100,
                               "dtype": dt}) for dt in ("f32", "bf16")),
    *((f"short_t32_{kind}_{dt}", {"B": 4, "H": 8, "Hkv": 8, "Tq": 32,
                                  "Tk": 32, "causal": kind == "causal",
                                  "pad": 10, "dtype": dt})
      for kind in ("causal", "noncausal") for dt in ("f32", "bf16")),
    *((f"moe_mlm_{dt}", {"B": 32, "H": 4, "Hkv": 4, "Tq": 64, "Tk": 64,
                         "causal": False, "dtype": dt})
      for dt in ("f32", "bf16")),
    *((f"moe_bert_rows_{dt}", {"B": 8, "H": 4, "Hkv": 4, "Tq": 512,
                               "Tk": 512, "causal": False, "pad": 300,
                               "dtype": dt}) for dt in ("f32", "bf16")),
]
ZOO_NAMES = {name for name, _ in ZOO_FLASH_CASES}
FLASH_CASES = [
    ("f32", {}),
    ("bf16", {"dtype": "bf16"}),
    ("padding", {"pad": True}),
    ("gqa_hkv4", {"Hkv": 4}),
    ("window_256", {"window": 256}),
    ("ragged_t2000", {"Tq": 2000, "Tk": 2000}),
    ("cross_non_causal", {"Tq": 256, "causal": False}),
    # ring attention's visiting blocks (phase 32): a query offset, with
    # and without a window; rows the band leaves empty are not compared
    *((f"q_offset_window_{dt}", {"q_offset": 2048, "window": 1024,
                                 "dtype": dt}) for dt in ("f32", "bf16")),
    *((f"q_offset_{dt}", {"q_offset": 512, "dtype": dt})
      for dt in ("f32", "bf16")),
    # every other head dim is a tile of its own: small shapes, both dtypes
    *((f"d{d}_{dt}", {"B": 1, "H": 2, "Hkv": 2, "Tq": 512, "Tk": 512,
                      "D": d, "dtype": dt})
      for d in (16, 32, 128) for dt in ("f32", "bf16")),
    *ZOO_FLASH_CASES,
]
#: (O and LSE max abs error, gradients' max abs error / max |reference|)
FLASH_TOL = {"f32": (1e-4, 1e-3), "bf16": (2e-2, 2e-2)}


def _flash_case(*, B, H, Hkv, Tq, Tk, D, causal=True, window=None,
                dtype="f32", pad=False, seed=0, q_offset=0):
    """Seeded q, k, v, key_valid and dO on the card.  ``pad``: rows 1 and
    2 lose their last ``pad`` keys (300 for True), row 3 all of them;
    ``q_offset`` shifts the queries' positions (ring attention's hops)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q = torch.randn(B, Tq, H, D, generator=gen)
    k = torch.randn(B, Tk, Hkv, D, generator=gen)
    v = torch.randn(B, Tk, Hkv, D, generator=gen)
    do = torch.randn(B, Tq, H, D, generator=gen)
    valid = torch.ones(B, Tk, dtype=torch.bool)
    if pad:
        valid[1:3, Tk - (300 if pad is True else pad):] = False
        valid[3] = False
    q, k, v, do = (x.to(dt).cuda() for x in (q, k, v, do))
    kw = dict(causal=causal, sm_scale=D ** -0.5, window=window)
    if q_offset:
        kw["q_offset"] = q_offset
    return q, k, v, valid.cuda(), do, kw


def _visible_pairs(q, k, valid, causal, window, q_offset=0):
    """(query, key) pairs the mask leaves visible, over every head."""
    import torch

    Tq, H, Tk = q.shape[1], q.shape[2], k.shape[1]
    qp = torch.arange(Tq, device=q.device)[:, None] + q_offset
    kp = torch.arange(Tk, device=q.device)[None, :]
    band = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
    if causal:
        band = qp >= kp
        if window is not None:
            band = band & (qp - kp < window)
    if valid is None:
        return int(band.sum()) * q.shape[0] * H
    return int((band[None] & valid[:, None, :]).sum()) * H


#: each kernel's operations per visible pair per head dim: the forward's
#: two products, dQ's three (its recomputed QK^T, dO.V^T and dS.K), dK/dV's
#: four
FLASH_PAIR_OPS = {"flash_forward": 4, "flash_backward_dq": 6,
                  "flash_backward_dkv": 8}


def _flash_bounds(q, k, valid, kw):
    """Least time of each kernel for these inputs: the larger of its bytes
    (each input read once, each output written once) over HBM and its
    flops on the visible (query, key) pairs over the dtype's peak: bf16's
    tensor-core rate, and for f32 three TF32 products (3xTF32, the only
    way the tensor cores keep f32 accuracy) at the TF32 rate.  Also
    returns, for f32, the same flops on the f32 units."""
    import torch

    B, Tq, H, D = q.shape
    pairs = _visible_pairs(q, k, valid, kw["causal"], kw["window"])
    item = q.element_size()
    q_el, kv_el, rows = q.numel(), k.numel(), B * H * Tq
    extra = valid.numel()                                # key_valid bytes
    work = {   # kernel: (bytes, flops)
        "flash_forward": ((2 * q_el + 2 * kv_el) * item + 4 * rows + extra,
                          FLASH_PAIR_OPS["flash_forward"] * D * pairs),
        "flash_backward_dq": ((3 * q_el + 2 * kv_el) * item + 8 * rows
                              + extra,
                              FLASH_PAIR_OPS["flash_backward_dq"] * D
                              * pairs),
        "flash_backward_dkv": ((2 * q_el + 4 * kv_el) * item + 8 * rows
                               + extra,
                               FLASH_PAIR_OPS["flash_backward_dkv"] * D
                               * pairs),
    }
    rate = BF16_FLOPS_PER_S if item == 2 else TF32_FLOPS_PER_S / 3
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = flops / rate * 1e3
        f32_units = (None if item == 2 else
                     max(t_bytes, flops / F32_FLOPS_PER_S * 1e3))
        out[name] = (max(t_bytes, t_flops),
                     "bytes" if t_bytes >= t_flops else "operations",
                     f32_units)
    return out


def _flash_timings(q, k, v, valid, do, kw):
    """Median cold-L2 ms of each kernel, its plain version and SDPA, and
    of ``delta`` (the backward's one torch op besides the kernels)."""
    import torch
    import torch.nn.functional as F

    from distributed_deep_learning_tpu_torch.ops import attention as fa

    out, lse = fa.flash_forward(q, k, v, valid, **kw)
    delta = fa._delta(out, do)
    ms = {
        "flash_forward": _time_ms(
            lambda: fa.flash_forward(q, k, v, valid, **kw)),
        "flash_backward_dq": _time_ms(lambda: fa.flash_backward_dq(
            q, k, v, valid, do, lse, delta, **kw)),
        "flash_backward_dkv": _time_ms(lambda: fa.flash_backward_dkv(
            q, k, v, valid, do, lse, delta, **kw)),
        "delta": _time_ms(lambda: fa._delta(out, do)),
    }
    plain_fwd = _time_ms(lambda: fa.flash_attention_reference(
        q, k, v, key_valid=valid, **kw), reps=5)
    plain_bwd = _time_ms(lambda: fa.flash_backward_reference(
        q, k, v, valid, out, lse, do, **kw), reps=5)
    qs, ks, vs, dos = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qs.requires_grad_(True)
    ks.requires_grad_(True)
    vs.requires_grad_(True)
    # the case's masking: causal, and padded keys as a boolean mask (which
    # takes SDPA off its flash backend; a fully padded row gives NaN there,
    # which only the timing sees)
    sdpa_kw = dict(is_causal=kw["causal"])
    if not bool(valid.all()):
        sdpa_kw = dict(attn_mask=valid[:, None, None, :] if not kw["causal"]
                       else valid[:, None, None, :] & torch.ones(
                           q.shape[1], k.shape[1], dtype=torch.bool,
                           device=q.device).tril())

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qs, ks, vs, **sdpa_kw)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qs, ks, vs, **sdpa_kw)
        return torch.autograd.grad(o, (qs, ks, vs), dos)

    lib_fwd = _time_ms(sdpa_fwd)
    lib_bwd = _time_ms(sdpa_fwd_bwd) - lib_fwd
    plain_bwd = {"flash_backward_dq": plain_bwd,
                 "flash_backward_dkv": plain_bwd, "backward": plain_bwd}
    return ms, {"flash_forward": plain_fwd, **plain_bwd}, {
        "flash_forward": lib_fwd, "flash_backward_dq": lib_bwd,
        "flash_backward_dkv": lib_bwd, "backward": lib_bwd}


def flash_costs() -> dict:
    """Each flash kernel's ms (:func:`_time_ms`) at the training shape, f32
    and bf16, from whichever copy of the package is first on
    ``sys.path``, so a parent commit's kernels are timed the same way::

        python3 -c "import sys, chip_smoke; sys.path.insert(0,
            'build/parent'); print(chip_smoke.flash_costs())"
    """
    from distributed_deep_learning_tpu_torch.ops import attention as fa

    out = {}
    for name, spec in (("f32", {}), ("bf16", {"dtype": "bf16"})):
        q, k, v, valid, do, kw = _flash_case(seed=len(name),
                                             **{**TRAIN_SHAPE, **spec})
        o, lse = fa.flash_forward(q, k, v, valid, **kw)
        delta = fa._delta(o, do)
        out[name] = {
            "flash_forward": _time_ms(
                lambda: fa.flash_forward(q, k, v, valid, **kw)),
            "flash_backward_dq": _time_ms(lambda: fa.flash_backward_dq(
                q, k, v, valid, do, lse, delta, **kw)),
            "flash_backward_dkv": _time_ms(lambda: fa.flash_backward_dkv(
                q, k, v, valid, do, lse, delta, **kw))}
    return out


def _seen_rows(q, k, valid, kw):
    """``(B, Tq)``: the queries whose band holds a valid key."""
    import torch

    qp = torch.arange(q.shape[1], device=q.device)[:, None] \
        + kw.get("q_offset", 0)
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    band = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                      device=q.device)
    if kw["causal"]:
        band = qp >= kp
        if kw["window"] is not None:
            band = band & (qp - kp < kw["window"])
    return (band[None] & valid[:, None, :]).any(-1)


def phase_flash_kernels():
    """Every case against the plain versions; timings of the f32 and bf16
    main cases.  Returns ``{dtype: {kernel: record}}``."""
    import torch

    from distributed_deep_learning_tpu_torch.ops import attention as fa

    records, zoo = {}, {}
    for name, spec in FLASH_CASES:
        q, k, v, valid, do, kw = _flash_case(seed=len(name),
                                             **{**TRAIN_SHAPE, **spec})
        out, lse = fa.flash_forward(q, k, v, valid, **kw)
        dq, dk, dv = fa.flash_backward(q, k, v, valid, out, lse, do, **kw)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v,
                                                        key_valid=valid, **kw)
        ref = fa.flash_backward_reference(q, k, v, valid, out, lse, do, **kw)
        live = valid.any(1)              # rows with at least one key
        seen = _seen_rows(q, k, valid, kw)   # (row, query) with a key
        if not bool(torch.isfinite(out.float()).all()):
            raise RuntimeError(f"flash case {name}: non-finite output")
        err_o = float((out.float() - ref_out.float())[seen].abs().max())
        err_lse = float((lse - ref_lse).transpose(1, 2)[seen].abs().max())
        errs = {}
        for gname, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            diff = float((got.float() - want.float()).abs().max())
            errs[gname] = (diff, diff / max(float(want.float().abs().max()),
                                            1e-30))
        tol_o, tol_g = FLASH_TOL[spec.get("dtype", "f32")]
        print(f"flash {name}: O {err_o:.3e} LSE {err_lse:.3e} (tol "
              f"{tol_o:g}); dq/dk/dv rel "
              + "/".join(f"{r:.2e}" for _, r in errs.values())
              + f" (tol {tol_g:g})")
        if not (err_o <= tol_o and err_lse <= tol_o
                and all(r <= tol_g for _, r in errs.values())):
            raise RuntimeError(f"flash case {name}: kernel disagrees with "
                               "its plain version")
        if spec.get("pad"):
            zero = all(bool((g[~live] == 0).all()) for g in (dq, dk, dv))
            print(f"flash {name}: fully padded row finite, gradients "
                  f"exactly zero: {zero}")
            if not zero:
                raise RuntimeError("fully padded row: non-zero gradients")
        if name in ZOO_NAMES:
            ms, plain, lib = _flash_timings(q, k, v, valid, do, kw)
            bounds = _flash_bounds(q, k, valid, kw)
            zoo[name] = {kn: ms[kn] for kn in FLASH_PAIR_OPS}
            zoo[name]["sdpa_fwd"] = lib["flash_forward"]
            zoo[name]["sdpa_bwd"] = lib["backward"]
            total = (ms["delta"] + ms["flash_backward_dq"]
                     + ms["flash_backward_dkv"])
            bwd_bound = (bounds["flash_backward_dq"][0]
                         + bounds["flash_backward_dkv"][0])
            print(f"flash {name} timing: forward {ms['flash_forward']:.4f} "
                  f"ms (sdpa {lib['flash_forward']:.4f}, plain "
                  f"{plain['flash_forward']:.4f}, bound "
                  f"{bounds['flash_forward'][0]:.4f} "
                  f"{bounds['flash_forward'][1]}); backward delta + dq + dkv "
                  f"{ms['delta']:.4f} + {ms['flash_backward_dq']:.4f} + "
                  f"{ms['flash_backward_dkv']:.4f} = {total:.4f} ms (sdpa "
                  f"{lib['backward']:.4f}, plain {plain['backward']:.4f}, "
                  f"bound {bwd_bound:.4f})")
        if name in ("f32", "bf16"):
            ms, plain, lib = _flash_timings(q, k, v, valid, do, kw)
            bounds = _flash_bounds(q, k, valid, kw)
            abs_err = {"flash_forward": max(err_o, err_lse),
                       "flash_backward_dq": errs["dq"][0],
                       "flash_backward_dkv": max(errs["dk"][0],
                                                 errs["dv"][0])}
            records[name] = {}
            for kname in abs_err:
                rec = dict(max_abs_err=abs_err[kname], ms=ms[kname],
                           plain_ms=plain[kname], bound_ms=bounds[kname][0],
                           bound_by=bounds[kname][1],
                           library_ms=lib[kname])
                records[name][kname] = rec
                f32_units = bounds[kname][2]
                print(f"flash {name} {kname}: kernel {rec['ms']:.4f} ms, "
                      f"plain {rec['plain_ms']:.4f} ms, sdpa "
                      f"{rec['library_ms']:.4f} ms, bound "
                      f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}"
                      + (", 3xTF32" if f32_units else "") + "), "
                      f"{rec['bound_ms'] / rec['ms']:.1%} of bound"
                      + (f"; f32-unit bound {f32_units:.4f} ms"
                         if f32_units else ""))
            total = (ms["delta"] + ms["flash_backward_dq"]
                     + ms["flash_backward_dkv"])
            bound = (bounds["flash_backward_dq"][0]
                     + bounds["flash_backward_dkv"][0])
            print(f"flash {name} backward total: delta {ms['delta']:.4f} + "
                  f"dq {ms['flash_backward_dq']:.4f} + dkv "
                  f"{ms['flash_backward_dkv']:.4f} = {total:.4f} ms vs sdpa "
                  f"backward {lib['backward']:.4f} ms "
                  f"({total / lib['backward']:.2f}x), plain "
                  f"{plain['backward']:.4f} ms, kernels' bound "
                  f"{bound:.4f} ms")
    records["zoo"] = zoo
    return records


# --- phases 8 and 9: training through the CLI -------------------------------

TRAIN_ROWS, TRAIN_T, TRAIN_VOCAB, TRAIN_BATCH, TRAIN_LAYERS = \
    48, 2048, 32768, 4, 12
#: phase 15's decode shape, held against the plain version in phase 3: the
#: CLI's paged engine on the model trained at T 2048 (max_len 2048, so 128
#: blocks of 16 a slot, pools of 2 x 8 x 128 blocks and the trash block), 8
#: slots, bf16 queries and pools; the CLI trace's prompts of 2-8 tokens and
#: 1-16 new ones keep 2-24 positions live
SERVE_BF16_SHAPE = dict(DECODE_SHAPE, Bps=TRAIN_T // 16,
                        N=2 * 8 * (TRAIN_T // 16) + 1)
SERVE_BF16_LENS = (2, 24)


def _write_tokens() -> Path:
    """A seeded ``tokens.npy`` of +1 ramps over [1, vocab) (the synthetic
    LM rule); row 0 crosses id vocab-1, so ``lm_dataset`` finds the whole
    vocabulary."""
    import numpy as np

    rng = np.random.default_rng(0)
    start = rng.integers(1, TRAIN_VOCAB, size=(TRAIN_ROWS, 1))
    start[0, 0] = TRAIN_VOCAB - 100
    ramp = np.arange(TRAIN_T + 1)[None, :]
    rows = ((start - 1 + ramp) % (TRAIN_VOCAB - 1) + 1).astype(np.int32)
    assert rows.max() == TRAIN_VOCAB - 1 and rows.min() >= 1
    out = ROOT / "build" / "chip_smoke_tokens"
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "tokens.npy", rows)
    return out


@contextlib.contextmanager
def _launch_dtypes():
    """Count the flash kernels' launches by (launcher, input dtype) while
    the block runs."""
    from distributed_deep_learning_tpu_torch.ops import attention as fa

    seen, real = collections.Counter(), fa._launch

    def counting(name, q, *args, **kw):
        seen[(name, str(q.dtype).replace("torch.", ""))] += 1
        return real(name, q, *args, **kw)

    fa._launch = counting
    try:
        yield seen
    finally:
        fa._launch = real


class _Tee:
    """A text stream that writes to stdout and keeps a copy."""

    def __init__(self):
        self.out, self.kept = sys.stdout, []

    def write(self, text):
        self.kept.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _train(data_dir: Path, attention: str, *flags, label=None,
           mode="sequential"):
    """One epoch through ``main(argv)``; returns the history, the flash
    kernels' launches during it (zeroed just before) and step time,
    tokens/s, peak device memory, the decode kernel's launches (zeroed
    just before: a post-train ``--serve --paged`` launches it), the run's
    log and what its post-train serving served (:func:`_served_runs`)."""
    import torch

    from distributed_deep_learning_tpu_torch.__main__ import main as cli
    from distributed_deep_learning_tpu_torch.ops import attention as fa
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode

    label = label or attention
    counters = (fa.flash_forward, fa.flash_backward_dq,
                fa.flash_backward_dkv)
    for c in counters + (paged_flash_decode,):
        c.launches = 0
    gc.collect()            # the previous run's model and optimizer
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tee = _Tee()
    with contextlib.redirect_stdout(tee), _served_runs() as served:
        state, hist = cli(["gpt", "-m", mode, "-l", str(TRAIN_LAYERS),
                           "-s", "768", "-e", "1", "-b", str(TRAIN_BATCH),
                           "--attention", attention, "--data-dir",
                           str(data_dir), *flags])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    from distributed_deep_learning_tpu_torch.parallel.zero import (
        optimizer_state_bytes, param_bytes)

    opt_state_bytes = optimizer_state_bytes(state.optimizer)
    params_bytes = param_bytes(state.model)
    del state
    peak = torch.cuda.max_memory_allocated()
    train = hist[0]
    losses = train.step_losses
    step_s = statistics.median(train.step_seconds[1:])
    tok_s = TRAIN_BATCH * TRAIN_T / step_s
    print(f"train[{label}]: {len(losses)} steps, losses "
          + " ".join(f"{x:.4f}" for x in losses))
    print(f"train[{label}]: {step_s:.4f} s/step (median of steps 2-"
          f"{len(losses)}), {tok_s:.1f} tokens/s, epoch loss "
          f"{train.loss:.9f}, accuracy {train.accuracy:.3f}, val loss "
          f"{hist[-2].loss:.9f}, test loss {hist[-1].loss:.9f}, peak memory "
          f"{peak / 2**30:.2f} GiB, {wall:.1f} s with model build")
    if not all(map(lambda x: x == x and abs(x) != float("inf"),
                   losses + [h.loss for h in hist])):
        raise RuntimeError(f"train[{label}]: a non-finite loss")
    return hist, launches, dict(step_s=step_s, tokens_per_s=tok_s, peak=peak,
                                decode_launches=paged_flash_decode.launches,
                                log="".join(tee.kept), served=served,
                                opt_state_bytes=opt_state_bytes,
                                param_bytes=params_bytes)


def split_steps(rows: int, batch: int) -> list[int]:
    """Train, validation and test steps of one epoch over ``rows``."""
    from distributed_deep_learning_tpu_torch.data.splits import \
        train_val_test_split

    return [len(s) // batch for s in train_val_test_split(rows, seed=42)]


def _phase_steps():
    """Train, validation and test steps of the smoke epoch."""
    return split_steps(TRAIN_ROWS, TRAIN_BATCH)


def expected_launches(attentions: int, steps, forward_per_train_step=1,
                      backward_per_step=1) -> dict:
    """Each flash kernel's launches in one epoch of ``steps`` (train, val,
    test) of a model with ``attentions`` flash attentions a step: a
    forward each (``forward_per_train_step`` each a train step), dQ and
    dK/dV each ``backward_per_step`` times a train step."""
    return {"flash_forward": int((forward_per_train_step * steps[0]
                                  + sum(steps[1:])) * attentions),
            "flash_backward_dq": backward_per_step * steps[0] * attentions,
            "flash_backward_dkv": backward_per_step * steps[0] * attentions}


def _expected_launches(forward_per_train_step=1, backward_per_step=1):
    return expected_launches(TRAIN_LAYERS, _phase_steps(),
                             forward_per_train_step, backward_per_step)


def _rel(a, b):
    return abs(a - b) / abs(b)


def phase_train_flash(data_dir: Path):
    hist, launches, perf = _train(data_dir, "flash")
    steps = _phase_steps()
    losses = hist[0].step_losses
    if len(losses) != steps[0]:
        raise RuntimeError(f"train: {len(losses)} steps, expected {steps[0]}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"train: loss did not fall ({losses[0]} -> "
                           f"{losses[-1]})")
    want = _expected_launches()
    print(f"train[flash]: launches {launches}, expected {want} "
          f"(train/val/test steps {steps} x {TRAIN_LAYERS} layers)")
    if launches != want:
        raise RuntimeError("train: a layer of a step did not go through "
                           "the flash kernels")
    return hist, launches, perf


def phase_train_dense(data_dir: Path, flash_hist, flash_perf):
    hist, launches, perf = _train(data_dir, "dense")
    if any(launches.values()):
        raise RuntimeError(f"dense run launched flash kernels: {launches}")
    first = (hist[0].step_losses[0], flash_hist[0].step_losses[0])
    epoch = (hist[0].loss, flash_hist[0].loss)
    rel_first = abs(first[0] - first[1]) / abs(first[1])
    rel_epoch = abs(epoch[0] - epoch[1]) / abs(epoch[1])
    print(f"dense vs flash: first step loss rel diff {rel_first:.2e} (tol "
          f"1e-4), epoch train loss rel diff {rel_epoch:.2e} (tol 1e-2); "
          f"tokens/s dense {perf['tokens_per_s']:.1f} vs flash "
          f"{flash_perf['tokens_per_s']:.1f}; peak memory dense "
          f"{perf['peak'] / 2**30:.2f} GiB vs flash "
          f"{flash_perf['peak'] / 2**30:.2f} GiB")
    if not (rel_first <= 1e-4 and rel_epoch <= 1e-2):
        raise RuntimeError("dense and flash training disagree")


# --- phases 10-12: bf16, -m data, remat, accumulation, checkpoints ---------


#: phase 15's post-train flags on phase 10's and phase 11's runs
SERVE_PAGED_FLAGS = ("--generate", "16", "--serve", "--paged",
                     "--prefill-chunk", "64")
SERVE_SLOT_FLAGS = ("--serve",)


def phase_train_bf16(data_dir: Path, f32_hist, serve=False):
    """Phase 10: phase 8's run in bf16, every launch on the bf16
    instantiations; ``serve``: with phase 15's post-train flags."""
    with _launch_dtypes() as seen:
        hist, launches, perf = _train(
            data_dir, "flash", "--dtype", "bfloat16",
            *(SERVE_PAGED_FLAGS if serve else ()), label="bf16")
    served = perf.pop("served")
    if serve:
        perf["served"] = _hold_served(served, "post-train [bf16 serve "
                                              "--paged]")
    losses = hist[0].step_losses
    want = _expected_launches()
    print(f"train[bf16]: launches {launches}, expected {want}; by launcher "
          f"and dtype {dict(sorted(seen.items()))}")
    if launches != want or {dt for _, dt in seen} != {"bfloat16"} \
            or sum(seen.values()) != sum(launches.values()):
        raise RuntimeError("train[bf16]: a layer of a step did not go "
                           "through the bf16 flash kernels")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"train[bf16]: loss did not fall ({losses[0]} "
                           f"-> {losses[-1]})")
    if f32_hist is not None:
        rel = _rel(losses[0], f32_hist[0].step_losses[0])
        print(f"bf16 vs f32: first step loss rel diff {rel:.2e} (tol 2e-2)")
        if not rel <= 2e-2:
            raise RuntimeError("bf16 and f32 training disagree")
    return hist, launches, perf


#: ``--grad-accum 2`` against the plain ``-m data`` run, each train step's
#: loss (relative): the same tokens (none padded, so the mean of the
#: microbatch means is the batch mean) through GEMMs of half the rows
ACCUM_STEP_TOL = 1e-4


@contextlib.contextmanager
def _planted_half_batch():
    """A planted fault: every second train-mode loss (the second
    microbatch of each step) keeps its value but sends a zero gradient,
    so the update sees half the batch.  Phase 11's check of
    ``--grad-accum 2`` must fail under it."""
    import torch

    from distributed_deep_learning_tpu_torch.train.objectives import \
        TokenCrossEntropy

    real, calls = TokenCrossEntropy.__call__, [0]

    def planted(self, pred, y):
        loss = real(self, pred, y)
        if not torch.is_grad_enabled():
            return loss
        calls[0] += 1
        return loss if calls[0] % 2 else loss.detach() + 0.0 * loss

    TokenCrossEntropy.__call__ = planted
    try:
        yield
    finally:
        TokenCrossEntropy.__call__ = real


def phase_data_parallel(data_dir: Path, bf16_hist, bf16_perf, serve=False):
    """Phase 11: ``-m data`` at world 1 on NCCL, plain (``serve``: with
    phase 15's post-train flag), ``--remat`` under the policies
    ``nothing`` and ``dots`` (the flash Function inside a selective
    checkpoint), and ``--grad-accum 2``."""
    import torch.distributed as dist

    bf16 = ("--dtype", "bfloat16")
    plain, launches, perf = _train(
        data_dir, "flash", *bf16, *(SERVE_SLOT_FLAGS if serve else ()),
        label="data bf16", mode="data")
    served = perf.pop("served")
    if serve:
        perf["served"] = _hold_served(served, "post-train [data bf16 serve]")
    if dist.is_initialized():
        raise RuntimeError("-m data left its process group behind")
    if launches != _expected_launches():
        raise RuntimeError(f"train[data bf16]: launches {launches}")
    first = plain[0].step_losses[0]
    if bf16_hist is not None:
        rel = _rel(first, bf16_hist[0].step_losses[0])
        print(f"data vs sequential (bf16): first step loss rel diff "
              f"{rel:.2e} (tol 1e-6); tokens/s {perf['tokens_per_s']:.1f} "
              f"vs {bf16_perf['tokens_per_s']:.1f}")
        if not rel <= 1e-6:
            raise RuntimeError("-m data and -m sequential disagree")
    remat_perf = {}
    for policy in ("nothing", "dots"):
        label = "data bf16 remat" + ("" if policy == "nothing"
                                     else f" {policy}")
        remat, r_launches, r_perf = _train(
            data_dir, "flash", *bf16, "--remat", "--remat-policy", policy,
            label=label, mode="data")
        want = _expected_launches(forward_per_train_step=2)
        rel = _rel(remat[0].step_losses[0], first)
        print(f"remat {policy}: launches {r_launches}, expected {want}; "
              f"first step loss rel diff {rel:.2e} (tol 1e-6); peak memory "
              f"{r_perf['peak'] / 2**30:.2f} GiB vs "
              f"{perf['peak'] / 2**30:.2f} GiB without remat and "
              + (f"{bf16_perf['peak'] / 2**30:.2f} GiB in phase 10"
                 if bf16_perf else "phase 10 not run"))
        if r_launches != want or not rel <= 1e-6:
            raise RuntimeError(f"--remat --remat-policy {policy}: wrong "
                               "launches or a different loss")
        remat_perf[policy] = r_perf
    want = _expected_launches(forward_per_train_step=2, backward_per_step=2)
    ref = bf16_hist if bf16_hist is not None else plain
    passed = {}
    for planted in (False, True):
        label = "data bf16 grad-accum 2" + (" planted" if planted else "")
        with _planted_half_batch() if planted else contextlib.nullcontext():
            accum, a_launches, _ = _train(data_dir, "flash", *bf16,
                                          "--grad-accum", "2", label=label,
                                          mode="data")
        rel = _rel(accum[0].loss, ref[0].loss)
        steps = [_rel(a, b) for a, b in zip(accum[0].step_losses,
                                             plain[0].step_losses)]
        print(f"{label}: launches {a_launches}, expected {want}; epoch loss "
              f"rel diff {rel:.2e} from phase 10's (tol 1e-2); per-step "
              "loss rel diff from the plain -m data run "
              + " ".join(f"{x:.2e}" for x in steps)
              + f" (tol {ACCUM_STEP_TOL:.0e} each)")
        passed[planted] = (a_launches == want and rel <= 1e-2
                         and max(steps) <= ACCUM_STEP_TOL)
    if not passed[False]:
        raise RuntimeError("--grad-accum 2: wrong launches, epoch loss or "
                           "step losses")
    if passed[True]:
        raise RuntimeError("--grad-accum 2: the check passed a planted "
                           "fault (the second microbatch's gradient "
                           "dropped)")
    return perf, remat_perf


# --- phase 15: serving after training, through the CLI ---------------------

_GENERATE_LINE = re.compile(r'"generate prompt=\[([\d, ]+)\] '
                            r'continuation=\[([\d, ]*)\]"')
_SERVE_PAGED_LINE = re.compile(
    r'"serve\(paged\): (\d+) requests, (\d+) tokens at ([\d.]+) tok/s, '
    r'prefix hit ([\d.]+), cow (\d+), decode captures=(\d+) ticks=(\d+) '
    r'launches=(\d+)')
_SERVE_SLOT_LINE = re.compile(
    r'"serve: (\d+) requests, (\d+) tokens at ([\d.]+) tok/s, occupancy '
    r'([\d.]+)/(\d+), decode captures=(\d+) ticks=(\d+)"')
#: the CLI's serve trace: max(2 x --max-slots, 8) requests
SERVE_REQUESTS = 16


def _one(pattern, log, label):
    found = pattern.findall(log)
    if len(found) != 1:
        raise RuntimeError(f"{label}: {len(found)} matching log lines")
    return [float(x) for x in found[0]]


#: a served greedy token against the plain forward on its own prefix: the
#: reference's top logit minus the token's, over the row's max|logit|, at
#: most one bf16 step (2^-8).  The tests' 2e-2 near-tie rule is too loose
#: here: 8 steps on uniform random ids leave logits whose top tokens crowd
#: within 1% of max|logit|, so any token near the top would pass it.
SERVE_GAP_TOL = 2.0 ** -8


@contextlib.contextmanager
def _served_runs():
    """Record what each engine ``run`` serves while the block runs: the
    engine's class, its model and geometry, the trace and the output (not
    the engine, so its caches go when its caller drops it)."""
    from distributed_deep_learning_tpu_torch.serve.engine import (
        PagedEngine, ServeEngine)

    runs, real = [], {cls: cls.run for cls in (PagedEngine, ServeEngine)}

    def recording(cls):
        def run(self, requests, *args, **kw):
            requests = list(requests)
            out = real[cls](self, requests, *args, **kw)
            geometry = dict(max_slots=self.max_slots, max_len=self.max_len)
            if cls is PagedEngine:
                geometry.update(
                    kv_block_size=self.block_size, num_blocks=self.num_blocks,
                    prefill_chunk=self.chunk,
                    blocks_per_slot=self.blocks_per_slot,
                    kv_dtype=str(self.pools[0]["cached_key"].dtype))
            runs.append(dict(engine=cls.__name__, model=self.model,
                             requests=requests, out=out, geometry=geometry))
            return out
        return run

    for cls in real:
        cls.run = recording(cls)
    try:
        yield runs
    finally:
        for cls, fn in real.items():
            cls.run = fn


def served_margins(model, requests, results):
    """Hold served greedy tokens against ``model``'s plain cached forward
    of each request's prompt and tokens in one call, position by position
    on the served prefix (so one flipped near-tie does not part the rest of
    a stream).  Returns the worst gap (the reference's top logit minus the
    served token's, over the row's max|logit|; 0 where the token is the
    reference's argmax) and the fraction of tokens with gap 0."""
    import numpy as np
    import torch

    dev = next(model.parameters()).device
    worst, same, total = 0.0, 0, 0
    with torch.no_grad():
        for r in requests:
            toks = torch.as_tensor(np.asarray(results[r.uid]),
                                   device=dev).long()
            seq = torch.cat([torch.as_tensor(np.asarray(r.prompt),
                                             device=dev).long(), toks[:-1]])
            hidden = model.cached_forward(
                seq[None], model.init_cache(1, seq.shape[0]))
            logits = model.logits_from(hidden[0, len(r.prompt) - 1:])
            scale = logits.abs().amax(-1)
            if model.pad_id is not None:       # never picked by an engine
                logits[:, model.pad_id] = -torch.inf
            top = logits.amax(-1)
            gap = (top - logits.gather(1, toks[:, None])[:, 0]) / scale
            worst = max(worst, float(gap.max()))
            same += int((gap == 0).sum())
            total += toks.numel()
    return worst, same / total


def _slots_swapped(q, k, v, tables, seq_lens, **kw):
    """A planted decode fault: the plain decode attention with each slot
    reading the next slot's blocks and length (a staging mix-up)."""
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_decode_reference

    return paged_decode_reference(q, k, v, tables.roll(1, 0),
                                  seq_lens.roll(1, 0), **kw)


def _hold_served(runs, label):
    """Phase 15's hold on what one post-train CLI run served (recorded by
    :func:`_served_runs`): no request rejected, every budget met, tokens in
    [1, vocab), each greedy token within ``SERVE_GAP_TOL`` of the plain
    forward's argmax on its prefix (:func:`served_margins`).  For the
    paged engine also: its geometry is phase 3's ``bf16_serve`` case, and
    the trace replayed with the plain decode attention gives the same
    first tokens (the greedy agreement printed) and gaps within the
    limit, while a planted fault (:func:`_slots_swapped`) must break
    it.  Returns a summary for phase 15's report."""
    import torch

    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode
    from distributed_deep_learning_tpu_torch.serve.engine import PagedEngine

    if len(runs) != 1:
        raise RuntimeError(f"{label}: {len(runs)} serving runs recorded")
    run = runs.pop()
    model, reqs, out, geo = (run[k] for k in ("model", "requests", "out",
                                              "geometry"))
    if out["errors"]:
        raise RuntimeError(f"{label}: {out['errors']} rejected")
    _check_results(label, out["results"], {r.uid: r.max_new_tokens
                                           for r in reqs},
                   vocab=model.vocab_size)
    gap, agree = served_margins(model, reqs, out["results"])
    print(f"{label}: {run['engine']} {geo}; greedy tokens against the "
          f"plain forward on their prefix: worst gap {gap:.3e} of "
          f"max|logit| (tol {SERVE_GAP_TOL:g}), argmax agreement "
          f"{agree:.4f}")
    if not gap <= SERVE_GAP_TOL:
        raise RuntimeError(f"{label}: a served token {gap:.3e} of "
                           "max|logit| below the reference's argmax")
    summary = dict(engine=run["engine"], gap=gap, agreement=agree)
    if run["engine"] != "PagedEngine":
        return summary
    shape = SERVE_BF16_SHAPE
    want = dict(max_slots=shape["B"], kv_block_size=shape["bs"],
                blocks_per_slot=shape["Bps"], num_blocks=shape["N"] - 1,
                kv_dtype=str(torch.bfloat16))
    if any(geo[k] != v for k, v in want.items()):
        raise RuntimeError(f"{label}: engine geometry {geo} is not phase "
                           f"3's bf16_serve case {want}")
    before = paged_flash_decode.launches
    for name, attention in (("plain", None), ("planted", _slots_swapped)):
        engine = PagedEngine(
            model, device=next(model.parameters()).device,
            max_slots=geo["max_slots"], max_len=geo["max_len"],
            kv_block_size=geo["kv_block_size"],
            num_blocks=geo["num_blocks"],
            prefill_chunk=geo["prefill_chunk"], decode_attention="plain")
        if attention is not None:
            engine.attention = attention
        replay = engine.run(reqs)
        del engine
        if replay["errors"]:
            raise RuntimeError(f"{label} {name}: {replay['errors']} "
                               "rejected")
        r_gap, r_agree = served_margins(model, reqs, replay["results"])
        print(f"{label} {name} replay: worst gap {r_gap:.3e} of "
              f"max|logit|, argmax agreement {r_agree:.4f}")
        summary[name] = dict(gap=r_gap, agreement=r_agree)
        if name == "plain":
            summary["plain_agreement"] = _agreement(
                out["results"], replay["results"], f"{label} vs plain")
            if not r_gap <= SERVE_GAP_TOL:
                raise RuntimeError(f"{label}: the plain replay is outside "
                                   "the gap limit")
        elif r_gap <= SERVE_GAP_TOL:
            raise RuntimeError(f"{label}: the gap check passed a planted "
                               "fault (each slot read its neighbour's "
                               "blocks)")
    if paged_flash_decode.launches != before:
        raise RuntimeError(f"{label}: a plain replay launched the kernel")
    return summary


def phase_post_train_serving(bf16_perf, data_perf):
    """Phase 15: the ``generate``, ``serve(paged):`` and ``serve:`` lines
    of phase 10's and phase 11's runs (each given when it ran), and that
    :func:`_hold_served` held what each served.  Returns the decode
    kernel's launches in phase 10's run."""
    for perf, engine in ((bf16_perf, "PagedEngine"),
                         (data_perf, "ServeEngine")):
        if perf is not None and perf.get("served", {}).get("engine") \
                != engine:
            raise RuntimeError(f"post-train: no {engine} run was held")
    launches = None
    if bf16_perf is not None:
        log = bf16_perf["log"]
        lens = [len(c.split(",")) for _, c in _GENERATE_LINE.findall(log)]
        print(f"post-train [bf16]: {len(lens)} generate lines, "
              f"continuations of {lens} tokens")
        if lens != [16, 16]:
            raise RuntimeError("post-train generate: expected two "
                               "continuations of 16 tokens")
        req, tok, tps, hit, _, cap, ticks, logged = _one(
            _SERVE_PAGED_LINE, log, "serve(paged)")
        launches = bf16_perf["decode_launches"]
        want = int(ticks) * TRAIN_LAYERS
        print(f"post-train [bf16 serve --paged]: {int(req)} requests, "
              f"{int(tok)} tokens at {tps:.1f} tok/s, prefix hit {hit:.3f},"
              f" decode captures {int(cap)}, {int(ticks)} ticks, "
              f"paged_flash_decode launches {launches} (logged "
              f"{int(logged)}), ticks x layers {want}")
        if int(req) != SERVE_REQUESTS or int(cap) != 1 or \
                not launches == int(logged) == want:
            raise RuntimeError("post-train serve --paged: a request "
                               "rejected, not one capture, or not one "
                               "kernel launch per layer per tick")
    if data_perf is not None:
        req, tok, tps, occ, slots, cap, ticks = _one(
            _SERVE_SLOT_LINE, data_perf["log"], "serve")
        print(f"post-train [data bf16 serve]: {int(req)} requests, "
              f"{int(tok)} tokens at {tps:.1f} tok/s, occupancy "
              f"{occ:.2f}/{int(slots)}, decode captures {int(cap)}, "
              f"{int(ticks)} ticks")
        if int(req) != SERVE_REQUESTS or int(cap) != 1:
            raise RuntimeError("post-train serve: a request rejected or "
                               "not one capture")
    return launches


def phase_checkpoint(data_dir: Path):
    """Phase 12: a mid-epoch save, the final step removed, ``--resume``."""
    from distributed_deep_learning_tpu_torch.utils.checkpoint import \
        Checkpointer

    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    flags = ("--dtype", "bfloat16", "--dropout", "0.1", "--checkpoint-dir",
             str(ckdir), "--checkpoint-every", "4")
    t0 = time.perf_counter()
    whole, _, _ = _train(data_dir, "flash", *flags, label="ckpt whole",
                         mode="data")
    ckpt = Checkpointer(ckdir)
    steps = _phase_steps()[0]
    print(f"checkpoint: steps {ckpt.all_steps()} after the whole run "
          f"({time.perf_counter() - t0:.1f} s with saves)")
    if ckpt.all_steps() != [4, steps]:
        raise RuntimeError(f"checkpoint: steps {ckpt.all_steps()}, expected "
                           f"[4, {steps}]")
    first_manifest = ckpt.read_manifest(steps)
    for name in (f"ckpt-{steps}.pt", f"extra-{steps}.json",
                 f"manifest-{steps}.json"):
        (ckdir / name).unlink()
    resumed, _, _ = _train(data_dir, "flash", *flags, "--resume",
                           label="ckpt resumed", mode="data")
    got, want = resumed[0].step_losses, whole[0].step_losses[4:]
    worst = max(_rel(a, b) for a, b in zip(got, want)) if got else 1.0
    print(f"checkpoint: resumed at batch 4, steps 5-{steps} losses rel diff "
          f"{worst:.2e} from the run never stopped (tol 1e-6)")
    if len(got) != steps - 4 or not worst <= 1e-6:
        raise RuntimeError("checkpoint: the resumed run differs")
    t0 = time.perf_counter()
    ckpt.load(steps)                    # raises unless every CRC matches
    manifest = ckpt.read_manifest(steps)
    same = sum(manifest["leaves"][k]["crc32"] == r["crc32"]
               for k, r in first_manifest["leaves"].items())
    print(f"checkpoint: step {steps} verifies against its manifest "
          f"({len(manifest['leaves'])} leaves, {time.perf_counter() - t0:.1f}"
          f" s); {same} of {len(first_manifest['leaves'])} leaf CRCs equal "
          "to the uninterrupted run's")
    shutil.rmtree(ckdir)


# --- phase 16: the fused head at the training shape -----------------------

#: fused head vs the logits path: the loss (relative) and each gradient
#: over its largest |element|; dh of bf16 hidden states is bf16 on both
#: sides, each rounded from f32 sums in other orders, so it is held to one
#: bf16 step (2^-7 of an element, at most 2^-7 of the largest)
FUSED_TOL = {"loss": 1e-5, "grad": 1e-4, "bf16_dh": 2.0 ** -7}


def _head_pass(model, h, targets, fused):
    """Loss, dh, dW, the peak bytes allocated above the start and the
    median ms of 3 forward+backward passes of the tied head with the token
    cross-entropy: ``CausalLM.loss`` (fused) or the training path's
    ``token_cross_entropy`` over ``logits_from``."""
    import torch

    from distributed_deep_learning_tpu_torch.train.objectives import \
        TokenCrossEntropy

    ce, times, peak = TokenCrossEntropy(), [], 0
    for _ in range(3):
        x = h.detach().requires_grad_()
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss = model.loss(x, targets) if fused else \
            ce(model.logits_from(x), targets)
        loss.backward()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
    return (loss.item(), x.grad.float(), model.tok.weight.grad.float(),
            peak, statistics.median(times))


def phase_fused_head(data_dir: Path, bf16_perf):
    """Phase 16: ``CausalLM.loss`` against the logits path at the training
    shape (B 4, T 2048, V 32768, d 768; the last 64 targets of each row
    are pad), f32 and bf16 hidden states: loss, gradients, peak memory and
    time; then 8 bf16 train steps of the 12-layer model through
    ``loss`` (flash attention, AdamW) beside phase 10's.  Returns a
    summary."""
    import numpy as np
    import torch

    from distributed_deep_learning_tpu_torch.models.transformer import \
        CausalLM
    from distributed_deep_learning_tpu_torch.workloads.base import adamw

    gen = torch.Generator().manual_seed(16)
    model = CausalLM(vocab_size=TRAIN_VOCAB, num_layers=TRAIN_LAYERS,
                     d_model=768, num_heads=12, mlp_dim=3072,
                     max_len=TRAIN_T, attention="flash")
    model.reset_parameters(gen)
    model.cuda()
    h32 = torch.randn(TRAIN_BATCH, TRAIN_T, 768, generator=gen).cuda()
    targets = torch.randint(1, TRAIN_VOCAB, (TRAIN_BATCH, TRAIN_T),
                            generator=gen)
    targets[:, -64:] = 0
    targets = targets.cuda()
    summary = {}
    for label, h in (("f32", h32), ("bf16", h32.bfloat16())):
        fused = _head_pass(model, h, targets, fused=True)
        ref = _head_pass(model, h, targets, fused=False)
        rel = abs(fused[0] - ref[0]) / abs(ref[0])
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(fused[1:3], ref[1:3])]
        dh_tol = FUSED_TOL["bf16_dh" if label == "bf16" else "grad"]
        print(f"fused head [{label}]: loss {fused[0]:.7f} vs logits path "
              f"{ref[0]:.7f}, rel diff {rel:.2e} (tol {FUSED_TOL['loss']:g});"
              f" dh max err {errs[0]:.2e} of max|ref| (tol {dh_tol:g}), dW "
              f"{errs[1]:.2e} (tol {FUSED_TOL['grad']:g}); peak "
              f"{fused[3] / 2**20:.1f} MiB vs {ref[3] / 2**20:.1f} MiB; "
              f"forward+backward {fused[4]:.3f} ms vs {ref[4]:.3f} ms")
        if not (rel <= FUSED_TOL["loss"] and errs[0] <= dh_tol
                and errs[1] <= FUSED_TOL["grad"]):
            raise RuntimeError(f"fused head [{label}]: disagrees with the "
                               "logits path")
        summary[label] = dict(rel=rel, dh=errs[0], dw=errs[1],
                              peak=fused[3], ref_peak=ref[3], ms=fused[4],
                              ref_ms=ref[4])
    del model, h32, h
    gc.collect()

    model = CausalLM(vocab_size=TRAIN_VOCAB, num_layers=TRAIN_LAYERS,
                     d_model=768, num_heads=12, mlp_dim=3072,
                     max_len=TRAIN_T, attention="flash",
                     dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(42))
    model.cuda().train()
    opt = adamw(1e-3).build(model.named_parameters())
    rows = torch.as_tensor(np.load(data_dir / "tokens.npy")[:TRAIN_BATCH],
                           device="cuda").long()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(8):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        opt.zero_grad(set_to_none=True)
        loss = model.loss(model(rows[:, :-1]), rows[:, 1:])
        loss.backward()
        opt.step()
        b.record()
        losses.append(loss.detach())
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
    losses = [float(x) for x in losses]
    step_s = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated()
    print(f"train[bf16 fused head]: losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; {step_s:.4f} s/step, {TRAIN_BATCH * TRAIN_T / step_s:.1f} "
          f"tokens/s, peak {peak / 2**30:.2f} GiB"
          + (f" | phase 10 (logits head, CLI): {bf16_perf['step_s']:.4f} "
             f"s/step, {bf16_perf['tokens_per_s']:.1f} tokens/s, peak "
             f"{bf16_perf['peak'] / 2**30:.2f} GiB" if bf16_perf else ""))
    if not all(np.isfinite(losses)):
        raise RuntimeError("train[bf16 fused head]: a non-finite loss")
    summary["train"] = dict(step_s=step_s, peak=peak, losses=losses)
    del model, opt
    gc.collect()
    return summary


# --- phase 17: LAMB and Adafactor through the CLI ---------------------------

#: phase 17's learning rate, ten times phase 10's: LAMB's trust ratio and
#: Adafactor's parameter scale make a step about lr times a parameter's
#: norm.  The losses' fall over 8 different batches is mostly the batches'
#: own (phase 11's runs all fall alike), so it is no check of the
#: optimizers' arithmetic: :func:`_optimizer_gap` is.
OPT_LR = "1e-2"
#: the hold of each optimizer's arithmetic on the card: OPT_HOLD_STEPS
#: updates of a full-width CausalLM cut to OPT_HOLD_LAYERS layers, the same
#: seeded gradients on the card and on the CPU; the parameters must agree
#: within OPT_HOLD_ATOL (absolute, test_torch_optimizers' limit), and the
#: planted control, the card's run at learning rate 0, must not
OPT_HOLD_STEPS, OPT_HOLD_LAYERS, OPT_HOLD_ATOL = 3, 2, 1e-5


def _optimizer_params(opt, lr, device):
    """The parameters (on the CPU) after OPT_HOLD_STEPS updates of the
    CLI's ``--optimizer opt --lr lr`` recipe on ``device``, from seed 0,
    each step's gradients N(0, 1e-3) drawn on the CPU from one seed."""
    import torch

    from distributed_deep_learning_tpu_torch.models.transformer import \
        CausalLM
    from distributed_deep_learning_tpu_torch.train.state import \
        create_train_state
    from distributed_deep_learning_tpu_torch.utils import config as tconfig
    from distributed_deep_learning_tpu_torch.workloads import base, northstar

    cfg = tconfig.parse_args(["--optimizer", opt, "--lr", lr], "gpt")
    tx = base.build_optimizer(northstar.GPT_SPEC, cfg, epoch_steps=8)
    model = CausalLM(**{**FULL_MODEL, "num_layers": OPT_HOLD_LAYERS})
    state = create_train_state(model, 0, tx, device=device)
    gen = torch.Generator().manual_seed(0)
    for _ in range(OPT_HOLD_STEPS):
        for p in state.model.parameters():
            p.grad = (torch.randn(p.shape, generator=gen) * 1e-3).to(device)
        state.apply_gradients()
    return [p.detach().cpu() for p in state.model.parameters()]


def _optimizer_gap(opt):
    """``(gap, control)``: max |card - CPU| over the parameters after
    :func:`_optimizer_params` at ``OPT_LR``, and the same with the card at
    learning rate 0 (the planted control)."""
    want = _optimizer_params(opt, OPT_LR, "cpu")

    def gap(lr):
        got = _optimizer_params(opt, lr, "cuda")
        return max(float((a - b).abs().max()) for a, b in zip(got, want))

    return gap(OPT_LR), gap("0")


def phase_optimizers(data_dir: Path, bf16_perf):
    """Phase 17: each optimizer's steps on the card held against the CPU's
    (:func:`_optimizer_gap`); then phase 10's run with ``--optimizer
    lamb`` and ``adafactor`` (``--lr`` ``OPT_LR``): finite losses that
    fall, phase 10's kernel launches; step time, peak memory and optimizer
    state beside AdamW's."""
    out = {}
    for opt in ("lamb", "adafactor"):
        gap, control = _optimizer_gap(opt)
        print(f"optimizer[{opt}]: {OPT_HOLD_STEPS} steps of a "
              f"{OPT_HOLD_LAYERS}-layer full-width model, card vs CPU max "
              f"|diff| {gap:.3e} (limit {OPT_HOLD_ATOL:g}); planted control "
              f"(card at lr 0) {control:.3e}")
        if not gap <= OPT_HOLD_ATOL:
            raise RuntimeError(f"optimizer[{opt}]: the card's steps differ "
                               f"from the CPU's by {gap:.3e}")
        if not control > OPT_HOLD_ATOL:
            raise RuntimeError(f"optimizer[{opt}]: the hold cannot tell a "
                               "step at lr 0 from the CPU's")
    for opt in ("lamb", "adafactor"):
        hist, launches, perf = _train(
            data_dir, "flash", "--dtype", "bfloat16", "--optimizer", opt,
            "--lr", OPT_LR, label=f"bf16 {opt}")
        perf.pop("served")
        losses = hist[0].step_losses
        print(f"train[bf16 {opt}]: launches {launches}; optimizer state "
              f"{perf['opt_state_bytes'] / 2**20:.1f} MiB"
              + (f" | AdamW (phase 10): {bf16_perf['step_s']:.4f} s/step, "
                 f"peak {bf16_perf['peak'] / 2**30:.2f} GiB, state "
                 f"{bf16_perf['opt_state_bytes'] / 2**20:.1f} MiB"
                 if bf16_perf else ""))
        if launches != _expected_launches():
            raise RuntimeError(f"train[bf16 {opt}]: a layer of a step did "
                               "not go through the flash kernels")
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"train[bf16 {opt}]: loss did not fall "
                               f"({losses[0]} -> {losses[-1]})")
        out[opt] = perf
    if bf16_perf and not out["adafactor"]["opt_state_bytes"] < \
            bf16_perf["opt_state_bytes"]:
        raise RuntimeError("adafactor: its state is not smaller than "
                           "AdamW's")
    return out


# --- phases 18-20: quantized, speculative and windowed serving --------------


def _serve_run(label, make, trace, layers=FULL_MODEL["num_layers"],
               launches_per_tick=None):
    """One engine lifetime over phase 4's trace with the decode counter
    zeroed just before: no request rejected, every budget met, tokens in
    [1, vocab), finite outputs, and ``launches_per_tick`` decode kernel
    launches a tick (one a layer unless given; 0 for the slot engine).
    Returns the output and the launches; the stats gain ``replay_ms``, the
    card's ms a replay of each captured tick (:func:`_replay_ms`), which
    a run's first-use costs do not reach."""
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode

    paged_flash_decode.launches = 0
    engine = make()
    out = engine.run(trace)
    launches, s = paged_flash_decode.launches, out["stats"]
    s["replay_ms"] = {
        name: _replay_ms(tick._graph)
        for name, tick in (("decode", engine._tick),
                           ("draft", getattr(engine, "_draft_tick", None)),
                           ("verify", getattr(engine, "_verify_tick", None)))
        if tick is not None and tick._graph is not None}
    del engine
    if out["errors"]:
        raise RuntimeError(f"{label}: {out['errors']} rejected")
    _check_results(label, out["results"],
                   {r.uid: r.max_new_tokens for r in trace})
    if s["nonfinite_tokens"]:
        raise RuntimeError(f"{label}: {s['nonfinite_tokens']} non-finite")
    per_tick = layers if launches_per_tick is None else launches_per_tick
    if not launches == s.get("paged_decode_launches", 0) == \
            s["decode_ticks"] * per_tick:
        raise RuntimeError(f"{label}: {launches} decode launches, expected "
                           f"{s['decode_ticks']} ticks x {per_tick}")
    return out, launches


def _serve_line(label, s, rec4, results):
    pe = rec4["paged_engine"]
    same = sum(a == b for uid, toks in rec4["results"].items()
               for a, b in zip(toks, results[uid]))
    total = sum(len(t) for t in rec4["results"].values())
    print(f"{label}: agreement with phase 4 {same}/{total} = "
          f"{same / total:.4f}; {s['tokens_per_sec']:.1f} tok/s vs "
          f"{pe['tokens_per_sec']:.1f}; tick {_tick_ms(s):.3f} ms vs "
          f"{_tick_ms(pe):.3f} ms over {s['decode_ticks']} ticks; on the "
          f"card a replay of " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                           s["replay_ms"].items())
          + f"; kv_cache_bytes {s['kv_cache_bytes']} vs "
          f"{pe['kv_cache_bytes']}; weight_bytes {s['weight_bytes']}")


def phase_quant_serving(rec4):
    """Phase 18: phase 4's trace through ``PagedEngine`` with int8 KV, bf16
    KV and int8 weights over int8 KV, and through the slot engine with
    bf16 KV: each graphed tick captured once, one kernel launch a layer a
    tick (none for the slot engine); each int8 run replayed with the plain
    decode attention gives the same first tokens.  Returns the kernel's
    launches in the paged runs."""
    from distributed_deep_learning_tpu_torch.serve.engine import (
        PagedEngine, ServeEngine)

    model, trace, cap = _full_width()
    runs = [("paged kv int8", dict(kv_dtype="int8")),
            ("paged kv bf16", dict(kv_dtype="bf16")),
            ("paged kv int8 weights int8",
             dict(kv_dtype="int8", weight_dtype="int8"))]
    launches = 0
    for label, opts in runs:
        out, n = _serve_run(f"quantized [{label}]", lambda: PagedEngine(
            model, max_len=cap, **FULL_ENGINE, **opts), trace)
        launches += n
        s = out["stats"]
        _check_tick(f"quantized [{label}]", s, captures=1)
        _serve_line(f"quantized [{label}]", s, rec4, out["results"])
        if "int8" in opts.values():
            plain, _ = _serve_run(
                f"quantized [{label}] plain", lambda: PagedEngine(
                    model, max_len=cap, decode_attention="plain",
                    **FULL_ENGINE, **opts), trace, launches_per_tick=0)
            _agreement(out["results"], plain["results"],
                       f"quantized [{label}] vs plain")
    slot, _ = _serve_run("quantized [slot kv bf16]", lambda: ServeEngine(
        model, max_slots=FULL_ENGINE["max_slots"], kv_dtype="bf16"), trace,
        launches_per_tick=0)
    _check_tick("quantized [slot kv bf16]", slot["stats"], captures=1)
    _serve_line("quantized [slot kv bf16]", slot["stats"], rec4,
                slot["results"])
    return launches


#: phase 19's draft and proposals a round
SPEC = dict(draft_layers=2, spec_k=4)
#: a speculatively served f32 token against the plain forward's argmax on
#: its own prefix (``served_margins``), over max|logit|: the verify is the
#: plain forward's arithmetic over the same f32 cache, in another order,
#: so only a top-2 tie within f32 rounding may flip (measured: 0 on the
#: H100, every token the reference's argmax)
SPEC_GAP_TOL = 1e-5


def phase_spec(rec4):
    """Phase 19: phase 4's trace with a 2-layer draft proposing 4 tokens a
    round: first tokens equal phase 4's, every token within
    ``SPEC_GAP_TOL`` of the plain forward's argmax on its prefix, one
    capture each of the draft round and the verify and none of the decode
    tick, and the kernel launched ``spec_k + 1`` times a draft layer a
    speculative tick.  Returns the launches."""
    from distributed_deep_learning_tpu_torch.serve.bench import paged_max_len
    from distributed_deep_learning_tpu_torch.serve.engine import PagedEngine

    model, trace, _ = _full_width()
    cap = paged_max_len(model.max_len, FULL_ENGINE["kv_block_size"], True,
                        SPEC["spec_k"])
    out, launches = _serve_run(
        "spec", lambda: PagedEngine(model, max_len=cap, **FULL_ENGINE,
                                    **SPEC), trace,
        launches_per_tick=(SPEC["spec_k"] + 1) * SPEC["draft_layers"])
    s, sp = out["stats"], out["stats"]["spec"]
    captures = (s["decode_captures"], s["draft_captures"],
                s["verify_captures"])
    print(f"spec: captures decode/draft/verify {captures}; "
          f"{launches} draft launches = {s['decode_ticks']} speculative "
          f"ticks x {SPEC['spec_k'] + 1} steps x {SPEC['draft_layers']} "
          f"layers; rounds {sp['rounds']}, proposed {sp['proposed']}, "
          f"accepted {sp['accepted']}, acceptance {sp['acceptance_rate']:.4f}")
    if captures != (0, 1, 1) or sp["proposed"] != \
            sp["rounds"] * SPEC["spec_k"]:
        raise RuntimeError("spec: not one capture of the draft round and "
                           "of the verify and none of the decode tick, or "
                           "proposals not spec_k a round")
    _agreement(rec4["results"], out["results"], "spec vs phase 4")
    gap, agree = served_margins(model, trace, out["results"])
    print(f"spec: greedy tokens against the plain forward on their prefix: "
          f"worst gap {gap:.3e} of max|logit| (tol {SPEC_GAP_TOL:g}), "
          f"argmax agreement {agree:.4f}")
    if not gap <= SPEC_GAP_TOL:
        raise RuntimeError(f"spec: a served token {gap:.3e} of max|logit| "
                           "below the reference's argmax")
    _serve_line("spec", s, rec4, out["results"])
    return launches


def phase_window(rec4):
    """Phase 20: phase 4's trace on the same model with a 256-position
    sliding window (prompts reach 512 past a 64-token prefix): the kernel
    against the plain decode, the same first tokens and agreement
    printed, one launch a layer a tick.  Returns the launches."""
    from distributed_deep_learning_tpu_torch.serve.bench import build_model
    from distributed_deep_learning_tpu_torch.serve.engine import PagedEngine

    _, trace, cap = _full_width()
    model = build_model(0, "cuda", **FULL_MODEL,
                        attention_window=SERVE_WINDOW)
    runs = {}
    for label in ("kernel", "plain"):
        out, n = _serve_run(
            f"window [{label}]", lambda: PagedEngine(
                model, max_len=cap, decode_attention=label, **FULL_ENGINE),
            trace, launches_per_tick=None if label == "kernel" else 0)
        _check_tick(f"window [{label}]", out["stats"], captures=1)
        runs[label] = (out, n)
    _agreement(runs["kernel"][0]["results"], runs["plain"][0]["results"],
               f"window {SERVE_WINDOW} kernel vs plain")
    s = runs["kernel"][0]["stats"]
    print(f"window [kernel]: {s['tokens_per_sec']:.1f} tok/s, tick "
          f"{_tick_ms(s):.3f} ms over {s['decode_ticks']} ticks (a replay "
          f"{s['replay_ms']['decode']:.3f} ms on the card), "
          f"{runs['kernel'][1]} launches")
    return runs["kernel"][1]


#: the CLI's second post-train leg on phase 10's run: speculation with a
#: 6-layer draft over int8 KV and int8 weights
SERVE_SPEC_FLAGS = ("--serve", "--paged", "--prefill-chunk", "64", "--draft",
                    "6", "--spec-k", "4", "--kv-dtype", "int8",
                    "--weight-dtype", "int8")
_SERVE_SPEC_LINE = re.compile(
    r'"serve\(paged\): (\d+) requests, (\d+) tokens at ([\d.]+) tok/s, '
    r'prefix hit ([\d.]+), cow (\d+), decode captures=(\d+) ticks=(\d+) '
    r'launches=(\d+), draft captures=(\d+) verify captures=(\d+), spec '
    r'acceptance ([\d.]+)')


def phase_cli_spec_quant(data_dir: Path):
    """Phase 10's run with ``SERVE_SPEC_FLAGS``: its ``serve(paged):`` line
    shows every request served, the draft round and the verify captured
    once and the decode tick never, and 6 x 5 kernel launches a tick;
    what it served is held as phase 15 holds it."""
    hist, _, perf = _train(data_dir, "flash", "--dtype", "bfloat16",
                           *SERVE_SPEC_FLAGS, label="bf16 serve spec int8")
    runs = perf.pop("served")
    req, tok, tps, hit, _, dcap, ticks, logged, drcap, vcap, acc = _one(
        _SERVE_SPEC_LINE, perf["log"], "serve(paged) spec")
    launches = perf["decode_launches"]
    want = int(ticks) * 6 * 5
    print(f"post-train [bf16 serve --paged --draft 6 --spec-k 4 --kv-dtype "
          f"int8 --weight-dtype int8]: {int(req)} requests, {int(tok)} "
          f"tokens at {tps:.1f} tok/s, captures decode/draft/verify "
          f"{int(dcap)}/{int(drcap)}/{int(vcap)}, {int(ticks)} ticks, "
          f"launches {launches} (logged {int(logged)}, expected {want}), "
          f"spec acceptance {acc:.3f}")
    if int(req) != SERVE_REQUESTS or (int(dcap), int(drcap), int(vcap)) \
            != (0, 1, 1) or not launches == int(logged) == want:
        raise RuntimeError("post-train spec int8: a request rejected, "
                           "wrong captures or launches")
    if len(runs) != 1:
        raise RuntimeError(f"post-train spec int8: {len(runs)} runs")
    run = runs.pop()
    model, reqs, out = run["model"], run["requests"], run["out"]
    if out["errors"]:
        raise RuntimeError(f"post-train spec int8: {out['errors']}")
    _check_results("post-train spec int8", out["results"],
                   {r.uid: r.max_new_tokens for r in reqs},
                   vocab=model.vocab_size)
    gap, agree = served_margins(model, reqs, out["results"])
    print(f"post-train spec int8: {run['engine']} {run['geometry']}; "
          f"greedy tokens against the plain forward (int8 weights) on their"
          f" prefix: worst gap {gap:.3e} of max|logit| (tol "
          f"{SERVE_GAP_TOL:g}), argmax agreement {agree:.4f}")
    if not gap <= SERVE_GAP_TOL:
        raise RuntimeError(f"post-train spec int8: a served token {gap:.3e}"
                           " of max|logit| below the reference's argmax")
    return dict(launches=launches, gap=gap, agreement=agree,
                acceptance=acc)


# --- phases 21-23: the reference's workloads through the CLI ---------------

#: each workload at its CLI default -l/-s: f32, batch 32, 2 epochs of its
#: synthetic twin
WORKLOADS = ("mlp", "lstm", "mnist", "cnn")
WORKLOAD_FLAGS = ("-e", "2", "-b", "32")
WORKLOAD_BATCH = 32
#: lstm's "accuracy" is argmax over regression targets (quirk Q5)
CLASSIFIERS = ("mlp", "mnist", "cnn")
#: the card's first train-step loss against the CPU's, bf16's and -m
#: data's against phase 21's, and the restored test metrics (relative)
FIRST_LOSS_TOL, BF16_FIRST_LOSS_TOL, DATA_FIRST_LOSS_TOL = 1e-4, 2e-2, 1e-6
RESTORE_TOL = 1e-6


def _step_setup(workload: str, argv, device: str, prefetch: int = 0,
                data: bool = False):
    """``(state, train_step, train_loader)`` of ``workload`` under ``argv``
    on ``device``, built as the CLI builds its run: the same dataset,
    split (``DDL_DATA_LIMIT`` honoured as the runner honours it), seeded
    initialisation and recipe; the loader set to epoch 1, ``prefetch``
    batches deep (``make_loaders``'s).  ``data``: the ``-m data`` step of
    one rank, the model wrapped as the runner wraps it (the default
    process group must exist)."""
    import os

    from distributed_deep_learning_tpu_torch.data.loader import make_loaders
    from distributed_deep_learning_tpu_torch.data.splits import \
        train_val_test_split
    from distributed_deep_learning_tpu_torch.train.state import \
        create_train_state
    from distributed_deep_learning_tpu_torch.train.step import make_step_fns
    from distributed_deep_learning_tpu_torch.utils.config import parse_args
    from distributed_deep_learning_tpu_torch.workloads import get_spec
    from distributed_deep_learning_tpu_torch.workloads.base import (
        build_dataset, build_optimizer)

    spec = get_spec(workload)
    cfg = parse_args([*argv, "-d", device], workload=workload)
    dataset = build_dataset(spec, cfg)
    limit = int(os.environ.get("DDL_DATA_LIMIT", "0"))
    splits = train_val_test_split(
        min(len(dataset), limit) if limit else len(dataset), seed=cfg.seed)
    train, _, _ = make_loaders(dataset, splits, cfg.batch_size, device,
                               seed=cfg.seed, prefetch=prefetch)
    epoch_steps = max(1, len(splits.train) // cfg.batch_size)
    state = create_train_state(spec.build_model(cfg, dataset), cfg.seed,
                               build_optimizer(spec, cfg, epoch_steps),
                               device=device)
    ddp = None
    if data:
        import torch
        from torch.nn.parallel import DistributedDataParallel

        from distributed_deep_learning_tpu_torch.models.densenet import \
            global_batch_statistics
        from distributed_deep_learning_tpu_torch.models.moe import \
            global_routing
        global_batch_statistics(state.model)
        global_routing(state.model)
        ddp = DistributedDataParallel(
            state.model, device_ids=[torch.cuda.current_device()]
            if device == "cuda" else None)
    step, _ = make_step_fns(spec.build_loss(cfg), ddp=ddp, remat=cfg.remat,
                            remat_policy=cfg.remat_policy)
    train.set_epoch(1)
    return state, step, train


def first_step_loss(workload: str, argv, device: str) -> float:
    """The loss of ``workload``'s first train step under ``argv`` on
    ``device`` (the CLI's first batch and initialisation)."""
    state, step, train = _step_setup(workload, argv, device)
    x, y = next(train.iter_batches())
    return step(state, x, y)[1]["loss"].item()


def device_busy_share(workload: str, steps: int = 8, argv=WORKLOAD_FLAGS,
                      warmup: int = 3, data: bool = False):
    """``(busy ms, wall ms, top, flash ms)`` a train step of ``workload``
    under ``argv`` (phase 21's settings by default): ``steps`` steps after
    ``warmup`` warm-up steps under ``torch.profiler``, the wall clock
    synchronised around them, busy the sum of the card's kernel times
    (None when the profiler sees no device time), ``top`` the 4 largest
    ``(kernel, ms a step, calls a step)`` and ``flash ms`` the flash
    kernels' time a step.  ``data``: the ``-m data`` step at world 1, in a
    process group of its own (NCCL, as the CLI's)."""
    if not data:
        state, step, train = _step_setup(workload, argv, "cuda")
        return profile_window(step, state, train, steps, warmup)
    from distributed_deep_learning_tpu_torch.runtime import bootstrap

    _, created = bootstrap.initialize("cuda")
    try:
        state, step, train = _step_setup(workload, argv, "cuda", data=True)
        return profile_window(step, state, train, steps, warmup)
    finally:
        if created:
            bootstrap.shutdown()


def _cycle(train):
    """The loader's batches in turn, from its start again when they run
    out (closing it closes the loader's pass, and a prefetch thread)."""
    while True:
        yield from train.iter_batches()


def profile_window(step, state, train, steps: int, warmup: int,
                   live: bool = False):
    """:func:`device_busy_share`'s window over ``step`` and ``state``:
    ``warmup`` steps, then ``steps`` under ``torch.profiler`` (the
    loader's batches in turn, from its start again when they run out),
    the batches formed before the window, or inside it when ``live``.
    Only the card's activity is recorded: the host's op records took
    ~10 s a window to process (33 windows, a third of a full run), and
    the window reads device time only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batches = _cycle(train)
    for _ in range(warmup):
        step(state, *next(batches))
    window = (next(batches) for _ in range(steps)) if live else \
        [next(batches) for _ in range(steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x, y in window:
            step(state, x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    batches.close()
    # device events but the spans of annotated ranges (such as
    # ``Optimizer.step``), which cover kernels counted on their own
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    flash_us = sum(e.self_device_time_total for e in kernels
                   if "flash_" in e.key)
    top = [(e.key[:60], e.self_device_time_total / 1e3 / steps,
            e.count / steps) for e in kernels[:4]]
    return (busy_us / 1e3 / steps if busy_us else None), \
        wall * 1e3 / steps, top, flash_us / 1e3 / steps


def check_first_loss(label: str, got: float, want: float,
                     tol: float) -> float:
    """Raise unless ``got`` lies within ``tol`` (relative) of ``want``."""
    rel = _rel(got, want)
    print(f"{label}: first train-step loss {got:.9f} against {want:.9f}: "
          f"rel diff {rel:.2e} (tol {tol:g})")
    if not rel <= tol:
        raise RuntimeError(f"{label}: first loss {got!r} is {rel:.2e} from "
                           f"{want!r}, beyond {tol:g}")
    return rel


#: item 18's A/B: the train loader unwrapped (0, the runner's default) and
#: two batches deep (2), in turns; timed steps and a profiler window of as
#: many, each after warm-up steps, the batches formed while the steps run;
#: phase 21 runs it on one workload (phase 24 on ResNet-50's packed cache)
PREFETCH_AB = (0, 2, 2, 0)
PREFETCH_WORKLOAD = "cnn"
PREFETCH_STEPS = dict(steps=12, warmup=3)


def prefetch_ab(workload: str, argv, label: str) -> dict:
    """``{depth: [(ms a step, idle share or None), ...]}`` of ``workload``
    under ``argv`` with the train loader ``PREFETCH_AB``'s depths deep, in
    turns: the step time on the synchronised host clock over
    ``PREFETCH_STEPS`` steps, then the card's kernel time over as many
    under ``torch.profiler`` (idle share against the unprofiled step)."""
    import torch

    out = {}
    steps, warmup = PREFETCH_STEPS["steps"], PREFETCH_STEPS["warmup"]
    for depth in PREFETCH_AB:
        state, step, train = _step_setup(workload, argv, "cuda",
                                         prefetch=depth)
        batches = _cycle(train)
        for _ in range(warmup):
            step(state, *next(batches))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, *next(batches))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        batches.close()
        busy, _, _, _ = profile_window(step, state, train, steps, warmup,
                                       live=True)
        idle = None if busy is None else 1 - busy / step_ms
        out.setdefault(depth, []).append((step_ms, idle))
        print(f"prefetch[{label}] depth {depth}: {step_ms:.3f} ms a step "
              f"over {steps} steps, batches formed while they run; "
              + ("idle share not measured (the profiler saw no device "
                 "time)" if idle is None else
                 f"{busy:.3f} ms of kernels a step: idle share {idle:.3f}"))
        del state, step, train
        gc.collect()
    a, b = (statistics.median(ms for ms, _ in out[d]) for d in (0, 2))
    print(f"prefetch[{label}]: depth 2 against depth 0: {b:.3f} against "
          f"{a:.3f} ms a step (medians of {PREFETCH_AB.count(0)} runs "
          f"each, {b / a - 1:+.1%})")
    return out


def _kernel_counters():
    from distributed_deep_learning_tpu_torch.ops import attention as fa
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode

    return (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv,
            paged_flash_decode)


def _workload_run(workload: str, *flags, label=None, base=WORKLOAD_FLAGS,
                  per_step=WORKLOAD_BATCH, unit="examples"):
    """One CLI run on the card (``base`` then ``flags``), the kernels'
    launch counters set to 0 just before it and read just after; returns
    the final state, the history and step time (median of every train
    step but the run's first), ``unit``/s (``per_step`` a step), peak
    memory, the first step's loss and the launches."""
    import torch

    from distributed_deep_learning_tpu_torch.__main__ import main as cli

    label = label or workload
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in _kernel_counters():
        c.launches = 0
    t0 = time.perf_counter()
    state, hist = cli([workload, *base, *flags])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in _kernel_counters()}
    peak = torch.cuda.max_memory_allocated()
    trains = [h for h in hist if h.phase == "train"]
    losses = [x for h in trains for x in h.step_losses]
    step_s = statistics.median([s for h in trains
                                for s in h.step_seconds][1:])
    perf = dict(step_s=step_s, rate=per_step / step_s,
                peak=peak, first_loss=losses[0], step_losses=losses,
                epoch_losses=[h.loss for h in trains],
                train_accuracy=[h.accuracy for h in trains],
                launches=launches)
    print(f"workload[{label}]: {len(losses)} train steps, {step_s:.5f} "
          f"s/step (median of steps 2-{len(losses)}), "
          f"{perf['rate']:.1f} {unit}/s, peak memory "
          f"{peak / 2**20:.1f} MiB; epoch train losses "
          + " ".join(f"{h.loss:.9f}" for h in trains) + ", train accuracy "
          + " -> ".join(f"{h.accuracy:.3f}" for h in trains)
          + f", test loss {hist[-1].loss:.9f} accuracy "
          f"{hist[-1].accuracy:.3f}; {wall:.1f} s with data and model build")
    if not all(math.isfinite(x) for x in losses + [h.loss for h in hist]):
        raise RuntimeError(f"workload[{label}]: a non-finite loss")
    return state, hist, perf


def _falls(label, perf, classifier):
    loss, acc = perf["epoch_losses"], perf["train_accuracy"]
    if not loss[-1] < loss[0]:
        raise RuntimeError(f"workload[{label}]: train loss did not fall "
                           f"({loss})")
    if classifier and not acc[-1] > acc[0]:
        raise RuntimeError(f"workload[{label}]: train accuracy did not "
                           f"rise ({acc})")


def phase_workloads():
    """Phase 21; returns each workload's figures."""
    import torch

    from distributed_deep_learning_tpu_torch import native

    where = (f"loaded from {native.library_path().relative_to(ROOT)}"
             if native.get_lib() is not None
             else "not loaded (the NumPy fallbacks run)")
    print(f"workloads: host-data library {where}")
    perf = {}
    for w in WORKLOADS:
        # torch's default; the CLI's f32 run must switch it off itself
        torch.backends.cudnn.allow_tf32 = True
        _, _, perf[w] = _workload_run(w)
        if torch.backends.cudnn.allow_tf32:
            raise RuntimeError(f"workload[{w}]: the f32 run left cuDNN's "
                               "TF32 on")
        _falls(w, perf[w], w in CLASSIFIERS)
        cpu = first_step_loss(w, WORKLOAD_FLAGS, "cpu")
        perf[w]["first_loss_rel"] = check_first_loss(
            f"workload[{w}] card vs cpu", perf[w]["first_loss"], cpu,
            FIRST_LOSS_TOL)
        busy, wall, top, _ = device_busy_share(w)
        step_ms = perf[w]["step_s"] * 1e3
        share = ("not measured (the profiler saw no device time)"
                 if busy is None else
                 f"{busy:.3f} ms of kernels a step: idle share "
                 f"{1 - busy / step_ms:.3f} of the unprofiled "
                 f"{step_ms:.3f} ms step")
        print(f"workload[{w}]: profiled 8 steps: {wall:.3f} ms a step on "
              f"the synchronised host clock, {share}; largest: "
              + "; ".join(f"{name} {ms:.3f} ms x{n:g}"
                          for name, ms, n in top))
        if w == PREFETCH_WORKLOAD:
            perf[w]["prefetch"] = prefetch_ab(w, WORKLOAD_FLAGS, w)
    print("workloads: kernel launches " + ", ".join(
        f"{name} {sum(p['launches'][name] for p in perf.values())}"
        for name in perf[WORKLOADS[0]]["launches"])
        + " (this path has no attention)")
    return perf


def phase_workload_variants(perf21):
    """Phase 22: bf16, ``-m data`` at world 1, ``--double-softmax`` and
    ``--remat`` beside phase 21's runs; returns their figures."""
    cnn = perf21["cnn"]
    out = {}
    _, _, out["cnn bf16"] = _workload_run(
        "cnn", "-e", "1", "--dtype", "bfloat16", label="cnn bf16")
    check_first_loss("workload[cnn bf16] vs phase 21",
                     out["cnn bf16"]["first_loss"], cnn["first_loss"],
                     BF16_FIRST_LOSS_TOL)
    _, _, out["cnn data"] = _workload_run("cnn", "-e", "1", "-m", "data",
                                          label="cnn data")
    check_first_loss("workload[cnn data] vs phase 21",
                     out["cnn data"]["first_loss"], cnn["first_loss"],
                     DATA_FIRST_LOSS_TOL)
    _, _, out["mlp double-softmax"] = _workload_run(
        "mlp", "--double-softmax", label="mlp double-softmax")
    _falls("mlp double-softmax", out["mlp double-softmax"], False)
    _, _, out["cnn remat"] = _workload_run("cnn", "-e", "1", "--remat",
                                           label="cnn remat")
    check_first_loss("workload[cnn remat] vs phase 21",
                     out["cnn remat"]["first_loss"], cnn["first_loss"],
                     DATA_FIRST_LOSS_TOL)
    print(f"workload[cnn remat]: peak memory "
          f"{out['cnn remat']['peak'] / 2**20:.1f} MiB against "
          f"{cnn['peak'] / 2**20:.1f} MiB without --remat")
    return out


def phase_workload_checkpoint():
    """Phase 23: the saved ``cnn`` model restored by ``--resume``."""
    import torch

    from distributed_deep_learning_tpu_torch.__main__ import main as cli

    ckdir = ROOT / "build" / "chip_smoke_cnn_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    flags = ("-e", "1", "--checkpoint-dir", str(ckdir))
    state, hist, _ = _workload_run("cnn", *flags, label="cnn checkpoint")
    saved = {k: v.clone() for k, v in state.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    del state
    restored, rhist = cli(["cnn", *WORKLOAD_FLAGS, *flags, "--resume"])
    if [h.phase for h in rhist] != ["test"]:
        raise RuntimeError(f"checkpoint[cnn]: the resumed run ran "
                           f"{[h.phase for h in rhist]}, not the test only")
    got, want = rhist[0], hist[-1]
    rel = max(_rel(got.loss, want.loss),
              _rel(got.accuracy, want.accuracy) if want.accuracy else 0.0)
    buffers = {k: v for k, v in restored.model.state_dict().items()
               if k in saved}
    same = sum(bool(torch.equal(buffers[k], v)) for k, v in saved.items())
    moved = sum(bool((v - 1).abs().max() > 1e-3) for k, v in saved.items()
                if k.endswith("running_var"))
    print(f"checkpoint[cnn]: restored test loss {got.loss:.9f} accuracy "
          f"{got.accuracy:.3f} against the saved model's {want.loss:.9f} "
          f"{want.accuracy:.3f} (rel diff {rel:.2e}, tol {RESTORE_TOL:g}); "
          f"{same} of {len(saved)} BatchNorm running buffers equal to the "
          f"saved ones, {moved} running variances moved off 1")
    shutil.rmtree(ckdir)
    if not rel <= RESTORE_TOL or same != len(saved) or not moved:
        raise RuntimeError("checkpoint[cnn]: the restored model is not the "
                           "saved one")


# --- phases 24-26: the north-star zoo ----------------------------------------

#: flash attentions a layer drives: the encoder's and the decoder's
#: self-attention and the cross-attention (seq2seq), BERT's one
ZOO_ATTENTIONS = {"transformer": 3, "bert": 1}
ZOO_ROWS, ZOO_T, ZOO_BATCH = 96, 512, 8
ZOO_VOCAB = {"transformer": 32000, "bert": 30522}
ZOO_LAYERS = {"transformer": 6, "bert": 12}
ZOO_WIDTH = {"transformer": 512, "bert": 768}
#: phase 24: ResNet-18 on the CIFAR twin, ResNet-50 on a packed 224 px
#: ImageNet twin of 512 images, 10 classes
RESNET18_FLAGS = ("-s", "18", "-e", "1", "-b", "128")
IMAGENET_ROWS, IMAGENET_SIZE, IMAGENET_BATCH = 512, 224, 32
S2D_TOL = 1e-4
#: the zoo's profiler window: train steps after warm-up steps (the
#: 96-row token runs have 8 train steps)
ZOO_PROFILE = dict(steps=5, warmup=2)


def check_launches(label: str, launches: dict, want: dict) -> None:
    print(f"{label}: launches {launches}, expected {want}")
    if launches != want:
        raise RuntimeError(f"{label}: an attention of a step did not go "
                           "through the flash kernels")


def _write_zoo_tokens(workload: str) -> Path:
    """A seeded ``tokens.npy`` of 96 rows of 512 ids under ``build/``.
    ``transformer``: source ids in each row's first half with a ragged pad
    tail (128-256 ids kept), the target half a copy of the source's first
    128-L ids (a task the model can learn), padded after them.  ``bert``:
    ids with a ragged pad tail (256-512 kept).  Row 0 holds the largest
    id, so the vocabulary read from the file is the base model's."""
    import numpy as np

    rng = np.random.default_rng(24 + len(workload))
    vocab = ZOO_VOCAB[workload]
    rows = np.zeros((ZOO_ROWS, ZOO_T), np.int32)
    half = ZOO_T // 2
    for r in range(ZOO_ROWS):
        ids = rng.integers(1, vocab, size=ZOO_T)
        if workload == "transformer":
            ls = int(rng.integers(half // 2, half + 1))
            lt = int(rng.integers(half // 2, ls + 1))
            rows[r, :ls] = ids[:ls]
            rows[r, half:half + lt] = ids[:lt]
        else:
            n = int(rng.integers(half, ZOO_T + 1))
            rows[r, :n] = ids[:n]
    rows[0, 0] = vocab - 1
    if workload == "transformer":
        rows[0, half] = vocab - 1
    out = ROOT / "build" / f"chip_smoke_{workload}_tokens"
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "tokens.npy", rows)
    return out


def step_operations(workload: str, argv) -> float:
    """Operations of one train step of ``workload`` under ``argv`` on the
    card, its first batch: torch's ``FlopCounterMode`` over the step
    (products and convolutions, forward and backward) plus the flash
    kernels' products on the pairs each launch's mask leaves visible
    (``FLASH_PAIR_OPS``)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from distributed_deep_learning_tpu_torch.ops import attention as fa

    state, step, train = _step_setup(workload, argv, "cuda")
    x, y = next(iter(train.iter_batches()))
    flash, real = [0], fa._launch
    names = {"flash_fwd_launch": "flash_forward",
             "flash_dq_launch": "flash_backward_dq",
             "flash_dkv_launch": "flash_backward_dkv"}

    def counting(name, q, k, v, key_valid, tensors, **kw):
        flash[0] += FLASH_PAIR_OPS[names[name]] * q.shape[-1] * \
            _visible_pairs(q, k, key_valid, kw["causal"], kw["window"])
        return real(name, q, k, v, key_valid, tensors, **kw)

    fa._launch = counting
    try:
        with FlopCounterMode(display=False) as counter:
            step(state, x, y)
        torch.cuda.synchronize()
    finally:
        fa._launch = real
    return counter.get_total_flops() + flash[0]


def _zoo_run(workload: str, argv, label: str, unit: str, per_step: int):
    """One CLI run of phases 24-26 (``argv`` only) through
    :func:`_workload_run`, its train steps' losses printed."""
    _, _, perf = _workload_run(workload, *argv, label=label, base=(),
                               per_step=per_step, unit=unit)
    print(f"workload[{label}]: train step losses "
          + " ".join(f"{x:.5f}" for x in perf["step_losses"]))
    return perf


def _zoo_profile(workload: str, argv, label: str, perf, ops=None,
                 data: bool = False) -> None:
    """Phase 21's profiler window on ``argv`` (the ``-m data`` step when
    ``data``) and the step's operations (``ops``, or
    :func:`step_operations`'s count) bound at the bf16 tensor-core rate,
    beside the run's step time."""
    busy, wall, top, flash = device_busy_share(workload, argv=argv,
                                               data=data, **ZOO_PROFILE)
    step_ms = perf["step_s"] * 1e3
    ops = ops or step_operations(workload, argv)
    bound = ops / BF16_FLOPS_PER_S * 1e3
    perf.update(busy_ms=busy, flash_ms=flash, ops=ops, bound_ms=bound)
    share = ("not measured (the profiler saw no device time)"
             if busy is None else
             f"{busy:.3f} ms of kernels a step ({flash:.3f} ms in the flash "
             f"kernels): idle share {1 - busy / step_ms:.3f} of the "
             f"unprofiled {step_ms:.3f} ms step")
    print(f"workload[{label}]: profiled {ZOO_PROFILE['steps']} steps: "
          f"{wall:.3f} ms a step on the synchronised host clock, {share}; "
          "largest: " + "; ".join(f"{name} {ms:.3f} ms x{n:g}"
                                  for name, ms, n in top))
    print(f"workload[{label}]: {ops / 1e12:.4f} TFLOP a train step: bound "
          f"{bound:.4f} ms at {BF16_FLOPS_PER_S / 1e12:g} TFLOP/s against "
          f"{step_ms:.4f} ms measured ({bound / step_ms:.1%} of bound)")


def _no_flash(label, perf):
    if any(perf["launches"].values()):
        raise RuntimeError(f"workload[{label}]: the flash kernels ran "
                           f"{perf['launches']} on a ResNet")


def _write_imagenet_cache() -> Path:
    """The seeded ImageNet twin (512 images of 224 px, 10 classes) packed
    under ``build/`` with the port's ``pack_dataset``."""
    from distributed_deep_learning_tpu_torch.data.datasets import \
        synthetic_imagenet
    from distributed_deep_learning_tpu_torch.data.packed import pack_dataset

    path = ROOT / "build" / "chip_smoke_imagenet.ddlpack"
    t0 = time.perf_counter()
    header = pack_dataset(synthetic_imagenet(
        n=IMAGENET_ROWS, image_size=IMAGENET_SIZE, num_classes=10, seed=0),
        path)
    print(f"resnet: packed {header['num_samples']} images "
          f"{header['feature_shape']} {header['feature_dtype']} into "
          f"{path.relative_to(ROOT)} ({header['total_bytes'] / 2**20:.1f} "
          f"MiB) in {time.perf_counter() - t0:.1f} s")
    return path


def s2d_forward_gap(cache: Path) -> float:
    """The first train step's forward of ResNet-50 in f32 with the 7×7
    stem and with the space-to-depth stem holding the mapped 7×7 weights,
    on the run's first batch: the largest gap over max|logit|."""
    import torch

    from distributed_deep_learning_tpu_torch.models.resnet import \
        space_to_depth_stem_kernel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    argv = ["-s", "50", "-b", str(IMAGENET_BATCH), "--packed-cache",
            str(cache)]
    plain, _, train = _step_setup("resnet", argv, "cuda")
    s2d, _, _ = _step_setup("resnet", [*argv, "--stem-s2d"], "cuda")
    sd = plain.model.state_dict()
    sd["stem.conv.weight"] = space_to_depth_stem_kernel(
        sd["stem.conv.weight"])
    s2d.model.load_state_dict(sd)
    x, _ = next(iter(train.iter_batches()))
    with torch.no_grad():
        a = plain.model.train()(x)
        b = s2d.model.train()(x)
    return float((a - b).abs().max() / a.abs().max())


def phase_resnet():
    """Phase 24; returns each run's figures."""
    import torch

    out = {}
    # (a) the CLI default, f32 with cuDNN's TF32 on before the run
    torch.backends.cudnn.allow_tf32 = True
    steps = split_steps(2048, 128)
    out["resnet18"] = perf = _zoo_run("resnet", RESNET18_FLAGS, "resnet18",
                                      "images", 128)
    if torch.backends.cudnn.allow_tf32:
        raise RuntimeError("workload[resnet18]: the f32 run left cuDNN's "
                           "TF32 on")
    losses = perf["step_losses"]
    if len(losses) != steps[0] or not losses[-1] < losses[0]:
        raise RuntimeError(f"workload[resnet18]: {len(losses)} steps "
                           f"(expected {steps[0]}), losses {losses[0]} -> "
                           f"{losses[-1]} did not fall")
    cpu = first_step_loss("resnet", RESNET18_FLAGS, "cpu")
    check_first_loss("workload[resnet18] card vs cpu", perf["first_loss"],
                     cpu, FIRST_LOSS_TOL)
    _no_flash("resnet18", perf)
    _zoo_profile("resnet", RESNET18_FLAGS, "resnet18", perf)
    # (b) ResNet-50 at 224 px from a packed cache, s2d and 7x7 stems
    cache = _write_imagenet_cache()
    flags = ("-s", "50", "-e", "1", "-b", str(IMAGENET_BATCH), "--dtype",
             "bfloat16", "--packed-cache", str(cache))
    for stem, extra in (("s2d", ("--stem-s2d",)), ("7x7", ())):
        label = f"resnet50 bf16 {stem}"
        out[label] = perf = _zoo_run("resnet", (*flags, *extra), label,
                                     "images", IMAGENET_BATCH)
        _no_flash(label, perf)
        _zoo_profile("resnet", (*flags, *extra), label, perf)
    out["resnet50 bf16 s2d"]["prefetch"] = prefetch_ab(
        "resnet", (*flags, "--stem-s2d"), "resnet50 bf16 s2d")
    gap = s2d_forward_gap(cache)
    print(f"workload[resnet50]: f32 first-step forward, s2d stem at the "
          f"7x7 stem's mapped weights: largest gap {gap:.2e} of max|logit| "
          f"(tol {S2D_TOL:g})")
    cache.unlink()
    if not gap <= S2D_TOL:
        raise RuntimeError("workload[resnet50]: the s2d stem is not the 7x7 "
                           "stem")
    return out


def phase_zoo_lm(workload: str):
    """Phase 25 (``transformer``) or 26 (``bert``): flash f32, dense f32
    and flash bf16 at full width on a seeded tokens.npy; returns each
    run's figures."""
    data = _write_zoo_tokens(workload)
    layers = ZOO_LAYERS[workload]
    base = ("-l", str(layers), "-s", str(ZOO_WIDTH[workload]), "-e", "1",
            "-b", str(ZOO_BATCH), "--data-dir", str(data))
    want = expected_launches(ZOO_ATTENTIONS[workload] * layers,
                             split_steps(ZOO_ROWS, ZOO_BATCH))
    runs, out = (("flash", ()), ("dense", ()), ("flash bf16",
                                                ("--dtype", "bfloat16"))), {}
    for label, extra in runs:
        attention = label.split()[0]
        argv = (*base, "--attention", attention, *extra)
        name = f"{workload} {label}"
        out[label] = perf = _zoo_run(workload, argv, name, "tokens",
                                     ZOO_BATCH * ZOO_T)
        check_launches(f"workload[{name}]",
                       {k: perf["launches"][k] for k in want},
                       want if attention == "flash"
                       else dict.fromkeys(want, 0))
        _zoo_profile(workload, argv, name, perf)
    check_first_loss(f"workload[{workload}] dense vs flash",
                     out["dense"]["first_loss"], out["flash"]["first_loss"],
                     FIRST_LOSS_TOL)
    check_first_loss(f"workload[{workload}] bf16 vs f32",
                     out["flash bf16"]["first_loss"],
                     out["flash"]["first_loss"], BF16_FIRST_LOSS_TOL)
    shutil.rmtree(data)
    return out


# --- phases 27-29: the staged modes and the pipelined trunk -----------------

#: phase 27: the reference's workloads (CLI defaults) and ResNet-18 on the
#: CIFAR twin, each staged in two
STAGED_WORKLOADS = {"mlp": (), "cnn": (), "lstm": (), "mnist": (),
                    "resnet": ("-s", "18")}
STAGED_BASE = ("-e", "1", "-b", "32")
STAGED_MODES = {"model": ("-m", "model", "--nstages", "2"),
                "pipeline": ("-m", "pipeline", "--nstages", "2", "-p", "8")}
#: -m model's first loss against -m sequential's at the same weights, and
#: -m pipeline's on the card against the CPU's (relative)
STAGED_MODEL_TOL, STAGED_PIPE_TOL = 1e-5, 1e-4
#: phase 28: GPT-2-small (12 layers, d 768) on phase 8's T 2048 rows, 4
#: stages of 1-row microbatches (M 8), each schedule
PIPE_FLAGS = ("-l", "12", "-s", "768", "-e", "1", "-b", "8", "-p", "1",
              "--nstages", "4", "--attention", "flash")
PIPE_BATCH, PIPE_M, PIPE_LAYERS = 8, 8, 12
SCHEDULES = {"gpipe": (),
             "1f1b": ("--pipeline-schedule", "1f1b"),
             "interleaved": ("--pipeline-schedule", "interleaved",
                             "--virtual-stages", "3")}
#: flash forwards a layer a microbatch a train step: GPipe's backward
#: keeps the forward's; 1F1B and interleaved compute each block again in
#: the backward, but for the last virtual stage's (1/(S·V) of the
#: blocks), whose forward only keeps its input
PIPE_FORWARDS = {"gpipe": 1, "1f1b": 2 - Fraction(1, 4),
                 "interleaved": 2 - Fraction(1, 4 * 3)}
#: the schedules' first f32 losses against each other and the
#: unpipelined walk (relative), their trunk gradients (of max|g|), bf16's
#: first loss against f32's; the walk with dense attention is held to
#: phases 25-26's dense-vs-flash ``FIRST_LOSS_TOL``
PIPE_LOSS_TOL, PIPE_GRAD_TOL, PIPE_BF16_TOL = 1e-5, 1e-3, 2e-2
#: 1F1B bf16's trunk gradients against f32's (of max|g|): read 7.87e-3 on
#: an H100, and 0.210 with the last microbatch's gradient dropped
PIPE_BF16_GRAD_TOL = 5e-2
PIPE_PROFILE = dict(steps=3, warmup=1)


def _staged_setup(workload: str, argv, device: str):
    """``(trainer, state, train loader)`` of a staged CLI run built as
    ``run_workload`` builds it, the loader set to epoch 1."""
    from distributed_deep_learning_tpu_torch.utils.config import parse_args
    from distributed_deep_learning_tpu_torch.utils.logging import \
        PhaseLogger
    from distributed_deep_learning_tpu_torch.workloads import get_spec
    from distributed_deep_learning_tpu_torch.workloads.base import \
        staged_setup

    cfg = parse_args([*argv, "-d", device], workload=workload)
    trainer, state, _, (train, _, _) = staged_setup(
        get_spec(workload), cfg, PhaseLogger(verbose=False))
    train.set_epoch(1)
    return trainer, state, train


def staged_first_losses(workload: str) -> dict:
    """Phase 27's first-step checks of ``workload``: ``-m model`` against
    ``-m sequential`` from the sequential model's weights mapped through
    ``split_state_dict`` (and how far the seeded staged init lies from
    them), ``-m pipeline`` on the card against the CPU."""
    import torch

    from distributed_deep_learning_tpu_torch.parallel.staging import \
        layer_state_dict

    base = (*STAGED_WORKLOADS[workload], *STAGED_BASE)
    state, step, train = _step_setup(workload, base, "cuda")
    seq_sd = {k: v.detach().clone()
              for k, v in layer_state_dict(state.model).items()}
    x, y = next(train.iter_batches())
    seq = step(state, x, y)[1]["loss"].item()
    del state
    trainer, st, train = _staged_setup(
        workload, (*base, *STAGED_MODES["model"]), "cuda")
    mapped = trainer.staged.from_sequential(seq_sd)
    seeded = trainer.staged.state_dict()
    if set(mapped) != set(seeded):
        raise RuntimeError(f"staged[{workload}]: split_state_dict keys "
                           f"{sorted(set(mapped) ^ set(seeded))[:4]} differ")
    init_gap = max(float((seeded[k].float() - v.to(seeded[k].device)
                          .float()).abs().max()) for k, v in mapped.items())
    trainer.staged.load_state_dict(mapped)
    x2, y2 = next(train.iter_batches())
    if not torch.equal(x2.cpu(), x.cpu()):
        raise RuntimeError(f"staged[{workload}]: another first batch")
    model = trainer.train_step(st, x2, y2)[1]["loss"].item()
    del trainer, st
    out = {"sequential": seq, "model": model, "init_gap": init_gap}
    for device in ("cuda", "cpu"):
        trainer, st, train = _staged_setup(
            workload, (*base, *STAGED_MODES["pipeline"]), device)
        out[f"pipeline {device}"] = trainer.train_step(
            st, *next(train.iter_batches()))[1]["loss"].item()
    print(f"staged[{workload}]: the seeded staged init lies "
          f"{init_gap:.1e} from the sequential weights (layer order)")
    out["model_rel"] = check_first_loss(
        f"staged[{workload} model] vs sequential", model, seq,
        STAGED_MODEL_TOL)
    out["pipeline_rel"] = check_first_loss(
        f"staged[{workload} pipeline] card vs cpu", out["pipeline cuda"],
        out["pipeline cpu"], STAGED_PIPE_TOL)
    return out


def phase_staged():
    """Phase 27; returns each run's figures."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for w, flags in STAGED_WORKLOADS.items():
        out[w] = staged_first_losses(w)
        for mode, mflags in STAGED_MODES.items():
            label = f"{w} {mode}"
            _, _, perf = _workload_run(w, *flags, *STAGED_BASE, *mflags,
                                       base=(), label=label)
            if any(perf["launches"].values()):
                raise RuntimeError(f"workload[{label}]: kernels launched "
                                   f"{perf['launches']} on a path without "
                                   "attention")
            out[w][mode] = perf
    return out


def _global_layers(trunk, tensors: dict) -> list[dict]:
    """``tensors`` (the trunk's stacked names → stacked tensors: its
    parameters or their gradients) as one dict a layer in the model's
    layer order (virtual stage ``v`` holds layers ``v·k .. v·k + k-1``)."""
    n_blocks = len(trunk.stage.blocks)
    layers = []
    for v in range(trunk.n_stages * trunk.n_chunks):
        for i in range(n_blocks):
            pre = f"blocks.{i}."
            layers.append({k[len(pre):]: t[trunk._index(v)]
                           for k, t in tensors.items() if k.startswith(pre)})
    return layers


def _pipeline_setup(argv, device="cuda"):
    """``(config, state, train_step, train loader)`` of a ``gpt -m
    pipeline`` run built as the CLI builds it, the loader at epoch 1."""
    from distributed_deep_learning_tpu_torch.utils.config import parse_args
    from distributed_deep_learning_tpu_torch.utils.logging import \
        PhaseLogger
    from distributed_deep_learning_tpu_torch.workloads import get_spec
    from distributed_deep_learning_tpu_torch.workloads.base import \
        pipelined_setup

    cfg = parse_args(["-m", "pipeline", *argv, "-d", device], workload="gpt")
    cfg, state, step, _, _, (train, _, _) = pipelined_setup(
        get_spec("gpt"), cfg, PhaseLogger(verbose=False))
    train.set_epoch(1)
    return cfg, state, step, train


def dense_walk(model, x, y) -> float:
    """The unpipelined walk's loss with the trunk's attention dense: a
    reference that runs no flash kernel."""
    import torch

    from distributed_deep_learning_tpu_torch.train.objectives import \
        TokenCrossEntropy

    blocks = model.trunk.stage.blocks
    kinds = [b.attention for b in blocks]
    for b in blocks:
        b.attention = "dense"
    try:
        with torch.no_grad():
            return TokenCrossEntropy()(model.eval().apply_sequential(x),
                                       y).item()
    finally:
        for b, kind in zip(blocks, kinds):
            b.attention = kind


def drop_last_microbatch(model, n_microbatches: int) -> None:
    """A planted fault: the head passes the last of a step's
    ``n_microbatches`` outputs on without a gradient, so that microbatch
    adds nothing to the trunk's gradients."""
    head, calls = model.head.forward, []

    def dropped(x):
        calls.append(1)
        out = head(x)
        return out if len(calls) < n_microbatches else \
            out.detach() + 0 * out
    model.head.forward = dropped


def pipeline_step(data_dir: Path, schedule: str, *extra,
                  dense: bool = False, planted: bool = False) -> dict:
    """One train step of phase 28's model under ``schedule`` on the first
    batch: its loss, the unpipelined walk's loss at the same weights
    before it (and with ``dense`` the dense walk's), each layer's weights
    and trunk gradients, the flash kernels' launches (zeroed just before)
    and the step's peak memory; ``planted`` drops the last microbatch's
    gradient (:func:`drop_last_microbatch`)."""
    import torch

    from distributed_deep_learning_tpu_torch.train.objectives import \
        TokenCrossEntropy

    gc.collect()
    torch.cuda.empty_cache()
    cfg, state, step, train = _pipeline_setup(
        (*PIPE_FLAGS, *SCHEDULES[schedule], "--data-dir", str(data_dir),
         *extra))
    model = state.model
    x, y = next(train.iter_batches())
    with torch.no_grad():
        walk = TokenCrossEntropy()(model.eval().apply_sequential(x),
                                   y).item()
    dense_loss = dense_walk(model, x, y) if dense else None
    weights = [{k: v.detach().float().cpu().clone() for k, v in layer.items()}
               for layer in _global_layers(model.trunk,
                                           model.trunk.stacked())]
    if planted:
        drop_last_microbatch(model, PIPE_M)
    for c in _kernel_counters():
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    loss = step(state, x, y)[1]["loss"].item()
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in _kernel_counters()}
    grads = [{k: g.detach().float().cpu().clone() for k, g in layer.items()}
             for layer in _global_layers(
                 model.trunk, {k: p.grad for k, p in
                               model.trunk.stacked().items()})]
    out = dict(loss=loss, walk=walk, dense_walk=dense_loss, weights=weights,
               grads=grads, launches=launches, peak=torch.cuda.max_memory_allocated(),
               resident=before)
    del state, model
    return out


def _max_gap(a: list[dict], b: list[dict]) -> float:
    """The largest gap between two per-layer tensor lists over the
    largest magnitude of the second."""
    top = max(float(t.abs().max()) for layer in b for t in layer.values())
    gap = max(float((layer_a[k] - t).abs().max())
              for layer_a, layer_b in zip(a, b)
              for k, t in layer_b.items())
    return gap / top


def _pipeline_run(data_dir: Path, label: str, *flags, per_step: int,
                  argv=PIPE_FLAGS, workload="gpt", unit="tokens"):
    """One ``-m pipeline`` CLI epoch (``argv``, ``flags``) through
    :func:`_workload_run`, its train steps' losses printed."""
    _, hist, perf = _workload_run(
        workload, "-m", "pipeline", *argv, "--data-dir", str(data_dir),
        *flags, base=(), label=label, per_step=per_step, unit=unit)
    print(f"workload[{label}]: train step losses "
          + " ".join(f"{x:.5f}" for x in perf["step_losses"]))
    return hist, perf


def _pipeline_profile(data_dir: Path, flags, label: str, perf):
    """Phase 28's profiler window over a run's steps (``flags`` after
    ``PIPE_FLAGS``), its kernel time and idle share beside the CLI run's
    step time."""
    _, state, step, train = _pipeline_setup(
        (*PIPE_FLAGS, *flags, "--data-dir", str(data_dir)))
    busy, wall, top, flash = profile_window(step, state, train,
                                            **PIPE_PROFILE)
    del state
    step_ms = perf["step_s"] * 1e3
    perf.update(busy_ms=busy, flash_ms=flash)
    share = ("not measured (the profiler saw no device time)"
             if busy is None else
             f"{busy:.3f} ms of kernels a step ({flash:.3f} ms in the flash "
             f"kernels): idle share {1 - busy / step_ms:.3f} of the "
             f"unprofiled {step_ms:.3f} ms step")
    print(f"workload[{label}]: profiled {PIPE_PROFILE['steps']} steps: "
          f"{wall:.3f} ms a step on the synchronised host clock, {share}; "
          "largest: " + "; ".join(f"{name} {ms:.3f} ms x{n:g}"
                                  for name, ms, n in top))


def phase_pipeline(data_dir: Path):
    """Phase 28; returns each schedule's figures."""
    steps = {}
    for schedule in SCHEDULES:
        steps[schedule] = pipeline_step(data_dir, schedule,
                                        dense=schedule == "gpipe")
    bf16 = ("--dtype", "bfloat16")
    steps["1f1b bf16"] = pipeline_step(data_dir, "1f1b", *bf16)
    steps["1f1b bf16 planted"] = pipeline_step(data_dir, "1f1b", *bf16,
                                               planted=True)
    ref = steps["gpipe"]
    for name, rec in steps.items():
        if name != "gpipe" and _max_gap(rec["weights"], ref["weights"]):
            raise RuntimeError(f"pipeline[{name}]: initialised off gpipe's "
                               "weights")
        print(f"pipeline[{name}] first step: loss {rec['loss']:.9f}, the "
              f"unpipelined walk {rec['walk']:.9f}; launches "
              f"{rec['launches']}; peak {rec['peak'] / 2**30:.2f} GiB "
              f"({rec['resident'] / 2**30:.2f} GiB of weights and state "
              "before it)")
    for name in SCHEDULES:
        rec = steps[name]
        check_first_loss(f"pipeline[{name}] vs the unpipelined walk",
                         rec["loss"], ref["walk"], PIPE_LOSS_TOL)
        check_first_loss(f"pipeline[{name}] vs the dense walk", rec["loss"],
                         ref["dense_walk"], FIRST_LOSS_TOL)
        check_first_loss(f"pipeline[{name}] vs gpipe", rec["loss"],
                         ref["loss"], PIPE_LOSS_TOL)
        gap = _max_gap(rec["grads"], ref["grads"])
        print(f"pipeline[{name}]: trunk gradients {gap:.2e} of max|g| from "
              f"gpipe's (tol {PIPE_GRAD_TOL:g})")
        if not gap <= PIPE_GRAD_TOL:
            raise RuntimeError(f"pipeline[{name}]: trunk gradients off "
                               "gpipe's")
        want = {"flash_forward": int(PIPE_FORWARDS[name] * PIPE_LAYERS
                                     * PIPE_M),
                "flash_backward_dq": PIPE_LAYERS * PIPE_M,
                "flash_backward_dkv": PIPE_LAYERS * PIPE_M}
        check_launches(f"pipeline[{name}] one train step",
                       {k: rec["launches"][k] for k in want}, want)
    check_first_loss("pipeline[1f1b bf16] vs f32", steps["1f1b bf16"]["loss"],
                     steps["1f1b"]["loss"], PIPE_BF16_TOL)
    gaps = {name: _max_gap(steps[name]["grads"], steps["1f1b"]["grads"])
            for name in ("1f1b bf16", "1f1b bf16 planted")}
    for name, gap in gaps.items():
        print(f"pipeline[{name}]: trunk gradients {gap:.2e} of max|g| from "
              f"1f1b f32's (tol {PIPE_BF16_GRAD_TOL:g})")
    if not gaps["1f1b bf16"] <= PIPE_BF16_GRAD_TOL:
        raise RuntimeError("pipeline[1f1b bf16]: trunk gradients off f32's")
    if gaps["1f1b bf16 planted"] <= PIPE_BF16_GRAD_TOL:
        raise RuntimeError("pipeline[1f1b bf16 planted]: a dropped "
                           "microbatch lies within the bf16 gradient limit")
    for name in ("1f1b", "interleaved"):
        print(f"pipeline[{name}]: peak {steps[name]['peak'] / 2**30:.2f} GiB "
              f"against gpipe's {ref['peak'] / 2**30:.2f} GiB")
        if not steps[name]["peak"] < ref["peak"]:
            raise RuntimeError(f"pipeline[{name}]: peak memory not below "
                               "gpipe's")
    runs = {}
    tokens = PIPE_BATCH * TRAIN_T
    epoch = split_steps(TRAIN_ROWS, PIPE_BATCH)
    for name, flags in (*SCHEDULES.items(),
                        ("1f1b bf16", (*SCHEDULES["1f1b"], "--dtype",
                                       "bfloat16"))):
        label = f"gpt pipeline {name}"
        _, runs[name] = _pipeline_run(data_dir, label, *flags,
                                      per_step=tokens)
        want = expected_launches(PIPE_LAYERS * PIPE_M, epoch,
                                 PIPE_FORWARDS[name.split()[0]])
        check_launches(f"workload[{label}]",
                       {k: runs[name]["launches"][k] for k in want}, want)
        _pipeline_profile(data_dir, flags, label, runs[name])
    return steps, runs


#: phase 29: BERT-base and transformer-base pipelined (gpipe, M 4 of 2
#: rows), gpt staged in two with dense attention
ZOO_PIPE = {"bert": ("--nstages", "4", "-p", "2"),
            "transformer": ("--nstages", "2", "-p", "2")}


def phase_pipeline_zoo(data_dir: Path):
    """Phase 29; returns each run's figures."""
    out = {}
    for workload, flags in ZOO_PIPE.items():
        data = _write_zoo_tokens(workload)
        layers = ZOO_LAYERS[workload]
        argv = ("-l", str(layers), "-s", str(ZOO_WIDTH[workload]), "-e", "1",
                "-b", str(ZOO_BATCH), "--attention", "flash", *flags)
        label = f"{workload} pipeline"
        _, out[workload] = _pipeline_run(
            data, label, argv=argv, workload=workload,
            per_step=ZOO_BATCH * ZOO_T)
        want = expected_launches(layers * ZOO_BATCH // 2,
                                 split_steps(ZOO_ROWS, ZOO_BATCH))
        check_launches(f"workload[{label}]",
                       {k: out[workload]["launches"][k] for k in want}, want)
        shutil.rmtree(data)
    label = "gpt model"
    _, _, out["gpt model"] = _workload_run(
        "gpt", "-m", "model", "--nstages", "2", "-l", str(TRAIN_LAYERS),
        "-s", "768", "-e", "1", "-b", str(TRAIN_BATCH), "--data-dir",
        str(data_dir), base=(), label=label, per_step=TRAIN_BATCH * TRAIN_T,
        unit="tokens")
    check_launches(f"workload[{label}]", out["gpt model"]["launches"],
                   dict.fromkeys(out["gpt model"]["launches"], 0))
    return out


# --- phase 30: moe, the GShard top-2 MoELM ----------------------------------

#: the CLI default width: 4 layers (1 and 3 routed, 8 experts top-2), d
#: 256, 4 heads, MLP 1024; one flash attention a layer
MOE_BASE = ("-l", "4", "-s", "256", "-e", "1")
MOE_LAYERS = 4
#: label -> (flags, rows, batch, T): (a) the synthetic MLM twin (1024 rows
#: of 64 ids; G 2048 tokens a step, capacity 512), (b) phase 26's BERT rows
#: (G 4096, capacity 1024), whose ragged pad tails drive the key mask
MOE_CONFIGS = {"mlm b32": ((), 1024, 32, 64),
               "bert rows b8": (("--data-dir",), ZOO_ROWS, ZOO_BATCH, ZOO_T)}


def moe_first_step(argv, device: str) -> dict:
    """The first train step's forward of ``moe`` under ``argv`` on
    ``device`` (the CLI's first batch and seeded initialisation), its
    routing read from each router's logits: the task loss, the sown
    load-balance term (what the step adds to the objective, not to the
    logged loss), each routed layer's dropped share of its token-expert
    assignments, the ``(G, E, C)`` shape and, on the card, the peak
    memory one ``top2_gating`` call adds (its dispatch and combine
    tensors and their intermediates)."""
    import torch

    from distributed_deep_learning_tpu_torch.models.layers import \
        collect_losses
    from distributed_deep_learning_tpu_torch.models.moe import (MoEMLP,
                                                               top2_gating)
    from distributed_deep_learning_tpu_torch.train.objectives import \
        TokenCrossEntropy

    state, _, train = _step_setup("moe", argv, device)
    batches = train.iter_batches()
    x, y = next(batches)
    batches.close()
    routed = [m for m in state.model.modules() if isinstance(m, MoEMLP)]
    logits = []
    hooks = [m.router.register_forward_hook(
        lambda mod, args, out: logits.append(out.detach())) for m in routed]
    with torch.no_grad(), collect_losses() as sown:
        pred = state.model.train()(x)
    for h in hooks:
        h.remove()
    out = {"loss": TokenCrossEntropy()(pred, y).item(),
           "aux": float(sum(sown)), "dropped": [], "peak": None}
    for mod, lg in zip(routed, logits):
        C = mod.capacity(lg.shape[0])
        if device == "cuda":
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        dispatch, _, _ = top2_gating(lg, C)
        if device == "cuda":
            torch.cuda.synchronize()
            out["peak"] = torch.cuda.max_memory_allocated() - base
        out["shape"] = tuple(dispatch.shape)
        out["dropped"].append(1 - dispatch.sum().item() / (2 * lg.shape[0]))
        del dispatch
    return out


def phase_moe():
    """Phase 30; returns each run's figures."""
    bert = _write_zoo_tokens("bert")
    out = {}
    for config, (flags, rows, batch, T) in MOE_CONFIGS.items():
        flags = (*flags, str(bert)) if flags else ()
        argv = (*MOE_BASE, "-b", str(batch), *flags)
        want = expected_launches(MOE_LAYERS, split_steps(rows, batch))
        for dtype in ("f32", "bf16"):
            label = f"moe {config} {dtype}"
            extra = ("--dtype", "bfloat16") if dtype == "bf16" else ()
            out[label] = perf = _zoo_run("moe", (*argv, *extra), label,
                                         "tokens", batch * T)
            check_launches(f"workload[{label}]",
                           {k: perf["launches"][k] for k in want}, want)
            first = moe_first_step((*argv, *extra), "cuda")
            peak = first["peak"]
            print(f"moe[{label}]: first step on the card: task loss "
                  f"{first['loss']:.9f} (the logged loss: "
                  f"{perf['first_loss']:.9f}), load-balance term "
                  f"{first['aux']:.9f} (added to the objective only); "
                  f"dropped share of token-expert assignments "
                  + ", ".join(f"{d:.4f}" for d in first["dropped"])
                  + f" (routed layers 1, 3); dispatch and combine "
                  f"{first['shape']} f32, one gating call's peak "
                  f"{peak / 2**20:.1f} MiB")
            if not (math.isfinite(first["aux"]) and first["aux"] > 0):
                raise RuntimeError(f"moe[{label}]: load-balance term "
                                   f"{first['aux']!r} not finite and "
                                   "positive")
            check_first_loss(f"moe[{label}] logged loss vs the task loss",
                             perf["first_loss"], first["loss"],
                             DATA_FIRST_LOSS_TOL)
            # the same shapes in either dtype: one operations count
            _zoo_profile("moe", (*argv, *extra), label, perf,
                         ops=out[f"moe {config} f32"].get("ops"))
        check_first_loss(f"moe[{config}] card vs cpu",
                         out[f"moe {config} f32"]["first_loss"],
                         first_step_loss("moe", argv, "cpu"),
                         FIRST_LOSS_TOL)
        check_first_loss(f"moe[{config}] bf16 vs f32",
                         out[f"moe {config} bf16"]["first_loss"],
                         out[f"moe {config} f32"]["first_loss"],
                         BF16_FIRST_LOSS_TOL)
        label = f"moe {config} data"
        out[label] = perf = _zoo_run("moe", (*argv, "-m", "data"), label,
                                     "tokens", batch * T)
        check_launches(f"workload[{label}]",
                       {k: perf["launches"][k] for k in want}, want)
        check_first_loss(f"moe[{config}] -m data world 1 vs sequential",
                         perf["first_loss"],
                         out[f"moe {config} f32"]["first_loss"],
                         DATA_FIRST_LOSS_TOL)
        _zoo_profile("moe", argv, label, perf,
                     ops=out[f"moe {config} f32"].get("ops"), data=True)
    shutil.rmtree(bert)
    return out


# --- phase 31: sharded training state ---------------------------------------

#: phase 8's rows cut to 4 train steps and a test step (DDL_DATA_LIMIT);
#: moe's MLM twin to 4 train steps at -b 32
SHARD_ROWS, MOE_SHARD_ROWS = 24, 192
#: a sharded run's first loss against the plain run's: the same
#: arithmetic at world 1 (FSDP's and ZeRO's collectives move whole
#: values), and across two ranks the split products' sums
SHARD_FIRST_LOSS_TOL, TWO_RANK_FIRST_LOSS_TOL = 1e-6, 1e-5

#: one rank of the two-rank legs, a job of :data:`RANK_JOBS` (the CLI's
#: bootstrap takes up its gloo group on card 0): a probe of the collectives the modes
#: need on CUDA tensors, then each leg through the CLI, the flash
#: kernels' launches and the head counts they saw recorded
TWO_RANK = r"""
import collections, json, os, statistics, sys, time
import torch
import torch.distributed as dist
from distributed_deep_learning_tpu_torch.__main__ import main as cli
from distributed_deep_learning_tpu_torch.ops import attention as fa

legs = json.loads(sys.argv[1])
rank = int(os.environ["RANK"])
dev = torch.device("cuda", 0)
probe = []
for op, fn in (
        ("all_reduce", lambda t: dist.all_reduce(t)),
        ("all_reduce max", lambda t: dist.all_reduce(t, op=dist.ReduceOp.MAX)),
        ("broadcast", lambda t: dist.broadcast(t, 0)),
        ("all_gather", lambda t: dist.all_gather([torch.empty_like(t)
                                                  for _ in range(2)], t)),
        ("new_group all_reduce", lambda t: dist.all_reduce(
            t, group=dist.new_group([0, 1])))):
    t = torch.full((4,), float(rank + 1), device=dev)
    try:
        fn(t)
        torch.cuda.synchronize()
        probe.append([op, None])
    except Exception as e:                      # report, do not run legs
        probe.append([op, f"{type(e).__name__}: {e}"[:300]])
# the explicit collectives' ops on CUDA tensors, as the port calls them
# (a send/recv crosses through host memory: collectives.host_staged),
# values checked
from distributed_deep_learning_tpu_torch.parallel import collectives as coll
i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)
ar = torch.full((4,), rank + 1, dtype=torch.int32, device=dev)
arb = torch.full((4,), rank + 1, dtype=torch.bfloat16, device=dev)
agi = torch.full((4,), rank + 1, dtype=torch.int8, device=dev)
rsf = torch.arange(4.0, device=dev) + 10 * rank


def gathered(t):
    out = t.new_empty(8)
    dist.all_gather_into_tensor(out, t)
    return out


def scattered(t):
    out = t.new_empty(2)
    dist.reduce_scatter_tensor(out, t)
    return out


def exchanged(t):
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t)
    return out


for op, t, fn, want in (
        ("all_reduce int32", ar, lambda t: dist.all_reduce(t) or t,
         i32(3, 3, 3, 3)),
        ("all_reduce bf16", arb, lambda t: dist.all_reduce(t) or t,
         i32(3, 3, 3, 3)),
        ("all_gather_into_tensor int8", agi, gathered,
         i32(1, 1, 1, 1, 2, 2, 2, 2)),
        ("reduce_scatter_tensor f32", rsf, scattered,
         i32(10, 12) if rank == 0 else i32(14, 16)),
        ("reduce_scatter_tensor int32", rsf.to(torch.int32), scattered,
         i32(10, 12) if rank == 0 else i32(14, 16)),
        ("all_to_all_single", rsf, exchanged,
         i32(0, 1, 10, 11) if rank == 0 else i32(2, 3, 12, 13)),
        ("batch_isend_irecv", rsf, lambda t: coll.Hop(t, None).wait(),
         i32(10, 11, 12, 13) if rank == 0 else i32(0, 1, 2, 3))):
    how = "host" if op == "batch_isend_irecv" and coll.host_staged(t, None) \
        else "direct"
    try:
        got = fn(t)
        torch.cuda.synchronize()
        err = None if torch.equal(got.to(torch.int32).cpu(), want.cpu()) \
            else f"wrong values {got.tolist()}, expected {want.tolist()}"
    except Exception as e:
        err = f"{type(e).__name__}: {e}"[:300]
    probe.append([f"{op} ({how})", err])
out = {"probe": probe}
if all(err is None for _, err in probe):
    heads, real = collections.Counter(), fa._launch

    def counting(name, q, *args, **kw):
        heads[f"{name} H={q.shape[2]}"] += 1
        return real(name, q, *args, **kw)

    fa._launch = counting
    counters = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)
    for label, leg in legs.items():
        os.environ["DDL_DATA_LIMIT"] = str(leg["rows"])
        heads.clear()
        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        state, hist = cli(leg["argv"])
        torch.cuda.synchronize()
        res = state.comm_residual or {}
        comm = type(state.comm).__name__
        residual = (max((float(r.abs().max()) for r in res.values()),
                        default=None),
                    all(bool(torch.isfinite(r).all()) for r in res.values()))
        del state, res
        train = hist[0]
        out[label] = {
            "residual_max": residual[0], "residual_finite": residual[1],
            "comm": comm,
            "first_loss": train.step_losses[0],
            "losses": train.step_losses,
            "step_s": statistics.median(train.step_seconds[1:]),
            "launches": {c.__name__: c.launches for c in counters},
            "heads": dict(heads),
            "peak": torch.cuda.max_memory_allocated()}
    os.environ.pop("DDL_DATA_LIMIT", None)
print("TWO_RANK " + json.dumps(out), flush=True)
"""


def sharded_busy_share(data_dir: Path, *flags, steps: int = 4,
                       warmup: int = 2):
    """``(busy ms, wall ms, top, flash ms)`` (:func:`profile_window`) a
    step of phase 31's ``gpt -m data`` at world 1 under ``flags``, the
    state and step made by the runner's ``train_setup`` (FSDP's hooks and
    ZeRO's optimizer as the CLI makes them), and the seconds the set-up
    and the window took."""
    from distributed_deep_learning_tpu_torch.runtime import bootstrap
    from distributed_deep_learning_tpu_torch.utils.config import parse_args
    from distributed_deep_learning_tpu_torch.utils.logging import \
        PhaseLogger
    from distributed_deep_learning_tpu_torch.workloads import get_spec
    from distributed_deep_learning_tpu_torch.workloads.base import \
        train_setup

    config = parse_args(["-m", "data", "-l", str(TRAIN_LAYERS), "-s", "768",
                         "-b", str(TRAIN_BATCH), "--attention", "flash",
                         "--data-dir", str(data_dir), *flags],
                        workload="gpt")
    gc.collect()
    t0 = time.perf_counter()
    env, created = bootstrap.initialize("cuda")
    try:
        state, step, _, (train, _, _), *_ = train_setup(
            get_spec("gpt"), config, env, None, PhaseLogger(verbose=False))
        train.set_epoch(1)
        t1 = time.perf_counter()
        got = profile_window(step, state, train, steps, warmup)
        return got, (t1 - t0, time.perf_counter() - t1)
    finally:
        if created:
            bootstrap.shutdown()


def sharded_legs(data_dir: Path) -> dict:
    """Phase 31's two-rank legs (:data:`TWO_RANK`)."""
    gpt_argv = ["gpt", "-m", "data", "-l", str(TRAIN_LAYERS), "-s", "768",
                "-e", "1", "-b", str(TRAIN_BATCH), "--attention", "flash",
                "--data-dir", str(data_dir), "--mesh", "model=2"]
    return {"gpt model=2": {"argv": gpt_argv, "rows": SHARD_ROWS},
            "moe expert=2": {"argv": ["moe", "-m", "data", *MOE_BASE, "-b",
                                      "32", "--mesh", "expert=2"],
                             "rows": MOE_SHARD_ROWS}}


def phase_sharded(data_dir: Path, data_perf=None) -> dict:
    """Phase 31; returns each run's figures (launches by kernel)."""
    want = expected_launches(TRAIN_LAYERS, split_steps(SHARD_ROWS,
                                                       TRAIN_BATCH))
    out = {}
    os.environ["DDL_DATA_LIMIT"] = str(SHARD_ROWS)
    try:
        for dtype in ("f32", "bf16"):
            extra = ("--dtype", "bfloat16") if dtype == "bf16" else ()
            runs = {}
            for zero in ("none", "1", "fsdp"):
                label = f"data {dtype}" + ("" if zero == "none"
                                           else f" zero {zero}")
                hist, launches, perf = _train(
                    data_dir, "flash", *extra, "--zero", zero, label=label,
                    mode="data")
                perf.pop("served")
                perf.update(first_loss=hist[0].step_losses[0],
                            losses=hist[0].step_losses, launches=launches)
                runs[zero] = out[label] = perf
                check_launches(f"sharded[{label}]", launches, want)
            plain = runs["none"]
            for zero in ("1", "fsdp"):
                perf = runs[zero]
                label = f"data {dtype} zero {zero}"
                check_first_loss(f"sharded[{label}] vs plain -m data",
                                 perf["first_loss"], plain["first_loss"],
                                 SHARD_FIRST_LOSS_TOL)
                print(f"sharded[{label}]: {perf['step_s']:.4f} s/step vs "
                      f"{plain['step_s']:.4f} plain; peak "
                      f"{perf['peak'] / 2**30:.2f} GiB vs "
                      f"{plain['peak'] / 2**30:.2f}; optimizer state a rank "
                      f"{perf['opt_state_bytes'] / 2**20:.1f} MiB vs "
                      f"{plain['opt_state_bytes'] / 2**20:.1f}; parameters "
                      f"a rank {perf['param_bytes'] / 2**20:.1f} MiB vs "
                      f"{plain['param_bytes'] / 2**20:.1f}"
                      + (f"; phase 11 (bf16, 48 rows): "
                         f"{data_perf['step_s']:.4f} s/step, peak "
                         f"{data_perf['peak'] / 2**30:.2f} GiB, optimizer "
                         f"state {data_perf['opt_state_bytes'] / 2**20:.1f}"
                         " MiB" if data_perf else ""))
        # where FSDP's extra bf16 step time goes: the card's kernel time
        # a step against the wall clock, plain and FSDP
        for zero in ("none", "fsdp"):
            label = "data bf16" + ("" if zero == "none" else " zero fsdp")
            (busy, wall, top, _), secs = sharded_busy_share(
                data_dir, "--dtype", "bfloat16", "--zero", zero)
            if busy is None:
                raise RuntimeError(f"sharded[{label}]: the profiler saw no "
                                   "device time")
            out[label].update(busy_ms=busy, wall_ms=wall,
                              idle=1 - busy / wall)
            print(f"sharded[{label}]: profiler window: the card busy "
                  f"{busy:.3f} ms of {wall:.3f} ms a step (idle share "
                  f"{1 - busy / wall:.3f}); set-up {secs[0]:.1f} s, window "
                  f"{secs[1]:.1f} s; top kernels "
                  + "; ".join(f"{k} {ms:.3f} ms x{n:g}"
                              for k, ms, n in top))
        # the world-1 reference of the expert leg
        moe_argv = ("-m", "data", *MOE_BASE, "-b", "32")
        os.environ["DDL_DATA_LIMIT"] = str(MOE_SHARD_ROWS)
        out["moe data f32"] = moe = _zoo_run("moe", moe_argv, "moe data f32",
                                             "tokens", 32 * 64)
    finally:
        os.environ.pop("DDL_DATA_LIMIT", None)
    records = rank_records(2, "TWO_RANK ")
    for op, err in records[0]["probe"]:
        print(f"two ranks on one card: gloo {op} of CUDA tensors: "
              + ("ok" if err is None else f"FAILED ({err})"))
    failed = sorted({op for r in records for op, err in r["probe"]
                     if err is not None})
    if failed:
        raise RuntimeError(f"two ranks on one card: gloo {failed} of CUDA "
                           "tensors failed, so the --mesh model|expert legs "
                           "did not run")
    refs = {"gpt model=2": (out["data f32"]["first_loss"], want, 12),
            "moe expert=2": (moe["first_loss"],
                             expected_launches(MOE_LAYERS, split_steps(
                                 MOE_SHARD_ROWS, 32)), 4)}
    for label, (ref, leg_want, heads) in refs.items():
        split = heads // 2 if label.startswith("gpt") else heads
        for rank, rec in enumerate(records):
            r = rec[label]
            check_first_loss(f"two-rank[{label}] rank {rank} vs world 1",
                             r["first_loss"], ref, TWO_RANK_FIRST_LOSS_TOL)
            check_launches(f"two-rank[{label}] rank {rank}", r["launches"],
                           leg_want)
            seen = {k.split(" H=")[1] for k in r["heads"]}
            print(f"two-rank[{label}] rank {rank}: {r['step_s']:.4f} s/step"
                  f" (gloo on one card), peak {r['peak'] / 2**30:.2f} GiB, "
                  f"flash launches by head count {r['heads']}")
            if seen != {str(split)}:
                raise RuntimeError(f"two-rank[{label}]: the flash kernels "
                                   f"saw {seen} heads, expected {split}")
        out[f"two-rank {label}"] = {"launches": records[0][label]["launches"],
                                    "step_s": records[0][label]["step_s"]}
    return out


# --- phase 32: compressed collectives and context parallelism -------------

#: JAX's int8 tolerance (tests/test_compress.py): a compressed leg's later
#: losses against world 1's; world 1 compresses nothing (1e-6)
COMM_LOSS_TOL, COMM_WORLD1_TOL = 5e-2, 1e-6
#: a --comm leg's first loss against world 1's: the first forward reads
#: the parameters through the quantized gather, so bf16 holds the two-rank
#: limit (read 2.7e-7 on the H100) and int8 about 25x its reading (4.05e-5)
COMM_FIRST_LOSS_TOL = {"bf16": 1e-5, "int8": 1e-3}
#: the context-parallel shape: each of two ranks holds T 2048, the training
#: shape's sequence
SEQ_SHAPE = dict(B=2, H=12, D=64, T=4096)
#: (label, dtype, causal, window, padded): the last masks keys with a
#: fully padded row
SEQ_CASES = (("causal f32", "f32", True, None, False),
             ("causal bf16", "bf16", True, None, False),
             ("window 1024 f32", "f32", True, 1024, False),
             ("padded non-causal f32", "f32", False, None, True))

#: one rank of phase 32's attention: ring attention and Ulysses (the flash
#: kernels inside) over the two ranks, each case's launches counted from
#: zero around one forward and backward, then timed; rank 0 also runs
#: single-rank flash_attention on the whole sequence and compares
SEQ_RANK = r"""
import json, os, sys, time
import torch
import torch.distributed as dist
from distributed_deep_learning_tpu_torch.ops import attention as fa
from distributed_deep_learning_tpu_torch.parallel import (ring_attention,
                                                          ulysses)

spec = json.loads(sys.argv[1])
rank = int(os.environ["RANK"])
dev = torch.device("cuda", 0)
group = dist.group.WORLD
B, H, D, T = (spec["shape"][x] for x in "BHDT")
counters = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)


def fwd_bwd(attn, q, k, v, do, kv, causal, window):
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    out = attn(qq, kk, vv, key_valid=kv, causal=causal, window=window)
    out.backward(do)
    return out.detach(), qq.grad, kk.grad, vv.grad


def timed(fn, reps=3, together=True):
    fn()
    if together:                 # both ranks start their reps at once
        dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


out = {}
for label, dtype, causal, window, padded in spec["cases"]:
    gen = torch.Generator().manual_seed(len(label))
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen).to(dt).to(dev)
                   for _ in range(4))
    kv = None
    if padded:
        kv = torch.rand(B, T, generator=gen) > 0.2
        kv[1] = False
        kv = kv.to(dev)
    rec = {}
    schemes = (("ring", ring_attention.make_attention_fn(group)),
               ("ulysses", ulysses.make_attention_fn(
                   group, inner=fa.make_attention_fn())))
    for name, attn in schemes:
        for c in counters:
            c.launches = 0
        got = fwd_bwd(attn, q, k, v, do, kv, causal, window)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        ms = timed(lambda: fwd_bwd(attn, q, k, v, do, kv, causal, window))
        rec[name] = {"launches": launches, "ms": ms}
        if rank == 0:
            rec[name]["got"] = got
    if rank == 0:
        flash = lambda q, k, v, *, key_valid, causal, window: \
            fa.flash_attention(q, k, v, key_valid=key_valid, causal=causal,
                               window=window)
        ref = fwd_bwd(flash, q, k, v, do, kv, causal, window)
        rec["flash_ms"] = timed(lambda: fwd_bwd(flash, q, k, v, do, kv,
                                                causal, window),
                                together=False)
        seen = torch.ones(B, T, dtype=torch.bool, device=dev) if kv is None \
            else kv.any(1)[:, None].expand(B, T)
        for name, _ in schemes:
            got = rec[name].pop("got")
            err = [float((got[0].float() - ref[0].float())[seen].abs().max())]
            for g, r in zip(got[1:], ref[1:]):
                err.append(float((g.float() - r.float()).abs().max())
                           / max(float(r.float().abs().max()), 1e-30))
            rec[name]["err"] = err
            rec[name]["finite"] = all(bool(torch.isfinite(t).all())
                                      for t in got)
            rec[name]["padded_zero"] = None if kv is None else \
                bool((got[0][~seen] == 0).all())
    out[label] = rec
print("SEQ_RANK " + json.dumps(out), flush=True)
"""


def comm_legs(data_dir: Path) -> dict:
    """Phase 32's two-rank legs (:data:`TWO_RANK`)."""
    base = ["gpt", "-m", "data", "-l", str(TRAIN_LAYERS), "-s", "768", "-e",
            "1", "-b", str(TRAIN_BATCH), "--attention", "flash",
            "--data-dir", str(data_dir)]
    return {label: {"argv": base + flags, "rows": SHARD_ROWS}
            for label, flags in (
                ("gpt grad-compress int8", ["--grad-compress", "int8"]),
                ("gpt fsdp comm int8 overlap",
                 ["--zero", "fsdp", "--comm", "int8", "--comm-overlap"]),
                ("gpt fsdp comm bf16", ["--zero", "fsdp", "--comm", "bf16"]))}


def _seq_payload() -> str:
    """Phase 32's ring attention and Ulysses cases (:data:`SEQ_RANK`)."""
    return json.dumps({"shape": SEQ_SHAPE, "cases": SEQ_CASES})


def phase_comm(data_dir: Path, sharded: dict) -> dict:
    """Phase 32; returns each leg's flash launches (``comm``) and each
    attention case's (``seq``)."""
    from distributed_deep_learning_tpu_torch.parallel.ring_attention import \
        ring_hops

    want = expected_launches(TRAIN_LAYERS, split_steps(SHARD_ROWS,
                                                       TRAIN_BATCH))
    out = {"comm": {}, "seq": {}}
    os.environ["DDL_DATA_LIMIT"] = str(SHARD_ROWS)
    try:
        plain = sharded.get("data f32")
        if plain is None:
            hist, launches, plain = _train(data_dir, "flash",
                                           label="data f32", mode="data")
            plain["losses"] = hist[0].step_losses
        for method in ("bf16", "int8"):
            label = f"data f32 grad-compress {method}"
            hist, launches, perf = _train(data_dir, "flash",
                                          "--grad-compress", method,
                                          label=label, mode="data")
            check_launches(f"comm[{label}]", launches, want)
            gap = max(_rel(a, b) for a, b in zip(hist[0].step_losses,
                                                 plain["losses"]))
            print(f"comm[{label}] at world 1: losses' largest rel diff "
                  f"from plain -m data {gap:.2e} (tol {COMM_WORLD1_TOL:g}; "
                  "one rank compresses nothing)")
            if not gap <= COMM_WORLD1_TOL:
                raise RuntimeError(f"comm[{label}]: world 1 moved the "
                                   "losses")
    finally:
        os.environ.pop("DDL_DATA_LIMIT", None)
    legs = comm_legs(data_dir)
    records = rank_records(2, "TWO_RANK ")
    for op, err in records[0]["probe"]:
        if "(" in op:                    # the explicit collectives' ops
            print(f"comm probe: {op} of CUDA tensors: "
                  + ("ok" if err is None else f"FAILED ({err})"))
    failed = sorted({op for r in records for op, err in r["probe"] if err})
    if failed:
        raise RuntimeError(f"comm probe: {failed} failed")
    for label in legs:
        # --grad-compress touches only the gradients, so the first loss is
        # world 1's; --comm's first forward reads the parameters through
        # the quantized gather, as JAX's does
        method = "int8" if "int8" in label else "bf16"
        first_tol = TWO_RANK_FIRST_LOSS_TOL if "grad-compress" in label \
            else COMM_FIRST_LOSS_TOL[method]
        for rank, rec in enumerate(records):
            r = rec[label]
            check_first_loss(f"comm[{label}] rank {rank} vs world 1",
                             r["first_loss"], plain["losses"][0], first_tol)
            gaps = [_rel(a, b) for a, b in zip(r["losses"][1:],
                                               plain["losses"][1:])]
            check_launches(f"comm[{label}] rank {rank}", r["launches"],
                           want)
            print(f"comm[{label}] rank {rank}: {r['step_s']:.4f} s/step "
                  f"(gloo on one card), peak {r['peak'] / 2**30:.2f} GiB, "
                  f"{r['comm']}; later losses' rel diff from world 1 "
                  + " ".join(f"{g:.2e}" for g in gaps)
                  + f" (tol {COMM_LOSS_TOL:g}); residual max "
                  f"{r['residual_max']}, finite {r['residual_finite']}")
            if not all(g <= COMM_LOSS_TOL for g in gaps):
                raise RuntimeError(f"comm[{label}]: a loss left JAX's int8 "
                                   "tolerance")
            if "int8" in label and not (r["residual_finite"]
                                        and (r["residual_max"] or 0) > 0):
                raise RuntimeError(f"comm[{label}]: the residual is not "
                                   "finite and nonzero")
        out["comm"][label] = {"launches": records[0][label]["launches"],
                              "step_s": records[0][label]["step_s"]}
    # ring attention and Ulysses over the two ranks
    records = rank_records(2, "SEQ_RANK ")
    Tl = SEQ_SHAPE["T"] // 2
    for label, dtype, causal, window, padded in SEQ_CASES:
        tol_o, tol_g = FLASH_TOL[dtype]
        ref = records[0][label]
        for name in ("ring", "ulysses"):
            r = ref[name]
            print(f"seq[{label}] {name}: O {r['err'][0]:.3e} (tol "
                  f"{tol_o:g}), dq/dk/dv rel "
                  + "/".join(f"{e:.2e}" for e in r["err"][1:])
                  + f" (tol {tol_g:g}) against single-rank flash; forward+"
                  f"backward {r['ms']:.3f} ms vs flash {ref['flash_ms']:.3f}"
                  f" ms; padded row zero {r['padded_zero']}")
            if not (r["finite"] and r["err"][0] <= tol_o
                    and all(e <= tol_g for e in r["err"][1:])):
                raise RuntimeError(f"seq[{label}] {name}: disagrees with "
                                   "single-rank flash attention")
            if name == "ring" and padded and not r["padded_zero"]:
                raise RuntimeError(f"seq[{label}]: the ring's fully padded "
                                   "row is not exactly 0")
            for rank, rec in enumerate(records):
                if name == "ring":
                    hops = sum(m is not None for _, m in ring_hops(
                        rank, 2, Tl, Tl, causal, window))
                else:
                    hops = 1
                seq_want = {"flash_forward": hops, "flash_backward_dq": hops,
                            "flash_backward_dkv": hops}
                check_launches(f"seq[{label}] {name} rank {rank}",
                               rec[label][name]["launches"], seq_want)
                out["seq"][f"{label} {name} rank {rank}"] = {
                    "launches": rec[label][name]["launches"]}
    return out


# --- phase 33: -m pipeline over a data x stage grid of ranks ----------------

#: phase 33: gpt at phase 28's width on phase 8's rows, 2 stages of 2-row
#: microbatches (M 4 of the 8-row batch); ranks share card 0 over gloo
GRID_FLAGS = ("-l", "12", "-s", "768", "-e", "1", "-b", "8", "-p", "2",
              "--nstages", "2", "--attention", "flash")
GRID_M, GRID_S = 4, 2
#: case -> (ranks, schedule, extra flags)
GRID_CASES = {
    "1f1b f32 2 ranks": (2, "1f1b", ()),
    "interleaved f32 2 ranks": (2, "interleaved", ("--virtual-stages",
                                                   "2")),
    "gpipe f32 2 ranks": (2, "gpipe", ()),
    "1f1b bf16 2 ranks": (2, "1f1b", ("--dtype", "bfloat16")),
    "1f1b f32 4 ranks": (4, "1f1b", ()),
}

#: one rank of phase 33, a job of :data:`RANK_JOBS`: each case as the CLI builds it (``pipelined_setup`` over the grid), one
#: train step with its loss, launches, peak and boundary bytes and this
#: rank's trunk gradients (a file a case), then a second step timed
GRID_RANK = r"""
import gc, json, os, sys, time
import torch
import torch.distributed as dist
from distributed_deep_learning_tpu_torch.ops import attention as fa
from distributed_deep_learning_tpu_torch.parallel import spmd_pipeline as sp
from distributed_deep_learning_tpu_torch.utils.config import parse_args
from distributed_deep_learning_tpu_torch.utils.logging import PhaseLogger
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from distributed_deep_learning_tpu_torch.workloads import get_spec

cases, out_dir = json.loads(sys.argv[1]), sys.argv[2]
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
counters = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)
out = {}
for label, argv in cases.items():
    cfg = parse_args(["-m", "pipeline", *argv], workload="gpt")
    grid, _ = tbase._pipeline_grid(cfg, tbase.pipeline_stages(cfg, world))
    cfg, state, step, _, _, (train, _, _) = tbase.pipelined_setup(
        get_spec("gpt"), cfg, PhaseLogger(verbose=False), grid=grid)
    train.set_epoch(1)
    batches = train.iter_batches()
    x, y = next(batches)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sp.sent_bytes = 0
    loss = step(state, x, y)[1]["loss"].item()
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    sent = sp.sent_bytes
    peak = torch.cuda.max_memory_allocated()
    trunk = state.model.trunk
    k, S = len(trunk.stage.blocks), grid.stages
    grads = {}
    for v in range(S * trunk.n_chunks):
        if v % S != grid.stage:
            continue
        idx = 0 if trunk.n_chunks == 1 else (v // S, 0)
        for i in range(k):
            pre = f"blocks.{i}."
            grads[v * k + i] = {
                n[len(pre):]: p.grad[idx].detach().float().cpu().clone()
                for n, p in trunk.stacked().items() if n.startswith(pre)}
    if grid.data == 0:
        torch.save(grads, os.path.join(out_dir, f"{label}-{rank}.pt"))
    x, y = next(batches)
    t0 = time.perf_counter()
    step(state, x, y)[1]["loss"].item()
    torch.cuda.synchronize()
    out[label] = {"loss": loss, "launches": launches, "sent": sent,
                  "peak": peak, "step_s": time.perf_counter() - t0,
                  "coord": [grid.data, grid.stage]}
    del state, step, train, batches
    gc.collect()
    torch.cuda.empty_cache()
print("GRID " + json.dumps(out), flush=True)
"""


def grid_launches(schedule: str, stage: int, stages: int, chunks: int,
                  layers: int, microbatches: int) -> dict:
    """The flash launches one train step gives rank ``stage`` of a grid:
    each of its layers' forward once a microbatch under GPipe, twice under
    1F1B and interleaved (the recompute) but for the last virtual stage's
    (its forward runs once, with the head); dQ and dK/dV once."""
    per_v = layers // (stages * chunks)
    mine = [v for v in range(stages * chunks) if v % stages == stage]
    last = stages * chunks - 1
    fwd = sum(per_v * microbatches * (1 if schedule == "gpipe" or v == last
                                      else 2) for v in mine)
    back = per_v * len(mine) * microbatches
    return {"flash_forward": fwd, "flash_backward_dq": back,
            "flash_backward_dkv": back}


def _n_ranks(script: str, args: list, tag: str, n: int,
             timeout: float = 300.0, env: dict | None = None) -> list[dict]:
    """Run ``script`` as ``n`` ranks on card 0 (torchrun's environment,
    the one card each rank's ``LOCAL_RANK``, and ``env``); returns the
    JSON each rank printed after ``tag``.  This process holds the ranks'
    rendezvous store on a port the OS picks
    (``runtime.bootstrap.host_store``; the ranks ``join`` it), so no other
    process can take the port first.  A rank that fails or is still
    running at ``timeout`` fails the phase (every rank is stopped)."""
    return _tagged(_collect(_spawn(script, args, n, env), timeout), tag, n)


def _spawn(script: str, args: list, n: int, env: dict | None) -> tuple:
    """Start ``script`` as ``n`` ranks on card 0 (see :func:`_n_ranks`);
    returns ``(processes, store)`` for :func:`_collect`."""
    from distributed_deep_learning_tpu_torch.runtime.bootstrap import (
        host_store, hosted_env)

    procs = []
    store = host_store()
    extra = {**hosted_env(store), **(env or {})}
    try:
        for rank in range(n):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                       LOCAL_RANK="0", OMP_NUM_THREADS="4",
                       PYTHONPATH=str(ROOT), **extra)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, *args], env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    except BaseException:
        _kill(procs)
        raise
    return procs, store


def _kill(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _collect(launch: tuple, timeout: float) -> list:
    """Wait for a launch's ranks (:func:`_spawn`), stopping any still
    running at ``timeout``; each rank's ``(exit code, output)``."""
    procs, store = launch
    outs = [""] * len(procs)
    try:
        for i, p in enumerate(procs):
            outs[i] = p.communicate(timeout=timeout)[0]
    finally:
        _kill(procs)
        del store                       # the ranks have ended
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _tagged(outputs: list, tag: str, n: int) -> list[dict]:
    """The JSON each rank printed once after ``tag``."""
    records = []
    for rank, (code, o) in enumerate(outputs):
        found = [line for line in o.splitlines() if line.startswith(tag)]
        if code or len(found) != 1:
            raise RuntimeError(f"{n} ranks on one card: rank {rank} exited "
                               f"{code}:\n{o[-3000:]}")
        records.append(json.loads(found[0][len(tag):]))
    return records


#: the phases whose work runs as ranks sharing card 0 (:func:`start_ranks`)
RANK_PHASES = {31, 32, 33, 41}

#: one launch of ranks: a gloo group on card 0 (the store
#: :func:`_spawn` holds), then, once the file ``SMOKE_GATE`` exists, the
#: rank scripts of this module listed in argv[1] (JSON ``[tag, script's
#: name, its arguments]``) in turn in that group, each job's seconds
#: printed after ``JOB_SECONDS``
RANK_JOBS = r"""
import gc, json, os, sys, time
import torch
import torch.distributed as dist
import chip_smoke
from distributed_deep_learning_tpu_torch.runtime.bootstrap import join

torch.cuda.set_device(0)
join("gloo", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]))
gate, t0 = os.environ["SMOKE_GATE"], time.monotonic()
while not os.path.exists(gate):
    if time.monotonic() - t0 > chip_smoke.GATE_TIMEOUT:
        sys.exit(f"the gate {gate} never opened")
    time.sleep(0.2)
seconds = {}
for tag, name, args in json.loads(sys.argv[1]):
    sys.argv = ["-c", *args]
    t0 = time.perf_counter()
    exec(compile(getattr(chip_smoke, name), name, "exec"),
         {"__name__": "__main__"})
    seconds[tag] = time.perf_counter() - t0
    gc.collect()                   # the next job starts from an empty card
    torch.cuda.empty_cache()
dist.destroy_process_group()
print("JOB_SECONDS " + json.dumps(seconds), flush=True)
"""

#: seconds ranks wait at their gate before they give up
GATE_TIMEOUT = 3600.0

#: each world's launch waiting at its gate: ``{world: (launch, gate,
#: jobs)}`` (:func:`start_ranks`)
LAUNCHES: dict = {}

#: each world's records once its launch ended: ``{world: {tag: each
#: rank's record}}`` (:func:`rank_records`)
RECORDS: dict = {}


def rank_jobs(phases: set, data_dir: Path) -> dict:
    """The ranks' jobs of ``phases``, by world: ``{world: [[tag, script's
    name, its arguments], ...]}``; phases 31 and 32's CLI legs share one
    job (:data:`TWO_RANK`)."""
    legs, jobs = {}, {}
    if 31 in phases:
        legs.update(sharded_legs(data_dir))
    if 32 in phases:
        legs.update(comm_legs(data_dir))
    if legs:
        jobs.setdefault(2, []).append(
            ["TWO_RANK ", "TWO_RANK", [json.dumps(legs)]])
    if 32 in phases:
        jobs.setdefault(2, []).append(
            ["SEQ_RANK ", "SEQ_RANK", [_seq_payload()]])
    if 33 in phases:
        for world, cases in grid_cases(data_dir).items():
            jobs.setdefault(world, []).append(
                ["GRID ", "GRID_RANK", [json.dumps(cases), str(GRID_DIR)]])
    if 41 in phases:
        jobs.setdefault(2, []).append(
            ["P41_RANK ", "P41_RANK", [json.dumps(P41_RANK_CALLS)]])
    return jobs


def start_ranks(phases: set, data_dir: Path) -> None:
    """Start one launch of ranks a world for the jobs of ``phases``
    (:func:`rank_jobs`): the ranks import torch and the port, make their
    group and wait at a gate file, which the first phase to read their
    records opens (:func:`rank_records`), so their start-up is off the
    phases' clocks.  Idle ranks hold a CUDA context each (peaks are read
    a process, so no phase's figures move); every one is stopped at
    exit."""
    import atexit

    work = ROOT / "build" / "chip_smoke_gates"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    if 33 in phases:
        _fresh_grid_dir()
    atexit.register(_stop_ranks)
    for world, jobs in rank_jobs(phases, data_dir).items():
        gate = work / f"world{world}.go"
        LAUNCHES[world] = (_spawn(RANK_JOBS, [json.dumps(jobs)], world,
                                  {"SMOKE_GATE": str(gate)}), gate, jobs)


def rank_records(world: int, tag: str) -> list[dict]:
    """Each rank's record of the job ``tag`` of ``world``'s launch; the
    first call for a world opens its gate and waits for all its jobs."""
    if world not in RECORDS:
        t0 = time.perf_counter()
        launch, gate, jobs = LAUNCHES.pop(world)
        gate.touch()
        outputs = _collect(launch, 900.0)
        tags = [job[0] for job in jobs] + ["JOB_SECONDS "]
        RECORDS[world] = {t: _tagged(outputs, t, world) for t in tags}
        spent = RECORDS[world]["JOB_SECONDS "][0]
        print(f"{world} ranks on one card: {time.perf_counter() - t0:.1f} s"
              " for one launch of " + ", ".join(
                  f"{t.strip()} ({spent[t]:.1f} s on rank 0)"
                  for t in tags[:-1]) + " (gloo)")
    return RECORDS[world][tag]


def _stop_ranks() -> None:
    for (procs, _), _, _ in LAUNCHES.values():
        _kill(procs)
    LAUNCHES.clear()


#: where phase 33's ranks leave their trunk gradients
GRID_DIR = ROOT / "build" / "chip_smoke_grid"


def grid_cases(data_dir: Path) -> dict:
    """Phase 33's cases by world: ``{world: {label: the CLI's argv}}``."""
    by_world: dict = {}
    for label, (world, schedule, extra) in GRID_CASES.items():
        by_world.setdefault(world, {})[label] = [
            *GRID_FLAGS, *SCHEDULES[schedule][:2], *extra, "--data-dir",
            str(data_dir), "-d", "cuda"]
    return by_world


def _fresh_grid_dir() -> None:
    shutil.rmtree(GRID_DIR, ignore_errors=True)
    GRID_DIR.mkdir(parents=True)


def phase_grid(data_dir: Path) -> dict:
    """Phase 33; returns each case's launches summed over its ranks."""
    import torch

    out_dir = GRID_DIR
    refs = {}
    for label, (_, schedule, extra) in GRID_CASES.items():
        key = (schedule, extra)
        if key not in refs:
            refs[key] = pipeline_step(data_dir, schedule, "--nstages",
                                      str(GRID_S), "-p", "2", *extra)
            gc.collect()
            torch.cuda.empty_cache()
    ranks = {world: rank_records(world, "GRID ")
             for world in grid_cases(data_dir)}
    summed = {}
    for label, (world, schedule, extra) in GRID_CASES.items():
        ref = refs[(schedule, extra)]
        recs = [r[label] for r in ranks[world]]
        bf16 = "bf16" in label
        chunks = 2 if schedule == "interleaved" else 1
        loss_tol = PIPE_BF16_TOL if bf16 else PIPE_LOSS_TOL
        grads = {}
        for rank in range(GRID_S):
            grads.update(torch.load(out_dir / f"{label}-{rank}.pt"))
        got = [grads[i] for i in range(len(grads))]
        gap = _max_gap(got, ref["grads"])
        grad_tol = PIPE_BF16_GRAD_TOL if bf16 else PIPE_GRAD_TOL
        for rec in recs:
            d, s = rec["coord"]
            check_first_loss(f"grid[{label}] rank ({d}, {s}) vs one process",
                             rec["loss"], ref["loss"], loss_tol)
            check_launches(f"grid[{label}] rank ({d}, {s}) one train step",
                           rec["launches"],
                           grid_launches(schedule, s, GRID_S, chunks,
                                         PIPE_LAYERS, GRID_M))
        share = {k: sum(rec["launches"][k] for rec in recs[:GRID_S])
                 for k in recs[0]["launches"]}
        check_launches(f"grid[{label}] data coordinate 0's stages against "
                       "one process", share,
                       {k: int(ref["launches"][k]) for k in share})
        print(f"grid[{label}]: trunk gradients {gap:.2e} of max|g| from "
              f"one process's (tol {grad_tol:g}); a step "
              f"{max(r['step_s'] for r in recs):.3f} s (slowest rank; one "
              f"process {ref['loss']:.6f} loss), peak a rank "
              + "/".join(f"{r['peak'] / 2**30:.2f}" for r in recs)
              + " GiB, sent a step "
              + "/".join(f"{r['sent'] / 2**20:.1f}" for r in recs)
              + " MiB by rank; launches by rank "
              + "; ".join(str(r["launches"]) for r in recs))
        if not gap <= grad_tol:
            raise RuntimeError(f"grid[{label}]: trunk gradients off one "
                               "process's")
        summed[label] = {"launches": {k: sum(r["launches"][k] for r in recs)
                                      for k in recs[0]["launches"]},
                         "step_s": max(r["step_s"] for r in recs)}
    shutil.rmtree(out_dir, ignore_errors=True)
    return summed


# --- phase 34: training resilience -------------------------------------------

#: phase 34: phase 31's gpt on its 24 rows in bf16 (4 train steps of 4
#: rows and a test step), -m data at world 1; the anomaly lands on step 3
#: (the sentinel's warm-up is 2 steps)
RESILIENCE_FLAGS = ("-m", "data", "-l", str(TRAIN_LAYERS), "-s", "768",
                    "-e", "1", "-b", str(TRAIN_BATCH), "--attention",
                    "flash", "--dtype", "bfloat16")
RESILIENCE_STEP = 3
#: logits scaled this much on the spiked step: a gradient-norm spike
SPIKE_SCALE = 1e3
SENTINEL_AB = ("off", "skip", "skip", "off")
#: train steps timed after an asynchronous save (against plain steps)
ASYNC_AFTER = 2
#: GPU clock cycles the planted race holds a save's copy back (~1 s at
#: the H100's clocks, several train steps)
RACE_CYCLES = 2_000_000_000


@contextlib.contextmanager
def one_shot_hook(module, step_of, step: int, fn):
    """A forward hook on ``module`` that replaces its output by
    ``fn(output)`` during global train step ``step`` only (``step_of()``
    reads the step being run), once."""
    fired = []

    def hook(_, __, output):
        if step_of() == step and not fired:
            fired.append(step)
            return fn(output)
        return output
    handle = module.register_forward_hook(hook)
    try:
        yield fired
    finally:
        handle.remove()


def _counting(step):
    """``step`` wrapped to count its calls (the global step it runs is
    ``calls["n"]`` while it runs)."""
    calls = {"n": 0}

    def run(state, x, y):
        calls["n"] += 1
        return step(state, x, y)
    return run, calls


def _resilience_setup(data_dir: Path, *flags):
    """``(config, state, train_step, eval_step, loaders, checkpointer
    parts)`` of phase 34's run as the CLI builds it at world 1, the
    sentinel's warm-up cut to 2 steps (a run has 4)."""
    import dataclasses

    from distributed_deep_learning_tpu_torch.runtime import bootstrap
    from distributed_deep_learning_tpu_torch.workloads import base
    from distributed_deep_learning_tpu_torch.utils.config import parse_args
    from distributed_deep_learning_tpu_torch.utils.logging import \
        PhaseLogger
    from distributed_deep_learning_tpu_torch.workloads import get_spec
    from distributed_deep_learning_tpu_torch.workloads.base import \
        train_setup

    config = parse_args([*RESILIENCE_FLAGS, "--data-dir", str(data_dir),
                         *flags], workload="gpt")
    env, _ = bootstrap.initialize("cuda")
    real = base._sentinel_config

    def warm_in_two(cfg):
        sentinel = real(cfg)
        return None if sentinel is None else \
            dataclasses.replace(sentinel, warmup_steps=2)
    base._sentinel_config = warm_in_two
    try:
        state, step, ev, loaders, _, ckpt, _ = train_setup(
            get_spec("gpt"), config, env, None, PhaseLogger(verbose=False))
    finally:
        base._sentinel_config = real
    return config, state, step, ev, loaders, ckpt


def _same_state(a, b, label: str) -> None:
    from distributed_deep_learning_tpu_torch.utils.determinism import \
        diff_trees

    bad = diff_trees(a, b)
    print(f"resilience[{label}]: {len(bad)} differing leaves")
    if bad:
        raise RuntimeError(f"resilience[{label}]: not bit-identical at "
                           f"{bad[:5]}")


def phase_resilience(data_dir: Path) -> dict:
    """Phase 34; returns the launches of its main path (the elastic CLI
    run with the injected failure)."""
    import torch

    from distributed_deep_learning_tpu_torch.__main__ import main as cli
    from distributed_deep_learning_tpu_torch.runtime import bootstrap
    from distributed_deep_learning_tpu_torch.train import loop
    from distributed_deep_learning_tpu_torch.train import sentinel as sen
    from distributed_deep_learning_tpu_torch.train.elastic import \
        fit_with_recovery
    from distributed_deep_learning_tpu_torch.utils import checkpoint as ck
    from distributed_deep_learning_tpu_torch.utils import failures
    from distributed_deep_learning_tpu_torch.utils.chaos import ChaosPlan
    from distributed_deep_learning_tpu_torch.train.state import TrainState
    from distributed_deep_learning_tpu_torch.utils.determinism import (
        check_step_determinism, diff_trees, load_tree, state_tree)
    from distributed_deep_learning_tpu_torch.workloads.base import \
        _reset_fn

    os.environ["DDL_DATA_LIMIT"] = str(SHARD_ROWS)
    base = ROOT / "build" / "chip_smoke_resilience"
    shutil.rmtree(base, ignore_errors=True)
    cfg_kw = dict(warmup_steps=2)
    try:
        # the precondition: one step twice from one state, bit-identical
        # (this plain run is also the sentinel's cost's baseline and the
        # asynchronous save's state)
        _, off_state, off_step, _, off_loaders, _ = _resilience_setup(
            data_dir)
        off_loaders[0].set_epoch(1)
        x, y = next(off_loaders[0].iter_batches())
        check_step_determinism(off_step, off_state, x, y)
        print("resilience[determinism]: two train steps from one state "
              "bit-identical (parameters, AdamW moments, step, generator)")

        # --sentinel skip: NaN activations on step 3 vs the skip-set run
        _, state, step, ev, loaders, _ = _resilience_setup(
            data_dir, "--sentinel", "skip")
        cfg = sen.SentinelConfig(policy="skip", **cfg_kw)
        init = state_tree(state)
        counted, calls = _counting(step)
        codes = []

        def recording(st, x, y):
            st, m = counted(st, x, y)
            codes.append(int(float(m["anomaly_code"])))
            return st, m
        with one_shot_hook(state.model.tok, lambda: calls["n"],
                           RESILIENCE_STEP, lambda o: o * float("nan")):
            state, _ = loop.fit(state, recording, ev, *loaders, epochs=1,
                                sentinel=cfg)
        poisoned = state_tree(state)
        load_tree(state, init)
        state.sentinel = sen.SentinelState()
        state, _ = loop.fit(state, step, ev, *loaders, epochs=1,
                            sentinel=cfg, skip_steps={RESILIENCE_STEP})
        print(f"resilience[sentinel skip]: codes by step {codes}")
        if codes[RESILIENCE_STEP - 1] != sen.NONFINITE or \
                sum(c != sen.OK for c in codes) != 1:
            raise RuntimeError("resilience[sentinel skip]: the NaN step was "
                               "not the one NONFINITE verdict")
        _same_state(poisoned, state_tree(state), "sentinel skip vs the "
                    "skip-set run")

        # a gradient-norm spike: the logits scaled on step 3
        load_tree(state, init)
        state.sentinel = sen.SentinelState()
        counted, calls = _counting(step)
        codes.clear()
        with one_shot_hook(state.model, lambda: calls["n"], RESILIENCE_STEP,
                           lambda o: o * SPIKE_SCALE):
            state, _ = loop.fit(state, recording, ev, *loaders, epochs=1,
                                sentinel=cfg)
        print(f"resilience[grad spike x{SPIKE_SCALE:g}]: codes by step "
              f"{codes}")
        if codes[RESILIENCE_STEP - 1] != sen.GRAD_SPIKE:
            raise RuntimeError("resilience[grad spike]: not GRAD_SPIKE")

        # --sentinel halt: raises within one step, naming step 3
        load_tree(state, init)
        state.sentinel = sen.SentinelState()
        counted, calls = _counting(step)
        halt = sen.SentinelConfig(policy="halt", **cfg_kw)
        try:
            with one_shot_hook(state.model.tok, lambda: calls["n"],
                               RESILIENCE_STEP, lambda o: o * float("nan")):
                loop.fit(state, counted, ev, *loaders, epochs=1,
                         sentinel=halt)
            raise RuntimeError("resilience[sentinel halt]: did not raise")
        except sen.AnomalyError as e:
            print(f"resilience[sentinel halt]: {e}; {calls['n']} steps "
                  "run")
            if e.global_step != RESILIENCE_STEP or \
                    calls["n"] > RESILIENCE_STEP + 1:
                raise RuntimeError("resilience[sentinel halt]: not within "
                                   "one step") from e

        # the sentinel's cost: skip against off, in turns
        times = {"off": [], "skip": []}
        for kind in SENTINEL_AB:
            st, fn = (off_state, off_step) if kind == "off" else \
                (state, step)
            fn(st, x, y)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(4):
                fn(st, x, y)
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) / 4)
        off_s, skip_s = (statistics.median(times[k]) for k in ("off",
                                                                "skip"))
        print(f"resilience[sentinel overhead]: {skip_s * 1e3:.2f} ms a step "
              f"with --sentinel skip against {off_s * 1e3:.2f} ms off "
              f"({skip_s / off_s - 1:+.1%}; {SENTINEL_AB} in turns, 4 steps "
              "each)")

        # an asynchronous save of the full state: the training it stops,
        # save()'s return plus what the steps after it take beyond plain
        # steps (the fence wait, the copy's share of the card and PCIe,
        # the writer thread's share of the host); the first save in a
        # process also allocates the pinned buffers
        ckpt = ck.Checkpointer(base / "async", shared=False)

        def step_s():
            t0 = time.perf_counter()
            off_step(off_state, x, y)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        plain = statistics.median(step_s() for _ in range(ASYNC_AFTER))
        stops = {}
        for n, kind in enumerate(("first", "warm"), start=1):
            want = ck.state_payload(off_state)
            t0 = time.perf_counter()
            ckpt.save(n, off_state, wait=False)
            ret = time.perf_counter() - t0
            extra = sum(step_s() for _ in range(ASYNC_AFTER)) \
                - ASYNC_AFTER * plain
            ckpt.wait_until_finished()
            written = time.perf_counter() - t0
            got = torch.load(base / "async" / f"ckpt-{n}.pt",
                             weights_only=True)
            _same_state(got, want, f"{kind} async save vs the state at "
                        "the save")
            stops[kind] = (ret, extra, written)
            del want, got
        t0 = time.perf_counter()
        ckpt.save(3, off_state, wait=True)
        sync_s = time.perf_counter() - t0
        size = os.path.getsize(base / "async" / "ckpt-1.pt")
        for kind, (ret, extra, written) in stops.items():
            print(f"resilience[async save, {kind}]: {size / 2**30:.2f} "
                  f"GiB; training stopped {ret + extra:.3f} s (save() "
                  f"{ret:.3f} s + the next {ASYNC_AFTER} steps "
                  f"{extra:+.3f} s over plain {plain * 1e3:.2f} ms "
                  f"steps; on disk {written:.3f} s after the save) against "
                  f"{sync_s:.3f} s (wait=True)")

        # the planted race on the card: the side stream held back
        # RACE_CYCLES before its copies, a train step at once; with the
        # fence the file is the state at the save, without it (a fence
        # wait that does nothing) the update reaches the file
        real_stream, real_wait = ck._side_stream, TrainState.wait_fence

        def held_back(device):
            side = real_stream(device)
            with torch.cuda.stream(side):
                torch.cuda._sleep(RACE_CYCLES)
            return side
        ck._side_stream = held_back
        try:
            for n, fenced in ((4, True), (5, False)):
                if not fenced:
                    TrainState.wait_fence = lambda self: None
                want = ck.state_payload(off_state)
                ckpt.save(n, off_state, wait=False)
                off_step(off_state, x, y)
                torch.cuda.synchronize()
                ckpt.wait_until_finished()
                TrainState.wait_fence = real_wait
                off_state.fence = None
                got = torch.load(base / "async" / f"ckpt-{n}.pt",
                                 weights_only=True)
                bad = diff_trees(got, want)
                print(f"resilience[async fence]: copy held "
                      f"{RACE_CYCLES:.0e} cycles, "
                      f"{'fenced' if fenced else 'planted unfenced'}: "
                      f"{len(bad)} differing leaves")
                if fenced and bad:
                    raise RuntimeError(f"resilience[async fence]: the "
                                       f"fenced save differs at {bad[:5]}")
                if not fenced and not any(b.startswith("/params/")
                                          for b in bad):
                    raise RuntimeError("resilience[async fence]: the "
                                       "planted race was not caught")
                del want, got
        finally:
            ck._side_stream, TrainState.wait_fence = real_stream, real_wait
        del off_state, off_step, ckpt

        # --sentinel rollback --elastic vs the replay
        load_tree(state, init)
        state.sentinel = sen.SentinelState()
        rollback = sen.SentinelConfig(policy="rollback", **cfg_kw)
        counted, calls = _counting(step)
        make_state = _reset_fn(state)
        with ck.Checkpointer(base / "rollback", shared=False) as c, \
                one_shot_hook(state.model.tok, lambda: calls["n"],
                              RESILIENCE_STEP, lambda o: o * float("nan")):
            state, _ = fit_with_recovery(
                make_state, counted, ev, loaders, epochs=1, checkpointer=c,
                checkpoint_every=2, sentinel=rollback, max_restarts=2)
        rolled = state_tree(state)
        load_tree(state, init)
        state.sentinel = sen.SentinelState()
        state, _ = loop.fit(state, step, ev, *loaders, epochs=1,
                            sentinel=rollback,
                            skip_steps={RESILIENCE_STEP})
        _same_state(rolled, state_tree(state), "rollback vs the replay")
        del state, step, init, rolled, poisoned
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        bootstrap.shutdown()

    # --elastic through the CLI: a failure after step 3, one restart
    argv = ["gpt", *RESILIENCE_FLAGS, "--data-dir", str(data_dir),
            "--elastic", "--checkpoint-every", "2"]
    for c in _kernel_counters():
        c.launches = 0
    t0 = time.perf_counter()
    clean, _ = cli(argv + ["--checkpoint-dir", str(base / "clean")])
    clean_s = time.perf_counter() - t0
    clean_launches = {c.__name__: c.launches for c in _kernel_counters()}
    clean_tree = state_tree(clean)
    del clean
    for c in _kernel_counters():
        c.launches = 0
    failed_at = []
    real = loop.maybe_inject_step_failure

    def timed(gstep):
        try:
            real(gstep)
        except RuntimeError:
            failed_at.append(time.perf_counter())
            raise
    os.environ["DDL_INJECT_STEP_FAILURE"] = f"0:{RESILIENCE_STEP}"
    failures._step_injected = False
    loop.maybe_inject_step_failure = timed
    try:
        t0 = time.perf_counter()
        hurt, _ = cli(argv + ["--checkpoint-dir", str(base / "hurt")])
        done = time.perf_counter()
    finally:
        loop.maybe_inject_step_failure = real
        del os.environ["DDL_INJECT_STEP_FAILURE"]
    launches = {c.__name__: c.launches for c in _kernel_counters()}
    if len(failed_at) != 1:
        raise RuntimeError("resilience[elastic]: the failure did not fire "
                           "once")
    _same_state(clean_tree, state_tree(hurt), "elastic vs uninterrupted")
    print(f"resilience[elastic]: one restart; {done - failed_at[0]:.3f} s "
          f"from the failure to completion, {done - t0:.3f} s in all "
          f"against {clean_s:.3f} s uninterrupted; launches {launches} "
          f"against {clean_launches}")
    replayed = RESILIENCE_STEP - 2       # restored from step 2
    check_launches("resilience[elastic] launches", launches, {
        k: clean_launches[k] + replayed * TRAIN_LAYERS
        for k in clean_launches if k != "paged_flash_decode"}
        | {"paged_flash_decode": 0})

    # a truncated latest save: quarantined, the older step restored
    c = ck.Checkpointer(base / "hurt", shared=False)
    steps = c.all_steps()
    ChaosPlan.truncate_checkpoint(str(base / "hurt"), steps[-1])
    restored, used = c.restore_verified(hurt)
    quarantined = sorted(os.listdir(base / "hurt" / "quarantine"))
    print(f"resilience[truncated save]: steps {steps}, step {steps[-1]} "
          f"cut in half; restored step {used}; quarantine {quarantined}")
    if used != steps[-2] or not quarantined:
        raise RuntimeError("resilience[truncated save]: no fallback to the "
                           "older step")
    del hurt, restored, c
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(base, ignore_errors=True)
    return {"launches": launches}


# --- phase 35: serving resilience and the fleet -----------------------------

#: phase 35's cut of phase 4's trace: its first 8 requests (data depth cut
#: so that some twenty serving runs fit the phase's time)
RESILIENT_REQUESTS = 8
#: the 2-slot priority-pressure trace's engine (the fleet drill's, at full
#: width): two priority-2 requests, then a priority-0 and a priority-1
PREEMPT_ENGINE = dict(max_slots=2, max_len=48, kv_block_size=16,
                      prefill_chunk=16)
#: the fleet drill's straggler (5 virtual seconds a tick past 1 s) and
#: the evacuation it triggers
EVAC_FLEET = dict(slow_tick_s=1.0, degrade_after=1, evacuate_on="degraded")


#: the CLI legs: a few training steps, then the trace under the
#: supervisor (a deadline, a reload watch on an empty directory,
#: admission control, a priority mix with preemption over the device
#: wire), and again through two replicas with evacuation and autoscaling
SERVE_SUPERVISED_FLAGS = (
    "--serve", "--paged", "--priority-classes", "0=0.25,1=0.5,2=0.25",
    "--serve-deadline-ms", "600000", "--admission", "depth=16",
    "--migrate", "device", "--max-slots", "4")
SERVE_FLEET_FLAGS = SERVE_SUPERVISED_FLAGS + (
    "--replicas", "2", "--evacuate-on", "degraded", "--autoscale",
    "min=1,max=3,patience=2,cool=2")
_SERVE_FLEET_LINE = re.compile(
    r'"serve\(fleet\): (\d+) requests over (\d+) replicas, \d+ tokens, '
    r'rounds=\d+, lost=(\d+), .*? launches=(\d+)')
_SERVE_SUPERVISED_LINE = re.compile(
    r'"serve\(supervised\): restarts=(\d+), lost=(\d+), deadline_misses='
    r'\d+, ticks=\d+, reload swaps=(\d+) rollbacks=\d+ rejected=\d+, '
    r'admission level=\d+ shed=\d+"')


def _snapshot_supervisor(engine, **kw):
    """A :class:`..serve.supervisor.ServeSupervisor` that keeps, in
    ``before_fault``, each request's committed tokens after the last tick
    that landed before its first fault."""
    from distributed_deep_learning_tpu_torch.serve.supervisor import \
        ServeSupervisor

    class Snapshotting(ServeSupervisor):
        before_fault: dict = {}

        def _on_tick(self, report):
            super()._on_tick(report)
            if not self.faults:
                self.before_fault = self.ledger.snapshot()

    return Snapshotting(engine, **kw)


@contextlib.contextmanager
def _tick_calls():
    """Count the calls of every decode tick whose body launches the paged
    decode kernel (the canary's among them) while the block runs."""
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode
    from distributed_deep_learning_tpu_torch.serve.graphs import DecodeTick

    calls, real = {"n": 0, "canary": 0}, DecodeTick.__call__

    def counted(self, engine):
        if paged_flash_decode in self.counters:
            calls["n"] += 1
            calls["canary"] += self is getattr(engine, "_canary_tick", None)
        return real(self, engine)

    DecodeTick.__call__ = counted
    try:
        yield calls
    finally:
        DecodeTick.__call__ = real


class _Margins:
    """A tick observer (a supervisor's ``fleet_hook``) recording, for every
    token a fault-free run commits, the top-2 logit margin of the tick that
    chose it and (``keep_rows``) the logits row itself; token 0 comes from
    the chunk prefill and is filled in by :func:`_chunk_logits`."""

    def __init__(self, keep_rows=False):
        self.margin, self.rows, self.seen = {}, {}, {}
        self.keep_rows = keep_rows

    def __call__(self, report, *_):
        import torch

        if report.kind != "decode":
            for uid, _ in report.emitted:
                self.seen[uid] = 1
            return
        logits = report.engine._last_logits
        sel = logits[torch.as_tensor(report.slots, device=logits.device)]
        top2 = torch.topk(sel, 2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        for j, (uid, _) in enumerate(report.emitted):
            k = self.seen.get(uid, 0)
            self.margin.setdefault(uid, {})[k] = gaps[j]
            if self.keep_rows:
                self.rows.setdefault(uid, {})[k] = sel[j].clone()
            self.seen[uid] = k + 1


def _chunk_logits(eng, stream):
    """``(len(stream), V)`` f32 logits at every position of ``stream``
    through ``eng``'s chunk prefill (a scratch slot of the reset engine,
    chunks of ``eng.chunk`` from position 0), the pad id masked as the
    tick masks it."""
    import numpy as np
    import torch

    from distributed_deep_learning_tpu_torch.serve import paged
    from distributed_deep_learning_tpu_torch.serve.prefill import \
        write_targets

    eng.reset()
    mgr, L = eng.manager, len(stream)
    mgr.admit(0, paged.SharedPrefix([], None, 0, b""), L)
    table = eng._tensor(mgr.tables[0], torch.long)[None]
    out = []
    with torch.no_grad():
        for s in range(0, L, eng.chunk):
            n = min(eng.chunk, L - s)
            toks = np.full(eng.chunk, eng.pad_fill, np.int64)
            toks[:n] = stream[s:s + n]
            wb, wo, _ = write_targets(s, eng.chunk, s, L, mgr.tables[0],
                                      eng.block_size)
            hidden = eng._prefill_chunk(
                eng.model, eng.pools, eng._tensor(toks, torch.long)[None],
                table, eng._tensor([s], torch.long),
                eng._tensor(wb, torch.long), eng._tensor(wo, torch.long))
            out.append(eng.model.logits_from(hidden[0, :n]))
    mgr.release(0)
    logits = torch.cat(out)
    if eng.model.pad_id is not None:
        logits[:, eng.model.pad_id] = -torch.inf
    return logits


def _first_margins(eng, trace, marg):
    """Each request's token-0 margin: the chunk prefill's over its prompt
    (which chooses token 0), into ``marg``."""
    import numpy as np
    import torch

    for r in trace:
        cl = _chunk_logits(eng, np.asarray(r.prompt).astype(np.int64))
        top2 = torch.topk(cl[-1], 2).values
        marg.margin.setdefault(r.uid, {})[0] = float(top2[0] - top2[1])


def _delta_and_first_margins(eng, trace, results, marg):
    """The largest |logit difference| between the chunk prefill and the
    decode tick at the same positions, over the fault-free run's every
    decoded token; and each request's token-0 margin (the chunk
    prefill's, which chooses it)."""
    import numpy as np
    import torch

    delta = 0.0
    for r in trace:
        toks = np.asarray(results[r.uid])
        L = len(r.prompt)
        cl = _chunk_logits(eng, np.concatenate(
            [np.asarray(r.prompt), toks[:-1]]).astype(np.int64))
        top2 = torch.topk(cl[L - 1], 2).values
        marg.margin.setdefault(r.uid, {})[0] = float(top2[0] - top2[1])
        for k, row in marg.rows.get(r.uid, {}).items():
            d = (row - cl[L - 1 + k]).abs()
            delta = max(delta, float(d[torch.isfinite(d)].max()))
    return delta


def _hold_replay(label, out, ref, marg, tol, *, exact=False, before=None,
                 again=None):
    """Zero requests lost and the determinism rule against the fault-free
    ``ref``: ``exact`` (a move at rest) every token equal; otherwise every
    request that parts from ``ref`` parts first at a near-tie (the
    fault-free margin there below ``tol``), past every token committed
    before the fault (``before``: uid -> count).  ``again``: the same run
    repeated, which must serve the same tokens.  Returns (requests that
    parted, the largest margin they parted at)."""
    import numpy as np

    st = out["stats"]
    if st["requests_lost"] or out["errors"]:
        raise RuntimeError(f"{label}: {st['requests_lost']} lost, errors "
                           f"{out['errors']}")
    parted, worst = 0, 0.0
    for uid, want in ref["results"].items():
        got, want = np.asarray(out["results"][uid]), np.asarray(want)
        diff = np.flatnonzero(got != want) if len(got) == len(want) else \
            np.arange(min(len(got), len(want)) + 1)
        if not diff.size:
            continue
        j = int(diff[0])
        parted += 1
        margin = marg.margin.get(uid, {}).get(j, float("inf"))
        worst = max(worst, margin)
        if exact or margin >= tol or j < (before or {}).get(uid, 0):
            raise RuntimeError(
                f"{label}: request {uid} parts from the fault-free run at "
                f"token {j} (margin {margin:.4g}, near-tie limit {tol:.4g}, "
                f"{(before or {}).get(uid, 0)} committed before the fault"
                f"{', a move at rest must be exact' if exact else ''})")
    if again is not None and any(
            not np.array_equal(np.asarray(again["results"][u]),
                               np.asarray(t))
            for u, t in out["results"].items()):
        raise RuntimeError(f"{label}: the same run twice served different "
                           "tokens")
    print(f"{label}: 0 lost, {parted} of {len(ref['results'])} requests "
          f"part from the fault-free run"
          + (f" (each first at a near-tie: largest margin {worst:.4g} < "
             f"{tol:.4g})" if parted else " (bit-identical)")
          + (", the same tokens run twice" if again is not None else ""))
    return parted, worst


def phase_serving_resilience(rec4):
    """Phase 35: the supervisor, hot reload, admission control and the
    fleet router on phase 4's model; returns each leg's decode launches."""
    import dataclasses

    import numpy as np
    import torch

    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode
    from distributed_deep_learning_tpu_torch.serve import migrate as mig
    from distributed_deep_learning_tpu_torch.serve import paged
    from distributed_deep_learning_tpu_torch.serve import reload as rel
    from distributed_deep_learning_tpu_torch.serve.admission import \
        AdmissionController
    from distributed_deep_learning_tpu_torch.serve.autoscaler import \
        FleetAutoscaler
    from distributed_deep_learning_tpu_torch.serve.bench import \
        DEFAULT_PRIORITY_CLASSES
    from distributed_deep_learning_tpu_torch.serve.engine import PagedEngine
    from distributed_deep_learning_tpu_torch.serve.fleet import (
        QUARANTINED, RETIRED, FleetRouter)
    from distributed_deep_learning_tpu_torch.serve.supervisor import \
        ServeSupervisor
    from distributed_deep_learning_tpu_torch.utils.chaos import (
        SERVE_KINDS, ChaosEvent, ChaosPlan, preemption_requests)

    t_phase = time.perf_counter()
    model, trace, cap = _full_width()
    trace = trace[:RESILIENT_REQUESTS]
    layers = FULL_MODEL["num_layers"]
    eng = PagedEngine(model, max_len=cap, **FULL_ENGINE)
    launches = {}

    def leg(label, fn, engines=(eng,)):
        """``fn()`` from cold engines, the kernel's count zeroed just
        before and read just after; launches must equal the decode ticks
        run (the canary's too) x layers."""
        for e in engines:
            e.reset()
        paged_flash_decode.launches = 0
        t0 = time.perf_counter()
        with _tick_calls() as calls:
            out = fn()
        torch.cuda.synchronize()
        n, want = paged_flash_decode.launches, calls["n"] * layers
        print(f"resilience-serve[{label}]: {time.perf_counter() - t0:.2f} s"
              f", paged_flash_decode launches {n}, ticks {calls['n']} "
              f"(canary {calls['canary']}) x {layers} layers = {want}")
        if n != want or not n:
            raise RuntimeError(f"{label}: {n} launches for {calls['n']} "
                               "decode ticks")
        launches[label] = n
        return out

    def captures(label, e, canary=0):
        if e._tick.captures != 1 or (
                canary and e._canary_tick.captures != 1):
            raise RuntimeError(f"{label}: decode captures "
                               f"{e._tick.captures} (canary "
                               f"{getattr(e._canary_tick, 'captures', 0)})"
                               ", expected 1")

    # --- the fault-free supervised run, and the rule's near-tie limit ----
    marg = _Margins(keep_rows=True)
    ref = leg("reference", lambda: ServeSupervisor(
        eng, fleet_hook=marg).run(list(trace)))
    ref_s = ref["stats"]["total_seconds"]
    delta = _delta_and_first_margins(eng, trace, ref["results"], marg)
    tol = 2 * delta
    print(f"resilience-serve: chunk prefill vs decode tick at the same "
          f"positions: max |dlogit| {delta:.4g} over "
          f"{sum(len(v) for v in marg.rows.values())} tokens; near-tie "
          f"limit {tol:.4g}; fault-free run {ref_s:.3f} s")
    marg.rows.clear()

    # --- each serve fault kind under the supervisor, twice ---------------
    for kind in SERVE_KINDS:
        outs, sups = [], []
        for _ in range(2):
            ev = ChaosEvent(step=5, kind=kind, magnitude=0.3
                            if kind == "stalled_tick" else 0.0)
            sup = _snapshot_supervisor(
                eng, chaos=ChaosPlan([ev]), stall_timeout_s=0.1
                if kind == "stalled_tick" else None)
            outs.append(leg(f"supervised {kind}",
                            lambda: sup.run(list(trace))))
            sups.append(sup)
        st, sup = outs[0]["stats"], sups[0]
        fault = st["faults"][0] if st["faults"] else None
        if kind == "slow_tick":
            if st["restarts"]:
                raise RuntimeError("slow_tick: a restart")
            _hold_replay(f"supervised {kind}", outs[0], ref, marg, tol,
                         exact=True, again=outs[1])
            continue
        if fault is None or st["restarts"] != 1:
            raise RuntimeError(f"supervised {kind}: no contained fault")
        fired = sup.chaos.fired[0][0]
        replayed = st["engine"]["paged"]["prompt_tokens"]
        print(f"supervised {kind}: fired at tick {fired}, detected "
              f"{fault['tick'] - fired} ticks later ({fault['kind']}); "
              f"restart {1e3 * fault['recovery_s']:.2f} ms, replay "
              f"{replayed} prompt + committed tokens through the chunk "
              f"prefill, run {st['total_seconds']:.3f} s against "
              f"{ref_s:.3f} s fault-free")
        _hold_replay(f"supervised {kind}", outs[0], ref, marg, tol,
                     before=sup.before_fault, again=outs[1])
        captures(f"supervised {kind}", eng)

    # --- hot reload: publish, watch, verify, canary -----------------------
    pub = ROOT / "build" / "chip_smoke_reload"
    shutil.rmtree(pub, ignore_errors=True)
    live = {k: v.detach().clone() for k, v in eng.params.items()}
    t0 = time.perf_counter()
    rel.publish_weights(str(pub), 1, live)
    t_pub = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = rel.load_verified(str(pub), 1, eng.params)
    t_load = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.swap_params(loaded)
    torch.cuda.synchronize()
    t_swap = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in live.values())
    print(f"reload: {nbytes / 2**20:.1f} MiB of weights: publish "
          f"{t_pub:.3f} s, load + verify (npz, CRC32s) {t_load:.3f} s, "
          f"in-place swap {1e3 * t_swap:.2f} ms")

    def reloaded(label):
        rm = rel.ReloadManager(str(pub), canary_slots=2, canary_ticks=4,
                               min_compare=4)
        rm.watcher.seen |= seen
        out = leg(label, lambda: ServeSupervisor(eng, reload=rm).run(
            list(trace)))
        seen.update(rm.watcher.seen)
        return out, rm

    seen = {1}
    rel.publish_weights(str(pub), 2, live)        # the live weights again
    out, rm = reloaded("reload promote")
    if (rm.swaps, rm.rollbacks, out["stats"]["restarts"]) != (1, 0, 0):
        raise RuntimeError(f"reload promote: swaps {rm.swaps}, rollbacks "
                           f"{rm.rollbacks}")
    _hold_replay("reload promote", out, ref, marg, tol)
    captures("reload promote", eng, canary=1)
    # zeroed weights: finite, and wrong (JAX's drill's bad candidate)
    rel.publish_weights(str(pub), 3, {k: torch.zeros_like(v)
                                      for k, v in live.items()})
    out, rm = reloaded("reload rollback")
    ev = rm.events[-1]
    if (rm.swaps, rm.rollbacks, out["stats"]["restarts"]) != (0, 1, 1):
        raise RuntimeError(f"reload rollback: swaps {rm.swaps}, rollbacks "
                           f"{rm.rollbacks}")
    print(f"reload rollback: canary nonfinite {ev['nonfinite']}, "
          f"acceptance {ev['acceptance']:.3f} over {ev['compared']} "
          "comparisons")
    _hold_replay("reload rollback", out, ref, marg, tol)
    captures("reload rollback", eng, canary=1)
    if any(not torch.equal(eng.params[k], v.to(eng.device))
           for k, v in live.items()):
        raise RuntimeError("reload rollback: the live weights changed")
    rel.publish_weights(str(pub), 4, {k: torch.full_like(v, float("nan"))
                                      for k, v in live.items()})
    out, rm = reloaded("reload reject")
    if (rm.rejected, rm.swaps) != (1, 0):
        raise RuntimeError("reload reject: the NaN publication was not "
                           "quarantined")
    _hold_replay("reload reject", out, ref, marg, tol, exact=True)
    print(f"reload: quarantined {sorted(os.listdir(pub / 'quarantine'))}")
    shutil.rmtree(pub, ignore_errors=True)

    # --- the admission ladder sheds priority >= 1 -------------------------
    rng = np.random.default_rng(0)
    prios = [p for p, _ in DEFAULT_PRIORITY_CLASSES]
    frac = [f for _, f in DEFAULT_PRIORITY_CLASSES]
    ptrace = [dataclasses.replace(r, priority=int(rng.choice(prios, p=frac)))
              for r in trace]
    adm = AdmissionController(itl_p99_ms=1e-3, max_queue_depth=1,
                              patience=1, cool=1000)
    out = leg("admission", lambda: ServeSupervisor(eng, admission=adm).run(
        list(ptrace)))
    shed = {u for u, m in out["errors"].items() if m.startswith("shed:")}
    prio = {r.uid: r.priority for r in ptrace}
    if not shed or any(prio[u] == 0 for u in shed) or not adm.level:
        raise RuntimeError(f"admission: level {adm.level}, shed {shed}")
    print(f"admission: ladder {adm.level_changes}, shed {len(shed)} of "
          f"{len(ptrace)} (priorities {sorted(prio[u] for u in shed)}), "
          f"served {len(out['results'])}")

    # --- priority preemption: spill and resume at rest, both wires --------
    preqs = preemption_requests(FULL_MODEL["vocab_size"], 0)
    solo_eng = PagedEngine(model, **PREEMPT_ENGINE)
    solo = {}
    for r in preqs:
        solo_eng.reset()
        solo[r.uid] = solo_eng.run([dataclasses.replace(
            r, arrival_tick=0, priority=1)])["results"][r.uid]
    solo_ref = {"results": solo}
    pmarg = _Margins()
    _first_margins(solo_eng, preqs, pmarg)
    for wire in ("host", "device"):
        pe = PagedEngine(model, preempt=True, migrate=wire,
                         **PREEMPT_ENGINE)
        out = leg(f"preempt {wire}", lambda: ServeSupervisor(
            pe, fleet_hook=pmarg).run(list(preqs)), engines=(pe,))
        ps = out["stats"]["engine"]["preempt"]
        if not (ps["preemptions"] and ps["resumes"]) or ps["still_spilled"]:
            raise RuntimeError(f"preempt {wire}: {ps}")
        print(f"preempt {wire}: {ps['preemptions']} spilled, "
              f"{ps['resumes']} resumed, {ps['migration_bytes']} bytes "
              f"moved on the card in {1e3 * ps['migration_seconds']:.2f} ms")
        _hold_replay(f"preempt {wire}", out, solo_ref, pmarg, tol,
                     exact=True)
        captures(f"preempt {wire}", pe)
    outs = []
    for _ in range(2):
        plan = ChaosPlan([ChaosEvent(step=1, kind="migrate_drop")])
        pe._migrate_chaos = plan.migrate_corruptor()
        sup = _snapshot_supervisor(pe, retries=2)
        outs.append(leg("migrate_drop", lambda: sup.run(list(preqs)),
                        engines=(pe,)))
        kinds = [f["kind"] for f in outs[-1]["stats"]["faults"]]
        if kinds != ["MigrationError"] or not plan.fired:
            raise RuntimeError(f"migrate_drop: faults {kinds}")
    _hold_replay("migrate_drop", outs[0], solo_ref, pmarg, tol,
                 before=sup.before_fault, again=outs[1])
    del pe, solo_eng

    # a move's bytes, digest and copy at the cut trace's longest slot
    longest = max(len(r.prompt) + r.max_new_tokens for r in trace)
    eng.reset()
    eng.manager.admit(0, paged.SharedPrefix([], None, 0, b""), longest)
    image = eng._slot_image(eng.manager.tables[0], longest)
    eng.manager.release(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mig.tree_digest(image)
    t_dig = time.perf_counter() - t0
    t0 = time.perf_counter()
    mig.offload(image, eng.device)
    torch.cuda.synchronize()
    t_copy = time.perf_counter() - t0
    t0 = time.perf_counter()
    [mig.to_host(t) for t in image]
    t_host = time.perf_counter() - t0
    print(f"move of a {longest}-position slot ({len(image)} tensors, "
          f"{mig.tree_bytes(image) / 2**20:.2f} MiB): blake2b digest "
          f"{1e3 * t_dig:.2f} ms, chunked copy on the card "
          f"{1e3 * t_copy:.3f} ms, pinned host copy {1e3 * t_host:.2f} ms")
    del image

    # --- two replicas behind the router -----------------------------------
    eng2 = PagedEngine(model, max_len=cap, **FULL_ENGINE)
    pair = (eng, eng2)
    fmarg = _Margins()

    def fleet(label, chaos=None, hook=None, **kw):
        router = FleetRouter(pair, chaos=chaos, **kw)
        if hook is not None:
            observe = router._observe_tick
            router._observe_tick = lambda rep, report: (
                hook(report), observe(rep, report))
        return leg(label, lambda: router.run(list(trace)), pair), router

    fref, _ = fleet("fleet reference", hook=fmarg)
    _first_margins(eng, trace, fmarg)
    crash = []
    for _ in range(2):
        plan = ChaosPlan([ChaosEvent(step=3, kind="replica_crash")])
        out, _ = fleet("fleet replica_crash", chaos=plan)
        crash.append(out)
        st = out["stats"]
        if QUARANTINED not in st["health"].values() or not plan.fired:
            raise RuntimeError(f"fleet replica_crash: health "
                               f"{st['health']}")
    f0 = crash[0]["stats"]["faults"][0]
    print(f"fleet replica_crash: replica {f0['replica']} quarantined at "
          f"tick {f0['tick']}, {crash[0]['stats']['rounds']} rounds, "
          f"recovery {f0['recovery_s']:.3f} s")
    _hold_replay("fleet replica_crash", crash[0], fref, fmarg, tol,
                 again=crash[1])

    for label, extra in (("evacuation", ()),
                         ("evacuation evac_drop",
                          (ChaosEvent(step=1, kind="evac_drop"),))):
        plan = ChaosPlan([ChaosEvent(step=2, kind="replica_straggler",
                                     magnitude=5.0), *extra])
        out, router = fleet(label, chaos=plan, **EVAC_FLEET)
        rb, ms = out["stats"]["rebalance"], router._evac_migrator.stats
        if not rb["evacuations"] or bool(rb["rolled_back"]) != bool(extra):
            raise RuntimeError(f"{label}: {rb['evacuations']} evacuations, "
                               f"{rb['rolled_back']} rolled back")
        if ms.verified != ms.moves + ms.failed:
            raise RuntimeError(f"{label}: a move left unverified")
        print(f"{label}: {rb['evacuations']} slots, {rb['evacuated_blocks']}"
              f" blocks ({rb['evacuated_tokens']} tokens) moved at rest, "
              f"{rb['rolled_back']} rolled back; {ms.moves} moves of "
              f"{ms.wire_bytes / 2**20:.2f} MiB, digests "
              f"{1e3 * ms.digest_seconds:.2f} ms, copies "
              f"{1e3 * ms.copy_seconds:.2f} ms")
        _hold_replay(label, out, fref, fmarg, tol)

    def grown():
        return PagedEngine(model, max_len=cap, **FULL_ENGINE)

    auto = FleetAutoscaler(min_replicas=2, max_replicas=3, patience=1,
                           cool=1)
    router = FleetRouter(pair, autoscaler=auto, engine_factory=grown)
    for e in pair:
        e.reset()
    router._autoscale_round(override="hot")
    grew = sum(r.health != RETIRED for r in router.replicas)
    router._autoscale_round(override="cold")
    shrunk = sum(r.health != RETIRED for r in router.replicas)
    out = leg("autoscaler", lambda: router.run(list(trace)),
              [r.engine for r in router.replicas
               if r.health != RETIRED])
    if (grew, shrunk, len(auto.events)) != (3, 2, 2):
        raise RuntimeError(f"autoscaler: grew to {grew}, shrank to "
                           f"{shrunk}, {auto.events}")
    print(f"autoscaler: grew to {grew} replicas (launch geometry), drained "
          f"back to {shrunk}, {len(auto.events)} scale events")
    _hold_replay("autoscaler", out, fref, fmarg, tol)
    del router, eng2, pair
    gc.collect()
    torch.cuda.empty_cache()

    # --- the CLI: a few training steps, then the supervisor, the fleet ------
    watch = ROOT / "build" / "chip_smoke_cli_watch"
    watch.mkdir(parents=True, exist_ok=True)
    data_dir = _write_tokens()
    for label, flags in (("cli supervised", SERVE_SUPERVISED_FLAGS),
                         ("cli fleet", SERVE_FLEET_FLAGS)):
        os.environ["DDL_DATA_LIMIT"] = str(SHARD_ROWS)
        try:
            _, _, perf = _train(data_dir, "flash", *flags, "--reload-watch",
                                str(watch), label=label)
        finally:
            os.environ.pop("DDL_DATA_LIMIT", None)
        ticks = sum(run["out"]["stats"]["decode_ticks"]
                    for run in perf["served"])
        if label == "cli fleet":
            n_req, replicas, lost, n_launch = _one(
                _SERVE_FLEET_LINE, perf["log"], label)
            what = f"{int(n_req)} requests over {int(replicas)} replicas"
        else:
            restarts, lost, swaps = _one(_SERVE_SUPERVISED_LINE,
                                         perf["log"], label)
            n_launch = _one(_SERVE_PAGED_LINE, perf["log"], label)[-1]
            what = f"restarts {int(restarts)}, reload swaps {int(swaps)}"
        print(f"{label}: {what}, lost {int(lost)}, paged_flash_decode "
              f"launches {perf['decode_launches']} (logged {int(n_launch)})"
              f", decode ticks {ticks} x {TRAIN_LAYERS} layers = "
              f"{ticks * TRAIN_LAYERS}")
        if lost or not perf["decode_launches"] == n_launch == \
                ticks * TRAIN_LAYERS:
            raise RuntimeError(f"{label}: lost requests or launches off")
        launches[label] = perf["decode_launches"]
    shutil.rmtree(watch, ignore_errors=True)
    print(f"phase 35: {time.perf_counter() - t_phase:.1f} s")
    return launches



# --- phase 36: disaggregated serving ----------------------------------------

#: phase 36's prefill rows a batched chunk (JAX's default)
DISAGG_STREAMS = 4
#: the int8 wire's largest |dlogit| against the unified engine, up to each
#: request's first parting: 5x the 0.009961 of a sound run (NVIDIA H100
#: 80GB HBM3, 700 W; phase 36's model and trace), far below the O(1) of a
#: wrong scale or a misplaced block
INT8_WIRE_DLOGIT = 0.05


def _disagg_run(label, eng, trace, marg=None):
    """One :class:`DisaggEngine` run from a reset engine, the decode
    kernel's count zeroed just before and read just after; the launches
    must equal the decode ticks x layers."""
    import torch

    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode

    eng.reset()
    paged_flash_decode.launches = 0
    out = eng.run(list(trace), on_tick=marg)
    torch.cuda.synchronize()
    n, st = paged_flash_decode.launches, out["stats"]
    want = st["decode_ticks"] * FULL_MODEL["num_layers"]
    mig = st["migration"]
    print(f"disagg[{label}]: {st['generated_tokens']} tokens at "
          f"{st['tokens_per_sec']:.1f} tok/s ({st['total_seconds']:.3f} s), "
          f"prefill util {st['prefill_util']:.3f} over "
          f"{st['prefill_chunk_calls']} batched chunks, decode "
          f"{st['decode_seconds'] / max(st['decode_ticks'], 1) * 1e3:.3f} ms"
          f" a tick over {st['decode_ticks']} ticks, {mig['moves']} handoffs"
          f" of {mig['blocks']} blocks ({mig['wire_bytes'] / 2**20:.2f} MiB)"
          f"; paged_flash_decode launches {n}, ticks x layers {want}")
    if out["errors"]:
        raise RuntimeError(f"disagg[{label}]: {out['errors']}")
    if n != want or n != st["paged_decode_launches"] or not n:
        raise RuntimeError(f"disagg[{label}]: {n} decode launches for "
                           f"{st['decode_ticks']} ticks")
    if st["decode_captures"] != 1:
        raise RuntimeError(f"disagg[{label}]: decode captures "
                           f"{st['decode_captures']}")
    return out, n


def _logit_delta(ref_marg, marg, ref, out):
    """The largest |logit difference| at the same decoded positions of two
    runs, up to each request's first parting."""
    import numpy as np

    delta = 0.0
    for uid, rows in ref_marg.rows.items():
        a, b = np.asarray(ref["results"][uid]), np.asarray(
            out["results"][uid])
        same = int(np.argmax(a != b)) if (a != b).any() else len(a)
        for k, row in rows.items():
            other = marg.rows.get(uid, {}).get(k)
            if other is not None and k <= same:
                d = (row - other).abs()
                delta = max(delta, float(d[d == d].max()))
    return delta


def _hold_disagg(label, out, ref, ref_marg, marg, limit, tie):
    """The determinism rule for a disaggregated run against the unified
    run ``ref``, under limits read independently of this run: the largest
    |dlogit| at the same positions (up to each request's first parting,
    the parting row included) at most ``limit``, and every parting first
    at a near-tie (the unified margin there below ``tie``).  Returns the
    |dlogit|."""
    delta = _logit_delta(ref_marg, marg, ref, out)
    print(f"{label}: max |dlogit| against the unified engine {delta:.4g} "
          f"(limit {limit:.4g}); near-tie limit {tie:.4g}")
    if not delta <= limit:
        raise RuntimeError(f"{label}: max |dlogit| {delta:.4g} against the "
                           f"unified engine exceeds {limit:.4g}")
    _hold_replay(label, {"results": out["results"], "errors": out["errors"],
                         "stats": {"requests_lost": 0}}, ref, ref_marg, tie)
    return delta


def phase_disagg():
    """Phase 36: the disaggregated engine on phase 4's model and its
    trace's first 8 requests, both pools on card 0; returns each wire's
    decode launches."""
    import torch

    from distributed_deep_learning_tpu_torch.serve import migrate as mig
    from distributed_deep_learning_tpu_torch.serve.bench import \
        disagg_serving_bench
    from distributed_deep_learning_tpu_torch.serve.disagg import \
        DisaggEngine
    from distributed_deep_learning_tpu_torch.serve.engine import PagedEngine
    from distributed_deep_learning_tpu_torch.utils.config import parse_args

    t_phase = time.perf_counter()
    model, trace, cap = _full_width()
    trace = trace[:RESILIENT_REQUESTS]
    dev = torch.device("cuda", 0)
    kw = dict(max_len=cap, prefill_streams=DISAGG_STREAMS, **FULL_ENGINE)
    uni = PagedEngine(model, max_len=cap, **FULL_ENGINE)
    ref_marg = _Margins(keep_rows=True)
    ref = uni.run(list(trace), on_tick=ref_marg)
    print(f"disagg: unified reference {ref['stats']['tokens_per_sec']:.1f} "
          f"tok/s ({ref['stats']['total_seconds']:.3f} s)")
    # the plain wire's limit, read apart from the disaggregated runs: the
    # unified engine's chunk prefill against its own decode tick at the
    # same positions (phase 35's reading); and each token-0 margin
    chunk_delta = _delta_and_first_margins(uni, trace, ref["results"],
                                           ref_marg)
    print(f"disagg: unified chunk prefill vs decode tick: max |dlogit| "
          f"{chunk_delta:.4g}")
    launches = {}
    eng = None
    for wire in ("at_rest", "int8"):
        eng = DisaggEngine(model, devices=[dev, dev], wire=wire, **kw)
        _disagg_run(f"{wire} warm", eng, trace)
        marg = _Margins(keep_rows=True)
        out, launches[wire] = _disagg_run(wire, eng, trace, marg)
        _check_results(f"disagg[{wire}]", out["results"],
                       {r.uid: r.max_new_tokens for r in trace})
        if wire == "at_rest":
            _hold_disagg(f"disagg[{wire}]", out, ref, ref_marg, marg,
                         2 * chunk_delta, 2 * chunk_delta)
        else:
            _hold_disagg(f"disagg[{wire}]", out, ref, ref_marg, marg,
                         INT8_WIRE_DLOGIT, 2 * INT8_WIRE_DLOGIT)
            _agreement(ref["results"], out["results"],
                       f"disagg[{wire}] vs unified")
        del eng
    # the handoff: one slot's blocks moved prefill -> decode, digested
    # before and after, waiting for each move
    eng = DisaggEngine(model, devices=[dev, dev], **kw)
    _disagg_run("handoff warm", eng, trace)
    pw, dw = eng.prefill[0], eng.decode[0]
    ids = list(range(1, pw.eng.blocks_per_slot + 1))
    m = mig.BlockMigrator(len(ids))
    for _ in range(4):
        m.migrate(pw.eng.pools, dw.eng.pools, ids, ids, device=dev,
                  verify=True, sync=True)
    st = m.stats
    print(f"disagg: handoff of {len(ids)} blocks "
          f"({st.wire_bytes / st.moves / 2**20:.2f} MiB a move): digest "
          f"{st.digest_seconds / st.moves * 1e3:.3f} ms, copy on the card "
          f"{st.copy_seconds / st.moves * 1e3:.3f} ms a move "
          f"({st.gb_per_s():.3f} GiB/s overall)")
    # role elasticity: a third worker on the same card moves both ways
    del eng
    three = DisaggEngine(model, prefill_workers=1, decode_workers=2,
                         devices=[dev] * 3, **kw)
    moved = [three.reassign("to_prefill"), three.reassign("to_decode")]
    pools = (len(three.prefill), len(three.decode))
    print(f"disagg: reassign to_prefill, to_decode -> {moved}, pools "
          f"{pools[0]}P+{pools[1]}D")
    if moved != [True, True] or pools != (1, 2):
        raise RuntimeError(f"disagg: reassign {moved}, pools {pools}")
    del three
    # the CLI on one card: JAX's refusal
    if torch.cuda.device_count() == 1:
        try:
            parse_args(["--serve", "--paged", "--disagg"], "gpt")
        except SystemExit as e:
            if "only 1 visible" not in str(e):
                raise RuntimeError(f"disagg: CLI refusal {e}") from e
            print(f"disagg: the CLI on one card: {e}")
        else:
            raise RuntimeError("disagg: the CLI took --disagg on one card")
    rec = disagg_serving_bench(device="cuda", devices=[dev, dev],
                               model=model, trace=trace, max_slots=8,
                               kv_block_size=16, prefill_chunk=64,
                               prefill_streams=DISAGG_STREAMS)
    print("disagg: bench " + json.dumps({k: rec[k] for k in (
        "speedup", "itl_p99_ratio", "token_agreement", "migration_gbps",
        "migration_ms_per_move", "wire_bytes_per_block",
        "int8_wire_shrink_x")}) + f"; unified itl p99 "
        f"{rec['unified']['itl_p99_s']:.5f} s, disagg itl p99 "
        f"{rec['disagg']['itl_p99_s']:.5f} s, prefill util "
        f"{rec['disagg']['prefill_util']:.3f}")
    if rec["errors"]:
        raise RuntimeError(f"disagg: bench errors {rec['errors']}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 36: {time.perf_counter() - t_phase:.1f} s")
    return launches


# --- phase 37: observability ------------------------------------------------

#: phase 37's CLI run: phase 31's gpt in bf16, on 32 rows (5 train steps,
#: so that the step window below holds whole train steps 2-4)
OBS_FLAGS = ("--dtype", "bfloat16")
OBS_ROWS = 32
#: the overhead benches' steps a phase and interleaved repeats: enough for
#: telemetry's paired quartiles to clear 0 on the card; span tracing's
#: cost is below what this can resolve, so its bench runs shorter
OBS_BENCH_STEPS, OBS_BENCH_REPEATS = 256, 11
OBS_TRACE_STEPS, OBS_TRACE_REPEATS = 128, 7


def _trace_kernels(path):
    """The kernel events of a Chrome trace the profiler wrote: ``(names,
    busy ms, window ms)``, the window from the first kernel's start to
    the last one's end."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ks = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not ks:
        return set(), 0.0, 0.0
    t0 = min(e["ts"] for e in ks)
    t1 = max(e["ts"] + e["dur"] for e in ks)
    return {e["name"] for e in ks}, sum(e["dur"] for e in ks) / 1e3, \
        (t1 - t0) / 1e3


def _step_window(path, layers: int, first: int = 2, last: int = 4):
    """``(busy ms, window ms)`` of train steps ``first``..``last`` in a
    Chrome trace the profiler wrote: from step ``first``'s first flash
    forward to step ``last + 1``'s (a train step runs ``layers`` flash
    forwards, and the train steps come first), the card busy for the
    union of the kernels inside it."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel" and "dur" in e]
    ks = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    fwd = sorted(e["ts"] for e in events if "flash_fwd" in e["name"])
    t0, t1 = fwd[(first - 1) * layers], fwd[last * layers]
    busy, end = 0.0, t0
    for a, b in ks:
        a, b = max(a, end), min(b, t1)
        if b > a:
            busy += b - a
            end = b
    return busy / 1e3, (t1 - t0) / 1e3


def _loop_instrument_us(steps: int = 512, repeats: int = 9):
    """The train loop's instruments' host cost a step on the card, as
    quartiles in microseconds: ``_run_phase`` over a step that launches
    nothing (its metrics made once on the card), with telemetry against
    without, each repeat's pair differenced."""
    import torch

    from distributed_deep_learning_tpu_torch import obs
    from distributed_deep_learning_tpu_torch.obs.bench import _ListLoader
    from distributed_deep_learning_tpu_torch.train.loop import _run_phase

    dev = torch.device("cuda", 0)
    m = {"loss": torch.zeros((), device=dev),
         "correct": torch.zeros((), dtype=torch.long, device=dev),
         "count": torch.ones((), dtype=torch.long, device=dev)}
    x = torch.zeros(1, device=dev)
    loader = _ListLoader([(x, x)] * steps)

    def timed(tel):
        t0 = time.perf_counter()
        _run_phase(lambda state, xb, yb: (state, m), None, loader,
                   train=True, telemetry=tel)
        return (time.perf_counter() - t0) / steps * 1e6

    timed(None)
    diffs = []
    for _ in range(repeats):
        off = timed(None)
        diffs.append(timed(obs.RunTelemetry(path=None, device=dev)) - off)
    return statistics.quantiles(diffs, n=4)


def _overhead_profile(kw, steps: int = OBS_BENCH_STEPS, top: int = 6):
    """Where ``overhead_bench``'s telemetry cost goes: its loop with
    telemetry and without under ``cProfile``, the functions whose own
    time a step grew most (host microseconds, cProfile's own cost
    included on both sides)."""
    import cProfile
    import pstats

    from distributed_deep_learning_tpu_torch import obs
    from distributed_deep_learning_tpu_torch.obs import bench as obs_bench
    from distributed_deep_learning_tpu_torch.train.loop import _run_phase

    dev = obs_bench._device(kw["device"])
    step, state, (x, y) = obs_bench._build_step(256, 4, 64, 0, dev)
    loader = obs_bench._ListLoader([(x, y)] * steps)
    _run_phase(step, state, loader, train=True, telemetry=None)

    def own(tel):
        prof = cProfile.Profile()
        prof.enable()
        _run_phase(step, state, loader, train=True, telemetry=tel)
        prof.disable()
        return {f"{Path(k[0]).name}:{k[2]}": v[2] / steps * 1e6
                for k, v in pstats.Stats(prof).stats.items()}

    off, on = own(None), own(obs.RunTelemetry(path=None, device=dev))
    grew = sorted(((on.get(k, 0.0) - off.get(k, 0.0), k)
                   for k in set(on) | set(off)), reverse=True)[:top]
    print(f"obs: the bench loop under cProfile: {sum(off.values()):.1f} us "
          f"a step without telemetry, {sum(on.values()):.1f} with; grew "
          "most: " + ", ".join(f"{k} {d:+.1f}" for d, k in grew))


def phase_obs(data_dir: Path) -> dict:
    """Phase 37: telemetry, tracing, the flight recorder, MFU and the
    profiler on the card; returns the flash launches of the observed
    CLI run."""
    import dataclasses

    import torch

    from distributed_deep_learning_tpu_torch import obs
    from distributed_deep_learning_tpu_torch.obs import bench as obs_bench
    from distributed_deep_learning_tpu_torch.obs import memory as obs_memory
    from distributed_deep_learning_tpu_torch.obs import mfu as obs_mfu
    from distributed_deep_learning_tpu_torch.obs.recorder import \
        FlightRecorder
    from distributed_deep_learning_tpu_torch.obs.trace import \
        read_chrome_trace
    from distributed_deep_learning_tpu_torch.serve.engine import PagedEngine
    from distributed_deep_learning_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "chip_smoke_obs"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    obs_argv = ("--obs", "--obs-file", str(out_dir / "ev.jsonl"),
                "--obs-trace", str(out_dir / "tr.json"), "--obs-blackbox",
                str(out_dir / "bb.json"), "--metrics-file",
                str(out_dir / "m.jsonl"), "--profile-dir",
                str(out_dir / "prof"))
    os.environ["DDL_DATA_LIMIT"] = str(OBS_ROWS)
    try:
        off, _, _ = _train(data_dir, "flash", *OBS_FLAGS, label="obs off")
        on, launches, perf = _train(data_dir, "flash", *OBS_FLAGS,
                                    *obs_argv, label="obs on")
    finally:
        os.environ.pop("DDL_DATA_LIMIT", None)
    lose = [(h.phase, h.loss, h.step_losses) for h in on]
    if lose != [(h.phase, h.loss, h.step_losses) for h in off]:
        raise RuntimeError("obs: the losses with --obs differ from those "
                           "without it")
    steps = split_steps(OBS_ROWS, TRAIN_BATCH)
    check_launches("obs", launches, expected_launches(TRAIN_LAYERS, steps))
    events = [json.loads(line) for line in open(out_dir / "ev.jsonl")]
    mfu = next(e for e in events if e["event"] == "obs_mfu")
    names = [e["event"] for e in events]
    print(f"obs: losses with --obs equal those without, bit for bit; "
          f"sidecar events {names}")
    print(f"obs: step FLOPs {mfu['step_flops']:.6g}, "
          f"{mfu['steps_per_sec']:.4f} steps/s over the epoch's train "
          f"phase (its first step built and counted), MFU {mfu['mfu']:.4f} "
          f"against {mfu['device_kind']}'s "
          f"{mfu['peak_flops_per_chip']:.4g} FLOP/s "
          f"({mfu['peak_flops_source']}); over steps 2-{steps[0]} "
          f"({perf['step_s']:.4f} s a step, the median of the card's step "
          f"times) "
          f"{mfu['step_flops'] / perf['step_s'] / mfu['peak_flops_per_chip']:.4f}")
    if mfu["peak_flops_source"] != "table" or not mfu["mfu"] or \
            mfu["peak_flops_per_chip"] != obs_mfu.chip_peak_flops(
                torch.cuda.get_device_name(0)):
        raise RuntimeError(f"obs: MFU record {mfu}")
    spans = read_chrome_trace(str(out_dir / "tr.json"))
    if not {"compile", "dispatch", "data_wait", "device_sync"} <= \
            {s["name"] for s in spans}:
        raise RuntimeError("obs: the span trace lacks the loop's spans")
    # the step's FLOPs with dense attention: within 1% of flash's
    os.environ["DDL_DATA_LIMIT"] = str(OBS_ROWS)
    try:
        dense, _, _ = _train(data_dir, "dense", *OBS_FLAGS, "--obs",
                             "--obs-file", str(out_dir / "dense.jsonl"),
                             label="obs dense")
    finally:
        os.environ.pop("DDL_DATA_LIMIT", None)
    dmfu = next(e for e in (json.loads(line) for line in
                            open(out_dir / "dense.jsonl"))
                if e["event"] == "obs_mfu")
    gap = _rel(mfu["step_flops"], dmfu["step_flops"])
    print(f"obs: step FLOPs flash {mfu['step_flops']:.6g} / dense "
          f"{dmfu['step_flops']:.6g}: {gap:.2e} apart (limit 1e-2)")
    if not gap <= 1e-2:
        raise RuntimeError("obs: flash and dense step FLOPs differ")
    # the profiler trace of the observed run: the flash kernels, and the
    # card's idle share over train steps 2-4
    prof = sorted((out_dir / "prof").glob("trace.*.json"))
    knames, _, _ = _trace_kernels(prof[-1])
    flash = sorted(n for n in knames if "flash_" in n)
    busy, window = _step_window(prof[-1], TRAIN_LAYERS)
    print(f"obs: --profile-dir trace {prof[-1].name}: {len(knames)} kernel "
          f"names, flash kernels {flash}; train steps 2-4: {busy:.3f} ms "
          f"busy of {window:.3f} ms: idle share {1 - busy / window:.3f}")
    if not any("flash_fwd" in n for n in flash) or \
            not any("flash_dq" in n for n in flash):
        raise RuntimeError("obs: the profiler trace names no flash kernel")
    rec = obs_bench.overhead_bench(device="cuda", steps=OBS_BENCH_STEPS,
                                   repeats=OBS_BENCH_REPEATS)
    rec2 = obs_bench.trace_overhead_bench(
        device="cuda", steps=OBS_TRACE_STEPS, repeats=OBS_TRACE_REPEATS)
    # the instruments' own costs: the memory tracker's poll (a sample
    # every 8 steps: the allocator's counters and the host's RSS), a
    # timeline record, and all of the loop's instruments on a step that
    # launches nothing
    tel = obs.RunTelemetry(path=None, device=torch.device("cuda", 0))
    costs = {name: _host_us(fn, calls=80, rounds=5) for name, fn in (
        ("allocator counters", lambda: obs_memory.device_memory_stats(
            tel.memory.device)),
        ("host RSS", obs_memory.host_rss_bytes),
        ("memory on_step", tel.memory.on_step),
        ("timeline add+step", lambda: (tel.timeline.add("dispatch", 0.0),
                                       tel.timeline.step())))}
    loop_q = _loop_instrument_us()
    _overhead_profile(dict(device="cuda"))
    print("obs: instrument costs (host us a call) " + ", ".join(
        f"{k} {v:.2f}" for k, v in costs.items()) + "; the loop's "
        "instruments a step (quartiles) " + " / ".join(
            f"{v:.2f}" for v in loop_q))
    for name, r, key in (("telemetry", rec, "obs_overhead_fraction"),
                         ("tracing", rec2, "obs_trace_overhead_fraction")):
        q = r["per_step_overhead_us_quartiles"]
        print(f"obs: {name} overhead {r[key]:+.4f} "
              f"({r['per_step_overhead_us']:+.2f} us a step over "
              f"{r['steps']} steps x {r['repeats']} repeats); paired "
              f"quartiles {q[0]:+.2f} / {q[1]:+.2f} / {q[2]:+.2f} us: "
              + ("resolved" if q[0] > 0 or q[2] < 0 else
                 "unresolved (the quartiles straddle 0)"))
    # a served run under telemetry, a tracer and the recorder: a planted
    # SLO breach (request 0's TTFT limit below any TTFT) trips it
    model, trace, cap = _full_width()
    trace = [dataclasses.replace(r, slo_ttft_ms=1e-3 if r.uid == 0
                                 else None, slo_e2e_ms=None)
             for r in trace[:RESILIENT_REQUESTS]]
    rec_bb = FlightRecorder()
    rec_bb.arm(str(out_dir / "serve_bb.json"))
    tel = obs.RunTelemetry(str(out_dir / "serve.jsonl"),
                           trace_path=str(out_dir / "serve_tr.json"),
                           recorder=rec_bb)
    eng = PagedEngine(model, max_len=cap, **FULL_ENGINE)
    out = eng.run(list(trace), telemetry=tel)
    summary = tel.close()
    sspans = read_chrome_trace(str(out_dir / "serve_tr.json"))
    kinds = collections.Counter(s["name"] for s in sspans)
    print(f"obs: served {out['stats']['generated_tokens']} tokens under "
          f"telemetry: {summary['trace']['spans']} spans "
          f"{dict(sorted(kinds.items()))}; recorder trips {rec_bb.trips}")
    if rec_bb.trips != ["slo_breach"] or not kinds["decode_tick"]:
        raise RuntimeError("obs: the planted SLO breach did not trip the "
                           "recorder, or no tick was traced")
    # a tick's idle share: the captured decode tick replayed under the
    # profiler (the run's last staged rows)
    for _ in range(3):
        eng._decode()
    torch.cuda.synchronize()
    with profiling.trace(str(out_dir / "tick")) as p:
        t0 = time.perf_counter()
        for _ in range(20):
            eng._decode()
        wall = (time.perf_counter() - t0) / 20 * 1e3
    tick_busy = (profiling.busy_ms(p) or 0.0) / 20
    print(f"obs: a decode tick {wall:.3f} ms on the host clock, "
          f"{tick_busy:.3f} ms of kernels: idle share "
          f"{1 - tick_busy / wall:.3f}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 37: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phases 38-40: remat on the conv models, tuning, resharding
# ---------------------------------------------------------------------------

#: phase 38: no remat, then each policy; losses held to the first's
REMAT_CASES = (None, "nothing", "dots", "dots_no_batch")
REMAT_STEPS = 3
REMAT_TOL = 1e-5


@contextlib.contextmanager
def _data_limit(rows):
    """``DDL_DATA_LIMIT`` at ``rows`` (None: unset) while the block runs,
    then as it was."""
    before = os.environ.get("DDL_DATA_LIMIT")
    if rows is None:
        os.environ.pop("DDL_DATA_LIMIT", None)
    else:
        os.environ["DDL_DATA_LIMIT"] = str(rows)
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("DDL_DATA_LIMIT", None)
        else:
            os.environ["DDL_DATA_LIMIT"] = before


def remat_steps(workload: str, argv, policy, steps: int = REMAT_STEPS,
                device: str = "cuda"):
    """``steps`` train steps of ``workload`` under ``argv`` on ``device``
    with ``--remat --remat-policy policy`` (None: no remat), from the
    CLI's initialisation and first batches (:func:`_step_setup`); returns
    the losses, the median step seconds (steps 2 on) and the peak device
    memory over the steps, the state's included (None on the CPU)."""
    import torch

    card = device == "cuda"
    flags = (*argv, "--remat", "--remat-policy", policy) if policy \
        else tuple(argv)
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    state, step, train = _step_setup(workload, flags, device)
    batches = _cycle(train)
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, seconds = [], []
    for _ in range(steps):
        x, y = next(batches)
        t0 = time.perf_counter()
        losses.append(step(state, x, y)[1]["loss"].item())
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() if card else None
    batches.close()
    return losses, statistics.median(seconds[1:]), peak


def _loss_gap(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def phase_remat() -> dict:
    """Phase 38; returns each run's losses, step time and peak."""
    out = {}
    with _data_limit(None):
        for policy in REMAT_CASES:
            label = f"resnet18 {policy or 'no remat'}"
            losses, step_s, peak = remat_steps("resnet", RESNET18_FLAGS,
                                               policy)
            out[label] = dict(losses=losses, step_s=step_s, peak=peak)
            gap = _loss_gap(losses, out["resnet18 no remat"]["losses"])
            print(f"remat[{label}]: losses "
                  + " ".join(f"{x:.7f}" for x in losses)
                  + f", {step_s:.5f} s/step (median of steps 2-{len(losses)})"
                  f", peak {peak / 2**20:.1f} MiB, largest loss gap from no "
                  f"remat {gap:.2e} (tol {REMAT_TOL:g})")
            if not gap <= REMAT_TOL:
                raise RuntimeError(f"remat[{label}]: the losses moved")
        plain, dots = out["resnet18 no remat"], out["resnet18 dots"]
        if not dots["peak"] < plain["peak"]:
            raise RuntimeError("remat[resnet18 dots]: peak not below the "
                               "run without remat")
        for workload in WORKLOADS:
            runs = {p: remat_steps(workload, WORKLOAD_FLAGS, p)
                    for p in (None, "dots")}
            gap = _loss_gap(runs["dots"][0], runs[None][0])
            out[f"{workload} dots"] = dict(
                losses=runs["dots"][0], step_s=runs["dots"][1],
                peak=runs["dots"][2], plain_peak=runs[None][2])
            print(f"remat[{workload} dots]: losses "
                  + " ".join(f"{x:.7f}" for x in runs["dots"][0])
                  + f", gap from no remat {gap:.2e} (tol {REMAT_TOL:g}); "
                  f"{runs['dots'][1]:.5f} / {runs[None][1]:.5f} s/step, peak "
                  f"{runs['dots'][2] / 2**20:.1f} / "
                  f"{runs[None][2] / 2**20:.1f} MiB (dots / none)")
            if not gap <= REMAT_TOL:
                raise RuntimeError(f"remat[{workload} dots]: the losses "
                                   "moved")
    return out


#: phase 39's real OOM: phase 8's model with dense attention at a batch
#: whose saved score tensors cannot fit without remat
TUNE_OOM_BATCH = 16
TUNE_WARMUP = 2          # run_search's default warm-up steps a trial


def _plan_launches(plan, calls: int, layers: int = TRAIN_LAYERS,
                   device: str = "cuda") -> dict:
    """The flash launches of ``calls`` train steps of phase 8's model
    under ``plan`` on ``device``: a forward a layer (two under remat,
    whose backward recomputes it) and a dQ and dK/dV a layer, each
    microbatch; none where the plan's attention is dense (``auto`` is
    the flash kernels on the card only)."""
    if plan.attention == "dense" or (plan.attention == "auto"
                                     and device != "cuda"):
        return {name: 0 for name in FLASH_REPLACES}
    fwd = (2 if plan.remat else 1) * plan.grad_accum
    return {"flash_forward": calls * fwd * layers,
            "flash_backward_dq": calls * plan.grad_accum * layers,
            "flash_backward_dkv": calls * plan.grad_accum * layers}


def _add(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in more.items()}


def _trial_calls(trial: dict, warmup: int) -> int:
    """A feasible trial's step calls from its record: the first step,
    the FLOP count's, the warm-up and the timed steps."""
    return 2 + warmup + trial["measured_steps"]


def phase_tune(data_dir: Path) -> dict:
    """Phase 39's search, replay and calibration; returns the flash
    launches of each run.  Its OOM trial is :func:`phase_tune_oom`."""
    from distributed_deep_learning_tpu_torch.runtime import bootstrap
    from distributed_deep_learning_tpu_torch.tune import (
        Plan, load_plan, run_calibration)
    from distributed_deep_learning_tpu_torch.tune.memory import ACT_FRACTION
    from distributed_deep_learning_tpu_torch.tune.search import \
        RECOMPUTE_COST
    from distributed_deep_learning_tpu_torch.utils.config import parse_args
    from distributed_deep_learning_tpu_torch.workloads import get_spec

    out = {}
    with _data_limit(None):
        # (a) --autotune --plan FILE through the CLI, then --plan FILE
        path = ROOT / "build" / "chip_smoke_tune" / "gpt.plan.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.unlink(missing_ok=True)
        t0 = time.perf_counter()
        hist, launches, _ = _train(data_dir, "flash", "--autotune", "--plan",
                                   str(path), label="autotune", mode="data")
        wall = time.perf_counter() - t0
        plan, record = load_plan(str(path))
        search = record["search"]
        print(f"tune[search]: {search['n_candidates']} candidates, "
              f"{len(search['trials'])} trials over {search['rungs']} rungs "
              f"in {search['search_seconds']:.2f} s ({wall:.1f} s with the "
              f"epoch); best {record['plan_hash']} [{plan.describe()}] "
              f"{search['best_steps_per_sec']:.3f} steps/s, baseline "
              f"{search['baseline_steps_per_sec']:.3f}")
        want = {}
        for t in search["trials"]:
            tp = Plan.from_dict(t["plan"])
            if t["infeasible"]:
                raise RuntimeError(f"tune[search]: {tp.describe()} was "
                                   f"infeasible ({t['error']})")
            mem = t["memory"]
            print(f"tune[trial]: {tp.describe()}: {t['steps_per_sec']:.3f} "
                  f"steps/s over {t['measured_steps']} steps, first step "
                  f"{t['compile_seconds']:.3f} s, temp "
                  f"{mem.get('temp_size_in_bytes', 0) / 2**30:.3f} GiB, "
                  f"{t['cost'].get('flops', 0):.4e} FLOPs a step")
            want = _add(want, _plan_launches(
                tp, _trial_calls(t, TUNE_WARMUP)))
        steps = _phase_steps()
        fwd = (2 if plan.remat else 1) * plan.grad_accum
        epoch = expected_launches(TRAIN_LAYERS, steps, fwd, plan.grad_accum)
        check_launches("tune[autotune]", launches, _add(want, epoch))
        replay, replay_launches, _ = _train(data_dir, "flash", "--plan",
                                            str(path), label="plan replay",
                                            mode="data")
        check_launches("tune[plan replay]", replay_launches, epoch)
        same = [h.loss for h in replay] == [h.loss for h in hist] and \
            replay[0].step_losses == hist[0].step_losses
        print(f"tune[plan replay]: losses bit-identical to the searched "
              f"run's: {same}")
        if not same:
            raise RuntimeError("tune[plan replay]: the replay trained "
                               "another run")
        out["autotune"], out["replay"] = _add(want, epoch), replay_launches

        # (c) the calibration on phase 8's model
        cfg = parse_args(["-m", "data", "-l", str(TRAIN_LAYERS), "-s",
                          "768", "-b", str(TRAIN_BATCH), "--attention",
                          "flash", "--data-dir", str(data_dir)], "gpt")
        counters = _kernel_counters()[:3]
        for c in counters:
            c.launches = 0
        env, created = bootstrap.initialize("cuda")
        try:
            t0 = time.perf_counter()
            cal = run_calibration(get_spec("gpt"), cfg)
            cal_s = time.perf_counter() - t0
        finally:
            if created:
                bootstrap.shutdown()
        want = {}
        for c in cal["corners"]:
            cp = Plan.from_dict(c["plan"])
            if c["infeasible"]:
                raise RuntimeError(f"tune[calibrate]: {c['corner']} was "
                                   f"infeasible ({c.get('error')})")
            want = _add(want, _plan_launches(cp, 2 + 1 + 2))
            key = (cp.remat, cp.remat_policy)
            print(f"tune[calibrate]: {c['corner']}: temp "
                  f"{c['temp_size_in_bytes'] / 2**30:.3f} GiB, fitted "
                  f"activation fraction {c.get('fitted_act_fraction')} "
                  f"(prior {ACT_FRACTION[key]}), recompute cost "
                  f"{c.get('fitted_recompute_cost')} (prior "
                  f"{RECOMPUTE_COST[key]}), {c['steps_per_sec']:.3f} steps/s"
                  f", error analytic {c.get('analytic_error')} calibrated "
                  f"{c.get('calibrated_error')}")
        print(f"tune[calibrate]: {cal_s:.2f} s; errors {cal['errors']}")
        check_launches("tune[calibrate]",
                       {c.__name__: c.launches for c in counters}, want)
        out["calibrate"] = want
    return out


def phase_tune_oom(data_dir: Path) -> None:
    """Phase 39's real OOM: a search over the one-device lattice's remat
    corners with dense attention, the card to itself."""
    import torch

    from distributed_deep_learning_tpu_torch.runtime import bootstrap
    from distributed_deep_learning_tpu_torch.tune import run_search
    from distributed_deep_learning_tpu_torch.utils.config import parse_args
    from distributed_deep_learning_tpu_torch.workloads import get_spec

    with _data_limit(None):
        cfg = parse_args(["-m", "data", "-l", str(TRAIN_LAYERS), "-s",
                          "768", "-b", str(TUNE_OOM_BATCH), "--attention",
                          "dense", "--data-dir", str(data_dir)], "gpt")
        scores = TUNE_OOM_BATCH * 12 * TRAIN_T ** 2 * 4
        total = torch.cuda.mem_get_info()[1]
        print(f"tune[oom]: b {TUNE_OOM_BATCH}: a saved score tensor "
              f"B·H·T²·4 = {scores / 2**30:.2f} GiB a layer, "
              f"{TRAIN_LAYERS * scores / 2**30:.2f} GiB over "
              f"{TRAIN_LAYERS} layers against the card's "
              f"{total / 2**30:.2f} GiB")
        starts = []
        for c in _kernel_counters():
            c.launches = 0
        env, created = bootstrap.initialize("cuda")
        try:
            gc.collect()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            # the lattice's plans take --attention auto (the flash
            # kernels on the card) unless told; a warm-up step starts the
            # timer
            result = run_search(
                get_spec("gpt"), cfg, budget_bytes=1 << 50, trial_steps=1,
                warmup=1, max_rungs=1, max_trials=None,
                oom_hook=lambda p: starts.append(time.perf_counter()),
                space_options=dict(grad_accum_options=(1,),
                                   attention_options=("dense",)))
            starts.append(time.perf_counter())
            gc.collect()
            torch.cuda.empty_cache()
            after = torch.cuda.memory_allocated()
        finally:
            if created:
                bootstrap.shutdown()
        for t, t0, t1 in zip(result.trials, starts, starts[1:]):
            print(f"tune[oom]: [{t.plan.describe()}] {t1 - t0:.3f} s: "
                  + (t.error[:160] if t.infeasible else
                     f"{t.steps_per_sec:.4f} steps/s"))
        print(f"tune[oom]: {len(result.trials)} trials in "
              f"{result.search_seconds:.2f} s; memory_allocated {before} B "
              f"before the search, {after} B after; chosen "
              f"[{result.best.describe()}] {result.best_sps:.4f} steps/s")
        plain = [t for t in result.trials if not t.plan.remat]
        if not (len(plain) == 1 and plain[0].infeasible and plain[0].oom
                and "OutOfMemoryError" in plain[0].error
                and all(t.oom for t in result.trials if t.infeasible)):
            raise RuntimeError("tune[oom]: the plan without remat was not "
                               "refused by the allocator")
        if not (result.best.remat and after == before):
            raise RuntimeError("tune[oom]: a remat plan was not chosen, or "
                               "the OOM trial left memory behind")
        check_launches("tune[oom] (dense)", {
            c.__name__: c.launches for c in _kernel_counters()[:3]},
            {name: 0 for name in FLASH_REPLACES})


#: phase 40: phase 31's gpt (f32) at a batch 4, 3 and 2 ranks divide, on
#: rows that make two train steps an epoch (the second reads the restored
#: optimizer moments); the ranks share card 0 over gloo
RESHARD_BATCH, RESHARD_ROWS = 12, 36

RESHARD_RANK = r"""
import faulthandler, json, os, sys, time
faulthandler.enable()
import torch
import torch.distributed as dist
from distributed_deep_learning_tpu_torch.__main__ import main as cli
from distributed_deep_learning_tpu_torch.ops import attention as fa
from distributed_deep_learning_tpu_torch.reshard import restore as rs
from chip_smoke import restored_parts_exact

from distributed_deep_learning_tpu_torch.runtime.bootstrap import join

# the CLI's argv (JSON), the checkpoint file a restore is held to, and a
# file to wait for before the run
argv, saved, gate = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
torch.cuda.set_device(0)
join("gloo", rank, world)      # the launcher's store (_n_ranks)
rec, real = {}, rs.restore_resharded


def restore(ckpt, target, **kw):
    # the CLI's resharding restore, timed, then checked in place
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, step, info = real(ckpt, target, **kw)
    torch.cuda.synchronize()
    rec.update(mode=info.get("mode"), step=step,
               seconds=time.perf_counter() - t0,
               bytes=(info.get("redistribute") or {}).get("bytes_moved"),
               restore_peak=torch.cuda.max_memory_allocated())
    whole = torch.load(saved, map_location="cpu", weights_only=True,
                       mmap=True)
    rec["exact"] = restored_parts_exact(state, whole)
    del whole
    return state, step, info


rs.restore_resharded = restore
counters = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)
# a leg's ranks start with the saving ranks and wait for their checkpoint
# (the orchestrator's gate file), so that their start-up overlaps it
while gate and not os.path.exists(gate):
    time.sleep(0.1)
dist.barrier()
for c in counters:
    c.launches = 0
torch.cuda.reset_peak_memory_stats()
state, hist = cli(argv)
torch.cuda.synchronize()
del state
rec.update(losses=[x for h in hist if h.phase == "train"
                   for x in h.step_losses],
           launches={c.__name__: c.launches for c in counters},
           peak=torch.cuda.max_memory_allocated())
dist.destroy_process_group()
print("RESHARD_RANK " + json.dumps(rec), flush=True)
"""


def restored_parts_exact(state, whole: dict) -> bool:
    """Whether this rank's part of every parameter, buffer and optimizer
    moment of ``state`` equals the same part of the saved whole tensors
    ``whole`` (a checkpoint's payload), bit for bit, with no gather.  The
    parts are cut here by the rank number, apart from the restore's own
    code: FSDP2 splits dim 0 of a parameter and of its moments over every
    rank (``torch.chunk``); ZeRO-1 keeps the moments of the parameters a
    rank owns, whole."""
    import torch
    import torch.distributed as dist

    from distributed_deep_learning_tpu_torch.parallel.shards import (
        is_dtensor, local, resharded)

    def part(p, want):
        if not is_dtensor(p):
            return want
        chunks = torch.chunk(want, dist.get_world_size(), dim=0)
        rank = dist.get_rank()
        return chunks[rank] if rank < len(chunks) else want[:0]

    def equal(got, want):
        return bool(torch.equal(got.detach().cpu(), want.to(got.dtype)))

    params = dict(resharded(state.model).named_parameters())
    ok = True
    for name, t in state.model.state_dict().items():
        p = params.get(name)
        want = whole["params"][name]
        ok &= equal(local(p) if p is not None else t,
                    part(p, want) if p is not None else want)
    opt = state.optimizer
    inner = getattr(opt, "optim", opt)            # ZeRO-1's local one
    moments = 0
    for i, p in enumerate(q for g in opt.param_groups for q in g["params"]):
        for k, v in inner.state.get(p, {}).items():
            want = whole["optimizer"]["state"][i][k]
            if isinstance(v, torch.Tensor) and v.dim() > 0:
                ok &= equal(local(v), part(p, want))
                moments += 1
            else:
                ok &= float(v) == float(want)
    return ok and moments > 0


def _reshard_ranks(n: int, argv: list, saved: str = "",
                   gate: str = "") -> list[dict]:
    """:data:`RESHARD_RANK` as ``n`` ranks on card 0, each running the CLI
    with ``argv`` after ``gate`` (a file) exists."""
    return _n_ranks(RESHARD_RANK, [json.dumps(argv), saved, gate],
                    "RESHARD_RANK ", n,
                    env={"DDL_DATA_LIMIT": str(RESHARD_ROWS)})


def phase_reshard(data_dir: Path) -> dict:
    """Phase 40; returns each leg's flash launches summed over its
    ranks."""
    from distributed_deep_learning_tpu_torch.utils.checkpoint import \
        Checkpointer

    base = ROOT / "build" / "chip_smoke_reshard"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    flags = ["gpt", "-m", "data", "--zero", "1", "-l", str(TRAIN_LAYERS),
             "-s", "768", "-b", str(RESHARD_BATCH), "--attention", "flash",
             "--data-dir", str(data_dir), "-e", "2"]
    steps = split_steps(RESHARD_ROWS, RESHARD_BATCH)
    want = expected_launches(TRAIN_LAYERS, steps)
    run_dir = base / "4 ranks"
    saved = str(run_dir / "ckpt-1.pt")       # a save an epoch
    legs = {"(a) data=3": (3, ["--reshard"]),
            "(b) fsdp=2": (2, ["--reshard", "--target-mesh", "fsdp=2",
                               "--zero", "fsdp"])}
    argv = {label: flags + ["-r", str(n), "--resume", "--checkpoint-dir",
                            str(base / label.split()[-1]), *extra]
            for label, (n, extra) in legs.items()}
    gate = base / "legs.go"
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(legs)) as pool:
        # the legs' ranks start with the four and wait at the gate; the
        # card holds the four ranks' run or the two legs, not both
        futures = {label: pool.submit(_reshard_ranks, n, argv[label], saved,
                                      str(gate))
                   for label, (n, _) in legs.items()}
        try:
            first = _reshard_ranks(4, flags + ["-r", "4", "--checkpoint-dir",
                                               str(run_dir)])
            saves = Checkpointer(run_dir, shared=False).all_steps()
            print(f"reshard[save]: 4 ranks, --zero 1, epochs {saves} "
                  f"saved; peaks "
                  + ", ".join(f"{r['peak'] / 2**30:.2f}" for r in first)
                  + " GiB")
            if saves != [1, 2]:
                raise RuntimeError(f"reshard[save]: saved {saves}, not "
                                   "epochs 1 and 2")
            for r in first:
                check_launches("reshard[save] a rank", r["launches"], _add(
                    want, expected_launches(TRAIN_LAYERS,
                                            [steps[0], steps[1], 0])))
            for label in legs:          # epoch 1's checkpoint alone
                leg_dir = base / label.split()[-1]
                leg_dir.mkdir()
                for f in run_dir.glob("*-1.*"):
                    shutil.copy(f, leg_dir / f.name)
        finally:
            gate.touch()                # no leg waits forever
        runs = {label: f.result() for label, f in futures.items()}
    # each leg's epoch-2 losses against the four ranks' (their second
    # epoch): the first reads the restored parameters, the second the
    # restored optimizer moments too
    ref = first[0]["losses"][steps[0]:]
    out = {}
    for label, ranks in runs.items():
        losses = ranks[0]["losses"]
        gap = _loss_gap(losses, ref) if len(losses) == len(ref) \
            else float("inf")
        print(f"reshard{label}: {len(ranks)} ranks, modes "
              f"{[r['mode'] for r in ranks]}, restore s "
              + ", ".join(f"{r['seconds']:.3f}" for r in ranks)
              + ", MiB to each rank's card "
              + ", ".join(f"{r['bytes'] / 2**20:.1f}" for r in ranks)
              + ", restore peaks " + ", ".join(
                  f"{r['restore_peak'] / 2**30:.2f}" for r in ranks)
              + ", run peaks " + ", ".join(f"{r['peak'] / 2**30:.2f}"
                                           for r in ranks)
              + f" GiB; each rank's parts equal to the saved tensors: "
              f"{[r['exact'] for r in ranks]}; epoch-2 losses "
              + " ".join(f"{x:.9f}" for x in losses) + " against the 4 "
              "ranks' " + " ".join(f"{x:.9f}" for x in ref)
              + f", largest gap {gap:.2e} (tol {REMAT_TOL:g})")
        if any(r["mode"] != "chunked" for r in ranks):
            raise RuntimeError(f"reshard{label}: a rank did not restore "
                               "chunked")
        if not all(r["exact"] for r in ranks):
            raise RuntimeError(f"reshard{label}: the restored state is not "
                               "the saved one")
        if not gap <= REMAT_TOL:
            raise RuntimeError(f"reshard{label}: the losses moved")
        for r in ranks:
            check_launches(f"reshard{label} a rank", r["launches"], want)
        out[label] = {k: sum(r["launches"][k] for r in ranks) for k in want}
    print(f"reshard: {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(base, ignore_errors=True)
    return out


# --- phase 41: the scripts and examples on the card -------------------------

#: ``scripts.serve_bench``'s argv in phase 41: the main path's full width
#: and the script's flags nearest phase 4's load (FULL_LOAD's two prompt
#: ranges and ``long_frac`` have no flags, so its record is not phase 4's)
P41_SERVE = ["--paged", "--layers", "12", "--d-model", "768", "--heads",
             "12", "--mlp-dim", "3072", "--vocab", "32768", "--max-len",
             "1024", "--requests", "16", "--arrival", "poisson",
             "--prompt-min", "16", "--prompt-max", "512",
             "--shared-prefix-len", "64", "--shared-frac", "0.6",
             "--new-min", "16", "--new-max", "64", "--max-slots", "8",
             "--prefill-chunk", "64"]
#: the multi-rank calls of phase 41, in turn in one launch of two ranks on
#: card 0 (``[package, module, argv]``)
P41_RANK_CALLS = [["scripts", "comm_bench", ["--device", "cuda"]],
                  ["examples", "02_long_context_ring_attention", []],
                  ["examples", "03_fsdp_sharded_training", []],
                  ["examples", "05_tensor_parallel_gpt_cli", []],
                  ["examples", "07_moe_expert_parallel_cli", []]]
#: the CLI examples' epochs, batch and rows (``DDL_DATA_LIMIT``)
P41_EPOCHS, P41_BATCH, P41_ROWS = 2, 16, 256

#: one rank of phase 41's multi-rank calls, a job of :data:`RANK_JOBS`:
#: each call's exit code, output, seconds and kernel launches (counted
#: from 0 for each call)
P41_RANK = r"""
import contextlib, importlib, io, json, os, sys, time
import torch
import torch.distributed as dist
from distributed_deep_learning_tpu_torch.ops import attention as fa
from distributed_deep_learning_tpu_torch.ops import paged_decode as pd

calls = json.loads(sys.argv[1])
counters = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv,
            pd.paged_flash_decode)
out = {}
for pkg, name, argv in calls:
    os.environ.pop("DDL_DATA_LIMIT", None)
    for c in counters:
        c.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = importlib.import_module(
            f"distributed_deep_learning_tpu_torch.{pkg}.{name}").main(argv)
    torch.cuda.synchronize()
    dist.barrier()
    out[name] = {"rc": rc, "seconds": time.perf_counter() - t0,
                 "launches": {c.__name__: c.launches for c in counters},
                 "out": buf.getvalue()[-6000:]}
print("P41_RANK " + json.dumps(out), flush=True)
"""


def _cli_launches(layers: int, rows: int = P41_ROWS,
                  batch: int = P41_BATCH, epochs: int = P41_EPOCHS) -> dict:
    """A ``-m data``/sequential CLI run's flash launches a rank: every
    attention forward a train and validation step of each epoch and a
    test step, dQ and dK/dV a train step."""
    train, val, test = split_steps(rows, batch)
    return {"flash_forward": layers * (epochs * (train + val) + test),
            "flash_backward_dq": layers * epochs * train,
            "flash_backward_dkv": layers * epochs * train}


def _no_launches() -> dict:
    return {"flash_forward": 0, "flash_backward_dq": 0,
            "flash_backward_dkv": 0}


def phase_scripts() -> dict:
    """Phase 41; returns the phase's seconds (its calls here and its
    ranks' calls) and its launches by kernel."""
    import contextlib
    import importlib
    import io

    import torch

    from distributed_deep_learning_tpu_torch.ops import attention as fa
    from distributed_deep_learning_tpu_torch.ops import paged_decode as pd
    from distributed_deep_learning_tpu_torch.parallel.ring_attention import \
        ring_hops
    from distributed_deep_learning_tpu_torch.serve import bench as sbench

    counters = (fa.flash_forward, fa.flash_backward_dq,
                fa.flash_backward_dkv, pd.paged_flash_decode)
    work = ROOT / "build" / "chip_smoke_scripts"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    total = {c.__name__: 0 for c in counters}
    seconds = {}
    t_phase = time.perf_counter()

    def call(pkg: str, name: str, argv: list, label: str | None = None):
        label = label or name
        os.environ.pop("DDL_DATA_LIMIT", None)
        for c in counters:
            c.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = importlib.import_module(
                f"distributed_deep_learning_tpu_torch.{pkg}.{name}").main(
                    list(argv))
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        for k, v in launches.items():
            total[k] += v
        print(f"scripts[{label}]: exit {rc} in {seconds[label]:.2f} s; "
              f"launches {launches}")
        if rc != 0:
            raise RuntimeError(f"scripts[{label}]: exit {rc}:\n"
                               f"{buf.getvalue()[-3000:]}")
        return buf.getvalue(), launches

    def json_line(text: str) -> dict:
        return json.loads([ln for ln in text.splitlines()
                           if ln.startswith("{")][-1])

    def want_launches(label, got, flash=None, decode=0):
        want = {**(flash or _no_launches()), "paged_flash_decode": decode}
        check_launches(f"scripts[{label}]", got, want)

    # 1. the serving bench at full width, with telemetry; its tokens against
    #    a direct paged_serving_bench call on the same seed and load; each
    #    run's decode launches are its decode ticks x layers
    layers = FULL_MODEL["num_layers"]
    events, trace = work / "obs_events.jsonl", work / "serve_trace.json"
    seen = {}
    real = sbench.paged_serving_bench

    def captured(**kw):
        rec = real(**kw)
        seen.update(kw=kw, results=dict(rec["results"]))
        return rec

    sbench.paged_serving_bench = captured
    try:
        text, got = call("scripts", "serve_bench",
                         [*P41_SERVE, "--obs", "--obs-file", str(events),
                          "--obs-trace", str(trace)])
    finally:
        sbench.paged_serving_bench = real
    rec = json_line(text)
    pe = rec["paged_engine"]
    print(f"scripts[serve_bench]: {pe['generated_tokens']} tokens at "
          f"{pe['tokens_per_sec']:.1f} tok/s on {rec['device']}, "
          f"{pe['decode_ticks']} ticks, {pe['decode_captures']} capture(s), "
          f"prefix hit rate {pe['prefix_hit_rate']:.3f}; slot engine "
          f"{rec['engine_v1']['tokens_per_sec']:.1f} tok/s")
    if not rec["device"].startswith("cuda") or rec["errors"] or \
            pe["nonfinite_tokens"] or not pe["paged_decode_launches"]:
        raise RuntimeError("scripts[serve_bench]: not served on the card "
                           "through the decode kernel, or requests failed")
    want_launches("serve_bench", got, decode=pe["decode_ticks"] * layers)
    pd.paged_flash_decode.launches = 0
    t0 = time.perf_counter()
    direct = real(**{**seen["kw"], "telemetry": None,
                     "compare_engine": False})
    torch.cuda.synchronize()
    seconds["serve_bench direct"] = time.perf_counter() - t0
    n = pd.paged_flash_decode.launches
    want = direct["paged_engine"]["decode_ticks"] * layers
    print(f"scripts[serve_bench direct]: paged_flash_decode launches {n}, "
          f"decode_ticks x layers {want}")
    if n != want:
        raise RuntimeError("scripts[serve_bench direct]: the decode did not "
                           "launch the kernel once per layer per tick")
    total["paged_flash_decode"] += n
    same = direct["results"] == seen["results"]
    print(f"scripts[serve_bench]: tokens of all {len(seen['results'])} "
          f"requests equal to a direct paged_serving_bench call on "
          f"load_kw {seen['kw']['load_kw']}: {same}")
    if not same:
        raise RuntimeError("scripts[serve_bench]: the script's tokens are "
                           "not the library call's")
    served = len(seen["results"])

    # 2. the report over the stream that run wrote
    text, got = call("scripts", "obs_report", [str(events), "--trace"],
                     "obs_report --trace")
    head = text.splitlines()[0]
    print(f"scripts[obs_report --trace]: {head}")
    if f", {served} request traces) ==" not in head:
        raise RuntimeError("scripts[obs_report]: the trace's requests are "
                           "not the requests served")
    want_launches("obs_report --trace", got)
    text, got = call("scripts", "obs_report", [str(events), "--window"],
                     "obs_report --window")
    lines = text.splitlines()
    print(f"scripts[obs_report --window]: {lines[0]}")
    if not lines[0].startswith("== live windows") or len(lines) < 3:
        raise RuntimeError("scripts[obs_report]: no live windows")

    # 3. disaggregation on one card (card 0 twice): the decode ticks of
    #    both arms' warm and timed runs, counted as they are called
    with _tick_calls() as ticks:
        text, got = call("scripts", "disagg_bench", ["--requests", "8"])
    rec = json_line(text)
    dis = rec["disagg"]
    nl = rec["model"]["num_layers"]
    print(f"scripts[disagg_bench]: on {rec['device']}, speedup "
          f"{rec['speedup']}, token agreement {rec['token_agreement']}; "
          f"{ticks['n']} decode ticks over both arms' warm and timed runs; "
          f"the timed disaggregated run {dis['paged_decode_launches']} "
          f"decode launches over {dis['decode_ticks']} ticks")
    if not rec["device"].startswith("cuda") or rec["errors"] or \
            not dis["decode_ticks"] or \
            dis["paged_decode_launches"] != dis["decode_ticks"] * nl:
        raise RuntimeError("scripts[disagg_bench]: not served on the card "
                           "through the decode kernel once per layer per "
                           "tick")
    want_launches("disagg_bench", got, decode=ticks["n"] * nl)

    # 4. the planner's dry run against the card's memory
    text, got = call("scripts", "autotune",
                     ["gpt", "-l", "12", "-s", "768", "-b", "4",
                      "--dry-run"])
    rec = json_line(text)
    print(f"scripts[autotune]: {rec}")
    if not (rec["budget_bytes"] or 0) > 0 or rec["n_candidates"] < 1:
        raise RuntimeError("scripts[autotune]: no budget from the card")
    want_launches("autotune", got)

    # 5. one soak's batches onto the card
    text, got = call("scripts", "data_soak", ["--small", "--only", "mqtt"])
    rec = json_line(text)
    print(f"scripts[data_soak]: {rec}")
    if not rec["device"].startswith("cuda"):
        raise RuntimeError("scripts[data_soak]: the batches did not reach "
                           "the card")
    want_launches("data_soak", got)

    # 6. the single-process examples
    passes = {"01_train_mlp_library_api": ("library API on cuda",
                                           _no_launches()),
              "04_pipelined_gpt_cli": ("pipelined train loss on cuda", None),
              "06_elastic_mid_epoch_resume": (
                  "survived the injected step-5 failure on cuda",
                  _no_launches()),
              "08_profiling_toolkit": ("trace: wrote", _no_launches())}
    for name, (line, flash) in passes.items():
        text, got = call("examples", name, [])
        if line not in text or "on cuda" not in text:
            raise RuntimeError(f"scripts[{name}]: no pass line on the card")
        if flash is None:
            flash = pipeline_cli_launches()
        want_launches(name, got, flash)

    # 7. the multi-rank calls, a job of the two ranks' launch (run at the
    #    first phase that read its records: the wait is not this job's)
    t0 = time.perf_counter()
    ranks = rank_records(2, "P41_RANK ")
    waited = time.perf_counter() - t0
    seconds["ranks"] = rank_records(2, "JOB_SECONDS ")[0]["P41_RANK "]
    T = 4096
    for name in [c[1] for c in P41_RANK_CALLS]:
        for rank, r in enumerate(ranks):
            got = r[name]["launches"]
            if name.startswith("02"):
                hops = sum(m is not None for _, m in ring_hops(
                    rank, 2, T // 2, T // 2, True, None))
                flash = {"flash_forward": hops, "flash_backward_dq": hops,
                         "flash_backward_dkv": hops}
            elif name.startswith(("05", "07")):   # 2 layers, whole batch
                flash = _cli_launches(2)
            else:
                flash = None
            if r[name]["rc"] != 0:
                raise RuntimeError(f"scripts[{name}] rank {rank}: exit "
                                   f"{r[name]['rc']}")
            want_launches(f"{name} rank {rank}", got, flash)
            for k, v in got.items():
                total[k] += v
        print(f"scripts[{name}]: {ranks[0][name]['seconds']:.2f} s on rank "
              f"0; its output's tail: {ranks[0][name]['out'][-300:]!r}")
    out0 = {c[1]: ranks[0][c[1]]["out"] for c in P41_RANK_CALLS}
    rec = json.loads(out0["comm_bench"][out0["comm_bench"].index("{"):])
    par, num, ov = rec["parity"], rec["numerics"], rec["overlap"]
    print(f"scripts[comm_bench]: on {rec['device']}, wire bytes "
          f"{rec['bytes']}, ring exact {num['ring_all_gather_exact']}/"
          f"{num['ring_reduce_scatter_exact']}, overlap fraction "
          f"{ov['overlap_fraction']} (host-staged {ov['host_staged']}: "
          f"the fraction measures gloo's staging through host memory), "
          f"FSDP parity none {par['explicit_none_max_abs_delta']}, int8 "
          f"{par['int8_ef_max_abs_delta']}")
    losses = par["losses"]
    if not rec["device"].startswith("cuda") or not (
            num["ring_all_gather_exact"] and num["ring_reduce_scatter_exact"]
            and all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(
                losses["explicit_none"], losses["annotation"]))
            and losses["explicit_int8_ef"][-1]
            < losses["explicit_int8_ef"][0]):
        raise RuntimeError("scripts[comm_bench]: a gate failed")
    for name, line in (("02_long_context_ring_attention", "max|ring - dense|"),
                       ("03_fsdp_sharded_training", "loss:"),
                       ("05_tensor_parallel_gpt_cli", "tensor-parallel"),
                       ("07_moe_expert_parallel_cli", "expert-parallel")):
        found = [ln for ln in out0[name].splitlines() if line in ln]
        print(f"scripts[{name}]: {found[-1] if found else 'NO PASS LINE'}")
        if not found:
            raise RuntimeError(f"scripts[{name}]: no pass line")
    took = time.perf_counter() - t_phase - waited + seconds["ranks"]
    print(f"scripts: phase 41 {took:.1f} s (its ranks' calls "
          f"{seconds['ranks']:.1f} s); "
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    return {"seconds": took, "launches": total}


def pipeline_cli_launches() -> dict:
    """Example 04's flash launches: ``gpt -l 4 -m pipeline --nstages 4
    --pipeline-schedule 1f1b -b 16`` (``-p 2``: 8 microbatches) walked by
    one process, 2 epochs of 256 rows.  A train step runs each layer's
    forward twice a microbatch (the recompute) but the last stage's once,
    dQ and dK/dV once; an evaluation step each layer's forward once a
    microbatch."""
    layers, stages, m = 4, 4, 16 // 2
    train, val, test = split_steps(P41_ROWS, P41_BATCH)
    fwd = sum(grid_launches("1f1b", s, stages, 1, layers, m)["flash_forward"]
              for s in range(stages))
    back = layers * m
    return {"flash_forward": P41_EPOCHS * train * fwd
            + (P41_EPOCHS * val + test) * layers * m,
            "flash_backward_dq": P41_EPOCHS * train * back,
            "flash_backward_dkv": P41_EPOCHS * train * back}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default=",".join(str(i) for i in range(1, 42)),
                    help="comma-separated phases to run; the result lines "
                         "are printed only when all run")
    ap.add_argument("--waves", type=int, default=None,
                    help="the decode's split rule aims at this many blocks "
                         "an SM instead of paged_decode.WAVES (a sweep; no "
                         "result lines)")
    opts = ap.parse_args(argv)
    phases = {int(x) for x in opts.phases.split(",")}
    complete = phases == set(range(1, 42)) and opts.waves is None
    if opts.waves is not None:
        from distributed_deep_learning_tpu_torch.ops import paged_decode
        paged_decode.WAVES = opts.waves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    def lap(done):
        print(f"time: phases {done} done at {time.perf_counter() - t0:.1f} "
              "s")

    phase_device()
    builds = start_builds()
    kernels = []
    if 2 in phases:
        phase_build(builds["paged_decode"])
    decode = rec = None
    if phases & {3, 4, 5, 13, 14, 18, 19, 20, 35, 36, 41}:
        builds["paged_decode"].result()        # not built again at use
        timing = phase_kernel() if 3 in phases else {}
        if phases & {4, 5, 13, 14, 18, 19, 20, 35, 36}:
            rec, launches = phase_serve(compare_engine=14 in phases)
            decode = {"name": "paged_flash_decode", "route": "cuda",
                      "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
                      "launches": launches, **timing}
            kernels.append(decode)
            if 5 in phases:
                phase_plain_replay(rec)
            if 13 in phases:
                phase_eager_replay(rec)
            if 14 in phases:
                phase_slot_engine(rec)
            if 18 in phases:
                decode["quant_serve_launches"] = phase_quant_serving(rec)
            if 19 in phases:
                decode["spec_launches"] = phase_spec(rec)
            if 20 in phases:
                decode["window_launches"] = phase_window(rec)
            if 35 in phases:
                builds["flash_attention"].result()  # its CLI leg trains
                decode["resilience_serve_launches"] = \
                    phase_serving_resilience(rec)
            if 36 in phases:
                decode["disagg_launches"] = phase_disagg()
        # phases 13, 18-20 and 35's model: off the card before the
        # training phases read their peaks
        _full_width.cache_clear()
        gc.collect()
        torch.cuda.empty_cache()
        lap("2-5, 13, 14, 18-20, 35, 36")
    if 6 in phases:
        phase_ptxas(builds)
    if phases & ({7, 25, 26, 28, 29, 30, 31, 32, 33, 34, 37, 39, 40, 41}
                 | set(range(8, 18))):
        builds["flash_attention"].result()     # not built again at use
    records = phase_flash_kernels() if 7 in phases else {}
    lap("6-7")
    data_perf = None
    if phases & {8, 9, 10, 11, 12, 15, 16, 17}:
        data_dir = _write_tokens()
        hist = launches = perf = None
        if phases & {8, 9}:
            hist, launches, perf = phase_train_flash(data_dir)
        if 9 in phases:
            phase_train_dense(data_dir, hist, perf)
        bf16_hist = bf16_launches = bf16_perf = None
        if phases & {10, 11, 15, 16, 17}:
            bf16_hist, bf16_launches, bf16_perf = phase_train_bf16(
                data_dir, hist, serve=15 in phases)
        if 11 in phases:
            data_perf, _ = phase_data_parallel(data_dir, bf16_hist, bf16_perf,
                                               serve=15 in phases)
        if 15 in phases:
            serve_launches = phase_post_train_serving(bf16_perf, data_perf)
            spec_cli = phase_cli_spec_quant(data_dir)
            if decode is not None:
                decode["bf16_serve_launches"] = serve_launches
                decode["cli_spec_int8_launches"] = spec_cli["launches"]
        if 16 in phases:
            phase_fused_head(data_dir, bf16_perf)
        if 17 in phases:
            phase_optimizers(data_dir, bf16_perf)
        if 12 in phases:
            phase_checkpoint(data_dir)
        for name in FLASH_REPLACES:
            rec = records.get("f32", {}).get(name, {})
            kernels.append({"name": name, "route": "cuda",
                            "source": FLASH_SOURCE,
                            "replaces": FLASH_REPLACES[name],
                            "launches": (launches or {}).get(name), **rec,
                            "bf16": records.get("bf16", {}).get(name),
                            "bf16_train_launches":
                                (bf16_launches or {}).get(name)})
        lap("8-12, 15-17")
    if phases & {21, 22}:
        workloads = phase_workloads()
        if 22 in phases:
            phase_workload_variants(workloads)
        lap("21-22")
    if phases & RANK_PHASES:
        # the ranks start up while phase 23, whose timings no one reads,
        # runs, and wait at their gates
        start_ranks(phases, _write_tokens())
    if 23 in phases:
        phase_workload_checkpoint()
    if 24 in phases:
        phase_resnet()
        lap("23-24")
    zoo = {}
    for phase, workload in ((25, "transformer"), (26, "bert")):
        if phase in phases:
            zoo[workload] = phase_zoo_lm(workload)
            lap(phase)
    if 27 in phases:
        phase_staged()
        lap(27)
    pipe = {}
    if phases & {28, 29}:
        data_dir = _write_tokens()
        if 28 in phases:
            _, pipe = phase_pipeline(data_dir)
        if 29 in phases:
            pipe.update(phase_pipeline_zoo(data_dir))
        lap("28-29")
    moe = phase_moe() if 30 in phases else {}
    sharded = {}
    if 31 in phases:
        sharded = phase_sharded(_write_tokens(), data_perf)
        lap(31)
    comm = {"comm": {}, "seq": {}}
    if 32 in phases:
        comm = phase_comm(_write_tokens(), sharded)
        lap(32)
    grid = phase_grid(_write_tokens()) if 33 in phases else {}
    if grid:
        lap(33)
    resilience = phase_resilience(_write_tokens()) if 34 in phases else {}
    if resilience:
        lap(34)
    observed = tuned = resharded = {}
    if phases & {37, 38, 39, 40}:
        # in turn: 37's and 39's timings and 38's peaks have the card to
        # themselves
        tokens = _write_tokens()
        if 37 in phases:
            builds["paged_decode"].result()
            observed = phase_obs(tokens)
            lap(37)
        if 38 in phases:
            phase_remat()
        if 39 in phases:
            tuned = phase_tune(tokens)
            phase_tune_oom(tokens)
        lap("38-39")
        if 40 in phases:
            resharded = phase_reshard(tokens)
            lap(40)
    scripts = {}
    if 41 in phases:
        gc.collect()
        torch.cuda.empty_cache()
        scripts = phase_scripts()
        lap(41)
    for entry in kernels:
        if entry["name"] not in FLASH_REPLACES:
            continue
        for workload, runs in zoo.items():
            entry[f"{workload}_launches"] = {
                label: run["launches"][entry["name"]]
                for label, run in runs.items()}
        entry["zoo_ms"] = {case: rec[entry["name"]] for case, rec in
                           records.get("zoo", {}).items()}
        entry["pipeline_launches"] = {label: run["launches"][entry["name"]]
                                      for label, run in pipe.items()}
        entry["moe_launches"] = {label: run["launches"][entry["name"]]
                                 for label, run in moe.items()}
        entry["sharded_launches"] = {
            label: run["launches"][entry["name"]]
            for label, run in sharded.items()}
        for part in ("comm", "seq"):
            entry[f"{part}_launches"] = {
                label: run["launches"][entry["name"]]
                for label, run in comm[part].items()}
        entry["grid_launches"] = {label: run["launches"][entry["name"]]
                                  for label, run in grid.items()}
        entry["resilience_launches"] = \
            resilience.get("launches", {}).get(entry["name"])
        entry["obs_launches"] = observed.get(entry["name"])
        entry["tune_launches"] = {label: run[entry["name"]]
                                  for label, run in tuned.items()}
        entry["reshard_launches"] = {label: run[entry["name"]]
                                     for label, run in resharded.items()}
    for entry in kernels:
        entry["scripts_launches"] = scripts.get("launches", {}).get(
            entry["name"])
    took = time.perf_counter() - t0
    print(f"phases {sorted(phases)} done in {took:.1f} s"
          + (f"; without phase 41 ({scripts['seconds']:.1f} s, its calls "
             f"here and its ranks' calls) {took - scripts['seconds']:.1f} s"
             if scripts else ""))
    if not complete:
        return 0
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
