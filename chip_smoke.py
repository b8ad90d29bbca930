#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds every kernel of the port from ``src/repro_torch/kernels`` (the
CUDA sources with ``nvcc``, all at once), holds each against its plain
PyTorch version on the card,
then drives the port's main paths: the multicast (``Group.run`` and
``Group.run_batch`` on the ``kernel`` backend, at the paper's deployment
sizes, agreeing exactly with the card's ``graph`` and the CPU's ``graph``
runs), the serve plane (``ReplicatedEngine.run`` on a full-width
qwen3-1.7b over the streamed multicast), the full-sequence forward
(``Arch.loss_fn`` / ``Arch.prefill_fn`` on a full-width qwen3-1.7b and
``Arch.loss_fn`` on a full-width mamba2-2.7b), the training plane
(``Trainer`` on a full-width qwen3-1.7b with the compressed Spindle
gradient reduction over two data-parallel workers) and the
virtual-synchrony cut (``MembershipService.reconfigure_stream``,
``BoundDomain.reconfigure``, ``ReplicatedEngine.run(fail_at=)``,
``ElasticRuntime`` with a ``BucketSyncStream`` and ``chaos_soak``), the
fused serve program (``ReplicatedEngine.run(fused=True)``), the load
plane (``run_profile``), the recurrent families (``Arch.loss_fn`` on
a full-width zamba2-2.7b, ``ReplicatedEngine.run`` per round and fused
on full-width mamba2-2.7b and zamba2-2.7b) and the moe, vlm and encdec
families (loss, prefill and decode of qwen2-moe-a2.7b, deepseek-moe-16b,
internvl2-26b and seamless-m4t-medium at full width,
``ReplicatedEngine.run`` per round and fused on qwen2-moe-a2.7b and per
round on seamless-m4t-medium) and their training (``Trainer`` on
zamba2-2.7b, qwen2-moe-a2.7b, deepseek-moe-16b, internvl2-26b and
seamless-m4t-medium at full width), and the launch plane (the serve and
train launchers, the dry-run and roofline tools, the multicast grid
sharded over named devices), and the port across real
``torch.distributed`` ranks (the data-parallel train step, the MoE's
expert parallelism, the SST push).

Phases (one JSON line each; any failure exits non-zero):

0. card identity (``nvidia-smi`` name and power limit) and build time;
1. both SMC kernels against their twins at the main path's lane counts,
   at 2**20 lanes and at lanes near INT32_MAX / INT32_MIN (the watermark
   kernel also against its closed form, the ring kernel against the
   watermark kernel): exact equality, CUDA-event and profiler times,
   device operations a call, the byte bound (for the ring, the counters
   the runs of these inputs need: run + 1 slots a row, at most W), and
   the time of the three-op PyTorch closed form beside them;
2. the paper's testbed: 16 nodes, all senders, 10 KB messages, window
   100, 1000 messages per sender;
3. the Fig. 6 window grid and the Fig. 11 null-send grid as one
   ``run_batch`` each, every point equal to its own sequential run;
4. a heterogeneous 64-topic DDS domain over 16 nodes (the masked kernel
   path);
5. flash-decode and both RMSNorm kernels against their plain versions at
   the serve shapes, float32 (2e-5) and bfloat16 (2e-2): flash decode at
   B=8 Hq=16 Hkv=8 D=128 S_max=2048 with the serve run's, mixed and
   all-2048 lengths, at zamba2's D=80 heads (group 1; mixed lengths and
   the recurrent serve's), at group 16 and on a one-chunk cache
   (S_max=128); the RMSNorm kernels also at the recurrent decode's rows
   (8 x 2560 and the gated 8 x 5120); CUDA-event and profiler times, the
   plain and library times, the bound;
6. the serve plane at full width: qwen3-1.7b (8 of its 28 layers,
   ``SERVE_LAYERS``, bf16 weights from seed 0), two replicas of 8 KV slots x 2048 positions, 16
   requests each, on the ``kernel`` backend: every kernel launched once
   per site per decode step, tokens/s, wall per round, device-busy share;
7. the same serve scenario in float32 at 4 layers, on the kernels and on
   ``Runtime(kernels="plain")`` over the ``graph`` backend: identical
   logs, round traces and tokens (a token may differ only where the
   plain run's top-2 logit margin is under 1e-4 relative);
8. flash attention, the SSD scan and RMSNorm against their plain
   versions at the forward path's shapes (attention: qwen3-1.7b's heads at
   S=2048, causal and not, S=1000 ragged, MQA, zamba2-2.7b's D=80 heads
   and D=96; the SSD scan at mamba2-2.7b's H=80, P=64, N=128, chunk 256,
   S=2048, at zamba2-2.7b's (P, N) = (64, 64), at (128, 256) with G=2
   and chunk 64, and at a ragged chunk of 100 with P=48; RMSNorm at
   widths 2560 and 5120), float32 (attention on the CUDA-core kernel)
   and bfloat16 (attention on the tensor-core kernel), at the
   ``tests/test_kernels.py`` bars: times, plain and library times, the
   bound; the qwen3 and zamba2 attention rows also their TFLOP/s, share
   of the bound and ratio to SDPA, and the bfloat16 ones the float32
   kernel's time at the same shape; and a bfloat16 q at a 2-byte offset,
   which the attention kernel takes through a contiguous copy (the copy
   count printed);
9. the forward path at full width (bf16 weights from seed 0): qwen3-1.7b,
   all 28 layers, ``loss_fn`` on 2 x 2048 tokens and ``prefill_fn`` on
   4 x 512; mamba2-2.7b, all 64 layers, ``loss_fn`` on 1 x 2048: a finite
   loss (or logits), exact launch counts per forward, tokens/s, wall,
   device time and busy share, the forward's bound;
10. the same forwards in float32 at 4 layers on the kernels and on
   ``Runtime(kernels="plain")``: loss and last-position logits within the
   stated tolerance, and prefill of S tokens then one decode step equal to
   the prefill of S + 1 tokens;
11. quantize and dequantize against their plain versions, bit for bit:
   the ``tests/test_quantize_kernel.py`` shapes and 2**24 elements at
   block 2048, a block of 100,003 (no multiple of 4 or 8; also from an x
   that is not 16-byte aligned), 2 x 40,000 (fewer tiles than the
   persistent grid's CTAs), float32 and bfloat16, zeros and exact .5
   ties, and the main path's largest bucket shard (qwen3-1.7b's plan,
   W = 2, float32): CUDA-event and profiler times, device operations a
   call, the plain time, the byte bound;
12. the training plane at full width: ``Trainer`` on qwen3-1.7b (28
   layers, bf16 weights from seed 0, AdamW state in float32) with
   ``Runtime(gradsync="spindle_compressed", dp_workers=2)``, 2 x 2048
   tokens of the synthetic pipeline, 3 steps: finite losses near ln V,
   exact launches per step (every forward site once per layer per worker;
   one quantize and one dequantize per bucket), tokens/s, wall per step,
   one warm step profiled (device time, busy share) and taken apart
   (gradients, reduction, AdamW), peak memory, the step's bound, and one
   warm step of the uncompressed ``spindle`` reduction; then
   rematerialisation: ``steps.worker_grads`` at the same shape under
   ``Runtime(remat=)`` ``none``, ``full`` and ``dots``, each warm:
   losses bit-identical, every gradient leaf within 1e-4 of its largest
   |g| of ``none``'s, the exact launches (every site inside a region
   twice, :func:`remat_launches`), wall and peak memory above what the
   call found allocated, ``full`` and ``dots`` under ``none``'s; and at
   ``train_4k``'s length (1 x 4096, W = 1) ``none`` and ``full`` with
   wall, peak and the dry-run's live-meta estimate of the same call;
13. the train path in float32 at 2 layers (``TRAIN_F32_LAYERS``), full
   width, on the kernels and
   on the plain versions: qwen3-1.7b (``spindle_compressed``, W = 2,
   2 x 512 tokens, three ``Trainer`` steps: losses within 1e-5 relative,
   per-worker gradients within 1e-4 of each leaf's largest, master weights
   after step 1 within 2 lr_1 + 1e-6, the compressed mean within 4
   quantization steps of the exact mean, the plain run launching nothing,
   and a restart from the step-2 checkpoint bit-equal to the uninterrupted
   run) and mamba2-2.7b (``spindle``, W = 2, 2 x 1024 tokens, one step:
   the SSD scan's gradient, per-worker gradients within 5e-4, and the
   error with only the SSD or only the RMSNorm sites on their kernels);
   for both, the float64 yardstick: the plain path's gradients in
   float64 against each float32 run, per leaf as a share of its largest
   entry (``e_kernel``, ``e_plain``), with e_kernel <= 2 e_plain + 1e-6
   on every leaf;
14. the cut on the multicast: the testbed of phase 2 streamed (one
   message per sender per round for 1000 rounds) through a cascading cut
   at round 300 (sender 5 suspected, receiver 11 while the wedge is open)
   and a joining cut at round 600, and phase 4's DDS domain through
   ``BoundDomain.reconfigure`` with nodes 3 and 9 failing at round 100 of
   200: every epoch's logs, ``EpochCarry`` and ``extras["view_change"]``
   identical on the card's ``kernel``, the card's ``graph`` and the CPU's
   ``graph``, one receive-kernel launch per streamed round in every epoch,
   every survivor holding the same epoch log, each closed epoch delivering
   exactly its stable prefix and every live sender delivered exactly
   once: the cut's host wall time and the ms per round of each epoch;
15. the serve plane of phase 6 (qwen3-1.7b at full width, bf16) through
   two cuts (``SERVE_FAIL_AT``: a subscriber at round 7; a slot node of
   replica 0 at round 20, with a wave during the wedge that kills a
   subscriber of replica 1): drained, logs agreeing at every surviving
   subscriber, each epoch delivering its stable prefix, completed and
   shed requests partitioning the submitted ones, exact launches:
   tokens/s, decode steps, ``cut_walls``; then the same cuts in float32
   at 4 layers on the kernels and on the plain versions: tokens, logs,
   the view log and the slot failures exactly equal;
16. ``ElasticRuntime`` with a ``BucketSyncStream`` on the card at W = 3:
   each worker's float32 fused bucket set for full-width qwen3-1.7b
   (``gradsync.make_plan``), seeded once on the card; 6 rounds, worker 2
   failing in round 3 and node 3 joining in round 5: the applied ledger
   in step order with no gap, only the dead worker voided, ``app_base``
   monotone, every applied update bit-equal to the plain mean of its
   contributors on the card; peak memory;
17. ``chaos_soak`` on the testbed stream, the serve plane at 4 layers in
   float32 and a ``BucketSyncStream`` at seeds 11, 23 and 47: the card's
   ``kernel`` runs and the CPU's ``graph`` runs give equal digests, and
   no invariant breaks;
18. the fused serve program (``ReplicatedEngine.run(fused=True)``: each
   epoch one round captured as a CUDA graph, its control flow in IF
   nodes) on phase 6's setup cut to FUSED_LAYERS (4) layers, card
   ``kernel`` and card ``graph``: tokens,
   per-topic logs, free / finish / admit rounds and the report identical
   to the per-round loop's; host_hops 0; one capture cold, none warm;
   flag reads within ceil(rounds / 32) + 2; tokens/s cold and warm,
   wall per round, capture seconds, graph nodes and pool bytes; then,
   from a traced warm ``kernel`` run, 4 / 9 / 8 device kernels per
   device decode step, one watermark kernel a round, device time and
   busy share;
19. the fused program through the cut: ``FUSED_FAIL_AT`` (homogeneous
   cuts, three epochs) at full width, cold and warm, identical to the
   per-round loop; phase 15's ``SERVE_FAIL_AT`` (heterogeneous) falling
   back with the reference's reason to identical results at 4 layers;
   ``chaos_soak(fused=True)`` at seeds 11, 23 and 47 with the unfused
   soak's digests;
20. the load plane: ``run_profile`` on phase 2's testbed and phase 4's
   64-topic bound domain under ``AdmitAll``, ``WindowSlack`` and
   ``TokenBucket`` (fused and host loop, card ``kernel`` and ``graph``,
   CPU ``graph``) and on phase 6's serve plane under ``ServeAdmission``
   (fused and host loop on both card backends): identical
   ``LoadReport`` JSON, rounds/s; traced fused ``kernel`` runs give one
   watermark kernel a streamed round;
21. zamba2-2.7b's forward at full width (54 layers, bf16 weights from
   seed 0, ``loss_fn`` on 1 x 2048): a finite loss near ln V, exactly
   9 / 54 / 55 / 72 flash-attention / SSD / RMSNorm / residual-norm
   calls a forward, tokens/s, the bound;
22. the recurrent serve plane at full width: mamba2-2.7b at 16 of 64
   layers and zamba2-2.7b at 12 of 54 (``RECURRENT_SERVE_LAYERS``; bf16
   weights from seed 0, two replicas of 8 slots x
   2048 positions, 12 requests each with 2-4-token prompts, ``kernel``
   backend): drained, exact launches a decode step (mamba2 17 / 16,
   zamba2 2 flash decode / 13 / 16), ``ssm_state`` float32 beside bf16
   leaves in every engine; tokens/s, wall a decode step, the step's
   computed byte bound;
23. the same runs fused on card ``kernel`` and card ``graph``:
   identical to the per-round loop (tokens, logs, round traces, the
   report), host_hops 0, one capture cold and none warm, flag reads
   within ceil(rounds / 32) + 2; warm tokens/s, capture seconds, graph
   nodes, pool bytes;
24. both recurrent families in float32 at 4 layers (zamba2 with its
   shared block every 2): serve on the kernels against the plain
   versions under phase 7's rule, every request's batched tokens equal
   to the same request served alone, and the forward over 512 tokens
   against 512 decode steps (equal in float64 on the plain versions
   within 1e-9; the float32 decode within 1e-4 of the float64 forward
   and within 5e-4 of the float32 forward);
25. the profiled figures of phases 21-22: zamba2's forward (device
   time, busy share, per kernel) and one decode step of each model
   (device time, device operations, the leading device ops) beside its
   bound; phases 21-25 run in a child process of their own
   (``--recurrent-phases``), timed runs before profiled ones;
26. qwen2-moe-a2.7b's loss at full width (24 layers, bf16 weights from
   seed 0, 2 x 2048 tokens): 1 / 48 / 24 RMSNorm / residual-norm /
   flash-attention calls, the loss beside ln V, the aux term, the routes
   dropped and the smallest router gap, tokens/s, and a computed bound
   that counts the E x C capacity slots the program runs;
27. qwen2-moe-a2.7b at full width, 4 of its 24 layers (``cut_layers``,
   for the run's time limit), served on phase 6's layout, per round
   (1 / 8 / 4 calls a decode step, C = 8 >= 8 rows: nothing drops) and
   ``run(fused=True)`` (identical, host_hops 0, one capture cold and
   none warm): tokens/s, wall a step, graph nodes, capture seconds, pool
   bytes, the fused run's wall a device step, one traced decode step's
   device ms beside the step's byte bound (every expert's weights:
   ROADMAP item 25) and a traced short fused epoch's device ms a device
   step;
28. deepseek-moe-16b at full width: loss on 1 x 2048 (1 / 56 / 28), a
   prefill of 64 tokens and 8 decode steps continuing it, the router
   margin;
29. internvl2-26b at full width: ``vlm_loss`` on 256 patches + 1792 text
   tokens (2 / 96 / 48), a prefill of 256 + 64 positions and 8 decode
   steps, the bound;
30. seamless-m4t-medium at full width: ``seq2seq_loss`` on 2 x (1024
   frames + 1024 tokens) (12 non-causal and 12 causal flash attention,
   2 / 60 norms), the encoder as ``prefill_fn``, and serving on phase 6's
   layout per round (12 self and 12 cross flash decode a step);
31. the families in float32 at 4 layers (encdec 2 + 2), full width:
   serving on the kernels against the plain versions (phase 7's rule),
   the MoE's batched tokens equal to each request served alone, every
   forward's loss and logits kernels against plain with the launches
   counted, prefill then decode against the forward (the MoE at
   ``capacity_factor = E / K``) within 1e-4, the router margins (the
   MoE forwards' over 1e-5, its seed chosen by ``--moe-seed-search``);
   and the kernels against their plain versions at this slice's new
   shapes (non-causal attention at D = 64, the MoE losses' 16 / 16 heads
   at D = 128, internvl2's group of 6, RMSNorm at width 3200 and 6144).
   Phases 26-31 run in a child process of their own
   (``--families-phases``), timed runs before profiled ones;
32. the quantize pair bit for bit against its plain version at each
   trained model's largest bucket (W x shard float32, up to 1.45 G
   elements); zamba2-2.7b trained at full width and depth (54 layers, bf16
   weights from seed 0): ``Trainer`` with ``spindle_compressed`` over
   W = 2 workers folded onto the card, 2 x 2048 tokens of the stream, 3
   steps: finite losses near ln V, exact launches a step (each forward's
   counts x W, one quantize and one dequantize a bucket), the attention
   calls by causal flag, tokens/s, wall a step, peak memory, the bound
   (3x the forward's matrix work against AdamW's bytes), one warm step
   taken apart (``worker_grads``, the reduction, ``adamw.update``), and
   a profiled warm step (device time, busy share, the port's kernels);
33. qwen2-moe-a2.7b and deepseek-moe-16b trained likewise, depth cut
   to what one card's 80 GB holds beside the optimizer state: also the
   bound over the E x C capacity slots with the routed-only one beside
   it, and from a second, untimed run under a router probe the routes
   dropped, the aux term and the smallest router gap a step;
34. internvl2-26b (depth cut likewise; 256 one-hot patches + 1792 text
   tokens from the stub frontend) and seamless-m4t-medium (12 + 12
   layers; 1024 one-hot frames + 1024 tokens, 12 non-causal flash
   attention calls a forward) trained likewise;
35. the four families' train path in float32 at full width on the
   kernels and on the plain versions (``spindle``, W = 2): zamba2 at 4
   layers (its shared block every 2), seamless at 2 + 2, internvl2 and
   qwen2-moe at 2 layers (a first step at 4 would need ~88-97 GB), each
   worker's gradients against the plain run (the family's bar) and
   against the plain run in float64 (e_kernel <= 2 e_ref + 1e-6 on
   every leaf, e_ref the plain path's distance, or for zamba2 and
   internvl2 the furthest of it and two pure PyTorch RMSNorm variants';
   zamba2 at params seeds 35, 36 and 37), the error with one kind of
   site on its kernels (zamba2 and internvl2 also from float64), one
   train step, every MoE router gap over 1e-5 (its seed
   from ``--moe-seed-search 35``); each model's per-worker gradients
   at seed 35 also under ``remat="full"``: the exact launches of the
   rerun, losses bit-identical, gradients within the family's bar of
   the ``none`` run's.  Phases 32-35 run in a child
   process of their own (``--families-train-phases``), timed runs
   before profiled ones;
36. the DES held to the card runs of phases 2, 14, 17 and 20
   (``--des-phase`` runs it alone);
37. the launch plane: ``python -m repro_torch.launch.serve --arch
   qwen3-1.7b`` and ``python -m repro_torch.launch.train`` (full-width
   qwen3-1.7b, 3 steps of 8 x 128) as child processes, their lines
   parsed; the same launchers in-process with exact launches (the serve
   run also in float32, kernels against plain, identical tokens; the
   train steps' launches phase 12's at W = 1); the dry-run children
   (qwen3-1.7b x every shape on one pod, qwen2-72b ``train_4k`` on two,
   statuses as ``skip_reason`` says, CUDA never initialised there) and
   ``repro_torch.launch.roofline`` on their records, beside the card
   work; phase 3's grids through ``run_batch(devices=[cuda:0] * k)``,
   one chunk a device, identical to phase 3's unsharded and per-point
   runs (``--launch-phase`` runs it alone, after the build and phase 3);
38. across real ``torch.distributed`` ranks (``repro_torch.core.ranks``;
   ``--ranks-phase`` runs it alone, after the build), each rank a process
   that loads the kernels built here: (a) qwen3-1.7b at full width, 2
   of 28 layers, a 2 x 2048 global batch, ``make_train_step`` for 2 steps
   in each Spindle mode on two ranks sharing the card over ``gloo``
   (1 x 2048 rows each), every rank's losses, parameters and AdamW state
   bit-equal to the folded ``Runtime(dp_workers=2)`` run in a one-rank
   process of its own, exact launches a step, a warm step taken apart;
   (b) qwen2-moe-a2.7b at full width, 4 of 24 layers, its 64 expert
   slots 32 a rank over a ``{"data": 1, "model": 2}`` mesh: the loss at
   1 x 2048, a prefill of 1 x 512 and 8 greedy decode steps against the
   unsplit path (within the bf16 bar, greedy tokens equal where the
   unsplit top-2 gap exceeds it, routes and drops equal); (c)
   ``sst.push_rows`` of the testbed's SST columns, exact; (d) in the
   one-rank process, over ``nccl``: a train step and the three
   reductions, bit-equal to the folded W = 1 ones; (e) qwen2-moe-a2.7b
   at full width, 2 of 24 layers, trained through its experts split over
   ``{"data": 1, "model": 2}`` (``gspmd``, 2 steps of 1 x 2048) on the
   two ranks, against the unsplit one-rank step in the one-rank process:
   losses and parameters (strided samples of every leaf, rank i's expert
   rows against the unsplit rows [i E/2, (i + 1) E/2)) within the bf16
   bar, the first step's routes and drops equal (the same weights), a
   later step's routes different only where the two runs' router
   probabilities differ by at least half the token's unsplit gap (bf16
   weights that differ by a rounding move a near tie), the non-expert
   state bit-identical between the ranks, exact launches a step; (f)
   qwen3-1.7b at full width, 2 of 28 layers, on four ranks sharing the
   card over
   ``{"pod": 2, "data": 2}`` with ``dp_axes=("pod", "data")``, a 4 x
   2048 global batch, 2 steps in each Spindle mode and ``gspmd``: every
   rank's state bit-identical to every other's, ``spindle`` and
   ``spindle_per_tensor`` against the folded ``Runtime(dp_workers=4)``
   step in the one-rank process (losses within 1e-6 relative, the
   float32 master within the sign-flip bound), the compressed mode's
   first reduction against the two-leg mean (the int8 leg over
   ``"data"``, then the plain mean over ``"pod"``) computed there from
   the four ranks' own gradients, within one quantization step; exact
   launches a step (a quantize and a dequantize a bucket); (g) the
   rules' parameter layouts (``Runtime(rules=...)``, each rank its
   blocks by ``layers.shard_params``): (g1) in the four ranks' processes,
   qwen3-1.7b at full width, 2 of 28 layers, under ``baseline`` on
   ``{"data": 2, "model": 2}`` (8 / 4 heads, half the MLP and vocabulary
   a rank over ``"model"``, the ``fsdp_embed`` dims halved over
   ``"data"``), 2 ``gspmd`` steps of a 2 x 2048 global batch against the
   unsplit step in the one-rank process: losses and strided samples of
   every rank's blocks within the bf16 bar, ranks that hold the same
   block bit-identical, the unsplit step's launches a step, the seconds
   in ``gloo`` and the peak a rank beside the unsplit's; (g2) in the two
   ranks' processes, qwen2-72b at full width, 2 of 80 layers, under
   ``megatron`` on ``{"model": 2}`` (32 / 4 heads a rank): a prefill of 1
   x 512 and 8 greedy decode steps through ``make_serve_step`` against
   the unsplit path on rank 0 (logits within the bf16 bar, tokens equal
   where the unsplit top-2 gap exceeds it), a rank's weight bytes half
   the unsplit's; ``flash_attention`` and ``flash_decode`` at each part's
   local head counts against their plain versions; (h) every other
   family's layout at full width: (h1) mamba2-2.7b and (h3)
   qwen2-moe-a2.7b at 2 layers trained as (g1) on the four ranks (the
   Mamba block on 40 of 80 heads a rank, its gated norms
   ``layers.rms_norm_split``, so 1 ``rms_norm`` a step; the MoE's 64
   expert slots 32 a rank beside 8 of 16 heads; its comparison the
   folded per-shard step, each shard routing its own tokens, and its
   first step's routes allowed to differ only where the two runs'
   router probabilities moved by half the token's unsplit gap), (h2)
   zamba2-2.7b at 6 layers, (h4) internvl2-26b at 2 layers and
   seamless-m4t-medium at full depth served as (g2) on the two ranks (a
   loss at 1 x 2048, a prefill of 1 x 512, 8 greedy steps, from a zero
   decode state for the hybrid and the encdec; the hybrid's forward and
   the encoder's memory held by the yardstick), each rank's weight bytes
   its layout's; ``ssd_scan`` at 40 heads against its plain version;
   (i) the sequence-parallel presets (each rank holding its rows of the
   stream between the mixers, a gather before each mixer and a
   reduce-scatter after it): (i1) qwen3-1.7b at 2 layers under
   ``seq_model`` on (g1)'s four ranks (1024 of a row's 2048 positions a
   rank), trained as (g1) and held to (g1)'s unsplit step with (g1)'s
   bars, its collectives a step by kind, the seconds in ``gloo`` and
   the peak a rank beside (g1)'s; (i2) qwen2-72b at 2 layers under
   ``megatron_seq`` on (g2)'s two ranks served as (g2) (a loss at 1 x
   2048, a prefill of 1 x 512, 256 positions a rank, 8 greedy steps);
   ``flash_attention``, ``flash_decode``, ``rms_norm`` and
   ``rms_norm_residual`` at (i)'s shapes against their plain versions;
   (j) ``ssm_seq``, Mamba's form (each rank its rows of the stream, the
   Mamba block and the SwiGLU on them with their weights whole, the
   conv's halo and the scan's (B, H, P, N) state handed from rank to
   rank, the attention over the gathered sequence): (j1) mamba2-2.7b at
   (h1)'s 2 layers on (g1)'s four ranks, trained as (h1) and held to
   (h1)'s unsplit step with (h1)'s bars (its blocks under ``ssm_seq``),
   its collectives a step, the seconds in ``gloo`` and the peak a rank
   beside (h1)'s; (j2) zamba2-2.7b at (h2)'s 6 layers on (g2)'s two
   ranks served as (h2) (the loss at 1 x 2048 held by phase 13's
   yardstick, 1024 positions and 4 chunks a rank, the decode whole), a
   rank's weight bytes whole but the vocabulary; ``ssd_scan`` at a
   rank's (1, 1024, 80, 64) N = 128 against its plain version and the
   handoff's fold and correction on the card against the same math on
   the CPU;
39. on a host of four cards only (``--cards-phase``; the default run
   prints one line saying it skipped it, and on fewer than four cards
   the flag exits 1 naming the count): phase 38 as above, then the same
   parts one rank a card over ``nccl`` ((a), (b), (c), (e), (g2), (h2),
   (h4), (i2), (j2) on cuda:0-1; (f), (g1), (h1), (h3), (i1), (j1) on
   cuda:0-3), every rank reporting ``nccl`` and its own card, each part
   held to the same folded and unsplit results with the same bars as
   its ``gloo`` leg, and a line a part with both legs' warm walls,
   collectives by kind and bytes, their seconds and share, and the peaks
   a rank; each card's ``nvidia-smi`` line and ``topo -m``; (l) the nine
   kernels at the ``kernels`` line's shapes on cuda:1-3 while cuda:0 is
   current, against their plain versions (rows 1, 2, 8, 9 exactly); (k)
   four of Fig. 6's windows and Fig. 11's grid through ``run_batch`` on
   four and two cards, ``[cuda:0] * k``, unsharded and the default
   (every card), identical to the unsharded batch and the per-point
   runs, with walls, launches a chunk and, traced last, each card's busy
   time and their overlap;
then the ``kernels`` line: per kernel its launches on the main paths
(phases 2-4, 6, 9, 12, 14-17, 21-22, 26-30, 32-34, 37, 38 and, from the
device traces, 18 and 20), its times and its bound.

The round loop of every card multicast ``kernel`` run executes under
``torch.cuda.set_sync_debug_mode("error")``, so a host synchronisation
inside it fails the run.  The last line is the device record.  Needs one
CUDA GPU and ``nvcc``; exits 2 without a GPU.  Matmuls run in
full float32 (TF32 off) wherever float32 is compared.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import hashlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import api  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.core import (gradsync, graphloop, placement,  # noqa: E402
                              ranks, sst)
from repro_torch.core.group import (GraphBackend, KernelBackend,  # noqa: E402
                                    _stack_masks)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import smc_sweep as ss  # noqa: E402
from repro_torch.kernels import ssd_scan as sc  # noqa: E402
from repro_torch.kernels.meta import (attention_flops,  # noqa: E402
                                      ssd_flops)
from repro_torch.launch import opanalysis  # noqa: E402
from repro_torch.models import (attention, encdec, hybrid,  # noqa: E402
                                layers, moe, registry, ssm, transformer)
from repro_torch.models.config import (ShapeConfig,  # noqa: E402
                                       shape_by_name)
from repro_torch.models.runtime import Runtime, recomputing  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import rules as rules_lib  # noqa: E402
from repro_torch.train import steps  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
# The card's table has no int32 ALU rate; the SMC kernels' integer
# operations (the ring kernel's slot checks, the watermark kernel's closed
# form) are charged at the fp32 non-tensor-core peak (67 TFLOP/s).  The
# flash-decode and RMSNorm kernels compute in float32 outside the tensor
# cores, so their operations are charged at the same peak.
ALU_OPS_PER_S = 67e12
# Matrix work in bf16 is charged at the bf16 tensor-core peak, whatever
# the kernel uses; in float32 at the float32 peak above (TF32 would not
# keep float32's digits).
BF16_TC_OPS_PER_S = 989e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
SSD_Y_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
SSD_STATE_TOL = 1e-3
RTOL_FLOAT = 1e-6             # float report fields (FMA / summation order)

INT_FIELDS = ("delivered_app_msgs", "delivered_null_msgs", "nulls_sent",
              "rdma_writes", "rounds", "stalled")
FLOAT_FIELDS = ("throughput_GBps", "mean_latency_us", "p99_latency_us",
                "duration_us")


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``t_s``, the seconds
    since its process started (where the run's time limit goes)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls,
    from CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(e):
    """Device time of one profiler event average, in µs."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def profiled_device(fn, iters: int):
    """(mean time the device spent in kernels per ``fn()`` call, device
    operations (kernels, memsets, copies) per call), from the profiler's
    device-side trace (launch gaps excluded); (None, None) if the
    profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if device_us(e) > 0]
    total_us = sum(device_us(e) for e in events)
    if total_us <= 0:
        return None, None
    return total_us / iters / 1e3, sum(e.count for e in events) / iters


def profiled_device_ms(fn, iters: int):
    """Mean time the device spent in kernels per ``fn()`` call (see
    :func:`profiled_device`); None if the profiler recorded none."""
    return profiled_device(fn, iters)[0]


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def same_logs(a, b, what: str) -> None:
    check(a.keys() == b.keys(), f"{what}: subgroups differ")
    for gid in a:
        la, lb = a[gid], b[gid]
        check(la.delivered_seq == lb.delivered_seq,
              f"{what}: delivered_seq differs in subgroup {gid}")
        check(len(la.is_app) == len(lb.is_app)
              and all(np.array_equal(x, y)
                      for x, y in zip(la.is_app, lb.is_app)),
              f"{what}: is_app differs in subgroup {gid}")


def same_report(ra, rb, what: str) -> None:
    for f in INT_FIELDS:
        check(getattr(ra, f) == getattr(rb, f),
              f"{what}: {f} {getattr(ra, f)} != {getattr(rb, f)}")
    for f in FLOAT_FIELDS:
        check(np.allclose(getattr(ra, f), getattr(rb, f), rtol=RTOL_FLOAT,
                          atol=0.0),
              f"{what}: {f} {getattr(ra, f)} vs {getattr(rb, f)}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase0_identity():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    build_s = build_kernels()
    emit({"phase": 0, "nvidia_smi": smi_line,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s})
    return smi_line


def build_kernels() -> float:
    """Build and load every CUDA source of the port (an unchanged source
    is loaded from ``build/``); returns the seconds it took."""
    t0 = time.perf_counter()
    # one nvcc per CUDA source, all started together
    with concurrent.futures.ThreadPoolExecutor() as pool:
        for fut in [pool.submit(_build.build, name)
                    for name in ("smc_sweep", "flash_decode",
                                 "flash_attention", "ssd_scan",
                                 "quantize", "rmsnorm", "graph_cond")]:
            fut.result()
    ss.build()
    fd.build()
    fa.build()
    sc.build()
    qz.build()
    rn.build()
    graphloop.build()
    return time.perf_counter() - t0


def lane_inputs(n: int, window: int, seed: int, extremes: bool = False):
    """Seeded lanes: half near a realistic receive (published within a
    window or two of processed), half arbitrary, with negative processed
    counts among both; plus a random validity mask.  ``extremes``: lanes
    within 2W of INT32_MAX, INT32_MIN and 0, published <= 0 and in
    (0, W), and arbitrary int32 lanes (as tests/test_torch_smc_sweep.py
    builds them), where the int32 adds wrap."""
    rng = np.random.default_rng(seed)
    processed = rng.integers(-2 * window, 4 * window, size=n)
    near = processed + rng.integers(-1, window + 2, size=n)
    wild = rng.integers(-window, 6 * window, size=n)
    published = np.where(rng.random(n) < 0.5, near, wild)
    if extremes:
        i32 = np.iinfo(np.int32)
        base = rng.choice(np.array([i32.max, i32.min, 0], np.int64), size=n)
        processed = base + rng.integers(-2 * window, 2 * window + 1, size=n)
        published = base + rng.integers(-2 * window, 2 * window + 1, size=n)
        small = rng.random(n) < 0.25
        published = np.where(small, rng.integers(-window, window, size=n)
                             + 1, published)
        mix = rng.random(n) < 0.2
        processed = np.where(mix, rng.integers(i32.min, i32.max, size=n),
                             processed)
        published = np.where(mix, rng.integers(i32.min, i32.max, size=n),
                             published)
        processed, published = (np.clip(x, i32.min, i32.max)
                                for x in (processed, published))
    valid = rng.random(n) < 0.8
    dev = torch.device("cuda")
    as_dev = lambda x: torch.as_tensor(x.astype(np.int32), device=dev)
    return as_dev(published), as_dev(processed), as_dev(valid)


# integer operations of one lane of the watermark kernel's closed form
# (difference, max, two clamps, add, mask select)
WATERMARK_OPS_PER_LANE = 6


def phase1_kernels(shapes):
    """Each kernel against its twin on the card, exact; times per shape."""
    rows = []
    for label, n, window in shapes:
        pub, proc, valid = lane_inputs(n, window, seed=n + window,
                                       extremes=label == "extremes")
        counters = ss.counters_from_counts(pub, window).contiguous()
        cases = {
            "smc_sweep_watermark": (
                lambda: ss.smc_sweep_watermark(pub, proc, window=window),
                lambda: ss.smc_sweep_watermark_plain(pub, proc, window)),
            "smc_sweep_watermark_masked": (
                lambda: ss.smc_sweep_watermark(pub, proc, window=window,
                                               valid=valid),
                lambda: ss.smc_sweep_watermark_plain(pub, proc, window,
                                                     valid)),
            "smc_sweep": (lambda: ss.smc_sweep(counters, proc),
                          lambda: ss.smc_sweep_plain(counters, proc)),
        }
        want_plain = None
        closed = ss.smc_sweep_watermark_closed_form
        forms = {"smc_sweep_watermark": lambda: closed(pub, proc, window),
                 "smc_sweep_watermark_masked":
                 lambda: closed(pub, proc, window, valid)}
        for name, (kernel, plain) in cases.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max().item())
            check(err == 0 and got.dtype == torch.int32,
                  f"{name} at {label} ({n} lanes, W={window}) differs "
                  f"from its twin by {err}")
            if name in forms:
                check(torch.equal(got, forms[name]()),
                      f"{name} at {label} differs from its closed form")
            if name == "smc_sweep_watermark":
                want_plain = want
            if name == "smc_sweep":   # the ring oracle of the watermark form
                check(torch.equal(got, want_plain),
                      f"ring sweep != watermark sweep at {label}")
            big = n >= 1 << 18
            kernel_ms = cuda_ms(kernel, 50 if big else 200)
            kernel_device_ms, ops_per_call = profiled_device(kernel, 50)
            plain_ms = cuda_ms(plain, 5 if big else 50, warmup=2)
            extra = {}
            if name == "smc_sweep":
                # the ring kernel checks (run + 1) slots of a row, at most
                # W: those counters are what these inputs need read, with
                # processed read and the count written (bytes_whole_ring:
                # what a bound that ignores the early exit would charge)
                run = (want.long() - proc.long()).clamp(min=0)
                ops = int((run + 1).clamp(max=window).sum().item())
                nbytes = 4 * (ops + 2 * n)
                extra = {"bytes_whole_ring": 4 * (counters.numel() + 2 * n)}
            else:
                ops = WATERMARK_OPS_PER_LANE * n
                nbytes = 4 * ((3 if name.endswith("masked") else 2) * n + n)
            bound_ms, bound_by = bound(nbytes, ops)
            rows.append({"kernel": name, "shape": label, "lanes": n,
                         "window": window, "max_abs_err": err,
                         "ms": kernel_ms, "device_ms": kernel_device_ms,
                         "device_ops_per_call": ops_per_call,
                         "plain_ms": plain_ms, "bytes": nbytes,
                         "int_ops": ops, "bound_ms": bound_ms,
                         "bound_by": bound_by, **extra})
        # three PyTorch calls (not one: no library call computes the
        # sweep), the closed form for non-negative inputs
        yard_ms = cuda_ms(lambda: proc + torch.clamp(pub - proc, 0, window),
                          50 if n >= 1 << 18 else 200)
        for r in rows[-len(cases):]:
            r["yardstick_ms"] = yard_ms
            emit({"phase": 1, **r})
    return rows


class SyncCheckedKernelBackend(KernelBackend):
    """The ``kernel`` backend with its device part (round loop and cost
    fold) run under ``set_sync_debug_mode("error")``: a host
    synchronisation inside the loop raises."""

    def _execute(self, *args):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return super()._execute(*args)
        finally:
            torch.cuda.set_sync_debug_mode(prev)


def timed_run(group, backend):
    t0 = time.perf_counter()
    report = group.run(backend=backend)
    return report, time.perf_counter() - t0


def phase2_testbed():
    """The paper's testbed on card ``kernel``, card ``graph`` and CPU
    ``graph``, identical; returns the card ``kernel`` run (report,
    logs)."""
    cfg = api.single_group(16, msg_size=10240, window=100, n_messages=1000)
    out = {}
    walls = {}
    for key, device, backend in (
            ("kernel_cuda", "cuda", SyncCheckedKernelBackend("cuda")),
            ("graph_cuda", "cuda", "graph"),
            ("graph_cpu", "cpu", "graph")):
        g = api.Group(cfg, device=device)
        timed_run(g, backend)                           # cold
        before = ss.WATERMARK_LAUNCHES
        report, wall = timed_run(g, backend)            # warm
        launches = ss.WATERMARK_LAUNCHES - before
        if key == "kernel_cuda":
            check(launches == report.rounds,
                  f"testbed: {launches} kernel launches for "
                  f"{report.rounds} rounds")
        else:
            check(launches == 0, f"testbed {key} launched the kernel")
        check(not report.stalled, f"testbed {key} stalled")
        check(report.delivered_app_msgs == 16 * 16 * 1000,
              f"testbed {key}: {report.delivered_app_msgs} app deliveries")
        out[key] = (report, dict(g.delivery_logs))
        walls[key] = {"wall_s": wall, "per_round_ms":
                      wall / report.rounds * 1e3, "launches": launches}
    ref_report, ref_logs = out["graph_cpu"]
    for key in ("kernel_cuda", "graph_cuda"):
        same_logs(out[key][1], ref_logs, f"testbed {key} vs graph_cpu")
        same_report(out[key][0], ref_report, f"testbed {key} vs graph_cpu")
    emit({"phase": 2, "scenario": "single_group(16, msg_size=10240, "
          "window=100, n_messages=1000)", "rounds": ref_report.rounds,
          "identical": True, **walls,
          "profile_kernel_cuda": profile_run(cfg),
          "summary": ref_report.summary()})
    return out["kernel_cuda"]


def profile_run(cfg):
    """Where a warm card ``kernel`` run's time goes: device kernel time
    against host wall time, from the profiler's device-side trace."""
    from torch.profiler import ProfilerActivity, profile
    g = api.Group(cfg, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        report, wall = timed_run(g, SyncCheckedKernelBackend("cuda"))
    events = prof.key_averages()

    busy_us = sum(device_us(e) for e in events)
    sweep = [e for e in events if "smc_sweep_watermark_kernel" in e.key]
    sweep_us = sum(device_us(e) for e in sweep)
    sweep_n = sum(e.count for e in sweep)
    top = sorted(events, key=device_us, reverse=True)[:5]
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "device_ops_per_round": sum(e.count for e in events)
            / report.rounds,
            "sweep_kernel_launches": sweep_n,
            "sweep_kernel_us_per_launch": sweep_us / sweep_n
            if sweep_n else None,
            "top_device_ops_us": {e.key[:60]: device_us(e) for e in top}}


def phase3_grids():
    """The two grids as one ``run_batch`` each on card ``kernel``, every
    point against its own sequential run; returns each grid's config,
    grid, batch reports and (solo report, solo logs) per point."""
    rows, grids_run = {}, {}
    grids = (
        ("fig6_windows", api.single_group(16, msg_size=10240, n_messages=800),
         {"windows": [5, 20, 100, 500, 1000]}),
        ("fig11_null_send",
         api.single_group(16, msg_size=10240, n_messages=1200),
         {"null_send": [True, False]}))
    for label, cfg, grid in grids:
        g = api.Group(cfg, device="cuda")
        before = ss.WATERMARK_LAUNCHES
        t0 = time.perf_counter()
        reports = g.run_batch(backend=SyncCheckedKernelBackend("cuda"),
                              **grid)
        wall = time.perf_counter() - t0
        launches = ss.WATERMARK_LAUNCHES - before
        t_max = max(r.rounds for r in reports)
        check(launches == t_max, f"{label}: {launches} launches for a "
              f"{t_max}-round grid (want one per round)")
        (key, values), = grid.items()
        solos = []
        for value, report in zip(values, reports):
            if key == "windows":
                over = {"subgroups": tuple(dataclasses.replace(
                    s, window=value) for s in cfg.subgroups)}
            else:
                over = {"flags": dataclasses.replace(cfg.flags,
                                                     null_send=value)}
            solo = api.Group(dataclasses.replace(cfg, **over),
                             device="cuda")
            solo_report = solo.run(backend=SyncCheckedKernelBackend("cuda"))
            same_logs(report.extras["delivery_logs"], solo.delivery_logs,
                      f"{label} point {value}")
            same_report(report, solo_report, f"{label} point {value}")
            solos.append((solo_report, solo.delivery_logs))
        rows[label] = {"points": len(reports), "rounds": t_max,
                       "launches": launches, "batch_wall_s": wall,
                       "per_round_ms": wall / t_max * 1e3,
                       "per_point": [r.summary() for r in reports]}
        grids_run[label] = (cfg, grid, reports, solos)
    emit({"phase": 3, "identical_to_sequential": True, **rows})
    return grids_run


def dds_domain():
    """16 nodes, 64 topics: topic t has 1 + t % 4 publishers and
    2 + t % 11 subscribers, windows alternating 16/100, 4 KB samples."""
    d = api.Domain(n_nodes=16)
    for t in range(64):
        n_pub, n_sub = 1 + t % 4, 2 + t % 11
        nodes = [(t + i) % 16 for i in range(n_pub + n_sub)]
        d.create_topic(f"topic-{t}", publishers=nodes[:n_pub],
                       subscribers=nodes[n_pub:], sample_size=4096,
                       window=16 if t % 2 == 0 else 100)
    return d


def dds_lanes() -> int:
    topics = dds_domain().topics
    return len(topics) * max(len(t.members) for t in topics) * \
        max(len(t.publishers) for t in topics)


def phase4_dds():
    out, walls = {}, {}
    for key, device, backend in (
            ("kernel_cuda", "cuda", SyncCheckedKernelBackend("cuda")),
            ("graph_cuda", "cuda", "graph"),
            ("graph_cpu", "cpu", "graph")):
        g = dds_domain().group(samples_per_publisher=200, device=device)
        before = ss.WATERMARK_LAUNCHES
        report, wall = timed_run(g, backend)
        launches = ss.WATERMARK_LAUNCHES - before
        cfg = g.cfg
        t_max = max(GraphBackend._rounds_for(cfg, spec, g.send_counts(i))
                    for i, spec in enumerate(cfg.subgroups))
        if key == "kernel_cuda":
            masks = _stack_masks(tuple(len(s.members) for s in cfg.subgroups),
                                 tuple(len(s.senders) for s in cfg.subgroups))
            check(masks[0] is not None, "DDS stack is not heterogeneous")
            check(launches == t_max, f"DDS: {launches} launches for "
                  f"{t_max} rounds")
        check(not report.stalled, f"DDS {key} stalled")
        out[key] = (report, dict(g.delivery_logs))
        walls[key] = {"wall_s": wall, "rounds": t_max, "launches": launches}
    for key in ("kernel_cuda", "graph_cuda"):
        same_logs(out[key][1], out["graph_cpu"][1], f"DDS {key} vs graph_cpu")
        same_report(out[key][0], out["graph_cpu"][0],
                    f"DDS {key} vs graph_cpu")
    emit({"phase": 4, "topics": 64, "nodes": 16, "lanes": dds_lanes(),
          "identical": True, **walls,
          "summary": out["graph_cpu"][0].summary()})


# ---------------------------------------------------------------------------
# the serve plane's kernels and the serve plane itself
# ---------------------------------------------------------------------------

def within(got, want, dtype, tol=None, what: str = "") -> float:
    """Max |got - want|; fails unless allclose at ``tol`` (the dtype's
    bar by default)."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max().item())
    tol = TOL[dtype] if tol is None else tol
    check(bool(((got - want).abs() <= tol + tol * want.abs()).all()),
          f"{what}: max error {err} beyond the {dtype} tolerance {tol}")
    return err


def bound(nbytes: float, flops: float, ops_per_s: float = ALU_OPS_PER_S):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def time_case(kernel, plain, library, iters: int = 200):
    # the profiler reported no device time for windows of 5-12 launches
    # on the card: profile at least 50
    device_ms, ops_per_call = profiled_device(kernel, max(iters // 4, 50))
    return {"ms": cuda_ms(kernel, iters), "device_ms": device_ms,
            "device_ops_per_call": ops_per_call,
            "plain_ms": cuda_ms(plain, max(iters // 10, 5), warmup=2),
            "library_ms": None if library is None
            else cuda_ms(library, iters)}


def sdpa_library(q, k, v, kv_len):
    """One ``scaled_dot_product_attention`` call with a boolean mask over
    the same inputs (timed as a yardstick; the port never calls it)."""
    F = torch.nn.functional
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qs = q[:, :, None]                                  # (B, Hq, 1, D)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)       # (B, Hkv, S, D)
    mask = (torch.arange(s, device=q.device)[None, :]
            < kv_len[:, None])[:, None, None]           # (B, 1, 1, S)
    try:
        F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                       enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)
    except TypeError:                     # a PyTorch without enable_gqa
        kr = ks.repeat_interleave(hq // hkv, 1)
        vr = vs.repeat_interleave(hq // hkv, 1)
        return lambda: F.scaled_dot_product_attention(qs, kr, vr,
                                                      attn_mask=mask)


def phase5_kernels():
    """The serve plane's kernels against their plain versions."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    mixed = [1, 511, 512, 513, 2048, 37, 1024, 1500]
    serve = np.random.default_rng(6).integers(1, 41, 8).tolist()
    # the recurrent serve's lengths (prompts of 2-4 tokens plus up to 16
    # generated ones; phases 22-23)
    recurrent = np.random.default_rng(7).integers(3, 21, 8).tolist()
    # (label, B, Hq, Hkv, D, S_max, lengths): the serve plane's shape with
    # the serve run's lengths (prompts of 8-24 tokens plus up to 16
    # generated ones), mixed and full lengths; zamba2's attention heads
    # (D=80, group 1), also at the recurrent serve's lengths (zamba2's
    # shared block, phases 22-23); a group of 16; a cache of one chunk,
    # where the split kernel writes the output and no merge runs
    cases = (("serve", 8, 16, 8, 128, 2048, serve),
             ("mixed", 8, 16, 8, 128, 2048, mixed),
             ("all2048", 8, 16, 8, 128, 2048, [2048] * 8),
             ("mixed D=80", 8, 32, 32, 80, 2048, mixed),
             ("recurrent D=80", 8, 32, 32, 80, 2048, recurrent),
             ("mixed group 16", 8, 16, 1, 128, 2048, mixed),
             ("serve one chunk", 8, 16, 8, 128, 128, serve))
    for dtype in (torch.float32, torch.bfloat16):
        for label, b, hq, hkv, d, s_max, lens in cases:
            q = torch.randn(b, hq, d, generator=gen, device=dev).to(dtype)
            k = torch.randn(b, s_max, hkv, d, generator=gen,
                            device=dev).to(dtype)
            v = torch.randn(b, s_max, hkv, d, generator=gen,
                            device=dev).to(dtype)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            kernel = lambda: fd.flash_decode(q, k, v, kv_len)
            plain = lambda: fd.flash_decode_plain(q, k, v, kv_len)
            err = within(kernel(), plain(), dtype,
                         what=f"flash_decode {label} {dtype}")
            keys = sum(lens)
            esize = q.element_size()
            nbytes = 2 * q.numel() * esize + 4 * b + \
                2 * keys * hkv * d * esize
            bound_ms, bound_by = bound(nbytes, 4 * d * hq * keys)
            chunk, n_chunks, tile = fd.launch_geometry(s_max, d, dtype)
            rows.append({"kernel": "flash_decode", "dtype": str(dtype),
                         "shape": f"B={b} Hq={hq} Hkv={hkv} D={d} "
                         f"S_max={s_max} lengths={label.split()[0]}",
                         "lengths": lens,
                         "chunks": n_chunks, "chunk": chunk, "tile": tile,
                         "max_abs_err": err,
                         **time_case(kernel, plain,
                                     sdpa_library(q, k, v, kv_len)),
                         "bound_ms": bound_ms, "bound_by": bound_by})
    # the dense decode's hidden and per-head norms, then the recurrent
    # decode's hidden (2560) and gated (5120) norms
    rows += rmsnorm_rows(((8, 2048), (8 * 16, 128), (8, 2560), (8, 5120)),
                         gen, 200)
    for r in rows:
        emit({"phase": 5, **r})
    return rows


def rmsnorm_rows(shapes, gen, iters: int):
    """Both RMSNorm kernels against their plain versions at each (rows,
    width) shape, float32 and bfloat16, with times and the bound."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in shapes:
            x, res = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                      for _ in range(2))
            w = (1 + 0.1 * torch.randn(shape[-1:], generator=gen,
                                       device=dev)).to(dtype)
            esize, n = x.element_size(), x.numel()
            cases = {
                "rms_norm": (lambda: rn.rms_norm(x, w),
                             lambda: rn.rms_norm_plain(x, w),
                             (lambda: F.rms_norm(x, shape[-1:], w, 1e-6))
                             if hasattr(F, "rms_norm") else None,
                             2 * n * esize + w.numel() * esize, 4 * n),
                "rms_norm_residual": (
                    lambda: rn.rms_norm_residual(x, res, w),
                    lambda: rn.rms_norm_residual_plain(x, res, w), None,
                    4 * n * esize + w.numel() * esize, 5 * n)}
            for name, (kernel, plain, library, nbytes, flops) in \
                    cases.items():
                got, want = kernel(), plain()
                if name == "rms_norm":
                    got, want = (got,), (want,)
                err = max(within(g, w_, dtype) for g, w_ in zip(got, want))
                bound_ms, bound_by = bound(nbytes, flops)
                rows.append({"kernel": name, "dtype": str(dtype),
                             "shape": f"{shape[0]}x{shape[1]}",
                             "max_abs_err": err,
                             **time_case(kernel, plain, library, iters),
                             "bound_ms": bound_ms, "bound_by": bound_by})
    return rows


def serve_requests(request_cls, vocab: int, per_replica: int, seed: int,
                   replicas: int = 2, new_tokens: int = 16):
    """Seeded prompts of 8-24 tokens, one list per replica."""
    rng = np.random.default_rng(seed)
    return [[request_cls(rid=g * 1000 + i,
                         prompt=rng.integers(0, vocab, int(rng.integers(
                             8, 25)), dtype=np.int32),
                         max_new_tokens=new_tokens)
             for i in range(per_replica)] for g in range(replicas)]


def tensors(tree):
    """Every tensor of a nested dict."""
    if isinstance(tree, torch.Tensor):
        yield tree
        return
    for v in tree.values():
        yield from tensors(v)


def serve_setup(cfg, dtype, seed: int, rt=Runtime(), backend="kernel"):
    """Two replicas sharing one random parameter set (``init_params``:
    float32 specs, the ssm's per-head vectors, stay float32)."""
    params = registry.Arch(cfg).init_params(seed, "cuda", dtype)
    engines = [api.ServeEngine(cfg.name, params, cfg,
                               api.EngineConfig(max_batch=8, max_len=2048),
                               rt=rt, device="cuda") for _ in range(2)]
    rep = api.ReplicatedEngine(engines, subscribers_per_replica=2,
                               window=8, backend=backend, device="cuda")
    return params, rep


def serve_run(rep, per_replica: int, seed: int):
    rep.reset()
    for g, reqs in enumerate(serve_requests(
            api.Request, rep.engines[0].cfg.vocab_size, per_replica, seed)):
        for req in reqs:
            rep.submit(g, req)
    torch.cuda.synchronize()
    report = rep.run()
    torch.cuda.synchronize()
    return report


def serve_profile(rep, per_replica: int, seed: int):
    """Device-busy share of a warm serve run, from the profiler's
    device-side trace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report = serve_run(rep, per_replica, seed)
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    busy_us = sum(device_us(e) for e in events)
    by_kernel = {}
    # device kernels of each wrapper; a call launches the first (and, for
    # flash decode over more than one chunk, the merge kernel after it)
    for label, keys in (("flash_decode", ("flash_decode_split_kernel",
                                          "flash_decode_merge_kernel")),
                        ("rms_norm", ("rms_norm_kernel",)),
                        ("rms_norm_residual", ("rms_norm_residual_kernel",)),
                        ("smc_sweep_watermark",
                         ("smc_sweep_watermark_kernel",))):
        hits = [e for e in events if any(k in e.key for k in keys)]
        n = sum(e.count for e in hits if keys[0] in e.key)
        by_kernel[label] = {"launches": n, "device_us_per_launch":
                            sum(device_us(e) for e in hits) / n
                            if n else None}
    top = sorted(events, key=device_us, reverse=True)[:6]
    serve = report.extras["serve"]
    return {"requests": serve["requests"], "decode_steps":
            serve["decode_steps"], "wall_s": wall,
            "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "device_ms_per_decode_step": busy_us / 1e3
            / serve["decode_steps"],
            "kernels": by_kernel,
            "top_device_ops_us": {e.key[:60]: device_us(e) for e in top}}


# phase 6 serves qwen3-1.7b at 8 of its 28 layers: its per-round loop is
# host-bound, ~1000 launches a step at 28 layers, and the run's time
# limit needed the room
SERVE_LAYERS = 8


def phase6_serve():
    """The serve plane at qwen3-1.7b's full width, SERVE_LAYERS layers,
    on the kernel backend; returns the serve path's launch counts."""
    cfg = dataclasses.replace(registry.get("qwen3-1.7b").cfg,
                              n_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    params, rep = serve_setup(cfg, torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in
                      tensors(params))
    per_replica = 16
    ops.reset_launch_counts()                 # the serve path starts here
    report = serve_run(rep, per_replica, seed=1)
    launches = ops.launch_counts()            # ... and ends here
    serve = report.extras["serve"]
    check(serve["drained"] and not report.stalled,
          f"serve run did not drain: {serve}")
    check(serve["requests"] == 32 and serve["tokens"] == 32 * 16,
          f"serve run: {serve['requests']} requests, {serve['tokens']} "
          "tokens (want 32, 512)")
    steps = serve["decode_steps"]
    want = {"flash_decode": cfg.n_layers * steps,
            "rms_norm": (1 + 2 * cfg.n_layers) * steps,
            "rms_norm_residual": 2 * cfg.n_layers * steps,
            "smc_sweep_watermark": report.extras["streamed_rounds"],
            "smc_sweep": 0, "flash_attention": 0, "ssd_scan": 0,
            "quantize": 0, "dequantize": 0}
    check(launches == want, f"serve launches {launches}, want {want}")
    tokens = rep.completed()
    for stream in (t for per in tokens.values() for t in per):
        check(len(stream) == 16 and all(0 <= x < cfg.vocab_size
                                        for x in stream),
              f"bad token stream {stream}")
    # one more step straight through the decoder: finite logits
    eng = rep.engines[0]
    logits, _ = eng.decode(params, eng.cache, torch.zeros(
        (8, 1), dtype=torch.int32, device="cuda"), torch.arange(
        8, dtype=torch.int32, device="cuda"), np.ones(8, bool))
    check(logits.shape == (8, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "full-width decode step gave non-finite logits")
    warm = serve_run(rep, per_replica, seed=1)
    check(rep.completed() == tokens, "warm serve run changed its tokens")
    wserve = warm.extras["serve"]
    emit({"phase": 6, "model": cfg.name, "layers": cfg.n_layers,
          "params": cfg.param_count(), "param_bytes": param_bytes,
          "replicas": 2, "slots": 8, "max_len": 2048, "window": 8,
          "subscribers_per_replica": 2, "backend": "kernel",
          "setup_s": setup_s, "launches": launches,
          "launches_per_decode_step": {
              k: launches[k] / steps for k in
              ("flash_decode", "rms_norm", "rms_norm_residual")},
          "cold": {"wall_s": serve["wall_s"],
                   "tokens_per_s": serve["tokens_per_s"]},
          "warm": {k: wserve[k] for k in
                   ("requests", "tokens", "tokens_per_s", "wall_s",
                    "engine_rounds", "decode_steps", "host_hops",
                    "max_backlog", "stall_rounds")},
          "warm_wall_ms_per_engine_round": wserve["wall_s"]
          / wserve["engine_rounds"] * 1e3,
          "warm_wall_ms_per_decode_step": wserve["wall_s"]
          / wserve["decode_steps"] * 1e3,
          "decode_step_bound_ms": param_bytes / HBM_BYTES_PER_S * 1e3,
          "streamed_rounds": warm.extras["streamed_rounds"],
          "multicast": warm.summary(),
          "profile_warm_2_per_replica": serve_profile(rep, 2, seed=3)})
    del params, rep
    torch.cuda.empty_cache()
    return launches


def record_margins(rep):
    """Wrap each engine's decode so every generating step keeps its
    rows' top-2 logits; returns the records (filled during the run)."""
    records = []
    for g, eng in enumerate(rep.engines):
        decode = eng.decode

        def wrapped(p, c, t, pos, valid, eng=eng, decode=decode, g=g):
            logits, c = decode(p, c, t, pos, valid)
            rows = [(i, eng.slot_req[i].rid, len(eng.slot_req[i].tokens_out))
                    for i in np.flatnonzero(valid)
                    if eng.slot_len[i] >= len(eng.slot_req[i].prompt)]
            if rows:          # a generating step, not a prefill step
                records.append((rows, torch.topk(logits.float(), 2,
                                                 dim=-1).values))
            return logits, c

        eng.decode = wrapped
    return records


def phase7_kernels_vs_plain():
    """The serve scenario in float32 at 4 layers on the kernels and on
    the plain versions (over the graph backend)."""
    cfg = dataclasses.replace(registry.get("qwen3-1.7b").cfg, n_layers=4)
    record, _ = serve_kernels_vs_plain(
        cfg, lambda rep: serve_run(rep, 16, seed=4),
        {"flash_decode": cfg.n_layers}, "phase 7")
    emit({"phase": 7, **record})


def serve_kernels_vs_plain(cfg, run, per_step: dict, what: str):
    """``run(rep)`` in float32 on two replicas of ``cfg`` on the kernels
    (``kernel`` backend) and on the plain versions (``graph`` backend):
    identical logs, counters and round traces, and tokens that differ
    only where the plain run's top-2 logit margin is under 1e-4
    relative; the kernel run launching ``per_step`` a decode step, the
    plain run nothing.  Returns the comparison's record and the kernel
    run's tokens by request."""
    out = {}
    margins = {}
    for key, rt, backend in (("kernels", Runtime(), "kernel"),
                             ("plain", Runtime(kernels="plain"), "graph")):
        _, rep = serve_setup(cfg, torch.float32, seed=2, rt=rt,
                             backend=backend)
        records = record_margins(rep) if key == "plain" else None
        before = ops.launch_counts()
        t0 = time.perf_counter()
        report = run(rep)
        wall = time.perf_counter() - t0
        after = ops.launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        if key == "plain":
            check(all(launched[k] == 0 for k in
                      ("flash_decode", "rms_norm", "rms_norm_residual",
                       "smc_sweep_watermark")),
                  f"{what}: the plain run launched kernels: {launched}")
            for rows, top in records:
                top = top.cpu().numpy()
                for i, rid, j in rows:
                    t1, t2 = top[i]
                    margins[(rid, j)] = (t1 - t2) / max(abs(t1), 1e-30)
        else:
            steps_ = report.extras["serve"]["decode_steps"]
            check(all(launched[k] == n * steps_
                      for k, n in per_step.items()),
                  f"{what}: kernel run launches {launched}, want "
                  f"{per_step} x {steps_} decode steps")
        out[key] = (report, rep, wall)
        del rep
        torch.cuda.empty_cache()
    (rk, repk, wk), (rp, repp, wp) = out["kernels"], out["plain"]
    same_logs({k: v for k, v in rk.extras["delivery_logs"].items()},
              rp.extras["delivery_logs"], f"{what} logs")
    for f in INT_FIELDS:
        check(getattr(rk, f) == getattr(rp, f), f"{what}: {f} differs")
    for key in ("engine_rounds", "decode_steps", "requests", "tokens",
                "host_hops", "stall_rounds", "max_backlog"):
        check(rk.extras["serve"][key] == rp.extras["serve"][key],
              f"{what}: serve {key} differs")
    for name in ("admit_rounds", "admit_slots", "finish_rounds",
                 "free_rounds"):
        check(getattr(repk, name) == getattr(repp, name),
              f"{what}: {name} differs")
    near_ties, compared = [], 0
    by_rid_k = {r.rid: r.tokens_out for e in repk.engines
                for r in e.completed}
    by_rid_p = {r.rid: r.tokens_out for e in repp.engines
                for r in e.completed}
    check(by_rid_k.keys() == by_rid_p.keys(), f"{what}: requests differ")
    for rid in sorted(by_rid_p):
        a, b = by_rid_k[rid], by_rid_p[rid]
        compared += len(b)
        diff = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)
        if diff is None:
            continue
        m = margins.get((rid, diff))
        check(m is not None and m < 1e-4,
              f"{what}: request {rid} differs at token {diff} where the "
              f"plain run's top-2 margin is {m}")
        near_ties.append({"rid": rid, "token": diff, "margin": float(m)})
    return {"model": cfg.name, "layers": cfg.n_layers,
            "dtype": "float32", "requests": rp.extras["serve"]["requests"],
            "tokens_compared": compared, "identical_logs": True,
            "identical_round_traces": True,
            "differing_tokens_at_near_ties": near_ties,
            "min_plain_margin": float(min(margins.values())),
            "kernels_wall_s": wk, "plain_wall_s": wp,
            "kernels_tokens_per_s": rk.extras["serve"]["tokens_per_s"],
            "plain_tokens_per_s": rp.extras["serve"]["tokens_per_s"]}, \
        by_rid_k


# ---------------------------------------------------------------------------
# the forward path's kernels and the forward path itself
# ---------------------------------------------------------------------------

def sdpa_causal_library(q, k, v, causal):
    """One ``scaled_dot_product_attention`` call over the same inputs in
    its (B, H, S, D) layout (timed as a yardstick; the port never calls
    it)."""
    F = torch.nn.functional
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal, enable_gqa=True)


def ssd_inputs(b, s, h, p, n, g, dtype, gen):
    """x, b, c in ``dtype``; dt in ``dtype`` too (the model slices it from
    the same projection); a_log, d_skip, dt_bias float32 and drawn."""
    dev = torch.device("cuda")
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    uni = lambda lo, hi: lo + (hi - lo) * torch.rand(h, generator=gen,
                                                     device=dev)
    return (rnd(b, s, h, p).to(dtype), (0.5 * rnd(b, s, h)).to(dtype),
            uni(-1.0, 0.5), (0.3 * rnd(b, s, g, n)).to(dtype),
            (0.3 * rnd(b, s, g, n)).to(dtype), uni(0.0, 1.0),
            uni(-0.5, 0.5))


def misaligned_attention_row(gen):
    """A bfloat16 q sliced 2 bytes into its buffer: no 16-byte aligned
    base, which the tensor-core kernel reads through a contiguous copy."""
    dev = torch.device("cuda")
    b, s, hq, hkv, d = 1, 512, 16, 8, 128
    q = torch.randn(b * s * hq * d + 1, generator=gen, device=dev).to(
        torch.bfloat16)[1:].view(b, s, hq, d)
    k, v = (torch.randn(b, s, hkv, d, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    check(not fa.tma_layout_ok(q), "the sliced q is aligned after all")
    before = fa.ALIGN_COPIES
    err = within(fa.flash_attention(q, k, v, True),
                 fa.flash_attention_plain(q, k, v, True), torch.bfloat16)
    copies = fa.ALIGN_COPIES - before
    check(copies == 1, f"misaligned q: {copies} copies, want 1")
    print(f"flash_attention bf16 q at a 2-byte offset: {copies} copy, "
          f"max error {err}", flush=True)
    return {"kernel": "flash_attention", "dtype": str(torch.bfloat16),
            "kernel_fn": fa.KERNEL_OF[torch.bfloat16],
            "shape": f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} causal=True, "
            f"q at a 2-byte offset", "label": "misaligned q",
            "max_abs_err": err, "align_copies": copies}


def phase8_forward_kernels():
    """The forward path's kernels against their plain versions."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    rows = []
    attn_shapes = (("qwen3 S=2048", 2, 2048, 16, 8, 128),
                   ("ragged S=1000", 1, 1000, 16, 8, 128),
                   ("MQA S=384", 1, 384, 8, 1, 128),
                   ("group 3, D=32", 2, 128, 6, 2, 32),
                   ("unpadded S=200, D=64", 2, 200, 4, 2, 64),
                   ("zamba2 D=80", 1, 2048, 32, 32, 80),
                   ("D=96", 2, 300, 8, 2, 96))
    for dtype in (torch.float32, torch.bfloat16):
        rate = BF16_TC_OPS_PER_S if dtype == torch.bfloat16 \
            else ALU_OPS_PER_S
        for label, b, s, hq, hkv, d in attn_shapes:
            q = torch.randn(b, s, hq, d, generator=gen, device=dev).to(dtype)
            k = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(dtype)
            v = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(dtype)
            for causal in (True, False):
                kernel = lambda: fa.flash_attention(q, k, v, causal)
                plain = lambda: fa.flash_attention_plain(q, k, v, causal)
                err = within(kernel(), plain(), dtype)
                nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
                bound_ms, bound_by = bound(
                    nbytes, attention_flops(b, s, hq, d, causal), rate)
                main = label.startswith(("qwen3", "zamba2"))
                row = {
                    "kernel": "flash_attention", "dtype": str(dtype),
                    "kernel_fn": fa.KERNEL_OF[dtype],
                    "shape": f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
                    f"causal={causal}", "label": label,
                    "max_abs_err": err,
                    **(time_case(kernel, plain,
                                 sdpa_causal_library(q, k, v, causal), 20)
                       if main else {}),
                    "bound_ms": bound_ms, "bound_by": bound_by}
                if main:
                    flops = attention_flops(b, s, hq, d, causal)
                    row.update(tflops=flops / row["ms"] / 1e9,
                               bound_share=bound_ms / row["ms"],
                               library_ratio=row["ms"] / row["library_ms"])
                    if dtype == torch.bfloat16:
                        # the CUDA-core design at the same shape, this run
                        f32_row = next(
                            r for r in rows if r["shape"] == row["shape"]
                            and r["dtype"] == str(torch.float32))
                        row["f32_kernel_ms"] = f32_row["ms"]
                rows.append(row)
    rows.append(misaligned_attention_row(gen))
    ssd_shapes = (("mamba2 S=2048", 1, 2048, 80, 64, 128, 1, 256),
                  ("zamba2 (P, N) = (64, 64)", 1, 2048, 80, 64, 64, 1, 256),
                  ("widest, G=2, chunk 64", 1, 1024, 16, 128, 256, 2, 64),
                  ("ragged chunk 100, P=48", 1, 300, 4, 48, 32, 2, 100),
                  ("test 1", 1, 64, 2, 16, 16, 1, 16),
                  ("test 2", 2, 128, 4, 32, 64, 2, 32),
                  ("test 3", 1, 96, 2, 64, 128, 1, 32))
    for dtype in (torch.float32, torch.bfloat16):
        rate = BF16_TC_OPS_PER_S if dtype == torch.bfloat16 \
            else ALU_OPS_PER_S
        for label, b, s, h, p, n, g, chunk in ssd_shapes:
            args = ssd_inputs(b, s, h, p, n, g, dtype, gen)
            kernel = lambda: sc.ssd_scan(*args, chunk)
            plain = lambda: sc.ssd_scan_plain(*args, chunk)
            (y, st), (y_want, st_want) = kernel(), plain()
            err = within(y, y_want, dtype, SSD_Y_TOL[dtype])
            st_err = within(st, st_want, torch.float32, SSD_STATE_TOL)
            x, dt, _, bb, cc = args[:5]
            nbytes = sum(t.numel() * t.element_size()
                         for t in (x, dt, bb, cc, y, st)) + 3 * 4 * h
            bound_ms, bound_by = bound(
                nbytes, ssd_flops(b, s, h, p, n, g, chunk), rate)
            main = label.startswith("mamba2")
            rows.append({"kernel": "ssd_scan", "dtype": str(dtype),
                         "shape": f"B={b} S={s} H={h} P={p} N={n} G={g} "
                         f"chunk={chunk}", "label": label,
                         "max_abs_err": err, "state_max_abs_err": st_err,
                         **(time_case(kernel, plain, None, 20)
                            if main else {}),
                         "bound_ms": bound_ms, "bound_by": bound_by})
    rows += rmsnorm_rows(((2048, 2560), (2048, 5120)), gen, 50)
    for r in rows:
        emit({"phase": 8, **r})
    return rows


# (label, a substring of the device kernels' names); a call of ssd_scan
# launches its four kernels (csrc/ssd_scan.cu), so its device launches
# are four a call
FORWARD_KERNELS = (("flash_attention", "flash_attention_kernel"),
                   ("ssd_scan", "ssd_scan_"),
                   ("rms_norm", "rms_norm_kernel"),
                   ("rms_norm_residual", "rms_norm_residual_kernel"))


def profile_forward(fn):
    """Wall and device time of one warm ``fn()``, from the profiler's
    device-side trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(device_us(e) for e in events)
    by_kernel = {}
    for label, key in FORWARD_KERNELS:
        hits = [e for e in events if key in e.key]
        n = sum(e.count for e in hits)
        by_kernel[label] = {"launches": n, "device_ms": sum(
            device_us(e) for e in hits) / 1e3}
    top = sorted(events, key=device_us, reverse=True)[:6]
    return {"profiled_wall_s": wall, "device_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "kernels": by_kernel,
            "top_device_ops_ms": {e.key[:60]: device_us(e) / 1e3
                                  for e in top}}


def matmul_params(cfg) -> int:
    """Weights of the per-token projections of every layer (what each
    token multiplies through), embedding and head excluded; the hybrid's
    shared block counts once an invocation."""
    specs = registry.param_specs(cfg)
    if cfg.family == "hybrid":
        mamba = sum(sp.numel() for sp in
                    layers.spec_leaves(specs["mamba_layers"])
                    if len(sp.shape) >= 4 and sp.axes[2] != "conv")
        shared = sum(sp.numel() for sp in
                     layers.spec_leaves(specs["shared_block"])
                     if len(sp.shape) >= 2)
        return mamba + shared * (cfg.n_layers // cfg.hybrid.attn_every)
    return sum(sp.numel() for sp in layers.spec_leaves(specs["layers"])
               if len(sp.shape) >= 3 and sp.axes[1] != "conv")


def forward_bound(cfg, params, tokens: int, logit_rows: int,
                  extra_flops: int, out_bytes: int):
    """The whole forward's least time: every weight read once plus the
    outputs written once, against the bf16 matrix work (projections, the
    head over ``logit_rows`` positions, and ``extra_flops``)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors(params)) + \
        out_bytes
    flops = 2 * tokens * matmul_params(cfg) + \
        2 * logit_rows * cfg.d_model * cfg.vocab_size + extra_flops
    bound_ms, bound_by = bound(nbytes, flops, BF16_TC_OPS_PER_S)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
            "bound_flops": flops}


def run_counted(fn, want: dict, what: str):
    """``fn()`` once, synchronised; checks the launches it made against
    ``want`` (every other kernel: none).  Returns (result, wall_s)."""
    before = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = ops.launch_counts()
    made = {k: after[k] - before[k] for k in after}
    check(made == {k: want.get(k, 0) for k in made},
          f"{what}: launches {made}, want {want}")
    return out, wall


def seeded_tokens(cfg, b: int, s: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s))
                            ).to("cuda")


def phase9_forward():
    """The forward path at full width; returns its launch counts."""
    out = {}
    ops.reset_launch_counts()                 # the forward path starts here
    # qwen3-1.7b: loss over 2 x 2048 tokens and prefill of 4 x 512
    arch = registry.get("qwen3-1.7b")
    cfg = arch.cfg
    t0 = time.perf_counter()
    params = arch.init_params(0, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    per_fwd = {"flash_attention": cfg.n_layers,
               "rms_norm": 1 + 2 * cfg.n_layers,
               "rms_norm_residual": 2 * cfg.n_layers}
    rt = Runtime()
    for kind, b, s in (("loss", 2, 2048), ("prefill", 4, 512)):
        batch = {"tokens": seeded_tokens(cfg, b, s, seed=90 + b)}
        if kind == "loss":
            fn = lambda: arch.loss_fn()(params, cfg, batch, rt)
        else:
            fn = lambda: arch.prefill_fn()(params, batch, rt)
        cold, cold_s = run_counted(fn, per_fwd, f"qwen3 {kind} (cold)")
        res, wall = run_counted(fn, per_fwd, f"qwen3 {kind}")
        if kind == "loss":
            check(res.dim() == 0 and bool(torch.isfinite(res)),
                  f"qwen3 loss {res}")
            value = float(res)
            repeat = float(cold) == value
            out_bytes = 4
            logit_rows = b * (s - 1)
        else:
            logits, cache = res
            check(logits.shape == (b, cfg.vocab_size)
                  and bool(torch.isfinite(logits).all()),
                  "qwen3 prefill logits")
            check(cache["k"].shape == (cfg.n_layers, b, s, cfg.n_kv_heads,
                                       cfg.head_dim_)
                  and bool(torch.isfinite(cache["k"]).all()),
                  "qwen3 prefill cache")
            value = float(logits.float().abs().max())
            repeat = torch.equal(logits, cold[0])
            out_bytes = logits.numel() * logits.element_size() + 2 * \
                cache["k"].numel() * cache["k"].element_size()
            logit_rows = b
            del logits, cache
        del res, cold
        prof = profile_forward(fn)
        attn = attention_flops(b, s, cfg.n_heads, cfg.head_dim_, True) * \
            cfg.n_layers
        out[f"qwen3-1.7b {kind}"] = {
            "batch": b, "seq": s, "layers": cfg.n_layers,
            "value": value, "same_as_cold_run": repeat,
            "launches_per_forward": per_fwd,
            "cold_wall_s": cold_s, "wall_s": wall,
            "tokens_per_s": b * s / wall, **prof,
            **forward_bound(cfg, params, b * s, logit_rows, attn, out_bytes)}
    out["qwen3-1.7b setup_s"] = setup_s
    del params
    torch.cuda.empty_cache()

    # mamba2-2.7b: loss over 1 x 2048 tokens
    arch = registry.get("mamba2-2.7b")
    cfg = arch.cfg
    params = arch.init_params(0, "cuda", torch.bfloat16)
    d_inner = cfg.ssm.expand * cfg.d_model
    per_fwd = {"ssd_scan": cfg.n_layers, "rms_norm": 1 + cfg.n_layers,
               "rms_norm_residual": cfg.n_layers}
    b, s = 1, 2048
    batch = {"tokens": seeded_tokens(cfg, b, s, seed=93)}
    fn = lambda: arch.loss_fn()(params, cfg, batch, rt)
    cold, cold_s = run_counted(fn, per_fwd, "mamba2 loss (cold)")
    res, wall = run_counted(fn, per_fwd, "mamba2 loss")
    check(res.dim() == 0 and bool(torch.isfinite(res)), f"mamba2 loss {res}")
    prof = profile_forward(fn)
    scan = ssd_flops(b, s, d_inner // cfg.ssm.head_dim, cfg.ssm.head_dim,
                     cfg.ssm.d_state, cfg.ssm.n_groups, cfg.ssm.chunk) * \
        cfg.n_layers
    out["mamba2-2.7b loss"] = {
        "batch": b, "seq": s, "layers": cfg.n_layers, "value": float(res),
        "same_as_cold_run": float(res) == float(cold),
        "launches_per_forward": per_fwd, "cold_wall_s": cold_s,
        "wall_s": wall, "tokens_per_s": b * s / wall, **prof,
        **forward_bound(cfg, params, b * s, b * (s - 1), scan, 4)}
    launches = ops.launch_counts()            # ... and ends here
    emit({"phase": 9, "params_qwen3": registry.get("qwen3-1.7b").cfg
          .param_count(), "params_mamba2": cfg.param_count(),
          "launches": launches, **out})
    del params, res, cold
    torch.cuda.empty_cache()
    return launches


FORWARD_TOL = 5e-4      # logits, float32, 4 layers: kernels vs plain
LOSS_RTOL = 1e-4


def phase10_forward_vs_plain():
    """The forwards in float32 at 4 layers, full width: kernels against
    the plain versions, and prefill -> decode against a longer prefill."""
    plain = Runtime(kernels="plain")
    rt = Runtime()
    res = {}
    cfg = dataclasses.replace(registry.get("qwen3-1.7b").cfg, n_layers=4)
    arch = registry.Arch(cfg)
    params = arch.init_params(2, "cuda", torch.float32)
    b, s = 2, 512
    batch = {"tokens": seeded_tokens(cfg, b, s, seed=100)}
    loss_k, _ = run_counted(lambda: arch.loss_fn()(params, cfg, batch, rt),
                            {"flash_attention": 4, "rms_norm": 9,
                             "rms_norm_residual": 8}, "qwen3 f32 loss")
    loss_p, _ = run_counted(lambda: arch.loss_fn()(params, cfg, batch,
                                                   plain), {},
                            "qwen3 f32 plain loss")
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    check(rel <= LOSS_RTOL, f"qwen3 f32 loss {loss_k} vs plain {loss_p}")
    (lk, ck), _ = run_counted(lambda: arch.prefill_fn()(params, batch, rt),
                              {"flash_attention": 4, "rms_norm": 9,
                               "rms_norm_residual": 8}, "qwen3 f32 prefill")
    (lp, cp), _ = run_counted(lambda: arch.prefill_fn()(params, batch,
                                                        plain), {},
                              "qwen3 f32 plain prefill")
    logit_err = within(lk, lp, torch.float32, FORWARD_TOL, "qwen3 logits")
    cache_err = max(within(ck[k], cp[k], torch.float32, FORWARD_TOL,
                           "qwen3 cache")
                    for k in ("k", "v"))
    # prefill of s - 1 tokens into an s-position cache, one decode step
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim_)
    cache = {k: torch.zeros(shape, device="cuda") for k in ("k", "v")}
    arch.prefill_fn()(params, {"tokens": batch["tokens"][:, :-1]}, rt,
                      cache=cache)
    step, _ = run_counted(
        lambda: transformer.decode_step(
            params, cfg, cache, batch["tokens"][:, -1:],
            torch.full((b,), s - 1, dtype=torch.int32, device="cuda"), rt),
        {"flash_decode": 4, "rms_norm": 9, "rms_norm_residual": 8},
        "qwen3 f32 decode step")
    decode_err = within(step[0], lk, torch.float32, FORWARD_TOL,
                        "prefill -> decode vs prefill")
    res["qwen3-1.7b"] = {"layers": 4, "batch": b, "seq": s,
                         "loss_kernels": float(loss_k),
                         "loss_plain": float(loss_p), "loss_rel_err": rel,
                         "prefill_logits_max_abs_err": logit_err,
                         "prefill_cache_max_abs_err": cache_err,
                         "prefill_decode_max_abs_err": decode_err}
    del params, ck, cp, cache
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(registry.get("mamba2-2.7b").cfg, n_layers=4)
    arch = registry.Arch(cfg)
    params = arch.init_params(3, "cuda", torch.float32)
    b, s = 1, 2048
    batch = {"tokens": seeded_tokens(cfg, b, s, seed=101)}
    want = {"ssd_scan": 4, "rms_norm": 5, "rms_norm_residual": 4}
    loss_k, _ = run_counted(lambda: arch.loss_fn()(params, cfg, batch, rt),
                            want, "mamba2 f32 loss")
    loss_p, _ = run_counted(lambda: arch.loss_fn()(params, cfg, batch,
                                                   plain), {},
                            "mamba2 f32 plain loss")
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    check(rel <= LOSS_RTOL, f"mamba2 f32 loss {loss_k} vs plain {loss_p}")
    last = {}
    for key, r in (("kernels", rt), ("plain", plain)):
        h = registry._ssm_hidden(params, cfg, batch["tokens"], r)
        last[key] = h[:, -1] @ params["lm_head"]
    logit_err = within(last["kernels"], last["plain"], torch.float32,
                       FORWARD_TOL, "mamba2 last logits")
    res["mamba2-2.7b"] = {"layers": 4, "batch": b, "seq": s,
                          "loss_kernels": float(loss_k),
                          "loss_plain": float(loss_p), "loss_rel_err": rel,
                          "last_logits_max_abs_err": logit_err}
    emit({"phase": 10, "dtype": "float32", "logits_tol": FORWARD_TOL,
          "loss_rtol": LOSS_RTOL, **res})
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the training plane (phases 11-13)
# ---------------------------------------------------------------------------

TRAIN_WORKERS = 2


def train_plan(cfg, workers: int = TRAIN_WORKERS):
    """The bucket plan of ``cfg``'s bf16 gradients (what the compressed
    reduction of phase 12 cuts them into), from shapes alone; and the
    largest bucket's per-worker shard length."""
    specs = registry.param_specs(cfg)
    like = layers.map_specs(lambda sp: torch.empty(
        sp.shape, dtype=torch.bfloat16, device="meta"), specs)
    plan = gradsync.make_plan(like, target_bytes=steps.BUCKET_BYTES)
    shard = max(-(-plan.bucket_size(b) // workers)
                for b in range(plan.n_buckets))
    return plan, shard


def quantize_row(x, block: int, label: str, out_dtype, iters: int):
    """quantize and dequantize of ``x`` against their plain versions
    (identical or fail), with times, device operations a call and byte
    bounds."""
    n = x.numel()
    q, s = qz.quantize(x, block)
    q_p, s_p = qz.quantize_plain(x, block)
    back = qz.dequantize(q, s, block, out_dtype)
    back_p = qz.dequantize_plain(q, s, block, out_dtype)
    torch.cuda.synchronize()
    check(torch.equal(q, q_p) and torch.equal(s, s_p),
          f"quantize {label}: not identical to the plain version (max |dq| "
          f"{int((q.int() - q_p.int()).abs().max())}, max |ds| "
          f"{float((s - s_p).abs().max())})")
    check(torch.equal(back, back_p),
          f"dequantize {label}: not identical to the plain version")
    out_size = torch.empty((), dtype=out_dtype).element_size()
    rows = []
    for name, kernel, plain, nbytes in (
            ("quantize", lambda: qz.quantize(x, block),
             lambda: qz.quantize_plain(x, block),
             n * x.element_size() + n + 4 * (n // block)),
            ("dequantize", lambda: qz.dequantize(q, s, block, out_dtype),
             lambda: qz.dequantize_plain(q, s, block, out_dtype),
             n + 4 * (n // block) + n * out_size)):
        bound_ms, bound_by = bound(nbytes, n)
        rows.append({"kernel": name, "dtype": str(x.dtype)
                     if name == "quantize" else str(out_dtype),
                     "shape": label, "n": n, "block": block,
                     "max_abs_err": 0, "identical": True,
                     **time_case(kernel, plain, None, iters),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": nbytes})
    return rows


def phase11_quantize():
    """Both quantize kernels against their plain versions, bit for bit:
    the reference tests' shapes, 2**24 elements, a block of 100,003 (no
    multiple of 4 or 8; also from an x that is not 16-byte aligned),
    fewer tiles than the persistent grid's CTAs, zeros and .5 ties, and
    the main path's largest bucket shard (qwen3-1.7b, W = 2)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    _, shard = train_plan(registry.get("qwen3-1.7b").cfg)
    rows = []
    for n, block in ((2048, 2048), (8192, 2048), (4096, 512),
                     (1 << 24, 2048), (3 * 100_003, 100_003),
                     (2 * 40_000, 40_000)):
        for dtype in (torch.float32, torch.bfloat16):
            x = (3 * torch.randn(n, generator=gen, device="cuda")).to(dtype)
            rows += quantize_row(x, block, f"n={n} block={block}", dtype,
                                 200 if n < 1 << 20 else 50)
            zeros = torch.zeros(n, dtype=dtype, device="cuda")
            quantize_row(zeros, block, f"zeros n={n} block={block}", dtype,
                         1)
            # absmax 127 in every block (scale exactly 1), every .5 tie
            ties = (torch.arange(n, device="cuda") % 509 - 254).float() / 2
            ties.view(-1, block)[:, 0] = 127.0
            quantize_row(ties.to(dtype), block, f"ties n={n} block={block}",
                         dtype, 1)
            if block == 100_003:      # x 2 or 4 bytes past 16-byte alignment
                buf = (3 * torch.randn(n + 1, generator=gen,
                                       device="cuda")).to(dtype)
                rows += quantize_row(buf[1:], block,
                                     f"misaligned n={n} block={block}",
                                     dtype, 50)
    n = TRAIN_WORKERS * shard
    x = 1e-3 * torch.randn(n, generator=gen, device="cuda")
    rows += quantize_row(x, shard, f"n={n} block={shard}", torch.float32, 10)
    for r in rows:
        emit({"phase": 11, **r})
    del x
    torch.cuda.empty_cache()
    return rows


def forward_launches(cfg) -> dict:
    """Launches of one loss forward of any family: the recurrent
    families' (:func:`recurrent_forward_launches`), the encdec's
    (:func:`encdec_launches`), a decoder stack's
    (:func:`decoder_launches`; the vlm adds its projector's norm)."""
    if cfg.family in ("ssm", "hybrid"):
        return recurrent_forward_launches(cfg)
    if cfg.family == "encdec":
        return encdec_launches(cfg, False)
    want = decoder_launches(cfg, "flash_attention")
    if cfg.family == "vlm":
        want["rms_norm"] += 1
    return want


def train_launches(cfg, workers: int, buckets: int) -> dict:
    """Launches per train step: every forward kernel site once per
    layer per worker (the backward launches nothing); one quantize and
    one dequantize per bucket when ``buckets``."""
    want = {k: v * workers for k, v in forward_launches(cfg).items()}
    if buckets:
        want.update(quantize=buckets, dequantize=buckets)
    return want


# the kernel sites outside every checkpointed region of a loss: each
# stack's final norm and the vlm projector's norm
REMAT_OUTSIDE = {"dense": {"rms_norm_residual": 1},
                 "moe": {"rms_norm_residual": 1},
                 "ssm": {"rms_norm_residual": 1},
                 "hybrid": {"rms_norm_residual": 1},
                 "vlm": {"rms_norm": 1, "rms_norm_residual": 1},
                 "encdec": {"rms_norm_residual": 2}}


def remat_launches(cfg, remat: str, workers: int) -> dict:
    """Launches of ``workers`` loss forwards and backwards under
    ``Runtime(remat=remat)``: the forward's, and under ``full`` and
    ``dots`` every site inside a region once more in the backward's
    rerun (2 x forward - REMAT_OUTSIDE: the rerun stops at a region's
    trailing product, after its last site, as tests/test_torch_remat.py
    pins on the CPU)."""
    fwd = forward_launches(cfg)
    if remat != "none":
        out = REMAT_OUTSIDE[cfg.family]
        fwd = {k: 2 * v - out.get(k, 0) for k, v in fwd.items()}
    return {k: v * workers for k, v in fwd.items()}


def launches_since(before: dict) -> dict:
    after = ops.launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] - before[k]}


def timed(fn):
    """(result, seconds) of ``fn()`` between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def train_bound(cfg, params, b: int, s: int) -> dict:
    """A train step's least time: the matrix work (forward and backward,
    3x the forward's: the per-token projections, the tied head and the
    causal attention) at the bf16 peak, against the bytes AdamW must
    move (gradients and parameters read and written once, the float32
    master, m and v read and written once)."""
    tokens = b * s
    n_params = sum(t.numel() for t in tensors(params))
    fwd = 2 * tokens * matmul_params(cfg) + \
        2 * b * (s - 1) * cfg.d_model * cfg.vocab_size + \
        attention_flops(b, s, cfg.n_heads, cfg.head_dim_, True) * \
        cfg.n_layers
    nbytes = n_params * (2 * 2 + 2 * 12)
    bound_ms, bound_by = bound(nbytes, 3 * fwd, BF16_TC_OPS_PER_S)
    return {"bound_ms": bound_ms, "bound_by": bound_by,
            "bound_flops": 3 * fwd, "bound_bytes": nbytes}


# device kernels of each wrapper, by the names the profiler records
TRAIN_KERNELS = tuple((label, (key,)) for label, key in FORWARD_KERNELS) + (
    ("quantize", ("quantize_fused_kernel", "quantize_cooperative_kernel")),
    ("dequantize", ("dequantize_kernel",)))


def profile_step(fn):
    """Device time and busy share of one warm ``fn()``, with the device
    time of the port's kernels and the top operations."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(device_us(e) for e in events)
    by_kernel = {}
    for label, keys in TRAIN_KERNELS:
        hits = [e for e in events if any(k in e.key for k in keys)]
        by_kernel[label] = {"launches": sum(e.count for e in hits),
                            "device_ms": sum(device_us(e)
                                             for e in hits) / 1e3}
    top = sorted(events, key=device_us, reverse=True)[:8]
    return {"profiled_wall_s": wall, "device_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "kernels": by_kernel,
            "top_device_ops_ms": {e.key[:60]: device_us(e) / 1e3
                                  for e in top}}


def phase12_train():
    """The training plane at qwen3-1.7b's full width: ``Trainer`` with
    the compressed Spindle reduction over W = 2 workers folded onto the
    card, 3 steps; returns the train path's launch counts."""
    arch = registry.get("qwen3-1.7b")
    cfg = arch.cfg
    b, s = 2, 2048
    rt = Runtime(gradsync="spindle_compressed", dp_workers=TRAIN_WORKERS)
    tcfg = api.TrainConfig(steps=3, seq_len=s, global_batch=b, log_every=1)
    torch.cuda.reset_peak_memory_stats()
    trainer = api.Trainer("qwen3-1.7b", cfg, tcfg, rt, device="cuda")
    (params, opt), setup_s = timed(lambda: trainer.init_state(0))
    plan, shard = train_plan(cfg)
    want = train_launches(cfg, TRAIN_WORKERS, plan.n_buckets)
    walls, per_step = [], []
    mark = {"t": None, "counts": None}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls.append(now - mark["t"])
        per_step.append(launches_since(mark["counts"]))
        mark["t"], mark["counts"] = time.perf_counter(), ops.launch_counts()

    ops.reset_launch_counts()                 # the train path starts here
    torch.cuda.synchronize()
    mark["t"], mark["counts"] = time.perf_counter(), ops.launch_counts()
    params, opt = trainer.run(params, opt, on_step=on_step)
    launches = ops.launch_counts()            # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    for i, made in enumerate(per_step):
        check(made == want, f"train step {i + 1}: launches {made}, want "
              f"{want}")
    losses = [h["loss"] for h in trainer.history]
    check(len(losses) == 3 and all(math.isfinite(x) and 10.0 < x < 14.0
                                   for x in losses),
          f"train losses {losses} (want finite, near ln V = "
          f"{math.log(cfg.vocab_size):.2f})")

    # one warm step under the profiler, and the same step taken apart
    step_fn = steps.make_train_step(arch, rt, param_dtype=torch.bfloat16,
                                    donate=True)
    batch = trainer._batch_for(3)
    prof = profile_step(lambda: step_fn(params, opt, batch))
    worker = steps.worker_grads(arch, rt)
    (_, stacked), grads_s = timed(lambda: worker(params, batch))
    mean, reduce_s = timed(lambda: steps.reduce_grads(stacked, rt))
    spindle = Runtime(gradsync="spindle", dp_workers=TRAIN_WORKERS)
    fused, fused_s = timed(lambda: steps.reduce_grads(stacked, spindle))
    del stacked, fused
    _, update_s = timed(lambda: adamw.update(tcfg.opt, mean, opt,
                                             torch.bfloat16, params=params))
    del mean
    # and one warm step of the uncompressed fused-bucket reduction
    spindle_step = steps.make_train_step(arch, spindle, donate=True)
    (_, _, m), spindle_wall = timed(lambda: spindle_step(params, opt, batch))
    check(math.isfinite(float(m["loss"])), "spindle step loss")
    remat, remat_counts = phase12_remat(arch, params, batch, rt)
    parts = grads_s + reduce_s + update_s
    emit({"phase": 12, "model": "qwen3-1.7b", "layers": cfg.n_layers,
          "batch": b, "seq": s, "workers": TRAIN_WORKERS,
          "gradsync": rt.gradsync, "buckets": plan.n_buckets,
          "largest_shard": shard, "setup_s": setup_s,
          "losses": losses, "history": trainer.history,
          "launches_per_step": want, "step_wall_s": walls,
          "tokens_per_s": [b * s / w for w in walls],
          "peak_memory_bytes": peak, **prof,
          "warm_step_parts_s": {"worker_grads": grads_s,
                                "reduce_compressed": reduce_s,
                                "adamw_update": update_s},
          "reduce_share": reduce_s / parts, "adamw_share": update_s / parts,
          "reduce_fused_uncompressed_s": fused_s,
          "spindle_step_wall_s": spindle_wall,
          "spindle_step_loss": float(m["loss"]),
          **train_bound(cfg, params, b, s)})
    emit({"phase": 12, "part": "remat", **remat})
    del params, opt, trainer, step_fn, spindle_step
    torch.cuda.empty_cache()
    return dict(collections.Counter(launches) + remat_counts)


REMAT_POLICIES = ("none", "full", "dots")
REMAT_SEQ = 4096              # train_4k's sequence length


def remat_call(arch, rt, params, batch, what: str):
    """Two calls of ``steps.worker_grads(arch, rt)``, the first to warm:
    each call's launches held to :func:`remat_launches`; returns the
    second's (losses, grads) and its wall, its peak memory and that peak
    above what the call found allocated."""
    fn = steps.worker_grads(arch, rt)
    want = remat_launches(arch.cfg, rt.remat, rt.dp_workers)
    run_counted(lambda: fn(params, batch), want, f"{what} (warm-up)")
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, wall = run_counted(lambda: fn(params, batch), want, what)
    peak = torch.cuda.max_memory_allocated()
    return out, {"wall_s": wall, "peak_bytes": peak,
                 "peak_above_base_bytes": peak - base,
                 "launches": want}


def grad_distance(got, want) -> dict:
    """Per leaf max |got - want| over the leaf's largest |want|; whether
    every leaf is bit-identical."""
    errs = {path: float((a - c).abs().max()) / (float(c.abs().max())
                                                 or 1.0)
            for (path, a), c in zip(tree_util.paths(got),
                                    tree_util.leaves(want))}
    worst = max(errs, key=errs.get)
    return {"max": errs[worst], "leaf": worst,
            "bit_identical": all(torch.equal(a, c) for a, c in zip(
                tree_util.leaves(got), tree_util.leaves(want)))}


def meta_peak_bytes(arch, rt, b: int, s: int) -> int:
    """The dry-run's estimate of ``worker_grads``' temporary memory at
    (b, s): the peak of the live ``meta`` tensors the call allocates
    (:mod:`repro_torch.launch.opanalysis`), nothing on the card."""
    params = layers.abstract_tree(arch.param_specs())
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32,
                                   device="meta")}
    with opanalysis.OpAnalysis() as an:
        out = steps.worker_grads(arch, rt)(params, batch)
        del out
    return an.peak_bytes


def phase12_remat(arch, params, batch, rt):
    """Rematerialisation on phase 12's model: ``worker_grads`` at phase
    12's shape (2 x 2048, W = 2, the same params and batch) under each
    policy, warm: losses bit-identical to ``none``'s, every gradient leaf
    within GRAD_TOL's dense bar of ``none``'s, the exact launches, wall
    and peak; ``full``'s peak under ``none``'s and ``dots``' no higher.
    Then one warm call at 1 x 4096, W = 1 under ``none`` and ``full``,
    with the dry-run's live-meta estimate of the same call.  Returns the
    record and the launches of the ``full`` and ``dots`` calls."""
    cfg = arch.cfg
    bar = GRAD_TOL["dense"]
    t0 = time.perf_counter()
    counts = collections.Counter()
    out = {"model": "qwen3-1.7b", "batch": 2, "seq": 2048,
           "workers": rt.dp_workers, "gradsync": rt.gradsync, "bar": bar}
    (ref_losses, ref_grads), out["none"] = remat_call(
        arch, rt, params, batch, "phase 12 remat none")
    for remat in ("full", "dots"):
        r = dataclasses.replace(rt, remat=remat)
        (losses, grads), row = remat_call(arch, r, params, batch,
                                          f"phase 12 remat {remat}")
        check(torch.equal(losses, ref_losses), f"phase 12 remat {remat}: "
              f"losses {losses.tolist()} != none's {ref_losses.tolist()}")
        dist = grad_distance(grads, ref_grads)
        check(dist["max"] <= bar, f"phase 12 remat {remat}: gradient "
              f"{dist['leaf']} {dist['max']} of its max (bar {bar})")
        del grads
        row.update(grad_vs_none=dist, losses_bit_identical=True,
                   wall_over_none=row["wall_s"] / out["none"]["wall_s"])
        out[remat] = row
        counts.update({k: 2 * v for k, v in row["launches"].items()})
    del ref_grads
    none_peak = out["none"]["peak_above_base_bytes"]
    check(out["full"]["peak_above_base_bytes"] < none_peak,
          f"phase 12 remat: full's peak {out['full']} is not under none's "
          f"{none_peak}")
    check(out["dots"]["peak_above_base_bytes"] <= none_peak,
          f"phase 12 remat: dots' peak {out['dots']} is over none's "
          f"{none_peak}")
    torch.cuda.empty_cache()

    # train_4k's length on one card: one row, one worker
    long = {"tokens": seeded_tokens(cfg, 1, REMAT_SEQ, 12)}
    out["seq_4096"] = {"batch": 1, "seq": REMAT_SEQ, "workers": 1}
    for remat in ("none", "full"):
        r = Runtime(remat=remat)
        (losses, grads), row = remat_call(arch, r, params, long,
                                          f"phase 12 remat {remat} 1x4096")
        check(bool(torch.isfinite(losses).all()),
              f"phase 12 remat {remat} 1x4096: loss {losses.tolist()}")
        del grads
        row["loss"] = float(losses[0])
        row["dryrun_meta_peak_bytes"] = meta_peak_bytes(arch, r, 1,
                                                        REMAT_SEQ)
        row["meta_over_measured"] = (row["dryrun_meta_peak_bytes"]
                                     / row["peak_above_base_bytes"])
        out["seq_4096"][remat] = row
        if remat == "full":
            counts.update({k: 2 * v for k, v in row["launches"].items()})
        torch.cuda.empty_cache()
    s4 = out["seq_4096"]
    check(s4["full"]["peak_above_base_bytes"]
          < s4["none"]["peak_above_base_bytes"],
          f"phase 12 remat 1x4096: full's peak is not under none's: {s4}")
    check(s4["full"]["loss"] == s4["none"]["loss"],
          f"phase 12 remat 1x4096: losses differ: {s4}")
    out["part_s"] = time.perf_counter() - t0
    return out, counts


TRAIN_LOSS_RTOL = 1e-5
# per-worker gradients, kernels vs plain, as a share of each leaf's
# largest |g|: 1e-4 for the dense family.  The ssm family's stays the
# phase-10 bar of its forward (FORWARD_TOL): its backward amplifies the
# forward kernels' last-bit differences to ~1e-4 of the embedding's
# gradient even where those kernels match their plain versions to a few
# ulps (the SSD scan's prefix sums bit for bit); phase 13 reports the
# error with only the SSD or only the RMSNorm sites on their kernels, and
# holds both float32 runs against the plain path in float64 (the plain
# float32 path is itself that far from float64: float64_yardstick).  The
# hybrid family's is the same bar for the same reason: zamba2's plain
# float32 gradient at 4 layers is 1.17e-4 of its embedding's largest |g|
# from float64 in phase 35, over the dense bar.
GRAD_TOL = {"dense": 1e-4, "ssm": FORWARD_TOL, "hybrid": FORWARD_TOL}


def grad_tol(cfg) -> float:
    """The family's GRAD_TOL; a family without an entry takes the dense
    bar."""
    return GRAD_TOL.get(cfg.family, GRAD_TOL["dense"])


def rms_norm_variant(order: str):
    """``(rms_norm, rms_norm_residual)`` in plain float32 that round
    differently from the plain versions: the sum of squares in 16 blocks
    and then across them with ``rsqrt`` as the plain versions
    (``"blocked"``), or serially, divided by the width as a tensor and
    inverted as ``1 / sqrt`` as the kernels do (``"serial"``).  Plain
    float32 implementations for :func:`float64_yardstick`'s band."""
    def inv_rms(r, eps):
        sq = r.square()
        if order == "serial":
            total = sq.cumsum(-1)[..., -1:]
        else:
            blocks = 16 if sq.shape[-1] % 16 == 0 else 1
            total = sq.unflatten(-1, (blocks, -1)).sum(-1).sum(
                -1, keepdim=True)
        var = total / torch.full_like(total, r.shape[-1])
        if order == "serial":
            return 1 / torch.sqrt(var + eps)
        return torch.rsqrt(var + eps)

    def norm(x, w, eps=1e-6):
        xf = x.float()
        return (xf * inv_rms(xf, eps) * w.float()).to(x.dtype)

    def norm_residual(x, res, w, eps=1e-6):
        r = res.float() + x.float()
        return (r * inv_rms(r, eps) * w.float()).to(x.dtype), r.to(x.dtype)
    return norm, norm_residual


@dataclasses.dataclass(frozen=True)
class VariantRuntime(Runtime):
    """The plain versions everywhere, the RMSNorm sites on
    :func:`rms_norm_variant` (``order``)."""
    order: str = "blocked"

    def op(self, name):
        if name in ("rms_norm", "rms_norm_residual"):
            return rms_norm_variant(self.order)[name == "rms_norm_residual"]
        return ops.PLAIN[name]


@dataclasses.dataclass(frozen=True)
class SiteRuntime(Runtime):
    """A Runtime whose kernel sites in ``on_kernels`` launch their kernels
    and whose other sites run their plain versions."""
    on_kernels: tuple = ()

    def op(self, name):
        kernels = "kernels" if name in self.on_kernels else "plain"
        return Runtime.op(dataclasses.replace(self, kernels=kernels), name)


def grad_errors_by_site(arch, params, batch, rt, sites: dict):
    """For each ``{label: kernel sites}``, the largest per-worker gradient
    error (a share of each leaf's largest |g|) against the plain run when
    only those sites launch their kernels."""
    _, g_p = steps.worker_grads(
        arch, dataclasses.replace(rt, kernels="plain"))(params, batch)
    out = {}
    for label, on in sites.items():
        site_rt = SiteRuntime(gradsync=rt.gradsync,
                              dp_workers=rt.dp_workers, on_kernels=on)
        _, g = steps.worker_grads(arch, site_rt)(params, batch)
        errs = {path: float((a - c).abs().max()) / (float(c.abs().max())
                                                    or 1.0)
                for (path, a), c in zip(tree_util.paths(g),
                                        tree_util.leaves(g_p))}
        worst = max(errs, key=errs.get)
        out[label] = {"max": errs[worst], "leaf": worst}
        del g
    return out


def grads_of(arch, rt, params, batch, worker=None):
    """``(losses, gradients)``: every worker's, stacked
    (``steps.worker_grads``), or worker ``worker``'s alone
    (``steps.value_and_grad`` on its rows, the w-th slice of
    ``worker_grads``: for a model whose W stacked trees do not fit on the
    card beside each other)."""
    if worker is None:
        return steps.worker_grads(arch, rt)(params, batch)
    rows = {k: v.tensor_split(rt.dp_workers)[worker]
            for k, v in batch.items()}
    return steps.value_and_grad(arch, rt)(params, rows)


def compare_worker_grads(arch, params, batch, rt, plain, what: str,
                         worker=None):
    """Per-worker gradients (every worker's, or worker ``worker``'s: see
    :func:`grads_of`) on the kernels against the plain versions (each
    leaf within GRAD_TOL of its largest entry); returns both runs'
    gradients, the largest relative error and the losses' relative
    error."""
    want = (train_launches(arch.cfg, rt.dp_workers, 0) if worker is None
            else forward_launches(arch.cfg))
    (loss_k, g_k), _ = run_counted(
        lambda: grads_of(arch, rt, params, batch, worker), want,
        f"{what} worker grads")
    (loss_p, g_p), _ = run_counted(
        lambda: grads_of(arch, plain, params, batch, worker), {},
        f"{what} plain worker grads")
    rel = float(((loss_k - loss_p).abs() / loss_p.abs()).max())
    check(rel <= TRAIN_LOSS_RTOL, f"{what} worker losses {loss_k} vs "
          f"{loss_p}")
    errs = {}
    for (path, a), c in zip(tree_util.paths(g_k), tree_util.leaves(g_p)):
        errs[path] = float((a - c).abs().max()) / (float(c.abs().max())
                                                    or 1.0)
    worst = max(errs, key=errs.get)
    tol = grad_tol(arch.cfg)
    check(errs[worst] <= tol, f"{what} gradient {worst}: {errs[worst]} of "
          f"its max (bar {tol}); every leaf: {errs}")
    return g_k, g_p, {"max": errs[worst], "leaf": worst, "bar": tol,
                      "per_leaf": errs}, rel


# the float64 yardstick: a float32 path's gradients are no further from
# float64 than twice the plain float32 path's, plus this share of each
# leaf's largest |g| (float32 rounding of a gradient far below its leaf's
# largest entry)
YARDSTICK_FLOOR = 1e-6
# plain float32 implementations that round differently from the plain
# path (:class:`VariantRuntime`): with a band, the rule's reference is the
# furthest of them and the plain path from float64, leaf by leaf
YARDSTICK_BAND = {"rms_blocked": VariantRuntime(order="blocked"),
                  "rms_serial": VariantRuntime(order="serial")}


def float64_yardstick(arch, params, batch, rt, g_k, g_p, what: str,
                      worker=None, band: bool = False, sites=None):
    """The plain path's per-worker gradients (``worker`` as in
    :func:`grads_of`) in float64 (the weights cast up; every step of the
    plain path then computes in float64) against both float32 runs, per
    leaf as a share of the leaf's largest float64 |g|: ``e_kernel`` for
    the kernels, ``e_plain`` for the plain versions.  Fails unless
    e_kernel <= 2 e_ref + YARDSTICK_FLOOR on every leaf, where e_ref is
    e_plain, or with ``band`` the largest of e_plain and the distances of
    YARDSTICK_BAND's plain float32 implementations (reported beside the
    rule against e_plain alone, and the leaves where the band's members
    break that rule themselves).  ``sites`` ({label: kernel sites}): the
    distances with only those sites on their kernels, reported."""
    p64 = tree_util.map(lambda t: t.double(), params)
    plain = dataclasses.replace(rt, kernels="plain")
    (loss64, g64), wall = run_counted(
        lambda: grads_of(arch, plain, p64, batch, worker), {},
        f"{what} float64 plain worker grads")
    del p64
    paths = [path for path, _ in tree_util.paths(g64)]
    tops = []
    for path, y in zip(paths, tree_util.leaves(g64)):
        check(y.dtype == torch.float64, f"{what} float64 gradient {path} "
              f"is {y.dtype}")
        tops.append(float(y.abs().max()) or 1.0)

    def distance(g) -> dict:
        return {path: float((a.double() - y).abs().max()) / top
                for path, a, y, top in zip(paths, tree_util.leaves(g),
                                           tree_util.leaves(g64), tops)}

    def rule(e, ref) -> dict:
        return {k: (e[k], ref[k]) for k in e
                if e[k] > 2 * ref[k] + YARDSTICK_FLOOR}

    e_kernel, e_plain = distance(g_k), distance(g_p)
    runs = {label: dataclasses.replace(v, gradsync=rt.gradsync,
                                       dp_workers=rt.dp_workers)
            for label, v in YARDSTICK_BAND.items()} if band else {}
    runs.update({label: SiteRuntime(gradsync=rt.gradsync,
                                    dp_workers=rt.dp_workers, on_kernels=on)
                 for label, on in (sites or {}).items()})
    extra = {}
    for label, r in runs.items():
        _, g = grads_of(arch, r, params, batch, worker)
        extra[label] = distance(g)
        del g
    del g64
    e_ref = {k: max([e_plain[k]] + [extra[b][k] for b in YARDSTICK_BAND
                                     if b in extra]) for k in e_plain}
    broken = rule(e_kernel, e_ref)
    check(not broken, f"{what}: the kernels' gradients are further from "
          f"float64 than twice the {'band' if band else 'plain path'}'s at "
          f"{broken} (e_kernel, e_ref)")
    worst = max(e_kernel, key=e_kernel.get)
    out = {"e_kernel": e_kernel, "e_plain": e_plain,
           "max_e_kernel": e_kernel[worst], "max_e_kernel_leaf": worst,
           "max_e_plain": max(e_plain.values()),
           "max_ratio": max(e_kernel[k] / e_plain[k] for k in e_kernel
                            if e_plain[k] > 0),
           "floor": YARDSTICK_FLOOR, "loss_float64": loss64.tolist(),
           "wall_s": wall}
    if band:
        out["band"] = {b: extra[b] for b in YARDSTICK_BAND}
        out["rule_against_plain_alone_broken_by"] = {
            label: rule(e, e_plain) for label, e in
            (("kernels", e_kernel), *((b, extra[b]) for b in YARDSTICK_BAND))}
    for label in sites or {}:
        e = extra[label]
        top = max(e, key=e.get)
        out.setdefault("one_site_on_kernels", {})[label] = {
            "max": e[top], "leaf": top,
            "rule_against_plain_alone_broken_at": sorted(rule(e, e_plain))}
    return out


def compare_first_step(arch, params, batch, rt, plain, opt_cfg, what):
    """One train step on the kernels and on the plain versions: the loss
    within TRAIN_LOSS_RTOL, the master weights within 2 lr_1 + 1e-6 (a
    first AdamW step is a sign step: a gradient near zero may flip).
    Each step updates a copy of the parameters in place, and the kernel
    step's master weights wait on the host during the plain step, so a
    2 B-parameter model's two steps fit on the card."""
    out = {}
    for key, r in (("kernels", rt), ("plain", plain)):
        p = tree_util.map(torch.clone, params)
        _, o, m = steps.make_train_step(arch, r, opt_cfg,
                                        param_dtype=torch.float32,
                                        donate=True)(p, adamw.init(p), batch)
        master = o["master"]
        if key == "kernels":
            master = tree_util.map(lambda t: t.cpu(), master)
        out[key] = (master, m)
        del p, o
    (mk, met_k), (mp, met_p) = out["kernels"], out["plain"]
    lr1 = float(met_k["lr"])
    err = max(float((a.to(c.device) - c).abs().max()) for a, c in
              zip(tree_util.leaves(mk), tree_util.leaves(mp)))
    check(err <= 2 * lr1 + 1e-6, f"{what} master after step 1: {err}")
    rel = abs(float(met_k["loss"]) - float(met_p["loss"])) / \
        abs(float(met_p["loss"]))
    check(rel <= TRAIN_LOSS_RTOL, f"{what} step-1 loss {met_k['loss']} vs "
          f"{met_p['loss']}")
    return {"master_max_abs_err": err, "lr_1": lr1, "step1_loss_rel": rel}


# phase 13's depth, cut from 4 for the run's time limit
TRAIN_F32_LAYERS = 2


def phase13_train_vs_plain():
    """The train path in float32 at TRAIN_F32_LAYERS layers, full width,
    on the kernels and on the plain versions: qwen3-1.7b with the compressed reduction
    (3 Trainer steps, checkpoint restart), mamba2-2.7b with fused buckets
    (one step, the SSD scan's gradient)."""
    plain_of = lambda r: dataclasses.replace(r, kernels="plain")
    res = {}
    cfg = dataclasses.replace(registry.get("qwen3-1.7b").cfg,
                              n_layers=TRAIN_F32_LAYERS)
    arch = registry.Arch(cfg)
    rt = Runtime(gradsync="spindle_compressed", dp_workers=TRAIN_WORKERS)
    kw = dict(seq_len=512, global_batch=2, log_every=1,
              param_dtype=torch.float32)
    tcfg = api.TrainConfig(steps=3, **kw)
    params = arch.init_params(13, "cuda", torch.float32)
    trainer = api.Trainer("qwen3-1.7b", cfg, tcfg, rt, device="cuda")
    batch = trainer._batch_for(0)
    g_k, g_p, grad_err, wl_rel = compare_worker_grads(
        arch, params, batch, rt, plain_of(rt), "qwen3 f32")
    yard = float64_yardstick(arch, params, batch, rt, g_k, g_p, "qwen3")
    del g_p
    # the compressed mean against the exact fused mean, per worker shard
    plan = gradsync.make_plan(tree_util.map(lambda g: g[0], g_k),
                              target_bytes=steps.BUCKET_BYTES)
    comp = steps.reduce_grads(g_k, rt)
    exact = steps.reduce_grads(g_k, Runtime(gradsync="spindle",
                                            dp_workers=TRAIN_WORKERS))
    worst_steps = 0.0
    for bk, (c, e) in enumerate(zip(gradsync.flatten_buckets(comp, plan),
                                    gradsync.flatten_buckets(exact, plan))):
        pad = (-c.numel()) % TRAIN_WORKERS
        c, e = (torch.nn.functional.pad(t.float(), (0, pad)).view(
            TRAIN_WORKERS, -1) for t in (c, e))
        step_size = e.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-30
        ratio = float(((c - e).abs() / step_size).max())
        worst_steps = max(worst_steps, ratio)
        check(ratio <= 4.0, f"compressed bucket {bk}: {ratio} quantization "
              f"steps from the exact mean")
    del g_k, comp, exact
    first = compare_first_step(arch, params, batch, rt, plain_of(rt),
                               tcfg.opt, "qwen3 f32")
    # three Trainer steps on the kernels and on the plain versions
    runs = {}
    for key, r in (("kernels", rt), ("plain", plain_of(rt))):
        tr = api.Trainer("qwen3-1.7b", cfg, tcfg, r, device="cuda")
        p0 = tree_util.map(torch.clone, params)
        ops.reset_launch_counts()
        final, _ = timed(lambda: tr.run(p0, adamw.init(p0)))
        made = {k: v for k, v in ops.launch_counts().items() if v}
        if key == "plain":
            check(not made, f"the plain train run launched {made}")
        else:
            per_step = train_launches(cfg, TRAIN_WORKERS, plan.n_buckets)
            check(made == {k: 3 * v for k, v in per_step.items()},
                  f"qwen3 f32 train launches {made}")
        runs[key] = ([h["loss"] for h in tr.history],
                     final if key == "kernels" else None)
        del final, p0
    loss_rel = [abs(a - c) / abs(c) for a, c in zip(runs["kernels"][0],
                                                    runs["plain"][0])]
    check(max(loss_rel) <= TRAIN_LOSS_RTOL,
          f"qwen3 f32 losses {runs['kernels'][0]} vs {runs['plain'][0]}")
    # checkpoint after step 2, restore into a fresh Trainer, step 3
    ckpt = ROOT / "build" / "chip_smoke_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    ck = dict(kw, checkpoint_dir=str(ckpt), checkpoint_every=2)
    p0 = tree_util.map(torch.clone, params)
    api.Trainer("qwen3-1.7b", cfg, api.TrainConfig(steps=2, **ck), rt,
                device="cuda").run(p0, adamw.init(p0))
    resumed = api.Trainer("qwen3-1.7b", cfg, api.TrainConfig(steps=3, **ck),
                          rt, device="cuda")
    (p_re, o_re), restart_s = timed(lambda: resumed.run(p0, adamw.init(p0)))
    full_p, full_o = runs["kernels"][1]
    same = [h["loss"] for h in resumed.history] == runs["kernels"][0][2:] \
        and all(torch.equal(a, c) for a, c in zip(
            tree_util.leaves({"p": p_re, "o": o_re}),
            tree_util.leaves({"p": full_p, "o": full_o})))
    check(same and resumed.sync.delivered_step == 3,
          "restart from the step-2 checkpoint is not bit-equal")
    shutil.rmtree(ckpt, ignore_errors=True)
    res["qwen3-1.7b"] = {
        "layers": 4, "batch": 2, "seq": 512, "gradsync": rt.gradsync,
        "workers": TRAIN_WORKERS, "losses_kernels": runs["kernels"][0],
        "losses_plain": runs["plain"][0], "loss_rel_err": loss_rel,
        "worker_loss_rel_err": wl_rel, "grad_rel_err": grad_err,
        "float64_yardstick": yard,
        "compressed_vs_exact_quant_steps": worst_steps, **first,
        "restart_bit_equal": same, "restart_wall_s": restart_s}
    del params, runs, p_re, o_re, full_p, full_o, p0
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(registry.get("mamba2-2.7b").cfg,
                              n_layers=TRAIN_F32_LAYERS)
    arch = registry.Arch(cfg)
    rt = Runtime(gradsync="spindle", dp_workers=TRAIN_WORKERS)
    params = arch.init_params(14, "cuda", torch.float32)
    batch = {"tokens": seeded_tokens(cfg, 2, 1024, seed=130)}
    g_k, g_p, grad_err, wl_rel = compare_worker_grads(
        arch, params, batch, rt, plain_of(rt), "mamba2 f32")
    yard = float64_yardstick(arch, params, batch, rt, g_k, g_p, "mamba2")
    del g_k, g_p
    by_site = grad_errors_by_site(
        arch, params, batch, rt,
        {"ssd_scan": ("ssd_scan",),
         "rms_norm": ("rms_norm", "rms_norm_residual")})
    first = compare_first_step(arch, params, batch, rt, plain_of(rt),
                               adamw.OptConfig(), "mamba2 f32")
    res["mamba2-2.7b"] = {"layers": 4, "batch": 2, "seq": 1024,
                          "gradsync": rt.gradsync, "workers": TRAIN_WORKERS,
                          "worker_loss_rel_err": wl_rel,
                          "grad_rel_err": grad_err,
                          "float64_yardstick": yard,
                          "grad_rel_err_one_site_on_kernels": by_site,
                          **first}
    emit({"phase": 13, "dtype": "float32", "loss_rtol": TRAIN_LOSS_RTOL,
          **res})
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the virtual-synchrony cut: multicast, DDS, serve, gradients, chaos
# ---------------------------------------------------------------------------

# (key, device, backend) of the three runs every cut is held across
CUT_RUNS = (("kernel_cuda", "cuda", "kernel"), ("graph_cuda", "cuda", "graph"),
            ("graph_cpu", "cpu", "graph"))


def closed_epoch(old_group, alive, carry, rounds, launches, wall, views):
    """What one epoch of a stream leaves at its cut (or at the end);
    ``views`` is the digest of its streamed rounds' ``StreamView``
    watermarks."""
    report = old_group.last_report
    return {"subgroups": old_group.cfg.subgroups, "alive": set(alive),
            "logs": old_group.delivery_logs, "carry": carry,
            "report": report, "rounds": rounds, "launches": launches,
            "wall": wall, "views": views,
            "view_change": report.extras.get("view_change")}


def same_carry(a, b, what: str) -> None:
    check((a is None) == (b is None), f"{what}: carry present on one side")
    if a is None:
        return
    check(a.from_epoch == b.from_epoch and a.cut_seq == b.cut_seq,
          f"{what}: carry cut {a.cut_seq} != {b.cut_seq}")
    for field in ("resend", "stable_apps", "app_base"):
        x, y = getattr(a, field), getattr(b, field)
        check(len(x) == len(y) and all(np.array_equal(p, q)
                                       for p, q in zip(x, y)),
              f"{what}: carry {field} differs")


def same_view_change(a, b, what: str) -> None:
    check((a is None) == (b is None), f"{what}: view_change on one side")
    if a is None:
        return
    check(a["cut_seq"] == b["cut_seq"]
          and a["resend_msgs"] == b["resend_msgs"],
          f"{what}: view_change {a['cut_seq']} != {b['cut_seq']}")
    sa, sb = a["stable_apps_by_old_rank"], b["stable_apps_by_old_rank"]
    check(sa.keys() == sb.keys() and all(np.array_equal(sa[g], sb[g])
                                         for g in sa),
          f"{what}: stable_apps_by_old_rank differs")


def same_epochs(ea, eb, what: str) -> None:
    check(len(ea) == len(eb), f"{what}: {len(ea)} epochs != {len(eb)}")
    for i, (a, b) in enumerate(zip(ea, eb)):
        w = f"{what} epoch {i}"
        check(a["subgroups"] == b["subgroups"] and a["alive"] == b["alive"]
              and a["rounds"] == b["rounds"], f"{w}: shape differs")
        check(a["views"] == b["views"], f"{w}: StreamView watermarks differ")
        same_logs(a["logs"], b["logs"], w)
        same_carry(a["carry"], b["carry"], w)
        same_view_change(a["view_change"], b["view_change"], w)
        same_report(a["report"], b["report"], w)


def check_stable_log(log, survivors, stable, what: str):
    """Every survivor holds the same sequence of ``log``, and an epoch
    that closed at a cut (``stable``: its apps per old sender rank, None
    for the drained epoch) delivered exactly that prefix.  Returns the
    apps delivered per sender rank."""
    if not survivors:
        return {}
    seqs = [log.sequence(m) if log else [] for m in survivors]
    check(all(s == seqs[0] for s in seqs[1:]), f"{what}: survivors disagree")
    per_rank = {}
    for rank, _, _ in seqs[0]:
        per_rank[rank] = per_rank.get(rank, 0) + 1
    if stable is not None:
        check([per_rank.get(r, 0) for r in range(len(stable))]
              == [int(x) for x in stable],
              f"{what}: delivered other than its stable prefix")
    return per_rank


def check_everywhere(epochs, what: str):
    """``check_stable_log`` on every subgroup of every epoch.  Returns the
    apps delivered per (subgroup, sender node) over all epochs, read at a
    surviving member."""
    delivered = {}
    for i, ep in enumerate(epochs):
        for gid, spec in enumerate(ep["subgroups"]):
            stable = None if ep["view_change"] is None else \
                ep["view_change"]["stable_apps_by_old_rank"][gid]
            per_rank = check_stable_log(
                ep["logs"].get(gid),
                [m for m in spec.members if m in ep["alive"]], stable,
                f"{what} epoch {i} subgroup {gid}")
            for rank, c in per_rank.items():
                key = (gid, spec.senders[rank])
                delivered[key] = delivered.get(key, 0) + c
    return delivered


def check_exactly_once(delivered, enqueued, dead, what: str) -> None:
    for key, total in enqueued.items():
        got = delivered.get(key, 0)
        if key[1] in dead:
            check(got <= total, f"{what}: dead sender {key} delivered "
                  f"{got} > {total}")
        else:
            check(got == total, f"{what}: live sender {key} delivered "
                  f"{got} of {total}")


def drive_cut_stream(handle, feed, cuts, ms, enqueued):
    """Stream rounds into ``handle`` (a ``GroupStream`` or a bound DDS
    domain) until ``feed(stream, round, enqueued)`` returns None, which
    counts what it feeds into ``enqueued``; after round r in ``cuts``
    cross the cut ``cuts[r](ms, handle) -> (view, next handle)``.
    Returns the epochs (the last one drained) and the cuts' host wall
    times."""
    def stream_of(h):
        return getattr(h, "stream", h)

    epochs, cut_walls = [], []
    rnd = 0
    t_epoch, l_epoch, r_epoch = time.perf_counter(), ss.WATERMARK_LAUNCHES, 0
    views = hashlib.sha256()
    while True:
        ready = feed(stream_of(handle), rnd, enqueued)
        if ready is None:
            break
        v = stream_of(handle).step(ready)
        for x in (v.delivered_num, v.published, v.backlog, v.app_pub,
                  v.nulls):
            views.update(np.ascontiguousarray(x, np.int64).tobytes())
        r_epoch += 1
        if rnd in cuts:
            wall = time.perf_counter() - t_epoch
            launches = ss.WATERMARK_LAUNCHES - l_epoch
            old = stream_of(handle).group
            t0 = time.perf_counter()
            view, handle = cuts[rnd](ms, handle)
            cut_walls.append(time.perf_counter() - t0)
            epochs.append(closed_epoch(old, view.members,
                                       stream_of(handle).carry, r_epoch,
                                       launches, wall, views.hexdigest()))
            t_epoch, l_epoch = time.perf_counter(), ss.WATERMARK_LAUNCHES
            r_epoch = 0
            views = hashlib.sha256()
        rnd += 1
    report, _ = handle.finish()
    check(not report.stalled, "the drained epoch stalled")
    group = stream_of(handle).group
    epochs.append(closed_epoch(
        group, group.cfg.members, None, report.extras["streamed_rounds"],
        ss.WATERMARK_LAUNCHES - l_epoch, time.perf_counter() - t_epoch,
        views.hexdigest()))
    return epochs, cut_walls


def testbed_cuts():
    """Round 300: sender 5 is suspected, and receiver 11 while the wedge
    is open (one cut over the final survivors); round 600: node 16 joins
    (outside the subgroup: the epoch rolls, the stack keeps its shape)."""
    def cascade(ms, stream):
        ms.suspect(0, 5)
        return ms.reconfigure_stream(
            stream, {}, during_wedge=lambda svc, attempt:
            svc.suspect(0, 11) if attempt == 0 else None)

    def join(ms, stream):
        ms.request_join(16)
        return ms.reconfigure_stream(stream, {})

    return {300: cascade, 600: join}


def dds_cuts(at: int):
    """Nodes 3 and 9 fail in one wave at round ``at``, through
    ``BoundDomain.reconfigure``."""
    def fail(ms, bound):
        ms.suspect(0, 3)
        ms.suspect(0, 9)
        view = ms.propose_and_install({})
        new_bound, _, _ = bound.reconfigure(view)
        return view, new_bound

    return {at: fail}


def testbed_feed(n_messages: int):
    """One message per live sender per round for ``n_messages`` rounds."""
    def feed(stream, rnd, enqueued):
        if rnd >= n_messages:
            return None
        ready = np.zeros(stream.shape, np.int32)
        for rank, node in enumerate(stream.group.cfg.subgroups[0].senders):
            ready[0, rank] = 1
            enqueued[(0, node)] = enqueued.get((0, node), 0) + 1
        return ready
    return feed


def dds_cut_feed(n_samples: int, publishers0):
    """One sample per round from every live original publisher of every
    topic for ``n_samples`` rounds (a silent publisher a cut installed
    publishes nothing)."""
    def feed(stream, rnd, enqueued):
        if rnd >= n_samples:
            return None
        ready = np.zeros(stream.shape, np.int32)
        for gid, spec in enumerate(stream.group.cfg.subgroups):
            for rank, node in enumerate(spec.senders):
                if node in publishers0[gid]:
                    ready[gid, rank] = 1
                    enqueued[(gid, node)] = enqueued.get((gid, node), 0) + 1
        return ready
    return feed


def cut_runs(make_handle, feed, cuts, members, dead, what: str):
    """One cut scenario on each of ``CUT_RUNS``: the epochs identical
    across them, one receive-kernel launch per streamed round on the
    card's ``kernel`` (none on ``graph``), everywhere-or-nowhere and
    exactly-once.  Returns the per-run timings and each run's epochs."""
    out, rows = {}, {}
    for key, device, backend in CUT_RUNS:
        enqueued = {}
        epochs, cut_walls = drive_cut_stream(
            make_handle(device, backend), feed, cuts,
            api.MembershipService(members), enqueued)
        for i, ep in enumerate(epochs):
            want = ep["rounds"] if backend == "kernel" else 0
            check(ep["launches"] == want,
                  f"{what} {key} epoch {i}: {ep['launches']} launches for "
                  f"{ep['rounds']} rounds (want {want})")
        delivered = check_everywhere(epochs, f"{what} {key}")
        check_exactly_once(delivered, enqueued, dead, f"{what} {key}")
        out[key] = epochs
        rows[key] = {
            "cut_wall_s": cut_walls,
            "epoch_rounds": [ep["rounds"] for ep in epochs],
            "epoch_launches": [ep["launches"] for ep in epochs],
            "ms_per_round_by_epoch": [ep["wall"] / ep["rounds"] * 1e3
                                      if ep["rounds"] else None
                                      for ep in epochs],
            "resend_msgs": [ep["view_change"]["resend_msgs"]
                            for ep in epochs[:-1]]}
    base = CUT_RUNS[-1][0]
    for key, _, _ in CUT_RUNS[:-1]:
        same_epochs(out[key], out[base], f"{what} {key} vs {base}")
    return rows, out


def phase14_multicast_cut():
    """The testbed stream through a cascading cut and a joining cut, and
    the 64-topic DDS domain through ``BoundDomain.reconfigure`` with two
    nodes failing; every epoch identical on the card's ``kernel``, the
    card's ``graph`` and the CPU's ``graph``.  Returns the testbed
    stream's card ``kernel`` epochs."""
    n_messages, dds_samples = 1000, 200
    cfg = api.single_group(16, msg_size=10240, window=100, n_messages=0)
    testbed, runs = cut_runs(
        lambda device, backend: api.Group(cfg, device=device).stream(
            backend=backend),
        testbed_feed(n_messages), testbed_cuts(), cfg.members, {5, 11},
        "testbed cut")
    check([len(ep["subgroups"][0].members) for ep in runs["graph_cpu"]]
          == [16, 14, 14], "testbed cut: wrong epoch memberships")

    publishers0 = [set(t.publishers) for t in dds_domain().topics]
    dds, _ = cut_runs(
        lambda device, backend: dds_domain().bind(backend=backend,
                                                  device=device),
        dds_cut_feed(dds_samples, publishers0), dds_cuts(dds_samples // 2),
        tuple(range(16)), {3, 9}, "DDS cut")
    emit({"phase": 14, "testbed": {
        "scenario": "single_group(16, msg_size=10240, window=100), one "
        f"message per sender per round for {n_messages} rounds; round 300: "
        "sender 5 suspected, receiver 11 during the wedge; round 600: node "
        "16 joins", "identical": True, **testbed},
        "dds": {"scenario": f"64 topics over 16 nodes, {dds_samples} "
                "samples per publisher; nodes 3 and 9 fail at round "
                f"{dds_samples // 2}", "identical": True, **dds}})
    return runs["kernel_cuda"]


def serve_cut_checks(rep, report, submitted, killed, what: str) -> None:
    """The serve plane through a cut: drained; every surviving subscriber
    of a topic holds the same log in every epoch; each closed epoch
    delivered exactly its stable prefix; completed and shed requests
    partition the submitted ones."""
    serve = report.extras["serve"]
    check(serve["drained"] and not report.stalled,
          f"{what}: did not drain: {serve}")
    alive = set(range(rep.domain.n_nodes)) - set(killed)
    epochs = [(old_logs, old_report)
              for _, _, old_report, old_logs in rep.view_log]
    epochs.append((report.extras["delivery_logs"], None))
    for e, (logs, old_report) in enumerate(epochs):
        for g, topic in enumerate(rep.topics):
            if topic.name not in logs:
                continue
            stable = None if old_report is None else old_report.extras[
                "view_change"]["stable_apps_by_old_rank"][g]
            check_stable_log(logs[topic.name],
                             [s for s in topic.subscribers if s in alive],
                             stable, f"{what}: epoch {e} of {topic.name}")
    done = {r.rid for eng in rep.engines for r in eng.completed}
    shed = {rid for rid, _ in rep.shed_log}
    check(not done & shed and done | shed == set(submitted),
          f"{what}: completed and shed do not partition the requests")


# engine round -> failing nodes of phase 15 (replica 0: slot nodes 0-7,
# subscribers 8-9; replica 1: slot nodes 10-17, subscribers 18-19)
SERVE_FAIL_AT = {7: [9], 20: [[3], [19]]}


def serve_cut_run(rep, per_replica: int, seed: int, fail_at):
    rep.reset()
    submitted = []
    for g, reqs in enumerate(serve_requests(
            api.Request, rep.engines[0].cfg.vocab_size, per_replica, seed)):
        for req in reqs:
            rep.submit(g, req)
            submitted.append(req.rid)
    torch.cuda.synchronize()
    report = rep.run(fail_at=fail_at)
    torch.cuda.synchronize()
    return report, submitted


def phase15_serve_cut():
    """The serve plane at qwen3-1.7b's full width through two cuts: a
    subscriber kill, then a slot node of replica 0 with a cascade wave
    that kills a subscriber of replica 1.  Returns the launches of the
    run."""
    cfg = registry.get("qwen3-1.7b").cfg
    params, rep = serve_setup(cfg, torch.bfloat16, seed=0)
    killed = [n for w in SERVE_FAIL_AT.values()
              for n in (w if not isinstance(w[0], list)
                        else [x for wave in w for x in wave])]
    before = ops.launch_counts()
    report, submitted = serve_cut_run(rep, 16, 1, SERVE_FAIL_AT)
    launches = launches_since(before)
    serve = report.extras["serve"]
    serve_cut_checks(rep, report, submitted, killed, "serve cut")
    check(serve["view_changes"] == 2 and serve["slot_failures"] == 1
          and serve["requeued_requests"] == 1
          and serve["fail_at_unreached"] == [],
          f"serve cut: {serve['view_changes']} views, "
          f"{serve['slot_failures']} slot failures, "
          f"{serve['requeued_requests']} requeued, unreached "
          f"{serve['fail_at_unreached']}")
    check(serve["requests"] == 32 and serve["tokens"] == 32 * 16,
          f"serve cut: {serve['requests']} requests, {serve['tokens']} "
          "tokens")
    steps = serve["decode_steps"]
    rounds = sum(r.extras["streamed_rounds"] for _, _, r, _ in rep.view_log)
    rounds += report.extras["streamed_rounds"]
    want = {"flash_decode": cfg.n_layers * steps,
            "rms_norm": (1 + 2 * cfg.n_layers) * steps,
            "rms_norm_residual": 2 * cfg.n_layers * steps,
            "smc_sweep_watermark": rounds}
    check(launches == want, f"serve cut launches {launches}, want {want}")
    for stream in (t for per in rep.completed().values() for t in per):
        check(len(stream) == 16 and all(0 <= x < cfg.vocab_size
                                        for x in stream),
              f"serve cut: bad token stream {stream}")
    emit({"phase": 15, "part": "full_width", "model": cfg.name,
          "layers": cfg.n_layers, "replicas": 2, "slots": 8,
          "max_len": 2048, "fail_at": {str(k): v for k, v in
                                       SERVE_FAIL_AT.items()},
          "launches": launches, **{k: serve[k] for k in (
              "requests", "tokens", "tokens_per_s", "wall_s",
              "engine_rounds", "decode_steps", "view_changes",
              "slot_failures", "voided_requests", "requeued_requests",
              "host_hops")},
          "slot_failure_log": serve["slot_failure_log"],
          "cut_walls_s": rep.cut_walls, "streamed_rounds": rounds,
          "resend_msgs": [r.extras["view_change"]["resend_msgs"]
                          for _, _, r, _ in rep.view_log]})
    del params, rep
    torch.cuda.empty_cache()
    return launches


def phase15_f32_vs_plain():
    """The same cuts in float32 at 4 layers on the kernels and on the
    plain versions over the graph backend: tokens, logs, the view log and
    the slot failures exactly equal."""
    cfg = dataclasses.replace(registry.get("qwen3-1.7b").cfg, n_layers=4)
    out = {}
    for key, rt, backend in (("kernels", Runtime(), "kernel"),
                             ("plain", Runtime(kernels="plain"), "graph")):
        _, rep = serve_setup(cfg, torch.float32, seed=2, rt=rt,
                             backend=backend)
        before = ops.launch_counts()
        report, submitted = serve_cut_run(rep, 16, 4, SERVE_FAIL_AT)
        launched = launches_since(before)
        if key == "plain":
            check(not launched, f"the plain cut run launched {launched}")
        out[key] = (rep, report)
    (rk, repk), (rp, repp) = out["kernels"], out["plain"]
    check(rk.completed() == rp.completed(), "phase 15 f32: tokens differ")
    same_logs(repk.extras["delivery_logs"], repp.extras["delivery_logs"],
              "phase 15 f32 logs")
    for f in INT_FIELDS:
        check(getattr(repk, f) == getattr(repp, f), f"phase 15 f32: {f}")
    sk, sp = repk.extras["serve"], repp.extras["serve"]
    for key in ("engine_rounds", "decode_steps", "requests", "tokens",
                "view_changes", "slot_failures", "voided_requests",
                "requeued_requests", "slot_failure_log",
                "fail_at_unreached", "host_hops"):
        check(sk[key] == sp[key], f"phase 15 f32: serve {key} differs")
    check(rk.slot_failures == rp.slot_failures
          and len(rk.view_log) == len(rp.view_log) == 2,
          "phase 15 f32: slot failures or view count differ")
    for (ra, va, oa, la), (rb, vb, ob, lb) in zip(rk.view_log, rp.view_log):
        check(ra == rb and va == vb, "phase 15 f32: views differ")
        same_logs(la, lb, "phase 15 f32 cut logs")
        same_view_change(oa.extras["view_change"], ob.extras["view_change"],
                         "phase 15 f32")
    emit({"phase": 15, "part": "f32_vs_plain", "layers": cfg.n_layers,
          "dtype": "float32", "identical": True,
          "requests": sk["requests"], "tokens": sk["tokens"],
          "view_changes": sk["view_changes"],
          "slot_failures": sk["slot_failures"],
          "kernels_wall_s": sk["wall_s"], "plain_wall_s": sp["wall_s"]})
    torch.cuda.empty_cache()


GRAD_WORKERS = 3
# (step, contributors, voided) of phase 16's applied ledger: worker 2's
# round-1 contribution is stable and applied; its round-2 one is not, so
# step 1 voids it and takes the mean over the survivors; the joiner
# contributes from round 6 (step 5)
GRAD_APPLIED = [(0, (0, 1, 2), ()), (1, (0, 1), (2,)), (2, (0, 1), ()),
                (3, (0, 1), ()), (4, (0, 1), ()), (5, (0, 1, 3), ())]


def phase16_gradsync_cut():
    """``ElasticRuntime`` with a ``BucketSyncStream`` at W = 3: each
    worker contributes its float32 fused bucket set for qwen3-1.7b's
    parameters at full width, seeded once on the card and reused every
    round; 6 rounds, worker 2 fails in round 3, node 3 joins in round 5.
    The applied ledger is ``GRAD_APPLIED``, and every applied update is
    held bit-equal to the plain mean of its contributors on the card,
    then dropped."""
    from repro_torch.train.elastic import ElasticConfig, ElasticRuntime
    cfg = registry.get("qwen3-1.7b").cfg
    specs = registry.param_specs(cfg)
    like = layers.map_specs(lambda sp: torch.empty(
        sp.shape, dtype=torch.float32, device="meta"), specs)
    plan = gradsync.make_plan(like, target_bytes=steps.BUCKET_BYTES)
    sizes = [plan.bucket_size(b) for b in range(plan.n_buckets)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    buckets = {}
    for node in range(GRAD_WORKERS + 1):          # node 3 is the joiner
        gen = torch.Generator(device="cuda").manual_seed(100 + node)
        buckets[node] = [torch.randn(n, generator=gen, device="cuda",
                                     dtype=torch.float32) for n in sizes]
    rt = ElasticRuntime(list(range(GRAD_WORKERS)), ElasticConfig())
    # a worker's ring holds one round's bucket set: a round publishes in
    # one multicast round and applies a few rounds later
    gs = gradsync.BucketSyncStream(list(range(GRAD_WORKERS)),
                                   n_buckets=plan.n_buckets,
                                   window=plan.n_buckets,
                                   backend="kernel", device="cuda")
    rt.attach_gradient_stream(gs, lambda node, rnd: buckets[node])
    checked, walls, bases = [], [], []

    def check_applied():
        for i, a in enumerate(rt.gradsync.applied):
            if a.update is None or i in checked:
                continue
            for b, got in enumerate(a.update):
                acc = buckets[a.contributors[0]][b].clone()
                for n in a.contributors[1:]:
                    acc.add_(buckets[n][b])
                acc.div_(len(a.contributors))
                check(torch.equal(got, acc), f"gradsync cut: round "
                      f"{a.step} bucket {b} differs from the plain mean")
            checked.append(i)
            rt.gradsync.applied[i] = dataclasses.replace(a, update=None)

    records = []
    for rnd in range(1, 7):
        if rnd == 3:
            rt.fail(GRAD_WORKERS - 1)
        if rnd == 5:
            rt.join(GRAD_WORKERS)          # contributes from round 6 on
        t0 = time.perf_counter()
        res = rt.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check_applied()
        bases.append(dict(rt.gradsync._base))
        records.append(res)
    # drain one multicast round at a time, so each applied update is
    # checked and dropped before the next (memory stays bounded)
    t0 = time.perf_counter()
    drain = 0
    while rt.gradsync._ledger and drain < 64:
        rt.gradsync.contribute({})
        check_applied()
        drain += 1
    rt.gradsync.finish()
    finish_s = time.perf_counter() - t0
    check_applied()
    applied = rt.gradsync.applied
    ledger = [(a.step, tuple(a.contributors), tuple(a.voided))
              for a in applied]
    check(ledger == GRAD_APPLIED, f"gradsync cut: applied ledger {ledger}")
    for prev, cur in zip(bases, bases[1:]):
        check(all(cur.get(n, 0) >= v for n, v in prev.items()),
              "gradsync cut: app_base rolled back")
    check(len(rt.view_changes) == 2, f"gradsync cut: "
          f"{len(rt.view_changes)} view changes")
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": 16, "model": cfg.name, "workers": GRAD_WORKERS,
          "buckets": plan.n_buckets,
          "bucket_elements": sum(sizes),
          "contribution_bytes": 4 * sum(sizes),
          "rounds": [{k: r[k] for k in ("round", "contributed",
                                         "view_change", "dp_size",
                                         "applied_step")}
                     for r in records],
          "applied": [(a.step, list(a.contributors), list(a.voided))
                      for a in applied],
          "step_wall_s": walls, "drain_rounds": drain,
          "drain_s": finish_s,
          "peak_memory_gb": (peak - mem0) / 1e9,
          "peak_memory_allocated_gb": peak / 1e9})
    del buckets, rt, gs
    torch.cuda.empty_cache()


CHAOS_SEEDS = (11, 23, 47)
# (device, backend) of the two runs each soak is held across
CHAOS_RUNS = (("cuda", "kernel"), ("cpu", "graph"))
CHAOS_STREAM_SPEC = dict(rounds=24, suspect_rate=0.25, cascade_prob=0.5,
                         join_rate=0.15, stall_rate=0.15)


def phase17_chaos():
    """``chaos_soak`` over the three targets at three seeds: the testbed
    stream, the serve plane at 4 layers in float32 (the engines on the
    card; the multicast on the card's ``kernel`` or the CPU's ``graph``)
    and a ``BucketSyncStream`` of two buckets a round.  The ``kernel``
    runs on the card and the ``graph`` runs on the CPU give equal
    digests; no invariant breaks (a break raises).  Returns the testbed
    stream's card ``kernel`` soak report by seed."""
    from repro_torch.chaos import FaultSpec, chaos_soak
    cfg = dataclasses.replace(registry.get("qwen3-1.7b").cfg, n_layers=4)
    specs = {
        "stream": FaultSpec(**CHAOS_STREAM_SPEC),
        "serve": FaultSpec(rounds=14, suspect_rate=0.2, cascade_prob=0.5,
                           slot_kill_rate=0.2, stall_rate=0.1),
        "gradsync": FaultSpec(rounds=20, suspect_rate=0.2, cascade_prob=0.5,
                              join_rate=0.2, stall_rate=0.1)}
    testbed = api.single_group(16, msg_size=10240, window=100, n_messages=0)
    params = layers.init_tree(
        layers.map_specs(lambda sp: dataclasses.replace(
            sp, dtype=torch.float32), registry.param_specs(cfg)),
        torch.Generator(device="cuda").manual_seed(5))
    engines = [api.ServeEngine(cfg.name, params, cfg,
                               api.EngineConfig(max_batch=4, max_len=256),
                               device="cuda") for _ in range(2)]
    rows, stream_soaks = {}, {}
    for seed in CHAOS_SEEDS:
        reports = {}
        for device, backend in CHAOS_RUNS:
            rep = {}
            rep["stream"] = chaos_soak(api.Group(testbed, device=device),
                                       specs["stream"], seed=seed,
                                       backend=backend)
            eng = api.ReplicatedEngine(engines, subscribers_per_replica=2,
                                       window=4, backend=backend,
                                       device=device)
            eng.reset()
            rng = np.random.default_rng(3)
            for g in range(2):
                for i in range(3):
                    eng.submit(g, api.Request(
                        rid=g * 10 + i, prompt=rng.integers(
                            0, cfg.vocab_size, 5, dtype=np.int32),
                        max_new_tokens=4))
            rep["serve"] = chaos_soak(eng, specs["serve"], seed=seed)
            gs = gradsync.BucketSyncStream([0, 1, 2, 3], n_buckets=2,
                                           window=6, backend=backend,
                                           device=device)
            rep["gradsync"] = chaos_soak(gs, specs["gradsync"], seed=seed)
            reports[(device, backend)] = rep
        stream_soaks[seed] = reports[("cuda", "kernel")]["stream"]
        (ka, a), (kb, b) = reports.items()
        for target in specs:
            ra, rb = a[target], b[target]
            check(ra.extras == rb.extras and ra.killed == rb.killed
                  and ra.joined == rb.joined and ra.checks == rb.checks
                  and ra.views_installed == rb.views_installed,
                  f"chaos {target} seed {seed}: {ka} and {kb} differ")
        rows[str(seed)] = {t: {"views": a[t].views_installed,
                               "wedge_retries": a[t].wedge_retries,
                               "killed": list(a[t].killed),
                               "joined": list(a[t].joined),
                               "checks": a[t].checks,
                               "rounds": a[t].rounds} for t in specs}
    emit({"phase": 17, "seeds": list(CHAOS_SEEDS),
          "runs": [f"{b} on {d}" for d, b in CHAOS_RUNS],
          "identical_digests": True, **rows})
    del params, engines
    return stream_soaks



# ---------------------------------------------------------------------------
# the discrete-event simulator: host code, held to the card's runs
# ---------------------------------------------------------------------------

DES_PHASE_FLAG = "--des-phase"
DES_MODEL = ("modelled by the DES of the paper's 100 Gb/s testbed "
             "(costmodel.RDMA_CX6), not measured on the card")
# BENCH_desscale.json's fleet points: (nodes, senders, messages a sender,
# window), 4 KB messages
DES_FLEET = ((64, 8, 32, 32), (256, 8, 32, 32))


class NothingOnTheCard:
    """Holds the code inside to the DES's rule: no kernel launch (the
    wrappers' counts unchanged) and no card allocation (the allocator's
    count of allocations and its allocated bytes unchanged; the
    collector is held so that no earlier tensor is freed meanwhile)."""

    def __init__(self, what: str):
        self.what = what

    @staticmethod
    def state():
        torch.cuda.synchronize()
        return (ops.launch_counts(), torch.cuda.memory_allocated(),
                torch.cuda.memory_stats().get("allocation.all.allocated",
                                              0))

    def __enter__(self):
        gc.collect()
        gc.disable()
        self.before = self.state()
        return self

    def __exit__(self, exc_type, exc, tb):
        gc.enable()
        if exc_type is None:
            after = self.state()
            check(after == self.before, f"des {self.what}: the card was "
                  f"touched: {self.before} -> {after}")
        return False


def delivery_digest(logs):
    """Order-sensitive per-member delivery digest: each member's delivered
    (rank, idx, is_app) sequence (``tests/test_des_scale.py::_digest``)."""
    return {(gid, node): log.sequence(node)
            for gid, log in sorted(logs.items())
            for node in sorted(log.delivered_seq)}


def apps_per_sender(logs, what: str):
    """Per (subgroup, member) the apps delivered per sender rank; checks
    per-sender FIFO and that every member of a subgroup delivered one
    sequence (the total order)."""
    out = {}
    for gid, log in logs.items():
        seqs = {node: log.sequence(node) for node in log.delivered_seq}
        first = next(iter(seqs.values()), [])
        check(all(q == first for q in seqs.values()),
              f"{what}: members of subgroup {gid} disagree on the order")
        for node, seq in seqs.items():
            last, per = {}, {}
            for rank, idx, _ in seq:
                check(idx > last.get(rank, -1),
                      f"{what}: per-sender FIFO broken at node {node}")
                last[rank] = idx
                per[rank] = per.get(rank, 0) + 1
            out[(gid, node)] = per
    return out


def des_fields(report) -> dict:
    """A report's fields but the backend's name, floats exact."""
    out = dataclasses.asdict(report)
    out.pop("backend")
    return out


def modelled(report) -> dict:
    return {"model": DES_MODEL, "GBps": report.throughput_GBps,
            "mean_latency_us": report.mean_latency_us,
            "p99_latency_us": report.p99_latency_us,
            "duration_us": report.duration_us}


def fleet_cfg(n: int, senders: int, messages: int, window: int,
              msg_size: int = 4096, rounds=None):
    spec = api.SubgroupSpec(members=tuple(range(n)),
                            senders=tuple(range(senders)), window=window,
                            msg_size=msg_size, n_messages=messages)
    return api.GroupConfig(members=tuple(range(n)), subgroups=(spec,),
                           rounds=rounds)


def des_and_loop(make_group, what: str):
    """``des`` and ``des-loop`` on fresh groups: reports and logs bit
    for bit.  Returns (report, logs, des host s, des-loop host s)."""
    runs = {}
    for be in ("des", "des-loop"):
        g = make_group()
        t0 = time.perf_counter()
        report = g.run(backend=be)
        runs[be] = (report, g.delivery_logs, time.perf_counter() - t0)
    (rd, ld, wd), (rl, ll, wl) = runs["des"], runs["des-loop"]
    check(des_fields(rd) == des_fields(rl),
          f"{what}: des and des-loop reports differ")
    same_logs(ld, ll, f"{what}: des vs des-loop")
    return rd, ld, wd, wl


def phase36_des(testbed, testbed_cut, soaks):
    """The discrete-event simulator (``des``: phase 1 ``desgraph`` then
    phase 2 ``desreplay``; ``des-loop``: the legacy loop) held to itself
    and to the card's ``kernel`` runs of phases 2, 14 and 17 (their
    returns: ``testbed`` the run's (report, logs), ``testbed_cut`` the
    stream's epochs, ``soaks`` the stream soak by seed), and the
    planes that stream on it: (a) phase 2's testbed, (b) Fig. 5's
    endpoints, (c) BENCH_desscale.json's fleet points and the N = 256
    conformance, (d) phase 14's testbed stream through its cuts, (e)
    phase 17's stream soaks, (f) phase 20's testbed load profile on the
    host loop.  Every des and des-loop run is held to launch nothing and
    allocate nothing on the card."""
    from repro_torch.chaos import FaultSpec, chaos_soak
    from repro_torch.configs.spindle_smc import PAPER
    from repro_torch.core import desgraph, desreplay
    from repro_torch.core import simulator as sim
    from repro_torch.core.group import DESLoopBackend

    # (a) phase 2's scenario
    cfg = api.single_group(16, msg_size=10240, window=100, n_messages=1000)
    k_report, k_logs = testbed
    with NothingOnTheCard("testbed"):
        g = api.Group(cfg, device="cuda")
        t0 = time.perf_counter()
        report = g.run(backend="des")
        host_s = time.perf_counter() - t0
    check(not report.stalled, "des testbed stalled")
    check(report.delivered_app_msgs == k_report.delivered_app_msgs,
          f"des testbed: {report.delivered_app_msgs} app deliveries, the "
          f"card's kernel {k_report.delivered_app_msgs}")
    check(apps_per_sender(g.delivery_logs, "des testbed")
          == apps_per_sender(k_logs, "kernel testbed"),
          "des testbed: apps per sender differ from the card's kernel run")
    exact = delivery_digest(g.delivery_logs) == delivery_digest(k_logs)
    emit({"phase": 36, "part": "a_testbed",
          "scenario": "single_group(16, msg_size=10240, window=100, "
          "n_messages=1000), as phase 2", "host_s": host_s,
          "modelled": modelled(report),
          "delivered_app_msgs": report.delivered_app_msgs,
          "apps_per_sender_equal_kernel": True,
          "digest_equal_kernel": exact,
          "nulls_sent": {"des": report.nulls_sent,
                         "kernel": k_report.nulls_sent},
          "digest_note": None if exact else
          "the DES's timed sweeps publish nulls the round model does not "
          "(nulls_sent above); a null takes a slot of the round-robin "
          "order, so the two total orders differ while the apps each "
          "member delivers per sender, their FIFO order and every "
          "member's agreement on one order are equal"})

    # (b) Fig. 5's endpoints, 100 messages a sender
    fig5 = {}
    for name, flags in (("baseline", api.SpindleFlags.baseline()),
                        ("spindle", api.SpindleFlags.spindle())):
        pc = PAPER.config(n_messages=100, flags=flags)
        with NothingOnTheCard(f"fig5 {name}"):
            rd, _, wd, wl = des_and_loop(
                lambda: api.Group.from_sim_config(pc, device="cuda"),
                f"fig5 {name}")
        check(not rd.stalled, f"des fig5 {name} stalled")
        fig5[name] = {"host_s_des": wd, "host_s_des_loop": wl,
                      "modelled": modelled(rd), "nulls_sent": rd.nulls_sent,
                      "rdma_writes": rd.rdma_writes}
    emit({"phase": 36, "part": "b_fig5",
          "scenario": "PAPER.config(n_messages=100): 16 nodes, 10 KB, "
          "window 100", "bit_identical": True, **fig5,
          "modelled_GBps_ratio_spindle_over_baseline":
          fig5["spindle"]["modelled"]["GBps"]
          / fig5["baseline"]["modelled"]["GBps"]})

    # (c) the fleet points, then the N = 256 conformance
    fleet = {}
    with NothingOnTheCard("fleet"):
        for n, s_, m, w in DES_FLEET:
            fc = fleet_cfg(n, s_, m, w)
            sim_cfg = DESLoopBackend._lower(
                fc, {0: np.full(s_, m, np.int64)})
            row = {}
            if n == 64:
                t0 = time.perf_counter()
                legacy = sim.Simulator(sim_cfg).run()
                row["legacy_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            graph = desgraph.simulate(sim_cfg)
            row["phase1_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            result = desreplay.replay(graph)
            row["phase2_s"] = time.perf_counter() - t0
            check(not result.stalled
                  and result.delivered_app_msgs == n * s_ * m,
                  f"des fleet N={n}: {result.delivered_app_msgs} apps")
            if n == 64:
                check(dataclasses.asdict(legacy)
                      == dataclasses.asdict(result),
                      "des fleet N=64: phase 1 + 2 differ from the loop")
                des_and_loop(lambda: api.Group(fc, device="cuda"),
                             "fleet N=64")
            fleet[f"n{n}"] = dict(row, senders=s_, messages=m, window=w,
                                  delivered_app_msgs=
                                  result.delivered_app_msgs)
        conf = fleet_cfg(256, 8, 4, 16, msg_size=1024, rounds=24)
        g_des = api.Group(conf, device="cuda")
        t0 = time.perf_counter()
        r_des = g_des.run(backend="des")
        conf_s = time.perf_counter() - t0
    g_k = api.Group(conf, device="cuda")
    r_k = g_k.run(backend="kernel")
    check(not r_des.stalled and not r_k.stalled
          and r_des.delivered_app_msgs == r_k.delivered_app_msgs
          and delivery_digest(g_des.delivery_logs)
          == delivery_digest(g_k.delivery_logs),
          "des N=256 conformance: digests differ from the card's kernel")
    emit({"phase": 36, "part": "c_fleet", "msg_size": 4096, **fleet,
          "conformance_n256": {
              "scenario": "256 nodes, 8 senders, 4 messages, window 16, "
              "1 KB, 24 rounds", "digest_equal_kernel": True,
              "des_host_s": conf_s,
              "delivered_app_msgs": r_des.delivered_app_msgs}})

    # (d) phase 14's testbed stream through its cuts
    cfg0 = api.single_group(16, msg_size=10240, window=100, n_messages=0)
    enqueued = {}
    t0 = time.perf_counter()
    with NothingOnTheCard("testbed stream"):
        epochs, cut_walls = drive_cut_stream(
            api.Group(cfg0, device="cuda").stream(backend="des"),
            testbed_feed(1000), testbed_cuts(),
            api.MembershipService(cfg0.members), enqueued)
    stream_s = time.perf_counter() - t0
    check(all(ep["launches"] == 0 for ep in epochs),
          "des testbed stream launched the kernel")
    check_exactly_once(check_everywhere(epochs, "des testbed stream"),
                       enqueued, {5, 11}, "des testbed stream")
    same_epochs(epochs, testbed_cut,
                "des testbed stream vs the card's kernel")
    emit({"phase": 36, "part": "d_stream_cut",
          "scenario": "phase 14's testbed stream: 1000 rounds, a "
          "cascading cut at round 300, a join at 600",
          "identical_to_kernel": True, "host_s": stream_s,
          "cut_wall_s": cut_walls,
          "epoch_rounds": [ep["rounds"] for ep in epochs]})

    # (e) phase 17's stream soaks
    testbed = api.single_group(16, msg_size=10240, window=100, n_messages=0)
    soak_rows = {}
    for seed in CHAOS_SEEDS:
        t0 = time.perf_counter()
        with NothingOnTheCard(f"chaos {seed}"):
            d = chaos_soak(api.Group(testbed, device="cuda"),
                           FaultSpec(**CHAOS_STREAM_SPEC), seed=seed,
                           backend="des")
        k = soaks[seed]
        check(d.backend == "des" and des_fields(d) == des_fields(k),
              f"des chaos seed {seed}: differs from the card's kernel soak")
        soak_rows[str(seed)] = {"host_s": time.perf_counter() - t0,
                                "views": d.views_installed,
                                "checks": d.checks}
    emit({"phase": 36, "part": "e_chaos", "identical_to_kernel": True,
          **soak_rows})

    # (f) phase 20's testbed profile, host loop
    loads = {}
    for policy in LOAD_POLICIES:
        rk, wk = load_stream_run("testbed", policy, "cuda", "kernel", False)
        with NothingOnTheCard(f"load {policy}"):
            rd, wd = load_stream_run("testbed", policy, "cuda", "des", False)
            rf, _ = load_stream_run("testbed", policy, "cuda", "des", True)
        check("load_fused" not in rf.run_report.extras
              and rf.json_str() == rd.json_str(),
              f"des load {policy}: fused=True left the host loop")
        jk, jd = json.loads(rk.json_str()), json.loads(rd.json_str())
        differ = sorted(k for k in set(jk) | set(jd)
                        if jk.get(k) != jd.get(k))
        check(not differ, f"des load {policy}: LoadReport fields {differ} "
              "differ from the card's kernel host loop")
        rounds = rd.run_report.extras["streamed_rounds"]
        loads[policy] = {"host_s_des": wd, "host_s_kernel": wk,
                         "rounds": rounds, "rounds_per_s_des": rounds / wd,
                         "rounds_per_s_kernel": rounds / wk}
    emit({"phase": 36, "part": "f_load", "ramp": LOAD_RAMP,
          "identical_json_to_kernel": True, **loads})


def des_phase() -> int:
    """Phase 36 alone, with the card runs it is held to (phases 2, 14 and
    17; the kernels built first)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase0_identity()
    testbed = phase2_testbed()
    testbed_cut = phase14_multicast_cut()
    soaks = phase17_chaos()
    phase36_des(testbed, testbed_cut, soaks)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# ---------------------------------------------------------------------------
# the fused serve program and the load plane (CUDA graphs, IF nodes)
# ---------------------------------------------------------------------------

# device kernels of each wrapper in a profiler trace (a flash-decode call
# launches its split kernel and, over more than one chunk, the merge)
DEVICE_KERNELS = (("flash_decode", "flash_decode_split_kernel"),
                  ("rms_norm", "rms_norm_kernel"),
                  ("rms_norm_residual", "rms_norm_residual_kernel"),
                  ("smc_sweep_watermark", "smc_sweep_watermark_kernel"))


def device_trace(fn):
    """``fn()`` under the profiler: (its result, the trace's figures).
    All from that one run: its wall, the device's busy time (the union
    of its device records' intervals, so records that overlap count
    once and the share stays <= 1), the busy share, the device launches
    of each wrapper's kernel, and the device time of ``masked_fill``
    kernels (the fused prefill's admission reset).  Read from the raw
    device records: a fused serve run leaves ~10^5 of them, too many to
    build the profiler's per-event summaries in reasonable time.  The
    profiler stays attached after its session, so every timed run of
    phases 18-20 comes before the first of these traces
    (:func:`fused_phases`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = []
    fill_ns = 0
    counts = {label: 0 for label, _ in DEVICE_KERNELS}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        spans.append((e.start_ns(), e.end_ns()))
        name = e.name()
        if "masked_fill" in name:
            fill_ns += e.duration_ns()
        for label, key in DEVICE_KERNELS:
            if key in name:
                counts[label] += 1
    busy_ns, end = 0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            busy_ns += hi - lo
            end = hi
        elif hi > end:
            busy_ns += hi - end
            end = hi
    check(busy_ns > 0, "the profiler recorded no device time")
    return out, {"traced_wall_s": wall, "device_busy_s": busy_ns / 1e9,
                 "device_busy_share": busy_ns / 1e9 / wall,
                 "masked_fill_s": fill_ns / 1e9, "launches": counts}


def fused_device_steps(rep, requests) -> int:
    """Decode steps the fused program ran on the device in a stall-free
    run: per replica, one main decode in each round a slot emitted (from
    its admission round to its finish round), plus, in each round that
    admitted, the longest admitted prompt's positions."""
    plen = {r.rid: len(r.prompt) for per in requests for r in per}
    emit_rounds = [set() for _ in rep.engines]
    prefill: dict = {}
    for rid, (g, _s) in rep.admit_slots.items():
        a = rep.admit_rounds[rid]
        emit_rounds[g] |= set(range(a, rep.finish_round_by_rid[rid] + 1))
        prefill[(g, a)] = max(prefill.get((g, a), 0), plen[rid])
    return sum(len(r) for r in emit_rounds) + sum(prefill.values())


def serve_traces(rep, report):
    """What a per-round and a fused serve run must agree on."""
    return {"tokens": rep.completed(),
            "logs": report.extras["delivery_logs"],
            "free_rounds": list(rep.free_rounds),
            "finish_rounds": list(rep.finish_rounds),
            "admit_rounds": dict(rep.admit_rounds),
            "admit_slots": dict(rep.admit_slots),
            "queue_depth_log": list(rep.queue_depth_log),
            "backlog_log": list(rep.backlog_log),
            "view_log": [(rnd, v.members) for rnd, v, _, _ in rep.view_log],
            "slot_failures": list(rep.slot_failures),
            "serve": {k: report.extras["serve"][k] for k in (
                "engine_rounds", "decode_steps", "requests", "tokens",
                "drained", "held_slots", "stall_rounds", "view_changes",
                "slot_failures", "voided_requests", "requeued_requests",
                "fail_at_unreached", "shed_requests", "max_queue_depth",
                "max_backlog")}}


def same_serve(a, b, ra, rb, what: str) -> None:
    for k in a:
        if k == "logs":
            check(a[k].keys() == b[k].keys(), f"{what}: topics differ")
            same_logs({i: a[k][n] for i, n in enumerate(sorted(a[k]))},
                      {i: b[k][n] for i, n in enumerate(sorted(b[k]))},
                      what)
        else:
            check(a[k] == b[k], f"{what}: {k} differs: {a[k]} != {b[k]}")
    same_report(ra, rb, what)


def submit_all(rep, requests) -> None:
    rep.reset()
    for g, reqs in enumerate(requests):
        for req in reqs:
            rep.submit(g, dataclasses.replace(req, tokens_out=[],
                                              finished_at=None))
    torch.cuda.synchronize()


def round_run(rep, requests, fail_at=None):
    submit_all(rep, requests)
    report = rep.run(fail_at=fail_at)
    torch.cuda.synchronize()
    return report


def fused_run(rep, requests, fail_at=None):
    """One fused serve run of ``requests``: (report, flag reads, new
    captures)."""
    submit_all(rep, requests)
    reads0, caps0 = graphloop.STATS["flag_reads"], \
        graphloop.STATS["captures"]
    report = rep.run(fail_at=fail_at, fused=True)
    torch.cuda.synchronize()
    serve = report.extras["serve"]
    check(serve["fused"] is True,
          f"fused run fell back: {serve.get('fused_fallback')}")
    check(serve["host_hops"] == 0, f"fused run took {serve['host_hops']} "
          "host hops")
    return (report, graphloop.STATS["flag_reads"] - reads0,
            graphloop.STATS["captures"] - caps0)


# the fused child's serve plane: qwen3-1.7b at full width and this many of
# its 28 layers (the depth cut that keeps the whole run well inside its
# time limit: the device trace's records and the captured graphs' nodes
# grow with the layers, and nothing in phases 18-20 depends on depth;
# cut from 8 for the run's time limit)
FUSED_LAYERS = 4


def fused_setup():
    """Phase 6's serve setup (qwen3-1.7b at full width, cut to
    FUSED_LAYERS layers, bf16, seed 0), one ``ReplicatedEngine`` per
    backend over the same two engines, and its 16 requests a replica."""
    cfg = dataclasses.replace(registry.get("qwen3-1.7b").cfg,
                              n_layers=FUSED_LAYERS)
    params, rep_k = serve_setup(cfg, torch.bfloat16, seed=0)
    rep_g = api.ReplicatedEngine(rep_k.engines, subscribers_per_replica=2,
                                 window=8, backend="graph", device="cuda")
    requests = serve_requests(api.Request, cfg.vocab_size, 16, seed=1)
    return cfg, params, {"kernel": rep_k, "graph": rep_g}, requests


def phase18_fused_serve(cfg, params, reps, requests):
    """Phase 6's serve plane as the fused program on card ``kernel`` and
    card ``graph``: bit-identical to the per-round loop (tokens, logs,
    free / finish / admit rounds, the report); one capture for the epoch
    shape cold, none warm; flag reads within ceil(rounds / K) + 2.
    Returns the rows the device trace completes
    (:func:`fused_device_phase`)."""
    param_bytes = sum(t.numel() * t.element_size() for t in
                      tensors(params))
    rows = {}
    for backend, rep in reps.items():
        t0 = time.perf_counter()
        per_round = round_run(rep, requests)
        want = serve_traces(rep, per_round)
        t1 = time.perf_counter()
        cold, cold_reads, cold_caps = fused_run(rep, requests)
        same_serve(serve_traces(rep, cold), want, cold, per_round,
                   f"fused {backend} cold vs per-round")
        t2 = time.perf_counter()
        warm, reads, caps = fused_run(rep, requests)
        same_serve(serve_traces(rep, warm), want, warm, per_round,
                   f"fused {backend} warm vs per-round")
        t3 = time.perf_counter()
        serve, fserve = warm.extras["serve"], cold.extras["serve"]
        check(cold_caps == 1 and caps == 0,
              f"fused {backend}: {cold_caps} captures cold, {caps} warm "
              "(want 1, 0)")
        bound_reads = math.ceil(serve["fused_rounds"] / graphloop.CHUNK) + 2
        check(reads <= bound_reads and cold_reads <= bound_reads,
              f"fused {backend}: {cold_reads} / {reads} flag reads for "
              f"{serve['fused_rounds']} rounds (at most {bound_reads})")
        (prog,) = rep._fused_programs.values()
        rows[backend] = {
            "per_round": {k: per_round.extras["serve"][k] for k in (
                "tokens_per_s", "wall_s", "engine_rounds",
                "decode_steps", "host_hops")},
            "fused_cold": {k: fserve[k] for k in (
                "tokens_per_s", "wall_s", "fused_rounds", "fused_epochs")},
            "fused_warm": {k: serve[k] for k in (
                "tokens", "tokens_per_s", "wall_s", "engine_rounds",
                "fused_rounds", "fused_round_budget", "host_hops")},
            "warm_wall_ms_per_engine_round":
                serve["wall_s"] / serve["engine_rounds"] * 1e3,
            "warm_wall_ms_per_fused_round":
                serve["wall_s"] / serve["fused_rounds"] * 1e3,
            "flag_reads": {"cold": cold_reads, "warm": reads,
                           "bound": bound_reads},
            "captures": {"cold": cold_caps, "warm": caps},
            "capture_s": prog.capture_s, "graph_nodes": prog.nodes,
            "graph_pool_bytes": prog.pool_bytes,
            "speedup_tokens_per_s": serve["tokens_per_s"]
            / per_round.extras["serve"]["tokens_per_s"],
            "phase_s": {"per_round": t1 - t0, "cold": t2 - t1,
                        "warm": t3 - t2}}
    emit({"phase": 18, "part": "timing", "model": cfg.name,
          "layers": cfg.n_layers, "replicas": 2, "slots": 8,
          "max_len": 2048, "window": 8, "requests_per_replica": 16,
          "identical_to_per_round": True, "chunk": graphloop.CHUNK,
          "decode_step_bound_ms": param_bytes / HBM_BYTES_PER_S * 1e3,
          **rows})
    return rows


def fused_device_phase(cfg, reps, requests, rows):
    """The device side of phase 18, from one traced warm fused run on
    ``kernel`` (collecting the trace's device records takes tens of
    seconds, so the ``graph`` run, whose device work is the same but for
    the watermark kernel, is not traced): L / 2L + 1 / 2L kernel
    launches per device decode step (4 / 9 / 8 at FUSED_LAYERS), one
    watermark kernel a round, device time per round and step and the
    busy share of the traced run; beside them, labelled, the untraced
    warm run's wall per round (phase 18's timing: a second run).
    Returns the run's device launches."""
    rep = reps["kernel"]
    (traced, _, _), trace = device_trace(lambda: fused_run(rep, requests))
    counts = trace["launches"]
    serve = traced.extras["serve"]
    steps = fused_device_steps(rep, requests)
    per_step = {k: counts[k] / steps for k in
                ("flash_decode", "rms_norm", "rms_norm_residual")}
    check(per_step == {"flash_decode": cfg.n_layers,
                       "rms_norm": 1 + 2 * cfg.n_layers,
                       "rms_norm_residual": 2 * cfg.n_layers},
          f"fused kernel: {counts} kernel launches for {steps} device "
          "decode steps")
    check(counts["smc_sweep_watermark"] == serve["fused_rounds"],
          f"fused kernel: {counts['smc_sweep_watermark']} watermark "
          f"kernels for {serve['fused_rounds']} rounds")
    busy = trace["device_busy_s"]
    emit({"phase": 18, "part": "device", "backend": "kernel", **trace,
          "device_ms_per_round": busy * 1e3 / serve["fused_rounds"],
          "device_decode_steps": steps,
          "device_ms_per_decode_step": busy * 1e3 / steps,
          "kernel_launches_per_decode_step": per_step,
          "untraced_run_wall_ms_per_round":
              rows["kernel"]["warm_wall_ms_per_fused_round"]})
    return counts


# homogeneous cuts for the fused wedge (replica 0: slot nodes 0-7,
# subscribers 8-9; replica 1: slot nodes 10-17, subscribers 18-19): a
# subscriber of each replica at round 7; at round 20 a slot node of
# replica 0, and of replica 1 in a wave during the wedge.  Phase 15's
# SERVE_FAIL_AT kills subscribers of one replica only: heterogeneous,
# so the fused path falls back for it (checked at 4 layers).
FUSED_FAIL_AT = {7: [9, 19], 20: [[3], [13]]}


def phase19_fused_wedge(cfg, reps, requests):
    """The fused serve program through the cut: FUSED_FAIL_AT at full
    width, three epochs, identical to the per-round loop; SERVE_FAIL_AT
    falls back with the reference's reason, identical; then
    ``chaos_soak(fused=True)`` at phase 17's seeds with digests equal to
    the unfused soak's but for ``fused`` and ``fused_fallback``."""
    from repro_torch.chaos import FaultSpec, chaos_soak
    rep = reps["kernel"]
    per_round = round_run(rep, requests, FUSED_FAIL_AT)
    want = serve_traces(rep, per_round)
    fused, reads, caps = fused_run(rep, requests, FUSED_FAIL_AT)
    same_serve(serve_traces(rep, fused), want, fused, per_round,
               "fused wedge vs per-round")
    warm, warm_reads, warm_caps = fused_run(rep, requests, FUSED_FAIL_AT)
    same_serve(serve_traces(rep, warm), want, warm, per_round,
               "warm fused wedge vs per-round")
    check(warm_caps == 0, f"warm fused wedge: {warm_caps} captures")
    serve = fused.extras["serve"]
    # the first epoch has phase 18's shape: its program is warm
    check(serve["fused_epochs"] == 3 and serve["view_changes"] == 2
          and caps == 2,
          f"fused wedge: {serve['fused_epochs']} epochs, "
          f"{serve['view_changes']} views, {caps} captures (want 3, 2, 2)")
    killed = [9, 19, 3, 13]
    serve_cut_checks(rep, fused, [r.rid for per in requests for r in per],
                     killed, "fused wedge")
    full = {"fail_at": {str(k): v for k, v in FUSED_FAIL_AT.items()},
            "per_round": {k: per_round.extras["serve"][k] for k in (
                "tokens_per_s", "wall_s", "engine_rounds")},
            "fused": {k: serve[k] for k in (
                "tokens_per_s", "wall_s", "engine_rounds", "fused_rounds",
                "fused_epochs", "host_hops", "view_changes",
                "slot_failures", "voided_requests", "requeued_requests")},
            "fused_warm": {k: warm.extras["serve"][k] for k in (
                "tokens_per_s", "wall_s")},
            "captures": {"cold": caps, "warm": warm_caps},
            "flag_reads": {"cold": reads, "warm": warm_reads},
            "cut_walls_s": rep.cut_walls}

    # 4 layers, float32: phase 15's heterogeneous cuts fall back,
    # explicitly, to identical results
    small = dataclasses.replace(cfg, n_layers=4)
    params, srep = serve_setup(small, torch.float32, seed=0)
    srequests = serve_requests(api.Request, small.vocab_size, 6, seed=2,
                               new_tokens=6)
    per_round = round_run(srep, srequests, SERVE_FAIL_AT)
    want = serve_traces(srep, per_round)
    submit_all(srep, srequests)
    back = srep.run(fail_at=SERVE_FAIL_AT, fused=True)
    reason = back.extras["serve"].get("fused_fallback") or ""
    check(back.extras["serve"]["fused"] is False
          and reason.startswith("fail_at cut at round 7 leaves "
                                "heterogeneous replicas"),
          f"SERVE_FAIL_AT fused: fallback {reason!r}")
    same_serve(serve_traces(srep, back), want, back, per_round,
               "SERVE_FAIL_AT fallback vs per-round")
    del params, srep

    # chaos_soak's fused leg (phase 17's serve setup, card kernel)
    spec = FaultSpec(rounds=14, suspect_rate=0.2, cascade_prob=0.5,
                     slot_kill_rate=0.2, stall_rate=0.1)
    params = layers.init_tree(
        layers.map_specs(lambda sp: dataclasses.replace(
            sp, dtype=torch.float32), registry.param_specs(small)),
        torch.Generator(device="cuda").manual_seed(5))
    engines = [api.ServeEngine(small.name, params, small,
                               api.EngineConfig(max_batch=4, max_len=256),
                               device="cuda") for _ in range(2)]
    chaos = {}
    for seed in CHAOS_SEEDS:
        out = {}
        for fused_leg in (False, True):
            eng = api.ReplicatedEngine(engines, subscribers_per_replica=2,
                                       window=4, backend="kernel",
                                       device="cuda")
            eng.reset()
            rng = np.random.default_rng(3)
            for g in range(2):
                for i in range(3):
                    eng.submit(g, api.Request(
                        rid=g * 10 + i, prompt=rng.integers(
                            0, small.vocab_size, 5, dtype=np.int32),
                        max_new_tokens=4))
            out[fused_leg] = chaos_soak(eng, spec, seed=seed,
                                        fused=fused_leg)
        u, f = out[False], out[True]
        strip = ("fused", "fused_fallback")
        check({k: v for k, v in u.extras.items() if k not in strip}
              == {k: v for k, v in f.extras.items() if k not in strip}
              and u.killed == f.killed
              and u.views_installed == f.views_installed
              and u.rounds == f.rounds and u.stall_rounds == f.stall_rounds,
              f"chaos fused seed {seed}: digests differ from the unfused "
              "soak")
        fb = f.extras["fused_fallback"]
        check(fb is None or "heterogeneous" in fb or "overflow" in fb,
              f"chaos fused seed {seed}: fallback {fb!r}")
        chaos[str(seed)] = {"fused": f.extras["fused"],
                            "fused_fallback": fb,
                            "views": f.views_installed}
    emit({"phase": 19, "full_width": full, "identical_to_per_round": True,
          "serve_fail_at_fallback": reason, "chaos_fused": chaos})
    del params, engines


# The repo's own load shapes (benchmarks/loadtest.py, copied: this script
# imports nothing of the reference): FULL's ramp and policy on the
# stream targets, SERVE_FULL's open-loop points on the serve plane (its
# prompt, new tokens, rate, stages and queue cap; the lanes are phase
# 6's 8 slots a replica).  JSON identity and the rates come from the
# same runs; every timed run is warm, each side run LOAD_REPEATS times.
LOAD_RAMP = dict(rate=0.4, warmup=40, steps=(1.0, 2.0),
                 rounds_per_stage=60, overload=8.0, seed=7)
LOAD_SERVE = dict(rate=0.5, warmup=6, measure=24, scales=(0.5, 1.5, 3.0),
                  queue_cap=6, prompt=3, new_tokens=4, seed=7)
LOAD_POLICIES = ("admit_all", "window_slack", "token_bucket")
LOAD_REPEATS = 3
# (device, backend, fused) of each stream-target run; the card `kernel`
# sides are timed
LOAD_RUNS = (("cuda", "kernel", True), ("cuda", "kernel", False),
             ("cuda", "graph", True), ("cpu", "graph", False))


def load_stream_run(target: str, policy: str, dev: str, backend: str,
                    fused: bool):
    """LOAD_RAMP on phase 2's testbed or phase 4's 64-topic domain:
    (LoadReport, wall s of ``run_profile``)."""
    from repro_torch.load import (AdmitAll, Poisson, TokenBucket,
                                  WindowSlack, run_profile, staged_ramp)
    make = {"admit_all": AdmitAll,
            "window_slack": lambda: WindowSlack(inflight_limit=8,
                                                queue_cap=32),
            "token_bucket": lambda: TokenBucket(rate=0.6, burst=4.0,
                                                queue_cap=32)}[policy]
    if target == "testbed":
        tgt = api.Group(api.single_group(16, msg_size=10240, window=100,
                                         n_messages=0), device=dev)
    else:
        tgt = dds_domain().bind(backend=backend, device=dev)
    r = LOAD_RAMP
    profile = staged_ramp(Poisson(rate=r["rate"]), warmup=r["warmup"],
                          steps=r["steps"],
                          rounds_per_stage=r["rounds_per_stage"],
                          overload=r["overload"], seed=r["seed"])
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = run_profile(tgt, profile, make(), backend=backend, fused=fused)
    if dev == "cuda":
        torch.cuda.synchronize()
    return rep, time.perf_counter() - t0


def load_serve_run(rep, scale: float, fused: bool):
    """One LOAD_SERVE point on phase 6's serve plane: (LoadReport, wall
    s of ``run_profile``)."""
    from repro_torch.load import Poisson, Profile, ServeAdmission, Stage
    from repro_torch.load import run_profile
    sh = LOAD_SERVE
    profile = Profile(arrivals=Poisson(rate=sh["rate"]), seed=sh["seed"],
                      stages=(Stage("warmup", sh["warmup"], scale),
                              Stage("measure", sh["measure"], scale)))
    rep.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = run_profile(rep, profile, ServeAdmission(
        queue_cap=sh["queue_cap"]), max_new_tokens=sh["new_tokens"],
        prompt_len=sh["prompt"], fused=fused)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(report.run_report.extras["serve"]["fused"] is fused,
          f"load serve x{scale}: fused={fused} took the other path")
    return report, wall


def spread(walls, rounds: int) -> dict:
    """Warm walls of one side and the rounds/s they give (rounds are the
    same in every repeat)."""
    return {"rounds": rounds, "wall_s": walls,
            "rounds_per_s": [rounds / w for w in walls],
            "rounds_per_s_min": rounds / max(walls),
            "rounds_per_s_max": rounds / min(walls)}


def phase20_load(reps):
    """``run_profile`` on phase 2's testbed group and phase 4's 64-topic
    bound domain (LOAD_RAMP under ``AdmitAll``, ``WindowSlack`` and
    ``TokenBucket``) and on phase 6's serve plane (LOAD_SERVE's points
    under ``ServeAdmission``): each ``LoadReport``'s JSON identical fused
    and host loop, card ``kernel`` and card ``graph``, and (stream
    targets) card and CPU ``graph``; rounds/s of the warm card
    ``kernel`` runs, fused and host loop, LOAD_REPEATS each."""
    rows = {}
    for target in ("testbed", "dds64"):
        for policy in LOAD_POLICIES:
            got, row = {}, {}
            for dev, be, fused in LOAD_RUNS:
                if fused:
                    load_stream_run(target, policy, dev, be, fused)  # cold
                rep, _ = load_stream_run(target, policy, dev, be, fused)
                got[(dev, be, fused)] = rep.json_str()
            check(len(set(got.values())) == 1,
                  f"load {target} {policy}: LoadReports differ across "
                  f"{list(got)}")
            for fused in (True, False):
                walls = []
                for _ in range(LOAD_REPEATS):
                    rep, wall = load_stream_run(target, policy, "cuda",
                                                "kernel", fused)
                    check(rep.json_str() == got[LOAD_RUNS[0]],
                          f"load {target} {policy}: a repeat differs")
                    walls.append(wall)
                row["fused" if fused else "host"] = spread(
                    walls, rep.run_report.extras["streamed_rounds"])
            rows[f"{target}/{policy}"] = row
    for scale in LOAD_SERVE["scales"]:
        got, row = {}, {}
        for fused in (True, False):
            if fused:
                load_serve_run(reps["kernel"], scale, True)    # cold
            walls = []
            for _ in range(LOAD_REPEATS if fused else 2):
                report, wall = load_serve_run(reps["kernel"], scale, fused)
                got.setdefault(("kernel", fused), report.json_str())
                check(report.json_str() == got[("kernel", fused)],
                      f"load serve x{scale}: a repeat differs")
                walls.append(wall)
            serve = report.run_report.extras["serve"]
            row["fused" if fused else "host"] = dict(
                spread(walls, serve["engine_rounds"]),
                tokens=serve["tokens"], requests=serve["requests"],
                shed=serve["shed_requests"],
                tokens_per_s=[serve["tokens"] / w for w in walls])
        if scale == LOAD_SERVE["scales"][1]:
            load_serve_run(reps["graph"], scale, True)         # cold
            for fused in (True, False):
                got[("graph", fused)] = load_serve_run(
                    reps["graph"], scale, fused)[0].json_str()
        check(len(set(got.values())) == 1,
              f"load serve x{scale}: LoadReports differ across "
              f"{list(got)}")
        rows[f"serve/x{scale}"] = row
    emit({"phase": 20, "part": "timing", "ramp": LOAD_RAMP,
          "serve_points": LOAD_SERVE, "repeats": LOAD_REPEATS,
          "identical_json": True, **rows})


def load_device_phase(reps):
    """The device side of phase 20: one traced warm fused ``kernel`` run
    per target (``AdmitAll`` on the stream targets, LOAD_SERVE's middle
    point on the serve plane): one watermark kernel a streamed round,
    busy share of the traced run.  Returns their device launches."""
    launches = {k: 0 for k, _ in DEVICE_KERNELS}
    out = {}
    runs = {t: (lambda t=t: load_stream_run(t, "admit_all", "cuda",
                                            "kernel", True)[0])
            for t in ("testbed", "dds64")}
    runs["serve"] = lambda: load_serve_run(
        reps["kernel"], LOAD_SERVE["scales"][1], True)[0]
    for target, fn in runs.items():
        report, trace = device_trace(fn)
        counts = trace["launches"]
        streamed = report.run_report.extras["streamed_rounds"]
        check(counts["smc_sweep_watermark"] == streamed,
              f"load {target}: {counts['smc_sweep_watermark']} watermark "
              f"kernels for {streamed} rounds")
        for k, v in counts.items():
            launches[k] += v
        out[target] = dict(trace, streamed_rounds=streamed)
    emit({"phase": 20, "part": "device", **out})
    return launches


FUSED_PHASES_FLAG = "--fused-phases"


def fused_phases() -> int:
    """Phases 18-20 in a process of their own (``chip_smoke.py
    --fused-phases``, started by the full run): every timed replay first,
    the device traces last.  A profiler session leaves the profiler
    attached in its process, and every later launch and graph replay
    pays for it (``PERF.md`` §6), so the timing needs a process that has
    not profiled yet; the earlier phases profile.  The last line is the
    fused and load paths' device launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    cfg, params, reps, requests = fused_setup()
    rows = phase18_fused_serve(cfg, params, reps, requests)
    phase19_fused_wedge(cfg, reps, requests)
    phase20_load(reps)
    fused = fused_device_phase(cfg, reps, requests, rows)
    load = load_device_phase(reps)
    emit({"fused": fused, "load": load})
    return 0


def run_child(flag: str, timeout: int):
    """Run this script with ``flag`` in a child process on the same
    card, relay its lines, and return its last line's JSON."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           flag], capture_output=True, text=True,
                          timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    sys.stderr.write(proc.stderr)
    check(proc.returncode == 0 and lines,
          f"the {flag} phases failed (exit {proc.returncode})")
    emit({"child": flag, "wall_s": time.perf_counter() - t0})
    return json.loads(lines[-1])


def run_fused_phases():
    """Run :func:`fused_phases` in a child process on the same card and
    return its (fused, load) device launches."""
    last = run_child(FUSED_PHASES_FLAG, 900)
    return last["fused"], last["load"]


# ---------------------------------------------------------------------------
# the recurrent families: zamba2's forward, mamba2 and zamba2 serving
# ---------------------------------------------------------------------------

RECURRENT = ("mamba2-2.7b", "zamba2-2.7b")
# phases 22 and 23 serve them at full width, mamba2-2.7b at 16 of 64
# layers and zamba2-2.7b at 12 of 54 (two shared-block groups): the
# per-round loops are host-bound and the run's time limit needed the
# room
RECURRENT_SERVE_LAYERS = {"mamba2-2.7b": 16, "zamba2-2.7b": 12}
RECURRENT_PER_REPLICA = 12
RECURRENT_PHASES_FLAG = "--recurrent-phases"


def shared_groups(cfg) -> int:
    """Invocations of the hybrid's shared block (0 for the ssm family)."""
    if cfg.family != "hybrid":
        return 0
    return cfg.n_layers // cfg.hybrid.attn_every


def recurrent_step_launches(cfg) -> dict:
    """Kernel launches of one recurrent decode step, by wrapper: the
    first norm and each Mamba block's gated norm ``rms_norm``; every
    later norm site (each Mamba block's but the first, the shared
    block's two a group, the final norm) one ``rms_norm_residual``; one
    ``flash_decode`` a shared-block invocation.  mamba2-2.7b: 65 / 64;
    zamba2-2.7b: 9 / 55 / 72."""
    g = shared_groups(cfg)
    want = {"rms_norm": 1 + cfg.n_layers,
            "rms_norm_residual": cfg.n_layers + 2 * g}
    if g:
        want["flash_decode"] = g
    return want


def recurrent_forward_launches(cfg) -> dict:
    """Kernel launches of one recurrent forward: the decode step's norms,
    one ``ssd_scan`` a Mamba block and one ``flash_attention`` a
    shared-block invocation (zamba2-2.7b: 9 / 54 / 55 / 72)."""
    want = recurrent_step_launches(cfg)
    g = want.pop("flash_decode", 0)
    want["ssd_scan"] = cfg.n_layers
    if g:
        want["flash_attention"] = g
    return want


def recurrent_requests(vocab: int, per_replica: int, seed: int,
                       replicas: int = 2):
    """Seeded requests with short prompts (2-4 tokens: the fused program
    unrolls one decode a prompt position, ROADMAP item 21) and 8-16 new
    tokens, so slots free at different rounds and later requests are
    admitted beside busy slots."""
    rng = np.random.default_rng(seed)
    return [[api.Request(rid=g * 1000 + i,
                         prompt=rng.integers(0, vocab, int(rng.integers(
                             2, 5)), dtype=np.int32),
                         max_new_tokens=int(rng.integers(8, 17)))
             for i in range(per_replica)] for g in range(replicas)]


def recurrent_cfg_4(cfg):
    """``cfg`` cut to 4 layers at full width; the hybrid keeps its shared
    block every 2 (two invocations: 4 is no multiple of 6)."""
    if cfg.family == "hybrid":
        return dataclasses.replace(
            cfg, n_layers=4,
            hybrid=dataclasses.replace(cfg.hybrid, attn_every=2))
    return dataclasses.replace(cfg, n_layers=4)


def state_bytes(eng) -> int:
    return sum(eng.cache[k].numel() * eng.cache[k].element_size()
               for k in ("ssm_state", "conv_state"))


def decode_step_bound(cfg, params, eng, kv_lens) -> dict:
    """The least time of one decode step of ``eng``'s B rows, computed
    (not measured): every weight read once but the embedding (B rows
    gathered) and the hybrid's shared block (read at each of its G
    invocations), the recurrent state read and written once, the shared
    block's K/V read over ``kv_lens`` and one row written a group;
    against the bf16 matrix work."""
    b = eng.ecfg.max_batch
    esize = params["embed"].element_size()
    weights = sum(t.numel() * t.element_size() for t in tensors(params)) \
        - params["embed"].numel() * esize + b * cfg.d_model * esize
    g = shared_groups(cfg)
    if g:
        weights += (g - 1) * sum(t.numel() * t.element_size()
                                 for t in tensors(params["shared_block"]))
    state = 2 * state_bytes(eng)
    kv = 2 * g * (sum(kv_lens) + b) * cfg.n_kv_heads * cfg.head_dim_ * \
        esize
    flops = 2 * b * (matmul_params(cfg) + cfg.d_model * cfg.vocab_size)
    bound_ms, bound_by = bound(weights + state + kv, flops,
                               BF16_TC_OPS_PER_S)
    return {"bound_ms": bound_ms, "bound_by": bound_by,
            "bound_weight_bytes": weights, "bound_state_bytes": state,
            "bound_kv_bytes": kv, "bound_flops": flops}


def step_inputs(eng, at: int):
    """One all-valid decode step's inputs for ``eng``'s B rows, at
    positions ``at`` .. ``at`` + B - 1."""
    b = eng.ecfg.max_batch
    tokens = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
    pos = torch.arange(b, dtype=torch.int32, device="cuda") + at
    return tokens, pos, np.ones(b, bool)


def phase21_zamba2_forward():
    """zamba2-2.7b's forward at full width: all 54 layers, bf16 weights
    from seed 0, ``loss_fn`` on 1 x 2048 tokens: a finite loss near ln V,
    exact launches per forward, tokens/s and the forward's bound (its
    device time comes from :func:`recurrent_device_phase`).  Returns the
    launches."""
    arch = registry.get("zamba2-2.7b")
    cfg = arch.cfg
    t0 = time.perf_counter()
    params = arch.init_params(0, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    want = recurrent_forward_launches(cfg)
    b, s = 1, 2048
    batch = {"tokens": seeded_tokens(cfg, b, s, seed=94)}
    rt = Runtime()
    fn = lambda: arch.loss_fn()(params, cfg, batch, rt)
    ops.reset_launch_counts()                 # the forward starts here
    cold, cold_s = run_counted(fn, want, "zamba2 loss (cold)")
    res, wall = run_counted(fn, want, "zamba2 loss")
    launches = ops.launch_counts()            # ... and ends here
    value = float(res)
    check(res.dim() == 0 and math.isfinite(value)
          and abs(value - math.log(cfg.vocab_size)) < 2.0,
          f"zamba2 loss {value}, want near ln V = "
          f"{math.log(cfg.vocab_size)}")
    g, d_inner = shared_groups(cfg), cfg.ssm.expand * cfg.d_model
    extra = attention_flops(b, s, cfg.n_heads, cfg.head_dim_, True) * g + \
        ssd_flops(b, s, d_inner // cfg.ssm.head_dim, cfg.ssm.head_dim,
                  cfg.ssm.d_state, cfg.ssm.n_groups, cfg.ssm.chunk) * \
        cfg.n_layers
    emit({"phase": 21, "model": cfg.name, "layers": cfg.n_layers,
          "shared_block_every": cfg.hybrid.attn_every,
          "params": cfg.param_count(), "batch": b, "seq": s,
          "setup_s": setup_s, "loss": value,
          "ln_vocab": math.log(cfg.vocab_size),
          "same_as_cold_run": float(cold) == value,
          "launches_per_forward": want, "launches": launches,
          "cold_wall_s": cold_s, "wall_s": wall,
          "tokens_per_s": b * s / wall,
          **forward_bound(cfg, params, b * s, b * (s - 1), extra, 4)})
    del params, res, cold
    torch.cuda.empty_cache()
    return launches


def check_cache_dtypes(rep, name: str) -> None:
    """``ssm_state`` float32 in every engine, the rest in bf16."""
    for eng in rep.engines:
        dtypes = {k: v.dtype for k, v in eng.cache.items()}
        check(dtypes["ssm_state"] == torch.float32
              and all(v == torch.bfloat16 for k, v in dtypes.items()
                      if k != "ssm_state"),
              f"{name}: engine cache dtypes {dtypes} (want ssm_state "
              "float32, the rest bfloat16)")


def recurrent_serve(name: str):
    """Phases 22 and 23 for one recurrent model at full width (bf16 from
    seed 0, 2 replicas x 8 slots x 2048 positions, window 8): the
    per-round loop on the ``kernel`` backend with its launches counted,
    then the fused program on card ``kernel`` and card ``graph`` against
    the per-round loop, at RECURRENT_SERVE_LAYERS layers.  Returns the
    per-round run's launches."""
    cfg = dataclasses.replace(registry.get(name).cfg,
                              n_layers=RECURRENT_SERVE_LAYERS[name])
    t0 = time.perf_counter()
    params, rep_k = serve_setup(cfg, torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check_cache_dtypes(rep_k, name)
    rep_g = api.ReplicatedEngine(rep_k.engines, subscribers_per_replica=2,
                                 window=8, backend="graph", device="cuda")
    requests = recurrent_requests(cfg.vocab_size, RECURRENT_PER_REPLICA,
                                  seed=21)
    per_step = recurrent_step_launches(cfg)

    # phase 22: the per-round loop, counted
    ops.reset_launch_counts()                 # the serve path starts here
    report = round_run(rep_k, requests)
    launches = ops.launch_counts()            # ... and ends here
    serve = report.extras["serve"]
    n_req = 2 * RECURRENT_PER_REPLICA
    want_tokens = sum(r.max_new_tokens for per in requests for r in per)
    check(serve["drained"] and serve["requests"] == n_req
          and serve["tokens"] == want_tokens, f"{name} serve: {serve}")
    steps_ = serve["decode_steps"]
    want = {k: 0 for k in launches}
    want.update({k: n * steps_ for k, n in per_step.items()})
    want["smc_sweep_watermark"] = report.extras["streamed_rounds"]
    check(launches == want,
          f"{name} serve launches {launches}, want {want}")
    for stream in (t for per in rep_k.completed().values() for t in per):
        check(all(0 <= x < cfg.vocab_size for x in stream),
              f"{name}: bad token stream {stream}")
    per_round = {"kernel": (report, serve_traces(rep_k, report))}
    # the decode step alone, all 8 rows valid: its host wall
    eng = rep_k.engines[0]
    tokens, pos, valid = step_inputs(eng, 16)
    logits, _ = eng.decode(params, eng.cache, tokens, pos, valid)
    check(bool(torch.isfinite(logits.float()).all()),
          f"{name}: non-finite logits")
    n = 10
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(n):
        eng.decode(params, eng.cache, tokens, pos, valid)
    torch.cuda.synchronize()
    step_wall_ms = (time.perf_counter() - t1) / n * 1e3
    emit({"phase": 22, "model": name, "layers": cfg.n_layers,
          "params": cfg.param_count(), "replicas": 2, "slots": 8,
          "max_len": 2048, "window": 8, "backend": "kernel",
          "requests": n_req, "setup_s": setup_s,
          "ssm_state_dtype": str(eng.cache["ssm_state"].dtype),
          "state_bytes_per_replica": state_bytes(eng),
          "launches": launches, "launches_per_decode_step": per_step,
          "decode_steps": steps_, "tokens": serve["tokens"],
          "tokens_per_s": serve["tokens_per_s"], "wall_s": serve["wall_s"],
          "wall_ms_per_decode_step": serve["wall_s"] / steps_ * 1e3,
          "engine_rounds": serve["engine_rounds"],
          "decode_step_alone_wall_ms": step_wall_ms,
          "decode_step_bound_computed": decode_step_bound(
              cfg, params, eng, (pos + 1).tolist())})

    # phase 23: the fused program against the per-round loop
    rows = {}
    for backend, rep in (("kernel", rep_k), ("graph", rep_g)):
        if backend not in per_round:
            r = round_run(rep, requests)
            per_round[backend] = (r, serve_traces(rep, r))
        r_round, want_traces = per_round[backend]
        t1 = time.perf_counter()
        cold, cold_reads, cold_caps = fused_run(rep, requests)
        same_serve(serve_traces(rep, cold), want_traces, cold, r_round,
                   f"{name} fused {backend} cold vs per-round")
        t2 = time.perf_counter()
        warm, reads, caps = fused_run(rep, requests)
        same_serve(serve_traces(rep, warm), want_traces, warm, r_round,
                   f"{name} fused {backend} warm vs per-round")
        wserve = warm.extras["serve"]
        check(cold_caps == 1 and caps == 0,
              f"{name} fused {backend}: {cold_caps} captures cold, {caps} "
              "warm (want 1, 0)")
        bound_reads = math.ceil(wserve["fused_rounds"]
                                / graphloop.CHUNK) + 2
        check(reads <= bound_reads and cold_reads <= bound_reads,
              f"{name} fused {backend}: {cold_reads} / {reads} flag reads "
              f"for {wserve['fused_rounds']} rounds (at most "
              f"{bound_reads})")
        (prog,) = rep._fused_programs.values()
        rows[backend] = {
            "per_round_tokens_per_s":
                r_round.extras["serve"]["tokens_per_s"],
            "cold": {"tokens_per_s": cold.extras["serve"]["tokens_per_s"],
                     "wall_s": t2 - t1},
            "warm": {k: wserve[k] for k in (
                "tokens", "tokens_per_s", "wall_s", "engine_rounds",
                "fused_rounds", "host_hops")},
            "warm_wall_ms_per_fused_round":
                wserve["wall_s"] / wserve["fused_rounds"] * 1e3,
            "flag_reads": {"cold": cold_reads, "warm": reads,
                           "bound": bound_reads},
            "captures": {"cold": cold_caps, "warm": caps},
            "capture_s": prog.capture_s, "graph_nodes": prog.nodes,
            "graph_pool_bytes": prog.pool_bytes,
            "speedup_tokens_per_s": wserve["tokens_per_s"]
            / r_round.extras["serve"]["tokens_per_s"]}
    emit({"phase": 23, "model": name, "layers": cfg.n_layers,
          "identical_to_per_round": True, "host_hops": 0,
          "chunk": graphloop.CHUNK, **rows})
    del params, rep_k, rep_g, eng, logits
    torch.cuda.empty_cache()
    return launches


def tokens_of(rep, rid: int):
    return next(r.tokens_out for e in rep.engines for r in e.completed
                if r.rid == rid)


F64_TOL = 1e-9          # float64: the forward and the decode, one function


def forward_and_decode(cfg, params, tokens, rt, decode: bool = True):
    """The last position's logits of the full-sequence forward over
    ``tokens`` (B, S) and of S decode steps from a zero state (None with
    ``decode=False``)."""
    if cfg.family == "hybrid":
        h = hybrid.hidden(params, cfg, tokens, rt)
    else:
        h = registry._ssm_hidden(params, cfg, tokens, rt)
    full = h[:, -1] @ params["lm_head"]
    del h
    if not decode:
        return full, None
    b, s = tokens.shape
    arch = registry.Arch(cfg)
    dtype = params["embed"].dtype
    cache = layers.map_specs(
        lambda sp: torch.zeros(sp.shape, dtype=torch.float64
                               if dtype == torch.float64
                               else torch.float32, device="cuda"),
        arch.cache_specs(ShapeConfig("x", s, b, "decode")))
    decode = arch.decode_fn()
    for t in range(s):
        logits, cache = decode(params, cfg, cache, tokens[:, t:t + 1],
                               torch.full((b,), t, dtype=torch.int32,
                                          device="cuda"), rt)
    return full, logits


def phase24_recurrent_f32():
    """Both recurrent families in float32 at 4 layers, full width: the
    serve plane on the kernels against ``Runtime(kernels="plain")``
    (phase 7's rule), each request's batched tokens against the same
    request served alone, and the forward over S + 1 = 512 tokens
    against 512 decode steps from a zero state: in float64 on the plain
    versions the two are one function (last logits within 1e-9); the
    float32 decode on the kernels is within 1e-4 (the SSD bar) of the
    float64 forward and within 5e-4 (phase 10's bar) of the float32
    forward, whose own float32 error is printed beside it."""
    out = {}
    for name in RECURRENT:
        cfg = recurrent_cfg_4(registry.get(name).cfg)
        requests = recurrent_requests(cfg.vocab_size, 8, seed=24)
        record, batched = serve_kernels_vs_plain(
            cfg, lambda rep: round_run(rep, requests),
            recurrent_step_launches(cfg), f"phase 24 {name}")
        # batched against solo, on the kernels
        params, rep = serve_setup(cfg, torch.float32, seed=2)
        for g, per in enumerate(requests):
            for req in per:
                solo = [[] for _ in requests]
                solo[g] = [req]
                round_run(rep, solo)
                got = tokens_of(rep, req.rid)
                check(got == batched[req.rid],
                      f"phase 24 {name}: request {req.rid} batched "
                      f"{batched[req.rid]} != solo {got}")
        del rep
        # the forward over S + 1 tokens against S + 1 decode steps, on
        # the kernels in float32 and on the plain versions in float64
        b, s1 = 2, 512
        tokens = seeded_tokens(cfg, b, s1, seed=124)
        p64 = tree_util.map(lambda t: t.double(), params)
        fwd, dec = forward_and_decode(cfg, params, tokens, Runtime())
        fwd64, dec64 = forward_and_decode(cfg, p64, tokens,
                                          Runtime(kernels="plain"))
        fwd_plain, _ = forward_and_decode(cfg, params, tokens,
                                          Runtime(kernels="plain"), False)
        tol = SSD_Y_TOL[torch.float32]
        diag = {"batch": b, "seq": s1, "max_abs_logit":
                float(fwd64.abs().max()),
                "f32_forward_vs_f64": float((fwd.double() - fwd64).abs()
                                            .max()),
                "f32_plain_forward_vs_f64":
                    float((fwd_plain.double() - fwd64).abs().max()),
                "f32_decode_vs_f64": float((dec.double() - fwd64).abs()
                                           .max())}
        # the two orders are the same function: equal in float64
        e64 = float((dec64 - fwd64).abs().max())
        check(e64 <= F64_TOL * max(1.0, diag["max_abs_logit"]),
              f"phase 24 {name}: float64 decode vs forward {e64}")
        diag["f64_decode_vs_forward"] = e64
        # the float32 decode (the exact recurrence) at the SSD bar of
        # the float64 forward; the float32 forward at phase 10's
        # full-width bar of the decode (its own float32 error vs float64
        # is the larger, f32_forward_vs_f64)
        within(dec, fwd64.float(), torch.float32, tol,
               f"phase 24 {name}: float32 decode vs the float64 forward")
        diag["f32_decode_vs_forward"] = within(
            dec, fwd, torch.float32, FORWARD_TOL,
            f"phase 24 {name}: {s1} decode steps vs the forward")
        out[name] = {**record, "shared_block_every":
                     cfg.hybrid.attn_every if cfg.hybrid else None,
                     "batched_equals_solo": True,
                     "solo_requests": sum(len(p) for p in requests),
                     "forward_vs_decode": diag}
        del params, p64
        torch.cuda.empty_cache()
    emit({"phase": 24, **out})


def recurrent_device_phase():
    """The profiled figures of phases 21-22, after every timed run of
    this process: zamba2-2.7b's forward (device time, busy share, per
    kernel) and one full-width decode step of each recurrent model at
    B = 8 (device time and device operations a step) beside its computed
    bound."""
    arch = registry.get("zamba2-2.7b")
    cfg = arch.cfg
    params = arch.init_params(0, "cuda", torch.bfloat16)
    batch = {"tokens": seeded_tokens(cfg, 1, 2048, seed=94)}
    prof = profile_forward(lambda: arch.loss_fn()(params, cfg, batch,
                                                  Runtime()))
    del params
    torch.cuda.empty_cache()
    steps_ = {}
    for name in RECURRENT:
        cfg = registry.get(name).cfg
        params = registry.Arch(cfg).init_params(0, "cuda", torch.bfloat16)
        eng = api.ServeEngine(name, params, cfg,
                              api.EngineConfig(max_batch=8, max_len=2048),
                              device="cuda")
        tokens, pos, valid = step_inputs(eng, 16)
        step = lambda: eng.decode(params, eng.cache, tokens, pos, valid)
        dev_ms, dev_ops = profiled_device(step, 5)
        check(dev_ms is not None, f"{name}: no device time profiled")
        top = profile_forward(step)["top_device_ops_ms"]
        b = decode_step_bound(cfg, params, eng, (pos + 1).tolist())
        steps_[name] = {"device_ms_per_decode_step": dev_ms,
                        "device_ops_per_decode_step": dev_ops,
                        "top_device_ops_ms_one_step": top,
                        "bound_ms_computed": b["bound_ms"],
                        "device_over_bound": dev_ms / b["bound_ms"]}
        del params, eng
        torch.cuda.empty_cache()
    emit({"phase": 25, "zamba2_forward": prof, "decode_steps": steps_})


def recurrent_phases() -> int:
    """Phases 21-25 in a process of their own (``chip_smoke.py
    --recurrent-phases``, started by the full run): every timed run
    first, the profiled ones last (a profiler session stays attached in
    its process, see :func:`fused_phases`).  The last line is the
    recurrent path's launches: zamba2's forward and both models'
    per-round serve."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    counts = phase21_zamba2_forward()
    for name in RECURRENT:
        for k, v in recurrent_serve(name).items():
            counts[k] = counts.get(k, 0) + v
    phase24_recurrent_f32()
    recurrent_device_phase()
    emit({"recurrent": counts})
    return 0


# ---------------------------------------------------------------------------
# the moe, vlm and encdec families (phases 26-31)
# ---------------------------------------------------------------------------

FAMILIES_PHASES_FLAG = "--families-phases"
MOE_SERVED = "qwen2-moe-a2.7b"
SEAMLESS = "seamless-m4t-medium"
INTERNVL = "internvl2-26b"
DEEPSEEK = "deepseek-moe-16b"
FAMILIES_PER_REPLICA = 16
# flash_attention calls by their causal flag, flash_decode calls by
# whether every row reads its whole cache (the encdec's cross attention)
SPLIT = collections.Counter()


@dataclasses.dataclass(frozen=True)
class SplitCountRuntime(Runtime):
    """The kernels, with :data:`SPLIT` counting the attention calls by
    kind (a host read a ``flash_decode`` call: single passes only)."""

    def op(self, name):
        fn = Runtime.op(self, name)
        if name == "flash_attention":
            def counted(q, k, v, causal=True):
                SPLIT["causal" if causal else "non_causal"] += 1
                return fn(q, k, v, causal)
            return counted
        if name == "flash_decode":
            def counted(q, k, v, kv_len):
                whole = bool((kv_len == k.shape[1]).all())
                SPLIT["cross" if whole else "self"] += 1
                return fn(q, k, v, kv_len)
            return counted
        return fn


def split_counts(fn):
    """``fn()`` on a :class:`SplitCountRuntime`: (result, the split)."""
    SPLIT.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(SPLIT)


def decoder_launches(cfg, attn: str) -> dict:
    """Launches of one pass of a decoder-only stack (``attn`` is
    ``flash_attention`` for a forward, ``flash_decode`` for a step): the
    first norm (and the q-/k-norms) ``rms_norm``, two fused residual
    norms a layer; the vlm's forward adds its projector's norm.
    qwen2-moe-a2.7b 1 / 48 / 24, deepseek-moe-16b 1 / 56 / 28."""
    n = cfg.n_layers
    return {attn: n, "rms_norm": 1 + (2 * n if cfg.qk_norm else 0),
            "rms_norm_residual": 2 * n}


def encdec_launches(cfg, step: bool) -> dict:
    """Launches of a seq2seq loss (seamless-m4t-medium: 24 attention, 2
    / 60 norms) or of one decode step (24 flash decode: 12 self, 12
    cross; 1 / 36 norms)."""
    e, d = cfg.encdec.n_encoder_layers, cfg.encdec.n_decoder_layers
    if step:
        return {"flash_decode": 2 * d, "rms_norm": 1,
                "rms_norm_residual": 3 * d}
    return {"flash_attention": e + d, "rms_norm": 2,
            "rms_norm_residual": 2 * e + 3 * d}


def encoder_launches(cfg) -> dict:
    e = cfg.encdec.n_encoder_layers
    return {"flash_attention": e, "rms_norm": 1, "rms_norm_residual": 2 * e}


class RouterProbe:
    """While entered, every router call's smallest gap between a token's
    K-th and (K+1)-th probability, its routes, its aux term and every
    dispatch's dropped routes, kept on the device and read on exit
    (diagnostic passes, the train steps of phase 33, phase 38's EP
    runs); a remat rerun's calls (``recomputing()``) are not counted
    again."""

    def __init__(self, keep_probs: bool = False):
        self.keep_probs = keep_probs

    def __enter__(self):
        self.gaps, self.drops, self.aux, self.routes = [], [], [], 0
        self.probs = []               # each call's (T, E), if kept
        self.idx = []                 # each call's routes (phase 38)
        # each call's per-token smallest gap between neighbours among
        # its K + 1 largest probabilities (phase 38)
        self.token_gaps = []
        self._route, self._dispatch = moe.route, moe._dispatch

        def route(p, cfg, x):
            if recomputing():         # a remat rerun: counted in its step
                return self._route(p, cfg, x)
            with torch.no_grad():
                probs = torch.softmax(moe.router_logits(p, x), -1)
                top = torch.topk(probs, cfg.moe.top_k + 1, dim=-1).values
                self.gaps.append((top[:, -2] - top[:, -1]).min())
                self.token_gaps.append((top[:, :-1] - top[:, 1:]).amin(-1))
                if self.keep_probs:
                    self.probs.append(probs)
            out = self._route(p, cfg, x)
            self.aux.append(out[2].detach())
            self.idx.append(out[0].clone())
            return out

        def dispatch(idx, weights, e, c, t):
            out = self._dispatch(idx, weights, e, c, t)
            if not recomputing():
                self.drops.append(idx.numel() - out[2].sum())
                self.routes += idx.numel()
            return out

        moe.route, moe._dispatch = route, dispatch
        return self

    def __exit__(self, *exc):
        moe.route, moe._dispatch = self._route, self._dispatch
        # a run may route on the card and on the CPU
        self.stats = {
            "min_router_gap": min(float(g) for g in self.gaps)
            if self.gaps else None,
            "routes": self.routes,
            "routes_dropped": sum(int(d) for d in self.drops)}
        return False


def moe_flops(cfg, tokens: int, routed: bool = False) -> int:
    """The matrix work of one MoE stack pass over ``tokens`` routing
    together, as the program does it: per token the attention
    projections, the router and the shared experts; per expert its E x C
    capacity slots (C from :func:`repro_torch.models.moe._capacity`),
    not the routes the tokens take (``routed``: the T K routes
    instead)."""
    m, d = cfg.moe, cfg.d_model
    specs = registry.param_specs(cfg)["layers"]
    attn = sum(sp.numel() for sp in layers.spec_leaves(specs["attn"])
               if len(sp.shape) >= 4) // cfg.n_layers
    per_token = attn + d * m.n_routed + 3 * d * m.n_shared * m.d_ff_expert
    slots = tokens * m.top_k if routed else \
        moe._padded_experts(cfg) * moe._capacity(tokens, cfg)
    return 2 * cfg.n_layers * (tokens * per_token +
                               slots * 3 * d * m.d_ff_expert)


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(params))


def moe_loss_bound(cfg, params, b: int, s: int) -> dict:
    """A loss's least time: every weight read once, against the bf16
    matrix work of :func:`moe_flops` over the B x S tokens (which route
    together), the head over B (S - 1) positions and the causal
    attention."""
    flops = moe_flops(cfg, b * s) + \
        2 * b * (s - 1) * cfg.d_model * cfg.vocab_size + \
        attention_flops(b, s, cfg.n_heads, cfg.head_dim_, True) * \
        cfg.n_layers
    bound_ms, bound_by = bound(param_bytes(params) + 4, flops,
                               BF16_TC_OPS_PER_S)
    return {"bound_ms_computed": bound_ms, "bound_by": bound_by,
            "bound_counts": "E x C capacity slots a layer, not active "
            "tokens", "bound_flops": flops}


def moe_step_bound(cfg, params, b: int, kv_lens) -> dict:
    """One MoE decode step's least time: every weight but the embedding
    read once (the capacity dispatch runs every expert on its C slots,
    so it reads every expert's weights; ROADMAP item 25), the K/V read
    over ``kv_lens`` and one row written a layer, against the bf16
    matrix work of :func:`moe_flops` over the B rows."""
    esize = params["embed"].element_size()
    weights = param_bytes(params) - params["embed"].numel() * esize + \
        b * cfg.d_model * esize
    kv = 2 * cfg.n_layers * (sum(kv_lens) + b) * cfg.n_kv_heads * \
        cfg.head_dim_ * esize
    flops = moe_flops(cfg, b) + 2 * b * cfg.d_model * cfg.vocab_size
    bound_ms, bound_by = bound(weights + kv, flops, BF16_TC_OPS_PER_S)
    return {"bound_ms_computed": bound_ms, "bound_by": bound_by,
            "bound_weight_bytes": weights, "bound_kv_bytes": kv,
            "bound_flops": flops}


def check_loss(value: float, cfg, what: str, slack: float = 2.0) -> None:
    check(math.isfinite(value)
          and abs(value - math.log(cfg.vocab_size)) < slack,
          f"{what}: loss {value}, want near ln V = "
          f"{math.log(cfg.vocab_size)}")


def family_kernel_rows():
    """The kernels against their plain versions at this slice's new
    shapes (bf16, as the full-width phases run them, and float32):
    attention at seamless-m4t-medium's encoder (non-causal) and decoder
    (causal), at the MoE losses' heads (qwen2-moe-a2.7b's B = 2; deepseek
    runs B = 1 at the same heads) and at internvl2-26b's heads; flash
    decode at the MoE serve,
    seamless's self and cross caches and internvl2's group of 6; RMSNorm
    at the widths 1024, 3200 (the vlm projector), 2048 and 6144."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    rows = []
    serve = np.random.default_rng(6).integers(9, 41, 8).tolist()
    for dtype in (torch.float32, torch.bfloat16):
        rate = BF16_TC_OPS_PER_S if dtype == torch.bfloat16 \
            else ALU_OPS_PER_S
        for label, b, s, hq, hkv, d, causal in (
                ("seamless encoder", 2, 1024, 16, 16, 64, False),
                ("seamless decoder", 2, 1023, 16, 16, 64, True),
                ("qwen2-moe / deepseek", 2, 2048, 16, 16, 128, True),
                ("internvl2", 1, 2048, 48, 8, 128, True)):
            q = torch.randn(b, s, hq, d, generator=gen, device=dev).to(dtype)
            k = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(dtype)
            v = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(dtype)
            kernel = lambda: fa.flash_attention(q, k, v, causal)
            plain = lambda: fa.flash_attention_plain(q, k, v, causal)
            err = within(kernel(), plain(), dtype)
            nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            flops = attention_flops(b, s, hq, d, causal)
            bound_ms, bound_by = bound(nbytes, flops, rate)
            row = {"kernel": "flash_attention", "dtype": str(dtype),
                   "shape": f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
                   f"causal={causal}", "label": label, "max_abs_err": err,
                   **time_case(kernel, plain,
                               sdpa_causal_library(q, k, v, causal), 20),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            row["tflops"] = flops / row["ms"] / 1e9
            rows.append(row)
        for label, b, hq, hkv, d, s_max, lens in (
                ("moe serve", 8, 16, 16, 128, 2048, serve),
                ("seamless self", 8, 16, 16, 64, 2048, serve),
                ("seamless cross", 8, 16, 16, 64, 2048, [2048] * 8),
                ("internvl2 decode", 1, 48, 8, 128, 2048, [328])):
            q = torch.randn(b, hq, d, generator=gen, device=dev).to(dtype)
            k = torch.randn(b, s_max, hkv, d, generator=gen,
                            device=dev).to(dtype)
            v = torch.randn(b, s_max, hkv, d, generator=gen,
                            device=dev).to(dtype)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            kernel = lambda: fd.flash_decode(q, k, v, kv_len)
            plain = lambda: fd.flash_decode_plain(q, k, v, kv_len)
            err = within(kernel(), plain(), dtype)
            keys = sum(lens)
            esize = q.element_size()
            bound_ms, bound_by = bound(
                2 * q.numel() * esize + 4 * b + 2 * keys * hkv * d * esize,
                4 * d * hq * keys)
            rows.append({"kernel": "flash_decode", "dtype": str(dtype),
                         "shape": f"B={b} Hq={hq} Hkv={hkv} D={d} "
                         f"S_max={s_max}", "label": label, "lengths": lens,
                         "max_abs_err": err,
                         **time_case(kernel, plain,
                                     sdpa_library(q, k, v, kv_len)),
                         "bound_ms": bound_ms, "bound_by": bound_by})
    rows += rmsnorm_rows(((2048, 1024), (256, 3200), (8, 2048),
                          (2048, 6144)), gen, 50)
    for r in rows:
        emit({"phase": 31, "part": "kernels", **r})
    return rows


def phase28_deepseek():
    """deepseek-moe-16b at full width (28 layers, bf16 weights from seed
    0): ``loss_fn`` on 1 x 2048 tokens, then ``prefill_fn`` of 1 x 64
    into a preallocated cache and 8 decode steps continuing it, launches
    counted; the router margin of a diagnostic forward.  Returns the
    launches."""
    arch = registry.get(DEEPSEEK)
    cfg = arch.cfg
    params = arch.init_params(0, "cuda", torch.bfloat16)
    rt = Runtime()
    b, s = 1, 2048
    batch = {"tokens": seeded_tokens(cfg, b, s, seed=128)}
    fwd = decoder_launches(cfg, "flash_attention")
    step = decoder_launches(cfg, "flash_decode")
    fn = lambda: arch.loss_fn()(params, cfg, batch, rt)
    ops.reset_launch_counts()                 # the path starts here
    cold, cold_s = run_counted(fn, fwd, "deepseek loss (cold)")
    res, wall = run_counted(fn, fwd, "deepseek loss")
    n_p, n_d = 64, 8
    cache = layers.map_specs(
        lambda sp: torch.zeros(sp.shape, dtype=torch.bfloat16,
                               device="cuda"),
        arch.cache_specs(ShapeConfig("x", n_p + n_d, b, "decode")))
    prompt = {"tokens": batch["tokens"][:, :n_p]}
    (logits, _), prefill_s = run_counted(
        lambda: arch.prefill_fn()(params, prompt, rt, cache), fwd,
        "deepseek prefill")
    decode = arch.decode_fn()

    def decode_steps():
        out = []
        for t in range(n_d):
            out.append(decode(params, cfg, cache,
                              batch["tokens"][:, n_p + t:n_p + t + 1],
                              torch.full((b,), n_p + t, dtype=torch.int32,
                                         device="cuda"), rt)[0])
        return out

    outs, decode_s = run_counted(
        decode_steps, {k: v * n_d for k, v in step.items()},
        "deepseek decode")
    launches = ops.launch_counts()            # ... and ends here
    value = float(res)
    check_loss(value, cfg, "deepseek")
    check(all(bool(torch.isfinite(o.float()).all()) for o in [logits, *outs]),
          "deepseek: non-finite logits")
    with RouterProbe() as probe:
        transformer.forward(params, cfg, transformer.embed(
            params, cfg, batch["tokens"]), rt)
    emit({"phase": 28, "model": cfg.name, "layers": cfg.n_layers,
          "params": cfg.param_count(),
          "active_params": cfg.active_param_count(), "batch": b, "seq": s,
          "loss": value, "ln_vocab": math.log(cfg.vocab_size),
          "same_as_cold_run": float(cold) == value,
          "launches_per_forward": fwd, "launches_per_decode_step": step,
          "launches": launches, "cold_wall_s": cold_s, "wall_s": wall,
          "tokens_per_s": b * s / wall, "prefill_tokens": n_p,
          "prefill_wall_s": prefill_s, "decode_steps": n_d,
          "decode_wall_ms_per_step": decode_s / n_d * 1e3,
          "router": probe.stats, **moe_loss_bound(cfg, params, b, s)})
    del params, cache, res, cold, logits, outs
    torch.cuda.empty_cache()
    return launches


def vlm_patches(cfg, b: int, seed: int) -> torch.Tensor:
    """Seeded patch embeddings at ``input_specs``' shape and dtype."""
    spec = registry.input_specs(cfg, ShapeConfig("x", 2048, b, "train"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(spec["patches"].shape, generator=gen,
                       device="cuda").to(spec["patches"].dtype)


def phase29_internvl2():
    """internvl2-26b at full width (48 layers, bf16 weights from seed 0):
    ``vlm_loss`` on 1 x (256 patches + 1792 text tokens) at
    ``input_specs``' shapes, then the prefill of 256 + 64 positions into
    a preallocated cache and 8 decode steps, launches counted (2 / 96 /
    48 a forward).  Returns the launches."""
    arch = registry.get(INTERNVL)
    cfg = arch.cfg
    params = arch.init_params(0, "cuda", torch.bfloat16)
    rt = Runtime()
    b, s = 1, 2048
    specs = arch.input_specs(ShapeConfig("x", s, b, "train"))
    n_p = cfg.vlm.n_patches
    check(tuple(specs["tokens"].shape) == (b, s - n_p),
          f"internvl2 input_specs {specs}")
    batch = {"patches": vlm_patches(cfg, b, seed=129),
             "tokens": seeded_tokens(cfg, b, s - n_p, seed=129)
             .to(torch.int32)}
    fwd = decoder_launches(cfg, "flash_attention")
    fwd["rms_norm"] += 1                      # the projector's norm
    step = decoder_launches(cfg, "flash_decode")
    fn = lambda: arch.loss_fn()(params, cfg, batch, rt)
    ops.reset_launch_counts()
    cold, cold_s = run_counted(fn, fwd, "internvl2 loss (cold)")
    res, wall = run_counted(fn, fwd, "internvl2 loss")
    value = float(res)
    check_loss(value, cfg, "internvl2")
    n_t, n_d = 64, 8
    cache = layers.map_specs(
        lambda sp: torch.zeros(sp.shape, dtype=torch.bfloat16,
                               device="cuda"),
        arch.cache_specs(ShapeConfig("x", n_p + n_t + n_d, b, "decode")))
    prompt = {"patches": batch["patches"],
              "tokens": batch["tokens"][:, :n_t]}
    (logits, _), prefill_s = run_counted(
        lambda: arch.prefill_fn()(params, prompt, rt, cache), fwd,
        "internvl2 prefill")
    decode = arch.decode_fn()

    def decode_steps():
        return [decode(params, cfg, cache,
                       batch["tokens"][:, n_t + t:n_t + t + 1],
                       torch.full((b,), n_p + n_t + t, dtype=torch.int32,
                                  device="cuda"), rt)[0]
                for t in range(n_d)]

    outs, decode_s = run_counted(
        decode_steps, {k: v * n_d for k, v in step.items()},
        "internvl2 decode")
    launches = ops.launch_counts()
    check(all(bool(torch.isfinite(o.float()).all()) for o in [logits, *outs]),
          "internvl2: non-finite logits")
    projector = 2 * b * n_p * (cfg.vlm.vision_dim + cfg.d_model) * \
        cfg.d_model
    extra = attention_flops(b, s, cfg.n_heads, cfg.head_dim_, True) * \
        cfg.n_layers + projector
    emit({"phase": 29, "model": cfg.name, "layers": cfg.n_layers,
          "params": cfg.param_count(), "batch": b, "patches": n_p,
          "text": s - n_p, "loss": value,
          "ln_vocab": math.log(cfg.vocab_size),
          "same_as_cold_run": float(cold) == value,
          "launches_per_forward": fwd, "launches_per_decode_step": step,
          "launches": launches, "cold_wall_s": cold_s, "wall_s": wall,
          "tokens_per_s": b * s / wall, "prefill_positions": n_p + n_t,
          "prefill_wall_s": prefill_s, "decode_steps": n_d,
          "decode_wall_ms_per_step": decode_s / n_d * 1e3,
          **forward_bound(cfg, params, b * s, b * (s - n_p), extra, 4)})
    del params, cache, res, cold, logits, outs
    torch.cuda.empty_cache()
    return launches


def seamless_batch(cfg, b: int, half: int, seed: int) -> dict:
    """Seeded frames and tokens at ``input_specs``' shapes and dtypes."""
    spec = registry.input_specs(cfg, ShapeConfig("x", 2 * half, b, "train"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {"frames": torch.randn(spec["frames"].shape, generator=gen,
                                  device="cuda").to(spec["frames"].dtype),
            "tokens": seeded_tokens(cfg, b, half, seed).to(torch.int32)}


def check_serve(rep, report, requests, per_step: dict, launches: dict,
                what: str) -> None:
    """Drained with every token, the launches exactly ``per_step`` a
    decode step and one watermark kernel a streamed round."""
    serve = report.extras["serve"]
    n_req = sum(len(r) for r in requests)
    want_tokens = sum(r.max_new_tokens for per in requests for r in per)
    check(serve["drained"] and serve["requests"] == n_req
          and serve["tokens"] == want_tokens, f"{what}: {serve}")
    want = {k: 0 for k in launches}
    want.update({k: n * serve["decode_steps"] for k, n in per_step.items()})
    want["smc_sweep_watermark"] = report.extras["streamed_rounds"]
    check(launches == want, f"{what}: launches {launches}, want {want}")
    vocab = rep.engines[0].cfg.vocab_size
    for stream in (t for per in rep.completed().values() for t in per):
        check(all(0 <= x < vocab for x in stream),
              f"{what}: bad token stream {stream}")


def phase30_seamless():
    """seamless-m4t-medium at full width (12 + 12 layers, bf16 weights
    from seed 0): ``seq2seq_loss`` on 2 x (1024 frames + 1024 tokens)
    (12 non-causal and 12 causal flash attention, 2 / 60 norms),
    ``prefill_fn`` (the encoder) on the frames, and serving on phase 6's
    layout per round (12 self and 12 cross flash decode a step).
    Returns the launches and the serve setup (for the device part)."""
    cfg = registry.get(SEAMLESS).cfg
    params, rep = serve_setup(cfg, torch.bfloat16, seed=0)
    arch = registry.Arch(cfg)
    for eng in rep.engines:
        check(all(v.dtype == torch.bfloat16 for v in eng.cache.values())
              and sorted(eng.cache) == ["cross_k", "cross_v", "k", "v"],
              f"seamless engine cache {[(k, v.dtype) for k, v in eng.cache.items()]}")
    b, half = 2, 1024
    batch = seamless_batch(cfg, b, half, seed=130)
    loss_want = encdec_launches(cfg, step=False)
    step_want = encdec_launches(cfg, step=True)
    fn = lambda: arch.loss_fn()(params, cfg, batch, Runtime())
    ops.reset_launch_counts()
    cold, cold_s = run_counted(fn, loss_want, "seamless loss (cold)")
    res, wall = run_counted(fn, loss_want, "seamless loss")
    (memory, empty), enc_s = run_counted(
        lambda: arch.prefill_fn()(params, batch, Runtime()),
        encoder_launches(cfg), "seamless encode")
    check(memory.shape == (b, half, cfg.d_model) and empty == {}
          and bool(torch.isfinite(memory.float()).all()),
          "seamless encode: bad memory")
    launches = ops.launch_counts()
    value = float(res)
    check_loss(value, cfg, "seamless")
    _, split = split_counts(lambda: arch.loss_fn()(params, cfg, batch,
                                                   SplitCountRuntime()))
    e, d = cfg.encdec.n_encoder_layers, cfg.encdec.n_decoder_layers
    check(split == {"non_causal": e, "causal": d},
          f"seamless loss attention calls {split}")
    requests = serve_requests(api.Request, cfg.vocab_size,
                              FAMILIES_PER_REPLICA, seed=1)
    ops.reset_launch_counts()
    report = round_run(rep, requests)
    serve_launches = ops.launch_counts()
    check_serve(rep, report, requests, step_want, serve_launches,
                "seamless serve")
    eng = rep.engines[0]
    tokens, pos, valid = step_inputs(eng, 16)
    _, step_split = split_counts(lambda: encdec.decode_step(
        params, cfg, eng.cache, tokens, pos, SplitCountRuntime(), valid))
    check(step_split == {"self": d, "cross": d},
          f"seamless decode step attention calls {step_split}")
    serve = report.extras["serve"]
    emit({"phase": 30, "model": cfg.name,
          "layers": [e, d], "params": cfg.param_count(), "batch": b,
          "frames": half, "tokens": half, "loss": value,
          "ln_vocab": math.log(cfg.vocab_size),
          "same_as_cold_run": float(cold) == value,
          "launches_per_loss": loss_want, "attention_split_loss": split,
          "launches_per_decode_step": step_want,
          "attention_split_decode_step": step_split,
          "cold_wall_s": cold_s, "wall_s": wall,
          "tokens_per_s": b * 2 * half / wall, "encode_wall_s": enc_s,
          "serve": {"replicas": 2, "slots": 8, "max_len": 2048,
                    "window": 8, "backend": "kernel",
                    "requests": serve["requests"],
                    "tokens": serve["tokens"],
                    "tokens_per_s": serve["tokens_per_s"],
                    "wall_s": serve["wall_s"],
                    "decode_steps": serve["decode_steps"],
                    "wall_ms_per_decode_step":
                        serve["wall_s"] / serve["decode_steps"] * 1e3,
                    "launches": serve_launches}})
    for k, v in serve_launches.items():
        launches[k] = launches.get(k, 0) + v
    del res, cold, memory
    torch.cuda.empty_cache()
    return launches, (cfg, params, rep)


def phase26_moe_loss(cfg, params):
    """qwen2-moe-a2.7b's loss at full width (24 layers, bf16 weights from
    seed 0) on 2 x 2048 tokens: 1 / 48 / 24 launches a forward, the loss
    beside ln V, the aux term and the routes dropped (a diagnostic
    forward), tokens/s and the computed bound.  Returns the launches."""
    arch = registry.Arch(cfg)
    rt = Runtime()
    b, s = 2, 2048
    batch = {"tokens": seeded_tokens(cfg, b, s, seed=126)}
    want = decoder_launches(cfg, "flash_attention")
    fn = lambda: arch.loss_fn()(params, cfg, batch, rt)
    ops.reset_launch_counts()
    cold, cold_s = run_counted(fn, want, "qwen2-moe loss (cold)")
    res, wall = run_counted(fn, want, "qwen2-moe loss")
    launches = ops.launch_counts()
    value = float(res)
    check_loss(value, cfg, "qwen2-moe")
    with RouterProbe() as probe:
        _, aux = transformer.forward(params, cfg, transformer.embed(
            params, cfg, batch["tokens"]), rt)
    emit({"phase": 26, "model": cfg.name, "layers": cfg.n_layers,
          "params": cfg.param_count(),
          "active_params": cfg.active_param_count(),
          "experts": [cfg.moe.n_routed, moe._padded_experts(cfg)],
          "capacity": moe._capacity(b * s, cfg), "batch": b, "seq": s,
          "loss": value, "ln_vocab": math.log(cfg.vocab_size),
          "aux": float(aux), "router": probe.stats,
          "same_as_cold_run": float(cold) == value,
          "launches_per_forward": want, "launches": launches,
          "cold_wall_s": cold_s, "wall_s": wall,
          "tokens_per_s": b * s / wall,
          **moe_loss_bound(cfg, params, b, s)})
    del res, cold
    torch.cuda.empty_cache()
    return launches


def phase27_moe_serve(cfg, params, rep_k):
    """qwen2-moe-a2.7b (``cfg``: 4 of its 24 layers) served on phase 6's
    layout (2 replicas x 8 slots x 2048 positions, window 8, 16 requests
    a replica): per round on the ``kernel`` backend with 1 / 8 / 4
    launches a decode step, then
    ``run(fused=True)`` identical to it, host_hops 0, one capture cold
    and none warm.  C = 8 >= T = 8, so no route drops.  Returns the
    per-round run's launches and the fused run's figures."""
    check(moe._capacity(8, cfg) >= 8,
          f"serve capacity {moe._capacity(8, cfg)} < 8 rows")
    requests = serve_requests(api.Request, cfg.vocab_size,
                              FAMILIES_PER_REPLICA, seed=1)
    per_step = decoder_launches(cfg, "flash_decode")
    ops.reset_launch_counts()
    report = round_run(rep_k, requests)
    launches = ops.launch_counts()
    check_serve(rep_k, report, requests, per_step, launches,
                "qwen2-moe serve")
    want_traces = serve_traces(rep_k, report)
    serve = report.extras["serve"]
    eng = rep_k.engines[0]
    tokens, pos, valid = step_inputs(eng, 16)
    logits, _ = eng.decode(params, eng.cache, tokens, pos, valid)
    check(bool(torch.isfinite(logits.float()).all()),
          "qwen2-moe: non-finite logits")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(10):
        eng.decode(params, eng.cache, tokens, pos, valid)
    torch.cuda.synchronize()
    step_wall_ms = (time.perf_counter() - t1) / 10 * 1e3
    t1 = time.perf_counter()
    cold, cold_reads, cold_caps = fused_run(rep_k, requests)
    same_serve(serve_traces(rep_k, cold), want_traces, cold, report,
               "qwen2-moe fused cold vs per-round")
    t2 = time.perf_counter()
    warm, reads, caps = fused_run(rep_k, requests)
    same_serve(serve_traces(rep_k, warm), want_traces, warm, report,
               "qwen2-moe fused warm vs per-round")
    check(cold_caps == 1 and caps == 0,
          f"qwen2-moe fused: {cold_caps} captures cold, {caps} warm "
          "(want 1, 0)")
    wserve = warm.extras["serve"]
    (prog,) = rep_k._fused_programs.values()
    device_steps = fused_device_steps(rep_k, requests)
    fused_row = {"device_decode_steps": device_steps,
                 "warm_wall_ms_per_device_step":
                     wserve["wall_s"] / device_steps * 1e3}
    emit({"phase": 27, "model": cfg.name, "layers": cfg.n_layers,
          "replicas": 2, "slots": 8, "max_len": 2048, "window": 8,
          "backend": "kernel", "requests": serve["requests"],
          "capacity_at_8_rows": moe._capacity(8, cfg),
          "launches": launches, "launches_per_decode_step": per_step,
          "per_round": {k: serve[k] for k in (
              "tokens", "tokens_per_s", "wall_s", "engine_rounds",
              "decode_steps", "host_hops")},
          "wall_ms_per_decode_step": serve["wall_s"]
          / serve["decode_steps"] * 1e3,
          "decode_step_alone_wall_ms": step_wall_ms,
          "fused": {"identical_to_per_round": True,
                    "cold_wall_s": t2 - t1,
                    "cold_tokens_per_s": cold.extras["serve"][
                        "tokens_per_s"],
                    "warm": {k: wserve[k] for k in (
                        "tokens", "tokens_per_s", "wall_s",
                        "fused_rounds", "host_hops")},
                    "flag_reads": {"cold": cold_reads, "warm": reads},
                    "captures": {"cold": cold_caps, "warm": caps},
                    "capture_s": prog.capture_s, "graph_nodes": prog.nodes,
                    "graph_pool_bytes": prog.pool_bytes, **fused_row},
          "decode_step_bound": moe_step_bound(
              cfg, params, 8, (pos + 1).tolist())})
    return launches, fused_row


def families_device_phase(cfg, params, served, fused_row, seamless):
    """The profiled figures of phases 26-30, after every timed run of
    this process: one qwen2-moe-a2.7b decode step traced on phase 27's
    engines (``served``: their config, parameters and replicas; the body
    the fused program replays; device time and operations beside the
    byte bound, and beside the untraced fused run's wall a device step),
    each full-width forward profiled (device time, busy share, per
    kernel) and one seamless decode step.  Phase 27's fused run is not
    traced (its 36 replays of a graph crashed the profiler's collection
    at 24 layers); a short fused epoch is (:func:`fused_short_trace`)."""
    scfg, sparams, rep_k = served
    eng = rep_k.engines[0]
    tokens, pos, valid = step_inputs(eng, 16)
    dev_ms, dev_ops = profiled_device(
        lambda: eng.decode(sparams, eng.cache, tokens, pos, valid), 5)
    check(dev_ms is not None, "qwen2-moe: no device time profiled")
    top = profile_forward(lambda: eng.decode(sparams, eng.cache, tokens,
                                             pos, valid))[
        "top_device_ops_ms"]
    b = moe_step_bound(scfg, sparams, 8, (pos + 1).tolist())
    emit({"phase": 27, "part": "device",
          "one_step_device_ms": dev_ms, "one_step_device_ops": dev_ops,
          "top_device_ops_ms_one_step": top,
          "bound_ms_computed": b["bound_ms_computed"],
          "one_step_device_over_bound": dev_ms / b["bound_ms_computed"],
          "fused_warm_wall_ms_per_device_step":
              fused_row["warm_wall_ms_per_device_step"]})
    emit({"phase": 27, "part": "fused device",
          **fused_short_trace(rep_k, scfg)})
    batch = {"tokens": seeded_tokens(cfg, 2, 2048, seed=126)}
    emit({"phase": 26, "part": "device", **profile_forward(
        lambda: registry.Arch(cfg).loss_fn()(params, cfg, batch,
                                             Runtime()))})
    scfg, sparams, srep = seamless
    eng = srep.engines[0]
    tokens, pos, valid = step_inputs(eng, 16)
    dev_ms, dev_ops = profiled_device(
        lambda: eng.decode(sparams, eng.cache, tokens, pos, valid), 5)
    sbatch = seamless_batch(scfg, 2, 1024, seed=130)
    emit({"phase": 30, "part": "device", "loss": profile_forward(
        lambda: registry.Arch(scfg).loss_fn()(sparams, scfg, sbatch,
                                              Runtime())),
        "decode_step_device_ms": dev_ms, "decode_step_device_ops": dev_ops})


def fused_short_trace(rep, cfg) -> dict:
    """A short fused epoch traced: one request a replica (a program of its
    own epoch shape, captured and run once untraced first), its device
    time and operations a device decode step beside its wall a device
    step, the run identical to the per-round loop's."""
    from torch.profiler import ProfilerActivity, profile
    requests = serve_requests(api.Request, cfg.vocab_size, 1, seed=27)
    base = round_run(rep, requests)
    want = serve_traces(rep, base)
    fused_run(rep, requests)
    submit_all(rep, requests)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report = rep.run(fused=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(report.extras["serve"]["fused"] is True
          and report.extras["serve"]["host_hops"] == 0,
          f"short fused epoch: {report.extras['serve']}")
    same_serve(serve_traces(rep, report), want, report, base,
               "short fused epoch vs per-round")
    steps_ = fused_device_steps(rep, requests)
    events = [e for e in prof.key_averages() if device_us(e) > 0]
    busy_us = sum(device_us(e) for e in events)
    check(busy_us > 0, "short fused epoch: no device time profiled")
    top = sorted(events, key=device_us, reverse=True)[:6]
    return {"requests_per_replica": 1,
            "fused_rounds": report.extras["serve"]["fused_rounds"],
            "device_decode_steps": steps_, "wall_s": wall,
            "device_ms_per_device_step": busy_us / 1e3 / steps_,
            "device_ops_per_device_step":
                sum(e.count for e in events) / steps_,
            "wall_ms_per_device_step": wall / steps_ * 1e3,
            "device_busy_share": busy_us / 1e6 / wall,
            "top_device_ops_ms": {e.key[:60]: device_us(e) / 1e3
                                  for e in top}}


def families_forward_profiles():
    """Device time of the deepseek-moe-16b and internvl2-26b losses of
    phases 28-29 (weights re-made from seed 0)."""
    for phase, name in ((28, DEEPSEEK), (29, INTERNVL)):
        arch = registry.get(name)
        cfg = arch.cfg
        params = arch.init_params(0, "cuda", torch.bfloat16)
        if name == DEEPSEEK:
            batch = {"tokens": seeded_tokens(cfg, 1, 2048, seed=128)}
        else:
            batch = {"patches": vlm_patches(cfg, 1, seed=129),
                     "tokens": seeded_tokens(cfg, 1, 2048 - 256, seed=129)
                     .to(torch.int32)}
        emit({"phase": phase, "part": "device", **profile_forward(
            lambda: arch.loss_fn()(params, cfg, batch, Runtime()))})
        del params
        torch.cuda.empty_cache()


def cut_layers(cfg):
    """``cfg`` at full width with 4 layers (encdec: 2 + 2)."""
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=4, encdec=dataclasses.replace(
            cfg.encdec, n_encoder_layers=2, n_decoder_layers=2))
    return dataclasses.replace(cfg, n_layers=4)


def relative(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


# a router gap under this makes a kernels-vs-plain or a path comparison
# one of tie-breaking, not of the port
TIE_GAP = 1e-5
# phase 31's token (and patch, frame) seeds; the MoE's chosen by the
# printed router margin (:func:`moe_seed_search`)
F32_FORWARD_SEEDS = {MOE_SERVED: 337, INTERNVL: 131, SEAMLESS: 131}
MOE_SEED_SEARCH_FLAG = "--moe-seed-search"


def check_margin(stats: dict, what: str) -> None:
    check(stats["min_router_gap"] > TIE_GAP,
          f"{what}: smallest router gap {stats['min_router_gap']} is a "
          f"near tie (<= {TIE_GAP}); the seed must be chosen by it")


def phase31_families_f32():
    """The families in float32 at 4 layers (encdec 2 + 2), full width:
    serving on the kernels against the plain versions (phase 7's rule)
    for qwen2-moe-a2.7b and seamless-m4t-medium, the MoE's batched
    tokens against each request served alone, every forward's loss and
    logits on the kernels against the plain versions, the MoE forward
    against prefill then decode with ``capacity_factor = E / K`` and the
    vlm's likewise, within 1e-4; every forward, prefill and decode step
    launch-counted (the kernels on the kernel side, none on the plain
    side); the router margins printed, the MoE forwards' held over
    :data:`TIE_GAP`."""
    out = {}
    rt, plain = Runtime(), Runtime(kernels="plain")
    per_replica = 6
    # serving: the MoE and the encdec
    for name in (MOE_SERVED, SEAMLESS):
        cfg = cut_layers(registry.get(name).cfg)
        per_step = {"flash_decode": 4} if cfg.family == "encdec" \
            else {"flash_decode": cfg.n_layers}
        with RouterProbe() as probe:
            record, batched = serve_kernels_vs_plain(
                cfg, lambda rep: serve_run(rep, per_replica, seed=4),
                per_step, f"phase 31 {name}")
        out[f"{name} serve"] = {**record, "router": probe.stats}
        if cfg.family == "moe":
            check(probe.stats["routes_dropped"] == 0,
                  f"phase 31 {name}: the serve dropped routes")
            params, rep = serve_setup(cfg, torch.float32, seed=2)
            requests = serve_requests(api.Request, cfg.vocab_size,
                                      per_replica, seed=4)
            for g, per in enumerate(requests):
                for req in per:
                    solo = [[] for _ in requests]
                    solo[g] = [req]
                    round_run(rep, solo)
                    got = tokens_of(rep, req.rid)
                    check(got == batched[req.rid],
                          f"phase 31 {name}: request {req.rid} batched "
                          f"{batched[req.rid]} != solo {got}")
            out[f"{name} serve"]["batched_equals_solo"] = True
            del params, rep
            torch.cuda.empty_cache()
    # the forwards on the kernels against the plain versions, each run
    # counted: the kernel runs launch the kernels, the plain runs none
    b, s = 2, 256
    for name in (MOE_SERVED, INTERNVL, SEAMLESS):
        cfg = cut_layers(registry.get(name).cfg)
        arch = registry.Arch(cfg)
        params = arch.init_params(3, "cuda", torch.float32)
        seed = F32_FORWARD_SEEDS[name]
        if cfg.family == "encdec":
            batch = seamless_batch(cfg, b, s // 2, seed=seed)
            batch["frames"] = batch["frames"].float()
            fwd, pre = encdec_launches(cfg, False), encoder_launches(cfg)
            step_want = encdec_launches(cfg, True)
        else:
            if cfg.family == "vlm":
                batch = {"patches": vlm_patches(cfg, b, seed=seed).float(),
                         "tokens": seeded_tokens(cfg, b, s, seed=seed)
                         .to(torch.int32)}
            else:
                batch = {"tokens": seeded_tokens(cfg, b, s, seed=seed)}
            fwd = decoder_launches(cfg, "flash_attention")
            if cfg.family == "vlm":
                fwd["rms_norm"] += 1              # the projector's norm
            pre, step_want = fwd, decoder_launches(cfg, "flash_decode")
        what = f"phase 31 {name}"
        with RouterProbe() as probe:
            loss_k, _ = run_counted(
                lambda: arch.loss_fn()(params, cfg, batch, rt), fwd,
                f"{what} loss")
            loss_p, _ = run_counted(
                lambda: arch.loss_fn()(params, cfg, batch, plain), {},
                f"{what} plain loss")
            (first, _), _ = run_counted(
                lambda: arch.prefill_fn()(params, batch, rt), pre,
                f"{what} prefill")
            (want, _), _ = run_counted(
                lambda: arch.prefill_fn()(params, batch, plain), {},
                f"{what} plain prefill")
        rel = relative(loss_k, loss_p)
        check(rel <= LOSS_RTOL, f"{what}: loss {float(loss_k)} "
              f"vs plain {float(loss_p)}")
        row = {"seed": seed, "loss_kernels": float(loss_k),
               "loss_plain": float(loss_p), "loss_rel_err": rel,
               "launches_per_forward": fwd, "launches_per_prefill": pre,
               "launches_per_decode_step": step_want}
        if cfg.moe is not None:
            row["router"] = probe.stats
            check_margin(probe.stats, what)
        row["prefill_max_abs_err"] = within(
            first, want, torch.float32, FORWARD_TOL, f"{what} prefill")
        if cfg.family == "encdec":
            # one decode step over the encoder's memory as the cross cache
            spec = arch.cache_specs(ShapeConfig("x", s, b, "decode"))
            logits = {}
            for key, r, launched in (("kernels", rt, step_want),
                                     ("plain", plain, {})):
                cache = layers.map_specs(
                    lambda sp: torch.zeros(sp.shape, device="cuda"), spec)
                for i in range(cfg.encdec.n_decoder_layers):
                    lp = transformer.layer_params(params["decoder"], i)
                    for leaf, w in (("cross_k", "wk"), ("cross_v", "wv")):
                        cache[leaf][i, :, :s // 2] = attention._heads(
                            first, lp["cross"][w])
                (logits[key], _), _ = run_counted(
                    lambda: encdec.decode_step(
                        params, cfg, cache, batch["tokens"][:, :1],
                        torch.zeros(b, dtype=torch.int32, device="cuda"),
                        r), launched, f"{what} {key} decode step")
            row["decode_step_max_abs_err"] = within(
                logits["kernels"], logits["plain"], torch.float32,
                FORWARD_TOL, f"{what} decode step")
        else:
            # prefill of S - 1 then one decode step against the forward
            # (the MoE with capacity_factor = E / K: C >= T, no drops)
            if cfg.moe is not None:
                m = cfg.moe
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    m, capacity_factor=moe._padded_experts(cfg) / m.top_k))
                arch = registry.Arch(cfg)
                check(moe._capacity(b * s, cfg) >= b * s,
                      "phase 31: capacity below the tokens")
            n = s + (cfg.vlm.n_patches if cfg.vlm else 0)
            cache = layers.map_specs(
                lambda sp: torch.zeros(sp.shape, device="cuda"),
                arch.cache_specs(ShapeConfig("x", n, b, "decode")))
            short = dict(batch, tokens=batch["tokens"][:, :-1])
            with RouterProbe() as probe:
                (full, _), _ = run_counted(
                    lambda: arch.prefill_fn()(params, batch, rt), pre,
                    f"{what} prefill at capacity_factor E / K")
                run_counted(lambda: arch.prefill_fn()(params, short, rt,
                                                      cache),
                            pre, f"{what} prefill of S - 1")
                (step, _), _ = run_counted(
                    lambda: arch.decode_fn()(
                        params, cfg, cache, batch["tokens"][:, -1:],
                        torch.full((b,), n - 1, dtype=torch.int32,
                                   device="cuda"), rt),
                    step_want, f"{what} decode step")
            row["prefill_decode_vs_forward_max_abs_err"] = within(
                step, full, torch.float32, 1e-4,
                f"{what} prefill -> decode vs forward")
            if cfg.moe is not None:
                check(probe.stats["routes_dropped"] == 0,
                      "phase 31: routes dropped at capacity_factor E / K")
                check_margin(probe.stats, f"{what} prefill -> decode")
                row["capacity_factor_e_over_k"] = cfg.moe.capacity_factor
                row["router_prefill_decode"] = probe.stats
        out[f"{name} forward"] = row
        del params
        torch.cuda.empty_cache()
    emit({"phase": 31, "dtype": "float32", "layers": "4 (encdec 2 + 2)",
          "logits_tol": FORWARD_TOL, "loss_rtol": LOSS_RTOL,
          "path_tol": 1e-4, **out})


def phase31_seed_runs():
    """Phase 31's MoE forwards for one token seed, in the order the
    search tries them: the kernels' loss; the plain loss and both
    prefills at capacity factor 1.25; at E / K the prefill, the prefill
    of S - 1 and the decode step."""
    cfg = cut_layers(registry.get(MOE_SERVED).cfg)
    arch = registry.Arch(cfg)
    params = arch.init_params(3, "cuda", torch.float32)
    m = cfg.moe
    wide = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=moe._padded_experts(cfg) / m.top_k))
    arch_w = registry.Arch(wide)
    rt, plain = Runtime(), Runtime(kernels="plain")
    b, s = 2, 256

    def runs(seed: int):
        batch = {"tokens": seeded_tokens(cfg, b, s, seed)}
        short = dict(batch, tokens=batch["tokens"][:, :-1])
        cache = layers.map_specs(
            lambda sp: torch.zeros(sp.shape, device="cuda"),
            arch_w.cache_specs(ShapeConfig("x", s, b, "decode")))
        return (lambda: arch.loss_fn()(params, cfg, batch, rt),
                lambda: (arch.loss_fn()(params, cfg, batch, plain),
                         arch.prefill_fn()(params, batch, rt),
                         arch.prefill_fn()(params, batch, plain)),
                lambda: (arch_w.prefill_fn()(params, batch, rt),
                         arch_w.prefill_fn()(params, short, rt, cache),
                         arch_w.decode_fn()(
                             params, wide, cache, batch["tokens"][:, -1:],
                             torch.full((b,), s - 1, dtype=torch.int32,
                                        device="cuda"), rt)))
    return runs


def phase35_seed_runs():
    """Phase 35's MoE forwards for one token seed: each worker's loss on
    its rows on the kernels, then on the plain versions, then in
    float64."""
    name, n_layers, s = next(r for r in TRAIN_F32_RUNS if r[0] == MOE_SERVED)
    cfg = train_f32_cfg(name, n_layers)
    arch = registry.Arch(cfg)
    params = arch.init_params(35, "cuda", torch.float32)
    p64 = tree_util.map(lambda t: t.double(), params)
    loss = arch.loss_fn()

    def runs(seed: int):
        rows = seeded_tokens(cfg, 2, s, seed).tensor_split(TRAIN_WORKERS)
        return tuple(
            (lambda p=p, r=r: [loss(p, cfg, {"tokens": t}, r) for t in rows])
            for p, r in ((params, Runtime()), (params, Runtime(
                kernels="plain")), (p64, Runtime(kernels="plain"))))
    return runs


def moe_seed_search(phase: int, first: int = 131, wanted: int = 3) -> int:
    """How phase 31's or phase 35's MoE token seed is chosen
    (``chip_smoke.py --moe-seed-search [31|35]``): from ``first`` up, each
    seed's smallest router gap over the phase's MoE runs
    (:func:`phase31_seed_runs`, :func:`phase35_seed_runs`), stopping at
    the first run with a gap at or under :data:`TIE_GAP`, printed, until
    ``wanted`` seeds have every gap over it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    build_kernels()
    runs_of = {31: phase31_seed_runs, 35: phase35_seed_runs}[phase]()
    found, tried, seed = [], 0, first
    while len(found) < wanted and tried < 5000:
        gaps = []
        for run in runs_of(seed):
            with torch.no_grad(), RouterProbe() as probe:
                run()
            gaps.append(probe.stats["min_router_gap"])
            if gaps[-1] <= TIE_GAP:
                break
        tried += 1
        if min(gaps) > TIE_GAP:
            found.append(seed)
        emit({"seed": seed, "min_router_gaps": gaps})
        seed += 1
    emit({"moe_seed_search": {"phase": phase, "first": first,
                              "tried": tried, "found": found,
                              "tie_gap": TIE_GAP}})
    return 0


def families_phases() -> int:
    """Phases 26-31 in a process of their own (``chip_smoke.py
    --families-phases``, started by the full run): every timed run
    first, the profiled ones after (a profiler session stays attached in
    its process, see :func:`fused_phases`), the float32 checks last.
    One model's weights at a time.  The last line is the families path's
    launches: each model's forward, prefill and decode and the per-round
    serve runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    family_kernel_rows()
    counts = collections.Counter()
    counts.update(phase28_deepseek())
    counts.update(phase29_internvl2())
    launches, seamless = phase30_seamless()
    counts.update(launches)
    cfg = registry.get(MOE_SERVED).cfg
    params = registry.Arch(cfg).init_params(0, "cuda", torch.bfloat16)
    counts.update(phase26_moe_loss(cfg, params))
    scfg = cut_layers(cfg)                   # phase 27 serves 4 layers
    sparams, rep_k = serve_setup(scfg, torch.bfloat16, seed=0)
    launches, fused_row = phase27_moe_serve(scfg, sparams, rep_k)
    counts.update(launches)
    families_device_phase(cfg, params, (scfg, sparams, rep_k), fused_row,
                          seamless)
    del params, sparams, rep_k, seamless
    torch.cuda.empty_cache()
    families_forward_profiles()
    phase31_families_f32()
    emit({"families": dict(counts)})
    return 0


# ---------------------------------------------------------------------------
# training the hybrid, moe, vlm and encdec families (phases 32-35)
# ---------------------------------------------------------------------------

FAMILIES_TRAIN_PHASES_FLAG = "--families-train-phases"
ZAMBA2 = "zamba2-2.7b"
TRAIN_SEQ = 2048
TRAIN_STEPS = 3
# a train step holds about this many bytes a parameter: bf16 weights 2;
# float32 master, m and v 12; the W = 2 stacked bf16 gradients 4; their
# mean and the compressed reduction's float32 bucket about 4
TRAIN_BYTES_PER_PARAM = 22
# (phase, model, layers run) at full width; None is full depth.  Depth is
# cut only where one card's 80 GB forces it (TRAIN_BYTES_PER_PARAM at
# full depth is printed beside each run).
TRAIN_FAMILY_RUNS = ((32, ZAMBA2, None), (33, MOE_SERVED, 4),
                     (33, DEEPSEEK, 4), (34, INTERNVL, 5),
                     (34, SEAMLESS, None))


def train_cfg(name: str, n_layers):
    """``name``'s config at full width and ``n_layers`` layers (None:
    every layer)."""
    cfg = registry.get(name).cfg
    if n_layers is None or n_layers == cfg.n_layers:
        return cfg
    return dataclasses.replace(cfg, n_layers=n_layers)


def attention_split(cfg, workers: int) -> dict:
    """The flash-attention calls of one train step by causal flag: every
    forward's self attention, the encdec's encoder non-causal."""
    if cfg.family == "encdec":
        e = cfg.encdec
        return {"causal": workers * e.n_decoder_layers,
                "non_causal": workers * e.n_encoder_layers}
    n = shared_groups(cfg) if cfg.family == "hybrid" else cfg.n_layers
    return {"causal": workers * n}


def family_forward_flops(cfg, b: int, s: int, workers: int,
                         routed: bool = False) -> int:
    """The matrix work of one loss forward over ``b`` rows of the
    ``s``-token stream as the program does it, each of the ``workers``
    routing its own rows: the per-token projections, the head over the
    predicted positions and the attention the masks keep; the hybrid's
    SSD scans; the MoE's E x C capacity slots (``routed``: the T K routes
    alone); the vlm's projector over its patches; the encdec's encoder
    over the S/2 frames, its decoder over S/2 - 1 tokens and the cross
    attention between them."""
    d, vocab = cfg.d_model, cfg.vocab_size
    hq, hd = cfg.n_heads, cfg.head_dim_
    if cfg.family == "encdec":
        half, t = s // 2, s // 2 - 1
        specs = registry.param_specs(cfg)
        mats = lambda tree: sum(sp.numel() for sp in layers.spec_leaves(tree)
                                if len(sp.shape) >= 3)
        cross_kv = sum(specs["decoder"]["cross"][k].numel()
                       for k in ("wk", "wv"))
        e, dl = cfg.encdec.n_encoder_layers, cfg.encdec.n_decoder_layers
        return (2 * b * half * mats(specs["encoder"])
                + 2 * b * t * (mats(specs["decoder"]) - cross_kv)
                + 2 * b * half * cross_kv + 2 * b * t * d * vocab
                + attention_flops(b, half, hq, hd, False) * e
                + attention_flops(b, t, hq, hd, True) * dl
                + 4 * b * hq * hd * t * half * dl)
    attn = attention_flops(b, s, hq, hd, True)
    if cfg.family == "vlm":
        n_p = cfg.vlm.n_patches
        return (2 * b * s * matmul_params(cfg) + 2 * b * (s - n_p) * d * vocab
                + attn * cfg.n_layers
                + 2 * b * n_p * (cfg.vlm.vision_dim + d) * d)
    head = 2 * b * (s - 1) * d * vocab
    if cfg.family == "hybrid":
        m = cfg.ssm
        return (2 * b * s * matmul_params(cfg) + head
                + attn * shared_groups(cfg)
                + ssd_flops(b, s, m.expand * d // m.head_dim, m.head_dim,
                            m.d_state, m.n_groups, m.chunk) * cfg.n_layers)
    return (workers * moe_flops(cfg, b // workers * s, routed) + head
            + attn * cfg.n_layers)


def family_train_bound(cfg, params, b: int, s: int, workers: int) -> dict:
    """A train step's least time: its matrix work (forward and backward,
    3x :func:`family_forward_flops`) at the bf16 peak, against the bytes
    AdamW must move (the mean gradient read and the parameters written
    in their dtype; the float32 master, m and v read and written once).
    The MoE's bound counts its capacity slots, with the routed-only
    figure beside it."""
    nbytes = sum(t.numel() * (2 * t.element_size() + 24)
                 for t in tensors(params))
    fwd = family_forward_flops(cfg, b, s, workers)
    bound_ms, bound_by = bound(nbytes, 3 * fwd, BF16_TC_OPS_PER_S)
    out = {"bound_ms": bound_ms, "bound_by": bound_by,
           "bound_flops": 3 * fwd, "bound_bytes": nbytes}
    if cfg.moe is not None:
        routed = 3 * family_forward_flops(cfg, b, s, workers, routed=True)
        r_ms, r_by = bound(nbytes, routed, BF16_TC_OPS_PER_S)
        out.update(bound_counts="E x C capacity slots a layer a worker",
                   bound_ms_routed_only=r_ms, bound_by_routed_only=r_by,
                   bound_flops_routed_only=routed)
    return out


def families_quantize():
    """The quantize pair bit for bit against its plain version at the
    largest bucket of each model :func:`train_family` trains: W x shard
    float32 elements with one block a worker's shard, as the compressed
    reduction gives them (``gradsync.compressed_psum_mean``); run while
    no model's state is on the card.  These shards are the path's
    largest: a full-depth stacked leaf is a bucket of its own, past
    2**31 bytes in float32."""
    gen = torch.Generator(device="cuda").manual_seed(32)
    shards = collections.defaultdict(list)
    for _, name, n_layers in TRAIN_FAMILY_RUNS:
        shards[train_plan(train_cfg(name, n_layers))[1]].append(name)
    for shard, names in sorted(shards.items()):
        n = TRAIN_WORKERS * shard
        x = 1e-3 * torch.randn(n, generator=gen, device="cuda")
        for r in quantize_row(x, shard, f"n={n} block={shard}",
                              torch.float32, 4):
            emit({"phase": 32, "part": "quantize", "models": names,
                  "bytes_in": 4 * n, **r})
        del x
        torch.cuda.empty_cache()


def family_trainer(name: str, n_layers, rt):
    cfg = train_cfg(name, n_layers)
    tcfg = api.TrainConfig(steps=TRAIN_STEPS, seq_len=TRAIN_SEQ,
                           global_batch=2, log_every=1)
    return cfg, api.Trainer(name, cfg, tcfg, rt, device="cuda")


def train_family(phase: int, name: str, n_layers):
    """One family's ``Trainer`` at full width (phases 32-34): bf16
    weights from seed 0, ``spindle_compressed`` over W = 2 workers
    folded onto the card, 2 x 2048 tokens of the stream (the vlm's 256
    patches and the encdec's 1024 frames cut from it by the stub
    frontends), 3 steps: finite losses near ln V, exact launches a step
    (each forward's counts x W, one quantize and one dequantize a
    bucket) and attention calls by causal flag, tokens/s, wall a step,
    peak memory, the bound, the MoE's routes dropped and aux term a
    step (:func:`train_routing`, untimed), and one warm step taken apart
    (``worker_grads``, the reduction, ``adamw.update``).  Returns (the
    launches, the split)."""
    rt = SplitCountRuntime(gradsync="spindle_compressed",
                           dp_workers=TRAIN_WORKERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    free_at_start = torch.cuda.mem_get_info()[0]
    cfg, trainer = family_trainer(name, n_layers, rt)
    b, s = 2, TRAIN_SEQ
    (params, opt), setup_s = timed(lambda: trainer.init_state(0))
    plan, shard = train_plan(cfg)
    want = train_launches(cfg, TRAIN_WORKERS, plan.n_buckets)
    split_want = attention_split(cfg, TRAIN_WORKERS)
    walls, per_step, splits = [], [], []
    mark = {}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - mark["t"])
        per_step.append(launches_since(mark["counts"]))
        splits.append(dict(SPLIT))
        SPLIT.clear()
        mark["t"], mark["counts"] = time.perf_counter(), ops.launch_counts()

    ops.reset_launch_counts()                 # the path starts here
    SPLIT.clear()
    torch.cuda.synchronize()
    mark["t"], mark["counts"] = time.perf_counter(), ops.launch_counts()
    params, opt = trainer.run(params, opt, on_step=on_step)
    launches = ops.launch_counts()            # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    what = f"phase {phase} {name}"
    for i, (made, split) in enumerate(zip(per_step, splits)):
        check(made == want, f"{what} step {i + 1}: launches {made}, want "
              f"{want}")
        check(split == split_want, f"{what} step {i + 1}: attention calls "
              f"{split}, want {split_want}")
    losses = [h["loss"] for h in trainer.history]
    check(len(losses) == TRAIN_STEPS, f"{what}: {len(losses)} steps logged")
    for x in losses:
        check_loss(x, cfg, what)
    # one warm step taken apart: the workers' gradients, the compressed
    # reduction, AdamW in place
    batch = trainer._batch_for(TRAIN_STEPS)
    arch = registry.Arch(cfg)
    (_, stacked), grads_s = timed(
        lambda: steps.worker_grads(arch, rt)(params, batch))
    mean, reduce_s = timed(lambda: steps.reduce_grads(stacked, rt))
    del stacked
    _, update_s = timed(lambda: adamw.update(
        trainer.tcfg.opt, mean, opt, torch.bfloat16, params=params))
    del mean
    SPLIT.clear()
    parts = grads_s + reduce_s + update_s
    full = registry.get(name).cfg
    emit({"phase": phase, "model": name, "family": cfg.family,
          "layers": cfg.n_layers if cfg.encdec is None else
          [cfg.encdec.n_encoder_layers, cfg.encdec.n_decoder_layers],
          "full_layers": full.n_layers, "params": cfg.param_count(),
          "full_depth_bytes_at_22_per_param":
              TRAIN_BYTES_PER_PARAM * full.param_count(),
          "batch": b, "seq": s, "batch_keys": sorted(batch),
          "workers": TRAIN_WORKERS, "gradsync": rt.gradsync,
          "buckets": plan.n_buckets, "largest_shard": shard,
          "setup_s": setup_s, "losses": losses, "history": trainer.history,
          "ln_vocab": math.log(cfg.vocab_size),
          "launches_per_step": want, "attention_split_per_step": split_want,
          "step_wall_s": walls, "tokens_per_s": [b * s / w for w in walls],
          "peak_memory_bytes": peak,
          "peak_bytes_per_param": peak / cfg.param_count(),
          "card_free_bytes_at_start": free_at_start,
          "warm_step_parts_s": {"worker_grads": grads_s,
                                "reduce_compressed": reduce_s,
                                "adamw_update": update_s},
          "reduce_share": reduce_s / parts, "adamw_share": update_s / parts,
          **family_train_bound(cfg, params, b, s, TRAIN_WORKERS)})
    split = collections.Counter()
    for x in splits:
        split.update(x)
    del params, opt, trainer
    torch.cuda.empty_cache()
    return launches, split


def train_routing(phase: int, name: str, n_layers) -> None:
    """The MoE's routing a step, from a second, untimed run of
    :func:`train_family`'s Trainer (the same seed, batches and steps)
    under :class:`RouterProbe`, whose extra router product and drop
    counts stay out of the timed run: routes, routes dropped, the aux
    term (the workers' mean) and the smallest router gap."""
    rt = Runtime(gradsync="spindle_compressed", dp_workers=TRAIN_WORKERS)
    _, trainer = family_trainer(name, n_layers, rt)
    params, opt = trainer.init_state(0)
    routing, mark = [], {"probed": 0, "routes": 0}
    with RouterProbe() as probe:
        def on_step(step, metrics):
            n = mark["probed"]
            routing.append({
                "routes": probe.routes - mark["routes"],
                "routes_dropped": int(torch.stack(probe.drops[n:]).sum()),
                "aux": float(torch.stack(probe.aux[n:]).sum())
                / TRAIN_WORKERS,
                "min_router_gap": float(torch.stack(probe.gaps[n:]).min())})
            mark["probed"], mark["routes"] = len(probe.drops), probe.routes

        trainer.run(params, opt, on_step=on_step)
    del params, opt, trainer
    torch.cuda.empty_cache()
    emit({"phase": phase, "part": "routing", "model": name,
          "routing_per_step": routing})


def train_family_profile(phase: int, name: str, n_layers):
    """One warm train step of :func:`train_family`'s setup under the
    profiler (after a cold one): device time, busy share, the port's
    kernels and the leading device operations."""
    rt = Runtime(gradsync="spindle_compressed", dp_workers=TRAIN_WORKERS)
    cfg, trainer = family_trainer(name, n_layers, rt)
    params, opt = trainer.init_state(0)
    step_fn = steps.make_train_step(registry.Arch(cfg), rt, donate=True)
    step_fn(params, opt, trainer._batch_for(0))
    batch = trainer._batch_for(1)
    prof = profile_step(lambda: step_fn(params, opt, batch))
    emit({"phase": phase, "part": "device", "model": name,
          "tokens_per_profiled_s": 2 * TRAIN_SEQ / prof["profiled_wall_s"],
          **prof})
    del params, opt, trainer, step_fn
    torch.cuda.empty_cache()


# phase 35: (model, layers, rows x stream length) in float32, full width.
# qwen2-moe-a2.7b and internvl2-26b run 2 layers: a first train step holds
# the parameters, their copy, the float32 master, m and v, the W = 2
# stacked gradients and their mean, about 8 parameter sets, and at 4
# layers (3.0 and 2.7 B parameters) that is 97 and 88 GB.
TRAIN_F32_RUNS = ((ZAMBA2, 4, 1024), (SEAMLESS, 4, 512), (INTERNVL, 2, 512),
                  (MOE_SERVED, 2, 256))
# the families whose float64 yardstick takes the band (YARDSTICK_BAND),
# with their distances from float64 when one kind of site is on its
# kernels: one draw of the plain path is no fair measure of float32
# rounding for them.  On the card (phase 35, params seeds 35-37 x 2
# workers for zamba2), the rule against the plain path alone broke for
# the kernels on 2 of zamba2's 6 draws (12 and 4 leaves) and on one of
# internvl2's 2 (its projector norm), and for the pure PyTorch RMSNorm
# variants too: on zamba2's seed 35, worker 1, on 3 ("rms_blocked") and 7
# ("rms_serial") leaves, the serial one 2.28e-4 from float64 at the
# embedding against the plain path's 4.86e-5 and the kernels' 2.71e-4.
YARDSTICK_BAND_FAMILIES = ("hybrid", "vlm")
# zamba2's params seeds in phase 35: the first with every check, each
# with its own batch of the stream; the rule is held on every draw
ZAMBA2_F32_SEEDS = (35, 36, 37)
# phase 35's MoE token seed, chosen by the printed router margins
# (``chip_smoke.py --moe-seed-search 35``)
MOE_TRAIN_F32_SEED = 134


def train_f32_cfg(name: str, n_layers: int):
    """Phase 35's config: ``name`` at full width, ``n_layers`` layers
    (the encdec 2 + 2, the hybrid with its shared block every 2)."""
    cfg = registry.get(name).cfg
    if cfg.family == "hybrid":
        return recurrent_cfg_4(cfg)
    if cfg.family == "encdec":
        return cut_layers(cfg)
    return dataclasses.replace(cfg, n_layers=n_layers)


def train_f32_batch(cfg, name: str, s: int, rt, step: int = 0):
    """Phase 35's batch of 2 rows: the MoE's seeded tokens, every other
    family's the Trainer's batch of ``step`` (the stub frontends' frames
    and patches in float32)."""
    if cfg.moe is not None:
        return {"tokens": seeded_tokens(cfg, 2, s, MOE_TRAIN_F32_SEED)}
    tcfg = api.TrainConfig(seq_len=s, global_batch=2,
                           param_dtype=torch.float32)
    return api.Trainer(name, cfg, tcfg, rt, device="cuda")._batch_for(step)


def yardstick_draw(arch, params, batch, rt, what: str, sites) -> dict:
    """One draw of phase 35's gradient checks, one worker at a time (three
    stacked trees of a 2 B-parameter model do not fit beside each
    other): :func:`compare_worker_grads` and :func:`float64_yardstick`,
    with the band for the families in YARDSTICK_BAND_FAMILIES."""
    plain = dataclasses.replace(rt, kernels="plain")
    band = arch.cfg.family in YARDSTICK_BAND_FAMILIES
    out = {"yardstick_band": band}
    for w in range(rt.dp_workers):
        g_k, g_p, err, rel = compare_worker_grads(
            arch, params, batch, rt, plain, f"{what} worker {w}", worker=w)
        yard = float64_yardstick(arch, params, batch, rt, g_k, g_p,
                                 f"{what} worker {w}", worker=w, band=band,
                                 sites=sites)
        del g_k, g_p
        out[f"worker_{w}"] = {"worker_loss_rel_err": rel,
                              "grad_rel_err": err, "float64_yardstick": yard}
    return out


def phase35_families_train_f32():
    """The families' train path in float32 at full width on the kernels
    and on the plain versions, ``spindle`` over W = 2 workers:
    zamba2-2.7b at 4 layers (its shared block every 2) on 2 x 1024
    tokens, seamless-m4t-medium at 2 + 2 and internvl2-26b at 2 layers
    on 2 x 512 of the stream (their stub frontends), qwen2-moe-a2.7b at
    2 layers on 2 x 256 seeded tokens: :func:`yardstick_draw` at params
    seed 35 (zamba2 also at ZAMBA2_F32_SEEDS' other seeds, each with the
    Trainer's next batch; zamba2 and internvl2 with their distances
    from float64 when one kind of site is on its kernels); at seed 35
    the error with one kind of site on its kernels against plain
    (zamba2, seamless), one train step (:func:`compare_first_step`);
    every MoE router gap of every run over TIE_GAP; at seed 35 each
    worker's gradients under ``remat="full"`` (:func:`remat_vs_none`).
    Returns the ``full`` runs' launches and attention calls by causal
    flag."""
    out = {}
    remat_counts = {"launches": collections.Counter(),
                    "split": collections.Counter()}
    for name, n_layers, s in TRAIN_F32_RUNS:
        cfg = train_f32_cfg(name, n_layers)
        arch = registry.Arch(cfg)
        rt = Runtime(gradsync="spindle", dp_workers=TRAIN_WORKERS)
        what = f"phase 35 {name}"
        sites = {"flash_attention": ("flash_attention",),
                 "rms_norm": ("rms_norm", "rms_norm_residual")}
        if cfg.family == "hybrid":
            sites["ssd_scan"] = ("ssd_scan",)
        row = {"layers": cfg.n_layers if cfg.encdec is None else
               [cfg.encdec.n_encoder_layers, cfg.encdec.n_decoder_layers],
               "batch": 2, "seq": s, "gradsync": rt.gradsync,
               "workers": TRAIN_WORKERS}
        seeds = ZAMBA2_F32_SEEDS if cfg.family == "hybrid" else (35,)
        with RouterProbe() as probe:
            for step, seed in enumerate(seeds):
                params = arch.init_params(seed, "cuda", torch.float32)
                batch = train_f32_batch(cfg, name, s, rt, step)
                row[f"params_seed_{seed}"] = yardstick_draw(
                    arch, params, batch, rt, f"{what} seed {seed}",
                    sites if cfg.family in YARDSTICK_BAND_FAMILIES
                    else None)
                if step:
                    del params, batch
                    continue
                row["batch_keys"] = sorted(batch)
                row.update(compare_first_step(
                    arch, params, batch, rt,
                    dataclasses.replace(rt, kernels="plain"),
                    adamw.OptConfig(), what))
                if cfg.family in ("hybrid", "encdec"):
                    row["grad_rel_err_one_site_on_kernels"] = \
                        grad_errors_by_site(arch, params, batch, rt, sites)
                row["remat_full"] = remat_vs_none(arch, params, batch, rt,
                                                  what, remat_counts)
                del params, batch
        if cfg.moe is not None:
            check_margin(probe.stats, what)
            row["router"] = probe.stats
            row["seed"] = MOE_TRAIN_F32_SEED
        out[name] = row
        torch.cuda.empty_cache()
    emit({"phase": 35, "dtype": "float32", "loss_rtol": TRAIN_LOSS_RTOL,
          **out})
    return remat_counts


def remat_vs_none(arch, params, batch, rt, what: str, counts) -> dict:
    """Each worker's gradients (one at a time, :func:`grads_of`) on the
    kernels under ``remat="full"`` against the same worker's under
    ``none``: the exact launches of each (:func:`remat_launches`),
    losses bit-identical, every leaf within the family's GRAD_TOL; and
    whether a second ``none`` run repeats the first bit for bit (the
    MoE's gather backward accumulates with atomics).  The ``full``
    runs' launches and attention calls go into ``counts``."""
    full = dataclasses.replace(rt, remat="full")
    cfg = arch.cfg
    out = {"bar": grad_tol(cfg)}
    for w in range(rt.dp_workers):
        (loss_n, g_n), wall_n = run_counted(
            lambda: grads_of(arch, rt, params, batch, w),
            remat_launches(cfg, "none", 1), f"{what} worker {w} remat none")
        _, g_again = grads_of(arch, rt, params, batch, w)
        repeat = grad_distance(g_again, g_n)
        del g_again
        want = remat_launches(cfg, "full", 1)
        (loss_f, g_f), wall_f = run_counted(
            lambda: grads_of(arch, full, params, batch, w), want,
            f"{what} worker {w} remat full")
        check(torch.equal(loss_f, loss_n), f"{what} worker {w} remat full: "
              f"loss {float(loss_f)} != none's {float(loss_n)}")
        dist = grad_distance(g_f, g_n)
        check(dist["max"] <= out["bar"], f"{what} worker {w} remat full: "
              f"gradient {dist['leaf']} {dist['max']} of its max (bar "
              f"{out['bar']})")
        del g_n, g_f
        counts["launches"].update(want)
        counts["split"].update({k: 2 * v for k, v in
                                attention_split(cfg, 1).items()})
        out[f"worker_{w}"] = {"grad_vs_none": dist,
                              "none_repeat_vs_none": repeat,
                              "wall_none_s": wall_n,
                              "wall_full_s": wall_f,
                              "losses_bit_identical": True,
                              "launches_full": want}
    return out


def families_train_phases() -> int:
    """Phases 32-35 in a process of their own (``chip_smoke.py
    --families-train-phases``, started by the full run): every timed
    Trainer run first, the profiled steps after (a profiler session
    stays attached in its process, see :func:`fused_phases`), the
    float32 checks last; one model's state at a time.  The last line is
    the families' train path launches (the timed runs' 3 steps a model),
    the attention calls by causal flag beside them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    families_quantize()
    counts, split = collections.Counter(), collections.Counter()
    for phase, name, n_layers in TRAIN_FAMILY_RUNS:
        launches, calls = train_family(phase, name, n_layers)
        counts.update(launches)
        split.update(calls)
        if registry.get(name).cfg.moe is not None:
            train_routing(phase, name, n_layers)
    for phase, name, n_layers in TRAIN_FAMILY_RUNS:
        train_family_profile(phase, name, n_layers)
    remat = phase35_families_train_f32()
    counts.update(remat["launches"])
    split.update(remat["split"])
    counts["flash_attention_causal"] = split["causal"]
    counts["flash_attention_non_causal"] = split["non_causal"]
    emit({"families_train": dict(counts)})
    return 0


# ---------------------------------------------------------------------------
# the launch plane: the serve and train launchers, the dry-run and the
# roofline report, and the grid sharded over named devices
# ---------------------------------------------------------------------------

LAUNCH_PHASE_FLAG = "--launch-phase"
LAUNCH_SERVE_ARGS = ["--arch", "qwen3-1.7b"]
LAUNCH_TRAIN_ARGS = ["--arch", "qwen3-1.7b", "--steps", "3", "--seq-len",
                     "128", "--global-batch", "8", "--log-every", "1"]
LAUNCH_DRYRUNS = (("pod16x16", ["--arch", "qwen3-1.7b", "--shape", "all",
                                "--mesh", "single"]),
                  ("pod2x16x16", ["--arch", "qwen2-72b", "--shape",
                                  "train_4k", "--mesh", "multi"]))
LAUNCH_DRYRUN_DIR = ROOT / "results" / "dryrun_torch"
# the dry-run's CLI run as ``__main__``, then whether it initialised CUDA
DRYRUN_CHILD = (
    "import json, runpy, torch; "
    "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__', "
    "alter_sys=True); "
    "print(json.dumps({'cuda_initialized': torch.cuda.is_initialized()}))")
# each grid of phase 3 sharded over these devices: one chunk a device
LAUNCH_GRID_DEVICES = {"fig6_windows": ["cuda:0"] * 5,
                       "fig11_null_send": ["cuda:0", "cuda:0"]}
SERVE_LINE = re.compile(r"served (\d+) requests, (\d+) tokens in ([\d.]+)s "
                        r"\(([\d.]+) tok/s, (\d+) decode steps, (\d+) "
                        r"rounds\)")
LATENCY_LINE = re.compile(r"latency mean (\d+)ms p99 (\d+)ms")
STEP_LINE = re.compile(r"step +(\d+) loss ([-\d.naif]+) ")


def launch_child(argv, timeout: int):
    """Run ``argv`` from the checkout's root with ``src`` on the path;
    returns (stdout lines, wall seconds); fails on a non-zero exit."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=timeout)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{' '.join(argv[1:4])} exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout.strip().splitlines(), wall


def launch_dryruns() -> dict:
    """The dry-run children (qwen3-1.7b x every shape on one pod,
    qwen2-72b train_4k on two) and the roofline report of each mesh;
    host code, run beside the card phases."""
    out = {"cells": [], "roofline_rows": {}, "walls_s": []}
    for mesh_name, args in LAUNCH_DRYRUNS:
        lines, wall = launch_child(
            [sys.executable, "-c", DRYRUN_CHILD, *args, "--out",
             str(LAUNCH_DRYRUN_DIR), "--force"], 300)
        check(json.loads(lines[-1]) == {"cuda_initialized": False},
              f"the dry-run initialised CUDA: {lines[-1]}")
        out["walls_s"].append(wall)
        for line in lines[:-1]:
            if line.startswith("[dryrun]"):
                continue
            status, _, arch, shape = line.split()[:4]
            rec = json.loads((LAUNCH_DRYRUN_DIR / mesh_name /
                              f"{arch}__{shape}.json").read_text())
            check(rec.get("remat", "full") == "full",
                  f"dry-run cell {arch} {shape}: remat {rec.get('remat')}, "
                  f"want the default full")
            out["cells"].append({
                "mesh": mesh_name, "arch": arch, "shape": shape,
                "status": rec["status"], "remat": rec.get("remat"),
                "trace_s": rec.get("trace_s"),
                **({k: rec["roofline"][k] for k in (
                    "dominant", "bound_s", "mfu_bound")}
                   if rec["status"] == "ok" else {}),
                **({"temp_size_bytes": rec["memory"]["temp_size_bytes"]}
                   if rec["status"] == "ok" else {}),
                "error": rec.get("error")})
            check(status == f"[{rec['status']}]", f"dry-run line {line}")
        table, _ = launch_child(
            [sys.executable, "-m", "repro_torch.launch.roofline", "--dir",
             str(LAUNCH_DRYRUN_DIR), "--mesh", mesh_name], 120)
        out["roofline_rows"][mesh_name] = table[2:]
    return out


def launch_serve_f32(args) -> dict:
    """The serve launcher's run in float32 on the kernels and on the
    plain versions: identical tokens, request by request."""
    from repro_torch.launch import serve as serve_launcher
    cfg = registry.get(args.arch).cfg.reduced()
    tokens, counts = {}, {}
    for key, rt in (("kernels", Runtime()), ("plain",
                                             Runtime(kernels="plain"))):
        params = registry.Arch(cfg).init_params(args.seed, "cuda",
                                                torch.float32)
        before = ops.launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            done = serve_launcher.serve(args, params=params, device="cuda",
                                        rt=rt)
        counts[key] = launches_since(before)
        tokens[key] = {r.rid: list(r.tokens_out) for r in done}
    check(tokens["kernels"] == tokens["plain"],
          "launch serve: float32 tokens differ between the kernels and "
          "the plain versions")
    check(counts["plain"] == {}, f"the plain run launched {counts['plain']}")
    return {"requests": len(tokens["kernels"]), "identical_tokens": True,
            "kernels_launches": counts["kernels"]}


def launch_grids(grids_run) -> dict:
    """Phase 3's grids through ``run_batch`` sharded over named devices
    (``[cuda:0] * k``: the chunks one after another on the card): every
    point identical to phase 3's unsharded batch and per-point runs."""
    rows = {}
    for label, devices in LAUNCH_GRID_DEVICES.items():
        cfg, grid, batch, solos = grids_run[label]
        (key, values), = grid.items()
        n_shards = placement.shard_count(len(values), devices)
        check(n_shards == len(devices), f"{label}: {n_shards} shards")
        before = ss.WATERMARK_LAUNCHES
        t0 = time.perf_counter()
        reports = api.Group(cfg, device="cuda").run_batch(
            backend=SyncCheckedKernelBackend("cuda"), devices=devices,
            **grid)
        wall = time.perf_counter() - t0
        launches = ss.WATERMARK_LAUNCHES - before
        t_max = max(r.rounds for r in reports)
        check(launches == n_shards * t_max, f"{label} sharded: {launches} "
              f"launches, want {n_shards} x {t_max}")
        for value, rs, rb, (solo, solo_logs) in zip(values, reports, batch,
                                                     solos):
            what = f"{label} sharded point {value}"
            same_logs(rs.extras["delivery_logs"],
                      rb.extras["delivery_logs"], what + " (batch)")
            same_report(rs, rb, what + " (batch)")
            same_logs(rs.extras["delivery_logs"], solo_logs,
                      what + " (solo)")
            same_report(rs, solo, what + " (solo)")
        rows[label] = {"points": len(values), "shards": n_shards,
                       "devices": devices, "rounds": t_max,
                       "launches": launches, "batch_wall_s": wall,
                       "identical_to_unsharded_and_solo": True}
    return rows


def phase37_launch(grids_run, smi_line: str) -> dict:
    """The launch plane: (a) the serve launcher as a child process and
    in-process (bf16 as the CLI, then float32 kernels against plain), (b)
    the train launcher at full width as a child and in-process, (c) the
    dry-run and roofline children (beside the card work), (d) phase 3's
    grids sharded over named devices, (e) the phase's seconds.  Returns
    the launch path's counts: the in-process launcher runs and the
    sharded grids."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        dry = pool.submit(launch_dryruns)

        # (a) and (b) as a user starts them
        lines, serve_wall = launch_child(
            [sys.executable, "-m", "repro_torch.launch.serve",
             *LAUNCH_SERVE_ARGS], 300)
        m, lat = SERVE_LINE.fullmatch(lines[-2]), \
            LATENCY_LINE.fullmatch(lines[-1])
        check(m is not None and lat is not None,
              f"serve launcher lines: {lines[-2:]}")
        serve_args = serve_launcher.parse_args(LAUNCH_SERVE_ARGS)
        check(int(m[1]) == serve_args.requests and int(m[2]) ==
              serve_args.requests * serve_args.max_new,
              f"serve launcher served {m[1]} requests, {m[2]} tokens")
        serve_cli = {"requests": int(m[1]), "tokens": int(m[2]),
                     "seconds": float(m[3]), "tokens_per_s": float(m[4]),
                     "decode_steps": int(m[5]), "rounds": int(m[6]),
                     "latency_mean_ms": int(lat[1]),
                     "latency_p99_ms": int(lat[2]),
                     "process_wall_s": serve_wall}
        lines, train_wall = launch_child(
            [sys.executable, "-m", "repro_torch.launch.train",
             *LAUNCH_TRAIN_ARGS], 600)
        cli_losses = [float(s[2]) for s in map(STEP_LINE.match, lines) if s]
        train_args = train_launcher.parse_args(LAUNCH_TRAIN_ARGS)
        cfg = registry.get(train_args.arch).cfg
        ln_v = math.log(cfg.vocab_size)
        check(len(cli_losses) == train_args.steps
              and all(math.isfinite(x) for x in cli_losses)
              and abs(cli_losses[0] - ln_v) < 1.0,
              f"train launcher losses {cli_losses} (ln V = {ln_v:.2f})")

        # in-process: the launch path's counted runs
        ops.reset_launch_counts()             # the launch path starts here
        serve_out = io.StringIO()
        with contextlib.redirect_stdout(serve_out):
            done = serve_launcher.serve(serve_args, device="cuda")
        m = SERVE_LINE.fullmatch(serve_out.getvalue().splitlines()[0])
        serve_counts = ops.launch_counts()
        steps_ = int(m[5])
        small = registry.get(serve_args.arch).cfg.reduced()
        want = {k: v * steps_ for k, v in
                decoder_launches(small, "flash_decode").items()}
        check({k: serve_counts.get(k, 0) for k in want} == want,
              f"serve launcher launches {serve_counts}, want {want}")
        check(len(done) == serve_args.requests, "serve launcher drained")

        want_step = train_launches(cfg, 1, 0)
        walls, per_step = [], []
        mark = {"t": None, "counts": None}

        def on_step(step, metrics):
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - mark["t"])
            per_step.append(launches_since(mark["counts"]))
            mark["t"], mark["counts"] = time.perf_counter(), \
                ops.launch_counts()

        torch.cuda.synchronize()
        mark["t"], mark["counts"] = time.perf_counter(), ops.launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            trainer = train_launcher.train(train_args, device="cuda",
                                           on_step=on_step)
        for i, made in enumerate(per_step):
            check(made == want_step, f"train launcher step {i + 1}: "
                  f"launches {made}, want {want_step}")
        losses = [h["loss"] for h in trainer.history]
        # the CLI prints 4 decimals: the same steps in another process
        check([f"{x:.4f}" for x in losses] == [f"{x:.4f}" for x in
                                               cli_losses],
              f"train launcher in-process losses {losses} != the CLI's "
              f"{cli_losses}")
        del trainer
        torch.cuda.empty_cache()

        grids = launch_grids(grids_run)
        launches = ops.launch_counts()        # ... and ends here

        serve_f32 = launch_serve_f32(serve_args)
        dryruns = dry.result()
    for cell in dryruns["cells"]:
        reason = registry.get(cell["arch"]).skip_reason(
            shape_by_name(cell["shape"]))
        check(cell["status"] == ("skipped" if reason else "ok"),
              f"dry-run cell {cell}")
    tokens = train_args.global_batch * train_args.seq_len
    phase_s = time.perf_counter() - t0
    emit({"phase": 37, "card": smi_line,
          "serve_cli": serve_cli, "serve_in_process": {
              "launches": {k: serve_counts.get(k, 0) for k in want},
              "decode_steps": steps_},
          "serve_f32_kernels_vs_plain": serve_f32,
          "train": {"model": train_args.arch, "layers": cfg.n_layers,
                    "batch": train_args.global_batch,
                    "seq": train_args.seq_len,
                    "cli_losses": cli_losses, "cli_wall_s": train_wall,
                    "launches_per_step": want_step, "step_wall_s": walls,
                    "tokens_per_s": [tokens / w for w in walls]},
          "dryrun": dryruns, "grids": grids, "launches": launches,
          "phase_s": phase_s})
    check(phase_s < 150, f"phase 37 took {phase_s:.0f} s")
    return launches


def launch_phase() -> int:
    """Phase 37 alone (``chip_smoke.py --launch-phase``), after the
    build and phase 3 it compares with."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi_line = phase0_identity()
    launch = phase37_launch(phase3_grids(), smi_line)
    check(all(launch.get(k, 0) > 0 for k in (
        "smc_sweep_watermark", "flash_decode", "flash_attention",
        "rms_norm", "rms_norm_residual")),
        f"the launch path skipped a kernel: {launch}")
    emit({"launch": launch})
    return 0


# ---------------------------------------------------------------------------
# phase 38: across real torch.distributed ranks
# ---------------------------------------------------------------------------

RANKS_PHASE_FLAG = "--ranks-phase"
# (a): qwen3-1.7b at full width, 2 of 28 layers (0.41 B parameters;
# bf16 weights, gradients and their mean, the float32 AdamW master, m
# and v at 12 B a parameter, activations and float32 logits at 1 x
# 2048).  Cut from 28 (36.4 GB allocated a rank) to make room in the
# run's time for (e) and (f), and from 4 for (h): its reductions
# through gloo take most of the part, 2.1-6.1 s a step still at 14
# layers (23.5 GB a rank)
RANKS_MODEL = "qwen3-1.7b"
RANKS_LAYERS = 2
RANKS_BATCH, RANKS_SEQ, RANKS_STEPS = 2, 2048, 2
RANKS_MODES = ("spindle", "spindle_per_tensor", "spindle_compressed")
# phase 38's ranks share cuda:0 over gloo (phase 39 runs the same parts
# one rank a card over nccl, ranks.cards); the folded comparisons run in
# one rank on cuda:0, over nccl at world size 1
RANKS_DEVICES = ("cuda:0", "cuda:0")
FOLDED_DEVICES = ("cuda:0",)
# (b): qwen2-moe-a2.7b at full width, 4 of 24 layers (phases 26 and 33's
# cut), its 64 expert slots 32 a rank
EP_LAYERS = 4
EP_SEQ, EP_PREFILL, EP_DECODE = 2048, 512, 8
# (c): the testbed's SST columns, its 16 senders
SST_PUSH_COLUMNS = {"received_num": (16,), "delivered_num": (),
                    "persisted_num": (), "num_nulls": (16,)}
# (e): qwen2-moe-a2.7b at full width, 2 of 24 layers, trained through
# its experts split over {"data": 1, "model": 2}.  A layer holds ~605 M
# parameters (553.6 M of experts in 64 slots, 34.6 M shared, 16.8 M
# attention), the embedding and head 622 M; at 18 B a parameter (bf16
# weights, gradients and their mean, float32 master, m and v) a rank's
# 1.28 B at 2 layers take ~23 GB plus activations, so two ranks fit on
# the 80 GB card; at 4 layers (~35 GB a rank before activations) they
# do not
EP_TRAIN_LAYERS = 2
EP_TRAIN_SEQ, EP_TRAIN_STEPS = 2048, 2
EP_MODEL = 2                             # ranks on the "model" axis
# (f): qwen3-1.7b at full width, 2 of 28 layers (~0.41 B parameters,
# ~10 GB a rank), four ranks on {"pod": 2, "data": 2} sharing the card,
# a 4 x 2048 global batch
POD_SHAPE = {"pod": 2, "data": 2}
POD_AXES = ("pod", "data")
POD_LAYERS, POD_BATCH = 2, 4
POD_MODES = RANKS_MODES + ("gspmd",)
POD_DEVICES = ("cuda:0",) * 4            # phase 38's four share cuda:0
POD_LOSS_RTOL = 1e-6
# (g1): qwen3-1.7b at full width, 2 of 28 layers (the cut of (f)), laid
# out by the "baseline" rules on four ranks {"data": 2, "model": 2}: 8 of
# its 16 q heads, 4 of its 8 kv heads, half the MLP columns and half the
# vocabulary a rank over "model", every fsdp_embed dim halved over
# "data"; 2 gspmd steps of a 2 x 2048 global batch (one row a data rank)
LAYOUT_SHAPE = {"data": 2, "model": 2}
LAYOUT_PRESET = "baseline"
LAYOUT_BATCH = 2
# (g2): qwen2-72b at full width (QKV bias, an untied head), 2 of 80
# layers, under "megatron" on two ranks {"model": 2}: 32 of 64 q heads and
# 4 of 8 kv heads a rank; a prefill of 1 x 512, then 8 greedy decode steps
TP_SERVE_MODEL = "qwen2-72b"
TP_SERVE_LAYERS = 2
TP_SERVE_SHAPE = {"model": 2}
TP_SERVE_PRESET = "megatron"
TP_PREFILL, TP_DECODE = 512, 8
# (h): every other family's layout at full width, part -> (model, layers
# (None: all), mesh shape, preset).  (h1) mamba2-2.7b, 2 of 64 layers,
# under "baseline" on the four ranks of (g1): 40 of its 80 ssm heads a
# rank over "model" (the fused projection's 10,576 columns and the conv's
# 5,376 channels in blocks of 5,288 and 2,688, gathered whole), every
# fsdp_embed dim halved over "data"; 2 gspmd steps of (g1)'s 2 x 2048.
# (h2) zamba2-2.7b, 6 of 54 layers (one group and its shared block),
# under "megatron" on the two ranks of (g2): 40 of 80 ssm heads, 16 of 32
# q and kv heads at D = 80.  (h3) qwen2-moe-a2.7b, 2 of 24 layers, under
# "baseline" on the four ranks: 8 of 16 heads, half the shared experts'
# columns and half the 64 expert slots a rank over "model".  (h4)
# internvl2-26b, 2 of 48 layers (24 of 48 q heads, 4 of 8 kv heads; its
# vocabulary of 92,553 stays whole), and seamless-m4t-medium at full
# depth (12 + 12 layers, 8 of 16 heads), under "megatron" on the two
# ranks.  The served parts: a loss at 1 x 2048, a prefill of 1 x 512 and
# 8 greedy decode steps, as (g2)
FAMILY_PARTS = {
    "h1": ("mamba2-2.7b", 2, LAYOUT_SHAPE, "baseline"),
    "h2": ("zamba2-2.7b", 6, TP_SERVE_SHAPE, "megatron"),
    "h3": ("qwen2-moe-a2.7b", 2, LAYOUT_SHAPE, "baseline"),
    "h4a": ("internvl2-26b", 2, TP_SERVE_SHAPE, "megatron"),
    "h4b": ("seamless-m4t-medium", None, TP_SERVE_SHAPE, "megatron"),
}
FAMILY_TRAINED = ("h1", "h3")
FAMILY_SERVED = ("h2", "h4a", "h4b")
# (i): the sequence-parallel presets.  (i1) qwen3-1.7b at (g1)'s 2 of 28
# layers under "seq_model" on (g1)'s four ranks: (g1)'s parameter layout,
# each rank holding 1024 of its row's 2048 positions between the blocks;
# 2 gspmd steps of (g1)'s 2 x 2048, held to (g1)'s unsplit step.  (i2)
# qwen2-72b at (g2)'s 2 of 80 layers under "megatron_seq" on (g2)'s two
# ranks: the loss at 1 x 2048 (1024 positions a rank), a prefill of 1 x
# 512 (256 a rank) and 8 greedy decode steps (whole: one position)
SEQ_TRAIN_PRESET = "seq_model"
SEQ_SERVE_PRESET = "megatron_seq"
# (j): ssm_seq, the sequence split with the mixers whole.  (j1)
# mamba2-2.7b at (h1)'s 2 of 64 layers on (g1)'s four ranks: every leaf
# whole on "model" but the vocabulary (the fsdp_embed dims halved over
# "data"), each rank 1024 of its row's 2048 positions (4 of the row's 8
# chunks of 256); 2 gspmd steps of (h1)'s 2 x 2048, held to (h1)'s
# unsplit step.  (j2) zamba2-2.7b at (h2)'s 6 of 54 layers on (g2)'s two
# ranks: the loss at 1 x 2048 (1024 positions a rank), the prefill's
# forward at 1 x 512 (256, one chunk, a rank) and 8 greedy decode steps
# (whole)
SSM_SEQ_PRESET = "ssm_seq"
# elements a leaf in the strided samples that (e) and (f) compare across
# processes (a whole tree would cross as gigabytes); (g1)'s blocks cross
# four times, one a rank, so fewer
SAMPLE = 1 << 20
LAYOUT_SAMPLE = 1 << 16
RANKS_TIMEOUT = 600


def ranks_cfg():
    return dataclasses.replace(registry.get(RANKS_MODEL).cfg,
                               n_layers=RANKS_LAYERS)


def ep_cfg():
    return cut_layers(registry.get(MOE_SERVED).cfg)


def ep_train_cfg():
    return dataclasses.replace(registry.get(MOE_SERVED).cfg,
                               n_layers=EP_TRAIN_LAYERS)


def pod_cfg():
    return dataclasses.replace(registry.get(RANKS_MODEL).cfg,
                               n_layers=POD_LAYERS)


def family_cfg(part: str):
    name, n_layers, _, _ = FAMILY_PARTS[part]
    cfg = registry.get(name).cfg
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def strided(t: torch.Tensor, n: int = SAMPLE) -> torch.Tensor:
    """At most ``n`` elements of ``t``, evenly strided over its flat
    order, as a copy."""
    flat = t.detach().reshape(-1)
    return flat[::-(-flat.numel() // n)].clone()


def samples(tree, model_index=None) -> dict:
    """path -> :func:`strided` of each leaf.  An MoE expert leaf is
    sampled per rank of the expert axis (key ``path#i``): of a whole
    tree (``model_index`` None) each rank's rows [i E/EP_MODEL, (i + 1)
    E/EP_MODEL), of a rank's own tree its rows as ``model_index``."""
    out = {}
    for path, leaf in tree_util.paths(tree):
        if not moe.is_expert_leaf(path):
            out[path] = strided(leaf)
        elif model_index is not None:
            out[f"{path}#{model_index}"] = strided(leaf)
        else:
            h = leaf.shape[1] // EP_MODEL
            for i in range(EP_MODEL):
                out[f"{path}#{i}"] = strided(leaf[:, i * h:(i + 1) * h])
    return out


def bit_digest(tree) -> list:
    """Per tensor, the int64 sums (mod 2**64) of its bit patterns, plain
    and weighted by position mod 65521: two trees with equal digests
    hold equal bits, barring a collision."""
    out = []
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    for leaf in tensors(tree):
        flat = leaf.detach().reshape(-1)
        flat = flat.view(ints[flat.element_size()])
        s = torch.zeros((), dtype=torch.int64, device=flat.device)
        w = torch.zeros((), dtype=torch.int64, device=flat.device)
        for lo in range(0, flat.numel(), 1 << 24):
            chunk = flat[lo:lo + (1 << 24)].to(torch.int64)
            pos = torch.arange(lo, lo + chunk.numel(),
                               device=flat.device) % 65521 + 1
            s += chunk.sum()
            w += (chunk * pos).sum()
        out.append((int(s), int(w)))
    return out


def ranks_batch(cfg, step: int, device) -> torch.Tensor:
    """Step ``step``'s global batch of (a)."""
    return seeded_tokens(cfg, RANKS_BATCH, RANKS_SEQ,
                         seed=138 + step).to(device)


class ReduceTimer:
    """While entered, the seconds of every ``steps.reduce_grads`` call
    (the train step's reduction, between two synchronisations), and
    :func:`samples` of the first call's mean (``first``)."""

    def __enter__(self):
        self.s, self._reduce, self.first = [], steps.reduce_grads, None

        def reduce_grads(*args, **kwargs):
            (out, secs) = timed(lambda: self._reduce(*args, **kwargs))
            self.s.append(secs)
            if self.first is None:
                self.first = samples(out)
            return out

        steps.reduce_grads = reduce_grads
        return self

    def __exit__(self, *exc):
        steps.reduce_grads = self._reduce
        return False


def pod_batch(cfg, step: int, device) -> torch.Tensor:
    """Step ``step``'s global batch of (f)."""
    return seeded_tokens(cfg, POD_BATCH, RANKS_SEQ,
                         seed=538 + step).to(device)


def ranks_train_mode(arch, rt, rows, device, batch_fn=ranks_batch,
                     keep: bool = False) -> dict:
    """RANKS_STEPS steps of ``make_train_step`` from seed 0's weights on
    ``rows`` of each global batch (``batch_fn``), each step's reduction
    and collectives timed inside it.  Returns losses, walls, the
    reduction's seconds and share of each step, the collectives' seconds
    a step and the last step's by kind, launches a step, digests of the
    parameters and the AdamW state; with ``keep``, :func:`samples` of
    the float32 master, the first reduction's mean and the learning
    rates too."""
    cfg = arch.cfg
    params = arch.init_params(0, device, torch.bfloat16)
    opt = adamw.init(params)
    step = steps.make_train_step(arch, rt, donate=True)
    losses, walls, per_step, lrs, coll_s = [], [], [], [], []
    with ReduceTimer() as reduce_timer:
        for i in range(RANKS_STEPS):
            batch = {"tokens": batch_fn(cfg, i, device)[rows]}
            before = ops.launch_counts()
            with CollectiveTimer() as clock:
                (params, opt, m), wall = timed(
                    lambda: step(params, opt, batch))
            per_step.append(launches_since(before))
            losses.append(float(m["loss"]))
            lrs.append(float(m["lr"]))
            walls.append(wall)
            coll_s.append(clock.s)
    out = {"losses": losses, "step_wall_s": walls,
           "reduce_s": reduce_timer.s,
           "reduce_share": [r / w for r, w in zip(reduce_timer.s, walls)],
           "collective_s": coll_s, "collectives_per_step": clock.kinds(),
           "launches_per_step": per_step, "params": bit_digest(params),
           "opt": bit_digest(opt)}
    if keep:
        out.update(master=samples(opt["master"]), lrs=lrs,
                   first_mean=reduce_timer.first)
    del params, opt, step
    torch.cuda.empty_cache()
    return out


def layout_cfg():
    return pod_cfg()


def tp_serve_cfg():
    return dataclasses.replace(registry.get(TP_SERVE_MODEL).cfg,
                               n_layers=TP_SERVE_LAYERS)


def layout_batch(cfg, step: int, device) -> torch.Tensor:
    """Step ``step``'s global batch of (g1)."""
    return seeded_tokens(cfg, LAYOUT_BATCH, RANKS_SEQ,
                         seed=638 + step).to(device)


def mesh_coords(shape: dict):
    """Every rank's coordinates on a mesh of ``shape``, in rank order."""
    return [dict(zip(shape, idx)) for idx in np.ndindex(*shape.values())]


def block_key(partition, coords: dict) -> tuple:
    """The coordinates that pick a leaf's block under ``partition``:
    two ranks with the same key hold the same block."""
    return tuple((a, coords[a]) for e in partition
                 for a in layers.entry_axes(e))


def block_samples(tree, cfg, table, shape: dict, coords: dict) -> dict:
    """path -> :func:`strided` samples of the block of each leaf of a
    whole tree that the rank at ``coords`` holds under ``table``."""
    def axis(entry):
        names = layers.entry_axes(entry)
        index, size = 0, 1
        for a in names:
            index, size = index * shape[a] + coords[a], size * shape[a]
        return types.SimpleNamespace(index=index, size=size)

    mesh = types.SimpleNamespace(shape=shape, axis=axis)
    mine = layers.shard_params(tree, registry.param_specs(cfg), table, mesh)
    return {path: strided(leaf, LAYOUT_SAMPLE)
            for path, leaf in tree_util.paths(mine)}


class CollectiveTimer:
    """While entered, the seconds this process spends in the ranks'
    collectives (``ranks._call``), each between two synchronisations of
    the card, so that work queued before it is not counted and its own
    is (``gloo`` and ``nccl`` alike: NCCL's calls return before their
    work is done); their count; and :func:`ranks.ledger`'s count of them
    (:meth:`kinds`)."""

    def __enter__(self):
        self.s, self.calls, self._call = 0.0, 0, ranks._call
        self._counting = ranks.ledger()
        self.ledger = self._counting.__enter__()

        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._call(*args, **kwargs)
            torch.cuda.synchronize()
            self.s += time.perf_counter() - t0
            self.calls += 1

        ranks._call = call
        return self

    def __exit__(self, *exc):
        ranks._call = self._call
        self._counting.__exit__(*exc)
        return False

    def kinds(self) -> dict:
        """kind -> {"calls", "operand_bytes"} of the collectives run."""
        out = {}
        for (kind, operand, _), n in sorted(self.ledger.items()):
            calls, nbytes = out.get(kind, (0, 0))
            out[kind] = (calls + n, nbytes + n * operand)
        return {k: {"calls": c, "operand_bytes": b}
                for k, (c, b) in sorted(out.items())}

    def record(self) -> dict:
        return {"collective_s": self.s, "collective_calls": self.calls,
                "collectives": self.kinds()}


def layout_train(arch, params, rt, rows, device) -> tuple:
    """RANKS_STEPS steps of ``make_train_step`` on ``rows`` of each of
    (g1)'s global batches: the parameters after, losses, walls, launches
    a step, and the seconds in the collectives; an MoE's first step's
    router calls (:class:`RouterProbe`) beside them."""
    opt = adamw.init(params)
    step = steps.make_train_step(arch, rt, donate=True)
    losses, walls, per_step, coll_s = [], [], [], []
    probe = RouterProbe(keep_probs=True)
    for i in range(RANKS_STEPS):
        batch = {"tokens": layout_batch(arch.cfg, i, device)[rows]}
        before = ops.launch_counts()
        with CollectiveTimer() as clock, (
                probe if i == 0 and arch.cfg.moe
                else contextlib.nullcontext()):
            (params, opt, m), wall = timed(lambda: step(params, opt, batch))
        per_step.append(launches_since(before))
        losses.append(float(m["loss"]))
        walls.append(wall)
        coll_s.append(clock.s)
    del opt, step
    out = {"losses": losses, "step_wall_s": walls,
           "launches_per_step": per_step, "collective_s": coll_s,
           "collective_calls_per_step": clock.calls,
           "collectives_per_step": clock.kinds()}
    if arch.cfg.moe:
        out["router"] = probe_record(probe)
    return params, out


def probe_record(probe) -> dict:
    """A :class:`RouterProbe`'s calls on the host: routes, probabilities,
    per-token gaps and dropped routes, a call each."""
    return {"routes": [r.cpu() for r in probe.idx],
            "probs": [p.cpu() for p in probe.probs],
            "token_gaps": [g.cpu() for g in probe.token_gaps],
            "drops": [int(d) for d in probe.drops]}


def layout_train_rank(device, cfg=None, shape=None, preset=None,
                      what: str = "(g1)") -> dict:
    """(g1) (or an (h) train part: ``cfg`` under ``preset`` on a mesh of
    ``shape``) on this rank of the four: its blocks of seed 0's weights,
    the gspmd steps on its row, then the blocks' samples and digests (an
    MoE's first step's router calls beside them)."""
    cfg = layout_cfg() if cfg is None else cfg
    shape = LAYOUT_SHAPE if shape is None else shape
    mesh = ranks.RankMesh(shape, device)
    arch = registry.Arch(cfg)
    rt = Runtime(mesh=mesh, rules=rules_lib.get(preset or LAYOUT_PRESET,
                                                arch.cfg))
    check(steps.splits_layout(arch, rt), f"{what} the rules split no leaf")
    full = arch.init_params(0, device, torch.bfloat16)
    params = layers.shard_params(full, arch.param_specs(), rt.rules_(),
                                 mesh)
    del full
    torch.cuda.empty_cache()
    axis = steps.batch_axis(arch, rt)
    torch.cuda.reset_peak_memory_stats()
    params, out = layout_train(arch, params, rt,
                               slice(axis.index, axis.index + 1), device)
    on = rt.on_sequence(RANKS_SEQ, arch.cfg)
    out.update(seq_split=on.seq_axis() is not None, seq_rows=on.seq_rows,
               coords={a: mesh.axis(a).index for a in mesh.shape},
               peak_bytes=torch.cuda.max_memory_allocated(),
               weight_bytes=sum(x.numel() * x.element_size()
                                for x in tree_util.leaves(params)),
               samples={path: strided(leaf, LAYOUT_SAMPLE)
                        for path, leaf in tree_util.paths(params)},
               digests={path: bit_digest({"x": leaf})
                        for path, leaf in tree_util.paths(params)})
    del params
    torch.cuda.empty_cache()
    return out


def layout_unsplit(device, cfg=None, shape=None, preset=None,
                   also=()) -> dict:
    """(g1)'s comparison on one rank (or an (h) train part's): the
    unsplit gspmd steps on the whole global batch, and the samples of
    each rank's block of the parameters after them.  An MoE over more
    than one data shard routes each shard's tokens with a capacity of
    its own and reports shard 0's aux loss (the reference's
    ``shard_map``): its comparison is the folded per-shard step
    (``Runtime(dp_workers=2, gradsync="spindle_per_tensor")``: the same
    mean of the shards' gradients), its loss the shards' mean cross
    entropy plus shard 0's aux at the step's weights, and its first
    step's router calls each shard's.  ``also``: presets whose blocks
    are sampled too (``blocks_under``), for a part that runs the same
    model and batches under another layout."""
    cfg = layout_cfg() if cfg is None else cfg
    shape = LAYOUT_SHAPE if shape is None else shape
    preset = preset or LAYOUT_PRESET
    arch = registry.Arch(cfg)
    per_shard = cfg.moe is not None and shape.get("data", 1) > 1
    torch.cuda.reset_peak_memory_stats()
    params = arch.init_params(0, device, torch.bfloat16)
    if not per_shard:
        params, out = layout_train(arch, params, Runtime(),
                                   slice(0, LAYOUT_BATCH), device)
    else:
        params, out = moe_shards_train(arch, params, device)
    table = rules_lib.get(preset, arch.cfg)
    out.update(peak_bytes=torch.cuda.max_memory_allocated(),
               weight_bytes=sum(x.numel() * x.element_size()
                                for x in tree_util.leaves(params)),
               blocks=[block_samples(params, arch.cfg, table, shape, c)
                       for c in mesh_coords(shape)],
               blocks_under={
                   p: [block_samples(params, arch.cfg,
                                     rules_lib.get(p, arch.cfg), shape, c)
                       for c in mesh_coords(shape)] for p in also})
    del params
    torch.cuda.empty_cache()
    return out


def moe_shards_train(arch, params, device) -> tuple:
    """:func:`layout_unsplit`'s MoE over LAYOUT_BATCH data shards, one
    row each: before each step every shard's cross entropy and aux loss
    at the step's weights (the first step's router calls recorded), then
    the folded per-shard step."""
    cfg = arch.cfg
    opt = adamw.init(params)
    step = steps.make_train_step(arch, Runtime(
        gradsync="spindle_per_tensor", dp_workers=LAYOUT_BATCH), donate=True)
    losses, walls, per_step, router = [], [], [], []
    for i in range(RANKS_STEPS):
        batch = {"tokens": layout_batch(cfg, i, device)}
        ce, aux = [], []
        for w in range(LAYOUT_BATCH):
            with torch.no_grad(), RouterProbe(keep_probs=True) as probe:
                c, a = transformer.lm_loss_terms(
                    params, cfg, {"tokens": batch["tokens"][w:w + 1]},
                    Runtime())
            ce.append(float(c))
            aux.append(float(a))
            if i == 0:
                router.append(probe_record(probe))
        losses.append(sum(ce) / len(ce) + aux[0])
        before = ops.launch_counts()
        (params, opt, _), wall = timed(lambda: step(params, opt, batch))
        per_step.append(launches_since(before))
        walls.append(wall)
    del opt, step
    return params, {"losses": losses, "step_wall_s": walls,
                    "launches_per_step": per_step, "router": router,
                    "per_shard": True}


def local_head_kernels(device, hq: int, hkv: int, seq: int,
                       head_dim: int = 128) -> dict:
    """flash_attention over (1, seq) and flash_decode over a cache of
    seq + TP_DECODE positions at a rank's head counts, against their
    plain versions on the same bf16 inputs."""
    gen = torch.Generator(device=device).manual_seed(hq * 100 + hkv)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.bfloat16)

    q, k, v = rand(1, seq, hq, head_dim), rand(1, seq, hkv, head_dim), \
        rand(1, seq, hkv, head_dim)
    errs = {"flash_attention": within(
        ops.flash_attention(q, k, v, True),
        ops.PLAIN["flash_attention"](q, k, v, True), torch.bfloat16,
        what=f"flash_attention at {hq}/{hkv} heads")}
    kc, vc = rand(1, seq + TP_DECODE, hkv, head_dim), \
        rand(1, seq + TP_DECODE, hkv, head_dim)
    qd = rand(1, hq, head_dim)
    lengths = torch.full((1,), seq + TP_DECODE, dtype=torch.int32,
                         device=device)
    errs["flash_decode"] = within(
        ops.flash_decode(qd, kc, vc, lengths),
        ops.PLAIN["flash_decode"](qd, kc, vc, lengths), torch.bfloat16,
        what=f"flash_decode at {hq}/{hkv} heads")
    return {"heads": [hq, hkv], "head_dim": head_dim, "seq": seq,
            "max_abs_err": errs}


def local_ssd_kernel(device, cfg, tp: int, seq: int) -> dict:
    """ssd_scan at a rank's heads and groups of ``cfg``'s Mamba block
    (``ssm.rank_dims``) over (1, seq), against its plain version on the
    same bf16 inputs."""
    h, g = ssm.rank_dims(cfg, tp)
    s_ = cfg.ssm
    gen = torch.Generator(device=device).manual_seed(h * 10 + g)
    args = ssd_inputs(1, seq, h, s_.head_dim, s_.d_state, g, torch.bfloat16,
                      gen)
    (y, st), (y_want, st_want) = sc.ssd_scan(*args, s_.chunk), \
        sc.ssd_scan_plain(*args, s_.chunk)
    return {"heads": h, "groups": g, "seq": seq,
            "max_abs_err": within(y, y_want, torch.bfloat16,
                                  SSD_Y_TOL[torch.bfloat16],
                                  what=f"ssd_scan at {h} heads"),
            "state_max_abs_err": within(st, st_want, torch.float32,
                                        SSD_STATE_TOL,
                                        what=f"ssd_scan state at {h} "
                                        "heads")}


def family_batch(cfg, seq: int, seed: int, device, dtype) -> dict:
    """A 1 x ``seq`` batch of the family's inputs from ``seed``: tokens,
    and the vlm's ``n_patches`` patch embeddings before ``seq -
    n_patches`` text tokens, or the encdec's ``seq / 2`` frames and
    ``seq / 2`` tokens (the reference's input specs)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_text = seq
    out = {}
    if cfg.family == "vlm":
        n_text = seq - cfg.vlm.n_patches
        out["patches"] = torch.randn((1, cfg.vlm.n_patches,
                                      cfg.vlm.vision_dim), generator=gen,
                                     device=device).to(dtype)
    if cfg.family == "encdec":
        n_text = seq // 2
        out["frames"] = torch.randn((1, seq // 2, cfg.d_model),
                                    generator=gen, device=device).to(dtype)
    out["tokens"] = seeded_tokens(cfg, 1, n_text, seed=seed).to(device)
    return out


def rank_kv(whole: torch.Tensor, cfg, rt) -> torch.Tensor:
    """This rank's kv heads (dim 3) of a whole (L, B, S, Hkv, D) cache:
    ``attention.kv_heads_split`` of them, its share where they split,
    else the one its q heads read."""
    tp = registry.tp_ways(cfg, rt)
    n = attention.kv_heads_split(cfg, tp)
    if n == whole.shape[3]:
        return whole
    axis = rt.tp_axis()
    first = axis.index * n if cfg.n_kv_heads % tp == 0 else \
        axis.index * (cfg.n_heads // tp) // (cfg.n_heads // cfg.n_kv_heads)
    return whole.narrow(3, first, n).contiguous()


def family_serve_run(arch, params, rt, device, feed=None):
    """A served part's path through the entry points: the loss at 1 x
    RANKS_SEQ; a prefill of 1 x TP_PREFILL (the KV cache of the
    decoder families, grown by TP_DECODE positions; the hybrid's
    forward, the encdec's encoder memory) and TP_DECODE greedy decode
    steps after it (or the tokens of ``feed``, (1, TP_DECODE)): from the
    KV cache, or for the recurrent and encdec families from a zero
    decode state fed the prompt's first token (the encdec's cross cache
    seeded, this rank's kv heads of it).  Returns (logits a step (the
    prefill's or the first step's first), tokens fed, the cache's kv
    heads, wall, loss, the prefill's value where it is not logits, the
    collectives' :meth:`CollectiveTimer.record`)."""
    cfg = arch.cfg
    dtype = params["embed"].dtype
    loss_batch = family_batch(cfg, RANKS_SEQ, 838, device, dtype)
    prompt = family_batch(cfg, TP_PREFILL, 839, device, dtype)
    prefill = steps.make_serve_step(arch, rt, "prefill")
    decode = steps.make_serve_step(arch, rt, "decode")

    def run():
        loss = arch.loss_fn()(params, cfg, loss_batch, rt)
        other = None
        if cfg.family in transformer.DECODER_FAMILIES:
            logits, cache = prefill(params, prompt)
            pos = cache["k"].shape[2]
            cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0,
                                                    TP_DECODE))
                     for k, v in cache.items()}
        else:
            specs = arch.cache_specs(
                ShapeConfig("h", TP_DECODE + 1, 1, "decode"),
                tp=registry.tp_ways(cfg, rt))
            # the float64 yardstick keeps its ssm state in float64 too
            cache = layers.map_specs(lambda sp: torch.zeros(
                sp.shape, dtype=dtype if dtype == torch.float64
                else sp.dtype_for(dtype), device=device), specs)
            other = prefill(params, prompt)
            if cfg.family == "encdec":
                other = other[0]
                gen = torch.Generator(device=device).manual_seed(840)
                shape = (cfg.encdec.n_decoder_layers, 1, TP_PREFILL,
                         cfg.n_kv_heads, cfg.head_dim_)
                for k in ("cross_k", "cross_v"):
                    cache[k] = rank_kv(torch.randn(
                        shape, generator=gen, device=device).to(dtype),
                        cfg, rt)
            pos = 0
            logits, cache = decode(params, cache,
                                   {"tokens": prompt["tokens"][:, :1]},
                                   torch.zeros((1,), dtype=torch.int32,
                                               device=device))
            pos = 1
        out, fed = [logits], []
        at = torch.full((1,), pos, dtype=torch.int32, device=device)
        for i in range(TP_DECODE):
            nxt = out[-1].argmax(-1, keepdim=True).to(torch.int32) \
                if feed is None else feed[:, i:i + 1]
            fed.append(nxt)
            logits, cache = decode(params, cache, {"tokens": nxt}, at)
            out.append(logits)
            at = at + 1
        kv = cache["k"].shape[3]
        return torch.stack(out), torch.cat(fed, dim=1), kv, loss, other

    with torch.no_grad(), CollectiveTimer() as clock:
        (logits, fed, kv_heads, loss, other), wall = timed(run)
    return logits, fed, kv_heads, wall, loss, other, clock.record()


def tp_serve_compare(split, whole, fed, split32, whole32, whole64,
                     what: str = "(g2)") -> dict:
    """(g2)'s bars (and a served (h) part's).  The bf16 runs: at every step the split logits no
    farther from the float32 unsplit run on the same (upcast) weights
    than twice the unsplit bf16 logits are, plus 1e-6, both unsplit
    runs fed the split run's tokens (``fed``, ``whole32``; phase 13's
    yardstick: two bf16 paths that round at different points differ by
    more than the bf16 bar at some of 152,064 logits, each as far from
    float32 as the other); and the greedy tokens of the split and the
    unsplit runs equal wherever the unsplit top-2 gap exceeds twice the
    two runs' distances from float32 added (where no pair of logits
    within those distances can swap; after a nearer tie the runs feed
    different tokens: the comparison stops there).  The float32 runs,
    fed the split bf16 run's tokens: the split logits no farther from
    the float64 unsplit run than twice the unsplit float32 logits are,
    plus 1e-6 (two float32 paths that sum the 8192- and 29568-long
    products in different orders differ by more than the float32 bar at
    full width)."""
    tol = TOL[torch.bfloat16]
    top2 = torch.topk(whole[0].float(), 2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).reshape(-1).tolist()
    errs, e_split, e_fed, bar = [], [], [], []
    errs32, e_split32, e_whole32 = [], [], []
    for i in range(TP_DECODE + 1):
        got, want = split[0][i].float(), fed[0][i].float()
        yard = whole32[0][i].float()
        errs.append(float((got - want).abs().max()))
        bar.append(float(((got - want).abs() - tol - tol * want.abs())
                         .max()))
        e_split.append(float((got - yard).abs().max()))
        e_fed.append(float((want - yard).abs().max()))
        check(e_split[-1] <= 2 * e_fed[-1] + 1e-6, f"{what} logits, step "
              f"{i}: {e_split[-1]} from float32 against the unsplit "
              f"bf16's {e_fed[-1]}")
        yard = whole64[0][i].double()
        errs32.append(float((split32[0][i] - whole32[0][i]).abs().max()))
        e_split32.append(float((split32[0][i].double() - yard).abs().max()))
        e_whole32.append(float((whole32[0][i].double() - yard).abs().max()))
        check(e_split32[-1] <= 2 * e_whole32[-1] + 1e-6, f"{what} float32 "
              f"logits, step {i}: {e_split32[-1]} from float64 against "
              f"the unsplit float32's {e_whole32[-1]}")
    tokens_equal, compared = True, 0
    for i in range(TP_DECODE):
        same = torch.equal(split[1][:, i], whole[1][:, i])
        apart = 2 * (e_split[i] + e_fed[i])
        if gaps[i] > apart:
            check(same, f"{what} greedy token {i} differs at a top-2 gap of "
                  f"{gaps[i]} > {apart}")
        compared = i + 1
        if not same:
            tokens_equal = False
            break
    return {"logits_max_err": max(errs), "bf16_bar_excess": bar,
            "bf16_bar_met": max(bar) <= 0,
            "split_from_float32": e_split, "unsplit_from_float32": e_fed,
            "float32_logits_max_err": max(errs32),
            "float32_split_from_float64": e_split32,
            "float32_unsplit_from_float64": e_whole32,
            "top2_gaps": gaps, "greedy_tokens_equal": tokens_equal,
            "greedy_tokens_compared": compared,
            "tokens_split": split[1].tolist(),
            "tokens_unsplit": whole[1].tolist(), "tol": tol,
            "tol_float32": TOL[torch.float32]}


def prefill_yardstick(split, whole, whole32, what: str) -> dict:
    """A prefill's value that is not logits (the hybrid's forward loss,
    the encdec's encoder memory) held as the logits are: the split bf16
    run no farther from the unsplit float32 run than twice the unsplit
    bf16 run is, plus 1e-6 (phase 13's yardstick)."""
    yard = whole32.float()
    e_split = float((split.float() - yard).abs().max())
    e_whole = float((whole.float() - yard).abs().max())
    check(e_split <= 2 * e_whole + 1e-6, f"{what} prefill: {e_split} from "
          f"float32 against the unsplit bf16's {e_whole}")
    return {"prefill_max_err": float((split.float() - whole.float()).abs()
                                     .max()),
            "prefill_split_from_float32": e_split,
            "prefill_unsplit_from_float32": e_whole}


def loss_yardstick(split, whole, whole32, what: str) -> dict:
    """A served part's loss held by phase 13's yardstick: the split bf16
    loss no farther from the unsplit float32 loss (on the upcast
    weights) than twice the unsplit bf16 loss is, plus 1e-6."""
    yard = float(whole32)
    e_split, e_whole = abs(float(split) - yard), abs(float(whole) - yard)
    check(e_split <= 2 * e_whole + 1e-6, f"{what} loss: {e_split} from "
          f"float32 against the unsplit bf16's {e_whole}")
    return {"loss_split_from_float32": e_split,
            "loss_unsplit_from_float32": e_whole}


def handoff_check(device, cfg, tp: int, seq: int) -> dict:
    """(j)'s state handoff on the card: ``cfg``'s scan over (1, ``seq``)
    at its whole heads, the rows of ``tp`` ranks simulated in this
    process (``ssm.ssd_local`` through the ``ssd_scan`` kernel on each
    rank's rows, every pair stacked in rank order, each rank's
    ``ssm.ssd_handoff``): the fold and the correction on the card
    against the same math on the CPU from the same kernel outputs
    (float32, 1e-4 relative), and the rows joined against the kernel's
    scan of the whole sequence (the bf16 bar of ``ssd_scan``)."""
    s_ = cfg.ssm
    h, g = ssm.rank_dims(cfg, 1)
    gen = torch.Generator(device=device).manual_seed(938)
    args = ssd_inputs(1, seq, h, s_.head_dim, s_.d_state, g,
                      torch.bfloat16, gen)
    rows = seq // tp
    local, cpu = [], []
    for r in range(tp):
        part = [a[:, r * rows:(r + 1) * rows] if a.dim() > 1 else a
                for a in args]
        local.append((ssm.ssd_local(sc.ssd_scan, *part, s_.chunk), part[4]))
    every = torch.stack([pair for (_, _, pair), _ in local])
    ys, err = [], 0.0
    for r, ((y0, cs, _), c) in enumerate(local):
        ys.append(ssm.ssd_handoff(y0, cs, c, every, r)[0])
        # the fold and the correction in float32 (y0 upcast), so that no
        # rounding to bf16 hides or makes a difference
        y, final = ssm.ssd_handoff(y0.float(), cs, c, every, r)
        y_cpu, final_cpu = ssm.ssd_handoff(y0.float().cpu(), cs.cpu(),
                                           c.cpu(), every.cpu(), r)
        err = max(err, within(y.cpu(), y_cpu, torch.float32, 1e-4,
                              what=f"(j) handoff rank {r} y"),
                  within(final.cpu(), final_cpu, torch.float32, 1e-4,
                         what=f"(j) handoff rank {r} final state"))
    y_whole, state_whole = sc.ssd_scan(*args, s_.chunk)
    return {"ranks": tp, "rows": rows, "heads": h,
            "card_vs_cpu_max_abs_err": err,
            "joined_vs_whole_max_abs_err": within(
                torch.cat(ys, 1), y_whole, torch.bfloat16,
                SSD_Y_TOL[torch.bfloat16], what="(j) rows joined"),
            "final_state_vs_whole_max_abs_err": within(
                final, state_whole, torch.float32, SSD_STATE_TOL,
                what="(j) final state")}


def serve_part(part: str):
    """A served part's (config, mesh shape, preset): (g2), or an (h)
    part of FAMILY_PARTS."""
    if part == "g2":
        return tp_serve_cfg(), TP_SERVE_SHAPE, TP_SERVE_PRESET
    if part == "i2":
        return tp_serve_cfg(), TP_SERVE_SHAPE, SEQ_SERVE_PRESET
    if part == "j2":
        return family_cfg("h2"), TP_SERVE_SHAPE, SSM_SEQ_PRESET
    _, _, shape, preset = FAMILY_PARTS[part]
    return family_cfg(part), shape, preset


def tp_serve_rank(rank, device, part: str = "g2") -> tuple:
    """(g2) (or a served (h) part) on this rank of the two: its blocks of
    seed 0's weights under the part's preset, the loss, prefill and
    decode in bf16 (the counted path); rank 0 then the unsplit path,
    greedy and fed the split run's tokens; both ranks again in float32
    on the upcast weights, fed the split run's tokens, and rank 0 the
    unsplit float32 path so fed (the yardstick of the bf16 runs), the
    unsplit float64 plain path so fed (the yardstick of the float32
    runs), and the kernels at the local heads.  Returns (results, this
    rank's launches on the path)."""
    what = f"({part})"
    cfg, shape, preset = serve_part(part)
    mesh = ranks.RankMesh(shape, device)
    arch = registry.Arch(cfg)
    rt = Runtime(mesh=mesh, rules=rules_lib.get(preset, cfg))
    check(steps.splits_layout(arch, rt), f"{what} the rules split no leaf")
    specs = arch.param_specs()
    full = arch.init_params(0, device, torch.bfloat16)
    mine = layers.shard_params(full, specs, rt.rules_(), mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    split = family_serve_run(arch, mine, rt, device)
    counts = ops.launch_counts()
    hq = cfg.n_heads // registry.tp_ways(cfg, rt) \
        if cfg.n_heads % registry.tp_ways(cfg, rt) == 0 else cfg.n_heads
    out = {"heads_here": [hq, split[2]], "wall_s": split[3],
           "loss": float(split[4]), **split[6],
           "seq_split": [rt.on_sequence(n, cfg).seq_axis() is not None
                         for n in (RANKS_SEQ, TP_PREFILL, 1)],
           "seq_rows": rt.on_sequence(RANKS_SEQ, cfg).seq_rows,
           "weight_bytes": sum(x.numel() * x.element_size()
                               for x in tree_util.leaves(mine)),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    if rank == 0:                            # the unsplit path beside it
        whole = family_serve_run(arch, full, Runtime(), device)
        fed = family_serve_run(arch, full, Runtime(), device,
                               feed=split[1])
        out.update(unsplit_wall_s=whole[3], unsplit_weight_bytes=sum(
            x.numel() * x.element_size() for x in tree_util.leaves(full)),
            unsplit_heads=[cfg.n_heads, whole[2]],
            loss_unsplit=float(whole[4]),
            loss_err=within(split[4], whole[4], torch.bfloat16,
                            what=f"{what} loss against unsplit"))
    del mine
    full = tree_util.map(lambda t: t.float(), full)
    torch.cuda.empty_cache()
    split32 = family_serve_run(arch, layers.shard_params(
        full, specs, rt.rules_(), mesh), rt, device, feed=split[1])
    if rank == 0:
        whole32 = family_serve_run(arch, full, Runtime(), device,
                                   feed=split[1])
        if split[5] is not None:
            out.update(prefill_yardstick(split[5], whole[5], whole32[5],
                                         what))
        if part == "j2":
            out.update(loss_yardstick(split[4], whole[4], whole32[4],
                                      what))
        full = tree_util.map(lambda t: t.double(), full)
        torch.cuda.empty_cache()
        whole64 = family_serve_run(arch, full, Runtime(kernels="plain"),
                                   device, feed=split[1])
        out.update(tp_serve_compare(split, whole, fed, split32, whole32,
                                    whole64, what),
                   kernels=local_head_kernels(device, hq, split[2],
                                              TP_PREFILL, cfg.head_dim_))
        del whole, fed, whole32, whole64
    del full, split, split32
    torch.cuda.empty_cache()
    dist.barrier()
    return out, counts


def local_norm_kernels(device, rows: int, d: int) -> dict:
    """``rms_norm`` and ``rms_norm_residual`` over (1, rows, d), a rank's
    rows of a split sequence, against their plain versions on the same
    bf16 inputs."""
    gen = torch.Generator(device=device).manual_seed(rows + d)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.bfloat16)

    x, res, w = rand(1, rows, d), rand(1, rows, d), rand(d)
    what = f"at {rows} x {d}"
    errs = {"rms_norm": within(
        ops.rms_norm(x, w, 1e-6), ops.PLAIN["rms_norm"](x, w, 1e-6),
        torch.bfloat16, what=f"rms_norm {what}")}
    got = ops.rms_norm_residual(x, res, w, 1e-6)
    want = ops.PLAIN["rms_norm_residual"](x, res, w, 1e-6)
    errs["rms_norm_residual"] = max(
        within(a, b, torch.bfloat16, what=f"rms_norm_residual {what}")
        for a, b in zip(got, want))
    return {"rows": rows, "d": d, "max_abs_err": errs}


def tp_launches(cfg, want: dict, table=None, shape=None) -> dict:
    """``want`` (a step's launches unsplit) on a rank whose Mamba heads
    split (under ``table`` on a mesh of ``shape``, when given): each
    Mamba layer's gated norm is ``layers.rms_norm_split``, not the
    ``rms_norm`` site.  Under ``ssm_seq`` the heads stay whole."""
    if cfg.ssm is None:
        return want
    if table is not None and registry.tp_ways(cfg, Runtime(
            mesh=ranks.RankMesh.ledger(shape), rules=table)) == 1:
        return want
    return dict(want, rms_norm=want["rms_norm"] - cfg.n_layers)


def layout_compare(results, unsplit, key: str = "g", cfg=None,
                   shape=None, preset=None) -> dict:
    """(g1)'s bars (see the module's docstring), or an (h) train part's
    (``key``: the part's entry in each rank's results)."""
    tol = TOL[torch.bfloat16]
    cfg = layout_cfg() if cfg is None else cfg
    shape = LAYOUT_SHAPE if shape is None else shape
    what = "(g1)" if key == "g" else f"({key})"
    want = train_launches(cfg, 1, 0)
    table = rules_lib.get(preset or LAYOUT_PRESET, cfg)
    layout = layers.tree_layout(registry.param_specs(cfg), table,
                                types.SimpleNamespace(shape=shape))
    per_shard = unsplit.get("per_shard", False)
    unsplit_want = train_launches(cfg, LAYOUT_BATCH, 0) if per_shard \
        else want
    check(all(made == unsplit_want for made in unsplit["launches_per_step"]),
          f"{what} unsplit launches {unsplit['launches_per_step']}, want "
          f"{unsplit_want}")
    split_want = tp_launches(cfg, want, table, shape)
    coords = mesh_coords(shape)
    errs, same, holders = [], {}, collections.Counter()
    routes = {}
    for r, got in enumerate(x[key] for x in results):
        for i, made in enumerate(got["launches_per_step"]):
            check(made == split_want, f"{what} rank {r} step {i}: launches "
                  f"{made}, want {split_want}")
        for i, (a, b) in enumerate(zip(got["losses"], unsplit["losses"])):
            check(abs(a - b) <= tol + tol * abs(b), f"{what} rank {r} loss "
                  f"{i}: {a} against unsplit {b}")
        blocks = unsplit["blocks"][coords.index(got["coords"])]
        for path, sample in got["samples"].items():
            errs.append(within(sample, blocks[path], torch.bfloat16,
                               what=f"{what} rank {r} {path}"))
        for path, digest in got["digests"].items():
            k = (path, block_key(layout[path], got["coords"]))
            holders[k] += 1
            check(same.setdefault(k, digest) == digest,
                  f"{what} rank {r}: its block of {path} differs from "
                  "another rank's same block")
        if "router" in got:
            shard = got["coords"].get("data", 0)
            ref = unsplit["router"][shard] if per_shard else \
                unsplit["router"]
            routes[r] = router_compare(got["router"], ref, f"{what} rank "
                                       f"{r}")
    walls = [x[key]["step_wall_s"] for x in results]
    coll = [x[key]["collective_s"] for x in results]
    out = {"losses_split": [x[key]["losses"] for x in results],
           "losses_unsplit": unsplit["losses"],
           "params_max_err": max(errs), "leaves_sampled":
           len(results[0][key]["samples"]), "sample": LAYOUT_SAMPLE,
           "blocks_held_by_several_ranks": sum(
               1 for n in holders.values() if n > 1),
           "launches_per_step": split_want,
           "launches_per_step_unsplit": unsplit_want,
           "step_wall_s_split": walls,
           "step_wall_s_unsplit": unsplit["step_wall_s"],
           "collective_s_split": coll,
           "collective_share_split": [[g / w for g, w in zip(gs, ws)]
                                      for gs, ws in zip(coll, walls)],
           "collective_calls_per_step":
           results[0][key]["collective_calls_per_step"],
           "peak_bytes_split": [x[key]["peak_bytes"] for x in results],
           "peak_bytes_unsplit": unsplit["peak_bytes"],
           "weight_bytes_split": [x[key]["weight_bytes"] for x in results],
           "weight_bytes_unsplit": unsplit["weight_bytes"], "tol": tol}
    if routes:
        out["first_step_router"] = routes
    return out


def router_compare(got: dict, want: dict, what: str) -> dict:
    """The first step's router calls of a rank against the unsplit
    path's on the same tokens: a token's routes may differ only where
    two of its experts swap, whose unsplit gap is at most twice the
    largest difference of the two runs' probabilities at that token
    (the split path's router input differs by the roundings of its
    row-parallel sums); the drops equal wherever no route moved."""
    check(len(got["routes"]) == len(want["routes"]),
          f"{what}: {len(got['routes'])} router calls, unsplit "
          f"{len(want['routes'])}")
    moved_total, shifts, equal_calls = 0, [], 0
    for i, (a, b) in enumerate(zip(got["routes"], want["routes"])):
        moved = (a != b).any(-1)
        shift = (got["probs"][i] - want["probs"][i]).abs().amax(-1)
        gap = want["token_gaps"][i]
        check(bool((gap[moved] <= 2 * shift[moved]).all()),
              f"{what} router call {i}: a route moved at an unsplit gap "
              "wider than the probabilities moved")
        if not moved.any():
            equal_calls += 1
            check(got["drops"][i] == want["drops"][i], f"{what} router call "
                  f"{i}: routes equal, drops {got['drops'][i]} against "
                  f"{want['drops'][i]}")
        moved_total += int(moved.sum())
        shifts.append(float(shift.max()))
    return {"calls": len(want["routes"]), "calls_routes_equal": equal_calls,
            "tokens_moved": moved_total, "max_prob_shift": max(shifts),
            "drops_split": got["drops"], "drops_unsplit": want["drops"]}


def ranks_folded_child(rank, device):
    """(a)'s comparison, the folded path ``Runtime(dp_workers=2)`` on the
    whole global batch; then (d), one train step over ``nccl`` at world
    size 1 (this process is a one-rank spawn: its own card) against the
    folded W = 1 step, and the rank forms of the three reductions over
    ``nccl`` against the folded forms at W = 1."""
    arch = registry.Arch(ranks_cfg())
    rows = slice(0, RANKS_BATCH)
    torch.cuda.reset_peak_memory_stats()
    folded = {mode: ranks_train_mode(
        arch, Runtime(gradsync=mode, dp_workers=RANKS_BATCH), rows, device)
        for mode in RANKS_MODES}
    peak = torch.cuda.max_memory_allocated()

    # (d): nccl at world size 1
    mesh = ranks.RankMesh({"data": 1}, device)
    axis = mesh.axis("data")
    params = arch.init_params(0, device, torch.bfloat16)
    batch = {"tokens": ranks_batch(arch.cfg, 0, device)[:1]}
    plain = steps.make_train_step(arch, Runtime(gradsync="spindle"))
    new_p, new_o, m = plain(params, adamw.init(params), batch)
    want = (float(m["loss"]), bit_digest(new_p), bit_digest(new_o))
    del new_p, new_o, m
    d = {}
    for mode in ("spindle", "spindle_per_tensor"):
        rt = Runtime(gradsync=mode, mesh=mesh)
        loss, grads = steps.rank_grads(arch, rt)(params, batch)
        new_p, new_o, _ = adamw.update(adamw.OptConfig(), grads,
                                       adamw.init(params))
        del grads
        d[mode] = (float(loss), bit_digest(new_p), bit_digest(new_o)) == want
        del new_p, new_o
        check(d[mode], f"(d) {mode} over nccl at world size 1 is not the "
              "folded W = 1 step bit for bit")
    _, grads = steps.value_and_grad(arch, Runtime())(params, batch)
    plan = gradsync.make_plan(grads, target_bytes=steps.BUCKET_BYTES)
    got, _ = gradsync.compressed_psum_mean(grads, plan, None, Runtime(),
                                           axis)
    want, _ = gradsync.compressed_psum_mean(
        tree_util.map(lambda g: g[None], grads), plan, None, Runtime())
    d["spindle_compressed"] = bit_digest(got) == bit_digest(want)
    check(d["spindle_compressed"], "(d) the compressed reduction over nccl "
          "is not the folded W = 1 one bit for bit")
    del params, grads, got, want
    torch.cuda.empty_cache()
    return {"folded": folded, "peak_bytes": peak, "nccl_world1": d,
            "backend": mesh.backend, "e": ep_train_unsplit(device),
            "f": pod_folded(device), "g": layout_unsplit(device),
            "h": {part: layout_unsplit(
                device, family_cfg(part), *FAMILY_PARTS[part][2:],
                also=(SSM_SEQ_PRESET,) if part == "h1" else ())
                for part in FAMILY_TRAINED}}


def ep_train(arch, params, rt, device):
    """(e)'s EP_TRAIN_STEPS steps of ``make_train_step`` from ``params``:
    the state after, and losses, walls, the collectives' seconds a step
    and the last step's by kind, launches a step, every router call's
    routes and dropped routes."""
    opt = adamw.init(params)
    step = steps.make_train_step(arch, rt, donate=True)
    losses, walls, per_step, coll_s = [], [], [], []
    with RouterProbe(keep_probs=True) as probe:
        for i in range(EP_TRAIN_STEPS):
            batch = {"tokens": seeded_tokens(arch.cfg, 1, EP_TRAIN_SEQ,
                                             seed=438 + i).to(device)}
            before = ops.launch_counts()
            with CollectiveTimer() as clock:
                (params, opt, m), wall = timed(
                    lambda: step(params, opt, batch))
            per_step.append(launches_since(before))
            losses.append(float(m["loss"]))
            walls.append(wall)
            coll_s.append(clock.s)
    return params, opt, {
        "losses": losses, "step_wall_s": walls, "collective_s": coll_s,
        "collectives_per_step": clock.kinds(),
        "launches_per_step": per_step,
        "routes": [r.cpu() for r in probe.idx],
        "token_gaps": [g.cpu() for g in probe.token_gaps],
        "probs": [p.cpu() for p in probe.probs],
        "drops": [int(d) for d in probe.drops]}


def ep_train_unsplit(device) -> dict:
    """(e)'s comparison: the unsplit step on one rank (every expert
    here), :func:`samples` of its parameters after the steps."""
    arch = registry.Arch(ep_train_cfg())
    torch.cuda.reset_peak_memory_stats()
    params = arch.init_params(0, device, torch.bfloat16)
    params, opt, out = ep_train(arch, params, Runtime(), device)
    out.update(samples=samples(params),
               peak_bytes=torch.cuda.max_memory_allocated())
    del params, opt
    torch.cuda.empty_cache()
    return out


def pod_folded(device) -> dict:
    """(f)'s comparisons on one rank: the folded ``Runtime(dp_workers=4)``
    step of ``spindle`` and ``spindle_per_tensor`` on the whole global
    batch; and the compressed mode's two-leg mean of the four ranks' own
    first-step gradients (worker ``2 pod + data``'s rows): the int8 leg
    over each pod's two data workers, then the plain mean over the
    pods, with each leaf's quantization step (its bucket's largest
    scale over both pods' shards)."""
    arch = registry.Arch(pod_cfg())
    out = {mode: ranks_train_mode(
        arch, Runtime(gradsync=mode, dp_workers=POD_BATCH),
        slice(0, POD_BATCH), device, pod_batch, keep=True)
        for mode in ("spindle", "spindle_per_tensor")}
    params = arch.init_params(0, device, torch.bfloat16)
    batch = {"tokens": pod_batch(arch.cfg, 0, device)}
    _, stacked = steps.worker_grads(
        arch, Runtime(dp_workers=POD_BATCH))(params, batch)
    del params
    plan = gradsync.make_plan(tree_util.map(lambda g: g[0], stacked),
                              target_bytes=steps.BUCKET_BYTES)
    scales, quantize = [], ops.quantize

    def recording(x, block):
        q, s = quantize(x, block)
        scales.append(float(s.max()))
        return q, s

    ops.quantize = recording
    try:
        legs = [gradsync.compressed_psum_mean(
            tree_util.map(lambda g: g[2 * pod:2 * pod + 2], stacked), plan,
            None, Runtime())[0] for pod in range(2)]
    finally:
        ops.quantize = quantize
    del stacked
    mean = gradsync.per_tensor_psum_mean(
        tree_util.map(lambda a, b: torch.stack([a, b]), *legs))
    paths = [path for path, _ in tree_util.paths(mean)]
    step_of = {}
    for b in range(plan.n_buckets):
        for i in plan.bucket_leaves(b):
            step_of[paths[i]] = max(scales[b], scales[plan.n_buckets + b])
    out["compressed"] = {"mean": samples(mean), "step": step_of,
                         "buckets": plan.n_buckets}
    del legs, mean
    torch.cuda.empty_cache()
    return out


def ep_run(arch, params, rt, loss_tokens, prompt, device):
    """(b)'s path through the entry points: the bf16 loss, a prefill
    into a preallocated cache, greedy decode steps.  Returns (loss,
    logits a step (prefill first), tokens fed, the router probe, wall,
    the collectives' :meth:`CollectiveTimer.record`)."""
    cfg = arch.cfg
    cache = {k: torch.zeros((cfg.n_layers, 1, EP_PREFILL + EP_DECODE,
                             cfg.n_kv_heads, cfg.head_dim_),
                            dtype=torch.bfloat16, device=device)
             for k in ("k", "v")}
    decode = steps.make_serve_step(arch, rt, "decode")

    def run():
        loss = arch.loss_fn()(params, cfg, {"tokens": loss_tokens}, rt)
        logits, _ = arch.prefill_fn()(params, {"tokens": prompt}, rt,
                                      cache=cache)
        out, fed = [logits], []
        pos = torch.full((1,), EP_PREFILL, dtype=torch.int32, device=device)
        for _ in range(EP_DECODE):
            nxt = out[-1].argmax(-1, keepdim=True).to(torch.int32)
            fed.append(nxt)
            logits, _ = decode(params, cache, {"tokens": nxt}, pos)
            out.append(logits)
            pos = pos + 1
        return loss, torch.stack(out), torch.cat(fed, dim=1)

    with torch.no_grad(), RouterProbe() as log, CollectiveTimer() as clock:
        (loss, logits, fed), wall = timed(run)
    return loss, logits, fed, log, wall, clock.record()


def ep_compare(split, whole, cfg) -> dict:
    """(b)'s bars: the loss and the logits within the bf16 tolerance,
    the greedy tokens equal wherever the unsplit top-2 gap exceeds it
    (after a near tie the two runs may feed different tokens, so the
    comparison stops there), routes and drops equal on the calls both
    runs share."""
    tol = TOL[torch.bfloat16]
    loss_err = within(split[0], whole[0], torch.bfloat16,
                      what="EP loss against unsplit")
    top2 = torch.topk(whole[1].float(), 2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).reshape(-1).tolist()
    tokens_equal, compared, errs = True, 0, []
    for i in range(EP_DECODE + 1):
        errs.append(within(split[1][i], whole[1][i], torch.bfloat16,
                           what=f"EP logits, step {i}"))
        compared = i + 1
        if i == EP_DECODE:
            break
        same = torch.equal(split[2][:, i], whole[2][:, i])
        if gaps[i] > tol:
            check(same, f"EP greedy token {i} differs at a top-2 gap of "
                  f"{gaps[i]} > {tol}")
        elif not same:
            tokens_equal = False
            break
    # router calls: n_layers for the loss, the prefill and each step fed
    # the same token
    calls = cfg.n_layers * (2 + compared - 1)
    ls, lw = split[3], whole[3]
    routes_equal = all(torch.equal(a, b)
                       for a, b in zip(ls.idx[:calls], lw.idx[:calls]))
    drops = [int(sum(int(d) for d in log.drops[:calls])) for log in (ls, lw)]
    check(routes_equal, "EP routes differ from the unsplit path's")
    check(drops[0] == drops[1], f"EP dropped {drops[0]} routes, unsplit "
          f"{drops[1]}")
    return {"loss_split": float(split[0]), "loss_unsplit": float(whole[0]),
            "loss_err": loss_err, "logits_max_err": max(errs),
            "logit_steps_compared": compared, "top2_gaps": gaps,
            "greedy_tokens_equal": tokens_equal,
            "tokens_split": split[2].tolist(),
            "tokens_unsplit": whole[2].tolist(),
            "router_calls_compared": calls, "routes_equal": routes_equal,
            "routes_dropped": drops[1],
            "min_router_gap": min(float(g) for g in lw.gaps[:calls]),
            "tol": tol}


def ranks_child(rank, device):
    """Phase 38's two ranks (sharing the card over ``gloo``, or in phase
    39 one a card over ``nccl``): (a) the train step, (b) expert
    parallelism, (c) the SST push, then (e), (g2), (h2), (h4), (i2) and
    (j2).  Returns this rank's results; rank 0 also holds (b) against
    the unsplit path."""
    out = {"rank": rank}
    mesh = ranks.RankMesh({"data": 2}, device)
    axis = mesh.axis("data")
    arch = registry.Arch(ranks_cfg())
    rows = slice(axis.index, axis.index + 1)
    ops.reset_launch_counts()                # the ranks path starts here
    torch.cuda.reset_peak_memory_stats()
    out["a"] = {mode: ranks_train_mode(
        arch, Runtime(gradsync=mode, mesh=mesh), rows, device)
        for mode in RANKS_MODES}
    out["backend"], out["device"] = mesh.backend, str(device)
    out["a_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["a_peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
    counts = ops.launch_counts()
    if rank == 0:                            # progress, before (b) runs
        emit({"phase": 38, "part": "a", "rank": 0,
              "losses": {m: r["losses"] for m, r in out["a"].items()},
              "step_wall_s": {m: r["step_wall_s"]
                              for m, r in out["a"].items()},
              "reduce_s": {m: r["reduce_s"] for m, r in out["a"].items()},
              "peak_bytes": out["a_peak_bytes"]})

    # (b) expert parallelism over a {"data": 1, "model": 2} mesh
    ep_mesh = ranks.RankMesh({"data": 1, "model": 2}, device)
    cfg = ep_cfg()
    ep_arch = registry.Arch(cfg)
    model = ep_mesh.axis("model")
    full = ep_arch.init_params(0, device, torch.bfloat16)
    mine = moe.shard_experts(full, model.index, model.size)
    if rank:
        del full
    torch.cuda.empty_cache()
    loss_tokens = seeded_tokens(cfg, 1, EP_SEQ, seed=238).to(device)
    prompt = seeded_tokens(cfg, 1, EP_PREFILL, seed=239).to(device)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    split = ep_run(ep_arch, mine, Runtime(mesh=ep_mesh), loss_tokens,
                   prompt, device)
    counts = collections.Counter(counts) + collections.Counter(
        ops.launch_counts())                 # ... and ends here
    out["b"] = {"experts_here": mine["layers"]["moe"]["w_gate"].shape[1],
                "wall_s": split[4], **split[5], "peak_bytes":
                torch.cuda.max_memory_allocated()}
    if rank == 0:                            # the unsplit path beside it
        whole = ep_run(ep_arch, full, Runtime(), loss_tokens, prompt,
                       device)
        out["b"].update(ep_compare(split, whole, cfg),
                        unsplit_wall_s=whole[4])
        del full, whole
    del mine, split
    torch.cuda.empty_cache()
    dist.barrier()

    # (c) the SST push over the data axis: int32, exact
    rng = np.random.default_rng(338)
    own, local = {}, {}
    for name, shape in SST_PUSH_COLUMNS.items():
        own[name] = torch.from_numpy(rng.integers(
            0, 1 << 20, size=(2,) + shape, dtype=np.int32)).to(device)
        local[name] = own[name] + torch.from_numpy(rng.integers(
            -50, 50, size=(2,) + shape, dtype=np.int32)).to(device)
    got = sst.push_rows({k: v[rank:rank + 1] for k, v in own.items()},
                        local, axis)
    out["c"] = all(got[k].dtype == torch.int32
                   and torch.equal(got[k], torch.maximum(own[k], local[k]))
                   for k in own)
    check(out["c"], "push_rows is not the elementwise max of the rows")

    # (e) training through the experts split over the model axis
    ops.reset_launch_counts()
    out["e"] = ep_train_rank(ep_mesh, device)
    counts = collections.Counter(counts) + collections.Counter(
        ops.launch_counts())
    # (g2) serving on the "megatron" layout over {"model": 2}
    out["g"], g_counts = tp_serve_rank(rank, device)
    counts = counts + collections.Counter(g_counts)
    # (h2), (h4): the other families served on it
    for part in FAMILY_SERVED:
        out[part], h_counts = tp_serve_rank(rank, device, part)
        counts = counts + collections.Counter(h_counts)
    # (i2) serving on the "megatron_seq" layout over {"model": 2}
    out["i2"], i_counts = tp_serve_rank(rank, device, "i2")
    counts = counts + collections.Counter(i_counts)
    # (j2) (h2)'s model served under "ssm_seq" over {"model": 2}
    out["j2"], j_counts = tp_serve_rank(rank, device, "j2")
    counts = counts + collections.Counter(j_counts)
    if rank == 0:
        out["h2"]["ssd"] = local_ssd_kernel(
            device, family_cfg("h2"), TP_SERVE_SHAPE["model"], TP_PREFILL)
        d = tp_serve_cfg().d_model
        out["i2"]["norms"] = [local_norm_kernels(
            device, n // TP_SERVE_SHAPE["model"], d)
            for n in (RANKS_SEQ, TP_PREFILL)]
    out["counts"] = dict(counts)
    return out


def ep_train_rank(mesh, device) -> dict:
    """(e) on this rank: its experts of seed 0's weights, the steps under
    ``gspmd`` on ``mesh``, :func:`samples` of its parameters after them
    and a digest of its non-expert state."""
    model = mesh.axis("model")
    arch = registry.Arch(ep_train_cfg())
    full = arch.init_params(0, device, torch.bfloat16)
    mine = moe.shard_experts(full, model.index, model.size)
    del full
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, opt, e = ep_train(arch, mine, Runtime(mesh=mesh), device)
    del mine
    whole = {"params": params, "opt": opt}
    e.update(samples=samples(params, model.index),
             non_expert=bit_digest({path: leaf for path, leaf
                                    in tree_util.paths(whole)
                                    if not moe.is_expert_leaf(path)}),
             experts_here=params["layers"]["moe"]["w_gate"].shape[1],
             peak_bytes=torch.cuda.max_memory_allocated())
    del params, opt, whole
    torch.cuda.empty_cache()
    return e


def pod_child(rank, device):
    """(f)'s four ranks (sharing the card over ``gloo``, or in phase 39
    one a card over ``nccl``): qwen3-1.7b at POD_LAYERS layers on
    ``{"pod": 2, "data": 2}``, each mode's steps on this rank's row of the
    global batch; then (g1), (h1), (h3), (i1) and (j1)."""
    mesh = ranks.RankMesh(POD_SHAPE, device)
    axis = mesh.axis(POD_AXES)
    arch = registry.Arch(pod_cfg())
    rows = slice(axis.index, axis.index + 1)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out = {"rank": rank, "index": axis.index, "backend": mesh.backend,
           "device": str(device)}
    for mode in POD_MODES:
        # the ranks' states are compared whole by digest; samples of one
        # rank's are enough beside them
        out[mode] = ranks_train_mode(
            arch, Runtime(gradsync=mode, mesh=mesh, dp_axes=POD_AXES), rows,
            device, pod_batch, keep=axis.index == 0)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    counts = collections.Counter(ops.launch_counts())
    # (g1) training on the "baseline" layout over {"data": 2, "model": 2}
    ops.reset_launch_counts()
    out["g"] = layout_train_rank(device)
    counts += collections.Counter(ops.launch_counts())
    # (h1), (h3): the other families trained on it
    for part in FAMILY_TRAINED:
        ops.reset_launch_counts()
        out[part] = layout_train_rank(device, family_cfg(part),
                                      *FAMILY_PARTS[part][2:],
                                      what=f"({part})")
        counts += collections.Counter(ops.launch_counts())
    # (i1) training under "seq_model" on (g1)'s mesh
    ops.reset_launch_counts()
    out["i1"] = layout_train_rank(device, layout_cfg(), LAYOUT_SHAPE,
                                  SEQ_TRAIN_PRESET, what="(i1)")
    counts += collections.Counter(ops.launch_counts())
    # (j1) (h1)'s model trained under "ssm_seq" on (g1)'s mesh
    ops.reset_launch_counts()
    out["j1"] = layout_train_rank(device, family_cfg("h1"), LAYOUT_SHAPE,
                                  SSM_SEQ_PRESET, what="(j1)")
    counts += collections.Counter(ops.launch_counts())
    out["counts"] = dict(counts)
    if out["g"]["coords"] == {"data": 0, "model": 0}:
        cfg = layout_cfg()
        out["g"]["kernels"] = local_head_kernels(
            device, cfg.n_heads // LAYOUT_SHAPE["model"],
            cfg.n_kv_heads // LAYOUT_SHAPE["model"], RANKS_SEQ)
        cfg = family_cfg("h3")
        out["h3"]["kernels"] = local_head_kernels(
            device, cfg.n_heads // LAYOUT_SHAPE["model"],
            cfg.n_kv_heads // LAYOUT_SHAPE["model"], RANKS_SEQ)
        out["h1"]["ssd"] = local_ssd_kernel(
            device, family_cfg("h1"), LAYOUT_SHAPE["model"], RANKS_SEQ)
        cfg = layout_cfg()
        out["i1"]["kernels"] = local_head_kernels(
            device, cfg.n_heads // LAYOUT_SHAPE["model"],
            cfg.n_kv_heads // LAYOUT_SHAPE["model"], RANKS_SEQ)
        out["i1"]["norms"] = local_norm_kernels(
            device, RANKS_SEQ // LAYOUT_SHAPE["model"], cfg.d_model)
        cfg = family_cfg("h1")
        out["j1"]["ssd"] = local_ssd_kernel(
            device, cfg, 1, RANKS_SEQ // LAYOUT_SHAPE["model"])
        out["j1"]["handoff"] = handoff_check(
            device, cfg, LAYOUT_SHAPE["model"], RANKS_SEQ)
        out["j1"]["norms"] = local_norm_kernels(
            device, RANKS_SEQ // LAYOUT_SHAPE["model"], cfg.d_model)
    return out


def ep_train_compare(results, unsplit) -> dict:
    """(e)'s bars (see the module's docstring)."""
    tol = TOL[torch.bfloat16]
    cfg = ep_train_cfg()
    want = train_launches(cfg, 1, 0)
    errs, later = {}, []
    for r, got in enumerate(x["e"] for x in results):
        check(got["experts_here"] * EP_MODEL == moe._padded_experts(cfg),
              f"(e) rank {r} holds {got['experts_here']} experts")
        for i, made in enumerate(got["launches_per_step"]):
            check(made == want, f"(e) rank {r} step {i}: launches {made}, "
                  f"want {want}")
        for i, (a, b) in enumerate(zip(got["losses"], unsplit["losses"])):
            check(abs(a - b) <= tol + tol * abs(b), f"(e) rank {r} loss "
                  f"{i}: {a} against unsplit {b}")
        calls = len(unsplit["routes"])
        check(len(got["routes"]) == calls == cfg.n_layers * EP_TRAIN_STEPS,
              f"(e) rank {r}: {len(got['routes'])} router calls")
        first = cfg.n_layers              # the first step's calls
        check(all(torch.equal(a, b) for a, b in
                  zip(got["routes"][:first], unsplit["routes"][:first]))
              and got["drops"][:first] == unsplit["drops"][:first],
              f"(e) rank {r}: the first step's routes or drops differ")
        for i in range(first, calls):
            # a token's top-k can change only if two of its experts swap,
            # whose unsplit gap is at most twice the largest difference
            # of the two runs' probabilities at that token
            moved = (got["routes"][i] != unsplit["routes"][i]).any(-1)
            shift = (got["probs"][i] - unsplit["probs"][i]).abs().amax(-1)
            gap = unsplit["token_gaps"][i]
            check(bool((gap[moved] <= 2 * shift[moved]).all()),
                  f"(e) rank {r} call {i}: a route moved at an unsplit gap "
                  "wider than the probabilities moved")
            if r == 0:
                later.append({"tokens_moved": int(moved.sum()),
                              "max_prob_shift": float(shift.max()),
                              "max_gap_moved": float(gap[moved].max())
                              if moved.any() else None,
                              "dropped": got["drops"][i],
                              "dropped_unsplit": unsplit["drops"][i]})
        for key, sample in got["samples"].items():
            errs[key] = within(sample, unsplit["samples"][key],
                               torch.bfloat16, what=f"(e) rank {r} {key}")
    check(results[0]["e"]["non_expert"] == results[1]["e"]["non_expert"],
          "(e) the non-expert state differs between the ranks")
    return {"losses_split": [x["e"]["losses"] for x in results],
            "losses_unsplit": unsplit["losses"],
            "step_wall_s_split": [x["e"]["step_wall_s"] for x in results],
            "step_wall_s_unsplit": unsplit["step_wall_s"],
            "params_max_err": max(errs.values()),
            "leaves_sampled": len(errs), "sample": SAMPLE,
            "routes_dropped": sum(unsplit["drops"]),
            "router_calls": len(unsplit["routes"]),
            "first_step_routes_equal": True, "later_calls": later,
            "launches_per_step": want,
            "peak_bytes_split": [x["e"]["peak_bytes"] for x in results],
            "peak_bytes_unsplit": unsplit["peak_bytes"], "tol": tol}


def pod_compare(results, folded) -> dict:
    """(f)'s bars (see the module's docstring)."""
    cfg = pod_cfg()
    plan, _ = train_plan(cfg, workers=POD_SHAPE["data"])
    check(sorted(r["index"] for r in results) == list(range(POD_BATCH)),
          "(f) the ranks' indices over (pod, data) are not 0..3")
    lead = next(r for r in results if r["index"] == 0)
    out = {"buckets": plan.n_buckets}
    for mode in POD_MODES:
        per_rank = [r[mode] for r in results]
        want = train_launches(cfg, 1, plan.n_buckets if
                              mode == "spindle_compressed" else 0)
        for r, got in enumerate(per_rank):
            for i, made in enumerate(got["launches_per_step"]):
                check(made == want, f"(f) {mode} rank {r} step {i}: "
                      f"launches {made}, want {want}")
        check(all(p[k] == per_rank[0][k] for p in per_rank
                  for k in ("params", "opt", "losses")),
              f"(f) {mode}: the ranks' states diverged")
        got = lead[mode]
        out[mode] = {"losses": got["losses"],
                     "step_wall_s_ranks": [p["step_wall_s"]
                                           for p in per_rank],
                     "reduce_s_ranks": [p["reduce_s"] for p in per_rank],
                     "reduce_share_ranks": [p["reduce_share"]
                                            for p in per_rank],
                     "launches_per_step": want}
        if mode in folded:
            w = folded[mode]
            rel = [relative(a, b) for a, b in zip(got["losses"],
                                                  w["losses"])]
            check(max(rel) <= POD_LOSS_RTOL, f"(f) {mode}: losses "
                  f"{got['losses']} against folded {w['losses']}")
            # an element whose summed gradient changes sign with the
            # order of the sum moves by at most 2 lr a step
            flip = 2.02 * sum(w["lrs"])
            diffs = [(got["master"][k] - w["master"][k]).abs()
                     for k in w["master"]]
            worst = max(float(d.max()) for d in diffs)
            over = sum(int((d > POD_LOSS_RTOL * w["master"][k].abs()).sum())
                       for d, k in zip(diffs, w["master"]))
            check(worst <= flip, f"(f) {mode}: master differs from the "
                  f"folded step by {worst} > {flip}")
            out[mode].update(losses_folded=w["losses"], loss_rel_err=rel,
                             master_max_abs_err=worst,
                             master_sign_flip_bound=flip,
                             master_elements_over_loss_rtol=over,
                             master_elements_sampled=sum(
                                 d.numel() for d in diffs),
                             step_wall_s_folded=w["step_wall_s"],
                             reduce_s_folded=w["reduce_s"])
    ref = folded["compressed"]
    check(ref["buckets"] == plan.n_buckets, "(f) bucket plans differ")
    errs = []
    got = lead["spindle_compressed"]["first_mean"]
    for k, want in ref["mean"].items():
        # one quantization step, and the rounding of the bf16 leaf
        step = ref["step"][k]
        err = float((got[k].float() - want.float()).abs().max())
        bar = 1.01 * step + 2 ** -7 * float(want.float().abs().max())
        check(err <= bar, f"(f) compressed {k}: {err} beyond one "
              f"quantization step {step}")
        errs.append(err / step if step else 0.0)
    out["spindle_compressed"].update(
        first_mean_max_err_in_steps=max(errs),
        quantize_per_step=[p["spindle_compressed"]["launches_per_step"][-1]
                           .get("quantize", 0) for p in results])
    check(all(r["gspmd"]["params"] == r["spindle_per_tensor"]["params"]
              for r in results),
          "(f) gspmd is not the per-tensor mean's numbers")
    return out


def ranks_folded() -> tuple:
    """Phase 38's comparisons: the kernels built in this process, then
    :func:`ranks_folded_child` in a one-rank spawn on FOLDED_DEVICES.
    Returns (its results, its seconds, this process's allocated and
    reserved bytes before it)."""
    build_kernels()
    torch.cuda.empty_cache()
    parent_bytes = [torch.cuda.memory_allocated(),
                    torch.cuda.memory_reserved()]
    (folded_out,), folded_s = timed(lambda: ranks.spawn(
        ranks_folded_child, list(FOLDED_DEVICES), timeout=RANKS_TIMEOUT))
    check(folded_out["backend"] == ranks.backend_for(FOLDED_DEVICES),
          f"the rank on {FOLDED_DEVICES} ran over {folded_out['backend']}")
    return folded_out, folded_s, parent_bytes


def check_placed(results, devices, what: str) -> str:
    """Every rank of a spawn on ``devices`` ran on its own device over
    :func:`ranks.backend_for` of them; returns that backend."""
    want = ranks.backend_for(devices)
    got = [(r["device"], r["backend"]) for r in results]
    check(got == [(str(torch.device(d)), want) for d in devices],
          f"{what}: the ranks on {list(devices)} ran on {got}, want each "
          f"on its device over {want}")
    return want


def ranks_leg(folded, two, four, smi_line: str, phase: int = 38) -> tuple:
    """Phase 38's rank parts: (a), (b), (c), (e), (g2), (h2), (h4), (i2)
    and (j2) in a spawn of one rank on each of ``two``, then (f), (g1),
    (h1), (h3), (i1) and (j1) in one on each of ``four``, every part held
    to the comparisons of ``folded`` (:func:`ranks_folded`) with phase
    38's bars.  The backend is the devices' (:func:`ranks.backend_for`):
    ``gloo`` for ranks that share a card, ``nccl`` for one a card; each
    line carries ``phase`` and the backend.  A rank that fails, or is not
    done in time, fails the run.  Returns (the ranks path's launches:
    every part's, (i) and (j) included; :func:`leg_summary`)."""
    folded_out, folded_s, parent_bytes = folded
    t0 = time.perf_counter()
    results, ranks_s = timed(lambda: ranks.spawn(
        ranks_child, list(two), timeout=RANKS_TIMEOUT))
    pod, pod_s = timed(lambda: ranks.spawn(
        pod_child, list(four), timeout=RANKS_TIMEOUT))
    backend = check_placed(results, two, "two ranks")
    check(check_placed(pod, four, "four ranks") == backend,
          "the two legs' backends differ")
    folded = folded_out["folded"]
    cfg = ranks_cfg()
    plan, _ = train_plan(cfg, workers=2)
    want = train_launches(cfg, 1, 0)
    a = {}
    for mode in RANKS_MODES:
        per_rank = [r["a"][mode] for r in results]
        w = folded[mode]
        for r, got in enumerate(per_rank):
            bucket_launches = plan.n_buckets \
                if mode == "spindle_compressed" else 0
            step_want = dict(want, **({"quantize": bucket_launches,
                                       "dequantize": bucket_launches}
                                      if bucket_launches else {}))
            for i, made in enumerate(got["launches_per_step"]):
                check(made == step_want, f"(a) {mode} rank {r} step {i}: "
                      f"launches {made}, want {step_want}")
        same_ranks = all(p["params"] == per_rank[0]["params"]
                         and p["opt"] == per_rank[0]["opt"]
                         and p["losses"] == per_rank[0]["losses"]
                         for p in per_rank)
        check(same_ranks, f"(a) {mode}: the ranks' states diverged")
        got = per_rank[0]
        equal = {"losses": got["losses"] == w["losses"],
                 "params": got["params"] == w["params"],
                 "opt": got["opt"] == w["opt"]}
        a[mode] = {
            "bit_equal_to_folded": equal,
            "leaves_differing": sum(x != y for x, y in
                                    zip(got["params"], w["params"])),
            "losses_ranks": got["losses"], "losses_folded": w["losses"],
            "step_wall_s_ranks": [p["step_wall_s"] for p in per_rank],
            "step_wall_s_folded": w["step_wall_s"],
            "tokens_per_s_ranks": RANKS_BATCH * RANKS_SEQ /
            max(p["step_wall_s"][-1] for p in per_rank),
            "tokens_per_s_folded": RANKS_BATCH * RANKS_SEQ /
            w["step_wall_s"][-1],
            "reduce_s_ranks": [p["reduce_s"] for p in per_rank],
            "reduce_share_ranks": [p["reduce_share"] for p in per_rank],
            "reduce_s_folded": w["reduce_s"],
            "reduce_share_folded": w["reduce_share"],
            "quantize_per_step_rank": [
                p["launches_per_step"][-1].get("quantize", 0)
                for p in per_rank],
            "dequantize_per_step_rank": [
                p["launches_per_step"][-1].get("dequantize", 0)
                for p in per_rank]}
        check(all(equal.values()), f"(a) {mode}: two ranks are not the "
              f"folded W = 2 step bit for bit: {equal}, "
              f"{a[mode]['leaves_differing']} parameter leaves differ, "
              f"losses {got['losses']} against {w['losses']}")
    emit({"phase": phase, "backend": backend,
          "part": "a", "model": RANKS_MODEL,
          "layers": cfg.n_layers, "of_layers":
          registry.get(RANKS_MODEL).cfg.n_layers, "params":
          cfg.param_count(), "global_batch": [RANKS_BATCH, RANKS_SEQ],
          "ranks": len(results), "devices": [str(d) for d in two],
          "steps": RANKS_STEPS,
          "modes": a,
          "buckets": plan.n_buckets,
          "peak_bytes_ranks": [r["a_peak_bytes"] for r in results],
          "peak_reserved_bytes_ranks": [r["a_peak_reserved_bytes"]
                                        for r in results],
          "peak_bytes_folded": folded_out["peak_bytes"],
          "parent_allocated_reserved_bytes": parent_bytes,
          "folded_child_s": folded_s, "ranks_child_s": ranks_s,
          "nvidia_smi": smi_line})
    b = results[0]["b"]
    emit({"phase": phase, "backend": backend,
          "part": "b", "model": MOE_SERVED,
          "layers": EP_LAYERS, "experts_a_rank":
          [r["b"]["experts_here"] for r in results],
          "loss_tokens": EP_SEQ, "prefill": EP_PREFILL,
          "decode_steps": EP_DECODE,
          "peak_bytes_ranks": [r["b"]["peak_bytes"] for r in results],
          "wall_s_ranks": [r["b"]["wall_s"] for r in results], **b})
    check(all(r["c"] for r in results), "(c) push_rows")
    emit({"phase": phase, "backend": backend,
          "part": "c", "columns": SST_PUSH_COLUMNS,
          "exact": True})
    emit({"phase": phase, "backend": backend,
          "part": "e", "model": MOE_SERVED,
          "layers": EP_TRAIN_LAYERS, "mesh": {"data": 1, "model": EP_MODEL},
          "gradsync": "gspmd", "tokens": [1, EP_TRAIN_SEQ],
          "steps": EP_TRAIN_STEPS, "params_a_rank": sum(
              v.numel() for k, v in tree_util.paths({"p": moe.shard_experts(
                  layers.abstract_tree(registry.param_specs(ep_train_cfg())),
                  0, EP_MODEL)})),
          **ep_train_compare(results, folded_out["e"]),
          "nvidia_smi": smi_line})
    emit({"phase": phase, "backend": backend,
          "part": "f", "model": RANKS_MODEL,
          "layers": POD_LAYERS, "mesh": POD_SHAPE, "dp_axes": POD_AXES,
          "global_batch": [POD_BATCH, RANKS_SEQ], "steps": RANKS_STEPS,
          "modes": pod_compare(pod, folded_out["f"]),
          "peak_bytes_ranks": [r["peak_bytes"] for r in pod],
          "pod_child_s": pod_s, "nvidia_smi": smi_line})
    g1 = layout_compare(pod, folded_out["g"])
    g1_kernels = next(r["g"]["kernels"] for r in pod if "kernels" in r["g"])
    emit({"phase": phase, "backend": backend,
          "part": "g1", "model": RANKS_MODEL,
          "layers": POD_LAYERS, "mesh": LAYOUT_SHAPE,
          "rules": LAYOUT_PRESET, "gradsync": "gspmd",
          "global_batch": [LAYOUT_BATCH, RANKS_SEQ], "steps": RANKS_STEPS,
          "heads_a_rank": [layout_cfg().n_heads // LAYOUT_SHAPE["model"],
                           layout_cfg().n_kv_heads // LAYOUT_SHAPE["model"]],
          **g1, "kernels_at_local_heads": g1_kernels,
          "nvidia_smi": smi_line})
    g2 = results[0]["g"]
    ratio = [r["g"]["weight_bytes"] / g2["unsplit_weight_bytes"]
             for r in results]
    check(all(abs(x - 1 / TP_SERVE_SHAPE["model"]) < 0.01 for x in ratio),
          f"(g2) a rank's weight bytes are {ratio} of the unsplit's")
    emit({"phase": phase, "backend": backend,
          "part": "g2", "model": TP_SERVE_MODEL,
          "layers": TP_SERVE_LAYERS, "of_layers":
          registry.get(TP_SERVE_MODEL).cfg.n_layers,
          "mesh": TP_SERVE_SHAPE, "rules": TP_SERVE_PRESET,
          "prefill": TP_PREFILL, "decode_steps": TP_DECODE,
          "heads_a_rank": [r["g"]["heads_here"] for r in results],
          "weight_bytes_ranks": [r["g"]["weight_bytes"] for r in results],
          "weight_ratio_ranks": ratio,
          "peak_bytes_ranks": [r["g"]["peak_bytes"] for r in results],
          "wall_s_ranks": [r["g"]["wall_s"] for r in results],
          **{k: v for k, v in g2.items() if k not in (
              "heads_here", "weight_bytes", "peak_bytes", "wall_s")},
          "nvidia_smi": smi_line})
    for part in FAMILY_TRAINED:
        cfg, (_, _, shape, preset) = family_cfg(part), FAMILY_PARTS[part]
        h = layout_compare(pod, folded_out["h"][part], part, cfg, shape,
                           preset)
        extra = {k: v for r in pod for k, v in r[part].items()
                 if k in ("kernels", "ssd")}
        emit({"phase": phase, "backend": backend,
              "part": part, "model": FAMILY_PARTS[part][0],
              "layers": cfg.n_layers, "of_layers": registry.get(
                  FAMILY_PARTS[part][0]).cfg.n_layers, "mesh": shape,
              "rules": preset, "gradsync": "gspmd",
              "global_batch": [LAYOUT_BATCH, RANKS_SEQ],
              "steps": RANKS_STEPS, **h, **extra, "nvidia_smi": smi_line})
    for part in FAMILY_SERVED:
        cfg, (_, _, shape, preset) = family_cfg(part), FAMILY_PARTS[part]
        h = results[0][part]
        ratio = [r[part]["weight_bytes"] / h["unsplit_weight_bytes"]
                 for r in results]
        table = rules_lib.get(preset, cfg)
        laid = sum(layers.shard_bytes(sp, table, types.SimpleNamespace(
            shape=shape), sp.dtype_for(torch.bfloat16))
            for sp in layers.spec_leaves(registry.param_specs(cfg)))
        check(all(r[part]["weight_bytes"] == laid for r in results),
              f"({part}) a rank's weight bytes "
              f"{[r[part]['weight_bytes'] for r in results]}, its layout's "
              f"{laid}")
        emit({"phase": phase, "backend": backend,
              "part": part, "model": FAMILY_PARTS[part][0],
              "layers": cfg.n_layers, "of_layers": registry.get(
                  FAMILY_PARTS[part][0]).cfg.n_layers, "mesh": shape,
              "rules": preset, "loss_tokens": RANKS_SEQ,
              "prefill": TP_PREFILL, "decode_steps": TP_DECODE,
              "heads_a_rank": [r[part]["heads_here"] for r in results],
              "weight_bytes_ranks": [r[part]["weight_bytes"]
                                     for r in results],
              "weight_ratio_ranks": ratio,
              "peak_bytes_ranks": [r[part]["peak_bytes"] for r in results],
              "wall_s_ranks": [r[part]["wall_s"] for r in results],
              "losses_ranks": [r[part]["loss"] for r in results],
              **{k: v for k, v in h.items() if k not in (
                  "heads_here", "weight_bytes", "peak_bytes", "wall_s",
                  "loss")}, "nvidia_smi": smi_line})
    i1 = layout_compare(pod, folded_out["g"], "i1", layout_cfg(),
                        LAYOUT_SHAPE, SEQ_TRAIN_PRESET)
    check(all(r["i1"]["seq_split"] for r in pod),
          "(i1) the sequence did not split over the ranks")
    extra = {k: v for r in pod for k, v in r["i1"].items()
             if k in ("kernels", "norms")}
    emit({"phase": phase, "backend": backend,
          "part": "i1", "model": RANKS_MODEL,
          "layers": POD_LAYERS, "mesh": LAYOUT_SHAPE,
          "rules": SEQ_TRAIN_PRESET, "gradsync": "gspmd",
          "global_batch": [LAYOUT_BATCH, RANKS_SEQ], "steps": RANKS_STEPS,
          "positions_a_rank": RANKS_SEQ // LAYOUT_SHAPE["model"], **i1,
          "collectives_per_step": [r["i1"]["collectives_per_step"]
                                   for r in pod],
          "collectives_per_step_g1": [r["g"]["collectives_per_step"]
                                      for r in pod],
          "step_wall_s_g1": g1["step_wall_s_split"],
          "collective_s_g1": g1["collective_s_split"],
          "peak_bytes_g1": g1["peak_bytes_split"], **extra,
          "nvidia_smi": smi_line})
    i2 = results[0]["i2"]
    check(all(r["i2"]["seq_split"] == [True, True, False] for r in results),
          "(i2) the loss and the prefill must split the sequence, a decode "
          f"step not: {[r['i2']['seq_split'] for r in results]}")
    check(all(r["i2"]["weight_bytes"] == r["g"]["weight_bytes"]
              for r in results), "(i2) a rank's weights differ from (g2)'s")
    emit({"phase": phase, "backend": backend,
          "part": "i2", "model": TP_SERVE_MODEL,
          "layers": TP_SERVE_LAYERS, "mesh": TP_SERVE_SHAPE,
          "rules": SEQ_SERVE_PRESET, "loss_tokens": RANKS_SEQ,
          "prefill": TP_PREFILL, "decode_steps": TP_DECODE,
          "positions_a_rank": [RANKS_SEQ // TP_SERVE_SHAPE["model"],
                               TP_PREFILL // TP_SERVE_SHAPE["model"]],
          "heads_a_rank": [r["i2"]["heads_here"] for r in results],
          "weight_bytes_ranks": [r["i2"]["weight_bytes"] for r in results],
          "peak_bytes_ranks": [r["i2"]["peak_bytes"] for r in results],
          "peak_bytes_g2": [r["g"]["peak_bytes"] for r in results],
          "wall_s_ranks": [r["i2"]["wall_s"] for r in results],
          "wall_s_g2": [r["g"]["wall_s"] for r in results],
          "losses_ranks": [r["i2"]["loss"] for r in results],
          **{k: v for k, v in i2.items() if k not in (
              "heads_here", "weight_bytes", "peak_bytes", "wall_s", "loss",
              "seq_split")}, "nvidia_smi": smi_line})
    h1_unsplit = folded_out["h"]["h1"]
    cfg = family_cfg("h1")
    j1 = layout_compare(pod, dict(h1_unsplit, blocks=h1_unsplit[
        "blocks_under"][SSM_SEQ_PRESET]), "j1", cfg, LAYOUT_SHAPE,
        SSM_SEQ_PRESET)
    check(all(r["j1"]["seq_split"] and r["j1"]["seq_rows"] for r in pod),
          "(j1) the sequence did not split in ssm_seq's form")
    extra = {k: v for r in pod for k, v in r["j1"].items()
             if k in ("ssd", "handoff", "norms")}
    emit({"phase": phase, "backend": backend,
          "part": "j1", "model": FAMILY_PARTS["h1"][0],
          "layers": cfg.n_layers, "mesh": LAYOUT_SHAPE,
          "rules": SSM_SEQ_PRESET, "gradsync": "gspmd",
          "global_batch": [LAYOUT_BATCH, RANKS_SEQ], "steps": RANKS_STEPS,
          "positions_a_rank": RANKS_SEQ // LAYOUT_SHAPE["model"],
          "chunks_a_rank": RANKS_SEQ // LAYOUT_SHAPE["model"]
          // cfg.ssm.chunk, **j1,
          "collectives_per_step": [r["j1"]["collectives_per_step"]
                                   for r in pod],
          "collectives_per_step_h1": [r["h1"]["collectives_per_step"]
                                      for r in pod],
          "step_wall_s_h1": [r["h1"]["step_wall_s"] for r in pod],
          "collective_s_h1": [r["h1"]["collective_s"] for r in pod],
          "collective_share_h1": [[g / w for g, w in zip(
              r["h1"]["collective_s"], r["h1"]["step_wall_s"])]
              for r in pod],
          "peak_bytes_h1": [r["h1"]["peak_bytes"] for r in pod],
          "weight_bytes_h1": [r["h1"]["weight_bytes"] for r in pod],
          **extra, "nvidia_smi": smi_line})
    j2 = results[0]["j2"]
    cfg = family_cfg("h2")
    check(all(r["j2"]["seq_split"] == [True, True, False]
              and r["j2"]["seq_rows"] for r in results),
          "(j2) the loss and the prefill must split the sequence in "
          "ssm_seq's form, a decode step not: "
          f"{[(r['j2']['seq_split'], r['j2']['seq_rows']) for r in results]}")
    table = rules_lib.get(SSM_SEQ_PRESET, cfg)
    laid = sum(layers.shard_bytes(sp, table, types.SimpleNamespace(
        shape=TP_SERVE_SHAPE), sp.dtype_for(torch.bfloat16))
        for sp in layers.spec_leaves(registry.param_specs(cfg)))
    check(all(r["j2"]["weight_bytes"] == laid for r in results),
          f"(j2) a rank's weight bytes "
          f"{[r['j2']['weight_bytes'] for r in results]}, its layout's "
          f"{laid}")
    emit({"phase": phase, "backend": backend,
          "part": "j2", "model": FAMILY_PARTS["h2"][0],
          "layers": cfg.n_layers, "mesh": TP_SERVE_SHAPE,
          "rules": SSM_SEQ_PRESET, "loss_tokens": RANKS_SEQ,
          "prefill": TP_PREFILL, "decode_steps": TP_DECODE,
          "positions_a_rank": [RANKS_SEQ // TP_SERVE_SHAPE["model"],
                               TP_PREFILL // TP_SERVE_SHAPE["model"]],
          "heads_a_rank": [r["j2"]["heads_here"] for r in results],
          "weight_bytes_ranks": [r["j2"]["weight_bytes"] for r in results],
          "weight_ratio_ranks": [r["j2"]["weight_bytes"] /
                                 j2["unsplit_weight_bytes"]
                                 for r in results],
          "peak_bytes_ranks": [r["j2"]["peak_bytes"] for r in results],
          "peak_bytes_h2": [r["h2"]["peak_bytes"] for r in results],
          "wall_s_ranks": [r["j2"]["wall_s"] for r in results],
          "wall_s_h2": [r["h2"]["wall_s"] for r in results],
          "losses_ranks": [r["j2"]["loss"] for r in results],
          **{k: v for k, v in j2.items() if k not in (
              "heads_here", "weight_bytes", "peak_bytes", "wall_s", "loss",
              "seq_split", "seq_rows")}, "nvidia_smi": smi_line})
    counts = collections.Counter()
    for r in results + pod:
        counts.update(r["counts"])
    emit({"phase": phase, "backend": backend, "launches": dict(counts),
          "cuda_collectives": ["all_reduce", "reduce_scatter",
                               "all_gather"], "staged": [],
          "devices": [[str(d) for d in two], [str(d) for d in four]],
          "folded_child_s": folded_s, "ranks_child_s": ranks_s,
          "pod_child_s": pod_s, "wall_s": time.perf_counter() - t0})
    return dict(counts), leg_summary(results, pod)


# the parts of a leg whose walls and collectives a summary holds:
# part -> (the spawn: 2 or 4 ranks, the key of its record in a rank's
# results); (a) and (f) hold one record a mode
LEG_PARTS = {"a": (2, "a"), "b": (2, "b"), "e": (2, "e"), "g2": (2, "g"),
             "h2": (2, "h2"), "h4a": (2, "h4a"), "h4b": (2, "h4b"),
             "i2": (2, "i2"), "j2": (2, "j2"), "f": (4, None),
             "g1": (4, "g"), "h1": (4, "h1"), "h3": (4, "h3"),
             "i1": (4, "i1"), "j1": (4, "j1")}
CLOCK_KEYS = ("step_wall_s", "wall_s", "collective_s", "collective_calls",
              "collectives_per_step", "collectives", "reduce_s",
              "peak_bytes")


def leg_summary(results, pod) -> dict:
    """part -> per rank: its walls (a step, or the served path's), the
    seconds in the collectives, the collectives by kind and operand
    bytes (a step, or the path's) and the peak bytes; (a) and (f) per
    mode, their peaks the spawn's."""
    out = {}
    for part, (n, key) in LEG_PARTS.items():
        spawn = results if n == 2 else pod
        if part in ("a", "f"):
            modes = RANKS_MODES if part == "a" else POD_MODES
            recs = [r["a"] if part == "a" else r for r in spawn]
            out[part] = {
                "modes": {m: [{k: v for k, v in rec[m].items()
                               if k in CLOCK_KEYS} for rec in recs]
                          for m in modes},
                "peak_bytes": [r["a_peak_bytes" if part == "a"
                                 else "peak_bytes"] for r in spawn]}
        else:
            out[part] = [{k: v for k, v in r[key].items() if k in CLOCK_KEYS}
                         for r in spawn]
    return out


def phase38_ranks(smi_line: str) -> dict:
    """Phase 38: the port across real ``torch.distributed`` ranks that
    share ``cuda:0``.  The kernels are built in this process first; each
    rank is a process of :func:`repro_torch.core.ranks.spawn` that loads
    them: the folded comparisons and (d) in a one-rank spawn over
    ``nccl`` (:func:`ranks_folded`), then every rank part over ``gloo``
    (:func:`ranks_leg`; NCCL refuses two ranks on one card).  Returns
    the ranks path's launches."""
    folded = ranks_folded()
    emit_world1(folded[0])
    counts, _ = ranks_leg(folded, RANKS_DEVICES, POD_DEVICES, smi_line)
    return counts


def emit_world1(folded_out: dict) -> None:
    """(d)'s line: the one-rank process's ``nccl`` step and reductions
    against the folded W = 1 ones."""
    emit({"phase": 38, "part": "d", "backend": folded_out["backend"],
          "world_size": 1, "bit_equal_to_folded_w1":
          folded_out["nccl_world1"]})


def ranks_phase() -> int:
    """Phase 38 alone (``chip_smoke.py --ranks-phase``), after the
    build."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi_line = phase0_identity()
    counts = phase38_ranks(smi_line)
    check_ranks_path(counts)
    emit({"ranks": counts})
    return 0


def check_ranks_path(counts: dict) -> None:
    check(all(counts.get(k, 0) > 0 for k in (
        "flash_attention", "flash_decode", "rms_norm", "rms_norm_residual",
        "ssd_scan", "quantize", "dequantize")),
        f"the ranks path skipped a kernel: {counts}")


# ---------------------------------------------------------------------------
# phase 39: the ranks one a card over NCCL, the grid across the cards
# ---------------------------------------------------------------------------

CARDS_PHASE_FLAG = "--cards-phase"
CARDS = 4
NCCL_LOG_DIR = ROOT / "build" / "nccl"
# (k): four of phase 3's Fig. 6 windows, and phase 3's Fig. 11 grid; each
# on the devices listed (None: run_batch's default, every card present)
CARDS_GRIDS = (("fig6_windows", 800, {"windows": [5, 20, 100, 500]},
                (4, 2, None)),
               ("fig11_null_send", 1200, {"null_send": [True, False]},
                (2, None)))


def cards_devices() -> tuple:
    """Phase 39's ranks, one a card (:func:`ranks.cards`): the two ranks
    on cuda:0-1 and the four on cuda:0-3.  Fails, naming the count, on
    fewer than CARDS cards."""
    have = torch.cuda.device_count()
    check(have >= CARDS, f"the cards phase needs {CARDS} cards; {have} "
          f"present")
    return tuple(ranks.cards(2)), tuple(ranks.cards(CARDS))


def card_lines() -> dict:
    """Each card's ``nvidia-smi`` name and power limit, and ``nvidia-smi
    topo -m`` (the links between the cards), printed and returned."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    for i, line in enumerate(lines):
        print(f"cuda:{i} {line}", flush=True)
    print(topo.stdout if topo.returncode == 0 else
          f"nvidia-smi topo -m failed ({topo.returncode}): "
          f"{topo.stdout.strip()} {topo.stderr.strip()}", flush=True)
    return {"nvidia_smi": lines, "topo": (topo.stdout + topo.stderr).strip()
            .splitlines(), "topo_rc": topo.returncode}


@contextlib.contextmanager
def nccl_debug():
    """NCCL's ``INFO`` lines, one file a process under ``build/nccl``, for
    the spawns inside; on a failure inside they go to stderr before it
    is raised.  Yields a dict that on a clean exit holds the transports
    NCCL chose (its ``via`` lines)."""
    shutil.rmtree(NCCL_LOG_DIR, ignore_errors=True)
    NCCL_LOG_DIR.mkdir(parents=True)
    saved = {k: os.environ.get(k) for k in ("NCCL_DEBUG", "NCCL_DEBUG_FILE")}
    os.environ["NCCL_DEBUG"] = "INFO"
    os.environ["NCCL_DEBUG_FILE"] = str(NCCL_LOG_DIR / "%h.%p.log")
    found = {}
    try:
        yield found
        via = collections.Counter()
        for f in NCCL_LOG_DIR.glob("*.log"):
            via.update(m.group(1) for m in re.finditer(
                r" via (\S+)", f.read_text(errors="replace")))
        found.update(transports=dict(via), files=len(list(
            NCCL_LOG_DIR.glob("*.log"))))
    except BaseException:
        for f in sorted(NCCL_LOG_DIR.glob("*.log")):
            sys.stderr.write(f"--- NCCL_DEBUG=INFO {f.name}\n"
                             + f.read_text(errors="replace"))
        sys.stderr.flush()
        raise
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def warm(recs) -> dict:
    """A part's warm figures from its per-rank records: the slowest
    rank's last step (or its served path), the seconds in collectives
    there and their share."""
    def last(r, key):
        v = r.get("step_wall_s" if key == "wall" else "collective_s")
        v = r.get("wall_s") if v is None and key == "wall" else v
        return v[-1] if isinstance(v, list) else v
    slow = max(recs, key=lambda r: last(r, "wall"))
    wall, coll = last(slow, "wall"), last(slow, "coll")
    return {"wall_s": wall, "collective_s": coll,
            "collective_share": coll / wall}


def leg_compare(nccl: dict, gloo: dict, cards: dict) -> dict:
    """A line a part: the NCCL leg's walls, collectives and peaks beside
    the ``gloo`` leg's from this call, and the warm wall's ratio."""
    ratios = {}
    for part in LEG_PARTS:
        n, g = nccl[part], gloo[part]
        if part in ("a", "f"):
            w = {m: {"nccl": warm(n["modes"][m]), "gloo": warm(g["modes"][m])}
                 for m in n["modes"]}
            ratios[part] = {m: x["gloo"]["wall_s"] / x["nccl"]["wall_s"]
                            for m, x in w.items()}
        else:
            w = {"nccl": warm(n), "gloo": warm(g)}
            ratios[part] = w["gloo"]["wall_s"] / w["nccl"]["wall_s"]
        emit({"phase": 39, "part": part, "compare":
              "nccl (one rank a card) against gloo (ranks sharing cuda:0), "
              "this call", "warm": w, "gloo_over_nccl_warm_wall":
              ratios[part], "nccl": n, "gloo": g, **cards})
    return ratios


def other_card_kernels(cards, smi: dict) -> list:
    """(l): the nine kernels at the shapes of the ``kernels`` line, inputs
    on each card but the first while the first is current, each against
    its plain version on the same inputs: the SMC pair and the quantize
    pair exactly, the rest at the default run's bars; every output on
    its inputs' card."""
    home = torch.cuda.current_device()
    check(home == cards[0].index, f"cuda:{home} is current")
    gen = torch.Generator(device="cuda").manual_seed(39)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    _, shard = train_plan(registry.get("qwen3-1.7b").cfg)
    lens = np.random.default_rng(6).integers(1, 41, 8).tolist()
    rows = []
    for dev in cards[1:]:
        to = lambda *ts: [t.to(dev) for t in ts]
        pub, proc, valid = to(*lane_inputs(16 * 16, 100, seed=356))
        counters = ss.counters_from_counts(pub, 100).contiguous()
        bf = torch.bfloat16
        q, k, v = to(*(rnd(*sh).to(bf) for sh in (
            (8, 16, 128), (8, 2048, 8, 128), (8, 2048, 8, 128))))
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        aq, ak, av = to(*(rnd(*sh).to(bf) for sh in (
            (2, 2048, 16, 128), (2, 2048, 8, 128), (2, 2048, 8, 128))))
        nx, nw = to(rnd(128, 128).to(bf), (1 + 0.1 * rnd(128)).to(bf))
        rx, rr, rw = to(rnd(8, 2048).to(bf), rnd(8, 2048).to(bf),
                        (1 + 0.1 * rnd(2048)).to(bf))
        ssd = to(*ssd_inputs(1, 2048, 80, 64, 128, 1, bf, gen))
        x = to(1e-3 * rnd(TRAIN_WORKERS * shard))[0]
        qx, sx = qz.quantize_plain(x, shard)
        cases = (
            ("smc_sweep_watermark", None,
             lambda: ss.smc_sweep_watermark(pub, proc, window=100,
                                            valid=valid),
             lambda: ss.smc_sweep_watermark_plain(pub, proc, 100, valid)),
            ("smc_sweep", None, lambda: ss.smc_sweep(counters, proc),
             lambda: ss.smc_sweep_plain(counters, proc)),
            ("flash_decode", bf, lambda: fd.flash_decode(q, k, v, kv_len),
             lambda: fd.flash_decode_plain(q, k, v, kv_len)),
            ("rms_norm", bf, lambda: rn.rms_norm(nx, nw),
             lambda: rn.rms_norm_plain(nx, nw)),
            ("rms_norm_residual", bf,
             lambda: rn.rms_norm_residual(rx, rr, rw),
             lambda: rn.rms_norm_residual_plain(rx, rr, rw)),
            ("flash_attention", bf, lambda: fa.flash_attention(aq, ak, av),
             lambda: fa.flash_attention_plain(aq, ak, av, True)),
            ("ssd_scan", bf, lambda: sc.ssd_scan(*ssd, 256),
             lambda: sc.ssd_scan_plain(*ssd, 256)),
            ("quantize", None, lambda: qz.quantize(x, shard),
             lambda: (qx, sx)),
            ("dequantize", None, lambda: qz.dequantize(qx, sx, shard),
             lambda: qz.dequantize_plain(qx, sx, shard)))
        errs = {}
        for name, dtype, kernel, plain in cases:
            got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            check(all(t.device == dev for t in got),
                  f"(l) {name}'s output is not on {dev}")
            if dtype is None:
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"(l) {name} on {dev} is not its plain version bit "
                      "for bit")
                errs[name] = 0.0
            elif name == "ssd_scan":
                errs[name] = max(
                    within(got[0], want[0], dtype, SSD_Y_TOL[dtype],
                           f"(l) ssd_scan y on {dev}"),
                    within(got[1], want[1], torch.float32, SSD_STATE_TOL,
                           f"(l) ssd_scan state on {dev}"))
            else:
                errs[name] = max(within(a, b, dtype, what=f"(l) {name} on "
                                        f"{dev}") for a, b in zip(got, want))
        torch.cuda.synchronize(dev)
        check(torch.cuda.current_device() == home,
              f"the current card moved from cuda:{home}")
        rows.append({"device": str(dev), "current": f"cuda:{home}",
                     "max_abs_err": errs})
        emit({"phase": 39, "part": "l", **rows[-1],
              "nvidia_smi": smi["nvidia_smi"]})
        del pub, proc, valid, counters, q, k, v, aq, ak, av, ssd, x, qx, sx
        torch.cuda.empty_cache()
    return rows


def spans_union_ns(spans) -> int:
    busy, end = 0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            busy, end = busy + hi - lo, hi
        elif hi > end:
            busy, end = busy + hi - end, hi
    return busy


def per_card_trace(fn, cards) -> dict:
    """``fn()`` under the profiler: its wall and each card's busy time
    (the union of its device records), the time any card was busy, and
    the overlap (the cards' busy times summed less that union: time two
    or more cards ran at once)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for d in cards:
        torch.cuda.synchronize(d)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        for d in cards:
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
    spans = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            spans[e.device_index()].append((e.start_ns(), e.end_ns()))
    busy = {f"cuda:{d}": spans_union_ns(v) / 1e9
            for d, v in sorted(spans.items())}
    check(busy, "the profiler recorded no device time")
    anyone = spans_union_ns([x for v in spans.values() for x in v]) / 1e9
    return {"traced_wall_s": wall, "busy_s": busy, "any_card_busy_s": anyone,
            "overlap_s": sum(busy.values()) - anyone}


def cards_grids(cards, smi: dict) -> dict:
    """(k): each grid of CARDS_GRIDS through ``run_batch`` on card
    ``kernel``, unsharded (on ``cuda:0``), on ``[cuda:0] * k`` and over
    each count of cards listed, every point identical to the unsharded
    batch and to its own run; cold and warm walls, launches a chunk; the
    sharded runs traced last, each card's busy time."""
    rows, traced = {}, []
    for label, n_messages, grid, counts in CARDS_GRIDS:
        cfg = api.single_group(16, msg_size=10240, n_messages=n_messages)
        (key, values), = grid.items()
        solos = []
        for value in values:
            over = ({"subgroups": tuple(dataclasses.replace(
                s, window=value) for s in cfg.subgroups)}
                if key == "windows" else {"flags": dataclasses.replace(
                    cfg.flags, null_send=value)})
            solo = api.Group(dataclasses.replace(cfg, **over), device="cuda")
            solos.append((solo.run(backend=SyncCheckedKernelBackend("cuda")),
                          solo.delivery_logs))
        runs = [("unsharded", [cards[0]]),
                ("cuda:0 x k", [cards[0]] * len(values))] + [
            (f"{n} cards" if n else "default (every card)",
             list(cards[:n]) if n else None) for n in counts]
        out = {}
        whole = None
        for name, devices in runs:
            batch = functools.partial(
                api.Group(cfg, device="cuda").run_batch,
                backend=SyncCheckedKernelBackend("cuda"), devices=devices,
                **grid)
            _, cold = timed(batch)
            before = ss.WATERMARK_LAUNCHES
            reports, wall = timed(batch)
            launches = ss.WATERMARK_LAUNCHES - before
            shards = placement.shard_count(
                len(values), placement.default_devices(cards[0])
                if devices is None else devices)
            t_max = max(r.rounds for r in reports)
            check(launches == shards * t_max, f"(k) {label} {name}: "
                  f"{launches} launches, want {shards} x {t_max}")
            whole = whole or reports
            for value, rs, rb, (solo, logs) in zip(values, reports, whole,
                                                   solos):
                what = f"(k) {label} {name} point {value}"
                same_logs(rs.extras["delivery_logs"],
                          rb.extras["delivery_logs"], what + " (unsharded)")
                same_report(rs, rb, what + " (unsharded)")
                same_logs(rs.extras["delivery_logs"], logs, what + " (solo)")
                same_report(rs, solo, what + " (solo)")
            out[name] = {"devices": None if devices is None
                         else [str(d) for d in devices], "shards": shards,
                         "rounds": t_max, "launches": launches,
                         "launches_a_chunk": launches / shards,
                         "cold_wall_s": cold, "warm_wall_s": wall}
            if shards > 1 and devices is not None and \
                    len(set(devices)) > 1:
                traced.append((label, name, batch))
        rows[label] = {"points": len(values), key: values,
                       "identical_to_unsharded_and_solo": True, **out}
    for label, name, batch in traced:
        rows[label][name]["trace"] = per_card_trace(batch, cards)
    emit({"phase": 39, "part": "k", **rows,
          "nvidia_smi": smi["nvidia_smi"]})
    return rows


def cards_phase() -> int:
    """Phase 39 alone (``chip_smoke.py --cards-phase``, on a host of
    CARDS cards): the build, phase 38 as the default run has it (the
    one-rank folded run, then the ranks sharing ``cuda:0`` over
    ``gloo``), then the same parts one rank a card over ``nccl`` held to
    the same folded results with the same bars, each part's walls and
    collectives beside the ``gloo`` leg's; (l) the nine kernels on the
    other cards while ``cuda:0`` is current; (k) phase 3's grids over the
    cards.  Exits 1, naming the count, on fewer than CARDS cards."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    two, four = cards_devices()
    t0 = time.perf_counter()
    smi_line = phase0_identity()
    cards = card_lines()
    folded = ranks_folded()
    emit_world1(folded[0])
    gloo_counts, gloo = ranks_leg(folded, RANKS_DEVICES, POD_DEVICES,
                                  smi_line)
    check_ranks_path(gloo_counts)
    with nccl_debug() as nccl_log:
        nccl_counts, nccl = ranks_leg(folded, two, four, smi_line, phase=39)
    check_ranks_path(nccl_counts)
    check(nccl_counts == gloo_counts, f"the legs' launches differ: nccl "
          f"{nccl_counts}, gloo {gloo_counts}")
    ratios = leg_compare(nccl, gloo, cards)
    kernels = other_card_kernels(four, cards)
    grids = cards_grids(four, cards)
    emit({"phase": 39, "cards": cards, "nccl": nccl_log,
          "launches": {"gloo": gloo_counts, "nccl": nccl_counts},
          "gloo_over_nccl_warm_wall": ratios,
          "kernels_checked_on": [r["device"] for r in kernels],
          "grid_walls": {label: {name: r["warm_wall_s"]
                                 for name, r in row.items()
                                 if isinstance(r, dict)}
                         for label, row in grids.items()},
          "wall_s": time.perf_counter() - t0})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


KERNELS = (
    ("smc_sweep_watermark", "cuda", "src/repro_torch/kernels/csrc/smc_sweep.cu",
     "src/repro/kernels/smc_sweep.py:153 smc_sweep_watermark_pallas"),
    ("smc_sweep", "cuda", "src/repro_torch/kernels/csrc/smc_sweep.cu",
     "src/repro/kernels/smc_sweep.py:127 smc_sweep_pallas"),
    ("flash_decode", "cuda", "src/repro_torch/kernels/csrc/flash_decode.cu",
     "src/repro/kernels/flash_decode.py:59 flash_decode_flat"),
    ("rms_norm", "cuda", "src/repro_torch/kernels/csrc/rmsnorm.cu",
     "src/repro/kernels/rmsnorm.py:34 rms_norm_pallas"),
    ("rms_norm_residual", "cuda", "src/repro_torch/kernels/csrc/rmsnorm.cu",
     "src/repro/kernels/rmsnorm.py:52 rms_norm_residual_pallas"),
    ("flash_attention", "cuda",
     "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:69 flash_attention_flat"),
    ("ssd_scan", "cuda", "src/repro_torch/kernels/csrc/ssd_scan.cu",
     "src/repro/kernels/ssd_scan.py:75 ssd_scan_pallas"),
    ("quantize", "cuda", "src/repro_torch/kernels/csrc/quantize.cu",
     "src/repro/kernels/quantize.py:32 quantize_pallas"),
    ("dequantize", "cuda", "src/repro_torch/kernels/csrc/quantize.cu",
     "src/repro/kernels/quantize.py:49 dequantize_pallas"),
)
# the shape and dtype each kernel's line reports: what its main path gives
# it (bf16 for the model kernels; the quantize kernels take the float32
# shard of the train path's largest bucket, phase 11)
LINE_SHAPES = {
    "flash_decode": ("B=8 Hq=16 Hkv=8 D=128 S_max=2048 lengths=serve",
                     torch.bfloat16),
    "rms_norm": ("128x128", torch.bfloat16),    # the per-head q/k norms
    "rms_norm_residual": ("8x2048", torch.bfloat16),  # hidden-state norms
    "flash_attention": ("B=2 S=2048 Hq=16 Hkv=8 D=128 causal=True",
                        torch.bfloat16),
    "ssd_scan": ("B=1 S=2048 H=80 P=64 N=128 G=1 chunk=256", torch.bfloat16),
}
PATHS = ("multicast", "serve", "forward", "train", "cut", "fused", "load",
         "recurrent", "families", "families_train", "launch", "ranks")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    if FUSED_PHASES_FLAG in sys.argv[1:]:
        return fused_phases()
    if RECURRENT_PHASES_FLAG in sys.argv[1:]:
        return recurrent_phases()
    if MOE_SEED_SEARCH_FLAG in sys.argv[1:]:
        rest = sys.argv[sys.argv.index(MOE_SEED_SEARCH_FLAG) + 1:]
        return moe_seed_search(int(rest[0]) if rest else 31)
    if FAMILIES_PHASES_FLAG in sys.argv[1:]:
        return families_phases()
    if FAMILIES_TRAIN_PHASES_FLAG in sys.argv[1:]:
        return families_train_phases()
    if DES_PHASE_FLAG in sys.argv[1:]:
        return des_phase()
    if LAUNCH_PHASE_FLAG in sys.argv[1:]:
        return launch_phase()
    if RANKS_PHASE_FLAG in sys.argv[1:]:
        return ranks_phase()
    if CARDS_PHASE_FLAG in sys.argv[1:]:
        return cards_phase()
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi_line = phase0_identity()
    shapes = (("group16", 16 * 16, 100), ("fig6_grid", 5 * 16 * 16, 1000),
              ("dds_stack", dds_lanes(), 100), ("large", 1 << 20, 100),
              ("extremes", 4099, 1000))
    rows = phase1_kernels(shapes)

    ops.reset_launch_counts()                 # the multicast path starts here
    testbed = phase2_testbed()
    grids_run = phase3_grids()
    phase4_dds()
    multicast = ops.launch_counts()           # ... and ends here
    check(multicast["smc_sweep_watermark"] > 0,
          "the multicast path never launched the watermark kernel")

    serve_rows = phase5_kernels()
    serve = phase6_serve()                    # counts of the serve path
    check(all(serve[k] > 0 for k in ("flash_decode", "rms_norm",
                                     "rms_norm_residual")),
          f"the serve path skipped a kernel: {serve}")
    phase7_kernels_vs_plain()

    model_rows = serve_rows + phase8_forward_kernels()
    forward = phase9_forward()                # counts of the forward path
    check(all(forward[k] > 0 for k in ("flash_attention", "ssd_scan",
                                       "rms_norm", "rms_norm_residual")),
          f"the forward path skipped a kernel: {forward}")
    phase10_forward_vs_plain()

    model_rows += phase11_quantize()
    train = phase12_train()                   # counts of the train path
    check(all(train[k] > 0 for k in ("flash_attention", "rms_norm",
                                     "rms_norm_residual", "quantize",
                                     "dequantize")),
          f"the train path skipped a kernel: {train}")
    phase13_train_vs_plain()

    # the cut path: each part counted from zero just before it and read
    # just after; the float32 comparison against the plain versions sits
    # outside the counts
    cut, returned = {}, {}
    for part in (phase14_multicast_cut, phase15_serve_cut,
                 phase16_gradsync_cut, phase17_chaos):
        ops.reset_launch_counts()
        returned[part] = part()
        for k, v in ops.launch_counts().items():
            cut[k] = cut.get(k, 0) + v
        if part is phase15_serve_cut:
            phase15_f32_vs_plain()
    check(all(cut[k] > 0 for k in ("smc_sweep_watermark", "flash_decode",
                                   "rms_norm", "rms_norm_residual")),
          f"the cut path skipped a kernel: {cut}")

    # the discrete-event simulator: host code, held to the card runs of
    # phases 2, 14 and 17 (it launches nothing: no path of the kernels
    # line counts it)
    phase36_des(testbed, returned[phase14_multicast_cut],
                returned[phase17_chaos])

    # the fused serve program and the load plane replay captured graphs:
    # their launches are the kernels of the profiler's device trace over
    # warm runs (a wrapper's count sees only the capture), taken in a
    # process of their own after every timed replay
    fused, load = run_fused_phases()
    for name, counts in (("fused", fused), ("load", load)):
        check(all(counts[k] > 0 for k, _ in DEVICE_KERNELS),
              f"the {name} path skipped a kernel: {counts}")

    # the recurrent families (zamba2's forward, mamba2 and zamba2 served
    # per round and fused), in a process of their own: their launches
    # are the wrappers' counts over zamba2's forward and the per-round
    # serve runs
    recurrent = run_child(RECURRENT_PHASES_FLAG, 900)["recurrent"]
    check(all(recurrent.get(k, 0) > 0 for k in (
        "flash_decode", "flash_attention", "ssd_scan", "rms_norm",
        "rms_norm_residual", "smc_sweep_watermark")),
        f"the recurrent path skipped a kernel: {recurrent}")

    # the moe, vlm and encdec families (each model's forward, prefill and
    # decode, the per-round serve runs), in a process of their own
    families = run_child(FAMILIES_PHASES_FLAG, 900)["families"]
    check(all(families.get(k, 0) > 0 for k in (
        "flash_decode", "flash_attention", "rms_norm", "rms_norm_residual",
        "smc_sweep_watermark")),
        f"the families path skipped a kernel: {families}")

    # training the hybrid, moe, vlm and encdec families (3 steps of each
    # at full width), in a process of their own
    families_train = run_child(FAMILIES_TRAIN_PHASES_FLAG, 900)[
        "families_train"]
    check(all(families_train.get(k, 0) > 0 for k in (
        "flash_attention_causal", "flash_attention_non_causal", "ssd_scan",
        "rms_norm", "rms_norm_residual", "quantize", "dequantize")),
        f"the families_train path skipped a kernel: {families_train}")

    # the launch plane: the launchers as a user starts them, the dry-run
    # and the roofline report, phase 3's grids sharded over named devices
    launch = phase37_launch(grids_run, smi_line)
    check(all(launch.get(k, 0) > 0 for k in (
        "smc_sweep_watermark", "flash_decode", "flash_attention",
        "rms_norm", "rms_norm_residual")),
        f"the launch path skipped a kernel: {launch}")

    # across real torch.distributed ranks: the data-parallel train step,
    # expert parallelism and the SST push, each rank a process of its own
    ranks_counts = phase38_ranks(smi_line)
    check_ranks_path(ranks_counts)
    emit({"phase": 39, "run": False, "cards": torch.cuda.device_count(),
          "why": f"the ranks one a card over nccl and the grid across "
          f"cards need {CARDS} cards: python3 chip_smoke.py "
          f"{CARDS_PHASE_FLAG} runs them alone"})

    _, shard = train_plan(registry.get("qwen3-1.7b").cfg)
    line_shapes = dict(LINE_SHAPES, **{
        name: (f"n={TRAIN_WORKERS * shard} block={shard}", torch.float32)
        for name in ("quantize", "dequantize")})
    by_path = dict(zip(PATHS, (multicast, serve, forward, train, cut,
                               fused, load, recurrent, families,
                               families_train, launch, ranks_counts)))
    kernels = []
    for name, route, source, replaces in KERNELS:
        if name in line_shapes:
            label, dtype = line_shapes[name]
            r = next(x for x in model_rows if x["kernel"] == name
                     and x["shape"] == label and x["dtype"] == str(dtype))
            errs = [x["max_abs_err"] for x in model_rows
                    if x["kernel"] == name]
            shape = f"{r['shape']}, {str(dtype).split('.')[-1]}"
        else:
            r = next(x for x in rows
                     if x["kernel"] == name and x["shape"] == "group16")
            errs = [x["max_abs_err"] for x in rows
                    if x["kernel"].startswith(name)]
            shape = f"{r['lanes']} lanes, W={r['window']}"
            r = dict(r, exact=all(e == 0 for e in errs))
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": sum(c.get(name, 0) for c in by_path.values()),
            "launches_by_path": {k: c.get(name, 0)
                                 for k, c in by_path.items()},
            "on_main_path": any(c.get(name, 0) for c in by_path.values()),
            "max_abs_err": r["max_abs_err"], "max_abs_err_all_shapes":
            max(errs), "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            "shape": shape, **{k: r[k] for k in ("exact", "yardstick_ms")
                               if k in r}})
    emit({"kernels": kernels, "total_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
