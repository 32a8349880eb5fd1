#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them, and at the
first failing phase (no phase catches an exception):

  1. device  — card name and power limit (nvidia-smi), torch/CUDA versions;
  2. build   — every kernel of ``src/repro_torch/kernels/csrc`` built with
     nvcc into ``build/kernels/``; for each device kernel of K4, K4b,
     K5 and K5b its registers, shared memory and spills (the ptxas report
     kept beside the library) and its tensor-core (HGMMA) instructions
     counted in the machine code (cuobjdump -sass): every ``_tc`` kernel
     of the bf16 instances (K5b's ``ssd_bwd_states_tc``,
     ``ssd_bwd_dbx_tc`` and ``ssd_bwd_dc_tc`` included; K4's forward
     at head dims 64, 112 and 128, each at block_q 64 and 128) must
     hold some;
  3. kernel  — the flash-attention kernel against its plain PyTorch
     version at three shapes (StableLM-1.6B prefill in bf16, GQA and
     ragged in f32; then head dim 112, kimi-k2's, in bf16 and f32,
     causal and not, with ragged Sq / Sk; here and at every later K4
     shape two calls give equal bits), with times of kernel, plain
     version and
     ``scaled_dot_product_attention`` (a yardstick the port never calls)
     beside the least time the card could take;
  4. serve   — StableLM-1.6B at full width cut to 12 of 24 layers (bf16,
     random weights from a seed) behind ``InferenceEngine``: 8 requests,
     4 slots, mid-flight joins; every request done, the kernel launched
     12 times per prefill batch,
     three engines with one seed (cold, warm, profiled) give the same
     tokens (the profiled serve's flash kernels all tensor-core
     instances); at full width cut to 2 layers, prefill (kernel attention)
     agrees with decode (plain attention) in f32; then the kernel against
     its plain version at every prefill shape the serve gave it;
  5. ssm     — K5, the SSD chunked scan, against its plain PyTorch
     version in f32 and bf16 at the shapes of tests/test_kernels.py
     (G = 2 included), ragged tails (300 at chunk 256, 7 at chunk 32),
     the tensor-core instance's ragged and G = 2 shapes (1, 300) and
     (2, 700) at P 64 / N 128, and chunk 64 against 128 (each shape with
     relative L2 and two calls giving equal bits); then mamba2-1.3b at
     full width cut to 24 of 48 layers
     (bf16, random weights from a seed) behind ``InferenceEngine``: 8
     requests with prompts of 2,048 to 2 tokens, 4 slots, prefill
     batches (2, 2048), (2, 512), (1, 300), (1, 256), (1, 33), (1, 2)
     (four mid-flight joins); every request done, K5 launched 24 times
     per prefill batch, every launch on the tensor-core instance, three
     engines with one seed (cold, warm, profiled: busy share, K5's share
     and its split by device kernel, every K5 product kernel a ``_tc``
     one) give the same tokens; at full
     width cut to 2 layers in f32, prefill of 301 tokens (K5) agrees with
     prefill of 300 and one decode step (plain recurrence); then K5
     against its plain version at every prefill shape of the serve, with
     kernel, plain and bound ms; K5 at (2, 2048) must take at most
     K5_MAX_MS;
  6. kernels — the training slice's kernels against their plain PyTorch
     versions, each with kernel, plain, library and bound ms: the PS
     update (K1, all five solvers at three shapes, timed at a shard of
     the run), the int8 wire (K2 quantize with error feedback, K3
     dequantize; exact ties included; timed at the run's length, K2 on
     the learner's bf16 gradient, K3 beside the one ``torch.mul`` that
     computes it), and the flash forward with its LSE (K4) and backward
     (K4b) at both training shapes and two small ones, with
     ``scaled_dot_product_attention``'s forward and backward as
     yardsticks the port never calls (each K4/K4b line has its share of
     bound and its multiple of SDPA; at 1 x 4,096 both must be within
     4 x SDPA); two calls on one input give the same bits;
  7. step    — a training step on the card against the CPU at smoke
     width in f32 (``LMPlugin.flat_loss_grad``: loss and flat gradient),
     then one int8 + adam PS round with 2 learners on both devices;
  8. train   — full-width StableLM-1.6B cut to 12 layers (bf16, random
     weights from a seed): two learner threads run ``make_learner_body``
     under the port's ``Watchdog`` against one ``SoftwareParameterServer``
     on the card (4 shards, adam, int8 wire, BSP) for 3 rounds of
     2 x 512 tokens per learner, checkpointing every 3 steps; asserts the
     push/round counts, every kernel's launches (every flash kernel in
     the profiled rounds a tensor-core instance), and that the newest
     checkpoint, the PS params and ``trained_model.npy`` are bit for bit
     one vector; prints round and agg times, tokens per second, peak
     device memory, and a profiled extra round (busy share, the PS
     kernels' share). The same for 3 rounds at one 4,096-token sequence
     per learner step (the model's context). After the first run's
     checks, 3 more rounds on its PS with a device synchronise after
     every step, push and pull, for the per-phase breakdown (those
     timers are not in the runs);
  9. platform — train -> deploy -> predict through the port's platform:
     phase 8's first traffic as a ``repro-lm`` manifest, planned by
     ``SoftwarePSBackend`` with ``BackendContext.cfg`` the 12-layer
     full-width config and launched under the ``LifecycleManager`` and
     ``Scheduler`` on one simulated node of 4 accounted GPUs, ticked to
     COMPLETED; asserts the PS app deployed before the learners, no
     restart, the push/round and launch counts (every flash launch on the
     tensor cores), and the newest checkpoint = the PS params =
     ``trained_model.npy`` bit for bit; releases the PS as ``DLaaSCore``
     does (the device memory one tick later within 0.5 GiB of before the
     plan) and drops the training platform and its device state; then a
     ``ServingBackend`` endpoint with
     ``source_training`` that job (capacity 4, max_seq 1024) goes
     DEPLOYING -> READY, serves the 8 requests of phase 4 (K4 launched 12
     times per prefill batch), drains to STOPPED with its engine
     released, and its tokens equal a bare ``InferenceEngine``'s on the
     PS params with the same seed; prints launch -> COMPLETED, the median
     round beside phase 8's, deploy -> READY split into download and
     start, tokens/s and device memory; prints the training's and the
     endpoint's ``status.perf`` (ready before COMPLETED, ``0 <
     pct_of_attainable <= 100``, the learner step's FLOPs within
     PERF_FLOPS_RANGE of ``model_flops``), each count repeated alone with
     no device allocation and no launch;
 10. service — the same train -> deploy -> predict as a tenant runs it:
     the port's ``DLaaSServer`` (``DLaaSCore`` with ``device="cuda"``,
     ``arch_cfgs`` the 12-layer config, one node of 4 accounted GPUs,
     the health controller's remediation off) driven over HTTP: upload
     ``PLATFORM_MANIFEST`` as YAML, train it to COMPLETED with no
     restart (three steps, ``data_plane``, the timeline's plan/queue_wait/
     run/checkpoint_publish spans, ``/metrics`` parses), the parameter
     server freed while the server stays up (``memory_allocated`` within
     0.5 GiB of its value before the submit), deploy the trained model
     (capacity 4, max_seq 1024) to READY, two requests one at a time
     (tokens equal to a bare ``InferenceEngine``'s on the downloaded
     ``trained_model.npy``, each request alone), the 8 requests of phase
     4 from 8 client threads at once (all DONE, latency p50/p99,
     tokens/s), DELETE to STOPPED with the engine released; the phase's
     K1-K4b launches (K4 12 x pushes + 12 x prefill batches, all on the
     tensor cores); ``status.perf`` ready in the first status that reads
     COMPLETED, ``GET /v1/trainings/<id>/perf`` and the endpoint's, with
     the checks of phase 9, and the ``slo_throughput`` alerts;
 11. ssm-kernel — K5b, the SSD scan backward, against its plain PyTorch
     version (autograd through the plain scan) at the full-width learner
     shapes (2, 512) and (1, 2048) in bf16, the f32 smoke width (64 and a
     ragged 50 positions), a ragged tail (300), a sequence shorter than
     a chunk, G = 2, N 64 at chunk 128 and a nonzero final-state
     gradient: every gradient within K5B_TOL of the plain version run in
     float64, two calls give equal bits; the instance that ran; kernel,
     plain and bound ms, library null; at the two full-width shapes the
     device time by kernel at the larger (``scripts/ssd_kernel_split.py
     --bwd`` in a child process); its device kernels' registers,
     shared memory, spills and HGMMA counts in phase 2. K5b at (1, 2048)
     bf16 must take at most K5B_MAX_MS, and both full-width shapes run
     the tensor-core instance;
 12. ssm-step — the ssm learner step on the card (K5, K5b) against the
     CPU: mamba2-1.3b's smoke reduction in f32, 2 layers, 64 and a
     ragged 50 positions (loss 1e-4, flat gradient 2e-3);
 13. ssm-train — full-width mamba2-1.3b cut to 16 of 48 layers (bf16,
     random weights from a seed) through the learner body and the PS as
     phase 8 (2 learners, 4 shards, adam, int8, BSP, 3 rounds, a
     checkpoint every 3 steps) at 2 x 512 and at 1 x 2,048 tokens per
     learner step: K5 and K5b launched once per layer per step, every
     launch on the tensor-core instances, every loss finite, the loss of a batch the run
     trained on lower under the trained weights than under the initial
     ones (the update moves along its gradient; a held-out batch's two
     losses printed beside it), checkpoint = PS params =
     ``trained_model.npy`` bit for bit; round ms, tokens/s, peak memory
     and a profiled round (busy share, K5 + K5b and K1-K3 shares; every
     K5 and K5b product kernel a ``_tc`` one);
 14. ssm-platform — the 2 x 512 traffic as a ``repro-lm`` manifest with
     ``arch: mamba2-1.3b`` and the 16-layer config through
     ``SoftwarePSBackend`` under the LCM and scheduler to COMPLETED (the
     checks of phase 9, the PS's release included); its
     ``trained_model.npy`` deployed as a managed endpoint (capacity
     4, max_seq 2080) serving the ssm serve's 8 requests, its tokens
     equal to a bare engine's on the same weights; the training's and the
     endpoint's ``status.perf`` (``0 < pct_of_attainable <= 100``);
     launch -> COMPLETED and deploy -> READY seconds;
 15. moe     — the moe family at grok-1's full width (d 6144, 48 heads of
     hd 128, 8 KV heads, 8 experts top-2, d_ff_expert 32,768; bf16,
     random weights from a seed): a. one layer's ``moe_block`` against
     ``moe_ref`` (the plain per-expert loop) at T = 512, 1,024 and a
     forced-drop 1,024 (every row one vector plus noise), relative L2
     within MOE_REL_L2, the dropped pairs equal (the forced input must
     drop), the block's ms beside its bound; b. grok-1 cut to 4 of 64
     layers behind ``InferenceEngine`` (the 8 requests of phase 4, 4
     slots): every request done, K4 launched 4 times per prefill batch,
     every launch on its tensor-core instance (hd 128, GQA 6), three
     engines (cold, warm, profiled) give the same tokens; prefill ms by
     batch, decode ms per step beside the bound of reading every
     expert's weights, tokens/s, peak memory, the profiled busy share
     and top kernels, the engine's ``status.perf`` (``0 <
     pct_of_attainable <= 100``); c. at 2 layers in f32, prefill of 40
     tokens against 39 and one decode step, the 40th token keeping its
     pairs in every layer and the two prefills dropping the same tokens
     (decode never drops); d. K4 against its plain version at every prefill shape of
     the serve; e. the grok-1 smoke-width f32 learner step on the card
     (K4, K4b) against the CPU;
 16. hybrid  — the hybrid family at Jamba-1.5-Large's full width (d 8192,
     64 heads of hd 128, 8 KV heads, 16 experts top-2, d_ff and
     d_ff_expert 24,576, mamba d_inner 16,384 in 256 heads of P 64, N
     128, chunk 256; bf16, random weights from a seed), cut to one period
     of 4 layers (attention + MLP, mamba + MoE, mamba + MLP, mamba + MoE):
     a. behind ``InferenceEngine`` (8 requests of 2,048 to 7 tokens, 4
     slots, max_seq 2080): every request done, per prefill batch K4 once
     and K5 three times, every launch on its tensor-core instance, three
     engines (cold, warm, profiled) give the same tokens; prefill ms by
     batch, decode ms per step beside the bound of reading every weight a
     step reads (all 16 experts' included), tokens/s, peak memory, the
     profiled busy share and top kernels, the engine's ``status.perf``
     (``0 < pct_of_attainable <= 100``); b. at 2 layers (attention + MLP,
     mamba + MoE) in f32, prefill of 301 tokens against 300 and one
     decode step, on the first of HYBRID_CHECK_PROMPTS prompts whose
     301st token keeps its pairs in the MoE layer, the two prefills
     dropping the same tokens (decode never drops); c. K4 and K5 against
     their plain versions at every prefill shape of the serve (two calls
     give equal bits), with kernel, plain, bound and (K4) SDPA ms; d. the
     jamba smoke-width f32 learner step (8 layers) on the card (K4, K4b,
     K5, K5b) against the CPU;
 17. encdec  — whisper-large-v3 at full width and depth (32 + 32 layers,
     d 1280, 20 heads of hd 64, d_ff 5120, LayerNorm, SwiGLU as the
     reference; bf16, random weights from a seed) through the
     model-level steps of ``distributed/steps.py``: a. ENCDEC_STEPS AdamW
     (lr 1e-3) steps on one batch of 4 x (1,500 frames + 448 tokens), the
     frames from a seed with numpy; the loss finite and falling; step
     ms, tokens/s, peak memory and the share of attainable against the
     larger of the step's FLOPs (counted on the meta device) at peak and
     its least bytes (``least_step_bytes``), beside the share of its own
     counted traffic; b. prefill of the frames and a 4-token prompt into
     a cache whose self K/V hold 448 positions, greedy decode to 64
     tokens, decode ms a step beside the bound of the bytes a step reads;
     K4 launched 3 x 32 times per forward and K4b 3 x 32 per step, all
     on the tensor cores; c. at 2 layers in f32, prefill of 33 tokens
     against 32 and one decode step (relative L2); d. K4 with its LSE
     and K4b against their plain versions at the encoder's (4, 1500)
     non-causal, the decoder's (4, 448) causal and the cross (448 against
     1,500) shapes, with SDPA's forward and backward as yardsticks, and
     K4 alone at the prefill's shapes: the encoder's, the prompt's (4, 4)
     causal and its cross (4 against 1,500); e. the smoke-width f32 step
     on the card against the CPU at a limit scaled by each gradient
     leaf's magnitude, and its controls: the step with a fault planted
     in K4b's output (``K4B_FAULTS``) must each fail that limit;
 18. vlm     — qwen2-vl-2b at full width and depth (28 layers, d 1536, 12
     heads over 2 KV heads of hd 128, M-RoPE (16, 24, 24), qkv bias;
     bf16) fed with ``embeds``: one 448 x 448 image per sequence (a 16 x
     16 grid of merged patches with (t, h, w) positions, the text after
     it), S 2,048, B 2: the steps, checks and numbers of phase 17 (the
     decode from a cache with room for 64 tokens; prefill of 289 embeds
     against 288 and one decode step of an embedding), K4 and K4b at (2,
     2048, GQA 6, hd 128) causal, and K4 alone at that prefill shape;
 19. pjit    — stablelm-1.6b at full width cut to 12 of 24 layers (bf16)
     as a ``distribution: pjit`` manifest through ``PjitBackend``, the
     LCM and the scheduler: 12 Adafactor steps of 8 x 512 tokens over
     32 documents, a checkpoint every 4 (Adafactor and an object store in
     host memory keep the run's disk writes small: see
     ``PJIT_MANIFEST``); paused once 6 steps are done,
     preempted, moved with ``resume(new_dist=)`` onto a 1 x 1 mesh
     (``MeshShape``): re-placed, its steps from the step-4 checkpoint on
     run in a rank process on the card (``runtime/spmd.py``, NCCL, one
     rank), COMPLETED; the last pass's mean loss below the first's, K4
     and K4b launched 12 times per step taken (this process's counts and
     the rank's), the losses after the resume within ``MODEL_TOL`` of a
     mesh-less restore of the step-4 checkpoint run here on the same
     batches, the newest checkpoint restored by a fresh ``Trainer`` equal
     to ``trained_model.npy``, the job's ``status.perf`` (collective term
     0: taken from the mesh-less incarnation), the rank's start, restore
     and step times, two warm steps under the profiler; b. a 1-rank NCCL mesh: the ``fsdp_tp`` AdamW step
     against the mesh-less step (loss and every leaf within
     ``MODEL_TOL``), and a mesh-less Adafactor trainer resumed onto the
     mesh at step 4 against an uninterrupted run; K4 and K4b at the
     step's shape (8, 512, 32 heads,
     hd 64) against their plain versions;
 20. solvers, zero3_sp — a. the paper's PS solvers (``core/solvers.py``)
     at stablelm-1.6b's full width cut to 4 of 24 layers (F =
     616,579,072), 4 learners on the card (the local path), 2 x 512
     tokens per learner microstep on fixed batches, the server's AdamW
     (K1's adam) and local SGD at SOLVER_LOCAL_LR: psgd, psgd with the
     int8 push, modelavg, easgd and downpour (H = 2), 3 rounds each; the
     loss falls, each round's launches are the derived counts (K4 =
     K4b = layers x learners x microsteps, all on the tensor cores; K1
     once, downpour once per arrival; K2 = K3 = learners with the int8
     push); round ms, peak memory, ``wire_bytes_per_round`` in both push
     modes (analytic); one round of each at smoke width in f32 on the
     card against the CPU (SOLVER_ATOL); K1 at (4, F) and K2/K3 at the
     push's F against their plain versions; b. K4 with its LSE and K4b
     at the per-rank shapes of a 4-way "model" axis: qwen2-vl-2b's 512
     queries of 2 x 2,048 against the gathered 2,048 keys at q_offset 0,
     512, 1,024 and 1,536 (causal, GQA 6, hd 128) and whisper's encoder
     slice (4, 375 of 1,500, non-causal); the zero3_sp train step of
     qwen2-vl-2b at full width and depth (phase 18's weights) on a
     1-rank NCCL mesh against the mesh-less step (loss and every leaf
     within ``MODEL_TOL``);
 21. kimi, expert-parallel — a. kimi-k2-1t-a32b at full width cut to
     1 of 61 layers (d 7168, 64 heads over 8 of head dim 112, 384
     experts top-8, vocab 163,840; ~39 GB of bf16, random weights from
     a seed) behind ``InferenceEngine``, cold and warm, phase 15's 8
     requests: every request done, the same tokens, K4 on its hd-112
     tensor-core instance at every prefill; tokens/s, prefill ms by
     batch, decode ms a step beside the bound of the bytes a step reads
     (``status.perf``); ``moe_block`` against ``moe_ref`` on its layer
     at k = 8 (relative L2 within ``MOE_REL_L2``, equal dropped pairs,
     a forced-drop input); b. on a 1-rank NCCL mesh (``fsdp_tp``), the
     expert-parallel ``jit_prefill_step`` (the all-to-all body) and
     ``jit_decode_step`` (the all-reduce body) of kimi-k2's weights,
     and then of grok-1's (phase 15's configuration, seed 0), against
     the mesh-less steps: logits and caches equal (``EP_DIFF_LIMIT``);
     c. K4 at kimi-k2's prefill shape (4, 512, 64, KV 8, hd 112) and at
     the serve's, with kernel, plain, bound and SDPA ms; K4b at hd 112
     (``KIMI_BWD_CASES``: (1, 4,096) and the prefill shape in bf16 on the
     tensor cores within ``BWD_BF16_REL_L2``, a ragged f32 shape within
     ``BWD_TOL``; two calls equal in their bits; kernel, plain, bound and
     SDPA-backward ms); the gradient of one attention sub-block (RMSNorm
     -> QKV + RoPE -> K4 -> output projection) on layer 0's weights at
     ``KIMI_GRAD`` through autograd, against the same function with the
     plain attention on the card (every gradient within
     ``BWD_BF16_REL_L2``; one K4 and one K4b launch: the path
     ``grad-kimi-attn``);
 22. autotune — the launch-shape tuner (``kernels/autotune.py``) from a
     fresh cache: a. K1 at the PS shard (2 learners) and the solvers'
     (4, F), K2 and K3 at the PS push (bf16 x) and the solvers' push (f32
     x), K4 at Jamba's serve, the 4,096-token training forward (LSE),
     qwen2-vl's training forward (LSE), a zero3_sp rank slice (512 of
     2,048 at q_offset 0), kimi-k2's serve (hd 112) and a 33-token
     prompt, each looked up as ``ops`` does (a miss, measured on scratch),
     then every candidate run at the full shape on scratch: its outputs
     ``torch.equal`` to the default's (any difference fails), its median
     ms beside the predicted and the tuner's measured us, the default's
     ms and the bound; b. each shape looked up again: a hit with no probe
     launch, hits and misses equal to the calls made, and a
     ``DLaaSCore``'s ``prometheus_text()`` carrying the three
     ``dlaas_autotune_cache_*`` families with those numbers; c.
     ``fit_block`` at an F that degrades it raises the core's
     ``kernels_small_block_total`` by one. The run's tuner reads and
     writes a fresh cache file under ``build/`` (each run tunes from
     scratch); every ``[phase]`` line gives the seconds the tuner spent
     measuring that phase's new shapes and its probe launches, which the
     kernels' launch counts leave out;
 23. dryrun  — a. a child process with no card visible, started before
     phase 2 and waited for here (``--dryrun-child``): ``run_cell`` of
     ``DRYRUN_CELLS`` (stablelm-1.6b train_4k on (16, 16), kimi-k2
     train_4k on (2, 16, 16)) on the meta device over a fake 512-rank
     group, and ``dry_step`` of phase 19 b's step (12 layers, 8 x 512,
     AdamW, fsdp_tp on a 1-rank mesh) at remat none and full; every
     record ``ok``; b. that step on the card, a fresh trainer at each
     remat value: the bytes of its params, optimizer state and batch
     equal the dry-run's ``argument_size_in_bytes`` to the byte, and
     ``max_memory_allocated() - memory_allocated()`` across one
     ``step_once`` is within ``REMAT_TEMP_TOL`` of its
     ``temp_size_in_bytes``; remat full's loss and updated leaves equal
     remat none's within ``MODEL_TOL``; K4 and K4b launch once a layer
     at none, K4 twice at full (the path ``train-pjit-remat``);
 24. drills  — the paper's fault tolerance through the port's
     ``DLaaSCore`` on the card (stablelm-1.6b at full width cut to 4 of
     24 layers, ``arch_cfgs``; object and results stores in host memory,
     checkpoints on disk; health remediation off): a. an uninterrupted
     training (one learner, SGD, the f32 wire, 2 shards, 2 x 512 tokens,
     8 steps, a checkpoint every 4); b. scripts/verify.sh's crash drill:
     a core process (``--drill-child``) deploys an endpoint, answers one
     prompt, submits a's manifest with an Idempotency-Key, is paused
     after its first checkpoint and SIGKILLed; a fresh core here recovers
     the workdir: the training resumed or requeued, the endpoint
     redeployed, the replayed key gives the original id, every loss
     after the resume equals a's at the same step within
     DRILL_LOSS_RTOL, the endpoint gives the child's tokens, the timeline
     has a ``recovery`` event under the persisted trace id; c. CRASH_CORE
     at step 6 of a's manifest, a second core in this process recovers:
     the zombie's parameter server freed once its learner returned, the
     losses as in b, memory back at the baseline; d. phase 9's traffic
     (2 learners, 4 shards, adam, int8, BSP), 12 steps, paused at step 6
     on a round boundary, the node under the learners killed: re-placed
     on the other node, resumed from step 4, COMPLETED with a restart,
     ``trained_model.npy`` uploaded, the dead incarnation's client
     buffers gone, memory at the survivor's first step no higher than at
     the victim's last plus SERVICE_MEMORY_SLACK; e. an endpoint on two
     single-GPU nodes (capacity 4, max_seq 1024), a request submitted
     while serving is paused, its node killed: re-placed, the request
     DONE with an undisturbed engine's tokens, memory READY again no
     higher than before the kill plus the slack. After each drill the
     device memory is within SERVICE_MEMORY_SLACK of the phase's
     baseline, and each drill's K1-K4b launches are those its steps,
     rounds, pushes and prefill batches imply (the path ``drills``);
     the bytes the phase wrote to disk are printed;
 25. dense   — the dense family's three archs that no earlier phase
     runs, at full width, bf16, random weights from seed 0, each freed
     before the next (``DENSE_CELLS``): minitron-8b (GQA 4, vocab
     256,000) and granite-20b (48 query heads on one KV head, 56.3 GB)
     served at full depth, qwen1.5-110b (QKV bias) cut to 8 of 80
     layers. For each: a. K4 at (1, 4,096) and K4 with its LSE and K4b
     at the arch's train shape against their plain versions, on the
     tensor cores, two calls equal in their bits, with bound and SDPA
     ms; b. the 8 requests of phase 4 through ``InferenceEngine`` (qwen's
     ``bq``/``bk``/``bv`` drawn non-zero into the engine's weights before
     the first request): every request done, K4 once a layer per prefill
     batch on the tensor cores, weights-ready s, prefill ms a batch,
     decode ms a step beside the bound of the least bytes a step reads,
     ``status.perf``; minitron's serve of the first 4 requests under the
     profiler; prefill vs decode at 2 layers in f32 (qwen's biases
     non-zero; held with wq, wk, wv redrawn at std d_model^-1/2,
     ``QK_CHECK_SEED``, and printed at the init's fan-in rule); c.
     ``DENSE_STEPS`` AdamW steps through ``steps.build_train_step`` on one
     batch (granite 2 layers at 1 x 4,096, minitron 2 at 2 x 2,048, qwen
     1 at 2 x 2,048): the losses fall, K4 with LSE and K4b once a layer
     a step, step ms beside the bound of least work; qwen's bias
     gradients finite and non-zero; the smoke-width step of granite (MQA)
     and minitron on the card against the CPU; d. device memory back
     within SERVICE_MEMORY_SLACK of the phase's baseline after each arch.
     The serves' and steps' launches are the path ``dense_archs``;
 26. result  — each phase's wall seconds (a ``[phase]`` line as each
     ends, and a ``[phases]`` line with the tuning seconds by phase),
     ``{"kernels": [...]}`` on the line before the last (each kernel's
     launches summed over the main paths, with ``launches_by_path``;
     K1-K4 with phase 22's chosen and default shapes and times) and
     ``{"ok": true, "device": {...}}`` as the last line.

``PERF.md`` gives the measured run times on an H100 80GB HBM3 at 700 W,
the kernel builds included.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # tests/test_kernels.py:34
SERVE_ARCH = "stablelm-1.6b"
SERVE_LAYERS = 12          # full width, 12 of 24 layers (PERF.md §4)
SERVE_REQUESTS = [(128, 16), (128, 32), (128, 24), (128, 20),
                  (512, 32), (512, 16), (33, 24), (7, 32)]  # (prompt, max_new)
# prefill (kernel) vs decode (plain) logits, relative L2, f32 at 2 layers:
# the two paths sum in other orders (~1e-6 expected)
PREFILL_DECODE_RTOL = 1e-4
LSE_TOL = 1e-4             # row log-sum-exp, f32 (abs; 1e-5 relative)
BWD_TOL = 2e-3             # K4b in f32 (tests/test_kernels.py:139-162)
BWD_BF16_REL_L2 = 2e-2     # K4b in bf16: relative L2 per gradient
# the bf16 instances of K4 and K4b (hd 64 and 128) run these device
# kernels, each of which must hold tensor-core (HGMMA) instructions
FLASH_LIBS = ("flash_attention", "flash_attention_bwd")
TC_KERNELS = ("flash_fwd_kernel_tc", "flash_bwd_dq_tc_kernel",
              "flash_bwd_dkv_tc_kernel")
# K5's bf16 instance (P 64, N 64 and 128): its product kernels
SSD_TC_KERNELS = ("ssd_chunk_cb_tc", "ssd_chunk_state_tc",
                  "ssd_chunk_scan_tc")
# K5b's bf16 instance (P 64, N 64 and 128): its product kernels
SSD_BWD_TC_KERNELS = ("ssd_bwd_states_tc", "ssd_bwd_dbx_tc",
                      "ssd_bwd_dc_tc")
TC_LIBS = FLASH_LIBS + ("ssd_scan", "ssd_scan_bwd")
# the product kernels of K5 and K5b, both instances (the carries, the
# finalize and the sums have no products): in a bf16 run at P 64 / N 128
# each one the profiler sees must be a ``_tc`` kernel
SSD_PRODUCT_KERNELS = ("ssd_chunk", "ssd_bwd_chunk", "ssd_bwd_dxdt",
                       "ssd_bwd_dcb", "ssd_bwd_states", "ssd_bwd_dbx",
                       "ssd_bwd_dc")
# K4 and K4b at the model's context (1 x 4,096, bf16 causal) take at most
# this many times SDPA's forward / backward, timed in the same run
TC_MAX_X_SDPA = 4.0
# K1 (tests/test_kernels.py:71-73): params 1e-5, m/v 1e-6
AGG_TOL = {"params": 1e-5, "m": 1e-6, "v": 1e-6}
# K2 (tests/test_compression.py:112-122): q equal, scales rtol 1e-6,
# err atol 1e-6; K3 exactly equal
QUANT_TOL = {"scales_rtol": 1e-6, "err_atol": 1e-6}
STEP_LOSS_TOL = 1e-4       # loss, card vs CPU, f32 smoke width
STEP_GRAD_TOL = 2e-3       # flat gradient, atol = rtol
ROUND_PARAM_TOL = 1e-5     # PS params after one int8 + adam round
TRAIN_ARCH_LAYERS = 12     # full width, depth cut to fit one card
# 3 rounds, a checkpoint at the last (the cuts of PERF.md §4)
TRAIN = dict(n_learners=2, n_shards=4, steps=3, batch_docs=2, seq_len=512,
             checkpoint_every=3, lr=1e-4, optimizer="adam",
             compression="int8")
# one sequence at the model's published context (StableLM 2 1.6B model
# card, hf:stabilityai/stablelm-2-1_6b: 4,096 tokens) per learner step
TRAIN_LONG = dict(TRAIN, batch_docs=1, seq_len=4096)
# the per-phase breakdown: rounds with synchronised timers on TRAIN's PS
BREAKDOWN_ROUNDS = 3
PS_KERNELS = ("ps_aggregate", "quantize_ef", "dequantize")
# phase 9: TRAIN's traffic as a manifest, planned by the software-ps
# backend on one simulated node whose GPUs are accounted only (one card)
PLATFORM_JOB = "chip-smoke-training"
PLATFORM_ENDPOINT = "chip-smoke-endpoint"
PLATFORM_GPUS = 4
PLATFORM_MANIFEST = {
    "name": "chip-smoke", "learners": TRAIN["n_learners"],
    "optimizer": TRAIN["optimizer"], "lr": TRAIN["lr"],
    "compression": TRAIN["compression"], "ps_shards": TRAIN["n_shards"],
    "batch_docs": TRAIN["batch_docs"], "steps": TRAIN["steps"],
    "checkpoint_every": TRAIN["checkpoint_every"], "seed": 0,
    "data": {"n_docs": 512, "seq_len": TRAIN["seq_len"], "seed": 0},
    "framework": {"name": "repro-lm", "arch": SERVE_ARCH}}
ENDPOINT_SERVING = {"capacity": 4, "max_seq": 1024, "max_queue": 16,
                    "seed": 0}
# phase 10: PLATFORM_MANIFEST through the port's REST server. First the
# requests of SERVE_REQUESTS at these indices (128 and 7 tokens), one at a
# time, then all of them from one client thread each
SERVICE_ALONE = (0, 7)
SERVICE_SPANS = ("plan", "queue_wait", "run", "checkpoint_publish")
# device memory one tick after COMPLETED against before the submit: the
# parameter server (26.93 GiB at 12 layers) must be freed
SERVICE_MEMORY_SLACK = 0.5 * 2**30
# status.perf (phases 9 and 10): the learner step's FLOPs counted on the
# meta device against model_flops (6 N T plus attention; the count has
# no embedding product, 0.870 of it at this config)
PERF_FLOPS_RANGE = (0.85, 1.15)
# the ssm serve: mamba2-1.3b at full width and depth. Prompts up to 2,048
# tokens, the context of the Mamba-2 language models (arXiv:2405.21060);
# equal-length neighbours prefill together, so the batches are (2, 2048),
# (2, 512), then joins (1, 300), (1, 256), (1, 33), (1, 2): eight chunks
# of 256, exactly one, a ragged tail, a prompt shorter than a chunk and
# one shorter than the conv window
SSM_ARCH = "mamba2-1.3b"
SSM_SERVE_LAYERS = 24      # full width, 24 of 48 layers (PERF.md §4)
SSM_REQUESTS = [(2048, 16), (2048, 32), (512, 24), (512, 16), (300, 32),
                (256, 20), (33, 24), (2, 32)]           # (prompt, max_new)
SSM_PREFILLS = [(2, 2048), (2, 512), (1, 300), (1, 256), (1, 33), (1, 2)]
SSM_MAX_SEQ = 2080
SSD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}    # tests/test_kernels.py:56
SSD_KERNELS = ("ssd_",)    # K5's device kernels share the prefix
# K5 at the serve's (2, 2048) bf16 takes at most half its PR 14 time
# (1.1903 ms, the CUDA-core kernels)
K5_MAX_MS = 0.6
# phases 11-14: ssm training. K5b against its plain version run in
# float64 on float64 copies of the same inputs (the exact gradient of the
# values the kernel reads), every gradient elementwise at atol = rtol: f32
# at SSD_TOL (the kernel sums in f32); bf16, compared in f32, at 2e-2: the
# kernel computes in f32 from the same values and rounds dx, db and dc to
# bf16 (2^-8 relative) at the end
K5B_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
# K5b at the learner's (1, 2048) bf16 takes at most twice the 0.5 ms its
# tensor-core instance is held to (its CUDA-core kernels took 2.3051 ms
# on an H100 80GB HBM3 at 700 W)
K5B_MAX_MS = 1.0
SSM_STEP_SEQS = (64, 50)   # the smoke step: two chunks of 32; ragged
# mamba2-1.3b at full width cut to 16 of its 48 layers (at 32,
# F = 1,032,986,624; 48 layers, F = 1,446,505,472, would take ~72 GB with
# its PS at ~50 B/param)
SSM_TRAIN_LAYERS = 16
SSM_TRAIN = dict(TRAIN)    # 2 x 512 tokens per learner step: two chunks
# one sequence at the model's context (2,048, the ssm serve's longest
# prompt) per learner step: eight chunks, K5 and K5b at their largest
SSM_TRAIN_LONG = dict(TRAIN, batch_docs=1, seq_len=2048)
SSM_PLATFORM_JOB = "chip-smoke-ssm-training"
SSM_PLATFORM_ENDPOINT = "chip-smoke-ssm-endpoint"
SSM_PLATFORM_MANIFEST = dict(PLATFORM_MANIFEST, name="chip-smoke-ssm",
                             framework={"name": "repro-lm",
                                        "arch": SSM_ARCH})
SSM_ENDPOINT_SERVING = dict(ENDPOINT_SERVING, max_seq=SSM_MAX_SEQ)
# phase 15: the moe family. grok-1 (configs/grok_1_314b.py,
# hf:xai-org/grok-1) at full width: one layer holds 4,919,980,032
# parameters (9.84 GB in bf16), embed + head 1,610,612,736; 4 of its 64
# layers make 21.29 B parameters, 42.6 GB of bf16 weights (6 would take
# 62.3 GB of the card's 80, with little left for the cache, prefill and
# the profiler)
MOE_ARCH = "grok-1-314b"
MOE_SERVE_LAYERS = 4
# moe_block against moe_ref, one full-width layer in bf16: T = 512 (the
# serve's (4, 128) batch), 1,024 ((2, 512)), and 1,024 rows of one vector
# plus 1e-3 noise, so every pair picks the same two experts (capacity
# 320: most of each expert's 1,024 pairs dropped)
MOE_BLOCK_CASES = [((4, 128), "random"), ((2, 512), "random"),
                   ((2, 512), "drop")]
# relative L2 of moe_block against moe_ref in bf16: the same products,
# each rounded to bf16 (2^-8), with f32 sums in other orders and tilings
MOE_REL_L2 = 1e-2
# prefill (40 tokens) against prefill (39) + decode at full width, 2
# layers in f32 (45.8 GB of weights). Both prefills have capacity 16 per
# expert, and a pair's rank in its expert follows token order, so the
# first 39 tokens (whose inputs to every layer are the same in both,
# attention being causal) keep and drop the same pairs in both; decode
# never drops. The comparison therefore holds where the 40th token kept
# its pairs in every layer of prefill(40): asserted, with the two
# prefills' dropped tokens equal layer by layer. (With random weights at
# full width, layer 1's router overfilled an expert for each of 8
# prompts tried on an H100, so no drop-free prompt is at hand.)
MOE_CHECK_LAYERS = 2
MOE_STEP_SEQS = (64,)      # the smoke step: 2 x 64 tokens, capacity 80
# phase 16: the hybrid family. Jamba-1.5-Large
# (configs/jamba_1_5_large_398b.py, arXiv:2403.19887;
# hf:ai21labs/AI21-Jamba-1.5-Large) at full width: one 8-layer period
# holds 45.14 B parameters (90.3 GB in bf16), more than the card's 80 GB,
# so the serve runs one period of 4 layers (attn_period 8 -> 4, n_layers
# 72 -> 4), the first four layers of every Jamba period: 22.98 B
# parameters, 45.96 GB of bf16 weights (attention : mamba 1:3, not 1:7)
HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_CUT = dict(attn_period=4, n_layers=4)
# prompts of 2,048 (K5 over eight chunks, K4 at its largest causal
# shape), 512, 300 (a ragged chunk tail), 128, 33 and 7 tokens
HYBRID_REQUESTS = [(2048, 16), (2048, 32), (512, 24), (512, 16),
                   (300, 32), (128, 20), (33, 24), (7, 32)]
HYBRID_MAX_SEQ = 2080
# prefill (301 tokens) against prefill (300) + decode at 2 layers in f32
# (attention + MLP, mamba + MoE: 11.9 B parameters, 47.6 GB). Both
# prefills have capacity 48 per expert and a pair's rank in its expert
# follows token order, so the first 300 tokens (whose inputs to the MoE
# layer are the same in both: attention and the scan are causal) keep
# and drop the same pairs in both; decode never drops. The comparison
# holds where the 301st token kept its pairs: the first of up to
# HYBRID_CHECK_PROMPTS prompts (drawn from seeds 0, 1, ...) that keeps
# them is compared, and the drops of every prompt tried are printed
HYBRID_CHECK_CUT = dict(attn_period=2, n_layers=2)
HYBRID_CHECK_N = 300
HYBRID_CHECK_PROMPTS = 8
HYBRID_STEP_SEQS = (64, 50)  # the smoke step: two chunks of 32; ragged
# phases 17 and 18: the stub-frontend families, nothing cut, through the
# model-level steps (distributed/steps.py with optim/optimizers.py), the
# reference's only way to train and run them. Phase 17: whisper-large-v3
# (arXiv:2212.04356) at the published lengths of
# hf:openai/whisper-large-v3 (n_audio_ctx 1,500 frames: 30 s of audio
# after the stubbed conv frontend; n_text_ctx 448 tokens); the prompt is
# a 4-token start-of-transcript prefix (start, language, task,
# no-timestamps ids of Whisper's multilingual vocabulary)
ENCDEC_ARCH = "whisper-large-v3"
ENCDEC_BATCH = 4
ENCDEC_FRAMES = 1500
ENCDEC_TOKENS = 448
ENCDEC_STEPS = 4
ENCDEC_PROMPT_IDS = (50258, 50259, 50360, 50364)
ENCDEC_NEW = 64
# phase 18: qwen2-vl-2b (arXiv:2409.12191) fed with embeds: one 448 x 448
# image per sequence, patches of 14 merged 2 x 2: 256 vision tokens on a
# 16 x 16 grid, (t, h, w) M-RoPE positions, the text after them
VLM_ARCH = "qwen2-vl-2b"
VLM_BATCH = 2
VLM_SEQ = 2048
VLM_GRID = 16
VLM_STEPS = 4
VLM_NEW = 64
# both: prefill against decode at full width cut to 2 layers in f32
FAMILY_CHECK_LAYERS = 2
FAMILY_CHECK_N = 32
# phase 19: the pjit distribution. stablelm-1.6b at full width cut to
# PJIT_LAYERS as a manifest through PjitBackend: 12 Adafactor steps of 8
# x 512 tokens over 32 documents (each seen three times, one pass every
# 4 steps), a checkpoint every 4 steps; paused once 6 steps are done,
# preempted, resumed from its checkpoint. Adafactor, not AdamW: the
# card's machine may write 45 GiB to its disk in a whole run, and an
# AdamW checkpoint of this model is 16.4 GB (its f32 moments), three of
# them 49 GB, where an Adafactor one is 3.3 GB (bf16 params, factored
# moments). The platform's object store (the checkpoint mirror) and
# results store are in host memory for the same reason. The resume after
# the preemption moves the job onto a 1-rank mesh: its later steps run in
# a rank process (runtime/spmd.py). Then the sharded step on a 1-rank NCCL
# mesh in this process against the mesh-less step (AdamW, no
# checkpoint), and a resume onto that mesh (Adafactor)
PJIT_ARCH = "stablelm-1.6b"
# full width, 12 of 24 layers (PERF.md §4). Its status.perf check
# holds the learner step's FLOPs within PERF_FLOPS_RANGE of model_flops,
# whose share without the embedding's product falls with depth (0.870 at
# 12 layers, 0.8126 at 6), so the depth is not cut below 12
PJIT_LAYERS = 12
PJIT_JOB = "chip-smoke-pjit"
PJIT_MANIFEST = {
    "name": "chip-smoke-pjit", "learners": 1, "steps": 12,
    "checkpoint_every": 4, "lr": 1e-3, "optimizer": "adafactor",
    "seed": 0, "batch_docs": 8, "data": {"n_docs": 32, "seq_len": 512},
    "distribution": "pjit",
    "framework": {"name": "repro-lm", "arch": PJIT_ARCH}}
PJIT_EPOCH = 4             # steps per pass over the documents
PJIT_PAUSE_AFTER = 6       # steps done when the job is paused and preempted
PJIT_MESH_STEPS = 8        # 19 b: mesh-less run; resumed onto the mesh at 4
PJIT_MESH_LR = 3e-4        # 19 b's AdamW step
MODEL_TOL = 1e-4           # atol = rtol, params (tests/test_torch_steps.py)
# every model the phases train runs without remat, as the learner, the
# trainer and the engine do (the reference's "remat": "none"): a
# recomputed forward would launch K4 and K5 again
NO_REMAT = {"remat": "none"}

# phase 20: the paper's PS solvers (core/solvers.py) at full width, L = 4
# learners on the local path, and zero3_sp's sequence-parallel attention
SOLVER_ARCH = "stablelm-1.6b"
SOLVER_LAYERS = 4          # full width, 4 of 24 layers
SOLVER_LEARNERS = 4
SOLVER_DOCS, SOLVER_SEQ = 2, 512   # tokens per learner microstep: 2 x 512
SOLVER_ROUNDS = 3
# local SGD of modelavg / easgd / downpour. The gradient of the mean CE of
# 1,024 tokens over a 100,352-token vocabulary is small: at 0.1 an SGD
# step of the f32 center mostly vanishes when the weights are cast to
# bf16 for the forward, and modelavg's loss did not fall in 3 rounds;
# at 0.3, 1 and 3 every solver's fell, most at 3 (PERF.md §6)
SOLVER_LOCAL_LR = 3.0
SOLVER_OPT = dict(name="adamw", lr=1e-3)   # the server's: K1's adam
SOLVER_RUNS = (("psgd", dict(name="psgd")),
               ("psgd-q8", dict(name="psgd", compress=True)),
               ("modelavg", dict(name="modelavg", comm_every=2)),
               ("easgd", dict(name="easgd", comm_every=2)),
               ("downpour", dict(name="downpour", comm_every=2)))
# card vs CPU at smoke width, sgd on the server and locally
SOLVER_SMOKE_LR = 2e-3
SOLVER_ATOL = 1e-5         # tests/test_torch_solvers.py
# An int8 push's rounding boundary can turn a 1e-7 difference between the
# devices' gradients into one int8 code of difference, a quantization
# step (~0.016 at the smoke gradients' block maxima) in that learner's
# wire value and, opposite, in its error-feedback row. psgd-q8's center
# is held to SOLVER_ATOL after each such flip's lr / L x step is taken
# out (a flip: an element of ``err`` that differs by more than SOLVER_ATOL
# and by more than its 256-block's largest |err| on the CPU, which is at
# most half a step), and the flips to at most this share of the L x F
# codes
SOLVER_MAX_FLIP_SHARE = 1e-2
SP_MODEL = 4               # the "model" axis whose per-rank shapes 20 b runs
SP_ENC = (4, 1500, 20, 20, 64)   # whisper-large-v3's encoder: B, S, H, KV, hd
# phase 21: kimi-k2-1t-a32b (configs/kimi_k2_1t_a32b.py) at full width, d
# 7168, 64 heads over 8 KV heads of head dim 112, 384 experts top-8 of
# d_ff 2048, vocab 163,840: one of its 61 layers holds 33.82 GB of bf16
# experts and 0.23 GB of attention; with the untied embedding and head
# (2 x 2.35 GB) the serve holds ~39 GB (grok-1's 42.6 GB of phase 15 is
# freed before it and built again after it for 21 b)
KIMI_ARCH = "kimi-k2-1t-a32b"
KIMI_SERVE_LAYERS = 1
# moe_block against moe_ref on the serve's layer (k = 8): T = 512 (the
# serve's (4, 128) batch) and 1,024, and 512 rows of one vector plus 1e-3
# noise (every pair picks the same 8 experts: capacity 16 of 512 each)
KIMI_BLOCK_CASES = [((4, 128), "random"), ((2, 512), "random"),
                    ((4, 128), "drop")]
# K4 at kimi-k2's prefill shape: B, S, H, KV, hd 112, bf16, causal
KIMI_PREFILL = (4, 512, 64, 8, 112, "bfloat16", True)
# 21 b: the expert-parallel prefill (EP_PROMPT tokens: the train body)
# and EP_DECODE decode steps (the decode body) of EP_BATCH rows on a
# 1-rank mesh against the mesh-less steps: the same arithmetic in the
# same order (the collectives over one rank are copies, the capacities
# equal), so the limit is no difference at all
EP_BATCH = 4
EP_PROMPT = 128
EP_DECODE = 2
EP_DIFF_LIMIT = 0.0
# phase 3: K4 at head dim 112 in both instances, causal and not, ragged
# Sq / Sk: (B, S, H, KV, hd, dtype, causal), Sk
K4_HD112_CASES = [((2, 300, 16, 2, 112, "bfloat16", True), None),
                  ((1, 100, 8, 1, 112, "bfloat16", False), 230),
                  ((1, 37, 8, 2, 112, "float32", True), None),
                  ((2, 77, 8, 1, 112, "float32", False), 141)]
# 21 c: K4b at kimi-k2's head dim 112 (the hd-128 tiles, columns
# 112..127 zero-filled): (1, 4096) and the prefill shape in bf16, causal
# with the LSE, and a small ragged shape in f32; then the gradient of one
# kimi-k2 attention sub-block at full width (KIMI_GRAD: batch, tokens),
# kernels against the plain versions on the card
KIMI_BWD_CASES = [(1, 4096, 64, 8, 112, "bfloat16", True, 0),
                  KIMI_PREFILL + (0,),
                  (2, 300, 8, 1, 112, "float32", True, 0)]
KIMI_GRAD = (1, 2048)

# Phase 23, the dry-run: a child process with no card counts these cells
# on the meta device over a fake 512-rank group while the card phases
# run, and phase 19 b's step (PJIT_LAYERS layers, PJIT_MANIFEST's batch,
# AdamW at PJIT_MESH_LR, fsdp_tp on a 1-rank mesh) at each REMAT_MODES
# value; the card then runs that step at each value and holds its bytes
# to the count: the arguments to the byte, the temp bytes within
# REMAT_TEMP_TOL
DRYRUN_CELLS = (("stablelm-1.6b", "train_4k", "single"),
                ("kimi-k2-1t-a32b", "train_4k", "multi"))
REMAT_MODES = ("none", "full")
REMAT_TEMP_TOL = 0.10
DRYRUN_CHILD_TIMEOUT = 600

# phase 24: the paper's fault tolerance (scripts/verify.sh's drills and
# tests/test_fault_tolerance.py's) through the port's DLaaSCore on the
# card: stablelm-1.6b at full width cut to SOLVER_LAYERS (F =
# 616,581,120), so that four trainings fit the phase's time
DRILL_LAYERS = SOLVER_LAYERS
# a-c: one learner, the f32 wire, 2 shards, 2 x 512 tokens, 8 steps, a
# checkpoint every 4. The server's solver is SGD: a learner's checkpoint
# holds the weights only (as the reference's), so a job resumed on a new
# core starts Adam's moments from zero and leaves the uninterrupted run's
# path; a resume that equals it (DRILL_LOSS_RTOL) needs a solver without
# state. lr 3.0: smaller SGD steps at full width do not survive the cast
# of the weights to bf16 (phase 20's local SGD)
DRILL_MANIFEST = {
    "name": "chip-smoke-drill", "learners": 1, "optimizer": "sgd",
    "lr": 3.0, "compression": "none", "ps_shards": 2,
    "batch_docs": TRAIN["batch_docs"], "steps": 8, "checkpoint_every": 4,
    "seed": 0, "data": {"n_docs": 512, "seq_len": TRAIN["seq_len"],
                        "seed": 0},
    "framework": {"name": "repro-lm", "arch": SERVE_ARCH}}
DRILL_LOSS_RTOL = 1e-6     # scripts/verify.sh's crash-recovery drill
DRILL_CRASH_AT = 6         # c: CRASH_CORE once step 6 is done
# d: phase 9's traffic at this depth (2 learners, 4 shards, adam, int8,
# BSP), 12 steps, a checkpoint every 4; paused once 6 steps are done,
# then the node under the learners is killed
DRILL_NODE_MANIFEST = dict(PLATFORM_MANIFEST, name="chip-smoke-drill-node",
                           steps=12, checkpoint_every=4)
DRILL_PAUSE_AT = 6
DRILL_NEW = 8              # tokens a drill's request decodes
DRILL_CHILD_TIMEOUT = 300

# Phase 25: the dense archs no earlier phase runs, at full width, bf16.
# serve_layers: the served depth (qwen1.5-110b's 80 layers are 217 GB of
# bf16: 8 of them, 26.7 GB with the embedding and head); train: (layers,
# B, S) of the AdamW steps (with the f32 moments they peak at 25, 44 and
# 65 GiB on an H100 80GB)
DENSE_CELLS = (
    dict(arch="minitron-8b", serve_layers=32, train=(2, 2, 2048)),
    dict(arch="granite-20b", serve_layers=52, train=(2, 1, 4096)),
    dict(arch="qwen1.5-110b", serve_layers=8, train=(1, 2, 2048)),
)
DENSE_K4_SEQ = 4096        # a.: K4 causal at (1, 4,096) of each arch
DENSE_STEPS = 3            # c.: AdamW steps on one batch: losses fall
# the arch whose serve runs again under the profiler, with the first 4
# requests (one prefill batch of 4 x 128, then decode: with all 8
# requests' ~190,000 device events the profiled serve and its
# post-processing took most of a minute)
DENSE_PROFILED = ("minitron-8b", SERVE_REQUESTS[:4])
DENSE_SMOKE_ARCHS = ("granite-20b", "minitron-8b")   # c.: card vs CPU
QKV_BIAS_STD = 0.1         # tests/test_torch_model.py:_setup's draw
# b.'s prefill-vs-decode check redraws wq, wk, wv at std d_model^-1/2:
# the reference's fan-in rule (a leaf's shape[-2]: the head count) gives
# granite's one KV head std 1, scores of std ~887, where two f32 paths
# differ by 1e-4 to 2e-3 from rounding alone (tests/test_torch_model.py::
# test_granite_prefill_vs_decode_conditioning; PERF.md §6, PR 32)
QK_CHECK_SEED = 2500


@dataclasses.dataclass(frozen=True)
class PlatformRun:
    """One train -> deploy -> predict run through the platform: its
    printed tag, the training's id and manifest, the endpoint's id,
    serving block and requests, and the phase whose hand loop ran the
    same traffic."""
    label: str
    job: str
    manifest: dict
    endpoint: str
    serving: dict
    requests: list
    hand_phase: str


PLATFORM = PlatformRun("platform", PLATFORM_JOB, PLATFORM_MANIFEST,
                       PLATFORM_ENDPOINT, ENDPOINT_SERVING, SERVE_REQUESTS,
                       "phase 8")
SSM_PLATFORM = PlatformRun("ssm-platform", SSM_PLATFORM_JOB,
                           SSM_PLATFORM_MANIFEST, SSM_PLATFORM_ENDPOINT,
                           SSM_ENDPOINT_SERVING, SSM_REQUESTS, "phase 13")


class PhaseClock:
    """Wall seconds of each phase of ``main``, each printed on a line of
    its own as the phase ends, and all of them at the end; beside each,
    the seconds the launch-shape tuner spent measuring the phase's new
    shapes (``autotune.tuning_seconds``, inside the wall seconds) and its
    probe launches, so that a first round's time is not misread."""

    def __init__(self):
        from repro_torch.kernels import autotune
        self.autotune = autotune
        self.start = self.t = time.perf_counter()
        self.tuned, self.probes = 0.0, 0
        self.rows, self.tuning = [], []

    def done(self, phase: str) -> None:
        now = time.perf_counter()
        tuned = self.autotune.tuning_seconds - self.tuned
        probes = self.autotune.probe_launches - self.probes
        self.rows.append((phase, round(now - self.t, 1)))
        self.tuning.append((phase, round(tuned, 3)))
        print(f"[phase] {phase}: {now - self.t:.1f} s wall; tuning "
              f"{tuned:.3f} s of it ({probes} probe launches)", flush=True)
        self.t, self.tuned = now, self.autotune.tuning_seconds
        self.probes = self.autotune.probe_launches

    def summary(self) -> str:
        return (f"[phases] {json.dumps(dict(self.rows))}; total "
                f"{time.perf_counter() - self.start:.1f} s; tuning s by "
                f"phase {json.dumps(dict(self.tuning))}")


def fresh_autotune_cache() -> None:
    """Point the launch-shape tuner at a new cache file under
    ``build/`` (removed at exit), so each run tunes from scratch and no
    earlier run's records steer it."""
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-autotune-",
                                 dir=build_dir))
    atexit.register(shutil.rmtree, work, True)
    os.environ["DLAAS_AUTOTUNE_CACHE"] = str(work / "cache.json")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_setup(script: str):
    """The start of a script that runs phases of this file alone: exit
    2 without a card; else TF32 off, a fresh autotune cache, the card's
    name and power limit printed, every kernel built. Returns (torch, the
    card's line)."""
    import torch
    if not torch.cuda.is_available():
        print(f"{script}: needs a CUDA card", file=sys.stderr)
        raise SystemExit(2)
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fresh_autotune_cache()
    card = card_line()
    print(card)
    build.build_all()
    return torch, card


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def demangle(names):
    """{mangled: readable} through cu++filt beside nvcc (the mangled
    name where that tool is missing)."""
    from repro_torch.kernels import build
    names = sorted(names)
    tool = Path(build.find_nvcc()).with_name("cu++filt")
    if not tool.exists():
        return {n: n for n in names}
    out = subprocess.run([str(tool)], input="\n".join(names) + "\n",
                         capture_output=True, text=True, timeout=60).stdout
    readable = out.splitlines()
    if len(readable) != len(names):
        return {n: n for n in names}
    def short(r):
        for noise in ("(anonymous namespace)::", "<unnamed>::", "(int)"):
            r = r.replace(noise, "")
        r = r.replace("(bool)0", "false").replace("(bool)1", "true")
        return r.split("(")[0].removeprefix("void ").strip()
    return {n: short(r) for n, r in zip(names, readable)}


def report_tc_build(build, built, card):
    """For the libraries with tensor-core instances (K4, K4b, K5, K5b):
    each device kernel's registers, shared memory and spills (nvcc's
    ptxas report, kept beside the library) and its count of tensor-core
    instructions in the machine code (cuobjdump -sass). Raises if a
    ``_tc`` kernel holds no HGMMA at any of its widths. Returns
    (the HGMMA counts by readable kernel name, {library: {readable kernel
    name: its ptxas report}})."""
    import ctypes
    dyn = {}
    fwd = ctypes.CDLL(str(built["flash_attention"].library))
    bwd = ctypes.CDLL(str(built["flash_attention_bwd"].library))
    ssd = ctypes.CDLL(str(built["ssd_scan"].library))
    ssdb = ctypes.CDLL(str(built["ssd_scan_bwd"].library))
    for hd in (64, 112, 128):
        for bq in (64, 128):
            dyn[f"flash_fwd_kernel_tc<{hd}, {bq}>"] = \
                fwd.flash_attention_fwd_tc_smem(hd, bq)
    for hd in (64, 112, 128):
        dyn[f"flash_bwd_dq_tc_kernel<{hd}>"] = \
            bwd.flash_attention_bwd_tc_smem(hd, 0)
        dyn[f"flash_bwd_dkv_tc_kernel<{hd}>"] = \
            bwd.flash_attention_bwd_tc_smem(hd, 1)
    for hd in (64, 128):
        for i, name in enumerate(SSD_TC_KERNELS):
            dyn[f"{name}<{hd}>"] = ssd.ssd_scan_tc_smem(i, hd)
        for i, name in enumerate(SSD_BWD_TC_KERNELS):
            dyn[f"{name}<{hd}>"] = ssdb.ssd_scan_bwd_tc_smem(i, hd)
    counts, reports = {}, {}
    for lib in TC_LIBS:
        res = built[lib]
        ptxas = build.ptxas_report(res.log)
        sass = build.sass_counts(res.library)
        names = demangle(set(ptxas) | set(sass))
        reports[lib] = {names[fn]: rep for fn, rep in ptxas.items()}
        if not ptxas:
            print(f"[build] {card}: {lib}: no ptxas report kept beside "
                  f"{res.library.name}: registers not captured")
        for fn in sorted(names, key=names.get):
            rep = ptxas.get(fn, {})
            ops = sass.get(fn, {})
            name = names[fn]
            counts[name] = ops.get("HGMMA", 0)
            print(f"[build] {card}: {lib}: {name}: registers "
                  f"{rep.get('registers', 'n/a')}, static smem "
                  f"{rep.get('smem', 'n/a')} B, dynamic smem "
                  f"{dyn.get(name, 0)} B, spill stores/loads "
                  f"{rep.get('spill_stores', 'n/a')}/"
                  f"{rep.get('spill_loads', 'n/a')} B; SASS HGMMA "
                  f"{ops.get('HGMMA', 0)}, HMMA {ops.get('HMMA', 0)}")
    for base in TC_KERNELS + SSD_TC_KERNELS + SSD_BWD_TC_KERNELS:
        found = {n: c for n, c in counts.items()
                 if n.split("<")[0].endswith(base)}
        # K4 and K4b have a third width, head dim 112 (kimi-k2), and
        # K4's forward each width at block_q 64 and 128
        widths = (6 if base == TC_KERNELS[0] else
                  3 if base in TC_KERNELS else 2)
        if len(found) != widths or not all(found.values()):
            raise AssertionError(f"tensor-core kernel {base}: HGMMA "
                                 f"counts {found} (want > 0 at each of "
                                 f"{widths} instances: widths 64, 128 and "
                                 f"for K4 and K4b 112, K4's forward each "
                                 f"at block_q 64 and 128)")
    return counts, reports


def check_tc_names(kernels, where, family="flash_"):
    """Every product kernel of a family (``flash_``; ``ssd_chunk`` for
    K5, whose carry pass has no products; a tuple of names, e.g.
    SSD_PRODUCT_KERNELS for K5 and K5b) the profiler saw in a bf16 run at
    tensor-core widths is a tensor-core instance."""
    families = (family,) if isinstance(family, str) else family
    other = [n for n in kernels if any(f in n for f in families)
             and "_tc" not in n]
    if other:
        raise AssertionError(f"{where}: {family} kernels off the tensor "
                             f"cores: {other}")


def bound(name, **shape):
    """(bound ms, what bounds it) of one call of kernel ``name`` at
    ``shape`` on an H100: the larger of its bytes (inputs read once,
    outputs written once) over the HBM rate and its operations over the
    peak rate for their type, from the port's roofline
    (``analysis/roofline.py:kernel_cost``, the formulas its
    ``status.perf`` counts the kernel by)."""
    from repro_torch.analysis.roofline import kernel_cost
    cost = kernel_cost(name, **shape)
    return 1e3 * cost.bound_s, cost.bound_by


def family_kernels(cfg):
    """(forward, backward) kernel of ``cfg``'s learner step, and the
    prefix of their device kernels' names (dense and ssm families)."""
    if cfg.family == "ssm":
        return "ssd_scan", "ssd_scan_bwd", "ssd_"
    return "flash_attention", "flash_attention_bwd", "flash_"


def step_launches(ops, cfg, pushes, rounds, shards, prefills=0):
    """Every kernel's launches for ``pushes`` learner steps of ``cfg``
    through the PS (``rounds`` rounds over ``shards`` shards) and
    ``prefills`` prefill batches: K2 and K3 once per push, K1 once per
    shard per round, the family's forward kernel (K4 or K5) once per
    layer per step and per prefill batch, its backward (K4b or K5b) once
    per layer per step, nothing else."""
    fwd, bwd, _ = family_kernels(cfg)
    want = dict.fromkeys(ops.launch_counts(), 0)
    want.update(quantize_ef=pushes, dequantize=pushes,
                ps_aggregate=rounds * shards)
    want[fwd] = cfg.n_layers * (pushes + prefills)
    want[bwd] = cfg.n_layers * pushes
    return want


def tensor_core_launches(cfg):
    """{kernel: launches on its tensor-core instance} of the family's
    kernels: K4 and K4b (dense), K5 and K5b (ssm)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_attention_bwd as kfab
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.kernels import ssd_scan_bwd as kssdb
    if cfg.family == "ssm":
        return {kssd.NAME: kssd.launches_tc, kssdb.NAME: kssdb.launches_tc}
    return {kfa.NAME: kfa.launches_tc, kfab.NAME: kfab.launches_tc}


def attention_bound_ms(B, Sq, Sk, H, KV, hd, dtype, causal, q_offset=0):
    """Least time for this call on an H100: q, k, v read once, o written
    once; QK^T and PV over the unmasked score pairs."""
    return bound("flash_attention", B=B, Sq=Sq, Sk=Sk, H=H, KV=KV, hd=hd,
                 dtype=dtype, causal=causal, q_offset=q_offset)


def check_attention(torch, ops, ref, shape, seed=0, sk=None):
    """Kernel vs plain version (and SDPA as yardstick) at one shape, keys
    ``sk`` long (default S, the queries'); two calls on one input give
    equal bits, and bf16 at hd 64/128 launches on the tensor-core
    instance."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    B, S, H, KV, hd, dtype, causal = shape
    Sk = sk or S
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dt)
    k = torch.randn(B, Sk, KV, hd, generator=g, device="cuda").to(dt)
    v = torch.randn(B, Sk, KV, hd, generator=g, device="cuda").to(dt)
    tc = kfa.launches_tc
    got = ops.flash_attention(q, k, v, causal=causal)
    again = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"flash kernel: two calls on one input differ "
                             f"in their bits at {shape}, Sk {Sk}")
    on_tc = kfa.uses_tensor_cores(q)
    if kfa.launches_tc - tc != (2 if on_tc else 0):
        raise AssertionError(f"K4 instance at {shape}, Sk {Sk}: "
                             f"{kfa.launches_tc - tc} tensor-core launches "
                             f"of 2 calls")
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    err = (got.float() - want.float()).abs()
    max_err = err.max().item()
    tol = TOL[dtype]
    bad = (err > tol + tol * want.float().abs()).sum().item()
    if bad or not torch.isfinite(got).all().item():
        raise AssertionError(f"flash kernel disagrees with its plain "
                             f"version at {shape}: {bad} elements out of "
                             f"atol=rtol={tol}, max abs err {max_err}")
    # SDPA wants (B, H, S, hd) and equal head counts: lay out outside timing
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    kernel_ms = time_ms(torch, lambda: ops.flash_attention(
        q, k, v, causal=causal), iters=50)
    plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(
        q, k, v, causal=causal), iters=10)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal), iters=50)
    bound_ms, bound_by = attention_bound_ms(B, S, Sk, H, KV, hd, dtype,
                                            causal)
    sh = {"B": B, "S": S, "H": H, "KV": KV, "hd": hd, "dtype": dtype,
          "causal": causal}
    if Sk != S:
        sh["Sk"] = Sk
    return {"shape": sh, "max_abs_err": max_err, "tol": tol,
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / kernel_ms,
            "x_library": kernel_ms / library_ms, "deterministic": True,
            "instance": "tensor cores" if on_tc else "CUDA cores"}


class SpanRecorder:
    """Duck-typed tracer for the engine and the platform: records every
    span's (name, start, end) on the host clock, and each prefill batch's
    (n, plen) and its host seconds (the span ends after the first
    tokens' device-to-host copy, so it covers the device work); started
    spans (requests, sampled steps) and point events are ignored."""

    def __init__(self):
        self.prefills = []
        self.prefill_s = []
        self.spans = []
        self.ready_s = None

    def span(self, job_id, name, **attrs):
        import contextlib
        if name == "prefill":
            self.prefills.append((attrs["n"], attrs["plen"]))

        @contextlib.contextmanager
        def timed():
            t0 = time.perf_counter()
            yield None
            t1 = time.perf_counter()
            self.spans.append((name, t0, t1))
            if name == "prefill":
                self.prefill_s.append(t1 - t0)
        return timed()

    def start(self, job_id, name, **attrs):
        return name

    def end(self, span, **attrs):
        pass

    def event(self, job_id, name, **attrs):
        pass


def serve_prompts(cfg, seed: int, requests=SERVE_REQUESTS):
    """The prompts of ``requests`` (prompt length, max_new), drawn from
    ``seed``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, size=n).astype("int32")
            for n, _ in requests]


def serve(torch, cfg, ops, seed: int, card: str, profile: bool = False,
          requests=SERVE_REQUESTS, max_seq: int = 1024, flat=None,
          prepare=None):
    """One full serve of ``requests`` (prompt length, max_new) through
    the engine's public API, on the weights ``flat`` (None: fresh from
    ``seed``); ``prepare(params)``, if given, edits the started engine's
    weights in place before the first request. Returns (tokens per
    request, engine, the ``SpanRecorder`` (``ready_s``: the weights-ready
    seconds), launches, wall seconds, profiler or None)."""
    from repro_torch.serving.engine import InferenceEngine
    prompts = serve_prompts(cfg, seed, requests)
    torch.cuda.reset_peak_memory_stats()
    rec = SpanRecorder()
    eng = InferenceEngine(cfg, capacity=4, max_seq=max_seq, max_queue=16,
                          seed=seed, device="cuda", tracer=rec,
                          endpoint_id="chip-smoke")
    t0 = time.perf_counter()
    eng.start(flat)
    torch.cuda.synchronize()
    rec.ready_s = time.perf_counter() - t0
    print(f"[serve] {card}: weights + cache ready in {rec.ready_s:.2f} s")
    if prepare is not None:
        with torch.no_grad():
            prepare(eng.params)
    reqs = [eng.submit(p, max_new=m)
            for p, (_, m) in zip(prompts, requests)]
    failed = []

    def body():
        try:
            eng.run()
        except BaseException as e:       # handed to the main thread below
            failed.append(e)
            raise

    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
        prof.start()
    ops.reset_launch_counts()
    worker = threading.Thread(target=body, name="serve", daemon=True)
    t0 = time.perf_counter()
    worker.start()
    deadline = time.time() + 600
    for r in reqs:
        while not r.wait(0.5):
            if failed:
                raise RuntimeError("serve loop failed") from failed[0]
            if not worker.is_alive() or time.time() > deadline:
                raise AssertionError(f"request {r.req_id} stuck: "
                                     f"{r.status}")
    wall = time.perf_counter() - t0
    if prof is not None:
        torch.cuda.synchronize()
        prof.stop()
    launches = ops.launch_counts()
    eng.drain()
    worker.join(60)
    if worker.is_alive():
        raise AssertionError("serve thread did not exit after drain")
    check_requests(reqs, requests, cfg)
    return [r.tokens for r in reqs], eng, rec, launches, wall, prof


def check_requests(reqs, requests, cfg):
    """Every request DONE with its ``max_new`` tokens, all in the vocab."""
    for r, (plen, m) in zip(reqs, requests):
        if r.status != "DONE" or len(r.tokens) != m:
            raise AssertionError(f"request plen={plen}: {r.status}, "
                                 f"{len(r.tokens)}/{m} tokens {r.error}")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"token out of vocab: {r.tokens}")


def print_profile(prof, wall: float, card: str, top: int = 8,
                  ours=("flash_fwd_kernel",)):
    """Device busy share of the profiled wall time and the kernels that
    took the most device time, from the profiler's CUDA events. Returns
    the device microseconds by event name (empty if the profiler saw no
    device events)."""
    from torch.autograd import DeviceType
    kernels = {}
    n_launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_launches += 1
            kernels[e.name] = kernels.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    if not kernels:
        print(f"[profile] {card}: the profiler saw no device events; "
              f"device busy share not measured")
        return kernels
    busy = sum(kernels.values()) / 1e6
    print(f"[profile] {card}: device busy {busy:.3f} s of {wall:.3f} s "
          f"wall = {busy / wall:.3f} (idle share {1 - busy / wall:.3f}), "
          f"{n_launches} device events under {len(kernels)} names")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    ours = [kv for kv in ranked[top:]
            if any(name in kv[0] for name in ours)]
    for name, us in ranked[:top] + ours:
        print(f"[profile] {card}: {us / 1e3:9.3f} ms "
              f"{us / 1e6 / busy:6.3f} of busy  {name[:110]}")
    return kernels


def prefill_vs_decode(torch, cfg, prompt, seed=0, prepare=None):
    """Full-width model cut to ``cfg.n_layers`` layers, random weights
    (edited in place by ``prepare(params)`` if given): last-position
    logits of prefill(prompt) (attention in the kernel)
    against prefill(prompt[:-1]) + decode(prompt[-1]) (plain decode
    attention), two independent attention paths. Returns the relative L2
    difference. The depth is cut because rounding differences between any
    two paths grow layer by layer through a randomly initialised stack
    (bf16 at 24 layers reaches tens of percent on the CPU too)."""
    from repro_torch.models import make_model
    model = make_model(cfg, opts=NO_REMAT)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    if prepare is not None:
        prepare(params)
    toks = torch.tensor(prompt, device="cuda", dtype=torch.int64)[None]
    with torch.no_grad():
        full, _ = model.prefill(params, {"tokens": toks})
        cache = model.empty_cache(1, len(prompt) + 1, "cuda")
        model.prefill(params, {"tokens": toks[:, :-1]}, cache=cache,
                      slots=torch.tensor([0], device="cuda"))
        step, _ = model.decode(params, cache, {"tokens": toks[:, -1:]})
    a, b = full[0, -1].float(), step[0, -1].float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite logits")
    if a.shape != (cfg.vocab_size,):
        raise AssertionError(f"logits shape {tuple(a.shape)}")
    return ((a - b).norm() / b.norm()).item()


# ---------------------------------------------------------------------------
# Phase 5: the ssm serve and K5
# ---------------------------------------------------------------------------


def ssd_inputs(torch, B, S, H, P, G, N, dtype, seed):
    """tests/test_kernels.py:47-51's distributions: x 0.5 N(0, 1), dt
    softplus(N(0, 1)), a_log 0, b/c 0.3 N(0, 1); x, b, c in ``dtype``."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt_ = getattr(torch, dtype)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device="cuda")
    return (randn(B, S, H, P, scale=0.5).to(dt_),
            F.softplus(randn(B, S, H)), torch.zeros(H, device="cuda"),
            randn(B, S, G, N, scale=0.3).to(dt_),
            randn(B, S, G, N, scale=0.3).to(dt_))


def ssd_bound_ms(B, S, H, P, G, N, chunk, dtype):
    """Least time for K5 at this shape: x, dt, a_log, b, c read once, y
    and the f32 state written once; the chunked scan's products."""
    return bound("ssd_scan", B=B, S=S, H=H, P=P, G=G, N=N, chunk=chunk,
                 dtype=dtype)


def check_ssd(torch, ops, ref, kssd, shape, seed=0):
    """K5 against its plain version at one shape: y and the final state
    within SSD_TOL (atol = rtol), with their relative L2 and the instance
    that ran; two calls give equal bits; then kernel, plain and bound ms.
    No single PyTorch call computes the SSD scan (library_ms null)."""
    B, S, H, P, G, N, chunk, dtype = shape
    args = ssd_inputs(torch, B, S, H, P, G, N, dtype, seed)
    before_tc = kssd.launches_tc
    y, state = ops.ssd_scan(*args, chunk=chunk)
    y2, state2 = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    tensor_cores = kssd.launches_tc == before_tc + 2
    if not (torch.equal(y, y2) and torch.equal(state, state2)):
        raise AssertionError(f"K5: two calls on one input differ in their "
                             f"bits at {shape}")
    y_ref, state_ref = ref.ssd_scan_ref(*args, chunk=chunk)
    tol = SSD_TOL[dtype]
    errs, rels = [], []
    for name, a, b in (("y", y, y_ref), ("state", state, state_ref)):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all().item():
            raise AssertionError(f"K5 {name} not finite at {shape}")
        errs.append((a - b).abs().max().item())
        rels.append(((a - b).norm() / b.norm()).item())
        if (a - b).abs().gt(tol + tol * b.abs()).any():
            raise AssertionError(f"K5 {name} out of atol=rtol={tol} at "
                                 f"{shape}: max abs err {errs[-1]}")
    ms = time_ms(torch, lambda: ops.ssd_scan(*args, chunk=chunk), iters=20)
    plain_ms = time_ms(torch, lambda: ref.ssd_scan_ref(*args, chunk=chunk),
                       iters=5, warmup=1)
    bound_ms, bound_by = ssd_bound_ms(B, S, H, P, G, N, chunk, dtype)
    return {"shape": {"B": B, "S": S, "H": H, "P": P, "G": G, "N": N,
                      "chunk": chunk, "dtype": dtype},
            "instance": "tensor cores" if tensor_cores else "CUDA cores",
            "max_abs_err": max(errs), "y_max_abs_err": errs[0],
            "state_max_abs_err": errs[1], "rel_l2": rels, "tol": tol,
            "deterministic": True, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms}


def ssd_chunk_invariance(torch, ops):
    """tests/test_kernels.py:122 on the card: slow decay (a_log -1, dt
    0.5) across 512 positions, chunk 64 against chunk 128; returns the
    largest difference of y and of the state."""
    x, _, _, b, c = ssd_inputs(torch, 1, 512, 1, 8, 1, 8, "float32", 3)
    dt = torch.full((1, 512, 1), 0.5, device="cuda")
    a_log = torch.full((1,), -1.0, device="cuda")
    y64, s64 = ops.ssd_scan(x, dt, a_log, b, c, chunk=64)
    y128, s128 = ops.ssd_scan(x, dt, a_log, b, c, chunk=128)
    tol = SSD_TOL["float32"]
    for a, b_ in ((y64, y128), (s64, s128)):
        if (a - b_).abs().gt(tol + tol * b_.abs()).any():
            raise AssertionError("K5 differs across chunk 64 and 128")
    return ((y64 - y128).abs().max().item(),
            (s64 - s128).abs().max().item())


def serve_ssm(torch, ops, ref, kssd, card):
    """Phase 5: K5 against its plain version, the mamba2-1.3b serve
    (cold, warm, profiled), prefill against decode at 2 layers in f32,
    and K5 at every prefill shape of the serve. Returns (K5 results at
    the main path's shapes, at the other shapes, the cold serve's
    launches)."""
    from repro_torch.configs.registry import get_arch
    others = [check_ssd(torch, ops, ref, kssd, shape, seed=i)
              for i, shape in enumerate(
                  [(1, 128, 2, 16, 1, 16, 32, dt) for dt in TOL]
                  + [(2, 256, 4, 32, 2, 16, 64, dt) for dt in TOL]
                  + [(1, 128, 4, 64, 1, 32, 128, dt) for dt in TOL]
                  + [(1, 300, 4, 64, 1, 128, 256, dt) for dt in TOL]
                  + [(2, 700, 8, 64, 2, 128, 256, "bfloat16"),
                     (2, 7, 2, 16, 1, 16, 32, "float32")])]
    for res in others:
        print(f"[kernel] {card}: K5 {json.dumps(res)}")
    print(f"[kernel] {card}: K5 chunk 64 vs 128 (y, state) max abs "
          f"difference {ssd_chunk_invariance(torch, ops)} (limit "
          f"{SSD_TOL['float32']})")
    cfg = dataclasses.replace(get_arch(SSM_ARCH), n_layers=SSM_SERVE_LAYERS)
    runs = []
    for label in ("cold", "warm", "profiled"):
        tokens, eng, rec, launches, wall, prof = serve(
            torch, cfg, ops, 0, card, profile=label == "profiled",
            requests=SSM_REQUESTS, max_seq=SSM_MAX_SEQ)
        if kssd.launches_tc != launches[kssd.NAME]:
            raise AssertionError(f"K5: {kssd.launches_tc} of "
                                 f"{launches[kssd.NAME]} launches on the "
                                 f"tensor-core instance, want all")
        st = eng.stats()
        n_batches = eng.prefill_batches
        if rec.prefills != SSM_PREFILLS or n_batches != len(SSM_PREFILLS):
            raise AssertionError(f"prefill batches {rec.prefills}, want "
                                 f"{SSM_PREFILLS}")
        if launches[kssd.NAME] != cfg.n_layers * n_batches:
            raise AssertionError(f"K5 launches {launches} != "
                                 f"{cfg.n_layers} x {n_batches} prefill "
                                 f"batches")
        if runs and tokens != runs[0]:
            raise AssertionError("same seed, same requests, different "
                                 "tokens")
        n_tok = st["tokens_out_total"]
        by_batch = ", ".join(f"{nb}x{pl} {1e3 * t:.2f}" for (nb, pl), t in
                             zip(rec.prefills, rec.prefill_s))
        print(f"[serve-ssm] {card}: {label}: {SSM_ARCH} L={cfg.n_layers} "
              f"d={cfg.d_model} bf16, capacity 4, max_seq {SSM_MAX_SEQ}: "
              f"{st['completed_total']} requests, {n_tok} tokens in "
              f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s; prefill ms by "
              f"batch (n x plen): {by_batch}; mean "
              f"{1e3 * eng.prefill_seconds / n_batches:.2f} ms per batch; "
              f"decode {st['decode_steps']} steps: "
              f"{1e3 * eng.decode_seconds / st['decode_steps']:.2f} ms per "
              f"step; mean occupancy {st['mean_batch_occupancy']}; request "
              f"latency p50 {st['p50_latency_s']} s, p99 "
              f"{st['p99_latency_s']} s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel "
              f"launches {launches}")
        if prof is not None:
            kernels = print_profile(prof, wall, card, ours=SSD_KERNELS)
            check_tc_names(kernels, "ssm serve", family="ssd_chunk")
            if kernels:
                busy = sum(kernels.values())
                mine = {n: us for n, us in kernels.items()
                        if any(k in n for k in SSD_KERNELS)}
                k5 = sum(mine.values())
                print(f"[serve-ssm] {card}: profiled: device busy "
                      f"{busy / 1e6 / wall:.3f} of the wall; K5 "
                      f"{k5 / 1e3:.3f} ms = {k5 / busy:.3f} of busy, "
                      f"{k5 / 1e6 / wall:.3f} of the wall")
                for n, us in sorted(mine.items(), key=lambda kv: -kv[1]):
                    print(f"[serve-ssm] {card}: K5 split: {us / 1e3:9.3f} "
                          f"ms {us / k5:6.3f} of K5  {n[:100]}")
        eng.release()
        runs.append(tokens)
        if label == "cold":
            cold_launches = launches
        del eng, prof
        torch.cuda.empty_cache()
    print(f"[serve-ssm] {card}: {len(runs)} engines, same seed: identical "
          f"tokens")
    # the model's output against an independent path (the plain decode
    # recurrence), across a chunk boundary: 301 = 256 + 45
    cut = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    rel = prefill_vs_decode(torch, cut, list(range(1000, 1301)))
    print(f"[serve-ssm] {card}: {SSM_ARCH} d={cfg.d_model} L=2 float32: "
          f"prefill(301) vs prefill(300) + decode logits, relative L2 "
          f"{rel:.3e} (limit {PREFILL_DECODE_RTOL})")
    if rel > PREFILL_DECODE_RTOL:
        raise AssertionError(f"ssm prefill vs decode logits differ by {rel}"
                             f" > {PREFILL_DECODE_RTOL}")
    s = cfg.ssm
    heads = s.expand * cfg.d_model // s.head_dim
    main_path = [check_ssd(torch, ops, ref, kssd,
                           (n, plen, heads, s.head_dim, s.n_groups,
                            s.d_state, s.chunk_size, "bfloat16"), seed=i)
                 for i, (n, plen) in enumerate(SSM_PREFILLS)]
    for res in main_path:
        print(f"[kernel] {card}: K5 main path {json.dumps(res)}")
    head = main_path[0]
    print(f"[kernel] {card}: K5 at {head['shape']}: {head['ms']:.4f} ms "
          f"(limit {K5_MAX_MS}), {head['share_of_bound']:.3f} of its "
          f"bound, on the {head['instance']}")
    if head["ms"] > K5_MAX_MS or head["instance"] != "tensor cores":
        raise AssertionError(f"K5 at {head['shape']} takes "
                             f"{head['ms']:.4f} ms on the "
                             f"{head['instance']} (limit {K5_MAX_MS} ms "
                             f"on the tensor cores)")
    return main_path, others, cold_launches


# ---------------------------------------------------------------------------
# Phase 6: the training slice's kernels against their plain versions
# ---------------------------------------------------------------------------


def check_attention_bwd(torch, ops, ref, shape, seed=0, sk=None):
    """K4 with LSE and K4b against their plain versions at one shape, keys
    ``sk`` long (default S, the queries'); two calls give equal bits, and
    bf16 at hd 64/128 launches both on their tensor-core instances. SDPA
    forward and backward through autograd are the yardsticks. Returns
    the K4b result; its ``fwd`` is the K4-with-LSE result in the same
    keys."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_attention_bwd as kfab
    B, S, H, KV, hd, dtype, causal, q_offset = shape
    Sk = sk or S
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dt)
    k = torch.randn(B, Sk, KV, hd, generator=g, device="cuda").to(dt)
    v = torch.randn(B, Sk, KV, hd, generator=g, device="cuda").to(dt)
    do = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dt)
    kw = dict(causal=causal, q_offset=q_offset)
    tc = (kfa.launches_tc, kfab.launches_tc)
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    tol = TOL[dtype]
    fwd_err = (o.float() - o_ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    if (o.float() - o_ref.float()).abs().gt(
            tol + tol * o_ref.float().abs()).any() or \
            (lse - lse_ref).abs().gt(LSE_TOL + 1e-5 * lse_ref.abs()).any():
        raise AssertionError(f"flash forward with LSE disagrees at {shape}: "
                             f"o err {fwd_err}, lse err {lse_err}")
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    o2, lse2 = ops.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(a, b) for a, b in
                        zip(got + (o, lse), again + (o2, lse2)))
    if not deterministic:
        raise AssertionError(f"K4/K4b: two calls on one input differ in "
                             f"their bits at {shape}")
    on_tc = kfa.uses_tensor_cores(q)
    if (kfa.launches_tc - tc[0], kfab.launches_tc - tc[1]) != \
            ((2, 2) if on_tc else (0, 0)):
        raise AssertionError(f"K4/K4b instance at {shape}: tensor-core "
                             f"launches {kfa.launches_tc - tc[0]}, "
                             f"{kfab.launches_tc - tc[1]}")
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    errs, rels = [], []
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all().item():
            raise AssertionError(f"K4b {name} not finite at {shape}")
        errs.append((a - b).abs().max().item())
        rels.append(((a - b).norm() / b.norm()).item())
        if dtype == "float32":
            if (a - b).abs().gt(BWD_TOL + BWD_TOL * b.abs()).any():
                raise AssertionError(f"K4b {name} out of atol=rtol="
                                     f"{BWD_TOL} at {shape}: {errs[-1]}")
        elif rels[-1] > BWD_BF16_REL_L2:
            raise AssertionError(f"K4b {name} relative L2 {rels[-1]} > "
                                 f"{BWD_BF16_REL_L2} at {shape}")
    fwd_ms = time_ms(torch, lambda: ops.flash_attention(
        q, k, v, return_lse=True, **kw), iters=20)
    bwd_ms = time_ms(torch, lambda: ops.flash_attention_bwd(
        q, k, v, o, lse, do, **kw), iters=20)
    plain_fwd_ms = time_ms(torch, lambda: ref.flash_attention_ref(
        q, k, v, return_lse=True, **kw), iters=3, warmup=1)
    plain_ms = time_ms(torch, lambda: ref.flash_attention_bwd_ref(
        q, k, v, o, lse, do, **kw), iters=5)
    # SDPA wants (B, H, S, hd), equal head counts, and a top-left causal
    # mask: lay out outside timing, pass an explicit mask for q_offset
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2).detach() \
        .requires_grad_()
    vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2).detach() \
        .requires_grad_()
    mask = None
    if causal and q_offset:
        pos = torch.arange(S, device="cuda")
        mask = torch.arange(Sk, device="cuda")[None, :] <= \
            pos[:, None] + q_offset

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and not q_offset)
    library_fwd_ms = time_ms(torch, sdpa, iters=20)
    out = sdpa()
    dot = do.transpose(1, 2)
    library_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters=20)
    sh = {"B": B, "S": S, "Sk": Sk, "H": H, "KV": KV, "hd": hd,
          "dtype": dtype, "causal": causal, "q_offset": q_offset}
    dims = dict(B=B, Sq=S, Sk=Sk, H=H, KV=KV, hd=hd, dtype=dtype,
                causal=causal, q_offset=q_offset)
    instance = "tensor cores" if on_tc else "CUDA cores"
    # read q, k, v, write o and the LSE; QK^T and PV
    fwd_bound, fwd_by = bound("flash_attention", lse=True, **dims)
    # read q, k, v, o, dO and lse, write dq, dk, dv; five products
    bound_ms, bound_by = bound("flash_attention_bwd", **dims)
    fwd = {"shape": sh, "max_abs_err": fwd_err, "lse_max_abs_err": lse_err,
           "ms": fwd_ms, "plain_ms": plain_fwd_ms,
           "library_ms": library_fwd_ms, "bound_ms": fwd_bound,
           "bound_by": fwd_by, "share_of_bound": fwd_bound / fwd_ms,
           "x_library": fwd_ms / library_fwd_ms, "instance": instance,
           "deterministic": deterministic}
    return {"shape": sh, "fwd_lse_ms": fwd_ms, "fwd_max_abs_err": fwd_err,
            "lse_max_abs_err": lse_err,
            "max_abs_err": max(errs), "rel_l2": rels, "ms": bwd_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / bwd_ms,
            "x_library": bwd_ms / library_ms, "instance": instance,
            "deterministic": deterministic, "fwd": fwd}


def check_ps_aggregate(torch, ops, ref, nl, f, solver, seed=0, steps=3,
                       rows=None):
    """K1 against its plain version for ``steps`` rounds from one state;
    returns the largest error of params, m and v. ``rows`` (NL, F) may
    be given as a strided view (the PS receive buffer's column slice)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if rows is None:
        wide = torch.randn(nl, f + 512, generator=g, device="cuda")
        rows = wide[:, 256:256 + f]
    state = [torch.randn(f, generator=g, device="cuda"),
             0.1 * torch.randn(f, generator=g, device="cuda"),
             0.1 * torch.randn(f, generator=g, device="cuda").abs()]
    mine = [x.clone() for x in state]
    plain = state
    kw = dict(solver=solver, lr=0.01)
    for step in range(1, steps + 1):
        ops.ps_aggregate(rows, *mine, step, **kw)
        ref.ps_aggregate_ref(rows, *plain, step, **kw)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b in zip(("params", "m", "v"), mine, plain):
        errs[name] = (a - b).abs().max().item()
        tol = AGG_TOL[name]
        rtol = tol if name == "params" else 0.0
        if (a - b).abs().gt(tol + rtol * b.abs()).any():
            raise AssertionError(f"K1 {solver} ({nl}, {f}) {name} err "
                                 f"{errs[name]} > {tol}")
    return errs


def time_ps_aggregate(torch, ops, ref, nl, f):
    """K1 at the run's shard shape (adam): check once, then kernel and
    plain ms, bound and errors. No single PyTorch call computes this
    fused mean + update (library_ms null)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = torch.randn(nl, f, generator=g, device="cuda")
    errs = check_ps_aggregate(torch, ops, ref, nl, f, "adam", steps=1,
                              rows=rows)
    torch.cuda.empty_cache()
    p = torch.randn(f, generator=g, device="cuda")
    m = torch.zeros(f, device="cuda")
    v = torch.zeros(f, device="cuda")
    kw = dict(solver="adam", lr=1e-4)
    ms = time_ms(torch, lambda: ops.ps_aggregate(rows, p, m, v, 2, **kw),
                 iters=10)
    plain_ms = time_ms(torch, lambda: ref.ps_aggregate_ref(
        rows, p, m, v, 2, **kw), iters=3, warmup=1)
    # adam: read NL rows and p/m/v, write p/m/v, f32
    bound_ms, bound_by = bound("ps_aggregate", NL=nl, F=f, solver="adam")
    return {"shape": {"NL": nl, "F": f, "solver": "adam"},
            "max_abs_err": max(errs.values()), "errors": errs, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def ties(torch, n, seed):
    """x, err whose sum y holds exact ties y = (k + 0.5) * scale, with
    every block's absmax 127 * scale so that scale is exact."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    scale = 0.25
    k = torch.randint(-126, 126, (n,), generator=g, device="cuda")
    y = (k.float() + 0.5) * scale
    y[::256] = 127 * scale
    # even positions (every block's absmax among them) carry err = 0, so
    # x + err is exactly y there; odd ones exercise the feedback add
    err = 1e-3 * torch.randn(n, generator=g, device="cuda")
    err[::2] = 0.0
    return y - err, err


def check_quantize(torch, ops, ref, x, err):
    """K2 then K3 against the plain versions: (q mismatches, scale and
    err max abs errors, dequantize max abs error)."""
    q, s, ne = ops.quantize_ef(x, err)
    qr, sr, er = ref.quantize_ref(x, err)
    deq = ops.dequantize(q, s)
    deq_ref = ref.dequantize_ref(q, s)
    torch.cuda.synchronize()
    bad_q = int((q != qr).sum().item())
    s_err = (s - sr).abs().max().item()
    e_err = (ne - er).abs().max().item()
    d_err = (deq - deq_ref).abs().max().item()
    if bad_q or (s - sr).abs().gt(QUANT_TOL["scales_rtol"] * sr.abs()).any() \
            or e_err > QUANT_TOL["err_atol"] or d_err != 0.0:
        raise AssertionError(f"int8 wire at n={x.numel()}: {bad_q} q "
                             f"mismatches, scale err {s_err}, err err "
                             f"{e_err}, dequantize err {d_err}")
    return bad_q, s_err, e_err, d_err


def time_quantize(torch, ops, ref, n, x_dtype):
    """K2 and K3 at the run's push length, K2 reading ``x_dtype`` (the
    learner's gradient dtype): check, then kernel, plain and bound ms.
    No single PyTorch call computes K2 (library_ms null). For K3 one
    does: ``torch.mul`` of the int8 blocks by their scales into the f32
    output (int8 x f32 promotes to f32, one rounding); it is timed as a
    yardstick, and its difference from K3 is reported."""
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(n, generator=g, device="cuda").to(x_dtype)
    err = 0.01 * torch.randn(n, generator=g, device="cuda")
    _, s_err, e_err, d_err = check_quantize(torch, ops, ref, x, err)
    torch.cuda.empty_cache()
    q, s, _ = ops.quantize_ef(x, err)
    k2_ms = time_ms(torch, lambda: ops.quantize_ef(x, err, out_err=err),
                    iters=10)
    k2_plain = time_ms(torch, lambda: ref.quantize_ref(x, err), iters=2,
                       warmup=1)
    out = torch.empty(n, device="cuda")
    lib = torch.empty(n, device="cuda")
    qb, sb, lb = q.view(-1, 256), s[:, None], lib.view(-1, 256)
    k3_ms = time_ms(torch, lambda: ops.dequantize(q, s, out=out), iters=10)
    k3_plain = time_ms(torch, lambda: ref.dequantize_ref(q, s, out=out),
                       iters=3, warmup=1)
    k3_lib = time_ms(torch, lambda: torch.mul(qb, sb, out=lb), iters=10)
    ops.dequantize(q, s, out=out)
    lib_err = (out - lib).abs().max().item()
    k2_bound = bound("quantize_ef", F=n, x_dtype=x_dtype)  # x, err -> q,
    k3_bound = bound("dequantize", F=n)                     # err, s; q, s -> x
    return ({"shape": {"F": n, "x_dtype": str(x_dtype).split(".")[-1]},
             "max_abs_err": max(s_err, e_err),
             "ms": k2_ms, "plain_ms": k2_plain, "library_ms": None,
             "bound_ms": k2_bound[0], "bound_by": k2_bound[1]},
            {"shape": {"F": n}, "max_abs_err": d_err, "ms": k3_ms,
             "plain_ms": k3_plain, "library_ms": k3_lib,
             "library_max_abs_diff": lib_err,
             "bound_ms": k3_bound[0], "bound_by": k3_bound[1]})


# ---------------------------------------------------------------------------
# Phase 7: a training step on the card against the CPU (smoke width)
# ---------------------------------------------------------------------------


def step_card_vs_cpu(torch, ops):
    """Loss and flat gradient of one step, then one int8 + adam PS round
    with 2 learners (the same two pushes) on both devices."""
    import numpy as np
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.software_ps import SoftwareParameterServer
    from repro_torch.runtime.learner import LMPlugin
    cfg = reduce_for_smoke(get_arch("stablelm-1.6b"))
    gpu = LMPlugin({}, cfg=cfg, device="cuda")
    cpu = LMPlugin({}, cfg=cfg, device="cpu")
    flat = cpu.flat_state(0)
    rng = np.random.RandomState(9)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 2, 65)).astype("int32")
    batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
    lg, gg = gpu.flat_loss_grad(flat.cuda(), batches[0])
    grads = [cpu.flat_loss_grad(flat, b) for b in batches]
    loss_err = abs(lg.item() - grads[0][0].item())
    gc = grads[0][1]
    grad_err = (gg.cpu() - gc).abs().max().item()
    if loss_err > STEP_LOSS_TOL or (gg.cpu() - gc).abs().gt(
            STEP_GRAD_TOL + STEP_GRAD_TOL * gc.abs()).any():
        raise AssertionError(f"step on the card vs the CPU: loss err "
                             f"{loss_err}, grad err {grad_err}")

    def ps_round(dev):
        ps = SoftwareParameterServer(flat, n_shards=2, n_learners=2,
                                     optimizer="adam", lr=1e-3,
                                     compression="int8", device=dev)
        clients = [ps.make_client(i) for i in range(2)]
        for i in range(2):
            ps.join(i)
        ts = [threading.Thread(target=clients[i].push,
                               args=(grads[i][1].to(dev),))
              for i in range(2)]
        [t.start() for t in ts]
        [t.join(120) for t in ts]
        if any(t.is_alive() for t in ts) or ps.stats()["agg_rounds"] != 1:
            raise AssertionError(f"PS round on {dev} did not complete")
        return clients[0].pull().cpu()

    round_err = (ps_round("cuda") - ps_round("cpu")).abs().max().item()
    if round_err > ROUND_PARAM_TOL:
        raise AssertionError(f"int8 + adam PS round: params differ by "
                             f"{round_err} > {ROUND_PARAM_TOL}")
    return loss_err, grad_err, round_err


# ---------------------------------------------------------------------------
# Phase 8: full-width training through the learner body and the PS
# ---------------------------------------------------------------------------


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def stamped_ps():
    """A SoftwareParameterServer class that stamps the end of every round
    on the host clock. That adds no synchronise: the PS already waits
    for the round's K1 launches, through the event it times them with."""
    from repro_torch.core.software_ps import SoftwareParameterServer

    class PS(SoftwareParameterServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.round_end = []

        def _finish_round_locked(self):
            super()._finish_round_locked()
            self.round_end.append(time.perf_counter())

    return PS


def batch_loss(torch, plugin, flat, batch):
    """The loss of ``batch`` under the flat weights ``flat``: the
    plugin's forward alone, no gradient."""
    with torch.no_grad():
        tree, _ = plugin._param_leaves(flat)
        b = {k: torch.as_tensor(batch[k], dtype=torch.int64,
                                device=plugin.device)
             for k in ("tokens", "labels")}
        return float(plugin.model.loss(tree, b,
                                       xent_chunk=plugin.XENT_CHUNK))


def train_run(torch, ops, cfg, device, workdir, card, *, n_learners,
              n_shards, steps, batch_docs, seq_len, checkpoint_every, lr,
              optimizer, compression, profile=False, breakdown=0):
    """Train ``cfg`` with ``n_learners`` learner threads through the
    port's learner body and PS. Returns a dict of what the run counted
    and measured; raises on any failed check. The loop is the port's own
    (round ends stamped on the host, no added synchronise). After the
    checks, ``profile`` adds one profiled round and ``breakdown`` that
    many timed rounds on the same PS (``timed_rounds``)."""
    import numpy as np
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.core.cursor import Chunk, GlobalCursor
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.platform.metrics import MetricsService
    from repro_torch.platform.storage import LocalFSStore, StorageManager
    from repro_torch.platform.watchdog import Watchdog
    from repro_torch.platform.zookeeper import ZooKeeper
    from repro_torch.runtime.learner import (LearnerJobConfig, LMPlugin,
                                             make_learner_body)
    job = "chip-smoke-train"
    zk = ZooKeeper()
    storage = StorageManager()
    storage.register("results", LocalFSStore(str(workdir / "results")))
    metrics = MetricsService()
    base = LMPlugin({}, cfg=cfg, device=device)
    data_cfg = {"seq_len": seq_len, "n_docs": 512, "seed": 0}
    jcfg = LearnerJobConfig(
        job_id=job, data_cfg=data_cfg, n_learners=n_learners,
        batch_docs=batch_docs, steps=steps, lr=lr, optimizer=optimizer,
        solver="psgd", compression=compression, seed=0,
        checkpoint_dir=str(workdir / "ckpt"),
        checkpoint_every=checkpoint_every)
    t0 = time.perf_counter()
    ps = stamped_ps()(base.flat_state(jcfg.seed),
                                   n_shards=n_shards,
                         n_learners=n_learners, optimizer=optimizer, lr=lr,
                         trigger="bsp", compression=compression,
                         metrics=metrics, job_id=job, device=device)
    sync(torch, device)
    init_s = time.perf_counter() - t0
    cursor = GlobalCursor(zk, f"/jobs/{job}/cursor", dataset_size=512)
    results = {}
    body = make_learner_body(jcfg, ps, cursor, storage, metrics, results,
                             plugin=base)
    failed = []

    def run(idx):
        wd = Watchdog(zk, job, f"learner-{idx}")
        try:
            wd.run(lambda w: body(w, idx))
        except BaseException as e:       # handed to the main thread below
            failed.append(e)
            raise

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    threads = [threading.Thread(target=run, args=(i,), daemon=True,
                                name=f"learner-{i}")
               for i in range(n_learners)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    sync(torch, device)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    if failed:
        raise RuntimeError("a learner failed") from failed[0]
    if any(th.is_alive() for th in threads):
        raise AssertionError("learner threads did not finish")
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else None)
    st = ps.stats()
    losses = metrics.series(job, "loss").values
    if len(losses) != n_learners * steps or \
            not all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    rounds = steps
    want = {"push_count": n_learners * steps, "agg_rounds": rounds,
            "push_timeouts": 0}
    if any(st[k] != v for k, v in want.items()):
        raise AssertionError(f"PS stats {st}, want {want}")
    if compression == "int8" and st["compression_ratio"] < 3.9:
        raise AssertionError(f"compression ratio {st['compression_ratio']}")
    pushes = n_learners * steps
    want_launches = step_launches(ops, cfg, pushes, rounds, n_shards)
    if torch.device(device).type == "cpu":
        want_launches = {k: 0 for k in want_launches}
    if launches != want_launches:
        raise AssertionError(f"launches {launches}, want {want_launches}")
    tc = tensor_core_launches(cfg)
    if cfg.family == "ssm" and torch.device(device).type == "cuda" and \
            tc != {k: launches[k] for k in tc}:
        raise AssertionError(f"K5/K5b launches on the tensor cores {tc} "
                             f"of {launches}")
    # the loss over the rounds: each round's batches differ, so its mean
    # per round moves by their spread
    series = metrics.series(job, "loss")
    by_step = {}
    for st_, v in zip(series.steps, series.values):
        by_step.setdefault(st_, []).append(v)
    first, last_loss = (float(np.mean(by_step[k]))
                        for k in (min(by_step), max(by_step)))
    # ssm: the loss of a batch the run trained on (the first documents of
    # the epoch, a batch of the first round) under the initial and the
    # trained weights must fall. That shows only that the update, through
    # K5b, the int8 push and the PS, moves along that batch's gradient;
    # beside it the same for a batch no round reads (the last documents)
    eval_loss = None
    if cfg.family == "ssm":
        corpus = SyntheticCorpus(base.dataset_spec(data_cfg))
        n_docs = data_cfg["n_docs"]
        batches = {"trained-on": [Chunk(0, 0, batch_docs)],
                   "held-out": [Chunk(0, n_docs - batch_docs, n_docs)]}
        batches = {k: corpus.batch_for(v) for k, v in batches.items()}
        flats = (base.flat_state(jcfg.seed), ps.pull(0))
        eval_loss = {k: tuple(batch_loss(torch, base, f, b) for f in flats)
                     for k, b in batches.items()}
        del flats
        if not eval_loss["trained-on"][1] < eval_loss["trained-on"][0]:
            raise AssertionError(f"the loss of a batch the run trained on "
                                 f"did not fall: {eval_loss}; by round "
                                 f"{by_step}")
    # the newest checkpoint, the PS params and the uploaded model are one
    # vector, bit for bit
    probe = CheckpointManager(jcfg.checkpoint_dir)
    last = probe.latest_valid()
    if last != steps:
        raise AssertionError(f"latest valid checkpoint {last} != {steps}")
    tree, extra = probe.restore(last, {"flat": np.zeros(ps.size,
                                                        np.float32)})
    ps_flat = ps.pull(0).cpu().numpy()
    uploaded = np.load(io.BytesIO(storage.download(
        "results", job, "trained_model.npy")))
    if not (tree["flat"].tobytes() == ps_flat.tobytes()
            == uploaded.tobytes()):
        raise AssertionError("checkpoint, PS params and trained_model.npy "
                             "differ")
    del tree, ps_flat, uploaded, results
    # copies: the profiled round below adds to the PS's own lists
    agg_ms = list(metrics.series(job, "agg_time_ms").values)
    out = {"wall_s": wall, "init_s": init_s, "stats": st,
           "launches": launches, "launches_tc": tc, "losses": losses,
           "loss_first_last": (first, last_loss), "eval_loss": eval_loss,
           "peak_bytes": peak,
           "agg_ms": agg_ms,
           "sync_ms": [1e3 * s for s in
                       metrics.series(job, "sync_time_s").values],
           "round_ms": [1e3 * (b - a) for a, b in
                        zip([t0] + ps.round_end[:-1], ps.round_end)],
           "tokens": n_learners * steps * batch_docs * seq_len,
           "F": ps.size,
           "checkpoint_step": last}
    corpus = SyntheticCorpus(base.dataset_spec(data_cfg))
    if profile:
        out["profile"] = profiled_round(torch, ps, base, cursor, corpus,
                                        batch_docs, card, cfg)
    if breakdown:
        out.update(timed_rounds(torch, ps, base, cursor, corpus,
                                batch_docs, breakdown))
    del ps
    return out


def timed_rounds(torch, ps, plugin, cursor, corpus, batch_docs, rounds):
    """``rounds`` more BSP rounds after the run's checks, through the
    port's own plugin and client, with every learner's step (forward +
    backward), push (K2, receive with K3, the BSP wait, and K1 for the
    last pusher) and pull ended by a device synchronise and timed on the
    host clock: the per-phase breakdown. The synchronises are not the
    port's own, and on one card both learners' work interleaves, so a
    step's time includes the other's. Returns {step_ms, push_ms,
    pull_ms}."""
    n = ps.n_learners
    clients = [ps.make_client(i) for i in range(n)]
    for i in range(n):
        ps.join(i)
    batches = [[corpus.batch_for(cursor.next_chunk(batch_docs))
                for _ in range(n)] for _ in range(rounds)]
    out = {"step_ms": [], "push_ms": [], "pull_ms": []}
    lock = threading.Lock()
    failed = []

    def timed(key, fn):
        t0 = time.perf_counter()
        res = fn()
        sync(torch, ps.device)
        with lock:
            out[key].append(1e3 * (time.perf_counter() - t0))
        return res

    def learner(i):
        try:
            flat = clients[i].pull()
            for r in range(rounds):
                _, g = timed("step_ms", lambda: plugin.flat_loss_grad(
                    flat, batches[r][i]))
                if not timed("push_ms", lambda: clients[i].push(g)):
                    raise AssertionError(f"learner {i}: push timed out")
                del g
                flat = timed("pull_ms", clients[i].pull)
        except BaseException as e:       # handed to the main thread below
            failed.append(e)
            raise

    ts = [threading.Thread(target=learner, args=(i,), daemon=True)
          for i in range(n)]
    [t.start() for t in ts]
    [t.join(300) for t in ts]
    for i in range(n):
        ps.leave(i)
    if failed or any(t.is_alive() for t in ts):
        raise RuntimeError("timed rounds failed") from (
            failed[0] if failed else None)
    return out


def profiled_round(torch, ps, plugin, cursor, corpus, batch_docs, card,
                   cfg):
    """One more BSP round (every learner: step, push, pull) under the
    profiler, after the run's checks, through the port's own plugin and
    client (no added synchronise). Returns its wall seconds and device
    ms: busy, the PS kernels (K1, K2, K3), device-to-device copies (the
    pulls and the gradient's flat copies) and the family's kernels
    (attention K4, K4b; the SSD scan K5, K5b)."""
    from torch.profiler import ProfilerActivity
    n = ps.n_learners
    clients = [ps.make_client(i) for i in range(n)]
    for i in range(n):
        ps.join(i)
    batches = [corpus.batch_for(cursor.next_chunk(batch_docs))
               for _ in range(n)]
    flats = [c.pull() for c in clients]
    torch.cuda.synchronize()
    failed = []

    def learner(i):
        try:
            _, g = plugin.flat_loss_grad(flats[i], batches[i])
            clients[i].push(g)
            del g
            clients[i].pull()
        except BaseException as e:       # handed to the main thread below
            failed.append(e)
            raise

    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    ts = [threading.Thread(target=learner, args=(i,), daemon=True)
          for i in range(n)]
    [t.start() for t in ts]
    [t.join(300) for t in ts]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.stop()
    for i in range(n):
        ps.leave(i)
    if failed or any(t.is_alive() for t in ts):
        raise RuntimeError("profiled round failed") from (
            failed[0] if failed else None)
    prefix = family_kernels(cfg)[2]
    kernels = print_profile(prof, wall, card, top=10,
                            ours=(prefix,) + PS_KERNELS)
    check_tc_names(kernels, "profiled round",
                   family=SSD_PRODUCT_KERNELS if cfg.family == "ssm"
                   else "flash_")

    def device_ms(names):
        return sum(us for n, us in kernels.items()
                   if any(k in n for k in names)) / 1e3

    return {"wall_ms": 1e3 * wall,
            "busy_ms": sum(kernels.values()) / 1e3 if kernels else None,
            "ps_ms": device_ms(PS_KERNELS) if kernels else None,
            "dtod_ms": device_ms(("DtoD",)) if kernels else None,
            "model_ms": device_ms((prefix,)) if kernels else None,
            "model_label": ("SSD scan K5+K5b" if cfg.family == "ssm"
                            else "attention K4+K4b")}


def print_train(label, res, card, cfg, traffic):
    tag = f"[{label}] {card}:"

    def stats(xs):
        xs = sorted(xs)
        return (f"min {xs[0]:.2f} median {xs[len(xs) // 2]:.2f} max "
                f"{xs[-1]:.2f} ms (n={len(xs)})")
    print(f"{tag} {cfg.arch_id} L={cfg.n_layers} d={cfg.d_model} "
          f"{cfg.dtype}, F={res['F']} params; {traffic}")
    print(f"{tag} PS + weights init {res['init_s']:.2f} s; "
          f"{len(res['round_ms'])} rounds in {res['wall_s']:.3f} s wall "
          f"(checkpoints and upload included) = "
          f"{res['tokens'] / res['wall_s']:.1f} tokens/s; peak device "
          f"memory {res['peak_bytes'] / 2**30:.2f} GiB")
    rounds = sorted(res["round_ms"])
    per_round = res["tokens"] / len(rounds)
    print(f"{tag} round {stats(rounds)}; at the median round "
          f"{per_round / rounds[len(rounds) // 2] * 1e3:.1f} tokens/s "
          f"({per_round:.0f} tokens per round); agg (device) "
          f"{stats(res['agg_ms'])}; the learner's push + pull on the "
          f"host clock {stats(res['sync_ms'])}")
    if "step_ms" in res:
        print(f"{tag} {BREAKDOWN_ROUNDS} more rounds with a synchronise "
              f"after each: learner step "
              f"forward+backward {stats(res['step_ms'])}; push "
              f"{stats(res['push_ms'])}; pull {stats(res['pull_ms'])}")
    prof = res.get("profile")
    if prof and prof["busy_ms"] is not None:
        w, b = prof["wall_ms"], prof["busy_ms"]
        print(f"{tag} profiled round {w:.3f} ms wall: device busy "
              f"{prof['busy_ms']:.3f} ms ({prof['busy_ms'] / w:.3f}; idle "
              f"{1 - prof['busy_ms'] / w:.3f}); PS kernels K1+K2+K3 "
              f"{prof['ps_ms']:.3f} ms ({prof['ps_ms'] / w:.3f} of the "
              f"round); device-to-device copies (pulls, gradient flat) "
              f"{prof['dtod_ms']:.3f} ms ({prof['dtod_ms'] / w:.3f}); "
              f"{prof['model_label']} {prof['model_ms']:.3f} ms "
              f"({prof['model_ms'] / w:.3f}; {prof['model_ms'] / b:.3f} of "
              f"busy)")
    ev = res["eval_loss"]
    held = "" if ev is None else "; " + "; ".join(
        f"a {k} batch under the initial weights {a:.4f}, under the trained "
        f"{b:.4f}" for k, (a, b) in ev.items())
    print(f"{tag} losses {[round(x, 4) for x in res['losses']]} (mean "
          f"of the first round {res['loss_first_last'][0]:.4f}, of the "
          f"last {res['loss_first_last'][1]:.4f}{held}); PS "
          f"{json.dumps(res['stats'])}; launches "
          f"{json.dumps(res['launches'])}, on the tensor cores "
          f"{json.dumps(res['launches_tc'])}; checkpoint step "
          f"{res['checkpoint_step']} == PS params == trained_model.npy "
          f"(bit for bit)")


# ---------------------------------------------------------------------------
# Phase 9: train -> deploy -> predict through the port's platform
# ---------------------------------------------------------------------------


class ChipPlatform:
    """The port's platform on one simulated node of ``PLATFORM_GPUS``
    accounted GPUs: ZooKeeper, storage (``local``, ``objectstore`` and
    ``results`` under ``workdir``, as ``DLaaSCore`` registers them),
    metrics that stamp the end of every PS round on the host clock, a
    cluster, scheduler and Lifecycle Manager, and a ``BackendContext`` on
    the card with ``cfg``. ``drive`` is the tick loop ``DLaaSCore`` runs
    (``scheduler.tick()`` then ``lcm.monitor``)."""

    def __init__(self, workdir, cfg, tracer):
        from repro_torch.platform.cluster import (Cluster, Node, Resources,
                                                  Scheduler)
        from repro_torch.platform.lcm import LifecycleManager
        from repro_torch.platform.metrics import MetricsService
        from repro_torch.platform.storage import (LocalFSStore, ObjectStore,
                                                  StorageManager)
        from repro_torch.platform.zookeeper import ZooKeeper
        from repro_torch.runtime.backend import BackendContext

        class Metrics(MetricsService):
            # the PS records a round's agg time as the round ends: the
            # moment phase 8's PS subclass stamps
            def record(self, job_id, metric, step, value):
                if metric == "agg_time_ms":
                    self.round_end.append(time.perf_counter())
                super().record(job_id, metric, step, value)

        self.zk = ZooKeeper()
        self.storage = StorageManager()
        self.storage.register("local", LocalFSStore(f"{workdir}/local"))
        self.storage.register("objectstore",
                              ObjectStore(f"{workdir}/objectstore"))
        self.storage.register("results", LocalFSStore(f"{workdir}/results"))
        self.metrics = Metrics()
        self.metrics.round_end = []
        self.scheduler = Scheduler(Cluster([Node(
            "node-0", Resources(cpus=32.0, gpus=PLATFORM_GPUS,
                                memory_mb=96 * 1024))]))
        self.lcm = LifecycleManager(self.zk, self.scheduler)
        self.ctx = BackendContext(zk=self.zk, storage=self.storage,
                                  metrics=self.metrics, workdir=str(workdir),
                                  tracer=tracer, device="cuda", cfg=cfg)

    def plan(self, job_id, manifest, backend):
        """(backend, admitted plan), as ``DLaaSCore`` plans and admits."""
        from repro_torch.platform.lcm import JobSpec
        from repro_torch.runtime.backend import get_backend
        be = get_backend(backend)
        spec = JobSpec(job_id=job_id,
                       learners=int(manifest.get("learners", 1)))
        plan = be.plan(spec, manifest, self.ctx)
        self.scheduler.check_admission(plan.tenant, plan.total_resources())
        return be, plan

    def drive(self, job_id, until=("COMPLETED", "FAILED", "KILLED"),
              timeout=900.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            self.scheduler.tick()
            st = self.lcm.monitor(job_id)
            if st in until:
                return st
            time.sleep(0.01)
        raise AssertionError(f"{job_id} still {self.lcm.job_state(job_id)} "
                             f"after {timeout} s: "
                             f"{self.lcm.member_statuses(job_id)}")

    def restarts(self, job_id):
        return sum(t.restarts for app in self.scheduler.apps.values()
                   if app.app_id.startswith(job_id)
                   for t in app.tasks.values())


def memory_line(torch, label):
    return (f"{label} {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            f"allocated")


def estimate_alone(torch, ops, cost_fn):
    """Run one ``status.perf`` count (``cost_fn``: ``program_cost`` or an
    engine's decode cost) alone on this thread: (its analysis, seconds,
    what the card saw). It runs on the meta device, so the card's
    allocated memory, its allocation count and every launch count must
    not move."""
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    allocs0 = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    launches0 = ops.launch_counts()
    t0 = time.perf_counter()
    analysis = cost_fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    allocs1 = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    if mem1 != mem0 or allocs1 != allocs0 or \
            ops.launch_counts() != launches0:
        raise AssertionError(f"the estimate touched the card: allocated "
                             f"{mem0} -> {mem1} B, {allocs1 - allocs0} "
                             f"allocations, launches {launches0} -> "
                             f"{ops.launch_counts()}")
    return analysis, secs, (f"memory_allocated {mem0} B before and after, "
                            f"0 allocations, 0 launches")


def check_perf(snap, label, cfg=None, m=None):
    """A ``status.perf`` payload: ready, with ``0 < pct_of_attainable <=
    100`` (a measured rate above the roofline means the count left work
    out). With the manifest ``m`` of a training, its FLOPs per learner
    step within ``PERF_FLOPS_RANGE`` of ``model_flops``; returns that
    ratio."""
    from repro_torch.analysis.roofline import model_flops
    from repro_torch.configs.base import ShapeSpec
    pct = snap.get("pct_of_attainable")
    if snap.get("state") != "ready" or pct is None or not 0 < pct <= 100:
        raise AssertionError(f"{label}: status.perf {snap}")
    if m is None:
        return None
    shape = ShapeSpec(label, m["data"]["seq_len"], m["batch_docs"], "train")
    ratio = snap["flops_per_step_per_device"] / model_flops(cfg, shape)
    lo, hi = PERF_FLOPS_RANGE
    if not lo <= ratio <= hi:
        raise AssertionError(f"{label}: {ratio:.4f} of model_flops, outside "
                             f"{PERF_FLOPS_RANGE}: {snap}")
    return ratio


def platform_train(torch, ops, cfg, workdir, card, run):
    """Plan ``run``'s manifest with ``SoftwarePSBackend`` at ``cfg``,
    launch it under the LCM and scheduler, tick until it ends; check the
    deployment order, the end state, the PS and launch counts, every
    launch of a kernel with a tensor-core instance on it, and the newest
    checkpoint = the PS params = ``trained_model.npy``, bit for bit. Then
    free the PS as ``DLaaSCore`` does once a training is terminal and
    check the device memory one tick later against before the plan
    (within SERVICE_MEMORY_SLACK). Returns (what the run measured, the
    trained flat vector on the host)."""
    import numpy as np
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.analysis.perf import measured_rate_from_metrics
    from repro_torch.runtime.learner import LMPlugin
    job, m = run.job, run.manifest
    # the learner step's estimate alone, as the plan's JobPerf counts it
    estimate = estimate_alone(torch, ops, lambda: LMPlugin(
        m["framework"], cfg=cfg, device="cuda").program_cost(
            m["batch_docs"], m["data"]))
    rec = SpanRecorder()
    plat = ChipPlatform(workdir, cfg, rec)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    be, plan = plat.plan(job, m, "software-ps")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    handle = be.launch(plan, plat.lcm)
    state = plat.drive(job)
    perf_state = plan.meta["perf"].state       # when COMPLETED was seen
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    tc = tensor_core_launches(cfg)
    if state != "COMPLETED" or plat.restarts(job):
        raise AssertionError(f"{job}: {state}, {plat.restarts(job)} "
                             f"restarts: {plat.lcm.member_statuses(job)}")
    # the PS app is deployed first, then the learners (lcm.deploy)
    order = list(plat.scheduler.apps)
    if order != [f"{job}-ps", f"{job}-learners"]:
        raise AssertionError(f"deployment order {order}")
    ps = plan.meta["ps"]
    st = ps.stats()
    n, steps, shards = m["learners"], m["steps"], m["ps_shards"]
    want = {"push_count": n * steps, "agg_rounds": steps,
            "push_timeouts": 0}
    if any(st[k] != v for k, v in want.items()) or \
            st["compression_ratio"] < 3.9:
        raise AssertionError(f"PS stats {st}, want {want}")
    pushes = n * steps
    want_launches = step_launches(ops, cfg, pushes, steps, shards)
    if launches != want_launches:
        raise AssertionError(f"launches {launches}, want {want_launches}")
    if tc != {k: launches[k] for k in tc}:
        raise AssertionError(f"launches on the tensor cores {tc} of "
                             f"{launches}")
    probe = CheckpointManager(f"{workdir}/ckpt/{job}")
    last = probe.latest_valid()
    if last != steps:
        raise AssertionError(f"latest valid checkpoint {last} != {steps}")
    tree, _ = probe.restore(last, {"flat": np.zeros(ps.size, np.float32)})
    ps_flat = ps.pull(0).cpu().numpy()
    uploaded = np.load(io.BytesIO(plat.storage.download(
        "results", job, "trained_model.npy")))
    if not (tree["flat"].tobytes() == ps_flat.tobytes()
            == uploaded.tobytes()):
        raise AssertionError("checkpoint, PS params and trained_model.npy "
                             "differ")
    mirrored = plat.storage.get_store("objectstore").list(f"ckpt/{job}")
    perf = plan.meta["perf"].snapshot(
        measured_rate_from_metrics(plat.metrics, job))
    if perf_state != "ready" or perf["flops_per_step_per_device"] != \
            estimate[0]["flops_per_device"]:
        raise AssertionError(f"status.perf {perf_state} at COMPLETED, "
                             f"{perf}; alone {estimate[0]}")
    ratio = check_perf(perf, job, cfg, m)
    rounds = [1e3 * (b - a) for a, b in
              zip([t0] + plat.metrics.round_end[:-1], plat.metrics.round_end)]
    out = {"plan_s": plan_s, "wall_s": wall, "round_ms": rounds,
           "agg_ms": list(plat.metrics.series(job, "agg_time_ms").values),
           "stats": st, "launches": launches, "launches_tc": tc,
           "losses": plat.metrics.series(job, "loss").values,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "checkpoint_step": last, "mirrored": len(mirrored),
           "checkpoint_s": [end - start for name, start, end in rec.spans
                            if name == "checkpoint_publish"],
           "tokens": n * steps * m["batch_docs"] * m["data"]["seq_len"],
           "perf": perf, "perf_model_ratio": ratio,
           "estimate_s": estimate[1], "estimate_card": estimate[2]}
    # DLaaSCore's tick loop frees a terminal training's PS; one tick
    # later the card holds what it held before the plan
    del tree, ps_flat
    ps.release()
    plat.scheduler.tick()
    plat.lcm.monitor(job)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - mem_before
    out["released"] = (f"{held / 2**30:.3f} GiB more than before the plan "
                       f"one tick after COMPLETED and the PS's release "
                       f"(limit {SERVICE_MEMORY_SLACK / 2**30:.1f} GiB)")
    if held > SERVICE_MEMORY_SLACK:
        raise AssertionError(f"{job}: {out['released']}")
    # drop every reference to the training's device state: the PS (in the
    # plan, its groups' learner body and the scheduler's apps), the
    # plugin, the whole training platform
    before = memory_line(torch, "before")
    del ps, plan, handle, be, plat
    gc.collect()
    torch.cuda.empty_cache()
    out["freed"] = f"{before}, {memory_line(torch, 'after')}"
    return out, uploaded


def platform_serve(torch, ops, cfg, workdir, card, run):
    """Deploy a ``ServingBackend`` endpoint from ``run``'s training with
    ``cfg``, tick it READY, serve its requests (the endpoint paused while
    they are submitted, so its run loop admits them as the bare engine's
    does), drain it to STOPPED. Returns what it measured."""
    from repro_torch.runtime.backend import get_backend
    from repro_torch.serving.endpoint import ModelEndpoint
    ep_id, requests = run.endpoint, run.requests
    rec = SpanRecorder()
    plat = ChipPlatform(workdir, cfg, rec)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    arch = cfg.arch_id.removesuffix("-smoke")
    manifest = {"framework": {"name": "repro-lm", "arch": arch},
                "source_training": run.job, "serving": run.serving}
    be, plan = plat.plan(ep_id, manifest, "serving")
    ep = ModelEndpoint(ep_id, plan)
    ep.handle = be.launch(plan, plat.lcm)
    seen = [ep.state()]
    deadline = time.time() + 600
    while ep.state() != "READY":
        plat.scheduler.tick()
        if plat.lcm.monitor(ep_id) in ("FAILED", "KILLED", "COMPLETED"):
            raise AssertionError(f"endpoint {ep.status()}: "
                                 f"{plat.lcm.member_statuses(ep_id)}")
        if time.time() > deadline:
            raise AssertionError(f"endpoint not READY: {ep.status()}")
        time.sleep(0.01)
    t_ready = time.perf_counter()
    seen.append(ep.state())
    if seen != ["DEPLOYING", "READY"]:
        raise AssertionError(f"endpoint states {seen}")
    (_, dl0, dl1), = [s for s in rec.spans if s[0] == "weights_download"]
    eng = ep.engine
    # the decode step's estimate, started by the engine; then the same
    # count alone (the endpoint idles READY)
    poll(lambda: eng.perf.state, lambda st: st in ("ready", "error"), 120,
         "decode-step estimate")
    estimate = estimate_alone(torch, ops, eng._decode_cost(eng.params))
    if estimate[0] != eng.perf.analysis:
        raise AssertionError(f"decode-step estimate {eng.perf.analysis}; "
                             f"alone {estimate[0]}")
    get_backend("serving").pause(ep.handle)
    time.sleep(0.2)            # the run loop now waits at its pause gate
    prompts = serve_prompts(cfg, 0, requests)
    ops.reset_launch_counts()
    t0s = time.perf_counter()
    reqs = [eng.submit(p, max_new=mn)
            for p, (_, mn) in zip(prompts, requests)]
    get_backend("serving").resume(ep.handle)
    deadline = time.time() + 600
    for r in reqs:
        while not r.wait(0.5):
            if ep.state() != "READY" or time.time() > deadline:
                raise AssertionError(f"request {r.req_id} {r.status}; "
                                     f"endpoint {ep.status()}")
    wall = time.perf_counter() - t0s
    launches = ops.launch_counts()
    fwd = family_kernels(cfg)[0]
    tc = tensor_core_launches(cfg)[fwd]
    check_requests(reqs, requests, cfg)
    n_batches = eng.prefill_batches
    want = dict.fromkeys(launches, 0)
    want[fwd] = cfg.n_layers * n_batches
    if launches != want or tc != want[fwd]:
        raise AssertionError(f"endpoint launches {launches} ({tc} on the "
                             f"tensor cores), want {want}: {cfg.n_layers} "
                             f"per prefill batch, all on the tensor cores")
    stats = eng.stats()
    peak = torch.cuda.max_memory_allocated()
    perf = ep.status()["perf"]
    check_perf(perf, ep_id)
    ep.drain()
    seen = [ep.state()]
    st = plat.drive(ep_id, timeout=120)
    ep.finalize(plat.metrics)
    seen.append(ep.state())
    if st != "COMPLETED" or seen != ["DRAINING", "STOPPED"] or \
            not eng.released or eng._cache is not None:
        raise AssertionError(f"drain: job {st}, states {seen}, released "
                             f"{eng.released}, cache {eng._cache is None}")
    prefills = list(rec.prefills)
    del ep, plan, be, plat, eng
    torch.cuda.empty_cache()
    return {"ready_s": t_ready - t0, "download_s": dl1 - dl0,
            "start_s": t_ready - dl1, "wall_s": wall, "stats": stats,
            "tokens": [r.tokens for r in reqs], "prefills": prefills,
            "launches": launches, "peak_bytes": peak,
            "after_teardown": memory_line(torch, "after teardown"),
            "perf": perf, "estimate_s": estimate[1],
            "estimate_card": estimate[2]}


def print_platform(tr, sv, hand, card, cfg, run):
    job, m, ep_id, serving = run.job, run.manifest, run.endpoint, run.serving
    tag = f"[{run.label}] {card}:"

    def med(xs):
        return sorted(xs)[len(xs) // 2]
    print(f"{tag} {job}: software-ps plan of {cfg.arch_id} "
          f"L={cfg.n_layers} d={cfg.d_model} {cfg.dtype} (weights init, PS, "
          f"warm build started) {tr['plan_s']:.2f} s; launch -> COMPLETED "
          f"{tr['wall_s']:.3f} s = {tr['tokens'] / tr['wall_s']:.1f} "
          f"tokens/s; PS app deployed before the learners; checkpoint step "
          f"{tr['checkpoint_step']} == PS params == trained_model.npy (bit "
          f"for bit), {tr['mirrored']} checkpoint objects mirrored; "
          f"checkpoint publish (learner 0, inside its step) "
          f"{[round(x, 3) for x in tr['checkpoint_s']]} s")
    print(f"{tag} rounds {[round(x, 2) for x in tr['round_ms']]} ms: median "
          f"{med(tr['round_ms']):.2f} ms ({run.hand_phase}'s hand loop at "
          f"the same traffic, this run: median "
          f"{med(hand['round_ms']):.2f} ms); agg "
          f"(device) median {med(tr['agg_ms']):.2f} ms; peak device memory "
          f"{tr['peak_bytes'] / 2**30:.2f} GiB; losses "
          f"{[round(x, 4) for x in tr['losses']]}; PS "
          f"{json.dumps(tr['stats'])}; launches {json.dumps(tr['launches'])}"
          f", on the tensor cores {json.dumps(tr['launches_tc'])}")
    print(f"{tag} {tr['released']}")
    print(f"{tag} training's device state dropped: {tr['freed']}")
    print(f"{tag} status.perf of {job} (the learner step, "
          f"{cfg.arch_id} L={cfg.n_layers}, {m['batch_docs']}"
          f" x {m['data']['seq_len']} tokens; ready before "
          f"COMPLETED; FLOPs {tr['perf_model_ratio']:.4f} of model_flops; "
          f"counted alone in {tr['estimate_s']:.3f} s, "
          f"{tr['estimate_card']}):")
    print(json.dumps(tr["perf"]))
    st = sv["stats"]
    n_tok = st["tokens_out_total"]
    print(f"{tag} {ep_id}: deploy -> READY {sv['ready_s']:.3f} s "
          f"(download of trained_model.npy {sv['download_s']:.3f} s, then "
          f"start {sv['start_s']:.3f} s); DEPLOYING -> READY -> DRAINING -> "
          f"STOPPED; {st['completed_total']} requests, {n_tok} tokens in "
          f"{sv['wall_s']:.3f} s = {n_tok / sv['wall_s']:.1f} tokens/s; "
          f"prefill batches {sv['prefills']}; decode {st['decode_steps']} "
          f"steps; peak device memory {sv['peak_bytes'] / 2**30:.2f} GiB; "
          f"{sv['after_teardown']} (engine released); launches "
          f"{json.dumps(sv['launches'])}")
    print(f"{tag} status.perf of {ep_id} (one decode step of "
          f"{serving['capacity']} slots over max_seq "
          f"{serving['max_seq']}; counted alone in "
          f"{sv['estimate_s']:.3f} s, {sv['estimate_card']}):")
    print(json.dumps(sv["perf"]))


# ---------------------------------------------------------------------------
# Phases 11-12: K5b, the SSD scan backward, and the ssm learner step
# ---------------------------------------------------------------------------

SSD_GRADS = ("dx", "ddt", "da_log", "db", "dc")


def k5b_split(shape):
    """K5b's device time by kernel at one bf16 shape (B, S, H, P, G, N,
    chunk): ``scripts/ssd_kernel_split.py --bwd`` run as a child process
    on the same card (a profiler session of its own, 50 calls). Returns
    its JSON line."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "ssd_kernel_split.py"),
         "--bwd", "--label", "chip_smoke", "--shape",
         *(str(v) for v in shape)],
        capture_output=True, text=True, check=True, timeout=600).stdout
    return json.loads(out.strip().splitlines()[-1])


def check_ssd_bwd(torch, ops, ref, kssdb, shape, dstate=False, seed=0):
    """K5b against its plain version at one shape, dy (and with
    ``dstate`` the final state's gradient) N(0, 1) from the seed: every
    gradient finite and within K5B_TOL (atol = rtol) of the plain version
    run in float64 on float64 copies of the same inputs, with its
    relative L2 and the instance that ran; two calls give equal bits;
    then kernel, plain (f32, the inputs as given) and bound ms. No single
    PyTorch call computes it (library_ms null)."""
    from repro_torch.analysis.roofline import kernel_cost
    B, S, H, P, G, N, chunk, dtype = shape
    args = ssd_inputs(torch, B, S, H, P, G, N, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    dy = torch.randn(B, S, H, P, generator=g, device="cuda").to(
        args[0].dtype)
    ds = (torch.randn(B, H, P, N, generator=g, device="cuda") if dstate
          else None)
    before, before_tc = kssdb.launches, kssdb.launches_tc
    got = ops.ssd_scan_bwd(*args, dy, ds, chunk=chunk)
    again = ops.ssd_scan_bwd(*args, dy, ds, chunk=chunk)
    torch.cuda.synchronize()
    tensor_cores = kssdb.launches_tc == before_tc + 2
    if kssdb.launches != before + 2:
        raise AssertionError(f"K5b: {kssdb.launches - before} launches "
                             f"for 2 calls at {shape}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"K5b: two calls on one input differ in "
                             f"their bits at {shape}")
    want = ref.ssd_scan_bwd_ref(*(t.double() for t in args), dy.double(),
                                None if ds is None else ds.double(),
                                chunk=chunk)
    tol = K5B_TOL[dtype]
    errs, rels = {}, {}
    for name, a, b, inp in zip(SSD_GRADS, got, want, args):
        if a.dtype != inp.dtype or a.shape != inp.shape:
            raise AssertionError(f"K5b {name}: {a.dtype} {tuple(a.shape)}"
                                 f" for {inp.dtype} {tuple(inp.shape)}")
        a = a.double()
        if not torch.isfinite(a).all().item():
            raise AssertionError(f"K5b {name} not finite at {shape}")
        errs[name] = (a - b).abs().max().item()
        rels[name] = ((a - b).norm() / b.norm()).item()
        if (a - b).abs().gt(tol + tol * b.abs()).any().item():
            raise AssertionError(f"K5b {name} out of atol=rtol={tol} at "
                                 f"{shape}, dstate {dstate}: max abs err "
                                 f"{errs[name]}")
    ms = time_ms(torch, lambda: ops.ssd_scan_bwd(*args, dy, ds,
                                                 chunk=chunk), iters=10)
    plain_ms = time_ms(torch, lambda: ref.ssd_scan_bwd_ref(
        *args, dy, ds, chunk=chunk), iters=3, warmup=1)
    dims = dict(B=B, S=S, H=H, P=P, G=G, N=N, chunk=chunk, dtype=dtype)
    bound_ms, bound_by = bound("ssd_scan_bwd", dstate=dstate, **dims)
    cost = kernel_cost("ssd_scan_bwd", dstate=dstate, **dims)
    return {"shape": {**dims, "dstate": dstate},
            "instance": "tensor cores" if tensor_cores else "CUDA cores",
            "max_abs_err": max(errs.values()), "max_abs_err_by": errs,
            "rel_l2": rels, "tol": tol, "deterministic": True, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "share_of_bound": bound_ms / ms,
            "flops": cost.flops, "bytes": cost.bytes}


def layer_launches(cfg):
    """{kernel: launches} of one learner step of ``cfg``: K4 and K4b
    once per attention layer, K5 and K5b once per mamba layer."""
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_period
        return {"flash_attention": n_attn, "flash_attention_bwd": n_attn,
                "ssd_scan": cfg.n_layers - n_attn,
                "ssd_scan_bwd": cfg.n_layers - n_attn}
    fwd, bwd, _ = family_kernels(cfg)
    return {fwd: cfg.n_layers, bwd: cfg.n_layers}


def lm_step_card_vs_cpu(torch, ops, arch, seqs):
    """``LMPlugin.flat_loss_grad`` of ``arch``'s smoke reduction (f32, 2
    layers, the hybrid's one period of 8; ssm and hybrid: chunk 32) on
    the card (ssm: K5, K5b; hybrid: all four; otherwise K4, K4b) against
    the CPU (plain versions) at each of ``seqs`` positions: loss and
    flat gradient errors, each kernel launched once per layer it
    serves."""
    import numpy as np
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_arch
    from repro_torch.runtime.learner import LMPlugin
    cfg = reduce_for_smoke(get_arch(arch))
    gpu = LMPlugin({}, cfg=cfg, device="cuda")
    cpu = LMPlugin({}, cfg=cfg, device="cpu")
    flat = cpu.flat_state(0)
    out = {}
    for seq in seqs:
        toks = np.random.RandomState(seq).randint(
            0, cfg.vocab_size, size=(2, seq + 1)).astype("int32")
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        ops.reset_launch_counts()
        lg, gg = gpu.flat_loss_grad(flat.cuda(), batch)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        lc, gc = cpu.flat_loss_grad(flat, batch)
        want = dict.fromkeys(launches, 0)
        want.update(layer_launches(cfg))
        if launches != want:
            raise AssertionError(f"{arch} step launches {launches}, want "
                                 f"{want}")
        loss_err = abs(lg.item() - lc.item())
        diff = (gg.cpu() - gc).abs()
        if loss_err > STEP_LOSS_TOL or diff.gt(
                STEP_GRAD_TOL + STEP_GRAD_TOL * gc.abs()).any():
            raise AssertionError(f"{arch} step at S={seq}, card vs CPU: "
                                 f"loss err {loss_err}, grad err "
                                 f"{diff.max().item()}")
        out[seq] = (loss_err, diff.max().item())
    return cfg, out


# ---------------------------------------------------------------------------
# Phase 10: the service entry point, driven over HTTP
# ---------------------------------------------------------------------------


def manifest_yaml(m, indent=0) -> str:
    """``m`` (nested dicts of scalars) as the YAML a tenant uploads."""
    lines = []
    for key, value in m.items():
        if isinstance(value, dict):
            lines.append(f"{' ' * indent}{key}:")
            lines.append(manifest_yaml(value, indent + 2))
        else:
            lines.append(f"{' ' * indent}{key}: {value}")
    return "\n".join(lines)


def http(url, method="GET", body=None):
    """One REST call as a tenant makes it: JSON in, JSON (or bytes) out."""
    import urllib.request
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("Authorization", "Bearer chip-smoke")
    if data is not None:
        req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=900) as r:
        raw = r.read()
        json_body = r.headers.get("Content-Type", "").startswith(
            "application/json")
    return json.loads(raw) if json_body else raw


def poll(fn, done, timeout, what):
    """``fn()`` every 50 ms until ``done`` holds of it; returns it."""
    deadline = time.time() + timeout
    while True:
        out = fn()
        if done(out):
            return out
        if time.time() > deadline:
            raise AssertionError(f"{what} after {timeout} s: {out}")
        time.sleep(0.05)


def stamp_rounds(metrics):
    """Stamp the host clock where the PS records a round's agg time (the
    round's end) on a service's own ``MetricsService``, as phase 9's
    subclass does; returns the list the stamps go into."""
    stamps = []
    record = metrics.record

    def stamped(job_id, metric, step, value):
        if metric == "agg_time_ms":
            stamps.append(time.perf_counter())
        record(job_id, metric, step, value)
    metrics.record = stamped
    return stamps


def service_run(torch, cfg, workdir):
    """Phase 10: train -> deploy -> predict through the port's REST server
    on the card at ``cfg``. Returns (what it measured, the trained flat
    vector downloaded over HTTP)."""
    import numpy as np
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_attention_bwd as kfab
    from repro_torch.kernels import ops
    from repro_torch.observability.export import parse_prometheus_text
    from repro_torch.platform.cluster import Cluster, Node, Resources
    from repro_torch.service.rest import DLaaSServer
    m = PLATFORM_MANIFEST
    cluster = Cluster([Node("node-0", Resources(
        cpus=32.0, gpus=PLATFORM_GPUS, memory_mb=96 * 1024))])
    out = {}
    with DLaaSServer(str(workdir), device="cuda",
                     arch_cfgs={SERVE_ARCH: cfg}, cluster=cluster) as srv:
        core, url = srv.core, srv.url
        # the SLO engine's remediations act on timing (shed load past a
        # 2 s p99, recycle the endpoint, preempt a straggling learner),
        # which would make this run's checks depend on the host's speed;
        # alerts are still evaluated and printed
        core.health.remediate = False
        round_end = stamp_rounds(core.metrics)
        mid = http(f"{url}/v1/models", "POST",
                   {"manifest": manifest_yaml(m)})["model_id"]

        # 2. train, monitor until COMPLETED
        gc.collect()
        out["mem_before"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sub = http(f"{url}/v1/trainings", "POST", {"model_id": mid})
        tid = sub["training_id"]
        t_launched = time.perf_counter()
        st = poll(lambda: http(f"{url}/v1/trainings/{tid}"),
                  lambda s: s["status"] in ("COMPLETED", "FAILED",
                                            "KILLED"), 900, tid)
        out["train_s"] = time.perf_counter() - t0
        # status.perf in the first status that reads COMPLETED
        if st.get("perf", {}).get("state") != "ready":
            raise AssertionError(f"{tid} COMPLETED, status.perf "
                                 f"{st.get('perf')}")
        out["peak_train"] = torch.cuda.max_memory_allocated()
        restarts = sum(t.restarts for app in core.scheduler.apps.values()
                       if app.app_id.startswith(tid)
                       for t in app.tasks.values())
        if st["status"] != "COMPLETED" or restarts or \
                st["steps_done"] != m["steps"] or "data_plane" not in st:
            raise AssertionError(f"{tid}: {st}, {restarts} restarts")
        # one tick after COMPLETED, the server still up: the PS is freed
        plan = core.trainings[tid]["plan"]
        poll(lambda: plan.meta["ps"] is None, bool, 10,
             "parameter server not released")
        out["mem_completed"] = torch.cuda.memory_allocated()
        if abs(out["mem_completed"] - out["mem_before"]) > \
                SERVICE_MEMORY_SLACK:
            raise AssertionError(
                f"{out['mem_completed'] / 2**30:.2f} GiB allocated after "
                f"COMPLETED, {out['mem_before'] / 2**30:.2f} GiB before "
                f"the submit")
        st = http(f"{url}/v1/trainings/{tid}")
        dp = st["data_plane"]
        n, steps = m["learners"], m["steps"]
        if dp["push_count"] != n * steps or dp["agg_rounds"] != steps:
            raise AssertionError(f"data_plane {dp}")
        spans = {s["name"] for s in http(
            f"{url}/v1/trainings/{tid}/timeline")["spans"]}
        if not set(SERVICE_SPANS) <= spans:
            raise AssertionError(f"timeline spans {sorted(spans)} lack "
                                 f"{set(SERVICE_SPANS) - spans}")
        out["perf"] = http(f"{url}/v1/trainings/{tid}/perf")["perf"]
        out["perf_model_ratio"] = check_perf(out["perf"], tid, cfg, m)
        if out["perf"]["flops_per_step_per_device"] != \
                st["perf"]["flops_per_step_per_device"]:
            raise AssertionError(f"GET .../perf {out['perf']} against "
                                 f"status.perf {st['perf']}")
        fams = parse_prometheus_text(http(f"{url}/metrics").decode())[
            "families"]
        out.update(
            training_id=tid, status=st, metric_families=len(fams),
            train_launches=ops.launch_counts(),
            round_ms=[1e3 * (b - a) for a, b in
                      zip([t_launched] + round_end[:-1], round_end)],
            losses=list(core.metrics.series(tid, "loss").values),
            tokens=n * steps * m["batch_docs"] * m["data"]["seq_len"])

        out["ps_lag_s"] = [
            [round(v, 3) for v in core.metrics.series(
                tid, f"ps_lag_s.{slot}").values] for slot in range(n)]

        # 3. deploy the trained model, monitor until READY
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eid = http(f"{url}/v1/models", "POST",
                   {"from_training": tid, "capacity": 4,
                    "max_seq": 1024})["endpoint_id"]
        ep = poll(lambda: http(f"{url}/v1/models/{eid}"),
                  lambda s: s["state"] in ("READY", "FAILED", "STOPPED"),
                  600, eid)
        out["ready_s"] = time.perf_counter() - t0
        if ep["state"] != "READY":
            raise AssertionError(f"endpoint {ep}")
        prompts = serve_prompts(cfg, 0)

        def predict(i):
            t = time.perf_counter()
            r = http(f"{url}/v1/models/{eid}/predict", "POST",
                     {"tokens": prompts[i].tolist(),
                      "max_new": SERVE_REQUESTS[i][1]})
            return r, time.perf_counter() - t

        # 4. one request at a time
        out["alone"] = [predict(i)[0]["tokens"] for i in SERVICE_ALONE]
        # 5. all at once, one client thread each
        got = [None] * len(SERVE_REQUESTS)
        errors = []

        def client(i):
            try:
                got[i] = predict(i)
            except Exception as e:      # re-raised on the main thread
                errors.append(e)
        clients = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(SERVE_REQUESTS))]
        t0 = time.perf_counter()
        for th in clients:
            th.start()
        for th in clients:
            th.join(600)
        out["burst_s"] = time.perf_counter() - t0
        if errors or any(th.is_alive() for th in clients):
            raise AssertionError(f"concurrent predicts: {errors}")
        for (r, _), (plen, mn) in zip(got, SERVE_REQUESTS):
            if len(r["tokens"]) != mn or r["n_prompt"] != plen or \
                    not all(0 <= t < cfg.vocab_size for t in r["tokens"]):
                raise AssertionError(f"predict plen={plen}: {r}")
        out["latency_s"] = sorted(lat for _, lat in got)
        out["burst_tokens"] = sum(len(r["tokens"]) for r, _ in got)
        eng = core.endpoints[eid].engine
        out["endpoint_perf"] = http(f"{url}/v1/models/{eid}")["perf"]
        check_perf(out["endpoint_perf"], eid)
        out["prefill_batches"] = eng.prefill_batches
        out["launches"] = ops.launch_counts()
        out["launches_tc"] = {kfa.NAME: kfa.launches_tc,
                              kfab.NAME: kfab.launches_tc}
        out["peak_serve"] = torch.cuda.max_memory_allocated()

        # 6. stop: drain to STOPPED, the engine released
        http(f"{url}/v1/models/{eid}", "DELETE")
        poll(lambda: http(f"{url}/v1/models/{eid}"),
             lambda s: s["state"] == "STOPPED", 120, f"{eid} stop")
        if not eng.released or eng.params is not None:
            raise AssertionError(f"{eid} STOPPED, engine not released")
        del eng
        out["mem_stopped"] = torch.cuda.memory_allocated()
        out["alerts"] = core.alerts()["history"] + core.alerts()["active"]
        if core._tick_errors:
            raise AssertionError(f"tick-loop errors {core._tick_errors}")
        trained = np.load(io.BytesIO(http(f"{url}/v1/trainings/{tid}/model")))
    return out, trained


def check_service_launches(svc, cfg):
    """Phase 10's launches: the training's K1-K4b as phase 9's, then K4
    once per layer per prefill batch of the endpoint; every flash launch
    on the tensor cores."""
    from repro_torch.kernels import ops
    m = PLATFORM_MANIFEST
    pushes = m["learners"] * m["steps"]
    want = step_launches(ops, cfg, pushes, m["steps"], m["ps_shards"],
                         prefills=svc["prefill_batches"])
    got = svc["launches"]
    if got != want or svc["launches_tc"] != {
            k: got[k] for k in svc["launches_tc"]}:
        raise AssertionError(f"service launches {got} (on the tensor cores "
                             f"{svc['launches_tc']}), want {want}")


def serve_alone(cfg, flat, prompts, max_news):
    """A bare ``InferenceEngine`` on ``flat`` (capacity 4, max_seq 1024,
    seed 0) serving each prompt alone in turn; their tokens."""
    from repro_torch.serving.engine import InferenceEngine
    eng = InferenceEngine(cfg, capacity=4, max_seq=1024, max_queue=16,
                          seed=0, device="cuda")
    eng.start(flat)
    worker = threading.Thread(target=eng.run, name="serve-alone",
                              daemon=True)
    worker.start()
    tokens = []
    try:
        for p, mn in zip(prompts, max_news):
            r = eng.submit(p, max_new=mn)
            if not r.wait(600) or r.status != "DONE":
                raise AssertionError(f"bare engine: {r.status} {r.error}")
            tokens.append(r.tokens)
    finally:
        eng.drain()
        worker.join(60)
        eng.release()
    return tokens


def print_service(svc, ptrain, card, cfg):
    tag = f"[service] {card}:"
    gib = 2**30

    def med(xs):
        return sorted(xs)[len(xs) // 2]
    st = svc["status"]
    print(f"{tag} DLaaSServer (device cuda, {cfg.arch_id} L={cfg.n_layers} "
          f"d={cfg.d_model} {cfg.dtype}): POST /v1/trainings -> COMPLETED "
          f"{svc['train_s']:.3f} s = {svc['tokens'] / svc['train_s']:.1f} "
          f"tokens/s, no restart, {st['steps_done']} steps, last loss "
          f"{st['last_loss']:.4f}; rounds "
          f"{[round(x, 2) for x in svc['round_ms']]} ms: median "
          f"{med(svc['round_ms']):.2f} ms (phase 9 in this run: "
          f"{med(ptrain['round_ms']):.2f} ms); data_plane "
          f"{json.dumps(st['data_plane'])}; /metrics "
          f"{svc['metric_families']} families; timeline spans "
          f"{list(SERVICE_SPANS)} present")
    print(f"{tag} device memory: before the submit "
          f"{svc['mem_before'] / gib:.2f} GiB, training peak "
          f"{svc['peak_train'] / gib:.2f} GiB, one tick after COMPLETED "
          f"(PS released, server up) {svc['mem_completed'] / gib:.2f} GiB "
          f"(limit +-{SERVICE_MEMORY_SLACK / gib:.1f} GiB), serving peak "
          f"{svc['peak_serve'] / gib:.2f} GiB, after STOPPED "
          f"{svc['mem_stopped'] / gib:.2f} GiB allocated")
    lat = svc["latency_s"]
    print(f"{tag} deploy -> READY {svc['ready_s']:.3f} s; two requests "
          f"alone ({[SERVE_REQUESTS[i][0] for i in SERVICE_ALONE]} tokens "
          f"prompt); then {len(lat)} concurrent clients: "
          f"{svc['burst_tokens']} tokens in {svc['burst_s']:.3f} s = "
          f"{svc['burst_tokens'] / svc['burst_s']:.1f} tokens/s, request "
          f"latency p50 {lat[len(lat) // 2]:.3f} s, p99 "
          f"{lat[min(len(lat) - 1, int(0.99 * len(lat)))]:.3f} s (client "
          f"side, HTTP included); {svc['prefill_batches']} prefill batches;"
          f" DELETE -> STOPPED, engine released")
    print(f"{tag} GET /v1/trainings/{svc['training_id']}/perf (the learner "
          f"step; ready in the first status that read COMPLETED; FLOPs "
          f"{svc['perf_model_ratio']:.4f} of model_flops):")
    print(json.dumps(svc["perf"]))
    print(f"{tag} the endpoint's status.perf after the burst:")
    print(json.dumps(svc["endpoint_perf"]))
    throughput = [a for a in svc["alerts"] if a["name"] == "slo_throughput"]
    print(f"{tag} slo_throughput alerts (steps/s against half the "
          f"attainable rate; a diagnosis ticket, no remediation): "
          f"{json.dumps(throughput)}")
    print(f"{tag} launches {json.dumps(svc['launches'])}, on the tensor "
          f"cores {json.dumps(svc['launches_tc'])} (training alone "
          f"{json.dumps(svc['train_launches'])}); BSP arrival lag by "
          f"learner {svc['ps_lag_s']} s; alerts (remediation off) "
          f"{sorted({a['name'] for a in svc['alerts']})}")


# ---------------------------------------------------------------------------
# Phase 15: the moe family, grok-1 at full width
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def counting_drops(moe):
    """Inside the block every moe dispatch (``moe._fill_buffers``, looked
    up by ``moe_block`` at each call) appends the tokens of its dropped
    pairs (a device tensor, one entry per pair) to the list it yields."""
    seen = []
    fill = moe._fill_buffers

    def counted(x2d, expert_v, gate, token, ev, cap):
        out = fill(x2d, expert_v, gate, token, ev, cap)
        seen.append(token[out[3] == ev * cap])
        return out
    moe._fill_buffers = counted
    try:
        yield seen
    finally:
        moe._fill_buffers = fill


def moe_block_bound_ms(cfg, T, cap):
    """Least time for one ``moe_block`` on an H100: every expert's bf16
    weights read once, x read and the output written once; the three
    expert products over ``cap`` rows per expert at the bf16 peak."""
    from repro_torch.analysis.roofline import HBM_BW, peak_flops
    m = cfg.moe
    weights = 3 * m.n_experts * cfg.d_model * m.d_ff_expert
    nbytes = 2 * (weights + cfg.d_model * m.n_experts + 2 * T * cfg.d_model)
    flops = 2 * cap * weights
    t_bytes, t_ops = nbytes / HBM_BW, flops / peak_flops("bfloat16")
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_moe_block(torch, cfg, params, shape, kind, seed):
    """``moe_block`` against ``moe_ref`` on one full-width layer in bf16:
    relative L2 (limit MOE_REL_L2), the dropped pairs counted by both
    (equal; the forced-drop input must drop), the block's and the plain
    loop's ms beside the block's bound."""
    from repro_torch.models import moe
    B, S = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, S, cfg.d_model, generator=g, device="cuda")
    if kind == "drop":
        x = x[:1, :1] + 1e-3 * x
    x = x.to(torch.bfloat16)
    m = cfg.moe
    cap = moe._capacity(B * S, m.top_k, m.n_experts, m.capacity_factor)
    with torch.no_grad():
        with counting_drops(moe) as seen:
            got = moe.moe_block(x, params, cfg)
        torch.cuda.synchronize()
        want, dropped = moe.moe_ref(x, params, cfg)
        ms = time_ms(torch, lambda: moe.moe_block(x, params, cfg), iters=10)
        plain_ms = time_ms(torch, lambda: moe.moe_ref(x, params, cfg),
                           iters=3, warmup=1)
    if not torch.isfinite(got).all().item() or got.shape != x.shape:
        raise AssertionError(f"moe_block at {shape} {kind}: shape "
                             f"{tuple(got.shape)} or non-finite values")
    rel = ((got.float() - want.float()).norm()
           / want.float().norm()).item()
    block_dropped = seen[0].numel()
    if rel > MOE_REL_L2 or block_dropped != dropped or (
            kind == "drop" and not dropped):
        raise AssertionError(f"moe_block at {shape} {kind}: relative L2 "
                             f"{rel} (limit {MOE_REL_L2}), dropped pairs "
                             f"{block_dropped} (moe_ref {dropped})")
    bound_ms, bound_by = moe_block_bound_ms(cfg, B * S, cap)
    return {"shape": {"B": B, "S": S, "D": cfg.d_model,
                      "E": m.n_experts, "k": m.top_k,
                      "Fe": m.d_ff_expert, "dtype": "bfloat16"},
            "input": kind, "capacity": cap, "pairs": B * S * m.top_k,
            "dropped": dropped, "rel_l2": rel, "limit": MOE_REL_L2,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "share_of_bound": bound_ms / ms}


def wait_perf(eng, timeout=300):
    """The engine's ``status.perf`` payload (what an endpoint's
    ``status()["perf"]`` carries) once its count on the meta device is
    ready."""
    t_end = time.time() + timeout
    while eng.perf.state not in ("ready", "error"):
        if time.time() > t_end:
            raise AssertionError(f"status.perf still {eng.perf.state}")
        time.sleep(0.2)
    return eng.perf.snapshot(eng.decode_rate())


def serve_moe(torch, ops, ref, kfa, card):
    """Phase 15: the moe family on the card. a. ``moe_block`` against
    ``moe_ref`` on one grok-1 layer at full width; b. grok-1 at full width
    cut to MOE_SERVE_LAYERS layers behind ``InferenceEngine`` (cold, warm,
    profiled); c. prefill against decode at MOE_CHECK_LAYERS layers in
    f32 with no pair dropped; d. K4 at every prefill shape of the serve;
    e. the smoke-width learner step on the card against the CPU. Returns
    (K4 results at the serve's prefill shapes, the cold serve's
    launches)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import moe
    from repro_torch.models.layers import init_params
    full = get_arch(MOE_ARCH)
    m = full.moe
    print(f"[moe] {card}: {memory_line(torch, 'before phase 15:')}")

    # a. one layer at full width
    gen = torch.Generator(device="cuda").manual_seed(0)
    layer = init_params(moe.moe_param_defs(full), gen, torch.bfloat16)
    for i, (shape, kind) in enumerate(MOE_BLOCK_CASES):
        res = check_moe_block(torch, full, layer, shape, kind, seed=i)
        print(f"[moe] {card}: moe_block vs moe_ref {json.dumps(res)}")
    del layer
    torch.cuda.empty_cache()

    # b. the serve: 4 of 64 layers at full width, bf16, random weights
    cfg = dataclasses.replace(full, n_layers=MOE_SERVE_LAYERS)
    expert_bytes = cfg.n_layers * 3 * m.n_experts * cfg.d_model \
        * m.d_ff_expert * 2
    from repro_torch.analysis.roofline import HBM_BW
    runs = []
    for label in ("cold", "warm", "profiled"):
        tokens, eng, rec, launches, wall, prof = serve(
            torch, cfg, ops, 0, card, profile=label == "profiled")
        st = eng.stats()
        n_batches = eng.prefill_batches
        if launches[kfa.NAME] != cfg.n_layers * n_batches or \
                kfa.launches_tc != launches[kfa.NAME]:
            raise AssertionError(f"K4 launches {launches} ({kfa.launches_tc}"
                                 f" on the tensor cores), want "
                                 f"{cfg.n_layers} x {n_batches} prefill "
                                 f"batches, all on the tensor cores")
        if len(rec.prefills) != n_batches or n_batches < 2:
            raise AssertionError(f"prefill batches {rec.prefills}: no "
                                 f"mid-flight join")
        if runs and tokens != runs[0]:
            raise AssertionError("same seed, same requests, different "
                                 "tokens")
        n_tok = st["tokens_out_total"]
        decode_ms = 1e3 * eng.decode_seconds / st["decode_steps"]
        by_batch = ", ".join(f"{nb}x{pl} {1e3 * t:.2f}" for (nb, pl), t in
                             zip(rec.prefills, rec.prefill_s))
        print(f"[serve-moe] {card}: {label}: {MOE_ARCH} L={cfg.n_layers} "
              f"of {full.n_layers}, d={cfg.d_model}, {m.n_experts} experts "
              f"top-{m.top_k}, bf16, capacity 4, max_seq 1024: "
              f"{st['completed_total']} requests, {n_tok} tokens in "
              f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s; prefill ms by "
              f"batch (n x plen): {by_batch}; mean "
              f"{1e3 * eng.prefill_seconds / n_batches:.2f} ms per batch; "
              f"decode {st['decode_steps']} steps: {decode_ms:.2f} ms per "
              f"step (bound of the experts' weights alone "
              f"{1e3 * expert_bytes / HBM_BW:.2f} ms: "
              f"{expert_bytes / 1e9:.2f} GB at {HBM_BW / 1e12} TB/s); mean "
              f"occupancy {st['mean_batch_occupancy']}; request latency p50 "
              f"{st['p50_latency_s']} s, p99 {st['p99_latency_s']} s; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB; kernel launches {launches} ({kfa.launches_tc} K4 on "
              f"the tensor cores)")
        if label == "warm":
            snap = wait_perf(eng)
            check_perf(snap, "serve-moe")
            print(f"[serve-moe] {card}: status.perf of the engine (one "
                  f"decode step of 4 slots over max_seq 1024; bound "
                  f"{1e3 * max(snap['memory_s'], snap['compute_s']):.2f} "
                  f"ms):")
            print(json.dumps(snap))
        if prof is not None:
            check_tc_names(print_profile(prof, wall, card), "serve-moe")
        eng.release()
        runs.append(tokens)
        if label == "cold":
            cold_launches, cold_prefills = launches, rec.prefills
        del eng, prof
        torch.cuda.empty_cache()
    print(f"[serve-moe] {card}: {len(runs)} engines, same seed: identical "
          f"tokens")

    # c. prefill (kernel attention, capacity over the prompt) against
    # prefill + decode (plain decode attention, one slot per expert)
    cut = dataclasses.replace(full, n_layers=MOE_CHECK_LAYERS,
                              dtype="float32")
    L = cut.n_layers
    with counting_drops(moe) as seen:
        rel = prefill_vs_decode(torch, cut, list(range(1000, 1040)))
    dropped = [sorted(t.tolist()) for t in seen]
    print(f"[serve-moe] {card}: {MOE_ARCH} d={cut.d_model} L={L} float32: "
          f"prefill(40) vs prefill(39) + decode logits, relative L2 "
          f"{rel:.3e} (limit {PREFILL_DECODE_RTOL}); dropped pairs' tokens "
          f"by layer: prefill(40) {dropped[:L]}, prefill(39) "
          f"{dropped[L:2 * L]} (capacity 16), decode {dropped[2 * L:]} "
          f"(capacity {moe.decode_capacity(1)})")
    if len(dropped) != 3 * L or dropped[:L] != dropped[L:2 * L] or \
            any(dropped[2 * L:]):
        raise AssertionError(f"moe prefill vs decode: the last token lost "
                             f"a pair, or the prefills' drops differ: "
                             f"{dropped}")
    if rel > PREFILL_DECODE_RTOL:
        raise AssertionError(f"moe prefill vs decode logits differ by {rel}"
                             f" > {PREFILL_DECODE_RTOL}")
    gc.collect()
    torch.cuda.empty_cache()

    # d. K4 at every prefill shape of the serve: hd 128, 48 heads, GQA 6
    main_path = [check_attention(torch, ops, ref,
                                 (n, plen, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.hd, "bfloat16", True), seed=i)
                 for i, (n, plen) in enumerate(sorted(set(cold_prefills)))]
    for res in main_path:
        print(f"[kernel] {card}: K4 serve-moe path {json.dumps(res)}")

    # e. the smoke-width learner step on the card against the CPU
    mcfg_smoke, steps = lm_step_card_vs_cpu(torch, ops, MOE_ARCH,
                                            MOE_STEP_SEQS)
    for seq, (loss_err, grad_err) in steps.items():
        print(f"[moe-step] {card}: {mcfg_smoke.arch_id} f32 L="
              f"{mcfg_smoke.n_layers}, 2 x {seq} tokens, card (K4, K4b) vs "
              f"CPU: loss err {loss_err:.3e} (limit {STEP_LOSS_TOL}), flat "
              f"gradient max abs err {grad_err:.3e} (atol=rtol "
              f"{STEP_GRAD_TOL})")
    return main_path, cold_launches


# ---------------------------------------------------------------------------
# Phase 16: the hybrid family, Jamba-1.5-Large at full width
# ---------------------------------------------------------------------------


def hybrid_prefill_vs_decode(torch, cfg, n, prompts, seed=0):
    """The hybrid at ``cfg`` (random weights from ``seed``): for each of
    ``prompts`` (n + 1 tokens) in turn, the MoE drops of prefill(n + 1),
    prefill(n) and one decode step, until the (n + 1)-th token keeps its
    pairs in every MoE layer of prefill(n + 1); for that prompt, the
    relative L2 of the last-position logits of prefill(n + 1) (K4 and K5)
    against prefill(n) + decode (plain decode attention and recurrence).
    Returns (index of the prompt compared or None, its relative L2 or
    None, [per prompt tried: drops by call, each a sorted token list per
    MoE layer])."""
    from repro_torch.models import make_model
    from repro_torch.models import moe
    model = make_model(cfg, opts=NO_REMAT)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    n_moe = cfg.n_layers // 2
    tried = []
    for i, prompt in enumerate(prompts):
        toks = torch.tensor(prompt, device="cuda", dtype=torch.int64)[None]
        with torch.no_grad(), counting_drops(moe) as seen:
            full, _ = model.prefill(params, {"tokens": toks})
            cache = model.empty_cache(1, n + 1, "cuda")
            model.prefill(params, {"tokens": toks[:, :-1]}, cache=cache,
                          slots=torch.tensor([0], device="cuda"))
            step, _ = model.decode(params, cache, {"tokens": toks[:, -1:]})
        drops = [sorted(t.tolist()) for t in seen]
        if len(drops) != 3 * n_moe:
            raise AssertionError(f"{len(drops)} moe dispatches, want "
                                 f"{3 * n_moe}")
        by_call = [drops[j * n_moe:(j + 1) * n_moe] for j in range(3)]
        tried.append(by_call)
        if any(n in layer for layer in by_call[0]):
            continue                      # the last token lost a pair
        if by_call[0] != by_call[1] or any(by_call[2]):
            raise AssertionError(f"hybrid prefill vs decode: the prefills' "
                                 f"drops differ, or decode dropped: "
                                 f"{by_call}")
        a, b = full[0, -1].float(), step[0, -1].float()
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError("non-finite logits")
        if a.shape != (cfg.vocab_size,):
            raise AssertionError(f"logits shape {tuple(a.shape)}")
        return i, ((a - b).norm() / b.norm()).item(), tried
    return None, None, tried


def serve_hybrid(torch, ops, ref, kfa, kssd, card):
    """Phase 16: the hybrid family on the card. a. Jamba-1.5-Large at full
    width cut to HYBRID_CUT behind ``InferenceEngine`` (cold, warm,
    profiled); b. prefill against decode at HYBRID_CHECK_CUT in f32; c.
    K4 and K5 at every prefill shape of the serve; d. the smoke-width
    learner step on the card against the CPU. Returns (K4 results at the
    serve's prefill shapes, K5 results at them, the cold serve's
    launches)."""
    import numpy as np
    from repro_torch.analysis.roofline import HBM_BW
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import moe
    from repro_torch.weights import flat_size
    full = get_arch(HYBRID_ARCH)
    m, s = full.moe, full.ssm
    print(f"[hybrid] {card}: {memory_line(torch, 'before phase 16:')}")

    # a. the serve: one period of 4 layers at full width, bf16
    cfg = dataclasses.replace(full, **HYBRID_CUT)
    n_attn = cfg.n_layers // cfg.attn_period
    n_mamba = cfg.n_layers - n_attn
    params = flat_size(cfg)
    # a decode step reads every weight but the embedding's (one row per
    # slot): the reference's capacity buffers run all 16 experts
    step_bytes = 2 * (params - cfg.vocab_size * cfg.d_model)
    step_bound_ms = 1e3 * step_bytes / HBM_BW
    runs = []
    for label in ("cold", "warm", "profiled"):
        tokens, eng, rec, launches, wall, prof = serve(
            torch, cfg, ops, 0, card, profile=label == "profiled",
            requests=HYBRID_REQUESTS, max_seq=HYBRID_MAX_SEQ)
        st = eng.stats()
        n_batches = eng.prefill_batches
        want = {kfa.NAME: n_attn * n_batches, kssd.NAME: n_mamba * n_batches}
        got = {k: launches[k] for k in want}
        tc = {kfa.NAME: kfa.launches_tc, kssd.NAME: kssd.launches_tc}
        if got != want or tc != want:
            raise AssertionError(f"hybrid serve launches {launches}, on the "
                                 f"tensor cores {tc}; want {want} "
                                 f"({n_batches} prefill batches), all on "
                                 f"the tensor cores")
        if len(rec.prefills) != n_batches or n_batches < 2:
            raise AssertionError(f"prefill batches {rec.prefills}: no "
                                 f"mid-flight join")
        if runs and tokens != runs[0]:
            raise AssertionError("same seed, same requests, different "
                                 "tokens")
        n_tok = st["tokens_out_total"]
        decode_ms = 1e3 * eng.decode_seconds / st["decode_steps"]
        by_batch = ", ".join(f"{nb}x{pl} {1e3 * t:.2f}" for (nb, pl), t in
                             zip(rec.prefills, rec.prefill_s))
        print(f"[serve-hybrid] {card}: {label}: {HYBRID_ARCH} "
              f"attn_period {cfg.attn_period} L={cfg.n_layers} of "
              f"{full.n_layers} ({n_attn} attention, {n_mamba} mamba), "
              f"d={cfg.d_model}, {m.n_experts} experts top-{m.top_k}, "
              f"{params} parameters, bf16, capacity 4, max_seq "
              f"{HYBRID_MAX_SEQ}: {st['completed_total']} requests, {n_tok} "
              f"tokens in {wall:.3f} s = {n_tok / wall:.1f} tokens/s; "
              f"prefill ms by batch (n x plen): {by_batch}; mean "
              f"{1e3 * eng.prefill_seconds / n_batches:.2f} ms per batch; "
              f"decode {st['decode_steps']} steps: {decode_ms:.2f} ms per "
              f"step (bound of the weights a step reads "
              f"{step_bound_ms:.2f} ms: {step_bytes / 1e9:.2f} GB at "
              f"{HBM_BW / 1e12} TB/s; {step_bound_ms / decode_ms:.3f} of "
              f"it); mean occupancy {st['mean_batch_occupancy']}; request "
              f"latency p50 {st['p50_latency_s']} s, p99 "
              f"{st['p99_latency_s']} s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel "
              f"launches {launches} (on the tensor cores {tc})")
        if label == "warm":
            snap = wait_perf(eng)
            check_perf(snap, "serve-hybrid")
            print(f"[serve-hybrid] {card}: status.perf of the engine (one "
                  f"decode step of 4 slots over max_seq {HYBRID_MAX_SEQ}; "
                  f"bound "
                  f"{1e3 * max(snap['memory_s'], snap['compute_s']):.2f} "
                  f"ms):")
            print(json.dumps(snap))
        if prof is not None:
            kernels = print_profile(prof, wall, card,
                                    ours=("flash_fwd", "ssd_"))
            check_tc_names(kernels, "serve-hybrid")
            check_tc_names(kernels, "serve-hybrid", family="ssd_chunk")
            if kernels:
                busy = sum(kernels.values())
                k4 = sum(us for n, us in kernels.items() if "flash_" in n)
                k5 = sum(us for n, us in kernels.items() if "ssd_" in n)
                print(f"[serve-hybrid] {card}: profiled: device busy "
                      f"{busy / 1e6 / wall:.3f} of the wall; K4 "
                      f"{k4 / 1e3:.3f} ms = {k4 / busy:.3f} of busy; K5 "
                      f"{k5 / 1e3:.3f} ms = {k5 / busy:.3f} of busy")
        eng.release()
        runs.append(tokens)
        if label == "cold":
            cold_launches, cold_prefills = launches, rec.prefills
        del eng, prof
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[serve-hybrid] {card}: {len(runs)} engines, same seed: "
          f"identical tokens; {memory_line(torch, 'after the serve:')}")

    # b. prefill (K4, K5; capacity over the prompt) against prefill +
    # decode (plain decode attention and recurrence, one slot per expert)
    cut = dataclasses.replace(full, dtype="float32", **HYBRID_CHECK_CUT)
    n = HYBRID_CHECK_N
    prompts = [np.random.RandomState(i).randint(
        0, cut.vocab_size, size=n + 1).tolist()
        for i in range(HYBRID_CHECK_PROMPTS)]
    cap = [moe._capacity(t, m.top_k, m.n_experts, m.capacity_factor)
           for t in (n + 1, n)]
    i, rel, tried = hybrid_prefill_vs_decode(torch, cut, n, prompts)
    for j, by_call in enumerate(tried):
        print(f"[serve-hybrid] {card}: prefill vs decode, prompt {j} "
              f"(seed {j}): dropped pairs' tokens by MoE layer: "
              f"prefill({n + 1}) {by_call[0]} (capacity {cap[0]}), "
              f"prefill({n}) {by_call[1]} (capacity {cap[1]}), decode "
              f"{by_call[2]} (capacity {moe.decode_capacity(1)}); token "
              f"{n} keeps its pairs: "
              f"{not any(n in layer for layer in by_call[0])}")
    if i is None:
        raise AssertionError(f"hybrid prefill vs decode: in each of "
                             f"{len(prompts)} prompts the last token lost a "
                             f"pair")
    print(f"[serve-hybrid] {card}: {HYBRID_ARCH} d={cut.d_model} "
          f"attn_period {cut.attn_period} L={cut.n_layers} float32: "
          f"prefill({n + 1}) vs prefill({n}) + decode logits on prompt {i}, "
          f"relative L2 {rel:.3e} (limit {PREFILL_DECODE_RTOL})")
    if rel > PREFILL_DECODE_RTOL:
        raise AssertionError(f"hybrid prefill vs decode logits differ by "
                             f"{rel} > {PREFILL_DECODE_RTOL}")
    gc.collect()
    torch.cuda.empty_cache()

    # c. K4 (hd 128, 64 heads, GQA 8) and K5 (256 heads) at every prefill
    # shape of the serve
    shapes = sorted(set(cold_prefills))
    k4_main = [check_attention(torch, ops, ref,
                               (nb, plen, cfg.n_heads, cfg.n_kv_heads,
                                cfg.hd, "bfloat16", True), seed=j)
               for j, (nb, plen) in enumerate(shapes)]
    for res in k4_main:
        print(f"[kernel] {card}: K4 serve-hybrid path {json.dumps(res)}")
    heads = s.expand * cfg.d_model // s.head_dim
    k5_main = [check_ssd(torch, ops, ref, kssd,
                         (nb, plen, heads, s.head_dim, s.n_groups,
                          s.d_state, s.chunk_size, "bfloat16"), seed=j)
               for j, (nb, plen) in enumerate(shapes)]
    for res in k5_main:
        print(f"[kernel] {card}: K5 serve-hybrid path {json.dumps(res)}")
    off = [r["shape"] for r in k5_main if r["instance"] != "tensor cores"]
    if off:
        raise AssertionError(f"K5 off the tensor cores at {off}")
    torch.cuda.empty_cache()

    # d. the smoke-width learner step on the card against the CPU
    hcfg_smoke, steps = lm_step_card_vs_cpu(torch, ops, HYBRID_ARCH,
                                            HYBRID_STEP_SEQS)
    for seq, (loss_err, grad_err) in steps.items():
        print(f"[hybrid-step] {card}: {hcfg_smoke.arch_id} f32 L="
              f"{hcfg_smoke.n_layers}, 2 x {seq} tokens, card (K4, K4b, "
              f"K5, K5b) vs CPU: loss err {loss_err:.3e} (limit "
              f"{STEP_LOSS_TOL}), flat gradient max abs err "
              f"{grad_err:.3e} (atol=rtol {STEP_GRAD_TOL})")
    return k4_main, k5_main, cold_launches


# ---------------------------------------------------------------------------
# Phases 17-18: the stub-frontend families through the model-level steps
# ---------------------------------------------------------------------------


def meta_like(torch, tree):
    """``tree`` (nested dicts of tensors) as empty meta tensors."""
    from repro_torch.models.layers import map_leaves
    return map_leaves(lambda _p, t: torch.empty(t.shape, dtype=t.dtype,
                                                device="meta"), tree)


def family_train(torch, model, params, batch, n_steps, tokens, card, label,
                 stats=None):
    """``n_steps`` of ``steps.build_train_step(model,
    default_optimizer(cfg))`` on the one ``batch`` (the main path: the
    launch counts are not reset here). Each step is timed between
    synchronisations; the step's roofline is counted on the meta device
    (``count_program``) for its FLOPs and its own traffic; the share of
    attainable is against the larger of those FLOPs at peak and
    ``least_step_bytes`` at the HBM rate. Prints a line per
    step and the summary; returns the params, and with a dict ``stats``
    puts the losses, step ms, warm median ms, bound ms, share of
    attainable (%) and peak GiB in it. The optimizer state is freed
    before it returns."""
    from repro_torch.analysis.roofline import HBM_BW, count_program
    from repro_torch.distributed import steps
    from repro_torch.optim.optimizers import init_opt_state
    cfg = model.cfg
    opt = steps.default_optimizer(cfg)
    step = steps.build_train_step(model, opt)
    state = init_opt_state(opt, params)
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss.item())
        print(f"[{label}] {card}: step {i}: loss {losses[-1]:.6f}, "
              f"{ms[-1]:.2f} ms")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state
    gc.collect()
    torch.cuda.empty_cache()
    aps = model.abstract_params()
    astate = init_opt_state(opt, aps)
    count = count_program(step, aps, astate, meta_like(torch, batch))
    least = least_step_bytes(cfg, aps, astate, batch)
    bound_s = max(count["compute_s"], least / HBM_BW)
    by = "operations" if count["compute_s"] >= least / HBM_BW else "bytes"
    own_s = max(count["compute_s"], count["memory_s"])
    warm = sorted(ms[1:])[len(ms[1:]) // 2]
    pct = 100 * bound_s / (warm / 1e3)
    own_pct = 100 * own_s / (warm / 1e3)
    if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"{label}: losses {losses} do not fall on "
                             f"the batch they train on")
    print(f"[{label}] {card}: {cfg.arch_id} L={cfg.n_layers} "
          f"d={cfg.d_model} bf16, {opt.name} lr {opt.lr}, {n_steps} steps on "
          f"one batch of {tokens} tokens: losses {losses}; step ms "
          f"{[round(t, 2) for t in ms]} (warm median {warm:.2f} ms = "
          f"{tokens / (warm / 1e3):.1f} tokens/s); peak device memory "
          f"{peak:.2f} GiB; bound of the step's least work "
          f"{1e3 * bound_s:.2f} ms ({by}: {count['flops_per_device']:.4e} "
          f"FLOPs at peak, {least / 1e9:.2f} GB of weights, gradients, "
          f"optimizer state, inputs and layer inputs at {HBM_BW / 1e12} "
          f"TB/s): {pct:.2f}% of attainable; the eager step's own traffic "
          f"(meta count, {count['hbm_bytes_per_device'] / 1e9:.2f} GB) "
          f"bounds it at {1e3 * own_s:.2f} ms: {own_pct:.2f}% of that "
          f"(share of own traffic)")
    if stats is not None:
        stats.update(losses=losses, ms=ms, warm_ms=warm,
                     bound_ms=1e3 * bound_s, bound_by=by, pct=pct,
                     peak_gib=peak)
    return params


def least_step_bytes(cfg, params, state, batch):
    """Bytes a train step must move at the least: every weight read and
    written once by the update, its gradient written once and read once,
    the optimizer state read and written once, the batch read once, and
    each layer's input (B x S x d_model in the model dtype, both stacks
    of an encdec) written once in the forward and read once in the
    backward, as a step that recomputes within the layer would. The
    eager step's own traffic (transients, casts, saved activations) is
    not counted."""
    from repro_torch.models.layers import iter_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for _, t in iter_leaves(tree))
    esize = next(iter_leaves(params))[1].element_size()
    x = batch.get("enc_embeds", batch.get("embeds", batch.get("tokens")))
    rows = x.shape[0] * x.shape[1] + (batch["tokens"].numel()
                                      if "enc_embeds" in batch else 0)
    layer_in = 2 * cfg.n_layers * rows * cfg.d_model * esize
    return 4 * nbytes(params) + 2 * nbytes(state) + nbytes(batch) + layer_in


def whisper_prompt_batch(torch, cfg, B, n_frames, n_tokens, seed):
    """Frame embeddings (B, n_frames, D) from ``seed`` with numpy (the
    stubbed conv frontend's output) and random tokens (B, n_tokens + 1)
    on the card."""
    import numpy as np
    rng = np.random.RandomState(seed)
    frames = torch.from_numpy(rng.standard_normal(
        (B, n_frames, cfg.d_model)).astype(np.float32)).to("cuda")
    toks = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, size=(B, n_tokens + 1))).to("cuda")
    return frames, toks


def decode_bytes(params, cache, keys, B, cfg):
    """Bytes a decode step must read: every leaf of ``params`` under
    ``keys`` and the whole cache (each slot attends over it), plus one
    embedding row per slot."""
    from repro_torch.models.layers import iter_leaves
    n = sum(t.numel() * t.element_size() for key in keys
            for _, t in iter_leaves({key: params[key]}))
    n += sum(t.numel() * t.element_size() for k, t in cache.items()
             if k != "pos")
    return n + B * cfg.d_model * params["embed"].element_size()


def greedy_decode(torch, decode, params, cache, first_logits, n_new):
    """``n_new`` tokens, greedy, from ``first_logits``: ``n_new - 1``
    decode steps. Returns (the new tokens (B, n_new) on the host, the ms
    a step of all but the first step (timed between two
    synchronisations: the first use of each product's shape is not
    counted), the last logits)."""
    tok = first_logits.argmax(-1)
    out = [tok]
    for i in range(n_new - 1):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        logits, cache = decode(params, cache, {"tokens": tok})
        tok = logits.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (n_new - 2)
    return torch.cat(out, 1).cpu(), ms, logits


def grad_excess(got, want, scaled):
    """Over every leaf pair of two gradient trees: (elements out of the
    step limit, the largest |got - want| / (atol + STEP_GRAD_TOL |want|),
    the max abs err, the leaf of that largest ratio). atol is
    STEP_GRAD_TOL, or with ``scaled`` STEP_GRAD_TOL of the leaf's largest
    magnitude (at least 1)."""
    from repro_torch.models.layers import iter_leaves
    n_out, worst, err, where = 0, 0.0, 0.0, None
    for (path, a), (_, b) in zip(iter_leaves(got), iter_leaves(want)):
        a, b = a.cpu(), b.cpu()
        d = (a - b).abs()
        atol = STEP_GRAD_TOL * (max(1.0, b.abs().max().item()) if scaled
                                else 1.0)
        ratio = d / (atol + STEP_GRAD_TOL * b.abs())
        n_out += int(ratio.gt(1).sum().item())
        err = max(err, d.max().item())
        if ratio.max().item() > worst:
            worst, where = ratio.max().item(), path
    return n_out, worst, err, where


# faults planted in K4b's output (dq, dk, dv) for the controls of a
# scaled limit (as tests/test_torch_encdec.py's): a masking bug that
# drops the last key position's dk and dv, dv 1% small, dq 1% small
K4B_FAULTS = {
    "last-key-dropped": lambda dq, dk, dv: (
        dq, zero_last_position(dk), zero_last_position(dv)),
    "dv-1pct": lambda dq, dk, dv: (dq, dk, dv * 0.99),
    "dq-1pct": lambda dq, dk, dv: (dq * 0.99, dk, dv),
}


def zero_last_position(t):
    """``t`` (B, S, ...) with its last position zeroed, out of place."""
    t = t.clone()
    t[:, -1] = 0
    return t


def family_step_card_vs_cpu(torch, ops, arch, batch_fn, scaled=False):
    """``steps.value_and_grad`` of ``arch``'s smoke reduction (f32, hd 16:
    K4 and K4b on the CUDA cores) on the card against the CPU on one
    batch ``batch_fn(cfg, device)``. Each leaf is held at STEP_GRAD_TOL
    (``grad_excess``; with ``scaled``, atol of the leaf's largest
    magnitude). With ``scaled`` the limit's controls run too: the card
    step again with each of ``K4B_FAULTS`` planted in K4b's output, each
    of which must fail the limit. Returns (cfg, loss err, max gradient
    err over every leaf, its largest ratio to the limit, the launches on
    the card, {fault: (elements out, largest ratio)})."""
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed import steps
    from repro_torch.models import make_model
    from repro_torch.models.layers import map_leaves
    cfg = reduce_for_smoke(get_arch(arch))
    model = make_model(cfg, opts=NO_REMAT)
    params = model.init(torch.Generator().manual_seed(0))
    gparams = map_leaves(lambda _p, t: t.cuda(), params)
    ops.reset_launch_counts()
    lg, gg = steps.value_and_grad(model, gparams, batch_fn(cfg, "cuda"))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    lc, gc_ = steps.value_and_grad(model, params, batch_fn(cfg, "cpu"))
    loss_err = abs(lg.item() - lc.item())
    n_out, worst, grad_err, where = grad_excess(gg, gc_, scaled)
    if n_out:
        raise AssertionError(f"{arch} smoke step, card vs CPU: {n_out} "
                             f"gradient elements out of the limit, worst "
                             f"{where} at {worst:.3f}x it")
    if loss_err > STEP_LOSS_TOL:
        raise AssertionError(f"{arch} smoke step, card vs CPU: loss err "
                             f"{loss_err}")
    controls = {}
    bwd = ops.flash_attention_bwd
    for name, fault in (K4B_FAULTS.items() if scaled else ()):
        ops.flash_attention_bwd = lambda *a, f=fault, **k: f(*bwd(*a, **k))
        try:
            _, gf = steps.value_and_grad(model, gparams,
                                         batch_fn(cfg, "cuda"))
        finally:
            ops.flash_attention_bwd = bwd
        controls[name] = grad_excess(gf, gc_, scaled)[:2]
        if not controls[name][0]:
            raise AssertionError(f"{arch} smoke step: the control with "
                                 f"K4b's {name} passes the limit")
    return cfg, loss_err, grad_err, worst, launches, controls


def rel_l2(torch, a, b):
    a, b = a.float(), b.float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite logits")
    return ((a - b).norm() / b.norm()).item()


def train_encdec(torch, ops, ref, kfa, kfab, card):
    """Phase 17: whisper-large-v3 at full width and depth on the card
    through ``distributed/steps.py``. a. ENCDEC_STEPS AdamW steps on one
    batch of ENCDEC_BATCH x (ENCDEC_FRAMES frames + ENCDEC_TOKENS
    tokens); b. prefill of the frames and an ENCDEC_PROMPT-token prompt
    into caches padded to ENCDEC_TOKENS, then greedy decode to
    ENCDEC_NEW tokens; c. prefill against decode at
    FAMILY_CHECK_LAYERS layers in f32; d. K4 and K4b at the three
    attention shapes, and K4 at the prefill's three; e. the smoke-width
    step on the card against the CPU, with its controls. Returns (K4
    results, K4b results, the main path's launches)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed import steps
    from repro_torch.models import make_model
    from repro_torch.weights import flat_size
    cfg = get_arch(ENCDEC_ARCH)
    L, B = cfg.n_layers, ENCDEC_BATCH
    print(f"[encdec] {card}: {memory_line(torch, 'before phase 17:')}")
    model = make_model(cfg, opts=NO_REMAT)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    frames, toks = whisper_prompt_batch(torch, cfg, B, ENCDEC_FRAMES,
                                        ENCDEC_TOKENS, 0)
    batch = {"enc_embeds": frames, "tokens": toks[:, :-1],
             "labels": toks[:, 1:]}

    # a. training (the main path starts here)
    ops.reset_launch_counts()
    tc0 = (kfa.launches_tc, kfab.launches_tc)
    params = family_train(torch, model, params, batch, ENCDEC_STEPS,
                          B * (ENCDEC_FRAMES + ENCDEC_TOKENS), card,
                          "train-whisper")

    # b. serving: prefill into a cache whose self K/V hold the decoder's
    # context, then greedy decode
    prompt = torch.tensor([ENCDEC_PROMPT_IDS] * B, device="cuda")
    prefill = steps.build_prefill_step(model)
    decode = steps.build_decode_step(model)
    cache = model.empty_cache(B, ENCDEC_TOKENS, "cuda", S_enc=ENCDEC_FRAMES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"enc_embeds": frames, "tokens": prompt},
                            cache=cache, slots=torch.arange(B, device="cuda"))
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    first = logits
    new, decode_ms, last = greedy_decode(torch, decode, params, cache,
                                         first, ENCDEC_NEW)
    launches = ops.launch_counts()
    tc = (kfa.launches_tc - tc0[0], kfab.launches_tc - tc0[1])
    want = {kfa.NAME: 3 * L * (ENCDEC_STEPS + 1),
            kfab.NAME: 3 * L * ENCDEC_STEPS}
    got = {k: launches[k] for k in want}
    if got != want or tc != tuple(want.values()):
        raise AssertionError(f"whisper launches {launches}, on the tensor "
                             f"cores {tc}; want {want}, all on them")
    if not torch.isfinite(last).all() or last.shape != (B, 1,
                                                         cfg.vocab_size):
        raise AssertionError(f"decode logits {tuple(last.shape)}, finite "
                             f"{torch.isfinite(last).all().item()}")
    if cache["pos"].tolist() != [len(ENCDEC_PROMPT_IDS) + ENCDEC_NEW - 1] * B:
        raise AssertionError(f"decode positions {cache['pos'].tolist()}")
    nbytes = decode_bytes(params, cache, ("dec_blocks", "final_norm",
                                          "head"), B, cfg)
    from repro_torch.analysis.roofline import HBM_BW
    bound_ms = 1e3 * nbytes / HBM_BW
    print(f"[serve-whisper] {card}: {ENCDEC_ARCH} L={L}+{L} d={cfg.d_model} "
          f"{flat_size(cfg)} parameters, bf16, B={B}: prefill of "
          f"{ENCDEC_FRAMES} frames + {len(ENCDEC_PROMPT_IDS)} tokens "
          f"{prefill_ms:.2f} ms; greedy decode to {ENCDEC_NEW} tokens on "
          f"caches padded to {ENCDEC_TOKENS}: {decode_ms:.3f} ms a warm step "
          f"(bound of the bytes a step reads {bound_ms:.3f} ms: "
          f"{nbytes / 1e9:.3f} GB at {HBM_BW / 1e12} TB/s; "
          f"{bound_ms / decode_ms:.3f} of it); first tokens "
          f"{new[:, :8].tolist()}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; main-path "
          f"launches {got} (on the tensor cores {tc})")
    del params, cache, batch, frames, logits, first, last
    gc.collect()
    torch.cuda.empty_cache()

    # c. prefill (K4 on the prompt) against prefill + decode (plain
    # decode attention), full width, 2 layers, f32
    cut = dataclasses.replace(cfg, n_layers=FAMILY_CHECK_LAYERS,
                              dtype="float32")
    cm = make_model(cut, opts=NO_REMAT)
    cp = cm.init(torch.Generator(device="cuda").manual_seed(1))
    frames, toks = whisper_prompt_batch(torch, cut, 1, ENCDEC_FRAMES,
                                        FAMILY_CHECK_N, 1)
    with torch.no_grad():
        full, _ = cm.prefill(cp, {"enc_embeds": frames, "tokens": toks})
        c = cm.empty_cache(1, FAMILY_CHECK_N + 1, "cuda",
                           S_enc=ENCDEC_FRAMES)
        cm.prefill(cp, {"enc_embeds": frames, "tokens": toks[:, :-1]},
                   cache=c, slots=torch.tensor([0], device="cuda"))
        stepped, _ = cm.decode(cp, c, {"tokens": toks[:, -1:]})
    rel = rel_l2(torch, stepped, full)
    print(f"[serve-whisper] {card}: {ENCDEC_ARCH} d={cut.d_model} "
          f"L={cut.n_layers}+{cut.n_layers} float32: prefill("
          f"{FAMILY_CHECK_N + 1}) vs prefill({FAMILY_CHECK_N}) + decode "
          f"logits, relative L2 {rel:.3e} (limit {PREFILL_DECODE_RTOL})")
    if rel > PREFILL_DECODE_RTOL:
        raise AssertionError(f"whisper prefill vs decode logits differ by "
                             f"{rel} > {PREFILL_DECODE_RTOL}")
    del cp, c, frames
    gc.collect()
    torch.cuda.empty_cache()

    # d. K4 and K4b at the three attention shapes of the train step
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    k4, k4b = [], []
    for j, (sq, sk, causal) in enumerate([
            (ENCDEC_FRAMES, ENCDEC_FRAMES, False),
            (ENCDEC_TOKENS, ENCDEC_TOKENS, True),
            (ENCDEC_TOKENS, ENCDEC_FRAMES, False)]):
        r = check_attention_bwd(torch, ops, ref, (B, sq, H, KV, hd,
                                                  "bfloat16", causal, 0),
                                seed=j, sk=sk)
        k4.append(r["fwd"])
        k4b.append(r)
        print(f"[kernel] {card}: K4 with LSE and K4b train-whisper path "
              f"{json.dumps(r)}")
        torch.cuda.empty_cache()
    # K4 without its LSE at the prefill's shapes: the encoder over the
    # frames, and the prompt's decoder self (causal) and cross attention
    P = len(ENCDEC_PROMPT_IDS)
    for j, (sq, sk, causal) in enumerate([
            (ENCDEC_FRAMES, ENCDEC_FRAMES, False), (P, P, True),
            (P, ENCDEC_FRAMES, False)]):
        r = check_attention(torch, ops, ref, (B, sq, H, KV, hd, "bfloat16",
                                              causal), seed=3 + j, sk=sk)
        k4.append(r)
        print(f"[kernel] {card}: K4 serve-whisper prefill path "
              f"{json.dumps(r)}")

    # e. the smoke-width step on the card against the CPU. The whisper
    # smoke model's f32 gradients are ill-conditioned: its encoder logits
    # have std ~20 (the reference's fan-in rule draws wq/wk at std
    # 1/sqrt(heads)), and on the CPU alone they lie up to 1.1e-2 x (1 +
    # |g|) from a float64 run of the same step (encoder ln1 bias), where
    # stablelm's lie 2.1e-4 (tests/test_torch_encdec.py). So each leaf's
    # atol is STEP_GRAD_TOL of its largest magnitude, and the planted
    # faults of K4B_FAULTS must each fail that limit
    scfg, loss_err, grad_err, worst, sl, controls = family_step_card_vs_cpu(
        torch, ops, ENCDEC_ARCH, lambda c, d: encdec_smoke_batch(torch, c, d),
        scaled=True)
    if (sl[kfa.NAME], sl[kfab.NAME]) != (3 * scfg.n_layers,) * 2:
        raise AssertionError(f"whisper smoke step launches {sl}")
    print(f"[encdec-step] {card}: {scfg.arch_id} f32 L={scfg.n_layers}+"
          f"{scfg.n_layers}, card (K4, K4b) vs CPU: loss err {loss_err:.3e} "
          f"(limit {STEP_LOSS_TOL}), gradient max abs err {grad_err:.3e} "
          f"(rtol {STEP_GRAD_TOL}, atol {STEP_GRAD_TOL} of each leaf's "
          f"largest magnitude) over every leaf, at most {worst:.3f} of the "
          f"limit; controls, K4b with a planted fault against the same "
          f"limit (elements out, largest ratio): {json.dumps(controls)}")
    return k4, k4b, launches


def encdec_smoke_batch(torch, cfg, device):
    import numpy as np
    rng = np.random.RandomState(7)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(2, 41)))
    frames = torch.from_numpy(rng.standard_normal(
        (2, 60, cfg.d_model)).astype(np.float32))
    return {"enc_embeds": frames.to(device), "tokens": toks[:, :-1].to(device),
            "labels": toks[:, 1:].to(device)}


def vision_positions(torch, B, S, grid, text_at_index=False):
    """M-RoPE positions (3, B, S) of one image of ``grid`` x ``grid``
    merged patches at the start of each sequence: (0, row, column); the
    text after it from max + 1 in all three sections (Qwen2-VL's rule,
    arXiv:2409.12191 §2.1), or, with ``text_at_index``, at its own index
    (where the reference's decode puts the next token: the cache
    position in all three sections)."""
    n = grid * grid
    img = torch.stack([torch.zeros(n), torch.arange(n) // grid,
                       torch.arange(n) % grid]).long()
    text = torch.arange(n, S) if text_at_index else \
        torch.arange(S - n) + grid
    pos = torch.cat([img, text.expand(3, -1)], 1)
    return pos[:, None].expand(3, B, S).contiguous().to("cuda")


def vlm_batch(torch, cfg, B, S, seed, grid=None, text_at_index=False):
    """Embeddings (B, S, D) and labels from ``seed`` with numpy, and the
    positions of one image of ``grid`` (default VLM_GRID) squared merged
    patches per sequence, on the card."""
    import numpy as np
    rng = np.random.RandomState(seed)
    emb = torch.from_numpy(rng.standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)).to("cuda")
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          size=(B, S))).to("cuda")
    return {"embeds": emb,
            "positions": vision_positions(torch, B, S, grid or VLM_GRID,
                                          text_at_index),
            "labels": labels}


def train_vlm(torch, ops, ref, kfa, kfab, card, keep=None):
    """Phase 18: qwen2-vl-2b fed with ``embeds`` at full width and depth
    through ``distributed/steps.py``. a. VLM_STEPS AdamW steps on one
    batch of VLM_BATCH x VLM_SEQ positions (one image of VLM_GRID^2
    merged patches per sequence, M-RoPE positions); b. prefill of that
    batch into a cache with room for VLM_NEW more, then greedy decode
    of tokens; c. prefill against decode (embeds) at
    FAMILY_CHECK_LAYERS layers in f32; d. K4 and K4b at the model's
    shape, and K4 at the prefill's; e. the smoke-width step on the card
    against the CPU. Returns
    (K4 results, K4b results, the main path's launches); with a dict
    ``keep``, the trained weights go into ``keep["params"]`` (phase 20's
    zero3_sp step) instead of being freed."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed import steps
    from repro_torch.models import make_model
    from repro_torch.weights import flat_size
    cfg = get_arch(VLM_ARCH)
    L, B, S = cfg.n_layers, VLM_BATCH, VLM_SEQ
    print(f"[vlm] {card}: {memory_line(torch, 'before phase 18:')}")
    model = make_model(cfg, opts=NO_REMAT)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = vlm_batch(torch, cfg, B, S, 0)

    # a. training (the main path starts here)
    ops.reset_launch_counts()
    tc0 = (kfa.launches_tc, kfab.launches_tc)
    params = family_train(torch, model, params, batch, VLM_STEPS, B * S,
                          card, "train-qwen2-vl")

    # b. serving: prefill with embeds and positions, then greedy decode
    decode = steps.build_decode_step(model)
    cache = model.empty_cache(B, S + VLM_NEW, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"embeds": batch["embeds"],
                     "positions": batch["positions"]},
            cache=cache, slots=torch.arange(B, device="cuda"))
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    new, decode_ms, last = greedy_decode(torch, decode, params, cache,
                                         logits, VLM_NEW)
    launches = ops.launch_counts()
    tc = (kfa.launches_tc - tc0[0], kfab.launches_tc - tc0[1])
    want = {kfa.NAME: L * (VLM_STEPS + 1), kfab.NAME: L * VLM_STEPS}
    got = {k: launches[k] for k in want}
    if got != want or tc != tuple(want.values()):
        raise AssertionError(f"qwen2-vl launches {launches}, on the tensor "
                             f"cores {tc}; want {want}, all on them")
    if not torch.isfinite(last).all() or cache["pos"].tolist() != \
            [S + VLM_NEW - 1] * B:
        raise AssertionError(f"decode: finite {torch.isfinite(last).all()},"
                             f" positions {cache['pos'].tolist()}")
    from repro_torch.analysis.roofline import HBM_BW
    nbytes = decode_bytes(params, cache, ("blocks", "final_norm", "head"),
                          B, cfg)
    bound_ms = 1e3 * nbytes / HBM_BW
    print(f"[serve-qwen2-vl] {card}: {VLM_ARCH} L={L} d={cfg.d_model} "
          f"{flat_size(cfg)} parameters, bf16, B={B}: prefill of {S} "
          f"positions (embeds, M-RoPE) {prefill_ms:.2f} ms; greedy decode "
          f"to {VLM_NEW} tokens: {decode_ms:.3f} ms a warm step (bound of the "
          f"bytes a step reads {bound_ms:.3f} ms: {nbytes / 1e9:.3f} GB; "
          f"{bound_ms / decode_ms:.3f} of it); first tokens "
          f"{new[:, :8].tolist()}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; main-path "
          f"launches {got} (on the tensor cores {tc})")
    if keep is not None:
        keep["params"] = params
    del params, cache, batch, logits, last
    gc.collect()
    torch.cuda.empty_cache()

    # c. prefill of n + 1 embeds (K4) against n and one decode step of
    # the last embedding (plain decode attention), 2 layers, f32; text
    # positions at their index, where decode puts them
    cut = dataclasses.replace(cfg, n_layers=FAMILY_CHECK_LAYERS,
                              dtype="float32")
    cm = make_model(cut, opts=NO_REMAT)
    cp = cm.init(torch.Generator(device="cuda").manual_seed(1))
    n = FAMILY_CHECK_N + VLM_GRID * VLM_GRID
    b = vlm_batch(torch, cut, 1, n + 1, 1, text_at_index=True)
    with torch.no_grad():
        full, _ = cm.prefill(cp, {"embeds": b["embeds"],
                                  "positions": b["positions"]})
        c = cm.empty_cache(1, n + 1, "cuda")
        cm.prefill(cp, {"embeds": b["embeds"][:, :-1],
                        "positions": b["positions"][:, :, :-1]},
                   cache=c, slots=torch.tensor([0], device="cuda"))
        stepped, _ = cm.decode(cp, c, {"embeds": b["embeds"][:, -1:]})
    rel = rel_l2(torch, stepped, full)
    print(f"[serve-qwen2-vl] {card}: {VLM_ARCH} d={cut.d_model} "
          f"L={cut.n_layers} float32: prefill({n + 1} embeds, an image of "
          f"{VLM_GRID}x{VLM_GRID}) vs prefill({n}) + decode logits, "
          f"relative L2 {rel:.3e} (limit {PREFILL_DECODE_RTOL})")
    if rel > PREFILL_DECODE_RTOL:
        raise AssertionError(f"qwen2-vl prefill vs decode logits differ "
                             f"by {rel} > {PREFILL_DECODE_RTOL}")
    del cp, c, b
    gc.collect()
    torch.cuda.empty_cache()

    # d. K4 and K4b at the model's shape (hd 128, GQA 6, causal)
    bw = check_attention_bwd(torch, ops, ref, (B, S, cfg.n_heads,
                                               cfg.n_kv_heads, cfg.hd,
                                               "bfloat16", True, 0))
    print(f"[kernel] {card}: K4 with LSE and K4b train-qwen2-vl path "
          f"{json.dumps(bw)}")
    # K4 without its LSE at the prefill's shape
    fw = check_attention(torch, ops, ref, (B, S, cfg.n_heads, cfg.n_kv_heads,
                                           cfg.hd, "bfloat16", True), seed=1)
    print(f"[kernel] {card}: K4 serve-qwen2-vl prefill path "
          f"{json.dumps(fw)}")
    torch.cuda.empty_cache()

    # e. the smoke-width step on the card against the CPU
    def smoke_batch(c, device):
        return {k: v.to(device)
                for k, v in vlm_batch(torch, c, 2, 40, 7, grid=4).items()}
    scfg, loss_err, grad_err, _, sl, _ = family_step_card_vs_cpu(
        torch, ops, VLM_ARCH, smoke_batch)
    if (sl[kfa.NAME], sl[kfab.NAME]) != (scfg.n_layers,) * 2:
        raise AssertionError(f"qwen2-vl smoke step launches {sl}")
    print(f"[vlm-step] {card}: {scfg.arch_id} f32 L={scfg.n_layers}, "
          f"embeds and M-RoPE positions, card (K4, K4b) vs CPU: loss err "
          f"{loss_err:.3e} (limit {STEP_LOSS_TOL}), gradient max abs err "
          f"{grad_err:.3e} (atol=rtol {STEP_GRAD_TOL}) over every leaf")
    return [bw["fwd"], fw], [bw], launches


class MemoryStore:
    """A ``platform.storage`` store held in host memory (phase 19's
    object store and results store: see ``PJIT_MANIFEST``)."""

    def __init__(self):
        self.blobs = {}

    def put(self, container, name, data):
        self.blobs[(container, name)] = bytes(data)

    def get(self, container, name):
        from repro_torch.platform.storage import StorageError
        if (container, name) not in self.blobs:
            raise StorageError(f"{container}/{name} not found")
        return self.blobs[(container, name)]

    def list(self, container):
        return sorted(n for c, n in self.blobs if c == container)

    def delete(self, container, name):
        self.blobs.pop((container, name), None)

    def exists(self, container, name):
        return (container, name) in self.blobs


def tick_until(plat, job, cond, what, timeout=600.0):
    """Tick ``plat`` (scheduler, then ``lcm.monitor``) until ``cond()``."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        plat.scheduler.tick()
        plat.lcm.monitor(job)
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"{job}: {what} not reached in {timeout} s: "
                         f"{plat.lcm.member_statuses(job)}")


def member_log(plat, job, member="worker-0"):
    base = f"/dlaas/jobs/{job}/members/{member}/log"
    return [plat.zk.get(f"{base}/{c}")[0].decode()
            for c in plat.zk.children(base)]


def resumed_batches(torch, plat, job, cfg, n):
    """The ``n`` batches the job took last, as its leader drew them: the
    cursor never moves back, so they are the ``n`` chunks that end at
    its final position."""
    import numpy as np
    from repro_torch.core.cursor import GlobalCursor
    from repro_torch.data.pipeline import DatasetSpec, SyntheticCorpus
    from repro_torch.platform.zookeeper import ZooKeeper
    m = PJIT_MANIFEST
    docs, bd = m["data"]["n_docs"], m["batch_docs"]
    epoch, offset = GlobalCursor(plat.zk, f"/dlaas/jobs/{job}/cursor",
                                 dataset_size=docs).position()
    cur = GlobalCursor(ZooKeeper(), "/replay", dataset_size=docs)
    cur.restore(*divmod(epoch * docs + offset - n * bd, docs))
    corpus = SyntheticCorpus(DatasetSpec(
        n_docs=docs, seq_len=m["data"]["seq_len"],
        vocab_size=cfg.vocab_size, seed=0))
    out = []
    for _ in range(n):
        b = corpus.batch_for(cur.next_chunk(bd))
        out.append({k: torch.as_tensor(np.asarray(b[k]),
                                       dtype=torch.int64).cuda()
                    for k in ("tokens", "labels")})
    return out


def pjit_platform(torch, ops, kfa, kfab, cfg, workdir, card):
    """19 a: ``PJIT_MANIFEST`` planned by ``PjitBackend`` at ``cfg`` on the
    card, launched under the LCM and scheduler; paused at a step boundary
    once ``PJIT_PAUSE_AFTER`` steps are done (before step 8), preempted
    once the step-4 checkpoint is published, and once its leader has
    yielded, moved with
    ``resume(new_dist=Dist(mesh=MeshShape(data=1, model=1)))``:
    re-placed, its steps run in one rank process on the card (NCCL), which
    logs the restore, ticked to COMPLETED. Checks: every step done, the
    last pass's mean loss below the first's, K4 and K4b launched
    ``n_layers`` times per step taken (the steps redone after the resume
    included; this process's counts and the rank's), the losses after the
    resume within ``MODEL_TOL`` of a mesh-less ``Trainer`` restored here
    from the step-4 checkpoint on the same batches, the newest checkpoint
    restored by a fresh mesh-less ``Trainer`` at its step with params
    equal to ``trained_model.npy``, and ``status.perf`` ready with its
    collective term 0. Then two warm steps of that trainer under the
    profiler. Returns what it measured."""
    import numpy as np
    from repro_torch.analysis.perf import measured_rate_from_metrics
    from repro_torch.distributed.sharding import Dist
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.weights import flat_from_params
    m, job = PJIT_MANIFEST, PJIT_JOB
    B, S = m["batch_docs"], m["data"]["seq_len"]
    ckdir = Path(workdir) / "ckpt" / job
    plat = ChipPlatform(workdir, cfg, SpanRecorder())
    for store in ("objectstore", "results"):
        plat.storage.register(store, MemoryStore())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    be, plan = plat.plan(job, m, "pjit")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    handle = be.launch(plan, plat.lcm)

    def done():
        return len(plat.metrics.series(job, "loss").values)
    ck4 = ckdir / f"step_{m['checkpoint_every']:010d}" / "manifest.json"
    # paused before step 8, so the step-4 checkpoint is the newest
    tick_until(plat, job, lambda: done() >= PJIT_PAUSE_AFTER,
               "the pause point")
    be.pause(handle)
    tick_until(plat, job, ck4.exists, "the step-4 checkpoint")
    paused_at = done()
    for app_id in plat.lcm._app_ids(job):
        plat.scheduler.preempt_app(app_id)
    # no tick until the leader has yielded: nothing is placed again before
    # the resume names the mesh
    deadline = time.time() + 600
    while not any(line.startswith("preempted")
                  for line in member_log(plat, job)):
        if time.time() > deadline:
            raise AssertionError(f"{job}: the leader never yielded")
        time.sleep(0.01)
    gc.collect()
    torch.cuda.empty_cache()
    be.resume(handle, new_dist=Dist(mesh=MeshShape(data=1, model=1)))
    # a failed rank restarts the gang (up to the LCM's restarts), which
    # would only show at the drive's deadline: fail on its first error
    tick_until(plat, job, lambda: plat.lcm.monitor(job) == "COMPLETED"
               or any(line.startswith("infra error")
                      for line in member_log(plat, job)),
               "the end of the job")
    state = plat.lcm.monitor(job)
    failed = [line for line in member_log(plat, job)
              if line.startswith("infra error")]
    if failed:
        raise AssertionError(f"{job}: {failed[0]}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spmd = plan.results.get("spmd", [])
    launches = ops.launch_counts()
    here = dict(launches)
    for inc in spmd:
        for k, v in (inc["launches"] or {}).items():
            launches[k] += v
    peak = torch.cuda.max_memory_allocated()
    logs = member_log(plat, job)
    series = plat.metrics.series(job, "loss")
    by_step = dict(zip(series.steps, series.values))   # the last of each
    n_calls = len(series.values)
    if state != "COMPLETED" or sorted(by_step) != list(range(m["steps"])):
        raise AssertionError(f"{job}: {state}, steps {series.steps}")
    resumed = [line for line in logs if "resumed from checkpoint" in line]
    if resumed != [f"resumed from checkpoint step={m['checkpoint_every']}"]:
        raise AssertionError(f"{job}: restores {resumed}")
    if [(inc["ranks"], inc["axes"]) for inc in spmd] != [
            (1, {"data": 1, "model": 1})]:
        raise AssertionError(f"{job}: rank incarnations {spmd}")
    rank = spmd[0]
    n_rank = len(rank["step_s"])
    if n_rank != m["steps"] - m["checkpoint_every"]:
        raise AssertionError(f"{job}: {n_rank} steps in the rank")
    want = {kfa.NAME: cfg.n_layers * n_calls,
            kfab.NAME: cfg.n_layers * n_calls}
    if {k: launches[k] for k in want} != want or any(
            rank["launches"][k] != cfg.n_layers * n_rank for k in want):
        raise AssertionError(f"{job}: launches {launches} (the rank's "
                             f"{rank['launches']}), want {want} "
                             f"({n_calls} steps taken, {n_rank} in the "
                             f"rank)")
    first = [by_step[s] for s in range(PJIT_EPOCH)]
    last = [by_step[s] for s in range(m["steps"] - PJIT_EPOCH, m["steps"])]
    if not all(map(math.isfinite, by_step.values())) or \
            sum(last) >= sum(first):
        raise AssertionError(f"{job}: the last pass's mean loss "
                             f"{sum(last) / len(last)} is not below the "
                             f"first's {sum(first) / len(first)}")
    perf = plan.meta["perf"].snapshot(measured_rate_from_metrics(
        plat.metrics, job))
    ratio = check_perf(perf, job, cfg, m)
    if perf.get("collective_s") != 0.0:
        raise AssertionError(f"{job}: a mesh-less step with a collective "
                             f"term: {perf}")
    uploaded = np.load(io.BytesIO(plat.storage.download(
        "results", job, "trained_model.npy")))
    rounds = list(plat.metrics.series(job, "round_time_s").values)
    batches = resumed_batches(torch, plat, job, cfg, n_rank)
    del handle, plan, be, plat
    gc.collect()
    torch.cuda.empty_cache()
    opt = OptConfig(name=m["optimizer"], lr=m["lr"])
    # the steps after the resume, mesh-less in this process from the
    # step-4 checkpoint on the batches the rank took
    tr = Trainer(cfg, Dist(), opt, TrainerConfig(
        batch=B, seq=S, ckpt_dir=str(ckdir), job_id="replay"))
    tr.restore(m["checkpoint_every"])
    replay = [tr.step_once(b) for b in batches]
    del tr, batches
    gc.collect()
    torch.cuda.empty_cache()
    after = [by_step[s] for s in range(m["checkpoint_every"], m["steps"])]
    replay_diff = max(abs(x - y) for x, y in zip(after, replay))
    if any(abs(x - y) > MODEL_TOL + MODEL_TOL * abs(y)
           for x, y in zip(after, replay)):
        raise AssertionError(f"{job}: losses in the rank {after} vs a "
                             f"mesh-less restore {replay}")
    tr = Trainer(cfg, Dist(), opt, TrainerConfig(
        batch=B, seq=S, ckpt_dir=str(ckdir), job_id="restore"))
    t1 = time.perf_counter()
    tr._restore_latest()
    restore_s = time.perf_counter() - t1
    if tr.step != m["steps"]:
        raise AssertionError(f"restored step {tr.step} != {m['steps']}")
    if flat_from_params(tr.params).tobytes() != uploaded.tobytes():
        raise AssertionError("the restored checkpoint's params differ from "
                             "trained_model.npy")
    del uploaded
    from torch.profiler import ProfilerActivity, profile
    batch = tr._batch(0)
    tr.step_once(batch)                                  # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(2):
            tr.step_once(batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    warm = sorted(rounds[1:])[len(rounds[1:]) // 2]
    in_rank = sorted(rank["step_s"][1:])[len(rank["step_s"][1:]) // 2]
    print(f"[pjit] {card}: {cfg.arch_id} L={cfg.n_layers} d={cfg.d_model} "
          f"{cfg.dtype} through PjitBackend, {m['optimizer']} lr {m['lr']}, "
          f"{m['steps']} steps of {B} x {S} tokens over "
          f"{m['data']['n_docs']} documents, a checkpoint every "
          f"{m['checkpoint_every']}: {state} in {wall:.2f} s; paused after "
          f"{paused_at} steps, preempted, moved onto a 1 x 1 mesh: one "
          f"rank process (NCCL) started and restored in "
          f"{rank['start_s']:.2f} s (its restore {rank['restore_s']:.2f} "
          f"s), {resumed[0]}, {n_rank} steps in the rank (step_once "
          f"there: median {1e3 * in_rank:.1f} ms, "
          f"{[round(1e3 * x, 1) for x in rank['step_s']]} ms), {n_calls} "
          f"steps taken; losses in the rank vs a mesh-less restore of step "
          f"{m['checkpoint_every']} here on the same batches: largest "
          f"difference {replay_diff:.3e} (atol=rtol {MODEL_TOL}); K4 "
          f"{here[kfa.NAME]} here + {rank['launches'][kfa.NAME]} in the "
          f"rank; loss by step {[round(by_step[s], 4) for s in by_step]}; "
          f"first pass mean {sum(first) / len(first):.4f}, last pass mean "
          f"{sum(last) / len(last):.4f}; step wall (round_time_s) median "
          f"{1e3 * warm:.1f} ms = {B * S / warm:.1f} tokens/s (rounds "
          f"{[round(1e3 * r, 1) for r in rounds]} ms, the saves' host "
          f"snapshots and the pause inside theirs); peak device memory "
          f"{peak / 2**30:.2f} GiB; K4 {launches[kfa.NAME]} and K4b "
          f"{launches[kfab.NAME]} launches = {cfg.n_layers} x {n_calls}; "
          f"checkpoint {m['steps']} restored by a fresh Trainer in "
          f"{restore_s:.2f} s, its params == trained_model.npy")
    print(f"[pjit] {card}: status.perf {json.dumps(perf)} "
          f"({ratio:.4f} of model_flops; collective term 0: estimated by "
          f"the mesh-less incarnation)")
    print(f"[pjit] {card}: two warm steps profiled: {prof_wall:.3f} s "
          f"wall = {1e3 * prof_wall / 2:.1f} ms a step")
    print_profile(prof, prof_wall, card,
                  ours=("flash_fwd_kernel", "flash_bwd"))
    return {"launches": launches, "wall_s": wall, "warm_ms": 1e3 * warm,
            "peak_bytes": peak, "losses": by_step,
            "rank_step_ms": 1e3 * in_rank, "replay_diff": replay_diff}


def pjit_mesh(torch, cfg, workdir, card):
    """19 b: a 1-rank NCCL process group and ``make_mesh(data=1,
    model=1)`` on the card. The ``fsdp_tp`` AdamW step of a trainer on
    the mesh against a mesh-less trainer's, from the same seed and batch:
    the loss and every updated leaf within ``MODEL_TOL``. Then a
    mesh-less Adafactor trainer resumed onto the mesh after 4 steps (its
    checkpoint 3.3 GB, where AdamW's would be 16.4): its next 4 losses
    against those of an uninterrupted mesh-less run. One rank's collectives are copies:
    this shows the DTensor and NCCL path runs the port's kernels, not its
    speed across cards."""
    import torch.distributed as tdist
    from repro_torch.distributed.sharding import Dist, gather
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import iter_leaves
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    m = PJIT_MANIFEST

    def trainer(dist, name, opt):
        return Trainer(cfg, dist, opt, TrainerConfig(
            batch=m["batch_docs"], seq=m["data"]["seq_len"],
            ckpt_dir=str(Path(workdir) / name), job_id=name)).init(0)

    def free():
        gc.collect()
        torch.cuda.empty_cache()
    adamw = OptConfig(name="adamw", lr=PJIT_MESH_LR)
    adafactor = OptConfig(name=m["optimizer"], lr=m["lr"])
    tdist.init_process_group(
        "nccl", store=tdist.FileStore(str(Path(workdir) / "pg-store"), 1),
        rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        a = trainer(Dist(), "flat", adamw)
        b = trainer(Dist(mesh=mesh), "mesh", adamw)
        batch = a._batch(0)
        k4 = ops.launch_counts()[kfa.NAME]
        la, lb = a.step_once(batch), b.step_once(batch)
        k4 = ops.launch_counts()[kfa.NAME] - k4
        diff = 0.0
        for (k, x), (_, y) in zip(iter_leaves(a.params),
                                  iter_leaves(b.params)):
            y = gather(y)
            d = (x.float() - y.float()).abs()
            diff = max(diff, d.max().item())
            if (d > MODEL_TOL + MODEL_TOL * x.float().abs()).any().item():
                raise AssertionError(f"the mesh step's {k} differs from "
                                     f"the mesh-less step's by {diff}")
        if abs(la - lb) > MODEL_TOL + MODEL_TOL * abs(la):
            raise AssertionError(f"mesh loss {lb} vs mesh-less {la}")
        del a, b
        free()
        flat = trainer(Dist(), "uninterrupted", adafactor)
        want = [flat.step_once(flat._batch(s))
                for s in range(PJIT_MESH_STEPS)]
        del flat
        free()
        c = trainer(Dist(), "resumed", adafactor)
        half = PJIT_MESH_STEPS // 2
        got = [c.step_once(c._batch(s)) for s in range(half)]
        c.resume(Dist(mesh=mesh))
        got += [c.step_once(c._batch(s))
                for s in range(half, PJIT_MESH_STEPS)]
        resumed_on = type(next(v for _, v in iter_leaves(c.params))).__name__
        del c
        free()
    finally:
        tdist.destroy_process_group()
    worst = max(abs(x - y) for x, y in zip(got[half:], want[half:]))
    if any(abs(x - y) > MODEL_TOL + MODEL_TOL * abs(y)
           for x, y in zip(got[half:], want[half:])):
        raise AssertionError(f"losses after the resume onto the mesh "
                             f"{got[half:]} vs uninterrupted {want[half:]}")
    print(f"[pjit-mesh] {card}: 1-rank NCCL mesh (data 1, model 1), "
          f"fsdp_tp, AdamW lr {PJIT_MESH_LR}: step loss {lb:.6f} vs "
          f"mesh-less {la:.6f}; every updated leaf within atol=rtol "
          f"{MODEL_TOL}, largest difference {diff:.3e}; {k4} K4 launches "
          f"for the two steps. Adafactor lr {m['lr']}: a mesh-less trainer "
          f"resumed onto the mesh at step {half} ({resumed_on} params): "
          f"losses {[round(x, 6) for x in got[half:]]} vs uninterrupted "
          f"{[round(x, 6) for x in want[half:]]}, largest difference "
          f"{worst:.3e}. One rank's collectives are copies: no claim on "
          f"speed across cards")
    return {"step_diff": diff, "loss_diff": abs(la - lb),
            "resume_diff": worst}


def train_pjit(torch, ops, ref, kfa, kfab, card):
    """Phase 19: ``pjit_platform`` (19 a) and ``pjit_mesh`` (19 b) at
    stablelm-1.6b's full width and depth, then K4 and K4b at the step's
    attention shape against their plain versions. Returns (K4 results,
    K4b results, 19 a's launch counts: the main path)."""
    from repro_torch.configs.registry import get_arch
    cfg = dataclasses.replace(get_arch(PJIT_ARCH), n_layers=PJIT_LAYERS)
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip-smoke-pjit-",
                                    dir=build_dir))
    try:
        res = pjit_platform(torch, ops, kfa, kfab, cfg, workdir, card)
        gc.collect()
        torch.cuda.empty_cache()
        pjit_mesh(torch, cfg, workdir, card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    m = PJIT_MANIFEST
    shape = (m["batch_docs"], m["data"]["seq_len"], cfg.n_heads,
             cfg.n_kv_heads, cfg.hd, "bfloat16", True)
    fwd = check_attention(torch, ops, ref, shape, seed=19)
    bwd = check_attention_bwd(torch, ops, ref, shape + (0,), seed=19)
    for label, r in (("K4", fwd), ("K4b", bwd)):
        print(f"[kernel] {card}: {label} at the pjit step's shape "
              f"{json.dumps(r)}")
    torch.cuda.empty_cache()
    return [fwd], [bwd], res["launches"]


# ---------------------------------------------------------------------------
# Phase 20: the paper's PS solvers and zero3_sp's sequence parallelism
# ---------------------------------------------------------------------------


def solver_launches(name: str, cfg, compress: bool, h: int):
    """Kernel launches of one round of solver ``name`` on the local path
    with SOLVER_LEARNERS learners: K4 and K4b once per layer per learner
    per microstep; K2 and K3 once per learner's push when ``compress``;
    K1 once (psgd's update, modelavg's ``average``, easgd's
    ``easgd_center``), downpour once per arrival."""
    n = SOLVER_LEARNERS
    steps = n * (1 if name == "psgd" else h)
    return {"flash_attention": cfg.n_layers * steps,
            "flash_attention_bwd": cfg.n_layers * steps,
            "ps_aggregate": n if name == "downpour" else 1,
            "quantize_ef": n if compress else 0,
            "dequantize": n if compress else 0,
            "ssd_scan": 0, "ssd_scan_bwd": 0}


def lm_solver(torch, model, scfg, opt, n_learners, device):
    """``core.solvers.make_solver`` over ``model``'s loss: the solver's f32
    leaves (per-layer lists for the stacked blocks) cast to the model
    dtype, then ``Model.loss`` (K4/K4b on the card)."""
    from repro_torch.core.solvers import make_solver
    from repro_torch.models.layers import is_stacked, map_leaves
    dt = model.dtype

    def cast(_p, t):
        return [x.to(dt) for x in t] if isinstance(t, list) else t.to(dt)

    def loss_fn(tree, batch):
        return model.loss(map_leaves(cast, tree), batch)
    return make_solver(loss_fn, model.abstract_params(), opt, scfg,
                       n_learners, device=device, per_layer=is_stacked)


def solver_batches(torch, cfg, h, n, b, seq, seed, device):
    """Fixed (H, L, b, seq) token batches and their next-token labels."""
    g = torch.Generator(device=device).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (h, n, b, seq + 1),
                         generator=g, device=device)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def solvers_card_vs_cpu(torch, ops):
    """One round of each SOLVER_RUNS solver at smoke width in f32 on the
    card and on the CPU from the same params and batches, SGD at
    SOLVER_SMOKE_LR on the server and locally: the centers within
    SOLVER_ATOL, the losses within STEP_LOSS_TOL. A compressed psgd run's
    center is held after its int8 flips are taken out (see
    SOLVER_MAX_FLIP_SHARE). Returns {run: (center err, loss err, flips)}."""
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.solvers import SolverConfig
    from repro_torch.models import make_model
    from repro_torch.optim.optimizers import OptConfig
    cfg = reduce_for_smoke(get_arch(SOLVER_ARCH))
    model = make_model(cfg, opts=NO_REMAT)
    params = model.init(torch.Generator().manual_seed(0))
    opt = OptConfig(name="sgd", lr=SOLVER_SMOKE_LR)
    out = {}
    for label, kw in SOLVER_RUNS:
        scfg = SolverConfig(local_lr=SOLVER_SMOKE_LR, **kw)
        res = {}
        for dev in ("cuda", "cpu"):
            s = lm_solver(torch, model, scfg, opt, SOLVER_LEARNERS, dev)
            st = s.init_state(params)
            b = solver_batches(torch, cfg, scfg.rounds_h, SOLVER_LEARNERS,
                               2, 64, 20, "cpu")
            st, m = s.round(st, {k: v.to(dev) for k, v in b.items()})
            res[dev] = (st["center"].cpu(), float(m["loss"]),
                        st["err"].cpu() if scfg.compress else None)
        diff = res["cuda"][0] - res["cpu"][0]
        flips = 0
        if scfg.compress:
            # psgd, sgd server: center -= lr * mean over learners of
            # (y - err), so a flip's step in err moves the center by
            # lr / L x that step
            assert scfg.name == "psgd" and opt.name == "sgd", label
            cpu_err = res["cpu"][2]
            derr = res["cuda"][2] - cpu_err
            half = cpu_err.abs().view(cpu_err.shape[0], -1, 256).amax(
                -1, keepdim=True).expand(-1, -1, 256).reshape(cpu_err.shape)
            flipped = (derr.abs() > SOLVER_ATOL) & (derr.abs() > half)
            flips = int(flipped.sum())
            diff = diff - SOLVER_SMOKE_LR * (derr * flipped).mean(0)
            if flips > SOLVER_MAX_FLIP_SHARE * derr.numel():
                raise AssertionError(f"{label}: {flips} int8 codes of "
                                     f"{derr.numel()} differ (limit "
                                     f"{SOLVER_MAX_FLIP_SHARE} of them)")
        err = diff.abs().max().item()
        lerr = abs(res["cuda"][1] - res["cpu"][1])
        if err > SOLVER_ATOL or lerr > STEP_LOSS_TOL:
            raise AssertionError(f"{label} round at smoke width: center "
                                 f"err {err} (limit {SOLVER_ATOL}), loss "
                                 f"err {lerr}")
        out[label] = (err, lerr, flips)
    return out


def train_solvers(torch, ops, kfa, kfab, card):
    """20 a: each SOLVER_RUNS solver for SOLVER_ROUNDS rounds at full width
    (SOLVER_ARCH cut to SOLVER_LAYERS layers), SOLVER_LEARNERS learners
    on one card (the local path), fixed batches; the loss falls, every
    round's launches are the derived counts, bf16 K4/K4b on the tensor
    cores. Then one round of each at smoke width against the CPU.
    Returns (the main path's launches summed over the runs, the solver's
    padded F)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.solvers import SolverConfig
    from repro_torch.models import make_model
    from repro_torch.optim.optimizers import OptConfig
    cfg = dataclasses.replace(get_arch(SOLVER_ARCH), n_layers=SOLVER_LAYERS)
    model = make_model(cfg, opts=NO_REMAT)
    opt = OptConfig(**SOLVER_OPT)
    print(f"[solvers] {card}: {memory_line(torch, 'before phase 20:')}")
    total = dict.fromkeys(ops.launch_counts(), 0)
    padded = None
    for label, kw in SOLVER_RUNS:
        scfg = SolverConfig(local_lr=SOLVER_LOCAL_LR, **kw)
        s = lm_solver(torch, model, scfg, opt, SOLVER_LEARNERS, "cuda")
        padded = s.padded
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        st = s.init_state(params)
        del params
        batches = solver_batches(torch, cfg, scfg.rounds_h, SOLVER_LEARNERS,
                                 SOLVER_DOCS, SOLVER_SEQ, 20, "cuda")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        want = solver_launches(scfg.name, cfg, scfg.compress, scfg.rounds_h)
        losses, ms, metrics = [], [], {}
        for r in range(SOLVER_ROUNDS):
            ops.reset_launch_counts()
            tc0 = (kfa.launches_tc, kfab.launches_tc)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = s.round(st, batches)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            got = ops.launch_counts()
            tc = (kfa.launches_tc - tc0[0], kfab.launches_tc - tc0[1])
            if got != want or tc != (want[kfa.NAME], want[kfab.NAME]):
                raise AssertionError(f"{label} round {r}: launches {got}, "
                                     f"on the tensor cores {tc}; want "
                                     f"{want}, K4/K4b all on them")
            for k, v in got.items():
                total[k] += v
            losses.append(float(m["loss"]))
            metrics = {k: float(v) for k, v in m.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
            raise AssertionError(f"{label}: losses {losses} do not fall on "
                                 f"the batches it trains on")
        wire = {mode: lm_solver(torch, model, SolverConfig(
            push_mode=mode, **kw), opt, SOLVER_LEARNERS,
            "cuda").wire_bytes_per_round() for mode in ("ps", "broadcast")}
        tokens = SOLVER_LEARNERS * scfg.rounds_h * SOLVER_DOCS * SOLVER_SEQ
        warm = sorted(ms[1:])[len(ms[1:]) // 2]
        print(f"[solvers] {card}: {label} {dataclasses.asdict(scfg)}, "
              f"server {SOLVER_OPT}, {SOLVER_ARCH} L={cfg.n_layers} "
              f"d={cfg.d_model} bf16, F={s.true_size} (padded {s.padded}), "
              f"{SOLVER_LEARNERS} learners x {SOLVER_DOCS} x {SOLVER_SEQ} "
              f"tokens per microstep: losses {[round(x, 4) for x in losses]}"
              f"; last metrics {metrics}; round ms "
              f"{[round(t, 2) for t in ms]} (warm median {warm:.2f} ms = "
              f"{tokens / (warm / 1e3):.1f} tokens/s); peak device memory "
              f"{peak:.2f} GiB; launches a round {want}; "
              f"wire_bytes_per_round (analytic, per learner; one card has "
              f"no wire) ps {wire['ps']:,} B, broadcast "
              f"{wire['broadcast']:,} B")
        del st, s, batches
        gc.collect()
        torch.cuda.empty_cache()
    for label, (err, lerr, flips) in solvers_card_vs_cpu(torch,
                                                         ops).items():
        print(f"[solvers] {card}: {label} smoke width f32, one round on the "
              f"card vs the CPU (sgd lr {SOLVER_SMOKE_LR}): center max abs "
              f"err {err:.3e} (limit {SOLVER_ATOL}; int8 codes that differ "
              f"{flips}, taken out), loss err {lerr:.3e} "
              f"(limit {STEP_LOSS_TOL})")
    return total, padded


def sp_kernels(torch, ops, ref, card):
    """20 b: K4 with LSE and K4b against their plain versions at the
    per-rank shapes of a SP_MODEL-way "model" axis: qwen2-vl-2b's (its
    VLM_BATCH x VLM_SEQ, causal, q_offset = rank * S / SP_MODEL) and
    whisper-large-v3's encoder (non-causal). Returns (K4 results, K4b
    results)."""
    from repro_torch.configs.registry import get_arch
    vl = get_arch(VLM_ARCH)
    n = VLM_SEQ // SP_MODEL
    shapes = [((VLM_BATCH, n, vl.n_heads, vl.n_kv_heads, vl.hd, "bfloat16",
                True, r * n), VLM_SEQ) for r in range(SP_MODEL)]
    B, S, H, KV, hd = SP_ENC
    shapes.append(((B, S // SP_MODEL, H, KV, hd, "bfloat16", False, 0), S))
    fwd, bwd = [], []
    for i, (shape, sk) in enumerate(shapes):
        r = check_attention_bwd(torch, ops, ref, shape, seed=40 + i, sk=sk)
        print(f"[kernel] {card}: K4 with LSE and K4b at a zero3_sp rank's "
              f"shape {json.dumps(r)}")
        fwd.append(r["fwd"])
        bwd.append(r)
        torch.cuda.empty_cache()
    return fwd, bwd


def sp_step(torch, ops, kfa, kfab, params, card):
    """20 b: the zero3_sp train step of qwen2-vl-2b at full width and depth
    on a 1-rank NCCL mesh (data 1, model 1) against the mesh-less step,
    from ``params`` (phase 18's weights, consumed) on one VLM_BATCH x
    VLM_SEQ batch, default optimizer: the loss and every updated leaf
    within MODEL_TOL. Returns the mesh step's launches (the main path)."""
    import torch.distributed as tdist
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed import steps
    from repro_torch.distributed.sharding import (Dist, Sharding,
                                                  distribute, gather)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import make_model
    from repro_torch.models.layers import iter_leaves, leaf_at, map_leaves
    from repro_torch.optim.optimizers import init_opt_state, opt_state_specs
    cfg = get_arch(VLM_ARCH)
    B, S = VLM_BATCH, VLM_SEQ
    batch = vlm_batch(torch, cfg, B, S, 2)
    opt = steps.default_optimizer(cfg)
    mesh_params = map_leaves(lambda _p, t: t.clone(), params)
    flat_model = make_model(cfg, opts=NO_REMAT)
    state = init_opt_state(opt, params)
    params, state, la = steps.build_train_step(flat_model, opt)(
        params, state, batch)
    la = la.item()
    del state
    gc.collect()
    torch.cuda.empty_cache()
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip-smoke-sp-", dir=build_dir))
    tdist.init_process_group(
        "nccl", store=tdist.FileStore(str(workdir / "pg-store"), 1),
        rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        d = Dist(mesh=mesh, policy="zero3_sp").resolve_batch(B)
        model = make_model(cfg, d, NO_REMAT)
        psh = model.param_shardings()
        ospecs = opt_state_specs(opt, model.param_defs(), d)
        full_state = init_opt_state(opt, mesh_params)
        mp = map_leaves(lambda p, x: distribute(x, leaf_at(psh, p)),
                        mesh_params)
        mstate = {k: (distribute(v, Sharding(mesh, ospecs[k])) if k == "step"
                      else map_leaves(lambda p, x, k=k: distribute(
                          x, Sharding(mesh, leaf_at(ospecs[k], p))), v))
                  for k, v in full_state.items()}
        del mesh_params, full_state
        shape = ShapeSpec("t", S, B, "train")
        step = steps.jit_train_step(model, opt, shape)
        sp = steps.local_loss_and_grads(model, shape).seq_parallel(batch)
        ops.reset_launch_counts()
        tc0 = (kfa.launches_tc, kfab.launches_tc)
        mp, mstate, lb = step(mp, mstate, batch)
        lb = lb.item()
        launches = ops.launch_counts()
        tc = (kfa.launches_tc - tc0[0], kfab.launches_tc - tc0[1])
        diff = 0.0
        for (k, x), (_, y) in zip(iter_leaves(params), iter_leaves(mp)):
            y = gather(y)
            dd = (x.float() - y.float()).abs()
            diff = max(diff, dd.max().item())
            if (dd > MODEL_TOL + MODEL_TOL * x.float().abs()).any().item():
                raise AssertionError(f"the zero3_sp step's {k} differs "
                                     f"from the mesh-less step's by {diff}")
        del mp, mstate
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(workdir, ignore_errors=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    want = cfg.n_layers
    if not sp or abs(la - lb) > MODEL_TOL + MODEL_TOL * abs(la) or \
            (launches[kfa.NAME], launches[kfab.NAME]) != (want, want) or \
            tc != (want, want):
        raise AssertionError(f"zero3_sp step: sequence-parallel {sp}, loss "
                             f"{lb} vs mesh-less {la}, launches {launches},"
                             f" on the tensor cores {tc}")
    print(f"[train-sp] {card}: {VLM_ARCH} L={cfg.n_layers} d={cfg.d_model} "
          f"bf16, B={B} x {S} embeds with M-RoPE positions, {opt.name} lr "
          f"{opt.lr}: the zero3_sp step on a 1-rank NCCL mesh (data 1, "
          f"model 1; sequence-parallel {sp}, one rank: the K/V gather is "
          f"the identity and q_offset 0) loss {lb:.6f} vs mesh-less "
          f"{la:.6f}; every updated leaf within atol=rtol {MODEL_TOL}, "
          f"largest difference {diff:.3e}; launches {launches} (on the "
          f"tensor cores {tc})")
    return launches



# ---------------------------------------------------------------------------
# Phase 21: kimi-k2 at full width (K4 at head dim 112) and the
# expert-parallel steps on a 1-rank NCCL mesh
# ---------------------------------------------------------------------------


def kimi_moe_checks(torch, cfg, params, card):
    """21 a: ``moe_block`` against ``moe_ref`` on the serve's layer 0 at
    kimi-k2's full width (384 experts, top-8: the first card check of the
    combine with k = 8) for each of KIMI_BLOCK_CASES."""
    from repro_torch.models.transformer import layer_params
    layer = layer_params(params["blocks"], 0)["moe"]
    out = []
    for i, (shape, kind) in enumerate(KIMI_BLOCK_CASES):
        res = check_moe_block(torch, cfg, layer, shape, kind, seed=21 + i)
        print(f"[kimi] {card}: moe_block vs moe_ref {json.dumps(res)}")
        out.append(res)
    return out


def ep_prefill_decode(torch, cfg, params, label, card, cache_len):
    """21 b: ``jit_prefill_step`` and ``jit_decode_step`` of ``cfg`` on a
    1-rank NCCL mesh under ``fsdp_tp`` (the expert-parallel path: the
    train body's two all-to-alls over one rank in the prefill of
    EP_PROMPT tokens, the decode body's all-reduce over one rank in
    EP_DECODE decode steps) against the mesh-less
    ``build_prefill_step`` / ``build_decode_step`` on the same params and
    batch: the largest difference of the logits and of the cache (limit
    EP_DIFF_LIMIT: the same arithmetic in the same order). The process
    group is up."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import steps
    from repro_torch.distributed.sharding import Dist, distribute
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import make_model
    from repro_torch.models.layers import leaf_at, map_leaves
    B = EP_BATCH
    g = torch.Generator(device="cuda").manual_seed(21)
    toks = torch.randint(0, cfg.vocab_size, (B, EP_PROMPT + EP_DECODE),
                         generator=g, device="cuda")
    model = make_model(cfg, opts=NO_REMAT)
    dist = Dist(mesh=make_mesh(1, 1)).resolve_batch(B)
    mmodel = make_model(cfg, dist, NO_REMAT)
    shape = ShapeSpec("ep", EP_PROMPT, B, "prefill")
    psh = mmodel.param_shardings()
    dparams = map_leaves(lambda p, x: distribute(x, leaf_at(psh, p)), params)
    csh = mmodel.cache_shardings(B)
    runs = {}
    for name, prefill, decode, wrap in (
            ("mesh-less", steps.build_prefill_step(model),
             steps.build_decode_step(model), None),
            ("mesh", steps.jit_prefill_step(mmodel, shape),
             steps.jit_decode_step(mmodel, shape), csh)):
        cache = model.empty_cache(B, cache_len, "cuda")
        p = params
        if wrap is not None:
            cache = {k: distribute(v, wrap[k]) for k, v in cache.items()}
            p = dparams
        kw = {"cache": cache} if wrap is not None else {
            "cache": cache, "slots": torch.arange(B, device="cuda")}
        logits, cache = prefill(p, {"tokens": toks[:, :EP_PROMPT]}, **kw)
        got = [logits]
        for i in range(EP_DECODE):
            logits, cache = decode(p, cache, {"tokens": toks[
                :, EP_PROMPT + i:EP_PROMPT + i + 1]})
            got.append(logits)
        if wrap is not None:
            got = [x.full_tensor() for x in got]
            cache = {k: v.full_tensor() for k, v in cache.items()}
        runs[name] = (torch.cat(got, 1), cache)
    (a, ca), (b, cb) = runs["mesh-less"], runs["mesh"]
    if not torch.isfinite(a).all().item() or a.shape != (
            B, 1 + EP_DECODE, cfg.vocab_size):
        raise AssertionError(f"{label}: logits {tuple(a.shape)} or "
                             f"non-finite values")
    diff = (a.float() - b.float()).abs().max().item()
    cdiff = max((ca[k].float() - cb[k].float()).abs().max().item()
                for k in ca)
    print(f"[ep] {card}: {label}: jit_prefill_step ({B} x {EP_PROMPT}, the "
          f"all-to-all body) + {EP_DECODE} jit_decode_step (the all-reduce "
          f"body) on a 1-rank NCCL mesh (data 1, model 1, fsdp_tp) vs the "
          f"mesh-less steps: logits max abs difference {diff:.3e}, cache "
          f"{cdiff:.3e} (limit {EP_DIFF_LIMIT}; predicted 0.000e+00)")
    if diff > EP_DIFF_LIMIT or cdiff > EP_DIFF_LIMIT:
        raise AssertionError(f"{label}: the expert-parallel steps differ "
                             f"from the mesh-less steps by {diff} "
                             f"(logits), {cdiff} (cache)")
    return {"logits_diff": diff, "cache_diff": cdiff}


def serve_kimi(torch, ops, ref, kfa, card):
    """Phase 21: a. kimi-k2 at full width cut to KIMI_SERVE_LAYERS layer
    behind ``InferenceEngine`` (cold, warm) with phase 15's requests, K4
    at head dim 112 on the tensor cores at every prefill, ``moe_block``
    against ``moe_ref`` on its layer (k = 8); b. the expert-parallel
    prefill and decode steps on a 1-rank NCCL mesh against the mesh-less
    steps, on kimi-k2's weights and then on grok-1's (phase 15's
    configuration, seed 0); c. K4 at kimi-k2's prefill shape and at the
    serve's, against its plain version and SDPA, then K4b at head dim
    112 and the gradient of one attention sub-block on layer 0's weights
    (``kimi_attention_grad``). Returns (K4 results, the moe_block
    results, the cold serve's launches, the EP differences, (K4b
    results, the sub-block gradient's launches))."""
    import torch.distributed as tdist
    from repro_torch.analysis.roofline import HBM_BW
    from repro_torch.configs.registry import get_arch
    full = get_arch(KIMI_ARCH)
    cfg = dataclasses.replace(full, n_layers=KIMI_SERVE_LAYERS)
    m = cfg.moe
    print(f"[kimi] {card}: {memory_line(torch, 'before phase 21:')}")
    runs, ep = [], {}
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip-smoke-ep-", dir=build_dir))
    tdist.init_process_group(
        "nccl", store=tdist.FileStore(str(workdir / "pg-store"), 1),
        rank=0, world_size=1)
    try:
        for label in ("cold", "warm"):
            tokens, eng, rec, launches, wall, _ = serve(torch, cfg, ops, 0,
                                                        card)
            st = eng.stats()
            n_batches = eng.prefill_batches
            if launches[kfa.NAME] != cfg.n_layers * n_batches or \
                    kfa.launches_tc != launches[kfa.NAME]:
                raise AssertionError(
                    f"K4 launches {launches} ({kfa.launches_tc} on the "
                    f"tensor cores), want {cfg.n_layers} x {n_batches} "
                    f"prefill batches, all on the tensor cores (hd "
                    f"{cfg.hd})")
            if runs and tokens != runs[0]:
                raise AssertionError("same seed, same requests, different "
                                     "tokens")
            n_tok = st["tokens_out_total"]
            decode_ms = 1e3 * eng.decode_seconds / st["decode_steps"]
            by_batch = ", ".join(f"{nb}x{pl} {1e3 * t:.2f}" for (nb, pl), t
                                 in zip(rec.prefills, rec.prefill_s))
            snap = wait_perf(eng)
            check_perf(snap, "serve-kimi")
            step_bytes = snap["memory_s"] * HBM_BW
            print(f"[serve-kimi] {card}: {label}: {KIMI_ARCH} L="
                  f"{cfg.n_layers} of {full.n_layers}, d={cfg.d_model}, "
                  f"{cfg.n_heads} heads over {cfg.n_kv_heads} of hd "
                  f"{cfg.hd}, {m.n_experts} experts top-{m.top_k}, vocab "
                  f"{cfg.vocab_size}, bf16, capacity 4, max_seq 1024: "
                  f"{st['completed_total']} requests, {n_tok} tokens in "
                  f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s; prefill ms "
                  f"by batch (n x plen): {by_batch}; mean "
                  f"{1e3 * eng.prefill_seconds / n_batches:.2f} ms per "
                  f"batch; decode {st['decode_steps']} steps: "
                  f"{decode_ms:.2f} ms per step, bound "
                  f"{1e3 * snap['memory_s']:.2f} ms ({step_bytes / 1e9:.2f}"
                  f" GB a step reads at {HBM_BW / 1e12} TB/s, counted on "
                  f"the meta device: status.perf) = "
                  f"{snap['memory_s'] * 1e3 / decode_ms:.3f} of it; request "
                  f"latency p50 {st['p50_latency_s']} s, p99 "
                  f"{st['p99_latency_s']} s; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                  f"kernel launches {launches} ({kfa.launches_tc} K4 on the "
                  f"tensor cores)")
            runs.append(tokens)
            if label == "cold":
                cold_launches, cold_prefills = launches, rec.prefills
                eng.release()
                del eng
                torch.cuda.empty_cache()
        print(f"[serve-kimi] {card}: {len(runs)} engines, same seed: "
              f"identical tokens")
        blocks = kimi_moe_checks(torch, cfg, eng.params, card)
        ep[KIMI_ARCH] = ep_prefill_decode(torch, cfg, eng.params, KIMI_ARCH,
                                          card, EP_PROMPT + EP_DECODE)
        # layer 0's attention weights, for 21 c's sub-block gradient
        pb = eng.params["blocks"]
        attn_w = {"ln": pb["ln1"]["w"][0].clone(),
                  "attn": {k: v[0].clone() for k, v in pb["attn"].items()}}
        del pb
        eng.release()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        gcfg = dataclasses.replace(get_arch(MOE_ARCH),
                                   n_layers=MOE_SERVE_LAYERS)
        from repro_torch.models import make_model
        gparams = make_model(gcfg, opts=NO_REMAT).init(
            torch.Generator(device="cuda").manual_seed(0))
        ep[MOE_ARCH] = ep_prefill_decode(torch, gcfg, gparams, MOE_ARCH,
                                         card, EP_PROMPT + EP_DECODE)
        del gparams
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(workdir, ignore_errors=True)

    # c. K4 at head dim 112: kimi-k2's prefill shape, and every prefill
    # shape of the serve
    shapes = [KIMI_PREFILL] + [(n, plen, cfg.n_heads, cfg.n_kv_heads,
                                cfg.hd, "bfloat16", True)
                               for n, plen in sorted(set(cold_prefills))]
    k4 = [check_attention(torch, ops, ref, s, seed=21 + i)
          for i, s in enumerate(shapes)]
    for res in k4:
        print(f"[kernel] {card}: K4 serve-kimi path {json.dumps(res)}")
    if any(r["instance"] != "tensor cores" for r in k4):
        raise AssertionError("K4 at hd 112 in bf16 off the tensor cores")
    head = k4[0]
    print(f"[kernel] {card}: K4k (hd 112) at {head['shape']}: "
          f"{head['ms']:.4f} ms, bound {head['bound_ms']:.4f} ms "
          f"({head['bound_by']}, the 112 real dims) = "
          f"{head['share_of_bound']:.3f} of it; plain "
          f"{head['plain_ms']:.3f} ms; SDPA {head['library_ms']:.4f} ms")
    torch.cuda.empty_cache()
    k4b, grad_launches = kimi_attention_grad(torch, ops, ref, cfg, attn_w,
                                             card)
    del attn_w
    torch.cuda.empty_cache()
    return k4, blocks, cold_launches, ep, (k4b, grad_launches)

def kimi_attention_grad(torch, ops, ref, cfg, w, card):
    """21 c (second part): K4b at head dim 112 (KIMI_BWD_CASES) against
    its plain version (``check_attention_bwd``: bf16 within relative L2
    BWD_BF16_REL_L2 per gradient on the tensor cores, f32 within
    BWD_TOL, two calls equal in their bits, kernel, plain, bound and
    SDPA-backward ms); then the gradient of one kimi-k2 attention
    sub-block at full width (RMSNorm -> QKV + RoPE -> attention ->
    output projection, layer 0's weights ``w`` of phase 21's serve) at
    KIMI_GRAD through autograd: with the kernels (K4 with the LSE, K4b)
    against the same function with the plain attention on the card,
    every gradient within BWD_BF16_REL_L2. Returns (the K4b results, the
    sub-block's launches: the path ``grad-kimi-attn``)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_attention_bwd as kfab
    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import flash_attention
    k4b = [check_attention_bwd(torch, ops, ref, s, seed=210 + i)
           for i, s in enumerate(KIMI_BWD_CASES)]
    for r in k4b:
        print(f"[kernel] {card}: K4b at hd 112 {json.dumps(r)}")
        if r["shape"]["dtype"] == "bfloat16" and \
                r["instance"] != "tensor cores":
            raise AssertionError("K4b at hd 112 in bf16 off the tensor "
                                 "cores")
    head = k4b[0]
    print(f"[kernel] {card}: K4bk (hd 112) at {head['shape']}: "
          f"{head['ms']:.4f} ms, bound {head['bound_ms']:.4f} ms "
          f"({head['bound_by']}, the 112 real dims) = "
          f"{head['share_of_bound']:.3f} of it; plain "
          f"{head['plain_ms']:.3f} ms; SDPA backward "
          f"{head['library_ms']:.4f} ms; relative L2 {head['rel_l2']}")

    B, S = KIMI_GRAD
    g = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn(B, S, cfg.d_model, generator=g, device="cuda") \
        .to(torch.bfloat16)
    dy = torch.randn(B, S, cfg.d_model, generator=g, device="cuda") \
        .to(torch.bfloat16)
    positions = torch.arange(S, device="cuda").expand(B, S)
    names = ["x", "ln"] + sorted(w["attn"])

    def grads(attend):
        xs = x.detach().requires_grad_()
        ln = w["ln"].detach().requires_grad_()
        p = {k: v.detach().requires_grad_() for k, v in w["attn"].items()}
        h = tf.norm_apply(xs, {"w": ln}, cfg)
        q, k, v = tf._qkv(h, p, cfg, positions)
        y = tf._out_proj(attend(q, k, v), p, cfg)
        return torch.autograd.grad(y, [xs, ln] + [p[n] for n in names[2:]],
                                   dy)
    before = ops.launch_counts()
    got = grads(lambda q, k, v: flash_attention(q, k, v, causal=True))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    want = grads(lambda q, k, v: ref.flash_attention_ref(q, k, v,
                                                         causal=True))
    rels = {}
    for n, a, b in zip(names, got, want):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all().item():
            raise AssertionError(f"kimi-k2 attention gradient {n} is not "
                                 f"finite")
        rels[n] = ((a - b).norm() / b.norm()).item()
    del got, want
    torch.cuda.empty_cache()
    if max(rels.values()) > BWD_BF16_REL_L2:
        raise AssertionError(f"kimi-k2 attention sub-block: relative L2 "
                             f"{rels} > {BWD_BF16_REL_L2}")
    if (launches[kfa.NAME], launches[kfab.NAME]) != (1, 1):
        raise AssertionError(f"kimi-k2 attention sub-block launches "
                             f"{launches}, want one K4 and one K4b")
    print(f"[kimi] {card}: the gradient of one {KIMI_ARCH} attention "
          f"sub-block at full width (d {cfg.d_model}, {cfg.n_heads} heads "
          f"over {cfg.n_kv_heads} of hd {cfg.hd}, {B} x {S} tokens, bf16, "
          f"layer 0 of phase 21's weights): K4 + K4b against the plain "
          f"attention on the card, relative L2 by gradient "
          f"{json.dumps({k: round(v, 6) for k, v in rels.items()})} "
          f"(limit {BWD_BF16_REL_L2}); launches K4 {launches[kfa.NAME]}, "
          f"K4b {launches[kfab.NAME]}")
    return k4b, launches


# ---------------------------------------------------------------------------
# Phase 22: the launch-shape tuner
# ---------------------------------------------------------------------------

# an F whose fit_block(F, 1024) degrades to 2: 2 x 3 x 5 x 7 x 11 x 13
SMALL_BLOCK_F = 30030


def autotune_lengths():
    """(the PS shard, the PS push, the solvers' padded F) of phases 8 and
    20, from the configurations alone (no device memory)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.compression import pad_to_block
    from repro_torch.core.software_ps import ShardLayout
    from repro_torch.models import make_model
    from repro_torch.models.layers import iter_leaves
    from repro_torch.weights import flat_size
    lay = ShardLayout.build(flat_size(dataclasses.replace(
        get_arch(SERVE_ARCH), n_layers=TRAIN_ARCH_LAYERS)),
        TRAIN["n_shards"])
    model = make_model(dataclasses.replace(get_arch(SOLVER_ARCH),
                                           n_layers=SOLVER_LAYERS))
    n = sum(math.prod(t.shape) for _, t in
            iter_leaves(model.abstract_params()))
    block = 256 * SOLVER_LEARNERS                # core/solvers.py:122
    return lay.shard_len, lay.padded, max(pad_to_block(n, block), block)


def autotune_shapes(shard, push, solver_f):
    """(label, plan, the lookup ops makes) of every kernel shape phase 22
    tunes: K1 at the PS shard (adam, 2 learners) and the solvers' (4,
    F); K2 / K3 at the PS push (bf16 x) and the solvers' (f32 x); K4 at
    Jamba's serve, the 4,096-token training forward, qwen2-vl's training
    forward, a zero3_sp rank slice, kimi-k2's serve and a serve prompt."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import autotune as at
    out = []
    for label, nl, f in (("PS shard", TRAIN["n_learners"], shard),
                         ("solvers", SOLVER_LEARNERS, solver_f)):
        out.append((f"K1 {label}", at.ps_plan(nl, f), functools.partial(
            at.tuned_ps_block, nl, f, torch.float32, device="cuda")))
    for kname, label, f, dt in (
            ("K2", "PS push", push, torch.bfloat16),
            ("K2", "solvers", solver_f, torch.float32),
            ("K3", "PS push", push, torch.int8),
            ("K3", "solvers", solver_f, torch.int8)):
        out.append((f"{kname} {label}", at.quantize_plan(f, 256, dt),
                    functools.partial(at.tuned_quantize_block, f, 256, dt,
                                      device="cuda")))
    for label, arch, B, Sq, Sk, causal, q_offset, lse in (
            ("K4 serve-hybrid", HYBRID_ARCH, 2, 2048, 2048, True, 0, False),
            ("K4 train-4k", SERVE_ARCH, 1, 4096, 4096, True, 0, True),
            ("K4 train-qwen2-vl", VLM_ARCH, 2, 2048, 2048, True, 0, True),
            ("K4 zero3_sp rank 0", VLM_ARCH, 2, 512, 2048, True, 0, True),
            ("K4 serve-kimi", KIMI_ARCH, 4, 512, 512, True, 0, False),
            ("K4 serve prompt", SERVE_ARCH, 1, 33, 33, True, 0, False)):
        cfg = get_arch(arch)
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        kw = dict(heads=(H, KV), causal=causal, q_offset=q_offset, lse=lse)
        out.append((label, at.flash_plan(B * H, Sq, Sk, hd, torch.bfloat16,
                                         **kw),
                    functools.partial(at.tuned_flash_blocks, B * H, Sq, Sk,
                                      hd, torch.bfloat16, device="cuda",
                                      **kw)))
    return out


def prom_values(text, prefix):
    """{family: value} of the unlabelled samples whose names start with
    ``prefix`` in Prometheus text."""
    out = {}
    for line in text.splitlines():
        name, _, value = line.partition(" ")
        if name.startswith(prefix):
            out[name] = float(value)
    return out


def autotune_phase(torch, card, shapes):
    """a. Each shape tuned from a fresh cache (the lookup ops makes: a
    miss, measured), then every candidate run at the full shape on
    scratch: its outputs ``torch.equal`` to the default's (any
    difference fails the phase) and its median ms; b. each shape looked
    up again: hits with no probe launch, the counters equal to the calls
    made, and a ``DLaaSCore``'s ``/metrics`` text carrying them; c. a
    degraded ``fit_block`` raises the core's
    ``kernels_small_block_total``. Returns {label: result}."""
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import grid
    from repro_torch.service.core import DLaaSCore
    build_dir = ROOT / "build"
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-autotune-22-",
                                 dir=build_dir))
    run_cache = os.environ["DLAAS_AUTOTUNE_CACHE"]
    os.environ["DLAAS_AUTOTUNE_CACHE"] = str(work / "cache.json")
    dev = torch.device("cuda")
    results = {}
    try:
        cache = at.get_cache()
        for label, plan, lookup in shapes:
            probes, t0 = at.probe_launches, time.perf_counter()
            choice = lookup()
            tune_s = time.perf_counter() - t0
            with torch.cuda.device(dev):
                key = at.make_key(plan.kernel, plan.shape, plan.dtype,
                                  plan.extra_key)
            rec = json.loads(Path(at.cache_path()).read_text())[key]
            tuner_probes = at.probe_launches - probes
            probe = plan.probe(dev, limit=None)
            want = probe.run(plan.default)
            equal, ms = {}, {}
            for c in dict.fromkeys(list(plan.candidates) + [plan.default]):
                equal[str(c)] = probe.matches(c, want)
                ms[str(c)] = round(1e3 * probe.seconds(c), 4)
            del probe, want
            torch.cuda.empty_cache()
            bound_ms, bound_by = bound(plan.cost[0], **plan.cost[1])
            res = {"kernel": plan.kernel, "shape": list(plan.shape),
                   "key": key, "choice": choice, "source": rec["source"],
                   "default": plan.default,
                   "predicted_us": rec["predicted_us"],
                   "probe_us": rec["measured_us"], "ms": ms,
                   "choice_ms": ms[str(choice)],
                   "default_ms": ms[str(plan.default)],
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bits_equal": equal, "tuning_s": round(tune_s, 4),
                   "tuner_probe_launches": tuner_probes}
            results[label] = res
            print(f"[autotune] {card}: {label} {key}: choice {choice} "
                  f"({rec['source']}); predicted us "
                  f"{json.dumps(rec['predicted_us'])}; the tuner's "
                  f"measured us (probe, median of {at.MEASURE_REPS}) "
                  f"{json.dumps(rec['measured_us'])}; ms at the full shape "
                  f"by candidate {json.dumps(ms)}; default "
                  f"{plan.default} {res['default_ms']:.4f} ms, chosen "
                  f"{res['choice_ms']:.4f} ms, bound {bound_ms:.5f} ms "
                  f"({bound_by}); torch.equal to the default's outputs "
                  f"{json.dumps(equal)}; tuning {tune_s:.3f} s, "
                  f"{tuner_probes} probe launches", flush=True)
            if not all(equal.values()):
                raise AssertionError(f"autotune {label}: candidates whose "
                                     f"outputs differ from the default's: "
                                     f"{[c for c, e in equal.items() if not e]}")
        n = len(shapes)
        if (cache.hits, cache.misses, cache.size()) != (0, n, n):
            raise AssertionError(f"autotune: after {n} first lookups the "
                                 f"cache has hits {cache.hits}, misses "
                                 f"{cache.misses}, size {cache.size()}")
        probes = at.probe_launches
        for label, plan, lookup in shapes:
            if lookup() != results[label]["choice"]:
                raise AssertionError(f"autotune {label}: a second lookup "
                                     f"chose otherwise")
        if at.probe_launches != probes or cache.hits != n or \
                cache.misses != n:
            raise AssertionError(f"autotune: {n} second lookups made "
                                 f"{at.probe_launches - probes} probe "
                                 f"launches; hits {cache.hits}, misses "
                                 f"{cache.misses} (want {n}, {n})")
        core = DLaaSCore(str(work / "core"), device="cuda")
        try:
            fams = prom_values(core.prometheus_text(),
                               "dlaas_autotune_cache_")
            want = {"dlaas_autotune_cache_entries": float(n),
                    "dlaas_autotune_cache_hits_total": float(n),
                    "dlaas_autotune_cache_misses_total": float(n)}
            if fams != want:
                raise AssertionError(f"autotune families {fams} != {want}")
            counters = core.metrics.counters
            before = counters("platform").get("kernels_small_block_total",
                                              0)
            chosen = grid.fit_block(SMALL_BLOCK_F, 1024)
            after = counters("platform").get("kernels_small_block_total", 0)
            if chosen >= grid.SMALL_BLOCK_FLOOR or after != before + 1:
                raise AssertionError(f"fit_block({SMALL_BLOCK_F}, 1024) = "
                                     f"{chosen}: kernels_small_block_total "
                                     f"{before} -> {after}")
        finally:
            core.close()
        print(f"[autotune] {card}: {n} shapes looked up again: {n} hits, "
              f"0 probe launches; the exporter's families {json.dumps(fams)}"
              f"; fit_block({SMALL_BLOCK_F}, 1024) = {chosen}: the core's "
              f"kernels_small_block_total {before} -> {after}", flush=True)
    finally:
        os.environ["DLAAS_AUTOTUNE_CACHE"] = run_cache
        shutil.rmtree(work, ignore_errors=True)
    return results


# ---------------------------------------------------------------------------
# Phase 23: the dry-run on the meta device, held against the card
# ---------------------------------------------------------------------------


def dryrun_child() -> int:
    """The dry-run child (``chip_smoke.py --dryrun-child``, started with
    no card visible): ``run_cell`` of each DRYRUN_CELLS cell on a fake
    512-rank group, then ``dry_step`` of phase 19 b's step on a 1-rank
    mesh of it at each REMAT_MODES value; one JSON record a line."""
    os.nice(10)                 # the card phases come first
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed.sharding import Dist
    from repro_torch.launch.dryrun import dry_step, fake_world, run_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import make_model
    from repro_torch.optim.optimizers import OptConfig
    fake_world(512)
    for arch, shape, mesh in DRYRUN_CELLS:
        try:
            rec = run_cell(arch, shape, mesh, save_ops=False)
        except Exception as e:      # recorded; the parent fails the phase
            rec = {"arch": arch, "shape": shape, "mesh": mesh,
                   "status": "error", "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(rec), flush=True)
    m = PJIT_MANIFEST
    cfg = dataclasses.replace(get_arch(PJIT_ARCH), n_layers=PJIT_LAYERS)
    shape = ShapeSpec("trainer", m["data"]["seq_len"], m["batch_docs"],
                      "train")
    dist = Dist(mesh=make_mesh(1, 1, device="cpu")).resolve_batch(
        m["batch_docs"])
    for remat in REMAT_MODES:
        rec = dry_step(make_model(cfg, dist, {"remat": remat}), shape,
                       OptConfig(name="adamw", lr=PJIT_MESH_LR))
        rec.pop("rows")
        print(json.dumps({"step": "19b", "remat": remat, "status": "ok",
                          **rec}), flush=True)
    return 0


def start_dryrun_child():
    """Start ``dryrun_child`` in a process of its own, with no card
    visible, its records going to a file under ``build/``; it is stopped
    at exit if it still runs. Returns (the process, the file)."""
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    out = Path(tempfile.mkdtemp(prefix="chip-smoke-dryrun-",
                                dir=build_dir)) / "records.jsonl"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    log = open(out, "w")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--dryrun-child"], stdout=log,
                            stderr=subprocess.STDOUT, env=env,
                            cwd=str(ROOT))
    log.close()

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(out.parent, ignore_errors=True)
    atexit.register(stop)
    return proc, out


def storage_bytes(trees) -> int:
    """Bytes of the distinct storages of the tensors in ``trees`` (a
    DTensor's, its local tensor's)."""
    from repro_torch.models.layers import iter_leaves
    seen, n = set(), 0
    for tree in trees:
        for _, t in iter_leaves(tree):
            st = getattr(t, "_local_tensor", t).untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                n += st.nbytes()
    return n


def remat_steps(torch, cfg, workdir, card):
    """23 b: phase 19 b's step on a 1-rank NCCL mesh, one fresh trainer
    at each REMAT_MODES value from the same seed and batch: the bytes of
    its params, optimizer state and batch, and ``max_memory_allocated()
    - memory_allocated()`` across one ``step_once`` (the peak reset just
    before it); its loss, updated leaves and K4/K4b launches. K4 is
    tuned at the step's shape first, so no probe falls inside a step."""
    import torch.distributed as tdist
    from repro_torch.distributed.sharding import Dist, gather
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import iter_leaves
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    m = PJIT_MANIFEST
    B, S = m["batch_docs"], m["data"]["seq_len"]
    bf = torch.bfloat16
    q = torch.zeros(B, S, cfg.n_heads, cfg.hd, dtype=bf, device="cuda")
    kv = torch.zeros(B, S, cfg.n_kv_heads, cfg.hd, dtype=bf, device="cuda")
    ops.flash_attention(q, kv, kv, causal=True, return_lse=True)
    del q, kv
    tdist.init_process_group(
        "nccl", store=tdist.FileStore(str(Path(workdir) / "pg-remat"), 1),
        rank=0, world_size=1)
    runs, leaves = {}, {}
    try:
        mesh = make_mesh(1, 1)
        for remat in REMAT_MODES:
            tr = Trainer(cfg, Dist(mesh=mesh), OptConfig(
                name="adamw", lr=PJIT_MESH_LR), TrainerConfig(
                batch=B, seq=S, ckpt_dir=str(Path(workdir) / remat),
                job_id=f"remat-{remat}"), opts={"remat": remat}).init(0)
            batch = tr._batch(0)
            held = storage_bytes((tr.params, tr.opt_state, batch))
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = ops.launch_counts()
            t0 = time.perf_counter()
            loss = tr.step_once(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            temp = torch.cuda.max_memory_allocated() - base
            after = ops.launch_counts()
            runs[remat] = {"held": held, "temp": temp, "loss": loss,
                           "step_s": wall, "launches": {
                               k: after[k] - before[k] for k in after}}
            leaves[remat] = {k: gather(x) for k, x in
                             iter_leaves(tr.params)}
            del tr, batch
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        tdist.destroy_process_group()
    diff = 0.0
    for k, x in leaves["none"].items():
        y = leaves["full"][k]
        d = (x.float() - y.float()).abs()
        diff = max(diff, d.max().item())
        if (d > MODEL_TOL + MODEL_TOL * x.float().abs()).any().item():
            raise AssertionError(f"remat full's updated {k} differs from "
                                 f"remat none's by {d.max().item()}")
    la, lb = runs["none"]["loss"], runs["full"]["loss"]
    if abs(la - lb) > MODEL_TOL + MODEL_TOL * abs(la):
        raise AssertionError(f"remat full's loss {lb} vs none's {la}")
    del leaves
    torch.cuda.empty_cache()
    return runs, max(diff, abs(la - lb))


def dryrun_phase(torch, kfa, kfab, card, child):
    """Phase 23: a. wait for the dry-run child and require every record
    ``ok``; b. phase 19 b's step on the card at remat none and full
    (``remat_steps``): its argument bytes equal the dry-run's to the
    byte, its temp bytes within REMAT_TEMP_TOL of the dry-run's, remat
    full's loss and leaves equal remat none's within MODEL_TOL, and the
    launches: K4 and K4b once a layer at none, K4 twice at full (the
    recomputed forward). Returns the launches of the two steps (the path
    ``train-pjit-remat``)."""
    from repro_torch.configs.registry import get_arch
    proc, out = child
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=DRYRUN_CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"the dry-run child did not end within "
                             f"{DRYRUN_CHILD_TIMEOUT} s")
    waited = time.perf_counter() - t0
    lines = out.read_text().splitlines()
    recs = []
    for line in lines:
        if line.startswith("{"):
            recs.append(json.loads(line))
    if rc != 0 or len(recs) != len(DRYRUN_CELLS) + len(REMAT_MODES):
        raise AssertionError(f"the dry-run child exited {rc} with "
                             f"{len(recs)} records: "
                             + "\n".join(lines[-30:]))
    bad = [r for r in recs if r.get("status") != "ok"]
    if bad:
        raise AssertionError(f"dry-run records not ok: {bad}")
    for r in recs[:len(DRYRUN_CELLS)]:
        print(f"[dryrun] {card}: {r['arch']} {r['shape']} {r['mesh']} "
              f"(counted on the meta device against H100 constants, no "
              f"card): peak {r['peak_bytes_per_device'] / 2**30:.2f} GiB "
              f"a device (fits 80 GB: {r['fits_h100_80gb']}), "
              f"{r['flops_per_device']:.4e} FLOPs a device, useful ratio "
              f"{r['useful_ratio']}, dominant {r['dominant']}, collectives "
              f"{r['ici_bytes_per_device'] / 1e9:.3f} GB "
              f"{json.dumps(r['collective_bytes_by_kind'])}; counted in "
              f"{r['count_s']} s")
    dry = {r["remat"]: r for r in recs[len(DRYRUN_CELLS):]}
    print(f"[dryrun] {card}: the child ended {waited:.1f} s after phase 22 "
          f"(it ran beside phases 2-22)")

    cfg = dataclasses.replace(get_arch(PJIT_ARCH), n_layers=PJIT_LAYERS)
    build_dir = ROOT / "build"
    workdir = Path(tempfile.mkdtemp(prefix="chip-smoke-remat-",
                                    dir=build_dir))
    try:
        runs, diff = remat_steps(torch, cfg, workdir, card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    L = cfg.n_layers
    want = {"none": (L, L), "full": (2 * L, L)}
    launches = None
    for remat in REMAT_MODES:
        r, d = runs[remat], dry[remat]
        gap = (r["temp"] - d["temp_size_in_bytes"]) / d["temp_size_in_bytes"]
        print(f"[remat] {card}: stablelm-1.6b L={L} fsdp_tp 1-rank NCCL "
              f"mesh, AdamW, {PJIT_MANIFEST['batch_docs']} x "
              f"{PJIT_MANIFEST['data']['seq_len']}, remat {remat}: "
              f"arguments on the card {r['held']} B, counted "
              f"{d['argument_size_in_bytes']} B; temp on the card "
              f"(max_memory_allocated - memory_allocated across the step) "
              f"{r['temp']} B = {r['temp'] / 2**30:.3f} GiB, counted "
              f"{d['temp_size_in_bytes']} B = "
              f"{d['temp_size_in_bytes'] / 2**30:.3f} GiB, gap "
              f"{100 * gap:+.2f}%; peak counted "
              f"{d['peak_bytes_per_device'] / 2**30:.3f} GiB; loss "
              f"{r['loss']:.6f}; step {r['step_s']:.3f} s; launches "
              f"K4 {r['launches'][kfa.NAME]}, K4b "
              f"{r['launches'][kfab.NAME]}")
        if r["held"] != d["argument_size_in_bytes"]:
            raise AssertionError(f"remat {remat}: the card holds "
                                 f"{r['held']} B of arguments, the dry-run "
                                 f"counts {d['argument_size_in_bytes']}")
        if abs(gap) > REMAT_TEMP_TOL:
            raise AssertionError(f"remat {remat}: temp bytes on the card "
                                 f"{r['temp']} vs counted "
                                 f"{d['temp_size_in_bytes']}: {gap:+.4f}")
        got = (r["launches"][kfa.NAME], r["launches"][kfab.NAME])
        if got != want[remat]:
            raise AssertionError(f"remat {remat}: K4/K4b launches {got}, "
                                 f"want {want[remat]}")
        launches = r["launches"] if launches is None else {
            k: launches[k] + v for k, v in r["launches"].items()}
    print(f"[remat] {card}: remat full's loss and every updated leaf "
          f"equal remat none's within atol=rtol {MODEL_TOL}: largest "
          f"difference {diff:.3e}")
    return launches


def drill_config():
    """The drills' configuration: stablelm-1.6b at full width, DRILL_LAYERS
    layers."""
    from repro_torch.configs.registry import get_arch
    return dataclasses.replace(get_arch(SERVE_ARCH), n_layers=DRILL_LAYERS)


def drill_core(workdir, nodes: int, gpus: int):
    """A ``DLaaSCore`` on the card over ``workdir`` (a fresh one, or one a
    crashed core left, which it recovers) with the drills' config, a
    cluster of ``nodes`` simulated nodes of ``gpus`` accounted GPUs each,
    and its object and results stores in host memory (the checkpoints
    stay on disk: recovery reads them there). Health remediation is off,
    as in phase 10."""
    from repro_torch.platform.cluster import Cluster, Node, Resources
    from repro_torch.service.core import DLaaSCore
    cluster = Cluster([Node(f"drill-{i}", Resources(
        cpus=32.0, gpus=gpus, memory_mb=96 * 1024)) for i in range(nodes)])
    core = DLaaSCore(str(workdir), device="cuda", tick_interval=0.005,
                     arch_cfgs={SERVE_ARCH: drill_config()},
                     cluster=cluster,
                     stores={"objectstore": MemoryStore(),
                             "results": MemoryStore()})
    core.health.remediate = False
    return core


def disk_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def drill_prompt():
    """The drills' prompt: phase 4's first (128 tokens, seed 0)."""
    return [int(t) for t in serve_prompts(drill_config(), 0)[0]]


def wait_ready(core, eid, timeout=300):
    poll(lambda: core.endpoint_status(eid)["state"],
         lambda s: s in ("READY", "FAILED", "STOPPED"), timeout, eid)
    if core.endpoint_status(eid)["state"] != "READY":
        raise AssertionError(f"{eid}: {core.endpoint_status(eid)}")


def wait_completed(core, tid, timeout=600):
    st = poll(lambda: core.training_status(tid),
              lambda s: s["status"] in ("COMPLETED", "FAILED", "KILLED"),
              timeout, tid)
    if st["status"] != "COMPLETED":
        raise AssertionError(f"{tid}: {st}")
    plan = core.trainings[tid]["plan"]
    poll(lambda: plan.meta["ps"] is None, bool, 30,
         f"{tid}: parameter server not released")
    return core.training_status(tid)


def losses_of(core, tid):
    s = core.metrics.series(tid, "loss")
    return dict(zip(s.steps, s.values))


def resumed_steps(core, tid, member="learner-0"):
    return [int(line.rsplit("=", 1)[1])
            for line in core.training_logs(tid, member)
            if line.startswith("resumed from checkpoint step=")]


def job_times(core, tid):
    """Where a training's wall time went: {span name: [seconds]} of its
    timeline (plan, queue wait, checkpoint publishes, ...) and the
    learners' step seconds (``round_time_s``)."""
    out = {}
    for sp in core.training_timeline(tid)["spans"]:
        if sp.get("duration_s"):
            out.setdefault(sp["name"], []).append(round(sp["duration_s"], 2))
    out["step"] = [round(v, 3) for v in
                   core.metrics.series(tid, "round_time_s").values]
    return out


def same_losses(label, got, want):
    """``got`` (step -> loss) against the uninterrupted run's ``want`` at
    the same steps, each within DRILL_LOSS_RTOL; the largest relative
    difference."""
    if not got or not set(got) <= set(want):
        raise AssertionError(f"{label}: steps {sorted(got)} against "
                             f"{sorted(want)}")
    worst = max(abs(v - want[k]) / abs(want[k]) for k, v in got.items())
    if worst > DRILL_LOSS_RTOL:
        raise AssertionError(f"{label}: losses {got} against the "
                             f"uninterrupted run's {want}: relative "
                             f"difference {worst:.3e} > {DRILL_LOSS_RTOL}")
    return worst


def drill_launches(torch, ops, cfg, pushes, rounds, shards, prefills=0,
                   int8=False):
    """Check this process's launches since the last reset against
    ``step_launches`` of what the drill did (K2 and K3 only on the int8
    wire), and every flash launch on the tensor cores; returns them."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_attention_bwd as kfab
    torch.cuda.synchronize()
    got = ops.launch_counts()
    want = step_launches(ops, cfg, pushes, rounds, shards, prefills)
    if not int8:
        want.update(quantize_ef=0, dequantize=0)
    tc = {kfa.NAME: kfa.launches_tc, kfab.NAME: kfab.launches_tc}
    if got != want or tc != {k: got[k] for k in tc}:
        raise AssertionError(f"drill launches {got} (on the tensor cores "
                             f"{tc}), want {want}")
    return got


def wait_for(cond, timeout: float) -> bool:
    """Whether ``cond()`` holds within ``timeout`` seconds (polled every
    50 ms)."""
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            return False
        time.sleep(0.05)
    return True


def paused_members(control):
    """The set of task threads waiting at ``control``'s pause gate, kept
    by wrapping the job's ``JobControl.wait_while_paused``: every
    incarnation of the job's bodies passes through it at each step
    boundary."""
    waiting = set()
    gate = control.wait_while_paused

    def counted(should_abort=None):
        me = threading.current_thread()
        if control.paused:
            waiting.add(me)
        try:
            return gate(should_abort)
        finally:
            waiting.discard(me)
    control.wait_while_paused = counted
    return waiting


def drill_child(workdir: str) -> int:
    """Drill b's core process (``chip_smoke.py --drill-child WORKDIR``):
    a ``DLaaSCore`` on the card over ``workdir`` deploys an endpoint
    (fresh weights from seed 0) and answers the drills' prompt, submits
    DRILL_MANIFEST, waits for its first checkpoint on disk, pauses it,
    writes ``marker.json`` and waits to be killed."""
    import torch
    if not torch.cuda.is_available():
        return 2
    core = drill_core(workdir, 1, 4)
    eid = core.deploy_endpoint(
        arch=SERVE_ARCH, capacity=ENDPOINT_SERVING["capacity"],
        max_seq=ENDPOINT_SERVING["max_seq"], max_new=DRILL_NEW,
        idempotency_key="drill-ep")["endpoint_id"]
    wait_ready(core, eid)
    tokens = core.predict(eid, drill_prompt(), max_new=DRILL_NEW)["tokens"]
    mid = core.deploy_model(manifest_yaml(DRILL_MANIFEST))["model_id"]
    tid = core.create_training(mid, idempotency_key="drill-sub")[
        "training_id"]
    poll(lambda: core.metrics.checkpoints(tid), bool, DRILL_CHILD_TIMEOUT,
         "the first checkpoint")
    core.pause_training(tid)        # hold it mid-flight: the kill is mid-job
    first = Path(workdir, "ckpt", tid,
                 f"step_{DRILL_MANIFEST['checkpoint_every']:010d}")
    poll(first.exists, bool, DRILL_CHILD_TIMEOUT, f"{first} published")
    tmp = Path(workdir, "marker.tmp")
    tmp.write_text(json.dumps({
        "tid": tid, "eid": eid, "mid": mid, "tokens": tokens,
        "steps_done": core.training_status(tid)["steps_done"],
        "checkpoints": len(core.metrics.checkpoints(tid))}))
    tmp.rename(Path(workdir, "marker.json"))
    time.sleep(DRILL_CHILD_TIMEOUT)   # the parent kills it here
    return 1


class Drills:
    """Phase 24's state: the drills' config and prompt, the phase's
    baseline device memory, the launches of the drills' path, the bytes
    each drill held on disk, and its workdirs under ``build/``."""

    def __init__(self, torch, ops, card):
        import collections
        from repro_torch.weights import flat_size
        self.torch, self.ops, self.card = torch, ops, card
        self.cfg = drill_config()
        self.F = flat_size(self.cfg)
        self.tag = f"[drills] {card}:"
        self.prompt = drill_prompt()
        self.launches = collections.Counter()
        self.held = {}
        build_dir = ROOT / "build"
        build_dir.mkdir(exist_ok=True)
        self.root = Path(tempfile.mkdtemp(prefix="chip-smoke-drills-",
                                          dir=build_dir))
        atexit.register(shutil.rmtree, self.root, True)
        self.published = 0          # checkpoints the drills wrote
        self.ckpt_bytes = 0         # the bytes of one on disk
        torch.cuda.empty_cache()
        self.base = self.memory()

    def memory(self) -> int:
        gc.collect()
        self.torch.cuda.synchronize()
        return self.torch.cuda.memory_allocated()

    def gib(self, *ns) -> str:
        return " -> ".join(f"{n / 2**30:.2f}" for n in ns) + " GiB"

    def say(self, line: str):
        print(f"{self.tag} {line}", flush=True)

    def start(self, label: str):
        """A drill's workdir; its launches count from here."""
        self.ops.reset_launch_counts()
        self.t0 = time.perf_counter()
        return self.root / label

    def count(self, pushes, rounds, shards, prefills=0, int8=False):
        self.launches.update(drill_launches(
            self.torch, self.ops, self.cfg, pushes, rounds, shards,
            prefills, int8))
        self.ops.reset_launch_counts()

    def finish(self, label, workdir, cores, tid, published) -> int:
        """Count the drill's ``published`` checkpoints, close ``cores``,
        delete the workdir (its size kept), and check the device memory
        is back within SERVICE_MEMORY_SLACK of the phase's baseline;
        returns it."""
        self.published += published
        steps = sorted(Path(workdir, "ckpt", tid).glob("step_*"))
        if steps:
            self.ckpt_bytes = disk_bytes(steps[-1])
        for c in cores:
            c.close()
        self.held[label] = disk_bytes(workdir)
        shutil.rmtree(workdir, ignore_errors=True)
        mem = self.memory()
        if abs(mem - self.base) > SERVICE_MEMORY_SLACK:
            raise AssertionError(f"{label}: {self.gib(mem)} allocated after "
                                 f"the drill, {self.gib(self.base)} before "
                                 f"the phase")
        return mem

    def seconds(self) -> float:
        return time.perf_counter() - self.t0

    def start_child(self):
        """Drill b's core process, started early so that its start
        overlaps drill a."""
        self.wd_b = self.root / "b"
        self.wd_b.mkdir()
        self.child_log = self.root / "b-child.log"
        with open(self.child_log, "wb") as out:
            self.child = subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--drill-child", str(self.wd_b)], stdout=out,
                stderr=subprocess.STDOUT, cwd=str(ROOT))
        child = self.child

        def stop():
            if child.poll() is None:
                child.kill()
                child.wait()
        atexit.register(stop)

    def uninterrupted(self):
        """a. DRILL_MANIFEST through a core: the losses by step and the
        trained model the recoveries are held to."""
        import numpy as np
        m = DRILL_MANIFEST
        wd = self.start("a")
        core = drill_core(wd, 1, 4)
        mid = core.deploy_model(manifest_yaml(m))["model_id"]
        tid = core.create_training(mid)["training_id"]
        st = wait_completed(core, tid)
        self.want = losses_of(core, tid)
        self.want_model = np.load(io.BytesIO(core.download_model(tid)))
        if sorted(self.want) != list(range(m["steps"])) or \
                st["last_loss"] != self.want[m["steps"] - 1] or \
                not all(math.isfinite(v) for v in self.want.values()):
            raise AssertionError(f"a: losses {self.want}, status {st}")
        times = job_times(core, tid)
        self.count(m["steps"], m["steps"], m["ps_shards"])
        mem = self.finish("a", wd, [core], tid,
                          len(core.metrics.checkpoints(tid)))
        self.say(f"a. uninterrupted: {self.seconds():.1f} s, COMPLETED, "
                 f"losses by step {json.dumps(self.want)}; memory "
                 f"{self.gib(self.base, mem)}; seconds {json.dumps(times)}")

    def recovered(self, label, core, tid):
        """Check a recovered training against a: COMPLETED, every loss
        after the resume a's at its step; (its losses, the largest
        relative difference, the trained model's largest difference)."""
        import numpy as np
        wait_completed(core, tid)
        got = losses_of(core, tid)
        rel = same_losses(label, got, self.want)
        model = np.load(io.BytesIO(core.download_model(tid)))
        return got, rel, float(np.abs(model - self.want_model).max())

    def sigkill(self):
        """b. scripts/verify.sh's crash drill on the card: the child core
        is SIGKILLed after its first checkpoint, a fresh core here
        recovers its workdir."""
        import signal
        m = DRILL_MANIFEST
        marker = self.wd_b / "marker.json"
        poll(lambda: marker.exists() or self.child.poll() is not None, bool,
             DRILL_CHILD_TIMEOUT, "the drill child's marker")
        if not marker.exists():
            raise AssertionError(
                f"drill child exited {self.child.returncode}: "
                f"{self.child_log.read_text()[-3000:]}")
        ids = json.loads(marker.read_text())
        os.kill(self.child.pid, signal.SIGKILL)     # no shutdown hook runs
        self.child.wait()
        self.start("b")
        core = drill_core(self.wd_b, 1, 4)
        tid, eid = ids["tid"], ids["eid"]
        rep = core.recovery_report()
        if tid not in rep["trainings"]["resumed"] + \
                rep["trainings"]["requeued"] or \
                eid not in rep["endpoints"]["redeployed"]:
            raise AssertionError(f"b: recovery report {rep}")
        again = core.create_training(ids["mid"],
                                     idempotency_key="drill-sub")
        if again["training_id"] != tid:
            raise AssertionError(f"b: the replayed key gave {again}")
        got, rel, diff = self.recovered("b", core, tid)
        resumed = resumed_steps(core, tid)
        if resumed != [m["steps"] - len(got)]:
            raise AssertionError(f"b: resumed {resumed}, {len(got)} steps")
        wait_ready(core, eid)
        eng = core.endpoints[eid].engine
        tokens = core.predict(eid, self.prompt, max_new=DRILL_NEW)["tokens"]
        if tokens != ids["tokens"]:
            raise AssertionError(f"b: tokens {tokens} after recovery, "
                                 f"{ids['tokens']} before the kill")
        tl = core.training_timeline(tid)
        rec = core._zget(f"/dlaas/jobs/{tid}/record")
        if "recovery" not in {s["name"] for s in tl["spans"]} or \
                tl["trace_id"] != rec["trace_id"]:
            raise AssertionError(f"b: timeline {tl['trace_id']} against "
                                 f"the record's {rec.get('trace_id')}")
        mem_at = self.memory()
        core.stop_endpoint(eid)
        poll(lambda: core.endpoint_status(eid)["state"],
             lambda s: s == "STOPPED", 120, f"{eid} stop")
        poll(lambda: eng.released, bool, 30, f"{eid}: engine not released")
        self.count(len(got), len(got), m["ps_shards"], eng.prefill_batches)
        del eng
        mem = self.finish("b", self.wd_b, [core], tid,
                          ids["checkpoints"]
                          + len(core.metrics.checkpoints(tid)))
        self.say(f"b. SIGKILL of the core process (paused after "
                 f"{ids['steps_done']} steps, its first checkpoint on "
                 f"disk): recovered, COMPLETED {self.seconds():.1f} s after "
                 f"the kill; {rep['trainings']}, endpoints "
                 f"{rep['endpoints']}; resumed from step {resumed[0]}; "
                 f"losses of steps {sorted(got)} within {rel:.3e} of a's "
                 f"(limit {DRILL_LOSS_RTOL}); trained_model.npy max abs "
                 f"diff from a's {diff:.3e}; the endpoint's {len(tokens)} "
                 f"tokens equal the child's; the replayed key gave {tid}; "
                 f"memory {self.gib(self.base, mem_at, mem)}")

    def crash(self):
        """c. CRASH_CORE at step DRILL_CRASH_AT of DRILL_MANIFEST; a second
        core in this process recovers once the zombie's learner has
        returned and its parameter server is freed."""
        from repro_torch.platform.faults import FaultEvent
        m = DRILL_MANIFEST
        wd = self.start("c")
        zombie = drill_core(wd, 1, 4)
        mid = zombie.deploy_model(manifest_yaml(m))["model_id"]
        tid = zombie.create_training(mid)["training_id"]
        ps = zombie.trainings[tid]["plan"].meta["ps"]
        zombie.inject_faults(events=[FaultEvent(
            "crash_core", "", at_step=DRILL_CRASH_AT, job_id=tid)])
        poll(lambda: zombie.crashed, bool, 600, "c: the crash")
        mem_crash = self.torch.cuda.memory_allocated()
        poll(lambda: ps.released, bool, 120, "c: the zombie's PS released")
        zombie_steps = len(losses_of(zombie, tid))
        zombie_rounds = ps.stats()["agg_rounds"]
        del ps
        mem_zombie = self.memory()
        core = drill_core(wd, 1, 4)
        rep = core.recovery_report()
        got, rel, diff = self.recovered("c", core, tid)
        resumed = resumed_steps(core, tid)
        self.count(zombie_steps + len(got), zombie_rounds + len(got),
                   m["ps_shards"])
        mem = self.finish("c", wd, [core, zombie], tid,
                          len(zombie.metrics.checkpoints(tid))
                          + len(core.metrics.checkpoints(tid)))
        self.say(f"c. CRASH_CORE at step {DRILL_CRASH_AT}: the zombie ran "
                 f"{zombie_steps} steps, its PS freed once its learner "
                 f"returned ({self.gib(mem_crash, mem_zombie)}); recovered "
                 f"{rep['trainings']}, resumed from step {resumed}; losses "
                 f"of steps {sorted(got)} within {rel:.3e} of a's; "
                 f"trained_model.npy max abs diff {diff:.3e}; "
                 f"{self.seconds():.1f} s; memory "
                 f"{self.gib(self.base, mem_crash, mem)}")

    def node_kill(self):
        """d. DRILL_NODE_MANIFEST on two nodes, paused at a step boundary
        once DRILL_PAUSE_AT steps are done; the node under the learners
        killed, the learners re-placed on the other and resumed from the
        last checkpoint."""
        import collections
        from repro_torch.platform.cluster import RUNNING
        from repro_torch.platform.faults import FaultEvent, KILL
        nm = DRILL_NODE_MANIFEST
        n = nm["learners"]
        wd = self.start("d")
        core = drill_core(wd, 2, 4)
        mid = core.deploy_model(manifest_yaml(nm))["model_id"]
        tid = core.create_training(mid)["training_id"]
        ps = core.trainings[tid]["plan"].meta["ps"]
        waiting = paused_members(core.trainings[tid]["plan"].control)

        def diagnose(what):
            logs = {k: [line for line in core.training_logs(tid, k)
                        if "loss=" not in line]
                    for k in (f"learner-{i}" for i in range(n))}
            apps = {a.app_id: {t.task_id: (t.state, t.node, t.restarts,
                                           t.message)
                               for t in a.tasks.values()}
                    for a in core.scheduler.apps.values()}
            steps = collections.Counter(
                core.metrics.series(tid, "loss").steps)
            return (f"d: {what}; logs {logs}; tasks {apps}; losses by "
                    f"step {dict(steps)}; data plane {ps.stats()}")

        poll(lambda: core.training_status(tid)["steps_done"],
             lambda k: k >= DRILL_PAUSE_AT, 600, "d: steps before the pause")
        # paused at one step boundary: under BSP a learner past the
        # boundary when the pause lands waits in its push for the
        # other's, and the kill would end that round with one learner;
        # let it finish first
        for _ in range(5):
            core.pause_training(tid)
            if wait_for(lambda: len(waiting) == n, 60):
                break
            core.resume_training(tid)
        else:
            raise AssertionError(diagnose("never paused at one step"))
        mem_victim = self.memory()
        app = core.scheduler.apps[f"{tid}-learners"]
        victim = next(t.node for t in app.tasks.values()
                      if t.state == RUNNING)
        victim_steps = core.training_status(tid)["steps_done"]
        core.inject_faults(events=[
            FaultEvent(KILL, victim, at_tick=core.cluster.clock + 1)])

        def live_clients():
            return [c for c in list(ps._clients) if c._err is not None]
        if not wait_for(lambda: (all(t.state == RUNNING and t.node != victim
                                     for t in app.tasks.values())
                                 and len(waiting) == n
                                 and len(live_clients()) == n), 300):
            raise AssertionError(diagnose("no re-placed learners at their "
                                          "first step"))
        mem_survivor = self.memory()
        n_clients = len(list(ps._clients))
        if mem_survivor > mem_victim + SERVICE_MEMORY_SLACK or \
                len(ps._pull_bufs) != n:
            raise AssertionError(diagnose(
                f"{self.gib(mem_survivor)} at the surviving incarnation's "
                f"first step, {self.gib(mem_victim)} at the victim's last; "
                f"pull buffers {sorted(ps._pull_bufs)}"))
        core.resume_training(tid)
        st = wait_completed(core, tid)
        restarts = sum(t.restarts for t in app.tasks.values())
        every = nm["checkpoint_every"]
        resumed = {k: resumed_steps(core, tid, f"learner-{k}")
                   for k in range(n)}
        model = core.download_model(tid)
        dp = st["data_plane"]
        n_loss = len(core.metrics.series(tid, "loss").values)
        if st["steps_done"] != nm["steps"] or restarts != n or \
                any(r != [every * (victim_steps // every)]
                    for r in resumed.values()) or \
                len(model) < self.F * 4 or dp["push_count"] != n_loss or \
                dp["agg_rounds"] * n != dp["push_count"]:
            raise AssertionError(diagnose(
                f"{st}, restarts {restarts}, resumed {resumed}, model "
                f"{len(model)} bytes"))
        times = job_times(core, tid)
        self.count(dp["push_count"], dp["agg_rounds"], nm["ps_shards"],
                   int8=nm["compression"] == "int8")
        del ps, model
        mem = self.finish("d", wd, [core], tid,
                          len(core.metrics.checkpoints(tid)))
        self.say(f"d. node kill under the PS learners ({n} learners, "
                 f"{nm['ps_shards']} shards, adam, int8, BSP): {victim} "
                 f"killed after {victim_steps} steps, restarts {restarts}, "
                 f"resumed from step {resumed}, COMPLETED "
                 f"{st['steps_done']} steps, trained_model.npy uploaded; "
                 f"{dp['push_count']} pushes, {dp['agg_rounds']} rounds; "
                 f"clients {n_clients}, {n} with buffers; memory at the "
                 f"victim's last step -> the survivor's first -> after "
                 f"{self.gib(mem_victim, mem_survivor, mem)}; "
                 f"{self.seconds():.1f} s; seconds {json.dumps(times)}")

    def serving_kill(self):
        """e. An endpoint on two single-GPU nodes; a request submitted
        while serving is paused, then its node killed."""
        from repro_torch.platform.cluster import RUNNING
        from repro_torch.platform.faults import FaultEvent, KILL
        from repro_torch.serving.engine import InferenceEngine
        wd = self.start("e")
        bare = InferenceEngine(self.cfg,
                               capacity=ENDPOINT_SERVING["capacity"],
                               max_seq=ENDPOINT_SERVING["max_seq"], seed=0,
                               device="cuda")
        bare.start()
        worker = threading.Thread(target=bare.run, daemon=True)
        worker.start()
        r = bare.submit(self.prompt, max_new=DRILL_NEW)
        if not r.wait(300) or r.status != "DONE":
            raise AssertionError(f"e: bare engine {r.status} {r.error}")
        want = r.tokens
        bare.drain()
        worker.join(60)
        bare.release()
        del bare, worker
        self.torch.cuda.empty_cache()
        self.ops.reset_launch_counts()      # the comparison's launches out
        core = drill_core(wd, 2, 1)
        eid = core.deploy_endpoint(
            arch=SERVE_ARCH, capacity=ENDPOINT_SERVING["capacity"],
            max_seq=ENDPOINT_SERVING["max_seq"],
            max_new=DRILL_NEW)["endpoint_id"]
        wait_ready(core, eid)
        warm = core.predict(eid, self.prompt, max_new=DRILL_NEW)["tokens"]
        eng = core.endpoints[eid].engine
        mem_before = self.memory()
        core.pause_training(eid)        # hold serving at a batch boundary
        req = eng.submit(self.prompt, max_new=DRILL_NEW)
        app = core.scheduler.apps[f"{eid}-servers"]
        victim = next(t.node for t in app.tasks.values()
                      if t.state == RUNNING)
        core.inject_faults(events=[
            FaultEvent(KILL, victim, at_tick=core.cluster.clock + 1)])
        poll(lambda: any(t.state == RUNNING and t.node != victim
                         for t in app.tasks.values()), bool, 120,
             "e: endpoint re-placed")
        wait_ready(core, eid)
        mem_ready = self.memory()
        core.resume_training(eid)
        if not req.wait(300) or req.status != "DONE":
            raise AssertionError(f"e: request {req.status} {req.error}")
        if req.tokens != want or warm != want or \
                not core.scheduler.faults.done():
            raise AssertionError(f"e: tokens {req.tokens} (warm {warm}) "
                                 f"against an undisturbed engine's {want}")
        if mem_ready > mem_before + SERVICE_MEMORY_SLACK:
            raise AssertionError(f"e: {self.gib(mem_ready)} READY again, "
                                 f"{self.gib(mem_before)} before the kill")
        core.stop_endpoint(eid)
        poll(lambda: core.endpoint_status(eid)["state"],
             lambda s: s == "STOPPED", 120, f"{eid} stop")
        poll(lambda: eng.released, bool, 30, f"{eid}: engine not released")
        prefills = eng.prefill_batches
        self.count(0, 0, 0, prefills)
        del eng
        mem = self.finish("e", wd, [core], eid, 0)
        self.say(f"e. serving node killed with a request queued: {victim} "
                 f"killed, re-placed, the request DONE with an undisturbed "
                 f"engine's {len(want)} tokens; {prefills} prefill batches; "
                 f"memory before the kill -> READY again -> after "
                 f"{self.gib(mem_before, mem_ready, mem)}; "
                 f"{self.seconds():.1f} s")

    def disk(self):
        held = {k: round(v / 2**30, 2) for k, v in self.held.items()}
        self.say(f"disk: {self.published} checkpoints of "
                 f"{self.ckpt_bytes:,} bytes written "
                 f"({self.published * self.ckpt_bytes / 2**30:.2f} GiB, the "
                 f"child's included); held at each drill's end (then "
                 f"deleted) {json.dumps(held)} GiB")
        shutil.rmtree(self.root, ignore_errors=True)


def drills_phase(torch, ops, card):
    """Phase 24: the paper's fault tolerance on the card (see the module
    docstring). Returns the launches of the drills' path."""
    d = Drills(torch, ops, card)
    d.say(f"stablelm-1.6b d={d.cfg.d_model} L={d.cfg.n_layers} bf16 (F = "
          f"{d.F:,}); baseline {d.gib(d.base)} allocated")
    d.start_child()
    d.uninterrupted()
    d.sigkill()
    d.crash()
    d.node_kill()
    d.serving_kill()
    d.disk()
    return dict(d.launches)


# ---------------------------------------------------------------------------
# Phase 25: the dense archs that no earlier phase runs
# ---------------------------------------------------------------------------


def qkv_bias_draw(torch, seed):
    """A ``prepare`` for ``serve`` and ``prefill_vs_decode``: the
    attention's ``bq``/``bk``/``bv`` (init zeros, so on fresh weights
    the forward's add does nothing) drawn in place, N(0, QKV_BIAS_STD^2)
    from generators seeded ``seed``, ``seed + 1``, ``seed + 2``, as
    tests/test_torch_model.py:_setup draws them on the CPU."""
    def prepare(params):
        attn = params["blocks"]["attn"]
        for j, name in enumerate(("bq", "bk", "bv")):
            t = attn[name]
            g = torch.Generator(device=t.device).manual_seed(seed + j)
            with torch.no_grad():
                t.copy_(torch.randn(t.shape, generator=g, device=t.device)
                        .mul_(QKV_BIAS_STD))
            if not t.abs().max().item() > 0:
                raise AssertionError(f"{name} still zero after its draw")
    return prepare


def qkv_unit_draw(torch, d_model, seed, then=None):
    """A ``prepare`` that redraws ``wq``/``wk``/``wv`` in place at std
    ``d_model``^-1/2 (the fan-in of their contraction) from a generator
    seeded ``seed``, so the scores have unit scale, then runs ``then``
    (e.g. ``qkv_bias_draw``'s) if given."""
    def prepare(params):
        attn = params["blocks"]["attn"]
        g = torch.Generator(device=attn["wq"].device).manual_seed(seed)
        for name in ("wq", "wk", "wv"):
            t = attn[name]
            with torch.no_grad():
                t.copy_(torch.randn(t.shape, generator=g, device=t.device)
                        .mul_(d_model ** -0.5))
        if then is not None:
            then(params)
    return prepare


def decode_least_bytes(cfg, params, requests, decode_steps, capacity):
    """Mean bytes a batched decode step of a serve of ``requests``
    (prompt length, max_new) must read at the least: every weight of the
    blocks, the final norm and the head, one embedding row a slot, and
    the cache rows (K and V of every layer, in the cache's bf16) its
    live slots see, averaged over the serve's ``decode_steps`` (a
    request of prompt p and m tokens decodes m - 1 steps, seeing p + 1,
    ..., p + m - 1 rows)."""
    from repro_torch.models.layers import iter_leaves
    weights = sum(t.numel() * t.element_size()
                  for key in ("blocks", "final_norm", "head")
                  for _, t in iter_leaves({key: params[key]}))
    embed = capacity * cfg.d_model * params["embed"].element_size()
    row = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.hd * 2
    rows = sum((m - 1) * p + (m - 1) * m // 2 for p, m in requests)
    return weights + embed + row * rows / decode_steps


def dense_kernels(torch, ops, ref, cfg, train, i, card):
    """25 a: K4 causal at (1, DENSE_K4_SEQ) and K4 with its LSE and K4b
    at the train shape ``train`` (B, S) of ``cfg``'s heads, bf16,
    against their plain versions (``check_attention``,
    ``check_attention_bwd``: TOL["bfloat16"], BWD_BF16_REL_L2, two calls
    equal in their bits), each on the tensor cores. Returns (K4
    results, K4b results)."""
    B, S = train
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    k4 = check_attention(torch, ops, ref, (1, DENSE_K4_SEQ, H, KV, hd,
                                           "bfloat16", True), seed=250 + i)
    torch.cuda.empty_cache()
    k4b = check_attention_bwd(torch, ops, ref, (B, S, H, KV, hd, "bfloat16",
                                                True, 0), seed=260 + i)
    torch.cuda.empty_cache()
    print(f"[kernel] {card}: K4 dense_archs {cfg.arch_id} {json.dumps(k4)}")
    print(f"[kernel] {card}: K4 with LSE and K4b dense_archs {cfg.arch_id} "
          f"{json.dumps(k4b)}")
    for label, r in (("K4", k4), ("K4 with LSE", k4b["fwd"]), ("K4b", k4b)):
        if r["instance"] != "tensor cores":
            raise AssertionError(f"{label} at {r['shape']} off the tensor "
                                 f"cores")
        sh = r["shape"]
        print(f"[kernel] {card}: {label} at ({sh['B']}, {sh['S']}, {H}, KV "
              f"{KV}, hd {hd}) bf16 causal ({cfg.arch_id}, group {H // KV}):"
              f" {r['ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}) = {r['share_of_bound']:.4f} of it; plain "
              f"{r['plain_ms']:.3f} ms; SDPA {r['library_ms']:.4f} ms, "
              f"{r['x_library']:.2f} x; two calls equal in their bits")
    return [k4, k4b["fwd"]], [k4b]


def dense_serve(torch, ops, kfa, cfg, full, prepare, card):
    """25 b: ``cfg`` behind ``InferenceEngine`` with SERVE_REQUESTS
    (``prepare`` edits the started engine's weights), the checks and the
    numbers of the module docstring; the DENSE_PROFILED arch's serve
    again under the profiler, of its first requests; then prefill
    against decode at 2 layers in f32 (held with wq, wk, wv at unit
    scale; printed at the init's). Returns the serve's launches."""
    from repro_torch.analysis.roofline import HBM_BW
    from repro_torch.weights import flat_size
    tokens, eng, rec, launches, wall, _ = serve(torch, cfg, ops, 0, card,
                                                prepare=prepare)
    st = eng.stats()
    n_batches = eng.prefill_batches
    want = dict.fromkeys(launches, 0)
    want[kfa.NAME] = cfg.n_layers * n_batches
    if launches != want or kfa.launches_tc != want[kfa.NAME]:
        raise AssertionError(f"{cfg.arch_id} serve launches {launches} "
                             f"({kfa.launches_tc} K4 on the tensor cores); "
                             f"want {want}, all on the tensor cores")
    snap = wait_perf(eng)
    check_perf(snap, f"serve-{cfg.arch_id}")
    n_tok = st["tokens_out_total"]
    decode_ms = 1e3 * eng.decode_seconds / st["decode_steps"]
    least = decode_least_bytes(cfg, eng.params, SERVE_REQUESTS,
                               st["decode_steps"], eng.capacity)
    bound_ms = 1e3 * least / HBM_BW
    share = bound_ms / decode_ms
    if not 0 < share <= 1:
        raise AssertionError(f"{cfg.arch_id}: decode {decode_ms} ms a step "
                             f"against a bound of {bound_ms} ms")
    by_batch = ", ".join(f"{nb}x{pl} {1e3 * t:.2f}" for (nb, pl), t
                         in zip(rec.prefills, rec.prefill_s))
    print(f"[serve-dense] {card}: {cfg.arch_id} L={cfg.n_layers} of "
          f"{full.n_layers}, d={cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} of hd {cfg.hd}, vocab {cfg.vocab_size}, "
          f"{flat_size(cfg):,} parameters, bf16, capacity 4, max_seq 1024: "
          f"weights + cache ready in {rec.ready_s:.2f} s; "
          f"{st['completed_total']} requests, {n_tok} tokens in {wall:.3f} "
          f"s = {n_tok / wall:.1f} tokens/s; prefill ms by batch (n x "
          f"plen): {by_batch}; mean "
          f"{1e3 * eng.prefill_seconds / n_batches:.2f} ms a batch; decode "
          f"{st['decode_steps']} steps: "
          f"{decode_ms:.3f} ms a step, bound {bound_ms:.3f} ms ("
          f"{least / 1e9:.3f} GB a step reads at the least: every weight, "
          f"the live slots' visible cache, at {HBM_BW / 1e12} TB/s) = "
          f"{share:.3f} of it; status.perf {snap['pct_of_attainable']:.2f}% "
          f"of attainable; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches} (all K4 on the tensor cores)")
    eng.release()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if cfg.arch_id == DENSE_PROFILED[0]:
        run = serve(torch, cfg, ops, 0, card, profile=True, prepare=prepare,
                    requests=DENSE_PROFILED[1])
        st = run[1].stats()
        step_ms = 1e3 * run[1].decode_seconds / st["decode_steps"]
        print(f"[serve-dense] {card}: {cfg.arch_id} profiled: "
              f"{len(DENSE_PROFILED[1])} requests, {st['tokens_out_total']} "
              f"tokens in {run[4]:.3f} s; decode {st['decode_steps']} "
              f"steps: {step_ms:.3f} ms a step under the profiler")
        check_tc_names(print_profile(run[5], run[4], card),
                       f"serve-{cfg.arch_id}")
        run[1].release()
        del run
        gc.collect()
        torch.cuda.empty_cache()

    cut = dataclasses.replace(full, n_layers=2, dtype="float32")
    prompt = list(range(1000, 1040))
    score_std = full.d_model / math.sqrt(full.n_heads * full.n_kv_heads)
    raw = prefill_vs_decode(torch, cut, prompt, prepare=prepare)
    rel = prefill_vs_decode(torch, cut, prompt, prepare=qkv_unit_draw(
        torch, cut.d_model, QK_CHECK_SEED, prepare))
    print(f"[serve-dense] {card}: {cfg.arch_id} d={cut.d_model} L=2 "
          f"float32{' (bq, bk, bv non-zero)' if prepare else ''}: prefill "
          f"vs decode logits, relative L2 {rel:.3e} with wq, wk, wv at std "
          f"d^-1/2 (limit {PREFILL_DECODE_RTOL}); {raw:.3e} at the init's "
          f"fan-in rule (scores of std ~{score_std:.0f}: f32 rounding, "
          f"not held)")
    if rel > PREFILL_DECODE_RTOL:
        raise AssertionError(f"{cfg.arch_id} prefill vs decode logits "
                             f"differ by {rel} > {PREFILL_DECODE_RTOL}")
    torch.cuda.empty_cache()
    return launches


def dense_train(torch, ops, kfa, kfab, tcfg, train, prepare, i, card):
    """25 c: DENSE_STEPS steps of ``family_train`` (AdamW) on one batch
    of ``train`` (B, S) tokens: the losses fall, K4 with its LSE and K4b
    once a layer a step on the tensor cores, the share of attainable in
    (0, 100]; with QKV biases their gradients at the trained weights
    finite and non-zero. Returns the steps' launches."""
    import numpy as np
    from repro_torch.distributed import steps
    from repro_torch.models import make_model
    B, S = train
    L = tcfg.n_layers
    model = make_model(tcfg, opts=NO_REMAT)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    if prepare is not None:
        prepare(params)
    toks = torch.from_numpy(np.random.RandomState(25 + i).randint(
        0, tcfg.vocab_size, size=(B, S + 1))).to("cuda")
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    stats = {}
    ops.reset_launch_counts()
    params = family_train(torch, model, params, batch, DENSE_STEPS, B * S,
                          card, f"train-{tcfg.arch_id}", stats=stats)
    launches = ops.launch_counts()
    want = dict.fromkeys(launches, 0)
    want[kfa.NAME] = want[kfab.NAME] = L * DENSE_STEPS
    tc = (kfa.launches_tc, kfab.launches_tc)
    if launches != want or tc != (L * DENSE_STEPS,) * 2:
        raise AssertionError(f"{tcfg.arch_id} train launches {launches}, on "
                             f"the tensor cores {tc}; want {want}, all on "
                             f"them")
    if not 0 < stats["pct"] <= 100:
        raise AssertionError(f"{tcfg.arch_id}: {stats['pct']}% of the "
                             f"step's least work")
    print(f"[train-dense] {card}: {tcfg.arch_id} L={L} d={tcfg.d_model} "
          f"bf16, {B} x {S} tokens, AdamW: step ms {stats['ms']} (warm "
          f"median {stats['warm_ms']:.2f}) beside the bound of least work "
          f"{stats['bound_ms']:.2f} ms ({stats['bound_by']}) = "
          f"{stats['pct']:.2f}%; losses {stats['losses']}; peak device "
          f"memory {stats['peak_gib']:.2f} GiB; launches {launches}")
    if tcfg.qkv_bias:
        _, grads = steps.value_and_grad(model, params, batch)
        norms = {}
        for name in ("bq", "bk", "bv"):
            gb = grads["blocks"]["attn"][name].float()
            norms[name] = gb.norm().item()
            if not torch.isfinite(gb).all().item() or not norms[name] > 0:
                raise AssertionError(f"{tcfg.arch_id}: the gradient of "
                                     f"{name} is not finite and non-zero: "
                                     f"norm {norms[name]}")
        del grads
        print(f"[train-dense] {card}: {tcfg.arch_id}: the QKV biases' "
              f"gradients at the trained weights, finite, L2 norms "
              f"{json.dumps({k: round(v, 6) for k, v in norms.items()})}")
    del params, batch, toks
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def dense_smoke_step(torch, ops, kfa, kfab, arch, card):
    """25 c: ``family_step_card_vs_cpu`` of ``arch``'s smoke reduction
    on 2 x 32 tokens (granite-20b's is MQA: 4 heads on one KV head)."""
    import numpy as np

    def batch_fn(c, device):
        toks = torch.from_numpy(np.random.RandomState(7).randint(
            0, c.vocab_size, size=(2, 33)))
        return {"tokens": toks[:, :-1].contiguous().to(device),
                "labels": toks[:, 1:].contiguous().to(device)}
    scfg, loss_err, grad_err, _, sl, _ = family_step_card_vs_cpu(
        torch, ops, arch, batch_fn)
    if (sl[kfa.NAME], sl[kfab.NAME]) != (scfg.n_layers,) * 2:
        raise AssertionError(f"{arch} smoke step launches {sl}")
    print(f"[dense-step] {card}: {scfg.arch_id} f32 L={scfg.n_layers}, "
          f"{scfg.n_heads} heads over {scfg.n_kv_heads}, card (K4, K4b) vs "
          f"CPU: loss err {loss_err:.3e} (limit {STEP_LOSS_TOL}), gradient "
          f"max abs err {grad_err:.3e} (atol=rtol {STEP_GRAD_TOL}) over "
          f"every leaf")


def dense_archs_phase(torch, ops, ref, kfa, kfab, card):
    """Phase 25 (see the module docstring): each of DENSE_CELLS in turn,
    its weights, caches and optimizer state freed before the next, the
    device memory then within SERVICE_MEMORY_SLACK of the phase's
    baseline. Returns (K4 results, K4b results, the launches of the
    serves and train steps: the path ``dense_archs``)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import autotune
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    print(f"[dense] {card}: {memory_line(torch, 'before phase 25:')}")
    k4s, k4bs, total = [], [], {}
    for i, cell in enumerate(DENSE_CELLS):
        t0, tuned0 = time.perf_counter(), autotune.tuning_seconds
        full = get_arch(cell["arch"])
        L, B, S = cell["train"]
        prepare = qkv_bias_draw(torch, 25 + 3 * i) if full.qkv_bias \
            else None
        parts, mark = {}, [t0]

        def part(name):
            now = time.perf_counter()
            parts[name] = round(now - mark[0], 1)
            mark[0] = now
        k4, k4b = dense_kernels(torch, ops, ref, full, (B, S), i, card)
        part("a kernels")
        cfg = dataclasses.replace(full, n_layers=cell["serve_layers"])
        served = dense_serve(torch, ops, kfa, cfg, full, prepare, card)
        part("b serve")
        tcfg = dataclasses.replace(full, n_layers=L)
        trained = dense_train(torch, ops, kfa, kfab, tcfg, (B, S), prepare,
                              i, card)
        part("c train")
        if cell["arch"] in DENSE_SMOKE_ARCHS:
            dense_smoke_step(torch, ops, kfa, kfab, cell["arch"], card)
            part("c smoke step")
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() - base
        print(f"[dense] {card}: {cell['arch']} done in "
              f"{time.perf_counter() - t0:.1f} s ({json.dumps(parts)}; the "
              f"tuner measured {autotune.tuning_seconds - tuned0:.3f} s of "
              f"it); freed: "
              f"{memory_line(torch, 'now')}, {left / 2**30:+.3f} GiB from "
              f"the phase's baseline (limit "
              f"{SERVICE_MEMORY_SLACK / 2**30} GiB)")
        if abs(left) > SERVICE_MEMORY_SLACK:
            raise AssertionError(f"{cell['arch']}: {left / 2**30:.3f} GiB "
                                 f"left on the card after it was freed")
        for k in served:
            total[k] = total.get(k, 0) + served[k] + trained[k]
        k4s += k4
        k4bs += k4b
    print(f"[dense] {card}: path dense_archs launches {json.dumps(total)}")
    return k4s, k4bs, total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_attention_bwd as kfab
    from repro_torch.kernels import ps_aggregate as kagg
    from repro_torch.kernels import quantize as kq
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.kernels import ssd_scan_bwd as kssdb

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fresh_autotune_cache()
    card = card_line()
    print(card)
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # the dry-run child (phase 23) counts on the meta device, with no
    # card, while the card phases run
    dry_child = start_dryrun_child()
    clock = PhaseClock()
    clock.done("1 device")

    # 2. build
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"[build] {len(built)} kernel librar(ies) in "
          f"{time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{n} {r.seconds:.2f} s" for n, r in built.items()))
    for r in built.values():
        if r.name in TC_LIBS + ("ssd_scan_bwd",):
            continue                  # per kernel below, by name
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {r.name}: {line.strip()}")
    hgmma, ptxas_reports = report_tc_build(build, built, card)
    k5b_ptxas = ptxas_reports["ssd_scan_bwd"]
    clock.done("2 build")

    # 3. kernel against its plain version
    for shape in [(1, 512, 32, 32, 64, "bfloat16", True),
                  (2, 256, 8, 2, 128, "float32", False),
                  (3, 37, 4, 2, 16, "float32", True)]:
        res = check_attention(torch, ops, ref, shape)
        print(f"[kernel] {card}: {json.dumps(res)}")
    # head dim 112 (kimi-k2): the hd-128 tiles with zero-filled columns
    k4_hd112 = [check_attention(torch, ops, ref, shape, seed=3 + i, sk=sk)
                for i, (shape, sk) in enumerate(K4_HD112_CASES)]
    for res in k4_hd112:
        print(f"[kernel] {card}: K4 at hd 112 {json.dumps(res)}")
    clock.done("3 kernel")

    # 4. serve at full width: cold (first use of every library kernel),
    # then warm with the same seed (same tokens), then warm under the
    # profiler (device busy share and where the device time goes)
    cfg = dataclasses.replace(get_arch(SERVE_ARCH), n_layers=SERVE_LAYERS)
    runs = []
    for label in ("cold", "warm", "profiled"):
        run = serve(torch, cfg, ops, 0, card, profile=label == "profiled")
        tokens, eng, rec, launches, wall = run[:5]
        prefills = rec.prefills
        st = eng.stats()
        n_batches = eng.prefill_batches
        if launches[kfa.NAME] != cfg.n_layers * n_batches:
            raise AssertionError(f"flash launches {launches} != {cfg.n_layers}"
                                 f" x {n_batches} prefill batches")
        if len(prefills) != n_batches or n_batches < 2:
            raise AssertionError(f"prefill batches {prefills}: no mid-flight "
                                 f"join")
        if st["mean_batch_occupancy"] <= 0.5:
            raise AssertionError(f"mean occupancy "
                                 f"{st['mean_batch_occupancy']}")
        if runs and tokens != runs[0][0]:
            raise AssertionError("same seed, same requests, different tokens")
        n_tok = st["tokens_out_total"]
        print(f"[serve] {card}: {label}: {SERVE_ARCH} L={cfg.n_layers} "
              f"d={cfg.d_model} bf16, capacity 4, max_seq 1024: "
              f"{st['completed_total']} requests, {n_tok} tokens in "
              f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s; prefill batches "
              f"{prefills} (n, plen): "
              f"{1e3 * eng.prefill_seconds / n_batches:.2f} ms per batch; "
              f"decode {st['decode_steps']} steps: "
              f"{1e3 * eng.decode_seconds / st['decode_steps']:.2f} ms per "
              f"step; mean occupancy {st['mean_batch_occupancy']}; request "
              f"latency p50 {st['p50_latency_s']} s, p99 "
              f"{st['p99_latency_s']} s (8 requests); peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB; kernel launches {launches}")
        if label == "profiled":
            check_tc_names(print_profile(run[5], wall, card), "serve")
        eng.release()
        runs.append((tokens, prefills, launches))
        del eng, run
        torch.cuda.empty_cache()
    print(f"[serve] {card}: {len(runs)} engines, same seed: identical tokens")
    _, prefills, serve_launches = runs[0]

    # the model's output against an independent path: full width, 2
    # layers, f32 (at 24 layers, or in bf16, rounding differences between
    # any two paths grow through the random stack past any useful limit)
    cut = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    rel = prefill_vs_decode(torch, cut, [int(t) for t in range(1000, 1040)])
    print(f"[serve] {card}: {SERVE_ARCH} d={cfg.d_model} L=2 float32: "
          f"prefill vs decode logits, relative L2 {rel:.3e} (limit "
          f"{PREFILL_DECODE_RTOL})")
    if rel > PREFILL_DECODE_RTOL:
        raise AssertionError(f"prefill vs decode logits differ by {rel} > "
                             f"{PREFILL_DECODE_RTOL}")

    # the kernel at every prefill shape the serve gave it
    main_path = [check_attention(torch, ops, ref,
                                 (n, plen, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.hd, "bfloat16", True), seed=i)
                 for i, (n, plen) in enumerate(sorted(set(prefills)))]
    for res in main_path:
        print(f"[kernel] {card}: main path {json.dumps(res)}")
    clock.done("4 serve")

    # 5. the ssm serve: K5 against its plain version, mamba2-1.3b at full
    # width and depth through the engine, prefill against decode
    ssd_main, ssd_others, ssm_launches = serve_ssm(torch, ops, ref, kssd,
                                                   card)
    torch.cuda.empty_cache()
    clock.done("5 serve-ssm")

    # 6. the training slice's kernels against their plain versions
    tcfg = dataclasses.replace(get_arch(SERVE_ARCH),
                               n_layers=TRAIN_ARCH_LAYERS)
    from repro_torch.core.software_ps import ShardLayout
    from repro_torch.weights import flat_size
    lay = ShardLayout.build(flat_size(tcfg), TRAIN["n_shards"])
    agg_errs = {}
    for solver in ("sgd", "momentum", "adam", "easgd_center", "average"):
        for nl, f in ((2, 2048), (8, 4096), (3, 9 * 256)):
            errs = check_ps_aggregate(torch, ops, ref, nl, f, solver)
            agg_errs[f"{solver} ({nl}, {f})"] = max(errs.values())
    print(f"[kernel] {card}: K1 ps_aggregate, 3 rounds each, max abs err "
          f"by solver and shape: {json.dumps(agg_errs)}")
    k1 = time_ps_aggregate(torch, ops, ref, TRAIN["n_learners"],
                           lay.shard_len)
    print(f"[kernel] {card}: K1 at the run's shard: {json.dumps(k1)}")
    torch.cuda.empty_cache()
    for n in (4096, 1 << 20):
        g = torch.Generator(device="cuda").manual_seed(n)
        for label, (x, e) in (
                ("random", (torch.randn(n, generator=g, device="cuda"),
                            0.1 * torch.randn(n, generator=g,
                                              device="cuda"))),
                ("ties", ties(torch, n, n))):
            res = check_quantize(torch, ops, ref, x, e)
            xb = x.to(torch.bfloat16)
            resb = check_quantize(torch, ops, ref, xb, e)
            print(f"[kernel] {card}: K2/K3 n={n} {label}: q mismatches, "
                  f"scale err, err err, dequantize err: f32 x {res}, "
                  f"bf16 x {resb}")
    # the learner pushes its gradient in the model dtype
    k2, k3 = time_quantize(torch, ops, ref, lay.padded,
                           getattr(torch, tcfg.dtype))
    print(f"[kernel] {card}: K2 at the run's push length: {json.dumps(k2)}")
    print(f"[kernel] {card}: K3 at the run's push length: {json.dumps(k3)}")
    torch.cuda.empty_cache()
    train_shapes = [(t["batch_docs"], t["seq_len"], tcfg.n_heads,
                     tcfg.n_kv_heads, tcfg.hd, "bfloat16", True)
                    for t in (TRAIN, TRAIN_LONG)]
    bwd = [check_attention_bwd(torch, ops, ref, shape) for shape in (
        train_shapes[0] + (0,),
        (2, 256, 8, 2, 128, "float32", False, 0),
        (3, 37, 4, 2, 16, "float32", True, 9),
        train_shapes[1] + (0,))]
    for res in bwd:
        print(f"[kernel] {card}: K4 with LSE and K4b: {json.dumps(res)}")
        torch.cuda.empty_cache()
    train_fwd = [check_attention(torch, ops, ref, s) for s in train_shapes]
    for res in train_fwd:
        print(f"[kernel] {card}: K4 at a training shape: {json.dumps(res)}")
    for label, res in (("K4", train_fwd[-1]), ("K4b", bwd[-1])):
        print(f"[kernel] {card}: {label} at {res['shape']}: "
              f"{res['ms']:.4f} ms = {res['x_library']:.2f} x SDPA "
              f"({res['library_ms']:.4f} ms; limit {TC_MAX_X_SDPA} x), "
              f"{res['share_of_bound']:.3f} of its bound")
        if res["x_library"] > TC_MAX_X_SDPA:
            raise AssertionError(f"{label} takes {res['x_library']:.2f} x "
                                 f"SDPA at the model's context (limit "
                                 f"{TC_MAX_X_SDPA})")
    torch.cuda.empty_cache()
    clock.done("6 kernels of training")

    # 7. a training step on the card against the CPU (smoke width, f32)
    loss_err, grad_err, round_err = step_card_vs_cpu(torch, ops)
    print(f"[step] {card}: stablelm-1.6b-smoke f32, card vs CPU: loss err "
          f"{loss_err:.3e} (limit {STEP_LOSS_TOL}), flat gradient max abs "
          f"err {grad_err:.3e} (atol=rtol {STEP_GRAD_TOL}); one int8 + adam "
          f"PS round, 2 learners: params max abs err {round_err:.3e} "
          f"(limit {ROUND_PARAM_TOL})")
    clock.done("7 step")

    # 8. full-width training, 12 layers, through the learner body and PS:
    # the main path (its launches go into the kernels line), the model's
    # context per learner step, and the per-phase breakdown with timers
    # in rounds after the first run's checks
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    train = {}
    for label, traffic, breakdown in (("train", TRAIN, BREAKDOWN_ROUNDS),
                                      ("train-4k", TRAIN_LONG, 0)):
        workdir = Path(tempfile.mkdtemp(prefix="chip-smoke-train-",
                                        dir=build_dir))
        try:
            train[label] = train_run(torch, ops, tcfg, "cuda", workdir,
                                     card, profile=True,
                                     breakdown=breakdown, **traffic)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print_train(label, train[label], card, tcfg, traffic)
        torch.cuda.empty_cache()
    train_launches = train["train"]["launches"]
    clock.done("8 train")

    # 9. platform: the same traffic planned by the software-ps backend and
    # run under the LCM and scheduler, then a managed endpoint deployed on
    # its trained_model.npy, its tokens held against a bare engine's
    workdir = Path(tempfile.mkdtemp(prefix="chip-smoke-platform-",
                                    dir=build_dir))
    try:
        ptrain, trained = platform_train(torch, ops, tcfg, workdir, card,
                                         PLATFORM)
        psv = platform_serve(torch, ops, tcfg, workdir, card, PLATFORM)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print_platform(ptrain, psv, train["train"], card, tcfg, PLATFORM)
    tokens, eng, rec, _, bare_wall = serve(torch, tcfg, ops, 0, card,
                                           flat=trained)[:5]
    bare_tok = eng.stats()["tokens_out_total"]
    eng.release()
    del eng, trained
    torch.cuda.empty_cache()
    if rec.prefills != psv["prefills"] or tokens != psv["tokens"]:
        raise AssertionError(f"endpoint tokens differ from a bare engine's "
                             f"on the PS params (prefill batches "
                             f"{psv['prefills']} vs {rec.prefills})")
    print(f"[platform] {card}: the endpoint's tokens for its "
          f"{len(tokens)} requests == a bare InferenceEngine's on the PS "
          f"params with seed 0 (prefill batches {rec.prefills}; the bare "
          f"engine {bare_tok} tokens in {bare_wall:.3f} s = "
          f"{bare_tok / bare_wall:.1f} tokens/s)")
    clock.done("9 platform")

    # 10. service: the same manifest through the port's REST server, the
    # trained model deployed and served over HTTP
    workdir = Path(tempfile.mkdtemp(prefix="chip-smoke-service-",
                                    dir=build_dir))
    try:
        svc, trained = service_run(torch, tcfg, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    check_service_launches(svc, tcfg)
    print_service(svc, ptrain, card, tcfg)
    prompts = serve_prompts(tcfg, 0)
    bare = serve_alone(tcfg, trained,
                       [prompts[i] for i in SERVICE_ALONE],
                       [SERVE_REQUESTS[i][1] for i in SERVICE_ALONE])
    del trained
    torch.cuda.empty_cache()
    if bare != svc["alone"]:
        raise AssertionError("the service's tokens differ from a bare "
                             "engine's on trained_model.npy")
    print(f"[service] {card}: the tokens of the {len(bare)} requests served "
          f"alone == a bare InferenceEngine's on the downloaded "
          f"trained_model.npy, each request alone")
    clock.done("10 service")

    # 11. K5b, the SSD scan backward, against its plain version: the
    # learner's full-width shapes, the smoke width, a ragged tail, a
    # sequence shorter than a chunk, G = 2, and a final-state gradient
    ssm = get_arch(SSM_ARCH)
    heads = ssm.ssm.expand * ssm.d_model // ssm.ssm.head_dim
    wide = (heads, ssm.ssm.head_dim, ssm.ssm.n_groups, ssm.ssm.d_state,
            ssm.ssm.chunk_size, "bfloat16")
    k5b_main = [check_ssd_bwd(torch, ops, ref, kssdb,
                              (t["batch_docs"], t["seq_len"]) + wide,
                              seed=i)
                for i, t in enumerate((SSM_TRAIN, SSM_TRAIN_LONG))]
    k5b_others = [check_ssd_bwd(torch, ops, ref, kssdb, shape, dstate=d,
                                seed=10 + i)
                  for i, (shape, d) in enumerate([
                      ((2, 64, 8, 16, 1, 16, 32, "float32"), False),
                      ((2, 50, 8, 16, 1, 16, 32, "float32"), True),
                      ((1, 300) + wide, False),
                      ((1, 300) + wide, True),
                      ((2, 7, 2, 16, 1, 16, 32, "float32"), False),
                      ((2, 256, 4, 32, 2, 16, 64, "float32"), True),
                      ((2, 700, 8, 64, 2, 128, 256, "bfloat16"), True),
                      ((2, 512, 4, 64, 1, 64, 128, "bfloat16"), True)])]
    for res in k5b_main:
        print(f"[kernel] {card}: K5b main path {json.dumps(res)}")
    for res in k5b_others:
        print(f"[kernel] {card}: K5b {json.dumps(res)}")
    # the split by device kernel at the head shape (the largest bound;
    # at one of the two full-width shapes, to keep the run short)
    for res in [max(k5b_main, key=lambda r: r["bound_ms"])]:
        sh = res["shape"]
        split = k5b_split([sh[k] for k in "B S H P G N chunk".split()])
        res["split"] = split["split"]
        for k in split["split"]:
            print(f"[kernel] {card}: K5b split at ({sh['B']}, {sh['S']}) "
                  f"({split['ms']:.4f} ms a call alone): "
                  f"{1e3 * k['ms_per_call']:9.1f} us "
                  f"{k['ms_per_call'] / split['profiled_ms']:6.3f} of it, "
                  f"{k['launches_per_call']:.0f} launch(es), registers "
                  f"{k.get('registers', 'n/a')}, spills "
                  f"{k.get('spill_stores', 'n/a')} B  {k['kernel']}")
    k5b_head = max(k5b_main, key=lambda r: r["bound_ms"])
    print(f"[kernel] {card}: K5b at {k5b_head['shape']}: "
          f"{k5b_head['ms']:.4f} ms (limit {K5B_MAX_MS}) on the "
          f"{k5b_head['instance']}, bound {k5b_head['bound_ms']:.5f} ms "
          f"({k5b_head['bound_by']}), {k5b_head['share_of_bound']:.4f} of "
          f"it; plain {k5b_head['plain_ms']:.3f} ms; library null (no "
          f"single PyTorch call computes it)")
    bad = [r for r in k5b_main if r["instance"] != "tensor cores"]
    if k5b_head["ms"] > K5B_MAX_MS or bad:
        raise AssertionError(f"K5b at {k5b_head['shape']} takes "
                             f"{k5b_head['ms']:.4f} ms (limit {K5B_MAX_MS} "
                             f"ms); off the tensor cores: "
                             f"{[r['shape'] for r in bad]}")
    torch.cuda.empty_cache()
    clock.done("11 K5b")

    # 12. the ssm learner step on the card against the CPU
    scfg_smoke, ssm_step = lm_step_card_vs_cpu(torch, ops, SSM_ARCH,
                                               SSM_STEP_SEQS)
    for seq, (loss_err, grad_err) in ssm_step.items():
        print(f"[ssm-step] {card}: {scfg_smoke.arch_id} f32 L="
              f"{scfg_smoke.n_layers}, 2 x {seq} tokens, card (K5, K5b) vs "
              f"CPU: loss err {loss_err:.3e} (limit {STEP_LOSS_TOL}), flat "
              f"gradient max abs err {grad_err:.3e} (atol=rtol "
              f"{STEP_GRAD_TOL})")
    clock.done("12 ssm-step")

    # 13. full-width mamba2-1.3b, 16 of 48 layers, through the learner
    # body and the PS at 2 x 512 and 1 x 2,048 tokens per learner step
    scfg = dataclasses.replace(ssm, n_layers=SSM_TRAIN_LAYERS)
    for label, traffic in (("ssm-train", SSM_TRAIN),
                           ("ssm-train-2k", SSM_TRAIN_LONG)):
        workdir = Path(tempfile.mkdtemp(prefix="chip-smoke-train-",
                                        dir=build_dir))
        try:
            train[label] = train_run(torch, ops, scfg, "cuda", workdir,
                                     card, profile=True, **traffic)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print_train(label, train[label], card, scfg, traffic)
        torch.cuda.empty_cache()
    clock.done("13 ssm-train")

    # 14. ssm platform: the 2 x 512 traffic as a manifest through the
    # software-ps backend, the LCM and the scheduler, the PS released,
    # then a managed endpoint on its trained_model.npy serving the ssm
    # serve's 8 requests, its tokens held against a bare engine's
    workdir = Path(tempfile.mkdtemp(prefix="chip-smoke-platform-",
                                    dir=build_dir))
    try:
        sptrain, trained = platform_train(torch, ops, scfg, workdir, card,
                                          SSM_PLATFORM)
        spsv = platform_serve(torch, ops, scfg, workdir, card, SSM_PLATFORM)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print_platform(sptrain, spsv, train["ssm-train"], card, scfg,
                   SSM_PLATFORM)
    tokens, eng, rec, _, bare_wall = serve(
        torch, scfg, ops, 0, card, requests=SSM_REQUESTS,
        max_seq=SSM_MAX_SEQ, flat=trained)[:5]
    bare_tok = eng.stats()["tokens_out_total"]
    eng.release()
    del eng, trained
    torch.cuda.empty_cache()
    if rec.prefills != spsv["prefills"] or tokens != spsv["tokens"]:
        raise AssertionError(f"ssm endpoint tokens differ from a bare "
                             f"engine's on the PS params (prefill batches "
                             f"{spsv['prefills']} vs {rec.prefills})")
    print(f"[ssm-platform] {card}: the endpoint's tokens for its "
          f"{len(tokens)} requests == a bare InferenceEngine's on the PS "
          f"params with seed 0 (prefill batches {rec.prefills}; the bare "
          f"engine {bare_tok} tokens in {bare_wall:.3f} s = "
          f"{bare_tok / bare_wall:.1f} tokens/s)")
    clock.done("14 ssm-platform")

    # 15. moe: grok-1 at full width, one layer against the plain loop,
    # 4 of 64 layers served, prefill against decode, K4 at the serve's
    # shapes and the smoke-width step
    moe_main, moe_launches = serve_moe(torch, ops, ref, kfa, card)
    torch.cuda.empty_cache()
    clock.done("15 moe")

    # 16. hybrid: Jamba-1.5-Large at full width, one period of 4 layers
    # served, prefill against decode, K4 and K5 at the serve's shapes and
    # the smoke-width step
    hy_k4, hy_k5, hybrid_launches = serve_hybrid(torch, ops, ref, kfa,
                                                 kssd, card)
    torch.cuda.empty_cache()
    clock.done("16 hybrid")

    # 17. encdec: whisper-large-v3 at full width and depth trained through
    # the model-level step, prefill and greedy decode, prefill against
    # decode, K4/K4b at its three attention shapes, the smoke-width step
    wh_k4, wh_k4b, whisper_launches = train_encdec(torch, ops, ref, kfa,
                                                   kfab, card)
    torch.cuda.empty_cache()
    clock.done("17 encdec")

    # 18. vlm: qwen2-vl-2b fed with embeds and M-RoPE positions, the same;
    # its trained weights kept for phase 20's zero3_sp step
    vl_kept = {}
    vl_k4, vl_k4b, vlm_launches = train_vlm(torch, ops, ref, kfa, kfab,
                                            card, keep=vl_kept)
    torch.cuda.empty_cache()
    clock.done("18 vlm")

    # 19. pjit: stablelm-1.6b at full width and depth through PjitBackend
    # (preempted and resumed from its checkpoint), the sharded step on a
    # 1-rank NCCL mesh, K4/K4b at the step's shape
    pj_k4, pj_k4b, pjit_launches = train_pjit(torch, ops, ref, kfa, kfab,
                                              card)
    torch.cuda.empty_cache()
    clock.done("19 pjit")

    # 20. the paper's PS solvers at full width (4 learners on the card),
    # K1-K3 at their shapes; zero3_sp: K4/K4b at a 4-way "model" axis's
    # per-rank shapes (q_offset > 0), the qwen2-vl step on a 1-rank mesh
    solver_launches_total, solver_f = train_solvers(torch, ops, kfa, kfab,
                                                    card)
    k1s = time_ps_aggregate(torch, ops, ref, SOLVER_LEARNERS, solver_f)
    print(f"[kernel] {card}: K1 at the solvers' (L, F): {json.dumps(k1s)}")
    torch.cuda.empty_cache()
    k2s, k3s = time_quantize(torch, ops, ref, solver_f, torch.float32)
    print(f"[kernel] {card}: K2 at the solvers' push: {json.dumps(k2s)}")
    print(f"[kernel] {card}: K3 at the solvers' push: {json.dumps(k3s)}")
    torch.cuda.empty_cache()
    sp_k4, sp_k4b = sp_kernels(torch, ops, ref, card)
    sp_launches = sp_step(torch, ops, kfa, kfab, vl_kept.pop("params"), card)
    torch.cuda.empty_cache()
    clock.done("20 solvers, zero3_sp")

    # 21. kimi-k2 at full width (one layer) served with K4 at head dim 112,
    # moe_block against moe_ref at k = 8, and the expert-parallel prefill
    # and decode steps on a 1-rank NCCL mesh (kimi-k2's and grok-1's
    # weights) against the mesh-less steps
    kimi_k4, _, kimi_launches, _, (kimi_k4b, kimi_grad_launches) = \
        serve_kimi(torch, ops, ref, kfa, card)
    torch.cuda.empty_cache()
    clock.done("21 kimi, expert-parallel")

    # 22. the launch-shape tuner: K1-K4 at the paths' shapes from a fresh
    # cache, every candidate's bits against the default's, the second
    # lookups, the exporter's families and the small-block counter
    tuned = autotune_phase(torch, card, autotune_shapes(
        lay.shard_len, lay.padded, solver_f))
    torch.cuda.empty_cache()
    clock.done("22 autotune")

    # 23. the dry-run: the child's records (two production cells on a fake
    # 512-rank group, phase 19 b's step counted at remat none and full),
    # then that step on the card at both values against the count
    remat_launches = dryrun_phase(torch, kfa, kfab, card, dry_child)
    torch.cuda.empty_cache()
    clock.done("23 dryrun")

    # 24. the paper's fault tolerance through the port's DLaaSCore: an
    # uninterrupted run, a SIGKILLed core process recovered here, a
    # CRASH_CORE recovered in this process, a node killed under the PS
    # learners and one under a serving endpoint
    drill_launches_total = drills_phase(torch, ops, card)
    torch.cuda.empty_cache()
    clock.done("24 drills")

    # 25. the dense archs no earlier phase runs: minitron-8b and
    # granite-20b served whole, qwen1.5-110b cut in depth, a train step
    # of each through K4/K4b, K4/K4b at their shapes
    dn_k4, dn_k4b, dense_launches = dense_archs_phase(torch, ops, ref, kfa,
                                                      kfab, card)
    torch.cuda.empty_cache()
    clock.done("25 dense")

    # 26. result
    def entry(mod, launches, head, shapes):
        return {"name": mod.NAME, "route": "cuda", "source": mod.SOURCE,
                "replaces": mod.REPLACES, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in shapes),
                "ms": head["ms"], "kernel_ms": head["ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "shape": head["shape"],
                "card": card, "shapes": shapes}

    # each entry's head: the main-path shape with the largest bound;
    # launches: the sum over the main paths that run the kernel
    def by_path(name, paths):
        return {p: ls[name] for p, ls in paths.items()}
    dense_paths = {"train": train_launches,
                   "platform-train": ptrain["launches"],
                   "service": svc["launches"],
                   "train-whisper": whisper_launches,
                   "train-qwen2-vl": vlm_launches,
                   "train-pjit": pjit_launches,
                   "solvers": solver_launches_total,
                   "train-sp": sp_launches,
                   "grad-kimi-attn": kimi_grad_launches,
                   "train-pjit-remat": remat_launches,
                   "drills": drill_launches_total,
                   "dense_archs": dense_launches}
    ssm_paths = {"ssm-train": train["ssm-train"]["launches"],
                 "ssm-platform-train": sptrain["launches"]}
    k4_paths = by_path(kfa.NAME, {"serve": serve_launches, **dense_paths,
                                  "platform-serve": psv["launches"],
                                  "serve-moe": moe_launches,
                                  "serve-hybrid": hybrid_launches,
                                  "serve-kimi": kimi_launches})
    k4_shapes = (main_path + train_fwd + moe_main + hy_k4 + wh_k4 + vl_k4
                 + pj_k4 + sp_k4 + kimi_k4 + k4_hd112 + dn_k4)
    k4 = entry(kfa, sum(k4_paths.values()),
               max(k4_shapes, key=lambda r: r["bound_ms"]), k4_shapes)
    k4["launches_by_path"] = k4_paths
    k4b_main = [bwd[-1]] + wh_k4b + vl_k4b + pj_k4b + dn_k4b
    k4b = entry(kfab, 0, max(k4b_main, key=lambda r: r["bound_ms"]),
                bwd + wh_k4b + vl_k4b + pj_k4b + sp_k4b + kimi_k4b
                + dn_k4b)
    for e, names in ((k4, TC_KERNELS[:1]), (k4b, TC_KERNELS[1:])):
        e["share_of_bound"] = e["bound_ms"] / e["ms"]
        e["x_library"] = e["ms"] / e["library_ms"]
        e["sass_hgmma"] = {n: c for n, c in hgmma.items()
                           if n.split("<")[0] in names}
    def biggest(rs):
        return max(rs, key=lambda r: r["bound_ms"])
    kernels = [k4, k4b,
               entry(kagg, 0, biggest([k1, k1s]), [k1, k1s]),
               entry(kq.QUANTIZE, 0, biggest([k2, k2s]), [k2, k2s]),
               entry(kq.DEQUANTIZE, 0, biggest([k3, k3s]), [k3, k3s])]
    for e in kernels[1:]:
        paths = dense_paths if e is k4b else {**dense_paths, **ssm_paths}
        e["launches_by_path"] = by_path(e["name"], paths)
        e["launches"] = sum(e["launches_by_path"].values())
    k5_paths = by_path(kssd.NAME, {"serve-ssm": ssm_launches, **ssm_paths,
                                   "ssm-platform-serve": spsv["launches"],
                                   "serve-hybrid": hybrid_launches})
    ssd_head = max(ssd_main + hy_k5, key=lambda r: r["bound_ms"])
    k5 = entry(kssd, sum(k5_paths.values()), ssd_head,
               ssd_main + hy_k5 + ssd_others)
    k5["launches_by_path"] = k5_paths
    k5["share_of_bound"] = k5["bound_ms"] / k5["ms"]
    k5["sass_hgmma"] = {n: c for n, c in hgmma.items()
                        if n.split("<")[0] in SSD_TC_KERNELS}
    k5b_paths = by_path(kssdb.NAME, ssm_paths)
    k5b = entry(kssdb, sum(k5b_paths.values()), k5b_head,
                k5b_main + k5b_others)
    k5b["launches_by_path"] = k5b_paths
    k5b["launches_tc"] = sum(by_path(kssdb.NAME, {
        "ssm-train": train["ssm-train"]["launches_tc"],
        "ssm-platform-train": sptrain["launches_tc"]}).values())
    k5b["instance"] = k5b_head["instance"]
    k5b["share_of_bound"] = k5b["bound_ms"] / k5b["ms"]
    k5b["ptxas"] = k5b_ptxas
    k5b["sass_hgmma"] = {n: c for n, c in hgmma.items()
                         if n.split("<")[0] in SSD_BWD_TC_KERNELS}
    kernels += [k5, k5b]
    for e in kernels:
        label = {kfa.NAME: "K4", kagg.NAME: "K1", kq.QUANTIZE.NAME: "K2",
                 kq.DEQUANTIZE.NAME: "K3"}.get(e["name"])
        if label:
            e["autotune"] = {k: {f: r[f] for f in (
                "shape", "choice", "default", "choice_ms", "default_ms",
                "bound_ms")} for k, r in tuned.items()
                if k.startswith(label + " ")}
    print(clock.summary())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--dryrun-child"]:
        sys.exit(dryrun_child())
    if sys.argv[1:2] == ["--drill-child"] and len(sys.argv) == 3:
        sys.exit(drill_child(sys.argv[2]))
    sys.exit(main())
