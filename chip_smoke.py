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
     ``ssd_bwd_dbx_tc`` and ``ssd_bwd_dc_tc`` included) must hold some;
  3. kernel  — the flash-attention kernel against its plain PyTorch
     version at three shapes (StableLM-1.6B prefill in bf16, GQA and
     ragged in f32), with times of kernel, plain version and
     ``scaled_dot_product_attention`` (a yardstick the port never calls)
     beside the least time the card could take;
  4. serve   — full-width StableLM-1.6B (bf16, random weights from a seed)
     behind ``InferenceEngine``: 8 requests, 4 slots, mid-flight joins;
     every request done, the kernel launched 24 times per prefill batch,
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
     relative L2 and two calls giving equal bits); then full-width,
     full-depth mamba2-1.3b
     (bf16, random weights from a seed) behind ``InferenceEngine``: 8
     requests with prompts of 2,048 to 2 tokens, 4 slots, prefill
     batches (2, 2048), (2, 512), (1, 300), (1, 256), (1, 33), (1, 2)
     (four mid-flight joins); every request done, K5 launched 48 times
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
     on the card (4 shards, adam, int8 wire, BSP) for 6 rounds of
     2 x 512 tokens per learner, checkpointing every 3 steps; asserts the
     push/round counts, every kernel's launches (every flash kernel in
     the profiled rounds a tensor-core instance), and that the newest
     checkpoint, the PS params and ``trained_model.npy`` are bit for bit
     one vector; prints round and agg times, tokens per second, peak
     device memory, and a profiled extra round (busy share, the PS
     kernels' share). The same at one 4,096-token sequence per learner
     step (the model's context), then 3 rounds of the first traffic with
     a device synchronise after every step, push and pull, for the
     per-phase breakdown (those timers are not in the other two runs);
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
     restart (six steps, ``data_plane``, the timeline's plan/queue_wait/
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
     device time by kernel (``scripts/ssd_kernel_split.py --bwd`` in a
     child process); its device kernels' registers,
     shared memory, spills and HGMMA counts in phase 2. K5b at (1, 2048)
     bf16 must take at most K5B_MAX_MS, and both full-width shapes run
     the tensor-core instance;
 12. ssm-step — the ssm learner step on the card (K5, K5b) against the
     CPU: mamba2-1.3b's smoke reduction in f32, 2 layers, 64 and a
     ragged 50 positions (loss 1e-4, flat gradient 2e-3);
 13. ssm-train — full-width mamba2-1.3b cut to 32 of 48 layers (bf16,
     random weights from a seed) through the learner body and the PS as
     phase 8 (2 learners, 4 shards, adam, int8, BSP, 6 rounds, a
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
     ``arch: mamba2-1.3b`` and the 32-layer config through
     ``SoftwarePSBackend`` under the LCM and scheduler to COMPLETED (the
     checks of phase 9, the PS's release included); its
     ``trained_model.npy`` deployed as a managed endpoint (capacity
     4, max_seq 2080) serving the ssm serve's 8 requests, its tokens
     equal to a bare engine's on the same weights; the training's and the
     endpoint's ``status.perf`` (``0 < pct_of_attainable <= 100``);
     launch -> COMPLETED and deploy -> READY seconds;
 15. result  — ``{"kernels": [...]}`` on the line before the last (each
     kernel's launches summed over the main paths, with
     ``launches_by_path``) and ``{"ok": true, "device": {...}}`` as the
     last line.

About ten minutes on an H100, the kernel builds included.
"""
from __future__ import annotations

import dataclasses
import gc
import io
import json
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
TRAIN = dict(n_learners=2, n_shards=4, steps=6, batch_docs=2, seq_len=512,
             checkpoint_every=3, lr=1e-4, optimizer="adam",
             compression="int8")
# one sequence at the model's published context (StableLM 2 1.6B model
# card, hf:stabilityai/stablelm-2-1_6b: 4,096 tokens) per learner step
TRAIN_LONG = dict(TRAIN, batch_docs=1, seq_len=4096)
# the per-phase breakdown: TRAIN's traffic with synchronised timers
TRAIN_TIMED = dict(TRAIN, steps=3)
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
# mamba2-1.3b at full width cut to 32 of its 48 layers: F = 1,032,986,624,
# within 0.6% of the dense train's F, which fits one card with its PS at
# ~50 B/param (48 layers, F = 1,446,505,472, would take ~72 GB)
SSM_TRAIN_LAYERS = 32
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    ``_tc`` kernel holds no HGMMA at either of its two widths. Returns
    (the HGMMA counts by readable kernel name, {library: {readable kernel
    name: its ptxas report}})."""
    import ctypes
    dyn = {}
    fwd = ctypes.CDLL(str(built["flash_attention"].library))
    bwd = ctypes.CDLL(str(built["flash_attention_bwd"].library))
    ssd = ctypes.CDLL(str(built["ssd_scan"].library))
    ssdb = ctypes.CDLL(str(built["ssd_scan_bwd"].library))
    for hd in (64, 128):
        dyn[f"flash_fwd_kernel_tc<{hd}>"] = fwd.flash_attention_fwd_tc_smem(hd)
        dyn[f"flash_bwd_dq_tc_kernel<{hd}>"] = \
            bwd.flash_attention_bwd_tc_smem(hd, 0)
        dyn[f"flash_bwd_dkv_tc_kernel<{hd}>"] = \
            bwd.flash_attention_bwd_tc_smem(hd, 1)
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
        if len(found) != 2 or not all(found.values()):
            raise AssertionError(f"tensor-core kernel {base}: HGMMA "
                                 f"counts {found} (want > 0 at both "
                                 f"widths, 64 and 128)")
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
    prefix of their device kernels' names."""
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


def check_attention(torch, ops, ref, shape, seed=0):
    """Kernel vs plain version (and SDPA as yardstick) at one shape."""
    import torch.nn.functional as F
    B, S, H, KV, hd, dtype, causal = shape
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dt)
    k = torch.randn(B, S, KV, hd, generator=g, device="cuda").to(dt)
    v = torch.randn(B, S, KV, hd, generator=g, device="cuda").to(dt)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
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
    bound_ms, bound_by = attention_bound_ms(B, S, S, H, KV, hd, dtype,
                                            causal)
    return {"shape": {"B": B, "S": S, "H": H, "KV": KV, "hd": hd,
                      "dtype": dtype, "causal": causal},
            "max_abs_err": max_err, "tol": tol, "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / kernel_ms,
            "x_library": kernel_ms / library_ms}


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
          requests=SERVE_REQUESTS, max_seq: int = 1024, flat=None):
    """One full serve of ``requests`` (prompt length, max_new) through
    the engine's public API, on the weights ``flat`` (None: fresh from
    ``seed``). Returns (tokens per request, engine, the
    ``SpanRecorder``, launches, wall seconds, profiler or None)."""
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
    print(f"[serve] {card}: weights + cache ready in "
          f"{time.perf_counter() - t0:.2f} s")
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


def prefill_vs_decode(torch, cfg, prompt, seed=0):
    """Full-width model cut to ``cfg.n_layers`` layers, random weights:
    last-position logits of prefill(prompt) (attention in the kernel)
    against prefill(prompt[:-1]) + decode(prompt[-1]) (plain decode
    attention), two independent attention paths. Returns the relative L2
    difference. The depth is cut because rounding differences between any
    two paths grow layer by layer through a randomly initialised stack
    (bf16 at 24 layers reaches tens of percent on the CPU too)."""
    from repro_torch.models import make_model
    model = make_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
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
    cfg = get_arch(SSM_ARCH)
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


def check_attention_bwd(torch, ops, ref, shape, seed=0):
    """K4 with LSE and K4b against their plain versions at one shape;
    SDPA forward + backward through autograd as the yardstick."""
    import torch.nn.functional as F
    B, S, H, KV, hd, dtype, causal, q_offset = shape
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dt)
    k = torch.randn(B, S, KV, hd, generator=g, device="cuda").to(dt)
    v = torch.randn(B, S, KV, hd, generator=g, device="cuda").to(dt)
    do = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dt)
    kw = dict(causal=causal, q_offset=q_offset)
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
        mask = pos[None, :] <= pos[:, None] + q_offset
    out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and not q_offset)
    dot = do.transpose(1, 2)
    library_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters=20)
    # read q, k, v, o, dO and lse, write dq, dk, dv; five products
    bound_ms, bound_by = bound("flash_attention_bwd", B=B, Sq=S, Sk=S, H=H,
                               KV=KV, hd=hd, dtype=dtype, causal=causal,
                               q_offset=q_offset)
    return {"shape": {"B": B, "S": S, "H": H, "KV": KV, "hd": hd,
                      "dtype": dtype, "causal": causal,
                      "q_offset": q_offset},
            "fwd_lse_ms": fwd_ms, "fwd_max_abs_err": fwd_err,
            "lse_max_abs_err": lse_err,
            "max_abs_err": max(errs), "rel_l2": rels, "ms": bwd_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / bwd_ms,
            "x_library": bwd_ms / library_ms,
            "deterministic": deterministic}


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


class TimedPlugin:
    """The learner's plugin with each step's forward + backward timed on
    the host clock up to a device synchronise. Only the breakdown run
    uses it: the synchronise is not the port's own, and on a card both
    learners share, a step's time includes the other's interleaved
    work."""

    def __init__(self, torch, plugin):
        self._torch, self._plugin = torch, plugin
        self.step_s = []

    def flat_loss_grad(self, flat, batch):
        t0 = time.perf_counter()
        out = self._plugin.flat_loss_grad(flat, batch)
        sync(self._torch, self._plugin.device)
        self.step_s.append(time.perf_counter() - t0)
        return out

    def __getattr__(self, name):
        return getattr(self._plugin, name)


def stamped_ps(torch, timers: bool):
    """A SoftwareParameterServer class that stamps the end of every round
    on the host clock. That adds no synchronise: the PS already waits
    for the round's K1 launches, through the event it times them with.
    With ``timers`` its clients also time each push (K2, receive with
    K3, the BSP wait, and K1 for the last pusher) and each pull up to a
    device synchronise, the breakdown run's instrumentation, which the
    port's own loop does not have."""
    from repro_torch.core.software_ps import (PSClient,
                                              SoftwareParameterServer)

    class Client(PSClient):
        def push(self, flat, timeout=30.0):
            t0 = time.perf_counter()
            ok = super().push(flat, timeout)
            sync(torch, self.ps.device)
            self.ps.push_s.append(time.perf_counter() - t0)
            return ok

        def pull(self):
            t0 = time.perf_counter()
            buf = super().pull()
            sync(torch, self.ps.device)
            self.ps.pull_s.append(time.perf_counter() - t0)
            return buf

    class PS(SoftwareParameterServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.push_s, self.pull_s, self.round_end = [], [], []

        def make_client(self, learner_id):
            if not timers:
                return super().make_client(learner_id)
            return Client(self, learner_id, compression=self.compression)

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
              optimizer, compression, timers=False, profile=False):
    """Train ``cfg`` with ``n_learners`` learner threads through the
    port's learner body and PS. Returns a dict of what the run counted
    and measured; raises on any failed check. Without ``timers`` the
    loop is the port's own (round ends stamped on the host, no added
    synchronise); with them, every step, push and pull ends in a device
    synchronise and is timed (the per-phase breakdown)."""
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
    plugin = TimedPlugin(torch, base) if timers else base
    data_cfg = {"seq_len": seq_len, "n_docs": 512, "seed": 0}
    jcfg = LearnerJobConfig(
        job_id=job, data_cfg=data_cfg, n_learners=n_learners,
        batch_docs=batch_docs, steps=steps, lr=lr, optimizer=optimizer,
        solver="psgd", compression=compression, seed=0,
        checkpoint_dir=str(workdir / "ckpt"),
        checkpoint_every=checkpoint_every)
    t0 = time.perf_counter()
    ps = stamped_ps(torch, timers)(plugin.flat_state(jcfg.seed),
                                   n_shards=n_shards,
                         n_learners=n_learners, optimizer=optimizer, lr=lr,
                         trigger="bsp", compression=compression,
                         metrics=metrics, job_id=job, device=device)
    sync(torch, device)
    init_s = time.perf_counter() - t0
    cursor = GlobalCursor(zk, f"/jobs/{job}/cursor", dataset_size=512)
    results = {}
    body = make_learner_body(jcfg, ps, cursor, storage, metrics, results,
                             plugin=plugin)
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
    if timers:
        out.update(step_ms=[1e3 * s for s in plugin.step_s],
                   push_ms=[1e3 * s for s in ps.push_s],
                   pull_ms=[1e3 * s for s in ps.pull_s])
    if profile:
        out["profile"] = profiled_round(torch, ps, base, cursor,
                                        SyntheticCorpus(
                                            base.dataset_spec(data_cfg)),
                                        batch_docs, card, cfg)
    del ps
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
        print(f"{tag} with a synchronise after each: learner step "
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


def ssm_step_card_vs_cpu(torch, ops):
    """``LMPlugin.flat_loss_grad`` of mamba2-1.3b's smoke reduction (f32,
    2 layers, chunk 32) on the card (K5, K5b) against the CPU (plain
    versions) at each of SSM_STEP_SEQS positions: loss and flat gradient
    errors, K5 and K5b launched once per layer each."""
    import numpy as np
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_arch
    from repro_torch.runtime.learner import LMPlugin
    cfg = reduce_for_smoke(get_arch(SSM_ARCH))
    gpu = LMPlugin({}, cfg=cfg, device="cuda")
    cpu = LMPlugin({}, cfg=cfg, device="cpu")
    flat = cpu.flat_state(0)
    out = {}
    for seq in SSM_STEP_SEQS:
        toks = np.random.RandomState(seq).randint(
            0, cfg.vocab_size, size=(2, seq + 1)).astype("int32")
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        ops.reset_launch_counts()
        lg, gg = gpu.flat_loss_grad(flat.cuda(), batch)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        lc, gc = cpu.flat_loss_grad(flat, batch)
        want = dict.fromkeys(launches, 0)
        want.update(ssd_scan=cfg.n_layers, ssd_scan_bwd=cfg.n_layers)
        if launches != want:
            raise AssertionError(f"ssm step launches {launches}, want "
                                 f"{want}")
        loss_err = abs(lg.item() - lc.item())
        diff = (gg.cpu() - gc).abs()
        if loss_err > STEP_LOSS_TOL or diff.gt(
                STEP_GRAD_TOL + STEP_GRAD_TOL * gc.abs()).any():
            raise AssertionError(f"ssm step at S={seq}, card vs CPU: loss "
                                 f"err {loss_err}, grad err "
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
    card = card_line()
    print(card)
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

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

    # 3. kernel against its plain version
    for shape in [(1, 512, 32, 32, 64, "bfloat16", True),
                  (2, 256, 8, 2, 128, "float32", False),
                  (3, 37, 4, 2, 16, "float32", True)]:
        res = check_attention(torch, ops, ref, shape)
        print(f"[kernel] {card}: {json.dumps(res)}")

    # 4. serve at full width: cold (first use of every library kernel),
    # then warm with the same seed (same tokens), then warm under the
    # profiler (device busy share and where the device time goes)
    cfg = get_arch(SERVE_ARCH)
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

    # 5. the ssm serve: K5 against its plain version, mamba2-1.3b at full
    # width and depth through the engine, prefill against decode
    ssd_main, ssd_others, ssm_launches = serve_ssm(torch, ops, ref, kssd,
                                                   card)
    ssd_head = max(ssd_main, key=lambda r: r["bound_ms"])
    torch.cuda.empty_cache()

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

    # 7. a training step on the card against the CPU (smoke width, f32)
    loss_err, grad_err, round_err = step_card_vs_cpu(torch, ops)
    print(f"[step] {card}: stablelm-1.6b-smoke f32, card vs CPU: loss err "
          f"{loss_err:.3e} (limit {STEP_LOSS_TOL}), flat gradient max abs "
          f"err {grad_err:.3e} (atol=rtol {STEP_GRAD_TOL}); one int8 + adam "
          f"PS round, 2 learners: params max abs err {round_err:.3e} "
          f"(limit {ROUND_PARAM_TOL})")

    # 8. full-width training, 12 layers, through the learner body and PS:
    # the main path (its launches go into the kernels line), the model's
    # context per learner step, and the per-phase breakdown with timers
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    train = {}
    for label, traffic, timers in (("train", TRAIN, False),
                                   ("train-4k", TRAIN_LONG, False),
                                   ("train-timed", TRAIN_TIMED, True)):
        workdir = Path(tempfile.mkdtemp(prefix="chip-smoke-train-",
                                        dir=build_dir))
        try:
            train[label] = train_run(torch, ops, tcfg, "cuda", workdir,
                                     card, timers=timers,
                                     profile=not timers, **traffic)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print_train(label, train[label], card, tcfg, traffic)
        torch.cuda.empty_cache()
    train_launches = train["train"]["launches"]

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
    for res in k5b_main:
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

    # 12. the ssm learner step on the card against the CPU
    scfg_smoke, ssm_step = ssm_step_card_vs_cpu(torch, ops)
    for seq, (loss_err, grad_err) in ssm_step.items():
        print(f"[ssm-step] {card}: {scfg_smoke.arch_id} f32 L="
              f"{scfg_smoke.n_layers}, 2 x {seq} tokens, card (K5, K5b) vs "
              f"CPU: loss err {loss_err:.3e} (limit {STEP_LOSS_TOL}), flat "
              f"gradient max abs err {grad_err:.3e} (atol=rtol "
              f"{STEP_GRAD_TOL})")

    # 13. full-width mamba2-1.3b, 32 of 48 layers, through the learner
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

    # 15. result
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
                   "service": svc["launches"]}
    ssm_paths = {"ssm-train": train["ssm-train"]["launches"],
                 "ssm-platform-train": sptrain["launches"]}
    k4_paths = by_path(kfa.NAME, {"serve": serve_launches, **dense_paths,
                                  "platform-serve": psv["launches"]})
    k4 = entry(kfa, sum(k4_paths.values()),
               max(main_path + train_fwd, key=lambda r: r["bound_ms"]),
               main_path + train_fwd)
    k4["launches_by_path"] = k4_paths
    k4b = entry(kfab, 0, bwd[-1], bwd)
    for e, names in ((k4, TC_KERNELS[:1]), (k4b, TC_KERNELS[1:])):
        e["share_of_bound"] = e["bound_ms"] / e["ms"]
        e["x_library"] = e["ms"] / e["library_ms"]
        e["sass_hgmma"] = {n: c for n, c in hgmma.items()
                           if n.split("<")[0] in names}
    kernels = [k4, k4b,
               entry(kagg, 0, k1, [k1]),
               entry(kq.QUANTIZE, 0, k2, [k2]),
               entry(kq.DEQUANTIZE, 0, k3, [k3])]
    for e in kernels[1:]:
        paths = dense_paths if e is k4b else {**dense_paths, **ssm_paths}
        e["launches_by_path"] = by_path(e["name"], paths)
        e["launches"] = sum(e["launches_by_path"].values())
    k5_paths = by_path(kssd.NAME, {"serve-ssm": ssm_launches, **ssm_paths,
                                   "ssm-platform-serve": spsv["launches"]})
    k5 = entry(kssd, sum(k5_paths.values()), ssd_head,
               ssd_main + ssd_others)
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
