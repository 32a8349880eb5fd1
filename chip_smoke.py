#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them, and at the
first failing phase (no phase catches an exception):

  1. device  — card name and power limit (nvidia-smi), torch/CUDA versions;
  2. build   — every kernel of ``src/repro_torch/kernels/csrc`` built with
     nvcc into ``build/kernels/``;
  3. kernel  — the flash-attention kernel against its plain PyTorch
     version at three shapes (StableLM-1.6B prefill in bf16, GQA and
     ragged in f32), with times of kernel, plain version and
     ``scaled_dot_product_attention`` (a yardstick the port never calls)
     beside the least time the card could take;
  4. serve   — full-width StableLM-1.6B (bf16, random weights from a seed)
     behind ``InferenceEngine``: 8 requests, 4 slots, mid-flight joins;
     every request done, the kernel launched 24 times per prefill batch,
     three engines with one seed (cold, warm, profiled) give the same
     tokens; at full width cut to 2 layers, prefill (kernel attention)
     agrees with decode (plain attention) in f32; then the kernel against
     its plain version at every prefill shape the serve gave it;
  5. result  — ``{"kernels": [...]}`` on the line before the last and
     ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

H100_BF16_FLOPS = 989e12       # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # f32 outside the tensor cores
H100_HBM_BYTES = 3.35e12       # HBM3 bytes/s
TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # tests/test_kernels.py:34
SERVE_ARCH = "stablelm-1.6b"
SERVE_REQUESTS = [(128, 16), (128, 32), (128, 24), (128, 20),
                  (512, 32), (512, 16), (33, 24), (7, 32)]  # (prompt, max_new)
# prefill (kernel) vs decode (plain) logits, relative L2, f32 at 2 layers:
# the two paths sum in other orders (~1e-6 expected)
PREFILL_DECODE_RTOL = 1e-4


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


def attention_bound_ms(B, Sq, Sk, H, KV, hd, dtype, causal, q_offset=0):
    """Least time for this call on an H100: bytes (q, k, v read once, o
    written once) over HBM rate vs FLOPs of the unmasked score pairs
    (QK^T and PV, 2 FLOP per multiply-add) over the peak for the type."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * B * Sq * H + 2 * B * Sk * KV) * hd * esize
    if causal:
        pairs = sum(min(Sk, i + 1 + q_offset) for i in range(Sq))
    else:
        pairs = Sq * Sk
    flops = 4 * B * H * hd * pairs
    peak = H100_BF16_FLOPS if dtype == "bfloat16" else H100_F32_FLOPS
    t_bytes, t_ops = nbytes / H100_HBM_BYTES, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
            "bound_ms": bound_ms, "bound_by": bound_by}


class PrefillRecorder:
    """Duck-typed tracer for the engine: records each prefill batch's
    (n, plen); request spans and decode events are ignored."""

    def __init__(self):
        self.prefills = []

    def span(self, job_id, name, **attrs):
        import contextlib
        if name == "prefill":
            self.prefills.append((attrs["n"], attrs["plen"]))
        return contextlib.nullcontext()

    def start(self, job_id, name, **attrs):
        return name

    def end(self, span, **attrs):
        pass

    def event(self, job_id, name, **attrs):
        pass


def serve(torch, cfg, ops, seed: int, card: str, profile: bool = False):
    """One full serve through the engine's public API. Returns (tokens per
    request, engine, prefill shapes, launches, wall seconds, profiler or
    None)."""
    import numpy as np
    from repro_torch.serving.engine import InferenceEngine
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype("int32")
               for n, _ in SERVE_REQUESTS]
    torch.cuda.reset_peak_memory_stats()
    rec = PrefillRecorder()
    eng = InferenceEngine(cfg, capacity=4, max_seq=1024, max_queue=16,
                          seed=seed, device="cuda", tracer=rec,
                          endpoint_id="chip-smoke")
    t0 = time.perf_counter()
    eng.start(None)
    torch.cuda.synchronize()
    print(f"[serve] {card}: weights + cache ready in "
          f"{time.perf_counter() - t0:.2f} s")
    reqs = [eng.submit(p, max_new=m)
            for p, (_, m) in zip(prompts, SERVE_REQUESTS)]
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
    for r, (plen, m) in zip(reqs, SERVE_REQUESTS):
        if r.status != "DONE" or len(r.tokens) != m:
            raise AssertionError(f"request plen={plen}: {r.status}, "
                                 f"{len(r.tokens)}/{m} tokens {r.error}")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"token out of vocab: {r.tokens}")
    return [r.tokens for r in reqs], eng, rec.prefills, launches, wall, prof


def print_profile(prof, wall: float, card: str, top: int = 8):
    """Device busy share of the serve's wall time and the kernels that
    took the most device time, from the profiler's CUDA events."""
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
        return
    busy = sum(kernels.values()) / 1e6
    print(f"[profile] {card}: device busy {busy:.3f} s of {wall:.3f} s "
          f"wall = {busy / wall:.3f} (idle share {1 - busy / wall:.3f}), "
          f"{n_launches} device events under {len(kernels)} names")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    ours = [kv for kv in ranked[top:] if "flash_fwd_kernel" in kv[0]]
    for name, us in ranked[:top] + ours:
        print(f"[profile] {card}: {us / 1e3:9.3f} ms "
              f"{us / 1e6 / busy:6.3f} of busy  {name[:110]}")


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as kfa

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
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {r.name}: {line.strip()}")

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
        tokens, eng, prefills, launches, wall = run[:5]
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
              f" GiB; flash launches {launches}")
        if label == "profiled":
            print_profile(run[5], wall, card)
        eng.release()
        runs.append((tokens, prefills, launches))
        del eng, run
        torch.cuda.empty_cache()
    print(f"[serve] {card}: {len(runs)} engines, same seed: identical tokens")
    tokens, prefills, launches = runs[0]

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
    head = max(main_path, key=lambda r: r["bound_ms"])

    # 5. result
    entry = {"name": kfa.NAME, "route": "cuda", "source": kfa.SOURCE,
             "replaces": kfa.REPLACES, "launches": launches[kfa.NAME],
             "max_abs_err": max(r["max_abs_err"] for r in main_path),
             "ms": head["ms"], "kernel_ms": head["ms"],
             "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
             "bound_by": head["bound_by"],
             "library_ms": head["library_ms"], "shape": head["shape"],
             "card": card, "shapes": main_path}
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
