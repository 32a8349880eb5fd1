"""Serving through the port's ``InferenceEngine``: ``run`` on a server
thread, ``submit`` from one client thread on an open-loop schedule.

Set-up starts the engine (``start(None)``), writes the benchmark's
weights into its parameters, waits for ``status.perf``'s background
count, tunes K4's launch shape for every prompt length the traffic
holds (the tuner keys on the exact length) and serves a few warm-up
requests across the lengths' range. Then the client sends a lead-in
block, to bring the engine to its steady load, the measured window's
block, and a tail block that keeps the load on until every request due
in the window has finished or the drain limit has passed; the engine's
own abort hook (``control``) then stops ``run`` at a step boundary.

A request's latency runs from when it was due to the engine's
``finished_ts``; one refused, failed, expired or unfinished counts as
infinitely late. Which requests shared a prefill batch follows from the
engine's ``prefill`` spans (each names its batch size) taken in the
queue's FIFO order; the reference prefills them together, since a
prefill's expert capacity is over the whole batch.
"""
from __future__ import annotations

import math
import threading
import time

import numpy as np

from bench import traffic, weights
from bench.common import percentile
from bench.runners import Run, card_sample, port_config, sync
from bench.reference import lm as ref_lm

BLOCK_LEAD, BLOCK_WINDOW, BLOCK_TAIL = 0, 1, 2
# a served token more than this below the reference's best logit is off
# the best; a router margin under FLIP_MARGIN is where a rounding can
# swap one of a token's experts for another
OFF_BEST = 0.1
FLIP_MARGIN = 0.01
WARM_LENGTHS = 8        # engine warm-up prompts across the lengths' range


class Recorder:
    """A tracer for the engine (``start``/``end``/``span``/``event``):
    keeps its prefill spans in order."""

    def __init__(self):
        self.lock = threading.Lock()
        self.prefills = []          # (t_start, t_end, n, plen)

    def start(self, job_id, name, **attrs):
        return (name, time.time(), attrs)

    def end(self, span, status="ok", **attrs):
        name, t0, a = span
        if name == "prefill":
            with self.lock:
                self.prefills.append((t0, time.time(), a["n"], a["plen"]))

    def span(self, job_id, name, **attrs):
        rec = self

        class _Ctx:
            def __enter__(self):
                self.sp = rec.start(job_id, name, **attrs)
                return self.sp

            def __exit__(self, *exc):
                rec.end(self.sp)
                return False
        return _Ctx()

    def event(self, job_id, name, **attrs):
        pass


class Stop(Exception):
    """Raised at a step boundary to end ``run``."""


class Stopper:
    """The engine's pause gate, called on its own thread at every step
    boundary: ends ``run`` once ``stop`` is set, and drives ``ops`` (an
    ``OpsTrace``) while one is set."""
    fenced = False

    def __init__(self):
        self.stop = False
        self.ops = None

    def wait_while_paused(self, should_abort=None):
        if self.stop:
            raise Stop()
        ops = self.ops
        if ops is not None:
            ops.at_boundary()


class OpsTrace:
    """A trace with the host ops of the engine's thread, which the
    profiler records only on the thread that starts it: that thread
    starts it at one step boundary, begins it ``settle_s`` later and
    stops it ``span_s`` after that; ``done`` is set then."""

    def __init__(self, settle_s: float, span_s: float, dev):
        from bench.trace import Profile
        self.prof = Profile(cpu=True)
        self.settle_s, self.span_s, self.dev = settle_s, span_s, dev
        self.phase, self.t = 0, 0.0
        self.done = threading.Event()

    def at_boundary(self):
        now = time.time()
        if self.phase == 0:
            self.prof.start()
            self.phase, self.t = 1, now
        elif self.phase == 1 and now - self.t >= self.settle_s:
            self.prof.begin()
            self.phase, self.t = 2, now
        elif self.phase == 2 and now - self.t >= self.span_s:
            sync(self.dev)
            self.prof.stop()
            self.phase = 3
            self.done.set()


def run(ctx) -> Run:
    import torch
    from repro_torch.kernels import autotune, ops
    from repro_torch.serving.engine import (R_DONE, R_FAILED,
                                            InferenceEngine, QueueFull)

    mix, seed, dev = ctx.mix, ctx.seed, ctx.device
    spec = weights.spec_of(ctx.config)
    cfg = port_config(ctx.config)
    W = float(ctx.seconds)
    rec = Recorder()
    eng = InferenceEngine(cfg, capacity=mix["capacity"],
                          max_seq=mix["max_seq"], max_queue=mix["max_queue"],
                          seed=seed, tracer=rec, device=dev,
                          endpoint_id="bench-serve")
    if str(dev).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    eng.start(None)
    with torch.no_grad():
        weights.fill_tree(spec, eng.params, seed)
    blocks = {BLOCK_LEAD: traffic.serve_block(mix, spec.vocab, seed,
                                              BLOCK_LEAD, mix["lead_s"]),
              BLOCK_WINDOW: traffic.serve_block(mix, spec.vocab, seed,
                                                BLOCK_WINDOW, W),
              BLOCK_TAIL: traffic.serve_block(mix, spec.vocab, seed,
                                              BLOCK_TAIL, mix["drain_s"])}
    if mix.get("tune_in_setup", True):
        warm_tuner(ops, spec, blocks, dev)
    stopper = Stopper()
    errors = []

    def server():
        try:
            eng.run(control=stopper)
        except Stop:
            pass
        except BaseException as e:            # reported below
            errors.append(e)

    srv = threading.Thread(target=server, daemon=True, name="engine-run")
    srv.start()
    warm_engine(eng, mix, spec, seed, errors)
    t_perf = time.time()
    while eng.perf.state in ("pending", "running") and \
            time.time() - t_perf < 300:
        time.sleep(0.05)
    n_warm_prefills = len(rec.prefills)

    # the open loop: lead-in, window, tail
    sent = []               # (block, index, due wall time, request | None)
    state = {"late_s": 0.0, "stop": False}
    lead = mix["lead_s"]
    start = time.time() + 0.5
    t0 = start + lead
    t_end = t0 + W
    drain_deadline = t_end + mix["drain_s"]

    def client():
        sched = ([(BLOCK_LEAD, i, start + r.due, r)
                  for i, r in enumerate(blocks[BLOCK_LEAD])]
                 + [(BLOCK_WINDOW, i, t0 + r.due, r)
                    for i, r in enumerate(blocks[BLOCK_WINDOW])]
                 + [(BLOCK_TAIL, i, t_end + r.due, r)
                    for i, r in enumerate(blocks[BLOCK_TAIL])])
        for blk, i, due, r in sched:
            while not state["stop"]:
                wait = due - time.time()
                if wait <= 0:
                    break
                time.sleep(min(wait, 0.05))
            if state["stop"]:
                return
            state["late_s"] = max(state["late_s"], time.time() - due)
            try:
                req = eng.submit(r.prompt, r.max_new)
            except QueueFull:
                req = None
            sent.append((blk, i, due, req))

    cl = threading.Thread(target=client, daemon=True, name="client")
    cl.start()
    _sleep_until(t0)
    snap0 = _snapshot(eng)
    misses0 = autotune.get_cache().misses
    card = {"window_start": card_sample(dev)}
    depth = []              # (seconds into the window, queue depth)
    while time.time() < t_end:
        depth.append((time.time() - t0, eng.stats()["queue_depth"]))
        time.sleep(min(0.5, max(0.0, t_end - time.time())))
    snap1 = _snapshot(eng)
    tunings = autotune.get_cache().misses - misses0
    card["window_end"] = card_sample(dev)
    summary = summary_ops = None
    if ctx.trace:
        # after the window, with the tail's load on: the device trace,
        # then a short one with the engine thread's host ops, to tell the
        # expert products' kernels apart (it slows that thread)
        from bench.trace import Profile
        with Profile() as prof:
            time.sleep(1.0)
            prof.begin()
            time.sleep(mix["trace_s"])
            sync(dev)
        summary = prof.summary
        ops = OpsTrace(1.0, mix["trace_ops_s"], dev)
        stopper.ops = ops
        t_ops = time.time()
        while not ops.done.wait(0.1):
            if errors or not srv.is_alive() or time.time() - t_ops > 120:
                raise RuntimeError("the engine's thread did not trace "
                                   "its ops") from (errors[0] if errors
                                                    else None)
        stopper.ops = None
        summary_ops = ops.prof.reduce()
    while time.time() < drain_deadline and not errors:
        win = [s for s in sent if s[0] == BLOCK_WINDOW]
        if len(win) == len(blocks[BLOCK_WINDOW]) and all(
                s[3] is None or s[3].done.is_set() for s in win):
            break
        time.sleep(0.05)
    t_drained = time.time()
    # a request the engine failed never comes; one refused, expired or
    # unfinished at the drain limit is late (counted in the latencies)
    engine_failed = sum(1 for s in sent if s[0] == BLOCK_WINDOW
                        and s[3] is not None and s[3].status == R_FAILED)
    state["stop"] = True
    cl.join(30)
    stopper.stop = True
    srv.join(120)
    if errors:
        raise RuntimeError("the engine failed") from errors[0]
    if srv.is_alive() or cl.is_alive():
        raise RuntimeError("the engine or the client did not stop")
    peak = (torch.cuda.max_memory_allocated()
            if str(dev).startswith("cuda") else 0)

    # every request due in the window, each as late as it was
    lat, failed, done = [], 0, []
    by_index = {s[1]: s for s in sent if s[0] == BLOCK_WINDOW}
    for i, r in enumerate(blocks[BLOCK_WINDOW]):
        s = by_index.get(i)
        req = s[3] if s else None
        if req is not None and req.status == R_DONE:
            lat.append(req.finished_ts - s[2])
            done.append((i, req))
        else:
            lat.append(math.inf)
            failed += 1
    prefills = rec.prefills[n_warm_prefills:]
    in_window = [p for p in prefills if t0 <= p[1] < t_end]
    record = {
        "spec": spec, "mix": mix, "window_s": W, "trace": summary,
        "trace_ops": summary_ops,
        "capacity": eng.capacity,
        "decode_seconds": snap1["decode_seconds"] - snap0["decode_seconds"],
        "decode_steps": snap1["decode_steps"] - snap0["decode_steps"],
        "occupied_slot_steps": (snap1["occupied_slot_steps"]
                                - snap0["occupied_slot_steps"]),
        "prefill_seconds": (snap1["prefill_seconds"]
                            - snap0["prefill_seconds"]),
        "prefills": [(n, plen) for _, _, n, plen in in_window],
        "client_late_s": state["late_s"],
        "latencies_s": lat,
        "dues_s": [r.due for r in blocks[BLOCK_WINDOW]],
        "tunings_in_window": tunings,
        "queue_depth": depth,
        "card": card,
    }
    submitted = [s[3] for s in sent if s[3] is not None]
    groups = prefill_groups(submitted, prefills)
    eng.release()
    del eng
    if str(dev).startswith("cuda"):
        torch.cuda.empty_cache()
    checks, notes, extra = compare(spec, mix, ctx.limits, seed, dev, done,
                                   groups, ctx.control)
    checks["failed_requests"] = (float(engine_failed), 0.0)
    notes.append(f"drained {t_drained - t_end:.1f} s after the window; "
                 f"client at most {state['late_s'] * 1e3:.1f} ms late")
    e2e = {"req_latency_p95_ms": 1e3 * _finite(percentile(lat, 95),
                                               t_drained - t0),
           "req_latency_p50_ms": 1e3 * _finite(percentile(lat, 50),
                                               t_drained - t0),
           "setup_s": t0 - ctx.t_start}
    return Run(end_to_end=e2e, record=record, checks=checks,
               attempted=len(lat), failed=failed, memory_peak_bytes=peak,
               notes=notes, extra=extra)


def _finite(v, waited):
    """A percentile that falls on a request that never came back reads as
    the longest wait the run saw for one: from the window's start to the
    moment it stopped waiting."""
    return v if math.isfinite(v) else waited


def _sleep_until(t):
    while True:
        d = t - time.time()
        if d <= 0:
            return
        time.sleep(min(d, 0.05))


def _snapshot(eng):
    st = eng.stats()
    return {"decode_seconds": eng.decode_seconds,
            "prefill_seconds": eng.prefill_seconds,
            "decode_steps": st["decode_steps"],
            "occupied_slot_steps": st["occupied_slot_steps"]}


def warm_tuner(ops, spec, blocks, dev):
    """K4's launch shape for every prompt length of the run (and for a
    batch of two where a length repeats), so no tuning runs in the
    window."""
    import torch
    if not str(dev).startswith("cuda"):
        return
    counts = {}
    for blk in blocks.values():
        for r in blk:
            counts[len(r.prompt)] = counts.get(len(r.prompt), 0) + 1
    with torch.no_grad():
        for plen, c in sorted(counts.items()):
            for b in (1, 2) if c > 1 else (1,):
                q = torch.zeros((b, plen, spec.heads, spec.hd),
                                dtype=spec.torch_dtype, device=dev)
                kv = torch.zeros((b, plen, spec.kv, spec.hd),
                                 dtype=spec.torch_dtype, device=dev)
                ops.flash_attention(q, kv, kv, causal=True)
    sync(dev)


def warm_engine(eng, mix, spec, seed, errors):
    """Serve a few requests across the prompt lengths' range, one at a
    time and two of the longest together, and decode at full capacity."""
    p = mix["prompt"]
    lengths = np.unique(np.geomspace(p["min"], p["max"], WARM_LENGTHS)
                        .astype(int))
    g = traffic.rng(seed, 99)
    reqs = []
    for plen in list(lengths) + [p["max"]]:
        reqs.append(eng.submit(g.integers(0, spec.vocab, int(plen)), 2))
        if plen != p["max"]:
            reqs[-1].wait(300)
    for r in reqs:
        if not r.wait(300) or errors:
            raise RuntimeError("warm-up request did not finish") \
                from (errors[0] if errors else None)


def prefill_groups(submitted, prefills):
    """The requests of each prefill batch: the engine admits FIFO, so
    batch i is the next n_i requests in submission order."""
    groups, k = [], 0
    for _, _, n, plen in prefills:
        grp = submitted[k:k + n]
        k += n
        if len(grp) != n or any(len(r.prompt) != plen for r in grp):
            raise RuntimeError("prefill batches do not follow the queue")
        groups.append(grp)
    return groups


def sample(done, mix, seed):
    """The finished window requests the reference checks: the one with the
    most served tokens and others drawn from the seed."""
    if not done:
        return []
    longest = max(done, key=lambda d: (len(d[1].tokens), -d[0]))
    rest = [d for d in done if d is not longest]
    g = traffic.rng(seed, 77)
    pick = [rest[j] for j in g.permutation(len(rest))[
        : mix["check_requests"] - 1]]
    return [longest] + pick


def compare(spec, mix, lim, seed, dev, done, groups, control=False):
    """The share of the sampled requests' served tokens whose logit lies
    more than ``OFF_BEST`` below the reference's best, in %; with
    ``control``, the same share of the tokens the reference in fp8 puts
    first at the same positions. The widest gap and how many of the
    tokens off the best sit where the router's top-k margin is under
    ``FLIP_MARGIN`` (where a rounding can swap an expert) go into the
    notes."""
    notes = []
    n_tok = n_off = n_ctrl = n_flip = n_low = 0
    widest, worst = 0.0, None
    short = [r for _, r in done if len(r.tokens) != r.max_new]
    chosen = sample(done, mix, seed)
    for i, req in chosen:
        grp = next(g for g in groups if any(r is req for r in g))
        b = next(j for j, r in enumerate(grp) if r is req)
        g_i, c_i, m_i = token_gaps(spec, seed, dev, grp, b, control)
        off = g_i > OFF_BEST
        n_tok += len(g_i)
        n_off += int(off.sum())
        if m_i is not None:
            low = m_i < FLIP_MARGIN
            n_low += int(low.sum())
            n_flip += int((off & low).sum())
        if worst is None or g_i.max() > widest:
            widest, worst = float(g_i.max()), i
        if c_i is not None:
            n_ctrl += int((c_i > OFF_BEST).sum())
    pct = 100.0 * n_off / max(1, n_tok)
    notes.append(f"checked {len(chosen)} requests, {n_tok} served tokens: "
                 f"{n_off} more than {OFF_BEST} below the best, {n_flip} of "
                 f"them where a router margin is under {FLIP_MARGIN} (such "
                 f"margins at {n_low} of all); widest gap {widest:.4f} in "
                 f"window request {worst}")
    checks = {"off_best_pct": (pct, lim["off_best_pct"]),
              "short_requests": (float(len(short)), 0.0),
              "checked_requests": (0.0 if chosen else 1.0, 0.0)}
    extra = ({"control_fp8": {"off_best_pct": 100.0 * n_ctrl
                              / max(1, n_tok)}} if control else {})
    return checks, notes, extra


def token_gaps(spec, seed, dev, group, b, control=False):
    """For member ``b`` of a prefill batch, at each served token: the
    reference's best logit minus the served token's; with ``control``,
    minus that of the token the fp8 reference puts first; and the
    smallest router margin over the layers there (moe)."""
    import torch
    ref_lm.strict_f32()

    def get(path, idx):
        return weights.draw(spec, path, idx, seed, dev, torch.float32)

    served = np.asarray(group[b].tokens, np.int64)
    prompts = [np.asarray(r.prompt) for r in group]
    margins = {} if spec.family == "moe" else None
    with torch.no_grad():
        logits = ref_lm.serve_logits(spec, get, prompts, {b: served}, "f32",
                                     dev, margins)[b]
        best = logits.max(dim=-1).values
        tok = torch.as_tensor(served, device=logits.device)
        g = (best - logits.gather(1, tok[:, None])[:, 0]).cpu().numpy()
        c = None
        if control:
            low = ref_lm.serve_logits(spec, get, prompts, {b: served},
                                      "fp8", dev)[b]
            first = low.argmax(dim=-1)
            c = (best - logits.gather(1, first[:, None])[:, 0]).cpu().numpy()
    m = margins[b].cpu().numpy() if margins else None
    return g, c, m
