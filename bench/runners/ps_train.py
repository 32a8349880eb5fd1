"""Training through the software PS, as the platform runs a ``psgd`` job:
``make_learner_body``'s body on one thread a learner, over one
``SoftwareParameterServer`` and a ``PSClient`` a learner.

Set-up draws the weights from the seed into the PS and starts the
learners; the body's own hooks (``control.wait_while_paused`` at each
step boundary) hold both learners after round 1 and after round 3, where
the benchmark reads the optimizer's first moment and the parameters.
The same learners run on into the window, which starts at a step
boundary once the first rounds have warmed every shape and ends at the
first boundary ``--seconds`` later; then ``maybe_preempt`` stops each
learner at its next boundary. Nothing is written: no checkpoint and no
trained model (the body uploads only after its last step).

The learners' rows come from the benchmark (``traffic.train_batch``):
``flat_loss_grad`` is handed them in place of the program's synthetic
corpus. Once the program is freed, the plain reference follows the
first three rounds from the same weights and rows.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict

from bench import traffic, weights
from bench.runners import (Clock, Run, card_sample, port_config, sync,
                           worst_leaf_gap, worst_leaf_ratio)
from bench.reference import lm as ref_lm
from bench.reference import ps as ref_ps

CHECKED_ROUNDS = 3      # rounds the reference follows
WINDOW_FROM = 4         # the window starts when this step has finished
JOIN_S = 120.0


def run(ctx) -> Run:
    import torch
    from repro_torch.core.cursor import GlobalCursor
    from repro_torch.core.software_ps import SoftwareParameterServer
    from repro_torch.errors import Preempted
    from repro_torch.platform.metrics import MetricsService
    from repro_torch.platform.storage import StorageManager
    from repro_torch.platform.zookeeper import ZooKeeper
    from repro_torch.runtime.learner import (LearnerJobConfig, LMPlugin,
                                             make_learner_body)

    mix, seed, dev = ctx.mix, ctx.seed, ctx.device
    spec = weights.spec_of(ctx.config)
    cfg = port_config(ctx.config)
    n_l = mix["learners"]
    local = threading.local()

    class FedPlugin(LMPlugin):
        """The port's LM plugin, handed the benchmark's rows."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.calls = defaultdict(int)

        def flat_loss_grad(self, flat, batch):
            i = local.idx
            k = self.calls[i]
            self.calls[i] += 1
            return super().flat_loss_grad(
                flat, traffic.train_batch(mix, spec.vocab, seed, i, k))

    clock = Clock()
    gate = Gate(local)

    class Wd:
        """The watchdog's hooks the body calls."""

        def __init__(self, idx):
            self.idx = idx

        def maybe_preempt(self):
            if gate.stop:
                raise Preempted(f"learner-{self.idx}: window closed")

        def heartbeat(self, step, **kw):
            clock.add(self.idx, step, kw.get("loss"))

        def log(self, line):
            pass

        def set_status(self, *a, **kw):
            pass

        def crash(self):
            pass

    job = "bench-train"
    metrics = MetricsService()
    plugin = FedPlugin({}, cfg=cfg, device=dev)
    theta0 = weights.flat_vector(spec, seed, dev)
    ps = SoftwareParameterServer(
        theta0, n_shards=mix["shards"], n_learners=n_l,
        optimizer=mix["optimizer"], lr=mix["lr"], trigger=mix["trigger"],
        compression=mix["compression"], metrics=metrics, job_id=job,
        device=dev)
    del theta0
    zk = ZooKeeper()
    jcfg = LearnerJobConfig(
        job_id=job, data_cfg={"seq_len": mix["seq_len"], "n_docs": 1 << 20,
                              "seed": 0},
        n_learners=n_l, batch_docs=mix["batch_docs"], steps=1 << 40,
        lr=mix["lr"], optimizer=mix["optimizer"], solver="psgd",
        compression=mix["compression"], seed=seed)
    cursor = GlobalCursor(zk, f"/jobs/{job}/cursor", dataset_size=1 << 20)
    body = make_learner_body(jcfg, ps, cursor, StorageManager(), metrics,
                             None, control=gate, plugin=plugin)
    errors = []

    def learner(i):
        local.idx = i
        try:
            body(Wd(i), i)
        except Preempted:
            pass
        except BaseException as e:          # reported by the main thread
            errors.append(e)
            gate.halt()

    gate.pause_at.update({1, CHECKED_ROUNDS})
    if str(dev).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    threads = [threading.Thread(target=learner, args=(i,), daemon=True,
                                name=f"learner-{i}") for i in range(n_l)]
    for th in threads:
        th.start()

    def done(i, step):
        return lambda evs: errors or any(e[1] == i and e[2] == step
                                         for e in evs)

    try:
        # round 1 done: the optimizer's first moment holds the first
        # mean gradient as the optimizer got it
        gate.park(1, n_l, errors)
        m = ps._m[: ps.size]
        grad1 = {k: v / (1 - ps.b1) for k, v in
                 weights.leaf_norms(spec, m).items()}
        # the first mean gradient itself, held off the card for the
        # comparison after the window
        grad1_flat = m.to("cpu", copy=True)
        grad1_scale = 1.0 / (1 - ps.b1)
        gate.release(1)
        gate.park(CHECKED_ROUNDS, n_l, errors)
        change = weights.leaf_norms(spec, ps._params[: ps.size],
                                    minus_seed=seed)
        gate.release(CHECKED_ROUNDS)
        clock.wait_for(done(0, WINDOW_FROM), 600)
        _raise(errors)
        t0 = _time_of(clock, 0, WINDOW_FROM)
        setup_s = time.time() - (time.perf_counter() - t0) - ctx.t_start
        card = {"window_start": card_sample(dev)}
        clock.wait_for(lambda evs: errors or any(
            e[1] == 0 and e[0] >= t0 + ctx.seconds for e in evs), 600)
        _raise(errors)
        t1, s1 = next((e[0], e[2]) for e in clock.events
                      if e[1] == 0 and e[0] >= t0 + ctx.seconds)
        card["window_end"] = card_sample(dev)
        summary = None
        if ctx.trace:
            # the device trace of a few steps after the window, which
            # the profiler would slow
            from bench.trace import Profile
            with Profile() as prof:
                clock.wait_for(done(0, s1 + 1), 600)
                prof.begin()
                clock.wait_for(done(0, s1 + 1 + mix["trace_steps"]), 600)
                sync(dev)
            summary = prof.summary
    finally:
        gate.halt()
        for th in threads:
            th.join(JOIN_S)
    _raise(errors)
    if any(th.is_alive() for th in threads):
        raise RuntimeError("a learner did not stop")
    peak = (torch.cuda.max_memory_allocated()
            if str(dev).startswith("cuda") else 0)
    steps = s1 - WINDOW_FROM
    tokens = n_l * steps * mix["batch_docs"] * mix["seq_len"]
    window_s = t1 - t0
    series = metrics.series(job, "sync_time_s")
    sync_s = [v for st, v in zip(series.steps, series.values)
              if WINDOW_FROM < st <= s1]
    stats = ps.stats()
    padded = ps.layout.padded
    losses = {(e[1], e[2]): e[3] for e in clock.events
              if e[2] < CHECKED_ROUNDS}
    ps.release()
    del ps, body, plugin, m
    if str(dev).startswith("cuda"):
        torch.cuda.empty_cache()

    checks, extra = compare(spec, mix, ctx.limits, seed, dev,
                            (losses, grad1, change,
                             (grad1_flat, grad1_scale)), n_l, ctx.control)
    del grad1_flat
    # a push that timed out lost its learner's gradient for the round
    checks["push_timeouts"] = (float(stats["push_timeouts"]), 0.0)
    record = {"spec": spec, "mix": mix, "window_s": window_s,
              "tokens": tokens, "steps": steps * n_l, "sync_s": sync_s,
              "ps_stats": stats, "trace": summary, "ps_padded": padded,
              "grad_esize": spec.torch_dtype.itemsize, "card": card}
    return Run(end_to_end={"train_tokens_per_s": tokens / window_s,
                           "setup_s": setup_s},
               record=record, checks=checks, attempted=steps * n_l,
               failed=stats["push_timeouts"], memory_peak_bytes=peak,
               extra=extra)


def gaps(spec, got, want) -> dict:
    """The numbers compared, of readings ``got`` against the reference's
    ``want`` (each (losses, grad1, change, (first gradient, its scale))):
    each step's loss; the first mean gradient as the optimizer took it,
    by leaf, as the gap of its norm and as the norm of its difference;
    and the parameters' change by leaf after the checked rounds (leaves
    whose first reference gradient is under a thousandth of the median
    leaf's left out). The difference is what tells a lower precision:
    its rounding moves every value, and a leaf's norm hardly at all."""
    losses, grad1, change, flat = got
    want_loss, want_grad1, want_change, want_flat = want
    loss_gap = max(abs(losses[k] - v) / abs(v) for k, v in want_loss.items())
    med = sorted(want_grad1.values())[len(want_grad1) // 2]
    moved = {n for n, v in want_grad1.items() if v >= 1e-3 * med}
    diff = weights.leaf_diff_norms(spec, flat[0], flat[1], want_flat[0])
    return {"loss_rel_gap": loss_gap,
            "grad1_norm_gap": worst_leaf_gap(grad1, want_grad1)[0],
            "grad1_diff": worst_leaf_ratio(diff, want_grad1)[0],
            "change_norm_gap": worst_leaf_gap(change, want_change,
                                              moved)[0]}


def compare(spec, mix, lim, seed, dev, got, n_l, control=False):
    """(checks, readings of the control and the planted faults): the
    reference's first rounds against the program's; with ``control``
    also the reference in fp8 and with half of each batch left out, each
    against the f32 reference."""
    ref_lm.strict_f32()
    want = reference_rounds(spec, mix, seed, dev, n_l, "f32")
    checks = {k: (v, lim[k]) for k, v in gaps(spec, got, want).items()}
    extra = {}
    if control:
        extra["control_fp8"] = gaps(spec, reference_rounds(
            spec, mix, seed, dev, n_l, "fp8"), want)
        extra["fault_half_batch"] = gaps(spec, reference_rounds(
            spec, mix, seed, dev, n_l, "f32", half=True), want)
    return checks, extra


def reference_rounds(spec, mix, seed, dev, n_l, prec, half=False):
    """(loss by (learner, step), first mean gradient's leaf norms, the
    parameters' change by leaf after ``CHECKED_ROUNDS`` rounds, (the
    first mean gradient, 1.0))."""
    import torch
    theta0 = weights.flat_vector(spec, seed, dev)
    server = ref_ps.AdamServer(theta0, mix["lr"])
    del theta0
    err = [torch.zeros(ref_ps.padded(server.theta.numel()),
                       dtype=torch.float32, device=dev) for _ in range(n_l)]
    losses, grad1, g1 = {}, None, None
    for k in range(CHECKED_ROUNDS):
        pushes = []
        for i in range(n_l):
            b = traffic.train_batch(mix, spec.vocab, seed, i, k)
            toks, labs = b["tokens"], b["labels"]
            if half:            # the fault: half of the batch left out
                toks, labs = (x[:, : x.shape[1] // 2] for x in (toks, labs))
            loss, g = ref_lm.loss_and_grad(spec, server.theta, toks, labs,
                                           prec)
            losses[(i, k)] = loss
            pushes.append(ref_ps.wire(g, err[i]))
            del g
        g = server.round(pushes)
        del pushes
        if k == 0:
            grad1, g1 = weights.leaf_norms(spec, g), g
        del g
    del err
    change = weights.leaf_norms(spec, server.theta, minus_seed=seed)
    return losses, grad1, change, (g1, 1.0)


class Gate:
    """The body's ``control``: holds every learner at a chosen step
    boundary until the benchmark has read the state there, and stops
    them once the window has closed."""
    fenced = False

    def __init__(self, local):
        self.local = local
        self.cond = threading.Condition()
        self.pause_at = set()
        self.parked = {}
        self.count = defaultdict(int)
        self.stop = False

    def wait_while_paused(self, should_abort=None):
        idx = self.local.idx
        with self.cond:
            k = self.count[idx]
            self.count[idx] += 1
            if k in self.pause_at and not self.stop:
                self.parked[idx] = k
                self.cond.notify_all()
                self.cond.wait_for(lambda: k not in self.pause_at
                                   or self.stop)
                self.parked.pop(idx, None)
        if should_abort is not None:
            should_abort()

    def take_checkpoint_request(self):
        return False

    def park(self, k, n, errors, timeout=600.0):
        with self.cond:
            ok = self.cond.wait_for(
                lambda: errors or self.stop or sum(
                    1 for v in self.parked.values() if v == k) == n,
                timeout)
        _raise(errors)
        if not ok:
            raise TimeoutError(f"learners did not reach step {k}")

    def release(self, k):
        with self.cond:
            self.pause_at.discard(k)
            self.cond.notify_all()

    def halt(self):
        with self.cond:
            self.stop = True
            self.cond.notify_all()


def _time_of(clock, learner, step):
    return next(e[0] for e in clock.events
                if e[1] == learner and e[2] == step)


def _raise(errors):
    if errors:
        raise RuntimeError("a learner failed") from errors[0]
