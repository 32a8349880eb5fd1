"""Learner runtime — the ``train.sh`` analogue executed under watchdog
supervision: the counterpart of ``repro/runtime/learner.py``.

Pluggable "frameworks" (paper §Extensibility) register in ``PLUGINS``:
``repro-lm`` (``LMPlugin``) and ``repro-mlp`` (``MLPPlugin``), as in the
reference. ``make_learner_body`` returns
the learner body with the reference's semantics (learner.py:311-448):
resume from the newest valid checkpoint (learner 0 republishes through
``ps.load_flat`` and restores the cursor), pull, the psgd and modelavg
branches, the ``fail_at_step`` / ``user_error_at`` hooks, a checkpoint
every ``checkpoint_every`` steps, ``trained_model.npy`` uploaded by
learner 0, and ``results``. Two differences: before its first pull each
learner waits at the PS's start barrier (``SoftwareParameterServer.start``)
until every learner of the job has started, for at most the PS's
``BSP_TIMEOUT_S`` and only under the ``bsp`` trigger, where the
reference's learner pulls at once and a late starter can take its step 0
on weights that a round finished without it; and a learner that raises
waits for its outstanding checkpoint write before its task fails, where
the reference's restart can probe before that write has landed and
start from an older checkpoint. A learner other than 0 restarted while
learner 0's checkpoint is still being written waits for it (at most
``BSP_TIMEOUT_S``) and reads only its step, so both resume from the same
step; in the reference it starts from an older one and the two run
different numbers of steps. Two more, for a task that ends without
finishing: a learner releases its ``PSClient``'s buffers as it leaves,
so an exception somebody keeps (and with it the learner's frames) holds
no device memory; and a learner of a crashed core (``control.fenced``,
set by ``DLaaSCore.crash``) stops before a checkpoint or the model
upload instead of writing it, as a killed process would.

The learner's state is the flat f32 weight vector, as in the reference,
but it lives on the device: the PS pull buffer, the gradient, the push
and the checkpoint snapshot all start from device tensors, and only the
checkpoint and the uploaded model go to the host. ``LMPlugin.warm_async``
starts the first-use ``nvcc`` build of the step's kernels, the port's
counterpart of the reference's XLA warm compile. Each plugin's
``program_cost`` counts its step on the meta device for ``JobPerf``
(``analysis/roofline.py:count_program``), where the reference's
``lowered_hlo`` hands it the step's compiled HLO.
"""
from __future__ import annotations

import copy
import io
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.analysis.roofline import count_program
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig, reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.core.cursor import GlobalCursor
from repro_torch.core.software_ps import (BSP_TIMEOUT_S,
                                          SoftwareParameterServer, as_flat)
from repro_torch.data.pipeline import DatasetSpec, SyntheticCorpus
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.errors import Preempted, UserError
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as _kfa
from repro_torch.kernels import flash_attention_bwd as _kfab
from repro_torch.kernels import ssd_scan as _kssd
from repro_torch.kernels import ssd_scan_bwd as _kssdb
from repro_torch.models import make_model
from repro_torch.models.layers import init_leaf, iter_leaves
from repro_torch.observability.trace import TRACE_STEP_SAMPLE, maybe_span
from repro_torch.platform.metrics import MetricsService
from repro_torch.platform.storage import StorageManager
from repro_torch.platform.watchdog import CHECKPOINTING, TRAINING, Watchdog
from repro_torch.weights import flat_layout, flat_size

log = logging.getLogger("repro_torch.learner")

# the kernel libraries an LM step launches on CUDA, by family: K4 and
# K4b (dense, moe and vlm), K5 and K5b (ssm), all four (hybrid)
_ATTN_LIBS = (_kfa.NAME, _kfab.NAME)
_SSD_LIBS = (_kssd.NAME, _kssdb.NAME)
STEP_LIBRARIES = {"dense": _ATTN_LIBS, "ssm": _SSD_LIBS,
                  "hybrid": _ATTN_LIBS + _SSD_LIBS}


def step_libraries(cfg: ArchConfig):
    """The kernel libraries ``cfg``'s learner step launches on CUDA."""
    return STEP_LIBRARIES.get(cfg.family, _ATTN_LIBS)

# ---------------------------------------------------------------------------
# Framework plugins
# ---------------------------------------------------------------------------

PLUGINS: Dict[str, Callable] = {}


def register_plugin(name: str):
    def deco(cls):
        PLUGINS[name] = cls
        return cls
    return deco


def _meta_twin(plugin):
    """The plugin on the meta device: a shallow copy sharing its model
    and layout, built once per plugin, so its step runs on meta tensors
    for ``count_program``."""
    twin = getattr(plugin, "_meta", None)
    if twin is None:
        twin = copy.copy(plugin)
        twin.device = torch.device("meta")
        plugin._meta = twin
    return twin


def _set_path(tree: Dict, path: str, value) -> None:
    *parents, last = path.split("/")
    for key in parents:
        tree = tree.setdefault(key, {})
    tree[last] = value


@register_plugin("repro-lm")
class LMPlugin:
    """Decoder LM from the model zoo. With no ``cfg`` it trains
    ``reduce_for_smoke(get_arch(arch))``, as the reference does, so a
    manifest means the same in both packages; ``cfg=`` runs any ported
    config (the card trains full width this way). Opts as the
    reference's plugin: ``xent_chunk`` 64, no remat."""

    XENT_CHUNK = 64

    def __init__(self, framework_cfg: Dict, *,
                 cfg: Optional[ArchConfig] = None,
                 device: DeviceLike = None):
        if cfg is None:
            cfg = reduce_for_smoke(get_arch(
                framework_cfg.get("arch", "stablelm-1.6b")))
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = make_model(cfg, opts={"remat": "none"})
        self.vocab = cfg.vocab_size
        self._layout = flat_layout(cfg)
        self.flat_size = flat_size(cfg)
        self._warming: Optional[threading.Event] = None

    def warm_async(self, batch_docs: int, data_cfg: Dict):
        """Build the step's kernel libraries (``step_libraries``, the
        first-use ``nvcc`` build of ``kernels/build.py``) on a background
        thread, so the build overlaps plan-time weight init and
        deployment instead of stalling the learner's first step, which
        waits on the build's lock if it is still running. ``_warming`` is
        set when the build ends; on the CPU, where the step launches no
        kernel, at once. The build does not depend on the batch, so
        ``batch_docs`` and ``data_cfg`` (the reference's compile shapes)
        are unused. A failed build is logged, as the reference logs a
        failed warm compile; the step's first launch then builds again
        and raises."""
        ev = threading.Event()
        self._warming = ev
        if self.device.type != "cuda":
            ev.set()
            return

        def run():
            try:
                for name in step_libraries(self.cfg):
                    build.load(name)
            except Exception as e:          # advisory: log, never crash
                log.warning("warm kernel build failed: %s: %s",
                            type(e).__name__, e)
            finally:
                ev.set()
        threading.Thread(target=run, daemon=True,
                         name="plugin-warm").start()

    def program_cost(self, batch_docs: int, data_cfg: Dict) -> Dict:
        """``count_program`` of one ``flat_loss_grad`` at ``batch_docs`` x
        the data's ``seq_len``, on the meta device: the forward,
        autograd's backward and the gradient's copies into the flat
        vector. The counterpart of the reference's ``lowered_hlo``; it
        touches no device memory and launches nothing."""
        seq_len = self.dataset_spec(data_cfg).seq_len
        tokens = np.zeros((batch_docs, seq_len), np.int64)
        flat = torch.empty(self.flat_size, dtype=torch.float32,
                           device="meta")
        return count_program(_meta_twin(self).flat_loss_grad, flat,
                             {"tokens": tokens, "labels": tokens})

    def flat_state(self, seed: int) -> torch.Tensor:
        """Initial weights as one flat f32 vector on the device, in
        ``weights.flat_layout`` order, drawn leaf by leaf from a
        ``torch.Generator`` seeded with ``seed`` (the values of
        ``model.init`` on that generator, rounded to the model dtype).
        Not cached: at full width each copy is gigabytes of device
        memory."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        defs = dict(iter_leaves(self.model.param_defs()))
        flat = torch.empty(self.flat_size, dtype=torch.float32,
                           device=self.device)
        for path, shape, off in self._layout:
            leaf = init_leaf(defs[path], gen, self.model.dtype)
            flat[off: off + leaf.numel()].copy_(leaf.reshape(-1))
        return flat

    def _param_leaves(self, flat: torch.Tensor):
        """(tree, leaves): the param tree as model-dtype copies of the flat
        slices, each requiring grad, and every leaf with its flat offset.
        Layer-stacked block weights become per-layer lists, so autograd
        hands back one gradient per layer with no (L, ...) scatter."""
        tree: Dict = {}
        leaves = []
        dt = self.model.dtype
        for path, shape, off in self._layout:
            n = int(np.prod(shape, dtype=np.int64))
            src = flat[off: off + n].view(shape)
            if path.startswith("blocks/"):
                per = n // shape[0]
                val = [src[l].detach().to(dt).requires_grad_()
                       for l in range(shape[0])]
                leaves += [(t, off + l * per) for l, t in enumerate(val)]
            else:
                val = src.detach().to(dt).requires_grad_()
                leaves.append((val, off))
            _set_path(tree, path, val)
        return tree, leaves

    def flat_loss_grad(self, flat, batch):
        """One step on the flat vector: (loss (0-dim f32 tensor), flat
        gradient on the device, in the same order). The flat slices are
        cast to the model dtype, ``Model.loss`` runs forward and
        backward, and each leaf's gradient is copied into its slice of a
        flat vector in the model dtype. Its values are those of the
        reference's f32 ``_flat_io`` ravel (widening is exact), and the
        int8 push reads it as f32 in K2, so a bf16 model keeps no f32
        copy of its gradient."""
        flat = as_flat(flat, self.device)
        tree, leaves = self._param_leaves(flat)
        b = {k: torch.as_tensor(np.asarray(batch[k]), dtype=torch.int64)
             .to(self.device) for k in ("tokens", "labels")}
        loss = self.model.loss(tree, b, xent_chunk=self.XENT_CHUNK)
        grads = torch.autograd.grad(loss, [t for t, _ in leaves])
        offsets = [off for _, off in leaves]
        del tree, leaves            # the model-dtype weights, before gflat
        gflat = torch.empty(self.flat_size, dtype=self.model.dtype,
                            device=self.device)
        for off, g in zip(offsets, grads):
            gflat[off: off + g.numel()].copy_(g.reshape(-1))
        return loss.detach(), gflat

    def dataset_spec(self, data_cfg: Dict) -> DatasetSpec:
        return DatasetSpec(n_docs=data_cfg.get("n_docs", 512),
                           seq_len=data_cfg.get("seq_len", 32),
                           vocab_size=self.vocab,
                           seed=data_cfg.get("seed", 0))


@register_plugin("repro-mlp")
class MLPPlugin:
    """Minimal classifier used by the colloquium-style hyperparameter
    sweep (CIFAR-like synthetic task): the reference's ``MLPPlugin``.
    Its flat vector has ``ravel_pytree``'s layout of the params, sorted
    keys ``b1, b2, w1, w2``, in f32 on ``device`` (the learner's)."""

    def __init__(self, framework_cfg: Dict, *, device: DeviceLike = None):
        self.d_in = framework_cfg.get("d_in", 32)
        self.d_hidden = framework_cfg.get("d_hidden", 64)
        self.n_classes = framework_cfg.get("n_classes", 10)
        self.vocab = self.n_classes
        self.device = resolve_device(device)
        self._shapes = (("b1", (self.d_hidden,)),
                        ("b2", (self.n_classes,)),
                        ("w1", (self.d_in, self.d_hidden)),
                        ("w2", (self.d_hidden, self.n_classes)))
        self.flat_size = sum(int(np.prod(s)) for _, s in self._shapes)

    def _unflat(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for name, shape in self._shapes:
            n = int(np.prod(shape))
            out[name] = flat[off: off + n].view(shape)
            off += n
        return out

    def flat_state(self, seed: int) -> torch.Tensor:
        """Initial weights as one flat f32 vector on the device: biases
        zero, ``w1`` then ``w2`` drawn N(0, 1) from a ``torch.Generator``
        seeded with ``seed`` and scaled by 1/sqrt of their fan-in."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        flat = torch.zeros(self.flat_size, dtype=torch.float32,
                           device=self.device)
        p = self._unflat(flat)
        for name, fan_in in (("w1", self.d_in), ("w2", self.d_hidden)):
            p[name].copy_(torch.randn(p[name].shape, generator=gen,
                                      device=self.device)
                          / np.sqrt(fan_in))
        return flat

    def _step(self, flat, batch):
        """(loss, flat f32 gradient, accuracy), each a tensor on the
        device: the step ``program_cost`` counts."""
        f = as_flat(flat, self.device).float().detach().requires_grad_()
        p = self._unflat(f)
        x, y = _synthetic_features(batch["tokens"], self.d_in,
                                   self.n_classes, self.device)
        h = torch.tanh(x @ p["w1"] + p["b1"])
        logits = h @ p["w2"] + p["b2"]
        nll = -torch.log_softmax(logits, -1)[
            torch.arange(len(y), device=self.device), y]
        loss = nll.mean()
        (g,) = torch.autograd.grad(loss, f)
        return loss.detach(), g, (logits.argmax(-1) == y).float().mean()

    def flat_loss_grad(self, flat, batch):
        """(mean NLL (0-dim f32 tensor), flat f32 gradient on the
        device); sets ``last_acc``, the batch's accuracy."""
        loss, g, acc = self._step(flat, batch)
        self.last_acc = float(acc)
        return loss, g

    def program_cost(self, batch_docs: int, data_cfg: Dict) -> Dict:
        """``count_program`` of one step at ``batch_docs`` documents, on
        the meta device (the reference's ``lowered_hlo``)."""
        tokens = np.zeros((batch_docs, 2), np.int64)
        flat = torch.empty(self.flat_size, dtype=torch.float32,
                           device="meta")
        return count_program(_meta_twin(self)._step, flat,
                             {"tokens": tokens})

    def dataset_spec(self, data_cfg: Dict) -> DatasetSpec:
        return DatasetSpec(n_docs=data_cfg.get("n_docs", 2048),
                           seq_len=2, vocab_size=1024,
                           seed=data_cfg.get("seed", 0))


def _synthetic_features(tokens: np.ndarray, d_in: int, n_classes: int,
                        device: torch.device):
    """Deterministic vision-like task: class = doc token hash; features =
    class prototype + noise (learnable, accuracy can approach 1.0). The
    reference's numpy draws, as (x f32, y int64) tensors on ``device``."""
    rng = np.random.Generator(np.random.Philox(key=1234))
    protos = rng.normal(size=(n_classes, d_in)).astype(np.float32)
    seed_tokens = np.asarray(tokens)[:, 0]
    y = (seed_tokens % n_classes).astype(np.int64)
    noise_rng = np.random.Generator(np.random.Philox(key=99))
    noise = noise_rng.normal(size=(len(y), d_in)).astype(np.float32)
    x = protos[y] + 0.5 * noise
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


# ---------------------------------------------------------------------------
# Learner body
# ---------------------------------------------------------------------------


@dataclass
class LearnerJobConfig:
    job_id: str
    framework: str = "repro-lm"
    framework_cfg: Dict = field(default_factory=dict)
    data_cfg: Dict = field(default_factory=dict)
    n_learners: int = 1
    batch_docs: int = 8
    steps: int = 50
    comm_every: int = 1
    lr: float = 0.1
    optimizer: str = "sgd"          # PS-side solver
    solver: str = "psgd"            # psgd | modelavg | easgd | downpour
    compression: str = "none"       # PS push wire format: none | int8
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 20
    # (StorageManager, store_id, prefix): mirror every published
    # checkpoint into the object store (backoff-wrapped uploads)
    ckpt_mirror: Optional[tuple] = None
    # test hooks
    fail_at_step: Dict[int, int] = field(default_factory=dict)
    user_error_at: Optional[int] = None


def make_learner_body(cfg: LearnerJobConfig, ps: SoftwareParameterServer,
                      cursor: GlobalCursor, storage: StorageManager,
                      metrics: MetricsService,
                      results: Optional[Dict] = None,
                      control=None, plugin=None, tracer=None):
    """Returns fn(watchdog, learner_idx) run under the watchdog.

    ``control`` (optional, duck-typed: ``wait_while_paused`` and
    ``take_checkpoint_request``) adds pause/resume and on-demand
    checkpoints at step boundaries; ``tracer`` (optional, duck-typed:
    ``start``/``end``/``span``) records sampled step spans. ``plugin``
    reuses an already-built framework plugin; without one the body
    builds ``PLUGINS[cfg.framework]``, which runs on CUDA (a CPU run
    passes a plugin built with ``device="cpu"``)."""
    plugin = plugin or PLUGINS[cfg.framework](cfg.framework_cfg)
    corpus = SyntheticCorpus(plugin.dataset_spec(cfg.data_cfg))

    def body(wd: Watchdog, idx: int):
        ps.join(idx)
        ckpt = None
        clients = []
        try:
            if cfg.checkpoint_dir and idx == 0:
                ckpt = CheckpointManager(cfg.checkpoint_dir, keep=3,
                                         mirror=cfg.ckpt_mirror)
            _train(wd, idx, ckpt, clients)
        finally:
            # a learner that crashes lets its outstanding checkpoint
            # write finish before its task fails: the restart resumes
            # from it
            if ckpt is not None:
                ckpt.wait()
            # its device buffers go now, not when its frames are
            # collected (a kept exception holds them)
            for client in clients:
                client.release()
            ps.leave(idx)

    def fence(idx: int):
        """Stop a learner of a crashed core before it writes."""
        if control is not None and getattr(control, "fenced", False):
            raise Preempted(f"learner-{idx}: its core crashed")

    def _train(wd: Watchdog, idx: int, ckpt, clients):
        start_step = 0
        # resume from checkpoint if one exists (any learner may restore
        # the global params by pulling after learner-0 pushed them)
        if cfg.checkpoint_dir:
            probe = CheckpointManager(cfg.checkpoint_dir, keep=3)
            # a learner restarted beside learner 0 waits for learner 0's
            # checkpoint still being written: learner 0 resumes from it
            if idx != 0 and not probe.wait_published(BSP_TIMEOUT_S):
                wd.log("a checkpoint write did not finish: resuming from "
                       "the newest published one")
            last = probe.latest_valid()
            if last is None and probe.steps():
                wd.log(f"no valid checkpoint among steps {probe.steps()}")
            if last is not None:
                extra = probe.extra(last)
                start_step = int(extra.get("step", last))
                # learner 0 republishes restored weights to the PS shards;
                # the others pull them and read only the step
                if idx == 0:
                    # the template only names the leaf (np.zeros touches
                    # no memory): the restored values are what count
                    tmpl = {"flat": np.zeros(plugin.flat_size, np.float32)}
                    tree, _ = probe.restore(last, tmpl)
                    ps.load_flat(tree["flat"])
                    del tree
                    cur_epoch = int(extra.get("epoch", 0))
                    cur_off = int(extra.get("offset", 0))
                    cursor.restore(cur_epoch, cur_off)
                wd.log(f"resumed from checkpoint step={start_step}")

        # on the PS's first start, no learner pulls before every learner
        # of the job has started (and learner 0 has republished a
        # checkpoint); after a restart the barrier is already open
        if not ps.start(idx):
            wd.log("start barrier timed out: training with the learners "
                   "that joined")
        # the learner's state is the flat f32 vector in its device pull
        # buffer, reused by every pull
        client = ps.make_client(idx)
        clients.append(client)
        flat = client.pull()

        def save_ckpt(step, flat):
            fence(idx)
            wd.set_status(CHECKPOINTING)
            with maybe_span(tracer, cfg.job_id, "checkpoint_publish",
                            step=step):
                epoch, offset = cursor.position()
                # the save snapshots `flat` to the host before it returns
                ckpt.save(step, {"flat": flat},
                          extra={"step": step, "epoch": epoch,
                                 "offset": offset})
            metrics.event(cfg.job_id, "checkpoint", step)
            wd.set_status(TRAINING)

        loss = None
        t_round = time.time()
        for step in range(start_step, cfg.steps):
            # step boundary: yield to the scheduler if preempted, honor
            # pause, serve on-demand checkpoint requests
            wd.maybe_preempt()
            if control is not None:
                control.wait_while_paused(should_abort=wd.maybe_preempt)
                if ckpt is not None and control.take_checkpoint_request():
                    save_ckpt(step, flat)
            if cfg.fail_at_step.get(idx) == step:
                cfg.fail_at_step.pop(idx)     # transient: fires once
                wd.log(f"injected crash at step {step}")
                wd.crash()
                raise RuntimeError("simulated container crash")
            if cfg.user_error_at is not None and step == cfg.user_error_at:
                raise UserError("bad hyperparameter in user model")
            chunks = cursor.next_chunk(cfg.batch_docs)
            batch = corpus.batch_for(chunks)
            step_sp = (tracer.start(cfg.job_id, "step", step=step,
                                    learner=idx)
                       if tracer is not None and idx == 0
                       and step % TRACE_STEP_SAMPLE == 0 else None)
            loss, gflat = plugin.flat_loss_grad(flat, batch)
            if cfg.solver == "psgd":
                t0 = time.time()
                client.push(gflat)
                del gflat               # free before the next step
                flat = client.pull()
                sync_s = time.time() - t0
            else:
                # local step; periodic weight sync (modelavg), in f32
                flat = flat - cfg.lr * gflat.float()
                del gflat
                sync_s = 0.0
                if (step + 1) % cfg.comm_every == 0:
                    t0 = time.time()
                    client.push(flat)
                    flat = client.pull()
                    sync_s = time.time() - t0
            loss_f = float(loss)
            if step_sp is not None:
                tracer.end(step_sp, loss=loss_f)
            wd.heartbeat(step, loss=loss_f)
            wd.log(f"step={step} loss={loss_f:.4f}"
                   + (f" acc={plugin.last_acc:.4f}"
                      if hasattr(plugin, "last_acc") else ""))
            metrics.record(cfg.job_id, "loss", step, loss_f)
            if hasattr(plugin, "last_acc"):
                metrics.record(cfg.job_id, "accuracy", step,
                               plugin.last_acc)
            metrics.record(cfg.job_id, "lr", step, cfg.lr)
            metrics.record(cfg.job_id, "sync_time_s", step, sync_s)
            metrics.record(cfg.job_id, "round_time_s", step,
                           time.time() - t_round)
            t_round = time.time()
            if ckpt is not None and (step + 1) % cfg.checkpoint_every == 0:
                save_ckpt(step + 1, flat)
        # store.sh: upload the trained model
        if idx == 0:
            fence(idx)
            host = flat.detach().cpu().numpy()
            buf = io.BytesIO()
            np.save(buf, host)
            storage.upload("results", cfg.job_id, "trained_model.npy",
                           buf.getbuffer())
            del buf
            if results is not None:
                results["final_loss"] = (float(loss) if loss is not None
                                         else None)
                results["params"] = host

    return body
