"""The port's ``runtime/trainer.py`` against the JAX package's, without a
mesh, on the CPU at smoke size.

Both trainers start from one param tree: the reference's
``model.init(PRNGKey(0))``, carried into the port through
``weights.params_from_jax`` (torch cannot reproduce ``jax.random``, so
the test patches the port's ``Model.init``). Over ``STEPS`` steps of
stablelm and mamba2 with sgd, adamw and adafactor, the ``_batch`` tokens
are equal, the losses are within ``FWD_TOL`` and the final params within
``MODEL_TOL`` (tests/test_torch_steps.py's tolerances). Adafactor runs
with ``min_dim_factored`` 32 in both packages, so the smoke model's
matrices take the factored statistics. Then, on the port alone: a save
at step 3 restored into a fresh ``Trainer`` goes on as an uninterrupted
run, ``step_once`` retries after one injected failure (restoring the
latest checkpoint), also one inside the update that left the params half
written, and raises such a failure when there is no checkpoint to
restore; a bfloat16 model round-trips its checkpoint, which the JAX
package refuses to read; and a stub-frontend arch cannot synthesise a
batch."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import reduce_for_smoke as jax_reduce
from repro.checkpoint.checkpoint import CheckpointManager as JaxCkpt
from repro.configs.registry import get_arch as jax_get_arch
from repro.distributed.sharding import Dist as JaxDist
from repro.optim.optimizers import OptConfig as JaxOpt
from repro.runtime.trainer import Trainer as JaxTrainer
from repro.runtime.trainer import TrainerConfig as JaxTC
from repro_torch.configs.base import reduce_for_smoke
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import steps as port_steps
from repro_torch.distributed.sharding import Dist
from repro_torch.models import model as port_model
from repro_torch.models.layers import iter_leaves
from repro_torch.optim.optimizers import OptConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.weights import params_from_jax

FWD_TOL = dict(atol=2e-5, rtol=2e-5)     # tests/test_torch_steps.py
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
STEPS = 6
BATCH, SEQ = 2, 64
OPTS = {"sgd": dict(name="sgd", lr=2e-3),
        "adamw": dict(name="adamw", lr=1e-3),
        "adafactor": dict(name="adafactor", lr=1e-3, min_dim_factored=32)}


def _tc(tmp_path, **kw):
    return dict(batch=BATCH, seq=SEQ, ckpt_every=1000,
                ckpt_dir=str(tmp_path), **kw)


def _jax_trainer(arch, opt, tmp_path):
    return JaxTrainer(jax_reduce(jax_get_arch(arch)), JaxDist(),
                      JaxOpt(**OPTS[opt]),
                      JaxTC(**_tc(tmp_path / "jax"))).init(0)


def _use_tree(monkeypatch, jax_params):
    """The port's ``Model.init`` returns the reference's tree."""
    host = jax.tree.map(np.asarray, jax_params)
    monkeypatch.setattr(port_model.Model, "init",
                        lambda self, gen: params_from_jax(host, gen.device))


def _port_trainer(arch, opt, tmp_path, **tc):
    return Trainer(reduce_for_smoke(get_arch(arch)), Dist(),
                   OptConfig(**OPTS[opt]),
                   TrainerConfig(**_tc(tmp_path / "port", **tc)),
                   device="cpu").init(0)


def _leaves(params):
    return {k: v.detach().float().numpy() for k, v in iter_leaves(params)}


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mamba2-1.3b"])
def test_trainer_matches_jax(tmp_path, monkeypatch, arch, opt):
    jtr = _jax_trainer(arch, opt, tmp_path)
    _use_tree(monkeypatch, jtr.params)
    ptr = _port_trainer(arch, opt, tmp_path)
    for step in range(STEPS):
        jb, pb = jtr._batch(step), ptr._batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]))
        jl, pl = jtr.step_once(jb), ptr.step_once(pb)
        np.testing.assert_allclose(pl, jl, **FWD_TOL, err_msg=str(step))
    assert ptr.step == jtr.step == STEPS
    want = {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jtr.params)[0]}
    got = _leaves(ptr.params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **MODEL_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_save_restore_continues_the_run(tmp_path, opt):
    arch = "stablelm-1.6b"
    whole = _port_trainer(arch, opt, tmp_path / "whole")
    want = [whole.step_once(whole._batch(s)) for s in range(STEPS)]
    a = _port_trainer(arch, opt, tmp_path / "split")
    for s in range(3):
        a.step_once(a._batch(s))
    a.save()
    a.ckpt.wait()
    b = Trainer(a.cfg, Dist(), a.opt, a.tc, device="cpu").init(7)
    b._restore_latest()
    assert b.step == 3
    got = [b.step_once(b._batch(s)) for s in range(3, STEPS)]
    np.testing.assert_allclose(got, want[3:], rtol=0, atol=0)
    for (k, x), (_, y) in zip(iter_leaves(b.params),
                              iter_leaves(whole.params)):
        assert torch.equal(x, y), k


def test_step_once_retries_after_a_failure(tmp_path):
    tr = _port_trainer("stablelm-1.6b", "adamw", tmp_path)
    tr.step_once(tr._batch(0))
    tr.save()
    calls = {"n": 0}
    real = tr._step_fn

    def flaky(params, state, batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient executor failure")
        return real(params, state, batch)
    tr._step_fn = flaky
    restored = []
    orig = tr.restore
    tr.restore = lambda step: restored.append(step) or orig(step)
    loss = tr.step_once(tr._batch(1))
    assert np.isfinite(loss) and calls["n"] == 2 and restored == [1]
    assert tr.step == 2
    tr._step_fn = lambda *a: (_ for _ in ()).throw(RuntimeError("down"))
    with pytest.raises(RuntimeError, match="down"):
        tr.step_once(tr._batch(2))


def _fail_inside_the_update(monkeypatch, times):
    """``apply_updates`` that, its first ``times`` calls, writes the first
    param leaf in place and then fails (an update cut off midway)."""
    real = port_steps.apply_updates
    calls = {"n": 0}

    def cut(opt, params, grads, state, **kw):
        calls["n"] += 1
        if calls["n"] <= times:
            next(iter(iter_leaves(params)))[1].add_(1.0)
            raise RuntimeError("out of memory in the update")
        return real(opt, params, grads, state, **kw)
    monkeypatch.setattr(port_steps, "apply_updates", cut)
    return calls


def test_step_once_retries_a_failure_inside_the_update(tmp_path,
                                                       monkeypatch):
    """The retry restores the checkpoint, so the half-written params do
    not reach the next step: the run equals an uninterrupted one."""
    whole = _port_trainer("stablelm-1.6b", "adamw", tmp_path / "whole")
    want = [whole.step_once(whole._batch(s)) for s in range(3)]
    tr = _port_trainer("stablelm-1.6b", "adamw", tmp_path / "cut")
    got = [tr.step_once(tr._batch(0))]
    tr.save()
    calls = _fail_inside_the_update(monkeypatch, 1)
    got += [tr.step_once(tr._batch(s)) for s in (1, 2)]
    assert calls["n"] == 3 and tr.step == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=0)
    for (k, x), (_, y) in zip(iter_leaves(tr.params),
                              iter_leaves(whole.params)):
        assert torch.equal(x, y), k


def test_a_failed_step_without_a_checkpoint_is_raised(tmp_path,
                                                      monkeypatch):
    """With nothing to restore, the half-written params cannot be
    trusted: the failure is raised, not retried."""
    tr = _port_trainer("stablelm-1.6b", "adamw", tmp_path)
    tr.step_once(tr._batch(0))
    calls = _fail_inside_the_update(monkeypatch, 1)
    with pytest.raises(RuntimeError, match="out of memory"):
        tr.step_once(tr._batch(1))
    assert calls["n"] == 1 and tr.step == 1


def test_train_checkpoints_every_ckpt_every(tmp_path):
    tr = Trainer(reduce_for_smoke(get_arch("stablelm-1.6b")), Dist(),
                 OptConfig(name="sgd", lr=2e-3),
                 TrainerConfig(batch=2, seq=32, ckpt_every=2,
                               ckpt_dir=str(tmp_path)),
                 device="cpu").init(0)
    losses = tr.train(5)
    assert len(losses) == 5 and tr.ckpt.steps() == [2, 4]


def test_bf16_checkpoint_round_trips(tmp_path):
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("stablelm-1.6b")),
                              dtype="bfloat16")
    tc = TrainerConfig(batch=2, seq=32, ckpt_dir=str(tmp_path))
    a = Trainer(cfg, Dist(), OptConfig(name="adamw"), tc,
                device="cpu").init(0)
    a.step_once(a._batch(0))
    a.save()
    a.ckpt.wait()
    b = Trainer(cfg, Dist(), OptConfig(name="adamw"), tc,
                device="cpu").init(1)
    b._restore_latest()
    assert b.step == 1
    for (k, x), (_, y) in zip(iter_leaves({"p": a.params, "o": a.opt_state}),
                              iter_leaves({"p": b.params,
                                           "o": b.opt_state})):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def test_bf16_checkpoint_is_refused_by_the_jax_package(tmp_path):
    """A bfloat16 leaf is stored as its bits in a structured array, which
    the reference's restore refuses instead of reading integers; float32
    leaves of the same checkpoint restore there as they are."""
    w = torch.randn(3, 4).to(torch.bfloat16)
    b = torch.randn(4)
    CheckpointManager(str(tmp_path)).save(1, {"w": w, "b": b}, block=True)
    ref = JaxCkpt(str(tmp_path))
    assert ref.latest_valid() == 1
    with pytest.raises(TypeError, match="bfloat16"):
        ref.restore(1, {"w": np.zeros((3, 4), np.float32),
                        "b": np.zeros(4, np.float32)})
    tree, _ = ref.restore(1, {"b": np.zeros(4, np.float32)})
    np.testing.assert_array_equal(np.asarray(tree["b"]), b.numpy())
    tree, _ = CheckpointManager(str(tmp_path)).restore(1, {"w": 0, "b": 0})
    np.testing.assert_array_equal(tree["w"], w.float().numpy())


def test_stub_frontend_cannot_synthesise_a_batch(tmp_path):
    tr = Trainer(reduce_for_smoke(get_arch("whisper-large-v3")), Dist(),
                 OptConfig(), TrainerConfig(batch=2, seq=32,
                                            ckpt_dir=str(tmp_path)),
                 device="cpu")
    with pytest.raises(NotImplementedError, match="stub-frontend"):
        tr._batch(0)


def test_trainer_wants_cuda_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(reduce_for_smoke(get_arch("stablelm-1.6b")), Dist(),
                OptConfig(), TrainerConfig(ckpt_dir=str(tmp_path)))
