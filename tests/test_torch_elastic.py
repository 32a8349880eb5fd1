"""The reference's ``tests/test_multidevice.py::test_elastic_trainer_reshard``
in the port, on 8 gloo ranks on the CPU (``util_spmd_worker.py``,
rendezvous through a ``FileStore`` under ``tmp_path``: no port; one
OpenMP thread a rank): a ``Trainer`` on ``make_mesh(data=4, model=2)``
for 20 steps, ``resume`` onto ``make_mesh(data=2, model=2)`` (over ranks
0-3: ranks 4-7 leave the run), on to step 40, AdamW lr 3e-3, batch 8 x
32, a checkpoint every 10 steps; then a fresh 2 x 2 ``Trainer`` restores
step 40.

The run starts from the reference's ``Trainer(...).init(0)`` params,
carried in through ``weights.params_from_jax`` as
tests/test_torch_trainer.py does. Rank 0 writes the run's params and
optimizer state before every step (and after the last) as checkpoints.
Every step's loss is within ``FWD_TOL``, and the params it leaves within
``MODEL_TOL``, of one step of a mesh-less port ``Trainer`` restored from
the state the run had before it; steps 0-9 also of one step of the
reference's mesh-less ``Trainer`` (tests/test_torch_trainer.py's
tolerances; the checkpoint layout is the reference's). One step from a
shared state, not an uninterrupted run: at AdamW lr 3e-3 this run
amplifies a rounding difference about tenfold a step, so two mesh-less
runs from the same weights, the reference's and the port's, already
differ by 4e-4 at step 4 and by 4e-2 at step 15 (PERF.md §6). The
reference's own asserts hold; ranks 4-7 hold no params after the resume,
``train`` returns nothing there and ``step_once`` raises, and they exit
while ranks 0-3 train on."""
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs.base import reduce_for_smoke as jax_reduce
from repro.configs.registry import get_arch as jax_get_arch
from repro.distributed.sharding import Dist as JaxDist
from repro.optim.optimizers import OptConfig as JaxOpt
from repro.runtime.trainer import Trainer as JaxTrainer
from repro.runtime.trainer import TrainerConfig as JaxTC
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.distributed.sharding import Dist
from repro_torch.models.layers import iter_leaves
from repro_torch.optim.optimizers import OptConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from util_gloo import spawn_ranks

FWD_TOL = dict(atol=2e-5, rtol=2e-5)     # tests/test_torch_trainer.py
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
WORLD = 8
ARCH = "stablelm-1.6b"
CASE = dict(kind="elastic", arch=ARCH, opt=dict(name="adamw", lr=3e-3),
            batch=8, seq=32, ckpt_every=10, first=[4, 2], then=[2, 2],
            steps1=20, steps2=40, timeout_s=120)
JAX_STEPS = 10
WORKER = Path(__file__).resolve().parent / "util_spmd_worker.py"


def _tc(ckpt):
    return dict(batch=CASE["batch"], seq=CASE["seq"], ckpt_every=1000,
                ckpt_dir=str(ckpt))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's mesh-less ``init(0)`` params (numpy)."""
    jtr = JaxTrainer(jax_reduce(jax_get_arch(ARCH)), JaxDist(),
                     JaxOpt(**CASE["opt"]),
                     JaxTC(**_tc(tmp_path_factory.mktemp("jax")))).init(0)
    return jax.tree.map(np.asarray, jtr.params)


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """Every rank's results, by rank, and the work directory."""
    work = tmp_path_factory.mktemp("elastic")
    flat = {"p/" + "/".join(str(k.key) for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(reference)[0]}
    np.savez(work / "inputs.npz", **flat)
    (work / "case.json").write_text(json.dumps(CASE))
    spawn_ranks(WORKER, work, WORLD, timeout=900)
    return [json.loads((work / f"out-{r}.json").read_text())
            for r in range(WORLD)], work


def _leaves(tree):
    return {k: np.asarray(v, np.float32) for k, v in iter_leaves(tree)}


def _held(name, got, want, tol):
    assert got.keys() == want.keys(), name
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol,
                                   err_msg=f"{name}: {k}")


def test_every_step_matches_a_meshless_step_from_its_state(ranks):
    outs, work = ranks
    losses = outs[0]["l1"] + outs[0]["l2"]
    assert len(losses) == CASE["steps2"]
    states = CheckpointManager(str(work / "states"))
    assert states.steps() == list(range(CASE["steps2"] + 1))
    tr = Trainer(reduce_for_smoke(get_arch(ARCH)), Dist(),
                 OptConfig(**CASE["opt"]),
                 TrainerConfig(**_tc(work / "states")), device="cpu")
    for s in range(CASE["steps2"]):
        tr.restore(s)
        loss = tr.step_once(tr._batch(s))
        np.testing.assert_allclose(losses[s], loss, **FWD_TOL,
                                   err_msg=f"step {s}")
        after = states.restore(s + 1, {"params": tr.params})[0]["params"]
        _held(f"step {s}", _leaves(after),
              {k: v.detach().numpy() for k, v in iter_leaves(tr.params)},
              MODEL_TOL)


def test_first_steps_match_the_jax_trainer(ranks):
    outs, work = ranks
    jtr = JaxTrainer(jax_reduce(jax_get_arch(ARCH)), JaxDist(),
                     JaxOpt(**CASE["opt"]), JaxTC(**_tc(work / "states")))
    for s in range(JAX_STEPS):
        jtr.restore(s)
        loss = float(jtr.step_once(jtr._batch(s)))
        np.testing.assert_allclose(outs[0]["l1"][s], loss, **FWD_TOL,
                                   err_msg=f"step {s}")
        want = {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
                for path, v in jax.tree_util.tree_flatten_with_path(
                    jtr.params)[0]}
        got = CheckpointManager(str(work / "states")).restore(
            s + 1, {"params": jtr.params})[0]["params"]
        _held(f"step {s}", {k: np.asarray(v, np.float32) for k, v in
                            iter_leaves(got)}, want, MODEL_TOL)


def test_every_rank_saw_the_same_losses(ranks):
    outs, _ = ranks
    for r in range(1, WORLD):
        assert outs[r]["l1"] == outs[0]["l1"], r
    for r in range(1, 4):
        assert outs[r]["l2"] == outs[0]["l2"], r


def test_the_reference_asserts_hold(ranks):
    l1, l2 = ranks[0][0]["l1"], ranks[0][0]["l2"]
    assert len(l2) == CASE["steps2"] - CASE["steps1"]
    assert l2[0] < l1[0] + 0.1 and l2[-1] < l2[0], (l1[0], l2[0], l2[-1])


def test_a_fresh_2x2_trainer_restores_step_40(ranks):
    ranks = ranks[0]
    assert [ranks[r]["restored_step"] for r in range(4)] == \
        [CASE["steps2"]] * 4
    assert all(ranks[r]["member"] for r in range(4))


def test_ranks_off_the_new_mesh_leave_the_run(ranks):
    ranks = ranks[0]
    for r in range(4, WORLD):
        out = ranks[r]
        assert out["member"] is False and out["holds"] is False, r
        assert out["l2"] == [], r
        assert "not on the trainer's mesh" in out["step_once"], r
        assert "restored_step" not in out
