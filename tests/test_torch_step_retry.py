"""A failed step's retry across the ranks of a mesh: 4 gloo ranks on the
CPU (``util_spmd_worker.py``, a ``FileStore`` under ``tmp_path``; one
OpenMP thread a rank), ``make_mesh(data=2, model=2)``, stablelm at smoke
size, AdamW, batch 4 x 32, the process group's timeout ``TIMEOUT_S``
(the bound of each wait on the mesh).

  * a fault that every rank raises at step 3, after writing into its
    first param shard (an update cut off midway): every rank restores
    the step-3 checkpoint and retries, and the losses of steps 0-5 are
    those of an unbroken mesh-less port run within ``FWD_TOL``;
  * the same fault with no checkpoint is raised on every rank;
  * a fault that only rank 1 raises, before the others finish the
    step's collectives: every rank's ``step_once`` raises, within twice
    the timeout (one wait in the step, one in the ranks' agreement), as
    ``runtime/trainer.py`` states; the test times it on every rank."""
import json
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs.base import reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.distributed.sharding import Dist
from repro_torch.optim.optimizers import OptConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from util_gloo import spawn_ranks

FWD_TOL = dict(atol=2e-5, rtol=2e-5)     # tests/test_torch_trainer.py
WORLD = 4
TIMEOUT_S = 20
# time past the bound that the test allows for the restore, the rank's
# own error path and the loaded host
SLACK_S = 10
CASE = dict(kind="retry", arch="stablelm-1.6b",
            opt=dict(name="adamw", lr=1e-3), batch=4, seq=32,
            ckpt_every=1000, mesh=[2, 2], fault_at=3, steps=6, lone=1,
            timeout_s=TIMEOUT_S)
WORKER = Path(__file__).resolve().parent / "util_spmd_worker.py"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("retry")
    (work / "case.json").write_text(json.dumps(CASE))
    spawn_ranks(WORKER, work, WORLD, timeout=600)
    return [json.loads((work / f"out-{r}.json").read_text())
            for r in range(WORLD)]


def test_a_fault_on_every_rank_is_retried_after_a_restore(ranks, tmp_path):
    tr = Trainer(reduce_for_smoke(get_arch(CASE["arch"])), Dist(),
                 OptConfig(**CASE["opt"]),
                 TrainerConfig(batch=CASE["batch"], seq=CASE["seq"],
                               ckpt_dir=str(tmp_path)),
                 device="cpu").init(0)
    want = [tr.step_once(tr._batch(s)) for s in range(CASE["steps"])]
    for r, out in enumerate(ranks):
        got = out["all_fault"]
        assert got["restored"] == [CASE["fault_at"]], r
        assert got["calls"] == CASE["steps"] - CASE["fault_at"] + 1, r
        assert got["step"] == CASE["steps"], r
        np.testing.assert_allclose(got["losses"], want, **FWD_TOL,
                                   err_msg=f"rank {r}")


def test_without_a_checkpoint_every_rank_raises(ranks):
    for r, out in enumerate(ranks):
        assert out["no_checkpoint"] == {"error": "down on every rank",
                                        "step": 1}, r


def test_a_fault_on_one_rank_ends_every_rank_within_the_bound(ranks):
    for r, out in enumerate(ranks):
        lone = out["lone"]
        assert lone["error"] is not None, r
        assert lone["seconds"] <= 2 * TIMEOUT_S + SLACK_S, (r, lone)
    assert "a fault on one rank" in ranks[CASE["lone"]]["lone"]["error"]
