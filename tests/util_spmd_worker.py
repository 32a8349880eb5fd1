"""One rank of tests/test_torch_elastic.py and tests/test_torch_step_retry.py.

    python tests/util_spmd_worker.py RANK WORLD WORKDIR

Waits on a ``FileStore`` in ``WORKDIR`` until every rank has started
(no port; slow starts under load cost no collective its timeout), then
joins a gloo process group whose timeout is the case's ``timeout_s``
(the bound of every wait on the mesh: ``launch.mesh.make_mesh`` gives it
to the mesh's groups), and runs the case of ``WORKDIR/case.json`` with
the port only (no JAX here):

  * ``elastic``: the reference's ``test_elastic_trainer_reshard``
    (tests/test_multidevice.py): a ``Trainer`` on ``first`` for
    ``steps1`` steps, ``resume`` onto ``then`` (over the first ranks:
    the others leave), on to ``steps2``; a fresh ``Trainer`` on
    ``then`` restores the newest checkpoint. The initial params are
    ``WORKDIR/inputs.npz``'s ``p/*`` (the reference's, through
    ``weights.params_from_jax``). Before each step, and after the last,
    the run's params and optimizer state go to ``WORKDIR/states`` as a
    checkpoint of that step (the test takes one mesh-less step from
    each);
  * ``retry``: on ``mesh``, from the port's seed-0 weights: a fault that
    every rank raises at step ``fault_at`` after writing into its first
    param shard, retried after a restore of the step-``fault_at``
    checkpoint, then on to ``steps``; a fault that every rank raises
    with no checkpoint; last, a fault that only rank ``lone`` raises,
    timed on every rank.

Writes ``WORKDIR/out-RANK.json``.
"""
import datetime
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as tdist

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(SRC))

from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import reduce_for_smoke  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.distributed.sharding import Dist  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.optim.optimizers import OptConfig  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402


def _tree(inputs, prefix="p/"):
    out = {}
    for k in inputs.files:
        if k.startswith(prefix):
            node = out
            *parents, last = k[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = inputs[k]
    return out


def _trainer(case, mesh, ckpt):
    return Trainer(reduce_for_smoke(get_arch(case["arch"])),
                   Dist(mesh=mesh), OptConfig(**case["opt"]),
                   TrainerConfig(batch=case["batch"], seq=case["seq"],
                                 ckpt_every=case["ckpt_every"],
                                 ckpt_dir=str(ckpt)))


def run_elastic(case, rank, work, out):
    tree = _tree(np.load(work / "inputs.npz"))
    port_model.Model.init = lambda self, gen: params_from_jax(tree,
                                                              gen.device)
    first = make_mesh(*case["first"], device="cpu")
    tr = _trainer(case, first, work / "ckpt").init(0)
    states = CheckpointManager(str(work / "states"), keep=0,
                               async_save=False)
    real_step = tr.step_once

    def record():
        states.save(tr.step, {"params": tr.params, "opt": tr.opt_state})
    tr.step_once = lambda batch: (record(), real_step(batch))[1]
    out["l1"] = tr.train(case["steps1"])
    then = make_mesh(*case["then"], device="cpu")
    tr.resume(Dist(mesh=then))
    out["member"] = tr.member
    out["holds"] = tr.params is not None or tr.opt_state is not None
    out["l2"] = tr.train(case["steps2"])
    if not tr.member:
        try:
            real_step(tr._batch(tr.step))
            out["step_once"] = "returned"
        except RuntimeError as e:
            out["step_once"] = str(e)
        return
    record()
    tr2 = _trainer(case, then, work / "ckpt").init(1)
    tr2._restore_latest()
    out["restored_step"] = tr2.step


def _faulty(tr, fn):
    """``tr._step_fn`` that calls ``fn(params)`` (which may raise) on its
    first call, then is the real step."""
    real, calls = tr._step_fn, []

    def step(params, state, batch):
        calls.append(1)
        if len(calls) == 1:
            fn(params)
        return real(params, state, batch)
    tr._step_fn = step
    return calls


def run_retry(case, rank, work, out):
    mesh = make_mesh(*case["mesh"], device="cpu")
    tr = _trainer(case, mesh, work / "ckpt-a").init(0)
    k = case["fault_at"]
    losses = [tr.step_once(tr._batch(s)) for s in range(k)]
    tr.save()
    restored = []
    real_restore = tr.restore
    tr.restore = lambda step: restored.append(step) or real_restore(step)

    def half_written(params):
        leaf = next(iter(params.values()))
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        leaf.to_local().add_(1.0)
        raise RuntimeError("transient executor failure")
    calls = _faulty(tr, half_written)
    losses += [tr.step_once(tr._batch(s)) for s in range(k, case["steps"])]
    tr.restore = real_restore
    out["all_fault"] = {"losses": losses, "restored": restored,
                        "calls": len(calls), "step": tr.step}

    bare = _trainer(case, mesh, work / "ckpt-b").init(0)
    bare.step_once(bare._batch(0))

    def down(params):
        raise RuntimeError("down on every rank")
    _faulty(bare, down)
    try:
        bare.step_once(bare._batch(1))
        out["no_checkpoint"] = {"error": None}
    except RuntimeError as e:
        out["no_checkpoint"] = {"error": str(e), "step": bare.step}

    def lone(params):
        if rank == case["lone"]:
            raise RuntimeError("a fault on one rank")
    _faulty(tr, lone)
    t0 = time.monotonic()
    try:
        tr.step_once(tr._batch(tr.step))
        out["lone"] = {"error": None}
    except Exception as e:
        out["lone"] = {"error": f"{type(e).__name__}: {e}"[:300]}
    out["lone"]["seconds"] = time.monotonic() - t0


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    case = json.loads((work / "case.json").read_text())
    store = tdist.FileStore(str(work / "store"), world)
    store.set_timeout(datetime.timedelta(seconds=600))
    store.set(f"up/{rank}", "1")
    store.wait([f"up/{r}" for r in range(world)])
    tdist.init_process_group(
        "gloo", store=tdist.PrefixStore("pg", store), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=case["timeout_s"]))
    torch.manual_seed(0)
    out = {}
    {"elastic": run_elastic, "retry": run_retry}[case["kind"]](
        case, rank, work, out)
    (work / f"out-{rank}.json").write_text(json.dumps(out))
    if case["kind"] != "retry":
        tdist.destroy_process_group()


if __name__ == "__main__":
    main()
