"""One rank of the mesh cases of tests/test_torch_solvers.py.

    python tests/util_ps_worker.py RANK WORLD WORKDIR

Joins a gloo process group through a ``FileStore`` in ``WORKDIR`` (no
port), builds a (WORLD, 1) ("data", "model") mesh on the CPU, loads the
arrays the test wrote to ``WORKDIR/inputs.npz`` and runs every case of
``WORKDIR/cases.json`` with the port only (no JAX here):

  * ``prim``: one PS primitive (``pull``, ``push_mean``,
    ``push_update_pull``, ``downpour_round``) on this rank's row of the
    global (L, F) stack and its shard of the center; the outputs as this
    rank holds them;
  * ``solver``: ``make_solver`` on the mesh, ``rounds`` rounds of the
    global batches; the center (``params_of``, gathered) and the metrics
    after each; round 1 under ``analysis.roofline.ProgramCounter`` (the
    collective bytes by kind).

Writes ``WORKDIR/out-RANK.npz`` and ``WORKDIR/out-RANK.json``.
"""
import json
import logging
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as tdist

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(SRC))

from repro_torch.analysis.roofline import ProgramCounter  # noqa: E402
from repro_torch.core import ps  # noqa: E402
from repro_torch.core.solvers import SolverConfig, make_solver  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.optim.optimizers import OptConfig, flat_init  # noqa: E402


def loss_fn(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def run_prim(case, inputs, ctx, arrays):
    r, nl = ctx.rank, ctx.n_learners
    stack = torch.from_numpy(inputs["stack"].copy())
    center = torch.from_numpy(inputs["center"].copy())
    c = center.numel() // nl
    mine = stack[r:r + 1].clone()
    shard = center[r * c:(r + 1) * c].clone()
    cid, op = case["id"], case["op"]
    if op == "pull":
        arrays[f"{cid}/out"] = ps.pull(shard, ctx).numpy()
        return
    if op == "push_mean":
        arrays[f"{cid}/out"] = ps.push_mean(mine, case["mode"],
                                            ctx).numpy()
        return
    cfg = OptConfig(**case["opt"])
    st = flat_init(cfg, c)
    for k in ("m", "v"):
        if k in st:
            st[k].copy_(torch.from_numpy(
                inputs[k][r * c:(r + 1) * c].copy()))
    st["step"] = torch.tensor(case["step0"], dtype=torch.int32)
    upd = ps.ServerUpdate(cfg)
    if op == "push_update_pull":
        new_c, new_st, full = ps.push_update_pull(mine, shard, st, upd,
                                                  case["mode"], ctx)
        arrays[f"{cid}/full"] = full.numpy()
    else:
        new_c, new_st, pre, stale = ps.downpour_round(mine, shard, st, upd,
                                                      ctx)
        arrays[f"{cid}/prefix"] = pre.numpy()
        arrays[f"{cid}/staleness"] = stale.numpy()
    arrays[f"{cid}/center"] = new_c.numpy()
    for k in ("m", "v"):
        if k in new_st:
            arrays[f"{cid}/{k}"] = new_st[k].numpy()
    arrays[f"{cid}/step"] = np.asarray(int(new_st["step"]))


def run_solver(case, inputs, mesh, out, arrays):
    scfg = SolverConfig(**case["scfg"])
    d = int(inputs["w_true"].shape[0])
    s = make_solver(loss_fn, {"w": torch.zeros(d)},
                    OptConfig(**case["opt"]), scfg, case["nl"], mesh=mesh)
    st = s.init_state({"w": torch.zeros(d)})
    metrics = []
    for i in range(case["rounds"]):
        x = torch.from_numpy(inputs[f"{case['data']}/x{i}"].copy())
        y = torch.from_numpy(inputs[f"{case['data']}/y{i}"].copy())
        if i == 0:
            with ProgramCounter() as pc:
                st, m = s.round(st, {"x": x, "y": y})
            out["counted"] = pc.totals()["collective_bytes_by_kind"]
        else:
            st, m = s.round(st, {"x": x, "y": y})
        metrics.append({k: float(v) for k, v in m.items()})
        arrays[f"{case['id']}/w{i}"] = s.params_of(st)["w"].numpy()
    out["metrics"] = metrics
    out["wire"] = s.wire_bytes_per_round()
    out["padded"] = s.padded
    out["center_len"] = int(st["center"].numel())
    out["round"] = int(st["round"])


def main():
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    torch.manual_seed(0)
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(str(Path(workdir) / "store"), world),
        rank=rank, world_size=world)
    mesh = make_mesh(world, 1, device="cpu")
    ctx = ps.PSContext(mesh=mesh, n_learners=world)
    inputs = np.load(Path(workdir) / "inputs.npz")
    cases = json.loads((Path(workdir) / "cases.json").read_text())
    results, arrays = {}, {}
    for case in cases:
        out = results[case["id"]] = {}
        if case["kind"] == "prim":
            run_prim(case, inputs, ctx, arrays)
        else:
            run_solver(case, inputs, mesh, out, arrays)
    np.savez(Path(workdir) / f"out-{rank}.npz", **arrays)
    (Path(workdir) / f"out-{rank}.json").write_text(json.dumps(results))
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()
