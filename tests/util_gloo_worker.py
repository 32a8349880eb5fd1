"""One rank of the sharded-step cases of tests/test_torch_dist_steps.py.

    python tests/util_gloo_worker.py RANK WORLD WORKDIR

Joins a gloo process group through a ``FileStore`` in ``WORKDIR`` (no
port), loads the initial params and the global batch that the test wrote
to ``WORKDIR/inputs.npz``, and runs every case of ``WORKDIR/cases.json``
on the CPU with the port only (no JAX here):

  * ``step``: ``jit_train_step`` on a mesh for a policy and an
    optimizer, ``STEPS`` steps; rank 0 records the losses and every leaf
    gathered after step 1 and the last step; every rank checks that its
    local shard of every param and state leaf is its slice of the
    gathered leaf; the collectives of step 1 counted by
    ``analysis.roofline.ProgramCounter`` around the step, and counted on
    the meta device (``steps.local_train_step``, which sends nothing);
  * ``resume``: a ``Trainer`` on one mesh for some steps, ``resume`` onto
    another mesh of the same ranks, and on; its ``program_cost`` beside
    the count of its first step on the new mesh;
  * ``serve``: ``jit_prefill_step`` and ``jit_decode_step`` on a mesh
    (the prompt and params ``INPUTS/tokens``, ``INPUTS/p/*`` when the
    case names ``inputs``);
  * ``sp``: the ``zero3_sp`` step's loss and gradients
    (``steps.local_loss_and_grads``) on one batch of the case's arch and
    params (``CASE/b/*``, ``CASE/p/*``); rank 0 records the loss and every
    gradient leaf gathered, every rank whether the step ran
    sequence-parallel;
  * ``ep_block``: the expert-parallel ``moe_block`` (tests/
    test_torch_moe_ep.py) on the rank's rows (its slice of the sequence
    under ``zero3_sp``) and its block of experts, and the gradients of
    ``sum(out * w)``; every rank records its output and gradients, and
    the collectives of the forward and of the backward as
    ``analysis.roofline.ProgramCounter`` counts them;
  * ``ep_step``: a moe or hybrid arch's ``jit_train_step`` for some
    AdamW steps from the case's params and batch (``CASE/p/*``,
    ``CASE/b/*``), then, from the same initial params,
    ``jit_prefill_step`` into a longer cache and ``jit_decode_step`` on
    fixed tokens; rank 0 records the losses, every leaf gathered after
    the last step, the logits and the cache.

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

from repro_torch.analysis.roofline import ProgramCounter, count_program  # noqa: E402
from repro_torch.configs.base import ShapeSpec, reduce_for_smoke  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.distributed import steps  # noqa: E402
from repro_torch.distributed.sharding import (Dist, Sharding, distribute,  # noqa: E402
                                              gather)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models.layers import iter_leaves, leaf_at, map_leaves  # noqa: E402
from repro_torch.optim.optimizers import (OptConfig, init_opt_state,  # noqa: E402
                                          opt_state_specs)
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

# the port's models without remat, as the reference's tests build theirs
NO_REMAT = {"remat": "none"}


def _cfg(arch):
    return reduce_for_smoke(get_arch(arch))


def _params(inputs, prefix="p/"):
    out = {}
    for k in inputs.files:
        if k.startswith(prefix):
            node = out
            *parents, last = k[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = torch.from_numpy(inputs[k].copy())
    return out


def _shards_match(tree, specs, mesh):
    """Every leaf's local shard is its slice of the gathered leaf."""
    ok = True
    for path, x in iter_leaves(tree):
        full = gather(x)
        sh = Sharding(mesh, leaf_at(specs, path))
        want = full[sh.local_slices(full.shape)]
        ok &= bool(torch.equal(x.to_local(), want))
    return ok


def run_step(case, inputs, rank, out, arrays):
    cfg = _cfg(case["arch"])
    mesh = make_mesh(*case["mesh"], device="cpu")
    B = int(inputs["tokens"].shape[0])
    d = Dist(mesh=mesh, policy=case["policy"]).resolve_batch(B)
    model = make_model(cfg, d, NO_REMAT)
    opt = OptConfig(**case["opt"])
    shape = ShapeSpec("t", int(inputs["tokens"].shape[1]), B, "train")
    step = steps.jit_train_step(model, opt, shape)
    psh = model.param_shardings()
    params = map_leaves(lambda p, x: distribute(x, leaf_at(psh, p)),
                        _params(inputs))
    ospecs = opt_state_specs(opt, model.param_defs(), d)
    full_state = init_opt_state(opt, _params(inputs))
    state = {k: (distribute(v, Sharding(mesh, ospecs[k])) if k == "step"
                 else map_leaves(lambda p, x, k=k: distribute(
                     x, Sharding(mesh, leaf_at(ospecs[k], p))), v))
             for k, v in full_state.items()}
    batch = {"tokens": torch.from_numpy(inputs["tokens"]).long(),
             "labels": torch.from_numpy(inputs["labels"]).long()}
    losses, ok = [], True
    for i in range(case["steps"]):
        if i == 0:
            with ProgramCounter() as pc:
                params, state, loss = step(params, state, batch)
            out["counted"] = pc.totals()["collective_bytes_by_kind"]
            out["listed"] = count_program(
                steps.local_train_step(model, opt, shape),
                *steps.abstract_local_inputs(model, shape, opt))[
                    "collective_bytes_by_kind"]
        else:
            params, state, loss = step(params, state, batch)
        losses.append(float(loss))
        if i in (0, case["steps"] - 1):
            for path, x in iter_leaves(params):
                full = gather(x)
                if rank == 0:
                    arrays[f"{case['id']}/{i}/{path}"] = full.numpy().copy()
        ok &= _shards_match(params, model.param_specs(), mesh)
        ok &= _shards_match({k: v for k, v in state.items()
                             if k != "step"},
                            {k: v for k, v in ospecs.items()
                             if k != "step"}, mesh)
    out["losses"] = losses
    out["shards_match"] = ok
    out["step_count"] = int(gather(state["step"]))
    x = torch.arange(8.0 * 6).reshape(8, 6)
    c = d.constrain(x, steps.P("data", "model"))
    out["constrain"] = bool(torch.equal(c.to_local(), x[Sharding(
        mesh, steps.P("data", "model")).local_slices(x.shape)])) and bool(
        torch.equal(gather(d.constrain(c, steps.P())), x))


def run_resume(case, inputs, rank, out, arrays, workdir):
    cfg = _cfg(case["arch"])
    opt = OptConfig(**case["opt"])
    tc = TrainerConfig(batch=case["batch"], seq=case["seq"],
                       ckpt_dir=str(Path(workdir) / f"ckpt-{case['id']}"))
    tr = Trainer(cfg, Dist(mesh=make_mesh(*case["mesh"], device="cpu")),
                 opt, tc).init(case["seed"])
    losses = [tr.step_once(tr._batch(s)) for s in range(case["before"])]
    tr.resume(Dist(mesh=make_mesh(*case["to"], device="cpu")))
    out["resumed_at"] = tr.step
    out["mesh_after"] = list(tr.dist.mesh.mesh.shape)
    cost = tr.program_cost()
    out["cost"] = {k: cost[k] for k in ("collective_bytes_by_kind",
                                         "ici_bytes_per_device",
                                         "flops_per_device")}
    with ProgramCounter() as pc:
        losses.append(tr.step_once(tr._batch(case["before"])))
    out["counted"] = pc.totals()["collective_bytes_by_kind"]
    losses += [tr.step_once(tr._batch(s))
               for s in range(case["before"] + 1, case["before"]
                              + case["after"])]
    out["losses"] = losses


def run_serve(case, inputs, rank, out, arrays):
    cfg = _moe_cfg(case) if case.get("capacity_factor") else \
        _cfg(case["arch"])
    mesh = make_mesh(*case["mesh"], device="cpu")
    pre = case.get("inputs", "")     # the case's own tokens and params
    prompt = torch.from_numpy(
        inputs[pre + "tokens"][:, :case["prompt"]]).long()
    B = prompt.shape[0]
    d = Dist(mesh=mesh, policy=case["policy"]).resolve_batch(B)
    model = make_model(cfg, d, NO_REMAT)
    shape = ShapeSpec("s", case["prompt"], B, "prefill")
    psh = model.param_shardings()
    params = map_leaves(lambda p, x: distribute(x, leaf_at(psh, p)),
                        _params(inputs, pre + "p/"))
    csh = model.cache_shardings(B)
    empty = model.empty_cache(B, case["prompt"] + case["new"], "cpu")
    cache = {k: distribute(v, csh[k]) for k, v in empty.items()}
    logits, cache = steps.jit_prefill_step(model, shape)(
        params, {"tokens": prompt}, cache=cache)
    out["cache_layout"] = all(tuple(v.placements) == csh[k].placements
                              for k, v in cache.items())
    decode = steps.jit_decode_step(model, shape)
    got = [logits.full_tensor()]
    for _ in range(case["new"]):
        nxt = got[-1].argmax(-1)
        logits, cache = decode(params, cache, {"tokens": nxt})
        got.append(logits.full_tensor())
    whole = {k: v.full_tensor() for k, v in cache.items()}  # collective
    if rank == 0:
        arrays[f"{case['id']}/logits"] = torch.cat(got, 1).numpy()
        for k, v in whole.items():
            arrays[f"{case['id']}/cache/{k}"] = v.numpy()


def run_sp(case, inputs, rank, out, arrays):
    cfg = _cfg(case["arch"])
    mesh = make_mesh(*case["mesh"], device="cpu")
    pre = f"{case['data']}/b/"
    batch = {k[len(pre):]: torch.from_numpy(inputs[k].copy())
             for k in inputs.files if k.startswith(pre)}
    batch = {k: v.long() if not v.is_floating_point() else v
             for k, v in batch.items()}
    B = batch["labels"].shape[0]
    d = Dist(mesh=mesh, policy="zero3_sp").resolve_batch(B)
    model = make_model(cfg, d, case["opts"])
    shape = ShapeSpec("t", int(batch["labels"].shape[1]), B, "train")
    psh = model.param_shardings()
    params = map_leaves(lambda p, x: distribute(x, leaf_at(psh, p)),
                        _params(inputs, f"{case['data']}/p/"))
    fn = steps.local_loss_and_grads(model, shape)
    out["sp"] = fn.seq_parallel(batch)
    loss, grads = fn(steps._local(params), batch)
    out["loss"] = float(loss)
    specs = model.param_specs()
    for path, g in iter_leaves(grads):
        whole = steps._gatherleaf_at(g, leaf_at(specs, path), mesh)
        if rank == 0:
            arrays[f"{case['id']}/{path}"] = whole.numpy().copy()


def _moe_cfg(case):
    import dataclasses
    cfg = _cfg(case["arch"])
    over = {k: case[k] for k in ("n_experts", "capacity_factor")
            if case.get(k) is not None}
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over))


def run_ep_block(case, inputs, rank, out, arrays):
    import dataclasses
    from repro_torch.models import moe
    cfg = _moe_cfg(case)
    mesh = make_mesh(*case["mesh"], device="cpu")
    pre = case["id"] + "/"
    x = torch.from_numpy(inputs[pre + "x"].copy())
    w = torch.from_numpy(inputs[pre + "w"].copy())
    d = Dist(mesh=mesh, policy=case["policy"]).resolve_batch(x.shape[0])
    ep = steps._expert_parallel(make_model(cfg, d, NO_REMAT))
    coord = dict(zip(("data", "model"), mesh.get_coordinate()))
    nb = x.shape[0] // case["mesh"][0]
    rows = slice(coord["data"] * nb, (coord["data"] + 1) * nb)
    x, w = x[rows], w[rows]
    if case["policy"] == "zero3_sp":
        ep = dataclasses.replace(ep, sliced=True)
        n = x.shape[1] // ep.size
        x, w = (t[:, ep.rank * n:(ep.rank + 1) * n] for t in (x, w))
    e_local = inputs[pre + "p/wg"].shape[0] // ep.size
    mine = slice(ep.rank * e_local, (ep.rank + 1) * e_local)
    params = {k: torch.from_numpy(inputs[pre + "p/" + k].copy())
              for k in ("router", "wg", "wu", "wd")}
    params = {k: (v if k == "router" else v[mine]).clone().requires_grad_()
              for k, v in params.items()}
    x = x.clone().requires_grad_()
    with ProgramCounter() as fwd:
        y = moe.moe_block(x, params, cfg, ep=ep)
    with ProgramCounter() as bwd:
        (y.float() * w).sum().backward()
    out["coord"] = [coord["data"], coord["model"]]
    out["colls"] = {"fwd": [list(c) for c in fwd.colls],
                    "bwd": [list(c) for c in bwd.colls]}
    out["r"] = ep.r
    arrays[pre + "out"] = y.detach().numpy()
    arrays[pre + "dx"] = x.grad.numpy()
    for k, v in params.items():
        arrays[pre + "d" + k] = v.grad.numpy()


def run_ep_step(case, inputs, rank, out, arrays):
    cfg = _moe_cfg(case)
    mesh = make_mesh(*case["mesh"], device="cpu")
    pre = case["id"] + "/"
    tokens = torch.from_numpy(inputs[pre + "b/tokens"]).long()
    labels = torch.from_numpy(inputs[pre + "b/labels"]).long()
    B, S = tokens.shape
    d = Dist(mesh=mesh, policy=case["policy"]).resolve_batch(B)
    model = make_model(cfg, d, NO_REMAT)
    opt = OptConfig(name="adamw", lr=case["lr"])
    shape = ShapeSpec("t", S, B, "train")
    psh = model.param_shardings()
    params = map_leaves(lambda p, x: distribute(x, leaf_at(psh, p)),
                        _params(inputs, pre + "p/"))
    ospecs = opt_state_specs(opt, model.param_defs(), d)
    full_state = init_opt_state(opt, _params(inputs, pre + "p/"))
    state = {k: (distribute(v, Sharding(mesh, ospecs[k])) if k == "step"
                 else map_leaves(lambda p, x, k=k: distribute(
                     x, Sharding(mesh, leaf_at(ospecs[k], p))), v))
             for k, v in full_state.items()}
    step = steps.jit_train_step(model, opt, shape)
    losses = []
    for _ in range(case["steps"]):
        params, state, loss = step(params, state,
                                   {"tokens": tokens, "labels": labels})
        losses.append(float(loss))
    out["losses"] = losses
    for path, x in iter_leaves(params):
        full = gather(x)
        if rank == 0:
            arrays[f"{pre}params/{path}"] = full.numpy().copy()
    if not case.get("prompt"):
        return
    params = map_leaves(lambda p, x: distribute(x, leaf_at(psh, p)),
                        _params(inputs, pre + "p/"))
    plen = case["prompt"]
    pshape = ShapeSpec("s", plen, B, "prefill")
    csh = model.cache_shardings(B)
    empty = model.empty_cache(B, plen + case["new"], "cpu")
    cache = {k: distribute(v, csh[k]) for k, v in empty.items()}
    logits, cache = steps.jit_prefill_step(model, pshape)(
        params, {"tokens": tokens[:, :plen]}, cache=cache)
    got = [logits.full_tensor()]
    decode = steps.jit_decode_step(model, pshape)
    for i in range(case["new"]):
        logits, cache = decode(params, cache,
                               {"tokens": tokens[:, plen + i:plen + i + 1]})
        got.append(logits.full_tensor())
    whole = {k: v.full_tensor() for k, v in cache.items()}  # collective
    if rank == 0:
        arrays[pre + "logits"] = torch.cat(got, 1).numpy()
        for k, v in whole.items():
            arrays[f"{pre}cache/{k}"] = v.numpy()


def main():
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    torch.manual_seed(0)
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(str(Path(workdir) / "store"), world),
        rank=rank, world_size=world)
    inputs = np.load(Path(workdir) / "inputs.npz")
    cases = json.loads((Path(workdir) / "cases.json").read_text())
    results, arrays = {}, {}
    for case in cases:
        out = results[case["id"]] = {}
        if case["kind"] == "step":
            run_step(case, inputs, rank, out, arrays)
        elif case["kind"] == "resume":
            run_resume(case, inputs, rank, out, arrays, workdir)
        elif case["kind"] == "sp":
            run_sp(case, inputs, rank, out, arrays)
        elif case["kind"] == "ep_block":
            run_ep_block(case, inputs, rank, out, arrays)
        elif case["kind"] == "ep_step":
            run_ep_step(case, inputs, rank, out, arrays)
        else:
            run_serve(case, inputs, rank, out, arrays)
    np.savez(Path(workdir) / f"out-{rank}.npz", **arrays)
    (Path(workdir) / f"out-{rank}.json").write_text(json.dumps(results))
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()
