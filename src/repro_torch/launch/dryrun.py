r"""Multi-pod dry-run: count every (arch x shape x mesh) cell's step on the
meta device, the counterpart of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell for 512 forced host devices
and reads XLA's memory and cost analyses. The port has no compiler: it
runs the cell's step once on meta tensors (shapes and dtypes, no data)
over a ``fake`` process group of 256 or 512 ranks, as rank 0 of the
production mesh (``launch/mesh.py``, a ``DeviceMesh`` of the CPU device
type), and counts it there (``analysis/roofline.py``
``measure_program``). For each cell this gives:

  * the reference's ``memory_analysis`` sizes and
    ``peak_bytes_per_device`` (does it fit? ``fits_h100_80gb``): the
    bytes of the storages the step holds at once, autograd's saved
    tensors and the whole-tree weight gather included;
  * FLOPs, HBM bytes and collective bytes a device, from the very ops
    and functional collectives the step issues (a collective on the
    ``fake`` group moves nothing), with ``roofline_row``'s terms;
  * with ``save_ops``, the per-op rows (``<key>.ops.json.gz``) in place
    of the reference's HLO.

Nothing touches a card on any machine, as the reference's touches no
TPU, and importing this module touches no process-group state:
``fake_world`` starts the group, and only ``main`` calls it (the
counterpart of the reference's ``XLA_FLAGS`` line).

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b \
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import gzip
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

from repro_torch.analysis.roofline import (HBM_BYTES, measure_program,
                                           roofline_row)
from repro_torch.configs.base import (SHAPES_BY_NAME, ShapeSpec, shapes_for,
                                      skip_reason)
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.distributed import steps
from repro_torch.distributed.sharding import Dist
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import Model, make_model
from repro_torch.optim.optimizers import OptConfig

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
WORLD = 512          # the multi-pod mesh's ranks; the single mesh takes 256
MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
               "alias_size_in_bytes", "temp_size_in_bytes",
               "peak_bytes_per_device")


def fake_world(world_size: int = WORLD) -> None:
    """Start a ``fake`` process group of ``world_size`` ranks, this
    process rank 0 (its collectives return at once and move nothing);
    one of at least that size already started is kept."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if tdist.is_initialized():
        if tdist.get_world_size() >= world_size:
            return
        tdist.destroy_process_group()
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=world_size)


def dry_step(model: Model, shape: ShapeSpec,
             opt_cfg: Optional[OptConfig] = None,
             grad_accum: int = 1) -> Dict:
    """One step of ``shape.kind`` for ``model.dist`` (no mesh, a 1-rank
    mesh or a production mesh), run once on this rank's meta inputs
    (``steps.abstract_local_inputs``): train ``local_train_step`` (the
    one-card ``build_train_step`` without a mesh), prefill and decode
    ``jit_prefill_step`` / ``jit_decode_step``. Returns
    ``count_program``'s terms, ``memory_program``'s sizes, ``count_s``
    (seconds of the run) and ``rows`` (per-op counts), all from that one
    run."""
    d = model.dist
    oc = opt_cfg or steps.default_optimizer(model.cfg)
    if shape.kind == "train":
        step = (steps.local_train_step(model, oc, shape, grad_accum)
                if d.has_mesh else steps.build_train_step(model, oc,
                                                          grad_accum))
    elif shape.kind == "prefill":
        step = steps.jit_prefill_step(model, shape)
    else:
        step = steps.jit_decode_step(model, shape)
    args = steps.abstract_local_inputs(model, shape, oc)
    t0 = time.perf_counter()
    totals, mem, rows = measure_program(step, *args)
    return {**totals, **mem, "count_s": time.perf_counter() - t0,
            "rows": rows}


def run_cell(arch_id: str, shape_name: str, mesh_name: str, *,
             policy: str = "fsdp_tp", remat: str = "full",
             grad_accum: int = 1, opt_name: str = "",
             save_ops: bool = True, out_dir: Path = RESULTS,
             tag: str = "") -> Dict:
    """The reference's ``run_cell`` on the port: the cell's record, its
    step counted on the production mesh ("single" (16, 16), "multi" (2,
    16, 16)) of the ``fake`` group that ``fake_world`` started."""
    cfg = get_arch(arch_id)
    shape = SHAPES_BY_NAME[shape_name]
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "policy": policy, "remat": remat, "grad_accum": grad_accum,
           "tag": tag}
    skip = skip_reason(cfg, shape)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec

    multi = mesh_name == "multi"
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    dist = Dist(mesh=mesh, policy=policy).resolve_batch(shape.global_batch)
    model = make_model(cfg, dist, {"remat": remat})
    opt_cfg = (OptConfig(name=opt_name) if opt_name
               else steps.default_optimizer(cfg))
    rec["optimizer"] = opt_cfg.name
    rec["n_params"] = cfg.n_params()
    rec["n_active_params"] = cfg.n_active_params()

    res = dry_step(model, shape, opt_cfg, grad_accum)
    rows = res.pop("rows")
    rec["count_s"] = round(res.pop("count_s"), 2)
    for k in MEMORY_KEYS:
        rec[k] = res.pop(k)
    rec["fits_h100_80gb"] = rec["peak_bytes_per_device"] <= HBM_BYTES
    rec.update(res)
    n_chips = mesh.size()
    rec.update(roofline_row(rec, res, cfg, shape, n_chips))

    if save_ops:
        out_dir.mkdir(parents=True, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        op = out_dir / f"{arch_id}__{shape_name}__{mesh_name}{suffix}" \
                       f".ops.json.gz"
        rows.sort(key=lambda r: -r["GB"])
        with gzip.open(op, "wt") as f:
            json.dump(rows, f)
        rec["ops"] = str(op)
    rec["status"] = "ok"
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--policy", default="fsdp_tp")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--optimizer", default="")
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-ops", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    fake_world(WORLD)

    cells = []
    archs = list(ARCH_IDS) if (args.all or not args.arch) \
        else args.arch.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for a in archs:
        cfg = get_arch(a)
        shs = ([SHAPES_BY_NAME[s] for s in args.shape.split(",")]
               if args.shape else list(shapes_for(cfg)))
        for s in shs:
            for m in meshes:
                cells.append((a, s.name, m))

    for a, s, m in cells:
        key = f"{a}__{s}__{m}" + (f"__{args.tag}" if args.tag else "")
        jp = out_dir / f"{key}.json"
        try:
            rec = run_cell(a, s, m, policy=args.policy, remat=args.remat,
                           grad_accum=args.grad_accum,
                           opt_name=args.optimizer,
                           save_ops=not args.no_ops, out_dir=out_dir,
                           tag=args.tag)
        except Exception as e:  # record, keep sweeping
            rec = {"arch": a, "shape": s, "mesh": m, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-3000:]}
        jp.write_text(json.dumps(rec, indent=1))
        msg = {k: v for k, v in rec.items() if k not in ("trace", "ops")}
        sys.stdout.write(json.dumps(msg) + "\n")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
