"""The port's dry-run (``repro_torch.launch.dryrun``) and what it needs:
``analysis.roofline.memory_program``, the reference's ``remat`` option,
and the mesh steps at a batch the data axes do not divide.

  * ``memory_program`` on hand-built programs gives the hand-computed
    sizes: views and in-place ops add nothing, a planted live tensor
    adds exactly its bytes, autograd's saved tensors count while held;
  * ``remat`` ``none`` / ``dots`` / ``full`` give bit-equal losses and
    gradients for smoke stablelm, jamba and whisper, and the dry-run's
    temp bytes order ``full < none`` and ``dots <= none``;
  * the miniature of ``tests/test_multidevice.py:141``: a ``fake`` group
    of 8 ranks, a (4, 2) mesh, six smoke archs x train / prefill /
    decode, each counted; the per-device bytes of the params, the
    optimizer state and the cache equal the reference's
    (``NamedSharding(mesh, spec).shard_shape`` in a JAX subprocess with
    8 host devices, no compile);
  * ``run_cell`` at the production meshes (a ``fake`` group of 512
    ranks): its FLOPs and bytes equal ``count_program``'s of the same
    step, a skipped cell gives the reference's reason, and the CLI
    writes its record and prints one line;
  * prefill and decode at batch 1 on 4 gloo ranks (2 x 2) equal the
    one-card steps for smoke mamba2 and jamba;
  * a 1-rank gloo trainer's params, state and batch hold exactly the
    bytes the dry-run counts as its arguments.

Each fake-group or gloo case runs in subprocesses of its own (a
``FakeStore`` needs no port; gloo rendezvouses through a ``FileStore``
under ``tmp_path``), so the tests stay xdist-safe.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES_BY_NAME as JAX_SHAPES
from repro.configs.base import skip_reason as jax_skip_reason
from repro.configs.registry import get_arch as jax_get_arch
from repro_torch.analysis.roofline import memory_program
from repro_torch.configs.base import ShapeSpec, reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import steps
from repro_torch.launch.dryrun import dry_step
from repro_torch.models import make_model
from repro_torch.models.layers import iter_leaves
from util_gloo import spawn_ranks
from util_subproc import run_with_devices

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
WORKER = Path(__file__).resolve().parent / "util_gloo_worker.py"
FWD_TOL = dict(atol=2e-5, rtol=2e-5)     # tests/test_torch_steps.py
REMAT_ARCHS = {"stablelm-1.6b": dict(n_layers=4),
               "jamba-1.5-large-398b": dict(n_layers=4, attn_period=2),
               "whisper-large-v3": dict(n_layers=4)}
TINY_ARCHS = ("stablelm-1.6b", "kimi-k2-1t-a32b", "mamba2-1.3b",
              "jamba-1.5-large-398b", "whisper-large-v3", "qwen2-vl-2b")
TINY_KINDS = (("train", 8, 64), ("prefill", 8, 64), ("decode", 8, 64))
CELLS = (("stablelm-1.6b", "train_4k", "single"),
         ("kimi-k2-1t-a32b", "train_4k", "multi"),
         ("jamba-1.5-large-398b", "long_500k", "multi"))
SERVE_ARCHS = ("mamba2-1.3b", "jamba-1.5-large-398b")


def _port(code: str, timeout: int = 600) -> dict:
    """Run ``code`` with the port alone in a subprocess; the JSON object
    on its last line of output."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=timeout,
                         cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# memory_program
# ---------------------------------------------------------------------------


def test_memory_program_gives_the_hand_computed_sizes():
    """Two live f32 temporaries of 100 values at once, a view and an
    in-place add that make nothing, one f32 scalar returned."""
    def f(x):
        a = x * 2                    # 400 bytes
        b = a + 1                    # 400 more: the high-water mark
        del a
        b.view(10, 10).add_(1)       # a view and an in-place op: 0
        return b.sum()               # 4
    m = memory_program(f, torch.empty(100))
    assert m == {"argument_size_in_bytes": 400, "output_size_in_bytes": 4,
                 "alias_size_in_bytes": 0, "temp_size_in_bytes": 796,
                 "peak_bytes_per_device": 1200}


def test_a_planted_live_tensor_adds_exactly_its_bytes():
    def f(x, plant):
        extra = torch.empty(plant, dtype=torch.bfloat16, device=x.device) \
            if plant else None
        a = x * 2
        b = a + 1
        del a
        y = b.sum()
        del extra, b
        return y
    x = torch.empty(100)
    base = memory_program(f, x, 0)
    planted = memory_program(f, x, 1000)
    assert planted["temp_size_in_bytes"] - base["temp_size_in_bytes"] \
        == 2000
    assert planted["peak_bytes_per_device"] \
        - base["peak_bytes_per_device"] == 2000


def test_views_and_in_place_updates_add_nothing():
    def f(x):
        x.mul_(2)
        x.view(4, 25).t().add_(1)
        x[3:].zero_()
        return x
    m = memory_program(f, torch.empty(100))
    assert m["temp_size_in_bytes"] == 0
    assert m["alias_size_in_bytes"] == m["output_size_in_bytes"] == 400
    assert m["peak_bytes_per_device"] == 400


def test_saved_tensors_count_while_autograd_holds_them():
    """exp's output (400 bytes) is saved for the backward: with autograd
    on it is still live when the later 1,600 bytes are, and the temp
    bytes rise by exactly its size."""
    def f(x, grad):
        with torch.set_grad_enabled(grad):
            x = x.detach().requires_grad_(grad)
            y = x.exp()                      # 400, saved under autograd
            z = (y * 3).sum()
            del y
            t = torch.cat([x, x]) * 5        # 800 + 800
            return (t.sum() + z).detach()
    x = torch.empty(100)
    off, on = memory_program(f, x, False), memory_program(f, x, True)
    assert on["temp_size_in_bytes"] - off["temp_size_in_bytes"] == 400


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


def _smoke(arch):
    return dataclasses.replace(reduce_for_smoke(get_arch(arch)),
                               **REMAT_ARCHS[arch])


def _batch(cfg, B=2, S=64, seed=1):
    g = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
           "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    if cfg.family == "encdec":
        out["enc_embeds"] = torch.randn(B, S, cfg.d_model, generator=g)
    return out


@pytest.mark.parametrize("arch", list(REMAT_ARCHS))
def test_remat_gives_bit_equal_gradients(arch):
    cfg = _smoke(arch)
    params = make_model(cfg, opts={"remat": "none"}).init(
        torch.Generator().manual_seed(0))
    batch = _batch(cfg)
    got = {m: steps.value_and_grad(make_model(cfg, opts={"remat": m}),
                                   params, batch)
           for m in ("none", "dots", "full")}
    for m in ("dots", "full"):
        assert torch.equal(got[m][0], got["none"][0]), m
        for (k, a), (_, b) in zip(iter_leaves(got[m][1]),
                                  iter_leaves(got["none"][1])):
            assert torch.equal(a, b), (m, k)


@pytest.mark.parametrize("arch", list(REMAT_ARCHS))
def test_remat_orders_the_dry_run_temp_bytes(arch):
    """At the smoke widths with 4 layers (jamba: two periods of 2), one
    train step's temp bytes on the meta device: ``full`` below ``none``,
    ``dots`` at most ``none``; the arguments are the same."""
    cfg = _smoke(arch)
    shape = ShapeSpec("t", 64, 4, "train")
    got = {m: dry_step(make_model(cfg, opts={"remat": m}), shape)
           for m in ("none", "dots", "full")}
    temp = {m: r["temp_size_in_bytes"] for m, r in got.items()}
    assert temp["full"] < temp["none"], temp
    assert temp["dots"] <= temp["none"], temp
    assert len({r["argument_size_in_bytes"] for r in got.values()}) == 1


def test_remat_is_the_reference_default_and_checked():
    cfg = reduce_for_smoke(get_arch("stablelm-1.6b"))
    assert make_model(cfg).remat == "full"
    assert make_model(cfg, opts={"xent_chunk": 64}).remat == "full"
    with pytest.raises(ValueError, match="remat"):
        make_model(cfg, opts={"remat": "some"})


def test_remat_does_nothing_without_autograd():
    """Prefill under ``no_grad`` runs the same ops in every mode: the
    same logits and the same count on the meta device."""
    from repro_torch.analysis.roofline import count_program
    cfg = reduce_for_smoke(get_arch("jamba-1.5-large-398b"))
    params = make_model(cfg, opts={"remat": "none"}).init(
        torch.Generator().manual_seed(0))
    prompt = {"tokens": _batch(cfg, 2, 40)["tokens"]}
    shape = ShapeSpec("p", 40, 2, "prefill")
    logits, counts = {}, {}
    for m in ("none", "full"):
        model = make_model(cfg, opts={"remat": m})
        logits[m] = steps.build_prefill_step(model)(params, prompt)[0]
        counts[m] = count_program(steps.build_prefill_step(model),
                                  *steps.abstract_inputs(model, shape))
    assert torch.equal(logits["none"], logits["full"])
    assert counts["none"] == counts["full"]


# ---------------------------------------------------------------------------
# The miniature of tests/test_multidevice.py:141 on a fake group of 8
# ---------------------------------------------------------------------------

_TINY_PORT = """
import json
from repro_torch.configs.base import ShapeSpec, reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import steps
from repro_torch.distributed.sharding import Dist
from repro_torch.launch.dryrun import dry_step, fake_world
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.layers import iter_leaves
from repro_torch.models.model import make_model
from repro_torch.optim.optimizers import OptConfig

fake_world(8)
mesh = make_mesh(4, 2, device="cpu")

def nbytes(tree, skip=()):
    n = 0
    for path, t in iter_leaves(tree):
        if path.split("/")[0] in skip:
            continue
        t = getattr(t, "_local_tensor", t)
        n += t.numel() * t.element_size()
    return n

out = {}
for arch in ARCHS:
    cfg = reduce_for_smoke(get_arch(arch))
    for kind, B, S in KINDS:
        shape = ShapeSpec("t", S, B, kind)
        dist = Dist(mesh=mesh).resolve_batch(B)
        model = make_model(cfg, dist, {"remat": "full", "xent_chunk": 32})
        opt = OptConfig(name="adamw")
        args = steps.abstract_local_inputs(model, shape, opt)
        rec = dry_step(model, shape, opt)
        got = {"params": nbytes(args[0]),
               "flops": rec["flops_per_device"],
               "argument": rec["argument_size_in_bytes"],
               "peak": rec["peak_bytes_per_device"]}
        if kind == "train":
            got["state"] = nbytes(args[1], skip=("step",))
        if kind == "decode":
            got["cache"] = nbytes(args[1], skip=("pos",))
        out[arch + "/" + kind] = got
print(json.dumps(out))
"""

_TINY_JAX = """
import json, math
import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import ShapeSpec, reduce_for_smoke
from repro.configs.registry import get_arch
from repro.distributed.sharding import Dist
from repro.distributed.steps import abstract_inputs
from repro.launch.mesh import make_mesh
from repro.models.model import make_model
from repro.optim.optimizers import OptConfig, opt_state_specs

mesh = make_mesh(data=4, model=2)

def nbytes(specs, tree, skip=()):
    n = 0
    for k in specs:
        if k in skip:
            continue
        pairs = jax.tree.leaves(jax.tree.map(
            lambda p, s: (p, s), specs[k], tree[k],
            is_leaf=lambda x: isinstance(x, P)),
            is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], P))
        for p, s in pairs:
            shard = NamedSharding(mesh, p).shard_shape(s.shape)
            n += math.prod(shard) * np.dtype(s.dtype).itemsize
    return n

out = {}
for arch in ARCHS:
    cfg = reduce_for_smoke(get_arch(arch))
    for kind, B, S in KINDS:
        shape = ShapeSpec("t", S, B, kind)
        dist = Dist(mesh=mesh).resolve_batch(B)
        model = make_model(cfg, dist, {"remat": "full", "xent_chunk": 32})
        opt = OptConfig(name="adamw")
        args = abstract_inputs(model, shape, opt)
        got = {"params": nbytes(model.param_specs(), args[0])}
        if kind == "train":
            got["state"] = nbytes(opt_state_specs(opt, model.param_defs(),
                                                  dist), args[1],
                                  skip=("step",))
        if kind == "decode":
            got["cache"] = nbytes(model.cache_sharding_specs(B), args[1],
                                  skip=("pos",))
        out[arch + "/" + kind] = got
print(json.dumps(out))
"""


def _fill(code):
    return code.replace("ARCHS", repr(TINY_ARCHS)).replace(
        "KINDS", repr(TINY_KINDS))


@pytest.fixture(scope="module")
def tiny():
    """(the port's counts on a fake 8-rank (4, 2) mesh, the reference's
    per-device bytes on 8 host devices)."""
    port = _port(_fill(_TINY_PORT))
    ref = json.loads(run_with_devices(_fill(_TINY_JAX), n=8)
                     .strip().splitlines()[-1])
    return port, ref


@pytest.mark.parametrize("kind", [k for k, _, _ in TINY_KINDS])
@pytest.mark.parametrize("arch", TINY_ARCHS)
def test_tiny_dryrun_all_step_kinds(tiny, arch, kind):
    port, ref = tiny
    got, want = port[f"{arch}/{kind}"], ref[f"{arch}/{kind}"]
    assert got["flops"] > 0 and got["peak"] >= got["argument"] > 0
    for key in want:
        assert got[key] == want[key], (key, got[key], want[key])


# ---------------------------------------------------------------------------
# run_cell at the production meshes, on a fake group of 512
# ---------------------------------------------------------------------------

_CELLS = """
import json, sys
from repro_torch.analysis.roofline import count_program
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import steps
from repro_torch.distributed.sharding import Dist
from repro_torch.launch.dryrun import fake_world, run_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import make_model

fake_world()
out = {}
for arch, shape_name, mesh_name in CELLS:
    rec = run_cell(arch, shape_name, mesh_name, save_ops=False)
    cfg, shape = get_arch(arch), SHAPES_BY_NAME[shape_name]
    mesh = make_production_mesh(multi_pod=mesh_name == "multi",
                                device="cpu")
    dist = Dist(mesh=mesh).resolve_batch(shape.global_batch)
    model = make_model(cfg, dist, {"remat": "full"})
    opt = steps.default_optimizer(cfg)
    step = (steps.local_train_step(model, opt, shape)
            if shape.kind == "train" else steps.jit_decode_step(model, shape))
    want = count_program(step, *steps.abstract_local_inputs(model, shape,
                                                           opt))
    out["/".join((arch, shape_name, mesh_name))] = {"rec": rec,
                                                    "want": want}
out["skip"] = run_cell("stablelm-1.6b", "long_500k", "single")
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cells():
    return _port(_CELLS.replace("CELLS", repr(CELLS)), timeout=900)


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_run_cell_at_the_production_meshes(cells, arch, shape, mesh):
    got = cells["/".join((arch, shape, mesh))]
    rec, want = got["rec"], got["want"]
    assert rec["status"] == "ok"
    assert rec["n_params"] == get_arch(arch).n_params()
    for key in ("flops_per_device", "hbm_bytes_per_device",
                "ici_bytes_per_device", "collective_bytes_by_kind"):
        assert rec[key] == want[key], key
    assert rec["peak_bytes_per_device"] == (
        rec["argument_size_in_bytes"] - rec["alias_size_in_bytes"]
        + rec["output_size_in_bytes"] + rec["temp_size_in_bytes"])
    assert rec["fits_h100_80gb"] == (rec["peak_bytes_per_device"] <= 80e9)
    assert rec["ici_bytes_per_device"] > 0


def test_run_cell_skips_as_the_reference(cells):
    rec = cells["skip"]
    want = jax_skip_reason(jax_get_arch("stablelm-1.6b"),
                           JAX_SHAPES["long_500k"])
    assert rec["status"] == "skipped" and rec["reason"] == want


def test_cli_writes_one_record_and_prints_one_line(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "stablelm-1.6b", "--shape", "long_500k", "--mesh", "single",
         "--out", str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["status"] == "skipped"
    saved = json.loads(
        (tmp_path / "stablelm-1.6b__long_500k__single.json").read_text())
    assert saved == rec


def test_import_touches_no_process_group():
    got = _port("import json, torch.distributed as d\n"
                "import repro_torch.launch.dryrun\n"
                "print(json.dumps({'init': d.is_initialized()}))")
    assert got == {"init": False}


# ---------------------------------------------------------------------------
# A batch the data axes do not divide, on 4 gloo ranks
# ---------------------------------------------------------------------------

def _tree(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, last = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = torch.from_numpy(v.copy())
    return tree


# jamba's moe layers run expert-parallel on the mesh, where each rank's
# experts take the capacity of its own tokens: at a capacity factor of 8
# neither path drops a pair, so the two must agree
SERVE_CAPACITY = {"jamba-1.5-large-398b": 8.0}


def _serve_cfg(arch):
    cfg = reduce_for_smoke(get_arch(arch))
    if arch in SERVE_CAPACITY:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=SERVE_CAPACITY[arch]))
    return cfg


def _serve_case(arch):
    return dict(id=arch, kind="serve", arch=arch, mesh=[2, 2],
                policy="fsdp_tp", prompt=12, new=4, inputs=arch + "/",
                capacity_factor=SERVE_CAPACITY.get(arch))


@pytest.fixture(scope="module")
def undivided(tmp_path_factory):
    """Prefill and decode at batch 1 on a 2 x 2 gloo mesh per arch; rank
    0's logits and cache, and the inputs."""
    work = tmp_path_factory.mktemp("undivided")
    arrays, inputs = {}, {}
    for i, arch in enumerate(SERVE_ARCHS):
        cfg = _serve_cfg(arch)
        params = make_model(cfg, opts={"remat": "none"}).init(
            torch.Generator().manual_seed(i))
        toks = np.random.default_rng(7 + i).integers(
            0, cfg.vocab_size, (1, 16)).astype(np.int32)
        inputs[arch] = ({k: v.numpy() for k, v in iter_leaves(params)},
                        toks)
        arrays[arch + "/tokens"] = toks
        for k, v in inputs[arch][0].items():
            arrays[f"{arch}/p/{k}"] = v
    np.savez(work / "inputs.npz", **arrays)
    (work / "cases.json").write_text(json.dumps(
        [_serve_case(a) for a in SERVE_ARCHS]))
    spawn_ranks(WORKER, work, 4, timeout=600)
    every = [json.loads((work / f"out-{r}.json").read_text())
             for r in range(4)]
    return dict(np.load(work / "out-0.npz")), every, inputs


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_undivided_batch_steps_match_one_card(undivided, arch):
    """B = 1 on (2, 2): no batch axis divides it, so every rank prefills
    and decodes the whole batch; the logits and the cache, laid out with
    its sequence dim over every axis, equal the one-card steps'."""
    arrays, every, inputs = undivided
    case = _serve_case(arch)
    assert all(r[arch]["cache_layout"] for r in every)
    flat, toks = inputs[arch]
    cfg = _serve_cfg(arch)
    model = make_model(cfg, opts={"remat": "none"})
    tree = _tree(flat)
    prompt = torch.from_numpy(toks[:, :case["prompt"]]).long()
    cache = model.empty_cache(1, case["prompt"] + case["new"], "cpu")
    logits, cache = steps.build_prefill_step(model)(
        tree, {"tokens": prompt}, cache=cache, slots=torch.arange(1))
    got = [logits]
    decode = steps.build_decode_step(model)
    for _ in range(case["new"]):
        logits, cache = decode(tree, cache, {"tokens": got[-1].argmax(-1)})
        got.append(logits)
    np.testing.assert_allclose(arrays[f"{arch}/logits"],
                               torch.cat(got, 1).numpy(), **FWD_TOL)
    for k, v in cache.items():
        np.testing.assert_allclose(arrays[f"{arch}/cache/{k}"], v.numpy(),
                                   **FWD_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# The arguments the dry-run counts are the bytes a trainer holds
# ---------------------------------------------------------------------------

_TRAINER = """
import json, sys
import torch, torch.distributed as tdist
from repro_torch.configs.base import reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.distributed.sharding import Dist
from repro_torch.launch.dryrun import dry_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.layers import iter_leaves
from repro_torch.optim.optimizers import OptConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig

tdist.init_process_group("gloo", store=tdist.FileStore(STORE, 1), rank=0,
                         world_size=1)
cfg = reduce_for_smoke(get_arch("stablelm-1.6b"))
mesh = make_mesh(1, 1, device="cpu")
opt = OptConfig(name="adamw", lr=3e-4)
tr = Trainer(cfg, Dist(mesh=mesh), opt, TrainerConfig(batch=4, seq=64,
             ckpt_dir=CKPT), opts={"remat": "full"}).init(0)
batch = tr._batch(0)
seen, held = set(), 0
for tree in (tr.params, tr.opt_state, batch):
    for _, t in iter_leaves(tree):
        st = getattr(t, "_local_tensor", t).untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            held += st.nbytes()
rec = dry_step(tr.model, tr.shape, opt)
print(json.dumps({"held": held, "argument": rec["argument_size_in_bytes"],
                  "remat": tr.model.remat}))
tdist.destroy_process_group()
"""


def test_dry_run_arguments_are_the_trainer_bytes(tmp_path):
    """A 1-rank gloo trainer (the CPU twin of the card's check) holds
    exactly the bytes of params, optimizer state and batch that the
    dry-run of its step counts as arguments."""
    code = _TRAINER.replace("STORE", repr(str(tmp_path / "store"))) \
        .replace("CKPT", repr(str(tmp_path / "ckpt")))
    got = _port(code)
    assert got["remat"] == "full"
    assert got["held"] == got["argument"] > 0


def test_dry_step_without_a_mesh_is_the_one_card_count():
    from repro_torch.analysis.roofline import count_program
    cfg = reduce_for_smoke(get_arch("stablelm-1.6b"))
    model = make_model(cfg, opts={"remat": "none"})
    shape = ShapeSpec("d", 64, 2, "decode")
    rec = dry_step(model, shape)
    want = count_program(steps.build_decode_step(model),
                         *steps.abstract_inputs(model, shape))
    assert rec["flops_per_device"] == want["flops_per_device"]
    assert rec["hbm_bytes_per_device"] == want["hbm_bytes_per_device"]
    # decode updates the cache in place and returns it: aliased
    assert rec["alias_size_in_bytes"] > 0
