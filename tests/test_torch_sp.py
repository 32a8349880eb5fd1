"""The ``zero3_sp`` policy's sequence-parallel attention in the port
(``models.attention.sp_flash_attention``, the SP branches of
``models.transformer`` and ``models.encdec``, the SP step of
``distributed.steps``) against the JAX package on the CPU.

Pieces, in one process: each rank's slice of the queries against the
gathered keys at ``q_offset = rank * S/n`` gives its rows of the whole
causal attention and of its gradients (JAX's ``flash_attention_ref``
and its VJP on repeated heads, ``GQA``), and ``GatherSeq``'s backward
is a reduce-scatter.

The step, on 4 gloo ranks spawned once (``util_gloo_worker.py``, a
``FileStore`` under ``tmp_path``: no port), meshes (data 2, model 2) and
(data 1, model 4), policy ``zero3_sp``: the loss and every gradient leaf
of the smoke models of stablelm-1.6b (tokens), qwen2-vl-2b (``embeds``
and M-RoPE positions) and whisper-large-v3 (frames and tokens) against
JAX's mesh-less ``value_and_grad`` of ``Model.loss`` from one
JAX-initialised vector, the loss within ``FWD_TOL`` and the gradients
within ``MODEL_TOL``; where a sequence does not divide the "model" size
(whisper's decoder 18, stablelm 18 on 4) the step keeps the replicated
path, as the reference's ``_sp_ok`` / ``_use_sp``, and still matches.

Whisper's smoke gradients in f32 are ill-conditioned (encoder logits of
std ~20; tests/test_torch_encdec.py::test_smoke_step_f32_conditioning):
the port's one-card gradient is already up to ~2e-3 from JAX's there,
past ``MODEL_TOL``. So whisper's gradients are held within ``MODEL_TOL``
of the port's mesh-less ``steps.value_and_grad`` on the same batch
(which tests/test_torch_steps.py ties to JAX through the step), its
loss against JAX's within ``FWD_TOL``, and its gradients also against
JAX's within ``JAX_GRAD_TOL``, the limit tests/test_torch_encdec.py
holds the port's one-card whisper gradient to. So are the replicated cases
("-odd"): they run the mesh-less step's arithmetic on every rank, and
at stablelm's 18 tokens the port's one-card embedding gradient is one
element in 16,384 past ``MODEL_TOL`` from JAX's (1.29e-4 against a
limit of 1.06e-4; ROADMAP Queue 3)."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduce_for_smoke as jax_reduce
from repro.configs.registry import get_arch as jax_get_arch
from repro.distributed.sharding import Dist as JDist
from repro.models import make_model as jax_make_model
from repro.models.attention import flash_attention_ref, repeat_kv
from repro.runtime.learner import _flat_io
from repro_torch.configs.registry import get_arch
from repro_torch.configs.base import reduce_for_smoke
from repro_torch.distributed import steps
from repro_torch.models import attention as tatt
from repro_torch.models import make_model
from repro_torch.models.layers import iter_leaves
from repro_torch.weights import params_from_flat
from util_gloo import spawn_ranks
from util_parity import vision_positions

FWD_TOL = dict(atol=2e-5, rtol=2e-5)     # tests/test_torch_steps.py
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
# tests/test_torch_encdec.py GRAD_TOL: the port's one-card f32 whisper
# gradient against JAX's
JAX_GRAD_TOL = dict(atol=2e-3, rtol=2e-3)
ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
WORLD = 4
OPTS = {"remat": "none", "xent_chunk": 512, "q_chunk": 32, "k_chunk": 32}
WORKER = Path(__file__).resolve().parent / "util_gloo_worker.py"
B = 4
# (arch, decoder/sequence length, encoder frames): each divides 2 and 4
# but the "-odd" ones, which divide neither 4 (the replicated path)
DATA = {"stablelm": ("stablelm-1.6b", 16, None),
        "qwen2-vl": ("qwen2-vl-2b", 16, None),
        "whisper": ("whisper-large-v3", 16, 24),
        "whisper-odd": ("whisper-large-v3", 18, 24),
        "stablelm-odd": ("stablelm-1.6b", 18, None)}
CASES = [(d, m) for d in ("stablelm", "qwen2-vl", "whisper")
         for m in ("2x2", "1x4")] + [("whisper-odd", "1x4"),
                                     ("stablelm-odd", "1x4")]
MESHES = {"2x2": [2, 2], "1x4": [1, 4]}
# gradients held against the port's mesh-less step (module docstring)
PORT_REFERENCE = ("whisper", "whisper-odd", "stablelm-odd")


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_slices_with_q_offset_are_the_rows_of_the_whole(n):
    """Rank r's queries (B, S/n, H, hd) against the whole compact K/V at
    ``q_offset = r * S/n`` give rows r of the whole causal attention and
    the query gradient; the K/V gradients summed over ranks (the
    gather's reduce-scatter) give the whole's."""
    Bq, S, H, KV, hd = 2, 16, 4, 2, 16
    rng = np.random.default_rng(n)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((Bq, S, H, hd), (Bq, S, KV, hd),
                             (Bq, S, KV, hd), (Bq, S, H, hd)))

    def jfwd(q, k, v):
        return flash_attention_ref(q, repeat_kv(k, H), repeat_kv(v, H),
                                   causal=True, q_chunk=4, k_chunk=4)
    jo, vjp = jax.vjp(jfwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(do))
    s = S // n
    dk = torch.zeros(Bq, S, KV, hd)
    dv = torch.zeros(Bq, S, KV, hd)
    for r in range(n):
        tq = torch.from_numpy(q[:, r * s:(r + 1) * s].copy()) \
            .requires_grad_()
        tk = torch.from_numpy(k).requires_grad_()
        tv = torch.from_numpy(v).requires_grad_()
        o = tatt.flash_attention(tq, tk, tv, causal=True, q_offset=r * s)
        o.backward(torch.from_numpy(do[:, r * s:(r + 1) * s].copy()))
        sl = slice(r * s, (r + 1) * s)
        np.testing.assert_allclose(o.detach().numpy(),
                                   np.asarray(jo)[:, sl], **ATTN_TOL)
        np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jdq)[:, sl],
                                   **ATTN_TOL)
        dk += tk.grad
        dv += tv.grad
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), **ATTN_TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), **ATTN_TOL)


def test_a_group_of_one_gathers_nothing():
    sp = tatt.SeqParallel(group=None, rank=0, size=1)
    x = torch.randn(2, 4, 2, 8)
    assert tatt.gather_seq(x, sp) is x
    q = torch.randn(2, 4, 4, 8)
    np.testing.assert_array_equal(
        tatt.sp_flash_attention(q, x, x, sp, causal=True).numpy(),
        tatt.flash_attention(q, x, x, causal=True).numpy())


# ---------------------------------------------------------------------------
# the step on 4 gloo ranks
# ---------------------------------------------------------------------------


def _setup(arch, seed=0):
    jcfg = jax_reduce(jax_get_arch(arch))
    jm = jax_make_model(jcfg, JDist(), dict(OPTS))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(seed))
    ravel, unravel = _flat_io(shapes)
    flat = np.asarray(ravel(jm.init(jax.random.PRNGKey(seed))))
    return jm, unravel, flat


def _batch(arch, S, S_enc, seed=3):
    cfg = reduce_for_smoke(get_arch(arch))
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, size=(B, S + 1))
    b = {"labels": toks[:, 1:]}
    if cfg.family == "encdec":
        b["enc_embeds"] = rng.standard_normal(
            (B, S_enc, cfg.d_model)).astype(np.float32)
        b["tokens"] = toks[:, :-1]
    elif cfg.frontend != "none":
        b["embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = toks[:, :-1]
    if cfg.mrope:
        b["positions"] = vision_positions(B, S, grid=2)
    return b


@pytest.fixture(scope="module")
def setups():
    return {arch: _setup(arch) for arch in {a for a, _, _ in DATA.values()}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, setups):
    """Every case on 4 gloo ranks, once: (each rank's json, rank 0's
    arrays, the batches)."""
    work = tmp_path_factory.mktemp("sp-gloo")
    inputs, batches = {}, {}
    for data, (arch, S, S_enc) in DATA.items():
        cfg = reduce_for_smoke(get_arch(arch))
        b = batches[data] = _batch(arch, S, S_enc)
        for k, v in b.items():
            inputs[f"{data}/b/{k}"] = v
        params = params_from_flat(setups[arch][2], cfg, device="cpu")
        for path, t in iter_leaves(params):
            inputs[f"{data}/p/{path}"] = t.numpy()
    np.savez(work / "inputs.npz", **inputs)
    cases = [dict(id=f"{d}-{m}", kind="sp", arch=DATA[d][0], data=d,
                  mesh=MESHES[m], opts=OPTS) for d, m in CASES]
    (work / "cases.json").write_text(json.dumps(cases))
    spawn_ranks(WORKER, work, WORLD, timeout=600)
    every = [json.loads((work / f"out-{r}.json").read_text())
             for r in range(WORLD)]
    return every, dict(np.load(work / "out-0.npz")), batches


def _port_grads(arch, flat, batch):
    """The port's mesh-less loss gradient (one process, no mesh)."""
    cfg = reduce_for_smoke(get_arch(arch))
    tb = {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
          else torch.from_numpy(v) for k, v in batch.items()}
    _, g = steps.value_and_grad(make_model(cfg, None, OPTS),
                                params_from_flat(flat, cfg, device="cpu"),
                                tb)
    return {path: t.numpy() for path, t in iter_leaves(g)}


@pytest.fixture(scope="module")
def references(ranks, setups):
    """JAX's mesh-less loss of each batch, the gradient the SP step is
    held to within ``MODEL_TOL`` (JAX's, or the port's mesh-less one:
    ``PORT_REFERENCE``), and JAX's gradient."""
    out = {}
    for data, (arch, _, _) in DATA.items():
        jm, unravel, flat = setups[arch]
        batch = {k: jnp.asarray(v) for k, v in ranks[2][data].items()}
        loss, g = jax.jit(jax.value_and_grad(jm.loss))(
            unravel(jnp.asarray(flat)), batch)
        grads = {"/".join(str(p.key) for p in path): np.asarray(v)
                 for path, v in jax.tree_util.tree_flatten_with_path(g)[0]}
        tight = grads
        if data in PORT_REFERENCE:
            tight = _port_grads(arch, flat, ranks[2][data])
        out[data] = (float(loss), tight, grads)
    return out


@pytest.mark.parametrize("data,mesh", CASES,
                         ids=[f"{d}-{m}" for d, m in CASES])
def test_zero3_sp_step_matches_jax(ranks, references, data, mesh):
    every, arrays, _ = ranks
    cid = f"{data}-{mesh}"
    want_loss, want, jax_grads = references[data]
    sp = not data.endswith("-odd")
    for r in range(WORLD):
        assert every[r][cid]["sp"] is sp, r
        np.testing.assert_allclose(every[r][cid]["loss"], want_loss,
                                   **FWD_TOL)
    for path, w in want.items():
        np.testing.assert_allclose(arrays[f"{cid}/{path}"], w, **MODEL_TOL,
                                   err_msg=path)
        np.testing.assert_allclose(arrays[f"{cid}/{path}"], jax_grads[path],
                                   **JAX_GRAD_TOL, err_msg=path)
