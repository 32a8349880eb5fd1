"""Step builders: train / prefill / decode of a ``Model``: the
counterpart of ``repro.distributed.steps``.

``build_*_step`` are the one-card steps: the only way the reference
trains and runs its stub-frontend families (whisper's encoder-decoder,
the vlm family's ``embeds``), which its learner, trainer and serving
engine refuse. The train step takes the model's loss and its gradient
(autograd through the port's kernels: K4 and K4b for attention) and one
``optim.optimizers.apply_updates`` in place.

``jit_*_step`` are the steps built for the model's ``Dist`` (the name is
the reference's; nothing is compiled). Without a mesh they are the
``build_*_step`` above. On a ``torch.distributed`` mesh the reference
lets GSPMD place everything; the port does it by hand, in one form whose
numbers equal the one-card step's:

  * state: params and optimizer state are DTensors with the placements
    of ``param_specs`` / ``opt_state_specs``;
  * batch: each rank takes its rows of the global batch over
    ``dist.batch_axes`` (every rank the whole batch when none divides);
  * forward and backward: the whole tree of weights is all-gathered at
    the start of the step, and the one-card ``value_and_grad`` runs on
    the rank's rows with the port's kernels (K4, K4b on CUDA); a moe
    arch's expert weights, where the ``Dist`` has an expert axis
    ("model"), are gathered over their FSDP axes only, each rank keeping
    its "model" block of experts (the reference's ``P("model", fsdp,
    None)``, moe.py:159-160), and its moe layers run expert-parallel
    (``_expert_parallel``, ``models.moe.ExpertParallel``: an all-to-all
    over "model" for a sequence that divides it, else the decode body's
    local experts and an all-reduce);
  * sequence parallelism (the ``zero3_sp`` policy, ``_seq_parallel``):
    where the reference's ``_use_sp`` / ``_sp_ok`` hold for the rank's
    rows (an attention family, every sequence divisible by the "model"
    size and longer than 1), each rank also takes its slice of the
    sequence over "model", with its global positions (RoPE, M-RoPE and
    the sinusoids start at the slice's offset; the labels are cut beside
    the tokens they follow), and attention gathers the group's K/V
    (``models.attention.sp_flash_attention``: K4/K4b with ``q_offset``,
    the gather's backward a reduce-scatter);
  * gradients (``_constrain_grads``): each is divided by the number of
    shards of the tokens and reduce-scattered onto its leaf's shards over
    the axes that shard them ("model" too under sequence parallelism), or
    all-reduced where the leaf is whole along one, so it is the mean over
    ranks that hold different tokens; ranks that differ only in an axis
    that does not shard the tokens computed the same gradient and take
    their slice of it. An expert leaf's gradient is already its owner's
    whole "model" block (the all-to-all's backward brought every rank's
    tokens to it), so it is not reduced or sliced over "model"; with r
    copies of each expert (fewer experts than "model" ranks) the copies'
    gradients are then averaged (``expert_grad_tie``). The loss is the
    all-reduced mean of the ranks' losses (their token counts are
    equal);
  * update: ``apply_updates`` on the local shards; Adafactor's means
    all-reduce over the mesh dims that shard the dims they reduce
    (``MeshLeaf``).

The "model" axis thus saves memory, not time, but for the experts: no
dense matmul is split over it. A ``Dist`` the port cannot run raises
``UserError``. Every group a step uses is a mesh dim's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed.sharding import (Dist, P, Sharding, axes_of,
                                              contiguous_stride, mesh_axes,
                                              placements, shard_slices)
from repro_torch.errors import UserError
from repro_torch.launch.mesh import wait
from repro_torch.models.attention import SeqParallel
from repro_torch.models.layers import (is_stacked, iter_leaves, leaf_at,
                                       map_leaves)
from repro_torch.models.model import Model, make_model
from repro_torch.models.moe import (ExpertParallel, is_expert_leaf,
                                    replication_factor)
from repro_torch.optim.optimizers import (LeafShards, OptConfig,
                                          apply_updates, init_opt_state,
                                          opt_state_specs)


def default_optimizer(cfg: ArchConfig) -> OptConfig:
    """Adafactor for huge models (factored stats), AdamW otherwise."""
    if cfg.n_params() > 30e9:
        return OptConfig(name="adafactor", lr=1e-3)
    return OptConfig(name="adamw", lr=1e-3)


def expert_grad_tie(cfg: ArchConfig, model: Model):
    """Gradient-tying transform for replicated ('virtual') MoE experts
    (``steps.py:33-64``): where the expert axis outnumbers the experts,
    each expert is replicated r times and its copies receive different
    tokens; averaging the copies' gradients keeps them tied to the
    paper-listed E-expert model. The identity where r is 1 (no mesh, or
    enough experts). Takes a tree of whole gradients."""
    if cfg.moe is None:
        return lambda g: g
    r = replication_factor(cfg.moe, model.dist)
    if r == 1:
        return lambda g: g
    defs = model.param_defs()
    e = cfg.moe.n_experts

    def one(path, g):
        if not is_expert_leaf(path):
            return g
        i, s = leaf_at(defs, path).dims.index("expert"), g.shape
        gr = g.reshape(s[:i] + (e, r) + s[i + 1:])
        return gr.mean(i + 1, keepdim=True).expand(gr.shape).reshape(s)

    def tie(grads):
        return map_leaves(one, grads)
    return tie


def value_and_grad(model: Model, params, batch,
                   sp: Optional[SeqParallel] = None,
                   ep: Optional[ExpertParallel] = None):
    """(loss, grads) of ``model.loss`` at ``params``: the loss a detached
    0-d f32 tensor, the gradients a tree like ``params`` in the params'
    dtypes. The params are not modified and need no ``requires_grad``.
    Layer-stacked weights enter the loss as per-layer lists (as the
    learner's ``_param_leaves`` does), so autograd hands back one
    gradient per layer, stacked once here, where differentiating the
    ``(L, ...)`` tensors would scatter every layer's gradient into a
    full-size zero tensor and add them: L^2 / 2 leaf-sized passes."""
    def live(path, t):
        if is_stacked(path):
            return [t[l].detach().requires_grad_() for l in
                    range(t.shape[0])]
        return t.detach().requires_grad_()
    with torch.enable_grad():
        tree = map_leaves(live, params)
        groups = [v if isinstance(v, list) else [v]
                  for _, v in iter_leaves(tree)]
        loss = model.loss(tree, batch, sp=sp, ep=ep)
        flat = torch.autograd.grad(loss, [t for g in groups for t in g],
                                   allow_unused=True)
    # a leaf the loss does not read (the token table under ``embeds``)
    # gets zeros, as JAX's gradient
    it = iter(torch.zeros_like(t) if g is None else g
              for t, g in zip([t for g in groups for t in g], flat))

    def grad(_path, v):
        if isinstance(v, list):
            return torch.stack([next(it) for _ in v])
        return next(it)
    return loss.detach(), map_leaves(grad, tree)


def split_batch(batch: Dict[str, torch.Tensor], n: int):
    """``n`` micro-batches of ``batch``, each 1/n of its rows. M-RoPE
    ``positions`` (3, B, S) split on their batch dim 1; the reference
    splits every leaf on dim 0 (``steps.py:83-85``), which cuts the
    three position rows instead (see ROADMAP Queue 3)."""
    def split(key, x):
        dim = 1 if key == "positions" and x.dim() == 3 else 0
        if x.shape[dim] % n:
            raise ValueError(f"{key}: batch {x.shape[dim]} is not a "
                             f"multiple of grad_accum {n}")
        return x.chunk(n, dim=dim)
    parts = {k: split(k, v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def loss_and_grads(model: Model, params, batch, grad_accum: int = 1,
                   sp: Optional[SeqParallel] = None,
                   ep: Optional[ExpertParallel] = None):
    """(loss, grads) of ``model.loss``; with ``grad_accum`` > 1 over that
    many micro-batches, their losses and f32 gradients summed and divided
    by ``grad_accum``, as the reference's scan does."""
    if grad_accum == 1:
        return value_and_grad(model, params, batch, sp, ep)
    loss = None
    grads = map_leaves(lambda _p, t: torch.zeros(
        t.shape, dtype=torch.float32, device=t.device), params)
    for mb in split_batch(batch, grad_accum):
        l, g = value_and_grad(model, params, mb, sp, ep)
        loss = l if loss is None else loss + l
        for acc, gi in zip([t for _, t in iter_leaves(grads)],
                           [t for _, t in iter_leaves(g)]):
            acc.add_(gi)
        del g
    loss = loss / grad_accum
    for _, acc in iter_leaves(grads):
        acc.div_(grad_accum)
    return loss, grads


def build_train_step(model: Model, opt_cfg: OptConfig, grad_accum: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    loss). With ``grad_accum`` > 1 the batch is cut into that many
    micro-batches (``loss_and_grads``). Params and state are updated in
    place (and returned)."""
    tie = expert_grad_tie(model.cfg, model)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch, grad_accum)
        grads = tie(grads)
        params, state = apply_updates(opt_cfg, params, grads, opt_state)
        return params, state, loss

    return train_step


def build_prefill_step(model: Model):
    """prefill_step(params, batch, cache=None, slots=None) -> (logits,
    cache) under no_grad: ``Model.prefill``, into a new cache or into
    ``slots`` of a batched one (``ep``: its moe layers expert-parallel,
    as the sharded step runs it on each rank)."""
    @torch.no_grad()
    def prefill_step(params, batch, *, cache=None, slots=None, ep=None):
        return model.prefill(params, batch, cache=cache, slots=slots,
                             ep=ep)
    return prefill_step


def build_decode_step(model: Model):
    """decode_step(params, cache, batch) -> (logits, cache) under
    no_grad; the cache is updated in place."""
    @torch.no_grad()
    def decode_step(params, cache, batch, ep=None):
        return model.decode(params, cache, batch, ep=ep)
    return decode_step


# ---------------------------------------------------------------------------
# Steps built for a Dist (sharded on a mesh)
# ---------------------------------------------------------------------------


def check_dist(model: Model) -> None:
    """Raise ``UserError`` for a ``Dist`` whose sharded step cannot run:
    a moe arch whose experts and "model" axis do not divide one another
    (the reference asserts, ``moe.py:32-40``)."""
    d = model.dist
    if not d.has_mesh or model.cfg.moe is None:
        return
    try:
        replication_factor(model.cfg.moe, d)
    except ValueError as e:
        raise UserError(f"{model.cfg.arch_id!r}: {e}") from None


def _expert_parallel(model: Model, sp: Optional[SeqParallel] = None
                     ) -> Optional[ExpertParallel]:
    """This rank's ``ExpertParallel`` where the model's moe layers run
    expert-parallel (a moe arch, or the hybrid's moe layers, on a mesh
    with an expert axis: "model", even of size 1), else None. ``sp``:
    the step hands the moe layers the rank's slice of the sequence."""
    d = model.dist
    if model.cfg.moe is None or not d.has_mesh or d.expert_axis is None:
        return None
    j = list(mesh_axes(d.mesh)).index("model")
    fsdp = tuple(a for a in (d.fsdp_axes or ()) if a != "model")
    return ExpertParallel(group=(d.mesh, j),
                          rank=_coord(d)["model"], size=d.model_size,
                          r=replication_factor(model.cfg.moe, d), fsdp=fsdp,
                          sliced=sp is not None)


def _ns(dist: Dist, spec_tree):
    """A tree of specs as ``Sharding``s on the mesh (None without one)."""
    if not dist.has_mesh:
        return None
    return map_leaves(lambda _p, s: Sharding(dist.mesh, s), spec_tree)


def _batch_group(dist: Dist):
    """(mesh dims that shard the batch, their number of shards)."""
    names = list(mesh_axes(dist.mesh))
    bt = dist.batch_axes or ()
    dims = [names.index(a) for a in bt]
    return dims, math.prod(dist.axis_size(a) for a in bt)


def _coord(dist: Dist) -> Dict[str, int]:
    return dict(zip(mesh_axes(dist.mesh), dist.mesh.get_coordinate()))


def local_batch(model: Model, shape: ShapeSpec,
                batch: Dict[str, torch.Tensor]):
    """This rank's rows of the global ``batch`` of ``shape`` (every rank
    holds it alike), cut per ``model.input_sharding_specs``: a view of
    each leaf."""
    d = model.dist
    specs = model.input_sharding_specs(shape)
    axes, coord = mesh_axes(d.mesh), _coord(d)
    return {k: x[shard_slices(specs[k], x.shape, axes, coord)]
            for k, x in batch.items()}


def _seq_lens(model: Model, rows: Dict[str, torch.Tensor]):
    """The sequence lengths of a batch: the frames' and the tokens'
    (encdec), else the tokens' or embeds'."""
    if model.encdec:
        return (rows["enc_embeds"].shape[1], rows["tokens"].shape[1])
    x = rows["embeds"] if "embeds" in rows else rows["tokens"]
    return (x.shape[1],)


def _seq_parallel(model: Model, rows) -> Optional[SeqParallel]:
    """This rank's ``SeqParallel`` over "model" where the step runs
    sequence-parallel on ``rows`` (the reference's ``_use_sp`` /
    ``_sp_ok``: the ``zero3_sp`` policy, a dense, moe, vlm or encdec
    arch, every sequence divisible by the "model" size and longer than
    1), else None."""
    from repro_torch.models.transformer import SP_FAMILIES
    d = model.dist
    if not d.seq_parallel or model.cfg.family not in SP_FAMILIES + (
            "encdec",):
        return None
    n = d.model_size
    if any(s % n or s <= 1 for s in _seq_lens(model, rows)):
        return None
    j = list(mesh_axes(d.mesh)).index("model")
    return SeqParallel(group=(d.mesh, j), rank=_coord(d)["model"], size=n)


def seq_slice(model: Model, rows: Dict[str, torch.Tensor],
              sp: SeqParallel):
    """This rank's slice of the sequence of ``rows`` (views), with the
    slice's global ``positions`` ((B, S) or M-RoPE's (3, B, S): the
    batch's own, else 0..S-1 as the loss would make them), so RoPE does
    not restart at 0. The labels are cut beside their tokens: each
    position's next-token target comes from the whole batch."""
    def cut(x, dim):
        n = x.shape[dim] // sp.size
        return x.narrow(dim, sp.rank * n, n)
    out = {}
    for k, x in rows.items():
        out[k] = cut(x, 2 if k == "positions" and x.dim() == 3 else 1)
    if not model.encdec and "positions" not in rows:
        x = rows["embeds"] if "embeds" in rows else rows["tokens"]
        B, S = x.shape[:2]
        pos = torch.arange(S, device=x.device).expand(B, S)
        if model.cfg.mrope:
            pos = pos.expand(3, B, S)
        out["positions"] = cut(pos, pos.dim() - 1)
    return out


def _all_reduce(t, mesh, dims):
    """``t`` summed over the ranks of each mesh dim in ``dims`` in turn
    (functional collectives, which ``analysis.roofline`` counts)."""
    import torch.distributed._functional_collectives as funcol
    for j in dims:
        if mesh.size(j) > 1:
            t = wait(funcol.all_reduce(t, "sum", (mesh, j)))
    return t


def _relayout(x, mesh, src: P, dst: P, shape):
    """The local part of a tensor of ``shape`` laid out as ``dst``, from
    its local part laid out as ``src`` (a slice where ``dst`` shards more;
    an all-gather where it shards less)."""
    if tuple(src) == tuple(dst):
        return x
    from torch.distributed.tensor import DTensor
    names = tuple(mesh_axes(mesh))
    dt = DTensor.from_local(x, mesh, placements(src, names),
                            run_check=False, shape=torch.Size(shape),
                            stride=contiguous_stride(shape))
    return dt.redistribute(mesh, placements(dst, names)).to_local()


class MeshLeaf(LeafShards):
    """A leaf's local shard on a mesh, for Adafactor's reductions: the
    mesh dims that shard each param dim, and the layouts of the column
    stats at the shard's columns (the param's spec without dim -2) and of
    the ``vc`` state (its own spec, which may shard its last dim over
    more axes: an axis freed by the dropped dim)."""

    def __init__(self, shape, mesh, spec: P, vc_spec: P):
        self.shape = tuple(shape)
        self.mesh = mesh
        names = list(mesh_axes(mesh))
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        self.by_dim = [[names.index(a) for a in axes_of(ax)]
                       for ax in spec]
        self.cols = P(*spec[:-2], spec[-1]) if len(shape) >= 2 else None
        self.vc_spec = vc_spec
        self.vc_shape = tuple(shape[:-2]) + tuple(shape[-1:])

    def _sum(self, t, pdims):
        """``t``, a partial sum over the local part of param dims
        ``pdims``, summed over the ranks that hold their other parts."""
        mdims = sorted({j for i in pdims for j in self.by_dim[i]})
        return _all_reduce(t, self.mesh, mdims)

    def mean(self, t, dim, pdim):
        return self._sum(torch.sum(t, dim=dim), (pdim,)) / self.shape[pdim]

    def mean_all(self, t):
        return self._sum(torch.sum(t), range(len(self.shape))) \
            / math.prod(self.shape)

    def vc_in(self, vc):
        return _relayout(vc, self.mesh, self.vc_spec, self.cols,
                         self.vc_shape)

    def vc_out(self, vc):
        return _relayout(vc, self.mesh, self.cols, self.vc_spec,
                         self.vc_shape)


def _local(tree):
    """The local tensors of a tree of DTensors (views: writing them
    writes the DTensors)."""
    from torch.distributed.tensor import DTensor
    return map_leaves(lambda _p, x: x.to_local()
                      if isinstance(x, DTensor) else x, tree)


def _axes_of(spec, i) -> tuple:
    """The axis names of tensor dim ``i`` of ``spec``."""
    return axes_of(tuple(spec)[i] if i < len(spec) else None)


def _grad_plan(spec, ndim: int, names, batch):
    """The order in which a whole-leaf gradient becomes its shard: per
    tensor dim, the axes before its first batch axis are sliced first
    (no collective: ranks that differ only there hold the same rows),
    then each batch axis in mesh order reduce-scatters (the leaf is
    sharded over it) or all-reduces (it is whole along it), then the
    remaining axes are sliced. Each step is (op, tensor dim or None,
    mesh dim), op one of "slice", "rs", "ar"; a dim sharded over several
    axes is cut major axis first, so the blocks are JAX's."""
    head, tail, where = [], [], {}
    for i in range(ndim):
        axes = _axes_of(spec, i)
        seen_batch = False
        for a in axes:
            where[a] = i
            if a in batch:
                seen_batch = True
            elif seen_batch:
                tail.append(("slice", i, names.index(a)))
            else:
                head.append(("slice", i, names.index(a)))
    mid = [("rs" if a in where else "ar", where.get(a), names.index(a))
           for a in names if a in batch]
    return head + mid + tail


def _token_group(d: Dist, seq: bool):
    """(mesh dims that shard the step's tokens, their number of shards):
    the batch axes, and "model" under sequence parallelism."""
    dims, n = _batch_group(d)
    if seq:
        dims = dims + [list(mesh_axes(d.mesh)).index("model")]
        n *= d.model_size
    return dims, n


def _constrain_grads(model: Model, grads, seq: bool = False,
                     ep: Optional[ExpertParallel] = None):
    """Each whole-leaf gradient of this rank's tokens -> the local shard
    of the mean gradient over the token shards, on its leaf's spec:
    divided by the number of token shards, sliced along the axes that do
    not shard the tokens, reduce-scattered (or all-reduced, where the
    leaf is whole along it) over those that do (``_grad_plan``): the
    batch axes, and "model" when ``seq`` (the step ran
    sequence-parallel: ranks that differ only in "model" hold partial
    gradients of different tokens, which sum). Under ``ep`` an expert
    leaf's gradient is already this rank's "model" block, summed over
    the group's tokens: nothing is done to it over "model"."""
    import torch.distributed._functional_collectives as funcol
    d = model.dist
    mesh = d.mesh
    names = list(mesh_axes(mesh))
    batch = set(d.batch_axes or ()) | ({"model"} if seq else set())
    _, n_b = _token_group(d, seq)
    coord = mesh.get_coordinate()
    specs = model.param_specs()
    j_model = names.index("model") if "model" in names else None

    def one(path, g):
        if n_b > 1:
            g = g / n_b
        plan = _grad_plan(leaf_at(specs, path), g.dim(), names, batch)
        if ep is not None and is_expert_leaf(path):
            plan = [st for st in plan if st[2] != j_model]
        for op, i, j in plan:
            n = mesh.size(j)
            if op == "slice":
                g = g.chunk(n, dim=i)[coord[j]]
            elif n == 1:
                continue
            elif op == "rs":
                rs = getattr(funcol, "reduce_scatter_single",
                             funcol.reduce_scatter_tensor)
                g = wait(rs(g.contiguous(), "sum", i, (mesh, j)))
            else:
                g = wait(funcol.all_reduce(g, "sum", (mesh, j)))
        return g.contiguous()
    return map_leaves(one, grads)


def _gatherleaf_at(x, spec, mesh, only=None):
    """The whole leaf from this rank's shard ``x`` laid out as ``spec``:
    per tensor dim, an all-gather over each of its axes, minor first;
    with ``only``, over those of its axes alone (the rank keeps its block
    along the others)."""
    import torch.distributed._functional_collectives as funcol
    names = list(mesh_axes(mesh))
    for i in range(x.dim()):
        for a in reversed(_axes_of(spec, i)):
            if only is not None and a not in only:
                continue
            j = names.index(a)
            if mesh.size(j) > 1:
                ag = getattr(funcol, "all_gather_single",
                             funcol.all_gather_tensor)
                x = wait(ag(x.contiguous(), i, (mesh, j)))
    return x


def _gather_tree(params, pspecs, mesh, ep: Optional[ExpertParallel] = None):
    """The whole weights from this rank's shards (plain tensors laid out
    per ``pspecs``): ``_gatherleaf_at`` of every leaf; under ``ep`` an
    expert leaf is gathered over its FSDP axes only and keeps its
    "model" block of experts (the reference's ``_gather_fsdp``)."""
    return map_leaves(lambda path, x: _gatherleaf_at(
        x, leaf_at(pspecs, path), mesh,
        ep.fsdp if ep is not None and is_expert_leaf(path) else None),
        params)


def _tie_sharded(model: Model, grads, ep: Optional[ExpertParallel]):
    """``expert_grad_tie`` on this rank's gradient shards: with r > 1
    copies of each expert (one copy per "model" rank), each expert leaf's
    shard is all-gathered over "model" on its expert dim, the whole tied
    by ``expert_grad_tie``, and the rank's block kept."""
    if ep is None or ep.r == 1:
        return grads
    import torch.distributed._functional_collectives as funcol
    ag = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
    defs = model.param_defs()

    def dim(path):
        return leaf_at(defs, path).dims.index("expert")
    whole = map_leaves(lambda path, g: wait(ag(
        g.contiguous(), dim(path), ep.group)) if is_expert_leaf(path)
        else g, grads)
    tied = expert_grad_tie(model.cfg, model)(whole)
    return map_leaves(lambda path, g: g.chunk(ep.size, dim(path))[
        ep.rank].contiguous() if is_expert_leaf(path) else g, tied)


def local_loss_and_grads(model: Model, shape: ShapeSpec,
                         grad_accum: int = 1):
    """fn(params, batch) -> (global mean loss, gradients): the forward and
    backward of the sharded step on this rank's local shards of the
    params (plain tensors laid out per ``param_specs``) and the global
    ``batch`` of ``shape``; each gradient this rank's shard of the mean
    gradient (``_constrain_grads``). ``fn.seq_parallel(batch)`` says
    whether the step runs sequence-parallel on ``batch``."""
    d = model.dist
    mesh = d.mesh
    local_model = make_model(model.cfg, d.local(), model.opts)
    pspecs = model.param_specs()

    def rows_of(batch):
        rows = local_batch(model, shape, batch)
        sp = _seq_parallel(model, rows)
        return (rows if sp is None else seq_slice(model, rows, sp)), sp

    def fn(params, batch):
        rows, sp = rows_of(batch)
        ep = _expert_parallel(model, sp)
        full = _gather_tree(params, pspecs, mesh, ep)
        loss, grads = loss_and_grads(local_model, full, rows, grad_accum,
                                     sp, ep)
        del full
        grads = _tie_sharded(model, _constrain_grads(
            model, grads, sp is not None, ep), ep)
        dims, n = _token_group(d, sp is not None)
        if n > 1:
            loss = _all_reduce(loss, mesh, dims) / n
        return loss, grads

    fn.seq_parallel = lambda batch: rows_of(batch)[1] is not None
    return fn


def local_train_step(model: Model, opt_cfg: OptConfig, shape: ShapeSpec,
                     grad_accum: int = 1):
    """The sharded train step on this rank's local shards:
    step(params, state, batch) -> (new step counter, global mean loss),
    params and state (plain tensors laid out per ``param_specs`` /
    ``opt_state_specs``) updated in place, ``batch`` the global batch of
    ``shape``. On meta tensors it moves no data, its collectives
    included, so ``analysis.roofline.count_program`` of it on
    ``abstract_local_inputs`` is one step's cost on this rank, the
    collective term counted from the very calls the step issues."""
    d = model.dist
    mesh = d.mesh
    defs = model.param_defs()
    pspecs = model.param_specs()
    vc_specs = (opt_state_specs(opt_cfg, defs, d)["vc"]
                if opt_cfg.name == "adafactor" else pspecs)
    shards = map_leaves(
        lambda path, dd: MeshLeaf(dd.shape, mesh, leaf_at(pspecs, path),
                                  leaf_at(vc_specs, path)), defs)
    loss_grads = local_loss_and_grads(model, shape, grad_accum)

    def step(params, state, batch):
        loss, grads = loss_grads(params, batch)
        _, new = apply_updates(opt_cfg, params, grads, state, shards=shards)
        return new["step"], loss

    return step


def abstract_local_inputs(model: Model, shape: ShapeSpec,
                          opt_cfg: Optional[OptConfig] = None):
    """This rank's arguments of the step of ``shape.kind`` on
    ``model.dist`` as empty meta tensors: for train those of
    ``local_train_step`` (params, state, batch: each param and state leaf
    this rank's shard of it, the batch global); for prefill (params,
    batch) and decode (params, cache, batch) those of
    ``jit_prefill_step`` / ``jit_decode_step``, the params and the cache
    DTensors of meta local shards laid out per ``param_specs`` and
    ``cache_sharding_specs``. Without a mesh, ``abstract_inputs``."""
    d = model.dist
    if not d.has_mesh:
        return abstract_inputs(model, shape, opt_cfg)
    axes, coord = mesh_axes(d.mesh), _coord(d)
    args = abstract_inputs(model, shape, opt_cfg)

    def local(spec, t):
        sl = shard_slices(spec, t.shape, axes, coord)
        return torch.empty([s.stop - s.start for s in sl], dtype=t.dtype,
                           device="meta")

    def cut(specs):
        return lambda path, t: local(leaf_at(specs, path), t)
    if shape.kind == "train":
        aps, state, batch = args
        oc = opt_cfg or default_optimizer(model.cfg)
        ospecs = opt_state_specs(oc, model.param_defs(), d)
        state = {k: v if k == "step" else map_leaves(cut(ospecs[k]), v)
                 for k, v in state.items()}
        return map_leaves(cut(model.param_specs()), aps), state, batch

    def dtensor(spec, t):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(local(spec, t), d.mesh,
                                  placements(spec, tuple(axes)),
                                  run_check=False, shape=t.shape,
                                  stride=contiguous_stride(t.shape))
    pspecs = model.param_specs()
    params = map_leaves(lambda path, t: dtensor(leaf_at(pspecs, path), t),
                        args[0])
    if shape.kind == "prefill":
        return params, args[1]
    cspecs = model.cache_sharding_specs(shape.global_batch)
    cache = {k: dtensor(cspecs[k], t) for k, t in args[1].items()}
    return params, cache, args[2]


def _sharded_train_step(model: Model, opt_cfg: OptConfig,
                        shape: ShapeSpec, grad_accum: int = 1):
    """``local_train_step`` on DTensor params and state."""
    mesh = model.dist.mesh
    local = local_train_step(model, opt_cfg, shape, grad_accum)

    def train_step(params, opt_state, batch):
        from torch.distributed.tensor import DTensor, Replicate
        step, loss = local(_local(params), _local(opt_state), batch)
        if isinstance(opt_state["step"], DTensor):
            step = DTensor.from_local(step, mesh,
                                      (Replicate(),) * mesh.ndim,
                                      run_check=False)
        return params, {**opt_state, "step": step}, loss

    return train_step


def jit_train_step(model: Model, opt_cfg: OptConfig, shape: ShapeSpec,
                   grad_accum: int = 1):
    """The train step for ``model.dist``: ``build_train_step`` without a
    mesh; on one, the sharded step of the module docstring, which takes
    params and state as DTensors (``param_shardings``,
    ``opt_state_specs``) and the global batch of ``shape``, updates them
    in place and returns (params, state, the global mean loss)."""
    if not model.dist.has_mesh:
        return build_train_step(model, opt_cfg, grad_accum)
    check_dist(model)
    return _sharded_train_step(model, opt_cfg, shape, grad_accum)


def _wrap(x, mesh, spec: P):
    """A DTensor from this rank's local part laid out as ``spec``."""
    from torch.distributed.tensor import DTensor
    names = tuple(mesh_axes(mesh))
    shape = list(x.shape)
    for i, ax in enumerate(tuple(spec)):
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            shape[i] *= mesh.size(names.index(a))
    return DTensor.from_local(x, mesh, placements(spec, names),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def _batch_only(spec: P, bt) -> P:
    """A cache spec with only its batch entry kept."""
    bt = P(bt)[0]
    return P(*[ax if ax == bt else None for ax in tuple(spec)])


def jit_prefill_step(model: Model, shape: ShapeSpec):
    """The prefill step for ``model.dist``: ``build_prefill_step``
    without a mesh. On one: the weights gathered, each rank's rows of the
    batch prefilled, the logits returned over the batch axes and the
    cache laid out per ``cache_sharding_specs(B)``: a new cache as long
    as the prompt, or ``cache`` (DTensors in that layout, e.g. a longer
    one for decoding) written for every row. A batch the data axes do
    not divide is prefilled whole on every rank, and its cache takes its
    sequence dim over every axis, as the reference's."""
    if not model.dist.has_mesh:
        return build_prefill_step(model)
    check_dist(model)
    d = model.dist
    local = build_prefill_step(make_model(model.cfg, d.local(), model.opts))
    cspecs = model.cache_sharding_specs(shape.global_batch)
    pspecs = model.param_specs()

    def prefill_step(params, batch, *, cache=None):
        ep = _expert_parallel(model)
        full = _gather_tree(_local(params), pspecs, d.mesh, ep)
        rows = local_batch(model, shape, batch)
        if cache is None:
            logits, mine = local(full, rows, ep=ep)
        else:
            mine = _cache_rows(model, cache, cspecs)
            n = next(iter(rows.values())).shape[0]
            slots = torch.arange(n, device=next(iter(mine.values())).device)
            logits, mine = local(full, rows, cache=mine, slots=slots, ep=ep)
        return _relay(model, logits, mine, cspecs)
    return prefill_step


def _cache_rows(model: Model, cache, cspecs):
    """This rank's slots of a cache laid out per ``cspecs``, whole along
    every other dim."""
    d = model.dist
    bt = d.batch_axes
    return {k: v.redistribute(d.mesh, Sharding(
        d.mesh, _batch_only(cspecs[k], bt)).placements).to_local()
        for k, v in cache.items()}


def _relay(model: Model, logits, cache, cspecs):
    """(logits, cache) of this rank's slots as DTensors: the logits over
    the batch axes, the cache per ``cspecs``."""
    d = model.dist
    bt = d.batch_axes
    out = {k: _wrap(v, d.mesh, _batch_only(cspecs[k], bt))
           .redistribute(d.mesh, Sharding(d.mesh, cspecs[k]).placements)
           for k, v in cache.items()}
    return _wrap(logits, d.mesh, P(bt, None, None)), out


def jit_decode_step(model: Model, shape: ShapeSpec):
    """The decode step for ``model.dist``: ``build_decode_step`` without
    a mesh. On one: the weights gathered, the cache (DTensors per
    ``cache_sharding_specs(B)``) gathered to its batch shards, each
    rank's slots decoded, and the cache laid out again. A batch the data
    axes do not divide (``batch_axes`` empty) has every slot on every
    rank: the cache, its sequence dim over every axis, is gathered whole,
    decoded, and sliced again."""
    if not model.dist.has_mesh:
        return build_decode_step(model)
    check_dist(model)
    d = model.dist
    local = build_decode_step(make_model(model.cfg, d.local(), model.opts))
    cspecs = model.cache_sharding_specs(shape.global_batch)
    pspecs = model.param_specs()
    one = dataclasses.replace(shape, kind="decode")

    def decode_step(params, cache, batch):
        ep = _expert_parallel(model)
        full = _gather_tree(_local(params), pspecs, d.mesh, ep)
        logits, mine = local(full, _cache_rows(model, cache, cspecs),
                             local_batch(model, one, batch), ep=ep)
        return _relay(model, logits, mine, cspecs)
    return decode_step


def abstract_inputs(model: Model, shape: ShapeSpec,
                    opt_cfg: Optional[OptConfig] = None):
    """The arguments of the step of ``shape.kind`` as empty tensors on the
    meta device (the reference's ShapeDtypeStructs): (params, opt_state,
    batch) for train, (params, batch) for prefill, (params, cache, batch)
    for decode against a ``shape.seq_len`` cache (encdec: the cross
    cache as long, as the reference's ``cache_specs``)."""
    aps = model.abstract_params()

    def meta(specs):
        return {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
                for k, s in specs.items()}
    batch = meta(model.input_specs(shape))
    if shape.kind == "train":
        oc = opt_cfg or default_optimizer(model.cfg)
        return (aps, init_opt_state(oc, aps), batch)
    if shape.kind == "prefill":
        return (aps, batch)
    return (aps, meta(model.cache_specs(shape.global_batch, shape.seq_len)),
            batch)
