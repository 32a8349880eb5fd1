"""Distribution context and sharding policy: the counterpart of
``repro/distributed/sharding.py``.

``Dist`` carries the mesh and the policy knobs through model code. With
``mesh=None`` (one card, the smoke tests) every constraint is a no-op.
The mesh is a ``torch.distributed`` ``DeviceMesh`` (``launch/mesh.py``)
or any object with ``axis_names`` and a ``shape`` mapping, the
reference's duck type: the spec engine reads only axis names and sizes.

Axes (fixed by the assignment):
  single-pod: (16, 16)        ("data", "model")
  multi-pod:  (2, 16, 16)     ("pod", "data", "model")

Policies:
  dp_only  — full model replica per data shard (small archs only).
  tp_dp    — "model"-sharded layout, replicated over data.
  fsdp_tp  — params/optimizer additionally sharded over the data (and
             optionally pod) axis: the paper's PS partition scheme as a
             resident layout (ZeRO lineage).
  zero3_sp — "model" carries no TP and joins the FSDP axes; attention
             runs sequence-parallel over it (``distributed.steps``).

A spec is a ``PartitionSpec`` of the port's own: one entry per tensor
dim, each ``None``, an axis name or a tuple of names, singleton tuples
normalised to the name as jax 0.9's ``P`` does. On a ``DeviceMesh`` a
spec becomes DTensor placements (``placements``): each mesh dim gets
``Shard(tensor_dim)`` or ``Replicate()``. Where one tensor dim takes
several axes, the first axis of the tuple is the major one, as in JAX;
``shard_slices`` is the slice each mesh coordinate holds, as a pure
function of the spec, the shape and the coordinate.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, NamedTuple, Optional, Sequence, Tuple


class PartitionSpec(tuple):
    """Per tensor dim: ``None``, an axis name, or a tuple of names.
    ``PartitionSpec(("data",))`` equals ``PartitionSpec("data")`` and an
    empty tuple is ``None``, as jax 0.9's ``P``."""

    def __new__(cls, *parts):
        norm = []
        for p in parts:
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                p = None if not p else (p[0] if len(p) == 1 else p)
            norm.append(p)
        return super().__new__(cls, norm)

    def __repr__(self):
        return "P(" + ", ".join(repr(p) for p in self) + ")"


P = PartitionSpec


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh-dim order, of a ``DeviceMesh`` or of the
    duck-typed mesh (``axis_names`` and a ``shape`` mapping)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def axes_of(ax) -> Tuple[str, ...]:
    """The axis names of one spec entry: () for None."""
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


@dataclass(frozen=True)
class Dist:
    mesh: Optional[object] = None
    policy: str = "fsdp_tp"          # dp_only | tp_dp | fsdp_tp | zero3_sp
    fsdp_over_pod: bool = True       # include "pod" in the FSDP axis set
    # Resolved batch axes for the current step's global batch (() when
    # the batch dim is not divisible by the data axes, e.g. B=1).
    batch_axes_resolved: Optional[Tuple[str, ...]] = None

    # ---- axis helpers -----------------------------------------------------
    @property
    def has_mesh(self) -> bool:
        return self.mesh is not None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(mesh_axes(self.mesh)) if self.mesh is not None else ()

    @property
    def has_pod(self) -> bool:
        return "pod" in self.axis_names

    @property
    def batch_axes(self):
        if not self.has_mesh:
            return None
        if self.batch_axes_resolved is not None:
            return self.batch_axes_resolved or None
        return ("pod", "data") if self.has_pod else ("data",)

    def resolve_batch(self, global_batch: int) -> "Dist":
        """Pick the largest batch-sharding axis set that divides B."""
        if not self.has_mesh:
            return self
        cands = []
        if self.has_pod:
            cands.append(("pod", "data"))
        cands.append(("data",))
        for bt in cands:
            n = 1
            for a in bt:
                n *= self.axis_size(a)
            if global_batch % n == 0:
                return replace(self, batch_axes_resolved=bt)
        return replace(self, batch_axes_resolved=())

    @property
    def fsdp_axes(self):
        """Axes over which params/opt-state are sharded (beyond TP)."""
        if not self.has_mesh or self.policy in ("dp_only", "tp_dp"):
            return None
        base = ("pod", "data") if (self.has_pod and self.fsdp_over_pod) \
            else ("data",)
        if self.policy == "zero3_sp":
            # model axis carries no TP: fold it into the FSDP axis set
            return base + ("model",)
        return base

    @property
    def tp_axis(self):
        if not self.has_mesh or self.policy in ("dp_only", "zero3_sp"):
            return None
        return "model"

    @property
    def expert_axis(self):
        """MoE expert-parallel axis (kept even in zero3_sp)."""
        if not self.has_mesh or self.policy == "dp_only":
            return None
        return "model"

    @property
    def seq_parallel(self) -> bool:
        """zero3_sp: activations sequence-sharded over "model"."""
        return self.policy == "zero3_sp" and self.has_mesh

    def axis_size(self, name: str) -> int:
        if self.mesh is None:
            return 1
        return mesh_axes(self.mesh)[name]

    @property
    def data_size(self) -> int:
        n = 1
        if self.has_mesh:
            n = self.axis_size("data")
            if self.has_pod:
                n *= self.axis_size("pod")
        return n

    @property
    def model_size(self) -> int:
        return self.axis_size("model") if self.has_mesh else 1

    # ---- constraint helpers ----------------------------------------------
    def constrain(self, x, spec: PartitionSpec):
        """``x`` redistributed to ``spec``'s placements on the mesh (a
        plain tensor counts as replicated); ``x`` itself without a mesh."""
        if self.mesh is None:
            return x
        return redistribute(x, self.sharding(spec))

    def sharding(self, spec: PartitionSpec) -> Optional["Sharding"]:
        if self.mesh is None:
            return None
        return Sharding(self.mesh, spec)

    # activations: (B, S, D)
    def act_spec(self, seq_over_model: bool = False) -> PartitionSpec:
        if not self.has_mesh:
            return P()
        return P(self.batch_axes, "model" if seq_over_model else None, None)

    def local(self) -> "Dist":
        """Dist with no mesh."""
        return replace(self, mesh=None)


# ---------------------------------------------------------------------------
# Parameter sharding rules (the reference's, verbatim)
# ---------------------------------------------------------------------------
# Logical dim names of ParamDef.dims:
#   layers  — layer-stacked leading dim (never sharded)
#   vocab   — vocabulary dim -> TP axis
#   embed   — d_model dim -> FSDP axes
#   heads   — attention heads -> TP axis
#   ff      — mlp hidden -> TP axis
#   expert  — MoE expert dim -> "model" (expert parallelism)
#   eff     — per-expert hidden -> FSDP axes
#   dinner  — mamba inner width -> FSDP axes


def _dim_axis(dist: Dist, name: str):
    if name == "expert":
        return dist.expert_axis
    if name == "vocab":
        return "model" if (dist.has_mesh and dist.policy != "dp_only") \
            else None
    if name in ("heads", "ff"):
        return dist.tp_axis
    if name in ("embed", "eff", "dinner"):
        return dist.fsdp_axes
    return None


def _axes_size(dist: Dist, ax) -> int:
    n = 1
    for a in axes_of(ax):
        n *= dist.axis_size(a)
    return n


def spec_for(dist: Dist, dim_names: Tuple[str, ...],
             shape: Optional[Tuple[int, ...]] = None) -> PartitionSpec:
    """PartitionSpec for a param. Dims whose size the candidate axis set
    does not divide fall back to one axis that does, largest first, or to
    replication (e.g. whisper's 20 heads or a vocab 16 does not divide);
    an axis taken by an earlier dim of the param is not used again."""
    if not dist.has_mesh:
        return P()
    used: set = set()
    parts = []
    for i, n in enumerate(dim_names):
        ax = _dim_axis(dist, n)
        if ax is not None:
            names = tuple(a for a in axes_of(ax) if a not in used)
            ax = None if not names else (
                names[0] if len(names) == 1 else names)
        ok = ax is not None
        if ok and shape is not None:
            ok = shape[i] % _axes_size(dist, ax) == 0
            if not ok and not isinstance(ax, str):
                for cand in sorted(ax, key=lambda a: -dist.axis_size(a)):
                    if shape[i] % dist.axis_size(cand) == 0:
                        ax = cand
                        ok = True
                        break
        if not ok:
            parts.append(None)
        else:
            used.update(axes_of(ax))
            parts.append(ax)
    return P(*parts)


def tree_specs(dist: Dist, defs) -> Dict:
    """A tree of ParamDefs mapped to a tree of PartitionSpecs."""
    from repro_torch.models.layers import map_leaves  # no cycle at load
    return map_leaves(lambda _p, d: spec_for(dist, d.dims, d.shape), defs)


def tree_shardings(dist: Dist, defs):
    """``tree_specs`` as ``Sharding``s on the mesh (the specs without
    one, as the reference returns them)."""
    from repro_torch.models.layers import map_leaves
    specs = tree_specs(dist, defs)
    if not dist.has_mesh:
        return specs
    return map_leaves(lambda _p, s: Sharding(dist.mesh, s), specs)


def dim_shardable(dist: Dist, size: int, name: str = "vocab") -> bool:
    ax = _dim_axis(dist, name)
    return (dist.has_mesh and ax is not None
            and size % _axes_size(dist, ax) == 0)


# ---------------------------------------------------------------------------
# Specs on a DeviceMesh
# ---------------------------------------------------------------------------


def shard_slices(spec: Sequence, shape: Sequence[int],
                 axes: Dict[str, int],
                 coord: Dict[str, int]) -> Tuple[slice, ...]:
    """The index range of every tensor dim that the mesh coordinate
    ``coord`` ({axis: index}) holds of a tensor of ``shape`` laid out as
    ``spec`` on a mesh of ``axes`` ({axis: size}). A dim sharded over
    several axes is cut into their product of equal blocks, the first
    axis of the tuple the major one (JAX's order); an unsharded dim is
    whole. Raises ``ValueError`` where the axes do not divide the dim."""
    out = []
    for i, n in enumerate(shape):
        names = axes_of(spec[i]) if i < len(spec) else ()
        idx, k = 0, 1
        for a in names:
            idx = idx * axes[a] + coord[a]
            k *= axes[a]
        if n % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"into {k} shards over {names}")
        step = n // k
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def placements(spec: Sequence, axis_names: Sequence[str]):
    """DTensor placements of ``spec``: per mesh dim, ``Shard(i)`` where
    tensor dim ``i`` takes the axis, else ``Replicate()``. DTensor nests
    shards of one tensor dim in mesh-dim order, so a tuple of axes must
    list them in that order for its layout to be JAX's."""
    from torch.distributed.tensor import Replicate, Shard
    where: Dict[str, int] = {}
    for i, ax in enumerate(spec):
        names = axes_of(ax)
        order = [axis_names.index(a) for a in names]
        if order != sorted(order):
            raise ValueError(f"spec {spec!r}: axes {names} are not in the "
                             f"mesh's order {tuple(axis_names)}")
        for a in names:
            where[a] = i
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in axis_names)


class Sharding(NamedTuple):
    """A spec on a mesh: the counterpart of ``NamedSharding``."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self):
        return placements(self.spec, tuple(mesh_axes(self.mesh)))

    def coordinate(self) -> Dict[str, int]:
        """This rank's coordinate on the mesh."""
        return dict(zip(mesh_axes(self.mesh), self.mesh.get_coordinate()))

    def local_slices(self, shape) -> Tuple[slice, ...]:
        return shard_slices(self.spec, shape, mesh_axes(self.mesh),
                            self.coordinate())


def distribute(full, sharding: Sharding):
    """A DTensor holding this rank's slice (a contiguous copy) of the
    whole tensor ``full``, which every rank holds alike: no collective."""
    from torch.distributed.tensor import DTensor
    local = full[sharding.local_slices(full.shape)].contiguous()
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=full.shape,
                              stride=contiguous_stride(full.shape))


def redistribute(x, sharding: Sharding):
    """``x`` (a DTensor, or a plain tensor that every rank holds alike)
    laid out as ``sharding``."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return distribute(x, sharding)
    return x.redistribute(sharding.mesh, sharding.placements)


def gather(x):
    """The whole tensor of a DTensor on every rank (all-gathers over the
    mesh dims that shard it); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))

