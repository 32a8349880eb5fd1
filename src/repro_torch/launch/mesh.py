"""Mesh construction: the counterpart of ``repro/launch/mesh.py``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with the reference's
axis names, ``("data", "model")`` or ``("pod", "data", "model")``, over
the first ``prod(shape)`` ranks of the default process group in
row-major order (rank ``r`` sits at the coordinate
``numpy.unravel_index(r, shape)``), as the reference's ``make_mesh``
takes the first devices. Functions only: importing this module touches
no process group, as the reference's touches no device state. The
caller starts the process group (``torch.distributed.init_process_group``
with NCCL on the card, gloo on the CPU) before it builds a mesh.

Every rank of the default group calls ``make_mesh`` (it makes groups,
which is collective). A rank past ``prod(shape)`` gets a mesh with no
coordinate (``mesh.get_coordinate()`` is None): it holds nothing of a
tensor laid out on it and joins none of its collectives. Every mesh
made here carries two attributes of its own: ``side_group``, a gloo
group over the same ranks on which the trainer agrees whether a step
failed and waits for a checkpoint (never on the step's own groups;
None on a fake process group), and ``wait_s``, the default group's
timeout in seconds, which every group made here is given, so each wait
on the mesh is bounded by the one timeout set where the process group
starts.

The mesh's device type follows the port's rule: ``cuda`` unless the
caller asks for ``device="cpu"``. ``MeshShape`` names axis sizes with no
ranks behind them: what a service process that starts the ranks (the
pjit backend, ``runtime/spmd.py``) hands ``Dist``.
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.device import DeviceLike, resolve_device

PRODUCTION_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


class MeshShape:
    """A mesh's axis names and sizes only (the duck type that
    ``sharding.mesh_axes`` reads): ``MeshShape(data=2, model=2)``."""

    def __init__(self, **sizes: int):
        self.shape: Dict[str, int] = {k: int(v) for k, v in sizes.items()}
        self.axis_names = tuple(self.shape)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """The assignment's production mesh: 16x16 per pod, 2 pods
    multi-pod (256 or 512 ranks)."""
    if multi_pod:
        return _sub_mesh(MULTI_POD_SHAPE, ("pod", "data", "model"), device)
    return _sub_mesh(PRODUCTION_SHAPE, ("data", "model"), device)


def wait(t):
    """A functional collective's result once it has arrived (an
    ``AsyncCollectiveTensor``, or a plain tensor under a dispatch mode)."""
    import torch.distributed._functional_collectives as funcol
    return t.wait() if hasattr(t, "wait") else funcol.wait_tensor(t)


def _default_timeout():
    """The default group's timeout (a ``timedelta``), or None where its
    backend does not say."""
    import torch
    from torch.distributed import distributed_c10d as c10d
    g = c10d._get_default_group()
    for dev in g._device_types:
        opts = getattr(g._get_backend(torch.device(dev)), "options", None)
        if getattr(opts, "_timeout", None) is not None:
            return opts._timeout
    return None


def _sub_mesh(shape, axes, device: DeviceLike = None):
    import torch
    import torch.distributed as tdist
    from torch.distributed import distributed_c10d as c10d
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    world = tdist.get_world_size()
    if n > world:
        raise ValueError(f"a mesh of {n} ranks {tuple(shape)} needs at "
                         f"least {n} ranks; the process group has {world}")
    timeout = _default_timeout()
    mesh = DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))
    side = None
    if tdist.get_backend() in ("gloo", "nccl"):
        side = tdist.new_group(list(range(n)), backend="gloo",
                               timeout=timeout)
    default = c10d._get_default_group()
    if timeout is not None and mesh.get_coordinate() is not None:
        for i in range(len(shape)):
            g = mesh.get_group(i)
            if g is not default:
                c10d._set_pg_timeout(timeout, g)
    mesh.side_group = side
    mesh.wait_s = timeout.total_seconds() if timeout is not None else None
    return mesh


def make_mesh(data: int, model: int, pod: int = 1,
              device: DeviceLike = None):
    """Any mesh for tests and examples (e.g. 2x2 over 4 gloo ranks, or
    over the first 4 of 8), on the first ``pod * data * model`` ranks."""
    if pod > 1:
        return _sub_mesh((pod, data, model), ("pod", "data", "model"),
                         device)
    return _sub_mesh((data, model), ("data", "model"), device)

