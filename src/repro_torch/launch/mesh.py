"""Mesh construction: the counterpart of ``repro/launch/mesh.py``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with the reference's
axis names, ``("data", "model")`` or ``("pod", "data", "model")``, over
the ranks of the default process group in row-major order (rank ``r``
sits at the coordinate ``numpy.unravel_index(r, shape)``). Functions
only: importing this module touches no process group, as the
reference's touches no device state. The caller starts the process
group (``torch.distributed.init_process_group`` with NCCL on the card,
gloo on the CPU) before it builds a mesh.

The mesh's device type follows the port's rule: ``cuda`` unless the
caller asks for ``device="cpu"``.
"""
from __future__ import annotations

from repro_torch.device import DeviceLike, resolve_device

PRODUCTION_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


def _mk(shape, axes, device: DeviceLike = None):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """The assignment's production mesh: 16x16 per pod, 2 pods
    multi-pod (256 or 512 ranks)."""
    if multi_pod:
        return _mk(MULTI_POD_SHAPE, ("pod", "data", "model"), device)
    return _mk(PRODUCTION_SHAPE, ("data", "model"), device)


def wait(t):
    """A functional collective's result once it has arrived (an
    ``AsyncCollectiveTensor``, or a plain tensor under a dispatch mode)."""
    import torch.distributed._functional_collectives as funcol
    return t.wait() if hasattr(t, "wait") else funcol.wait_tensor(t)


def make_mesh(data: int, model: int, pod: int = 1,
              device: DeviceLike = None):
    """Any mesh for tests and examples (e.g. 2x2 over 4 gloo ranks)."""
    if pod > 1:
        return _mk((pod, data, model), ("pod", "data", "model"), device)
    return _mk((data, model), ("data", "model"), device)
