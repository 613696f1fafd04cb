"""Meshes (the port of ``launch/mesh.py``).

The production meshes and the elastic one are descriptions
(``distributed.sharding.Mesh``: axis names and sizes), so specs resolve
against them in any process.  :func:`device_mesh` builds the
``torch.distributed`` DeviceMesh that places tensors, over a process group
the caller has initialised with one rank per mesh position.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..distributed.sharding import Mesh


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    return Mesh(tuple(axis_names), tuple(int(s) for s in shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh_for(n_devices: int, model_parallel: int = 1,
                  pods: int = 1, device_type: Optional[str] = None) -> Mesh:
    """Elastic scaling: the best mesh for the devices that are alive.  With
    ``device_type`` (``"cuda"`` or ``"cpu"``) the mesh carries a DeviceMesh
    over the initialised process group of ``n_devices`` ranks
    (:func:`device_mesh`), so the restart after a failure restores its
    checkpoint onto it (``checkpoint.restore_checkpoint(...,
    shardings=)``) and runs the sharded step there."""
    if n_devices % (model_parallel * pods):
        raise ValueError(f"{n_devices} devices do not split into "
                         f"{pods} pods x {model_parallel} model ranks")
    data = n_devices // (model_parallel * pods)
    if pods > 1:
        m = make_mesh((pods, data, model_parallel), ("pod", "data", "model"))
    else:
        m = make_mesh((data, model_parallel), ("data", "model"))
    return m if device_type is None else device_mesh(m, device_type)


def mesh_description(mesh: Mesh) -> dict:
    return {"axis_names": list(mesh.axis_names),
            "shape": [int(s) for s in mesh.sizes],
            "n_devices": int(mesh.size)}


def device_mesh(mesh: Mesh, device_type: str = "cuda") -> Mesh:
    """``mesh`` with a DeviceMesh over the initialised default process
    group, rank ``r`` at the row-major position ``r`` (its world size
    must be the mesh's size).  On ``cuda`` each rank must have set its
    device first (``torch.cuda.set_device``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("initialise the process group first")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"a world of {dist.get_world_size()} ranks for a "
                         f"mesh of {mesh.size}")
    dm = init_device_mesh(device_type, mesh.sizes,
                          mesh_dim_names=mesh.axis_names)
    return Mesh(mesh.axis_names, mesh.sizes, dm)
