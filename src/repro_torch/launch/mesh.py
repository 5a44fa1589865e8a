"""Mesh construction — the port's copy of ``repro/launch/mesh.py``.

Functions, never module-level meshes, so importing this module touches
no process group.  Each builds a :class:`~repro_torch.parallel.axes.Mesh`
over the ranks of the initialized ``torch.distributed`` world, on
``device`` ("cuda": this rank's card over NCCL; "cpu": gloo).  Under
``torchrun`` a process reads its rank and world from the environment:
``torch.distributed.init_process_group`` first, then the mesh.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.parallel.axes import Mesh


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs torch.distributed's process "
                           "group: call init_process_group first")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> Mesh:
    """16x16 = 256 ranks; 2 pods = 512 ranks multi-pod.  Raises unless
    the world holds exactly that many."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    if _world() != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; "
                         f"the world holds {_world()}")
    return Mesh(shape, axes, device)


def make_host_mesh(device: str = "cuda") -> Mesh:
    """Every rank of the world on the model axis: (1, world)."""
    return Mesh((1, _world()), ("data", "model"), device)


def mesh_shape_for(devices: int, model_parallel: int) -> tuple[int, int]:
    """The (data, model) split :func:`make_mesh_for` takes: the model
    axis degraded from ``model_parallel`` until it divides ``devices``."""
    mp = max(1, min(model_parallel, devices))
    while devices % mp:
        mp -= 1
    return devices // mp, mp


def make_mesh_for(devices: int, model_parallel: int,
                  device: str = "cuda") -> Mesh:
    """Elastic re-mesh helper: the (data, model) mesh of
    :func:`mesh_shape_for` over a world of ``devices`` ranks."""
    if _world() != devices:
        raise ValueError(f"a mesh of {devices} ranks over a world of "
                         f"{_world()}")
    return Mesh(mesh_shape_for(devices, model_parallel), ("data", "model"),
                device)
