"""The mesh and the logical-axis rules — the port's copy of
``repro/parallel/axes.py``.

:class:`Mesh` stands for the reference's ``jax.sharding.Mesh``: a grid
of ``torch.distributed`` ranks built on
``torch.distributed.device_mesh.init_device_mesh``, carrying the
reference's ``shape`` (an ordered dict of axis sizes) and
``axis_names``, and for each axis its process group and this rank's
index along it.  Every rank runs the same program on its own block of
each tensor (the reference's ``shard_map`` bodies); the collectives of
:mod:`repro_torch.parallel.collectives` join them.

The launcher installs a rule set mapping logical names to mesh axes
(:func:`axis_rules`); :func:`spec_for` reads it.  In the reference
``constrain`` hands a layout to the SPMD partitioner.  Eager PyTorch has
none, so here it is a no-op: every layout the port runs is made by the
explicit collectives of the model code, never by a partitioner.

A mesh of CUDA tensors runs over NCCL only: gloo would stage every CUDA
tensor through the host, so a CUDA mesh on another backend raises.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Mapping

import torch

_state = threading.local()


class Mesh:
    """A mesh of ``torch.distributed`` ranks: ``shape`` (an ordered dict
    of axis sizes, the reference's ``mesh.shape``), ``axis_names``,
    ``groups`` (each axis's process group), ``index`` (this rank's index
    along each axis) and ``device`` (where this rank's tensors lie).

    ``device_type`` is ``"cuda"`` (the rank's current card, NCCL only),
    ``"cpu"`` (gloo), or ``"meta"`` (shapes only, over PyTorch's
    ``"fake"`` backend alone, whose collectives move nothing: the
    dry-run's one rank of a large world).  The process group must be
    initialized and its world must hold ``prod(shape)`` ranks."""

    def __init__(self, shape, axis_names, device_type: str = "cuda"):
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             f"differ in length")
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs torch.distributed's process "
                               "group: call init_process_group first")
        if device_type not in ("cuda", "cpu", "meta"):
            raise ValueError(f"device_type must be 'cuda', 'cpu' or "
                             f"'meta', not {device_type!r}")
        backend = dist.get_backend()
        if device_type == "cuda" and backend != "nccl":
            raise ValueError(f"a mesh of CUDA tensors runs over NCCL, not "
                             f"{backend}: gloo stages CUDA tensors through "
                             f"the host")
        if (device_type == "meta") != (backend == "fake"):
            raise ValueError(f"a mesh of meta tensors runs over the 'fake' "
                             f"backend and that backend carries nothing "
                             f"else; got {device_type!r} over {backend}")
        n = 1
        for s in shape:
            n *= s
        if n != dist.get_world_size():
            raise ValueError(f"mesh {shape} holds {n} ranks, the world "
                             f"{dist.get_world_size()}")
        self.device_mesh = init_device_mesh(
            "cpu" if device_type == "meta" else device_type, shape,
            mesh_dim_names=axis_names)
        self.shape = collections.OrderedDict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.groups = {a: self.device_mesh.get_group(a) for a in axis_names}
        self.index = {a: self.device_mesh.get_local_rank(a)
                      for a in axis_names}
        self.device_type = device_type
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if device_type == "cuda"
                       else torch.device(device_type))

    @property
    def size(self) -> int:
        return self.device_mesh.size()


def current_rules() -> Mapping[str, tuple] | None:
    return getattr(_state, "rules", None)


def current_mesh() -> Mesh | None:
    return getattr(_state, "mesh", None)


def current_fsdp() -> bool:
    rules = getattr(_state, "rules", None)
    return bool(rules.get("_fsdp", True)) if rules else True


def current_flag(name: str, default: bool = False) -> bool:
    rules = getattr(_state, "rules", None)
    return bool(rules.get("_" + name, default)) if rules else default


@contextlib.contextmanager
def axis_rules(rules: Mapping[str, tuple], mesh: Mesh):
    """Install logical->mesh axis rules (and the mesh) for the duration
    of a call."""
    prev_r = getattr(_state, "rules", None)
    prev_m = getattr(_state, "mesh", None)
    _state.rules, _state.mesh = dict(rules), mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = prev_r, prev_m


def P(*entries) -> tuple:
    """A spec (one entry a dim: a mesh axis, a tuple of axes, or
    ``None`` = replicated), canonical as JAX's ``PartitionSpec`` makes
    one: a tuple of one axis is the axis, an empty tuple ``None``."""
    def canon(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            return None if not e else e[0] if len(e) == 1 else e
        return e
    return tuple(canon(e) for e in entries)


def spec_for(*logical: str | None) -> tuple:
    """The spec for a tuple of logical axis names."""
    rules = current_rules() or {}
    return P(*(rules.get(a) if a is not None else None for a in logical))


def constrain(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """The reference's sharding constraint: a no-op in the port, whose
    layouts come from the model code's explicit collectives."""
    return x


def model_size(mesh: Mesh | None = None) -> int:
    """The ``model`` axis's size on ``mesh`` (the current one by
    default), 1 without a mesh."""
    mesh = current_mesh() if mesh is None else mesh
    return mesh.shape.get("model", 1) if mesh is not None else 1
