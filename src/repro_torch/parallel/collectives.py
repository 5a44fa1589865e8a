"""Collectives over a mesh axis — the port's stand-ins for
``jax.lax.psum``, ``pmax``, ``all_gather(tiled=True)``,
``psum_scatter(tiled=True)``, ``all_to_all`` and ``axis_index`` inside
the reference's ``shard_map`` bodies.

Each takes an axis name of the current mesh
(:func:`~repro_torch.parallel.axes.current_mesh`, or ``mesh=``), or for
``psum``/``pmax``/``axis_index``/``axis_size`` a tuple of names (the
first axis major, as JAX orders a multi-axis index), and runs on that
axis's process group.  On an axis of size 1 a collective returns its
input and counts nothing; otherwise each call adds one to
``COUNTS[(op, axis)]["calls"]`` and the bytes this rank sends to its
``"bytes"``, as ``attention.launches`` counts K4's launches.  The
results are new tensors: no input is written.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel.axes import Mesh, current_mesh

#: {(op, axis): {"calls": n, "bytes": b}} since the last :func:`reset`
COUNTS: dict[tuple[str, str], dict[str, int]] = {}
#: the tensor-to-tensor gather and reduce-scatter under their newer
#: names where this torch has them (older ones have only the first)
_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def reset() -> None:
    COUNTS.clear()


def counts_by_op() -> dict[str, dict[str, int]]:
    """The counts summed over axes: ``{op: {"calls", "bytes"}}``."""
    out: dict[str, dict[str, int]] = {}
    for (op, _axis), c in sorted(COUNTS.items()):
        o = out.setdefault(op, {"calls": 0, "bytes": 0})
        o["calls"] += c["calls"]
        o["bytes"] += c["bytes"]
    return out


def _mesh(mesh: Mesh | None) -> Mesh:
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        raise RuntimeError("a collective needs a mesh: install one with "
                           "axes.axis_rules")
    return mesh


def _axes(axis) -> tuple[str, ...]:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _count(op: str, axis: str, t: torch.Tensor) -> None:
    c = COUNTS.setdefault((op, axis), {"calls": 0, "bytes": 0})
    c["calls"] += 1
    c["bytes"] += t.numel() * t.element_size()


def axis_size(axis, mesh: Mesh | None = None) -> int:
    mesh = _mesh(mesh)
    n = 1
    for a in _axes(axis):
        n *= mesh.shape[a]
    return n


def axis_index(axis, mesh: Mesh | None = None) -> int:
    """This rank's index along ``axis`` (a tuple: the first axis
    major), a host int."""
    mesh = _mesh(mesh)
    idx = 0
    for a in _axes(axis):
        idx = idx * mesh.shape[a] + mesh.index[a]
    return idx


def _reduce(x: torch.Tensor, axis, op, name: str,
            mesh: Mesh | None) -> torch.Tensor:
    mesh = _mesh(mesh)
    axes = [a for a in _axes(axis) if mesh.shape[a] > 1]
    if not axes:
        return x
    y = x.contiguous().clone()
    for a in axes:
        _count(name, a, y)
        dist.all_reduce(y, op=op, group=mesh.groups[a])
    return y


def psum(x: torch.Tensor, axis, mesh: Mesh | None = None) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (one all-reduce per axis of size
    above 1)."""
    return _reduce(x, axis, dist.ReduceOp.SUM, "psum", mesh)


def pmax(x: torch.Tensor, axis, mesh: Mesh | None = None) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axis``."""
    return _reduce(x, axis, dist.ReduceOp.MAX, "pmax", mesh)


def all_gather(x: torch.Tensor, axis: str, dim: int = 0,
               mesh: Mesh | None = None) -> torch.Tensor:
    """``x`` of every rank along ``axis`` concatenated in rank order on
    ``dim`` (JAX's ``all_gather(..., tiled=True)``)."""
    mesh = _mesh(mesh)
    n = mesh.shape[axis]
    if n == 1:
        return x
    dim = dim % x.dim()
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count("all_gather", axis, xm)
    _GATHER(out, xm, group=mesh.groups[axis])
    return out.movedim(0, dim)


def psum_scatter(x: torch.Tensor, axis: str, dim: int = 0,
                 mesh: Mesh | None = None) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, of which this rank keeps its
    block of ``dim`` (JAX's ``psum_scatter(..., tiled=True)``)."""
    mesh = _mesh(mesh)
    n = mesh.shape[axis]
    if n == 1:
        return x
    dim = dim % x.dim()
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks of {axis!r}")
    out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count("psum_scatter", axis, xm)
    _SCATTER(out, xm, op=dist.ReduceOp.SUM, group=mesh.groups[axis])
    return out.movedim(0, dim)


def all_to_all(x: torch.Tensor, axis: str,
               mesh: Mesh | None = None) -> torch.Tensor:
    """``x`` (n, ...) with n the size of ``axis``: block i goes to rank
    i, and block i of the result came from rank i (JAX's
    ``all_to_all(x, axis, split_axis=0, concat_axis=0, tiled=False)``)."""
    mesh = _mesh(mesh)
    n = mesh.shape[axis]
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {axis!r} needs a leading dim of "
                         f"{n}, got {tuple(x.shape)}")
    if n == 1:
        return x
    xc = x.contiguous()
    out = torch.empty_like(xc)
    _count("all_to_all", axis, xc)
    dist.all_to_all_single(out, xc, group=mesh.groups[axis])
    return out
