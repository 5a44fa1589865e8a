"""Collectives over a mesh axis — the port's stand-ins for
``jax.lax.psum``, ``pmax``, ``all_gather(tiled=True)``,
``psum_scatter(tiled=True)``, ``all_to_all`` and ``axis_index`` inside
the reference's ``shard_map`` bodies.

Each takes an axis name of the current mesh
(:func:`~repro_torch.parallel.axes.current_mesh`, or ``mesh=``), or for
``psum``/``pmax``/``axis_index``/``axis_size`` a tuple of names (the
first axis major, as JAX orders a multi-axis index), and runs on that
axis's process group.  On an axis of size 1 a collective returns its
input and counts nothing, forward and backward; otherwise each call
adds one to ``COUNTS[(op, axis)]["calls"]`` and the bytes this rank
sends to its ``"bytes"``, as ``attention.launches`` counts K4's
launches.  The results are new tensors (``psum_grad``'s a view of
its input): no input is written.

Under autograd each is a ``torch.autograd.Function`` whose backward is
a collective of its own, counted under that collective's op.  The
convention is Megatron's: a tensor whole (replicated) on every rank of
an axis carries its whole cotangent on every rank, and a block of a
sharded one the cotangent of that block.  So:

  * ``psum`` (partial sums in, the whole sum out): identity (Megatron's
    "g");
  * ``psum_grad`` (identity forward): the cotangent summed over the
    axis, for a whole tensor entering work that differs by rank, such
    as a column-parallel projection (Megatron's "f");
  * ``all_gather``: the cotangent reduce-scattered (JAX's transpose of
    ``all_gather``), where the gathered tensor feeds work that differs
    by rank, so that its cotangent arrives partial (the FSDP weights
    over "data", the sequence gathers of ``sp_rs`` over "model"); with
    ``whole_grad=True``, where it arrives whole (an output gathered
    back into the replicated residual), this rank's block of it;
  * ``split`` (this rank's block of a whole tensor): the blocks'
    cotangents all-gathered;
  * ``psum_scatter``: the cotangent all-gathered; ``all_to_all``: an
    all-to-all of the cotangent (the exchange is a permutation);
  * ``pmax``: none; the reference takes it under ``stop_gradient``.
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


def _reduce(x: torch.Tensor, axes: list, op, name: str,
            mesh: Mesh) -> torch.Tensor:
    y = x.contiguous().clone()
    for a in axes:
        _count(name, a, y)
        dist.all_reduce(y, op=op, group=mesh.groups[a])
    return y


def _live(axis, mesh: Mesh | None) -> tuple[Mesh, list[str]]:
    """The mesh and those of ``axis``'s axes whose size is above 1."""
    mesh = _mesh(mesh)
    return mesh, [a for a in _axes(axis) if mesh.shape[a] > 1]


def _gather(x: torch.Tensor, axis: str, dim: int,
            mesh: Mesh) -> torch.Tensor:
    n = mesh.shape[axis]
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count("all_gather", axis, xm)
    _GATHER(out, xm, group=mesh.groups[axis])
    return out.movedim(0, dim)


def _scatter(x: torch.Tensor, axis: str, dim: int,
             mesh: Mesh) -> torch.Tensor:
    n = mesh.shape[axis]
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks of {axis!r}")
    out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count("psum_scatter", axis, xm)
    _SCATTER(out, xm, op=dist.ReduceOp.SUM, group=mesh.groups[axis])
    return out.movedim(0, dim)


def _block(x: torch.Tensor, axis: str, dim: int,
           mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``dim`` over ``axis`` (a view)."""
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks of {axis!r}")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.index[axis] * size, size)


def _exchange(x: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    xc = x.contiguous()
    out = torch.empty_like(xc)
    _count("all_to_all", axis, xc)
    dist.all_to_all_single(out, xc, group=mesh.groups[axis])
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return _reduce(x, axes, dist.ReduceOp.SUM, "psum", mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.axes, dist.ReduceOp.SUM, "psum",
                       ctx.mesh), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh, whole_grad):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        ctx.whole_grad = whole_grad
        return _gather(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.whole_grad:
            dx = _block(g, ctx.axis, ctx.dim, ctx.mesh)
        else:
            dx = _scatter(g, ctx.axis, ctx.dim, ctx.mesh)
        return dx, None, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        return _block(x, axis, dim, mesh).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.dim, ctx.mesh), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        return _scatter(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.dim, ctx.mesh), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return _exchange(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.axis, ctx.mesh), None, None


def psum(x: torch.Tensor, axis, mesh: Mesh | None = None) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (one all-reduce per axis of size
    above 1); the backward passes the cotangent through."""
    mesh, axes = _live(axis, mesh)
    return _Psum.apply(x, axes, mesh) if axes else x


def psum_grad(x: torch.Tensor, axis, mesh: Mesh | None = None
              ) -> torch.Tensor:
    """``x`` itself forward; backward, its cotangent summed over
    ``axis`` (a whole tensor entering work that differs by rank)."""
    mesh, axes = _live(axis, mesh)
    return _PsumGrad.apply(x, axes, mesh) if axes else x


def pmax(x: torch.Tensor, axis, mesh: Mesh | None = None) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axis``, outside autograd."""
    mesh, axes = _live(axis, mesh)
    if not axes:
        return x
    return _reduce(x.detach(), axes, dist.ReduceOp.MAX, "pmax", mesh)


def all_gather(x: torch.Tensor, axis: str, dim: int = 0,
               mesh: Mesh | None = None, *,
               whole_grad: bool = False) -> torch.Tensor:
    """``x`` of every rank along ``axis`` concatenated in rank order on
    ``dim`` (JAX's ``all_gather(..., tiled=True)``).  Backward: the
    cotangent reduce-scattered onto this rank's block, or, with
    ``whole_grad`` (the cotangent arrives whole on every rank), this
    rank's block of it."""
    mesh = _mesh(mesh)
    if mesh.shape[axis] == 1:
        return x
    return _AllGather.apply(x, axis, dim % x.dim(), mesh, whole_grad)


def split(x: torch.Tensor, axis: str, dim: int = 0,
          mesh: Mesh | None = None) -> torch.Tensor:
    """This rank's block of ``dim`` of ``x``, whole on every rank of
    ``axis`` (a copy); backward, the blocks' cotangents all-gathered."""
    mesh = _mesh(mesh)
    if mesh.shape[axis] == 1:
        return x
    return _Split.apply(x, axis, dim % x.dim(), mesh)


def psum_scatter(x: torch.Tensor, axis: str, dim: int = 0,
                 mesh: Mesh | None = None) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, of which this rank keeps its
    block of ``dim`` (JAX's ``psum_scatter(..., tiled=True)``);
    backward, the cotangent all-gathered."""
    mesh = _mesh(mesh)
    if mesh.shape[axis] == 1:
        return x
    return _PsumScatter.apply(x, axis, dim % x.dim(), mesh)


def all_to_all(x: torch.Tensor, axis: str,
               mesh: Mesh | None = None) -> torch.Tensor:
    """``x`` (n, ...) with n the size of ``axis``: block i goes to rank
    i, and block i of the result came from rank i (JAX's
    ``all_to_all(x, axis, split_axis=0, concat_axis=0, tiled=False)``);
    backward, the same exchange of the cotangent."""
    mesh = _mesh(mesh)
    n = mesh.shape[axis]
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {axis!r} needs a leading dim of "
                         f"{n}, got {tuple(x.shape)}")
    if n == 1:
        return x
    return _AllToAll.apply(x, axis, mesh)
