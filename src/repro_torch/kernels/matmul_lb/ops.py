"""Public entry point of the lower-bound matmul — the port's copy of
``repro/kernels/matmul_lb/ops.py``.

:func:`matmul_lb` plans the product as the reference does: the
accounted block is :func:`~repro_torch.core.hopper_adapter.lb_block_shape`
on the reference's budget (or ``blk``), clamped exactly as the
reference clamps it, and checked by
:func:`~repro_torch.analysis.plan_check.check_matmul_block` at the
``interpret`` profile; a structural error raises
:class:`~repro_torch.analysis.plan_check.PlanLegalityError`.  That
block is what :func:`~repro_torch.core.hopper_adapter.hbm_traffic_model`
charges; the CUDA kernels tile for the card on their own
(:func:`~repro_torch.kernels.matmul_lb.kernel.sm90_tile`,
:func:`~repro_torch.kernels.matmul_lb.kernel.cta_tile`), and the
ragged edges are zero-filled by TMA or predicated, never padded in
memory.
"""

from __future__ import annotations

import torch

from repro_torch.analysis.plan_check import (TARGET_INTERPRET,
                                             PlanLegalityError,
                                             check_matmul_block, errors)
from repro_torch.core.exec_target import resolve_target
from repro_torch.core.hopper_adapter import BlockShape, lb_block_shape
from repro_torch.kernels.matmul_lb import kernel


def accounted_block(m: int, n: int, k: int, dtype_bytes: int,
                    blk: BlockShape | None = None) -> BlockShape:
    """The block the reference plans an ``m x k @ k x n`` product with,
    clamped to the operands as the reference clamps it."""
    if blk is None:
        blk = lb_block_shape(m, n, k, dtype_bytes=dtype_bytes)
    return BlockShape(min(blk.bm, max(8, m)), min(blk.bn, max(8, n)),
                      min(blk.bk, max(8, k)))


def matmul_lb(x: torch.Tensor, w: torch.Tensor,
              blk: BlockShape | None = None, target=None) -> torch.Tensor:
    """Communication-optimal matmul: (M, K) @ (K, N) -> (M, N) in
    ``x.dtype``, f32 sums.

    ``target`` is ``kernel`` (the default) or ``account-only``, which
    cannot execute a matmul and raises.  A CUDA ``x`` launches the
    CUDA kernel :func:`~repro_torch.kernels.matmul_lb.kernel.route`
    names or raises; a CPU ``x`` runs the plain version.  ``w`` may be
    strided (``w.t()`` of a contiguous ``(N, K)`` included)."""
    if target is not None and not resolve_target(target).compute:
        raise ValueError("account-only target cannot execute a matmul")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul needs (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    blk = accounted_block(m, n, k, x.element_size(), blk)
    diags = check_matmul_block(blk, m, n, k,
                               dtype_bytes=x.element_size(),
                               target=TARGET_INTERPRET,
                               where=f"matmul_lb {m}x{k}@{k}x{n}")
    if errors(diags):
        raise PlanLegalityError(errors(diags))
    return kernel.matmul_lb(x, w)
