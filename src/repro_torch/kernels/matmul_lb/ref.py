"""The plain PyTorch version of the matmul kernel — the port's copy of
``repro/kernels/matmul_lb/ref.py``: the product in f32, cast to
``x.dtype``.  The kernel wrapper runs it for CPU tensors, and the tests
and the chip smoke hold the kernel against it on the card; it never
runs for a CUDA tensor on any entry point."""

from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) in ``x.dtype``, summed in f32."""
    return (x.to(torch.float32) @ w.to(torch.float32)).to(x.dtype)
