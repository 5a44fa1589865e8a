"""The matmul kernel's wrapper: build, bind and launch the hand-written
CUDA kernel (``csrc/matmul_lb.cu``, K3), which replaces the TPU kernel
``_matmul_kernel`` / ``matmul_lb_call`` of
``repro/kernels/matmul_lb/kernel.py``.

The library is built like the conv kernel's
(:func:`repro_torch.kernels.conv_lb.kernel.build`): ``nvcc`` at first
use, never at import.  :func:`matmul_lb` dispatches on where its
tensors lie and nothing else: a CUDA tensor launches the kernel or
raises; a CPU tensor runs the plain version
(:func:`~repro_torch.kernels.matmul_lb.ref.matmul_ref`).  Each launch
adds one to ``matmul_lb.launches``.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import torch

from repro_torch.core.hopper_adapter import SM_COUNT
from repro_torch.core.layer import ceil_div
from repro_torch.kernels.conv_lb.kernel import CTAS_PER_SM, _aligned, build
from repro_torch.kernels.matmul_lb.ref import matmul_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "matmul_lb.cu"

#: the kernel's fixed CTA shape (must match csrc/matmul_lb.cu)
TILE_M = 128        # output rows per CTA
#: input types the kernel takes, by the code its C interface uses
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@lru_cache(maxsize=4096)
def cta_tile(m: int, n: int) -> int:
    """The kernel's own column tile ``tn`` (64 or 128) for an ``m`` x
    ``n`` output: the fewest waves of CTAs over the card's SMs, then
    the fewest CTAs, each weighted by its ``128 x tn`` work."""
    best = None
    for tn in (64, 128):
        ctas = ceil_div(m, TILE_M) * ceil_div(n, tn)
        waves = ceil_div(ctas, SM_COUNT * CTAS_PER_SM)
        key = (waves * tn, ctas * tn, -tn)
        if best is None or key < best[0]:
            best = (key, tn)
    return best[1]


def matmul_lb(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) in ``x.dtype``, f32 sums.

    A CUDA ``x`` launches the CUDA kernel; a CPU ``x`` runs the plain
    version.  Any other device raises."""
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"the matmul kernel runs on CUDA tensors (or "
                         f"its plain version on CPU ones), not {x.device}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul needs (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"w lies on {w.device}, x on {x.device}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"the matmul kernel takes float32 or bfloat16 "
                        f"operands of one type; got {x.dtype} and "
                        f"{w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    tn = cta_tile(m, n)
    lib = build(SOURCE)
    forward = lib.bind("matmul_lb_forward", 3, 8)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = forward(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                      tn, DTYPES[x.dtype], _aligned(x), _aligned(w),
                      _aligned(out), stream)
    if err != 0:
        raise RuntimeError(f"matmul_lb kernel launch failed: "
                           f"{lib.error_string(err)} (error {err})")
    matmul_lb.launches += 1
    return out


matmul_lb.launches = 0
