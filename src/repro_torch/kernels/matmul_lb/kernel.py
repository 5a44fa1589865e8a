"""The matmul kernels' wrapper: build, bind and launch the two
hand-written CUDA kernels of K3, which together replace the TPU kernel
``_matmul_kernel`` / ``matmul_lb_call`` of
``repro/kernels/matmul_lb/kernel.py``:

  * ``csrc/matmul_lb_sm90.cu`` (route ``"sm90"``): bf16 on the tensor
    cores, TMA into an mbarrier ring feeding ``wgmma``;
  * ``csrc/matmul_lb.cu`` (route ``"fma"``): f32, and every bf16
    product whose operands TMA cannot describe, on FMA.

The libraries are built like the conv kernel's
(:func:`repro_torch.kernels.conv_lb.kernel.build`): ``nvcc`` at first
use, never at import.  :func:`matmul_lb` dispatches on where its
tensors lie: a CUDA tensor launches a kernel or raises; a CPU tensor
runs the plain version
(:func:`~repro_torch.kernels.matmul_lb.ref.matmul_ref`).  On the card
:func:`route` picks the kernel from types, strides and pointers before
launch, never by trying one; the FMA kernel takes contiguous operands,
so a strided one bound for it is copied once (``matmul_lb.copies``).
Each launch adds one to ``matmul_lb.launches`` and to its route's
entry of ``matmul_lb.launches_by_route``.
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
SM90_SOURCE = Path(__file__).resolve().parent / "csrc" / "matmul_lb_sm90.cu"

#: the kernel's fixed CTA shape (must match csrc/matmul_lb.cu)
TILE_M = 128        # output rows per CTA
#: input types the kernel takes, by the code its C interface uses
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the sm90 kernel's column tiles (must match csrc/matmul_lb_sm90.cu)
SM90_TILES = (128, 256)
ROUTES = ("sm90", "fma")


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


@lru_cache(maxsize=4096)
def sm90_tile(m: int, n: int) -> int:
    """The sm90 kernel's column tile ``BN`` (128 or 256) for an ``m`` x
    ``n`` output, ranked as :func:`cta_tile` ranks (one CTA per SM: its
    ring fills the shared memory)."""
    best = None
    for bn in SM90_TILES:
        ctas = ceil_div(m, TILE_M) * ceil_div(n, bn)
        waves = ceil_div(ctas, SM_COUNT)
        key = (waves * bn, ctas * bn, -bn)
        if best is None or key < best[0]:
            best = (key, bn)
    return best[1]


def _pitched(t: torch.Tensor, dim: int) -> bool:
    """``t`` is unit-strided along ``dim`` and its rows, no shorter than
    they are long, lie a multiple of 16 bytes apart: a TMA map
    describes it."""
    pitch = t.stride(1 - dim)
    return (t.stride(dim) == 1 and pitch >= t.shape[dim]
            and (pitch * t.element_size()) % 16 == 0)


def w_layout(w: torch.Tensor) -> str | None:
    """``"n-major"`` for rows of N (a contiguous ``(K, N)``),
    ``"k-major"`` for rows of K (``w.t()`` of a contiguous ``(N, K)``),
    whichever TMA can describe, else ``None``."""
    if _pitched(w, 1):
        return "n-major"
    if _pitched(w, 0):
        return "k-major"
    return None


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """``"sm90"`` iff both operands are bf16, ``x`` is row-major, ``w``
    is N-major or K-major, the base addresses are 16-byte aligned and
    the row pitches are multiples of 16 bytes; else ``"fma"``.  Read
    from types, strides and pointers only."""
    if (x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
            and x.dim() == 2 and w.dim() == 2
            and _pitched(x, 1) and w_layout(w) is not None
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "sm90"
    return "fma"


def _launched(lib, err: int, name: str, rt: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.error_string(err)} (error {err})")
    matmul_lb.launches += 1
    matmul_lb.launches_by_route[rt] += 1


def _sm90(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    m, k = x.shape
    n = w.shape[1]
    kmajor = w_layout(w) == "k-major"
    lib = build(SM90_SOURCE)
    forward = lib.bind("matmul_lb_sm90_forward", 3, 7)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = forward(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                      x.stride(0), w.stride(1) if kmajor else w.stride(0),
                      sm90_tile(m, n), int(kmajor), stream)
    _launched(lib, err, "matmul_lb_sm90", "sm90")
    return out


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    if t.is_contiguous():
        return t
    matmul_lb.copies += 1
    return t.contiguous()


def matmul_lb(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) in ``x.dtype``, f32 sums.

    A CUDA ``x`` launches the kernel :func:`route` names (a strided
    operand bound for the FMA kernel is copied once first); a CPU
    ``x`` runs the plain version.  Any other device raises."""
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
    if route(x, w) == "sm90":
        return _sm90(x, w)
    x, w = _contiguous(x), _contiguous(w)
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
    _launched(lib, err, "matmul_lb", "fma")
    return out


matmul_lb.launches = 0
matmul_lb.launches_by_route = dict.fromkeys(ROUTES, 0)
matmul_lb.copies = 0
