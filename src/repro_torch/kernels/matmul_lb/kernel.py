"""The matmul kernels' wrapper: build, bind and launch the hand-written
CUDA kernels of K3, which together replace the TPU kernel
``_matmul_kernel`` / ``matmul_lb_call`` of
``repro/kernels/matmul_lb/kernel.py``:

  * ``csrc/matmul_lb_sm90.cu`` (route ``"sm90"``): bf16 on the tensor
    cores, TMA into an mbarrier ring feeding ``wgmma``;
  * ``csrc/matmul_lb_sm90_tf32.cu`` (route ``"sm90_tf32"``): f32 on the
    tensor cores in 3xTF32, the same ring, A from registers, w rewritten
    into K-major hi and lo tiles by producer warps, the tensor cores'
    sums promoted into f32 sums on the CUDA cores every
    ``TF32_PROMOTE`` stages;
  * ``csrc/matmul_lb.cu`` (route ``"fma"``): every product whose
    operands TMA cannot describe, on FMA.

The libraries are built like the conv kernel's
(:mod:`repro_torch.kernels.nvcc`): ``nvcc`` at first use, never at
import.  :func:`matmul_lb` dispatches on where its
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

from repro_torch.analysis.plan_check import LaunchFacts, TmaMap
from repro_torch.core.hopper_adapter import SM_COUNT
from repro_torch.core.layer import ceil_div
from repro_torch.kernels.conv_lb.kernel import (CTAS_PER_SM, MIN_BLOCKS,
                                                SM90_THREADS, THREADS,
                                                _aligned)
from repro_torch.kernels.matmul_lb.ref import matmul_ref
from repro_torch.kernels.nvcc import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "matmul_lb.cu"
SM90_SOURCE = Path(__file__).resolve().parent / "csrc" / "matmul_lb_sm90.cu"
TF32_SOURCE = (Path(__file__).resolve().parent / "csrc"
               / "matmul_lb_sm90_tf32.cu")

#: the kernel's fixed CTA shape (must match csrc/matmul_lb.cu)
TILE_M = 128        # output rows per CTA
#: input types the kernel takes, by the code its C interface uses
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the sm90 kernel's column tiles and ring (must match
#: csrc/matmul_lb_sm90.cu): 64 of K a stage
SM90_TILES = (128, 256)
SM90_BK = 64
SM90_STAGES = 4
#: the 3xTF32 kernel's shape (must match csrc/matmul_lb_sm90_tf32.cu):
#: 128-row CTAs of two consumer warpgroups, 64 or 128 columns (two f32
#: accumulators a thread, BN / 2 words each), 32 of K a stage
TF32_TILES = (64, 128)
TF32_BK = 32
TF32_STAGES = 4
TF32_BSTAGES = 2
TF32_TRANSPOSERS = 3
#: 3xTF32: three tensor-core products per multiply-add
TF32_PRODUCTS = 3
#: stages (32 of K each) the tensor cores sum before the kernel adds
#: their sums into its CUDA-core f32 sums: the kernel's compile-time
#: ``kPromote``, chosen by the sweep of ``launch/tf32_promote.py``
TF32_PROMOTE = 2
ROUTES = ("sm90", "sm90_tf32", "fma")


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


def _one_per_sm_tile(m: int, n: int, tiles: tuple[int, ...]) -> int:
    """The column tile of ``tiles`` for an ``m`` x ``n`` output, ranked
    as :func:`cta_tile` ranks, one CTA per SM (its rings fill the shared
    memory)."""
    best = None
    for bn in tiles:
        ctas = ceil_div(m, TILE_M) * ceil_div(n, bn)
        waves = ceil_div(ctas, SM_COUNT)
        key = (waves * bn, ctas * bn, -bn)
        if best is None or key < best[0]:
            best = (key, bn)
    return best[1]


@lru_cache(maxsize=4096)
def sm90_tile(m: int, n: int) -> int:
    """The sm90 kernel's column tile ``BN`` (128 or 256) for an ``m`` x
    ``n`` output."""
    return _one_per_sm_tile(m, n, SM90_TILES)


@lru_cache(maxsize=4096)
def tf32_tile(m: int, n: int) -> int:
    """The 3xTF32 kernel's column tile ``BN`` (64 or 128) for an ``m`` x
    ``n`` output."""
    return _one_per_sm_tile(m, n, TF32_TILES)


def sm90_smem_bytes(bn: int) -> int:
    """The sm90 kernel's dynamic shared memory at column tile ``bn``
    (``Smem<BN>::kBytes``): 1024 bytes to align the ring, the ring's A
    and B tiles, a full and an empty mbarrier a stage."""
    return (1024 + SM90_STAGES * (TILE_M + bn) * SM90_BK * 2
            + 2 * SM90_STAGES * 8)


def tf32_smem_bytes(bn: int) -> int:
    """The 3xTF32 kernel's dynamic shared memory at column tile ``bn``
    (``Smem<BN>::kBytes``): 1024 bytes of alignment, the TMA ring's A
    and w tiles, the hi/lo B ring, a full and an empty mbarrier a stage
    of each ring."""
    return (1024 + TF32_STAGES * (TILE_M + bn) * TF32_BK * 4
            + TF32_BSTAGES * 2 * bn * TF32_BK * 4
            + 8 * 2 * (TF32_STAGES + TF32_BSTAGES))


def tile_of(rt: str, m: int, n: int) -> int:
    """The column tile route ``rt``'s kernel runs an ``m`` x ``n``
    output at: :func:`sm90_tile` (``"sm90"``), :func:`tf32_tile`
    (``"sm90_tf32"``) or :func:`cta_tile` (``"fma"``)."""
    return {"sm90": sm90_tile, "sm90_tf32": tf32_tile,
            "fma": cta_tile}[rt](m, n)


def plan_of(x: torch.Tensor, w: torch.Tensor) -> tuple[str, int]:
    """The route :func:`matmul_lb` takes and its kernel's column tile
    (:func:`tile_of`)."""
    rt = route(x, w)
    return rt, tile_of(rt, x.shape[0], w.shape[1])


def launch_facts(kernel: str, route: str, plan: int, shape, dtype
                 ) -> tuple[LaunchFacts, ...]:
    """What one launch of route ``route`` at column tile ``plan`` asks of
    the card, for :func:`~repro_torch.analysis.plan_check.check_launch_plan`:
    ``shape`` is ``(m, n, k, w_kmajor)``, or with the row pitches
    ``(m, n, k, w_kmajor, lda, ldb)`` in words (default dense)."""
    if kernel != "matmul_lb":
        raise ValueError(f"{kernel!r} is not this module's kernel")
    m, n, k, kmajor, *pitches = shape
    lda, ldb = pitches or (k, k if kmajor else n)
    bn = plan
    if route == "fma":
        return (LaunchFacts(source=SOURCE.stem, function="matmul_lb_kernel",
                            grid=(ceil_div(n, bn), ceil_div(m, TILE_M), 1),
                            threads=THREADS, min_blocks=MIN_BLOCKS,
                            ctas_per_sm=CTAS_PER_SM, smem_bytes=0),)
    tf32 = route == "sm90_tf32"
    elt, bk = (4, TF32_BK) if tf32 else (2, SM90_BK)
    b_box = (bk, bn) if kmajor else (128 // elt, bk)
    source = (TF32_SOURCE if tf32 else SM90_SOURCE).stem
    return (LaunchFacts(
        source=source, function=f"{source}_kernel",
        grid=(ceil_div(n, bn) * ceil_div(m, TILE_M), 1, 1),
        threads=SM90_THREADS,
        smem_bytes=tf32_smem_bytes(bn) if tf32 else sm90_smem_bytes(bn),
        maps=(TmaMap("x", (bk, TILE_M), (lda * elt,)),
              TmaMap("w", b_box, (ldb * elt,)))),)


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
    """Where both operands are of one type, ``x`` is row-major, ``w`` is
    N-major or K-major, the base addresses are 16-byte aligned and the
    row pitches are multiples of 16 bytes (a TMA map describes both):
    ``"sm90"`` in bf16, ``"sm90_tf32"`` in f32.  Else ``"fma"``.  Read
    from types, strides and pointers only."""
    if (x.dtype == w.dtype and x.dim() == 2 and w.dim() == 2
            and _pitched(x, 1) and w_layout(w) is not None
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        if x.dtype == torch.bfloat16:
            return "sm90"
        if x.dtype == torch.float32:
            return "sm90_tf32"
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


def _sm90_tf32(x: torch.Tensor, w: torch.Tensor, *,
               lo_terms: bool = True) -> torch.Tensor:
    """One launch of ``csrc/matmul_lb_sm90_tf32.cu`` on :func:`tf32_tile`.
    ``lo_terms=False`` drops the lo words (1xTF32, same tile): a control
    that the card's gate sees the small terms, never a route."""
    m, k = x.shape
    n = w.shape[1]
    kmajor = w_layout(w) == "k-major"
    lib = build(TF32_SOURCE)
    forward = lib.bind("matmul_lb_sm90_tf32_forward", 3, 8)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = forward(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                      x.stride(0), w.stride(1) if kmajor else w.stride(0),
                      tf32_tile(m, n), int(kmajor), int(lo_terms), stream)
    _launched(lib, err, "matmul_lb_sm90_tf32", "sm90_tf32")
    return out


def _fma(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/matmul_lb.cu`` on contiguous operands."""
    m, k = x.shape
    n = w.shape[1]
    lib = build(SOURCE)
    forward = lib.bind("matmul_lb_forward", 3, 8)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = forward(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                      cta_tile(m, n), DTYPES[x.dtype], _aligned(x),
                      _aligned(w), _aligned(out), stream)
    _launched(lib, err, "matmul_lb", "fma")
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
    rt = route(x, w)
    if rt == "sm90":
        return _sm90(x, w)
    if rt == "sm90_tf32":
        return _sm90_tf32(x, w)
    return _fma(_contiguous(x), _contiguous(w))


matmul_lb.launches = 0
matmul_lb.launches_by_route = dict.fromkeys(ROUTES, 0)
matmul_lb.copies = 0
