"""The conv kernel's wrapper: build, bind and launch the hand-written
CUDA kernel (``csrc/conv_lb.cu``), which replaces the TPU kernel
``_conv_kernel`` / ``conv_lb_call`` of
``repro/kernels/conv_lb/kernel.py``.

Build (:func:`build`, shared with the wgrad kernel's wrapper): at
first use ``nvcc`` compiles a source in this checkout for ``sm_90a``
into a shared library with a plain C interface under
``build/repro_torch/`` (named by the source's hash, so an edited source
is rebuilt), and ``ctypes`` binds it.  Nothing is compiled when the
module is imported.

:func:`conv_lb` dispatches on where its tensors lie and nothing else:
a CUDA tensor launches the kernel or raises (a failed build, a refused
launch, a geometry or dtype the kernel does not take); a CPU tensor
runs the plain version (:func:`~repro_torch.kernels.conv_lb.ref.conv2d_ref`).
Each launch adds one to ``conv_lb.launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from pathlib import Path

import torch

from repro_torch.core.hopper_adapter import (REGS_PER_SM, SM_COUNT,
                                             SMEM_PER_BLOCK)
from repro_torch.core.layer import ceil_div
from repro_torch.kernels.conv_lb.ref import conv2d_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "conv_lb.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: the kernel's fixed CTA shape (must match csrc/conv_lb.cu)
TILE_M = 128        # output pixels per CTA
CI_BLOCK = 8        # input channels staged per step
THREADS = 256
MAX_REGS = 128      # per thread, as __launch_bounds__(256, 2) caps it
CTAS_PER_SM = REGS_PER_SM // (THREADS * MAX_REGS)
#: operand types the conv and wgrad kernels take, by the code their C
#: interfaces use
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class Library:
    """One loaded kernel library and what its build printed.  The C
    interface of ``csrc/<stem>.cu`` exports ``<stem>_error_string``."""

    def __init__(self, lib: ctypes.CDLL, path: Path, log: str,
                 seconds: float, stem: str):
        self.lib, self.path, self.log, self.seconds = lib, path, log, seconds
        self._error_string = getattr(lib, f"{stem}_error_string")
        self._error_string.argtypes = [ctypes.c_int]
        self._error_string.restype = ctypes.c_char_p
        self._bound: dict[str, object] = {}

    def bind(self, name: str, n_pointers: int, n_ints: int):
        """The C function ``name`` taking ``n_pointers`` pointers, then
        ``n_ints`` ints, then the stream, and returning a CUDA error
        code."""
        if name not in self._bound:
            fn = getattr(self.lib, name)
            fn.argtypes = ([ctypes.c_void_p] * n_pointers
                           + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._bound[name] = fn
        return self._bound[name]

    def error_string(self, code: int) -> str:
        return self._error_string(code).decode()


_LIBRARIES: dict[Path, Library] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the kernels are built from "
                           "their csrc/*.cu sources at first use and "
                           "need the CUDA toolkit")
    return found


def build_many(sources) -> list[Library]:
    """Compile (once per process and source) and load kernel libraries,
    one ``nvcc`` per source, all started together; raises with the
    compiler's output if a build fails."""
    todo = {}
    for source in sources:
        source = Path(source)
        if source in _LIBRARIES or source in todo:
            continue
        src = source.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                 str(source)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        todo[source] = (proc, tmp,
                        BUILD_DIR / f"{source.stem}-{digest}.so",
                        time.perf_counter())
    # wait for every compiler before loading or raising
    logs = {source: job[0].communicate()[0] for source, job in todo.items()}
    failed = []
    for source, (proc, tmp, target, t0) in todo.items():
        log = logs[source]
        try:
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) on "
                              f"{source}:\n{log}")
                continue
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        _LIBRARIES[source] = Library(ctypes.CDLL(str(target)), target, log,
                                     time.perf_counter() - t0, source.stem)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [_LIBRARIES[Path(s)] for s in sources]


def build(source: Path = SOURCE) -> Library:
    """Compile (once per process) and load one kernel library, by
    default the conv kernel's."""
    return build_many([source])[0]


def _best_tile(batch: int, ho: int, wo: int, co: int, pool: int, hk: int,
               wk: int, stride: tuple[int, int], dilation: tuple[int, int],
               elt: int, krows: int, fit: bool):
    """The best ``((bb, ty, tx, tn), ctas)`` by :func:`cta_tile`'s
    ranking, among the tiles whose shared memory fits (``fit``) or
    among all; ``None`` if none qualifies."""
    best = None
    for tn in (64, 128):
        if tn == 128 and co <= 64:
            continue
        nco = ceil_div(co, tn)
        for tx in range(pool, min(16, -(-wo // pool) * pool) + 1, pool):
            for ty in range(pool, min(TILE_M // tx,
                                      -(-ho // pool) * pool) + 1, pool):
                bb = max(1, min(batch, TILE_M // (ty * tx)))
                if fit and cta_smem_bytes(bb, ty, tx, tn, hk, wk, stride,
                                          dilation, pool, krows,
                                          elt) > SMEM_PER_BLOCK:
                    continue
                ctas = (ceil_div(batch, bb) * ceil_div(ho, ty)
                        * ceil_div(wo, tx) * nco)
                waves = ceil_div(ctas, SM_COUNT * CTAS_PER_SM)
                halo = (ty + 2) * (tx + 2) / (ty * tx)
                key = (waves * tn, ctas * tn, halo, -tn)
                if best is None or key < best[0]:
                    best = (key, (bb, ty, tx, tn), ctas)
    return None if best is None else best[1:]


@lru_cache(maxsize=4096)
def cta_plan(batch: int, ho: int, wo: int, co: int, pool: int,
             hk: int = 1, wk: int = 1, stride: tuple[int, int] = (1, 1),
             dilation: tuple[int, int] = (1, 1), elt: int = 4
             ) -> tuple[int, int, int, int, int]:
    """The kernel's own CTA tile and staging ``(bb, ty, tx, tn, krows)``
    for one conv of ``elt``-byte words (4 f32, 2 bf16): ``bb`` images x
    ``ty`` x ``tx`` output pixels (<= 128, pool-aligned) x ``tn`` output
    channels, the weight slice of ``krows`` kernel rows staged per step
    (``hk``: the whole window; 1: one kernel row at a time).  Only tiles
    whose shared memory (:func:`cta_smem_bytes`) fits in
    ``SMEM_PER_BLOCK`` are ranked:
    the fewest waves of CTAs over the card's SMs, then the fewest CTAs
    (each CTA does 128 x tn work whatever part of it is real), then the
    least halo per output pixel (the squarest tile).  The whole window
    is staged if a tile fits so with at least as many CTAs as the card
    has SMs (or as row staging gets); otherwise one kernel row at a
    time.  If no tile fits either way, the best tile of the ranking,
    which the launch then refuses."""
    if pool > 16:
        raise ValueError(f"pool={pool} exceeds the kernel's 16-column "
                         f"tile")
    geom = (batch, ho, wo, co, pool, hk, wk, tuple(stride),
            tuple(dilation), elt)
    whole = _best_tile(*geom, krows=hk, fit=True)
    rows = _best_tile(*geom, krows=1, fit=True) if hk > 1 else None
    if whole is not None and (rows is None
                              or whole[1] >= min(SM_COUNT, rows[1])):
        return whole[0] + (hk,)
    if rows is not None:
        return rows[0] + (1,)
    return _best_tile(*geom, krows=1, fit=False)[0] + (1,)


def cta_tile(batch: int, ho: int, wo: int, co: int, pool: int,
             hk: int = 1, wk: int = 1, stride: tuple[int, int] = (1, 1),
             dilation: tuple[int, int] = (1, 1), elt: int = 4
             ) -> tuple[int, int, int, int]:
    """The kernel's own CTA tile ``(bb, ty, tx, tn)`` for one conv
    (:func:`cta_plan` without its staging)."""
    return cta_plan(batch, ho, wo, co, pool, hk, wk, tuple(stride),
                    tuple(dilation), elt)[:4]


def cta_smem_bytes(bb: int, ty: int, tx: int, tn: int, hk: int, wk: int,
                   stride: tuple[int, int], dilation: tuple[int, int],
                   pool: int, krows: int | None = None,
                   elt: int = 4) -> int:
    """Dynamic shared memory of one CTA: two stage buffers of the halo
    tile and weight slice of ``krows`` kernel rows (default all ``hk``)
    in ``elt``-byte words, or the f32 pre-pool output tile when a pool
    is fused."""
    krows = hk if krows is None else krows
    hy = (ty - 1) * stride[0] + (krows - 1) * dilation[0] + 1
    hx = (tx - 1) * stride[1] + (wk - 1) * dilation[1] + 1
    staged = 2 * (bb * hy * hx + krows * wk * tn) * CI_BLOCK * elt
    return max(staged, TILE_M * tn * 4 if pool > 1 else 0)


def _check_cuda_operand(name: str, t: torch.Tensor, device,
                        shape: tuple, dtype: torch.dtype) -> None:
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, x on {device}")
    if t.dtype not in DTYPES or t.dtype != dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 operands "
                        f"of one type; {name} is {t.dtype}"
                        + ("" if name == "x" else f", x {dtype}"))
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, the conv "
                         f"needs {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _aligned(t: torch.Tensor) -> bool:
    """16-byte copies need 16-byte aligned rows (the kernel also needs
    the channel count to divide by 4, which it checks itself)."""
    return t.data_ptr() % 16 == 0


def conv_lb(x: torch.Tensor, w: torch.Tensor,
            bias: torch.Tensor | None = None,
            residual: torch.Tensor | None = None, *,
            stride=(1, 1), padding=(0, 0), dilation=(1, 1),
            lhs_dilation=(1, 1), relu: bool = False,
            pool: int = 1) -> torch.Tensor:
    """One group of the conv: x (B, H, W, Ci), w (Hk, Wk, Ci, Co),
    bias (Co,), residual (B, Ho, Wo, Co) -> (B, Ho/pool, Wo/pool, Co).

    A CUDA ``x`` launches the CUDA kernel; a CPU ``x`` runs the plain
    version.  Any other device raises."""
    if x.device.type == "cpu":
        return conv2d_ref(x, w, bias, residual, stride=stride,
                          padding=padding, dilation=dilation,
                          lhs_dilation=lhs_dilation, relu=relu, pool=pool)
    if x.device.type != "cuda":
        raise ValueError(f"the conv kernel runs on CUDA tensors (or its "
                         f"plain version on CPU ones), not {x.device}")
    b, h, wd, ci = x.shape
    hk, wk, _, co = w.shape
    sy, sx = stride
    py, px = padding
    dy, dx = dilation
    ly, lx = lhs_dilation
    if min(sy, sx, dy, dx, ly, lx, pool) < 1 or min(py, px) < 0:
        raise ValueError("stride, dilation, lhs_dilation and pool must "
                         "be >= 1 and padding >= 0")
    ho = ((h - 1) * ly + 1 + 2 * py - ((hk - 1) * dy + 1)) // sy + 1
    wo = ((wd - 1) * lx + 1 + 2 * px - ((wk - 1) * dx + 1)) // sx + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"{hk}x{wk} conv has no output on a {h}x{wd} "
                         f"plane")
    if pool > 1 and (ho % pool or wo % pool):
        raise ValueError(f"fused pool={pool} needs a pool-divisible "
                         f"output plane, got {ho}x{wo}")
    _check_cuda_operand("x", x, x.device, (b, h, wd, ci), x.dtype)
    _check_cuda_operand("w", w, x.device, (hk, wk, ci, co), x.dtype)
    if bias is not None:
        _check_cuda_operand("bias", bias, x.device, (co,), x.dtype)
    if residual is not None:
        _check_cuda_operand("residual", residual, x.device,
                            (b, ho, wo, co), x.dtype)
    elt = x.element_size()
    bb, ty, tx, tn, krows = cta_plan(b, ho, wo, co, pool, hk, wk,
                                     (sy, sx), (dy, dx), elt)
    smem = cta_smem_bytes(bb, ty, tx, tn, hk, wk, (sy, sx), (dy, dx),
                          pool, krows, elt)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"a {hk}x{wk} stride {stride} dilation "
                         f"{dilation} conv needs {smem} B of shared "
                         f"memory per CTA, more than the card's "
                         f"{SMEM_PER_BLOCK} B")
    lib = build()
    forward = lib.bind("conv_lb_forward", 5, 29)
    out = torch.empty((b, ho // pool, wo // pool, co), dtype=x.dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = forward(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), b, h, wd, ci, co, hk, wk, ho, wo,
            sy, sx, dy, dx, ly, lx, py, px, pool, int(relu),
            bb, ty, tx, tn, krows, _aligned(x), _aligned(w),
            _aligned(out) and (residual is None or _aligned(residual)),
            DTYPES[x.dtype], smem, stream)
    if err != 0:
        raise RuntimeError(f"conv_lb kernel launch failed: "
                           f"{lib.error_string(err)} (error {err})")
    conv_lb.launches += 1
    return out


conv_lb.launches = 0
