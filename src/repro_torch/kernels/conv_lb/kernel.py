"""The conv kernel's wrapper: build, bind and launch the two
hand-written CUDA kernels of K1, which together replace the TPU kernel
``_conv_kernel`` / ``conv_lb_call`` of
``repro/kernels/conv_lb/kernel.py``:

  * ``csrc/conv_lb_sm90.cu`` (route ``"sm90"``): bf16 at stride 1 on
    the tensor cores, TMA into mbarrier rings feeding ``wgmma``;
  * ``csrc/conv_lb.cu`` (route ``"fma"``): f32, and every bf16 conv
    :func:`route` does not send to the sm90 kernel, on FMA.

Build (:func:`build`, shared with the wgrad kernel's wrapper): at
first use ``nvcc`` compiles a source in this checkout for ``sm_90a``
into a shared library with a plain C interface under
``build/repro_torch/`` (named by the source's hash, so an edited source
is rebuilt), and ``ctypes`` binds it.  Nothing is compiled when the
module is imported.

:func:`conv_lb` dispatches first on where its tensors lie: a CUDA
tensor launches the kernel :func:`route` names or raises (a
failed build, a refused launch, a geometry or dtype the kernel does not
take); a CPU tensor runs the plain version
(:func:`~repro_torch.kernels.conv_lb.ref.conv2d_ref`).  The route is
read from types, geometry and pointers before launch, never by trying
one; :func:`plan_of` names it with the tile its kernel runs.  Each
launch adds one to ``conv_lb.launches`` and to its route's
entry of ``conv_lb.launches_by_route``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import itertools
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
SM90_SOURCE = Path(__file__).resolve().parent / "csrc" / "conv_lb_sm90.cu"
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


@lru_cache(maxsize=None)
def _entry(source: Path, name: str, n_pointers: int, n_ints: int):
    """``(library, bound C function)``, built and bound once per
    process: a launch then spends no host time on either."""
    lib = build(source)
    return lib, lib.bind(name, n_pointers, n_ints)


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


#: the sm90 kernel's fixed shape (must match csrc/conv_lb_sm90.cu): a
#: CTA owns two wgmma blocks of 8 x 8 output pixels of one image,
#: ``(bb, ty, tx)`` side by side or in two images
SM90_BLOCK = 8
SM90_TILES = ((1, 8, 16), (2, 8, 8))
SM90_BN = (64, 128, 256)     # output channels per CTA
SM90_W_STAGES = 4            # weight ring: (Ci block, window) stages
SM90_H_STAGES = 2            # halo ring: Ci blocks
SM90_MAX_WIN = 128           # windows whose offsets a launch carries
SM90_BOX_MAX = 256           # a TMA box's extent in any dimension
SM90_PLANE = 8               # channels of one 16-byte halo plane
ROUTES = ("sm90", "fma")


@dataclasses.dataclass(frozen=True)
class Sm90Plan:
    """The sm90 kernel's tile and every shared-memory offset it is
    passed (bytes).  The halo of one Ci block lies as ``cib / 8``
    planes ``[bb][hy][hx][8 channels]``, each padded to 128 bytes: A's
    core matrix (8 output pixels of a row x 8 channels) is then 128
    contiguous bytes, the next 8 channels one plane further (the
    descriptor's leading offset), the next output row one halo row
    further (its stride offset), and window ``(ky, kx)`` the same
    descriptor shifted by ``win_off[ky * wk + kx]``."""

    bb: int
    ty: int
    tx: int
    bn: int                    # output channels per CTA
    cib: int                   # input channels per Ci block
    hy: int                    # halo box rows
    hx: int                    # halo box columns
    plane_bytes: int           # A's leading offset
    sbo: int                   # A's stride offset
    blk_off: tuple[int, int]   # each consumer's block in the halo
    win_off: tuple[int, ...]   # window ky * wk + kx -> shift in the halo
    smem_bytes: int
    ctas: int

    @property
    def tile(self) -> tuple[int, int, int, int, int]:
        """``(bb, ty, tx, bn, cib)``."""
        return self.bb, self.ty, self.tx, self.bn, self.cib


def sm90_cibs(ci: int) -> tuple[int, ...]:
    """Input channels per Ci block, widest first: 64, 32 and 16 (a
    multiple of wgmma's 16-channel depth), none wider than ``ci``
    rounded up to that depth."""
    return tuple(c for c in (64, 32, 16) if c <= ceil_div(ci, 16) * 16)


def sm90_layout(bb: int, ty: int, tx: int, bn: int, cib: int, hk: int,
                wk: int, dilation: tuple[int, int]) -> dict:
    """The halo box and the shared-memory offsets of one tile (the
    fields of :class:`Sm90Plan` but ``ctas``)."""
    dy, dx = dilation
    hy, hx = ty + (hk - 1) * dy, tx + (wk - 1) * dx
    plane = ceil_div(bb * hy * hx * 2 * SM90_PLANE, 128) * 128
    # the second consumer's block: the next image's, or 8 columns on
    blk = ((bb - 1) * hy * hx + (tx - SM90_BLOCK)) * 16
    win = tuple((ky * dy * hx + kx * dx) * 16
                for ky in range(hk) for kx in range(wk))
    # 1024 bytes to align the weight ring to its swizzle, the weight
    # ring, the halo ring, a full and an empty mbarrier per stage
    smem = (1024 + SM90_W_STAGES * bn * cib * 2
            + SM90_H_STAGES * (cib // SM90_PLANE) * plane
            + 8 * 2 * (SM90_W_STAGES + SM90_H_STAGES))
    return dict(bb=bb, ty=ty, tx=tx, bn=bn, cib=cib, hy=hy, hx=hx,
                plane_bytes=plane, sbo=hx * 16, blk_off=(0, blk),
                win_off=win, smem_bytes=smem)


def _sm90_fits(lay: dict) -> bool:
    return (lay["smem_bytes"] <= SMEM_PER_BLOCK
            and len(lay["win_off"]) <= SM90_MAX_WIN
            and max(lay["hy"], lay["hx"]) <= SM90_BOX_MAX)


@lru_cache(maxsize=4096)
def sm90_plan(batch: int, ho: int, wo: int, co: int, ci: int, hk: int = 1,
              wk: int = 1, dilation: tuple[int, int] = (1, 1)
              ) -> Sm90Plan | None:
    """The sm90 kernel's tile for one stride-1 conv, ranked as
    :func:`cta_plan` ranks (one CTA per SM: 384 threads at up to 232
    registers for the consumers): the fewest waves of CTAs over the
    card's SMs, then the fewest CTAs (each does 128 x ``bn`` work
    whatever part of it is real), then the least halo per output pixel,
    then the widest ``bn``, then the widest Ci block (a narrower one
    only where a wide halo does not fit otherwise).  Only tiles whose
    shared memory fits are ranked; ``None`` if none does."""
    best = None
    for bn, cib, (bb, ty, tx) in itertools.product(SM90_BN, sm90_cibs(ci),
                                                   SM90_TILES):
        if bn > 64 and co <= bn // 2:
            continue
        lay = sm90_layout(bb, ty, tx, bn, cib, hk, wk, tuple(dilation))
        if not _sm90_fits(lay):
            continue
        ctas = (ceil_div(batch, bb) * ceil_div(ho, ty) * ceil_div(wo, tx)
                * ceil_div(co, bn))
        waves = ceil_div(ctas, SM_COUNT)
        halo = lay["hy"] * lay["hx"] / (ty * tx)
        key = (waves * bn, ctas * bn, halo, -bn, -cib)
        if best is None or key < best[0]:
            best = (key, Sm90Plan(**lay, ctas=ctas))
    return None if best is None else best[1]


def route(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
          lhs_dilation=(1, 1), *, bias: torch.Tensor | None = None,
          residual: torch.Tensor | None = None, dilation=(1, 1),
          pool: int = 1) -> str:
    """``"sm90"`` iff x, w, bias and residual (where given) are bf16,
    stride and lhs dilation are (1, 1) (any dilation and padding), Ci
    and Co are multiples of 8 (16-byte pixel and row pitches that a TMA
    map describes), every base address is 16-byte aligned, the fused
    pool is 1 or 2 (the sm90 epilogue pools 2 x 2 in registers) and a
    tile of :func:`sm90_plan` fits shared memory with at most
    ``SM90_MAX_WIN`` windows; else ``"fma"``.  Read from types,
    geometry and pointers only, before launch."""
    operands = [t for t in (x, w, bias, residual) if t is not None]
    ci, co = x.shape[-1], w.shape[-1]
    if (all(t.dtype == torch.bfloat16 for t in operands)
            and tuple(stride) == (1, 1) and tuple(lhs_dilation) == (1, 1)
            and ci % SM90_PLANE == 0 and co % SM90_PLANE == 0
            and all(t.data_ptr() % 16 == 0 for t in operands)
            and pool in (1, 2)
            and sm90_plan(1, 1, 1, co, ci, w.shape[0], w.shape[1],
                          tuple(dilation)) is not None):
        return "sm90"
    return "fma"


def _out_plane(h: int, wd: int, hk: int, wk: int, stride, padding,
               dilation, lhs_dilation) -> tuple[int, int]:
    """The conv's output plane ``(ho, wo)`` before the pool."""
    (sy, sx), (py, px) = stride, padding
    (dy, dx), (ly, lx) = dilation, lhs_dilation
    return (((h - 1) * ly + 1 + 2 * py - ((hk - 1) * dy + 1)) // sy + 1,
            ((wd - 1) * lx + 1 + 2 * px - ((wk - 1) * dx + 1)) // sx + 1)


def plan_of(x: torch.Tensor, w: torch.Tensor,
            bias: torch.Tensor | None = None,
            residual: torch.Tensor | None = None, *, stride=(1, 1),
            padding=(0, 0), dilation=(1, 1), lhs_dilation=(1, 1),
            pool: int = 1) -> tuple[str, Sm90Plan | tuple]:
    """The route :func:`conv_lb` takes for these operands and the plan
    its kernel then runs: an :class:`Sm90Plan` (``"sm90"``) or
    :func:`cta_plan`'s ``(bb, ty, tx, tn, krows)`` (``"fma"``).  Read
    from types, geometry and pointers only, before launch."""
    b, h, wd, ci = x.shape
    hk, wk, _, co = w.shape
    stride, padding = tuple(stride), tuple(padding)
    dilation, lhs_dilation = tuple(dilation), tuple(lhs_dilation)
    ho, wo = _out_plane(h, wd, hk, wk, stride, padding, dilation,
                        lhs_dilation)
    rt = route(x, w, stride, lhs_dilation, bias=bias, residual=residual,
               dilation=dilation, pool=pool)
    if rt == "sm90":
        return rt, sm90_plan(b, ho, wo, co, ci, hk, wk, dilation)
    return rt, cta_plan(b, ho, wo, co, pool, hk, wk, stride, dilation,
                        x.element_size())


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

    A CUDA ``x`` launches the kernel :func:`route` names; a CPU ``x``
    runs the plain version.  Any other device raises."""
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
    ho, wo = _out_plane(h, wd, hk, wk, stride, padding, dilation,
                        lhs_dilation)
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
    rt, plan = plan_of(x, w, bias, residual, stride=stride,
                       padding=padding, dilation=dilation,
                       lhs_dilation=lhs_dilation, pool=pool)
    if rt == "sm90":
        out = _sm90(x, w, bias, residual, ho, wo, (py, px), relu, pool,
                    plan)
    else:
        out = _fma(x, w, bias, residual, ho, wo, stride, padding, dilation,
                   lhs_dilation, relu, pool, plan)
    conv_lb.launches += 1
    conv_lb.launches_by_route[rt] += 1
    return out


def _launched(lib: Library, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.error_string(err)} (error {err})")


def _sm90(x, w, bias, residual, ho: int, wo: int, padding, relu: bool,
          pool: int, plan: Sm90Plan) -> torch.Tensor:
    """One launch of ``csrc/conv_lb_sm90.cu`` on the tile and offsets of
    ``plan``: :func:`sm90_plan`'s, or a wrong one that a check passes
    to show that the card's gate sees it."""
    b, h, wd, ci = x.shape
    hk, wk, _, co = w.shape
    lib, forward = _entry(SM90_SOURCE, "conv_lb_sm90_forward", 6, 25)
    out = torch.empty((b, ho // pool, wo // pool, co), dtype=x.dtype,
                      device=x.device)
    win_off = (ctypes.c_int * len(plan.win_off))(*plan.win_off)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = forward(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), ctypes.addressof(win_off), b, h, wd, ci, co, hk,
            wk, ho, wo, padding[0], padding[1], pool, int(relu), plan.bb,
            plan.ty, plan.tx, plan.hy, plan.hx, plan.bn, plan.cib,
            plan.plane_bytes, plan.sbo, plan.blk_off[0], plan.blk_off[1],
            plan.smem_bytes, stream)
    _launched(lib, err, "conv_lb_sm90")
    return out


def _fma(x, w, bias, residual, ho: int, wo: int, stride, padding,
         dilation, lhs_dilation, relu: bool, pool: int,
         plan: tuple[int, int, int, int, int]) -> torch.Tensor:
    """One launch of ``csrc/conv_lb.cu`` on ``plan``, the tile of
    :func:`cta_plan`."""
    b, h, wd, ci = x.shape
    hk, wk, _, co = w.shape
    (sy, sx), (py, px) = stride, padding
    (dy, dx), (ly, lx) = dilation, lhs_dilation
    elt = x.element_size()
    bb, ty, tx, tn, krows = plan
    smem = cta_smem_bytes(bb, ty, tx, tn, hk, wk, (sy, sx), (dy, dx),
                          pool, krows, elt)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"a {hk}x{wk} stride {stride} dilation "
                         f"{dilation} conv needs {smem} B of shared "
                         f"memory per CTA, more than the card's "
                         f"{SMEM_PER_BLOCK} B")
    lib, forward = _entry(SOURCE, "conv_lb_forward", 5, 29)
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
    _launched(lib, err, "conv_lb")
    return out


conv_lb.launches = 0
conv_lb.launches_by_route = dict.fromkeys(ROUTES, 0)
