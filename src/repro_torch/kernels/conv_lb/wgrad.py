"""The wgrad kernel's wrapper: build, bind and launch the two
hand-written CUDA kernels of K2, which together replace the TPU kernel
``_wgrad_kernel`` / ``wgrad_lb_call`` of
``repro/kernels/conv_lb/wgrad.py``:

  * ``csrc/wgrad_lb_sm90.cu`` (route ``"sm90"``): bf16 at stride 1 on
    the tensor cores, TMA into an mbarrier ring feeding ``wgmma``;
  * ``csrc/wgrad_lb.cu`` (route ``"fma"``): f32, and every bf16 wgrad
    :func:`route` does not send to the sm90 kernel, on FMA.

dW is the conv of the input with the incoming gradient as the kernel
plane (batch folds into the reduction):

  dW[ky, kx, ci, co] = sum_{b, oy, ox}
      x_pad[b, ky*dil + oy*stride, kx*dil + ox*stride, ci]
      * dy[b, oy, ox, co]

The libraries are built like the conv kernel's
(:func:`repro_torch.kernels.conv_lb.kernel.build`) and bound once
(``_entry``).  :func:`wgrad_lb` dispatches first on where its tensors
lie: a CUDA tensor launches the kernel :func:`route` names or raises; a
CPU tensor runs the plain version
(:func:`~repro_torch.kernels.conv_lb.ref.wgrad_ref`).  The route is
read from types, geometry and pointers before launch, never by trying
one; :func:`plan_of` names it with the plan its kernel runs.  Each
layer call that launches a kernel adds one to ``wgrad_lb.launches`` and
to its route's entry of ``wgrad_lb.launches_by_route``; a split
reduction's second pass adds one to ``wgrad_lb.reduce_launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
from functools import lru_cache
from pathlib import Path

import torch

from repro_torch.core.hopper_adapter import (HBM_BYTES_PER_S,
                                             PEAK_BF16_FLOPS,
                                             PEAK_F32_FLOPS, SM_COUNT,
                                             SMEM_PER_BLOCK)
from repro_torch.core.layer import ceil_div
from repro_torch.kernels.conv_lb.kernel import (CTAS_PER_SM, DTYPES,
                                                _aligned,
                                                _check_cuda_operand,
                                                _entry, _launched)
from repro_torch.kernels.conv_lb.ref import _pair, wgrad_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "wgrad_lb.cu"
SM90_SOURCE = Path(__file__).resolve().parent / "csrc" / "wgrad_lb_sm90.cu"

#: the FMA kernel's fixed CTA shape (must match csrc/wgrad_lb.cu)
TILE_M = 128        # dW rows (ky, kx, ci) per CTA
CHUNK = 16          # reduction pixels staged per step
MAX_SPLITS = 1024
ROUTES = ("sm90", "fma")

#: the sm90 kernel's fixed shape (must match csrc/wgrad_lb_sm90.cu): a K
#: step is an 8 x 8 block of output pixels of one image; two consumer
#: warpgroups each hold ``nwc`` row blocks of 64 dW rows x ``bn``
#: columns, at most 128 f32 sums a thread
SM90_BLOCK = 8
SM90_CONSUMERS = 2
SM90_ROWS = 64                 # dW rows of one row block (one wgmma M)
SM90_TILES = ((256, 1), (128, 1), (128, 2), (64, 1), (64, 3))  # (bn, nwc)
SM90_CIBS = (64, 128)          # channels of one halo (one Ci block)
SM90_MAX_STAGES = 8            # ring stages: a dy tile and a halo each
SM90_MAX_WIN = 128             # windows whose offsets a launch carries
SM90_BOX_MAX = 256             # a TMA box's extent in any dimension
#: pixel blocks a split range may hold (16,384 pixels, 1,024 k16
#: steps): a bound on the f32 sums the tensor cores carry in registers
SM90_MAX_RANGE = 256
#: planning assumption, not a measurement: the rate at which L2 serves
#: the SMs' TMA loads, taken as twice the HBM rate, spread over the SMs
SM90_FILL_BYTES_PER_S = 2 * HBM_BYTES_PER_S
#: planning assumption, not a measurement: the bytes a clock at which
#: wgmma reads its shared-memory operands (half the banks' 128), and the
#: clock at which the tensor cores reach their peak (4096 bf16
#: operations a clock per SM)
SM90_SMEM_BYTES_PER_CLOCK = 64
SM90_CLOCK_HZ = PEAK_BF16_FLOPS / (SM_COUNT * 4096)


@dataclasses.dataclass(frozen=True)
class WgradGeometry:
    """The forward conv a weight gradient belongs to."""

    hk: int
    wk: int
    stride: tuple[int, int] = (1, 1)
    padding: tuple[int, int] = (0, 0)
    dilation: tuple[int, int] = (1, 1)

    @classmethod
    def of(cls, geom) -> "WgradGeometry":
        """A :class:`WgradGeometry` passes through; a
        :class:`~repro_torch.kernels.conv_lb.ops.WgradPlan` gives its
        executing geometry."""
        if isinstance(geom, cls):
            return geom
        return cls(hk=geom.hk, wk=geom.wk, stride=(geom.sy, geom.sx),
                   padding=(geom.py, geom.px),
                   dilation=(geom.dly, geom.dlx))


@lru_cache(maxsize=4096)
def wgrad_split(m: int, co: int, k: int) -> tuple[int, int, int]:
    """The FMA kernel's own tiling ``(tn, splits, chunks_per_split)``
    for a dW of ``m`` = Hk*Wk*Ci rows x ``co`` columns reduced over
    ``k`` = B*Ho*Wo pixels.  ``tn`` is 128 where Co exceeds 64.  The
    split of the reduction minimizes a model of the time: waves of CTAs
    over the card's SMs x the pixel steps of one CTA, at the f32 FMA
    rate, plus the second pass's workspace bytes at the HBM rate; ties
    go to fewer splits."""
    tn = 64 if co <= 64 else 128
    tiles = ceil_div(m, TILE_M) * ceil_div(co, tn)
    chunks = ceil_div(k, CHUNK)
    slots = SM_COUNT * CTAS_PER_SM
    step_s = 2.0 * CHUNK * TILE_M * tn * slots / PEAK_F32_FLOPS
    best = None
    for splits in range(1, min(chunks, MAX_SPLITS) + 1):
        cps = ceil_div(chunks, splits)
        real = ceil_div(chunks, cps)       # no empty range
        if real != splits:
            continue
        t = ceil_div(tiles * splits, slots) * cps * step_s
        if splits > 1:
            t += 4.0 * (2 * splits + 1) * m * co / HBM_BYTES_PER_S
        if best is None or t < best[0]:
            best = (t, (tn, splits, cps))
    return best[1]


@dataclasses.dataclass(frozen=True)
class Sm90WgradPlan:
    """The sm90 wgrad kernel's tile, split and every shared-memory
    offset it is passed (bytes).  A CTA owns ``2 * nwc`` row blocks of
    one Ci block of ``cib`` channels, each a (64-channel slice, window)
    pair (slice-major), x ``bn`` output channels, over ``bps`` pixel
    blocks of the reduction.  The halo of one pixel block lies as
    ``cib / 64`` boxes ``[hy][hx][64 channels]``, ``sub_bytes`` apart,
    one 128-byte row per pixel with the 128-byte swizzle: A (64
    channels x 16 pixels) reads two K groups of 8 consecutive pixels of
    a halo row, the next output row one halo row further (the
    descriptor's stride offset, ``sbo``), and window ``(ky, kx)`` the
    same descriptor shifted by ``win_off[ky * wk + kx]``."""

    bn: int                    # dW columns (output channels) per CTA
    nwc: int                   # row blocks per consumer
    cib: int                   # input channels per Ci block (halo)
    stages: int                # ring depth
    hy: int                    # halo box rows
    hx: int                    # halo box columns
    sub_bytes: int             # one 64-channel halo box
    sbo: int                   # A's stride offset (one halo row)
    win_off: tuple[int, ...]   # window ky * wk + kx -> shift in the halo
    smem_bytes: int
    nblk: int                  # pixel blocks of the reduction
    splits: int                # contiguous ranges of pixel blocks
    bps: int                   # pixel blocks per range
    tiles: int                 # CTAs per range
    ws_bytes: int              # the second pass's workspace

    @property
    def ctas(self) -> int:
        return self.tiles * self.splits

    @property
    def tile(self) -> tuple[int, int, int, int]:
        """``(bn, nwc, cib, splits)``."""
        return self.bn, self.nwc, self.cib, self.splits


def sm90_wgrad_layout(bn: int, nwc: int, cib: int, hk: int, wk: int,
                      dilation: tuple[int, int]) -> dict:
    """The halo box, the ring depth and the shared-memory offsets of one
    tile: the ring (a ``bn`` x 64-pixel dy tile, then ``cib / 64`` halo
    boxes of 1024-byte multiples, per stage) from a 1024-byte line, a
    full and an empty mbarrier per stage; as many stages as fit, up to
    ``SM90_MAX_STAGES``."""
    dy, dx = dilation
    hy = SM90_BLOCK + (hk - 1) * dy
    hx = SM90_BLOCK + (wk - 1) * dx
    sub = ceil_div(hy * hx * 128, 1024) * 1024
    win = tuple((ky * dy * hx + kx * dx) * 128
                for ky in range(hk) for kx in range(wk))
    stage = bn * SM90_BLOCK * SM90_BLOCK * 2 + (cib // SM90_ROWS) * sub
    stages = min(SM90_MAX_STAGES, (SMEM_PER_BLOCK - 1024) // (stage + 16))
    return dict(bn=bn, nwc=nwc, cib=cib, stages=stages, hy=hy, hx=hx,
                sub_bytes=sub, sbo=hx * 128, win_off=win,
                smem_bytes=1024 + stages * (stage + 16))


def _sm90_fits(lay: dict) -> bool:
    return (lay["stages"] >= 2 and lay["smem_bytes"] <= SMEM_PER_BLOCK
            and len(lay["win_off"]) <= SM90_MAX_WIN
            and max(lay["hy"], lay["hx"]) <= SM90_BOX_MAX)


@lru_cache(maxsize=4096)
def sm90_wgrad_plan(batch: int, ho: int, wo: int, ci: int, co: int,
                    hk: int = 1, wk: int = 1,
                    dilation: tuple[int, int] = (1, 1),
                    only: tuple[int, int, int] | None = None
                    ) -> Sm90WgradPlan | None:
    """The sm90 wgrad kernel's tile and split for one stride-1 conv
    (one CTA per SM), minimizing a model of the time: waves of CTAs
    over the card's SMs x (the pixel blocks of one range x the time of
    one block + the tile's store), a block's time the largest of its
    ``wgmma`` work at the bf16 tensor-core rate, the shared memory those
    ``wgmma`` read (A and B for each) and TMA writes at
    ``SM90_SMEM_BYTES_PER_CLOCK``, and its ring stage at
    ``SM90_FILL_BYTES_PER_S``; plus the second pass's workspace bytes
    (written once, read once, dW written) at the HBM rate.  Row blocks
    past a Ci block's last (its window count not a multiple of the
    CTA's) cost their work too.  Ranges hold at most
    ``SM90_MAX_RANGE`` pixel blocks; ties go to fewer splits, then to
    the widest ``bn``.  ``only`` = ``(bn, nwc, cib)`` ranks the splits
    of that one tile.  ``None`` if no tile fits shared memory."""
    nwin = hk * wk
    nblk = batch * ceil_div(ho, SM90_BLOCK) * ceil_div(wo, SM90_BLOCK)
    m = nwin * ci
    per_sm_flops = PEAK_BF16_FLOPS / SM_COUNT
    per_sm_fill = SM90_FILL_BYTES_PER_S / SM_COUNT
    best = None
    for (bn, nwc), cib in itertools.product(SM90_TILES, SM90_CIBS):
        if only is not None and (bn, nwc, cib) != tuple(only):
            continue
        if only is None and ((bn > 64 and co <= bn // 2)
                             or (cib > 64 and ci <= 64)):
            continue
        lay = sm90_wgrad_layout(bn, nwc, cib, hk, wk, tuple(dilation))
        if not _sm90_fits(lay):
            continue
        rows = SM90_CONSUMERS * nwc * SM90_ROWS
        ngrp = ceil_div(nwin * cib // SM90_ROWS, SM90_CONSUMERS * nwc)
        tiles = ceil_div(ci, cib) * ngrp * ceil_div(co, bn)
        stage = bn * SM90_BLOCK * SM90_BLOCK * 2 + (
            cib // SM90_ROWS) * lay["sub_bytes"]
        wgmmas = SM90_CONSUMERS * nwc * SM90_BLOCK // 2
        smem_s = ((wgmmas * (SM90_ROWS + bn) * 16 * 2 + stage)
                  / (SM90_SMEM_BYTES_PER_CLOCK * SM90_CLOCK_HZ))
        step_s = max(2.0 * SM90_BLOCK ** 2 * rows * bn / per_sm_flops,
                     smem_s, stage / per_sm_fill)
        store_s = 4.0 * rows * bn / per_sm_fill
        for splits in range(ceil_div(nblk, SM90_MAX_RANGE),
                            min(nblk, MAX_SPLITS) + 1):
            bps = ceil_div(nblk, splits)
            if ceil_div(nblk, bps) != splits:      # no empty range
                continue
            ws = 4 * splits * m * co if splits > 1 else 0
            t = ceil_div(tiles * splits, SM_COUNT) * (bps * step_s
                                                      + store_s)
            t += (2 * ws + 4 * m * co * (splits > 1)) / HBM_BYTES_PER_S
            key = (t, splits, -bn, -cib)
            if best is None or key < best[0]:
                best = (key, Sm90WgradPlan(
                    **lay, nblk=nblk, splits=splits, bps=bps, tiles=tiles,
                    ws_bytes=ws))
    return None if best is None else best[1]


def _out_plane(x: torch.Tensor, g: WgradGeometry) -> tuple[int, int]:
    (sy, sx), (py, px), (dly, dlx) = (_pair(g.stride), _pair(g.padding),
                                      _pair(g.dilation))
    _, h, wd, _ = x.shape
    return ((h + 2 * py - ((g.hk - 1) * dly + 1)) // sy + 1,
            (wd + 2 * px - ((g.wk - 1) * dlx + 1)) // sx + 1)


def route(x: torch.Tensor, dy: torch.Tensor, geom) -> str:
    """``"sm90"`` iff x and dy are bf16, the stride is (1, 1) (any
    dilation and padding), Ci and Co are multiples of 8 (16-byte pixel
    pitches that a TMA map describes), both base addresses are 16-byte
    aligned and a tile of :func:`sm90_wgrad_plan` fits shared memory
    with at most ``SM90_MAX_WIN`` windows; else ``"fma"``.  Read from
    types, geometry and pointers only, before launch."""
    g = WgradGeometry.of(geom)
    ci, co = x.shape[-1], dy.shape[-1]
    if (x.dtype == torch.bfloat16 and dy.dtype == torch.bfloat16
            and _pair(g.stride) == (1, 1)
            and ci % 8 == 0 and co % 8 == 0
            and x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
            and sm90_wgrad_plan(1, 1, 1, ci, co, g.hk, g.wk,
                                _pair(g.dilation)) is not None):
        return "sm90"
    return "fma"


def plan_of(x: torch.Tensor, dy: torch.Tensor, geom
            ) -> tuple[str, Sm90WgradPlan | tuple[int, int, int]]:
    """The route :func:`wgrad_lb` takes for these operands and the plan
    its kernel then runs: a :class:`Sm90WgradPlan` (``"sm90"``) or
    :func:`wgrad_split`'s ``(tn, splits, chunks_per_split)``
    (``"fma"``).  Read from types, geometry and pointers only, before
    launch."""
    g = WgradGeometry.of(geom)
    b, _, _, ci = x.shape
    co = dy.shape[-1]
    ho, wo = _out_plane(x, g)
    rt = route(x, dy, g)
    if rt == "sm90":
        return rt, sm90_wgrad_plan(b, ho, wo, ci, co, g.hk, g.wk,
                                   _pair(g.dilation))
    return rt, wgrad_split(g.hk * g.wk * ci, co, b * ho * wo)


def wgrad_lb(x: torch.Tensor, dy: torch.Tensor, geom) -> torch.Tensor:
    """dW (Hk, Wk, Ci, Co) f32 of one group of the conv x (B, H, W, Ci)
    -> dy (B, Ho, Wo, Co), x and dy f32 or bf16 (one type; sums in
    f32); ``geom`` a :class:`WgradGeometry` or a
    :class:`~repro_torch.kernels.conv_lb.ops.WgradPlan`.

    A CUDA ``x`` launches the kernel :func:`route` names; a CPU ``x``
    runs the plain version.  Any other device raises."""
    g = WgradGeometry.of(geom)
    sy, sx = _pair(g.stride)
    py, px = _pair(g.padding)
    dly, dlx = _pair(g.dilation)
    if x.device.type == "cpu":
        return wgrad_ref(x, dy, g.hk, g.wk, stride=(sy, sx),
                         padding=(py, px), dilation=(dly, dlx))
    if x.device.type != "cuda":
        raise ValueError(f"the wgrad kernel runs on CUDA tensors (or its "
                         f"plain version on CPU ones), not {x.device}")
    if min(sy, sx, dly, dlx) < 1 or min(py, px) < 0:
        raise ValueError("stride and dilation must be >= 1 and padding "
                         ">= 0")
    b, h, wd, ci = x.shape
    ho, wo = _out_plane(x, g)
    if ho < 1 or wo < 1:
        raise ValueError(f"{g.hk}x{g.wk} conv has no output on a "
                         f"{h}x{wd} plane")
    co = dy.shape[-1]
    _check_cuda_operand("x", x, x.device, (b, h, wd, ci), x.dtype)
    _check_cuda_operand("dy", dy, x.device, (b, ho, wo, co), x.dtype)
    m, k = g.hk * g.wk * ci, b * ho * wo
    if max(m, k) >= 2 ** 31:
        raise ValueError(f"wgrad of {m} x {co} over {k} pixels exceeds "
                         f"the kernel's index range")
    rt, plan = plan_of(x, dy, g)
    if rt == "sm90":
        dw = _sm90(x, dy, g, plan)
        splits = plan.splits
    else:
        dw = _fma(x, dy, g, plan)
        splits = plan[1]
    wgrad_lb.launches += 1
    wgrad_lb.launches_by_route[rt] += 1
    if splits > 1:
        wgrad_lb.reduce_launches += 1
    return dw


def _sm90(x: torch.Tensor, dy: torch.Tensor, g: WgradGeometry,
          plan: Sm90WgradPlan) -> torch.Tensor:
    """One launch of ``csrc/wgrad_lb_sm90.cu`` (and its second pass) on
    the tile, split and offsets of ``plan``: :func:`sm90_wgrad_plan`'s,
    or a wrong one that a check passes to show that the card's gate
    sees it."""
    b, h, wd, ci = x.shape
    _, ho, wo, co = dy.shape
    py, px = _pair(g.padding)
    lib, forward = _entry(SM90_SOURCE, "wgrad_lb_sm90_forward", 5, 22)
    dw = torch.empty((g.hk, g.wk, ci, co), dtype=torch.float32,
                     device=x.device)
    ws = (torch.empty((plan.splits, g.hk * g.wk * ci, co),
                      dtype=torch.float32, device=x.device)
          if plan.splits > 1 else None)
    win_off = (ctypes.c_int * len(plan.win_off))(*plan.win_off)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = forward(
            x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
            None if ws is None else ws.data_ptr(), ctypes.addressof(win_off),
            b, h, wd, ci, co, g.hk, g.wk, ho, wo, py, px, plan.hy, plan.hx,
            plan.bn, plan.nwc, plan.cib, plan.stages, plan.sub_bytes,
            plan.sbo, plan.splits, plan.bps, plan.smem_bytes, stream)
    _launched(lib, err, "wgrad_lb_sm90")
    return dw


def _fma(x: torch.Tensor, dy: torch.Tensor, g: WgradGeometry,
         plan: tuple[int, int, int]) -> torch.Tensor:
    """One launch of ``csrc/wgrad_lb.cu`` (and its second pass) on
    ``plan``, the tiling of :func:`wgrad_split`."""
    b, h, wd, ci = x.shape
    _, ho, wo, co = dy.shape
    (sy, sx), (py, px), (dly, dlx) = (_pair(g.stride), _pair(g.padding),
                                      _pair(g.dilation))
    tn, splits, cps = plan
    lib, forward = _entry(SOURCE, "wgrad_lb_forward", 4, 22)
    dw = torch.empty((g.hk, g.wk, ci, co), dtype=torch.float32,
                     device=x.device)
    ws = (torch.empty((splits, g.hk * g.wk * ci, co), dtype=torch.float32,
                      device=x.device) if splits > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = forward(
            x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
            None if ws is None else ws.data_ptr(),
            b, h, wd, ci, co, g.hk, g.wk, ho, wo, sy, sx, dly, dlx, py, px,
            tn, splits, cps, _aligned(x), _aligned(dy),
            _aligned(dw) and (ws is None or _aligned(ws)),
            DTYPES[x.dtype], stream)
    _launched(lib, err, "wgrad_lb")
    return dw


wgrad_lb.launches = 0
wgrad_lb.launches_by_route = dict.fromkeys(ROUTES, 0)
wgrad_lb.reduce_launches = 0
