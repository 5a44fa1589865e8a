"""The wgrad kernel's wrapper: build, bind and launch the hand-written
CUDA kernels of K2, which together replace the TPU kernel
``_wgrad_kernel`` / ``wgrad_lb_call`` of
``repro/kernels/conv_lb/wgrad.py``:

  * ``csrc/wgrad_lb_sm90.cu`` (route ``"sm90"``): bf16 at stride 1 on
    the tensor cores, TMA into an mbarrier ring feeding ``wgmma``;
  * ``csrc/wgrad_lb_sm90_tf32.cu`` (route ``"sm90_tf32"``): f32 at any
    stride on the tensor cores in 3xTF32, A (x) from registers (a
    strided halo as one box per residue), B (dy) rewritten once per
    pixel block into K-major hi and lo tiles;
  * ``csrc/wgrad_im2col.cu`` (route ``"sm90_im2col"``): a channel
    count too small for a TMA map (VGG16's conv1_1, Ci = 3) staged as
    an im2col plane of ``Cp`` <= 64 channels
    (:mod:`~repro_torch.kernels.conv_lb.im2col`, shared with K1), then
    one of the two tensor-core kernels above on it as a 1x1 wgrad;
  * ``csrc/wgrad_lb.cu`` (route ``"fma"``): bf16 strides, and what no
    tensor-core route takes, on FMA.

dW is the conv of the input with the incoming gradient as the kernel
plane (batch folds into the reduction):

  dW[ky, kx, ci, co] = sum_{b, oy, ox}
      x_pad[b, ky*dil + oy*stride, kx*dil + ox*stride, ci]
      * dy[b, oy, ox, co]

The libraries are built like the conv kernel's
(:mod:`repro_torch.kernels.nvcc`) and bound once (``_entry``).  :func:`wgrad_lb` dispatches first on where its tensors
lie: a CUDA tensor launches the kernel :func:`route` names or raises; a
CPU tensor runs the plain version
(:func:`~repro_torch.kernels.conv_lb.ref.wgrad_ref`).  The route is
read from types, geometry and pointers before launch, never by trying
one, and read once per geometry key (:func:`lookup`); :func:`plan_of`
names it with the plan its kernel runs.  Each
layer call that launches a kernel adds one to ``wgrad_lb.launches`` and
to its route's entry of ``wgrad_lb.launches_by_route``; a split
reduction's second pass adds one to ``wgrad_lb.reduce_launches``; the
im2col staging kernel adds one to ``wgrad_lb.stage_launches`` where it
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
from functools import lru_cache
from pathlib import Path

import torch

from repro_torch.analysis.plan_check import (LaunchFacts, TmaMap,
                                             tile_fits)
from repro_torch.core.hopper_adapter import (GRID_YZ_MAX, HBM_BYTES_PER_S,
                                             PEAK_BF16_FLOPS,
                                             PEAK_F32_FLOPS,
                                             PEAK_TF32_FLOPS, SM_COUNT,
                                             SMEM_PER_BLOCK)
from repro_torch.core.layer import ceil_div
from repro_torch.kernels.conv_lb.im2col import (Im2colPlan, _c_ints,
                                                im2col_channels,
                                                im2col_taps, stage,
                                                stage_facts, stage_fits)
from repro_torch.kernels.conv_lb.kernel import (CTAS_PER_SM, DTYPES,
                                                MIN_BLOCKS, SM90_THREADS,
                                                TF32_MAX_PARTS,
                                                TF32_MAX_STRIDE, THREADS,
                                                _aligned,
                                                _check_cuda_operand,
                                                _launched, aligned,
                                                operand_type, tf32_parts)
from repro_torch.kernels.conv_lb.ref import _pair, wgrad_ref
from repro_torch.kernels.lean import LaunchCache, on_device, operand_key
from repro_torch.kernels.nvcc import _entry, _entry_struct

SOURCE = Path(__file__).resolve().parent / "csrc" / "wgrad_lb.cu"
SM90_SOURCE = Path(__file__).resolve().parent / "csrc" / "wgrad_lb_sm90.cu"
TF32_SOURCE = (Path(__file__).resolve().parent / "csrc"
               / "wgrad_lb_sm90_tf32.cu")

#: the FMA kernel's fixed CTA shape (must match csrc/wgrad_lb.cu)
TILE_M = 128        # dW rows (ky, kx, ci) per CTA
CHUNK = 16          # reduction pixels staged per step
MAX_SPLITS = 1024
#: the tensor-core kernels' grid runs one z index a split range
GRID_Z_MAX = GRID_YZ_MAX
ROUTES = ("sm90", "sm90_tf32", "sm90_im2col", "fma")

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

#: the 3xTF32 kernel's fixed shape (must match csrc/wgrad_lb_sm90_tf32.cu):
#: the same 8 x 8 pixel blocks and two consumer warpgroups; a consumer
#: holds ``nwc`` row blocks of 64 dW rows x ``bn`` columns and its A
#: fragments in four buffers (8 registers a row block a step), so
#: ``nwc * bn / 2 + 32 * nwc`` <= 128; halo and dy boxes are 32 f32
#: channels (one 128-byte swizzled row); three producer-warpgroup warps
#: rewrite each dy tile into K-major hi and lo tiles, a ring of two
#: stages
TF32_TILES = ((128, 1), (64, 2), (64, 1))     # (bn, nwc)
TF32_CIBS = (32, 64, 128)      # channels of one halo (one Ci block)
TF32_BOX = 32                  # channels of one halo or dy box
TF32_CPRS = (16, 32, 64)       # channels of one window in a row block
TF32_TRANSPOSERS = 3
TF32_BSTAGES = 2
#: 3xTF32: three tensor-core products per multiply-add
TF32_PRODUCTS = 3
#: pixel blocks a 3xTF32 split range may hold (4,096 pixels): three
#: products a k8 step add six times as often to the f32 sums as the bf16
#: kernel's k16 steps, and their drift grows with a range's length
#: (conv1_2 at batch 8: 7.0e-5 of max |dW| at 143 blocks, 4.6e-5 at 98)
TF32_MAX_RANGE = 64


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


def _sm90_tile(lay: dict) -> dict:
    """The sm90 wgrad kernel's TMA boxes (a 64-channel halo box, a 64
    channel x 8 x 8 dy box), ring and argument arrays at one layout
    (:func:`sm90_wgrad_layout`'s dict, or a :class:`Sm90WgradPlan`'s
    ``vars``)."""
    return dict(boxes=((64, lay["hx"], lay["hy"], 1),
                       (64, SM90_BLOCK, SM90_BLOCK, 1)),
                stages=lay["stages"],
                args=(("windows", len(lay["win_off"]), SM90_MAX_WIN),))


def _sm90_fits(lay: dict) -> bool:
    return tile_fits(lay["smem_bytes"], **_sm90_tile(lay))


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
        for t, splits, bps, ws in _splits(nblk, tiles, step_s, store_s,
                                          m, co, SM90_MAX_RANGE):
            key = (t, splits, -bn, -cib)
            if best is None or key < best[0]:
                best = (key, Sm90WgradPlan(
                    **lay, nblk=nblk, splits=splits, bps=bps, tiles=tiles,
                    ws_bytes=ws))
    return None if best is None else best[1]


def _splits(nblk: int, tiles: int, step_s: float, store_s: float, m: int,
            co: int, max_range: int):
    """Every split of ``nblk`` pixel blocks into contiguous ranges of at
    most ``max_range`` blocks, none empty, as ``(t, splits, bps,
    ws_bytes)``: ``t`` the tensor-core kernels' model of the time, waves
    of ``tiles * splits`` CTAs (one per SM) x (the blocks of one range x
    ``step_s`` + ``store_s``), plus the second pass's workspace bytes
    (written once, read once, dW written) at the HBM rate.  Up to
    ``MAX_SPLITS`` ranges are ranked; where the range cap needs more (a
    large batch: VGG16/224's conv1_2 in f32 from batch 84), only the
    fewest it allows, as long as a range is a grid z index
    (``GRID_Z_MAX``); none past that."""
    least = ceil_div(nblk, max_range)
    for splits in range(least, min(nblk, max(least, MAX_SPLITS),
                                   GRID_Z_MAX) + 1):
        bps = ceil_div(nblk, splits)
        if ceil_div(nblk, bps) != splits:      # no empty range
            continue
        ws = 4 * splits * m * co if splits > 1 else 0
        t = ceil_div(tiles * splits, SM_COUNT) * (bps * step_s + store_s)
        t += (2 * ws + 4 * m * co * (splits > 1)) / HBM_BYTES_PER_S
        yield t, splits, bps, ws


@dataclasses.dataclass(frozen=True)
class Sm90Tf32Plan:
    """The 3xTF32 wgrad kernel's tile, split and shared-memory offsets
    (bytes).  A CTA owns ``2 * nwc`` row blocks of one Ci block of
    ``cib`` channels x ``bn`` output channels over ``bps`` pixel blocks.
    A row block is 64 rows: ``cpr`` channels of each of ``64 / cpr``
    windows (a window group), of one channel slice; row blocks run
    slice-major.  The halo of one pixel block lies as ``cib / 32``
    slices, ``sub_bytes`` apart, each ``len(parts)`` boxes
    ``[hy][hx][32 channels]``, ``part_bytes`` apart, one 128-byte
    swizzled row per pixel; a box is loaded at the traversal stride
    ``es`` (its extent in the tensor ``hy * es`` by ``hx * es``) from
    the block's origin times the stride plus its residue.  Pixel (r, c)
    of a block reads
    ``r * row_step + c * 128`` into the halo, window ``(ky, kx)``
    shifted by ``win_off[ky * wk + kx]``."""

    bn: int                    # dW columns (output channels) per CTA
    nwc: int                   # row blocks per consumer
    cib: int                   # input channels per Ci block (halo)
    cpr: int                   # channels of one window in a row block
    stages: int                # TMA ring depth
    hy: int                    # halo box rows
    hx: int                    # halo box columns
    sub_bytes: int             # one 32-channel slice of the halo
    win_off: tuple[int, ...]   # window ky * wk + kx -> shift in the halo
    smem_bytes: int
    nblk: int                  # pixel blocks of the reduction
    splits: int                # contiguous ranges of pixel blocks
    bps: int                   # pixel blocks per range
    tiles: int                 # CTAs per range
    ws_bytes: int              # the second pass's workspace
    parts: tuple[tuple[int, int], ...]   # each box's residue (ry, rx)
    part_bytes: int            # one box (a 1024-byte multiple)
    row_step: int              # bytes between a block's pixel rows
    es: tuple[int, int]        # the x map's traversal strides
    stride: tuple[int, int]    # x rows, columns a dy row, column moves

    @property
    def ctas(self) -> int:
        return self.tiles * self.splits

    @property
    def tile(self) -> tuple[int, int, int, int]:
        """``(bn, nwc, cib, splits)``."""
        return self.bn, self.nwc, self.cib, self.splits


def sm90_tf32_wgrad_layout(bn: int, nwc: int, cib: int, ci: int, hk: int,
                           wk: int, dilation: tuple[int, int],
                           stride: tuple[int, int] = (1, 1)) -> dict:
    """The halo box, the row-block shape, the ring depth and the
    shared-memory offsets of one 3xTF32 tile: from a 1024-byte line the
    TMA ring (per stage a 64-pixel x ``bn`` dy tile, then ``cib / 32``
    halo boxes of 1024-byte multiples), the B ring (``TF32_BSTAGES``
    stages of a hi and a lo tile, each 64 pixels x ``bn`` words), then a
    full and an empty mbarrier per stage of each ring; as many TMA
    stages as fit, up to ``SM90_MAX_STAGES``.  ``cpr``, the channels of
    one window in a row block, is the next power of two of ``ci`` from
    16 up to ``cib`` and 64.  At stride (sy, sx) the halo of a slice is
    one box per residue of K1's
    :func:`~repro_torch.kernels.conv_lb.kernel.tf32_parts`, each at the
    traversal stride, as K1 lays out its halo."""
    (dy, dx), (sy, sx) = dilation, stride
    parts = tf32_parts(hk, wk, dilation, stride)
    hy = SM90_BLOCK + (hk - 1) * dy // sy
    hx = SM90_BLOCK + (wk - 1) * dx // sx
    part = ceil_div(hy * hx * 128, 1024) * 1024
    index = {r: i for i, r in enumerate(parts)}
    win = tuple(index[ky * dy % sy, kx * dx % sx] * part
                + ((ky * dy // sy) * hx + kx * dx // sx) * 128
                for ky in range(hk) for kx in range(wk))
    sub = len(parts) * part
    tile = bn * SM90_BLOCK * SM90_BLOCK * 4
    stage = tile + (cib // TF32_BOX) * sub
    fixed = 1024 + TF32_BSTAGES * (2 * tile + 16)
    stages = min(SM90_MAX_STAGES, (SMEM_PER_BLOCK - fixed) // (stage + 16))
    cpr = min(cib, 64, max(16, 1 << (ci - 1).bit_length()))
    return dict(bn=bn, nwc=nwc, cib=cib, cpr=cpr, stages=stages, hy=hy,
                hx=hx, sub_bytes=sub, win_off=win,
                smem_bytes=fixed + stages * (stage + 16), parts=parts,
                part_bytes=part, row_step=hx * 128, es=(sy, sx),
                stride=(sy, sx))


def _tf32_tile(lay: dict) -> dict:
    """The 3xTF32 wgrad kernel's TMA boxes (a 32-channel halo box, its
    extent ``hy * es`` by ``hx * es`` traversed at ``es``; a 32-channel
    x 8 x 8 dy box), ring and argument arrays at one layout
    (:func:`sm90_tf32_wgrad_layout`'s dict, or an :class:`Sm90Tf32Plan`'s
    ``vars``)."""
    esy, esx = lay["es"]
    return dict(boxes=((TF32_BOX, lay["hx"] * esx, lay["hy"] * esy, 1),
                       (TF32_BOX, SM90_BLOCK, SM90_BLOCK, 1)),
                elems=((1, esx, esy, 1), ()), stages=lay["stages"],
                args=(("windows", len(lay["win_off"]), SM90_MAX_WIN),
                      ("halo boxes", len(lay["parts"]), TF32_MAX_PARTS)))


def _tf32_fits(lay: dict) -> bool:
    return tile_fits(lay["smem_bytes"], **_tf32_tile(lay))


@lru_cache(maxsize=4096)
def sm90_tf32_wgrad_plan(batch: int, ho: int, wo: int, ci: int, co: int,
                         hk: int = 1, wk: int = 1,
                         dilation: tuple[int, int] = (1, 1),
                         only: tuple[int, int, int] | None = None,
                         stride: tuple[int, int] = (1, 1)
                         ) -> Sm90Tf32Plan | None:
    """The 3xTF32 wgrad kernel's tile and split for one f32 conv at
    ``stride`` (one CTA per SM), on :func:`sm90_wgrad_plan`'s model of the
    time: a pixel block's time the largest of its ``wgmma`` work (three
    products a multiply-add, rows past the last included) at the TF32
    tensor-core rate, the shared memory it moves at
    ``SM90_SMEM_BYTES_PER_CLOCK`` (B read by each of the three products
    of each row block and k8 step, the A fragments' loads, the dy tile's
    rewrite into hi and lo, TMA's writes), and its ring stage at
    ``SM90_FILL_BYTES_PER_S``.  Ranges hold at most ``TF32_MAX_RANGE``
    pixel blocks; ties go to fewer splits, then to the widest ``bn``.
    ``only`` = ``(bn, nwc, cib)`` ranks the splits of that one tile.
    ``None`` if no tile fits shared memory."""
    nwin = hk * wk
    nblk = batch * ceil_div(ho, SM90_BLOCK) * ceil_div(wo, SM90_BLOCK)
    m = nwin * ci
    per_sm_flops = PEAK_TF32_FLOPS / SM_COUNT
    per_sm_fill = SM90_FILL_BYTES_PER_S / SM_COUNT
    smem_rate = SM90_SMEM_BYTES_PER_CLOCK * SM90_CLOCK_HZ
    px = SM90_BLOCK * SM90_BLOCK
    best = None
    for (bn, nwc), cib in itertools.product(TF32_TILES, TF32_CIBS):
        if only is not None and (bn, nwc, cib) != tuple(only):
            continue
        if only is None and ((bn > 64 and co <= bn // 2)
                             or (cib > 32 and ci <= cib // 2)):
            continue
        lay = sm90_tf32_wgrad_layout(bn, nwc, cib, ci, hk, wk,
                                     tuple(dilation), tuple(stride))
        if not _tf32_fits(lay):
            continue
        cpr = lay["cpr"]
        nrb = ceil_div(min(cib, ci), cpr) * ceil_div(nwin, 64 // cpr)
        ngrp = ceil_div(nrb, SM90_CONSUMERS * nwc)
        tiles = ceil_div(ci, cib) * ngrp * ceil_div(co, bn)
        rows = SM90_CONSUMERS * nwc * SM90_ROWS
        stage = bn * px * 4 + (cib // TF32_BOX) * lay["sub_bytes"]
        steps = SM90_CONSUMERS * nwc * SM90_BLOCK     # row block x k8
        moved = (steps * (TF32_PRODUCTS * 8 * bn * 4 + SM90_ROWS * 8 * 4)
                 + px * bn * 12 + stage)
        step_s = max(TF32_PRODUCTS * 2.0 * px * rows * bn / per_sm_flops,
                     moved / smem_rate, stage / per_sm_fill)
        store_s = 4.0 * rows * bn / per_sm_fill
        for t, splits, bps, ws in _splits(nblk, tiles, step_s, store_s,
                                          m, co, TF32_MAX_RANGE):
            key = (t, splits, -bn, -cib)
            if best is None or key < best[0]:
                best = (key, Sm90Tf32Plan(
                    **lay, nblk=nblk, splits=splits, bps=bps, tiles=tiles,
                    ws_bytes=ws))
    return None if best is None else best[1]


def _im2col_inner(dtype: torch.dtype, batch: int, ho: int, wo: int,
                  cp: int, co: int):
    """The plan of the plane's 1x1 wgrad on the tensor-core kernel of
    ``dtype``."""
    plan = (sm90_wgrad_plan if dtype == torch.bfloat16
            else sm90_tf32_wgrad_plan)
    return plan(batch, ho, wo, cp, co, 1, 1, (1, 1))


def _out_plane(xshape, g: WgradGeometry) -> tuple[int, int]:
    (sy, sx), (py, px), (dly, dlx) = (_pair(g.stride), _pair(g.padding),
                                      _pair(g.dilation))
    _, h, wd, _ = xshape
    return ((h + 2 * py - ((g.hk - 1) * dly + 1)) // sy + 1,
            (wd + 2 * px - ((g.wk - 1) * dlx + 1)) // sx + 1)


def route(x: torch.Tensor, dy: torch.Tensor, geom) -> str:
    """The kernel a wgrad runs on, read from types, geometry and
    pointers only, before launch.  The tensor-core routes need x and dy
    of one type (any dilation and padding) and both base addresses
    16-byte aligned; then, with ``pitch`` 8 channels in bf16 and 4 in
    f32 (16-byte pixels that a TMA map describes) and Co a multiple of
    it:

      * ``"sm90"``: bf16, stride (1, 1), Ci a multiple of 8, and
        :func:`sm90_wgrad_plan` finds a tile that fits shared memory
        with at most ``SM90_MAX_WIN`` windows and a split of this call's
        reduction;
      * ``"sm90_tf32"``: f32 at any stride up to ``TF32_MAX_STRIDE``, Ci
        a multiple of 4, and :func:`sm90_tf32_wgrad_plan` finds the
        same;
      * ``"sm90_im2col"``: stride (1, 1), Ci not a multiple of ``pitch`` and
        Hk*Wk*Ci <= ``im2col.IM2COL_MAX`` (VGG16's conv1_1: 27), staged as an
        im2col plane of :func:`im2col_channels` channels (where the
        staging kernel takes the plane: ``stage_fits``) whose 1x1 wgrad
        the tensor-core kernel of its type plans likewise.

    Everything else (bf16 strides, misaligned or mixed operands, channel
    counts no staging fits, a reduction no split of ranges of at most
    ``SM90_MAX_RANGE`` or ``TF32_MAX_RANGE`` pixel blocks covers)
    ``"fma"``."""
    return plan_of(x, dy, geom)[0]


def plan_of(x: torch.Tensor, dy: torch.Tensor, geom
            ) -> tuple[str, Sm90WgradPlan | Sm90Tf32Plan | Im2colPlan
                       | tuple[int, int, int]]:
    """The route :func:`wgrad_lb` takes for these operands and the plan
    its kernel then runs, both at this call's size: a
    :class:`Sm90WgradPlan` (``"sm90"``), a :class:`Sm90Tf32Plan`
    (``"sm90_tf32"``), an :class:`Im2colPlan` (``"sm90_im2col"``) or
    :func:`wgrad_split`'s ``(tn, splits, chunks_per_split)``
    (``"fma"``): :func:`launch_plan` of their types, shapes and
    alignment, read before launch."""
    return launch_plan(operand_type(x, dy), tuple(x.shape), dy.shape[-1],
                       WgradGeometry.of(geom), aligned(x, dy))


@lru_cache(maxsize=4096)
def launch_plan(dtype: torch.dtype | None, xshape: tuple, co: int,
                g: WgradGeometry, aligned: bool = True):
    """The shape-only core of :func:`route` and :func:`plan_of`: the
    route and plan of the weight gradient of x ``xshape`` against a dy
    of ``co`` channels in geometry ``g``, x and dy of type ``dtype``
    (``None``: of two types), both bases 16-byte ``aligned``."""
    dt = dtype
    b, _, _, ci = xshape
    ho, wo = _out_plane(xshape, g)
    plan = None
    pitch = 8 if dt == torch.bfloat16 else 4
    stride = _pair(g.stride)
    f32_strided = (dt == torch.float32 and stride != (1, 1)
                   and max(stride) <= TF32_MAX_STRIDE)
    if (dt in (torch.bfloat16, torch.float32)
            and (stride == (1, 1) or f32_strided) and aligned
            and co % pitch == 0):
        dil = _pair(g.dilation)
        if ci % pitch == 0:
            if dt == torch.bfloat16:
                rt, plan = "sm90", sm90_wgrad_plan(b, ho, wo, ci, co, g.hk,
                                                   g.wk, dil)
            else:
                rt, plan = "sm90_tf32", sm90_tf32_wgrad_plan(
                    b, ho, wo, ci, co, g.hk, g.wk, dil, stride=stride)
        elif stride == (1, 1) and stage_fits(b, *xshape[1:], ho, wo,
                        cp := im2col_channels(ci, g.hk, g.wk),
                        2 if dt == torch.bfloat16 else 4):
            rt, plan = "sm90_im2col", _im2col_inner(dt, b, ho, wo, cp, co)
            if plan is not None:
                plan = Im2colPlan(cp, im2col_taps(g.hk, g.wk, g.padding,
                                                  g.dilation), plan)
    if plan is not None:
        return rt, plan
    return "fma", wgrad_split(g.hk * g.wk * ci, co, b * ho * wo)


def launch_facts(kernel: str, route: str, plan, shape, dtype
                 ) -> tuple[LaunchFacts, ...]:
    """What one call of ``wgrad_lb`` on ``route`` with ``plan`` asks of
    the card, for :func:`~repro_torch.analysis.plan_check.check_launch_plan`:
    ``shape`` is ``(xshape, dyshape, geom)``; a split reduction adds
    its second pass."""
    if kernel != "wgrad_lb":
        raise ValueError(f"{kernel!r} is not this module's kernel")
    x, dy, geom = shape
    g = WgradGeometry.of(geom)
    b, h, wd, ci = x
    co = dy[-1]
    ho, wo = _out_plane(x, g)
    dw = g.hk * g.wk * ci * co
    if route == "sm90":
        return _sm90_facts(plan, x, (b, ho, wo, co), dw)
    if route == "sm90_tf32":
        return _tf32_facts(plan, x, (b, ho, wo, co), dw)
    if route == "sm90_im2col":
        elt = 2 if dtype == torch.bfloat16 else 4
        inner = _sm90_facts if dtype == torch.bfloat16 else _tf32_facts
        return (stage_facts(x, ho, wo, plan.cp, elt),
                *inner(plan.inner, (b, ho, wo, plan.cp), (b, ho, wo, co),
                       plan.cp * co))
    tn, splits, _ = plan
    return (LaunchFacts(
        source=SOURCE.stem, function="wgrad_lb_kernel",
        grid=(ceil_div(g.hk * g.wk * ci, TILE_M), ceil_div(co, tn), splits),
        threads=THREADS, min_blocks=MIN_BLOCKS, ctas_per_sm=CTAS_PER_SM,
        smem_bytes=0),) + _reduce_facts(SOURCE.stem, "wgrad_reduce_kernel",
                                        splits, dw, 1, 256, 4096)


def _reduce_facts(source: str, function: str, splits: int, n: int,
                  vec: int, threads: int, most: int) -> tuple:
    """A split reduction's second pass over ``n`` dW words, ``vec`` a
    thread, at most ``most`` blocks of ``threads``; none unsplit."""
    if splits == 1:
        return ()
    return (LaunchFacts(
        source=source, function=function,
        grid=(min(ceil_div(n // vec, threads), most), 1, 1),
        threads=threads, smem_bytes=0),)


def _grid(plan, co: int) -> tuple[int, int, int]:
    """The tensor-core kernels' grid: the CTAs of a range over Co's
    blocks, Co's blocks, the ranges."""
    nco = ceil_div(co, plan.bn)
    return plan.tiles // nco, nco, plan.splits


def _sm90_facts(plan: Sm90WgradPlan, x, dy, dw: int) -> tuple:
    """One launch of ``csrc/wgrad_lb_sm90.cu``: x and dy as (C, W, H, B)
    maps in 64-channel boxes; then a split's second pass over the ``dw``
    words."""
    _, h, wd, ci = x
    _, ho, wo, co = dy
    tile = _sm90_tile(vars(plan))
    maps = (TmaMap("x", tile["boxes"][0], (2 * ci, 2 * ci * wd,
                                           2 * ci * wd * h)),
            TmaMap("dy", tile["boxes"][1], (2 * co, 2 * co * wo,
                                            2 * co * wo * ho)))
    return (LaunchFacts(source=SM90_SOURCE.stem,
                        function="wgrad_lb_sm90_kernel",
                        grid=_grid(plan, co), threads=SM90_THREADS,
                        smem_bytes=plan.smem_bytes, maps=maps,
                        args=tile["args"], stages=tile["stages"]),
            *_reduce_facts(SM90_SOURCE.stem, "wgrad_sm90_reduce_kernel",
                           plan.splits, dw, 4, 256, 2048))


def _tf32_facts(plan: Sm90Tf32Plan, x, dy, dw: int) -> tuple:
    """One launch of ``csrc/wgrad_lb_sm90_tf32.cu``: x and dy as (C, W,
    H, B) maps in 32-channel boxes, x's traversed at the stride; then a
    split's second pass over the ``dw`` words."""
    _, h, wd, ci = x
    _, ho, wo, co = dy
    tile = _tf32_tile(vars(plan))
    maps = (TmaMap("x", tile["boxes"][0], (4 * ci, 4 * ci * wd,
                                           4 * ci * wd * h),
                   elem=tile["elems"][0]),
            TmaMap("dy", tile["boxes"][1], (4 * co, 4 * co * wo,
                                            4 * co * wo * ho)))
    return (LaunchFacts(source=TF32_SOURCE.stem,
                        function="wgrad_lb_sm90_tf32_kernel",
                        grid=_grid(plan, co), threads=SM90_THREADS,
                        smem_bytes=plan.smem_bytes, maps=maps,
                        args=tile["args"], stages=tile["stages"]),
            *_reduce_facts(TF32_SOURCE.stem, "wgrad_tf32_reduce_kernel",
                           plan.splits, dw, 4, 128, 4096))


def wgrad_lb(x: torch.Tensor, dy: torch.Tensor, geom) -> torch.Tensor:
    """dW (Hk, Wk, Ci, Co) f32 of one group of the conv x (B, H, W, Ci)
    -> dy (B, Ho, Wo, Co), x and dy f32 or bf16 (one type; sums in
    f32); ``geom`` a :class:`WgradGeometry` or a
    :class:`~repro_torch.kernels.conv_lb.ops.WgradPlan`.

    A CUDA ``x`` launches the kernel :func:`route` names; a CPU ``x``
    runs the plain version.  Any other device raises.  The route, the
    plan and the checks are read once per geometry key
    (:func:`lookup`)."""
    g = WgradGeometry.of(geom)
    if x.device.type == "cpu":
        return wgrad_ref(x, dy, g.hk, g.wk, stride=_pair(g.stride),
                         padding=_pair(g.padding),
                         dilation=_pair(g.dilation))
    if x.device.type != "cuda":
        raise ValueError(f"the wgrad kernel runs on CUDA tensors (or its "
                         f"plain version on CPU ones), not {x.device}")
    key, entry, fresh = lookup(x, dy, g)
    try:
        dw = entry.launch(x, dy)
    except BaseException:
        if fresh:
            launch_cache.drop(key)
        raise
    wgrad_lb.launches += 1
    wgrad_lb.launches_by_route[entry.route] += 1
    if entry.splits > 1:
        wgrad_lb.reduce_launches += 1
    return dw


def lookup(x, dy, geom):
    """``(key, entry, fresh)``: the launch entry of this call's geometry
    key (:func:`~repro_torch.kernels.lean.operand_key` of x and dy and
    the geometry), made (checks, route and plan) on its first call
    only."""
    g = WgradGeometry.of(geom)
    key = (operand_key(x), operand_key(dy), g)
    entry, fresh = launch_cache.get(key, lambda: _prepare(x, dy, g))
    return key, entry, fresh


class _Launch:
    """One geometry's route, plan, split count and launcher."""

    def __init__(self, route: str, plan, splits: int, launch):
        self.route, self.plan, self.splits = route, plan, splits
        self.launch = launch


def _prepare(x, dy, g: WgradGeometry) -> _Launch:
    """Check the operands, read the route and plan, and bind the
    launcher of one geometry."""
    sy, sx = _pair(g.stride)
    py, px = _pair(g.padding)
    dly, dlx = _pair(g.dilation)
    if min(sy, sx, dly, dlx) < 1 or min(py, px) < 0:
        raise ValueError("stride and dilation must be >= 1 and padding "
                         ">= 0")
    b, h, wd, ci = x.shape
    ho, wo = _out_plane(x.shape, g)
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
    if rt == "sm90_tf32":
        return _Launch(rt, plan, plan.splits, Tf32WgradLaunch(
            (g.hk, g.wk, ci, co), tf32_wgrad_args(x.shape, dy.shape, g,
                                                  plan)))
    if rt == "sm90_im2col" and x.dtype == torch.float32:
        # the plane's 1x1 wgrad packed once too
        inner = Tf32WgradLaunch((1, 1, plan.cp, co), tf32_wgrad_args(
            (b, ho, wo, plan.cp), dy.shape, _ONE_BY_ONE, plan.inner))
        return _Launch(rt, plan, plan.inner.splits,
                       lambda x, dy: _im2col_wgrad(x, dy, g, plan, inner))
    launch = {"sm90": _sm90, "sm90_im2col": _im2col_wgrad, "fma": _fma}[rt]
    return _Launch(rt, plan, plan[1] if rt == "fma" else plan.splits,
                   lambda x, dy: launch(x, dy, g, plan))


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
    win_off = _c_ints(plan.win_off)
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


class Tf32WgradGeom(ctypes.Structure):
    """What the 3xTF32 wgrad kernel reads of a launch (``Geom`` in the
    kernel)."""

    _fields_ = ([(n, ctypes.c_int) for n in (
        "Ci", "Co", "nwin", "py", "px", "sy", "sx", "nby", "nbx", "nblk",
        "bps", "cib", "cpr", "nwg", "nrb", "ngrp", "stages", "sub_bytes",
        "part_bytes", "nparts", "row_step", "halo_tx")]
        + [("lo_mask", ctypes.c_uint32),
           ("part_y", ctypes.c_int * TF32_MAX_PARTS),
           ("part_x", ctypes.c_int * TF32_MAX_PARTS),
           ("win_off", ctypes.c_int * SM90_MAX_WIN)])


class Tf32WgradArgs(ctypes.Structure):
    """One launch of ``csrc/wgrad_lb_sm90_tf32.cu`` (``Args`` in the
    kernel): the pointers and the stream, filled in per call, then every
    integer of the plan, packed once per geometry."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "dy", "dw", "ws", "stream")]
        + [(n, ctypes.c_int) for n in (
            "B", "H", "W", "Ho", "Wo", "box_y", "box_x", "es_y", "es_x",
            "bn", "nwc", "splits", "smem_bytes")]
        + [("g", Tf32WgradGeom)])


def tf32_wgrad_args(xshape, dyshape, g: WgradGeometry, plan: Sm90Tf32Plan,
                    lo_terms: bool = True) -> Tf32WgradArgs:
    """Every integer of one launch on ``plan``."""
    b, h, wd, ci = xshape
    _, ho, wo, co = dyshape
    nwin = g.hk * g.wk
    a = Tf32WgradArgs()
    k = a.g
    k.Ci, k.Co, k.nwin = ci, co, nwin
    (k.py, k.px), (k.sy, k.sx) = _pair(g.padding), plan.stride
    k.nby, k.nbx = ceil_div(ho, SM90_BLOCK), ceil_div(wo, SM90_BLOCK)
    k.nblk, k.bps = b * k.nby * k.nbx, plan.bps
    k.cib, k.cpr, k.stages = plan.cib, plan.cpr, plan.stages
    k.nwg = ceil_div(nwin, 64 // plan.cpr)
    k.nrb = ceil_div(min(ci, plan.cib), plan.cpr) * k.nwg
    k.ngrp = ceil_div(k.nrb, SM90_CONSUMERS * plan.nwc)
    k.sub_bytes, k.part_bytes = plan.sub_bytes, plan.part_bytes
    k.nparts = len(plan.parts)
    k.row_step = plan.row_step
    k.halo_tx = (plan.cib // TF32_BOX) * len(plan.parts) * plan.hy \
        * plan.hx * 128
    k.lo_mask = 0xFFFFFFFF if lo_terms else 0
    for i, (ry, rx) in enumerate(plan.parts):
        k.part_y[i], k.part_x[i] = ry, rx
    k.win_off[:nwin] = plan.win_off
    a.B, a.H, a.W, a.Ho, a.Wo = b, h, wd, ho, wo
    (a.es_y, a.es_x) = plan.es
    a.box_y, a.box_x = plan.hy * a.es_y, plan.hx * a.es_x
    a.bn, a.nwc, a.splits = plan.bn, plan.nwc, plan.splits
    a.smem_bytes = plan.smem_bytes
    return a


class Tf32WgradLaunch:
    """The launcher of one geometry on ``csrc/wgrad_lb_sm90_tf32.cu``:
    its packed arguments, into which each call writes only the pointers
    and the stream."""

    def __init__(self, dw_shape: tuple, args: Tf32WgradArgs):
        self.dw_shape, self.args = dw_shape, args
        self.ref = ctypes.byref(args)
        self.lib = self.fn = None

    def __call__(self, x, dy) -> torch.Tensor:
        dw = torch.empty(self.dw_shape, dtype=torch.float32, device=x.device)
        splits = self.args.splits
        ws = (torch.empty((splits,) + (dw.numel(),), dtype=torch.float32,
                          device=x.device) if splits > 1 else None)
        on_device(x.device, lambda stream: self.fire(x, dy, dw, ws, stream))
        return dw

    def fire(self, x, dy, dw, ws, stream: int) -> None:
        """Fill in the pointers and the stream and call the C entry."""
        if self.fn is None:
            self.lib, self.fn = _entry_struct(TF32_SOURCE,
                                              "wgrad_lb_sm90_tf32_launch",
                                              Tf32WgradArgs)
        a = self.args
        a.x, a.dy, a.dw, a.stream = (x.data_ptr(), dy.data_ptr(),
                                     dw.data_ptr(), stream)
        a.ws = None if ws is None else ws.data_ptr()
        err = self.fn(self.ref)
        if err:
            _launched(self.lib, err, "wgrad_lb_sm90_tf32")


def _sm90_tf32(x: torch.Tensor, dy: torch.Tensor, g: WgradGeometry,
               plan: Sm90Tf32Plan, lo_terms: bool = True) -> torch.Tensor:
    """One launch of ``csrc/wgrad_lb_sm90_tf32.cu`` (and its second
    pass) on the tile, split and offsets of ``plan``, packed anew.
    ``lo_terms=False`` drops the lo words (1xTF32): a control that the
    card's gate sees the small terms, never a route."""
    return Tf32WgradLaunch((g.hk, g.wk, x.shape[-1], dy.shape[-1]),
                           tf32_wgrad_args(x.shape, dy.shape, g, plan,
                                           lo_terms))(x, dy)


def _im2col_wgrad(x: torch.Tensor, dy: torch.Tensor, g: WgradGeometry,
                  plan: Im2colPlan, inner=None) -> torch.Tensor:
    """Route ``sm90_im2col``: the plane on ``plan``'s taps, its 1x1
    wgrad on the tensor-core kernel of x's type (through ``inner`` where
    the launch cache packed it), and rows 0 .. Hk*Wk*Ci - 1 of that dW
    (a view) as dW (Hk, Wk, Ci, Co)."""
    ci, co = x.shape[-1], dy.shape[-1]
    plane = stage(x, plan.taps, *_out_plane(x.shape, g), plan.cp)
    wgrad_lb.stage_launches += 1
    if inner is not None:
        dw = inner(plane, dy)
    else:
        launch = _sm90 if x.dtype == torch.bfloat16 else _sm90_tf32
        dw = launch(plane, dy, _ONE_BY_ONE, plan.inner)
    return dw.view(plan.cp, co)[:g.hk * g.wk * ci].view(g.hk, g.wk, ci, co)


_ONE_BY_ONE = WgradGeometry(hk=1, wk=1)


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


#: the launch entries of :func:`wgrad_lb`
launch_cache = LaunchCache()

wgrad_lb.launches = 0
wgrad_lb.launches_by_route = dict.fromkeys(ROUTES, 0)
wgrad_lb.reduce_launches = 0
wgrad_lb.stage_launches = 0
