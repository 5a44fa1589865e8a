"""The conv kernel's wrapper: build, bind and launch the hand-written
CUDA kernels of K1, which together replace the TPU kernel
``_conv_kernel`` / ``conv_lb_call`` of
``repro/kernels/conv_lb/kernel.py``:

  * ``csrc/conv_lb_sm90.cu`` (route ``"sm90"``): bf16 at stride 1 on
    the tensor cores, TMA into mbarrier rings feeding ``wgmma``;
  * ``csrc/conv_lb_sm90_tf32.cu`` (route ``"sm90_tf32"``): f32 at any
    stride on the tensor cores in 3xTF32, A (the halo) from registers,
    the weights rewritten once per K step into K-major hi and lo tiles;
    also a strided conv's data gradient in one launch by output phases
    (:func:`conv_lb_dgrad`);
  * ``csrc/wgrad_im2col.cu``, then one of the two kernels above (route
    ``"sm90_im2col"``): stride 1 with a channel count too small for a
    TMA map (VGG16's conv1_1, Ci = 3) staged as an im2col plane of at
    most 64 channels (:mod:`~repro_torch.kernels.conv_lb.im2col`, shared
    with K2), then a 1x1 conv of the plane on the tensor-core kernel of
    its type against w read as Hk*Wk*Ci rows (its weight map zero past
    them);
  * ``csrc/conv_lb.cu`` (route ``"fma"``): bf16 strides, lhs dilation
    and every conv :func:`route` does not send to the tensor cores, on
    FMA.

Build (:mod:`repro_torch.kernels.nvcc`, shared by every wrapper): at
first use ``nvcc`` compiles a source in this checkout for ``sm_90a``
into a shared library with a plain C interface, and ``ctypes`` binds
it.  Nothing is compiled when the module is imported.

:func:`conv_lb` dispatches first on where its tensors lie: a CUDA
tensor launches the kernel :func:`route` names or raises (a
failed build, a refused launch, a geometry or dtype the kernel does not
take); a CPU tensor runs the plain version
(:func:`~repro_torch.kernels.conv_lb.ref.conv2d_ref`).  The route is
read from types, geometry and pointers before launch, never by trying
one, and read once per geometry key (:func:`lookup`,
:class:`~repro_torch.kernels.lean.LaunchCache`); :func:`plan_of` names
it with the tile its kernel runs.  Each
layer call that launches adds one to ``conv_lb.launches`` and to its
route's entry of ``conv_lb.launches_by_route``; the im2col staging
kernel adds one to ``conv_lb.stage_launches`` where it launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
from functools import lru_cache
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.analysis.plan_check import (LaunchFacts, TmaMap,
                                             smem_rule, tile_fits)
from repro_torch.core.hopper_adapter import (REGS_PER_SM, SM_COUNT,
                                             SMEM_PER_BLOCK,
                                             TMA_ELEM_STRIDE_MAX,
                                             launch_bounds_regs)
from repro_torch.core.layer import ceil_div
from repro_torch.kernels.conv_lb.im2col import (Im2colPlan,
                                                im2col_channels,
                                                im2col_taps, stage,
                                                stage_facts, stage_fits)
from repro_torch.kernels.conv_lb.ref import conv2d_ref, flip_w
from repro_torch.kernels.lean import LaunchCache, on_device, operand_key
from repro_torch.kernels.nvcc import Library, _entry, _entry_struct

SOURCE = Path(__file__).resolve().parent / "csrc" / "conv_lb.cu"
SM90_SOURCE = Path(__file__).resolve().parent / "csrc" / "conv_lb_sm90.cu"
TF32_SOURCE = (Path(__file__).resolve().parent / "csrc"
               / "conv_lb_sm90_tf32.cu")

#: the kernel's fixed CTA shape (must match csrc/conv_lb.cu)
TILE_M = 128        # output pixels per CTA
CI_BLOCK = 8        # input channels staged per step
THREADS = 256
MIN_BLOCKS = 2      # __launch_bounds__(256, 2)
MAX_REGS = launch_bounds_regs(THREADS, MIN_BLOCKS)    # per thread: 128
CTAS_PER_SM = REGS_PER_SM // (THREADS * MAX_REGS)
#: the tensor-core kernels' CTA: a producer and two consumer warpgroups
#: under __launch_bounds__(384, 1), one CTA an SM
SM90_THREADS = 384
#: operand types the conv and wgrad kernels take, by the code their C
#: interfaces use
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
                if fit and not tile_fits(cta_smem_bytes(
                        bb, ty, tx, tn, hk, wk, stride, dilation, pool,
                        krows, elt)):
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
SM90_PLANE = 8               # channels of one 16-byte halo plane
ROUTES = ("sm90", "sm90_tf32", "sm90_im2col", "fma")

#: the 3xTF32 kernel's fixed shape (must match csrc/conv_lb_sm90_tf32.cu):
#: the sm90 kernel's two 8 x 8 pixel blocks a CTA (``SM90_TILES``), K
#: steps of one window of a 32-channel Ci block (one 128-byte f32 halo
#: row a pixel), ``bn`` output channels (a wgmma N, a multiple of the
#: transposers' 32 lanes); three producer-warpgroup warps rewrite each
#: weight slice into K-major hi and lo tiles
TF32_BN = (32, 64, 128)
TF32_BK = 32                 # channels of a Ci block
TF32_W_STAGES = 4            # weight ring: (Ci block, window) stages
TF32_B_STAGES = 2            # ring of the hi/lo B tiles
TF32_H_STAGES = 2            # halo ring: Ci blocks
TF32_TRANSPOSERS = 3
#: 3xTF32: three tensor-core products per multiply-add
TF32_PRODUCTS = 3
#: K steps (32 of K each) the tensor cores sum before the consumers
#: promote their sums into round-to-nearest f32 sums: K3's interval,
#: held at VGG's deepest K (4608) by ``tests/test_torch_conv_tc.py``'s
#: model and swept on the card by ``launch/conv_tf32_promote.py``
TF32_PROMOTE = 2


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


def _sm90_tile(lay: dict) -> dict:
    """The sm90 kernel's TMA boxes (the halo's 8-channel planes, the
    weights' 64 x ``cib`` slices) and argument arrays at one layout
    (:func:`sm90_layout`'s dict, or an :class:`Sm90Plan`'s ``vars``)."""
    return dict(boxes=((SM90_PLANE, lay["hx"], lay["hy"], lay["bb"]),
                       (64, lay["cib"], 1)),
                args=(("windows", len(lay["win_off"]), SM90_MAX_WIN),))


def _sm90_fits(lay: dict) -> bool:
    return tile_fits(lay["smem_bytes"], **_sm90_tile(lay))


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


#: halo boxes of one Ci block (the residues of a stride: ``sy * sx``
#: at most), output phases of one launch, window offsets of a launch
#: (must match csrc/conv_lb_sm90_tf32.cu)
TF32_MAX_PARTS = 16
TF32_MAX_PHASES = 16
TF32_MAX_STRIDE = TMA_ELEM_STRIDE_MAX    # a TMA map's traversal stride


@dataclasses.dataclass(frozen=True)
class Sm90Tf32Plan:
    """The 3xTF32 kernel's tile and every shared-memory offset it is
    passed (bytes).  The halo of one Ci block lies as ``len(parts)``
    boxes, ``part_bytes`` apart, each ``bb`` images x ``hy`` x ``hx``
    pixels, one 128-byte swizzled row of 32 channels a pixel, in a
    stage of ``h_stage`` bytes.  A box is loaded at the TMA traversal
    stride ``es`` (so its extent in the tensor is ``hy * es`` rows by
    ``hx * es`` columns), starting ``stride``
    x the tile's origin plus its residue ``parts[i]``; a consumer's
    pixel (r, c) of its block reads the halo at ``blk_off + r * sbo + c
    * 128`` (``sbo``: one box row), window ``i`` the same rows shifted
    by ``win_off[i]``.  At stride 1 there is one box.

    A data gradient's plan (:func:`sm90_tf32_dgrad_plan`) adds its
    output ``phases``, one ``(qy, qx, ho, wo, y0, x0, win0, nwin)`` each
    (its plane, halo origin and windows), each window's weight tap
    (``win_w``), and ``wt``: w's (Ci, Co) slices read transposed."""

    bb: int
    ty: int
    tx: int
    bn: int                    # output channels per CTA
    hy: int                    # halo box rows (in the box)
    hx: int                    # halo box columns
    h_stage: int               # one halo stage (a 1024-byte multiple)
    sbo: int                   # bytes between output rows in the halo
    blk_off: tuple[int, int]   # each consumer's block in the halo
    win_off: tuple[int, ...]   # window -> shift in the halo
    smem_bytes: int
    parts: tuple[tuple[int, int], ...]   # each box's residue (ry, rx)
    part_bytes: int            # one box (a 1024-byte multiple)
    es: tuple[int, int]        # the x map's traversal strides
    stride: tuple[int, int]    # halo rows, columns a tile row, column moves
    ctas: int
    phases: tuple[tuple[int, ...], ...] = ()
    win_w: tuple[int, ...] = ()
    wt: bool = False

    @property
    def tile(self) -> tuple[int, int, int, int]:
        """``(bb, ty, tx, bn)``."""
        return self.bb, self.ty, self.tx, self.bn


def tf32_parts(hk: int, wk: int, dilation: tuple[int, int],
               stride: tuple[int, int]) -> tuple[tuple[int, int], ...]:
    """The residues ``(ky*dly mod sy, kx*dlx mod sx)`` some window has:
    one halo box each (4 at a 3x3/2, 1 at a 1x1/2 or at stride 1)."""
    (dy, dx), (sy, sx) = dilation, stride
    ys = sorted({ky * dy % sy for ky in range(hk)})
    xs = sorted({kx * dx % sx for kx in range(wk)})
    return tuple((ry, rx) for ry in ys for rx in xs)


def sm90_tf32_layout(bb: int, ty: int, tx: int, bn: int, hk: int, wk: int,
                     dilation: tuple[int, int],
                     stride: tuple[int, int] = (1, 1),
                     w_stages: int = TF32_W_STAGES) -> dict:
    """The halo boxes and the shared-memory offsets of one 3xTF32 tile
    (the fields of :class:`Sm90Tf32Plan` but ``ctas``): from a
    1024-byte line the weight ring (``bn`` x 32 words a stage), the B
    ring (a hi and a lo tile of ``bn`` x 32 words a stage), the halo
    ring, then a full and an empty mbarrier per stage of each ring.  At
    stride (sy, sx) the halo is one box per residue of
    :func:`tf32_parts`, each at the traversal stride (sy, sx), so window
    (ky, kx) reads its box densely at the shift (ky*dly // sy, kx*dlx
    // sx): consecutive pixels in consecutive rows, as at stride 1.
    ``w_stages`` other than the kernel's ``TF32_W_STAGES`` sizes a ring
    the kernel does not have: the legality checks' control, never a
    route."""
    (dy, dx), (sy, sx) = dilation, stride
    parts = tf32_parts(hk, wk, dilation, stride)
    hy, hx = ty + (hk - 1) * dy // sy, tx + (wk - 1) * dx // sx
    part = ceil_div(bb * hy * hx * 128, 1024) * 1024
    index = {r: i for i, r in enumerate(parts)}
    win = tuple(index[ky * dy % sy, kx * dx % sx] * part
                + ((ky * dy // sy) * hx + kx * dx // sx) * 128
                for ky in range(hk) for kx in range(wk))
    h_stage = len(parts) * part
    # the second consumer's block: the next image's, or 8 columns on
    blk = ((bb - 1) * hy * hx + tx - SM90_BLOCK) * 128
    tile = bn * TF32_BK * 4
    smem = (1024 + w_stages * tile + TF32_B_STAGES * 2 * tile
            + TF32_H_STAGES * h_stage
            + 16 * (w_stages + TF32_B_STAGES + TF32_H_STAGES))
    return dict(bb=bb, ty=ty, tx=tx, bn=bn, hy=hy, hx=hx, h_stage=h_stage,
                sbo=hx * 128, blk_off=(0, blk), win_off=win,
                smem_bytes=smem, parts=parts, part_bytes=part,
                es=(sy, sx), stride=(sy, sx))


def _tf32_tile(lay: dict) -> dict:
    """The 3xTF32 kernel's TMA boxes (a halo box of 32 channels, its
    extent in the tensor ``hy * es`` by ``hx * es``, traversed at
    ``es``; the weights' 32 x 32 slices) and argument arrays at one
    layout (:func:`sm90_tf32_layout`'s dict, or an
    :class:`Sm90Tf32Plan`'s ``vars``: a forward's one phase, or a data
    gradient's ``phases``)."""
    esy, esx = lay["es"]
    return dict(boxes=((TF32_BK, lay["hx"] * esx, lay["hy"] * esy,
                        lay["bb"]), (32, TF32_BK, 1)),
                elems=((1, esx, esy, 1), ()),
                args=(("windows", len(lay["win_off"]), SM90_MAX_WIN),
                      ("halo boxes", len(lay["parts"]), TF32_MAX_PARTS),
                      ("output phases", len(lay.get("phases") or (0,)),
                       TF32_MAX_PHASES)))


def _tf32_fits(lay: dict) -> bool:
    return tile_fits(lay["smem_bytes"], **_tf32_tile(lay))


def _rank_tf32(lays, batch: int, ho: int, wo: int, co: int, phases: int = 1):
    """The best of ``lays`` (tiles that fit) by :func:`sm90_tf32_plan`'s
    ranking, as an :class:`Sm90Tf32Plan` without its phases; ``None``
    if none fits."""
    best = None
    for lay in lays:
        if not _tf32_fits(lay):
            continue
        ty, tx, bn = lay["ty"], lay["tx"], lay["bn"]
        ctas = (ceil_div(batch, lay["bb"]) * ceil_div(ho, ty)
                * ceil_div(wo, tx) * ceil_div(co, bn) * phases)
        waves = ceil_div(ctas, SM_COUNT)
        halo = len(lay["parts"]) * lay["hy"] * lay["hx"] / (ty * tx)
        key = (waves * bn, ctas * bn, halo, -bn)
        if best is None or key < best[0]:
            best = (key, Sm90Tf32Plan(**lay, ctas=ctas))
    return None if best is None else best[1]


@lru_cache(maxsize=4096)
def sm90_tf32_plan(batch: int, ho: int, wo: int, co: int, ci: int,
                   hk: int = 1, wk: int = 1,
                   dilation: tuple[int, int] = (1, 1),
                   stride: tuple[int, int] = (1, 1)
                   ) -> Sm90Tf32Plan | None:
    """The 3xTF32 kernel's tile for one f32 conv at ``stride``, ranked
    as :func:`sm90_plan` ranks (one CTA per SM): the fewest waves of
    CTAs over the card's SMs, then the fewest CTAs (each does 128 x
    ``bn`` work whatever part of it is real), then the least halo per
    output pixel, then the widest ``bn`` (a narrower one where Co is
    small: ResNet-20's 16 and 32 channels).  ``ci`` does not enter the
    rank: every tile steps over 32-channel Ci blocks.  Only tiles whose
    shared memory fits with at most ``SM90_MAX_WIN`` windows and boxes
    TMA takes are ranked; ``None`` if none does."""
    lays = (sm90_tf32_layout(bb, ty, tx, bn, hk, wk, tuple(dilation),
                             tuple(stride))
            for bn, (bb, ty, tx) in itertools.product(TF32_BN, SM90_TILES)
            if bn == TF32_BN[0] or co > bn // 2)
    return _rank_tf32(lays, batch, ho, wo, co)


def dgrad_taps(n: int, k: int, s: int, p: int, d: int):
    """Per output phase q (dx rows q, q + s, ...) of one axis of the
    data gradient of a conv (``n`` input rows, window ``k`` at dilation
    ``d``, stride ``s``, padding ``p``): its rows ``ceil((n - q) / s)``
    and its taps ``[(k_i, e_i)]``, tap ``k_i`` reading gy row ``m + e_i``
    for dx row ``s*m + q`` (``q + p - k_i*d = e_i*s``)."""
    return [(max(0, ceil_div(n - q, s)),
             [(kk, (q + p - kk * d) // s) for kk in range(k)
              if (q + p - kk * d) % s == 0])
            for q in range(s)]


@lru_cache(maxsize=4096)
def sm90_tf32_dgrad_plan(batch: int, h: int, wd: int, ci: int, co: int,
                         hk: int, wk: int, stride: tuple[int, int],
                         padding: tuple[int, int],
                         dilation: tuple[int, int] = (1, 1)
                         ) -> Sm90Tf32Plan | None:
    """The 3xTF32 kernel's plan for dx (batch, h, wd, ci) of the conv x
    -> gy (batch, ho, wo, co) with w (hk, wk, ci, co) at ``stride``, by
    output phases: phase (qy, qx) is a stride-1 conv of the compact gy
    over the taps of :func:`dgrad_taps` on each axis (w's slices read
    transposed, tap by tap as they lie: no flipped copy), its halo box
    starting at the phase's least tap offset, stored at stride ``s``
    from (qy, qx); a phase with no tap writes zeros.  The tile is ranked
    as :func:`sm90_tf32_plan` ranks, over phase (0, 0)'s plane, with
    one halo box as wide as the widest phase's span of taps."""
    (sy, sx), (py, px), (dly, dlx) = stride, padding, dilation
    ys = dgrad_taps(h, hk, sy, py, dly)
    xs = dgrad_taps(wd, wk, sx, px, dlx)

    def span(axis):
        return max((max(e for _, e in t) - min(e for _, e in t) if t else 0)
                   for _, t in axis)

    if sy * sx > TF32_MAX_PHASES or hk * wk > SM90_MAX_WIN:
        return None
    lays = (sm90_tf32_layout(bb, ty, tx, bn, span(ys) + 1, span(xs) + 1,
                             (1, 1))
            for bn, (bb, ty, tx) in itertools.product(TF32_BN, SM90_TILES)
            if bn == TF32_BN[0] or ci > bn // 2)
    base = _rank_tf32(lays, batch, ys[0][0], xs[0][0], ci, sy * sx)
    if base is None:
        return None
    phases, win_off, win_w = [], [], []
    for qy, (hq, ty_) in enumerate(ys):
        for qx, (wq, tx_) in enumerate(xs):
            y0 = min((e for _, e in ty_), default=0)
            x0 = min((e for _, e in tx_), default=0)
            phases.append((qy, qx, hq, wq, y0, x0, len(win_off),
                           len(ty_) * len(tx_)))
            for ky, ey in ty_:
                for kx, ex in tx_:
                    win_off.append(((ey - y0) * base.hx + ex - x0) * 128)
                    win_w.append(ky * wk + kx)
    return dataclasses.replace(base, win_off=tuple(win_off),
                               phases=tuple(phases), win_w=tuple(win_w),
                               wt=True)


def halo_at_stride_one(plan):
    """``plan`` (K1's or K2's 3xTF32 plan) with each halo box loaded
    without its traversal stride but read as if strided: a control that
    the card's gate sees a strided halo, never a route."""
    return dataclasses.replace(plan, es=(1, 1))


def tf32_overfull(plan: Sm90Tf32Plan, hk: int, wk: int,
                  dilation=(1, 1), stride=(1, 1)) -> Sm90Tf32Plan:
    """``plan``'s tile with one weight-ring stage past the most whose
    shared memory fits: a control that the ``sm90.smem`` rule sees a
    tile the card refuses, never a route (nothing launches it)."""
    def lay(stages):
        return sm90_tf32_layout(plan.bb, plan.ty, plan.tx, plan.bn, hk, wk,
                                tuple(dilation), tuple(stride), stages)

    stages = TF32_W_STAGES
    while tile_fits(lay(stages + 1)["smem_bytes"]):
        stages += 1
    return Sm90Tf32Plan(**lay(stages + 1), ctas=plan.ctas)


def dgrad_phase_shifted(plan: Sm90Tf32Plan) -> Sm90Tf32Plan:
    """``plan`` with its fullest phase's windows one gy column off: a
    control that the card's gate sees a phase's taps, never a route."""
    *_, win0, nwin = max(plan.phases, key=lambda ph: ph[-1])
    off = list(plan.win_off)
    off[win0:win0 + nwin] = [o + 128 for o in off[win0:win0 + nwin]]
    return dataclasses.replace(plan, win_off=tuple(off))


def route(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
          lhs_dilation=(1, 1), *, bias: torch.Tensor | None = None,
          residual: torch.Tensor | None = None, dilation=(1, 1),
          pool: int = 1, padding=(0, 0)) -> str:
    """The route :func:`conv_lb` takes for these operands
    (:func:`launch_plan`'s, from their types, shapes and whether every
    base address is 16-byte aligned).  Read before launch."""
    ops = (x, w, bias, residual)
    return launch_plan(operand_type(*ops), tuple(x.shape), tuple(w.shape),
                       tuple(stride), tuple(padding), tuple(dilation),
                       tuple(lhs_dilation), pool, aligned(*ops))[0]


def operand_type(*operands) -> torch.dtype | None:
    """The operands' one type, or ``None`` where they differ (``None``
    operands are skipped)."""
    types = {t.dtype for t in operands if t is not None}
    return types.pop() if len(types) == 1 else None


def aligned(*operands) -> bool:
    """Every base address of the operands is 16-byte aligned."""
    return all(t.data_ptr() % 16 == 0 for t in operands if t is not None)


@lru_cache(maxsize=4096)
def launch_plan(dtype: torch.dtype | None, xshape: tuple, wshape: tuple,
                stride=(1, 1), padding=(0, 0), dilation=(1, 1),
                lhs_dilation=(1, 1), pool: int = 1, aligned: bool = True
                ) -> tuple[str, Sm90Plan | Sm90Tf32Plan | Im2colPlan
                           | tuple]:
    """The shape-only core of :func:`route` and :func:`plan_of`: the
    route of one group of the conv x ``xshape`` (B, H, W, Ci) against w
    ``wshape`` (Hk, Wk, Ci, Co), its operands of type ``dtype``
    (``None``: of more than one) and ``aligned`` (every base 16-byte
    aligned), and the plan its kernel runs.  The tensor-core routes need
    bf16 or f32, lhs dilation (1, 1) (any dilation and padding), Co a
    multiple of ``pitch`` (8 bf16, 4 f32 channels: a 16-byte row pitch
    that a TMA map describes), every base aligned and the fused pool 1
    or 2 (the epilogue pools 2 x 2 in registers); then

      * ``"sm90"`` (bf16, stride (1, 1)) with an :class:`Sm90Plan`, or
        ``"sm90_tf32"`` (f32, any stride up to ``TF32_MAX_STRIDE``; the
        pool 1 where the stride is not 1) with an
        :class:`Sm90Tf32Plan`: Ci a multiple of ``pitch`` and a tile of
        :func:`sm90_plan` or :func:`sm90_tf32_plan` that fits
        (:func:`~repro_torch.analysis.plan_check.tile_fits`);
      * ``"sm90_im2col"`` with an :class:`Im2colPlan`: stride (1, 1),
        Ci not a multiple of ``pitch``, Hk*Wk*Ci <= ``im2col.IM2COL_MAX``
        (VGG16's conv1_1 and ResNet-20's stem: 27), the staging kernel
        takes the plane (``stage_fits``) and a tile of the type's plan
        fits the plane's 1x1 conv.

    Else ``"fma"`` with :func:`cta_plan`'s ``(bb, ty, tx, tn, krows)``
    (``None`` where the conv has no output)."""
    b, h, wd, ci = xshape
    co = wshape[3]
    stride, padding = tuple(stride), tuple(padding)
    dilation, lhs_dilation = tuple(dilation), tuple(lhs_dilation)
    ho, wo = _out_plane(h, wd, wshape[0], wshape[1], stride, padding,
                        dilation, lhs_dilation)
    bf16 = dtype == torch.bfloat16
    pitch = SM90_PLANE if bf16 else 4
    strided = stride != (1, 1)
    tensor_cores = (
        dtype in (torch.bfloat16, torch.float32) and aligned
        and lhs_dilation == (1, 1) and pool in (1, 2) and co % pitch == 0
        and not (strided and (bf16 or pool > 1
                              or max(stride) > TF32_MAX_STRIDE)))
    rt = "fma"
    if tensor_cores and ci % pitch == 0:
        rt = "sm90" if bf16 else "sm90_tf32"
    elif tensor_cores and not strided and min(ho, wo) >= 1 and stage_fits(
            b, h, wd, ci, ho, wo, im2col_channels(ci, *wshape[:2]),
            2 if bf16 else 4):
        rt = "sm90_im2col"
    key = (dtype, tuple(xshape), tuple(wshape), stride, padding, dilation,
           lhs_dilation, pool)
    plan = route_plan(rt, *key)
    if plan is None and rt != "fma":        # no tile fits
        rt, plan = "fma", route_plan("fma", *key)
    return rt, plan


@lru_cache(maxsize=4096)
def route_plan(rt: str, dtype: torch.dtype | None, xshape: tuple,
               wshape: tuple, stride, padding, dilation, lhs_dilation,
               pool: int):
    """The plan route ``rt``'s kernel runs this conv on (the arguments
    as :func:`launch_plan`'s): :func:`sm90_plan`'s, :func:`sm90_tf32_plan`'s,
    an :class:`Im2colPlan` of the plane and its 1x1 conv's plan, or
    :func:`cta_plan`'s; ``None`` where no tile fits or the conv has no
    output."""
    b, h, wd, ci = xshape
    hk, wk, _, co = wshape
    ho, wo = _out_plane(h, wd, hk, wk, stride, padding, dilation,
                        lhs_dilation)
    bf16 = dtype == torch.bfloat16
    if rt == "sm90":
        return sm90_plan(b, ho, wo, co, ci, hk, wk, dilation)
    if rt == "sm90_tf32":
        return sm90_tf32_plan(b, ho, wo, co, ci, hk, wk, dilation, stride)
    if rt == "sm90_im2col":
        cp = im2col_channels(ci, hk, wk)
        inner = (sm90_plan if bf16 else sm90_tf32_plan)(b, ho, wo, co, cp)
        return None if inner is None else Im2colPlan(
            cp, im2col_taps(hk, wk, padding, dilation), inner)
    if min(ho, wo) < 1:         # no output: a launch refuses it
        return None
    return cta_plan(b, ho, wo, co, pool, hk, wk, stride, dilation,
                    2 if bf16 else 4)


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
            pool: int = 1) -> tuple[str, Sm90Plan | Sm90Tf32Plan
                                    | Im2colPlan | tuple]:
    """The route :func:`conv_lb` takes for these operands and the plan
    its kernel then runs: an :class:`Sm90Plan` (``"sm90"``), an
    :class:`Sm90Tf32Plan` (``"sm90_tf32"``), an :class:`Im2colPlan`
    (``"sm90_im2col"``, its inner plan the one of x's type) or
    :func:`cta_plan`'s ``(bb, ty, tx, tn, krows)`` (``"fma"``): the
    plan :func:`route_plan` gives :func:`route`'s route, read before
    launch."""
    rt = route(x, w, stride, lhs_dilation, bias=bias, residual=residual,
               dilation=dilation, pool=pool, padding=padding)
    return rt, route_plan(rt, operand_type(x, w, bias, residual),
                          tuple(x.shape), tuple(w.shape), tuple(stride),
                          tuple(padding), tuple(dilation),
                          tuple(lhs_dilation), pool)


def launch_facts(kernel: str, route: str, plan, shape, dtype
                 ) -> tuple[LaunchFacts, ...]:
    """What one call of ``kernel`` (``"conv_lb"`` or ``"conv_lb_dgrad"``)
    on ``route`` with ``plan`` asks of the card, for
    :func:`~repro_torch.analysis.plan_check.check_launch_plan`:
    ``shape`` is ``(xshape, wshape, stride, padding, dilation,
    lhs_dilation, pool)`` for a conv, ``(gyshape, wshape, stride,
    padding, dilation, h, wd)`` for a data gradient by output phases."""
    if kernel == "conv_lb_dgrad":
        gy, w, *_, h, wd = shape
        if route != "sm90_tf32":
            raise ValueError(f"a data gradient launches on sm90_tf32, not "
                             f"{route}")
        return (_tf32_facts(plan, gy, w, (h, wd)),)
    x, w, stride, padding, dilation, lhs_dilation, pool = shape
    b, h, wd, ci = x
    hk, wk, _, co = w
    ho, wo = _out_plane(h, wd, hk, wk, tuple(stride), tuple(padding),
                        tuple(dilation), tuple(lhs_dilation))
    if route == "sm90":
        return (_sm90_facts(plan, x, w, (ho, wo)),)
    if route == "sm90_tf32":
        return (_tf32_facts(plan, x, w, (ho, wo)),)
    if route == "sm90_im2col":
        elt = 2 if dtype == torch.bfloat16 else 4
        inner = _sm90_facts if dtype == torch.bfloat16 else _tf32_facts
        return (stage_facts(x, ho, wo, plan.cp, elt),
                inner(plan.inner, (b, ho, wo, plan.cp),
                      (1, 1, hk * wk * ci, co), (ho, wo)))
    bb, ty, tx, tn, krows = plan
    return (LaunchFacts(
        source=SOURCE.stem, function="conv_lb_kernel",
        grid=(ceil_div(b, bb) * ceil_div(ho, ty) * ceil_div(wo, tx),
              ceil_div(co, tn), 1),
        threads=THREADS, min_blocks=MIN_BLOCKS, ctas_per_sm=CTAS_PER_SM,
        smem_bytes=cta_smem_bytes(bb, ty, tx, tn, hk, wk, tuple(stride),
                                  tuple(dilation), pool, krows,
                                  2 if dtype == torch.bfloat16 else 4)),)


def _sm90_facts(plan: Sm90Plan, x, w, plane) -> LaunchFacts:
    """One launch of ``csrc/conv_lb_sm90.cu``: x (B, H, W, Ci) as
    (Ci, W, H, B) in 8-channel halo planes, w as (Co, wCi, Hk*Wk) in 64 x
    ``cib`` slices, one CTA per ``bb x ty x tx`` pixels and ``bn``
    output channels."""
    b, h, wd, ci = x
    *_, wci, co = w
    ho, wo = plane
    tile = _sm90_tile(vars(plan))
    maps = (TmaMap("x", tile["boxes"][0], (2 * ci, 2 * ci * wd,
                                           2 * ci * wd * h)),
            TmaMap("w", tile["boxes"][1], (2 * co, 2 * co * wci)))
    return LaunchFacts(
        source=SM90_SOURCE.stem, function="conv_lb_sm90_kernel",
        grid=(ceil_div(b, plan.bb) * ceil_div(ho, plan.ty)
              * ceil_div(wo, plan.tx), ceil_div(co, plan.bn), 1),
        threads=SM90_THREADS, smem_bytes=plan.smem_bytes, maps=maps,
        args=tile["args"])


def _tf32_facts(plan: Sm90Tf32Plan, x, w, plane) -> LaunchFacts:
    """One launch of ``csrc/conv_lb_sm90_tf32.cu`` as :func:`tf32_args`
    packs it: x (B, H, W, Ci) as (Ci, W, H, B) in halo boxes, w (Hk, Wk,
    wd1, wd0) as (wd0, wd1, Hk*Wk) in 32 x 32 slices; a grid of the
    largest phase's tiles x ``bn`` output channels x the phases."""
    b, h, wd, ci = x
    hk, wk, wd1, wd0 = w
    if plan.phases:
        co = wd1
        phases = [(hq, wq) for _, _, hq, wq, *_ in plan.phases]
    else:
        co, phases = wd0, [plane]
    tiles = max(ceil_div(b, plan.bb) * max(1, ceil_div(hq, plan.ty))
                * max(1, ceil_div(wq, plan.tx)) for hq, wq in phases)
    tile = _tf32_tile(vars(plan))
    maps = (TmaMap("x", tile["boxes"][0], (4 * ci, 4 * ci * wd,
                                           4 * ci * wd * h),
                   elem=tile["elems"][0]),
            TmaMap("w", tile["boxes"][1], (4 * wd0, 4 * wd0 * wd1)))
    return LaunchFacts(
        source=TF32_SOURCE.stem, function="conv_lb_sm90_tf32_kernel",
        grid=(tiles, ceil_div(co, plan.bn), len(phases)),
        threads=SM90_THREADS, smem_bytes=plan.smem_bytes, maps=maps,
        args=tile["args"])


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
    runs the plain version.  Any other device raises.  The route, the
    plan and the checks are read once per geometry key
    (:func:`lookup`)."""
    if x.device.type == "cpu":
        return conv2d_ref(x, w, bias, residual, stride=stride,
                          padding=padding, dilation=dilation,
                          lhs_dilation=lhs_dilation, relu=relu, pool=pool)
    if x.device.type != "cuda":
        raise ValueError(f"the conv kernel runs on CUDA tensors (or its "
                         f"plain version on CPU ones), not {x.device}")
    key, entry, fresh = lookup(x, w, bias, residual, stride=stride,
                               padding=padding, dilation=dilation,
                               lhs_dilation=lhs_dilation, relu=relu,
                               pool=pool)
    try:
        out = entry.launch(x, w, bias, residual)
    except BaseException:
        if fresh:
            launch_cache.drop(key)
        raise
    conv_lb.launches += 1
    conv_lb.launches_by_route[entry.route] += 1
    return out


def lookup(x, w, bias=None, residual=None, *, stride=(1, 1),
           padding=(0, 0), dilation=(1, 1), lhs_dilation=(1, 1),
           relu: bool = False, pool: int = 1):
    """``(key, entry, fresh)``: the launch entry of this call's geometry
    key (:func:`~repro_torch.kernels.lean.operand_key` of each operand
    and the geometry), made (checks, route and plan) on its first call
    only."""
    key = (operand_key(x), operand_key(w), operand_key(bias),
           operand_key(residual), tuple(stride), tuple(padding),
           tuple(dilation), tuple(lhs_dilation), bool(relu), pool)
    entry, fresh = launch_cache.get(key, lambda: _prepare(
        x, w, bias, residual, tuple(stride), tuple(padding),
        tuple(dilation), tuple(lhs_dilation), bool(relu), pool))
    return key, entry, fresh


class _Launch:
    """One geometry's route, plan and launcher."""

    def __init__(self, route: str, plan, launch):
        self.route, self.plan, self.launch = route, plan, launch


def _prepare(x, w, bias, residual, stride, padding, dilation, lhs_dilation,
             relu: bool, pool: int) -> _Launch:
    """Check the operands, read the route and plan, and bind the
    launcher of one geometry."""
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
        return _Launch(rt, plan, lambda x, w, bias, res: _sm90(
            x, w, bias, res, ho, wo, padding, relu, pool, plan))
    if rt == "sm90_tf32":
        return _Launch(rt, plan, Tf32Launch(
            (b, ho // pool, wo // pool, co),
            tf32_args(x.shape, w.shape, plan, (ho, wo), padding, relu,
                      pool)))
    if rt == "sm90_im2col":
        # f32: the plane's 1x1 conv packed once too
        inner = None if x.dtype == torch.bfloat16 else Tf32Launch(
            (b, ho // pool, wo // pool, co),
            tf32_args((b, ho, wo, plan.cp), (1, 1, hk * wk * ci, co),
                      plan.inner, (ho, wo), (0, 0), relu, pool))
        return _Launch(rt, plan, lambda x, w, bias, res: _im2col_sm90(
            x, w, bias, res, ho, wo, relu, pool, plan, inner))
    return _Launch(rt, plan, lambda x, w, bias, res: _fma(
        x, w, bias, res, ho, wo, stride, padding, dilation, lhs_dilation,
        relu, pool, plan))


def _launched(lib: Library, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.error_string(err)} (error {err})")


def _sm90(x, w, bias, residual, ho: int, wo: int, padding, relu: bool,
          pool: int, plan: Sm90Plan) -> torch.Tensor:
    """One launch of ``csrc/conv_lb_sm90.cu`` on the tile and offsets of
    ``plan``: :func:`sm90_plan`'s, or a wrong one that a check passes
    to show that the card's gate sees it.  w's input channels may be
    fewer than x's (the 1x1 conv of an im2col plane): the weight map
    reads zeros past them."""
    b, h, wd, ci = x.shape
    hk, wk, wci, co = w.shape
    lib, forward = _entry(SM90_SOURCE, "conv_lb_sm90_forward", 6, 26)
    out = torch.empty((b, ho // pool, wo // pool, co), dtype=x.dtype,
                      device=x.device)
    win_off = (ctypes.c_int * len(plan.win_off))(*plan.win_off)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = forward(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), ctypes.addressof(win_off), b, h, wd, ci, wci, co,
            hk, wk, ho, wo, padding[0], padding[1], pool, int(relu), plan.bb,
            plan.ty, plan.tx, plan.hy, plan.hx, plan.bn, plan.cib,
            plan.plane_bytes, plan.sbo, plan.blk_off[0], plan.blk_off[1],
            plan.smem_bytes, stream)
    _launched(lib, err, "conv_lb_sm90")
    return out


class Tf32Phase(ctypes.Structure):
    """One output phase of a launch (``Phase`` in the kernel)."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "ho", "wo", "nty", "ntx", "y0", "x0", "qy", "qx", "win0", "nwin")]


class Tf32ConvGeom(ctypes.Structure):
    """What the 3xTF32 kernel reads of a launch (``Geom`` in the
    kernel)."""

    _fields_ = ([(n, ctypes.c_int) for n in (
        "B", "OH", "OW", "Co", "bb", "ty", "tx", "ncb", "sy", "sx",
        "nparts", "part_bytes", "h_stage", "halo_tx", "row_step", "osy",
        "osx", "pool", "relu", "wt")]
        + [("lo_mask", ctypes.c_uint32),
           ("blk_off", ctypes.c_int * 2),
           ("part_y", ctypes.c_int * TF32_MAX_PARTS),
           ("part_x", ctypes.c_int * TF32_MAX_PARTS),
           ("ph", Tf32Phase * TF32_MAX_PHASES),
           ("win_off", ctypes.c_int * SM90_MAX_WIN),
           ("win_w", ctypes.c_int * SM90_MAX_WIN)])


class Tf32ConvArgs(ctypes.Structure):
    """One launch of ``csrc/conv_lb_sm90_tf32.cu`` (``Args`` in the
    kernel): the pointers and the stream, filled in per call, then
    every integer of the plan, packed once per geometry."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "w", "bias", "res", "out", "stream")]
        + [(n, ctypes.c_int) for n in (
            "H", "W", "Ci", "wd0", "wd1", "wd2", "box_y", "box_x", "es_y",
            "es_x", "bn", "nphase", "tiles", "smem_bytes")]
        + [("g", Tf32ConvGeom)])


def tf32_args(xshape, wshape, plan: Sm90Tf32Plan, plane: tuple[int, int],
              padding, relu: bool, pool: int, lo_terms: bool = True
              ) -> Tf32ConvArgs:
    """Every integer of one launch on ``plan``: a forward of x against w
    (HWIO) onto the ``plane`` (ho, wo) before the pool (one phase), or,
    where ``plan`` has phases, a data gradient of x = gy against the
    forward's w onto the plane (h, wd) of dx, stored at the stride."""
    b, h, wd, ci = xshape
    hk, wk, wd1, wd0 = wshape
    a = Tf32ConvArgs()
    g = a.g
    oh, ow = plane
    if plan.phases:
        phases, win_w = plan.phases, plan.win_w
        g.osy, g.osx = plan.phases[-1][0] + 1, plan.phases[-1][1] + 1
        co = wd1
    else:
        phases = ((0, 0, oh, ow, -padding[0], -padding[1], 0,
                   len(plan.win_off)),)
        win_w = range(hk * wk)
        g.osy = g.osx = 1
        co = wd0
    tiles = 0
    for i, (qy, qx, hq, wq, y0, x0, win0, nwin) in enumerate(phases):
        nty, ntx = max(1, ceil_div(hq, plan.ty)), max(1, ceil_div(wq, plan.tx))
        g.ph[i] = Tf32Phase(hq, wq, nty, ntx, y0, x0, qy, qx, win0,
                            nwin if min(hq, wq) > 0 else 0)
        tiles = max(tiles, ceil_div(b, plan.bb) * nty * ntx)
    g.B, g.OH, g.OW, g.Co = b, oh, ow, co
    g.bb, g.ty, g.tx = plan.bb, plan.ty, plan.tx
    g.ncb = ceil_div(ci, TF32_BK)
    g.sy, g.sx = plan.stride
    g.nparts, g.part_bytes = len(plan.parts), plan.part_bytes
    g.h_stage = plan.h_stage
    g.halo_tx = len(plan.parts) * plan.bb * plan.hy * plan.hx * 128
    g.row_step = plan.sbo
    g.pool, g.relu, g.wt = pool, int(relu), int(plan.wt)
    g.lo_mask = 0xFFFFFFFF if lo_terms else 0
    g.blk_off[:] = plan.blk_off
    for i, (ry, rx) in enumerate(plan.parts):
        g.part_y[i], g.part_x[i] = ry, rx
    g.win_off[:len(plan.win_off)] = plan.win_off
    g.win_w[:len(plan.win_off)] = tuple(win_w)
    a.H, a.W, a.Ci = h, wd, ci
    a.wd0, a.wd1, a.wd2 = wd0, wd1, hk * wk
    (a.es_y, a.es_x) = plan.es
    a.box_y, a.box_x = plan.hy * a.es_y, plan.hx * a.es_x
    a.bn, a.nphase, a.tiles = plan.bn, len(phases), tiles
    a.smem_bytes = plan.smem_bytes
    return a


class Tf32Launch:
    """The launcher of one geometry on ``csrc/conv_lb_sm90_tf32.cu``:
    its packed arguments, into which each call writes only the pointers
    and the stream."""

    def __init__(self, out_shape: tuple, args: Tf32ConvArgs):
        self.out_shape, self.args = out_shape, args
        self.ref = ctypes.byref(args)
        self.lib = self.fn = None

    def __call__(self, x, w, bias, residual) -> torch.Tensor:
        out = torch.empty(self.out_shape, dtype=x.dtype, device=x.device)
        on_device(x.device, lambda stream: self.fire(
            x, w, bias, residual, out, stream))
        return out

    def fire(self, x, w, bias, residual, out, stream: int) -> None:
        """Fill in the pointers and the stream and call the C entry."""
        if self.fn is None:
            self.lib, self.fn = _entry_struct(TF32_SOURCE,
                                              "conv_lb_sm90_tf32_launch",
                                              Tf32ConvArgs)
        a = self.args
        a.x, a.w, a.out, a.stream = (x.data_ptr(), w.data_ptr(),
                                     out.data_ptr(), stream)
        a.bias = None if bias is None else bias.data_ptr()
        a.res = None if residual is None else residual.data_ptr()
        err = self.fn(self.ref)
        if err:
            _launched(self.lib, err, "conv_lb_sm90_tf32")


def _sm90_tf32(x, w, bias, residual, ho: int, wo: int, padding,
               relu: bool, pool: int, plan: Sm90Tf32Plan,
               lo_terms: bool = True) -> torch.Tensor:
    """One launch of ``csrc/conv_lb_sm90_tf32.cu`` on the tile and
    offsets of ``plan``: :func:`sm90_tf32_plan`'s, or a wrong one that a
    check passes to show that the card's gate sees it, packed anew.  w's
    input channels may be fewer than x's (the 1x1 conv of an im2col
    plane): the weight map reads zeros past them.  ``lo_terms=False``
    drops the lo words (1xTF32): a control that the card's gate sees the
    small terms, never a route."""
    co = w.shape[-1]
    return Tf32Launch((x.shape[0], ho // pool, wo // pool, co),
                      tf32_args(x.shape, w.shape, plan, (ho, wo), padding,
                                relu, pool, lo_terms))(x, w, bias, residual)


def dgrad_route(gy: torch.Tensor, w: torch.Tensor, stride, h: int,
                wd: int, padding, dilation=(1, 1)) -> str:
    """The route of :func:`conv_lb_dgrad`: ``"sm90_tf32"`` (by output
    phases, one launch) where :func:`dgrad_plan` gives a plan; else
    ``"composed"``: gy padded, lhs-dilated by the stride against a
    flipped copy of w on :func:`conv_lb`'s route (the FMA kernel at a
    stride), then cropped.  Read before launch."""
    plan = dgrad_plan(operand_type(gy, w), tuple(gy.shape), tuple(w.shape),
                      tuple(stride), tuple(padding), tuple(dilation), h, wd,
                      aligned(gy, w))
    return "composed" if plan is None else "sm90_tf32"


@lru_cache(maxsize=4096)
def dgrad_plan(dtype: torch.dtype | None, gyshape: tuple, wshape: tuple,
               stride, padding, dilation, h: int, wd: int,
               aligned: bool = True) -> Sm90Tf32Plan | None:
    """The shape-only core of :func:`dgrad_route`: the
    :func:`sm90_tf32_dgrad_plan` of f32 gy ``gyshape`` and w ``wshape``
    (``dtype`` their one type), both bases 16-byte ``aligned``, at a
    stride other than (1, 1) up to ``TF32_MAX_STRIDE``, Ci and Co
    multiples of 4; ``None`` where the dgrad is composed."""
    hk, wk, ci, co = wshape
    stride = tuple(stride)
    if not (dtype == torch.float32 and stride != (1, 1)
            and max(stride) <= TF32_MAX_STRIDE and aligned
            and ci % 4 == 0 and co % 4 == 0):
        return None
    return sm90_tf32_dgrad_plan(gyshape[0], h, wd, ci, co, hk, wk, stride,
                                tuple(padding), tuple(dilation))


def dgrad_on_kernel(hk: int, wk: int, padding, dilation=(1, 1)) -> bool:
    """Whether K1 runs a conv's dgrad: not for a padding past the
    full-padding transform (the dgrad conv's padding would be
    negative), as the reference's ``dgrad_rides_kernel``."""
    (py, px), (dy, dx) = padding, dilation
    return py <= (hk - 1) * dy and px <= (wk - 1) * dx


def dgrad_launch(dtype: torch.dtype | None, gyshape: tuple, wshape: tuple,
                 stride, padding, dilation, h: int, wd: int,
                 aligned: bool = True):
    """The K1 launch :func:`conv_lb_dgrad` makes, from shapes alone, as
    ``(kernel, route, plan, shape, dtype)`` for
    :func:`~repro_torch.analysis.plan_check.check_launch_plan`: one
    ``conv_lb_dgrad`` launch by output phases, or the composed form's
    ``conv_lb`` launch (gy with a zero row and column appended at a
    stride, lhs-dilated by it against the flipped w)."""
    stride, padding = tuple(stride), tuple(padding)
    dilation = tuple(dilation)
    plan = dgrad_plan(dtype, gyshape, wshape, stride, padding, dilation, h,
                      wd, aligned)
    if plan is not None:
        return ("conv_lb_dgrad", "sm90_tf32", plan,
                (gyshape, wshape, stride, padding, dilation, h, wd), dtype)
    hk, wk, ci, co = wshape
    b, gh, gw, _ = gyshape
    (ey, ex), padding = _composed(stride, padding, dilation, hk, wk)
    conv = ((b, gh + ey, gw + ex, co), (hk, wk, co, ci), (1, 1), padding,
            dilation, stride, 1)
    return ("conv_lb", *launch_plan(dtype, *conv, aligned), conv, dtype)


def _composed(stride, padding, dilation, hk: int, wk: int):
    """The composed data gradient's geometry: the zero rows and columns
    appended to gy (one at a stride: its dilated plane otherwise ends
    ``(h + 2p - ekh) % s`` rows short of the last input rows) and the
    padding of its lhs-dilated conv against the flipped w (the full
    padding)."""
    (sy, sx), (py, px), (dy, dx) = stride, padding, dilation
    return ((int(sy > 1), int(sx > 1)),
            ((hk - 1) * dy - py, (wk - 1) * dx - px))


def conv_lb_dgrad(gy: torch.Tensor, w: torch.Tensor, *, stride, padding,
                  dilation=(1, 1), h: int, wd: int) -> torch.Tensor:
    """dx (B, h, wd, Ci) of one group of the conv x -> gy (B, Ho, Wo,
    Co) with w (Hk, Wk, Ci, Co) at ``stride``, ``padding`` and
    ``dilation``.

    At a stride on a CUDA gy, on route ``"sm90_tf32"``
    (:func:`dgrad_route`, read once per geometry key) one launch of the
    3xTF32 kernel by output phases (:func:`sm90_tf32_dgrad_plan`); else
    (route ``"composed"``, a stride of 1, a CPU gy) gy with
    ``(h + 2p - ekh) % s`` zero rows and columns appended, lhs-dilated
    by the stride against w's flipped copy through :func:`conv_lb`, then
    cropped to (h, wd)."""
    if gy.device.type == "cuda" and tuple(stride) != (1, 1):
        key = ("dgrad", operand_key(gy), operand_key(w), tuple(stride),
               tuple(padding), tuple(dilation), h, wd)
        entry, fresh = launch_cache.get(key, lambda: _prepare_dgrad(
            gy, w, tuple(stride), tuple(padding), tuple(dilation), h, wd))
        if entry.route == "sm90_tf32":
            try:
                dx = entry.launch(gy, w, None, None)
            except BaseException:
                if fresh:
                    launch_cache.drop(key)
                raise
            conv_lb.launches += 1
            conv_lb.launches_by_route[entry.route] += 1
            return dx
    (ey, ex), full = _composed(tuple(stride), tuple(padding),
                               tuple(dilation), w.shape[0], w.shape[1])
    if ey or ex:
        gy = F.pad(gy, (0, 0, 0, ex, 0, ey))
    gx = conv_lb(gy, flip_w(w), stride=(1, 1), padding=full,
                 dilation=tuple(dilation), lhs_dilation=tuple(stride))
    return gx[:, :h, :wd].contiguous()


def _prepare_dgrad(gy, w, stride, padding, dilation, h: int,
                   wd: int) -> _Launch:
    hk, wk, ci, co = w.shape
    _check_cuda_operand("gy", gy, gy.device, tuple(gy.shape), gy.dtype)
    _check_cuda_operand("w", w, gy.device, (hk, wk, ci, co), gy.dtype)
    plan = dgrad_plan(operand_type(gy, w), tuple(gy.shape), (hk, wk, ci, co),
                      stride, padding, dilation, h, wd, aligned(gy, w))
    if plan is None:
        return _Launch("composed", None, None)
    return _Launch("sm90_tf32", plan, Tf32Launch(
        (gy.shape[0], h, wd, ci),
        tf32_args(gy.shape, w.shape, plan, (h, wd), (0, 0), False, 1)))


def _im2col_sm90(x, w, bias, residual, ho: int, wo: int, relu: bool,
                 pool: int, plan: Im2colPlan, inner=None) -> torch.Tensor:
    """Route ``sm90_im2col``: the plane on ``plan``'s taps, then its 1x1
    conv on the tensor-core kernel of x's type (``csrc/conv_lb_sm90.cu``
    in bf16, ``csrc/conv_lb_sm90_tf32.cu`` in f32, through ``inner``
    where the launch cache packed it) against w (Hk, Wk, Ci, Co) read as
    (1, 1, Hk*Wk*Ci, Co), the plane's channels past those rows times the
    weight map's zeros."""
    hk, wk, ci, co = w.shape
    plane = stage(x, plan.taps, ho, wo, plan.cp)
    conv_lb.stage_launches += 1
    wv = w.view(1, 1, hk * wk * ci, co)
    if inner is not None:
        return inner(plane, wv, bias, residual)
    launch = _sm90 if x.dtype == torch.bfloat16 else _sm90_tf32
    return launch(plane, wv, bias, residual, ho, wo, (0, 0), relu, pool,
                  plan.inner)


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
    refused = smem_rule(smem)
    if refused is not None:
        raise ValueError(f"a {hk}x{wk} stride {stride} dilation "
                         f"{dilation} conv: {refused.message}")
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


#: the launch entries of :func:`conv_lb` and :func:`conv_lb_dgrad`
launch_cache = LaunchCache()

conv_lb.launches = 0
conv_lb.launches_by_route = dict.fromkeys(ROUTES, 0)
conv_lb.stage_launches = 0
