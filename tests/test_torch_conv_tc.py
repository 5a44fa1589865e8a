"""K1's route ``sm90_tf32`` on the CPU: what the wrapper decides and
computes before it launches ``csrc/conv_lb_sm90_tf32.cu`` (f32 in
3xTF32 on ``wgmma``).

  * :func:`route`: ``sm90_tf32`` for f32 at stride 1 with Ci and Co
    multiples of 4, ``sm90_im2col`` for a small Ci (the plane, then the
    3xTF32 kernel as a 1x1 conv); ``fma`` off by one alignment (a base
    4 bytes off, Ci or Co not a multiple of 4), at stride 2, under lhs
    dilation, at pool 4 and for mixed types (on VGG16/224, its dgrads
    and ResNet-20/32: ``test_torch_conv_sm90.py``);
  * :func:`sm90_tf32_plan` fits shared memory as the kernel lays it
    out, is pool-aligned and ranks as documented; the 3xTF32 bound of
    the 13 forward convs is three products at the TF32 rate (1.49 ms);
  * a numpy model of the kernel's addressing and arithmetic, K step by
    K step: the halo of each Ci block as TMA lays it out (32 channels a
    128-byte row, 128-byte swizzle, zeros past every edge) read at each
    window's shift, each thread's A words loaded and split into hi and
    lo as the kernel does, the weight slice as TMA lays it out and the
    transposing warps' K-major hi and lo tiles in the permuted K order
    (K3's N-major path and its model, ``test_torch_matmul_tc.py``), each
    operand read as the tensor cores read TF32 (its top 19 bits), every
    k8 product added to the tensor cores' f32 sums rounding toward zero,
    the promotion into round-to-nearest sums every ``TF32_PROMOTE`` K
    steps, and the fused bias -> residual -> ReLU -> 2x2 pool epilogue on
    the accumulator rows.  Against the reference's ``conv2d_ref`` and
    ``conv2d_lb(..., fallback=True)`` on the same numpy inputs: max
    |model - reference| <= 2e-5 |reference| + 2e-4 (the reference's own
    f32 tolerance, ``tests/test_kernels.py``); the model without its lo
    terms (1xTF32) errs at least 4x more; at conv5_x's depth (K = 4608)
    the model without promotion errs more than with it;
  * the A loads and the transposers' stores are conflict-free;
  * the kernel's constants and C interface against the wrapper's.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_lb.ops import conv2d_lb as jax_conv2d_lb
from repro.kernels.conv_lb.ref import conv2d_ref as jax_conv2d_ref
from repro_torch.core.hopper_adapter import (PEAK_F32_FLOPS,
                                             PEAK_TF32_FLOPS, SM_COUNT,
                                             SMEM_PER_BLOCK)
from repro_torch.kernels.conv_lb import kernel as K
from repro_torch.models.cnn import resnet_graph, vgg_graph, vgg_layer_dims
from repro_torch.models.graph import graph_stages
from test_torch_matmul_tc import (_b_operand, _fragment, _rtz, _split,
                                  _swz, _tc, _transpose, _w_tile)

F32 = torch.float32


def _vgg_stages():
    params = {"convs": [{"w": torch.empty((3, 3, ci, co))}
                        for _, ci, co, _, _ in vgg_layer_dims()]}
    return graph_stages(vgg_graph(params), 224, 224)


def _resnet_stages():
    return graph_stages(resnet_graph(), 32, 32)


def _misaligned(*shape):
    """A contiguous f32 tensor whose base is 4 bytes past a 16-byte
    line."""
    n = int(np.prod(shape))
    t = torch.zeros(n + 4, dtype=F32)[1:n + 1].view(shape)
    assert t.data_ptr() % 16 == 4
    return t


# ---------------------------------------------------------------- route


@pytest.mark.parametrize("case,want", [
    ("f32", "sm90_tf32"),
    ("ci 4", "sm90_tf32"),
    ("ci 12", "sm90_tf32"),
    ("co 200", "sm90_tf32"),
    ("residual", "sm90_tf32"),
    ("pool 2", "sm90_tf32"),
    ("rhs dilation 2", "sm90_tf32"),
    ("ci 3", "sm90_im2col"),
    ("ci 6", "sm90_im2col"),
    ("ci 10", "fma"),
    ("co 10", "fma"),
    ("x off by 4 bytes", "fma"),
    ("w off by 4 bytes", "fma"),
    ("bias off by 4 bytes", "fma"),
    ("residual off by 4 bytes", "fma"),
    ("stride 2", "sm90_tf32"),
    ("stride 2 pool 2", "fma"),
    ("stride 9", "fma"),
    ("ci 3 stride 2", "fma"),
    ("lhs dilation 2", "fma"),
    ("pool 4", "fma"),
    ("f32 x, bf16 w", "fma"),
    ("bf16 bias", "fma"),
])
def test_route_reads_types_geometry_and_pointers(case, want):
    """Ci 6 has 54 taps (the plane takes it); Ci 10 has 90, more than
    the plane's 64.  A stride takes ``sm90_tf32`` up to TMA's traversal
    stride of 8, without a fused pool and not through the plane."""
    ci = {"ci 3": 3, "ci 4": 4, "ci 6": 6, "ci 10": 10,
          "ci 12": 12, "ci 3 stride 2": 3}.get(case, 64)
    co = {"co 10": 10, "co 200": 200}.get(case, 64)
    x = torch.zeros((2, 8, 8, ci))
    w = torch.zeros((3, 3, ci, co))
    kw = dict(bias=torch.zeros(co), padding=(1, 1))
    stride, lhs = (1, 1), (1, 1)
    if case == "x off by 4 bytes":
        x = _misaligned(*x.shape)
    elif case == "w off by 4 bytes":
        w = _misaligned(*w.shape)
    elif case == "bias off by 4 bytes":
        kw["bias"] = _misaligned(co)
    elif case.startswith("residual"):
        r = torch.zeros((2, 8, 8, co))
        kw["residual"] = _misaligned(*r.shape) if "off" in case else r
    elif case == "pool 2" or case == "pool 4":
        kw["pool"] = int(case[-1])
    elif case == "rhs dilation 2":
        kw["dilation"] = (2, 2)
    elif case in ("stride 2", "ci 3 stride 2", "stride 9"):
        stride = (int(case[-1]),) * 2
    elif case == "stride 2 pool 2":
        stride, kw["pool"] = (2, 2), 2
    elif case == "lhs dilation 2":
        lhs = (2, 2)
    elif case == "f32 x, bf16 w":
        w = w.to(torch.bfloat16)
    elif case == "bf16 bias":
        kw["bias"] = kw["bias"].to(torch.bfloat16)
    assert K.route(x, w, stride, lhs, **kw) == want


# ------------------------------------------------------ plan and bound


def _plan_cases():
    cases = []
    for st in _vgg_stages()[1:]:
        n = st.node
        cases.append(("vgg " + n.name, st.ho, st.wo, n.ci, n.co, 3, 1))
        cases.append(("vgg dgrad " + n.name, st.h, st.w, n.co, n.ci, 3, 1))
    for st in _resnet_stages():
        n = st.node
        if n.stride == 1 and n.ci % 4 == 0:
            cases.append(("resnet " + n.name, st.ho, st.wo, n.ci, n.co,
                          n.hk, 1))
    cases.append(("conv1_1 plane", 224, 224, 32, 64, 1, 1))
    cases.append(("dilation 2", 20, 20, 32, 48, 3, 2))
    return cases


def _smem(p: K.Sm90Tf32Plan) -> int:
    """The rings and barriers as csrc/conv_lb_sm90_tf32.cu lays them out:
    from a 1024-byte line the weight ring, the B ring (a hi and a lo
    tile a stage), the halo ring, then a full and an empty mbarrier per
    stage of each ring."""
    tile = p.bn * K.TF32_BK * 4
    return (1024 + K.TF32_W_STAGES * tile + K.TF32_B_STAGES * 2 * tile
            + K.TF32_H_STAGES * p.h_stage
            + 16 * (K.TF32_W_STAGES + K.TF32_B_STAGES + K.TF32_H_STAGES))


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name,ho,wo,ci,co,k,d", _plan_cases())
def test_tf32_plan_fits_and_is_pool_aligned(name, ho, wo, ci, co, k, d,
                                            batch):
    """Two 8 x 8 blocks a CTA, each on an 8-aligned row and column of one
    image (so a 2 x 2 pool window lies inside one consumer's registers),
    each halo stage a whole number of 1024-byte swizzle atoms, the
    rings within the card's shared memory."""
    p = K.sm90_tf32_plan(batch, ho, wo, co, ci, k, k, (d, d))
    assert p is not None
    assert (p.bb, p.ty, p.tx) in K.SM90_TILES and p.bn in K.TF32_BN
    assert p.hy == 8 + (k - 1) * d and p.hx == p.tx + (k - 1) * d
    assert p.h_stage % 1024 == 0 and p.h_stage >= p.bb * p.hy * p.hx * 128
    assert p.sbo == p.hx * 128
    assert p.blk_off == (0, ((p.bb - 1) * p.hy * p.hx + p.tx - 8) * 128)
    assert p.smem_bytes == _smem(p) <= SMEM_PER_BLOCK
    assert p.ctas == (-(-batch // p.bb) * -(-ho // 8) * -(-wo // p.tx)
                      * -(-co // p.bn))


@pytest.mark.parametrize("name,ho,wo,ci,co,k,d", _plan_cases())
def test_tf32_plan_ranks_fewest_waves_then_ctas_then_halo_then_width(
        name, ho, wo, ci, co, k, d):
    def key(lay):
        ctas = (-(-8 // lay["bb"]) * -(-ho // 8) * -(-wo // lay["tx"])
                * -(-co // lay["bn"]))
        return (-(-ctas // SM_COUNT) * lay["bn"], ctas * lay["bn"],
                lay["hy"] * lay["hx"] / (8 * lay["tx"]), -lay["bn"])
    lays = [K.sm90_tf32_layout(bb, ty, tx, bn, k, k, (d, d))
            for bn in K.TF32_BN for bb, ty, tx in K.SM90_TILES
            if bn == K.TF32_BN[0] or co > bn // 2]
    best = min((lay for lay in lays if lay["smem_bytes"] <= SMEM_PER_BLOCK),
               key=key)
    p = K.sm90_tf32_plan(8, ho, wo, co, ci, k, k, (d, d))
    assert (p.bb, p.tx, p.bn) == (best["bb"], best["tx"], best["bn"])


def test_tf32_plan_narrows_n_for_resnets_small_layers():
    """ResNet-20's 16- and 32-channel layers take 32-wide CTAs (TF32
    wgmma takes N a multiple of 8; the transposers a multiple of 32)."""
    assert K.sm90_tf32_plan(8, 32, 32, 16, 16, 3, 3).bn == 32
    assert K.sm90_tf32_plan(8, 16, 16, 32, 32, 3, 3).bn == 32
    assert K.sm90_tf32_plan(8, 14, 14, 512, 512, 3, 3).bn == 64


def test_tf32_plan_refuses_what_fits_no_tile():
    assert K.sm90_tf32_plan(1, 8, 8, 64, 64, 7, 7, (16, 16)) is None
    assert K.sm90_tf32_plan(1, 8, 8, 64, 64, 12, 12) is None   # 144 windows
    x, w = torch.zeros((1, 8, 8, 64)), torch.zeros((7, 7, 64, 64))
    assert K.route(x, w, dilation=(16, 16)) == "fma"
    assert K.route(x, w, dilation=(2, 2)) == "sm90_tf32"


def test_forward_bound_is_three_products_at_the_tf32_rate():
    """The 13 f32 VGG16/224 forward convs at batch 8: about 246 GFLOP,
    whose operations take at least 3.66 ms on FMA and 1.49 ms in
    3xTF32."""
    flops = sum(2.0 * 8 * h * w * 9 * ci * co
                for _, ci, co, h, w in vgg_layer_dims())
    assert 245e9 < flops < 250e9
    assert 3.66e-3 < flops / PEAK_F32_FLOPS < 3.67e-3
    assert 1.48e-3 < K.TF32_PRODUCTS * flops / PEAK_TF32_FLOPS < 1.50e-3


# ----------------------------------- numpy model of the 3xTF32 conv

BK = K.TF32_BK


def _halo_stage(xp: np.ndarray, margin: int, p: K.Sm90Tf32Plan, b0: int,
                y: int, x: int, cb: int) -> np.ndarray:
    """The halo of Ci block ``cb`` as the kernel's 4-D TMA loads lay it
    out in a stage: per box i (residue (ry, rx) = ``p.parts[i]``, at
    ``i * part_bytes``) ``bb`` images x ``hy`` x ``hx`` pixels from (y +
    ry, x + rx), every ``es``-th pixel of the tensor (the traversal
    stride), pixel row R's channel k at swz(R * 128 + 4k).  ``xp``
    carries zeros past every edge (TMA's out-of-bounds fill)."""
    (ey, ex) = p.es
    words = np.zeros(p.h_stage // 4, np.float32)
    r, k = np.meshgrid(np.arange(p.bb * p.hy * p.hx), np.arange(BK),
                       indexing="ij")
    for i, (ry, rx) in enumerate(p.parts):
        y0, x0 = y + ry + margin, x + rx + margin
        box = xp[b0:b0 + p.bb, y0:y0 + p.hy * ey:ey, x0:x0 + p.hx * ex:ex,
                 cb * BK:(cb + 1) * BK]
        assert box.shape[1:3] == (p.hy, p.hx)
        words[(i * p.part_bytes + _swz(r * 128 + 4 * k)) // 4] = \
            box.reshape(-1, BK)
    return words


def _threads(p: K.Sm90Tf32Plan):
    """Each consumer thread's A offset in the halo (pixel (2v, t/4) of
    its block: 2v box rows and t/4 pixels in, chunk 2c), its
    accumulator row r0 (r0 + 8: pixel (2v + 1, t/4)) and its c = lane %
    4, over the CTA's 256 consumer threads."""
    t = np.arange(256)
    cw, tid = t // 128, t % 128
    v, lane = tid // 32, tid % 32
    a_off = (np.asarray(p.blk_off)[cw] + 2 * v * p.sbo
             + (lane // 4) * 128 + (lane % 4) * 32)
    return a_off, cw * 64 + 16 * v + lane // 4, lane % 4


def _a_words(words: np.ndarray, at: np.ndarray, sbo: int) -> np.ndarray:
    """Each thread's 16 A words of one K step: its two pixels (the second
    one row step on), two 16-byte chunks a pixel, as the kernel loads
    them: [thread][pixel][8]."""
    out = np.empty((len(at), 2, 8), np.float32)
    for r in range(2):
        for h in range(2):
            base = _swz(at + r * sbo + h * 16)
            for i in range(4):
                out[:, r, 4 * h + i] = words[(base + 4 * i) // 4]
    return out


def _cta_sums(steps, p: K.Sm90Tf32Plan, promote: int, lo_terms: bool):
    """One CTA's 128 x bn sums from its K steps, each ``(words, w_tile,
    kmajor)``: the thread's A words, the weight slice as TMA laid it
    out; per k8 step the three products lo*hi + hi*lo + hi*hi on TF32
    operands into sums rounding toward zero, promoted into
    round-to-nearest sums every ``promote`` K steps."""
    _, r0, cq = _threads(p)
    acc = np.zeros((128, p.bn), np.float32)
    total = np.zeros_like(acc)
    since = 0
    steps = list(steps)
    for step, (words, w_words, kmajor) in enumerate(steps, 1):
        hi_t, lo_t = _transpose(w_words, p.bn, kmajor, lo_terms)
        for kk in range(BK // 8):
            a_hi, a_lo = _split(_fragment(words, r0, cq, kk), lo_terms)
            b_hi = _b_operand(hi_t, kk, p.bn)
            b_lo = _b_operand(lo_t, kk, p.bn)
            for a_op, b_op in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                prod = (_tc(a_op).astype(np.float64)
                        @ _tc(b_op).astype(np.float64))
                acc = _rtz(acc.astype(np.float64) + prod)
        since += 1
        if promote and since == promote and step < len(steps):
            total = (total + acc).astype(np.float32)
            acc = np.zeros_like(acc)
            since = 0
    return total + acc


def _model(x, w, bias, res, *, pad, dil=(1, 1), pool=1, relu=True,
           plan=None, promote=K.TF32_PROMOTE, lo_terms=True,
           stride=(1, 1)) -> np.ndarray:
    """The kernel's output, CTA by CTA and K step by K step, from its
    plan's tile and offsets (at ``stride``: each Ci block's halo boxes
    from (sy*oy0 - py, sx*ox0 - px) plus their residues)."""
    b, h, wd, ci = x.shape
    hk, wk, _, co = w.shape
    (sy, sx) = stride
    ho = (h + 2 * pad[0] - (hk - 1) * dil[0] - 1) // sy + 1
    wo = (wd + 2 * pad[1] - (wk - 1) * dil[1] - 1) // sx + 1
    p = plan or K.sm90_tf32_plan(b, ho, wo, co, ci, hk, wk, dil, stride)
    ncb = -(-ci // BK)
    margin = 2 * max(p.hy, p.hx) * max(p.es) + max(pad) + 16
    xp = np.zeros((b + p.bb, h + 2 * margin, wd + 2 * margin, ncb * BK),
                  np.float32)
    xp[:b, margin:margin + h, margin:margin + wd, :ci] = x
    npad = -(-co // p.bn) * p.bn
    wp = np.zeros((hk * wk, ncb * BK, npad), np.float32)
    wp[:, :ci, :co] = w.reshape(hk * wk, ci, co)
    a_off, _, _ = _threads(p)
    pre = np.zeros((b + p.bb, ho + 16, wo + 16, npad), np.float32)
    for b0 in range(0, b, p.bb):
        for oy0 in range(0, ho, p.ty):
            for ox0 in range(0, wo, p.tx):
                for n0 in range(0, co, p.bn):
                    def steps():
                        for cb in range(ncb):
                            halo = _halo_stage(xp, margin, p, b0,
                                               sy * oy0 - pad[0],
                                               sx * ox0 - pad[1], cb)
                            for win in range(hk * wk):
                                yield (_a_words(halo, a_off + p.win_off[win],
                                                p.sbo),
                                       _w_tile(wp[win, cb * BK:(cb + 1) * BK,
                                                  n0:n0 + p.bn], False),
                                       False)

                    sums = _cta_sums(steps(), p, promote, lo_terms)
                    # accumulator row m: consumer m // 64, block pixel
                    # ((m % 64) // 8, m % 8)
                    for cw in range(2):
                        bi = b0 + cw * (p.bb - 1)
                        xo = ox0 + cw * (p.tx - 8)
                        pre[bi, oy0:oy0 + 8, xo:xo + 8, n0:n0 + p.bn] = \
                            sums[64 * cw:64 * (cw + 1)].reshape(8, 8, p.bn)
    v = pre[:b, :ho, :wo, :co]
    if bias is not None:
        v = v + bias
    if res is not None:
        v = v + res
    if relu:
        v = np.maximum(v, 0.0)
    if pool > 1:
        v = v.reshape(b, ho // 2, 2, wo // 2, 2, co).max(axis=(2, 4))
    return v.astype(np.float32)


def _dgrad_model(gy, w, *, stride, pad, h, wd, dil=(1, 1), plan=None,
                 promote=K.TF32_PROMOTE, lo_terms=True) -> np.ndarray:
    """The kernel's dx by output phases, CTA by CTA and K step by K step,
    from :func:`K.sm90_tf32_dgrad_plan`: phase (qy, qx)'s tiles over its
    plane, each Ci block's halo of the compact gy from (my0 + y0, mx0 +
    x0), the phase's windows at their shifts against w's slice of tap
    ``win_w`` as TMA lays it out (rows the output channels n: K-major,
    read by the transposers' 16-byte chunks), the sums stored at (s*my
    + qy, s*mx + qx)."""
    b, ho, wo, co = gy.shape
    hk, wk, ci, _ = w.shape
    p = plan or K.sm90_tf32_dgrad_plan(b, h, wd, ci, co, hk, wk,
                                       tuple(stride), tuple(pad), tuple(dil))
    ncb = -(-co // BK)
    margin = 2 * max(p.hy, p.hx) + 16
    gp = np.zeros((b + p.bb, ho + 2 * margin, wo + 2 * margin, ncb * BK),
                  np.float32)
    gp[:b, margin:margin + ho, margin:margin + wo, :co] = gy
    npad = -(-ci // p.bn) * p.bn
    # B of tap t: K = co (gy's channels), N = ci; w[ky, kx, ci, co]
    wt = np.zeros((hk * wk, ncb * BK, npad), np.float32)
    wt[:, :co, :ci] = w.reshape(hk * wk, ci, co).transpose(0, 2, 1)
    a_off, _, _ = _threads(p)
    sy, sx = stride
    dx = np.full((b + p.bb, h + 16 * sy, wd + 16 * sx, npad), np.nan,
                 np.float32)
    for qy, qx, hq, wq, y0, x0, win0, nwin in p.phases:
        for b0 in range(0, b, p.bb):
            for my0 in range(0, hq, p.ty):
                for mx0 in range(0, wq, p.tx):
                    for n0 in range(0, ci, p.bn):
                        def steps():
                            for cb in range(ncb):
                                halo = _halo_stage(gp, margin, p, b0,
                                                   my0 + y0, mx0 + x0, cb)
                                for i in range(win0, win0 + nwin):
                                    yield (_a_words(halo,
                                                    a_off + p.win_off[i],
                                                    p.sbo),
                                           _w_tile(wt[p.win_w[i],
                                                      cb * BK:(cb + 1) * BK,
                                                      n0:n0 + p.bn], True),
                                           True)

                        sums = _cta_sums(steps(), p, promote, lo_terms)
                        for cw in range(2):
                            bi = b0 + cw * (p.bb - 1)
                            for m in range(64):
                                my = my0 + m // 8
                                mx = mx0 + cw * (p.tx - 8) + m % 8
                                if my < hq and mx < wq:
                                    dx[bi, sy * my + qy, sx * mx + qx,
                                       n0:n0 + p.bn] = sums[64 * cw + m]
    out = dx[:b, :h, :wd, :ci]
    assert not np.isnan(out).any()      # every dx pixel stored once
    return out


def _inputs(b, h, ci, co, k, pad, d, res, seed):
    rng = np.random.default_rng(seed)
    ho = h + 2 * pad - (k - 1) * d
    x = rng.standard_normal((b, h, h, ci)).astype(np.float32)
    w = (rng.standard_normal((k, k, ci, co))
         / np.sqrt(k * k * ci)).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    r = (rng.standard_normal((b, ho, ho, co)).astype(np.float32)
         if res else None)
    return x, w, bias, r


def _reference(x, w, bias, r, *, pad, d, pool):
    return np.asarray(jax_conv2d_lb(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
        None if r is None else jnp.asarray(r), padding=pad, dilation=d,
        relu=True, pool=pool, fallback=True))


def _exact_err(got, x, w, bias, r, *, pad, d, pool):
    """max |got - float64 conv| / max |float64 conv|, the epilogue in
    float64."""
    t = [None if a is None else torch.from_numpy(a).double()
         for a in (x, w, bias, r)]
    ref = torch.nn.functional.conv2d(
        t[0].permute(0, 3, 1, 2), t[1].permute(3, 2, 0, 1), t[2],
        padding=pad, dilation=d).permute(0, 2, 3, 1)
    if t[3] is not None:
        ref = ref + t[3]
    ref = torch.clamp_min(ref, 0.0)
    if pool > 1:
        ref = torch.nn.functional.max_pool2d(
            ref.permute(0, 3, 1, 2), pool).permute(0, 2, 3, 1)
    ref = ref.numpy()
    return np.abs(got - ref).max() / np.abs(ref).max()


# b, h, ci, co, k, pad, dilation, pool, residual: a few channels (a Ci
# block past Ci), 3x3 at pads 0 and 1, dilation 2, a fused pool, a
# residual join, a ragged tile, two Ci blocks, Co past one CTA's width,
# the im2col plane's 1x1 conv
MODEL_CASES = [
    (2, 10, 8, 16, 3, 1, 1, 2, False),
    (1, 12, 4, 24, 3, 0, 1, 1, True),
    (2, 14, 12, 32, 3, 2, 2, 1, False),
    (3, 9, 40, 72, 3, 1, 1, 1, True),
    (1, 16, 16, 140, 3, 1, 1, 2, True),
    (2, 12, 32, 64, 1, 0, 1, 2, False),
]


@pytest.mark.parametrize("b,h,ci,co,k,pad,d,pool,res", MODEL_CASES)
def test_tf32_model_reproduces_the_reference(b, h, ci, co, k, pad, d, pool,
                                             res):
    x, w, bias, r = _inputs(b, h, ci, co, k, pad, d, res, seed=h + ci + co)
    got = _model(x, w, bias, r, pad=(pad, pad), dil=(d, d), pool=pool)
    ref = _reference(x, w, bias, r, pad=pad, d=d, pool=pool)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-4)
    if r is None:
        plain = np.asarray(jax_conv2d_ref(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), padding=pad,
            dilation=d, relu=True, pool=pool))
        np.testing.assert_allclose(got, plain, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("tile", K.SM90_TILES)
def test_tf32_model_at_every_tile_shape(tile):
    """Both pixel tiles (two blocks side by side, or in two images) at
    each width, the consumers' block offsets and windows as the layout
    gives them."""
    x, w, bias, r = _inputs(3, 11, 8, 40, 3, 1, 1, True, seed=5)
    ref = _reference(x, w, bias, r, pad=1, d=1, pool=1)
    for bn in K.TF32_BN:
        lay = K.sm90_tf32_layout(*tile, bn, 3, 3, (1, 1))
        plan = K.Sm90Tf32Plan(**lay, ctas=0)
        got = _model(x, w, bias, r, pad=(1, 1), plan=plan)
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("b,h,ci,co,k,pad,d,pool,res", MODEL_CASES[:3])
def test_tf32_model_without_lo_terms_errs_more(b, h, ci, co, k, pad, d,
                                               pool, res):
    x, w, bias, r = _inputs(b, h, ci, co, k, pad, d, res, seed=h + ci + co)
    kw = dict(pad=(pad, pad), dil=(d, d), pool=pool)
    right = _exact_err(_model(x, w, bias, r, **kw), x, w, bias, r,
                       pad=pad, d=d, pool=pool)
    one = _exact_err(_model(x, w, bias, r, lo_terms=False, **kw), x, w,
                     bias, r, pad=pad, d=d, pool=pool)
    assert one >= 4 * right


def test_tf32_model_at_conv5_depth_needs_its_promotion():
    """conv5_x's K = 3 * 3 * 512 = 4608 (144 K steps): the tensor cores'
    sums, rounding toward zero at every k8 product, drift with the range
    they sum; promoted every ``TF32_PROMOTE`` K steps into
    round-to-nearest sums the model stays within the f32 gate and under
    the plain f32 conv's own error from float64, and without promotion
    it errs more.  No bias: the sums are the whole output."""
    x, w, _, _ = _inputs(1, 8, 512, 32, 3, 1, 1, False, seed=9)
    kw = dict(pad=(1, 1), pool=1, relu=False)
    promoted = _model(x, w, None, None, **kw)
    never = _model(x, w, None, None, promote=0, **kw)
    ref = np.asarray(jax_conv2d_lb(jnp.asarray(x), jnp.asarray(w),
                                   padding=1, fallback=True))
    np.testing.assert_allclose(promoted, ref, rtol=2e-5, atol=2e-4)
    exact = np.asarray(torch.nn.functional.conv2d(
        torch.from_numpy(x).double().permute(0, 3, 1, 2),
        torch.from_numpy(w).double().permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1))
    scale = np.abs(exact).max()
    err_p = np.abs(promoted - exact).max() / scale
    err_n = np.abs(never - exact).max() / scale
    plain = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w).permute(3, 2, 0, 1), padding=1)
    err_plain = np.abs(plain.permute(0, 2, 3, 1).numpy() - exact).max() / scale
    assert err_p < err_plain < err_n
    assert err_n > 2 * err_p


# ----------------------------- strides: the halo as parts, dgrad phases

# b, h, w, ci, co, k, stride, pad: ResNet-20's four strided convs at
# batch 2 (3x3/2 and 1x1/2 at 32 -> 16 and 16 -> 8: 32 + 2 - 3 = 31, so
# the data gradient's gy plane ends one row short of dx's last rows, the
# row the lhs-dilated form appends), stride (1, 2) on a ragged plane,
# and a 15 x 13 plane at 3x3/2, whose last dx rows every tap reaches
STRIDED_CASES = [
    (2, 32, 32, 16, 32, 3, (2, 2), 1),
    (2, 32, 32, 16, 32, 1, (2, 2), 0),
    (2, 16, 16, 32, 64, 3, (2, 2), 1),
    (2, 16, 16, 32, 64, 1, (2, 2), 0),
    (1, 10, 13, 8, 12, 3, (1, 2), 1),
    (2, 15, 13, 4, 8, 3, (2, 2), 1),
]


def _strided_inputs(b, h, w, ci, co, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    wt = (rng.standard_normal((k, k, ci, co))
          / np.sqrt(k * k * ci)).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    return x, wt, bias


@pytest.mark.parametrize("b,h,w,ci,co,k,s,pad", STRIDED_CASES)
def test_tf32_strided_model_reproduces_the_reference(b, h, w, ci, co, k, s,
                                                     pad):
    """The halo as one box per residue at the traversal stride, each
    window reading its box densely at (ky*dly // sy, kx*dlx // sx):
    against the reference's ``conv2d_ref`` and ``conv2d_lb(...,
    fallback=True)`` within the reference's f32 tolerance (rtol 2e-5,
    atol 2e-4)."""
    x, wt, bias = _strided_inputs(b, h, w, ci, co, k, seed=h + ci + k)
    got = _model(x, wt, bias, None, pad=(pad, pad), stride=s)
    kw = dict(stride=s, padding=pad, relu=True)
    ref = np.asarray(jax_conv2d_ref(jnp.asarray(x), jnp.asarray(wt),
                                    jnp.asarray(bias), **kw))
    lb = np.asarray(jax_conv2d_lb(jnp.asarray(x), jnp.asarray(wt),
                                  jnp.asarray(bias), fallback=True, **kw))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(got, lb, rtol=2e-5, atol=2e-4)


def test_tf32_strided_halo_read_at_stride_one_fails():
    """A strided launch whose plan reads its halo at stride 1 (each box
    loaded without the traversal stride: the card's control) misses the
    reference by far more than the tolerance."""
    b, h, w, ci, co, k, s, pad = STRIDED_CASES[0]
    x, wt, bias = _strided_inputs(b, h, w, ci, co, k, seed=1)
    p = K.sm90_tf32_plan(b, 16, 16, co, ci, k, k, (1, 1), s)
    bad = K.halo_at_stride_one(p)
    assert bad.es == (1, 1) and p.es == s
    ref = np.asarray(jax_conv2d_ref(jnp.asarray(x), jnp.asarray(wt),
                                    jnp.asarray(bias), stride=s,
                                    padding=pad, relu=True))
    right = _model(x, wt, bias, None, pad=(pad, pad), stride=s, plan=p)
    np.testing.assert_allclose(right, ref, rtol=2e-5, atol=2e-4)
    wrong = _model(x, wt, bias, None, pad=(pad, pad), stride=s, plan=bad)
    assert np.abs(wrong - ref).max() > 100 * (2e-4 + 2e-5 * np.abs(ref).max())


def _dgrad_reference(gy, wt, x_shape, s, pad):
    def f(x):
        return jax_conv2d_ref(x, jnp.asarray(wt), stride=s, padding=pad)

    _, vjp = jax.vjp(f, jnp.zeros(x_shape, jnp.float32))
    return np.asarray(vjp(jnp.asarray(gy))[0])


@pytest.mark.parametrize("b,h,w,ci,co,k,s,pad", STRIDED_CASES)
def test_tf32_dgrad_phases_reproduce_the_reference_vjp(b, h, w, ci, co, k,
                                                       s, pad):
    """dx by output phases, one launch: each phase a stride-1 conv of
    the compact gy over its own taps, stored at the stride, against the
    VJP of the reference's ``conv2d_ref`` within its f32 tolerance; no
    gy padding (the rows past gy are TMA's zeros) and no flipped copy of
    w (each window reads its tap, transposed)."""
    x, wt, _ = _strided_inputs(b, h, w, ci, co, k, seed=h + co)
    sy, sx = s
    ho, wo = (h + 2 * pad - k) // sy + 1, (w + 2 * pad - k) // sx + 1
    gy = np.random.default_rng(h).standard_normal(
        (b, ho, wo, co)).astype(np.float32)
    got = _dgrad_model(gy, wt, stride=s, pad=(pad, pad), h=h, wd=w)
    ref = _dgrad_reference(gy, wt, x.shape, s, pad)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-4)
    one = _dgrad_model(gy, wt, stride=s, pad=(pad, pad), h=h, wd=w,
                       lo_terms=False)
    exact = _dgrad_exact(gy, wt, x.shape, s, pad)
    assert (np.abs(one - exact).max()
            >= 4 * np.abs(got - exact).max())


def _dgrad_exact(gy, wt, x_shape, s, pad):
    t = torch.zeros(x_shape, dtype=torch.float64, requires_grad=True)
    out = torch.nn.functional.conv2d(
        t.permute(0, 3, 1, 2), torch.from_numpy(wt).double().permute(3, 2, 0, 1),
        stride=s, padding=pad)
    (g,) = torch.autograd.grad(out, t, torch.from_numpy(gy).double()
                               .permute(0, 3, 1, 2))
    return g.numpy()


@pytest.mark.parametrize("b,h,w,ci,co,k,s,pad", STRIDED_CASES)
def test_dgrad_phases_partition_taps_and_pixels(b, h, w, ci, co, k, s,
                                                pad):
    """Every tap lies in exactly one phase of each axis, each phase's
    stores cover exactly the dx pixels of its residue, and each window's
    shift is its tap's gy offset less the phase's halo origin."""
    sy, sx = s
    p = K.sm90_tf32_dgrad_plan(b, h, w, ci, co, k, k, s, (pad, pad))
    assert len(p.phases) == sy * sx and p.wt and p.parts == ((0, 0),)
    assert sorted(p.win_w) == list(range(k * k))
    cover = np.zeros((h, w), int)
    for qy, qx, hq, wq, y0, x0, win0, nwin in p.phases:
        assert (hq, wq) == (len(range(qy, h, sy)), len(range(qx, w, sx)))
        cover[qy::sy, qx::sx] += 1
        for i in range(win0, win0 + nwin):
            ky, kx = divmod(p.win_w[i], k)
            ey, ry = divmod(qy + pad - ky, sy)
            ex, rx = divmod(qx + pad - kx, sx)
            assert ry == rx == 0
            assert p.win_off[i] == ((ey - y0) * p.hx + ex - x0) * 128
            assert 0 <= ey - y0 < p.hy - p.ty + 1
    assert (cover == 1).all()


def test_dgrad_phase_taps_shifted_by_one_fail():
    """One phase's taps shifted by one (each window of the fullest
    phase one gy column off: the card's control) miss the reference."""
    b, h, w, ci, co, k, s, pad = STRIDED_CASES[0]
    x, wt, _ = _strided_inputs(b, h, w, ci, co, k, seed=3)
    gy = np.random.default_rng(3).standard_normal(
        (b, 16, 16, co)).astype(np.float32)
    p = K.sm90_tf32_dgrad_plan(b, h, w, ci, co, k, k, s, (pad, pad))
    bad = K.dgrad_phase_shifted(p)
    ref = _dgrad_reference(gy, wt, x.shape, s, pad)
    wrong = _dgrad_model(gy, wt, stride=s, pad=(pad, pad), h=h, wd=w,
                         plan=bad)
    assert np.abs(wrong - ref).max() > 100 * (2e-4 + 2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("k,s", [(3, (2, 2)), (1, (2, 2)), (3, (1, 2))])
def test_strided_a_loads_are_conflict_free(k, s):
    """At a stride, each window reads its box at consecutive halo rows:
    every quarter warp's 16-byte A loads fall in 8 distinct chunks, as
    at stride 1."""
    for tile in K.SM90_TILES:
        p = K.Sm90Tf32Plan(**K.sm90_tf32_layout(*tile, 64, k, k, (1, 1), s),
                           ctas=0)
        a_off, _, _ = _threads(p)
        for shift in p.win_off:
            for r in range(2):
                for hh in range(2):
                    addr = _swz(a_off + shift + r * p.sbo + hh * 16)
                    for quarter in range(256 // 8):
                        chunks = (addr[8 * quarter:8 * quarter + 8]
                                  % 128) // 16
                        assert len(set(chunks.tolist())) == 8


def test_dgrad_route_and_plan_on_resnet20():
    """ResNet-20's four strided convs' data gradients take ``sm90_tf32``
    in f32 (one launch by phases: four phases of 1, 2, 2 and 4 taps at a
    3x3/2, one tap and three zero phases at a 1x1/2); bf16 and a stride
    of 1 take the composed path."""
    for st in _resnet_stages():
        n = st.node
        gy = torch.zeros((8, st.ho, st.wo, n.co))
        w = torch.zeros((n.hk, n.wk, n.ci, n.co))
        s = (n.stride, n.stride)
        want = "sm90_tf32" if n.stride > 1 else "composed"
        assert K.dgrad_route(gy, w, s, st.h, st.w, (n.pad, n.pad)) == want
        assert K.dgrad_route(gy.bfloat16(), w.bfloat16(), s, st.h, st.w,
                             (n.pad, n.pad)) == "composed"
        if n.stride > 1:
            p = K.sm90_tf32_dgrad_plan(8, st.h, st.w, n.ci, n.co, n.hk,
                                       n.wk, s, (n.pad, n.pad))
            taps = sorted(ph[-1] for ph in p.phases)
            assert taps == ([1, 2, 2, 4] if n.hk == 3 else [0, 0, 0, 1])
            assert p.smem_bytes <= SMEM_PER_BLOCK


def test_launch_cache_plans_a_geometry_once_and_reroutes_a_misaligned_one(
        monkeypatch):
    """:func:`K.lookup` reads the route and plan once per geometry key
    (a second call with other tensors of the same shapes, types and
    alignment finds the entry), and a base 4 bytes off a 16-byte line is
    another key: it is planned anew, on ``fma``."""
    calls = []
    plan_of = K.plan_of

    def counted(*a, **kw):
        calls.append(1)
        return plan_of(*a, **kw)

    monkeypatch.setattr(K, "plan_of", counted)
    K.launch_cache.clear()
    before = K.launch_cache.plans
    kw = dict(stride=(2, 2), padding=(1, 1))
    x, w = torch.zeros((8, 32, 32, 16)), torch.zeros((3, 3, 16, 32))
    _, first, fresh = K.lookup(x, w, **kw)
    _, again, fresh2 = K.lookup(x.clone(), w.clone(), **kw)
    assert fresh and not fresh2 and again is first and len(calls) == 1
    assert first.route == "sm90_tf32" and first.plan.stride == (2, 2)
    _, off, fresh3 = K.lookup(_misaligned(*x.shape), w, **kw)
    assert fresh3 and off.route == "fma" and len(calls) == 2
    assert K.launch_cache.plans == before + 2
    args = first.launch.args
    assert (args.g.nparts, args.box_y, args.es_y) == (4, 18, 2)
    K.launch_cache.clear()


# ----------------------------------------------------- bank conflicts


@pytest.mark.parametrize("tile", K.SM90_TILES)
@pytest.mark.parametrize("k,d", [(3, 1), (3, 2), (1, 1), (5, 1)])
def test_a_loads_are_conflict_free(tile, k, d):
    """Every quarter warp's 16-byte A loads (8 lanes: two consecutive
    halo rows x 4 chunks) fall in 8 distinct 16-byte chunks of the banks
    at every window, pixel and half: one wavefront each."""
    p = K.Sm90Tf32Plan(**K.sm90_tf32_layout(*tile, 64, k, k, (d, d)),
                       ctas=0)
    a_off, _, _ = _threads(p)
    for shift in p.win_off:
        for r in range(2):
            for h in range(2):
                addr = _swz(a_off + shift + r * p.sbo + h * 16)
                for quarter in range(256 // 8):
                    chunks = (addr[8 * quarter:8 * quarter + 8] % 128) // 16
                    assert len(set(chunks.tolist())) == 8


def test_transposer_loads_and_stores_are_conflict_free():
    """A transposer warp loads 32 consecutive words of one swizzled
    128-byte weight row (a lane a column) and stores 16-byte chunks of 8
    rows of an atom per quarter warp."""
    lane = np.arange(32)
    for nb in range(128 // 32):
        n = nb * 32 + lane
        for k in range(BK):
            addr = _swz(nb * 4096 + k * 128 + lane * 4)
            assert len(set((addr // 4 % 32).tolist())) == 32
        for chunk in range(8):
            addr = n * 128 + ((chunk ^ (n % 8)) << 4)
            for quarter in range(4):
                chunks = (addr[8 * quarter:8 * quarter + 8] % 128) // 16
                assert len(set(chunks.tolist())) == 8


# ------------------------------------------- kernel against the wrapper


def _src() -> str:
    return K.TF32_SOURCE.read_text()


def test_tf32_kernel_constants_match_the_wrapper():
    src = _src()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kBK") == K.TF32_BK
    assert const("kWStages") == K.TF32_W_STAGES
    assert const("kBStages") == K.TF32_B_STAGES
    assert const("kHStages") == K.TF32_H_STAGES
    assert const("kTransposers") == K.TF32_TRANSPOSERS
    assert const("kMaxWin") == K.SM90_MAX_WIN
    assert const("kConsumers") == 2
    assert const("kPromote") == K.TF32_PROMOTE >= 1
    inst = {int(b) for b in re.findall(r"launch<(\d+)>\(", src)}
    assert inst == set(K.TF32_BN)
    assert all(bn % 32 == 0 for bn in K.TF32_BN)
    # ptxas holds a 384-thread CTA to 168 registers a thread: two
    # accumulators of BN / 2, two fragment buffers of 8 and 8 A words
    # leave the rest for addresses and the loop
    assert 2 * (max(K.TF32_BN) // 2) + 2 * 8 + 8 <= 168 - 16
    assert "uint32_t af[2][8];" in src and "float4 x[2];" in src


def c_struct_fields(src: str, name: str) -> list[tuple[str, str, int]]:
    """The fields of C struct ``name`` in ``src``, in order: ``(type,
    name, count)`` (count 1, or an array's length by its constant)."""
    body = re.search(rf"struct {name} {{(.*?)\n}};", src, re.S)[1]
    body = re.sub(r"//[^\n]*", "", body)
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", src)}
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        typ, names = re.match(r"((?:const )?\w+\*?)\s+(.*)", decl, re.S
                              ).groups()
        for item in names.split(","):
            item = item.strip()
            m = re.match(r"(\w+)\[(\w+)\]", item)
            if m:
                n = m[2]
                fields.append((typ, m[1], consts.get(n) or int(n)))
            else:
                fields.append((typ, item, 1))
    return fields


def ctypes_fields(struct) -> list[tuple[str, int]]:
    """``(name, count)`` of a ``ctypes.Structure``'s fields."""
    return [(n, getattr(t, "_length_", 1)) for n, t in struct._fields_]


def test_wrapper_binds_the_kernels_c_interface():
    """The lean entry takes one pointer to ``Args``; the wrapper's
    ``Tf32ConvArgs`` / ``Tf32ConvGeom`` / ``Tf32Phase`` lay out the
    kernel's ``Args`` / ``Geom`` / ``Phase`` field by field (pointers
    first, then ints, the nested geometry last), and binds the entry by
    name."""
    src = _src()
    assert re.search(r'extern "C" int conv_lb_sm90_tf32_launch\('
                     r'const void\* args\)', src)
    for c_name, struct in (("Args", K.Tf32ConvArgs),
                           ("Geom", K.Tf32ConvGeom),
                           ("Phase", K.Tf32Phase)):
        c = c_struct_fields(src, c_name)
        assert [(n, k) for _, n, k in c] == ctypes_fields(struct), c_name
        for typ, n, _ in c:
            assert (typ.endswith("*")) == (
                dict(struct._fields_)[n] is __import__("ctypes").c_void_p)
    assert ('_entry_struct(TF32_SOURCE,\n'
            in Path(K.__file__).read_text())
    assert '"conv_lb_sm90_tf32_launch"' in Path(K.__file__).read_text()
    assert "conv_lb_sm90_tf32_forward" not in src


def test_the_sweeps_copies_change_only_the_promotion_interval():
    """``launch/conv_tf32_promote.py`` builds each interval as a copy of
    the source with another ``kPromote``: the one line it rewrites is the
    kernel's only definition of the interval."""
    from repro_torch.launch import conv_tf32_promote as CP
    src = _src()
    assert len(CP.PROMOTE.findall(src)) == 1
    copy = CP.PROMOTE.sub("constexpr int kPromote = 7;", src)
    changed = [(a, b) for a, b in zip(src.splitlines(), copy.splitlines())
               if a != b]
    assert changed == [(f"constexpr int kPromote = {K.TF32_PROMOTE};",
                        "constexpr int kPromote = 7;")]
    assert [name for name, *_ in CP.LAYERS] == ["conv5_3", "conv3_2",
                                                "conv1_2"]
