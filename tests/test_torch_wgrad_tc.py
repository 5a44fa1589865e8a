"""K2's two newer tensor-core routes on the CPU: what the wrapper decides
and computes before it launches ``csrc/wgrad_lb_sm90_tf32.cu`` (f32 in
3xTF32) and ``csrc/wgrad_im2col.cu`` (the im2col plane of a small-Ci
layer, then a 1x1 wgrad on a tensor-core kernel).

  * :func:`route` for every case it reads: on VGG16/224 conv1_1 takes
    ``sm90_im2col`` in bf16 and f32, the 12 layers after it
    ``sm90_tf32`` in f32; on ResNet-20/32 the stride-2 layers and the
    1x1 projections stay on ``fma``; a misaligned base, an f32 Ci that
    neither a TMA map nor the plane takes, and mixed types stay on
    ``fma``;
  * the plain version of the im2col plane: its 1x1 wgrad, rows 0 ..
    Hk*Wk*Ci - 1, equals ``wgrad_ref`` and the reference's Pallas
    ``wgrad_lb_call`` at its interpret target at conv1_1's geometry;
  * :func:`sm90_tf32_wgrad_plan` fits shared memory and the register
    budget for every VGG16/224 and ResNet-20/32 layer the route takes
    (and the plane's 1x1 wgrads), at batch 1 and 8, and its split covers
    the reduction exactly in ranges of at most ``TF32_MAX_RANGE``;
  * the route and plan at VGG16/224's ImageNet batches (128, 256, 512),
    where the range caps need more than ``MAX_SPLITS`` ranges, and past
    the grid's limit (``fma``);
  * a numpy model of the 3xTF32 kernel's addressing and arithmetic: the
    A fragments each thread loads from the 128-byte-swizzled f32 halo at
    each window's shift (two adjacent channels an 8-byte load), the
    K-major hi and lo dy tiles the transposing warps write, the split
    (hi = trunc(v), v's top 19 bits, lo = v - hi) and the three products
    with each operand read as the tensor cores read TF32 (its top 19
    bits; the split is exact whether they truncate or round),
    the stores through the kernel's masks and the splits summed in
    order, against ``wgrad_ref`` and the reference's ``wgrad_lb_call``;
    the same model without the lo terms (1xTF32) errs at least 4x more.
    Tolerance: max |model - plain| <= 1e-5 * max |plain| (f32 sums in
    another order; the dropped lo*lo term and lo's own truncation are
    about 2^-20 of a product);
  * the kernels' constants and C interfaces against the wrapper's.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``).
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.conv_lb.ops import plan_conv as jax_plan_conv
from repro.kernels.conv_lb.ops import plan_conv_wgrad as jax_plan_wgrad
from repro.kernels.conv_lb.wgrad import wgrad_lb_call
from repro_torch.core.hopper_adapter import (PEAK_TF32_FLOPS,
                                             SMEM_PER_BLOCK)
from repro_torch.kernels.conv_lb import im2col as I
from repro_torch.kernels.conv_lb import kernel as K
from repro_torch.kernels.conv_lb import wgrad as W
from repro_torch.kernels.conv_lb.ref import im2col_ref, wgrad_ref
from repro_torch.models.cnn import resnet_graph, vgg_graph, vgg_layer_dims
from repro_torch.models.graph import graph_stages

BF = torch.bfloat16
F32 = torch.float32
TOL = 1e-5


def _vgg_stages():
    params = {"convs": [{"w": torch.empty((3, 3, ci, co))}
                        for _, ci, co, _, _ in vgg_layer_dims()]}
    return graph_stages(vgg_graph(params), 224, 224)


def _resnet_stages():
    return graph_stages(resnet_graph(), 32, 32)


def _geom(k=3, s=1, p=1, d=1):
    return W.WgradGeometry(hk=k, wk=k, stride=(s, s), padding=(p, p),
                           dilation=(d, d))


def _misaligned(*shape, dtype=F32):
    """A contiguous tensor whose base is 4 bytes past a 16-byte line."""
    n = int(np.prod(shape))
    step = 4 // torch.tensor([], dtype=dtype).element_size()
    t = torch.zeros(n + 16, dtype=dtype)[step:n + step].view(shape)
    assert t.data_ptr() % 16 == 4
    return t


# ---------------------------------------------------------------- route


@pytest.mark.parametrize("case,want", [
    ("f32", "sm90_tf32"),
    ("f32 ci 4", "sm90_tf32"),
    ("f32 ci 12", "sm90_tf32"),
    ("f32 co 12", "sm90_tf32"),
    ("f32 co 6", "fma"),
    ("f32 dilation 2", "sm90_tf32"),
    ("f32 stride 2", "sm90_tf32"),
    ("bf16 ci 64 stride 2", "fma"),
    ("f32 ci 3", "sm90_im2col"),
    ("f32 ci 7", "sm90_im2col"),
    ("f32 ci 10 (90 taps)", "fma"),
    ("f32 ci 3 co 6", "fma"),
    ("f32 ci 3 stride 2", "fma"),
    ("f32 x off by 4 bytes", "fma"),
    ("f32 dy off by 4 bytes", "fma"),
    ("f32 ci 3 x off by 4 bytes", "fma"),
    ("f32 x, bf16 dy", "fma"),
    ("bf16 x, f32 dy", "fma"),
    ("bf16 ci 3", "sm90_im2col"),
    ("bf16 ci 3 co 12", "fma"),
    ("bf16 ci 12 (108 taps)", "fma"),
    ("bf16 ci 7 5x5 (175 taps)", "fma"),
    ("bf16 ci 3 1x1", "sm90_im2col"),
    ("bf16 ci 64", "sm90"),
    ("f32 13x13 window (169 windows)", "fma"),
])
def test_route_reads_types_geometry_and_pointers(case, want):
    ci = int(re.search(r"ci (\d+)", case)[1]) if "ci " in case else 64
    co = int(re.search(r"co (\d+)", case)[1]) if "co " in case else 64
    xt = BF if case.startswith("bf16") else F32
    dt = BF if case.startswith("bf16") or "bf16 dy" in case else F32
    if case.startswith("bf16 x"):
        dt = F32
    x = torch.zeros((2, 8, 8, ci), dtype=xt)
    dy = torch.zeros((2, 8, 8, co), dtype=dt)
    geom = _geom()
    if "stride 2" in case:
        geom = _geom(s=2)
    elif "dilation 2" in case:
        geom = _geom(p=2, d=2)
    elif "1x1" in case:
        geom = _geom(k=1, p=0)
    elif "5x5" in case:
        geom = _geom(k=5, p=2)
    elif "13x13" in case:
        geom = _geom(k=13, p=6)
    if "x off" in case:
        x = _misaligned(*x.shape)
    elif "dy off" in case:
        dy = _misaligned(*dy.shape)
    assert W.route(x, dy, geom) == want


def test_route_on_vgg16():
    """conv1_1 (Ci = 3) through the plane in both types; the 12 layers
    after it on the tensor cores: f32 in 3xTF32, bf16 on
    ``csrc/wgrad_lb_sm90.cu``."""
    got = {BF: [], F32: []}
    for st in _vgg_stages():
        n = st.node
        for dtype in got:
            x = torch.zeros((1, st.h, st.w, n.ci), dtype=dtype)
            dy = torch.zeros((1, st.ho, st.wo, n.co), dtype=dtype)
            got[dtype].append(W.route(x, dy, _geom(s=n.stride, p=n.pad)))
    assert got[F32] == ["sm90_im2col"] + ["sm90_tf32"] * 12
    assert got[BF] == ["sm90_im2col"] + ["sm90"] * 12


@pytest.mark.parametrize("dtype", [BF, F32])
def test_route_on_resnet20(dtype):
    """The stem (Ci = 3) through the plane; the stride-1 3x3 convs on
    the tensor cores; the stride-2 3x3 convs and the 1x1/2 projections
    on the 3xTF32 kernel in f32 (the halo as parts at the traversal
    stride), on FMA in bf16."""
    tc = "sm90" if dtype == BF else "sm90_tf32"
    for st in _resnet_stages():
        n = st.node
        x = torch.zeros((1, st.h, st.w, n.ci), dtype=dtype)
        dy = torch.zeros((1, st.ho, st.wo, n.co), dtype=dtype)
        rt = W.route(x, dy, _geom(k=n.hk, s=n.stride, p=n.pad))
        want = ("sm90_im2col" if n.name == "stem" else
                "fma" if n.stride > 1 and dtype == BF else tc)
        assert rt == want, n.name


@pytest.mark.parametrize("dtype", [BF, F32])
def test_plan_of_names_the_new_routes_plans(dtype):
    """``plan_of`` at VGG16/224 batch 8: conv1_1's :class:`Im2colPlan`
    (a 32-channel plane, 27 taps with padding 1, the 1x1 plan of the
    route of its type), and each f32 layer's
    :func:`sm90_tf32_wgrad_plan`."""
    for st in _vgg_stages():
        n = st.node
        x = torch.zeros((8, st.h, st.w, n.ci), dtype=dtype)
        dy = torch.zeros((8, st.ho, st.wo, n.co), dtype=dtype)
        rt, plan = W.plan_of(x, dy, _geom())
        if rt == "sm90_im2col":
            assert plan.cp == 32 and len(plan.taps) == 9
            assert plan.taps[0] == (-1, -1) and plan.taps[8] == (1, 1)
            inner = (W.sm90_wgrad_plan if dtype == BF
                     else W.sm90_tf32_wgrad_plan)(8, 224, 224, 32, 64)
            assert plan.inner == inner and plan.splits == inner.splits
            assert plan.tile == (32, *inner.tile)
        elif rt == "sm90_tf32":
            assert plan == W.sm90_tf32_wgrad_plan(8, st.ho, st.wo, n.ci,
                                                  n.co, 3, 3, (1, 1))
            assert plan.tile == (plan.bn, plan.nwc, plan.cib, plan.splits)
        else:
            assert dtype == BF and rt == "sm90"


def _blocks(b, ho, wo):
    return b * -(-ho // 8) * -(-wo // 8)


@pytest.mark.parametrize("batch", [128, 256, 512])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_route_and_plan_hold_at_imagenet_batches(dtype, batch):
    """At VGG's ImageNet batch (256) and around it the range caps need
    more than ``MAX_SPLITS`` ranges on the 224 x 224 planes (f32 from 84
    images, bf16 from 335): every layer keeps its tensor-core route, and
    its plan at the call's size covers the reduction in ranges of at most
    the cap, one grid z index each.  Shapes only: the operands are one
    word expanded."""
    cap = W.SM90_MAX_RANGE if dtype == BF else W.TF32_MAX_RANGE
    tc = "sm90" if dtype == BF else "sm90_tf32"
    most = 0
    for st in _vgg_stages():
        n = st.node
        x = torch.zeros(1, dtype=dtype).expand(batch, st.h, st.w, n.ci)
        dy = torch.zeros(1, dtype=dtype).expand(batch, st.ho, st.wo, n.co)
        rt, plan = W.plan_of(x, dy, _geom())
        assert rt == W.route(x, dy, _geom())
        assert rt == ("sm90_im2col" if n.ci == 3 else tc), n.name
        inner, ci = (plan.inner, plan.cp) if rt == "sm90_im2col" else (
            plan, n.ci)
        k = 1 if rt == "sm90_im2col" else 3
        nblk = _blocks(batch, st.ho, st.wo)
        assert inner.nblk == nblk
        assert (inner.splits - 1) * inner.bps < nblk <= inner.splits * inner.bps
        assert inner.bps <= cap and inner.splits <= W.GRID_Z_MAX
        assert inner.ws_bytes == (4 * inner.splits * k * k * ci * n.co
                                  if inner.splits > 1 else 0)
        most = max(most, inner.splits)
    if _blocks(batch, 224, 224) > cap * W.MAX_SPLITS:
        assert most > W.MAX_SPLITS


@pytest.mark.parametrize("dtype", [BF, F32])
def test_route_past_the_grids_split_limit_is_fma(dtype):
    """A reduction that no split into ``GRID_Z_MAX`` ranges of at most the
    cap covers (a 224 x 224 plane past 21,399 images in bf16, 5,349 in
    f32) stays on FMA, planned by :func:`wgrad_split`."""
    cap = W.SM90_MAX_RANGE if dtype == BF else W.TF32_MAX_RANGE
    batch = -(-(W.GRID_Z_MAX * cap + 1) // 784)
    x = torch.zeros(1, dtype=dtype).expand(batch, 224, 224, 64)
    dy = torch.zeros(1, dtype=dtype).expand(batch, 224, 224, 64)
    assert W.route(x, dy, _geom()) == "fma"
    assert W.plan_of(x, dy, _geom()) == (
        "fma", W.wgrad_split(576, 64, batch * 224 * 224))
    x1 = torch.zeros(1, dtype=dtype).expand(batch - 1, 224, 224, 64)
    dy1 = torch.zeros(1, dtype=dtype).expand(batch - 1, 224, 224, 64)
    assert W.route(x1, dy1, _geom()) != "fma"


def test_launch_counters_by_route():
    assert set(W.wgrad_lb.launches_by_route) == set(W.ROUTES) == {
        "sm90", "sm90_tf32", "sm90_im2col", "fma"}
    assert isinstance(W.wgrad_lb.stage_launches, int)


# ------------------------------------------------------- the im2col plane


def _inputs(b, h, w, ci, co, k, pad, d, seed):
    rng = np.random.default_rng(seed)
    ho = h + 2 * pad - (k - 1) * d
    wo = w + 2 * pad - (k - 1) * d
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    dy = rng.standard_normal((b, ho, wo, co)).astype(np.float32)
    return x, dy, ho, wo


def _close(got: np.ndarray, want: np.ndarray) -> float:
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= TOL * np.abs(want).max(), err
    return err


@pytest.mark.parametrize("b,h,w,ci,co,k,pad,d", [
    (2, 12, 12, 3, 16, 3, 1, 1),      # conv1_1's geometry, small
    (1, 11, 9, 3, 8, 3, 2, 2),        # dilation 2
    (2, 10, 10, 7, 8, 3, 1, 1),       # 63 taps
])
def test_im2col_plane_as_a_1x1_wgrad_is_the_wgrad(b, h, w, ci, co, k, pad,
                                                  d):
    x, dy, ho, wo = _inputs(b, h, w, ci, co, k, pad, d, seed=ci + h)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    geom = _geom(k=k, p=pad, d=d)
    cp = I.im2col_channels(ci, k, k)
    plane = I.im2col_plane(xt, k, k, (pad, pad), (d, d))   # the plain one
    assert torch.equal(plane, im2col_ref(xt, k, k, padding=pad, dilation=d,
                                         channels=cp))
    assert plane.shape == (b, ho, wo, cp) and cp % 8 == 0
    assert not plane[..., k * k * ci:].any()
    one = wgrad_ref(plane, dyt, 1, 1).numpy().reshape(cp, co)
    got = one[:k * k * ci].reshape(k, k, ci, co)
    _close(got, wgrad_ref(xt, dyt, k, k, padding=pad, dilation=d).numpy())
    rplan = jax_plan_wgrad(jax_plan_conv(h, w, ci, co, k, k, batch=b,
                                         stride=(1, 1), padding=(pad, pad),
                                         dilation=(d, d)))
    # the reference kernel at its default, the interpret target
    ref_kernel = np.asarray(wgrad_lb_call(x, dy, rplan))
    _close(got, ref_kernel[..., :ci, :co])


def test_im2col_plane_sees_a_tap_one_column_off():
    """The card's control: one tap read one column off gives a dW far
    outside the tolerance."""
    b, h, w, ci, co = 1, 10, 10, 3, 8
    x, dy, _, _ = _inputs(b, h, w, ci, co, 3, 1, 1, seed=5)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    taps = list(I.im2col_taps(3, 3, (1, 1)))
    taps[4] = (taps[4][0], taps[4][1] + 1)
    plane = torch.cat([torch.nn.functional.pad(
        xt, (0, 0, 2, 2, 2, 2))[:, 2 + ty:2 + ty + h, 2 + tx:2 + tx + w]
        for ty, tx in taps], dim=-1)
    got = wgrad_ref(plane, dyt, 1, 1).reshape(3, 3, ci, co)
    want = wgrad_ref(xt, dyt, 3, 3, padding=1)
    assert (got - want).abs().max() > 100 * TOL * want.abs().max()


# ---------------------------------------------------------------- plan


def _tf32_cases():
    cases = []
    for st in _vgg_stages()[1:]:
        cases.append(("vgg " + st.node.name, st.ho, st.wo, st.node.ci,
                      st.node.co, 3))
    for st in _resnet_stages():
        n = st.node
        if n.stride == 1 and n.ci % 4 == 0 and n.co % 4 == 0:
            cases.append(("resnet " + n.name, st.ho, st.wo, n.ci, n.co,
                          n.hk))
    # the planes' 1x1 wgrads: VGG16's conv1_1, ResNet's stem
    cases.append(("vgg conv1_1 plane", 224, 224, 32, 64, 1))
    cases.append(("resnet stem plane", 32, 32, 32, 16, 1))
    return cases


def _tf32_smem(p: W.Sm90Tf32Plan) -> int:
    """Shared memory as csrc/wgrad_lb_sm90_tf32.cu lays it out: from a
    1024-byte line, per TMA stage a bn x 64-pixel f32 dy tile and cib /
    32 halo boxes; per B stage a hi and a lo tile of the same size; an
    mbarrier pair per stage of each ring."""
    tile = p.bn * 64 * 4
    return (1024 + p.stages * (tile + (p.cib // 32) * p.sub_bytes)
            + W.TF32_BSTAGES * 2 * tile + 16 * (p.stages + W.TF32_BSTAGES))


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name,ho,wo,ci,co,k", _tf32_cases())
def test_tf32_plan_fits_and_covers_the_reduction(name, ho, wo, ci, co, k,
                                                 batch):
    p = W.sm90_tf32_wgrad_plan(batch, ho, wo, ci, co, k, k, (1, 1))
    assert p is not None
    assert (p.bn, p.nwc) in W.TF32_TILES and p.cib in W.TF32_CIBS
    # registers: the sums and four steps of hi and lo A fragments
    assert p.nwc * p.bn // 2 + 4 * p.nwc * 8 <= 128
    assert p.cpr in W.TF32_CPRS and p.cpr <= p.cib
    assert p.smem_bytes == _tf32_smem(p) <= SMEM_PER_BLOCK
    assert 2 <= p.stages <= W.SM90_MAX_STAGES
    assert p.hy == 8 + k - 1 and p.hx == 8 + k - 1
    assert p.sub_bytes % 1024 == 0 and p.sub_bytes >= p.hy * p.hx * 128
    nblk = batch * -(-ho // 8) * -(-wo // 8)
    assert p.nblk == nblk
    assert (p.splits - 1) * p.bps < nblk <= p.splits * p.bps
    assert p.bps <= W.TF32_MAX_RANGE <= W.SM90_MAX_RANGE
    # every (channel slice, window group) row block of every Ci block,
    # and every column block, has a CTA; every window and channel has a
    # row
    nwg = -(-k * k // (64 // p.cpr))
    nrb = -(-min(p.cib, ci) // p.cpr) * nwg
    assert nwg * (64 // p.cpr) >= k * k
    assert -(-min(p.cib, ci) // p.cpr) * p.cpr >= min(p.cib, ci)
    assert p.tiles == -(-ci // p.cib) * -(-nrb // (2 * p.nwc)) * -(-co //
                                                                  p.bn)
    assert p.ws_bytes == (4 * p.splits * k * k * ci * co
                          if p.splits > 1 else 0)


def test_tf32_plan_refuses_what_fits_no_tile():
    assert W.sm90_tf32_wgrad_plan(1, 8, 8, 64, 64, 13, 13, (1, 1)) is None
    assert W.sm90_tf32_wgrad_plan(1, 8, 8, 64, 64, 3, 3, (125, 125)) is None
    assert W.sm90_tf32_wgrad_plan(1, 8, 8, 64, 64, 11, 11,
                                  (1, 1)) is not None


def test_tf32_bound_is_three_products_at_the_tf32_rate():
    """The 12 f32 VGG16/224 layers after conv1_1 at batch 8: about 245
    GFLOP, so 3xTF32 at 495 TFLOP/s bounds them near 1.48 ms."""
    flops = sum(2.0 * 8 * h * w * 9 * ci * co
                for _, ci, co, h, w in vgg_layer_dims()[1:])
    assert 240e9 < flops < 250e9
    assert PEAK_TF32_FLOPS == 495e12
    assert 1.45e-3 < W.TF32_PRODUCTS * flops / PEAK_TF32_FLOPS < 1.5e-3


# ---------------------------------- numpy model of the 3xTF32 kernel


def _tc(v: np.ndarray) -> np.ndarray:
    """A word as the tensor cores read a TF32 operand: its top 19 bits
    (sign, exponent, 10 mantissa bits), round toward zero."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _split(v: np.ndarray, lo_terms: bool) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's split: hi = trunc(v), v's top 19 bits, lo = v - hi
    (exact in f32), or 0 (the 1xTF32 control)."""
    v = np.asarray(v, np.float32)
    hi = _tc(v)
    lo = (v - hi) if lo_terms else np.zeros_like(v)
    return hi, lo.astype(np.float32)


def _rna(v: np.ndarray) -> np.ndarray:
    """A word rounded to TF32, to nearest with ties away from zero (what
    ``cvt.rna.tf32.f32`` gives)."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def test_tf32_split_is_exact_by_construction():
    """hi is a TF32 value (its low 13 bits zero), so the tensor cores read
    it unchanged whether they truncate or round an operand; hi + lo is v
    exactly in f32; lo read as TF32 either way errs under 2^-20 of |v|."""
    rng = np.random.default_rng(11)
    v = (rng.standard_normal(1 << 16)
         * np.exp2(rng.integers(-20, 20, 1 << 16))).astype(np.float32)
    hi, lo = _split(v, True)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.array_equal(_tc(hi), hi) and np.array_equal(_rna(hi), hi)
    assert np.array_equal(hi + lo, v)
    for read in (_tc, _rna):
        err = np.abs(hi.astype(np.float64) + read(lo) - v)
        assert (err <= np.exp2(-20) * np.abs(v)).all()


def _swz(off: np.ndarray) -> np.ndarray:
    """The 128-byte swizzle on offsets from a 1024-byte line: the 16-byte
    chunk (bits 4-6) XOR the 128-byte row within the line (bits 7-9)."""
    return off ^ ((off >> 3) & 0x70)


def _tma_stage(xp, dyp, p: W.Sm90Tf32Plan, pad, margin, b, oy0, ox0, ci0,
               n0) -> tuple[np.ndarray, np.ndarray]:
    """One TMA ring stage in f32 words, as the kernel's 4-D loads lay it
    out, 128-byte swizzled from 1024-byte lines: the dy tile (bn / 32
    boxes of 32 channels x 8 x 8 pixels, 8 KB apart) and the halo (slice
    q, channels ci0 + 32q .., at q * sub_bytes, its box i (residue (ry,
    rx) = ``p.parts[i]``) at i * part_bytes, [hy][hx] pixels of 128 bytes
    from (sy*oy0 - py + ry, sx*ox0 - px + rx), every ``es``-th pixel of
    the tensor).  ``xp`` and ``dyp`` carry zeros past every edge (TMA's
    out-of-bounds fill)."""
    dy_w = np.zeros(p.bn * 64, np.float32)
    for j in range(p.bn // 32):
        box = dyp[b, oy0:oy0 + 8, ox0:ox0 + 8, n0 + 32 * j:n0 + 32 * j + 32]
        off = j * 8192 + np.arange(64 * 128, step=4)
        dy_w[_swz(off) // 4] = box.reshape(-1)
    h_w = np.zeros((p.cib // 32) * p.sub_bytes // 4, np.float32)
    (sy, sx), (ey, ex) = p.stride, p.es
    for q in range(p.cib // 32):
        for i, (ry, rx) in enumerate(p.parts):
            y0 = sy * oy0 - pad[0] + ry + margin
            x0 = sx * ox0 - pad[1] + rx + margin
            box = xp[b, y0:y0 + p.hy * ey:ey, x0:x0 + p.hx * ex:ex,
                     ci0 + 32 * q:ci0 + 32 * q + 32]
            assert box.shape[:2] == (p.hy, p.hx)
            off = (q * p.sub_bytes + i * p.part_bytes
                   + np.arange(box.size * 4, step=4))
            h_w[_swz(off) // 4] = box.reshape(-1)
    return dy_w, h_w


def _transpose(dy_w: np.ndarray, bn: int, lo_terms: bool) -> np.ndarray:
    """The transposing warps: every unit (32-channel box nb, output row
    j, pixel parity h), lane n % 32, reads pixels 8j + 2t + h (t = 0..3)
    of channel n from the swizzled dy tile and writes their hi and lo
    words as one 16-byte chunk of row n of the K-major tiles (half j //
    4, chunk 2 (j % 4) + h, XOR n % 8).  Returns the B stage in words:
    the hi tile, then the lo tile."""
    nb, j, h, lane, t = np.meshgrid(np.arange(bn // 32), np.arange(8),
                                    np.arange(2), np.arange(32),
                                    np.arange(4), indexing="ij")
    src = nb * 8192 + (j * 8 + 2 * t + h) * 128 + lane * 4
    hi, lo = _split(dy_w[_swz(src) // 4], lo_terms)
    n = nb * 32 + lane
    dst = (j // 4) * (bn * 128) + n * 128 + ((((j % 4) * 2 + h) ^ (n % 8))
                                             << 4) + 4 * t
    out = np.full(2 * bn * 64, np.nan, np.float32)
    out[dst // 4] = hi
    out[bn * 64 + dst // 4] = lo
    assert not np.isnan(out).any()          # every word written once
    return out


def _read_b(words: np.ndarray, start: int, bn: int) -> np.ndarray:
    """The 8 x bn B tile wgmma reads from a K-major descriptor with the
    128-byte swizzle: row k, column n at the swizzle of start +
    (n // 8) * 1024 + (n % 8) * 128 + k * 4 bytes."""
    k = np.arange(8)[:, None]
    n = np.arange(bn)[None, :]
    addr = start + (n // 8) * 1024 + (n % 8) * 128 + k * 4
    return words[_swz(addr) // 4]


def _row_channel(rows: np.ndarray, r: int, nwg: int, cpr: int):
    """The kernel's row order: row ``w16 + g`` (g < 16) of row block
    ``r`` is channel ``(r // nwg) * cpr + w16 % cpr + 2 (g % 8) + g // 8``
    of window ``(r % nwg) * (64 / cpr) + w16 // cpr``: a thread's rows
    g and g + 8 are two adjacent channels."""
    w16, g = 16 * (rows // 16), rows % 16
    ch = (r // nwg) * cpr + w16 % cpr + 2 * (g % 8) + g // 8
    return (r % nwg) * (64 // cpr) + w16 // cpr, ch


def _thread_offsets(p: W.Sm90Tf32Plan, r: int, nwin: int, nwg: int):
    """Each of a consumer's 128 threads' halo offset for row block ``r``
    (the kernel's ``a_off``): warp v, lane l hold rows 16v + l // 4 (and
    + 8), channels ch and ch + 1 of their window (a window past the last
    reads window 0), and pixel column 2 (l % 4) (and + 1)."""
    tid = np.arange(128)
    row0 = 16 * (tid // 32) + (tid % 32) // 4
    win, ch = _row_channel(row0, r, nwg, p.cpr)
    win = np.where(win >= nwin, 0, win)
    off = ((ch // 32) * p.sub_bytes + np.asarray(p.win_off)[win]
           + (ch % 32) * 4 + (tid % 4) * 256)
    return row0, off


def _fragments(h_w: np.ndarray, off: np.ndarray, row0: np.ndarray, kk: int,
               sbo: int, lo_terms: bool) -> tuple[np.ndarray, np.ndarray]:
    """The m64k8 A tile of output row ``kk`` assembled from each thread's
    two 8-byte loads, at the swizzle of its offset (pixel 2t) and of the
    offset + 128 (pixel 2t + 1), t = lane % 4: a0 (row0, col t) and a1
    (row0 + 8, t) from the first, a2 (row0, t + 4) and a3 (row0 + 8,
    t + 4) from the second; each word split into hi and lo."""
    a = off + kk * sbo
    t = np.arange(128) % 4
    hi = np.full((64, 8), np.nan, np.float32)
    lo = np.full((64, 8), np.nan, np.float32)
    for delta, dc in ((0, 0), (128, 4)):
        word = _swz(a + delta) // 4
        assert (word % 2 == 0).all()             # 8-byte aligned
        for dr in (0, 8):
            h_, l_ = _split(h_w[word + dr // 8], lo_terms)
            hi[row0 + dr, t + dc] = h_
            lo[row0 + dr, t + dc] = l_
    assert not np.isnan(hi).any()
    return hi, lo


def _model_tf32(x: np.ndarray, dy: np.ndarray, p: W.Sm90Tf32Plan, k: int,
                pad, lo_terms: bool = True) -> np.ndarray:
    """The 3xTF32 kernel's dW for every CTA of the plan: per pixel block
    of its range one TMA stage and its rewrite into hi and lo tiles, per
    k8 step and row block the A fragments from the halo and the three
    products lo*hi + hi*lo + hi*hi, the tile stored through the kernel's
    masks into its split's slice, the slices summed in split order."""
    b, h, wd, ci = x.shape
    _, ho, wo, co = dy.shape
    nwin = k * k
    margin = 2 * max(p.hy, p.hx) * max(p.es) + max(pad) + 8
    ncb, nco = -(-ci // p.cib), -(-co // p.bn)
    xp = np.zeros((b, h + 2 * margin, wd + 2 * margin, ncb * p.cib),
                  np.float32)
    xp[:, margin:margin + h, margin:margin + wd, :ci] = x
    dyp = np.zeros((b, ho + 8, wo + 8, nco * p.bn), np.float32)
    dyp[:, :ho, :wo, :co] = dy
    nby, nbx = -(-ho // 8), -(-wo // 8)
    nwg = -(-nwin // (64 // p.cpr))
    nrb = -(-min(p.cib, ci) // p.cpr) * nwg
    ngrp = -(-nrb // (2 * p.nwc))
    assert p.tiles == ncb * ngrp * nco
    ws = np.full((p.splits, nwin, ci, co), np.nan)
    for z in range(p.splits):
        blocks = range(z * p.bps, min(p.nblk, (z + 1) * p.bps))
        for cb, grp, nb in np.ndindex(ncb, ngrp, nco):
            rbs = [(grp * 2 + cw) * p.nwc + j for cw in range(2)
                   for j in range(p.nwc)]
            thr = [_thread_offsets(p, min(r, nrb - 1), nwin, nwg)
                   for r in rbs]
            acc = np.zeros((len(rbs), 64, p.bn))
            for blk in blocks:
                bi, rem = divmod(blk, nby * nbx)
                oy0, ox0 = (rem // nbx) * 8, (rem % nbx) * 8
                dy_w, h_w = _tma_stage(xp, dyp, p, pad, margin, bi, oy0,
                                       ox0, cb * p.cib, nb * p.bn)
                b_w = _transpose(dy_w, p.bn, lo_terms)
                for kk in range(8):
                    start = (kk // 4) * p.bn * 128 + (kk % 4) * 32
                    b_hi = _tc(_read_b(b_w, start, p.bn)).astype(np.float64)
                    b_lo = _tc(_read_b(b_w, p.bn * 256 + start,
                                       p.bn)).astype(np.float64)
                    for i, (row0, off) in enumerate(thr):
                        a_hi, a_lo = (_tc(f).astype(np.float64) for f in
                                      _fragments(h_w, off, row0, kk,
                                                 p.row_step, lo_terms))
                        acc[i] += a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
            for i, r in enumerate(rbs):
                if r >= nrb:
                    continue
                wins, chs = _row_channel(np.arange(64), r, nwg, p.cpr)
                cols = min(p.bn, co - nb * p.bn)
                for row, (win, c) in enumerate(zip(wins, cb * p.cib + chs)):
                    if win < nwin and c < ci:
                        ws[z, win, c, nb * p.bn:nb * p.bn + cols] = \
                            acc[i, row, :cols]
    assert not np.isnan(ws).any()     # every slice fully written
    out = ws[0].copy()
    for z in range(1, p.splits):
        out += ws[z]
    return out.reshape(k, k, ci, co)


def _tf32_plan(b, ho, wo, ci, co, k, d, tile=None, splits=None, s=1):
    p = W.sm90_tf32_wgrad_plan(b, ho, wo, ci, co, k, k, (d, d), only=tile,
                               stride=(s, s))
    if p is not None and splits is not None:
        bps = -(-p.nblk // splits)
        p = dataclasses.replace(p, splits=splits, bps=bps)
        assert (splits - 1) * bps < p.nblk
    return p


# b, h, w, ci, co, k, pad, dilation: Ci 16 (4 windows a row block) on a
# ragged 9 x 11 plane; Ci 8 at dilation 2 with Co 12 (a column block past
# Co); Ci 72 (a Ci block past Ci) with Co 36; Ci 4; the plane's 1x1
TF32_CASES = [
    (2, 9, 11, 16, 16, 3, 1, 1),
    (1, 10, 10, 8, 12, 3, 2, 2),
    (1, 8, 9, 72, 36, 3, 1, 1),
    (1, 9, 9, 4, 8, 3, 1, 1),
    (2, 8, 8, 32, 8, 1, 0, 1),
]


def _fitting(cases):
    """(case, tile) for every tile that fits shared memory at the case's
    window (the only ones the plan may pick)."""
    out = []
    for case in cases:
        b, h, w, ci, co, k, pad, d = case
        for bn, nwc in W.TF32_TILES:
            for cib in W.TF32_CIBS:
                lay = W.sm90_tf32_wgrad_layout(bn, nwc, cib, ci, k, k,
                                               (d, d))
                if W._sm90_fits(lay):
                    out.append((*case, (bn, nwc, cib)))
    return out


def test_tf32_tiles_that_do_not_fit_are_refused():
    """bn 128 with a 64- or 128-channel 3x3 halo leaves room for one TMA
    stage: the plan refuses it; every other tile fits at 3x3."""
    for bn, nwc in W.TF32_TILES:
        for cib in W.TF32_CIBS:
            p = W.sm90_tf32_wgrad_plan(1, 8, 8, 64, 64, 3, 3, (1, 1),
                                       only=(bn, nwc, cib))
            assert (p is None) == (bn == 128 and cib > 32), (bn, nwc, cib)


@pytest.mark.parametrize("b,h,w,ci,co,k,pad,d,tile", _fitting(TF32_CASES))
def test_tf32_model_reproduces_the_plain_wgrad(b, h, w, ci, co, k, pad, d,
                                               tile):
    """Every tile the plan may pick, with the offsets
    :func:`sm90_tf32_wgrad_layout` computes (what the wrapper passes),
    over two split ranges (the second pass in split order)."""
    x, dy, ho, wo = _inputs(b, h, w, ci, co, k, pad, d, seed=ci + h)
    p = _tf32_plan(b, ho, wo, ci, co, k, d, tile=tile, splits=2)
    got = _model_tf32(x, dy, p, k, (pad, pad))
    want = wgrad_ref(torch.from_numpy(x), torch.from_numpy(dy), k, k,
                     padding=pad, dilation=d).numpy()
    _close(got, want)


@pytest.mark.parametrize("b,h,w,ci,co,k,pad,d", TF32_CASES[:3])
def test_tf32_model_without_lo_terms_errs_more(b, h, w, ci, co, k, pad, d):
    """1xTF32 (the lo words zeroed, the card's control) on the same
    inputs errs at least 4x more than 3xTF32."""
    x, dy, ho, wo = _inputs(b, h, w, ci, co, k, pad, d, seed=ci + h)
    p = _tf32_plan(b, ho, wo, ci, co, k, d)
    want = wgrad_ref(torch.from_numpy(x), torch.from_numpy(dy), k, k,
                     padding=pad, dilation=d).numpy()
    err3 = _close(_model_tf32(x, dy, p, k, (pad, pad)), want)
    err1 = np.abs(_model_tf32(x, dy, p, k, (pad, pad), lo_terms=False)
                  - want).max()
    assert err1 >= 4 * err3, (err1, err3)


def test_tf32_model_at_the_plans_own_tile_matches_the_reference():
    """The tile, split and offsets :func:`sm90_tf32_wgrad_plan` picks
    for a small conv, against ``wgrad_ref`` and the reference's Pallas
    ``wgrad_lb_call`` at its interpret target (cropped to the layer's
    channels)."""
    b, h, w, ci, co, k, pad, d = 2, 12, 12, 16, 16, 3, 1, 1
    x, dy, ho, wo = _inputs(b, h, w, ci, co, k, pad, d, seed=7)
    p = W.sm90_tf32_wgrad_plan(b, ho, wo, ci, co, k, k, (d, d))
    got = _model_tf32(x, dy, p, k, (pad, pad))
    rplan = jax_plan_wgrad(jax_plan_conv(h, w, ci, co, k, k, batch=b,
                                         stride=(1, 1), padding=(pad, pad),
                                         dilation=(d, d)))
    # the reference kernel at its default, the interpret target
    ref_kernel = np.asarray(wgrad_lb_call(x, dy, rplan))
    _close(got, ref_kernel[..., :ci, :co])
    _close(got, wgrad_ref(torch.from_numpy(x), torch.from_numpy(dy), k, k,
                          padding=pad).numpy())


# b, h, w, ci, co, k, stride, pad: ResNet-20's four strided wgrads at
# batch 2 (3x3/2 and 1x1/2, 32 -> 16 and 16 -> 8), stride (1, 2) on a
# ragged plane, and a 15 x 13 plane at 3x3/2
STRIDED_CASES = [
    (2, 32, 32, 16, 32, 3, (2, 2), 1),
    (2, 32, 32, 16, 32, 1, (2, 2), 0),
    (2, 16, 16, 32, 64, 3, (2, 2), 1),
    (2, 16, 16, 32, 64, 1, (2, 2), 0),
    (1, 10, 13, 8, 12, 3, (1, 2), 1),
    (2, 15, 13, 4, 8, 3, (2, 2), 1),
]


def _strided(b, h, w, ci, co, k, s, pad, seed):
    sy, sx = s
    ho, wo = (h + 2 * pad - k) // sy + 1, (w + 2 * pad - k) // sx + 1
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    dy = rng.standard_normal((b, ho, wo, co)).astype(np.float32)
    return x, dy, ho, wo


def _reference_wgrad(x, dy, k, s, pad):
    """The reference's dW: the VJP of its ``conv2d_ref`` in w."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.conv_lb.ref import conv2d_ref as jax_conv2d_ref

    def f(w):
        return jax_conv2d_ref(jnp.asarray(x), w, stride=s, padding=pad)

    _, vjp = jax.vjp(f, jnp.zeros((k, k, x.shape[-1], dy.shape[-1]),
                                  jnp.float32))
    return np.asarray(vjp(jnp.asarray(dy))[0])


@pytest.mark.parametrize("b,h,w,ci,co,k,s,pad", STRIDED_CASES)
def test_tf32_strided_model_reproduces_the_reference(b, h, w, ci, co, k, s,
                                                     pad):
    """At a stride the halo of each pixel block is one box per residue at
    the traversal stride, each window reading its box at (ky*dly // sy,
    kx*dlx // sx): the model of the plan the route takes, over two split
    ranges where the reduction has two blocks, against the VJP of the
    reference's ``conv2d_ref`` and the port's ``wgrad_ref`` (max |err| <=
    1e-5 of max |dW|)."""
    x, dy, ho, wo = _strided(b, h, w, ci, co, k, s, pad, seed=h + ci + k)
    p = W.sm90_tf32_wgrad_plan(b, ho, wo, ci, co, k, k, (1, 1),
                               stride=s)
    assert p is not None and p.stride == s and p.es == s
    if p.nblk > 1:
        p = dataclasses.replace(p, splits=2, bps=-(-p.nblk // 2))
    got = _model_tf32(x, dy, p, k, (pad, pad))
    _close(got, _reference_wgrad(x, dy, k, s, pad))
    _close(got, wgrad_ref(torch.from_numpy(x), torch.from_numpy(dy), k, k,
                          stride=s, padding=pad).numpy())


def test_tf32_strided_model_matches_the_reference_kernel():
    """A 3x3/2 wgrad through the plan's parts against the reference's
    Pallas ``wgrad_lb_call`` at its interpret target (cropped to the
    layer's channels)."""
    b, h, w, ci, co, k, s, pad = 2, 12, 12, 8, 16, 3, (2, 2), 1
    x, dy, ho, wo = _strided(b, h, w, ci, co, k, s, pad, seed=4)
    p = W.sm90_tf32_wgrad_plan(b, ho, wo, ci, co, k, k, (1, 1), stride=s)
    got = _model_tf32(x, dy, p, k, (pad, pad))
    rplan = jax_plan_wgrad(jax_plan_conv(h, w, ci, co, k, k, batch=b,
                                         stride=s, padding=(pad, pad),
                                         dilation=(1, 1)))
    ref_kernel = np.asarray(wgrad_lb_call(x, dy, rplan))
    _close(got, ref_kernel[..., :ci, :co])


def test_tf32_strided_halo_read_at_stride_one_fails():
    """A strided launch whose plan reads its halo at stride 1 (each box
    loaded without the traversal stride: the card's control) misses the
    reference by far more than the gate."""
    b, h, w, ci, co, k, s, pad = STRIDED_CASES[0]
    x, dy, ho, wo = _strided(b, h, w, ci, co, k, s, pad, seed=2)
    p = W.sm90_tf32_wgrad_plan(b, ho, wo, ci, co, k, k, (1, 1), stride=s)
    want = _reference_wgrad(x, dy, k, s, pad)
    _close(_model_tf32(x, dy, p, k, (pad, pad)), want)
    bad = K.halo_at_stride_one(p)
    err = np.abs(_model_tf32(x, dy, bad, k, (pad, pad)) - want).max()
    assert err > 100 * TOL * np.abs(want).max()


@pytest.mark.parametrize("k,s", [(3, (2, 2)), (1, (2, 2)), (3, (1, 2))])
def test_tf32_strided_fragment_loads_are_conflict_free(k, s):
    """At a stride the parts keep each half-warp's 8-byte fragment loads
    in 32 distinct banks, as at stride 1."""
    p = W.sm90_tf32_wgrad_plan(1, 8, 8, 32, 64, k, k, (1, 1),
                               only=(64, 2, 32), stride=s)
    nwin = k * k
    nwg = -(-nwin // (64 // p.cpr))
    for r in range(nwg):
        _, off = _thread_offsets(p, r, nwin, nwg)
        for kk in range(8):
            for delta in (0, 128):
                addr = _swz(off + kk * p.row_step + delta)
                for half in range(8):
                    words = addr[16 * half:16 * half + 16] // 4
                    banks = np.concatenate([words, words + 1]) % 32
                    assert len(set(banks.tolist())) == 32


def test_launch_cache_plans_a_geometry_once_and_reroutes_a_misaligned_one(
        monkeypatch):
    """:func:`W.lookup` reads the route and plan once per geometry key,
    and a base 4 bytes off a 16-byte line is another key, planned anew on
    ``fma``; the packed arguments carry the plan's parts."""
    calls = []
    plan_of = W.plan_of

    def counted(*a, **kw):
        calls.append(1)
        return plan_of(*a, **kw)

    monkeypatch.setattr(W, "plan_of", counted)
    W.launch_cache.clear()
    geom = _geom(k=3, s=2, p=1)
    x, dy = torch.zeros((8, 32, 32, 16)), torch.zeros((8, 16, 16, 32))
    _, first, fresh = W.lookup(x, dy, geom)
    _, again, fresh2 = W.lookup(x.clone(), dy.clone(), geom)
    assert fresh and not fresh2 and again is first and len(calls) == 1
    assert first.route == "sm90_tf32"
    a = first.launch.args
    assert (a.g.nparts, a.g.sy, a.es_x, a.box_x) == (4, 2, 2, 18)
    _, off, fresh3 = W.lookup(x, _misaligned(*dy.shape), geom)
    assert fresh3 and off.route == "fma" and len(calls) == 2
    W.launch_cache.clear()


@pytest.mark.parametrize("ci", [64, 32, 16])
def test_tf32_fragment_loads_are_conflict_free(ci):
    """Each half-warp's 8-byte fragment loads, at every window shift of a
    3x3 halo and every output row, fall in 32 distinct banks (the
    header's bank pattern: two wavefronts a load, the least 256 bytes
    take), for each row-block shape (64, 32 and 16 channels a window)."""
    p = W.sm90_tf32_wgrad_plan(1, 8, 8, ci, 64, 3, 3, (1, 1),
                               only=(64, 2, 64 if ci == 64 else 32))
    nwg = -(-9 // (64 // p.cpr))
    for r in range(nwg):
        _, off = _thread_offsets(p, r, 9, nwg)
        for kk in range(8):
            for delta in (0, 128):
                addr = _swz(off + kk * p.hx * 128 + delta)
                for half in range(8):
                    words = addr[16 * half:16 * half + 16] // 4
                    banks = np.concatenate([words, words + 1]) % 32
                    assert len(set(banks.tolist())) == 32


# ------------------------------------------- kernels against the wrapper


def _src(path: Path) -> str:
    return path.read_text()


def test_tf32_kernel_constants_match_the_wrapper():
    src = _src(W.TF32_SOURCE)

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kConsumers") == W.SM90_CONSUMERS
    assert const("kBlock") == W.SM90_BLOCK
    assert const("kMaxWin") == W.SM90_MAX_WIN
    assert const("kMaxStages") == W.SM90_MAX_STAGES
    assert const("kBox") == W.TF32_BOX
    assert const("kTransposers") == W.TF32_TRANSPOSERS
    assert const("kBStages") == W.TF32_BSTAGES
    inst = set(re.findall(r"if \(bn == (\d+) && nwc == (\d+)\)", src))
    assert {(int(a), int(b)) for a, b in inst} == set(W.TF32_TILES)
    for cib in W.TF32_CIBS:
        assert f"cib != {cib}" in src
    for cpr in W.TF32_CPRS:
        assert f"cpr != {cpr}" in src
    assert int(re.search(r"constexpr int kMaxTaps = (\d+);",
                         _src(I.SOURCE))[1]) == I.IM2COL_MAX


@pytest.mark.parametrize("source,name,pointers,ints", [
    (I.SOURCE, "wgrad_im2col_forward", 3, 9),
])
def test_wrapper_binds_the_kernels_c_interface(source, name, pointers,
                                               ints):
    """The number of pointers and ints the wrapper passes is the C
    function's."""
    sig = re.search(rf'extern "C" int {name}\((.*?)\)', _src(source),
                    re.S)[1]
    params = [p.strip() for p in sig.split(",")]
    assert sum(p.startswith("int ") for p in params) == ints
    assert sum("*" in p for p in params) == pointers + 1   # + stream
    assert (f'_entry(SOURCE, "{name}", {pointers}, {ints})'
            in Path(I.__file__).read_text())


def test_wrapper_packs_the_tf32_kernels_c_structs():
    """The 3xTF32 wgrad's lean entry takes one pointer to ``Args``; the
    wrapper's ``Tf32WgradArgs`` / ``Tf32WgradGeom`` lay out the kernel's
    ``Args`` / ``Geom`` field by field, and bind the entry by name."""
    import ctypes

    from test_torch_conv_tc import c_struct_fields, ctypes_fields
    src = _src(W.TF32_SOURCE)
    assert re.search(r'extern "C" int wgrad_lb_sm90_tf32_launch\('
                     r'const void\* args\)', src)
    for c_name, struct in (("Args", W.Tf32WgradArgs),
                           ("Geom", W.Tf32WgradGeom)):
        c = c_struct_fields(src, c_name)
        assert [(n, k) for _, n, k in c] == ctypes_fields(struct), c_name
        for typ, n, _ in c:
            assert typ.endswith("*") == (dict(struct._fields_)[n]
                                         is ctypes.c_void_p)
    assert '"wgrad_lb_sm90_tf32_launch"' in Path(W.__file__).read_text()
    assert "wgrad_lb_sm90_tf32_forward" not in src
