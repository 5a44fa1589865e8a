"""The port's conv op on the CPU (its plain PyTorch version) held
against the reference's lax conv on the same numpy inputs.

Geometries: those of ``tests/test_kernels.py`` (stride, padding, rhs
dilation, groups, asymmetric pairs, the fused bias/relu/pool
epilogue), plus ``lhs_dilation`` (the dgrad geometry) and the fused
residual join, which the reference runs through
``conv2d_lb(..., fallback=True)``.  Tolerance: max |port - ref| <=
1e-5 * max |ref| in f32 (the sums run in another order).
"""

import itertools

import numpy as np
import pytest
import torch

from repro.kernels.conv_lb.ops import conv2d_lb as jax_conv2d_lb
from repro.kernels.conv_lb.ref import conv2d_ref as jax_conv2d_ref
from repro_torch.kernels.conv_lb import kernel as torch_kernel
from repro_torch.kernels.conv_lb.ops import conv2d_lb
from repro_torch.kernels.conv_lb.ref import conv2d_ref

TOL = 1e-5


def _arrays(seed, *shapes, scale=(1.0, 0.2, 0.1, 1.0)):
    rng = np.random.default_rng(seed)
    return [None if s is None else
            (rng.standard_normal(s) * sc).astype(np.float32)
            for s, sc in zip(shapes, scale)]


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _assert_close(out: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert tuple(out.shape) == ref.shape
    err = np.abs(out.numpy() - ref).max()
    assert err <= TOL * np.abs(ref).max(), err


@pytest.mark.parametrize("b,h,w,ci,co,k,s,p", [
    (2, 16, 16, 8, 16, 3, 1, 1),
    (1, 14, 14, 24, 40, 3, 1, 1),
    (2, 12, 12, 6, 10, 3, 2, 1),
    (1, 9, 9, 5, 7, 1, 1, 0),
    (1, 20, 20, 16, 32, 5, 1, 2),
    (1, 8, 8, 3, 4, 3, 2, 0),
])
def test_conv_sweep_matches_reference(b, h, w, ci, co, k, s, p):
    x, wt = _arrays(0, (b, h, w, ci), (k, k, ci, co))
    out = conv2d_lb(_t(x), _t(wt), stride=s, padding=p)
    _assert_close(out, jax_conv2d_ref(x, wt, stride=s, padding=p))


@pytest.mark.parametrize("b,h,w,ci,co,k,s,p,d,g", [
    (1, 17, 13, 5, 6, 3, 1, 1, 2, 1),      # dilated, odd plane
    (1, 16, 16, 8, 8, 3, 1, 1, 3, 1),      # heavy dilation
    (2, 16, 16, 8, 12, 3, 1, 1, 1, 4),     # grouped
    (1, 12, 12, 6, 6, 3, 2, 1, 1, 3),      # grouped + strided
    (2, 15, 11, 7, 9, 3, 2, 1, 1, 1),      # odd strided
    (1, 21, 21, 6, 8, 5, 2, 2, 1, 1),      # 5x5 strided
    (1, 14, 10, 4, 6, 3, (2, 1), (1, 0), (1, 2), 1),  # asymmetric
])
def test_conv_general_sweep_matches_reference(b, h, w, ci, co, k, s, p,
                                              d, g):
    x, wt = _arrays(1, (b, h, w, ci), (k, k, ci // g, co))
    kw = dict(stride=s, padding=p, dilation=d, groups=g)
    _assert_close(conv2d_lb(_t(x), _t(wt), **kw),
                  jax_conv2d_ref(x, wt, **kw))


@pytest.mark.parametrize("relu,pool,use_bias,groups", [
    (False, 1, True, 1),
    (True, 1, True, 1),
    (True, 2, True, 1),
    (True, 2, False, 1),
    (False, 2, False, 1),
    (True, 2, True, 2),
])
def test_fused_epilogue_matches_reference(relu, pool, use_bias, groups):
    x, wt, b = _arrays(2, (2, 12, 12, 8), (3, 3, 8 // groups, 12),
                       (12,) if use_bias else None)
    kw = dict(padding=1, relu=relu, pool=pool, groups=groups)
    _assert_close(conv2d_lb(_t(x), _t(wt), _t(b), **kw),
                  jax_conv2d_ref(x, wt, b, **kw))


@pytest.mark.parametrize("b,h,w,ci,co,k,s,p,d,ld", [
    (2, 9, 9, 8, 8, 3, 1, 2, 1, 2),        # dgrad of a stride-2 3x3
    (1, 8, 7, 4, 6, 3, 1, 1, 1, 2),        # odd compact plane
    (1, 6, 6, 5, 3, 3, 1, 2, 1, 3),        # lhs dilation 3
    (2, 7, 7, 4, 4, 3, 2, 1, 2, 2),        # with stride and rhs dilation
    (1, 10, 10, 6, 6, 1, 1, 0, 1, 2),      # 1x1 projection's dgrad
])
def test_lhs_dilation_matches_reference(b, h, w, ci, co, k, s, p, d, ld):
    x, wt = _arrays(3, (b, h, w, ci), (k, k, ci, co))
    kw = dict(stride=s, padding=p, dilation=d, lhs_dilation=ld)
    _assert_close(conv2d_lb(_t(x), _t(wt), **kw),
                  jax_conv2d_lb(x, wt, fallback=True, **kw))


@pytest.mark.parametrize("b,h,ci,co,s,relu,pool", [
    (2, 12, 8, 8, 1, True, 1),             # BasicBlock join
    (2, 12, 8, 16, 2, True, 1),            # strided block's join
    (1, 16, 6, 10, 1, True, 2),            # join before a fused pool
    (3, 9, 5, 7, 1, False, 1),             # odd plane, no ReLU
])
def test_residual_join_matches_reference(b, h, ci, co, s, relu, pool):
    ho = (h + 2 - 3) // s + 1
    x, wt, bias, res = _arrays(4, (b, h, h, ci), (3, 3, ci, co), (co,),
                               (b, ho, ho, co))
    kw = dict(stride=s, padding=1, relu=relu, pool=pool)
    _assert_close(conv2d_lb(_t(x), _t(wt), _t(bias), _t(res), **kw),
                  jax_conv2d_lb(x, wt, bias, res, fallback=True, **kw))


def test_plain_version_is_the_cpu_path_and_counts_no_launch():
    x, wt, b = _arrays(5, (1, 10, 10, 4), (3, 3, 4, 6), (6,))
    before = torch_kernel.conv_lb.launches
    out = conv2d_lb(_t(x), _t(wt), _t(b), padding=1, relu=True)
    ref = conv2d_ref(_t(x), _t(wt), _t(b), padding=1, relu=True)
    assert torch.equal(out, ref)
    assert torch_kernel.conv_lb.launches == before


def test_other_devices_raise():
    x = torch.zeros((1, 6, 6, 2), device="meta")
    w = torch.zeros((3, 3, 2, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv2d_lb(x, w, padding=1)


@pytest.mark.parametrize("h,w,k,s,p,d,pool", [
    (7, 7, 3, 1, 0, 1, 2),                 # Ho = Wo = 5
    (8, 7, 3, 1, 1, 1, 2),                 # 8 x 7: only Wo is odd
    (12, 12, 3, 1, 1, 1, 3),               # 12 x 12 divides 3 ...
    (11, 11, 3, 1, 1, 1, 3),               # ... 11 x 11 does not
    (9, 9, 3, 2, 1, 1, 2),                 # strided: 5 x 5
    (10, 10, 3, 1, 1, 2, 2),               # rhs dilation 2: 8 x 8 ...
    (10, 9, 3, 1, 1, 2, 2),                # ... 8 x 7
])
def test_fused_pool_that_does_not_divide_the_plane_is_refused(h, w, k, s,
                                                               p, d, pool):
    """``conv2d_lb`` refuses a fused pool that does not divide the conv
    output plane before anything runs, with the reference's kernel
    target's message (its ``plan_conv``), as the card's kernel does; a
    pool that divides computes as the reference's."""
    from repro.kernels.conv_lb.ops import plan_conv as jax_plan_conv

    ci, co = 4, 8
    ho = (h + 2 * p - (k - 1) * d - 1) // s + 1
    wo = (w + 2 * p - (k - 1) * d - 1) // s + 1
    x, wt, b = _arrays(7, (1, h, w, ci), (k, k, ci, co), (co,))
    kw = dict(stride=s, padding=p, dilation=d, relu=True, pool=pool)
    if ho % pool == 0 and wo % pool == 0:
        _assert_close(conv2d_lb(_t(x), _t(wt), _t(b), **kw),
                      jax_conv2d_lb(x, wt, b, fallback=True, **kw))
        return
    want = (f"fused pool={pool} needs pool-divisible output plane, got "
            f"{ho}x{wo}")
    xt = _t(x).requires_grad_(True)
    before = torch_kernel.conv_lb.launches
    with pytest.raises(ValueError) as got:
        conv2d_lb(xt, _t(wt), _t(b), **kw)
    assert str(got.value) == want
    assert xt.grad is None and torch_kernel.conv_lb.launches == before
    with pytest.raises(ValueError) as ref:
        jax_plan_conv(h, w, ci, co, k, k, batch=1, stride=(s, s),
                      padding=(p, p), dilation=(d, d), pool=pool)
    assert str(ref.value) == want


def test_op_rejects_bad_geometry():
    x = torch.zeros((1, 6, 6, 4))
    with pytest.raises(ValueError, match="groups"):
        conv2d_lb(x, torch.zeros((3, 3, 3, 4)), groups=2)
    with pytest.raises(ValueError, match="lhs-dilated"):
        conv2d_lb(x, torch.zeros((3, 3, 4, 4)), lhs_dilation=2, pool=2)


@pytest.mark.parametrize("batch,ho,wo,co,pool", [
    (8, 224, 224, 64, 2), (8, 14, 14, 512, 2), (1, 14, 14, 512, 1),
    (8, 8, 8, 64, 1), (3, 15, 13, 9, 1), (8, 16, 16, 32, 1),
])
def test_cta_tile_is_pool_aligned_and_fits(batch, ho, wo, co, pool):
    bb, ty, tx, tn = torch_kernel.cta_tile(batch, ho, wo, co, pool)
    assert bb * ty * tx <= torch_kernel.TILE_M
    assert ty % pool == 0 and tx % pool == 0 and tn in (64, 128)
    assert 1 <= bb <= batch
    smem = torch_kernel.cta_smem_bytes(bb, ty, tx, tn, 3, 3, (1, 1),
                                       (1, 1), pool)
    assert smem <= torch_kernel.SMEM_PER_BLOCK


def _tile_before(batch, ho, wo, co, pool):
    """The tile ranking the kernel used before tiles were held to the
    shared-memory budget (no geometry, every tile a candidate)."""
    ceil_div = torch_kernel.ceil_div
    best = None
    for tn in (64, 128):
        if tn == 128 and co <= 64:
            continue
        nco = ceil_div(co, tn)
        for tx in range(pool, min(16, -(-wo // pool) * pool) + 1, pool):
            for ty in range(pool, min(torch_kernel.TILE_M // tx,
                                      -(-ho // pool) * pool) + 1, pool):
                bb = max(1, min(batch, torch_kernel.TILE_M // (ty * tx)))
                ctas = (ceil_div(batch, bb) * ceil_div(ho, ty)
                        * ceil_div(wo, tx) * nco)
                waves = ceil_div(ctas, torch_kernel.SM_COUNT
                                 * torch_kernel.CTAS_PER_SM)
                halo = (ty + 2) * (tx + 2) / (ty * tx)
                key = (waves * tn, ctas * tn, halo, -tn)
                if best is None or key < best[0]:
                    best = (key, (bb, ty, tx, tn))
    return best[1]


@pytest.mark.parametrize("hk", range(1, 12))
def test_cta_plan_fits_every_window_stride_and_dilation(hk):
    """Over wk 1..11 and stride, dilation 1..4, every tile the kernel
    would launch fits the card's shared memory, or the conv has no
    output; the whole window is staged wherever a tile fits so."""
    for (b, h, co), wk, s, d in itertools.product(
            [(8, 224, 64), (1, 32, 128)], range(1, 12), range(1, 5),
            range(1, 5)):
        ho = (h + 2 * (hk // 2) - ((hk - 1) * d + 1)) // s + 1
        wo = (h + 2 * (wk // 2) - ((wk - 1) * d + 1)) // s + 1
        if ho < 1 or wo < 1:
            continue
        geom = (hk, wk, (s, s), (d, d))
        bb, ty, tx, tn, krows = torch_kernel.cta_plan(b, ho, wo, co, 1,
                                                      *geom)
        assert krows in (hk, 1)
        assert bb * ty * tx <= torch_kernel.TILE_M and tn in (64, 128)
        assert torch_kernel.cta_smem_bytes(bb, ty, tx, tn, *geom, 1,
                                           krows) <= \
            torch_kernel.SMEM_PER_BLOCK, (b, h, co, geom)
        assert (bb, ty, tx, tn) == torch_kernel.cta_tile(b, ho, wo, co, 1,
                                                         *geom)


def test_7x7_stride2_gets_a_tile_that_fits():
    """The conv that raised on the card: the ranking's first choice,
    (1, 16, 8, 64), needs 250,432 B; the chosen tile fits with the
    whole window staged and at least one CTA per SM."""
    geom = (7, 7, (2, 2), (1, 1))
    assert _tile_before(8, 112, 112, 64, 1) == (1, 16, 8, 64)
    assert torch_kernel.cta_smem_bytes(1, 16, 8, 64, *geom, 1) == 250432
    for batch in (1, 8):
        bb, ty, tx, tn, krows = torch_kernel.cta_plan(batch, 112, 112, 64,
                                                      1, *geom)
        assert krows == 7
        assert torch_kernel.cta_smem_bytes(bb, ty, tx, tn, *geom, 1) <= \
            torch_kernel.SMEM_PER_BLOCK
        assert (-(-batch // bb) * -(-112 // ty) * -(-112 // tx)
                >= torch_kernel.SM_COUNT)
    # 11x11: the whole window's weights alone exceed the budget
    assert torch_kernel.cta_plan(2, 55, 55, 64, 1, 11, 11, (4, 4),
                                 (1, 1))[4] == 1


def _model_stages():
    from repro_torch.models.cnn import init_vgg, resnet_graph, vgg_graph
    from repro_torch.models.graph import graph_stages
    vgg = vgg_graph(init_vgg(torch.Generator().manual_seed(0),
                             device="cpu"))
    return {"vgg16_224": graph_stages(vgg, 224, 224),
            "resnet20_32": graph_stages(resnet_graph(), 32, 32)}


@pytest.mark.parametrize("model", ["vgg16_224", "resnet20_32"])
@pytest.mark.parametrize("batch", [1, 2, 4, 8])
def test_model_layers_keep_their_tiles(model, batch):
    """VGG16/224's 13 and ResNet-20/32's 21 convs, forward and dgrad,
    keep the tile they had before the budget, with the whole window
    staged."""
    stages = _model_stages()[model]
    assert len(stages) == {"vgg16_224": 13, "resnet20_32": 21}[model]
    for st in stages:
        n = st.node
        pool = st.pool if st.fused_pool else 1
        geom = (n.hk, n.wk, (n.stride, n.stride), (1, 1))
        fwd = torch_kernel.cta_plan(batch, st.ho, st.wo, n.co, pool,
                                    *geom)
        assert fwd == _tile_before(batch, st.ho, st.wo, n.co, pool) + (
            n.hk,), n.name
        # dgrad: a stride-1 conv onto the input plane, Ci out
        dgrad = torch_kernel.cta_plan(batch, st.h, st.w, n.ci, 1, n.hk,
                                      n.wk)
        assert dgrad == _tile_before(batch, st.h, st.w, n.ci, 1) + (
            n.hk,), n.name


@pytest.mark.parametrize("b,h,ci,co,k,s,p,d", [
    (2, 23, 3, 8, 7, 2, 3, 1),      # a stem: 7x7 stride 2
    (1, 20, 4, 6, 7, 1, 2, 2),      # 7x7 at dilation 2
    (1, 27, 3, 5, 11, 4, 2, 1),     # 11x11 stride 4
])
def test_large_windows_match_reference(b, h, ci, co, k, s, p, d):
    x, wt = _arrays(3, (b, h, h, ci), (k, k, ci, co))
    out = conv2d_lb(_t(x), _t(wt), stride=s, padding=p, dilation=d)
    _assert_close(out, jax_conv2d_ref(x, wt, stride=s, padding=p,
                                      dilation=d))
