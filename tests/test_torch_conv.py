"""The port's conv op on the CPU (its plain PyTorch version) held
against the reference's lax conv on the same numpy inputs.

Geometries: those of ``tests/test_kernels.py`` (stride, padding, rhs
dilation, groups, asymmetric pairs, the fused bias/relu/pool
epilogue), plus ``lhs_dilation`` (the dgrad geometry) and the fused
residual join, which the reference runs through
``conv2d_lb(..., fallback=True)``.  Tolerance: max |port - ref| <=
1e-5 * max |ref| in f32 (the sums run in another order).
"""

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
