"""The port's wgrad op on the CPU (its plain PyTorch version) held
against the reference: its dW-stationary Pallas kernel
``wgrad_lb_call`` at its default, the interpret target (cropped to the
layer's channels), and the ``jax.vjp`` of its lax conv path
(``conv2d_lb(..., fallback=True)``), on the same numpy inputs.
Tolerance: max |port - ref| <= 1e-5 * max |ref| (f32 sums in another
order)."""

import jax
import numpy as np
import pytest
import torch

from repro.kernels.conv_lb.ops import conv2d_lb as jax_conv2d_lb
from repro.kernels.conv_lb.ops import plan_conv as jax_plan_conv
from repro.kernels.conv_lb.ops import plan_conv_wgrad as jax_plan_wgrad
from repro.kernels.conv_lb.wgrad import wgrad_lb_call
from repro_torch.kernels.conv_lb.ops import plan_conv, plan_conv_wgrad
from repro_torch.kernels.conv_lb.ref import wgrad_ref
from repro_torch.kernels.conv_lb.wgrad import (WgradGeometry, wgrad_lb,
                                               wgrad_split)

TOL = 1e-5

# b, h, w, ci, co, k, stride, pad, dilation
GEOMETRIES = {
    "3x3_s1_p1": (2, 12, 12, 8, 16, 3, 1, 1, 1),
    "3x3_s2_p1": (2, 13, 13, 8, 16, 3, 2, 1, 1),
    "1x1_s2_p0": (2, 12, 12, 8, 16, 1, 2, 0, 1),
    "rhs_dilation2": (1, 14, 14, 6, 8, 3, 1, 2, 2),
    "odd_plane_odd_channels": (3, 15, 13, 7, 9, 3, 1, 1, 1),
}


def _lax_wgrad(x, dy, w_shape, s, p, d):
    """The weight VJP of the reference's lax conv path."""
    def conv(w):
        return jax_conv2d_lb(x, w, stride=s, padding=p, dilation=d,
                             fallback=True)
    _, vjp = jax.vjp(conv, np.zeros(w_shape, np.float32))
    return np.asarray(vjp(dy)[0])


def _close(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert err <= TOL * np.abs(ref).max(), err


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_wgrad_matches_reference_kernel_and_lax_vjp(name):
    b, h, w, ci, co, k, s, p, d = GEOMETRIES[name]
    ekh = (k - 1) * d + 1
    ho = (h + 2 * p - ekh) // s + 1
    wo = (w + 2 * p - ekh) // s + 1
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    dy = rng.standard_normal((b, ho, wo, co)).astype(np.float32)
    rplan = jax_plan_wgrad(jax_plan_conv(
        h, w, ci, co, k, k, batch=b, stride=(s, s), padding=(p, p),
        dilation=(d, d)))
    # the reference kernel at its default, the interpret target
    ref_kernel = np.asarray(wgrad_lb_call(x, dy, rplan))[..., :ci, :co]
    ref_lax = _lax_wgrad(x, dy, (k, k, ci, co), s, p, d)
    geom = WgradGeometry(hk=k, wk=k, stride=(s, s), padding=(p, p),
                         dilation=(d, d))
    got = wgrad_lb(torch.from_numpy(x), torch.from_numpy(dy), geom)
    _close(got, ref_kernel)
    _close(got, ref_lax)
    # the port's own wgrad plan carries the same executing geometry
    wplan = plan_conv_wgrad(plan_conv(h, w, ci, co, k, k, batch=b,
                                      stride=(s, s), padding=(p, p),
                                      dilation=(d, d)))
    assert WgradGeometry.of(wplan) == geom
    assert torch.equal(wgrad_lb(torch.from_numpy(x), torch.from_numpy(dy),
                                wplan), got)
    assert torch.equal(wgrad_ref(torch.from_numpy(x), torch.from_numpy(dy),
                                 k, k, stride=s, padding=p, dilation=d),
                       got)


def test_wgrad_split_fills_the_card_and_covers_the_reduction():
    """The kernel's split of the reduction: no empty range, every pixel
    covered, and enough CTAs where the dW tile alone is one or two."""
    for m, co, k in [(27, 64, 8 * 224 * 224), (576, 64, 8 * 224 * 224),
                     (4608, 512, 8 * 14 * 14), (144, 16, 8 * 32 * 32),
                     (63, 9, 3 * 15 * 13), (9, 1, 1)]:
        tn, splits, cps = wgrad_split(m, co, k)
        chunks = -(-k // 16)
        assert tn in (64, 128) and (tn == 128) == (co > 64)
        assert (splits - 1) * cps < chunks <= splits * cps
    # conv1_2 of VGG16/224 at batch 8: one 128 x 64 tile row of dW per
    # 128 rows, so the split alone fills the 132 SMs
    tn, splits, _ = wgrad_split(576, 64, 8 * 224 * 224)
    assert 5 * splits >= 132


def test_wgrad_rejects_other_devices():
    x = torch.zeros((1, 4, 4, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        wgrad_lb(x, torch.zeros((1, 4, 4, 2), device="meta"),
                 WgradGeometry(hk=3, wk=3, padding=(1, 1)))
