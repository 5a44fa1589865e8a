"""The port's bf16 paths on the CPU (the kernels' plain versions) held
against the reference on the same numpy inputs.

  * K1's plain version in bf16 against the reference's
    ``conv2d_lb(..., fallback=True)`` per layer.  The port sums in f32
    and rounds once, as K1 and the reference's Pallas kernel do; the
    reference's lax path rounds after the conv, after the bias and
    after the residual.  Each rounding moves a value by at most 2^-8 of
    itself, and the chain's values lie within the output's range, so
    the two differ by at most 4 x 2^-8 = 2^-6 of max |ref|.
  * K2's plain version takes bf16 x and dy and returns f32 dW, as the
    reference's ``wgrad_lb_call`` does: the same widened words, summed
    in f32 (1e-5 of max |ref|, the f32 tolerance).
  * A computing bf16 ``ImageServer`` against the reference's bf16
    server at ``target="lax"`` on converted bf16 params (random biases,
    so the roundings differ): the reference rounds each of VGG's 13
    layers once more than the port (after the conv, before the bias),
    each at most 2^-9 of a value, and each layer passes an error on
    with a gain near 1 (He init); with the bf16 mean pool and head on
    both sides the logits differ by at most 14 x 2^-9 < 2^-5 of
    max |ref|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_lb.ops import conv2d_lb as jax_conv2d_lb
from repro.kernels.conv_lb.ops import plan_conv as jax_plan_conv
from repro.kernels.conv_lb.ops import plan_conv_wgrad as jax_plan_wgrad
from repro.kernels.conv_lb.wgrad import wgrad_lb_call
from repro.models.cnn import init_vgg as jax_init_vgg
from repro.serve import ImageServer as JaxImageServer
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels.conv_lb import kernel as K
from repro_torch.kernels.conv_lb.ops import conv2d_lb
from repro_torch.kernels.conv_lb.wgrad import WgradGeometry, wgrad_lb
from repro_torch.serve import ImageServer

CONV_TOL = 2 ** -6
SERVE_TOL = 2 ** -5


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded once to bf16, as f32 numpy (the same words on both
    sides)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _port(a):
    return None if a is None else torch.from_numpy(a).to(torch.bfloat16)


def _ref(a):
    return None if a is None else jnp.asarray(a, jnp.bfloat16)


# b, h, ci, co, k, stride, pad, bias, residual, relu, pool: conv1_1
# (Ci = 3), a pooled layer, a residual join, a strided and a 1x1
# projection, a 64-channel layer
LAYERS = [
    (2, 16, 3, 16, 3, 1, 1, True, False, True, 1),
    (2, 16, 16, 32, 3, 1, 1, True, False, True, 2),
    (2, 12, 16, 16, 3, 1, 1, True, True, True, 1),
    (2, 16, 16, 32, 3, 2, 1, True, False, False, 1),
    (2, 16, 16, 32, 1, 2, 0, False, False, False, 1),
    (1, 14, 64, 64, 3, 1, 1, True, True, True, 2),
]


@pytest.mark.parametrize("b,h,ci,co,k,s,p,has_b,has_r,relu,pool", LAYERS)
def test_bf16_plain_conv_matches_reference_fallback(b, h, ci, co, k, s, p,
                                                    has_b, has_r, relu,
                                                    pool):
    rng = np.random.default_rng(ci * co + k)
    ho = (h + 2 * p - k) // s + 1
    x = _bf16(rng.standard_normal((b, h, h, ci)))
    w = _bf16(rng.standard_normal((k, k, ci, co)) / np.sqrt(k * k * ci))
    bias = _bf16(rng.standard_normal(co)) if has_b else None
    res = _bf16(rng.standard_normal((b, ho, ho, co))) if has_r else None
    kw = dict(stride=s, padding=p, relu=relu, pool=pool)
    got = conv2d_lb(_port(x), _port(w), _port(bias), _port(res), **kw)
    assert got.dtype == torch.bfloat16
    ref = jax_conv2d_lb(_ref(x), _ref(w), _ref(bias), _ref(res),
                        fallback=True, **kw)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= CONV_TOL * np.abs(ref).max()


@pytest.mark.parametrize("b,h,ci,co,k,s,p", [
    (2, 12, 8, 16, 3, 1, 1),
    (2, 13, 3, 16, 3, 2, 1),
    (3, 15, 7, 9, 3, 1, 1),
])
def test_bf16_wgrad_plain_matches_reference_kernel(b, h, ci, co, k, s, p):
    """bf16 x and dy in, f32 dW out, in both packages."""
    rng = np.random.default_rng(5)
    ho = (h + 2 * p - k) // s + 1
    x = _bf16(rng.standard_normal((b, h, h, ci)))
    dy = _bf16(rng.standard_normal((b, ho, ho, co)))
    plan = jax_plan_wgrad(jax_plan_conv(
        h, h, ci, co, k, k, batch=b, stride=(s, s), padding=(p, p)))
    ref = wgrad_lb_call(_ref(x), _ref(dy), plan)
    assert ref.dtype == jnp.float32
    ref = np.asarray(ref)[..., :ci, :co]
    got = wgrad_lb(_port(x), _port(dy),
                   WgradGeometry(hk=k, wk=k, stride=(s, s), padding=(p, p)))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_bf16_backward_gives_bf16_gradients():
    """The conv's backward in bf16 on the plain versions: dx, dW and db
    come back in bf16 (dW from K2's f32, cast to w's type where the
    reference casts it) and agree with the f32 autograd of the same
    words at bf16 precision (2^-6 of max |f32|)."""
    rng = np.random.default_rng(7)
    arrs = [_bf16(rng.standard_normal(s) * sc) for s, sc in (
        ((2, 10, 10, 8), 1.0), ((3, 3, 8, 16), 0.2), ((16,), 0.1))]
    gy = _bf16(rng.standard_normal((2, 10, 10, 16)))
    grads = {}
    for dtype in (torch.bfloat16, torch.float32):
        leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True)
                  for a in arrs]
        out = conv2d_lb(*leaves, padding=1)
        grads[dtype] = torch.autograd.grad(
            out, leaves, torch.from_numpy(gy).to(dtype))
    for g16, g32 in zip(grads[torch.bfloat16], grads[torch.float32]):
        assert g16.dtype == torch.bfloat16
        err = (g16.float() - g32).abs().max().item()
        assert err <= 2 ** -6 * g32.abs().max().item()


def test_cta_plan_sizes_shared_memory_by_element_size():
    """bf16 stages half the bytes of f32 (the pooled tile stays f32),
    and every VGG16/224 layer's bf16 plan fits; a 7x7/2 stem at 64
    channels, whose whole window crowds f32's tile to 9 x 8 pixels,
    keeps the 16 x 8 tile in bf16."""
    from repro_torch.core.hopper_adapter import SMEM_PER_BLOCK
    geom = (11, 11, (4, 4), (1, 1))
    f32 = K.cta_smem_bytes(1, 8, 8, 64, *geom, 1)
    assert K.cta_smem_bytes(1, 8, 8, 64, *geom, 1, elt=2) * 2 == f32
    assert K.cta_smem_bytes(1, 8, 8, 64, 3, 3, (1, 1), (1, 1), 2, 3,
                            elt=2) == 128 * 64 * 4
    stem = (8, 112, 112, 64, 1, 7, 7, (2, 2), (1, 1))
    assert K.cta_plan(*stem) == (1, 9, 8, 64, 7)
    assert K.cta_plan(*stem, 2) == (1, 16, 8, 64, 7)
    for h, co, pool in ((224, 64, 1), (224, 64, 2), (112, 128, 2),
                        (56, 256, 2), (28, 512, 2), (14, 512, 2)):
        bb, ty, tx, tn, krows = K.cta_plan(8, h, h, co, pool, 3, 3,
                                           (1, 1), (1, 1), 2)
        assert K.cta_smem_bytes(bb, ty, tx, tn, 3, 3, (1, 1), (1, 1),
                                pool, krows, elt=2) <= SMEM_PER_BLOCK


def test_convert_carries_bf16_params():
    """bf16 leaves stay bf16, bit for bit; back to numpy they widen to
    f32 exactly."""
    ref = jax_init_vgg(jax.random.PRNGKey(0), n_classes=4,
                       width_mult=0.05, dtype=jnp.bfloat16)
    tree = {"convs": [{k: np.asarray(v) for k, v in p.items()}
                      for p in ref["convs"]],
            "head": np.asarray(ref["head"])}
    params = params_from_numpy(tree, device="cpu")
    assert params["head"].dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for p in params["convs"]
               for t in p.values())
    back = params_to_numpy(params)
    np.testing.assert_array_equal(
        back["head"], np.asarray(ref["head"].astype(jnp.float32)))
    np.testing.assert_array_equal(
        back["convs"][3]["w"],
        np.asarray(ref["convs"][3]["w"].astype(jnp.float32)))


def test_bf16_server_matches_reference_bf16_lax_server():
    ref_params = jax_init_vgg(jax.random.PRNGKey(3), width_mult=0.125,
                              dtype=jnp.bfloat16)
    rng = np.random.default_rng(3)
    ref_params = {"convs": [
        {"w": p["w"], "b": jnp.asarray(0.1 * rng.standard_normal(
            p["b"].shape), jnp.bfloat16)} for p in ref_params["convs"]],
        "head": ref_params["head"]}
    params = params_from_numpy(
        {"convs": [{k: np.asarray(v) for k, v in p.items()}
                   for p in ref_params["convs"]],
         "head": np.asarray(ref_params["head"])}, device="cpu")
    sizes = (1, 3, 2)
    payloads = [rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
                for n in sizes]
    t = [0.0]
    ref_srv = JaxImageServer(ref_params, 32, 32, buckets=(1, 2, 4),
                             target="lax", dtype=jnp.bfloat16,
                             clock=lambda: t[0])
    srv = ImageServer(params, 32, 32, buckets=(1, 2, 4), device="cpu",
                      dtype=torch.bfloat16, clock=lambda: t[0])
    got, ref = [], []
    for s, out in ((ref_srv, ref), (srv, got)):
        for p in payloads:
            s.submit(p, now=0.0)
            out += s.poll(now=0.0)
        out += s.drain(now=0.0)
    got = sorted(got, key=lambda r: r.rid)
    ref = sorted(ref, key=lambda r: r.rid)
    assert [r.rid for r in got] == [r.rid for r in ref] == [0, 1, 2]
    for g, r in zip(got, ref):
        assert g.logits.dtype == torch.bfloat16
        rl = np.asarray(r.logits.astype(jnp.float32))
        gl = g.logits.float().numpy()
        assert gl.shape == rl.shape
        assert np.abs(gl - rl).max() <= SERVE_TOL * np.abs(rl).max()
        assert dataclasses.asdict(g.charge) == dataclasses.asdict(r.charge)
