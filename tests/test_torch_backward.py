"""The port's conv backward on the CPU held against the reference:
``torch.autograd.grad`` through the port's ``conv2d_lb`` (its
``ConvLb`` Function, whose backward runs the kernels' plain versions
on a CPU tensor) against the ``jax.vjp`` of the reference's
``conv2d_lb(..., fallback=True)``, for x, w, bias and residual, on the
same numpy inputs and cotangent.  Tolerance: max |port - ref| <=
1e-5 * max |ref| per tensor (f32 sums in another order)."""

import jax
import numpy as np
import pytest
import torch

from repro.kernels.conv_lb.ops import _lax_epilogue
from repro.kernels.conv_lb.ops import conv2d_lb as jax_conv2d_lb
from repro_torch.kernels.conv_lb import ops
from repro_torch.kernels.conv_lb.ops import conv2d_lb

TOL = 1e-5

# b, h, ci, co, k, stride, pad, groups, relu, pool, residual
CASES = {
    "relu": (2, 12, 6, 8, 3, 1, 1, 1, True, 1, False),
    "pool2": (2, 12, 6, 8, 3, 1, 1, 1, True, 2, False),
    "residual": (2, 10, 8, 8, 3, 1, 1, 1, True, 1, True),
    "residual_pool2": (1, 12, 5, 7, 3, 1, 1, 1, True, 2, True),
    "stride2": (2, 13, 6, 8, 3, 2, 1, 1, True, 1, False),
    "proj_1x1_s2": (2, 12, 6, 8, 1, 2, 0, 1, False, 1, False),
    "groups2": (2, 10, 6, 8, 3, 1, 1, 2, True, 1, False),
    "padding_past_full": (1, 9, 3, 5, 3, 1, 3, 1, True, 1, False),
}


def _inputs(case, seed=0):
    b, h, ci, co, k, s, p, g, relu, pool, res = case
    ho = (h + 2 * p - k) // s + 1
    rng = np.random.default_rng(seed)
    arrs = {
        "x": rng.standard_normal((b, h, h, ci)),
        "w": rng.standard_normal((k, k, ci // g, co)) * (k * k * ci) ** -.5,
        "bias": rng.standard_normal((co,)) * 0.1,
        "residual": rng.standard_normal((b, ho, ho, co)) if res else None,
        "g": rng.standard_normal((b, ho // pool, ho // pool, co)),
    }
    kw = dict(stride=s, padding=p, groups=g, relu=relu, pool=pool)
    return ({k_: None if a is None else a.astype(np.float32)
             for k_, a in arrs.items()}, kw)


def _torch_grads(a, kw):
    leaves = [None if a[n] is None else
              torch.from_numpy(a[n]).requires_grad_(True)
              for n in ("x", "w", "bias", "residual")]
    out = conv2d_lb(*leaves, **kw)
    live = [t for t in leaves if t is not None]
    return torch.autograd.grad(out, live, torch.from_numpy(a["g"]))


def _jax_grads(a, kw):
    args = [a[n] for n in ("x", "w", "bias", "residual")
            if a[n] is not None]
    has_res = a["residual"] is not None

    def f(x, w, bias, *res):
        return jax_conv2d_lb(x, w, bias, res[0] if has_res else None,
                             fallback=True, **kw)

    _, vjp = jax.vjp(f, *args)
    return [np.asarray(t) for t in vjp(a["g"])]


@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_reference_vjp(name):
    a, kw = _inputs(CASES[name])
    got = _torch_grads(a, kw)
    ref = _jax_grads(a, kw)
    assert len(got) == len(ref)
    for n, g, r in zip(("x", "w", "bias", "residual"), got, ref):
        assert tuple(g.shape) == r.shape, n
        err = np.abs(g.numpy() - r).max()
        assert err <= TOL * np.abs(r).max(), (n, err)


@pytest.mark.parametrize("name,x_grad,kernel_calls", [
    ("pool2", True, (3, 1)),        # fwd, recompute, dgrad; wgrad
    ("pool2", False, (2, 1)),       # no dgrad when x needs no gradient
    ("groups2", True, (6, 2)),      # every call once per group
])
def test_backward_runs_through_the_kernel_wrappers(monkeypatch, name,
                                                   x_grad, kernel_calls):
    """The backward calls the conv kernel's wrappers for the recompute
    (``conv_lb``) and the dgrad (``conv_lb_dgrad``) and the wgrad
    kernel's wrapper for dW — on the CPU their plain versions, on the
    card the kernels."""
    calls = {"conv": 0, "wgrad": 0}
    conv_lb, wgrad_lb = ops.conv_lb, ops.wgrad_lb

    def count(key, fn):
        def wrapped(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(ops, "conv_lb", count("conv", conv_lb))
    monkeypatch.setattr(ops, "conv_lb_dgrad",
                        count("conv", ops.conv_lb_dgrad))
    monkeypatch.setattr(ops, "wgrad_lb", count("wgrad", wgrad_lb))
    a, kw = _inputs(CASES[name])
    x = torch.from_numpy(a["x"]).requires_grad_(x_grad)
    w = torch.from_numpy(a["w"]).requires_grad_(True)
    out = conv2d_lb(x, w, torch.from_numpy(a["bias"]), **kw)
    out.backward(torch.from_numpy(a["g"]))
    assert (calls["conv"], calls["wgrad"]) == kernel_calls
    assert (x.grad is not None) == x_grad and w.grad is not None


def test_serving_records_no_backward():
    a, kw = _inputs(CASES["pool2"])
    out = conv2d_lb(torch.from_numpy(a["x"]), torch.from_numpy(a["w"]),
                    torch.from_numpy(a["bias"]), **kw)
    assert out.grad_fn is None and not out.requires_grad


def test_lhs_dilated_forward_backward_on_cpu_is_the_plain_autograd():
    """No kernel backward for an lhs-dilated forward: on a CPU tensor
    it is the plain version's autograd (on the card, cuDNN's)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 7, 4)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 4, 6)) * 0.2).astype(np.float32)
    kw = dict(stride=1, padding=2, lhs_dilation=2, relu=True)
    out_shape = jax_conv2d_lb(x, w, fallback=True, **kw).shape
    g = rng.standard_normal(out_shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = torch.autograd.grad(conv2d_lb(xt, wt, **kw), [xt, wt],
                              torch.from_numpy(g))
    _, vjp = jax.vjp(lambda xx, ww: jax_conv2d_lb(xx, ww, fallback=True,
                                                  **kw), x, w)
    for t, r in zip(got, vjp(g)):
        r = np.asarray(r)
        assert np.abs(t.numpy() - r).max() <= TOL * np.abs(r).max()


@pytest.mark.parametrize("relu,pool", [(True, 1), (False, 2), (True, 2)])
def test_epilogue_pullback_splits_ties_like_the_reference(relu, pool):
    """Exact zeros before a ReLU take half the gradient, and a pool
    window with tied maxima routes its gradient to the first of them,
    as the reference's ``jnp.maximum`` and ``reduce_window`` VJPs do."""
    y = np.array([[1.0, 1.0, 0.0, -1.0], [1.0, 0.5, 0.0, 0.0],
                  [0.0, -2.0, 3.0, 3.0], [-1.0, 0.0, 3.0, 0.25]],
                 np.float32).reshape(1, 4, 4, 1)
    g = np.arange(1, 1 + 16 // pool ** 2, dtype=np.float32).reshape(
        1, 4 // pool, 4 // pool, 1)
    _, vjp = jax.vjp(lambda yy: _lax_epilogue(yy, None, relu, pool), y)
    want = np.asarray(vjp(g)[0])
    got, db, dres = ops.epilogue_vjp(torch.from_numpy(y), None, None, relu,
                                     pool, torch.from_numpy(g))
    assert db is None and dres is None
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,kw,tally,kernel_calls", [
    ("lhs_dilated", dict(padding=2, lhs_dilation=2), {"bwd": 1}, (1, 0)),
    ("padding_past_full", dict(padding=3), {"dgrad": 1}, (2, 1)),
])
def test_backward_the_kernels_do_not_take_is_loud(monkeypatch, name, kw,
                                                  tally, kernel_calls):
    """Where the reference routes to lax, the backward routes to the
    library rung, and each route adds to the tally and traces an
    ``exec.fallback`` event; the padding past full keeps the recompute
    and wgrad on the kernels' wrappers (the forward is the first conv
    call)."""
    from repro_torch.obs.tracer import Tracer
    calls = {"conv": 0, "wgrad": 0}
    conv_lb, wgrad_lb = ops.conv_lb, ops.wgrad_lb

    def count(key, fn):
        def wrapped(*args, **kw_):
            calls[key] += 1
            return fn(*args, **kw_)
        return wrapped

    monkeypatch.setattr(ops, "conv_lb", count("conv", conv_lb))
    monkeypatch.setattr(ops, "wgrad_lb", count("wgrad", wgrad_lb))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 7, 7, 3))
                         .astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy((rng.standard_normal((3, 3, 3, 5)) * 0.2)
                         .astype(np.float32)).requires_grad_(True)
    ops.reset_fallback_counts()
    tracer = Tracer()
    with tracer.activate():
        conv2d_lb(x, w, relu=True, **kw).sum().backward()
    assert ops.exec_fallback_counts() == tally
    (pass_,) = tally
    (ev,) = tracer.find("exec.fallback")
    assert ev.attrs["pass"] == pass_ and ev.attrs["layer"] == "3->5k3x3"
    assert (calls["conv"], calls["wgrad"]) == kernel_calls
    assert x.grad is not None and w.grad is not None
