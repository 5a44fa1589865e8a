"""The port's Mamba2 block (``repro_torch.models.ssm``) on the CPU against
the reference's ``repro.models.ssm`` on the same numpy inputs, f32.

``ssd_chunked``: at several lengths and chunks (a ragged L padded to a
multiple of the chunk), with and without ``init_state``, and on a chunk
whose masked panel overflows (``A_log`` 0, large ``dt``: ``exp(seg)``
is ``inf`` above the diagonal) with no NaN, and its gradients over two
such chunks and a ragged tail finite and equal to those of the
reference's recurrence (its chunked scan's are NaN there); the reference's
chunk-invariance test mirrored.  ``ssd_decode_step``; ``mamba_forward``
with and without ``conv_state`` and at L = 1 and 2 (the conv tail with
zeros first: k - 1 rows, where at L = 1 the reference's holds k - 2,
its zeros sliced from an L-row tensor); ``mamba_decode``; the decode
chain against the forward, from a 1-token prefill too.
Tolerances: 1e-5 of max |ref| (the two sum in other orders), the
reference's own 1e-4 for chunk invariance; the conv tail (rows of
the input projection) within 1e-6, its zeros and shifted rows exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_config, reduced
from repro_torch.models import ssm as S

KEY = jax.random.PRNGKey(0)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(out, ref, rel):
    out = np.asarray(out.float() if isinstance(out, torch.Tensor) else out,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _softplus(a):
    return np.logaddexp(a, 0).astype(np.float32)


def _ssd_inputs(b, length, h, p, n, seed=0, dt_scale=1.0):
    return (_rand(b, length, h, p, seed=seed),
            _softplus(_rand(b, length, h, seed=seed + 1)) * dt_scale,
            _rand(h, seed=seed + 2, scale=0.5),
            _rand(b, length, 1, n, seed=seed + 3, scale=0.3),
            _rand(b, length, 1, n, seed=seed + 4, scale=0.3),
            _rand(h, seed=seed + 5))


@pytest.mark.parametrize("length,chunk", [(32, 8), (30, 8), (17, 32),
                                          (1, 256), (600, 256)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(length, chunk, with_state):
    b, h, p, n = 2, 4, 8, 16
    ins = _ssd_inputs(b, length, h, p, n)
    st = _rand(b, h, p, n, seed=9, scale=0.5) if with_state else None
    ry, rs = jax_ssm.ssd_chunked(*(jnp.asarray(a) for a in ins), chunk=chunk,
                                 init_state=None if st is None
                                 else jnp.asarray(st))
    y, s = S.ssd_chunked(*(_t(a) for a in ins), chunk=chunk,
                         init_state=None if st is None else _t(st))
    assert y.shape == (b, length, h, p) and s.shape == (b, h, p, n)
    _close(y, np.asarray(ry), 1e-5)
    _close(s, np.asarray(rs), 1e-5)


def test_ssd_overflowing_masked_panel_gives_no_nan():
    """``A_log`` 0 and ``dt`` near 1: over a 256-row chunk the segment
    sums above the diagonal reach ~exp(180), ``inf`` in f32; both drop
    them with ``where``."""
    b, length, h, p, n = 1, 256, 2, 4, 8
    x, dt, _a, bm, cm, d = _ssd_inputs(b, length, h, p, n, seed=3)
    dt = np.full_like(dt, 0.7)
    a_log = np.zeros((h,), np.float32)
    cs = np.cumsum(dt[0, :, 0] * -1.0)
    with np.errstate(over="ignore"):
        assert not np.isfinite(np.exp(np.float32(cs[0] - cs[-1])))
    ry, rs = jax_ssm.ssd_chunked(*(jnp.asarray(a) for a in
                                   (x, dt, a_log, bm, cm, d)), chunk=256)
    y, s = S.ssd_chunked(*(_t(a) for a in (x, dt, a_log, bm, cm, d)),
                         chunk=256)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    _close(y, np.asarray(ry), 1e-5)
    _close(s, np.asarray(rs), 1e-5)


def test_ssd_overflowing_masked_panel_gradient_is_finite():
    """The same overflowing chunk under autograd, over two 256-row
    chunks and a ragged tail: the port's gradients in every input are
    finite and within 1e-4 of max |ref| of ``jax.grad`` through the
    reference's own recurrence (``ssd_decode_step`` scanned token by
    token, whose decay factors are at most 1).  The reference's chunked
    scan gives NaN in dt there: the gradient of ``where(tri, exp(seg),
    0)`` is ``exp(seg) * 0 = inf * 0``."""
    b, length, h, p, n = 1, 600, 2, 4, 8
    x, _dt, _a, bm, cm, d = _ssd_inputs(b, length, h, p, n, seed=3)
    dt = np.full((b, length, h), 0.7, np.float32)
    a_log = np.zeros((h,), np.float32)
    w = _rand(b, length, h, p, seed=11)
    ins = (x, dt, a_log, bm, cm, d)

    def recurrence(x, dt, a_log, bm, cm, d):
        def step(state, t):
            y, state = jax_ssm.ssd_decode_step(
                x[:, t], dt[:, t], a_log, bm[:, t], cm[:, t], d, state)
            return state, y
        _, ys = jax.lax.scan(step, jnp.zeros((b, h, p, n), jnp.float32),
                             jnp.arange(length))
        return jnp.sum(jnp.moveaxis(ys, 0, 1) * w)

    ref = jax.grad(recurrence, argnums=range(6))(*map(jnp.asarray, ins))
    chunked = jax.grad(
        lambda *a: jnp.sum(jax_ssm.ssd_chunked(*a, chunk=256)[0] * w),
        argnums=range(6))(*map(jnp.asarray, ins))
    assert np.isnan(np.asarray(chunked[1])).any()     # in dt
    args = [_t(a).requires_grad_() for a in ins]
    y, _ = S.ssd_chunked(*args, chunk=256)
    grads = torch.autograd.grad((y * _t(w)).sum(), args)
    for g, r in zip(grads, ref):
        _close(g, np.asarray(r), 1e-4)


def test_ssd_chunk_invariance():
    """SSD result must not depend on the chunk size (state handoff)."""
    b, length, h, p, n = 2, 32, 4, 8, 16
    x = _rand(b, length, h, p)
    dt = _softplus(_rand(b, length, h, seed=1))
    a_log = np.zeros((h,), np.float32)
    bm = _rand(b, length, 1, n, seed=2, scale=0.3)
    cm = _rand(b, length, 1, n, seed=3, scale=0.3)
    d = np.ones((h,), np.float32)
    args = [_t(a) for a in (x, dt, a_log, bm, cm, d)]
    y8, s8 = S.ssd_chunked(*args, chunk=8)
    y32, s32 = S.ssd_chunked(*args, chunk=32)
    np.testing.assert_allclose(y8.numpy(), y32.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(s8.numpy(), s32.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_ssd_decode_step_matches_reference():
    b, h, p, n = 3, 4, 8, 16
    x, dt, a_log = (_rand(b, h, p), _softplus(_rand(b, h, seed=1)),
                    _rand(h, seed=2, scale=0.5))
    bt, ct = _rand(b, 1, n, seed=3), _rand(b, 1, n, seed=4)
    d, st = _rand(h, seed=5), _rand(b, h, p, n, seed=6)
    ry, rs = jax_ssm.ssd_decode_step(*(jnp.asarray(a) for a in
                                       (x, dt, a_log, bt, ct, d, st)))
    y, s = S.ssd_decode_step(*(_t(a) for a in (x, dt, a_log, bt, ct, d, st)))
    _close(y, np.asarray(ry), 1e-5)
    _close(s, np.asarray(rs), 1e-5)


def _mamba_pair(seed=0):
    """The reference's mamba params at the reduced mamba2 config (and
    random SSM scalars, so A_log, D and dt_bias matter) as numpy."""
    jcfg = jax_reduced(jax_get_config("mamba2-1.3b"))
    cfg = reduced(get_config("mamba2-1.3b"))
    jp = jax_ssm.init_mamba(jax.random.PRNGKey(seed), jcfg.d_model,
                            jcfg.ssm_state, jcfg.ssm_head_dim,
                            jcfg.ssm_expand, jcfg.ssm_conv, jnp.float32)
    p = {k: np.array(v) for k, v in jp.items()}
    h = p["A_log"].shape[0]
    p["A_log"] = _rand(h, seed=seed + 11, scale=0.5)
    p["D"] = _rand(h, seed=seed + 12)
    p["dt_bias"] = _rand(h, seed=seed + 13, scale=0.5)
    p["norm_w"] = 1 + _rand(p["norm_w"].shape[0], seed=seed + 14,
                            scale=0.1)
    return jcfg, cfg, {k: jnp.asarray(v) for k, v in p.items()}, \
        {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("length", [1, 2, 3, 16, 40])
@pytest.mark.parametrize("with_conv_state", [False, True])
def test_mamba_forward_matches_reference(length, with_conv_state):
    jcfg, cfg, jp, p = _mamba_pair()
    b = 2
    x = _rand(b, length, cfg.d_model, seed=20)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    cs = _rand(b, cfg.ssm_conv - 1, conv_dim, seed=21) \
        if with_conv_state else None
    st = _rand(b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, seed=22,
               scale=0.3) if with_conv_state else None
    ry, (rst, rtail) = jax_ssm.mamba_forward(
        jp, jnp.asarray(x), jcfg,
        init_state=None if st is None else jnp.asarray(st),
        conv_state=None if cs is None else jnp.asarray(cs))
    y, (s, tail) = S.mamba_forward(
        p, _t(x), cfg, init_state=None if st is None else _t(st),
        conv_state=None if cs is None else _t(cs))
    _close(y, np.asarray(ry), 1e-5)
    _close(s, np.asarray(rst), 1e-5)
    k1 = cfg.ssm_conv - 1
    assert tail.shape == (b, k1, conv_dim)
    rtail = np.asarray(rtail)
    if length < k1:     # zeros first, then the L rows
        assert not tail[:, :k1 - length].any()
    if 2 * length < k1:
        # the reference slices its zeros from xbc's L rows, so at L = 1
        # its tail is one row short (k - 2 rows, which its own decode
        # cannot take); the port's holds the k - 1 the cache holds
        assert rtail.shape[1] == 2 * length
        rtail = np.concatenate([np.zeros((b, k1 - rtail.shape[1], conv_dim),
                                         np.float32), rtail], axis=1)
    _close(tail, rtail, 1e-6)


def test_mamba_decode_matches_reference():
    jcfg, cfg, jp, p = _mamba_pair(seed=1)
    b = 3
    x = _rand(b, 1, cfg.d_model, seed=30)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    cs = _rand(b, cfg.ssm_conv - 1, conv_dim, seed=31)
    st = _rand(b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, seed=32,
               scale=0.3)
    ry, (rst, rconv) = jax_ssm.mamba_decode(jp, jnp.asarray(x), jcfg,
                                            jnp.asarray(st), jnp.asarray(cs))
    y, (s, conv) = S.mamba_decode(p, _t(x), cfg, _t(st), _t(cs))
    _close(y, np.asarray(ry), 1e-5)
    _close(s, np.asarray(rst), 1e-5)
    _close(conv, np.asarray(rconv), 1e-6)
    np.testing.assert_array_equal(conv[:, :-1].numpy(), cs[:, 1:])


@pytest.mark.parametrize("prefix", [1, 2, 9])
def test_mamba_decode_chain_equals_forward(prefix):
    """A prefill of ``prefix`` tokens, then decode steps from its state
    and conv tail: each step's output equals the full forward's row."""
    _, cfg, _, p = _mamba_pair(seed=2)
    b, length = 2, 12
    x = _t(_rand(b, length, cfg.d_model, seed=40))
    full, _ = S.mamba_forward(p, x, cfg)
    _, (st, tail) = S.mamba_forward(p, x[:, :prefix], cfg)
    for i in range(prefix, length):
        y, (st, tail) = S.mamba_decode(p, x[:, i:i + 1], cfg, st, tail)
        _close(y[:, 0], full[:, i].numpy(), 1e-5)


def test_init_mamba_shapes_match_reference():
    jcfg = jax_get_config("mamba2-1.3b")
    ref = jax.eval_shape(lambda: jax_ssm.init_mamba(
        KEY, jcfg.d_model, jcfg.ssm_state, jcfg.ssm_head_dim,
        jcfg.ssm_expand, jcfg.ssm_conv, jnp.bfloat16))
    out = S.init_mamba(None, jcfg.d_model, jcfg.ssm_state,
                       jcfg.ssm_head_dim, jcfg.ssm_expand, jcfg.ssm_conv,
                       torch.bfloat16)
    assert set(out) == set(ref)
    for k, v in ref.items():
        assert tuple(out[k].shape) == tuple(v.shape), k
        assert str(out[k].dtype).removeprefix("torch.") == v.dtype.name, k
        assert out[k].device.type == "meta"
    small = S.init_mamba(torch.Generator().manual_seed(0), 32, 8, 16, 2, 4,
                         torch.float32)
    assert (small["A_log"] == 0).all() and (small["D"] == 1).all()
    assert abs(float(small["conv_w"].std()) - 1 / math.sqrt(4)) < 0.05
