"""The port's lower-bound matmul on the CPU held against the reference:
``repro_torch.kernels.matmul_lb.ops.matmul_lb`` (whose kernel wrapper
runs the plain version on a CPU tensor) against the reference's Pallas
kernel at ``target="interpret"``, its oracle ``matmul_ref`` and its
``target="lax"``, on the same numpy inputs, over every shape and type
of the reference's sweep (``tests/test_kernels.py:27-46``).  Also the
accounting (``lb_block_shape``, ``hbm_traffic_model``,
``arithmetic_intensity``) and the legality pass (``check_matmul_block``)
against the reference's, exactly.

Tolerances are the reference's: f32 ``rtol 2e-5, atol 2e-4``; bf16
``rtol 8e-2, atol 0.8`` (one bf16 rounding of the output apart).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import plan_check as jpc
from repro.core import tpu_adapter as jta
from repro.kernels.matmul_lb.ops import matmul_lb as jax_matmul_lb
from repro.kernels.matmul_lb.ref import matmul_ref as jax_matmul_ref
from repro_torch.analysis import plan_check as pc
from repro_torch.core import hopper_adapter as ha
from repro_torch.kernels.matmul_lb import kernel as K3
from repro_torch.kernels.matmul_lb.ops import accounted_block, matmul_lb
from repro_torch.kernels.matmul_lb.ref import matmul_ref

TOL = {"float32": (2e-5, 2e-4), "bfloat16": (8e-2, 0.8)}
SWEEP = [(64, 64, 64), (128, 256, 128), (300, 200, 150), (1000, 333, 77),
         (8, 8, 8), (257, 129, 511)]
#: the full-width projections of phi3-medium-14b at 4096 tokens
FULL = [(4096, 5120, 5120), (4096, 5120, 1280), (4096, 5120, 17920),
        (4096, 17920, 5120)]


def _inputs(m, k, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    if dtype == "bfloat16":     # round once, the same words on both sides
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        w = np.array(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    return x, w


def _port(x, w, dtype, **kw):
    t = getattr(torch, dtype)
    out = matmul_lb(torch.from_numpy(x).to(t), torch.from_numpy(w).to(t),
                    **kw)
    assert out.dtype == t
    return out.to(torch.float32).numpy()


def _jax(fn, x, w, dtype, **kw):
    t = getattr(jnp, dtype)
    out = fn(jnp.asarray(x, t), jnp.asarray(w, t), **kw)
    assert out.dtype == t
    return np.asarray(out.astype(jnp.float32))


def _close(out, ref, dtype):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SWEEP)
def test_matmul_matches_reference(m, k, n, dtype):
    x, w = _inputs(m, k, n, dtype)
    got = _port(x, w, dtype)
    assert got.shape == (m, n)
    _close(got, _jax(jax_matmul_lb, x, w, dtype, target="interpret"), dtype)
    _close(got, _jax(jax_matmul_ref, x, w, dtype), dtype)
    _close(got, _jax(jax_matmul_lb, x, w, dtype, target="lax"), dtype)


@pytest.mark.parametrize("blk", [(64, 64, 64), (128, 128, 64),
                                 (256, 160, 192), (64, 32, 32)])
def test_block_shape_invariance(blk):
    """The accounted block changes no result, in either package."""
    x, w = _inputs(256, 192, 160, "float32")
    ref = _jax(jax_matmul_ref, x, w, "float32")
    got = _port(x, w, "float32", blk=ha.BlockShape(*blk))
    np.testing.assert_array_equal(got, _port(x, w, "float32"))
    _close(got, ref, "float32")
    _close(_jax(jax_matmul_lb, x, w, "float32", blk=jta.BlockShape(*blk),
                target="interpret"), ref, "float32")


def test_cpu_tensors_launch_nothing():
    before = K3.matmul_lb.launches
    x, w = _inputs(64, 64, 64, "float32")
    _port(x, w, "float32")
    assert K3.matmul_lb.launches == before


def test_account_only_cannot_execute():
    x = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="account-only"):
        matmul_lb(x, x, target="account-only")
    with pytest.raises(ValueError, match="account-only"):
        jax_matmul_lb(jnp.zeros((8, 8)), jnp.zeros((8, 8)),
                      target="account-only")


def test_over_budget_block_raises_in_both_packages():
    with pytest.raises(pc.PlanLegalityError):
        matmul_lb(torch.zeros((4096, 4096)), torch.zeros((4096, 4096)),
                  blk=ha.BlockShape(4096, 4096, 4096))
    with pytest.raises(jpc.PlanLegalityError):
        jax_matmul_lb(jnp.zeros((4096, 4096)), jnp.zeros((4096, 4096)),
                      blk=jta.BlockShape(4096, 4096, 4096))


GRID = sorted(set(itertools.product((8, 77, 300, 1000, 4096),
                                    (8, 150, 511, 1280, 5120),
                                    (8, 129, 333, 5120, 17920),
                                    (2, 4)))
              | {(m, n, k, b) for m, k, n in FULL for b in (2, 4)})


def test_accounting_equals_the_reference():
    for m, n, k, b in GRID:
        want = jta.lb_block_shape(m, n, k, dtype_bytes=b)
        got = ha.lb_block_shape(m, n, k, dtype_bytes=b)
        assert (got.bm, got.bn, got.bk) == (want.bm, want.bn, want.bk)
        assert ha.hbm_traffic_model(m, n, k, got, b) == \
            jta.hbm_traffic_model(m, n, k, want, b)
        assert ha.arithmetic_intensity(m, n, k, got, b) == \
            jta.arithmetic_intensity(m, n, k, want, b)


def test_accounted_block_is_the_references_clamp():
    for m, n, k, b in GRID:
        want = jta.lb_block_shape(m, n, k, dtype_bytes=b)
        got = accounted_block(m, n, k, b)
        assert (got.bm, got.bn, got.bk) == (
            min(want.bm, max(8, m)), min(want.bn, max(8, n)),
            min(want.bk, max(8, k)))


BLOCKS = [(0, 128, 128), (128, 128, 128), (100, 128, 128),
          (128, 100, 128), (128, 128, 100), (64, 64, 64), (8, 8, 8),
          (4096, 4096, 4096), (1024, 1024, 512), (12, 300, 40)]


@pytest.mark.parametrize("target", ["interpret", "mosaic"])
def test_check_matmul_block_equals_the_reference(target):
    for blk, (m, n, k), b in itertools.product(
            BLOCKS, [(128, 128, 128), (1000, 77, 333), (4096, 5120, 17920)],
            (2, 4)):
        want = jpc.check_matmul_block(jta.BlockShape(*blk), m, n, k,
                                      dtype_bytes=b, target=target,
                                      where="w")
        got = pc.check_matmul_block(ha.BlockShape(*blk), m, n, k,
                                    dtype_bytes=b, target=target,
                                    where="w")
        assert [(d.rule, d.severity, d.message, d.hint, d.where)
                for d in got] == [(d.rule, d.severity, d.message, d.hint,
                                   d.where) for d in want], (blk, m, n, k)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _sm90_pitch(k_or_n):
    return (2 * k_or_n) % 16 == 0


@pytest.mark.parametrize("m,k,n", SWEEP + FULL)
def test_route_reads_types_strides_and_pointers(m, k, n):
    """bf16 goes to the sm90 kernel, f32 to the 3xTF32 kernel, iff TMA
    can describe both operands: x row-major, w N-major (rows of N) or
    K-major (rows of K), 16-byte pitches and bases; mixed types and what
    TMA cannot describe go to the FMA kernel."""
    x = _bf16(m, k)
    w_n = _bf16(k, n)                # N-major
    w_k = _bf16(n, k).t()            # K-major: w.t() of a contiguous (N, K)
    assert K3.w_layout(w_n) == ("n-major" if _sm90_pitch(n) else None)
    assert K3.w_layout(w_k) == ("k-major" if _sm90_pitch(k) else None)
    want_n = "sm90" if _sm90_pitch(k) and _sm90_pitch(n) else "fma"
    want_k = "sm90" if _sm90_pitch(k) else "fma"
    assert K3.route(x, w_n) == want_n
    assert K3.route(x, w_k) == want_k
    f32_pitch = (4 * k) % 16 == 0
    assert K3.route(x.float(), w_n.float()) == (
        "sm90_tf32" if f32_pitch and (4 * n) % 16 == 0 else "fma")
    assert K3.route(x.float(), w_k.float().t().contiguous().t()) == (
        "sm90_tf32" if f32_pitch else "fma")
    assert K3.route(x, w_n.float()) == "fma"
    assert K3.route(x.float(), w_n) == "fma"


def test_route_of_the_projections_and_off_by_two_bytes():
    for m, k, n in FULL:
        x, w = _bf16(m, k), _bf16(k, n)
        assert K3.route(x, w) == "sm90"
        assert K3.route(x, _bf16(n, k).t()) == "sm90"
    buf = _bf16(1 + 64 * 64)
    off = buf[1:].view(64, 64)       # 2 bytes past an aligned base
    assert off.data_ptr() % 16 == 2
    assert K3.route(off, _bf16(64, 64)) == "fma"
    assert K3.route(_bf16(64, 64), off) == "fma"
    wide = _bf16(64, 65)[:, :64]     # rows 130 bytes apart
    assert K3.route(wide, _bf16(64, 64)) == "fma"
    assert K3.route(_bf16(64, 64), wide) == "fma"
    pitched = _bf16(64, 72)[:, :64]  # rows 144 bytes apart: TMA takes it
    assert K3.route(pitched, _bf16(64, 64)) == "sm90"
    assert K3.route(_bf16(64, 64), _bf16(64, 64).expand(64, 64)) == "sm90"
    assert K3.route(_bf16(64, 64), _bf16(1, 64).expand(64, 64)) == "fma"


@pytest.mark.parametrize("m,k,n", SWEEP + FULL)
def test_sm90_tile_takes_fewest_waves_then_fewest_ctas(m, k, n):
    cost = {}
    for bn in K3.SM90_TILES:
        ctas = -(-m // K3.TILE_M) * -(-n // bn)
        cost[bn] = (-(-ctas // ha.SM_COUNT) * bn, ctas * bn, -bn)
    assert K3.sm90_tile(m, n) == min(cost, key=cost.get)
    assert K3.sm90_tile(m, n) in K3.SM90_TILES


def test_sm90_tile_of_the_projections():
    # wk (N 1280): 3 waves of 320 CTAs at 128, 2 of 160 at 256
    assert [K3.sm90_tile(m, n) for m, _, n in FULL] == [256, 128, 256,
                                                        256]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (300, 200, 150),
                                   (1000, 333, 77), (8, 8, 8)])
def test_transposed_w_matches_reference(m, k, n, dtype):
    """``matmul_lb(x, w.t())`` with ``w`` a contiguous ``(N, K)``: the
    port on the CPU against the reference's kernel at ``interpret``,
    its oracle and ``lax``; no copy is counted on the CPU."""
    x, w = _inputs(m, k, n, dtype, seed=3)
    w_nk = np.ascontiguousarray(w.T)
    t = getattr(torch, dtype)
    copies = K3.matmul_lb.copies
    got = matmul_lb(torch.from_numpy(x).to(t),
                    torch.from_numpy(w_nk).to(t).t())
    assert K3.matmul_lb.copies == copies
    got = got.to(torch.float32).numpy()
    assert got.shape == (m, n)
    _close(got, _jax(jax_matmul_lb, x, w_nk.T, dtype, target="interpret"),
           dtype)
    _close(got, _jax(jax_matmul_ref, x, w_nk.T, dtype), dtype)
    _close(got, _jax(jax_matmul_lb, x, w_nk.T, dtype, target="lax"), dtype)
