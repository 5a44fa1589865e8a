"""K4's route ``sm90_tf32`` on the CPU: what the wrapper decides and
computes before it launches ``csrc/attention_block_sm90_tf32.cu`` (f32
attention in 3xTF32 on ``wgmma``).

  * :func:`route`: ``sm90_tf32`` for f32 at a head dim that is a
    multiple of 4 up to 128 (the widths 64, 96, 128 whose plan fits),
    ``sm90`` for bf16 as before, ``fma`` for everything else;
  * :func:`sm90_tf32_plan`: every region inside the card's 232,448
    bytes, on the swizzle's 1024-byte period, none overlapping; 256 and
    the widths the kernel is not instantiated at refused;
  * the phi3-medium-14b + mixtral-8x7b bounds: 3.541 ms in 3xTF32
    against the FMA rate's 8.719;
  * a numpy model of the kernel's addressing and arithmetic, sub-tile
    by sub-tile: Q, K and V tiles as TMA lays them out (128-byte
    swizzle, zeros past the tensors), each thread's Q fragment loads
    and split, K's hi written over it in place and its lo beside it,
    the transposers' V^T hi and lo tiles in the permuted key order of
    the P fragments, the B operands read as ``wgmma`` reads a K-major
    swizzled tile, the three products with every operand read as the
    tensor cores read TF32 (its top 19 bits), every k8 product added
    to the tensor cores' f32 sums rounding toward zero, the online
    softmax in the exp2 domain with the masks (-1e30 masked, -inf past
    Skv), P split into hi and lo from the score registers.  Against the
    reference's ``flash_attention`` at its default interpret target and
    ``attention_plain`` on the same numpy inputs (the reference's f32
    tolerance, ``rtol 2e-5, atol 2e-4``), and against float64; the
    model without its lo terms (1xTF32) errs at least 4x more; at 4096
    keys each sub-tile's P V summed afresh and added to O on the CUDA
    cores (the kernel's promotion) stays within the f32 card gate, and
    errs over 4x less against float64 than O summed on the tensor cores
    throughout;
  * the Q fragment loads, the V loads and the transposers' stores are
    conflict-free;
  * the kernel's constants and C interface against the wrapper's.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention_block.ops import flash_attention as jax_flash
from repro_torch.core.hopper_adapter import (HBM_BYTES_PER_S,
                                             PEAK_F32_FLOPS,
                                             PEAK_TF32_FLOPS,
                                             SMEM_PER_BLOCK)
from repro_torch.kernels.attention_block import kernel as K4
from repro_torch.kernels.attention_block.ref import attention_plain
from test_torch_matmul_tc import _rtz, _split, _swz, _tc

F32 = torch.float32
BK = K4.TF32_BK


# ---------------------------------------------------------------- route


@pytest.mark.parametrize("hd", [1, 4, 8, 12, 16, 20, 32, 60, 64, 68, 80,
                                96, 100, 124, 128, 130, 132, 256, 320])
def test_route_of_f32_by_head_dim(hd):
    """f32 whose rows TMA describes (hd a multiple of 4) up to 128 takes
    sm90_tf32 at the next of 64, 96, 128; every other f32 head dim
    takes fma; bf16 keeps its routes."""
    q = torch.zeros((2, 4, hd), dtype=F32)
    kv = torch.zeros((1, 4, hd), dtype=F32)
    tf32 = hd % 4 == 0 and hd <= 128
    assert K4.route(q, kv, kv) == ("sm90_tf32" if tf32 else "fma")
    width = K4.sm90_tf32_head_dim(hd)
    assert width == (min(w for w in K4.TF32_HEAD_DIMS if w >= hd)
                     if tf32 else None)
    bq, bkv = q.bfloat16(), kv.bfloat16()
    assert K4.route(bq, bkv, bkv) == (
        "sm90" if hd % 8 == 0 and hd <= 256 else "fma")
    # mixed types are never a tensor-core route
    assert K4.route(q, bkv, bkv) == "fma"
    assert K4.route(bq, kv, kv) == "fma"
    assert K4.cta_rows("sm90_tf32", hd) == 128


def test_route_of_the_configs():
    """phi3-medium-14b's and mixtral-8x7b's f32 attention (hd 128) take
    sm90_tf32; in bf16 sm90."""
    for h, kv, s in ((40, 10, 4096), (32, 8, 8192)):
        q = torch.zeros((h, s, 128), dtype=F32)
        k = torch.zeros((kv, s, 128), dtype=F32)
        assert K4.route(q, k, k) == "sm90_tf32"
        assert K4.route(q.bfloat16(), k.bfloat16(), k.bfloat16()) == "sm90"


def test_launch_counters_by_route():
    assert set(K4.attention.launches_by_route) == set(K4.ROUTES) == {
        "sm90", "sm90_tf32", "fma"}


def test_cpu_tensors_count_no_launch_via_sm90_tf32():
    q = torch.randn((2, 16, 64))
    kv = torch.randn((1, 16, 64))
    before = (K4.attention.launches, dict(K4.attention.launches_by_route))
    out = K4.attention(q, kv, kv, groups=2, via="sm90_tf32")
    assert torch.equal(out, attention_plain(q, kv, kv, groups=2))
    assert (K4.attention.launches, K4.attention.launches_by_route) == before


# ----------------------------------------------------- plan and bounds


@pytest.mark.parametrize("width", K4.TF32_HEAD_DIMS)
def test_plan_fits_and_aligns(width):
    """Q, two raw stages (K, V) and two split stages (K lo, V^T hi,
    V^T lo) on 1024-byte lines, then the mbarriers, inside 232,448
    bytes with the 1024 bytes of alignment slack."""
    p = K4.sm90_tf32_plan(width)
    assert p.width == width and p.v_key_off == 0
    assert p.q_bytes == 128 * width * 4
    assert p.tile_bytes == BK * width * 4
    regions = [(0, p.q_bytes), (p.raw, p.raw + 2 * 2 * p.tile_bytes),
               (p.split, p.split + 2 * 3 * p.tile_bytes),
               (p.bars, p.bars + 8 * 9)]
    for (a0, a1), (b0, _) in zip(regions, regions[1:]):
        assert a1 <= b0
    for off in (p.raw, p.split, p.q_bytes, p.tile_bytes):
        assert off % 1024 == 0
    assert p.bars % 8 == 0
    assert p.smem_bytes == 1024 + p.bars + 72 <= SMEM_PER_BLOCK


def test_plan_at_128_is_the_card_nearly_full():
    p = K4.sm90_tf32_plan(128)
    assert (p.raw, p.split, p.bars, p.smem_bytes) == (
        65536, 131072, 229376, 230472)
    assert SMEM_PER_BLOCK - p.smem_bytes == 1976


@pytest.mark.parametrize("width", [32, 80, 160, 256, 512])
def test_plan_refuses_what_is_not_instantiated_or_does_not_fit(width):
    assert K4.sm90_tf32_plan(width) is None


def test_plan_at_256_would_not_fit():
    """Q alone at 128 rows x 256 f32 is 128 KB: with the two rings the
    kernel's layout needs 459,848 bytes, so hd 256 stays on fma."""
    q, tile = 128 * 256 * 4, BK * 256 * 4
    assert 1024 + q + 2 * 5 * tile + 72 > SMEM_PER_BLOCK
    assert K4.sm90_tf32_head_dim(256) is None


# source config, b, s, h, kv, hd, window, causal
CONFIGS = [(1, 4096, 40, 10, 128, 0, True), (1, 8192, 32, 8, 128, 4096, True)]


def _unmasked(sq, window, causal):
    q = np.arange(sq)
    hi = q if causal else np.full(sq, sq - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, int)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def test_config_bounds():
    """4 hd operations an unmasked pair: 584.2 GFLOP over the two f32
    calls, bound at 3.541 ms in 3xTF32 (three products at 495 TFLOP/s)
    and 8.719 at the FMA rate; both operations-bound."""
    flops = sum(4.0 * hd * b * h * _unmasked(s, win, causal)
                for b, s, h, kv, hd, win, causal in CONFIGS)
    n_bytes = sum(4.0 * 2 * b * s * (h + kv) * hd
                  for b, s, h, kv, hd, win, causal in CONFIGS)
    assert 584.1e9 < flops < 584.3e9
    assert n_bytes / HBM_BYTES_PER_S < 0.2e-3
    assert 3.540e-3 < K4.TF32_PRODUCTS * flops / PEAK_TF32_FLOPS < 3.542e-3
    assert 8.718e-3 < flops / PEAK_F32_FLOPS < 8.720e-3


# ------------------------------------ numpy model of the 3xTF32 kernel

LOG2E = 1.4426950408889634


def _tile_words(rows: np.ndarray, width: int) -> np.ndarray:
    """A tile of ``len(rows)`` rows x ``width`` f32 as TMA writes it:
    boxes of 32 columns, ``len(rows)`` 128-byte swizzled rows each, one
    after another."""
    n = rows.shape[0]
    words = np.zeros(n * width, np.float32)
    r, c = np.meshgrid(np.arange(n), np.arange(width), indexing="ij")
    words[(c // 32 * n * 128 + _swz(r * 128 + (c % 32) * 4)) // 4] = rows
    return words


def _threads():
    """Each consumer thread's local row r0 (and r0 + 8) and c = lane % 4,
    over one warpgroup's 128 threads."""
    t = np.arange(128)
    lane = t % 32
    return 16 * (t // 32) + lane // 4, lane % 4


def _q_fragment(qwords, cw, kk, r0, c):
    """The 64 x 8 A operand of k8 step kk of consumer ``cw``, as each
    thread loads it from the Q tile (boxes of 128 rows): a0 (r0, c), a1
    (r0 + 8, c), a2 (r0, c + 4), a3 (r0 + 8, c + 4) at hd 8kk + c,
    8kk + c + 4."""
    a = np.zeros((64, 8), np.float32)
    base = (kk // 4) * 128 * 128 + (cw * 64 + r0) * 128 + (8 * (kk % 4) + c) * 4
    a[r0, c] = qwords[_swz(base) // 4]
    a[r0 + 8, c] = qwords[_swz(base + 8 * 128) // 4]
    a[r0, c + 4] = qwords[_swz(base + 16) // 4]
    a[r0 + 8, c + 4] = qwords[_swz(base + 8 * 128 + 16) // 4]
    return a


def _k_operand(kwords, kk):
    """The 8 x 32 B operand wgmma reads at k8 step kk from a K-major
    swizzled K tile (box kk / 4, start 32 (kk % 4) bytes on): slot s of
    key n at swz(box + n*128 + 32 (kk % 4) + 4s)."""
    s, n = np.meshgrid(np.arange(8), np.arange(BK), indexing="ij")
    return kwords[((kk // 4) * BK * 128
                   + _swz(n * 128 + 32 * (kk % 4) + 4 * s)) // 4]


def _transpose_v(vwords, width, lo_terms, v_key_off=0):
    """The transposers' V^T hi and lo tiles, by the kernel's index math:
    unit (box b, chunk r), lane a column n = 32b + lane, words q = 0..3
    read from keys 8 (r / 2) + r % 2 + 2q (+ ``v_key_off``, mod 32),
    split and stored as 16-byte chunk r of row n, swizzled."""
    hi = np.zeros(width * BK, np.float32)
    lo = np.zeros(width * BK, np.float32)
    lane = np.arange(32)
    for b in range(width // 32):
        n = 32 * b + lane
        for r in range(8):
            vals = np.empty((4, 32), np.float32)
            for q in range(4):
                key = (8 * (r // 2) + r % 2 + 2 * q + v_key_off) % BK
                vals[q] = vwords[(b * BK * 128
                                  + _swz(key * 128 + lane * 4)) // 4]
            h, l_ = _split(vals, lo_terms)
            d = n * 128 + ((r ^ (n % 8)) << 4)
            for q in range(4):
                hi[(d + 4 * q) // 4] = h[q]
                lo[(d + 4 * q) // 4] = l_[q]
    return hi, lo


def _vt_operand(vt, j, width):
    """The 8 x width B operand wgmma reads at k8 step j of P V from a
    K-major swizzled V^T tile: slot s of row n at swz(n*128 + 32j +
    4s)."""
    s, n = np.meshgrid(np.arange(8), np.arange(width), indexing="ij")
    return vt[_swz(n * 128 + 32 * j + 4 * s) // 4]


def _p_fragment(p, j, r0, c):
    """The 64 x 8 A operand of k8 step j of P V, taken in place from the
    score accumulator: the thread holds sc[4j + e] at (r0 + 8 (e / 2),
    key 8j + 2c + e % 2) and passes a0..a3 = sc[4j], sc[4j + 2],
    sc[4j + 1], sc[4j + 3] as (r0, c), (r0 + 8, c), (r0, c + 4),
    (r0 + 8, c + 4)."""
    sc = np.stack([p[r0 + 8 * (e // 2), 8 * j + 2 * c + e % 2]
                   for e in range(4)])
    a = np.zeros((64, 8), np.float32)
    a[r0, c], a[r0 + 8, c] = sc[0], sc[2]
    a[r0, c + 4], a[r0 + 8, c + 4] = sc[1], sc[3]
    return a


def _tc_sum(acc, a, b, first):
    """Three products (lo*hi, hi*lo, hi*hi) of one k8 step, each operand
    as the tensor cores read it, each added to the f32 sums rounding
    toward zero; ``first`` starts the sums afresh (scale-d 0)."""
    (a_hi, a_lo), (b_hi, b_lo) = a, b
    for i, (x, y) in enumerate(((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))):
        prod = _tc(x).astype(np.float64) @ _tc(y).astype(np.float64)
        base = 0.0 if first and i == 0 else acc.astype(np.float64)
        acc = _rtz(base + prod)
    return acc


def _consumer(q, k, v, q0, cw, *, width, window, causal, lo_terms=True,
              promote=True, v_key_off=0):
    """One consumer warpgroup (rows q0 + 64 cw ..) of one head: its
    visited sub-tiles, the kernel's arithmetic in each.  q (Sq, hd), k,
    v (Skv, hd) f32 -> (64, width) f32 rows (zeros past Sq)."""
    sq, hd = q.shape
    skv = k.shape[0]
    qw0 = q0 + 64 * cw
    r0, c = _threads()
    qt = np.zeros((128, width), np.float32)
    qt[:max(0, min(128, sq - q0)), :hd] = q[q0:q0 + 128]
    qwords = _tile_words(qt, width)
    mask = 0xFFFFFFFF if lo_terms else 0
    scale_log2 = np.float32(1.0 / np.sqrt(hd) * LOG2E)
    o = np.zeros((64, width), np.float32)
    m = np.full(64, -np.inf, np.float32)
    l_ = np.zeros(64, np.float32)
    lo_w, hi_w = K4.key_tile_range(qw0, min(qw0 + 64, sq), skv, window,
                                   causal, K4.BKV)
    rows = qw0 + np.arange(64)[:, None]
    for u in range(2 * lo_w, 2 * hi_w):
        k0 = u * BK
        if k0 >= skv:
            continue
        kt = np.zeros((BK, width), np.float32)
        vt = np.zeros((BK, width), np.float32)
        kt[:min(BK, skv - k0), :hd] = k[k0:k0 + BK]
        vt[:min(BK, skv - k0), :hd] = v[k0:k0 + BK]
        kraw = _tile_words(kt, width)
        # the producer warps: hi over K in place, lo beside it
        k_hi = _tc(kraw)
        k_lo = ((kraw - k_hi).view(np.uint32) & np.uint32(mask)).view(
            np.float32)
        vt_hi, vt_lo = _transpose_v(_tile_words(vt, width), width,
                                    lo_terms, v_key_off)
        acc = np.zeros((64, BK), np.float32)
        for kk in range(width // 8):
            a_hi, a_lo = _split(_q_fragment(qwords, cw, kk, r0, c),
                                lo_terms)
            acc = _tc_sum(acc, (a_hi, a_lo),
                          (_k_operand(k_hi, kk), _k_operand(k_lo, kk)),
                          kk == 0)
        keys = k0 + np.arange(BK)[None, :]
        masked = np.zeros((64, BK), bool)
        if causal:
            masked |= keys > rows
        if window:
            masked |= keys <= rows - window
        s2 = np.where(keys >= skv, np.float32(-np.inf),
                      np.where(masked, np.float32(-1e30),
                               acc * scale_log2)).astype(np.float32)
        mn = np.maximum(m, s2.max(axis=1))
        alpha = np.exp2(m - mn).astype(np.float32)
        p = np.exp2(s2 - mn[:, None]).astype(np.float32)
        m = mn
        l_ = (l_ * alpha + p.sum(axis=1, dtype=np.float32)).astype(np.float32)
        if promote:   # P V afresh, then O = fma(O, alpha, P V)
            t = np.zeros_like(o)
        else:         # O rescaled, then summed on by the tensor cores
            t = o = (o * alpha[:, None]).astype(np.float32)
        for j in range(BK // 8):
            t = _tc_sum(t, _split(_p_fragment(p, j, r0, c), lo_terms),
                        (_vt_operand(vt_hi, j, width),
                         _vt_operand(vt_lo, j, width)), promote and j == 0)
        o = (o.astype(np.float64) * alpha[:, None] + t).astype(np.float32) \
            if promote else t
    return (o / np.maximum(l_, np.float32(1e-30))[:, None]).astype(np.float32)


def _model(q, k, v, *, groups, window, causal, **kw):
    """The kernel in its layout: q (BH, Sq, hd), k, v (BH / groups, Skv,
    hd) numpy f32 -> (BH, Sq, hd)."""
    bh, sq, hd = q.shape
    width = K4.sm90_tf32_head_dim(hd)
    out = np.zeros((bh, sq, hd), np.float32)
    for h in range(bh):
        for q0 in range(0, sq, 128):
            for cw in range(2):
                if q0 + 64 * cw >= sq:
                    continue
                rows = _consumer(q[h], k[h // groups], v[h // groups], q0,
                                 cw, width=width, window=window,
                                 causal=causal, **kw)
                r = slice(q0 + 64 * cw, min(q0 + 64 * cw + 64, sq))
                out[h, r] = rows[:r.stop - r.start, :hd]
    return out


def _inputs(b, sq, skv, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd))]


def _heads_first(a):
    b, s, h, hd = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b * h, s, hd))


def _exact(q, k, v, *, groups, window, causal):
    """float64 attention with the plain version's masks, heads first."""
    sq, skv, hd = q.shape[1], k.shape[1], q.shape[2]
    kx = np.repeat(k.astype(np.float64), groups, axis=0)
    vx = np.repeat(v.astype(np.float64), groups, axis=0)
    s = q.astype(np.float64) @ kx.transpose(0, 2, 1) / np.sqrt(hd)
    qp, kp = np.arange(sq)[:, None], np.arange(skv)[None, :]
    keep = np.ones((sq, skv), bool)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= kp > qp - window
    s = np.where(keep, s, -1e30)
    s = np.exp(s - s.max(axis=-1, keepdims=True))
    return (s / s.sum(axis=-1, keepdims=True)) @ vx


def _plain(q, k, v, **kw):
    return attention_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                           **kw).numpy()


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


# b, sq, skv, h, kv, hd, window, causal: causal, a window, GQA, ragged
# edges in queries and keys, no causal, 64 and 128 (and 80 and 32 at
# the widths they pad to), and rows with no unmasked key (q >= 20 + 8 - 1)
MODEL_CASES = [
    (1, 128, 128, 2, 1, 64, 0, True),
    (1, 200, 200, 2, 1, 128, 64, True),
    (1, 96, 160, 4, 2, 64, 0, False),
    (2, 130, 130, 2, 2, 128, 0, True),
    (1, 100, 100, 2, 1, 80, 32, True),
    (1, 64, 20, 2, 1, 32, 8, True),
    (1, 256, 256, 1, 1, 128, 0, True),
]
TOL = dict(rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("b,sq,skv,h,kv,hd,win,causal", MODEL_CASES)
def test_tf32_model_reproduces_the_reference(b, sq, skv, h, kv, hd, win,
                                             causal):
    arrs = _inputs(b, sq, skv, h, kv, hd, seed=sq + skv + hd)
    kw = dict(window=win, causal=causal)
    qf, kf, vf = (_heads_first(a) for a in arrs)
    got = _model(qf, kf, vf, groups=h // kv, **kw)
    np.testing.assert_allclose(
        got, _plain(qf, kf, vf, groups=h // kv, **kw), **TOL)
    assert _rel(got, _exact(qf, kf, vf, groups=h // kv, **kw)) <= 4e-6
    if skv % 32 == 0:   # the reference's Pallas kernel: lax semantics
        ref = np.asarray(jax_flash(*(jnp.asarray(a) for a in arrs),
                                   bq=32, bk=32, **kw))
        np.testing.assert_allclose(
            got, _heads_first(ref), **TOL)


def test_tf32_model_gives_masked_rows_the_mean_of_v():
    """Rows with no unmasked key (q >= Skv + window - 1) visit every key
    at the same -1e30: the mean of V over the Skv keys."""
    arrs = _inputs(1, 64, 20, 2, 1, 32, seed=3)
    qf, kf, vf = (_heads_first(a) for a in arrs)
    got = _model(qf, kf, vf, groups=2, window=8, causal=True)
    mean = vf.mean(axis=1)
    np.testing.assert_allclose(got[:, 27:], np.broadcast_to(
        mean[[0, 0]][:, None], (2, 37, 32)), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("b,sq,skv,h,kv,hd,win,causal", MODEL_CASES[:3])
def test_tf32_model_without_lo_terms_errs_more(b, sq, skv, h, kv, hd, win,
                                               causal):
    arrs = _inputs(b, sq, skv, h, kv, hd, seed=sq + skv + hd)
    kw = dict(groups=h // kv, window=win, causal=causal)
    qf, kf, vf = (_heads_first(a) for a in arrs)
    exact = _exact(qf, kf, vf, **kw)
    right = _rel(_model(qf, kf, vf, **kw), exact)
    one = _rel(_model(qf, kf, vf, lo_terms=False, **kw), exact)
    assert one >= 4 * right


def test_tf32_model_with_v_read_one_key_off_fails_the_gate():
    """The smoke's control: the transposers read V one key off."""
    arrs = _inputs(1, 128, 128, 2, 1, 64, seed=11)
    kw = dict(groups=2, window=0, causal=True)
    qf, kf, vf = (_heads_first(a) for a in arrs)
    plain = _plain(qf, kf, vf, **kw)
    wrong = _model(qf, kf, vf, v_key_off=1, **kw)
    assert np.abs(wrong - plain).max() > 100 * (
        TOL["atol"] + TOL["rtol"] * np.abs(plain).max())


def _card_gate(got, plain):
    """The smoke's f32 gate (``launch/yardstick.py`` ``CARD_TOL``): the
    worst |err| / (atol' + 2e-5 |plain|), atol' = min(2e-4, 1e-3
    rms(plain))."""
    atol = min(2e-4, 1e-3 * float(np.sqrt(np.mean(plain.astype(
        np.float64) ** 2))))
    return float((np.abs(got - plain) / (atol + 2e-5 * np.abs(plain))).max())


def _last_rows(q, k, v, rows: int, dtype):
    """Causal attention of the last ``rows`` queries over every key, in
    ``dtype`` (np.float64: exact; np.float32: the plain version's
    arithmetic, as ``attention_plain`` runs it, on those rows only)."""
    s, hd = q.shape
    if dtype == np.float32:
        qt, kt, vt = (torch.from_numpy(a) for a in (q[-rows:], k, v))
        sc = (qt @ kt.T) * (1.0 / hd ** 0.5)
        keep = (torch.arange(s)[None, :]
                <= torch.arange(s - rows, s)[:, None])
        sc = sc.masked_fill(~keep, -1e30)
        return (torch.softmax(sc, dim=-1) @ vt).numpy()
    sc = q[-rows:].astype(np.float64) @ k.T.astype(np.float64) / np.sqrt(hd)
    keep = np.arange(s)[None, :] <= np.arange(s - rows, s)[:, None]
    sc = np.where(keep, sc, -1e30)
    sc = np.exp(sc - sc.max(axis=-1, keepdims=True))
    return (sc / sc.sum(axis=-1, keepdims=True)) @ v.astype(np.float64)


def test_tf32_model_at_4096_keys_needs_its_promotion():
    """phi3-medium-14b's depth: the last 64 query rows of one causal
    head at 4096 keys (128 sub-tiles).  Each sub-tile's P V summed
    afresh on the tensor cores (12 truncating adds) and added to O on
    the CUDA cores stays within the f32 card gate of the plain version
    and within 5e-6 of max |exact|; O summed on the tensor cores over
    the whole sweep (1,536 truncating adds into each word) would still
    pass the gate but err over 4x more."""
    rng = np.random.default_rng(4096)
    s, hd = 4096, 128
    q, k, v = (rng.standard_normal((s, hd)).astype(np.float32)
               for _ in range(3))
    kw = dict(width=128, window=0, causal=True)
    got = _consumer(q, k, v, s - 128, 1, **kw)
    plain = _last_rows(q, k, v, 64, np.float32)
    exact = _last_rows(q, k, v, 64, np.float64)
    assert _card_gate(got, plain) <= 1.0
    promoted = _rel(got, exact)
    assert promoted <= 5e-6
    never = _consumer(q, k, v, s - 128, 1, promote=False, **kw)
    assert _card_gate(never, plain) <= 1.0
    assert _rel(never, exact) > 4 * promoted


# ------------------------------------------------------ bank conflicts


def test_q_fragment_loads_are_conflict_free():
    """A warp's four 4-byte Q loads of a k8 step each touch 32 distinct
    banks: 8 rows x 4 columns, the swizzle puts the 8 rows' words in 8
    distinct 16-byte chunks."""
    r0, c = _threads()
    for cw in range(2):
        for kk in range(16):
            base = ((kk // 4) * 128 * 128 + (cw * 64 + r0) * 128
                    + (8 * (kk % 4) + c) * 4)
            for off in (0, 16, 8 * 128, 8 * 128 + 16):
                banks = (_swz(base + off) // 4) % 32
                for w in range(4):
                    assert len(set(banks[32 * w:32 * w + 32].tolist())) == 32


def test_v_loads_and_transposer_stores_are_conflict_free():
    """A transposer's 4-byte V loads (a lane a column of one key row)
    touch 32 distinct banks; its 16-byte stores (8 lanes, rows n % 8 =
    0..7 of an atom) fall in 8 distinct chunks: one wavefront each."""
    lane = np.arange(32)
    for key in range(BK):
        banks = (_swz(key * 128 + lane * 4) // 4) % 32
        assert len(set(banks.tolist())) == 32
    for b in range(4):
        n = 32 * b + lane
        for r in range(8):
            addr = n * 128 + ((r ^ (n % 8)) << 4)
            for quarter in range(4):
                chunks = (addr[8 * quarter:8 * quarter + 8] % 128) // 16
                assert len(set(chunks.tolist())) == 8


def test_v_transpose_order_is_the_p_fragments():
    """Slot s of k8 step j holds the same key in the P fragment (the
    thread's score registers) and in V^T (the transposers' chunk
    order): key 8j + 2s for s < 4, 8j + 2(s - 4) + 1 after, a bijection
    of the sub-tile's 32 keys."""
    seen = []
    for j in range(4):
        for s in range(8):
            c, half = s % 4, s // 4
            p_key = 8 * j + 2 * c + half          # sc[4j + half]
            pos = 8 * j + s                       # word of the V^T row
            r, q = divmod(pos, 4)                 # chunk r, word q
            v_key = 8 * (r // 2) + r % 2 + 2 * q  # the transposers'
            assert p_key == v_key
            seen.append(p_key)
    assert sorted(seen) == list(range(32))


# ------------------------------------------- kernel against the wrapper


def _src() -> str:
    return K4.TF32_SOURCE.read_text()


def test_tf32_kernel_constants_match_the_wrapper():
    src = _src()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kBQW") * const("kConsumers") == K4.TF32_BQ
    assert const("kBKV") == K4.BKV
    assert const("kBK") == K4.TF32_BK
    assert const("kStages") == K4.TF32_STAGES
    assert const("kTransposers") == K4.TF32_TRANSPOSERS
    inst = {int(w) for w in re.findall(r"case (\d+): return launch<", src)}
    assert inst == set(K4.TF32_HEAD_DIMS)
    # the producer's and both consumers' setmaxnreg sum to 3 x 168
    dec = int(re.search(r"setmaxnreg\.dec\.sync\.aligned\.u32 (\d+)", src)[1])
    inc = int(re.search(r"setmaxnreg\.inc\.sync\.aligned\.u32 (\d+)", src)[1])
    assert dec + 2 * inc <= 504
    # the kernel checks the plan's offsets against its own sizes
    assert "bars_off < split_off + kStages * C::kSplit" in src


def test_wrapper_binds_the_kernels_c_interface():
    """The entry without the log-sum-exp (4 pointers) and the one with
    it (an ``lse`` pointer after ``out``), 14 ints and the stream each;
    the wrapper binds the one it calls by its pointer count."""
    for entry, pointers in (("attention_block_sm90_tf32_forward", 4),
                            ("attention_block_sm90_tf32_forward_lse", 5)):
        sig = re.search(rf'extern "C" int {entry}\((.*?)\)', _src(),
                        re.S)[1]
        params = [p.strip() for p in sig.split(",")]
        assert sum(p.startswith("int ") for p in params) == 14
        assert sum("*" in p for p in params) == pointers + 1  # + stream
    wrapper = Path(K4.__file__).read_text()
    assert 'entry = "attention_block_sm90_tf32_forward"' in wrapper
    assert 'entry += "_lse"' in wrapper
    assert "lib.bind(entry, len(ptrs), 14)" in wrapper
