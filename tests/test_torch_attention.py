"""The port's blocked attention on the CPU held against the reference:
``repro_torch.kernels.attention_block.ops.flash_attention`` (whose
kernel wrapper runs the plain version on a CPU tensor) against the
reference's Pallas kernel at ``target="interpret"``, its oracle
``attention_ref`` and its ``target="lax"``, on the same numpy inputs,
over every case and type of the reference's sweep
(``tests/test_kernels.py:225-256``).

A query row with no unmasked key (``Sq > Skv`` with a window) takes the
``lax`` target's semantics: the mean of V over the real keys.  The
reference's Pallas kernel agrees when ``Skv`` is a multiple of its
``bk``; its oracle gives NaN there (it masks with ``-inf``).

Tolerances are the reference's: f32 ``rtol 2e-5, atol 2e-4``; bf16
``rtol 8e-2, atol 0.8``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention_block.ops import flash_attention as jax_flash
from repro.kernels.attention_block.ref import attention_ref as jax_ref
from repro.models.layers import attention_naive as jax_naive
from repro_torch.kernels.attention_block import kernel as K4
from repro_torch.kernels.attention_block.ops import (flash_attention,
                                                     heads_first)
from repro_torch.kernels.attention_block.ref import (attention_plain,
                                                     attention_ref)
from repro_torch.models.layers import attention_naive

TOL = {"float32": (2e-5, 2e-4), "bfloat16": (8e-2, 0.8)}
# b, sq, skv, h, kv, hd, window, causal
SWEEP = [
    (2, 64, 64, 4, 2, 16, 0, True),
    (1, 100, 100, 8, 8, 32, 0, True),
    (2, 128, 128, 4, 1, 16, 32, True),
    (1, 48, 80, 4, 4, 16, 0, False),
    (1, 33, 65, 2, 1, 8, 16, True),
]


def _inputs(b, sq, skv, h, kv, hd, dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd))]
    if dtype == "bfloat16":     # round once, the same words on both sides
        arrs = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    return arrs


def _port(fn, arrs, dtype="float32", **kw):
    t = getattr(torch, dtype)
    out = fn(*[torch.from_numpy(a).to(t) for a in arrs], **kw)
    assert out.dtype == t
    return out.to(torch.float32).numpy()


def _jax(fn, arrs, dtype="float32", **kw):
    t = getattr(jnp, dtype)
    out = fn(*[jnp.asarray(a, t) for a in arrs], **kw)
    assert out.dtype == t
    return np.asarray(out.astype(jnp.float32))


def _close(out, ref, dtype="float32"):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,h,kv,hd,win,causal", SWEEP)
def test_flash_attention_matches_reference(b, sq, skv, h, kv, hd, win,
                                           causal, dtype):
    arrs = _inputs(b, sq, skv, h, kv, hd, dtype)
    kw = dict(window=win, causal=causal)
    got = _port(flash_attention, arrs, dtype, bq=32, bk=32, **kw)
    assert got.shape == (b, sq, h, hd)
    _close(got, _jax(jax_flash, arrs, dtype, bq=32, bk=32,
                     target="interpret", **kw), dtype)
    _close(got, _jax(jax_ref, arrs, dtype, **kw), dtype)
    _close(got, _jax(jax_flash, arrs, dtype, target="lax", **kw), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,h,kv,hd,win,causal", SWEEP)
def test_oracle_matches_reference_oracle(b, sq, skv, h, kv, hd, win,
                                         causal, dtype):
    arrs = _inputs(b, sq, skv, h, kv, hd, dtype, seed=1)
    kw = dict(window=win, causal=causal)
    _close(_port(attention_ref, arrs, dtype, **kw),
           _jax(jax_ref, arrs, dtype, **kw), dtype)


def test_attention_naive_matches_reference():
    q, k, v = _inputs(2, 40, 56, 4, 2, 16)
    q_pos, kv_pos = np.arange(16, 56), np.arange(56)
    got = attention_naive(*[torch.from_numpy(a) for a in (q, k, v)],
                          torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                          window=12).numpy()
    _close(got, np.asarray(jax_naive(q, k, v, jnp.asarray(q_pos),
                                     jnp.asarray(kv_pos), window=12)))


# q (1, 64, 2, 16), k/v (1, 20, 1, 16), window 8, causal: rows
# q >= 20 + 8 - 1 have no unmasked key
MASKED = (1, 64, 20, 2, 1, 16)


def test_fully_masked_rows_take_the_lax_semantics():
    arrs = _inputs(*MASKED, seed=2)
    kw = dict(window=8, causal=True)
    got = _port(flash_attention, arrs, **kw)
    mean_v = arrs[2][0, :, 0].mean(axis=0)
    for row in (27, 40, 63):
        _close(got[0, row, 0], mean_v)
        _close(got[0, row, 1], mean_v)
    _close(got, _jax(jax_flash, arrs, target="lax", **kw))
    # the reference kernel agrees where no kv padding exists (bk | Skv)
    for bq, bk in ((32, 32), (16, 10), (64, 20)):
        _close(got, _jax(jax_flash, arrs, bq=bq, bk=bk, target="interpret",
                         **kw))
    # its oracle masks with -inf: NaN on those rows, equal elsewhere
    oracle = _jax(jax_ref, arrs, **kw)
    assert np.isnan(oracle[0, 27:]).all()
    _close(got[0, :27], oracle[0, :27])


@pytest.mark.parametrize("bq,bk", [(16, 16), (32, 96), (96, 32), (48, 48),
                                   (8, 8), (128, 128)])
def test_block_size_invariance(bq, bk):
    """The blocks change no result, in either package (the reference's
    where its kv padding is empty)."""
    arrs = _inputs(1, 96, 96, 4, 2, 16, seed=3)
    ref = _jax(jax_ref, arrs)
    got = _port(flash_attention, arrs, bq=bq, bk=bk)
    np.testing.assert_array_equal(got, _port(flash_attention, arrs))
    _close(got, ref)
    _close(_jax(jax_flash, arrs, bq=bq, bk=bk, target="interpret"), ref)


def test_window_applies_without_causal():
    arrs = _inputs(1, 40, 40, 2, 1, 8, seed=4)
    kw = dict(window=6, causal=False)
    _close(_port(flash_attention, arrs, **kw),
           _jax(jax_flash, arrs, target="lax", **kw))


def test_plain_version_is_the_heads_first_layout():
    q, k, v = _inputs(2, 24, 30, 6, 3, 8, seed=5)
    got = attention_plain(*[heads_first(torch.from_numpy(a))
                            for a in (q, k, v)], groups=2, window=5)
    want = _port(flash_attention, (q, k, v), window=5)
    np.testing.assert_array_equal(
        got.reshape(2, 6, 24, 8).transpose(1, 2).numpy(), want)


def test_cpu_tensors_launch_nothing_and_account_only_raises():
    before = K4.attention.launches
    arrs = _inputs(1, 16, 16, 2, 1, 8)
    _port(flash_attention, arrs)
    assert K4.attention.launches == before
    t = [torch.from_numpy(a) for a in arrs]
    with pytest.raises(ValueError, match="account-only"):
        flash_attention(*t, target="account-only")
    with pytest.raises(ValueError, match="group"):
        flash_attention(t[0], torch.zeros((1, 16, 3, 8)),
                        torch.zeros((1, 16, 3, 8)))


def test_padded_head_dim_and_its_shared_memory():
    """A head dim runs on the FMA kernel at the next instantiated width
    up to 256, and above 256 at 256 in ceil(hd / 256) column chunks
    (no head dim raises); every width fits the card's shared memory in
    both types, with one K/V stage only where two do not fit (f32 at
    256, which is also the tile of the chunked head dims)."""
    from repro_torch.core.hopper_adapter import SMEM_PER_BLOCK
    want = {1: 8, 8: 8, 9: 16, 20: 32, 24: 32, 33: 64, 64: 64, 65: 80,
            80: 80, 81: 96, 96: 96, 100: 128, 128: 128, 129: 256,
            200: 256, 256: 256, 257: 256, 320: 256, 512: 256, 4096: 256}
    assert {hd: K4.padded_head_dim(hd) for hd in want} == want
    chunks = {1: 1, 256: 1, 257: 2, 320: 2, 512: 2, 513: 3, 4096: 16}
    assert {hd: K4.head_dim_chunks(hd) for hd in chunks} == chunks
    for width in K4.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            stages = K4.attention_stages(width, dtype)
            assert stages == (1 if (width, dtype) == (256, torch.float32)
                              else 2)
            assert K4.attention_smem_bytes(width, dtype) <= SMEM_PER_BLOCK
    assert K4.attention_smem_bytes(256, torch.float32, 2) > SMEM_PER_BLOCK
    assert K4.attention_smem_bytes(256, torch.float32, 1) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,h,kv,hd,win,causal", [
    (1, 24, 24, 2, 1, 320, 0, True),
    (1, 20, 28, 2, 2, 512, 8, False),
    (1, 40, 16, 2, 1, 264, 6, True),
])
def test_flash_attention_above_head_dim_256_matches_reference(
        b, sq, skv, h, kv, hd, win, causal, dtype):
    """Head dims above the kernels' widest instance: the port (whose
    FMA kernel runs them as 256-column chunks on the card) against the
    reference's Pallas kernel at ``interpret`` and its ``lax`` target;
    the last case has rows with no unmasked key (q >= 16 + 6 - 1)."""
    arrs = _inputs(b, sq, skv, h, kv, hd, dtype, seed=6)
    kw = dict(window=win, causal=causal)
    got = _port(flash_attention, arrs, dtype, bq=8, bk=8, **kw)
    assert got.shape == (b, sq, h, hd)
    _close(got, _jax(jax_flash, arrs, dtype, target="lax", **kw), dtype)
    if skv % 8 == 0 or not win:
        _close(got, _jax(jax_flash, arrs, dtype, bq=8, bk=8,
                         target="interpret", **kw), dtype)


def _brute_tiles(q0, q1, skv, window, causal, bkv):
    """Per key tile: does any row of [q0, q1) keep a key in it, and is
    any row of [q0, q1) left with no unmasked key at all."""
    q = np.arange(q0, q1)[:, None]
    k = np.arange(skv)[None, :]
    keep = np.ones((q1 - q0, skv), bool)
    if causal:
        keep &= k <= q
    if window:
        keep &= k > q - window
    nkv = -(-skv // bkv)
    hold = [keep[:, t * bkv:(t + 1) * bkv].any() for t in range(nkv)]
    return hold, bool((~keep.any(axis=1)).any())


@pytest.mark.parametrize("window", [0, 1, 8, 20, 64, 100, 1000])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(130, 130), (64, 20), (200, 77),
                                    (33, 65), (1, 1), (257, 300)])
def test_key_tile_range_visits_every_unmasked_pair(sq, skv, window,
                                                   causal):
    """Against brute-force enumeration of the masks, for every query
    tile: every unmasked pair lies in a visited key tile, every skipped
    tile is wholly masked for the tile's rows, the range is contiguous
    and tight (its end tiles hold an unmasked pair), and a tile that
    holds a row with no unmasked key visits every key tile."""
    for bq, bkv in ((64, 64), (16, 32), (32, 16)):
        for q0 in range(0, sq, bq):
            q1 = min(q0 + bq, sq)
            lo, hi = K4.key_tile_range(q0, q1, skv, window, causal, bkv)
            hold, masked_row = _brute_tiles(q0, q1, skv, window, causal,
                                            bkv)
            if masked_row:
                assert (lo, hi) == (0, len(hold))
                continue
            assert 0 <= lo < hi <= len(hold)
            assert not any(hold[:lo]) and not any(hold[hi:])
            assert hold[lo] and hold[hi - 1]


def test_visited_pairs_counts_the_visited_tiles():
    """Causal S 4096 visits the lower triangle of 64 x 64 tiles, the
    diagonal tiles whole: 1 + 63/4097 of the unmasked pairs; a full
    mask (no causal, no window) visits every pair once."""
    unmasked = 4096 * 4097 // 2
    visited = K4.visited_pairs(4096, 4096, 0, True)
    assert visited == 64 * 64 * (64 * 65 // 2)
    assert visited / unmasked == pytest.approx(1 + 63 / 4097)
    assert K4.visited_pairs(100, 70, 0, False) == 100 * 70
    # every row fully masked: each query tile visits all keys
    assert K4.visited_pairs(64, 20, 8, True) == 27 * 20 + 37 * 20


@pytest.mark.parametrize("hd", [1, 8, 16, 20, 24, 64, 72, 80, 96, 100,
                                104, 128, 136, 200, 256, 257, 264, 320,
                                512])
def test_route_by_type_and_head_dim(hd):
    """bf16 whose rows TMA describes (hd a multiple of 8, up to 256)
    takes sm90 at the next of 64, 80, 96, 128, 256; f32 whose rows TMA
    describes (hd a multiple of 4) up to 128 takes sm90_tf32 at the next
    of 64, 96, 128; everything else (other head dims, above those)
    takes fma."""
    sm90 = hd % 8 == 0 and hd <= 256
    tf32 = hd % 4 == 0 and hd <= 128
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((2, 4, hd), dtype=dtype)
        kv = torch.zeros((1, 4, hd), dtype=dtype)
        want = ("sm90" if sm90 and dtype == torch.bfloat16
                else "sm90_tf32" if tf32 and dtype == torch.float32
                else "fma")
        assert K4.route(q, kv, kv) == want
    width = K4.sm90_head_dim(hd)
    assert width == (min(w for w in K4.SM90_HEAD_DIMS if w >= hd)
                     if sm90 else None)
    # the sm90 CTA holds 128 query rows, 64 at width 256
    if width is not None:
        assert K4.sm90_cta_rows(width) == (64 if width == 256 else 128)
    # a mixed pair of types is never sm90
    q = torch.zeros((2, 4, hd), dtype=torch.bfloat16)
    assert K4.route(q, torch.zeros((1, 4, hd)), torch.zeros((1, 4, hd))) \
        == "fma"


def test_cpu_tensors_count_no_launch_on_any_route():
    before = dict(K4.attention.launches_by_route)
    q = torch.zeros((2, 16, 64), dtype=torch.bfloat16)
    kv = torch.zeros((1, 16, 64), dtype=torch.bfloat16)
    out = K4.attention(q, kv, kv, groups=2, via="sm90")
    assert out.dtype == torch.bfloat16
    assert K4.attention.launches_by_route == before
    assert set(before) == set(K4.ROUTES)


# head dims outside the configs': 80 and 96 (phi-2, llama-style 96),
# 20 (padded, and not 16-byte pitched)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,h,kv,hd,win,causal", [
    (1, 40, 40, 4, 2, 80, 0, True),
    (1, 33, 33, 2, 1, 96, 16, True),
    (2, 24, 24, 2, 2, 20, 0, True),
])
def test_flash_attention_at_other_head_dims_matches_reference(
        b, sq, skv, h, kv, hd, win, causal, dtype):
    arrs = _inputs(b, sq, skv, h, kv, hd, dtype, seed=2)
    kw = dict(window=win, causal=causal)
    got = _port(flash_attention, arrs, dtype, bq=32, bk=32, **kw)
    assert got.shape == (b, sq, h, hd)
    _close(got, _jax(jax_flash, arrs, dtype, bq=32, bk=32,
                     target="interpret", **kw), dtype)
    _close(got, _jax(jax_flash, arrs, dtype, target="lax", **kw), dtype)
