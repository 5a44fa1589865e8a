"""The LM building blocks of the port on the CPU against the reference's,
on the same numpy inputs: ``rms_norm``, ``apply_rope`` (scalar and
vector positions), ``swiglu``, ``cast_params_for_compute`` (its
``_KEEP_F32`` set), ``attention_chunked`` (against the reference's and
the port's ``attention_naive``), ``decode_attention``, and the port's
decode dispatch onto K4 (``decode_block``: the cache slots the
reference's mask keeps, gathered, then ``flash_attention`` without a
causal mask, whose wrapper runs the plain version on a CPU tensor)
against the reference's ``decode_attention`` / ``decode_block`` over an
empty cache, a filled prefix, a wrapped ring, a slot set that is not
a prefix, a position past the last slot, and a mask that keeps no
slot.

Tolerances (f32 unless stated): elementwise ops 1e-6 of max |ref| (one
ulp's worth of libm differences); attention 2e-5 absolute on unit
normal inputs (the reference's own chunked-vs-naive tolerance); bf16
``rms_norm`` one bf16 rounding step (2^-7 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_cache_from_numpy
from repro_torch.models import attention as A
from repro_torch.models import layers as L

KEY = jax.random.PRNGKey(0)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(out, ref, rel):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-30), err


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    x, w = _rand(3, 5, 64), _rand(64, seed=1)
    ref = jax_layers.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w))
    out = L.rms_norm(_t(x).to(getattr(torch, dtype)), _t(w))
    assert out.dtype == getattr(torch, dtype)
    _close(out.float(), np.asarray(ref.astype(jnp.float32)),
           1e-6 if dtype == "float32" else 2 ** -7)


@pytest.mark.parametrize("pos", [0, 5, 37, "vector"])
def test_apply_rope_matches_reference(pos):
    x = _rand(2, 12, 4, 16)
    if pos == "vector":
        jpos, tpos = jnp.arange(12, dtype=jnp.int32), torch.arange(12)
    else:
        jpos, tpos = jnp.asarray(pos, jnp.int32), pos
    ref = jax_layers.apply_rope(jnp.asarray(x), jpos, 1e4)
    out = L.apply_rope(_t(x), tpos, 1e4)
    _close(out, np.asarray(ref), 1e-6)
    if pos != "vector":     # a 0-d tensor and an int agree
        _close(L.apply_rope(_t(x), torch.tensor(pos), 1e4), out, 0.0)


def test_rope_frequencies_match_reference():
    _close(L.rope_frequencies(128, 1e4),
           np.asarray(jax_layers.rope_frequencies(128, 1e4)), 1e-6)


def test_swiglu_matches_reference():
    x, wg, wu, wd = (_rand(2, 7, 32), _rand(32, 48, seed=1) / 6,
                     _rand(32, 48, seed=2) / 6, _rand(48, 32, seed=3) / 7)
    ref = jax_layers.swiglu(*map(jnp.asarray, (x, wg, wu, wd)))
    _close(L.swiglu(*map(_t, (x, wg, wu, wd))), np.asarray(ref), 1e-6)


def test_cast_params_for_compute_keeps_the_reference_f32_set():
    assert L._KEEP_F32 == jax_layers._KEEP_F32
    names = sorted(L._KEEP_F32) + ["wq", "wo", "embed", "w"]
    tree = {"blocks": [{n: _rand(4, 4) for n in names}],
            "vec": _rand(4), "table": _rand(8, 4),
            "half": _rand(4, 4).astype(jnp.bfloat16)}
    ref = jax_layers.cast_params_for_compute(
        {"blocks": [{n: jnp.asarray(a) for n, a in tree["blocks"][0].items()}],
         "vec": jnp.asarray(tree["vec"]), "table": jnp.asarray(tree["table"]),
         "half": jnp.asarray(tree["half"])}, jnp.bfloat16)
    port = L.cast_params_for_compute(
        {"blocks": [{n: _t(a) for n, a in tree["blocks"][0].items()}],
         "vec": _t(tree["vec"]), "table": _t(tree["table"]),
         "half": _t(tree["half"].astype(np.float32)).to(torch.bfloat16)},
        torch.bfloat16)
    want = {n: str(ref["blocks"][0][n].dtype) for n in names}
    got = {n: str(port["blocks"][0][n].dtype).removeprefix("torch.")
           for n in names}
    assert got == want
    for n in ("vec", "table", "half"):
        assert str(port[n].dtype).removeprefix("torch.") == str(ref[n].dtype)


@pytest.mark.parametrize("window", [0, 16])
def test_attention_chunked_matches_reference_and_naive(window):
    q, k, v = _rand(2, 40, 4, 16), _rand(2, 40, 2, 16, seed=1), \
        _rand(2, 40, 2, 16, seed=2)
    pos = np.arange(40, dtype=np.int32)
    ref = jax_layers.attention_chunked(*map(jnp.asarray, (q, k, v, pos, pos)),
                                       window, chunk=16)
    out = L.attention_chunked(*map(_t, (q, k, v)), torch.from_numpy(pos),
                              torch.from_numpy(pos), window, chunk=16)
    naive = L.attention_naive(*map(_t, (q, k, v)), torch.from_numpy(pos),
                              torch.from_numpy(pos), window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(out.numpy(), naive.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_repeat_kv_matches_reference():
    k = _rand(2, 5, 3, 8)
    np.testing.assert_array_equal(
        L.repeat_kv(_t(k), 4).numpy(),
        np.asarray(jax_layers.repeat_kv(jnp.asarray(k), 4)))


# slots' positions (-1 = empty), cur_pos, window
DECODE_POS = {
    "empty": ([-1] * 8, 0, 0),
    "prefix": ([0, 1, 2, 3, 4, -1, -1, -1], 4, 0),
    "wrapped_ring": ([8, 9, 10, 3, 4, 5, 6, 7], 10, 8),
    "ring_window_drops_old": ([8, 9, 10, 3, 4, 5, 6, 7], 10, 5),
    "not_a_prefix": ([0, -1, 2, 9, 4, -1, 6, 5], 6, 0),
}


@pytest.mark.parametrize("case", sorted(DECODE_POS))
def test_decode_attention_matches_reference(case):
    pos, cur, window = DECODE_POS[case]
    q, kc, vc = _rand(2, 1, 4, 16), _rand(2, 8, 2, 16, seed=1), \
        _rand(2, 8, 2, 16, seed=2)
    kv_pos = np.array(pos, np.int32)
    ref = jax_layers.decode_attention(
        *map(jnp.asarray, (q, kc, vc, kv_pos)), jnp.asarray(cur, jnp.int32),
        window=window, chunk=4)
    out = L.decode_attention(*map(_t, (q, kc, vc)), kv_pos, cur,
                             window=window, chunk=4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_kept_slots_is_the_reference_mask():
    rng = np.random.default_rng(3)
    for _ in range(200):
        pos = rng.integers(-1, 20, size=16).astype(np.int32)
        cur, window = int(rng.integers(0, 20)), int(rng.integers(0, 6))
        mask = (pos >= 0) & (pos <= cur)
        if window:
            mask &= pos > cur - window
        np.testing.assert_array_equal(A.kept_slots(pos, cur, window),
                                      np.flatnonzero(mask))


def test_gather_slices_a_prefix_and_selects_the_rest():
    c = torch.arange(2 * 6 * 1 * 2, dtype=torch.float32).reshape(2, 6, 1, 2)
    pre = A._gather(c, np.array([0, 1, 2]))
    assert pre.data_ptr() == c.data_ptr() and pre.shape[1] == 3
    sel = A._gather(c, np.array([0, 2, 5]))
    assert torch.equal(sel, c[:, [0, 2, 5]])


def _cfgs(window):
    return (jax_reduced(jax_get_config("phi3-medium-14b"), window=window),
            reduced(get_config("phi3-medium-14b"), window=window))


def _scenario(name):
    """A reference cache (stacked on a block axis of 1, as the reference's
    cache tree is) and the position to decode at."""
    jcfg, _ = _cfgs(8 if name == "wrapped_ring" else 0)
    b, kvh, hd = 2, jcfg.n_kv_heads, jcfg.head_dim
    if name == "empty":
        cache = jax_attn.init_cache(b, 12, kvh, hd, 0, jnp.float32)
        return cache, 0
    if name == "prefix":
        k, v = _rand(b, 5, kvh, hd, seed=4), _rand(b, 5, kvh, hd, seed=5)
        cache = jax_attn.cache_from_prefill(
            jnp.asarray(k), jnp.asarray(v), jnp.arange(5, dtype=jnp.int32),
            12, 0)
        return cache, 5
    if name == "wrapped_ring":
        k, v = _rand(b, 13, kvh, hd, seed=4), _rand(b, 13, kvh, hd, seed=5)
        cache = jax_attn.cache_from_prefill(
            jnp.asarray(k), jnp.asarray(v), jnp.arange(13, dtype=jnp.int32),
            32, 8)
        return cache, 13
    if name == "past_the_end":
        # no window and cur_pos past the last slot: the reference's one
        # shard owns no slot for it, so nothing is written
        k, v = _rand(b, 6, kvh, hd, seed=4), _rand(b, 6, kvh, hd, seed=5)
        cache = jax_attn.cache_from_prefill(
            jnp.asarray(k), jnp.asarray(v), jnp.arange(6, dtype=jnp.int32),
            6, 0)
        return cache, 9
    if name == "nothing_kept":
        # an empty cache decoded past its end: every score masked, the
        # reference's softmax uniform over all slots
        cache = jax_attn.init_cache(b, 6, kvh, hd, 0, jnp.float32)
        cache["k"] = jnp.asarray(_rand(b, 6, kvh, hd, seed=4))
        cache["v"] = jnp.asarray(_rand(b, 6, kvh, hd, seed=5))
        return cache, 7
    # not a prefix: a cache filled to 9, decoded at 4 (the slots past it
    # are masked), with two holes
    k, v = _rand(b, 9, kvh, hd, seed=4), _rand(b, 9, kvh, hd, seed=5)
    cache = jax_attn.cache_from_prefill(
        jnp.asarray(k), jnp.asarray(v), jnp.arange(9, dtype=jnp.int32), 12, 0)
    cache["pos"] = cache["pos"].at[jnp.array([1, 2])].set(-1)
    return cache, 4


@pytest.mark.parametrize("name", ["empty", "prefix", "wrapped_ring",
                                  "not_a_prefix", "past_the_end",
                                  "nothing_kept"])
def test_decode_block_k4_dispatch_matches_reference(name, monkeypatch):
    jcache, cur = _scenario(name)
    jcfg, cfg = _cfgs(8 if name == "wrapped_ring" else 0)
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    jparams = jax_attn.init_attention(KEY, cfg.d_model, nh, nkv, hd,
                                      jnp.float32)
    h = _rand(2, 1, cfg.d_model, seed=6)
    ref_out, ref_cache = jax_attn.decode_block(
        jparams, jnp.asarray(h), jcache, jnp.asarray(cur, jnp.int32), jcfg,
        nh, nkv)
    params = {n: _t(a) for n, a in jparams.items()}
    cache = lm_cache_from_numpy(
        {"c": {n: np.asarray(a)[None] for n, a in jcache.items()}},
        device="cpu")[0]["c"]
    # the kernel path: nothing plain runs on it
    monkeypatch.setattr(A, "decode_attention", None)
    seen = []
    out, new = A.decode_block(params, _t(h), cache, cur, cfg, nh, nkv,
                              tap=lambda q, k, v, o, **kw: seen.append(
                                  (k.shape[1], kw)))
    kept = A.kept_slots(new["pos"], cur, cfg.window)
    assert seen == [(len(kept) or cache["k"].shape[1],
                     {"window": 0, "causal": False})]
    # the token's own key is kept where it has a slot (always in a ring)
    assert (cur in new["pos"][kept]) == bool(cfg.window
                                             or cur < cache["k"].shape[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_array_equal(new["pos"], np.asarray(ref_cache["pos"]))
    for n in ("k", "v"):
        np.testing.assert_allclose(new[n].numpy(), np.asarray(ref_cache[n]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("max_seq,window", [(12, 0), (6, 0), (6, 4),
                                            (20, 8), (8, 16)])
def test_cache_from_prefill_matches_reference(max_seq, window):
    """A 10-token prefill into caches shorter and longer than it, with
    and without a ring: past the last slot (no window) the reference's
    scatter drops the position, in a ring it wraps."""
    k, v = _rand(2, 10, 2, 16), _rand(2, 10, 2, 16, seed=1)
    ref = jax_attn.cache_from_prefill(jnp.asarray(k), jnp.asarray(v),
                                      jnp.arange(10, dtype=jnp.int32),
                                      max_seq, window)
    out = A.cache_from_prefill(_t(k), _t(v), np.arange(10, dtype=np.int32),
                               max_seq, window)
    np.testing.assert_array_equal(out["pos"], np.asarray(ref["pos"]))
    for n in ("k", "v"):
        np.testing.assert_array_equal(out[n].numpy(), np.asarray(ref[n]))
