"""The port's encoder-decoder (whisper-medium) on the CPU against the
reference's ``repro.models.encdec``, on the same weights: the
reference's ``build(cfg).init`` drawn with a JAX key, handed over as
numpy leaves through ``repro_torch.convert``.

At ``reduced(get_config("whisper-medium"))`` in f32 (2 encoder and 2
decoder layers, d_model 64, 4 heads over 2, hd 16), both with K4's plain
version (``attn="kernel"`` on the CPU) and with ``attn="plain"``:
``encode``, ``decoder_forward`` (hidden states and every cache leaf),
``prefill``'s logits and caches, a prefill followed by 3 decode steps,
3 decode steps from ``init_cache`` (cross-attention over 1500 zero
slots), each within 1e-5 of max |ref|, at frame counts where the
reference's chunked attention pads no key (T 32 at ``attn_chunk`` 32,
T 37 at 37); the reference's ``test_arch_smoke_decode_matches_prefill``
(rtol/atol 2e-4) and ``test_multi_token_decode_chain`` (3e-4) mirrored;
params and caches to the port and back bit for bit; the full-size init
on ``meta`` against ``jax.eval_shape`` of the reference's.

The departure, kept on purpose: for a non-causal call the reference's
``attention_chunked`` gives every query and every pad key the position
``INT32_MAX``, so its zero pad keys pass the mask whenever the key count
is not a multiple of the chunk.  The port attends over the real keys.
At T = 1500 the port's non-causal ``attention_block`` equals the
reference's exact ``impl="naive"`` one, from which the reference's
chunked call (chunk 32: 4 pad keys) is 100x the tolerance away; the
port's ``encode`` and ``prefill`` equal the reference run at
``attn_chunk`` 1500 (no padding), from which the reference at its own
chunk 32 is more than 1e-4 of max away.  A non-causal call under a
window raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import attention as jax_attn
from repro.models import encdec as jax_encdec
from repro.models.api import build as jax_build
from repro.models.layers import cast_params_for_compute as jax_cast
from repro_torch.configs import get_config, reduced
from repro_torch.convert import (lm_cache_from_numpy, lm_cache_to_numpy,
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec
from repro_torch.models.api import build

KEY = jax.random.PRNGKey(0)
ARCH = "whisper-medium"
ATTN = ["kernel", "plain"]
#: (frames, attn_chunk) at which the reference's chunked attention pads
#: no key: T <= the chunk, or a multiple of it
UNPADDED = [(32, 32), (37, 37)]
REL = 1e-5


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(**overrides):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = jax_reduced(jax_get_config(ARCH), **overrides)
    cfg = reduced(get_config(ARCH), **overrides)
    jparams = jax_build(jcfg).init(KEY)
    return jcfg, cfg, jparams, lm_params_from_numpy(_numpy_tree(jparams),
                                                    device="cpu")


def _batch(cfg, b=2, s=8, frames=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "frames": (rng.standard_normal((b, frames, cfg.d_model))
                       * 0.02).astype(np.float32)}


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _err(out, ref) -> float:
    """max |out - ref| over max |ref| (an all-zero ``ref``: max |out|)."""
    out = np.asarray(out.float() if isinstance(out, torch.Tensor) else out,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    return float(err / np.abs(ref).max() if err else 0.0)


def _within(out, ref, rel=REL):
    err = _err(out, ref)
    assert err <= rel, err


def _caches_within(port_caches, ref_caches, rel=REL):
    port = lm_cache_to_numpy(port_caches)
    ref = _numpy_tree(ref_caches)
    assert port.keys() == ref.keys() == {"self", "cross_k", "cross_v"}
    np.testing.assert_array_equal(port["self"]["pos"], ref["self"]["pos"])
    for name in ("k", "v"):
        assert port["self"][name].dtype == ref["self"][name].dtype
        _within(port["self"][name], ref["self"][name], rel)
    for name in ("cross_k", "cross_v"):
        assert port[name].dtype == ref[name].dtype
        _within(port[name], ref[name], rel)


@pytest.mark.parametrize("attn", ATTN)
@pytest.mark.parametrize("frames,chunk", UNPADDED)
def test_encode_matches_reference(frames, chunk, attn):
    jcfg, cfg, jparams, params = _pair(attn_chunk=chunk)
    batch = _batch(cfg, frames=frames)
    ref = jax_encdec.encode(jparams, jnp.asarray(batch["frames"]), jcfg)
    out = encdec.encode(params, torch.from_numpy(batch["frames"]), cfg,
                        attn=attn)
    _within(out, ref)


@pytest.mark.parametrize("attn", ATTN)
@pytest.mark.parametrize("frames,chunk", UNPADDED)
def test_decoder_forward_matches_reference(frames, chunk, attn):
    jcfg, cfg, jparams, params = _pair(attn_chunk=chunk)
    batch = _batch(cfg, s=8, frames=frames)
    enc = jax_encdec.encode(jparams, jnp.asarray(batch["frames"]), jcfg)
    ref_h, ref_caches = jax_encdec.decoder_forward(
        jparams, jnp.asarray(batch["tokens"]), enc, jcfg, want_cache=True,
        max_seq=12)
    h, caches = encdec.decoder_forward(
        params, torch.from_numpy(batch["tokens"]),
        torch.from_numpy(np.array(enc)), cfg, want_cache=True, max_seq=12,
        attn=attn)
    _within(h, ref_h)
    _caches_within(caches, ref_caches)
    h2, none = encdec.decoder_forward(
        params, torch.from_numpy(batch["tokens"]),
        torch.from_numpy(np.array(enc)), cfg, attn=attn)
    assert none is None and torch.equal(h2, h)


@pytest.mark.parametrize("attn", ATTN)
@pytest.mark.parametrize("frames,chunk", UNPADDED)
def test_prefill_and_decode_chain_match_reference(frames, chunk, attn):
    """Prefill's logits and every cache leaf, then 3 decode steps, each
    fed from its own side's caches."""
    jcfg, cfg, jparams, params = _pair(attn_chunk=chunk)
    japi, api = jax_build(jcfg), build(cfg)
    batch = _batch(cfg, s=8, frames=frames)
    ref_logits, ref_caches = japi.prefill(jparams, _jax(batch), max_seq=12)
    logits, caches = api.prefill(params, _port(batch), max_seq=12,
                                 attn=attn)
    _within(logits, ref_logits)
    _caches_within(caches, ref_caches)
    rng = np.random.default_rng(1)
    for pos in range(8, 11):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        ref_logits, ref_caches = japi.decode_step(
            jparams, ref_caches, jnp.asarray(tok),
            jnp.asarray(pos, jnp.int32))
        logits, caches = api.decode_step(params, caches,
                                         torch.from_numpy(tok), pos,
                                         attn=attn)
        _within(logits, ref_logits)
        _caches_within(caches, ref_caches)


@pytest.mark.parametrize("attn", ATTN)
def test_decode_from_init_cache_matches_reference(attn):
    """The server's path: decode steps from ``init_cache``, the cross
    K/V the ``ENC_FRAMES`` zero slots on both sides."""
    jcfg, cfg, jparams, params = _pair()
    japi, api = jax_build(jcfg), build(cfg)
    ref_caches = japi.init_cache(2, 12)
    caches = api.init_cache(2, 12, device="cpu")
    assert caches[0]["cross_k"].shape == (2, encdec.ENC_FRAMES, 2, 16)
    assert encdec.ENC_FRAMES == jax_encdec.ENC_FRAMES
    _caches_within(caches, ref_caches)
    rng = np.random.default_rng(2)
    for pos in range(3):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        ref_logits, ref_caches = japi.decode_step(
            jparams, ref_caches, jnp.asarray(tok),
            jnp.asarray(pos, jnp.int32))
        logits, caches = api.decode_step(params, caches,
                                         torch.from_numpy(tok), pos,
                                         attn=attn)
        _within(logits, ref_logits)
        _caches_within(caches, ref_caches)


def test_arch_smoke_decode_matches_prefill():
    """The reference's test on whisper: 8 frames, greedy decode of
    token t equals teacher-forced logits at t."""
    _, cfg, _, params = _pair()
    api = build(cfg)
    b, s = 2, 16
    batch = _port(_batch(cfg, b, s, frames=8))
    full, _ = api.prefill(params, batch, max_seq=s + 4)
    short = dict(batch, tokens=batch["tokens"][:, :s - 1])
    _, caches = api.prefill(params, short, max_seq=s + 4)
    dec, _ = api.decode_step(params, caches, batch["tokens"][:, s - 1:s],
                             s - 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_multi_token_decode_chain():
    """Decode 4 tokens sequentially == prefill of the longer sequence,
    against the same frames."""
    _, cfg, _, params = _pair()
    api = build(cfg)
    b, s, extra = 2, 8, 4
    batch = _port(_batch(cfg, b, s + extra, frames=37, seed=3))
    toks = batch["tokens"]
    _, caches = api.prefill(params, dict(batch, tokens=toks[:, :s]),
                            max_seq=s + extra)
    for i in range(extra):
        logits, caches = api.decode_step(params, caches,
                                         toks[:, s + i:s + i + 1], s + i)
    full, _ = api.prefill(params, batch, max_seq=s + extra + 1)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=3e-4,
                               atol=3e-4)


def test_cross_attention_over_zero_slots_adds_nothing():
    """From ``init_cache`` (what the server decodes from) every
    cross-attention's output is exactly 0: the logits equal those of the
    decoder with the cross-attention's ``wo`` zeroed."""
    _, cfg, _, params = _pair()
    api = build(cfg)
    tok = torch.tensor([[5], [9]])
    logits, _ = api.decode_step(params, api.init_cache(2, 4, device="cpu"),
                                tok, 0)
    cut = dict(params, dec_blocks=[
        dict(bp, cross_attn=dict(bp["cross_attn"],
                                 wo=torch.zeros_like(bp["cross_attn"]["wo"])))
        for bp in params["dec_blocks"]])
    zeroed, _ = api.decode_step(cut, api.init_cache(2, 4, device="cpu"),
                                tok, 0)
    assert torch.equal(logits, zeroed)


@pytest.mark.parametrize("half", [False, True])
def test_convert_round_trip_is_bit_exact(half):
    """Both block stacks, the embedding and both norms; the prefill's
    caches (cross K/V of the frames) and ``init_cache``'s, to the port
    and back bit for bit."""
    jcfg = jax_reduced(jax_get_config(ARCH))
    jparams = jax_build(jcfg).init(KEY)
    if half:
        jparams = dict(jparams, **{k: jax_cast(jparams[k], jnp.bfloat16)
                                   for k in ("enc_blocks", "dec_blocks")})
    tree = _numpy_tree(jparams)
    params = lm_params_from_numpy(tree, device="cpu")
    assert len(params["enc_blocks"]) == jcfg.enc_layers
    assert len(params["dec_blocks"]) == jcfg.n_layers
    assert params["dec_blocks"][0]["cross_attn"]["wk"].dtype == (
        torch.bfloat16 if half else torch.float32)
    assert params["dec_blocks"][0]["lnx"].dtype == torch.float32
    _assert_same_tree(tree, lm_params_to_numpy(params))
    jcfg_c = dataclasses.replace(
        jcfg, compute_dtype=jnp.bfloat16 if half else jnp.float32)
    batch = _batch(reduced(get_config(ARCH)), frames=37)
    _, prefilled = jax_build(jcfg_c).prefill(jparams, _jax(batch),
                                             max_seq=12)
    for jcaches in (prefilled, jax_build(jcfg_c).init_cache(2, 8)):
        ctree = _numpy_tree(jax.tree_util.tree_map(lambda a: a + 1,
                                                   jcaches))
        caches = lm_cache_from_numpy(ctree, device="cpu")
        assert len(caches) == jcfg.n_layers
        assert isinstance(caches[0]["self"]["pos"], np.ndarray)
        assert isinstance(caches[0]["cross_k"], torch.Tensor)
        _assert_same_tree(ctree, lm_cache_to_numpy(caches))


def _assert_same_tree(tree, back):
    flat, treedef = jax.tree_util.tree_flatten(tree)
    flat_back, treedef_back = jax.tree_util.tree_flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _leaf_shapes(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for n, sub in tree.items()
                for k, v in _leaf_shapes(sub, prefix + (n,)).items()}
    return {prefix: tuple(tree.shape)}


def test_full_size_init_matches_reference_shapes():
    """whisper-medium's init on ``meta`` against the reference's
    (``jax.eval_shape``), layer for layer; the sum is ``param_count()``
    plus ``enc_ln`` and the vocab's padding."""
    cfg = get_config(ARCH)
    params = encdec.init_params(cfg, None)
    ref = jax.eval_shape(jax_build(jax_get_config(ARCH)).init, KEY)
    for name, n in (("enc_blocks", cfg.enc_layers),
                    ("dec_blocks", cfg.n_layers)):
        assert len(params[name]) == n
        want = _leaf_shapes(ref[name])
        for block in params[name]:
            got = _leaf_shapes(block)
            assert got.keys() == want.keys()
            for k, shape in got.items():
                assert (n,) + shape == want[k], (name, k)
    for name in ("embed", "enc_ln", "final_ln"):
        assert tuple(params[name].shape) == tuple(ref[name].shape)
    leaves = [t for v in params.values()
              for t in (v if isinstance(v, list) else [v])]
    tensors = [t for x in leaves for t in _tensors(x)]
    assert all(t.device.type == "meta" for t in tensors)
    d = cfg.d_model
    assert sum(t.numel() for t in tensors) == (
        cfg.param_count() + d + (cfg.padded_vocab(1) - cfg.vocab) * d)


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


def test_cast_blocks_keeps_matmul_weights_in_the_compute_type():
    cfg = dataclasses.replace(reduced(get_config(ARCH)),
                              compute_dtype=torch.bfloat16)
    master = encdec.init_params(cfg, torch.Generator().manual_seed(5))
    cast = encdec.init_params(cfg, torch.Generator().manual_seed(5),
                              cast_blocks=True)
    for name in ("enc_blocks", "dec_blocks"):
        for a, b in zip(master[name], cast[name]):
            for t, u in zip(_tensors(a), _tensors(b)):
                want = t.to(torch.bfloat16) if t.dim() >= 2 else t
                assert u.dtype == want.dtype and torch.equal(u, want)
    assert cast["dec_blocks"][0]["cross_attn"]["wq"].dtype == torch.bfloat16
    assert cast["dec_blocks"][0]["lnx"].dtype == torch.float32
    assert torch.equal(cast["embed"], master["embed"])


# --------------------------------------------------------------------------
# the departure: the reference's pad keys
# --------------------------------------------------------------------------

T_REAL = encdec.ENC_FRAMES


@pytest.mark.parametrize("attn", ATTN)
def test_noncausal_sublayer_attends_over_the_real_keys_only(attn):
    """At T = 1500, chunk 32 (46 full chunks and 28 keys, so 4 zero pad
    keys in the reference's last chunk): the port's non-causal
    ``attention_block`` against the reference's exact ``impl="naive"``
    one within 1e-5 of max; the reference's own chunked call is more
    than 100x that away (its pad keys join the softmax)."""
    jcfg, cfg, jparams, params = _pair()
    nh, nkv = cfg.padded_heads(1)
    bp = params["enc_blocks"][0]["attn"]
    jbp = jax.tree_util.tree_map(lambda a: a[0],
                                 jparams["enc_blocks"])["attn"]
    h = (np.random.default_rng(4).standard_normal((1, T_REAL, cfg.d_model))
         ).astype(np.float32)
    pos = np.arange(T_REAL, dtype=np.int32)
    exact, _ = jax_attn.attention_block(jbp, jnp.asarray(h),
                                        jnp.asarray(pos), jcfg, nh, nkv,
                                        causal=False, impl="naive")
    padded, _ = jax_attn.attention_block(jbp, jnp.asarray(h),
                                         jnp.asarray(pos), jcfg, nh, nkv,
                                         causal=False)
    out, _ = attn_mod.attention_block(bp, torch.from_numpy(h),
                                      torch.from_numpy(pos), cfg, nh, nkv,
                                      causal=False, attn=attn)
    _within(out, exact)
    assert _err(padded, exact) > 100 * REL


def _real_frames(cfg, b=1, s=8, seed=5):
    return _batch(cfg, b, s, frames=T_REAL, seed=seed)


def test_encode_and_prefill_at_1500_frames_equal_the_unpadded_reference():
    """The port at chunk 32 against the reference at ``attn_chunk``
    1500 (one chunk, no padding) within 1e-5 of max: ``encode``, the
    prefill's logits and its cross caches; the reference at its own
    chunk 32 is more than 1e-4 of max away from its unpadded run."""
    jcfg, cfg, jparams, params = _pair()
    jexact = dataclasses.replace(jcfg, attn_chunk=T_REAL)
    batch = _real_frames(cfg)
    frames = jnp.asarray(batch["frames"])
    exact_enc = jax_encdec.encode(jparams, frames, jexact)
    padded_enc = jax_encdec.encode(jparams, frames, jcfg)
    for attn in ATTN:
        out = encdec.encode(params, torch.from_numpy(batch["frames"]), cfg,
                            attn=attn)
        _within(out, exact_enc)
    assert _err(padded_enc, exact_enc) > 1e-4
    exact_logits, exact_caches = jax_build(jexact).prefill(
        jparams, _jax(batch), max_seq=12)
    padded_logits, _ = jax_build(jcfg).prefill(jparams, _jax(batch),
                                               max_seq=12)
    logits, caches = build(cfg).prefill(params, _port(batch), max_seq=12)
    _within(logits, exact_logits)
    _caches_within(caches, exact_caches)
    assert _err(padded_logits, exact_logits) > 1e-4


def test_noncausal_attention_under_a_window_raises():
    """The reference's non-causal result under a window depends on its
    chunk padding; the port refuses it, in both attentions."""
    _, cfg, _, params = _pair(window=8)
    nh, nkv = cfg.padded_heads(1)
    bp = params["enc_blocks"][0]["attn"]
    h = torch.zeros((1, 16, cfg.d_model))
    pos = torch.arange(16, dtype=torch.int32)
    for attn in ATTN:
        with pytest.raises(ValueError, match="window"):
            attn_mod.attention_block(bp, h, pos, cfg, nh, nkv, causal=False,
                                     attn=attn)
        with pytest.raises(ValueError, match="window"):
            encdec.encode(params, h, cfg, attn=attn)
    # causal under the same window stays as it was
    attn_mod.attention_block(bp, h, pos, cfg, nh, nkv)


def test_train_loss_raises_until_the_training_slice():
    """The training slice has landed: ``train_loss`` gives a finite loss
    and, as ``prefill``, refuses an unknown ``attn``."""
    api = build(reduced(get_config(ARCH)))
    params = api.init(torch.Generator().manual_seed(0))
    batch = _port(_batch(api.cfg, 1, 4, frames=8))
    batch["labels"] = batch["tokens"]
    assert torch.isfinite(api.train_loss(params, batch))
    with pytest.raises(ValueError, match="attn"):
        api.train_loss(params, batch, attn="fast")
    with pytest.raises(ValueError, match="attn"):
        api.prefill(api.init(torch.Generator().manual_seed(0)),
                    _port(_batch(api.cfg, 1, 4, frames=8)), attn="fast")
