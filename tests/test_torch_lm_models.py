"""The port's dense decoders on the CPU against the reference's, on the
same weights: the reference's ``build(cfg).init`` drawn with a JAX key,
handed over as numpy leaves through ``repro_torch.convert``.

For the five archs whose blocks are attention + dense FFN
(phi3-medium-14b, granite-34b (MQA), deepseek-7b, minitron-4b,
llava-next-34b with its ``vision_stub`` prefix) at ``reduced()``, f32:
``prefill``'s logits and caches and ``decode_step``'s logits within
1e-5 of max |ref| (the two sum in other orders; attention on the port's
side is K4's plain version), also across a ring wrap; the reference's
``test_arch_smoke_decode_matches_prefill`` (rtol/atol 2e-4),
``test_multi_token_decode_chain`` (3e-4, on phi3) and
``test_sliding_window_masks_old_tokens`` (1e-4, phi3 with window 8)
mirrored on the port; one bf16-compute case within 2e-2 of max |ref|
(both sides round every matmul to bf16, in other orders).
``param_count`` and ``padded_heads`` equal the reference's for all ten
archs, and the port's init shapes at full size sum to ``param_count()``.
LM params and caches go to the port and back bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models.api import build as jax_build
from repro.models.layers import cast_params_for_compute as jax_cast
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.convert import (lm_cache_from_numpy, lm_cache_to_numpy,
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.models import transformer as T
from repro_torch.models.api import build
from repro_torch.models.layers import cast_params_for_compute

KEY = jax.random.PRNGKey(0)
DENSE = ["phi3-medium-14b", "granite-34b", "deepseek-7b", "minitron-4b",
         "llava-next-34b"]


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, **overrides):
    """(reference cfg, port cfg, reference params, port params)."""
    jo = {k: (getattr(jnp, str(v).removeprefix("torch."))
              if isinstance(v, torch.dtype) else v)
          for k, v in overrides.items()}
    jcfg = jax_reduced(jax_get_config(arch), **jo)
    cfg = reduced(get_config(arch), **overrides)
    jparams = jax_build(jcfg).init(KEY)
    return jcfg, cfg, jparams, lm_params_from_numpy(_numpy_tree(jparams),
                                                    device="cpu")


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        batch["prefix_embeds"] = (rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _within(out, ref, rel):
    out = np.asarray(out.float() if isinstance(out, torch.Tensor) else out,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _caches_within(port_caches, ref_caches, rel):
    port = lm_cache_to_numpy(port_caches)
    ref = _numpy_tree(ref_caches)
    for sub in ref:
        np.testing.assert_array_equal(port[sub]["pos"], ref[sub]["pos"])
        for n in ("k", "v"):
            _within(port[sub][n].astype(np.float32),
                    ref[sub][n].astype(np.float32), rel)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch):
    jcfg, cfg, jparams, params = _pair(arch)
    b, s = 2, 16
    batch = _batch(cfg, b, s)
    ref_logits, ref_caches = jax_build(jcfg).prefill(
        jparams, _jax_batch(batch), max_seq=s + 4)
    api = build(cfg)
    logits, caches = api.prefill(params, _port_batch(batch), max_seq=s + 4)
    _within(logits, ref_logits, 1e-5)
    _caches_within(caches, ref_caches, 1e-5)
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (b, 1)).astype(
        np.int32)
    ref_dec, ref_caches = jax_build(jcfg).decode_step(
        jparams, ref_caches, jnp.asarray(tok), jnp.asarray(s, jnp.int32))
    dec, caches = api.decode_step(params, caches, torch.from_numpy(tok), s)
    _within(dec, ref_dec, 1e-5)
    _caches_within(caches, ref_caches, 1e-5)


def test_decode_across_a_ring_wrap_matches_reference():
    """phi3 with window 8: a 13-token prefill fills the 8-slot ring past
    its end, then 6 decode steps wrap it again; every step's logits and
    cache against the reference's, fed from its own cache each time."""
    jcfg, cfg, jparams, params = _pair("phi3-medium-14b", window=8)
    batch = _batch(cfg, 2, 13)
    japi, api = jax_build(jcfg), build(cfg)
    ref_logits, ref_caches = japi.prefill(jparams, _jax_batch(batch),
                                          max_seq=32)
    logits, caches = api.prefill(params, _port_batch(batch), max_seq=32)
    _within(logits, ref_logits, 1e-5)
    _caches_within(caches, ref_caches, 1e-5)
    rng = np.random.default_rng(2)
    for pos in range(13, 19):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        ref_logits, ref_caches = japi.decode_step(
            jparams, ref_caches, jnp.asarray(tok),
            jnp.asarray(pos, jnp.int32))
        logits, caches = api.decode_step(params, caches,
                                         torch.from_numpy(tok), pos)
        _within(logits, ref_logits, 1e-5)
        _caches_within(caches, ref_caches, 1e-5)


@pytest.mark.parametrize("arch", DENSE)
def test_arch_smoke_decode_matches_prefill(arch):
    """Greedy decode of token t equals teacher-forced logits at t."""
    _, cfg, _, params = _pair(arch)
    api = build(cfg)
    b, s = 2, 16
    batch = _port_batch(_batch(cfg, b, s))
    full, _ = api.prefill(params, batch, max_seq=s + 4)
    short = dict(batch)
    short["tokens"] = batch["tokens"][:, :s - 1]
    _, caches = api.prefill(params, short, max_seq=s + 4)
    dec, _ = api.decode_step(params, caches, batch["tokens"][:, s - 1:s],
                             s - 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_multi_token_decode_chain():
    """Decode 4 tokens sequentially == prefill of the longer sequence."""
    _, cfg, _, params = _pair("phi3-medium-14b")
    api = build(cfg)
    b, s, extra = 2, 8, 4
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, s + extra)).astype(np.int32))
    _, caches = api.prefill(params, {"tokens": toks[:, :s]},
                            max_seq=s + extra)
    outs = []
    for i in range(extra):
        logits, caches = api.decode_step(params, caches,
                                         toks[:, s + i:s + i + 1], s + i)
        outs.append(logits)
    full, _ = api.prefill(params, {"tokens": toks}, max_seq=s + extra + 1)
    np.testing.assert_allclose(outs[-1].numpy(), full.numpy(), rtol=3e-4,
                               atol=3e-4)


def test_sliding_window_masks_old_tokens():
    """SWA: logits must be independent of tokens beyond the window (one
    layer: the receptive field grows by ``window`` a layer)."""
    _, cfg, _, params = _pair("phi3-medium-14b", window=8, n_layers=1)
    api = build(cfg)
    b, s = 1, 24
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (b, s)).astype(np.int32))
    toks2 = toks.clone()
    toks2[:, :s - 9] = (toks[:, :s - 9] + 7) % cfg.vocab
    l1, _ = api.prefill(params, {"tokens": toks}, max_seq=s)
    l2, _ = api.prefill(params, {"tokens": toks2}, max_seq=s)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-4, atol=1e-4)
    # and a token inside the window does move them
    toks3 = toks.clone()
    toks3[:, s - 2] = (toks[:, s - 2] + 7) % cfg.vocab
    l3, _ = api.prefill(params, {"tokens": toks3}, max_seq=s)
    assert np.abs(l3.numpy() - l1.numpy()).max() > 1e-3


def test_bf16_compute_matches_reference():
    jcfg, cfg, jparams, params = _pair("phi3-medium-14b",
                                       compute_dtype=torch.bfloat16)
    b, s = 2, 16
    batch = _batch(cfg, b, s)
    ref_logits, ref_caches = jax_build(jcfg).prefill(
        jparams, _jax_batch(batch), max_seq=s + 4)
    api = build(cfg)
    logits, caches = api.prefill(params, _port_batch(batch), max_seq=s + 4)
    assert caches[0]["sub0"]["k"].dtype == torch.bfloat16
    _within(logits, ref_logits, 2e-2)
    tok = np.full((b, 1), 7, np.int32)
    ref_dec, _ = jax_build(jcfg).decode_step(
        jparams, ref_caches, jnp.asarray(tok), jnp.asarray(s, jnp.int32))
    dec, _ = api.decode_step(params, caches, torch.from_numpy(tok), s)
    _within(dec, ref_dec, 2e-2)


def test_vlm_prefix_changes_output():
    _, cfg, _, params = _pair("llava-next-34b")
    api = build(cfg)
    batch = _port_batch(_batch(cfg))
    l1, _ = api.prefill(params, batch)
    batch2 = dict(batch)
    batch2["prefix_embeds"] = batch["prefix_embeds"] + 1.0
    l2, _ = api.prefill(params, batch2)
    assert np.abs(l1.numpy() - l2.numpy()).max() > 1e-6


def test_configs_match_reference():
    assert ARCHS == JAX_ARCHS
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for f in dataclasses.fields(cfg):
            a, b = getattr(cfg, f.name), getattr(jcfg, f.name)
            if isinstance(a, torch.dtype):
                assert str(a).removeprefix("torch.") == jnp.dtype(b).name
            elif a is None:
                assert b is None
            else:
                assert a == b, (arch, f.name)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.sub_quadratic == jcfg.sub_quadratic
        for tp in (1, 2, 4, 8, 16, 64):
            assert cfg.padded_heads(tp) == jcfg.padded_heads(tp), (arch, tp)
            assert cfg.padded_vocab(tp) == jcfg.padded_vocab(tp)
        r, jr = reduced(cfg), jax_reduced(jcfg)
        assert (r.n_layers, r.d_model, r.n_heads, r.n_kv_heads, r.window,
                r.frontend_len, r.param_count()) == (
            jr.n_layers, jr.d_model, jr.n_heads, jr.n_kv_heads, jr.window,
            jr.frontend_len, jr.param_count())


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "granite-34b",
                                  "deepseek-7b"])
def test_full_size_init_shapes_sum_to_param_count(arch):
    cfg = get_config(arch)
    params = T.init_params(cfg, None)     # shapes only, on "meta"
    leaves = [params["embed"], params["final_ln"]] + [
        t for block in params["blocks"] for sub in block.values()
        for x in sub.values()
        for t in (x.values() if isinstance(x, dict) else [x])]
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == cfg.param_count()
    assert len(params["blocks"]) == cfg.n_layers


def test_cast_blocks_init_equals_the_per_step_cast():
    cfg = dataclasses.replace(reduced(get_config("phi3-medium-14b")),
                              compute_dtype=torch.bfloat16)
    master = T.init_params(cfg, torch.Generator().manual_seed(5))
    cast = T.init_params(cfg, torch.Generator().manual_seed(5),
                         cast_blocks=True)
    for a, b in zip(master["blocks"], cast["blocks"]):
        want = cast_params_for_compute(a, torch.bfloat16)
        for sub in want:
            for n, x in want[sub].items():
                for name, t in (x.items() if isinstance(x, dict)
                                else [(n, x)]):
                    got = b[sub][n][name] if isinstance(x, dict) \
                        else b[sub][n]
                    assert got.dtype == t.dtype and torch.equal(got, t)
    assert cast["blocks"][0]["sub0"]["attn"]["wq"].dtype == torch.bfloat16
    assert cast["blocks"][0]["sub0"]["ln1"].dtype == torch.float32
    assert cast["embed"].dtype == torch.float32
    assert torch.equal(cast["embed"], master["embed"])


@pytest.mark.parametrize("half", [False, True])
def test_convert_round_trip_is_bit_exact(half):
    jcfg = jax_reduced(jax_get_config("phi3-medium-14b"))
    jparams = jax_build(jcfg).init(KEY)
    if half:   # bf16 leaves: the blocks as the compute cast makes them
        jparams = dict(jparams, blocks=jax_cast(jparams["blocks"],
                                                jnp.bfloat16))
    tree = _numpy_tree(jparams)
    params = lm_params_from_numpy(tree, device="cpu")
    assert len(params["blocks"]) == jcfg.n_layers
    if half:
        assert params["blocks"][0]["sub0"]["ffn"]["wg"].dtype \
            == torch.bfloat16
    back = lm_params_to_numpy(params)
    flat, treedef = jax.tree_util.tree_flatten(tree)
    flat_back, treedef_back = jax.tree_util.tree_flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    # caches too
    jcaches = jax_build(jcfg).init_cache(2, 8)
    jcaches = jax.tree_util.tree_map(lambda a: a + 1, jcaches)
    ctree = _numpy_tree(jcaches)
    caches = lm_cache_from_numpy(ctree, device="cpu")
    assert isinstance(caches[0]["sub0"]["pos"], np.ndarray)
    cback = lm_cache_to_numpy(caches)
    for a, b in zip(jax.tree_util.tree_leaves(ctree),
                    jax.tree_util.tree_leaves(cback)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_what_is_not_ported_raises():
    with pytest.raises(NotImplementedError, match="tp"):
        build(reduced(get_config("phi3-medium-14b")), tp=2)
    for arch, what in (("whisper-medium", "encoder-decoder"),
                       ("mixtral-8x7b", "MoE"), ("dbrx-132b", "MoE"),
                       ("mamba2-1.3b", "mamba"),
                       ("jamba-1.5-large-398b", "mamba")):
        with pytest.raises(NotImplementedError, match=what):
            build(reduced(get_config(arch)))
    api = build(reduced(get_config("phi3-medium-14b")))
    with pytest.raises(NotImplementedError, match="train_loss"):
        api.train_loss({}, {})
    with pytest.raises(ValueError, match="attn"):
        api.prefill(api.init(torch.Generator().manual_seed(0)),
                    {"tokens": torch.zeros((1, 4), dtype=torch.int64)},
                    attn="fast")
