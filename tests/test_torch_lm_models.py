"""The port's decoders on the CPU against the reference's, on the same
weights: the reference's ``build(cfg).init`` drawn with a JAX key,
handed over as numpy leaves through ``repro_torch.convert``.

For the nine decoder-only archs at ``reduced()``, f32 — dense
(phi3-medium-14b, granite-34b (MQA), deepseek-7b, minitron-4b), the VLM
(llava-next-34b with its ``vision_stub`` prefix), MoE (mixtral-8x7b,
dbrx-132b: the dense MoE mode), SSM (mamba2-1.3b) and the hybrid
(jamba-1.5-large-398b: attention, Mamba and MoE sublayers):
``prefill``'s logits and caches and ``decode_step``'s logits and caches
within 1e-5 of max |ref| (the two sum in other orders; attention on the
port's side is K4's plain version), also across a ring wrap; the
reference's ``test_arch_smoke_decode_matches_prefill`` (rtol/atol
2e-4, ``capacity_factor = n_experts`` where there are experts, as
there), ``test_multi_token_decode_chain`` (3e-4; phi3, and mixtral,
mamba2 and jamba as the reference runs it) and
``test_sliding_window_masks_old_tokens`` (1e-4; phi3, and mixtral as
the reference runs it, window 8) mirrored on the port; one bf16-compute
case within 2e-2 of max |ref| (both sides round every matmul to bf16,
in other orders).  ``param_count`` and ``padded_heads`` equal the
reference's for all ten archs; the port's init shapes at full size
equal the reference's leaf for leaf and sum to ``param_count()`` (for
a Mamba mixer plus what the analytic count leaves out).  LM params and
caches (KV, SSM state and conv tail) go to the port and back bit for
bit.
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
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as T
from repro_torch.models.api import build
from repro_torch.models.layers import cast_params_for_compute

KEY = jax.random.PRNGKey(0)
DENSE = ["phi3-medium-14b", "granite-34b", "deepseek-7b", "minitron-4b",
         "llava-next-34b"]
#: the decoder-only archs beyond the dense ones: MoE, SSM, hybrid
MOE_SSM = ["mixtral-8x7b", "dbrx-132b", "mamba2-1.3b",
           "jamba-1.5-large-398b"]
DECODERS = DENSE + MOE_SSM


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
    assert port.keys() == ref.keys()
    for sub in ref:
        assert port[sub].keys() == ref[sub].keys()
        if "pos" in ref[sub]:
            np.testing.assert_array_equal(port[sub]["pos"], ref[sub]["pos"])
        for n in ref[sub].keys() - {"pos"}:
            assert port[sub][n].dtype == ref[sub][n].dtype, (sub, n)
            _within(port[sub][n].astype(np.float32),
                    ref[sub][n].astype(np.float32), rel)


def _for_parity(cfg):
    """The reference's decode tests' config: no token dropped."""
    if cfg.n_experts:
        return dataclasses.replace(cfg, capacity_factor=float(
            cfg.n_experts))
    return cfg


@pytest.mark.parametrize("arch", DECODERS)
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


@pytest.mark.parametrize("arch", DECODERS)
def test_arch_smoke_decode_matches_prefill(arch):
    """Greedy decode of token t equals teacher-forced logits at t."""
    _, cfg, _, params = _pair(arch)
    api = build(_for_parity(cfg))
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


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-1.3b",
                                  "jamba-1.5-large-398b"])
def test_multi_token_decode_chain_moe_ssm_hybrid(arch):
    """The reference's chain over its MoE, SSM and hybrid archs: 4
    tokens decoded one by one == prefill of the longer sequence."""
    _, cfg, _, params = _pair(arch)
    api = build(_for_parity(cfg))
    b, s, extra = 2, 8, 4
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, s + extra)).astype(np.int32))
    _, caches = api.prefill(params, {"tokens": toks[:, :s]},
                            max_seq=s + extra)
    for i in range(extra):
        logits, caches = api.decode_step(params, caches,
                                         toks[:, s + i:s + i + 1], s + i)
    full, _ = api.prefill(params, {"tokens": toks}, max_seq=s + extra + 1)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=3e-4,
                               atol=3e-4)


def test_decode_chain_matches_reference_with_drops(monkeypatch):
    """mixtral at capacity factor 0.5: a decode step's 2 tokens route 4
    pairs into 4 experts' bins of 1 row, the prefill's 12 tokens 24
    pairs into bins of 3, so pairs drop; the prefill's and every decode
    step's logits and caches against the reference's."""
    jcfg, cfg, jparams, params = _pair("mixtral-8x7b", capacity_factor=0.5)
    dropped = []
    dispatch = moe_mod.moe_dispatch_local

    def counting(x, gates, idx, n_experts, capacity):
        bins, slot = dispatch(x, gates, idx, n_experts, capacity)
        dropped.append(int((slot == n_experts * capacity).sum()))
        return bins, slot
    monkeypatch.setattr(moe_mod, "moe_dispatch_local", counting)
    batch = _batch(cfg, 2, 6)
    japi, api = jax_build(jcfg), build(cfg)
    ref_logits, ref_caches = japi.prefill(jparams, _jax_batch(batch),
                                          max_seq=16)
    logits, caches = api.prefill(params, _port_batch(batch), max_seq=16)
    _within(logits, ref_logits, 1e-5)
    _caches_within(caches, ref_caches, 1e-5)
    rng = np.random.default_rng(5)
    for pos in range(6, 12):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        ref_logits, ref_caches = japi.decode_step(
            jparams, ref_caches, jnp.asarray(tok),
            jnp.asarray(pos, jnp.int32))
        logits, caches = api.decode_step(params, caches,
                                         torch.from_numpy(tok), pos)
        _within(logits, ref_logits, 1e-5)
        _caches_within(caches, ref_caches, 1e-5)
    assert len(dropped) == 7 * cfg.n_layers and sum(dropped) > 0


def test_sliding_window_masks_old_tokens_mixtral():
    """The reference's own window test, on mixtral (window 8, one layer,
    capacity factor 8)."""
    _, cfg, _, params = _pair("mixtral-8x7b", window=8, n_layers=1,
                              capacity_factor=8.0)
    api = build(cfg)
    b, s = 1, 24
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (b, s)).astype(np.int32))
    toks2 = toks.clone()
    toks2[:, :s - 9] = (toks[:, :s - 9] + 7) % cfg.vocab
    l1, _ = api.prefill(params, {"tokens": toks}, max_seq=s)
    l2, _ = api.prefill(params, {"tokens": toks2}, max_seq=s)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-4, atol=1e-4)
    toks3 = toks.clone()
    toks3[:, s - 2] = (toks[:, s - 2] + 7) % cfg.vocab
    l3, _ = api.prefill(params, {"tokens": toks3}, max_seq=s)
    assert np.abs(l3.numpy() - l1.numpy()).max() > 1e-3


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


def test_vlm_prefix_prefill_then_decode_chain_matches_reference():
    """llava's vision path as the chip smoke drives it at full size: a
    prefill whose first ``frontend_len`` (8) positions are prefix
    embeddings, then 4 ``decode_step``s from its caches, each step's
    logits over the real vocabulary within 1e-5 of max |ref| of the
    reference's ``prefill``/``decode_step`` on the same weights and
    inputs, the caches after the chain likewise.  The control: the
    port's prefill with the prefix left out misses the gate."""
    jcfg, cfg, jparams, params = _pair("llava-next-34b")
    b, s, extra = 2, 16, 4
    batch = _batch(cfg, b, s)
    japi, api = jax_build(jcfg), build(cfg)
    ref, ref_caches = japi.prefill(jparams, _jax_batch(batch),
                                   max_seq=s + extra)
    logits, caches = api.prefill(params, _port_batch(batch),
                                 max_seq=s + extra)
    _within(logits[..., :cfg.vocab], np.asarray(ref)[..., :cfg.vocab], 1e-5)
    bare, _ = api.prefill(params, {"tokens": _port_batch(batch)["tokens"]},
                          max_seq=s + extra)
    real = np.asarray(ref)[..., :cfg.vocab]
    assert np.abs(bare.numpy()[..., :cfg.vocab] - real).max() \
        > 1e-5 * np.abs(real).max()
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (extra, b, 1)
                                             ).astype(np.int32)
    for i, tok in enumerate(toks):
        ref, ref_caches = japi.decode_step(jparams, ref_caches,
                                           jnp.asarray(tok),
                                           jnp.asarray(s + i, jnp.int32))
        logits, caches = api.decode_step(params, caches,
                                         torch.from_numpy(tok), s + i)
        _within(logits[..., :cfg.vocab], np.asarray(ref)[..., :cfg.vocab],
                1e-5)
    _caches_within(caches, ref_caches, 1e-5)


@pytest.mark.parametrize("entry", ["train_loss", "prefill"])
def test_prefix_longer_than_the_sequence_is_refused(entry):
    """llava at ``reduced()`` (8 prefix rows) over 6 tokens: the
    reference's ``dynamic_update_slice`` refuses the prefix, and so does
    the port, in ``train_loss`` and in ``prefill``; a prefix of exactly
    the sequence's 6 rows both take, within 1e-5 of max |ref|."""
    jcfg, cfg, jparams, params = _pair("llava-next-34b")
    japi, api = jax_build(jcfg), build(cfg)
    rng = np.random.default_rng(9)
    b, s = 2, 6
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "prefix_embeds": (rng.standard_normal(
                 (b, cfg.frontend_len, cfg.d_model)) * 0.02
             ).astype(np.float32)}
    assert cfg.frontend_len > s

    def run(fn, bt):
        if entry == "train_loss":
            return fn.train_loss(params if fn is api else jparams, bt)
        return fn.prefill(params if fn is api else jparams, bt,
                          max_seq=s)[0]
    with pytest.raises(TypeError, match="update shape"):
        run(japi, _jax_batch(batch))
    with pytest.raises(ValueError, match="does not fit"):
        run(api, _port_batch(batch))
    batch["prefix_embeds"] = batch["prefix_embeds"][:, :s]
    ref = run(japi, _jax_batch(batch))
    got = run(api, _port_batch(batch))
    _within(got.detach(), np.asarray(ref), 1e-5)


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


def _leaf_shapes(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for n, sub in tree.items()
                for k, v in _leaf_shapes(sub, prefix + (n,)).items()}
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("arch", MOE_SSM)
def test_full_size_init_matches_reference_shapes(arch):
    """The port's full-size init on ``meta`` against the reference's
    (``jax.eval_shape``, nothing drawn) leaf for leaf, its blocks one
    slice each of the reference's stacked leaves; the sum is
    ``param_count()``, plus for each Mamba mixer what the analytic
    count leaves out (the dt columns of ``in_proj``, the B/C taps of
    ``conv_w``, ``D`` and ``dt_bias``), less the second norm an
    FFN-less (SSM) layer lacks, plus the vocab's padding."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    params = T.init_params(cfg, None)
    ref = jax.eval_shape(jax_build(jcfg).init, KEY)
    blocks = ref["blocks"]
    assert len(params["blocks"]) == T.n_blocks(cfg)
    want = _leaf_shapes(blocks)
    for block in params["blocks"]:
        got = _leaf_shapes(block)
        assert got.keys() == want.keys()
        for k, shape in got.items():
            assert (T.n_blocks(cfg),) + shape == want[k], k
    assert tuple(params["embed"].shape) == tuple(ref["embed"].shape)
    leaves = [t for block in params["blocks"] for t in
              _tensors(block)] + [params["embed"], params["final_ln"]]
    assert all(t.device.type == "meta" for t in leaves)
    d, h = cfg.d_model, cfg.ssm_heads
    n_mamba = sum(mixer == "mamba" for mixer, _ in T.block_spec(cfg)) \
        * T.n_blocks(cfg)
    extra = n_mamba * (d * h + 2 * cfg.ssm_state * cfg.ssm_conv + 2 * h)
    if cfg.family == "ssm":
        extra -= cfg.n_layers * d
    extra += (cfg.padded_vocab(1) - cfg.vocab) * d
    assert sum(t.numel() for t in leaves) == cfg.param_count() + extra
    if cfg.family == "moe":
        assert extra == 0


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


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


@pytest.mark.parametrize("arch", MOE_SSM)
@pytest.mark.parametrize("half", [False, True])
def test_convert_round_trip_moe_ssm_is_bit_exact(arch, half):
    """MoE (router, wg/wi/wo) and Mamba (in_proj, conv_w, A_log, D,
    dt_bias, norm_w, out_proj) params, and the SSM state and conv-tail
    caches beside the KV ones, to the port and back bit for bit."""
    jcfg = jax_reduced(jax_get_config(arch))
    jparams = jax_build(jcfg).init(KEY)
    if half:
        jparams = dict(jparams, blocks=jax_cast(jparams["blocks"],
                                                jnp.bfloat16))
    tree = _numpy_tree(jparams)
    params = lm_params_from_numpy(tree, device="cpu")
    subs = params["blocks"][0].values()
    for sub in subs:
        if "moe" in sub:
            assert sub["moe"]["router"].dtype == torch.float32
            assert sub["moe"]["wg"].dtype == (torch.bfloat16 if half
                                              else torch.float32)
        if "mamba" in sub:
            assert sub["mamba"]["A_log"].dtype == torch.float32
    assert any("moe" in sub for sub in subs) == bool(jcfg.n_experts)
    assert any("mamba" in sub for sub in subs) == bool(jcfg.ssm_state)
    back = lm_params_to_numpy(params)
    flat, treedef = jax.tree_util.tree_flatten(tree)
    flat_back, treedef_back = jax.tree_util.tree_flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    jcaches = jax_build(dataclasses.replace(
        jcfg, compute_dtype=jnp.bfloat16 if half else jnp.float32)
    ).init_cache(2, 8)
    jcaches = jax.tree_util.tree_map(lambda a: a + 1, jcaches)
    ctree = _numpy_tree(jcaches)
    caches = lm_cache_from_numpy(ctree, device="cpu")
    kinds = {n for block in caches for c in block.values() for n in c}
    assert ({"ssm", "conv"} <= kinds) == bool(jcfg.ssm_state)
    for block in caches:
        for c in block.values():
            for n, x in c.items():
                assert isinstance(x, np.ndarray) == (n == "pos")
    cback = lm_cache_to_numpy(caches)
    flat, treedef = jax.tree_util.tree_flatten(ctree)
    flat_back, treedef_back = jax.tree_util.tree_flatten(cback)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_ssm_cache_leaf_of_one_dim_is_not_pos():
    """``pos`` is told by its name: a one-long SSM leaf (a 1-block
    cache's stacked state sliced to one dim) stays a tensor."""
    tree = {"sub0": {"ssm": np.ones((2, 3), np.float32),
                     "conv": np.ones((2, 3), np.float32)}}
    caches = lm_cache_from_numpy(tree, device="cpu")
    assert all(isinstance(x, torch.Tensor) for b in caches
               for c in b.values() for x in c.values())


class _StandInMesh:
    """What the models read of a mesh before any collective runs."""
    shape = {"data": 1, "model": 3}
    axis_names = ("data", "model")
    size = 3


def test_heads_off_the_model_axis_and_unknown_attn_raise():
    """A Mamba mixer on a mesh whose model axis does not split its SSD
    heads (8 over 3), serving or training, raises ``ValueError`` naming
    both numbers (on an axis that splits them it runs:
    ``tests/test_torch_parallel_ssm.py``); so does an unknown ``attn``."""
    from repro_torch.parallel.axes import axis_rules
    for arch in ("mamba2-1.3b", "jamba-1.5-large-398b"):
        api = build(reduced(get_config(arch)), tp=3)
        with axis_rules({"batch": None}, _StandInMesh()):
            with pytest.raises(ValueError, match="8 SSD heads .* of 3"):
                api.init_cache(2, 9, device="cpu")
            with pytest.raises(ValueError, match="8 SSD heads .* of 3"):
                api.train_loss({}, {"tokens": torch.zeros((1, 3)),
                                    "labels": None})
    api = build(reduced(get_config("phi3-medium-14b")))
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="attn"):
        api.train_loss(api.init(torch.Generator().manual_seed(0)),
                       {"tokens": tokens, "labels": tokens}, attn="fast")
    with pytest.raises(ValueError, match="attn"):
        api.prefill(api.init(torch.Generator().manual_seed(0)),
                    {"tokens": torch.zeros((1, 4), dtype=torch.int64)},
                    attn="fast")
