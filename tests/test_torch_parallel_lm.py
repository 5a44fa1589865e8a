"""The port's LM serving path on a mesh against the reference's
mesh-free ``build(cfg, tp=4)``, at ``reduced(d_model=64, vocab=512,
attn_chunk=32)`` in f32, on the reference's weights (its init at tp 4:
padded heads and vocabulary, ``tpe`` expert slices), each logit within
1e-5 of max |ref|.

Without a mesh: ``build(cfg, tp=4)`` ``prefill`` and 3 ``decode_step``s
of phi3, mixtral (``capacity_factor = E``, as
``tests/test_distributed.py`` sets it), mamba2, jamba and whisper.

On one (2, 4) ("data", "model") gloo group of 8 spawned CPU ranks
(``tests/_torch_group.py``, one spawn for the file; batch 8, rows over
"data"): phi3, mixtral (``a2a`` prefill, ``psum`` decode; 4 experts, so
``tpe`` 1 at model 4; a 60-token prefill and 6 decode steps that wrap
its 64-slot window's ring across the slot shards; a 62-token prefill,
which the model axis does not split, raising as the reference's
``shard_map`` does) and whisper, each
``prefill`` and its decode steps; the sharded ``decode_block`` in the
reference's ``[past_the_end]`` and ``[nothing_kept]`` cases and across
a ring; and a reduced ``BatchedServer`` (phi3 and mixtral) whose tokens
equal the mesh-free server's on the same weights.  The reference's own
sharded tests (``tests/test_distributed.py``) fail under JAX 0.9.0; its
test holds sharded against mesh-free, as these do.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import attention as jax_attn
from repro.models.api import build as jax_build
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models.api import build

from _torch_group import join_group, start_group

KEY = jax.random.PRNGKey(0)
SMALL = dict(d_model=64, vocab=512, attn_chunk=32)
TP = 4
DEADLINE = 150.0


def _over(arch, **extra):
    over = dict(SMALL, **extra)
    if arch == "mixtral-8x7b":
        over["capacity_factor"] = 4.0          # E: nothing dropped
    return over


def _cfgs(arch, **extra):
    over = _over(arch, **extra)
    return jax_reduced(jax_get_config(arch), **over), \
        reduced(get_config(arch), **over)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _within(got, ref, rel=1e-5):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _reference_run(jcfg, params, tokens, prompt, steps, max_seq,
                   frames=None):
    """The reference's mesh-free logits: prefill, then each decode."""
    api = jax_build(jcfg, tp=TP)
    batch = {"tokens": jnp.asarray(tokens[:, :prompt])}
    if frames is not None:
        batch["frames"] = jnp.asarray(frames)
    lg, caches = api.prefill(params, batch, max_seq=max_seq)
    out = [np.asarray(lg)]
    for i in range(steps):
        lg, caches = api.decode_step(
            params, caches, jnp.asarray(tokens[:, prompt + i:prompt + i + 1]),
            jnp.asarray(prompt + i, jnp.int32))
        out.append(np.asarray(lg))
    return out


# --------------------------------------------------------------------------
# tp 4 without a mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["phi3-medium-14b", "mixtral-8x7b",
                                  "mamba2-1.3b", "jamba-1.5-large-398b",
                                  "whisper-medium"])
def test_padded_heads_without_a_mesh_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jparams = jax_build(jcfg, tp=TP).init(KEY)
    rng = np.random.default_rng(1)
    b, s, steps = 2, 12, 3
    tokens = rng.integers(0, cfg.vocab, (b, s + steps)).astype(np.int32)
    frames = (rng.standard_normal((b, 32, cfg.d_model)) * 0.5).astype(
        np.float32) if cfg.family == "encdec" else None
    ref = _reference_run(jcfg, jparams, tokens, s, steps, s + steps,
                         frames)
    api = build(cfg, tp=TP)
    params = lm_params_from_numpy(_np_tree(jparams), "cpu")
    batch = {"tokens": torch.from_numpy(tokens[:, :s].astype(np.int64))}
    if frames is not None:
        batch["frames"] = torch.from_numpy(frames)
    lg, caches = api.prefill(params, batch, max_seq=s + steps)
    got = [lg]
    for i in range(steps):
        lg, caches = api.decode_step(
            params, caches,
            torch.from_numpy(tokens[:, s + i:s + i + 1].astype(np.int64)),
            s + i)
        got.append(lg)
    nh, nkv = cfg.padded_heads(TP)
    assert (nh, nkv) == jcfg.padded_heads(TP)
    for g, r in zip(got, ref):
        _within(g.numpy(), r)


# --------------------------------------------------------------------------
# the (2, 4) gloo group
# --------------------------------------------------------------------------

#: arch -> (prompt, decode steps, max_seq, encoder frames)
RUNS = {"phi3-medium-14b": (32, 3, 36, 0),
        "mixtral-8x7b": (60, 6, 66, 0),
        "whisper-medium": (16, 3, 20, 32)}
BATCH = 8
#: a mixtral prompt whose length the model axis (4) does not split
UNSPLIT = 62


def _block_cases(rng):
    """The reference's decode_block scenarios on 8 slots (2 a model
    shard): (name, window, cache maker, cur_pos)."""
    b, kvh, hd = BATCH, 4, 16

    def rand(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    return {
        # no window, cur_pos past the last slot: no shard owns it
        "past_the_end": (0, lambda: jax_attn.cache_from_prefill(
            rand(b, 8, kvh, hd), rand(b, 8, kvh, hd),
            jnp.arange(8, dtype=jnp.int32), 8, 0), 9),
        # an empty cache decoded past its end: every score masked
        "nothing_kept": (0, lambda: dict(
            jax_attn.init_cache(b, 8, kvh, hd, 0, jnp.float32),
            k=rand(b, 8, kvh, hd), v=rand(b, 8, kvh, hd)), 9),
        # a ring of 8 wrapped by 13 tokens, the token at slot 13 % 8
        "ring": (8, lambda: jax_attn.cache_from_prefill(
            rand(b, 13, kvh, hd), rand(b, 13, kvh, hd),
            jnp.arange(13, dtype=jnp.int32), 32, 8), 13),
    }


def _serve_cfg(arch):
    """A reduced config whose shapes are the same at tp 1 and tp 4 (kv
    heads 4), so one set of weights serves on and off the mesh."""
    return _cfgs(arch, n_kv_heads=4)


def _serve_reference(cfg, params, prompts):
    server = BatchedServer(cfg, slots=4, max_seq=128, device="cpu",
                           params=params)
    reqs = [Request(rid=i, prompt=list(p), max_new=16)
            for i, p in enumerate(prompts)]
    for r in reqs:
        server.submit(r)
    steps = 0
    while (server.active or server.queue) and steps < 128:
        server.step()
        steps += 1
    return [r.out for r in reqs], steps


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel_lm_group")
    rng = np.random.default_rng(0)
    inputs = {"archs": {}, "blocks": {}, "serve": {}}
    refs = {"archs": {}, "blocks": {}, "serve": {}}
    jobs = []
    for arch, (prompt, steps, max_seq, frames) in RUNS.items():
        jcfg, cfg = _cfgs(arch)
        jparams = jax_build(jcfg, tp=TP).init(KEY)
        tokens = rng.integers(0, cfg.vocab,
                              (BATCH, prompt + steps)).astype(np.int32)
        spec = {"arch": arch, "over": _over(arch), "params":
                _np_tree(jparams), "tokens": tokens, "prompt": prompt,
                "steps": steps, "max_seq": max_seq}
        if arch == "mixtral-8x7b":
            spec["unsplit"] = UNSPLIT
        if frames:
            spec["frames"] = (rng.standard_normal(
                (BATCH, frames, cfg.d_model)) * 0.5).astype(np.float32)
        inputs["archs"][arch] = spec
        jobs.append(("archs", arch, lambda jcfg=jcfg, jp=jparams, sp=spec:
                     _reference_run(jcfg, jp, sp["tokens"], sp["prompt"],
                                    sp["steps"], sp["max_seq"],
                                    sp.get("frames"))))
    for name, (window, make, cur) in _block_cases(rng).items():
        jcfg, cfg = _cfgs("phi3-medium-14b", window=window)
        nh, nkv = jcfg.padded_heads(TP)
        jp = jax_attn.init_attention(KEY, cfg.d_model, nh, nkv,
                                     cfg.head_dim, jnp.float32)
        jcache = make()
        h = rng.standard_normal((BATCH, 1, cfg.d_model)).astype(np.float32)
        inputs["blocks"][name] = {
            "over": _over("phi3-medium-14b", window=window),
            "heads": (nh, nkv), "params": _np_tree(jp),
            "cache": _np_tree(jcache), "h": h, "cur": cur}
        jobs.append(("blocks", name, lambda jp=jp, h=h, jc=jcache,
                     jcfg=jcfg, cur=cur, nh=nh, nkv=nkv:
                     _np_tree(jax_attn.decode_block(
                         jp, jnp.asarray(h), jc, jnp.asarray(cur, jnp.int32),
                         jcfg, nh, nkv))))
    prompts = rng.integers(0, 512, (6, 8)).tolist()
    for arch in ("phi3-medium-14b", "mixtral-8x7b"):
        jcfg, cfg = _serve_cfg(arch)
        np_params = _np_tree(jax_build(jcfg, tp=TP).init(KEY))
        inputs["serve"][arch] = {
            "arch": arch, "over": _over(arch, n_kv_heads=4),
            "params": np_params, "prompts": prompts, "slots": 4,
            "max_seq": 128, "max_new": 16}
        jobs.append(("serve", arch, lambda cfg=cfg, p=np_params:
                     _serve_reference(cfg, lm_params_from_numpy(p, "cpu"),
                                      prompts)))
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    procs = start_group("lm", 8, work)
    try:
        for kind, name, fn in jobs:        # while the ranks run
            refs[kind][name] = fn()
    finally:
        ranks = join_group(procs, work, DEADLINE)
    return ranks, refs, inputs


@pytest.mark.parametrize("arch", list(RUNS))
def test_sharded_prefill_and_decode_match_reference(group, arch):
    ranks, refs, _ = group
    got = ranks[0]["archs"][arch]["logits"]
    assert len(got) == len(refs["archs"][arch]) == 1 + RUNS[arch][1]
    for g, r in zip(got, refs["archs"][arch]):
        _within(g, r)
    for out in ranks[1:]:             # every rank gathers the same rows
        for g, r0 in zip(out["archs"][arch]["logits"], got):
            np.testing.assert_array_equal(g, r0)


@pytest.mark.parametrize("arch", list(RUNS))
def test_caches_are_slot_sharded(group, arch):
    """Each rank holds its quarter of every self-attention cache's slots
    (mixtral's ring of 64 under its window)."""
    ranks, _, inputs = group
    max_seq = RUNS[arch][2]
    slots = min(max_seq, 64) if arch == "mixtral-8x7b" else max_seq
    for out in ranks:
        assert set(out["archs"][arch]["slots_local"]) == {slots // TP}


def test_mesh_path_runs_the_collectives_it_should(group):
    """phi3's decode: q, k and v gathered over "model", the merge's one
    all-reduce MAX, and sums over "model" (the merge's one, wo's and the
    FFN's, the embedding's); the FSDP gathers over "data"."""
    ranks, _, _ = group
    steps, layers = RUNS["phi3-medium-14b"][1], 2
    for out in ranks:
        run = out["archs"]["phi3-medium-14b"]
        dec = run["decode_counts"]
        assert dec["pmax"]["calls"] == steps * layers
        assert dec["psum"]["calls"] == steps * (1 + 3 * layers)
        assert dec["all_gather"]["calls"] >= steps * 3 * layers
        assert "all_to_all" not in dec


def test_mixtral_prefill_runs_a2a_in_the_reference_layout(group):
    """The a2a prefill: two all-to-alls over "model" a layer, each rank
    routing its (B, S / 4) block; the psum decode none.  A prompt whose
    length does not split over "model" raises on every rank."""
    ranks, _, _ = group
    layers = _cfgs("mixtral-8x7b")[1].n_layers
    for out in ranks:
        run = out["archs"]["mixtral-8x7b"]
        assert run["prefill_counts"]["all_to_all"]["calls"] == 2 * layers
        assert "all_to_all" not in run["decode_counts"]
        assert run["unsplit"] == (f"a2a shards the sequence over the model "
                                  f"axis: {UNSPLIT} tokens do not split "
                                  f"over 4 shards")


@pytest.mark.parametrize("name", ["past_the_end", "nothing_kept", "ring"])
def test_sharded_decode_block_matches_reference(group, name):
    ranks, refs, inputs = group
    ref_out, ref_cache = refs["blocks"][name]
    c = inputs["blocks"][name]
    for r, out in enumerate(ranks):
        got = out["blocks"][name]
        _within(got["out"], ref_out)
        np.testing.assert_array_equal(got["pos"], ref_cache["pos"])
        model = r % 4
        kept = [s for s in np.flatnonzero(
            (ref_cache["pos"] >= 0) & (ref_cache["pos"] <= c["cur"]))
            if 2 * model <= s < 2 * model + 2]
        if name == "nothing_kept":
            assert got["seen"] == [2]        # a zero query, all its slots
        else:
            assert got["seen"] == ([len(kept)] if kept else [])


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "mixtral-8x7b"])
def test_mesh_server_tokens_equal_the_mesh_free_server(group, arch):
    ranks, refs, _ = group
    want, want_steps = refs["serve"][arch]
    for out in ranks:
        assert out["serve"][arch]["outs"] == want
        assert out["serve"][arch]["steps"] == want_steps
    assert all(len(o) == 16 for o in want)
