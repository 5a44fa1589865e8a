"""The port's LM training path on the CPU against the reference's, on the
same weights (the reference's init carried across through
``repro_torch.convert``) and the same batches (the reference's, carried
across as numpy), at ``reduced()`` sizes in f32:

  * ``lm_loss`` with ignored labels, a padded vocabulary, and sequences
    that are a multiple of its 512-token chunk and not: the loss within
    1e-6 relative, its gradients in ``h`` and the table within 1e-5 of
    their max |ref|;
  * ``train_loss`` and its gradient for all ten archs (``jax.value_and_
    grad`` of the reference's): the loss within 1e-5 relative, every
    gradient leaf within 1e-4 of its max |ref|, read back in the
    reference's stacked layout; whisper at ``attn_chunk`` 1500, where
    the reference pads no key (``ROADMAP.md`` §3); also mixtral at
    ``window=8`` over 24 tokens, where the window bites, and mamba2 and
    jamba over 600 tokens, two 256-row SSD chunks and a ragged tail
    (their ``dt_bias`` Mamba2's own initialisation, where the
    reference's gradient is finite); and at the published grouping,
    experts and prefix (head dim 8): granite's 48 query heads on one kv
    head, dbrx's 16 experts top-4 at capacity factor 1.25 with pairs
    dropped, llava's 24-row prefix in 32 tokens, its labels -1 there;
  * remat on and off (and the ``dots`` policy) give the same gradients;
  * three ``make_train_step`` steps of minitron, of mixtral and of
    that llava against the reference's: ``loss``, ``grad_norm`` and
    ``lr`` within 1e-5 relative at every step;
  * a reference ``TrainState`` carried across, through the port's
    checkpointer and back, bit for bit.

Attention on the port's side is K4's plain version (the CPU) under the
autograd ``Function`` whose backward is the reference's VJP.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import steps as jax_steps
from repro.models.api import build as jax_build
from repro.models.embedding import lm_loss as jax_lm_loss
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.convert import (lm_params_from_numpy, lm_params_to_numpy,
                                 train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.launch import steps
from repro_torch.models.api import build
from repro_torch.models import moe as moe_mod
from repro_torch.models.embedding import lm_loss

KEY = jax.random.PRNGKey(0)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _overrides(arch):
    """whisper where the reference pads no key: its 1500 frames in one
    chunk."""
    return {"attn_chunk": 1500} if arch == "whisper-medium" else {}


def _mamba2_dt_bias(jparams):
    """Every ``dt_bias`` drawn as Mamba2's own initialisation draws it:
    dt log-uniform in [1e-3, 1e-1], then the inverse softplus.  The
    reference's all-zero ``dt_bias`` sums ``dt`` past 88 within a
    256-row chunk, where its ``where(tri, exp(seg), 0)`` has a NaN
    gradient (``tests/test_torch_lm_ssm.py``)."""
    rng = np.random.default_rng(7)

    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['dt_bias']"):
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), leaf.shape))
            return jnp.asarray(dt + np.log(-np.expm1(-dt)), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(draw, jparams)


def _pair(arch, mamba2_dt=False, **overrides):
    overrides = {**_overrides(arch), **overrides}
    jcfg = jax_reduced(jax_get_config(arch), **overrides)
    cfg = reduced(get_config(arch), **overrides)
    jparams = jax_build(jcfg).init(KEY)
    if mamba2_dt:
        jparams = _mamba2_dt_bias(jparams)
    return jcfg, cfg, jparams, lm_params_from_numpy(_numpy_tree(jparams),
                                                    device="cpu")


def _batch(cfg, b=2, s=16, seed=0, mask_prefix=False):
    """``mask_prefix``: the labels -1 over the prefix's positions, as a
    VLM batch is trained."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    batch["labels"][0, :3] = -1
    if cfg.frontend == "vision_stub":
        batch["prefix_embeds"] = (rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)) * 0.02).astype(np.float32)
        if mask_prefix:
            batch["labels"][:, :cfg.frontend_len] = -1
    if cfg.family == "encdec":
        batch["frames"] = (rng.standard_normal(
            (b, 1500, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def _port(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _rel(out, ref) -> float:
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _grads_within(port_grads, ref_grads, rel):
    port = lm_params_to_numpy(port_grads)
    ref = _numpy_tree(ref_grads)
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    port_leaves = jax.tree_util.tree_leaves(port)
    assert len(ref_leaves) == len(port_leaves)
    for (path, r), p in zip(ref_leaves, port_leaves):
        assert _rel(p, r) <= rel, (jax.tree_util.keystr(path), _rel(p, r))


# -------------------------------------------------------------------- loss

@pytest.mark.parametrize("s,vocab,real", [(16, 256, 256), (1024, 256, 200),
                                          (600, 320, 300)])
def test_lm_loss_matches_reference(s, vocab, real):
    rng = np.random.default_rng(s)
    h = rng.standard_normal((2, s, 32)).astype(np.float32)
    table = (rng.standard_normal((vocab, 32)) * 0.2).astype(np.float32)
    labels = rng.integers(0, real, (2, s)).astype(np.int32)
    labels[0, ::3] = -1
    labels[1, -5:] = -1

    def ref_fn(h_, t_):
        return jax_lm_loss(h_, t_, jnp.asarray(labels), real)
    ref, (rdh, rdt) = jax.value_and_grad(ref_fn, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(table))
    th = torch.from_numpy(h).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    out = lm_loss(th, tt, torch.from_numpy(labels), real)
    out.backward()
    assert abs(float(out.detach()) - float(ref)) <= 1e-6 * abs(float(ref))
    assert _rel(th.grad, rdh) <= 1e-5
    assert _rel(tt.grad, rdt) <= 1e-5
    if real < vocab:        # the padded vocabulary gets no gradient
        assert not tt.grad[real:].any()


# ------------------------------------------------------------ train_loss

#: beyond every arch at ``s = 16``: mixtral where its window bites
#: (``window=8`` at 24 tokens), and the SSD scan over two 256-row chunks
#: and a ragged tail, which the reference pads (mamba2, jamba at 600)
#: and the reference's gradient finite, its ``dt_bias`` Mamba2's own
#: (:func:`_mamba2_dt_bias`)
LONGER = [pytest.param("mixtral-8x7b", {"window": 8}, 24,
                       id="mixtral-8x7b-window8-s24"),
          pytest.param("mamba2-1.3b", {"mamba2_dt": True}, 600,
                       id="mamba2-1.3b-s600"),
          pytest.param("jamba-1.5-large-398b", {"mamba2_dt": True}, 600,
                       id="jamba-1.5-large-398b-s600")]
#: the published grouping, experts and prefix at narrow widths (head dim
#: 8, d_model 64), where ``reduced()`` caps heads at 4 over 2, experts
#: at 4 of top-2 and the prefix at 8 rows: granite's 48 query heads on
#: one kv head (the backward sums 48 heads' dk and dv into it); dbrx's
#: 48 over 8 with 16 experts, top-4, capacity factor 1.25, where the
#: 32 tokens' 128 pairs overflow the 10-row bins (``drops``); llava's 56
#: over 8 with a prefix of 24 rows in 32 tokens and the labels -1 over
#: it (``mask_prefix``)
PUBLISHED = {
    "granite-34b": dict(n_heads=48, n_kv_heads=1, head_dim=8),
    "dbrx-132b": dict(n_heads=48, n_kv_heads=8, head_dim=8, n_experts=16,
                      top_k=4, capacity_factor=1.25),
    "llava-next-34b": dict(n_heads=56, n_kv_heads=8, head_dim=8,
                           frontend_len=24)}
AT_PUBLISHED = [
    pytest.param("granite-34b", PUBLISHED["granite-34b"], 16,
                 id="granite-34b-48-on-1"),
    pytest.param("dbrx-132b", {**PUBLISHED["dbrx-132b"], "drops": True}, 16,
                 id="dbrx-132b-16-experts-top4-drops"),
    pytest.param("llava-next-34b", {**PUBLISHED["llava-next-34b"],
                                    "mask_prefix": True}, 32,
                 id="llava-next-34b-prefix24-s32")]


def _counting_drops(monkeypatch) -> list:
    """Each dispatch's dropped pairs (a slot past the last bin)."""
    dropped = []
    dispatch = moe_mod.moe_dispatch_local

    def counting(x, gates, idx, n_experts, capacity):
        bins, slot = dispatch(x, gates, idx, n_experts, capacity)
        dropped.append(int((slot == n_experts * capacity).sum()))
        return bins, slot
    monkeypatch.setattr(moe_mod, "moe_dispatch_local", counting)
    return dropped


@pytest.mark.parametrize(
    "arch,overrides,s",
    [pytest.param(a, {}, 16, id=a) for a in ARCHS] + LONGER + AT_PUBLISHED)
def test_train_loss_and_grads_match_reference(arch, overrides, s,
                                              monkeypatch):
    overrides = dict(overrides)
    drops = overrides.pop("drops", False)
    mask_prefix = overrides.pop("mask_prefix", False)
    jcfg, cfg, jparams, params = _pair(arch, **overrides)
    batch = _batch(cfg, s=s, mask_prefix=mask_prefix)
    ref, ref_grads = jax.jit(jax.value_and_grad(jax_build(jcfg).train_loss))(
        jparams, _jax(batch))
    dropped = _counting_drops(monkeypatch)
    loss, grads = steps.value_and_grad(build(cfg), params, _port(batch))
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
    _grads_within(grads, ref_grads, 1e-4)
    if drops:   # the forward and the remat recompute, each layer
        assert len(dropped) == 2 * cfg.n_layers and min(dropped) > 0, \
            dropped


@pytest.mark.parametrize("arch,policy", [("minitron-4b", "nothing"),
                                         ("minitron-4b", "dots"),
                                         ("mixtral-8x7b", "dots"),
                                         ("whisper-medium", "nothing")])
def test_remat_on_and_off_give_equal_gradients(arch, policy):
    cfg = reduced(get_config(arch), remat_policy=policy,
                  **_overrides(arch))
    params = build(cfg).init(torch.Generator().manual_seed(1))
    batch = _port(_batch(cfg, s=12, seed=3))
    if cfg.family == "encdec":
        batch["frames"] = batch["frames"][:, :40]
    out = {}
    for on in (True, False):
        api = build(dataclasses.replace(cfg, remat=on))
        out[on] = steps.value_and_grad(api, params, batch)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(lm_params_to_numpy(out[True][1]).values(),
                    lm_params_to_numpy(out[False][1]).values()):
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------- steps

@pytest.mark.parametrize("arch,overrides,s", [
    ("minitron-4b", {}, 16), ("mixtral-8x7b", {}, 16),
    pytest.param("llava-next-34b", PUBLISHED["llava-next-34b"], 32,
                 id="llava-next-34b-prefix24-s32")])
def test_three_train_steps_match_reference(arch, overrides, s):
    jcfg = jax_reduced(jax_get_config(arch), **overrides)
    cfg = reduced(get_config(arch), **overrides)
    japi = jax_build(jcfg)
    jstate = jax_steps.init_train_state(japi, KEY)
    state = train_state_from_numpy(_numpy_tree(jstate), device="cpu")
    kw = dict(peak_lr=1e-2, warmup=1, total=6)
    jstep = jax.jit(jax_steps.make_train_step(japi, **kw))
    step = steps.make_train_step(build(cfg), **kw)
    for i in range(3):
        batch = _batch(cfg, s=s, seed=10 + i, mask_prefix=True)
        jstate, jm = jstep(jstate, _jax(batch))
        state, m = step(state, _port(batch))
        for name in ("loss", "grad_norm", "lr"):
            assert abs(float(m[name]) - float(jm[name])) \
                <= 1e-5 * abs(float(jm[name])), (i, name)
    assert int(state.step) == int(jstate.step) == 3
    assert int(state.opt.step) == int(jstate.opt.step) == 3


def test_train_state_round_trips_through_the_checkpointer(tmp_path):
    """The reference's state after one step (non-zero moments) carried
    across, saved by the port's checkpointer, restored into a fresh
    state's structure and carried back: every leaf equal to the
    reference's, bit for bit."""
    arch = "mixtral-8x7b"
    jcfg = jax_reduced(jax_get_config(arch))
    japi = jax_build(jcfg)
    jstate = jax_steps.init_train_state(japi, KEY)
    jstate, _ = jax.jit(jax_steps.make_train_step(japi, warmup=1))(
        jstate, _jax(_batch(reduced(get_config(arch)))))
    ref = _numpy_tree(jstate)
    state = train_state_from_numpy(ref, device="cpu")
    ckpt.save(str(tmp_path), 1, state)
    like = steps.init_train_state(build(reduced(get_config(arch))),
                                  torch.Generator().manual_seed(5))
    restored, step = ckpt.restore_latest(str(tmp_path), like)
    back = train_state_to_numpy(restored)
    assert step == 1 and back["step"] == back["opt_step"] == 1
    for mine, theirs in ((back["params"], ref.params), (back["m"], ref.opt.m),
                         (back["v"], ref.opt.v)):
        for x, y in zip(jax.tree_util.tree_leaves(mine),
                        jax.tree_util.tree_leaves(theirs)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
