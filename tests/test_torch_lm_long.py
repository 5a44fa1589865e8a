"""The long-context serving path on the CPU, against the reference.

  * ``attention_plain_panel`` (a panel of query rows over only the keys
    its masks leave) equal to the same rows of ``attention_plain``
    within 1e-6: causal, windowed, non-causal, decode (Sq = 1), groups
    1, 4 and 8, panels that start at 0, in the middle, at the last row
    and across the window's edge, rows that keep no key; and
    ``chip_smoke.plain_attention`` giving the same result however its
    budget splits the work (kv head groups, query heads, query panels);
  * ``apply_rope`` at positions 32767-32783 and 524280-524287 (past
    ``prefill_32k`` and at the end of ``long_500k``) against the
    reference's in f32, within 1e-6;
  * phi3-medium-14b and mixtral-8x7b at ``reduced()`` with window 8: a
    43-token prefill (the 8-slot ring filled 5 times over), then 20
    greedy decode steps (the ring wrapped 2-3 more times), each step's
    logits over the real vocabulary within 1e-5 of max |ref| and the
    greedy tokens equal; without a window at ``max_seq`` = S + gen, the
    same chain, every decode gather a slice of the cache's first slots.

The reference runs mesh-free through its own ``build(cfg).prefill`` /
``decode_step`` (its Pallas attention at the default interpret target),
as the other LM tests run it.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import layers as jax_layers
from repro.models.api import build as jax_build
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.attention_block.ref import (attention_plain,
                                                     attention_plain_panel,
                                                     key_span)
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.api import build

REPO = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)

# bh, kv heads, sq, skv, hd, window, causal; panels (row0, rows)
PANEL_CASES = [
    pytest.param(8, 1, 96, 96, 16, 0, True,
                 [(0, 16), (40, 16), (95, 1), (80, 16)], id="causal-g8"),
    pytest.param(8, 2, 96, 96, 16, 7, True,
                 [(0, 16), (40, 16), (95, 1), (5, 4), (3, 9)],
                 id="window-g4"),
    pytest.param(4, 4, 40, 70, 16, 0, False,
                 [(0, 8), (16, 8), (39, 1)], id="noncausal-g1"),
    pytest.param(8, 2, 30, 50, 8, 9, False,
                 [(0, 8), (12, 8), (29, 1), (6, 6)],
                 id="noncausal-window-g4"),
    pytest.param(8, 1, 1, 37, 16, 0, False, [(0, 1)], id="decode-g8"),
    pytest.param(4, 1, 64, 20, 16, 8, True,
                 [(0, 8), (24, 8), (63, 1), (20, 12)],
                 id="rows-keep-no-key-g4"),
]


def _qkv(bh, kvh, sq, skv, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((bh, sq, hd), (kvh, skv, hd), (kvh, skv, hd)))


@pytest.mark.parametrize("bh,kvh,sq,skv,hd,win,causal,panels", PANEL_CASES)
def test_panel_equals_the_rows_of_the_plain_version(bh, kvh, sq, skv, hd,
                                                    win, causal, panels):
    q, k, v = _qkv(bh, kvh, sq, skv, hd, seed=bh * 7 + sq)
    kw = dict(groups=bh // kvh, window=win, causal=causal)
    whole, lse = attention_plain(q, k, v, return_lse=True, **kw)
    for row0, rows in panels:
        out, plse = attention_plain_panel(q[:, row0:row0 + rows], k, v,
                                          row0=row0, return_lse=True, **kw)
        assert out.shape == (bh, rows, hd)
        np.testing.assert_allclose(out.numpy(),
                                   whole[:, row0:row0 + rows].numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(plse.numpy(),
                                   lse[:, row0:row0 + rows].numpy(),
                                   rtol=0, atol=1e-6)
        assert torch.equal(attention_plain_panel(
            q[:, row0:row0 + rows], k, v, row0=row0, **kw), out)


def test_panel_scores_cover_only_the_span_the_masks_leave():
    """Under a window the span is the panel's rows plus the window,
    whatever Sq is; the causal span ends at the panel's last row; a
    panel past every key under a window keeps none."""
    assert key_span(500000, 128, 524288, 4096, True) == (495905, 500128)
    assert key_span(0, 128, 524288, 4096, True) == (0, 128)
    assert key_span(16320, 128, 32768, 0, True) == (0, 16448)
    assert key_span(5, 1, 37, 0, False) == (0, 37)
    lo, hi = key_span(40, 8, 20, 8, True)
    assert hi <= lo


def test_panel_shifted_one_row_misses():
    """The control the chip smoke runs on a prefill panel: the plain
    panel with its causal mask one row off differs from the rows."""
    q, k, v = _qkv(4, 1, 64, 64, 16, seed=3)
    whole = attention_plain(q, k, v, groups=4, window=0, causal=True)
    off = attention_plain_panel(q[:, 32:48], k, v, row0=33, groups=4,
                                window=0, causal=True)
    assert (off - whole[:, 32:48]).abs().max() > 1e-2


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _smoke()


# b, sq, skv, h, kv, hd, window, causal
SPLIT_CASES = [(2, 48, 48, 8, 2, 16, 0, True),
               (1, 40, 40, 8, 2, 16, 6, True),
               (2, 1, 33, 8, 1, 16, 0, False),
               (1, 30, 50, 4, 4, 8, 0, False)]


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("budget", [1 << 30, 4 * 48 * 48 * 4, 4 * 48 * 48,
                                    4 * 8 * 48, 4 * 50, 1])
def test_smoke_plain_attention_keeps_its_result_at_any_budget(
        smoke, monkeypatch, case, budget):
    """``plain_attention`` by kv head groups, by query heads and, where
    one head's scores exceed the budget, by query panels: the same
    result as one ``attention_plain`` call over everything."""
    b, sq, skv, h, kv, hd, win, causal = case
    rng = np.random.default_rng(sq + h)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd)))
    monkeypatch.setattr(smoke, "plain_budget", lambda: budget)
    got = smoke.plain_attention(q, k, v, window=win, causal=causal)
    hf = smoke.heads_first
    want = attention_plain(hf(q), hf(k), hf(v), groups=h // kv, window=win,
                           causal=causal).reshape(b, h, sq, hd).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("budget", [4 * 48 * 48, 4 * 8 * 48, 4 * 50])
def test_smoke_plain_attention_holds_its_budget(smoke, monkeypatch, budget):
    """No call of ``plain_attention`` holds more f32 scores than its
    budget where a single query row's fit: at 32768 keys one head's
    scores (4.3 GB) passed a 4 GiB budget, and a 524288-token head's
    would be 1.1 TB."""
    b, sq, skv, h, kv, hd, win, causal = 1, 48, 48, 4, 1, 8, 0, True
    q, k, v = (torch.ones(s) for s in ((b, sq, h, hd), (b, skv, kv, hd),
                                       (b, skv, kv, hd)))
    held = []
    for name in ("attention_plain", "attention_plain_panel"):
        fn = getattr(smoke, name)

        def record(q_, k_, v_, *a, _fn=fn, **kw):
            held.append(4 * q_.shape[0] * q_.shape[1] * k_.shape[1])
            return _fn(q_, k_, v_, *a, **kw)
        monkeypatch.setattr(smoke, name, record)
    monkeypatch.setattr(smoke, "plain_budget", lambda: budget)
    smoke.plain_attention(q, k, v, window=win, causal=causal)
    assert held and max(held) <= budget


def test_smoke_plain_panels_are_the_rows(smoke, monkeypatch):
    """``plain_panels``: the fixed panels (first, middle and last rows
    of every head) of the plain version, and the kernel's output cut to
    the same rows, in the (B*H, rows, hd) layout."""
    b, s, h, kv, hd, win = 1, 300, 4, 2, 16, 40
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    monkeypatch.setattr(smoke, "plain_budget", lambda: 1 << 30)
    panels = smoke.panel_rows(s, 64)
    assert panels == [(0, 64), (118, 64), (236, 64)]
    ref, rows = smoke.plain_panels(q, k, v, window=win, causal=True,
                                   panels=panels)
    whole = smoke.plain_attention(q, k, v, window=win, causal=True)
    want = smoke.panel_cut(whole, panels)
    np.testing.assert_allclose(ref.numpy(), want.numpy(), rtol=0, atol=1e-6)
    assert rows == 3 * 64


@pytest.mark.parametrize("start,n", [(32767, 17), (524280, 8)])
@pytest.mark.parametrize("form", ["vector", "scalar"])
def test_apply_rope_at_long_positions_matches_reference(start, n, form):
    theta = get_config("phi3-medium-14b").rope_theta
    assert get_config("mixtral-8x7b").rope_theta == theta
    x = np.random.default_rng(start).standard_normal(
        (2, n, 4, 128)).astype(np.float32)
    pos = np.arange(start, start + n)
    if form == "vector":
        ref = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos,
                                                              jnp.int32),
                                    theta)
        out = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)
        return
    for i, p in enumerate(pos):
        ref = jax_layers.apply_rope(jnp.asarray(x[:, i:i + 1]),
                                    jnp.asarray(p, jnp.int32), theta)
        out = L.apply_rope(torch.from_numpy(x[:, i:i + 1]), int(p), theta)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)


def _pair(arch, **overrides):
    jcfg = jax_reduced(jax_get_config(arch), **overrides)
    cfg = reduced(get_config(arch), **overrides)
    jparams = jax_build(jcfg).init(KEY)
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  device="cpu")
    return jcfg, cfg, jparams, params


def _rel(out, ref, vocab):
    out = out[..., :vocab].double().numpy()
    ref = np.asarray(ref, np.float64)[..., :vocab]
    return np.abs(out - ref).max() / np.abs(ref).max()


def _greedy_chain(arch, window, s, gen, max_seq, monkeypatch):
    """``s`` prompt tokens, then ``gen`` greedy decode steps on both
    sides, each fed its own argmax; returns each step's gather routes."""
    jcfg, cfg, jparams, params = _pair(arch, window=window)
    japi, api = jax_build(jcfg), build(cfg)
    routes = []
    gather = A._gather

    def recorded(c, idx):
        n = len(idx)
        routes.append("slice" if n and idx[-1] == n - 1 else "index_select")
        return gather(c, idx)
    monkeypatch.setattr(A, "_gather", recorded)
    toks = np.random.default_rng(s).integers(0, cfg.vocab, (2, s)).astype(
        np.int32)
    ref, ref_caches = japi.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                   max_seq=max_seq)
    logits, caches = api.prefill(params, {"tokens": torch.from_numpy(toks)},
                                 max_seq=max_seq)
    assert _rel(logits, ref, cfg.vocab) <= 1e-5
    for pos in range(s, s + gen):
        tok = logits[..., :cfg.vocab].argmax(-1).reshape(2, 1)
        jtok = jnp.argmax(ref[..., :cfg.vocab], -1).reshape(2, 1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        ref, ref_caches = japi.decode_step(jparams, ref_caches,
                                           jtok.astype(jnp.int32),
                                           jnp.asarray(pos, jnp.int32))
        logits, caches = api.decode_step(params, caches, tok, pos)
        assert _rel(logits, ref, cfg.vocab) <= 1e-5, pos
    slots = caches[0]["sub0"]["pos"]
    np.testing.assert_array_equal(
        slots, np.asarray(ref_caches["sub0"]["pos"])[0])
    return cfg, slots, routes


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "mixtral-8x7b"])
def test_ring_wrapped_many_times_matches_reference(arch, monkeypatch):
    s, gen, window = 43, 20, 8
    cfg, slots, routes = _greedy_chain(arch, window, s, gen, s + gen,
                                       monkeypatch)
    last = s + gen - 1
    # the ring holds the last 8 positions, each in slot pos % 8
    assert sorted(slots.tolist()) == list(range(last - window + 1,
                                                last + 1))
    assert all(slots[p % window] == p for p in slots)
    # every slot of a full ring is kept: the gather is a slice
    assert routes == ["slice"] * (2 * gen * cfg.n_layers)   # k and v


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "mixtral-8x7b"])
def test_chain_without_window_gathers_a_slice(arch, monkeypatch):
    s, gen = 21, 6
    cfg, slots, routes = _greedy_chain(arch, 0, s, gen, s + gen,
                                       monkeypatch)
    assert cfg.window == 0
    assert slots.tolist() == list(range(s + gen))
    assert routes == ["slice"] * (2 * gen * cfg.n_layers)   # k and v


def test_wrong_position_control_misses():
    """The chip smoke's wrong-RoPE control at the CPU's size: a decode
    step at ``cur_pos`` one off moves the logits well past 1e-5."""
    _, cfg, _, params = _pair("phi3-medium-14b", window=8)
    api = build(dataclasses.replace(cfg))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 20)).astype(np.int32))
    _, caches = api.prefill(params, {"tokens": toks[:, :19]}, max_seq=24)
    clone = [{n: dict(c) | {"k": c["k"].clone(), "v": c["v"].clone(),
                            "pos": c["pos"].copy()}
              for n, c in block.items()} for block in caches]
    right, _ = api.decode_step(params, caches, toks[:, 19:], 19)
    wrong, _ = api.decode_step(params, clone, toks[:, 19:], 20)
    assert _rel(wrong, right.numpy(), cfg.vocab) > 1e-3


# b, s, skv, window, q_pos kind: causal, windowed (a query chunk's
# first key chunks wholly before its window), non-causal (every pair
# runs), rows past every key under a window (no key: every pair runs)
CHUNK_CASES = [(2, 40, 40, 0, "causal"), (1, 64, 64, 9, "causal"),
               (2, 37, 37, 5, "causal"), (1, 24, 40, 0, "noncausal"),
               (1, 40, 20, 4, "causal")]


@pytest.mark.parametrize("b,s,skv,window,kind", CHUNK_CASES)
def test_chunked_attention_skips_only_pairs_that_change_no_bit(
        b, s, skv, window, kind, monkeypatch):
    """``attention_chunked`` skipping the chunk pairs no mask leaves a
    score in gives the same bits, forward and backward, as running
    every pair; and it skips them (a causal prefill about half)."""
    rng = np.random.default_rng(s + window)
    q = torch.from_numpy(rng.standard_normal((b, s, 4, 16)).astype(
        np.float32)).requires_grad_()
    k, v = (torch.from_numpy(rng.standard_normal((b, skv, 2, 16)).astype(
        np.float32)).requires_grad_() for _ in range(2))
    q_pos = torch.arange(s) if kind == "causal" else torch.full(
        (s,), A.NONCAUSAL_Q_POS)
    kv_pos = torch.arange(skv)
    dout = torch.from_numpy(rng.standard_normal((b, s, 4, 16)).astype(
        np.float32))

    def run():
        out = L.attention_chunked(q, k, v, q_pos, kv_pos, window, chunk=8)
        return (out, *torch.autograd.grad(out, (q, k, v), dout))
    pairs = L._chunk_pairs(q_pos, kv_pos, 8, 8, -(-s // 8), -(-skv // 8),
                           window)
    skipped = run()
    monkeypatch.setattr(L, "_chunk_pairs",
                        lambda *a: np.ones(pairs.shape, bool))
    every = run()
    for a, b_ in zip(skipped, every):
        assert torch.equal(a, b_)
    has_key = kind == "noncausal" or not (window and s > skv + window - 1)
    if kind == "causal" and has_key:
        assert pairs.sum() < pairs.size
    if not has_key or kind == "noncausal":
        assert pairs.all()
    if (s, window, kind) == (40, 0, "causal"):
        assert pairs.sum() == 15      # of 25: the lower triangle


def test_chunked_attention_pairs_at_32768():
    n = 32768 // 1024
    pairs = L._chunk_pairs(torch.arange(32768), torch.arange(32768), 1024,
                           1024, n, n, 0)
    assert pairs.sum() == n * (n + 1) // 2
    wpairs = L._chunk_pairs(torch.arange(32768), torch.arange(32768), 1024,
                            1024, n, n, 4096)
    # under the 4096 window: query chunk i reads key chunks i - 4 .. i
    assert wpairs.sum() == 1 + 2 + 3 + 4 + 5 * (n - 4)
