"""K4's log-sum-exp output and the merge of attentions over shards of
the keys, on the CPU.

``attention_plain(..., return_lse=True)`` (what K4's wrapper returns for
a CPU tensor with ``lse``) against ``jax.nn.logsumexp`` of the
reference's scaled, masked scores (``_lax_attention``'s, with the masked
ones excluded): causal, windowed, grouped, and rows that keep no key
(``-inf``); the output the same bits with and without it.
``combine_partials`` over 1-8 shards of the keys against the attention
over all of them, with empty shards, shards whose rows keep nothing, and
no key kept anywhere (0).  The card's routes are held in
``tests/test_torch_gpu.py`` (``test_attention_lse_on_every_route``) and
by ``chip_smoke.py``'s ``mesh_attention``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.attention_block import kernel as K4
from repro_torch.kernels.attention_block.ops import (combine_partials,
                                                     flash_attention)
from repro_torch.kernels.attention_block.ref import attention_plain


def _reference_lse(q, k, v, groups, window, causal):
    """log-sum-exp over the unmasked keys of the reference's scores:
    ``_lax_attention``'s (scaled by 1/sqrt(hd), kv head = head //
    groups), masked keys excluded."""
    hd = q.shape[-1]
    kx = jnp.repeat(jnp.asarray(k), groups, axis=0)
    s = jnp.einsum("hqd,hkd->hqk", jnp.asarray(q), kx) * (1.0 / hd ** 0.5)
    sq, skv = q.shape[1], k.shape[1]
    qp, kp = jnp.arange(sq)[:, None], jnp.arange(skv)[None, :]
    mask = jnp.ones((sq, skv), bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    return np.asarray(jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf),
                                       axis=-1))


CASES = [  # bh, kv heads, sq, skv, hd, window, causal
    (4, 2, 5, 37, 16, 0, False),
    (4, 1, 33, 33, 32, 0, True),
    (6, 3, 40, 40, 8, 7, True),
    (2, 2, 30, 10, 16, 4, True),      # rows 13.. keep no key
    (2, 1, 1, 64, 64, 0, False),
]


@pytest.mark.parametrize("bh,kvh,sq,skv,hd,win,causal", CASES)
def test_plain_lse_matches_reference_logsumexp(bh, kvh, sq, skv, hd, win,
                                               causal):
    rng = np.random.default_rng(bh * 100 + sq)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((bh, sq, hd), (kvh, skv, hd), (kvh, skv, hd)))
    t = torch.from_numpy
    groups = bh // kvh
    out, lse = attention_plain(t(q), t(k), t(v), groups=groups, window=win,
                               causal=causal, return_lse=True)
    want = _reference_lse(q, k, v, groups, win, causal)
    assert lse.dtype == torch.float32 and lse.shape == (bh, sq)
    np.testing.assert_array_equal(np.isneginf(lse.numpy()),
                                  np.isneginf(want))
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)
    assert torch.equal(out, attention_plain(t(q), t(k), t(v), groups=groups,
                                            window=win, causal=causal))
    # the wrapper: a CPU tensor runs the plain version
    out2, lse2 = K4.attention(t(q), t(k), t(v), groups=groups, window=win,
                              causal=causal, lse=True)
    assert torch.equal(lse2, lse) and torch.equal(out2, out)
    assert torch.equal(K4.attention(t(q), t(k), t(v), groups=groups,
                                    window=win, causal=causal, lse=False),
                       out)


def test_lse_arguments_are_checked():
    qg = torch.zeros((1, 3, 2, 8), requires_grad=True)
    kg = torch.zeros((1, 5, 2, 8))
    with pytest.raises(ValueError, match="autograd"):
        flash_attention(qg, kg, kg, return_lse=True)
    out, lse = flash_attention(qg.detach(), kg, kg, causal=False,
                               return_lse=True)
    assert out.shape == (1, 3, 2, 8) and lse.shape == (1, 2, 3)


def _split(skv, shards, rng):
    """``shards`` contiguous key ranges of ``skv``, some empty."""
    cuts = np.sort(rng.integers(0, skv + 1, shards - 1))
    edges = np.concatenate([[0], cuts, [skv]])
    return list(zip(edges[:-1], edges[1:]))


@pytest.mark.parametrize("shards", range(1, 9))
def test_combine_partials_equals_the_whole(shards):
    rng = np.random.default_rng(shards)
    b, sq, h, kv, hd, skv = 2, 3, 4, 2, 16, 40
    q = torch.from_numpy(rng.standard_normal((b, sq, h, hd)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, skv, kv, hd)).astype(
        np.float32)) for _ in range(2))
    whole = flash_attention(q, k, v, causal=False)
    ranges = _split(skv, shards, rng)
    if shards > 2:                                   # an empty shard
        ranges[1] = (ranges[1][0], ranges[1][0])
        ranges[2] = (ranges[1][0], ranges[2][1])
    outs, lses = [], []
    for lo, hi in ranges:
        if hi == lo:      # no key: nothing launched, nothing added
            outs.append(torch.zeros_like(whole))
            lses.append(torch.full((b, h, sq), -torch.inf))
            continue
        o, l = flash_attention(q, k[:, lo:hi], v[:, lo:hi], causal=False,
                               return_lse=True)
        outs.append(o)
        lses.append(l)
    outs = torch.stack(outs)                           # (S, B, Sq, H, hd)
    lses = torch.stack(lses).transpose(2, 3)           # (S, B, Sq, H)
    got = combine_partials(outs, lses)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_combine_partials_with_rows_a_shard_does_not_keep():
    """A window leaves a shard's rows with no key: its ``lse`` is -inf
    and its out (the mean of V) weighs nothing."""
    rng = np.random.default_rng(3)
    bh, sq, hd, win = 2, 20, 8, 4
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, n, hd)).astype(
        np.float32)) for n in (sq, sq, sq))
    whole = attention_plain(q, k, v, groups=1, window=win, causal=True)
    # shard the keys in two: causal-with-window masks per absolute
    # position, so run each shard over the whole key axis with the other
    # shard's keys pushed out of reach by a mask of their own
    parts = []
    for lo, hi in ((0, 10), (10, 20)):
        kk, vv = k.clone(), v.clone()
        out, lse = attention_plain(q, kk, vv, groups=1, window=win,
                                   causal=True, return_lse=True)
        # the same rows over only [lo, hi): drop the others' terms
        s = torch.bmm(q, kk.transpose(1, 2)) / hd ** 0.5
        qp = torch.arange(sq)[:, None]
        kp = torch.arange(sq)[None, :]
        mask = (kp <= qp) & (kp > qp - win) & (kp >= lo) & (kp < hi)
        s = s.masked_fill(~mask, -torch.inf)
        lse = torch.logsumexp(s, dim=-1)
        p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
        parts.append((torch.bmm(p, vv), lse))
    assert torch.isneginf(parts[1][1][:, :5]).all()   # rows 0-4: no key
    got = combine_partials(torch.stack([p[0] for p in parts]),
                           torch.stack([p[1] for p in parts]))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_combine_partials_where_nothing_is_kept():
    """No shard keeps a key of the row: 0 (the mesh decode never merges
    such a row: each shard runs a zero query over all its slots, whose
    merge is the mean of V over every slot, the reference's result)."""
    outs = torch.randn(3, 2, 1, 4, 8)
    lses = torch.full((3, 2, 1, 4), -torch.inf)
    assert torch.equal(combine_partials(outs, lses), torch.zeros(2, 1, 4, 8))
    # the zero-query rule: every shard's lse is log(its slots), and the
    # merge is the mean of V over all slots
    v = torch.randn(1, 24, 2, 8)
    q = torch.zeros(1, 1, 4, 8)
    parts = [flash_attention(q, v[:, lo:hi], v[:, lo:hi], causal=False,
                             return_lse=True) for lo, hi in
             ((0, 6), (6, 18), (18, 24))]
    for (lo, hi), (_, l) in zip(((0, 6), (6, 18), (18, 24)), parts):
        np.testing.assert_allclose(l.numpy(), np.log(hi - lo), rtol=1e-6)
    got = combine_partials(torch.stack([p[0] for p in parts]),
                           torch.stack([p[1].transpose(1, 2)
                                        for p in parts]))
    want = v.mean(dim=1, keepdim=True).repeat_interleave(2, dim=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_combine_partials_checks_its_shapes():
    with pytest.raises(ValueError, match="do not match"):
        combine_partials(torch.zeros(2, 3, 4), torch.zeros(2, 4))
