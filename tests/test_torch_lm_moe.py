"""The port's MoE FFN (``repro_torch.models.moe``, dense mode) on the CPU
against the reference's ``repro.models.moe`` on the same numpy inputs.

``router_top_k``: the chosen experts equal, gates within 1e-6 (f32),
and an exact tie (two router columns equal) broken toward the lower
expert as ``jax.lax.top_k`` breaks it.  ``moe_dispatch_local`` given
the reference's own ``(gates, idx)``: bins and slots bit for bit, also
at ``capacity_factor`` 0.5 where pairs are dropped (within an expert
the first ``cap`` pairs in flat (token, choice) order kept, the rest
dropped), also in bf16.
``moe_combine_local`` within 1e-6 of max |ref|.  ``moe_ffn_dense`` at
``tpe`` 1 and 2 in f32 (1e-5 of max |ref|: the products sum in other
orders) and in bf16 on identical bf16 inputs (2e-2 of max |ref|, the
bf16 gate of the model tests).  The capacity formula at the server's
decode (4 tokens, top-2 of 8, 1.25: 2 rows) and at an 8192-token
prefill (2560 rows).  The mesh modes raise.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jax_moe
from repro_torch.models import moe as M

KEY = jax.random.PRNGKey(0)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(out, ref, rel):
    out = np.asarray(out.float() if isinstance(out, torch.Tensor) else out,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _params(d, f, e, tpe=1, seed=0):
    """Reference-layout MoE weights as numpy f32."""
    rng = np.random.default_rng(seed)
    rows = e * tpe
    return {"router": (rng.standard_normal((d, e)) / math.sqrt(d)
                       ).astype(np.float32),
            "wg": (rng.standard_normal((rows, d, f // tpe))
                   / math.sqrt(d)).astype(np.float32),
            "wi": (rng.standard_normal((rows, d, f // tpe))
                   / math.sqrt(d)).astype(np.float32),
            "wo": (rng.standard_normal((rows, f // tpe, d))
                   / math.sqrt(f)).astype(np.float32)}


@pytest.mark.parametrize("t,d,e,k", [(16, 32, 4, 2), (37, 64, 8, 2),
                                     (20, 48, 16, 4)])
def test_router_top_k_matches_reference(t, d, e, k):
    x, router = _rand(t, d), _rand(d, e, seed=1, scale=0.3)
    rg, ri = jax_moe.router_top_k(jnp.asarray(x), jnp.asarray(router), k)
    g, i = M.router_top_k(torch.from_numpy(x), torch.from_numpy(router), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), atol=1e-6,
                               rtol=0)
    assert g.dtype == torch.float32


def test_router_top_k_breaks_an_exact_tie_as_the_reference():
    """Router columns 1 and 3 equal, 0 and 2 far below: every token's
    two largest probabilities tie exactly; the lower expert comes
    first, as ``jax.lax.top_k`` orders it."""
    x = _rand(12, 16)
    col = _rand(16, seed=2, scale=0.3)
    router = np.stack([col - 50, col, col - 60, col], axis=1).astype(
        np.float32)
    x = np.abs(x)       # x @ (col - 50) far below x @ col
    rg, ri = jax_moe.router_top_k(jnp.asarray(x), jnp.asarray(router), 2)
    g, i = M.router_top_k(torch.from_numpy(x), torch.from_numpy(router), 2)
    assert (np.asarray(ri) == [1, 3]).all()
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(g.numpy(), np.asarray(rg))
    # top-1 of the same tie: the lower of the two
    _, i1 = M.router_top_k(torch.from_numpy(x), torch.from_numpy(router), 1)
    assert (i1.numpy() == 1).all()


def _dispatch_pair(t, d, e, k, cf, dtype=np.float32, seed=0):
    x = _rand(t, d, seed=seed).astype(dtype)
    router = _rand(d, e, seed=seed + 1, scale=0.3)
    rg, ri = jax_moe.router_top_k(jnp.asarray(x), jnp.asarray(router), k)
    cap = max(1, int(math.ceil(t * k / e * cf)))
    rbins, rslot = jax_moe.moe_dispatch_local(jnp.asarray(x), rg, ri, e, cap)
    tx = torch.from_numpy(x.astype(np.float32)).to(
        torch.bfloat16 if dtype != np.float32 else torch.float32)
    bins, slot = M.moe_dispatch_local(
        tx, torch.from_numpy(np.array(rg)),
        torch.from_numpy(np.array(ri).astype(np.int64)), e, cap)
    return (rg, ri, rbins, rslot), (bins, slot), cap


@pytest.mark.parametrize("cf", [8.0, 1.25, 0.5])
def test_dispatch_bins_and_slots_bit_equal(cf):
    t, d, e, k = 24, 32, 4, 2
    (rg, ri, rbins, rslot), (bins, slot), cap = _dispatch_pair(t, d, e, k,
                                                               cf)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(rslot))
    np.testing.assert_array_equal(bins.numpy(), np.asarray(rbins))
    assert bins.shape == (e, cap, d)
    dropped = int((slot.numpy() == e * cap).sum())
    if cf == 0.5:
        assert dropped > 0
        # the stable rank: within an expert, the first ``cap`` pairs
        # in flat (token, choice) order are kept, the rest dropped
        flat_e = np.asarray(ri).reshape(-1)
        s = slot.numpy()
        for ex in range(e):
            mine = np.flatnonzero(flat_e == ex)
            kept = mine[s[mine] < e * cap]
            gone = mine[s[mine] == e * cap]
            assert len(kept) == min(cap, len(mine))
            if len(gone):
                assert kept.max() < gone.min()
    if cf == 8.0:
        assert dropped == 0


def test_dispatch_bf16_bit_equal_with_drops():
    t, d, e, k = 40, 32, 8, 2
    (_, _, rbins, rslot), (bins, slot), cap = _dispatch_pair(
        t, d, e, k, 0.5, dtype=jnp.bfloat16)
    assert bins.dtype == torch.bfloat16
    assert (slot.numpy() == e * cap).any()
    np.testing.assert_array_equal(slot.numpy(), np.asarray(rslot))
    np.testing.assert_array_equal(bins.float().numpy(),
                                  np.asarray(rbins.astype(jnp.float32)))


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_combine_matches_reference(cf):
    t, d, e, k = 24, 32, 4, 2
    (rg, _ri, rbins, rslot), (bins, slot), cap = _dispatch_pair(t, d, e, k,
                                                                cf)
    ret = _rand(e, cap, d, seed=5)
    ref = jax_moe.moe_combine_local(jnp.asarray(ret), rslot, rg, t, k)
    out = M.moe_combine_local(torch.from_numpy(ret), slot,
                              torch.from_numpy(np.array(rg)), t, k)
    _close(out, np.asarray(ref), 1e-6)


@pytest.mark.parametrize("tpe", [1, 2])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_ffn_dense_f32_matches_reference(tpe, cf):
    t, d, f, e, k = 30, 32, 64, 4, 2
    p = _params(d, f, e, tpe)
    x = _rand(t, d, seed=7)
    ref = jax_moe.moe_ffn_dense(jnp.asarray(x),
                                {n: jnp.asarray(a) for n, a in p.items()},
                                k, cf)
    out = M.moe_ffn_dense(torch.from_numpy(x),
                          {n: torch.from_numpy(a) for n, a in p.items()},
                          k, cf)
    assert out.dtype == torch.float32
    _close(out, np.asarray(ref), 1e-5)


@pytest.mark.parametrize("tpe", [1, 2])
def test_moe_ffn_dense_bf16_matches_reference(tpe):
    """One layer on identical bf16 inputs and weights (router f32)."""
    t, d, f, e, k = 30, 32, 64, 4, 2
    p = _params(d, f, e, tpe, seed=3)
    x = _rand(t, d, seed=8)
    jp = {n: jnp.asarray(a) if n == "router"
          else jnp.asarray(a, jnp.bfloat16) for n, a in p.items()}
    ref = jax_moe.moe_ffn_dense(jnp.asarray(x, jnp.bfloat16), jp, k, 1.25)
    tp = {n: torch.from_numpy(a) if n == "router"
          else torch.from_numpy(a).to(torch.bfloat16) for n, a in p.items()}
    out = M.moe_ffn_dense(torch.from_numpy(x).to(torch.bfloat16), tp, k,
                          1.25)
    assert out.dtype == torch.bfloat16
    _close(out, np.asarray(ref.astype(jnp.float32)), 2e-2)


@pytest.mark.parametrize("t,k,e,cf,want", [
    (4, 2, 8, 1.25, 2),            # the server's decode: 4 slots
    (8192, 2, 8, 1.25, 2560),      # mixtral's 8192-token prefill
    (1, 2, 8, 1.25, 1),
    (6, 2, 4, 8.0, 24),            # the reference server's --reduced
    (16, 4, 16, 1.25, 5),          # dbrx's top-4 of 16
])
def test_capacity_formula(t, k, e, cf, want):
    assert M.bin_capacity(t, k, e, cf) == want
    assert max(1, int(math.ceil(t * k / e * cf))) == want


def test_init_moe_shapes():
    p = M.init_moe(torch.Generator().manual_seed(0), 32, 64, 4,
                   torch.bfloat16, tpe=2)
    assert p["router"].dtype == torch.float32 and p["router"].shape == (32, 4)
    assert p["wg"].shape == p["wi"].shape == (8, 32, 32)
    assert p["wo"].shape == (8, 32, 32) and p["wo"].dtype == torch.bfloat16
    ref = jax_moe.init_moe(KEY, 32, 64, 4, jnp.bfloat16, tpe=2)
    for n in ref:
        assert tuple(ref[n].shape) == tuple(p[n].shape)
    # each projection at 1/sqrt(its input width): wg/wi d, wo d_ff (the
    # full width); the reference's wg/wi take the expert count instead
    w = M.init_moe(torch.Generator().manual_seed(0), 64, 4096, 2,
                   torch.float32)
    assert abs(float(w["wo"].std()) - 1 / 64) < 1e-3
    for n in ("wg", "wi"):
        assert abs(float(w[n].std()) - 1 / 8) < 1e-3
    ref = jax_moe.init_moe(KEY, 64, 4096, 2, jnp.float32)
    assert abs(float(jnp.std(ref["wg"])) - 1 / math.sqrt(2)) < 1e-2


@pytest.mark.parametrize("mode", ["moe_ffn_a2a", "moe_ffn_psum",
                                  "moe_ffn_psum_ep2"])
def test_mesh_modes_raise(mode):
    """The mesh modes are the bodies of the reference's shard_map: with no
    mesh installed their first collective refuses
    (tests/test_torch_parallel.py holds them against the reference's on
    a mesh)."""
    x = torch.zeros((4, 8))
    params = {"router": torch.zeros((8, 2)), "wg": torch.zeros((1, 8, 4)),
              "wi": torch.zeros((1, 8, 4)), "wo": torch.zeros((1, 4, 8))}
    args = {"moe_ffn_a2a": (x, params, 2, 1.25, "model", None),
            "moe_ffn_psum": (x, params, 2, "model", None),
            "moe_ffn_psum_ep2": (x, params, 2, ("model", "data"),
                                 None)}[mode]
    with pytest.raises(RuntimeError, match="needs a mesh"):
        getattr(M, mode)(*args)
