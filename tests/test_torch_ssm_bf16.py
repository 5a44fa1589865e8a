"""How far mamba2's bf16 path lies from its f32 path, in the port and in
the reference, on the CPU, on the same bf16-representable weights and
inputs.

The card's ``lm_serve_ssm`` phase gates mamba2-1.3b's served bf16 steps
against an f32 replay of each layer; there a whole step's logits, which
carry 48 layers of bf16 rounding, read far more than one layer's
output.  These tests hold that the distance is the reference's own bf16
semantics and not a fault of the port: the port's bf16 result is no
farther from the reference's f32 result than twice the reference's own
bf16 result is, for one mixer (``mamba_decode`` and ``mamba_forward``)
and for a whole model's prefill and decode steps, at a mamba2 config of
4 layers, d_model 256 and state 64 (f32 weights rounded to bf16, so
both paths hold the same values).  Every distance is max |a - b| over
max |b|.  The reference's own bf16 logits lie beyond the card's 2e-2
gate at 4 layers already.  The readings print with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_ssm_bf16.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import ssm as jax_ssm
from repro.models.api import build as jax_build
from repro.models.layers import cast_params_for_compute as jax_cast
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import ssm as S
from repro_torch.models.api import build
from repro_torch.models.layers import cast_params_for_compute

ARCH = "mamba2-1.3b"
SIZE = dict(n_layers=4, d_model=256, vocab=1024, ssm_state=64,
            ssm_head_dim=64)
#: how much farther from f32 the port's bf16 may be than the reference's
FACTOR = 2.0
PROMPT, STEPS, BATCH = 24, 4, 2
#: the card's bf16 gate on served logits (``chip_smoke.LM_BF16_TOL``)
LM_BF16_TOL = 2e-2


def _cfgs(dtype: str):
    jd = {"bf16": jnp.bfloat16, "f32": jnp.float32}[dtype]
    td = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    return (jax_reduced(jax_get_config(ARCH), **SIZE, compute_dtype=jd),
            reduced(get_config(ARCH), **SIZE, compute_dtype=td))


def _bf16_exact(a):
    """``a`` rounded to bf16, held in f32."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _dist(a, b) -> float:
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all()
    return float(np.abs(a - b).max() / np.abs(b).max())


def _weights():
    jcfg, _ = _cfgs("f32")
    tree = jax_build(jcfg).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(_bf16_exact, tree)


def _jax_run(dtype, tree, tokens):
    jcfg, _ = _cfgs(dtype)
    api = jax_build(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    lg, caches = api.prefill(params, {"tokens": jnp.asarray(
        tokens[:, :PROMPT])}, max_seq=PROMPT + STEPS)
    out = [np.asarray(lg.astype(jnp.float32))]
    for i in range(STEPS):
        lg, caches = api.decode_step(
            params, caches, jnp.asarray(tokens[:, PROMPT + i:PROMPT + i + 1]),
            jnp.asarray(PROMPT + i, jnp.int32))
        out.append(np.asarray(lg.astype(jnp.float32)))
    return out


def _torch_run(tree, tokens):
    _, cfg = _cfgs("bf16")
    api = build(cfg)
    params = lm_params_from_numpy(tree, "cpu")
    t = torch.from_numpy(tokens.astype(np.int64))
    lg, caches = api.prefill(params, {"tokens": t[:, :PROMPT]},
                             max_seq=PROMPT + STEPS)
    out = [lg]
    for i in range(STEPS):
        lg, caches = api.decode_step(params, caches,
                                     t[:, PROMPT + i:PROMPT + i + 1],
                                     PROMPT + i)
        out.append(lg)
    return out


def model_readings() -> dict:
    """Each step's logits (the prefill's, then each decode's) in bf16
    against the reference's f32 run: the reference's and the port's."""
    _, cfg = _cfgs("bf16")
    tree = _weights()
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab, (BATCH, PROMPT + STEPS)).astype(np.int32)
    ref32 = _jax_run("f32", tree, tokens)
    ref16 = _jax_run("bf16", tree, tokens)
    port16 = _torch_run(tree, tokens)
    v = cfg.vocab
    return {"reference": [_dist(a[..., :v], b[..., :v])
                          for a, b in zip(ref16, ref32)],
            "port": [_dist(a[..., :v], b[..., :v])
                     for a, b in zip(port16, ref32)]}


def _rand(*shape, seed, scale=1.0):
    return _bf16_exact((np.random.default_rng(seed).standard_normal(shape)
                        * scale).astype(np.float32))


def _bf16(a) -> torch.Tensor:
    return torch.tensor(a).bfloat16()


def mixer_readings(kind: str) -> dict:
    """One mixer's output in bf16 against the reference's f32 mixer on
    the same inputs (``decode``: one token from a random state and conv
    tail; ``forward``: a 40-token prefill over two chunks)."""
    jcfg16, cfg16 = _cfgs("bf16")
    jcfg32, _ = _cfgs("f32")
    tree = jax.tree_util.tree_map(_bf16_exact, jax_ssm.init_mamba(
        jax.random.PRNGKey(1), jcfg32.d_model, jcfg32.ssm_state,
        jcfg32.ssm_head_dim, jcfg32.ssm_expand, jcfg32.ssm_conv,
        jnp.float32))
    jp32 = jax.tree_util.tree_map(jnp.asarray, tree)
    jp16 = jax_cast(jp32, jnp.bfloat16)
    tp = cast_params_for_compute(
        {n: torch.from_numpy(np.array(a)) for n, a in tree.items()},
        torch.bfloat16)
    b, d = 3, cfg16.d_model
    if kind == "decode":
        x = _rand(b, 1, d, seed=10)
        conv = _rand(b, cfg16.ssm_conv - 1,
                     cfg16.d_inner + 2 * cfg16.ssm_state, seed=11)
        st = _rand(b, cfg16.ssm_heads, cfg16.ssm_head_dim, cfg16.ssm_state,
                   seed=12, scale=0.3)

        def ref(jcfg, dt):
            jp = jp16 if dt == jnp.bfloat16 else jp32
            y, _ = jax_ssm.mamba_decode(jp, jnp.asarray(x, dt), jcfg,
                                        jnp.asarray(st),
                                        jnp.asarray(conv, dt))
            return np.asarray(y.astype(jnp.float32))
        port, _ = S.mamba_decode(tp, _bf16(x), cfg16, torch.tensor(st),
                                 _bf16(conv))
    else:
        x = _rand(b, 40, d, seed=13)

        def ref(jcfg, dt):
            jp = jp16 if dt == jnp.bfloat16 else jp32
            y, _ = jax_ssm.mamba_forward(jp, jnp.asarray(x, dt), jcfg)
            return np.asarray(y.astype(jnp.float32))
        port, _ = S.mamba_forward(tp, _bf16(x), cfg16)
    ref32 = ref(jcfg32, jnp.float32)
    return {"reference": _dist(ref(jcfg16, jnp.bfloat16), ref32),
            "port": _dist(port, ref32)}


@pytest.mark.parametrize("kind", ["decode", "forward"])
def test_bf16_mixer_is_as_far_from_f32_as_the_reference(kind):
    r = mixer_readings(kind)
    assert r["port"] <= FACTOR * r["reference"], r


def test_bf16_model_is_as_far_from_f32_as_the_reference():
    """Also: the reference's own bf16 logits, 4 layers deep, already lie
    beyond the card's 2e-2 gate from its f32 logits, so a whole step of
    48 layers is no gate for the port's bf16 path."""
    r = model_readings()
    assert max(r["port"]) <= FACTOR * max(r["reference"]), r
    assert max(r["reference"]) > LM_BF16_TOL, r


if __name__ == "__main__":
    for k in ("decode", "forward"):
        print(f"mixer {k}:", mixer_readings(k))
    print("model steps:", model_readings())
