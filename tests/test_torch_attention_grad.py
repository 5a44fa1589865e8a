"""The attention's backward on the CPU: ``flash_attention`` under autograd
(the ``Attention`` Function: K4's plain version forward, the
reference's VJP backward) against ``jax.vjp`` of the reference's
``flash_attention(..., target="lax")`` on the same numpy inputs and
output cotangent — causal, windowed, non-causal, GQA, ragged key counts
and rows with no unmasked key (a uniform P there), one query panel or
many.  f32: dq, dk and dv within 1e-5 of max |ref|.  bf16 (the same
bf16 words on both sides): within the bf16 ``CARD_TOL`` of the
reference's f32 math on those words rounded once to bf16, and, where
every query head has its own kv head, of the reference's own bf16 VJP.
Under GQA the reference's bf16 VJP rounds each query head's dk and dv
to bf16 before summing a group (``jnp.repeat`` of a bf16 k, then
``astype(f32)``, whose transpose casts each head's cotangent back),
and misses that gate by up to 1.3x; the port sums a group in f32 and
rounds once, and lies nearer the f32 math than the reference's bf16
VJP (a departure kept on purpose, ``ROADMAP.md`` §3).  A backward
whose causal mask keeps one key too many misses the f32 gate by far.
Also the trainer's entry points on the CPU: the ``repro_torch.launch.
train`` CLI (``--device cpu --reduced``: its loss falls) and the
quickstart sibling."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.attention_block.ops import flash_attention as jax_flash
from repro_torch.kernels.attention_block import backward as B
from repro_torch.kernels.attention_block.ops import (Attention,
                                                     flash_attention)
from repro_torch.launch import train as train_cli
from repro_torch.launch.yardstick import within

REPO = Path(__file__).resolve().parent.parent

#: (b, sq, skv, h, kv, hd, window, causal)
CASES = [
    (2, 16, 16, 4, 4, 16, 0, True),          # causal, MHA
    (2, 24, 24, 8, 2, 16, 0, True),          # GQA
    (1, 40, 40, 4, 2, 8, 7, True),           # windowed
    (2, 12, 20, 4, 1, 8, 0, False),          # non-causal, MQA
    (1, 33, 17, 4, 2, 16, 0, True),          # ragged keys, causal
    (1, 5, 37, 2, 2, 8, 0, False),           # ragged keys, non-causal
    (1, 40, 8, 2, 2, 8, 4, True),            # rows 11.. keep no key
    (1, 30, 10, 2, 1, 8, 3, False),          # the same without causal
]
IDS = [f"{b}x{sq}x{skv}_h{h}kv{kv}_d{hd}_w{w}_{'c' if c else 'nc'}"
       for b, sq, skv, h, kv, hd, w, c in CASES]


def _inputs(b, sq, skv, h, kv, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd),
                      (b, sq, h, hd))]
    if dtype == "bfloat16":     # round once, the same words on both sides
        arrs = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    return arrs


def _ref_grads(arrs, dtype, window, causal, round_to=None):
    """The reference's VJP in ``dtype``; with ``round_to``, each
    gradient rounded once to that type."""
    t = getattr(jnp, dtype)
    q, k, v, do = (jnp.asarray(a, t) for a in arrs)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash(
        q_, k_, v_, window=window, causal=causal, target="lax"), q, k, v)
    grads = vjp(do)
    if round_to is not None:
        grads = [g.astype(getattr(jnp, round_to)) for g in grads]
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(arrs, dtype, window, causal):
    t = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(t).requires_grad_() for a in arrs[:3])
    out = flash_attention(q, k, v, window=window, causal=causal)
    assert out.grad_fn is not None and out.dtype == t
    grads = torch.autograd.grad(out, (q, k, v),
                                torch.from_numpy(arrs[3]).to(t))
    assert all(g.dtype == t for g in grads)
    return grads


def _rel(out, ref) -> float:
    return float(np.abs(out.float().numpy() - ref).max()
                 / np.abs(ref).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_attention_grads_match_reference_f32(case):
    b, sq, skv, h, kv, hd, window, causal = case
    arrs = _inputs(b, sq, skv, h, kv, hd, "float32")
    ref = _ref_grads(arrs, "float32", window, causal)
    for g, r in zip(_port_grads(arrs, "float32", window, causal), ref):
        assert _rel(g, r) <= 1e-5


def _bf16_gate(g, r) -> float:
    return within(g, torch.from_numpy(r), torch.bfloat16)["worst_over_tol"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_attention_grads_match_reference_bf16(case):
    b, sq, skv, h, kv, hd, window, causal = case
    arrs = _inputs(b, sq, skv, h, kv, hd, "bfloat16", seed=1)
    port = _port_grads(arrs, "bfloat16", window, causal)
    refs = [_ref_grads(arrs, "float32", window, causal, round_to="bfloat16")]
    if h == kv:
        refs.append(_ref_grads(arrs, "bfloat16", window, causal))
    for ref in refs:
        for g, r in zip(port, ref):
            assert _bf16_gate(g, r) <= 1.0


@pytest.mark.parametrize("case", [c for c in CASES if c[3] > c[4]],
                         ids=[i for c, i in zip(CASES, IDS) if c[3] > c[4]])
def test_gqa_bf16_grads_sum_each_group_in_f32(case):
    """The port's bf16 dk and dv lie no farther from the reference's f32
    math than the reference's own bf16 VJP, which rounds each query
    head's share before summing the group."""
    b, sq, skv, h, kv, hd, window, causal = case
    arrs = _inputs(b, sq, skv, h, kv, hd, "bfloat16", seed=1)
    exact = _ref_grads(arrs, "float32", window, causal)
    ref16 = _ref_grads(arrs, "bfloat16", window, causal)
    port = _port_grads(arrs, "bfloat16", window, causal)
    for g, r, e in zip(port[1:], ref16[1:], exact[1:]):
        assert np.abs(g.float().numpy() - e).max() <= np.abs(r - e).max()


def test_query_panels_give_the_same_gradients(monkeypatch):
    """A backward over many small query panels (each skipping the key
    tiles it cannot reach) equals the one-panel backward."""
    arrs = _inputs(2, 150, 150, 4, 2, 8, "float32", seed=2)
    whole = _port_grads(arrs, "float32", 20, True)
    monkeypatch.setattr(B, "PANEL_SCORES", 2 * 4 * 150 * 3)
    panels = _port_grads(arrs, "float32", 20, True)
    for a, b in zip(whole, panels):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_forward_under_autograd_equals_the_plain_call():
    arrs = _inputs(2, 24, 24, 8, 2, 16, "float32", seed=3)
    q, k, v = (torch.from_numpy(a) for a in arrs[:3])
    plain = flash_attention(q, k, v, window=5)
    assert plain.grad_fn is None
    out = flash_attention(q.requires_grad_(), k, v, window=5)
    assert type(out.grad_fn).__name__ == Attention.__name__ + "Backward"
    assert torch.equal(out.detach(), plain)


def test_a_mask_one_key_off_misses_the_gate(monkeypatch):
    """The control the chip smoke runs: the backward's causal mask
    keeping key q + 1 moves the gradients far past 1e-5."""
    good = B.panel_mask

    def one_key_off(q0, q1, lo, hi, *, window, causal, device):
        mask = good(q0, q1, lo, hi, window=window, causal=False,
                    device=device)
        if causal:
            mask &= (torch.arange(lo, hi)[None, :]
                     <= torch.arange(q0, q1)[:, None] + 1)
        return mask
    arrs = _inputs(2, 24, 24, 8, 2, 16, "float32")
    ref = _ref_grads(arrs, "float32", 0, True)
    monkeypatch.setattr(B, "_key_range", lambda q0, q1, skv, w, c: (0, skv))
    monkeypatch.setattr(B, "panel_mask", one_key_off)
    errs = [_rel(g, r) for g, r in zip(
        _port_grads(arrs, "float32", 0, True), ref)]
    assert min(errs[:2]) > 100 * 1e-5, errs


# ------------------------------------------------------ the entry points

def test_trainer_cli_runs_on_the_cpu_and_its_loss_falls(tmp_path, capsys):
    train_cli.main(["--device", "cpu", "--reduced", "--steps", "20",
                    "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert "done: 20 steps" in out and "(0 restarts)" in out
    assert len(losses) == 5 and losses[-1] < losses[0]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir())[-1] \
        == "step_00000020"


def test_quickstart_example_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", REPO / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    hits = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.strip().startswith("step")]
    assert losses[-1] < losses[0] - 1.0
    assert "greedy continuation" in out and hits >= 4


def test_train_100m_example_config_is_the_references():
    """The example's config, ``examples/train_100m.py``'s member of the
    minitron family (75.5M parameters by ``param_count``)."""
    spec = importlib.util.spec_from_file_location(
        "train_100m_torch", REPO / "examples" / "train_100m_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = mod.config()
    ref = dataclasses.replace(
        jax_get_config("minitron-4b"), n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=2048, vocab=32768, head_dim=64, attn_chunk=256)
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if "dtype" not in f.name} == \
        {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)
         if "dtype" not in f.name}
    assert cfg.param_count() == ref.param_count() == 75_510_528
