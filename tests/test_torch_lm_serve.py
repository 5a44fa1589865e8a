"""The port's continuous-batching ``BatchedServer`` on the CPU against the
reference's, on the same weights and requests.

The reference's server cannot be built as it is under the installed JAX
(its mesh's sharding constraints raise inside ``constrain``), so the
reference side here is its own ``BatchedServer.step`` driven mesh-free:
the object made without ``__init__``, with no axis rules and no mesh
(``constrain`` is then a no-op), its decode the reference's
``build(cfg).decode_step`` under ``jax.jit``, its params the ones the
port gets through ``repro_torch.convert``.  Both run the reference's
``test_serve_continuous_batching`` scenario (phi3 reduced to d_model 32,
vocab 64, one layer; 2 slots, max_seq 48, 4 requests of 3 prompt tokens
and 4 new ones): every step feeds the same tokens, its logits over the
real vocabulary agree within 1e-5 of their max |ref| (the 192 padded
columns, -1e30 on both sides, left out; a control moves one real logit
by 1e-4 of that max, which the gate must see), its greedy tokens are
equal, every request
completes and freed slots are reused.  The same for reduced mixtral
(capacity factor 8.0, as the reference's ``main --reduced``), mamba2
and jamba: a reused slot's SSM state and conv tail carry over from its
previous request on both sides, as its KV entries do; deepseek-7b (kept
MHA), minitron-4b, llava-next-34b (text only), granite-34b at its 48:1
grouping and dbrx-132b at 16 experts and top-4 (capacity factor 8.0,
and 1.25, where decode steps drop pairs); and whisper-medium
(decode only, its cross-attention over the cache's zero slots).  Then
the CLI on the CPU, also with ``--arch mixtral-8x7b`` and ``--arch
whisper-medium``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import serve as jax_serve
from repro.models.api import build as jax_build
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import moe as moe_mod

REPO = Path(__file__).resolve().parent.parent
SCENARIO = dict(d_model=32, vocab=64, n_layers=1, attn_chunk=32)
SLOTS, MAX_SEQ = 2, 48


def _reference_server(jcfg, jparams, record):
    """The reference's ``BatchedServer`` with no mesh, each decode's
    tokens, position and logits appended to ``record``."""
    api = jax_build(jcfg, tp=1)
    decode = jax.jit(api.decode_step)

    def recorded(params, caches, tok, pos):
        logits, caches = decode(params, caches, tok, pos)
        record.append((np.asarray(tok), int(pos), np.asarray(logits)))
        return logits, caches

    server = object.__new__(jax_serve.BatchedServer)
    server.cfg, server.mesh = jcfg, None
    server.slots, server.max_seq = SLOTS, MAX_SEQ
    server.api, server.rules = api, {}
    server.params = jparams
    server.caches = api.init_cache(SLOTS, MAX_SEQ)
    server._decode = recorded
    server.active, server.queue, server.pos = {}, [], 0
    return server


def _requests(cls):
    return [cls(rid=rid, prompt=[1 + rid, 2, 3], max_new=4)
            for rid in range(4)]


def _drive(server, reqs, slots_seen):
    for r in reqs:
        server.submit(r)
    steps = 0
    while (server.active or server.queue) and steps < MAX_SEQ:
        out = server.step()
        slots_seen.append({s: r.rid for s, r in server.active.items()})
        steps += 1
        yield out


def test_serve_continuous_batching_matches_the_reference_server():
    _serve_against_reference("phi3-medium-14b")


def test_serve_encdec_matches_the_reference_server():
    """whisper-medium as both servers serve it: decode steps only, from
    ``init_cache`` (cross-attention over 1500 zero slots)."""
    _serve_against_reference("whisper-medium")


#: each case's arch and its overrides of ``SCENARIO`` on both sides:
#: capacity factor 8.0 (the reference's ``main --reduced``) unless the
#: case sets its own; deepseek kept MHA (``reduced`` would give it 4
#: heads over 2), granite at its real 48:1 grouping, dbrx at its 16
#: experts and top-4, also at its published capacity factor 1.25, where a
#: decode step's 2 tokens route 8 pairs into bins of 1 row and pairs drop
SERVE_CASES = {
    "mixtral-8x7b": ("mixtral-8x7b", {}),
    "mamba2-1.3b": ("mamba2-1.3b", {}),
    "jamba-1.5-large-398b": ("jamba-1.5-large-398b", {}),
    "deepseek-7b": ("deepseek-7b", dict(n_kv_heads=4)),
    "minitron-4b": ("minitron-4b", {}),
    "llava-next-34b": ("llava-next-34b", {}),
    "granite-34b": ("granite-34b", dict(n_heads=48, n_kv_heads=1,
                                        head_dim=8)),
    "dbrx-132b": ("dbrx-132b", dict(n_experts=16, top_k=4)),
    "dbrx-132b-cf1.25": ("dbrx-132b", dict(n_experts=16, top_k=4,
                                           capacity_factor=1.25)),
}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_serve_moe_ssm_hybrid_matches_the_reference_server(case,
                                                           monkeypatch):
    """The MoE, SSM and hybrid archs, and the dense and VLM configs
    beyond phi3 (llava text only, as both servers serve it).  At dbrx's
    published capacity factor the port's decode steps must have dropped
    pairs, or that case would not test the drops."""
    arch, overrides = SERVE_CASES[case]
    dropped = []
    dispatch = moe_mod.moe_dispatch_local

    def counting(x, gates, idx, n_experts, capacity):
        bins, slot = dispatch(x, gates, idx, n_experts, capacity)
        dropped.append(int((slot == n_experts * capacity).sum()))
        return bins, slot
    monkeypatch.setattr(moe_mod, "moe_dispatch_local", counting)
    _serve_against_reference(arch, **{"capacity_factor": 8.0, **overrides})
    if overrides.get("capacity_factor", 8.0) < 8.0:
        assert sum(dropped) > 0
    else:
        assert not any(dropped)


def _serve_against_reference(arch, **overrides):
    jcfg = jax_reduced(jax_get_config(arch), **SCENARIO, **overrides)
    cfg = reduced(get_config(arch), **SCENARIO, **overrides)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  device="cpu")
    record = []
    ref = _reference_server(jcfg, jparams, record)
    ref_reqs = _requests(jax_serve.Request)
    list(_drive(ref, ref_reqs, []))

    server = BatchedServer(cfg, slots=SLOTS, max_seq=MAX_SEQ, device="cpu",
                           params=params)
    reqs = _requests(Request)
    seen = []
    steps = list(_drive(server, reqs, seen))

    assert len(steps) == len(record) == server.pos
    for pos, ((tok, logits), (ref_tok, ref_pos, ref_logits)) in enumerate(
            zip(steps, record)):
        assert pos == ref_pos
        np.testing.assert_array_equal(tok.numpy(), ref_tok)
        assert _logits_within(logits.numpy(), ref_logits, cfg.vocab), pos
        np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                      ref_logits.argmax(-1))
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert all(r.done and len(r.out) >= 4 for r in reqs)
    assert not server.active and not server.queue
    # freed slots were reused: each slot served more than one request
    served = {}
    for active in seen:
        for slot, rid in active.items():
            served.setdefault(slot, set()).add(rid)
    assert sorted(served) == [0, 1]
    assert all(len(rids) >= 2 for rids in served.values())
    return steps, record, cfg


def _logits_within(logits, ref_logits, vocab: int) -> bool:
    """The real vocabulary's logits within 1e-5 of its max |ref|.  The
    padded columns hold -1e30 on both sides; a max over them would set
    the gate at 1e25."""
    out, ref = logits[..., :vocab], ref_logits[..., :vocab]
    return np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_logit_gate_sees_one_real_logit():
    """The control: the first served step's logits with one real logit
    moved by 1e-4 of max |ref| fail the gate over the real vocabulary
    and pass the old one over the padded row."""
    steps, record, cfg = _serve_against_reference("phi3-medium-14b")
    ref = record[0][2]
    assert ref.shape[-1] > cfg.vocab and (ref[..., cfg.vocab:] == -1e30).all()
    wrong = steps[0][1].numpy().copy()
    wrong[0, cfg.vocab // 2] += 1e-4 * np.abs(ref[..., :cfg.vocab]).max()
    assert not _logits_within(wrong, ref, cfg.vocab)
    assert np.abs(wrong - ref).max() <= 1e-5 * np.abs(ref).max()


def test_server_draws_its_own_weights_from_a_seed():
    cfg = reduced(get_config("phi3-medium-14b"), **SCENARIO)
    a = BatchedServer(cfg, slots=SLOTS, max_seq=8, device="cpu", seed=3)
    b = BatchedServer(cfg, slots=SLOTS, max_seq=8, device="cpu", seed=3)
    wq = a.params["blocks"][0]["sub0"]["attn"]["wq"]
    assert wq.dtype == cfg.compute_dtype
    assert all(np.array_equal(x["sub0"]["attn"]["wq"].numpy(),
                              y["sub0"]["attn"]["wq"].numpy())
               for x, y in zip(a.params["blocks"], b.params["blocks"]))
    assert a.step() is None      # nothing submitted, nothing run


def test_serve_cli_on_the_cpu():
    _cli_on_the_cpu([])


def test_serve_cli_mixtral_on_the_cpu():
    _cli_on_the_cpu(["--arch", "mixtral-8x7b"])


def test_serve_cli_whisper_on_the_cpu():
    _cli_on_the_cpu(["--arch", "whisper-medium"])


def _cli_on_the_cpu(args):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--requests", "3", "--gen", "4", *args],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-2] == "cpu"
    assert lines[-1].startswith("served 3 requests, 12 tokens in ")
    assert lines[-1].endswith("over 11 steps")
