"""The port's sibling examples against the reference's on the CPU.

``examples/accelerator_analysis_torch.py`` prints, for each argv set,
every line of ``examples/accelerator_analysis.py`` before its
adaptation section, character for character, and the reference's
matmul block (bm, bn, bk); the layer it runs through ``conv2d_lb`` (the
plain version here) lies within 1e-5 of max |ref| of the reference's
``conv2d_ref`` on the same numpy inputs.

``examples/serve_batched_torch.py``'s serving function, on a one-rank
gloo mesh with the reference's params carried across
(``repro_torch.convert``), serves the same tokens as the reference's
mesh-free ``BatchedServer`` (driven as ``test_torch_lm_serve.py``
drives it: the reference's own server cannot be built under the
installed JAX) on the same prompts, for the reference example's reduced
mixtral-8x7b and for minitron-4b at the reference test's argv (2
requests, 2 slots, 2 new tokens); each step's logits over the real
vocabulary lie within 1e-5 of max |ref|.

Both siblings' ``main`` runs with ``--device cpu``, and raises without a
card and without it.  ``repro_torch.core`` exports every name that
``repro.core`` exports.
"""

import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro_torch.core as torch_core
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.tpu_adapter import lb_block_shape as jax_lb_block_shape
from repro.kernels.conv_lb.ref import conv2d_ref as jax_conv2d_ref
from repro.launch import serve as jax_serve
from repro.models.api import build as jax_build
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_numpy

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def analysis():
    return _load("accelerator_analysis_torch")


@pytest.fixture(scope="module")
def serving():
    return _load("serve_batched_torch")


# ------------------------------------------------------------- the exports

def test_core_exports_every_name_the_reference_core_exports():
    missing = [n for n in jax_core.__all__ if n not in torch_core.__all__
               or not hasattr(torch_core, n)]
    assert not missing
    from repro_torch.core import BlockShape, lb_block_shape
    assert lb_block_shape(9408, 256, 1152) == BlockShape(4096, 256, 512)


@pytest.mark.parametrize("mnk", [(9408, 256, 1152), (2352, 256, 1152),
                                 (784, 128, 1600), (100, 1000, 64),
                                 (65536, 4096, 4096)])
def test_lb_block_shape_is_the_references(mnk):
    ours = torch_core.lb_block_shape(*mnk)
    ref = jax_lb_block_shape(*mnk)
    assert (ours.bm, ours.bn, ours.bk) == (ref.bm, ref.bn, ref.bk)


# ------------------------------------------------ accelerator_analysis

ANALYSIS_ARGV = {
    "defaults": [],
    "stride2": ["--stride", "2"],
    "k5": ["--k", "5", "--hw", "28", "--batch", "1", "--ci", "64",
           "--co", "128", "--s-kb", "128"],
}
BLOCK = re.compile(r"bm=(\d+) bn=(\d+) bk=(\d+)")


@pytest.mark.parametrize("case", list(ANALYSIS_ARGV))
def test_analysis_prints_the_references_lines(case, analysis, monkeypatch,
                                              capsys):
    argv = ANALYSIS_ARGV[case]
    ref_mod = _load("accelerator_analysis")
    monkeypatch.setattr(sys, "argv", ["accelerator_analysis.py", *argv])
    ref_mod.main()
    ref = capsys.readouterr().out.splitlines()
    got = analysis.main([*argv, "--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()

    cut_ref = ref.index(next(l for l in ref
                             if l.startswith("TPU adaptation")))
    cut = ours.index(next(l for l in ours
                          if l.startswith(analysis.ADAPTATION)))
    assert cut == cut_ref and ours[:cut] == ref[:cut_ref]
    assert BLOCK.search(ours[cut + 1]).groups() \
        == BLOCK.search(ref[cut_ref + 1]).groups()
    assert (got["block"].bm, got["block"].bn, got["block"].bk) == tuple(
        int(g) for g in BLOCK.search(ref[cut_ref + 1]).groups())
    assert any(l.startswith("  conv plan (plan_conv, f32): ") for l in ours)
    assert f"  K1 on the card, f32: route {got['route']}, tile " in "\n".join(
        ours)
    assert got["route"] == "sm90_tf32"
    ran = [l for l in ours if l.startswith(analysis.RAN)]
    assert ran == [ours[-1]] and "cpu: route plain, out " in ran[0]
    assert got["ran"] == "plain"

    x, w = got["x"].numpy(), got["w"].numpy()
    want = np.asarray(jax_conv2d_ref(x, w, stride=got["stride"],
                                     padding=got["padding"]))
    out = got["out"].numpy()
    assert out.shape == want.shape
    assert np.abs(out - want).max() <= 1e-5 * np.abs(want).max()


def test_analysis_layer_check_sees_a_flipped_window(analysis, capsys):
    """The control: the same layer with the weights' kernel window
    flipped misses the 1e-5 gate by far."""
    got = analysis.main(["--k", "3", "--hw", "14", "--batch", "1",
                         "--ci", "16", "--co", "32", "--device", "cpu"])
    capsys.readouterr()
    x, w = got["x"].numpy(), got["w"].numpy()
    wrong = np.asarray(jax_conv2d_ref(x, w[::-1, ::-1].copy(),
                                      stride=got["stride"],
                                      padding=got["padding"]))
    out = got["out"].numpy()
    assert np.abs(out - wrong).max() > 1e-2 * np.abs(wrong).max()


# ------------------------------------------------------- serve_batched

SERVE_ARCHS = ("mixtral-8x7b", "minitron-4b")
SLOTS, REQUESTS, GEN = 2, 2, 2


def _reference_server(jcfg, jparams, max_seq: int, record: list):
    """The reference's ``BatchedServer`` with no mesh, each decode's
    logits appended to ``record`` (as ``test_torch_lm_serve.py``)."""
    api = jax_build(jcfg, tp=1)
    decode = jax.jit(api.decode_step)

    def recorded(params, caches, tok, pos):
        logits, caches = decode(params, caches, tok, pos)
        record.append(np.asarray(logits))
        return logits, caches

    server = object.__new__(jax_serve.BatchedServer)
    server.cfg, server.mesh = jcfg, None
    server.slots, server.max_seq = SLOTS, max_seq
    server.api, server.rules = api, {}
    server.params = jparams
    server.caches = api.init_cache(SLOTS, max_seq)
    server._decode = recorded
    server.active, server.queue, server.pos = {}, [], 0
    return server


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_served_tokens_match_the_reference_server(arch, serving, capsys):
    jcfg = jax_reduced(jax_get_config(arch), capacity_factor=8.0)
    cfg = reduced(get_config(arch), capacity_factor=8.0)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")

    reqs = serving.make_requests(cfg, REQUESTS, GEN)
    record = []
    ref = _reference_server(jcfg, jparams, serving.MAX_SEQ, record)
    ref_reqs = [jax_serve.Request(rid=r.rid, prompt=list(r.prompt),
                                  max_new=r.max_new) for r in reqs]
    for r in ref_reqs:
        ref.submit(r)
    steps = 0
    while (ref.active or ref.queue) and steps < serving.MAX_STEPS:
        ref.step()
        steps += 1

    trace = []
    with serving.host_mesh(torch.device("cpu")) as mesh:
        assert dict(mesh.shape) == {"data": 1, "model": 1}
        out = serving.serve(cfg, mesh, params, reqs, slots=SLOTS,
                            device="cpu", trace=trace)
    assert not torch.distributed.is_initialized()
    assert out is reqs
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert all(r.done and len(r.out) == GEN for r in reqs)
    assert len(trace) == len(record) == steps
    for (_caches, _tok, pos, logits), want in zip(trace, record):
        got, want = logits.numpy()[..., :cfg.vocab], want[..., :cfg.vocab]
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), pos
    printed = capsys.readouterr().out
    assert f"served {REQUESTS} requests / {REQUESTS * GEN} tokens in " \
        in printed


# --------------------------------------------------------- the mains

def test_serve_example_main_on_the_cpu(serving, capsys):
    reqs = serving.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu"
    assert any(l.startswith("served 8 requests / 96 tokens in ")
               and l.endswith(" tok/s, 4 slots, 29 decode steps)")
               for l in lines)
    assert [l for l in lines if l.startswith("  req ")] == [
        f"  req {r.rid}: {r.out}" for r in reqs[:3]]
    assert all(r.done and len(r.out) == 12 for r in reqs)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("name", ["accelerator_analysis_torch",
                                  "serve_batched_torch"])
def test_examples_raise_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main([])
