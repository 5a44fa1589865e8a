"""The port's dry-run on the ``meta`` device (``repro_torch.launch.dryrun``)
and what it reads, against the reference's:

  * ``ModelAPI.input_specs``: every arch x shape, full size, the shapes
    and types of the reference's ``ShapeDtypeStruct``s (its stacked
    caches against the port's per-block ones);
  * ``ModelAPI.make_batch``: deterministic per seed, in range, in type;
  * ``analysis.memory_model``: ``sharded_bytes_per_chip`` of every debug
    cell's state and inputs (and five full-size cells), on the (2, 4)
    mesh and a (2, 2, 2) multi-pod one, equal to the reference's under
    its own shardings on 8 forced host devices
    (``tests/_jax_dryrun_ref.py`` in a process of its own);
    ``activation_allowance`` and ``model_flops_*`` equal to the
    reference's;
  * the counts: phi3 at reduced widths on (2, 4), one rank's FLOPs x 8
    within 2% of the (1, 1) count (work split, not duplicated);
  * one production cell, mamba2-1.3b x train_4k on (16, 16), end to
    end in a subprocess (the ``"fake"`` process group of 256 ranks);
  * ``ShardPlan``/``balanced_shard_plan`` equal to the reference's over
    a grid of (m, n, chips, r).
"""

import collections
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import memory_model as jax_mm
from repro.analysis import roofline as jax_rl
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.core import tpu_adapter
from repro.configs import reduced as jax_reduced
from repro.models.api import build as jax_build
from repro_torch.analysis import memory_model as mm
from repro_torch.analysis import roofline as rl
from repro_torch.configs import (ARCHS, SHAPES, applicable_shapes,
                                 get_config, reduced)
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import ShardPlan, balanced_shard_plan
from repro_torch.launch import dryrun as D
from repro_torch.models.api import build
from repro_torch.parallel import sharding as sh

REPO = Path(__file__).resolve().parent.parent
CELLS = [(a, s) for a in ARCHS for s in applicable_shapes(get_config(a))]
#: full-size cells beside the debug ones
FULL = [("phi3-medium-14b", "train_4k"), ("mamba2-1.3b", "decode_32k"),
        ("jamba-1.5-large-398b", "decode_32k"),
        ("mixtral-8x7b", "prefill_32k"), ("whisper-medium", "decode_32k")]
MESHES = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
#: every arch's decode cells, full size and debug, as ``--optimized``
#: builds them
OPTIMIZED = [(a, s, debug) for a, s in CELLS if SHAPES[s].kind == "decode"
             for debug in (False, True)]


class _Mesh:
    """A mesh's axis sizes, all the memory model and the rules read."""

    def __init__(self, dims, names):
        self.shape = collections.OrderedDict(zip(names, dims))
        self.axis_names = names


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _compare(port, ref, path=""):
    """The port's tree (per-block caches) against the reference's
    (stacked): the same names, shapes and types."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), (path, set(port), set(ref))
        for k in ref:
            _compare(port[k], ref[k], f"{path}/{k}")
        return
    if isinstance(port, list):                       # the stacked blocks
        assert ref.shape[0] == len(port), path
        for block in port:
            _compare(block, jax.ShapeDtypeStruct(ref.shape[1:], ref.dtype),
                     path)
        return
    assert tuple(port.shape) == tuple(ref.shape), (path, port.shape,
                                                   ref.shape)
    assert _dtype(port) == np.dtype(ref.dtype).name, (path, port.dtype,
                                                      ref.dtype)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    """Full size: the port's ``meta`` tensors (and ``pos`` vectors) have
    the reference's shapes and types."""
    tp = 16
    got = build(get_config(arch), tp=tp).input_specs(SHAPES[shape])
    want = jax_build(jax_get_config(arch), tp=tp).input_specs(
        JAX_SHAPES[shape])
    assert set(got) == set(want)
    for name, ref in want.items():
        if name == "caches":
            # the reference stacks the blocks: compare block by block
            blocks = got["caches"]
            for sub, leaves in ref.items():
                port = [b[sub] for b in blocks]
                if isinstance(leaves, dict):
                    for n, leaf in leaves.items():
                        _compare([p[n] for p in port], leaf, f"{sub}/{n}")
                else:
                    _compare(port, leaves, sub)
            continue
        _compare(got[name], ref, name)
        assert got[name].device.type == "meta"


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_make_batch_is_deterministic_per_seed(shape):
    from repro_torch.configs import reduced
    api = build(reduced(get_config("jamba-1.5-large-398b")), tp=1)
    small = SHAPES[shape].__class__(shape, 16, 2, SHAPES[shape].kind)
    a, b, c = (api.make_batch(torch.Generator().manual_seed(s), small)
               for s in (7, 7, 8))
    flat = [jax.tree_util.tree_leaves(t) for t in (a, b, c)]
    specs = jax.tree_util.tree_leaves(api.input_specs(small))
    assert len(flat[0]) == len(specs)
    differs = False
    for x, y, z, spec in zip(*flat, specs):
        x, y, z = (torch.as_tensor(t) for t in (x, y, z))
        assert torch.equal(x, y)
        assert tuple(x.shape) == tuple(spec.shape)
        assert _dtype(x) == _dtype(spec)
        if x.dim() == 0:
            assert int(x) == 0
        elif not x.is_floating_point():
            assert int(x.min()) >= 0 and int(x.max()) < api.cfg.vocab
        differs |= x.numel() > 1 and not torch.equal(x, z)
    assert differs


@pytest.fixture(scope="module")
def reference_bytes(tmp_path_factory):
    work = tmp_path_factory.mktemp("dryrun_ref")
    cells = [(a, s, dims, names, True) for dims, names in MESHES
             for a, s in CELLS] + \
        [(a, s, (2, 4), ("data", "model"), False) for a, s in FULL]
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"cells": cells, "optimized": OPTIMIZED}, f)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(
        REPO / "src"), "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    ref = subprocess.run([sys.executable, str(REPO / "tests" /
                                              "_jax_dryrun_ref.py"),
                          str(work / "inputs.pkl"), str(work / "out.pkl")],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert ref.returncode == 0, ref.stderr[-3000:]
    with open(work / "out.pkl", "rb") as f:
        out = pickle.load(f)
    return {"cells": dict(zip(cells, out["cells"])),
            "optimized": dict(zip(OPTIMIZED, out["optimized"]))}


def test_sharded_bytes_match_reference(reference_bytes):
    """Every cell's state (params or train state, caches) and inputs, per
    chip, equal to the reference's to the byte."""
    for (arch, shape_name, dims, names, debug), want in \
            reference_bytes["cells"].items():
        mesh = _Mesh(dims, names)
        cfg, shape = D.cell_config(arch, shape_name, debug)
        api = build(cfg, tp=mesh.shape["model"])
        rules = sh.axis_rules(mesh, shape.global_batch, shape.seq_len)
        inputs = api.input_specs(shape)
        state = sum(mm.sharded_bytes_per_chip(tree, specs, mesh)
                    for tree, specs in D.state_memo(api, shape, rules,
                                                    inputs).values())
        got_inputs = 0 if shape.kind == "decode" else \
            mm.sharded_bytes_per_chip(inputs, sh.batch_specs(
                inputs, mesh, rules), mesh)
        cell = (arch, shape_name, dims, debug)
        assert (state, got_inputs) == (want["state"], want["inputs"]), cell


def test_optimized_decode_takes_the_reference_f8_cache(reference_bytes):
    """``--optimized``: every decode cell, full size and debug, has the
    reference's exact heads and f8 KV cache, and its params and caches
    per chip on the (2, 4) mesh under the ``sp_rs`` rules equal the
    reference's to the byte."""
    mesh = _Mesh((2, 4), ("data", "model"))
    for (arch, shape_name, debug), want in \
            reference_bytes["optimized"].items():
        cfg, shape = D.cell_config(arch, shape_name, debug, optimized=True)
        cell = (arch, shape_name, debug)
        assert want["kv_cache_dtype"] == "float8_e4m3fn", cell
        assert cfg.pad_heads == want["pad_heads"], cell
        assert str(cfg.kv_cache_dtype).removeprefix("torch.") == \
            want["kv_cache_dtype"], cell
        api = build(cfg, tp=mesh.shape["model"])
        rules = sh.axis_rules(mesh, shape.global_batch, shape.seq_len,
                              sp_rs=True)
        memo = D.state_memo(api, shape, rules)
        got = {k: mm.sharded_bytes_per_chip(*memo[k], mesh)
               for k in ("params", "caches")}
        assert got == {k: want[k] for k in got}, cell


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "mixtral-8x7b"])
def test_optimized_f8_cache_decode_chain_matches_reference(arch):
    """The ``--optimized`` cache type at ``reduced()`` size: 6 decode
    steps from an empty f8 ``init_cache`` (the port casts the kept slots
    to q's type before K4), each step's logits within 1e-5 of max |ref|
    of the reference's on the same weights, its cache's f8 bytes equal
    the reference's."""
    f8 = D.cell_config(arch, "decode_32k", debug=True,
                       optimized=True)[0].kv_cache_dtype
    jcfg = jax_reduced(jax_get_config(arch),
                       kv_cache_dtype=jnp.float8_e4m3fn)
    cfg = reduced(get_config(arch), kv_cache_dtype=f8)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    japi, api = jax_build(jcfg), build(cfg)
    b, steps = 2, 6
    ref_caches = japi.init_cache(b, 16)
    caches = api.init_cache(b, 16, device="cpu")
    assert caches[0]["sub0"]["k"].dtype == torch.float8_e4m3fn
    rng = np.random.default_rng(11)
    for pos in range(steps):
        tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        ref, ref_caches = japi.decode_step(jparams, ref_caches,
                                           jnp.asarray(tok),
                                           jnp.asarray(pos, jnp.int32))
        logits, caches = api.decode_step(params, caches,
                                         torch.from_numpy(tok), pos)
        ref = np.asarray(ref, np.float64)
        err = np.abs(logits.double().numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (pos, err)
    for sub, leaves in jax.tree_util.tree_map(np.asarray,
                                              ref_caches).items():
        for name in ("k", "v"):
            port = np.stack([block[sub][name].view(torch.uint8).numpy()
                             for block in caches])
            np.testing.assert_array_equal(port, leaves[name].view(np.uint8))


@pytest.mark.parametrize("dims,names", MESHES + [((16, 16),
                                                  ("data", "model"))])
def test_activation_allowance_and_model_flops_match_reference(dims, names):
    mesh = _Mesh(dims, names)
    chips = int(np.prod(dims))
    for arch, shape_name in CELLS:
        for debug in (False, True):
            cfg, shape = D.cell_config(arch, shape_name, debug)
            jcfg = jax_get_config(arch)
            if debug:
                from repro.configs import reduced as jax_reduced
                jcfg = jax_reduced(jcfg, d_model=128, n_layers=2 * max(
                    1, jcfg.attn_every or 1), head_dim=32, vocab=512,
                    attn_chunk=64)
            args = (shape.seq_len, shape.global_batch, mesh, shape.kind)
            assert mm.activation_allowance(cfg, *args) == \
                jax_mm.activation_allowance(jcfg, *args)
            b, s = shape.global_batch, shape.seq_len
            assert rl.model_flops_train(cfg, s, b, chips) == \
                jax_rl.model_flops_train(jcfg, s, b, chips)
            assert rl.model_flops_prefill(cfg, s, b, chips) == \
                jax_rl.model_flops_prefill(jcfg, s, b, chips)
            assert rl.model_flops_decode(cfg, b, chips) == \
                jax_rl.model_flops_decode(jcfg, b, chips)


def _counted(dims, names, shape_name):
    cfg, shape = D.cell_config("phi3-medium-14b", shape_name, debug=True)
    with D.fake_world(int(np.prod(dims))):
        mesh = D.Mesh(dims, names, "meta")
        api = build(cfg, tp=4)
        rules = sh.axis_rules(mesh, shape.global_batch, shape.seq_len)
        counts, *_ = D.run_cell(api, shape, mesh, rules)
    return counts


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_work_is_split_not_duplicated(shape):
    """phi3 at reduced widths, the tp-4 model (its padded heads): one
    rank of (2, 4) counts, x 8, within 2% of the (1, 1) mesh's count of
    the same model whole; the collectives run only where an axis is
    above 1."""
    one = _counted((1, 1), ("data", "model"), shape)
    rank = _counted((2, 4), ("data", "model"), shape)
    assert abs(8 * rank["flops"] - one["flops"]) <= 0.02 * one["flops"], \
        (rank["flops"], one["flops"])
    assert one["collectives"] == {} and rank["collectives"]
    assert rank["bytes"] < one["bytes"]


def test_a_production_cell_runs_end_to_end(tmp_path):
    """mamba2-1.3b x train_4k on the (16, 16) mesh: one rank of 256 over
    the fake group, every Mamba mixer over the model axis of 16."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-1.3b", "--shape", "train_4k", "--mesh", "single",
         "--json", "--out", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=600, cwd=str(REPO))
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    rec = json.loads((tmp_path / "mamba2-1.3b_train_4k_single.json")
                     .read_text())
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    cfg = get_config("mamba2-1.3b")
    assert rec["model_flops_per_chip"] == rl.model_flops_train(
        cfg, 4096, 256, 256)
    # counted work at least the model's (remat recomputes the forward)
    assert rec["flops_per_chip"] >= rec["model_flops_per_chip"]
    assert rec["coll_detail"]["all_gather"] > 0
    assert rec["memory_analysis"] is None
    assert 0 < rec["analytic_memory_gb"] < 80


def test_shard_plan_matches_reference():
    for m in (1, 7, 64, 100, 4096, 12288):
        for n in (1, 9, 128, 300, 8192):
            for chips in (1, 2, 4, 6, 8, 16, 256, 512):
                for r in (0.25, 1.0, 3.0):
                    got = balanced_shard_plan(m, n, chips, r)
                    want = tpu_adapter.balanced_shard_plan(m, n, chips, r)
                    assert isinstance(got, ShardPlan)
                    assert (got.m_shards, got.n_shards) == \
                        (want.m_shards, want.n_shards)
                    assert got.per_chip_tile(m, n) == \
                        want.per_chip_tile(m, n)
