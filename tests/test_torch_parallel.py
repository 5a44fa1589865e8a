"""The port's ``parallel/``, ``launch/mesh.py`` and ``runtime/elastic.py``
against the reference's.

Spec tables, against the reference's own functions: ``_param_spec`` on
every leaf of every arch's ``reduced()`` params at tp 4 (fsdp on and
off, ``moe_ep_data``), walked with ``tree_map_with_path`` over
``jax.eval_shape`` of the reference's init, and the port's
``param_specs`` over its own per-block tree; ``axis_rules``,
``batch_axes_for`` and ``data_axes`` on meshes (2, 4), (1, 8) and
(2, 2, 2) with ``pod`` at batches 1, 6, 8 and 64 (a stand-in mesh
exposing ``shape`` and ``axis_names``, all the reference reads);
``_cache_spec``, ``batch_specs`` and ``decode_output_specs``;
``plan_remesh`` and ``make_mesh_for`` over 1-64 devices x tp {1, 2, 4,
8, 16} (the counterpart of ``tests/test_substrates.py::
test_elastic_plan_remesh``).

On one (2, 4) gloo group of 8 spawned CPU ranks
(``tests/_torch_group.py``, one spawn for the file): the mesh's
attributes; each collective against its definition, its input left
as it was, and its counts; the three MoE modes (``moe_ffn_a2a``,
``moe_ffn_psum``, ``moe_ffn_psum_ep2``, and the a2a at capacity factor
1, where the capacity drops tokens) on the shapes of
``tests/test_distributed.py`` within its 2e-5 of the reference's
``shard_map`` bodies, which run in a process of their own on 8 forced
host devices (``tests/_jax_moe_modes.py``); and the sharded decode
(slots over "model", K4's log-sum-exp merged by one all-reduce MAX and
one SUM, and the plain version's ``pmax``/``psum``) against the whole
cache, where one shard keeps nothing, where no shard keeps anything,
across a ring and past the last slot.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import mesh as jax_mesh
from repro.models.api import build as jax_build
from repro.parallel import sharding as jax_sh
from repro.runtime.elastic import plan_remesh as jax_plan_remesh
from repro_torch.configs import get_config, reduced
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import attention as A
from repro_torch.models.api import build
from repro_torch.parallel import sharding as sh
from repro_torch.runtime.elastic import plan_remesh

from _torch_group import REPO, join_group, start_group

KEY = jax.random.PRNGKey(0)
WORLD = 8
#: the group's deadline: a hung collective fails the file, never holds it
DEADLINE = 150.0


class StandInMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"2x4": {"data": 2, "model": 4}, "1x8": {"data": 1, "model": 8},
          "pod2x2x2": {"pod": 2, "data": 2, "model": 2}}


def _jkeys(path):
    return [getattr(k, "key", getattr(k, "name", None)) for k in path]


def _spec(p):
    return tuple(p)


# --------------------------------------------------------------------------
# spec tables
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_param_specs_match_reference(arch):
    jcfg = jax_reduced(jax_get_config(arch))
    shapes = jax.eval_shape(lambda: jax_build(jcfg, tp=4).init(KEY))
    port = build(reduced(get_config(arch)), tp=4).init(None)
    for fsdp, ep in ((True, False), (False, False), (True, True)):
        ref = {}

        def visit(path, leaf):
            keys = _jkeys(path)
            want = _spec(jax_sh._param_spec(path, leaf, fsdp, ep))
            assert sh._param_spec(keys, leaf, fsdp, ep) == want, keys
            ref[tuple(keys)] = want
        jax.tree_util.tree_map_with_path(visit, shapes)
        # the port's own per-block tree: the stacked entry dropped
        got = {}
        for path, spec in _spec_leaves(sh.param_specs(port, fsdp, ep)):
            keys = tuple(k for k in path if isinstance(k, str))
            stacked = any(k.endswith("blocks") for k in keys)
            want = ref[keys][1:] if stacked else ref[keys]
            assert spec == want, (keys, fsdp, ep)
            got[keys] = spec
        assert set(got) == set(ref)


def _spec_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("batch", [1, 6, 8, 64])
def test_axis_rules_match_reference(mesh, batch):
    m = StandInMesh(MESHES[mesh])
    assert sh.data_axes(m) == jax_sh.data_axes(m)
    assert sh.batch_axes_for(m, batch) == jax_sh.batch_axes_for(m, batch)
    for seq, tp_ok, fsdp, sp in ((128, True, True, False),
                                 (6, True, False, True),
                                 (4, False, True, False)):
        assert sh.axis_rules(m, batch, seq, tp_ok, fsdp=fsdp, sp_rs=sp) \
            == jax_sh.axis_rules(m, batch, seq, tp_ok, fsdp=fsdp,
                                 sp_rs=sp)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_and_batch_specs_match_reference(mesh):
    from jax.sharding import NamedSharding
    m = StandInMesh(MESHES[mesh])
    rules = jax_sh.axis_rules(m, 8, 32)
    for batch in (rules["batch"], None):
        for name, ndim in (("k", 5), ("v", 5), ("cross_k", 5),
                           ("cross_v", 5), ("pos", 2), ("ssm", 5),
                           ("conv", 4), ("other", 3)):
            leaf = jax.ShapeDtypeStruct((2,) * ndim, np.float32)
            assert sh._cache_spec(name, leaf, batch) == \
                _spec(jax_sh._cache_spec(name, leaf, batch))
    specs = {
        "tokens": jax.ShapeDtypeStruct((8, 32), np.int32),
        "labels": jax.ShapeDtypeStruct((8, 30), np.int32),
        "frames": jax.ShapeDtypeStruct((8, 16, 4), np.float32),
        "prefix_embeds": jax.ShapeDtypeStruct((8, 2, 4), np.float32),
        "token": jax.ShapeDtypeStruct((8, 1), np.int32),
        "cur_pos": jax.ShapeDtypeStruct((), np.int32),
        "extra": jax.ShapeDtypeStruct((8, 3, 2), np.float32),
        "caches": {"sub0": {"k": jax.ShapeDtypeStruct((2,) * 5, np.float32),
                            "pos": jax.ShapeDtypeStruct((2, 2), np.int32)}}}
    # the reference wraps each spec in a NamedSharding on a real mesh:
    # read its spec back
    real = jax.make_mesh((1,) * len(m.shape), tuple(m.shape))
    shaped = StandInMesh(m.shape)
    ref = jax_sh.batch_shardings(specs, _Spy(real, shaped), rules)
    got = sh.batch_specs(specs, shaped, rules)
    assert _by_path(ref) == dict(_spec_leaves(got))
    logits, caches = sh.decode_output_specs(shaped, rules, specs["caches"])
    jl, jc = jax_sh.output_shardings_for_decode(_Spy(real, shaped), rules,
                                                specs["caches"])
    assert logits == _spec(jl.spec)
    assert _by_path(jc) == dict(_spec_leaves(caches))


def _by_path(tree):
    """{path of dict keys: spec} of a tree of NamedShardings."""
    from jax.sharding import NamedSharding
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))
    return {tuple(_jkeys(path)): _spec(s.spec) for path, s in flat}


class _Spy:
    """A real one-device mesh for ``NamedSharding`` that reports the
    stand-in's axis sizes to the rules (the reference reads
    ``mesh.shape`` for them)."""

    def __init__(self, real, shaped):
        self._real, self.shape = real, shaped.shape

    def __getattr__(self, name):
        return getattr(self._real, name)


def test_plan_remesh_and_make_mesh_for_match_reference(monkeypatch):
    monkeypatch.setattr(jax_mesh.jax, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    for n in range(1, 65):
        for tp in (1, 2, 4, 8, 16):
            for gb in (1, 7, 64, 256):
                assert dataclasses.asdict(plan_remesh(n, tp, gb)) == \
                    dataclasses.asdict(jax_plan_remesh(n, tp, gb))
            assert port_mesh.mesh_shape_for(n, tp) == \
                jax_mesh.make_mesh_for(n, tp)[0]
    # the reference's own cases (tests/test_substrates.py)
    plan = plan_remesh(12, tp=4, global_batch=64)
    assert (plan.tp, plan.dp, plan.shape) == (4, 3, (3, 4))
    assert plan.global_batch % plan.dp == 0
    assert plan_remesh(7, tp=4, global_batch=64).shape == (7, 1)


def test_mesh_on_a_one_rank_group(tmp_path):
    """In this process, a one-rank gloo group: the (1, 1) host mesh on
    the CPU, its axes' groups and indices; a CUDA mesh on gloo and a
    production mesh of the wrong size refused; collectives on axes of
    size 1 return their input and count nothing."""
    import datetime

    import torch.distributed as dist
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.axes import Mesh, axis_rules
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = port_mesh.make_host_mesh("cpu")
        assert dict(mesh.shape) == {"data": 1, "model": 1}
        assert mesh.index == {"data": 0, "model": 0} and mesh.size == 1
        assert set(mesh.groups) == {"data", "model"}
        with pytest.raises(ValueError, match="NCCL"):
            Mesh((1, 1), ("data", "model"), "cuda")
        with pytest.raises(ValueError, match="256"):
            port_mesh.make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="ranks"):
            Mesh((2, 1), ("data", "model"), "cpu")
        col.reset()
        x = torch.ones(3)
        with axis_rules({"batch": None}, mesh):
            assert col.psum(x, ("model", "data")) is x
            assert col.all_gather(x, "model") is x
            assert col.all_to_all(x[None], "model").shape == (1, 3)
        assert col.COUNTS == {}
    finally:
        dist.destroy_process_group()


def test_meshes_need_a_process_group():
    for make in (lambda: port_mesh.make_host_mesh("cpu"),
                 lambda: port_mesh.make_production_mesh(device="cpu"),
                 lambda: port_mesh.make_mesh_for(8, 4, "cpu")):
        with pytest.raises(RuntimeError, match="init_process_group"):
            make()


def test_axis_rules_context_matches_reference():
    """``axis_rules`` installs rules and mesh for a block (nested, and
    restored after); ``spec_for``, ``current_fsdp`` and ``current_flag``
    read them as the reference's do; ``constrain`` returns its input."""
    from repro.parallel import axes as jax_axes
    from repro_torch.parallel import axes
    m = StandInMesh(MESHES["2x4"])
    rules = jax_sh.axis_rules(m, 8, 32, fsdp=False, sp_rs=True)
    assert axes.current_mesh() is None and axes.current_rules() is None
    assert axes.current_fsdp() and not axes.current_flag("sp_rs")
    with axes.axis_rules(rules, m):
        assert axes.current_mesh() is m
        assert not axes.current_fsdp() and axes.current_flag("sp_rs")
        for logical in (("batch", None, "heads"), ("seq", "vocab"), ()):
            assert axes.spec_for(*logical) == tuple(
                _rules_spec(jax_axes, rules, m, logical))
        x = torch.ones(2)
        assert axes.constrain(x, "batch") is x
        with axes.axis_rules({"batch": None}, m):
            assert axes.spec_for("batch") == (None,)
        assert axes.spec_for("batch") == ("data",)
    assert axes.current_mesh() is None
    assert axes.model_size() == 1 and axes.model_size(m) == 4


def _rules_spec(jax_axes, rules, mesh, logical):
    with jax_axes.axis_rules(rules, mesh):
        return jax_axes.spec_for(*logical)


def test_reshard_state_slices_params_and_moments_alike():
    from repro_torch.runtime.elastic import reshard_state
    m = StandInMesh({"data": 2, "model": 4})
    m.index = {"data": 0, "model": 3}
    m.device = torch.device("cpu")
    params = {"embed": torch.arange(16.).reshape(8, 2),
              "blocks": [{"sub0": {"ffn": {"wo": torch.ones(8, 4)}}}]}
    state = {"params": params, "m": params, "v": params,
             "step": torch.tensor(3)}
    out = reshard_state(state, m)
    for part in ("params", "m", "v"):
        assert torch.equal(out[part]["embed"], params["embed"][6:8])
        assert out[part]["blocks"][0]["sub0"]["ffn"]["wo"].shape == (2, 2)
    assert out["step"] is state["step"]


def test_local_shard_and_shard_params():
    m = StandInMesh({"data": 2, "model": 4})
    m.index = {"data": 1, "model": 2}
    m.device = torch.device("cpu")
    t = torch.arange(8 * 12).reshape(8, 12)
    assert torch.equal(sh.local_shard(t, ("data", "model"), m),
                       t[4:8, 6:9])
    assert torch.equal(sh.local_shard(t, (("model", "data"), None), m),
                       t[5:6])            # 2 * 2 + 1: model major
    assert sh.local_shard(t, (None, None), m) is t
    with pytest.raises(ValueError, match="split"):
        sh.local_shard(torch.zeros(6, 3), ("model", None), m)
    params = {"embed": torch.zeros(16, 4), "final_ln": torch.ones(4),
              "blocks": [{"sub0": {"attn": {"wq": torch.zeros(4, 8)}}}]}
    local = sh.shard_params(params, m)
    assert local["final_ln"] is params["final_ln"]
    assert local["embed"].shape == (4, 4)
    assert local["blocks"][0]["sub0"]["attn"]["wq"].shape == (2, 2)
    assert local["embed"].is_contiguous()


# --------------------------------------------------------------------------
# the (2, 4) gloo group
# --------------------------------------------------------------------------

def _moe_inputs(rng):
    d, f, e, k = 16, 32, 4, 2

    def w(*shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)
    return {"top_k": k, "n_experts": e,
            "params": {"router": w(d, e, fan=d), "wg": w(e, d, f, fan=d),
                       "wi": w(e, d, f, fan=d), "wo": w(e, f, d, fan=f)},
            "params_ep2": {"router": w(d, e, fan=d),
                           "wg": w(2 * e, d, f // 2, fan=d),
                           "wi": w(2 * e, d, f // 2, fan=d),
                           "wo": w(2 * e, f // 2, d, fan=f)},
            "x_a2a": rng.standard_normal((64, d)).astype(np.float32),
            "x_psum": rng.standard_normal((8, d)).astype(np.float32)}


#: (pos of the 32 slots, cur_pos, window) of each sharded-decode case
def _cases():
    filled = np.full(32, -1, np.int32)
    filled[:20] = np.arange(20)
    ring = np.zeros(32, np.int32)
    for p in range(20, 52):
        ring[p % 32] = p
    return {"one_shard_empty": (filled, 20, 0),
            "nothing_kept": (np.full(32, -1, np.int32), 40, 0),
            "ring": (ring, 52, 16),
            "past_the_end": (np.arange(32, dtype=np.int32), 33, 0)}


def _attention_inputs(rng):
    b, h, kv, hd = 2, 8, 2, 16
    cases = {}
    for i, (name, (pos, cur, window)) in enumerate(_cases().items()):
        cases[name] = {
            "k": rng.standard_normal((b, 32, kv, hd)).astype(np.float32),
            "v": rng.standard_normal((b, 32, kv, hd)).astype(np.float32),
            "pos": pos, "cur": cur, "window": window}
    return {"q": rng.standard_normal((b, 1, h, hd)).astype(np.float32),
            "new_k": rng.standard_normal((b, 1, kv, hd)).astype(np.float32),
            "new_v": rng.standard_normal((b, 1, kv, hd)).astype(np.float32),
            "cases": cases}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel_group")
    rng = np.random.default_rng(0)
    inputs = {"moe": _moe_inputs(rng), "attention": _attention_inputs(rng)}
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    procs = start_group("parallel", WORLD, work)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(
        REPO / "src"), "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    ref = subprocess.run([sys.executable, str(REPO / "tests" /
                                              "_jax_moe_modes.py"),
                          str(work / "inputs.pkl"), str(work / "ref.npz")],
                         env=env, capture_output=True, text=True,
                         timeout=DEADLINE)
    ranks = join_group(procs, work, DEADLINE)
    assert ref.returncode == 0, ref.stderr[-3000:]
    return ranks, dict(np.load(work / "ref.npz")), inputs


def _coords(r):
    return r // 4, r % 4            # (data, model): ranks row-major


def test_mesh_attributes(group):
    ranks, _, _ = group
    for r, out in enumerate(ranks):
        shape, names, index, device = out["mesh"]
        assert shape == {"data": 2, "model": 4}
        assert names == ("data", "model")
        assert index == dict(zip(names, _coords(r)))
        assert device == "cpu"
        d, m = _coords(r)
        assert out["axis_index"] == (m, d, m * 2 + d)


def _x(r):
    return np.arange(24, dtype=np.float32).reshape(8, 3) + 100 * r


@pytest.mark.parametrize("op", ["psum_model", "psum_both", "pmax_data",
                                "gather_model_dim1", "scatter_model_dim0",
                                "a2a_model"])
def test_collective_matches_its_definition(group, op):
    ranks, _, _ = group
    for r, out in enumerate(ranks):
        d, m = _coords(r)
        row = [d * 4 + j for j in range(4)]          # this rank's model axis
        if op == "psum_model":
            want = sum(_x(q) for q in row)
        elif op == "psum_both":
            want = sum(_x(q) for q in range(8))
        elif op == "pmax_data":
            want = np.maximum(_x(m), _x(4 + m))
        elif op == "gather_model_dim1":
            want = np.concatenate([_x(q) for q in row], axis=1)
        elif op == "scatter_model_dim0":
            want = sum(_x(q) for q in row)[2 * m:2 * m + 2]
        else:
            want = np.stack([_x(q).reshape(4, 2, 3)[m] for q in row])
        np.testing.assert_array_equal(out[op], want)
        np.testing.assert_array_equal(out["untouched"], _x(r))


def test_collective_counts(group):
    ranks, _, _ = group
    nbytes = 24 * 4
    for out in ranks:
        assert out["counts"] == {
            ("psum", "model"): {"calls": 2, "bytes": 2 * nbytes},
            ("psum", "data"): {"calls": 1, "bytes": nbytes},
            ("pmax", "data"): {"calls": 1, "bytes": nbytes},
            ("all_gather", "model"): {"calls": 1, "bytes": nbytes},
            ("psum_scatter", "model"): {"calls": 1, "bytes": nbytes},
            ("all_to_all", "model"): {"calls": 1, "bytes": nbytes}}
        # a2a: the ZeRO-3 gathers of wg, wi, wo over data, two exchanges
        assert out["a2a_counts"][("all_gather", "data")]["calls"] == 3
        assert out["a2a_counts"][("all_to_all", "model")]["calls"] == 2


@pytest.mark.parametrize("mode", ["a2a", "a2a_tight", "psum", "ep2"])
def test_moe_mode_matches_reference_shard_map(group, mode):
    """The mode's blocks, laid out as the reference's out_specs lay them
    out, within tests/test_distributed.py's 2e-5 (``a2a_tight``: the a2a
    at capacity factor 1, each rank's capacity dropping tokens as the
    reference's does)."""
    ranks, ref, _ = group
    if mode.startswith("a2a"):  # P(("data", "model")): rank order
        got = np.concatenate([ranks[r][mode] for r in range(8)])
    else:                      # P("data"): each data rank's rows
        got = np.concatenate([ranks[0][mode], ranks[4][mode]])
        for r in range(8):     # replicated over model
            np.testing.assert_array_equal(ranks[r][mode],
                                          ranks[4 * (r // 4)][mode])
    np.testing.assert_allclose(got, ref[mode], rtol=2e-5, atol=2e-5)


def test_tight_a2a_drops_tokens(group):
    """Capacity factor 1 drops pairs the factor E keeps, so the two
    differ: the a2a_tight comparison reads the capacity's accounting."""
    ranks, _, _ = group
    gap = max(np.abs(out["a2a_tight"] - out["a2a"]).max() for out in ranks)
    assert gap > 1e-2


def test_moe_modes_match_the_dense_mode(group):
    """As tests/test_distributed.py holds the reference's modes: equal to
    the dense mode at capacity factor E (nothing dropped)."""
    from repro_torch.models.moe import moe_ffn_dense
    ranks, _, inputs = group
    moe = inputs["moe"]
    p = {n: torch.from_numpy(a) for n, a in moe["params"].items()}
    for mode, x in (("a2a", moe["x_a2a"]), ("psum", moe["x_psum"])):
        dense = moe_ffn_dense(torch.from_numpy(x), p, moe["top_k"],
                              float(moe["n_experts"])).numpy()
        got = np.concatenate([ranks[r][mode] for r in range(8)]) \
            if mode == "a2a" else np.concatenate([ranks[0][mode],
                                                  ranks[4][mode]])
        np.testing.assert_allclose(got, dense, rtol=2e-5, atol=2e-5)


def _whole(inputs, case):
    att = inputs["attention"]
    c = att["cases"][case]
    t = torch.from_numpy
    cache = {"k": t(c["k"].copy()), "v": t(c["v"].copy()),
             "pos": np.array(c["pos"], np.int32)}
    out = A._decode_local(t(att["q"]), t(att["new_k"]), t(att["new_v"]),
                          cache, c["cur"], c["window"], 4, "kernel", None)
    return out.numpy(), cache


@pytest.mark.parametrize("attn", ["kernel", "plain"])
@pytest.mark.parametrize("case", list(_cases()))
def test_sharded_decode_matches_the_whole_cache(group, case, attn):
    ranks, _, inputs = group
    want, cache = _whole(inputs, case)
    pos, cur, window = _cases()[case]
    kept = A.kept_slots(cache["pos"], cur, window)
    for r, out in enumerate(ranks):
        got, got_pos, seen, k_local = out["attention"][(case, attn)]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got_pos, cache["pos"])
        m = _coords(r)[1]
        np.testing.assert_array_equal(k_local,
                                      cache["k"][:, 8 * m:8 * m + 8].numpy())
        if attn == "plain":
            continue
        mine = [s for s in kept if 8 * m <= s < 8 * m + 8]
        if not len(kept):          # every shard: a zero query, all slots
            assert seen == [8]
        else:                      # a shard that keeps nothing: no K4
            assert seen == ([len(mine)] if mine else [])
