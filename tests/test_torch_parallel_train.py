"""The port's training on a mesh against the reference's mesh-free
``build(cfg, tp)``, at ``reduced(d_model=64, vocab=512, attn_chunk=32)``
in f32, batch 8 x 32, on the reference's weights (its init at ``tp``:
padded heads and vocabulary, ``tpe`` expert slices) carried across with
``convert.lm_params_from_numpy``.

One (2, 4) ("data", "model") gloo group of 8 spawned CPU ranks
(``tests/_torch_group.py``, one spawn for the file; the job is
``tests/_torch_train_worker.py``'s).  Against the reference's
``jax.value_and_grad(build(cfg, tp).train_loss)`` and three steps of its
``make_train_step`` (warmup 1, so the learning rate is above 0):

  * the loss within 1e-5 relative; every gradient leaf, gathered whole,
    within 1e-4 of its max |ref|;
  * each step's ``loss``, ``grad_norm`` and ``lr`` within 1e-5 relative,
    and the params gathered whole after the third within 1e-5 of their
    max |ref| (over every leaf: a leaf made of the steps alone, such as
    a Mamba ``dt_bias``, carries AdamW's normalized f32 noise, 1.6e-4 of
    its own max in the mesh-free port's jamba as much as on the mesh);

for phi3 (ZeRO-3 over "data", and also with ``fsdp`` off and with
``sp_rs`` on), mixtral (``a2a``; ``capacity_factor = E``, as
``tests/test_distributed.py`` sets it; also under ``sp_rs``) and whisper
(frames and tokens at the 32 of ``attn_chunk``, where the reference
pads no key; also under ``sp_rs``) and llava (its 8-row prefix stub
written into the first rank's sequence block under ``sp_rs``) at tp 4,
and mamba2 and jamba on an (8, 1) mesh against ``build(cfg, tp=1)``.  The collectives by op: the
FSDP gathers over "data" and their reduce-scatters, mixtral's
all-to-alls, the loss's ``pmax`` and sums.  Two controls, each
monkeypatched in the worker for its case alone, must fail the gradient
gate: the column-parallel entry's backward sum over "model" replaced by
the identity, and the gradient sync over "data" skipped.
``run_resilient`` with a failure and ``on_restart`` onto the (4, 2)
mesh ends where the clean run ends; its sharded checkpoints hold whole
leaves under the manifest the mesh-free checkpointer writes.  mamba2
and jamba also at tp 4 on (2, 4), the Mamba mixers over the model axis
of 4: the loss and gradients against the reference's ``build(cfg,
tp=4)``.

The reference's own sharded test (``tests/test_distributed.py::
test_sharded_train_step_matches_single_device``) fails under JAX 0.9.0;
it holds sharded against mesh-free, as this does.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import steps as jax_steps
from repro.models.api import build as jax_build
from repro_torch.configs import get_config, reduced
from repro_torch.models.api import build
from repro_torch.models.transformer import n_blocks
from repro_torch.parallel.sharding import param_specs

from _torch_group import join_group, start_group

KEY = jax.random.PRNGKey(0)
SMALL = dict(d_model=64, vocab=512, attn_chunk=32)
B, S, FRAMES = 8, 32, 32
#: peak lr 1e-3: at 1e-2 the mesh-free port's own jamba misses the
#: reference's step-3 grad norm by 1.79e-5 relative and its params by
#: 6e-3 of the embedding's max (AdamW's eps of 1e-8 turns f32 noise in
#: near-zero gradients into whole steps, which then move the routing)
SCHEDULE = dict(peak_lr=1e-3, warmup=1, total_steps=6)
DEADLINE = 420.0

#: arch -> (reference tp, mesh); the attention families at tp 4 on the
#: group's (2, 4) mesh, the SSM families at tp 1 on (8, 1)
ARCHS = {"phi3-medium-14b": (4, (2, 4)), "mixtral-8x7b": (4, (2, 4)),
         "whisper-medium": (4, (2, 4)), "llava-next-34b": (4, (2, 4)),
         "mamba2-1.3b": (1, (8, 1)), "jamba-1.5-large-398b": (1, (8, 1))}
#: case -> (arch, fsdp, sp_rs, control)
CASES = {
    "phi3": ("phi3-medium-14b", True, False, None),
    "phi3-sp_rs": ("phi3-medium-14b", True, True, None),
    "phi3-no_fsdp": ("phi3-medium-14b", False, False, None),
    "mixtral": ("mixtral-8x7b", True, False, None),
    "mixtral-sp_rs": ("mixtral-8x7b", True, True, None),
    "whisper": ("whisper-medium", True, False, None),
    "whisper-sp_rs": ("whisper-medium", True, True, None),
    "llava": ("llava-next-34b", True, False, None),
    "llava-sp_rs": ("llava-next-34b", True, True, None),
    "mamba2": ("mamba2-1.3b", True, False, None),
    "jamba": ("jamba-1.5-large-398b", True, False, None),
    "control-no_model_sum": ("phi3-medium-14b", True, False,
                             "no_model_sum"),
    "control-no_data_sync": ("phi3-medium-14b", True, False,
                             "no_data_sync"),
}
GATED = [c for c in CASES if not c.startswith("control")]
RESILIENT = dict(steps=4, every=2, fail_at=3, remesh_tp=2)
#: the SSM families also run at tp 4 on the group's (2, 4) mesh
SSM_TP4 = ("mamba2-1.3b", "jamba-1.5-large-398b")


def _over(arch):
    over = dict(SMALL)
    n_experts = get_config(arch).n_experts
    if n_experts:
        over["capacity_factor"] = float(min(n_experts, 4))   # E: no drops
    return over


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(out, ref) -> float:
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _worst(port, ref) -> tuple[float, str]:
    """The worst leaf of ``port`` (the port's stacked layout as numpy)
    against ``ref`` (the reference's tree), relative to its max |ref|."""
    ref_leaves = jax.tree_util.tree_flatten_with_path(_np_tree(ref))[0]
    port_leaves = jax.tree_util.tree_leaves(port)
    assert len(ref_leaves) == len(port_leaves)
    return max((_rel(p, r), jax.tree_util.keystr(path))
               for (path, r), p in zip(ref_leaves, port_leaves))


def _batches(cfg, rng, n=3):
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        b["labels"][0, :3] = -1
        b["labels"][5, -4:] = -1
        if cfg.family == "encdec":
            b["frames"] = (rng.standard_normal(
                (B, FRAMES, cfg.d_model)) * 0.5).astype(np.float32)
        if cfg.frontend == "vision_stub":
            b["prefix_embeds"] = (rng.standard_normal(
                (B, cfg.frontend_len, cfg.d_model)) * 0.02).astype(
                np.float32)
        out.append(b)
    return out


def _reference(jcfg, tp, batches):
    """The reference's mesh-free gradient of batch 0 and its three
    steps from ``init_train_state(api, KEY)`` (whose params are
    ``init(KEY)``)."""
    api = jax_build(jcfg, tp=tp)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    loss, grads = jax.jit(jax.value_and_grad(api.train_loss))(
        api.init(KEY), jb[0])
    state = jax_steps.init_train_state(api, KEY)
    step = jax.jit(jax_steps.make_train_step(
        api, peak_lr=SCHEDULE["peak_lr"], warmup=SCHEDULE["warmup"],
        total=SCHEDULE["total_steps"]))
    metrics = []
    for b in jb:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"loss": float(loss), "grads": _np_tree(grads),
            "metrics": metrics, "params": _np_tree(state.params)}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel_train_group")
    rng = np.random.default_rng(0)
    archs, jobs = {}, {}
    for arch, (tp, _mesh) in ARCHS.items():
        over = _over(arch)
        jcfg = jax_reduced(jax_get_config(arch), **over)
        cfg = reduced(get_config(arch), **over)
        batches = _batches(cfg, rng)
        archs[arch] = {"arch": arch, "over": over, "tp": tp,
                       "params": _np_tree(jax_build(jcfg, tp=tp).init(KEY)),
                       "batches": batches}
        jobs[arch] = (jcfg, tp, batches)
    cases = {name: {"arch": arch, "mesh": ARCHS[arch][1], "fsdp": fsdp,
                    "sp_rs": sp_rs, "control": control,
                    "steps": control is None, "schedule": SCHEDULE}
             for name, (arch, fsdp, sp_rs, control) in CASES.items()}
    # mamba2 and jamba at tp 4 on the group's (2, 4) mesh, batch 0 alone
    mamba_tp4 = {}
    for arch in SSM_TP4:
        jcfg, _tp, batches = jobs[arch]
        mamba_tp4[arch] = dict(archs[arch], tp=4, params=_np_tree(
            jax_build(jcfg, tp=4).init(KEY)), batches=batches[:1])
    inputs = {"archs": archs, "cases": cases,
              "resilient": dict(RESILIENT, arch=archs["phi3-medium-14b"],
                                schedule=SCHEDULE),
              "mamba_tp4": mamba_tp4}
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    procs = start_group("train", 8, work)
    refs = {}
    try:
        for arch, (jcfg, tp, batches) in jobs.items():   # while they run
            refs[arch] = _reference(jcfg, tp, batches)
        for arch in SSM_TP4:
            jcfg, _tp, batches = jobs[arch]
            api = jax_build(jcfg, tp=4)
            loss, grads = jax.jit(jax.value_and_grad(api.train_loss))(
                api.init(KEY), {k: jnp.asarray(v)
                                for k, v in batches[0].items()})
            refs[arch + "@tp4"] = {"loss": float(loss),
                                   "grads": _np_tree(grads)}
    finally:
        ranks = join_group(procs, work, DEADLINE)
    return ranks, refs


@pytest.mark.parametrize("case", GATED)
def test_sharded_loss_and_gradients_match_reference(group, case):
    ranks, refs = group
    ref = refs[CASES[case][0]]
    for out in ranks:              # the global mean on every rank
        got = out["cases"][case]["loss"]
        assert abs(got - ref["loss"]) <= 1e-5 * abs(ref["loss"]), (got, ref)
    err, leaf = _worst(ranks[0]["cases"][case]["grads"], ref["grads"])
    assert err <= 1e-4, (case, leaf, err)


@pytest.mark.parametrize("case", GATED)
def test_three_sharded_steps_match_reference(group, case):
    ranks, refs = group
    ref = refs[CASES[case][0]]
    for out in ranks:
        got = out["cases"][case]
        assert got["step"] == (3, 3)
        for i, (m, rm) in enumerate(zip(got["metrics"], ref["metrics"])):
            for name in ("loss", "grad_norm", "lr"):
                assert abs(m[name] - rm[name]) <= 1e-5 * abs(rm[name]), \
                    (case, i, name, m[name], rm[name])
    port = jax.tree_util.tree_leaves(ranks[0]["cases"][case]["params"])
    want = jax.tree_util.tree_leaves(ref["params"])
    assert len(port) == len(want)
    err = max(float(np.abs(np.asarray(p, np.float64) - r).max())
              for p, r in zip(port, want))
    top = max(float(np.abs(r).max()) for r in want)
    assert err <= 1e-5 * top, (case, err, top)


@pytest.mark.parametrize("control", ["control-no_model_sum",
                                     "control-no_data_sync"])
def test_controls_fail_the_gradient_gate(group, control):
    """The column-parallel entry without its backward sum over "model",
    or the gradients left unsynced over "data", must miss the gate."""
    ranks, refs = group
    err, leaf = _worst(ranks[0]["cases"][control]["grads"],
                       refs["phi3-medium-14b"]["grads"])
    assert err > 1e-4 * 100, (control, leaf, err)


def test_each_rank_takes_its_rows(group):
    ranks, _ = group
    for out in ranks:
        for case, (arch, *_rest) in CASES.items():
            data = ARCHS[arch][1][0]
            assert out["cases"][case]["local_rows"] == B // data


def test_the_step_runs_the_collectives_it_should(group):
    """Over one ``value_and_grad`` (every block under remat, so each
    forward collective of a block runs twice): phi3's seven weights a
    block gathered over "data" and reduce-scattered back once; none
    without ``fsdp``; mixtral's two all-to-alls a layer, forward, in the
    recompute and backward; the loss's ``pmax`` over "model" once a
    chunk and again in its recompute, its sums over the batch axes; no
    collective over a size-1 axis."""
    ranks, _ = group
    cfg = reduced(get_config("phi3-medium-14b"), **SMALL)
    nb = n_blocks(cfg)
    specs = jax.tree_util.tree_leaves(
        param_specs(build(cfg, tp=4).init(None)),
        is_leaf=lambda x: isinstance(x, tuple))
    replicated = sum("data" not in spec for spec in specs)
    for out in ranks:
        c = out["cases"]["phi3"]["counts"]
        assert c["all_gather@data"] == 2 * 7 * nb
        assert c["psum_scatter@data"] == 7 * nb
        assert c["pmax@model"] == 2
        # the loss's two sums, then the sync of every leaf the spec
        # leaves whole over "data" (the norms, the embedding)
        assert c["psum@data"] == 2 + replicated
        assert c["psum@model"] > 0
        assert "all_to_all@model" not in c
        c = out["cases"]["phi3-no_fsdp"]["counts"]
        assert "all_gather@data" not in c and "psum_scatter@data" not in c
        assert c["psum@data"] == 2 + len(specs)
        c = out["cases"]["phi3-sp_rs"]["counts"]
        assert c["psum_scatter@model"] > 0 and c["all_gather@model"] > 0
        moe = reduced(get_config("mixtral-8x7b"), **SMALL)
        assert out["cases"]["mixtral"]["counts"]["all_to_all@model"] \
            == 3 * 2 * n_blocks(moe)
        for case in ("mamba2", "jamba"):
            assert not any(k.endswith("@model")
                           for k in out["cases"][case]["counts"])


def test_resilient_restart_onto_a_new_mesh_ends_in_the_clean_state(group):
    ranks, _ = group
    res = ranks[0]["resilient"]
    clean, failed = res["clean"], res["failed"]
    assert clean["meshes"] == [{"data": 2, "model": 4}]
    assert failed["meshes"] == [{"data": 2, "model": 4},
                                {"data": 4, "model": 2}]
    assert (clean["restarts"], failed["restarts"]) == (0, 1)
    assert clean["steps"] == failed["steps"] == RESILIENT["steps"]
    first = dict(clean["losses"])
    for i, loss in failed["losses"]:
        assert abs(loss - first[i]) <= 1e-5 * abs(first[i]), (i, loss)
    for part in ("params", "m", "v"):
        a = jax.tree_util.tree_leaves(clean["final"][part])
        b = jax.tree_util.tree_leaves(failed["final"][part])
        for x, y in zip(a, b):
            assert _rel(y, x) <= 1e-5, part
    # the step-2 checkpoint, written before the failure: equal bit for bit
    every = RESILIENT["every"]
    for name in ("clean", "failed"):
        assert f"step_{every:08d}" in res[name]["saved"]
    ca, fa = clean["ckpt"], failed["ckpt"]
    assert ca["manifest"] == fa["manifest"]
    for k, v in ca["arrays"].items():
        np.testing.assert_array_equal(v, fa["arrays"][k])


@pytest.mark.parametrize("run", ["clean", "failed"])
def test_sharded_checkpoint_holds_whole_leaves(group, run):
    """The sharded save of the final state (on (2, 4) for the clean run,
    on (4, 2) after the restart) equals the mesh-free checkpointer's
    save of that state gathered whole: the same names, types and whole
    shapes in the manifest, the same arrays bit for bit."""
    ranks, _ = group
    res = ranks[0]["resilient"][run]
    mine, whole = res["final_ckpt"], res["whole_ckpt"]
    for key in ("names", "dtypes", "shapes", "n_hosts"):
        assert mine["manifest"][key] == whole["manifest"][key]
    assert mine["arrays"].keys() == whole["arrays"].keys()
    for k, v in mine["arrays"].items():
        np.testing.assert_array_equal(v, whole["arrays"][k])
    cfg = reduced(get_config("phi3-medium-14b"), **SMALL)
    shapes = dict(zip(mine["manifest"]["names"],
                      mine["manifest"]["shapes"]))
    assert shapes["params/embed"] == [cfg.padded_vocab(4), cfg.d_model]
    assert shapes["opt/m/blocks/0/sub0/attn/wq"][0] == cfg.d_model


@pytest.mark.parametrize("arch", SSM_TP4)
def test_mamba_mixer_on_a_model_axis_matches_reference(group, arch):
    """mamba2 and jamba at tp 4 on the group's (2, 4) mesh, the Mamba
    mixers over the model axis of 4 (``tests/test_torch_parallel_ssm.py``
    holds serving, the steps, ``fsdp`` off and ``sp_rs``): the loss and
    every gradient leaf against the reference's ``build(cfg, tp=4)``,
    with the mixer's all-gathers over "model" run."""
    ranks, refs = group
    ref = refs[arch + "@tp4"]
    for out in ranks:
        got = out["mamba_tp4"][arch]
        assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
        assert got["counts"]["all_gather@model"] > 0
    err, leaf = _worst(ranks[0]["mamba_tp4"][arch]["grads"], ref["grads"])
    assert err <= 1e-4, (arch, leaf, err)
