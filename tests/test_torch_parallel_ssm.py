"""The Mamba mixer on a "model" axis above 1 against the reference's
mesh-free ``build(cfg, tp=4)``, at ``reduced(d_model=64, vocab=512,
attn_chunk=32)`` in f32 (8 SSD heads of 16, so 2 a rank at model 4), on
the reference's weights (its init at tp 4) carried across with
``convert.lm_params_from_numpy``.

The reference shards ``in_proj``'s packed ``[z | x | B | C | dt]``
output over "model" in one contiguous split and ``conv_w`` over the
conv channels, which do not fall on the heads; the port keeps those
layouts and regroups inside the mixer
(:func:`repro_torch.models.ssm.mamba_forward_mesh`).

On one (2, 4) ("data", "model") gloo group of 8 spawned CPU ranks
(``tests/_torch_group.py``; the job is ``tests/_torch_mesh_worker.py``'s
``ssm``):

  * serving, mamba2 and jamba: a 20-token prefill and 3 decode steps,
    every logit within 1e-5 of max |ref| and the caches gathered whole
    within 1e-5 of the reference's; the control (each rank's conv
    channels read at its contiguous block of ``conv_dim`` as its heads',
    patched in the worker) misses that gate;
  * training, mamba2 with ``fsdp`` on and off, jamba with ``fsdp`` on,
    off and under ``sp_rs``: the loss within 1e-5 relative, every
    gradient leaf gathered whole within 1e-4 of its max |ref|, three
    steps' loss, grad norm and lr within 1e-5, the params after them
    within 1e-5 of their max, as ``tests/test_torch_parallel_train.py``
    holds phi3.

In one process: :func:`~repro_torch.models.ssm.run_shards` (the shards'
bodies in turn, the collectives done in the process) against the
reference's ``mamba_forward``/``mamba_decode`` at 2, 4 and 8 shards and
its control; a head count the model axis does not split raises
``ValueError``.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import steps as jax_steps
from repro.models import ssm as jax_ssm
from repro.models.api import build as jax_build
from repro_torch.configs import get_config, reduced
from repro_torch.models import ssm as S
from repro_torch.models.api import build
from repro_torch.parallel.axes import axis_rules

from _torch_group import join_group, start_group
from _torch_mesh_worker import contiguous_cut

KEY = jax.random.PRNGKey(0)
SMALL = dict(d_model=64, vocab=512, attn_chunk=32)
TP = 4
ARCHS = ("mamba2-1.3b", "jamba-1.5-large-398b")
B, S_TRAIN = 8, 32
#: serving: prompt (split by the model axis, as jamba's a2a needs),
#: decode steps, max_seq (its slots split over "model")
PROMPT, STEPS, MAX_SEQ = 20, 3, 24
SCHEDULE = dict(peak_lr=1e-3, warmup=1, total_steps=6)
#: case -> (arch, fsdp, sp_rs)
CASES = {"mamba2": ("mamba2-1.3b", True, False),
         "mamba2-no_fsdp": ("mamba2-1.3b", False, False),
         "jamba": ("jamba-1.5-large-398b", True, False),
         "jamba-no_fsdp": ("jamba-1.5-large-398b", False, False),
         "jamba-sp_rs": ("jamba-1.5-large-398b", True, True)}
DEADLINE = 240.0


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
    ref_leaves = jax.tree_util.tree_flatten_with_path(_np_tree(ref))[0]
    port_leaves = jax.tree_util.tree_leaves(port)
    assert len(ref_leaves) == len(port_leaves)
    return max((_rel(p, r), jax.tree_util.keystr(path))
               for (path, r), p in zip(ref_leaves, port_leaves))


def _batches(cfg, rng, n=3):
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab,
                                    (B, S_TRAIN)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab,
                                    (B, S_TRAIN)).astype(np.int32)}
        b["labels"][0, :3] = -1
        out.append(b)
    return out


def _serve_reference(jcfg, params, tokens):
    """The reference's mesh-free logits of the prefill and each decode
    step, and its caches after the last."""
    api = jax_build(jcfg, tp=TP)
    lg, caches = api.prefill(params, {"tokens": jnp.asarray(
        tokens[:, :PROMPT])}, max_seq=MAX_SEQ)
    out = [np.asarray(lg)]
    for i in range(STEPS):
        lg, caches = api.decode_step(
            params, caches, jnp.asarray(tokens[:, PROMPT + i:PROMPT + i + 1]),
            jnp.asarray(PROMPT + i, jnp.int32))
        out.append(np.asarray(lg))
    return out, _np_tree(caches)


def _train_reference(jcfg, batches):
    api = jax_build(jcfg, tp=TP)
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
    work = tmp_path_factory.mktemp("parallel_ssm_group")
    rng = np.random.default_rng(0)
    inputs = {"serve": {}, "archs": {}, "cases": {}}
    jobs = {}
    for arch in ARCHS:
        over = _over(arch)
        jcfg = jax_reduced(jax_get_config(arch), **over)
        cfg = reduced(get_config(arch), **over)
        params = _np_tree(jax_build(jcfg, tp=TP).init(KEY))
        tokens = rng.integers(0, cfg.vocab,
                              (B, PROMPT + STEPS)).astype(np.int32)
        serve = {"arch": arch, "over": over, "params": params,
                 "tokens": tokens, "prompt": PROMPT, "steps": STEPS,
                 "max_seq": MAX_SEQ, "caches": True}
        inputs["serve"][arch] = serve
        if arch == "mamba2-1.3b":
            inputs["serve"]["control-contiguous"] = dict(
                serve, control="contiguous", caches=False)
        batches = _batches(cfg, rng)
        inputs["archs"][arch] = {"arch": arch, "over": over, "tp": TP,
                                 "params": params, "batches": batches}
        jobs[arch] = (jcfg, params, tokens, batches)
    inputs["cases"] = {
        name: {"arch": arch, "mesh": (2, 4), "fsdp": fsdp, "sp_rs": sp_rs,
               "control": None, "steps": True, "schedule": SCHEDULE}
        for name, (arch, fsdp, sp_rs) in CASES.items()}
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    procs = start_group("ssm", 8, work)
    refs = {}
    try:
        for arch, (jcfg, params, tokens, batches) in jobs.items():
            refs[arch] = {"serve": _serve_reference(jcfg, params, tokens),
                          "train": _train_reference(jcfg, batches)}
    finally:
        ranks = join_group(procs, work, DEADLINE)
    return ranks, refs


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_mixer_serves_as_the_reference(group, arch):
    ranks, refs = group
    want, _ = refs[arch]["serve"]
    for out in ranks:
        got = out["serve"][arch]["logits"]
        assert len(got) == len(want) == 1 + STEPS
        for i, (g, w) in enumerate(zip(got, want)):
            assert _rel(g, w) <= 1e-5, (arch, i, _rel(g, w))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_mixer_caches_match_reference(group, arch):
    """The caches after the last decode step, every rank's blocks
    gathered whole: the SSM state by heads and the conv tail by channels
    over "model" (and jamba's attention slots), ``pos`` equal."""
    ranks, refs = group
    _, want = refs[arch]["serve"]
    got = ranks[0]["serve"][arch]["caches"]
    for sub, leaves in want.items():
        for name, ref in leaves.items():
            if name == "pos":
                np.testing.assert_array_equal(got[sub][name], ref)
            else:
                assert _rel(got[sub][name], ref) <= 1e-5, (arch, sub, name)


def test_contiguous_split_control_misses_the_gate(group):
    """Each rank's conv channels read at its contiguous block of
    ``conv_dim`` (the reference's split of ``conv_w``) as its heads'."""
    ranks, refs = group
    want, _ = refs["mamba2-1.3b"]["serve"]
    got = ranks[0]["serve"]["control-contiguous"]["logits"]
    assert _rel(got[0], want[0]) > 1e-5 * 100


@pytest.mark.parametrize("case", CASES)
def test_sharded_mixer_loss_and_gradients_match_reference(group, case):
    ranks, refs = group
    ref = refs[CASES[case][0]]["train"]
    for out in ranks:
        got = out["train"][case]["loss"]
        assert abs(got - ref["loss"]) <= 1e-5 * abs(ref["loss"]), (got, ref)
    err, leaf = _worst(ranks[0]["train"][case]["grads"], ref["grads"])
    assert err <= 1e-4, (case, leaf, err)


@pytest.mark.parametrize("case", CASES)
def test_three_sharded_mixer_steps_match_reference(group, case):
    ranks, refs = group
    ref = refs[CASES[case][0]]["train"]
    for out in ranks:
        got = out["train"][case]
        assert got["step"] == (3, 3)
        for i, (m, rm) in enumerate(zip(got["metrics"], ref["metrics"])):
            for name in ("loss", "grad_norm", "lr"):
                assert abs(m[name] - rm[name]) <= 1e-5 * abs(rm[name]), \
                    (case, i, name, m[name], rm[name])
    port = jax.tree_util.tree_leaves(ranks[0]["train"][case]["params"])
    want = jax.tree_util.tree_leaves(ref["params"])
    assert len(port) == len(want)
    err = max(float(np.abs(np.asarray(p, np.float64) - r).max())
              for p, r in zip(port, want))
    top = max(float(np.abs(r).max()) for r in want)
    assert err <= 1e-5 * top, (case, err, top)


def test_the_mixer_runs_its_collectives_over_the_model_axis(group):
    """A Mamba layer's projection, ``conv_w`` and (at decode) conv cache
    all-gathered over "model", its sum of squares all-reduced; under
    ``sp_rs`` the sequence gathered and reduce-scattered."""
    ranks, _ = group
    for out in ranks:
        for arch in ARCHS:
            c = out["serve"][arch]
            assert c["prefill_counts"]["all_gather"]["calls"] > 0
            assert c["decode_counts"]["psum"]["calls"] > 0
        for case in CASES:
            c = out["train"][case]["counts"]
            assert c["all_gather@model"] > 0 and c["psum@model"] > 0
        assert out["train"]["jamba-sp_rs"]["counts"]["psum_scatter@model"] \
            > 0


# --------------------------------------------------------------------------
# one process
# --------------------------------------------------------------------------

def _mixer(arch, seed=3):
    """A reduced mixer's reference params (A_log, dt_bias, D and norm_w
    drawn away from their init) and the port's copy."""
    jcfg = jax_reduced(jax_get_config(arch), **SMALL)
    cfg = reduced(get_config(arch), **SMALL)
    rng = np.random.default_rng(seed)
    p = _np_tree(jax_ssm.init_mamba(KEY, cfg.d_model, cfg.ssm_state,
                                    cfg.ssm_head_dim, cfg.ssm_expand,
                                    cfg.ssm_conv, jnp.float32))
    h = cfg.ssm_heads
    p["A_log"] = rng.standard_normal(h).astype(np.float32) * 0.5
    p["dt_bias"] = rng.standard_normal(h).astype(np.float32) * 0.5
    p["D"] = rng.standard_normal(h).astype(np.float32)
    p["norm_w"] = (1 + 0.1 * rng.standard_normal(cfg.d_inner)).astype(
        np.float32)
    return jcfg, cfg, p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


@pytest.mark.parametrize("mp", [2, 4, 8])
def test_shards_in_one_process_match_reference(mp):
    """``run_shards``: a 37-token prefill, then one decode step from its
    caches, against the reference's ``mamba_forward``/``mamba_decode``
    (output, SSM state, conv tail within 1e-5 of their max)."""
    jcfg, cfg, p, tp = _mixer("mamba2-1.3b")
    rng = np.random.default_rng(mp)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    ry, (rst, rtail) = jax_ssm.mamba_forward(p, jnp.asarray(x), jcfg)
    y, (st, tail) = S.run_shards(tp, torch.from_numpy(x), cfg, mp)
    for got, ref in ((y, ry), (st, rst), (tail, rtail)):
        assert _rel(got.numpy(), np.asarray(ref)) <= 1e-5
    xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    rd, (rds, rdc) = jax_ssm.mamba_decode(p, jnp.asarray(xd), jcfg, rst,
                                          rtail)
    d, (ds, dc) = S.run_shards(tp, torch.from_numpy(xd), cfg, mp,
                               caches=(st, tail))
    for got, ref in ((d, rd), (ds, rds), (dc, rdc)):
        assert _rel(got.numpy(), np.asarray(ref)) <= 1e-5
    wrong, _ = S.run_shards(tp, torch.from_numpy(x), cfg, mp,
                            cut=contiguous_cut)
    assert _rel(wrong.numpy(), np.asarray(ry)) > 1e-5 * 100


class _StandInMesh:
    """What the models read of a mesh before any collective runs."""
    shape = {"data": 1, "model": 3}
    axis_names = ("data", "model")
    size = 3


@pytest.mark.parametrize("arch", ARCHS)
def test_heads_that_do_not_split_raise(arch):
    """8 SSD heads over a model axis of 3: serving and training raise
    ``ValueError`` naming both numbers."""
    api = build(reduced(get_config(arch)), tp=3)
    with axis_rules({"batch": None}, _StandInMesh()):
        with pytest.raises(ValueError, match="8 SSD heads .* of 3"):
            api.init_cache(2, 9, device="cpu")
        with pytest.raises(ValueError, match="8 SSD heads .* of 3"):
            api.train_loss({}, {"tokens": torch.zeros((1, 3)),
                                "labels": None})
