"""The port's training substrates — the data stream, AdamW, the
schedules, compression, the checkpointer and the runtime — case for
case with the reference's ``tests/test_substrates.py`` (its elastic
re-mesh waits for ``parallel/``), and held against the reference's
modules on the same inputs:

  * AdamW's update fed the reference's gradients (Adam's first steps
    amplify sign noise on near-zero gradients, so both sides get the
    same ones): params and moments within 1e-6 relative over three
    steps, clipped and not, in f32 and bf16;
  * the clip and the schedules equal at steps 0-N (the schedules within
    two f32 ulps: the reference's f32 cosine is not correctly rounded);
  * the compression round trip equal (payload, scale, feedback);
  * the checkpointer's directory layout and manifest keys the
    reference's, and each side restoring the other's checkpoint;
  * ``run_resilient`` driven by the same toy step and failure hook as
    the reference's: equal ``steps_done``, ``restarts``, ``failures``
    and final state; both giving up after ``max_restarts``; the
    straggler monitor's flags and EWMA equal.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jax_ckpt
from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_comp
from repro.optim import schedules as jax_sched
from repro.runtime import fault_tolerance as jax_ft
from repro.runtime.straggler import StragglerMonitor as JaxMonitor
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.data.pipeline import Prefetcher
from repro_torch.data.synthetic import (DataConfig, global_batch_at,
                                        shard_batch_at)
from repro_torch.optim import adamw
from repro_torch.optim.compression import (compress_grads, init_error,
                                           roundtrip)
from repro_torch.optim.schedules import constant, warmup_cosine
from repro_torch.runtime.fault_tolerance import (ResilienceConfig,
                                                 run_resilient)
from repro_torch.runtime.straggler import StragglerMonitor


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _rel(out, ref) -> float:
    out, ref = _np(out).astype(np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


# --------------------------------------------------------------------- data

def test_data_deterministic_and_structured():
    dc = DataConfig(vocab=64, seq_len=32, global_batch=4)
    b1 = global_batch_at(dc, 7)
    b2 = global_batch_at(dc, 7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], global_batch_at(dc, 8)["tokens"])
    # labels are next tokens
    assert torch.equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    # markov structure: majority of transitions follow the affine map
    nxt = (b1["tokens"] * 31 + 7) % dc.vocab
    agree = float((nxt == b1["labels"]).float().mean())
    assert agree > 0.7


def test_data_follows_the_markov_rule_at_one_minus_noise():
    """Over many tokens the rule holds at ~1 - noise (+ noise / V for a
    uniform draw that lands on the rule's token), per step and seed."""
    for noise in (0.1, 0.3):
        dc = DataConfig(vocab=128, seq_len=256, global_batch=16, seed=3,
                        noise=noise)
        b = global_batch_at(dc, 5)
        agree = float(((b["tokens"] * 31 + 7) % dc.vocab
                       == b["labels"]).float().mean())
        want = 1 - noise + noise / dc.vocab
        assert abs(agree - want) < 0.02, (noise, agree)
        assert b["tokens"].min() >= 0 and b["tokens"].max() < dc.vocab
    other = global_batch_at(DataConfig(vocab=128, seq_len=256,
                                       global_batch=16, seed=4), 5)
    assert not torch.equal(other["tokens"], b["tokens"])


def test_data_uses_no_global_rng_state():
    dc = DataConfig(vocab=64, seq_len=16, global_batch=4)
    torch.manual_seed(0)
    a = global_batch_at(dc, 2)
    torch.manual_seed(123)
    torch.rand(10)
    b = global_batch_at(dc, 2)
    assert torch.equal(a["tokens"], b["tokens"])


def test_data_sharding_partitions_batch():
    dc = DataConfig(vocab=64, seq_len=16, global_batch=8)
    full = global_batch_at(dc, 3)
    parts = [shard_batch_at(dc, 3, i, 4) for i in range(4)]
    recon = torch.cat([p["tokens"] for p in parts], dim=0)
    assert torch.equal(recon, full["tokens"])
    assert torch.equal(torch.cat([p["labels"] for p in parts]),
                       full["labels"])


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetcher_orders_and_overlaps(device):
    seen = []
    pf = Prefetcher(lambda s: {"x": torch.full((2,), s)}, depth=2,
                    device=device)
    for _ in range(5):
        step, batch = next(pf)
        seen.append((step, int(batch["x"][0])))
    pf.close()
    assert seen == [(i, i) for i in range(5)]
    assert not pf._thread.is_alive()


def test_prefetcher_starts_at_a_step():
    dc = DataConfig(vocab=64, seq_len=8, global_batch=2)
    pf = Prefetcher(lambda s: global_batch_at(dc, s), start_step=10)
    step, batch = next(pf)
    pf.close()
    assert step == 10
    assert torch.equal(batch["tokens"], global_batch_at(dc, 10)["tokens"])


# ---------------------------------------------------------------- optimizer

def test_adamw_decreases_quadratic():
    params = {"w": torch.ones((4,)) * 5.0}
    state = adamw.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw.update(params, grads, state, lr=0.1,
                                        wd=0.0)
    assert float(params["w"].abs().max()) < 0.5


def test_adamw_moments_follow_param_dtype():
    params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    state = adamw.init(params)
    assert state.m["w"].dtype == torch.bfloat16
    assert state.step.dtype == torch.int32 and int(state.step) == 0


def test_clip_by_global_norm():
    grads = {"a": torch.full((10,), 100.0)}
    clipped, norm = adamw.clip_by_global_norm(grads, 1.0)
    assert float(adamw.global_norm(clipped)) == pytest.approx(1.0,
                                                              rel=1e-5)
    assert float(norm) == pytest.approx(float(np.sqrt(10) * 100),
                                        rel=1e-6)


def _tree(rng, dtype):
    """A params-like tree: a dict holding a list of dicts, mixed
    sizes, some gradients near zero."""
    def a(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    t = {"embed": a(40, 8), "blocks": [{"w": a(8, 8), "ln": a(8)},
                                       {"w": a(8, 8), "ln": a(8)}],
         "tiny": a(16, scale=1e-7)}
    if dtype == "bfloat16":
        t = jax.tree_util.tree_map(
            lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), t)
    return t


def _torch_tree(tree):
    def t(x):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(x.copy())
    return jax.tree_util.tree_map(t, tree)


@pytest.mark.parametrize("dtype,clip", [("float32", 1.0), ("float32", 0.0),
                                        ("float32", 1e3),
                                        ("bfloat16", 1.0)])
def test_adamw_update_matches_reference_on_its_gradients(dtype, clip):
    rng = np.random.default_rng(0)
    jparams = jax.tree_util.tree_map(jnp.asarray, _tree(rng, dtype))
    jstate = jax_adamw.init(jparams)
    params = _torch_tree(jax.tree_util.tree_map(np.asarray, jparams))
    state = adamw.init(params)
    for i, lr in enumerate((1e-2, 3e-3, 5e-2)):
        grads = _tree(rng, dtype)
        jparams, jstate, jnorm = jax_adamw.update(
            jparams, jax.tree_util.tree_map(jnp.asarray, grads), jstate,
            lr=lr, clip=clip)
        params, state, norm = adamw.update(params, _torch_tree(grads),
                                           state, lr=lr, clip=clip)
        assert abs(float(norm) - float(jnorm)) <= 1e-6 * float(jnorm)
        for mine, ref in ((params, jparams), (state.m, jstate.m),
                          (state.v, jstate.v)):
            for x, y in zip(jax.tree_util.tree_leaves(mine),
                            jax.tree_util.tree_leaves(ref)):
                assert x.dtype == getattr(torch, dtype)
                tol = 1e-6 if dtype == "float32" else 2 ** -8
                assert _rel(x, np.asarray(y.astype(jnp.float32))) <= tol, i
        assert int(state.step) == int(jstate.step) == i + 1


def test_clip_matches_reference():
    rng = np.random.default_rng(1)
    grads = _tree(rng, "float32")
    for max_norm in (0.5, 1e3):
        jc, jn = jax_adamw.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, grads), max_norm)
        c, n = adamw.clip_by_global_norm(_torch_tree(grads), max_norm)
        assert _rel(n, jn) <= 1e-6
        for x, y in zip(jax.tree_util.tree_leaves(c),
                        jax.tree_util.tree_leaves(jc)):
            assert _rel(x, y) <= 1e-6


def test_schedule_warmup_then_decay():
    lr0 = warmup_cosine(0, peak_lr=1.0, warmup=10, total=100)
    lr_peak = warmup_cosine(10, peak_lr=1.0, warmup=10, total=100)
    lr_end = warmup_cosine(100, peak_lr=1.0, warmup=10, total=100)
    assert lr0 == 0.0 and lr_peak == pytest.approx(1.0)
    assert lr_end == pytest.approx(0.1, rel=1e-3)


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 2, 20),
                                               (1e-3, 100, 10_000),
                                               (1.0, 0, 7)])
def test_schedules_match_reference(peak, warmup, total):
    for step in list(range(0, total + 3)) + [total * 2]:
        ref = float(jax_sched.warmup_cosine(step, peak_lr=peak,
                                            warmup=warmup, total=total))
        out = warmup_cosine(step, peak_lr=peak, warmup=warmup, total=total)
        # f32 arithmetic on both sides; XLA's f32 cosine is not
        # correctly rounded, the port's is: two f32 ulps apart at most
        assert abs(out - ref) <= 2 ** -22 * abs(ref), (step, out, ref)
        assert constant(step, peak_lr=peak) == float(
            jax_sched.constant(step, peak_lr=peak))


# -------------------------------------------------------------- compression

@pytest.mark.parametrize("seed", range(6))
def test_compression_error_feedback_bounded(seed):
    g = {"w": torch.randn((64, 64),
                          generator=torch.Generator().manual_seed(seed))}
    err = init_error(g)
    deq, err = roundtrip(g, err)
    # one-step quantization error < 1% of amax per element
    amax = float(g["w"].abs().max())
    assert float((deq["w"] - g["w"]).abs().max()) <= amax / 127 + 1e-6


def test_compression_error_feedback_converges():
    """Accumulated error feedback keeps the running sum faithful."""
    g = {"w": torch.randn((32, 32),
                          generator=torch.Generator().manual_seed(0))}
    err = init_error(g)
    total_true = torch.zeros((32, 32))
    total_sent = torch.zeros((32, 32))
    for _ in range(20):
        deq, err = roundtrip(g, err)
        total_true += g["w"]
        total_sent += deq["w"]
    amax = float(g["w"].abs().max())
    assert float((total_true - total_sent).abs().max()) < 3 * amax / 127


def test_compression_roundtrip_matches_reference():
    rng = np.random.default_rng(2)
    grads = {"a": rng.standard_normal((16, 8)).astype(np.float32),
             "b": [rng.standard_normal(5).astype(np.float32) * 1e-3]}
    jgrads = jax.tree_util.tree_map(jnp.asarray, grads)
    jerr = jax_comp.init_error(jgrads)
    tgrads = _torch_tree(grads)
    err = init_error(tgrads)
    for _ in range(3):
        jpay, _ = jax_comp.compress_grads(jgrads, jerr)
        pay, _ = compress_grads(tgrads, err)
        np.testing.assert_array_equal(pay["a"][0].numpy(),
                                      np.asarray(jpay["a"][0]))
        assert float(pay["a"][1]) == float(jpay["a"][1])
        jdeq, jerr = jax_comp.roundtrip(jgrads, jerr)
        deq, err = roundtrip(tgrads, err)
        for x, y in zip(jax.tree_util.tree_leaves(deq) +
                        jax.tree_util.tree_leaves(err),
                        jax.tree_util.tree_leaves(jdeq) +
                        jax.tree_util.tree_leaves(jerr)):
            assert _rel(x, y) <= 1e-6


# ---------------------------------------------------------------- checkpoint

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1.5, -2.25, 3.0, 1 / 3],
                                    dtype=torch.bfloat16)},
            "s": torch.tensor(7, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 5, tree)
    like = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(
        4, dtype=torch.bfloat16)}, "s": torch.zeros((), dtype=torch.int32)}
    restored, step = ckpt.restore_latest(str(tmp_path), like)
    assert step == 5
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    assert restored["s"].dtype == torch.int32 and int(restored["s"]) == 7


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.ones((2,))})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 1, {"a": torch.ones((3,))})


def test_checkpoint_picks_latest_complete(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.ones((2,))})
    ckpt.save(str(tmp_path), 2, {"a": torch.ones((2,)) * 2})
    # a torn save (no manifest) must be ignored
    os.makedirs(tmp_path / "step_00000099")
    restored, step = ckpt.restore_latest(str(tmp_path),
                                         {"a": torch.zeros((2,))})
    assert step == 2
    assert float(restored["a"][0]) == 2.0


def test_async_checkpointer_gc(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        saver.submit(s, {"a": torch.full((2,), float(s))})
        saver.wait()
        time.sleep(0.05)
    saver.close()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step"))
    assert len(steps) <= 2
    assert ckpt.latest_step(str(tmp_path)) == 30
    assert len(saver.save_seconds) == 3


def test_async_checkpointer_saves_the_state_as_submitted(tmp_path):
    """The trainer updates its tensors in place after ``submit``: the
    snapshot taken at submit is what lands on disk."""
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    w = torch.zeros(1000)
    saver.submit(1, {"w": w})
    w += 1.0
    saver.wait()
    saver.close()
    restored, _ = ckpt.restore_latest(str(tmp_path), {"w": w})
    assert not restored["w"].any()


def test_async_checkpointer_under_contention(tmp_path):
    """Submits racing the worker (a shortened switch interval): after
    ``wait`` the newest submitted step is on disk and the worker idle;
    ``close`` ends the thread."""
    import sys
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
        for s in range(1, 41):
            saver.submit(s, {"a": torch.full((64,), float(s))})
        saver.wait(timeout=60)
        assert not saver._busy
        assert ckpt.latest_step(str(tmp_path)) == 40
        restored, _ = ckpt.restore_latest(str(tmp_path),
                                          {"a": torch.zeros(64)})
        assert float(restored["a"][0]) == 40.0
        saver.close()
        assert not saver._thread.is_alive()
    finally:
        sys.setswitchinterval(interval)


def _layout(path):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return sorted(os.listdir(path)), manifest


def test_checkpoint_layout_and_manifest_are_the_references(tmp_path):
    """The same tree (dicts only: both sides flatten keys in sorted
    order) saved by each side gives the same files, manifest keys,
    names, dtypes and shapes; each side restores the other's."""
    arrays = {"w": np.arange(6, dtype=np.float32).reshape(3, 2),
              "n": {"x": np.float32([0.5, 1.5]),
                    "k": np.int32([3, 4, 5])}}
    jtree = jax.tree_util.tree_map(jnp.asarray, arrays)
    jtree["n"]["h"] = jnp.asarray([1.0, -0.5], jnp.bfloat16)
    tree = {"w": torch.from_numpy(arrays["w"]),
            "n": {"x": torch.from_numpy(arrays["n"]["x"]),
                  "k": torch.from_numpy(arrays["n"]["k"]),
                  "h": torch.tensor([1.0, -0.5], dtype=torch.bfloat16)}}
    mine = ckpt.save(str(tmp_path / "port"), 3, tree)
    ref = jax_ckpt.save(str(tmp_path / "ref"), 3, jtree)
    assert os.path.basename(mine) == os.path.basename(ref) == "step_00000003"
    (files, m), (rfiles, rm) = _layout(mine), _layout(ref)
    assert files == rfiles == ["manifest.json", "shard_0.npz"]
    assert m.keys() == rm.keys()
    for key in ("step", "n_hosts", "names", "dtypes", "shapes"):
        assert m[key] == rm[key], key
    with np.load(os.path.join(mine, "shard_0.npz")) as a, \
            np.load(os.path.join(ref, "shard_0.npz")) as b:
        assert a.files == b.files
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])
    back, _ = jax_ckpt.restore_latest(str(tmp_path / "port"), jtree)
    assert back["n"]["h"].dtype == jnp.bfloat16
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32))
    like = jax.tree_util.tree_map(torch.zeros_like, tree)
    mine_back, _ = ckpt.restore_latest(str(tmp_path / "ref"), like)
    for x, y in zip(jax.tree_util.tree_leaves(mine_back),
                    jax.tree_util.tree_leaves(tree)):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------------------------------ runtime

def _toy_step(state, batch):
    return state + batch, {"loss": float(state)}


def _failing_once_at(step_no):
    calls = {"n": 0}

    def hook(step):
        if step == step_no and calls["n"] == 0:
            calls["n"] = 1
            raise RuntimeError("injected node failure")
    return hook


def test_run_resilient_recovers_from_injected_failure(tmp_path):
    report = run_resilient(
        torch.zeros(()), _toy_step, lambda s: torch.ones(()), 12,
        ResilienceConfig(ckpt_dir=str(tmp_path), ckpt_every=5,
                         async_save=False),
        failure_hook=_failing_once_at(7))
    assert report.steps_done == 12
    assert report.restarts == 1
    # replay is exact: 12 deterministic increments
    assert float(report.final_state) == 12.0


@pytest.mark.parametrize("async_save", [False, True])
def test_run_resilient_matches_reference(tmp_path, async_save):
    """The same toy step, batches and failures (steps 7 and 13, once
    each) through both loops."""
    def hooks():
        a, b = _failing_once_at(7), _failing_once_at(13)

        def hook(step):
            a(step)
            b(step)
        return hook
    cfg = dict(ckpt_every=5, async_save=async_save, keep=2)
    ref = jax_ft.run_resilient(
        jnp.zeros(()), _toy_step, lambda s: jnp.asarray(float(s % 3)), 17,
        jax_ft.ResilienceConfig(ckpt_dir=str(tmp_path / "ref"), **cfg),
        failure_hook=hooks())
    mine = run_resilient(
        torch.zeros(()), _toy_step, lambda s: torch.tensor(float(s % 3)), 17,
        ResilienceConfig(ckpt_dir=str(tmp_path / "port"), **cfg),
        failure_hook=hooks())
    assert mine.steps_done == ref.steps_done == 17
    assert mine.restarts == ref.restarts == 2
    assert mine.failures == ref.failures
    assert float(mine.final_state) == float(ref.final_state)
    if async_save:
        # the reference's wait() may return before the save in flight
        # ends, so it can restore an older step and replay more steps
        assert len(mine.step_times) <= len(ref.step_times)
    else:
        assert len(mine.step_times) == len(ref.step_times)


def test_run_resilient_resumes_from_a_checkpoint(tmp_path):
    cfg = ResilienceConfig(ckpt_dir=str(tmp_path), ckpt_every=4,
                           async_save=False)
    first = run_resilient(torch.zeros(()), _toy_step,
                          lambda s: torch.ones(()), 6, cfg)
    assert first.steps_done == 6
    again = run_resilient(torch.zeros(()), _toy_step,
                          lambda s: torch.ones(()), 10, cfg)
    assert again.steps_done == 10 and float(again.final_state) == 10.0
    assert len(again.step_times) == 4


def test_run_resilient_gives_up_after_max_restarts(tmp_path):
    def step_fn(state, batch):
        raise RuntimeError("permanently broken")

    for run, cfg_cls, zero in (
            (run_resilient, ResilienceConfig, torch.zeros(())),
            (jax_ft.run_resilient, jax_ft.ResilienceConfig, jnp.zeros(()))):
        with pytest.raises(RuntimeError, match="max_restarts=2"):
            run(zero, step_fn, lambda s: 0, 5,
                cfg_cls(ckpt_dir=str(tmp_path / run.__module__),
                        max_restarts=2, async_save=False))


def test_on_restart_rebuilds_the_step(tmp_path):
    rebuilt = []

    def on_restart(n):
        rebuilt.append(n)
        return lambda st, b: (st + 2 * b, {})
    report = run_resilient(
        torch.zeros(()), _toy_step, lambda s: torch.ones(()), 6,
        ResilienceConfig(ckpt_dir=str(tmp_path), ckpt_every=3,
                         async_save=False),
        failure_hook=_failing_once_at(4), on_restart=on_restart)
    assert rebuilt == [1]
    assert float(report.final_state) == 3.0 + 2 * 3.0


def test_straggler_monitor_flags_outlier():
    mon = StragglerMonitor(threshold=3.0, warmup=1)
    flagged = []
    for step, dt in enumerate([1.0, 1.0, 1.1, 0.9, 5.0, 1.0]):
        if mon.record(step, dt):
            flagged.append(step)
    assert flagged == [4]
    # EWMA not polluted by the outlier
    assert mon.ewma < 1.5


def test_straggler_monitor_matches_reference():
    times = list(np.random.default_rng(4).exponential(1.0, 50))
    times[20] = 40.0
    a, b = StragglerMonitor(), JaxMonitor()
    flags = [(a.record(i, t), b.record(i, t)) for i, t in enumerate(times)]
    assert all(x == y for x, y in flags) and any(x for x, _ in flags)
    assert a.ewma == b.ewma and a.times == b.times
    assert [(e.step, e.duration, e.ewma) for e in a.events] == \
        [(e.step, e.duration, e.ewma) for e in b.events]
