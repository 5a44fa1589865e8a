"""The training job of the CPU process group of
``tests/test_torch_parallel_train.py``: ``python -m _torch_mesh_worker
train <rank> <world> <workdir>`` runs :func:`job_train` on every rank
(imports neither JAX nor the reference).

Each case of ``inputs["cases"]`` builds its mesh (the group's (2, 4),
or (8, 1)), carries the reference's numpy params across onto it, takes
``value_and_grad`` of the global batch 0 (this rank's rows) and, where
asked, three steps of ``launch.train.make_step`` on batches 0-2; rank 0
returns the gradients and the params gathered whole.  A case may name a
``control``: a boundary broken for that case alone, monkeypatched here
and never in the program.  Then ``run_resilient`` on (2, 4), once clean
and once failing before a step and restarting onto the (4, 2) mesh of
``plan_remesh``.  Last, ``value_and_grad`` of mamba2 and jamba at tp 4
on (2, 4) (``inputs["mamba_tp4"]``).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.launch import steps
from repro_torch.launch.train import make_step
from repro_torch.models.api import build
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.axes import Mesh, axis_rules
from repro_torch.runtime.elastic import plan_remesh
from repro_torch.runtime.fault_tolerance import (ResilienceConfig,
                                                 run_resilient)

_MESHES: dict = {}


def _mesh(shape, group_mesh):
    """The mesh of ``shape`` over the group (each made once, in the same
    order on every rank)."""
    shape = tuple(shape)
    if shape == tuple(group_mesh.shape.values()):
        return group_mesh
    if shape not in _MESHES:
        _MESHES[shape] = Mesh(shape, ("data", "model"), "cpu")
    return _MESHES[shape]


def _identity(x, *_a, **_kw):
    return x


@contextlib.contextmanager
def _control(name: str | None):
    """``no_model_sum``: the whole residual's entry into the
    column-parallel projections (and the loss) passes its cotangent
    through unsummed; ``no_data_sync``: the gradient sync skipped."""
    patch = {"no_model_sum": (col, "psum_grad", _identity),
             "no_data_sync": (sh, "sync_grads", _identity)}.get(name)
    if patch is None:
        yield
        return
    mod, attr, fn = patch
    saved = getattr(mod, attr)
    setattr(mod, attr, fn)
    try:
        yield
    finally:
        setattr(mod, attr, saved)


def _batch(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in b.items()}


def _counts() -> dict:
    return {f"{op}@{axis}": c["calls"] for (op, axis), c in col.COUNTS.items()}


def _state(params) -> steps.TrainState:
    return steps.TrainState(params=params, opt=adamw.init(params),
                            step=torch.zeros((), dtype=torch.int32))


def _case(group_mesh, case: dict, arch: dict, keep: bool) -> dict:
    mesh = _mesh(case["mesh"], group_mesh)
    cfg = reduced(get_config(arch["arch"]), **arch["over"])
    fsdp, sp_rs = case["fsdp"], case["sp_rs"]
    b, s = arch["batches"][0]["tokens"].shape
    rules = sh.axis_rules(mesh, b, s, fsdp=fsdp, sp_rs=sp_rs)
    api = build(cfg, tp=arch["tp"])
    params = lm_params_from_numpy(arch["params"], "cpu", mesh=mesh,
                                  fsdp=fsdp)
    out: dict = {}
    with _control(case.get("control")):
        with axis_rules(rules, mesh):
            local = sh.shard_batch(_batch(arch["batches"][0]), mesh, rules)
            col.reset()
            loss, grads = steps.value_and_grad(api, params, local)
            out["counts"] = _counts()
            out["local_rows"] = int(local["tokens"].shape[0])
            whole = sh.whole_params(grads, mesh, fsdp)
        out["loss"] = float(loss)
        if keep:
            out["grads"] = lm_params_to_numpy(whole)
        if case.get("steps"):
            run = make_step(cfg, mesh, global_batch=b, seq_len=s,
                            tp=arch["tp"], fsdp=fsdp, sp_rs=sp_rs,
                            **case["schedule"])
            state = _state(params)
            metrics = []
            for batch in arch["batches"]:
                state, m = run(state, _batch(batch))
                metrics.append({k: float(v) for k, v in m.items()})
            out["metrics"] = metrics
            out["step"] = (int(state.step), int(state.opt.step))
            final = sh.whole_params(state.params, mesh, fsdp)
            if keep:
                out["params"] = lm_params_to_numpy(final)
    return out


def _resilient(group_mesh, spec: dict, workdir, keep: bool) -> dict:
    """``run_resilient`` of phi3 on the group's (2, 4) mesh, clean and
    with a failure before ``spec["fail_at"]`` that restarts onto the
    (data, model) mesh ``plan_remesh`` gives for the world at
    ``spec["remesh_tp"]`` (the model built at the padding of its first
    ``tp`` throughout)."""
    arch = spec["arch"]
    cfg = reduced(get_config(arch["arch"]), **arch["over"])
    b, s = arch["batches"][0]["tokens"].shape
    kw = dict(global_batch=b, seq_len=s, tp=arch["tp"], **spec["schedule"])
    batches = arch["batches"]
    out: dict = {}
    for name, fail_at in (("clean", None), ("failed", spec["fail_at"])):
        run = make_step(cfg, group_mesh, **kw)
        state = _state(lm_params_from_numpy(arch["params"], "cpu",
                                            mesh=group_mesh))
        fired, meshes = [], [dict(group_mesh.shape)]

        def hook(step, fail_at=fail_at, fired=fired):
            if step == fail_at and not fired:
                fired.append(step)
                raise RuntimeError("injected node failure")

        def on_restart(restarts, meshes=meshes):
            plan = plan_remesh(dist.get_world_size(), spec["remesh_tp"], b)
            new = _mesh(plan.shape, group_mesh)
            meshes.append(dict(new.shape))
            return make_step(cfg, new, **kw)

        losses = []
        d = os.path.join(str(workdir), f"ckpt_{name}")
        report = run_resilient(
            state, run, lambda i: _batch(batches[i % len(batches)]),
            spec["steps"], ResilienceConfig(ckpt_dir=d,
                                            ckpt_every=spec["every"]),
            failure_hook=hook, on_restart=on_restart,
            metrics_cb=lambda i, m, losses=losses:
                losses.append((i, float(m["loss"]))))
        final_mesh = _mesh(meshes[-1].values(), group_mesh)
        layout = sh.Layout(final_mesh)
        whole = layout.whole(report.final_state)
        res = {"losses": losses, "meshes": meshes,
               "restarts": report.restarts, "steps": report.steps_done,
               "saved": sorted(os.listdir(d)) if keep else None}
        if keep:
            res["final"] = {k: lm_params_to_numpy(getattr(
                whole.opt, k) if k in ("m", "v") else whole.params)
                for k in ("params", "m", "v")}
            res["ckpt"] = _read_step(d, spec["every"])
            res["final_ckpt"] = _read_step(d, spec["steps"])
            # the same state written whole by the mesh-free checkpointer
            ref_dir = os.path.join(str(workdir), f"whole_{name}")
            ckpt.save(ref_dir, 7, whole)
            res["whole_ckpt"] = _read_step(ref_dir, 7)
        out[name] = res
        dist.barrier()
    return out


def _read_step(d: str, step: int) -> dict:
    """A checkpoint step's manifest and arrays, as the files hold them."""
    import json
    path = os.path.join(d, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    manifest.pop("time")
    return {"manifest": manifest, "arrays": arrays}


def job_train(mesh, inp, workdir=None):
    keep = dist.get_rank() == 0
    out = {"cases": {}}
    for name, case in inp["cases"].items():
        out["cases"][name] = _case(mesh, case, inp["archs"][case["arch"]],
                                   keep)
    out["resilient"] = _resilient(mesh, inp["resilient"], workdir, keep)
    # the SSM families on the group's model axis of 4
    out["mamba_tp4"] = {
        arch: _case(mesh, {"mesh": (2, 4), "fsdp": True, "sp_rs": False},
                    spec, keep)
        for arch, spec in inp["mamba_tp4"].items()}
    return out
