"""End-to-end LM training driver — the port's copy of
``repro/launch/train.py``.

Builds the model and its train state on the device (``cuda`` unless
``--device cpu``), or on a (data, model) mesh of ``torch.distributed``
ranks (``--mesh host`` under ``torchrun``), wires the synthetic data
stream and drives the fault-tolerant step loop with asynchronous
checkpoints.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --steps 50 --reduced --batch 8 --seq 128 --device cpu
  # on the (1, world) host mesh of 8 gloo ranks; NCCL, one card a rank,
  # without --device
  PYTHONPATH=src torchrun --nproc_per_node 8 -m repro_torch.launch.train \\
      --mesh host --device cpu --reduced
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.exec_target import resolve_device
from repro_torch.data.synthetic import DataConfig, global_batch_at
from repro_torch.launch import steps as steps_mod
from repro_torch.models.api import build
from repro_torch.optim import adamw
from repro_torch.parallel import axes as axes_mod
from repro_torch.parallel import sharding as sh
from repro_torch.runtime.fault_tolerance import (ResilienceConfig,
                                                 run_resilient)


class MeshStep:
    """The train step on a mesh: takes a state of this rank's blocks and
    the global batch, keeps this rank's rows
    (:func:`~repro_torch.parallel.sharding.shard_batch`) on the mesh's
    device, and runs the step under the mesh's rules.  ``layout`` says
    where the state's blocks lie, for the checkpointer and
    ``run_resilient``."""

    def __init__(self, step_fn, api, mesh, rules: dict, layout: sh.Layout):
        self.step_fn, self.api, self.mesh = step_fn, api, mesh
        self.rules, self.layout = rules, layout

    def __call__(self, state, batch):
        with axes_mod.axis_rules(self.rules, self.mesh):
            local = sh.shard_batch(batch, self.mesh, self.rules)
            local = {k: v.to(self.mesh.device, non_blocking=True)
                     for k, v in local.items()}
            return self.step_fn(state, local)


def _schedule(peak_lr: float, total_steps: int, warmup: int | None) -> dict:
    return dict(peak_lr=peak_lr, total=total_steps,
                warmup=warmup if warmup is not None
                else max(1, total_steps // 10))


def make_step(cfg, mesh, *, global_batch: int, seq_len: int,
              peak_lr: float = 3e-4, total_steps: int = 1000,
              warmup: int | None = None, tp: int | None = None,
              fsdp: bool = True, sp_rs: bool = False) -> MeshStep:
    """The train step of ``cfg`` on ``mesh`` (a :class:`MeshStep`), the
    model built at ``tp`` (by default the mesh's "model" size; a state
    restored onto a mesh of another model size keeps the padding of the
    ``tp`` it was made at)."""
    tp = tp or mesh.shape.get("model", 1)
    api = build(cfg, tp=tp)
    rules = sh.axis_rules(mesh, global_batch, seq_len, fsdp=fsdp,
                          sp_rs=sp_rs)
    step_fn = steps_mod.make_train_step(
        api, **_schedule(peak_lr, total_steps, warmup))
    return MeshStep(step_fn, api, mesh, rules,
                    sh.Layout(mesh, fsdp, cfg.moe_ep_data))


def make_trainer(cfg, mesh=None, *, global_batch: int, seq_len: int,
                 peak_lr: float = 3e-4, total_steps: int = 1000,
                 warmup: int | None = None, device="cuda"):
    """Returns (step closure, initial state, api, rules), as the
    reference's.  The state's params are drawn from seed 0 (the
    reference draws from ``PRNGKey(0)``) and updated in place by the
    closure.

    Without a ``mesh`` (``rules`` None): one device, ``device``; the
    closure moves each batch there.  ``global_batch`` and ``seq_len``
    size the batches it will see (the reference sizes its shardings by
    them; one device needs nothing of them).

    On a ``mesh``: the model at ``tp`` = the mesh's "model" size, under
    the reference's ``sharding.axis_rules(mesh, global_batch, seq_len)``
    (ZeRO-3 on, ``sp_rs`` off; :func:`make_step` takes either);
    the whole params drawn on the mesh's device, then this rank's blocks
    kept (``shard_params``; on a mesh that splits nothing, the same
    tensors), the moments zero blocks of the same shapes; the closure is
    a :class:`MeshStep`, which takes the global batch."""
    if mesh is None:
        dev = resolve_device(device)
        api = build(cfg)
        state = steps_mod.init_train_state(
            api, torch.Generator(device=dev).manual_seed(0))
        step_fn = steps_mod.make_train_step(
            api, **_schedule(peak_lr, total_steps, warmup))

        def run_step(st, batch):
            batch = {k: torch.as_tensor(v).to(dev, non_blocking=True)
                     for k, v in batch.items()}
            return step_fn(st, batch)

        return run_step, state, api, None
    run_step = make_step(cfg, mesh, global_batch=global_batch,
                         seq_len=seq_len, peak_lr=peak_lr,
                         total_steps=total_steps, warmup=warmup)
    whole = run_step.api.init(
        torch.Generator(device=mesh.device).manual_seed(0))
    params = run_step.layout.local(whole)
    del whole
    state = steps_mod.TrainState(params=params, opt=adamw.init(params),
                                 step=torch.zeros((), dtype=torch.int32))
    return run_step, state, run_step.api, run_step.rules


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", choices=("none", "host"), default="none",
                    help="host: the (1, world) mesh of the process group "
                         "torchrun starts (NCCL on the card, gloo with "
                         "--device cpu)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, d_model=128, vocab=512, attn_chunk=64)
    mesh = _mesh(args) if args.mesh == "host" else None
    try:
        _train(args, cfg, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _mesh(args):
    """Join torchrun's process group (its environment gives the rank,
    the world and the address) and build the (1, world) mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return make_host_mesh(dev.type)


def _train(args, cfg, mesh) -> None:
    run_step, state, api, rules = make_trainer(
        cfg, mesh, global_batch=args.batch, seq_len=args.seq,
        peak_lr=args.lr, total_steps=args.steps, device=args.device)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch)
    talk = mesh is None or torch.distributed.get_rank() == 0
    losses = []

    def metrics_cb(step, metrics):
        losses.append(float(metrics["loss"]))
        if talk and (step % 5 == 0 or step == args.steps - 1):
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)

    t0 = time.time()
    report = run_resilient(
        state, run_step, lambda s: global_batch_at(dc, s), args.steps,
        ResilienceConfig(ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every),
        metrics_cb=metrics_cb)
    dt = time.time() - t0
    if talk:
        where = "" if mesh is None else f" on mesh {dict(mesh.shape)}"
        print(f"done: {report.steps_done} steps in {dt:.1f}s "
              f"({report.restarts} restarts){where}; loss {losses[0]:.3f} "
              f"-> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
