"""End-to-end LM training driver — the port's copy of
``repro/launch/train.py``, without a mesh (tp = 1, one device).

Builds the model and its train state on the device (``cuda`` unless
``--device cpu``), wires the synthetic data stream and drives the
fault-tolerant step loop with asynchronous checkpoints.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --steps 50 --reduced --batch 8 --seq 128 --device cpu
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
from repro_torch.runtime.fault_tolerance import (ResilienceConfig,
                                                 run_resilient)


def make_trainer(cfg, *, global_batch: int, seq_len: int,
                 peak_lr: float = 3e-4, total_steps: int = 1000,
                 warmup: int | None = None, device="cuda"):
    """Returns (step closure, initial state, api).  The state's params
    are drawn from seed 0 on ``device`` (the reference draws from
    ``PRNGKey(0)``); the closure moves each batch
    there and updates the state in place.  ``global_batch`` and
    ``seq_len`` size the batches the closure will see (the reference
    sizes its shardings by them; one device needs nothing of them)."""
    del global_batch, seq_len
    dev = resolve_device(device)
    api = build(cfg)
    state = steps_mod.init_train_state(
        api, torch.Generator(device=dev).manual_seed(0))
    step_fn = steps_mod.make_train_step(
        api, peak_lr=peak_lr, total=total_steps,
        warmup=warmup if warmup is not None
        else max(1, total_steps // 10))

    def run_step(st, batch):
        batch = {k: torch.as_tensor(v).to(dev, non_blocking=True)
                 for k, v in batch.items()}
        return step_fn(st, batch)

    return run_step, state, api


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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, d_model=128, vocab=512, attn_chunk=64)
    run_step, state, api = make_trainer(
        cfg, global_batch=args.batch, seq_len=args.seq, peak_lr=args.lr,
        total_steps=args.steps, device=args.device)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch)

    losses = []

    def metrics_cb(step, metrics):
        losses.append(float(metrics["loss"]))
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)

    t0 = time.time()
    report = run_resilient(
        state, run_step, lambda s: global_batch_at(dc, s), args.steps,
        ResilienceConfig(ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every),
        metrics_cb=metrics_cb)
    dt = time.time() - t0
    print(f"done: {report.steps_done} steps in {dt:.1f}s "
          f"({report.restarts} restarts); loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}")


if __name__ == "__main__":
    main()
