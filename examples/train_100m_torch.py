"""End-to-end driver on the PyTorch port: train a ~100M-parameter LM
with the full stack (synthetic data, asynchronous checkpoints, the
fault-tolerant loop) — the sibling of ``examples/train_100m.py``.

  PYTHONPATH=src python examples/train_100m_torch.py --steps 200 \\
      [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""

import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataConfig, global_batch_at
from repro_torch.launch.train import make_trainer
from repro_torch.runtime.fault_tolerance import (ResilienceConfig,
                                                 run_resilient)


def config():
    """The ~100M-parameter member of the minitron family."""
    return dataclasses.replace(
        get_config("minitron-4b"), n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=2048, vocab=32768, head_dim=64,
        attn_chunk=256)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = config()
    n_params = cfg.param_count()
    print(f"config: {cfg.name}-100m  ~{n_params/1e6:.0f}M params")

    run_step, state, api, _rules = make_trainer(
        cfg, global_batch=args.batch, seq_len=args.seq, peak_lr=1e-3,
        total_steps=args.steps, device=args.device)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch)

    losses = []
    t_last = [time.time()]

    def metrics_cb(step, metrics):
        losses.append(float(metrics["loss"]))
        if step % 20 == 0 or step == args.steps - 1:
            dt = max(time.time() - t_last[0], 1e-9)
            t_last[0] = time.time()
            tok_s = args.batch * args.seq * min(step + 1, 20) / dt
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  "
                  f"{tok_s:,.0f} tok/s", flush=True)

    t0 = time.time()
    report = run_resilient(
        state, run_step, lambda s: global_batch_at(dc, s), args.steps,
        ResilienceConfig(ckpt_dir=args.ckpt_dir, ckpt_every=50),
        metrics_cb=metrics_cb)
    times = report.step_times
    dt = time.time() - t0
    print(f"\n{report.steps_done} steps in {dt/60:.1f} min; "
          f"loss {losses[0]:.3f} -> {min(losses[-10:]):.3f}; "
          f"{report.restarts} restarts; "
          f"median step {sorted(times)[len(times)//2]:.2f}s")
    return report


if __name__ == "__main__":
    main()
