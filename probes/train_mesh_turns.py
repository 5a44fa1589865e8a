"""The mesh trainer's step against the mesh-free trainer's, in turns in
one process: minitron-4b at full width and ``BLOCKS`` blocks in bf16
(two states fit one card), the same seed and batches (8 x 128, the
smoke's schedule), one trainer through ``make_trainer(cfg)`` and one
through ``make_trainer(cfg, mesh)`` on a one-rank NCCL group's (1, 1)
mesh.  Step ``i`` runs both, the mesh-free one first at even ``i``
and second at odd ``i``; each step is timed on the host clock from the
call to a ``torch.cuda.synchronize()`` after its loss and grad norm
are read, and the two steps' losses and grad norms must be equal bit
for bit.  Prints one JSON line: each side's step ms, their medians and
the per-step differences.  Needs one card:

    python3 probes/train_mesh_turns.py
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

BLOCKS = 8
STEPS = 24


def main() -> int:
    card = CS.phase_device()
    CS.phase_build()
    cfg = dataclasses.replace(CS.get_config(CS.LM_TRAIN_ARCH),
                              n_layers=BLOCKS)
    kw = dict(global_batch=CS.LM_TRAIN_B, seq_len=CS.LM_TRAIN_S,
              peak_lr=CS.LM_TRAIN_LR, total_steps=STEPS,
              warmup=CS.LM_TRAIN_WARMUP)
    dc = CS.DataConfig(vocab=cfg.vocab, seq_len=CS.LM_TRAIN_S,
                       global_batch=CS.LM_TRAIN_B, seed=CS.SEED)
    ms = {"mesh_free": [], "mesh": []}
    equal = True
    with CS.one_rank_nccl() as mesh:
        runs = {"mesh_free": list(CS.make_trainer(cfg, device="cuda",
                                                  **kw)[:2]),
                "mesh": list(CS.make_trainer(cfg, mesh, **kw)[:2])}
        for i in range(STEPS):
            batch = CS.global_batch_at(dc, i)
            order = ("mesh_free", "mesh") if i % 2 == 0 \
                else ("mesh", "mesh_free")
            out = {}
            for name in order:
                run, state = runs[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = run(state, batch)
                out[name] = (float(m["loss"]), float(m["grad_norm"]))
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
                runs[name][1] = state
            equal = equal and out["mesh_free"] == out["mesh"]
    diff = [b - a for a, b in zip(ms["mesh_free"], ms["mesh"])]
    print(json.dumps({
        "probe": "train_mesh_turns", "config": CS.LM_TRAIN_ARCH,
        "blocks": BLOCKS, "steps": STEPS, "step_ms": ms,
        "median_ms": {k: float(np.median(v[2:])) for k, v in ms.items()},
        "mesh_minus_free_ms": diff,
        "median_diff_ms": float(np.median(diff[2:])),
        "bit_equal": equal, "card": card}), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
