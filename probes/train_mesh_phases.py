"""``chip_smoke.py``'s LM training phases alone, the mesh ones included:
the kernels' build, then ``lm_train`` (minitron-4b at full width, 24
blocks, bf16), ``lm_train_resilient`` (the 75.5M config, a failure
before step 15), and on a one-rank NCCL group's (1, 1) mesh
``lm_train_mesh`` (``lm_train``'s run through ``make_trainer(cfg,
mesh)``, held bit for bit to it) and ``lm_train_mesh_resilient``
(the failed run with sharded checkpoints and a restart onto a fresh
mesh, held bit for bit to the clean mesh-free run).  Each phase prints
its JSON line as the smoke does, then its seconds.  Needs one card:

    python3 probes/train_mesh_phases.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402


def main() -> int:
    t0 = time.time()
    card = CS.phase_device()
    CS.phase_build()
    print("build s", time.time() - t0, flush=True)
    t = time.time()
    train = CS.phase_lm_train(card)
    print("lm_train s", time.time() - t, flush=True)
    t = time.time()
    resilient = CS.phase_lm_train_resilient(card)
    print("lm_train_resilient s", time.time() - t, flush=True)
    with CS.one_rank_nccl() as mesh:
        t = time.time()
        CS.phase_lm_train_mesh(card, mesh, train)
        print("lm_train_mesh s", time.time() - t, flush=True)
        t = time.time()
        CS.phase_lm_train_mesh_resilient(card, mesh, resilient)
        print("lm_train_mesh_resilient s", time.time() - t, flush=True)
    print("missed", CS.MISSED, "total s", time.time() - t0, flush=True)
    return 1 if CS.MISSED else 0


if __name__ == "__main__":
    sys.exit(main())
