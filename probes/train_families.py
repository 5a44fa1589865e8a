"""``chip_smoke.py``'s training phases of the MoE, SSM and hybrid
families alone: the kernels' build, then ``lm_train_f32`` (its mixtral
row at 1 x 8192 under the window with the rows before it),
``lm_train_moe`` (mixtral-8x7b at full width, 2 blocks, bf16),
``lm_train_ssm`` (mamba2-1.3b at full size, bf16, and its f32 gate
against the CPU) and ``lm_train_hybrid`` (jamba at ``reduced()``, f32).
Each phase prints its JSON line as the smoke does, then its seconds.
Needs one card:

    python3 probes/train_families.py [phase ...]
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

PHASES = {"f32": CS.phase_lm_train_f32, "moe": CS.phase_lm_train_moe,
          "ssm": CS.phase_lm_train_ssm, "hybrid": CS.phase_lm_train_hybrid}


def main(names: list[str]) -> int:
    t0 = time.time()
    CS.torch.backends.cuda.matmul.allow_tf32 = False
    CS.torch.backends.cudnn.allow_tf32 = False
    card = CS.phase_device()
    CS.phase_build()
    print("build s", time.time() - t0, flush=True)
    for name in names or list(PHASES):
        t = time.time()
        PHASES[name](card)
        print(f"{name} s", time.time() - t, flush=True)
    print("missed", CS.MISSED, "total s", time.time() - t0, flush=True)
    return 1 if CS.MISSED else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
