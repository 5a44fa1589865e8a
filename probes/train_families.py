"""``chip_smoke.py``'s training phases of the MoE, SSM and hybrid
families and of the other decoder configs alone: the kernels' build,
then ``lm_train_f32`` (its mixtral row at 1 x 8192 under the window,
llava's prefix batch and granite's 48:1 rows with the rows before
them), ``lm_train_moe`` (mixtral-8x7b at full width, 2 blocks, bf16),
``lm_train_ssm`` (mamba2-1.3b at full size, bf16, and its f32 gate
against the CPU), ``lm_train_hybrid`` (jamba at ``reduced()``, f32),
``lm_train_vlm`` (llava-next-34b, 5 layers, through its 2880-embedding
prefix), ``lm_train_mqa`` (granite-34b, 5 layers), ``lm_train_dbrx``
(dbrx-132b, 1 block) and ``lm_train_dense`` (deepseek-7b, 14 layers;
phi3-medium-14b, 8).  Each phase prints its JSON lines as the smoke
does, then its seconds; a phase that fails prints its error and the
card's peak memory, and the others run on (exit 1).  Needs one card:

    python3 probes/train_families.py [f32 moe ssm hybrid vlm mqa dbrx dense]
"""
from __future__ import annotations

import gc
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

PHASES = {"f32": CS.phase_lm_train_f32, "moe": CS.phase_lm_train_moe,
          "ssm": CS.phase_lm_train_ssm, "hybrid": CS.phase_lm_train_hybrid,
          "vlm": CS.phase_lm_train_vlm, "mqa": CS.phase_lm_train_mqa,
          "dbrx": CS.phase_lm_train_dbrx, "dense": CS.phase_lm_train_dense}


def main(names: list[str]) -> int:
    t0 = time.time()
    CS.torch.backends.cuda.matmul.allow_tf32 = False
    CS.torch.backends.cudnn.allow_tf32 = False
    card = CS.phase_device()
    CS.phase_build()
    print("build s", time.time() - t0, flush=True)
    failed = []
    for name in names or list(PHASES):
        t = time.time()
        CS.torch.cuda.reset_peak_memory_stats()
        try:
            PHASES[name](card)
        except Exception:       # the next phase still runs
            traceback.print_exc()
            failed.append(name)
            print(f"{name} failed, peak GB",
                  CS.torch.cuda.max_memory_allocated() / 1e9, flush=True)
            gc.collect()
            CS._free()
        print(f"{name} s", time.time() - t, flush=True)
    print("missed", CS.MISSED, "failed", failed, "total s",
          time.time() - t0, flush=True)
    return 1 if CS.MISSED or failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
