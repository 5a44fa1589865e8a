"""``chip_smoke.py``'s serving phases of the five decoder configs beyond
phi3 and mixtral alone: the kernels' build, then ``check_attention``
(its decode shapes include granite-34b's 48:1 and llava-next-34b's 56:8
with the kv-head control), ``lm_serve_dense`` (deepseek-7b and
minitron-4b at full size), ``lm_serve_mqa`` (granite-34b, 60 of 88
layers), ``lm_serve_dbrx`` (dbrx-132b, 9 of 40 blocks) and
``lm_serve_vlm`` (llava-next-34b at full size, text only, then its
2880-embedding vision prefix), each with its f32 row.  Each phase prints
its JSON lines as the smoke does, then its seconds.  Needs one card:

    python3 probes/serve_configs.py [check dense mqa dbrx vlm ...]
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

PHASES = {"check": lambda card, flush: CS.phase_check_attention(),
          "dense": CS.phase_lm_serve_dense, "mqa": CS.phase_lm_serve_mqa,
          "dbrx": CS.phase_lm_serve_dbrx, "vlm": CS.phase_lm_serve_vlm}


def main(names: list[str]) -> int:
    t0 = time.time()
    CS.torch.backends.cuda.matmul.allow_tf32 = False
    CS.torch.backends.cudnn.allow_tf32 = False
    card = CS.phase_device()
    CS.phase_build()
    print("build s", time.time() - t0, flush=True)
    flush = CS.torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    for name in names or list(PHASES):
        t = time.time()
        PHASES[name](card, flush)
        print(f"{name} s", time.time() - t, flush=True)
    print("missed", CS.MISSED, "total s", time.time() - t0, flush=True)
    return 1 if CS.MISSED else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
