"""``chip_smoke.py``'s long-context phases alone: the kernels' build,
then ``lm_attention_long`` (K4 alone at phi3-medium-14b's 32768-token
causal prefill and decode and mixtral-8x7b's windowed prefill of 32768
and 524288 tokens, held on their panels), ``lm_long_dense``
(phi3-medium-14b at full size over two 32768-token prompts and 16
decode steps, with its f32 row) and ``lm_long_window`` (mixtral-8x7b at
20 of 32 blocks over a 32768-token prompt under its 4096 window, with
its f32 row).  A failed phase prints its error and peak memory; the
others run on.  Each phase prints its JSON lines as the smoke does,
then its seconds.  Needs one card:

    python3 probes/long_context.py [attention dense window ...]
"""
from __future__ import annotations

import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

PHASES = {"attention": CS.phase_lm_attention_long,
          "dense": CS.phase_lm_long_dense,
          "window": CS.phase_lm_long_window}


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
        try:
            PHASES[name](card)
        except Exception:
            traceback.print_exc()
            print(f"{name} failed; peak GB",
                  CS.torch.cuda.max_memory_allocated() / 1e9, flush=True)
            failed.append(name)
            CS._free()
        print(f"{name} s", time.time() - t, flush=True)
    print("missed", CS.MISSED, "failed", failed, "total s",
          time.time() - t0, flush=True)
    return 1 if CS.MISSED or failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
