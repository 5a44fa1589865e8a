"""How far apart two correct bf16 computations of phi3-medium-14b's long
decode lie: the floor under ``chip_smoke.py``'s ``lm_long_dense`` logits
gate (2e-2 of max |plain| at 40 layers).

On the smoke's weights and prompts (seed 0; two 32768-token prompts
drawn as ``lm_long_dense`` draws them), one served prefill, then
``--steps`` greedy decode steps, each from a clone of its caches also
run as: the plain replay (``attn="plain"``, the model's
``decode_attention`` at its 1024-slot chunk); the plain replay at a
2048-slot chunk (a second plain attention, other summation order, no
kernel); and the plain replay in f32 (every block's bf16 weights
widened as it runs, the bf16 cache read in f32).  Prints, per step, the
max |err| over max |ref| over the real vocabulary of: served against
plain (the smoke's reading), plain at 2048 against plain (the floor
between two plain attentions), served and plain each against the f32
replay.  Needs one card:

    python3 probes/long_replay_floor.py [--steps 16]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402
from chip_smoke import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = CS.phase_device()
    CS.phase_build()
    t0 = time.time()
    cfg = CS.get_config(CS.LM_ARCH)
    gen = torch.Generator().manual_seed(CS.SEED + 71)
    b, s = CS.LONG_DENSE_BATCH, CS.LONG_S
    max_seq = s + args.steps
    api = CS.build_lm(cfg)
    wide = CS.build_lm(dataclasses.replace(cfg, attn_chunk=2048))
    f32 = CS.build_lm(dataclasses.replace(cfg, compute_dtype=torch.float32))
    params = api.init(torch.Generator(device="cuda").manual_seed(CS.SEED),
                      cast_blocks=True)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen).cuda()
    logits, caches = api.prefill(params, {"tokens": toks}, max_seq=max_seq)
    tok = logits[..., :cfg.vocab].argmax(-1).reshape(b, 1)
    rows = []
    for pos in range(s, max_seq):
        def replay(model, attn):
            return model.decode_step(params, CS.clone_caches(caches), tok,
                                     pos, attn=attn)[0]
        plain = replay(api, "plain")
        other = replay(wide, "plain")
        with CS.patched((CS.LM_T, "cast_params_for_compute", CS.widen)):
            exact = replay(f32, "plain")
        logits, caches = api.decode_step(params, caches, tok, pos)
        row = {"pos": pos,
               "served_vs_plain": CS._rel(logits, plain, cfg.vocab),
               "plain2048_vs_plain": CS._rel(other, plain, cfg.vocab),
               "served_vs_f32": CS._rel(logits, exact, cfg.vocab),
               "plain_vs_f32": CS._rel(plain, exact, cfg.vocab),
               "plain2048_vs_f32": CS._rel(other, exact, cfg.vocab)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        tok = logits[..., :cfg.vocab].argmax(-1).reshape(b, 1)
    summary = {k: {"max": max(r[k] for r in rows),
                   "mean": sum(r[k] for r in rows) / len(rows)}
               for k in rows[0] if k != "pos"}
    print(json.dumps({"summary": summary, "steps": len(rows),
                      "seconds": time.time() - t0, "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
