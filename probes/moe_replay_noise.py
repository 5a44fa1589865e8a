"""How far mixtral-8x7b's random-weight bf16 decode carries one rounding.

Serves mixtral-8x7b at full width and ``chip_smoke.MOE_LAYERS`` blocks
in bf16 through ``BatchedServer`` as ``chip_smoke.py``'s
``lm_serve_moe`` phase does, then replays every served step from a
clone of its caches under the served routing:

  * ``plain``: the plain attention (the smoke's replay), against the
    served logits;
  * ``noisy``: the same plain replay with each attention output word
    scaled by 1 - 2^-8, 1 or 1 + 2^-8 at random (about one bf16 ulp
    down, none, or up; no kernel in it), against the noise-free replay.

At the step where ``plain`` errs most it also prints the residual
stream after each layer: its rms, and its max error over max |plain|
for the served path and for the noisy replay.  Every logits error is
max |a - b| over max |b| on the vocabulary's columns.  Needs one card:

    python3 probes/moe_replay_noise.py
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as C  # noqa: E402


@contextlib.contextmanager
def ulp_noise(gen: torch.Generator):
    plain = C.LM_A.decode_attention

    def noisy(*args, **kw):
        out = plain(*args, **kw)
        step = torch.randint(-1, 2, out.shape, device=out.device,
                             generator=gen)
        return (out.float() * (1 + step * 2.0 ** -8)).to(out.dtype)
    with C.patched((C.LM_A, "decode_attention", noisy)):
        yield


@contextlib.contextmanager
def residuals(into: list):
    """The residual stream after every layer's FFN, in call order."""
    ffn = C.LM_T._apply_ffn

    def record(*args, **kw):
        h = ffn(*args, **kw)
        into.append(h.float())
        return h
    with C.patched((C.LM_T, "_apply_ffn", record)):
        yield


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_replay_noise: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(C.card_line(), flush=True)
    cfg = dataclasses.replace(C.get_config(C.MOE_ARCH),
                              n_layers=C.MOE_LAYERS)
    server = C.BatchedServer(cfg, slots=C.LM_SLOTS, max_seq=C.LM_MAX_SEQ,
                             device="cuda", seed=C.SEED)
    routing = C.Routing(C.moe_layers(cfg))
    with routing.record():
        steps, _ = C.serve_lm(server, C.lm_requests(cfg, C.SEED + 12),
                              "sm90", cfg.n_layers)
    api, params = server.api, server.params
    gen = torch.Generator(device="cuda").manual_seed(C.SEED + 100)
    plain_errs, noise_errs = [], []
    for i, (caches, tok, pos, logits) in enumerate(steps):
        with routing.served(i):
            plain, _ = api.decode_step(params, C.clone_caches(caches), tok,
                                       pos, attn="plain")
        with routing.served(i), ulp_noise(gen):
            noisy, _ = api.decode_step(params, C.clone_caches(caches), tok,
                                       pos, attn="plain")
        plain_errs.append(C._rel(logits, plain, cfg.vocab))
        noise_errs.append(C._rel(noisy, plain, cfg.vocab))
    worst = max(range(len(steps)), key=plain_errs.__getitem__)
    caches, tok, pos, _ = steps[worst]
    runs = {}
    for name, attn, noise in (("served", "kernel", False),
                              ("plain", "plain", False),
                              ("noisy", "plain", True)):
        runs[name] = []
        with routing.served(worst), residuals(runs[name]), \
                (ulp_noise(gen) if noise else contextlib.nullcontext()):
            api.decode_step(params, C.clone_caches(caches), tok, pos,
                            attn=attn)
    C.emit({"probe": "moe_replay_noise", "config": cfg.name,
            "layers": cfg.n_layers, "steps": len(steps),
            "plain_vs_served": plain_errs, "noisy_vs_plain": noise_errs,
            "plain_vs_served_max": max(plain_errs),
            "noisy_vs_plain_min": min(noise_errs),
            "noisy_vs_plain_max": max(noise_errs),
            "worst_step_pos": pos,
            "residual_rms": [h.square().mean().sqrt().item()
                             for h in runs["plain"]],
            "residual_served_vs_plain": [
                rel(a, b) for a, b in zip(runs["served"], runs["plain"])],
            "residual_noisy_vs_plain": [
                rel(a, b) for a, b in zip(runs["noisy"], runs["plain"])]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
