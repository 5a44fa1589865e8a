"""K4's 3xTF32 kernel (route ``sm90_tf32``) against its two shape knobs,
on the card: ``kSGroup`` (k8 steps of S = Q K^T a ``wgmma`` commit
group holds, two groups in flight) and ``kPart`` (O columns a P V
product sums before the kernel adds them into O on the CUDA cores).
Each pair is a copy of ``csrc/attention_block_sm90_tf32.cu`` with those
values, under ``build/attention_tf32_variants/``, all built together;
ptxas' registers and spills are printed per copy.  Each copy runs
phi3-medium-14b's and mixtral-8x7b's f32 attention (hd 128) and two
other head dims at 4096 tokens, held to the plain version at the card's
f32 gate (:data:`~repro_torch.launch.yardstick.CARD_TOL`), launched twice
for equal bits, and timed as ``chip_smoke.py`` times a call
(:func:`~repro_torch.launch.yardstick.time_ms`), in two rounds, the
second in reverse order.

  PYTHONPATH=src python -m repro_torch.launch.attention_tf32_variants [--variants half:1,half:2,32:2]

A variant ``part:group`` names kPart (``half`` for HD / 2, or a column
count) and kSGroup.  Prints one JSON line per copy's build and per
(config, variant).  Needs a CUDA device: a measurement of the card has
no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import re

import torch

from repro_torch.core.exec_target import resolve_device
from repro_torch.kernels.attention_block import kernel as K4
from repro_torch.kernels.attention_block.ref import attention_plain
from repro_torch.kernels.nvcc import BUILD_DIR, build_many
from repro_torch.launch.yardstick import time_ms, within

PART = re.compile(r"static constexpr int kPart = [^;]+;")
GROUP = re.compile(r"constexpr int kSGroup = \d+;")
# name, s, h, kv, hd, window (all causal)
CONFIGS = [("phi3-medium-14b", 4096, 40, 10, 128, 0),
           ("mixtral-8x7b", 8192, 32, 8, 128, 4096),
           ("hd64", 4096, 32, 8, 64, 0), ("hd96", 4096, 32, 8, 96, 0)]


def variants(names: list[str]) -> dict[str, tuple]:
    """Per ``part:group``, the library of a copy of the kernel's source
    with those knobs and its bound C entry, built together."""
    src = K4.TF32_SOURCE.read_text()
    if len(PART.findall(src)) != 1 or len(GROUP.findall(src)) != 1:
        raise ValueError(f"{K4.TF32_SOURCE} must define kPart and kSGroup "
                         f"once each")
    paths = []
    for name in names:
        part, group = name.split(":")
        part = "HD / 2" if part == "half" else str(int(part))
        text = PART.sub(f"static constexpr int kPart = {part};", src)
        text = GROUP.sub(f"constexpr int kSGroup = {int(group)};", text)
        path = (BUILD_DIR / "attention_tf32_variants"
                / name.replace(":", "_") / K4.TF32_SOURCE.name)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        paths.append(path)
    libs = build_many(paths)
    return {n: (lib, lib.bind("attention_block_sm90_tf32_forward", 4, 14))
            for n, lib in zip(names, libs)}


def launch(entry, q, k, v, *, groups: int, window: int,
           causal: bool) -> torch.Tensor:
    """One launch of a copy, as ``K4._sm90_tf32`` launches the kernel."""
    lib, forward = entry
    bh, sq, hd = q.shape
    plan = K4.sm90_tf32_plan(K4.sm90_tf32_head_dim(hd))
    out = torch.empty_like(q)
    err = forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  bh, sq, k.shape[1], hd, plan.width, groups, window,
                  int(causal), plan.raw, plan.split, plan.bars,
                  plan.smem_bytes, 0, 1,
                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_block_sm90_tf32 variant: "
                           f"{lib.error_string(err)} (error {err})")
    return out


def sweep(names: list[str], seed: int = 1) -> list[dict]:
    resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    entries = variants(names)
    for name, (lib, _) in entries.items():
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in lib.log.splitlines()
            if "spill" in ln or "registers" in ln]}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    card = torch.cuda.get_device_name(0)
    rows = []
    for config, s, h, kv, hd, win in CONFIGS:
        q, k, v = (torch.randn((n, s, hd), generator=gen, device="cuda")
                   for n in (h, kv, kv))
        kw = dict(groups=h // kv, window=win, causal=True)
        g = h // kv
        plain = torch.cat([attention_plain(q[i * g:(i + 1) * g],
                                           k[i:i + 1], v[i:i + 1], **kw)
                           for i in range(kv)])
        found = {}
        for name in names:
            out = launch(entries[name], q, k, v, **kw)
            again = launch(entries[name], q, k, v, **kw)
            torch.cuda.synchronize()
            found[name] = {
                "worst_over_tol":
                within(out, plain, torch.float32)["worst_over_tol"],
                "same_bits": bool(torch.equal(out, again)), "ms": []}
        del plain
        for order in (names, names[::-1]):
            for name in order:
                found[name]["ms"].append(time_ms(
                    lambda: launch(entries[name], q, k, v, **kw), flush))
        for name in names:
            row = {"config": config, "variant": name, "hd": hd,
                   **found[name], "card": card}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="half:1,half:2,half:4,32:2",
                    help="comma-separated part:group pairs")
    sweep(ap.parse_args().variants.split(","))


if __name__ == "__main__":
    main()
