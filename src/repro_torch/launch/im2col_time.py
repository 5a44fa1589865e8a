"""The im2col staging kernel (``csrc/wgrad_im2col.cu``, the first launch
of K1's and K2's route ``sm90_im2col``) timed alone on the card, at
VGG16/224 conv1_1 (batch 8, 3x3, pad 1: a 32-channel plane), in f32 and
bf16: the checkout's source, and any other copies of the source given
(each named ``wgrad_im2col.cu`` in a directory of its own, for instance
a parent commit's), all built together and timed in alternating rounds.
Each plane is held to the plain version bit for bit.  Two times a
launch: ``device_ms``, back-to-back launches enqueued while the stream
spins (:func:`~repro_torch.launch.yardstick.device_ms`: the kernel's own
time), and ``ms``, one call with the L2 flushed before it as
``chip_smoke.py`` times a row
(:func:`~repro_torch.launch.yardstick.time_ms`: the host's enqueue
when it is the longer).

  PYTHONPATH=src python -m repro_torch.launch.im2col_time [--sources a/wgrad_im2col.cu,...] [--rounds 5]

Prints one JSON line per (round, source, type).  Needs a CUDA device: a
measurement of the card has no CPU fallback.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
from pathlib import Path

import torch

from repro_torch.core.exec_target import resolve_device
from repro_torch.kernels.conv_lb import im2col as I
from repro_torch.kernels.conv_lb.ref import im2col_ref
from repro_torch.kernels.nvcc import build_many
from repro_torch.launch.yardstick import device_ms, time_ms

#: VGG16/224 conv1_1 at batch 8
B, H, W, CI, K = 8, 224, 224, 3, 3


def launch(entry, x: torch.Tensor, plane: torch.Tensor, offs) -> None:
    """One launch of a build of the staging kernel, as
    :func:`~repro_torch.kernels.conv_lb.im2col.stage` launches it."""
    lib, forward = entry
    b, h, wd, ci = x.shape
    _, ho, wo, cp = plane.shape
    err = forward(x.data_ptr(), plane.data_ptr(), ctypes.addressof(offs),
                  b, h, wd, ci, ho, wo, K * K, cp, I.DTYPES[x.dtype],
                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgrad_im2col: {lib.error_string(err)} "
                           f"(error {err})")


def run(sources: list[Path], rounds: int, seed: int = 0) -> list[dict]:
    resolve_device("cuda")
    entries = [(lib, lib.bind("wgrad_im2col_forward", 3, 9))
               for lib in build_many(sources)]
    taps = I.im2col_taps(K, K, (1, 1))
    offs = I._c_ints(tuple(itertools.chain(*taps)))
    cp = I.im2col_channels(CI, K, K)
    gen = torch.Generator().manual_seed(seed)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    card = torch.cuda.get_device_name(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((B, H, W, CI), generator=gen).to("cuda", dtype)
        plain = im2col_ref(x, K, K, padding=(1, 1), channels=cp)
        plane = torch.empty((B, H, W, cp), dtype=dtype, device="cuda")
        for rnd in range(rounds):
            for source, entry in zip(sources, entries):
                plane.fill_(float("nan"))
                launch(entry, x, plane, offs)
                if not torch.equal(plane, plain):
                    raise RuntimeError(f"{source}: the plane differs "
                                       f"from the plain version")
                row = {"round": rnd, "source": str(source),
                       "dtype": str(dtype), "shape": [B, H, W, CI, cp],
                       "device_ms": device_ms(
                           lambda: launch(entry, x, plane, offs)),
                       "ms": time_ms(lambda: launch(entry, x, plane, offs),
                                     flush),
                       "card": card}
                print(json.dumps(row), flush=True)
                rows.append(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sources", default="",
                    help="comma-separated copies of wgrad_im2col.cu")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    extra = [Path(s).resolve() for s in args.sources.split(",") if s]
    run([I.SOURCE, *extra], args.rounds)


if __name__ == "__main__":
    main()
