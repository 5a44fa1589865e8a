"""K2's tensor-core kernels at every tile their plans rank, on the
card: for each VGG16/224 layer after conv1_1 (conv1_2 ... conv5_3, batch
8), in bf16 on ``sm90`` (:func:`~repro_torch.kernels.conv_lb.wgrad.
sm90_wgrad_plan`) or with ``--dtype f32`` on ``sm90_tf32`` in 3xTF32
(:func:`~repro_torch.kernels.conv_lb.wgrad.sm90_tf32_wgrad_plan`), each
``(bn, nwc, cib)`` that fits, launched on that tile with the split the
plan ranks best for it, held to the plain version (``WGRAD_TOL`` of max
|plain|) and timed as ``chip_smoke.py`` times a layer (CUDA events
around one call, L2 flushed, mean of 10), beside cuDNN's
``conv2d_weight`` in the same type (TF32 off) and the tile the plan
picks.

  PYTHONPATH=src python -m repro_torch.launch.wgrad_tiles [--dtype f32] [--layers conv5_1]
  PYTHONPATH=src python -m repro_torch.launch.wgrad_tiles [--dtype f32] --ranges

Prints one JSON line per (layer, tile) and one per layer.  ``--ranges``
instead runs conv1_2 (the longest reduction, 6,272 pixel blocks) on the
plan's tile at split ranges of several lengths, past the plan's cap
(``SM90_MAX_RANGE``, ``TF32_MAX_RANGE``) too, each with its error
against the plain version:
the tensor cores' f32 sums drift with the length of a range.  Needs a
CUDA device: a measurement of the card has no CPU fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.core.exec_target import resolve_device
from repro_torch.kernels.conv_lb import wgrad as W
from repro_torch.kernels.conv_lb.ref import wgrad_ref
from repro_torch.launch.yardstick import WGRAD_TOL
from repro_torch.launch.yardstick import time_ms as _time_ms
from repro_torch.models.cnn import vgg_layer_dims

#: per type: the plan, the kernel's launcher and the tiles it may pick
KERNELS = {
    "bf16": (torch.bfloat16, W.sm90_wgrad_plan, W._sm90,
             [(bn, nwc, cib) for bn, nwc in W.SM90_TILES
              for cib in W.SM90_CIBS]),
    "f32": (torch.float32, W.sm90_tf32_wgrad_plan, W._sm90_tf32,
            [(bn, nwc, cib) for bn, nwc in W.TF32_TILES
             for cib in W.TF32_CIBS]),
}


def sweep(layers: list[str] | None = None, batch: int = 8,
          seed: int = 0, dtype: str = "bf16") -> list[dict]:
    dt, plan_fn, launch, tiles = KERNELS[dtype]
    dev = resolve_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    flush = torch.empty(64 * 1024 * 1024 // 4, device=dev)
    geom = W.WgradGeometry(hk=3, wk=3, padding=(1, 1))
    rows = []
    for name, ci, co, h, wd in vgg_layer_dims():
        if ci % 8 or (layers and name not in layers):
            continue
        x = torch.randn((batch, h, wd, ci), generator=gen).to(dev, dt)
        dy = torch.randn((batch, h, wd, co), generator=gen).to(dev, dt)
        plain = wgrad_ref(x, dy, 3, 3, padding=1)
        scale = plain.abs().max().item()
        picked = plan_fn(batch, h, wd, ci, co, 3, 3, (1, 1))
        cl = torch.channels_last
        x_nchw = x.permute(0, 3, 1, 2).contiguous(memory_format=cl)
        dy_nchw = dy.permute(0, 3, 1, 2).contiguous(memory_format=cl)
        library_ms = _time_ms(lambda: torch.nn.grad.conv2d_weight(
            x_nchw, (co, ci, 3, 3), dy_nchw, padding=1), flush)
        best = None
        for tile in tiles:
            plan = plan_fn(batch, h, wd, ci, co, 3, 3, (1, 1), only=tile)
            if plan is None:
                continue
            dw = launch(x, dy, geom, plan)
            rel = (dw - plain).abs().max().item() / scale
            ms = _time_ms(lambda: launch(x, dy, geom, plan), flush)
            row = {"layer": name, "dtype": dtype, "tile": list(plan.tile),
                   "stages": plan.stages, "ctas": plan.ctas,
                   "bps": plan.bps, "ms": ms,
                   "max_abs_err_over_max_ref": rel,
                   "within_tol": rel <= WGRAD_TOL, "picked": plan == picked}
            print(json.dumps(row), flush=True)
            rows.append(row)
            if best is None or ms < best["ms"]:
                best = row
        summary = {"layer": name, "dtype": dtype,
                   "picked": list(picked.tile),
                   "picked_ms": next(r["ms"] for r in rows
                                     if r["layer"] == name and r["picked"]),
                   "fastest": best["tile"], "fastest_ms": best["ms"],
                   "library_ms": library_ms,
                   "card": torch.cuda.get_device_name(0)}
        print(json.dumps(summary), flush=True)
    return rows


def ranges(batch: int = 8, seed: int = 0, dtype: str = "bf16"
           ) -> list[dict]:
    dt, plan_fn, launch, _ = KERNELS[dtype]
    dev = resolve_device("cuda")
    gen = torch.Generator().manual_seed(seed)
    name, ci, co, h, wd = vgg_layer_dims()[1]
    x = torch.randn((batch, h, wd, ci), generator=gen).to(dev, dt)
    dy = torch.randn((batch, h, wd, co), generator=gen).to(dev, dt)
    geom = W.WgradGeometry(hk=3, wk=3, padding=(1, 1))
    plain = wgrad_ref(x, dy, 3, 3, padding=1)
    scale = plain.abs().max().item()
    plan = plan_fn(batch, h, wd, ci, co, 3, 3, (1, 1))
    rows = []
    for splits in sorted({1, 4, 16, 64, plan.splits}):
        bps = -(-plan.nblk // splits)
        p = dataclasses.replace(plan, splits=-(-plan.nblk // bps), bps=bps)
        dw = launch(x, dy, geom, p)
        rel = (dw - plain).abs().max().item() / scale
        row = {"layer": name, "dtype": dtype, "tile": list(p.tile),
               "bps": bps,
               "pixels_per_range": bps * W.SM90_BLOCK ** 2,
               "planned": p == plan, "max_abs_err_over_max_ref": rel,
               "within_tol": rel <= WGRAD_TOL,
               "card": torch.cuda.get_device_name(0)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", nargs="*", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ranges", action="store_true")
    ap.add_argument("--dtype", choices=sorted(KERNELS), default="bf16")
    args = ap.parse_args(argv)
    if args.ranges:
        ranges(args.batch, dtype=args.dtype)
    else:
        sweep(args.layers, args.batch, dtype=args.dtype)


if __name__ == "__main__":
    main()
