"""K2's sm90 kernel at every tile its plan ranks, on the card: for each
VGG16/224 layer that takes route ``sm90`` (conv1_2 ... conv5_3, bf16,
batch 8), each ``(bn, nwc, cib)`` that fits, launched on that tile with
the split :func:`~repro_torch.kernels.conv_lb.wgrad.sm90_wgrad_plan`
ranks best for it, held to the plain version (``WGRAD_TOL`` of max
|plain|) and timed as ``chip_smoke.py`` times a layer (CUDA events
around one call, L2 flushed, mean of 10), beside cuDNN's
``conv2d_weight`` in bf16 and the tile the plan picks.

  PYTHONPATH=src python -m repro_torch.launch.wgrad_tiles [--layers conv5_1]
  PYTHONPATH=src python -m repro_torch.launch.wgrad_tiles --ranges

Prints one JSON line per (layer, tile) and one per layer.  ``--ranges``
instead runs conv1_2 (the longest reduction, 6,272 pixel blocks) on the
plan's tile at split ranges of several lengths, past the plan's
``SM90_MAX_RANGE`` too, each with its error against the plain version:
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
from repro_torch.models.cnn import vgg_layer_dims

#: wgrad kernel vs plain version (as ``chip_smoke.WGRAD_TOL``)
WGRAD_TOL = 2e-4


def _time_ms(fn, flush: torch.Tensor, reps: int = 10) -> float:
    for _ in range(2):
        fn()
    start = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    end = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        flush.zero_()
        start[i].record()
        fn()
        end[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(start, end)) / reps


def sweep(layers: list[str] | None = None, batch: int = 8,
          seed: int = 0) -> list[dict]:
    dev = resolve_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    flush = torch.empty(64 * 1024 * 1024 // 4, device=dev)
    geom = W.WgradGeometry(hk=3, wk=3, padding=(1, 1))
    rows = []
    for name, ci, co, h, wd in vgg_layer_dims():
        if ci % 8 or (layers and name not in layers):
            continue
        x = torch.randn((batch, h, wd, ci), generator=gen).to(
            dev, torch.bfloat16)
        dy = torch.randn((batch, h, wd, co), generator=gen).to(
            dev, torch.bfloat16)
        plain = wgrad_ref(x, dy, 3, 3, padding=1)
        scale = plain.abs().max().item()
        picked = W.sm90_wgrad_plan(batch, h, wd, ci, co, 3, 3, (1, 1))
        cl = torch.channels_last
        x_nchw = x.permute(0, 3, 1, 2).contiguous(memory_format=cl)
        dy_nchw = dy.permute(0, 3, 1, 2).contiguous(memory_format=cl)
        library_ms = _time_ms(lambda: torch.nn.grad.conv2d_weight(
            x_nchw, (co, ci, 3, 3), dy_nchw, padding=1), flush)
        best = None
        for (bn, nwc) in W.SM90_TILES:
            for cib in W.SM90_CIBS:
                plan = W.sm90_wgrad_plan(batch, h, wd, ci, co, 3, 3, (1, 1),
                                         only=(bn, nwc, cib))
                if plan is None:
                    continue
                dw = W._sm90(x, dy, geom, plan)
                rel = (dw - plain).abs().max().item() / scale
                ms = _time_ms(lambda: W._sm90(x, dy, geom, plan), flush)
                row = {"layer": name, "tile": list(plan.tile),
                       "stages": plan.stages, "ctas": plan.ctas,
                       "bps": plan.bps, "ms": ms,
                       "max_abs_err_over_max_ref": rel,
                       "within_tol": rel <= WGRAD_TOL,
                       "picked": plan == picked}
                print(json.dumps(row), flush=True)
                rows.append(row)
                if best is None or ms < best["ms"]:
                    best = row
        summary = {"layer": name, "picked": list(picked.tile),
                   "picked_ms": next(r["ms"] for r in rows
                                     if r["layer"] == name and r["picked"]),
                   "fastest": best["tile"], "fastest_ms": best["ms"],
                   "library_ms": library_ms,
                   "card": torch.cuda.get_device_name(0)}
        print(json.dumps(summary), flush=True)
    return rows


def ranges(batch: int = 8, seed: int = 0) -> list[dict]:
    dev = resolve_device("cuda")
    gen = torch.Generator().manual_seed(seed)
    name, ci, co, h, wd = vgg_layer_dims()[1]
    x = torch.randn((batch, h, wd, ci), generator=gen).to(
        dev, torch.bfloat16)
    dy = torch.randn((batch, h, wd, co), generator=gen).to(
        dev, torch.bfloat16)
    geom = W.WgradGeometry(hk=3, wk=3, padding=(1, 1))
    plain = wgrad_ref(x, dy, 3, 3, padding=1)
    scale = plain.abs().max().item()
    plan = W.sm90_wgrad_plan(batch, h, wd, ci, co, 3, 3, (1, 1))
    rows = []
    for splits in sorted({1, 4, 16, 64, plan.splits}):
        bps = -(-plan.nblk // splits)
        p = dataclasses.replace(plan, splits=-(-plan.nblk // bps), bps=bps)
        dw = W._sm90(x, dy, geom, p)
        rel = (dw - plain).abs().max().item() / scale
        row = {"layer": name, "tile": list(p.tile), "bps": bps,
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
    args = ap.parse_args(argv)
    if args.ranges:
        ranges(args.batch)
    else:
        sweep(args.layers, args.batch)


if __name__ == "__main__":
    main()
