"""K1's 3xTF32 kernel (route ``sm90_tf32``) against the length of the
range its tensor cores sum, on the card: VGG16/224's conv5_3 (K = 3 * 3
* 512 = 4608, the deepest), conv3_2 (2304) and conv1_2 (576) at batch 8,
f32, pad 1, no epilogue (the pre-epilogue sums the backward's recompute
also gives), He-scaled weights.  The promotion interval (K steps of 32
the tensor cores sum before the kernel adds their sums into its
CUDA-core f32 sums; 0: never) is the kernel's compile-time ``kPromote``:
each interval is a copy of ``csrc/conv_lb_sm90_tf32.cu`` with that
value, under ``build/conv_tf32_promote/``, all built together (the
idiom of :mod:`repro_torch.launch.tf32_promote`).  Each is launched on
the wrapper's plan, held to the plain version (max |err| over max
|plain|, ``chip_smoke.py``'s ``TOL`` is 1e-4) and to float64, and timed
as ``chip_smoke.py`` times a layer
(:func:`~repro_torch.launch.yardstick.time_ms`); beside them the FMA
kernel (route ``fma``, another f32 order of the sums).

  PYTHONPATH=src python -m repro_torch.launch.conv_tf32_promote [--promote 0,1,2,4]

Prints one JSON line per (layer, interval).  The wrapper's
``TF32_PROMOTE`` is the interval kept.  Needs a CUDA device: a
measurement of the card has no CPU fallback.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from repro_torch.core.exec_target import resolve_device
from repro_torch.kernels.conv_lb import kernel as K
from repro_torch.kernels.conv_lb.ref import conv2d_ref
from repro_torch.kernels.nvcc import BUILD_DIR, build_many
from repro_torch.launch.tf32_promote import PROMOTE
from repro_torch.launch.yardstick import time_ms

#: VGG16/224 layers at batch 8: name, plane, Ci, Co
LAYERS = [("conv5_3", 14, 512, 512), ("conv3_2", 56, 256, 256),
          ("conv1_2", 224, 64, 64)]


def variants(promotes: list[int]) -> dict[int, object]:
    """Per interval, the bound C entry of a copy of the kernel's source
    whose ``kPromote`` is that interval, built together."""
    src = K.TF32_SOURCE.read_text()
    if len(PROMOTE.findall(src)) != 1:
        raise ValueError(f"{K.TF32_SOURCE} must define kPromote once")
    paths = []
    for r in promotes:
        path = (BUILD_DIR / "conv_tf32_promote" / f"promote{r}"
                / K.TF32_SOURCE.name)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(PROMOTE.sub(f"constexpr int kPromote = {r};", src))
        paths.append(path)
    libs = build_many(paths)
    return {r: (lib, lib.bind_struct("conv_lb_sm90_tf32_launch",
                                     K.Tf32ConvArgs))
            for r, lib in zip(promotes, libs)}


def launch(entry, x: torch.Tensor, w: torch.Tensor,
           plan: K.Sm90Tf32Plan) -> torch.Tensor:
    """One launch of a variant, as ``K._sm90_tf32`` launches the kernel
    (a 3x3, pad-1 conv, no bias, residual, ReLU or pool, lo words kept)
    on ``plan``."""
    lib, forward = entry
    b, h, wd, ci = x.shape
    co = w.shape[-1]
    out = torch.empty((b, h, wd, co), dtype=x.dtype, device=x.device)
    args = K.tf32_args(x.shape, w.shape, plan, (h, wd), (1, 1), False, 1)
    args.x, args.w, args.out = x.data_ptr(), w.data_ptr(), out.data_ptr()
    args.stream = torch.cuda.current_stream().cuda_stream
    err = forward(args)
    if err != 0:
        raise RuntimeError(f"conv_lb_sm90_tf32 variant: "
                           f"{lib.error_string(err)} (error {err})")
    return out


def _errors(out: torch.Tensor, plain: torch.Tensor,
            exact: torch.Tensor) -> dict:
    scale = exact.abs().max().item()
    return {"err_over_max_plain": (out - plain).abs().max().item()
            / plain.abs().max().item(),
            "err_over_max_exact": (out.double() - exact).abs().max().item()
            / scale}


def sweep(promotes: list[int], batch: int = 8, seed: int = 6) -> list[dict]:
    resolve_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    entries = variants(promotes)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    card = torch.cuda.get_device_name(0)
    rows = []
    for name, h, ci, co in LAYERS:
        x = torch.randn((batch, h, h, ci), generator=gen, device="cuda")
        w = torch.randn((3, 3, ci, co), generator=gen,
                        device="cuda") * (9 * ci) ** -0.5
        rt, plan = K.plan_of(x, w, padding=(1, 1))
        if rt != "sm90_tf32":
            raise ValueError(f"{name}: route {rt}, not sm90_tf32")
        plain = conv2d_ref(x, w, padding=(1, 1))
        exact = F.conv2d(x.double().permute(0, 3, 1, 2),
                         w.double().permute(3, 2, 0, 1),
                         padding=1).permute(0, 2, 3, 1)
        base = {"layer": name, "batch": batch, "in": [h, h, ci], "co": co,
                "k_steps": 9 * -(-ci // K.TF32_BK), "tile": list(plan.tile),
                "card": card, "plain_err_over_max_exact":
                (plain.double() - exact).abs().max().item()
                / exact.abs().max().item()}
        for r in promotes:
            out = launch(entries[r], x, w, plan)
            row = dict(base, promote=r, picked=r == K.TF32_PROMOTE,
                       **_errors(out, plain, exact),
                       ms=time_ms(lambda: launch(entries[r], x, w, plan),
                                  flush))
            print(json.dumps(row), flush=True)
            rows.append(row)
        fplan = K.cta_plan(batch, h, h, co, 1, 3, 3, (1, 1), (1, 1), 4)
        one = (1, 1)
        fma = K._fma(x, w, None, None, h, h, one, one, one, one, False, 1,
                     fplan)
        row = dict(base, control="fma", **_errors(fma, plain, exact))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del exact, plain
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--promote", default="0,1,2,4,8,16,144")
    args = ap.parse_args(argv)
    sweep([int(v) for v in args.promote.split(",")])


if __name__ == "__main__":
    main()
