#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: builds the conv kernel from
the sources in this checkout, holds it against its plain PyTorch
version on the card, serves VGG16/224 (full width) and ResNet-20/32
through ``repro_torch.serve.ImageServer`` with every conv on the
kernel, and times the kernel per VGG layer.

    python3 chip_smoke.py        # on a host with one NVIDIA H100

Every phase prints one JSON line; any failed phase raises and the
script exits non-zero.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core.hopper_adapter import (HBM_BYTES_PER_S,  # noqa: E402
                                             PEAK_F32_FLOPS)
from repro_torch.kernels.conv_lb import kernel as K  # noqa: E402
from repro_torch.kernels.conv_lb.ops import conv2d_lb  # noqa: E402
from repro_torch.kernels.conv_lb.ref import conv2d_ref  # noqa: E402
from repro_torch.models.cnn import (init_resnet, init_vgg,  # noqa: E402
                                    resnet_graph, vgg_graph)
from repro_torch.models.graph import graph_logits, graph_stages  # noqa: E402
from repro_torch.obs.tracer import Tracer  # noqa: E402
from repro_torch.serve import ImageServer  # noqa: E402

#: kernel vs plain version: sums run in another order over K <= 4608
TOL = 1e-4
SEED = 0
SOURCE = "src/repro_torch/kernels/conv_lb/csrc/conv_lb.cu"
REPLACES = "src/repro/kernels/conv_lb/kernel.py:116"


class SmokeFailure(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs err, max abs err / max |ref|)."""
    err = (out - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def phase_device() -> str:
    card = card_line()
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return card


def phase_build() -> None:
    lib = K.build()
    emit({"phase": "build", "seconds": lib.seconds, "library": lib.path.name,
          "source": SOURCE,
          "ptxas": [ln.strip() for ln in lib.log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]})


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).cuda()


# name, batch, (h, w), ci, co, k, stride, pad, dilation, lhs_dilation,
# groups, bias, residual, relu, pool
CHECKS = [
    ("vgg_3x3_s1_p1_bias_relu_pool2_b8", 8, (28, 28), 64, 128, 3, 1, 1,
     1, 1, 1, True, False, True, 2),
    ("vgg_conv1_1_ci3_b1", 1, (224, 224), 3, 64, 3, 1, 1, 1, 1, 1, True,
     False, True, 1),
    ("stride2_b8", 8, (32, 32), 16, 32, 3, 2, 1, 1, 1, 1, True, False,
     True, 1),
    ("proj_1x1_s2_b8", 8, (32, 32), 16, 32, 1, 2, 0, 1, 1, 1, True, False,
     False, 1),
    ("rhs_dilation2", 2, (20, 20), 16, 16, 3, 1, 2, 2, 1, 1, True, False,
     True, 1),
    ("lhs_dilation2_dgrad", 2, (9, 9), 8, 8, 3, 1, 2, 1, 2, 1, False,
     False, False, 1),
    ("residual_relu_b8", 8, (16, 16), 32, 32, 3, 1, 1, 1, 1, 1, True,
     True, True, 1),
    ("residual_relu_pool2_b1", 1, (16, 16), 24, 40, 3, 1, 1, 1, 1, 1,
     True, True, True, 2),
    ("odd_plane_odd_channels_b3", 3, (15, 13), 7, 9, 3, 1, 1, 1, 1, 1,
     True, False, True, 1),
    ("groups2", 2, (16, 16), 8, 12, 3, 1, 1, 1, 1, 2, True, False, True,
     1),
    ("vgg_conv5_3_pool2_b8", 8, (14, 14), 512, 512, 3, 1, 1, 1, 1, 1,
     True, False, True, 2),
]


def phase_check() -> None:
    gen = torch.Generator().manual_seed(SEED)
    for (name, b, (h, w), ci, co, k, s, p, d, ld, g, has_bias,
         has_res, relu, pool) in CHECKS:
        x = _randn(gen, b, h, w, ci)
        wt = _randn(gen, k, k, ci // g, co, scale=(k * k * ci / g) ** -0.5)
        bias = _randn(gen, co) if has_bias else None
        hd, wd = (h - 1) * ld + 1, (w - 1) * ld + 1
        ho = (hd + 2 * p - ((k - 1) * d + 1)) // s + 1
        wo = (wd + 2 * p - ((k - 1) * d + 1)) // s + 1
        res = _randn(gen, b, ho, wo, co) if has_res else None
        kw = dict(stride=s, padding=p, dilation=d, lhs_dilation=ld,
                  groups=g, relu=relu, pool=pool)
        out = conv2d_lb(x, wt, bias, res, **kw)
        ref = conv2d_ref(x, wt, bias, res, **kw)
        torch.cuda.synchronize()
        require(out.shape == ref.shape,
                f"check {name}: shape {tuple(out.shape)} != "
                f"{tuple(ref.shape)}")
        err, rel = rel_err(out, ref)
        emit({"phase": "check", "geometry": name,
              "shape": list(out.shape), "max_abs_err": err,
              "max_abs_err_over_max_ref": rel, "tol": TOL})
        require(rel <= TOL, f"check {name}: kernel vs plain {rel} > {TOL}")


def phase_serve(model: str) -> int:
    """Serve 16 requests of 1-8 images; returns the kernel launches."""
    gen = torch.Generator().manual_seed(SEED)
    if model == "vgg":
        params = init_vgg(gen, device="cuda")
        graph, size = vgg_graph(params), 224
    else:
        graph = resnet_graph()
        params = init_resnet(gen, graph, device="cuda")
        size = 32
    n_convs = len(graph_stages(graph, size, size))
    sizes = np.random.default_rng(SEED).integers(1, 9, size=16)
    images = [torch.randn((int(n), size, size, 3), generator=gen)
              for n in sizes]
    tracer = Tracer()
    srv = ImageServer(params, size, size, graph=graph, device="cuda",
                      tracer=tracer)
    srv.warm()
    K.conv_lb.launches = 0
    results = []
    for im in images:
        srv.submit(im)
        results += srv.poll()
    results += srv.drain()
    launches = K.conv_lb.launches
    rids = sorted(r.rid for r in results)
    require(rids == list(range(len(images))),
            f"{model}: rids answered {rids}")
    dispatches = srv.stats["dispatches"]
    require(launches == n_convs * dispatches,
            f"{model}: {launches} kernel launches for {dispatches} "
            f"dispatches of {n_convs} convs")
    got = torch.cat([r.logits for r in sorted(results,
                                              key=lambda r: r.rid)])
    with torch.no_grad():
        plain = graph_logits(graph, params, torch.cat(images).cuda(),
                             conv=conv2d_ref)
    torch.cuda.synchronize()
    err, rel = rel_err(got, plain)
    finite = bool(torch.isfinite(got).all().item())
    dispatch_ms = [s.attrs["us"] / 1e3
                   for s in tracer.find("serve.execute")]
    summary = srv.ledger.summary()
    emit({"phase": model, "requests": len(images),
          "images": int(sum(sizes)), "dispatches": dispatches,
          "convs_per_dispatch": n_convs, "kernel_launches": launches,
          "every_rid_answered_once": True,
          "logits_shape": list(got.shape), "logits_finite": finite,
          "max_abs_err_vs_plain": err, "max_rel_err_vs_plain": rel,
          "dispatch_ms": dispatch_ms, "stats": srv.stats,
          "ledger": {k: summary[k] for k in (
              "bytes_per_image", "vs_bound_x", "w_amortization_x",
              "vs_serving_x", "dispatches", "padded_images")}})
    print(srv.ledger.format_summary(), flush=True)
    require(finite, f"{model}: non-finite logits")
    require(rel <= TOL, f"{model}: logits vs plain {rel} > {TOL}")
    return launches


def _time_ms(fn, flush: torch.Tensor, reps: int = 10) -> float:
    """Mean device ms of ``fn`` with the L2 cache flushed before each
    call (a serving layer finds its weights cold)."""
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


def phase_layers(card: str) -> list[dict]:
    batch = 8
    gen = torch.Generator().manual_seed(SEED)
    params = init_vgg(gen, device="cuda")
    graph = vgg_graph(params)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    rows = []
    for st, p in zip(graph_stages(graph, 224, 224), params["convs"]):
        node = st.node
        x = _randn(gen, batch, st.h, st.w, node.ci)
        w, b = p["w"], _randn(gen, node.co, scale=0.1)
        pool = st.pool if st.fused_pool else 1
        kw = dict(stride=node.stride, padding=node.pad, relu=node.relu,
                  pool=pool)
        x_nchw = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        out = conv2d_lb(x, w, b, **kw)
        ref = conv2d_ref(x, w, b, **kw)
        err, rel = rel_err(out, ref)
        require(rel <= TOL, f"layer {node.name}: kernel vs plain {rel}")
        ms = _time_ms(lambda: conv2d_lb(x, w, b, **kw), flush)
        plain_ms = _time_ms(lambda: conv2d_ref(x, w, b, **kw), flush)
        library_ms = _time_ms(lambda: F.conv2d(
            x_nchw, w_oihw, b, stride=node.stride, padding=node.pad),
            flush)
        flops = 2.0 * batch * st.ho * st.wo * node.co * node.ci * 9
        n_bytes = 4.0 * (x.numel() + w.numel() + b.numel() + out.numel())
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, n_bytes / HBM_BYTES_PER_S
        row = {"phase": "layers", "model": "vgg16", "layer": node.name,
               "batch": batch, "in": [st.h, st.w, node.ci],
               "co": node.co, "pool": pool, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "flops": flops, "bytes": n_bytes,
               "launches_per_dispatch": 1, "max_abs_err": err,
               "max_abs_err_over_max_ref": rel,
               "tile": list(K.cta_tile(batch, st.ho, st.wo, node.co,
                                       pool)),
               "card": card}
        emit(row)
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    phase_check()
    vgg_launches = phase_serve("vgg")
    resnet_launches = phase_serve("resnet")
    rows = phase_layers(card)
    ops_ms = sum(r["bound_ms"] for r in rows
                 if r["bound_by"] == "operations")
    kernels = [{
        "name": "conv_lb", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": vgg_launches,
        "launches_resnet": resnet_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": ("operations"
                     if 2 * ops_ms >= sum(r["bound_ms"] for r in rows)
                     else "bytes"),
        "library_ms": sum(r["library_ms"] for r in rows),
        "times_are": "sums over the 13 VGG16/224 convs at batch 8",
        "card": card}]
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
