"""Where a short conv call's time goes, on the card: ResNet-20/32's four
strided convs at batch 8 in f32 (the two 3x3/2 convs and the two 1x1/2
projections), their forward (``conv_lb``), dgrad (``dgrad_lb``) and
wgrad (``wgrad_lb``), each

  * on the route it takes, with the kernels one call puts on the card
    (``torch.profiler``: every device kernel the call launches, copies
    and pads included);
  * timed three ways: ``ms``, CUDA events around one call with the L2
    cache flushed before it (a call shorter than its host enqueue is
    charged the enqueue); ``device_ms``, one of 100 back-to-back calls
    enqueued while the stream spins (the kernels' own time, L2 warm);
    ``host_us``, the host's time to enqueue one call;
  * beside cuDNN's call for the same function (TF32 off) timed the same
    three ways, and the 3xTF32 and FMA bounds;

and, for the forward and the wgrad of the first strided conv (s2b0_proj,
a 1x1/2), the host's time per part of one call
(``time.perf_counter_ns`` over 200 calls of each part alone), each part
read through the wrapper's launch cache: the lookup (route, plan and
operand checks, read once per key), the device check and the stream,
the output's allocation, the foreign call (tensor maps from the entry's
cache, the launch), the rest of the wrapper, and ``conv2d_lb``'s
autograd and planner above it.

  PYTHONPATH=src python -m repro_torch.launch.enqueue

Prints one JSON line per row, then the card's name and power limit.
Needs a CUDA device: a measurement of the card has no CPU fallback.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch
import torch.nn.functional as F

from repro_torch.core.exec_target import resolve_device
from repro_torch.core.hopper_adapter import (HBM_BYTES_PER_S,
                                             PEAK_F32_FLOPS,
                                             PEAK_TF32_FLOPS)
from repro_torch.kernels.conv_lb import kernel as K
from repro_torch.kernels.conv_lb import wgrad as W
from repro_torch.kernels.conv_lb.ops import (ConvArgs, conv2d_lb,
                                             dgrad_lb)
from repro_torch.kernels.lean import on_device
from repro_torch.launch.yardstick import device_ms, time_ms
from repro_torch.models.cnn import resnet_graph
from repro_torch.models.graph import graph_stages

BATCH = 8


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _kernels_per_call(fn) -> list[str]:
    """The device kernels one call of ``fn`` launches, by name."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _host_part_us(fn, reps: int = 200) -> float:
    """Mean host microseconds of one call of ``fn``, the stream held
    busy meanwhile where ``fn`` enqueues work."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    us = (time.perf_counter_ns() - t0) / reps / 1e3
    torch.cuda.synchronize()
    return us


def _timed(fn, flush) -> dict:
    return {"ms": time_ms(fn, flush), "device_ms": device_ms(fn),
            "host_us": _host_part_us(fn, reps=20)}


def _conv_parts(x, w, b, s: int, p: int) -> dict:
    """The host's time per part of one ``conv_lb`` call (the forward with
    bias, no ReLU), and of ``conv2d_lb`` above it with w needing a
    gradient."""
    kw = dict(stride=(s, s), padding=(p, p))
    parts = {}
    _lean_parts(parts, lambda: K.lookup(x, w, b, None, **kw), x,
                lambda e, out, st: e.launch.fire(x, w, b, None, out, st))
    parts["conv_lb"] = _host_part_us(lambda: K.conv_lb(x, w, b, **kw))
    parts["rest_of_wrapper"] = parts["conv_lb"] - sum(
        v for k, v in parts.items() if k != "conv_lb")
    wg = w.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        parts["conv2d_lb"] = _host_part_us(
            lambda: conv2d_lb(x, wg, b, stride=s, padding=p))
    parts["autograd_and_planner"] = parts["conv2d_lb"] - parts["conv_lb"]
    return parts


def _lean_parts(parts: dict, lookup, x, fire) -> None:
    """The parts of a call through a launch cache: the key and its
    lookup (route, plan and checks read once per key), the device check
    and the stream, the output's allocation, and the foreign call (the
    pointers and the stream filled in, tensor maps from the entry's
    cache, the launch)."""
    _, entry, _ = lookup()
    parts["route_and_plan"] = _host_part_us(lookup)
    parts["operand_checks"] = 0.0     # in the key: read on a miss only
    parts["device_guard_and_stream"] = _host_part_us(
        lambda: on_device(x.device, lambda stream: stream))
    shape = getattr(entry.launch, "out_shape", None) or entry.launch.dw_shape
    parts["alloc"] = _host_part_us(
        lambda: torch.empty(shape, device=x.device))
    out = torch.empty(shape, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    parts["foreign_call"] = _host_part_us(lambda: fire(entry, out, stream))


def _wgrad_parts(x, gy, geom) -> dict:
    """The host's time per part of one ``wgrad_lb`` call."""
    parts = {}
    splits = W.lookup(x, gy, geom)[1].splits
    ws = (torch.empty((splits, geom.hk * geom.wk * x.shape[-1]
                       * gy.shape[-1]), device=x.device)
          if splits > 1 else None)
    _lean_parts(parts, lambda: W.lookup(x, gy, geom), x,
                lambda e, out, st: e.launch.fire(x, gy, out, ws, st))
    parts["wgrad_lb"] = _host_part_us(lambda: W.wgrad_lb(x, gy, geom))
    parts["rest_of_wrapper"] = parts["wgrad_lb"] - sum(
        v for k, v in parts.items() if k != "wgrad_lb")
    return parts


def _nchw(t):
    return t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def run(seed: int = 8) -> list[dict]:
    dev = resolve_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    flush = torch.empty(64 * 1024 * 1024 // 4, device=dev)
    card = _card()
    rows = []
    first = True
    for st in graph_stages(resnet_graph(), 32, 32):
        n = st.node
        if n.stride == 1:
            continue
        ci, co, k, s, p = n.ci, n.co, n.hk, n.stride, n.pad
        x = torch.randn((BATCH, st.h, st.w, ci), generator=gen).to(dev)
        w = (torch.randn((k, k, ci, co), generator=gen)
             / (k * k * ci) ** 0.5).to(dev)
        b = (0.1 * torch.randn((co,), generator=gen)).to(dev)
        gy = torch.randn((BATCH, st.ho, st.wo, co), generator=gen).to(dev)
        a = ConvArgs(stride=(s, s), padding=(p, p), dilation=(1, 1),
                     lhs_dilation=(1, 1), groups=1, relu=False, pool=1)
        geom = W.WgradGeometry(hk=k, wk=k, stride=(s, s), padding=(p, p))
        x_c, w_c, gy_c = _nchw(x), w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last), _nchw(gy)
        flops = 2.0 * BATCH * st.ho * st.wo * ci * co * k * k
        calls = {
            "forward": (lambda: K.conv_lb(x, w, b, stride=(s, s),
                                          padding=(p, p)),
                        lambda: F.conv2d(x_c, w_c, b, stride=s, padding=p),
                        K.route(x, w, (s, s), bias=b, padding=(p, p)),
                        x.numel() + w.numel() + b.numel() + gy.numel()),
            "dgrad": (lambda: dgrad_lb(gy, w, a, st.h, st.w),
                      lambda: torch.nn.grad.conv2d_input(
                          x_c.shape, w_c, gy_c, stride=s, padding=p),
                      K.dgrad_route(gy, w, (s, s), st.h, st.w, (p, p)),
                      gy.numel() + w.numel() + x.numel()),
            "wgrad": (lambda: W.wgrad_lb(x, gy, geom),
                      lambda: torch.nn.grad.conv2d_weight(
                          x_c, (co, ci, k, k), gy_c, stride=s, padding=p),
                      W.route(x, gy, geom),
                      x.numel() + gy.numel() + w.numel())}
        for op, (kernel, library, rt, words) in calls.items():
            t_ops = 3 * flops / PEAK_TF32_FLOPS
            t_fma = flops / PEAK_F32_FLOPS
            t_bytes = 4.0 * words / HBM_BYTES_PER_S
            row = {"probe": "enqueue", "layer": n.name, "op": op,
                   "in": [st.h, st.w, ci], "co": co, "k": k, "stride": s,
                   "batch": BATCH, "route": rt,
                   "kernels_per_call": _kernels_per_call(kernel),
                   **_timed(kernel, flush),
                   "library": _timed(library, flush),
                   "library_kernels_per_call": _kernels_per_call(library),
                   "bound_ms_3xtf32": max(t_ops, t_bytes) * 1e3,
                   "bound_ms_fma": max(t_fma, t_bytes) * 1e3,
                   "card": card}
            if first and op == "forward":
                row["host_parts_us"] = _conv_parts(x, w, b, s, p)
            if first and op == "wgrad":
                row["host_parts_us"] = _wgrad_parts(x, gy, geom)
            print(json.dumps(row), flush=True)
            rows.append(row)
        first = False
    sums = {op: {key: sum(r[key] for r in rows if r["op"] == op)
                 for key in ("ms", "device_ms", "host_us")}
            | {"library_" + key: sum(r["library"][key] for r in rows
                                     if r["op"] == op)
               for key in ("ms", "device_ms", "host_us")}
            for op in ("forward", "dgrad", "wgrad")}
    print(json.dumps({"probe": "enqueue_sums", **sums, "card": card}),
          flush=True)
    print(card, flush=True)
    return rows


def main() -> None:
    run()


if __name__ == "__main__":
    main()
