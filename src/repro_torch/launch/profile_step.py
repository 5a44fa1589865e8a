"""Where a training step's device time goes: ``torch.profiler`` over a
few SGD steps of :mod:`repro_torch.launch.train_vgg` on the card,
device time summed by kernel (the conv kernels of K1, the wgrad kernels
of K2, their second passes and the im2col staging kernel both use, and
PyTorch's own kernels by name), beside the
host clock around the same number of synchronized steps run without
the profiler (the device's idle share is taken against those).

  PYTHONPATH=src python -m repro_torch.launch.profile_step --model vgg

(VGG16/224 or ResNet-20/32 at full width, batch 8, three steps after
one warm-up step.)

Prints one JSON line.  Needs a CUDA device: a measurement of the card
has no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.exec_target import resolve_device
from repro_torch.launch import train_vgg as T

#: kernel names of the port's own kernels (no name is a part of another)
OWN = {"conv_lb_kernel": "K1 conv_lb",
       "conv_lb_sm90_kernel": "K1 conv_lb_sm90",
       "conv_lb_sm90_tf32_kernel": "K1 conv_lb_sm90_tf32",
       "wgrad_lb_kernel": "K2 wgrad_lb",
       "wgrad_lb_sm90_kernel": "K2 wgrad_lb_sm90",
       "wgrad_lb_sm90_tf32_kernel": "K2 wgrad_lb_sm90_tf32",
       "wgrad_im2col_kernel": "K1/K2 im2col staging",
       "wgrad_reduce_kernel": "K2 second pass",
       "wgrad_sm90_reduce_kernel": "K2 second pass",
       "wgrad_tf32_reduce_kernel": "K2 second pass"}


def _group(name: str) -> str:
    for prefix, label in OWN.items():
        if prefix in name:
            return label
    return name


def _busy_us(spans: list[tuple[float, float]]) -> float:
    """Length of the union of device intervals."""
    busy, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    return busy


def profile_steps(model: str, *, image: int, batch: int, width_mult: float,
                  steps: int, warmup: int, lr: float, seed: int = 0,
                  top: int = 12) -> dict:
    dev = resolve_device("cuda")
    gen = torch.Generator().manual_seed(seed)
    graph, params = T.build_model(model, width_mult=width_mult,
                                  n_classes=10, generator=gen, device=dev)
    images, labels = T.make_batch(batch, image, 10, gen, dev)

    def run() -> float:
        t0 = time.perf_counter()
        for _ in range(steps):
            T.sgd_step(graph, params, images, labels, lr)
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e6

    for _ in range(warmup):
        T.sgd_step(graph, params, images, labels, lr)
    torch.cuda.synchronize(dev)
    wall_us = run()               # the profiler slows the host side
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_us = run()
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    spans = []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t_0, t_1 = evt.time_range.start, evt.time_range.end
        spans.append((t_0, t_1))
        row = by_name[_group(evt.name)]
        row[0] += t_1 - t_0
        row[1] += 1
    busy = _busy_us(spans)
    kernels = sorted(({"kernel": k, "ms_per_step": v[0] / steps / 1e3,
                       "launches_per_step": v[1] / steps}
                      for k, v in by_name.items()),
                     key=lambda r: -r["ms_per_step"])
    own = [r for r in kernels if r["kernel"] in OWN.values()]
    rest = [r for r in kernels if r["kernel"] not in OWN.values()]
    return {"model": model, "image": image, "batch": batch,
            "width_mult": width_mult, "steps": steps,
            "wall_ms_per_step": wall_us / steps / 1e3,
            "wall_ms_per_step_profiled": profiled_us / steps / 1e3,
            "device_busy_ms_per_step": busy / steps / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us),
            "own_kernels": own,
            "other_kernels_ms_per_step": sum(r["ms_per_step"]
                                             for r in rest),
            "other_kernels_top": rest[:top],
            "device": torch.cuda.get_device_name(dev)}


#: per model: image edge and the SGD rate the chip smoke trains with
MODELS = {"vgg": (224, 1e-4), "resnet": (32, 1e-3)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=tuple(MODELS), default="vgg")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    image, lr = MODELS[args.model]
    print(json.dumps(profile_steps(args.model, image=image, batch=8,
                                   width_mult=1.0, steps=3, warmup=1,
                                   lr=lr)), flush=True)


if __name__ == "__main__":
    main()
