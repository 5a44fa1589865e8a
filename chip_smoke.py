#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: builds the conv kernel (K1)
and the wgrad kernel (K2) from the sources in this checkout, holds
each against its plain PyTorch version on the card (K1 also in its
dgrad geometries), serves VGG16/224 (full width) and ResNet-20/32
through ``repro_torch.serve.ImageServer`` with every conv on K1,
trains both for a few SGD steps with the backward on K1 (recompute,
dgrad) and K2 (wgrad), and times each kernel per VGG layer.

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
from repro_torch.kernels.conv_lb import wgrad as W  # noqa: E402
from repro_torch.kernels.conv_lb.ops import (ConvArgs,  # noqa: E402
                                             conv2d_lb, dgrad_lb,
                                             relu_slope)
from repro_torch.kernels.conv_lb.ref import (conv2d_ref, flip_w,  # noqa: E402
                                             wgrad_ref)
from repro_torch.launch import train_vgg as T  # noqa: E402
from repro_torch.models.cnn import (init_resnet, init_vgg,  # noqa: E402
                                    resnet_graph, vgg_graph)
from repro_torch.models.graph import (graph_logits, graph_stages,  # noqa: E402
                                      graph_training_step_report)
from repro_torch.obs.tracer import Tracer  # noqa: E402
from repro_torch.serve import ImageServer  # noqa: E402

#: kernel vs plain version: sums run in another order over K <= 4608
TOL = 1e-4
#: wgrad kernel vs plain version: sums over up to 401,408 pixels in
#: another order (split ranges, then the splits)
WGRAD_TOL = 2e-4
#: training-step gradients vs plain autograd on the same ReLU masks and
#: pool maxima (``Decisions``): 13-21 layers of f32 sums in another
#: order, relative to each tensor's max |plain grad|
GRAD_TOL = 1e-3
TRAIN_STEPS = 3
#: SGD rates under which the loss falls over the steps from He init
#: (no normalization layers)
TRAIN_LR = {"vgg": 1e-4, "resnet": 1e-3}
SEED = 0
SOURCE = "src/repro_torch/kernels/conv_lb/csrc/conv_lb.cu"
REPLACES = "src/repro/kernels/conv_lb/kernel.py:116"
WGRAD_SOURCE = "src/repro_torch/kernels/conv_lb/csrc/wgrad_lb.cu"
WGRAD_REPLACES = "src/repro/kernels/conv_lb/wgrad.py:50"


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
    """Both kernels, one nvcc each, started together."""
    t0 = time.perf_counter()
    libs = K.build_many([K.SOURCE, W.SOURCE])
    for lib, source in zip(libs, (SOURCE, WGRAD_SOURCE)):
        emit({"phase": "build", "seconds": lib.seconds,
              "library": lib.path.name, "source": source,
              "ptxas": [ln.strip() for ln in lib.log.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Compiling entry" in ln]})
    emit({"phase": "build", "wall_seconds": time.perf_counter() - t0})


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


# name, batch, (h, w), ci, co, k, stride, pad: the forward conv whose
# backward is checked
BWD_CHECKS = [
    ("vgg_3x3_s1_p1_conv4_b8", 8, (28, 28), 256, 512, 3, 1, 1),
    ("stride2_3x3_p1_b8", 8, (32, 32), 16, 32, 3, 2, 1),
    ("proj_1x1_s2_p0_b8", 8, (32, 32), 16, 32, 1, 2, 0),
    ("odd_plane_odd_channels_b3", 3, (15, 13), 7, 9, 3, 1, 1),
    ("odd_plane_s2_ci3_b2", 2, (15, 13), 3, 16, 3, 2, 1),
]
# wgrad only: the VGG layers with the longest and shortest reductions
WGRAD_ONLY = [
    ("vgg_conv1_1_b8", 8, (224, 224), 3, 64, 3, 1, 1),
    ("vgg_conv1_2_b8", 8, (224, 224), 64, 64, 3, 1, 1),
    ("vgg_conv5_3_b8", 8, (14, 14), 512, 512, 3, 1, 1),
]


def phase_check_bwd() -> float:
    """K1 in the dgrad geometry and K2 against their plain versions;
    the cropped dx also against the plain forward's autograd.  Returns
    K2's max abs error."""
    gen = torch.Generator().manual_seed(SEED + 1)
    worst = 0.0
    for (name, b, (h, w), ci, co, k, s, p) in BWD_CHECKS + WGRAD_ONLY:
        x = _randn(gen, b, h, w, ci)
        wt = _randn(gen, k, k, ci, co, scale=(k * k * ci) ** -0.5)
        ho = (h + 2 * p - k) // s + 1
        wo = (w + 2 * p - k) // s + 1
        gy = _randn(gen, b, ho, wo, co)
        row = {"phase": "check_bwd", "geometry": name}
        if (name, b, (h, w), ci, co, k, s, p) in BWD_CHECKS:
            # the dgrad conv itself: compact gy plane (+ one zero
            # row/col when strided), flipped weights, full padding
            gyp = F.pad(gy, (0, 0, 0, int(s > 1), 0, int(s > 1)))
            kw = dict(stride=1, padding=k - 1 - p, lhs_dilation=s)
            wf = flip_w(wt)
            out = conv2d_lb(gyp, wf, **kw)
            ref = conv2d_ref(gyp, wf, **kw)
            torch.cuda.synchronize()
            require(out.shape == ref.shape, f"check_bwd {name}: dgrad "
                    f"shape {tuple(out.shape)} != {tuple(ref.shape)}")
            err, rel = rel_err(out, ref)
            require(rel <= TOL, f"check_bwd {name}: dgrad kernel vs "
                                f"plain {rel} > {TOL}")
            # the cropped dx against the plain forward's autograd
            args = ConvArgs(stride=(s, s), padding=(p, p),
                            dilation=(1, 1), lhs_dilation=(1, 1),
                            groups=1, relu=False, pool=1)
            gx = dgrad_lb(gy, wt, args, h, w)
            xg = x.clone().requires_grad_(True)
            (want,) = torch.autograd.grad(
                conv2d_ref(xg, wt, stride=s, padding=p), xg, gy)
            gerr, grel = rel_err(gx, want)
            require(gx.shape == want.shape and grel <= TOL,
                    f"check_bwd {name}: dx vs plain autograd {grel}")
            row.update(dgrad_shape=list(out.shape), dgrad_max_abs_err=err,
                       dgrad_max_abs_err_over_max_ref=rel,
                       dx_vs_autograd_over_max_ref=grel, dgrad_tol=TOL)
        dw = W.wgrad_lb(x, gy, W.WgradGeometry(hk=k, wk=k, stride=(s, s),
                                               padding=(p, p)))
        dw_ref = wgrad_ref(x, gy, k, k, stride=s, padding=p)
        torch.cuda.synchronize()
        require(dw.shape == dw_ref.shape, f"check_bwd {name}: wgrad shape")
        err, rel = rel_err(dw, dw_ref)
        require(rel <= WGRAD_TOL, f"check_bwd {name}: wgrad kernel vs "
                                  f"plain {rel} > {WGRAD_TOL}")
        worst = max(worst, err)
        row.update(wgrad_shape=list(dw.shape), wgrad_max_abs_err=err,
                   wgrad_max_abs_err_over_max_ref=rel,
                   wgrad_split=list(W.wgrad_split(k * k * ci, co,
                                                  b * ho * wo)),
                   wgrad_tol=WGRAD_TOL)
        emit(row)
    return worst


class Decisions:
    """The discrete choices of a forward, shared between two runs.

    A ReLU keeps a pixel where its pre-activation is positive, and a
    max-pool routes a window's gradient to its maximum.  The kernel and
    the plain version sum in different orders, so a pre-activation
    within ~1e-6 of zero, or two pixels of a window within ~1e-6 of
    each other, can go one way in one and the other way in the other;
    the gradient then flows through another pixel, and the difference
    spreads through every layer below.  ``record`` is a conv for
    ``graph_forward`` that runs the port's conv and keeps the choices
    the port's backward makes (from the kernel's own pre-epilogue
    sums); ``replay`` is the plain version with those choices, whose
    autograd then differs from the port's only by the order of the
    sums.  ``flips`` counts where the plain version's own choices
    differ."""

    def __init__(self):
        self.masks, self.argmax = [], []
        self.flips = {"relu": 0, "pool": 0}
        self._i = 0

    @staticmethod
    def _windows(a: torch.Tensor, pool: int) -> torch.Tensor:
        b, h, w, c = a.shape
        return (a.reshape(b, h // pool, pool, w // pool, pool, c)
                .permute(0, 1, 3, 5, 2, 4)
                .reshape(b, h // pool, w // pool, c, pool * pool))

    def record(self, x, w, bias=None, residual=None, *, relu, pool,
               **kw):
        with torch.no_grad():
            z = conv2d_lb(x, w, **kw)
            if bias is not None:
                z = z + bias
            if residual is not None:
                z = z + residual
            self.masks.append(relu_slope(z) if relu else None)
            a = torch.clamp_min(z, 0.0) if relu else z
            self.argmax.append(self._windows(a, pool).argmax(
                dim=-1, keepdim=True) if pool > 1 else None)
        return conv2d_lb(x, w, bias, residual, relu=relu, pool=pool, **kw)

    def replay(self, x, w, bias=None, residual=None, *, relu, pool,
               **kw):
        mask, idx = self.masks[self._i], self.argmax[self._i]
        self._i += 1
        z = conv2d_ref(x, w, bias, residual, **kw)
        if relu:
            self.flips["relu"] += int((relu_slope(z.detach()) != mask)
                                      .sum())
            z = z * mask
        if pool > 1:
            win = self._windows(z, pool)
            own = win.detach().argmax(dim=-1, keepdim=True)
            self.flips["pool"] += int((own != idx).sum())
            z = win.gather(-1, idx).squeeze(-1)
        return z


def phase_train(model: str) -> dict:
    """A few SGD steps at full width, batch 8, through
    ``launch/train_vgg.py``'s step on the card; step 0's gradients held
    against the plain version's autograd on the same weights, batch,
    ReLU masks and pool maxima (:class:`Decisions`), and reported
    against its autograd on its own choices.  Returns the launches of
    the run."""
    gen = torch.Generator().manual_seed(SEED)
    size = 224 if model == "vgg" else 32
    graph, params = T.build_model(model, width_mult=1.0, n_classes=10,
                                  generator=gen, device="cuda")
    images, labels = T.make_batch(8, size, 10, gen, "cuda")
    n_convs = len(graph_stages(graph, size, size))
    plain_loss, plain = T.loss_and_grads(graph, params, images, labels,
                                         conv=conv2d_ref)
    dec = Decisions()
    with torch.no_grad():
        graph_logits(graph, params, images, conv=dec.record)
    _, aligned = T.loss_and_grads(graph, params, images, labels,
                                  conv=dec.replay)
    torch.cuda.synchronize()
    rep = graph_training_step_report(graph, size, size, batch=8,
                                     vmem_budget=1 << 20)
    per_step, errs, own = [], [], []

    def check(i, loss, grads):
        per_step.append((K.conv_lb.launches, W.wgrad_lb.launches))
        if i == 0:
            errs.extend(rel_err(g, want)[1]
                        for g, want in zip(grads, aligned))
            own.extend(rel_err(g, want)[1] for g, want in zip(grads, plain))
            errs.append(abs(float(loss) - float(plain_loss))
                        / abs(float(plain_loss)))

    tracer = Tracer()
    with tracer.activate():
        K.conv_lb.launches = 0
        W.wgrad_lb.launches = 0
        W.wgrad_lb.reduce_launches = 0
        losses = T.train(graph, params, images, labels,
                         steps=TRAIN_STEPS, lr=TRAIN_LR[model],
                         traffic_bytes=rep["bytes_per_step"],
                         on_step=check)
        launches = {"conv_lb": K.conv_lb.launches,
                    "wgrad_lb": W.wgrad_lb.launches,
                    "wgrad_reduce": W.wgrad_lb.reduce_launches}
    k1 = [c - p for (c, _), (p, _) in zip(per_step, [(0, 0)] + per_step)]
    k2 = [c - p for (_, c), (_, p) in zip(per_step, [(0, 0)] + per_step)]
    step_ms = [sp.attrs["us"] / 1e3 for sp in tracer.find("train.step")]
    # forward + recompute through K1 for every conv; dgrad for every
    # conv but the first (the images need no gradient)
    want_k1 = 3 * n_convs - 1
    row = {"phase": f"train_{model}", "batch": 8, "image": size,
           "convs": n_convs, "steps": TRAIN_STEPS, "lr": TRAIN_LR[model],
           "losses": losses, "plain_loss_step0": float(plain_loss),
           "grad_max_err_over_max_plain": max(errs[:-1]),
           "grad_tol": GRAD_TOL,
           "grad_max_err_over_max_plain_own_choices": max(own),
           "grad_err_per_tensor_own_choices": own,
           "plain_own_choices_flipped": dec.flips,
           "loss_rel_err_step0": errs[-1],
           "conv_lb_launches_per_step": k1,
           "wgrad_lb_launches_per_step": k2, "launches": launches,
           "step_ms": step_ms,
           "bytes_per_step": rep["bytes_per_step"],
           "train_vs_bound_x": rep["train_vs_bound_x"]}
    emit(row)
    require(all(np.isfinite(losses)), f"train_{model}: loss not finite")
    require(max(errs[:-1]) <= GRAD_TOL, f"train_{model}: step-0 grads vs "
            f"plain {max(errs[:-1])} > {GRAD_TOL}")
    require(errs[-1] <= TOL, f"train_{model}: step-0 loss vs plain "
                             f"{errs[-1]}")
    require(k1 == [want_k1] * TRAIN_STEPS,
            f"train_{model}: K1 launches per step {k1} != {want_k1}")
    require(k2 == [n_convs] * TRAIN_STEPS,
            f"train_{model}: K2 launches per step {k2} != {n_convs}")
    return launches


def phase_layers_bwd(card: str) -> tuple[list[dict], list[dict]]:
    """dgrad (K1) and wgrad (K2) per VGG16/224 layer at batch 8."""
    batch = 8
    gen = torch.Generator().manual_seed(SEED + 2)
    params = init_vgg(gen, device="cuda")
    graph = vgg_graph(params)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    dgrad_rows, wgrad_rows = [], []
    for i, (st, p) in enumerate(zip(graph_stages(graph, 224, 224),
                                    params["convs"])):
        node = st.node
        ci, co = node.ci, node.co
        x = _randn(gen, batch, st.h, st.w, ci)
        gy = _randn(gen, batch, st.ho, st.wo, co)
        w = p["w"]
        flops = 2.0 * batch * st.ho * st.wo * co * ci * 9
        t_ops = flops / PEAK_F32_FLOPS
        cl = torch.channels_last
        x_nchw = x.permute(0, 3, 1, 2).contiguous(memory_format=cl)
        gy_nchw = gy.permute(0, 3, 1, 2).contiguous(memory_format=cl)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=cl)
        base = {"model": "vgg16", "layer": node.name, "batch": batch,
                "in": [st.h, st.w, ci], "co": co, "flops": flops,
                "card": card}
        if i > 0:      # conv1_1's dgrad is never needed
            wf = flip_w(w)
            kw = dict(stride=(1, 1), padding=(1, 1))
            out = K.conv_lb(gy, wf, **kw)
            ref = conv2d_ref(gy, wf, **kw)
            err, rel = rel_err(out, ref)
            require(rel <= TOL, f"dgrad {node.name}: kernel vs plain {rel}")
            n_bytes = 4.0 * (gy.numel() + wf.numel() + out.numel())
            t_bytes = n_bytes / HBM_BYTES_PER_S
            row = dict(base, phase="layers_bwd", op="dgrad",
                       ms=_time_ms(lambda: K.conv_lb(gy, wf, **kw), flush),
                       plain_ms=_time_ms(lambda: conv2d_ref(gy, wf, **kw),
                                         flush),
                       library_ms=_time_ms(
                           lambda: torch.nn.grad.conv2d_input(
                               x_nchw.shape, w_oihw, gy_nchw, padding=1),
                           flush),
                       bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes
                       else "bytes", bytes=n_bytes,
                       max_abs_err=err, max_abs_err_over_max_ref=rel,
                       tile=list(K.cta_tile(batch, st.h, st.w, ci, 1)))
            emit(row)
            dgrad_rows.append(row)
        geom = W.WgradGeometry(hk=3, wk=3, stride=(1, 1), padding=(1, 1))
        dw = W.wgrad_lb(x, gy, geom)
        dw_ref = wgrad_ref(x, gy, 3, 3, padding=1)
        err, rel = rel_err(dw, dw_ref)
        require(rel <= WGRAD_TOL, f"wgrad {node.name}: kernel vs plain "
                                  f"{rel}")
        n_bytes = 4.0 * (x.numel() + gy.numel() + dw.numel())
        t_bytes = n_bytes / HBM_BYTES_PER_S
        row = dict(base, phase="layers_bwd", op="wgrad",
                   ms=_time_ms(lambda: W.wgrad_lb(x, gy, geom), flush),
                   plain_ms=_time_ms(
                       lambda: wgrad_ref(x, gy, 3, 3, padding=1), flush),
                   library_ms=_time_ms(
                       lambda: torch.nn.grad.conv2d_weight(
                           x_nchw, w_oihw.shape, gy_nchw, padding=1),
                       flush),
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   bytes=n_bytes, max_abs_err=err,
                   max_abs_err_over_max_ref=rel,
                   split=list(W.wgrad_split(9 * ci, co,
                                            batch * st.ho * st.wo)))
        emit(row)
        wgrad_rows.append(row)
    return dgrad_rows, wgrad_rows


def _sums(rows: list[dict]) -> dict:
    ops_ms = sum(r["bound_ms"] for r in rows
                 if r["bound_by"] == "operations")
    bound = sum(r["bound_ms"] for r in rows)
    return {"ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": bound,
            "bound_by": "operations" if 2 * ops_ms >= bound else "bytes",
            "library_ms": sum(r["library_ms"] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


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
    phase_check_bwd()
    vgg_launches = phase_serve("vgg")
    resnet_launches = phase_serve("resnet")
    train_vgg = phase_train("vgg")
    train_resnet = phase_train("resnet")
    rows = phase_layers(card)
    dgrad_rows, wgrad_rows = phase_layers_bwd(card)
    dgrad = _sums(dgrad_rows)
    kernels = [
        dict(_sums(rows), name="conv_lb", route="cuda", source=SOURCE,
             replaces=REPLACES, launches=vgg_launches,
             launches_resnet=resnet_launches,
             launches_train_vgg=train_vgg["conv_lb"],
             launches_train_resnet=train_resnet["conv_lb"],
             dgrad={k: dgrad[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
             times_are="sums over the 13 VGG16/224 convs at batch 8 "
                       "(dgrad: the 12 whose dgrad a step runs)",
             card=card),
        dict(_sums(wgrad_rows), name="wgrad_lb", route="cuda",
             source=WGRAD_SOURCE, replaces=WGRAD_REPLACES,
             launches=train_vgg["wgrad_lb"],
             launches_train_resnet=train_resnet["wgrad_lb"],
             reduce_launches=train_vgg["wgrad_reduce"],
             times_are="sums over the 13 VGG16/224 convs at batch 8",
             card=card)]
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
