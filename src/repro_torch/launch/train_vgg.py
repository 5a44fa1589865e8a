"""Train a conv stack through the port's kernels and account each
training step's traffic against the bound — the port's counterpart of
``examples/train_vgg.py``.

Every step runs the loss forward through the conv kernel with its
fused epilogue and the backward through :class:`ConvLb`: the conv
kernel recomputes the pre-epilogue sums and runs dgrad (flipped
weights at full padding, ``lhs_dilation = stride``), and the wgrad
kernel runs dW.  The update is plain SGD, ``p -= lr * g``, in place on
the parameter tensors.  The printed report scores the accounted
fwd+dgrad+wgrad bytes against ``q_dram_training``.

  # plain PyTorch versions on the CPU, a small VGG:
  PYTHONPATH=src python -m repro_torch.launch.train_vgg --device cpu

  # VGG16/224 at full width, batch 8, through the kernels on the card:
  PYTHONPATH=src python -m repro_torch.launch.train_vgg \\
      --image 224 --width-mult 1.0 --steps 3 --lr 1e-4

  # ResNet-20 on 32x32 images:
  PYTHONPATH=src python -m repro_torch.launch.train_vgg --model resnet \\
      --image 32 --width-mult 1.0 --steps 3 --lr 1e-3

  # a Perfetto/Chrome trace (+ JSONL): planning, the training report,
  # each step and, inside it, each layer's forward with its bytes
  PYTHONPATH=src python -m repro_torch.launch.train_vgg --device cpu \\
      --steps 1 --trace train.trace.json

(The stacks have no normalization layers; at full width the default
rate of the small demo diverges.)

A traced step runs eagerly, so it holds each forward layer's
``graph.layer`` / ``kernel.conv2d_lb`` spans; each of those waits for
the device, so a traced step's ``us`` is not an untraced step's time.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import torch

from repro_torch.core.exec_target import resolve_device
from repro_torch.kernels.conv_lb.ops import conv2d_lb
from repro_torch.models.cnn import (graph_loss, init_resnet, init_vgg,
                                    resnet_graph, vgg_graph)
from repro_torch.models.graph import (ConvGraph,
                                      graph_training_step_report)
from repro_torch.obs import Tracer, write_trace
from repro_torch.obs.tracer import active_tracer

N_CLASSES = 4       # as in examples/train_vgg.py


def report_line(rep: dict, tag: str) -> str:
    return (f"{tag}: {rep['bytes_per_step'] / 1e6:.2f} MB/step "
            f"(bwd {rep['bwd_share'] * 100:.0f}%), "
            f"{rep['train_vs_bound_x']:.3f}x q_dram_training, "
            f"dgrad-through-kernel on {rep['dgrad_kernel_layers']}"
            f"/{rep['layers']} layers")


def build_model(model: str, *, width_mult: float, n_classes: int,
                generator: torch.Generator, device) -> tuple[ConvGraph,
                                                             dict]:
    """The graph and its He-init params, every leaf requiring a
    gradient."""
    if model == "resnet":
        graph = resnet_graph(width_mult=width_mult)
        params = init_resnet(generator, graph, n_classes=n_classes,
                             device=device)
    else:
        params = init_vgg(generator, n_classes=n_classes,
                          width_mult=width_mult, device=device)
        graph = vgg_graph(params)
    for t in param_leaves(params):
        t.requires_grad_(True)
    return graph, params


def param_leaves(params: dict) -> list[torch.Tensor]:
    """The parameter tensors in a fixed order: each conv's ``w`` then
    ``b`` (where present), then the head."""
    out = []
    for conv in params["convs"]:
        out += [conv[k] for k in ("w", "b") if k in conv]
    return out + [params["head"]]


def make_batch(batch: int, image: int, n_classes: int,
               generator: torch.Generator, device) -> tuple[torch.Tensor,
                                                            torch.Tensor]:
    """Images with a learnable per-class shift, as
    ``examples/train_vgg.py`` makes them."""
    labels = torch.arange(batch) % n_classes
    images = torch.randn((batch, image, image, 3), generator=generator)
    images = images + labels[:, None, None, None] * 0.5
    return images.to(device), labels.to(device)


def loss_and_grads(graph: ConvGraph, params: dict, images: torch.Tensor,
                   labels: torch.Tensor, *, conv=conv2d_lb):
    """The loss and its gradient with respect to every parameter
    (:func:`param_leaves` order)."""
    loss = graph_loss(graph, params, images, labels, conv=conv)
    return loss.detach(), torch.autograd.grad(loss, param_leaves(params))


def sgd_step(graph: ConvGraph, params: dict, images: torch.Tensor,
             labels: torch.Tensor, lr: float):
    """One plain SGD step, ``p -= lr * g`` in place; returns the loss
    and the gradients it applied."""
    loss, grads = loss_and_grads(graph, params, images, labels)
    with torch.no_grad():
        for p, g in zip(param_leaves(params), grads):
            p.sub_(lr * g)
    return loss, grads


def train(graph: ConvGraph, params: dict, images: torch.Tensor,
          labels: torch.Tensor, *, steps: int, lr: float,
          traffic_bytes: float = 0.0, on_step=None,
          tracer=None) -> list[float]:
    """``steps`` SGD steps on one batch; each is a ``train.step`` span
    of ``tracer`` (default: the ambient one; with ``traffic_bytes`` and
    its wall ``us`` after the device finished).  A tracer passed here
    and not made ambient times the steps alone: the forward's per-layer
    spans, and their waits, follow the ambient tracer.
    ``on_step(i, loss, grads)`` sees each step.  Returns the losses."""
    tr = active_tracer() if tracer is None else tracer
    cuda = images.device.type == "cuda"
    losses = []
    for i in range(steps):
        with tr.span("train.step", step=i,
                     traffic_bytes=traffic_bytes) as sp:
            t0 = time.perf_counter()
            loss, grads = sgd_step(graph, params, images, labels, lr)
            if cuda:
                torch.cuda.synchronize(images.device)
            sp.set(us=(time.perf_counter() - t0) * 1e6)
        losses.append(float(loss))
        if on_step is not None:
            on_step(i, loss, grads)
    return losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("vgg", "resnet"), default="vgg")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--image", type=int, default=8,
                    help="square image edge")
    ap.add_argument("--width-mult", type=float, default=0.05)
    ap.add_argument("--lr", type=float, default=0.08)
    ap.add_argument("--budget-kib", type=int, default=1024,
                    help="on-chip accounting budget for the bound")
    ap.add_argument("--paper-scale", action="store_true",
                    help="also report the account-only VGG16/224x224 "
                         "training-step economics")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda runs the CUDA kernels; cpu their plain "
                         "PyTorch versions")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Perfetto/Chrome trace JSON (+ JSONL "
                         "event log at PATH.jsonl): planning spans, the "
                         "training report span, per-step spans and the "
                         "forward's per-layer spans (each layer waits "
                         "for the device)")
    args = ap.parse_args(argv)
    tracer = Tracer() if args.trace else None
    # the ambient tracer over the whole run: planning (inside the
    # memoized plan_conv), the report and every step land in one trace
    with tracer.activate() if tracer else contextlib.nullcontext():
        run(args)
    if tracer is not None:
        out = write_trace(args.trace, tracer)
        print(f"trace: {out} ({len(tracer.records)} records; open in "
              f"ui.perfetto.dev)")


def run(args) -> None:
    """The run :func:`main` parsed ``args`` for."""
    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)
    graph, params = build_model(args.model, width_mult=args.width_mult,
                                n_classes=N_CLASSES, generator=gen,
                                device=dev)
    images, labels = make_batch(args.batch, args.image, N_CLASSES, gen,
                                dev)
    # the per-step traffic is plan-derived, hence step-invariant: one
    # report covers every step of the run
    rep = graph_training_step_report(graph, args.image, args.image,
                                     batch=args.batch,
                                     vmem_budget=args.budget_kib * 1024,
                                     strict=False)
    print(report_line(rep, "per-step traffic"))

    def show(i, loss, _grads):
        print(f"step {i}: loss {float(loss):.4f}  "
              f"[{rep['bytes_per_step'] / 1e6:.2f} MB accounted, "
              f"{rep['train_vs_bound_x']:.3f}x bound]")

    t0 = time.perf_counter()
    train(graph, params, images, labels, steps=args.steps, lr=args.lr,
          traffic_bytes=rep["bytes_per_step"], on_step=show)
    print(f"{args.steps} steps in {time.perf_counter() - t0:.2f}s on "
          f"{dev.type}")
    if args.paper_scale:
        big = init_vgg(gen, n_classes=10, width_mult=1.0, device="cpu")
        rep224 = graph_training_step_report(vgg_graph(big), 224, 224,
                                            batch=8, vmem_budget=1 << 20,
                                            strict=False)
        print(report_line(rep224, "VGG16/224 @ 1 MiB (account-only)"))


if __name__ == "__main__":
    main()
