"""Conv-network builders over the :mod:`repro_torch.models.graph` IR —
the port's copy of the VGG and ResNet builders of
``repro/models/cnn.py``.

VGG16 (the paper's own workload) and CIFAR-style ResNet BasicBlock
stacks are both :class:`~repro_torch.models.graph.ConvGraph` s; the
ResNet is the one that carries stride-2 downsampling, 1x1 projection
shortcuts and residual joins.  Init is He (Kaiming) with the sqrt(2)
ReLU gain, drawn from a ``torch.Generator``.  The training loss
(:func:`graph_loss` / :func:`vgg_loss`), the VGG training-step report
and the VGG helpers (:class:`ConvStage`, :func:`vgg_conv_geometry`,
:func:`vgg_conv_layers_for`, :func:`vgg_plan_handles`,
:func:`vgg_forward`, and :func:`resnet_forward`;
``repro/models/cnn.py:82-137, 148, 228``) are the reference's, thin
wrappers over the graph walk.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.exec_target import resolve_device
from repro_torch.core.layer import ConvLayer
from repro_torch.core.vgg import _CFG
from repro_torch.kernels.conv_lb.ops import conv2d_lb
from repro_torch.models.graph import (ConvGraph, ConvNode, graph_logits,
                                      graph_plan_handles, graph_stages,
                                      graph_training_step_report,
                                      init_graph)


def vgg_layer_dims(width_mult: float = 1.0):
    dims = []
    for name, ci, co, h, w in _CFG:
        dims.append((name, max(1, int(ci * width_mult)) if ci != 3 else 3,
                     max(1, int(co * width_mult)), h, w))
    return dims


def init_vgg(generator: torch.Generator, n_classes: int = 10,
             width_mult: float = 1.0, *, device="cuda") -> dict:
    """He-init VGG16 conv params (3x3, zero bias) and a linear head,
    drawn from ``generator`` and placed on ``device``."""
    dev = resolve_device(device)
    convs = []
    for _, ci, co, _, _ in vgg_layer_dims(width_mult):
        w = torch.randn((3, 3, ci, co), generator=generator) \
            * (math.sqrt(2.0) / math.sqrt(9 * ci))
        convs.append({"w": w.to(dev),
                      "b": torch.zeros((co,), device=dev)})
    last_co = vgg_layer_dims(width_mult)[-1][2]
    head = torch.randn((last_co, n_classes), generator=generator) \
        / math.sqrt(last_co)
    return {"convs": convs, "head": head.to(dev)}


_POOL_AFTER = {"conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3"}


def vgg_graph(params, name: str = "vgg") -> ConvGraph:
    """The VGG stack the params realize: channel counts from the param
    shapes (any ``width_mult``), pool cadence from the VGG-16 config."""
    nodes = []
    for p, (cfg_name, *_rest) in zip(params["convs"], _CFG):
        ci, co = int(p["w"].shape[2]), int(p["w"].shape[3])
        nodes.append(ConvNode(name=cfg_name, ci=ci, co=co,
                              pool=2 if cfg_name in _POOL_AFTER else 1))
    return ConvGraph(name=name, nodes=tuple(nodes))


@dataclasses.dataclass(frozen=True)
class ConvStage:
    """One conv layer of the stack as the forward pass will execute it
    for a given input-plane geometry (the VGG view of
    :class:`~repro_torch.models.graph.GraphStage`)."""

    name: str
    ci: int
    co: int
    h: int             # input plane entering this layer
    w: int
    pool: bool         # a 2x2 maxpool follows this layer
    fused_pool: bool   # ... and the kernel path fuses it in-epilogue


def vgg_conv_geometry(params, h: int, w: int, in_ch: int = 3, *,
                      strict: bool = False) -> list[ConvStage]:
    """Walk the conv stack for an (h, w, in_ch) image: a thin wrapper
    over :func:`~repro_torch.models.graph.graph_stages`.
    ``strict=False`` truncates the stack at the first channel mismatch
    (the reduced-width path); ``strict=True`` raises there."""
    return [ConvStage(name=st.node.name, ci=st.node.ci, co=st.node.co,
                      h=st.h, w=st.w, pool=st.pool > 1,
                      fused_pool=st.fused_pool)
            for st in graph_stages(vgg_graph(params), h, w, in_ch,
                                   strict=strict)]


def vgg_conv_layers_for(params, h: int, w: int, *, batch: int,
                        in_ch: int = 3) -> list[ConvLayer]:
    """The stack as :class:`~repro_torch.core.layer.ConvLayer`
    workloads at an arrival batch — the analytic side of the serve
    ledger."""
    return [ConvLayer(name=g.name, batch=batch, ci=g.ci, co=g.co,
                      hi=g.h, wi=g.w, hk=3, wk=3, stride=1, pad=1)
            for g in vgg_conv_geometry(params, h, w, in_ch)]


def vgg_plan_handles(params, h: int, w: int, *, batch: int,
                     in_ch: int = 3, dtype_bytes: int = 4,
                     vmem_budget: int | None = None,
                     training: bool = False):
    """Exported plan handles: [(ConvLayer, ConvPlan)] per conv stage at
    this arrival batch —
    :func:`~repro_torch.models.graph.graph_plan_handles` over the VGG
    graph, its walk truncated at a channel mismatch."""
    return graph_plan_handles(vgg_graph(params), h, w, batch=batch,
                              in_ch=in_ch, dtype_bytes=dtype_bytes,
                              vmem_budget=vmem_budget, training=training,
                              strict=False)


def vgg_forward(params, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) -> logits (B, n_classes):
    :func:`~repro_torch.models.graph.graph_logits` over the VGG graph,
    its walk truncated at a channel mismatch.  Every conv runs K1 with
    its epilogue fused on CUDA images, its plain version on CPU ones."""
    graph = vgg_graph(params)
    stages = graph_stages(graph, images.shape[1], images.shape[2],
                          images.shape[3], strict=False)
    if len(stages) < len(graph.nodes):
        graph = ConvGraph(name=graph.name,
                          nodes=graph.nodes[:len(stages)])
        params = {"convs": params["convs"][:len(stages)],
                  "head": params["head"]}
    return graph_logits(graph, params, images)


def resnet_forward(graph: ConvGraph, params,
                   images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, in_ch) -> logits:
    :func:`~repro_torch.models.graph.graph_logits` over a ResNet graph
    (residual joins fused), on K1 for CUDA images, the plain version
    for CPU ones."""
    return graph_logits(graph, params, images)


def vgg_training_step_report(params, h: int, w: int, *, batch: int,
                             in_ch: int = 3, dtype_bytes: int = 4,
                             vmem_budget: int | None = None) -> dict:
    """Per-training-step traffic accounting for the VGG conv stack —
    :func:`~repro_torch.models.graph.graph_training_step_report` over
    the VGG graph."""
    return graph_training_step_report(
        vgg_graph(params), h, w, batch=batch, in_ch=in_ch,
        dtype_bytes=dtype_bytes, vmem_budget=vmem_budget, strict=False)


def graph_loss(graph: ConvGraph, params, images: torch.Tensor,
               labels: torch.Tensor, *, conv=conv2d_lb) -> torch.Tensor:
    """Mean negative log-likelihood of ``log_softmax`` over the logits,
    in f32 (the reference's ``vgg_loss``, for any graph); ``conv`` as
    in :func:`~repro_torch.models.graph.graph_forward`."""
    logits = graph_logits(graph, params, images, conv=conv)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def vgg_loss(params, batch: dict) -> torch.Tensor:
    """:func:`graph_loss` over the VGG graph of ``params``;
    ``batch`` holds ``images`` and ``labels``."""
    return graph_loss(vgg_graph(params), params, batch["images"],
                      batch["labels"])


def resnet_graph(blocks=(3, 3, 3), widths=(16, 32, 64), in_ch: int = 3,
                 width_mult: float = 1.0,
                 name: str | None = None) -> ConvGraph:
    """CIFAR-style ResNet of BasicBlocks: one 3x3 stem, then
    ``blocks[i]`` BasicBlocks at ``widths[i]`` channels per stage;
    every stage after the first opens with a stride-2 block whose
    shortcut is a 1x1 stride-2 projection.  Each block is

        x -> conv3x3(stride s) + ReLU -> conv3x3 -> (+ shortcut) -> ReLU

    with the join as the second conv's ``residual`` edge.  Defaults
    build ResNet-20; ``width_mult`` scales channel widths."""
    widths = tuple(max(1, int(round(w * width_mult))) for w in widths)
    if name is None:
        name = f"resnet{2 + 2 * sum(blocks)}"
    nodes = [ConvNode(name="stem", ci=in_ch, co=widths[0])]
    prev = "stem"
    ci = widths[0]
    for si, (n_blocks, co) in enumerate(zip(blocks, widths), start=1):
        for bi in range(n_blocks):
            stride = 2 if si > 1 and bi == 0 else 1
            base = f"s{si}b{bi}"
            block_in = prev
            if stride != 1 or ci != co:
                nodes.append(ConvNode(name=f"{base}_proj", ci=ci, co=co,
                                      hk=1, wk=1, stride=stride, pad=0,
                                      relu=False, src=block_in))
                shortcut = f"{base}_proj"
            else:
                shortcut = block_in
            nodes.append(ConvNode(name=f"{base}_a", ci=ci, co=co,
                                  stride=stride, src=block_in))
            nodes.append(ConvNode(name=f"{base}_b", ci=co, co=co,
                                  residual=shortcut))
            prev = f"{base}_b"
            ci = co
    return ConvGraph(name=name, nodes=tuple(nodes))


def init_resnet(generator: torch.Generator, graph: ConvGraph | None = None,
                n_classes: int = 10, *, device="cuda") -> dict:
    """He-init params for a ResNet graph (default: ResNet-20)."""
    return init_graph(generator, graph or resnet_graph(),
                      n_classes=n_classes, device=device)
