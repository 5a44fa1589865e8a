"""Model-agnostic conv-graph IR — the port's copy of
``repro/models/graph.py``.

A :class:`ConvGraph` of :class:`ConvNode` s carries each conv's
geometry, its epilogue (bias/relu/pool) and an optional residual input
edge; one geometry walk (:func:`graph_stages`) is shared by every
consumer:

  * :func:`graph_forward` — the executable forward: every conv runs
    :func:`~repro_torch.kernels.conv_lb.ops.conv2d_lb` with its
    epilogue (bias, residual join, ReLU, aligned pool) fused;
  * :func:`graph_plan_handles` — the ``(ConvLayer, ConvPlan)``
    accounting handles the serve ledger charges, or with
    ``training=True`` the ``(ConvLayer, ConvTrainingPlan)`` handles of
    a training step (forward, dgrad and wgrad plans);
  * :func:`graph_training_step_report` — a training step's accounted
    words against the per-step Eq. (15) sum.

Topology: nodes are listed in topological order; each node consumes
``src`` (a prior node's name, or :data:`GRAPH_INPUT`; ``None`` chains
to the preceding node) and may name a ``residual`` tensor added to its
conv output before the ReLU/pool epilogue — the BasicBlock join.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.analysis.plan_check import (Diagnostic, PlanLegalityError,
                                             audit_handles)
from repro_torch.core.exec_target import KERNEL, resolve_device
from repro_torch.core.layer import ConvLayer
from repro_torch.kernels.conv_lb.ops import (conv2d_lb, conv2d_lb_timed,
                                            plan_conv, plan_conv_training)
from repro_torch.kernels.conv_lb.ref import max_pool
from repro_torch.obs.tracer import NULL_SPAN, active_tracer

GRAPH_INPUT = "input"


@dataclasses.dataclass(frozen=True)
class ConvNode:
    """One conv layer of a :class:`ConvGraph`.  ``pool`` is an aligned
    ``pool x pool`` max-pool after the epilogue (fused when the output
    plane divides it, skipped when the plane is smaller than the
    window)."""

    name: str
    ci: int
    co: int
    hk: int = 3
    wk: int = 3
    stride: int = 1
    pad: int = 1
    groups: int = 1
    bias: bool = True
    relu: bool = True
    pool: int = 1
    src: str | None = None
    residual: str | None = None


@dataclasses.dataclass(frozen=True)
class ConvGraph:
    """A conv network as a topologically-ordered tuple of nodes;
    hashable, so a graph can key plan-handle caches."""

    name: str
    nodes: tuple[ConvNode, ...]

    def __post_init__(self):
        seen = {GRAPH_INPUT}
        for node in self.nodes:
            if node.name in seen:
                raise ValueError(f"duplicate node name {node.name!r}")
            for ref in (node.src, node.residual):
                if ref is not None and ref not in seen:
                    raise ValueError(
                        f"node {node.name!r} references {ref!r} before "
                        f"it is produced (nodes must be topological)")
            if node.ci % node.groups or node.co % node.groups:
                raise ValueError(f"node {node.name!r}: groups="
                                 f"{node.groups} must divide ci={node.ci}"
                                 f" and co={node.co}")
            seen.add(node.name)

    @property
    def out_channels(self) -> int:
        return self.nodes[-1].co


@dataclasses.dataclass(frozen=True)
class GraphStage:
    """One node resolved against a concrete input-plane geometry."""

    node: ConvNode
    h: int              # input plane entering the conv
    w: int
    ho: int             # conv output plane (pre-pool)
    wo: int
    pool: int           # effective pool (1 = none; plane too small)
    fused_pool: bool    # the pool is fused into the conv's epilogue
    residual: bool      # a residual join lands on this node's output


def graph_stages(graph: ConvGraph, h: int, w: int, in_ch: int = 3, *,
                 strict: bool = True) -> list[GraphStage]:
    """Resolve the graph against an ``(h, w, in_ch)`` input image.
    ``strict=True`` raises on a channel mismatch along the walk;
    ``strict=False`` truncates the stack there instead."""
    shapes: dict[str, tuple[int, int, int]] = {GRAPH_INPUT: (h, w, in_ch)}
    prev = GRAPH_INPUT
    stages: list[GraphStage] = []
    for node in graph.nodes:
        h0, w0, c0 = shapes[node.src or prev]
        if c0 != node.ci:
            if strict:
                raise ValueError(
                    f"node {node.name!r} expects ci={node.ci} but its "
                    f"input {node.src or prev!r} carries {c0} channels "
                    f"(pass strict=False to truncate the walk here)")
            break
        ho = (h0 + 2 * node.pad - node.hk) // node.stride + 1
        wo = (w0 + 2 * node.pad - node.wk) // node.stride + 1
        if ho < 1 or wo < 1:
            raise ValueError(f"node {node.name!r}: {node.hk}x{node.wk} "
                             f"s{node.stride} conv has no output on a "
                             f"{h0}x{w0} plane")
        if node.residual is not None:
            rshape = shapes[node.residual]
            if rshape != (ho, wo, node.co):
                raise ValueError(
                    f"node {node.name!r}: residual {node.residual!r} is "
                    f"{rshape}, join needs {(ho, wo, node.co)}")
        pool = node.pool if node.pool > 1 and min(ho, wo) >= node.pool else 1
        fused = pool > 1 and ho % pool == 0 and wo % pool == 0
        stages.append(GraphStage(node=node, h=h0, w=w0, ho=ho, wo=wo,
                                 pool=pool, fused_pool=fused,
                                 residual=node.residual is not None))
        shapes[node.name] = (ho // pool, wo // pool, node.co)
        prev = node.name
    return stages


def init_graph(generator: torch.Generator, graph: ConvGraph,
               n_classes: int = 10, *, device="cuda") -> dict:
    """He-init conv params for every node + a linear head off the graph
    output channels, drawn from ``generator`` (a CPU generator, so the
    weights do not depend on the device) and placed on ``device``.
    Returns the ``{"convs": [{"w", "b"}], "head"}`` dict.  ReLU nodes
    get the sqrt(2) gain; linear nodes (1x1 projections) plain He."""
    dev = resolve_device(device)
    convs = []
    for node in graph.nodes:
        fan_in = node.hk * node.wk * (node.ci // node.groups)
        gain = math.sqrt(2.0) if node.relu else 1.0
        w = torch.randn((node.hk, node.wk, node.ci // node.groups,
                         node.co), generator=generator) \
            * (gain / math.sqrt(fan_in))
        p = {"w": w.to(dev)}
        if node.bias:
            p["b"] = torch.zeros((node.co,), device=dev)
        convs.append(p)
    co = graph.out_channels
    head = torch.randn((co, n_classes), generator=generator) / math.sqrt(co)
    return {"convs": convs, "head": head.to(dev)}


def graph_forward(graph: ConvGraph, conv_params, x: torch.Tensor, *,
                  conv=conv2d_lb, tracer=None) -> torch.Tensor:
    """Execute the graph on ``x`` (B, H, W, Ci) -> (B, H', W', Co).

    ``conv_params`` aligns with ``graph.nodes``.  Every conv runs
    ``conv`` — by default :func:`conv2d_lb`, i.e. the CUDA kernel for a
    CUDA ``x`` — with its epilogue fused; a pool the plane does not
    divide runs unfused after it.  Passing the plain
    :func:`~repro_torch.kernels.conv_lb.ref.conv2d_ref` gives the
    reference forward a kernel run is held against.

    ``tracer`` (default: the ambient tracer), when active, records a
    ``graph.forward`` span and one ``graph.layer`` span per node; with
    the default ``conv`` each layer runs through
    :func:`~repro_torch.kernels.conv_lb.ops.conv2d_lb_timed` inside it,
    which waits for the device after every layer and records the
    layer's accounted bytes beside its seconds (on the card also its
    device time).  Inside a ``torch.jit`` trace or a ``torch.compile``
    nothing is recorded, and with the tracer inactive nothing of this
    runs at all: no span, no event, no wait."""
    tr = active_tracer() if tracer is None else tracer
    timing = (tr.active and not torch.jit.is_tracing()
              and not torch.compiler.is_compiling())
    timed = timing and conv is conv2d_lb
    stages = graph_stages(graph, x.shape[1], x.shape[2], x.shape[3])
    tensors = {GRAPH_INPUT: x}
    prev = GRAPH_INPUT
    out = x
    fwd_span = NULL_SPAN
    if timing:      # mode: the kernel target, or the conv's own name
        mode = KERNEL.name if timed else \
            getattr(conv, "__name__", type(conv).__name__)
        fwd_span = tr.span("graph.forward", model=graph.name,
                           batch=x.shape[0], mode=mode)
    with fwd_span:
        for p, st in zip(conv_params, stages):
            node = st.node
            src = tensors[node.src or prev]
            res = (None if node.residual is None
                   else tensors[node.residual])
            bias = p.get("b") if node.bias else None
            kw = dict(stride=node.stride, padding=node.pad,
                      groups=node.groups, relu=node.relu,
                      pool=st.pool if st.fused_pool else 1)
            if timing:
                with tr.span("graph.layer", layer=node.name,
                             model=graph.name):
                    if timed:
                        y = conv2d_lb_timed(src, p["w"], bias, res,
                                            tracer=tr, **kw)
                    else:
                        y = conv(src, p["w"], bias, res, **kw)
            else:
                y = conv(src, p["w"], bias, res, **kw)
            if st.pool > 1 and not st.fused_pool:
                y = max_pool(y, st.pool)
            tensors[node.name] = y
            prev = node.name
            out = y
    return out


def graph_logits(graph: ConvGraph, params, images: torch.Tensor, *,
                 conv=conv2d_lb) -> torch.Tensor:
    """Full classification forward: graph features, global mean pool,
    linear head (``params`` from :func:`init_graph`); the features'
    spans go to the ambient tracer, as in :func:`graph_forward`."""
    h = graph_forward(graph, params["convs"], images, conv=conv)
    return h.mean(dim=(1, 2)) @ params["head"]


def graph_plan_handles(graph: ConvGraph, h: int, w: int, *, batch: int,
                       in_ch: int = 3, dtype_bytes: int = 4,
                       vmem_budget: int | None = None,
                       training: bool = False, strict: bool = True,
                       verify: bool = False):
    """Accounting handles for the whole graph at an arrival batch:
    ``[(ConvLayer, ConvPlan)]`` per conv stage, from the memoized
    ``plan_conv`` cache (grouped nodes export one per-group handle per
    group).  ``training=True`` exports ``(ConvLayer,
    ConvTrainingPlan)`` instead: the forward handle plus the planned
    dgrad/wgrad convs of each layer's backward.  An explicit
    ``vmem_budget`` (e.g. the paper's 1 MiB GBuf) yields the
    accounting plans the ledger scores distance-to-bound with.
    ``verify=True`` audits the handles
    (:func:`~repro_torch.analysis.plan_check.audit_handles`) and raises
    :class:`~repro_torch.analysis.plan_check.PlanLegalityError` on any
    structural finding or accountant drift."""
    handles = []
    for st in graph_stages(graph, h, w, in_ch, strict=strict):
        node = st.node
        ci_g, co_g = node.ci // node.groups, node.co // node.groups
        layer = ConvLayer(name=node.name, batch=batch, ci=ci_g, co=co_g,
                          hi=st.h, wi=st.w, hk=node.hk, wk=node.wk,
                          stride=node.stride, pad=node.pad)
        plan = plan_conv(st.h, st.w, ci_g, co_g, node.hk, node.wk,
                         batch=batch, stride=(node.stride,) * 2,
                         padding=(node.pad,) * 2,
                         pool=st.pool if st.fused_pool else 1,
                         residual=st.residual,
                         dtype_bytes=dtype_bytes,
                         vmem_budget=vmem_budget)
        if training:
            plan = plan_conv_training(
                plan, batch=batch, groups=node.groups,
                dtype_bytes=dtype_bytes, vmem_budget=vmem_budget)
        handles.extend([(layer, plan)] * node.groups)
    if verify:
        audit = audit_handles(handles, batch=batch,
                              dtype_bytes=dtype_bytes,
                              vmem_budget=vmem_budget)
        if not audit.ok:
            diags = audit.errors() or [Diagnostic(
                rule="audit.traffic", severity="error",
                message=audit.report())]
            raise PlanLegalityError(diags)
    return handles


def graph_training_step_report(graph: ConvGraph, h: int, w: int, *,
                               batch: int, in_ch: int = 3,
                               dtype_bytes: int = 4,
                               vmem_budget: int | None = None,
                               strict: bool = True,
                               tracer=None) -> dict:
    """Per-training-step traffic accounting for any conv graph: every
    layer's planned fwd+dgrad+wgrad words
    (:meth:`ConvTrainingPlan.traffic`) scored against the per-graph
    ``q_dram_training`` sum, each pass's Eq. (15) term at its realized
    plan footprint — the training counterpart of the serve ledger's
    ``vs_bound_x``.  The ambient (or given) tracer records a
    ``graph.training_report`` span."""
    tr = active_tracer() if tracer is None else tracer
    with tr.span("graph.training_report", model=graph.name,
                 batch=batch) as _sp:
        handles = graph_plan_handles(graph, h, w, batch=batch,
                                     in_ch=in_ch,
                                     dtype_bytes=dtype_bytes,
                                     vmem_budget=vmem_budget,
                                     training=True, strict=strict)
        words = fwd_words = bound = 0.0
        kernel_layers = 0
        for layer, tp in handles:
            t = tp.traffic(batch)
            words += t.total
            fwd_words += t.fwd.total
            bound += tp.bound_words(layer)
            kernel_layers += int(tp.dgrad_kernel)
        n_stages = len(graph_stages(graph, h, w, in_ch, strict=strict))
        _sp.set(traffic_bytes=words * dtype_bytes,
                train_vs_bound_x=words / max(bound, 1e-30))
        return {
            "model": graph.name,
            "layers": n_stages,
            "dgrad_kernel_layers": kernel_layers,
            "dgrad_kernel_frac": kernel_layers / max(1, len(handles)),
            "bytes_per_step": words * dtype_bytes,
            "bound_bytes_per_step": bound * dtype_bytes,
            "train_vs_bound_x": words / max(bound, 1e-30),
            "bwd_share": (words - fwd_words) / max(words, 1e-30),
        }
