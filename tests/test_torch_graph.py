"""The port's conv graphs on the CPU against the reference's lax
forward, on the same weights (handed across with
``params_from_numpy``) and the same numpy images.  Tolerance: max
|port - ref| <= 1e-4 * max |ref| on the logits (f32, 13-21 layers)."""

import jax
import numpy as np
import pytest
import torch

from repro.models.cnn import init_resnet as jax_init_resnet
from repro.models.cnn import init_vgg as jax_init_vgg
from repro.models.cnn import resnet_graph as jax_resnet_graph
from repro.models.cnn import vgg_graph as jax_vgg_graph
from repro.models.graph import graph_logits as jax_graph_logits
from repro.models.graph import graph_stages as jax_graph_stages
from repro_torch.convert import params_from_numpy
from repro_torch.core.exec_target import resolve_device
from repro_torch.kernels.conv_lb.ref import conv2d_ref
from repro_torch.models.cnn import (init_resnet, init_vgg, resnet_graph,
                                    vgg_graph, vgg_layer_dims)
from repro_torch.models.graph import (ConvGraph, ConvNode, graph_logits,
                                      graph_stages)

TOL = 1e-4


def _model(name):
    key = jax.random.PRNGKey(0)
    if name == "vgg":
        params = jax_init_vgg(key, width_mult=1 / 16)
        # biases are zero at init; make them count
        for i, p in enumerate(params["convs"]):
            p["b"] = p["b"] + 0.01 * (i + 1)
        return jax_vgg_graph(params), params
    graph = jax_resnet_graph(width_mult=0.25)
    return graph, jax_init_resnet(key, graph)


def _numpy_tree(params):
    return {"convs": [{k: np.asarray(v) for k, v in p.items()}
                      for p in params["convs"]],
            "head": np.asarray(params["head"])}


@pytest.mark.parametrize("model", ["vgg", "resnet"])
def test_graph_logits_match_reference_lax(model):
    ref_graph, ref_params = _model(model)
    images = np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax_graph_logits(ref_graph, ref_params, images,
                                      target="lax"))
    params = params_from_numpy(_numpy_tree(ref_params), device="cpu")
    graph = (vgg_graph(params) if model == "vgg"
             else resnet_graph(width_mult=0.25))
    assert graph == ConvGraph(name=ref_graph.name, nodes=tuple(
        ConvNode(**vars(n)) for n in ref_graph.nodes))
    got = graph_logits(graph, params, torch.from_numpy(images))
    assert tuple(got.shape) == ref.shape == (2, 10)
    err = np.abs(got.numpy() - ref).max()
    assert err <= TOL * np.abs(ref).max(), err
    # the plain forward is the same computation on the CPU
    plain = graph_logits(graph, params, torch.from_numpy(images),
                         conv=conv2d_ref)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("size", [224, 32, 20, 7])
def test_graph_stages_equal_reference(size):
    for ref_graph, graph in ((jax_resnet_graph(), resnet_graph()),
                             (jax_vgg_graph(jax_init_vgg(
                                 jax.random.PRNGKey(0), width_mult=1 / 16)),
                              vgg_graph({"convs": [
                                  {"w": torch.zeros(3, 3, ci, co)}
                                  for _, ci, co, _, _ in
                                  vgg_layer_dims(1 / 16)]}))):
        got = graph_stages(graph, size, size, strict=False)
        ref = jax_graph_stages(ref_graph, size, size, strict=False)
        assert [(s.node.name, s.h, s.w, s.ho, s.wo, s.pool, s.fused_pool,
                 s.residual) for s in got] == \
            [(s.node.name, s.h, s.w, s.ho, s.wo, s.pool, s.fused_pool,
              s.residual) for s in ref]


def test_init_is_seeded_he_and_shaped():
    a = init_vgg(torch.Generator().manual_seed(3), device="cpu")
    b = init_vgg(torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(p["w"], q["w"])
               for p, q in zip(a["convs"], b["convs"]))
    assert [tuple(p["w"].shape) for p in a["convs"]] == \
        [(3, 3, ci, co) for _, ci, co, _, _ in vgg_layer_dims()]
    w = a["convs"][5]["w"]               # 256 -> 256: fan_in 2304
    assert abs(w.std().item() / (2.0 / 2304) ** 0.5 - 1.0) < 0.05
    r = init_resnet(torch.Generator().manual_seed(0), device="cpu")
    assert len(r["convs"]) == 21 and tuple(r["head"].shape) == (64, 10)
    assert "b" in r["convs"][0] and r["convs"][0]["w"].dtype == \
        torch.float32


def test_cuda_entry_points_never_fall_back_to_cpu():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_vgg(torch.Generator(), width_mult=1 / 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"convs": [], "head": np.zeros((2, 2))})
