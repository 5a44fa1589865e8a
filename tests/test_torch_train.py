"""One SGD step of the port's trainer on the CPU against the reference:
``jax.value_and_grad`` of the reference loss over
``graph_logits(target="lax")`` (``vgg_loss`` for VGG), on the same
weights (handed across with ``params_from_numpy``) and the same numpy
batch.  Tolerances: the loss within 1e-5 relative; every gradient and
every updated parameter within 1e-4 * max |ref| of its tensor (f32 sums
over 13-21 layers in another order).  Also a smoke run of the
trainer's command line."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.cnn import init_resnet as jax_init_resnet
from repro.models.cnn import init_vgg as jax_init_vgg
from repro.models.cnn import resnet_graph as jax_resnet_graph
from repro.models.cnn import vgg_loss as jax_vgg_loss
from repro.models.graph import graph_logits as jax_graph_logits
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch.train_vgg import param_leaves, sgd_step
from repro_torch.models.cnn import resnet_graph, vgg_graph

REPO = Path(__file__).resolve().parent.parent
LR = 0.05
# model, width_mult, image, batch
CASES = {"vgg": ("vgg", 1 / 16, 32, 4), "resnet": ("resnet", 0.25, 16, 4)}


def _numpy_tree(params):
    return {"convs": [{k: np.asarray(v) for k, v in p.items()}
                      for p in params["convs"]],
            "head": np.asarray(params["head"])}


def _reference(model, width, size, batch):
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    labels = (np.arange(batch) % 4).astype(np.int32)
    if model == "vgg":
        params = jax_init_vgg(key, n_classes=4, width_mult=width)

        def loss(p):
            return jax_vgg_loss(p, {"images": images, "labels": labels},
                                "lax")
    else:
        graph = jax_resnet_graph(width_mult=width)
        params = jax_init_resnet(key, graph, n_classes=4)

        def loss(p):
            logits = jax_graph_logits(graph, p, images, target="lax")
            logp = jax.nn.log_softmax(logits.astype(jnp.float32))
            return -jnp.take_along_axis(logp, labels[:, None], 1).mean()
    # biases are zero at init; make them count
    for i, p in enumerate(params["convs"]):
        if "b" in p:
            p["b"] = p["b"] + 0.01 * (i + 1)
    value, grads = jax.value_and_grad(loss)(params)
    stepped = jax.tree_util.tree_map(lambda a, g: a - LR * g, params,
                                     grads)
    return (params, images, labels, float(value), _numpy_tree(grads),
            _numpy_tree(stepped))


def _like_params(params, flat):
    it = iter(flat)
    return {"convs": [{k: next(it) for k in ("w", "b") if k in conv}
                      for conv in params["convs"]],
            "head": next(it)}


def _leaves(tree):
    out = []
    for conv in tree["convs"]:
        out += [conv[k] for k in ("w", "b") if k in conv]
    return out + [tree["head"]]


@pytest.mark.parametrize("name", list(CASES))
def test_one_sgd_step_matches_reference(name):
    model, width, size, batch = CASES[name]
    jparams, images, labels, ref_loss, ref_grads, ref_stepped = \
        _reference(model, width, size, batch)
    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    for t in param_leaves(params):
        t.requires_grad_(True)
    graph = (vgg_graph(params) if model == "vgg"
             else resnet_graph(width_mult=width))
    loss, grads = sgd_step(graph, params, torch.from_numpy(images),
                           torch.from_numpy(labels), LR)
    assert abs(float(loss) - ref_loss) <= 1e-5 * abs(ref_loss)
    got_grads = params_to_numpy(_like_params(params, grads))
    for which, got, ref in (("grad", got_grads, ref_grads),
                            ("param", params_to_numpy(params),
                             ref_stepped)):
        for i, (g, r) in enumerate(zip(_leaves(got), _leaves(ref))):
            assert g.shape == r.shape, (which, i)
            err = np.abs(g - r).max()
            assert err <= 1e-4 * np.abs(r).max(), (which, i, err)


@pytest.mark.parametrize("model", ["vgg", "resnet"])
def test_trainer_command_line_runs_on_the_cpu(model):
    extra = ["--model", "resnet", "--image", "16", "--width-mult",
             "0.25", "--lr", "0.001"] if model == "resnet" else []
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_vgg",
         "--device", "cpu", "--steps", "2", *extra],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("per-step traffic:")
    losses = [float(ln.split()[3]) for ln in lines
              if ln.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_profile_step_needs_a_card(monkeypatch):
    """The profile measures the card; without one it raises rather than
    profiling the CPU."""
    from repro_torch.launch import profile_step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_step.profile_steps("resnet", image=16, batch=2,
                                   width_mult=0.25, steps=1, warmup=0,
                                   lr=1e-3)
