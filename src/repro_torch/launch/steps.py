"""Step builders shared by the trainer and the servers — the port's
copy of ``repro/launch/steps.py``.

A train step takes the loss and its gradients in the f32 master params
(``torch.autograd.grad``), then runs :func:`repro_torch.optim.adamw.update`,
which writes the new params and moments into the state's own tensors
(the reference jits the step and donates the state).  ``TrainState``'s
``step`` and its optimizer's are 0-d int32 tensors on the host, so the
learning rate is chosen on the host without a device sync; ``loss`` and
``grad_norm`` come back as 0-d device tensors, ``lr`` as a float.

On a mesh (the rules installed: :func:`repro_torch.parallel.axes.
axis_rules`) the state's params and moments are this rank's blocks and
its step counters host ints on every rank; :func:`value_and_grad` syncs
the gradients over the batch axes
(:func:`~repro_torch.parallel.sharding.sync_grads`) and the optimizer
takes the global norm across the shards
(:func:`~repro_torch.parallel.sharding.norm_axes`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import torch

from repro_torch.models.api import ModelAPI
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.axes import current_fsdp, current_mesh, \
    current_rules
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.tree import leaves, unflatten


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: adamw.AdamWState
    step: torch.Tensor


def init_train_state(api: ModelAPI, key: torch.Generator) -> TrainState:
    """Params drawn from ``key`` on its device (f32 masters), zero
    moments."""
    params = api.init(key)
    return TrainState(params=params, opt=adamw.init(params),
                      step=torch.zeros((), dtype=torch.int32))


def value_and_grad(api: ModelAPI, params, batch, **kw):
    """(loss, grads): the loss of ``api.train_loss`` and its gradient in
    every leaf of ``params``, a tree of ``params``' structure."""
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = api.train_loss(params, batch, **kw)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
    finally:
        for t in flat:
            t.requires_grad_(False)
    # a leaf the loss does not reach gets zeros, as under jax.grad
    grads = unflatten(params, [torch.zeros_like(t) if g is None else g
                               for t, g in zip(flat, grads)])
    mesh = current_mesh()
    if mesh is not None:
        grads = sh.sync_grads(grads, mesh, current_rules(), current_fsdp(),
                              api.cfg.moe_ep_data)
    return loss.detach(), grads


def make_train_step(api: ModelAPI, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total: int = 10_000,
                    clip: float = 1.0) -> Callable:
    lr_fn = partial(warmup_cosine, peak_lr=peak_lr, warmup=warmup,
                    total=total)

    def train_step(state: TrainState, batch):
        loss, grads = value_and_grad(api, state.params, batch)
        lr = lr_fn(int(state.step))
        mesh = current_mesh()
        axes = sh.norm_axes(state.params, mesh, current_fsdp(),
                            api.cfg.moe_ep_data) if mesh is not None else None
        new_params, new_opt, gnorm = adamw.update(
            state.params, grads, state.opt, lr=lr, clip=clip,
            norm_axes=axes)
        del grads
        new_state = TrainState(params=new_params, opt=new_opt,
                               step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def make_serve_step(api: ModelAPI) -> Callable:
    def serve_step(params, caches, token, cur_pos):
        return api.decode_step(params, caches, token, cur_pos)
    return serve_step


def make_prefill_step(api: ModelAPI, max_seq: int | None = None) -> Callable:
    def prefill_step(params, batch):
        return api.prefill(params, batch, max_seq=max_seq)
    return prefill_step
