"""AdamW with global-norm clipping — the port's copy of
``repro/optim/adamw.py``.

Moment dtype follows the parameter dtype (bf16 params => bf16 moments).
The update is the reference's formula, term for term, in f32:

  * clip scale ``min(1, max_norm / max(norm, 1e-9))`` on the global norm;
  * ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``;
  * bias corrections ``1 - b^step``;
  * decoupled weight decay inside the step:
    ``p -= lr (mhat / (sqrt(vhat) + eps) + wd p)``.

``torch.optim.AdamW`` decays in another order (``p *= 1 - lr wd`` before
the Adam step), so it is not used.  The reference's update is
functional and donates its inputs; :func:`update` writes the new
params and moments into the tensors that held the old ones, leaf by
leaf and in slices of at most :data:`SLICE` elements, so a step needs
no second copy of the state (a 3.4e9-parameter model's f32 params,
grads and moments are 55 GB).  Trees are those of
:mod:`repro_torch.tree`; ``step`` is a 0-d int32 tensor on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.parallel import collectives as col
from repro_torch.tree import leaves, tree_map

#: elements of one slice of a leaf's update: its f32 temporaries stay
#: a few hundred MB whatever the leaf's size
SLICE = 1 << 26


@dataclasses.dataclass
class AdamWState:
    m: Any
    v: Any
    step: torch.Tensor


def init(params) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p)  # noqa: E731
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      step=torch.zeros((), dtype=torch.int32))


def global_norm(tree, axes=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares,
    the leaves added in flattening order (as the reference's Python
    ``sum``); a 0-d f32 tensor on the leaves' device.  On a mesh
    ``axes`` gives, leaf by leaf, the axes this rank's block of the leaf
    is sharded over (:func:`~repro_torch.parallel.sharding.norm_axes`):
    the block's sum of squares is summed over them, and a leaf
    replicated over an axis is counted once."""
    total = None
    for i, x in enumerate(leaves(tree)):
        x32 = x.detach().reshape(-1).to(torch.float32)
        sq = torch.dot(x32, x32)
        if axes is not None and axes[i]:
            sq = col.psum(sq, axes[i])
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


def _slices(t: torch.Tensor) -> list[torch.Tensor]:
    """Views of ``t``'s slices (``t`` contiguous: the update writes
    through them)."""
    flat = t.view(-1)
    return [flat[i:i + SLICE] for i in range(0, flat.numel(), SLICE)]


@torch.no_grad()
def _update_leaf(p, g, m, v, scale, *, lr, b1, b2, eps, wd, b1c, b2c):
    for ps, gs, ms, vs in zip(*map(_slices, (p, g, m, v))):
        g32 = gs.to(torch.float32)
        if scale is not None:
            g32 = (g32 * scale).to(gs.dtype).to(torch.float32)
        m32 = ms.to(torch.float32) * b1 + g32 * (1 - b1)
        v32 = vs.to(torch.float32) * b2 + torch.square(g32) * (1 - b2)
        mhat = m32 / b1c
        vhat = v32 / b2c
        p32 = ps.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + eps) + wd * p32
        ps.copy_(p32 - lr * delta)
        ms.copy_(m32)
        vs.copy_(v32)


def update(params, grads, state: AdamWState, *, lr, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, wd: float = 0.1,
           clip: float = 1.0, norm_axes=None):
    """Returns (params, new_state, grad_norm): ``params`` and the
    moments updated in place, ``grad_norm`` the global norm before
    clipping (a 0-d device tensor).  ``lr`` is a Python float (the f32
    value of a schedule).  On a mesh ``params``, ``grads`` and the
    moments are this rank's blocks and ``norm_axes`` their shard axes
    (:func:`global_norm`); every elementwise term is the reference's."""
    with torch.profiler.record_function("adamw.update"):
        gnorm = global_norm(grads, norm_axes)
        scale = _clip_scale(gnorm, clip) if clip else None
        step = int(state.step) + 1
        # the bias corrections in f32, as the reference computes them
        b1c = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
        b2c = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.m), leaves(state.v)):
            # a gradient may come back as a transposed view
            g = g.contiguous()
            _update_leaf(p, g, m, v, scale, lr=lr, b1=b1, b2=b2, eps=eps,
                         wd=wd, b1c=b1c, b2c=b2c)
    return params, AdamWState(m=state.m, v=state.v,
                              step=torch.tensor(step, dtype=torch.int32)
                              ), gnorm
