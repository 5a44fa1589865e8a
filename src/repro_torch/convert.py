"""Parameters of the reference package as the port's tensors, and back.

The reference's CNN params are a ``{"convs": [{"w", "b"}], "head"}``
pytree; handed over as numpy arrays (``numpy.asarray`` of each leaf),
:func:`params_from_numpy` turns them into the port's dict of tensors,
and :func:`params_to_numpy` turns the port's params (or gradients of
the same shape) into numpy arrays leaf by leaf.
Layouts are kept — HWIO weights stay HWIO, the ``(Co,)`` bias and the
``(C, n_classes)`` head as they are — so both packages compute on
identical weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.exec_target import resolve_device


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """``{"convs": [{"w": ndarray, "b": ndarray?}], "head": ndarray}``
    -> the same dict of f32 tensors on ``device``."""
    dev = resolve_device(device)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(
            device=dev, dtype=torch.float32)

    return {"convs": [{k: t(v) for k, v in conv.items()}
                      for conv in tree["convs"]],
            "head": t(tree["head"])}


def params_to_numpy(tree: dict) -> dict:
    """The port's ``{"convs": [{"w", "b"?}], "head"}`` tensors -> the
    same dict of numpy arrays (detached, on the host)."""

    def a(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    return {"convs": [{k: a(v) for k, v in conv.items()}
                      for conv in tree["convs"]],
            "head": a(tree["head"])}
