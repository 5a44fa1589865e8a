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


def _tensor(a) -> torch.Tensor:
    """One numpy leaf as a tensor of its own type; a bfloat16 leaf
    (numpy's extension type, which ``torch.from_numpy`` does not take)
    through its 16-bit pattern."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """``{"convs": [{"w": ndarray, "b": ndarray?}], "head": ndarray}``
    -> the same dict of tensors on ``device``, each of its leaf's type
    (float32 or bfloat16, as the reference's params are)."""
    dev = resolve_device(device)

    def t(a) -> torch.Tensor:
        return _tensor(a).to(device=dev)

    return {"convs": [{k: t(v) for k, v in conv.items()}
                      for conv in tree["convs"]],
            "head": t(tree["head"])}


def params_to_numpy(tree: dict) -> dict:
    """The port's ``{"convs": [{"w", "b"?}], "head"}`` tensors -> the
    same dict of numpy arrays (detached, on the host); a bfloat16 leaf
    comes back widened, exactly, to float32."""

    def a(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return {"convs": [{k: a(v) for k, v in conv.items()}
                      for conv in tree["convs"]],
            "head": a(tree["head"])}
