"""Parameters of the reference package as the port's tensors.

The reference's CNN params are a ``{"convs": [{"w", "b"}], "head"}``
pytree; handed over as numpy arrays (``numpy.asarray`` of each leaf),
:func:`params_from_numpy` turns them into the port's dict of tensors.
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
