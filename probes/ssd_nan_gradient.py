"""Why the SSD scan masks its decay panel before the exponential.

mamba2-1.3b at full width, 2 layers, f32, one sequence of 128 tokens
at its initialisation (``dt_bias`` 0), on the CPU: the largest segment
sum above a chunk's diagonal, and ``value_and_grad``'s leaves that are
not finite with the port's ``_chunk_step`` and with the same step
written as the reference writes its decay panel,
``where(tri, exp(seg), 0)`` (``src/repro/models/ssm.py``), whose
gradient is ``exp(seg) * 0``, NaN once ``seg`` passes 88::

    PYTHONPATH=src python probes/ssd_nan_gradient.py
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import ssm
from repro_torch.models.api import build

PORT_STEP = ssm._chunk_step


def reference_form(state, xi, dti, dtai, bi, ci, tri, g, hg):
    """``_chunk_step`` with the decay panel as the reference forms it."""
    cs = torch.cumsum(dtai, dim=1)
    seg = cs[:, :, None, :] - cs[:, None, :, :]
    print("largest segment sum above the diagonal", seg.max().item())
    decay = torch.where(tri[None, :, :, None], torch.exp(seg), 0.0)
    real_exp = torch.exp
    try:    # the port's step, with its masked exponential replaced
        torch.exp = lambda t: decay if t.shape == seg.shape else real_exp(t)
        return PORT_STEP(state, xi, dti, dtai, bi, ci, tri, g, hg)
    finally:
        torch.exp = real_exp


def main() -> None:
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), n_layers=2,
                              compute_dtype=torch.float32)
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (1, 129),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for name, step in (("port", PORT_STEP), ("reference form",
                                             reference_form)):
        ssm._chunk_step = step
        _, grads = steps.value_and_grad(api, params, batch)
        bad = [p for p, t in tree.leaves_with_paths(grads)
               if not torch.isfinite(t).all()]
        print(f"{name}: {len(bad)} of {len(tree.leaves(grads))} gradient "
              f"leaves not finite {bad[:4]}")
    ssm._chunk_step = PORT_STEP


if __name__ == "__main__":
    main()
