"""Error-feedback int8 gradient compression (1-bit-Adam-family trick) —
the port's copy of ``repro/optim/compression.py``.

For a cross-replica gradient all-reduce the wire format is int8 with a
per-tensor f32 scale; the quantization residual is fed back into the
next step's gradient (error feedback keeps SGD/Adam convergence).
Trees are those of :mod:`repro_torch.tree`.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """g -> (int8 payload, f32 scale)."""
    g32 = g.to(torch.float32)
    amax = g32.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def init_error(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def compress_grads(grads, error):
    """Returns (payload tree of (int8, scale) pairs, new error feedback)."""
    corrected = tree_map(lambda g, e: g.to(torch.float32) + e, grads, error)
    payload = tree_map(quantize, corrected)
    new_err = tree_map(lambda c, qs: c - dequantize(*qs, torch.float32),
                       corrected, payload)
    return payload, new_err


def decompress_grads(payload, dtype_tree):
    """The payload's (int8, scale) pairs back to tensors of the types of
    ``dtype_tree``'s leaves."""
    return tree_map(lambda ref, qs: dequantize(qs[0], qs[1], ref.dtype),
                    dtype_tree, payload)


def roundtrip(grads, error):
    """Compress + decompress (what each replica applies before the
    cross-replica reduce); used by tests."""
    payload, new_err = compress_grads(grads, error)
    return decompress_grads(payload, grads), new_err
