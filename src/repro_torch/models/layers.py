"""The attention oracle of the LM substrate — the port's copy of
``attention_naive`` and ``_gqa_scores_scale`` from
``repro/models/layers.py:172-202``, which
:func:`~repro_torch.kernels.attention_block.ref.attention_ref` needs.
Nothing else of the LM substrate is ported yet."""

from __future__ import annotations

import math

import torch


def _gqa_scores_scale(head_dim: int) -> float:
    return 1.0 / math.sqrt(head_dim)


def attention_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor,
                    window: int = 0) -> torch.Tensor:
    """Reference O(S^2) causal (optionally sliding-window) attention.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); positions are absolute.
    A row with no unmasked key is NaN (it is masked with ``-inf``)."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) * _gqa_scores_scale(hd)
    mask = kv_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= kv_pos[None, :] > (q_pos[:, None] - window)
    scores = scores.masked_fill(~mask[None, None, None], -math.inf)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.to(torch.float32))
    return out.reshape(b, sq, h, hd).to(q.dtype)
