"""The attention oracle and the plain version of the attention kernel.

:func:`attention_ref` is the port's copy of
``repro/kernels/attention_block/ref.py``: the naive O(S^2) attention of
:mod:`repro_torch.models.layers`, for the tests.  :func:`attention_plain`
is the kernel's plain version: the kernel wrapper runs it for CPU
tensors, and the tests and the chip smoke hold the kernel against it on
the card; it never runs for a CUDA tensor on any entry point."""

from __future__ import annotations

import torch

from repro_torch.models.layers import attention_naive


def attention_ref(q, k, v, *, window: int = 0, causal: bool = True):
    sq, skv = q.shape[1], k.shape[1]
    q_pos = torch.arange(sq, device=q.device)
    if not causal:
        q_pos = torch.full((sq,), torch.iinfo(torch.int32).max,
                           device=q.device)
    return attention_naive(q, k, v, q_pos, torch.arange(skv, device=q.device),
                           window)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    groups: int, window: int = 0, causal: bool = True,
                    return_lse: bool = False):
    """The plain version of the attention kernel, in its layout: q
    (B*H, Sq, hd); k, v (B*KV, Skv, hd) -> (B*H, Sq, hd), query head
    ``bh`` reading kv head ``bh // groups``.

    The counterpart of the reference's ``_lax_attention``
    (``attention_block/ops.py:15``), not of :func:`attention_ref`: a
    masked score is the finite -1e30, so a row with no unmasked key
    gets the mean of V over the Skv keys where the oracle gives NaN.
    Scores and softmax in f32, the output in ``q.dtype``.

    ``return_lse`` also returns each row's log-sum-exp over its unmasked
    keys' scaled scores, f32 (B*H, Sq), ``-inf`` for a row with none:
    the pair (out, lse), as the kernels give it."""
    sq, hd = q.shape[1], q.shape[2]
    skv = k.shape[1]
    kx = k.to(torch.float32).repeat_interleave(groups, dim=0)
    vx = v.to(torch.float32).repeat_interleave(groups, dim=0)
    s = torch.bmm(q.to(torch.float32), kx.transpose(1, 2)) * (1.0 / hd ** 0.5)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    out = torch.bmm(torch.softmax(s.masked_fill(~mask, -1e30), dim=-1),
                    vx).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(s.masked_fill(~mask, -torch.inf), dim=-1)
