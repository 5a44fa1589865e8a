"""The attention oracle and the plain version of the attention kernel.

:func:`attention_ref` is the port's copy of
``repro/kernels/attention_block/ref.py``: the naive O(S^2) attention of
:mod:`repro_torch.models.layers`, for the tests.  :func:`attention_plain`
is the kernel's plain version: the kernel wrapper runs it for CPU
tensors, and the tests and the chip smoke hold the kernel against it on
the card; it never runs for a CUDA tensor on any entry point.
:func:`attention_plain_panel` is the same for a panel of query rows,
over only the keys its masks leave: the yardstick at lengths where the
whole plain version's scores do not fit a card."""

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


def key_span(row0: int, rows: int, skv: int, window: int,
             causal: bool) -> tuple[int, int]:
    """The keys ``[lo, hi)`` that query rows ``row0 .. row0 + rows`` may
    keep: none past the last row under the causal mask, none at or
    before ``row0 - window`` under a window (``hi <= lo``: none)."""
    lo = max(0, row0 - window + 1) if window else 0
    hi = min(skv, row0 + rows) if causal else skv
    return lo, hi


def attention_plain_panel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, row0: int, groups: int, window: int = 0,
                          causal: bool = True, return_lse: bool = False):
    """Rows ``row0 .. row0 + P`` of :func:`attention_plain`: q (B*H, P,
    hd) holds those query rows; k, v (B*KV, Skv, hd) every key.  The
    scores cover only the keys of :func:`key_span`, so the cost is P
    times that span, whatever Sq is.  A row that keeps no key gets
    :func:`attention_plain`'s mean of V over all Skv keys (and ``lse``
    ``-inf``), as the finite -1e30 mask gives it there."""
    p, hd = q.shape[1], q.shape[2]
    skv = k.shape[1]
    lo, hi = key_span(row0, p, skv, window, causal)
    hi = max(lo, hi)
    kx = k[:, lo:hi].to(torch.float32).repeat_interleave(groups, dim=0)
    vx = v[:, lo:hi].to(torch.float32).repeat_interleave(groups, dim=0)
    s = torch.bmm(q.to(torch.float32), kx.transpose(1, 2)) * (1.0 / hd ** 0.5)
    q_pos = torch.arange(row0, row0 + p, device=q.device)[:, None]
    k_pos = torch.arange(lo, hi, device=q.device)[None, :]
    mask = torch.ones((p, hi - lo), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    out = torch.bmm(torch.softmax(s.masked_fill(~mask, -1e30), dim=-1), vx)
    empty = ~mask.any(dim=-1)
    if bool(empty.any()):
        mean = v.to(torch.float32).mean(dim=1, keepdim=True)
        out[:, empty] = mean.repeat_interleave(groups, dim=0)
    out = out.to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(s.masked_fill(~mask, -torch.inf), dim=-1)
