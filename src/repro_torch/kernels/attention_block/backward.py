"""The backward of :class:`~repro_torch.kernels.attention_block.ops.Attention`
on both devices: the exact VJP of the reference's ``_lax_attention``
(``repro/kernels/attention_block/ops.py:15``), which JAX differentiates
as XLA ops, written as PyTorch ops in f32 by query panel.  K4 has no
backward kernel, nor does the reference."""

from __future__ import annotations

import math

import torch


#: f32 elements of one query panel's score tensor in the backward
#: (256 MB; the panel's P, dP and dS are as large)
PANEL_SCORES = 1 << 26


def panel_mask(q0: int, q1: int, lo: int, hi: int, *, window: int,
               causal: bool, device) -> torch.Tensor:
    """The kept (query, key) pairs of queries [q0, q1) and keys [lo, hi):
    key k <= query q under ``causal``, k > q - ``window`` under a
    window, positions counted from 0 on both sides."""
    q_pos = torch.arange(q0, q1, device=device)[:, None]
    k_pos = torch.arange(lo, hi, device=device)[None, :]
    mask = torch.ones((q1 - q0, hi - lo), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    return mask


def _key_range(q0: int, q1: int, skv: int, window: int,
               causal: bool) -> tuple[int, int]:
    """The keys any query of [q0, q1) keeps; all of them where the
    panel's last row keeps none (a row with no kept key attends to every
    key alike, so each takes part)."""
    lo = max(0, q0 - window + 1) if window else 0
    hi = min(skv, q1) if causal else skv
    last_lo = max(0, q1 - window) if window else 0
    last_hi = min(skv, q1) if causal else skv
    return (lo, hi) if last_lo < last_hi else (0, skv)


def attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dout: torch.Tensor, *, window: int = 0,
                  causal: bool = True) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of the reference's ``_lax_attention``
    (``repro/kernels/attention_block/ops.py:15``) at ``dout``, in f32,
    one query panel at a time (at most :data:`PANEL_SCORES` scores).

    q: (B, Sq, H, hd); k, v, dk, dv: (B, Skv, KV, hd); each gradient in
    its input's type.  Per panel: the scores ``S = scale q k^T`` and
    ``P = softmax(S)`` under the causal, window and key-length masks (a
    masked score is -1e30, so a row with no kept key has a uniform P),
    ``dP = dO v^T``, ``dS = P (dP - rowsum(P dP))`` (``rowsum(P dP)`` is
    ``rowsum(dO O)``), zero at the masked pairs (the reference's
    ``where`` passes them no gradient), then ``dq = scale dS k``,
    ``dk = scale dS^T q`` and ``dv = P^T dO``, dk and dv summed over each
    kv head's group of query heads."""
    with torch.profiler.record_function("attention_vjp"):
        b, sq, h, hd = q.shape
        skv, kv = k.shape[1], k.shape[2]
        g = h // kv
        scale = 1.0 / math.sqrt(hd)
        qf = q.to(torch.float32).reshape(b, sq, kv, g, hd)
        dof = dout.to(torch.float32).reshape(b, sq, kv, g, hd)
        kf = k.to(torch.float32)
        vf = v.to(torch.float32)
        dq = torch.empty_like(qf)
        dk = torch.zeros_like(kf)
        dv = torch.zeros_like(vf)
        rows = max(1, PANEL_SCORES // max(1, b * h * skv))
        rows = min(sq, rows // 64 * 64 if rows >= 64 else rows)
        for q0 in range(0, sq, rows):
            q1 = min(sq, q0 + rows)
            lo, hi = _key_range(q0, q1, skv, window, causal)
            mask = panel_mask(q0, q1, lo, hi, window=window, causal=causal,
                              device=q.device)
            qi, doi = qf[:, q0:q1], dof[:, q0:q1]
            ki, vi = kf[:, lo:hi], vf[:, lo:hi]
            s = torch.einsum("bqkgd,bskd->bkgqs", qi, ki) * scale
            p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
            dp = torch.einsum("bqkgd,bskd->bkgqs", doi, vi)
            ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
            ds = ds.masked_fill(~mask, 0.0)
            dq[:, q0:q1] = torch.einsum("bkgqs,bskd->bqkgd", ds, ki) * scale
            dk[:, lo:hi] += torch.einsum("bkgqs,bqkgd->bskd", ds, qi) * scale
            dv[:, lo:hi] += torch.einsum("bkgqs,bqkgd->bskd", p, doi)
        return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype))
