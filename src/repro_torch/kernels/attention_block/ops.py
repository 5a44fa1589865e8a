"""Public entry point of the blocked attention — the port's copy of
``repro/kernels/attention_block/ops.py``.

:func:`flash_attention` takes and returns the reference's
``(B, S, H, hd)`` layout and runs the heads-first kernel layout through
:func:`~repro_torch.kernels.attention_block.kernel.attention`: on a
CUDA tensor the CUDA kernel (K4) its ``route`` names (bf16 on the
tensor cores, the rest on FMA), on a CPU tensor the plain version.
The semantics are those of the reference's ``lax`` target: a row with
no unmasked key gets the mean of V over the real keys, whatever the
block sizes (the reference's Pallas kernel agrees whenever ``Skv`` is a
multiple of its ``bk``).

Where an input requires a gradient (and grad mode is on),
:func:`flash_attention` runs through :class:`Attention`, an autograd
``Function`` on both devices: its forward is the same K4 launch (or, on
the CPU, the plain version) and saves q, k and v; its backward is
:func:`~repro_torch.kernels.attention_block.backward.attention_vjp`, the
exact VJP of the reference's ``_lax_attention`` in f32 by query panel.
The reference has no backward kernel (JAX differentiates its XLA
attention), and the port has none either.  K4's CUDA launch fills a
tensor through ``ctypes``, which autograd cannot see: without the
Function a loss on the card would silently get no attention gradient.

``flash_attention(..., return_lse=True)`` also returns each row's
log-sum-exp, f32 (B, H, Sq) (the kernel's, or the plain version's on
the CPU); :func:`combine_partials` merges attentions over disjoint
shards of the keys through it (the reference's flash-decoding combine,
``repro/models/layers.py:324-330``).  It runs no autograd.
"""

from __future__ import annotations

import torch

from repro_torch.core.exec_target import resolve_target
from repro_torch.kernels.attention_block import kernel
from repro_torch.kernels.attention_block.backward import attention_vjp


def heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> contiguous, 16-byte aligned (B*H, S, hd)."""
    b, s, h, hd = t.shape
    t = t.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, causal: bool = True,
                    bq: int = 128, bk: int = 128,
                    target=None, return_lse: bool = False):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) -> (B, Sq, H, hd).

    Causal keeps key k <= query q by absolute position from 0 on both
    sides; ``window`` keeps k > q - window (also without causal); the
    kv head of query head h is h // (H / KV).  ``bq`` and ``bk`` are the
    reference's query and key blocks, clamped as it clamps them; the
    result does not depend on them, and the CUDA kernel tiles for the
    card on its own.  ``target`` is ``kernel`` (the default) or
    ``account-only``, which cannot execute attention and raises.
    ``return_lse`` returns (out, lse (B, H, Sq) f32), and refuses inputs
    that require a gradient."""
    if target is not None and not resolve_target(target).compute:
        raise ValueError("account-only target cannot execute attention")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention needs q (B, Sq, H, hd) and k, v "
                         f"(B, Skv, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or kv < 1 or h % kv:
        raise ValueError(f"{h} query heads of dim {hd} do not group over "
                         f"k {tuple(k.shape)}")
    bq = min(bq, max(8, sq))
    bk = min(bk, max(8, skv))
    if bq < 1 or bk < 1:
        raise ValueError(f"blocks must be >= 1, got bq={bq}, bk={bk}")
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if return_lse:
        if grad:
            raise ValueError("return_lse runs no autograd: its inputs "
                             "must not require a gradient")
        return _forward(q, k, v, window=window, causal=causal,
                        return_lse=True)
    if grad:
        return Attention.apply(q, k, v, window, causal)
    return _forward(q, k, v, window=window, causal=causal)


def _forward(q, k, v, *, window: int, causal: bool,
             return_lse: bool = False):
    """K4 (the plain version on the CPU) in the reference's layout."""
    b, sq, h, hd = q.shape
    out = kernel.attention(heads_first(q), heads_first(k), heads_first(v),
                           groups=h // k.shape[2], window=window,
                           causal=causal, lse=return_lse)
    if return_lse:
        out, lse = out
        return (out.reshape(b, h, sq, hd).transpose(1, 2),
                lse.reshape(b, h, sq))
    return out.reshape(b, h, sq, hd).transpose(1, 2)


def combine_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Merge attentions over disjoint shards of one set of keys: ``outs``
    (S, ..., hd), each shard's normalized output, and ``lses`` (S, ...),
    its rows' log-sum-exp (``outs.shape[:-1]``) ->
    ``sum_s w_s out_s / sum_s w_s`` with ``w_s = exp(lse_s - max_s
    lse_s)``, in f32, then ``outs.dtype``.  A shard whose row kept no
    key (``lse`` -inf) adds nothing; a row no shard kept a key of is 0.
    """
    if lses.shape != outs.shape[:-1]:
        raise ValueError(f"lses {tuple(lses.shape)} do not match outs "
                         f"{tuple(outs.shape)} less the head dim")
    m = lses.amax(dim=0)
    w = torch.exp(lses - torch.where(torch.isfinite(m), m, 0.0))
    num = (w[..., None] * outs.to(torch.float32)).sum(dim=0)
    den = w.sum(dim=0)[..., None]
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                       0.0).to(outs.dtype)


class Attention(torch.autograd.Function):
    """:func:`flash_attention` under autograd: the K4 forward, the
    reference's VJP as the backward."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.causal = window, causal
        return _forward(q, k, v, window=window, causal=causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_vjp(q, k, v, dout, window=ctx.window,
                                   causal=ctx.causal)
        return dq, dk, dv, None, None
