"""Token embedding and decode-time logits — the port's copy of
``embed_tokens`` and ``lm_logits`` from ``repro/models/embedding.py``
at tp = 1 (the table whole on one device, no vocab sharding).
``lm_loss`` waits for the training slice."""

from __future__ import annotations

import torch


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> (B, S, d); table (V, d)."""
    return table[tokens]


def lm_logits(h: torch.Tensor, table: torch.Tensor,
              real_vocab: int) -> torch.Tensor:
    """Logits of the last position in f32: h (B, S, d) -> (B, V), the
    padded vocabulary (ids >= ``real_vocab``) masked to -1e30."""
    logits = h[:, -1].to(torch.float32) @ table.to(torch.float32).T
    v = table.shape[0]
    if v > real_vocab:
        logits[:, real_vocab:] = -1e30
    return logits
