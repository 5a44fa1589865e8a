"""Deterministic synthetic LM data stream — the port's copy of
``repro/data/synthetic.py``.

Every batch is drawn from its own ``torch.Generator``, seeded from
``(seed, step)`` alone: no global RNG state, so any step's batch is the
same wherever and whenever it is drawn (a replay after a restart
consumes identical batches).  The stream has learnable structure, a
noisy Markov chain over the vocab: ``t' = (31 t + 7) mod V``, with a
fraction ``noise`` of the tokens drawn uniformly instead, so a small
model's training loss falls measurably.  The reference draws with JAX's
threefry, so the two streams are not equal token for token; parity
tests carry the reference's batches across.  Batches are built on the
host: (B, S) int64 ``tokens`` and ``labels`` (the next tokens).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_order: int = 1
    noise: float = 0.1


def _generator(seed: int, step: int) -> torch.Generator:
    """A generator for ``(seed, step)`` alone."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(2,
                                                                np.uint32)
    return torch.Generator().manual_seed(int(mixed[0]) << 31
                                         | int(mixed[1]) >> 1)


def global_batch_at(cfg: DataConfig, step: int) -> dict[str, torch.Tensor]:
    """The full (global_batch, seq_len) batch for one step."""
    gen = _generator(cfg.seed, step)
    b, s = cfg.global_batch, cfg.seq_len
    first = torch.randint(0, cfg.vocab, (b,), generator=gen)
    flip = torch.rand((s, b), generator=gen) < cfg.noise
    rand = torch.randint(0, cfg.vocab, (s, b), generator=gen)
    toks = [first]
    for i in range(s):
        nxt = (toks[-1] * 31 + 7) % cfg.vocab
        toks.append(torch.where(flip[i], rand[i], nxt))
    seq = torch.stack(toks, dim=1)              # (B, S+1)
    return {"tokens": seq[:, :-1].contiguous(),
            "labels": seq[:, 1:].contiguous()}


def shard_batch_at(cfg: DataConfig, step: int, shard: int,
                   n_shards: int) -> dict[str, torch.Tensor]:
    """Only this data shard's rows (what a per-host loader feeds)."""
    full = global_batch_at(cfg, step)
    per = cfg.global_batch // n_shards
    sl = slice(shard * per, (shard + 1) * per)
    return {k: v[sl] for k, v in full.items()}
