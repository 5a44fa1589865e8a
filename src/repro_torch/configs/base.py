"""Model/config schema shared by all assigned architectures — the port's
copy of ``repro/configs/base.py``.

A :class:`ModelConfig` fully determines the model function; an
:class:`InputShape` is one of the four assigned workload shapes.  The
types are torch's (``param_dtype=torch.float32``,
``compute_dtype=torch.bfloat16``).  The reference's ``input_specs``
(the dry-run's stand-ins) waits for the port's dry-run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1           # MoE FFN every Nth layer (jamba: 2)
    capacity_factor: float = 1.25
    moe_tpe: int = 0             # expert TP slices (0 = auto: tp//E)
    moe_ep_data: bool = False    # serving: experts over (model x data)
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    attn_every: int = 0          # hybrid: 1 attention layer per N (jamba: 8)
    # attention
    window: int = 0              # sliding-window size; 0 = full attention
    rope_theta: float = 1e4
    # frontends / enc-dec
    frontend: str = "none"       # none | audio_stub | vision_stub
    frontend_len: int = 0        # #prefix embeddings provided by the stub
    enc_layers: int = 0          # >0 => encoder-decoder
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    # numerics
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    kv_cache_dtype: Any = None   # None -> compute_dtype
    remat: bool = True
    remat_policy: str = "nothing"   # nothing | dots (save matmul outputs)
    pad_heads: bool = True       # pad (q, kv) heads to the TP degree
    attn_chunk: int = 1024       # kv chunk of the plain online softmax

    # ------------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts?"""
        return self.family in ("ssm", "hybrid") or self.window > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def padded_heads(self, tp: int) -> tuple[int, int]:
        """Pad (n_heads, n_kv_heads) to shard over ``tp`` model shards,
        preserving an integer GQA group size: both counts become
        multiples of tp (MQA kv=1 is replicated up to tp)."""
        if self.n_heads == 0:
            return 0, 0
        if not self.pad_heads:
            return self.n_heads, self.n_kv_heads
        nh = _round_up(self.n_heads, tp)
        nkv = _round_up(self.n_kv_heads, tp)
        while nh % nkv:               # integer GQA group size
            nkv += tp
        return nh, nkv

    def padded_vocab(self, tp: int) -> int:
        return _round_up(self.vocab, 256 * tp // math.gcd(256, tp))

    def param_count(self) -> int:
        """Analytic parameter count (unpadded, embeddings included)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        ffn_dense = 3 * d * f
        per_layer = []
        for i in range(self.n_layers):
            p = 2 * d  # norms
            if self.family == "ssm" or (
                    self.family == "hybrid"
                    and self.attn_every and i % self.attn_every != 0):
                di = self.d_inner
                p += d * (2 * di + 2 * self.ssm_state) \
                    + di * self.ssm_conv + di // self.ssm_head_dim \
                    + di * d + di
            else:
                p += attn
            if self.family in ("moe", "hybrid") and self.n_experts \
                    and (i % self.moe_every == 0):
                p += self.n_experts * ffn_dense + d * self.n_experts
            elif self.family != "ssm":
                p += ffn_dense
            per_layer.append(p)
        total = sum(per_layer) + v * d + d
        if self.enc_layers:
            total += self.enc_layers * (2 * d + attn + ffn_dense) \
                + self.n_layers * (d + attn)   # cross-attention
        if not self.tie_embeddings:
            total += v * d
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        n_moe = sum(1 for i in range(self.n_layers)
                    if i % self.moe_every == 0)
        ffn_dense = 3 * self.d_model * self.d_ff
        inactive = n_moe * (self.n_experts - self.top_k) * ffn_dense
        return full - inactive


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """The assigned shape cells for an arch."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test configuration of the same family (small everything)."""
    base = dict(
        n_layers=min(cfg.n_layers, 2 if not cfg.attn_every
                     else cfg.attn_every),
        d_model=64,
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        head_dim=16,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        ssm_state=min(cfg.ssm_state, 16),
        ssm_head_dim=16 if cfg.ssm_state else cfg.ssm_head_dim,
        window=min(cfg.window, 64) if cfg.window else 0,
        enc_layers=min(cfg.enc_layers, 2),
        frontend_len=min(cfg.frontend_len, 8),
        attn_chunk=32,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
