"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16e top-2, Mamba+attention 1:7 interleave
[arXiv:2403.19887].  Optimizer states kept in bf16 (DESIGN.md §5) so a
single 256-chip pod fits the 398B-parameter training state.

The port's copy of ``repro/configs/jamba_15_large_398b.py``."""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536, head_dim=128,
    n_experts=16, top_k=2, moe_every=2, attn_every=8,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    param_dtype=torch.bfloat16)
