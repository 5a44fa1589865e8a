"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling; vision frontend STUBBED: input_specs
provides precomputed patch embeddings [hf:llava-hf/llava-v1.6].

The port's copy of ``repro/configs/llava_next_34b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128,
    frontend="vision_stub", frontend_len=2880)
