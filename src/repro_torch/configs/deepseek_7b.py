"""deepseek-7b [dense]: 30L d_model=4096 32H (MHA kv=32) d_ff=11008
vocab=102400 — llama-arch [arXiv:2401.02954].

The port's copy of ``repro/configs/deepseek_7b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=102400, head_dim=128)
