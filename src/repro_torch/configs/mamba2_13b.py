"""mamba2-1.3b [ssm]: 48L d_model=2048, attention-free, ssm_state=128 —
SSD (state-space duality) [arXiv:2405.21060].

The port's copy of ``repro/configs/mamba2_13b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, head_dim=0,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4)
