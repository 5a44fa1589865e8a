"""granite-34b [dense]: 88L d_model=6144 48H (GQA kv=1 = MQA)
d_ff=24576 vocab=49152 — llama-arch, code [arXiv:2405.04324].

The port's copy of ``repro/configs/granite_34b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, head_dim=128)
