"""whisper-medium [audio enc-dec]: 24L enc + 24L dec, d_model=1024 16H
(MHA kv=16) d_ff=4096 vocab=51865 — conv frontend STUBBED: input_specs
provides precomputed frame embeddings [arXiv:2212.04356].

The port's copy of ``repro/configs/whisper_medium.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, head_dim=64, frontend="audio_stub")
