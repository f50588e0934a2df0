"""Mamba2-780m: attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=12,          # unused (attention-free)
    num_kv_heads=12,
    d_ff=0,                # no MLP: block = norm + SSD mixer
    vocab_size=50280,
    ssm_state=128,
    ssm_groups=1,
    ssm_expand=2,
    ssm_head_dim=64,
).validate()
