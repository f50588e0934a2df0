"""Jamba-1.5-Large (398B): hybrid Mamba+attention 1:7, MoE 16e top-2.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,          # MoE ffn on every 2nd layer (Jamba e=2)
    attn_every=8,         # 1 attention layer per 8 (1:7 with Mamba)
    attn_offset=4,
    ssm_state=16,         # Jamba Mamba d_state
    ssm_groups=8,
    ssm_expand=2,
    ssm_head_dim=64,
).validate()
