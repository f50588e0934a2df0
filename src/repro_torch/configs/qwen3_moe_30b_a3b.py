"""Qwen3-30B-A3B: 128-expert top-8 MoE, GQA kv=4, qk-norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,             # expert hidden size (all layers MoE)
    moe_d_ff=768,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    qk_norm=True,
).validate()
