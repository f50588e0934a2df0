"""Kimi K2 (1T total / 32B active): 384-expert top-8 MoE (paper-table).
[arXiv:2501.kimi2; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,         # 7168 / 64
    d_ff=2048,            # expert hidden size
    moe_d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    # 1.03T params on a single 256-chip pod: fp32 weights alone are 16.1
    # GB/chip — bf16 weights (+ Adafactor factored state, see dryrun
    # OPT_POLICY) keep train/serve under the v5e 16 GB budget.
    param_dtype="bfloat16",
).validate()
