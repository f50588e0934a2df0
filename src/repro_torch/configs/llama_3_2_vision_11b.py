"""Llama-3.2-Vision 11B: cross-attn image layers every 5th; the vision
frontend is a STUB (input_specs provides precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_every=5,          # 8 cross-attention layers of 40
    num_image_tokens=1601,  # precomputed patch embeddings (stub frontend)
).validate()
