"""Whisper-small: enc-dec; the conv frame frontend is a STUB
(input_specs provides precomputed frame embeddings).  Decode shapes are
clamped to the 448-token target limit — see DESIGN.md §4.
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,          # decoder depth
    encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    encoder_seq=1500,       # 30 s of audio at 50 Hz after the conv stub
    max_target_len=448,
).validate()
