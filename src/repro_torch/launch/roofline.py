"""Analytic model size and work: the port of `count_params` and
`model_flops` from the JAX package's `repro/launch/roofline.py` (plain
arithmetic over the config, equal with `==`).  The reference's TPU
constants and its dry-run roofline over compiled modules are not ported.
"""
from __future__ import annotations


def count_params(cfg) -> tuple[int, int]:
    """(total, active) parameter counts from the config, analytically."""
    d = cfg.d_model
    total = 0
    active = 0
    pattern = cfg.pattern()
    per_pattern = cfg.reps
    for mixer, ffn in pattern:
        t = a = 0
        if mixer in ("attn", "attn_nc", "cross", "attn_cross"):
            attn = d * cfg.num_heads * cfg.hd * 2 + d * cfg.num_kv_heads * cfg.hd * 2
            t += attn * (2 if mixer == "attn_cross" else 1)
            a += attn * (2 if mixer == "attn_cross" else 1)
        if mixer == "mamba":
            g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
            di = cfg.d_inner
            m = d * (2 * di + 2 * g * n + h) + di * d + 4 * (di + 2 * g * n) + di
            t += m
            a += m
        if ffn == "mlp":
            t += 3 * d * cfg.d_ff
            a += 3 * d * cfg.d_ff
        elif ffn == "moe":
            f = cfg.moe_d_ff or cfg.d_ff
            t += 3 * d * f * cfg.num_experts + d * cfg.num_experts
            a += 3 * d * f * cfg.experts_per_token + d * cfg.num_experts
        total += t * per_pattern
        active += a * per_pattern
    if cfg.encoder_layers:
        enc = cfg.encoder_layers * (d * cfg.num_heads * cfg.hd * 4 + 3 * d * cfg.d_ff)
        total += enc
        active += enc
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return total + emb, active + emb


def model_flops(cfg, shape) -> float:
    """6·N_active·tokens (train) or 2·N_active·tokens (inference)."""
    _, active = count_params(cfg)
    if cfg.max_target_len:
        seq = min(shape.seq_len, cfg.max_target_len)
    else:
        seq = shape.seq_len
    if shape.kind == "train":
        tokens = shape.global_batch * seq
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * seq
        return 2.0 * active * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * active * tokens
