"""Model configuration schema + repeating layer patterns.

Every architecture is expressed as a repeating *pattern* of blocks
(mixer, ffn).  The model scans over pattern repetitions with stacked
parameters, so the compiled graph contains ONE pattern body regardless
of depth — essential for compiling 61-72 layer trillion-parameter
configs on the CPU dry-run host, and the standard production trick for
fast compiles.

Block mixers:  attn | attn_nc (non-causal) | cross | attn_cross | mamba
Block ffns:    mlp | moe | none
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Mixer = Literal["attn", "attn_nc", "cross", "attn_cross", "mamba"]
Ffn = Literal["mlp", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qk_norm: bool = False
    use_bias: bool = False

    # -- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0          # expert hidden dim (0 -> d_ff)
    moe_every: int = 1         # MoE ffn every k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    moe_dispatch: str = "scatter"  # "scatter" (baseline) | "gather" (§Perf)

    # -- SSM / hybrid --------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 8
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_impl: str = "baseline"  # "grouped": §Perf group-factored einsums
    attn_every: int = 0        # hybrid: one attn layer per `attn_every` block
    attn_offset: int = 0       # position of the attn layer within the period

    # -- VLM / enc-dec --------------------------------------------------------
    cross_every: int = 0       # decoder: cross-attn mixer every k-th layer
    num_image_tokens: int = 0  # VLM frontend stub: precomputed patch embeds
    encoder_layers: int = 0    # enc-dec (whisper): encoder depth
    encoder_seq: int = 0       # precomputed frame embeddings (conv stub)
    max_target_len: int = 0    # enc-dec decoder length clamp

    # -- misc -----------------------------------------------------------------
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: bool = True
    scan_layers: bool = True  # False: unrolled (dry-run cost extrapolation)
    param_dtype: str = "float32"  # 1T-scale single-pod configs use bfloat16
    # sub-quadratic decode support (SSM/hybrid) — long_500k eligibility
    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # -- pattern -----------------------------------------------------------
    def pattern(self) -> list[tuple[Mixer, Ffn]]:
        """The repeating block pattern; num_layers % len(pattern) == 0."""
        if self.family == "audio":
            return [("attn_cross", "mlp")]  # decoder blocks (enc built apart)
        if self.family == "ssm":
            return [("mamba", "none")]
        blocks: list[tuple[Mixer, Ffn]] = []
        if self.attn_every:  # hybrid (jamba): 1 attn per period
            period = self.attn_every
            for i in range(period):
                mixer: Mixer = "attn" if i == self.attn_offset else "mamba"
                ffn: Ffn = "moe" if (self.num_experts and i % self.moe_every == self.moe_every - 1) else "mlp"
                blocks.append((mixer, ffn))
            return blocks
        if self.cross_every:  # vlm: cross-attn mixer every k-th layer
            for i in range(self.cross_every):
                mixer = "cross" if i == self.cross_every - 1 else "attn"
                blocks.append((mixer, "mlp"))
            return blocks
        ffn = "moe" if self.num_experts else "mlp"
        return [("attn", ffn)]

    @property
    def reps(self) -> int:
        p = len(self.pattern())
        assert self.num_layers % p == 0, (self.name, self.num_layers, p)
        return self.num_layers // p

    def validate(self):
        assert self.d_model % 128 == 0 or self.family == "audio", self.name
        _ = self.reps
        if self.num_experts:
            assert self.experts_per_token > 0
        return self

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            num_layers=len(self.pattern()) * 2,
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=128 if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_groups=min(self.ssm_groups, 2),
            ssm_chunk=16,
            num_image_tokens=8 if self.num_image_tokens else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=24 if self.encoder_seq else 0,
            max_target_len=32 if self.max_target_len else 0,
            name=self.name + "-smoke",
            remat=False,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# input shapes (assigned): every arch runs these four cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
