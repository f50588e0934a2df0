"""Architecture registry: --arch <id> resolution + per-cell applicability."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "mamba2-780m": "mamba2_780m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen3-4b": "qwen3_4b",
    "command-r-35b": "command_r_35b",
    "qwen3-8b": "qwen3_8b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "whisper-small": "whisper_small",
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def cell_status(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """'run' or a documented skip reason (DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return "skip: full-attention arch, 500k decode is quadratic (per spec)"
    return "run"


def effective_shape(cfg: ModelConfig, shape: ShapeConfig) -> ShapeConfig:
    """Per-arch shape clamps (whisper's 448-token decoder limit)."""
    if cfg.max_target_len and shape.seq_len > cfg.max_target_len:
        return ShapeConfig(shape.name, cfg.max_target_len, shape.global_batch, shape.kind)
    return shape


def all_cells():
    for name in ARCH_NAMES:
        cfg = get_config(name)
        for shape in SHAPES.values():
            yield cfg, shape, cell_status(cfg, shape)
