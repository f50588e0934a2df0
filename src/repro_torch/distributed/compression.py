"""Gradient compression codec: the port of the JAX package's
`repro/distributed/compression.py` (`ef_compress` / `ef_decompress`).

int8 quantization with a per-tensor scale and an error-feedback residual
(the standard EF-SGD trick that keeps convergence unbiased over time).
Elementwise, and `torch.round` rounds half to even as `jnp.round` does, so
the codes and residuals are the reference's bit for bit.  The divisions
are between tensors on one device: a CUDA division by a host scalar
multiplies by its reciprocal instead.  `compressed_psum` and
`hierarchical_grad_sync` (collectives) are not ported yet.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def ef_compress(g, residual):
    """(g + residual) -> int8 code + scale, new residual."""
    target = g.to(F32) + residual
    amax = torch.max(torch.abs(target))
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    code = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    decoded = code.to(F32) * scale
    return code, scale, target - decoded


def ef_decompress(code, scale):
    return code.to(F32) * scale
