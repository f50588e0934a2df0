"""Gradient compression for the cross-pod all-reduce: the port of the JAX
package's `repro/distributed/compression.py`.

  * `ef_compress / ef_decompress` — int8 quantization with a per-tensor
    scale and an error-feedback residual (the standard EF-SGD trick that
    keeps convergence unbiased over time);
  * `compressed_psum` — an all-reduce that quantizes to int8, sums in int32
    (exact) and dequantizes; wire bytes drop 4x vs fp32;
  * `hierarchical_grad_sync` — reduce in full precision over the intra-pod
    'data' axis first, then compressed over 'pod'.

Elementwise, and `torch.round` rounds half to even as `jnp.round` does, so
the codes and residuals are the reference's bit for bit.  The divisions
are between tensors on one device: a CUDA division by a host scalar
multiplies by its reciprocal instead.  The reference's named axes inside
`shard_map` become process groups (`DeviceMesh.get_group(name)`); the
collectives are `torch.distributed`'s functional ones, so a dispatch mode
(the dry-run's) sees them.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol

from repro_torch.tree import tree_map

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


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    return x / torch.tensor(float(n), dtype=x.dtype, device=x.device)


def compressed_psum(g, group):
    """int8-quantized sum of `g` over the ranks of `group` (the reference's
    psum over a named axis inside `shard_map`).

    The int32 accumulation is exact; quantization error is the only loss
    and is bounded by scale/2 per element.  Scales are max-combined across
    the ranks so all of them decode identically."""
    g32 = g.to(F32)
    amax = torch.max(torch.abs(g32))
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    scale = funcol.all_reduce(scale, "max", group)
    code = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    summed = funcol.all_reduce(code.to(torch.int32), "sum", group)
    return summed.to(F32) * scale


def hierarchical_grad_sync(grads, mesh, intra_axis: str = "data", inter_axis: str = "pod"):
    """Full-precision mean over `intra_axis`, then `compressed_psum` over
    `inter_axis` divided by its size, leaf by leaf (the reference's pmean,
    then compressed psum / npods)."""
    intra, inter = mesh.get_group(intra_axis), mesh.get_group(inter_axis)
    n_intra, npods = mesh.size(mesh.mesh_dim_names.index(intra_axis)), mesh.size(mesh.mesh_dim_names.index(inter_axis))

    def sync(g):
        g = _div(funcol.all_reduce(g, "sum", intra), n_intra)
        return _div(compressed_psum(g, inter), npods)

    return tree_map(sync, grads)
