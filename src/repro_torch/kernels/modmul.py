"""Element-wise modular multiply on the H100: the port of `repro/kernels/modmul.py`.

`modmul_cuda` launches B3 `modmul` (`csrc/modmul.cu`) on a CUDA tensor and
runs its plain torch version, the int64 twin of the same Montgomery round
trip, on a CPU tensor.  The reference's `block` is a TPU grid size and its
padding a TPU grid artifact; the CUDA kernel takes any length.
"""
from __future__ import annotations

import torch

from repro_torch.core import modmath as mm
from repro_torch.core.ntt import NttContext
from repro_torch.kernels import _build

#: Kernel launches made by `modmul_cuda`; the plain version adds nothing.
LAUNCHES = {"modmul": 0}
#: Host seconds in `modmul_cuda`, entry to return, summed over its calls on
#: either device.
HOST_S = {"modmul_cuda": 0.0}


def modmul_plain(a: torch.Tensor, b: torch.Tensor, ctx: NttContext) -> torch.Tensor:
    """B3's plain version: REDC(REDC(a*b) * R^2) in int64, on any device."""
    prod = mm.mulmod_u32(mm.as_i64(a), mm.as_i64(b), ctx.q, ctx.qprime, ctx.r2_mod_q)
    return mm.to_u32(prod)


@_build.timed_span(HOST_S, "modmul_cuda", "repro_torch.kernels.modmul_cuda")
def modmul_cuda(a: torch.Tensor, b: torch.Tensor, ctx: NttContext) -> torch.Tensor:
    """Element-wise a*b mod q over any (..., n) uint32 shape, into a fresh
    tensor.  Each call adds its host seconds to `HOST_S` and runs inside the
    span `repro_torch.kernels.modmul_cuda`."""
    _build.check_u32("a", a)
    _build.check_u32("b", b, a.device)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    out = torch.empty_like(a)
    if a.is_cuda:
        if a.numel() == 0:
            return out
        lib = _build.load()
        with torch.cuda.device(a.device):
            err = lib.modmul_launch(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                ctx.q, ctx.qprime, ctx.r2_mod_q, _build.stream_handle(a.device),
            )
        _build.check(err, "modmul")
        LAUNCHES["modmul"] += 1
    elif a.device.type == "cpu":
        out.copy_(modmul_plain(a, b, ctx))
    else:
        raise ValueError(f"modmul runs on CUDA or CPU tensors, not {a.device}")
    return out
