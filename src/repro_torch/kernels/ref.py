"""Plain torch oracles for every kernel of this package.

The port of `repro/kernels/ref.py`: the same functions over the torch stage
loop of `repro_torch.core.ntt` (int64 twins of the kernels' uint32
arithmetic).  They take numpy arrays or uint32 tensors and compute on the
tensor's device (numpy input on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import modmath as mm
from repro_torch.core import ntt as ntt_core
from repro_torch.core.ntt import NttContext, make_context  # noqa: F401  (re-export)


def _as_u32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32))


def ntt_forward_ref(x, ctx: NttContext) -> torch.Tensor:
    """Negacyclic forward NTT over the last axis (natural in, brv out)."""
    return ntt_core.ntt_forward_torch(_as_u32(x), ctx)


def ntt_inverse_ref(x, ctx: NttContext) -> torch.Tensor:
    """Negacyclic inverse NTT over the last axis (brv in, natural out)."""
    return ntt_core.ntt_inverse_torch(_as_u32(x), ctx)


def modmul_ref(a, b, ctx: NttContext) -> torch.Tensor:
    """Element-wise a*b mod q."""
    prod = mm.mulmod_u32(mm.as_i64(_as_u32(a)), mm.as_i64(_as_u32(b)), ctx.q, ctx.qprime, ctx.r2_mod_q)
    return mm.to_u32(prod)


def polymul_ref(a, b, ctx: NttContext) -> torch.Tensor:
    """Negacyclic polynomial product over the last axis (eq. 1)."""
    return ntt_core.polymul_negacyclic_torch(_as_u32(a), _as_u32(b), ctx)


def ntt_conv_ref(u, kern, ctx: NttContext) -> torch.Tensor:
    """Negacyclic convolution of integer sequences (u, kern in [0, q))."""
    return polymul_ref(u, kern, ctx)
