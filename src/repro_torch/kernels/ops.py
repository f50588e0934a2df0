"""Public API over the CUDA kernels: the port of `repro/kernels/ops.py`.

  ntt / intt           batched negacyclic NTT (forward: natural->brv,
                       inverse: brv->natural, 1/N folded in)
  polymul_ntt          a*b in Z_q[X]/(X^N+1), eq. (1) of the paper — no
                       bit-reversal anywhere (element-wise NTT domain)
  ntt_conv             integer negacyclic convolution (exact, O(N log N))
  ntt_conv_fixedpoint  float sequences via fixed-point lift, exact
                       integer convolution, and un-lift

Where the work runs: a tensor stays on its own device; a numpy array goes
to `device`, by default the card (`torch.device("cuda")`).  On the card the
entry points launch the CUDA kernels; on the CPU (a CPU tensor, or
`device="cpu"`) they run the kernels' plain versions.  Asked for the card
where there is none, they raise.  Results are tensors on that device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import modmath as mm
from repro_torch.core.ntt import NttContext, make_context  # noqa: F401  (re-export)
from repro_torch.device import resolve
from repro_torch.kernels.modmul import modmul_cuda
from repro_torch.kernels.ntt import ntt_cuda


def _place(x, device=None, dtype=np.uint32) -> torch.Tensor:
    """`x` as a tensor on the device the call runs on.

    A tensor with no `device` given stays where it is; otherwise the
    target is `device`, by default the card.
    """
    if isinstance(x, torch.Tensor) and device is None:
        return x
    target = resolve(device)
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:  # moved through the int32 view every device copies
            return x.view(torch.int32).to(target).view(torch.uint32)
        return x.to(target)
    if dtype == np.uint32:
        return mm.to_device_u32(x, target)
    return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(target)


def ntt(x, ctx: NttContext, tile: int | None = None, device=None) -> torch.Tensor:
    """Forward negacyclic NTT over the last axis (natural in, brv out)."""
    return ntt_cuda(_place(x, device), ctx, forward=True, tile=tile)


def intt(x, ctx: NttContext, tile: int | None = None, device=None) -> torch.Tensor:
    """Inverse negacyclic NTT over the last axis (brv in, natural out, /N)."""
    return ntt_cuda(_place(x, device), ctx, forward=False, tile=tile)


def polymul_ntt(a, b, ctx: NttContext, tile: int | None = None, device=None) -> torch.Tensor:
    """a*b mod (X^N + 1): NTT -> element-wise modmul -> INTT.

    `b` is placed beside `a` unless `device` is given.
    """
    a = _place(a, device)
    b = _place(b, a.device if device is None else device)
    ah = ntt_cuda(a, ctx, forward=True, tile=tile)
    bh = ntt_cuda(b, ctx, forward=True, tile=tile)
    return ntt_cuda(modmul_cuda(ah, bh, ctx), ctx, forward=False, tile=tile)


def ntt_conv(u, k, ctx: NttContext, tile: int | None = None, device=None) -> torch.Tensor:
    """Exact negacyclic convolution of uint32 sequences in [0, q)."""
    return polymul_ntt(u, k, ctx, tile=tile, device=device)


def ntt_conv_fixedpoint(
    u, k, ctx: NttContext, frac_bits: int = 10, tile: int | None = None, device=None
) -> torch.Tensor:
    """Negacyclic convolution of float sequences via fixed-point lift.

    Values are scaled by 2^frac_bits, rounded (half to even, as
    `jnp.round`), lifted to [0, q) (negatives as q - |x|), convolved
    exactly over Z_q, and mapped back assuming the true result magnitude
    < q / 2^(2*frac_bits + 1).  Every step is the reference's float32 or
    integer step, so the result equals `repro.kernels.ops`'s bit for bit.
    """
    q = ctx.q
    scale = float(1 << frac_bits)
    u = _place(u, device, np.float32)
    k = _place(k, u.device if device is None else device, np.float32)

    def lift(x):
        xi = torch.round(x * scale).to(torch.int32).to(torch.int64)
        return mm.to_u32(torch.where(xi < 0, q + xi, xi))

    ch = mm.as_i64(ntt_conv(lift(u), lift(k), ctx, tile=tile))
    chf = ch.to(torch.float32)
    # map back to signed: values > q/2 are negative
    signed = torch.where(ch > q // 2, chf - float(np.float32(q)), chf)
    return signed / (scale * scale)
