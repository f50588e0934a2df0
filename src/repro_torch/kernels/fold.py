"""Strict left fold of float64 increments on the H100: the fastpath's bus chain.

`left_fold(inc, b0)` returns ``[b0, b0 + inc[0], (b0 + inc[0]) + inc[1], ...]``,
every value the running sum with its adds in order, bit-identical to
`np.cumsum` over ``[b0, *inc]``.  On a CUDA tensor it launches
`chain_fold` (`csrc/fold.cu`, one thread walking the chain); on a CPU
tensor it runs the plain version, `torch.cumsum`, which on the CPU is a
strict left fold too.  `torch.cumsum` on CUDA is a parallel scan that
reassociates the adds, so it is never taken for a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: Kernel launches made by `left_fold`; the plain version adds nothing.
LAUNCHES = {"chain_fold": 0}


def _check(inc) -> None:
    if not isinstance(inc, torch.Tensor):
        raise TypeError(f"inc must be a torch.Tensor, got {type(inc).__name__}")
    if inc.dtype != torch.float64 or inc.dim() != 1:
        raise TypeError(f"inc must be a 1-d float64 tensor, got {inc.dim()}-d {inc.dtype}")
    if not inc.is_contiguous():
        raise ValueError("inc must be contiguous")


def left_fold_plain(inc: torch.Tensor, b0: float) -> torch.Tensor:
    """`chain_fold`'s plain version: `torch.cumsum` over ``[b0, *inc]`` on
    the CPU, where it adds in order (a float64 accumulator, one add per
    element)."""
    _check(inc)
    if inc.device.type != "cpu":
        raise ValueError(f"the plain left fold runs on the CPU only, not {inc.device}")
    out = torch.cumsum(torch.cat([inc.new_tensor([b0]), inc]), 0)
    out[0] = b0
    return out


def left_fold(inc: torch.Tensor, b0: float) -> torch.Tensor:
    """``[b0, *running sums]`` of float64 `inc`, adds in order, on `inc`'s device."""
    _check(inc)
    if inc.is_cuda:
        out = torch.empty(inc.numel() + 1, dtype=torch.float64, device=inc.device)
        lib = _build.load()
        with torch.cuda.device(inc.device):
            err = lib.chain_fold_launch(inc.data_ptr(), out.data_ptr(), inc.numel(), float(b0),
                                        _build.stream_handle(inc.device))
        _build.check(err, "chain_fold")
        LAUNCHES["chain_fold"] += 1
        return out
    if inc.device.type == "cpu":
        return left_fold_plain(inc, b0)
    raise ValueError(f"chain_fold runs on CUDA or CPU tensors, not {inc.device}")
