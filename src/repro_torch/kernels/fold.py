"""The fastpath's bus chain on the H100: `chain_fold`, a strict left fold.

`chain_fold(b0, pn_blk, n, t_bus, device)` returns the chain
``[b0, s_1, B_1, s_2, B_2, ...]`` over K = len(pn_blk) rounds x n banks (per
bank ``s = B + pn_blk[k]``, then ``B = s + t_bus``): 1 + 2*K*n float64 values
as numpy, each with its adds in order, bit-identical to `np.cumsum` over the
interleaved increments (the evaluator's `_numpy_chain`).

On the card a chain is one round trip through two pinned host buffers kept per
card (the round times, the chain; grown on demand, never allocated per call):
the round times are written to the first, `chain_fold` (`csrc/fold.cu`) reads
them and writes the chain to the second itself (zero-copy: no copy in or out),
and one sync of the round trip's own stream ends it, all in one call into the
kernels' library; then a numpy copy, since the next chain reuses the buffer.
On the CPU it runs the plain version, `torch.cumsum` over the increments,
which adds in order there.  `torch.cumsum` on CUDA is a parallel scan that
reassociates the adds, so it is never taken for the card.  `chain_fold_cuda`
launches the kernel alone on tensors on the card.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels import _build

#: Kernel launches made by `chain_fold` and `chain_fold_cuda`; the plain version adds nothing.
LAUNCHES = {"chain_fold": 0}


def chain_fold_plain(b0: float, pn_blk, n: int, t_bus: float) -> torch.Tensor:
    """`chain_fold`'s plain version, on the CPU: the interleaved float64
    increments ``[b0, pn[0], t_bus, ...]`` (each round time once per bank),
    then `torch.cumsum`, which on the CPU adds them in order."""
    pn = torch.as_tensor(np.asarray(pn_blk, dtype=np.float64))
    inc = torch.empty(1 + 2 * pn.numel() * n, dtype=torch.float64)
    inc[0] = b0
    inc[1::2] = pn.repeat_interleave(n)
    inc[2::2] = t_bus
    return torch.cumsum(inc, 0)


class RoundTrip:
    """One card's pinned buffers for the chain's round trip, and a stream of
    its own that the chains run on, whatever stream the caller has made
    current (a chain reads and writes nothing but these buffers, and ends
    with a sync of that stream).  The kernel reads and writes the buffers in
    place, through the host pointers (unified addressing)."""

    def __init__(self, index: int):
        self.device = torch.device("cuda", index)
        self.stream = torch.cuda.Stream(self.device)
        self.handle = self.stream.cuda_stream
        self.lib = _build.load()
        self.lock = threading.Lock()  # the library call lets go of the GIL
        self.pn = self.out = None

    @staticmethod
    def _pinned(size: int, held):
        """(numpy view, pointer, tensor) of at least `size` pinned doubles:
        `held` if it is large enough, else twice its size."""
        if held is not None and held[0].size >= size:
            return held
        cap = max(size, 2 * (held[0].size if held is not None else 128))
        t = torch.empty(cap, dtype=torch.float64, pin_memory=True)
        return t.numpy(), t.data_ptr(), t

    def stage(self, pn_blk, n: int) -> int:
        """Grows the buffers for K = len(pn_blk) rounds x n banks and writes
        the round times; returns the chain's length."""
        k = len(pn_blk)
        length = 1 + 2 * k * n
        self.pn = self._pinned(k, self.pn)
        self.out = self._pinned(length, self.out)
        self.pn[0][:k] = pn_blk
        return length

    def run(self, b0: float, k: int, n: int, t_bus: float) -> None:
        """The launch and the sync of a chain of k rounds staged in the buffers."""
        err = self.lib.chain_fold_roundtrip(self.pn[1], self.out[1], k, int(n), float(t_bus),
                                            float(b0), self.device.index, self.handle)
        _build.check(err, "chain_fold")
        LAUNCHES["chain_fold"] += 1

    def chain(self, b0: float, pn_blk, n: int, t_bus: float) -> np.ndarray:
        with self.lock:
            length = self.stage(pn_blk, n)
            self.run(b0, len(pn_blk), n, t_bus)
            return self.out[0][:length].copy()


_ROUND_TRIPS: dict = {}


def round_trip(device) -> RoundTrip | None:
    """The round trip of `device` (None: the current card), one per card, made
    at its first chain; None for the CPU."""
    dev = resolve(device)
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"chain_fold runs on the card or the CPU, not {dev}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    rt = _ROUND_TRIPS.get(index)
    if rt is None:
        rt = _ROUND_TRIPS.setdefault(index, RoundTrip(index))
    return rt


def chain_fold(b0: float, pn_blk, n: int, t_bus: float, device=None) -> np.ndarray:
    """The chain over round times `pn_blk` (K float64, numpy) x `n` banks, as
    numpy: on `device` (None: the card) one pinned round trip through the
    `chain_fold` kernel; on the CPU the plain version."""
    rt = round_trip(device)
    if rt is None:
        return chain_fold_plain(b0, pn_blk, n, t_bus).numpy()
    return rt.chain(b0, pn_blk, n, t_bus)


def chain_fold_cuda(pn: torch.Tensor, out: torch.Tensor, b0: float, n: int, t_bus: float) -> torch.Tensor:
    """The chain over round times `pn` (K float64) x `n` banks into `out`
    (1 + 2*K*n float64, 16-byte aligned), both on the card: the kernel alone
    on the current stream.  The fastpath goes through `chain_fold`."""
    for name, t in (("pn", pn), ("out", out)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float64 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous 1-d float64 tensor")
    if not pn.is_cuda:
        raise ValueError(f"chain_fold_cuda runs on CUDA tensors, not {pn.device}")
    if out.device != pn.device:
        raise ValueError(f"out is on {out.device}, expected {pn.device}")
    if out.numel() != 1 + 2 * pn.numel() * n:
        raise ValueError(f"out holds {out.numel()} values, the chain {1 + 2 * pn.numel() * n}")
    lib = _build.load()
    with torch.cuda.device(pn.device):
        err = lib.chain_fold_launch(pn.data_ptr(), out.data_ptr(), pn.numel(), int(n), float(t_bus),
                                    float(b0), _build.stream_handle(pn.device))
    _build.check(err, "chain_fold")
    LAUNCHES["chain_fold"] += 1
    return out
