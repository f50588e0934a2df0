"""Torch backend for the fastpath bus chain: the counterpart of the JAX
package's `jax_backend.py`.

The only sequential recurrence in the evaluator is the speculative bus
chain (everything else is elementwise / exact-max gathers), so this
backend swaps exactly that seam.  The chain must stay a strict left fold,
the same add-by-add semantics as `np.cumsum`, so that results remain
bit-identical to the interpreted engine: on a CUDA device it runs the
hand-written `chain_fold` kernel (one thread walking the chain in order,
`repro_torch.kernels.fold`), never `torch.cumsum`, whose CUDA scan
reassociates the adds; on the CPU it runs `torch.cumsum`, which adds in
order there.  Selected with `evaluate_gang(..., backend="torch", device=)`;
`device=None` is the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels import fold

__all__ = ["torch_chain"]


def torch_chain(b0: float, pn_blk: np.ndarray, n: int, t_bus: float,
                device=None) -> np.ndarray:
    """`_numpy_chain` semantics on torch: returns the ``[b0, s_1, B_1, ...]``
    chain over K rounds x n banks as a float64 numpy array."""
    K = len(pn_blk)
    inc = np.empty(2 * K * n)
    inc[0::2] = np.repeat(pn_blk, n)
    inc[1::2] = t_bus
    vals = fold.left_fold(torch.from_numpy(inc).to(resolve(device)), b0)
    return vals.cpu().numpy()
