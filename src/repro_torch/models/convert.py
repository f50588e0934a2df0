"""Carries the JAX package's parameters into the port.

`params_from_reference(tree, device)` takes the reference's parameter
tree as numpy arrays (`jax.tree.map(np.asarray, params)`, so nothing here
touches jax) and returns the port's parameter dict, with names, nesting,
shapes and dtypes unchanged, so that both packages compute the same
function.  A bf16 array arrives with numpy dtype `bfloat16` (from the
`ml_dtypes` package, recognised here by its name only), which
`torch.from_numpy` refuses: its bits go through `uint16` instead.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One array as a tensor on `device` (the card when None), bit for bit;
    bf16 through its bits."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve(device))


def params_from_reference(tree, device=None):
    """The reference's parameter tree (dicts and lists of numpy arrays) as
    the port's parameter dict on `device` (the card when None)."""
    device = resolve(device)
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_reference(v, device) for v in tree]
    return tensor_from_numpy(tree, device)
