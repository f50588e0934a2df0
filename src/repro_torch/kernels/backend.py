"""NTT execution backends (`NttBackend`): the port of `repro/kernels/backend.py`.

Two lanes of the SAME transform contract sit behind one interface, so they
can be differentially tested against each other (and against the
reference package's lanes):

  reference  numpy stage loop (`core.ntt`) — the ground truth.
  cuda       `kernels.ops.ntt` / `intt` on a torch device: the CUDA kernels
             on the card (the default), their plain versions with
             `device="cpu"`.

The reference package's `pim-sim` lane joins when the simulator is ported.

Contract (shared by all lanes): uint32 arrays over the last axis,
`forward=True` is natural in -> bit-reversed out, `forward=False` is
bit-reversed in -> natural out scaled by 1/N — exactly the
`core.ntt.ntt_forward_np` / `ntt_inverse_np` conventions.

`get_backend(name)` / `available_backends()` are the registry.
"""
from __future__ import annotations

import abc

import numpy as np
import torch

from repro_torch.core import modmath as mm
from repro_torch.core import ntt as ntt_core
from repro_torch.kernels import ops

DEFAULT_Q = mm.DEFAULT_Q


class NttBackend(abc.ABC):
    """One NTT execution lane behind the shared transform contract."""

    name: str = "?"
    summary: str = ""

    def __init__(self) -> None:
        self._ctxs: dict[tuple[int, int], ntt_core.NttContext] = {}

    # -- shared helpers ------------------------------------------------------
    def context(self, q: int, n: int) -> ntt_core.NttContext:
        """Cached `NttContext` per (q, n) — table setup is the expensive
        part of small transforms and must not pollute timing loops."""
        key = (q, n)
        ctx = self._ctxs.get(key)
        if ctx is None:
            ctx = self._ctxs[key] = ntt_core.make_context(q, n)
        return ctx

    def available(self) -> bool:
        """Whether this lane can run in the current environment."""
        return True

    def modeled_latency_ns(self, n: int, forward: bool = True) -> float | None:
        """Architecture-model latency for one size-n transform, if this
        backend has one; None means only wall-clock timing applies."""
        return None

    # -- the transform -------------------------------------------------------
    @abc.abstractmethod
    def _ntt_2d(self, x: np.ndarray, ctx: ntt_core.NttContext,
                forward: bool) -> np.ndarray:
        """Transform a (batch, n) uint32 array over the last axis."""

    def ntt(self, x: np.ndarray, q: int = DEFAULT_Q,
            forward: bool = True) -> np.ndarray:
        """Negacyclic NTT over the last axis of a (n,) or (batch, n)
        uint32 array; see the module docstring for the orientation
        contract."""
        x = np.asarray(x, np.uint32)
        if x.ndim not in (1, 2):
            raise ValueError(f"expected (n,) or (batch, n), got {x.shape}")
        n = x.shape[-1]
        if n & (n - 1) or n <= 0:
            raise ValueError("n must be a power of two")
        ctx = self.context(q, n)
        batched = x.ndim == 2
        out = self._ntt_2d(x if batched else x[None, :], ctx, forward)
        out = np.asarray(out, np.uint32)
        return out if batched else out[0]


class ReferenceBackend(NttBackend):
    name = "reference"
    summary = "numpy stage loop (core.ntt) — ground truth"

    def _ntt_2d(self, x, ctx, forward):
        fn = ntt_core.ntt_forward_np if forward else ntt_core.ntt_inverse_np
        return fn(x, ctx)


class CudaBackend(NttBackend):
    """The CUDA kernel lane (`kernels.ops`), on the card by default."""

    name = "cuda"
    summary = "hand-written CUDA kernels (kernels.ntt.ntt_cuda)"

    def __init__(self, device="cuda") -> None:
        super().__init__()
        self.device = torch.device(device)

    def available(self) -> bool:
        return self.device.type != "cuda" or torch.cuda.is_available()

    def _ntt_2d(self, x, ctx, forward):
        fn = ops.ntt if forward else ops.intt
        return mm.to_numpy_u32(fn(x, ctx, device=self.device))


_REGISTRY = {
    ReferenceBackend.name: ReferenceBackend,
    CudaBackend.name: CudaBackend,
}

BACKEND_NAMES = tuple(_REGISTRY)


def get_backend(name: str, **kwargs) -> NttBackend:
    """Instantiate a backend by registry name ('reference', 'cuda');
    raises ValueError for unknown names with the list of known ones in
    the message."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown NTT backend {name!r}; known: {sorted(_REGISTRY)}"
        ) from None
    return cls(**kwargs)


def available_backends() -> list[NttBackend]:
    """Every registered backend that can run here, registry order."""
    return [b for b in (get_backend(name) for name in _REGISTRY) if b.available()]
