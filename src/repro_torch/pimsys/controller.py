"""Per-channel memory controller: thin driver of `repro_torch.pimsys.engine`.

`ChannelController` and `Device` are the established device-facing names
for the channel and device layers of the hierarchical resource engine;
since the engine refactor they ARE those layers — one command-issue path
(`engine.ChannelEngine` / `engine.DeviceEngine`: shared-bus arbitration
→ `RankState` tFAW/turnaround windows → `core.pimsim.BankEngine` bank
hazards → CU), not a parallel implementation.  With one bank the grant
sequence degenerates to program order and the timing is bit-identical to
`BankTimer` by construction; see the engine module docstring for the
layering, arbitration policies, and the device-side twiddle-parameter
cache model.
"""
from __future__ import annotations

from repro_torch.pimsys.engine import (
    POLICIES,
    ChannelEngine,
    Completion,
    DeviceEngine,
)

__all__ = ["POLICIES", "ChannelController", "Completion", "Device"]


class ChannelController(ChannelEngine):
    """One command/address bus shared by bank ports (`ChannelEngine`)."""

    __slots__ = ()


class Device(DeviceEngine):
    """A full PIM device: one `ChannelController` per channel
    (`DeviceEngine`)."""

    __slots__ = ()
