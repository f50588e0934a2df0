"""Device-level topology of an NTT-PIM memory system.

The paper evaluates one bank and predicts near-linear multi-bank speedup
(§VII); `repro_torch.pimsys` models the layer above: a device is

    channels × ranks × banks_per_rank

where every channel owns ONE shared command/address bus (the contention
resource of `core.pimsim.simulate_multibank`'s analytic bound) and banks
are the paper's row-centric NTT-PIM banks.  The address mapper follows
the HBM-PIMulator convention of channel-interleaving consecutive
resources so independent jobs spread across buses first.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple

from repro_torch.core.pim_config import PimConfig


class BankAddress(NamedTuple):
    """Physical location of one bank: (channel, rank, bank-in-rank)."""

    channel: int
    rank: int
    bank: int


@dataclasses.dataclass(frozen=True)
class DeviceTopology:
    """channels × ranks × banks_per_rank, parameterized from `PimConfig`."""

    channels: int = 1
    ranks: int = 1
    banks_per_rank: int = 1

    def __post_init__(self):
        for name in ("channels", "ranks", "banks_per_rank"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")

    @classmethod
    def from_config(cls, cfg: PimConfig) -> "DeviceTopology":
        return cls(
            channels=cfg.num_channels,
            ranks=cfg.num_ranks,
            banks_per_rank=max(1, cfg.num_banks),
        )

    # -- sizes ---------------------------------------------------------------
    @property
    def banks_per_channel(self) -> int:
        return self.ranks * self.banks_per_rank

    @property
    def total_banks(self) -> int:
        return self.channels * self.banks_per_channel

    # -- flat id <-> physical address (channel-interleaved) ------------------
    def address_of(self, flat: int) -> BankAddress:
        """Flat bank id -> (channel, rank, bank).

        Channel bits are the LOW bits (HBM-PIMulator-style interleaving):
        consecutive flat ids land on different channels, so a scheduler
        filling banks in order naturally balances the per-channel buses.
        """
        if not 0 <= flat < self.total_banks:
            raise IndexError(f"bank id {flat} out of range [0, {self.total_banks})")
        ch = flat % self.channels
        within = flat // self.channels
        return BankAddress(ch, within // self.banks_per_rank, within % self.banks_per_rank)

    def flat_of(self, addr: BankAddress) -> int:
        if not (0 <= addr.channel < self.channels
                and 0 <= addr.rank < self.ranks
                and 0 <= addr.bank < self.banks_per_rank):
            raise IndexError(f"{addr} out of range for {self}")
        within = addr.rank * self.banks_per_rank + addr.bank
        return within * self.channels + addr.channel

    def banks(self) -> Iterator[BankAddress]:
        """All bank addresses in flat-id (channel-interleaved) order."""
        for flat in range(self.total_banks):
            yield self.address_of(flat)

    def local_id(self, addr: BankAddress) -> int:
        """Bank index within its channel (the controller's bank key)."""
        return addr.rank * self.banks_per_rank + addr.bank

    def flat_from_local(self, channel: int, local: int) -> int:
        """Inverse of (address_of, local_id): channel + in-channel id -> flat."""
        return local * self.channels + channel

    def channel_of(self, flat: int) -> int:
        """Channel owning flat bank id (the bus a transfer to/from it holds)."""
        return self.address_of(flat).channel

    def describe(self) -> str:
        return (f"{self.channels}ch x {self.ranks}rk x {self.banks_per_rank}ba "
                f"= {self.total_banks} banks "
                f"({self.banks_per_channel}/channel bus)")
