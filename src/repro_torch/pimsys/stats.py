"""Stats registry for the PIM memory system.

Aggregates the per-bank command counters that `core.pimsim.BankEngine`
produces, plus per-channel bus occupancy, into device-level views:
per-bank, per-channel, and whole-device rollups, bus utilization, and
energy via `core.pim_config.EnergyModel` (the same accounting as
`TimingResult.energy_nj`, so single-bank numbers agree with the paper
benchmarks).
"""
from __future__ import annotations

from collections import defaultdict

from repro_torch.core.pim_config import EnergyModel


def merge_counts(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        dst[k] = dst.get(k, 0) + v
    return dst


class StatsRegistry:
    """Counters keyed by (channel, bank-within-channel)."""

    def __init__(self, channels: int | None = None):
        # declared channel universe (the topology's channel count); a
        # channel exists even before any traffic lands on it, so span
        # stretches and summaries must cover silent channels too
        self._channels = channels or 0
        self._bank: dict[tuple[int, int], dict] = defaultdict(dict)
        self._bus_busy_ns: dict[int, float] = defaultdict(float)
        self._bus_span_ns: dict[int, float] = defaultdict(float)
        self._device: dict = {}
        self._service: dict[tuple[str, str], int] = {}
        self._series: dict[str, object] = {}

    # -- recording -----------------------------------------------------------
    def add_bank(self, channel: int, bank: int, counters: dict) -> None:
        merge_counts(self._bank[(channel, bank)], counters)

    def add_service(self, qos: str, key: str, count: int = 1) -> None:
        """Service-layer counters keyed by QoS class: submissions,
        per-reason rejections (`rejected_queue_full`, `rejected_rate_limited`)
        — the admission-control view `run_service` records."""
        self._service[(qos, key)] = self._service.get((qos, key), 0) + count

    def add_bus(self, channel: int, busy_ns: float, span_ns: float) -> None:
        self._bus_busy_ns[channel] += busy_ns
        self._bus_span_ns[channel] = max(self._bus_span_ns[channel], span_ns)

    def add_device(self, counters: dict) -> None:
        """Counters with no per-bank home (e.g. the sharded exchange's
        `xfer_atoms` / `xfer_hops` inter-bank bursts)."""
        merge_counts(self._device, counters)

    def attach_series(self, name: str, series) -> None:
        """Attach a windowed time series (`telemetry.WindowedSeries`) so
        `summary()` carries the timeline next to the counters."""
        self._series[name] = series

    def extend_span(self, span_ns: float) -> None:
        """Stretch every channel's observation window to `span_ns`.

        Covers the declared channel universe (see `channels()`), not
        just channels that already recorded bus traffic — a silent
        channel's utilization is a true 0.0 over the run's span, not an
        undefined 0/0 that stays zero after traffic arrives later.
        """
        for ch in self.channels():
            self._bus_span_ns[ch] = max(self._bus_span_ns[ch], span_ns)

    # -- views ---------------------------------------------------------------
    def bank_counts(self, channel: int, bank: int) -> dict:
        return dict(self._bank.get((channel, bank), {}))

    def channel_counts(self, channel: int) -> dict:
        out: dict = {}
        for (ch, _), c in self._bank.items():
            if ch == channel:
                merge_counts(out, c)
        return out

    def device_counts(self) -> dict:
        out: dict = {}
        for c in self._bank.values():
            merge_counts(out, c)
        merge_counts(out, self._device)
        return out

    def service_counts(self, qos: str | None = None) -> dict:
        """Service-layer counters: `{key: count}` for one QoS class, or
        `{(qos, key): count}` over every class."""
        if qos is None:
            return dict(self._service)
        return {k: v for (c, k), v in self._service.items() if c == qos}

    def channels(self) -> list[int]:
        """Every known channel: the declared universe (constructor
        `channels=` from the topology) unioned with any channel that has
        recorded bank or bus activity."""
        seen = {ch for ch, _ in self._bank} | set(self._bus_busy_ns)
        seen.update(range(self._channels))
        return sorted(seen)

    def bus_busy_ns(self, channel: int) -> float:
        return self._bus_busy_ns.get(channel, 0.0)

    def bus_utilization(self, channel: int) -> float:
        span = self._bus_span_ns.get(channel, 0.0)
        if span <= 0.0:
            return 0.0
        return min(1.0, self._bus_busy_ns[channel] / span)

    def energy_nj(self, model: EnergyModel | None = None) -> float:
        return (model or EnergyModel()).energy_nj(self.device_counts())

    def param_hit_rate(self, channel: int | None = None,
                       bank: int | None = None) -> float:
        """Hit rate of the device-side twiddle-parameter cache
        (`PimConfig.param_cache_entries`): hits / (hits + misses) over
        the whole device, one channel, or one bank.  `bank` addresses a
        bank WITHIN a channel and therefore requires `channel` on a
        multi-channel registry (it defaults to the sole channel 0
        otherwise).  0.0 when the cache is disabled (no tracked
        accesses)."""
        if bank is not None:
            if channel is None:
                chans = self.channels()
                if len(chans) > 1:
                    raise ValueError(
                        "bank= addresses a bank within a channel; pass "
                        f"channel= too (registry spans channels {chans})")
                channel = chans[0] if chans else 0
            c = self.bank_counts(channel, bank)
        elif channel is not None:
            c = self.channel_counts(channel)
        else:
            c = self.device_counts()
        hits = c.get("param_hit", 0)
        total = hits + c.get("param_miss", 0)
        return hits / total if total else 0.0

    def diff(self, other: "StatsRegistry") -> dict:
        """Structured difference against another registry — empty when
        the two agree on every per-bank counter, device counter, and
        per-channel bus occupancy.  The fastpath differential tests use
        this to report WHICH counter diverged instead of a bare
        dict-inequality failure; `refresh` is still compared (the
        backends are bit-identical on a shared timeline)."""
        out: dict = {}
        banks = set(self._bank) | set(other._bank)
        for key in sorted(banks):
            a = self._bank.get(key, {})
            b = other._bank.get(key, {})
            if a != b:
                keys = set(a) | set(b)
                out[f"bank{key}"] = {
                    k: (a.get(k), b.get(k))
                    for k in sorted(keys) if a.get(k) != b.get(k)
                }
        if self._device != other._device:
            keys = set(self._device) | set(other._device)
            out["device"] = {
                k: (self._device.get(k), other._device.get(k))
                for k in sorted(keys)
                if self._device.get(k) != other._device.get(k)
            }
        chans = set(self._bus_busy_ns) | set(other._bus_busy_ns)
        for ch in sorted(chans):
            a, b = self.bus_busy_ns(ch), other.bus_busy_ns(ch)
            if a != b:
                out[f"bus{ch}"] = (a, b)
        return out

    #: per-bank counters that are derived metrics, not issued commands
    NON_COMMAND_KEYS = ("bu_ops", "refresh", "param_hit", "param_miss")

    def summary(self, model: EnergyModel | None = None) -> dict:
        """Flat dict for reports / benchmark `emit` lines."""
        dev = self.device_counts()
        per_ch = {
            ch: {
                "bus_utilization": self.bus_utilization(ch),
                "commands": sum(
                    v for k, v in self.channel_counts(ch).items()
                    if k not in self.NON_COMMAND_KEYS
                ),
            }
            for ch in self.channels()
        }
        out = {
            "device_counts": dev,
            "energy_nj": self.energy_nj(model),
            "per_channel": per_ch,
        }
        if self._service:
            out["service"] = {
                f"{qos}/{key}": v for (qos, key), v in sorted(self._service.items())
            }
        if self._series:
            out["timeseries"] = {
                name: s.points_us() for name, s in sorted(self._series.items())
            }
        return out
