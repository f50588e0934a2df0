"""NTT-PIM architecture + timing parameters (paper Table I, HBM2E-based)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PimConfig:
    """Architecture and timing parameters of one PIM bank.

    Timing parameters are in DRAM cycles at `dram_clock_mhz` (Table I);
    DRAM latencies are fixed in *ns* when the CU clock is scaled (the
    paper's Fig 8 protocol: "the absolute latency of DRAM memory access
    time (in ns) is kept constant").
    """

    # -- architecture (Table I) --------------------------------------------
    atom_bytes: int = 32            # DRAM atom
    word_bytes: int = 4             # 32-bit coefficients
    atoms_per_row: int = 32         # "# of columns per row"
    rows_per_bank: int = 32768
    num_banks: int = 1
    num_buffers: int = 2            # Nb, including the primary (GSA)

    # -- device level (repro_torch.pimsys; beyond the paper's single bank) --------
    # One shared command/address bus per channel; ranks on a channel share
    # that bus (HBM pseudo-channel style), banks within a rank are the
    # paper's independent NTT-PIM banks.
    num_channels: int = 1
    num_ranks: int = 1

    # -- DRAM timing in cycles at dram_clock_mhz (Table I) ------------------
    CL: int = 14
    tCCD: int = 2
    tRP: int = 14
    tRAS: int = 34
    tRCD: int = 14
    tWR: int = 16
    dram_clock_mhz: float = 1200.0

    # -- CU (paper §VI-B: "latency of C1 and C2 is 15 and 10 cycles") -------
    c1_latency: int = 15
    c2_latency: int = 10
    bu_word_latency: int = 6        # single-word BU via scalar regs (Nb=1 path)
    param_load_cycles: int = 4      # (w0, r_w) via global buffer per C1/C2,
    #                                 16-bit chunks "in multiple cycles" (§IV-A)
    cu_clock_mhz: float = 1200.0    # scaled in the Fig 8 experiment

    # -- device-side twiddle-parameter cache (repro_torch.pimsys.engine) ----------
    # LRU cache of recently-used (w0, r_w) parameter programs at each
    # bank's CU (the §V "per-application buffer" idea applied to the
    # per-CU-op parameter stream that sets the multibank bus knee): a
    # miss streams the full `param_load_cycles` beats over the shared
    # bus, a hit pays a single re-select beat.  0 = no cache (the seed
    # timing model, charged flat per CU op).
    param_cache_entries: int = 0

    # -- rank-level timing (repro_torch.pimsys.engine.RankState) ------------------
    # DRAM rank constraints in cycles at `dram_clock_mhz`, shared by the
    # banks of one rank: tFAW (at most 4 ACTs per rank in any tFAW
    # window), tRRD (ACT-to-ACT within a rank), and tRTW/tWTR data-bus
    # turnaround when consecutive same-rank column accesses switch
    # direction.  All default to 0 — the seed model's idealized rank,
    # kept as the differential anchor (banks=1 and the committed golden
    # cycle counts are bit-identical by construction).  HBM2E-class
    # values to enable them: tFAW=24, tRRD=4, tRTW=8, tWTR=5.
    tFAW: int = 0
    tRRD: int = 0
    tRTW: int = 0
    tWTR: int = 0

    # -- refresh (DRAMsim3 models it; approximated as a stall window) -------
    tREFI_ns: float = 3900.0
    tRFC_ns: float = 260.0

    # -- inter-bank exchange (repro_torch.pimsys.sharded) -------------------------
    # A sharded NTT moves atoms between banks over the per-channel shared
    # bus: one atom (Na words) crosses as a burst of `xfer_beats_per_atom`
    # bus beats (paired ColRead on the source / ColWrite on the target);
    # crossing a channel boundary additionally costs `channel_hop_cycles`
    # of hop latency (both channels' buses are held for the burst).
    xfer_beats_per_atom: int = 4
    channel_hop_cycles: int = 12

    # -- observability (repro_torch.pimsys.telemetry) -----------------------------
    # Opt-in command/phase tracing.  Off by default: engines then carry
    # `tracer=None` and the issue loops pay a single `is None` test, so
    # the committed `engine_speed` floor is unaffected.  On, session
    # runs attach a `TelemetryHandle` to `RunResult.telemetry` with the
    # full per-command/per-phase timeline (Perfetto-exportable).  A bool
    # keeps the config hashable (it stays a valid plan-cache key); the
    # flag does not alter timing, only recording.
    telemetry: bool = False

    @property
    def atom_words(self) -> int:  # Na
        return self.atom_bytes // self.word_bytes

    @property
    def row_words(self) -> int:  # R
        return self.atoms_per_row * self.atom_words

    @property
    def dram_ns(self) -> float:
        return 1e3 / self.dram_clock_mhz

    @property
    def cu_ns(self) -> float:
        return 1e3 / self.cu_clock_mhz

    def with_(self, **kw) -> "PimConfig":
        return dataclasses.replace(self, **kw)


#: Default configuration used throughout the paper's evaluation.
DEFAULT_PIM = PimConfig()


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Per-op energy constants (nJ).

    `literature` uses HBM2-class per-bank numbers (row activate+precharge,
    column access terminating at the atom buffer — i.e. no chip I/O — and a
    32-lane modular-arithmetic CU at 65 nm).  The paper's Table III energy
    unit/accounting is not fully specified, so benchmarks also report a
    least-squares fit of these three constants to the paper's own (N, Nb)
    energy table; see benchmarks/table3_comparison.py.
    """

    e_act: float = 0.909       # nJ per ACT(+PRE) of a 1KB row (HBM2-class)
    e_col: float = 0.053       # nJ per 32B column access stopping at P/S
    e_cu: float = 0.020        # nJ per C1/C2 (<=12 pipelined 32b mod-ops)
    e_word: float = 0.004      # nJ per word load/store micro-op

    def energy_nj(self, stats: dict) -> float:
        return (
            self.e_act * stats.get("act", 0)
            + self.e_col * (stats.get("col_read", 0) + stats.get("col_write", 0))
            + self.e_cu * (stats.get("c1", 0) + stats.get("c2", 0) + stats.get("cmul", 0))
            + self.e_word
            * (stats.get("word_load", 0) + stats.get("word_store", 0) + stats.get("bu_word", 0))
        )
