"""Record / replay of device command traces (text, HBM-PIMulator style).

A trace is a line-oriented text artifact so benchmark workloads can be
versioned, diffed, and replayed bit-for-bit.  Grammar (one command per
line, `#` comments, blank lines ignored):

    <channel> <bank> <MNEMONIC> <args...>

mirroring HBM-PIMulator's ``R/W MEM [channel_id] [bank_id] [row_id]``
frontend convention of addressing every line by its physical target.
Mnemonics cover the full `core.mapping` command IR:

    ACT  row                      row activate
    RD   row atom buf             column read into atom buffer
    WR   row atom buf             column write from atom buffer
    C1   buf base gs lo hi        intra-atom fused NTT stages
    C2   u,.. v,.. base,.. stride gs   grouped inter-atom butterfly
    CMUL u v                      pointwise Montgomery multiply
    LDW  row col reg              word load  (Nb==1 path)
    STW  row col reg              word store (Nb==1 path)
    BUW  base stride gs           word-granular butterfly
    MARK name                     phase marker (no hardware effect)

Replay drives `pimsys.controller.Device`, so a recorded workload rides
the same arbitration/timing model as a live one.  Scheduler-level
reproducibility (arrival processes) comes from seeds; the trace pins the
*command-level* workload.
"""
from __future__ import annotations

import io
from collections import defaultdict
from typing import IO, Mapping

from repro_torch.core.mapping import (
    Act,
    BUWord,
    C1,
    C2,
    CMul,
    ColRead,
    ColWrite,
    Command,
    Mark,
    WordLoad,
    WordStore,
)
from repro_torch.core.pim_config import PimConfig
from repro_torch.pimsys.controller import Device
from repro_torch.pimsys.topology import DeviceTopology

TRACE_HEADER = "# ntt-pim trace v1: <channel> <bank> <op> <args...>"

Streams = Mapping[tuple[int, int], list[Command]]


def _ints(xs) -> str:
    return ",".join(str(x) for x in xs)


def format_command(cmd: Command) -> str:
    if isinstance(cmd, Act):
        return f"ACT {cmd.row}"
    if isinstance(cmd, ColRead):
        return f"RD {cmd.row} {cmd.atom} {cmd.buf}"
    if isinstance(cmd, ColWrite):
        return f"WR {cmd.row} {cmd.atom} {cmd.buf}"
    if isinstance(cmd, C1):
        return f"C1 {cmd.buf} {cmd.base} {int(cmd.gs)} {cmd.stages_lo} {cmd.stages_hi}"
    if isinstance(cmd, C2):
        return (f"C2 {_ints(cmd.bufs_u)} {_ints(cmd.bufs_v)} "
                f"{_ints(cmd.bases_u)} {cmd.stride} {int(cmd.gs)}")
    if isinstance(cmd, CMul):
        return f"CMUL {cmd.buf_u} {cmd.buf_v}"
    if isinstance(cmd, WordLoad):
        return f"LDW {cmd.row} {cmd.col_word} {cmd.reg}"
    if isinstance(cmd, WordStore):
        return f"STW {cmd.row} {cmd.col_word} {cmd.reg}"
    if isinstance(cmd, BUWord):
        return f"BUW {cmd.base_u} {cmd.stride} {int(cmd.gs)}"
    if isinstance(cmd, Mark):
        return f"MARK {cmd.name}"
    raise TypeError(cmd)


def parse_command(op: str, args: list[str]) -> Command:
    if op == "ACT":
        return Act(int(args[0]))
    if op == "RD":
        return ColRead(int(args[0]), int(args[1]), int(args[2]))
    if op == "WR":
        return ColWrite(int(args[0]), int(args[1]), int(args[2]))
    if op == "C1":
        return C1(int(args[0]), int(args[1]), bool(int(args[2])),
                  int(args[3]), int(args[4]))
    if op == "C2":
        tup = lambda s: tuple(int(x) for x in s.split(","))
        return C2(tup(args[0]), tup(args[1]), tup(args[2]),
                  int(args[3]), bool(int(args[4])))
    if op == "CMUL":
        return CMul(int(args[0]), int(args[1]))
    if op == "LDW":
        return WordLoad(int(args[0]), int(args[1]), int(args[2]))
    if op == "STW":
        return WordStore(int(args[0]), int(args[1]), int(args[2]))
    if op == "BUW":
        return BUWord(int(args[0]), int(args[1]), bool(int(args[2])))
    if op == "MARK":
        return Mark(args[0])
    raise ValueError(f"unknown trace mnemonic {op!r}")


# --------------------------------------------------------------------------
# record / replay
# --------------------------------------------------------------------------


def dump_trace(streams: Streams, f: IO[str] | str) -> None:
    """Write per-(channel, bank) command streams as a text trace.

    Lines keep per-bank program order; banks are emitted in address
    order (replay re-buckets by the leading channel/bank columns, so the
    interleaving of *lines* across banks carries no timing meaning).
    """
    if isinstance(f, str):
        with open(f, "w") as fh:
            dump_trace(streams, fh)
        return
    f.write(TRACE_HEADER + "\n")
    for (ch, bank) in sorted(streams):
        for cmd in streams[(ch, bank)]:
            f.write(f"{ch} {bank} {format_command(cmd)}\n")


def load_trace(f: IO[str] | str) -> dict[tuple[int, int], list[Command]]:
    if isinstance(f, str):
        with open(f) as fh:
            return load_trace(fh)
    streams: dict[tuple[int, int], list[Command]] = defaultdict(list)
    for lineno, line in enumerate(f, 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 3:
            raise ValueError(f"trace line {lineno}: expected '<ch> <bank> <op> ...'")
        ch, bank, op = int(parts[0]), int(parts[1]), parts[2]
        streams[(ch, bank)].append(parse_command(op, parts[3:]))
    return dict(streams)


def loads_trace(text: str) -> dict[tuple[int, int], list[Command]]:
    return load_trace(io.StringIO(text))


def dumps_trace(streams: Streams) -> str:
    buf = io.StringIO()
    dump_trace(streams, buf)
    return buf.getvalue()


def replay_trace(cfg: PimConfig, streams: Streams, policy: str = "rr",
                 param_traces: Mapping[tuple[int, int], object] | None = None,
                 ) -> Device:
    """Build a Device large enough for the trace, enqueue, and drain it.

    The text format records commands, not twiddle values, so a replay
    cannot rederive the device-side parameter cache's residency (that
    needs the GLOBAL transform size behind each stream's (w0, r_w)
    bases).  When the recording ran with `param_cache_entries > 0`,
    pass `param_traces` to reproduce the recorded timing exactly: the
    per-stream `engine.param_beat_trace` results keyed like `streams`,
    which is what `session.CompiledPlan.param_trace_streams()` returns
    for the plan that produced the recording.  Without it the replay
    charges the flat seed-model `param_load_cycles` per CU op (exact
    for default configs, conservative otherwise).
    """
    channels = max((ch for ch, _ in streams), default=0) + 1
    banks = max((b for _, b in streams), default=0) + 1
    topo = DeviceTopology(channels=channels, ranks=1, banks_per_rank=banks)
    dev = Device(cfg, topo, policy=policy)
    for (ch, bank), cmds in sorted(streams.items()):
        trace = param_traces.get((ch, bank)) if param_traces is not None else None
        dev.channels[ch].enqueue(bank, cmds, param_trace=trace)
    dev.drain()
    return dev
