"""Lowering: frozen command streams -> dense arrays (`LoweredPlan`).

NTT-PIM's schedules are static: a `CompiledPlan` is a frozen command
stream whose hazards are all *structural* — each dependency a command
waits on (`col_t`, `cu_t`, `row_usable_t`, `data_ready`/`buf_free` per
buffer, `reg_ready` per register) is last-written by a *fixed earlier
command index*, the same index on every bank of a homogeneous gang.
Lowering replays the stream once symbolically and materializes that
structure as dense numpy arrays:

``kind``/``dram``/masks
    per-command class code and class-membership masks (refresh-checked
    DRAM ops, Act rounds, write-recovery contributors, row-quiesce
    contributors).
``pn``/``code``/``bus_inc``
    per-command parameter-beat cost in ns (resolved from the plan's
    `param_trace` exactly as `ChannelEngine.enqueue` does — a cache hit
    pays the re-select beat, a miss the full `param_load_cycles`) and
    the bus occupancy increment `pn + t_bus`.
``add1``/``add2``
    completion constants so ``done = (s + add1) + add2`` reproduces each
    `BankEngine` handler's float operation order bit-for-bit.
``done_preds``/``col_pred``/``act_pred``
    predecessor command indices.  `done_preds` is a fixed-width table of
    indices whose *done* time the command waits on; `col_pred`/`act_pred`
    index the *start* time of the last column op (+``tCCD``) / last Act
    (+``tRAS``).  Padding rows use sentinel indices that the evaluator
    backs with neutral values, so gathers need no masking.

The evaluator (`repro_torch.pimsys.fastpath.evaluate`) turns these arrays into
start/done schedules without touching Python command objects again.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

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
from repro_torch.core.pimsim import PARAM_OPS

__all__ = ["LoweredPlan", "lower_commands", "lower_plan"]

# command-kind codes (LoweredPlan.kind values, dense per-class dispatch)
K_ACT, K_COL_READ, K_COL_WRITE, K_C1, K_C2, K_CMUL = range(6)
K_WORD_LOAD, K_WORD_STORE, K_BU_WORD = 6, 7, 8

_KIND = {
    Act: K_ACT, ColRead: K_COL_READ, ColWrite: K_COL_WRITE,
    C1: K_C1, C2: K_C2, CMul: K_CMUL,
    WordLoad: K_WORD_LOAD, WordStore: K_WORD_STORE, BUWord: K_BU_WORD,
}
_STAT_KEY = ("act", "col_read", "col_write", "c1", "c2", "cmul",
             "word_load", "word_store", "bu_word")
# refresh-checked DRAM classes (CU ops never consult the refresh clock)
_DRAM = (True, True, True, False, False, False, True, True, False)
# classes whose issue contributes done+tWR to act_start_ok
_WR = (False, False, True, False, False, False, False, True, False)
# classes whose done feeds row_quiesce (read only by Act)
_QUI = (False, True, True, False, False, False, True, True, False)
# classes that update / wait on the column-command cadence (col_t)
_COL = (False, True, True, False, False, False, True, True, False)

# queue-entry param codes, mirrored from repro_torch.pimsys.engine
P_NONE, P_MISS, P_HIT = 0, 1, 2


@dataclasses.dataclass(frozen=True, eq=False)
class LoweredPlan:
    """Dense-array form of one homogeneous command stream (Marks stripped).

    All arrays are indexed by *round* — the stream position after Mark
    stripping; round ``r`` is the r-th command every bank of a gang
    issues.  Sentinel predecessor indices: ``n_cmds`` rows of the
    evaluator's history arrays hold the neutral initial values (0.0 for
    done-type deps, ``-tCCD``/``-tRAS`` for the start-type deps so the
    padded term lands exactly on the engine's 0.0 initial state).
    """

    cfg: PimConfig
    n_cmds: int
    kind: np.ndarray        # (n_cmds,) int8, K_* codes
    dram: np.ndarray        # (n_cmds,) bool — refresh-checked rounds
    pn: np.ndarray          # (n_cmds,) f8 — parameter-beat ns (0 for non-CU)
    code: np.ndarray        # (n_cmds,) int8 — P_NONE / P_MISS / P_HIT
    add1: np.ndarray        # (n_cmds,) f8 — done = (s + add1) + add2
    add2: np.ndarray        # (n_cmds,) f8
    bus_inc: np.ndarray     # (n_cmds,) f8 — pn + t_bus, the bus occupancy
    done_preds: np.ndarray  # (n_cmds, T) int32 — wait-on-done indices
    col_pred: np.ndarray    # (n_cmds,) int32 — last col op (start + tCCD)
    act_pred: np.ndarray    # (n_cmds,) int32 — last Act (start + tRAS)
    act_mask: np.ndarray    # (n_cmds,) bool — Act rounds (read wr/quiesce)
    wr_mask: np.ndarray     # (n_cmds,) bool — contribute done+tWR
    qui_mask: np.ndarray    # (n_cmds,) bool — contribute done to quiesce
    class_counts: tuple     # ((stat_key, count), ...) for classes present
    bu_ops: int             # total butterfly ops per bank
    has_bu: bool            # any C1/C2/BUWord issued (bu_ops key exists)
    n_param_hit: int
    n_param_miss: int
    marks: tuple            # ((round_index, phase_name), ...) in order
    # timing constants, precomputed exactly as BankEngine.__init__ does
    t_bus: float
    t_ccd: float
    t_ras: float
    t_wr: float
    trefi: float
    trfc: float


def lower_commands(
    cfg: PimConfig,
    commands: Sequence[Command],
    param_trace: Sequence[tuple[int, int]] | None = None,
) -> LoweredPlan:
    """Lower one command stream under `cfg` to a `LoweredPlan`.

    `param_trace` is the plan's precomputed cache-residency trace
    (`param_beat_trace`); without one every CU op pays the flat
    `param_load_cycles` beats, exactly like the interpreted engine.
    Raises ValueError when `cfg` enables rank timing — the fastpath
    models the default gate-free rank (`tFAW/tRRD/tRTW/tWTR == 0`).
    """
    if cfg.tFAW or cfg.tRRD or cfg.tRTW or cfg.tWTR:
        raise ValueError(
            "fastpath models the gate-free rank; rank timing "
            "(tFAW/tRRD/tRTW/tWTR) requires the interpreted engine")
    d = cfg.dram_ns
    c = cfg.cu_ns
    t_bus = 1 * d
    t_ccd = cfg.tCCD * d
    t_cl = cfg.CL * d
    t_act = (cfg.tRP + cfg.tRCD) * d
    t_ras = cfg.tRAS * d
    t_wr = cfg.tWR * d
    t_c1 = cfg.c1_latency * c
    t_c2 = cfg.c2_latency * c
    t_c2_extra = cfg.atom_words * c
    t_buw = cfg.bu_word_latency * c
    t_param = cfg.param_load_cycles * d
    c1_bu = cfg.atom_words // 2
    c2_bu = cfg.atom_words

    # done-completion constants per class; C2 overrides add2 per command
    _ADD = {
        K_ACT: (t_act, 0.0), K_COL_READ: (t_cl, t_ccd),
        K_COL_WRITE: (t_ccd, 0.0), K_C1: (t_c1, 0.0), K_C2: (t_c2, 0.0),
        K_CMUL: (t_c2, 0.0), K_WORD_LOAD: (t_cl, 0.0),
        K_WORD_STORE: (t_ccd, 0.0), K_BU_WORD: (t_buw, 0.0),
    }

    kinds: list[int] = []
    pns: list[float] = []
    codes: list[int] = []
    add1s: list[float] = []
    add2s: list[float] = []
    preds: list[tuple[int, ...]] = []
    col_preds: list[int] = []
    act_preds: list[int] = []
    marks: list[tuple[int, str]] = []

    # last-writer trackers (command indices; -1 = initial state)
    last_col = -1           # col_t writer (start-valued)
    last_act = -1           # Act: row_usable_t (done) + act cadence (start)
    last_cu = -1            # cu_t writer (done-valued)
    dr: dict[int, int] = {}     # data_ready[buf] writer
    bf: dict[int, int] = {}     # buf_free[buf] writer
    rr = [-1, -1]               # reg_ready writer per register
    counts = [0] * len(_STAT_KEY)
    bu_ops = 0
    has_bu = False
    n_hit = n_miss = 0

    it = iter(param_trace) if param_trace is not None else None
    i = 0
    for cmd in commands:
        cls = cmd.__class__
        if cls is Mark:
            marks.append((i, cmd.name))
            continue
        k = _KIND[cls]
        pn = 0.0
        code = P_NONE
        if cls in PARAM_OPS:
            if it is None:
                pn = t_param
            else:
                try:
                    beats, code = next(it)
                except StopIteration:
                    raise ValueError(
                        "param_trace shorter than the stream's CU ops"
                    ) from None
                pn = beats * d
                if code == P_HIT:
                    n_hit += 1
                else:
                    n_miss += 1
        a1, a2 = _ADD[k]
        cp = last_col if _COL[k] else -1
        ap = -1
        if k == K_ACT:
            p: tuple[int, ...] = ()
            ap = last_act
            last_act = i
        elif k == K_COL_READ:
            p = (last_act, bf.get(cmd.buf, -1))
            last_col = i
            dr[cmd.buf] = i
        elif k == K_COL_WRITE:
            p = (last_act, dr.get(cmd.buf, -1))
            last_col = i
            bf[cmd.buf] = i
        elif k == K_C1:
            p = (last_cu, dr.get(cmd.buf, -1))
            last_cu = i
            dr[cmd.buf] = bf[cmd.buf] = i
            bu_ops += c1_bu * (cmd.stages_hi - cmd.stages_lo)
            has_bu = True
        elif k == K_C2:
            bufs = tuple(cmd.bufs_u) + tuple(cmd.bufs_v)
            p = (last_cu,) + tuple(dr.get(b, -1) for b in bufs)
            a2 = t_c2_extra * (len(cmd.bufs_u) - 1)
            last_cu = i
            for b in bufs:
                dr[b] = bf[b] = i
            bu_ops += c2_bu * len(cmd.bufs_u)
            has_bu = True
        elif k == K_CMUL:
            p = (last_cu, dr.get(cmd.buf_u, -1), dr.get(cmd.buf_v, -1))
            last_cu = i
            dr[cmd.buf_u] = bf[cmd.buf_u] = i
            bf[cmd.buf_v] = i
        elif k == K_WORD_LOAD:
            p = (last_act, rr[cmd.reg])
            last_col = i
            rr[cmd.reg] = i
        elif k == K_WORD_STORE:
            p = (last_act, rr[cmd.reg])
            last_col = i
        else:  # K_BU_WORD
            p = (last_cu, rr[0], rr[1])
            last_cu = i
            rr[0] = rr[1] = i
            bu_ops += 1
            has_bu = True
        kinds.append(k)
        pns.append(pn)
        codes.append(code)
        add1s.append(a1)
        add2s.append(a2)
        preds.append(p)
        col_preds.append(cp)
        act_preds.append(ap)
        counts[k] += 1
        i += 1
    if it is not None and next(it, None) is not None:
        raise ValueError("param_trace longer than the stream's CU ops")

    n = i
    width = max((len(p) for p in preds), default=1) or 1
    kind = np.asarray(kinds, dtype=np.int8)
    done_preds = np.full((n, width), n, dtype=np.int32)
    for r, p in enumerate(preds):
        for j, v in enumerate(p):
            done_preds[r, j] = v if v >= 0 else n
    col_pred = np.asarray(col_preds, dtype=np.int32)
    col_pred[col_pred < 0] = n          # S sentinel row holds -tCCD
    act_pred = np.asarray(act_preds, dtype=np.int32)
    act_pred[act_pred < 0] = n + 1      # S sentinel row holds -tRAS

    pn_arr = np.asarray(pns, dtype=np.float64)
    kt = kind if n else kind.reshape(0)
    take = lambda tbl: np.asarray(tbl, dtype=bool)[kt] if n else np.zeros(0, bool)
    return LoweredPlan(
        cfg=cfg,
        n_cmds=n,
        kind=kind,
        dram=take(_DRAM),
        pn=pn_arr,
        code=np.asarray(codes, dtype=np.int8),
        add1=np.asarray(add1s, dtype=np.float64),
        add2=np.asarray(add2s, dtype=np.float64),
        bus_inc=pn_arr + t_bus,
        done_preds=done_preds,
        col_pred=col_pred,
        act_pred=act_pred,
        act_mask=(kind == K_ACT) if n else np.zeros(0, bool),
        wr_mask=take(_WR),
        qui_mask=take(_QUI),
        class_counts=tuple(
            (key, cnt) for key, cnt in zip(_STAT_KEY, counts) if cnt),
        bu_ops=bu_ops,
        has_bu=has_bu,
        n_param_hit=n_hit,
        n_param_miss=n_miss,
        marks=tuple(marks),
        t_bus=t_bus,
        t_ccd=t_ccd,
        t_ras=t_ras,
        t_wr=t_wr,
        trefi=cfg.tREFI_ns,
        trfc=cfg.tRFC_ns,
    )


def lower_plan(cfg: PimConfig, plan) -> LoweredPlan:
    """Lower a `CompiledPlan` (NttOp/PolymulOp, or a homogeneous BatchOp
    of one) to dense arrays, reusing the plan's cached `param_trace`.

    A BatchOp plan lowers its replicated member stream once — the gang
    width comes in at evaluation time (`evaluate_gang(lowered, banks)`).
    """
    if plan.cfg != cfg:
        raise ValueError("lower_plan: cfg does not match plan.cfg")
    inner = plan.inner if plan.inner is not None else plan
    if inner.sharded_plan is not None or not inner.commands:
        raise ValueError("lower_plan: plan has no homogeneous command "
                         "stream (sharded plans run on the interpreted "
                         "engine)")
    return lower_commands(cfg, inner.commands, inner.param_trace)
