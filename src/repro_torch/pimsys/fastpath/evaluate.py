"""Block-speculative vectorized evaluation of lowered command streams.

The interpreted hierarchy (`repro_torch.pimsys.engine`) walks one command at a
time through a Python event loop.  For a *homogeneous gang* — `banks`
copies of one stream behind one shared command bus under the default
round-robin arbiter — the grant order is statically known: with every
queue non-empty and every head gated at t=0, `ChannelEngine._pick`
always grants the next bank cyclically, so round ``r`` issues command
``r`` on banks ``[1, 2, .., n-1, 0]`` and the whole schedule collapses
to array recurrences over the `LoweredPlan` arrays.

The evaluator exploits the workload's character: multibank gangs are
*bus-bound* (each command's dependencies usually resolve before the bus
grants), so it **speculates** K rounds at a time assuming the bus alone
binds every start:

1. one `cumsum` over interleaved ``[param_ns, t_bus]`` increments yields
   every speculative start/grant in the block (`np.cumsum` accumulates
   left-to-right, so the chain reproduces the interpreted engine's
   float adds bit-for-bit);
2. completion times follow elementwise: ``done = (s + add1) + add2``;
3. per-round dependency maxima gather from the provisional history via
   the lowered predecessor tables (`max` is exact in floating point, so
   gather-and-reduce order is free);
4. a round validates iff every bank's dependencies resolve at or before
   its grant AND no refresh window opens; the valid prefix commits, the
   first failing round replays through an exact scalar fallback, and
   speculation resumes after it.

Dep-bound streams (small gangs, the single-bank profile case) would
fail speculation every round, so a short failure streak flips the
evaluator into scalar bursts with periodic re-probes — the fallback IS
the interpreted recurrence, just over dense arrays, so results stay
bit-identical either way.  Refresh (`tREFI/tRFC`), the param-cache
hit/miss beat charges, write-recovery (`tWR`), the row-quiesce fence,
and the unpipelined serial barrier are all modeled exactly.

`backend="torch"` swaps the sequential bus chain for a strict left fold
on `device` (the card by default: the `chain_fold` kernel), keeping the
same bit-exact left-fold semantics, the counterpart of the JAX package's
`backend="jax"` (`torch_backend.py`).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.pim_config import PimConfig

from .lowering import LoweredPlan, P_HIT, P_MISS, lower_commands, lower_plan

__all__ = ["GangResult", "FastpathMismatch", "evaluate_gang",
           "phase_breakdown", "verify_stream", "verify"]

_NEG_INF = float("-inf")


class FastpathMismatch(RuntimeError):
    """Fastpath and interpreted-engine results disagree — a timing-model
    bug, raised by the differential oracle (`verify` / sampled serving
    verification), never by normal evaluation."""


@dataclasses.dataclass(frozen=True, eq=False)
class GangResult:
    """Timing of one homogeneous gang: `banks` copies of one stream on
    one shared-bus channel, bit-identical to the interpreted engine.

    `starts`/`dones` are (n_cmds, banks) — column b is bank b's per-round
    schedule in issue order (what a `telemetry.Tracer` would record).
    """

    banks: int
    makespan_ns: float
    bank_end_ns: np.ndarray      # (banks,) per-bank end_t
    bus_busy_ns: float           # shared-bus occupancy, arbiter bookkeeping
    counters: tuple              # per-bank stats dicts, BankEngine key rules
    starts: np.ndarray           # (n_cmds, banks) f8
    dones: np.ndarray            # (n_cmds, banks) f8
    fallback_rounds: int         # rounds replayed via the scalar path


def evaluate_gang(lowered: LoweredPlan, banks: int, *, pipelined: bool = True,
                  backend: str = "numpy", block: int = 96, device=None) -> GangResult:
    """Evaluate `banks` copies of a lowered stream on one shared bus.

    Reproduces `ChannelEngine` under the default round-robin arbiter
    (every stream enqueued at gate 0, drained to completion) exactly:
    same makespans, same per-command start/done floats, same stat
    counters.  `banks=1` additionally matches the paper's `BankTimer`.
    `device` is where `backend="torch"` runs the chain (None: the card).
    """
    if banks < 1:
        raise ValueError("evaluate_gang: banks must be >= 1")
    if backend not in ("numpy", "torch"):
        raise ValueError(f"evaluate_gang: unknown backend {backend!r}")
    chain = _numpy_chain
    if backend == "torch":
        from .torch_backend import torch_chain
        chain = functools.partial(torch_chain, device=device)

    lp = lowered
    C = lp.n_cmds
    n = banks
    if C == 0:
        return GangResult(banks=n, makespan_ns=0.0,
                          bank_end_ns=np.zeros(n), bus_busy_ns=0.0,
                          counters=tuple({} for _ in range(n)),
                          starts=np.zeros((0, n)), dones=np.zeros((0, n)),
                          fallback_rounds=0)
    if n == 1:
        # no arbitration: one flat native-float scan over the dense
        # tables beats both the vector path and the interpreted loop
        return _evaluate_single(lp, pipelined)

    # History arrays.  Rows [0, C) are per-round values; the tail rows
    # back the sentinel predecessor indices with neutral values so that
    # padded gathers reproduce the engine's zero initial state exactly:
    # done sentinel = 0.0, col sentinel -tCCD (+tCCD -> 0.0), act
    # sentinel -tRAS (+tRAS -> 0.0).
    S = np.zeros((C + 2, n))
    DONE = np.zeros((C + 1, n))
    S[C, :] = -lp.t_ccd
    S[C + 1, :] = -lp.t_ras

    bank_of_pos = (np.arange(n) + 1) % n    # grant position -> bank id
    refresh_ct = [0] * n
    wmax = np.full(n, _NEG_INF)     # write-recovery component of act_start_ok
    qui = np.full(n, _NEG_INF)      # row_quiesce running max
    B_state = 0.0                   # shared-bus free time
    t_bus, t_ccd, t_ras, t_wr = lp.t_bus, lp.t_ccd, lp.t_ras, lp.t_wr

    nref = [lp.trefi] * n           # python-float refresh clocks
    trfc, trefi = lp.trfc, lp.trefi
    # native-typed per-round tables so the exact fallback round pays no
    # numpy scalar extraction
    done_preds = lp.done_preds
    col_pred_l = lp.col_pred.tolist()
    act_pred_l = lp.act_pred.tolist()
    pn_l = lp.pn.tolist()
    a1_l = lp.add1.tolist()
    a2_l = lp.add2.tolist()
    dram_l = lp.dram.tolist()
    act_l = lp.act_mask.tolist()
    wr_l = lp.wr_mask.tolist()
    qui_l = lp.qui_mask.tolist()

    def exact_round(r: int, B: float) -> float:
        """Exact interpreted recurrence for one full arbitration round:
        per-bank dependency maxima gather vectorized (max reduction is
        exact in float, so order is free), then the short sequential bus
        scan over the n grant slots in native floats — every add in the
        same order the interpreted handlers perform it."""
        dep = DONE[done_preds[r]].max(axis=0)
        np.maximum(dep, S[col_pred_l[r]] + t_ccd, out=dep)
        np.maximum(dep, S[act_pred_l[r]] + t_ras, out=dep)
        if act_l[r]:
            np.maximum(dep, wmax, out=dep)
            np.maximum(dep, qui, out=dep)
        if not pipelined and r > 0:
            np.maximum(dep, DONE[r - 1], out=dep)
        dl = dep.tolist()
        pn = pn_l[r]
        a1 = a1_l[r]
        a2 = a2_l[r]
        is_dram = dram_l[r]
        s_row = [0.0] * n
        d_row = [0.0] * n
        for pos in range(n):
            b = pos + 1 if pos + 1 < n else 0
            d = dl[b]
            s = B if B >= d else d
            if is_dram and s >= nref[b]:
                nr = nref[b]
                while s >= nr:
                    refresh_ct[b] += 1
                    t = nr + trfc
                    if t > s:
                        s = t
                    nr += trefi
                nref[b] = nr
            s = s + pn
            s_row[b] = s
            d_row[b] = (s + a1) + a2
            B = s + t_bus
        S[r] = s_row
        DONE[r] = d_row
        if wr_l[r]:
            np.maximum(wmax, DONE[r] + t_wr, out=wmax)
        if qui_l[r]:
            np.maximum(qui, DONE[r], out=qui)
        return B

    fallback = 0
    streak = 0          # consecutive blocks that failed at their 1st round
    K_adapt = block     # block size tracks the recent valid-prefix length
    r = 0
    while r < C:
        if streak >= 2:
            # dep-bound regime: run an exact-round burst, then probe again
            stop = min(C, r + 64)
            while r < stop:
                B_state = exact_round(r, B_state)
                fallback += 1
                r += 1
            streak = 0
            continue
        K = min(K_adapt, C - r)
        sl = slice(r, r + K)

        # 1. speculative bus chain: starts assuming the bus alone binds
        vals = chain(B_state, lp.pn[sl], n, t_bus)
        S_b = np.empty((K, n))
        G_b = np.empty((K, n))
        S_b[:, bank_of_pos] = vals[1::2].reshape(K, n)
        G_b[:, bank_of_pos] = vals[0::2][:-1].reshape(K, n)

        # 2. provisional completion times into history
        S[sl] = S_b
        D_b = (S_b + lp.add1[sl, None]) + lp.add2[sl, None]
        DONE[sl] = D_b

        # 3. dependency maxima from the (provisional) history
        dep = DONE[lp.done_preds[sl]].max(axis=1)
        np.maximum(dep, S[lp.col_pred[sl]] + t_ccd, out=dep)
        np.maximum(dep, S[lp.act_pred[sl]] + t_ras, out=dep)
        wr_blk = lp.wr_mask[sl]
        qui_blk = lp.qui_mask[sl]
        act_blk = lp.act_mask[sl]
        contrib_w = np.where(wr_blk[:, None], D_b + t_wr, _NEG_INF)
        contrib_q = np.where(qui_blk[:, None], D_b, _NEG_INF)
        if act_blk.any():
            accw = np.maximum.accumulate(
                np.concatenate([wmax[None], contrib_w[:-1]]), axis=0)
            accq = np.maximum.accumulate(
                np.concatenate([qui[None], contrib_q[:-1]]), axis=0)
            wq = np.maximum(accw, accq)
            dep = np.where(act_blk[:, None], np.maximum(dep, wq), dep)
        if not pipelined:
            barr = np.empty((K, n))
            barr[0] = DONE[r - 1] if r > 0 else 0.0
            barr[1:] = D_b[:-1]
            np.maximum(dep, barr, out=dep)

        # 4. validate: deps resolved by grant time, no refresh window
        ok = (dep <= G_b).all(axis=1)
        ref_bad = (S_b >= np.asarray(nref)[None, :]).any(axis=1)
        ok &= ~(lp.dram[sl] & ref_bad)
        m = K if ok.all() else int(np.argmin(ok))
        # size the next block to the observed valid-prefix length, so a
        # marginal regime stops paying full-block cost for short commits
        K_adapt = (min(block, K_adapt * 2) if m == K
                   else max(8, min(K_adapt, 2 * max(m, 1))))

        # 5. commit the valid prefix, scalar-replay the failing round
        if m > 0:
            np.maximum(wmax, contrib_w[:m].max(axis=0), out=wmax)
            np.maximum(qui, contrib_q[:m].max(axis=0), out=qui)
            B_state = float(vals[2 * m * n])
            streak = 0
        r += m
        if m < K:
            if m == 0:
                streak += 1
            B_state = exact_round(r, B_state)
            fallback += 1
            r += 1

    starts = S[:C]
    dones = DONE[:C]
    bank_end = dones.max(axis=0)
    # the interpreted arbiter accumulates (param_ns + t_bus) per issue,
    # left to right; cumsum is the same left fold, so the total is exact
    bus_busy = float(np.cumsum(np.repeat(lp.bus_inc, n))[-1])

    counters = []
    for b in range(n):
        stats = {key: cnt for key, cnt in lp.class_counts}
        if lp.has_bu:
            stats["bu_ops"] = lp.bu_ops
        if lp.n_param_hit:
            stats["param_hit"] = lp.n_param_hit
        if lp.n_param_miss:
            stats["param_miss"] = lp.n_param_miss
        if refresh_ct[b]:
            stats["refresh"] = int(refresh_ct[b])
        counters.append(stats)

    return GangResult(banks=n, makespan_ns=float(bank_end.max()),
                      bank_end_ns=bank_end, bus_busy_ns=bus_busy,
                      counters=tuple(counters), starts=starts, dones=dones,
                      fallback_rounds=fallback)


def _evaluate_single(lp: LoweredPlan, pipelined: bool) -> GangResult:
    """banks=1 special case: no arbitration, so the schedule is one
    strict left fold — a native-float scan over the dense tables, every
    add/max in the interpreted `BankTimer` order."""
    C = lp.n_cmds
    preds = lp.done_preds.tolist()
    col_p = lp.col_pred.tolist()
    act_p = lp.act_pred.tolist()
    pn_l = lp.pn.tolist()
    a1_l = lp.add1.tolist()
    a2_l = lp.add2.tolist()
    dram_l = lp.dram.tolist()
    act_l = lp.act_mask.tolist()
    wr_l = lp.wr_mask.tolist()
    qui_l = lp.qui_mask.tolist()
    t_bus, t_ccd, t_ras, t_wr = lp.t_bus, lp.t_ccd, lp.t_ras, lp.t_wr
    trfc, trefi = lp.trfc, lp.trefi

    S0 = [0.0] * (C + 2)
    D0 = [0.0] * (C + 1)
    S0[C] = -t_ccd
    S0[C + 1] = -t_ras
    B = 0.0
    wm = qu = _NEG_INF
    nr = trefi
    refresh = 0
    barrier = 0.0
    end_t = 0.0
    for r in range(C):
        d = 0.0
        for p in preds[r]:
            v = D0[p]
            if v > d:
                d = v
        v = S0[col_p[r]] + t_ccd
        if v > d:
            d = v
        v = S0[act_p[r]] + t_ras
        if v > d:
            d = v
        if act_l[r]:
            if wm > d:
                d = wm
            if qu > d:
                d = qu
        if not pipelined and barrier > d:
            d = barrier
        s = B if B >= d else d
        if dram_l[r] and s >= nr:
            while s >= nr:
                refresh += 1
                t = nr + trfc
                if t > s:
                    s = t
                nr += trefi
        s = s + pn_l[r]
        done = (s + a1_l[r]) + a2_l[r]
        S0[r] = s
        D0[r] = done
        B = s + t_bus
        if done > end_t:
            end_t = done
        if not pipelined:
            barrier = done
        if wr_l[r]:
            w = done + t_wr
            if w > wm:
                wm = w
        if qui_l[r] and done > qu:
            qu = done

    stats = {key: cnt for key, cnt in lp.class_counts}
    if lp.has_bu:
        stats["bu_ops"] = lp.bu_ops
    if lp.n_param_hit:
        stats["param_hit"] = lp.n_param_hit
    if lp.n_param_miss:
        stats["param_miss"] = lp.n_param_miss
    if refresh:
        stats["refresh"] = refresh
    bus_busy = float(np.cumsum(lp.bus_inc)[-1]) if C else 0.0
    return GangResult(banks=1, makespan_ns=end_t,
                      bank_end_ns=np.array([end_t]), bus_busy_ns=bus_busy,
                      counters=(stats,),
                      starts=np.asarray(S0[:C])[:, None],
                      dones=np.asarray(D0[:C])[:, None],
                      fallback_rounds=0)


def _numpy_chain(b0: float, pn_blk: np.ndarray, n: int,
                 t_bus: float) -> np.ndarray:
    """Speculative bus chain ``[b0, s_1, B_1, s_2, B_2, ...]`` over K
    rounds x n banks: ``s = B_prev + param_ns``, ``B = s + t_bus``.
    `np.cumsum` is a strict left fold, so each value carries exactly the
    float adds the interpreted arbiter performs."""
    K = len(pn_blk)
    arr = np.empty(1 + 2 * K * n)
    arr[0] = b0
    arr[1::2] = np.repeat(pn_blk, n)
    arr[2::2] = t_bus
    return np.cumsum(arr)


def phase_breakdown(lowered: LoweredPlan, dones: np.ndarray) -> dict:
    """Reconstruct `BankTimer`-style `phase_ns` from a single-bank done
    column, replaying the Mark bookkeeping over the running end time."""
    run_end = np.maximum.accumulate(dones) if len(dones) else dones
    phase_ns: dict[str, float] = {}
    name, start = "intra", 0.0
    for pos, mark in lowered.marks:
        end_here = float(run_end[pos - 1]) if pos else 0.0
        phase_ns[name] = phase_ns.get(name, 0.0) + (end_here - start)
        name, start = mark, end_here
    end_t = float(run_end[-1]) if len(dones) else 0.0
    phase_ns[name] = phase_ns.get(name, 0.0) + (end_t - start)
    return phase_ns


# --------------------------------------------------------------------------
# Differential oracle — the interpreted engine stays the ground truth
# --------------------------------------------------------------------------


def verify_stream(cfg: PimConfig, commands, banks: int, *,
                  param_trace=None, pipelined: bool = True,
                  backend: str = "numpy", device=None) -> GangResult:
    """Replay one homogeneous gang through BOTH the fastpath and the
    interpreted `ChannelEngine`, asserting bit-identical makespans,
    per-bank stat counters, and bus occupancy.  Raises
    `FastpathMismatch` on any disagreement; returns the fastpath result.
    """
    from repro_torch.pimsys.engine import replay_gang

    lp = lower_commands(cfg, commands, param_trace)
    g = evaluate_gang(lp, banks, pipelined=pipelined, backend=backend, device=device)
    eng = replay_gang(cfg, commands, banks, param_trace=param_trace,
                      pipelined=pipelined)
    if eng.makespan_ns != g.makespan_ns:
        raise FastpathMismatch(
            f"fastpath makespan {g.makespan_ns!r} != interpreted "
            f"{eng.makespan_ns!r} (banks={banks})")
    if eng.bus_busy_ns != g.bus_busy_ns:
        raise FastpathMismatch(
            f"fastpath bus_busy {g.bus_busy_ns!r} != interpreted "
            f"{eng.bus_busy_ns!r} (banks={banks})")
    for b in range(banks):
        ref = dict(eng.engines[b].stats)
        if ref != g.counters[b]:
            raise FastpathMismatch(
                f"fastpath stats diverge on bank {b}: {g.counters[b]!r} "
                f"!= interpreted {ref!r}")
        if eng.engines[b].end_t != float(g.bank_end_ns[b]):
            raise FastpathMismatch(
                f"fastpath end_t diverges on bank {b}: "
                f"{float(g.bank_end_ns[b])!r} != {eng.engines[b].end_t!r}")
    return g


def verify(plan, seed: int = 0, *, banks: int | None = None,
           pipelined: bool = True, backend: str = "numpy", device=None) -> float:
    """Differential oracle entry point: evaluate `plan` as a homogeneous
    gang through the fastpath AND the interpreted engine, assert equal
    makespans/stat counters, and return the makespan.  `seed` draws the
    gang width when `banks` is None — the sampled-verification hook the
    serving path and CI use."""
    if banks is None:
        banks = int(np.random.default_rng(seed).integers(1, 17))
    inner = plan.inner if plan.inner is not None else plan
    if inner.sharded_plan is not None or not inner.commands:
        raise ValueError("verify: plan has no homogeneous command stream")
    g = verify_stream(plan.cfg, inner.commands, banks,
                      param_trace=inner.param_trace, pipelined=pipelined,
                      backend=backend, device=device)
    return g.makespan_ns
