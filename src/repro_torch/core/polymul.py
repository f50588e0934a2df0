"""RLWE polynomial multiplication (paper eq. 1) on the PIM bank model:

    a * b = INTT( NTT(a) ⊙ NTT(b) )            in Z_q[X]/(X^N + 1)

Layout: a at base_row ra, b at rb.  Three command phases:
  1. forward NTT of a (in place), forward NTT of b (in place)
  2. pointwise pass: stream atom pairs through CMul (a <- a ⊙ b)
  3. inverse NTT of a (in place) + 1/N scaling pass

Because the forward emits bit-reversed order and the pointwise product is
element-wise, no bit-reversal commands are needed anywhere (§II-B).

Bank-level parallelism: `polymul_batch` runs independent products on
separate banks through the device-level controller (`repro_torch.pimsys`),
which arbitrates the per-channel shared command bus — near-linear until
the bus saturates (§I / §VII).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import ntt as ntt_ref
from repro_torch.core.mapping import (
    Act,
    CMul,
    ColRead,
    ColWrite,
    Command,
    Mark,
    RowCentricMapper,
)
from repro_torch.core.pim_config import PimConfig
from repro_torch.core.pimsim import TimingResult


def pointwise_commands(cfg: PimConfig, n: int, row_a: int, row_b: int) -> list[Command]:
    """Stream both polynomials through CMul, a <- a ⊙ b, atom by atom.

    Uses buffer pairs with the same software-pipelining discipline as the
    butterfly stages; rows alternate, so with Nb >= 4 the mapper groups
    G = Nb//2 atoms per row switch.
    """
    out: list[Command] = [Mark("pointwise")]
    Na, R, apr = cfg.atom_words, cfg.row_words, cfg.atoms_per_row
    n_rows = max(1, n // R)
    atoms_last = (min(n, R)) // Na
    G = max(1, cfg.num_buffers // 2)
    for r in range(n_rows):
        atoms = apr if n >= R else atoms_last
        for g0 in range(0, atoms, G):
            grp = list(range(g0, min(g0 + G, atoms)))
            out.append(Act(row_a + r))
            for i, atm in enumerate(grp):
                out.append(ColRead(row_a + r, atm, 2 * i))
            out.append(Act(row_b + r))
            for i, atm in enumerate(grp):
                out.append(ColRead(row_b + r, atm, 2 * i + 1))
            for i in range(len(grp)):
                out.append(CMul(2 * i, 2 * i + 1))
            out.append(Act(row_a + r))
            for i, atm in enumerate(grp):
                out.append(ColWrite(row_a + r, atm, 2 * i))
    # deduplicate consecutive Acts to the same row
    dedup: list[Command] = []
    open_row = None
    for c in out:
        if isinstance(c, Act):
            if c.row == open_row:
                continue
            open_row = c.row
        dedup.append(c)
    return dedup


def scaling_commands(cfg: PimConfig, n: int, row_a: int) -> list[Command]:
    """1/N scaling after the inverse NTT: one CMul pass against a constant.

    Hardware-wise the CU multiplies by the scalar n_inv from its parameter
    register; we model it as a CMul-latency pass per atom (no second read).
    """
    out: list[Command] = [Mark("scale")]
    Na, R, apr = cfg.atom_words, cfg.row_words, cfg.atoms_per_row
    n_rows = max(1, n // R)
    atoms_last = min(n, R) // Na
    nb = max(1, cfg.num_buffers)
    for r in range(n_rows):
        out.append(Act(row_a + r))
        atoms = apr if n >= R else atoms_last
        for atm in range(atoms):
            buf = atm % nb
            out.append(ColRead(row_a + r, atm, buf))
            out.append(CMul(buf, buf))  # timed like a scalar multiply pass
            out.append(ColWrite(row_a + r, atm, buf))
    return out


def polymul_phases(cfg: PimConfig, n: int, row_a: int = 0,
                   row_b: int | None = None) -> tuple[dict[str, list[Command]], int]:
    """The canonical polymul phase layout, in execution order.

    Single source of truth for both the flat timed stream
    (`polymul_commands`) and the session's per-phase functional execution
    (`repro_torch.pimsys.session` compiles the dict into its `CompiledPlan`).
    Returns `(phases, row_b)`; concatenating the dict values in insertion
    order IS the timed command stream.
    """
    R = cfg.row_words
    rows = max(1, n // R)
    row_b = row_b if row_b is not None else row_a + rows
    phases = {
        "fwd_a": RowCentricMapper(cfg, n, forward=True, base_row=row_a).commands(),
        "fwd_b": RowCentricMapper(cfg, n, forward=True, base_row=row_b).commands(),
        "pointwise": pointwise_commands(cfg, n, row_a, row_b),
        "inv_a": RowCentricMapper(cfg, n, forward=False, base_row=row_a).commands(),
        "scale": scaling_commands(cfg, n, row_a),
    }
    return phases, row_b


def polymul_commands(cfg: PimConfig, n: int, row_a: int = 0, row_b: int | None = None):
    phases, row_b = polymul_phases(cfg, n, row_a, row_b)
    return [c for cmds in phases.values() for c in cmds], row_b


def pim_polymul(
    a: np.ndarray,
    b: np.ndarray,
    ctx: ntt_ref.NttContext,
    cfg: PimConfig | None = None,
) -> tuple[np.ndarray, TimingResult]:
    """Functional + timed polynomial multiplication on one bank.

    Legacy shim over `repro_torch.pimsys.session.PimSession` (compile once,
    run many); bit-identical values, cycles, and command lists.
    """
    from repro_torch.pimsys.session import PimSession, PolymulOp, warn_legacy

    warn_legacy("pim_polymul", "run(compile(PolymulOp(n)), a, b)")
    sess = PimSession(cfg)
    r = sess.run(sess.compile(PolymulOp(a.shape[0])), a, b, ctx=ctx)
    return r.value, r.timing


def pim_ntt_sharded(
    a: np.ndarray,
    ctx: ntt_ref.NttContext,
    cfg: PimConfig | None = None,
    banks: int = 2,
    forward: bool = False,
    scale_n_inv: bool = True,
    topo=None,
):
    """Execute one negacyclic NTT sharded over `banks` banks, bit-exactly.

    The four-step split of `repro_torch.pimsys.sharded`: each bank runs its
    N/banks-point local `RowCentricMapper` stream (shifted twiddle bases)
    on its own `FunctionalBank`, and the cross-bank stages apply the
    shared-twiddle column butterflies between bank images.  Same
    orientation/scaling conventions as `pim_ntt`; at banks=1 the two are
    command-for-command identical.  Returns `(out, plan)` — time the
    plan with `plan.simulate()`.

    Legacy shim over `repro_torch.pimsys.session.PimSession`; the returned
    plan is the compiled artifact's `ShardedNttPlan`.
    """
    from repro_torch.pimsys.session import PimSession, ShardedNttOp, warn_legacy

    warn_legacy("pim_ntt_sharded", "run(compile(ShardedNttOp(n, banks)), a)")
    a = np.asarray(a, np.uint32)
    sess = PimSession(cfg, topo=topo)
    plan = sess.compile(ShardedNttOp(a.shape[0], banks, forward=forward,
                                     scale_n_inv=scale_n_inv))
    r = sess.run(plan, a, ctx=ctx, time=False)
    return r.value, plan.sharded_plan


def polymul_batch(n: int, batch: int, cfg: PimConfig | None = None, policy: str = "rr"):
    """Time `batch` independent products on the device-level controller.

    One product per bank, banks contending on their channel's shared
    command bus; requests beyond `cfg` topology capacity (num_channels x
    num_ranks x num_banks) queue FIFO.  Returns the closed-loop
    `repro_torch.pimsys.SchedulerResult` (latency percentiles, throughput,
    device stats).  Timing only — for functional output use `pim_polymul`.

    Legacy shim over `repro_torch.pimsys.session.PimSession`.
    """
    from repro_torch.pimsys.session import BatchOp, PimSession, PolymulOp, warn_legacy

    warn_legacy("polymul_batch", "run(compile(BatchOp(PolymulOp(n), batch)))")
    sess = PimSession(cfg, policy=policy)
    return sess.run(sess.compile(BatchOp(PolymulOp(n), batch))).timing
