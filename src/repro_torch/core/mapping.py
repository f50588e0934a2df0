"""Row-centric NTT→PIM mapping (paper §III/§IV-B) + functional execution.

The memory controller (MC) model turns one NTT invocation into a DRAM
command stream.  Commands:

  Act(row)                    row activate (implies precharge of open row)
  ColRead(row, atom, buf)     atom: row buffer -> atom buffer `buf` (CU-read)
  ColWrite(row, atom, buf)    atom buffer -> row buffer (CU-write)
  C1(buf, base)               intra-atom NTT: log(Na) fused stages (Alg. 1)
  C2(bufs_u, bufs_v, ...)     vectorized inter-atom butterfly (Alg. 2);
                              grouped over G=len(bufs_u) atom pairs so the
                              scheduler can exploit same-row grouping (§V)
  WordLoad/WordStore/BUWord   word-granular path used when Nb==1 (§III-B:
                              "two loads ... two stores per BU operation")

Twiddles: the hardware generates twiddles on the fly from (w0, r_w) per
command (§IV-A).  Functionally we resolve them from the NttContext tables
using the *global word offset* each command touches; the MC would program
(w0, r_w) so that the generated sequence equals exactly these table values
(per-block resets are parameter re-loads, which the command encoding
supports — see DESIGN.md §2, changed-assumption #1).

Three regimes (§IV-B): stage stride t (in words)
  t < Na          intra-atom  -> folded into C1
  Na <= t < R     intra-row   -> C2, all accesses hit the open row
  t >= R          inter-row   -> C2 with intermittent Acts; with Nb >= 4
                  the mapper groups G = Nb//2 atom pairs per row switch,
                  eliminating activations (§V "pipelining ... reduced
                  number of row activations").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import numpy as np

from repro_torch.core import modmath as mm
from repro_torch.core import ntt as ntt_ref
from repro_torch.core.pim_config import PimConfig


# --------------------------------------------------------------------------
# Command IR
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Act:
    row: int


@dataclasses.dataclass(frozen=True)
class ColRead:
    row: int
    atom: int
    buf: int


@dataclasses.dataclass(frozen=True)
class ColWrite:
    row: int
    atom: int
    buf: int


@dataclasses.dataclass(frozen=True)
class C1:
    buf: int
    base: int  # global word offset of the atom (for twiddle resolution)
    gs: bool   # butterfly type: GS (inverse orientation) or CT (forward)
    stages_lo: int  # first stage index handled (0-based, in stride order)
    stages_hi: int  # one past last


@dataclasses.dataclass(frozen=True)
class C2:
    bufs_u: tuple[int, ...]
    bufs_v: tuple[int, ...]
    bases_u: tuple[int, ...]  # global word offsets of the u-atoms
    stride: int               # butterfly stride in words
    gs: bool


@dataclasses.dataclass(frozen=True)
class WordLoad:
    row: int
    col_word: int
    reg: int


@dataclasses.dataclass(frozen=True)
class WordStore:
    row: int
    col_word: int
    reg: int


@dataclasses.dataclass(frozen=True)
class BUWord:
    base_u: int  # global word offset of operand u
    stride: int
    gs: bool


@dataclasses.dataclass(frozen=True)
class CMul:
    """Pointwise Montgomery multiply of two atom buffers: u <- u * v mod q.

    Used for the NTT-domain element-wise product of eq. (1); same CU
    datapath as C2 (ModMult lane per element), no butterfly add/sub.
    """

    buf_u: int
    buf_v: int


@dataclasses.dataclass(frozen=True)
class Mark:
    """Phase marker (no hardware effect) — lets the timer attribute time."""

    name: str


Command = Act | ColRead | ColWrite | C1 | C2 | CMul | WordLoad | WordStore | BUWord | Mark


# --------------------------------------------------------------------------
# Stage plan helpers
# --------------------------------------------------------------------------

#: Count of `RowCentricMapper.commands()` materializations since import.
#: The session layer (`repro_torch.pimsys.session`) compiles each mapper stream
#: once per `CompiledPlan`; tests snapshot this counter around a repeated
#: `run()` to prove the cached plan performs zero mapper regeneration.
MAPPER_GENERATIONS = 0


def mapper_generations() -> int:
    """Current value of the module-wide mapper-generation counter."""
    return MAPPER_GENERATIONS


def stage_strides(n: int, forward: bool) -> list[int]:
    """Butterfly strides in execution order.

    inverse/GS orientation (paper Alg. 1-2): 1, 2, ..., N/2
    forward/CT orientation:                  N/2, ..., 2, 1
    """
    s = [1 << i for i in range(int(math.log2(n)))]
    return s[::-1] if forward else s


def twiddle_index(n: int, stride: int, global_offset: int) -> int:
    """Index into the brv twiddle table for the block containing offset.

    For both orientations, the stage with stride t has blocks of 2t
    elements and block B uses table[h + B] with h = n/(2t).
    """
    h = n // (2 * stride)
    return h + global_offset // (2 * stride)


def cu_twiddle_indices(cfg: PimConfig, n: int, cmd) -> tuple[int, ...] | None:
    """Global twiddle-table indices one CU op's (w0, r_w) parameter
    program resolves, or None for ops without a generator program
    (CMul's pointwise operands, non-CU commands).

    THE single definition of program identity: the session's functional
    `twiddle_param_stream` and the engine's parameter-cache keys
    (`pimsys.engine.param_program_key`) both derive from it, so the
    replayed values and the cached residency can never disagree.  `n`
    is the GLOBAL transform size (sharded local streams resolve the
    full table through their shifted bases).  Stage-h prefixing makes
    index tuples disjoint across strides (index = h + B with B < h),
    so the tuple alone identifies the stage geometry.
    """
    cls = cmd.__class__
    if cls is C2:
        return tuple(twiddle_index(n, cmd.stride, b) for b in cmd.bases_u)
    if cls is C1:
        Na = cfg.atom_words
        strides = stage_strides(Na, not cmd.gs)[cmd.stages_lo:cmd.stages_hi]
        return tuple(twiddle_index(n, t, cmd.base + k)
                     for t in strides for k in range(0, Na, 2 * t))
    if cls is BUWord:
        return (twiddle_index(n, cmd.stride, cmd.base_u),)
    return None


# --------------------------------------------------------------------------
# The mapper (memory controller model)
# --------------------------------------------------------------------------


class RowCentricMapper:
    """Generates the command stream for one negacyclic NTT of size n.

    Layout: coefficient i lives at word i of a contiguous region starting
    at `base_row` (row = base_row + i // R, atom = (i % R) // Na).
    The polynomial is in bit-reversed order for the inverse orientation
    and natural order for the forward one (paper: CPU does bit reversal).

    `twiddle_base` offsets every emitted twiddle base (C1/C2/BUWord) by a
    constant *global* word offset without moving the data: a size-n stream
    with twiddle_base = b*n resolves its twiddles as words [b*n, (b+1)*n)
    of a larger transform, which is exactly the local pass of bank b in a
    sharded size-(B*n) NTT (`repro_torch.pimsys.sharded`).  The MC realizes it
    by programming shifted (w0, r_w) parameters; the command count and
    memory traffic are untouched, so twiddle_base = 0 streams are
    bit-identical to the unsharded mapper's.
    """

    def __init__(self, cfg: PimConfig, n: int, forward: bool = False, base_row: int = 0,
                 twiddle_base: int = 0):
        if n & (n - 1):
            raise ValueError("n must be a power of two")
        self.cfg = cfg
        self.n = n
        self.forward = forward
        self.base_row = base_row
        self.twiddle_base = twiddle_base
        self.Na = cfg.atom_words
        self.R = cfg.row_words
        if cfg.num_buffers >= 2:
            self.G = cfg.num_buffers // 2  # atom pairs per C2 group
        else:
            self.G = 0

    # -- address helpers ----------------------------------------------------
    def row_of(self, word: int) -> int:
        return self.base_row + word // self.R

    def atom_of(self, word: int) -> int:
        return (word % self.R) // self.Na

    def _act(self, out: list, row: int):
        """Emit Act only when switching rows (an MC never re-activates)."""
        if getattr(self, "_open_row", None) != row:
            out.append(Act(row))
            self._open_row = row

    # -- emission -----------------------------------------------------------
    def commands(self) -> list[Command]:
        global MAPPER_GENERATIONS
        MAPPER_GENERATIONS += 1
        self._open_row = None
        out: list[Command] = []
        strides = stage_strides(self.n, self.forward)
        intra_atom = [t for t in strides if t < self.Na]
        intra_row = [t for t in strides if self.Na <= t < self.R]
        inter_row = [t for t in strides if t >= self.R]

        if self.forward:
            # CT: large strides first (mirror of the paper's Fig 4 order).
            self._emit_inter_row(out, inter_row)
            out.append(Mark("intra"))
            self._emit_row_blocks(out, intra_row, intra_atom, c1_first=False)
        else:
            out.append(Mark("intra"))
            self._emit_row_blocks(out, intra_row, intra_atom, c1_first=True)
            self._emit_inter_row(out, inter_row)
        return out

    # -- phase 1: independent row-sized blocks (vertical split, Fig 4) ------
    def _emit_row_blocks(self, out, intra_row, intra_atom, c1_first: bool):
        n_rows = max(1, self.n // self.R)
        words_per_block = min(self.n, self.R)
        atoms_per_block = words_per_block // self.Na
        for blk in range(n_rows):
            row = self.base_row + blk
            self._act(out, row)
            blk_base = blk * self.R
            if c1_first:
                self._emit_c1_pass(out, row, blk_base, atoms_per_block, intra_atom)
                self._emit_intra_row(out, row, blk_base, atoms_per_block, intra_row)
            else:
                self._emit_intra_row(out, row, blk_base, atoms_per_block, intra_row)
                self._emit_c1_pass(out, row, blk_base, atoms_per_block, intra_atom)

    def _emit_c1_pass(self, out, row, blk_base, atoms, intra_atom):
        """Software-pipelined read -> C1 -> write per atom (§V, Fig 6b).

        The MC emits reads up to Nb atoms ahead; with one buffer the
        schedule degenerates to the serial read/compute/write chain.
        """
        if not intra_atom:
            return
        lo, hi = 0, len(intra_atom)
        nb = max(1, self.cfg.num_buffers)
        depth = nb
        for a in range(min(depth, atoms)):  # prologue
            out.append(ColRead(row, a, a % nb))
        for a in range(atoms):
            buf = a % nb
            out.append(C1(buf, self.twiddle_base + blk_base + a * self.Na,
                          gs=not self.forward, stages_lo=lo, stages_hi=hi))
            out.append(ColWrite(row, a, buf))
            nxt = a + depth
            if nxt < atoms:
                out.append(ColRead(row, nxt, nxt % nb))

    def _emit_intra_row(self, out, row, blk_base, atoms, intra_row):
        for t in intra_row:
            if self.cfg.num_buffers >= 2:
                self._emit_c2_stage_intra(out, row, blk_base, atoms, t)
            else:
                self._emit_word_serial_stage(out, [t], blk_base, min(self.n, self.R))

    def _emit_c2_stage_intra(self, out, row, blk_base, atoms, t):
        """Intra-row C2s: atom u pairs with atom u + t/Na inside the open row.

        Buffer pairs rotate across consecutive C2s (software pipelining):
        with Nb buffers, Nb//2 butterfly C2s can be in flight — reads of
        C2 #k+1 overlap compute/writes of C2 #k (paper §V, Fig 6b).
        """
        ta = t // self.Na  # stride in atoms
        pairs = [u for u in range(atoms) if (u // ta) % 2 == 0]
        D = max(1, self.G)  # pipeline depth = Nb // 2 buffer pairs

        def slot_bufs(g):
            slot = g % D
            return 2 * slot, 2 * slot + 1

        for g in range(min(D, len(pairs))):  # prologue reads
            bu, bv = slot_bufs(g)
            out.append(ColRead(row, pairs[g], bu))
            out.append(ColRead(row, pairs[g] + ta, bv))
        for g, u_atom in enumerate(pairs):
            bu, bv = slot_bufs(g)
            base = self.twiddle_base + blk_base + u_atom * self.Na
            out.append(C2((bu,), (bv,), (base,), t, gs=not self.forward))
            out.append(ColWrite(row, u_atom, bu))
            out.append(ColWrite(row, u_atom + ta, bv))
            nxt = g + D
            if nxt < len(pairs):
                nbu, nbv = slot_bufs(nxt)
                out.append(ColRead(row, pairs[nxt], nbu))
                out.append(ColRead(row, pairs[nxt] + ta, nbv))

    # -- phase 2: inter-row stages (stage-by-stage, §IV-B) -------------------
    def _emit_inter_row(self, out, strides):
        for t in strides:
            out.append(Mark(f"inter:{t}"))
            if self.cfg.num_buffers >= 2:
                self._emit_c2_stage_inter(out, t)
            else:
                self._emit_word_serial_stage(out, [t], 0, self.n)

    def _emit_c2_stage_inter(self, out, t):
        """Inter-row stage at stride t >= R.

        Row r pairs with row r + t/R.  For each row pair, process the
        atoms_per_row atom pairs in groups of G = Nb//2: read G u-atoms
        under one activation of r_u, switch to r_v, read G v-atoms,
        compute, write the v results while r_v is open (buffer hits),
        switch back to r_u, write u results + read the next G u-atoms
        under the same activation.  2 Acts per group instead of 2 per
        atom pair — the §V activation-grouping effect.
        """
        tr = t // self.R  # stride in rows
        n_rows = self.n // self.R
        G = max(1, self.G)
        apr = self.cfg.atoms_per_row
        for r_u_idx in range(n_rows):
            if (r_u_idx // tr) % 2 != 0:
                continue
            r_v_idx = r_u_idx + tr
            row_u = self.base_row + r_u_idx
            row_v = self.base_row + r_v_idx
            for g0 in range(0, apr, G):
                atoms = list(range(g0, min(g0 + G, apr)))
                self._act(out, row_u)
                bufs_u, bufs_v, bases = [], [], []
                for i, a in enumerate(atoms):
                    bu = (2 * i) % self.cfg.num_buffers
                    bv = (2 * i + 1) % self.cfg.num_buffers
                    out.append(ColRead(row_u, a, bu))
                    bufs_u.append(bu)
                    bufs_v.append(bv)
                    bases.append(self.twiddle_base + r_u_idx * self.R + a * self.Na)
                self._act(out, row_v)
                for i, a in enumerate(atoms):
                    out.append(ColRead(row_v, a, bufs_v[i]))
                out.append(C2(tuple(bufs_u), tuple(bufs_v), tuple(bases), t, gs=not self.forward))
                # v results written while row_v is open: buffer hits.
                for i, a in enumerate(atoms):
                    out.append(ColWrite(row_v, a, bufs_v[i]))
                # u results need the row switched back.
                self._act(out, row_u)
                for i, a in enumerate(atoms):
                    out.append(ColWrite(row_u, a, bufs_u[i]))

    # -- Nb == 1 degenerate path (§III-B) ------------------------------------
    def _emit_word_serial_stage(self, out, strides, blk_base, span):
        """Word-granular butterflies via the CU's two scalar registers.

        Every BU: two loads + two stores; loads/stores are column accesses
        into the open row; crossing rows forces activations ("about half
        of them require row activation").
        """
        for t in strides:
            for blk in range(blk_base, blk_base + span, 2 * t):
                for j in range(t):
                    u = blk + j
                    v = u + t
                    row_u, row_v = self.row_of(u), self.row_of(v)
                    self._act(out, row_u)
                    out.append(WordLoad(row_u, u % self.R, 0))
                    self._act(out, row_v)
                    out.append(WordLoad(row_v, v % self.R, 1))
                    out.append(BUWord(self.twiddle_base + u, t, gs=not self.forward))
                    out.append(WordStore(row_v, v % self.R, 1))
                    self._act(out, row_u)
                    out.append(WordStore(row_u, u % self.R, 0))


# --------------------------------------------------------------------------
# Functional executor — "verify the functionality of our NTT function as
# executed" (paper §VI-A, the DRAMsim3 two-way check)
# --------------------------------------------------------------------------


class FunctionalBank:
    """Executes a command stream against a memory image, bit-exactly."""

    def __init__(self, cfg: PimConfig, ctx: ntt_ref.NttContext, forward: bool):
        self.cfg = cfg
        self.ctx = ctx
        self.forward = forward
        self.mem = np.zeros((cfg.rows_per_bank, cfg.row_words), np.uint32)
        self.bufs = np.zeros((max(1, cfg.num_buffers), cfg.atom_words), np.uint32)
        self.regs = np.zeros(2, np.uint32)
        self.open_row: int | None = None
        self.table = ctx.psi_brv if forward else ctx.psi_inv_brv

    # twiddle for stage stride t, block containing global offset
    def _tw(self, stride: int, offset: int) -> int:
        return int(self.table[twiddle_index(self.ctx.n, stride, offset)])

    def _bu(self, a: int, b: int, w: int, gs: bool) -> tuple[int, int]:
        q = self.ctx.q
        if gs:
            return (a + b) % q, (a - b) * w % q
        wb = b * w % q
        return (a + wb) % q, (a - wb) % q

    def load_poly(self, a: np.ndarray, base_row: int = 0):
        R = self.cfg.row_words
        n = a.shape[0]
        rows = max(1, n // R)
        for r in range(rows):
            chunk = a[r * R : (r + 1) * R]
            self.mem[base_row + r, : chunk.shape[0]] = chunk

    def read_poly(self, n: int, base_row: int = 0) -> np.ndarray:
        R = self.cfg.row_words
        rows = max(1, n // R)
        out = [self.mem[base_row + r, : min(n, R)] for r in range(rows)]
        return np.concatenate(out)[:n]

    def run(self, commands: Iterable[Command]):
        cfg, Na = self.cfg, self.cfg.atom_words
        q = self.ctx.q
        for cmd in commands:
            if isinstance(cmd, Act):
                self.open_row = cmd.row
            elif isinstance(cmd, ColRead):
                assert self.open_row == cmd.row, "buffer conflict: row not open"
                self.bufs[cmd.buf] = self.mem[cmd.row, cmd.atom * Na : (cmd.atom + 1) * Na]
            elif isinstance(cmd, ColWrite):
                assert self.open_row == cmd.row, "buffer conflict: row not open"
                self.mem[cmd.row, cmd.atom * Na : (cmd.atom + 1) * Na] = self.bufs[cmd.buf]
            elif isinstance(cmd, C1):
                self._run_c1(cmd)
            elif isinstance(cmd, C2):
                self._run_c2(cmd)
            elif isinstance(cmd, CMul):
                u = self.bufs[cmd.buf_u].astype(np.int64)
                v = self.bufs[cmd.buf_v].astype(np.int64)
                self.bufs[cmd.buf_u] = (u * v % q).astype(np.uint32)
            elif isinstance(cmd, WordLoad):
                assert self.open_row == cmd.row
                self.regs[cmd.reg] = self.mem[cmd.row, cmd.col_word]
            elif isinstance(cmd, WordStore):
                assert self.open_row == cmd.row
                self.mem[cmd.row, cmd.col_word] = self.regs[cmd.reg]
            elif isinstance(cmd, BUWord):
                w = self._tw(cmd.stride, cmd.base_u)
                a, b = self._bu(int(self.regs[0]), int(self.regs[1]), w, cmd.gs)
                self.regs[0], self.regs[1] = a, b
            elif isinstance(cmd, Mark):
                pass
            else:  # pragma: no cover
                raise TypeError(cmd)

    def _run_c1(self, cmd: C1):
        """Alg. 1: log(Na) butterfly stages inside one atom buffer."""
        Na = self.cfg.atom_words
        x = self.bufs[cmd.buf].astype(np.int64)
        strides = stage_strides(Na, self.forward)[cmd.stages_lo : cmd.stages_hi]
        for t in strides:
            for k in range(0, Na, 2 * t):
                w = self._tw(t, cmd.base + k)
                for j in range(k, k + t):
                    a, b = self._bu(int(x[j]), int(x[j + t]), w, cmd.gs)
                    x[j], x[j + t] = a, b
        self.bufs[cmd.buf] = x.astype(np.uint32)

    def _run_c2(self, cmd: C2):
        """Alg. 2: Na-way vectorized butterfly between buffer pairs."""
        q = self.ctx.q
        for bu, bv, base in zip(cmd.bufs_u, cmd.bufs_v, cmd.bases_u):
            u = self.bufs[bu].astype(np.int64)
            v = self.bufs[bv].astype(np.int64)
            w = self._tw(cmd.stride, base)
            if cmd.gs:
                nu = (u + v) % q
                nv = (u - v) * w % q
            else:
                wv = v * w % q
                nu = (u + wv) % q
                nv = (u - wv) % q
            self.bufs[bu] = nu.astype(np.uint32)
            self.bufs[bv] = nv.astype(np.uint32)


# --------------------------------------------------------------------------
# Public API: run a full NTT through the functional PIM model
# --------------------------------------------------------------------------


def pim_ntt(
    a: np.ndarray,
    ctx: ntt_ref.NttContext,
    cfg: PimConfig | None = None,
    forward: bool = False,
    scale_n_inv: bool = True,
) -> tuple[np.ndarray, list[Command]]:
    """Execute a negacyclic NTT on the functional PIM bank model.

    forward=False (paper orientation): input bit-reversed-domain, GS
    butterflies, output natural — the inverse NTT (scaled by 1/N unless
    scale_n_inv=False; the scaling is one extra vectorized pass that the
    host or CU performs; MeNTT-style comparisons exclude it).
    """
    cfg = cfg or PimConfig()
    n = a.shape[0]
    if n < cfg.atom_words:
        raise ValueError("n must be at least one atom")
    mapper = RowCentricMapper(cfg, n, forward=forward)
    cmds = mapper.commands()
    bank = FunctionalBank(cfg, ctx, forward=forward)
    bank.load_poly(np.asarray(a, np.uint32))
    bank.run(cmds)
    out = bank.read_poly(n)
    if not forward and scale_n_inv:
        out = np.asarray(mm.np_mulmod(out, ctx.n_inv, ctx.q), np.uint32)
    return out, cmds
