"""RNS-CKKS arithmetic on the H100: the port of `repro/he/rns.py`.

A ciphertext polynomial under Q = q_0 ... q_{L-1} is L residue towers,
rows of uint32 `[L, n]`, and each tower's arithmetic is a negacyclic NTT
or polymul modulo its own prime.  Here the towers are uint32 tensors on
the card and every tower op goes through the port's kernel wrappers with
that tower's `NttContext`: `kernels.ntt.ntt_cuda` (B1 `ntt_tile`, B2
`ntt_pair`) for the transforms and `kernels.modmul.modmul_cuda` (B3) for
the pointwise products, one call per tower per phase over all of that
tower's rows.  The modular adds, the base extension and rescale are
elementwise int64 torch passes, as they are numpy passes outside any
kernel in the reference.

  * `RnsBasis` / `make_basis` — the modulus chain with one port
    `NttContext` per tower; CRT `encode` / `decode` and the gadget stay
    host-side (python ints, numpy uint32 `[L, n]`); `base_extend` runs on
    the tensor's device.
  * `ntt_towers`, `poly_mul_towers`, `ct_mul`, `keyswitch`,
    `relinearize`, `ct_mul_relin`, `rescale` — bit-exact with the
    reference: every result is a canonical residue.
  * big-int oracles `ct_mul_reference`, `keyswitch_reference`,
    `rescale_reference`, `decrypt` — host code, for the tests.
  * `basis_from_reference`, `keyswitch_key_from_reference` — carry the
    JAX package's basis and keys across, read duck-typed.

Where the work runs, as in `kernels.ops`: a tensor stays on its device; a
numpy array goes to `device`, by default the card; asked for the card
where there is none, a call raises.  Results are uint32 tensors on that
device.  On a CPU tensor the wrappers run the kernels' plain versions.

Launches per call, with T = `sum(kernels.ntt.launch_plan(n).values())`
the launches of one transform: `ntt_towers` L*T; `poly_mul_towers`,
`ct_mul` and `keyswitch` 2*L*T + L (per tower one forward call, one B3
call, one inverse call); `ct_mul_relin` their sum; `rescale` none.

torch's uint32 has no indexing, copying or arithmetic on the card, so
every layout move (`movedim`, `cat`, `stack`, slicing) goes through the
int32 view and arithmetic through `core.modmath.as_i64` / `to_u32`.

What a call costs, counted always: `HOST_S` holds the host seconds inside
`poly_mul_towers`, `COPY_BYTES` the bytes the tower split (`_split`) and
join (`_join`) copy (`counters`, `reset_counters`).  Under `torch.profiler`
a product call opens the spans `repro_torch.rns.poly_mul_towers` and, in
it, `repro_torch.rns.split`, `repro_torch.rns.towers` (the per-tower loop)
and `repro_torch.rns.join`; the kernel wrappers open their own.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import modmath as mm
from repro_torch.core import ntt
from repro_torch.kernels._build import span, timed_span
from repro_torch.kernels.modmul import modmul_cuda
from repro_torch.kernels.ntt import ntt_cuda
from repro_torch.kernels.ops import _place

#: Host seconds inside `poly_mul_towers`, entry to return, summed over calls.
HOST_S = {"poly_mul_towers": 0.0}
#: Bytes the tower split and join copy, summed over calls: each word a copy
#: writes is read once and written once (8 bytes); no copy, no bytes.
COPY_BYTES = {"split": 0, "join": 0}
_COPY_BYTES_PER_WORD = 8


def counters() -> dict[str, dict]:
    """The op's counters so far: `host_s` (`HOST_S`) and `copy_bytes`
    (`COPY_BYTES`), as copies."""
    return {"host_s": dict(HOST_S), "copy_bytes": dict(COPY_BYTES)}


def reset_counters() -> None:
    """Sets `HOST_S` and `COPY_BYTES` to 0."""
    HOST_S["poly_mul_towers"] = 0.0
    for name in COPY_BYTES:
        COPY_BYTES[name] = 0


# --------------------------------------------------------------------------
# Basis
# --------------------------------------------------------------------------


def rns_primes(n: int, towers: int, bits: int = 31) -> tuple[int, ...]:
    """`towers` distinct primes q = 1 (mod 2n), descending from 2**bits."""
    if towers < 1:
        raise ValueError("towers must be >= 1")
    two_n = 2 * n
    out: list[int] = []
    p = ((1 << bits) - 2) // two_n * two_n + 1
    while len(out) < towers and p > two_n:
        if mm.is_prime(p):
            out.append(p)
        p -= two_n
    if len(out) < towers:
        raise ValueError(f"only {len(out)} NTT-friendly {bits}-bit primes exist for n={n}")
    return tuple(out)


def _host(x) -> np.ndarray:
    """`x` (numpy, or a uint32 tensor on any device) as a numpy array."""
    return mm.to_numpy_u32(x) if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _moduli_on(moduli: tuple[int, ...], device: str) -> torch.Tensor:
    """The moduli as an int64 tensor on `device`, copied there once."""
    return torch.tensor(moduli, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def _rescale_consts(moduli: tuple[int, ...], device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(q_i, q_last^-1 mod q_i) for i < L-1, int64 `[L-1, 1]` on `device`."""
    q_last = moduli[-1]
    q = torch.tensor(moduli[:-1], dtype=torch.int64, device=device)[:, None]
    inv = torch.tensor([mm.inv_mod(q_last % qi, qi) for qi in moduli[:-1]],
                       dtype=torch.int64, device=device)[:, None]
    return q, inv


@dataclasses.dataclass(frozen=True, eq=False)
class RnsBasis:
    """A chain of NTT-friendly moduli with per-tower twiddle contexts.

    Compared by identity (like `NttContext`): `make_basis` memoizes, so
    equal parameters return the same object.
    """

    n: int
    moduli: tuple[int, ...]
    contexts: tuple[ntt.NttContext, ...] = dataclasses.field(repr=False)

    @property
    def towers(self) -> int:
        return len(self.moduli)

    @functools.cached_property
    def modulus(self) -> int:
        """Q = prod(q_i), a python big int."""
        q = 1
        for m in self.moduli:
            q *= m
        return q

    @functools.cached_property
    def _crt(self) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """(Q/q_i, [(Q/q_i)^{-1}]_{q_i}) per tower."""
        hats = tuple(self.modulus // q for q in self.moduli)
        invs = tuple(mm.inv_mod(h % q, q) for h, q in zip(hats, self.moduli))
        return hats, invs

    @functools.cached_property
    def gadget(self) -> tuple[int, ...]:
        """CRT idempotents g_j mod Q: g_j = 1 mod q_j, 0 mod q_{i!=j}."""
        hats, invs = self._crt
        return tuple(h * v % self.modulus for h, v in zip(hats, invs))

    def encode(self, coeffs) -> np.ndarray:
        """Big-int coefficient vector -> residue matrix `[towers, n]` (numpy)."""
        if len(coeffs) != self.n:
            raise ValueError(f"expected {self.n} coefficients, got {len(coeffs)}")
        ints = [int(c) for c in coeffs]
        out = np.empty((self.towers, self.n), np.uint32)
        for i, q in enumerate(self.moduli):
            out[i] = np.array([c % q for c in ints], np.uint32)
        return out

    def decode(self, res) -> list[int]:
        """Residue matrix `[towers, n]` (numpy, or a tensor on any device)
        -> coefficients in [0, Q)."""
        res = _host(res)
        if res.shape != (self.towers, self.n):
            raise ValueError(f"expected shape {(self.towers, self.n)}, got {res.shape}")
        big_q = self.modulus
        out = [0] * self.n
        for i, g in enumerate(self.gadget):
            row = res[i]
            for k in range(self.n):
                out[k] = (out[k] + int(row[k]) * g) % big_q
        return out

    def base_extend(self, res, device=None) -> torch.Tensor:
        """Digit-decompose and extend: `[towers, n]` -> `[towers, towers, n]`.

        Entry `[j, i]` is the tower-j residue, lifted to [0, q_j), reduced
        mod q_i: one int64 broadcast on the tensor's device, exact because
        the lift is already the full integer.
        """
        res = _place(res, device)
        _check_towers(self, res, 2)
        q = _moduli_on(self.moduli, str(res.device))
        return mm.to_u32(mm.as_i64(res)[:, None, :] % q[None, :, None])

    def drop_last(self) -> RnsBasis:
        """The rescale target basis (one fewer tower), memoized."""
        if self.towers < 2:
            raise ValueError("cannot drop the last remaining tower")
        return make_basis(self.n, self.towers - 1, moduli=self.moduli[:-1])


def make_basis(n: int, towers: int, moduli: tuple[int, ...] | None = None) -> RnsBasis:
    """Memoized basis factory (shared twiddle contexts)."""
    if moduli is None:
        moduli = rns_primes(n, towers)
    else:
        moduli = tuple(int(q) for q in moduli)
        if len(moduli) != towers:
            raise ValueError(f"{towers} towers but {len(moduli)} moduli")
        if len(set(moduli)) != len(moduli):
            raise ValueError("moduli must be distinct")
    return _cached_basis(n, moduli)


@functools.lru_cache(maxsize=None)
def _cached_basis(n: int, moduli: tuple[int, ...]) -> RnsBasis:
    contexts = tuple(ntt.make_context(q, n) for q in moduli)
    return RnsBasis(n=n, moduli=moduli, contexts=contexts)


def basis_from_reference(basis) -> RnsBasis:
    """The port's `RnsBasis` from the JAX package's one.

    Read duck-typed (`n`, `moduli`, `contexts`), so nothing of `repro` is
    imported; every context is carried through
    `core.ntt.context_from_reference` and checked against its tower.
    """
    n = int(basis.n)
    moduli = tuple(int(q) for q in basis.moduli)
    if not moduli or len(set(moduli)) != len(moduli):
        raise ValueError(f"moduli must be distinct and non-empty, got {moduli}")
    bad = [q for q in moduli if q % (2 * n) != 1]
    if bad:
        raise ValueError(f"moduli {bad} are not 1 mod 2n = {2 * n}")
    contexts = tuple(ntt.context_from_reference(c) for c in basis.contexts)
    if [(c.q, c.n) for c in contexts] != [(q, n) for q in moduli]:
        raise ValueError("the contexts do not match the moduli and n")
    return RnsBasis(n=n, moduli=moduli, contexts=contexts)


# --------------------------------------------------------------------------
# Tower layout: [..., L, n] <-> per tower one contiguous (rows, n) block
# --------------------------------------------------------------------------


def _check_towers(basis: RnsBasis, x: torch.Tensor, dim: int | None = None) -> None:
    """Raises unless `x` is uint32 towers `[..., L, n]` (of `dim` axes, if given)."""
    if x.dtype != torch.uint32:
        raise TypeError(f"expected uint32 residues, got {x.dtype}")
    if x.dim() < 2 or tuple(x.shape[-2:]) != (basis.towers, basis.n) or dim not in (None, x.dim()):
        axes = "" if dim is None else f" of {dim} axes"
        raise ValueError(f"expected towers [..., {basis.towers}, {basis.n}]{axes}, got {tuple(x.shape)}")


def _rows(t: torch.Tensor, sl) -> torch.Tensor:
    """`t[sl]` of a uint32 tensor, through the int32 view."""
    return t.view(torch.int32)[sl].view(torch.uint32)


def _split(basis: RnsBasis, *xs: torch.Tensor) -> list[torch.Tensor]:
    """Per tower i, the rows `x[..., i, :]` of each of `xs` in order, as one
    contiguous uint32 (rows, n) block: the one copy that moves the tower
    axis to the front (none for a single `[L, n]`).  A broadcast operand's
    rows are written out by the copy, and counted in `COPY_BYTES`."""
    big_l, n = basis.towers, basis.n
    with span("repro_torch.rns.split"):
        parts = []
        for x in xs:
            _check_towers(basis, x)
            parts.append(x.view(torch.int32).movedim(-2, 0).reshape(big_l, -1, n))
        front = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0].contiguous()
        if front.data_ptr() != parts[0].data_ptr():
            COPY_BYTES["split"] += _COPY_BYTES_PER_WORD * front.numel()
        return [front[i].view(torch.uint32) for i in range(big_l)]


def _join(towers: list[torch.Tensor], lead: tuple[int, ...]) -> torch.Tensor:
    """Per-tower (rows, n) blocks -> `[*lead, L, n]`, one copy (counted in
    `COPY_BYTES`)."""
    with span("repro_torch.rns.join"):
        out = torch.stack([t.view(torch.int32) for t in towers], dim=1)
        COPY_BYTES["join"] += _COPY_BYTES_PER_WORD * out.numel()
        return out.reshape(*lead, len(towers), out.shape[-1]).view(torch.uint32)


def _addmod(x: torch.Tensor, y: torch.Tensor, q) -> torch.Tensor:
    return mm.to_u32(mm.addmod_u32(mm.as_i64(x), mm.as_i64(y), q))


# --------------------------------------------------------------------------
# Per-tower ops
# --------------------------------------------------------------------------


def ntt_towers(basis: RnsBasis, x, forward: bool = True, device=None) -> torch.Tensor:
    """Per-tower (inverse) NTT over the trailing two axes `[..., L, n]`:
    one `ntt_cuda` call per tower over all of its rows.  The inverse
    includes the 1/N scaling."""
    x = _place(x, device)
    out = [ntt_cuda(t, ctx, forward) for t, ctx in zip(_split(basis, x), basis.contexts)]
    return _join(out, tuple(x.shape[:-2]))


def _random_poly_np(basis: RnsBasis, seed: int) -> np.ndarray:
    """The reference's `random_poly` draw, as numpy `[towers, n]`."""
    rng = np.random.default_rng(seed)
    out = np.empty((basis.towers, basis.n), np.uint32)
    for i, q in enumerate(basis.moduli):
        out[i] = rng.integers(0, q, basis.n, dtype=np.uint64).astype(np.uint32)
    return out


def random_poly(basis: RnsBasis, seed: int, device=None) -> torch.Tensor:
    """A uniformly random residue matrix `[towers, n]` (a uniform element
    of R_Q by CRT), byte-equal to the reference's for the same seed."""
    return _place(_random_poly_np(basis, seed), device)


def random_ct(basis: RnsBasis, seed: int, k: int = 2, device=None) -> torch.Tensor:
    """A random `k`-component ciphertext `[k, towers, n]`."""
    return _place(np.stack([_random_poly_np(basis, seed * 1000 + c) for c in range(k)]), device)


def make_secret(basis: RnsBasis, seed: int = 0, device=None) -> torch.Tensor:
    """A ternary secret s in {-1, 0, 1}^n, encoded per tower."""
    rng = np.random.default_rng(seed)
    s = rng.integers(-1, 2, basis.n)
    out = np.empty((basis.towers, basis.n), np.uint32)
    for i, q in enumerate(basis.moduli):
        out[i] = np.mod(s, q).astype(np.uint32)
    return _place(out, device)


@timed_span(HOST_S, "poly_mul_towers", "repro_torch.rns.poly_mul_towers")
def poly_mul_towers(basis: RnsBasis, a, b, device=None) -> torch.Tensor:
    """Negacyclic product per tower of `[..., L, n]` operands, broadcast
    against each other as the reference's: per tower one forward call
    over the rows of both, one B3 call, one inverse call.  Each call adds
    its host seconds to `HOST_S`."""
    a = _place(a, device)
    b = _place(b, a.device if device is None else device)
    _check_towers(basis, a)
    _check_towers(basis, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a, b = (x.view(torch.int32).expand(shape).view(torch.uint32) for x in (a, b))
    blocks = _split(basis, a, b)
    out = []
    with span("repro_torch.rns.towers"):
        for t, ctx in zip(blocks, basis.contexts):
            h = ntt_cuda(t, ctx)
            r = h.shape[0] // 2
            out.append(ntt_cuda(modmul_cuda(_rows(h, slice(0, r)), _rows(h, slice(r, None)), ctx),
                                ctx, forward=False))
    return _join(out, tuple(shape[:-2]))


def _ct_pair(basis: RnsBasis, ct_a, ct_b, device) -> tuple[torch.Tensor, torch.Tensor]:
    a = _place(ct_a, device)
    b = _place(ct_b, a.device if device is None else device)
    for name, x in (("ct_a", a), ("ct_b", b)):
        if tuple(x.shape) != (2, basis.towers, basis.n):
            raise ValueError(f"{name} must be [2, {basis.towers}, {basis.n}], got {tuple(x.shape)}")
    return a, b


def _ct_mul_towers(basis: RnsBasis, a: torch.Tensor, b: torch.Tensor) -> list[torch.Tensor]:
    """Per tower (d0, d1, d2) as a (3, n) block: one forward call over
    (a0, a1, b0, b1), one B3 call over the pairs (a0,b0), (a0,b1), (a1,b0),
    (a1,b1), d1 as an addmod, one inverse call over the 3 rows."""
    out = []
    for t, ctx in zip(_split(basis, a, b), basis.contexts):
        h = ntt_cuda(t, ctx).view(torch.int32)
        lhs = h[:2, None].expand(2, 2, h.shape[-1]).reshape(4, -1)  # a0 a0 a1 a1
        rhs = h[2:].repeat(2, 1)  # b0 b1 b0 b1
        p = mm.as_i64(modmul_cuda(lhs.view(torch.uint32), rhs.view(torch.uint32), ctx))
        d = torch.stack([p[0], mm.addmod_u32(p[1], p[2], ctx.q), p[3]])
        out.append(ntt_cuda(mm.to_u32(d), ctx, forward=False))
    return out


def ct_mul(basis: RnsBasis, ct_a, ct_b, device=None) -> torch.Tensor:
    """Tensor two ciphertexts: `[2, L, n]` x `[2, L, n]` -> `[3, L, n]`.

    (a0 + a1 s)(b0 + b1 s) = d0 + d1 s + d2 s^2 with d0 = a0 b0,
    d1 = a0 b1 + a1 b0, d2 = a1 b1.
    """
    a, b = _ct_pair(basis, ct_a, ct_b, device)
    return _join(_ct_mul_towers(basis, a, b), (3,))


@dataclasses.dataclass(frozen=True, eq=False)
class KeySwitchKey:
    """Gadget keyswitch key from `s_from` to `s_to`, zero noise.

    `b[j] = -a[j] s_to + g_j s_from` with uniform `a[j]`: tower i of b[j]
    is `-a[j] s_to + (s_from if i == j else 0)`.  `b` and `a` are uint32
    `[L, L, n]` tensors (digit j, tower i) on one device.  The NTT-domain
    key is computed once, on construction, and stays resident on that
    device in the layout the keyswitch reads (`hat`: per tower i one
    contiguous (2L, n) block, `b_hat[:, i]` then `a_hat[:, i]`), so the
    inner products are one B3 call per tower.  `b_hat` / `a_hat` give it in
    the reference's `[L, L, n]` layout.
    """

    basis: RnsBasis
    b: torch.Tensor
    a: torch.Tensor
    hat: tuple[torch.Tensor, ...] = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        big_l, n = self.basis.towers, self.basis.n
        for name, x in (("b", self.b), ("a", self.a)):
            if x.dtype != torch.uint32 or tuple(x.shape) != (big_l, big_l, n):
                raise ValueError(f"{name} must be uint32 [{big_l}, {big_l}, {n}], "
                                 f"got {x.dtype} {tuple(x.shape)}")
        if self.a.device != self.b.device:
            raise ValueError(f"b is on {self.b.device}, a on {self.a.device}")
        blocks = _split(self.basis, self.b, self.a)
        object.__setattr__(self, "hat", tuple(
            ntt_cuda(t, ctx) for t, ctx in zip(blocks, self.basis.contexts)))

    @property
    def device(self) -> torch.device:
        return self.b.device

    @property
    def b_hat(self) -> torch.Tensor:
        """NTT(b) as `[L, L, n]` (a copy of the resident key)."""
        return _join([_rows(h, slice(0, self.basis.towers)) for h in self.hat], (self.basis.towers,))

    @property
    def a_hat(self) -> torch.Tensor:
        """NTT(a) as `[L, L, n]` (a copy of the resident key)."""
        return _join([_rows(h, slice(self.basis.towers, None)) for h in self.hat], (self.basis.towers,))


def make_keyswitch_key(basis: RnsBasis, s_from, s_to, seed: int = 0, device=None) -> KeySwitchKey:
    """The key from `s_from` to `s_to` on `s_from`'s device (or `device`):
    `a` drawn with numpy as the reference draws it, `b` on the device
    through `poly_mul_towers`."""
    s_from = _place(s_from, device)
    dev = s_from.device
    s_to = _place(s_to, dev)
    _check_towers(basis, s_from, 2)
    a = _place(np.stack([_random_poly_np(basis, seed * 7919 + j) for j in range(basis.towers)]), dev)
    prod = mm.as_i64(poly_mul_towers(basis, a, s_to))  # [j, i, n]
    q = _moduli_on(basis.moduli, str(dev))[None, :, None]
    b = mm.submod_u32(0, prod, q)
    diag = torch.eye(basis.towers, dtype=torch.bool, device=dev)[:, :, None]
    b = torch.where(diag, mm.addmod_u32(b, mm.as_i64(s_from)[None], q), b)
    return KeySwitchKey(basis=basis, b=mm.to_u32(b), a=a)


def relin_key(basis: RnsBasis, s, seed: int = 0, device=None) -> KeySwitchKey:
    """Relinearization key: keyswitch from s^2 to s."""
    s = _place(s, device)
    return make_keyswitch_key(basis, poly_mul_towers(basis, s, s), s, seed=seed)


def keyswitch_key_from_reference(ksk, basis: RnsBasis, device=None) -> KeySwitchKey:
    """The port's key from the JAX package's one (its numpy `b` and `a`),
    placed on `device` (by default the card)."""
    ref = getattr(ksk, "basis", None)
    if ref is not None and (int(ref.n), tuple(int(q) for q in ref.moduli)) != (basis.n, basis.moduli):
        raise ValueError("the key's basis differs from `basis`")
    b = _place(np.asarray(ksk.b), device)
    return KeySwitchKey(basis=basis, b=b, a=_place(np.asarray(ksk.a), b.device))


def _keyswitch_towers(basis: RnsBasis, c2: torch.Tensor, ksk: KeySwitchKey) -> list[torch.Tensor]:
    """Per tower i, (c0', c1') as a (2, n) block: the digits of `c2`
    base-extended on the device (tower-major), one forward call over the L
    digit rows, one B3 call against the resident key, the sum over digits
    in int64 (L residues < 2^31: exact) mod q_i, one inverse call."""
    if ksk.basis.moduli != basis.moduli or ksk.basis.n != basis.n:
        raise ValueError("the key belongs to another basis")
    if ksk.device != c2.device:
        raise ValueError(f"the key is on {ksk.device}, the ciphertext on {c2.device}")
    big_l, n = basis.towers, basis.n
    q = _moduli_on(basis.moduli, str(c2.device))
    digits = mm.to_u32(mm.as_i64(c2)[None, :, :] % q[:, None, None])  # [i, j, n]
    out = []
    for i, (ctx, key) in enumerate(zip(basis.contexts, ksk.hat)):
        dhat = ntt_cuda(_rows(digits, i), ctx).view(torch.int32)
        prod = modmul_cuda(dhat.repeat(2, 1).view(torch.uint32), key, ctx)
        acc = mm.as_i64(prod).view(2, big_l, n).sum(dim=1) % ctx.q
        out.append(ntt_cuda(mm.to_u32(acc), ctx, forward=False))
    return out


def keyswitch(basis: RnsBasis, c2, ksk: KeySwitchKey, device=None) -> torch.Tensor:
    """Switch one polynomial to the key pair: `[L, n]` -> `[2, L, n]`.
    Exact: c0' + c1' s_to = c2 * s_from mod Q."""
    c2 = _place(c2, device)
    _check_towers(basis, c2, 2)
    return _join(_keyswitch_towers(basis, c2, ksk), (2,))


def _relin_towers(basis, d: list[torch.Tensor], c2: torch.Tensor, ksk) -> list[torch.Tensor]:
    ks = _keyswitch_towers(basis, c2, ksk)
    return [_addmod(_rows(t, slice(0, 2)), k, ctx.q) for t, k, ctx in zip(d, ks, basis.contexts)]


def relinearize(basis: RnsBasis, d, ksk: KeySwitchKey, device=None) -> torch.Tensor:
    """Degree-2 -> degree-1: `[3, L, n]` -> `[2, L, n]`."""
    d = _place(d, device)
    if tuple(d.shape) != (3, basis.towers, basis.n):
        raise ValueError(f"d must be [3, {basis.towers}, {basis.n}], got {tuple(d.shape)}")
    return _join(_relin_towers(basis, _split(basis, d), _rows(d, 2), ksk), (2,))


def ct_mul_relin(basis: RnsBasis, ct_a, ct_b, ksk: KeySwitchKey, device=None) -> torch.Tensor:
    """Fused multiply + relinearize: `[2, L, n]` x 2 -> `[2, L, n]`, equal
    to `relinearize(ct_mul(...))`; d stays per tower between the two."""
    a, b = _ct_pair(basis, ct_a, ct_b, device)
    d = _ct_mul_towers(basis, a, b)
    c2 = torch.stack([t.view(torch.int32)[2] for t in d]).view(torch.uint32)
    return _join(_relin_towers(basis, d, c2, ksk), (2,))


def rescale(basis: RnsBasis, ct, device=None) -> torch.Tensor:
    """Exact mod-down by q_last: `[..., L, n]` -> `[..., L-1, n]`.

    c'_i = (c_i - [c]_{q_last}) * q_last^{-1} mod q_i, in int64 torch ops
    (the product is below 2^62); no kernel is launched.
    """
    ct = _place(ct, device)
    _check_towers(basis, ct)
    q, inv = _rescale_consts(basis.moduli, str(ct.device))
    x = mm.as_i64(ct)
    last = x[..., -1:, :] % q
    return mm.to_u32(mm.submod_u32(x[..., :-1, :], last, q) * inv % q)


# --------------------------------------------------------------------------
# Big-int CRT references (the differential oracle; host code)
# --------------------------------------------------------------------------


def _poly_mul_int(a: list[int], b: list[int], n: int, big_q: int) -> list[int]:
    """Negacyclic schoolbook over python ints mod Q (x^n = -1)."""
    out = [0] * n
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            k = i + j
            if k < n:
                out[k] += ai * bj
            else:
                out[k - n] -= ai * bj
    return [x % big_q for x in out]


def ct_mul_reference(basis: RnsBasis, ct_a, ct_b) -> np.ndarray:
    """Big-int oracle for `ct_mul` (O(n^2) schoolbook mod Q)."""
    big_q, n = basis.modulus, basis.n
    a0, a1 = (basis.decode(c) for c in _host(ct_a))
    b0, b1 = (basis.decode(c) for c in _host(ct_b))
    d0 = _poly_mul_int(a0, b0, n, big_q)
    d1 = [(x + y) % big_q for x, y in zip(_poly_mul_int(a0, b1, n, big_q),
                                          _poly_mul_int(a1, b0, n, big_q))]
    d2 = _poly_mul_int(a1, b1, n, big_q)
    return np.stack([basis.encode(d) for d in (d0, d1, d2)])


def keyswitch_reference(basis: RnsBasis, c2, ksk: KeySwitchKey) -> np.ndarray:
    """Big-int oracle for `keyswitch`: sum_j D_j * (b_j, a_j) mod Q."""
    big_q, n = basis.modulus, basis.n
    res, kb, ka = _host(c2), _host(ksk.b), _host(ksk.a)
    c0 = [0] * n
    c1 = [0] * n
    for j in range(basis.towers):
        digit = [int(v) for v in res[j]]  # the lift, already in [0, q_j)
        pb = _poly_mul_int(digit, basis.decode(kb[j]), n, big_q)
        pa = _poly_mul_int(digit, basis.decode(ka[j]), n, big_q)
        c0 = [(x + y) % big_q for x, y in zip(c0, pb)]
        c1 = [(x + y) % big_q for x, y in zip(c1, pa)]
    return np.stack([basis.encode(c0), basis.encode(c1)])


def rescale_reference(basis: RnsBasis, ct) -> np.ndarray:
    """Big-int oracle for `rescale`: (v - [v]_{q_last}) / q_last mod Q'."""
    ct = _host(ct)
    sub = basis.drop_last()
    q_last = basis.moduli[-1]
    out = []
    for comp in ct:
        v = basis.decode(comp)
        scaled = [((x - int(r)) // q_last) % sub.modulus for x, r in zip(v, comp[-1])]
        out.append(sub.encode(scaled))
    return np.stack(out)


def decrypt(basis: RnsBasis, ct, s) -> list[int]:
    """c0 + c1 s (+ c2 s^2) mod Q over python ints: the test probe that
    shows keyswitch / relinearize preserve the encrypted value."""
    big_q, n = basis.modulus, basis.n
    ct = _host(ct)
    s_int = basis.decode(s)
    out = basis.decode(ct[0])
    pw = s_int
    for comp in ct[1:]:
        term = _poly_mul_int(basis.decode(comp), pw, n, big_q)
        out = [(x + y) % big_q for x, y in zip(out, term)]
        pw = _poly_mul_int(pw, s_int, n, big_q)
    return out
