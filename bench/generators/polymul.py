"""The general generator of `polymul` traffic: RNS products through the
program's `repro_torch.he.poly_mul_towers`.

A mix gives `products_per_call` (B), `shared_operand` (0: B pairs a call;
1: one b of one row against B rows of a, broadcast as `relin_key` calls
it), `operand_sets`, `inflight`, `warmup_calls`, `check_products` and
`trace_calls`.  The operands are uint32 residues [B, L, N], uniform in
[0, q_i), drawn on the device from the seed in one call per operand;
call i uses set i mod `operand_sets`.

The check: a reservoir of `check_products` products, drawn uniformly from
every product the window produced (the draws from the seed), is copied
aside as the calls return.  Once the window has closed, the operands are
drawn again from the seed and the configuration's reference recomputes
each kept product from them; every residue is compared.
"""
from __future__ import annotations

import time

import numpy as np
import torch

CHECK_BLOCK = 16  # products the reference takes at a time


def make_operands(config: dict, mix: dict, seed: int, device: torch.device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """`operand_sets` pairs (a, b) of uint32 residues on `device`, from `seed`."""
    n, towers, rows = config["n"], config["towers"], mix["products_per_call"]
    q = torch.tensor(config["moduli"], dtype=torch.int64, device=device).view(1, towers, 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    sets = []
    for _ in range(mix["operand_sets"]):
        pair = []
        for count in (rows, 1 if mix["shared_operand"] else rows):
            x = torch.randint(0, 1 << 62, (count, towers, n), generator=gen, device=device, dtype=torch.int64)
            pair.append(x.remainder_(q).to(torch.int32).view(torch.uint32))
            del x
        sets.append(tuple(pair))
    return sets


class Polymul:
    """One cell's calls into the program, and the check of what they returned."""

    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device, reference, system=None):
        from repro_torch import he, kernels

        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.reference = reference
        self._he, self._kernels, self._system = he, kernels, system
        self.products_per_call = mix["products_per_call"]
        t0 = time.perf_counter()
        self.basis = he.make_basis(config["n"], config["towers"], moduli=tuple(config["moduli"]))
        t1 = time.perf_counter()
        self.sets = make_operands(config, mix, seed, device)
        self.phases = {"basis_s": t1 - t0, "operands_s": time.perf_counter() - t1}  # set-up, by part
        slots = mix["check_products"]
        self.kept = torch.zeros((slots, config["towers"], config["n"]), dtype=torch.int32, device=device)
        self.origin: list[tuple[int, int] | None] = [None] * slots  # (call, product)
        self.rng = np.random.default_rng([seed % (1 << 64), 0x5A11])
        self.seen = 0
        self.failed = 0

    def launches(self) -> dict[str, int]:
        """The program's own count of its kernel launches, by kernel."""
        return self._kernels.launch_counts()

    def issue(self, i: int) -> torch.Tensor:
        a, b = self.sets[i % len(self.sets)]
        system = self._system or self._he.poly_mul_towers
        return system(self.basis, a, b)

    def warm(self, i: int, out: torch.Tensor) -> None:
        """The copy that `keep` makes, into a slot the window overwrites."""
        self.kept[0].copy_(out.view(torch.int32)[0])

    def keep(self, i: int, out: torch.Tensor) -> None:
        """Algorithm R over every product so far: product t takes slot t while
        t < slots, else slot j for a draw j <= t, where j < slots."""
        slots, rows = len(self.origin), self.products_per_call
        t = self.seen + np.arange(rows)
        draw = self.rng.integers(0, t + 1)
        take = np.where(t < slots, t, draw)
        hits = {int(take[p]): int(p) for p in np.flatnonzero(take < slots)}  # the last draw wins
        words = out.view(torch.int32)
        for slot, p in hits.items():
            self.kept[slot].copy_(words[p])
            self.origin[slot] = (i, p)
        self.seen += rows

    def verify(self) -> dict[str, dict]:
        """Each kept product against the reference, on operands drawn again
        once the program's operands are dropped."""
        self.sets = self.basis = None
        filled = [s for s, o in enumerate(self.origin) if o is not None]
        wrong = 0
        if filled:
            sets = make_operands(self.config, self.mix, self.seed, self.device)
            shared = bool(self.mix["shared_operand"])
            pairs = [(sets[i % len(sets)], p) for i, p in (self.origin[s] for s in filled)]
            a = torch.stack([pair[0].view(torch.int32)[p] for pair, p in pairs])
            b = torch.stack([pair[1].view(torch.int32)[0 if shared else p] for pair, p in pairs])
            del sets, pairs
            for lo in range(0, len(filled), CHECK_BLOCK):
                idx = filled[lo:lo + CHECK_BLOCK]
                ref = self.reference.poly_mul(a[lo:lo + CHECK_BLOCK].long(), b[lo:lo + CHECK_BLOCK].long(),
                                              self.config["moduli"])
                diff = ref != self.kept[idx].long()
                wrong += int(diff.sum())
                self.failed += int(diff.flatten(1).any(1).sum())
        return {"wrong_residues": {"value": wrong, "limit": 0},
                "unchecked_products": {"value": len(self.origin) - len(filled), "limit": 0}}


def build(config: dict, mix: dict, seed: int, device: torch.device, reference, system=None) -> Polymul:
    return Polymul(config, mix, seed, device, reference, system)
