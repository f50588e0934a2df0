"""`correct` comes out false where it should: for the control (the
reference in the program's place, computed in float64), and for each fault
that a polymul cell can have, planted under a run on the CPU at a small
size.  The sound program comes out true on the same seeds.  (One card, so
no exchange between chips to leave out.)"""
import pytest
import torch

import benchtest
from benchlib.spec import Spec

CELLS = ["n15l28.polymul", "n13l7.polymul"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = benchtest.copy_benchmark(tmp_path_factory.mktemp("bench"))
    benchtest.shrink(root)
    return root


def moduli(root, cell):
    spec = Spec(root)
    return spec.config(spec.cell(cell)["config"])["moduli"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(tiny, cell):
    assert benchtest.run_on_cpu(tiny, cell, seed=2**31 + 101)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_float64_is_not_correct(tiny, cell):
    spec = Spec(tiny)
    system = spec.reference("rns_negacyclic").as_system(moduli(tiny, cell), "float64")
    result = benchtest.run_on_cpu(tiny, cell, seed=2**31 + 101, system=system)
    slots, t = benchtest.TINY["check_products"], benchtest.TINY
    assert not result["correct"]
    assert result["checks"]["wrong_residues"]["value"] > 0.9 * slots * t["towers"] * t["n"]
    assert result["failed"] == slots


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_int64_is_correct(tiny, cell):
    """The reference itself, in the program's place at its own precision."""
    system = Spec(tiny).reference("rns_negacyclic").as_system(moduli(tiny, cell), "int64")
    assert benchtest.run_on_cpu(tiny, cell, seed=2**31 + 101, system=system)["correct"]


def unchanged(basis, a, b):
    """A step that returns its state unchanged."""
    return a.view(torch.int32).clone().view(torch.uint32)


def half_the_batch(basis, a, b):
    """Half the products left out: the rest computed, these left zero."""
    from repro_torch import he

    half = a.shape[0] // 2
    out = torch.zeros(a.shape, dtype=torch.int32)
    rows = b if b.shape[0] == 1 else b.view(torch.int32)[:half].view(torch.uint32)
    out[:half] = he.rns.poly_mul_towers(basis, a.view(torch.int32)[:half].view(torch.uint32), rows).view(torch.int32)
    return out.view(torch.uint32)


@pytest.mark.parametrize("fault", [unchanged, half_the_batch])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny, cell, fault, monkeypatch):
    from repro_torch import he

    monkeypatch.setattr(he, "poly_mul_towers", fault)
    result = benchtest.run_on_cpu(tiny, cell, seed=2**31 + 101)
    assert not result["correct"] and result["checks"]["wrong_residues"]["value"] > 0, result


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_is_not_correct(tiny, cell, monkeypatch):
    """One residue a tower of every product, altered as the inverse
    transform writes it."""
    from repro_torch.he import rns

    real = rns.ntt_cuda

    def altered(x, ctx, forward=True, tile=None):
        out = real(x, ctx, forward, tile)
        if not forward:
            words = out.view(torch.int32)
            words[:, 0] = (words[:, 0] + 1) % ctx.q
        return out

    monkeypatch.setattr(rns, "ntt_cuda", altered)
    result = benchtest.run_on_cpu(tiny, cell, seed=2**31 + 101)
    t = benchtest.TINY
    assert not result["correct"]
    assert result["checks"]["wrong_residues"]["value"] == t["check_products"] * t["towers"]
