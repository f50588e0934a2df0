"""The `polymul` mix on the CPU, through the kernels' plain versions, at a
small N: the program agrees with the benchmark's reference, and the
reference agrees with schoolbook products."""
import json

import numpy as np
import pytest
import torch

import benchtest
from benchlib.spec import Spec

MODULI = (2147352577, 2146959361, 2121793537)


def schoolbook(a, b, q):
    n = len(a)
    out = [0] * n
    for i in range(n):
        for j in range(n):
            sign = 1 if i + j < n else -1
            out[(i + j) % n] += sign * int(a[i]) * int(b[j])
    return [x % q for x in out]


@pytest.fixture(scope="module")
def reference():
    return Spec(benchtest.ROOT).reference("rns_negacyclic")


@pytest.mark.parametrize("n", [1, 2, 8, 32])
def test_reference_equals_schoolbook(reference, n):
    rng = np.random.default_rng(n)
    a = np.stack([[rng.integers(0, q, n) for q in MODULI] for _ in range(2)])
    b = np.stack([[rng.integers(0, q, n) for q in MODULI] for _ in range(2)])
    got = reference.poly_mul(torch.tensor(a), torch.tensor(b), MODULI)
    for s in range(2):
        for t, q in enumerate(MODULI):
            assert got[s, t].tolist() == schoolbook(a[s, t], b[s, t], q)


def test_reference_broadcasts_a_shared_operand(reference):
    rng = np.random.default_rng(3)
    a = torch.tensor(np.stack([[rng.integers(0, q, 16) for q in MODULI] for _ in range(3)]))
    b = torch.tensor(np.stack([[rng.integers(0, q, 16) for q in MODULI]]))
    assert torch.equal(reference.poly_mul(a, b, MODULI), reference.poly_mul(a, b.expand_as(a), MODULI))


def test_reference_refuses_a_modulus_without_its_roots(reference):
    with pytest.raises(ValueError):
        reference.poly_mul(torch.zeros(1, 1, 8, dtype=torch.int64), torch.zeros(1, 1, 8, dtype=torch.int64),
                           (2147352577 - 16,))


@pytest.fixture
def tiny(tmp_path):
    root = benchtest.copy_benchmark(tmp_path)
    benchtest.shrink(root)
    return root


def set_mix(root, cell, **params):
    spec = Spec(root)
    path = root / "bench" / "traffic" / f"{spec.cell(cell)['traffic']}.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **params}))


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("cell", ["n15l28.polymul", "n13l7.polymul"])
def test_the_mix_agrees_with_the_reference(tiny, cell, shared):
    set_mix(tiny, cell, shared_operand=shared)
    result = benchtest.run_on_cpu(tiny, cell, seed=2**31 + 11)
    assert result["correct"], result
    assert result["checks"] == {"wrong_residues": {"value": 0, "limit": 0},
                                "unchecked_products": {"value": 0, "limit": 0}}
    assert result["attempted"] > 0 and result["attempted"] % benchtest.TINY["products_per_call"] == 0
    assert result["failed"] == 0
    assert set(result["metrics"]) == {"polymul_per_s", "setup_s"}
    assert list(result)[-1] == "checks"


def test_operands_follow_the_seed(tiny):
    spec = Spec(tiny)
    cell = spec.cell("n13l7.polymul")
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    gen = spec.generator(mix["generator"])
    one, again, other = (gen.make_operands(config, mix, s, torch.device("cpu")) for s in (2**33 + 1, 2**33 + 1, 5))
    for (a1, b1), (a2, b2), (a3, _) in zip(one, again, other):
        assert torch.equal(a1.view(torch.int32), a2.view(torch.int32))
        assert torch.equal(b1.view(torch.int32), b2.view(torch.int32))
        assert not torch.equal(a1.view(torch.int32), a3.view(torch.int32))
        q = torch.tensor(config["moduli"]).view(1, -1, 1)
        assert bool(((a1.view(torch.int32).long() < q) & (a1.view(torch.int32) >= 0)).all())
    assert not torch.equal(one[0][0].view(torch.int32), one[1][0].view(torch.int32))


def test_the_sample_is_drawn_from_every_call(tiny):
    """Algorithm R keeps products from late calls too, and the same seed
    keeps the same products."""
    spec = Spec(tiny)
    cell = spec.cell("n13l7.polymul")
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    gen = spec.generator(mix["generator"])
    rows = mix["products_per_call"]
    origins = []
    for _ in range(2):
        w = gen.build(config, mix, 77, torch.device("cpu"), spec.reference(config["reference"]))
        for i in range(40):
            w.keep(i, torch.zeros((rows, config["towers"], config["n"]), dtype=torch.int32).view(torch.uint32))
        origins.append(list(w.origin))
    assert origins[0] == origins[1]
    assert len(set(origins[0])) == len(origins[0]) == mix["check_products"]
    assert max(call for call, _ in origins[0]) >= 20
