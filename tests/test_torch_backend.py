"""The port's `NttBackend` lanes against every lane of the JAX package's.

The port's `reference` lane (numpy stage loop), its `pim-sim` lane (the
row-centric bank's functional model) and its `cuda` lane with
`device="cpu"` (the kernels' plain versions) must agree bit for bit with
every lane of `repro.kernels.backend.available_backends()` — reference,
pim-sim and pallas (interpret mode) — on the same inputs.
"""
import numpy as np
import pytest

from repro.kernels.backend import available_backends as ref_backends
from repro.kernels.backend import get_backend as ref_get_backend
from repro_torch.core import modmath as mm
from repro_torch.kernels.backend import BACKEND_NAMES, available_backends, get_backend

Q = mm.DEFAULT_Q


def rand(shape, seed=42):
    return np.random.default_rng(seed).integers(0, Q, shape).astype(np.uint32)


def port_lanes():
    return [get_backend("reference"), get_backend("cuda", device="cpu")]


def all_port_lanes():
    return port_lanes() + [get_backend("pim-sim")]


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [256, 1024])
def test_port_lanes_match_every_reference_lane(n, forward):
    x = rand((2, n), seed=n + forward)
    ran = []
    for ref_lane in ref_backends():
        exp = ref_lane.ntt(x, forward=forward)
        for lane in all_port_lanes():
            got = lane.ntt(x, forward=forward)
            assert got.dtype == np.uint32
            assert np.array_equal(got, exp), (lane.name, ref_lane.name, n, forward)
        ran.append(ref_lane.name)
    assert {"reference", "pim-sim", "pallas"} <= set(ran)


def test_registry_names_and_errors():
    assert BACKEND_NAMES == ("reference", "pim-sim", "cuda")
    with pytest.raises(ValueError, match="unknown NTT backend"):
        get_backend("pallas")


def test_available_backends_follow_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert [b.name for b in available_backends()] == ["reference", "pim-sim"]
    assert not get_backend("cuda").available()
    assert get_backend("cuda", device="cpu").available()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert [b.name for b in available_backends()] == ["reference", "pim-sim", "cuda"]


def test_roundtrip_and_1d():
    x = rand(512)
    for lane in all_port_lanes():
        back = lane.ntt(lane.ntt(x, forward=True), forward=False)
        assert back.shape == (512,)
        assert np.array_equal(back, x), lane.name


def test_input_validation():
    for lane in port_lanes():
        with pytest.raises(ValueError, match="power of two"):
            lane.ntt(np.zeros(100, np.uint32))
        with pytest.raises(ValueError, match="expected"):
            lane.ntt(np.zeros((2, 2, 2), np.uint32))
        assert lane.modeled_latency_ns(1024) is None


def test_context_cached_per_lane():
    lane = get_backend("cuda", device="cpu")
    assert lane.context(Q, 256) is lane.context(Q, 256)


@pytest.mark.parametrize("forward", [True, False])
def test_pim_sim_latency_matches_reference(forward):
    lane = get_backend("pim-sim")
    ns = lane.modeled_latency_ns(1024, forward=forward)
    assert ns == ref_get_backend("pim-sim").modeled_latency_ns(1024, forward=forward)
    assert lane.modeled_latency_ns(1024, forward=forward) is ns  # cached per (n, direction)
