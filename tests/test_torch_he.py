"""The port's RNS-CKKS layer (`repro_torch.he`) on the CPU against the JAX
package's `repro.he.rns`, bit for bit, and against its big-int oracles.

Inputs are drawn with numpy from fixed seeds (the port's draws are the
reference's, byte for byte) and go to both packages; on CPU tensors every
kernel wrapper runs its plain torch version.  CRT coefficients are drawn
as python ints (`random.Random(seed).randrange(Q)`): Q is beyond int64
from 3 towers on.
"""
import importlib.util
import pathlib
import random

import numpy as np
import pytest
import torch

import repro.he.rns as R
from hypo import given, settings, st
from repro_torch import he, kernels
from repro_torch.core import modmath as mm
from repro_torch.core import ntt as ntt_core
from repro_torch.he import rns
from repro_torch.kernels import ntt as kntt

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 64
LEVELS = [2, 4, 8]
CPU = "cpu"


def host(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.uint32 and t.device.type == CPU
    return mm.to_numpy_u32(t)


def bases(n, towers):
    return R.make_basis(n, towers), he.make_basis(n, towers)


def keys(rb, pb, seed=7):
    s = R.make_secret(rb, 0)
    return s, R.relin_key(rb, s, seed=seed), he.relin_key(pb, s, seed=seed, device=CPU)


# ---------------------------------------------------------------------------
# basis, draws, CRT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("towers", LEVELS)
def test_basis_matches_reference(towers):
    rb, pb = bases(N, towers)
    assert pb.moduli == rb.moduli == rns.rns_primes(N, towers)
    assert (pb.modulus, pb.gadget) == (rb.modulus, rb.gadget)
    for pc, rc in zip(pb.contexts, rb.contexts):
        for f in ("psi_brv", "psi_brv_shoup", "psi_inv_brv", "psi_inv_brv_shoup"):
            np.testing.assert_array_equal(getattr(pc, f), getattr(rc, f))
    assert he.make_basis(N, towers) is pb
    assert pb.drop_last() is he.make_basis(N, towers - 1)


def test_rns_primes_at_logn16():
    assert he.rns_primes(65536, 16) == R.rns_primes(65536, 16)
    assert he.rns_primes(65536, 16)[0] == 2147352577


@pytest.mark.parametrize("towers", LEVELS)
def test_random_draws_byte_equal(towers):
    rb, pb = bases(N, towers)
    np.testing.assert_array_equal(host(he.random_poly(pb, 11, device=CPU)), R.random_poly(rb, 11))
    np.testing.assert_array_equal(host(he.random_ct(pb, 3, k=3, device=CPU)), R.random_ct(rb, 3, k=3))
    np.testing.assert_array_equal(host(he.make_secret(pb, 5, device=CPU)), R.make_secret(rb, 5))


@pytest.mark.parametrize("towers", LEVELS)
def test_encode_decode(towers):
    rb, pb = bases(N, towers)
    gen = random.Random(towers)
    coeffs = [gen.randrange(pb.modulus) for _ in range(N)]
    res = pb.encode(coeffs)
    np.testing.assert_array_equal(res, rb.encode(coeffs))
    assert pb.decode(torch.from_numpy(res.view(np.int32)).view(torch.uint32)) == coeffs
    assert pb.decode(res) == rb.decode(res) == coeffs


@pytest.mark.parametrize("towers", LEVELS)
def test_base_extend(towers):
    rb, pb = bases(N, towers)
    c = R.random_poly(rb, 9)
    got = pb.base_extend(c, device=CPU)
    assert got.shape == (towers, towers, N)
    np.testing.assert_array_equal(host(got), rb.base_extend(c))


# ---------------------------------------------------------------------------
# tower ops against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("towers", LEVELS)
def test_ntt_towers_both_directions(towers):
    rb, pb = bases(N, towers)
    x = R.random_ct(rb, 4, k=3).reshape(3, 1, towers, N)  # leading axes
    fwd = he.ntt_towers(pb, x, device=CPU)
    np.testing.assert_array_equal(host(fwd), R.ntt_towers(rb, x))
    inv = he.ntt_towers(pb, x, forward=False, device=CPU)
    np.testing.assert_array_equal(host(inv), R.ntt_towers(rb, x, forward=False))
    np.testing.assert_array_equal(host(he.ntt_towers(pb, fwd, forward=False)), x)


@pytest.mark.parametrize("towers", LEVELS)
def test_poly_mul_towers(towers):
    rb, pb = bases(N, towers)
    a, b = R.random_ct(rb, 1), R.random_poly(rb, 2)
    got = he.poly_mul_towers(pb, a, b, device=CPU)  # b broadcast over a's components
    np.testing.assert_array_equal(host(got), np.stack([R.poly_mul_towers(rb, a[k], b) for k in range(2)]))


@pytest.mark.parametrize("towers", LEVELS)
def test_ct_mul(towers):
    rb, pb = bases(N, towers)
    a, b = R.random_ct(rb, 1), R.random_ct(rb, 2)
    got = host(he.ct_mul(pb, a, b, device=CPU))
    np.testing.assert_array_equal(got, R.ct_mul(rb, a, b))
    np.testing.assert_array_equal(got, he.ct_mul_reference(pb, a, b))


@pytest.mark.parametrize("towers", LEVELS)
def test_keyswitch_keys_byte_equal(towers):
    rb, pb = bases(N, towers)
    s_from, s_to = R.make_secret(rb, 1), R.make_secret(rb, 0)
    pairs = [(R.make_keyswitch_key(rb, s_from, s_to, seed=3),
              he.make_keyswitch_key(pb, s_from, s_to, seed=3, device=CPU)), keys(rb, pb)[1:]]
    for rk, pk in pairs:
        for f in ("b", "a", "b_hat", "a_hat"):
            np.testing.assert_array_equal(host(getattr(pk, f)), getattr(rk, f), err_msg=f)
        assert all(h.shape == (2 * towers, N) and h.is_contiguous() for h in pk.hat)


@pytest.mark.parametrize("towers", LEVELS)
def test_keyswitch(towers):
    rb, pb = bases(N, towers)
    s_from, s_to = R.make_secret(rb, 1), R.make_secret(rb, 0)
    rk = R.make_keyswitch_key(rb, s_from, s_to, seed=3)
    pk = he.make_keyswitch_key(pb, s_from, s_to, seed=3, device=CPU)
    c2 = R.random_poly(rb, 9)
    got = host(he.keyswitch(pb, c2, pk, device=CPU))
    np.testing.assert_array_equal(got, R.keyswitch(rb, c2, rk))
    np.testing.assert_array_equal(got, he.keyswitch_reference(pb, c2, pk))


@pytest.mark.parametrize("towers", LEVELS)
def test_relinearize(towers):
    rb, pb = bases(N, towers)
    s, rk, pk = keys(rb, pb)
    d = R.ct_mul(rb, R.random_ct(rb, 4), R.random_ct(rb, 5))
    got = he.relinearize(pb, d, pk, device=CPU)
    np.testing.assert_array_equal(host(got), R.relinearize(rb, d, rk))
    assert he.decrypt(pb, got, s) == he.decrypt(pb, d, s) == R.decrypt(rb, d, s)


@pytest.mark.parametrize("towers", LEVELS)
def test_ct_mul_relin(towers):
    rb, pb = bases(N, towers)
    _, rk, pk = keys(rb, pb)
    a, b = R.random_ct(rb, 4), R.random_ct(rb, 5)
    got = host(he.ct_mul_relin(pb, a, b, pk, device=CPU))
    np.testing.assert_array_equal(got, R.ct_mul_relin(rb, a, b, rk))
    np.testing.assert_array_equal(got, host(he.relinearize(pb, he.ct_mul(pb, a, b, device=CPU), pk)))


@pytest.mark.parametrize("towers", LEVELS)
def test_rescale(towers):
    rb, pb = bases(N, towers)
    ct = R.random_ct(rb, 6)
    got = host(he.rescale(pb, ct, device=CPU))
    assert got.shape == (2, towers - 1, N)
    np.testing.assert_array_equal(got, R.rescale(rb, ct))
    np.testing.assert_array_equal(got, he.rescale_reference(pb, ct))


def test_two_regime_n16384():
    """n = 16384 > the default tile of 8192: every transform runs B2's
    plain version and the packed B1 tile pass."""
    n, towers = 16384, 2
    assert kntt.inter_groups(n, kntt.resolve_tile(None, n), True)
    rb, pb = bases(n, towers)
    a, b = R.random_ct(rb, 1), R.random_ct(rb, 2)
    np.testing.assert_array_equal(host(he.ntt_towers(pb, a, device=CPU)), R.ntt_towers(rb, a))
    np.testing.assert_array_equal(host(he.ntt_towers(pb, a, forward=False, device=CPU)),
                                  R.ntt_towers(rb, a, forward=False))
    np.testing.assert_array_equal(host(he.ct_mul(pb, a, b, device=CPU)), R.ct_mul(rb, a, b))


# ---------------------------------------------------------------------------
# carrying the reference's basis and keys across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("towers", LEVELS)
def test_basis_and_key_from_reference(towers):
    rb, pb = bases(N, towers)
    carried = he.basis_from_reference(rb)
    assert carried.moduli == rb.moduli and carried.n == N and carried.gadget == rb.gadget
    for cc, pc in zip(carried.contexts, pb.contexts):
        np.testing.assert_array_equal(cc.psi_brv, pc.psi_brv)
        assert (cc.q, cc.n, cc.n_inv_shoup, cc.qprime) == (pc.q, pc.n, pc.n_inv_shoup, pc.qprime)
    _, rk, pk = keys(rb, pb)
    ck = he.keyswitch_key_from_reference(rk, carried, device=CPU)
    for f in ("b", "a", "b_hat", "a_hat"):
        np.testing.assert_array_equal(host(getattr(ck, f)), getattr(rk, f), err_msg=f)
    c2 = R.random_poly(rb, 3)
    np.testing.assert_array_equal(host(he.keyswitch(carried, c2, ck, device=CPU)), R.keyswitch(rb, c2, rk))
    # and back: the port's key read as the reference's
    back = R.KeySwitchKey(basis=rb, b=host(pk.b), a=host(pk.a))
    np.testing.assert_array_equal(back.b_hat, host(pk.b_hat))
    np.testing.assert_array_equal(R.keyswitch(rb, c2, back), host(he.keyswitch(pb, c2, pk, device=CPU)))


def test_from_reference_rejects_mismatches():
    rb, pb = bases(N, 3)
    other = R.make_basis(N, 2)
    with pytest.raises(ValueError, match="another basis|differs"):
        he.keyswitch_key_from_reference(R.relin_key(other, R.make_secret(other, 0)), pb, device=CPU)

    class Bad:
        n, moduli, contexts = N, rb.moduli, rb.contexts[::-1]

    with pytest.raises(ValueError, match="contexts"):
        he.basis_from_reference(Bad)


# ---------------------------------------------------------------------------
# devices, shapes, launches
# ---------------------------------------------------------------------------


def test_numpy_input_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rb, pb = bases(N, 2)
    ct = R.random_ct(rb, 1)
    for call in (lambda: he.ntt_towers(pb, ct), lambda: he.ct_mul(pb, ct, ct),
                 lambda: he.rescale(pb, ct), lambda: he.random_ct(pb, 1),
                 lambda: he.relin_key(pb, R.make_secret(rb, 0)), lambda: pb.base_extend(ct[0])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_bad_shapes_and_devices_raise():
    rb, pb = bases(N, 3)
    ct = he.random_ct(pb, 1, device=CPU)
    with pytest.raises(ValueError, match="towers"):
        he.ntt_towers(pb, ct[..., :32])
    with pytest.raises(ValueError, match=r"\[2, 3, 64\]"):
        he.ct_mul(pb, ct[:1], ct)
    with pytest.raises(TypeError, match="uint32"):
        he.rescale(pb, ct.view(torch.int32))
    _, _, pk = keys(rb, pb)
    with pytest.raises(ValueError, match="another basis"):
        he.keyswitch(he.make_basis(N, 2), he.random_poly(he.make_basis(N, 2), 1, device=CPU), pk)
    with pytest.raises(ValueError, match=r"\[3, 3, 64\]"):
        he.KeySwitchKey(pb, pk.b[:2], pk.a)


def test_cpu_tensors_stay_on_cpu_and_launch_nothing():
    rb, pb = bases(N, 2)
    _, _, pk = keys(rb, pb)
    kernels.reset_launch_counts()
    ct = he.random_ct(pb, 1, device=CPU)
    out = he.rescale(pb, he.ct_mul_relin(pb, ct, ct, pk))
    assert out.device.type == CPU and out.dtype == torch.uint32
    assert kernels.launch_counts() == {"ntt_tile": 0, "ntt_pair": 0, "modmul": 0}


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,towers", [(1024, 3), (16384, 2)])
def test_launch_formula_counts_wrapper_calls(monkeypatch, n, towers):
    """chip_smoke.py's `rns_launches` against the wrapper calls each op makes
    (counted on the CPU, where the wrappers run the plain versions)."""
    cs = _load_chip_smoke()
    calls = {"ntt_tile": 0, "ntt_pair": 0, "modmul": 0}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(kntt, "_tile_pass", counting("ntt_tile", kntt._tile_pass))
    monkeypatch.setattr(kntt, "_pair_pass", counting("ntt_pair", kntt._pair_pass))
    monkeypatch.setattr(rns, "modmul_cuda", counting("modmul", rns.modmul_cuda))
    pb = he.make_basis(n, towers)
    s = he.make_secret(pb, 0, device=CPU)
    ct = he.random_ct(pb, 1, device=CPU)
    ops = {"relin_key": lambda: he.relin_key(pb, s, seed=1)}
    rlk = ops["relin_key"]()
    ops.update(ct_mul=lambda: he.ct_mul(pb, ct, ct), keyswitch=lambda: he.keyswitch(pb, ct[1], rlk),
               ct_mul_relin=lambda: he.ct_mul_relin(pb, ct, ct, rlk), rescale=lambda: he.rescale(pb, ct))
    plan = kntt.launch_plan(n)
    for op, fn in ops.items():
        for k in calls:
            calls[k] = 0
        fn()
        assert calls == cs.rns_launches(n, towers, op), op
    per = cs.rns_launches(n, towers, "ct_mul")
    assert per == {"ntt_tile": 2 * towers * plan["ntt_tile"], "ntt_pair": 2 * towers * plan["ntt_pair"],
                   "modmul": towers}


def test_chip_smoke_rns_phase_on_cpu():
    """The rns phase of chip_smoke.py rehearsed on the CPU at a small size."""
    cs = _load_chip_smoke()
    report = cs.drive_rns("cpu", n=1024, towers=3)
    assert all(report["cpu_bit_exact"].values()) and report["roundtrip"]
    assert [c["tower"] for c in report["identity"]] == [0, 1, 2]
    assert report["expected_launches"] == cs.rns_launches(1024, 3)
    plan = kntt.launch_plan(1024)
    assert report["expected_launches"] == {"ntt_tile": 4 * 3 * plan["ntt_tile"], "ntt_pair": 0, "modmul": 6}
    assert cs.rns_launches(65536, 16) == {"ntt_tile": 64, "ntt_pair": 64, "modmul": 32}
    assert cs.rns_work("ct_mul_relin", 16)["elementwise"] == 16 * (6 * 16 + 42)


# ---------------------------------------------------------------------------
# hypothesis twin
# ---------------------------------------------------------------------------


@settings(max_examples=20)
@given(n=st.sampled_from([16, 32, 64]), towers=st.integers(min_value=1, max_value=5),
       seed=st.integers(min_value=0, max_value=2**16))
def test_property_ops_match_reference(n, towers, seed):
    rb, pb = bases(n, towers)
    gen = random.Random(seed)
    coeffs = [gen.randrange(pb.modulus) for _ in range(n)]
    assert pb.decode(pb.encode(coeffs)) == coeffs
    a, b = R.random_ct(rb, seed), R.random_ct(rb, seed + 1)
    got = host(he.ct_mul(pb, a, b, device=CPU))
    np.testing.assert_array_equal(got, R.ct_mul(rb, a, b))
    np.testing.assert_array_equal(got, he.ct_mul_reference(pb, a, b))
    s = R.make_secret(rb, seed)
    rk, pk = R.relin_key(rb, s, seed=seed + 1), he.relin_key(pb, s, seed=seed + 1, device=CPU)
    c2 = R.random_poly(rb, seed + 2)
    np.testing.assert_array_equal(host(he.keyswitch(pb, c2, pk, device=CPU)), R.keyswitch(rb, c2, rk))
    np.testing.assert_array_equal(host(he.ct_mul_relin(pb, a, b, pk, device=CPU)),
                                  R.ct_mul_relin(rb, a, b, rk))
    if towers >= 2:
        np.testing.assert_array_equal(host(he.rescale(pb, a, device=CPU)), R.rescale(rb, a))
    ctx = pb.contexts[0]
    np.testing.assert_array_equal(host(he.ntt_towers(pb, a, device=CPU))[:, 0],
                                  ntt_core.ntt_forward_np(a[:, 0], ctx))
