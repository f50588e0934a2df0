"""`repro_torch.he` — RNS-CKKS ciphertext ops on the H100.

The port of the `rns` half of `repro.he`: residue towers as uint32
tensors on the card, each tower's transforms and pointwise products run
through the port's kernels (B1 `ntt_tile`, B2 `ntt_pair`, B3 `modmul`),
one call per tower per phase.  The device plans of the simulated PIM are
part of it too (`ops`, the port of `repro.he.ops`): `RlweCtMulOp`,
`KeySwitchOp`, `RescaleOp` and `CtMulRelinOp` register with
`repro_torch.pimsys.PimSession` on import, lower tower by tower onto
banks for the simulator's timing, and take their values from `rns` on the
session's device.

    from repro_torch import he

    basis = he.make_basis(65536, 16)
    s = he.make_secret(basis, 0)                 # on the card
    rlk = he.relin_key(basis, s, seed=1)
    ct_a, ct_b = he.random_ct(basis, 1), he.random_ct(basis, 2)
    ct = he.ct_mul_relin(basis, ct_a, ct_b, rlk)
    ct = he.rescale(basis, ct)                   # [2, 15, 65536] uint32, CUDA

    from repro_torch.pimsys import PimSession
    sess = PimSession(device="cuda")
    plan = sess.compile(he.CtMulRelinOp(n=65536, towers=16))
    assert he.basis_for(plan.op) is basis        # make_basis memoizes
    r = sess.run(plan, ct_a, ct_b, rlk, time=False)  # the value, on the card
    sess.run(sess.compile(he.CtMulRelinOp(n=4096, towers=8))).timing.latency_ns
                                                 # modeled PIM latency (host)
"""
from repro_torch.he.ops import (
    HE_OPS,
    CtMulRelinOp,
    HeOpHandler,
    HePlan,
    HeTimingResult,
    KeySwitchOp,
    RescaleOp,
    RlweCtMulOp,
    basis_for,
)
from repro_torch.he.rns import (
    KeySwitchKey,
    RnsBasis,
    basis_from_reference,
    ct_mul,
    ct_mul_reference,
    ct_mul_relin,
    decrypt,
    keyswitch,
    keyswitch_key_from_reference,
    keyswitch_reference,
    make_basis,
    make_keyswitch_key,
    make_secret,
    ntt_towers,
    poly_mul_towers,
    random_ct,
    random_poly,
    relin_key,
    relinearize,
    rescale,
    rescale_reference,
    rns_primes,
)

__all__ = [
    "HE_OPS",
    "CtMulRelinOp",
    "HeOpHandler",
    "HePlan",
    "HeTimingResult",
    "KeySwitchKey",
    "KeySwitchOp",
    "RescaleOp",
    "RlweCtMulOp",
    "RnsBasis",
    "basis_for",
    "basis_from_reference",
    "ct_mul",
    "ct_mul_reference",
    "ct_mul_relin",
    "decrypt",
    "keyswitch",
    "keyswitch_key_from_reference",
    "keyswitch_reference",
    "make_basis",
    "make_keyswitch_key",
    "make_secret",
    "ntt_towers",
    "poly_mul_towers",
    "random_ct",
    "random_poly",
    "relin_key",
    "relinearize",
    "rescale",
    "rescale_reference",
    "rns_primes",
]
