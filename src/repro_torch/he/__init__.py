"""`repro_torch.he` — RNS-CKKS ciphertext ops on the H100.

The port of the `rns` half of `repro.he`: residue towers as uint32
tensors on the card, each tower's transforms and pointwise products run
through the port's kernels (B1 `ntt_tile`, B2 `ntt_pair`, B3 `modmul`),
one call per tower per phase.  The device plans of `repro.he.ops` (the
simulated PIM) are not part of it.

    from repro_torch import he

    basis = he.make_basis(65536, 16)
    s = he.make_secret(basis, 0)                 # on the card
    rlk = he.relin_key(basis, s, seed=1)
    ct = he.ct_mul_relin(basis, he.random_ct(basis, 1), he.random_ct(basis, 2), rlk)
    ct = he.rescale(basis, ct)                   # [2, 15, 65536] uint32, CUDA
"""
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
    "KeySwitchKey",
    "RnsBasis",
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
