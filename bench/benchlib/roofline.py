"""The least bytes each piece of an RNS product has to move.

Residues are 4-byte words.  A call multiplies `products` pairs of [L, N]
polynomials (`shared` 1: one b against all of them).  The counts follow
from the shapes alone; a roofline share divides them by a time and the
card's published memory rate.
"""
from __future__ import annotations

WORD = 4
#: Parts of the program's kernel names, as the profiler reports them.
NTT_KERNELS = ("ntt_tile_kernel", "ntt_pair_kernel")
MODMUL_KERNELS = ("modmul_kernel",)


def polymul_bytes_per_call(n: int, towers: int, products: int, shared: int) -> int:
    """The product itself: a read once, b read once (once a call where it
    is shared), c written once."""
    b_rows = 1 if shared else products
    return WORD * towers * n * (2 * products + b_rows)


def ntt_launch_bytes(n: int, rows: int) -> int:
    """One NTT launch over `rows` rows of n: the array read once and written once."""
    return 2 * WORD * rows * n


def ntt_table_bytes(n: int) -> int:
    """One transform's twiddles: the n-word table and its Shoup companion, read once."""
    return 2 * WORD * n


def ntt_bytes_per_call(n: int, towers: int, products: int, launches_per_transform: float) -> float:
    """The NTT launches of one call: per tower a forward over the 2 *
    `products` rows the call hands it (a's and b's, a broadcast b expanded)
    and an inverse over `products` rows, each transform taking
    `launches_per_transform` launches, and each transform's twiddles once."""
    per_tower = (launches_per_transform * (ntt_launch_bytes(n, 2 * products) + ntt_launch_bytes(n, products))
                 + 2 * ntt_table_bytes(n))
    return towers * per_tower


def modmul_bytes_per_call(n: int, towers: int, products: int) -> int:
    """The pointwise products of one call: per tower two [products, n]
    arrays read once and one written once."""
    return 3 * WORD * towers * products * n


def share(nbytes: float, seconds: float, bytes_per_s: float | None) -> float | None:
    """`nbytes` over `seconds` as a percentage of `bytes_per_s`; None where
    there is no time or no published rate."""
    if not bytes_per_s or seconds <= 0:
        return None
    return 100.0 * nbytes / (seconds * bytes_per_s)

