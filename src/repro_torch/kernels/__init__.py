"""The port's kernels: CUDA C++ for the H100 (`csrc/`), each behind a
wrapper that launches it on a CUDA tensor and runs its plain torch version
on a CPU tensor.  Importing this package builds nothing; the kernels are
compiled on their first launch (`_build.load`)."""
from repro_torch.kernels import backend, fold, modmul, ntt, ops, silu  # noqa: F401


def launch_counts() -> dict[str, int]:
    """Launches so far of the NTT lane's kernels (B1-B3), by kernel name;
    the fastpath chain's kernel counts its own in `fold.LAUNCHES`, the LM
    path's silu its own in `silu.LAUNCHES`."""
    return {**ntt.LAUNCHES, **modmul.LAUNCHES}


def reset_launch_counts() -> None:
    """Sets every kernel's launch count to 0, the chain's and silu's included."""
    for counts in (ntt.LAUNCHES, modmul.LAUNCHES, fold.LAUNCHES, silu.LAUNCHES):
        for name in counts:
            counts[name] = 0
