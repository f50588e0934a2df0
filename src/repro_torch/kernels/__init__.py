"""The port's kernels: CUDA C++ for the H100 (`csrc/`), each behind a
wrapper that launches it on a CUDA tensor and runs its plain torch version
on a CPU tensor.  Importing this package builds nothing; the kernels are
compiled on their first launch (`_build.load`)."""
from repro_torch.kernels import backend, modmul, ntt, ops  # noqa: F401


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {**ntt.LAUNCHES, **modmul.LAUNCHES}


def reset_launch_counts() -> None:
    """Sets every kernel's launch count to 0."""
    for counts in (ntt.LAUNCHES, modmul.LAUNCHES):
        for name in counts:
            counts[name] = 0
