"""Builds the port's CUDA kernels at first use and binds them with ctypes;
also the launch helpers every wrapper shares (argument checks, launch
errors, the current stream).

`nvcc` compiles every source under `csrc/` for `sm_90a` (one process per
source, all started together) and links them into one shared library with
a plain C interface.  The library goes to `_build/<hash>/`, keyed by a hash
of the sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.  A missing `nvcc` or a failed build raises: no
caller falls back to a plain version.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent / "_build"
LIB_NAME = "librepro_torch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_report: dict | None = None


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.access(default, os.X_OK) else None


def _run_nvcc(cmds: list[list[str]]) -> list[str]:
    """Runs the nvcc commands in parallel; returns each one's output."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    outputs = []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
            outputs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outputs


def _build() -> tuple[pathlib.Path, dict]:
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        ptxas = (out_dir / "ptxas.txt").read_text().splitlines()
        return lib_path, {"seconds": 0.0, "cached": True, "ptxas": ptxas, "library": str(lib_path)}
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the kernels")
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=".tmp-", dir=BUILD_ROOT))
    try:
        t0 = time.perf_counter()
        objs = [tmp / (src.stem + ".o") for src in _sources()]
        compile_out = _run_nvcc(
            [
                [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(_sources(), objs)
            ]
        )
        _run_nvcc([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME), *map(str, objs)]])
        seconds = time.perf_counter() - t0
        # ptxas -v: per kernel its registers, barriers, stack frame and spills
        ptxas = [ln.strip() for out in compile_out for ln in out.splitlines() if ln.strip()]
        (tmp / "ptxas.txt").write_text("\n".join(ptxas) + "\n")
        try:
            os.rename(tmp, out_dir)  # atomic; another process may have won
        except OSError:
            if not lib_path.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path, {"seconds": seconds, "cached": False, "ptxas": ptxas, "library": str(lib_path)}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    # c_void_p for every pointer and the stream: a bare int would be cut to 32 bits.
    P, I, U, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_longlong
    lib.ntt_tile_launch.argtypes = [P, P, P, P, L, I, I, I, U, I, U, U, P]
    lib.ntt_tile_launch.restype = I
    lib.ntt_pair_launch.argtypes = [P, P, P, P, L, I, I, I, I, U, I, U, U, P]
    lib.ntt_pair_launch.restype = I
    lib.modmul_launch.argtypes = [P, P, P, L, U, U, U, P]
    lib.modmul_launch.restype = I
    D = ctypes.c_double
    lib.chain_fold_launch.argtypes = [P, P, L, I, D, D, P]
    lib.chain_fold_launch.restype = I
    lib.chain_fold_roundtrip.argtypes = [P, P, L, I, D, D, I, P]
    lib.chain_fold_roundtrip.restype = I
    lib.fold_dadd_probe_launch.argtypes = [P, L, D, D, P]
    lib.fold_dadd_probe_launch.restype = I
    lib.silu_fwd_launch.argtypes = [P, L, P, L, L, I, P, P]
    lib.silu_fwd_launch.restype = I
    lib.silu_table_launch.argtypes = [P, P]
    lib.silu_table_launch.restype = I
    lib.silu_grad_table_launch.argtypes = [P, P]
    lib.silu_grad_table_launch.restype = I
    lib.silu_bwd_launch.argtypes = [P, L, P, L, P, L, L, I, P, P]
    lib.silu_bwd_launch.restype = I
    lib.softplus_fwd_launch.argtypes = [P, L, P, L, L, P, P]
    lib.softplus_fwd_launch.restype = I
    lib.softplus_bwd_launch.argtypes = [P, L, P, L, P, L, P, L, L, P, P]
    lib.softplus_bwd_launch.restype = I
    lib.empty_launch.argtypes = [I, I, P]
    lib.empty_launch.restype = I
    lib.repro_cuda_error_string.argtypes = [I]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built on the first call of the process."""
    global _lib, _report
    if _lib is not None:  # every launch comes here: no lock once loaded
        return _lib
    with _lock:
        if _lib is None:
            path, report = _build()
            _lib = _bind(ctypes.CDLL(str(path)))
            _report = report
    return _lib


def build_report() -> dict:
    """Build seconds, whether the library was cached, ptxas's report of
    each kernel's registers and shared memory, and the library's path
    (after `load()`)."""
    load()
    return dict(_report)


def check_u32(name: str, t, device=None) -> None:
    """Raises unless `t` is a contiguous uint32 tensor (on `device`, if given):
    what every kernel wrapper must check before it passes a pointer."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.uint32:
        raise TypeError(f"{name} must be uint32, got {t.dtype}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check(err: int, kernel: str) -> None:
    """Raises if a launch returned a CUDA error."""
    if err:
        msg = load().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")


def _index(device) -> int | None:
    """The card's index of `device` (a card's index, a `torch.device` or a
    string), None for "cuda" without one."""
    if isinstance(device, int):
        return device
    return (device if isinstance(device, torch.device) else torch.device(device)).index


def stream_handle(device) -> int:
    """The handle of PyTorch's current stream on `device` (a card's index,
    as `Tensor.get_device()` gives it, a `torch.device` or a string), for a
    launch."""
    index = _index(device)
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device() if index is None else index)


def on_device(device):
    """A context that makes `device` (as for `stream_handle`) current for a
    launch, where it is not."""
    index = _index(device)
    if index is None or index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def empty_launch(blocks: int, threads: int, device) -> None:
    """An empty kernel of `blocks` CTAs of `threads` on `device`'s current
    stream: the floor under a launch of that shape."""
    check(load().empty_launch(blocks, threads, stream_handle(device)), "empty")
