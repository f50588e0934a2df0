"""Every f32 bit pattern through the port's plain softplus and its grad
against the JAX reference on the CPU: not a test (it takes hours on a
CPU), the exhaustive sweep that `PERF.md` records.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_softplus_sweep.py \\
        --chunks 0:256 --out sweep.json

The patterns go in 256 chunks of 2^24 (`--chunks a:b` takes chunks a to
b - 1, so that processes can share the sweep).  For each, the forward
(`jax.jit(jax.nn.softplus)`) and the grad at cotangent 1
(`jax.jit(jax.vmap(jax.grad(jax.nn.softplus)))`) against
`softplus_fwd_plain` / `softplus_bwd_plain`: the count of values whose bits
differ, and apart from it the count where both are NaN with other
payloads.
"""
import argparse
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import softplus as ksp  # noqa: E402

CHUNK = 1 << 24


def sweep(first: int, last: int) -> dict:
    fwd = jax.jit(jax.nn.softplus)
    grad = jax.jit(jax.vmap(jax.grad(jax.nn.softplus)))
    out = {"chunks": [first, last], "fwd_differ": 0, "fwd_nan_payload": 0, "bwd_differ": 0, "bwd_nan_payload": 0,
           "examples": []}
    t0 = time.time()
    for c in range(first, last):
        x = (np.arange(CHUNK, dtype=np.uint64) + c * CHUNK).astype(np.uint32).view(np.float32)
        want = {"fwd": np.asarray(fwd(x)), "bwd": np.asarray(grad(x))}
        t = torch.from_numpy(x)
        y = ksp.softplus_fwd_plain(t)
        got = {"fwd": y.numpy(), "bwd": ksp.softplus_bwd_plain(t, y, torch.ones_like(t)).numpy()}
        for name in ("fwd", "bwd"):
            a, b = got[name], want[name]
            ne = a.view(np.uint32) != b.view(np.uint32)
            both = np.isnan(a) & np.isnan(b)
            out[name + "_differ"] += int((ne & ~both).sum())
            out[name + "_nan_payload"] += int((ne & both).sum())
            for i in np.flatnonzero(ne & ~both)[:2]:
                if len(out["examples"]) < 20:
                    out["examples"].append([name, hex(int(x.view(np.uint32)[i])), float(a[i]), float(b[i])])
        print(c, round(time.time() - t0), {k: v for k, v in out.items() if k != "examples"}, flush=True)
    out["seconds"] = time.time() - t0
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", default="0:256", help="chunks a:b of the 256 (2^24 patterns each)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--threads", type=int, default=0, help="torch's CPU threads (0: its default)")
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    first, last = map(int, args.chunks.split(":"))
    res = sweep(first, last)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
