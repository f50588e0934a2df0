"""Both packages' train steps side by side from the same weights: qwen3-4b
at full width, cut to `--layers`, trained `--steps` steps on the same
`SyntheticStream` batches with `chip_smoke.py`'s schedule (warmup_steps=1,
total_steps=steps + 1) and its bf16 AdamW moments for qwen3-4b.  Each
package's loss and grad norm per step are printed as one JSON object.

The reference runs first, in a child interpreter of its own: it draws the
weights (seed 0), saves them in the shared checkpoint format under
`--work`, and takes its jitted steps; then the port, in another child,
restores them and takes its steps.  One package's weights, moments and
grads are in memory at a time (about 1e9 f32 params at 2 layers: some
14 GB a child).  Too large for the tier-1 tests, which hold the reduced
model's trajectory (test_torch_train.py::test_train_trajectory_matches_reference).

Usage, from the repo root:
  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_trajectory.py --layers 2 --batch 2 --seq 128 --work DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

MOMENTS = "bfloat16"


def _rows(metrics) -> dict:
    return {k: float(metrics[k]) for k in ("loss", "grad_norm", "lr")}


def reference(args) -> list:
    import jax
    import jax.numpy as jnp

    from repro.ckpt.checkpoint import CheckpointManager
    from repro.configs.registry import get_config
    from repro.data.pipeline import SyntheticStream
    from repro.launch import steps
    from repro.models import transformer as T
    from repro.optim import OptConfig

    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=args.layers)
    opt = OptConfig(moment_dtype=MOMENTS, warmup_steps=1, total_steps=args.steps + 1)
    params = T.init_params(cfg, jax.random.PRNGKey(0))
    CheckpointManager(args.work).save(0, params)
    state = steps.make_opt_init(cfg, opt)(params)
    step_fn = jax.jit(steps.make_train_step(cfg, opt), donate_argnums=(0, 1))
    stream, rows = SyntheticStream(cfg, args.batch, args.seq, seed=0), []
    for step in range(1, args.steps + 1):
        batch = {k: jnp.asarray(v) for k, v in stream.batch_at(step).items()}
        params, state, m = step_fn(params, state, batch, jnp.int32(step))
        rows.append(_rows(m))
    return rows


def port(args) -> list:
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.launch import steps
    from repro_torch.launch.serve import to_device
    from repro_torch.optim import OptConfig

    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=args.layers)
    opt = OptConfig(moment_dtype=MOMENTS, warmup_steps=1, total_steps=args.steps + 1)
    params = CheckpointManager(args.work).restore(0, steps.param_specs(cfg), "cpu")[0]
    state = steps.make_opt_init(cfg, opt)(params)
    step_fn = steps.make_train_step(cfg, opt)
    stream, rows = SyntheticStream(cfg, args.batch, args.seq, seed=0), []
    for step in range(1, args.steps + 1):
        params, state, m = step_fn(params, state, to_device(stream.batch_at(step), "cpu"), step)
        rows.append(_rows(m))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--work", required=True, help="a directory for the shared weights")
    ap.add_argument("--package", choices=("reference", "port"), default=None)
    args = ap.parse_args()
    if args.package:
        rows = (reference if args.package == "reference" else port)(args)
        print(json.dumps(rows))
        return
    out = {"arch": "qwen3-4b", "layers": args.layers, "batch": args.batch, "seq": args.seq,
           "moments": MOMENTS}
    for package in ("reference", "port"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), *sys.argv[1:], "--package", package],
                              check=True, capture_output=True, text=True)
        out[package] = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
