"""Two source trees' LM steps, or their LM kernels, on one card, in turns.

    python -m repro_torch.launch.compare_trees --tree parent=DIR --tree change=. \\
        [--part steps|kernels] [--order parent,change,change,parent] [--out compare_trees.json]

Each run is a child interpreter in one tree (its `src` first on the path)
that imports that tree's own `chip_smoke.py` and drives, on the card, its
`drive_lm_serve` (full size, batch 4, prompt 128, 32 tokens: decode ms a
step, the profiler's kernels and busy ms a decode step) and
`drive_train_steps` (full size, batch 4 x seq 512, 8 steps: step ms, the
kernels and busy ms of one profiled step) for each of `ARCHS`.  The runs go
in `--order` (by default parent, change, change, parent), one after the
other on the same card, so that drift of the card shows as a difference
between a tree's two runs.  With `--part kernels` a run times the tree's
silu and softplus kernels instead, through its `chip_smoke.py`'s
`time_silu` (seeded draws) and `time_softplus`.  Prints one JSON line per
run and writes them all, with the card's name and power limit, to `--out`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: (arch, AdamW moment dtype): chip_smoke.py's full-size train runs, served too.
ARCHS = (("qwen3-4b", "bfloat16"), ("mamba2-780m", "float32"))
CHILD_TIMEOUT_S = 900

_CHILD = r"""
import importlib.util, json, os, sys
root = os.getcwd()
sys.path.insert(0, os.path.join(root, "src"))
spec = importlib.util.spec_from_file_location("chip_smoke_tree", os.path.join(root, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
out = {}
for arch, moments in json.loads(sys.argv[1]):
    serve = cs.drive_lm_serve(arch, 4, 128, 32, "cuda")
    train = cs.drive_train_steps(arch, moments, "cuda")
    prof = serve["profile"]
    out[arch] = {
        "decode_ms_per_step": serve["decode_ms_per_token"], "decode_ms_spread": serve["decode_ms_spread"],
        "decode_kernels_per_step": sum(prof["kernels_per_step"].values()),
        "decode_kernels_by_class": prof["kernels_per_step"], "decode_busy_ms_per_step": prof["busy_ms_per_step"],
        "decode_busy_share": prof["busy_share"], "prefill_warm_ms": serve["prefill_warm_ms"],
        "serve_launches": serve["launches"], "train_step_ms": train["step_ms"],
        "train_step_ms_spread": train["step_ms_spread"], "train_kernels": train["profile"]["kernels"],
        "train_busy_ms": train["profile"]["busy_ms"], "train_busy_share": train["busy_share"],
        "train_ms_by_class": train["profile"]["ms_by_class"], "train_launches": train["launches"],
        "losses": [r["loss"] for r in train["steps"]],
    }
    cs.gc.collect()
print(json.dumps(out))
"""

_KERNELS_CHILD = r"""
import importlib.util, json, os, sys
root = os.getcwd()
sys.path.insert(0, os.path.join(root, "src"))
spec = importlib.util.spec_from_file_location("chip_smoke_tree", os.path.join(root, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
cs._build.load()
print(json.dumps({"silu": cs.time_silu(cs.np.random.default_rng(cs.SEED), "cuda"), "softplus": cs.time_softplus("cuda")}))
"""


def run_tree(path: str, archs=ARCHS, part: str = "steps") -> dict:
    """One child run of `part` in the tree at `path`: its last stdout line, as JSON."""
    code = _CHILD if part == "steps" else _KERNELS_CHILD
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(archs)], cwd=path, capture_output=True,
                          text=True, timeout=CHILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"run in {path} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", required=True, help="NAME=DIR, a checkout with chip_smoke.py")
    ap.add_argument("--part", choices=("steps", "kernels"), default="steps")
    ap.add_argument("--order", default=None, help="comma-separated names (default: first, second, second, first)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.tree)
    names = list(trees)
    order = args.order.split(",") if args.order else [names[0], names[-1], names[-1], names[0]]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    runs = []
    for i, name in enumerate(order):
        runs.append({"run": i, "tree": name, "path": os.path.abspath(trees[name]), **run_tree(trees[name], part=args.part)})
        print(json.dumps(runs[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "order": order, "runs": runs}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
