"""Readings for the limit that decides `correct`: the program on many
seeds, and the control on a few, in one process at a cell's own size.

    python bench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 101,102,103 --seconds 1 --out chiprun_out/control.json

Each seed is one run of the cell as `run.py` makes it (its window shorter);
for a control seed the configuration's reference, computed in float64,
stands in the program's place.  The benchmark's own runs never run this.
"""
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

from benchlib import harness  # noqa: E402
from benchlib.spec import Spec  # noqa: E402


def readings(spec: Spec, cell: str, seeds, seconds: float, control: bool, device: str = "cuda:0") -> list[dict]:
    config = spec.config(spec.cell(cell)["config"])
    reference = spec.reference(config["reference"])
    system = reference.as_system(config["moduli"], "float64") if control else None
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        result = harness.run_cell(spec, cell, seed, seconds, False, device, t0, system=system)
        out.append({"seed": seed, "correct": result["correct"], "checks": result["checks"],
                    "attempted": result["attempted"], "failed": result["failed"],
                    "seconds": time.perf_counter() - t0})
        print(json.dumps(out[-1]), file=sys.stderr, flush=True)
    return out


def main(argv: list[str]) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds for the program")
    p.add_argument("--control-seeds", required=True, help="comma-separated seeds for the control")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", type=pathlib.Path, required=True)
    args = p.parse_args(argv)
    spec = Spec(HERE.parent)
    program = readings(spec, args.workload, [int(s) for s in args.seeds.split(",")], args.seconds, False)
    control = readings(spec, args.workload, [int(s) for s in args.control_seeds.split(",")], args.seconds, True)
    total = [r["checks"]["wrong_residues"]["value"] for r in control]
    summary = {"workload": args.workload,
               "program_largest": max(r["checks"]["wrong_residues"]["value"] for r in program),
               "control_smallest": min(total), "program": program, "control": control}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: summary[k] for k in ("workload", "program_largest", "control_smallest")}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
