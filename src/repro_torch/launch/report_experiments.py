"""The dry-run and roofline tables from reports/dryrun_torch/*.json, written
to a new markdown file beside them: the port of the JAX package's
`repro/launch/report_experiments.py` (which injects its tables into an
EXPERIMENTS.md that this repo does not have).

    PYTHONPATH=src python -m repro_torch.launch.report_experiments [--report-dir D]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch import roofline

REPORT_NAME = "REPORT.md"


def dryrun_table(report_dir: str) -> str:
    rows = []
    for path in sorted(glob.glob(os.path.join(report_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        mem = r.get("memory", {})
        coll = r.get("collectives", {})
        status = r["status"]
        if status == "run":
            status = "OK"
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {status[:60]} | "
            f"{mem.get('peak_bytes', 0) / 2**30:.2f} | "
            f"{r.get('flops_per_device', 0):.2e} | "
            f"{coll.get('total_bytes', 0):.2e} | "
            f"{','.join(sorted((coll.get('counts') or {}).keys())) or '—'} |"
        )
    hdr = ("| arch | shape | mesh | status | peak GiB/dev (no activations) | flops/dev | "
           "coll B/dev | collective kinds |\n|---|---|---|---|---|---|---|---|")
    return hdr + "\n" + "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--report-dir", default=roofline.REPORT_DIR)
    args = ap.parse_args()
    rows = roofline.load_all(args.report_dir, "pod16x16")
    n = len(glob.glob(os.path.join(args.report_dir, "*.json")))
    md = ("# Dry-run (repro_torch)\n\n" + dryrun_table(args.report_dir)
          + "\n\n# Roofline (pod16x16, H100 data-sheet rates)\n\n" + roofline.to_markdown(rows) + "\n")
    out = os.path.join(args.report_dir, REPORT_NAME)
    with open(out, "w") as f:
        f.write(md)
    print(f"{out} written: {n} cells")


if __name__ == "__main__":
    main()
