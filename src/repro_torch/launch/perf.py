"""Perf-iteration harness: the port of the JAX package's
`repro/launch/perf.py`.  One cell with config overrides, and its three
roofline terms from the dry-run's fake-world pass (`launch.dryrun`), so
that a hypothesis -> change -> measure cycle is a single command:

  python -m repro_torch.launch.perf --arch qwen3-moe-30b-a3b --shape train_4k \\
      --set moe_dispatch=gather --set remat=False

The terms are the pass's per-device counts over the H100 data-sheet rates
of `launch.roofline`; like the reference, it times no real step.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import effective_shape, get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_production_mesh


def parse_override(kv: str):
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("True", "False"):
        return k, v == "True"
    return k, v


def measure(arch: str, shape_name: str, overrides: dict, fullmem: bool = False) -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = effective_shape(cfg, SHAPES[shape_name])
    mesh = make_production_mesh()
    with dryrun.fake_world(mesh) as dmesh:
        ri = dryrun.extrapolated_costs(cfg, shape, mesh, dmesh)
    t = roofline.terms(ri, roofline.model_flops(cfg, shape), mesh.size)
    out = dict(arch=arch, shape=shape_name, overrides=overrides,
               **{k: t[k] for k in ("compute_s", "memory_s", "collective_s", "dominant", "useful_ratio",
                                    "roofline_fraction")},
               collective_by_op=ri["collective_by_op"])
    if fullmem:
        out["peak_gib"] = ri["memory"]["peak_bytes"] / 2**30
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", action="append", default=[], dest="overrides")
    ap.add_argument("--fullmem", action="store_true", help="also the peak memory from the local shapes")
    args = ap.parse_args()
    overrides = dict(parse_override(kv) for kv in args.overrides)
    out = measure(args.arch, args.shape, overrides, fullmem=args.fullmem)
    print(json.dumps(out, indent=2, default=str))


if __name__ == "__main__":
    main()
