"""Roofline analysis over the dry-run reports: the port of the JAX
package's `repro/launch/roofline.py`.

Three terms per (arch x shape) cell, single-pod mesh, from the dry-run's
per-device numbers (`launch.dryrun`: a fake-world pass, depth-extrapolated):

    compute term    = FLOPs_per_device / peak_FLOPs                  [s]
    memory term     = bytes_per_device / HBM_bw                      [s]
    collective term = collective_operand_bytes_per_device / link_bw  [s]

Hardware: one NVIDIA H100 SXM per mesh device, at the data sheet's figures
(not measurements): 989 TFLOP/s dense bf16, 3.35 TB/s HBM, 450 GB/s NVLink
per direction.  The reference's constants are a TPU v5e's.

Also reported: MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D
(inference) and the usefulness ratio MODEL_FLOPS / (FLOPs x chips), which
exposes remat/redundancy waste.  `count_params` and `model_flops` are
plain arithmetic over the config, equal with `==` to the reference's.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--report-dir D] [--mesh pod16x16]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

#: Dense bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet, at 700 W).
PEAK_FLOPS = 989e12
#: HBM3 bandwidth of one H100 SXM (NVIDIA data sheet), B/s.
HBM_BW = 3.35e12
#: NVLink bandwidth of one H100 SXM per direction (NVIDIA data sheet: 900
#: GB/s both ways), B/s.
LINK_BW = 450e9

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "reports", "dryrun_torch")


def count_params(cfg) -> tuple[int, int]:
    """(total, active) parameter counts from the config, analytically."""
    d = cfg.d_model
    total = 0
    active = 0
    pattern = cfg.pattern()
    per_pattern = cfg.reps
    for mixer, ffn in pattern:
        t = a = 0
        if mixer in ("attn", "attn_nc", "cross", "attn_cross"):
            attn = d * cfg.num_heads * cfg.hd * 2 + d * cfg.num_kv_heads * cfg.hd * 2
            t += attn * (2 if mixer == "attn_cross" else 1)
            a += attn * (2 if mixer == "attn_cross" else 1)
        if mixer == "mamba":
            g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
            di = cfg.d_inner
            m = d * (2 * di + 2 * g * n + h) + di * d + 4 * (di + 2 * g * n) + di
            t += m
            a += m
        if ffn == "mlp":
            t += 3 * d * cfg.d_ff
            a += 3 * d * cfg.d_ff
        elif ffn == "moe":
            f = cfg.moe_d_ff or cfg.d_ff
            t += 3 * d * f * cfg.num_experts + d * cfg.num_experts
            a += 3 * d * f * cfg.experts_per_token + d * cfg.num_experts
        total += t * per_pattern
        active += a * per_pattern
    if cfg.encoder_layers:
        enc = cfg.encoder_layers * (d * cfg.num_heads * cfg.hd * 4 + 3 * d * cfg.d_ff)
        total += enc
        active += enc
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return total + emb, active + emb


def model_flops(cfg, shape) -> float:
    """6·N_active·tokens (train) or 2·N_active·tokens (inference)."""
    _, active = count_params(cfg)
    if cfg.max_target_len:
        seq = min(shape.seq_len, cfg.max_target_len)
    else:
        seq = shape.seq_len
    if shape.kind == "train":
        tokens = shape.global_batch * seq
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * seq
        return 2.0 * active * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * active * tokens


def terms(ri: dict, model_flops_total: float, chips: int) -> dict:
    """The three terms of one step's per-device counts `ri` (a record's
    `roofline_inputs`) over the data-sheet rates, the dominant one, the
    usefulness ratio, and the roofline fraction: useful compute time over
    the bound (the step time if the terms overlapped perfectly)."""
    t_comp = ri["flops_per_device"] / PEAK_FLOPS
    t_mem = ri["bytes_per_device"] / HBM_BW
    t_coll = ri["collective_bytes_per_device"] / LINK_BW
    dominant = max(
        ("compute", t_comp), ("memory", t_mem), ("collective", t_coll), key=lambda kv: kv[1]
    )[0]
    hlo_total = ri["flops_per_device"] * chips
    bound = max(t_comp, t_mem, t_coll)
    return dict(
        compute_s=t_comp,
        memory_s=t_mem,
        collective_s=t_coll,
        dominant=dominant,
        hlo_flops_total=hlo_total,
        useful_ratio=model_flops_total / hlo_total if hlo_total else 0.0,
        roofline_fraction=(model_flops_total / chips / PEAK_FLOPS) / bound if bound else 0.0,
    )


def analyze_cell(rec: dict) -> dict | None:
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_config

    if rec.get("status") != "run" or "roofline_inputs" not in rec:
        return None
    mf = model_flops(get_config(rec["arch"]), SHAPES[rec["shape"]])
    chips = 256 if rec["mesh"] == "pod16x16" else 512
    ri = rec["roofline_inputs"]
    return dict(
        arch=rec["arch"],
        shape=rec["shape"],
        mesh=rec["mesh"],
        model_flops=mf,
        **terms(ri, mf, chips),
        peak_gib=rec["memory"]["peak_bytes"] / 2**30,
        collective_by_op=ri.get("collective_by_op", {}),
    )


def load_all(report_dir: str = REPORT_DIR, mesh: str = "pod16x16"):
    rows = []
    for path in sorted(glob.glob(os.path.join(report_dir, f"*__{mesh}.json"))):
        with open(path) as f:
            rec = json.load(f)
        row = analyze_cell(rec)
        if row:
            rows.append(row)
        elif rec.get("status", "").startswith("skip"):
            rows.append(dict(arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
                             skip=rec["status"]))
    return rows


def to_markdown(rows) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant | "
           "useful ratio | roofline frac | peak GiB |\n|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        if "skip" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | {r['skip']} | — | — | — |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | {r['memory_s']:.3e} | "
            f"{r['collective_s']:.3e} | **{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.2%} | {r['peak_gib']:.2f} |"
        )
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--report-dir", default=REPORT_DIR)
    ap.add_argument("--mesh", default="pod16x16")
    args = ap.parse_args()
    rows = load_all(args.report_dir, args.mesh)
    print(to_markdown(rows))
    ranked = sorted([r for r in rows if "skip" not in r], key=lambda r: r["roofline_fraction"])
    if ranked:
        print("\nWorst roofline fraction:", ranked[0]["arch"], ranked[0]["shape"],
              f"{ranked[0]['roofline_fraction']:.2%}")
        coll = sorted(ranked, key=lambda r: -r["collective_s"] / max(r["compute_s"], 1e-12))
        print("Most collective-bound:", coll[0]["arch"], coll[0]["shape"])


if __name__ == "__main__":
    main()
