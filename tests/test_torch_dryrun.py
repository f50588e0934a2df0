"""`repro_torch.launch.{dryrun,roofline,perf,report_experiments}` against
`repro`'s dry-run tools, and a miniature fake-world pass.

Parsers, arithmetic and the roofline report are plain functions and are
compared in this process with `==`.  Every fake-world pass (a `fake`
process group) runs in a child interpreter (`torch_dist.run_child`); the
full 40-cell sweep runs on the card's host (`chip_smoke.py`'s dist phase,
or `python -m repro_torch.launch.dryrun --all`).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro.configs.registry import ARCH_NAMES
from repro.configs.registry import get_config as ref_get_config
from repro.launch import dryrun as ref_dryrun
from repro.launch import roofline as ref_roofline
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun, perf, report_experiments, roofline
from repro_torch.tree import leaves
from torch_dist import SRC, run_child

HLO = """
  %ag = f32[64,128]{1,0} all-gather(%x), channel_id=1, replica_groups=[16,16]<=[256], dimensions={0}
  %ar.1 = bf16[1024]{0} all-reduce(%y), replica_groups=[16,16]<=[16,16]T(1,0)
  %rs = f32[8,16]{1,0} reduce-scatter(%z), replica_groups={{0,1,2,3}}, dimensions={0}
  %cp = u32[256]{0} collective-permute(%w), source_target_pairs={{0,1}}
  %a2a = f32[32]{0} all-to-all(%v), replica_groups=[4,2]<=[8]
  %ag-done = f32[64]{0} all-gather-done(%ag-start)
  %ars = (f32[4]{0}, bf16[8]{0}) all-reduce-start(%q), replica_groups={{0,1}}
"""


def test_parse_collectives_equals_the_reference():
    """tests/test_dryrun.py's HLO, plus a -done line and a tuple-typed -start."""
    out = dryrun.parse_collectives(HLO)
    assert out == ref_dryrun.parse_collectives(HLO)
    assert out["counts"] == {"all-gather": 1, "all-reduce": 2, "reduce-scatter": 1,
                             "collective-permute": 1, "all-to-all": 1}
    assert out["all-gather"] == 64 * 128 * 4 // 16 and out["reduce-scatter"] == 8 * 16 * 4 * 4
    assert dryrun.parse_collectives("  %ag-done = f32[64]{0} all-gather-done(%ag-start)\n")["counts"] == {}
    for line in HLO.splitlines():
        assert dryrun._group_size(line) == ref_dryrun._group_size(line)
    for dt, dims in (("bf16", "3,5"), ("pred", ""), ("c64", "2"), ("s8", "7,1,2")):
        assert dryrun._bytes_of(dt, dims) == ref_dryrun._bytes_of(dt, dims)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_depth_variant_equals_the_reference(arch):
    for n in (1, 2):
        v, ref_v = dryrun._depth_variant(get_config(arch), n), ref_dryrun._depth_variant(ref_get_config(arch), n)
        assert dataclasses.asdict(v) == dataclasses.asdict(ref_v)
        assert v.num_layers == n * len(v.pattern()) and not v.scan_layers and v.pattern() == get_config(arch).pattern()


def test_parse_override_equals_the_reference():
    from repro.launch.perf import parse_override as ref_parse_override  # sets XLA_FLAGS at import

    for kv in ("remat=False", "remat=True", "capacity_factor=2.5", "num_layers=4", "moe_dispatch=gather",
               "x=1e-3", "name=a=b", "ssm_impl=", "flag=true"):
        assert perf.parse_override(kv) == ref_parse_override(kv)


def records(tmp_path):
    """Dry-run records of both meshes, a skip and a failure, written as
    `run_cell` writes them."""
    ri = dict(flops_per_device=3.1e15, bytes_per_device=2.5e11, collective_bytes_per_device=4.0e10,
              wire_bytes_per_device=7.5e10, collective_by_op={"all-gather": 3.0e10, "reduce-scatter": 1.0e10},
              method="test")
    recs = [
        {"arch": "qwen3-8b", "shape": "train_4k", "mesh": "pod16x16", "status": "run", "roofline_inputs": ri,
         "memory": {"peak_bytes": 3 * 2**30}, "flops_per_device": 3.1e15,
         "collectives": {"total_bytes": 4e10, "counts": {"all-gather": 5}}},
        {"arch": "whisper-small", "shape": "decode_32k", "mesh": "pod16x16", "status": "run",
         "roofline_inputs": dict(ri, flops_per_device=1e9, collective_bytes_per_device=9e10),
         "memory": {"peak_bytes": 2**28}},
        {"arch": "qwen3-4b", "shape": "long_500k", "mesh": "pod16x16", "status": "skip: quadratic"},
        {"arch": "mamba2-780m", "shape": "train_4k", "mesh": "pod16x16", "status": "FAIL: X"},
        {"arch": "qwen3-8b", "shape": "train_4k", "mesh": "pod2x16x16", "status": "run", "roofline_inputs": ri,
         "memory": {"peak_bytes": 2**30}},
    ]
    for r in recs:
        with open(tmp_path / f"{r['arch']}__{r['shape']}__{r['mesh']}.json", "w") as f:
            json.dump(r, f)
    return recs


@pytest.mark.parametrize("constants", ["h100", "v5e"])
def test_roofline_report_equals_the_reference(tmp_path, monkeypatch, constants):
    """analyze_cell, load_all and to_markdown on the same records with the
    same constants (each package's in turn) give the reference's rows and
    table; roofline.main and report_experiments write from them."""
    src, dst = (roofline, ref_roofline) if constants == "h100" else (ref_roofline, roofline)
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(dst, name, getattr(src, name))
    recs = records(tmp_path)
    for r in recs:
        assert roofline.analyze_cell(r) == ref_roofline.analyze_cell(r)
    for mesh in ("pod16x16", "pod2x16x16"):
        rows = roofline.load_all(str(tmp_path), mesh)
        assert rows == ref_roofline.load_all(str(tmp_path), mesh)
        assert roofline.to_markdown(rows) == ref_roofline.to_markdown(rows)
    assert [r.get("skip") for r in roofline.load_all(str(tmp_path))] == ["skip: quadratic", None, None]
    monkeypatch.setattr(sys, "argv", ["report", "--report-dir", str(tmp_path)])
    report_experiments.main()
    text = (tmp_path / report_experiments.REPORT_NAME).read_text()
    assert "| qwen3-8b | train_4k | pod16x16 | OK | 3.00 | 3.10e+15 | 4.00e+10 | all-gather |" in text
    assert roofline.to_markdown(roofline.load_all(str(tmp_path))) in text


def test_h100_constants_are_the_data_sheets():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)


def test_skipped_cell_needs_no_world(tmp_path):
    rec = dryrun.run_cell("qwen3-4b", "long_500k", False, str(tmp_path))
    assert rec["status"].startswith("skip") and os.path.exists(tmp_path / "qwen3-4b__long_500k__pod16x16.json")


def test_import_sets_no_process_state():
    """Unlike the reference's dryrun.py and perf.py, which set XLA_FLAGS at
    import, the port's tools touch nothing when imported."""
    code = ("import os, torch.distributed as dist\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.perf, repro_torch.launch.roofline\n"
            "import repro_torch.launch.report_experiments, repro_torch.launch.mesh\n"
            "import repro_torch.distributed.sharding, repro_torch.distributed.compression\n"
            "assert 'XLA_FLAGS' not in os.environ and not dist.is_initialized()\n"
            "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env=dict(env, PYTHONPATH=SRC))
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr[-3000:]


MINI_PASS = '''
import dataclasses, json
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import effective_shape, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.tree import leaves

mesh = AbstractMesh(("data", "model"), (2, 4))
out = {}
with dryrun.fake_world(mesh) as dmesh:
    for arch in ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b", "whisper-small"):
        base = dataclasses.replace(get_config(arch).reduced(), name=arch)  # the arch's optimizer policy
        deep = dryrun._depth_variant(base, 3)
        shapes = [ShapeConfig("t", 64, 8, "train"), ShapeConfig("p", 64, 8, "prefill"),
                  ShapeConfig("d", 64, 8, "decode")]
        if arch == "jamba-1.5-large-398b":  # long_500k's batch 1, replicated over dp
            shapes.append(ShapeConfig("decode_b1", 64, 1, "decode"))
        for shp in shapes:
            shp = effective_shape(deep, shp)  # whisper's decoder length, as run_cell clamps it
            ri = dryrun.extrapolated_costs(deep, shp, mesh, dmesh)
            full = dryrun.measure_pass(deep, shp, mesh, dmesh)
            cell = dryrun.build_cell(deep, shp, mesh)
            args = dryrun.place_inputs(cell, dmesh)
            local = sum(t.to_local().numel() * t.to_local().element_size() for k in args for t in leaves(args[k]))
            with dryrun.CollectiveTally() as tally:
                dryrun.run_step(deep, shp, cell, args, dmesh)
            out[f"{arch}/{shp.name if shp.global_batch == 1 else shp.kind}"] = dict(
                flops=ri["flops_per_device"], full_flops=full["flops"], coll=ri["collective_bytes_per_device"],
                full_coll=full["coll"]["total_bytes"], counts=ri["collective_counts"],
                full_counts=full["coll"]["counts"], args=ri["memory"]["argument_bytes"], local=local,
                memory=ri["memory"], opt=cell.opt_cfg.optimizer, whole=dryrun._whole_bytes(cell.inputs["params"]),
                model_all_reduces=sum(op == "all-reduce" and group == 4 for op, _, group in tally.ops))
# the model axis: a reduced dense and a reduced MoE train cell, per-device
# flops on 2 x 4 against 2 x 1, and the gathered copies against the whole model
train = ShapeConfig("t", 64, 8, "train")
axis = {}
for shape in ((2, 4), (2, 1)):
    small = AbstractMesh(("data", "model"), shape)
    with dryrun.fake_world(small) as dmesh:
        for arch in ("qwen3-8b", "qwen3-moe-30b-a3b"):
            cfg = dataclasses.replace(get_config(arch).reduced(), name=arch)
            rec = axis.setdefault(arch, {})
            rec[f"flops_{shape[1]}"] = dryrun.measure_pass(cfg, train, small, dmesh)["flops"]
            if shape == (2, 4):
                cell = dryrun.build_cell(cfg, train, small)
                rec["temp"] = dryrun.memory_bytes(cfg, train, small)["temp_bytes"]
                rec["whole"] = dryrun._whole_bytes(cell.inputs["params"])
out["model_axis"] = axis
print(json.dumps(out))
'''


def test_mini_fake_world_pass(tmp_path):
    """Train, prefill and decode of four reduced archs (MoE, Adafactor, the
    hybrid SSD, the encoder-decoder) at 3 reps on a 2 x 4 fake world: flops
    and collective bytes > 0; the passes at 1 and 2 reps extrapolate to the
    3-rep pass exactly; argument bytes from the local shapes equal the
    placed local shards' bytes; donated state aliases its outputs.  The
    prefill and decode cells run the sharded serving steps: the gathered
    copies below the whole model's bytes, and every decode step's
    partial-softmax all-reduces over `model` (groups of 4); a decode cell
    of batch 1 (long_500k's), which does not divide over dp and is
    replicated there, so that MoE routes that one row on every dp rank.  The
    train cells of reduced qwen3-8b and qwen3-moe: per-device flops on
    2 x 4 at most 0.6 of those on 2 x 1 (the model axis splits the work),
    and the gathered copies (`temp_bytes`) below the whole model's bytes."""
    out = json.loads(run_child(tmp_path, MINI_PASS).strip().splitlines()[-1])
    axis = out.pop("model_axis")
    for arch, r in axis.items():  # the model axis splits the compute; a rep at a time is gathered
        assert r["flops_4"] <= 0.6 * r["flops_1"] and r["temp"] < r["whole"], (arch, r)
    assert len(out) == 13
    assert "reduce-scatter" not in out["jamba-1.5-large-398b/decode_b1"]["counts"]  # MoE routes its one row
    for key, r in out.items():
        assert r["flops"] > 0 and r["coll"] > 0, key
        assert (r["flops"], r["coll"], r["counts"]) == (r["full_flops"], r["full_coll"], r["full_counts"]), key
        assert r["args"] == r["local"], key
        mem = r["memory"]
        assert mem["peak_bytes"] == mem["argument_bytes"] + mem["output_bytes"] - mem["alias_bytes"] + mem["temp_bytes"]
        if key.endswith("train"):
            assert mem["alias_bytes"] == mem["output_bytes"] and "reduce-scatter" in r["counts"], key
        else:
            assert mem["temp_bytes"] < r["whole"], key
        if "decode" in key:
            assert r["model_all_reduces"] > 0, key
    assert out["kimi-k2-1t-a32b/train"]["opt"] == "adafactor"


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b", "whisper-small", "llama-3.2-vision-11b"])
def test_train_gather_bytes_keep_the_mixers_model_shards(arch):
    """The train_4k cell on the 16 x 16 mesh (meta tensors, no world): the
    gathered copies now keep the model shards of the SSD, cross-attention
    and the whisper encoder (only the SSD's `conv_w` is gathered whole), so
    they are below what the same accounting gives with every block leaf
    but the FFN's, and every encoder leaf, gathered over `model`; the
    cell's temporaries are those copies."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.mesh import make_production_mesh

    cfg, shape, mesh = get_config(arch), SHAPES["train_4k"], make_production_mesh()
    cell = dryrun.build_cell(cfg, shape, mesh)
    params, shardings = cell.inputs["params"], cell.in_sh["params"]
    now = dryrun._train_gather_bytes(cfg, params, shardings, mesh)
    mixers_whole = dryrun._train_gather_bytes(cfg, params, shardings, mesh,
                                              lambda path: "['ffn']" in path and "encoder" not in path)
    assert now < mixers_whole, (now, mixers_whole)
    assert dryrun.memory_bytes(cfg, shape, mesh)["temp_bytes"] == now


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serving_memory_keeps_the_model_shards(arch):
    """The decode_32k cell on the 16 x 16 mesh (meta tensors, no world): the
    serving steps' temporaries are `memory_bytes`' rule, one rep's block
    leaves gathered over dp with their model shards kept plus the encoder,
    embedding and head (`_train_gather_bytes` with remat), no whole cache;
    so the cell's whole peak is below the whole model's bytes."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import effective_shape
    from repro_torch.launch.mesh import make_production_mesh

    cfg, mesh = get_config(arch), make_production_mesh()
    shape = effective_shape(cfg, SHAPES["decode_32k"])
    cell = dryrun.build_cell(cfg, shape, mesh)
    params, shardings = cell.inputs["params"], cell.in_sh["params"]
    mem = dryrun.memory_bytes(cfg, shape, mesh)
    rule = dryrun._train_gather_bytes(dataclasses.replace(cfg, remat=True), params, shardings, mesh)
    assert mem["temp_bytes"] == rule, (mem, rule)
    caches = sum(t.numel() * t.element_size() for t in leaves(cell.inputs["caches"]))
    assert mem["peak_bytes"] < dryrun._whole_bytes(params) and mem["argument_bytes"] < caches, mem
