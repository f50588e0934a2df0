"""Multi-pod dry-run: the port of the JAX package's `repro/launch/dryrun.py`.

Proves the distribution config is coherent without the hardware: for each
(arch x shape x mesh) cell the real step runs once in a *fake world*, a
`fake` process group of 256 ranks (512 with --multi-pod) in this one
process, as its rank 0, over a CPU `DeviceMesh` of the production mesh's
axes.  Its inputs are `meta` `DTensor`s placed by the sharding rules, so
nothing is allocated and no collective moves data; the step runs under
`FlopCounterMode` and `CommDebugMode`, and a dispatch mode tallies each
collective's bytes.  The reference lowers and compiles the same cells
with XLA onto 512 forced host devices and reads XLA's cost and memory
analyses; these numbers are the port's own and are not held to XLA's:

  * flops: `FlopCounterMode`, matmul-class ops only (elementwise work is
    not counted);
  * collectives: operand bytes, ring wire bytes and counts by kind, as
    `parse_collectives` reports them for the reference;
  * memory: from the local shapes (`sharding.local_shape` over the
    abstract mesh): argument, output and aliased (donated) bytes, and as
    temporaries the params' gathered copies: one rep's block leaves
    gathered over dp (every rep's in a train step without remat), model
    shards kept where the layers split the work, the encoder, embedding and
    head.  The serving steps' caches are arguments and outputs at their
    local shapes.  No activation peak is computed on meta.

The pass runs the step at 1 and 2 pattern repetitions (`_depth_variant`)
and extrapolates to full depth, affine in depth as the reference does.
Failures here (a sharding the rules cannot place, a shape mismatch) are
bugs in the system.  Nothing is set at import: the fake world lives in
`run_cell` / `main` (`fake_world`) only.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod]   # every cell
Results land in reports/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_NAMES, cell_status, effective_shape, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.optim import OptConfig
from repro_torch.tree import keystr, leaves, leaves_with_path, unflatten

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "reports", "dryrun_torch")

#: per-arch optimizer policy (trillion-param MoEs need factored or
#: low-precision optimizer state)
OPT_POLICY = {
    "kimi-k2-1t-a32b": OptConfig(optimizer="adafactor"),
    "jamba-1.5-large-398b": OptConfig(optimizer="adamw", moment_dtype="bfloat16"),
}

METHOD = ("fake-world pass (torch 'fake' process group, meta DTensors) at 1 and 2 pattern reps, "
          "affine in depth; the sharded train, prefill and decode steps; flops: FlopCounterMode, "
          "matmul-class ops only; collectives: functional collectives' bytes; memory from the local "
          "shapes (caches placed by cache_shardings), temp = the gathered params (one rep over dp "
          "with model shards kept, every rep in a train step without remat, + encoder, embedding, "
          "head), no activation peak; bytes = arguments + outputs + the gathered copies written and "
          "read once")

# ---------------------------------------------------------------------------
# collective accounting (the reference parses XLA's per-device HLO)
# ---------------------------------------------------------------------------

_COLL_APPLY_RE = re.compile(
    r"=\s+(\([^)]*\)|\S+)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\("
)
_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}


def _bytes_of(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _group_size(line: str) -> int:
    m = _GROUPS_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_LIST_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return 1


def _collective_totals(ops) -> dict:
    """Per-device traffic of (op, result bytes, group size) triples: operand
    bytes per op semantics, and ring-algorithm wire bytes:
      all-gather:      operand = result / group   (result is concatenated)
      all-reduce:      operand = result
      reduce-scatter:  operand = result * group
      all-to-all:      operand = result
      collective-permute: operand = result
    """
    out: dict[str, int] = {}
    wire: dict[str, float] = {}
    count: dict[str, int] = {}
    for op, rbytes, g in ops:
        if op == "all-gather":
            operand = rbytes // max(g, 1)
            w = rbytes * (g - 1) / max(g, 1)
        elif op == "all-reduce":
            operand = rbytes
            w = 2 * rbytes * (g - 1) / max(g, 1)
        elif op == "reduce-scatter":
            operand = rbytes * g
            w = rbytes * (g - 1)
        else:  # all-to-all, collective-permute
            operand = rbytes
            w = rbytes * (g - 1) / max(g, 1) if op == "all-to-all" else rbytes
        out[op] = out.get(op, 0) + operand
        wire[op] = wire.get(op, 0.0) + w
        count[op] = count.get(op, 0) + 1
    out["total_bytes"] = sum(v for k, v in out.items() if k != "total_bytes")
    out["wire_bytes"] = round(sum(wire.values()))
    out["counts"] = count
    return out


def parse_collectives(hlo_text: str) -> dict:
    """Per-device collective traffic from compiled (SPMD) HLO text: the
    reference's parser, for its reports.  The scheduled HLO elides operand
    types, so the RESULT shape is read and operand bytes derived per op
    (`_collective_totals`)."""
    ops = []
    for line in hlo_text.splitlines():
        m = _COLL_APPLY_RE.search(line)
        if m is None or "-done" in line.split("=")[0]:
            continue
        result_ty, op = m.group(1), m.group(2)
        rbytes = sum(_bytes_of(d, s) for d, s in _SHAPE_RE.findall(result_ty))
        ops.append((op, rbytes, _group_size(line)))
    return _collective_totals(ops)


#: torch's functional collectives by the reference's op names.
_FUNCOL_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


class CollectiveTally(TorchDispatchMode):
    """Records (op, result bytes, group size) of every functional collective
    run under it (`DTensor` redistributions, the sharded step's
    all-reduces), after `DTensor` has lowered its ops to them."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented  # let DTensor lower itself to plain ops first
        out = func(*args, **(kwargs or {}))
        ns = getattr(func, "namespace", "")
        op = _FUNCOL_OPS.get(func._overloadpacket.__name__) if ns == "_c10d_functional" else None
        if op is not None:
            group = dist.distributed_c10d._resolve_process_group(args[-1])
            self.ops.append((op, out.numel() * out.element_size(), group.size()))
        return out


# ---------------------------------------------------------------------------
# the fake world and the cells' steps
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(mesh):
    """A `fake` process group of `mesh.size` ranks in this process (rank 0:
    collectives return at once, moving nothing) and a CPU `DeviceMesh` of
    the `AbstractMesh` `mesh`'s axes over it; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers the backend

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    try:
        yield make_mesh(mesh.axis_names, mesh.axis_sizes, "cpu")
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass
class Cell:
    """A cell's abstract inputs and outputs with their shardings (over the
    abstract mesh): the reference's `build_lowerable` without the jit."""

    kind: str
    opt_cfg: OptConfig
    inputs: dict  # name -> meta tree
    in_sh: dict  # name -> NamedSharding tree
    outputs: dict
    out_sh: dict
    donated: tuple  # input names the outputs alias


def build_cell(cfg, shape, mesh) -> Cell:
    opt_cfg = OPT_POLICY.get(cfg.name, OptConfig())
    spec = steps.input_specs(cfg, shape, opt_cfg)
    dp = shd.dp_axes(mesh) or None
    b = shape.global_batch
    logits = torch.empty((b, cfg.vocab_size), dtype=T.COMPUTE_DTYPE, device="meta")
    p_sh = shd.param_shardings(mesh, spec["params"])
    if shape.kind == "train":
        in_sh = {"params": p_sh, "opt_state": shd.opt_shardings(mesh, spec["opt_state"]),
                 "batch": shd.batch_shardings(mesh, spec["batch"]), "step": shd.replicated(mesh)}
        outputs = {"params": spec["params"], "opt_state": spec["opt_state"]}
        return Cell("train", opt_cfg, spec, in_sh, outputs, {k: in_sh[k] for k in outputs},
                    ("params", "opt_state"))
    if shape.kind == "prefill":
        caches = steps.cache_specs(cfg, b, shape.seq_len)
        in_sh = {"params": p_sh, "batch": shd.batch_shardings(mesh, spec["batch"])}
        out_sh = {"logits": shd.named(mesh, shd.P(dp, "model"), logits.shape),
                  "caches": shd.cache_shardings(mesh, caches)}
        return Cell("prefill", opt_cfg, spec, in_sh, {"logits": logits, "caches": caches}, out_sh, ())
    c_sh = shd.cache_shardings(mesh, spec["caches"])
    in_sh = {"params": p_sh, "token": shd.named(mesh, shd.P(dp), (b,)), "caches": c_sh,
             "pos": shd.replicated(mesh)}
    out_sh = {"logits": shd.named(mesh, shd.P(dp, "model"), logits.shape), "caches": c_sh}
    return Cell("decode", opt_cfg, spec, in_sh, {"logits": logits, "caches": spec["caches"]}, out_sh,
                ("caches",))


def _pairs(tree, shardings):
    return zip(leaves(tree), (s for _, s in leaves_with_path(shardings)))


def _tree_bytes(tree, shardings, mesh) -> int:
    """Bytes of one device's shards of `tree` under `shardings`."""
    return sum(math.prod(shd.local_shape(mesh, s.spec, t.shape)) * t.element_size()
               for t, s in _pairs(tree, shardings))


def _whole_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _gathered_bytes(tree, shardings, mesh, kept=lambda path: True, prefix: str = "") -> int:
    """Bytes of `tree`'s leaves as the sharded train step gathers them: over
    the dp axes, and over `model` too where `kept(path)` is false (`path`
    the leaf's key string, after `prefix`)."""
    dp = set(shd.dp_axes(mesh))
    total = 0
    for (path, t), (_, s) in zip(leaves_with_path(tree), leaves_with_path(shardings)):
        drop = dp if kept(prefix + keystr(path)) else dp | {"model"}
        spec = shd.P(*(tuple(a for a in shd._axes(e) if a not in drop) or None for e in s.spec))
        total += math.prod(shd.local_shape(mesh, spec, t.shape)) * t.element_size()
    return total


def _kept_over_model(path: str) -> bool:
    """Whether the sharded step computes on a param's model shard: all but
    the SSD's `ssm.MODEL_GATHERED` leaves."""
    return shd._leaf_name(path) not in ssm.MODEL_GATHERED


def _train_gather_bytes(cfg, params, shardings, mesh, kept=_kept_over_model) -> int:
    """The sharded train step's gathered copies of the params at their peak:
    one rep's block leaves gathered over dp, with their model shards kept
    where `kept(path)` (every rep's with `cfg.remat` off, whose backward
    keeps them), the encoder's layers likewise, the embedding gathered over
    dp, and the head (the tied one: the embedding redistributed so that the
    vocab is over model)."""
    rep = 0
    for i, (block, sh) in enumerate(zip(params["blocks"], shardings["blocks"])):
        rep += _gathered_bytes(block, sh, mesh, kept, f"['blocks'][{i}]") // cfg.reps
    total = rep if cfg.remat else rep * cfg.reps
    if "encoder" in params:
        total += _gathered_bytes(params["encoder"]["blocks"], shardings["encoder"]["blocks"], mesh, kept,
                                 "['encoder']['blocks']")
    embed = _gathered_bytes(params["embed"], shardings["embed"], mesh)
    head = _gathered_bytes(params["lm_head"], shardings["lm_head"], mesh) if "lm_head" in params else embed
    return total + embed + head


def memory_bytes(cfg, shape, mesh) -> dict:
    """The cell's memory per device from the local shapes: arguments,
    outputs, aliased outputs (donated arguments), and as temporaries the
    params' gathered copies (`_train_gather_bytes`; the serving steps,
    which keep no backward, hold one rep's, as a train step with remat
    does).  The caches count as the serving steps' arguments and outputs,
    at their local shapes."""
    cell = build_cell(cfg, shape, mesh)
    args = sum(_tree_bytes(cell.inputs[k], cell.in_sh[k], mesh) for k in cell.in_sh)
    outs = sum(_tree_bytes(cell.outputs[k], cell.out_sh[k], mesh) for k in cell.out_sh)
    alias = sum(_tree_bytes(cell.outputs[k], cell.out_sh[k], mesh) for k in cell.donated)
    gathered = cfg if cell.kind == "train" else dataclasses.replace(cfg, remat=True)
    temp = _train_gather_bytes(gathered, cell.inputs["params"], cell.in_sh["params"], mesh)
    return dict(argument_bytes=args, output_bytes=outs, temp_bytes=temp,
                peak_bytes=args + outs - alias + temp, alias_bytes=alias)


def place_inputs(cell: Cell, dmesh) -> dict:
    """The cell's inputs as meta `DTensor`s on the `DeviceMesh` `dmesh`,
    placed by its shardings' specs."""
    return {k: unflatten(cell.inputs[k], [shd.distribute(t, dmesh, shd.placements(dmesh, s.spec))
                                          for t, s in _pairs(cell.inputs[k], cell.in_sh[k])])
            for k in cell.in_sh}


def _local_batch(d: DTensor, dmesh) -> torch.Tensor:
    """This rank's whole share of a batch-sharded `d`: gathered over every
    mesh axis but the dp axes, which keep their shards."""
    dp = shd.dp_axes(dmesh)
    keep = [p if dmesh.mesh_dim_names[i] in dp else Replicate() for i, p in enumerate(d.placements)]
    return d.redistribute(dmesh, keep).to_local()


def run_step(cfg, shape, cell: Cell, args: dict, dmesh) -> None:
    """The cell's step on its placed inputs, as one rank of `dmesh` runs it."""
    if cell.kind == "train":
        batch = {k: _local_batch(v, dmesh) for k, v in args["batch"].items()}
        step = steps.make_sharded_train_step(cfg, cell.opt_cfg, dmesh)
        step(args["params"], args["opt_state"], batch, 1)
        return
    if cell.kind == "prefill":
        batch = {k: _local_batch(v, dmesh) for k, v in args["batch"].items()}
        step = steps.make_sharded_prefill_step(cfg, shape.seq_len, dmesh, shape.global_batch)
        step(args["params"], batch)
    else:
        step = steps.make_sharded_decode_step(cfg, dmesh, shape.global_batch)
        step(args["params"], _local_batch(args["token"], dmesh), args["caches"], shape.seq_len - 1)


def measure_pass(cfg, shape, mesh, dmesh) -> dict:
    """One rank's flops and collectives for the cell's step at `cfg`'s depth."""
    cell = build_cell(cfg, shape, mesh)
    args = place_inputs(cell, dmesh)
    with FlopCounterMode(display=False) as flops, CommDebugMode() as comms, CollectiveTally() as tally:
        run_step(cfg, shape, cell, args, dmesh)
    if comms.get_total_counts() != len(tally.ops):
        raise AssertionError(f"CommDebugMode counted {comms.get_total_counts()} collectives, "
                             f"the tally {len(tally.ops)}")
    return {"flops": flops.get_total_flops(), "coll": _collective_totals(tally.ops)}


def _depth_variant(cfg, n_reps: int):
    """An n-pattern-rep config: the reference's, for exact per-layer costing.

    Costs are affine in depth, so two shallow passes give exact totals:
        total = c(1) + (reps - 1) * (c(2) - c(1)).
    """
    plen = len(cfg.pattern())
    over = dict(num_layers=plen * n_reps, scan_layers=False, name=cfg.name)
    if cfg.encoder_layers:
        # whisper: encoder depth == decoder depth, one combined slope
        assert cfg.encoder_layers == cfg.reps
        over["encoder_layers"] = n_reps
    return dataclasses.replace(cfg, **over)


def extrapolated_costs(cfg, shape, mesh, dmesh) -> dict:
    """Per-device flops and collectives at full depth from passes at 1 and
    2 reps, and bytes from the full-depth local shapes."""
    c1, c2 = (measure_pass(_depth_variant(cfg, n), shape, mesh, dmesh) for n in (1, 2))
    reps = cfg.reps

    def affine(a, b):
        return a + (reps - 1) * (b - a)

    kinds = set(c1["coll"]["counts"]) | set(c2["coll"]["counts"])
    by_op = {k: affine(c1["coll"].get(k, 0), c2["coll"].get(k, 0)) for k in kinds}
    mem = memory_bytes(cfg, shape, mesh)
    return dict(
        flops_per_device=affine(c1["flops"], c2["flops"]),
        bytes_per_device=mem["argument_bytes"] + mem["output_bytes"] + 2 * mem["temp_bytes"],
        collective_bytes_per_device=affine(c1["coll"]["total_bytes"], c2["coll"]["total_bytes"]),
        wire_bytes_per_device=affine(c1["coll"]["wire_bytes"], c2["coll"]["wire_bytes"]),
        collective_by_op=by_op,
        collective_counts={k: affine(c1["coll"]["counts"].get(k, 0), c2["coll"]["counts"].get(k, 0))
                           for k in kinds},
        memory=mem,
        method=METHOD,
    )


def run_cell(arch: str, shape_name: str, multi_pod: bool, report_dir: str = REPORT_DIR, dmesh=None):
    """One cell's record, written to `report_dir`; in a fake world of its
    own unless `dmesh` (a `DeviceMesh` of the production mesh's axes, from
    `fake_world`) is given."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    status = cell_status(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}"
    os.makedirs(report_dir, exist_ok=True)
    out_path = os.path.join(report_dir, cell_id + ".json")
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": status}
    if status != "run":
        print(f"[dryrun] {cell_id}: {status}")
        with open(out_path, "w") as f:
            json.dump(record, f, indent=2)
        return record

    eff = effective_shape(cfg, shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    try:
        with contextlib.ExitStack() as stack:
            if dmesh is None:
                dmesh = stack.enter_context(fake_world(mesh))
            ri = extrapolated_costs(cfg, eff, mesh, dmesh)
        coll = dict(ri["collective_by_op"], total_bytes=ri["collective_bytes_per_device"],
                    wire_bytes=ri["wire_bytes_per_device"], counts=ri.pop("collective_counts"))
        record.update(
            pass_s=round(time.time() - t0, 2),
            method=METHOD,
            flops_per_device=ri["flops_per_device"],
            bytes_accessed_per_device=ri["bytes_per_device"],
            collectives=coll,
            memory=ri.pop("memory"),
        )
        if not multi_pod:  # the roofline table is single-pod
            record["roofline_inputs"] = ri
        print(
            f"[dryrun] {cell_id}: OK  flops/dev={record['flops_per_device']:.3e} "
            f"coll={coll['total_bytes']:.3e}B  peak={record['memory']['peak_bytes']/2**30:.2f}GiB "
            f"(pass {record['pass_s']:.1f}s)"
        )
    except Exception as e:  # noqa: BLE001 — a failed cell is a finding: recorded, the sweep goes on
        record["status"] = f"FAIL: {type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {cell_id}: FAIL {type(e).__name__}: {str(e)[:400]}")
    with open(out_path, "w") as f:
        json.dump(record, f, indent=2)
    return record


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--report-dir", default=REPORT_DIR)
    args = ap.parse_args()
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch/--shape or --all")
    cells = [(a, s) for a in ARCH_NAMES for s in SHAPES] if args.all else [(args.arch, args.shape)]
    with fake_world(make_production_mesh(multi_pod=args.multi_pod)) as dmesh:
        recs = [run_cell(a, s, args.multi_pod, args.report_dir, dmesh) for a, s in cells]
    raise SystemExit(1 if any(str(r["status"]).startswith("FAIL") for r in recs) else 0)


if __name__ == "__main__":
    main()
