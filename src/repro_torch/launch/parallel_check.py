"""The sharded train and serving steps on a (data, model) mesh of this
host's cards, held against the single-device steps on the global batch,
and both timed.

Each rank draws the same weights (a seeded generator on its card), takes
step 1 of `make_train_step` on the global batch (every dp rank's rows, in
host order) and of `make_sharded_train_step` on its own rows, and compares:
the largest |param or state difference|, the update's error (per leaf,
the 2-norm of the difference of the two updates over the 2-norm of the
single-device update; the worst leaf), and the loss, aux loss and grad
norm.  Then `--steps` more steps of each, timed alike (CUDA events around
each step; the median of steps 2.., the first step apart).  The serving cases
(`SERVE_CASES`) run one device's `T.prefill` and greedy `T.decode_step`s
on the global batch, then `make_sharded_prefill_step` and
`make_sharded_decode_step` on the rank's rows, teacher-forced on those
greedy tokens: the largest relative error of the logits and of every
gathered cache leaf, and the prefill and per-step decode ms of both, timed
alike.  Rank 0 prints one JSON line per case and writes them all to
`--out`.

With `--trace`, step 1 of each train case runs under `BlockTrace` on both
sides, and the first block, routing, mixer or MoE value that differs is
reported (`compare_traces`); `--cases` picks cases by name.
`ssd_head_split` is the same kind of check on one device: the SSD's heads
in the runs a model axis deals out, against the whole call.

Usage (one process per card; NCCL, met through a `file://` store):
  python -m repro_torch.launch.parallel_check --data 2 --model 2 [--out results.json]
  python -m repro_torch.launch.parallel_check --data 2 --model 2 --device cpu   # gloo, reduced cases
  python -m repro_torch.launch.parallel_check --data 1 --model 4 --steps 1 --trace --cases "jamba reduced"
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import make_inputs
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.optim import OptConfig
from repro_torch.tree import leaves

#: (name, arch, optimizer, full width, overrides of that config (the full
#: one or the reduced one), batch per dp rank, seq, compare every leaf):
#: the reduced dense, MoE, SSD, hybrid, encoder-decoder and
#: cross-attention cases of the CPU tests; reduced qwen3-8b with 3 q heads
#: of one kv group, which a model axis of 2 or 4 cuts (each batch row's kv
#: group attended on one rank); and qwen3-moe-30b-a3b at full width and 2
#: layers (its metrics compared, not its 1.55 x 10^9-param leaves, whose
#: host copies would take ~37 GB a rank).
CASES = (
    ("qwen3-8b reduced", "qwen3-8b", "adamw", False, {}, 4, 32, True),
    ("qwen3-8b reduced", "qwen3-8b", "adafactor", False, {}, 4, 32, True),
    ("qwen3-8b reduced, cut heads", "qwen3-8b", "adamw", False, {"num_heads": 3, "num_kv_heads": 1}, 4, 32, True),
    ("qwen3-moe reduced", "qwen3-moe-30b-a3b", "adamw", False, {}, 4, 32, True),
    ("qwen3-moe reduced", "qwen3-moe-30b-a3b", "adafactor", False, {}, 4, 32, True),
    ("mamba2 reduced", "mamba2-780m", "adamw", False, {}, 4, 32, True),
    ("jamba reduced", "jamba-1.5-large-398b", "adamw", False, {}, 4, 32, True),
    ("whisper reduced", "whisper-small", "adamw", False, {}, 4, 32, True),
    ("llama-vision reduced", "llama-3.2-vision-11b", "adamw", False, {}, 4, 32, True),
    ("qwen3-moe full width, 2 layers", "qwen3-moe-30b-a3b", "adamw", True, {"num_layers": 2}, 4, 512, False),
)


#: (name, arch, batch per dp rank, prompt, decode steps): the reduced dense,
#: MoE, SSD, hybrid, encoder-decoder and cross-attention archs, served.
SERVE_CASES = tuple((f"{arch} reduced", arch, 4, 16, 4) for arch in (
    "qwen3-8b", "qwen3-moe-30b-a3b", "mamba2-780m", "jamba-1.5-large-398b", "whisper-small",
    "llama-3.2-vision-11b"))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    """(fn's result, ms): CUDA events on a card, the host clock elsewhere."""
    if device.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn()
        ev[1].record()
        _sync(device)
        return out, ev[0].elapsed_time(ev[1])
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _update_err(a, b, start) -> float:
    """The worst leaf's |(a - start) - (b - start)| / |b - start| (2-norms)."""
    worst = 0.0
    for x, y, z in zip(leaves(a), leaves(b), leaves(start)):
        du, dv = x - z.float(), y.float() - z.float()
        err, size = float(torch.linalg.vector_norm(du - dv)), float(torch.linalg.vector_norm(dv))
        worst = max(worst, err / size if size else (0.0 if err == 0 else float("inf")))
    return worst


class BlockTrace:
    """While entered: the values at `POINTS`, recorded in call order (the
    forward, then remat's recompute): each block's output, each MoE
    routing's experts, and in a Mamba / MoE block the in-projection's
    output (the conv's input), the gated rows (the norm's input), the
    mixer's output and the MoE's output."""

    #: name -> (module, function, what to record of (args, result))
    POINTS = {
        "block": (T, "_apply_block", lambda a, out: out[0]),
        "routing": (L, "_top_k", lambda a, out: out[1]),
        "mixer in_proj": (ssm, "_causal_conv", lambda a, out: a[0]),
        "mixer gated rows": (ssm, "rmsnorm", lambda a, out: a[0]),
        "mixer out": (ssm, "mamba_forward", lambda a, out: out[0]),
        "moe out": (L, "moe", lambda a, out: out[0]),
    }

    def __enter__(self):
        self.records = {name: [] for name in self.POINTS}
        self._saved = {}
        for name, (mod, fn, what) in self.POINTS.items():
            orig = self._saved[name] = getattr(mod, fn)

            def traced(*args, _orig=orig, _what=what, _rec=self.records[name]):
                out = _orig(*args)
                _rec.append(_what(args, out).detach().clone())
                return out

            setattr(mod, fn, traced)
        return self

    def __exit__(self, *exc):
        for name, (mod, fn, _) in self.POINTS.items():
            setattr(mod, fn, self._saved[name])


def compare_traces(single: BlockTrace, sharded: BlockTrace, rank: int, batch: int, hosts: int) -> dict:
    """Per traced point: the calls whose values differ between one device's
    trace (on the global batch) and a rank's (its `batch` rows; a routing's
    tokens batch-major), the first of them and its largest |difference|
    (for routings: the tokens routed otherwise)."""
    out = {}
    for name in BlockTrace.POINTS:
        unequal, first = [], None
        for i, (a, b) in enumerate(zip(single.records[name], sharded.records[name])):
            if name == "routing":
                a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
                per = a.shape[0] // (batch * hosts)
                a = a[rank * batch * per:(rank + 1) * batch * per]
                diff = float((a != b).any(-1).sum())
            else:
                a = a[rank * batch:(rank + 1) * batch]
                diff = float((a.float() - b.float()).abs().max()) if not torch.equal(a, b) else 0.0
            if diff:
                unequal.append(i)
                first = first or {"call": i, "max_abs_diff": diff}
        out[name] = {"calls": [len(single.records[name]), len(sharded.records[name])], "unequal_calls": unequal,
                     "first_unequal": first}
    return out


def run_case(case, mesh, device, steps: int, seed: int = 0, trace: bool = False) -> dict:
    """One train case; with `trace`, step 1 of both steps under `BlockTrace`
    and the two traces compared (`compare_traces`)."""
    name, arch, optimizer, full, over, batch, seq, by_leaf = case
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, **over) if full else cfg.reduced(**over)
    opt = OptConfig(total_steps=steps + 2, warmup_steps=1, optimizer=optimizer)
    rank, hosts = S.data_parallel_rank(mesh)

    def init():
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = T.init_params(cfg, gen, device)
        return params, S.make_opt_init(cfg, opt)(params)

    def batch_at(step, h):
        return SyntheticStream(cfg, batch, seq, seed=seed, host_id=h, num_hosts=hosts).batch_at(step)

    def whole(step):
        parts = [batch_at(step, h) for h in range(hosts)]
        return {k: torch.from_numpy(np.concatenate([p[k] for p in parts])).to(device) for k in parts[0]}

    def local(step):
        return {k: torch.from_numpy(v).to(device) for k, v in batch_at(step, rank).items()}

    single = S.make_train_step(cfg, opt)
    p, s = init()
    host = lambda tree: [t.to("cpu", torch.float32, copy=True) for t in leaves(tree)] if by_leaf else None
    start = host((p, s))
    with BlockTrace() if trace else contextlib.nullcontext() as single_trace:
        (p, s, m1), single_first = _timed(lambda: single(p, s, whole(1), 1), device)
    ref = host((p, s))
    single_ms = [_timed(lambda: single(p, s, whole(k), k), device)[1] for k in range(2, steps + 2)]
    del p, s
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    state = init()
    dp, ds = shd.distribute_tree(state, (shd.param_shardings(mesh, state[0]), shd.opt_shardings(mesh, state[1])))
    del state
    sharded = S.make_sharded_train_step(cfg, opt, mesh)
    with BlockTrace() if trace else contextlib.nullcontext() as sharded_trace:
        (dp, ds, m), sharded_first = _timed(lambda: sharded(dp, ds, local(1), 1), device)
    diff = errs = None
    if by_leaf:
        got = [t.full_tensor().to("cpu", torch.float32) for t in leaves((dp, ds))]
        n = len(leaves(dp))
        diff = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        errs = {"param": _update_err(got[:n], ref[:n], start[:n]),
                "state": _update_err(got[n:], ref[n:], start[n:])}
        del got
    del ref, start
    sharded_ms = [_timed(lambda: sharded(dp, ds, local(k), k), device)[1] for k in range(2, steps + 2)]
    rel = {k: abs(float(m[k]) - float(m1[k])) / max(abs(float(m1[k])), 1e-30) for k in ("loss", "aux", "grad_norm")}
    out = {"case": name, "arch": arch, "optimizer": optimizer, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "experts": cfg.num_experts, "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "batch_per_dp_rank": batch, "seq": seq, "max_abs_diff": diff, "update_err": errs,
           "rel_diff": rel, "loss": float(m["loss"]), "single_loss": float(m1["loss"]),
           "sharded_first_ms": sharded_first, "single_first_ms": single_first,
           "sharded_step_ms": float(np.median(sharded_ms)), "single_step_ms": float(np.median(single_ms)),
           "sharded_ms_all": sharded_ms, "single_ms_all": single_ms}
    if device.type == "cuda":
        out["sharded_peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
    if trace:
        out["trace"] = compare_traces(single_trace, sharded_trace, rank, batch, hosts)
    return out


def _rel(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.float(), got.float()
    return float((ref - got).abs().max() / ref.abs().max().clamp_min(1e-30))


def run_serve_case(case, mesh, device, seed: int = 0) -> dict:
    """One serving case: one device's prefill and greedy decode steps on the
    global batch, then the sharded steps on this rank's rows, teacher-forced
    on the same tokens; their distance and both timed alike."""
    name, arch, batch, prompt, gen = case
    cfg = get_config(arch).reduced()
    rank, hosts = S.data_parallel_rank(mesh)
    rng = torch.Generator(device=device)
    rng.manual_seed(seed)
    params = T.init_params(cfg, rng, device)
    inputs = {k: torch.from_numpy(v).to(device) for k, v in make_inputs(cfg, batch * hosts, prompt, seed).items()}
    cache_len = prompt + gen
    with torch.inference_mode():
        (logits, caches), single_prefill = _timed(lambda: T.prefill(params, cfg, inputs, cache_len), device)
        ref, tokens, single_ms = [logits], [], []
        for i in range(gen):
            tokens.append(torch.argmax(ref[-1], dim=-1).to(torch.int32))
            (logits, caches), ms = _timed(lambda: T.decode_step(params, cfg, tokens[-1], caches, prompt + i), device)
            ref.append(logits)
            single_ms.append(ms)
        placed = shd.distribute_tree(params, shd.param_shardings(mesh, params))
        prefill, decode = S.make_sharded_prefill_step(cfg, cache_len, mesh), S.make_sharded_decode_step(cfg, mesh)
        rows = slice(rank * batch, (rank + 1) * batch)
        (logits, got_caches), sharded_prefill = _timed(
            lambda: prefill(placed, {k: v[rows] for k, v in inputs.items()}), device)
        got, sharded_ms = [logits], []
        for i, tok in enumerate(tokens):
            (logits, got_caches), ms = _timed(lambda: decode(placed, tok[rows], got_caches, prompt + i), device)
            got.append(logits)
            sharded_ms.append(ms)
        logit_err = max(_rel(a, b.full_tensor()) for a, b in zip(ref, got))
        cache_err = max(_rel(c[k], g[k].full_tensor()) for c, g in zip(caches, got_caches) for k in c)
    return {"case": name, "arch": arch, "kind": "serve", "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "batch_per_dp_rank": batch, "prompt": prompt, "gen": gen, "logits_rel_err": logit_err,
            "caches_rel_err": cache_err, "sharded_prefill_ms": sharded_prefill, "single_prefill_ms": single_prefill,
            "sharded_decode_ms": float(np.median(sharded_ms)), "single_decode_ms": float(np.median(single_ms)),
            "sharded_decode_ms_all": sharded_ms, "single_decode_ms_all": single_ms}


#: The SSD head-split checks (`ssd_head_split`): (name, arch, full width,
#: batch, seq) in the baseline form: reduced mamba2 and jamba at the train
#: cases' batch and seq, and mamba2-780m at full width (48 heads) at the
#: train phase's batch 4 x seq 512.
SSD_SPLITS = (("mamba2 reduced", "mamba2-780m", False, 4, 32),
              ("jamba reduced", "jamba-1.5-large-398b", False, 4, 32),
              ("mamba2-780m", "mamba2-780m", True, 4, 512))


def ssd_head_split(arch: str, runs: int, device, full: bool = False, batch: int = 4, seq: int = 32,
                   seed: int = 0) -> dict:
    """A mixer's SSD (`ssm._ssd_heads`, baseline form) on one device, on all
    its heads and on its heads split into `runs` runs as the sharded step's
    ranks hold them (`parallel.split_to_model`: runs of ceil(H / runs), each
    a contiguous copy; the rank's `a_log` / `dt_bias` / `skip_d` shards and
    its place among the heads, `parallel.model_run`; the cotangent's run of
    the heads), forward and backward under
    `layers.f32_accumulation`, as the train step runs it.  The inputs are
    laid out as `ssm.mamba_forward` hands them over (z, x and dt column
    slices of one projection, B and C expanded to heads).  Per output (y,
    the final state) and grad (z, x, B, C, dt, `a_log`, `dt_bias`,
    `skip_d`): whether the runs' results, concatenated, equal the whole
    call's (`torch.equal`), and the largest |difference|."""
    device = torch.device(device)
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, ssm_impl="baseline") if full else cfg.reduced(ssm_impl="baseline")
    b, s, h, hp, n = batch, seq, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(device, dtype)

    proj = draw(b, s, 2 * cfg.d_inner + 2 * cfg.ssm_groups * n + h)
    z, xbc, dt = ssm._split_proj(cfg, proj)
    xi, B, C = ssm._split_xbc(cfg, xbc)
    inputs = {"z": z.reshape(b, s, h, hp), "x": xi.reshape(b, s, h, hp), "B": ssm._expand_groups(cfg, B),
              "C": ssm._expand_groups(cfg, C), "dt": dt}
    params = {"a_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32, device=device))
              + draw(h, scale=0.1, dtype=torch.float32),
              "dt_bias": draw(h, scale=0.5, dtype=torch.float32),
              "skip_d": 1 + draw(h, scale=0.1, dtype=torch.float32)}
    gy, gs = draw(b, s, h, hp), draw(b, h, hp, n)

    def run(ins, ps, gy_run, gs_run, place=None):
        ins = {k: v.detach().requires_grad_() for k, v in ins.items()}
        ps = {k: v.detach().clone().requires_grad_() for k, v in ps.items()}
        with L.f32_accumulation():
            y, state = ssm._ssd_heads(ps, cfg, ins["z"], ins["x"], ins["B"], ins["C"], ins["dt"], place=place)
            grads = torch.autograd.grad((y, state), [*ins.values(), *ps.values()],
                                        (gy_run.reshape(y.shape), gs_run))
        return {"y": y.detach().reshape(gy_run.shape), "state": state.detach(),
                **dict(zip([*ins, *ps], grads))}

    whole = run(inputs, params, gy, gs)  # on the views, laid out as the mixer's
    per = -(-h // runs)
    parts = []
    for lo in range(0, h, per):
        hi = min(lo + per, h)
        parts.append(run({k: v.narrow(2, lo, hi - lo).contiguous() for k, v in inputs.items()},
                         {k: v[lo:hi] for k, v in params.items()}, gy[:, :, lo:hi].contiguous(),
                         gs[:, lo:hi].contiguous(), (lo, h)))
    head_dim = {"state": 1, "a_log": 0, "dt_bias": 0, "skip_d": 0}
    out = {}
    for name, ref in whole.items():
        got = torch.cat([p[name] for p in parts], dim=head_dim.get(name, 2))
        out[name] = {"equal": bool(torch.equal(got, ref)), "max_abs_diff": float((got.float() - ref.float()).abs().max())}
    return {"arch": arch, "full_width": full, "heads": h, "runs": runs, "heads_per_run": per, "batch": b, "seq": s,
            "exact": all(v["equal"] for v in out.values()), "tensors": out}


def _rank(rank, world, args, store):
    cuda = args.device == "cuda"
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=300))
    try:
        mesh = make_host_mesh(data=args.data, model=args.model, device=device.type)
        records = []
        train = CASES if cuda else [c for c in CASES if not c[3]]  # full width on cards only
        runs = [(run_case, c, args.steps, 0, args.trace) for c in train] + [(run_serve_case, c) for c in SERVE_CASES]
        if args.cases:
            runs = [r for r in runs if r[1][0] in args.cases.split(",")]
        for fn, case, *more in runs:
            records.append(fn(case, mesh, device, *more))
            if rank == 0:
                print(json.dumps(records[-1]), flush=True)
            if cuda:
                torch.cuda.empty_cache()
        if rank == 0 and args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(records, f, indent=1)
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5, help="timed steps after step 1")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--cases", default=None, help="comma-separated case names (default: all)")
    ap.add_argument("--trace", action="store_true", help="compare the train cases' step 1 block by block")
    args = ap.parse_args()
    world = args.data * args.model
    if args.device == "cuda" and torch.cuda.device_count() < world:
        raise SystemExit(f"{world} ranks need {world} cards; {torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(world, args, os.path.join(tmp, "store")), nprocs=world, join=True)


if __name__ == "__main__":
    main()
