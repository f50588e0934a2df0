"""Fault-tolerant training loop, on the card: the port of the JAX
package's `repro/launch/train.py`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt [--full] [--device cpu]

Behaviours, as in the reference:
  * auto-resume from the latest complete checkpoint (the restart-safe data
    pipeline replays the exact stream position);
  * per-step failure handling: a failed step (device error, NaN loss,
    injected fault) rolls back to the last checkpoint and retries with
    the same data, bounded by `max_retries`;
  * straggler accounting: a per-step deadline; steps exceeding it are
    logged and counted;
  * elastic re-mesh: checkpoints are whole arrays, so a restart under a
    different mesh re-shards on load.
Without `mesh` the state lives on one `device`, the card unless the caller
asks for another (without a card `train` raises).  With a `DeviceMesh`
`mesh` (every rank of the initialised process group calls `train`) the
params and optimizer state are `DTensor`s placed by the sharding rules,
each rank reads its dp shard of the stream, and the step is
`steps.make_sharded_train_step`.  The train step updates params and
optimizer state in place, so a failed step may leave them half updated;
the rollback restores both from the checkpoint.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.device import resolve
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.serve import _sync, to_device
from repro_torch.models import transformer as T
from repro_torch.optim import OptConfig


class FaultInjector:
    """Deterministically fails chosen steps (for tests / demos)."""

    def __init__(self, fail_steps=(), exc=RuntimeError):
        self.fail_steps = set(fail_steps)
        self.exc = exc
        self.fired = set()

    def check(self, step: int):
        if step in self.fail_steps and step not in self.fired:
            self.fired.add(step)
            raise self.exc(f"injected fault at step {step}")


def train(
    arch,
    steps: int,
    batch: int,
    seq: int,
    ckpt_dir: str,
    reduced: bool = True,
    ckpt_every: int = 20,
    max_retries: int = 3,
    step_deadline_s: float = 120.0,
    seed: int = 0,
    injector: FaultInjector | None = None,
    mesh=None,
    log_every: int = 10,
    device=None,
):
    """arch: registry name or a ModelConfig instance (custom models).
    Returns (params, opt_state, history), history one {"step", "loss",
    "time_s"} per step run, retries included."""
    dev = resolve(device)
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if reduced and isinstance(arch, str):
        cfg = cfg.reduced()
    opt_cfg = OptConfig(total_steps=steps, warmup_steps=max(1, steps // 20))
    mgr = CheckpointManager(ckpt_dir)
    injector = injector or FaultInjector()
    example = (steps_lib.param_specs(cfg), steps_lib.opt_specs(cfg, opt_cfg))
    shardings = None
    if mesh is None:
        stream = SyntheticStream(cfg, batch, seq, seed=seed)
        train_step = steps_lib.make_train_step(cfg, opt_cfg)
    else:
        host_id, num_hosts = steps_lib.data_parallel_rank(mesh)
        stream = SyntheticStream(cfg, batch, seq, seed=seed, host_id=host_id, num_hosts=num_hosts)
        train_step = steps_lib.make_sharded_train_step(cfg, opt_cfg, mesh)
        shardings = (shd.param_shardings(mesh, example[0]), shd.opt_shardings(mesh, example[1]))

    start_step = 0
    latest = mgr.latest_step()
    if latest is not None:
        (params, opt_state), _ = mgr.restore(latest, example, dev, mesh, shardings)
        start_step = latest
        print(f"[train] resumed from checkpoint step {latest}")
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = T.init_params(cfg, gen, dev)
        opt_state = steps_lib.make_opt_init(cfg, opt_cfg)(params)
        if mesh is not None:
            params, opt_state = shd.distribute_tree((params, opt_state), shardings)
        mgr.save(0, (params, opt_state))

    # -- loop ----------------------------------------------------------------
    history = []
    stragglers = 0
    step = start_step
    retries = 0
    while step < steps:
        batch_np = stream.batch_at(step)
        _sync(dev)
        t0 = time.time()
        try:
            injector.check(step)
            params, opt_state, metrics = train_step(params, opt_state, to_device(batch_np, dev), step)
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}")
        except Exception as e:  # noqa: BLE001 — rollback + retry
            retries += 1
            if retries > max_retries:
                raise RuntimeError(f"step {step}: exceeded max retries") from e
            latest = mgr.latest_step()
            print(f"[train] step {step} failed ({e}); rolling back to ckpt {latest} "
                  f"(retry {retries}/{max_retries})")
            params = opt_state = None  # free the device state before the restore
            (params, opt_state), _ = mgr.restore(latest, example, dev, mesh, shardings)
            step = latest
            continue
        _sync(dev)
        dt = time.time() - t0
        if dt > step_deadline_s:
            stragglers += 1
            print(f"[train] step {step} exceeded deadline ({dt:.1f}s) — straggler logged")
        retries = 0
        if step % log_every == 0:
            print(f"[train] step {step} loss {loss:.4f} lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} ({dt:.2f}s)")
        history.append({"step": step, "loss": loss, "time_s": dt})
        step += 1
        if step % ckpt_every == 0 or step == steps:
            mgr.save(step, (params, opt_state), blocking=False)
    mgr.wait()
    summary = {
        "arch": cfg.name,
        "steps": steps,
        "final_loss": history[-1]["loss"] if history else None,
        "first_loss": history[0]["loss"] if history else None,
        "stragglers": stragglers,
        "device": str(dev),
    }
    print("[train] done:", json.dumps(summary))
    return params, opt_state, history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--full", action="store_true", help="full (paper) config")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--inject-failure", type=int, default=None)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    injector = FaultInjector([args.inject_failure]) if args.inject_failure else None
    train(
        args.arch,
        args.steps,
        args.batch,
        args.seq,
        args.ckpt_dir,
        reduced=not args.full,
        ckpt_every=args.ckpt_every,
        injector=injector,
        device=args.device,
    )


if __name__ == "__main__":
    main()
