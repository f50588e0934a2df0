"""Serving entry point: batched prefill + greedy decode with KV/SSM caches,
on the card.  The port of the JAX package's `repro/launch/serve.py`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --full \
        --batch 4 --prompt-len 128 --gen 32

A request batcher fills a fixed-size decode batch; prefill runs per
micro-batch and decode steps run lock-step across the batch.  `serve`
draws the prompt (and image embeddings or frames) with the reference's
numpy calls, so both packages see the same inputs for a seed; the weights
are random, from the seed.  `generate` is the greedy loop alone, over any
`Transformer`.  The default device is the card; without one, `serve`
raises (it never carries on on the CPU unless asked to).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve
from repro_torch.launch import steps as steps_lib
from repro_torch.models.transformer import Transformer


def make_inputs(cfg, batch: int, prompt_len: int, seed: int = 0) -> dict:
    """The prompt tokens (int32) and, where the arch takes them, image
    embeddings or audio frames (float32), as numpy arrays drawn as the
    reference's `serve` draws them."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, cfg.vocab_size - 1, (batch, prompt_len)).astype(np.int32)}
    if cfg.num_image_tokens:
        out["image_embeds"] = rng.standard_normal((batch, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def to_device(inputs: dict, device) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in inputs.items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Transformer, batch_inputs: dict, prompt_len: int, gen: int) -> dict:
    """Prefill `batch_inputs` (tensors on the model's device), then `gen - 1`
    greedy decode steps in lock-step.  Returns the generated tokens (B, gen)
    as numpy, the prefill and decode seconds (the device synchronised before
    each clock read), tokens/s, and on a card each decode step's ms from
    CUDA events recorded on the stream between the steps."""
    cfg = model.cfg
    device = batch_inputs["tokens"].device
    prefill = steps_lib.make_prefill_step(cfg, prompt_len + gen)
    decode = steps_lib.make_decode_step(cfg)
    on_card = device.type == "cuda"
    with torch.inference_mode():
        params = model.params
        _sync(device)
        t0 = time.perf_counter()
        logits, caches = prefill(params, batch_inputs)
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        out_tokens = [token]
        _sync(device)
        t_prefill = time.perf_counter() - t0

        events = []
        t0 = time.perf_counter()
        if on_card:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        for i in range(gen - 1):
            logits, caches = decode(params, token, caches, prompt_len + i)
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            out_tokens.append(token)
            if on_card:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        _sync(device)
        t_decode = time.perf_counter() - t0
    batch = batch_inputs["tokens"].shape[0]
    return {
        "generated": torch.stack(out_tokens, dim=1).cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
        "step_ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])] if on_card else None,
    }


def serve(
    arch: str,
    batch: int = 4,
    prompt_len: int = 32,
    gen: int = 16,
    reduced: bool = True,
    seed: int = 0,
    device=None,
):
    """Random weights from `seed`, the reference's prompt for `seed`, then
    `generate`.  The result also holds the `model` and its `inputs` (on the
    device), for checks on the same weights."""
    dev = resolve(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = Transformer.init(cfg, seed, dev)
    inputs = to_device(make_inputs(cfg, batch, prompt_len, seed), dev)
    res = generate(model, inputs, prompt_len, gen)
    return {**res, "model": model, "inputs": inputs, "device": str(dev)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    res = serve(args.arch, args.batch, args.prompt_len, args.gen, reduced=not args.full,
                device=args.device)
    print(f"prefill {res['prefill_s']:.2f}s  decode {res['decode_s']:.2f}s "
          f"({res['tok_per_s']:.1f} tok/s) on {res['device']}")
    print("sample tokens:", res["generated"][0][:12])


if __name__ == "__main__":
    main()
