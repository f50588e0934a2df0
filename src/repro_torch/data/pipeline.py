"""Deterministic synthetic data pipeline with host sharding + prefetch: the
port's own copy of the JAX package's `repro/data/pipeline.py` (pure numpy),
so that both packages draw the same batches for a seed.

Design goals mirrored from production loaders:
  * deterministic as a function of (seed, step, host) — restart-safe, so
    checkpoint resume replays the exact same stream with no state file;
  * host-sharded: each host materializes only its slice of the global
    batch (global_batch // num_hosts rows);
  * background prefetch thread with a bounded queue.

The "dataset" is a Zipf-ish synthetic token stream (cheap, stationary,
non-trivial unigram distribution so losses are meaningful); frontends
for VLM/audio stubs emit deterministic pseudo-embeddings.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.configs.base import ModelConfig


class SyntheticStream:
    def __init__(
        self,
        cfg: ModelConfig,
        global_batch: int,
        seq_len: int,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
    ):
        assert global_batch % num_hosts == 0
        self.cfg = cfg
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.seq_len = seq_len
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts

    def _rng(self, step: int) -> np.random.Generator:
        seq = np.random.SeedSequence([self.seed, step, self.host_id, 0xDA7A])
        return np.random.Generator(np.random.Philox(seq))

    def batch_at(self, step: int) -> dict:
        """The batch for a given global step (pure function of step)."""
        rng = self._rng(step)
        v = self.cfg.vocab_size
        ranks = rng.zipf(1.3, size=(self.local_batch, self.seq_len)).astype(np.int64)
        tokens = (ranks % (v - 2)) + 1  # avoid 0 (pad) / v-1 (reserved)
        out = {"tokens": tokens.astype(np.int32)}
        if self.cfg.num_image_tokens:
            out["image_embeds"] = rng.standard_normal(
                (self.local_batch, self.cfg.num_image_tokens, self.cfg.d_model), np.float32
            )
        if self.cfg.encoder_layers:
            out["frames"] = rng.standard_normal(
                (self.local_batch, self.cfg.encoder_seq, self.cfg.d_model), np.float32
            )
        return out

    def iterate(self, start_step: int = 0, prefetch: int = 2):
        """Background-prefetched iterator from `start_step` on."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                try:
                    q.put((step, self.batch_at(step)), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
