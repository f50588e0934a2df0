#!/usr/bin/env python3
"""Drives the port's main paths on one NVIDIA card and checks its kernels.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card

Phases, one JSON line each:
  1. device   the card's name, count and power limit;
  2. build    nvcc build of `src/repro_torch/kernels/csrc/` with ptxas's
              register / shared-memory report (a stack frame or a spill
              fails the run), then a `sass` line: each kernel's SASS
              instruction mix, where the toolkit has `cuobjdump`;
  3. check    each kernel (ntt_tile, ntt_pair, modmul) against its plain
              torch version on the card, bit-exact, both directions, in
              place and out of place, at the main shapes and on a grid of
              edge cases (tiles 2 to 32768, 1 to 6 inter-tile stages); then
              `silu_fwd` / `silu_bwd` (the LM path's silu as the reference
              rounds it) against theirs, bit for bit, at the LM's shapes
              (`SILU_SHAPES`: qwen3-4b's MLP hidden, mamba2-780m's conv
              output and its gate read where it lies in the projection, a
              column slice whose start and row stride are not 16-byte
              aligned), a and its cotangent at different 16-byte phases,
              every bf16 a against cotangents of every magnitude
              (`SILU_H_BITS`), an expert path's permuted einsum output and
              every bf16 value, in bf16 and f32; `softplus_fwd` /
              `softplus_bwd` (the SSD's softplus as XLA's CPU rounds it)
              against theirs on all 2^32 f32 patterns (with the count of
              elements each kernel took through the CPU's ops) and at
              mamba2-780m's dt, contiguous and as rows;
              and part `split_products`: `parallel.block_of_product` against
              the whole product's block for jamba's and mamba2's in-projection
              splits over 4 ranks, with the width each block takes;
  4. main     `polymul_ntt` at n=65536 x batch 64 and n=4096 x batch 1024
              (16 MiB per operand: an RNS-CKKS batch of 64 towers at
              logN=16, and a batch of logN=12 polynomials), bit-exact
              against the numpy stage loop on sampled rows and against the
              plain torch path on all rows, plus intt(ntt(x)) == x; every
              kernel must have launched during this phase;
  5. rns      the RNS-CKKS path (`repro_torch.he`) at the logN = 16 level of
              a chain, n=65536 with L=16 towers: `relin_key`, then
              `ct_mul_relin` of two random ciphertexts and `rescale`,
              bit-exact against the same ops on the CPU plain path (the key
              copied over) on every tower, the keyswitch identity in the NTT
              domain checked with the numpy stage loop on sampled towers,
              and the launches of each drive equal to `rns_launches`;
  7. pimsys   the simulator stack (`repro_torch.pimsys`, `repro_torch.he.ops`):
              (a) on the card, `PimSession(..., device="cuda")` over 4
              channels x 4 banks compiles `CtMulRelinOp(n=65536, towers=16)`
              and runs it with `time=False` on the rns phase's ciphertexts
              and key; the value must be bit-exact with the rns phase's
              `ct_mul_relin` and the launches equal `rns_launches`; its wall
              time beside the direct `he.ct_mul_relin` call is the session
              layer's host cost; (b) on the host, the golden records of
              `tests/golden/engine_goldens.json` and the `he/mix/*/N=256`
              latencies of `BENCH_he.json` replayed exactly, and the
              modeled PIM latency of `CtMulRelinOp(n=4096, towers=8)`
              (simulator output, not device time);
  8. timing   CUDA-event times per launch beside the bound (the larger of
              bytes over the memory rate and integer instructions over the
              issue rate), the plain version and a library call where one
              exists, the whole polymul_ntt, and the RNS ops ct_mul,
              keyswitch, ct_mul_relin and rescale beside their floors; the
              silu kernels at `SILU_TIMED` beside their byte bound,
              their plain versions and `F.silu` / `aten.silu_backward`, the
              build time of each kernel's table and the host's enqueue time
              per call; the softplus kernels at
              `SOFTPLUS_SHAPES` beside theirs and `F.softplus` /
              `aten.softplus_backward`; each beside an empty kernel's time
              at its launch shape (the launch floor).
  9. lm       the LM serving path (`repro_torch.launch.serve`) on the card:
              qwen3-4b (36 layers, d_model 2560, vocab 151936) and
              mamba2-780m served at full size (batch 4, prompt 128, 32
              tokens) with prefill ms, decode ms per token, tokens/s, peak
              memory and the profiler's busy share of a decode step, and
              prefill/decode checked against a full forward; qwen3-4b's full
              width at 2 layers and the ten archs reduced, card against CPU
              on the same weights; then the fastpath chain
              (`evaluate_gang(backend="torch")`) over its grid, bit-identical
              to `backend="numpy"`, with its chains' statistics, the kernel's
              summed device time and each chain's round trip broken down
              (host prep, kernel, launch and sync); and `chain_fold` against
              its plain version and `np.cumsum` (the round trip and the
              kernel alone), timed at 96 x 16 and 5 x 8 on the round trip's
              pinned buffers (as the path runs it) and on device memory,
              beside the dependency bound from the `fold_dadd_probe` DADD
              latency and the roofline bound.  The LM path launches
              `silu_fwd` (and `softplus_fwd` for mamba2-780m) and none of
              B1-B3.
 10. train    the LM training core (`repro_torch.launch.{steps,train}`):
              (a) qwen3-4b at full size (remat, AdamW with bf16 moments) and
              (b) mamba2-780m at full size (f32 AdamW), 8 steps each at batch
              4 x seq 512 from `SyntheticStream(seed=0)`: first-step ms, step
              ms (CUDA events), tokens/s, model TFLOP/s and its share of the
              card's bf16 peak (`mfu`), peak memory, the profiler's busy
              share and kernel classes of one step, loss and grad norm per
              step, every loss and grad finite and the last 3 losses below
              the first 3; (c) `train()` at reduced qwen3-4b with
              checkpoints, 10 steps then a resume to 16 with a fault injected
              at 13, the exact step list, and a restore equal bit for bit to
              the state it saved; (d) loss and every grad of the ten reduced
              archs, card against CPU on the same weights.  The path
              launches `silu_fwd` and `silu_bwd` (and the softplus pair
              for mamba2-780m) and no other kernel.
 11. dist     the distribution layer (`repro_torch.distributed`,
              `launch.{mesh,steps,dryrun}`) with NCCL at world size 1,
              met through a `file://` store in a temporary directory, on a
              1 x 1 (data, model) `DeviceMesh` on the card: (a) qwen3-4b at
              full width with phase 10's weights and batch (batch 4 x seq
              512, remat, bf16 AdamW moments): `compressed_psum` and
              `hierarchical_grad_sync` over NCCL on step 1's grads, equal
              to `ef_decompress` of their codes, then the unsharded step 1
              (its loss, params and moments copied to the host) and
              `make_sharded_train_step` on `DTensor` state from the same
              seed: the loss and every updated leaf equal bit for bit (at
              world size 1 every collective is an identity), steps 2-8 timed
              (CUDA events), tokens/s and peak memory, and one more step
              of each under the profiler (busy ms by kernel class); then
              the same for
              qwen3-moe-30b-a3b at full width (128 experts, top 8,
              d_model 2048, vocab 151936) and 4 of its 48 layers, f32
              AdamW, without the compression check: step 1's loss, aux
              loss, grad norm and every leaf bit-exact, both steps timed
              alike, peak memory; and so for the other mixers
              (`DIST_MIXERS`): mamba2-780m (the SSD) and whisper-small
              (encoder, `attn_cross`) at full size, llama-3.2-vision-11b
              (the `cross` mixer) at full width and 5 layers; (b) the
              lm phase's serves (qwen3-4b and mamba2-780m at full size,
              batch 4, prompt 128, 32 tokens) through
              `make_sharded_prefill_step` / `make_sharded_decode_step` on
              `DTensor` params and caches: the greedy tokens, every step's
              logits and every cache leaf equal bit for bit to the
              unsharded steps' on the same weights, prefill and decode
              ms per step of both timed alike; then the part
              `ssd_head_split`: the SSD of reduced mamba2, reduced jamba
              and full-width mamba2-780m whole and in the runs of heads of
              4 and 2 ranks on this card, forward and backward, every
              output and grad bit for bit (`parallel_check.ssd_head_split`);
              (c) the dry-run sweep, all
              40 cells of the 16 x 16 mesh (`python -m
              repro_torch.launch.dryrun --all`, the serving cells through
              the sharded steps) in a child interpreter on the host, beside
              (a) and (b): its host seconds, the counts of run / skip / FAIL
              cells (a FAIL fails the phase) and each cell's roofline row.
              The path launches `silu_fwd` and `silu_bwd` (and the softplus
              pair for the SSD archs) and no other kernel.
Then the `kernels` line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failed check raises (exit code != 0).
Imports nothing of `jax` or `repro`.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import he, kernels  # noqa: E402
from repro_torch.core import modmath as mm  # noqa: E402
from repro_torch.core import ntt as ntt_core  # noqa: E402
from repro_torch.core.mapping import RowCentricMapper  # noqa: E402
from repro_torch.core.pim_config import PimConfig  # noqa: E402
from repro_torch.core.pimsim import BankTimer, analytic_multibank_bound  # noqa: E402
from repro_torch.pimsys import (  # noqa: E402
    ChannelController,
    NttJob,
    PimSession,
    PolymulJob,
    RequestScheduler,
    ShardedNttPlan,
    evaluate_gang,
    lower_commands,
    param_beat_trace,
    verify_stream,
)
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    compressed_psum,
    ef_compress,
    ef_decompress,
    hierarchical_grad_sync,
)
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticStream  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.launch.roofline import model_flops  # noqa: E402
from repro_torch.launch.train import FaultInjector, train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.tree import keystr, leaves, leaves_with_path, tree_map  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import fold as kfold  # noqa: E402
from repro_torch.pimsys.fastpath import evaluate as fp_evaluate  # noqa: E402
from repro_torch.launch.serve import make_inputs, serve, to_device  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.kernels import modmul as kmod  # noqa: E402
from repro_torch.kernels import silu as ksilu  # noqa: E402
from repro_torch.kernels import softplus as ksoftplus  # noqa: E402
from repro_torch.distributed import parallel as dparallel  # noqa: E402
from repro_torch.launch import parallel_check  # noqa: E402
from repro_torch.kernels import ntt as kntt  # noqa: E402

#: Published H100 SXM memory rate (NVIDIA data sheet); byte bounds are bytes over it.
HBM_BYTES_PER_S = 3.35e12
#: Op bounds: an SM issues 4 warp instructions (128 lane operations) per
#: clock, at most, at the card's maximum SM clock (nvidia-smi clocks.max.sm).
LANE_OPS_PER_SM_CLOCK = 128
#: Instructions per butterfly on sm_90a, read from the kernels' SASS
#: (`cuobjdump -sass`): the Shoup product as IMAD.HI + IMAD + IMAD, the add
#: and the subtract as IMAD.IADD each, and the three reductions mod q as one
#: VIADDMNMX each (the source's formulas count 11: see csrc/modmath.cuh).
OPS_PER_BUTTERFLY = 8
SEED = 0
TILE = 8192
#: (batch, n) of the main path: 64 x 65536 runs one B2 launch of 3 stages
#: and one B1 per transform, 1024 x 4096 runs the fused B1.
MAIN_SHAPES = ((64, 65536), (1024, 4096))
#: (batch, n, tile) edge cases of the check phase: tiles 2 to MAX_TILE
#: (B1's groups of up to 5 stages meet tiles of 1 to 15 stages), and
#: n / tile in {2, 8, 16, 32, 64}, which gives B2 groups for 1, 3, 4, 5 and
#: 6 inter-tile stages (at most 4 per launch).
CHECK_SHAPES = (
    (3, 2, 2), (5, 16, 16), (3, 32, 32), (2, 128, 128),
    (3, 64, 2), (3, 256, 8), (2, 1024, 16), (5, 512, 32),
    (3, 128, 64), (2, 4096, 64), (2, 2048, 128), (4, 8192, 1024), (2, 16384, 2048),
    (1, 32768, 32768), (2, 65536, 32768),
)
#: (n, towers) of the rns phase: the logN = 16 level of an RNS-CKKS chain,
#: 16 towers from rns_primes(65536, 16) (q from 2147352577 down, Q ~ 496 bits).
RNS_SHAPE = (65536, 16)
#: Towers of the rns phase checked against the numpy stage loop.
RNS_SAMPLE = 4
RNS_OPS = ("ct_mul", "keyswitch", "ct_mul_relin", "rescale")
#: The pimsys phase's devices: `benchmarks/he_ops.py`'s FULL_CFG (4 channels
#: x 4 banks) for the full-width op, its QUICK_CFG for the BENCH_he.json points.
PIMSYS_CFG = dict(num_channels=4, num_banks=4, param_cache_entries=16)
PIMSYS_QUICK_CFG = dict(num_channels=2, num_banks=4, param_cache_entries=16)
#: (n, towers) of the pimsys phase's timed simulation (host seconds ~20).
PIMSYS_MODELED = (4096, 8)
GOLDEN_PATH = os.path.join(ROOT, "tests", "golden", "engine_goldens.json")
BENCH_HE_PATH = os.path.join(ROOT, "BENCH_he.json")
L2_BYTES = 50 * 2**20
#: `torch.cuda._sleep` spins for clock cycles; the SM clock is at most
#: ~2 GHz, so this many cycles last at least 1 ms.
SLEEP_CYCLES_PER_MS = 2_000_000
#: The lm phase's full-size serves: (arch, batch, prompt_len, gen).
LM_SERVE = (("qwen3-4b", 4, 128, 32), ("mamba2-780m", 4, 128, 32))
#: Prefill/decode against a full forward: `tests/test_archs.py`'s bound
#: (rtol = atol = 0.2, set for its reduced configs).  The SSD's recurrent
#: decode drifts from its chunked form in bf16 as layers are added, in the
#: reference as in the port (tests/test_torch_serve.py::
#: test_ssd_decode_drift_tracks_reference, mamba2-780m at full width on the
#: CPU: the reference's max |decode - forward| is 0.0469 / 0.1016 / 0.1328
#: at 4 / 16 / 32 layers).  mamba2-780m's 48 layers measured 0.242 on the
#: card; its bound is 0.265, twice the reference's own drift at 32 layers.
LM_CONSISTENCY_TOL = {"*": 0.2, "mamba2-780m": 0.265}
#: Card against CPU on the same weights, max |card - cpu| / max |cpu| of
#: the logits: twice the largest reading on the card when it was set
#: (NVIDIA H100 80GB HBM3, 0.0135 for llama-3.2-vision; jamba 0.060, whose
#: bf16 router logits tie exactly, so that one token's routing differed
#: between the two devices).  With silu rounded as the reference on both
#: devices the readings are 0.0211 (llama-3.2-vision) and jamba 0.0215, no
#: flip: the bounds stay, since a tie can still break either way.
LM_CARD_TOL = {"*": 0.027, "jamba-1.5-large-398b": 0.12}
#: tests/test_torch_pimsys.py's fastpath grid: (n, banks, entries, nb, pipelined).
FASTPATH_GRID = ((64, 1, 0, 2, True), (64, 16, 128, 2, False), (128, 3, 4, 4, True),
                 (128, 8, 0, 4, False), (256, 5, 128, 2, True), (256, 12, 4, 4, True),
                 (256, 2, 32, 4, True), (256, 8, 32, 4, True))
#: FP64 adds outside the tensor cores, per second (NVIDIA H100 SXM data sheet).
FP64_FLOPS = 34e12
#: (K rounds, banks) of the chain checks: the fastpath's block at 16 and 8
#: banks, edge lengths, and 512 x 32 (16 of the kernel's segments of 1024 bank steps).
FOLD_SHAPES = ((96, 16), (96, 8), (1, 1), (3, 1), (2, 5), (40, 3), (512, 32), (0, 4))
#: (K rounds, banks) timed: the fastpath's block at 16 banks (3,072 adds) and
#: the grid's median chain (80 adds).
FOLD_TIMED = ((96, 16), (5, 8))
#: Rounds x 16 banks timed for the kernel's cost an add (the slope of its
#: time against the adds) and its fixed cost (the intercept).
FOLD_FIT_ROUNDS = (32, 96, 256, 512)
#: Dependent DADDs in one launch of `fold_dadd_probe` (a multiple of 16).
DADD_PROBE_ADDS = 1 << 21
#: Dense bf16 tensor-core peak (NVIDIA H100 SXM data sheet, at 700 W): the
#: train phase's `mfu` is model FLOP/s over it.
BF16_PEAK_FLOPS = 989e12
#: The train phase's full-size runs: (arch, AdamW moment dtype).  qwen3-4b's
#: f32 params, grads and f32 moments would hold 70 GB before activations.
TRAIN_FULL = (("qwen3-4b", "bfloat16"), ("mamba2-780m", "float32"))
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 8
#: `train()`'s resume-and-fault run: 10 steps, then a resume to 16 with a
#: fault at 13, checkpoints every 5 steps: the step lists it must give.
TRAIN_LOOP_STEPS = ([*range(10)], [10, 11, 12, 10, 11, 12, 13, 14, 15])
#: Card against CPU on the same weights, the loss and every grad leaf
#: (max |card - cpu| / max |cpu|), reduced archs: twice the largest reading
#: on the card when it was set (NVIDIA H100 80GB HBM3: 0.0257,
#: llama-3.2-vision's ln2 grad; jamba 0.153, whose bf16 router ties broke
#: another way on the card, so that one token's routing and every grad
#: behind it differed).  With silu rounded as the reference: 0.0299
#: (llama-3.2-vision) and jamba 0.0775; the bounds stay, as above.
TRAIN_CARD_TOL = {"*": 0.052, "jamba-1.5-large-398b": 0.31}
#: The dist phase's sharded steps: phase 10's qwen3-4b run (moments, batch,
#: seq) on a 1 x 1 mesh, steps 1..DIST_STEPS, steps 2.. timed.
DIST_ARCH, DIST_MOMENTS, DIST_STEPS = "qwen3-4b", "bfloat16", 8
#: The dist phase's MoE run: (arch, layers, AdamW moment dtype), at full
#: width (128 experts, top 8) and batch 4 x seq 512: 4 of 48 layers, 3.1 x
#: 10^9 f32 params (~50 GB with grads and f32 moments).
DIST_MOE = ("qwen3-moe-30b-a3b", 4, "float32")
#: The dist phase's runs of the other mixers, each (arch, layers or None for
#: the full depth, AdamW moment dtype, seq) at batch TRAIN_BATCH: mamba2-780m
#: (48 SSD layers) and whisper-small (12 + 12 layers, its encoder over 1500
#: frames, the decoder at its 448 target positions) at full size,
#: llama-3.2-vision-11b at full width and one pattern rep (5 layers: 4
#: self-attention, 1 cross over 1601 image tokens; 2.1 x 10^9 f32 params,
#: ~34 GB with grads and f32 moments).
DIST_MIXERS = (("mamba2-780m", None, "float32", 512), ("whisper-small", None, "float32", 448),
               ("llama-3.2-vision-11b", 5, "float32", 512))
#: The dist phase's sharded serves: the lm phase's full-size serves
#: (arch, batch, prompt_len, gen) through the sharded prefill and decode
#: steps on a 1 x 1 mesh, against `generate`'s unsharded steps.
DIST_SERVE = LM_SERVE
#: The dry-run sweep's time limit (host seconds, a child interpreter).
DRYRUN_TIMEOUT_S = 300
KERNEL_INFO = {
    "ntt_tile": ("src/repro_torch/kernels/csrc/ntt.cu", "src/repro/kernels/ntt.py:77"),
    "ntt_pair": ("src/repro_torch/kernels/csrc/ntt.cu", "src/repro/kernels/ntt.py:127"),
    "modmul": ("src/repro_torch/kernels/csrc/modmul.cu", "src/repro/kernels/modmul.py:26"),
}
#: The LM path's kernels, which replace no Pallas kernel: `jax.nn.silu` and
#: its grad as XLA rounds them, where the JAX package calls it.
SILU_INFO = {
    "silu_fwd": ("src/repro_torch/kernels/csrc/silu.cu",
                 "src/repro/models/layers.py:159 (jax.nn.silu, not Pallas; also :231, :309, ssm.py:222, :250)"),
    "silu_bwd": ("src/repro_torch/kernels/csrc/silu.cu",
                 "src/repro/models/layers.py:159 (jax.grad of jax.nn.silu, not Pallas)"),
}
#: The SSD mixer's kernels, which replace no Pallas kernel: `jax.nn.softplus`
#: and its grad as XLA's CPU rounds them, where the JAX package calls it.
SOFTPLUS_INFO = {
    "softplus_fwd": ("src/repro_torch/kernels/csrc/softplus.cu",
                     "src/repro/models/ssm.py:224 (jax.nn.softplus, not Pallas; also :263)"),
    "softplus_bwd": ("src/repro_torch/kernels/csrc/softplus.cu",
                     "src/repro/models/ssm.py:224 (jax.grad of jax.nn.softplus, not Pallas)"),
}
#: softplus's input on the LM path: mamba2-780m's `dt + dt_bias` (48 heads,
#: f32) at train (batch 4 x seq 512) and decode (batch 4); the first is the
#: kernels' row in the `kernels` line.
SOFTPLUS_SHAPES = (("mamba2-780m dt train", (4, 512, 48)), ("mamba2-780m dt decode", (4, 48)))
#: f32 operations an element (an FMA two): forward exp 21 and 2 adds, and
#: log1p's rational branch 34 where e = exp(-|x|) < 0.41421357 (|x| >
#: `SOFTPLUS_NEAR_X`), else its log branch 31; backward a subtract, exp 21 and a
#: multiply.
SOFTPLUS_FLOPS = {"softplus_fwd": 23, "softplus_bwd": 23}
SOFTPLUS_BRANCH_FLOPS = (31, 34)
SOFTPLUS_NEAR_X = 0.8813736
#: Patterns a chunk of the exhaustive softplus check takes: 2^26 (256 MiB in f32).
SOFTPLUS_CHUNK = 1 << 26
#: The split products held against the whole product's block on the card:
#: (name, rows, inner, whole width, ranks) for jamba's and mamba2's
#: in-projection split over 4 ranks, reduced (batch 4 x seq 32) and at
#: mamba2-780m's full width (batch 4 x seq 512, d_model 1536, 6448 columns).
SPLIT_PRODUCTS = (("jamba reduced in_proj", 128, 128, 580, 4), ("mamba2 reduced in_proj", 128, 128, 548, 4),
                  ("mamba2-780m in_proj", 2048, 1536, 6448, 4))
#: Expert einsums ("ecd,edf->ecf") split over ranks by experts, recorded:
#: (name, experts, capacity, d_model, d_ff, ranks) for reduced jamba on
#: 1 x 4 and full-width qwen3-moe's 128 experts on 2 x 2.
EXPERT_SPLITS = (("jamba reduced wi", 4, 64, 128, 256, 4), ("qwen3-moe wi", 128, 80, 2048, 768, 2))
#: silu's inputs on the LM path at full size (batch 4; prompt 128 serving,
#: seq 512 training): (name, shape of the tensor silu reads, the part of its
#: last dim it reads (a column slice of a projection: its first `cols`
#: columns, or columns (start, stop)) or None).  qwen3-4b's MLP hidden (d_ff
#: 9728) at decode, prefill and train; mamba2-780m's conv output (d_inner +
#: 2 G N = 3328) and its gate z, the first 3072 of the in-projection's 6448
#: columns, at train and decode; and a slice whose start (5 bf16) and row
#: stride (3335) are not 16-byte aligned, so that its rows take every phase.
SILU_SHAPES = (("qwen3-4b mlp decode", (4, 1, 9728), None), ("qwen3-4b mlp prefill", (4, 128, 9728), None),
               ("qwen3-4b mlp train", (4, 512, 9728), None), ("mamba2-780m xbc train", (4, 512, 3328), None),
               ("mamba2-780m z train", (4, 512, 6448), 3072), ("mamba2-780m z decode", (4, 1, 6448), 3072),
               ("misaligned slice", (4, 64, 3335), (5, 3333)))
#: Cotangents (bf16 bits) held against every bf16 input in the silu check:
#: zeros, subnormals, 2^-126 and its neighbours, small and huge normals, the
#: largest finite, infinity and NaN (each also negated).
SILU_H_BITS = [0x0000, 0x0001, 0x0020, 0x007F, 0x0080, 0x0081, 0x0100, 0x0380, 0x0400, 0x0C00, 0x3F80, 0x4A00,
               0x7000, 0x7F7F, 0x7F80, 0x7FC0]
#: The shapes timed (the first is the kernels' row in the `kernels` line).
SILU_TIMED = ("qwen3-4b mlp train", "mamba2-780m z train", "qwen3-4b mlp decode")
#: Float32 operations outside the tensor cores, per second (NVIDIA H100 SXM
#: data sheet): silu's op bound.
FP32_FLOPS = 67e12
#: f32 operations an element: forward neg, exp, add, divide, multiply;
#: backward those but the multiply, then sub, four multiplies and an add.
SILU_FLOPS = {"silu_fwd": 5, "silu_bwd": 10}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: int, butterflies: int, sm_mhz: float) -> dict:
    """The least time the card could take: the larger of `nbytes` over the
    memory rate and the butterflies' integer instructions over the issue
    rate of 132 SMs at `sm_mhz`."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = butterflies * OPS_PER_BUTTERFLY / (sms * LANE_OPS_PER_SM_CLOCK * sm_mhz * 1e6) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "bytes_bound_ms": bytes_ms, "butterflies": butterflies,
            "ops_bound_ms": ops_ms, "sm_mhz": sm_mhz}


def residues(rng, shape, q: int, device) -> torch.Tensor:
    return mm.to_device_u32(rng.integers(0, q, shape).astype(np.uint32), device)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((mm.as_i64(a) - mm.as_i64(b)).abs().max())


def _events_ms(fn, iters: int, sleep_ms: float = 0.0) -> tuple[float, float]:
    """(device ms, host enqueue ms) per call over one block of `iters` calls.

    With `sleep_ms` longer than the host's enqueue time, a GPU sleep runs
    first, so the block's launches wait in the stream and the events time
    them back to back: device time alone, whatever the host's launch cost.
    Without it, the events time calls as a caller makes them.
    """
    if sleep_ms:
        torch.cuda._sleep(int(SLEEP_CYCLES_PER_MS * sleep_ms))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def time_ms(fn, iters: int, reps: int = 5, warmup: int = 3) -> dict:
    """ms per call of `fn`, from `reps` blocks of `iters` calls timed by CUDA
    events: `ms` is the median block with the launches queued behind a GPU
    sleep (device time), `spread` its fastest and slowest block; `wall_ms` is
    the median block as a caller sees it (no queue, so the larger of device
    and host time); `host_ms` the host's time to enqueue one call.
    `queued_host_ms` is the enqueue time per call behind the sleep: near
    `sleep_ms / iters`, the stream's queue filled and the host waited on
    the device, so `ms` then holds host time too."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    sleep_ms = 3 * iters * _events_ms(fn, iters)[1] + 1.0
    queued = [_events_ms(fn, iters, sleep_ms) for _ in range(reps)]
    plain = [_events_ms(fn, iters) for _ in range(reps)]
    device = [d for d, _ in queued]
    wall = [d for d, _ in plain]
    return {"ms": float(np.median(device)), "spread": [min(device), max(device)],
            "wall_ms": float(np.median(wall)), "wall_spread": [min(wall), max(wall)],
            "host_ms": float(np.median([h for _, h in plain])), "calls": 2 * reps * iters,
            "sleep_ms": sleep_ms, "queued_host_ms": float(np.median([h for _, h in queued]))}


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def pass_cases(ctx, tile: int, forward: bool, device):
    """The launches `ntt_cuda` makes for one transform, in order, as
    (kernel, args) with args (tw, tw_sh, plan or group, [tile,] scale)."""
    n = ctx.n
    tw, tw_sh = ntt_core.device_tables(ctx, device).for_direction(forward)
    scale = None if forward else (ctx.n_inv, ctx.n_inv_shoup)
    if tile >= n:
        plan = ntt_core.forward_stages(n) if forward else ntt_core.inverse_stages(n)
        return [("ntt_tile", (tw, tw_sh, plan, n, scale))]
    packed, packed_sh, local = kntt._packed_tables(ctx, tile, forward, device)
    groups = kntt.inter_groups(n, tile, forward)
    pairs = [("ntt_pair", (tw, tw_sh, g, scale if not forward and i == len(groups) - 1 else None))
             for i, g in enumerate(groups)]
    tile_case = ("ntt_tile", (packed, packed_sh, local, tile, None))
    return pairs + [tile_case] if forward else [tile_case] + pairs


def run_case(name, args, src, dst, q, plain=False) -> None:
    """One launch of `pass_cases` from `src` into `dst`: the kernel, or its
    plain version."""
    if name == "ntt_tile":
        tw, tw_sh, stages, t, scale = args
        fn = kntt.ntt_tile_plain if plain else kntt._tile_pass
        fn(src, dst, tw, tw_sh, stages, t, q, scale)
    else:
        tw, tw_sh, group, scale = args
        fn = kntt.ntt_pair_plain if plain else kntt._pair_pass
        fn(src, dst, tw, tw_sh, group, q, scale)


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` one word past a 16-byte boundary: the kernels' 4-byte
    access paths."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_kernels(rng, device, shapes=None, tile=TILE) -> dict:
    """Every kernel launch of the transforms at the main shapes and at
    CHECK_SHAPES against its plain version on the same inputs and tables,
    on `device`: out of place, in place, and from a misaligned buffer."""
    if shapes is None:
        shapes = [(b, n, tile) for b, n in MAIN_SHAPES] + list(CHECK_SHAPES)
    errs = {name: 0 for name in KERNEL_INFO}
    checks = []

    def record(entry, got, exp):
        ok = same(got, exp)
        errs[entry["kernel"]] = max(errs[entry["kernel"]], max_abs_err(got, exp))
        checks.append({**entry, "bit_exact": ok})
        if not ok:
            raise AssertionError(f"{entry['kernel']} differs from its plain version: {checks[-1]}")

    for batch, n, t in shapes:
        ctx = ntt_core.make_context(mm.DEFAULT_Q, n)
        t = kntt.resolve_tile(t, n)
        for forward in (True, False):
            for name, args in pass_cases(ctx, t, forward, device):
                src = residues(rng, (batch, n), ctx.q, device)
                exp = torch.empty_like(src)
                run_case(name, args, src, exp, ctx.q, plain=True)
                stages = args[2]
                entry = {"kernel": name, "batch": batch, "n": n, "tile": t, "forward": forward,
                         "strides": [st.stride for st in stages] if name == "ntt_pair" else None,
                         "stages": len(stages), "scale": args[-1] is not None}
                got = torch.empty_like(src)
                run_case(name, args, src, got, ctx.q)
                record({**entry, "mode": "out of place"}, got, exp)
                got = src.clone()
                run_case(name, args, got, got, ctx.q)
                record({**entry, "mode": "in place"}, got, exp)
                if batch * n <= 1 << 16:
                    got = misaligned(src)
                    run_case(name, args, got, got, ctx.q)
                    record({**entry, "mode": "in place, misaligned"}, got, exp)
        a = residues(rng, (batch, n), ctx.q, device)
        b = residues(rng, (batch, n), ctx.q, device)
        record({"kernel": "modmul", "batch": batch, "n": n},
               kmod.modmul_cuda(a, b, ctx), kmod.modmul_plain(a, b, ctx))
    return {"max_abs_err": errs, "cases": len(checks), "checks": checks}


def silu_input(rng, shape, cols, device, dtype=torch.bfloat16) -> torch.Tensor:
    """A draw of `shape` (scale 3, as an MLP's hidden), or its first `cols`
    columns (or columns `cols` = (start, stop)), read where they lie."""
    t = torch.from_numpy((rng.standard_normal(shape) * 3).astype(np.float32)).to(device, dtype)
    if cols is None:
        return t
    start, stop = cols if isinstance(cols, tuple) else (0, cols)
    return t[..., start:stop]


def silu_elements(shape, cols) -> int:
    """Elements of `silu_input(rng, shape, cols, ...)`."""
    width = shape[-1] if cols is None else (cols[1] - cols[0] if isinstance(cols, tuple) else cols)
    return int(np.prod(shape[:-1])) * width


def at_phase(t: torch.Tensor, elements: int) -> torch.Tensor:
    """A dense copy of `t` that starts `elements` elements past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    return buf[elements:elements + t.numel()].view(t.shape).copy_(t)


def silu_cases(rng, device):
    """(name, input, cotangent) of the silu check: `SILU_SHAPES` in bf16; a
    and its cotangent at different 16-byte phases (dense, and a column slice
    against a dense cotangent); every bf16 value against cotangents of every
    magnitude (`SILU_H_BITS`, both signs: zero, subnormal, at and beside
    2^-126, huge, infinite, NaN); and an expert path's einsum output
    (permuted dims) and every bf16 value, in bf16 and f32."""
    for name, shape, cols in SILU_SHAPES:
        a = silu_input(rng, shape, cols, device)
        yield name, a, silu_input(rng, a.shape, None, device)
    a, h = silu_input(rng, (4, 64, 3072), None, device), silu_input(rng, (4, 64, 3072), None, device)
    yield "phases: a at 0, h at 3", a, at_phase(h, 3)
    yield "phases: a at 5, h at 2", at_phase(a, 5), at_phase(h, 2)
    z = silu_input(rng, (4, 64, 6448), (1, 3073), device)
    yield "phases: z slice at 1, h dense", z, silu_input(rng, z.shape, None, device)
    hs = np.array(SILU_H_BITS + [b | 0x8000 for b in SILU_H_BITS], dtype=np.uint16)
    every = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    yield ("every bf16 value against every cotangent class",
           torch.from_numpy(np.tile(every, (len(hs), 1))).to(device, torch.bfloat16),
           torch.from_numpy(np.repeat(hs[:, None], 1 << 16, axis=1).astype(np.int16)).to(device).view(torch.bfloat16))
    for dtype in (torch.bfloat16, torch.float32):
        buf, w = silu_input(rng, (4, 8, 32, 64), None, device, dtype), silu_input(rng, (8, 64, 96), None, device, dtype)
        a = torch.einsum("becd,edf->becf", buf, w)
        yield f"expert einsum {dtype}", a, silu_input(rng, a.shape, None, device, dtype)
        a = torch.from_numpy((np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)).to(device, dtype)
        yield f"every bf16 value {dtype}", a, silu_input(rng, a.shape, None, device, dtype)


def float_err(got: torch.Tensor, exp: torch.Tensor) -> float:
    """max |got - exp| over the finite elements; inf where their nans,
    infinities or signs (of zeros too) differ."""
    nan = got.isnan()
    if not torch.equal(nan, exp.isnan()):
        return float("inf")
    g, e = got[~nan], exp[~nan]
    inf = g.isinf()
    if not (torch.equal(inf, e.isinf()) and torch.equal(g[inf], e[inf]) and torch.equal(g.signbit(), e.signbit())):
        return float("inf")
    return float((g[~inf].double() - e[~inf].double()).abs().max()) if (~inf).any() else 0.0


def check_silu(rng, device) -> dict:
    """`silu_fwd` and `silu_bwd` against their plain versions on the same
    inputs on `device` (`silu_cases`), bit for bit; and a float16 tensor on
    the card refused."""
    errs = {name: 0.0 for name in SILU_INFO}
    checks = []
    for name, a, h in silu_cases(rng, device):
        row = {"case": name, "shape": list(a.shape), "dtype": str(a.dtype), "contiguous": a.is_contiguous(),
               "silu_fwd": float_err(ksilu.silu_fwd(a), ksilu.silu_fwd_plain(a)),
               "silu_bwd": float_err(ksilu.silu_bwd(a, h), ksilu.silu_bwd_plain(a, h))}
        checks.append(row)
        for k in SILU_INFO:
            errs[k] = max(errs[k], row[k])
    refused = False
    if torch.device(device).type == "cuda":
        try:
            ksilu.silu_fwd(torch.zeros(4, dtype=torch.float16, device=device))
        except TypeError:
            refused = True
    out = {"max_abs_err": errs, "cases": len(checks), "checks": checks, "float16_refused": refused}
    if any(errs.values()) or (torch.device(device).type == "cuda" and not refused):
        raise AssertionError(f"silu differs from its plain version: {out}")
    return out


def softplus_patterns(start: int, count: int, device) -> torch.Tensor:
    """The f32 values of bit patterns start .. start + count - 1."""
    bits = torch.arange(start, start + count, dtype=torch.int64, device=device)
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32).view(torch.float32)


def softplus_differ(got: torch.Tensor, exp: torch.Tensor, nan_as_nan: bool) -> torch.Tensor:
    """Where `got` and `exp` differ in their bits (with `nan_as_nan`, NaN
    against NaN agrees)."""
    ne = got.view(torch.int32) != exp.view(torch.int32)
    return ne & ~(got.isnan() & exp.isnan()) if nan_as_nan else ne


def check_softplus(rng, device, total: int = 1 << 32, chunk: int = SOFTPLUS_CHUNK) -> dict:
    """`softplus_fwd` and `softplus_bwd` against their plain versions on
    `device` on every f32 bit pattern (`total` of them from 0, in chunks),
    the grad's cotangent the pattern's bitwise complement (so every pattern
    appears as a cotangent too), bit for bit (the grad's NaNs as NaNs); then
    at `SOFTPLUS_SHAPES`, contiguous and as rows of a wider tensor; and a
    float64 tensor on the card refused.  On the card the sweep also counts
    the elements that each kernel computed again by the CPU's ops
    (`flagged`).  The launches here are the check's own: the caller resets
    the counts before the main path."""
    differ = {name: 0 for name in SOFTPLUS_INFO}
    errs = {name: 0.0 for name in SOFTPLUS_INFO}
    on_card = torch.device(device).type == "cuda"
    flagged = {k: torch.zeros(1, dtype=torch.int64, device=device) for k in SOFTPLUS_INFO} if on_card else None
    t0 = time.perf_counter()

    def compare(x, g, count=None):
        out = ksoftplus.softplus_fwd(x, flagged=count and count["softplus_fwd"])
        want = ksoftplus.softplus_fwd_plain(x)
        bad = softplus_differ(out, want, nan_as_nan=False)
        differ["softplus_fwd"] += int(bad.sum())
        errs["softplus_fwd"] = max(errs["softplus_fwd"], float_err(out, want))
        dx = ksoftplus.softplus_bwd(x, want, g, flagged=count and count["softplus_bwd"])
        want = ksoftplus.softplus_bwd_plain(x, want, g)
        differ["softplus_bwd"] += int(softplus_differ(dx, want, nan_as_nan=True).sum())
        errs["softplus_bwd"] = max(errs["softplus_bwd"], float_err(dx, want))

    for start in range(0, total, chunk):
        x = softplus_patterns(start, min(chunk, total - start), device)
        compare(x, (~x.view(torch.int32)).view(torch.float32), flagged)
        del x
    sweep_s = time.perf_counter() - t0
    shapes = []
    for name, shape in SOFTPLUS_SHAPES:
        x = torch.from_numpy((rng.standard_normal(shape) * 4).astype(np.float32)).to(device)
        g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
        wide = torch.zeros(*shape[:-1], 3 * shape[-1], device=device)
        rows = wide[..., shape[-1]:2 * shape[-1]].copy_(x)
        for layout, t in (("contiguous", x), ("rows", rows)):
            compare(t, g)
            shapes.append({"case": name, "layout": layout, "shape": list(shape)})
    refused = False
    if torch.device(device).type == "cuda":
        try:
            ksoftplus.softplus_fwd(torch.zeros(4, dtype=torch.float64, device=device))
        except TypeError:
            refused = True
    out = {"patterns": total, "differ": differ, "max_abs_err": {k: 0.0 if not differ[k] else errs[k] for k in differ},
           "sweep_s": sweep_s, "flagged": None if flagged is None else {k: int(v.item()) for k, v in flagged.items()},
           "shapes": shapes,
           "float64_refused": refused}
    if any(differ.values()) or (torch.device(device).type == "cuda" and not refused):
        raise AssertionError(f"softplus differs from its plain version: {out}")
    return out


def check_split_products(device, splits=SPLIT_PRODUCTS, expert_splits=EXPERT_SPLITS) -> dict:
    """`parallel.block_of_product` against the whole product's block on
    `device`, for each rank of each split of `splits` (bf16), in the four
    forms of the model axis's five split products: `x @ w` (the column-
    parallel forward, and the row-parallel one on the exchanged weight),
    `g @ W.T` (the grad of the input of both), `x.T @ g` (the column-
    parallel weight grad) and `h.T @ g` (the row-parallel one); the width
    each block is computed at (its own where the card sums it as the whole
    product, else wider: `_exact_width`), and whether the plain block
    product equals the whole product's block with
    `allow_bf16_reduced_precision_reduction` off (as the model runs) and on.
    Then, for the record, whether an expert einsum over a rank's experts
    equals the whole einsum's (`expert_splits`; not a failure)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    mm = torch.backends.cuda.matmul
    old = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    rows, unequal = [], []
    try:
        for name, m, k, total, parts in splits:
            def draw(*shape):
                return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)

            x, w, wt, g = draw(m, k), draw(k, total), draw(k, total), draw(m, total)
            n, kn = total // parts, k // parts
            for index in range(parts):
                cols, krows = slice(index * n, (index + 1) * n), slice(index * kn, (index + 1) * kn)
                forms = (("x @ w", (x @ w)[:, cols], x, w[:, cols].contiguous(), total, False),
                         ("g @ W.T", (g @ wt.T)[:, krows], g, wt[krows].contiguous().T, k, False),
                         ("x.T @ g", (x.T @ g)[:, cols], x.T, g[:, cols].contiguous(), total, False),
                         ("h.T @ g", (x.T @ g)[krows], x[:, krows].contiguous().T, g, k, True))
                for form, want, a, b, whole, by_rows in forms:
                    got = dparallel.block_of_product(a, b, whole, index, rows=by_rows)
                    mm.allow_bf16_reduced_precision_reduction = True
                    own_reduced = bool(torch.equal(a @ b, want))
                    mm.allow_bf16_reduced_precision_reduction = False
                    row = {"split": name, "form": form, "rank": index,
                           "block": (a if by_rows else b).shape[0 if by_rows else -1], "whole": whole,
                           "width": dparallel._exact_width(a, b, whole, index, by_rows),
                           "equal": bool(torch.equal(got, want)), "plain_block_equal": bool(torch.equal(a @ b, want)),
                           "plain_block_equal_reduced_precision_allowed": own_reduced}
                    rows.append(row)
                    if not row["equal"]:
                        unequal.append(row)
        experts = []
        for name, e, c, d, f, parts in expert_splits:
            buf = torch.randn(e, c, d, generator=gen, device=device).to(torch.bfloat16)
            w = torch.randn(e, d, f, generator=gen, device=device).to(torch.bfloat16)
            whole = torch.einsum("ecd,edf->ecf", buf, w)
            per = e // parts
            experts.append({"split": name, "shape": [e, c, d, f], "ranks": parts, "equal_by_rank": [
                bool(torch.equal(torch.einsum("ecd,edf->ecf", buf[i * per:(i + 1) * per].contiguous(),
                                              w[i * per:(i + 1) * per].contiguous()), whole[i * per:(i + 1) * per]))
                for i in range(parts)]})
    finally:
        mm.allow_bf16_reduced_precision_reduction = old
    widths = collections.Counter((r["split"], r["form"], r["block"], r["width"]) for r in rows)
    out = {"cases": len(rows), "unequal": unequal, "rows": rows, "expert_einsums": experts,
           "widths": [{"split": a, "form": b, "block": c, "width": d, "ranks": v} for (a, b, c, d), v in widths.items()]}
    if unequal:
        raise AssertionError(f"block_of_product differs from the whole product's block: {unequal}")
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def polymul_launches(n: int, tile=TILE) -> dict:
    """Launches of one polymul_ntt: 3 transforms (`launch_plan`) and 1 modmul."""
    return {**{k: 3 * v for k, v in kntt.launch_plan(n, tile).items()}, "modmul": 1}


def expected_launches(shapes=MAIN_SHAPES, tile=TILE) -> dict:
    """Launches of one polymul_ntt per shape."""
    counts = collections.Counter()
    for _, n in shapes:
        counts.update(polymul_launches(n, tile))
    return dict(counts)


def rns_launches(n: int, towers: int, op: str = "ct_mul_relin", tile=TILE) -> dict:
    """Launches of one call of a `he` op at (n, towers).  `ct_mul` and
    `keyswitch` each make, per tower, one forward transform call, one
    modmul call and one inverse call (2*L*T + L, T = `launch_plan`'s
    launches per transform); `ct_mul_relin` is both; `rescale` launches
    nothing.  `relin_key`: two `poly_mul_towers` (per tower a forward call,
    a modmul call and an inverse call each) and the key's NTT (per tower one
    forward call): 5*L*T + 2L."""
    transforms, modmuls = {"ct_mul": (2, 1), "keyswitch": (2, 1), "ct_mul_relin": (4, 2),
                           "rescale": (0, 0), "relin_key": (5, 2)}[op]
    return {**{k: transforms * towers * v for k, v in kntt.launch_plan(n, tile).items()},
            "modmul": modmuls * towers}


def drive_main_path(rng, device, shapes=MAIN_SHAPES) -> dict:
    """`polymul_ntt` through the user's entry point on each shape, then
    the checks of its output; returns the launch counts of the drive."""
    inputs, outputs = [], []
    kernels.reset_launch_counts()
    for batch, n in shapes:
        ctx = ntt_core.make_context(mm.DEFAULT_Q, n)
        a = rng.integers(0, ctx.q, (batch, n)).astype(np.uint32)
        b = rng.integers(0, ctx.q, (batch, n)).astype(np.uint32)
        inputs.append((ctx, a, b))
        outputs.append(ops.polymul_ntt(a, b, ctx, device=device))
    if device != "cpu":
        torch.cuda.synchronize()
    launches = kernels.launch_counts()

    report = []
    for (ctx, a, b), out in zip(inputs, outputs):
        batch, n = a.shape
        if tuple(out.shape) != (batch, n) or out.dtype != torch.uint32:
            raise AssertionError(f"polymul_ntt gave {tuple(out.shape)} {out.dtype}")
        rows = np.sort(rng.choice(batch, size=min(4, batch), replace=False))
        oracle = ntt_core.polymul_negacyclic_np(a[rows], b[rows], ctx)
        picked = out.view(torch.int32)[torch.from_numpy(rows).to(out.device)]  # no uint32 indexing on CUDA
        rows_ok = bool(np.array_equal(mm.to_numpy_u32(picked.view(torch.uint32)), oracle))
        a_t, b_t = mm.to_device_u32(a, device), mm.to_device_u32(b, device)
        plain_ok = same(out, ntt_core.polymul_negacyclic_torch(a_t, b_t, ctx))
        roundtrip_ok = same(ops.intt(ops.ntt(a_t, ctx), ctx), a_t)
        report.append({"batch": batch, "n": n, "oracle_rows": rows.tolist(),
                       "numpy_oracle_bit_exact": rows_ok, "plain_torch_bit_exact": plain_ok,
                       "roundtrip": roundtrip_ok})
        if not (rows_ok and plain_ok and roundtrip_ok):
            raise AssertionError(f"main path wrong: {report[-1]}")
    return {"launches": launches, "results": report}


# ---------------------------------------------------------------------------
# phase 5: the RNS-CKKS path
# ---------------------------------------------------------------------------


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _on_cpu(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32).cpu().view(torch.uint32)


def drive_rns(device, n: int = RNS_SHAPE[0], towers: int = RNS_SHAPE[1],
              sample: int = RNS_SAMPLE, seed: int = SEED, keep: dict | None = None) -> dict:
    """`relin_key`, then `ct_mul_relin` and `rescale`, through the user's
    entry points on `device`, each drive between a reset and a read of the
    launch counts; then the checks of the results: every tower bit-exact
    against the same ops on the CPU plain path (the key's b and a copied
    over, its NTT form recomputed there and compared), and on `sample`
    towers, with the numpy stage loop, ct_mul's products, the keyswitch
    identity NTT(c0') + NTT(c1') NTT(s) = NTT(d2) NTT(s)^2 (c0', c1' the
    keyswitch of d2), the relinearized sum and rescale's formula; and
    intt(ntt(x)) == x on the towers.  `keep`, where given, receives the
    basis, ciphertexts, key and `ct_mul_relin` result for the pimsys phase."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    basis = he.make_basis(n, towers)
    s = he.make_secret(basis, seed, device=device)
    ct_a = he.random_ct(basis, seed + 1, device=device)
    ct_b = he.random_ct(basis, seed + 2, device=device)
    kernels.reset_launch_counts()
    rlk = he.relin_key(basis, s, seed=seed + 3)
    _sync(device)
    key_launches = kernels.launch_counts()
    kernels.reset_launch_counts()
    out = he.ct_mul_relin(basis, ct_a, ct_b, rlk)
    res = he.rescale(basis, out)
    _sync(device)
    launches = kernels.launch_counts()
    drive_s = time.perf_counter() - t0
    peak_mib = torch.cuda.max_memory_allocated() / 2**20 if on_card else None
    if tuple(out.shape) != (2, towers, n) or tuple(res.shape) != (2, towers - 1, n) \
            or out.dtype != torch.uint32 or res.dtype != torch.uint32:
        raise AssertionError(f"ct_mul_relin / rescale gave {tuple(out.shape)} {tuple(res.shape)}")

    # every tower against the CPU plain path on the same inputs and key
    t0 = time.perf_counter()
    cpu_key = he.KeySwitchKey(basis, _on_cpu(rlk.b), _on_cpu(rlk.a))
    key_hat_ok = all(same(_on_cpu(g), c) for g, c in zip(rlk.hat, cpu_key.hat))
    cpu_out = he.ct_mul_relin(basis, _on_cpu(ct_a), _on_cpu(ct_b), cpu_key)
    cpu_res = he.rescale(basis, cpu_out)
    out_np, res_np = mm.to_numpy_u32(out), mm.to_numpy_u32(res)
    cpu_exact = {"key_hat": key_hat_ok,
                 "ct_mul_relin": bool(np.array_equal(out_np, mm.to_numpy_u32(cpu_out))),
                 "rescale": bool(np.array_equal(res_np, mm.to_numpy_u32(cpu_res)))}
    cpu_s = time.perf_counter() - t0

    # sampled towers against the numpy stage loop, independent of the kernels
    t0 = time.perf_counter()
    d = he.ct_mul(basis, ct_a, ct_b)
    ks = he.keyswitch(basis, d.view(torch.int32)[2].view(torch.uint32), rlk)
    back = he.ntt_towers(basis, he.ntt_towers(basis, ct_a), forward=False)
    roundtrip = same(back, ct_a)
    host = {k: mm.to_numpy_u32(v).astype(np.int64)
            for k, v in (("s", s), ("a", ct_a), ("b", ct_b), ("d", d), ("ks", ks))}
    picked = np.sort(np.random.default_rng(seed).choice(towers, size=min(sample, towers), replace=False))
    identities = []
    for i in picked.tolist():
        ctx, q = basis.contexts[i], basis.moduli[i]
        rows = np.stack([host["s"][i], *host["a"][:, i], *host["b"][:, i], *host["d"][:, i],
                         *host["ks"][:, i]])
        sh, a0, a1, b0, b1, d0, d1, d2, k0, k1 = ntt_core.ntt_forward_np(rows, ctx).astype(np.int64)
        ct_mul_ok = (np.array_equal(d0, a0 * b0 % q) and np.array_equal(d2, a1 * b1 % q)
                     and np.array_equal(d1, (a0 * b1 % q + a1 * b0 % q) % q))
        keyswitch_ok = np.array_equal((k0 + k1 * sh % q) % q, d2 * sh % q * sh % q)
        relin_ok = np.array_equal(out_np[:, i], (host["d"][:2, i] + host["ks"][:, i]) % q)
        rescale_ok = None
        if i < towers - 1:
            inv = mm.inv_mod(basis.moduli[-1] % q, q)
            delta = (out_np[:, i].astype(np.int64) - out_np[:, -1].astype(np.int64) % q) % q
            rescale_ok = bool(np.array_equal(res_np[:, i], delta * inv % q))
        identities.append({"tower": i, "q": q, "ct_mul": bool(ct_mul_ok),
                           "keyswitch": bool(keyswitch_ok), "relinearize": bool(relin_ok),
                           "rescale": rescale_ok})
    identity_s = time.perf_counter() - t0

    report = {"n": n, "towers": towers, "moduli": [basis.moduli[0], basis.moduli[-1]],
              "modulus_bits": basis.modulus.bit_length(), "device": str(out.device),
              "key_launches": key_launches, "launches": launches,
              "expected_key_launches": rns_launches(n, towers, "relin_key"),
              "expected_launches": rns_launches(n, towers, "ct_mul_relin"),
              "cpu_bit_exact": cpu_exact, "towers_checked_vs_cpu": list(range(towers)),
              "identity": identities, "roundtrip": roundtrip, "peak_mib": peak_mib,
              "seconds": {"drive": drive_s, "cpu_path": cpu_s, "identity": identity_s}}
    bad = [c for c in identities if not all(v in (True, None) for k, v in c.items()
                                              if k not in ("tower", "q"))]
    if not all(cpu_exact.values()) or bad or not roundtrip:
        raise AssertionError(f"rns path wrong: {report}")
    if keep is not None:
        keep.update(basis=basis, ct_a=ct_a, ct_b=ct_b, rlk=rlk, out=out)
    return report


# ---------------------------------------------------------------------------
# phase 7: the simulator stack
# ---------------------------------------------------------------------------


def drive_pimsys(device, kept: dict, cfg: dict = PIMSYS_CFG, reps: int = 3) -> dict:
    """(a) `CtMulRelinOp` at the rns phase's (n, towers) through
    `PimSession(..., device=device)`: compile, then `run(..., time=False)`
    on the rns phase's ciphertexts and key between a reset and a read of the
    launch counts (checked by the caller against `rns_launches`: on the CPU
    nothing launches); its value must equal the rns phase's `ct_mul_relin`
    result bit for bit.  Then `reps` alternating wall times of the session
    run and of the direct `he.ct_mul_relin` call: the session layer's host
    cost per op."""
    basis = kept["basis"]
    n, towers = basis.n, basis.towers
    sess = PimSession(PimConfig(**cfg), device=device)
    t0 = time.perf_counter()
    plan = sess.compile(he.CtMulRelinOp(n=n, towers=towers))
    compile_s = time.perf_counter() - t0
    if he.basis_for(plan.op) is not basis:
        raise AssertionError("the plan's basis is not the rns phase's (memoized) basis")
    args = (kept["ct_a"], kept["ct_b"], kept["rlk"])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    r = sess.run(plan, *args, time=False)
    _sync(device)
    run_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    expected = rns_launches(n, towers, "ct_mul_relin")
    exact = r.value.device == kept["out"].device and same(r.value, kept["out"])
    session_s, direct_s = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        sess.run(plan, *args, time=False)
        _sync(device)
        session_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        he.ct_mul_relin(basis, *args)
        _sync(device)
        direct_s.append(time.perf_counter() - t0)
    session_ms, direct_ms = float(np.median(session_s)) * 1e3, float(np.median(direct_s)) * 1e3
    report = {"op": f"CtMulRelinOp(n={n}, towers={towers})", "cfg": cfg, "device": str(r.value.device),
              "plan": dict(plan.placement), "compile_s": compile_s, "first_run_s": run_s,
              "launches": launches, "expected_launches": expected,
              "value_bit_exact_vs_rns_phase": exact,
              "session_run_ms": session_ms, "direct_ct_mul_relin_ms": direct_ms,
              "session_host_cost_ms": session_ms - direct_ms,
              "session_run_ms_all": [t * 1e3 for t in session_s],
              "direct_ms_all": [t * 1e3 for t in direct_s]}
    if not exact or r.timing is not None:
        raise AssertionError(f"pimsys session run wrong: {report}")
    return report


def golden_names(path: str = GOLDEN_PATH) -> list[str]:
    """Every record of the engine goldens, by name."""
    with open(path) as f:
        g = json.load(f)
    names = [f"single/n{r['n']}-nb{r['nb']}-f{int(r['forward'])}" for r in g["single"]]
    names += [f"multibank/n{r['n']}-nb{r['nb']}-b{r['banks']}-{r['policy']}" for r in g["multibank"]]
    names += [f"sharded/n{r['n']}-b{r['banks']}-f{int(r['forward'])}" for r in g["sharded"]]
    return names + ["scheduler/0"]


def replay_goldens(path: str = GOLDEN_PATH, names=None) -> dict:
    """The named records of the engine goldens (all by default) replayed
    through the port's simulator as `tests/test_engine.py` replays them
    through the reference; every value compared with `==`."""
    with open(path) as f:
        g = json.load(f)
    records = dict(zip(golden_names(path), g["single"] + g["multibank"] + g["sharded"] + g["scheduler"]))
    names = list(records) if names is None else list(names)
    bad = []
    t0 = time.perf_counter()
    for name in names:
        rec, kind = records[name], name.split("/")[0]
        if kind == "single":
            cfg = PimConfig(num_buffers=rec["nb"])
            cmds = RowCentricMapper(cfg, rec["n"], forward=rec["forward"]).commands()
            r = BankTimer(cfg).simulate(cmds)
            got = [len(cmds), r.ns, dict(sorted(r.stats.items()))]
            want = [rec["commands"], rec["ns"], rec["stats"]]
        elif kind == "multibank":
            cfg = PimConfig(num_buffers=rec["nb"])
            cmds = RowCentricMapper(cfg, rec["n"]).commands()
            ctrl = ChannelController(cfg, policy=rec["policy"])
            for i in range(rec["banks"]):
                ctrl.enqueue(ctrl.add_bank(), cmds, job_id=i)
            ctrl.drain()
            got = [ctrl.makespan_ns, ctrl.bus_busy_ns, analytic_multibank_bound(rec["n"], rec["banks"], cfg)]
            want = [rec["latency_ns"], rec["bus_busy_ns"], rec["analytic_ns"]]
        elif kind == "sharded":
            cfg = PimConfig(num_buffers=rec["nb"], num_channels=rec["channels"],
                            num_banks=rec["banks_per_rank"])
            r = ShardedNttPlan(cfg, rec["n"], rec["banks"], forward=rec["forward"]).simulate(baseline=False)
            got = [r.latency_ns, r.local_ns, r.exchange_ns, r.xfer_atoms, r.xfer_hops]
            want = [rec[k] for k in ("latency_ns", "local_ns", "exchange_ns", "xfer_atoms", "xfer_hops")]
        else:
            cfg = PimConfig(num_buffers=2, num_channels=2, num_banks=2)
            jobs = [NttJob(512), PolymulJob(256), NttJob(1024), NttJob(512), PolymulJob(512), NttJob(256)]
            closed = RequestScheduler(cfg).run_closed_loop(jobs)
            open_ = RequestScheduler(cfg).run_open_loop(jobs, rate_per_us=0.1, seed=3)
            got = [[float(x) for x in closed.done_ns], closed.makespan_ns,
                   [float(x) for x in open_.done_ns], open_.makespan_ns]
            want = [rec["closed_done_ns"], rec["closed_makespan_ns"], rec["open_done_ns"],
                    rec["open_makespan_ns"]]
        if got != want:
            bad.append({"record": name, "got": got, "want": want})
    return {"records": names, "mismatches": bad, "seconds": time.perf_counter() - t0}


def he_mix_points(path: str = BENCH_HE_PATH, n: int = 256, levels=(2, 4, 8)) -> dict:
    """The `he/mix/<op>/N=<n>/*` latency points of BENCH_he.json, made as
    `benchmarks/he_ops.py` makes them (`t.latency_ns / 1e3` under its quick
    config, banks = min(towers, 8)) and compared by name with `==`.  They
    are the simulator's modeled PIM latencies, in µs, not device times."""
    with open(path) as f:
        committed = {p["name"]: p["us_per_call"] for p in json.load(f)["points"]}
    sess = PimSession(PimConfig(**PIMSYS_QUICK_CFG))
    ops = {"ct_mul": he.RlweCtMulOp, "keyswitch": he.KeySwitchOp, "rescale": he.RescaleOp,
           "ct_mul_relin": he.CtMulRelinOp}
    points, bad = {}, []
    t0 = time.perf_counter()
    for big_l in levels:
        banks = min(big_l, sess.topo.total_banks)
        for kind, cls in ops.items():
            name = f"he/mix/{kind}/N={n}/L={big_l}/banks={banks}"
            us = sess.run(sess.compile(cls(n=n, towers=big_l, banks=banks))).timing.latency_ns / 1e3
            points[name] = us
            if committed.get(name) != us:
                bad.append({"point": name, "got": us, "committed": committed.get(name)})
    return {"modeled_us": points, "mismatches": bad, "seconds": time.perf_counter() - t0}


def modeled_latency(n: int = PIMSYS_MODELED[0], towers: int = PIMSYS_MODELED[1],
                    cfg: dict = PIMSYS_CFG) -> dict:
    """The simulator's modeled PIM latency of one `CtMulRelinOp(n, towers)`
    (a timed run without values) and the host seconds it took."""
    sess = PimSession(PimConfig(**cfg))
    t0 = time.perf_counter()
    t = sess.run(sess.compile(he.CtMulRelinOp(n=n, towers=towers))).timing
    return {"op": f"CtMulRelinOp(n={n}, towers={towers})", "cfg": cfg,
            "modeled_pim_latency_us": t.latency_ns / 1e3, "modeled_single_bank_us": t.single_ns / 1e3,
            "speedup": t.speedup, "efficiency": t.efficiency, "banks": t.banks,
            "host_seconds": time.perf_counter() - t0}


def run_pimsys_host(goldens=None) -> dict:
    """(b) the simulator's own numbers on this machine's host: the golden
    records (all by default), the BENCH_he.json mix points and the modeled
    latency; raises on any mismatch."""
    replay = replay_goldens(names=goldens)
    mix = he_mix_points()
    if replay["mismatches"] or mix["mismatches"]:
        raise AssertionError(f"simulator numbers differ: {replay['mismatches']} {mix['mismatches']}")
    return {"goldens": replay, "bench_he_mix": mix, "modeled": modeled_latency(),
            "note": "modeled_* and *_us latencies are simulator output (PIM model), not device time"}


# ---------------------------------------------------------------------------
# phase 8: timing
# ---------------------------------------------------------------------------


def time_kernels(rng, device, batch: int, n: int, sm_mhz: float, tile: int = TILE) -> dict:
    """Per-launch times of each kernel at (batch, n), cold: a ring of
    buffers larger than L2, so each launch reads from device memory."""
    ctx = ntt_core.make_context(mm.DEFAULT_Q, n)
    words = batch * n
    ring = max(2, -(-2 * L2_BYTES // (4 * words)) + 1)
    bufs = [residues(rng, (batch, n), ctx.q, device) for _ in range(ring)]
    out = {}
    cases = dict(pass_cases(ctx, kntt.resolve_tile(tile, n), True, device))  # one B2 group at most here
    it = itertools.count()

    def record(kernel_fn, warm_fn, plain_fn, library_fn, nbytes, butterflies, **extra):
        cold = time_ms(kernel_fn, 50)
        plain = time_ms(plain_fn, 3, reps=3, warmup=1)
        rec = {**cold, "plain_ms": plain["ms"], "library_ms": None,
               **bound(nbytes, butterflies, sm_mhz), **extra}
        if warm_fn is not None:
            rec["warm_ms"] = time_ms(warm_fn, 50)["ms"]
        if library_fn is not None:
            rec["library_ms"] = time_ms(library_fn, 20)["ms"]
        return rec

    for name, args in cases.items():
        def launch(name=name, args=args):
            x = bufs[next(it) % ring]
            run_case(name, args, x, x, ctx.q)

        stages = args[2]
        table_bytes = 2 * 4 * sum(st.blocks for st in stages)
        if name == "ntt_tile":
            table_bytes = 2 * 4 * args[0].numel()  # every tile reads its packed row
            extra = {"stages": len(stages), "tile": args[3]}
        else:
            extra = {"stages": len(stages), "strides": [st.stride for st in stages]}
        out[name] = record(
            launch,
            lambda name=name, args=args: run_case(name, args, bufs[0], bufs[0], ctx.q),
            lambda name=name, args=args: run_case(name, args, bufs[0], bufs[1], ctx.q, plain=True),
            None, 2 * 4 * words + table_bytes, words // 2 * len(stages), **extra,
        )

    def modmul_launch():
        i = next(it)
        kmod.modmul_cuda(bufs[i % ring], bufs[(i + 1) % ring], ctx)

    def library_modmul():
        a64 = bufs[0].view(torch.int32).long()
        b64 = bufs[1].view(torch.int32).long()
        return (a64 * b64) % ctx.q

    out["modmul"] = record(
        modmul_launch, None, lambda: kmod.modmul_plain(bufs[0], bufs[1], ctx),
        library_modmul, 3 * 4 * words, 0,
        library_call="(a.view(int32).long() * b.view(int32).long()) % q, int64",
    )
    return out


def silu_launch_shape(a: torch.Tensor, vectors: int = 2) -> tuple[int, int]:
    """(CTAs, threads) of a silu kernel on bf16 `a`: its rows (one where it
    is contiguous) in tiles of 256 threads x `vectors` 16-byte vectors
    (`silu_fwd` two a thread, `silu_bwd` one)."""
    rows, cols = (1, a.numel()) if a.is_contiguous() else (a.numel() // a.shape[-1], a.shape[-1])
    return rows * -(-(-(-cols // 8)) // (256 * vectors)), 256


def time_silu(rng, device, names=SILU_TIMED) -> dict:
    """Per-launch times of `silu_fwd` and `silu_bwd` at `SILU_SHAPES`' `names`
    (bf16), cold (a ring of inputs larger than L2), beside the bound (the
    larger of the bytes at 3.35 TB/s, each input read and the output written
    once, and `SILU_FLOPS` at the f32 rate), the plain version and one
    PyTorch call of the same function that rounds once: `F.silu` and
    `aten.silu_backward`; and an empty kernel at `silu_fwd`'s launch shape
    (`launch_floor_ms`; the backward's at its own).  `host_ms` is
    the host's time to enqueue one call.  Also the time to build each
    kernel's table on the card, once: `silu_fwd`'s results, `silu_bwd`'s
    (d, c)."""
    out = {}
    index = torch.device(device).index or 0
    for key, tables, build in (("table", ksilu._TABLES, ksilu._table), ("grad_table", ksilu._GRAD_TABLES,
                                                                         ksilu._grad_table)):
        tables.pop(index, None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        build(index)
        torch.cuda.synchronize()
        out[f"{key}_build_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{key}_bytes"] = build(index).numel() * build(index).element_size()
    for name, shape, cols in SILU_SHAPES:
        if name not in names:
            continue
        n = silu_elements(shape, cols)
        ring = max(2, -(-2 * L2_BYTES // (2 * n)) + 1)
        a = [silu_input(rng, shape, cols, device) for _ in range(ring)]
        h = [silu_input(rng, x.shape, None, device) for x in a]
        it = itertools.count()
        calls = {"silu_fwd": (lambda: ksilu.silu_fwd(a[next(it) % ring]), lambda: ksilu.silu_fwd_plain(a[0]),
                              lambda: torch.nn.functional.silu(a[next(it) % ring]), 2 * 2 * n),
                 "silu_bwd": (lambda: ksilu.silu_bwd(a[next(it) % ring], h[next(it) % ring]),
                              lambda: ksilu.silu_bwd_plain(a[0], h[0]),
                              lambda: torch.ops.aten.silu_backward(h[next(it) % ring], a[next(it) % ring]), 3 * 2 * n)}
        rows = {}
        for kname, (kernel, plain, library, nbytes) in calls.items():
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = SILU_FLOPS[kname] * n / FP32_FLOPS * 1e3
            rows[kname] = {**time_ms(kernel, 50), "plain_ms": time_ms(plain, 3, reps=3, warmup=1)["ms"],
                           "library_ms": time_ms(library, 50)["ms"], "bound_ms": max(bytes_ms, ops_ms),
                           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes,
                           "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms, "elements": n,
                           "library_call": "F.silu" if kname == "silu_fwd" else "aten.silu_backward"}
        for kname, vectors in (("silu_fwd", 2), ("silu_bwd", 1)):
            blocks, threads = silu_launch_shape(a[0], vectors)
            rows[kname]["launch_floor_ms"] = time_ms(lambda: _build.empty_launch(blocks, threads, device), 50)["ms"]
            rows[kname]["launch_shape"] = [blocks, threads]
        out[name] = {"shape": list(shape), "cols": cols, **rows}
    return out


def time_softplus(device) -> dict:
    """Per-launch times of `softplus_fwd` and `softplus_bwd` at
    `SOFTPLUS_SHAPES` (f32), cold (a ring of inputs larger than L2, drawn on
    the card), beside the bound (the larger of the bytes at 3.35 TB/s, each
    input read and the output written once, and `SOFTPLUS_FLOPS` at the f32
    rate: the forward's log1p branch as each input of the ring selects it),
    the plain version, one PyTorch call of the same function that rounds
    otherwise: `F.softplus` and `aten.softplus_backward`, and an empty
    kernel at the kernels' launch shape (`launch_floor_ms`: 128 threads, an
    element a thread)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    out = {}
    for name, shape in SOFTPLUS_SHAPES:
        n = int(np.prod(shape))
        ring = max(2, -(-2 * L2_BYTES // (4 * n)) + 1)
        x = torch.randn(ring, *shape, generator=gen, device=device) * 4
        y, g = ksoftplus.softplus_fwd_plain(x), torch.randn(ring, *shape, generator=gen, device=device)
        it = itertools.count()
        calls = {"softplus_fwd": (lambda: ksoftplus.softplus_fwd(x[next(it) % ring]),
                                  lambda: ksoftplus.softplus_fwd_plain(x[0]),
                                  lambda: torch.nn.functional.softplus(x[next(it) % ring]), 2 * 4 * n,
                                  "F.softplus"),
                 "softplus_bwd": (lambda: ksoftplus.softplus_bwd(x[next(it) % ring], y[next(it) % ring],
                                                                 g[next(it) % ring]),
                                  lambda: ksoftplus.softplus_bwd_plain(x[0], y[0], g[0]),
                                  lambda: torch.ops.aten.softplus_backward(g[next(it) % ring], x[next(it) % ring],
                                                                           1.0, 20.0), 4 * 4 * n,
                                  "aten.softplus_backward")}
        near = int((x.abs() > SOFTPLUS_NEAR_X).sum())  # the ring's inputs on log1p's rational branch
        branch_ops = (SOFTPLUS_BRANCH_FLOPS[0] * (x.numel() - near) + SOFTPLUS_BRANCH_FLOPS[1] * near) / ring
        rows = {}
        for kname, (kernel, plain, library, nbytes, call) in calls.items():
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops = SOFTPLUS_FLOPS[kname] * n + (branch_ops if kname == "softplus_fwd" else 0)
            ops_ms = ops / FP32_FLOPS * 1e3
            rows[kname] = {**time_ms(kernel, 50), "plain_ms": time_ms(plain, 3, reps=3, warmup=1)["ms"],
                           "library_ms": time_ms(library, 50)["ms"], "bound_ms": max(bytes_ms, ops_ms),
                           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes,
                           "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms, "elements": n, "library_call": call}
        blocks = -(-n // 128)
        floor = time_ms(lambda: _build.empty_launch(blocks, 128, device), 50)["ms"]
        for kname in calls:
            rows[kname]["launch_floor_ms"] = floor
            rows[kname]["launch_shape"] = [blocks, 128]
        out[name] = {"shape": list(shape), "ring": ring, **rows}
        del x, y, g
    return out


def time_polymul(rng, device, batch: int, n: int, sm_mhz: float, tile: int = TILE) -> dict:
    """`polymul_ntt` per call, beside the sum of its launches' bounds."""
    ctx = ntt_core.make_context(mm.DEFAULT_Q, n)
    a = residues(rng, (batch, n), ctx.q, device)
    b = residues(rng, (batch, n), ctx.q, device)
    words = batch * n
    t = kntt.resolve_tile(tile, n)
    launches = polymul_launches(n, tile)
    transforms = launches["ntt_tile"]
    # each launch reads and writes the data once; B1 reads a table of n words x 2
    nbytes = ((launches["ntt_tile"] + launches["ntt_pair"]) * 2 * 4 * words
              + transforms * 2 * 4 * n + 3 * 4 * words)
    butterflies = transforms * (words // 2) * (n.bit_length() - 1)
    return {
        "batch": batch, "n": n, "tile": t,
        **time_ms(lambda: ops.polymul_ntt(a, b, ctx, tile=tile), 20),
        **bound(nbytes, butterflies, sm_mhz), "launches": launches,
    }


def transform_floor_ms(n: int, rows: int, sm_mhz: float, tile: int = TILE) -> float:
    """Sum of the bounds of one transform's launches over `rows` rows of n:
    each launch reads and writes the rows once, B1 also its twiddle rows
    (2 x n words), each B2 launch its group's twiddles."""
    t = kntt.resolve_tile(tile, n)
    words = rows * n
    total = bound(8 * words + 8 * n, words // 2 * (t.bit_length() - 1), sm_mhz)["bound_ms"]
    for group in kntt.inter_groups(n, t, True):
        total += bound(8 * words + 8 * sum(st.blocks for st in group), words // 2 * len(group),
                       sm_mhz)["bound_ms"]
    return total


def rns_work(op: str, towers: int) -> dict:
    """What one call of `op` does at L = `towers`, in rows of n residues:
    `calls`, per tower the rows of each (forward call, inverse call, modmul
    call); `elementwise`, the rows its torch passes read and write in all
    (each pass's inputs read once and its output written once, as uint32)."""
    big_l = towers
    passes = {  # per tower: (rows read, rows written)
        "move a, b tower-major": (4, 4), "pair the operands": (4, 8), "form d": (4, 3),
        "move d back": (3, 3), "gather d2": (1, 1), "base-extend": (1, big_l),
        "repeat the digits": (big_l, 2 * big_l), "sum over digits": (2 * big_l, 2),
        "relinearize": (4, 2), "move back": (2, 2),
    }
    ct_mul = ["move a, b tower-major", "pair the operands", "form d"]
    keyswitch = ["base-extend", "repeat the digits", "sum over digits"]
    work = {
        "ct_mul": ([(4, 3, 4)], ct_mul + ["move d back"]),
        "keyswitch": ([(big_l, 2, 2 * big_l)], keyswitch + ["move back"]),
        "ct_mul_relin": ([(4, 3, 4), (big_l, 2, 2 * big_l)],
                         ct_mul + ["gather d2"] + keyswitch + ["relinearize", "move back"]),
        "rescale": ([], []),
    }
    calls, used = work[op]
    rows = big_l * sum(sum(passes[p]) for p in used)
    if op == "rescale":  # reads the L towers, writes L - 1, of 2 components
        rows = 2 * big_l + 2 * (big_l - 1)
    return {"calls": calls, "elementwise": rows}


def rns_floor_ms(op: str, n: int, towers: int, sm_mhz: float) -> dict:
    """The floor of one call of `op`: the sum of its launches' bounds plus
    its elementwise bytes over the memory rate."""
    work = rns_work(op, towers)
    kernels_ms = towers * sum(transform_floor_ms(n, fwd, sm_mhz) + transform_floor_ms(n, inv, sm_mhz)
                              + bound(12 * mul * n, 0, sm_mhz)["bound_ms"]
                              for fwd, inv, mul in work["calls"])
    elementwise_bytes = 4 * work["elementwise"] * n
    elementwise_ms = elementwise_bytes / HBM_BYTES_PER_S * 1e3
    return {"floor_ms": kernels_ms + elementwise_ms, "kernels_bound_ms": kernels_ms,
            "elementwise_bytes": elementwise_bytes, "elementwise_ms": elementwise_ms}


def device_breakdown(fn, calls: int = 3) -> dict:
    """Device time per call of `fn` by kernel, from torch.profiler's CUDA
    activity over `calls` calls: each of the port's kernels by name, every
    other device kernel (torch's elementwise passes) as `torch`.
    `busy_ms` is their sum: the device's busy time, without the gaps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, count = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((k for k in KERNEL_INFO if f"{k}_kernel" in e.name), "torch")
        us[name] += e.time_range.elapsed_us()
        count[name] += 1
    return {"busy_ms": sum(us.values()) / calls / 1e3,
            "ms": {k: v / calls / 1e3 for k, v in us.items()},
            "kernels_per_call": {k: v / calls for k, v in count.items()}}


def time_rns(device, sm_mhz: float, n: int = RNS_SHAPE[0], towers: int = RNS_SHAPE[1],
             seed: int = SEED) -> dict:
    """Each RNS op per call at (n, towers): device time (one call per block,
    queued behind a GPU sleep), wall and host time, its launches by kernel
    (counted over one call and checked against `rns_launches`), its floor,
    and the device's idle share of the wall time."""
    basis = he.make_basis(n, towers)
    s = he.make_secret(basis, seed, device=device)
    rlk = he.relin_key(basis, s, seed=seed + 3)
    ct_a = he.random_ct(basis, seed + 1, device=device)
    ct_b = he.random_ct(basis, seed + 2, device=device)
    c2 = he.random_poly(basis, seed + 4, device=device)
    calls = {
        "ct_mul": lambda: he.ct_mul(basis, ct_a, ct_b),
        "keyswitch": lambda: he.keyswitch(basis, c2, rlk),
        "ct_mul_relin": lambda: he.ct_mul_relin(basis, ct_a, ct_b, rlk),
        "rescale": lambda: he.rescale(basis, ct_a),
    }
    out = {}
    for op in RNS_OPS:
        kernels.reset_launch_counts()
        calls[op]()
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        expected = rns_launches(n, towers, op)
        if launches != expected:
            raise AssertionError(f"{op}: launches {launches}, expected {expected}")
        rec = time_ms(calls[op], 1, reps=7)
        out[op] = {**rec, "launches": launches, **rns_floor_ms(op, n, towers, sm_mhz),
                   "device_idle_share": 1 - rec["ms"] / rec["wall_ms"],
                   "profile": device_breakdown(calls[op])}
    return {"n": n, "towers": towers, "ops": out}


# ---------------------------------------------------------------------------
# phase 9: the LM serving path and the fastpath chain
# ---------------------------------------------------------------------------


def _rel_err(ref: torch.Tensor, got: torch.Tensor) -> float:
    """max |got - ref| over max |ref|, in float32 on the CPU."""
    ref, got = ref.float().cpu(), got.float().cpu()
    return float((ref - got).abs().max() / ref.abs().max().clamp_min(1e-30))


def lm_consistency(model, inputs: dict, s: int) -> dict:
    """`tests/test_archs.py`'s check on `model`: a full `forward` over the
    first `s` tokens against `prefill` of the first s - 2 and a decode step
    at s - 2, at the last two positions (rtol = atol = `LM_CONSISTENCY_TOL`),
    all finite."""
    tol = LM_CONSISTENCY_TOL.get(model.cfg.name, LM_CONSISTENCY_TOL["*"])
    batch = dict(inputs, tokens=inputs["tokens"][:, :s])
    with torch.inference_mode():
        full, _ = model(batch)
        logits_pre, caches = model.prefill(dict(batch, tokens=batch["tokens"][:, : s - 2]), cache_len=s)
        logits_dec, _ = model.decode_step(batch["tokens"][:, s - 2], caches, s - 2)
    pairs = {"prefill_vs_forward": (logits_pre, full[:, s - 3]), "decode_vs_forward": (logits_dec, full[:, s - 2])}
    out = {"seq": s, "tol": tol, "finite": bool(torch.isfinite(full).all() and torch.isfinite(logits_pre).all()
                                                and torch.isfinite(logits_dec).all())}
    for name, (got, ref) in pairs.items():
        got, ref = got.float(), ref.float()
        excess = ((got - ref).abs() - (tol + tol * ref.abs())).max()
        out[name] = {"max_abs_err": float((got - ref).abs().max()), "max_abs_ref": float(ref.abs().max()),
                     "least_tol": float(((got - ref).abs() / (1 + ref.abs())).max()),
                     "argmax_agrees": float((got.argmax(-1) == ref.argmax(-1)).float().mean()),
                     "ok": bool(excess <= 0)}
    if not (out["finite"] and all(out[k]["ok"] for k in pairs)):
        raise AssertionError(f"prefill/decode disagree with forward: {out}")
    return out


def _kernel_class(name: str) -> str:
    n = name.lower()
    if any(k in n for k in ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_", "sm80_")):
        return "matmul"
    if "softmax" in n:
        return "softmax"
    if any(k in n for k in ("reduce", "norm")):
        return "reduce"
    if any(k in n for k in ("index", "gather", "scatter", "sort", "cat", "where")):
        return "index / copy"
    if "copy" in n:
        return "cast / copy"
    return "elementwise"


def _class_times(prof) -> tuple[collections.Counter, collections.Counter]:
    """(µs, kernels) by `_kernel_class` of a profile's CUDA kernels."""
    us, count = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            cls = _kernel_class(e.name)
            us[cls] += e.time_range.elapsed_us()
            count[cls] += 1
    return us, count


def lm_profile(model, inputs: dict, prompt_len: int, steps: int = 4) -> dict:
    """Device time per decode step by kernel class from torch.profiler's
    CUDA activity over `steps` steps after a prefill (busy time, without
    the gaps), and the host's time per step under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        logits, caches = model.prefill(inputs, cache_len=prompt_len + steps + 1)
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                logits, caches = model.decode_step(token, caches, prompt_len + i)
                token = torch.argmax(logits, dim=-1).to(torch.int32)
            host_s = time.perf_counter() - t0
            torch.cuda.synchronize()
    us, count = _class_times(prof)
    return {"busy_ms_per_step": sum(us.values()) / steps / 1e3,
            "ms_per_step_by_class": {k: v / steps / 1e3 for k, v in us.most_common()},
            "kernels_per_step": {k: v / steps for k, v in count.most_common()},
            "host_ms_per_step_profiled": host_s / steps * 1e3}


def drive_lm_serve(arch: str, batch: int, prompt_len: int, gen: int, device, seed: int = SEED,
                   reduced: bool = False) -> dict:
    """`serve(arch, reduced=reduced)` on `device` through the user's entry
    point, between a reset and a read of the launch counts (on the card the
    LM path launches `silu_fwd` and none of B1-B3 or the chain); its
    prefill and per-step decode times, tokens/s,
    peak memory; then the prefill/decode consistency over the served
    sequence, and the device's busy share of a decode step."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve(arch, batch=batch, prompt_len=prompt_len, gen=gen, reduced=reduced, seed=seed, device=device)
    serve_s = time.perf_counter() - t0
    launches = port_launches()
    model, cfg = res["model"], res["model"].cfg
    n_params = sum(p.numel() for p in model.parameters())
    if res["generated"].shape != (batch, gen) or (res["generated"] < 0).any() \
            or (res["generated"] >= cfg.vocab_size).any():
        raise AssertionError(f"{arch}: generated {res['generated'].shape}")
    out = {"arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": n_params, "batch": batch, "prompt_len": prompt_len, "gen": gen,
           "device": res["device"], "launches": launches, "serve_s": serve_s,
           "prefill_ms": res["prefill_s"] * 1e3, "decode_s": res["decode_s"], "tok_per_s": res["tok_per_s"],
           "sample_tokens": res["generated"][0, :8].tolist()}
    if on_card:
        steps = res["step_ms"]
        out.update(decode_ms_per_token=float(np.median(steps)), decode_ms_spread=[min(steps), max(steps)],
                   peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    if lm_launch_fault(launches, device, backward=False, cfg=cfg):
        raise AssertionError(f"{arch}: the LM path launched {launches}")
    with torch.inference_mode():  # prefill again, warm: serve's first call pays the libraries' set-up
        _sync(device)
        t0 = time.perf_counter()
        model.prefill(res["inputs"], cache_len=prompt_len + gen)
        _sync(device)
        out["prefill_warm_ms"] = (time.perf_counter() - t0) * 1e3
    served = np.concatenate([np.asarray(res["inputs"]["tokens"].cpu()), res["generated"][:, :-1]], axis=1)
    inputs = dict(res["inputs"], tokens=torch.from_numpy(served).to(device))
    out["consistency"] = lm_consistency(model, inputs, served.shape[1])
    if on_card:
        prof = lm_profile(model, res["inputs"], prompt_len)
        prof["busy_share"] = prof["busy_ms_per_step"] / out["decode_ms_per_token"]
        out["profile"] = prof
    del res, model
    if on_card:
        torch.cuda.empty_cache()
    return out


def card_vs_cpu(cfg, device, batch: int = 2, seq: int = 16, seed: int = SEED, tol: float | None = None) -> dict:
    """One model on the CPU and the same weights on `device`: `forward`,
    `prefill` of seq - 4 tokens and 4 decode steps teacher-forced by the
    inputs, each side on its own caches; the largest |card - cpu| over the
    largest |cpu| of each, against `tol` (`LM_CARD_TOL` by default)."""
    tol = LM_CARD_TOL.get(cfg.name.removesuffix("-smoke"), LM_CARD_TOL["*"]) if tol is None else tol
    cpu = Transformer.init(cfg, seed, "cpu")
    card = Transformer(cfg, cpu.params).to(device)  # new parameters; the CPU model's stay
    inputs = make_inputs(cfg, batch, seq, seed)
    errs = {}
    with torch.inference_mode():
        for name, model in (("cpu", cpu), ("card", card)):
            b = to_device(inputs, "cpu" if name == "cpu" else device)
            logits, _ = model(b)
            lp, caches = model.prefill(dict(b, tokens=b["tokens"][:, : seq - 4]), cache_len=seq)
            outs = [logits, lp]
            for i in range(4):
                ld, caches = model.decode_step(b["tokens"][:, seq - 4 + i], caches, seq - 4 + i)
                outs.append(ld)
            errs[name] = outs
    names = ["forward", "prefill"] + [f"decode{i}" for i in range(4)]
    rel = {n: _rel_err(c, g) for n, c, g in zip(names, errs["cpu"], errs["card"])}
    finite = all(bool(torch.isfinite(g).all()) for g in errs["card"])
    out = {"arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "tol": tol, "rel_err": rel, "max_rel_err": max(rel.values()), "finite": finite}
    if not finite or out["max_rel_err"] > tol:
        raise AssertionError(f"card and CPU disagree: {out}")
    return out


def fastpath_cases():
    """(cfg, commands, param trace, banks, pipelined) of the fastpath grid."""
    for n, banks, entries, nb, pipelined in FASTPATH_GRID:
        cfg = PimConfig(num_buffers=nb, param_cache_entries=entries)
        cmds = RowCentricMapper(cfg, n).commands()
        trace = param_beat_trace(cfg, n, cmds) if entries else None
        yield cfg, cmds, trace, banks, pipelined


def drive_fastpath(device) -> dict:
    """`evaluate_gang(..., backend="torch", device=device)` over the grid,
    between a reset and a read of the chain kernel's count, each result
    equal to `backend="numpy"` with `==` (starts, dones, end times,
    counters), and one `verify_stream` through the torch backend; then the
    grid's chains (count, adds) and, on the card, their round trips broken
    down."""
    lowered = [(lower_commands(cfg, cmds, trace), cmds, cfg, trace, banks, pipelined)
               for cfg, cmds, trace, banks, pipelined in fastpath_cases()]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = [evaluate_gang(lp, banks, pipelined=pipelined, backend="torch", device=device)
           for lp, _, _, _, banks, pipelined in lowered]
    torch_s = time.perf_counter() - t0
    launches = dict(kfold.LAUNCHES)
    t0 = time.perf_counter()
    want = [evaluate_gang(lp, banks, pipelined=pipelined) for lp, _, _, _, banks, pipelined in lowered]
    numpy_s = time.perf_counter() - t0
    cases = []
    for (lp, _, cfg, _, banks, pipelined), g, w in zip(lowered, got, want):
        same_ = (g.makespan_ns == w.makespan_ns and g.bus_busy_ns == w.bus_busy_ns
                 and np.array_equal(g.starts, w.starts) and np.array_equal(g.dones, w.dones)
                 and np.array_equal(g.bank_end_ns, w.bank_end_ns) and g.counters == w.counters)
        cases.append({"n_cmds": lp.n_cmds, "banks": banks, "pipelined": pipelined,
                      "makespan_ns": g.makespan_ns, "bit_identical": bool(same_)})
    _, cmds, cfg, trace, banks, pipelined = lowered[-1]
    verified = verify_stream(cfg, cmds, banks, param_trace=trace, pipelined=pipelined,
                             backend="torch", device=device).makespan_ns
    chains = record_chains(lowered)
    adds = [2 * len(pn) * n for _, pn, n, _ in chains]
    out = {"cases": cases, "launches": launches, "torch_s": torch_s, "numpy_s": numpy_s,
           "verify_stream_makespan_ns": verified,
           "chains": {"count": len(chains), "adds": sum(adds), "median_adds": float(np.median(adds)),
                      "mean_adds": float(np.mean(adds)), "max_adds": max(adds)},
           "torch_minus_numpy_us_per_chain": (torch_s - numpy_s) / len(chains) * 1e6}
    if torch.device(device).type == "cuda":
        out["round_trip"] = round_trip_breakdown(chains, device)
    if not all(c["bit_identical"] for c in cases) or verified != want[-1].makespan_ns:
        raise AssertionError(f"fastpath torch backend differs from numpy: {out}")
    if launches["chain_fold"] not in (0, len(chains)):
        raise AssertionError(f"{launches['chain_fold']} chain_fold launches for {len(chains)} chains")
    return out


def record_chains(lowered) -> list:
    """The inputs ``(b0, round times, banks, t_bus)`` of every chain that the
    numpy fastpath evaluates over the grid, in order."""
    chains, numpy_chain = [], fp_evaluate._numpy_chain

    def record(b0, pn_blk, n, t_bus):
        chains.append((b0, np.array(pn_blk), n, t_bus))
        return numpy_chain(b0, pn_blk, n, t_bus)

    fp_evaluate._numpy_chain = record
    try:
        for lp, _, _, _, banks, pipelined in lowered:
            evaluate_gang(lp, banks, pipelined=pipelined)
    finally:
        fp_evaluate._numpy_chain = numpy_chain
    return chains


def round_trip_breakdown(chains, device) -> dict:
    """The grid's chains on the card, µs a chain: `total_us` through
    `kfold.chain_fold` as the backend calls it; then the same chains through
    its steps on the host clock: `host_prep_us` (the round times into pinned
    memory, the chain copied out of it) and `call_us` (the library call: the
    launch, the kernel reading and writing the pinned buffers, the sync), and
    `empty_call_us`, the call for a chain of no rounds (a launch and a sync
    of a kernel with nothing to walk).  `kernel_ms_sum` is the kernel's
    device time over the grid's chains on pinned host memory (as the round
    trip runs it, zero-copy), launched back to back on the round trip's
    stream behind a GPU sleep between two CUDA events; `kernel_us` that a
    chain; `kernel_ms_sum_device_memory` the same on device memory."""
    rt = kfold.round_trip(device)
    for c in chains[:20]:
        kfold.chain_fold(*c, device)
    t0 = time.perf_counter()
    for c in chains:
        kfold.chain_fold(*c, device)
    total = time.perf_counter() - t0
    prep = call = 0.0
    for b0, pn, n, t_bus in chains:
        t0 = time.perf_counter()
        length = rt.stage(pn, n)
        t1 = time.perf_counter()
        rt.run(b0, len(pn), n, t_bus)
        t2 = time.perf_counter()
        rt.out[0][:length].copy()
        prep += (t1 - t0) + (time.perf_counter() - t2)
        call += t2 - t1
    rt.stage(np.empty(0), 1)
    t0 = time.perf_counter()
    for _ in chains:
        rt.run(0.0, 0, 1, 1.0)
    empty = time.perf_counter() - t0
    held = [(torch.from_numpy(pn).pin_memory(), torch.empty(1 + 2 * len(pn) * n, dtype=torch.float64,
                                                           pin_memory=True)) for _, pn, n, _ in chains]
    pinned = [pinned_launch(rt, b0, len(pn), n, t_bus, x.data_ptr(), y.data_ptr())
              for (b0, pn, n, t_bus), (x, y) in zip(chains, held)]
    with torch.cuda.stream(rt.stream):
        kernel_ms = _events_ms(lambda: [launch() for launch in pinned], 1, sleep_ms=len(chains) * 0.05)[0]
    inputs = [(torch.from_numpy(pn).to(device), torch.empty(1 + 2 * len(pn) * n, dtype=torch.float64,
                                                           device=device), b0, n, t_bus)
              for b0, pn, n, t_bus in chains]
    device_ms = _events_ms(lambda: [kfold.chain_fold_cuda(*a) for a in inputs], 1,
                           sleep_ms=len(chains) * 0.05)[0]
    per = 1e6 / len(chains)
    return {"chains": len(chains), "total_us": total * per, "host_prep_us": prep * per,
            "call_us": call * per, "empty_call_us": empty * per, "kernel_us": kernel_ms * 1e3 / len(chains),
            "kernel_ms_sum": kernel_ms, "kernel_ms_sum_device_memory": device_ms}


def pinned_launch(rt, b0, k, n, t_bus, src: int, dst: int):
    """A launch of the `chain_fold` kernel alone from and into pinned host
    memory (`src`, `dst`: pointers), on the round trip `rt`'s stream with no
    sync: the kernel as `rt.run` launches it, without the call's sync."""
    lib = _build.load()

    def launch():
        _build.check(lib.chain_fold_launch(src, dst, k, int(n), float(t_bus), float(b0), rt.handle),
                     "chain_fold")

    return launch


def chain_inputs(rng, k: int, banks: int) -> tuple:
    """One speculative block of K rounds x `banks`: ``(b0, the K round times
    of mixed magnitudes, banks, t_bus)``, as `torch_chain` takes them."""
    pn = rng.uniform(0.0, 60.0, k) * rng.choice([1e-3, 1.0, 1e3], k)
    return float(rng.uniform(0.0, 1e5)), pn, banks, float(rng.choice([0.3, 1.25, 37.5]))


def increments(b0, pn, n, t_bus) -> np.ndarray:
    """``[b0, pn[0], t_bus, pn[0], t_bus, ...]``, each round time n times."""
    inc = np.empty(1 + 2 * len(pn) * n)
    inc[0] = b0
    inc[1::2] = np.repeat(pn, n)
    inc[2::2] = t_bus
    return inc


def numpy_chain(b0, pn, n, t_bus) -> np.ndarray:
    """The chain as the numpy fastpath builds it: `np.cumsum` over the increments."""
    return np.cumsum(increments(b0, pn, n, t_bus))


def check_fold(rng, device) -> dict:
    """`chain_fold` on `device` against its plain version (on the CPU, where
    `torch.cumsum` is a left fold) and `np.cumsum`, with `==`, at
    `FOLD_SHAPES`: the round trip the fastpath makes and, on the card, the
    kernel alone on device memory; then four chains in
    a row through the round trip, each result right after the others (the
    buffers are reused)."""
    checks, err = [], 0.0
    on_card = torch.device(device).type == "cuda"
    for k, banks in FOLD_SHAPES:
        b0, pn, n, t_bus = chain_inputs(rng, k, banks)
        ref = numpy_chain(b0, pn, n, t_bus)
        plain = kfold.chain_fold_plain(b0, pn, n, t_bus).numpy()
        got = {"round_trip": kfold.chain_fold(b0, pn, n, t_bus, device)}
        if on_card:
            out = torch.empty(len(ref), dtype=torch.float64, device=device)
            got["kernel"] = kfold.chain_fold_cuda(torch.from_numpy(pn).to(device), out, b0, n,
                                                  t_bus).cpu().numpy()
        for form, g in got.items():
            err = max(err, float(np.abs(g - plain).max()))
            checks.append({"rounds": k, "banks": banks, "length": len(ref), "form": form,
                           "bit_exact_vs_plain": bool(np.array_equal(g, plain)),
                           "bit_exact_vs_np_cumsum": bool(np.array_equal(g, ref))})
    row = [chain_inputs(rng, k, banks) for k, banks in ((96, 16), (3, 2), (512, 32), (5, 8))]
    outs = [kfold.chain_fold(*c, device) for c in row]
    checks.append({"in_a_row": [[len(c[1]), c[2]] for c in row], "form": "round_trip",
                   "bit_exact_vs_plain": all(np.array_equal(o, kfold.chain_fold_plain(*c).numpy())
                                             for o, c in zip(outs, row)),
                   "bit_exact_vs_np_cumsum": all(np.array_equal(o, numpy_chain(*c)) for o, c in zip(outs, row))})
    if not all(c["bit_exact_vs_plain"] and c["bit_exact_vs_np_cumsum"] for c in checks):
        raise AssertionError(f"chain_fold differs: {checks}")
    return {"max_abs_err": err, "checks": checks}


def time_dadd_probe(device) -> dict:
    """ns per dependent DADD on the card: `fold_dadd_probe` (one thread,
    `DADD_PROBE_ADDS` dependent register adds) timed by CUDA events, its sum
    checked against `np.cumsum`."""
    lib = _build.load()
    out = torch.empty(1, dtype=torch.float64, device=device)
    stream = _build.stream_handle(torch.device(device))

    def probe():
        _build.check(lib.fold_dadd_probe_launch(out.data_ptr(), DADD_PROBE_ADDS, 0.5, 0.1, stream),
                     "fold_dadd_probe")

    rec = time_ms(probe, 3)
    want = float(np.cumsum(np.concatenate([[0.5], np.full(DADD_PROBE_ADDS, 0.1)]))[-1])
    if out.item() != want:
        raise AssertionError(f"fold_dadd_probe summed {out.item()!r}, np.cumsum {want!r}")
    return {**rec, "adds": DADD_PROBE_ADDS, "ns_per_dadd": rec["ms"] * 1e6 / DADD_PROBE_ADDS}


def time_fold(rng, device) -> dict:
    """`chain_fold` alone per launch at `FOLD_TIMED`: `ms` on the round
    trip's pinned buffers and stream (zero-copy, the kernel as the fastpath
    launches it; its chain checked after), `device_memory_ms` on device
    memory; beside the dependency bound (2*K*n dependent adds at the
    probe's DADD latency) and its share, the roofline bound (K doubles in,
    2*K*n + 1 out, at the memory rate; the adds at the FP64 rate), the plain
    version (on the CPU, host clock) and `torch.cumsum` on the card (a
    parallel scan: the same sums, reassociated); then its time on device
    memory against the adds at `FOLD_FIT_ROUNDS` x 16 banks, fitted to a
    line: the walk's ns an add and the fixed cost of a launch."""
    probe = time_dadd_probe(device)
    rt = kfold.round_trip(device)
    shapes = {}
    for k, banks in FOLD_TIMED:
        b0, pn, n, t_bus = chain_inputs(rng, k, banks)
        length = rt.stage(pn, n)
        with torch.cuda.stream(rt.stream):
            rec = time_ms(pinned_launch(rt, b0, k, n, t_bus, rt.pn[1], rt.out[1]), 50)
        plain = kfold.chain_fold_plain(b0, pn, n, t_bus)
        if not np.array_equal(rt.out[0][:length], plain.numpy()):
            raise AssertionError(f"chain_fold on the pinned buffers differs at {k} x {banks}")
        x = torch.from_numpy(pn).to(device)
        out = torch.empty(length, dtype=torch.float64, device=device)
        device_ms = time_ms(lambda: kfold.chain_fold_cuda(x, out, b0, n, t_bus), 50)["ms"]
        t0 = time.perf_counter()
        for _ in range(200):
            kfold.chain_fold_plain(b0, pn, n, t_bus)
        plain_ms = (time.perf_counter() - t0) / 200 * 1e3
        inc = torch.from_numpy(increments(b0, pn, n, t_bus)).to(device)
        lib = time_ms(lambda: torch.cumsum(inc, 0), 50)
        lib_exact = bool(torch.equal(torch.cumsum(inc, 0).cpu(), plain))
        adds = 2 * k * n
        nbytes = 8 * k + 8 * (adds + 1)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = adds / FP64_FLOPS * 1e3
        dep_ms = adds * probe["ns_per_dadd"] * 1e-6
        shapes[f"{k}x{banks}"] = {
            **rec, "device_memory_ms": device_ms, "plain_ms": plain_ms, "plain_device": "cpu",
            "library_ms": lib["ms"], "library_call": "torch.cumsum(x, 0) on the card",
            "library_bit_exact": lib_exact, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "dependency_bound_ms": dep_ms,
            "dependency_share": dep_ms / rec["ms"], "bytes": nbytes, "adds": adds, "rounds": k,
            "banks": banks, "ns_per_add": rec["ms"] * 1e6 / adds}
    fit = []
    for k in FOLD_FIT_ROUNDS:
        b0, pn, n, t_bus = chain_inputs(rng, k, 16)
        x = torch.from_numpy(pn).to(device)
        out = torch.empty(1 + 2 * k * n, dtype=torch.float64, device=device)
        fit.append((2 * k * n, time_ms(lambda: kfold.chain_fold_cuda(x, out, b0, n, t_bus), 30)["ms"]))
    slope, intercept = np.polyfit(*zip(*fit), 1)
    return {"probe": probe, "shapes": shapes, "fit_adds_ms": fit, "walk_ns_per_add": slope * 1e6,
            "walk_share_of_dadd_latency": probe["ns_per_dadd"] / (slope * 1e6), "fixed_us": intercept * 1e3}


# ---------------------------------------------------------------------------
# phase 10: the LM training core
# ---------------------------------------------------------------------------


def port_launches() -> dict:
    """Launches so far of every kernel of the port, the chain's, silu's and softplus's included."""
    return {**kernels.launch_counts(), **kfold.LAUNCHES, **ksilu.LAUNCHES, **ksoftplus.LAUNCHES}


def lm_launch_fault(launches: dict, device, backward: bool, cfg) -> bool:
    """Whether an LM path's launch counts are wrong: on the card it launches
    `silu_fwd` (and `silu_bwd` where it takes grads), `softplus_fwd` (and
    `softplus_bwd`) where `cfg` has SSD mixers, and no other kernel of the
    port; on the CPU no kernel at all."""
    lm = {"silu_fwd", "silu_bwd"} if backward else {"silu_fwd"}
    if any(mixer == "mamba" for mixer, _ in cfg.pattern()):
        lm |= {"softplus_fwd", "softplus_bwd"} if backward else {"softplus_fwd"}
    on_card = torch.device(device).type == "cuda"
    return any((v > 0) != (on_card and k in lm) for k, v in launches.items())


def profile_by_class(fn) -> dict:
    """Device time of one call of `fn` by kernel class (`_kernel_class`), from
    torch.profiler's CUDA activity: busy time, without the gaps."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us, count = _class_times(prof)
    return {"busy_ms": sum(us.values()) / 1e3, "ms_by_class": {k: v / 1e3 for k, v in us.most_common()},
            "kernels_by_class": dict(count.most_common()), "kernels": sum(count.values())}


def drive_train_steps(arch: str, moments: str, device, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                      steps: int = TRAIN_STEPS, reduced: bool = False, seed: int = SEED) -> dict:
    """`steps` train steps of `arch` (steps 1..steps: step 0's lr is 0 under
    warmup) through `make_train_step`, AdamW with `moments`, on batches of
    `SyntheticStream(seed)`, between a reset and a read of the launch
    counts; each step's loss, grad norm and ms (CUDA events on the card),
    then one more step under the profiler.  Every loss and grad norm must
    be finite (a norm is finite only if every grad is) and the mean of the
    last 3 losses below that of the first 3."""
    on_card = torch.device(device).type == "cuda"
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    opt_cfg = OptConfig(moment_dtype=moments, warmup_steps=1, total_steps=steps + 1)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, device)
    opt_state = steps_lib.make_opt_init(cfg, opt_cfg)(params)
    _sync(device)
    init_s = time.perf_counter() - t0
    stream = SyntheticStream(cfg, batch, seq, seed=seed)
    step_fn = steps_lib.make_train_step(cfg, opt_cfg)
    rows = []
    for step in range(1, steps + 1):
        b = to_device(stream.batch_at(step), device)
        if on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, b, step)
        if on_card:
            ev[1].record()
        row = {"step": step, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"])}
        _sync(device)
        row["ms"] = ev[0].elapsed_time(ev[1]) if on_card else (time.perf_counter() - t0) * 1e3
        rows.append(row)
    if on_card:  # one more step, under the profiler
        b = to_device(stream.batch_at(steps + 1), device)
        prof = profile_by_class(lambda: step_fn(params, opt_state, b, steps + 1))
    launches = port_launches()
    losses = [r["loss"] for r in rows]
    ms = [r["ms"] for r in rows[1:]]
    step_ms = float(np.median(ms))
    flops = model_flops(cfg, ShapeConfig("train", seq, batch, "train"))
    out = {"arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": sum(p.numel() for p in leaves(params)), "remat": cfg.remat, "moment_dtype": moments,
           "batch": batch, "seq": seq, "steps": rows, "init_s": init_s, "launches": launches,
           "first_step_ms": rows[0]["ms"], "step_ms": step_ms, "step_ms_spread": [min(ms), max(ms)],
           "tokens_per_s": batch * seq / step_ms * 1e3, "model_tflop_per_step": flops / 1e12,
           "model_tflop_per_s": flops / step_ms / 1e9}
    if on_card:
        out.update(mfu_vs_bf16_peak=out["model_tflop_per_s"] * 1e12 / BF16_PEAK_FLOPS,
                   peak_mib=torch.cuda.max_memory_allocated() / 2**20, profile=prof,
                   busy_share=prof["busy_ms"] / step_ms)
    del params, opt_state, step_fn
    if on_card:
        torch.cuda.empty_cache()
    finite = all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows)
    falling = np.mean(losses[-3:]) < np.mean(losses[:3])
    if not finite or not falling or lm_launch_fault(launches, device, backward=True, cfg=cfg):
        raise AssertionError(f"{arch}: train steps finite {finite}, falling {falling}, launches {launches}: {rows}")
    return out


def drive_train_loop(device, arch: str = "qwen3-4b", batch: int = 4, seq: int = 64) -> dict:
    """`train()` on `device` at reduced `arch`, checkpoints in a temporary
    directory: 10 steps, then a resume to 16 with a fault injected at step
    13, each run's step list exactly `TRAIN_LOOP_STEPS` (an unexpected
    rollback fails the phase), the retried steps' losses equal to their
    first run's, and a restore of the last checkpoint equal bit for bit to
    the state `train` returned."""
    kw = dict(batch=batch, seq=seq, ckpt_every=5, log_every=100, device=device)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        _, _, hist1 = train(arch, 10, ckpt_dir=d, **kw)
        params, opt_state, hist2 = train(arch, 16, ckpt_dir=d, injector=FaultInjector([13]), **kw)
        seconds = time.perf_counter() - t0
        restored, manifest = CheckpointManager(d).restore(16, (params, opt_state), device=device)
        same_state = all(torch.equal(a, b) for a, b in zip(leaves((params, opt_state)), leaves(restored)))
    runs = [[h["step"] for h in hist] for hist in (hist1, hist2)]
    first = {}
    repeats_equal = all(first.setdefault(h["step"], h["loss"]) == h["loss"] for h in hist2)
    out = {"arch": arch, "batch": batch, "seq": seq, "step_lists": runs, "expected": list(TRAIN_LOOP_STEPS),
           "losses": [h["loss"] for h in hist1 + hist2], "retried_losses_equal": repeats_equal,
           "restore_step": manifest["step"], "restore_bit_exact": same_state, "seconds": seconds}
    if runs != list(TRAIN_LOOP_STEPS) or not repeats_equal or not same_state:
        raise AssertionError(f"train() resume / fault run: {out}")
    return out


def train_card_vs_cpu(cfg, device, batch: int = 2, seq: int = 16, seed: int = SEED, tol: float | None = None) -> dict:
    """The loss and every grad of `cfg` on the CPU and with the same weights
    on `device`: max |card - cpu| / max |cpu| of the loss and of each leaf's
    grad, the largest against `tol` (`TRAIN_CARD_TOL` by default)."""
    tol = TRAIN_CARD_TOL.get(cfg.name.removesuffix("-smoke"), TRAIN_CARD_TOL["*"]) if tol is None else tol
    gen = torch.Generator().manual_seed(seed)
    cpu = T.init_params(cfg, gen, "cpu")
    inputs = make_inputs(cfg, batch, seq, seed)
    out = {}
    for name, dev in (("cpu", "cpu"), ("card", device)):
        params = cpu if dev == "cpu" else tree_map(lambda p: p.to(dev), cpu)
        loss, _, grads = steps_lib.loss_and_grads(cfg, params, to_device(inputs, dev))
        out[name] = [loss] + leaves(grads)
    names = ["loss"] + [keystr(p) for p, _ in leaves_with_path(cpu)]
    rel = {n: _rel_err(c, g) for n, c, g in zip(names, out["cpu"], out["card"])}
    finite = all(bool(torch.isfinite(g).all()) for g in out["card"])
    worst = max(rel, key=rel.get)
    res = {"arch": cfg.name, "tol": tol, "loss_rel_err": rel["loss"], "max_rel_err": rel[worst],
           "worst_leaf": worst, "leaves": len(names) - 1, "finite": finite}
    if not finite or res["max_rel_err"] > tol:
        raise AssertionError(f"train: card and CPU disagree: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 11: the distribution layer
# ---------------------------------------------------------------------------


class one_rank_world:
    """A process group of this process alone (NCCL on the card, gloo on the
    CPU), met through a `file://` store in a temporary directory, destroyed
    on exit."""

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        self.tmp = tempfile.TemporaryDirectory()
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device.index or 0)
        torch.distributed.init_process_group(backend, init_method=f"file://{self.tmp.name}/store", rank=0,
                                             world_size=1, timeout=timedelta(seconds=60))
        return self

    def __exit__(self, *exc):
        torch.distributed.destroy_process_group()
        self.tmp.cleanup()


def check_compression(grads, mesh, pods) -> dict:
    """`compressed_psum` over the mesh's data group and
    `hierarchical_grad_sync` over a (pod, data) mesh, leaf by leaf: at world
    size 1 each must equal `ef_decompress` of the leaf's own codes (the
    int32 sum of one rank's codes is that rank's), bit for bit; the whole
    tree's sync timed once."""
    group = mesh.get_group("data")
    bad = []
    for path, g in leaves_with_path(grads):
        want = ef_decompress(*ef_compress(g, torch.zeros((), dtype=torch.float32, device=g.device))[:2])
        if not torch.equal(compressed_psum(g, group), want):
            bad.append(f"compressed_psum {keystr(path)}")
        if not torch.equal(hierarchical_grad_sync({"g": g}, pods)["g"], want):
            bad.append(f"hierarchical_grad_sync {keystr(path)}")
        del want
    on_card = pods.device_type == "cuda"
    t0 = time.perf_counter()
    if on_card:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    synced = hierarchical_grad_sync(grads, pods)
    if on_card:
        ev[1].record()
    _sync(pods.device_type)
    ms = ev[0].elapsed_time(ev[1]) if on_card else (time.perf_counter() - t0) * 1e3
    out = {"leaves": len(leaves(grads)), "elements": sum(g.numel() for g in leaves(grads)),
           "mismatches": bad, "tree_sync_ms": ms}
    del synced
    if bad:
        raise AssertionError(f"compression over {pods.device_type}: {bad}")
    return out


def timed_call(fn, device):
    """(fn's result, ms): CUDA events on the card, the host clock elsewhere."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    out = fn()
    if on_card:
        ev[1].record()
    _sync(device)
    return out, ev[0].elapsed_time(ev[1]) if on_card else (time.perf_counter() - t0) * 1e3


def drive_dist_step(device, arch: str = DIST_ARCH, moments: str = DIST_MOMENTS, batch: int = TRAIN_BATCH,
                    seq: int = TRAIN_SEQ, steps: int = DIST_STEPS, reduced: bool = False, seed: int = SEED,
                    layers: int | None = None, compression: bool = True) -> dict:
    """Phase 11 (a), inside a one-rank world: with `compression`, step 1's
    grads through the collectives (`check_compression`); `steps` unsharded
    steps (`make_train_step`), step 1's loss, aux loss, grad norm, params and
    moments copied to the host; then the same seed's state as `DTensor`s on
    a 1 x 1 mesh and `steps` steps of `make_sharded_train_step` (its model
    code under `parallel.sharded`): step 1's metrics and every leaf must
    equal the unsharded step's bit for bit.  Steps 2..`steps` of both are
    timed alike (CUDA events on the card), one after the other in this
    process with nothing else running.  Launch counts are reset before and
    read after the sharded steps.  On the card one more step of each runs
    under the profiler (device busy time by kernel class).  `layers` cuts
    the depth."""
    on_card = torch.device(device).type == "cuda"
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    opt_cfg = OptConfig(moment_dtype=moments, warmup_steps=1, total_steps=steps + 1)
    mesh = make_host_mesh(data=1, model=1, device=device)
    pods = make_mesh(("pod", "data"), (1, 1), device)
    host_id, num_hosts = steps_lib.data_parallel_rank(mesh)
    stream = SyntheticStream(cfg, batch, seq, seed=seed, host_id=host_id, num_hosts=num_hosts)

    def init_params():  # the same values at every call
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return T.init_params(cfg, gen, device)

    def init_state():
        params = init_params()
        return params, steps_lib.make_opt_init(cfg, opt_cfg)(params)

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    b1 = to_device(stream.batch_at(1), device)
    checked = None
    if compression:
        grads = steps_lib.loss_and_grads(cfg, init_params(), b1)[2]  # the params go once their grads are taken
        checked = check_compression(grads, mesh, pods)
        del grads
    params, opt_state = init_state()
    step_fn = steps_lib.make_train_step(cfg, opt_cfg)
    unsharded_ms = []
    for step in range(1, steps + 1):
        b = b1 if step == 1 else to_device(stream.batch_at(step), device)
        (params, opt_state, m), ms = timed_call(lambda: step_fn(params, opt_state, b, step), device)
        unsharded_ms.append(ms)
        if step == 1:
            ref = [t.to("cpu", copy=True) for t in leaves((params, opt_state))]  # steps 2.. update in place
            ref_metrics = {k: float(m[k]) for k in ("loss", "aux", "grad_norm", "lr")}
    if on_card:  # one more step of each, under the profiler
        extra = to_device(stream.batch_at(steps + 1), device)
        unsharded_prof = profile_by_class(lambda: step_fn(params, opt_state, extra, steps + 1))
    del params, opt_state, m, step_fn
    free()
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    state = init_state()
    shardings = (shd.param_shardings(mesh, state[0]), shd.opt_shardings(mesh, state[1]))
    params, opt_state = shd.distribute_tree(state, shardings)
    del state
    step_fn = steps_lib.make_sharded_train_step(cfg, opt_cfg, mesh)
    kernels.reset_launch_counts()
    rows = []
    for step in range(1, steps + 1):
        b = b1 if step == 1 else to_device(stream.batch_at(step), device)
        (params, opt_state, m), ms = timed_call(lambda: step_fn(params, opt_state, b, step), device)
        rows.append({"step": step, "loss": float(m["loss"]), "aux": float(m["aux"]), "grad_norm": float(m["grad_norm"]),
                     "ms": ms})
        if step == 1:
            got = leaves((params, opt_state))
            unequal = [i for i, (a, r) in enumerate(zip(got, ref)) if not torch.equal(a.to_local(), r.to(device))]
            equal = {"leaves": len(ref), "unequal_leaves": unequal,
                     **{k: float(m[k]) == ref_metrics[k] for k in ("loss", "aux", "grad_norm", "lr")}}
            del ref, got
    launches = port_launches()
    if on_card:
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        prof = profile_by_class(lambda: step_fn(params, opt_state, extra, steps + 1))
    ms = [r["ms"] for r in rows[1:]]
    step_ms, plain_ms = float(np.median(ms)), float(np.median(unsharded_ms[1:]))
    out = {"arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model, "experts": cfg.num_experts,
           "moment_dtype": moments, "params": sum(p.numel() for p in leaves(params)),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "backend": torch.distributed.get_backend(), "batch": batch, "seq": seq, "steps": rows,
           "unsharded_step1": ref_metrics, "equal_to_unsharded": equal, "compression": checked,
           "launches": launches, "first_step_ms": rows[0]["ms"], "step_ms": step_ms,
           "step_ms_spread": [min(ms), max(ms)], "tokens_per_s": batch * seq / step_ms * 1e3,
           "unsharded_step_ms": plain_ms, "unsharded_step_ms_all": unsharded_ms,
           "sharded_over_unsharded": step_ms / plain_ms,
           "placements": sorted({str(p.placements) for p in leaves(params)})}
    if on_card:
        out.update(peak_mib=peak_mib, profile=prof, unsharded_profile=unsharded_prof,
                   busy_over_unsharded=prof["busy_ms"] / unsharded_prof["busy_ms"])
    del params, opt_state, step_fn
    free()
    if (equal["unequal_leaves"] or not all(equal[k] for k in ("loss", "aux", "grad_norm", "lr"))
            or lm_launch_fault(launches, device, backward=True, cfg=cfg)):
        raise AssertionError(f"dist: the sharded step differs from the unsharded one: {equal}, launches {launches}")
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows):
        raise AssertionError(f"dist: non-finite steps {rows}")
    return out


def serve_steps(prefill, decode, params, inputs, prompt_len: int, gen: int, device, local=lambda t: t) -> dict:
    """`generate`'s loop over the steps `prefill` / `decode`: the prefill,
    then `gen - 1` greedy decode steps, each call timed alike
    (`timed_call`).  `local` takes a step's logits or cache leaf to a plain
    tensor (a `DTensor`'s local shard).  Returns the tokens, every call's
    logits, the caches (and as `next`, a call of one more decode step on
    them) and the times."""
    with torch.inference_mode():
        (logits, caches), prefill_ms = timed_call(lambda: prefill(params, inputs), device)
        out = [local(logits)]
        tokens = [torch.argmax(out[-1], dim=-1).to(torch.int32)]
        step_ms = []
        for i in range(gen - 1):
            (logits, caches), ms = timed_call(lambda: decode(params, tokens[-1], caches, prompt_len + i), device)
            out.append(local(logits))
            tokens.append(torch.argmax(out[-1], dim=-1).to(torch.int32))
            step_ms.append(ms)

    def next_step():
        with torch.inference_mode():
            decode(params, tokens[-1], caches, prompt_len + gen - 1)

    return {"tokens": torch.stack(tokens, dim=1), "logits": out, "prefill_ms": prefill_ms, "step_ms": step_ms,
            "caches": [{k: local(t) for k, t in c.items()} for c in caches], "next": next_step}


def drive_dist_serve(device, arch: str, batch: int, prompt_len: int, gen: int, reduced: bool = False,
                     seed: int = SEED) -> dict:
    """Phase 11 (b), inside a one-rank world: `serve`'s weights and prompt
    for `seed`, served greedily by the unsharded steps (`make_prefill_step`
    / `make_decode_step`, as `generate` runs them) and by
    `make_sharded_prefill_step` / `make_sharded_decode_step` on the same
    weights as `DTensor`s on a 1 x 1 mesh, each fed its own greedy tokens,
    in turns (unsharded, sharded, sharded, unsharded): every sharded run's
    tokens, logits and cache leaves must equal the first unsharded run's
    bit for bit (at world size 1 nothing is split and no collective runs).
    Each prefill and decode step is timed alike; a version's decode ms is
    the median over its two runs' steps.  The launch counts are reset
    before and read after the sharded runs.  A short unsharded serve
    first, untimed, pays the first calls' set-up; on the card one more
    decode step of each runs under the profiler (device busy ms)."""
    on_card = torch.device(device).type == "cuda"
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    inputs = to_device(make_inputs(cfg, batch, prompt_len, seed), device)
    cache_len = prompt_len + gen
    mesh = make_host_mesh(data=1, model=1, device=device)
    versions = {
        "unsharded": (steps_lib.make_prefill_step(cfg, cache_len), steps_lib.make_decode_step(cfg), params,
                      lambda t: t),
        "sharded": (steps_lib.make_sharded_prefill_step(cfg, cache_len, mesh),
                    steps_lib.make_sharded_decode_step(cfg, mesh),
                    shd.distribute_tree(params, shd.param_shardings(mesh, params)), lambda t: t.to_local()),
    }

    def run(name, n=gen):
        prefill, decode, weights, local = versions[name]
        return serve_steps(prefill, decode, weights, inputs, prompt_len, n, device, local)

    run("unsharded", 2)  # untimed: the first calls' set-up
    runs = {"unsharded": [run("unsharded")]}
    kernels.reset_launch_counts()
    runs["sharded"] = [run("sharded"), run("sharded")]
    launches = port_launches()
    runs["unsharded"].append(run("unsharded"))
    plain = runs["unsharded"][0]
    unequal_logits, unequal_caches, tokens = [], [], True
    for split in runs["sharded"]:
        tokens = tokens and bool(torch.equal(plain["tokens"], split["tokens"]))
        unequal_logits += [i for i, (a, b) in enumerate(zip(plain["logits"], split["logits"])) if not torch.equal(a, b)]
        unequal_caches += [f"{i}.{k}" for i, (a, b) in enumerate(zip(plain["caches"], split["caches"]))
                           for k in a if not torch.equal(a[k], b[k])]
    equal = {"tokens": tokens, "unequal_logits": unequal_logits, "unequal_cache_leaves": unequal_caches,
             "cache_leaves": sum(len(c) for c in plain["caches"]), "logits": len(plain["logits"]),
             "sharded_runs": len(runs["sharded"])}
    out = {"arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": sum(p.numel() for p in leaves(params)), "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "backend": torch.distributed.get_backend(), "batch": batch, "prompt_len": prompt_len, "gen": gen,
           "order": ["unsharded", "sharded", "sharded", "unsharded"], "equal_to_unsharded": equal,
           "launches": launches, "sample_tokens": runs["sharded"][0]["tokens"][0, :8].tolist(),
           "cache_specs": sorted({f"{k}: {sh.spec}" for c in shd.cache_shardings(
               mesh, T.init_cache(cfg, batch, cache_len, device="meta")) for k, sh in c.items()})}
    for name, pair in runs.items():
        ms = [m for r in pair for m in r["step_ms"]]
        out[f"{name}_prefill_ms"] = [r["prefill_ms"] for r in pair]
        out[f"{name}_decode_ms_per_step"] = float(np.median(ms))
        out[f"{name}_decode_ms_by_run"] = [float(np.median(r["step_ms"])) for r in pair]
        out[f"{name}_decode_ms_spread"] = [min(ms), max(ms)]
        if on_card:
            out[f"{name}_decode_profile"] = profile_by_class(pair[0]["next"])
    out["sharded_over_unsharded_decode"] = out["sharded_decode_ms_per_step"] / out["unsharded_decode_ms_per_step"]
    finite = all(bool(torch.isfinite(t.float()).all()) for r in runs["sharded"] for t in r["logits"])
    del runs, plain, versions, params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if (not tokens or unequal_logits or unequal_caches or not finite
            or lm_launch_fault(launches, device, backward=False, cfg=cfg)):
        raise AssertionError(f"dist serve {arch}: the sharded steps differ from the unsharded ones: {equal}, "
                             f"finite {finite}, launches {launches}")
    return out


def check_ssd_head_split(device, runs=(4, 2), splits=parallel_check.SSD_SPLITS) -> dict:
    """Phase 11, part `ssd_head_split`: the SSD of reduced mamba2, reduced
    jamba (baseline form) and mamba2-780m at full width on `device`, whole
    and in runs of heads as `runs` ranks of the sharded step hold them
    (`parallel_check.ssd_head_split`), forward and backward: y, the state
    and every grad bit for bit."""
    t0 = time.perf_counter()
    cases = [{"case": name, **parallel_check.ssd_head_split(arch, r, device, full, b, s)}
             for name, arch, full, b, s in splits for r in runs]
    out = {"cases": cases, "exact": all(c["exact"] for c in cases), "seconds": time.perf_counter() - t0}
    if not out["exact"]:
        raise AssertionError(f"the SSD's head split is not exact: {[c for c in cases if not c['exact']]}")
    return out


def run_dryrun_sweep(report_dir: str, args=("--all",)) -> dict:
    """`python -m repro_torch.launch.dryrun` in a child interpreter on the
    host (a fake world of 256 ranks, meta tensors: no card), killed past
    `DRYRUN_TIMEOUT_S`; then its records: counts by status and each run
    cell's roofline row (H100 data-sheet rates).  A FAIL or a non-zero exit
    fails the phase."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--report-dir", report_dir]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    recs = []
    for name in sorted(os.listdir(report_dir)):
        with open(os.path.join(report_dir, name)) as f:
            recs.append(json.load(f))
    status = collections.Counter("FAIL" if r["status"].startswith("FAIL") else r["status"].split(":")[0]
                                 for r in recs)
    cells = []
    for r in recs:
        row = roofline.analyze_cell(r)
        cell = {"cell": f"{r['arch']}__{r['shape']}", "status": r["status"][:300]}
        if row:
            cell.update({k: row[k] for k in ("compute_s", "memory_s", "collective_s", "dominant", "useful_ratio",
                                             "roofline_fraction", "peak_gib")},
                        pass_s=r["pass_s"], counts=r["collectives"]["counts"])
        cells.append(cell)
    res = {"cells": len(recs), "status": dict(status), "host_seconds": seconds, "exit_code": proc.returncode,
           "roofline_table": cells}
    if proc.returncode != 0 or status.get("FAIL"):
        raise AssertionError(f"dry-run sweep failed: {res}: {proc.stderr[-3000:]}")
    return res


def sass_summary(library: str) -> dict | None:
    """Per kernel of the built library, its SASS instruction count by
    opcode class, from `cuobjdump -sass` where the toolkit has it."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.access(tool, os.X_OK):
        return None
    out = subprocess.run([tool, "-sass", library], capture_output=True, text=True, check=True,
                         timeout=300).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name is not None:
            op = m.group(1)
            kernels[name][op.split(".")[0]] += 1
            if op.startswith("IMAD.HI"):
                kernels[name]["IMAD.HI"] += 1
    return {k: dict(sorted(v.items())) for k, v in kernels.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    device = "cuda"
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi("name,power.limit")
    emit({"phase": "device", "name": name, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    _build.load()
    report = _build.build_report()
    emit({"phase": "build", "nvcc_seconds": report["seconds"], "cached": report["cached"],
          "load_seconds": time.perf_counter() - t0, "ptxas": report["ptxas"]})
    # a stack frame means registers arrays went to local memory; a spill, registers ran out
    local = [ln for ln in report["ptxas"] if re.search(r"\b[1-9]\d* bytes (stack frame|spill)", ln)]
    if local:
        raise AssertionError(f"ptxas reports local memory use: {local}")
    emit({"phase": "sass", "kernels": sass_summary(report["library"])})

    rng = np.random.default_rng(SEED)
    checked = check_kernels(rng, device)
    emit({"phase": "check", **checked})
    silu_checked = check_silu(rng, device)
    emit({"phase": "check", "part": "silu", **silu_checked})
    softplus_checked = check_softplus(rng, device)
    emit({"phase": "check", "part": "softplus", **softplus_checked})
    emit({"phase": "check", "part": "split_products", **check_split_products(device)})

    main_run = drive_main_path(rng, device)
    launches = main_run["launches"]
    expected = expected_launches()
    emit({"phase": "main", **main_run, "expected_launches": expected})
    if launches != expected or any(v <= 0 for v in launches.values()):
        raise AssertionError(f"launch counts {launches}, expected {expected}")

    kept: dict = {}
    rns = drive_rns(device, keep=kept)
    emit({"phase": "rns", **rns})
    if (rns["launches"] != rns["expected_launches"] or rns["key_launches"] != rns["expected_key_launches"]
            or any(v <= 0 for v in rns["launches"].values())):
        raise AssertionError(f"rns launch counts {rns['key_launches']} / {rns['launches']}, expected "
                             f"{rns['expected_key_launches']} / {rns['expected_launches']}")

    t0 = time.perf_counter()
    pim = {"card": drive_pimsys(device, kept)}
    del kept
    if pim["card"]["launches"] != pim["card"]["expected_launches"]:
        raise AssertionError(f"pimsys launch counts {pim['card']['launches']}, expected "
                             f"{pim['card']['expected_launches']}")
    pim["host"] = run_pimsys_host()
    pim["seconds"] = time.perf_counter() - t0
    emit({"phase": "pimsys", **pim})

    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    timing = {f"{b}x{n}": time_kernels(rng, device, b, n, sm_mhz) for b, n in MAIN_SHAPES}
    polymul = [time_polymul(rng, device, b, n, sm_mhz) for b, n in MAIN_SHAPES]
    rns_timing = time_rns(device, sm_mhz)
    silu_timing = time_silu(rng, device)
    softplus_timing = time_softplus(device)
    power = nvidia_smi("name,power.limit,power.draw,clocks.sm,temperature.gpu")
    emit({"phase": "timing", "card": smi, "kernels": timing, "polymul_ntt": polymul,
          "rns": rns_timing, "silu": silu_timing, "softplus": softplus_timing, "nvidia_smi_after": power})

    # phase 9: the LM serving path, then the fastpath chain
    t_lm = time.perf_counter()
    lm_serves = []
    for spec in LM_SERVE:
        lm_serves.append(drive_lm_serve(*spec, device))
        emit({"phase": "lm", "part": "serve", **lm_serves[-1]})
    wide = dataclasses.replace(get_config("qwen3-4b"), num_layers=2)
    emit({"phase": "lm", "part": "full_width_card_vs_cpu", **card_vs_cpu(wide, device)})
    reduced = [card_vs_cpu(get_config(a).reduced(capacity_factor=8.0), device) for a in ARCH_NAMES]
    emit({"phase": "lm", "part": "reduced_card_vs_cpu", "archs": reduced})
    fold_check = check_fold(rng, device)
    fastpath = drive_fastpath(device)
    fold_timing = time_fold(rng, device)
    fastpath["grid_dependency_bound_ms"] = fastpath["chains"]["adds"] * fold_timing["probe"]["ns_per_dadd"] * 1e-6
    emit({"phase": "lm", "part": "fastpath", "check": fold_check, **fastpath, "timing": fold_timing})
    if fastpath["launches"]["chain_fold"] <= 0:
        raise AssertionError(f"the fastpath's torch backend launched no chain_fold: {fastpath['launches']}")
    emit({"phase": "lm", "part": "done", "seconds": time.perf_counter() - t_lm,
          "card": nvidia_smi("name,power.limit,power.draw,clocks.sm,temperature.gpu")})

    # phase 10: the LM training core, on a card the lm phase's models have left
    gc.collect()
    torch.cuda.empty_cache()
    t_train = time.perf_counter()
    train_runs = []
    for arch, moments in TRAIN_FULL:
        train_runs.append(drive_train_steps(arch, moments, device))
        emit({"phase": "train", "part": "steps", **train_runs[-1]})
    kernels.reset_launch_counts()
    loop = drive_train_loop(device)
    train_runs.append({"launches": port_launches()})
    emit({"phase": "train", "part": "train_loop", **loop})
    grads = [train_card_vs_cpu(get_config(a).reduced(capacity_factor=8.0), device) for a in ARCH_NAMES]
    emit({"phase": "train", "part": "card_vs_cpu", "archs": grads})
    emit({"phase": "train", "part": "done", "seconds": time.perf_counter() - t_train,
          "card": nvidia_smi("name,power.limit,power.draw,clocks.sm,temperature.gpu")})

    # phase 11: the distribution layer; the dry-run sweep runs on the host after the card's part
    gc.collect()
    torch.cuda.empty_cache()
    t_dist = time.perf_counter()
    with one_rank_world(device):
        dist_run = drive_dist_step(device)
        emit({"phase": "dist", "part": "sharded_step", **dist_run})
        arch, layers, moments = DIST_MOE
        moe_run = drive_dist_step(device, arch, moments, layers=layers, compression=False)
        emit({"phase": "dist", "part": "sharded_moe_step", **moe_run})
        mixer_runs = []
        for arch, layers, moments, seq in DIST_MIXERS:
            mixer_runs.append(drive_dist_step(device, arch, moments, seq=seq, layers=layers, compression=False))
            emit({"phase": "dist", "part": "sharded_mixer_step", **mixer_runs[-1]})
        serve_runs = []
        for spec in DIST_SERVE:
            serve_runs.append(drive_dist_serve(device, *spec))
            emit({"phase": "dist", "part": "sharded_serve", **serve_runs[-1]})
    head_split = check_ssd_head_split(device)
    emit({"phase": "dist", "part": "ssd_head_split", **head_split})
    with tempfile.TemporaryDirectory() as report_dir:
        dryrun_sweep = run_dryrun_sweep(report_dir)
    emit({"phase": "dist", "part": "dryrun_sweep", **dryrun_sweep})
    emit({"phase": "dist", "part": "done", "seconds": time.perf_counter() - t_dist,
          "card": nvidia_smi("name,power.limit,power.draw,clocks.sm,temperature.gpu")})

    big = timing[f"{MAIN_SHAPES[0][0]}x{MAIN_SHAPES[0][1]}"]
    rows = []
    for kname, (source, replaces) in KERNEL_INFO.items():
        rec = big[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": checked["max_abs_err"][kname],
            "launches_by_path": {"polymul_ntt": launches[kname], "rns relin_key": rns["key_launches"][kname],
                                 "rns ct_mul_relin + rescale": rns["launches"][kname],
                                 "pimsys CtMulRelinOp run": pim["card"]["launches"][kname],
                                 "lm serve": sum(r["launches"][kname] for r in lm_serves),
                                 "train": sum(r["launches"][kname] for r in train_runs),
                                 "dist": sum(r["launches"][kname]
                                             for r in (dist_run, moe_run, *mixer_runs, *serve_runs))},
            "bit_exact": checked["max_abs_err"][kname] == 0,
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": list(MAIN_SHAPES[0]),
        })
    block = fold_timing["shapes"]["%dx%d" % FOLD_TIMED[0]]
    rows.append({
        "name": "chain_fold", "route": "cuda", "source": "src/repro_torch/kernels/csrc/fold.cu",
        "replaces": "src/repro/pimsys/fastpath/jax_backend.py:39 (_scan_chain, a lax.scan, not Pallas)",
        "launches": fastpath["launches"]["chain_fold"], "max_abs_err": fold_check["max_abs_err"],
        "launches_by_path": {"fastpath evaluate_gang grid": fastpath["launches"]["chain_fold"],
                             "train": sum(r["launches"]["chain_fold"] for r in train_runs),
                             "dist": sum(r["launches"]["chain_fold"]
                                         for r in (dist_run, moe_run, *mixer_runs, *serve_runs))},
        "bit_exact": fold_check["max_abs_err"] == 0,
        "ms": block["ms"], "plain_ms": block["plain_ms"], "bound_ms": block["bound_ms"],
        "bound_by": block["bound_by"], "library_ms": block["library_ms"],
        "dependency_bound_ms": block["dependency_bound_ms"], "device_memory_ms": block["device_memory_ms"],
        "shape": [block["rounds"], block["banks"]],
    })
    for kname, (source, replaces) in SILU_INFO.items():
        rec = silu_timing[SILU_TIMED[0]][kname]
        by_path = {"lm serve": sum(r["launches"][kname] for r in lm_serves),
                   "train": sum(r["launches"][kname] for r in train_runs[:len(TRAIN_FULL)]),
                   "train loop": train_runs[-1]["launches"][kname],
                   "dist": sum(r["launches"][kname] for r in (dist_run, moe_run, *mixer_runs, *serve_runs))}
        rows.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": by_path["lm serve"] + by_path["train"], "max_abs_err": silu_checked["max_abs_err"][kname],
            "launches_by_path": by_path, "bit_exact": silu_checked["max_abs_err"][kname] == 0,
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "library_call": rec["library_call"],
            "launch_floor_ms": rec.get("launch_floor_ms"), "shape": silu_timing[SILU_TIMED[0]]["shape"],
        })
    for kname, (source, replaces) in SOFTPLUS_INFO.items():
        rec = softplus_timing[SOFTPLUS_SHAPES[0][0]][kname]
        by_path = {"lm serve": sum(r["launches"][kname] for r in lm_serves),
                   "train": sum(r["launches"][kname] for r in train_runs[:len(TRAIN_FULL)]),
                   "train loop": train_runs[-1]["launches"][kname],
                   "dist": sum(r["launches"][kname] for r in (dist_run, moe_run, *mixer_runs, *serve_runs))}
        rows.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": by_path["lm serve"] + by_path["train"],
            "max_abs_err": softplus_checked["max_abs_err"][kname], "launches_by_path": by_path,
            "bit_exact": softplus_checked["differ"][kname] == 0, "patterns_checked": softplus_checked["patterns"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "library_call": rec["library_call"],
            "launch_floor_ms": rec.get("launch_floor_ms"),
            "flagged_in_sweep": (softplus_checked["flagged"] or {}).get(kname),
            "shape": softplus_timing[SOFTPLUS_SHAPES[0][0]]["shape"],
        })
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
