"""Transformer building blocks: RMSNorm, RoPE, GQA attention, SwiGLU, MoE.

The port of the JAX package's `repro/models/layers.py`, on plain torch
tensors.  Param trees are plain dicts with the reference's names and
layouts.  Compute runs in bf16 (params are cast at use), reductions in
fp32, with the reference's casts at the same places, so both packages
compute the same function.  All functions are batch-agnostic over leading
dims of `x` (B, S, D).

Inside the sharded train step (`distributed.parallel.sharded`) the
functions take local shards and compute their own slice: attention (self
and cross) and the dense MLP tensor-parallel where `model` splits their
heads and hidden dim, MoE expert-parallel over `model` with the routing of
the global batch (capacity, sort order and aux loss over every dp rank's
tokens).  In the sharded serving steps prefill hands back every kv head
for the caches (`attention(..., return_kv=True)`), and decode gathers q,
k and v whole and attends over a cache whose length is split over `model`
with a partial softmax reduced over it (`attention_decode`,
`cross_decode`, `split_softmax`).  Without a plan, or where nothing is
split, they run the single-device code.
"""
from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import parallel as P
from repro_torch.kernels import silu as ksilu

COMPUTE_DTYPE = torch.bfloat16
F32 = torch.float32


@contextlib.contextmanager
def f32_accumulation():
    """bf16 matmuls sum their products in f32, as the reference's do: cuBLAS
    may otherwise reduce split-K partial sums in bf16.  The flag is global,
    so it is set for the duration and restored after (usable as a decorator)."""
    mm = torch.backends.cuda.matmul
    old = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_bf16_reduced_precision_reduction = old


def _he(shape, fan_in, generator, device) -> torch.Tensor:
    """He-normal f32 weights: a standard normal draw over sqrt(fan_in)."""
    return torch.randn(shape, generator=generator, device=device, dtype=F32) / math.sqrt(fan_in)


class _Silu(torch.autograd.Function):
    """`jax.nn.silu` as the reference rounds it, forward and backward
    (`kernels.silu`: the kernels on the card, their plain versions on the
    CPU).  The backward saves only the input and recomputes the logistic."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return ksilu.silu_fwd(x)

    @staticmethod
    def backward(ctx, h):
        (x,) = ctx.saved_tensors
        return ksilu.silu_bwd(x, h)


def silu(x: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Silu.apply(x)
    return ksilu.silu_fwd(x)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=F32, device=device)


def _normed(x, eps):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps)


def rmsnorm(x, scale, eps):
    return (_normed(x, eps) * scale).to(COMPUTE_DTYPE)


class _SharedScale(torch.autograd.Function):
    """`out * scale` for a scale that the heads of `out` (..., H, hd) share,
    its grad summed in one order that no split of the heads changes: each
    head's partial over the leading dims, then the heads, each by one
    `sum` over dim 0 of a tensor whose shape is the same on one device and
    on every rank (a CUDA reduction's order follows its launch shape, and
    so the count of heads it sees).  With `group` the heads are this
    rank's run, `rank` of `ranks` equal runs in rank order: the rank sums
    its heads' products among all the heads' (the others zero), and the
    ranks' partials are gathered, so every rank sums the heads as one
    device does (an all-reduce of each rank's total would round
    otherwise)."""

    @staticmethod
    def forward(ctx, out, scale, group, rank, ranks):
        ctx.save_for_backward(out, scale)
        ctx.group, ctx.rank, ctx.ranks = group, rank, ranks
        return out * scale

    @staticmethod
    def backward(ctx, g):
        out, scale = ctx.saved_tensors
        gs = None
        if ctx.needs_input_grad[1]:
            prod = (g * out).reshape(-1, *out.shape[-2:]).contiguous()
            if ctx.group is None:
                heads = prod.sum(0)
            else:
                n, h, hd = prod.shape
                run = slice(ctx.rank * h, (ctx.rank + 1) * h)
                whole = prod.new_zeros(n, h * ctx.ranks, hd)
                whole[:, run] = prod
                heads = P._ag(whole.sum(0)[run], 0, ctx.group)
            gs = heads.sum(0)
        return g * scale, gs, None, None, None


def head_norm(x, scale, eps, split: bool = False):
    """`rmsnorm` of q or k (..., H, hd) by the weight its heads share (the
    q / k norms), its weight grad by `_SharedScale`; with `split` the heads
    are this rank's run of all of them, split evenly over `model`."""
    if not (torch.is_grad_enabled() and scale.requires_grad):
        return rmsnorm(x, scale, eps)
    plan = P.current() if split else None
    if plan is None or plan.model_dim is None:
        args = (None, 0, 1)
    else:
        args = (plan.group(plan.model_dim), plan.model_rank, plan.model_size)
    return _SharedScale.apply(_normed(x, eps), scale, *args).to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _rope_freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """The rotary frequencies in numpy float32, as the reference computes
    them, once per (half, theta, device)."""
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(np.asarray(freqs, np.float32)).to(device)


def rope(x, positions, theta):
    """x: (..., S, H, hd), positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, theta, x.device)
    angles = positions[..., :, None].to(F32) * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (self / cross), optional qk-norm
# ---------------------------------------------------------------------------


def attn_init(cfg: ModelConfig, lead: tuple, generator, device) -> dict:
    """Attention weights with leading dims `lead` (the stacked reps)."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {
        "wq": _he((*lead, d, h * hd), d, generator, device),
        "wk": _he((*lead, d, kv * hd), d, generator, device),
        "wv": _he((*lead, d, kv * hd), d, generator, device),
        "wo": _he((*lead, h * hd, d), h * hd, generator, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init((*lead, hd), device)
        p["k_norm"] = rmsnorm_init((*lead, hd), device)
    return p


def _whole_proj(x, w, full: int):
    """`x @ w` of all `full` columns: in the sharded step, where `w`'s
    columns are split over `model`, this rank's block, gathered whole
    (replicated over `model`)."""
    if P.model_split(w.shape[-1], full):
        return P.gather_model(P.column_parallel(x, w.to(COMPUTE_DTYPE))[0], -1)
    return x @ w.to(COMPUTE_DTYPE)


def _project_q(p, cfg: ModelConfig, xq):
    q = _whole_proj(xq, p["wq"], cfg.num_heads * cfg.hd).reshape(*xq.shape[:-1], cfg.num_heads, cfg.hd)
    if cfg.qk_norm:
        q = head_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def _project_qkv(p, cfg: ModelConfig, xq, xkv):
    kv, hd = cfg.num_kv_heads, cfg.hd
    q = _project_q(p, cfg, xq)
    k, v = (_whole_proj(xkv, p[w], kv * hd).reshape(*xkv.shape[:-1], kv, hd) for w in ("wk", "wv"))
    if cfg.qk_norm:
        k = head_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _softmax_bf16(scores):
    """Softmax over the last dim in f32, probs cast to bf16 (the reference's
    `jax.nn.softmax(...).astype(bf16)`)."""
    return torch.softmax(scores, dim=-1).to(COMPUTE_DTYPE)


def _sdpa(q, k, v, cfg: ModelConfig, causal: bool, q_offset=0):
    """q: (B,Sq,H,hd) k,v: (B,Sk,KV,hd).  GQA: H = KV * rep.

    The reference's formula, not `scaled_dot_product_attention`: bf16
    scores cast to f32, scaled, the -1e30 mask, f32 softmax, probs in bf16
    for the PV product."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, sq, kvh, rep, hd)
    scores = torch.einsum("bqgrh,bkgh->bgrqk", qg, k).to(F32)
    scores = scores / np.float32(np.sqrt(hd))
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(qpos < kpos, -1e30)
    probs = _softmax_bf16(scores)
    out = torch.einsum("bgrqk,bkgh->bqgrh", probs, v)
    return out.reshape(b, sq, h, hd)


def _heads(y, n: int, hd: int, lo: int, hi: int):
    """Heads [lo, hi) of a projection `y` of `n` heads whose columns are
    split over `model`, for this rank's own compute: gathered over `model`,
    the backward summing the ranks' grads (zero outside their heads)."""
    y = P.gather_model_sum(y, -1)
    return y.reshape(*y.shape[:-1], n, hd)[..., lo:hi, :]


def _attention_tp(p, cfg: ModelConfig, x, positions, causal: bool, kv=None, return_kv: bool = False):
    """Self (kv None) or cross attention with `wq`'s columns (and `wo`'s
    rows) split over `model`, the projections column-parallel.  Where each
    rank holds whole kv groups (`num_kv_heads` divides over `model`), each
    rank attends with its own q heads and the kv heads they use (k / v
    gathered whole, each rank taking its kv heads), `wo` row-parallel;
    otherwise `_attend_units`.  Cross-attention's k / v come from `kv`,
    replicated over `model` like `x`, through its own column-parallel
    projections; no rope, no causal mask.  With `return_kv` (prefill, no
    grad) k is normed and roped over all kv heads, and (out, k, v) of all
    of them come back for the cache."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    m = P.current().model_size
    kv_split = P.model_split(p["wk"].shape[-1], kvh * hd)
    xkv = x if kv is None else kv
    # role tokens_act: x (and kv) replicated over model, into the column-parallel projections
    if kv is None:
        proj = P.column_parallel(x, *(p[w].to(COMPUTE_DTYPE) for w in (("wq", "wk", "wv") if kv_split else ("wq",))))
        q, kv_proj = proj[0], proj[1:]
    else:
        q = P.column_parallel(x, p["wq"].to(COMPUTE_DTYPE))[0]
        # one projection a call: `kv` takes each one's grad as on one device, where it sums the
        # grads of every cross layer's wk and wv in the order they arrive
        kv_proj = tuple(P.column_parallel(kv, p[w].to(COMPUTE_DTYPE))[0] for w in ("wk", "wv")) if kv_split else ()
    if kvh % m:
        return _attend_units(p, cfg, q, kv_proj, x, xkv, positions, causal and kv is None, kv is None, return_kv)
    width = h // m  # this rank's q heads, whole kv groups (and kv_split)
    klo = P.current().model_rank * width // (h // kvh)
    khi = klo + kvh // m
    q = q.reshape(*x.shape[:-1], width, hd)
    if return_kv:  # all kv heads, gathered whole; this rank's taken after their norm and rope
        k_all, v_all = (P.gather_model(y, -1).reshape(*xkv.shape[:-1], kvh, hd) for y in kv_proj)
        if cfg.qk_norm:
            q = head_norm(q, p["q_norm"], cfg.norm_eps)
            k_all = head_norm(k_all, p["k_norm"], cfg.norm_eps)
        if kv is None:
            q = rope(q, positions, cfg.rope_theta)
            k_all = rope(k_all, positions, cfg.rope_theta)
        k, v = k_all[..., klo:khi, :], v_all[..., klo:khi, :]
    else:
        k, v = (_heads(y, kvh, hd, klo, khi) for y in kv_proj)
        if cfg.qk_norm:
            q = head_norm(q, p["q_norm"], cfg.norm_eps, split=True)
            k = head_norm(k, p["k_norm"], cfg.norm_eps, split=True)
        if kv is None:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
    out = _sdpa(q, k, v, cfg, causal=causal and kv is None).reshape(*x.shape[:-1], width * hd)
    out = P.row_parallel(out, p["wo"].to(COMPUTE_DTYPE))
    return (out, k_all, v_all) if return_kv else out


def _attend_units(p, cfg: ModelConfig, q, kv_proj, x, xkv, positions, causal: bool, self_attn: bool,
                  return_kv: bool):
    """`_attention_tp` where the `model` split cuts a q head or spreads a kv
    group's q heads over ranks, every element of the output and of every
    grad computed whole on one rank, as on one device.  q (and k / v where
    their columns split; else their projections replicated) gathered whole
    (`gather_model`: the backward takes the rank's chunk of a whole grad);
    qk-norm and rope replicated over all heads.  The unit of attention is
    one batch row's kv group (its k, its v and its `rep` q heads): the
    B x KV units are dealt out over `model` in runs (`split_to_model`,
    padded where they do not divide, so a rank may hold none), each
    attended on its rank, and their outputs gathered whole (`gather_model`)
    into the row-parallel `wo`, which takes them whole.  Nothing is summed
    over `model` in the backward."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    rep = h // kvh
    q = P.gather_model(q, -1).reshape(*x.shape[:-1], h, hd)
    ys = (P.gather_model(y, -1) for y in kv_proj) if kv_proj else (xkv @ p[w].to(COMPUTE_DTYPE) for w in ("wk", "wv"))
    k, v = (y.reshape(*xkv.shape[:-1], kvh, hd) for y in ys)
    if cfg.qk_norm:
        q = head_norm(q, p["q_norm"], cfg.norm_eps)
        k = head_norm(k, p["k_norm"], cfg.norm_eps)
    if self_attn:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    b, sq, sk = x.shape[0], x.shape[1], xkv.shape[1]
    units = b * kvh  # (row, group), row-major
    qu = P.split_to_model(q.reshape(b, sq, kvh, rep, hd).transpose(1, 2).reshape(units, sq, rep, hd), 0)
    ku, vu = (P.split_to_model(t.transpose(1, 2).reshape(units, sk, 1, hd), 0) for t in (k, v))
    out = P.gather_model(_sdpa(qu, ku, vu, cfg, causal=causal), 0, units)
    out = out.reshape(b, kvh, sq, rep * hd).transpose(1, 2).reshape(b, sq, h * hd)
    out = P.row_parallel(out, p["wo"].to(COMPUTE_DTYPE), whole=True)
    return (out, k, v) if return_kv else out


def attention(p, cfg: ModelConfig, x, positions, causal=True, kv=None, return_kv: bool = False):
    """Self (kv=None) or cross attention.  Returns (B, S, D), or with
    `return_kv` (out, k, v): k / v (B, S_kv, KV, hd) of all kv heads as the
    cache holds them (k normed and, for self-attention, roped)."""
    if P.model_split(p["wq"].shape[-1], cfg.num_heads * cfg.hd):
        return _attention_tp(p, cfg, x, positions, causal, kv, return_kv)
    xkv = kv if kv is not None else x
    q, k, v = _project_qkv(p, cfg, x, xkv)
    if kv is None:  # self-attn: rotary on both
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = _sdpa(q, k, v, cfg, causal=causal and kv is None)
    out = out.reshape(*x.shape[:-1], -1) @ p["wo"].to(COMPUTE_DTYPE)
    return (out, k, v) if return_kv else out


# ---------------------------------------------------------------------------
# one-token decode; in the sharded serving step over a cache whose length
# is split over `model`
# ---------------------------------------------------------------------------


def _out_proj(p, cfg: ModelConfig, out):
    """`out` (all heads, replicated) @ `wo`: row-parallel where `wo`'s rows
    are split over `model`."""
    w = p["wo"].to(COMPUTE_DTYPE)
    if P.model_split(w.shape[0], cfg.num_heads * cfg.hd):
        return P.row_parallel(out, w, whole=True)
    return out @ w


def split_softmax(scores):
    """Softmax over the last dim of `scores` (f32), whose columns are split
    over `model`, probs in bf16: the max and the sum of exps all-reduced
    over `model`, the probs normalised before the cast (the reference's
    `jax.nn.softmax(...).astype(bf16)` of the whole row)."""
    m = P.all_reduce_model(torch.amax(scores, dim=-1, keepdim=True), "max")
    e = torch.exp(scores - m)
    z = P.all_reduce_model(torch.sum(e, dim=-1, keepdim=True))
    return (e / z).to(COMPUTE_DTYPE)


def _attend_one(q, cache_k, cache_v, split: bool, valid=None):
    """q (B, 1, H, hd) over a cache (B, L, KV, hd), at the positions where
    `valid` (1, 1, 1, L) holds (all without it); with `split`, the cache holds this
    rank's slice of the length: `split_softmax`, each rank's PV in f32,
    summed over `model`.  Returns (B, 1, H x hd) bf16."""
    b, _, h, hd = q.shape
    kvh = cache_k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, hd)
    scores = torch.einsum("bgrh,bkgh->bgrk", qg, cache_k.to(COMPUTE_DTYPE)).to(F32)
    scores = scores / np.float32(np.sqrt(hd))
    if valid is not None:
        scores = scores.masked_fill(~valid, -1e30)
    if split:  # a rank whose positions are all masked adds zeros (exp(-1e30 - max) = 0)
        out = torch.einsum("bgrk,bkgh->bgrh", split_softmax(scores).to(F32), cache_v.to(F32))
        out = P.all_reduce_model(out).to(COMPUTE_DTYPE)
    else:
        out = torch.einsum("bgrk,bkgh->bgrh", _softmax_bf16(scores), cache_v.to(COMPUTE_DTYPE))
    return out.reshape(b, 1, h * hd)


def attention_decode(p, cfg: ModelConfig, x, cache_k, cache_v, pos: int, split: bool = False):
    """One-token decode: x (B, 1, D), cache (B, L, KV, hd), pos an int.

    Returns (out, cache_k, cache_v): the caches are written in place at
    `pos` (the reference updates a donated cache functionally).  In the
    sharded serving step q, k and v are gathered whole over `model`, and
    with `split` the cache holds this rank's slice [r L, (r + 1) L) of the
    length: the rank that holds `pos` writes it, each rank scores its
    slice, and the softmax and PV are reduced over `model`; `wo`
    row-parallel."""
    q, k, v = _project_qkv(p, cfg, x, x)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    n = cache_k.shape[1]
    start = P.current().model_rank * n if split else 0
    if start <= pos < start + n:
        cache_k[:, pos - start] = k[:, 0].to(cache_k.dtype)
        cache_v[:, pos - start] = v[:, 0].to(cache_v.dtype)
    valid = torch.arange(start, start + n, device=x.device)[None, None, None, :] <= pos
    out = _attend_one(q, cache_k, cache_v, split, valid)
    return _out_proj(p, cfg, out), cache_k, cache_v


def cross_decode(p, cfg: ModelConfig, x, cache_k, cache_v, split: bool = False):
    """One-token cross-attention over the precomputed (B, S_enc, KV, hd)
    caches; with `split`, this rank's slice of S_enc (`attention_decode`)."""
    q = _project_q(p, cfg, x)
    if split:
        out = _attend_one(q, cache_k, cache_v, True)
    else:
        out = _sdpa(q, cache_k, cache_v, cfg, causal=False).reshape(x.shape[0], 1, -1)
    return _out_proj(p, cfg, out)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_init(cfg: ModelConfig, lead: tuple, generator, device, d_ff=None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi": _he((*lead, d, f), d, generator, device),
        "wg": _he((*lead, d, f), d, generator, device),
        "wo": _he((*lead, f, d), f, generator, device),
    }


def mlp(p, x, d_ff: int | None = None):
    """SwiGLU.  With `d_ff` (the full hidden width) and `wi` / `wg` split over
    `model`, column-parallel up-projections and a row-parallel `wo`."""
    if d_ff is not None and P.model_split(p["wi"].shape[-1], d_ff):
        g, i = P.column_parallel(x, p["wg"].to(COMPUTE_DTYPE), p["wi"].to(COMPUTE_DTYPE))  # role tokens_act
        return P.row_parallel(silu(g) * i, p["wo"].to(COMPUTE_DTYPE))
    h = silu(x @ p["wg"].to(COMPUTE_DTYPE)) * (x @ p["wi"].to(COMPUTE_DTYPE))
    return h @ p["wo"].to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# MoE: top-k routing, sort-based capacity dispatch
# ---------------------------------------------------------------------------


def moe_init(cfg: ModelConfig, lead: tuple, generator, device) -> dict:
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    e = cfg.num_experts
    return {
        "router": _he((*lead, d, e), d, generator, device),
        "wi": _he((*lead, e, d, f), d, generator, device),
        "wg": _he((*lead, e, d, f), d, generator, device),
        "wo": _he((*lead, e, f, d), f, generator, device),
    }


def _top_k(probs, k):
    """`jax.lax.top_k` along the last dim: descending, ties to the lower
    index (a stable descending sort; `torch.topk` promises no tie order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(logits, e: int, k: int, dp: bool = False):
    """Softmax router probs, renormalised top-k weights and experts, and the
    Switch-style load-balancing aux loss over the token dims; with `dp`,
    its means over every dp rank's tokens (the global batch)."""
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, k)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    lead = tuple(range(probs.dim() - 1))
    first = torch.nn.functional.one_hot(top_e[..., 0], e).to(F32)
    if dp:
        n = probs[..., 0].numel() * P.current().dp_size
        density = P.all_reduce_dp(first.sum(dim=lead)) / n
        aux = torch.sum(density * (P.all_reduce_dp(probs.sum(dim=lead)) / n)) * e
    else:
        aux = torch.sum(first.mean(dim=lead) * probs.mean(dim=lead)) * e
    return top_w, top_e, aux


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Per-expert capacity for `tokens` routed together."""
    return int(np.ceil(tokens * cfg.experts_per_token / cfg.num_experts * cfg.capacity_factor))


def _ep(p, cfg: ModelConfig):
    """(sharded, first expert, local experts): whether this MoE runs the
    sharded form (dp ranks route together, or experts split over `model`),
    and the expert range this rank computes."""
    plan, el = P.current(), p["wi"].shape[-3]
    if plan is None:
        return False, 0, el
    split = P.model_split(el, cfg.num_experts)
    return plan.dp_size > 1 or split, plan.model_rank * el if split else 0, el


def _experts(p, buf, eq: str):
    """SwiGLU over the expert dim of `buf` (`eq` its einsum lead, e.g. "ec")."""
    h = silu(torch.einsum(f"{eq}d,edf->{eq}f", buf, p["wg"].to(COMPUTE_DTYPE)))
    h = h * torch.einsum(f"{eq}d,edf->{eq}f", buf, p["wi"].to(COMPUTE_DTYPE))  # role moe_hidden
    return torch.einsum(f"{eq}f,efd->{eq}d", h, p["wo"].to(COMPUTE_DTYPE))


def _sum_k(x):
    """bf16 sum over dim -2 with an f32 accumulator, one rounding (jnp's
    `sum` of bf16)."""
    return x.to(F32).sum(dim=-2).to(COMPUTE_DTYPE)


def moe_local(p, cfg: ModelConfig, x, n_blocks: int | None = None):
    """Token-local MoE dispatch (`moe_dispatch="local"`): route within blocks
    of tokens; capacity is per (block, expert).  Every sort and gather is
    block-local."""
    sharded, e0, el = _ep(p, cfg)
    if sharded:
        return _moe_local_sharded(p, cfg, x, e0, el, n_blocks)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    nb = n_blocks or min(32, b)
    while t % nb:
        nb //= 2
    tl = t // nb
    cap = capacity(tl, cfg)
    xt = x.reshape(nb, tl, d)
    dev = x.device

    logits = torch.einsum("btd,de->bte", xt, p["router"].to(COMPUTE_DTYPE)).to(F32)
    top_w, top_e, aux = _route(logits, e, k)  # (nb, tl, k)

    flat_e = top_e.reshape(nb, tl * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    arange_e = torch.arange(e, device=dev, dtype=sorted_e.dtype).expand(nb, e).contiguous()
    seg_start = torch.searchsorted(sorted_e, arange_e)  # (nb, e), side="left"
    seg_end = torch.cat([seg_start[:, 1:], seg_start.new_full((nb, 1), tl * k)], dim=1)
    pos_in_e = torch.arange(tl * k, device=dev)[None] - torch.gather(seg_start, 1, sorted_e)
    keep = pos_in_e < cap
    tok_of = order // k

    # dispatch: compose indices in int space -> one d-wide gather
    gidx = seg_start[:, :, None] + torch.arange(cap, device=dev)[None, None, :]  # (nb, e, cap)
    valid = gidx < seg_end[:, :, None]
    gidx = torch.clamp(gidx, max=tl * k - 1).reshape(nb, e * cap)
    comp_idx = torch.gather(tok_of, 1, gidx)  # slot -> source token
    buf = torch.gather(xt.to(COMPUTE_DTYPE), 1, comp_idx[..., None].expand(nb, e * cap, d))
    buf = torch.where(valid.reshape(nb, e * cap, 1), buf, 0.0)
    buf = buf.reshape(nb, e, cap, d)

    out_buf = _experts(p, buf, "bec")

    # combine: token-major slot ids (int gathers) -> one d-wide gather
    flat_out = out_buf.reshape(nb, e * cap, d)
    slot = torch.where(keep, sorted_e * cap + pos_in_e, torch.zeros_like(pos_in_e))
    inv_order = torch.argsort(order, dim=-1, stable=True)
    slot_tm = torch.gather(slot, 1, inv_order)
    keep_tm = torch.gather(keep, 1, inv_order)
    gathered = torch.gather(flat_out, 1, slot_tm[..., None].expand(nb, tl * k, d))
    gathered = torch.where(keep_tm[..., None], gathered, 0.0)
    w_tm = top_w.reshape(nb, tl * k).to(COMPUTE_DTYPE)
    out = _sum_k((gathered * w_tm[..., None]).reshape(nb, tl, k, d))
    return out.reshape(b, s, d), aux


def moe(p, cfg: ModelConfig, x):
    """x: (B, S, D) -> (B, S, D), plus aux load-balancing loss.

    Sort-based dispatch with per-expert capacity C = k*T/E * cap_factor:
    assignments are sorted by expert id (stable), each expert takes its
    first C tokens (standard dropping MoE).  `cfg.moe_dispatch`:
      "scatter" - scatter into the (E*C + 1)-row buffer (the spare last row
          takes the dropped assignments), combine by adding each token's
          contributions in the order the reference's scatter-add applies
          them (sorted-assignment order, i.e. by expert id), one bf16
          rounding per add, without atomics;
      "gather"  - per-expert segment gathers, combine through the inverse
          permutation and a sum over k;
      "local"   - `moe_local`.
    """
    if cfg.moe_dispatch == "local":
        return moe_local(p, cfg, x)
    sharded, e0, el = _ep(p, cfg)
    if sharded:
        return _moe_sharded(p, cfg, x, e0, el)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    cap = capacity(t, cfg)
    xt = x.reshape(t, d)
    dev = x.device

    logits = (xt @ p["router"].to(COMPUTE_DTYPE)).to(F32)
    top_w, top_e, aux = _route(logits, e, k)  # (T, k)

    flat_e = top_e.reshape(-1)  # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(e, device=dev, dtype=sorted_e.dtype))
    pos_in_e = torch.arange(t * k, device=dev) - seg_start[sorted_e]
    keep = pos_in_e < cap
    tok_of = order // k  # token index per sorted assignment

    if cfg.moe_dispatch == "gather":
        sorted_tok = xt[tok_of].to(COMPUTE_DTYPE)  # (T*k, d)
        seg_end = torch.cat([seg_start[1:], seg_start.new_full((1,), t * k)])
        gidx = seg_start[:, None] + torch.arange(cap, device=dev)[None, :]  # (e, cap)
        valid = gidx < seg_end[:, None]
        gidx = torch.clamp(gidx, max=t * k - 1)
        buf = torch.where(valid[..., None], sorted_tok[gidx], 0.0)
    else:  # scatter baseline
        dest = torch.where(keep, sorted_e * cap + pos_in_e, torch.full_like(pos_in_e, e * cap))
        buf = torch.zeros((e * cap + 1, d), dtype=COMPUTE_DTYPE, device=dev)
        buf[dest] = xt[tok_of].to(COMPUTE_DTYPE)
        buf = buf[: e * cap].reshape(e, cap, d)

    out_buf = _experts(p, buf, "ec")

    flat_out = out_buf.reshape(e * cap, d)
    slot = torch.where(keep, sorted_e * cap + pos_in_e, torch.zeros_like(pos_in_e))
    gathered = torch.where(keep[:, None], flat_out[slot], 0.0)
    w_sorted = top_w.reshape(-1)[order].to(COMPUTE_DTYPE)
    contrib = gathered * w_sorted[:, None]  # (T*k, d), sorted-assignment order
    inv_order = torch.argsort(order, stable=True)
    if cfg.moe_dispatch == "gather":  # combine = inverse perm + reshape-sum
        return _sum_k(contrib[inv_order].reshape(t, k, d)).reshape(b, s, d), aux
    # scatter-add: token t's k contributions added to zeros in the order the
    # sorted assignments list them, each add rounded to bf16
    rank = inv_order.reshape(t, k)  # sorted position of each assignment
    by_rank = torch.argsort(rank, dim=1, stable=True)
    parts = contrib[torch.gather(rank, 1, by_rank)]  # (T, k, d), in scatter order
    out = torch.zeros((t, d), dtype=COMPUTE_DTYPE, device=dev)
    for j in range(k):
        out = out + parts[:, j]
    return out.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# MoE in the sharded step: global-batch routing, experts over model
# ---------------------------------------------------------------------------


def _combine_scatter(contrib, rank, k: int):
    """The scatter-add combine of `contrib` (T, k, d), token-major: each
    token's contributions added to zeros in the order of their sorted
    positions `rank` (T, k), one bf16 rounding per add."""
    by_rank = torch.argsort(rank, dim=1, stable=True)
    parts = torch.gather(contrib, 1, by_rank[..., None].expand(contrib.shape))
    out = torch.zeros_like(parts[:, 0])
    for j in range(k):
        out = out + parts[:, j]
    return out


def _moe_sharded(p, cfg: ModelConfig, x, e0: int, el: int):
    """`moe` on this dp rank's tokens with the routing of the global batch:
    capacity from the global token count, the top-k choices all-gathered
    over dp and sorted as one (so the same assignments are kept and each
    keeps its slot), the aux loss from global means.  This rank computes
    experts [e0, e0 + el) on its block of the capacity slots: it fills the
    slots whose source token it holds and reduce-scatters the (el, cap, d)
    buffer over dp (each slot has one source, so the sum is exact), runs
    the experts, all-gathers their outputs back, takes its own tokens'
    slots and sums each (token, k) entry over `model` (one nonzero owner),
    then combines as the reference does."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    plan = P.current()
    dp, r = plan.dp_size, plan.dp_rank
    tl = b * s
    t = tl * dp  # the global batch's tokens
    cap = capacity(t, cfg)
    capp = -(-cap // dp) * dp  # padded to whole dp blocks: spare slots stay zero and are never read
    xt = x.reshape(tl, d)
    dev = x.device

    logits = (xt @ p["router"].to(COMPUTE_DTYPE)).to(F32)
    top_w, top_e, aux = _route(logits, e, k, dp=dp > 1)  # (tl, k)

    flat_e = P.gather_dp_ints(top_e).reshape(-1)  # (t*k,), global token order
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(e, device=dev, dtype=sorted_e.dtype))
    seg_end = torch.cat([seg_start[1:], seg_start.new_full((1,), t * k)])
    pos_in_e = torch.arange(t * k, device=dev) - seg_start[sorted_e]
    keep = pos_in_e < cap
    tok_of = order // k

    # dispatch: my experts' slots whose source token is mine, then over dp
    gidx = seg_start[e0:e0 + el, None] + torch.arange(capp, device=dev)[None, :]  # (el, capp)
    valid = (gidx < seg_end[e0:e0 + el, None]) & (torch.arange(capp, device=dev) < cap)
    src = tok_of[torch.clamp(gidx, max=t * k - 1)] - r * tl
    mine = valid & (src >= 0) & (src < tl)
    xs = P.copy_to_model(xt) if el < e else xt
    buf = xs.to(COMPUTE_DTYPE)[torch.clamp(src, 0, tl - 1)]
    buf = torch.where(mine[..., None], buf, 0.0)
    buf = P.reduce_scatter_dp(buf, 1)  # role moe_buffer: experts over model, capacity over dp
    out_buf = P.gather_dp(_experts(p, buf, "ec"), 1)  # role moe_buffer

    # combine: my tokens' assignments, token-major
    spos = torch.argsort(order, stable=True)[r * tl * k:(r + 1) * tl * k]  # their sorted positions
    se = sorted_e[spos]
    here = keep[spos] & (se >= e0) & (se < e0 + el)
    slot = torch.where(here, (se - e0) * capp + pos_in_e[spos], torch.zeros_like(spos))
    gathered = torch.where(here[:, None], out_buf.reshape(el * capp, d)[slot], 0.0)
    if el < e:
        gathered = P.reduce_from_model(gathered)  # each (token, k) entry has one nonzero owner
    contrib = (gathered * top_w.reshape(-1).to(COMPUTE_DTYPE)[:, None]).reshape(tl, k, d)
    if cfg.moe_dispatch == "gather":
        return _sum_k(contrib).reshape(b, s, d), aux
    return _combine_scatter(contrib, spos.reshape(tl, k), k).reshape(b, s, d), aux


def _moe_local_sharded(p, cfg: ModelConfig, x, e0: int, el: int, n_blocks: int | None):
    """`moe_local` on this dp rank's tokens: the blocks of the global batch
    (`nb` from its batch, as the reference picks it); where the dp ranks
    hold whole blocks, each rank its own, so the routing and dispatch need
    no dp traffic; where a block straddles ranks (the dp size does not
    divide `nb`), the tokens are all-gathered over dp and each rank runs
    the blocks that hold its tokens, keeping its tokens' outputs.  The aux
    loss from global means over each rank's own tokens; experts [e0, e0 +
    el) here, each (token, k) entry summed over `model`."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    plan = P.current()
    dp = plan.dp_size
    mine = b * s
    t = mine * dp
    nb = n_blocks or min(32, b * dp)
    while t % nb:
        nb //= 2
    tl = t // nb
    cap = capacity(tl, cfg)
    straddle = nb % dp != 0
    if not straddle:  # role moe_tokens_local: my blocks
        nbl, first = nb // dp, 0
        xt = x.reshape(nbl, tl, d)
    else:  # the blocks that hold my tokens [start, start + mine), from every rank's tokens
        start = plan.dp_rank * mine
        j0, j1 = start // tl, -(-(start + mine) // tl)
        nbl, first = j1 - j0, start - j0 * tl
        xt = P.gather_dp(x.reshape(mine, d), 0)[j0 * tl:j1 * tl].reshape(nbl, tl, d)
    dev = x.device

    logits = torch.einsum("btd,de->bte", xt, p["router"].to(COMPUTE_DTYPE)).to(F32)
    top_w, top_e, aux = _route(logits, e, k, dp=dp > 1 and not straddle)
    if straddle:  # the aux means over my own tokens
        aux = _route(logits.reshape(nbl * tl, e)[first:first + mine], e, k, dp=True)[2]

    flat_e = top_e.reshape(nbl, tl * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    arange_e = torch.arange(e, device=dev, dtype=sorted_e.dtype).expand(nbl, e).contiguous()
    seg_start = torch.searchsorted(sorted_e, arange_e)
    seg_end = torch.cat([seg_start[:, 1:], seg_start.new_full((nbl, 1), tl * k)], dim=1)
    pos_in_e = torch.arange(tl * k, device=dev)[None] - torch.gather(seg_start, 1, sorted_e)
    keep = pos_in_e < cap
    tok_of = order // k

    gidx = seg_start[:, e0:e0 + el, None] + torch.arange(cap, device=dev)[None, None, :]  # (nbl, el, cap)
    valid = gidx < seg_end[:, e0:e0 + el, None]
    gidx = torch.clamp(gidx, max=tl * k - 1).reshape(nbl, el * cap)
    comp_idx = torch.gather(tok_of, 1, gidx)
    xs = P.copy_to_model(xt) if el < e else xt
    buf = torch.gather(xs.to(COMPUTE_DTYPE), 1, comp_idx[..., None].expand(nbl, el * cap, d))
    buf = torch.where(valid.reshape(nbl, el * cap, 1), buf, 0.0).reshape(nbl, el, cap, d)
    out_buf = _experts(p, buf, "bec")  # role moe_buffer_local: blocks over dp, experts over model

    flat_out = out_buf.reshape(nbl, el * cap, d)
    here = keep & (sorted_e >= e0) & (sorted_e < e0 + el)
    slot = torch.where(here, (sorted_e - e0) * cap + pos_in_e, torch.zeros_like(pos_in_e))
    inv_order = torch.argsort(order, dim=-1, stable=True)
    slot_tm = torch.gather(slot, 1, inv_order)
    here_tm = torch.gather(here, 1, inv_order)
    gathered = torch.gather(flat_out, 1, slot_tm[..., None].expand(nbl, tl * k, d))
    gathered = torch.where(here_tm[..., None], gathered, 0.0)
    if el < e:
        gathered = P.reduce_from_model(gathered)  # each (token, k) entry has one nonzero owner
    w_tm = top_w.reshape(nbl, tl * k).to(COMPUTE_DTYPE)
    out = _sum_k((gathered * w_tm[..., None]).reshape(nbl, tl, k, d))
    return out.reshape(nbl * tl, d)[first:first + mine].reshape(b, s, d), aux
