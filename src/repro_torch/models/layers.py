"""Transformer building blocks: RMSNorm, RoPE, GQA attention, SwiGLU, MoE.

The port of the JAX package's `repro/models/layers.py`, on plain torch
tensors.  Param trees are plain dicts with the reference's names and
layouts.  Compute runs in bf16 (params are cast at use), reductions in
fp32, with the reference's casts at the same places, so both packages
compute the same function.  All functions are batch-agnostic over leading
dims of `x` (B, S, D).
"""
from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

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


def silu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=F32, device=device)


def rmsnorm(x, scale, eps):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale).to(COMPUTE_DTYPE)


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


def _project_q(p, cfg: ModelConfig, xq):
    q = (xq @ p["wq"].to(COMPUTE_DTYPE)).reshape(*xq.shape[:-1], cfg.num_heads, cfg.hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    return q


def _project_qkv(p, cfg: ModelConfig, xq, xkv):
    kv, hd = cfg.num_kv_heads, cfg.hd
    q = _project_q(p, cfg, xq)
    k = (xkv @ p["wk"].to(COMPUTE_DTYPE)).reshape(*xkv.shape[:-1], kv, hd)
    v = (xkv @ p["wv"].to(COMPUTE_DTYPE)).reshape(*xkv.shape[:-1], kv, hd)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
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


def attention(p, cfg: ModelConfig, x, positions, causal=True, kv=None):
    """Self (kv=None) or cross attention.  Returns (B, S, D)."""
    xkv = kv if kv is not None else x
    q, k, v = _project_qkv(p, cfg, x, xkv)
    if kv is None:  # self-attn: rotary on both
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = _sdpa(q, k, v, cfg, causal=causal and kv is None)
    return out.reshape(*x.shape[:-1], -1) @ p["wo"].to(COMPUTE_DTYPE)


def attention_decode(p, cfg: ModelConfig, x, cache_k, cache_v, pos: int):
    """One-token decode: x (B, 1, D), cache (B, L, KV, hd), pos an int.

    Returns (out, cache_k, cache_v): the caches are written in place at
    `pos` (the reference updates a donated cache functionally)."""
    q, k, v = _project_qkv(p, cfg, x, x)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    b, _, h, hd = q.shape
    kvh = cache_k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, hd)
    scores = torch.einsum("bgrh,bkgh->bgrk", qg, cache_k.to(COMPUTE_DTYPE)).to(F32)
    scores = scores / np.float32(np.sqrt(hd))
    invalid = torch.arange(cache_k.shape[1], device=x.device)[None, None, None, :] > pos
    scores = scores.masked_fill(invalid, -1e30)
    probs = _softmax_bf16(scores)
    out = torch.einsum("bgrk,bkgh->bgrh", probs, cache_v.to(COMPUTE_DTYPE))
    out = out.reshape(b, 1, h * hd) @ p["wo"].to(COMPUTE_DTYPE)
    return out, cache_k, cache_v


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


def mlp(p, x):
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


def _route(logits, e: int, k: int):
    """Softmax router probs, renormalised top-k weights and experts, and the
    Switch-style load-balancing aux loss over the token dims."""
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, k)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    lead = tuple(range(probs.dim() - 1))
    density = torch.nn.functional.one_hot(top_e[..., 0], e).to(F32).mean(dim=lead)
    aux = torch.sum(density * probs.mean(dim=lead)) * e
    return top_w, top_e, aux


def _sum_k(x):
    """bf16 sum over dim -2 with an f32 accumulator, one rounding (jnp's
    `sum` of bf16)."""
    return x.to(F32).sum(dim=-2).to(COMPUTE_DTYPE)


def moe_local(p, cfg: ModelConfig, x, n_blocks: int | None = None):
    """Token-local MoE dispatch (`moe_dispatch="local"`): route within blocks
    of tokens; capacity is per (block, expert).  Every sort and gather is
    block-local."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    nb = n_blocks or min(32, b)
    while t % nb:
        nb //= 2
    tl = t // nb
    cap = int(np.ceil(tl * k / e * cfg.capacity_factor))
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

    h = silu(torch.einsum("becd,edf->becf", buf, p["wg"].to(COMPUTE_DTYPE)))
    h = h * torch.einsum("becd,edf->becf", buf, p["wi"].to(COMPUTE_DTYPE))
    out_buf = torch.einsum("becf,efd->becd", h, p["wo"].to(COMPUTE_DTYPE))

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
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    cap = int(np.ceil(t * k / e * cfg.capacity_factor))
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

    h = silu(torch.einsum("ecd,edf->ecf", buf, p["wg"].to(COMPUTE_DTYPE)))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["wi"].to(COMPUTE_DTYPE))
    out_buf = torch.einsum("ecf,efd->ecd", h, p["wo"].to(COMPUTE_DTYPE))

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
