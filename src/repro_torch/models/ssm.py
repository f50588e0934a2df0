"""Mamba2 / SSD (state-space duality) blocks, chunked-scan form and
O(1)-state decode form: the port of the JAX package's `repro/models/ssm.py`.

Per chunk a dense (L x L) decay-masked attention-like product, plus an
inter-chunk state recurrence (the reference's `lax.scan` over chunks, here
a loop that emits the state entering each chunk).

Shapes: x (B, S, H, P) heads x head_dim, B/C (B, S, G, N) groups x state,
dt (B, S, H), A (H,) negative decay rates.

Inside the sharded train step (`distributed.parallel.sharded`) the mixer
takes its model shards (the reference's rules: `in_proj` columns, `conv_w`
channels, `a_log` / `skip_d` / `dt_bias` heads, `out_proj` rows) and each
rank computes the SSD of its own heads (`mamba_forward`); in the sharded
serving steps each rank also steps its own heads' state (`mamba_decode`).
"""
from __future__ import annotations

import itertools
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import parallel as P
from repro_torch.models.layers import COMPUTE_DTYPE, F32, _he, rmsnorm, rmsnorm_init, silu

#: The mixer's leaves that the sharded step gathers whole over `model`
#: (`mamba_forward`): the depthwise conv's taps, W x (d_inner + 2 G N).
MODEL_GATHERED = ("conv_w",)

# ---------------------------------------------------------------------------
# three-operand contractions in the reference's order
# ---------------------------------------------------------------------------


def _size(idx, sizes) -> int:
    return math.prod(sizes[c] for c in idx)


def contraction_order(sub: str, shapes) -> tuple[int, int]:
    """The pair of operands `jnp.einsum` contracts first in the
    three-operand `sub` at `shapes`.  `jnp.einsum`'s default
    `optimize="auto"` takes opt_einsum's `optimal` path for three operands:
    a depth-first search over pairwise contractions for the fewest flops,
    the first of equal ones, with a cache of pair costs keyed by the two
    operands' index sets.  The cache is kept here as it is there, since it
    decides the order: a second-level contraction whose index sets equal a
    first-level pair's reuses that pair's cost."""
    ins, out = sub.split("->")
    terms = tuple(frozenset(t) for t in ins.split(","))
    sizes = {c: n for t, shape in zip(ins.split(","), shapes) for c, n in zip(t, shape)}
    output = frozenset(out)
    best = {"flops": math.inf, "path": None}
    cache: dict = {}

    def pair(inputs, remaining, i, j):
        k1, k2 = inputs[i], inputs[j]
        keep = output.union(*(inputs[r] for r in remaining - {i, j}))
        either = k1 | k2
        return either & keep, _size(either, sizes) * (1 + bool((k1 & k2) - keep))

    def search(path, remaining, inputs, flops):
        if len(remaining) == 1:
            best["flops"], best["path"] = flops, path
            return
        for i, j in itertools.combinations(sorted(remaining), 2):
            key = (inputs[i], inputs[j])
            if key not in cache:
                cache[key] = pair(inputs, remaining, i, j)
            k12, cost = cache[key]
            if flops + cost >= best["flops"]:
                continue
            search(path + ((i, j),), remaining - {i, j} | {len(inputs)}, inputs + (k12,), flops + cost)

    search((), frozenset(range(len(terms))), terms, 0)
    return best["path"][0]


def einsum3(sub: str, *ops: torch.Tensor) -> torch.Tensor:
    """A three-operand einsum as two pairwise bf16 contractions, in
    `contraction_order`: the intermediate rounds to bf16 where the
    reference's does."""
    ins, out = sub.split("->")
    terms = ins.split(",")
    i, j = contraction_order(sub, [o.shape for o in ops])
    o = 3 - i - j
    keep = set(out) | set(terms[o])
    mid = "".join(c for c in dict.fromkeys(terms[i] + terms[j]) if c in keep)
    x = torch.einsum(f"{terms[i]},{terms[j]}->{mid}", ops[i], ops[j])
    return torch.einsum(f"{mid},{terms[o]}->{out}", x, ops[o])


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


class _Broadcast(torch.autograd.Function):
    """`v` expanded to `shape`.  The backward sums the grad over the
    broadcast dims with them made innermost and contiguous, so that each
    element's sum runs over one contiguous row (a broadcast's own backward
    reduces over outer dims in an order that depends on the size of the
    inner ones).  A CUDA reduction splits its rows over threads and blocks
    by the number of rows, so with `place` = (offset, total) a 1-d `v`,
    this rank's run of a vector of `total` (a rank of the sharded step holds
    H / model heads), sums its rows at their own place among `total` rows,
    the others zero: each row as the whole vector's would be, on any
    device."""

    @staticmethod
    def forward(ctx, v, shape, place):
        ctx.vshape, ctx.place = v.shape, place
        return v.expand(shape)

    @staticmethod
    def backward(ctx, g):
        vs = (1,) * (g.dim() - len(ctx.vshape)) + tuple(ctx.vshape)
        red = [i for i in range(g.dim()) if vs[i] == 1 and g.shape[i] != 1]
        keep = [i for i in range(g.dim()) if i not in red]
        rows = g.permute(keep + red)
        if ctx.place is None:
            out = rows.contiguous().reshape(*(g.shape[i] for i in keep), -1).sum(-1)
        else:
            (offset, total), n = ctx.place, ctx.vshape[0]
            whole = g.new_zeros(total, math.prod(g.shape[i] for i in red))
            whole[offset:offset + n] = rows.reshape(n, -1)
            out = whole.sum(-1)[offset:offset + n]
        return out.reshape(ctx.vshape), None, None


def _bcast(v, like, place=None):
    return _Broadcast.apply(v, like.shape, place)


def _segsum_decay(a_cs):
    """L[i, j] = exp(a_cs[i] - a_cs[j]) for i >= j else 0.  a_cs: (..., L).

    The mask is applied before `exp`, as -inf: above the diagonal the
    argument is a sum of up to L - 1 positive steps and overflows to inf
    at the published chunk of 256, and the backward of a mask applied after
    `exp` multiplies that inf by 0 (the reference's form, NaN grads).  The
    forward is that of the mask after `exp` bit for bit (exp(-inf) = 0)."""
    li = a_cs[..., :, None]
    lj = a_cs[..., None, :]
    n = a_cs.shape[-1]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=a_cs.device))
    return torch.exp(torch.where(mask, li - lj, -torch.inf))


def _chunk_scan(init_state, chunk_states, a_total):
    """The inter-chunk recurrence over dim 1 of `chunk_states` (b, c, ...)
    and `a_total` (b, c, h-like): returns (final state, the state entering
    each chunk, stacked on dim 1)."""
    state = init_state
    prev = []
    for c in range(chunk_states.shape[1]):
        prev.append(state)
        decay = torch.exp(a_total[:, c])[..., None, None].to(COMPUTE_DTYPE)
        state = state * decay + chunk_states[:, c]
    return state, torch.stack(prev, dim=1)


def ssd_chunked_grouped(xb, dA, Bg, Cg, chunk: int, init_state=None):
    """Group-factored chunked SSD (`cfg.ssm_impl == "grouped"`).

    xb: (B,S,H,P); dA: (B,S,H); Bg/Cg: (B,S,G,N) kept at group rank: the
    C·B^T score matrices are computed once per group and shared by its H/G
    heads; the decay mask is cast to bf16 before its product."""
    b, s, h, p = xb.shape
    g = Bg.shape[2]
    n = Bg.shape[-1]
    hh = h // g
    nc = s // chunk
    xc = xb.reshape(b, nc, chunk, g, hh, p)
    dAc = dA.reshape(b, nc, chunk, g, hh).to(F32)
    Bc = Bg.reshape(b, nc, chunk, g, n)
    Cc = Cg.reshape(b, nc, chunk, g, n)

    a_cs = torch.cumsum(dAc, dim=2)  # (b,c,l,g,hh)
    a_total = a_cs[:, :, -1]  # (b,c,g,hh)

    scores = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)  # (b,c,g,l,s)
    a_sw = torch.movedim(a_cs, 2, -1)  # (b,c,g,hh,l)
    L = _segsum_decay(a_sw).to(COMPUTE_DTYPE)  # (b,c,g,hh,l,s)
    y_diag = einsum3("bcgls,bcghls,bcsghp->bclghp", scores, L, xc)

    decay_to_end = torch.exp(_bcast(a_total[:, :, None], a_cs) - a_cs).to(COMPUTE_DTYPE)  # (b,c,l,g,hh)
    chunk_states = einsum3("bclgn,bclgh,bclghp->bcghpn", Bc, decay_to_end, xc)

    if init_state is None:
        init_state = torch.zeros((b, g, hh, p, n), dtype=COMPUTE_DTYPE, device=xb.device)
    elif init_state.dim() == 4:  # (b,h,p,n) cache layout
        init_state = init_state.reshape(b, g, hh, p, n)

    final_state, prev_states = _chunk_scan(init_state, chunk_states, a_total)
    state_decay = torch.exp(a_cs).to(COMPUTE_DTYPE)  # (b,c,l,g,hh)
    y_off = einsum3("bclgn,bcghpn,bclgh->bclghp", Cc, prev_states, state_decay)

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, final_state.reshape(b, h, p, n)


def ssd_chunked(xb, dA, Bh, Ch, chunk: int, init_state=None):
    """Chunked SSD scan.

    xb: (B,S,H,P) dt-scaled inputs; dA: (B,S,H); Bh/Ch: (B,S,H,N)
    Returns (y (B,S,H,P), final_state (B,H,P,N)).
    """
    b, s, h, p = xb.shape
    n = Bh.shape[-1]
    nc = s // chunk
    xc = xb.reshape(b, nc, chunk, h, p)
    dAc = dA.reshape(b, nc, chunk, h).to(F32)
    Bc = Bh.reshape(b, nc, chunk, h, n)
    Cc = Ch.reshape(b, nc, chunk, h, n)

    a_cs = torch.cumsum(dAc, dim=2)  # inclusive (b,c,l,h)
    a_total = a_cs[:, :, -1, :]  # (b,c,h)

    # intra-chunk ("diagonal") term
    Ldt = _segsum_decay(torch.movedim(a_cs, -1, -2)).to(COMPUTE_DTYPE)  # (b,c,h,l,l)
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)  # (b,c,h,l,s)
    y_diag = einsum3("bchls,bchls,bcshp->bclhp", scores, Ldt, xc)

    # per-chunk end states
    decay_to_end = torch.exp(_bcast(a_total[:, :, None, :], a_cs) - a_cs).to(COMPUTE_DTYPE)  # (b,c,l,h)
    chunk_states = einsum3("bclhn,bclh,bclhp->bchpn", Bc, decay_to_end, xc)

    # inter-chunk recurrence
    if init_state is None:
        init_state = torch.zeros((b, h, p, n), dtype=COMPUTE_DTYPE, device=xb.device)
    final_state, prev_states = _chunk_scan(init_state, chunk_states, a_total)

    # off-diagonal (carried state) term
    state_decay = torch.exp(a_cs).to(COMPUTE_DTYPE)  # decay from chunk start
    y_off = einsum3("bclhn,bchpn,bclh->bclhp", Cc, prev_states, state_decay)

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, final_state


def ssd_decode_step(state, x_t, dA_t, B_t, C_t):
    """One-token SSD update.  state (B,H,P,N); x_t (B,H,P); dA_t (B,H);
    B_t/C_t (B,H,N).  Returns (y_t (B,H,P), new_state)."""
    decay = torch.exp(dA_t.to(F32))[:, :, None, None].to(COMPUTE_DTYPE)
    outer = x_t[..., :, None] * B_t[..., None, :]  # (B,H,P,N)
    new_state = state * decay + outer
    y = torch.einsum("bhpn,bhn->bhp", new_state, C_t)
    return y, new_state


# ---------------------------------------------------------------------------
# Mamba2 mixer block
# ---------------------------------------------------------------------------


def mamba_init(cfg: ModelConfig, lead: tuple, generator, device) -> dict:
    """Mixer weights with leading dims `lead` (the stacked reps)."""
    d = cfg.d_model
    di = cfg.d_inner
    h = cfg.ssm_heads
    g, n, w = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv_width
    xbc = di + 2 * g * n
    proj = 2 * di + 2 * g * n + h  # z, x, B, C, dt
    a_log = torch.log(torch.arange(1, h + 1, dtype=F32, device=device))
    return {
        "in_proj": _he((*lead, d, proj), d, generator, device),
        "conv_w": _he((*lead, w, xbc), w, generator, device),
        "conv_b": torch.zeros((*lead, xbc), dtype=F32, device=device),
        "a_log": a_log.expand(*lead, h).clone(),
        "skip_d": torch.ones((*lead, h), dtype=F32, device=device),
        "dt_bias": torch.zeros((*lead, h), dtype=F32, device=device),
        "norm": rmsnorm_init((*lead, di), device),
        "out_proj": _he((*lead, di, d), di, generator, device),
    }


def _split_proj(cfg: ModelConfig, proj):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    z = proj[..., :di]
    xbc = proj[..., di : 2 * di + 2 * g * n]
    dt = proj[..., 2 * di + 2 * g * n :]
    return z, xbc, dt


def _split_xbc(cfg: ModelConfig, xbc):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    x = xbc[..., :di]
    B = xbc[..., di : di + g * n]
    C = xbc[..., di + g * n :]
    return x, B, C


def _causal_conv(xbc, conv_w, conv_b, history=None):
    """Depthwise causal conv over time; xbc (B, S, Cdim), conv_w (W, Cdim).

    history: (B, W-1, Cdim) left context (decode/prefill continuity).
    The taps are summed in order, each product and sum in bf16."""
    w = conv_w.shape[0]
    if history is None:
        history = torch.zeros((xbc.shape[0], w - 1, xbc.shape[-1]), dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([history, xbc], dim=1)
    s = xbc.shape[1]
    out = xp[:, 0:s, :] * conv_w[0].to(xbc.dtype)
    for i in range(1, w):
        out = out + xp[:, i : i + s, :] * conv_w[i].to(xbc.dtype)
    return out + conv_b.to(xbc.dtype), xp[:, -(w - 1) :, :]


def _expand_groups(cfg: ModelConfig, bc):
    """(B, S, G*N) -> per-head (B, S, H, N) by repeating groups."""
    b, s = bc.shape[:2]
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return torch.repeat_interleave(bc.reshape(b, s, g, n), h // g, dim=2)


def _softplus(x):
    """`jax.nn.softplus`: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssd_heads(p, cfg: ModelConfig, z, xi, B, C, dt, init_state=None, place=None):
    """The SSD of the heads that `z`, `xi` (B, S, heads, P), `dt` (B, S,
    heads) and `p`'s `a_log` / `skip_d` / `dt_bias` hold, with `B` / `C` at
    group rank (B, S, groups, N) for `ssm_impl="grouped"`, else per head
    (B, S, heads, N): the gated rows y * silu(z), (B, S, heads x P), and
    the final state.  `place` = (first head, all heads) where these are a
    rank's run of the mixer's heads (`_Broadcast`).

    Sequences are padded (at the end) to a chunk multiple; padded steps
    have dt forced to 0, so they neither decay nor feed the state: the
    returned state is exactly the post-last-real-token state."""
    b, s, h, hp = xi.shape
    dt = _softplus(dt.to(F32) + _bcast(p["dt_bias"], dt, place))  # (B,S,H)
    pad = (-s) % cfg.ssm_chunk
    if pad:  # dt = 0 -> identity step
        dt, xi, B, C = (torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (dt, xi, B, C))
    dA = dt * _bcast(-torch.exp(p["a_log"]), dt, place)  # (B,Sp,H)
    xb = xi * dt[..., None].to(COMPUTE_DTYPE)
    if cfg.ssm_impl == "grouped":
        y, state = ssd_chunked_grouped(xb, dA, B, C, cfg.ssm_chunk, init_state)
    else:
        y, state = ssd_chunked(xb, dA, B, C, cfg.ssm_chunk, init_state)
    y = y[:, :s]
    xh = xi[:, :s]
    y = y + xh * p["skip_d"][None, None, :, None].to(COMPUTE_DTYPE)
    return y.reshape(b, s, h * hp) * silu(z.reshape(b, s, h * hp)), state


def _heads_split(p, cfg: ModelConfig) -> bool:
    """Whether the mixer's heads are split over `model` here (`a_log`'s
    are); the grouped form needs whole groups a rank."""
    heads = P.model_split(p["a_log"].shape[-1], cfg.ssm_heads)
    if heads and cfg.ssm_impl == "grouped" and cfg.ssm_groups % P.current().model_size:
        raise ValueError(f"ssm_impl='grouped' splits whole groups over model: {cfg.ssm_groups} groups over "
                         f"{P.current().model_size} ranks; use the baseline form")
    return heads


def mamba_forward(p, cfg: ModelConfig, x, init_state=None, conv_history=None):
    """Full-sequence mixer.  x: (B, S, D) bf16.  Returns (y, (conv_hist, state)).

    In the sharded train step, on the mixer's model shards: `in_proj`'s
    columns [z | x | B | C | dt] split over `model` do not line up with the
    heads, so each rank computes its column block (each column whole there)
    and the block is all-gathered; the conv (its `conv_w` gathered whole:
    `MODEL_GATHERED`), silu and the groups' expansion to heads run
    replicated; each rank takes its own heads (`split_to_model`, where
    `a_log` splits: H / model heads) and runs the SSD on them; the gated
    rows are all-gathered, normed whole (the RMS statistic is over all of
    `d_inner`) and go whole into the row-parallel `out_proj`.  No grad is
    summed over `model`: each head's grad is computed on its rank and
    all-gathered, and the replicated part's backward runs on whole grads,
    as on one device.  The grouped form needs whole groups a rank.  The
    state returned there is the rank's heads'."""
    b, s, _ = x.shape
    h, hp, g, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    di = cfg.d_inner
    w = p["in_proj"].to(COMPUTE_DTYPE)
    if P.model_split(w.shape[-1], 2 * di + 2 * g * n + h):  # role tokens_act: x replicated over model
        proj = P.gather_model(P.column_parallel(x, w)[0], -1)
    else:
        proj = x @ w
    conv_w = p["conv_w"]
    if P.model_split(conv_w.shape[-1], di + 2 * g * n):
        conv_w = P.gather_model(conv_w, -1)
    z, xbc, dt = _split_proj(cfg, proj)
    xbc, conv_hist = _causal_conv(xbc, conv_w, p["conv_b"], conv_history)
    xi, B, C = _split_xbc(cfg, silu(xbc))
    heads = _heads_split(p, cfg)
    if cfg.ssm_impl == "grouped":
        B, C = B.reshape(b, s, g, n), C.reshape(b, s, g, n)
    else:
        B, C = _expand_groups(cfg, B), _expand_groups(cfg, C)
    z, xi = z.reshape(b, s, h, hp), xi.reshape(b, s, h, hp)
    if heads:  # this rank's heads (and groups)
        z, xi, B, C, dt = (P.split_to_model(t, 2) for t in (z, xi, B, C, dt))
    y, state = _ssd_heads(p, cfg, z, xi, B, C, dt, init_state, (P.model_run(h)[0], h) if heads else None)
    if heads:
        y = P.gather_model(y, -1)
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    w = p["out_proj"].to(COMPUTE_DTYPE)
    if P.model_split(w.shape[0], di):
        return P.row_parallel(y, w, whole=True), (conv_hist, state)
    return y @ w, (conv_hist, state)


def mamba_decode(p, cfg: ModelConfig, x, conv_history, state):
    """One-token mixer.  x (B, 1, D).  Returns (y, (conv_hist, state)).

    In the sharded serving step, on the mixer's model shards, split as in
    `mamba_forward`: `in_proj` column-parallel and gathered; the conv
    history (this rank's channels where they split over `model`) gathered
    whole, the conv run replicated and the rank's channels of the new
    history handed back; the rank's heads (`split_to_model`) stepped on
    its `state` (its heads where `a_log` splits); y gathered, normed whole
    and into the row-parallel `out_proj`."""
    b = x.shape[0]
    h_heads, hp, g, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    di = cfg.d_inner
    w = p["in_proj"].to(COMPUTE_DTYPE)
    if P.model_split(w.shape[-1], 2 * di + 2 * g * n + h_heads):
        proj = P.gather_model(P.column_parallel(x, w)[0], -1)
    else:
        proj = x @ w
    conv_w = p["conv_w"]
    if P.model_split(conv_w.shape[-1], di + 2 * g * n):
        conv_w = P.gather_model(conv_w, -1)
    conv_split = P.model_split(conv_history.shape[-1], di + 2 * g * n)
    if conv_split:
        conv_history = P.gather_model(conv_history, -1)
    z, xbc, dt = _split_proj(cfg, proj)
    xbc, conv_hist = _causal_conv(xbc, conv_w, p["conv_b"], conv_history)
    if conv_split:
        conv_hist = P.split_to_model(conv_hist, -1)
    xbc = silu(xbc)
    xi, B, C = _split_xbc(cfg, xbc)
    xh = xi.reshape(b, h_heads, hp)
    Bh = _expand_groups(cfg, B)[:, 0]  # (B,H,N)
    Ch = _expand_groups(cfg, C)[:, 0]
    dt = dt[:, 0]
    heads = _heads_split(p, cfg)
    if heads:  # this rank's heads
        xh, Bh, Ch, dt = (P.split_to_model(t, 1) for t in (xh, Bh, Ch, dt))
    dt = _softplus(dt.to(F32) + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["a_log"])
    dA = dt * A  # (B,H)
    xb = xh * dt[..., None].to(COMPUTE_DTYPE)
    y, state = ssd_decode_step(state, xb, dA, Bh, Ch)
    y = y + xh * p["skip_d"][None, :, None].to(COMPUTE_DTYPE)
    if heads:
        y = P.gather_model(y, 1)
    y = y.reshape(b, 1, di)
    y = rmsnorm(y * silu(z), p["norm"], cfg.norm_eps)
    w = p["out_proj"].to(COMPUTE_DTYPE)
    if P.model_split(w.shape[0], di):
        return P.row_parallel(y, w, whole=True), (conv_hist, state)
    return y @ w, (conv_hist, state)
