"""Pattern-repeated decoder LM covering all assigned families: the port of
the JAX package's `repro/models/transformer.py`.

The model is a loop over `cfg.reps` repetitions of `cfg.pattern()`; every
pattern position has its own stacked parameter dict (leading dim = reps),
as in the reference, whose `lax.scan` over reps becomes a loop over `r`
that indexes the stacks.

Entry points (functions over a param dict, and the same as methods of
`Transformer`, an `nn.Module` that holds the dict):
  init_params(cfg, generator, device)          parameter dict
  forward(params, cfg, batch)                  full-seq logits + aux (train)
  loss_fn(params, cfg, batch)                  next-token cross-entropy + aux
  prefill(params, cfg, batch, cache_len)       logits at last pos + caches
  decode_step(params, cfg, token, caches, pos) one-token serve step
  encoder_forward(params, cfg, frames)         whisper encoder (conv stub in)

Caches are lists of dicts aligned with the stacked params: leading dim = reps.
  attn  : {"k": (reps,B,L,KV,hd), "v": ...}
  mamba : {"conv": (reps,B,W-1,xbc), "state": (reps,B,H,P,N)}
  cross : {"ck": (reps,B,S_enc,KV,hd), "cv": ...}  (precomputed at prefill)
`decode_step` writes them in place and returns them (the reference
returns new, donated ones).  Serve under `torch.inference_mode()`.  The
entry points sum bf16 products in f32 (`layers.f32_accumulation`).  With
`cfg.remat`, `forward` recomputes each rep in the backward
(`torch.utils.checkpoint`, the reference's `jax.checkpoint` per rep), only
while grads are being recorded.

Inside the sharded train step (`distributed.parallel.sharded`) `forward`
and `loss_fn` take each rank's local shards: each rep gathers its block
leaves over the dp axes as it starts (inside the remat `checkpoint`), and
every leaf keeps its model shard: attention (self and cross), the MLP,
MoE and the SSD mixer split the work, in the decoder and the whisper
encoder alike (the SSD gathers its small `conv_w` whole, `ssm.
MODEL_GATHERED`); the embedding is gathered at use, the head keeps the
vocab split over `model` and the loss reduces over it.  `prefill` and
`decode_step` run the same way inside the sharded serving steps
(`launch.steps.make_sharded_prefill_step` / `make_sharded_decode_step`),
on each rank's caches, placed by the plan's `caches`: a KV or cross
cache holds the rank's slice of the length, the SSD state its heads, the
conv history its channels, where the rules split them.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.distributed import parallel as P
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.tree import tree_map

COMPUTE_DTYPE = L.COMPUTE_DTYPE

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _block_init(cfg: ModelConfig, mixer: str, ffn: str, lead: tuple, generator, device) -> dict:
    p = {"ln1": L.rmsnorm_init((*lead, cfg.d_model), device)}
    if mixer in ("attn", "attn_nc", "cross"):
        p["mixer"] = L.attn_init(cfg, lead, generator, device)
    elif mixer == "attn_cross":
        p["mixer"] = L.attn_init(cfg, lead, generator, device)
        p["ln_cross"] = L.rmsnorm_init((*lead, cfg.d_model), device)
        p["cross"] = L.attn_init(cfg, lead, generator, device)
    elif mixer == "mamba":
        p["mixer"] = ssm.mamba_init(cfg, lead, generator, device)
    else:  # pragma: no cover
        raise ValueError(mixer)
    if ffn == "mlp":
        p["ln2"] = L.rmsnorm_init((*lead, cfg.d_model), device)
        p["ffn"] = L.mlp_init(cfg, lead, generator, device)
    elif ffn == "moe":
        p["ln2"] = L.rmsnorm_init((*lead, cfg.d_model), device)
        p["ffn"] = L.moe_init(cfg, lead, generator, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random parameters in the reference's layout, shapes and scales
    (embed x 0.02, He-normal weights, ones, zeros, a_log = log(1..H)),
    drawn from `generator` on `device` (other values than jax's PRNG)."""
    params = {
        "embed": torch.randn((cfg.vocab_size, cfg.d_model), generator=generator, device=device) * 0.02,
        "final_norm": L.rmsnorm_init(cfg.d_model, device),
        "blocks": [_block_init(cfg, mixer, ffn, (cfg.reps,), generator, device)
                   for mixer, ffn in cfg.pattern()],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._he((cfg.d_model, cfg.vocab_size), cfg.d_model, generator, device)
    if cfg.encoder_layers:  # whisper-style encoder over precomputed frames
        params["encoder"] = {
            "blocks": _block_init(cfg, "attn_nc", "mlp", (cfg.encoder_layers,), generator, device),
            "final_norm": L.rmsnorm_init(cfg.d_model, device),
        }
    if cfg.param_dtype != "float32":
        dt = getattr(torch, cfg.param_dtype)
        params = tree_map(lambda x: x.to(dt), params)
    return params


# ---------------------------------------------------------------------------
# block application (full sequence)
# ---------------------------------------------------------------------------


def _apply_block(cfg, mixer, ffn, p, x, positions, enc_out):
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    aux = torch.zeros((), dtype=L.F32, device=x.device)
    if mixer in ("attn", "attn_nc"):
        out = L.attention(p["mixer"], cfg, h, positions, causal=mixer == "attn")
    elif mixer == "cross":
        out = L.attention(p["mixer"], cfg, h, positions, kv=enc_out)
    elif mixer == "attn_cross":
        out = L.attention(p["mixer"], cfg, h, positions, causal=True)
        x = x + out
        h2 = L.rmsnorm(x, p["ln_cross"], cfg.norm_eps)
        out = L.attention(p["cross"], cfg, h2, positions, kv=enc_out)
    elif mixer == "mamba":
        out, _ = ssm.mamba_forward(p["mixer"], cfg, h)
    else:  # pragma: no cover
        raise ValueError(mixer)
    x = x + out
    if ffn != "none":
        h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        if ffn == "moe":
            out, aux = L.moe(p["ffn"], cfg, h)
        else:
            out = L.mlp(p["ffn"], h, cfg.d_ff)
        x = x + out
    return x, aux


def _rep_slice(stack, r):
    """Rep `r`'s parameter (or cache) slice of a stacked dict: views."""
    return {k: _rep_slice(v, r) if isinstance(v, dict) else v[r] for k, v in stack.items()}


def _rep_slices(stack, reps: int) -> list[dict]:
    """Every rep's `_rep_slice` of a stacked dict, from one `unbind` per
    leaf: the backward then writes each leaf's grad once, where one
    indexing per rep would write a zero-filled full-size grad per rep."""
    per = {k: _rep_slices(v, reps) if isinstance(v, dict) else torch.unbind(v) for k, v in stack.items()}
    return [{k: v[r] for k, v in per.items()} for r in range(reps)]


def _apply_rep(cfg, plan, p_slices, positions, enc_out, x, aux):
    """One repetition of the pattern (the reference's scan body).  In the
    sharded step (`plan`, entered here for the remat recompute too) the
    block's leaves are gathered over dp here, per rep."""
    with P.use_plan(plan):
        for i, (mixer, ffn) in enumerate(cfg.pattern()):
            p = p_slices[i]
            if plan is not None:  # the scan body's site (role tokens_act): this rep's leaves gathered over dp
                p = P.gather_tree(p, plan.placements["blocks"][i])
            x, a = _apply_block(cfg, mixer, ffn, p, x, positions, enc_out)
            aux = aux + a
    return x, aux


def _positions(b, s, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _head(params):
    head = params.get("lm_head")
    return params["embed"].T if head is None else head


def _embed(params, tokens, plan):
    """The token embeddings, bf16; in the sharded step the table gathered
    over dp at use, its model columns looked up here and gathered."""
    if plan is None:
        return params["embed"][tokens].to(COMPUTE_DTYPE)
    place = plan.placements["embed"]
    x = P.gather(params["embed"], place)[tokens].to(COMPUTE_DTYPE)
    if plan.model_dim is not None and place[plan.model_dim].is_shard():
        x = P.gather_model(x, -1)
    return x  # role tokens_act


def _logits(params, cfg, plan, x):
    """x (B, S, D) normed -> logits (B, S, V); in the sharded step this
    rank's vocab columns where the head splits them over `model` (role
    logits)."""
    if plan is None:
        return x @ _head(params).to(COMPUTE_DTYPE)
    head = _sharded_head(params, plan).to(COMPUTE_DTYPE)
    if head.shape[1] != cfg.vocab_size:
        return P.column_parallel(x, head)[0]
    return x @ head


def _sharded_head(params, plan):
    """This rank's head in the sharded step: (d, V / model) where the vocab
    splits over `model` (role logits), else (d, V)."""
    if "lm_head" in params:
        return P.gather(params["lm_head"], plan.placements["lm_head"])
    place = plan.placements["embed"]  # tied: the table's vocab over dp, d over model
    table = P.gather(params["embed"], place)
    i = plan.model_dim
    if i is None or not place[i].is_shard():
        return table.T
    if table.shape[0] % plan.model_size:
        return P.gather_model(table, 1).T
    return P.vocab_to_model(table).T


# ---------------------------------------------------------------------------
# public: training / scoring forward
# ---------------------------------------------------------------------------


@L.f32_accumulation()
def encoder_forward(params, cfg: ModelConfig, frames):
    """frames: (B, S_enc, D) precomputed conv-frontend embeddings (stub)."""
    x = frames.to(COMPUTE_DTYPE)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    enc = params["encoder"]
    plan = P.current()
    place = plan.placements["encoder"]["blocks"] if plan else None
    for p in _rep_slices(enc["blocks"], cfg.encoder_layers):
        x, _ = _apply_block(cfg, "attn_nc", "mlp", P.gather_tree(p, place), x, positions, None)
    return L.rmsnorm(x, enc["final_norm"], cfg.norm_eps)


def _enc_out(params, cfg, batch):
    if cfg.encoder_layers:
        return encoder_forward(params, cfg, batch["frames"])
    if cfg.num_image_tokens:
        return batch["image_embeds"].to(COMPUTE_DTYPE)
    return None


@L.f32_accumulation()
def forward(params, cfg: ModelConfig, batch):
    """batch: tokens (B,S) [+ image_embeds | frames].  Returns (logits, aux)."""
    tokens = batch["tokens"]
    plan = P.current()
    x = _embed(params, tokens, plan)
    positions = _positions(*tokens.shape, tokens.device)
    enc_out = _enc_out(params, cfg, batch)
    aux = torch.zeros((), dtype=L.F32, device=x.device)
    blocks = [_rep_slices(stack, cfg.reps) for stack in params["blocks"]]
    remat = cfg.remat and torch.is_grad_enabled()
    for r in range(cfg.reps):
        body = functools.partial(_apply_rep, cfg, plan, [b[r] for b in blocks], positions, enc_out)
        x, aux = checkpoint(body, x, aux, use_reentrant=False) if remat else body(x, aux)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, plan, x), aux


def loss_fn(params, cfg: ModelConfig, batch):
    """Next-token cross-entropy in f32 (+ 0.01 x the MoE aux loss), its
    logsumexp's sum of exps in f64 (`parallel.logsumexp`: the same f32
    result whether or not the vocab is split).  Returns (loss, {"ce", "aux"})."""
    logits, aux = forward(params, cfg, batch)
    targets = batch["tokens"][:, 1:].long()
    logits = logits[:, :-1].to(L.F32)
    split = logits.shape[-1] != cfg.vocab_size  # the vocab split over model (the sharded step)
    logz = P.logsumexp(logits, split)
    if not split:
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    else:  # the gold logit from the rank that holds it
        vl = logits.shape[-1]
        v0 = P.current().model_rank * vl
        here = (targets >= v0) & (targets < v0 + vl)
        gold = torch.gather(logits, -1, torch.clamp(targets - v0, 0, vl - 1)[..., None])[..., 0]
        gold = P.reduce_from_model(torch.where(here, gold, 0.0))
    ce = torch.mean(logz - gold)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + one-token decode
# ---------------------------------------------------------------------------


def _init_cache_slice(cfg: ModelConfig, mixer, lead, cache_len, enc_len, device):
    kv, hd = cfg.num_kv_heads, cfg.hd

    def zeros(*shape):
        return torch.zeros((*lead, *shape), dtype=COMPUTE_DTYPE, device=device)

    if mixer in ("attn", "attn_nc"):
        return {"k": zeros(cache_len, kv, hd), "v": zeros(cache_len, kv, hd)}
    if mixer in ("cross", "attn_cross"):
        c = {"ck": zeros(enc_len, kv, hd), "cv": zeros(enc_len, kv, hd)}
        if mixer == "attn_cross":
            c["k"] = zeros(cache_len, kv, hd)
            c["v"] = zeros(cache_len, kv, hd)
        return c
    if mixer == "mamba":
        return {
            "conv": zeros(cfg.ssm_conv_width - 1, cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state),
            "state": zeros(cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
        }
    raise ValueError(mixer)  # pragma: no cover


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, enc_len: int = 0, device=None):
    """Zeroed caches, stacked (reps, ...) per pattern position, on `device`
    (the card when None)."""
    dev = resolve(device)
    return [_init_cache_slice(cfg, mixer, (cfg.reps, batch), cache_len, max(enc_len, 1), dev)
            for mixer, _ in cfg.pattern()]


def _local_cache(cfg: ModelConfig, plan, batch: int, cache_len: int, enc_len: int, device):
    """This rank's zeroed caches in the sharded serving step: the whole
    caches' shapes (the global batch) cut by `plan.caches`' placements."""
    whole = init_cache(cfg, batch * plan.dp_size, cache_len, enc_len, device="meta")
    out = []
    for c, places in zip(whole, plan.caches):
        local = {}
        for k, t in c.items():
            shape = list(t.shape)
            for i, place in enumerate(places[k]):
                if place.is_shard():
                    shape[place.dim] //= plan.mesh.size(i)
            local[k] = torch.zeros(shape, dtype=t.dtype, device=device)
        out.append(local)
    return out


def _serving_plan():
    """The plan in use, which on local shards must hold the caches'
    placements (the sharded serving steps enter it so)."""
    plan = P.current()
    if plan is not None and plan.caches is None:
        raise ValueError("prefill / decode_step on local shards need the caches' placements: serve through "
                         "launch.steps.make_sharded_prefill_step / make_sharded_decode_step")
    return plan


def _splits(plan, cache: dict, i: int) -> dict:
    """{leaf: whether pattern position `i`'s cache leaf is split over
    `model`} (a KV cache's length, the SSD state's heads, the conv's
    channels); all False without a plan."""
    if plan is None or plan.model_dim is None:
        return dict.fromkeys(cache, False)
    return {k: plan.caches[i][k][plan.model_dim].is_shard() for k in cache}


def _fill(cache, kv, split: bool) -> None:
    """Writes `kv` (B, S, KV, hd), positions [0, S), into `cache` (B, L,
    KV, hd); with `split` the cache is this rank's slice [r L, (r + 1) L)
    of the length, and takes the positions that fall in it."""
    n = cache.shape[1]
    start = P.current().model_rank * n if split else 0
    stop = min(start + n, kv.shape[1])
    if stop > start:
        cache[:, :stop - start] = kv[:, start:stop]


def _block_params(plan, blocks, i: int, r: int) -> dict:
    """Rep `r`'s slice of pattern position `i`'s params; in the sharded step
    gathered over dp (the scan body's site, role tokens_act)."""
    p = _rep_slice(blocks[i], r)
    return p if plan is None else P.gather_tree(p, plan.placements["blocks"][i])


def _prefill_block(cfg, mixer, ffn, p, x, positions, enc_out, cache, split=None):
    """Like `_apply_block`, but fills rep r's cache slice `cache` in place
    (`split`: `_splits`, or nothing split)."""
    split = split or dict.fromkeys(cache, False)
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if mixer in ("attn", "attn_nc", "attn_cross"):
        out, k, v = L.attention(p["mixer"], cfg, h, positions, causal=mixer != "attn_nc", return_kv=True)
        _fill(cache["k"], k, split["k"])
        _fill(cache["v"], v, split["v"])
        if mixer == "attn_cross":
            x = x + out
            h2 = L.rmsnorm(x, p["ln_cross"], cfg.norm_eps)
            out, ck, cv = L.attention(p["cross"], cfg, h2, positions, kv=enc_out, return_kv=True)
            _fill(cache["ck"], ck, split["ck"])
            _fill(cache["cv"], cv, split["cv"])
    elif mixer == "cross":
        out, ck, cv = L.attention(p["mixer"], cfg, h, positions, kv=enc_out, return_kv=True)
        _fill(cache["ck"], ck, split["ck"])
        _fill(cache["cv"], cv, split["cv"])
    elif mixer == "mamba":
        out, (conv_hist, state) = ssm.mamba_forward(p["mixer"], cfg, h)
        cache["conv"].copy_(P.split_to_model(conv_hist, -1) if split["conv"] else conv_hist)
        cache["state"].copy_(state)
    else:  # pragma: no cover
        raise ValueError(mixer)
    x = x + out
    if ffn != "none":
        h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        out = L.moe(p["ffn"], cfg, h)[0] if ffn == "moe" else L.mlp(p["ffn"], h, cfg.d_ff)
        x = x + out
    return x


@L.f32_accumulation()
def prefill(params, cfg: ModelConfig, batch, cache_len: int):
    """Run the prompt, return (last-position logits, caches).

    In the sharded serving step (`launch.steps.make_sharded_prefill_step`)
    on the local shards: the caches are made at this rank's shapes
    (`plan.caches`), each rep's block leaves are gathered over dp as it
    starts, and the logits are this rank's vocab columns where the head
    splits them."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    plan = _serving_plan()
    x = _embed(params, tokens, plan)
    positions = _positions(b, s, tokens.device)
    enc_out = _enc_out(params, cfg, batch)
    enc_len = 0 if enc_out is None else enc_out.shape[1]
    if plan is None:
        caches = init_cache(cfg, b, cache_len, enc_len, device=x.device)
    else:
        caches = _local_cache(cfg, plan, b, cache_len, enc_len, x.device)
    splits = [_splits(plan, c, i) for i, c in enumerate(caches)]
    for r in range(cfg.reps):
        for i, (mixer, ffn) in enumerate(cfg.pattern()):
            x = _prefill_block(cfg, mixer, ffn, _block_params(plan, params["blocks"], i, r), x, positions,
                               enc_out, _rep_slice(caches[i], r), splits[i])
    x = L.rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, plan, x)[:, 0], caches


def _decode_block(cfg, mixer, ffn, p, x, cache, pos, split=None):
    split = split or dict.fromkeys(cache, False)
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if mixer in ("attn", "attn_nc", "attn_cross"):
        out, _, _ = L.attention_decode(p["mixer"], cfg, h, cache["k"], cache["v"], pos, split["k"])
        if mixer == "attn_cross":
            x = x + out
            h2 = L.rmsnorm(x, p["ln_cross"], cfg.norm_eps)
            out = L.cross_decode(p["cross"], cfg, h2, cache["ck"], cache["cv"], split["ck"])
    elif mixer == "cross":
        out = L.cross_decode(p["mixer"], cfg, h, cache["ck"], cache["cv"], split["ck"])
    elif mixer == "mamba":
        out, (conv, state) = ssm.mamba_decode(p["mixer"], cfg, h, cache["conv"], cache["state"])
        cache["conv"].copy_(conv)
        cache["state"].copy_(state)
    else:  # pragma: no cover
        raise ValueError(mixer)
    x = x + out
    if ffn != "none":
        h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        out = L.moe(p["ffn"], cfg, h)[0] if ffn == "moe" else L.mlp(p["ffn"], h, cfg.d_ff)
        x = x + out
    return x


@L.f32_accumulation()
def decode_step(params, cfg: ModelConfig, token, caches, pos: int):
    """token: (B,) int; pos: int (next position to fill).

    Returns (logits (B, V), caches), the caches updated in place.  In the
    sharded serving step (`launch.steps.make_sharded_decode_step`) on the
    local shards and this rank's caches, placed by `plan.caches`."""
    plan = _serving_plan()
    x = _embed(params, token[:, None], plan)
    splits = [_splits(plan, c, i) for i, c in enumerate(caches)]
    for r in range(cfg.reps):
        for i, (mixer, ffn) in enumerate(cfg.pattern()):
            x = _decode_block(cfg, mixer, ffn, _block_params(plan, params["blocks"], i, r), x,
                              _rep_slice(caches[i], r), pos, splits[i])
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, plan, x)[:, 0], caches


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------


class _Tree(nn.Module):
    """A nested dict / list of tensors as submodules and (frozen) parameters,
    under the dict's own names."""

    def __init__(self, tree):
        super().__init__()
        self._is_list = isinstance(tree, (list, tuple))
        items = enumerate(tree) if self._is_list else tree.items()
        for k, v in items:
            if isinstance(v, torch.Tensor):
                self.register_parameter(str(k), nn.Parameter(v, requires_grad=False))
            else:
                self.add_module(str(k), _Tree(v))

    def value(self):
        out = {k: p for k, p in self._parameters.items()}
        out.update({k: m.value() for k, m in self._modules.items()})
        if self._is_list:
            return [out[str(i)] for i in range(len(out))]
        return out


class Transformer(nn.Module):
    """The LM as an `nn.Module`: `params` (a dict in the reference's layout)
    held as frozen parameters under the reference's names, and the entry
    points as methods."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.tree = _Tree(params)

    @classmethod
    def init(cls, cfg: ModelConfig, seed: int, device) -> "Transformer":
        """Random parameters drawn on `device` from a generator seeded with `seed`."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return cls(cfg, init_params(cfg, gen, device))

    @property
    def params(self) -> dict:
        return self.tree.value()

    def forward(self, batch):
        return forward(self.params, self.cfg, batch)

    def prefill(self, batch, cache_len: int):
        return prefill(self.params, self.cfg, batch, cache_len)

    def decode_step(self, token, caches, pos: int):
        return decode_step(self.params, self.cfg, token, caches, pos)
