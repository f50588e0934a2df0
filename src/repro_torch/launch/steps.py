"""Step functions: the port of the JAX package's `repro/launch/steps.py`
(training, and serving's prefill and decode), and their abstract inputs.

The reference's steps are pure functions for `jax.jit`; here they run
eagerly over the same param dict.  The train step takes grads with torch
autograd (for `jax.value_and_grad`) and updates params and optimizer
state in place (the reference donates them); the decode step writes the
caches in place.  `param_specs`, `opt_specs`, `batch_specs`, `cache_specs`
and `input_specs` are the inputs' shapes and dtypes on the `meta` device
(for `jax.eval_shape` / `ShapeDtypeStruct`), with no allocation.

`make_sharded_train_step` is the step over `DTensor` state placed by the
sharding rules (the reference gets its sharded step from `jax.jit` with
in/out shardings): data parallel over the dp axes, with the params and
optimizer state sharded (FSDP) and gathered a rep at a time, tensor and
expert parallel over the model axis (`distributed.parallel`).
`make_sharded_prefill_step` / `make_sharded_decode_step` serve the same
way, over `DTensor` caches placed by `cache_shardings` (the KV caches'
length and the SSD states' heads over the model axis, the batch over dp).
"""
from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import parallel
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.optim.optimizers import square_sum
from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten

# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def loss_and_grads(cfg: ModelConfig, params, batch):
    """(loss, metrics, grads): `loss_fn` on `batch` and its grads w.r.t.
    `params`, in the params' nesting (`jax.value_and_grad` of the
    reference's `loss_fn`).

    The grads are taken w.r.t. detached views of the params, made trainable
    for the call alone, so the params (frozen `nn.Parameter`s of a
    `Transformer`, say) stay as serving uses them.  bf16 products sum in
    f32 throughout: the forward, the backward and the remat recompute."""
    with L.f32_accumulation(), torch.enable_grad():
        trainable = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = T.loss_fn(trainable, cfg, batch)
        flat = torch.autograd.grad(loss, leaves(trainable), materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten(params, flat)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig):
    _, update = make_optimizer(opt_cfg)

    def train_step(params, opt_state, batch, step):
        """One step on `batch` (a dict of tensors on the params' device):
        returns (params, opt_state, metrics), the first two updated in place
        under `no_grad`."""
        loss, metrics, grads = loss_and_grads(cfg, params, batch)
        with torch.no_grad():
            params, opt_state, opt_metrics = update(grads, opt_state, params, step)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def make_opt_init(cfg: ModelConfig, opt_cfg: OptConfig):
    init, _ = make_optimizer(opt_cfg)
    return init


def param_specs(cfg: ModelConfig):
    """The param dict's shapes and dtypes, on the `meta` device."""
    return T.init_params(cfg, None, "meta")


def opt_specs(cfg: ModelConfig, opt_cfg: OptConfig):
    """The optimizer state's shapes and dtypes, on the `meta` device."""
    return make_opt_init(cfg, opt_cfg)(param_specs(cfg))


def _all_reduce_sum(x: torch.Tensor, groups) -> torch.Tensor:
    """`x` summed over each process group in turn (over every rank of
    their product)."""
    for g in groups:
        x = funcol.wait_tensor(funcol.all_reduce(x, "sum", g))
    return x


def _sharded_mean(mesh, place):
    """Adafactor's `mean(x, dim, keepdim)` over a dim of a param sharded by
    `place`: the local sum over the ranks that shard that dim, divided by
    the whole dim; `torch.mean` itself where no rank splits the dim."""

    def mean(x, dim, keepdim=False):
        pdim = x.dim() + dim  # vr's dim -1 is the param's dim -2
        groups = [mesh.get_group(i) for i, p in enumerate(place) if p.is_shard(pdim) and mesh.size(i) > 1]
        if not groups:
            return torch.mean(x, dim, keepdim=keepdim)
        n = x.shape[dim] * math.prod(g.size() for g in groups)
        total = _all_reduce_sum(torch.sum(x, dim, keepdim=keepdim), groups)
        return total / torch.tensor(float(n), dtype=total.dtype, device=total.device)

    return mean


def _aligned_state(opt_state, params, mesh):
    """(the optimizer state as the update reads it, write-backs): each
    leaf's local tensor in its param's layout (AdamW's moments and
    Adafactor's unfactored `v`: the param's placements; Adafactor's `vr` /
    `vc`: the param's without its dim -1 / -2).  The in-place updates reach
    a leaf placed so through its `to_local()`; a leaf placed otherwise (the
    rules replicate the factors of most weights) is redistributed for the
    update, and the write-backs list (DTensor, update's placements, updated
    tensor) to redistribute back into it."""
    write_back = []

    def one(path, d):
        node, i = params, 1  # path[0] is the state's "m" / "v"
        while isinstance(node, (dict, list)):
            node, i = node[path[i]], i + 1
        removed = {"vr": node.dim() - 1, "vc": node.dim() - 2}.get(path[i]) if i < len(path) else None
        place = []
        for p in node.placements:
            if not p.is_shard() or p.dim == removed:
                place.append(Replicate())
            else:
                place.append(Shard(p.dim - (removed is not None and p.dim > removed)))
        if place == list(d.placements):
            return d.to_local()
        t = d.redistribute(mesh, place).to_local()
        write_back.append((d, place, t))
        return t

    flat = [one(path, d) for path, d in leaves_with_path(opt_state)]
    return unflatten(opt_state, flat), write_back


def data_parallel_rank(mesh) -> tuple[int, int]:
    """(this rank's index, the count) over the mesh's dp axes, major to
    minor: the host id and host count of its data stream."""
    rank, size = 0, 1
    coord = mesh.get_coordinate()
    for a in shd.dp_axes(mesh):
        i = mesh.mesh_dim_names.index(a)
        rank, size = rank * mesh.size(i) + coord[i], size * mesh.size(i)
    return rank, size


def make_sharded_train_step(cfg: ModelConfig, opt_cfg: OptConfig, mesh):
    """The train step over `DTensor` params and optimizer state on the
    `DeviceMesh` `mesh`, placed by `param_shardings` / `opt_shardings`
    (`sharding.distribute_tree`), and this rank's batch shard (a dict of
    tensors: `SyntheticStream(host_id, num_hosts)` from `data_parallel_rank`).

    Each step runs `loss_and_grads` on the local shards inside
    `parallel.sharded`: every rep gathers its block leaves over the dp axes
    as it starts, the model axis splits attention, the MLP, the MoE experts
    and the head (tensor and expert parallel), and MoE routes the global
    batch.  The grads come out of autograd in the params' placements,
    reduce-scattered over the dp axes that shard a leaf; this step
    all-reduces them over the dp axes that replicate it and divides by the
    dp size, takes the clip's global norm as an all-reduce of the shards'
    sums of squares, and updates the local shards in place.  Returns
    (params, opt_state, metrics), the metrics' loss the mean over the dp
    ranks.  At world size 1 the model code runs no collective, the grad norm's
    all-reduce is an identity, and the step computes what
    `make_train_step` computes, bit for bit."""
    _, update = make_optimizer(opt_cfg)
    dp_dims = [mesh.mesh_dim_names.index(a) for a in shd.dp_axes(mesh)]
    dp_groups = [mesh.get_group(i) for i in dp_dims]
    dp_size = math.prod(mesh.size(i) for i in dp_dims)
    all_groups = [mesh.get_group(i) for i in range(mesh.ndim)]

    def reduce_grad(g, place):
        """`g`, this rank's term of the grad, summed over the dp axes that
        replicate its leaf (the gathers' backward summed it over the others)
        and divided by the dp size."""
        g = _all_reduce_sum(g, [mesh.get_group(i) for i in dp_dims if not place[i].is_shard() and mesh.size(i) > 1])
        if dp_size > 1:
            g = g.div_(torch.tensor(float(dp_size), dtype=g.dtype, device=g.device))
        return g

    def replicas(place) -> int:
        return math.prod(mesh.size(i) for i, p in enumerate(place) if not p.is_shard())

    def train_step(params, opt_state, batch, step):
        flat_p = leaves(params)
        places = [tuple(p.placements) for p in flat_p]
        local = unflatten(params, [p.to_local() for p in flat_p])
        with parallel.sharded(mesh, unflatten(params, places)):
            loss, metrics, grads = loss_and_grads(cfg, local, batch)
        with torch.no_grad():
            local_g = [reduce_grad(g, place) for g, place in zip(leaves(grads), places)]
            del grads
            sums = []
            for g, place in zip(local_g, places):  # a leaf replicated r times is summed r times below
                r = replicas(place)
                sums.append(square_sum(g) if r == 1 else square_sum(g) / r)
            norm = torch.sqrt(_all_reduce_sum(torch.sum(torch.stack(sums)), all_groups))
            means = [_sharded_mean(mesh, place) for place in places]
            state, write_back = _aligned_state(opt_state, params, mesh)
            *_, opt_metrics = update(unflatten(params, local_g), state, local, step, norm=norm, means=means)
            for d, place, t in write_back:
                d.to_local().copy_(DTensor.from_local(t, mesh, place, run_check=False)
                                   .redistribute(mesh, d.placements).to_local())
            metrics = dict(metrics, loss=loss)
            if dp_size > 1:
                n = torch.tensor(float(dp_size), device=loss.device)
                metrics = {k: _all_reduce_sum(v, dp_groups) / n for k, v in metrics.items()}
        return params, opt_state, dict(metrics, **opt_metrics)

    return train_step


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    def prefill_step(params, batch):
        return T.prefill(params, cfg, batch, cache_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, token, caches, pos):
        return T.decode_step(params, cfg, token, caches, pos)

    return decode_step


def _placements(tree):
    """A `DTensor` tree's placements, each leaf's as a tuple in its place."""
    return unflatten(tree, [tuple(d.placements) for d in leaves(tree)])


def _to_local(tree):
    return unflatten(tree, [d.to_local() for d in leaves(tree)])


class _Serving:
    """What the sharded serving steps share: the mesh's dp size, whether a
    batch is split over it, and the logits' placement."""

    def __init__(self, cfg: ModelConfig, mesh, global_batch: int | None):
        self.cfg, self.mesh = cfg, mesh
        self.dp = math.prod(shd.axis_sizes(mesh)[a] for a in shd.dp_axes(mesh))
        self.split = global_batch is None or global_batch % self.dp == 0

    def global_batch(self, local: int) -> int:
        return local * self.dp if self.split else local

    def logits(self, logits: torch.Tensor) -> DTensor:
        """This rank's logits (B, V or V / model) placed (dp, model) as the
        reference's `logits_spec`: the vocab replicated where it does not
        divide over `model`, and where it does, this rank's columns (taken
        here if the head gave the whole row)."""
        b, v = self.global_batch(logits.shape[0]), self.cfg.vocab_size
        place = shd.named(self.mesh, shd.P(shd.dp_axes(self.mesh) or None, "model"), (b, v)).placements()
        for i, p in enumerate(place):
            if p.is_shard(1) and logits.shape[1] == v:
                logits = torch.chunk(logits, self.mesh.size(i), 1)[self.mesh.get_coordinate()[i]].contiguous()
        return DTensor.from_local(logits, self.mesh, place, run_check=False)


def make_sharded_prefill_step(cfg: ModelConfig, cache_len: int, mesh, global_batch: int | None = None):
    """The prefill step over `DTensor` params placed by `param_shardings` on
    the `DeviceMesh` `mesh`, and this rank's batch shard (a dict of tensors;
    the whole batch where `global_batch` does not divide over the dp axes,
    which the reference's `batch_shardings` then replicate).  The model
    runs on the local shards inside `parallel.sharded` (`T.prefill`): each
    rep's block leaves gathered over dp as it starts, attention, the MLP,
    MoE (global-batch routing), the SSD, the encoder and the head split over
    `model` as in the train step.  Returns (logits, caches): the logits
    placed (dp, model), and the caches as `DTensor`s placed by
    `cache_shardings`, made at their local shapes (`DTensor.from_local`):
    the batch over dp, a KV or cross cache's length over `model` (each rank
    holds positions [r L / m, (r + 1) L / m)), the SSD state's heads and
    the conv history's channels over `model`, each where it divides.  At
    world size 1 it computes what `make_prefill_step` computes, bit for
    bit."""
    serving = _Serving(cfg, mesh, global_batch)

    def prefill_step(params, batch):
        enc = batch.get("frames", batch.get("image_embeds"))
        whole = T.init_cache(cfg, serving.global_batch(batch["tokens"].shape[0]), cache_len,
                             0 if enc is None else enc.shape[1], device="meta")
        places = [{k: tuple(sh.placements()) for k, sh in c.items()} for c in shd.cache_shardings(mesh, whole)]
        with parallel.sharded(mesh, _placements(params), places, serving.split):
            logits, caches = T.prefill(_to_local(params), cfg, batch, cache_len)
        caches = [{k: DTensor.from_local(t, mesh, p[k], run_check=False) for k, t in c.items()}
                  for c, p in zip(caches, places)]
        return serving.logits(logits), caches

    return prefill_step


def make_sharded_decode_step(cfg: ModelConfig, mesh, global_batch: int | None = None):
    """The decode step over `DTensor` params (as `make_sharded_prefill_step`
    takes them), this rank's tokens (B / dp,) and the prefill step's
    `DTensor` caches, which it updates in place (their local shards) and
    returns.  Attention over a cache whose length is split over `model`
    scores each rank's slice and reduces the softmax over `model`
    (`layers.attention_decode`: the max and the sum of exps all-reduced,
    the probs normalised before the bf16 cast, the PV products summed);
    the SSD steps each rank's heads (`ssm.mamba_decode`).  Returns (logits
    placed (dp, model), caches).  At world size 1 it computes what
    `make_decode_step` computes, bit for bit."""
    serving = _Serving(cfg, mesh, global_batch)

    def decode_step(params, token, caches, pos):
        places = [{k: tuple(d.placements) for k, d in c.items()} for c in caches]
        local = [{k: d.to_local() for k, d in c.items()} for c in caches]
        with parallel.sharded(mesh, _placements(params), places, serving.split):
            logits, _ = T.decode_step(_to_local(params), cfg, token, local, pos)
        return serving.logits(logits), caches

    return decode_step


# ---------------------------------------------------------------------------
# abstract specs (meta tensors, no allocation)
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.max_target_len:
        s = min(s, cfg.max_target_len)
    out = {"tokens": _meta((b, s), torch.int32)}
    if cfg.num_image_tokens:
        out["image_embeds"] = _meta((b, cfg.num_image_tokens, cfg.d_model), torch.float32)
    if cfg.encoder_layers:
        out["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), torch.float32)
    return out


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int):
    enc_len = cfg.encoder_seq or cfg.num_image_tokens or 0
    return T.init_cache(cfg, batch, cache_len, enc_len, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, opt_cfg: OptConfig | None = None) -> dict:
    """All abstract inputs for the step implied by shape.kind."""
    opt_cfg = opt_cfg or OptConfig()
    if shape.kind == "train":
        return {
            "params": param_specs(cfg),
            "opt_state": opt_specs(cfg, opt_cfg),
            "batch": batch_specs(cfg, shape),
            "step": _meta((), torch.int32),
        }
    if shape.kind == "prefill":
        return {"params": param_specs(cfg), "batch": batch_specs(cfg, shape)}
    if shape.kind == "decode":
        b = shape.global_batch
        s = min(shape.seq_len, cfg.max_target_len) if cfg.max_target_len else shape.seq_len
        return {
            "params": param_specs(cfg),
            "token": _meta((b,), torch.int32),
            "caches": cache_specs(cfg, b, s),
            "pos": _meta((), torch.int32),
        }
    raise ValueError(shape.kind)
