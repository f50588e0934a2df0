"""The port's LM layers and models (`repro_torch.models`) against the JAX
package's `repro.models` on the CPU, on identical inputs and weights.

Inputs are drawn from a seed with numpy; weights are the reference's,
carried across by `params_from_reference`.  Both sides compute in bf16
with f32 statistics, but round at different places in a few spots (XLA
fuses a `lax.scan` body and may keep f32 between bf16 ops; `rsqrt`,
`exp` and `softplus` differ by an f32 ulp on some inputs; sums are taken
in other orders), so outputs are compared by a stated tolerance: the largest
|port - reference| over the largest |reference|, each bound set at no more
than twice the worst value measured on this grid (the measured worst is
in the comment beside it).  Integer results (routing, caches' positions)
are compared exactly where they do not depend on a bf16 rounding.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_NAMES, get_config as ref_get_config
from repro.models import layers as RL
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import make_inputs
from repro_torch.models import layers as PL
from repro_torch.models import ssm as PS
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_reference, tensor_from_numpy

# Relative bounds (max |port - ref| / max |ref|), each at most twice the
# worst measured on this grid.  One bf16 ulp is 2^-8 to 2^-7 (0.0039 to
# 0.0078) of a value.  `rmsnorm`, `rope`, `_sdpa`, the baseline SSD scan,
# the SSD decode step and the causal conv agree bit for bit (measured 0), and
# so do the MLP and MoE layers, whose `silu` rounds as `jax.nn.silu` does
# (tests/test_torch_silu.py), so they are held to 0.
TOL_LAYER = 0.0084  # attention on identical inputs (worst 0.0042, decode's output)
TOL_MAMBA = 3.7e-5  # the whole Mamba2 mixer: the SSD's f32 ulps, not softplus's (worst 1.88e-5, jamba grouped's state)
TOL_BLOCK = 0.015   # a block's output and caches, a reduced arch, the reference's input (worst 0.0076)
TOL_HEAD = 5e-4     # final norm and head on the reference's own last hidden state (worst 2.55e-4)
TOL_MODEL = 0.035   # whole-model logits and caches, through 2-16 layers (worst 0.0189)
# jamba end to end: an exact tie between the 2nd and 3rd router probability
# (bf16 logits) at rep 0, block 7 flips one token's routing after a 1-ulp
# difference upstream, and the flip carries to the logits; its blocks are
# held to TOL_BLOCK on the reference's own inputs in the walk above.
TOL_MODEL_ARCH = {"jamba-1.5-large-398b": 0.24}  # worst 0.123


def rel_err(ref, got) -> float:
    ref = np.asarray(jnp.asarray(ref, jnp.float32)) if not isinstance(ref, np.ndarray) else ref
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = ref.astype(np.float32)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30))


def to_torch(x) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(x), device="cpu")


def bf16(rng, shape, scale=1.0):
    """A bf16 array for the reference and the same bits as a tensor."""
    x = jnp.asarray((rng.standard_normal(shape) * scale).astype(np.float32)).astype(jnp.bfloat16)
    return x, to_torch(x)


def f32(rng, shape, scale=1.0, offset=0.0):
    x = (rng.standard_normal(shape) * scale + offset).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def carried(tree):
    return params_from_reference(jax.tree.map(np.asarray, tree), device="cpu")


# ---------------------------------------------------------------------------
# layers on identical inputs
# ---------------------------------------------------------------------------


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    xj, xt = bf16(rng, (2, 8, 128), 3.0)
    sj, st = f32(rng, (128,), 0.2, 1.0)
    out = PL.rmsnorm(xt, st, 1e-5)
    assert out.dtype == torch.bfloat16
    assert rel_err(RL.rmsnorm(xj, sj, 1e-5), out) == 0.0


@pytest.mark.parametrize("theta", [1e6, 1e4])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    xj, xt = bf16(rng, (2, 8, 4, 32))
    pos = rng.integers(0, 4096, (2, 8)).astype(np.int32)
    out = PL.rope(xt, torch.from_numpy(pos), theta)
    assert out.dtype == torch.bfloat16
    assert rel_err(RL.rope(xj, jnp.asarray(pos), theta), out) == 0.0


@pytest.mark.parametrize("causal,sk", [(True, 8), (False, 8), (False, 12)])
def test_sdpa_matches_reference(causal, sk):
    cfg, ref_cfg = get_config("qwen3-4b").reduced(), ref_get_config("qwen3-4b").reduced()
    rng = np.random.default_rng(2)
    qj, qt = bf16(rng, (2, 8, 4, 32))
    kj, kt = bf16(rng, (2, sk, 2, 32))
    vj, vt = bf16(rng, (2, sk, 2, 32))
    got = PL._sdpa(qt, kt, vt, cfg, causal=causal)
    assert rel_err(RL._sdpa(qj, kj, vj, ref_cfg, causal=causal), got) == 0.0


def _layer_params(arch, init, **over):
    ref_cfg = ref_get_config(arch).reduced(**over)
    p = init(jax.random.PRNGKey(3), ref_cfg)
    return get_config(arch).reduced(**over), ref_cfg, p, carried(p)


def test_attention_and_decode_match_reference():
    cfg, ref_cfg, pj, pt = _layer_params("qwen3-4b", RL.attn_init)
    rng = np.random.default_rng(4)
    xj, xt = bf16(rng, (2, 8, 128))
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    got = PL.attention(pt, cfg, xt, torch.from_numpy(pos.copy()))
    assert rel_err(RL.attention(pj, ref_cfg, xj, jnp.asarray(pos)), got) <= TOL_LAYER

    ckj, ckt = bf16(rng, (2, 16, 2, 32))
    cvj, cvt = bf16(rng, (2, 16, 2, 32))
    x1j, x1t = bf16(rng, (2, 1, 128))
    out_j, nkj, nvj = RL.attention_decode(pj, ref_cfg, x1j, ckj, cvj, jnp.int32(5))
    out_t, nkt, nvt = PL.attention_decode(pt, cfg, x1t, ckt, cvt, 5)
    assert rel_err(out_j, out_t) <= TOL_LAYER
    assert rel_err(nkj, nkt) <= TOL_LAYER and rel_err(nvj, nvt) <= TOL_LAYER
    # only position 5 was written; the rest of the cache is untouched
    assert torch.equal(nkt[:, 6:], to_torch(ckj)[:, 6:]) and torch.equal(nvt[:, :5], to_torch(cvj)[:, :5])


def test_mlp_matches_reference():
    cfg, ref_cfg, pj, pt = _layer_params("qwen3-4b", RL.mlp_init)
    xj, xt = bf16(np.random.default_rng(5), (2, 8, 128))
    assert rel_err(RL.mlp(pj, xj), PL.mlp(pt, xt)) == 0.0


MOE_CASES = [  # (moe_dispatch, overrides): top-2 of 4 experts with and
    # without drops, and top-4 of 8 (the scatter-add's order over k matters)
    ("scatter", {}), ("scatter", {"capacity_factor": 8.0}),
    ("scatter", {"num_experts": 8, "experts_per_token": 4}),
    ("gather", {}), ("gather", {"num_experts": 8, "experts_per_token": 4}),
    ("local", {}), ("local", {"num_experts": 8, "experts_per_token": 4, "capacity_factor": 8.0}),
]


@pytest.mark.parametrize("dispatch,over", MOE_CASES, ids=lambda c: str(c))
def test_moe_matches_reference(dispatch, over):
    cfg, ref_cfg, pj, pt = _layer_params("qwen3-moe-30b-a3b", RL.moe_init, moe_dispatch=dispatch, **over)
    xj, xt = bf16(np.random.default_rng(6), (4, 8, 128))
    out_j, aux_j = RL.moe(pj, ref_cfg, xj)
    out_t, aux_t = PL.moe(pt, cfg, xt)
    assert out_t.dtype == torch.bfloat16
    assert rel_err(out_j, out_t) == 0.0
    assert abs(float(aux_j) - float(aux_t)) <= 1e-5 * abs(float(aux_j))


def test_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    w, e = PL._top_k(probs, 2)
    ref_w, ref_e = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert e.tolist() == np.asarray(ref_e).tolist() == [[1, 2], [0, 1]]
    assert torch.equal(w, torch.from_numpy(np.array(ref_w)))


def _ssd_inputs(rng, b, s, h, p, n, g=None):
    xj, xt = bf16(rng, (b, s, h, p))
    dt = np.abs(rng.standard_normal((b, s, h))).astype(np.float32) * 0.5
    dA = -dt * np.arange(1, h + 1, dtype=np.float32)
    bc = (b, s, g, n) if g else (b, s, h, n)
    Bj, Bt = bf16(rng, bc)
    Cj, Ct = bf16(rng, bc)
    return (xj, jnp.asarray(dA), Bj, Cj), (xt, torch.from_numpy(dA), Bt, Ct)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(grouped, with_state):
    rng = np.random.default_rng(7)
    b, s, h, p, n, g, chunk = 2, 48, 4, 16, 8, 2, 16
    ref_in, port_in = _ssd_inputs(rng, b, s, h, p, n, g if grouped else None)
    sj, st = bf16(rng, (b, h, p, n)) if with_state else (None, None)
    ref_fn, port_fn = (RS.ssd_chunked_grouped, PS.ssd_chunked_grouped) if grouped else \
        (RS.ssd_chunked, PS.ssd_chunked)
    yj, fj = ref_fn(*ref_in, chunk, sj)
    yt, ft = port_fn(*port_in, chunk, st)
    # the baseline agrees bit for bit; the grouped path's y once by one bf16
    # ulp of an element 1/2000 of the largest (measured 3.89e-7)
    assert rel_err(yj, yt) <= (7.7e-7 if grouped else 0.0)
    assert rel_err(fj, ft) == 0.0


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(8)
    sj, st = bf16(rng, (2, 4, 16, 8))
    xj, xt = bf16(rng, (2, 4, 16))
    dA = -np.abs(rng.standard_normal((2, 4))).astype(np.float32)
    Bj, Bt = bf16(rng, (2, 4, 8))
    Cj, Ct = bf16(rng, (2, 4, 8))
    yj, nj = RS.ssd_decode_step(sj, xj, jnp.asarray(dA), Bj, Cj)
    yt, nt = PS.ssd_decode_step(st, xt, torch.from_numpy(dA), Bt, Ct)
    assert rel_err(yj, yt) == 0.0 and rel_err(nj, nt) == 0.0


@pytest.mark.parametrize("history", [False, True])
def test_causal_conv_matches_reference(history):
    rng = np.random.default_rng(9)
    xj, xt = bf16(rng, (2, 10, 40))
    wj, wt = f32(rng, (4, 40))
    bj, bt = f32(rng, (40,), 0.1)
    hj, ht = bf16(rng, (2, 3, 40)) if history else (None, None)
    oj, cj = RS._causal_conv(xj, wj, bj, hj)
    ot, ct = PS._causal_conv(xt, wt, bt, ht)
    assert rel_err(oj, ot) == 0.0
    assert torch.equal(ct, to_torch(cj))  # the history is a slice of the input


def test_contraction_order_is_jnp_einsums():
    """`einsum3` contracts first the pair `jnp.einsum` does (opt_einsum's
    `optimal` path) for the SSD's three-operand einsums, at random sizes."""
    import opt_einsum

    subs = ["bchls,bchls,bcshp->bclhp", "bclhn,bclh,bclhp->bchpn", "bclhn,bchpn,bclh->bclhp",
            "bcgls,bcghls,bcsghp->bclghp", "bclgn,bclgh,bclghp->bcghpn", "bclgn,bcghpn,bclgh->bclghp"]
    rng = np.random.default_rng(10)
    for sub in subs:
        terms = sub.split("->")[0].split(",")
        letters = sorted(set("".join(terms)))
        for _ in range(200):
            size = {c: int(rng.choice([1, 2, 3, 4, 8, 16, 32, 48, 64, 128, 256])) for c in letters}
            shapes = [tuple(size[c] for c in t) for t in terms]
            path, _ = opt_einsum.contract_path(sub, *shapes, shapes=True, optimize="auto")
            assert PS.contraction_order(sub, shapes) == tuple(path[0]), (sub, size)


@pytest.mark.parametrize("arch,impl,s", [("mamba2-780m", "baseline", 20), ("mamba2-780m", "grouped", 32),
                                         ("jamba-1.5-large-398b", "baseline", 20),
                                         ("jamba-1.5-large-398b", "grouped", 7)])
def test_mamba_forward_and_decode_match_reference(arch, impl, s):
    cfg, ref_cfg, pj, pt = _layer_params(arch, RS.mamba_init, ssm_impl=impl)
    rng = np.random.default_rng(11)
    xj, xt = bf16(rng, (2, s, 128))
    yj, (cj, sj) = RS.mamba_forward(pj, ref_cfg, xj)
    yt, (ct, st) = PS.mamba_forward(pt, cfg, xt)
    assert rel_err(yj, yt) <= TOL_MAMBA
    assert rel_err(cj, ct) <= TOL_MAMBA and rel_err(sj, st) <= TOL_MAMBA
    # one decode step from the reference's own caches
    x1j, x1t = bf16(rng, (2, 1, 128))
    dj, (dcj, dsj) = RS.mamba_decode(pj, ref_cfg, x1j, cj, sj)
    dt, (dct, dst) = PS.mamba_decode(pt, cfg, x1t, to_torch(cj), to_torch(sj))
    assert rel_err(dj, dt) <= TOL_MAMBA
    assert rel_err(dcj, dct) <= TOL_MAMBA and rel_err(dsj, dst) <= TOL_MAMBA



#: The mixer at the published `ssm_chunk=256` (reduced width, 2 x 256
#: tokens), output against the reference's: one bf16 ulp of an element,
#: set by the out-projection's rounding on the CPU (worst 1.67e-3 mamba2,
#: 3.73e-3 jamba; `test_ssd_deviations_at_the_published_chunk`).  The
#: state and the conv cache agree bit for bit.
TOL_MAMBA_256 = {"mamba2-780m": 3.4e-3, "jamba-1.5-large-398b": 7.5e-3}


@pytest.mark.parametrize("arch,impl", [("mamba2-780m", "baseline"), ("mamba2-780m", "grouped"),
                                       ("jamba-1.5-large-398b", "grouped")])
def test_mamba_forward_matches_reference_at_the_published_chunk(arch, impl):
    cfg, ref_cfg, pj, pt = _layer_params(arch, RS.mamba_init, ssm_impl=impl, ssm_chunk=256)
    rng = np.random.default_rng(11)
    xj, xt = bf16(rng, (2, 256, 128))
    yj, (cj, sj) = RS.mamba_forward(pj, ref_cfg, xj)
    yt, (ct, st) = PS.mamba_forward(pt, cfg, xt)
    assert rel_err(yj, yt) <= TOL_MAMBA_256[arch]
    assert rel_err(cj, ct) == 0.0 and rel_err(sj, st) == 0.0


def xla_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`jnp.cumsum` as XLA's CPU computes it in f32 (a `reduce_window`): blocks
    of 16 from the start, each a left fold, the blocks' totals scanned the
    same way, then each block's exclusive prefix added."""
    x = torch.movedim(x, dim, -1)
    n = x.shape[-1]
    if n <= 16:
        out = [x[..., 0]]
        for i in range(1, n):
            out.append(out[-1] + x[..., i])
        return torch.movedim(torch.stack(out, -1), -1, dim)
    blocks = -(-n // 16)
    inner = xla_cumsum(torch.cat([x, x.new_zeros(*x.shape[:-1], blocks * 16 - n)], -1)
                       .reshape(*x.shape[:-1], blocks, 16), -1)
    totals = xla_cumsum(inner[..., -1], -1)
    prefix = torch.cat([totals.new_zeros(*totals.shape[:-1], 1), totals[..., :-1]], -1)
    out = (inner + prefix[..., None]).reshape(*x.shape[:-1], blocks * 16)[..., :n]
    return torch.movedim(out, -1, dim)


def test_ssd_deviations_at_the_published_chunk(monkeypatch):
    """Where the port's mixer rounds otherwise than the reference on the
    CPU at `ssm_chunk=256`, each held on the reference's own operands
    (measured counts of differing elements beside each):
    - the out-projection, a 256-long bf16 matmul, differs in a few elements
      (9 of 65,536: 1.67e-3, the mixer's reading); computed in f32 and
      rounded once it equals XLA's;
    - the SSD alone (`ssd_chunked`, (1, 256, 4, 16), n 16) differs (3.55e-4):
      `torch.cumsum` accumulates in f64 on the CPU, XLA in f32 blocks of 16
      (`xla_cumsum`); with XLA's order the SSD equals the reference bit for
      bit;
    - its pairwise bf16 contractions (`einsum3`'s, and the scores): the
      16-long scores differ in a few elements (3 of 262,144) and none when
      computed in f32 and rounded once; the 256-long ones none in f32 (in
      bf16 0 here, 4 of 131,072 on the mixer's own operands); the
      elementwise products (`L * scores`, `decay * x`) differ only where
      XLA's CPU flushes a subnormal operand or result to zero.
    The port keeps torch's matmuls, `torch.cumsum` and bf16 einsums: on the
    card they round as cuBLAS does, which is neither."""
    cfg, ref_cfg, pj, pt = _layer_params("mamba2-780m", RS.mamba_init, ssm_chunk=256)
    rng = np.random.default_rng(11)
    xj, _ = bf16(rng, (2, 256, 128))
    walk = {}

    def keep(x, *a, **k):  # the mixer's gated, normed rows as the reference has them
        walk["normed"] = RL.rmsnorm(x, *a, **k)
        return walk["normed"]

    with monkeypatch.context() as m:
        m.setattr(RS, "rmsnorm", keep)
        RS.mamba_forward(pj, ref_cfg, xj)
    normed, w = walk["normed"], pj["out_proj"].astype(jnp.bfloat16)
    want = np.asarray((normed @ w).astype(jnp.float32))
    got = (to_torch(normed) @ to_torch(w)).float().numpy()
    once = (to_torch(normed).float() @ to_torch(w).float()).to(torch.bfloat16).float().numpy()
    assert 0 < (got != want).sum() <= 1e-3 * want.size and (once != want).sum() == 0

    rng = np.random.default_rng(7)
    (xj, dAj, Bj, Cj), (xt, dAt, Bt, Ct) = _ssd_inputs(rng, 1, 256, 4, 16, 16)
    yj, fj = RS.ssd_chunked(xj, dAj, Bj, Cj, 256)
    assert rel_err(yj, PS.ssd_chunked(xt, dAt, Bt, Ct, 256)[0]) > 0
    with monkeypatch.context() as m:
        m.setattr(PS.torch, "cumsum", xla_cumsum)
        yt, ft = PS.ssd_chunked(xt, dAt, Bt, Ct, 256)
    assert rel_err(yj, yt) == 0.0 and rel_err(fj, ft) == 0.0

    def differ(sub, *ops):
        """(elements where torch's bf16 einsum differs from jnp's, where its
        f32 einsum rounded once does, where the former are flushes)."""
        want = np.asarray(jnp.einsum(sub, *ops).astype(jnp.float32))
        tops = [to_torch(o) for o in ops]
        got = torch.einsum(sub, *tops).float().numpy()
        once = torch.einsum(sub, *[o.float() for o in tops]).to(torch.bfloat16).float().numpy()
        tiny = lambda v: (v != 0) & (np.abs(v) < np.finfo(np.float32).tiny)  # noqa: E731
        flushed = (want == 0) & (tiny(got) | np.any([tiny(np.broadcast_to(np.asarray(o.astype(jnp.float32)), got.shape))
                                                     for o in ops if o.shape == got.shape], axis=0))
        return int((got != want).sum()), int((once != want).sum()), int(((got != want) & ~flushed).sum())

    xc, Bc, Cc = xj.reshape(1, 1, 256, 4, 16), Bj.reshape(1, 1, 256, 4, 16), Cj.reshape(1, 1, 256, 4, 16)
    a_cs = jnp.cumsum(dAj.reshape(1, 1, 256, 4), axis=2)
    scores = jnp.einsum("bclhn,bcshn->bchls", Cc, Bc)
    bf, f32_once, _ = differ("bclhn,bcshn->bchls", Cc, Bc)
    assert 0 < bf <= 1e-3 * scores.size and f32_once == 0
    ldt = RS._segsum_decay(jnp.moveaxis(a_cs, -1, -2)).astype(jnp.bfloat16)
    masked = jnp.einsum("bchls,bchls->bchls", scores, ldt)
    assert differ("bchls,bchls->bchls", scores, ldt)[2] == 0  # products: flushes only
    assert differ("bchls,bcshp->bclhp", masked, xc)[1] == 0  # the 256-long contraction
    decay = jnp.exp(a_cs[:, :, -1:, :] - a_cs).astype(jnp.bfloat16)
    assert differ("bclh,bclhp->bclhp", decay, xc)[2] == 0
    assert differ("bclhp,bclhn->bchpn", jnp.einsum("bclh,bclhp->bclhp", decay, xc), Bc)[1] == 0

# ---------------------------------------------------------------------------
# the ten archs, reduced: block by block, then end to end
# ---------------------------------------------------------------------------

SEQ = 16          # tokens per sequence (batch 2)
PROMPT = SEQ - 4  # prefill length; then 4 teacher-forced decode steps


@functools.lru_cache(maxsize=None)
def arch_setup(arch):
    """(port cfg, reference cfg, reference params, carried params, inputs)
    for `arch` at `reduced(capacity_factor=8.0)`: no MoE drops."""
    ref_cfg = ref_get_config(arch).reduced(capacity_factor=8.0)
    params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    return (get_config(arch).reduced(capacity_factor=8.0), ref_cfg, params, carried(params),
            make_inputs(ref_cfg, 2, SEQ, seed=0))


def _slice(tree, r):
    return jax.tree.map(lambda t: t[r], tree)


def _cache_to_torch(cache):
    return {k: to_torch(v) for k, v in cache.items()}


class Walk:
    """Every block of the model run by both packages on the reference's own
    input, its output and cache compared, the reference's carried on.  A
    MoE block is split: the mixer half (the block with ffn "none"), then the
    MoE on the reference's own normed input.  The reduced configs' bf16
    router logits tie exactly at times (jamba has ties between its 2nd and
    3rd expert), so a 1-ulp difference in the MoE's input would flip a
    routing; held on the reference's input, the routing is the same."""

    def __init__(self, arch):
        self.cfg, self.ref_cfg, self.pj, self.pt, inputs = arch_setup(arch)
        self.jb = {k: jnp.asarray(v) for k, v in inputs.items()}
        self.errs = {}

    def check(self, name, ref, got, tol=None):
        err = rel_err(ref, got)
        self.errs[name] = err
        assert err <= (TOL_BLOCK if tol is None else tol), (name, err)

    def enc_out(self):
        if self.ref_cfg.encoder_layers:
            ej = RT.encoder_forward(self.pj, self.ref_cfg, self.jb["frames"])
            et = PT.encoder_forward(self.pt, self.cfg, to_torch(self.jb["frames"]))
            self.check("encoder", ej, et)
            return ej
        if self.ref_cfg.num_image_tokens:
            return self.jb["image_embeds"].astype(jnp.bfloat16)
        return None

    def blocks(self, x, run_ref, run_port, label):
        """`run_ref(i, mixer, ffn, pj, x, r) -> x'` and `run_port(...)` per
        block; the MoE half handled here."""
        cfg, ref_cfg = self.cfg, self.ref_cfg
        for r in range(ref_cfg.reps):
            for i, (mixer, ffn) in enumerate(ref_cfg.pattern()):
                pj, pt = _slice(self.pj["blocks"][i], r), PT._rep_slice(self.pt["blocks"][i], r)
                half = "none" if ffn == "moe" else ffn
                yj = run_ref(i, mixer, half, pj, x, r)
                yt = run_port(i, mixer, half, pt, to_torch(x), r)
                self.check(f"{label} r{r} b{i} {mixer}/{half}", yj, yt)
                if ffn == "moe":
                    h = RL.rmsnorm(yj, pj["ln2"], ref_cfg.norm_eps)
                    oj, _ = RL.moe(pj["ffn"], ref_cfg, h)
                    ot, _ = PL.moe(pt["ffn"], cfg, to_torch(h))
                    self.check(f"{label} r{r} b{i} moe", oj, ot)
                    yj = yj + oj
                x = yj
        return x

    def head(self, x):
        xn = RL.rmsnorm(x, self.pj["final_norm"], self.ref_cfg.norm_eps)
        head = self.pj.get("lm_head")
        return xn @ (self.pj["embed"].T if head is None else head).astype(jnp.bfloat16)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arch_blocks_match_reference(arch):
    """forward, prefill (its caches too) and 4 decode steps, every block on
    the reference's own input (see `Walk`)."""
    w = Walk(arch)
    cfg, ref_cfg, tokens = w.cfg, w.ref_cfg, w.jb["tokens"]
    enc_j = w.enc_out()
    enc_t = None if enc_j is None else to_torch(enc_j)

    # forward
    pos_j = jnp.broadcast_to(jnp.arange(SEQ)[None], (2, SEQ))
    pos_t = torch.from_numpy(np.array(pos_j, np.int32))
    x = w.blocks(
        w.pj["embed"][tokens].astype(jnp.bfloat16),
        lambda i, m, f, p, x, r: RT._apply_block(ref_cfg, m, f, p, x, pos_j, enc_j)[0],
        lambda i, m, f, p, x, r: PT._apply_block(cfg, m, f, p, x, pos_t, enc_t)[0], "forward")
    xn = PL.rmsnorm(to_torch(x), w.pt["final_norm"], cfg.norm_eps)
    w.check("forward logits", w.head(x), xn @ PT._head(w.pt).to(torch.bfloat16), TOL_HEAD)

    # prefill: each block fills both packages' cache slices
    enc_len = 0 if enc_j is None else enc_j.shape[1]
    caches_j = RT.init_cache(ref_cfg, 2, SEQ, enc_len)
    caches_t = PT.init_cache(cfg, 2, SEQ, enc_len, device="cpu")
    filled = [[None] * ref_cfg.reps for _ in caches_j]
    pj_pos, pt_pos = pos_j[:, :PROMPT], pos_t[:, :PROMPT]

    def ref_prefill(i, m, f, p, x, r):
        y, filled[i][r] = RT._prefill_block(ref_cfg, m, f, p, x, pj_pos, enc_j, _slice(caches_j[i], r), SEQ)
        return y

    def port_prefill(i, m, f, p, x, r):
        c = PT._rep_slice(caches_t[i], r)
        y = PT._prefill_block(cfg, m, f, p, x, pt_pos, enc_t, c)
        for k in c:
            w.check(f"prefill cache r{r} b{i} {k}", filled[i][r][k], c[k])
        return y

    x = w.blocks(w.pj["embed"][tokens[:, :PROMPT]].astype(jnp.bfloat16), ref_prefill, port_prefill, "prefill")
    caches = [jax.tree.map(lambda *xs: jnp.stack(xs), *reps) for reps in filled]

    # decode: the reference's caches, 4 steps teacher-forced by the inputs
    for step in range(4):
        pos = PROMPT + step
        new = [[None] * ref_cfg.reps for _ in caches]

        def ref_decode(i, m, f, p, x, r):
            y, new[i][r] = RT._decode_block(ref_cfg, m, f, p, x, None, _slice(caches[i], r), jnp.int32(pos))
            return y

        def port_decode(i, m, f, p, x, r):
            c = _cache_to_torch(_slice(caches[i], r))
            y = PT._decode_block(cfg, m, f, p, x, c, pos)
            for k in c:
                w.check(f"decode {step} cache r{r} b{i} {k}", new[i][r][k], c[k])
            return y

        x = w.blocks(w.pj["embed"][tokens[:, pos]][:, None, :].astype(jnp.bfloat16),
                     ref_decode, port_decode, f"decode {step}")
        caches = [jax.tree.map(lambda *xs: jnp.stack(xs), *reps) for reps in new]
        xn = PL.rmsnorm(to_torch(x), w.pt["final_norm"], cfg.norm_eps)
        w.check(f"decode {step} logits", w.head(x), xn @ PT._head(w.pt).to(torch.bfloat16), TOL_HEAD)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arch_end_to_end_matches_reference(arch):
    """forward logits, prefill logits and caches, then 4 decode steps
    teacher-forced by the inputs, each package on its own caches: the whole
    model against the reference's, errors carried through every layer."""
    cfg, ref_cfg, pj, pt, inputs = arch_setup(arch)
    tol = TOL_MODEL_ARCH.get(arch, TOL_MODEL)
    jb = {k: jnp.asarray(v) for k, v in inputs.items()}
    tb = {k: torch.from_numpy(v) for k, v in inputs.items()}
    lj, aux_j = RT.forward(pj, ref_cfg, jb)
    lt, aux_t = PT.forward(pt, cfg, tb)
    assert lt.shape == (2, SEQ, cfg.vocab_size) and lt.dtype == torch.bfloat16
    assert rel_err(lj, lt) <= tol
    assert abs(float(aux_j) - float(aux_t)) <= 0.006 * max(abs(float(aux_j)), 1e-6)  # worst 0.0046

    pre_j, pre_t = dict(jb), dict(tb)
    pre_j["tokens"], pre_t["tokens"] = jb["tokens"][:, :PROMPT], tb["tokens"][:, :PROMPT]
    lpj, cj = RT.prefill(pj, ref_cfg, pre_j, cache_len=SEQ)
    lpt, ct = PT.prefill(pt, cfg, pre_t, cache_len=SEQ)
    assert rel_err(lpj, lpt) <= tol
    for a, b in zip(cj, ct):
        assert a.keys() == b.keys()
        for k in a:
            assert rel_err(a[k], b[k]) <= tol, k
    for step in range(4):
        pos = PROMPT + step
        lgj, cj = RT.decode_step(pj, ref_cfg, jb["tokens"][:, pos], cj, jnp.int32(pos))
        lgt, ct = PT.decode_step(pt, cfg, tb["tokens"][:, pos], ct, pos)
        assert rel_err(lgj, lgt) <= tol, step
