"""The port's optimizers (`repro_torch.optim`) against the JAX package's
`repro.optim` on the CPU: the schedule, one AdamW update (f32 and bf16
moments) and one Adafactor update from identical numpy params, grads and
state, `global_norm`, and twins of `tests/test_substrate.py`'s optimizer
tests.

The AdamW update is elementwise f32 arithmetic in the reference's order, so
it agrees bit for bit (measured: 0 of 251 values differ, params and both
moments, in either moment dtype).  Adafactor's factored second moment is a
mean over rows or columns, summed in runs in a fixed pairwise order
(`optim.factored_mean`, the same on one device and split over ranks), not
XLA's: 1 ulp on 13 of 105 state values and on 1 of 251 params measured
(`torch.mean` gave 8 and 0).  The bound is 2 f32 ulps per element
throughout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as RO
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import optimizers as PO
from repro_torch.tree import leaves

MAX_ULPS = 2


def ulps(a, b) -> np.ndarray:
    """|a - b| in f32 units in the last place, elementwise."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def port_cfg(cfg: RO.OptConfig) -> PO.OptConfig:
    return PO.OptConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def tree_1d_2d_3d(rng, scale=1.0):
    """A 1-D leaf (a norm), a matrix, and stacked 3-D / 4-D leaves."""
    shapes = {"norm": (5,), "w": (6, 7), "blocks": [{"wi": (3, 4, 5)}, {"moe": (2, 3, 4, 6)}]}
    return jax.tree.map(lambda s: (rng.standard_normal(s) * scale).astype(np.float32), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))


def to_port(tree):
    return params_from_reference(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 10), (0, 5)])
def test_schedule_matches_reference(warmup, total):
    cfg = RO.OptConfig(lr_peak=1e-3, lr_min=1e-4, warmup_steps=warmup, total_steps=total)
    for step in sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2, total - 1, total, total + 7}):
        if step < 0:
            continue
        want = RO.schedule(cfg, jnp.int32(step))
        got = PO.schedule(port_cfg(cfg), step)
        assert got.dtype == torch.float32
        assert ulps(want, got.numpy()).max() <= MAX_ULPS, step


def _one_update(cfg: RO.OptConfig, step: int):
    """The reference and the port from the same params, grads and a warm
    state (the reference's after 3 updates); returns both results."""
    rng = np.random.default_rng(0)
    params, grads = tree_1d_2d_3d(rng), tree_1d_2d_3d(rng, 0.3)
    init, update = RO.make_optimizer(cfg)
    jp, jg = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads)
    state = init(jp)
    for t in range(3):
        jp, state, _ = update(jg, state, jp, jnp.int32(t))
    tp, ts, tg = to_port(jp), to_port(state), to_port(jg)
    want = update(jg, state, jp, jnp.int32(step))
    _, p_update = PO.make_optimizer(port_cfg(cfg))
    got = p_update(tg, ts, tp, step)
    return want, got


@pytest.mark.parametrize("optimizer,moments", [("adamw", "float32"), ("adamw", "bfloat16"),
                                               ("adafactor", "float32")])
def test_update_matches_reference(optimizer, moments):
    cfg = RO.OptConfig(optimizer=optimizer, moment_dtype=moments, warmup_steps=3, total_steps=20)
    (wp, ws, wm), (gp, gs, gm) = _one_update(cfg, 4)
    assert float(wm["lr"]) == float(gm["lr"])
    assert abs(float(wm["grad_norm"]) - float(gm["grad_norm"])) <= 1e-6 * float(wm["grad_norm"])
    for name, want, got in (("params", wp, gp), ("state", ws, gs)):
        w_leaves, g_leaves = jax.tree.leaves(want), leaves(got)
        assert len(w_leaves) == len(g_leaves)
        for w, g in zip(w_leaves, g_leaves):
            assert str(w.dtype) == str(g.dtype).removeprefix("torch."), name
            assert ulps(w.astype(jnp.float32), g.float().numpy()).max() <= MAX_ULPS, (name, w.shape)


def test_update_is_in_place_and_sliced(monkeypatch):
    """The update writes params and state in place, slice by slice along
    the leading dim, with the same values as one whole-leaf pass."""
    cfg = RO.OptConfig(warmup_steps=1, total_steps=10, moment_dtype="bfloat16")
    _, (gp, gs, _) = _one_update(cfg, 2)
    monkeypatch.setattr(PO, "SLICE_ELEMS", 7)  # every leaf in several slices
    _, (sp, ss, _) = _one_update(cfg, 2)
    for a, b in zip(leaves((gp, gs)), leaves((sp, ss))):
        assert torch.equal(a, b)
    p, g = {"w": torch.ones(4, 4)}, {"w": torch.full((4, 4), 0.5)}
    init, update = PO.make_optimizer(port_cfg(cfg))
    state = init(p)
    w, m = p["w"], state["m"]["w"]
    new_p, new_state, _ = update(g, state, p, 1)
    assert new_p["w"] is w and new_state["m"]["w"] is m and not torch.equal(w, torch.ones(4, 4))


def test_global_norm_matches_reference():
    tree = tree_1d_2d_3d(np.random.default_rng(3), 2.0)
    want = float(RO.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(PO.global_norm(to_port(tree)))
    assert abs(got - want) <= 1e-6 * want


# ---------------------------------------------------------------------------
# twins of tests/test_substrate.py's optimizer tests
# ---------------------------------------------------------------------------


def test_adamw_matches_reference():
    cfg = PO.OptConfig(optimizer="adamw", lr_peak=1e-2, warmup_steps=0, total_steps=1000,
                       weight_decay=0.0, grad_clip=1e9)
    init, update = PO.make_optimizer(cfg)
    p = {"w": torch.ones((4, 4)) * 2.0}
    g = {"w": torch.full((4, 4), 0.5)}
    state = init(p)
    new_p, state, _ = update(g, state, p, 0)
    # step 0: bias-corrected mhat=g, vhat=g^2 => delta=1
    expect = 2.0 - float(PO.schedule(cfg, 0)) * (0.5 / (np.sqrt(0.25) + cfg.eps))
    np.testing.assert_allclose(new_p["w"].numpy(), expect, rtol=1e-5)


def test_adamw_bf16_moments_close_to_fp32():
    base = dict(lr_peak=1e-3, warmup_steps=0, total_steps=100, weight_decay=0.01)
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((8, 8)).astype(np.float32)
    grads = [(rng.standard_normal((8, 8)) * 0.1).astype(np.float32) for _ in range(10)]
    traj = {}
    for dt in ("float32", "bfloat16"):
        init, update = PO.make_optimizer(PO.OptConfig(moment_dtype=dt, **base))
        p = {"w": torch.from_numpy(p0.copy())}
        st = init(p)
        for t, g in enumerate(grads):
            p, st, _ = update({"w": torch.from_numpy(g)}, st, p, t)
        traj[dt] = p["w"].numpy()
    np.testing.assert_allclose(traj["bfloat16"], traj["float32"], atol=5e-3)


def test_adafactor_reduces_loss_quadratic():
    cfg = PO.OptConfig(optimizer="adafactor", lr_peak=0.1, warmup_steps=0, total_steps=100,
                       weight_decay=0.0)
    init, update = PO.make_optimizer(cfg)
    target = torch.from_numpy(np.random.default_rng(1).standard_normal((6, 6)).astype(np.float32))
    p = {"w": torch.zeros((6, 6))}
    st = init(p)
    losses = []
    for t in range(50):
        w = p["w"].detach().requires_grad_()
        loss = torch.mean((w - target) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        p, st, _ = update({"w": g}, st, p, t)
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.2 * losses[0]


def test_schedule_warmup_and_cosine():
    cfg = PO.OptConfig(lr_peak=1e-3, lr_min=1e-4, warmup_steps=10, total_steps=100)
    assert float(PO.schedule(cfg, 0)) == 0.0
    assert abs(float(PO.schedule(cfg, 10)) - 1e-3) < 1e-9
    assert float(PO.schedule(cfg, 100)) == pytest.approx(1e-4, rel=1e-3)
    assert float(PO.schedule(cfg, 55)) < 1e-3
