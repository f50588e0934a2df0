"""The port's model configurations (`repro_torch.configs`) against the JAX
package's `repro.configs`: every field, pattern, rep count, reduced form,
input shape, and the 40 (arch x shape) cells' status and effective shape."""
import dataclasses

import pytest

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro_torch.configs import base, registry

ARCHS = ref_registry.ARCH_NAMES


def test_arch_names_match():
    assert registry.ARCH_NAMES == ref_registry.ARCH_NAMES
    assert len(registry.ARCH_NAMES) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    cfg, ref = registry.get_config(arch), ref_registry.get_config(arch)
    assert type(cfg) is base.ModelConfig and type(cfg).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.pattern() == ref.pattern()
    assert cfg.reps == ref.reps
    assert (cfg.hd, cfg.d_inner, cfg.ssm_heads, cfg.subquadratic) == \
        (ref.hd, ref.d_inner, ref.ssm_heads, ref.subquadratic)
    for kw in ({}, {"capacity_factor": 8.0}, {"num_layers": 2 * len(ref.pattern()), "d_model": 256}):
        small, ref_small = cfg.reduced(**kw), ref.reduced(**kw)
        assert dataclasses.asdict(small) == dataclasses.asdict(ref_small)
        assert small.pattern() == ref_small.pattern() and small.reps == ref_small.reps
    assert cfg.validate() is cfg


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("gpt-5")


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_match_reference(arch):
    cfg, ref = registry.get_config(arch), ref_registry.get_config(arch)
    for name, shape in base.SHAPES.items():
        ref_shape = ref_base.SHAPES[name]
        assert registry.cell_status(cfg, shape) == ref_registry.cell_status(ref, ref_shape)
        assert dataclasses.asdict(registry.effective_shape(cfg, shape)) == \
            dataclasses.asdict(ref_registry.effective_shape(ref, ref_shape))


def test_all_cells_match_reference():
    port = [(c.name, s.name, st) for c, s, st in registry.all_cells()]
    ref = [(c.name, s.name, st) for c, s, st in ref_registry.all_cells()]
    assert port == ref and len(port) == 40
    assert sum(st != "run" for _, _, st in port) == 8
