"""Shared pytest configuration for the repro test suite.

Hypothesis boilerplate (importorskip + settings profile) lives in
`tests/hypo.py`; property-based modules import from there.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (excluded from the smoke run via -m 'not slow')",
    )
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one (run: -m gpu)")


@pytest.fixture
def small_pim_cfg():
    """A small device config the system-level tests share: Nb=2 banks of
    the paper's geometry on a 2-channel x 2-bank device — big enough to
    exercise channel-crossing exchange traffic, small enough that a full
    cycle-level simulation stays in the milliseconds."""
    from repro.core.pim_config import PimConfig

    return PimConfig(num_buffers=2, num_channels=2, num_banks=2)
