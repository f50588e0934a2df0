"""Optimizers: the port of the JAX package's `repro.optim`."""
from repro_torch.optim.optimizers import (  # noqa: F401
    OptConfig,
    adafactor_init,
    adamw_init,
    global_norm,
    make_optimizer,
    schedule,
)
