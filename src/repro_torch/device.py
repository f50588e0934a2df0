"""Where the port's entry points run: on the card, unless the caller asks
for another device.  Nothing falls back to the CPU on its own."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device`, or the card when it is None; raises when a card is asked
    for and none is there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU "
                           "(the kernels' plain versions)")
    return dev
