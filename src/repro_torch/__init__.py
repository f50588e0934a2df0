"""NTT-PIM's accelerator path in PyTorch + CUDA for the H100.

The counterpart of the JAX package `repro`, which stays the reference:
`repro_torch.core` mirrors `repro.core` (modular arithmetic, NTT contexts,
stage plans, and the paper's row-centric mapper and cycle-level bank
model), `repro_torch.kernels` mirrors `repro.kernels` (`ntt`, `intt`,
`polymul_ntt` over hand-written CUDA kernels), `repro_torch.pimsys` the
multi-bank PIM device simulator and `repro_torch.he` the RNS-CKKS ops
(values on the card, PIM timing from the simulator).  Nothing here
imports `jax` or `repro`.
"""
