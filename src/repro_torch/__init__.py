"""NTT-PIM's accelerator path in PyTorch + CUDA for the H100.

The counterpart of the JAX package `repro`, which stays the reference:
`repro_torch.core` mirrors `repro.core` (modular arithmetic, NTT contexts,
stage plans) and `repro_torch.kernels` mirrors `repro.kernels` (`ntt`,
`intt`, `polymul_ntt` over hand-written CUDA kernels).  Nothing here
imports `jax` or `repro`.
"""
