"""The LM substrate's models: the port of the JAX package's `repro.models`.

`layers` (norms, rotary, GQA attention, SwiGLU, MoE), `ssm` (Mamba2 / SSD)
and `transformer` (the pattern-repeated decoder: forward, prefill, decode)
on plain torch tensors, with the reference's parameter names and layouts;
`convert` carries the reference's parameters across.
"""
