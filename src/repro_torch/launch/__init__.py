"""Entry points: the port of the JAX package's `repro.launch` (`steps`,
`serve`, `train`, and `roofline`'s analytic counts)."""
