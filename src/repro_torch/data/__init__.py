"""Synthetic training data: the port of the JAX package's `repro.data`."""
