"""Gradient compression: the port of the JAX package's `repro.distributed`
(`compression.ef_compress` / `ef_decompress`; the collectives and the
sharding rules are not ported yet)."""
