"""Serving entry points: the port of the JAX package's `repro.launch`
(serving half: `steps.make_prefill_step` / `make_decode_step` and `serve`)."""
