"""Model configurations: the port's copy of the JAX package's `repro.configs`.

`base.py` holds the schema (`ModelConfig`, `ShapeConfig`, `SHAPES`) and
`registry.py` resolves `--arch` names; one module per architecture.  Plain
Python, equal field for field to the reference.
"""
