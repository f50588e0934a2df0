"""Root pytest settings: collect this tree's tests only.

The gitignored `artifacts/` may hold unpacked copies of other trees (a
parent commit for a card comparison) with `tests/` of their own, and
`chiprun_out/` what card runs write back.  A pathless `pytest` run from
the root would collect both, and a test module whose basename appears
twice fails to import.
"""
collect_ignore_glob = ["artifacts/*", "chiprun_out/*"]
