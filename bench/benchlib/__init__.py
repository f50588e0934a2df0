"""The benchmark's own code: finding cells by name, the measured loop, the
profiler's reading, the byte counts and the table of peaks.  It imports
nothing of the program at module level; `harness` imports `repro_torch`
once a run starts."""
