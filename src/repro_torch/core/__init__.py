"""Host core of the port: modular arithmetic (with int64 torch twins of the
kernels' uint32 arithmetic), twiddle contexts, stage plans and oracles."""
