"""Flash attention, forward (K7): the plain version and the CUDA binding
(`kernel`), the public entry with padding (`ops`) and the dense oracle
(`ref`)."""
