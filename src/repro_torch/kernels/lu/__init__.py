"""Batched small-matrix LU solve: plain lanes version and CUDA binding
(`kernel`), public entry with the singular-lane reroute (`ops`) and the
reference solve (`ref`)."""
