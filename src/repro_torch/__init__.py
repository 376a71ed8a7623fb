"""PyTorch + CUDA port of `repro`: massively parallel ensemble ODE solving
on an NVIDIA H100 (paper: Automated Translation and Accelerated Solving of
Differential Equations on Multiple GPU Platforms).

This package imports neither JAX nor `repro`; the tests hold it against
`repro`, the reference.  See `repro_torch.core` for the front door.
"""
