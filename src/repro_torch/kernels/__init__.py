"""Hand-written CUDA kernels for Hopper (`csrc/`), their ctypes bindings,
build helper and launch-and-assemble layer."""
