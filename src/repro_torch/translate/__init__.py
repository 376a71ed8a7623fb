"""Automated translation of a component-style PyTorch right-hand side into
the device functors of the CUDA kernels (the paper's "automated
translation": an RHS reaches the GPU kernels without the user writing
device code).

- `ir`: the IR, a hash-consed DAG of scalar nodes, and `evaluate`, which
  replays it with torch ops: the plain version of every generated functor.
- `trace`: the recording proxy that calls ``f(u, p, t)`` once and builds
  the graph; it refuses what it cannot take, naming ROADMAP item 17.
- `derive`: forward mode on the IR (∂f/∂u, ∂f/∂t, (∂g/∂u)·g).
- `emit`: the CUDA C++ functors of K1, K3 and K4.
- `units`: the generated translation units, built by `kernels/build.py`
  (`load_generated`) under ``build/repro_torch/gen/``.

The kernel wrappers (`kernels/tsit5`, `kernels/rosenbrock`, `kernels/em`)
use it for every RHS that carries no hand-written functor's registration.
"""
