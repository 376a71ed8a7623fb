"""Automated translation of a component-style PyTorch right-hand side into
the device functors of the CUDA kernels (the paper's "automated
translation": an RHS reaches the GPU kernels without the user writing
device code).

- `ir`: the IR, a hash-consed DAG of scalar nodes, and `evaluate`, which
  replays it with torch ops: the plain version of every generated functor.
- `trace`: the recording proxy that calls ``f(u, p, t)`` (``f(u, p, t,
  data)`` with a dataset, whose lookups become nodes) once and builds the
  graph, and an event's condition and affect (`trace_event`); it refuses
  what it cannot take, naming ROADMAP item 17.
- `derive`: forward mode on the IR (∂f/∂u, ∂f/∂t, (∂g/∂u)·g and, of
  that, the milstein pair's ∂((∂g)·g)·g; a lookup's tangent).
- `emit`: the CUDA C++ functors of K1, K3, K4 and K5, data functors, and
  the event functors of every kernel.
- `units`: the generated translation units, one per form of a kernel,
  built by `kernels/build.py` (`load_generated`) under
  ``build/repro_torch/gen/``.

The kernel wrappers (`kernels/tsit5`, `kernels/rosenbrock`, `kernels/em`)
use it for every form their hand-written sources do not compile: an RHS,
event or dataset without a hand-written functor, and a registered functor
in a form its source lacks (each wrapper's `route`).
"""
