"""Bounded, checkpointed solver loops — the reverse-mode substrate, the
PyTorch counterpart of `repro.core.loops`.

The adaptive engines run a Python ``while`` loop whose condition reads the
lanes' ``done`` mask.  Autograd records such a loop as it runs, so reverse
mode crosses it, but it keeps every step's residuals alive until the
backward pass: O(steps) memory.  Every adaptive engine body in this package
is written so that a finished lane's iteration is an exact no-op (all writes
are masked by ``accept``/``active``), which buys the reference's
substitution: run the SAME body a fixed number of times and the outputs are
bitwise-identical to the while loop whenever the bound covers the true
iteration count — and a too-small bound surfaces as ``status == 1``
(max-iters semantics), never as a silently wrong answer.

`solver_loop` is that substitution: with ``bounded_steps=None`` it is the
plain ``while`` loop (the forward hot path, untouched); with an integer
bound it runs ``ceil(K / checkpoint_every)`` segments of
``checkpoint_every`` body applications, each wrapped in
`torch.utils.checkpoint.checkpoint` (non-reentrant).  The forward pass then
keeps one full carry per segment boundary, and the backward pass recomputes
each segment from it, so peak memory is
O(n_segments * carry + checkpoint_every * step_residuals) instead of
O(K * step_residuals).

`checkpointed_fori` is the fixed-step sibling for loops over a known index
range (the fixed-dt RK and SDE paths).

A body run under a checkpoint must not write into its input carry in
place (the recompute replays it from that carry) and must take the same
branches on recompute as on the first pass; every engine body here is a
pure function of its carry.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch.utils.checkpoint

Carry = Any


def _remat(fn: Callable, *args):
    """One checkpointed segment: keep `args`, recompute `fn` in the
    backward pass."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def default_checkpoint_every(bounded_steps: int) -> int:
    """sqrt-schedule: balances stored carries against recompute residuals."""
    return max(1, math.isqrt(max(1, int(bounded_steps))))


def _every(n: int, checkpoint_every: Optional[int]) -> int:
    every = (default_checkpoint_every(n) if checkpoint_every is None
             else max(1, int(checkpoint_every)))
    return min(every, n)


def solver_loop(cond: Callable[[Carry], bool], body: Callable[[Carry], Carry],
                carry0: Carry, *, bounded_steps: Optional[int] = None,
                checkpoint_every: Optional[int] = None) -> Carry:
    """``while cond(c): c = body(c)``, or its bounded reverse-mode
    substitute.

    bounded_steps=None -> the plain while loop.
    bounded_steps=K    -> ceil(K / checkpoint_every) checkpointed segments of
                          ``checkpoint_every`` unconditional body
                          applications (``cond`` is not consulted; at least
                          K in total).

    Contract on ``body``: an application on a carry whose lanes are all done
    leaves every observable output unchanged — then the bounded form equals
    the while form bit for bit whenever K covers the true iteration count,
    and a K too small reproduces the max-iters outcome (lanes still marked
    not done; the engines report ``status == 1``).
    """
    if bounded_steps is None:
        c = carry0
        while cond(c):
            c = body(c)
        return c
    bounded = int(bounded_steps)
    if bounded <= 0:
        raise ValueError(f"bounded_steps must be positive, got {bounded}")
    every = _every(bounded, checkpoint_every)
    n_seg = -(-bounded // every)

    def segment(c):
        for _ in range(every):
            c = body(c)
        return c

    c = carry0
    for _ in range(n_seg):
        c = _remat(segment, c)
    return c


def checkpointed_fori(lower: int, upper: int,
                      body: Callable[[int, Carry], Carry], init: Carry, *,
                      checkpoint_every: Optional[int] = None) -> Carry:
    """``for i in range(lower, upper): init = body(i, init)`` with periodic
    checkpoints.

    Runs the identical body sequence (same indices, same order), so the
    primal is bitwise-equal to the plain loop; reverse mode keeps one carry
    per segment and recomputes inside segments.  A tail of
    ``(upper - lower) % checkpoint_every`` steps is its own segment."""
    lower, upper = int(lower), int(upper)
    n = upper - lower
    if n <= 0:
        return init
    every = _every(n, checkpoint_every)
    n_seg, rem = divmod(n, every)

    def run(c, start, stop):
        for i in range(start, stop):
            c = body(i, c)
        return c

    for s in range(n_seg):
        start = lower + every * s
        init = _remat(run, init, start, start + every)
    if rem:
        init = _remat(run, init, upper - rem, upper)
    return init
