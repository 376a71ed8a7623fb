"""The device event functors of the CUDA kernels (`csrc/events.cuh`) and
their registry.

A kernel cannot call a Python condition or affect.  An `Event` reaches a
kernel through the hand-written functor its condition (and its affect, if it
has one) is registered with by `device_event`; its ``terminal``,
``direction`` and ``bisect_iters`` travel to the launch as runtime ints.
Each kernel compiles its event forms only for the (problem, event) pairs it
lists (`EVENT_PAIRS` in each kernel module), so an event without a device
form, or a pair that is not compiled in, raises `NotImplementedError` on
the card: it never falls back to the plain version.
"""
from __future__ import annotations

from typing import NamedTuple


class EventFunctor(NamedTuple):
    """A functor of `csrc/events.cuh`: its id in the launches' dispatch and
    whether it has an affect."""
    id: int
    affect: bool


# as in csrc/events.cuh (`kEventId` of each functor)
EVENT_FUNCTORS = {"ball_bounce": EventFunctor(1, True),
                  "decay_half": EventFunctor(2, False),
                  "rober_half": EventFunctor(3, False),
                  "gbm_barrier": EventFunctor(4, False),
                  "ramp_sawtooth": EventFunctor(5, True),
                  "osc_level": EventFunctor(6, False)}


def device_event(name: str):
    """Register an event's condition, or its affect, with a hand-written
    device functor of `csrc/events.cuh`."""
    if name not in EVENT_FUNCTORS:
        raise ValueError(f"no device event functor {name!r} in events.cuh; "
                         f"have {sorted(EVENT_FUNCTORS)}")

    def mark(fn):
        fn.device_event = name
        return fn

    return mark


def event_launch_args(ev, problem: str, pairs, source: str):
    """(event id, terminal, direction, bisect_iters) of `ev` for a kernel
    launch on the problem functor `problem`; `pairs` are the (problem,
    event) pairs compiled into `source`.  Raises NotImplementedError where
    the event has no device form or the pair is not compiled in."""
    name = getattr(ev.condition, "device_event", None)
    if name is None:
        raise NotImplementedError(
            f"event condition {getattr(ev.condition, '__name__', ev.condition)!r}"
            " has no device form: register a functor of csrc/events.cuh with "
            "@device_event (repro_torch.kernels.events; translating an event's"
            " condition and affect is ROADMAP queue 1 item 17's next slice)")
    fun = EVENT_FUNCTORS[name]
    affect = getattr(ev.affect, "device_event", None)
    if (ev.affect is None) == fun.affect or (fun.affect and affect != name):
        raise NotImplementedError(
            f"event {name!r}: its affect is not the device functor's "
            f"({'one registered' if fun.affect else 'none'} with "
            "@device_event); the kernel runs only the registered one")
    if (problem, name) not in pairs:
        raise NotImplementedError(
            f"the event form ({problem}, {name}) is not compiled into "
            f"{source}; it has {sorted(pairs)} (repro_torch.kernels.events)")
    if ev.direction not in (-1, 0, 1) or not 0 <= int(ev.bisect_iters) < 2 ** 31:
        raise ValueError(f"direction must be -1, 0 or 1 and bisect_iters "
                         f">= 0, got {ev.direction}, {ev.bisect_iters}")
    return fun.id, int(bool(ev.terminal)), int(ev.direction), \
        int(ev.bisect_iters)
