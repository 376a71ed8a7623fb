"""The device event functors of the CUDA kernels (`csrc/events.cuh`) and
their registry.

A kernel cannot call a Python condition or affect.  An `Event` reaches a
kernel through a device functor: the hand-written one of `events.cuh` its
condition (and its affect, if it has one) is registered with by
`device_event`, or one the automated translation (`repro_torch.translate`)
generates from the Python condition and affect (`event_form`).  Its
``terminal``, ``direction`` and ``bisect_iters`` travel to the launch as
runtime ints (`event_launch_args`).  Each hand-written source compiles its
event forms for the (problem, event) pairs it lists (`EVENT_PAIRS` in each
kernel module, `compiled_in`); every other pair, and every event whose
condition and affect are not registered together, runs in a generated
unit.  Nothing falls back to the plain version.
"""
from __future__ import annotations

from typing import NamedTuple


class EventFunctor(NamedTuple):
    """A functor of `csrc/events.cuh`: its id in the launches' dispatch,
    whether it has an affect, and its struct."""
    id: int
    affect: bool
    struct: str


# as in csrc/events.cuh (`kEventId` of each functor)
EVENT_FUNCTORS = {"ball_bounce": EventFunctor(1, True, "BallBounce"),
                  "decay_half": EventFunctor(2, False, "DecayHalf"),
                  "rober_half": EventFunctor(3, False, "RoberHalf"),
                  "gbm_barrier": EventFunctor(4, False, "GbmBarrier"),
                  "ramp_sawtooth": EventFunctor(5, True, "RampSawtooth"),
                  "osc_level": EventFunctor(6, False, "OscLevel")}


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


def registered_event(ev):
    """The hand-written functor `ev` is registered with (its condition's,
    with the affect that functor has or none), or None: an event to
    translate."""
    name = getattr(ev.condition, "device_event", None)
    if name is None:
        return None
    fun = EVENT_FUNCTORS[name]
    affect = getattr(ev.affect, "device_event", None)
    if (ev.affect is None) == fun.affect or (fun.affect and affect != name):
        return None
    return name


def compiled_in(ev, problem: str, pairs) -> bool:
    """Whether a hand-written source compiles the event form of `ev` on
    the problem functor `problem`: its registered functor paired with it in
    `pairs`."""
    name = registered_event(ev)
    return name is not None and (problem, name) in pairs


def event_launch_args(ev):
    """(event id, terminal, direction, bisect_iters) of `ev` for a launch:
    the id of its registered functor, -1 for a translated one (a generated
    unit fixes its functor and ignores the id)."""
    if ev.direction not in (-1, 0, 1) or not 0 <= int(ev.bisect_iters) < 2 ** 31:
        raise ValueError(f"direction must be -1, 0 or 1 and bisect_iters "
                         f">= 0, got {ev.direction}, {ev.bisect_iters}")
    name = registered_event(ev)
    return (EVENT_FUNCTORS[name].id if name is not None else -1,
            int(bool(ev.terminal)), int(ev.direction), int(ev.bisect_iters))


def event_form(ev, n: int, m: int):
    """The event form of a generated unit (`translate.units.EventForm`):
    None without an event, the registered functor's struct, or the
    condition and affect traced for n states and m parameters."""
    if ev is None:
        return None
    from repro_torch.translate.trace import trace_event
    # traced in any case: a registered functor is paired here with a
    # problem its source does not pair it with, and the trace checks that
    # its condition and affect read and write this problem's state
    traced = trace_event(ev.condition, ev.affect, n, m)
    name = registered_event(ev)
    if name is not None:
        return f"repro_ev::{EVENT_FUNCTORS[name].struct}"
    return traced
