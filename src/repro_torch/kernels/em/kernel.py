"""ctypes binding of the fixed-dt SDE ensemble kernel (`csrc/sde_ensemble.cu`),
which replaces the TPU kernel `repro.kernels.ensemble_kernel.run_ensemble_kernel`
+ `sde_body` with its in-kernel Threefry noise (`repro.kernels.rng`).

`sde_ensemble` is the wrapper: for CUDA tensors it checks its inputs,
allocates the outputs and launches the kernel on the current stream (or
raises); for CPU tensors, and only for them, it runs the plain PyTorch
version of the same function, the lanes loop `repro_torch.kernels.em.ref`.
`sde_normals` does the same for the kernel's counter normals alone.

The kernel cannot call Python drift and diffusion functions.  A
registered pair (f, g) reaches it through the hand-written device functor
both are registered with by `device_sde`; Milstein's derivative term then
needs the functor's hand-written ``gdg`` member, (∂g/∂u)·g.  The source
compiles those functors without an event, their event forms for its
`EVENT_PAIRS`, and its data functor (`DATA_LAYOUTS`, through a third C
entry, `kernels/interp.py`) without an event.  Every other form goes
through the automated translation (`repro_torch.translate`), in a
generated translation unit with the counter stream and the noise table:
any other pair ``f(u, p, t)``, ``g(u, p, t)`` (or ``f(u, p, t, data)``,
``g(u, p, t, data)``, traced with the dataset's lookups) is traced into
one graph (a term both compute, CRN's Hill term, is computed once a
point), diagonal or general noise, with ``gdg`` derived (the plain
version's `torch.func.jvp`) where the noise is diagonal; an event whose
condition and affect are not registered together is traced; a registered
functor in a form the source lacks (another event, data with an event)
runs its hand-written struct in a unit.  `sde_route` decides between
source and unit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core.problem import bind_data
from repro_torch.core.sde import sde_nf_per_step
from repro_torch.kernels.em.ref import solve_lanes
from repro_torch.kernels.events import (compiled_in, event_form,
                                        event_launch_args)
from repro_torch.kernels.interp import (DataLayout, data_argtypes,
                                        data_launch_args, matches)
from repro_torch.kernels.rng import (M32, check_u32, counter_normals_threefry,
                                     counter_words)

SOURCE = "sde_ensemble.cu"


class SDEFunctor(NamedTuple):
    """A device functor of `csrc/sde_problems.cuh`: id, states, parameters,
    noise kind, Wiener processes, whether it has the ``gdg`` member,
    (∂g/∂u)·g, and the ``ddb`` member, ∂((∂g)·g)·g (the milstein pair's),
    and its struct, which a generated unit instantiates in a form the
    sources do not compile (None for a traced pair)."""
    id: int
    n: int
    k: int
    noise: str
    m: int
    gdg: bool
    ddb: bool
    struct: Optional[str] = None


# as in the .cu files (`by_problem`)
SDE_FUNCTORS = {
    "gbm": SDEFunctor(0, 3, 2, "diagonal", 3, True, True, "repro_sde::Gbm"),
    "crn": SDEFunctor(1, 4, 6, "general", 8, False, False, "repro_sde::Crn"),
    "ramp": SDEFunctor(2, 1, 2, "diagonal", 1, True, True, "repro_sde::Ramp"),
    "gbm_rate": SDEFunctor(3, 1, 1, "diagonal", 1, True, True,
                           "repro_sde::GbmRate")}
# the data functors and the dataset each reads (`by_data` in both .cu)
DATA_LAYOUTS = {"gbm_rate": DataLayout((("rate", 1),))}
# the (problem, event) pairs whose event form both SDE kernels compile
# (`by_event`)
EVENT_PAIRS = {("gbm", "gbm_barrier"), ("ramp", "ramp_sawtooth")}
STEPPER_IDS = {"em": 0, "heun_strat": 1, "platen_w2": 2, "milstein": 3}
DIAGONAL_ONLY = ("platen_w2", "milstein")
DTYPE_IDS = {torch.float32: 0, torch.float64: 1}

# launches of the SDE kernel, and of the normals kernel, since each counter
# was last set to 0
launches = 0
normals_launches = 0


def device_sde(name: str):
    """Register a Python drift or diffusion with its hand-written device
    functor; a problem's f and g must both carry the same name."""
    if name not in SDE_FUNCTORS:
        raise ValueError(f"no device functor {name!r} in sde_problems.cuh; "
                         f"have {sorted(SDE_FUNCTORS)}")

    def mark(fn):
        fn.device_sde = name
        return fn

    return mark


@functools.lru_cache(maxsize=None)
def _bind():
    from repro_torch.kernels.build import load
    lib = load(SOURCE)
    vp, i32, f64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                         ctypes.c_uint)
    run = lib.sde_ensemble_launch
    run.argtypes = argtypes()
    run.restype = i32
    normals = lib.sde_normals_launch
    normals.argtypes = [u32, ctypes.c_longlong, i32, i32, i32, u32, vp, vp,
                        vp]
    normals.restype = i32
    return run, normals


@functools.lru_cache(maxsize=None)
def _bind_unit(unit, event: bool = False, data: bool = False):
    """The entry of a generated unit for the form (event, data)."""
    from repro_torch.kernels.build import load_generated
    fn = getattr(load_generated(unit), "sde_ensemble" + (
        "_data" if data else "") + ("_event" if event else "") + "_launch")
    fn.argtypes = argtypes(event, data)
    fn.restype = ctypes.c_int
    return fn


def argtypes(event: bool = False, data: bool = False):
    """The ctypes argument types of the no-event entry, the event entry
    (the event id, terminal, direction and bisect_iters after the table
    switch), the data entry (the tables there) or a generated unit's
    data-and-event entry (the event's four, then the tables): the
    hand-written entries' and a generated unit's."""
    vp, i32, f64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                         ctypes.c_uint)
    args = [i32, i32, i32, i32, vp, vp, vp, i32, i32, i32, f64, f64, f64,
            u32, u32, vp, vp, vp, vp, vp]
    extra = ([i32] * 4 if event else []) + (data_argtypes() if data else [])
    return args[:4] + extra + args[4:]


@functools.lru_cache(maxsize=None)
def _bind_event():
    """The event entry of SOURCE."""
    from repro_torch.kernels.build import load
    fn = load(SOURCE).sde_ensemble_event_launch
    fn.argtypes = argtypes(event=True)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bind_data():
    """The data entry of SOURCE."""
    from repro_torch.kernels.build import load
    fn = load(SOURCE).sde_ensemble_data_launch
    fn.argtypes = argtypes(data=True)
    fn.restype = ctypes.c_int
    return fn


class SdeRoute(NamedTuple):
    """Where an SDE launch goes: `unit` None for the hand-written source
    (the functor `name`, `fun`), else the generated unit; `fun` gives the
    sizes and the noise the launch checks."""
    unit: object
    name: str
    fun: SDEFunctor


def sde_route(f, g, method: str, *, noise: str, m_noise: int, n: int, k: int,
              dtype, event=None, data=None, make_unit=None):
    """The route of a K4 (or, with K5's `make_unit`, K5) launch (both
    sources compile the same `EVENT_PAIRS`): a registered pair in the forms the source compiles (no event,
    the `EVENT_PAIRS`, the data functor of `DATA_LAYOUTS` without an event)
    goes to the source; in any other form it runs its hand-written struct
    in a unit; any other pair is traced into a unit (and so is a registered
    one that reads no dataset, given one).  `make_unit(f, g, fun, hand)`
    makes the unit; n, k are the state's and the parameters' sizes."""
    make_unit = make_unit or (lambda f, g, fun, hand: generated_unit(
        f, g, method, fun, dtype, event=event, data=data, hand=hand))
    names = {getattr(f, "device_sde", None), getattr(g, "device_sde", None)}
    name = names.pop() if len(names) == 1 else None
    if name is not None:
        fun = SDE_FUNCTORS[name]
        if noise != fun.noise or m_noise != fun.m:
            raise ValueError(f"functor {name!r} has {fun.noise} noise with "
                             f"{fun.m} Wiener processes, not {noise} with "
                             f"{m_noise}")
        layout = DATA_LAYOUTS.get(name)
        if data is not None and not (layout is not None
                                     and matches(data, layout)):
            name = None         # a dataset the functor does not read
        elif data is None and layout is not None:
            raise ValueError(f"the device functor {name!r} reads a dataset; "
                             "the problem has none (prob.data)")
    if method in DIAGONAL_ONLY and noise != "diagonal":
        raise ValueError(f"{method} supports diagonal noise only")
    if name is None:
        fname = (f"{getattr(f, '__name__', 'f')}/"
                 f"{getattr(g, '__name__', 'g')}")
        fun = SDEFunctor(-1, n, k, noise, int(m_noise), noise == "diagonal",
                         noise == "diagonal")
        return SdeRoute(make_unit(f, g, fun, None), fname, fun)
    if event is None or (data is None
                         and compiled_in(event, name, EVENT_PAIRS)):
        return SdeRoute(None, name, fun)
    return SdeRoute(make_unit(f, g, fun, name), name, fun)


def _plain(f, g, method, noise, m_noise, u0, p, *, t0, dt, n_steps,
           save_every, seed, lane_offset, table, event=None):
    us, uf, estate = solve_lanes(f, g, noise, m_noise, method, u0, p, t0=t0,
                                 dt=dt, n_steps=n_steps,
                                 save_every=save_every, seed=seed,
                                 noise_table=table, lane_offset=lane_offset,
                                 event=event)
    N = u0.shape[1]
    full = lambda v: torch.full((N,), v, dtype=torch.int32, device=u0.device)
    if estate is None:
        t_final = torch.full((N,), t0 + n_steps * dt, dtype=u0.dtype,
                             device=u0.device)
        naccept = full(n_steps)
    else:
        # a terminal event ends a lane early: its located time and the
        # steps it was active
        t_final, naccept = estate["t_out"], estate["naccept"]
    stats = torch.stack([naccept, full(0), full(0),
                         full(n_steps * sde_nf_per_step(method)), full(0),
                         full(0)])
    return us, uf, t_final, stats


def sde_ensemble(f, g, method: str, u0, p, *, noise: str, m_noise: int,
                 t0: float, dt: float, n_steps: int, save_every: int,
                 seed: int, lane_offset: int = 0, table=None, event=None,
                 data=None):
    """Integrate every lane of u0 (n, N) with parameters p (k, N) over
    `n_steps` fixed steps of `dt` from t0, by `method` (em, heun_strat,
    platen_w2, milstein), with N(0,1) noise from the Threefry stream
    (seed; step, row, lane_offset + lane) or from `table` (n_steps, m, N),
    and an optional `Event` (a terminal hit freezes the lane; its t_final
    is the event time and naccept its active steps); with a dataset `data`,
    f and g take it as a fourth argument.  Returns us (S, n, N)
    with S = n_steps / save_every, u_final (n, N), t_final (N,) and stats
    (6, N) int32 with rows (naccept, nreject, status, nf, njac, nfact)."""
    seed = check_u32("seed", seed)
    lane_offset = check_u32("lane_offset", lane_offset)
    if save_every < 1 or n_steps < 0 or n_steps % save_every != 0 \
            or n_steps * sde_nf_per_step(method) >= 2 ** 31:
        raise ValueError(f"need 0 <= n_steps with n_steps * nf_per_step "
                         f"< 2^31 (the int32 nf count) and save_every >= 1 "
                         f"dividing it, got n_steps={n_steps}, "
                         f"save_every={save_every}")
    if u0.device.type == "cpu":
        return _plain(bind_data(f, data), bind_data(g, data), method, noise,
                      m_noise, u0, p, t0=t0, dt=dt,
                      n_steps=n_steps, save_every=save_every, seed=seed,
                      lane_offset=lane_offset, table=table, event=event)
    if u0.device.type != "cuda":
        raise ValueError(f"sde_ensemble runs on CPU or CUDA tensors, not "
                         f"{u0.device.type}")
    if method not in STEPPER_IDS:
        raise NotImplementedError(
            f"stepper {method!r} is not compiled into the CUDA kernel; it "
            f"has {sorted(STEPPER_IDS)}")
    names = {getattr(f, "device_sde", None), getattr(g, "device_sde", None)}
    if method == "milstein" and len(names) == 1 and None not in names \
            and not SDE_FUNCTORS[min(names)].gdg:
        raise NotImplementedError(
            f"milstein on the CUDA kernel needs the functor's hand-written "
            f"gdg member, (dg/du)·g; {min(names)!r} has none in {SOURCE}")
    unit, name, fun = sde_route(f, g, method, noise=noise, m_noise=m_noise,
                                n=u0.shape[0], k=p.shape[0], dtype=u0.dtype,
                                event=event, data=data)
    tables = (None if data is None
              else data_launch_args(data, None, name, u0))
    ev = () if event is None else event_launch_args(event)
    dtype = u0.dtype
    if dtype not in DTYPE_IDS:
        raise TypeError(f"the CUDA kernel takes float32 or float64, not "
                        f"{dtype}")
    N = u0.shape[-1]
    if N < 1 or N >= 2 ** 31:
        raise ValueError(f"need 1 <= N < 2^31 lanes, got N={N}")
    checks = [("u0", u0, (fun.n, N)), ("p", p, (fun.k, N))]
    if table is not None:
        checks.append(("table", table, (n_steps, fun.m, N)))
    for what, x, shape in checks:
        if x.device != u0.device or x.dtype != dtype:
            raise ValueError(f"{what} must be a {dtype} tensor on {u0.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous with shape {shape} "
                             f"for {name}, got {tuple(x.shape)}")

    S = n_steps // save_every
    us = torch.empty((S, fun.n, N), dtype=dtype, device=u0.device)
    u_final = torch.empty((fun.n, N), dtype=dtype, device=u0.device)
    t_final = torch.empty((N,), dtype=dtype, device=u0.device)
    stats = torch.empty((6, N), dtype=torch.int32, device=u0.device)
    stream = torch.cuda.current_stream(u0.device).cuda_stream
    with torch.cuda.device(u0.device):
        entry = (_bind_unit(unit, event is not None, tables is not None)
                 if unit is not None
                 else _bind_data() if tables is not None
                 else _bind_event() if event is not None else _bind()[0])
        rc = entry(
            DTYPE_IDS[dtype], fun.id, STEPPER_IDS[method],
            int(table is not None), *ev, *(tables or ()), u0.data_ptr(),
            p.data_ptr(),
            table.data_ptr() if table is not None else None, N, n_steps,
            save_every, float(t0), float(dt), float(t0 + n_steps * dt), seed,
            lane_offset, us.data_ptr(), u_final.data_ptr(),
            t_final.data_ptr(), stats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sde_ensemble launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return us, u_final, t_final, stats


def _plain_normals(seed, step0, steps, rows, lanes, lane_offset, device):
    i64 = dict(dtype=torch.int64, device=device)
    step = torch.arange(step0, step0 + steps, **i64)[:, None, None]
    row = torch.arange(rows, **i64)[None, :, None]
    lane = ((torch.arange(lanes, **i64) + lane_offset) & M32)[None, None]
    shape = (steps, rows, lanes)
    words = torch.stack([w.expand(shape)
                         for w in counter_words(seed, step, lane, row)])
    return words, counter_normals_threefry(seed, step, lane, row).expand(shape)


def sde_normals(seed: int, step0: int, steps: int, rows: int, lanes: int, *,
                lane_offset: int = 0, device="cuda"):
    """The counter normals of the kernel's stream for a block of
    (step0 + s, row, lane_offset + lane), s < steps, row < rows,
    lane < lanes.  Returns the Threefry words (2, steps, rows, lanes) as
    int64 and the float32 normals (steps, rows, lanes).  On a CUDA device
    the kernel draws them; on the CPU the plain version
    (`repro_torch.kernels.rng`) does."""
    seed = check_u32("seed", seed)
    lane_offset = check_u32("lane_offset", lane_offset)
    total = steps * rows * lanes
    if min(steps, rows, lanes) < 1 or total >= 2 ** 31 or step0 < 0 \
            or step0 + steps > 2 ** 31:
        raise ValueError(f"need a non-empty block of < 2^31 elements with "
                         f"steps below 2^31, got ({step0}+{steps}, {rows}, "
                         f"{lanes})")
    device = torch.device(device)
    if device.type == "cpu":
        return _plain_normals(seed, step0, steps, rows, lanes, lane_offset,
                              device)
    if device.type != "cuda":
        raise ValueError(f"sde_normals runs on CPU or CUDA, not {device.type}")
    words = torch.empty((2, steps, rows, lanes), dtype=torch.int32,
                        device=device)
    z = torch.empty((steps, rows, lanes), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = _bind()[1](seed, int(step0), steps, rows, lanes, lane_offset,
                        words.data_ptr(), z.data_ptr(),
                        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sde_normals launch failed: CUDA error {rc}")
    global normals_launches
    normals_launches += 1
    return words.to(torch.int64) & M32, z


_UNITS: dict = {}


def generated_unit(f, g, method: str, fun: SDEFunctor, dtype, *, event=None,
                   data=None, hand=None):
    """The generated unit of K4 for `method` in `dtype` with the `Event`
    `event` and the dataset `data` (`fun`: the pair's sizes and noise): the
    pair (f, g) traced into one graph, with the derived gdg = (∂g/∂u)·g
    where the noise is diagonal; or, where `hand` names a registered
    functor, its hand-written struct."""
    from repro_torch.translate.units import sde_unit
    form = event_form(event, fun.n, fun.k)
    if hand is not None:
        key = (hand, method, dtype, form, data is not None)
        if key not in _UNITS:
            _UNITS[key] = sde_unit(None, None, fun.noise, None, method,
                                   dtype, hand_functor=SDE_FUNCTORS[hand].struct,
                                   event=form, data=data is not None)
        return _UNITS[key]
    tf, tg, gdg, _ = traced_pair(f, g, fun, data)
    key = (tf, tg, method, dtype, form)
    if key not in _UNITS:
        _UNITS[key] = sde_unit(tf, tg, fun.noise, gdg, method, dtype,
                               event=form, data=data is not None)
    return _UNITS[key]


def traced_pair(f, g, fun: SDEFunctor, data=None, ddb: bool = False):
    """(f, g, gdg, ddb) traced into one graph: gdg = (∂g/∂u)·g where the
    noise is diagonal and, where asked, the milstein pair's ddb =
    ∂((∂g)·g)·g, the derivative of gdg along g (the reference's nested
    JVP)."""
    from repro_torch.translate import derive
    from repro_torch.translate.trace import trace_pair
    g_out = (fun.n,) if fun.noise == "diagonal" else (fun.n, fun.m)
    tf, tg = trace_pair(f, g, fun.n, fun.k, f_outputs=(fun.n,),
                        g_outputs=g_out, data=data)
    if fun.noise != "diagonal":
        return tf, tg, None, None
    gdg = derive.jvp(tg, tg)
    return tf, tg, gdg, derive.jvp(gdg, tg) if ddb else None
