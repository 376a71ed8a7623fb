"""The trajectory work queue of the adaptive ensemble kernels
(csrc/trajectory_queue.cuh, kernels/queue.py), on the CPU: the divergence
measure on stats whose answer is known, and the K3 and K5 .cu sources
parsed against their wrappers — every C entry the wrappers bind takes the
arguments they pass, every instantiation they name is compiled, K5 takes
its trajectories from the queue and K3 runs one a thread."""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.em import adaptive as k5
from repro_torch.kernels.em import kernel as em_kernel
from repro_torch.kernels.queue import WARP, simt_efficiency
from repro_torch.kernels.rosenbrock import kernel as k3

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
C_TYPES = {"int": ctypes.c_int, "unsigned int": ctypes.c_uint,
           "double": ctypes.c_double, "long long": ctypes.c_longlong,
           "const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "const double*": ctypes.c_void_p, "const int*": ctypes.c_void_p,
           "const void* const*": ctypes.c_void_p}


# ---------------------------------------------------------------------------
# the SIMT efficiency
# ---------------------------------------------------------------------------

def test_simt_efficiency_is_one_on_equal_lanes():
    assert simt_efficiency(torch.full((4 * WARP,), 7)) == 1.0
    assert simt_efficiency(torch.zeros(3 * WARP, dtype=torch.int64)) == 1.0


def test_simt_efficiency_of_one_slow_lane_a_warp():
    """31 lanes of 1 attempt and one of 33 in each warp: 64 attempts
    against 32 · 33 slots."""
    a = torch.ones(2 * WARP, dtype=torch.int64)
    a[5] = a[WARP + 31] = 33
    assert simt_efficiency(a) == pytest.approx(64 / (32 * 33), abs=0)


def test_simt_efficiency_pads_the_last_warp_with_idle_lanes():
    """N = 40: a full warp of 2 attempts and 8 lanes of 4 in a warp of
    32 slots of 4."""
    a = torch.cat([torch.full((WARP,), 2), torch.full((8,), 4)])
    assert simt_efficiency(a) == pytest.approx((64 + 32) / (64 + 128),
                                               abs=0)


def test_simt_efficiency_against_a_loop_on_random_stats():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 200, size=1000)
    slots = 0
    for w in range(0, 1000, WARP):
        slots += WARP * int(a[w:w + WARP].max())
    assert simt_efficiency(torch.from_numpy(a)) == pytest.approx(
        a.sum() / slots, rel=1e-15)


# ---------------------------------------------------------------------------
# the .cu sources against their wrappers
# ---------------------------------------------------------------------------

def _entry(source, name):
    """(argument C types, body) of the extern "C" function `name`."""
    text = (CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)\s*\{(.*?)\n\}",
                  text, re.S)
    assert m, f"{name} not found in {source}"
    args = [re.sub(r"\s+", " ", a.strip()).rsplit(" ", 1)[0]
            .replace(" *", "*") for a in m.group(1).split(",")]
    return [C_TYPES[a] for a in args], m.group(2)


@pytest.mark.parametrize("event,data,name", [
    (False, False, "sde_adaptive_launch"),
    (True, False, "sde_adaptive_event_launch"),
    (False, True, "sde_adaptive_data_launch")])
def test_k5_c_entries_take_what_the_wrapper_passes(event, data, name):
    args, _ = _entry(k5.SOURCE, name)
    assert args == k5.argtypes(event, data)


@pytest.mark.parametrize("event,data,name", [
    (False, False, "rosenbrock_ensemble_launch"),
    (True, False, "rosenbrock_ensemble_event_launch"),
    (False, True, "rosenbrock_ensemble_data_launch")])
def test_k3_c_entries_take_what_the_wrapper_passes(event, data, name):
    args, _ = _entry(k3.SOURCE, name)
    assert args == k3.argtypes(event, data)


def _k5_text():
    """K5's source and its body (`sde_adaptive_body.cuh`)."""
    return "".join((CSRC / f).read_text()
                   for f in (k5.SOURCE, "sde_adaptive_body.cuh"))


def test_k5_takes_trajectories_from_the_queue():
    text = _k5_text()
    assert '#include "trajectory_queue.cuh"' in text
    assert "repro_queue::next(queue)" in text
    assert "repro_queue::persistent_grid(" in text
    assert k5.argtypes()[-2:] == [ctypes.c_void_p, ctypes.c_void_p]


def test_k3_runs_one_trajectory_a_thread():
    """No K3 row measured a SIMT efficiency below 0.95 (PERF.md §6, PR
    20), so K3 takes no queue: its entries take no counter word."""
    text = "".join((CSRC / f).read_text()
                   for f in (k3.SOURCE, "rosenbrock_body.cuh"))
    assert "#include \"trajectory_queue.cuh\"" not in text
    assert "void* queue" not in text
    assert "blockIdx.x * blockDim.x + threadIdx.x" in text


def _function(text, head):
    body = text[text.index(head):]
    return body[:body.index("\n}\n")]


def test_k3_instantiations_are_the_wrappers():
    text = (CSRC / k3.SOURCE).read_text()
    tabs = _function(text, "int by_tableau(")
    assert {int(c) for c in re.findall(r"case (\d+):", tabs)} \
        == set(k3.TABLEAU_IDS.values())
    rhs = _function(text, "int by_rhs(")
    named = dict(re.findall(r"case (\d+): return launch<T, Tab, (\w+),", rhs))
    no_data = {k: v for k, v in k3.STIFF_FUNCTORS.items()
               if k not in k3.DATA_LAYOUTS}
    assert {int(i) for i in named} == {v[0] for v in no_data.values()}
    events = _function(text, "int by_event(")
    pairs = set(re.findall(r"rhs_id == (\d+) && event_id == ev::(\w+)::",
                           events))
    ids = {v[0]: k for k, v in k3.STIFF_FUNCTORS.items()}
    assert {(ids[int(r)], e) for r, e in pairs} == {
        (r, "".join(w.title() for w in e.split("_")))
        for r, e in k3.EVENT_PAIRS}
    data = _function(text, "int by_data(")
    assert f"rhs_id != {k3.STIFF_FUNCTORS['forced_osc'][0]}" in data
    assert {int(c) for c in re.findall(r"case (\d+):", data)} \
        == set(k3.TABLEAU_IDS.values())


def test_k5_instantiations_are_the_wrappers():
    text = (CSRC / k5.SOURCE).read_text()
    method = _function(text, "int by_method(")
    assert f"est_id == {k5.ESTIMATOR_IDS['embedded']}" in method
    assert f"est_id != {k5.ESTIMATOR_IDS['doubling']}" in method
    steppers = {int(x) for x in re.findall(r"stepper_id == (\d+)", method)}
    steppers |= {int(x) for x in re.findall(r"case (\d+): return launch",
                                            method)}
    assert steppers == set(em_kernel.STEPPER_IDS.values())
    problems = _function(text, "int by_problem(")
    ids = {int(x) for x in re.findall(r"case (\d+): return by_method",
                                      problems)}
    data = _function(text, "int by_data(")
    ids |= {int(x) for x in re.findall(r"prob_id == (\d+)", data)}
    assert ids == {f.id for f in em_kernel.SDE_FUNCTORS.values()}


def test_k5_draws_w_at_t_once_a_trajectory():
    """Node 0 of the tree, W(T), is drawn where a trajectory starts, not in
    every descent."""
    text = _k5_text()
    assert len(re.findall(r"bridge_normal\(\s*seed, 0u,", text)) == 1
    descent = _function(text, "__device__ __forceinline__ void bridge_points(")
    assert "bridge_normal(seed, 0u" not in descent
