"""The automated translation's tracer, IR and derivatives on the CPU
(`repro_torch.translate`): every f, g and Jacobian of the port's problem
catalogue, the reference quickstart's inline Lorenz and Van der Pol, and
the reference kernel test's time-dependent stiff RHS traced; `evaluate`
bitwise to the traced function in f32 and f64; the derived Jacobian, ∂f/∂t
and (∂g/∂u)·g against `torch.func`; CSE on the CRN pair; the refusals."""
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import de_problems as dp
from repro_torch.translate import derive
from repro_torch.translate.ir import evaluate
from repro_torch.translate.trace import trace, trace_pair

F32, F64 = torch.float32, torch.float64


def quickstart_lorenz(u, p, t):
    """examples/quickstart.py's inline Lorenz, in PyTorch."""
    s, r, b = p[0], p[1], p[2]
    return torch.stack([s * (u[1] - u[0]),
                        r * u[0] - u[1] - u[0] * u[2],
                        u[0] * u[1] - b * u[2]])


def quickstart_vdp(u, p, t):
    return torch.stack([u[1], p[0] * ((1.0 - u[0] ** 2) * u[1]) - u[0]])


def cos_stiff(u, p, t):
    """tests/test_kernels.py's time-dependent stiff RHS."""
    return torch.stack([-p[0] * (u[0] - torch.cos(t))])


def many_ops(u, p, t):
    """Every op of the translator once."""
    return torch.stack([
        u[0] ** 2 + u[1] ** 3 - u[0] ** 0.5 + u[1] ** -1 - u[0] ** -2,
        u[1] ** -0.5 + u[0] / 3.0 + 3.0 / u[1] + u[0] ** 2.5,
        torch.exp(-u[0]) * torch.log(u[1]) + torch.sin(u[0] * t)
        - torch.cos(u[1]) + torch.tanh(u[0]) + torch.sqrt(u[1]),
        torch.maximum(u[0], u[1]) - torch.minimum(u[0], p[0])
        + torch.clamp_min(u[0] - 0.5, 0.0) + torch.clamp_max(u[1], 1.5)
        + torch.abs(u[0] - 1.0) + u[0] ** p[0] + torch.reciprocal(u[1]),
        torch.where(u[0] > u[1], u[0] * u[1], 1.0 - u[0]) + (2 - u[1])
        + torch.where(u[1] <= 0.7, -u[1], torch.zeros_like(u[1])),
    ])


def diff_ops(u, p, t):
    """The ops the derivatives take."""
    return torch.stack([
        u[0] ** 2 + u[1] ** 3 - u[0] ** 0.5 + u[1] ** -1 - u[0] ** -2,
        u[1] ** -0.5 + u[0] / 3.0 + 3.0 / u[1] + u[0] ** 2.5,
        torch.exp(-u[0]) * torch.log(u[1]) + torch.sin(u[0] * t)
        - torch.cos(u[1]) + torch.sqrt(u[1]) + u[0] ** p[0],
        torch.clamp_min(u[0] - 0.5, 0.0) + torch.clamp_max(u[1], 1.5)
        + torch.reciprocal(u[1]) + (2 - u[1]) * t,
        torch.where(u[0] > u[1], u[0] * u[1], 1.0 - u[0])
        + torch.where(u[1] <= 0.7, -u[1], torch.zeros_like(u[1])),
    ])


def ramp_like(u, p, t):
    return torch.ones_like(u) * p[0] + (u - 0.1) * 0.0


# (function, n, m, output shape)
FUNCTIONS = {
    "lorenz": (dp.lorenz_rhs, 3, 3, (3,)),
    "ball": (dp.bouncing_ball_rhs, 2, 2, (2,)),
    "vdp": (dp.vdp_rhs, 2, 1, (2,)),
    "rober": (dp.rober_rhs, 3, 3, (3,)),
    "rober_jac": (dp.rober_jac, 3, 3, (3, 3)),
    "orego": (dp.orego_rhs, 3, 3, (3,)),
    "decay": (dp.linear_decay_rhs, 1, 1, (1,)),
    "sho": (dp.sho_rhs, 2, 1, (2,)),
    "gbm_drift": (dp.gbm_drift, 3, 2, (3,)),
    "gbm_diffusion": (dp.gbm_diffusion, 3, 2, (3,)),
    "ramp_drift": (dp.ramp_drift, 1, 2, (1,)),
    "ramp_diffusion": (dp.ramp_diffusion, 1, 2, (1,)),
    "crn_drift": (dp.crn_drift, 4, 6, (4,)),
    "crn_diffusion": (dp.crn_diffusion, 4, 6, (4, 8)),
    "quickstart_lorenz": (quickstart_lorenz, 3, 3, (3,)),
    "quickstart_vdp": (quickstart_vdp, 2, 1, (2,)),
    "cos_stiff": (cos_stiff, 1, 1, (1,)),
    "many_ops": (many_ops, 2, 1, (5,)),
    "diff_ops": (diff_ops, 2, 1, (5,)),
    "ramp_like": (ramp_like, 2, 1, (2,)),
}
# the ODE right-hand sides the stiff kernel may differentiate
DIFFERENTIABLE = ("lorenz", "ball", "vdp", "rober", "orego", "decay", "sho",
                  "quickstart_lorenz", "quickstart_vdp", "cos_stiff",
                  "diff_ops")


def inputs(n, m, dtype, B=97, seed=0, lanes=True):
    rng = np.random.default_rng(seed)
    shape = (B,) if lanes else ()
    u = rng.uniform(0.05, 2.0, (n,) + shape)
    p = rng.uniform(0.5, 4.0, (m,) + shape)
    t = rng.uniform(0.0, 3.0, shape)
    as_t = lambda x: torch.tensor(x, dtype=dtype)
    return as_t(u), as_t(p), as_t(t)


@pytest.mark.parametrize("lanes", [True, False], ids=["lanes", "one"])
@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_evaluate_is_the_traced_function_bit_for_bit(name, dtype, lanes):
    fn, n, m, shape = FUNCTIONS[name]
    traced = trace(fn, n, m, outputs=shape)
    assert traced.shape == shape
    u, p, t = inputs(n, m, dtype, lanes=lanes)
    want = fn(u, p, t)
    got = evaluate(traced, u, p, t)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


def test_trace_is_cached_per_function_weakly():
    f = lambda u, p, t: torch.stack([-p[0] * u[0]])  # noqa: E731
    a = trace(f, 1, 1, outputs=(1,))
    assert trace(f, 1, 1, outputs=(1,)) is a
    assert trace(f, 1, 2, outputs=(1,)) is not a
    from repro_torch.translate import trace as tr
    before = len(tr._CACHE)
    del f, a
    gc.collect()
    assert len(tr._CACHE) == before - 1


def test_hash_consing_shares_the_crn_hill_term():
    """CRN's drift and diffusion compute (S sig)^n / ((S sig)^n + (D
    A3)^n + 1) three times between them: one node, two pow nodes in all."""
    f, g = trace_pair(dp.crn_drift, dp.crn_diffusion, 4, 6,
                      f_outputs=(4,), g_outputs=(4, 8))
    graph = f.graph
    pows = [i for i in graph.reachable(f.outputs + g.outputs)
            if graph.nodes[i].op == "pow"]
    assert len(pows) == 2
    from repro_torch.translate.emit import shared_nodes
    shared = shared_nodes(f, g)
    assert set(pows) <= set(shared)
    assert {graph.nodes[i].op for i in shared} == {"mul", "pow", "add",
                                                   "add_s", "div"}


def _jacfwd(fn, u, p, t):
    return torch.func.vmap(torch.func.jacfwd(fn), in_dims=(-1, -1, 0))(
        u, p, t).movedim(0, -1)


@pytest.mark.parametrize("name", DIFFERENTIABLE)
def test_derived_jacobian_and_time_derivative_match_torch_func(name):
    """f64: bitwise to `torch.func.jacfwd` and `jvp` along t.  In f32
    PyTorch's forward mode computes some tangents in f64 (a Python scalar
    against a 0-d primal promotes the tangent, e.g. OREGO's (1 + y1) y2),
    so f32 holds within 4 f32 ulps of the f64 derivative."""
    fn, n, m, shape = FUNCTIONS[name]
    traced = trace(fn, n, m, outputs=shape)
    J, dT = derive.jacobian(traced), derive.time_derivative(traced)
    assert J.shape == (shape[0], n) and dT.shape == shape
    u, p, t = inputs(n, m, F64)
    want_j = _jacfwd(fn, u, p, t)
    want_t = torch.func.jvp(lambda tt: fn(u, p, tt), (t,),
                            (torch.ones_like(t),))[1]
    assert torch.equal(evaluate(J, u, p, t), want_j), name
    assert torch.equal(evaluate(dT, u, p, t), want_t), name
    u32, p32, t32 = (x.float() for x in (u, p, t))
    got = evaluate(J, u32, p32, t32).double()
    scale = want_j.abs().clamp_min(1e-30)
    assert float(((got - want_j).abs() / scale).max()) <= 4 * 2.0 ** -23 \
        or float((got - want_j).abs().max()) <= 4 * 2.0 ** -23 * float(
            want_j.abs().max())


def test_derived_rober_jacobian_is_the_analytic_one():
    traced = trace(dp.rober_rhs, 3, 3, outputs=(3,))
    J = derive.jacobian(traced)
    for dtype in (F64, F32):
        u, p, t = inputs(3, 3, dtype, seed=3)
        p = p * torch.tensor([[0.01], [3e7], [1e4]], dtype=dtype)
        assert torch.equal(evaluate(J, u, p, t), dp.rober_jac(u, p, t))


@pytest.mark.parametrize("name", ["gbm_diffusion", "ramp_diffusion"])
def test_derived_gdg_is_torch_func_jvp(name):
    """Milstein's (∂g/∂u)·g: `jvp(g, along=g)` against `torch.func.jvp`
    along g(u), as `core.sde.milstein_step` takes it, and against the
    hand-written functor's p² u."""
    fn, n, m, shape = FUNCTIONS[name]
    traced = trace(fn, n, m, outputs=shape)
    gdg = derive.jvp(traced, traced)
    for dtype in (F64, F32):
        u, p, t = inputs(n, m, dtype)
        want = torch.func.jvp(lambda uu: fn(uu, p, t), (u,),
                              (fn(u, p, t),))[1]
        got = evaluate(gdg, u, p, t)
        assert torch.equal(got, want)
        assert torch.equal(got, p[1] * (p[1] * u))


def test_derived_jvp_of_a_nonlinear_diffusion():
    g = lambda u, p, t: torch.stack([p[0] * torch.sqrt(u[0]),  # noqa: E731
                                     torch.sin(u[1]) * u[0] / 3.0])
    traced = trace(g, 2, 1, outputs=(2,))
    u, p, t = inputs(2, 1, F64)
    want = torch.func.jvp(lambda uu: g(uu, p, t), (u,), (g(u, p, t),))[1]
    assert torch.equal(evaluate(derive.jvp(traced, traced), u, p, t), want)


REFUSED = {
    "python if on the data": (lambda u, p, t: torch.stack(
        [u[0] if u[0] > 0 else -u[0]]), "torch.where"),
    "an unlisted op": (lambda u, p, t: torch.stack([torch.erf(u[0])]),
                       "torch.erf"),
    "a tensor constant": (lambda u, p, t: torch.stack(
        [u[0] * torch.tensor(2.0)]), "tensor constant"),
    "a tensor method": (lambda u, p, t: torch.stack([u[0].sigmoid()]),
                        "sigmoid"),
    "a wrong output shape": (lambda u, p, t: torch.stack([u[0], u[0]]),
                             r"shape \(1,\)"),
    "an unstacked output": (lambda u, p, t: -u[0], "shape"),
    "a comparison as a value": (lambda u, p, t: torch.stack(
        [(u[0] > 0) * u[0]]), "comparison"),
    "a vector comparison as a value": (lambda u, p, t: (u > 0) * u,
                                       "comparison"),
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_untraceable_functions_raise_naming_item_17(what):
    fn, match = REFUSED[what]
    with pytest.raises(NotImplementedError, match=match) as err:
        trace(fn, 1, 1, outputs=(1,))
    assert "item 17" in str(err.value)


def test_derivative_refusals():
    f = lambda u, p, t: torch.stack([u[0] ** u[1], u[1]])  # noqa: E731
    with pytest.raises(NotImplementedError, match="exponent"):
        derive.jacobian(trace(f, 2, 1, outputs=(2,)))
    h = lambda u, p, t: torch.stack([torch.tanh(u[0])])  # noqa: E731
    with pytest.raises(NotImplementedError, match="analytic Jacobian"):
        derive.jacobian(trace(h, 1, 1, outputs=(1,)))
