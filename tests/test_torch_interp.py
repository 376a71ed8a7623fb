"""The port's dataset lookups (`repro_torch.core.interp`) against the
reference's (`repro.core.interp`), on the same numpy inputs, in float64:
the cases of tests/test_interp.py, each held bit for bit in gather and
cubic mode and within 1e-15 in onehot mode (a matmul that may sum in
another order), plus the reference's own property.  Then the forward
tangent at the table's ends against `jax.jvp` (JAX's clip passes half the
tangent on a bound, torch.clamp all of it), the autograd gradient, and the
pytree helpers' leaf order and signatures.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import interp as R
from repro_torch.core import interp as P

MODES = ("gather", "onehot", "cubic")


def tol(mode):
    return 1e-15 if mode == "onehot" else 0.0


def tables1(fn, K=33, x0=-2.0, dx=0.25):
    xs = x0 + dx * np.arange(K)
    v = fn(xs)
    return (R.UniformTable1D(jnp.asarray(v), x0, dx),
            P.UniformTable1D(torch.tensor(v), x0, dx), xs)


def tables2(V, x0, dx, y0, dy):
    return (R.UniformTable2D(jnp.asarray(V), x0, dx, y0, dy),
            P.UniformTable2D(torch.tensor(V), x0, dx, y0, dy))


def both1(rt, pt, q, mode):
    a = np.asarray(R.interp1d(rt, jnp.asarray(q), mode))
    b = P.interp1d(pt, torch.tensor(q), mode).numpy()
    np.testing.assert_allclose(b, a, rtol=tol(mode), atol=tol(mode))
    return b


def both2(rt, pt, qx, qy, mode):
    a = np.asarray(R.interp2d(rt, jnp.asarray(qx), jnp.asarray(qy), mode))
    b = P.interp2d(pt, torch.tensor(qx), torch.tensor(qy), mode).numpy()
    np.testing.assert_allclose(b, a, rtol=tol(mode), atol=tol(mode))
    return b


@pytest.mark.parametrize("mode", MODES)
def test_exact_at_nodes(mode):
    rt, pt, xs = tables1(np.sin)
    np.testing.assert_allclose(both1(rt, pt, xs, mode), np.sin(xs),
                               atol=1e-12)


@pytest.mark.parametrize("mode", ["gather", "onehot"])
def test_linear_function_exact_everywhere(mode):
    rt, pt, _ = tables1(lambda x: 3.0 * x - 1.0)
    q = np.linspace(-2.0, 6.0 - 1e-6, 57)
    np.testing.assert_allclose(both1(rt, pt, q, mode), 3.0 * q - 1.0,
                               atol=1e-10)


@pytest.mark.parametrize("mode", MODES)
def test_clamped_boundaries(mode):
    rt, pt, xs = tables1(np.sin)
    lo, hi = both1(rt, pt, np.array([-100.0, 100.0]), mode)
    np.testing.assert_allclose(lo, np.sin(-2.0), atol=1e-12)
    np.testing.assert_allclose(hi, np.sin(xs[-1]), atol=1e-12)


def test_gather_equals_onehot_1d():
    rt, pt, _ = tables1(np.cos, K=17, x0=-1.0, dx=0.5)
    q = np.random.default_rng(0).uniform(-10.0, 10.0, 64)
    np.testing.assert_allclose(both1(rt, pt, q, "gather"),
                               both1(rt, pt, q, "onehot"), atol=1e-12)


@pytest.mark.parametrize("mode", ["gather", "onehot"])
def test_bilinear_2d_exact_on_bilinear_fn(mode):
    K = 9
    x0, dx, y0, dy = 0.0, 0.5, -1.0, 0.25
    xs, ys = x0 + dx * np.arange(K), y0 + dy * np.arange(K)
    V = 2.0 * xs[:, None] + 3.0 * ys[None, :] + 0.5 * xs[:, None] * ys[None]
    rt, pt = tables2(V, x0, dx, y0, dy)
    qx, qy = np.linspace(0.0, 3.99, 23), np.linspace(-1.0, 0.99, 23)
    np.testing.assert_allclose(both2(rt, pt, qx, qy, mode),
                               2 * qx + 3 * qy + 0.5 * qx * qy, atol=1e-10)


def test_gather_equals_onehot_2d():
    xs = np.arange(7) * 0.5
    rt, pt = tables2(np.sin(xs[:, None]) * np.cos(xs[None, :]), 0.0, 0.5,
                     0.0, 0.5)
    rng = np.random.default_rng(1)
    qx, qy = rng.uniform(-5.0, 10.0, 64), rng.uniform(-5.0, 5.0, 64)
    np.testing.assert_allclose(both2(rt, pt, qx, qy, "gather"),
                               both2(rt, pt, qx, qy, "onehot"), atol=1e-12)


def test_cubic_exact_at_nodes():
    rt, pt, xs = tables1(np.sin)
    np.testing.assert_allclose(both1(rt, pt, xs, "cubic"), np.sin(xs),
                               atol=1e-12)


def test_cubic_reproduces_quadratics():
    rt, pt, _ = tables1(lambda x: 0.5 * x * x - 2.0 * x + 1.0)
    q = np.linspace(-2.0 + 0.25, 6.0 - 0.5, 91)
    np.testing.assert_allclose(both1(rt, pt, q, "cubic"),
                               0.5 * q ** 2 - 2.0 * q + 1.0, atol=1e-10)


def test_cubic_clamp_matches_linear_clamp():
    rt, pt, _ = tables1(np.sin)
    q = np.array([-100.0, 100.0])
    np.testing.assert_allclose(both1(rt, pt, q, "cubic"),
                               both1(rt, pt, q, "gather"), atol=1e-12)


def test_cubic_continuous_across_cells():
    rt, pt, xs = tables1(np.sin, K=17, x0=0.0, dx=0.5)
    for k in (3, 8, 12):
        lo, hi = both1(rt, pt, np.array([xs[k] - 1e-9, xs[k] + 1e-9]),
                       "cubic")
        np.testing.assert_allclose(lo, hi, atol=1e-7)


@pytest.mark.parametrize("mode", MODES)
def test_2d_modes_match_reference_on_random_queries(mode):
    """The reference's biquadratic cubic case, and every 2-D mode on queries
    inside, outside and on the grid."""
    K = 13
    x0, dx, y0, dy = 0.0, 0.5, -1.0, 0.25
    xs, ys = x0 + dx * np.arange(K), y0 + dy * np.arange(K)
    V = 0.3 * xs[:, None] ** 2 + 2.0 * ys[None] ** 2 - xs[:, None] * ys[None]
    rt, pt = tables2(V, x0, dx, y0, dy)
    if mode == "cubic":
        qx = np.linspace(x0 + dx, x0 + (K - 2.5) * dx, 17)
        qy = np.linspace(y0 + dy, y0 + (K - 2.5) * dy, 17)
        np.testing.assert_allclose(both2(rt, pt, qx, qy, mode),
                                   0.3 * qx ** 2 + 2.0 * qy ** 2 - qx * qy,
                                   atol=1e-9)
    rng = np.random.default_rng(2)
    qx = np.concatenate([rng.uniform(-2.0, 8.0, 200), xs, [x0, xs[-1]]])
    qy = np.concatenate([rng.uniform(-3.0, 3.0, 200), ys, [ys[-1], y0]])
    both2(rt, pt, qx, qy, mode)


@pytest.mark.parametrize("mode", MODES)
def test_grad_flows_to_table_values(mode):
    """d interp1d / d values by autograd equals the reference's jax.grad."""
    rt, pt, _ = tables1(np.sin, K=17, x0=0.0, dx=0.5)
    q = np.array([0.3, 2.71, 7.9, 0.0, 8.0])

    def loss_r(vals):
        return jnp.sum(R.interp1d(R.UniformTable1D(vals, 0.0, 0.5),
                                  jnp.asarray(q), mode) ** 2)

    g_r = np.asarray(jax.grad(loss_r)(rt.values))
    vals = pt.values.clone().requires_grad_(True)
    loss = torch.sum(P.interp1d(P.UniformTable1D(vals, 0.0, 0.5),
                                torch.tensor(q), mode) ** 2)
    loss.backward()
    np.testing.assert_allclose(vals.grad.numpy(), g_r, rtol=1e-14,
                               atol=1e-15)


def test_interp_inside_ode_rhs():
    """A drag table consumed inside the RHS: the port's fixed-step solve
    with gather and onehot lookups, against the reference's."""
    from repro.core import get_tableau as r_tab
    from repro.core import solve_fixed as r_fixed
    from repro_torch.core import get_tableau as p_tab
    from repro_torch.core import solve_fixed as p_fixed
    rt, pt, _ = tables1(lambda x: 0.1 * np.sin(x), K=65, x0=0.0, dx=0.25)
    out = {}
    for mode in ("gather", "onehot"):
        rr = r_fixed(lambda u, p, t, m=mode: jnp.stack(
            [u[1], -9.8 - R.interp1d(rt, u[0], m) * u[1]]), r_tab("tsit5"),
            jnp.asarray([10.0, 0.0]), jnp.zeros(1), 0.0, 0.01, 100,
            save_every=100)
        rp = p_fixed(lambda u, p, t, m=mode: torch.stack(
            [u[1], -9.8 - P.interp1d(pt, u[0], m) * u[1]]), p_tab("tsit5"),
            torch.tensor([10.0, 0.0], dtype=torch.float64),
            torch.zeros(1, dtype=torch.float64), 0.0, 0.01, 100,
            save_every=100)
        np.testing.assert_allclose(rp.u_final.numpy(),
                                   np.asarray(rr.u_final), rtol=1e-13)
        out[mode] = rp.u_final.numpy()
    np.testing.assert_allclose(out["gather"], out["onehot"], rtol=1e-10)


# ---------------------------------------------------------------------------
# the forward tangent: JAX's tie rule at the table's ends
# ---------------------------------------------------------------------------

def forced_table():
    xs = np.linspace(0.0, 10.0, 65)
    return tables1(lambda x: np.sin(1.3 * x) + 0.5 * np.cos(0.4 * x),
                   K=65, x0=0.0, dx=float(xs[1] - xs[0]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("where", ["first knot", "last knot", "inside a cell",
                                   "on an inner knot", "below the grid",
                                   "above the grid"])
def test_tangent_matches_jax_jvp(mode, where):
    rt, pt, xs = forced_table()
    t = {"first knot": 0.0, "last knot": 10.0, "inside a cell": 3.3,
         "on an inner knot": float(xs[7]), "below the grid": -0.5,
         "above the grid": 10.5}[where]
    want = float(jax.jvp(lambda tt: R.interp1d(rt, tt, mode),
                         (jnp.asarray(t),), (jnp.asarray(1.0),))[1])
    got = float(torch.func.jvp(lambda tt: P.interp1d(pt, tt, mode),
                               (torch.tensor(t, dtype=torch.float64),),
                               (torch.tensor(1.0, dtype=torch.float64),))[1])
    # onehot's tangent is a matmul too, of terms near |v| / dx ~ 10 that
    # cancel: two ulps of those
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4e-15 if mode == "onehot" else 0)


def test_tangent_is_half_the_slope_on_the_bounds():
    """On the first and the last knot the clamp passes half the tangent,
    as jnp.clip does; torch.clamp alone would pass all of it."""
    rt, pt, xs = forced_table()
    v = pt.values.numpy()
    dx = float(xs[1] - xs[0])
    for t, slope in ((0.0, (v[1] - v[0]) / dx), (10.0, (v[-1] - v[-2]) / dx)):
        got = float(torch.func.jvp(lambda tt: P.interp1d(pt, tt),
                                   (torch.tensor(t, dtype=torch.float64),),
                                   (torch.tensor(1.0,
                                                 dtype=torch.float64),))[1])
        np.testing.assert_allclose(got, 0.5 * slope, rtol=1e-12)
    # a test clip of slope 2: JAX gives 1 on the bound, torch.clamp 2
    x = torch.tensor(0.0, dtype=torch.float64)
    _, t_clip = torch.func.jvp(lambda s: P._Clip.apply(2.0 * s, 0.0, 1.0),
                               (x,), (torch.ones_like(x),))
    _, t_clamp = torch.func.jvp(lambda s: torch.clamp(2.0 * s, 0.0, 1.0),
                                (x,), (torch.ones_like(x),))
    j = jax.jvp(lambda s: jnp.clip(2.0 * s, 0.0, 1.0), (jnp.asarray(0.0),),
                (jnp.asarray(1.0),))[1]
    assert float(t_clip) == float(j) == 1.0 and float(t_clamp) == 2.0


def test_lookups_batch_under_vmap_and_jvp():
    """`torch.func.vmap` of a lookup and of its tangent: the port's vmap
    strategies run the RHS under it."""
    rt, pt, _ = forced_table()
    q = torch.tensor([0.0, 1.7, 10.0, 12.0], dtype=torch.float64)
    for mode in MODES:
        direct = P.interp1d(pt, q, mode)
        assert torch.equal(torch.func.vmap(
            lambda t: P.interp1d(pt, t, mode))(q), direct)
        tang = torch.func.vmap(lambda t: torch.func.jvp(
            lambda s: P.interp1d(pt, s, mode), (t,),
            (torch.ones_like(t),))[1])(q)
        want = jax.vmap(lambda t: jax.jvp(
            lambda s: R.interp1d(rt, s, mode), (t,),
            (jnp.ones_like(t),))[1])(jnp.asarray(q.numpy()))
        np.testing.assert_array_equal(tang.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# pytree helpers
# ---------------------------------------------------------------------------

def nested_data(pkg, mk):
    T1, T2 = pkg.UniformTable1D, pkg.UniformTable2D
    return {"zeta": T1(mk(np.arange(5.0)), 0.0, 1.0),
            "alpha": {"b": T2(mk(np.ones((3, 4))), 0.0, 1.0, 0.0, 2.0),
                      "a": T1(mk(np.arange(7.0, dtype=np.float32)), 1.0,
                              0.5)},
            "mid": [T1(mk(np.zeros(2)), 0.0, 1.0), None]}


def test_data_flatten_order_and_signature_match_the_reference():
    rd = nested_data(R, jnp.asarray)
    pd = nested_data(P, torch.tensor)
    r_leaves, _ = R.data_flatten(rd)
    p_leaves, tree = P.data_flatten(pd)
    assert [tuple(x.shape) for x in p_leaves] == \
        [tuple(x.shape) for x in r_leaves]
    for a, b in zip(r_leaves, p_leaves):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert P.data_signature(pd) == R.data_signature(rd)
    assert P.data_signature(pd) == "7float32+3x4float64+2float64+5float64"
    assert P.data_words(pd) == R.data_words(rd) == 26
    assert P.data_signature(None) == "none" == R.data_signature(None)
    assert P.data_signature({}) == "empty" == R.data_signature({})
    back = P.data_unflatten(tree, [x * 2 for x in p_leaves])
    assert isinstance(back["alpha"]["b"], P.UniformTable2D)
    assert back["alpha"]["b"].dy == 2.0 and back["mid"][1] is None
    assert torch.equal(back["zeta"].values, pd["zeta"].values * 2)


def test_forced_oscillator_signature_matches_the_reference():
    from repro.configs.de_problems import forced_oscillator_problem as rfo
    from repro_torch.configs.de_problems import forced_oscillator_problem
    assert P.data_signature(forced_oscillator_problem().data) == \
        R.data_signature(rfo().data) == "65float64"
