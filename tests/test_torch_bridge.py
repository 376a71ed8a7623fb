"""The port's virtual Brownian tree (`repro_torch.kernels.rng`
`bridge_words`, `bridge_normals`, `brownian_bridge_point`) against the
reference's (`repro.kernels.rng`), and its properties.

Bars: Threefry words bitwise; float32 Box–Muller normals within 4.77e-7
(XLA-CPU's and PyTorch's float32 log and cos differ by a few ulps,
tests/test_torch_rng.py); with the reference's normals substituted, W
bitwise equal at depth 14, since both round every operation on its own
(the port with a correctly rounded sqrt, `rng.sqrt_rn`).  The properties
are the port's versions of tests/test_bridge_props.py and of
tests/test_adaptive_sde.py's bridge tests, at small sizes.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rng as jrng
from repro_torch.kernels import rng as trng

pytest.importorskip(
    "hypothesis",
    reason="optional property-test dependency (requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
NORMAL_TOL = 4.77e-7
_ref_normals = jax.jit(jrng.bridge_normals, static_argnums=(0,))


def ref_normals(seed, node, lane, row, dtype=torch.float32):
    """The reference's float32 bridge normals of the port's int64 index
    tensors, cast to `dtype` as the port casts its own."""
    shape = torch.broadcast_shapes(node.shape, lane.shape, row.shape)
    args = [jnp.asarray(x.expand(shape).numpy().astype(np.uint32))
            for x in (node, lane, row)]
    return torch.from_numpy(np.array(_ref_normals(seed, *args))).to(dtype)


def random_indices(K, seed=0, node_hi=2 ** 32):
    rng = np.random.default_rng(seed)
    node = rng.integers(0, node_hi, K, dtype=np.uint64)
    lane = rng.integers(0, 2 ** 32, K, dtype=np.uint64)
    lane[:8] = 2 ** 32 - 1 - np.arange(8)           # the top of the range
    row = rng.integers(0, 16, K, dtype=np.uint64)
    return node, lane, row


def t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_bridge_words_bitwise_on_random_counters():
    """Random (seed, node, lane, row), lanes up to 2^32 - 1 and node
    counters node * 0x9E3779B9 + row that wrap 2^32."""
    node, lane, row = random_indices(8192)
    assert (lane >= 2 ** 31).any()
    for seed in (0, 7, 2 ** 32 - 1):
        c0 = ((node * 0x9E3779B9) % 2 ** 32 + row) % 2 ** 32
        want = jrng.threefry2x32(jnp.uint32(seed), jnp.uint32(0x85A308D3),
                                 jnp.asarray(c0.astype(np.uint32)),
                                 jnp.asarray(lane.astype(np.uint32)))
        got = trng.bridge_words(seed, t64(node), t64(lane), t64(row))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(w).astype(np.int64))


def test_bridge_normals_within_float32_rounding():
    node, lane, row = random_indices(2 ** 16, seed=1)
    args = [jnp.asarray(x.astype(np.uint32)) for x in (node, lane, row)]
    want = np.asarray(jrng.bridge_normals(11, *args, dtype=jnp.float64))
    got = trng.bridge_normals(11, t64(node), t64(lane), t64(row),
                              torch.float64).numpy()
    assert np.isfinite(got).all()
    assert np.max(np.abs(got - want)) <= NORMAL_TOL


@pytest.mark.parametrize("depth", [1, 6, 14])
def test_bridge_point_bitwise_with_the_reference_normals(monkeypatch, depth):
    monkeypatch.setattr(trng, "bridge_normals", ref_normals)
    rng = np.random.default_rng(depth)
    K = 4096
    idx = rng.integers(0, 2 ** depth + 1, K)
    idx[:2] = (0, 2 ** depth)
    lane = rng.integers(0, 2 ** 32, K)
    row = rng.integers(0, 3, K)
    want = np.asarray(jrng.brownian_bridge_point(
        7, jnp.asarray(idx.astype(np.uint32)),
        jnp.asarray(lane.astype(np.uint32)),
        jnp.asarray(row.astype(np.uint32)), depth=depth, t_total=1.0,
        dtype=jnp.float64))
    got = trng.brownian_bridge_point(7, t64(idx), t64(lane), t64(row),
                                     depth=depth, t_total=1.0,
                                     dtype=torch.float64).numpy()
    np.testing.assert_array_equal(got, want)


def test_bridge_point_on_its_own_stream_close_to_the_reference():
    """Without the substitution the normals differ by float32 ulps, and W
    by as little: at most the sum over the levels of sqrt(h)/2 times the
    normals' bar."""
    rng = np.random.default_rng(3)
    D, K = 12, 2048
    idx, lane = rng.integers(0, 2 ** D + 1, K), rng.integers(0, 2 ** 32, K)
    want = np.asarray(jrng.brownian_bridge_point(
        5, jnp.asarray(idx.astype(np.uint32)),
        jnp.asarray(lane.astype(np.uint32)), jnp.zeros(K, jnp.uint32),
        depth=D, t_total=2.0, dtype=jnp.float64))
    got = trng.brownian_bridge_point(5, t64(idx), t64(lane),
                                     torch.zeros(K, dtype=torch.int64),
                                     depth=D, t_total=2.0,
                                     dtype=torch.float64).numpy()
    bound = NORMAL_TOL * (np.sqrt(2.0) + sum(0.5 * np.sqrt(2.0 / 2 ** d)
                                            for d in range(D)))
    assert np.max(np.abs(got - want)) <= bound


def test_cuda_source_holds_the_bridge_key_and_stride():
    """The kernels' header draws with the port's key word and counter
    stride."""
    text = (CSRC / "threefry.cuh").read_text()

    def const(name):
        return int(re.search(rf"{name}\s*=\s*(0x[0-9A-Fa-f]+)u;",
                             text).group(1), 16)

    assert const("kBridgeKey") == trng.BRIDGE_KEY == 0x85A308D3
    assert const("kStepStride") == trng.STEP_STRIDE
    assert const("kStreamKey") == trng.STREAM_KEY
    assert "node * kStepStride + row" in text
    kernel = "".join((CSRC / f).read_text() for f in (
        "sde_adaptive_ensemble.cu", "sde_adaptive_body.cuh"))
    assert '#include "threefry.cuh"' in kernel
    assert "bridge_normal(seed, 0u," in kernel      # the endpoint, node 0


# ---------------------------------------------------------------------------
# properties of the tree
# ---------------------------------------------------------------------------

def W(seed, idx, depth, n_lanes=64, t_total=1.0, row=0):
    """W at grid index (int or list of K) for n_lanes lanes: (K, lanes)."""
    idx = torch.as_tensor(np.atleast_1d(idx), dtype=torch.int64)[:, None]
    lanes = torch.arange(n_lanes, dtype=torch.int64)[None]
    rows = torch.full((1, 1), row, dtype=torch.int64)
    return trng.brownian_bridge_point(seed, idx, lanes, rows, depth=depth,
                                      t_total=t_total,
                                      dtype=torch.float64).numpy()


def test_bridge_is_pure_and_telescoping():
    D, n = 12, 2 ** 12
    np.testing.assert_array_equal(W(7, 777, D), W(7, 777, D))
    assert np.all(W(7, 0, D) == 0.0)
    q = W(7, [i * n // 4 for i in range(5)], D)
    np.testing.assert_allclose(sum(q[i + 1] - q[i] for i in range(4)), q[4],
                               atol=1e-12)


def test_bridge_value_does_not_depend_on_query_shape():
    """One point queried alone, in a batch, broadcast over rows, and as
    one element of a (K, lanes) grid: the same bits."""
    D = 10
    alone = W(3, 300, D, n_lanes=8, row=2)
    batch = W(3, [5, 300, 1000], D, n_lanes=8, row=2)[1:2]
    lanes = torch.arange(8, dtype=torch.int64)
    grid = trng.brownian_bridge_point(
        3, torch.full((3, 8), 300, dtype=torch.int64), lanes[None],
        torch.arange(3, dtype=torch.int64)[:, None], depth=D, t_total=1.0,
        dtype=torch.float64).numpy()[2:3]
    np.testing.assert_array_equal(alone, batch)
    np.testing.assert_array_equal(alone, grid)


def test_bridge_statistics():
    D, lanes = 12, 20000
    wf, wh = W(3, 2 ** D, D, n_lanes=lanes)[0], W(3, 2 ** D // 2, D,
                                                 n_lanes=lanes)[0]
    assert abs(np.var(wf) - 1.0) < 0.05          # Var W(1) = 1
    assert abs(np.var(wh) - 0.5) < 0.03          # Var W(1/2) = 1/2
    assert abs(np.mean(wh * (wf - wh))) < 0.02   # independent increments


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), depth=st.integers(4, 10),
       data=st.data())
def test_bridge_interpolation_mean_and_variance(seed, depth, data):
    """W(s) | W(l), W(r): the linear interpolant's mean and variance
    θ(1-θ)(t_r - t_l), the residual uncorrelated with the increment."""
    n, lanes = 2 ** depth, 4000
    l = data.draw(st.integers(0, n - 2), label="l")
    r = data.draw(st.integers(l + 2, n), label="r")
    s = data.draw(st.integers(l + 1, r - 1), label="s")
    wl, ws, wr = W(seed, [l, s, r], depth, n_lanes=lanes)
    theta = (s - l) / (r - l)
    resid = ws - (wl + theta * (wr - wl))
    var_want = theta * (1.0 - theta) * (r - l) / n
    sd = np.sqrt(var_want)
    assert abs(np.mean(resid)) < 5.0 * sd / np.sqrt(lanes)
    assert abs(np.var(resid) / var_want - 1.0) < 0.25
    inc = wr - wl
    assert abs(np.mean(resid * inc) / (sd * np.std(inc))) < 0.1


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), depth=st.integers(4, 12),
       data=st.data())
def test_reject_redraw_replays_increments_bitwise(seed, depth, data):
    """Attempt [i, i+m], 'reject', redraw at a finer partition (another
    query shape and order), re-query: every value bitwise the same, and
    the sub-increments telescope to the rejected one."""
    n = 2 ** depth
    i = data.draw(st.integers(0, n - 2), label="i")
    m = data.draw(st.integers(2, min(n - i, 64)), label="m")
    k = data.draw(st.integers(1, 6), label="k")
    cuts = sorted({i, i + m}
                  | {i + data.draw(st.integers(1, m - 1), label=f"c{j}")
                     for j in range(k)})
    w_i, w_im = W(seed, [i, i + m], depth)
    fine = W(seed, list(reversed(cuts)), depth)[::-1]
    w_i2, w_im2 = W(seed, [i, i + m], depth)
    np.testing.assert_array_equal(w_i, w_i2)
    np.testing.assert_array_equal(w_im, w_im2)
    np.testing.assert_array_equal(fine[0], w_i)
    np.testing.assert_array_equal(fine[-1], w_im)
    acc = np.zeros_like(w_i)
    for a, b in zip(fine, fine[1:]):
        acc = acc + (b - a)
    np.testing.assert_allclose(acc, fine[-1] - fine[0], rtol=0, atol=1e-12)
