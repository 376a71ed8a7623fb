"""`repro_torch.core.order_conditions` against `repro.core.order_conditions`:
the rooted trees and their counts up to order 8, and every ERK and
Rosenbrock residual of the port's tableaus equal to the reference's on the
reference's tableaus, bit for bit (both are the same numpy arithmetic on
the same float64 coefficients)."""
import numpy as np
import pytest

from repro.core import order_conditions as ref_oc
from repro.core import tableaus as ref_tab
from repro_torch.core import order_conditions as oc
from repro_torch.core import tableaus as tab


@pytest.mark.parametrize("order", range(1, 9))
def test_trees_equal_the_reference(order):
    assert oc.rooted_trees(order) == ref_oc.rooted_trees(order)
    assert oc.count_trees(order) == ref_oc.count_trees(order)
    for t in oc.rooted_trees(order):
        assert oc.tree_order(t) == order
        assert oc.tree_density(t) == ref_oc.tree_density(t)


def _same(got, want):
    assert [t for t, _ in got] == [t for t, _ in want]
    a = np.array([r for _, r in got])
    b = np.array([r for _, r in want])
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(tab.TABLEAUS))
def test_erk_residuals_bitwise(name):
    mine, ref = tab.TABLEAUS[name], ref_tab.TABLEAUS[name]
    order = max(mine.order, 1)
    _same(oc.order_condition_residuals(mine.a, mine.b, mine.c, order),
          ref_oc.order_condition_residuals(ref.a, ref.b, ref.c, order))
    for embedded in (False, True):
        q = mine.embedded_order if embedded else mine.order
        if q < 1:
            continue
        got = oc.max_order_condition_residual(mine, q, embedded)
        assert got == ref_oc.max_order_condition_residual(ref, q, embedded)
    assert (oc.stage_consistency_residual(mine)
            == ref_oc.stage_consistency_residual(ref))
    U, rhs, trees = oc.elementary_weight_matrix(mine.a, mine.c, order)
    rU, rrhs, rtrees = ref_oc.elementary_weight_matrix(ref.a, ref.c, order)
    assert trees == rtrees
    assert U.tobytes() == rU.tobytes() and rhs.tobytes() == rrhs.tobytes()


@pytest.mark.parametrize("name", sorted(tab.ROSENBROCK_TABLEAUS))
def test_rosenbrock_residuals_bitwise(name):
    mine = tab.ROSENBROCK_TABLEAUS[name]
    ref = ref_tab.ROSENBROCK_TABLEAUS[name]
    for got, want in zip(oc.rosenbrock_kform(mine),
                         ref_oc.rosenbrock_kform(ref)):
        assert got.tobytes() == want.tobytes()
    for embedded in (False, True):
        q = mine.embedded_order if embedded else mine.order
        _same(oc.rosenbrock_order_condition_residuals(mine, q, embedded),
              ref_oc.rosenbrock_order_condition_residuals(ref, q, embedded))
        assert (oc.max_rosenbrock_condition_residual(mine, q, embedded)
                == ref_oc.max_rosenbrock_condition_residual(ref, q,
                                                            embedded))
    assert (oc.rosenbrock_consistency_residual(mine)
            == ref_oc.rosenbrock_consistency_residual(ref))


def test_doctests_and_orders():
    """The module's doctests hold, and every shipped tableau meets its
    order to rounding."""
    import doctest
    assert doctest.testmod(oc).failed == 0
    for t in tab.TABLEAUS.values():
        assert oc.max_order_condition_residual(t, t.order) < 1e-10, t.name
    for r in tab.ROSENBROCK_TABLEAUS.values():
        assert oc.max_rosenbrock_condition_residual(r, r.order) < 1e-10
