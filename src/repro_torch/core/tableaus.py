"""Butcher tableaus for embedded explicit Runge-Kutta pairs, and the
Rosenbrock W-method tableaus — the data of `repro.core.tableaus`, copied.

A method is data: the coefficients below are the reference's literals (and
its construction code for GBS10 and ROS23W), so every float is bitwise the
reference's; the tests hold each array equal to it.  Only `_tsit5_bpoly`
changes, to evaluate on tensors.  The fused CUDA kernel
(`csrc/erk_ensemble.cu`) carries its own compiled-in copy of the tsit5 and
dopri5 rows; a test holds those equal to these arrays.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class Tableau(NamedTuple):
    name: str
    a: np.ndarray        # (s, s) strictly lower triangular
    b: np.ndarray        # (s,)  high-order weights
    btilde: np.ndarray   # (s,)  b - bhat  (error-estimate weights)
    c: np.ndarray        # (s,)  abscissae
    order: int           # order of the propagated solution
    embedded_order: int
    fsal: bool           # first-same-as-last: k[s-1] of step n == k[0] of step n+1
    # optional dense-output polynomial: theta -> (s,) weights; None => Hermite cubic
    interp_bpoly: Optional[Callable] = None

    @property
    def stages(self) -> int:
        return len(self.b)


def _tab(name, a_rows, b, bhat=None, btilde=None, c=None, order=0,
         embedded_order=0, fsal=False, interp_bpoly=None) -> Tableau:
    s = len(b)
    a = np.zeros((s, s), dtype=np.float64)
    for i, row in enumerate(a_rows):
        a[i + 1, : len(row)] = row
    b = np.asarray(b, dtype=np.float64)
    if btilde is None:
        btilde = b - np.asarray(bhat, dtype=np.float64)
    else:
        btilde = np.asarray(btilde, dtype=np.float64)
    if c is None:
        c = a.sum(axis=1)
    return Tableau(name, a, b, btilde, np.asarray(c, np.float64), order,
                   embedded_order, fsal, interp_bpoly)


# Tsitouras 5(4) — [Tsitouras 2011], coefficients as in OrdinaryDiffEq.jl.
# FSAL; 7 stages (6 effective); free 4th-order interpolant.
_TSIT5_A = [
    [0.161],
    [-0.008480655492356989, 0.335480655492357],
    [2.8971530571054935, -6.359448489975075, 4.3622954328695815],
    [5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525],
    [5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401006, -0.028269050394068383],
    [0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774],
]
_TSIT5_B = [0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
            -3.290069515436081, 2.324710524099774, 0.0]
# btilde = b - bhat (4th-order embedded): error = dt * sum(btilde_i * k_i)
_TSIT5_BTILDE = [-0.00178001105222577714, -0.0008164344596567469,
                 0.007880878010261995, -0.1447110071732629,
                 0.5823571654525552, -0.45808210592918697,
                 0.015151515151515152]
_TSIT5_C = [0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0]


def _tsit5_bpoly(theta: torch.Tensor) -> torch.Tensor:
    """Tsitouras free 4th-order interpolant: theta in [0,1] -> stage weights
    (7, *theta.shape); u(t+theta*h) = u + h * sum_i b_i(theta) k_i.  The
    expressions keep the reference's operation order."""
    t = theta
    b1 = -1.0530884977290216 * t * (t - 1.3299890189751412) * (
        t * t - 1.4364028541716351 * t + 0.7139816917074209)
    b2 = 0.1017 * t * t * (t * t - 2.1966568338249754 * t + 1.2949852507374631)
    b3 = 2.490627285651252793 * t * t * (
        t * t - 2.38535645472061657 * t + 1.57803468208092486)
    b4 = -16.54810288924490272 * (t - 1.21712927295533244) * (
        t - 0.61620406037800089) * t * t
    b5 = 47.37952196281928122 * (t - 1.203071208372362603) * (
        t - 0.658047292653547382) * t * t
    b6 = -34.87065786149660974 * (t - 1.2) * (t - 2.0 / 3.0) * t * t
    b7 = 2.5 * (t - 1.0) * (t - 0.6) * t * t
    return torch.stack([b1, b2, b3, b4, b5, b6, b7])


TSIT5 = _tab("tsit5", _TSIT5_A, _TSIT5_B, btilde=_TSIT5_BTILDE, c=_TSIT5_C,
             order=5, embedded_order=4, fsal=True, interp_bpoly=_tsit5_bpoly)

# Dormand-Prince 5(4) — [Dormand & Prince 1980]; MATLAB ode45 / dopri5. FSAL.
_DOPRI5_A = [
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DOPRI5_B = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
_DOPRI5_BHAT = [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
                187 / 2100, 1 / 40]
DOPRI5 = _tab("dopri5", _DOPRI5_A, _DOPRI5_B, bhat=_DOPRI5_BHAT,
              c=[0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0],
              order=5, embedded_order=4, fsal=True)

# Cash-Karp 5(4) — the MPGOS comparison method in the paper's Fig. 5/6.
_RKCK_A = [
    [1 / 5],
    [3 / 40, 9 / 40],
    [3 / 10, -9 / 10, 6 / 5],
    [-11 / 54, 5 / 2, -70 / 27, 35 / 27],
    [1631 / 55296, 175 / 512, 575 / 13824, 44275 / 110592, 253 / 4096],
]
_RKCK_B = [37 / 378, 0.0, 250 / 621, 125 / 594, 0.0, 512 / 1771]
_RKCK_BHAT = [2825 / 27648, 0.0, 18575 / 48384, 13525 / 55296, 277 / 14336,
              1 / 4]
RKCK54 = _tab("rkck54", _RKCK_A, _RKCK_B, bhat=_RKCK_BHAT,
              c=[0, 1 / 5, 3 / 10, 3 / 5, 1.0, 7 / 8],
              order=5, embedded_order=4, fsal=False)

# Bogacki-Shampine 3(2) — MATLAB ode23. FSAL.
_BS3_A = [
    [1 / 2],
    [0.0, 3 / 4],
    [2 / 9, 1 / 3, 4 / 9],
]
_BS3_B = [2 / 9, 1 / 3, 4 / 9, 0.0]
_BS3_BHAT = [7 / 24, 1 / 4, 1 / 3, 1 / 8]
BS3 = _tab("bs3", _BS3_A, _BS3_B, bhat=_BS3_BHAT, c=[0, 1 / 2, 3 / 4, 1.0],
           order=3, embedded_order=2, fsal=True)

# Fehlberg 4(5) — classical RKF45.
_RKF45_A = [
    [1 / 4],
    [3 / 32, 9 / 32],
    [1932 / 2197, -7200 / 2197, 7296 / 2197],
    [439 / 216, -8.0, 3680 / 513, -845 / 4104],
    [-8 / 27, 2.0, -3544 / 2565, 1859 / 4104, -11 / 40],
]
_RKF45_B = [16 / 135, 0.0, 6656 / 12825, 28561 / 56430, -9 / 50, 2 / 55]
_RKF45_BHAT = [25 / 216, 0.0, 1408 / 2565, 2197 / 4104, -1 / 5, 0.0]
RKF45 = _tab("rkf45", _RKF45_A, _RKF45_B, bhat=_RKF45_BHAT,
             c=[0, 1 / 4, 3 / 8, 12 / 13, 1.0, 1 / 2],
             order=5, embedded_order=4, fsal=False)

# Classical RK4 (fixed-step only; btilde = 0 sentinel).
_RK4_A = [
    [1 / 2],
    [0.0, 1 / 2],
    [0.0, 0.0, 1.0],
]
RK4 = _tab("rk4", _RK4_A, [1 / 6, 1 / 3, 1 / 3, 1 / 6],
           btilde=[0.0, 0.0, 0.0, 0.0], c=[0, 1 / 2, 1 / 2, 1.0],
           order=4, embedded_order=4, fsal=False)

# Verner "most efficient" 7(6) — [Verner 2010], the paper's GPUVern7.
# 10 stages; b uses 9, stage 10 feeds only the order-6 error estimator.
# Dense output falls back to Hermite cubic.
_VERN7_A = [
    [0.005],
    [-1.0767901234565735, 1.1856790123454624],
    [0.040833333333336864, 0.0, 0.12249999999999647],
    [0.6389139236256102, 0.0, -2.4556726382238203, 2.2722587145982103],
    [-2.6615773750273117, 0.0, 10.804513886491288, -8.353914657424742,
     0.8204875949589865],
    [6.067741434695297, 0.0, -24.711273635906824, 20.42751793078589,
     -1.9061579788134801, 1.0061722492391174],
    [12.054670076247431, 0.0, -49.754784950450635, 41.14288863859173,
     -4.4617601499684865, 2.0423348222341633, -0.0983484366541985],
    [10.138146522844547, 0.0, -42.64113603157068, 35.76384003980545,
     -4.348022840378171, 2.009862268369773, 0.3487490460336382,
     -0.2714390051045587],
    [-45.030072034298676, 0.0, 187.3272437654589, -154.02882369350186,
     18.56465306347536, -7.141809679295079, 1.3088085781613787, 0.0, 0.0],
]
_VERN7_B = [0.04715561848627767, 0.0, 0.0, 0.257505642984316,
            0.2621665397743865, 0.15216092656729885, 0.49399691700248516,
            -0.2943031171395947, 0.08131747232483061, 0.0]
_VERN7_BTILDE = [0.002548988715029059, 0.0, 0.0, -0.009665891129052029,
                 0.04209735781365781, -0.06673399842882516,
                 0.2652154308245583, -0.29453153722512393, 0.0813805859745605,
                 -0.02031093654480414]
_VERN7_C = [0.0, 0.005, 49.0 / 450.0, 49.0 / 300.0, 0.4555,
            0.6095094489982205, 0.884, 0.925, 1.0, 1.0]
VERN7 = _tab("vern7", _VERN7_A, _VERN7_B, btilde=_VERN7_BTILDE, c=_VERN7_C,
             order=7, embedded_order=6, fsal=False)


def _build_gbs_tableau(ns=(2, 4, 6, 8, 10), name="gbs10"):
    """GBS10: Gragg-Bulirsch-Stoer midpoint extrapolation (sequence
    2,4,6,8,10; 26 stages) as an embedded 10(8) ERK pair, built from exact
    rationals — the reference's construction, unchanged."""
    F = Fraction
    stage_of = {}
    idx = 1
    for j, n in enumerate(ns):
        stage_of[(j, 0)] = 0          # f(y0) shared by every sequence
        for i in range(1, n):
            stage_of[(j, i)] = idx
            idx += 1
    s = idx
    A = [[F(0)] * s for _ in range(s)]
    c = [F(0)] * s
    yrow = {}
    for j, n in enumerate(ns):
        # midpoint chain y_{i+1} = y_{i-1} + (2h/n) f(y_i), Euler start
        y = {0: [F(0)] * s, 1: [F(0)] * s}
        y[1][stage_of[(j, 0)]] = F(1, n)
        for i in range(1, n):
            r = stage_of[(j, i)]
            A[r] = list(y[i])
            c[r] = F(i, n)
            y[i + 1] = list(y[i - 1])
            y[i + 1][r] += F(2, n)
        yrow[j] = y[n]                # increment coefficients of T_j = y_n

    def extrapolated_b(js):
        # Aitken-Neville to h^2 -> 0 through the points (1/n_j^2, T_j)
        xs = [F(1, ns[j] * ns[j]) for j in js]
        b = [F(0)] * s
        for a, j in enumerate(js):
            w = F(1)
            for l in range(len(js)):
                if l != a:
                    w *= xs[l] / (xs[l] - xs[a])
            for q in range(s):
                b[q] += w * yrow[j][q]
        return b

    b = extrapolated_b(range(len(ns)))
    bhat = extrapolated_b(range(len(ns) - 1))
    btilde = [x - y for x, y in zip(b, bhat)]
    as_f = lambda v: np.asarray([float(x) for x in v], np.float64)
    return Tableau(name, np.asarray([[float(x) for x in row] for row in A]),
                   as_f(b), as_f(btilde), as_f(c), order=2 * len(ns),
                   embedded_order=2 * (len(ns) - 1), fsal=False,
                   interp_bpoly=None)


GBS10 = _build_gbs_tableau()

TABLEAUS = {t.name: t for t in [TSIT5, DOPRI5, RKCK54, BS3, RKF45, RK4,
                                VERN7, GBS10]}


def get_tableau(name: str) -> Tableau:
    try:
        return TABLEAUS[name]
    except KeyError:
        raise KeyError(f"unknown tableau {name!r}; have {sorted(TABLEAUS)}")


# ============================================================================
# Rosenbrock (linearly-implicit W-method) tableaus, implementation form
# (Hairer-Wanner IV.7 eq. 7.4).  Data only in this slice: the stiff engine is
# ROADMAP queue 1, item 5.
# ============================================================================


class RosenbrockTableau(NamedTuple):
    """Coefficients of an s-stage Rosenbrock W-method (implementation form)."""
    name: str
    gamma: float         # the single diagonal γ (one LU factorization/step)
    a: np.ndarray        # (s, s) strictly lower: stage-argument weights
    C: np.ndarray        # (s, s) strictly lower: in-solve stage coupling
    b: np.ndarray        # (s,)  solution weights
    btilde: np.ndarray   # (s,)  b - bhat (error-estimate weights)
    c: np.ndarray        # (s,)  abscissae (= row sums of the k-form α)
    d: np.ndarray        # (s,)  f_t weights (= row sums of the k-form Γ)
    order: int
    embedded_order: int
    interp_h: Optional[np.ndarray] = None

    @property
    def stages(self) -> int:
        return len(self.b)


def _lower(s, rows):
    M = np.zeros((s, s), np.float64)
    for i, row in enumerate(rows):
        M[i + 1, : len(row)] = row
    return M


def _build_ros23w() -> RosenbrockTableau:
    """ode23s from its k-form (the reference's transformation, unchanged)."""
    d = 1.0 / (2.0 + np.sqrt(2.0))
    e32 = 6.0 + np.sqrt(2.0)
    alpha = np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 1.0, 0.0]])
    Gamma = np.array([[d, 0.0, 0.0], [-d, d, 0.0],
                      [d * (e32 - 2.0), -d * e32, d]])
    b_k = np.array([0.0, 1.0, 0.0])
    btilde_k = np.array([-1.0 / 6.0, 1.0 / 3.0, -1.0 / 6.0])  # b - Simpson ŷ
    Ginv = np.linalg.inv(Gamma)
    return RosenbrockTableau(
        name="rosenbrock23", gamma=d, a=alpha @ Ginv,
        C=np.eye(3) / d - Ginv, b=b_k @ Ginv, btilde=btilde_k @ Ginv,
        c=alpha.sum(axis=1), d=Gamma.sum(axis=1), order=2, embedded_order=3)


ROS23W = _build_ros23w()


def _build_rodas4() -> RosenbrockTableau:
    a51, a52, a53, a54 = (1.221224509226641, 6.019134481288629,
                          12.53708332932087, -0.6878860361058950)
    a = _lower(6, [
        [1.544000000000000],
        [0.9466785280815826, 0.2557011698983284],
        [3.314825187068521, 2.896124015972201, 0.9986419139977817],
        [a51, a52, a53, a54],
        [a51, a52, a53, a54, 1.0],          # g6 = g5-solution + U5
    ])
    C = _lower(6, [
        [-5.668800000000000],
        [-2.430093356833875, -0.2063599157091915],
        [-0.1073529058151375, -9.594562251023355, -20.47028614809616],
        [7.496443313967647, -10.24680431464352, -33.99990352819905,
         11.70890893206160],
        [8.083246795921522, -7.981132988064893, -31.52159432874371,
         16.31930543123136, -6.058818238834054],
    ])
    b = np.array([a51, a52, a53, a54, 1.0, 1.0])   # stiffly accurate
    btilde = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 1.0])   # err = U_6
    interp_h = np.array([
        [10.12623508344586, -7.487995877610167, -34.80091861555747,
         -7.992771707568823, 1.025137723295662, 0.0],
        [-0.6762803392801253, 6.087714651680015, 16.43084320892478,
         24.76722511418386, -6.594389125716872, 0.0],
    ])
    return RosenbrockTableau(
        name="rodas4", gamma=0.25, a=a, C=C, b=b, btilde=btilde,
        c=np.array([0.0, 0.386, 0.21, 0.63, 1.0, 1.0]),
        d=np.array([0.25, -0.1043, 0.1035, -0.03620000000000023, 0.0, 0.0]),
        order=4, embedded_order=3, interp_h=interp_h)


RODAS4 = _build_rodas4()


def _build_rodas5p() -> RosenbrockTableau:
    a61, a62, a63, a64, a65 = (-7.502846399306121, 2.561846144803919,
                               -11.627539656261098, -0.18268767659942256,
                               0.030198172008377946)
    a = _lower(8, [
        [3.0],
        [2.849394379747939, 0.45842242204463923],
        [-6.954028509809101, 2.489845061869568, -10.358996098473584],
        [2.8029986275628964, 0.5072464736228206, -0.3988312541770524,
         -0.04721187230404641],
        [a61, a62, a63, a64, a65],
        [a61, a62, a63, a64, a65, 1.0],
        [a61, a62, a63, a64, a65, 1.0, 1.0],
    ])
    C = _lower(8, [
        [-14.155112264123755],
        [-17.97296035885952, -2.859693295451294],
        [147.12150275711716, -1.41221402718213, 71.68940251302358],
        [165.43517024871676, -0.4592823456491126, 42.90938336958603,
         -5.961986721573306],
        [24.854864614690072, -3.0009227002832186, 47.4931110020768,
         5.5814197821558125, -0.6610691825249471],
        [30.91273214028599, -3.1208243349937974, 77.79954646070892,
         34.28646028294783, -19.097331116725623, -28.087943162872662],
        [37.80277123390563, -3.2571969029072276, 112.26918849496327,
         66.9347231244047, -40.06618937091002, -54.66780262877968,
         -9.48861652309627],
    ])
    b = np.array([a61, a62, a63, a64, a65, 1.0, 1.0, 1.0])
    btilde = np.array([0.0] * 7 + [1.0])           # err = U_8
    return RosenbrockTableau(
        name="rodas5p", gamma=0.21193756319429014, a=a, C=C, b=b,
        btilde=btilde,
        c=np.array([0.0, 0.6358126895828704, 0.4095798393397535,
                    0.9769306725060716, 0.4288403609558664, 1.0, 1.0, 1.0]),
        d=np.array([0.21193756319429014, -0.42387512638858027,
                    -0.3384627126235924, 1.8046452872882734,
                    2.325825639765069, 0.0, 0.0, 0.0]),
        order=5, embedded_order=4, interp_h=None)


RODAS5P = _build_rodas5p()

ROSENBROCK_TABLEAUS = {t.name: t for t in [ROS23W, RODAS4, RODAS5P]}


def get_rosenbrock_tableau(name: str) -> RosenbrockTableau:
    try:
        return ROSENBROCK_TABLEAUS[name]
    except KeyError:
        raise KeyError(f"unknown Rosenbrock tableau {name!r}; "
                       f"have {sorted(ROSENBROCK_TABLEAUS)}")
