# The paper's primary contribution — massively parallel ensemble ODE solving
# with two strategies (array lock-step vs the fused whole-integration
# kernel), adaptive embedded RK with dense output — ported to PyTorch, erk
# family first, then the fixed-dt SDE steppers.
from .problem import EnsembleProblem, ODEProblem, SDEProblem
from .tableaus import (ROSENBROCK_TABLEAUS, TABLEAUS, RosenbrockTableau,
                       get_rosenbrock_tableau, get_tableau)
from .controller import (STATUS_DTMIN_EXHAUSTED, STATUS_MAX_ITERS,
                         STATUS_SUCCESS, PIController, WReusePolicy,
                         hairer_norm, initial_dt, pi_propose)
from .methods import (MethodSpec, get_method, list_methods, register_method,
                      valid_dispatch)
from .solvers import (AdaptiveOptions, SolveResult, interp_step, rk_step,
                      solve_adaptive, solve_fixed, solve_one)
from .ensemble import EnsembleResult, solve_ensemble_local
from .sde import SDE_STEPPERS, EnsembleSDEResult, solve_sde_ensemble

__all__ = [
    "EnsembleProblem", "ODEProblem", "SDEProblem",
    "TABLEAUS", "get_tableau", "ROSENBROCK_TABLEAUS", "RosenbrockTableau",
    "get_rosenbrock_tableau", "PIController", "hairer_norm", "pi_propose",
    "initial_dt", "WReusePolicy", "STATUS_SUCCESS", "STATUS_MAX_ITERS",
    "STATUS_DTMIN_EXHAUSTED",
    "MethodSpec", "get_method", "list_methods", "register_method",
    "valid_dispatch",
    "AdaptiveOptions", "SolveResult", "interp_step", "rk_step",
    "solve_adaptive", "solve_fixed", "solve_one",
    "EnsembleResult", "solve_ensemble_local",
    "SDE_STEPPERS", "EnsembleSDEResult", "solve_sde_ensemble",
]
