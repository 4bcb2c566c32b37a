"""Foundation types: activation/termination enums and solver options.

Fixed-shape re-design of the reference foundation layer
(ref: include/jrl-qp/enums.h:14-52, include/jrl-qp/SolverOptions.h:14-88).
Enums are plain ``IntEnum`` so their values can live inside JAX int32 arrays;
the *ordering is semantic* exactly as in the reference (enums.h:11-13):
``status <= EQUALITY`` means "general constraint", ``status >= LOWER_BOUND``
means "bound on a variable".
"""
from __future__ import annotations

import dataclasses
import enum

import jax.numpy as jnp

__all__ = [
    "ActivationStatus",
    "TerminationStatus",
    "SolverOptions",
    "BIG_BND",
]

# Infinity proxy used both as "no bound" marker and infeasibility threshold
# (ref: SolverOptions.h bigBnd_=1e100; DualSolver.cpp:131 uses it as the
# infeasibility test `t >= bigBnd`).
BIG_BND = 1e100


class ActivationStatus(enum.IntEnum):
    """Activation status of a constraint (ref: enums.h:14-23).

    Order matters: values <= EQUALITY are general constraints, values >=
    LOWER_BOUND are variable bounds.
    """

    INACTIVE = 0
    LOWER = 1  # active at lower bound
    UPPER = 2  # active at upper bound
    EQUALITY = 3  # equality constraint (bl == bu)
    LOWER_BOUND = 4  # variable bound active at lower
    UPPER_BOUND = 5  # variable bound active at upper
    FIXED = 6  # variable fixed (xl == xu)


class TerminationStatus(enum.IntEnum):
    """Solver termination reason (ref: enums.h:26-37).

    RUNNING is an addition of this build: per-lane status while the
    batched ``lax.while_loop`` is still iterating.
    """

    RUNNING = -1
    SUCCESS = 0
    INCONSISTENT_INPUT = 1
    NON_POS_HESSIAN = 2
    INFEASIBLE = 3
    MAX_ITER_REACHED = 4
    LINEAR_DEPENDENCY_DETECTED = 5
    OVERCONSTRAINED_PROBLEM = 6
    UNKNOWN = 7


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Runtime options (ref: SolverOptions.h:14-88).

    All fields are trace-time constants for a given jitted solve.
    ``big_bnd`` doubles as the infinity proxy and the infeasibility
    threshold, like the reference's ``bigBnd_``.
    """

    max_iter: int = 500
    big_bnd: float = BIG_BND
    warm_start: bool = False
    # opt-in traced input validation: lanes with inverted/NaN bounds or
    # non-finite G/a/C terminate with INCONSISTENT_INPUT instead of
    # producing garbage (analog of the reference's wellFormed validators,
    # ref include/jrl-qp/test/problems.h:16-146; off by default -- it adds
    # a data pass per solve)
    validate: bool = False
    # Numerical tolerances mirroring the reference's inline constants.
    zero_z_threshold: float = 1e-14  # ref GoldfarbIdnaniSolver.cpp:174
    # dtype of all solver arithmetic. float64 is required for the
    # reference-level 1e-8 KKT residuals (the algorithm's tie-breaking is
    # sensitive at the 1e-13 level, see ref test exclusion list).
    dtype: jnp.dtype = jnp.float64

    def with_(self, **kw) -> "SolverOptions":
        return dataclasses.replace(self, **kw)


# int32 codes used in arrays (aliases to keep call-sites terse)
INACTIVE = int(ActivationStatus.INACTIVE)
LOWER = int(ActivationStatus.LOWER)
UPPER = int(ActivationStatus.UPPER)
EQUALITY = int(ActivationStatus.EQUALITY)
LOWER_BOUND = int(ActivationStatus.LOWER_BOUND)
UPPER_BOUND = int(ActivationStatus.UPPER_BOUND)
FIXED = int(ActivationStatus.FIXED)

RUNNING = int(TerminationStatus.RUNNING)
SUCCESS = int(TerminationStatus.SUCCESS)
INCONSISTENT_INPUT = int(TerminationStatus.INCONSISTENT_INPUT)
NON_POS_HESSIAN = int(TerminationStatus.NON_POS_HESSIAN)
INFEASIBLE = int(TerminationStatus.INFEASIBLE)
MAX_ITER_REACHED = int(TerminationStatus.MAX_ITER_REACHED)
LINEAR_DEPENDENCY_DETECTED = int(TerminationStatus.LINEAR_DEPENDENCY_DETECTED)
OVERCONSTRAINED_PROBLEM = int(TerminationStatus.OVERCONSTRAINED_PROBLEM)
