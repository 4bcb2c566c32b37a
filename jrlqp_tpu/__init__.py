"""jrlqp_tpu -- batched strictly-convex dense QP solver framework.

A from-scratch JAX / XLA / Pallas re-design with the capabilities of the
jrl-qp reference library (Goldfarb-Idnani dual active-set method): dense and
structured solvers, warm starting, batched/sharded solves over device
meshes, a problem-generation + KKT-verification test library, a QPS reader
for the Maros-Meszaros collection, and a benchmark harness.

The solver arithmetic defaults to float64; x64 mode is enabled on import
(set JRLQP_TPU_NO_X64=1 beforehand to opt out).
"""
import os as _os

import jax as _jax

if not _os.environ.get("JRLQP_TPU_NO_X64"):
    _jax.config.update("jax_enable_x64", True)

# On the GPU a float32 contraction may run in TF32 (about three decimal
# digits) unless a higher precision is asked for; the init's Cholesky and
# operator products and the iterative-refinement corrections need true
# float32 contractions. Set JRLQP_TPU_MATMUL_PRECISION to override (e.g.
# "default" to opt out).
_jax.config.update(
    "jax_default_matmul_precision",
    _os.environ.get("JRLQP_TPU_MATMUL_PRECISION", "float32"),
)

from .problems import LeastSquareProblem, QPProblem, pad_problem, stack_problems
from .solver.box_single import solve_box
from .solver.dense import solve, solve_batch
from .solver.mixed import solve_mixed
from .solver.state import GIResult, GIState
from .solver.warm_start import solve_warm
from .structured import GType, StructuredC, StructuredG, solve_structured
from .types import ActivationStatus, SolverOptions, TerminationStatus
from .validation import inconsistent_mask, well_formed

__version__ = "0.1.0"

__all__ = [
    "QPProblem",
    "well_formed",
    "inconsistent_mask",
    "LeastSquareProblem",
    "pad_problem",
    "stack_problems",
    "solve",
    "solve_batch",
    "solve_mixed",
    "solve_warm",
    "solve_box",
    "solve_structured",
    "GType",
    "StructuredC",
    "StructuredG",
    "GIResult",
    "GIState",
    "ActivationStatus",
    "TerminationStatus",
    "SolverOptions",
]
