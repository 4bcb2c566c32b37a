"""Mixed-precision solve: f32 active-set identification + f64 refinement.

This path has no reference counterpart -- it answers the accelerator's
precision profile. The reference runs everything in double on CPU;
accelerators are several times faster in float32 than in float64, so a
straight f64 port spends most of its time where a few digits would do. The
GI dual active-set method splits naturally:

1. *Identify* the optimal active set with the whole GI iteration in
   float32 -- combinatorial decisions (which constraint is most violated,
   which multiplier blocks) only need a few correct digits.
2. *Refine* in float64 with one shot of the warm-start machinery
   (:mod:`jrlqp_tpu.solver.warm_start`, ref
   src/experimental/GoldfarbIdnaniSolver.cpp:392-486): rebuild J/R by QR of
   L^{-1}N from the f32 active set and evaluate the closed-form primal/dual
   point. If the f32 set was right this is exact (0 further iterations) and
   reaches <=1e-8 KKT residuals; if it was off by a constraint or two, the
   f64 GI loop continues from there, which costs only the difference.

The reference's own warm-start test (0 iterations on the exact active set,
tests/GoldfarbIdnaniSolverTest.cpp:134-176) is precisely the property that
makes this sound.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..problems import QPProblem
from ..types import SolverOptions
from .dense import _solve_impl
from .state import GIResult
from .warm_start import _solve_warm_impl

__all__ = ["solve_mixed"]

# f32 needs a looser "z is numerically zero" threshold than the reference's
# 1e-14 (ref GoldfarbIdnaniSolver.cpp:174): float32 eps ~ 1.2e-7.
F32_ZERO_Z = 1e-6


@functools.partial(jax.jit, static_argnames=("opt",))
def solve_mixed(pb: QPProblem, opt: SolverOptions = SolverOptions()) -> GIResult:
    """Solve in f32, refine in f64. Returns a float64 GIResult whose
    ``iterations`` counts f32 iterations + any f64 correction iterations.
    Jitted by default; composes with jit/vmap."""
    pb32 = pb.with_dtype(jnp.float32)
    opt32 = opt.with_(dtype=jnp.float32, zero_z_threshold=F32_ZERO_Z)
    res32 = _solve_impl(pb32, opt32)

    pb64 = pb.with_dtype(jnp.float64)
    res64 = _solve_warm_impl(
        pb64, res32.active_set, opt.with_(dtype=jnp.float64, warm_start=True))
    return GIResult(
        x=res64.x,
        multipliers=res64.multipliers,
        f=res64.f,
        iterations=res32.iterations + res64.iterations,
        status=res64.status,
        active_set=res64.active_set,
    )
