"""Specialized solver: min 0.5 |x - x0|^2  s.t.  c^T x >= bl, xl <= x <= xu.

Fixed-shape re-design of the reference BoxAndSingleConstraintSolver
(ref: src/experimental/BoxAndSingleConstraintSolver.cpp:7-95). The
reference seeds the generic GI machinery with a closed-form clamp init and
lets the active-set loop handle the single general constraint; batched, that
loop is the entire cost (a data-dependent while_loop of O(n^2) steps for a
problem whose true work is O(n log n)). This module instead solves the QP
EXACTLY in closed form: with multiplier lam >= 0 on c'x >= bl, KKT
stationarity pins x(lam) = clip(x0 + lam*c, xl, xu), and
g(lam) = c'x(lam) is a nondecreasing piecewise-linear function whose
breakpoints are the 2n clamp entry/exit times. Sorting the breakpoints and
interpolating the segment where g crosses bl yields the exact lam -- no
iteration, no factorization, no while_loop; a batch of B problems is B
independent (2n+2)-sorts + one (2n+2, n) contraction (`solve_box`). The
GI-seeded variant is kept as `solve_box_gi` (differential oracle, and the
literal analog of the reference's code path).

Note (matching the reference quirk at :34,59): the reported objective value
is f = 0.5 |x - x0|^2, i.e. the least-squares distance, which differs from
the canonical QP objective 0.5 x'Gx + a'x by the constant 0.5 |x0|^2.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..problems import QPProblem
from ..types import (
    INFEASIBLE,
    LOWER,
    LOWER_BOUND,
    RUNNING,
    SUCCESS,
    UPPER_BOUND,
    SolverOptions,
)
from .dense import finalize, run_loop
from .state import GIResult, GIState, initial_state

__all__ = ["solve_box", "solve_box_gi", "box_qp_problem"]


def box_qp_problem(x0, c, bl, xl, xu) -> QPProblem:
    """The equivalent dense QPProblem (G = I, a = -x0) for oracle checks."""
    n = x0.shape[0]
    inf = jnp.asarray(jnp.inf, x0.dtype)
    return QPProblem(
        G=jnp.eye(n, dtype=x0.dtype),
        a=-x0,
        C=c[None, :],
        l=jnp.asarray(bl, x0.dtype)[None] if jnp.ndim(bl) == 0 else bl,
        u=inf[None],
        xl=xl,
        xu=xu,
        objcst=0.5 * jnp.dot(x0, x0),
    )


def box_init_state(x0, c, bl, xl, xu) -> GIState:
    """Closed-form init (ref :46-94): clamp x0 into [xl, xu]; each clamped
    coordinate becomes an active bound with multiplier |x0_i - x_i|; J is a
    permutation (active coordinates in activation order first, free
    coordinates in reverse order last), R a +/-1 diagonal."""
    n = x0.shape[0]
    dt = x0.dtype
    m = 1
    low = x0 < xl
    high = x0 > xu
    clamped = low | high
    x = jnp.clip(x0, xl, xu)

    # activation order = increasing coordinate index among clamped
    csum = jnp.cumsum(clamped.astype(jnp.int32))
    q = csum[-1]
    rank = csum - 1  # rank[i] = active slot of coordinate i (if clamped)
    i_idx = jnp.arange(n)
    # J columns: clamped i -> column rank[i]; free i -> column n - i + q_i - 1
    # with q_i = number of clamped coordinates before i (ref :88).
    q_before = csum - clamped.astype(jnp.int32)
    col = jnp.where(clamped, rank, n - i_idx + q_before - 1)
    J = jnp.zeros((n, n), dt).at[i_idx, col].set(1.0)

    # R diagonal: +1 for lower-bound activations, -1 for upper (ref :68,79)
    rdiag = jnp.ones((n,), dt)
    rdiag = rdiag.at[jnp.where(clamped, rank, n - 1)].set(
        jnp.where(clamped, jnp.where(low, 1.0, -1.0), rdiag[n - 1])
    )
    # slots >= q keep 1 (identity padding); clamped ranks < q by construction
    k = jnp.arange(n)
    rdiag = jnp.where(k < q, rdiag, 1.0)
    R = jnp.diag(rdiag)

    # condensed multipliers in activation order: |x_i - x0_i|
    dist = jnp.abs(x - x0)
    u_head = jnp.zeros((n,), dt).at[jnp.where(clamped, rank, n - 1)].add(
        jnp.where(clamped, dist, 0.0)
    )
    u = jnp.concatenate([u_head, jnp.zeros((1,), dt)])
    f = 0.5 * jnp.dot(x - x0, x - x0)

    # status vector: slot 0 = the general constraint, slots 1.. = bounds
    st_b = jnp.where(
        low, LOWER_BOUND, jnp.where(high, UPPER_BOUND, 0)
    ).astype(jnp.int32)
    status = jnp.concatenate([jnp.zeros((m,), jnp.int32), st_b])
    aorder = jnp.where(
        k < q,
        jnp.zeros((n,), jnp.int32)
        .at[jnp.where(clamped, rank, n - 1)]
        .set(jnp.where(clamped, m + i_idx, 0).astype(jnp.int32)),
        -1,
    ).astype(jnp.int32)

    base = initial_state(n, m, dt)
    return GIState(
        x=x, f=f, J=J, R=R, status=status, aorder=aorder, u=u,
        q=q.astype(jnp.int32), it=base.it,
        term=jnp.asarray(RUNNING, jnp.int32), skip1=base.skip1,
        sc_idx=base.sc_idx, sc_status=base.sc_status,
    )


@functools.partial(jax.jit, static_argnames=("opt",))
def solve_box_gi(x0, c, bl, xl, xu,
                 opt: SolverOptions = SolverOptions()) -> GIResult:
    """GI-machinery variant: closed-form clamp init + generic active-set
    loop, the literal analog of the reference's code path
    (ref: BoxAndSingleConstraintSolver::solve :11-44). Kept as the
    differential oracle for :func:`solve_box`; use `solve_box` in
    production (exact, loop-free, ~an order of magnitude faster batched)."""
    pb = box_qp_problem(x0, c, bl, xl, xu)
    state = box_init_state(x0, c, jnp.asarray(bl, x0.dtype), xl, xu)
    state = run_loop(pb, state, opt)
    return finalize(pb, state)


@functools.partial(jax.jit, static_argnames=("opt",))
def solve_box(x0, c, bl, xl, xu,
              opt: SolverOptions = SolverOptions()) -> GIResult:
    """Exact closed-form solve of min 0.5|x-x0|^2 s.t. c'x >= bl,
    xl <= x <= xu (see module docstring; ref problem:
    BoxAndSingleConstraintSolver.h:15-49). ``opt`` is accepted for API
    symmetry but unused -- the solution is non-iterative. vmap/jit-clean.

    Returns the standard :class:`GIResult`; ``iterations`` is 1 when the
    general constraint is active, 0 otherwise (the clamp-only majority).
    """
    dt = x0.dtype
    n = x0.shape[0]
    bl = jnp.asarray(bl, dt)
    big = jnp.asarray(jnp.sqrt(jnp.finfo(dt).max) * 1e-3, dt)

    # clamp entry/exit times of each coordinate along x(lam) = clip(x0+lam*c)
    safe_c = jnp.where(c != 0, c, 1.0)
    r_l = (xl - x0) / safe_c
    r_u = (xu - x0) / safe_c
    tin = jnp.clip(jnp.minimum(r_l, r_u), 0.0, big)
    tout = jnp.clip(jnp.maximum(r_l, r_u), 0.0, big)
    tin = jnp.where(c != 0, tin, 0.0)
    tout = jnp.where(c != 0, tout, 0.0)
    w2 = c * c

    # g(lam) = c'x(lam) evaluated at every breakpoint (piecewise linear,
    # nondecreasing); sentinel events at 0 and `big` bracket the domain
    ts = jnp.sort(jnp.concatenate(
        [jnp.zeros((1,), dt), tin, tout, jnp.full((1,), big, dt)]))
    g0 = jnp.dot(c, jnp.clip(x0, xl, xu))
    contrib = w2[None, :] * (
        jnp.clip(ts[:, None], tin[None, :], tout[None, :]) - tin[None, :])
    gs = g0 + jnp.sum(contrib, axis=1)                     # (2n+2,)

    # scaled feasibility tolerance: a bl exactly at the box's best corner
    # (degenerate one-point feasible set) must not round to INFEASIBLE
    gscale = 1.0 + jnp.abs(g0) + jnp.abs(bl) + jnp.sum(
        w2 * jnp.where(tout < big, tout - tin, 0.0))
    tol = jnp.asarray(1e3 * jnp.finfo(dt).eps, dt) * gscale
    feasible0 = g0 >= bl
    reachable = gs[-1] >= bl - tol
    bl_eff = jnp.where(reachable, jnp.minimum(bl, gs[-1]), bl)
    # first breakpoint with g >= bl; interpolate the segment before it
    j = jnp.clip(jnp.argmax(gs >= bl_eff).astype(jnp.int32), 1, 2 * n + 1)
    t_lo, t_hi = ts[j - 1], ts[j]
    g_lo, g_hi = gs[j - 1], gs[j]
    tiny = jnp.asarray(jnp.finfo(dt).tiny, dt)
    slope = (g_hi - g_lo) / jnp.maximum(t_hi - t_lo, tiny)
    lam = t_lo + (bl_eff - g_lo) / jnp.maximum(slope, tiny)
    lam = jnp.where(feasible0 | ~reachable, 0.0, lam)

    y = x0 + lam * c
    x = jnp.clip(y, xl, xu)
    # external multipliers (kkt.py convention): G x + a + C^T u_c + u_b = 0
    # with G = I, a = -x0: u_c = -lam (active lower side), u_b = y - x
    multipliers = jnp.concatenate([-lam[None], y - x])
    f = 0.5 * jnp.dot(x - x0, x - x0)
    status = jnp.where(feasible0 | reachable, SUCCESS,
                       INFEASIBLE).astype(jnp.int32)
    active = jnp.concatenate([
        jnp.where(lam > 0, LOWER, 0)[None].astype(jnp.int32),
        jnp.where(y < xl, LOWER_BOUND,
                  jnp.where(y > xu, UPPER_BOUND, 0)).astype(jnp.int32),
    ])
    return GIResult(
        x=x,
        multipliers=multipliers,
        f=f,
        iterations=(lam > 0).astype(jnp.int32),
        status=status,
        active_set=active,
    )
