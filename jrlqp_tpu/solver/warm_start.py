"""Warm-started Goldfarb-Idnani solve.

Fixed-shape re-design of the reference's experimental warm-start solver
(ref: src/experimental/GoldfarbIdnaniSolver.cpp:66-488): an activation-status
vector (the previous solve's active set) seeds the initial active set; the
factorizations (J, R) are rebuilt with one batched QR; the primal/dual point
comes from the closed-form alpha/beta formulas of notes/DualQP notes.tex; and
warm-start hints that turned out wrong (u < 0) are deactivated one by one
before entering the normal iteration loop.

Pipeline (reference anchors):
- processInitialActiveSet      (ref :306-390) -> :func:`_process_initial_active_set`
- initializeComputationData    (ref :392-460) -> :func:`_initialize_computation_data`
- initializePrimalDualPoints   (ref :462-486) -> :func:`_initialize_primal_dual`
- post-init u<0 deactivation   (ref :83-108)  -> while_loop in :func:`warm_init_state`
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops.linalg import givens_remove, shift_left, tri_solve_masked
from ..problems import QPProblem
from ..types import (
    EQUALITY,
    FIXED,
    INACTIVE,
    LOWER,
    LOWER_BOUND,
    NON_POS_HESSIAN,
    OVERCONSTRAINED_PROBLEM,
    RUNNING,
    UPPER,
    UPPER_BOUND,
    SolverOptions,
)
from .dense import _constraint_normal, finalize, run_loop
from .state import GIResult, GIState, initial_state

__all__ = ["solve_warm", "warm_init_state"]


def _process_initial_active_set(pb: QPProblem, as_hint: jax.Array, opt: SolverOptions):
    """Decide the initial active set (ref :306-390).

    Scan order is bounds first then general constraints (that is the
    reference's activation order, which determines both the condensed-u
    layout and which hints get dropped on overflow). Problem equalities
    (l == u, xl == xu) always activate; warm-start hints are validated
    (FIXED on unequal bounds ignored, activations at infinite bounds
    ignored); if more than n constraints remain, inequalities are
    deactivated from the back.

    Returns (status (m+n,), aorder (n,), q, overconstrained).
    """
    m, n = pb.m, pb.n
    mt = m + n
    big = opt.big_bnd
    # Hints are only honored when warm start is enabled (ref :321, :348:
    # `!pb_.as.empty() && options_.warmStart_`); problem equalities always
    # activate.
    use_hint = bool(opt.warm_start)

    # --- bounds pass (hint slots m..m+n-1) ---
    hb = as_hint[m:]
    fixed = pb.xl == pb.xu
    hb_valid = use_hint & (
        ((hb == LOWER_BOUND) & (pb.xl >= -big))
        | ((hb == UPPER_BOUND) & (pb.xu <= big))
    )
    st_b = jnp.where(fixed, FIXED, jnp.where(hb_valid, hb, INACTIVE)).astype(jnp.int32)

    # --- constraints pass (hint slots 0..m-1) ---
    hc = as_hint[:m]
    eq = pb.l == pb.u
    hc_valid = use_hint & (
        ((hc == LOWER) & (pb.l >= -big)) | ((hc == UPPER) & (pb.u <= big))
    )
    st_c = jnp.where(eq, EQUALITY, jnp.where(hc_valid, hc, INACTIVE)).astype(jnp.int32)

    status = jnp.concatenate([st_c, st_b])

    # activation priority: bounds (0..n-1) then constraints (n..n+m-1)
    prio = jnp.concatenate([n + jnp.arange(m), jnp.arange(n)]).astype(jnp.int32)
    act = status != INACTIVE
    n_act = jnp.sum(act).astype(jnp.int32)
    hard = act & ((status == EQUALITY) | (status == FIXED))
    n_hard = jnp.sum(hard).astype(jnp.int32)
    over = n_hard > n

    # Overflow: deactivate removable (non-equality/fixed) actives working
    # BACKWARD from the last-activated (ref :369-390). Bounds activate
    # before constraints, so high-index general constraints drop first.
    excess = jnp.maximum(n_act - n, 0)
    removable = act & ~hard
    # ascending argsort on -prio puts the removable entry with the LARGEST
    # activation priority (= last activated) first; non-removable entries
    # get +INT_MAX so they sort past every removable one.
    key = jnp.where(removable, -prio, jnp.iinfo(jnp.int32).max)
    drop_order = jnp.argsort(key).astype(jnp.int32)
    dropped = jnp.arange(mt) < excess
    status = status.at[drop_order].set(
        jnp.where(dropped, INACTIVE, status[drop_order])
    )
    act = status != INACTIVE
    q = jnp.sum(act).astype(jnp.int32)

    # activation order: active entries sorted by priority
    order_key = jnp.where(act, prio, mt + n + 1)
    aorder_full = jnp.argsort(order_key).astype(jnp.int32)
    k = jnp.arange(n)
    aorder = jnp.where(k < q, aorder_full[:n], -1).astype(jnp.int32)
    return status, aorder, q, over


def _active_normals_and_bounds(pb: QPProblem, status, aorder, q):
    """N (n, n) with column k = signed normal of the k-th active constraint
    (zero beyond q), and b_act (n,) the matching signed bounds
    (ref :392-427)."""
    n = pb.n
    m = pb.m
    k = jnp.arange(n)
    valid = k < q
    idxs = jnp.where(valid, aorder, 0)
    sts = status[jnp.clip(idxs, 0, m + n - 1)]

    def one(idx, st, v):
        col = _constraint_normal(pb, idx, st) * v
        # signed bound: LOWER/EQUALITY -> l, UPPER -> -u,
        # LOWER_BOUND/FIXED -> xl, UPPER_BOUND -> -xu
        if m > 0:
            ci = jnp.clip(idx, 0, m - 1)
            b_gen = jnp.where(st == UPPER, -pb.u[ci], pb.l[ci])
        else:
            b_gen = jnp.zeros((), pb.G.dtype)
        bi = jnp.clip(idx - m, 0, n - 1)
        b_bnd = jnp.where(st == UPPER_BOUND, -pb.xu[bi], pb.xl[bi])
        b = jnp.where(st >= LOWER_BOUND, b_bnd, b_gen) * v
        return col, b

    cols, b_act = jax.vmap(one)(idxs, sts, valid.astype(pb.G.dtype))
    return cols.T, b_act  # (n, n), (n,)


def _initialize_computation_data(pb: QPProblem, status, aorder, q):
    """J = L^{-T} Q, R from the QR of B = L^{-1} N (ref :392-460).

    Inactive columns of R are reset to identity so the masked triangular
    solves stay well-posed.
    """
    n = pb.n
    dt = pb.G.dtype
    L = jnp.linalg.cholesky(pb.G)
    posdef = jnp.all(jnp.isfinite(jnp.diagonal(L)))
    Lsafe = jnp.where(posdef, L, jnp.eye(n, dtype=dt))
    N, b_act = _active_normals_and_bounds(pb, status, aorder, q)
    B = jax.lax.linalg.triangular_solve(Lsafe, N, left_side=True, lower=True)
    Q, R = jnp.linalg.qr(B, mode="complete")
    # identity-pad inactive columns of R (cols >= q)
    k = jnp.arange(n)
    eye = jnp.eye(n, dtype=dt)
    R = jnp.where(k[None, :] >= q, eye, jnp.triu(R))
    J0 = jax.lax.linalg.triangular_solve(
        Lsafe, eye, left_side=True, lower=True, transpose_a=True
    )
    J = J0 @ Q
    return J, R, b_act, posdef


def _initialize_primal_dual(pb: QPProblem, J, R, b_act, q):
    """alpha/beta closed form (ref :462-486, notes/DualQP notes.tex):
    alpha = J^T a, beta = R1^{-T} b_act, x = J1 beta - J2 alpha2,
    u = R1^{-1} (alpha1 + beta), f = beta.(0.5 beta + alpha1) - 0.5|alpha2|^2.
    """
    n = pb.n
    k = jnp.arange(n)
    head = k < q
    alpha = J.T @ pb.a
    bh = jnp.where(head, b_act, 0.0)
    beta = jax.lax.linalg.triangular_solve(
        R, bh[:, None], left_side=True, lower=False, transpose_a=True
    )[:, 0]
    beta = jnp.where(head, beta, 0.0)
    alpha1 = jnp.where(head, alpha, 0.0)
    alpha2 = jnp.where(head, 0.0, alpha)
    x = J @ jnp.where(head, beta, -alpha2)
    u_head = tri_solve_masked(R, alpha1 + beta, q)
    f = jnp.dot(beta, 0.5 * beta + alpha1) - 0.5 * jnp.dot(alpha2, alpha2)
    u = jnp.concatenate([u_head, jnp.zeros((1,), u_head.dtype)])
    return x, u, f


def warm_init_state(pb: QPProblem, as_hint: jax.Array, opt: SolverOptions) -> GIState:
    """Warm-start initialization (ref init_ :66-111)."""
    n, m = pb.n, pb.m
    dt = pb.G.dtype
    status, aorder, q, over = _process_initial_active_set(pb, as_hint, opt)
    J, R, b_act, posdef = _initialize_computation_data(pb, status, aorder, q)
    x, u, f = _initialize_primal_dual(pb, J, R, b_act, q)

    base = initial_state(n, m, dt)
    term = jnp.where(
        over, OVERCONSTRAINED_PROBLEM, jnp.where(posdef, RUNNING, NON_POS_HESSIAN)
    ).astype(jnp.int32)
    state = GIState(
        x=x, f=f, J=J, R=R, status=status, aorder=aorder, u=u, q=q,
        it=base.it, term=term, skip1=base.skip1, sc_idx=base.sc_idx,
        sc_status=base.sc_status,
    )

    # --- deactivate wrongly-hinted constraints with u < 0 (ref :83-108) ---
    def worst(st):
        k = jnp.arange(n)
        idxs = jnp.where(k < st.q, st.aorder, 0)
        sts = st.status[jnp.clip(idxs, 0, m + n - 1)]
        elig = (k < st.q) & (sts != EQUALITY) & (sts != FIXED)
        vals = jnp.where(elig, st.u[:n], 0.0)
        lmin = jnp.argmin(vals).astype(jnp.int32)
        return lmin, vals[lmin]

    def cond(carry):
        st, _ = carry
        lmin, umin = worst(st)
        return (st.term == RUNNING) & (umin < -1e-14)

    def body(carry):
        st, b_act = carry
        lmin, _ = worst(st)
        J2, R2 = givens_remove(st.J, st.R, st.q, lmin)
        rem_idx = jnp.clip(st.aorder[jnp.clip(lmin, 0, n - 1)], 0, m + n - 1)
        status2 = st.status.at[rem_idx].set(INACTIVE)
        aorder2 = shift_left(st.aorder, lmin, st.q - 1).at[
            jnp.clip(st.q - 1, 0, n - 1)
        ].set(-1)
        b_act2 = shift_left(b_act, lmin, st.q - 1)
        b_act2 = b_act2.at[jnp.clip(st.q - 1, 0, n - 1)].set(0.0)
        q2 = st.q - 1
        x2, u2, f2 = _initialize_primal_dual(pb, J2, R2, b_act2, q2)
        st2 = GIState(
            x=x2, f=f2, J=J2, R=R2, status=status2, aorder=aorder2, u=u2,
            q=q2, it=st.it + 1, term=st.term, skip1=st.skip1,
            sc_idx=st.sc_idx, sc_status=st.sc_status,
        )
        return st2, b_act2

    state, _ = jax.lax.while_loop(cond, body, (state, b_act))
    return state


def _solve_warm_impl(pb: QPProblem, as_hint: jax.Array,
                     opt: SolverOptions = SolverOptions()) -> GIResult:
    state = warm_init_state(pb, as_hint, opt)
    state = run_loop(pb, state, opt)
    return finalize(pb, state)


@functools.partial(jax.jit, static_argnames=("opt",))
def solve_warm(pb: QPProblem, as_hint: jax.Array,
               opt: SolverOptions = SolverOptions()) -> GIResult:
    """Warm-started solve: `as_hint` is a (m+n,) ActivationStatus vector,
    e.g. a previous :class:`GIResult`'s ``active_set``
    (ref: experimental::GoldfarbIdnaniSolver::solve :20-64). Jitted by
    default; composes with jit/vmap."""
    return _solve_warm_impl(pb, as_hint, opt)
