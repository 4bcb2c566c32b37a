"""Dense Goldfarb-Idnani dual active-set solver, fixed-shape and batched.

Functional re-design of the reference's template-method loop
(ref: src/DualSolver.cpp:91-168) and its dense hooks
(ref: src/GoldfarbIdnaniSolver.cpp:56-338): one GI iteration is a pure
``GIState -> GIState`` function over fixed-shape padded arrays, the solve is
a ``lax.while_loop``, and thousands of independent problems batch through
``vmap``. There is no per-iteration recompilation and no data-dependent
shape anywhere.

Key correspondences (reference file:line -> here):
- DualSolver::solve loop          -> :func:`gi_iteration` + while_loop
- selectViolatedConstraint_ (:84) -> :func:`_select_violated` (masked argmin)
- computeStep_ (:136)             -> :func:`_compute_step`
- computeStepLength_ (:150)       -> :func:`_step_length`
- addConstraint_ (:221)           -> ops.linalg.householder_add
- removeConstraint_ (:239)        -> ops.linalg.givens_remove
- init_ (:56) + initActiveSet     -> :func:`init_state` (equality replay via
                                     a packed-index while_loop)
- multipliers() re-expansion      -> :func:`_expand_multipliers`
                                     (ref: DualSolver.cpp:38-69)
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops.linalg import givens_remove, householder_add, shift_left, tri_solve_masked
from ..problems import QPProblem
from ..types import (
    EQUALITY,
    FIXED,
    INACTIVE,
    INCONSISTENT_INPUT,
    INFEASIBLE,
    LINEAR_DEPENDENCY_DETECTED,
    LOWER,
    LOWER_BOUND,
    MAX_ITER_REACHED,
    NON_POS_HESSIAN,
    OVERCONSTRAINED_PROBLEM,
    RUNNING,
    SUCCESS,
    UPPER,
    UPPER_BOUND,
    SolverOptions,
)
from .state import GIResult, GIState, initial_state

__all__ = ["solve", "solve_batch", "init_state", "gi_iteration", "finalize"]


def _select_violated(pb: QPProblem, x: jax.Array, status: jax.Array,
                     cx: jax.Array | None = None):
    """Most-violated inactive constraint scan (ref: :84-134).

    Returns (index into [0, m+n), ActivationStatus, violation). The
    violation is negative iff a constraint is violated; argmin's
    first-occurrence tie-breaking reproduces the reference's sequential
    strict `<` scan (general constraints first, then bounds). ``cx`` lets a
    structured caller supply C@x computed blockwise (ref: BlockGISolver
    precomputes it via StructuredC::transposeMult, BlockGISolver.cpp:117)."""
    m = pb.m
    n = pb.n
    inf = jnp.asarray(jnp.inf, x.dtype)
    if cx is None:
        cx = pb.C @ x
    sl = cx - pb.l
    su = pb.u - cx
    act_c = status[:m] != INACTIVE
    cand_c = jnp.where(act_c, inf, jnp.minimum(sl, su))
    st_c = jnp.where(sl <= su, LOWER, UPPER)
    slb = x - pb.xl
    sub = pb.xu - x
    act_b = status[m:] != INACTIVE
    cand_b = jnp.where(act_b, inf, jnp.minimum(slb, sub))
    st_b = jnp.where(slb <= sub, LOWER_BOUND, UPPER_BOUND)
    cand = jnp.concatenate([cand_c, cand_b])
    sts = jnp.concatenate([st_c, st_b]).astype(jnp.int32)
    p = jnp.argmin(cand).astype(jnp.int32)
    return p, sts[p], cand[p]


def _constraint_normal(pb: QPProblem, idx: jax.Array, st: jax.Array) -> jax.Array:
    """Signed normal n+ of constraint `idx` (ref: ConstraintNormal.h:81-102).

    UPPER / UPPER_BOUND negate so internal multipliers stay >= 0.
    """
    m, n = pb.m, pb.n
    sign = jnp.where((st == UPPER) | (st == UPPER_BOUND), -1.0, 1.0).astype(pb.C.dtype)
    is_bnd = st >= LOWER_BOUND
    if m > 0:
        crow = pb.C[jnp.clip(idx, 0, m - 1)]
    else:
        crow = jnp.zeros((n,), pb.C.dtype)
    bidx = jnp.clip(idx - m, 0, n - 1)
    e = (jnp.arange(n) == bidx).astype(pb.C.dtype)
    return sign * jnp.where(is_bnd, e, crow)


def _selected_bound(pb: QPProblem, idx: jax.Array, st: jax.Array) -> jax.Array:
    """The bound value b of the selected constraint, unsigned
    (ref: :178-204 switch)."""
    m, n = pb.m, pb.n
    bi = jnp.clip(idx - m, 0, n - 1)
    if m > 0:
        ci = jnp.clip(idx, 0, m - 1)
        b_gen = jnp.where(st == UPPER, pb.u[ci], pb.l[ci])
    else:
        b_gen = jnp.zeros((), pb.G.dtype)
    b_bnd = jnp.where(st == UPPER_BOUND, pb.xu[bi], pb.xl[bi])
    return jnp.where(st >= LOWER_BOUND, b_bnd, b_gen)


def _compute_step(pb: QPProblem, J, R, q, idx, st):
    """Step 2a (ref: :136-148): d = J^T n+, z = J2 d2, r = R^{-1} d1."""
    n = pb.n
    nplus = _constraint_normal(pb, idx, st)
    d = J.T @ nplus
    k = jnp.arange(n)
    z = J @ jnp.where(k >= q, d, 0.0)
    r = tri_solve_masked(R, d, q)
    return nplus, d, z, r


def _step_length(pb, state, opt, nplus, z, r, u):
    """Step 2b (ref: :150-219): blocking dual step t1 (with the active
    position l achieving it) and full primal step t2."""
    n = pb.n
    big = jnp.asarray(opt.big_bnd, z.dtype)
    k = jnp.arange(n)
    idxs = jnp.where(k < state.q, state.aorder, 0)
    stat_k = state.status[jnp.clip(idxs, 0, state.status.shape[0] - 1)]
    eligible = (
        (k < state.q)
        & (stat_k != EQUALITY)
        & (stat_k != FIXED)
        & (r > 0)
    )
    r_safe = jnp.where(eligible, r, 1.0)
    tks = jnp.where(eligible, u[:n] / r_safe, big)
    l = jnp.argmin(tks).astype(jnp.int32)
    t1 = jnp.minimum(tks[l], big)

    znorm = jnp.linalg.norm(z)
    nz = jnp.dot(nplus, z)
    nx = jnp.dot(nplus, state.x)
    sign = jnp.where(
        (state.sc_status == UPPER) | (state.sc_status == UPPER_BOUND), -1.0, 1.0
    ).astype(z.dtype)
    b = _selected_bound(pb, state.sc_idx, state.sc_status)
    nz_safe = jnp.where(nz != 0, nz, 1.0)
    t2 = jnp.where(
        znorm > opt.zero_z_threshold, (sign * b - nx) / nz_safe, big
    )
    return t1, t2, l, nz


def _expand_multipliers(state: GIState, m: int) -> jax.Array:
    """Condensed, activation-ordered u -> full signed external multipliers
    (ref: DualSolver.cpp:38-69): negative at lower/equality, positive at
    upper activations."""
    n = state.aorder.shape[0]
    k = jnp.arange(n)
    valid = k < state.q
    idxs = jnp.where(valid, state.aorder, 0)
    stat_k = state.status[jnp.clip(idxs, 0, m + n - 1)]
    sign = jnp.where((stat_k == UPPER) | (stat_k == UPPER_BOUND), 1.0, -1.0)
    vals = jnp.where(valid, sign * state.u[:n], 0.0)
    return jnp.zeros((m + n,), state.u.dtype).at[idxs].add(vals)


def _apply_add(pb, state: GIState, d, idx, st) -> GIState:
    """Activate constraint (idx, st) and update (J, R) with a Householder
    reflector (ref: addConstraint_ :221-237 + ActiveSet::activate)."""
    J, R, dependent = householder_add(state.J, state.R, d, state.q)
    status = state.status.at[idx].set(st)
    aorder = state.aorder.at[state.q].set(idx)
    term = jnp.where(dependent, LINEAR_DEPENDENCY_DETECTED, state.term)
    return GIState(
        x=state.x, f=state.f, J=J, R=R, status=status, aorder=aorder,
        u=state.u, q=state.q + 1, it=state.it, term=term, skip1=state.skip1,
        sc_idx=state.sc_idx, sc_status=state.sc_status,
    )


def _apply_remove(pb, state: GIState, l, u_new) -> GIState:
    """Deactivate active position l (ref: DualSolver.cpp:237-244 +
    removeConstraint_ :239-256). ``u_new`` is the already-stepped multiplier
    vector, before the shift."""
    n = pb.n
    q_old = state.q
    J, R = givens_remove(state.J, state.R, q_old, l)
    rem_idx = jnp.clip(state.aorder[jnp.clip(l, 0, n - 1)], 0, state.status.shape[0] - 1)
    status = state.status.at[rem_idx].set(INACTIVE)
    aorder = shift_left(state.aorder, l, q_old - 1).at[jnp.clip(q_old - 1, 0, n - 1)].set(-1)
    u = shift_left(u_new, l, q_old)
    u = u.at[jnp.clip(q_old, 0, n)].set(0.0)
    return GIState(
        x=state.x, f=state.f, J=J, R=R, status=status, aorder=aorder,
        u=u, q=q_old - 1, it=state.it, term=state.term, skip1=state.skip1,
        sc_idx=state.sc_idx, sc_status=state.sc_status,
    )


def _tree_where(pred, a, b):
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def gi_iteration(pb: QPProblem, state: GIState, opt: SolverOptions,
                 select_fn=None, step_fn=None) -> GIState:
    """One pass of the GI dual iteration (ref: DualSolver.cpp:103-166).

    Handles selection (step 1), step computation/length (step 2), and the
    three outcomes -- full step (activate), partial step (deactivate and
    keep the candidate), dual-only step (deactivate) -- with per-lane masks
    so a vmapped batch can take different branches in one trace.

    ``select_fn`` / ``step_fn`` override the selection and step-direction
    hooks -- the functional analog of the reference's DualSolver virtual
    hooks (ref: include/jrl-qp/DualSolver.h:101-121); the structured solver
    passes block-sparsity-exploiting versions (see structured/solver.py).
    """
    n, m = pb.n, pb.m
    big = opt.big_bnd
    _select = select_fn or _select_violated
    _step = step_fn or _compute_step

    # ---- Step 1: selection (unless a partial step is in progress) ----
    sel_idx, sel_st, viol = _select(pb, state.x, state.status)
    do_select = ~state.skip1
    found = viol < 0
    success = do_select & ~found

    sc_idx = jnp.where(do_select, sel_idx, state.sc_idx)
    sc_st = jnp.where(do_select, sel_st, state.sc_status)
    u = jnp.where(do_select, state.u.at[jnp.clip(state.q, 0, n)].set(0.0), state.u)
    st1 = GIState(
        x=state.x, f=state.f, J=state.J, R=state.R, status=state.status,
        aorder=state.aorder, u=u, q=state.q, it=state.it, term=state.term,
        skip1=state.skip1, sc_idx=sc_idx, sc_status=sc_st,
    )

    # ---- Step 2: direction and step length ----
    nplus, d, z, r = _step(pb, st1.J, st1.R, st1.q, st1.sc_idx, st1.sc_status)
    t1, t2, l, nz = _step_length(pb, st1, opt, nplus, z, r, st1.u)
    t = jnp.minimum(t1, t2)

    infeasible = t >= big
    dual_step = (t2 >= big) & ~infeasible
    full_step = ~infeasible & ~dual_step & (t2 <= t1)
    partial = ~infeasible & ~dual_step & ~full_step

    # u <- u + t [-r; 1]  (candidate multiplier lives at slot q)
    k = jnp.arange(n + 1)
    uq = st1.u[jnp.clip(st1.q, 0, n)]
    r_ext = jnp.where(k[: n] < st1.q, r, 0.0)
    u_stepped = st1.u - t * jnp.concatenate([r_ext, jnp.zeros((1,), r.dtype)])
    u_stepped = u_stepped.at[jnp.clip(st1.q, 0, n)].add(t)

    # primal update (full and partial steps only; ref :145-149)
    primal = full_step | partial
    x_new = jnp.where(primal, st1.x + t * z, st1.x)
    f_new = jnp.where(primal, st1.f + t * nz * (0.5 * t + uq), st1.f)
    st2 = GIState(
        x=x_new, f=f_new, J=st1.J, R=st1.R, status=st1.status,
        aorder=st1.aorder, u=u_stepped, q=st1.q, it=st1.it, term=st1.term,
        skip1=st1.skip1, sc_idx=st1.sc_idx, sc_status=st1.sc_status,
    )

    added = _apply_add(pb, st2, d, st2.sc_idx, st2.sc_status)
    removed = _apply_remove(pb, st2, l, u_stepped)

    nxt = _tree_where(full_step, added, _tree_where(dual_step | partial, removed, st2))
    out = GIState(
        x=nxt.x, f=nxt.f, J=nxt.J, R=nxt.R, status=nxt.status,
        aorder=nxt.aorder, u=nxt.u, q=nxt.q, it=state.it + 1, term=nxt.term,
        skip1=dual_step | partial, sc_idx=nxt.sc_idx, sc_status=nxt.sc_status,
    )
    # SUCCESS / INFEASIBLE terminate before any update is applied
    # (ref: DualSolver.cpp:114,131 return straight out of the loop body);
    # the lane keeps its pre-pass state apart from the termination code.
    stopped = GIState(
        x=state.x, f=state.f, J=state.J, R=state.R, status=state.status,
        aorder=state.aorder, u=state.u, q=state.q, it=state.it,
        term=jnp.where(success, SUCCESS, INFEASIBLE).astype(jnp.int32),
        skip1=state.skip1, sc_idx=sc_idx, sc_status=sc_st,
    )
    out = _tree_where(success | infeasible, stopped, out)
    # frozen lanes (already terminated) pass through untouched
    return _tree_where(state.term == RUNNING, out, state)


def _add_initial_constraint(pb, state: GIState, idx, st, opt,
                            step_fn=None) -> GIState:
    """Replay of addInitialConstraint (ref: :295-338): full step onto an
    equality/fixed-variable constraint, then activate it."""
    n = pb.n
    u = state.u.at[jnp.clip(state.q, 0, n)].set(0.0)
    _step = step_fn or _compute_step
    nplus, d, z, r = _step(pb, state.J, state.R, state.q, idx, st)
    znorm = jnp.linalg.norm(z)
    nz = jnp.dot(nplus, z)
    nx = jnp.dot(nplus, state.x)
    b = _selected_bound(pb, idx, st)  # EQUALITY -> l, FIXED -> xl; sign +1
    nz_safe = jnp.where(nz != 0, nz, 1.0)
    t = jnp.where(znorm > opt.zero_z_threshold, (b - nx) / nz_safe, 0.0)
    x = state.x + t * z
    uq = u[jnp.clip(state.q, 0, n)]
    f = state.f + t * nz * (0.5 * t + uq)
    k = jnp.arange(n + 1)
    r_ext = jnp.where(k[:n] < state.q, r, 0.0)
    u = u - t * jnp.concatenate([r_ext, jnp.zeros((1,), r.dtype)])
    u = u.at[jnp.clip(state.q, 0, n)].add(t)
    st2 = GIState(
        x=x, f=f, J=state.J, R=state.R, status=state.status,
        aorder=state.aorder, u=u, q=state.q, it=state.it, term=state.term,
        skip1=state.skip1, sc_idx=state.sc_idx, sc_status=state.sc_status,
    )
    return _apply_add(pb, st2, d, idx, st)


def init_state(pb: QPProblem, opt: SolverOptions) -> GIState:
    """Cold-start init (ref: init_ :56-82 + initActiveSet :268-287):
    Cholesky of G, J = L^{-T}, x = -G^{-1} a, then auto-activation of
    equality constraints (l == u) and fixed variables (xl == xu)."""
    n, m = pb.n, pb.m
    dt = pb.G.dtype
    L = jnp.linalg.cholesky(pb.G)
    posdef = jnp.all(jnp.isfinite(jnp.diagonal(L)))
    Lsafe = jnp.where(posdef, L, jnp.eye(n, dtype=dt))
    eye = jnp.eye(n, dtype=dt)
    # J = L^{-T}
    J = jax.lax.linalg.triangular_solve(
        Lsafe, eye, left_side=True, lower=True, transpose_a=True
    )
    y = jax.lax.linalg.triangular_solve(
        Lsafe, pb.a[:, None], left_side=True, lower=True
    )[:, 0]
    x = -jax.lax.linalg.triangular_solve(
        Lsafe, y[:, None], left_side=True, lower=True, transpose_a=True
    )[:, 0]
    f = 0.5 * jnp.dot(pb.a, x)

    state = initial_state(n, m, dt)
    state = GIState(
        x=x, f=f, J=J, R=state.R, status=state.status, aorder=state.aorder,
        u=state.u, q=state.q, it=state.it,
        term=jnp.where(posdef, RUNNING, NON_POS_HESSIAN).astype(jnp.int32),
        skip1=state.skip1, sc_idx=state.sc_idx, sc_status=state.sc_status,
    )

    # ---- auto-activate equalities and fixed variables ----
    eq_c = pb.l == pb.u
    fix_b = pb.xl == pb.xu
    eqmask = jnp.concatenate([eq_c, fix_b])
    mt = m + n
    arange_mt = jnp.arange(mt)
    # packed list: the first `neq` entries of perm are the equality indices
    perm = jnp.argsort(jnp.where(eqmask, arange_mt, mt + arange_mt)).astype(jnp.int32)
    neq = jnp.sum(eqmask).astype(jnp.int32)
    over = neq > n
    stats = jnp.where(arange_mt < m, EQUALITY, FIXED).astype(jnp.int32)

    def cond(carry):
        kk, st = carry
        return (kk < neq) & (st.term == RUNNING)

    def body(carry):
        kk, st = carry
        idx = perm[kk]
        st = _add_initial_constraint(pb, st, idx, stats[idx], opt)
        return kk + 1, st

    _, state = jax.lax.while_loop(cond, body, (jnp.zeros((), jnp.int32), state))
    term = jnp.where(over & (state.term == RUNNING), OVERCONSTRAINED_PROBLEM, state.term)
    if opt.validate:
        from ..validation import inconsistent_mask

        term = jnp.where(inconsistent_mask(pb), INCONSISTENT_INPUT, term)
    return GIState(
        x=state.x, f=state.f, J=state.J, R=state.R, status=state.status,
        aorder=state.aorder, u=state.u, q=state.q, it=state.it,
        term=term.astype(jnp.int32), skip1=state.skip1, sc_idx=state.sc_idx,
        sc_status=state.sc_status,
    )


def run_loop(pb: QPProblem, state: GIState, opt: SolverOptions,
             select_fn=None, step_fn=None) -> GIState:
    """Iterate until termination or max_iter (ref: DualSolver.cpp:103-167)."""
    max_iter = jnp.asarray(opt.max_iter, jnp.int32)

    def cond(st):
        return (st.term == RUNNING) & (st.it < max_iter)

    def body(st):
        return gi_iteration(pb, st, opt, select_fn=select_fn, step_fn=step_fn)

    state = jax.lax.while_loop(cond, body, state)
    term = jnp.where(state.term == RUNNING, MAX_ITER_REACHED, state.term)
    return GIState(
        x=state.x, f=state.f, J=state.J, R=state.R, status=state.status,
        aorder=state.aorder, u=state.u, q=state.q, it=state.it,
        term=term.astype(jnp.int32), skip1=state.skip1, sc_idx=state.sc_idx,
        sc_status=state.sc_status,
    )


def finalize(pb: QPProblem, state: GIState) -> GIResult:
    return GIResult(
        x=state.x,
        multipliers=_expand_multipliers(state, pb.m),
        f=state.f,
        iterations=state.it,
        status=state.term,
        active_set=state.status,
    )


def _solve_impl(pb: QPProblem, opt: SolverOptions = SolverOptions()) -> GIResult:
    state = init_state(pb, opt)
    state = run_loop(pb, state, opt)
    return finalize(pb, state)


@functools.partial(jax.jit, static_argnames=("opt",))
def solve(pb: QPProblem, opt: SolverOptions = SolverOptions()) -> GIResult:
    """Solve one QP with the dense Goldfarb-Idnani dual active-set method.

    Equivalent to jrl::qp::GoldfarbIdnaniSolver::solve
    (ref: src/GoldfarbIdnaniSolver.cpp:18-54); unlike the reference, G is
    not destroyed (functional style). Jitted by default (one compilation
    per padded shape -- the analog of the reference's malloc-free
    resize-once-solve-many contract); composes with jit/vmap/shard_map.
    """
    return _solve_impl(pb, opt)


@functools.partial(jax.jit, static_argnames=("opt",))
def solve_batch(pbs: QPProblem, opt: SolverOptions = SolverOptions()) -> GIResult:
    """vmapped batched solve: every leaf of `pbs` has a leading batch dim."""
    return jax.vmap(lambda p: _solve_impl(p, opt))(pbs)
