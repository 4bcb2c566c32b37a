"""GI solver over structured G (BlockGISolver analog).

A fixed-shape take on the reference's experimental::BlockGISolver
(ref: src/experimental/BlockGISolver.cpp:10-486). Design note: the reference
keeps Q implicit as an OrthonormalSequence whose apply cost grows with the
add/remove history (SURVEY.md section 3.3); that design is shape-dynamic and
maps poorly to XLA. Following SURVEY.md section 7 / M4 we instead exploit the
structure where it pays -- the O(nb * s^3) blocked factorization and
the O(n^2 s) computation of J0 = L^{-T} (vs O(n^3) dense) -- and then run
the same fixed-shape dense-J GI iteration as the dense solver. Results are
differential-tested against the dense solver at 1e-8, mirroring the
reference's structured-vs-dense tests (tests/BlockGISolverTest.in.cpp).
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import jax
import jax.numpy as jnp

from ..problems import QPProblem
from ..solver.dense import _add_initial_constraint, finalize, run_loop
from ..solver.state import GIResult, GIState, initial_state
from ..types import (
    EQUALITY,
    FIXED,
    NON_POS_HESSIAN,
    RUNNING,
    OVERCONSTRAINED_PROBLEM,
    SolverOptions,
)
from .containers import StructuredC, StructuredG

__all__ = ["solve_structured", "solve_structured_fast",
           "solve_structured_fast_batch", "solve_structured_fast_carry",
           "structured_inverse_batch", "structured_qp_problem"]


def structured_qp_problem(
    sg: StructuredG,
    a: jax.Array,
    sc: Union[StructuredC, jax.Array],
    l: jax.Array,
    u: jax.Array,
    xl: Optional[jax.Array] = None,
    xu: Optional[jax.Array] = None,
) -> QPProblem:
    """Materialize the dense QPProblem for the GI loop / oracle checks."""
    n = sg.n
    C = sc.to_dense() if isinstance(sc, StructuredC) else sc
    inf = jnp.asarray(jnp.inf, a.dtype)
    if xl is None:
        xl = jnp.full((n,), -inf, a.dtype)
    if xu is None:
        xu = jnp.full((n,), inf, a.dtype)
    return QPProblem(G=sg.to_dense(), a=a, C=C, l=l, u=u, xl=xl, xu=xu)


def structured_hooks(sc: StructuredC):
    """Block-sparsity-exploiting selection/step hooks for the GI loop.

    Fixed-shape analog of the reference's per-iteration structure exploitation
    (ref: src/experimental/BlockGISolver.cpp:117-118 block-wise C^T x in the
    selection, src/structured/StructuredJ.cpp:43-57 zero-skipping d = J^T n+
    via SingleNZSegmentVector): the selected constraint's normal is nonzero
    on a single s-wide variable block, so

    - selection computes C@x via (nb, mc, s) block matvecs: O(m s), not O(m n)
    - d = J^T n+ touches only s rows of J (dynamic slice + (s,n) matvec):
      O(n s), not O(n^2)

    Bounds are a 1-hot segment inside their variable block (the reference's
    [0; v; 0] SingleNZSegmentVector, include/jrl-qp/internal/
    SingleNZSegmentVector.h:10-61). Returns ``(select_fn, step_fn)`` for
    :func:`jrlqp_tpu.solver.dense.gi_iteration`.
    """
    from ..solver.dense import _select_violated
    from ..ops.linalg import tri_solve_masked
    from ..types import LOWER_BOUND, UPPER, UPPER_BOUND

    nb, mc, s = sc.blocks.shape

    def select_fn(pb, x, status):
        return _select_violated(pb, x, status, cx=sc.transpose_mult(x))

    def step_fn(pb, J, R, q, idx, st):
        n, m = pb.n, pb.m
        dtype = J.dtype
        sign = jnp.where((st == UPPER) | (st == UPPER_BOUND), -1.0, 1.0).astype(dtype)
        is_bnd = st >= LOWER_BOUND
        # general constraint: row (idx % mc) of block (idx // mc)
        gi = jnp.clip(idx, 0, m - 1)
        blk_g = gi // mc
        seg_g = sc.blocks[blk_g, gi % mc]
        # bound: one-hot at position (idx-m) % s of block (idx-m) // s
        bi = jnp.clip(idx - m, 0, n - 1)
        blk_b = bi // s
        seg_b = (jnp.arange(s) == bi % s).astype(dtype)
        blk = jnp.where(is_bnd, blk_b, blk_g)
        seg = sign * jnp.where(is_bnd, seg_b, seg_g)
        start = blk * s
        # d = J^T n+ touches only the segment's s rows of J
        Jrows = jax.lax.dynamic_slice(J, (start, jnp.zeros((), start.dtype)),
                                      (s, n))
        d = Jrows.T @ seg
        nplus = jax.lax.dynamic_update_slice(jnp.zeros((n,), dtype), seg,
                                             (start,))
        k = jnp.arange(n)
        z = J @ jnp.where(k >= q, d, 0.0)
        r = tri_solve_masked(R, d, q)
        return nplus, d, z, r

    return select_fn, step_fn


def init_state_structured(
    sg: StructuredG, pb: QPProblem, opt: SolverOptions, step_fn=None
) -> GIState:
    """Cold init using the structured factorization
    (ref: BlockGISolver::init_ :62-107): blocked LLT, x = -G^{-1} a via
    block solves, J = L^{-T} via a blocked multi-rhs solve; then the same
    equality/fixed auto-activation replay as the dense solver (the
    reference's structured warm start is unfinished; ours supports the cold
    path plus equalities, beyond the reference's 0-active restriction
    :474-481)."""
    n, m = pb.n, pb.m
    dt = pb.G.dtype

    fac = sg.llt()
    posdef = jnp.all(jnp.isfinite(fac.diag))
    J = fac.inverse_transpose()
    J = jnp.where(posdef, J, jnp.eye(n, dtype=dt))
    x = -fac.solve(pb.a)
    x = jnp.where(posdef, x, jnp.zeros_like(x))
    f = 0.5 * jnp.dot(pb.a, x)

    base = initial_state(n, m, dt)
    state = GIState(
        x=x, f=f, J=J, R=base.R, status=base.status, aorder=base.aorder,
        u=base.u, q=base.q, it=base.it,
        term=jnp.where(posdef, RUNNING, NON_POS_HESSIAN).astype(jnp.int32),
        skip1=base.skip1, sc_idx=base.sc_idx, sc_status=base.sc_status,
    )

    # auto-activate equalities (l == u) and fixed variables (xl == xu),
    # identical to the dense path (ref BlockGISolver shares DualSolver init)
    eq_c = pb.l == pb.u
    fix_b = pb.xl == pb.xu
    eqmask = jnp.concatenate([eq_c, fix_b])
    mt = m + n
    arange_mt = jnp.arange(mt)
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
        st = _add_initial_constraint(pb, st, idx, stats[idx], opt,
                                     step_fn=step_fn)
        return kk + 1, st

    _, state = jax.lax.while_loop(cond, body, (jnp.zeros((), jnp.int32), state))
    term = jnp.where(over & (state.term == RUNNING), OVERCONSTRAINED_PROBLEM,
                     state.term)
    return GIState(
        x=state.x, f=state.f, J=state.J, R=state.R, status=state.status,
        aorder=state.aorder, u=state.u, q=state.q, it=state.it,
        term=term.astype(jnp.int32), skip1=state.skip1,
        sc_idx=state.sc_idx, sc_status=state.sc_status,
    )


@functools.partial(jax.jit, static_argnames=("opt",))
def solve_structured(
    sg: StructuredG,
    a: jax.Array,
    sc: Union[StructuredC, jax.Array],
    l: jax.Array,
    u: jax.Array,
    xl: Optional[jax.Array] = None,
    xu: Optional[jax.Array] = None,
    opt: SolverOptions = SolverOptions(),
) -> GIResult:
    """Solve min 0.5 x'Gx + a'x s.t. l <= Cx <= u, xl <= x <= xu with G a
    StructuredG (tri-block-diagonal or block-arrow) and C optionally
    block-diagonal (ref: BlockGISolver::solve :17-60). Jitted by default.

    When C is a StructuredC, every iteration exploits its block sparsity:
    selection computes C@x blockwise and d = J^T n+ touches only the
    selected constraint's s-row block of J (see :func:`structured_hooks`),
    matching the reference's per-iteration zero-skipping
    (ref: src/structured/StructuredJ.cpp:43-57)."""
    pb = structured_qp_problem(sg, a, sc, l, u, xl, xu)
    if isinstance(sc, StructuredC):
        select_fn, step_fn = structured_hooks(sc)
    else:
        select_fn = step_fn = None
    state = init_state_structured(sg, pb, opt, step_fn=step_fn)
    state = run_loop(pb, state, opt, select_fn=select_fn, step_fn=step_fn)
    return finalize(pb, state)


def _structured_inverse(sg32: StructuredG):
    """H = G^{-1} (n, n) and the posdef flag from the blocked LLT
    (O(nb s^3) factor + O(n^2 s) J0 = L^{-T}); identity where G is not
    positive definite."""
    n = sg32.nb * sg32.s
    fac = sg32.llt()
    posdef = jnp.all(jnp.isfinite(fac.diag))
    J0 = jnp.where(posdef, fac.inverse_transpose(),
                   jnp.eye(n, dtype=sg32.diag.dtype))
    return J0 @ J0.T, posdef


def structured_inverse_batch(diag, off, gtype):
    """Batched :func:`_structured_inverse`: ``diag`` (B, nb, s, s), ``off``
    the matching off-diagonal blocks (or None). Returns (H (B, n, n),
    posdef (B,))."""
    import dataclasses as _dc

    B, nb, s, _ = diag.shape
    proto = StructuredG(diag=diag[0], off=None if off is None else off[0],
                        gtype=gtype)
    return jax.vmap(lambda d, o: _structured_inverse(
        _dc.replace(proto, diag=d, off=o)))(diag, off)


@functools.partial(jax.jit, static_argnames=("opt", "ir_steps"))
def solve_structured_fast(
    sg: StructuredG,
    a: jax.Array,
    sc: Union[StructuredC, jax.Array],
    l: jax.Array,
    u: jax.Array,
    xl: Optional[jax.Array] = None,
    xu: Optional[jax.Array] = None,
    opt: SolverOptions = SolverOptions(),
    ir_steps: int = 3,
) -> GIResult:
    """Structured problem through the explicit-operator throughput engine.

    The blocked LLT (:mod:`jrlqp_tpu.structured.blocks`, XLA scans)
    replaces the dense O(n^3) Cholesky in the f32 init; the active-set loop
    and the f64-residual refinement are the dense fast engine.
    vmap-compatible; differential-tested against :func:`solve_structured`.
    """
    import dataclasses as _dc

    from ..solver.fast import _init_fast_from_ops, _loop_xla, _opt32, _refine

    pb = structured_qp_problem(sg, a, sc, l, u, xl, xu)
    f32 = jnp.float32
    pb32 = pb.with_dtype(f32)
    sg32 = _dc.replace(
        sg, diag=sg.diag.astype(f32),
        off=None if sg.off is None else sg.off.astype(f32))
    opt32 = _opt32(opt)
    H, posdef = _structured_inverse(sg32)
    x = jnp.where(posdef, -(H @ pb32.a), 0.0)
    state = _init_fast_from_ops(pb32, H, x, posdef, opt32)
    return _refine(pb, _loop_xla(pb32, state, opt32), ir_steps)


def _batch_problems(sgs, a, scs, l, u, xl, xu):
    B = a.shape[0]
    n = sgs.nb * sgs.s
    inf = jnp.asarray(jnp.inf, a.dtype)
    if xl is None:
        xl = jnp.full((B, n), -inf, a.dtype)
    if xu is None:
        xu = jnp.full((B, n), inf, a.dtype)
    return jax.vmap(
        lambda sg, av, sc, lv, uv, xlv, xuv: structured_qp_problem(
            sg, av, sc, lv, uv, xlv, xuv))(sgs, a, scs, l, u, xl, xu)


@functools.partial(jax.jit, static_argnames=("opt", "ir_steps"))
def solve_structured_fast_batch(
    sgs: StructuredG,
    a: jax.Array,
    scs: Union[StructuredC, jax.Array],
    l: jax.Array,
    u: jax.Array,
    xl: Optional[jax.Array] = None,
    xu: Optional[jax.Array] = None,
    opt: SolverOptions = SolverOptions(),
    ir_steps: int = 3,
) -> GIResult:
    """Batched structured solve: every array is batch-leading (``sgs.diag``
    is (B, nb, s, s), ``a`` is (B, n), ...).

    The throughput form of :func:`solve_structured_fast`: the f32 init is
    the batched blocked LLT (O(nb s^3) per problem vs the dense engine's
    O(n^3) Cholesky + O(n^3) inverse assembly -- the reason the reference's
    structured layer exists, tests/BlockGISolverTest.in.cpp:251-268), the
    active-set loop is the vmapped explicit-operator iteration, and
    finalization is the batched f64-residual refinement. Semantics match
    ``vmap(solve_structured_fast)``.
    """
    from ..solver.fast import _refine_batch

    pbs, states = _solve_structured_states(sgs, a, scs, l, u, xl, xu, opt)
    return _refine_batch(pbs, states, ir_steps)


@functools.partial(jax.jit, static_argnames=("opt", "ir_steps"))
def solve_structured_fast_carry(
    sgs: StructuredG,
    a: jax.Array,
    scs: Union[StructuredC, jax.Array],
    l: jax.Array,
    u: jax.Array,
    carry=None,
    xl: Optional[jax.Array] = None,
    xu: Optional[jax.Array] = None,
    opt: SolverOptions = SolverOptions(),
    ir_steps: int = 3,
):
    """Batched structured solve for sequential trajectories (IK control
    loops, the structured layer's primary workload -- ref 'Sequential IK',
    tests/BlockGISolverTest.in.cpp:172-271). Returns ``(result, carry)``.

    The reference's structured warm start is unfinished (BlockGISolver
    asserts an empty initial active set, src/experimental/
    BlockGISolver.cpp:474-481). Here the explicit-operator form makes it
    trivial: when consecutive problems share G and C (only a / bounds
    drift), the previous solve's reduced operators ARE the warm operators
    (:class:`jrlqp_tpu.solver.fast.WarmCarry`) -- no blocked factorization,
    no identity solve, zero O(n^3)/O(nb s^3) work at solve entry. First
    call: ``carry=None`` (cold, blocked-LLT init).
    """
    import dataclasses as _dc

    from ..solver.fast import (
        WarmCarry,
        _init_fast_from_carry,
        _loop_xla,
        _opt32,
        _refine_batch,
    )

    if carry is None:
        pbs, states = _solve_structured_states(sgs, a, scs, l, u, xl, xu,
                                               opt)
    else:
        pbs = _batch_problems(sgs, a, scs, l, u, xl, xu)
        pb32 = pbs.with_dtype(jnp.float32)
        opt32 = _opt32(opt)
        state0 = jax.vmap(_init_fast_from_carry)(
            pb32, carry.H, carry.Ns, carry.status, carry.aorder, carry.q)
        if opt.validate:
            # the cold path gets this gating inside _init_fast_from_ops;
            # warm steps must honor opt.validate identically
            from ..types import INCONSISTENT_INPUT
            from ..validation import inconsistent_mask

            bad = jax.vmap(inconsistent_mask)(pb32)
            state0 = _dc.replace(state0, term=jnp.where(
                bad, INCONSISTENT_INPUT, state0.term).astype(jnp.int32))
        states = jax.vmap(lambda p, s: _loop_xla(p, s, opt32))(pb32, state0)

    res = _refine_batch(pbs, states, ir_steps)
    new_carry = WarmCarry(H=states.H, Ns=states.Ns, status=states.status,
                          aorder=states.aorder, q=states.q)
    return res, new_carry


def _solve_structured_states(sgs, a, scs, l, u, xl, xu, opt):
    """Cold-start shared body: returns (pbs, final f32 states)."""
    from ..solver.fast import _init_fast_from_ops, _loop_xla, _opt32

    f32 = jnp.float32
    pbs = _batch_problems(sgs, a, scs, l, u, xl, xu)
    pb32 = pbs.with_dtype(f32)
    opt32 = _opt32(opt)
    H, posdef = structured_inverse_batch(
        sgs.diag.astype(f32), None if sgs.off is None else sgs.off.astype(f32),
        sgs.gtype)
    x = jnp.where(posdef[:, None], -jnp.einsum("bij,bj->bi", H, pb32.a), 0.0)

    def run(p, Hi, xi, pd):
        return _loop_xla(p, _init_fast_from_ops(p, Hi, xi, pd, opt32), opt32)

    return pbs, jax.vmap(run)(pb32, H, x, posdef)
