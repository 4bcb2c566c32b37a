"""Iteration tracing / observability.

JAX stand-in for the reference's Matlab-emitting Logger
(ref: include/jrl-qp/utils/Logger.h:18-166, utils/debug.h:60-86,
enums.h LogFlags). Host-side streaming from inside a jitted while-loop is
impossible, so traces are *returned as arrays*: preallocated
(max_iter, ...) buffers written at index ``it`` each iteration, with a
validity mask. Flags mirror LogFlags; unset groups cost nothing (buffers of
size 0 are simply absent from the pytree).

Usage::

    res, trace = solve_traced(pb, opt, LogFlags.ITERATION_BASIC_DETAILS)
    trace.x[: int(res.iterations)]   # per-iteration primal iterates

``dump_matlab`` renders a trace to the reference Logger's Matlab-script
format (``name(iter).var = [...]``) for drop-in use of existing analysis
scripts.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..problems import QPProblem
from ..solver.dense import finalize, gi_iteration, init_state
from ..solver.state import GIResult, GIState
from ..types import MAX_ITER_REACHED, RUNNING, SolverOptions

__all__ = ["LogFlags", "IterationTrace", "solve_traced",
           "solve_fast_traced", "capture_pallas_trajectory", "dump_matlab"]


class LogFlags(enum.IntFlag):
    """(ref: enums.h:40-52)."""

    NONE = 0
    ITERATION_BASIC_DETAILS = 1 << 0  # x, f, q, selected constraint
    ITERATION_ADVANCE_DETAILS = 1 << 1  # u (condensed multipliers)
    ACTIVE_SET = 1 << 2  # status vector per iteration
    ACTIVE_SET_DETAILS = 1 << 3  # activation order per iteration
    INIT = 1 << 4  # state right after init
    TERMINATION = 1 << 5  # final status (always cheap, kept in result)
    NO_ITER = 1 << 6  # reference's noIterationFlag (global data)
    ALL = (1 << 7) - 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IterationTrace:
    """Fixed-shape per-iteration records; rows >= iterations are garbage
    (mask with ``valid``)."""

    valid: jax.Array  # (T,) bool
    x: Optional[jax.Array]  # (T, n)
    f: Optional[jax.Array]  # (T,)
    q: Optional[jax.Array]  # (T,) int32
    sc_idx: Optional[jax.Array]  # (T,) int32 selected constraint
    sc_status: Optional[jax.Array]  # (T,) int32
    u: Optional[jax.Array]  # (T, n+1)
    status: Optional[jax.Array]  # (T, m+n) int8
    aorder: Optional[jax.Array]  # (T, n) int32


def _empty_trace(flags: LogFlags, T: int, n: int, m: int, dtype) -> IterationTrace:
    basic = bool(flags & LogFlags.ITERATION_BASIC_DETAILS)
    adv = bool(flags & LogFlags.ITERATION_ADVANCE_DETAILS)
    aset = bool(flags & LogFlags.ACTIVE_SET)
    adet = bool(flags & LogFlags.ACTIVE_SET_DETAILS)
    z = jnp.zeros
    return IterationTrace(
        valid=z((T,), bool),
        x=z((T, n), dtype) if basic else None,
        f=z((T,), dtype) if basic else None,
        q=z((T,), jnp.int32) if basic else None,
        sc_idx=z((T,), jnp.int32) if basic else None,
        sc_status=z((T,), jnp.int32) if basic else None,
        u=z((T, n + 1), dtype) if adv else None,
        status=z((T, m + n), jnp.int8) if aset else None,
        aorder=z((T, n), jnp.int32) if adet else None,
    )


def _record(tr: IterationTrace, st: GIState, i) -> IterationTrace:
    def setrow(buf, val):
        return None if buf is None else buf.at[i].set(val)

    return IterationTrace(
        valid=tr.valid.at[i].set(True),
        x=setrow(tr.x, st.x),
        f=setrow(tr.f, st.f),
        q=setrow(tr.q, st.q),
        sc_idx=setrow(tr.sc_idx, st.sc_idx),
        sc_status=setrow(tr.sc_status, st.sc_status),
        u=setrow(tr.u, st.u),
        status=None if tr.status is None else tr.status.at[i].set(
            st.status.astype(jnp.int8)
        ),
        aorder=setrow(tr.aorder, st.aorder),
    )


def solve_traced(
    pb: QPProblem,
    opt: SolverOptions = SolverOptions(),
    flags: LogFlags = LogFlags.ITERATION_BASIC_DETAILS,
):
    """Like :func:`jrlqp_tpu.solve` but also returns an IterationTrace.
    jit/vmap-compatible; tracing costs one buffer write per iteration."""
    n, m = pb.n, pb.m
    state = init_state(pb, opt)
    T = opt.max_iter
    trace = _empty_trace(flags, T, n, m, pb.G.dtype)
    if flags & LogFlags.INIT:
        trace = _record(trace, state, 0)
    max_iter = jnp.asarray(opt.max_iter, jnp.int32)

    def cond(carry):
        st, _ = carry
        return (st.term == RUNNING) & (st.it < max_iter)

    def body(carry):
        st, tr = carry
        st2 = gi_iteration(pb, st, opt)
        # the terminating pass (SUCCESS/INFEASIBLE detection) does not
        # advance `it` and must not be recorded -- it changes no state
        advanced = st2.it != st.it
        tr2 = _record(tr, st2, jnp.clip(st.it, 0, T - 1))
        tr = jax.tree.map(
            lambda a, b: jnp.where(advanced, b, a), tr, tr2
        )
        return st2, tr

    state, trace = jax.lax.while_loop(cond, body, (state, trace))
    term = jnp.where(state.term == RUNNING, MAX_ITER_REACHED, state.term)
    state = dataclasses.replace(state, term=term.astype(jnp.int32))
    return finalize(pb, state), trace


def solve_fast_traced(
    pb: QPProblem,
    opt: SolverOptions = SolverOptions(),
    flags: LogFlags = LogFlags.ITERATION_BASIC_DETAILS,
):
    """Like :func:`jrlqp_tpu.solver.fast.solve_fast` but also returns an
    IterationTrace — observability for the explicit-operator engine that
    actually runs in production (the reference Logger wraps every solver,
    ref: include/jrl-qp/utils/Logger.h:18-166). ``FastState`` shares the
    traced fields (x, f, q, u, status, aorder, selected constraint) with
    the dense ``GIState``, so the same buffers and ``dump_matlab`` apply.
    jit/vmap-compatible."""
    from ..solver.fast import _finalize, _init_fast, fast_iteration

    n, m = pb.n, pb.m
    state = _init_fast(pb, opt)
    T = opt.max_iter
    trace = _empty_trace(flags, T, n, m, pb.G.dtype)
    if flags & LogFlags.INIT:
        trace = _record(trace, state, 0)
    max_iter = jnp.asarray(opt.max_iter, jnp.int32)

    def cond(carry):
        st, _ = carry
        return (st.term == RUNNING) & (st.it < max_iter)

    def body(carry):
        st, tr = carry
        st2 = fast_iteration(pb, st, opt)
        advanced = st2.it != st.it
        tr2 = _record(tr, st2, jnp.clip(st.it, 0, T - 1))
        tr = jax.tree.map(lambda a, b: jnp.where(advanced, b, a), tr, tr2)
        return st2, tr

    state, trace = jax.lax.while_loop(cond, body, (state, trace))
    term = jnp.where(state.term == RUNNING, MAX_ITER_REACHED, state.term)
    state = dataclasses.replace(state, term=term.astype(jnp.int32))
    return _finalize(pb, state), trace


def capture_pallas_trajectory(
    pb: QPProblem,
    opt: SolverOptions = SolverOptions(),
    n_iters: int = 16,
    interpret: bool = False,
):
    """Per-iteration state capture for the whole-solve loop kernel.

    The kernel runs its while-loop inside one launch, so intermediate
    states are not observable from a single launch. This debug helper
    re-runs the kernel with the iteration cap set to 1..n_iters from the
    same init and stacks the reached states (``interpret=True`` runs the
    kernel in the Pallas interpreter, as it must off the GPU) —
    O(n_iters^2) kernel work, intended for inspecting XLA-vs-kernel
    divergence on one problem, not for production. Returns a dict of
    (n_iters, ...) arrays: x, u, q, it, term.
    """
    from ..ops.pallas.gi_kernel import run_loop_pallas
    from ..solver.fast import _init_fast, _opt32

    pb32 = jax.tree.map(
        lambda a: a[None], pb.with_dtype(jnp.float32))  # batch of 1
    opt32 = _opt32(opt)
    state0 = jax.vmap(lambda p: _init_fast(p, opt32))(pb32)
    rows = {k: [] for k in ("x", "u", "q", "it", "term")}
    for cap in range(1, n_iters + 1):
        out = run_loop_pallas(pb32, state0, cap, interpret=interpret)
        for k in rows:
            rows[k].append(np.asarray(getattr(out, k)[0]))
    return {k: np.stack(v) for k, v in rows.items()}


def dump_matlab(name: str, trace: IterationTrace, res: GIResult) -> str:
    """Render a trace as a Matlab script, one ``name(iter).var = ...``
    assignment per record (ref: Logger.h iteration-indexed logs +
    toMatlab.h formatting)."""
    out = []
    valid = np.asarray(trace.valid)
    T = int(valid.sum())

    def mat(v):
        a = np.atleast_2d(np.asarray(v, dtype=float))
        rows = ";".join(",".join(repr(float(x)) for x in row) for row in a)
        return f"[{rows}]"

    for i in range(T):
        for field in ("x", "f", "q", "sc_idx", "sc_status", "u"):
            buf = getattr(trace, field)
            if buf is not None:
                out.append(f"{name}({i + 1}).{field} = {mat(buf[i])};")
        if trace.status is not None:
            out.append(f"{name}({i + 1}).status = {mat(trace.status[i])};")
        if trace.aorder is not None:
            out.append(f"{name}({i + 1}).aorder = {mat(trace.aorder[i])};")
    out.append(f"{name}_final.x = {mat(res.x)};")
    out.append(f"{name}_final.status = {int(res.status)};")
    out.append(f"{name}_final.iterations = {int(res.iterations)};")
    return "\n".join(out) + "\n"
