"""Solver state and result pytrees.

The reference keeps solver state in mutable member workspaces
(ref: include/jrl-qp/DualSolver.h:123-142, internal/ActiveSet.h:150-168).
This build replaces them with one immutable fixed-shape pytree per
problem; a batch is the vmapped stack of these.

Active-set representation (ref: internal/ActiveSet.h dual view):
- ``status``: (m+n,) int32 ActivationStatus per constraint (general
  constraints first, then variable bounds) -- the full status vector.
- ``aorder``: (n,) int32 indices of active constraints *in activation
  order* (-1 padded). Removal is by position in this order and the
  condensed multipliers ``u`` are stored in the same order, exactly like
  the reference (DualSolver.cpp:237-244).
- ``q``: number of active constraints.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..types import RUNNING

__all__ = ["GIState", "GIResult"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GIState:
    x: jax.Array  # (n,) primal iterate
    f: jax.Array  # () objective value
    J: jax.Array  # (n, n) J = L^{-T} Q
    R: jax.Array  # (n, n) upper triangular, identity-padded beyond q
    status: jax.Array  # (m+n,) int32 ActivationStatus
    aorder: jax.Array  # (n,) int32 active indices in activation order
    u: jax.Array  # (n+1,) condensed multipliers in activation order
    q: jax.Array  # () int32 number of active constraints
    it: jax.Array  # () int32 iteration counter
    term: jax.Array  # () int32 TerminationStatus (RUNNING while iterating)
    skip1: jax.Array  # () bool: skip selection (partial step in progress)
    sc_idx: jax.Array  # () int32 selected constraint index
    sc_status: jax.Array  # () int32 selected constraint ActivationStatus


def initial_state(n: int, m: int, dtype) -> GIState:
    return GIState(
        x=jnp.zeros((n,), dtype),
        f=jnp.zeros((), dtype),
        J=jnp.eye(n, dtype=dtype),
        R=jnp.eye(n, dtype=dtype),
        status=jnp.zeros((m + n,), jnp.int32),
        aorder=jnp.full((n,), -1, jnp.int32),
        u=jnp.zeros((n + 1,), dtype),
        q=jnp.zeros((), jnp.int32),
        it=jnp.zeros((), jnp.int32),
        term=jnp.full((), RUNNING, jnp.int32),
        skip1=jnp.zeros((), bool),
        sc_idx=jnp.full((), -1, jnp.int32),
        sc_status=jnp.zeros((), jnp.int32),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GIResult:
    """Solve result. ``multipliers`` are in the reference's *external*
    convention (ref: DualSolver.cpp:38-69): full (m+n,) vector, negative at
    active lower bounds / equalities, positive at active upper bounds.
    """

    x: jax.Array  # (n,)
    multipliers: jax.Array  # (m+n,)
    f: jax.Array  # () objective value (without the problem's objcst)
    iterations: jax.Array  # () int32
    status: jax.Array  # () int32 TerminationStatus
    active_set: jax.Array  # (m+n,) int32 ActivationStatus (for warm start)

    @property
    def success(self):
        return self.status == 0
