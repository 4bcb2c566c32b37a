"""Fixed-shape masked linear-algebra primitives for the GI solver.

These are the fixed-shape replacements for the reference's in-place Eigen
updates (ref: src/GoldfarbIdnaniSolver.cpp:221-256). Everything operates on
padded (n, n) arrays with a dynamic active count ``q``; loop trip counts are
static, data-dependence is expressed through masks so a single jitted
``while_loop`` body serves every lane of a vmapped batch.

Design choices vs the reference:

- addConstraint's Givens chain (ref :226-231, with the reference's own
  "[OPTIM] use Householder transformation instead" note) is implemented as a
  single masked Householder reflector: one gemv + one rank-1 update on J --
  O(n(n-q)) batched work instead of n sequential rotations.
- removeConstraint's Hessenberg restore (ref :239-256) keeps the sequential
  Givens sweep (the rotations are data-dependent through the running R), as
  a fixed-trip ``fori_loop`` with per-step masks.
- R keeps nonzero diagonal entries on inactive columns (identity padding),
  so a full n x n triangular solve of a head-masked rhs yields exactly the
  q-dimensional solve the reference performs on the active block.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "tri_solve_masked",
    "householder_add",
    "givens_remove",
    "shift_left",
]


def tri_solve_masked(R: jax.Array, d: jax.Array, q: jax.Array) -> jax.Array:
    """r = R[:q,:q]^{-1} d[:q], zero-padded to length n.

    Requires R upper-triangular with nonzero diagonal everywhere (inactive
    columns are identity-padded). (ref: src/GoldfarbIdnaniSolver.cpp:146
    ``r = R.solve(d.head(q))``.)
    """
    n = d.shape[0]
    head = jnp.arange(n) < q
    dh = jnp.where(head, d, 0.0)
    r = jax.lax.linalg.triangular_solve(
        R, dh[:, None], left_side=True, lower=False
    )[:, 0]
    return jnp.where(head, r, 0.0)


def householder_add(J: jax.Array, R: jax.Array, d: jax.Array, q: jax.Array):
    """Add a constraint: zero d[q+1:] with one Householder reflector H acting
    on indices >= q, update J <- J H, and write the new column q of R.

    Returns (J_new, R_new, dependent) where ``dependent`` flags a (near-)zero
    tail, i.e. the new constraint normal is linearly dependent on the active
    set. (ref: src/GoldfarbIdnaniSolver.cpp:221-237 does this with a Givens
    chain and always returns true; we surface the dependency flag so the
    caller can keep or use it.)
    """
    n = d.shape[0]
    k = jnp.arange(n)
    tail = k >= q
    v = jnp.where(tail, d, 0.0)
    norm2 = jnp.dot(v, v)
    norm = jnp.sqrt(norm2)
    dq = jnp.take(d, q, mode="clip")
    # alpha = -sign(d[q]) * ||v|| so that w = v - alpha e_q is well conditioned
    alpha = jnp.where(dq >= 0, -norm, norm)
    w = v - alpha * (k == q)
    ww = jnp.dot(w, w)
    dependent = norm <= 1e-300  # tail numerically zero
    beta = jnp.where(ww > 0, 2.0 / jnp.where(ww > 0, ww, 1.0), 0.0)
    # J <- J H = J - (J w) beta w^T ; only columns >= q change (w zero elsewhere)
    Jw = J @ w
    J_new = J - beta * jnp.outer(Jw, w)
    # d after reflection: head unchanged, d[q] = alpha, zeros beyond
    d_new = jnp.where(k < q, d, jnp.where(k == q, alpha, 0.0))
    # R gains column q = d_new head (ref :233-235), diagonal entry alpha != 0
    # keeps the identity-padding invariant for masked solves.
    R_new = R.at[:, :].set(jnp.where((k[None, :] == q), d_new[:, None], R))
    return J_new, R_new, dependent


def shift_left(vec: jax.Array, l: jax.Array, q: jax.Array) -> jax.Array:
    """Delete element l from the first q+1 slots: out[i] = vec[i+1] for
    l <= i < q, identity elsewhere. (ref: DualSolver.cpp:237-244 u-shift.)
    """
    n = vec.shape[0]
    i = jnp.arange(n)
    src = jnp.where((i >= l) & (i < q), i + 1, i)
    return jnp.take(vec, jnp.clip(src, 0, n - 1))


def givens_remove(J: jax.Array, R: jax.Array, q_old: jax.Array, l: jax.Array):
    """Remove the active constraint at position l: delete column l of R,
    restore upper-triangularity with a Givens sweep on row pairs, applying
    each rotation to J's columns on the right.

    q_old is the active count *before* removal. Returns (J_new, R_new) with
    R re-identity-padded on columns >= q_old-1.
    (ref: src/GoldfarbIdnaniSolver.cpp:239-256.)
    """
    n = R.shape[0]
    q_new = q_old - 1
    cols = jnp.arange(n)
    # Delete column l: columns [l, q_new) take their right neighbor.
    src = jnp.where((cols >= l) & (cols < q_new), cols + 1, cols)
    R = jnp.take(R, jnp.clip(src, 0, n - 1), axis=1)

    def body(i, JR):
        J, R = JR
        active = (i >= l) & (i < q_new)
        a = R[i, i]
        b = R[i + 1, i]
        rad = jnp.sqrt(a * a + b * b)
        rad_safe = jnp.where(rad > 0, rad, 1.0)
        c = jnp.where(rad > 0, a / rad_safe, 1.0)
        s = jnp.where(rad > 0, b / rad_safe, 0.0)
        c = jnp.where(active, c, 1.0)
        s = jnp.where(active, s, 0.0)
        # Rotate rows i, i+1 of R:  [ri; ri1] <- [[c, s], [-s, c]] @ [ri; ri1]
        ri = R[i]
        ri1 = R[i + 1]
        R = R.at[i].set(c * ri + s * ri1)
        R = R.at[i + 1].set(-s * ri + c * ri1)
        # J <- J G^T : columns i, i+1 mix with the transposed rotation so that
        # J_new R_new = J_old R_old(shifted) stays invariant.
        ji = J[:, i]
        ji1 = J[:, i + 1]
        J = J.at[:, i].set(c * ji + s * ji1)
        J = J.at[:, i + 1].set(-s * ji + c * ji1)
        return J, R

    J, R = jax.lax.fori_loop(0, n - 1, body, (J, R))
    # Re-impose exact zeros below the diagonal and identity padding on
    # inactive columns (>= q_new).
    R = jnp.triu(R)
    eye = jnp.eye(n, dtype=R.dtype)
    R = jnp.where(cols[None, :] >= q_new, eye, R)
    return J, R
