"""Structured SPD factorizations: block-tridiagonal and block-arrow LLT.

Fixed-shape re-design of the reference decomposition kernels
(ref: include/jrl-qp/decomposition/triBlockDiagLLT.h:14-72,
src/decomposition/triBlockDiagLLT.cpp:9-159 and
include/jrl-qp/decomposition/blockArrowLLT.h:14-110,
src/decomposition/blockArrowLLT.cpp:52-279). Differences from the
reference's in-place Eigen code:

- Blocks have a *uniform* padded size so everything is fixed-shape and
  batches with vmap (the reference supports ragged block sizes; pad to the
  max and put an identity diagonal in the padding).
- The block-tridiagonal chain is a static Python unroll over nb (the
  recurrence L_i = chol(D_i - S'_{i-1} S'_{i-1}^T) is inherently
  sequential; nb is a trace-time constant, and the unroll fuses better
  under XLA than a ``scan``).
- The block-arrow factorization's per-block work (chol(D_i), B_i = S_i
  L_i^{-T}) is *vmapped across blocks* -- this is exactly the parallelism
  the reference marks with [OPTIM] comments (blockArrowLLT.cpp:118-120,217).
- Arrow-up matrices are handled by the same implicit roll-permutation trick
  as the reference (blockArrowLLT.h:34-48): rolling block 0 to the end turns
  an up arrow into a down arrow; solves roll the rhs accordingly.

Shapes (nb = number of blocks, s = block size, n = nb * s):
- tri-block-diagonal: diag (nb, s, s); sub-diagonal (nb-1, s, s) with
  S[i] the block at row i+1, col i.
- block-arrow(down): diag (nb, s, s); side (nb-1, s, s) with side[i] the
  block at the last block-row, col i.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "tri_block_diag_llt",
    "tri_block_l_solve",
    "tri_block_lt_solve",
    "block_arrow_llt",
    "block_arrow_l_solve",
    "block_arrow_lt_solve",
    "tri_block_to_dense",
    "block_arrow_to_dense",
]


def _chol(D):
    return jnp.linalg.cholesky(D)


def _solve_lower(L, B, transpose=False):
    """X = L^{-1} B (or L^{-T} B)."""
    return jax.lax.linalg.triangular_solve(
        L, B, left_side=True, lower=True, transpose_a=transpose
    )


def tri_block_diag_llt(diag: jax.Array, sub: jax.Array):
    """LLT of a block-tridiagonal SPD matrix
    (ref: src/decomposition/triBlockDiagLLT.cpp:9-35).

    Returns (L_diag (nb, s, s) lower-triangular blocks,
    L_sub (nb-1, s, s) = S_i L_i^{-T}). The factor is
    L = [[L_0], [L_sub_0, L_1], ...].

    The chain over blocks is a static Python unroll (nb is a trace-time
    constant): XLA fuses the unrolled chain better than a ``scan``.
    """
    nb, s, _ = diag.shape
    M = jnp.zeros((s, s), diag.dtype)
    Ls, Sps = [], []
    for i in range(nb):
        L = _chol(diag[i] - M)
        Ls.append(L)
        if i < nb - 1:
            # S' = S L^{-T}  <=>  S'^T = L^{-1} S^T
            Sp = _solve_lower(L, sub[i].T).T
            Sps.append(Sp)
            M = Sp @ Sp.T
    return jnp.stack(Ls), (jnp.stack(Sps) if Sps
                           else jnp.zeros((0, s, s), diag.dtype))


def tri_block_l_solve(L_diag, L_sub, r):
    """y = L^{-1} r, blockwise forward substitution, statically unrolled
    (ref: triBlockDiagLLT.cpp:37-95). r has shape (nb, s) or (nb, s, k)."""
    nb, s, _ = L_diag.shape
    vec = r.ndim == 2
    if vec:
        r = r[..., None]
    ys = []
    for i in range(nb):
        rhs = r[i] if i == 0 else r[i] - L_sub[i - 1] @ ys[-1]
        ys.append(_solve_lower(L_diag[i], rhs))
    y = jnp.stack(ys)
    return y[..., 0] if vec else y


def tri_block_lt_solve(L_diag, L_sub, r):
    """y = L^{-T} r, blockwise backward substitution, statically unrolled
    (ref: triBlockDiagLLT.cpp:97-158)."""
    nb, s, _ = L_diag.shape
    vec = r.ndim == 2
    if vec:
        r = r[..., None]
    ys = [None] * nb
    for i in range(nb - 1, -1, -1):
        rhs = r[i] if i == nb - 1 else r[i] - L_sub[i].T @ ys[i + 1]
        ys[i] = _solve_lower(L_diag[i], rhs, transpose=True)
    y = jnp.stack(ys)
    return y[..., 0] if vec else y


def block_arrow_llt(diag: jax.Array, side: jax.Array, up: bool = False):
    """LLT of a block-arrow SPD matrix
    (ref: src/decomposition/blockArrowLLT.cpp:52-81).

    Down arrow: M = [[D_0, .., B_0^T], .., [B_0, .., D_last]] with the
    coupling blocks in the last block row. ``up=True`` means the coupling is
    in the *first* block row/col; it is reduced to the down case by the
    implicit permutation that rolls block 0 to the end
    (ref: blockArrowLLT.h:34-48) -- callers must roll solve rhs the same way,
    which the solve functions below do.

    Returns (L_diag (nb, s, s), L_side (nb-1, s, s)) where the independent
    per-block work chol(D_i), B_i = S_i L_i^{-T} is vmapped across blocks
    (the parallelism the reference marks [OPTIM]).
    """
    if up:
        # roll block 0 (the coupled one) to the end: new_diag[j] = diag[j+1],
        # new_diag[nb-1] = diag[0]; the up-arrow's first-block-row blocks
        # side[i] = M[block 0, block i+1] become exactly the rolled matrix's
        # last-block-row blocks M'[nb-1, i] -- no transpose needed.
        diag = jnp.roll(diag, -1, axis=0)
    Ls = jax.vmap(_chol)(diag[:-1])
    # B_i = S_i L_i^{-T}  <=>  B_i^T = L_i^{-1} S_i^T
    Bs = jnp.swapaxes(jax.vmap(lambda L, S: _solve_lower(L, S))(
        Ls, jnp.swapaxes(side, -1, -2)
    ), -1, -2)
    D_last = diag[-1] - jnp.sum(Bs @ jnp.swapaxes(Bs, -1, -2), axis=0)
    L_last = _chol(D_last)
    return jnp.concatenate([Ls, L_last[None]], axis=0), Bs


def block_arrow_l_solve(L_diag, L_side, r, up: bool = False):
    """y = L^{-1} P r for the (possibly rolled) arrow factor
    (ref: blockArrowLLT.cpp:92-176). r shape (nb, s) or (nb, s, k)."""
    vec = r.ndim == 2
    if vec:
        r = r[..., None]
    if up:
        r = jnp.roll(r, -1, axis=0)
    # independent blocks first (vmapped), last block gathers the updates
    y_head = jax.vmap(lambda L, ri: _solve_lower(L, ri))(L_diag[:-1], r[:-1])
    acc = jnp.sum(L_side @ y_head, axis=0)
    y_last = _solve_lower(L_diag[-1], r[-1] - acc)
    y = jnp.concatenate([y_head, y_last[None]], axis=0)
    return y[..., 0] if vec else y


def block_arrow_lt_solve(L_diag, L_side, r, up: bool = False):
    """y = P^T L^{-T} r (ref: blockArrowLLT.cpp:178-277)."""
    vec = r.ndim == 2
    if vec:
        r = r[..., None]
    y_last = _solve_lower(L_diag[-1], r[-1], transpose=True)
    y_head = jax.vmap(
        lambda L, B, ri: _solve_lower(L, ri - jnp.swapaxes(B, -1, -2) @ y_last,
                                      transpose=True)
    )(L_diag[:-1], L_side, r[:-1])
    y = jnp.concatenate([y_head, y_last[None]], axis=0)
    if up:
        y = jnp.roll(y, 1, axis=0)
    return y[..., 0] if vec else y


def tri_block_to_dense(diag, sub):
    """Assemble the dense SPD matrix (test oracle)."""
    nb, s, _ = diag.shape
    n = nb * s
    M = jnp.zeros((n, n), diag.dtype)
    for i in range(nb):
        M = M.at[i * s:(i + 1) * s, i * s:(i + 1) * s].set(diag[i])
    for i in range(nb - 1):
        M = M.at[(i + 1) * s:(i + 2) * s, i * s:(i + 1) * s].set(sub[i])
        M = M.at[i * s:(i + 1) * s, (i + 1) * s:(i + 2) * s].set(sub[i].T)
    return M


def block_arrow_to_dense(diag, side, up: bool = False):
    """Assemble the dense SPD matrix (test oracle). Down: coupling in the
    last block row; up: coupling in the first block row."""
    nb, s, _ = diag.shape
    n = nb * s
    M = jnp.zeros((n, n), diag.dtype)
    for i in range(nb):
        M = M.at[i * s:(i + 1) * s, i * s:(i + 1) * s].set(diag[i])
    for i in range(nb - 1):
        if up:
            # side[i] couples block 0 (rows) with block i+1 (cols)
            M = M.at[0:s, (i + 1) * s:(i + 2) * s].set(side[i])
            M = M.at[(i + 1) * s:(i + 2) * s, 0:s].set(side[i].T)
        else:
            M = M.at[(nb - 1) * s:, i * s:(i + 1) * s].set(side[i])
            M = M.at[i * s:(i + 1) * s, (nb - 1) * s:].set(side[i].T)
    return M
