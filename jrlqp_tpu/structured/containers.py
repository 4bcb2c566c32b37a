"""Structured matrix containers: StructuredG and StructuredC analogs.

Fixed-shape re-design of the reference containers
(ref: include/jrl-qp/structured/StructuredG.h:14-76,
include/jrl-qp/structured/StructuredC.h:15-54). Uniform padded block sizes
replace the reference's ragged ``std::vector<MatrixRef>`` views so
everything is a fixed-shape pytree; the factorization is functional
(returns factors) instead of in-place on user memory.
"""
from __future__ import annotations

import dataclasses
import enum

import jax
import jax.numpy as jnp

from .blocks import (
    block_arrow_l_solve,
    block_arrow_llt,
    block_arrow_lt_solve,
    block_arrow_to_dense,
    tri_block_diag_llt,
    tri_block_l_solve,
    tri_block_lt_solve,
    tri_block_to_dense,
)

__all__ = ["GType", "StructuredG", "StructuredGFactor", "StructuredC"]


class GType(enum.IntEnum):
    """(ref: StructuredG.h:17-22)."""

    TRI_BLOCK_DIAGONAL = 0
    BLOCK_ARROW_UP = 1
    BLOCK_ARROW_DOWN = 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StructuredG:
    """SPD matrix stored as (nb, s, s) diagonal blocks + (nb-1, s, s)
    off-diagonal blocks, interpreted per ``gtype``:

    - TRI_BLOCK_DIAGONAL: off[i] at block (i+1, i)
    - BLOCK_ARROW_DOWN:   off[i] at block (nb-1, i)
    - BLOCK_ARROW_UP:     off[i] at block (0, i+1)
    """

    diag: jax.Array  # (nb, s, s)
    off: jax.Array  # (nb-1, s, s)
    gtype: int = dataclasses.field(metadata=dict(static=True))

    def __post_init__(self):
        # a bare string like "tri_block_diagonal" would silently compare
        # unequal to every GType and fall through to the block-arrow
        # branches -- reject anything that isn't a valid GType value
        try:
            GType(self.gtype)
        except ValueError:
            raise ValueError(
                f"gtype must be a GType value (e.g. "
                f"GType.TRI_BLOCK_DIAGONAL), got {self.gtype!r}") from None

    @property
    def nb(self) -> int:
        return self.diag.shape[-3]

    @property
    def s(self) -> int:
        return self.diag.shape[-1]

    @property
    def n(self) -> int:
        return self.nb * self.s

    def llt(self) -> "StructuredGFactor":
        """(ref: StructuredG::lltInPlace, StructuredG.cpp:22-43)."""
        if self.gtype == GType.TRI_BLOCK_DIAGONAL:
            Ld, Lo = tri_block_diag_llt(self.diag, self.off)
        else:
            Ld, Lo = block_arrow_llt(
                self.diag, self.off, up=self.gtype == GType.BLOCK_ARROW_UP
            )
        return StructuredGFactor(diag=Ld, off=Lo, gtype=self.gtype)

    def to_dense(self) -> jax.Array:
        if self.gtype == GType.TRI_BLOCK_DIAGONAL:
            return tri_block_to_dense(self.diag, self.off)
        return block_arrow_to_dense(
            self.diag, self.off, up=self.gtype == GType.BLOCK_ARROW_UP
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StructuredGFactor:
    """Cholesky factor of a StructuredG, same block layout."""

    diag: jax.Array
    off: jax.Array
    gtype: int = dataclasses.field(metadata=dict(static=True))

    @property
    def nb(self) -> int:
        return self.diag.shape[-3]

    @property
    def s(self) -> int:
        return self.diag.shape[-1]

    @property
    def n(self) -> int:
        return self.nb * self.s

    def _blocked(self, v):
        """(n,) or (n, k) -> (nb, s) or (nb, s, k)."""
        if v.ndim == 1:
            return v.reshape(self.nb, self.s)
        return v.reshape(self.nb, self.s, v.shape[-1])

    def l_solve(self, r: jax.Array) -> jax.Array:
        """L^{-1} r for flat r of shape (n,) or (n, k)
        (ref: StructuredG::solveL, StructuredG.cpp:45-79)."""
        rb = self._blocked(r)
        if self.gtype == GType.TRI_BLOCK_DIAGONAL:
            y = tri_block_l_solve(self.diag, self.off, rb)
        else:
            y = block_arrow_l_solve(
                self.diag, self.off, rb, up=self.gtype == GType.BLOCK_ARROW_UP
            )
        return y.reshape(r.shape)

    def lt_solve(self, r: jax.Array) -> jax.Array:
        """L^{-T} r (ref: StructuredG::solveInPlaceLTranspose,
        StructuredG.cpp:81-113)."""
        rb = self._blocked(r)
        if self.gtype == GType.TRI_BLOCK_DIAGONAL:
            y = tri_block_lt_solve(self.diag, self.off, rb)
        else:
            y = block_arrow_lt_solve(
                self.diag, self.off, rb, up=self.gtype == GType.BLOCK_ARROW_UP
            )
        return y.reshape(r.shape)

    def solve(self, r: jax.Array) -> jax.Array:
        """G^{-1} r."""
        return self.lt_solve(self.l_solve(r))

    def inverse_transpose(self) -> jax.Array:
        """Dense J0 = L^{-T} as an (n, n) array, computed blockwise in
        O(n^2 s) (vs O(n^3) for a dense factorization). Feeds the dense-J GI
        loop (see structured.solver design note)."""
        n = self.n
        eye = jnp.eye(n, dtype=self.diag.dtype)
        return self.lt_solve(eye)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StructuredC:
    """Block-diagonal constraint matrix (ref: StructuredC.h Type::Diagonal):
    block i contributes ``mc`` constraints on the i-th variable block, so
    C is (nb*mc, nb*s) with blocks (mc, s) on the block diagonal."""

    blocks: jax.Array  # (nb, mc, s)

    @property
    def nb(self) -> int:
        return self.blocks.shape[-3]

    @property
    def mc(self) -> int:
        return self.blocks.shape[-2]

    @property
    def s(self) -> int:
        return self.blocks.shape[-1]

    @property
    def m(self) -> int:
        return self.nb * self.mc

    def transpose_mult(self, x: jax.Array) -> jax.Array:
        """C x blockwise (ref: StructuredC::transposeMult,
        StructuredC.cpp:66-77 -- note the reference's C is stored transposed,
        hence the name; ours is row-major so this *is* C @ x)."""
        xb = x.reshape(self.nb, self.s, 1)
        return (self.blocks @ xb).reshape(self.m)

    def to_dense(self) -> jax.Array:
        nb, mc, s = self.blocks.shape
        C = jnp.zeros((nb * mc, nb * s), self.blocks.dtype)
        for i in range(nb):
            C = C.at[i * mc:(i + 1) * mc, i * s:(i + 1) * s].set(self.blocks[i])
        return C
