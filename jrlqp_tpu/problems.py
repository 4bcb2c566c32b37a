"""Problem containers as JAX pytrees.

JAX analog of the reference problem structs
(ref: include/jrl-qp/test/problems.h:16-146). Everything is a registered
pytree of fixed-shape arrays so problems batch with ``vmap`` and shard with
``pjit``. Convention differences vs the reference C++ API:

- ``C`` has shape ``(m, n)`` with one constraint per ROW (the reference's
  ``solve`` takes the transposed ``n x m`` layout; its own test structs use
  rows, problems.h `transposedMat`). Row-major constraints keep the
  selection pass ``C @ x`` a single gemv.
- Bounds are always present; "no bound" is encoded as +/-inf. Padded
  constraints use l=-inf, u=+inf and a zero row so they can never be
  selected; padded variables use an identity diagonal in G and infinite
  bounds so they stay at 0 with zero multipliers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["QPProblem", "LeastSquareProblem", "pad_problem", "stack_problems"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QPProblem:
    """min 0.5 x^T G x + a^T x  s.t.  l <= C x <= u, xl <= x <= xu.

    (ref: include/jrl-qp/GoldfarbIdnaniSolver.h:22-33 for the problem
    definition; include/jrl-qp/test/problems.h:118-146 for the struct.)
    """

    G: jax.Array  # (n, n) symmetric positive definite
    a: jax.Array  # (n,)
    C: jax.Array  # (m, n) one constraint per row
    l: jax.Array  # (m,)
    u: jax.Array  # (m,)
    xl: jax.Array  # (n,)  -inf where unbounded
    xu: jax.Array  # (n,)  +inf where unbounded
    objcst: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros(())
    )  # constant term of the objective (ref: problems.h QPProblem::objCst)

    @property
    def n(self) -> int:
        return self.G.shape[-1]

    @property
    def m(self) -> int:
        return self.C.shape[-2]

    def with_dtype(self, dtype) -> "QPProblem":
        return QPProblem(
            G=self.G.astype(dtype),
            a=self.a.astype(dtype),
            C=self.C.astype(dtype),
            l=self.l.astype(dtype),
            u=self.u.astype(dtype),
            xl=self.xl.astype(dtype),
            xu=self.xu.astype(dtype),
            objcst=self.objcst.astype(dtype),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LeastSquareProblem:
    """min 0.5 |A x - b|^2  s.t.  E x = f, l <= C x <= u, xl <= x <= xu.

    (ref: include/jrl-qp/test/problems.h LeastSquareProblem<Separated>.)
    """

    A: jax.Array  # (nobj, n)
    b: jax.Array  # (nobj,)
    E: jax.Array  # (neq, n)
    f: jax.Array  # (neq,)
    C: jax.Array  # (m, n)
    l: jax.Array  # (m,)
    u: jax.Array  # (m,)
    xl: jax.Array  # (n,)
    xu: jax.Array  # (n,)

    def to_qp(self) -> QPProblem:
        """G = A^T A, a = -A^T b; equalities folded into C with l == u.

        (ref: problems.h:110-115 LS->QP conversion; equalities are appended
        as rows with equal bounds, which the solver auto-activates.)
        """
        G = self.A.T @ self.A
        a = -self.A.T @ self.b
        C = jnp.concatenate([self.E, self.C], axis=0)
        l = jnp.concatenate([self.f, self.l])
        u = jnp.concatenate([self.f, self.u])
        objcst = 0.5 * jnp.dot(self.b, self.b)
        return QPProblem(G=G, a=a, C=C, l=l, u=u, xl=self.xl, xu=self.xu, objcst=objcst)


def pad_problem(pb: QPProblem, n_pad: int, m_pad: int) -> QPProblem:
    """Pad a problem to fixed shapes (n_pad, m_pad) without changing its
    solution: padded variables get G-diagonal 1, a=0, infinite bounds;
    padded constraints get a zero row and infinite bounds.
    """
    n, m = pb.n, pb.m
    assert n_pad >= n and m_pad >= m, (n, n_pad, m, m_pad)
    dn, dm = n_pad - n, m_pad - m
    if dn == 0 and dm == 0:
        return pb
    dt = pb.G.dtype
    inf = jnp.asarray(np.inf, dt)
    G = jnp.zeros((n_pad, n_pad), dt).at[:n, :n].set(pb.G)
    G = G.at[jnp.arange(n, n_pad), jnp.arange(n, n_pad)].set(1.0)
    a = jnp.zeros((n_pad,), dt).at[:n].set(pb.a)
    C = jnp.zeros((m_pad, n_pad), dt).at[:m, :n].set(pb.C)
    l = jnp.full((m_pad,), -inf, dt).at[:m].set(pb.l)
    u = jnp.full((m_pad,), inf, dt).at[:m].set(pb.u)
    xl = jnp.full((n_pad,), -inf, dt).at[:n].set(pb.xl)
    xu = jnp.full((n_pad,), inf, dt).at[:n].set(pb.xu)
    return QPProblem(G=G, a=a, C=C, l=l, u=u, xl=xl, xu=xu, objcst=pb.objcst)


def stack_problems(pbs: list[QPProblem], n_pad: Optional[int] = None,
                   m_pad: Optional[int] = None) -> QPProblem:
    """Pad a list of problems to a common shape and stack into a batch."""
    n_pad = n_pad or max(p.n for p in pbs)
    m_pad = m_pad or max(p.m for p in pbs)
    padded = [pad_problem(p, n_pad, m_pad) for p in pbs]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *padded)
