"""Structured-vs-dense solver differential tests
(ref: tests/BlockGISolverTest.in.cpp:70-170): random block problems solved
by both the dense GI solver and the structured solver must agree to 1e-8."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jrlqp_tpu import QPProblem, SolverOptions, TerminationStatus, solve
from jrlqp_tpu.structured import (
    GType,
    StructuredC,
    StructuredG,
    solve_structured,
    structured_qp_problem,
)
from jrlqp_tpu.testing import check_kkt

jit_solve = jax.jit(solve, static_argnames=("opt",))


def _rand_structured(rng, nb, s, mc, gtype):
    diag = np.zeros((nb, s, s))
    off = rng.standard_normal((nb - 1, s, s))
    for i in range(nb):
        A = rng.standard_normal((s, s))
        diag[i] = A @ A.T + nb * s * np.eye(s)
    sg = StructuredG(diag=jnp.asarray(diag), off=jnp.asarray(off), gtype=int(gtype))
    sc = StructuredC(blocks=jnp.asarray(rng.standard_normal((nb, mc, s))))
    n = nb * s
    m = nb * mc
    a = jnp.asarray(rng.standard_normal(n))
    # bounds around a feasible-ish point so some constraints activate
    x0 = rng.uniform(-1, 1, n)
    cx = np.asarray(sc.to_dense()) @ x0
    l = jnp.asarray(cx - rng.uniform(0.0, 0.5, m))
    u = jnp.asarray(cx + rng.uniform(0.0, 2.0, m))
    return sg, a, sc, l, u


@pytest.mark.parametrize(
    "gtype", [GType.TRI_BLOCK_DIAGONAL, GType.BLOCK_ARROW_DOWN, GType.BLOCK_ARROW_UP]
)
def test_structured_matches_dense(gtype):
    rng = np.random.default_rng(int(gtype) + 1)
    nb, s, mc = 3, 3, 2
    sg, a, sc, l, u = _rand_structured(rng, nb, s, mc, gtype)
    pb = structured_qp_problem(sg, a, sc, l, u)

    res_d = jit_solve(pb, SolverOptions())
    res_s = jax.jit(
        lambda sg, a, sc, l, u: solve_structured(sg, a, sc, l, u, opt=SolverOptions())
    )(sg, a, sc, l, u)

    assert int(res_d.status) == int(TerminationStatus.SUCCESS)
    assert int(res_s.status) == int(TerminationStatus.SUCCESS)
    np.testing.assert_allclose(
        np.asarray(res_s.x), np.asarray(res_d.x), rtol=1e-8, atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(res_s.multipliers), np.asarray(res_d.multipliers),
        rtol=1e-7, atol=1e-8,
    )
    assert bool(check_kkt(res_s.x, res_s.multipliers, pb))


def test_structured_with_equalities_and_bounds():
    rng = np.random.default_rng(42)
    nb, s, mc = 3, 2, 2
    sg, a, sc, l, u = _rand_structured(rng, nb, s, mc, GType.TRI_BLOCK_DIAGONAL)
    n = nb * s
    # make the first constraint an equality and add box bounds
    l = l.at[0].set(u[0])
    xl = jnp.full((n,), -2.0)
    xu = jnp.full((n,), 2.0)
    pb = structured_qp_problem(sg, a, sc, l, u, xl, xu)

    res_d = jit_solve(pb, SolverOptions())
    res_s = jax.jit(
        lambda sg, a, sc, l, u, xl, xu: solve_structured(
            sg, a, sc, l, u, xl, xu, opt=SolverOptions()
        )
    )(sg, a, sc, l, u, xl, xu)
    assert int(res_d.status) == int(TerminationStatus.SUCCESS)
    assert int(res_s.status) == int(TerminationStatus.SUCCESS)
    np.testing.assert_allclose(
        np.asarray(res_s.x), np.asarray(res_d.x), rtol=1e-8, atol=1e-8
    )


def test_structured_batched_vmap():
    """Scenario batches of structured problems vmap (BASELINE config 5)."""
    rng = np.random.default_rng(7)
    nb, s, mc = 3, 2, 1
    sgs, als, scs, ls, us = [], [], [], [], []
    for _ in range(4):
        sg, a, sc, l, u = _rand_structured(rng, nb, s, mc, GType.TRI_BLOCK_DIAGONAL)
        sgs.append(sg)
        als.append(a)
        scs.append(sc)
        ls.append(l)
        us.append(u)
    sg_b = jax.tree.map(lambda *x: jnp.stack(x), *sgs)
    sc_b = jax.tree.map(lambda *x: jnp.stack(x), *scs)
    a_b = jnp.stack(als)
    l_b = jnp.stack(ls)
    u_b = jnp.stack(us)
    res = jax.jit(
        jax.vmap(
            lambda sg, a, sc, l, u: solve_structured(sg, a, sc, l, u,
                                                     opt=SolverOptions())
        )
    )(sg_b, a_b, sc_b, l_b, u_b)
    assert np.all(np.asarray(res.status) == int(TerminationStatus.SUCCESS))
    for k in range(4):
        ref = jit_solve(
            structured_qp_problem(sgs[k], als[k], scs[k], ls[k], us[k]),
            SolverOptions(),
        )
        np.testing.assert_allclose(
            np.asarray(res.x[k]), np.asarray(ref.x), rtol=1e-8, atol=1e-8
        )


def test_structured_fast_matches_structured():
    """Fast (f32 + IR) structured engine vs the f64 J/R structured solver."""
    import numpy as np

    from jrlqp_tpu.structured.solver import (
        solve_structured,
        solve_structured_fast,
    )

    rng = np.random.default_rng(11)
    sg, a, sc, l, u = _rand_structured(rng, nb=4, s=6, mc=3,
                                       gtype=GType.TRI_BLOCK_DIAGONAL)
    r64 = solve_structured(sg, a, sc, l, u)
    rf = solve_structured_fast(sg, a, sc, l, u)
    assert int(rf.status) == int(r64.status) == 0
    np.testing.assert_allclose(np.asarray(rf.x), np.asarray(r64.x),
                               atol=1e-7)


@pytest.mark.parametrize(
    "gtype",
    [GType.TRI_BLOCK_DIAGONAL, GType.BLOCK_ARROW_DOWN, GType.BLOCK_ARROW_UP],
)
def test_structured_fast_pallas_backend(gtype):
    """The blocked-LLT init of the structured fast solve must reproduce the
    f64 structured solver for every G type (ref parallelization targets:
    src/decomposition/blockArrowLLT.cpp:118-120,217)."""
    from jrlqp_tpu.structured.solver import (
        solve_structured,
        solve_structured_fast,
    )

    rng = np.random.default_rng(13 + int(gtype))
    sg, a, sc, l, u = _rand_structured(rng, nb=4, s=6, mc=3, gtype=gtype)
    r64 = solve_structured(sg, a, sc, l, u)
    rp = solve_structured_fast(sg, a, sc, l, u)
    assert int(rp.status) == int(r64.status) == 0
    np.testing.assert_allclose(np.asarray(rp.x), np.asarray(r64.x),
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(rp.f), np.asarray(r64.f),
                               rtol=1e-7, atol=1e-7)


def test_structured_fast_pallas_vmap():
    """Batched (vmapped) structured fast solves through the blocked init."""
    from jrlqp_tpu.structured.solver import (
        solve_structured,
        solve_structured_fast,
    )

    rng = np.random.default_rng(21)
    probs = [_rand_structured(rng, nb=3, s=4, mc=2,
                              gtype=GType.TRI_BLOCK_DIAGONAL)
             for _ in range(4)]
    sgs = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in probs])
    a_b = jnp.stack([p[1] for p in probs])
    scs = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[2] for p in probs])
    l_b = jnp.stack([p[3] for p in probs])
    u_b = jnp.stack([p[4] for p in probs])

    res = jax.vmap(
        lambda sg, a, sc, l, u: solve_structured_fast(sg, a, sc, l, u)
    )(sgs, a_b, scs, l_b, u_b)
    for k, (sg, a, sc, l, u) in enumerate(probs):
        ref = solve_structured(sg, a, sc, l, u)
        assert int(res.status[k]) == int(ref.status) == 0
        np.testing.assert_allclose(np.asarray(res.x[k]), np.asarray(ref.x),
                                   atol=1e-7)


def test_structured_fast_pallas_non_spd_flagged():
    """A non-SPD structured G must terminate NON_POS_HESSIAN through the
    blocked init (a failed block Cholesky leaves a non-finite factor)."""
    from jrlqp_tpu.structured.solver import solve_structured_fast

    rng = np.random.default_rng(3)
    nb, s, mc = 3, 4, 2
    diag = np.zeros((nb, s, s))
    for i in range(nb):
        A = rng.standard_normal((s, s))
        diag[i] = A @ A.T + nb * s * np.eye(s)
    diag[1] -= 3 * nb * s * np.eye(s)          # make block 1 indefinite
    off = rng.standard_normal((nb - 1, s, s))
    sg = StructuredG(diag=jnp.asarray(diag), off=jnp.asarray(off),
                     gtype=int(GType.TRI_BLOCK_DIAGONAL))
    sc = StructuredC(blocks=jnp.asarray(rng.standard_normal((nb, mc, s))))
    n, m = nb * s, nb * mc
    res = solve_structured_fast(
        sg, jnp.zeros(n), sc, jnp.full(m, -1.0), jnp.full(m, 1.0))
    assert int(res.status) == int(TerminationStatus.NON_POS_HESSIAN)


@pytest.mark.parametrize("gtype", [GType.TRI_BLOCK_DIAGONAL,
                                   GType.BLOCK_ARROW_DOWN])
def test_structured_fast_batch_matches_vmapped(gtype):
    """solve_structured_fast_batch == vmap(solve_structured_fast): the
    batched blocked init must reproduce the per-problem path, and agree
    with the f64 structured oracle."""
    from jrlqp_tpu.structured.solver import (
        solve_structured_fast,
        solve_structured_fast_batch,
    )

    rng = np.random.default_rng(int(gtype) + 11)
    nb, s, mc, B = 3, 8, 2, 5
    probs = [_rand_structured(rng, nb, s, mc, gtype) for _ in range(B)]
    sgs = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in probs])
    a_b = jnp.stack([p[1] for p in probs])
    scs = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[2] for p in probs])
    l_b = jnp.stack([p[3] for p in probs])
    u_b = jnp.stack([p[4] for p in probs])

    res_b = solve_structured_fast_batch(sgs, a_b, scs, l_b, u_b)
    res_1 = jax.vmap(
        lambda sg, a, sc, l, u: solve_structured_fast(sg, a, sc, l, u)
    )(sgs, a_b, scs, l_b, u_b)
    assert np.array_equal(np.asarray(res_b.status), np.asarray(res_1.status))
    np.testing.assert_allclose(np.asarray(res_b.x), np.asarray(res_1.x),
                               atol=1e-7)
    for k, (sg, a, sc, l, u) in enumerate(probs):
        ref = solve_structured(sg, a, sc, l, u)
        assert int(res_b.status[k]) == int(ref.status) == 0
        np.testing.assert_allclose(np.asarray(res_b.x[k]),
                                   np.asarray(ref.x), atol=1e-7)


def test_structured_fast_carry_trajectory():
    """Structured control-loop warm start: a drifting-bounds trajectory
    through solve_structured_fast_carry must converge in ~0 iterations on
    warm steps and match the cold batch entry's solutions. The reference's
    structured warm start is unfinished (BlockGISolver asserts 0 initial
    actives, src/experimental/BlockGISolver.cpp:474-481); the carry form
    goes beyond it with zero refactorization work."""
    from jrlqp_tpu.structured.solver import (
        solve_structured_fast_batch,
        solve_structured_fast_carry,
    )

    rng = np.random.default_rng(42)
    nb, s, mc, B = 3, 8, 2, 4
    probs = [_rand_structured(rng, nb, s, mc, GType.TRI_BLOCK_DIAGONAL)
             for _ in range(B)]
    sgs = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in probs])
    a_b = jnp.stack([p[1] for p in probs])
    scs = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[2] for p in probs])
    l_b = jnp.stack([p[3] for p in probs])
    u_b = jnp.stack([p[4] for p in probs])
    m = nb * mc

    carry = None
    for step in range(3):
        d = jnp.asarray(0.02 * rng.standard_normal((B, m)))
        ls, us = l_b + d, u_b + d
        res, carry = solve_structured_fast_carry(
            sgs, a_b, scs, ls, us, carry)
        assert np.all(np.asarray(res.status) == 0), res.status
        ref = solve_structured_fast_batch(sgs, a_b, scs, ls, us)
        np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                                   atol=1e-7)
        if step > 0:
            assert float(np.mean(np.asarray(res.iterations))) <= 3.0


@pytest.mark.parametrize("gtype", [GType.TRI_BLOCK_DIAGONAL,
                                   GType.BLOCK_ARROW_DOWN,
                                   GType.BLOCK_ARROW_UP])
def test_structured_inverse_batch_matches_dense(gtype):
    """The batched XLA blocked factorization (the structured init) gives
    G^-1 of the dense assembly for every G type at batch > 1."""
    from jrlqp_tpu.structured.solver import structured_inverse_batch

    rng = np.random.default_rng(7 + int(gtype))
    nb, s, B = 4, 5, 3
    probs = [_rand_structured(rng, nb, s, 2, gtype)[0] for _ in range(B)]
    diag = jnp.stack([p.diag for p in probs])
    off = jnp.stack([p.off for p in probs])
    H, posdef = structured_inverse_batch(diag, off, int(gtype))
    assert np.asarray(posdef).all()
    for k, p in enumerate(probs):
        np.testing.assert_allclose(np.asarray(H[k]),
                                   np.linalg.inv(np.asarray(p.to_dense())),
                                   atol=1e-10)


def test_structured_inverse_batch_flags_non_spd():
    """An indefinite lane is flagged (posdef False, identity operator)
    without touching its batch neighbours."""
    from jrlqp_tpu.structured.solver import structured_inverse_batch

    rng = np.random.default_rng(5)
    nb, s, B = 3, 4, 2
    probs = [_rand_structured(rng, nb, s, 2, GType.TRI_BLOCK_DIAGONAL)[0]
             for _ in range(B)]
    diag = jnp.stack([p.diag for p in probs])
    diag = diag.at[1, 1].add(-10.0 * nb * s * jnp.eye(s))
    off = jnp.stack([p.off for p in probs])
    H, posdef = structured_inverse_batch(diag, off,
                                         int(GType.TRI_BLOCK_DIAGONAL))
    assert np.asarray(posdef).tolist() == [True, False]
    np.testing.assert_array_equal(np.asarray(H[1]), np.eye(nb * s))
