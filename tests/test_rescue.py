"""Failed-lane f64 rescue tests.

The f32 kernel path degrades at high active fractions (the reference's own
[NUMERIC] notes, ref: src/GoldfarbIdnaniSolver.cpp:87,174,236);
``solve_refined_pallas_rescued`` re-solves failed lanes with the f64 J/R
engine. These tests force failures and check the rescue restores a
batch-wide KKT <= 1e-8 / SUCCESS guarantee.
"""
import jax
import jax.numpy as jnp
import numpy as np

from jrlqp_tpu import SolverOptions
from jrlqp_tpu.solver.fast import (
    rescue_failed_lanes,
    solve_refined_pallas,
    solve_refined_pallas_carry,
    solve_refined_pallas_rescued,
)
from jrlqp_tpu.testing.batch_gen import random_qp_batch
from jrlqp_tpu.testing.kkt import kkt_residual


def test_rescue_high_active_fraction():
    """At 90%+ active fraction some f32 lanes fail; the rescued wrapper
    must deliver SUCCESS + KKT <= 1e-8 on every lane."""
    opt = SolverOptions(max_iter=120)
    pbs = random_qp_batch(jax.random.key(2), 24, 12, 24, act_frac=0.95)
    res = solve_refined_pallas_rescued(pbs, opt, interpret=True)
    assert np.all(np.asarray(res.status) == 0), np.asarray(res.status)
    resid = jax.vmap(kkt_residual)(res.x, res.multipliers, pbs)
    assert float(jnp.max(resid)) <= 1e-8, float(jnp.max(resid))


def test_rescue_noop_on_clean_batch():
    """With no failed lanes, the wrapper returns the fast-path result
    unchanged (no f64 work)."""
    opt = SolverOptions(max_iter=100)
    pbs = random_qp_batch(jax.random.key(3), 8, 8, 14, act_frac=0.2)
    res_r = solve_refined_pallas_rescued(pbs, opt, interpret=True)
    res_p = solve_refined_pallas(pbs, opt, interpret=True)
    np.testing.assert_array_equal(np.asarray(res_r.x), np.asarray(res_p.x))
    np.testing.assert_array_equal(np.asarray(res_r.status),
                                  np.asarray(res_p.status))


def test_rescue_fixes_injected_failures():
    """Inject an ill-conditioned lane (near-dependent active normals) that
    the f32 kernel rejects with LINEAR_DEPENDENCY or solves inaccurately;
    the rescue must still produce the f64 answer for it."""
    opt = SolverOptions(max_iter=100)
    pbs = random_qp_batch(jax.random.key(4), 6, 10, 20, act_frac=0.4)
    # make lane 2 nasty: duplicate constraint rows with eps perturbation,
    # both active at the same bound
    C = np.array(pbs.C)
    l = np.array(pbs.l)
    u = np.array(pbs.u)
    C[2, 1] = C[2, 0] * (1 + 1e-7)
    l[2, 1] = l[2, 0]
    u[2, 1] = u[2, 0]
    import dataclasses

    pbs = dataclasses.replace(pbs, C=jnp.asarray(C), l=jnp.asarray(l),
                              u=jnp.asarray(u))
    res = solve_refined_pallas_rescued(pbs, opt, interpret=True)
    resid = jax.vmap(kkt_residual)(res.x, res.multipliers, pbs)
    assert np.all(np.asarray(res.status) == 0)
    assert float(jnp.max(resid)) <= 1e-8


def test_phase2_keeps_init_dependence_scale():
    """The kernel carries the INIT-time trace(H0) through its state: after a
    run truncated by max_iter, the state's hscale equals the initial one,
    not the evolved (shrunken) trace of H -- the dependence threshold of a
    resumed run would otherwise loosen on hard lanes."""
    from jrlqp_tpu.ops.pallas.gi_kernel import run_loop_pallas
    from jrlqp_tpu.solver.fast import _init_fast, _opt32

    opt = SolverOptions(max_iter=100)
    pbs = random_qp_batch(jax.random.key(23), 4, 10, 16, act_frac=0.6)
    pb32 = pbs.with_dtype(jnp.float32)
    opt32 = _opt32(opt)
    state0 = jax.vmap(lambda p: _init_fast(p, opt32))(pb32)
    st1 = run_loop_pallas(pb32, state0, 5, interpret=True)   # truncated run
    np.testing.assert_allclose(np.asarray(st1.hscale),
                               np.asarray(state0.hscale), rtol=1e-6)
    # the evolved operator's trace HAS shrunk (constraints activated)
    tr_evolved = np.trace(np.asarray(st1.H), axis1=-2, axis2=-1)
    assert (tr_evolved < np.asarray(state0.hscale) - 1e-6).any()


def test_rescue_failed_lanes_after_warm_step():
    """The warm trajectory path returns f32-loop lanes as they end; the
    library rescue re-solves every failed lane of a warm step with the f64
    engine and leaves the lanes that passed untouched."""
    import dataclasses

    from jrlqp_tpu import solve_batch

    opt = SolverOptions(max_iter=120)
    pbs = random_qp_batch(jax.random.key(7), 16, 12, 24, act_frac=0.95)
    _, carry = solve_refined_pallas_carry(pbs, None, opt, interpret=True)
    step = dataclasses.replace(pbs, l=pbs.l + 0.05, u=pbs.u + 0.05)
    res, _ = solve_refined_pallas_carry(step, carry, opt, interpret=True)
    resid = np.asarray(jax.vmap(kkt_residual)(res.x, res.multipliers, step))
    good = (resid <= 1e-8) & (np.asarray(res.status) == 0)
    assert not good.all()   # the step leaves lanes for the rescue
    fixed = rescue_failed_lanes(step, res, opt)
    ref = solve_batch(step, opt)
    np.testing.assert_array_equal(np.asarray(fixed.status)[~good],
                                  np.asarray(ref.status)[~good])
    np.testing.assert_allclose(np.asarray(fixed.x)[~good],
                               np.asarray(ref.x)[~good], atol=1e-12)
    np.testing.assert_array_equal(np.asarray(fixed.x)[good],
                                  np.asarray(res.x)[good])
