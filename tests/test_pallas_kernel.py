"""Differential tests: the Triton GI loop kernel vs the XLA fast path.

Runs the kernel in interpret mode (CPU) on batches that exercise adds,
removals, equalities, fixed variables, and bounds, and checks the final
state matches ``vmap(solve_refined)`` (same math, different engine).
Mirrors the reference's structured-vs-dense differential strategy
(ref: tests/BlockGISolverTest.in.cpp:70-170). Also covers the wrapper's
padding and the engine choice by platform and shape.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jrlqp_tpu import SolverOptions
from jrlqp_tpu.ops.pallas import gi_kernel
from jrlqp_tpu.solver import fast
from jrlqp_tpu.solver.fast import solve_refined, solve_refined_pallas
from jrlqp_tpu.testing.batch_gen import random_qp_batch
from jrlqp_tpu.testing.kkt import kkt_residual
from jrlqp_tpu.types import RUNNING, TerminationStatus


def _xla(pbs, opt):
    return jax.vmap(lambda p: solve_refined(p, opt))(pbs)


def _assert_same(res_p, res_x, x_atol=1e-7):
    np.testing.assert_array_equal(np.asarray(res_p.status),
                                  np.asarray(res_x.status))
    np.testing.assert_array_equal(np.asarray(res_p.iterations),
                                  np.asarray(res_x.iterations))
    # both engines refine to <=1e-8 KKT; accumulation order differs
    np.testing.assert_allclose(np.asarray(res_p.x), np.asarray(res_x.x),
                               atol=x_atol)


@pytest.mark.parametrize("num_warps", [4, 8])
@pytest.mark.parametrize("n,m,batch", [(8, 12, 6), (13, 7, 4), (50, 100, 3)])
def test_pallas_matches_xla(n, m, batch, num_warps):
    # (8, 12) and (13, 7) pad to 16x16 / 16x8 blocks (n+1 and m rounded up
    # to powers of two); (50, 100) is the headline width, 64x128
    opt = SolverOptions(max_iter=150)
    opt32 = fast._opt32(opt)
    pbs = random_qp_batch(jax.random.key(0), batch, n, m, act_frac=0.4)
    pb32 = pbs.with_dtype(jnp.float32)
    st0 = jax.vmap(lambda p: fast._init_fast(p, opt32))(pb32)
    st = gi_kernel.run_loop_pallas(pb32, st0, opt.max_iter, interpret=True,
                                   num_warps=num_warps)
    res_p = fast._refine_batch(pbs, st, 3)   # = solve_refined_pallas
    res_x = _xla(pbs, opt)
    _assert_same(res_p, res_x)
    np.testing.assert_allclose(np.asarray(res_p.multipliers),
                               np.asarray(res_x.multipliers), atol=1e-6)


def test_pallas_with_equalities_and_fixed():
    # equalities (l == u) and fixed variables (xl == xu) exercise the
    # pre-activated initial state handed to the kernel
    opt = SolverOptions(max_iter=60)
    pbs = random_qp_batch(jax.random.key(3), 4, 9, 6, act_frac=0.3)
    l = pbs.l.at[:, 0].set(pbs.u[:, 0])          # constraint 0 equality
    xl = pbs.xl.at[:, 2].set(0.37)
    xu = pbs.xu.at[:, 2].set(0.37)               # variable 2 fixed
    pbs = dataclasses.replace(pbs, l=l, xl=xl, xu=xu)
    res_p = solve_refined_pallas(pbs, opt, interpret=True)
    res_x = _xla(pbs, opt)
    np.testing.assert_array_equal(np.asarray(res_p.status),
                                  np.asarray(res_x.status))
    np.testing.assert_allclose(np.asarray(res_p.x), np.asarray(res_x.x),
                               atol=1e-7)
    # fixed variable honored
    np.testing.assert_allclose(np.asarray(res_p.x[:, 2]), 0.37, atol=1e-6)


def test_pallas_kkt_quality():
    opt = SolverOptions(max_iter=80)
    pbs = random_qp_batch(jax.random.key(7), 8, 10, 16, act_frac=0.4)
    res = solve_refined_pallas(pbs, opt, interpret=True)
    resid = jax.vmap(kkt_residual)(res.x, res.multipliers, pbs)
    ok = np.asarray((resid <= 1e-8) & (res.status == 0))
    assert ok.all(), np.asarray(resid)


def test_fused_init_matches_xla_init():
    """The XLA init + kernel must reproduce the all-XLA engine at a high
    active fraction: same iterations, same solutions, same KKT quality."""
    pbs = random_qp_batch(jax.random.key(17), 10, 12, 20, act_frac=0.5)
    opt = SolverOptions(max_iter=100)
    r1 = solve_refined_pallas(pbs, opt, interpret=True)
    _assert_same(r1, _xla(pbs, opt))
    resid = jax.vmap(kkt_residual)(r1.x, r1.multipliers, pbs)
    assert float(jnp.max(np.asarray(resid))) <= 1e-8


def test_fused_init_with_equalities_and_fixed():
    """Equality/fixed auto-activation in the XLA init, continued by the
    kernel, must match the all-XLA engine on equality-bearing batches."""
    opt = SolverOptions(max_iter=80)
    pbs = random_qp_batch(jax.random.key(21), 6, 9, 6, act_frac=0.3)
    l = pbs.l.at[:, 0].set(pbs.u[:, 0])          # constraint 0 equality
    l = l.at[:, 3].set(pbs.u[:, 3])              # constraint 3 equality
    xl = pbs.xl.at[:, 2].set(0.41)
    xu = pbs.xu.at[:, 2].set(0.41)               # variable 2 fixed
    pbs = dataclasses.replace(pbs, l=l, xl=xl, xu=xu)
    r1 = solve_refined_pallas(pbs, opt, interpret=True)
    _assert_same(r1, _xla(pbs, opt))
    np.testing.assert_allclose(np.asarray(r1.x[:, 2]), 0.41, atol=1e-6)
    resid = jax.vmap(kkt_residual)(r1.x, r1.multipliers, pbs)
    assert float(jnp.max(np.asarray(resid))) <= 1e-8


def test_fused_init_equality_only_lane_mix():
    """Mixed batch: some lanes carry equalities, others none -- each
    program must only see its own lane's pre-activated constraints."""
    opt = SolverOptions(max_iter=80)
    pbs = random_qp_batch(jax.random.key(22), 4, 8, 10, act_frac=0.4)
    l = pbs.l.at[1, 2].set(pbs.u[1, 2])          # lane 1 only: equality
    xl = pbs.xl.at[3, 0].set(-0.2)
    xu = pbs.xu.at[3, 0].set(-0.2)               # lane 3 only: fixed var
    pbs = dataclasses.replace(pbs, l=l, xl=xl, xu=xu)
    r1 = solve_refined_pallas(pbs, opt, interpret=True)
    _assert_same(r1, _xla(pbs, opt))


def test_vertex_touch_candidate_relocation():
    """Regression for the hole-based slot layout: when a solve touches a
    full-rank vertex (q == n), the pending candidate provisionally pins a
    PADDED slot and must be relocated into the slot freed by the
    forced dual-step removal -- without that, one multiplier lands in
    padding and is silently truncated from the outputs (KKT blows up while
    x stays near-correct)."""
    opt = SolverOptions(max_iter=120)
    # small n + many tight constraints => vertex touches are common
    pbs = random_qp_batch(jax.random.key(41), 12, 4, 16, act_frac=0.9)
    res = solve_refined_pallas(pbs, opt, interpret=True)
    rx = _xla(pbs, opt)
    ok = np.asarray(res.status) == 0
    assert ok.all()
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(rx.x),
                               atol=1e-7)
    resid = jax.vmap(kkt_residual)(res.x, res.multipliers, pbs)
    assert float(jnp.max(np.asarray(resid))) <= 1e-8, np.asarray(resid)


def test_warm_carry_kernel_large_drift():
    """The XLA warm-carry init (closed-form point + u<0 deactivation
    downdates) followed by the kernel must reach the same optimum as a
    cold solve even on large drifts that force several deactivations."""
    from jrlqp_tpu.solver.fast import solve_refined_pallas_carry

    opt = SolverOptions(max_iter=100)
    B, n, m = 5, 8, 12
    base = random_qp_batch(jax.random.key(29), B, n, m, act_frac=0.5)
    res0, carry = solve_refined_pallas_carry(base, None, opt, interpret=True)
    assert np.all(np.asarray(res0.status) == 0)
    d = 0.5 * jax.random.normal(jax.random.key(30), (B, m), base.l.dtype)
    pbs = dataclasses.replace(base, l=base.l + d, u=base.u + d)
    res_w, _ = solve_refined_pallas_carry(pbs, carry, opt, interpret=True)
    res_c = solve_refined_pallas(pbs, opt, interpret=True)
    assert np.all(np.asarray(res_w.status) == 0)
    np.testing.assert_allclose(np.asarray(res_w.x), np.asarray(res_c.x),
                               atol=1e-7)
    resid = jax.vmap(kkt_residual)(res_w.x, res_w.multipliers, pbs)
    assert float(jnp.max(resid)) <= 1e-8


def test_fused_init_detects_non_spd():
    """A non-SPD lane must terminate NON_POS_HESSIAN through the XLA
    init (the kernel never runs its loop) without touching the rest of
    the batch."""
    pbs = random_qp_batch(jax.random.key(18), 4, 8, 12, act_frac=0.3)
    G = pbs.G.at[2].set(jnp.diag(jnp.asarray(
        [1.0] * 7 + [-1.0], pbs.G.dtype)))
    bad = dataclasses.replace(pbs, G=G)
    res = solve_refined_pallas(bad, SolverOptions(max_iter=60),
                               interpret=True)
    sts = np.asarray(res.status)
    assert sts[2] == int(TerminationStatus.NON_POS_HESSIAN)
    assert all(sts[k] == int(TerminationStatus.SUCCESS) for k in (0, 1, 3))


def test_kernel_resumes_truncated_state():
    """A kernel state cut at max_iter (skip1, pending candidate, slot
    holes) fed back into the kernel finishes exactly like one run, and
    keeps the init-time dependence scale."""
    opt = SolverOptions(max_iter=100)
    opt32 = fast._opt32(opt)
    pbs = random_qp_batch(jax.random.key(24), 6, 10, 16, act_frac=0.6)
    pb32 = pbs.with_dtype(jnp.float32)
    st0 = jax.vmap(lambda p: fast._init_fast(p, opt32))(pb32)
    full = gi_kernel.run_loop_pallas(pb32, st0, 100, interpret=True)
    cut = gi_kernel.run_loop_pallas(pb32, st0, 7, interpret=True)
    assert (np.asarray(cut.term) == int(TerminationStatus.MAX_ITER_REACHED)
            ).any()
    cut = dataclasses.replace(cut, term=jnp.where(
        cut.term == int(TerminationStatus.MAX_ITER_REACHED), RUNNING,
        cut.term).astype(jnp.int32))
    rest = gi_kernel.run_loop_pallas(pb32, cut, 100, interpret=True)
    np.testing.assert_array_equal(np.asarray(rest.it), np.asarray(full.it))
    np.testing.assert_array_equal(np.asarray(rest.term),
                                  np.asarray(full.term))
    np.testing.assert_allclose(np.asarray(rest.x), np.asarray(full.x),
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(rest.hscale),
                                  np.asarray(st0.hscale))


@pytest.mark.parametrize("n,m,dims", [(8, 12, (16, 16)), (13, 7, (16, 8)),
                                      (50, 100, (64, 128)),
                                      (100, 200, (128, 256)),
                                      (3, 1, (8, 8))])
def test_padded_dims(n, m, dims):
    """Blocks are powers of two with room for the n+1-th (candidate) slot."""
    assert gi_kernel.padded_dims(n, m) == dims
    assert gi_kernel.kernel_fits(n, m) == (dims[0] <= gi_kernel.MAX_NP)


def test_kernel_engine_raises_off_gpu_without_interpret():
    """On the CPU the kernel engine runs only when interpret=True is
    passed; it never falls back to the interpreter silently."""
    pbs = random_qp_batch(jax.random.key(1), 2, 6, 8, act_frac=0.3)
    with pytest.raises(ValueError, match="interpret=True"):
        solve_refined_pallas(pbs, SolverOptions(max_iter=30))
    with pytest.raises(ValueError, match="interpret=True"):
        fast._use_kernel(6, 8, interpret=False)
    assert fast._use_kernel(6, 8, interpret=True)


def test_kernel_engine_routes_large_n_to_xla():
    """Above the kernel's size limit (padded n > MAX_NP) the kernel entry
    points run the XLA loop: same iterations and solution as
    vmap(solve_refined)."""
    n, m = 128, 6
    assert not fast._use_kernel(n, m, interpret=True)
    opt = SolverOptions(max_iter=60)
    pbs = random_qp_batch(jax.random.key(2), 2, n, m, act_frac=0.5)
    res = solve_refined_pallas(pbs, opt, interpret=True)
    _assert_same(res, _xla(pbs, opt), x_atol=1e-9)


def test_refine_batch_matches_f64_engine():
    """The native-f64 batched refinement of an f32 state reaches the f64
    J/R engine's solution."""
    from jrlqp_tpu import solve_batch

    opt = SolverOptions(max_iter=100)
    pbs = random_qp_batch(jax.random.key(9), 6, 12, 20, act_frac=0.4)
    opt32 = fast._opt32(opt)
    pb32 = pbs.with_dtype(jnp.float32)
    st = jax.vmap(lambda p: fast._run_fast(p, opt32))(pb32)
    res = fast._refine_batch(pbs, st, 3)
    ref = solve_batch(pbs, opt)
    assert np.all(np.asarray(res.status) == 0)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(res.f), np.asarray(ref.f),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(res.multipliers),
                               np.asarray(ref.multipliers), atol=1e-8)


@pytest.mark.parametrize("warm", [False, True])
def test_carry_honors_validate(warm):
    """Both branches of solve_refined_pallas_carry gate inconsistent lanes
    (l > u) to INCONSISTENT_INPUT when opt.validate is set."""
    from jrlqp_tpu.solver.fast import solve_refined_pallas_carry

    opt = SolverOptions(max_iter=60, validate=True)
    pbs = random_qp_batch(jax.random.key(12), 3, 6, 8, act_frac=0.3)
    carry = None
    if warm:
        _, carry = solve_refined_pallas_carry(pbs, None, opt, interpret=True)
    bad = dataclasses.replace(pbs, l=pbs.l.at[1, 0].set(pbs.u[1, 0] + 1.0))
    res, _ = solve_refined_pallas_carry(bad, carry, opt, interpret=True)
    sts = np.asarray(res.status)
    assert sts[1] == int(TerminationStatus.INCONSISTENT_INPUT)
    assert sts[0] == sts[2] == int(TerminationStatus.SUCCESS)


@pytest.fixture
def gpu_device():
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU: the Triton kernel compiles only for it")
    return jax.devices("gpu")[0]


@pytest.mark.gpu
def test_kernel_compiled_for_gpu_matches_xla(gpu_device):
    """The kernel as compiled for the card agrees with the XLA engine: the
    same status and iterations on >= 99.9% of lanes (f32 sums run in
    another order, so a near-tie may go the other way), and x within 1e-7
    on every lane where both engines succeed (SUCCESS, KKT <= 1e-8)."""
    opt = SolverOptions(max_iter=150)
    with jax.default_device(gpu_device):
        pbs = random_qp_batch(jax.random.key(0), 1024, 50, 100, act_frac=0.3)
        res_k = solve_refined_pallas(pbs, opt)
        res_x = _xla(pbs, opt)
        kkt_k, kkt_x = (np.asarray(jax.vmap(kkt_residual)(
            r.x, r.multipliers, pbs)) for r in (res_k, res_x))
    st_k, st_x = np.asarray(res_k.status), np.asarray(res_x.status)
    same = (st_k == st_x) & (np.asarray(res_k.iterations)
                             == np.asarray(res_x.iterations))
    assert same.mean() >= 0.999
    both = (st_k == 0) & (st_x == 0) & (kkt_k <= 1e-8) & (kkt_x <= 1e-8)
    assert both.mean() >= 0.999
    np.testing.assert_allclose(np.asarray(res_k.x)[both],
                               np.asarray(res_x.x)[both], atol=1e-7)
