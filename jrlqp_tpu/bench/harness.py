"""Benchmark harness: timing fixtures mirroring the reference's
google-benchmark suite (ref: benchmarks/Solvers.cpp:613-639,
benchmarks/SolversWarmStart.cpp:218-276, benchmarks/Decomposition.cpp).

The reference measures us/solve for one solver call at a time; on an
accelerator the unit of work is a *batch*, so every fixture here reports
us/solve = wall_time / batch and solves/sec, plus mean GI iterations (the
reference's ``it`` counter, SolversWarmStart.cpp:250). Times are medians of
repetitions that each end on ``block_until_ready``; compilation is
excluded.
"""
from __future__ import annotations

import dataclasses
import statistics
import subprocess
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..problems import QPProblem
from ..solver.dense import solve, solve_batch
from ..solver.mixed import solve_mixed
from ..solver.warm_start import solve_warm
from ..testing.batch_gen import random_qp_batch
from ..testing.kkt import kkt_residual
from ..types import SolverOptions

__all__ = [
    "BenchResult",
    "require_gpu",
    "gpu_name_and_power",
    "device_info",
    "time_batch",
    "bench_size_sweep",
    "bench_active_sweep",
    "bench_warm_start_trajectory",
    "bench_decompositions",
    "bench_structured_ik",
    "bench_scaling",
    "ik_batch",
]


@dataclasses.dataclass
class BenchResult:
    name: str
    batch: int
    wall_s: float
    us_per_solve: float
    solves_per_sec: float
    mean_iterations: float
    max_kkt_residual: float
    success_rate: float
    kkt_pass_rate: float  # fraction with SUCCESS *and* KKT <= 1e-8

    def row(self) -> dict:
        return dataclasses.asdict(self)


def require_gpu():
    """Raise unless JAX's default backend is the GPU: device timings are
    never taken on another backend."""
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {jax.default_backend()!r}")


def device_info() -> dict:
    """The device the numbers were taken on, as JAX reports it."""
    d = jax.devices()[0]
    return dict(platform=d.platform, kind=d.device_kind,
                count=len(jax.devices()))


def gpu_name_and_power() -> str:
    """``nvidia-smi``'s card name and power limit (first line), e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _timeit(fn: Callable, n_rep: int = 5) -> float:
    """Median wall time of ``n_rep`` calls after one warm-up call."""
    jax.block_until_ready(fn())
    ts = []
    for _ in range(n_rep):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def time_batch(
    name: str,
    pbs: QPProblem,
    opt: SolverOptions = SolverOptions(max_iter=500),
    solver: str = "f64",
    n_rep: int = 5,
) -> BenchResult:
    """Time one jitted batched solve (compile excluded)."""
    if solver == "mixed":
        run = jax.jit(jax.vmap(lambda p: solve_mixed(p, opt)))
    elif solver == "pallas":
        from ..solver.fast import solve_refined_pallas

        run = lambda p: solve_refined_pallas(p, opt)  # noqa: E731
    elif solver == "pallas_rescued":
        from ..solver.fast import solve_refined_pallas_rescued

        # host-orchestrated two-phase (not jittable end-to-end)
        run = lambda p: solve_refined_pallas_rescued(p, opt)  # noqa: E731
    elif solver == "refined":
        from ..solver.fast import solve_refined

        run = jax.jit(jax.vmap(lambda p: solve_refined(p, opt)))
    else:
        run = jax.jit(lambda p: solve_batch(p, opt))
    res = jax.block_until_ready(run(pbs))  # compile + warmup
    wall = _timeit(lambda: run(pbs), n_rep)
    batch = pbs.G.shape[0]
    resid = jax.vmap(kkt_residual)(res.x, res.multipliers, pbs)
    ok = res.status == 0
    return BenchResult(
        name=name,
        batch=batch,
        wall_s=wall,
        us_per_solve=wall / batch * 1e6,
        solves_per_sec=batch / wall,
        mean_iterations=float(jnp.mean(res.iterations)),
        max_kkt_residual=float(jnp.max(jnp.where(ok, resid, 0.0))),
        success_rate=float(jnp.mean(ok.astype(jnp.float64))),
        kkt_pass_rate=float(jnp.mean(
            (ok & (resid <= 1e-8)).astype(jnp.float64))),
    )


def bench_size_sweep(
    sizes=(10, 25, 50, 75, 100),
    batch: int = 64,
    solver: str = "f64",
    seed: int = 0,
) -> list[BenchResult]:
    """Variables sweep at m = 2n (ref: Solvers.cpp size sweep 10-100 vars)."""
    out = []
    for n in sizes:
        pbs = random_qp_batch(jax.random.key(seed), batch, n, 2 * n, act_frac=0.3)
        out.append(time_batch(f"size/n={n}/m={2 * n}", pbs, solver=solver))
    return out


def bench_active_sweep(
    n: int = 50,
    m: int = 100,
    fracs=(0.0, 0.1, 0.3, 0.5, 0.8, 0.95),
    batch: int = 64,
    solver: str = "f64",
    seed: int = 0,
) -> list[BenchResult]:
    """Active-fraction sweep (ref: Solvers.cpp %active fixtures)."""
    out = []
    for fr in fracs:
        pbs = random_qp_batch(jax.random.key(seed), batch, n, m, act_frac=fr)
        out.append(time_batch(f"active/{int(fr * 100)}%", pbs, solver=solver))
    return out


def bench_warm_start_trajectory(
    n: int = 20,
    m: int = 40,
    steps: int = 100,
    batch: int = 32,
    shift_scale: float = 0.02,
    seed: int = 0,
    solver: str = "f64",
    time_window: int = 20,
) -> dict:
    """Control-loop trajectory benchmark
    (ref: benchmarks/SolversWarmStart.cpp:31-59,162-169): a batch of QPs
    whose bounds drift a little each step; the warm solver carries the
    previous step's state. Reports mean iterations/step and us/solve, warm
    vs cold (the reference's ``it`` counter). ``solver``: "f64" = J/R warm
    path (scan-based), "pallas" = loop kernel with operator-reuse warm
    carry, driven step by step from the host like a real control loop.
    Timing for the pallas path is the wall clock of ``time_window``
    consecutive steps after a warm-up step.
    """
    opt = SolverOptions(max_iter=100, warm_start=True)
    base = random_qp_batch(jax.random.key(seed), batch, n, m, act_frac=0.4)
    key = jax.random.key(seed + 1)
    drifts = shift_scale * jax.random.normal(key, (steps, batch, m),
                                             base.l.dtype)

    def shifted(pb: QPProblem, d):
        return dataclasses.replace(pb, l=pb.l + d, u=pb.u + d)

    if solver == "pallas":
        from ..solver.fast import (
            solve_refined_pallas,
            solve_refined_pallas_carry,
        )

        shift_j = jax.jit(jax.vmap(shifted))

        def run_traj(warm: bool):
            carry = None
            its, sts, t0, t_win = [], [], None, None
            for s_i in range(steps):
                pbs = shift_j(base, drifts[s_i])
                if warm:
                    res, carry = solve_refined_pallas_carry(pbs, carry, opt)
                else:
                    res = solve_refined_pallas(pbs, opt)
                jax.block_until_ready(res)
                if s_i == 1:  # step 0 = compile + warm-up
                    t0 = time.perf_counter()
                its.append(res.iterations)
                sts.append(res.status)
                if t0 is not None and s_i == min(steps - 1, time_window):
                    t_win = (time.perf_counter() - t0) / (s_i - 1 + 1e-12)
            return (jnp.stack(its), jnp.stack(sts),
                    t_win * steps if t_win is not None else 0.0)

        its_w, sts_w, t_w = run_traj(True)
        its_c, sts_c, t_c = run_traj(False)
    else:
        @jax.jit
        def run_warm(base, drifts):
            def step(carry, d):
                hints = carry
                pbs = jax.vmap(shifted)(base, d)
                res = jax.vmap(lambda p, h: solve_warm(p, h, opt))(pbs, hints)
                return res.active_set, (res.iterations, res.status)

            init = jnp.zeros((batch, m + n), jnp.int32)
            _, (its, sts) = jax.lax.scan(step, init, drifts)
            return its, sts

        @jax.jit
        def run_cold(base, drifts):
            def step(_, d):
                pbs = jax.vmap(shifted)(base, d)
                res = jax.vmap(lambda p: solve(p, opt))(pbs)
                return 0, (res.iterations, res.status)

            _, (its, sts) = jax.lax.scan(step, 0, drifts)
            return its, sts

        its_w, sts_w = run_warm(base, drifts)
        its_c, sts_c = run_cold(base, drifts)
        t_w = _timeit(lambda: run_warm(base, drifts))
        t_c = _timeit(lambda: run_cold(base, drifts))

    n_solves = steps * batch
    return dict(
        name=f"warm_start_trajectory/{solver}/n={n}/m={m}/steps={steps}",
        batch=batch,
        steps=steps,
        warm_mean_it=float(jnp.mean(its_w[1:])),  # step 0 is effectively cold
        cold_mean_it=float(jnp.mean(its_c)),
        warm_us_per_solve=t_w / n_solves * 1e6,
        cold_us_per_solve=t_c / n_solves * 1e6,
        warm_success=float(jnp.mean((sts_w == 0).astype(jnp.float64))),
        cold_success=float(jnp.mean((sts_c == 0).astype(jnp.float64))),
    )


def bench_scaling(
    mesh_sizes=(1, 2, 4, 8),
    n: int = 50,
    m: int = 100,
    per_device_batch: int = 256,
    engine: str = "f64",
    seed: int = 0,
    platform: str | None = None,
) -> list[dict]:
    """Weak-scaling capture over a device mesh (BASELINE.md scaling row):
    solves/s at each mesh size with a fixed per-device batch, on the
    devices of ``platform`` (default: the default backend). Efficiency is
    relative to mesh size 1 (perfect weak scaling = 1.0)."""
    import jax.sharding

    from ..parallel.mesh import solve_sharded

    all_devs = jax.devices(platform) if platform else jax.devices()
    rows = []
    base_rate = None
    for nd in mesh_sizes:
        if len(all_devs) < nd:
            continue
        mesh = jax.make_mesh((nd,), ("batch",), devices=all_devs[:nd])
        platform = mesh.devices.ravel()[0].platform
        batch = per_device_batch * nd
        pbs = random_qp_batch(jax.random.key(seed), batch, n, m,
                              act_frac=0.3)
        run = lambda: solve_sharded(pbs, SolverOptions(max_iter=150),  # noqa: E731
                                    mesh=mesh, engine=engine)
        res, stats = jax.block_until_ready(run())
        wall = _timeit(run)
        rate = batch / wall
        if base_rate is None:
            base_rate = rate / nd  # per-device rate at the smallest mesh
        rows.append(dict(
            name=f"scaling/{engine}/mesh={nd}/{platform}",
            mesh_size=nd,
            platform=platform,
            batch=batch,
            solves_per_sec=rate,
            us_per_solve=wall / batch * 1e6,
            efficiency=rate / (base_rate * nd),
            success_rate=float(jnp.mean(
                (res.status == 0).astype(jnp.float64))),
        ))
    return rows


def bench_box_single(
    n: int = 16,
    batch: int = 1024,
    seed: int = 0,
    n_rep: int = 3,
) -> dict:
    """Box-and-single-constraint batch (BASELINE config 2 / ref
    benchmarks/BoxAndSingleConstraintSolver.cpp): 1k+ small
    min |x - x0|^2 s.t. c'x >= bl, box problems, vmapped."""
    from ..solver.box_single import solve_box

    rng = np.random.default_rng(seed)
    x0 = jnp.asarray(rng.standard_normal((batch, n)))
    c = jnp.asarray(rng.standard_normal((batch, n)))
    xl = jnp.asarray(-np.abs(rng.standard_normal((batch, n))) - 0.1)
    xu = jnp.asarray(np.abs(rng.standard_normal((batch, n))) + 0.1)
    mid = np.clip(np.asarray(x0), np.asarray(xl), np.asarray(xu))
    bl = jnp.asarray(np.sum(np.asarray(c) * mid, axis=1)
                     + rng.uniform(-0.5, 0.5, batch))
    opt = SolverOptions(max_iter=3 * n)
    run = jax.jit(jax.vmap(lambda *a: solve_box(*a, opt)))
    res = jax.block_until_ready(run(x0, c, bl, xl, xu))
    wall = _timeit(lambda: run(x0, c, bl, xl, xu), n_rep)
    ok = res.status == 0
    return dict(
        name=f"box_single/n={n}",
        batch=batch,
        wall_s=wall,
        us_per_solve=wall / batch * 1e6,
        solves_per_sec=batch / wall,
        mean_iterations=float(jnp.mean(res.iterations)),
        success_rate=float(jnp.mean(ok.astype(jnp.float64))),
    )


def bench_decompositions(
    nb: int = 9, s: int = 48, batch: int = 16, seed: int = 0,
    include_f64: bool = True,
) -> list[dict]:
    """Structured vs dense Cholesky timings (ref: benchmarks/Decomposition.cpp
    and the IK timing harness in tests/BlockGISolverTest.in.cpp:251-268).

    Measures the XLA blocked LLT chains and dense Cholesky in f64 and f32.
    Rows carry ``speedup_vs_dense`` relative to the same-precision dense
    factor."""
    from ..structured.blocks import (
        block_arrow_llt,
        tri_block_diag_llt,
        tri_block_to_dense,
    )

    rng = np.random.default_rng(seed)
    diag = np.zeros((batch, nb, s, s))
    off = rng.standard_normal((batch, nb - 1, s, s))
    for b in range(batch):
        for i in range(nb):
            A = rng.standard_normal((s, s))
            diag[b, i] = A @ A.T + nb * s * np.eye(s)
    n = nb * s
    tri = jax.jit(jax.vmap(tri_block_diag_llt))
    arrow = jax.jit(jax.vmap(lambda d, o: block_arrow_llt(d, o)))
    dense = jax.jit(jax.vmap(jnp.linalg.cholesky))

    def row(name, t, t_ref=None):
        r = dict(name=f"{name}/batch={batch}", ms=t / batch * 1e3)
        if t_ref is not None:
            r["speedup_vs_dense"] = t_ref / t
        return r

    rows = []
    for dtype, tag in ((jnp.float64, ""), (jnp.float32, "_f32")):
        if dtype == jnp.float64 and not include_f64:
            continue
        d, o = jnp.asarray(diag, dtype), jnp.asarray(off, dtype)
        dense_in = jax.vmap(tri_block_to_dense)(d, o)
        t_dense = _timeit(lambda: dense(dense_in))
        rows += [
            row(f"llt/tri_block{tag}/nb={nb}/s={s}",
                _timeit(lambda: tri(d, o)), t_dense),
            row(f"llt/block_arrow{tag}/nb={nb}/s={s}",
                _timeit(lambda: arrow(d, o)), t_dense),
            row(f"llt/dense{tag}/n={n}", t_dense),
        ]
    return rows


def ik_batch(nb: int = 9, s: int = 43, mc: int = 4, batch: int = 16,
             seed: int = 0):
    """Batch of IK-shaped QPs (ref workload: tests/BlockGISolverTest.in.cpp:
    172-271 'Sequential IK', 9 robots x 43 dof): tri-block-diagonal G,
    block-diagonal C with ``mc`` rows per block, feasible bounds. Returns
    (StructuredG, StructuredC, a, l, u), all batch-leading."""
    from ..structured.containers import GType, StructuredC, StructuredG

    rng = np.random.default_rng(seed)
    n, m = nb * s, nb * mc
    diag = np.zeros((batch, nb, s, s))
    off = rng.standard_normal((batch, nb - 1, s, s))
    blocks = rng.standard_normal((batch, nb, mc, s))
    a = rng.standard_normal((batch, n))
    l_ = np.zeros((batch, m))
    u_ = np.zeros((batch, m))
    for b in range(batch):
        for i in range(nb):
            A = rng.standard_normal((s, s))
            diag[b, i] = A @ A.T + nb * s * np.eye(s)
        x0 = rng.uniform(-1, 1, n)
        Cd = np.zeros((m, n))
        for i in range(nb):
            Cd[i * mc:(i + 1) * mc, i * s:(i + 1) * s] = blocks[b, i]
        cx = Cd @ x0
        l_[b] = cx - rng.uniform(0.0, 0.5, m)
        u_[b] = cx + rng.uniform(0.0, 2.0, m)
    sgs = StructuredG(diag=jnp.asarray(diag), off=jnp.asarray(off),
                      gtype=int(GType.TRI_BLOCK_DIAGONAL))
    scs = StructuredC(blocks=jnp.asarray(blocks))
    return sgs, scs, jnp.asarray(a), jnp.asarray(l_), jnp.asarray(u_)


def bench_structured_ik(
    nb: int = 9, s: int = 43, mc: int = 4, batch: int = 16, seed: int = 0,
) -> list[dict]:
    """Batched IK-shaped workload end to end through the structured fast
    path (:func:`ik_batch`, inline timing at tests/BlockGISolverTest.in.cpp:
    251-268) against the dense fast engine, reporting ms/solve and
    cross-engine agreement."""
    from ..solver.fast import solve_refined
    from ..structured.solver import (
        solve_structured_fast_batch,
        structured_qp_problem,
    )

    sgs, scs, a_b, l_b, u_b = ik_batch(nb, s, mc, batch, seed)
    opt = SolverOptions(max_iter=200)
    f_struct = jax.jit(lambda sg, av, sc, lv, uv: solve_structured_fast_batch(
        sg, av, sc, lv, uv, opt=opt))
    pbs = jax.vmap(
        lambda sg, av, sc, lv, uv: structured_qp_problem(sg, av, sc, lv, uv)
    )(sgs, a_b, scs, l_b, u_b)
    f_dense = jax.jit(jax.vmap(lambda p: solve_refined(p, opt)))

    rows = []
    ref_x = None
    for name, fn, args in [
        ("structured_fast", f_struct, (sgs, a_b, scs, l_b, u_b)),
        ("dense_fast", f_dense, (pbs,)),
    ]:
        res = jax.block_until_ready(fn(*args))
        t = _timeit(lambda: fn(*args))
        ok = float(jnp.mean((res.status == 0).astype(jnp.float64)))
        row = dict(name=f"ik/{name}/nb={nb}/s={s}/batch={batch}",
                   batch=batch,
                   ms_per_solve=t / batch * 1e3,
                   solves_per_sec=batch / t,
                   success_rate=ok)
        if ref_x is None:
            ref_x = res.x
        else:
            row["max_diff_vs_structured"] = float(
                jnp.max(jnp.abs(res.x - ref_x)))
        rows.append(row)
    return rows
