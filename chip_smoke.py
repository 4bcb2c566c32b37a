"""Smoke run of the batched GI solver on one GPU (or a 4-GPU mesh).

Drives the user entry points once at real sizes, each kernel as compiled for
the card, and checks every result against the repository's own references:

1. headline: ``solve_refined_pallas`` at n=50, m=100, batch 16384;
2. engine comparisons on 1024 lanes of that batch: the vmapped XLA engine
   ``solve_refined`` (same math), the f64 engine ``solve_batch``, and
   ``reference_impl.solve_np`` on the host for 32 problems; the kernel's
   widest blocks against ``solve_refined`` at n=100, m=200, 1024 lanes;
3. warm trajectory: ``solve_refined_pallas_carry`` at n=20, m=40,
   batch 4096, 16 drifting steps, failed lanes through the library's f64
   rescue ``rescue_failed_lanes``;
4. structured: ``solve_structured_fast_batch`` at the 9x43 IK shape,
   batch 128, against the dense f64 engine;
5. corpus: ``run_corpus`` on the 16 vendored Maros-Meszaros problems.

``--devices 4`` runs only the sharded path: ``solve_sharded`` over four
cards at 16384 problems per card, compared lane for lane with the one-card
engine on the same problems.

Every phase raises on failure. The last line of stdout is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``. Run from the repo
root: ``python chip_smoke.py [--devices 4]``.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import jax

if jax.default_backend() != "gpu":
    sys.exit(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from jrlqp_tpu import SolverOptions, solve_batch  # noqa: E402
from jrlqp_tpu.bench import device_info, gpu_name_and_power, ik_batch  # noqa: E402
from jrlqp_tpu.solver.fast import (  # noqa: E402
    solve_refined,
    solve_refined_pallas,
    solve_refined_pallas_carry,
    rescue_failed_lanes,
)
from jrlqp_tpu.testing.batch_gen import random_qp_batch  # noqa: E402
from jrlqp_tpu.testing.kkt import kkt_residual  # noqa: E402
from jrlqp_tpu.utils.cache import enable_compile_cache  # noqa: E402

N, M, BATCH = 50, 100, 16384
OPT = SolverOptions(max_iter=150)


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def kkt(res, pbs):
    return np.asarray(jax.vmap(kkt_residual)(res.x, res.multipliers, pbs))


def timed(fn):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def headline_batch(batch=BATCH):
    return random_qp_batch(jax.random.key(0), batch, N, M, act_frac=0.3,
                           dtype=jnp.float32).with_dtype(jnp.float64)


def phase_headline(pbs):
    res = jax.block_until_ready(solve_refined_pallas(pbs, OPT))  # compile
    res, t = timed(lambda: solve_refined_pallas(pbs, OPT))
    ok = (kkt(res, pbs) <= 1e-8) & (np.asarray(res.status) == 0)
    its = np.asarray(res.iterations)
    log(f"headline: n={N} m={M} batch={BATCH} kkt<=1e-8 pass rate "
        f"{ok.mean():.6f} mean_it {its.mean():.2f} max_it {its.max()} "
        f"solves/s {BATCH / t:.1f}")
    check(ok.mean() >= 0.999, "headline KKT pass rate below 0.999")


def against_xla(pbs, opt, label):
    """The kernel engine against the vmapped XLA engine (same math) on
    ``pbs``; returns the kernel's result."""
    rk = solve_refined_pallas(pbs, opt)
    rx = jax.jit(jax.vmap(lambda p: solve_refined(p, opt)))(pbs)
    st_k, st_x = np.asarray(rk.status), np.asarray(rx.status)
    it_k, it_x = np.asarray(rk.iterations), np.asarray(rx.iterations)
    kkt_k, kkt_x = kkt(rk, pbs), kkt(rx, pbs)
    # f32 sums run in another order in the kernel than in XLA, so a lane
    # may take another path through a near-tie; x is compared on every
    # lane where both engines succeed (SUCCESS and KKT <= 1e-8)
    same = (st_k == st_x) & (it_k == it_x)
    both = (st_k == 0) & (st_x == 0) & (kkt_k <= 1e-8) & (kkt_x <= 1e-8)
    dx = np.abs(np.asarray(rk.x) - np.asarray(rx.x)).max(axis=1)
    log(f"engines: {label}: kernel vs XLA: same status+iterations "
        f"{same.mean():.6f}, both succeed {both.mean():.6f}, max |dx| "
        f"{dx[both].max():.3e} over {both.sum()} lanes")
    for i in np.nonzero(~same | ~both)[0]:
        log(f"engines: {label}: lane {i}: status {st_k[i]}/{st_x[i]} "
            f"iterations {it_k[i]}/{it_x[i]} kkt {kkt_k[i]:.3e}/"
            f"{kkt_x[i]:.3e} (kernel/XLA) |dx| {dx[i]:.3e}")
    check(same.mean() >= 0.999, f"{label}: kernel and XLA disagree on "
          f">0.1% of lanes")
    check(both.mean() >= 0.999, f"{label}: kernel or XLA failed on >0.1% "
          f"of lanes")
    check(dx[both].max() <= 1e-7, f"{label}: kernel vs XLA |dx| above 1e-7")
    return rk


def phase_engines(pbs_full):
    prec = jax.config.jax_default_matmul_precision
    log(f"engines: default matmul precision {prec!r}")
    check(prec in ("float32", "highest"),
          "f32 contractions outside the kernel must run at full precision")
    pbs = jax.tree.map(lambda a: a[:1024], pbs_full)
    rk = against_xla(pbs, OPT, f"n={N} m={M}")
    # the kernel's widest blocks (128), at an iteration cap every lane
    # converges under
    against_xla(random_qp_batch(jax.random.key(1), 1024, 100, 200,
                                act_frac=0.3, dtype=jnp.float32
                                ).with_dtype(jnp.float64),
                SolverOptions(max_iter=1000), "n=100 m=200")

    r64 = jax.jit(lambda p: solve_batch(p, OPT))(pbs)
    both = (np.asarray(rk.status) == 0) & (np.asarray(r64.status) == 0)
    f_k, f_64 = np.asarray(rk.f), np.asarray(r64.f)
    rel = np.abs(f_k - f_64) / np.maximum(1.0, np.abs(f_64))
    log(f"engines: kernel vs f64 engine: both succeed {both.mean():.6f}, "
        f"max rel objective diff {rel[both].max():.3e}")
    check(both.mean() >= 0.999, "kernel or f64 engine failed on >0.1%")
    check(rel[both].max() <= 1e-8, "objective differs from f64 by >1e-8")

    from jrlqp_tpu.reference_impl import solve_np

    worst = 0.0
    for i in range(32):
        pb = jax.tree.map(lambda a: np.asarray(a[i]), pbs)
        x_ref = solve_np(pb.G, pb.a, pb.C, pb.l, pb.u, pb.xl, pb.xu).x
        worst = max(worst, float(np.abs(np.asarray(rk.x[i]) - x_ref).max()))
    log(f"engines: kernel vs reference_impl.solve_np (32 problems, host): "
        f"max |dx| {worst:.3e}")
    check(worst <= 1e-6, "kernel vs host reference |dx| above 1e-6")


def phase_warm(n=20, m=40, batch=4096, steps=16, drift=0.02):
    opt = SolverOptions(max_iter=100)
    base = random_qp_batch(jax.random.key(5), batch, n, m, act_frac=0.4)
    drifts = drift * jax.random.normal(jax.random.key(6), (steps, batch, m),
                                       base.l.dtype)

    def step_pb(k):
        return dataclasses.replace(base, l=base.l + drifts[k],
                                   u=base.u + drifts[k])

    _, carry = solve_refined_pallas_carry(step_pb(0), None, opt)
    # compile the warm and the cold program before the clock runs
    jax.block_until_ready(solve_refined_pallas_carry(step_pb(0), carry, opt))
    jax.block_until_ready(solve_refined_pallas(step_pb(0), opt))
    t_warm = t_cold = 0.0
    its, n_bad, worst = [], 0, 0.0
    for k in range(1, steps):
        pbs = step_pb(k)
        (res, carry), dt = timed(
            lambda: solve_refined_pallas_carry(pbs, carry, opt))
        t_warm += dt
        _, dt = timed(lambda: solve_refined_pallas(pbs, opt))
        t_cold += dt
        its.append(float(jnp.mean(res.iterations)))
        n_bad += int(np.sum((kkt(res, pbs) > 1e-8)
                            | (np.asarray(res.status) != 0)))
        # the library's f64 rescue must bring every lane to the gate
        res = rescue_failed_lanes(pbs, res, opt)
        r = kkt(res, pbs)
        ok = (r <= 1e-8) & (np.asarray(res.status) == 0)
        worst = max(worst, float(r.max()))
        check(bool(ok.all()), f"warm step {k}: {int((~ok).sum())} lanes "
              f"above KKT 1e-8 after the rescue")
    per = batch * (steps - 1)
    log(f"warm: n={n} m={m} batch={batch} steps={steps - 1} warm "
        f"{t_warm / per * 1e6:.3f} us/solve cold {t_cold / per * 1e6:.3f} "
        f"us/solve warm mean_it {np.mean(its):.3f}; lane-steps above KKT "
        f"1e-8 or not SUCCESS before rescue_failed_lanes {n_bad}, max KKT "
        f"after {worst:.3e}")


def phase_structured(batch=128):
    from jrlqp_tpu.structured.solver import (
        solve_structured_fast_batch,
        structured_qp_problem,
    )

    sgs, scs, a, l, u = ik_batch(9, 43, 4, batch, seed=0)
    opt = SolverOptions(max_iter=200)
    res = jax.jit(lambda *args: solve_structured_fast_batch(*args, opt=opt))(
        sgs, a, scs, l, u)
    pbs = jax.vmap(structured_qp_problem)(sgs, a, scs, l, u)
    ref = jax.jit(lambda p: solve_batch(p, opt))(pbs)
    ok = (np.asarray(res.status) == 0) & (np.asarray(ref.status) == 0)
    dx = float(np.abs(np.asarray(res.x) - np.asarray(ref.x)).max())
    log(f"structured: 9x43 IK batch={batch} success {ok.mean():.6f} "
        f"max |dx| vs dense f64 {dx:.3e}")
    check(ok.all(), "structured or dense engine failed a lane")
    check(dx <= 1e-10, "structured vs dense |dx| above 1e-10")


def phase_corpus():
    from jrlqp_tpu.io import run_corpus
    from jrlqp_tpu.io.maros_meszaros import MAROS_MESZAROS

    qps_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", "qps")
    names = {f[:-4].lower() for f in os.listdir(qps_dir)
             if f.upper().endswith(".QPS")}
    entries = [e for e in MAROS_MESZAROS if e.name in names]
    results = run_corpus(qps_dir=qps_dir, entries=entries, bucketed=True,
                         engine="pallas_rescued")
    # the singular-G members (cond > 1e8, outside the reference's filter)
    # pass with f* or with a detected NON_POS_HESSIAN, as in
    # tests/test_corpus.py
    singular = {"hs51", "hs52", "hs53", "genhs28", "tame", "cvxqp1_s",
                "cvxqp2_s", "cvxqp3_s"}
    hit = [r for r in results if r.get("obj_ok")]
    for r in results:
        if not r.get("obj_ok"):
            log(f"corpus: no f* for {r['name']} (status {r['status']})")
    log(f"corpus: {len(hit)} of {len(results)} match f* within 1e-6 "
        f"relative")
    check(len(results) == 16, "corpus: vendored problems missing")
    check(all(r.get("obj_ok") or (r["name"] in singular
                                  and r["status"] == "NON_POS_HESSIAN")
              for r in results), "corpus: a problem missed f*")


def phase_sharded(n_dev, per_dev=BATCH, interpret=False):
    from jrlqp_tpu.parallel.mesh import make_mesh, solve_sharded

    mesh = make_mesh(n_dev)
    pbs = random_qp_batch(jax.random.key(0), per_dev * n_dev, N, M,
                          act_frac=0.3, dtype=jnp.float32
                          ).with_dtype(jnp.float64)

    def sharded():
        return solve_sharded(pbs, OPT, mesh=mesh, engine="pallas",
                             interpret=interpret)

    jax.block_until_ready(sharded())  # compile
    (res, stats), t = timed(sharded)
    # the one-card engine on the same problems, one shard-sized batch at a
    # time on the first card (the program each card ran)
    one = [jax.block_until_ready(solve_refined_pallas(
        jax.device_put(jax.tree.map(lambda a: a[k * per_dev:(k + 1) * per_dev],
                                    pbs), jax.devices()[0]),
        OPT, interpret=interpret)) for k in range(n_dev)]
    st = np.asarray(res.status)
    st1 = np.concatenate([np.asarray(r.status) for r in one])
    it1 = np.concatenate([np.asarray(r.iterations) for r in one])
    x1 = np.concatenate([np.asarray(r.x) for r in one])
    dx = float(np.abs(np.asarray(res.x) - x1).max())
    log(f"sharded: {n_dev} devices x {per_dev} problems, "
        f"{per_dev * n_dev / t:.1f} solves/s; status identical "
        f"{np.mean(st == st1):.6f}; max |dx| vs one card {dx:.3e}; stats "
        f"total_it {int(stats.total_iterations)} n_success "
        f"{int(stats.n_success)} max_it {int(stats.max_iterations)}")
    check(np.array_equal(st, st1), "sharded status differs from one card")
    check(dx <= 1e-9, "sharded |dx| vs one card above 1e-9")
    check(int(stats.total_iterations) == int(it1.sum())
          and int(stats.n_success) == int((st1 == 0).sum())
          and int(stats.max_iterations) == int(it1.max()),
          "BatchStats differ from the one-card sums")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=1)
    args = ap.parse_args()
    enable_compile_cache()
    log(gpu_name_and_power())
    log(f"device: {device_info()}")
    if args.devices > 1:
        check(len(jax.devices()) >= args.devices,
              f"need {args.devices} GPUs, have {len(jax.devices())}")
        phase_sharded(args.devices)
    else:
        pbs = headline_batch()
        phase_headline(pbs)
        phase_engines(pbs)
        phase_warm()
        phase_structured()
        phase_corpus()
    print(json.dumps({"ok": True, "device": device_info()}))


if __name__ == "__main__":
    main()
