"""Engine comparison on the GPU: the loop kernel against the XLA engine.

Times, end to end and by layer, the batched GI engines at the shapes the
benchmark uses, and writes one JSON object per measurement to stdout (and to
``--out`` if given):

- ``dense``: ``jax.vmap(solve_refined)`` (XLA init + XLA loop +
  refinement), the production entry ``solve_refined_pallas`` with its own
  engine and warp choice, and, within the kernel's size limit, XLA init +
  Triton loop kernel + refinement for each ``--warps`` value; all with the
  production engine's refinement steps, taking turns rep by rep; the init,
  loop and refinement layers are also timed on their own;
- ``warm``: one warm trajectory step both ways: the loop kernel with its
  fused warm prologue (``solve_refined_pallas_carry``) and the XLA carry
  init followed by the kernel without it; the XLA carry init is also timed
  on its own, with and without its u < 0 deactivation loop;
- ``structured``: the blocked-LLT init and the whole batched structured
  solve at the 9x43 IK shape.

Every time is the median of ``--reps`` runs, each ending on
``block_until_ready``; compilation is excluded. Run on the GPU:

    python benchmarks/engines.py --phase dense --shape 50,100,16384
"""
import argparse
import dataclasses
import glob
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from jrlqp_tpu import SolverOptions  # noqa: E402
from jrlqp_tpu.bench.harness import gpu_name_and_power, require_gpu  # noqa: E402
from jrlqp_tpu.utils.cache import enable_compile_cache  # noqa: E402
from jrlqp_tpu.ops.pallas import gi_kernel  # noqa: E402
from jrlqp_tpu.solver import fast  # noqa: E402
from jrlqp_tpu.testing.batch_gen import random_qp_batch  # noqa: E402
from jrlqp_tpu.testing.kkt import kkt_residual  # noqa: E402


IR_STEPS = 3  # refinement steps of the production engine


def median_time(fn, reps):
    return interleaved([fn], reps)[0][0]


def interleaved(fns, reps):
    """Time each of ``fns`` ``reps`` times, taking turns so that drift of
    the card's clock falls on all alike. Returns (median, all times) per
    function, each time ending on ``block_until_ready``."""
    for fn in fns:
        jax.block_until_ready(fn())
    ts = [[] for _ in fns]
    for _ in range(reps):
        for fn, t in zip(fns, ts):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            t.append(time.perf_counter() - t0)
    return [(statistics.median(t), t) for t in ts]


def device_profile(fn, calls):
    """Profile ``calls`` back-to-back calls of ``fn`` (compiled first) with
    the JAX profiler. Device busy time is the union of the event intervals
    on the GPU planes' stream lines; returns it per call, with the host
    time per call, the device operations per call and the idle share of
    the window."""
    jax.block_until_ready(fn())
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn()
        jax.block_until_ready(out)
        wall = time.perf_counter() - t0
        jax.profiler.stop_trace()
        path = glob.glob(os.path.join(d, "plugins", "profile", "*",
                                      "*.xplane.pb"))[0]
        data = jax.profiler.ProfileData.from_file(path)
    spans, lines = [], set()
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                lines.add(line.name)
                spans += [(e.start_ns, e.start_ns + e.duration_ns)
                          for e in line.events]
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return dict(calls=calls, host_per_call_s=wall / calls,
                device_busy_per_call_s=busy * 1e-9 / calls,
                device_ops_per_call=len(spans) / calls,
                idle_share=1.0 - busy * 1e-9 / wall,
                stream_lines=sorted(lines),
                device_planes=[p.name for p in data.planes
                               if p.name.startswith("/device")])


def emit(row, out):
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def quality(res, pbs):
    resid = jax.vmap(kkt_residual)(res.x, res.multipliers, pbs)
    ok = (resid <= 1e-8) & (res.status == 0)
    return dict(kkt_pass_rate=float(jnp.mean(ok)),
                mean_it=float(jnp.mean(res.iterations)),
                max_it=int(jnp.max(res.iterations)))


def phase_dense(n, m, batch, warps, reps, max_iter, out, trace=False):
    opt = SolverOptions(max_iter=max_iter)
    opt32 = fast._opt32(opt)
    pbs = random_qp_batch(jax.random.key(0), batch, n, m, act_frac=0.3,
                          dtype=jnp.float32).with_dtype(jnp.float64)
    pb32 = pbs.with_dtype(jnp.float32)
    init = jax.jit(jax.vmap(lambda p: fast._init_fast(p, opt32)))
    st0 = jax.block_until_ready(init(pb32))
    base = dict(n=n, m=m, batch=batch, max_iter=max_iter, ir_steps=IR_STEPS)
    t_init = median_time(lambda: init(pb32), reps)
    emit(dict(base, layer="init_xla", s=t_init), out)
    loop_xla = jax.jit(jax.vmap(lambda p, s: fast._loop_xla(p, s, opt32)))
    t = median_time(lambda: loop_xla(pb32, st0), reps)
    emit(dict(base, layer="loop_xla", s=t), out)
    st = loop_xla(pb32, st0)
    refine = jax.jit(lambda p, s: fast._refine_batch(p, s, IR_STEPS))
    t = median_time(lambda: refine(pbs, st), reps)
    emit(dict(base, layer="refine", s=t), out)

    xla = jax.jit(jax.vmap(lambda p: fast.solve_refined(p, opt,
                                                        ir_steps=IR_STEPS)))
    entry = jax.jit(lambda p: fast.solve_refined_pallas(p, opt))
    # solve_refined_pallas with the kernel's warp count set per run (only
    # within the kernel's size limit)
    if not gi_kernel.kernel_fits(n, m):
        warps = []
    kern = [jax.jit(lambda p, w=w: fast._refine_batch(p, gi_kernel.run_loop_pallas(
        p.with_dtype(jnp.float32), init(p.with_dtype(jnp.float32)),
        opt.max_iter, num_warps=w), IR_STEPS)) for w in warps]
    timed = interleaved([lambda: xla(pbs), lambda: entry(pbs)]
                        + [lambda k=k: k(pbs) for k in kern], reps)
    emit(dict(base, engine="xla", s=timed[0][0], reps_s=timed[0][1],
              solves_per_s=batch / timed[0][0], **quality(xla(pbs), pbs)), out)
    # the production entry point, with its own engine and warp choice
    emit(dict(base, engine="solve_refined_pallas", s=timed[1][0],
              reps_s=timed[1][1], solves_per_s=batch / timed[1][0],
              **quality(entry(pbs), pbs)), out)
    for w, k, (t, ts) in zip(warps, kern, timed[2:]):
        emit(dict(base, engine="kernel", num_warps=w, s=t, reps_s=ts,
                  solves_per_s=batch / t, **quality(k(pbs), pbs)), out)
        loop = jax.jit(lambda p, s, w=w: gi_kernel.run_loop_pallas(
            p, s, opt.max_iter, num_warps=w))
        t = median_time(lambda: loop(pb32, st0), reps)
        emit(dict(base, layer="loop_kernel", num_warps=w, s=t), out)
    if trace:
        for name, fn in (("xla", lambda: xla(pbs)),
                         ("solve_refined_pallas", lambda: entry(pbs))):
            emit(dict(base, profile=name, **device_profile(fn, 3)), out)


def phase_warm(n, m, batch, reps, out, steps=16, drift=0.02, trace=False):
    opt = SolverOptions(max_iter=100)
    base_pb = random_qp_batch(jax.random.key(0), batch, n, m, act_frac=0.4)
    drifts = drift * jax.random.normal(jax.random.key(1), (steps, batch, m),
                                       base_pb.l.dtype)

    def shifted(k):
        return dataclasses.replace(base_pb, l=base_pb.l + drifts[k],
                                   u=base_pb.u + drifts[k])

    @jax.jit
    def warm_xla_init(pbs, carry):
        # the other way: XLA carry init, then the loop kernel (no prologue)
        pb32 = pbs.with_dtype(jnp.float32)
        st0 = jax.vmap(fast._init_fast_from_carry)(
            pb32, carry.H, carry.Ns, carry.status, carry.aorder, carry.q)
        st = gi_kernel.run_loop_pallas(pb32, st0, opt.max_iter)
        return fast._refine_batch(pbs, st, IR_STEPS)

    res, carry = fast.solve_refined_pallas_carry(base_pb, None, opt)
    pbs = shifted(1)
    pb32 = pbs.with_dtype(jnp.float32)
    args = (pb32, carry.H, carry.Ns, carry.status, carry.aorder, carry.q)
    # the XLA carry init by part: the compaction and closed-form point
    # alone, then with the vmapped u < 0 deactivation loop
    point = jax.jit(jax.vmap(fast._carry_point))
    init = jax.jit(jax.vmap(fast._init_fast_from_carry))
    deact = np.asarray(init(*args).it)
    (t_cold, _), (t_warm, ts_warm), (t_warm_xla, ts_xla), (t_point, _), (
        t_init, _) = interleaved([
            lambda: fast.solve_refined_pallas(pbs, opt),
            lambda: fast.solve_refined_pallas_carry(pbs, carry, opt)[0],
            lambda: warm_xla_init(pbs, carry),
            lambda: point(*args),
            lambda: init(*args)], reps)
    if trace:
        for name, fn in (
                ("warm_prologue", lambda: fast.solve_refined_pallas_carry(
                    pbs, carry, opt)[0]),
                ("warm_xla_init", lambda: warm_xla_init(pbs, carry)),
                ("init_xla", lambda: init(*args)),
                ("init_xla_point", lambda: point(*args))):
            emit(dict(n=n, m=m, batch=batch, profile=name,
                      **device_profile(fn, 20)), out)
    its, its_xla = [], []
    for k in range(1, steps):
        its_xla.append(float(jnp.mean(
            warm_xla_init(shifted(k), carry).iterations)))
        res, carry = fast.solve_refined_pallas_carry(shifted(k), carry, opt)
        its.append(float(jnp.mean(res.iterations)))
    emit(dict(n=n, m=m, batch=batch, phase="warm_step", cold_s=t_cold,
              warm_prologue_s=t_warm, warm_prologue_reps_s=ts_warm,
              warm_xla_init_s=t_warm_xla, warm_xla_init_reps_s=ts_xla,
              init_xla_s=t_init, init_xla_point_s=t_point,
              init_xla_deactivations_mean=float(deact.mean()),
              init_xla_deactivations_max=int(deact.max()),
              warm_mean_it=statistics.mean(its),
              warm_xla_init_mean_it=statistics.mean(its_xla)), out)


def phase_structured(batch, reps, out, nb=9, s=43, mc=4):
    from jrlqp_tpu.bench.harness import ik_batch
    from jrlqp_tpu.structured.solver import (
        structured_inverse_batch,
        solve_structured_fast_batch,
    )

    sgs, scs, a, l, u = ik_batch(nb, s, mc, batch, seed=0)
    opt = SolverOptions(max_iter=200)
    init = jax.jit(lambda d, o: structured_inverse_batch(
        d.astype(jnp.float32), o.astype(jnp.float32), sgs.gtype))
    t_init = median_time(lambda: init(sgs.diag, sgs.off), reps)
    run = jax.jit(lambda sg, av, sc, lv, uv: solve_structured_fast_batch(
        sg, av, sc, lv, uv, opt=opt))
    t = median_time(lambda: run(sgs, a, scs, l, u), reps)
    emit(dict(phase="structured", nb=nb, s=s, batch=batch,
              init_xla_s=t_init, solve_s=t), out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=["dense", "warm", "structured"],
                    action="append", required=True)
    ap.add_argument("--shape", action="append", default=[],
                    help="n,m,batch for the dense phase (repeatable)")
    ap.add_argument("--warps", default="4,8,16")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--max-iter", type=int, default=150,
                    help="iteration cap of the dense phase")
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace", action="store_true",
                    help="also profile the dense and warm engines' device "
                         "time in a separate traced window")
    args = ap.parse_args()
    require_gpu()
    enable_compile_cache()
    print("# card:", gpu_name_and_power(), flush=True)
    warps = [int(w) for w in args.warps.split(",")]
    if "dense" in args.phase:
        for shp in args.shape or ["50,100,16384"]:
            n, m, b = (int(v) for v in shp.split(","))
            phase_dense(n, m, b, warps, args.reps, args.max_iter, args.out,
                        args.trace)
    if "warm" in args.phase:
        phase_warm(20, 40, 4096, args.reps, args.out, trace=args.trace)
    if "structured" in args.phase:
        phase_structured(128, args.reps, args.out)


if __name__ == "__main__":
    main()
