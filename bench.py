"""Headline benchmark: batched GI QP throughput (n=50, m=100, batch 16384).

Prints ONE JSON line: {"metric", "value", "unit", "device", "card", ...}
with the median solves/s over the timed repetitions, their quartiles, the
per-problem KKT <= 1e-8 pass rate, and mean/max iterations. Fails unless
JAX's default backend is the GPU.

The engine is the production one, ``solve_refined_pallas``: XLA init, the
Triton whole-solve loop kernel (f32, one problem per program), and batched
mixed-precision iterative refinement with float64 residuals.
``benchmarks/engines.py`` compares it with the XLA engine.

Run on the GPU: ``python bench.py [--reps 5]``.
"""
import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from jrlqp_tpu import SolverOptions  # noqa: E402
from jrlqp_tpu.bench import device_info, gpu_name_and_power, require_gpu  # noqa: E402
from jrlqp_tpu.solver.fast import solve_refined_pallas  # noqa: E402
from jrlqp_tpu.testing.batch_gen import random_qp_batch  # noqa: E402
from jrlqp_tpu.testing.kkt import kkt_residual  # noqa: E402
from jrlqp_tpu.utils.cache import enable_compile_cache  # noqa: E402

N, M, BATCH = 50, 100, 16384
IR_STEPS = 3


def batch(seed):
    return random_qp_batch(jax.random.key(seed), BATCH, N, M, act_frac=0.3,
                           dtype=jnp.float32).with_dtype(jnp.float64)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    require_gpu()
    enable_compile_cache()
    opt = SolverOptions(max_iter=150)
    run = jax.jit(lambda p: solve_refined_pallas(p, opt, ir_steps=IR_STEPS))

    pbs = jax.block_until_ready(batch(0))
    t0 = time.perf_counter()
    res = jax.block_until_ready(run(pbs))
    compile_s = time.perf_counter() - t0
    resid = jax.vmap(kkt_residual)(res.x, res.multipliers, pbs)
    ok = float(jnp.mean((resid <= 1e-8) & (res.status == 0)))
    its = np.asarray(res.iterations)

    rates = []
    for r in range(args.reps):
        pbs_r = jax.block_until_ready(batch(r + 1))
        t0 = time.perf_counter()
        jax.block_until_ready(run(pbs_r))
        rates.append(BATCH / (time.perf_counter() - t0))
    q1, med, q3 = statistics.quantiles(rates, n=4) if len(rates) > 1 else (
        rates * 3)
    print(json.dumps({
        "metric": f"GI QP solves/s (n={N}, m={M}, "
                  f"batch={BATCH}, median of {args.reps})",
        "value": med,
        "unit": "solves/s",
        "quartiles": [q1, q3],
        "kkt_pass_rate": ok,
        "mean_it": float(its.mean()),
        "max_it": int(its.max()),
        "first_call_s": compile_s,
        "device": device_info(),
        "card": gpu_name_and_power(),
    }))


if __name__ == "__main__":
    main()
