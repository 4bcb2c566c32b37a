"""Independent-solver timing comparison.

The reference benchmarks against LSSOL / QLD / eigen-quadprog / eiquadprog
(ref: benchmarks/problemAdaptors.h:10-65); none of those (nor OSQP /
quadprog / qpsolvers / cvxpy) is installable in this image. The only
independent optimizer available is scipy.optimize (SLSQP) -- a general
sequential-least-squares NLP method, NOT a tuned dense QP code -- so this
capture times it on the same random strictly-convex QPs as the headline
bench, on the host CPU, purely as an order-of-magnitude anchor. Solutions
are cross-checked against the library's f64 engine. Prints one JSON row
and writes it to the path given as the first argument, if any.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
from scipy import optimize  # noqa: E402

from jrlqp_tpu import SolverOptions, solve  # noqa: E402
from jrlqp_tpu.testing.batch_gen import random_qp_batch  # noqa: E402
from jrlqp_tpu.utils.cache import enable_compile_cache  # noqa: E402

N, M = 50, 100
COUNT = int(os.environ.get("COMP_COUNT", "16"))


def main():
    enable_compile_cache()
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    pbs = random_qp_batch(jax.random.key(0), COUNT, N, M, act_frac=0.3)
    G = np.asarray(pbs.G)
    a = np.asarray(pbs.a)
    C = np.asarray(pbs.C)
    l = np.asarray(pbs.l)
    u = np.asarray(pbs.u)

    times = []
    max_obj_diff = 0.0
    n_ok = 0
    opt = SolverOptions(max_iter=500)
    for i in range(COUNT):
        Gi, ai, Ci, li, ui = G[i], a[i], C[i], l[i], u[i]

        def f(x, Gi=Gi, ai=ai):
            return 0.5 * x @ Gi @ x + ai @ x

        def fgrad(x, Gi=Gi, ai=ai):
            return Gi @ x + ai

        cons = [
            dict(type="ineq", fun=lambda x, Ci=Ci, li=li: Ci @ x - li,
                 jac=lambda x, Ci=Ci: Ci),
            dict(type="ineq", fun=lambda x, Ci=Ci, ui=ui: ui - Ci @ x,
                 jac=lambda x, Ci=Ci: -Ci),
        ]
        t0 = time.perf_counter()
        r = optimize.minimize(f, np.zeros(N), jac=fgrad, method="SLSQP",
                              constraints=cons,
                              options=dict(maxiter=500, ftol=1e-10))
        times.append(time.perf_counter() - t0)
        pb_i = jax.tree.map(lambda x: x[i], pbs)
        ours = solve(pb_i, opt)
        f_ours = float(ours.f)
        if r.success:
            n_ok += 1
            max_obj_diff = max(max_obj_diff,
                               abs(r.fun - f_ours) / max(1.0, abs(f_ours)))

    out = dict(
        name=f"competitor/scipy_slsqp/n={N}/m={M}",
        count=COUNT,
        scipy_slsqp_us_per_solve=float(np.mean(times) * 1e6),
        scipy_success=n_ok / COUNT,
        max_rel_obj_diff_vs_f64_engine=max_obj_diff,
        note=("scipy SLSQP is a general NLP method on the host CPU, not a "
              "tuned QP code; the reference's competitor set "
              "(LSSOL/QLD/eigen-quadprog/eiquadprog) and common QP packages "
              "(OSQP/quadprog/qpsolvers/cvxpy) are not installed, so this "
              "row is an order-of-magnitude anchor only."),
    )
    print(json.dumps(out))
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as fh:
            json.dump(out, fh, indent=2)


if __name__ == "__main__":
    main()
