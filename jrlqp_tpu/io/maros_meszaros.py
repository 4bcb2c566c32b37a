"""Maros-Meszaros QP collection metadata and corpus runner.

The metadata table (problem name, published optimal objective f*, estimated
cond(G), sizes, nonzero counts) reproduces the reference's data table
(ref: tests/QPSProblems.h:21-161); these are published properties of the
public Maros-Meszaros collection, used to filter the corpus and to check
objective values to 1e-6 relative accuracy
(ref: tests/GoldfarbIdnaniSolverTest.cpp:261-274,304-306).

The QPS files themselves are not redistributed here; point
``JRLQP_TPU_QPS_DIR`` (or the ``qps_dir`` argument) at a local copy of the
collection to run the corpus.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Iterable, Optional

import numpy as np

__all__ = [
    "MarosMeszarosEntry",
    "MAROS_MESZAROS",
    "default_subset",
    "run_corpus",
]

Inf = math.inf


@dataclasses.dataclass(frozen=True)
class MarosMeszarosEntry:
    name: str
    fstar: float  # objective value at the optimum (published)
    cond: float  # estimated condition number of G
    nb_cstr: int
    nb_var: int
    nz: int  # nonzeros in C
    qn: int  # quadratic variables
    qnz: int  # off-diagonal lower-triangular nonzeros of G


def _e(name, fstar, cond, nb_cstr, nb_var, nz, qn, qnz):
    return MarosMeszarosEntry(name, fstar, cond, nb_cstr, nb_var, nz, qn, qnz)


# (name, f*, cond(G) est., nbCstr, nbVar, NZ, QN, QNZ) -- ref QPSProblems.h:21-161
MAROS_MESZAROS = [
    _e("aug2d", 1.6874118e+06, Inf, 10000, 20200, 40000, 19800, 0),
    _e("aug2dc", 1.8183681e+06, 1, 10000, 20200, 40000, 20200, 0),
    _e("aug2dcqp", 6.4981348e+06, 1, 10000, 20200, 40000, 20200, 0),
    _e("aug2dqp", 6.2370121e+06, Inf, 10000, 20200, 40000, 19800, 0),
    _e("aug3d", 5.5406773e+02, Inf, 1000, 3873, 6546, 2673, 0),
    _e("aug3dc", 7.7126244e+02, 1, 1000, 3873, 6546, 3873, 0),
    _e("aug3dcqp", 9.9336215e+02, 1, 1000, 3873, 6546, 3873, 0),
    _e("aug3dqp", 6.7523767e+02, Inf, 1000, 3873, 6546, 2673, 0),
    _e("boyd1", -6.1735220e+07, 1782, 18, 93261, 558985, 93261, 0),
    _e("boyd2", 2.1256767e+01, Inf, 186531, 93263, 423784, 2, 0),
    _e("cont-050", -4.5638509e+00, 2, 2401, 2597, 12005, 2597, 0),
    _e("cont-100", -4.6443979e+00, 1, 9801, 10197, 49005, 10197, 0),
    _e("cont-101", 1.9552733e-01, Inf, 10098, 10197, 49599, 2700, 0),
    _e("cont-200", -4.6848759e+00, 2, 39601, 40397, 198005, 40397, 0),
    _e("cont-201", 1.9248337e-01, Inf, 40198, 40397, 199199, 10400, 0),
    _e("cont-300", 1.9151232e-01, Inf, 90298, 90597, 448799, 23100, 0),
    _e("cvxqp1_l", 1.0870480e+08, Inf, 5000, 10000, 14998, 10000, 29984),
    _e("cvxqp1_m", 1.0875116e+06, 7.9548418e+17, 500, 1000, 1498, 1000, 2984),
    _e("cvxqp1_s", 1.1590718e+04, 1.3398455e+17, 50, 100, 148, 100, 286),
    _e("cvxqp2_l", 8.1842458e+07, Inf, 2500, 10000, 7499, 10000, 29984),
    _e("cvxqp2_m", 8.2015543e+05, 7.9548418e+17, 250, 1000, 749, 1000, 2984),
    _e("cvxqp2_s", 8.1209405e+03, 1.3398455e+17, 25, 100, 74, 100, 286),
    _e("cvxqp3_l", 1.1571110e+08, Inf, 7500, 10000, 22497, 10000, 29984),
    _e("cvxqp3_m", 1.3628287e+06, 7.9548418e+17, 750, 1000, 2247, 1000, 2984),
    _e("dpklo1", 3.7009622e-01, Inf, 77, 133, 1575, 77, 0),
    _e("dtoc3", 2.3526248e+02, Inf, 9998, 14999, 34993, 14997, 0),
    _e("dual1", 3.5012966e-02, 8604.2029, 1, 85, 85, 85, 3473),
    _e("dual2", 3.3733676e-02, 2865.7763, 1, 96, 96, 96, 4412),
    _e("dual3", 1.3575584e-01, 987.4926, 1, 111, 111, 111, 5997),
    _e("dual4", 7.4609084e-01, 103.0244, 1, 75, 75, 75, 2724),
    _e("dualc1", 6.1552508e+03, 1107045.8821, 215, 9, 1935, 9, 36),
    _e("dualc2", 3.5513077e+03, 5.0415126e+17, 229, 7, 1603, 7, 21),
    _e("dualc5", 4.2723233e+02, 1744.856, 278, 8, 2224, 8, 28),
    _e("dualc8", 1.8309359e+04, 1.0107421e+17, 503, 8, 4024, 8, 28),
    _e("cvxqp3_s", 1.1943432e+04, 1.3398455e+17, 75, 100, 222, 100, 286),
    _e("exdata", -1.4184343e+02, Inf, 3001, 3000, 7500, 1500, 1124250),
    _e("genhs28", 9.2717369e-01, 3.0394937e+16, 8, 10, 24, 10, 9),
    _e("gouldqp2", 1.8427534e-04, Inf, 349, 699, 1047, 349, 348),
    _e("gouldqp3", 2.0627840e+00, 2.9462113e+16, 349, 699, 1047, 698, 697),
    _e("hs118", 6.6482045e+02, 1.5, 17, 15, 39, 15, 0),
    _e("hs21", -9.9960000e+01, 100, 1, 2, 2, 2, 0),
    _e("hs268", 5.7310705e-07, 1176920.3779, 5, 5, 25, 5, 10),
    _e("hs35", 1.1111111e-01, 16.3937, 1, 3, 3, 3, 2),
    _e("hs35mod", 2.5000000e-01, 16.3937, 1, 3, 3, 3, 2),
    _e("hs51", 8.8817842e-16, 2.3486094e+16, 3, 5, 7, 5, 2),
    _e("hs52", 5.3266476e+00, 6.6637185e+16, 3, 5, 7, 5, 2),
    _e("hs53", 4.0930233e+00, 2.3486094e+16, 3, 5, 7, 5, 2),
    _e("hs76", -4.6818182e+00, 16.3937, 3, 4, 10, 4, 2),
    _e("hues-mod", 3.4824690e+07, 1, 2, 10000, 19899, 10000, 0),
    _e("huestis", 3.4824690e+11, 1, 2, 10000, 19899, 10000, 0),
    _e("ksip", 5.7579794e-01, 20, 1001, 20, 18411, 20, 0),
    _e("laser", 2.4096014e+06, 9.4835780e+10, 1000, 1002, 3000, 1002, 3000),
    _e("liswet1", 3.6122402e+01, 1, 10000, 10002, 30000, 10002, 0),
    _e("liswet10", 4.9485785e+01, 1, 10000, 10002, 30000, 10002, 0),
    _e("liswet11", 4.9523957e+01, 1, 10000, 10002, 30000, 10002, 0),
    _e("liswet12", 1.7369274e+03, 1, 10000, 10002, 30000, 10002, 0),
    _e("liswet2", 2.4998076e+01, 1, 10000, 10002, 30000, 10002, 0),
    _e("liswet3", 2.5001220e+01, 1, 10000, 10002, 30000, 10002, 0),
    _e("liswet4", 2.5000112e+01, 1, 10000, 10002, 30000, 10002, 0),
    _e("liswet5", 2.5034253e+01, 1, 10000, 10002, 30000, 10002, 0),
    _e("liswet6", 2.4995748e+01, 1, 10000, 10002, 30000, 10002, 0),
    _e("liswet7", 4.9884089e+02, 1, 10000, 10002, 30000, 10002, 0),
    _e("liswet8", 7.1447006e+03, 1, 10000, 10002, 30000, 10002, 0),
    _e("liswet9", 1.9632513e+03, 1, 10000, 10002, 30000, 10002, 0),
    _e("lotschd", 2.3984159e+03, Inf, 7, 12, 54, 6, 0),
    _e("mosarqp1", -9.5287544e+02, 3.6673, 700, 2500, 3422, 2500, 45),
    _e("mosarqp2", -1.5974821e+03, 20.0855, 600, 900, 2930, 900, 45),
    _e("powell20", 5.2089583e+10, 1, 10000, 10000, 20000, 10000, 0),
    _e("primal1", -3.5012965e-02, Inf, 85, 325, 5815, 324, 0),
    _e("primal2", -3.3733676e-02, Inf, 96, 649, 8042, 648, 0),
    _e("primal3", -1.3575584e-01, Inf, 111, 745, 21547, 744, 0),
    _e("primal4", -7.4609083e-01, Inf, 75, 1489, 16031, 1488, 0),
    _e("primalc1", -6.1552508e+03, Inf, 9, 230, 2070, 229, 0),
    _e("primalc2", -3.5513077e+03, Inf, 7, 231, 1617, 230, 0),
    _e("primalc5", -4.2723233e+02, Inf, 8, 287, 2296, 286, 0),
    _e("primalc8", -1.8309430e+04, Inf, 8, 520, 4160, 519, 0),
    _e("q25fv47", 1.3744448e+07, Inf, 820, 1571, 10400, 446, 59053),
    _e("qadlittl", 4.8031886e+05, Inf, 56, 97, 383, 17, 70),
    _e("qafiro", -1.5907818e+00, Inf, 27, 32, 83, 3, 3),
    _e("qbandm", 1.6352342e+04, Inf, 305, 472, 2494, 25, 16),
    _e("qbeaconf", 1.6471206e+05, Inf, 173, 262, 3375, 18, 9),
    _e("qbore3d", 3.1002008e+03, Inf, 233, 315, 1429, 28, 50),
    _e("qbrandy", 2.8375115e+04, Inf, 220, 249, 2148, 16, 49),
    _e("qcapri", 6.6793293e+07, 1.1686697e+11, 271, 353, 1767, 56, 838),
    _e("qe226", 2.1265343e+02, Inf, 223, 282, 2578, 67, 897),
    _e("qetamacr", 8.6760370e+04, Inf, 400, 688, 2409, 378, 4069),
    _e("qfffff80", 8.7314747e+05, Inf, 524, 854, 6227, 278, 1638),
    _e("qforplan", 7.4566315e+09, Inf, 161, 421, 4563, 36, 546),
    _e("qgfrdxpn", 1.0079059e+11, Inf, 616, 1092, 2377, 54, 108),
    _e("qgrow15", -1.0169364e+08, Inf, 300, 645, 5620, 38, 462),
    _e("qgrow22", -1.4962895e+08, Inf, 440, 946, 8252, 65, 787),
    _e("qgrow7", -4.2798714e+07, Inf, 140, 301, 2612, 30, 327),
    _e("qisrael", 2.5347838e+07, Inf, 174, 142, 2269, 42, 656),
    _e("qpcblend", -7.8425409e-03, 10, 74, 83, 491, 83, 0),
    _e("qpcboei1", 1.1503914e+07, 10, 351, 384, 3485, 384, 0),
    _e("qpcboei2", 8.1719623e+06, 10, 166, 143, 1196, 143, 0),
    _e("qpcstair", 6.2043875e+06, 10, 356, 467, 3856, 467, 0),
    _e("qpilotno", 4.7285869e+06, Inf, 975, 2172, 13057, 94, 391),
    _e("qptest", 4.3718750e+00, 1.6612, 2, 2, 4, 2, 1),
    _e("qrecipe", -2.6661600e+02, Inf, 91, 180, 663, 20, 30),
    _e("qsc205", -5.8139518e-03, Inf, 205, 203, 551, 11, 10),
    _e("qscagr25", 2.0173794e+08, Inf, 471, 500, 1554, 28, 100),
    _e("qscagr7", 2.6865949e+07, Inf, 129, 140, 420, 8, 17),
    _e("qscfxm1", 1.6882692e+07, Inf, 330, 457, 2589, 56, 677),
    _e("qscfxm2", 2.7776162e+07, Inf, 660, 914, 5183, 74, 1057),
    _e("qscfxm3", 3.0816355e+07, Inf, 990, 1371, 7777, 89, 1132),
    _e("qscorpio", 1.8805096e+03, Inf, 388, 358, 1426, 22, 18),
    _e("qscrs8", 9.0456001e+02, Inf, 490, 1169, 3182, 33, 88),
    _e("qscsd1", 8.6666667e+00, Inf, 77, 760, 2388, 54, 691),
    _e("qscsd6", 5.0808214e+01, Inf, 147, 1350, 4316, 96, 1308),
    _e("qscsd8", 9.4076357e+02, Inf, 397, 2750, 8584, 140, 2370),
    _e("qsctap1", 1.4158611e+03, Inf, 300, 480, 1692, 36, 117),
    _e("qsctap2", 1.7350265e+03, Inf, 1090, 1880, 6714, 141, 636),
    _e("qsctap3", 1.4387547e+03, Inf, 1480, 2480, 8874, 186, 861),
    _e("qseba", 8.1481801e+07, Inf, 515, 1028, 4352, 96, 550),
    _e("qshare1b", 7.2007832e+05, Inf, 117, 225, 1151, 18, 21),
    _e("qshare2b", 1.1703692e+04, Inf, 96, 79, 694, 10, 45),
    _e("qshell", 1.5726368e+12, Inf, 536, 1775, 3556, 405, 34385),
    _e("qship04l", 2.4200155e+06, Inf, 402, 2118, 6332, 14, 42),
    _e("qship04s", 2.4249937e+06, Inf, 402, 1458, 4352, 14, 42),
    _e("qship08l", 2.3760406e+06, Inf, 778, 4283, 12802, 940, 34025),
    _e("qship08s", 2.3857289e+06, Inf, 778, 2387, 7114, 538, 11139),
    _e("qship12l", 3.0188766e+06, Inf, 1151, 5427, 16170, 2023, 60205),
    _e("qship12s", 3.0569623e+06, Inf, 1151, 2763, 8178, 1042, 16361),
    _e("qsierra", 2.3750458e+07, Inf, 1227, 2036, 7302, 122, 61),
    _e("qstair", 7.9854528e+06, Inf, 356, 467, 3856, 66, 952),
    _e("qstandat", 6.4118384e+03, Inf, 359, 1075, 3031, 138, 666),
    _e("s268", 5.7310705e-07, 1176920.3779, 5, 5, 25, 5, 10),
    _e("stadat1", -2.8526864e+07, Inf, 3999, 2001, 9997, 2000, 0),
    _e("stadat2", -3.2626665e+01, Inf, 3999, 2001, 9997, 2000, 0),
    _e("stadat3", -3.5779453e+01, Inf, 7999, 4001, 19997, 4000, 0),
    _e("stcqp1", 1.5514356e+05, 831.5172, 2052, 4097, 13338, 4097, 22506),
    _e("stcqp2", 2.2327313e+04, 1090.1896, 2052, 4097, 13338, 4097, 22506),
    _e("tame", 0.0000000e+00, 1.1568581e+17, 1, 2, 2, 2, 1),
    _e("ubh1", 1.1160008e+00, Inf, 12000, 18009, 48000, 6003, 0),
    _e("values", -1.3966211e+00, 409752866.825, 1, 202, 202, 202, 3620),
    _e("yao", 1.9770426e+02, 1, 2000, 2002, 6000, 2002, 0),
    _e("zecevic2", -4.1250000e+00, Inf, 2, 2, 4, 1, 0),
]

# reference per-solver exclusions: 1e-13-level tie-breaking in constraint
# selection makes these fragile (ref: GoldfarbIdnaniSolverTest.cpp:233-247)
DEFAULT_EXCLUSIONS = ("qforplan", "qpcboei1", "qpcboei2")


def default_subset(
    max_cond: float = 1e8,
    max_var: int = 500,
    max_cstr: int = 1000,
    exclusions: Iterable[str] = DEFAULT_EXCLUSIONS,
) -> list[MarosMeszarosEntry]:
    """The reference's corpus filter
    (ref: GoldfarbIdnaniSolverTest.cpp:261-274): strictly-convex (finite
    cond), small enough, not excluded."""
    excl = set(exclusions)
    return [
        e
        for e in MAROS_MESZAROS
        if e.cond <= max_cond and e.nb_var <= max_var and e.nb_cstr <= max_cstr
        and e.name not in excl
    ]


def load_corpus(
    qps_dir: str,
    entries: list[MarosMeszarosEntry],
    parser_engine: str = "auto",
):
    """Parse the available corpus files.

    Returns ``(loaded, missing)`` where ``loaded`` is a list of
    ``(entry, QPSData)`` and ``missing`` the entries with no file under
    ``qps_dir`` (``<NAME>.QPS`` / ``.qps`` / ``.SIF``)."""
    from .qps import read_qps

    loaded, missing = [], []
    for e in entries:
        path = None
        for cand in (f"{e.name}.QPS", f"{e.name}.qps", f"{e.name.upper()}.QPS",
                     f"{e.name}.SIF", f"{e.name.upper()}.SIF"):
            p = os.path.join(qps_dir, cand)
            if os.path.exists(p):
                path = p
                break
        if path is None:
            missing.append(e)
            continue
        loaded.append((e, read_qps(path, engine=parser_engine)))
    return loaded, missing


def _bucket_dim(x: int, lo: int = 8) -> int:
    """Round a size up to the bucket grid: multiples of 8 up to 64, then
    powers of two. Keeps pad waste <= ~2x while bounding the number of
    compiled shapes (BASELINE config 3: padded/bucketed shapes)."""
    x = max(x, lo)
    if x <= 64:
        return -(-x // 8) * 8
    return 1 << (x - 1).bit_length()


def run_corpus(
    qps_dir: Optional[str] = None,
    entries: Optional[list[MarosMeszarosEntry]] = None,
    rel_tol: float = 1e-6,
    max_iter: int = 2000,
    bucketed: bool = True,
    engine: str = "f64",
    parser_engine: str = "auto",
    ir_steps: int = 4,
    interpret: bool = False,
):
    """Solve the filtered corpus, checking objective vs f* and KKT
    (ref: GoldfarbIdnaniSolverTest.cpp:221-310). Returns a list of dicts.

    Requires a local copy of the collection (``<qps_dir>/<NAME>.QPS`` or
    ``.SIF``/``.qps``). Problems whose file is missing are reported with
    status "missing".

    ``bucketed=True`` (the batched execution model, BASELINE config 3) groups
    problems by padded shape buckets (:func:`_bucket_dim` grid), pads each
    bucket to a common (n, m), and solves each bucket as ONE batched call
    -- one compile per bucket shape instead of one per problem.
    ``engine``: "f64" = reference-faithful J/R loop (robust, right for the
    corpus's wide conditioning range); "refined" = f32 loop + f64-residual
    refinement; "pallas" = the whole-solve loop kernel + refinement (the
    throughput path; GPU only unless ``interpret=True``, see
    :func:`jrlqp_tpu.solver.fast.solve_refined_pallas`); "pallas_rescued" =
    same plus the f64 re-solve of lanes whose refined KKT residual misses
    1e-8 (host-orchestrated).
    """
    import jax
    import jax.numpy as jnp

    from ..problems import QPProblem, stack_problems
    from ..solver.dense import solve, solve_batch
    from ..solver.fast import solve_refined
    from ..testing.kkt import kkt_residual
    from ..types import SolverOptions, TerminationStatus
    qps_dir = qps_dir or os.environ.get("JRLQP_TPU_QPS_DIR")
    if qps_dir is None:
        raise ValueError("no QPS directory given (set JRLQP_TPU_QPS_DIR)")
    if entries is None:
        entries = default_subset()

    loaded, missing = load_corpus(qps_dir, entries, parser_engine)
    results = [dict(name=e.name, status="missing") for e in missing]
    opt = SolverOptions(max_iter=max_iter)

    def to_pb(data):
        return QPProblem(
            G=jnp.asarray(data.G), a=jnp.asarray(data.a),
            C=jnp.asarray(data.C), l=jnp.asarray(data.l),
            u=jnp.asarray(data.u), xl=jnp.asarray(data.xl),
            xu=jnp.asarray(data.xu), objcst=jnp.asarray(data.objcst),
        )

    def record(e, data, pb, res):
        obj = float(res.f) + float(data.objcst)
        ok_obj = abs(obj - e.fstar) <= rel_tol * max(1.0, abs(e.fstar))
        resid = float(kkt_residual(res.x, res.multipliers, pb))
        results.append(dict(
            name=e.name,
            status=TerminationStatus(int(res.status)).name,
            objective=obj,
            fstar=e.fstar,
            obj_ok=bool(ok_obj),
            kkt_residual=resid,
            iterations=int(res.iterations),
        ))

    if not bucketed:
        for e, data in loaded:
            pb = to_pb(data)
            record(e, data, pb, solve(pb, opt))
        return results

    # shape-bucketed batched execution
    buckets: dict[tuple[int, int], list] = {}
    for e, data in loaded:
        key = (_bucket_dim(data.n), _bucket_dim(data.m))
        buckets.setdefault(key, []).append((e, data))
    for (n_pad, m_pad), items in sorted(buckets.items()):
        pbs = stack_problems([to_pb(d) for _, d in items], n_pad, m_pad)
        if engine == "refined":
            batch_res = jax.jit(jax.vmap(
                lambda p: solve_refined(p, opt, ir_steps=ir_steps)))(pbs)
        elif engine in ("pallas", "pallas_rescued"):
            from ..solver.fast import (
                solve_refined_pallas,
                solve_refined_pallas_rescued,
            )

            if engine == "pallas_rescued":
                batch_res = solve_refined_pallas_rescued(
                    pbs, opt, ir_steps=ir_steps, interpret=interpret)
            else:
                batch_res = solve_refined_pallas(pbs, opt, ir_steps=ir_steps,
                                                 interpret=interpret)
        else:
            batch_res = solve_batch(pbs, opt)
        for i, (e, data) in enumerate(items):
            res_i = jax.tree.map(lambda x: x[i], batch_res)
            pb_i = jax.tree.map(lambda x: x[i], pbs)
            record(e, data, pb_i, res_i)
    return results
