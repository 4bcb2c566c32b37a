"""End-to-end corpus pipeline test (ref: GoldfarbIdnaniSolverTest.cpp:221-310).

The real Maros-Meszaros QPS files are not redistributable here, so the
corpus pipeline is exercised on synthesized QPS files: random problems with
KNOWN optimal objectives (generator ground truth) are serialized with
``write_qps``, read back through the QPS readers, bucketed by padded shape,
and solved as batches -- the execution model of an accelerator corpus run
(BASELINE config 3: padded/bucketed shapes). Acceptance matches the
reference: objective within 1e-6 relative of f*, KKT at 1e-6
(ref: GoldfarbIdnaniSolverTest.cpp:304-306).
"""
import numpy as np
import pytest

from jrlqp_tpu.io import load_corpus, parse_qps, run_corpus, write_qps
from jrlqp_tpu.io.maros_meszaros import MarosMeszarosEntry, _bucket_dim
from jrlqp_tpu.io import native
from jrlqp_tpu.testing.random_problems import (
    ProblemCharacteristics,
    random_problem,
)


def _make_corpus(tmp_path, specs, seed=0):
    """Synthesize QPS files with known f*; returns the entries list."""
    rng = np.random.default_rng(seed)
    entries = []
    for i, (n, n_ineq, n_act, bounds, dbl) in enumerate(specs):
        ch = ProblemCharacteristics(
            n_var=n, n_obj=n, n_ineq=n_ineq,
            n_strong_act_ineq=n_act, bounds=bounds,
            n_strong_act_bounds=1 if bounds else 0,
            double_sided_ineq=dbl,
        )
        pb = random_problem(ch, rng)
        d = pb.to_qp_arrays()
        # ground-truth objective at the generator's known solution
        r = pb.A @ pb.x - pb.b
        fstar = 0.5 * float(r @ r)
        name = f"synth{i:02d}"
        text = write_qps(name, d["G"], d["a"], d["C"], d["l"], d["u"],
                         d["xl"], d["xu"], objcst=d["objcst"])
        (tmp_path / f"{name}.qps").write_text(text)
        entries.append(MarosMeszarosEntry(
            name=name, fstar=fstar, cond=1.0, nb_cstr=d["C"].shape[0],
            nb_var=n, nz=int(np.count_nonzero(d["C"])), qn=n, qnz=0))
    return entries


SPECS = [
    # (n_var, n_ineq, n_strong_act, bounds, double_sided)
    (5, 4, 2, False, False),
    (6, 8, 3, False, True),
    (7, 6, 2, True, False),
    (9, 10, 4, False, False),
    (11, 9, 3, True, False),
    (12, 14, 5, False, True),
    (14, 12, 4, False, False),
    (17, 15, 6, True, False),
    (20, 18, 7, False, False),
    (23, 20, 8, False, True),
    (26, 22, 8, False, False),
    (30, 25, 10, True, False),
]


def test_corpus_bucketed_end_to_end(tmp_path):
    entries = _make_corpus(tmp_path, SPECS)
    results = run_corpus(qps_dir=str(tmp_path), entries=entries,
                         bucketed=True)
    assert len(results) == len(SPECS)
    for r in results:
        assert r["status"] == "SUCCESS", r
        assert r["obj_ok"], r
        assert r["kkt_residual"] <= 1e-6, r


def test_corpus_bucketing_groups_shapes(tmp_path):
    entries = _make_corpus(tmp_path, SPECS)
    loaded, missing = load_corpus(str(tmp_path), entries)
    assert not missing and len(loaded) == len(SPECS)
    buckets = {(_bucket_dim(d.n), _bucket_dim(d.m)) for _, d in loaded}
    # the grid must actually coalesce shapes: far fewer compiles than files
    assert len(buckets) <= len(SPECS) / 2
    # grid properties: multiples of 8 below 64, powers of two above
    assert _bucket_dim(5) == 8 and _bucket_dim(63) == 64
    assert _bucket_dim(65) == 128 and _bucket_dim(500) == 512


def test_corpus_unbucketed_matches_bucketed(tmp_path):
    entries = _make_corpus(tmp_path, SPECS[:3], seed=1)
    r_b = run_corpus(qps_dir=str(tmp_path), entries=entries, bucketed=True)
    r_s = run_corpus(qps_dir=str(tmp_path), entries=entries, bucketed=False)
    for rb, rs in zip(sorted(r_b, key=lambda r: r["name"]),
                      sorted(r_s, key=lambda r: r["name"])):
        assert rb["name"] == rs["name"]
        assert rb["status"] == rs["status"] == "SUCCESS"
        # same problem, same algorithm; padding must not change the optimum
        np.testing.assert_allclose(rb["objective"], rs["objective"],
                                   rtol=1e-9, atol=1e-12)


def test_corpus_missing_files_reported(tmp_path):
    entries = _make_corpus(tmp_path, SPECS[:2], seed=2)
    ghost = MarosMeszarosEntry(name="nosuchpb", fstar=0.0, cond=1.0,
                               nb_cstr=1, nb_var=1, nz=1, qn=1, qnz=0)
    results = run_corpus(qps_dir=str(tmp_path), entries=entries + [ghost],
                         bucketed=True)
    by_name = {r["name"]: r for r in results}
    assert by_name["nosuchpb"]["status"] == "missing"
    assert by_name["synth00"]["obj_ok"]


@pytest.mark.skipif(not native.available(),
                    reason="native QPS parser not built")
def test_corpus_parsers_agree_on_synthesized_files(tmp_path):
    entries = _make_corpus(tmp_path, SPECS[:4], seed=3)
    for e in entries:
        text = (tmp_path / f"{e.name}.qps").read_text()
        dp = parse_qps(text)
        dn = native.parse_qps_native(text)
        for k in ("G", "a", "C", "l", "u", "xl", "xu"):
            np.testing.assert_array_equal(getattr(dp, k), getattr(dn, k))
        assert dp.objcst == dn.objcst


VENDORED_DIR = __import__("os").path.join(
    __import__("os").path.dirname(__file__), "data", "qps")
# Vendored from published formulations (tests/data/qps/generate_vendored.py),
# each validated against the table's independent f*. The reference's
# filtered run covers the strictly-convex members (cond <= 1e8,
# ref: GoldfarbIdnaniSolverTest.cpp:261-274); the singular-G members are
# excluded by that filter in the reference but solve (or are detected)
# here. dual1-4/dualc*/primal* have machine-generated dense data that is
# not reconstructible from their problem statements -- external-only, as
# in the reference (WITH_QPS_TESTS + QPS_DIR).
VENDORED_STRICT = ("hs21", "hs35", "hs35mod", "hs76", "qptest", "hs118",
                   "hs268", "s268")
VENDORED_SINGULAR = ("hs51", "hs52", "hs53", "genhs28", "tame",
                     "cvxqp1_s", "cvxqp2_s", "cvxqp3_s")


def _vendored_entries(names):
    from jrlqp_tpu.io.maros_meszaros import MAROS_MESZAROS
    return [e for e in MAROS_MESZAROS if e.name in names]


@pytest.mark.parametrize("engine", ["f64", "pallas_rescued"])
def test_vendored_public_problems_match_fstar(engine):
    """The strictly-convex vendored problems must hit the published f*
    from the Maros-Meszaros table at 1e-6 relative through both the
    reference-faithful f64 engine and the kernel production configuration
    (kernel + IR + f64 rescue; the Pallas interpreter on CPU)
    (ref acceptance: GoldfarbIdnaniSolverTest.cpp:304-306)."""
    entries = _vendored_entries(VENDORED_STRICT)
    assert len(entries) == len(VENDORED_STRICT)
    results = run_corpus(qps_dir=VENDORED_DIR, entries=entries,
                         bucketed=True, engine=engine,
                         interpret=engine == "pallas_rescued")
    assert len(results) == len(VENDORED_STRICT)
    for r in results:
        assert r["status"] == "SUCCESS", r
        assert r["obj_ok"], r
        assert r["kkt_residual"] <= 1e-8, r


def test_vendored_singular_problems_f64():
    """The singular-G vendored problems (cond > 1e8, skipped by the
    reference's filter): the f64 engine must either detect the
    non-SPD Hessian or solve to the published f* -- equality
    auto-activation restricts the iteration to the constraint manifold
    where the objective is strictly convex, so SUCCESS+f* is the common
    outcome; a NON_POS_HESSIAN detection (platform-dependent Cholesky of
    an exactly singular matrix) is also correct."""
    entries = _vendored_entries(VENDORED_SINGULAR)
    assert len(entries) == len(VENDORED_SINGULAR)
    results = run_corpus(qps_dir=VENDORED_DIR, entries=entries,
                         bucketed=False, engine="f64")
    for r in results:
        assert r["status"] in ("SUCCESS", "NON_POS_HESSIAN"), r
        if r["status"] == "SUCCESS":
            assert r["obj_ok"], r


LARGE_SPECS = [
    # bigger buckets + controlled conditioning (VERDICT r2 item 5):
    # (n_var, n_ineq, n_strong_act, bounds, double_sided)
    (48, 40, 16, False, False),
    (64, 50, 20, False, True),
    (96, 80, 30, False, False),
    (128, 100, 40, True, False),
]


def test_corpus_large_buckets_through_pallas(tmp_path):
    """Corpus pipeline at larger sizes (n up to 128) through the kernel
    production configuration (kernel + IR + f64 rescue of lanes whose
    refined residual misses 1e-8; the Pallas interpreter on CPU, the XLA
    loop above the kernel's size limit): bucketed batched solves must
    match f* and pass KKT at 1e-8."""
    entries = _make_corpus(tmp_path, LARGE_SPECS, seed=7)
    results = run_corpus(qps_dir=str(tmp_path), entries=entries,
                         bucketed=True, engine="pallas_rescued",
                         interpret=True)
    assert len(results) == len(LARGE_SPECS)
    for r in results:
        assert r["status"] == "SUCCESS", r
        assert r["obj_ok"], r
        assert r["kkt_residual"] <= 1e-8, r


def test_corpus_ill_conditioned_spectrum_f64(tmp_path):
    """Ill-conditioned G (controlled spectrum, cond ~ 1e6): the f64 engine
    must still match the known optimum -- the regime the corpus's high-cond
    problems exercise (the reference filters at cond <= 1e8)."""
    import jax.numpy as jnp

    from jrlqp_tpu.io.qps import parse_qps
    from jrlqp_tpu.problems import QPProblem
    from jrlqp_tpu.solver.dense import solve
    from jrlqp_tpu.testing.kkt import kkt_residual
    from jrlqp_tpu.types import SolverOptions

    rng = np.random.default_rng(11)
    n, m = 20, 15
    # G with spectrum 1e-3 .. 1e3 (cond 1e6)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.logspace(-3, 3, n)
    G = Q @ np.diag(ev) @ Q.T
    G = 0.5 * (G + G.T)
    x_star = rng.standard_normal(n)
    C = rng.standard_normal((m, n))
    cx = C @ x_star
    l = cx - rng.uniform(0.1, 1.0, m)
    u = cx + rng.uniform(0.1, 1.0, m)
    a = -(G @ x_star)           # unconstrained optimum at x_star, interior
    text = write_qps("illcond", G, a, C, l, u,
                     np.full(n, -np.inf), np.full(n, np.inf))
    d = parse_qps(text)
    pb = QPProblem(G=jnp.asarray(d.G), a=jnp.asarray(d.a),
                   C=jnp.asarray(d.C), l=jnp.asarray(d.l),
                   u=jnp.asarray(d.u), xl=jnp.asarray(d.xl),
                   xu=jnp.asarray(d.xu))
    res = solve(pb, SolverOptions(max_iter=200))
    assert int(res.status) == 0
    fstar = float(0.5 * x_star @ (G @ x_star) + a @ x_star)
    np.testing.assert_allclose(float(res.f), fstar, rtol=1e-6)
    assert float(kkt_residual(res.x, res.multipliers, pb)) <= 1e-6


def test_corpus_kernel_engine_needs_gpu_or_interpret(tmp_path):
    """The kernel engines of run_corpus never fall back to the Pallas
    interpreter: on the CPU they raise unless interpret=True is passed."""
    entries = _make_corpus(tmp_path, SPECS[:1], seed=4)
    with pytest.raises(ValueError, match="interpret=True"):
        run_corpus(qps_dir=str(tmp_path), entries=entries, bucketed=True,
                   engine="pallas")
