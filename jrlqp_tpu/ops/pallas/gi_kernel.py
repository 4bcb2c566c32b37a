"""Pallas (Triton) whole-solve kernel for the explicit-form GI loop (float32).

The vmapped XLA loop (:func:`jrlqp_tpu.solver.fast.solve_refined`) reads the
operators H and N* and the constraint matrix C from device memory on every
iteration, writes the rank-one updates back, and runs every lane until the
slowest lane of the batch is done. This kernel runs the ENTIRE active-set
loop for one problem per program: G, C and the operators are read once per
solve, the operators stay in registers across iterations, and each program
stops when its own problem is done.

Layout (Triton wants power-of-two block shapes):
- one problem per program; ``np_`` = next power of two >= n+1 (the extra
  slot holds a pending candidate at a full-rank vertex), ``mp_`` = next
  power of two >= m; padded rows/lanes carry zeros and +-BIG bounds;
- H is (np_, np_) and N* is stored transposed, ``NsT`` (np_, np_), so the
  k-th active row of N* is COLUMN k: the directions z = H n+ and
  r = N* n+ are both column sums of a broadcast multiply, and both
  rank-one updates are outer products of a row vector with a lane vector;
- matrix-vector products are broadcast multiplies plus ``jnp.sum`` (no
  ``pl.dot``: Triton's dot needs operands >= 16 per dimension and would
  compute f32 in TF32);
- the constraint index space is remapped so padded general-constraint slots
  sit between the real constraints (0..m-1) and the bounds (mp_..mp_+n-1);
  statuses are carried as two vectors (general, bounds);
- active-set slots form a HOLE-BASED free list instead of the reference's
  compact activation order (ref ActiveSet erases by position and shifts,
  src/internal/ActiveSet.cpp:132-168): a slot is active iff its carried
  per-slot status ``sk`` is nonzero; an add writes the first free slot
  (pinned per candidate in ``sc_slot``); a removal zeroes the slot's N*
  column, status, activation index and multiplier. Outputs may therefore
  carry holes; consumers mask validity with ``aorder >= 0``;
- ``lax.cond`` keeps only one of {stop, add, remove} operator updates on the
  executed path (one problem per program: no divergence), and the
  violated-constraint scan is skipped after a removal (the reference's
  skipStep1, DualSolver.cpp:103-111).

The init (Cholesky, H0 = G^-1, x0 = -G^-1 a, equality auto-activation, or a
warm start) runs outside the kernel as batched XLA ops; the kernel takes
any such state, including one with holes.

Under jax_enable_x64 bare Python ints trace as 64-bit; every scalar and
index below is pinned to int32/float32.

Reproduces :func:`jrlqp_tpu.solver.fast.fast_iteration` (differential-tested
in interpret mode on CPU and against the XLA path on the GPU).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...problems import QPProblem
from ...types import (
    EQUALITY,
    FIXED,
    INFEASIBLE,
    LINEAR_DEPENDENCY_DETECTED,
    LOWER,
    LOWER_BOUND,
    MAX_ITER_REACHED,
    RUNNING,
    SUCCESS,
    UPPER,
    UPPER_BOUND,
)

__all__ = ["run_loop_pallas", "kernel_fits", "padded_dims", "MAX_NP"]

BIG = 1e30  # f32 infinity proxy inside the kernel

# Largest padded variable dimension the kernel takes (n <= 127). On an H100
# 80GB HBM3 (400 W limit), end to end with refinement and at iteration caps
# that every lane converges under, the kernel engine is 2.9x faster than the
# XLA engine at n=50 (64-wide blocks) and 1.17x faster at n=100 (128-wide
# blocks, batch 4096, 8 warps); above the limit the engines route to the XLA
# loop (see solver.fast._use_kernel and PERF.md).
MAX_NP = 128


def default_warps(np_: int) -> int:
    """Warps per program for ``np_``-wide blocks, as measured fastest on the
    same card: 4 at 64 wide (2 warps: 2.0x slower, 8: 1.3x, 16: 2.4x), 8 at
    128 wide (4 warps: 2.7x slower; PERF.md)."""
    return 4 if np_ <= 64 else 8


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def padded_dims(n: int, m: int) -> tuple[int, int]:
    """Kernel block sizes (np_, mp_) for an (n, m) problem."""
    return max(_pow2(n + 1), 8), max(_pow2(m), 8)


def kernel_fits(n: int, m: int) -> bool:
    """Whether an (n, m) problem is within the kernel's size limit."""
    return padded_dims(n, m)[0] <= MAX_NP


def _kernel(*refs, n, m, np_, mp_, max_iter, warm):
    (G_ref, C_ref, lo_ref, up_ref, xlo_ref, xup_ref, H0_ref, N0_ref, x0_ref,
     u0_ref, stc0_ref, stb0_ref, ao0_ref, sk0_ref, scal0_ref,
     hs_ref) = refs[:16]
    (x_out, u_out, stc_out, stb_out, ao_out, scal_out, H_out,
     N_out) = refs[-8:]
    f32, i32 = jnp.float32, jnp.int32
    lax = jax.lax
    iot_n = lax.broadcasted_iota(i32, (np_,), 0)
    iot_m = lax.broadcasted_iota(i32, (mp_,), 0)
    iot8 = lax.broadcasted_iota(i32, (8,), 0)
    row_n = lax.broadcasted_iota(i32, (np_, np_), 1)   # lane index of (np_, np_)
    row_m = lax.broadcasted_iota(i32, (mp_, np_), 0)   # row index of (mp_, np_)
    real_m = iot_m < i32(m)
    real_n = iot_n < i32(n)
    lo, up = lo_ref[...], up_ref[...]
    xlo, xup = xlo_ref[...], xup_ref[...]

    def isum(v):
        return jnp.sum(v, dtype=i32)

    def pick(v, mask):
        """v[k] for the single lane where mask holds (0 elsewhere)."""
        if v.dtype == i32:
            return isum(jnp.where(mask, v, i32(0)))
        return jnp.sum(jnp.where(mask, v, f32(0.0)))

    def argmin(v):
        return lax.argmin(v, 0, i32)

    scal0 = scal0_ref[...]
    # the INIT-time trace(H0) = trace(G^-1) is the scale reference of the
    # dependence and zero-z thresholds (see fast._dep_eps); a resumed state
    # keeps its original scale instead of the evolved H's smaller trace
    tr0 = jnp.maximum(pick(hs_ref[...], iot8 == 0), f32(1e-30))
    dep_thr = f32(2e-7) * tr0
    zs = f32(1e-6) * tr0 * f32(1.0 / n)

    def remove_op(H, NsT, lpos, valid):
        """Rank-one remove update of slot ``lpos`` (fast._apply_remove)."""
        lmask = row_n == lpos
        nl = jnp.sum(jnp.where(lmask, NsT, f32(0.0)), axis=1)       # N*[l]
        G = G_ref[...]
        v = jnp.sum(G * nl[None, :], axis=1)                        # G n_l*
        w = jnp.sum(v[:, None] * NsT, axis=0)                       # N* v
        wl = pick(w, iot_n == lpos)
        wl_safe = jnp.where(jnp.abs(wl) > f32(0.0), wl, f32(1.0))
        wmask = jnp.where(valid & (iot_n != lpos), w, f32(0.0))
        H2 = H + nl[:, None] * (nl / wl_safe)[None, :]
        N2 = NsT - nl[:, None] * (wmask / wl_safe)[None, :]
        # hole-based slots: just zero the freed N* column
        return H2, jnp.where(lmask, f32(0.0), N2)

    def remove_status(stc, stb, ao, sk, lpos):
        """Free slot ``lpos``: its constraint becomes inactive."""
        rem_idx = pick(ao, iot_n == lpos)
        return (jnp.where(iot_m == rem_idx, i32(0), stc),
                jnp.where(iot_n == rem_idx - i32(mp_), i32(0), stb),
                jnp.where(iot_n == lpos, i32(-1), ao),
                jnp.where(iot_n == lpos, i32(0), sk))

    def body(carry):
        (x, H, NsT, uvec, stc, stb, ao, sk, nplus, q, it, term, skip1,
         sc_idx, sc_st, sc_slot) = carry
        valid = sk != i32(0)

        # ---- step 1: most-violated constraint (skipped after a removal) --
        C = C_ref[...]
        cx = jnp.sum(C * x[None, :], axis=1)                    # (mp_,)
        sl, su = cx - lo, up - cx
        cand_c = jnp.where((stc != i32(0)) | ~real_m, f32(BIG),
                           jnp.minimum(sl, su))
        st_c = jnp.where(sl <= su, i32(LOWER), i32(UPPER))
        slb, sub = x - xlo, xup - x
        cand_b = jnp.where((stb != i32(0)) | ~real_n, f32(BIG),
                           jnp.minimum(slb, sub))
        st_b = jnp.where(slb <= sub, i32(LOWER_BOUND), i32(UPPER_BOUND))
        pc, pb = argmin(cand_c), argmin(cand_b)
        vc, vb = jnp.min(cand_c), jnp.min(cand_b)
        gen = vc <= vb           # ties go to the lower (general) index
        viol = jnp.minimum(vc, vb)
        p = jnp.where(gen, pc, i32(mp_) + pb)
        sel_st = jnp.where(gen, pick(st_c, iot_m == pc),
                           pick(st_b, iot_n == pb))
        do_select = skip1 == i32(0)
        success = do_select & (viol >= f32(0.0))
        sc_idx_n = jnp.where(do_select, p, sc_idx)
        sc_st_n = jnp.where(do_select, sel_st, sc_st)
        # candidate slot: first FREE slot, pinned for the candidate's
        # lifetime (its multiplier accumulates there across partial steps)
        free = argmin(valid.astype(i32))
        sc_slot_n = jnp.where(do_select, free, sc_slot)
        upperish = (sc_st_n == i32(UPPER)) | (sc_st_n == i32(UPPER_BOUND))
        sign = jnp.where(upperish, f32(-1.0), f32(1.0))
        is_bnd = sc_st_n >= i32(LOWER_BOUND)
        crow = jnp.sum(jnp.where(row_m == sc_idx_n, C, f32(0.0)), axis=0)
        e = (iot_n == sc_idx_n - i32(mp_)).astype(f32)
        nplus_n = jnp.where(do_select, sign * jnp.where(is_bnd, e, crow),
                            nplus)

        # ---- directions: z = H n+ (H symmetric), r = N* n+ ----
        z = jnp.sum(nplus_n[:, None] * H, axis=0)
        r = jnp.sum(nplus_n[:, None] * NsT, axis=0)

        # ---- step lengths ----
        eligible = (valid & (sk != i32(EQUALITY)) & (sk != i32(FIXED))
                    & (r > f32(0.0)))
        tks = jnp.where(eligible, uvec / jnp.where(eligible, r, f32(1.0)),
                        f32(BIG))
        lpos = argmin(tks)
        t1 = jnp.minimum(jnp.min(tks), f32(BIG))

        znorm2 = jnp.sum(z * z)
        nz = jnp.sum(nplus_n * z)
        nx = jnp.sum(nplus_n * x)
        nn = jnp.sum(nplus_n * nplus_n)
        b_gen = pick(jnp.where(sc_st_n == i32(UPPER), up, lo),
                     iot_m == sc_idx_n)
        b_bnd = pick(jnp.where(sc_st_n == i32(UPPER_BOUND), xup, xlo),
                     iot_n == sc_idx_n - i32(mp_))
        b = jnp.where(is_bnd, b_bnd, b_gen)
        nz_safe = jnp.where(nz != f32(0.0), nz, f32(1.0))
        # scale-aware zero-z test (see fast.fast_iteration)
        t2 = jnp.where(znorm2 > zs * zs * nn, (sign * b - nx) / nz_safe,
                       f32(BIG))
        t = jnp.minimum(t1, t2)

        infeasible = (t >= f32(BIG)) & ~success
        dual_step = (t2 >= f32(BIG)) & ~infeasible
        full_step = ~infeasible & ~dual_step & (t2 <= t1)
        stop = success | infeasible
        add_sel = ~stop & full_step
        rem_sel = ~stop & ~full_step
        t_safe = jnp.where(stop, f32(0.0), t)

        r_head = jnp.where(valid, r, f32(0.0))
        u_stepped = uvec - t_safe * r_head
        u_stepped = jnp.where(iot_n == sc_slot_n, u_stepped + t_safe,
                              u_stepped)
        x_new = jnp.where(dual_step, x, x + t_safe * z)

        dependent = nz <= dep_thr * nn
        dsafe = jnp.where(dependent, f32(1.0), nz)

        # ---- operator update: one of keep / add / remove ----
        def keep(H, NsT):
            return H, NsT

        def add(H, NsT):
            zn = z / dsafe
            H2 = H - z[:, None] * zn[None, :]
            N2 = NsT - z[:, None] * (r_head / dsafe)[None, :]
            # the new N* row is column sc_slot of NsT
            return H2, jnp.where(row_n == sc_slot_n, zn[:, None], N2)

        def remove(H, NsT):
            return remove_op(H, NsT, lpos, valid)

        H_n, NsT_n = lax.cond(
            stop, keep,
            lambda H, NsT: lax.cond(full_step, add, remove, H, NsT),
            H, NsT)

        # ---- bookkeeping (cheap vector selects) ----
        stc_add = jnp.where(iot_m == sc_idx_n, sc_st_n, stc)
        stb_add = jnp.where(iot_n == sc_idx_n - i32(mp_), sc_st_n, stb)
        ao_add = jnp.where(iot_n == sc_slot_n, sc_idx_n, ao)
        sk_add = jnp.where(iot_n == sc_slot_n, sc_st_n, sk)
        stc_rem, stb_rem, ao_rem, sk_rem = remove_status(stc, stb, ao, sk,
                                                         lpos)
        # relocate the pending candidate's accumulated multiplier into the
        # freed slot and re-pin it there: at q == n the candidate
        # provisionally sits in a PADDED slot (no real slot free), and the
        # dual-step removal that must follow brings it back inside the
        # real slot range (an add needs t2 finite, which the zero-z test
        # forbids at q == n, so actives never land in padding)
        cand_val = pick(u_stepped, iot_n == sc_slot_n)
        u_rem = jnp.where(iot_n == lpos, cand_val,
                          jnp.where(iot_n == sc_slot_n, f32(0.0),
                                    u_stepped))

        def sel(a, r_, keep_):
            return jnp.where(add_sel, a, jnp.where(rem_sel, r_, keep_))

        term_n = jnp.where(
            stop, jnp.where(success, i32(SUCCESS), i32(INFEASIBLE)),
            jnp.where(add_sel & dependent, i32(LINEAR_DEPENDENCY_DETECTED),
                      term))
        return (
            jnp.where(stop, x, x_new), H_n, NsT_n,
            sel(u_stepped, u_rem, uvec),
            sel(stc_add, stc_rem, stc), sel(stb_add, stb_rem, stb),
            sel(ao_add, ao_rem, ao), sel(sk_add, sk_rem, sk),
            nplus_n,
            jnp.where(add_sel, q + i32(1), jnp.where(rem_sel, q - i32(1), q)),
            jnp.where(stop, it, it + i32(1)),
            term_n,
            jnp.where(stop, skip1, jnp.where(full_step, i32(0), i32(1))),
            sc_idx_n, sc_st_n,
            jnp.where(rem_sel, lpos, sc_slot_n),
        )

    def cond(carry):
        it, term = carry[10], carry[11]
        return (term == i32(RUNNING)) & (it < i32(max_iter))

    x0, H0, N0, u0 = x0_ref[...], H0_ref[...], N0_ref[...], u0_ref[...]
    stc0, stb0, ao0, sk0 = (stc0_ref[...], stb0_ref[...], ao0_ref[...],
                            sk0_ref[...])
    q0, it0, term0 = (pick(scal0, iot8 == 0), pick(scal0, iot8 == 1),
                      pick(scal0, iot8 == 2))
    if warm:
        # warm-carry prologue (fast._init_fast_from_carry): closed-form
        # primal/dual point through the carried operators, then the
        # reference's one-at-a-time deactivation of u < 0 slots
        # (src/experimental/GoldfarbIdnaniSolver.cpp:83-108)
        a, b0 = refs[16][...], refs[17][...]

        def closed(H, NsT, b, sk):
            # x = N*^T b - H a,  u = N* (G x + a)
            x = (jnp.sum(NsT * b[None, :], axis=1)
                 - jnp.sum(H * a[None, :], axis=1))
            v = jnp.sum(G_ref[...] * x[None, :], axis=1) + a
            u = jnp.sum(v[:, None] * NsT, axis=0)
            return x, jnp.where(sk != i32(0), u, f32(0.0))

        def worst(u, sk):
            elig = (sk != i32(0)) & (sk != i32(EQUALITY)) & (sk != i32(FIXED))
            vals = jnp.where(elig, u, f32(0.0))
            return argmin(vals), jnp.min(vals)

        def pro_cond(c):
            return (term0 == i32(RUNNING)) & (worst(c[3], c[7])[1]
                                               < f32(-1e-5))

        def pro_body(c):
            x, H, NsT, u, stc, stb, ao, sk, b, q, it = c
            lpos = worst(u, sk)[0]
            H, NsT = remove_op(H, NsT, lpos, sk != i32(0))
            stc, stb, ao, sk = remove_status(stc, stb, ao, sk, lpos)
            b = jnp.where(iot_n == lpos, f32(0.0), b)
            x, u = closed(H, NsT, b, sk)
            return (x, H, NsT, u, stc, stb, ao, sk, b, q - i32(1),
                    it + i32(1))

        x0, u0 = closed(H0, N0, b0, sk0)
        (x0, H0, N0, u0, stc0, stb0, ao0, sk0, _, q0, it0) = lax.while_loop(
            pro_cond, pro_body,
            (x0, H0, N0, u0, stc0, stb0, ao0, sk0, b0, q0, it0))
        # the first free slot takes the first candidate
        scal0 = jnp.where(iot8 == 6, argmin((sk0 != i32(0)).astype(i32)),
                          scal0)

    init = (
        x0, H0, N0, u0, stc0, stb0, ao0, sk0, jnp.zeros((np_,), f32),
        q0, it0, term0,
        pick(scal0, iot8 == 3), pick(scal0, iot8 == 4),
        pick(scal0, iot8 == 5), pick(scal0, iot8 == 6),
    )
    (x, H, NsT, uvec, stc, stb, ao, _, _, q, it, term, skip1, sc_idx, sc_st,
     sc_slot) = lax.while_loop(cond, body, init)
    term = jnp.where(term == i32(RUNNING), i32(MAX_ITER_REACHED), term)

    x_out[...] = x
    u_out[...] = uvec
    stc_out[...] = stc
    stb_out[...] = stb
    ao_out[...] = ao
    H_out[...] = H
    N_out[...] = NsT
    scal = jnp.zeros((8,), i32)
    for k, v in enumerate((q, it, term, skip1, sc_idx, sc_st, sc_slot)):
        scal = jnp.where(iot8 == k, v, scal)
    scal_out[...] = scal


def run_loop_pallas(pb32: QPProblem, state0, max_iter: int,
                    interpret: bool = False, num_warps: int | None = None,
                    warm_prologue: bool = False):
    """Run the GI loop with the Triton kernel on a batch of f32 problems.

    ``pb32``: stacked QPProblem (leading batch dim, float32). ``state0``: a
    batched :class:`jrlqp_tpu.solver.fast.FastState` (cold init, warm
    start, or a previous kernel state; slot holes allowed). ``num_warps``:
    warps per program (None = :func:`default_warps`). ``warm_prologue``:
    ``state0`` holds a previous solve's operators and active set (x and u
    are ignored) for problems with the same G and C; the kernel first
    computes the warm point and drops u < 0 slots, as
    :func:`jrlqp_tpu.solver.fast._init_fast_from_carry` does in XLA.
    Returns the final batched FastState in the library's (m+n) index
    layout, with ``f`` left at zero (refinement recomputes it) and
    ``hscale`` carried through.
    """
    from ...solver.fast import FastState

    B, n = pb32.a.shape
    m = pb32.C.shape[1]
    np_, mp_ = padded_dims(n, m)
    if np_ > MAX_NP:
        raise ValueError(f"n={n} is above the kernel's limit "
                         f"(padded {np_} > {MAX_NP})")
    if num_warps is None:
        num_warps = default_warps(np_)
    f32, i32 = jnp.float32, jnp.int32

    def pad2(A, r, c):
        return jnp.zeros((B, r, c), f32).at[:, :A.shape[1], :A.shape[2]].set(
            A.astype(f32))

    def padv(v, c, fill=0.0, dtype=f32):
        v = v.astype(dtype)
        if dtype == f32:
            v = jnp.nan_to_num(v, posinf=BIG * 10, neginf=-BIG * 10)
        return jnp.full((B, c), fill, dtype).at[:, :v.shape[1]].set(v)

    st = state0
    valid0 = st.aorder >= 0
    ao_remap = jnp.where(st.aorder >= m, st.aorder - m + mp_, st.aorder)
    ao_remap = jnp.where(valid0, ao_remap, -1)
    sk0 = jnp.where(valid0, jnp.take_along_axis(
        st.status, jnp.where(valid0, st.aorder, 0), axis=1), 0)
    sc_idx0 = jnp.where(st.sc_idx >= m, st.sc_idx - m + mp_, st.sc_idx)
    # pending-candidate slot: the FREE slot holding a nonzero multiplier
    # (a resumed state with skip1 set), else the first free slot; for a
    # compact fresh state this is exactly q
    k = jnp.arange(n)
    free0 = ~valid0
    cand_key = jnp.where(free0 & (st.u[:, :n] != 0), k,
                         jnp.where(free0, n + k, 2 * n + k))
    sc_slot0 = jnp.argmin(cand_key, axis=1)
    scal0 = jnp.stack([st.q, st.it, st.term, st.skip1, sc_idx0,
                       st.sc_status, sc_slot0, jnp.zeros_like(st.q)],
                      axis=-1).astype(i32)
    hs0 = jnp.zeros((B, 8), f32).at[:, 0].set(st.hscale.astype(f32))

    inputs = (
        pad2(pb32.G, np_, np_), pad2(pb32.C, mp_, np_),
        padv(pb32.l, mp_, -BIG * 10), padv(pb32.u, mp_, BIG * 10),
        padv(pb32.xl, np_, -BIG * 10), padv(pb32.xu, np_, BIG * 10),
        pad2(st.H, np_, np_), pad2(jnp.swapaxes(st.Ns, 1, 2), np_, np_),
        padv(st.x, np_), padv(st.u[:, :n + 1], np_),
        padv(st.status[:, :m], mp_, 0, i32),
        padv(st.status[:, m:], np_, 0, i32),
        padv(ao_remap, np_, -1, i32), padv(sk0, np_, 0, i32),
        scal0, hs0,
    )
    shapes = [(np_, np_), (mp_, np_), (mp_,), (mp_,), (np_,), (np_,),
              (np_, np_), (np_, np_), (np_,), (np_,), (mp_,), (np_,),
              (np_,), (np_,), (8,), (8,)]
    if warm_prologue:
        # per-slot signed active bounds of the NEW problem (sign convention
        # of warm_start._active_normals_and_bounds)
        stat = jnp.where(valid0, sk0, 0)
        upperish = (stat == UPPER) | (stat == UPPER_BOUND)
        idx = jnp.where(valid0, st.aorder, 0)
        lo = jnp.take_along_axis(jnp.concatenate([pb32.l, pb32.xl], 1), idx, 1)
        hi = jnp.take_along_axis(jnp.concatenate([pb32.u, pb32.xu], 1), idx, 1)
        b_act = jnp.where(valid0, jnp.where(upperish, -hi, lo), 0.0)
        inputs += (padv(pb32.a, np_), padv(b_act, np_))
        shapes += [(np_,), (np_,)]

    def spec(*shape):
        zeros = (0,) * len(shape)
        return pl.BlockSpec((None,) + shape, lambda i: (i,) + zeros)

    def out(shape, dtype):
        return jax.ShapeDtypeStruct((B,) + shape, dtype)

    out_shapes = [((np_,), f32), ((np_,), f32), ((mp_,), i32),
                  ((np_,), i32), ((np_,), i32), ((8,), i32),
                  ((np_, np_), f32), ((np_, np_), f32)]
    x, uvec, stc, stb, ao, scal, H, NsT = pl.pallas_call(
        functools.partial(_kernel, n=n, m=m, np_=np_, mp_=mp_,
                          max_iter=max_iter, warm=warm_prologue),
        grid=(B,),
        in_specs=[spec(*s) for s in shapes],
        out_specs=[spec(*s) for s, _ in out_shapes],
        out_shape=[out(s, d) for s, d in out_shapes],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="gi_loop",
    )(*inputs)

    ao = ao[:, :n]
    ao_back = jnp.where(ao >= mp_, ao - mp_ + m, ao)
    sc_raw = scal[:, 4]
    return FastState(
        x=x[:, :n],
        f=jnp.zeros((B,), f32),
        H=H[:, :n, :n],
        Ns=jnp.swapaxes(NsT, 1, 2)[:, :n, :n],
        status=jnp.concatenate([stc[:, :m], stb[:, :n]], axis=1),
        aorder=jnp.where(ao < 0, -1, ao_back),
        u=jnp.concatenate([uvec[:, :n], jnp.zeros((B, 1), f32)], axis=1),
        q=scal[:, 0],
        it=scal[:, 1],
        term=scal[:, 2],
        skip1=scal[:, 3].astype(bool),
        sc_idx=jnp.where(sc_raw >= mp_, sc_raw - mp_ + m, sc_raw),
        sc_status=scal[:, 5],
        hscale=st.hscale.astype(f32),
    )
