"""Device-mesh sharding of QP batches.

The reference is a single-process CPU library with no distributed runtime
(SURVEY.md section 2, parallelism accounting); its benchmark harness solves
arrays of problems sequentially (ref: benchmarks/Solvers.cpp:154-299). Here
thousands of independent QPs are batched per device and the batch dimension
is sharded over a flat 1-D ``jax.sharding.Mesh`` with ``shard_map``. The GI
algorithm needs no cross-problem communication; collectives (psum / pmax)
appear only for convergence accounting, outside the hot loop.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..problems import QPProblem
from ..solver.dense import _solve_impl
from ..solver.state import GIResult
from ..types import RUNNING, SUCCESS, SolverOptions

__all__ = ["make_mesh", "shard_batch", "solve_sharded", "BatchStats"]


def make_mesh(n_devices: Optional[int] = None, axis: str = "batch") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices of the default backend
    (default: all). Raises ``ValueError`` if it has fewer."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, the default backend "
                f"({jax.default_backend()}) has {len(devs)}")
        devs = devs[:n_devices]
    return jax.make_mesh((len(devs),), (axis,), devices=devs)


def shard_batch(pbs: QPProblem, mesh: Mesh, axis: str = "batch") -> QPProblem:
    """Place a stacked problem batch with its leading dim sharded over
    ``axis`` (problem data sharded; no replication)."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), pbs)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BatchStats:
    """Globally-reduced convergence accounting (the only collectives in a
    sharded solve): total iterations, solved-lane count, max iterations."""

    total_iterations: jax.Array  # () int32, psum over the mesh
    n_success: jax.Array  # () int32
    max_iterations: jax.Array  # () int32, pmax


@functools.lru_cache(maxsize=64)
def _shard_solve_fn(mesh: Mesh, axis: str, engine: str, opt: SolverOptions,
                    interpret: bool):
    """Build-and-cache the jitted shard_map'd solve for a given
    (mesh, engine, options) configuration: a fresh ``jax.jit`` of a fresh
    closure per call would re-trace the whole solve on every call.
    """
    # check_vma=False: the GI while_loop mixes device-varying problem data
    # with replicated constants (identity J/R seeds) in its carry; the solve
    # is embarrassingly parallel, so varying-axis tracking adds nothing.
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis),),
        out_specs=(P(axis), P()),
        check_vma=False,
    )
    def _shard_solve(local: QPProblem):
        if engine == "pallas":
            from ..solver.fast import solve_refined_pallas

            res: GIResult = solve_refined_pallas(local, opt,
                                                 interpret=interpret)
        elif engine == "refined":
            from ..solver.fast import solve_refined

            res = jax.vmap(lambda p: solve_refined(p, opt))(local)
        else:
            res = jax.vmap(lambda p: _solve_impl(p, opt))(local)
        stats = BatchStats(
            total_iterations=jax.lax.psum(jnp.sum(res.iterations), axis),
            n_success=jax.lax.psum(
                jnp.sum((res.status == SUCCESS).astype(jnp.int32)), axis
            ),
            max_iterations=jax.lax.pmax(jnp.max(res.iterations), axis),
        )
        return res, stats

    return jax.jit(_shard_solve)


def solve_sharded(
    pbs: QPProblem,
    opt: SolverOptions = SolverOptions(),
    mesh: Optional[Mesh] = None,
    axis: str = "batch",
    engine: str = "f64",
    interpret: bool = False,
):
    """Solve a stacked batch of QPs sharded over a device mesh.

    Each device runs the chosen engine over its local shard ("f64" =
    reference-faithful J/R loop; "refined" = f32 explicit-operator loop +
    f64-residual refinement; "pallas" = the whole-solve loop kernel, with the
    engine choice of :func:`jrlqp_tpu.solver.fast.solve_refined_pallas`:
    GPU only unless ``interpret=True``); a single psum/pmax pass at the end
    produces global convergence statistics. Returns (GIResult batch sharded
    like the input, BatchStats).

    The compiled executable is cached per (mesh, axis, engine, options), so
    repeated calls on the same configuration pay no re-trace cost.
    """
    if mesh is None:
        mesh = make_mesh(axis=axis)
    fn = _shard_solve_fn(mesh, axis, engine, opt, interpret)
    pbs = shard_batch(pbs, mesh, axis)
    return fn(pbs)
