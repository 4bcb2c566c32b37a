"""Multi-host initialization and cross-host meshes.

The reference has no distributed runtime (single-process CPU library); this
module is the multi-host scaling layer mandated by the project north star
(SURVEY.md section 2 parallelism accounting, BASELINE.md scaling row):
batches of independent QPs sharded over all devices of a multi-host job,
with collectives only for convergence accounting.

Usage on each host (pass the coordinator address, process count and process
id where the cluster does not provide them)::

    from jrlqp_tpu.parallel import distributed
    distributed.initialize()              # no-op on single process
    mesh = distributed.global_mesh()      # 1-D "batch" mesh over all devices
    res, stats = solve_sharded(pbs, opt, mesh=mesh)

Data layout guidance: shard the leading batch axis; each chip solves its
local problems with zero cross-chip traffic; the psum/pmax reductions in
``solve_sharded`` ride ICI within a slice and DCN across hosts, inserted by
XLA from the shard_map out_specs.
"""
from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh

__all__ = ["initialize", "global_mesh", "process_local_batch_slice"]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed if running multi-process. Where the
    cluster does not announce itself, pass ``coordinator_address``
    (``host:port``), ``num_processes`` and ``process_id``; single-process
    callers can skip entirely (calling this is then a no-op)."""
    if num_processes is not None and num_processes <= 1:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (ValueError, RuntimeError) as e:
        if "already" in str(e).lower():
            return  # second call in the same process: fine
        if coordinator_address is None and num_processes is None:
            return  # single-process environment without coordinator: fine
        raise  # explicit multi-process setup that failed must be loud


def global_mesh(axis: str = "batch") -> Mesh:
    """1-D mesh over every addressable chip of every host."""
    devs = jax.devices()
    return jax.make_mesh((len(devs),), (axis,), devices=devs)


def process_local_batch_slice(global_batch: int) -> slice:
    """The slice of a global batch this process should materialize when
    constructing problem data host-side (jax.make_array_from_process_local_data
    composes with this)."""
    per = global_batch // jax.process_count()
    i = jax.process_index()
    return slice(i * per, (i + 1) * per)
