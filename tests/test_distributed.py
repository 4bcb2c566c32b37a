"""Multi-process distributed test (BASELINE.md scaling row).

Spawns two CPU-only JAX processes (2 virtual devices each -> a 4-device
global mesh) coordinated via jax.distributed on localhost, runs a sharded
batch solve across both processes, and checks every process's local shards
against an unsharded single-process oracle. The reference has no
distributed runtime (SURVEY.md section 2); this validates the scaling
layer's multi-host path without real multi-host hardware.
"""
import os
import socket
import subprocess
import sys

import pytest

from jrlqp_tpu.utils.cache import compile_cache_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
import jax
jax.config.update("jax_enable_x64", True)
pid, nproc, coord, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
sys.path.insert(0, os.environ["JRLQP_REPO"])
from jrlqp_tpu.parallel import distributed

distributed.initialize(coordinator_address=coord, num_processes=nproc,
                       process_id=pid)
assert jax.process_count() == nproc, jax.process_count()

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jrlqp_tpu.parallel.mesh import solve_sharded
from jrlqp_tpu.solver.dense import solve_batch
from jrlqp_tpu.testing.batch_gen import random_qp_batch

mesh = distributed.global_mesh()
n_global = len(mesh.devices.ravel())
assert n_global == nproc * 2, n_global  # 2 virtual devices per process

B, n, m = 16, 6, 10
# identical host data in every process (deterministic key)
pbs = random_qp_batch(jax.random.key(0), B, n, m, act_frac=0.3)
pbs_np = jax.tree.map(np.asarray, pbs)
sh = NamedSharding(mesh, P("batch"))
pbs_g = jax.tree.map(lambda x: jax.device_put(x, sh), pbs_np)

res, stats = solve_sharded(pbs_g, mesh=mesh)

# oracle: local unsharded solve of the same batch
ora = solve_batch(pbs)
ora_x = np.asarray(ora.x)
checked = 0
for shard in res.x.addressable_shards:
    rows = shard.index[0]
    np.testing.assert_allclose(np.asarray(shard.data), ora_x[rows],
                               atol=1e-10)
    checked += np.asarray(shard.data).shape[0]
assert checked == B // nproc, checked  # each process owns half the batch
assert int(stats.n_success) == B      # psum'd across processes

with open(os.path.join(outdir, f"ok{pid}"), "w") as fh:
    fh.write(f"checked={checked}")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_solve(tmp_path):
    # hang guard is the communicate(timeout=540) below (pytest-timeout is
    # not a dependency)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = _free_port()
    env = dict(os.environ)
    # CPU-only children: never a second process on an accelerator
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JRLQP_REPO"] = REPO
    env["JAX_COMPILATION_CACHE_DIR"] = compile_cache_dir()
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2",
             f"127.0.0.1:{port}", str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"proc {i} rc={p.returncode}\n{outs[i][-3000:]}"
        assert (tmp_path / f"ok{i}").exists(), outs[i][-3000:]
