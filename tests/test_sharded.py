"""Mesh-sharded batch solves on the virtual 8-device CPU mesh.

The reference has no distributed runtime; the framework's parallelism
contract (SURVEY.md §2 accounting / §7 M6) is: batches shard over a
``jax.sharding.Mesh`` with psum/pmax only for convergence accounting, and
every engine must produce the same per-problem results sharded as unsharded.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jrlqp_tpu import SolverOptions, solve_batch
from jrlqp_tpu.parallel import make_mesh, solve_sharded
from jrlqp_tpu.testing.batch_gen import random_qp_batch
from jrlqp_tpu.testing.kkt import kkt_residual


@pytest.mark.parametrize("engine", ["f64", "refined", "pallas"])
def test_sharded_matches_unsharded(engine):
    mesh = make_mesh(8)
    opt = SolverOptions(max_iter=60)
    pbs = random_qp_batch(jax.random.key(1), 16, 7, 11, act_frac=0.4)
    res, stats = solve_sharded(pbs, opt, mesh=mesh, engine=engine,
                               interpret=engine == "pallas")
    ref = solve_batch(pbs, opt)
    np.testing.assert_array_equal(np.asarray(res.status),
                                  np.asarray(ref.status))
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               atol=1e-6)
    # detach from the mesh sharding before the KKT check
    res_x = jnp.asarray(np.asarray(res.x))
    res_mu = jnp.asarray(np.asarray(res.multipliers))
    resid = jax.vmap(kkt_residual)(res_x, res_mu, pbs)
    assert np.asarray(resid <= 1e-8).all()
    assert int(stats.n_success) == 16
    assert int(stats.max_iterations) == int(jnp.max(ref.iterations))


def test_make_mesh_raises_when_devices_are_missing():
    """make_mesh never falls back to other devices: asking for more
    devices than the default backend has is an error."""
    have = len(jax.devices())
    assert make_mesh(have).devices.size == have
    with pytest.raises(ValueError, match="need"):
        make_mesh(have + 1)
