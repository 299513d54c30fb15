"""Sharded explicit dynamics must match the single-device integrator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pfemfort_jax.dynamics.explicit import explicit_dynamics
from pfemfort_jax.dynamics.sharded import explicit_dynamics_sharded
from pfemfort_jax.mesh import generate


def _mesh_or_skip(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices")
    return jax.sharding.Mesh(np.array(devs[:n]), ("shard",))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_explicit_matches_single_2d(n_shards):
    dm = _mesh_or_skip(n_shards)
    mesh = generate.rect_tria(0, 1, 4, 0, 4, 12)   # long in y -> slabs
    left = np.nonzero(np.isclose(mesh.coords[:, 1], 0))[0]
    dbc = np.array([[n, d, 0.0] for n in left for d in (0, 1)])
    E, nu, dens, dt, nsteps = 200.0, 0.3, 10.0, 1e-4, 40
    bf = lambda t: jnp.stack([jnp.where(t <= 0.1, 1.0, 0.0), jnp.zeros(())])

    ref = explicit_dynamics(mesh, dbc, E, nu, dens, dt, nsteps,
                            bforce_fn=bf, probe_dofs=(10, 11))
    res = explicit_dynamics_sharded(mesh, dbc, E, nu, dens, dt, nsteps,
                                    device_mesh=dm, bforce_fn=bf,
                                    probe_dofs=(10, 11))
    assert np.allclose(res.disp, ref.disp, rtol=1e-9, atol=1e-12)
    assert np.allclose(res.velo, ref.velo, rtol=1e-9, atol=1e-12)
    assert np.allclose(res.acce, ref.acce, rtol=1e-9, atol=1e-10)
    assert np.abs(res.acce).max() > 0
    assert np.allclose(res.probe_history, ref.probe_history,
                       rtol=1e-9, atol=1e-12)


def test_sharded_explicit_matches_single_3d():
    dm = _mesh_or_skip(4)
    mesh, _ = generate.box_tet(0, 1, 3, 0, 1, 3, 0, 3, 9)
    base = np.nonzero(np.isclose(mesh.coords[:, 2], 0))[0]
    dbc = np.array([[n, d, 0.0] for n in base for d in (0, 1, 2)])
    E, nu, dens, dt, nsteps = 200.0, 0.3, 10.0, 5e-5, 25
    bf = lambda t: jnp.asarray([1.0, 0.0, 0.0])

    ref = explicit_dynamics(mesh, dbc, E, nu, dens, dt, nsteps,
                            bforce_fn=bf)
    res = explicit_dynamics_sharded(mesh, dbc, E, nu, dens, dt, nsteps,
                                    device_mesh=dm, bforce_fn=bf)
    assert np.allclose(res.disp, ref.disp, rtol=1e-8, atol=1e-12)
    assert np.allclose(res.acce, ref.acce, rtol=1e-8, atol=1e-9)
