"""Device-side SPMD RCB partitioner (the ParMETIS_V3_PartMeshKway analog,
/root/reference/src/meshpartitionfortparmetis.cpp:393-413): balance and
slab-contiguity checks, including with INPUT SHARDED over the device mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pfemfort_jax.mesh import generate
from pfemfort_jax.parallel.dist_partition import rcb_partition_device


@pytest.mark.parametrize("k", [2, 4, 7, 8])
def test_device_rcb_balance(k):
    rng = np.random.default_rng(0)
    pts = rng.uniform(size=(20000, 3)) * np.array([1.0, 2.0, 8.0])
    part = np.asarray(jax.jit(
        rcb_partition_device, static_argnums=1)(jnp.asarray(pts), k))
    counts = np.bincount(part, minlength=k)
    assert counts.min() > 0
    assert counts.max() <= 1.05 * 20000 / k + 64


def test_device_rcb_matches_geometry():
    """Parts of a box mesh are spatially contiguous slabs/blocks: every part
    has a bounded extent product (no interleaving)."""
    mesh, _ = generate.box_tet(0, 1, 8, 0, 1, 8, 0, 4, 32)
    cent = mesh.elem_centroids()
    part = np.asarray(jax.jit(
        rcb_partition_device, static_argnums=1)(jnp.asarray(cent), 8))
    vol_total = 1.0 * 1.0 * 4.0
    for p in range(8):
        sel = cent[part == p]
        ext = sel.max(axis=0) - sel.min(axis=0)
        assert np.prod(ext + 1e-9) < 0.35 * vol_total  # ~1/8 + slack


def test_device_rcb_runs_sharded():
    """SPMD execution: centroids sharded over the 8-device mesh; result must
    equal the replicated run exactly."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 devices")
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    dm = Mesh(np.array(devs[:8]), ("shard",))
    rng = np.random.default_rng(1)
    pts = rng.uniform(size=(16384, 3))
    ref = np.asarray(jax.jit(
        rcb_partition_device, static_argnums=1)(jnp.asarray(pts), 8))
    pts_s = jax.device_put(jnp.asarray(pts), NamedSharding(dm, P("shard")))
    out = np.asarray(jax.jit(
        rcb_partition_device, static_argnums=1)(pts_s, 8))
    np.testing.assert_array_equal(out, ref)
    counts = np.bincount(ref, minlength=8)
    assert counts.min() > 0
