"""Worker process for the 2-process jax.distributed CPU test.

Each process owns 4 virtual CPU devices; together they form an 8-device
global mesh.  Every process reads ONLY its own per-rank mesh files
(triapoissonparallelimpl2 semantics), the pieces are allgathered, and the
distributed per-shard assembly + halo CG runs over the global mesh.
Launched by tests/test_multihost.py — not a pytest module itself.
"""

import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
coord = sys.argv[3]
prefix = sys.argv[4]
# "dia" (lattice mesh, slab shards) or "ell" (scrambled mesh: the
# unstructured per-shard ELL assembly + all_to_all stash + pairwise ghost
# exchange crossing a REAL process boundary)
mode = sys.argv[5] if len(sys.argv) > 5 else "dia"

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from pfemfort_jax.parallel import multihost  # noqa: E402

multihost.initialize(coordinator_address=coord, num_processes=nproc,
                     process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
assert jax.device_count() == 4 * nproc, jax.device_count()

from pfemfort_jax.drivers.partitioned import (  # noqa: E402
    solve_poisson_partitioned,
)

# the ell leg also drives the reference's parallel default PC across the
# REAL process boundary: per-shard IC(0) under block-Jacobi
kw = dict(recover=False, precond="ic0") if mode == "ell" else {}
mesh, res = solve_poisson_partitioned(
    prefix, nproc, multiprocess=True,
    device_mesh=multihost.global_mesh(), rtol=1e-10, **kw)

assert bool(np.asarray(res.stats.converged)), res.stats
if mode == "ell":
    assert res.timings["assembly_layout"] == "ell", res.timings
    assert res.timings["precond_used"] == "ic0", res.timings
u_exact = (mesh.coords ** 2).sum(axis=1)
err = float(np.abs(res.u_full - u_exact).max())
assert err < 1e-6, err
if multihost.is_coordinator():
    print(f"MULTIHOST OK: {nproc} processes, "
          f"{jax.device_count()} devices, err {err:.2e}, "
          f"iters {int(np.asarray(res.stats.iters))}, "
          f"layout={res.timings['assembly_layout']}, "
          f"dist_assembly={res.timings['distributed_assembly']}")
