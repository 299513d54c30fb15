"""Weak-scaling harness: sharded CG over a device mesh (BASELINE.md target:
>=80% weak-scaling efficiency on SpMV nnz/s up to the 48M-element problem).

One process drives every device of the mesh.  On several GPUs of one host
it reports per-device SpMV and CG throughput at fixed work per device; on
the virtual CPU mesh it validates the harness and the sharded pipeline:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  JAX_PFEM_CPU=1 python bench_scaling.py --per-shard-n 16 --shards 1 2 4 8

Prints one JSON line per shard count with nnz/s and efficiency vs 1 shard.
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-shard-n", type=int, default=32,
                    help="hex cells per axis per shard (weak scaling: the "
                         "z extent grows with the shard count)")
    ap.add_argument("--shards", type=int, nargs="+", default=None)
    ap.add_argument("--rtol", type=float, default=1e-6)
    args = ap.parse_args()

    import jax
    if os.environ.get("JAX_PFEM_CPU"):
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pfemfort_jax.drivers.sharded import solve_implicit_sharded
    from pfemfort_jax.elements.poisson import poisson_element_matrices
    from pfemfort_jax.mesh import generate

    devs = jax.devices()
    shard_counts = args.shards or sorted(
        {1, 2, len(devs) // 2, len(devs)} - {0})
    n = args.per_shard_n
    base_rate = None
    for S in shard_counts:
        if S > len(devs):
            continue
        mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, S, S * n)
        dm = jax.sharding.Mesh(np.array(devs[:S]), ("shard",))
        t0 = time.perf_counter()
        res = solve_implicit_sharded(
            mesh, 1, dbc,
            lambda c: poisson_element_matrices(c, "tetra4", source=-6.0),
            device_mesh=dm, rtol=args.rtol, dtype=jnp.float32)
        t = res.timings["solve_s"]
        iters = int(np.asarray(res.stats.iters))
        # nnz ~ 15 * n_dof for the tet stencil
        nnz = 15 * (mesh.n_node - len(dbc))
        rate = nnz * iters / t
        if base_rate is None:
            base_rate = rate / S if S else rate
        eff = rate / (S * base_rate)
        print(json.dumps({
            "shards": S,
            "elems": mesh.n_elem,
            "iters": iters,
            "solve_s": t,
            "spmv_nnz_per_s": rate,
            "weak_scaling_eff": eff,
            "converged": bool(np.asarray(res.stats.converged)),
        }), flush=True)


if __name__ == "__main__":
    main()
