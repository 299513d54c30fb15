"""Multi-host bootstrap: jax.distributed + global device mesh construction.

The reference scales across hosts with `mpirun -np N` + PETSc's MPI
communicator (SURVEY §2.6).  The JAX equivalent is one Python process per
host calling `jax.distributed.initialize()`, after which `jax.devices()`
spans every host's devices and every shard_map/psum in this package runs
across them unchanged — the same solver code that the tests run on the virtual
CPU mesh.

Typical multi-host usage:

    from pfemfort_jax.parallel.multihost import initialize, global_mesh
    initialize()                      # no-op on a single host
    mesh = global_mesh()              # 1D 'shard' mesh over every device
    res = solve_implicit_sharded(..., device_mesh=mesh)

Process-0-only I/O (the reference's rank-0 VTK write) via `is_coordinator()`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed when running multi-process.

    With no arguments, relies on JAX's auto-detection of a cluster
    environment.  Safe to call on a single host: errors from missing
    cluster metadata leave single-process mode untouched.
    """
    import jax

    # Detect prior initialization WITHOUT touching the XLA backend
    # (jax.process_count() would initialize it, and
    # jax.distributed.initialize must run before that).
    try:
        from jax._src import distributed as _dist
        if getattr(_dist.global_state, "client", None) is not None:
            return  # already initialized
    except Exception:
        pass
    if coordinator_address is not None or num_processes is not None:
        # explicit cluster spec: failures are REAL errors, propagate them
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
        return
    try:
        jax.distributed.initialize()
    except Exception:
        # auto-detection found no cluster env: stay single-process
        pass


def global_mesh(axis: str = "shard"):
    """1D device mesh over every device of every process."""
    import jax

    return jax.sharding.Mesh(np.asarray(jax.devices()), (axis,))


def is_coordinator() -> bool:
    import jax

    return jax.process_index() == 0
