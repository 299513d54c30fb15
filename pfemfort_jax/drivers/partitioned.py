"""Pre-partitioned per-rank input mode (triapoissonparallelimpl2 parity).

The reference's impl2 variant has each MPI rank read ONLY its subdomain
files and recover global sizes with MPI_Allreduce
(/root/reference/src/triapoissonparallelimpl2.F:188-231).  Here: every process reads `<prefix>-p<rank>-*.dat`
(mesh/io.py:write_partitioned), the pieces are merged — locally when one
process holds them all, via `multihost_utils.process_allgather` across a
multi-process run — and the merged mesh feeds the standard distributed
solve (drivers/sharded.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from pfemfort_jax.mesh.core import Mesh
from pfemfort_jax.mesh.io import read_partitioned


def merge_partitions(pieces: Sequence[Tuple[Mesh, Optional[np.ndarray],
                                            np.ndarray]]):
    """Merge (mesh_local, dirichlet_local, node_gids) pieces -> global
    (mesh, dirichlet).  Elements are rank-disjoint by construction
    (write_partitioned); shared boundary nodes deduplicate by global id."""
    etype = pieces[0][0].etype
    ndim = pieces[0][0].ndim
    n_node = int(max(p[2].max() for p in pieces)) + 1
    coords = np.zeros((n_node, ndim), dtype=np.float64)
    seen = np.zeros(n_node, dtype=bool)
    conns = []
    dbc_rows = []
    for mesh_l, dbc_l, gids in pieces:
        coords[gids] = mesh_l.coords
        seen[gids] = True
        conns.append(gids[mesh_l.conn])
        if dbc_l is not None and len(dbc_l):
            d = dbc_l.copy()
            d[:, 0] = gids[dbc_l[:, 0].astype(np.int64)]
            dbc_rows.append(d)
    if not seen.all():
        raise ValueError(f"{(~seen).sum()} global nodes missing from the "
                         "rank files")
    conn = np.concatenate(conns, axis=0)
    dbc = None
    if dbc_rows:
        dbc = np.concatenate(dbc_rows, axis=0)
        # shared boundary nodes appear in several rank files: dedup (node,dof)
        _, keep = np.unique(dbc[:, 0] * 8 + dbc[:, 1], return_index=True)
        dbc = dbc[np.sort(keep)]
    return Mesh(etype, coords, conn), dbc


def read_partitioned_local(prefix: str, ranks: Sequence[int]):
    """Single-process form: read the given rank files and merge."""
    return merge_partitions([read_partitioned(prefix, r) for r in ranks])


def read_partitioned_multiprocess(prefix: str):
    """Multi-process form: THIS process reads only rank=process_index()'s
    files; the pieces are exchanged with a process_allgather (the
    MPI_Allreduce/Allgatherv of the reference impl2)."""
    import jax
    from jax.experimental import multihost_utils

    rank = jax.process_index()
    mesh_l, dbc_l, gids = read_partitioned(prefix, rank)

    def gather_ragged(arr, dtype):
        arr = np.asarray(arr, dtype=dtype)
        n = np.zeros((), np.int64) + arr.shape[0]
        counts = multihost_utils.process_allgather(n)
        m = int(counts.max())
        pad = np.zeros((m,) + arr.shape[1:], dtype=dtype)
        pad[:arr.shape[0]] = arr
        full = multihost_utils.process_allgather(pad)
        return [full[p, :int(counts[p])] for p in range(len(counts))]

    coords_all = gather_ragged(mesh_l.coords, np.float64)
    conn_all = gather_ragged(mesh_l.conn, np.int64)
    gids_all = gather_ragged(gids, np.int64)
    dbc_arr = dbc_l if dbc_l is not None else np.zeros((0, 3))
    dbc_all = gather_ragged(dbc_arr, np.float64)

    pieces = []
    for p in range(len(coords_all)):
        m = Mesh(mesh_l.etype, coords_all[p],
                 conn_all[p].astype(np.int32))
        d = dbc_all[p] if len(dbc_all[p]) else None
        pieces.append((m, d, gids_all[p]))
    return merge_partitions(pieces)


def solve_poisson_partitioned(prefix: str, n_ranks: int,
                              multiprocess: bool = False, **kw):
    """End-to-end per-rank-file Poisson solve (impl2 executable parity)."""
    from pfemfort_jax.drivers.sharded import solve_implicit_sharded
    from pfemfort_jax.elements.poisson import poisson_element_matrices

    if multiprocess:
        mesh, dbc = read_partitioned_multiprocess(prefix)
    else:
        mesh, dbc = read_partitioned_local(prefix, range(n_ranks))
    source = -6.0 if mesh.etype == "tetra4" else 0.0
    return mesh, solve_implicit_sharded(
        mesh, 1, dbc,
        lambda c: poisson_element_matrices(c, mesh.etype, source=source),
        **kw)
