"""Row-sharded system construction: partition -> contiguous renumbering ->
padded per-shard ELL blocks.

The counterpart of the reference's partition-contiguous row renumbering
(node_start/node_end/row_start/row_end,
/root/reference/src/triapoissonparallelimpl1.F:536-700): free equations are
reordered so shard s owns rows [s*P, (s+1)*P) with P identical across shards
(padded with empty rows so shapes are static and shard-equal — the shard_map
requirement replacing PETSc's per-rank size_local).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pfemfort_jax.assembly.pattern import AssemblyPattern, build_pattern
from pfemfort_jax.dofs.dofmap import DofMap, build_dofmap
from pfemfort_jax.mesh.core import Mesh
from pfemfort_jax.parallel.partition import (
    nodes_from_elem_partition,
    partition_elements,
)
from pfemfort_jax.sparse.formats import round_up


@dataclasses.dataclass
class ShardedSystem:
    n_shards: int
    rows_per_shard: int           # P
    n_rows_padded: int            # n_shards * P
    dofmap: DofMap                # original (unpermuted) dofmap
    pattern: AssemblyPattern      # pattern over padded, shard-ordered rows
    eq_perm: np.ndarray           # (total_dof,) old eq id -> padded row id
    elem_part: np.ndarray         # (n_elem,) partition of each element
    node_part: np.ndarray         # (n_node,)

    def reduce_solution(self, x_padded: np.ndarray) -> np.ndarray:
        """Padded shard-ordered vector -> original eq ordering."""
        return np.asarray(x_padded)[self.eq_perm]

    def expand_rhs(self, b_orig: np.ndarray) -> np.ndarray:
        out = np.zeros(self.n_rows_padded, dtype=b_orig.dtype)
        out[self.eq_perm] = b_orig
        return out


def _within_shard_order(mesh: Mesh, node_part: np.ndarray,
                        n_shards: int) -> np.ndarray:
    """Per-shard geometric (z, y, x)-lexicographic rank of every node.

    Bandwidth-reduced local numbering keeps each row's columns close
    together, so the in-shard ELL gather reads nearby x values.  Geometric
    lex recovers the lattice numbering exactly on near-lattice meshes,
    costs one lexsort instead of a scipy graph pass, and has no size cap."""
    keys = [mesh.coords[:, d] for d in range(mesh.ndim)]
    order = np.lexsort(tuple(keys) + (node_part,))
    part_sorted = node_part[order]
    first = np.ones(len(order), dtype=bool)
    first[1:] = part_sorted[1:] != part_sorted[:-1]
    start_of = np.zeros(len(order), dtype=np.int64)
    start_of[first] = np.nonzero(first)[0]
    np.maximum.accumulate(start_of, out=start_of)
    rank = np.empty(mesh.n_node, dtype=np.int64)
    rank[order] = np.arange(len(order)) - start_of
    return rank


def build_sharded_system(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    n_shards: int,
    method: str = "rcb",
    lane_pad: int = 8,
    layout: str = "auto",
) -> ShardedSystem:
    """Partition the mesh and build a shard-contiguous assembly pattern."""
    dofmap = build_dofmap(mesh, ndof, dirichlet)
    red_lat = None
    if method == "slab":
        # Contiguous equation-block ownership: shard s owns rows
        # [s*P, (s+1)*P) of the ORIGINAL equation numbering, padding only
        # past the global end (eq_perm = identity).  This is the literal
        # analog of the reference's row_start/row_end ownership
        # (triapoissonparallelimpl1.F:536-667) and it preserves the lattice numbering exactly, so the DIA offset
        # census stays the original stencil (no pad-jump offsets at shard
        # boundaries, no scrambled boundary nodes).
        P = round_up(-(-max(dofmap.total_dof, 1) // n_shards), lane_pad)
        from pfemfort_jax.dofs.dofmap import reduced_lattice
        red_lat = reduced_lattice(mesh, dofmap)
        if red_lat is not None and len(red_lat) >= 2:
            # Align shard boundaries to whole lattice planes: each shard's
            # rows are then a z-slab of the reduced lattice, enabling the
            # N-D stencil form of the in-shard SpMV (parallel/halo.py:
            # spmv_dia_halo_lattice) instead of 1-D shifted slices.
            plane = int(np.prod(red_lat[1:]))
            P = plane * (-(-P // plane))
        eq_perm = np.arange(dofmap.total_dof, dtype=np.int64)
        eq_node = dofmap.assy_for_soln // ndof
        node_part = np.zeros(mesh.n_node, dtype=np.int32)
        node_part[eq_node] = np.minimum(eq_perm // P, n_shards - 1)
        elem_part = node_part[mesh.conn].min(axis=1).astype(np.int32)
    else:
        elem_part = partition_elements(mesh, n_shards, method=method)
        node_part = nodes_from_elem_partition(mesh, elem_part,
                                              max(n_shards, 1))

        # Part of each free equation = part of its node.
        eq_node = dofmap.assy_for_soln // ndof      # (total_dof,)
        eq_part = node_part[eq_node]

        # Within-shard order: geometric lex of each shard's nodes (dofs of
        # a node stay adjacent, preserving the block-Jacobi node blocks).
        # Bandwidth-reduced local numbering gives the in-shard ELL gather
        # (parallel/dist_ell.py) locality in x.
        node_rank = _within_shard_order(mesh, node_part, n_shards)

        if ndof > 1:
            # NODE-ALIGNED rows: every node with >=1 free equation owns ndof
            # consecutive row slots (component d at slot + d); nodes with
            # partially-eliminated dofs leave padding rows instead of
            # shifting later rows.  Local blocks r//ndof are then TRUE node
            # blocks, which is what makes the per-shard block-Jacobi
            # (the reference default PC, solverpetsc.F:206) extractable by
            # pure strided slicing on the ELL values.
            eq_comp = dofmap.assy_for_soln % ndof
            has_free = np.zeros(mesh.n_node, dtype=bool)
            has_free[eq_node] = True
            nodes_idx = np.nonzero(has_free)[0]
            npart = node_part[nodes_idx].astype(np.int64)
            order_n = np.lexsort((nodes_idx, node_rank[nodes_idx], npart))
            node_slot = np.full(mesh.n_node, -1, dtype=np.int64)
            countsn = np.bincount(npart, minlength=n_shards)
            startn = 0
            for s in range(n_shards):
                c = countsn[s]
                node_slot[nodes_idx[order_n[startn:startn + c]]] = \
                    np.arange(c)
                startn += c
            # P a multiple of lane_pad AND ndof so (P//ndof, ndof) reshapes
            # and lane alignment both hold
            P = round_up(max(int(countsn.max(initial=1)), 1) * ndof,
                         lane_pad * ndof)
            eq_perm = (eq_part.astype(np.int64) * P
                       + node_slot[eq_node] * ndof + eq_comp)
        else:
            counts = np.bincount(eq_part, minlength=n_shards)
            P = round_up(max(int(counts.max(initial=1)), 1), lane_pad)
            order = np.lexsort((np.arange(dofmap.total_dof),
                                node_rank[eq_node], eq_part))
            within = np.zeros(dofmap.total_dof, dtype=np.int64)
            start = 0
            for s in range(n_shards):
                c = counts[s]
                within[order[start:start + c]] = np.arange(c)
                start += c
            eq_perm = (eq_part.astype(np.int64) * P + within).astype(
                np.int64)

    # Remap elem_dof into padded row space (-1 sentinels preserved).
    elem_dof = dofmap.elem_dof
    mapped = np.where(elem_dof >= 0, eq_perm[np.clip(elem_dof, 0, None)], -1)

    pad_lat = None
    if red_lat is not None and len(red_lat) >= 2:
        # identity numbering + plane-aligned shards: the padded row space is
        # itself a lattice (extra all-zero planes at the end), so the
        # stencil SpMV stays available after sharding
        plane = int(np.prod(red_lat[1:]))
        if (n_shards * P) % plane == 0:
            pad_lat = ((n_shards * P) // plane,) + tuple(red_lat[1:])

    pattern = build_pattern(mapped.astype(np.int32), n_shards * P,
                            lane_pad=lane_pad, layout=layout,
                            lattice=pad_lat)
    return ShardedSystem(
        n_shards=n_shards,
        rows_per_shard=P,
        n_rows_padded=n_shards * P,
        dofmap=dofmap,
        pattern=pattern,
        eq_perm=eq_perm,
        elem_part=elem_part,
        node_part=node_part,
    )
