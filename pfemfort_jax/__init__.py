"""pfemfort_jax — a finite-element framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of PFEMFort
(chennachaos/PFEMFort: Fortran + PETSc + MPI + METIS): 2D/3D Poisson and
linear elasticity on Tria3/Tria6/Quad4/Tetra4/Prism6/Hexa8 meshes with
implicit Krylov solves and explicit central-difference dynamics.

Design (data-parallel, not a port):
  * element kernels are batched over all elements at once (the element axis
    is the vector axis; per-element matrices are tiny unrolled tensors)
    instead of the
    reference's per-element Fortran subroutine calls
    (/root/reference/src/elementutilitiespoisson.F:23-193),
  * assembly is a statically-permuted gather + sorted segment-sum into a
    CSR/ELL global matrix instead of MatSetValues stashing
    (/root/reference/src/solverpetsc.F:328-401),
  * the Krylov layer (CG/BiCGStab + Jacobi/block-Jacobi) is pure JAX with
    `lax.while_loop`, shardable with `shard_map` + `psum` over a device mesh
    instead of PETSc KSP over MPI (/root/reference/src/solverpetsc.F:92-105),
  * mesh partitioning is coordinate-RCB / greedy-kway (host or native C++)
    instead of METIS (/root/reference/src/meshpartitioncpp.cpp:321-341).
"""

from pfemfort_jax.mesh.core import Mesh, ELEMENT_INFO
from pfemfort_jax.mesh import generate, io as mesh_io
from pfemfort_jax.dofs.dofmap import DofMap, build_dofmap
from pfemfort_jax.solve.cg import cg_solve, bicgstab_solve, SolveStats
from pfemfort_jax.drivers.poisson import solve_poisson
from pfemfort_jax.drivers.elasticity import solve_elasticity
from pfemfort_jax.dynamics.explicit import explicit_dynamics

__version__ = "0.1.0"

__all__ = [
    "Mesh",
    "ELEMENT_INFO",
    "generate",
    "mesh_io",
    "DofMap",
    "build_dofmap",
    "cg_solve",
    "bicgstab_solve",
    "SolveStats",
    "solve_poisson",
    "solve_elasticity",
    "explicit_dynamics",
]
