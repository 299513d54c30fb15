from pfemfort_jax.assembly.pattern import AssemblyPattern, build_pattern
from pfemfort_jax.assembly.assemble import (
    assemble_matrix,
    assemble_dia_values,
    assemble_ell_values,
    assemble_rhs,
    dirichlet_rhs_correction,
    scatter_full,
)

__all__ = [
    "AssemblyPattern",
    "build_pattern",
    "assemble_matrix",
    "assemble_dia_values",
    "assemble_ell_values",
    "assemble_rhs",
    "dirichlet_rhs_correction",
    "scatter_full",
]
