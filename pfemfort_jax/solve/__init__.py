from pfemfort_jax.solve.cg import cg_solve, bicgstab_solve, SolveStats

__all__ = ["cg_solve", "bicgstab_solve", "SolveStats"]
