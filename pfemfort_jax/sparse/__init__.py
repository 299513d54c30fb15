from pfemfort_jax.sparse.formats import ELLMatrix
from pfemfort_jax.sparse.spmv import spmv_ell

__all__ = ["ELLMatrix", "spmv_ell"]
