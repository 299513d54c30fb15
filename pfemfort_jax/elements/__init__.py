from pfemfort_jax.elements.quadrature import gauss_rule
from pfemfort_jax.elements.basis import tabulate_basis

__all__ = ["gauss_rule", "tabulate_basis"]
