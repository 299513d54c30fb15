from pfemfort_jax.drivers.poisson import solve_poisson
from pfemfort_jax.drivers.elasticity import solve_elasticity

__all__ = ["solve_poisson", "solve_elasticity"]
