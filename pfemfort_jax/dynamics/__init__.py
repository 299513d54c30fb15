from pfemfort_jax.dynamics.explicit import explicit_dynamics, ExplicitResult

__all__ = ["explicit_dynamics", "ExplicitResult"]
