from pfemfort_jax.utils.timing import Timer, timed

__all__ = ["Timer", "timed"]
