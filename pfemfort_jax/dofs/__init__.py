from pfemfort_jax.dofs.dofmap import DofMap, build_dofmap

__all__ = ["DofMap", "build_dofmap"]
