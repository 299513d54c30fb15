from pfemfort_jax.io.vtk import write_vtk

__all__ = ["write_vtk"]
