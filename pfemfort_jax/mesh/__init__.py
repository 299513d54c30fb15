from pfemfort_jax.mesh.core import Mesh, ELEMENT_INFO

__all__ = ["Mesh", "ELEMENT_INFO"]
