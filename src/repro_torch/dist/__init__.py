"""repro_torch.dist — the device mesh the distributed stencil executor
runs over (the mesh part of ``repro.dist``; the LM's sharding rules are
not ported yet)."""

from .sharding import Mesh, make_auto_mesh

__all__ = ["Mesh", "make_auto_mesh"]
