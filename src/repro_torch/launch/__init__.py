"""Entry points of the port (counterpart of ``repro.launch``): mesh
construction, ``serve`` and ``train``."""
from .mesh import HW, make_local_mesh, make_production_mesh  # noqa: F401
