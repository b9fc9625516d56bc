"""Entry points of the port (counterpart of ``repro.launch``): mesh
construction, the dry run and its cost counter, ``serve`` and ``train``."""
from .mesh import HW, make_local_mesh, make_production_mesh  # noqa: F401
