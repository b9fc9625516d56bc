"""Model zoo in PyTorch, counterpart of ``repro.models``: the dense family
(``build_model`` raises for the others) and the decode-cache containers."""
from .model import Model, build_model  # noqa: F401
from . import layers, transformer  # noqa: F401
