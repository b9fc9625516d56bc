"""Model zoo in PyTorch, counterpart of ``repro.models``: every family of
the reference's configs, and the decode-cache containers."""
from .model import Model, build_model  # noqa: F401
from . import layers, transformer  # noqa: F401
