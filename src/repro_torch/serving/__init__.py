"""Serving utilities in PyTorch, counterpart of ``repro.serving``: the
KV-cache store (``kvcache``) and range-query serving over streamed SHRKS
containers (``batching``)."""
from .batching import RangeQuery, RangeQueryBatcher  # noqa: F401
