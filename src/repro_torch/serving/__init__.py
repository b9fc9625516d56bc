"""Serving utilities in PyTorch, counterpart of ``repro.serving``: the
KV-cache store (``kvcache``), the LM decode loop and range-query serving
over streamed SHRKS containers (``batching``)."""
from .kvcache import QuantizedKV, dequantize_cache, promote_caches, quantize_cache  # noqa: F401
from .batching import ContinuousBatcher, RangeQuery, RangeQueryBatcher, Request  # noqa: F401
