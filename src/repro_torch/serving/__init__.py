"""Serving in PyTorch, counterpart of ``repro.serving``: the KV-cache store
(``kvcache``), the LM decode loop and range-query serving over streamed
SHRKS containers (``batching``), the ragged multi-sensor ingest scheduler
(``ragged``), the fault-tolerant gateway (``gateway``), the sharded
multi-tenant fleet (``fleet``) and the cross-archive KB store
(``kbstore``)."""
from .kvcache import QuantizedKV, dequantize_cache, promote_caches, quantize_cache  # noqa: F401
from .batching import ContinuousBatcher, RangeQuery, RangeQueryBatcher, Request  # noqa: F401
from .ragged import RaggedBatcher  # noqa: F401
from .gateway import CircuitBreaker, FaultTolerantGateway, RetryPolicy  # noqa: F401
from .fleet import ShrinkFleet, TenantQuota  # noqa: F401
from .kbstore import AttachRecord, KBStore, StoreSnapshot, resolve_container_kb  # noqa: F401
