"""SHRINK core in PyTorch: semantics extraction, base construction,
residual encoding, streamed containers and the segment algebra.  Public
API re-exports."""
from .errors import (  # noqa: F401
    BackpressureError,
    BatcherFinalizedError,
    CircuitOpenError,
    ConfigError,
    CorruptFrameError,
    DeadlineExceededError,
    FormatError,
    LayerCorruptError,
    QuotaExceededError,
    RangeCoverageError,
    ShrinkError,
    TransientError,
    TruncatedArchiveError,
    UnknownSeriesError,
)
from .types import (  # noqa: F401
    Base,
    CompressedSeries,
    PyramidLayer,
    ResidualPyramid,
    ResidualStream,
    Segment,
    ShrinkConfig,
    SubBase,
)
from .phases import (  # noqa: F401
    default_interval_length,
    divide,
    eps_hat_for_level,
    fluctuation_table,
)
from .semantics import (  # noqa: F401
    extract_semantics,
    extract_semantics_batch,
    extract_semantics_py,
)
from .base import base_predictions, construct_base, practical_eps_b  # noqa: F401
from .segment_algebra import (  # noqa: F401
    BaseStats,
    SegmentTable,
    base_aggregate,
    count_cmp,
    segment_table,
)
from .slope import optimized_slope, shortest_decimal_in_interval  # noqa: F401
from .residuals import (  # noqa: F401
    compute_residuals,
    dequantize_exact,
    dequantize_residuals,
    normalize_tiers,
    quantize_exact,
    quantize_exact_batch,
    quantize_pyramid,
    quantize_pyramid_batch,
    quantize_residuals,
    quantize_residuals_batch,
)
from .shrink import (  # noqa: F401
    BYTES_PER_ROW,
    ProgressiveDecoder,
    ShrinkCodec,
    cs_from_bytes,
    cs_to_bytes,
    decompress_at,
    encode_with_base,
    original_size_bytes,
)
from .streaming import (  # noqa: F401
    KnowledgeBase,
    ShrinkStreamCodec,
    decode_range,
    decode_series,
    read_knowledge_base,
    routing_metadata,
)
