"""SHRINK core in PyTorch: semantics extraction, base construction,
residual encoding.  Public API re-exports."""
from .errors import (  # noqa: F401
    ConfigError,
    CorruptFrameError,
    FormatError,
    LayerCorruptError,
    ShrinkError,
    TruncatedArchiveError,
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
from .phases import default_interval_length, eps_hat_for_level, fluctuation_table  # noqa: F401
from .semantics import extract_semantics, extract_semantics_batch  # noqa: F401
from .base import base_predictions, construct_base, practical_eps_b  # noqa: F401
from .slope import optimized_slope, shortest_decimal_in_interval  # noqa: F401
from .residuals import normalize_tiers, quantize_pyramid, quantize_pyramid_batch  # noqa: F401
from .shrink import (  # noqa: F401
    BYTES_PER_ROW,
    ProgressiveDecoder,
    ShrinkCodec,
    cs_from_bytes,
    cs_to_bytes,
    decompress_at,
    encode_with_base,
)
