"""Typed error taxonomy of the PyTorch port (counterpart of ``repro.core.errors``).

A copy of the reference taxonomy, so ``repro_torch`` raises the same
classes for the same failures without importing ``repro``.

Every failure the codec, the containers, or the serving layer can raise
derives from :class:`ShrinkError`, which carries *machine-readable
context* — series id, frame index, byte offset, pyramid layer — so a
caller (or a fault-tolerant gateway) can scope its reaction to exactly
the corrupt unit instead of failing the whole query.  The taxonomy:

``ShrinkError`` (subclasses ``ValueError``)
├── ``FormatError``            foreign blob / bad magic / unsupported version
├── ``TruncatedArchiveError``  input cut short at any boundary
├── ``CorruptFrameError``      CRC mismatch or structural corruption
│   └── ``LayerCorruptError``  scoped to one pyramid layer (``layer=``)
├── ``UnknownSeriesError``     series id not present in a container
├── ``RangeCoverageError``     query range empty / not covered / gapped
├── ``ConfigError``            invalid construction parameters
├── ``BatcherFinalizedError``  use-after-finalize on an ingest batcher
├── ``KBReferenceError``       knowledge-base refcount/id accounting broken (``entry=``)
├── ``StaleSnapshotError``     kb_snapshot_ref does not resolve against the store
└── serving/operational
    ├── ``TransientError``     retryable (injected flake, timeout, I/O)
    ├── ``DeadlineExceededError``  per-request deadline blew
    ├── ``BackpressureError``  bounded queue full, request shed
    │   └── ``QuotaExceededError``  per-tenant admission quota exhausted
    └── ``CircuitOpenError``   per-frame breaker open, decode skipped

Deliberately ``ValueError`` at the root: the pre-taxonomy API contract
was "corrupt/foreign/truncated input raises ``ValueError``", and every
existing caller and test that catches ``ValueError`` keeps working;
callers that care about *which* failure catch the subclass.

Degradation semantics built on this taxonomy (what bound survives which
fault) are specified in ``docs/robustness.md``.
"""
from __future__ import annotations

__all__ = [
    "ShrinkError",
    "FormatError",
    "TruncatedArchiveError",
    "CorruptFrameError",
    "LayerCorruptError",
    "UnknownSeriesError",
    "RangeCoverageError",
    "ConfigError",
    "BatcherFinalizedError",
    "KBReferenceError",
    "StaleSnapshotError",
    "TransientError",
    "DeadlineExceededError",
    "BackpressureError",
    "QuotaExceededError",
    "CircuitOpenError",
]


class ShrinkError(ValueError):
    """Base of the taxonomy.  ``message`` is the human diagnosis; the
    keyword context names the corrupt/offending unit so handlers can
    quarantine precisely (all fields optional, ``None`` = not known at
    the raise site)."""

    def __init__(
        self,
        message: str,
        *,
        series_id: int | None = None,
        frame_index: int | None = None,
        offset: int | None = None,
        layer: int | None = None,
        entry: int | None = None,
    ):
        self.series_id = series_id
        self.frame_index = frame_index
        self.offset = offset
        self.layer = layer
        self.entry = entry
        ctx = []
        if series_id is not None:
            ctx.append(f"series={series_id}")
        if frame_index is not None:
            ctx.append(f"frame={frame_index}")
        if layer is not None:
            ctx.append(f"layer={layer}")
        if offset is not None:
            ctx.append(f"offset={offset}")
        if entry is not None:
            ctx.append(f"entry={entry}")
        super().__init__(message + (f" [{', '.join(ctx)}]" if ctx else ""))
        self.message = message

    def context(self) -> dict:
        """The machine-readable context as a plain dict (telemetry)."""
        return {
            "type": type(self).__name__,
            "series_id": self.series_id,
            "frame_index": self.frame_index,
            "offset": self.offset,
            "layer": self.layer,
            "entry": self.entry,
        }


class FormatError(ShrinkError):
    """Not one of ours: bad magic, unsupported version, or a field that
    no writer could have produced (foreign or misidentified input)."""


class TruncatedArchiveError(ShrinkError):
    """Input ends before a declared length/boundary — the archive (or a
    section of it) was cut short."""


class CorruptFrameError(ShrinkError):
    """Stored CRC does not match the bytes, or the structure contradicts
    itself: the unit (frame, container section, blob) cannot be trusted."""


class LayerCorruptError(CorruptFrameError):
    """Corruption scoped to ONE residual-pyramid layer (``layer=`` index).
    Layers above it remain decodable — degradation serves the finest
    intact prefix instead of failing the frame."""


class UnknownSeriesError(ShrinkError):
    """The container has no frames for the requested series id."""


class RangeCoverageError(ShrinkError):
    """The requested sample range is empty, outside the frames, or spans
    a gap between frames."""


class ConfigError(ShrinkError):
    """Invalid construction-time parameters (bad eps ladder, nonpositive
    sizes, missing ``decimals`` for a lossless tier, ...)."""


class BatcherFinalizedError(ShrinkError):
    """An ingest batcher was used after ``finalize()``."""


class KBReferenceError(ShrinkError):
    """Knowledge-base reference accounting is broken: a refcount would go
    negative, an entry id is out of range, or an attach handle is unknown.
    ``entry=`` names the offending KB entry id when one is known."""


class StaleSnapshotError(ShrinkError):
    """A ``kb_snapshot_ref`` does not resolve against the KB store: the
    snapshot version is unknown (evicted, compacted away, or from another
    store lineage), the semantic id disagrees, or a referenced entry id
    was retired.  Containers carrying an inline footer KB fall back to it;
    ref-only containers surface this error."""


# --------------------------------------------------------------------- #
# serving / operational
# --------------------------------------------------------------------- #
class TransientError(ShrinkError):
    """A retryable failure (flaky I/O, injected fault, timeout on a
    backend call).  The gateway's retry policy targets exactly this
    class — corruption errors are permanent and are never retried."""


class DeadlineExceededError(ShrinkError):
    """The request's deadline elapsed before a full-resolution answer
    could be produced."""


class BackpressureError(ShrinkError):
    """The bounded admission queue is full and the request could not be
    shed to degraded (coarse-tier) service."""


class QuotaExceededError(BackpressureError):
    """A tenant's admission quota (token bucket) is exhausted and the
    request could not be shed to a coarser tier.  Subclasses
    :class:`BackpressureError`: quota exhaustion IS backpressure, scoped
    to one tenant instead of the whole gateway — handlers that shed or
    retry-later on backpressure keep working unchanged."""


class CircuitOpenError(ShrinkError):
    """The per-frame circuit breaker is open: this frame failed
    repeatedly and decode attempts are suppressed until the recovery
    window elapses."""
