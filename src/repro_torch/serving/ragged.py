"""Gateway admission scheduler for ragged multi-sensor ingest, counterpart
of ``repro.serving.ragged``.

Hundreds of sensors publish at rates that span orders of magnitude, so at a
flush the pending buffers form a ragged batch.  ``RaggedBatcher`` turns
that traffic into batched compression:

* ``submit(series_id, chunk)`` appends a sensor's next chunk to its pending
  buffer (no compression on the hot path).
* The batch **flushes** when total pending samples reach ``flush_samples``
  (size) or the oldest pending sample has waited ``flush_deadline_s``
  (deadline, on the injected ``clock``); ``poll()`` checks the deadline
  without new data.
* ``scope="series"`` applies both triggers per series and seals only the
  due series, so frame boundaries depend on each series' own ingest
  history alone (what the sharded fleet relies on).
* A flush runs ONE ragged ``ShrinkCodec.compress_batch`` on the codec's
  device (the card unless ``device="cpu"``: masked cone scans and the
  shared rANS pass run as kernels there) and seals each series' buffer as
  a ``SHRKS`` frame, in series-id order; each frame's sub-base lines feed
  the shared ``KnowledgeBase`` before the next frame is written, so every
  frame's KB epoch and the footer KB equal the reference's.
* ``finalize()`` emits the ``SHRKS`` container, byte-identical to the
  reference batcher's on the same traffic; it is idempotent, and a flush
  after it is a no-op.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

import torch

from ..core.errors import BatcherFinalizedError, ConfigError
from ..core.serialize import FramedWriter
from ..core.shrink import ShrinkCodec, cs_to_bytes
from ..core.streaming import KnowledgeBase
from ..core.types import ShrinkConfig, merge_backend_stats

__all__ = ["RaggedBatcher"]


@dataclasses.dataclass
class _PendingSeries:
    start: int  # absolute sample index of the buffer's first sample
    oldest: Optional[float] = None  # clock() when the buffer became nonempty
    chunks: list = dataclasses.field(default_factory=list)
    samples: int = 0

    def append(self, vals: np.ndarray) -> None:
        self.chunks.append(vals)
        self.samples += int(vals.size)

    def take(self) -> np.ndarray:
        out = np.concatenate(self.chunks) if len(self.chunks) > 1 else self.chunks[0]
        self.chunks = []
        self.samples = 0
        return out


class RaggedBatcher:
    """Bucketed admission scheduler: many concurrent ragged series ->
    batched ragged compression -> ``SHRKS`` frames + shared knowledge base.

    Parameters
    ----------
    config:           ShrinkConfig shared by every series on this gateway.
    eps_targets:      residual resolutions per frame (0.0 = lossless,
                      requires ``decimals``).
    flush_samples:    size trigger — flush when total pending samples reach
                      this (None disables; flush on deadline/finalize only).
    flush_deadline_s: latency trigger — flush when the oldest pending
                      sample has waited this long (None disables).
    max_buckets:      percentile length-buckets per flush (None = scale
                      with series count; see ``ShrinkCodec.compress_batch``).
    semantics:        the reference's scan-route argument, forwarded to
                      ``compress_batch``, where it changes nothing (the
                      port has one scan route, the cone-scan kernel).
    scope:            "batch" (default) applies the triggers to the whole
                      pending pool and a flush seals every pending series;
                      "series" applies both triggers per series and seals
                      only the due ones (shard-invariant frame boundaries
                      — see the module docstring).
    kb:               share a KnowledgeBase across batchers/codecs.
    kb_store:         a ``serving.kbstore.KBStore`` to attach the finalized
                      container's KB to; the footer then carries a
                      ``kb_snapshot_ref`` and (unless ``inline_kb=True``)
                      omits the inline KB.
    inline_kb:        force the inline footer KB on/off; default ``None``
                      = inline exactly when no ``kb_store`` is attached.
    source:           stable attach handle for ``kb_store``.
    clock:            monotonic-seconds source (injectable for tests).
    device:           where flushes compress (default the card).
    """

    def __init__(
        self,
        config: ShrinkConfig,
        eps_targets: list[float],
        decimals: int | None = None,
        backend: str = "rans",
        flush_samples: int | None = 262_144,
        flush_deadline_s: float | None = None,
        max_buckets: int | None = None,
        semantics: str = "auto",
        scope: str = "batch",
        kb: KnowledgeBase | None = None,
        kb_store=None,  # serving.kbstore.KBStore
        inline_kb: bool | None = None,
        source: str | None = None,
        clock: Callable[[], float] = time.monotonic,
        device: torch.device | str | None = None,
    ):
        if 0.0 in eps_targets and decimals is None:
            raise ConfigError("lossless eps target 0.0 requires `decimals`")
        if inline_kb is False and kb_store is None:
            raise ConfigError(
                "inline_kb=False requires a kb_store (a container with "
                "neither an inline KB nor a snapshot ref loses its dictionary)"
            )
        if flush_samples is not None and flush_samples < 1:
            raise ConfigError(f"flush_samples must be >= 1, got {flush_samples}")
        if flush_deadline_s is not None and flush_deadline_s < 0:
            raise ConfigError(
                f"flush_deadline_s must be >= 0, got {flush_deadline_s}"
            )
        if scope not in ("batch", "series"):
            raise ConfigError(f"scope must be 'batch' or 'series', got {scope!r}")
        self.scope = scope
        self.codec = ShrinkCodec(config=config, backend=backend, device=device)
        self.eps_targets = list(eps_targets)
        self.decimals = decimals
        self.flush_samples = flush_samples
        self.flush_deadline_s = flush_deadline_s
        self.max_buckets = max_buckets
        self.semantics = semantics
        self.kb = kb if kb is not None else KnowledgeBase(config)
        self.kb_store = kb_store
        self.inline_kb = inline_kb
        self._store_source = source
        self._store_handle: str | None = None
        self._clock = clock
        self._writer = FramedWriter()
        self._pending: dict[int, _PendingSeries] = {}
        self._series_pos: dict[int, int] = {}  # next absolute sample index
        self._pending_samples = 0
        self._frames: list[tuple[int, int, int]] = []
        self._flushes = 0
        self._samples_in = 0
        self._payload_bytes = 0
        self._backend_stats: dict[str, dict[str, int]] = {}
        self._finalized = False
        self._container: Optional[bytes] = None

    # -- admission ------------------------------------------------------ #
    def submit(self, series_id: int, values_chunk) -> list[tuple[int, int, int]]:
        """Append one series' next chunk; returns the frames sealed by this
        call ([] unless a flush trigger fired)."""
        if self._finalized:
            raise BatcherFinalizedError(
                "batcher already finalized", series_id=int(series_id)
            )
        sid = int(series_id)
        vals = np.asarray(values_chunk, dtype=np.float64).ravel()
        if vals.size:
            st = self._pending.get(sid)
            if st is None:
                st = self._pending[sid] = _PendingSeries(
                    start=self._series_pos.setdefault(sid, 0),
                    oldest=self._clock(),
                )
            st.append(vals)
            self._pending_samples += int(vals.size)
            self._samples_in += int(vals.size)
        return self._maybe_flush()

    def due(self) -> bool:
        """True when a flush trigger (size or deadline) has fired.  Always
        False once finalized: a late deadline timer must not re-seal."""
        if self._finalized or self._pending_samples == 0:
            return False
        if self.scope == "series":
            return bool(self.due_series())
        if self.flush_samples is not None and self._pending_samples >= self.flush_samples:
            return True
        if self.flush_deadline_s is None:
            return False
        oldest = min(ps.oldest for ps in self._pending.values())
        return self._clock() - oldest >= self.flush_deadline_s

    def due_series(self) -> list[int]:
        """The series whose own size/deadline trigger has fired (meaningful
        under ``scope="series"``; [] once finalized)."""
        if self._finalized or not self._pending:
            return []
        now: Optional[float] = None
        out = []
        for sid, ps in self._pending.items():
            if self.flush_samples is not None and ps.samples >= self.flush_samples:
                out.append(sid)
                continue
            if self.flush_deadline_s is not None and ps.oldest is not None:
                if now is None:
                    now = self._clock()
                if now - ps.oldest >= self.flush_deadline_s:
                    out.append(sid)
        return sorted(out)

    def poll(self) -> list[tuple[int, int, int]]:
        """Deadline check with no new data (drive from a timer loop)."""
        return self._maybe_flush()

    def _maybe_flush(self) -> list[tuple[int, int, int]]:
        if self.scope == "series":
            due = self.due_series()
            return self.flush(due) if due else []
        return self.flush() if self.due() else []

    # -- flush / finalize ----------------------------------------------- #
    def flush(self, series_ids=None) -> list[tuple[int, int, int]]:
        """Compress pending buffers as one ragged batch and seal each as a
        SHRKS frame; returns (series_id, t_lo, t_hi) per frame.
        ``series_ids`` restricts the flush to a subset (None = all).

        A flush after ``finalize`` is a NO-OP (returns []), and the buffers
        being flushed are detached from the pending pool *before* any
        compression work: a ``flush_deadline_s`` timer firing ``poll``
        concurrently with ``finalize`` (or reentrantly from inside the
        compression callback) can no longer double-seal the pending pool —
        the second flush simply finds nothing pending."""
        if self._finalized or not self._pending:
            return []
        if series_ids is None:
            sids = sorted(self._pending)
        else:
            sids = sorted(s for s in set(series_ids) if s in self._pending)
            if not sids:
                return []
        taken = [(sid, self._pending.pop(sid)) for sid in sids]
        self._pending_samples -= sum(ps.samples for _, ps in taken)
        arrs = [ps.take() for _, ps in taken]
        css = self.codec.compress_batch(
            arrs,
            eps_targets=self.eps_targets,
            decimals=self.decimals,
            semantics=self.semantics,
            max_buckets=self.max_buckets,
        )
        sealed = []
        for (sid, ps), vals, cs in zip(taken, arrs, css):
            merge_backend_stats(self._backend_stats, cs.backend_stats())
            payload = cs_to_bytes(cs)
            self.kb.ingest_base(cs.base)
            t_lo = ps.start
            t_hi = t_lo + int(vals.size)
            self._writer.add_frame(sid, t_lo, t_hi, self.kb.epoch, payload)
            self._payload_bytes += len(payload)
            self._series_pos[sid] = t_hi
            sealed.append((sid, t_lo, t_hi))
        self._frames.extend(sealed)
        self._flushes += 1
        return sealed

    def finalize(self) -> bytes:
        """Flush the remainder and emit the SHRKS container (knowledge base
        in the footer).  Idempotent: a retried ``finalize`` (e.g. after a
        delivery timeout upstream) returns the SAME bytes instead of
        corrupting writer state."""
        if self._finalized:
            return self._container
        self.flush()
        self._finalized = True
        ref = None
        if self.kb_store is not None:
            rec = self.kb_store.attach_kb(self.kb, source=self._store_source)
            self._store_handle = rec.handle
            ref = rec.ref
        inline = self.inline_kb if self.inline_kb is not None else self.kb_store is None
        self._container = self._writer.finish(
            self.kb.to_bytes() if inline else b"", snapshot_ref=ref
        )
        if self.kb_store is not None:
            self.kb_store.register_container(self._store_handle, self._container)
        return self._container

    # -- introspection -------------------------------------------------- #
    @property
    def sealed_frames(self) -> list[tuple[int, int, int]]:
        return list(self._frames)

    def stats(self) -> dict:
        return {
            "series": len(self._series_pos),
            "flushes": self._flushes,
            "frames": len(self._frames),
            "samples_ingested": self._samples_in,
            "samples_pending": self._pending_samples,
            "payload_bytes": self._payload_bytes,
            "backends": {b: dict(d) for b, d in self._backend_stats.items()},
            "kb": self.kb.stats(),
        }
