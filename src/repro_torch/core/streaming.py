"""Streaming ingest for SHRINK in PyTorch, counterpart of
``repro.core.streaming``: chunk-at-a-time compression on a gateway.

* ``ShrinkStreamCodec`` — stateful, multi-series.  ``ingest(chunk,
  series_id)`` advances an *incremental* cone scan whose open-cone state
  (origin, adaptive threshold, running slope intersection) carries across
  chunk boundaries, so segment breaks, and every byte after them, are
  identical to the one-shot scan over the concatenated data.  Sealed
  frames accumulate; ``finalize()`` emits a ``SHRKS`` framed container
  byte-identical to the reference's (layout in docs/wire-format.md).
* ``KnowledgeBase`` — the gateway-resident dictionary of semantic lines
  (fluctuation level, origin grid index, slope), deduplicated across
  chunks and series, with ``merge``, ``release`` and the ``SHKB`` blob.
* ``decode_range`` / ``decode_series`` — random access: only the frames
  overlapping [t0, t1) are decoded (and CRC-checked), each at the
  cheapest sufficient layer prefix of its pyramid.

Where the work runs: the incremental recurrence (``_advance``), the
knowledge base and the framing are host code, as in the reference: the
recurrence is a sequential state machine with a data-dependent exit per
chunk, which on the card would cost a launch and a sync a step.  Frame
encoding (``_drain_pending``: base predictions, the pyramid quantizer,
entropy features and the rANS kernels), the deferred-mode frame scans
(the cone-scan kernel) and decoding (the rANS decode kernel) run on the
codec's ``device`` (default the card).

Exactness contract: every frame payload equals ``ShrinkCodec.compress``
of that frame's slice under the pinned parameters, for ANY chunking.
``value_range`` pins the fluctuation denominator and ``n_hint`` (else
``frame_len``) pins the interval length L; with both the scan runs
incrementally, without them it is deferred to frame seal.
"""
from __future__ import annotations

import dataclasses
import math
import struct
import zlib

import numpy as np
import torch

from .base import construct_base, origin_index
from .device import resolve_device
from .errors import (
    ConfigError,
    FormatError,
    KBReferenceError,
    RangeCoverageError,
    ShrinkError,
    TruncatedArchiveError,
    UnknownSeriesError,
)
from .phases import default_interval_length, divide, eps_hat_for_level
from .semantics import extract_semantics
from .serialize import (
    FramedWriter,
    _read_svarint,
    _write_svarint,
    frame_payload,
    kb_snapshot_id,
    parse_framed_container,
    read_snapshot_ref,
    read_varint,
    write_varint,
)
from .shrink import (
    cs_from_bytes,
    cs_to_bytes,
    decompress_at,
    encode_frames_with_bases,
    encode_with_base,
)
from .types import Base, FrameMeta, Segment, ShrinkConfig, merge_backend_stats

__all__ = [
    "KnowledgeBase",
    "ShrinkStreamCodec",
    "decode_range",
    "decode_series",
    "read_knowledge_base",
    "routing_metadata",
]

_INF = math.inf
# Deferred-encode watermark: collected frames accumulate until this many
# samples are pending, then drain through one batched residual + entropy
# pass, so the per-pass launches and copies are shared by many frames even
# when callers feed small chunks.
_PENDING_ENCODE_SAMPLES = 128 * 1024
_KB_MAGIC = b"SHKB"
_KB_VERSION = 1
_RAW_SLOPE = 255


# --------------------------------------------------------------------- #
# Knowledge base: deduplicating dictionary of semantic lines
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class KBEntry:
    """One deduplicated semantic line: value = theta(level, origin_idx) at
    the segment start, advancing by ``slope`` per sample.  ``refs`` counts
    the sub-bases (across all frames and series) that use this line."""

    level: int
    origin_idx: int
    slope: float
    slope_digits: int
    refs: int = 0


def _slope_key(slope: float, digits: int) -> tuple:
    if digits <= 13:
        return (digits, int(round(slope * 10**digits)))
    return (_RAW_SLOPE, struct.pack("<d", slope))


class KnowledgeBase:
    """Gateway-resident, append-only dictionary of (level, origin, slope)
    lines shared across chunks and series.

    Entries are identified positionally: the container records each
    frame's ``kb_epoch`` (= entry count at seal time), so entry ids below
    a frame's epoch were known when that frame was written.  ``merge``
    folds another gateway's KB in (summing refcounts) and returns the id
    remap; ``to_bytes``/``from_bytes`` spill/restore the whole dictionary.
    """

    def __init__(self, config: ShrinkConfig):
        self.config = config
        self.entries: list[KBEntry] = []
        self._index: dict[tuple, int] = {}

    # -- identity ------------------------------------------------------ #
    @property
    def epoch(self) -> int:
        """Number of entries; frames record this at seal time."""
        return len(self.entries)

    def theta_of(self, entry: KBEntry) -> float:
        return entry.origin_idx * eps_hat_for_level(entry.level, self.config)

    def _find_or_add(self, level: int, oidx: int, slope: float, digits: int) -> int:
        key = (level, oidx) + _slope_key(slope, digits)
        eid = self._index.get(key)
        if eid is None:
            eid = len(self.entries)
            self.entries.append(
                KBEntry(level=level, origin_idx=oidx, slope=slope, slope_digits=digits)
            )
            self._index[key] = eid
        return eid

    # -- ingest / merge ------------------------------------------------ #
    def ingest_base(self, base) -> list[int]:
        """Register every sub-base of a sealed frame's base; returns the
        entry id for each (deduplicated, refcount bumped)."""
        ids = []
        for sb in base.subbases:
            oidx = origin_index(sb.theta, sb.level, self.config)
            eid = self._find_or_add(sb.level, oidx, sb.slope, sb.slope_digits)
            self.entries[eid].refs += 1
            ids.append(eid)
        return ids

    def merge(self, other: "KnowledgeBase") -> list[int]:
        """Fold ``other`` into self (e.g. two gateways syncing).  Returns
        ``remap`` with ``remap[other_id] == self_id``; refcounts sum."""
        for attr in ("eps_b", "lam", "beta_levels"):
            if getattr(self.config, attr) != getattr(other.config, attr):
                raise ConfigError(
                    f"cannot merge knowledge bases with different configs ({attr})"
                )
        remap = []
        for e in other.entries:
            eid = self._find_or_add(e.level, e.origin_idx, e.slope, e.slope_digits)
            self.entries[eid].refs += e.refs
            remap.append(eid)
        return remap

    def canonical(self) -> dict[tuple, int]:
        """Insertion-order-invariant view: ``{(level, origin_idx,
        slope_key...): refs}``.  Two KBs that hold the same lines with the
        same total refcounts — e.g. the single-process KB versus the merge
        of shard KBs in ANY order — have equal canonical maps even though
        their positional entry ids differ."""
        out: dict[tuple, int] = {}
        for e in self.entries:
            key = (e.level, e.origin_idx) + _slope_key(e.slope, e.slope_digits)
            out[key] = out.get(key, 0) + e.refs
        return out

    def snapshot_id(self) -> int:
        """Semantic snapshot identity: CRC-32 over the *sorted* canonical
        entries (plus the config triple), so it is invariant under entry
        insertion order and therefore under KB merge order.  Used by the
        fleet to tag KB sync epochs; the companion
        ``serialize.kb_snapshot_id`` identifies one concrete serialized
        blob instead."""
        buf = bytearray()
        buf += struct.pack(
            "<ddB", self.config.eps_b, self.config.lam, self.config.beta_levels
        )
        for key, refs in sorted(self.canonical().items()):
            level, oidx, digits, scaled = key
            buf += struct.pack("<Bq", level & 0xFF, oidx)
            buf.append(digits & 0xFF)
            if digits == _RAW_SLOPE:
                buf += scaled  # packed f64 bytes
            else:
                buf += struct.pack("<q", scaled)
            buf += struct.pack("<q", refs)
        return zlib.crc32(bytes(buf)) & 0xFFFFFFFF

    def release(self, entry_ids: list[int]) -> None:
        """Drop one reference per id (e.g. a frame was deleted)."""
        for eid in entry_ids:
            if not 0 <= eid < len(self.entries):
                raise KBReferenceError(
                    f"release of unknown KB entry id {eid} "
                    f"(knowledge base holds {len(self.entries)} entries)",
                    entry=eid,
                )
            e = self.entries[eid]
            if e.refs <= 0:
                raise KBReferenceError(
                    f"refcount underflow on KB entry {eid}", entry=eid
                )
            e.refs -= 1

    def stats(self) -> dict:
        total_refs = sum(e.refs for e in self.entries)
        return {
            "entries": len(self.entries),
            "total_refs": total_refs,
            "dedup_ratio": total_refs / len(self.entries) if self.entries else 1.0,
        }

    # -- spill / restore (SHKB blob; byte layout in docs/wire-format.md) - #
    def to_bytes(self) -> bytes:
        buf = bytearray()
        buf += _KB_MAGIC
        buf.append(_KB_VERSION)
        buf += struct.pack(
            "<ddB", self.config.eps_b, self.config.lam, self.config.beta_levels
        )
        write_varint(buf, len(self.entries))
        prev_idx_by_level: dict[int, int] = {}
        for e in self.entries:
            buf.append(e.level & 0xFF)
            prev = prev_idx_by_level.get(e.level, 0)
            _write_svarint(buf, e.origin_idx - prev)
            prev_idx_by_level[e.level] = e.origin_idx
            if e.slope_digits <= 13:
                buf.append(e.slope_digits)
                _write_svarint(buf, int(round(e.slope * 10**e.slope_digits)))
            else:
                buf.append(_RAW_SLOPE)
                buf += struct.pack("<d", e.slope)
            write_varint(buf, e.refs)
        return bytes(buf)

    @classmethod
    def from_bytes(cls, data: bytes) -> "KnowledgeBase":
        data = bytes(data)
        if len(data) < 5 or data[:4] != _KB_MAGIC:
            raise FormatError("bad knowledge-base magic")
        if data[4] != _KB_VERSION:
            raise FormatError(f"unsupported knowledge-base version {data[4]}")
        try:
            eps_b, lam, beta_levels = struct.unpack_from("<ddB", data, 5)
            pos = 5 + 17
            kb = cls(ShrinkConfig(eps_b=eps_b, lam=lam, beta_levels=beta_levels))
            n, pos = read_varint(data, pos)
            prev_idx_by_level: dict[int, int] = {}
            for _ in range(n):
                level = data[pos]
                pos += 1
                didx, pos = _read_svarint(data, pos)
                oidx = prev_idx_by_level.get(level, 0) + didx
                prev_idx_by_level[level] = oidx
                digits = data[pos]
                pos += 1
                if digits == _RAW_SLOPE:
                    (slope,) = struct.unpack_from("<d", data, pos)
                    pos += 8
                else:
                    scaled, pos = _read_svarint(data, pos)
                    slope = scaled / 10**digits
                refs, pos = read_varint(data, pos)
                # Append positionally: entry i of the blob MUST become entry
                # id i, because frames resolve refs against positional ids
                # (kb_epoch).  A duplicate line would silently collapse via
                # _find_or_add and shift every later id — reject it instead.
                key = (level, oidx) + _slope_key(slope, int(digits))
                if key in kb._index:
                    raise FormatError(
                        f"duplicate knowledge-base line at entry {len(kb.entries)} "
                        f"(same line as entry {kb._index[key]}); no writer "
                        "produces duplicates — positional entry ids would shift"
                    )
                kb._index[key] = len(kb.entries)
                kb.entries.append(
                    KBEntry(
                        level=level,
                        origin_idx=oidx,
                        slope=slope,
                        slope_digits=int(digits),
                        refs=refs,
                    )
                )
        except ShrinkError:
            raise
        except (IndexError, struct.error) as e:
            raise TruncatedArchiveError(
                f"truncated or corrupt knowledge-base blob: {e}"
            ) from e
        if pos != len(data):
            raise FormatError(
                f"trailing garbage after knowledge-base entries "
                f"({len(data) - pos} byte(s) past entry {n - 1 if n else 'header'})"
            )
        return kb


# --------------------------------------------------------------------- #
# Per-series incremental scan state
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class _SeriesState:
    start: int = 0  # absolute sample index of the current frame's first sample
    buf: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(1024, dtype=np.float64)
    )
    n_buf: int = 0
    # incremental cone-scan state (frame-relative indices)
    scan_pos: int = 0
    cone_open: bool = False
    t0: int = 0
    theta: float = 0.0
    level: int = 0
    eps_hat: float = 0.0
    psi_lo: float = -_INF
    psi_hi: float = _INF
    chunk: int = 256
    segments: list[Segment] = dataclasses.field(default_factory=list)
    total_ingested: int = 0

    def append(self, vals: np.ndarray) -> None:
        need = self.n_buf + vals.size
        if need > self.buf.size:
            cap = max(self.buf.size * 2, need)
            grown = np.empty(cap, dtype=np.float64)
            grown[: self.n_buf] = self.buf[: self.n_buf]
            self.buf = grown
        self.buf[self.n_buf : need] = vals
        self.n_buf = need
        self.total_ingested += int(vals.size)

    def drop_prefix(self, n: int) -> None:
        keep = self.n_buf - n
        fresh = np.empty(max(1024, keep), dtype=np.float64)
        fresh[:keep] = self.buf[n : self.n_buf]
        self.buf = fresh
        self.n_buf = keep
        self.start += n
        self.scan_pos = 0
        self.cone_open = False
        self.segments = []
        self.chunk = 256


# --------------------------------------------------------------------- #
# The streaming codec
# --------------------------------------------------------------------- #
class ShrinkStreamCodec:
    """Chunk-at-a-time SHRINK compression with a shared knowledge base.

    Parameters
    ----------
    config:       the ShrinkConfig shared by all series on this gateway.
    eps_targets:  residual resolutions encoded per frame (0.0 = lossless,
                  requires ``decimals``).
    value_range:  (vmin, vmax) spec of the sensors; pins delta_global so
                  the cone scan runs incrementally.  None defers the scan
                  to frame seal with the frame's own range.
    frame_len:    samples per frame; ``None`` means one frame per flush.
    n_hint:       pins the interval length L (Alg. 2); defaults to
                  ``frame_len``.  Both unset forces the deferred scan.
    kb:           share a KnowledgeBase across codecs; default fresh.
    kb_store:     a ``serving.kbstore.KBStore`` to attach the finalized
                  container's KB to; the footer then carries a
                  ``kb_snapshot_ref`` into the store and, unless
                  ``inline_kb=True``, no inline KB.
    inline_kb:    force the inline footer KB on or off; default ``None``
                  = inline exactly when no ``kb_store`` is attached.
    source:       stable attach handle for ``kb_store`` (default a
                  store-assigned handle).
    device:       where frames are encoded (default the card).

    ``ingest`` returns the frames sealed during the call (as
    ``(series_id, t_lo, t_hi)`` tuples); ``flush`` seals partial frames;
    ``finalize`` emits the SHRKS container.
    """

    def __init__(
        self,
        config: ShrinkConfig,
        eps_targets: list[float],
        decimals: int | None = None,
        backend: str = "best",
        value_range: tuple[float, float] | None = None,
        frame_len: int | None = None,
        n_hint: int | None = None,
        kb: KnowledgeBase | None = None,
        kb_store=None,  # serving.kbstore.KBStore (duck-typed: core does not import serving)
        inline_kb: bool | None = None,
        source: str | None = None,
        device: torch.device | str | None = None,
    ):
        if 0.0 in eps_targets and decimals is None:
            raise ConfigError("lossless eps target 0.0 requires `decimals`")
        if frame_len is not None and frame_len < 1:
            raise ConfigError(f"frame_len must be >= 1, got {frame_len}")
        if inline_kb is False and kb_store is None:
            raise ConfigError(
                "inline_kb=False requires a kb_store (a container with "
                "neither an inline KB nor a snapshot ref loses its dictionary)"
            )
        self.config = config
        self.eps_targets = list(eps_targets)
        self.decimals = decimals
        self.backend = backend
        self.device = resolve_device(device)
        self.value_range = (
            (float(value_range[0]), float(value_range[1])) if value_range else None
        )
        self.frame_len = frame_len
        self.n_hint = int(n_hint) if n_hint is not None else None
        self.kb = kb if kb is not None else KnowledgeBase(config)
        self.kb_store = kb_store
        self.inline_kb = inline_kb
        self._store_source = source
        self._store_handle: str | None = None
        n_for_l = self.n_hint if self.n_hint is not None else frame_len
        self.incremental = self.value_range is not None and n_for_l is not None
        if self.incremental:
            self._L = default_interval_length(int(n_for_l), config)
            self._delta = self.value_range[1] - self.value_range[0]
        self._series: dict[int, _SeriesState] = {}
        self._sealed: list[tuple[int, int, int, int, bytes]] = []
        # frames collected but not yet residual-encoded (see
        # _PENDING_ENCODE_SAMPLES): frames completed by different ingest
        # calls still share one batched encode
        self._pending: list[tuple[int, int, np.ndarray, Base, int, int]] = []
        self._pending_n = 0
        # running per-backend routing tally of every sealed layer payload
        self._backend_stats: dict[str, dict[str, int]] = {}

    # -- ingest -------------------------------------------------------- #
    def ingest(self, values_chunk, series_id: int = 0) -> list[tuple[int, int, int]]:
        """Feed the next chunk of one series; returns frames sealed now."""
        vals = np.asarray(values_chunk, dtype=np.float64).ravel()
        st = self._series.setdefault(int(series_id), _SeriesState())
        if vals.size:
            st.append(vals)
        sealed = []
        if self.frame_len is not None:
            while st.n_buf >= self.frame_len:
                if self.incremental:
                    self._advance(st, avail=self.frame_len, final=True)
                p = self._collect(int(series_id), st, self.frame_len)
                self._pending.append(p)
                self._pending_n += p[2].size
                sealed.append((p[1], p[4], p[5]))
            if self._pending_n >= _PENDING_ENCODE_SAMPLES:
                self._drain_pending()
        if self.incremental and st.n_buf:
            self._advance(st, avail=st.n_buf, final=False)
        return sealed

    def flush(self, series_id: int | None = None) -> list[tuple[int, int, int]]:
        """Seal the open (partial) frame of one series, or of all series,
        and encode every pending frame."""
        sids = [series_id] if series_id is not None else sorted(self._series)
        sealed = []
        for sid in sids:
            st = self._series.get(sid)
            if st is None or st.n_buf == 0:
                continue
            if self.incremental:
                self._advance(st, avail=st.n_buf, final=True)
            p = self._collect(sid, st, st.n_buf)
            self._pending.append(p)
            self._pending_n += p[2].size
            sealed.append((p[1], p[4], p[5]))
        self._drain_pending()
        return sealed

    def finalize(self) -> bytes:
        """Flush everything and emit the SHRKS framed container (frames in
        seal order, the knowledge base in the footer).  With a
        ``kb_store`` the KB is attached to the store instead and the
        footer carries a ``kb_snapshot_ref`` (and the inline KB only when
        ``inline_kb=True``); the container is registered with the store
        for compaction re-basing."""
        self.flush()
        w = FramedWriter()
        for sid, t_lo, t_hi, epoch, payload in self._sealed:
            w.add_frame(sid, t_lo, t_hi, epoch, payload)
        ref = None
        if self.kb_store is not None:
            # a stable handle makes a re-finalize a replace, not a double count
            rec = self.kb_store.attach_kb(
                self.kb, source=self._store_handle or self._store_source
            )
            self._store_handle = rec.handle
            ref = rec.ref
        inline = self.inline_kb if self.inline_kb is not None else self.kb_store is None
        blob = w.finish(self.kb.to_bytes() if inline else b"", snapshot_ref=ref)
        if self.kb_store is not None:
            self.kb_store.register_container(self._store_handle, blob)
        return blob

    @property
    def sealed_frames(self) -> list[tuple[int, int, int, int]]:
        """(series_id, t_lo, t_hi, kb_epoch) of every sealed frame so far."""
        return [(sid, lo, hi, ep) for sid, lo, hi, ep, _ in self._sealed]

    def stats(self) -> dict:
        self._drain_pending()  # payload_bytes counts encoded frames only
        payload_bytes = sum(len(p) for *_, p in self._sealed)
        ingested = sum(st.total_ingested for st in self._series.values())
        return {
            "series": len(self._series),
            "frames": len(self._sealed),
            "samples_ingested": ingested,
            "samples_sealed": sum(hi - lo for _, lo, hi, _, _ in self._sealed),
            "payload_bytes": payload_bytes,
            "backends": {b: dict(d) for b, d in self._backend_stats.items()},
            "kb": self.kb.stats(),
        }

    # -- incremental cone scan ----------------------------------------- #
    def _advance(self, st: _SeriesState, avail: int, final: bool) -> None:
        """Consume buffered samples [st.scan_pos, avail) of the current
        frame on the host.  Mirrors the reference's one-shot host scan
        (``repro.core.semantics.extract_semantics``) expression for
        expression, with the same prefix-min/max recurrence, so the closed
        segments are bit-identical to the one-shot scan of the frame slice
        (and to the cone-scan kernel's) however ingest chunked the data.
        ``final`` means ``avail`` is the frame end: the open cone closes
        there and division windows truncate there, as at a series end."""
        L = self._L
        maxw = max(L, 2)
        cap = self.frame_len
        buf = st.buf
        while True:
            if not st.cone_open:
                j = st.scan_pos
                if j >= avail:
                    break
                wend = j + maxw if cap is None else min(j + maxw, cap)
                if wend > avail:
                    if not final:
                        break  # wait for look-ahead before opening the cone
                    wend = avail
                theta, level, eps_hat = divide(buf[:wend], j, L, self._delta, self.config)
                st.cone_open = True
                st.t0 = j
                st.theta, st.level, st.eps_hat = theta, level, eps_hat
                st.psi_lo, st.psi_hi = -_INF, _INF
                st.chunk = 256
                st.scan_pos = j + 1
            i, theta, eps_hat = st.t0, st.theta, st.eps_hat
            closed = False
            j = st.scan_pos
            while j < avail:
                end = min(avail, j + st.chunk)
                dt = np.arange(j - i, end - i, dtype=np.float64)
                seg_vals = buf[j:end]
                hi = (seg_vals + (eps_hat - theta)) / dt
                lo = (seg_vals - (eps_hat + theta)) / dt
                run_hi = np.minimum(np.minimum.accumulate(hi), st.psi_hi)
                run_lo = np.maximum(np.maximum.accumulate(lo), st.psi_lo)
                viol = run_lo > run_hi
                if viol.any():
                    idx = int(np.argmax(viol))
                    if idx > 0:
                        st.psi_hi = float(run_hi[idx - 1])
                        st.psi_lo = float(run_lo[idx - 1])
                    k = j + idx
                    st.segments.append(
                        Segment(
                            theta=theta, level=st.level, psi_lo=st.psi_lo,
                            psi_hi=st.psi_hi, t0=i, length=k - i,
                        )
                    )
                    st.cone_open = False
                    st.scan_pos = k
                    closed = True
                    break
                st.psi_hi = float(run_hi[-1])
                st.psi_lo = float(run_lo[-1])
                j = end
                st.chunk = min(st.chunk * 2, 65536)
            if closed:
                continue  # a new cone opens at the violation point
            st.scan_pos = avail
            if final and st.cone_open:
                st.segments.append(
                    Segment(
                        theta=theta, level=st.level, psi_lo=st.psi_lo,
                        psi_hi=st.psi_hi, t0=st.t0, length=avail - st.t0,
                    )
                )
                st.cone_open = False
            break

    # -- frame sealing ------------------------------------------------- #
    def _collect(
        self, series_id: int, st: _SeriesState, frame_n: int
    ) -> tuple[int, int, np.ndarray, Base, int, int]:
        """Close one frame: fix its semantics and base, advance the
        knowledge base (epoch order is collect order), reserve its slot in
        the sealed log, and leave the residual encoding to
        ``_drain_pending``."""
        frame_vals = st.buf[:frame_n].copy()
        if self.incremental:
            segments = st.segments
            vmin, vmax = self.value_range
        else:
            segments = extract_semantics(
                torch.as_tensor(frame_vals, device=self.device), self.config,
                value_range=self.value_range, n_hint=self.n_hint,
            )
            if self.value_range is not None:
                vmin, vmax = self.value_range
            else:  # the frame's own range, reduced by numpy as the reference does
                vmin, vmax = float(frame_vals.min()), float(frame_vals.max())
        base = construct_base(segments, frame_n, float(vmin), float(vmax), self.config)
        self.kb.ingest_base(base)
        t_lo, t_hi = st.start, st.start + frame_n
        slot = len(self._sealed)
        self._sealed.append((series_id, t_lo, t_hi, self.kb.epoch, b""))
        st.drop_prefix(frame_n)
        return (slot, series_id, frame_vals, base, t_lo, t_hi)

    def _drain_pending(self) -> None:
        """Residual-encode every deferred frame on the codec's device and
        fill its reserved payload slot.  Equal-length frames share one
        batched pass; odd sizes (partial flush frames) encode singly.  Both
        give the same bytes."""
        pending, self._pending = self._pending, []
        self._pending_n = 0
        if not pending:
            return
        by_size: dict[int, list[tuple[int, int, np.ndarray, Base, int, int]]] = {}
        for p in pending:
            by_size.setdefault(p[2].size, []).append(p)
        for group in by_size.values():
            if len(group) == 1:
                _, _, frame_vals, base, _, _ = group[0]
                cs_list = [
                    encode_with_base(
                        torch.as_tensor(frame_vals, device=self.device), base,
                        self.eps_targets, self.decimals, backend=self.backend,
                    )
                ]
            else:
                cs_list = encode_frames_with_bases(
                    torch.as_tensor(np.stack([p[2] for p in group]), device=self.device),
                    [p[3] for p in group],
                    self.eps_targets,
                    self.decimals,
                    backend=self.backend,
                )
            for (slot, _sid, _vals, _base, _lo, _hi), cs in zip(group, cs_list):
                merge_backend_stats(self._backend_stats, cs.backend_stats())
                sid, lo, hi, epoch, _ = self._sealed[slot]
                self._sealed[slot] = (sid, lo, hi, epoch, cs_to_bytes(cs))


# --------------------------------------------------------------------- #
# Random-access decode
# --------------------------------------------------------------------- #
def _series_frames(blob: bytes, series_id: int) -> list[FrameMeta]:
    metas, _ = parse_framed_container(blob)
    frames = sorted(
        (m for m in metas if m.series_id == series_id), key=lambda m: m.t_lo
    )
    if not frames:
        raise UnknownSeriesError(
            f"no frames for series {series_id} in container", series_id=series_id
        )
    return frames


def decode_range(
    blob: bytes, series_id: int, t0: int, t1: int, eps: float,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Reconstruct samples [t0, t1) of one series at resolution ``eps`` on
    ``device`` (default the card), decoding (and CRC-checking) only the
    frames that overlap the range.  Equal to
    ``decode_series(blob, series_id, eps)[t0:t1]``."""
    return _decode_range_frames(
        blob, _series_frames(blob, series_id), series_id, t0, t1, eps, resolve_device(device)
    )


def _decode_range_frames(
    blob: bytes, frames: list[FrameMeta], series_id: int, t0: int, t1: int, eps: float,
    device: torch.device,
) -> torch.Tensor:
    if t1 <= t0:
        raise RangeCoverageError(f"empty range [{t0}, {t1})", series_id=series_id)
    touched = [m for m in frames if m.t_lo < t1 and m.t_hi > t0]
    if not touched or touched[0].t_lo > t0 or touched[-1].t_hi < t1:
        raise RangeCoverageError(
            f"range [{t0}, {t1}) not covered by series {series_id} frames "
            f"[{frames[0].t_lo}, {frames[-1].t_hi})",
            series_id=series_id,
        )
    out = torch.empty(t1 - t0, dtype=torch.float64, device=device)
    expected = t0
    for i, m in enumerate(touched):
        if m.t_lo > expected:
            raise RangeCoverageError(
                f"gap in series {series_id} frames at sample {expected} "
                f"(frame covering [{m.t_lo}, {m.t_hi}) follows)",
                series_id=series_id, frame_index=i,
            )
        cs = cs_from_bytes(frame_payload(blob, m))
        vals = decompress_at(cs, eps, device)
        lo, hi = max(t0, m.t_lo), min(t1, m.t_hi)
        out[lo - t0 : hi - t0] = vals[lo - m.t_lo : hi - m.t_lo]
        expected = hi
    return out


def decode_series(
    blob: bytes, series_id: int, eps: float, device: torch.device | str | None = None
) -> torch.Tensor:
    """Full reconstruction of one series (all frames concatenated)."""
    frames = _series_frames(blob, series_id)
    return _decode_range_frames(
        blob, frames, series_id, frames[0].t_lo, frames[-1].t_hi, eps, resolve_device(device)
    )


def read_knowledge_base(blob: bytes) -> KnowledgeBase | None:
    """The knowledge base in the container footer, or ``None`` for
    containers written without one."""
    _, kb_bytes = parse_framed_container(blob)
    return KnowledgeBase.from_bytes(kb_bytes) if kb_bytes else None


def routing_metadata(blob: bytes) -> dict:
    """The routing view of a ``SHRKS`` container: its series, every
    frame's KB epoch, the ids of the footer's KB snapshot, whether that
    snapshot covers every frame (``self_contained``: each ``kb_epoch`` <=
    the footer KB's entry count), and the ``kb_snapshot_ref`` of a
    ref-mode container (``None`` otherwise)."""
    metas, kb_bytes = parse_framed_container(blob)
    ref = read_snapshot_ref(blob)
    kb = KnowledgeBase.from_bytes(kb_bytes) if kb_bytes else None
    max_epoch = max((m.kb_epoch for m in metas), default=0)
    return {
        "frames": [(m.series_id, m.t_lo, m.t_hi, m.kb_epoch) for m in metas],
        "series_ids": sorted({m.series_id for m in metas}),
        "kb_entries": kb.epoch if kb is not None else 0,
        "kb_snapshot_id": kb_snapshot_id(kb_bytes),
        "kb_semantic_id": kb.snapshot_id() if kb is not None else 0,
        "max_frame_epoch": max_epoch,
        "self_contained": kb is not None and max_epoch <= kb.epoch,
        "kb_ref": (
            {
                "version": ref.version,
                "entries": ref.entries,
                "sem_id": ref.sem_id,
                "n_remap": len(ref.remap),
            }
            if ref is not None
            else None
        ),
    }
