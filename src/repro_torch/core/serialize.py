"""Byte-level serialization of the knowledge base and the residual pyramid,
counterpart of ``repro.core.serialize``: the ``SHRB`` base blob, the
``SHRR`` v3 residual pyramid blob and the ``SHRKS`` v2 framed stream
container (append-only frames, a CRC'd footer with the frame directory,
the knowledge base and an optional ``kb_snapshot_ref``, a 16-byte tail),
byte for byte the reference's layouts (normative spec in
``docs/wire-format.md``).  Host code: a few varints per segment, a
directory per series, a CRC per frame.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

from .base import origin_index
from .errors import (
    BatcherFinalizedError,
    ConfigError,
    CorruptFrameError,
    FormatError,
    LayerCorruptError,
    ShrinkError,
    TruncatedArchiveError,
)
from .phases import eps_hat_for_level
from .types import (
    Base,
    FrameMeta,
    PyramidLayer,
    ResidualPyramid,
    ResidualStream,
    ShrinkConfig,
    SubBase,
)

__all__ = [
    "write_varint",
    "read_varint",
    "encode_base",
    "decode_base",
    "pyramid_layers",
    "encode_pyramid",
    "decode_pyramid",
    "FramedWriter",
    "parse_framed_container",
    "frame_payload",
    "kb_snapshot_id",
    "KBSnapshotRef",
    "read_snapshot_ref",
]

_BASE_MAGIC = b"SHRB"
_RES_MAGIC = b"SHRR"
_VERSION = 1
_RES_VERSION = 3
_MODE_CODE = {"midpoint": 0, "exact": 1, "identity": 2}
_MODE_NAME = {v: k for k, v in _MODE_CODE.items()}
_RAW_SLOPE = 255
_STREAM_MAGIC = b"SHRKS"
_STREAM_END_MAGIC = b"SHRE"
# v2 appended the kb_snapshot_ref section (flag byte + optional ref) to the
# footer, after the inline knowledge-base section.  v1 blobs are rejected.
_STREAM_VERSION = 2
_TAIL_LEN = 8 + 4 + 4  # u64 footer offset + u32 footer crc + end magic


def write_varint(buf: bytearray, x: int) -> None:
    if x < 0:
        raise FormatError("varint must be non-negative")
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def read_varint(data: bytes, pos: int) -> tuple[int, int]:
    shift = 0
    out = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not (b & 0x80):
            return out, pos
        shift += 7


def _write_svarint(buf: bytearray, x: int) -> None:
    write_varint(buf, (x << 1) ^ (x >> 63) if x < 0 else (x << 1))


def _read_svarint(data: bytes, pos: int) -> tuple[int, int]:
    z, pos = read_varint(data, pos)
    return (z >> 1) ^ -(z & 1), pos


def encode_base(base: Base) -> bytes:
    buf = bytearray()
    buf += _BASE_MAGIC
    buf.append(_VERSION)
    write_varint(buf, base.n)
    buf += struct.pack("<ddB", base.config.eps_b, base.config.lam, base.config.beta_levels)
    buf += struct.pack("<dd", base.vmin, base.vmax)
    write_varint(buf, len(base.subbases))
    prev_idx_by_level: dict[int, int] = {}
    for sb in base.subbases:
        buf.append(sb.level & 0xFF)
        idx = origin_index(sb.theta, sb.level, base.config)
        prev = prev_idx_by_level.get(sb.level, 0)
        _write_svarint(buf, idx - prev)
        prev_idx_by_level[sb.level] = idx
        if sb.slope_digits <= 13:
            buf.append(sb.slope_digits)
            _write_svarint(buf, int(round(sb.slope * 10**sb.slope_digits)))
        else:
            buf.append(_RAW_SLOPE)
            buf += struct.pack("<d", sb.slope)
        write_varint(buf, len(sb.t0s))
        prev_t = 0
        for t0 in sb.t0s.tolist():
            write_varint(buf, t0 - prev_t)
            prev_t = t0
    return bytes(buf)


def decode_base(data: bytes) -> Base:
    if data[:4] != _BASE_MAGIC:
        raise FormatError("bad base magic")
    try:
        return _decode_base_body(data)
    except (IndexError, struct.error) as e:
        raise TruncatedArchiveError(f"truncated or corrupt base blob: {e}") from e


def _decode_base_body(data: bytes) -> Base:
    pos = 5  # magic + version
    n, pos = read_varint(data, pos)
    eps_b, lam, beta_levels = struct.unpack_from("<ddB", data, pos)
    pos += 17
    vmin, vmax = struct.unpack_from("<dd", data, pos)
    pos += 16
    config = ShrinkConfig(eps_b=eps_b, lam=lam, beta_levels=beta_levels)
    k, pos = read_varint(data, pos)
    subbases: list[SubBase] = []
    prev_idx_by_level: dict[int, int] = {}
    for _ in range(k):
        level = data[pos]
        pos += 1
        didx, pos = _read_svarint(data, pos)
        idx = prev_idx_by_level.get(level, 0) + didx
        prev_idx_by_level[level] = idx
        eps_hat = eps_hat_for_level(level, config)
        theta = idx * eps_hat
        digits = data[pos]
        pos += 1
        if digits == _RAW_SLOPE:
            (slope,) = struct.unpack_from("<d", data, pos)
            pos += 8
            digits = 13
        else:
            scaled, pos = _read_svarint(data, pos)
            slope = scaled / 10**digits
        m, pos = read_varint(data, pos)
        t0s = np.empty(m, dtype=np.int64)
        prev_t = 0
        for i in range(m):
            dt, pos = read_varint(data, pos)
            t0 = prev_t + dt
            prev_t = t0
            t0s[i] = t0
        subbases.append(
            SubBase(
                theta=theta,
                level=level,
                psi_lo=slope,
                psi_hi=slope,
                slope=slope,
                slope_digits=digits,
                t0s=t0s,
                lengths=np.zeros(m, dtype=np.int64),  # filled below
            )
        )
    # Segments partition [0, n): recover lengths from the global t0 order.
    flat = [(int(t0), si, mi) for si, sb in enumerate(subbases) for mi, t0 in enumerate(sb.t0s.tolist())]
    flat.sort()
    for j, (t0, si, mi) in enumerate(flat):
        end = flat[j + 1][0] if j + 1 < len(flat) else n
        subbases[si].lengths[mi] = end - t0
    return Base(n=n, config=config, vmin=vmin, vmax=vmax, subbases=subbases)


# --------------------------------------------------------------------- #
# SHRR v3: the residual pyramid blob (per-layer directory, per-layer
# payload CRCs + one directory CRC; normative byte layout in
# docs/wire-format.md, corruption-scoping semantics in docs/robustness.md)
# --------------------------------------------------------------------- #
def pyramid_layers(
    tiers: list[float],
    streams: list[ResidualStream | None],
    payloads: list[bytes | None],
) -> ResidualPyramid:
    """Assemble a :class:`ResidualPyramid` from the quantizer's per-tier
    streams and their already-entropy-coded payloads (``None`` at tier k
    means an identity layer).  Split from :func:`encode_pyramid` so batch
    compressors can run ONE entropy pass over every (series, layer) stream
    and then assemble each series' pyramid from the shared result."""
    layers: list[PyramidLayer] = []
    for eps, st, payload in zip(tiers, streams, payloads):
        if st is None:
            layers.append(
                PyramidLayer(eps=eps, mode="identity", step=0.0, r_lo=0.0, payload=None)
            )
        else:
            layers.append(
                PyramidLayer(
                    eps=eps, mode=st.mode, step=st.step, r_lo=st.r_lo, payload=payload
                )
            )
    return ResidualPyramid(layers=layers)


def encode_pyramid(pyramid: ResidualPyramid) -> bytes:
    """``SHRR`` v3 blob: version, per-layer directory (eps, mode, quantizer
    params, payload length, **payload CRC32**), a CRC32 of the directory
    section, then the concatenated tagged entropy payloads in layer order.

    The v3 CRC granularity is what makes corruption-scoped degradation
    possible: a flipped byte in layer k's payload fails ONLY layer k's
    CRC, so a reader can quarantine that layer and still serve the intact
    prefix 0..k-1 (the v2 single whole-blob CRC could only say
    "something, somewhere, is wrong")."""
    directory = bytearray()
    body = bytearray()
    for layer in pyramid.layers:
        payload = layer.payload if layer.payload is not None else b""
        if layer.mode == "identity" and payload:
            raise FormatError("identity layer cannot carry a payload")
        directory += struct.pack("<d", layer.eps)
        directory.append(_MODE_CODE[layer.mode])
        directory += struct.pack("<dd", layer.step, layer.r_lo)
        write_varint(directory, len(payload))
        directory += struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF)
        body += payload
    buf = bytearray()
    buf += _RES_MAGIC
    buf.append(_RES_VERSION)
    write_varint(buf, len(pyramid.layers))
    buf += directory
    # the directory gets its own CRC (a flipped eps/step f64 corrupts
    # decode as surely as a payload byte, and the per-layer CRCs live in
    # the directory so they must themselves be trustworthy)
    buf += struct.pack("<I", zlib.crc32(bytes(directory)) & 0xFFFFFFFF)
    buf += body
    return bytes(buf)


def decode_pyramid(data: bytes, strict: bool = True) -> ResidualPyramid:
    """Parse a ``SHRR`` v3 blob.  Raises a :class:`ShrinkError` subclass
    (never a raw ``struct.error``/``IndexError``) on foreign, truncated,
    or corrupt input.

    CRC semantics (normative, docs/wire-format.md): the directory CRC is
    always verified — a blob whose directory cannot be trusted is
    rejected outright (:class:`CorruptFrameError`).  Per-layer payload
    CRCs are then verified eagerly; with ``strict=True`` (the default)
    the first mismatch raises :class:`LayerCorruptError` carrying the
    layer index.  With ``strict=False`` corrupt layers are returned
    **quarantined** (``layer.corrupt = True``, payload withheld) so a
    degraded reader can still decode the finest intact prefix."""
    data = bytes(data)
    if len(data) < 4 or data[:4] != _RES_MAGIC:
        raise FormatError("bad residual pyramid magic: not a SHRR blob")
    if len(data) < 5:
        raise TruncatedArchiveError("truncated SHRR blob: missing version")
    if data[4] != _RES_VERSION:
        raise FormatError(
            f"unsupported SHRR version {data[4]} (this build reads v{_RES_VERSION} "
            "refinement pyramids; older archives must be re-encoded)"
        )
    try:
        pos = 5
        n_layers, pos = read_varint(data, pos)
        dir_start = pos
        dirent: list[tuple[float, int, float, float, int, int]] = []
        for _ in range(n_layers):
            if pos + 25 > len(data):
                raise TruncatedArchiveError(
                    "truncated SHRR blob: layer directory cut short"
                )
            (eps,) = struct.unpack_from("<d", data, pos)
            mode_code = data[pos + 8]
            step, r_lo = struct.unpack_from("<dd", data, pos + 9)
            pos += 25
            ln, pos = read_varint(data, pos)
            if pos + 4 > len(data):
                raise TruncatedArchiveError(
                    "truncated SHRR blob: layer payload CRC cut short"
                )
            (pcrc,) = struct.unpack_from("<I", data, pos)
            pos += 4
            dirent.append((eps, mode_code, step, r_lo, ln, pcrc))
    except ShrinkError:
        raise
    except (IndexError, struct.error) as e:
        raise TruncatedArchiveError(f"truncated or corrupt SHRR blob: {e}") from e
    directory = data[dir_start:pos]
    if pos + 4 > len(data):
        raise TruncatedArchiveError("truncated SHRR blob: missing directory CRC")
    (crc,) = struct.unpack_from("<I", data, pos)
    pos += 4
    if zlib.crc32(directory) & 0xFFFFFFFF != crc:
        raise CorruptFrameError("corrupt SHRR blob: directory CRC mismatch")
    body = data[pos:]
    want = sum(ln for *_, ln, _pcrc in dirent)
    if len(body) < want:
        raise TruncatedArchiveError("truncated SHRR blob: payload section cut short")
    if len(body) != want:
        raise CorruptFrameError("corrupt SHRR blob: payload section length mismatch")
    # the tier-ladder invariant resolve() depends on is normative: eps
    # strictly decreasing coarse -> fine (0.0, the lossless tier, last)
    eps_seq = [e for e, *_ in dirent]
    if any(e < 0.0 for e in eps_seq):
        raise CorruptFrameError("corrupt SHRR blob: negative tier eps")
    if any(b >= a for a, b in zip(eps_seq, eps_seq[1:])):
        raise CorruptFrameError(
            "corrupt SHRR blob: tiers not strictly decreasing coarse -> fine"
        )
    layers: list[PyramidLayer] = []
    off = 0
    for k, (eps, mode_code, step, r_lo, ln, pcrc) in enumerate(dirent):
        if mode_code not in _MODE_NAME:
            raise CorruptFrameError(
                f"corrupt SHRR blob: unknown layer mode {mode_code}", layer=k
            )
        mode = _MODE_NAME[mode_code]
        if mode == "identity" and ln:
            raise CorruptFrameError(
                "corrupt SHRR blob: identity layer with payload", layer=k
            )
        if mode != "identity" and not ln:
            raise CorruptFrameError(
                f"corrupt SHRR blob: {mode} layer without payload", layer=k
            )
        payload = body[off : off + ln] if ln else None
        off += ln
        corrupt = ln > 0 and zlib.crc32(payload) & 0xFFFFFFFF != pcrc
        if corrupt and strict:
            raise LayerCorruptError(
                f"corrupt SHRR blob: layer payload CRC mismatch (tier eps={eps:g})",
                layer=k,
            )
        layers.append(
            PyramidLayer(
                eps=eps, mode=mode, step=step, r_lo=r_lo,
                payload=None if corrupt else payload, corrupt=corrupt,
            )
        )
    return ResidualPyramid(layers=layers)


# --------------------------------------------------------------------- #
# SHRKS framed stream container (layout in docs/wire-format.md)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class KBSnapshotRef:
    """Footer pointer from a container to a ``KBStore`` snapshot (the
    reference's ``serving.kbstore``; the port parses and writes the field
    but has no store yet): instead of (or in addition to) carrying the
    whole knowledge base inline, the container records *which* store
    snapshot holds its lines and how its container-local entry ids map
    into that snapshot's id space.

    ``remap[i]`` is the store entry id of container-local entry ``i``;
    ``refs[i]`` is this container's reference count on that line — so a
    resolver can rebuild the container's private KB view (positional ids,
    exact refcounts) from the snapshot alone.  ``entries`` is the
    snapshot's total id space and ``sem_id`` its order-invariant semantic
    identity (``KnowledgeBase.snapshot_id`` over live lines) — both are
    cross-checked at resolve time so a ref never silently binds to the
    wrong snapshot."""

    version: int
    entries: int
    sem_id: int
    remap: tuple[int, ...] = ()
    refs: tuple[int, ...] = ()


class FramedWriter:
    """Append-only writer for the ``SHRKS`` container.

    Frames are appended in seal order (any interleaving of series);
    ``finish`` emits the directory footer + knowledge-base section + tail.
    """

    def __init__(self) -> None:
        self._buf = bytearray()
        self._buf += _STREAM_MAGIC
        self._buf.append(_STREAM_VERSION)
        self._frames: list[FrameMeta] = []
        self._finished = False

    def add_frame(
        self, series_id: int, t_lo: int, t_hi: int, kb_epoch: int, payload: bytes
    ) -> FrameMeta:
        if self._finished:
            raise BatcherFinalizedError("container already finished")
        if t_hi <= t_lo:
            raise ConfigError(
                f"empty frame range [{t_lo}, {t_hi})", series_id=int(series_id)
            )
        meta = FrameMeta(
            series_id=int(series_id),
            t_lo=int(t_lo),
            t_hi=int(t_hi),
            kb_epoch=int(kb_epoch),
            offset=len(self._buf),
            length=len(payload),
            crc32=zlib.crc32(payload) & 0xFFFFFFFF,
        )
        self._buf += payload
        self._frames.append(meta)
        return meta

    def finish(
        self, kb_bytes: bytes = b"", snapshot_ref: KBSnapshotRef | None = None
    ) -> bytes:
        if self._finished:
            raise BatcherFinalizedError("container already finished")
        self._finished = True
        footer = bytearray()
        write_varint(footer, len(self._frames))
        for m in self._frames:
            write_varint(footer, m.series_id)
            write_varint(footer, m.t_lo)
            write_varint(footer, m.t_hi - m.t_lo)
            write_varint(footer, m.kb_epoch)
            write_varint(footer, m.offset)
            write_varint(footer, m.length)
            footer += struct.pack("<I", m.crc32)
        write_varint(footer, len(kb_bytes))
        footer += kb_bytes
        if snapshot_ref is None:
            footer.append(0)
        else:
            if len(snapshot_ref.remap) != len(snapshot_ref.refs):
                raise ConfigError(
                    "kb_snapshot_ref remap/refs length mismatch "
                    f"({len(snapshot_ref.remap)} != {len(snapshot_ref.refs)})"
                )
            footer.append(1)
            write_varint(footer, snapshot_ref.version)
            write_varint(footer, snapshot_ref.entries)
            footer += struct.pack("<I", snapshot_ref.sem_id & 0xFFFFFFFF)
            write_varint(footer, len(snapshot_ref.remap))
            prev = 0
            for sid in snapshot_ref.remap:
                _write_svarint(footer, sid - prev)
                prev = sid
            for r in snapshot_ref.refs:
                write_varint(footer, r)
        footer_offset = len(self._buf)
        self._buf += footer
        self._buf += struct.pack("<QI", footer_offset, zlib.crc32(bytes(footer)) & 0xFFFFFFFF)
        self._buf += _STREAM_END_MAGIC
        return bytes(self._buf)


def _parse_footer(
    blob: bytes,
) -> tuple[list[FrameMeta], bytes, KBSnapshotRef | None]:
    blob = bytes(blob)
    if len(blob) < 6 or blob[:5] != _STREAM_MAGIC:
        raise FormatError("bad container magic: not a SHRKS blob")
    if blob[5] != _STREAM_VERSION:
        raise FormatError(
            f"unsupported SHRKS version {blob[5]} "
            f"(this build reads v{_STREAM_VERSION} only)"
        )
    if len(blob) < 6 + _TAIL_LEN:
        raise TruncatedArchiveError("truncated SHRKS container: missing tail")
    if blob[-4:] != _STREAM_END_MAGIC:
        raise TruncatedArchiveError(
            "truncated SHRKS container: bad end magic", offset=len(blob) - 4
        )
    footer_offset, footer_crc = struct.unpack_from("<QI", blob, len(blob) - _TAIL_LEN)
    if footer_offset < 6 or footer_offset > len(blob) - _TAIL_LEN:
        raise CorruptFrameError(
            "corrupt SHRKS container: footer offset out of range",
            offset=footer_offset,
        )
    footer = blob[footer_offset : len(blob) - _TAIL_LEN]
    if zlib.crc32(footer) & 0xFFFFFFFF != footer_crc:
        raise CorruptFrameError(
            "corrupt SHRKS container: footer CRC mismatch", offset=footer_offset
        )
    try:
        pos = 0
        n_frames, pos = read_varint(footer, pos)
        metas: list[FrameMeta] = []
        for i in range(n_frames):
            sid, pos = read_varint(footer, pos)
            t_lo, pos = read_varint(footer, pos)
            n, pos = read_varint(footer, pos)
            epoch, pos = read_varint(footer, pos)
            off, pos = read_varint(footer, pos)
            ln, pos = read_varint(footer, pos)
            (crc,) = struct.unpack_from("<I", footer, pos)
            pos += 4
            if off + ln > footer_offset:
                raise CorruptFrameError(
                    "corrupt SHRKS container: frame extends into footer",
                    series_id=sid, frame_index=i, offset=off,
                )
            metas.append(
                FrameMeta(
                    series_id=sid, t_lo=t_lo, t_hi=t_lo + n, kb_epoch=epoch,
                    offset=off, length=ln, crc32=crc,
                )
            )
        kb_len, pos = read_varint(footer, pos)
        if pos + kb_len > len(footer):
            raise CorruptFrameError(
                "corrupt SHRKS container: knowledge-base section length mismatch"
            )
        kb_bytes = bytes(footer[pos : pos + kb_len])
        pos += kb_len
        if pos >= len(footer):
            raise TruncatedArchiveError(
                "truncated SHRKS container: missing kb_snapshot_ref flag"
            )
        flag = footer[pos]
        pos += 1
        ref: KBSnapshotRef | None = None
        if flag == 1:
            version, pos = read_varint(footer, pos)
            entries, pos = read_varint(footer, pos)
            (sem_id,) = struct.unpack_from("<I", footer, pos)
            pos += 4
            n_ref, pos = read_varint(footer, pos)
            remap: list[int] = []
            prev = 0
            for _ in range(n_ref):
                d, pos = _read_svarint(footer, pos)
                prev += d
                if not 0 <= prev < entries:
                    raise CorruptFrameError(
                        "corrupt SHRKS container: kb_snapshot_ref remap id "
                        f"{prev} outside snapshot id space [0, {entries})"
                    )
                remap.append(prev)
            refs: list[int] = []
            for _ in range(n_ref):
                r, pos = read_varint(footer, pos)
                refs.append(r)
            ref = KBSnapshotRef(
                version=version,
                entries=entries,
                sem_id=sem_id,
                remap=tuple(remap),
                refs=tuple(refs),
            )
        elif flag != 0:
            raise CorruptFrameError(
                f"corrupt SHRKS container: bad kb_snapshot_ref flag {flag}"
            )
        if pos != len(footer):
            raise CorruptFrameError(
                "corrupt SHRKS container: trailing bytes after footer "
                f"({len(footer) - pos} byte(s))"
            )
    except ShrinkError:
        raise
    except (IndexError, struct.error) as e:
        raise CorruptFrameError(
            f"corrupt SHRKS container: footer parse failed: {e}"
        ) from e
    return metas, kb_bytes, ref


def parse_framed_container(blob: bytes) -> tuple[list[FrameMeta], bytes]:
    """Validate head/tail/footer of a ``SHRKS`` container and return
    (frame directory, kb_bytes).  Raises a :class:`ShrinkError` subclass
    on foreign, truncated, or corrupt input (including a footer CRC
    mismatch).  Frame *payload* CRCs are NOT checked here — see
    ``frame_payload``.  The optional ``kb_snapshot_ref`` footer field is
    validated structurally here too; read it with
    :func:`read_snapshot_ref`."""
    metas, kb_bytes, _ = _parse_footer(blob)
    return metas, kb_bytes


def read_snapshot_ref(blob: bytes) -> KBSnapshotRef | None:
    """The container's ``kb_snapshot_ref`` footer field, or ``None`` for a
    self-contained container.  Same validation/raising as
    :func:`parse_framed_container`."""
    _, _, ref = _parse_footer(blob)
    return ref


def kb_snapshot_id(kb_bytes: bytes) -> int:
    """Routing identity of a container's serialized knowledge-base
    snapshot: the CRC-32 of the footer's ``SHKB`` blob (0 for containers
    written without one).  Two containers carrying byte-identical KB
    snapshots — e.g. replicas of one shard — share an id; a snapshot that
    gained entries gets a new one.  This identifies a concrete *serialized
    snapshot*; for the insertion-order-invariant semantic identity use
    ``KnowledgeBase.snapshot_id()`` (``core/streaming.py``)."""
    return zlib.crc32(bytes(kb_bytes)) & 0xFFFFFFFF if kb_bytes else 0


def frame_payload(blob: bytes, meta: FrameMeta, verify_crc: bool = True) -> bytes:
    """Extract one frame's payload (a complete ``SHRK`` blob), checking its
    directory CRC unless ``verify_crc=False``."""
    payload = bytes(blob[meta.offset : meta.offset + meta.length])
    if len(payload) != meta.length:
        raise TruncatedArchiveError(
            "truncated SHRKS container: frame payload cut short",
            series_id=meta.series_id, offset=meta.offset,
        )
    if verify_crc and zlib.crc32(payload) & 0xFFFFFFFF != meta.crc32:
        raise CorruptFrameError(
            f"frame payload CRC mismatch (series {meta.series_id}, "
            f"samples [{meta.t_lo}, {meta.t_hi}))",
            series_id=meta.series_id, offset=meta.offset,
        )
    return payload
