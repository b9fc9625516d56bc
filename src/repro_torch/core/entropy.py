"""Entropy coding of residual streams, counterpart of ``repro.core.entropy``:
the interleaved static-frequency rANS backend (tag 3).

A stream of int64 residuals is zigzag-mapped around its median, split into
8-bit planes, and each plane is rANS-coded with its own normalized
frequency table (12-bit probabilities) by ``min(64, n)`` interleaved 32-bit
states.  Wire layout of one stream (after the tag byte)::

    i64 med, u64 count, u8 nplanes, u8 k
    per plane: 32 B presence bitmap, u16 freq per present symbol,
               k u32 states, u32 nwords, u16 words

Everything up to the wire bytes runs in torch on the streams' device: the
median, zigzag, plane split, histograms, table normalization, the coder
(``kernels.rans``) and the word compaction.  The host only frames the
bytes.  Integers stay int64 (torch has little uint64 support): zigzag and
unzigzag are int64 bit operations and the plane count comes from the
unsigned bit length.

The other backends (rc, zstd, raw, bitpack) and the ``best`` cost model
come in a later slice of the port; naming them raises ``ConfigError``, and
a blob with their tag raises ``FormatError``.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from ..kernels import ops
from .device import resolve_device
from .errors import ConfigError, CorruptFrameError, FormatError, TruncatedArchiveError

__all__ = [
    "decode_ints",
    "decode_ints_batch",
    "encode_ints",
    "encode_ints_batch",
]

_RANS_PROB_BITS = 12
_RANS_M = 1 << _RANS_PROB_BITS
_RANS_K = 64
_BACKENDS = {"rc": 0, "zstd": 1, "raw": 2, "rans": 3, "bitpack": 4}
_REV = {v: k for k, v in _BACKENDS.items()}
_TAG = bytes([_BACKENDS["rans"]])
_LATER = "only the 'rans' entropy backend is ported so far; {} comes in a later slice"
_HEADER = struct.Struct("<qQBB")


def _check_backend(backend: str) -> None:
    if backend != "rans":
        raise ConfigError(_LATER.format(repr(backend)))


# ------------------------------------------------------------------ #
# integer front end
# ------------------------------------------------------------------ #
def _zigzag(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement zigzag in int64: the bits of numpy's uint64 result."""
    return (x << 1) ^ (x >> 63)


def _unzigzag(z: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_zigzag` on int64 holding uint64 bits."""
    half = (z >> 1) & 0x7FFFFFFFFFFFFFFF  # logical shift
    return half ^ -(z & 1)


def _median_rows(q: torch.Tensor) -> torch.Tensor:
    """``np.median(q, axis=1).astype(int64)``: the float64 mean of the middle
    value(s), truncated toward zero (``torch.median`` would give the lower
    middle value)."""
    n = q.shape[1]
    srt = torch.sort(q, dim=1).values
    mid = srt[:, n // 2].double()
    if n % 2 == 0:
        mid = (srt[:, n // 2 - 1].double() + mid) / 2.0  # halving is exact
    return mid.long()


def _plane_counts(zz: torch.Tensor) -> list[int]:
    """Bytes needed per row for the unsigned values held in int64 ``zz``."""
    if zz.shape[1] == 0:
        return [1] * zz.shape[0]
    top = (zz < 0).any(dim=1).tolist()  # the uint64 top bit is set
    zmax = zz.amax(dim=1).tolist()
    return [8 if t else max(1, (int(z).bit_length() + 7) // 8) for t, z in zip(top, zmax)]


def _rans_normalize_freqs_rows(counts: torch.Tensor) -> torch.Tensor:
    """Scale each row of an [R, 256] histogram to sum exactly M, keeping
    every present symbol at >= 1: rounding drift is added round-robin over
    the most frequent symbols, or stolen greedily from them (each donor
    keeps >= 1).  Byte-identical per row to the reference."""
    counts = counts.long()
    dev = counts.device
    totals = counts.sum(dim=1)
    nz = counts > 0
    scale = torch.div(
        torch.full(totals.shape, float(_RANS_M), dtype=torch.float64, device=dev),
        totals.clamp(min=1).double(),
    )
    scaled = torch.round(counts.double() * scale[:, None]).long()
    freqs = torch.where(nz, scaled.clamp(min=1), 0)
    diff = _RANS_M - freqs.sum(dim=1)
    if not bool(diff.any()):
        return torch.where(totals[:, None] > 0, freqs, 0)
    order = torch.argsort(-counts, dim=1, stable=True)  # most frequent first
    freqs_ord = freqs.gather(1, order)
    npres = nz.sum(dim=1)
    pos = torch.arange(256, device=dev)[None, :]
    present_pref = pos < npres[:, None]
    surplus = diff > 0
    deficit = diff < 0
    np1 = npres.clamp(min=1)
    addv = torch.where(surplus, diff // np1, 0)
    remv = torch.where(surplus, diff % np1, 0)
    inc = present_pref.long() * addv[:, None] + (pos < remv[:, None]).long()
    caps = torch.where(present_pref, freqs_ord - 1, 0)
    cum = torch.cumsum(caps, dim=1)
    need = torch.where(deficit, -diff, 0)
    if bool((need > cum[:, -1]).any()):
        raise AssertionError(
            "rANS freq normalization stalled: deficit exceeds donor "
            "capacity (histogram invariant violated)"
        )
    steal = torch.minimum((need[:, None] - (cum - caps)).clamp(min=0), caps)
    delta = torch.where(surplus[:, None], inc, -steal)
    freqs = freqs.scatter(1, order, freqs_ord + delta)
    return torch.where(totals[:, None] > 0, freqs, 0)


def _rans_normalize_freqs(counts: torch.Tensor) -> torch.Tensor:
    """One histogram [256]: the R = 1 row of :func:`_rans_normalize_freqs_rows`."""
    return _rans_normalize_freqs_rows(counts[None])[0]


def _rans_plane_table(freqs: np.ndarray) -> bytes:
    """Wire bytes of one plane's table: 32 B presence bitmap + u16 freq per
    present symbol."""
    present = freqs > 0
    bitmap = np.packbits(present.astype(np.uint8), bitorder="little")
    return bitmap.tobytes() + freqs.astype("<u2")[present].tobytes()


def _rans_plane_rows(qs: torch.Tensor):
    """The coder's input for equal-length streams qs[S, n]: (med[S] list,
    nplanes[S] list, k, rows [(series, plane)], sym[R, n] int16, freqs[R,
    256] int64), rows plane-major."""
    s_count, n = qs.shape
    med = _median_rows(qs) if n else qs.new_zeros(s_count)
    zz = _zigzag(qs - med[:, None])
    nplanes = _plane_counts(zz)
    k = max(1, min(_RANS_K, n))
    rows: list[tuple[int, int]] = []
    blocks = []
    for p in range(max(nplanes, default=0)):
        sel = [i for i in range(s_count) if nplanes[i] > p]
        rows.extend((i, p) for i in sel)
        zsel = zz if len(sel) == s_count else zz[torch.tensor(sel, device=zz.device)]
        blocks.append(((zsel >> (8 * p)) & 0xFF).to(torch.int16))
    if not rows:
        empty = torch.zeros((0, n), dtype=torch.int16, device=qs.device)
        return med.tolist(), nplanes, k, rows, empty, empty.new_zeros((0, 256)).long()
    sym = torch.cat(blocks, dim=0)
    r_count = sym.shape[0]
    offsets = torch.arange(r_count, device=sym.device)[:, None] * 256
    counts = torch.bincount((sym.long() + offsets).reshape(-1), minlength=256 * r_count)
    freqs = _rans_normalize_freqs_rows(counts.view(r_count, 256))
    return med.tolist(), nplanes, k, rows, sym, freqs


def _rans_encode_batch(qs: torch.Tensor) -> list[bytes]:
    """Encode S equal-length int64 streams; one blob per row (without the
    tag byte), each byte-identical to the reference ``_rans_encode``."""
    s_count, n = qs.shape
    med, nplanes, k, rows, sym, freqs = _rans_plane_rows(qs)
    parts = [[_HEADER.pack(med[i], n, nplanes[i], k)] for i in range(s_count)]
    if rows:
        states, words, wcounts = ops.rans_encode_rows(sym, freqs, k)
        freqs_h = freqs.cpu().numpy()
        states32 = states.cpu().numpy().astype("<u4")
        words_h = words.cpu().numpy().view(np.uint16).astype("<u2")
        ends = np.cumsum(wcounts.cpu().numpy())
        for i, (s, _p) in enumerate(rows):
            w = words_h[ends[i - 1] if i else 0 : ends[i]]
            parts[s] += [
                _rans_plane_table(freqs_h[i]),
                states32[i].tobytes(),
                struct.pack("<I", w.size),
                w.tobytes(),
            ]
    return [b"".join(p) for p in parts]


def _rans_encode(q: torch.Tensor) -> bytes:
    """One stream: the S = 1 row of :func:`_rans_encode_batch`."""
    return _rans_encode_batch(q.reshape(1, -1))[0]


def encode_ints(q: torch.Tensor, backend: str = "rans") -> bytes:
    """Losslessly encode one int64 stream; returns tagged bytes."""
    _check_backend(backend)
    return _TAG + _rans_encode(q.long())


def encode_ints_batch(qs, backend: str = "rans") -> list[bytes]:
    """Encode a batch of int64 streams: an [S, n] tensor or a list of 1-D
    tensors.  Streams of equal length share one coder launch; each blob is
    byte-identical to ``encode_ints`` of that stream."""
    _check_backend(backend)
    if isinstance(qs, torch.Tensor):
        if qs.ndim != 2:
            raise ValueError(f"expected [S, n], got shape {tuple(qs.shape)}")
        return [_TAG + b for b in _rans_encode_batch(qs.long())]
    arrs = [q.reshape(-1).long() for q in qs]
    by_len: dict[int, list[int]] = {}
    for i, a in enumerate(arrs):
        by_len.setdefault(a.numel(), []).append(i)
    out: list[bytes] = [b""] * len(arrs)
    for idxs in by_len.values():
        blobs = _rans_encode_batch(torch.stack([arrs[i] for i in idxs]))
        for i, b in zip(idxs, blobs):
            out[i] = _TAG + b
    return out


# ------------------------------------------------------------------ #
# decode
# ------------------------------------------------------------------ #
def _need(data: bytes, off: int, size: int, what: str) -> None:
    if off + size > len(data):
        raise TruncatedArchiveError(f"rANS stream truncated: {what} cut short", offset=off)


def _parse_rans(body: bytes):
    """Header and planes of one rANS stream body (host bytes)."""
    _need(body, 0, _HEADER.size, "header")
    med, count, nplanes, k = _HEADER.unpack_from(body, 0)
    if not 1 <= k <= _RANS_K:
        raise FormatError(f"rANS stream has {k} lanes (1..{_RANS_K} allowed)")
    if not 1 <= nplanes <= 8:
        raise FormatError(f"rANS stream has {nplanes} byte planes (1..8 allowed)")
    if count >= 1 << 31:
        raise FormatError(f"rANS stream of {count} symbols exceeds the decoder's 2^31 - 1")
    off = _HEADER.size
    planes = []
    for _ in range(nplanes):
        _need(body, off, 32, "plane table")
        bitmap = np.frombuffer(body, dtype=np.uint8, count=32, offset=off)
        off += 32
        present = np.unpackbits(bitmap, bitorder="little").astype(bool)
        npres = int(present.sum())
        _need(body, off, 2 * npres + 4 * k + 4, "plane table")
        freqs = np.zeros(256, dtype=np.int64)
        freqs[present] = np.frombuffer(body, dtype="<u2", count=npres, offset=off)
        off += 2 * npres
        if count and int(freqs.sum()) != _RANS_M:
            raise CorruptFrameError(f"rANS plane table sums to {int(freqs.sum())}, not {_RANS_M}")
        states = np.frombuffer(body, dtype="<u4", count=k, offset=off).astype(np.int64)
        off += 4 * k
        (nwords,) = struct.unpack_from("<I", body, off)
        off += 4
        _need(body, off, 2 * nwords, "word stream")
        words = np.frombuffer(body, dtype="<u2", count=nwords, offset=off).view(np.int16)
        off += 2 * nwords
        planes.append((freqs, states, words))
    return med, count, k, planes


def _rans_decode_many(bodies: list[bytes], device) -> list[torch.Tensor]:
    """Decode rANS stream bodies; streams with the same lane count share
    one decoder launch (their planes are its rows)."""
    parsed = [_parse_rans(b) for b in bodies]
    out: list[torch.Tensor | None] = [None] * len(bodies)
    by_k: dict[int, list[int]] = {}
    for i, (_m, _c, k, _p) in enumerate(parsed):
        by_k.setdefault(k, []).append(i)
    for k, idxs in by_k.items():
        planes = [pl for i in idxs for pl in parsed[i][3]]
        ns = [parsed[i][1] for i in idxs for _ in parsed[i][3]]
        wlen = [pl[2].size for pl in planes]
        words = torch.from_numpy(np.concatenate([pl[2] for pl in planes]))
        syms, used = ops.rans_decode_rows(
            torch.from_numpy(np.stack([pl[1] for pl in planes])).to(device),
            torch.from_numpy(np.stack([pl[0] for pl in planes])).to(device),
            words.to(device),
            torch.tensor(np.cumsum([0] + wlen[:-1]), dtype=torch.int64, device=device),
            torch.tensor(wlen, dtype=torch.int64, device=device),
            torch.tensor(ns, dtype=torch.int64, device=device),
            k,
        )
        if bool((used > torch.tensor(wlen, device=device)).any()):
            raise CorruptFrameError("rANS stream ran out of renormalization words")
        row = 0
        for i in idxs:
            med, count, _k, pls = parsed[i]
            zz = torch.zeros(count, dtype=torch.int64, device=device)
            for p in range(len(pls)):
                zz |= syms[row + p, :count].long() << (8 * p)
            row += len(pls)
            out[i] = _unzigzag(zz) + med
    return out


def _rans_decode(body: bytes, device) -> torch.Tensor:
    """One stream body: the single-stream case of :func:`_rans_decode_many`."""
    return _rans_decode_many([body], device)[0]


def _rans_body(data: bytes) -> bytes:
    """The body of a tagged rANS stream; other tags raise."""
    if not data:
        raise TruncatedArchiveError("entropy stream is empty (missing tag byte)")
    name = _REV.get(data[0])
    if name is None:
        raise FormatError(f"unknown entropy backend tag {data[0]}")
    if name != "rans":
        raise FormatError(_LATER.format(f"the {name!r} stream this blob holds"))
    return bytes(data[1:])


def decode_ints(data: bytes, device=None) -> torch.Tensor:
    """Decode one tagged stream into an int64 tensor on ``device`` (default
    the card)."""
    return _rans_decode(_rans_body(data), resolve_device(device))


def decode_ints_batch(blobs: list[bytes], device=None) -> list[torch.Tensor]:
    """Decode tagged streams on ``device`` (default the card); rANS streams
    with the same lane count share one decoder launch."""
    return _rans_decode_many([_rans_body(d) for d in blobs], resolve_device(device))
