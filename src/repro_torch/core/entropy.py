"""Entropy coding of residual streams, counterpart of ``repro.core.entropy``.

Five backends, each a tagged wire format byte for byte the reference's:

* ``rans`` (tag 3): interleaved static-frequency rANS.  A stream of int64
  residuals is zigzag-mapped around its median, split into 8-bit planes,
  and each plane is coded with its own normalized frequency table (12-bit
  probabilities) by ``min(64, n)`` interleaved 32-bit states::

      i64 med, u64 count, u8 nplanes, u8 k
      per plane: 32 B presence bitmap, u16 freq per present symbol,
                 k u32 states, u32 nwords, u16 words

* ``rc`` (tag 0): the adaptive order-0 range coder, O(n) Python on the host;
* ``zstd`` (tag 1): zstandard level 19 over the biased values, on the host,
  only where the optional ``zstandard`` package imports;
* ``raw`` (tag 2) and ``bitpack`` (tag 4): fixed-width packing on the host;
* ``best``: the cost model (:func:`predict_backend_sizes`,
  :func:`choose_backend`) routes each stream to its predicted winner;
  ``exhaustive=True`` encodes with every candidate and keeps the smallest.

The features of a batch of streams are computed in torch on the streams'
device, all streams at once (:class:`_Streams`): min, max and median
(the plane counts follow from them on the host), then the zigzagged byte
planes and their histograms in passes of bounded size.  The
rANS coder runs in ``kernels.rans``, one launch per group of rows that
share a lane count and a power-of-two step count, so a ragged batch pads
no row to more than twice its length.  A batch of rANS streams decodes
with one launch per lane count, one host-to-device copy and one read-back
(:func:`decode_ints_until_error`, which stops where a loop over the
streams would).  The host frames the bytes, runs the
packers, the range coder and zstd, and sums the cost model's <= 256-entry
float64 terms in numpy in the reference's own expression and order, so the
same stream always gets the same pick.  Integers stay int64 (torch has
little uint64 support): zigzag and unzigzag are int64 bit operations.
"""
from __future__ import annotations

import bisect
import struct

import numpy as np
import torch

from ..kernels import ops
from ..kernels import rans as rans_rows
from .device import resolve_device
from .errors import CorruptFrameError, FormatError, TruncatedArchiveError

try:  # optional backend, as in the reference
    import zstandard as _zstd
except Exception:  # pragma: no cover - depends on the installation
    _zstd = None

__all__ = [
    "AdaptiveModel",
    "RangeDecoder",
    "RangeEncoder",
    "available_backends",
    "backend_name",
    "choose_backend",
    "decode_ints",
    "decode_ints_batch",
    "decode_ints_until_error",
    "encode_ints",
    "encode_ints_batch",
    "predict_backend_sizes",
]

_BACKENDS = {"rc": 0, "zstd": 1, "raw": 2, "rans": 3, "bitpack": 4}
_REV = {v: k for k, v in _BACKENDS.items()}

# what a payload that slipped past its CRC can raise in a decoder (a
# failed kernel build or launch is a RuntimeError and is not among them)
PAYLOAD_ERRORS = (struct.error, IndexError, KeyError, ValueError) + (
    (_zstd.ZstdError,) if _zstd is not None else ()
)


def available_backends() -> list[str]:
    out = ["rc", "rans", "raw", "bitpack"]
    if _zstd is not None:
        out.insert(2, "zstd")
    return out


def backend_name(tag: int) -> str | None:
    """Backend name for a stream's leading tag byte, or None if unknown."""
    return _REV.get(tag)


# ------------------------------------------------------------------ #
# the adaptive range coder (host)
# ------------------------------------------------------------------ #
_MASK = 0xFFFFFFFF
_TOP = 1 << 24
_BOT = 1 << 16


class RangeEncoder:
    def __init__(self) -> None:
        self.low = 0
        self.rng = _MASK
        self.out = bytearray()

    def encode(self, cum_lo: int, freq: int, tot: int) -> None:
        r = self.rng // tot
        self.low = (self.low + r * cum_lo) & _MASK
        self.rng = r * freq
        low, rng, out = self.low, self.rng, self.out
        while True:
            if (low ^ (low + rng)) < _TOP:
                pass
            elif rng < _BOT:
                rng = (-low) & (_BOT - 1)
            else:
                break
            out.append((low >> 24) & 0xFF)
            low = (low << 8) & _MASK
            rng = (rng << 8) & _MASK
        self.low, self.rng = low, rng

    def finish(self) -> bytes:
        for _ in range(4):
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & _MASK
        return bytes(self.out)


class RangeDecoder:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 4
        self.low = 0
        self.rng = _MASK
        code = 0
        for i in range(4):
            code = (code << 8) | (data[i] if i < len(data) else 0)
        self.code = code

    def decode_freq(self, tot: int) -> int:
        self._r = self.rng // tot
        v = (self.code - self.low) // self._r
        return min(v, tot - 1)

    def decode_update(self, cum_lo: int, freq: int, tot: int) -> None:
        r = self._r
        self.low = (self.low + r * cum_lo) & _MASK
        self.rng = r * freq
        low, rng, code = self.low, self.rng, self.code
        data, pos = self.data, self.pos
        while True:
            if (low ^ (low + rng)) < _TOP:
                pass
            elif rng < _BOT:
                rng = (-low) & (_BOT - 1)
            else:
                break
            nxt = data[pos] if pos < len(data) else 0
            pos += 1
            code = ((code << 8) | nxt) & _MASK
            low = (low << 8) & _MASK
            rng = (rng << 8) & _MASK
        self.low, self.rng, self.code, self.pos = low, rng, code, pos


class AdaptiveModel:
    """Order-0 adaptive model; Fenwick tree over symbol frequencies."""

    def __init__(self, nsym: int, inc: int = 24, max_total: int = 1 << 14) -> None:
        self.nsym = nsym
        self.inc = inc
        self.max_total = max_total
        self.freq = [1] * nsym
        self.total = nsym
        self.tree = [0] * (nsym + 1)
        for i in range(nsym):
            self._tree_add(i, 1)

    def _tree_add(self, i: int, delta: int) -> None:
        i += 1
        tree = self.tree
        while i <= self.nsym:
            tree[i] += delta
            i += i & (-i)

    def cum(self, i: int) -> int:
        """Sum of freq[0:i]."""
        s = 0
        tree = self.tree
        while i > 0:
            s += tree[i]
            i -= i & (-i)
        return s

    def find(self, target: int) -> int:
        """Largest i with cum(i) <= target."""
        idx = 0
        bitmask = 1 << (self.nsym.bit_length())
        tree = self.tree
        rem = target
        while bitmask:
            nxt = idx + bitmask
            if nxt <= self.nsym and tree[nxt] <= rem:
                idx = nxt
                rem -= tree[nxt]
            bitmask >>= 1
        return idx

    def update(self, sym: int) -> None:
        self.freq[sym] += self.inc
        self.total += self.inc
        self._tree_add(sym, self.inc)
        if self.total > self.max_total:
            freq = self.freq
            tree = self.tree
            for i in range(len(tree)):
                tree[i] = 0
            tot = 0
            for i, f in enumerate(freq):
                nf = (f + 1) >> 1
                freq[i] = nf
                tot += nf
                self._tree_add(i, nf)
            self.total = tot

    def encode_symbol(self, enc: RangeEncoder, sym: int) -> None:
        cum_lo = self.cum(sym)
        enc.encode(cum_lo, self.freq[sym], self.total)
        self.update(sym)

    def decode_symbol(self, dec: RangeDecoder) -> int:
        target = dec.decode_freq(self.total)
        sym = self.find(target)
        cum_lo = self.cum(sym)
        dec.decode_update(cum_lo, self.freq[sym], self.total)
        self.update(sym)
        return sym


def _zigzag_np(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.int64)
    return ((x << 1) ^ (x >> 63)).view(np.uint64)


def _unzigzag_np(z: np.ndarray) -> np.ndarray:
    z = np.asarray(z, dtype=np.uint64)
    half = (z >> np.uint64(1)).view(np.int64)
    return half ^ -(z & np.uint64(1)).astype(np.int64)


def _rc_encode_stream(symbols: np.ndarray, nsym: int) -> bytes:
    enc = RangeEncoder()
    model = AdaptiveModel(nsym)
    es = model.encode_symbol
    for s in symbols.tolist():
        es(enc, s)
    return enc.finish()


def _rc_decode_stream(data: bytes, count: int, nsym: int) -> np.ndarray:
    dec = RangeDecoder(data)
    model = AdaptiveModel(nsym)
    ds = model.decode_symbol
    out = np.empty(count, dtype=np.int64)
    for i in range(count):
        out[i] = ds(dec)
    return out


_SPLIT_ALPHABET = 4096  # above this, split into low-byte + high streams


def _rc_encode(q: np.ndarray) -> bytes:
    """Zigzag around the median, then byte planes off the bottom until the
    top stream's alphabet is <= _SPLIT_ALPHABET; each stream adaptive
    range-coded."""
    med = int(np.median(q)) if q.size else 0
    zz = _zigzag_np(q - med)
    zmax = int(zz.max()) if zz.size else 0
    planes: list[np.ndarray] = []
    while zmax >= _SPLIT_ALPHABET:
        planes.append((zz & np.uint64(0xFF)).astype(np.int64))
        zz = zz >> np.uint64(8)
        zmax >>= 8
    top = zz.astype(np.int64)
    parts = [struct.pack("<qQB", med, q.size, len(planes))]
    for p in planes:
        blob = _rc_encode_stream(p, 256)
        parts.append(struct.pack("<Q", len(blob)))
        parts.append(blob)
    top_max = int(top.max()) if top.size else 0
    blob = _rc_encode_stream(top, top_max + 1)
    parts.append(struct.pack("<QQ", len(blob), top_max))
    parts.append(blob)
    return b"".join(parts)


def _rc_decode(data: bytes) -> np.ndarray:
    med, count, nplanes = struct.unpack_from("<qQB", data, 0)
    off = 17
    planes: list[np.ndarray] = []
    for _ in range(nplanes):
        (ln,) = struct.unpack_from("<Q", data, off)
        off += 8
        planes.append(_rc_decode_stream(data[off : off + ln], count, 256).astype(np.uint64))
        off += ln
    ln, top_max = struct.unpack_from("<QQ", data, off)
    off += 16
    zz = _rc_decode_stream(data[off : off + ln], count, top_max + 1).astype(np.uint64)
    for p in reversed(planes):
        zz = (zz << np.uint64(8)) | p
    return _unzigzag_np(zz) + med


# ------------------------------------------------------------------ #
# the packers and zstd (host)
# ------------------------------------------------------------------ #
def _raw_encode(q: np.ndarray) -> bytes:
    """Minimal-width bit packing, MSB-first, at least 1 bit a value."""
    lo = int(q.min()) if q.size else 0
    span = (int(q.max()) - lo + 1) if q.size else 1
    bits = max(1, int(span - 1).bit_length()) if span > 1 else 1
    vals = (q - lo).astype(np.uint64)
    header = struct.pack("<qQB", lo, q.size, bits)
    bitmat = ((vals[:, None] >> np.arange(bits, dtype=np.uint64)) & 1).astype(np.uint8)
    return header + np.packbits(bitmat.reshape(-1)).tobytes()


def _raw_decode(data: bytes) -> np.ndarray:
    lo, count, bits = struct.unpack_from("<qQB", data, 0)
    packed = np.frombuffer(data, dtype=np.uint8, offset=17)
    bitvec = np.unpackbits(packed)[: count * bits]
    bitmat = bitvec.reshape(count, bits).astype(np.uint64)
    vals = (bitmat << np.arange(bits, dtype=np.uint64)).sum(axis=1)
    return vals.astype(np.int64) + lo


def _bitpack_encode(q: np.ndarray) -> bytes:
    """Values biased by the stream minimum, packed LSB-first at
    ``span.bit_length()`` bits each (0 bits for a constant stream)."""
    lo = int(q.min()) if q.size else 0
    span = (int(q.max()) - lo) if q.size else 0
    width = span.bit_length()
    header = struct.pack("<qQB", lo, q.size, width)
    if width == 0:
        return header
    vals = (q - lo).astype(np.uint64)  # wraps mod 2^64: exact unsigned bias
    bitmat = ((vals[:, None] >> np.arange(width, dtype=np.uint64)) & 1).astype(np.uint8)
    return header + np.packbits(bitmat.reshape(-1), bitorder="little").tobytes()


def _bitpack_decode(data: bytes) -> np.ndarray:
    if len(data) < 17:
        raise TruncatedArchiveError(f"bitpack stream truncated: {len(data)} byte header, need 17")
    lo, count, width = struct.unpack_from("<qQB", data, 0)
    if width > 64:
        raise FormatError(f"bitpack width byte {width} out of range (max 64)")
    nbytes = (count * width + 7) // 8
    if len(data) < 17 + nbytes:
        raise TruncatedArchiveError(
            f"bitpack stream truncated: payload {len(data) - 17} bytes, "
            f"need {nbytes} for {count} values at width {width}"
        )
    if len(data) > 17 + nbytes:
        raise CorruptFrameError(f"bitpack stream has {len(data) - 17 - nbytes} trailing bytes")
    if width == 0:
        return np.full(count, lo, dtype=np.int64)
    packed = np.frombuffer(data, dtype=np.uint8, offset=17)
    bitvec = np.unpackbits(packed, bitorder="little")[: count * width]
    bitmat = bitvec.reshape(count, width).astype(np.uint64)
    vals = (bitmat << np.arange(width, dtype=np.uint64)).sum(axis=1, dtype=np.uint64)
    return vals.astype(np.int64) + lo


def _zstd_encode(q: np.ndarray, level: int = 19, compressor=None) -> bytes:
    if _zstd is None:
        raise RuntimeError("zstandard not available")
    lo = int(q.min()) if q.size else 0
    span = (int(q.max()) - lo) if q.size else 0
    if span < (1 << 8):
        dt, code = np.uint8, 0
    elif span < (1 << 16):
        dt, code = np.uint16, 1
    elif span < (1 << 32):
        dt, code = np.uint32, 2
    else:
        dt, code = np.uint64, 3
    body = (q - lo).astype(dt).tobytes()
    ctx = compressor if compressor is not None else _zstd.ZstdCompressor(level=level)
    return struct.pack("<qQB", lo, q.size, code) + ctx.compress(body)


def _zstd_decode(data: bytes, decompressor=None) -> np.ndarray:
    if _zstd is None:
        raise RuntimeError(
            "this stream was encoded with the zstd backend; install the "
            "'zstandard' extra to decode it"
        )
    lo, count, code = struct.unpack_from("<qQB", data, 0)
    dt = [np.uint8, np.uint16, np.uint32, np.uint64][code]
    ctx = decompressor if decompressor is not None else _zstd.ZstdDecompressor()
    body = ctx.decompress(data[17:])
    return np.frombuffer(body, dtype=dt).astype(np.int64) + lo


_HOST_ENCODERS = {"rc": _rc_encode, "raw": _raw_encode, "bitpack": _bitpack_encode,
                  "zstd": _zstd_encode}


# ------------------------------------------------------------------ #
# stream features on the device
# ------------------------------------------------------------------ #
def _zigzag(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement zigzag in int64: the bits of numpy's uint64 result."""
    return (x << 1) ^ (x >> 63)


def _unzigzag(z: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_zigzag` on int64 holding uint64 bits."""
    half = (z >> 1) & 0x7FFFFFFFFFFFFFFF  # logical shift
    return half ^ -(z & 1)


def _nplanes(zmax: int) -> int:
    """Byte planes of an unsigned maximum held in int64 bits."""
    return 8 if zmax < 0 else max(1, (zmax.bit_length() + 7) // 8)


def _order_stats(flat: torch.Tensor, ns: list[int]):
    """(lo, hi, med) per stream of ``flat`` (streams of lengths ``ns`` end
    to end): min, max and ``int(np.median)``, the float64 mean of the
    middle value(s) truncated toward zero; 0 for an empty stream.  Equal
    lengths take row reductions and selections, with no full sort."""
    dev, s = flat.device, len(ns)
    if not flat.numel():
        z = torch.zeros(s, dtype=torch.int64, device=dev)
        return z, z, z
    if min(ns) == max(ns):
        n = ns[0]
        v = flat.view(s, n)
        a = v.kthvalue((n - 1) // 2 + 1, dim=1).values
        b = a if n % 2 else v.kthvalue(n // 2 + 1, dim=1).values
        mid = (a.double() + b.double()) / 2.0  # halving is exact
        return v.amin(dim=1), v.amax(dim=1), mid.long()
    n_t = torch.tensor(ns, dtype=torch.int64, device=dev)
    off = torch.cumsum(n_t, 0) - n_t
    seg = torch.repeat_interleave(torch.arange(s, device=dev), n_t, output_size=flat.numel())
    vals, order = torch.sort(flat, stable=True)
    seg = seg[order]
    del order
    order = torch.sort(seg, stable=True).indices  # sorted within each stream
    del seg
    srt = vals[order]
    del vals, order
    live = n_t > 0

    def at(i: torch.Tensor) -> torch.Tensor:
        return torch.where(live, srt[(off + i).clamp(0, flat.numel() - 1)], 0)

    mid = (at((n_t - 1) // 2).double() + at(n_t // 2).double()) / 2.0
    return at(torch.zeros_like(n_t)), at(n_t - 1), torch.where(live, mid.long(), 0)


# symbols per pass over the (stream, plane) rows: bounds the int64 index
# temporaries whatever the batch size
_CHUNK = 1 << 22


class _Streams:
    """A batch of int64 streams on one device, with what every encoder and
    the cost model read from them.

    Host lists, per stream: ``ns`` (lengths), ``offs`` (offsets into
    ``flat``), ``lo``/``hi`` (min/max, 0 when empty), ``med`` (the median
    as ``int(np.median)``), ``nplanes``.  Per (stream, plane) row in
    ``rows``: the bytes of the zigzagged stream around its median, laid
    end to end in ``sym`` (int16, row r at ``row_first[r]``), and a
    histogram ``counts[R, 256]``.  Rows are ordered by (lane count,
    power-of-two step count), the groups the rANS coder launches;
    ``groups`` holds (k, first row, end row)."""

    def __init__(self, arrs: list[torch.Tensor]):
        self.device = arrs[0].device if arrs else torch.device("cpu")
        self.ns = [int(a.numel()) for a in arrs]
        self.offs = np.concatenate([[0], np.cumsum(self.ns, dtype=np.int64)[:-1]]).tolist()
        self.flat = (
            torch.cat(arrs) if arrs else torch.zeros(0, dtype=torch.int64, device=self.device)
        )
        lo, hi, med = _order_stats(self.flat, self.ns)
        host = torch.stack([lo, hi, med]).tolist() if arrs else [[], [], []]
        self.lo, self.hi, self.med = host
        self.nplanes = [_nplanes(self._zigzag_max(i)) for i in range(len(arrs))]
        self._rows()

    def _zigzag_max(self, i: int) -> int:
        """The largest zigzag of stream i around its median, as an unsigned
        int.  Zigzag grows with |d| on each side of 0, so it is the larger
        of the extremes' unless a difference wraps in int64 (as numpy's
        does); then the stream is read on the host."""
        lo, hi, med = self.lo[i], self.hi[i], self.med[i]
        if hi - med < 1 << 63 and med - lo <= 1 << 63:
            return max(2 * (hi - med), 2 * (med - lo) - 1)
        return int(_zigzag_np(self.host(i) - med).max())

    def subset(self, idxs: list[int]) -> "_Streams":
        """Streams ``idxs`` of this batch, sharing ``flat`` and its stats."""
        sub = object.__new__(_Streams)
        sub.device, sub.flat = self.device, self.flat
        for name in ("ns", "offs", "lo", "hi", "med", "nplanes"):
            setattr(sub, name, [getattr(self, name)[i] for i in idxs])
        sub._rows()
        return sub

    def _rows(self) -> None:
        dev = self.device
        keys = []
        for i, (n, npl) in enumerate(zip(self.ns, self.nplanes)):
            k = max(1, min(64, n))
            steps = -(-n // k)
            keys.extend(((k, steps.bit_length()), i, p) for p in range(npl))
        keys.sort(key=lambda e: e[0])  # stable: planes stay ascending per stream
        self.rows = [(i, p) for _, i, p in keys]
        self.groups = []
        for r, (key, _, _) in enumerate(keys):
            if not self.groups or self.groups[-1][3] != key:
                self.groups.append([key[0], r, r + 1, key])
            else:
                self.groups[-1][2] = r + 1
        self.groups = [(k, a, b) for k, a, b, _ in self.groups]
        self.row_len = [self.ns[i] for i, _ in self.rows]
        self.row_first = np.concatenate([[0], np.cumsum(self.row_len, dtype=np.int64)]).tolist()

        def dev_t(vals):
            return torch.tensor(vals, dtype=torch.int64, device=dev)

        self._len_t = dev_t(self.row_len)
        self._first_t = dev_t(self.row_first[:-1])
        self._src_t = dev_t([self.offs[i] for i, _ in self.rows])
        self._med_t = dev_t([self.med[i] for i, _ in self.rows])
        self._shift_t = dev_t([8 * p for _, p in self.rows])
        r_count = len(self.rows)
        self.sym = torch.empty(self.row_first[-1], dtype=torch.int16, device=dev)
        self.counts = torch.zeros((r_count, 256), dtype=torch.int64, device=dev)
        for r, r1, rid, pos in self.row_chunks(0, r_count):
            g = r + rid
            v = self.flat[self._src_t[g] + pos] - self._med_t[g]
            sym = (_zigzag(v) >> self._shift_t[g]) & 0xFF
            self.sym[self.row_first[r] : self.row_first[r1]] = sym
            self.counts[r:r1] = torch.bincount(rid * 256 + sym, minlength=(r1 - r) * 256).view(
                r1 - r, 256
            )

    def row_chunks(self, a: int, b: int):
        """Rows [a, b) in passes of about ``_CHUNK`` symbols: (first row r,
        end row r1, row of each symbol relative to r, its position)."""
        r = a
        while r < b:
            r1 = min(b, max(r + 1, bisect.bisect_right(self.row_first, self.row_first[r] + _CHUNK) - 1))
            total = self.row_first[r1] - self.row_first[r]
            if total:
                rl = self._len_t[r:r1]
                rid = torch.repeat_interleave(
                    torch.arange(r1 - r, device=self.device), rl, output_size=total
                )
                first = self._first_t[r:r1] - self.row_first[r]
                yield r, r1, rid, torch.arange(total, device=self.device) - first[rid]
            r = r1

    def runs(self) -> list[int]:
        """Per stream: 1 + the number of adjacent unequal values (0 if empty)."""
        total = self.flat.numel()
        if total < 2:
            return [int(n > 0) for n in self.ns]
        # cs[j]: unequal adjacent pairs (t, t + 1) with t < j
        cs = torch.cat(
            [self.flat.new_zeros(1), torch.cumsum((self.flat[1:] != self.flat[:-1]).long(), 0)]
        )
        ends = torch.tensor(
            [[min(o, total - 1), min(o + max(n, 1) - 1, total - 1)] for o, n in zip(self.offs, self.ns)],
            dtype=torch.int64,
            device=self.device,
        )
        diff = (cs[ends[:, 1]] - cs[ends[:, 0]]).tolist()
        return [d + 1 if n else 0 for d, n in zip(diff, self.ns)]

    def stream(self, i: int) -> torch.Tensor:
        return self.flat[self.offs[i] : self.offs[i] + self.ns[i]]

    def host(self, i: int) -> np.ndarray:
        """Stream i as a host numpy int64 array."""
        return self.stream(i).cpu().numpy()


# ------------------------------------------------------------------ #
# rANS
# ------------------------------------------------------------------ #
_RANS_PROB_BITS = 12
_RANS_M = 1 << _RANS_PROB_BITS
_RANS_K = 64
_HEADER = struct.Struct("<qQBB")


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


def _rans_encode_streams(st: _Streams) -> list[bytes]:
    """rANS bodies (without the tag byte) of every stream of ``st``, each
    byte-identical to the reference's ``_rans_encode`` of that stream.
    One coder launch per row group; the host frames the bytes."""
    s_count = len(st.ns)
    parts = [
        [_HEADER.pack(st.med[i], st.ns[i], st.nplanes[i], max(1, min(_RANS_K, st.ns[i])))]
        for i in range(s_count)
    ]
    if not st.rows:
        return [b"".join(p) for p in parts]
    freqs = _rans_normalize_freqs_rows(st.counts)
    states, words, wcounts = [], [], []
    for k, a, b in st.groups:
        width = max(st.row_len[a:b])
        rows = st.sym[st.row_first[a] : st.row_first[b]]
        if min(st.row_len[a:b]) == width:  # full rows: the symbols as they lie
            cells = rows.view(b - a, width)
        else:  # short rows padded with the identity symbol
            cells = torch.full((b - a, width), ops.RANS_ID_SYM, dtype=torch.int16, device=st.device)
            for r, r1, rid, pos in st.row_chunks(a, b):
                lo = st.row_first[r] - st.row_first[a]
                cells[r - a + rid, pos] = rows[lo : lo + rid.numel()]
        x, w, c = rans_rows.encode_rows(cells, freqs[a:b], k)
        states.append(x.cpu().numpy().astype("<u4"))
        words.append(w)
        wcounts.append(c)
    freqs_h = freqs.cpu().numpy()
    present = freqs_h > 0
    bitmaps = np.packbits(present, axis=1, bitorder="little")
    freqs16 = freqs_h.astype("<u2")
    words_h = torch.cat(words).cpu().numpy().view(np.uint16).astype("<u2")
    ends = np.cumsum(torch.cat(wcounts).cpu().numpy())
    row = 0
    for grp in states:
        for lane_states in grp:
            i = st.rows[row][0]
            w = words_h[ends[row - 1] if row else 0 : ends[row]]
            parts[i] += [
                bitmaps[row].tobytes(),
                freqs16[row][present[row]].tobytes(),
                lane_states.tobytes(),
                struct.pack("<I", w.size),
                w.tobytes(),
            ]
            row += 1
    return [b"".join(p) for p in parts]


# ------------------------------------------------------------------ #
# the cost model
# ------------------------------------------------------------------ #
# rc is never a candidate (an O(n)-Python oracle); zstd must win its
# prediction by a margin; the rANS prediction is inflated a touch so that
# near-ties go to the packers, whose predictions are exact.
_ZSTD_MARGIN = 0.9
_RANS_PRED_INFLATE = 1.02
_ZSTD_FRAME_OVERHEAD = 13


def _predictions(st: _Streams) -> list[dict[str, int]]:
    """The reference's ``predict_backend_sizes`` of every stream of ``st``:
    the features come from the device, the float64 sums run here in numpy
    in the reference's expression and order."""
    counts = st.counts.cpu().numpy()
    runs = st.runs() if _zstd is not None else None
    first: dict[int, int] = {}
    for r, (i, p) in enumerate(st.rows):
        if p == 0:
            first[i] = r
    out = []
    for i, n in enumerate(st.ns):
        span = st.hi[i] - st.lo[i] if n else 0
        width = span.bit_length()
        pred = {
            "raw": 1 + 17 + (n * max(1, width) + 7) // 8,
            "bitpack": 1 + 17 + (n * width + 7) // 8,
        }
        k = max(1, min(_RANS_K, n))
        rans = 18
        info_bits = 0.0
        nlog2n = n * np.log2(n) if n else 0.0
        for p in range(st.nplanes[i]):
            c = counts[first[i] + p]
            nz = c[c > 0]
            rans += 32 + 2 * nz.size + 4 * k + 4
            if n:
                info_bits += float(nlog2n - (nz * np.log2(nz)).sum())
        rans += int(info_bits / 8)
        pred["rans"] = 1 + int(rans * _RANS_PRED_INFLATE) + 8
        if runs is not None and n:
            wbytes = 1 if width <= 8 else 2 if width <= 16 else 4 if width <= 32 else 8
            pred["zstd"] = (
                1 + 17 + _ZSTD_FRAME_OVERHEAD + min(int(info_bits / 8), runs[i] * (wbytes + 2))
            )
        out.append(pred)
    return out


def _choose(pred: dict[str, int]) -> str:
    best = "bitpack"
    for cand in ("rans", "raw"):
        if pred[cand] < pred[best]:
            best = cand
    z = pred.get("zstd")
    if z is not None and z < _ZSTD_MARGIN * pred[best]:
        best = "zstd"
    return best


def predict_backend_sizes(q: torch.Tensor) -> dict[str, int]:
    """Predicted encoded sizes (tag byte included) per backend of one
    stream: ``raw`` and ``bitpack`` exact, ``rans`` and ``zstd`` estimates
    from the byte-plane histograms and a run count."""
    return _predictions(_Streams([q.reshape(-1).long()]))[0]


def choose_backend(q: torch.Tensor) -> str:
    """The cost model's pick for one stream; ties go to the packers."""
    return _choose(predict_backend_sizes(q))


# ------------------------------------------------------------------ #
# encode
# ------------------------------------------------------------------ #
def _check_name(backend: str) -> None:
    if backend != "best" and backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {sorted(_BACKENDS)} or 'best'")


def _encode_group(st: _Streams, idxs: list[int], backend: str, out: list) -> None:
    """Encode streams ``idxs`` of ``st`` with one named backend into ``out``."""
    tag = bytes([_BACKENDS[backend]])
    if backend == "rans":
        sub = st if len(idxs) == len(st.ns) else st.subset(idxs)
        for i, body in zip(idxs, _rans_encode_streams(sub)):
            out[i] = tag + body
        return
    kwargs = {}
    if backend == "zstd":
        if _zstd is None:
            raise RuntimeError("zstandard not available")
        kwargs["compressor"] = _zstd.ZstdCompressor(level=19)
    enc = _HOST_ENCODERS[backend]
    for i in idxs:
        out[i] = tag + enc(st.host(i), **kwargs)


def _exhaustive(st: _Streams, i: int) -> bytes:
    """Every candidate backend on stream i; the smallest blob wins (the
    first in candidate order on a tie)."""
    q = st.host(i)
    cands = [b"\x03" + _rans_encode_streams(st.subset([i]))[0]]
    if q.size <= 300_000:
        cands.append(b"\x00" + _rc_encode(q))
    if _zstd is not None:
        cands.append(b"\x01" + _zstd_encode(q))
    cands.append(b"\x02" + _raw_encode(q))
    cands.append(b"\x04" + _bitpack_encode(q))
    return min(cands, key=len)


def encode_ints_batch(qs, backend: str = "best", exhaustive: bool = False) -> list[bytes]:
    """Encode a batch of int64 streams (an [S, n] tensor or a list of 1-D
    tensors, any mix of lengths); each blob is byte-identical to the
    reference's ``encode_ints`` of that stream.  The features of all
    streams are one device pass; ``best`` partitions the batch by the cost
    model's pick, and the rANS-bound streams share the coder launches."""
    _check_name(backend)
    if isinstance(qs, torch.Tensor):
        if qs.ndim != 2:
            raise ValueError(f"expected [S, n], got shape {tuple(qs.shape)}")
        qs = list(qs)
    arrs = [q.reshape(-1).long() for q in qs]
    if not arrs:
        return []
    st = _Streams(arrs)
    out: list[bytes] = [b""] * len(arrs)
    if backend != "best":
        _encode_group(st, list(range(len(arrs))), backend, out)
        return out
    if exhaustive:
        return [_exhaustive(st, i) for i in range(len(arrs))]
    groups: dict[str, list[int]] = {}
    for i, pred in enumerate(_predictions(st)):
        groups.setdefault(_choose(pred), []).append(i)
    for name, idxs in groups.items():
        _encode_group(st, idxs, name, out)
    return out


def encode_ints(q: torch.Tensor, backend: str = "best", exhaustive: bool = False) -> bytes:
    """Losslessly encode one int64 stream; returns tagged bytes."""
    return encode_ints_batch([q], backend=backend, exhaustive=exhaustive)[0]


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


def _rans_decode_many(parsed: list, device) -> tuple[list[torch.Tensor], int | None]:
    """Decode parsed rANS streams (:func:`_parse_rans` results).  Streams
    with the same lane count share one decoder launch (their planes are its
    rows, every launch as wide as the widest).  Every row's states, table,
    word offset and count and symbol count, the rebuild terms and all words
    reach the device in one copy; one read-back checks every row's word
    count; the int64 values of all streams are rebuilt in a fixed number of
    torch ops: each decoded symbol is scattered to byte ``p`` of its value
    (plane p holds bits 8p..8p+7), the bytes are read as little-endian
    int64, unzigzagged and offset by the stream's median.  Returns the
    streams' tensors and the index of the first stream that ran out of
    renormalization words (None if none)."""
    if not parsed:
        return [], None
    counts = [c for _m, c, _k, _p in parsed]
    starts = np.cumsum([0] + counts[:-1])
    by_k: dict[int, list[int]] = {}
    for i, (_m, _c, k, _p) in enumerate(parsed):
        by_k.setdefault(k, []).append(i)
    # every row's steps * k fit: the kernel keeps its writes inside cols
    # and does not check the width against ns
    cols = max(-(-counts[i] // k) * k for k, idxs in by_k.items() for i in idxs)
    # the launches' rows in order: per row its plane, its stream and the
    # byte its first symbol goes to
    groups, planes, row_of, row_dst = [], [], [], []
    for k, idxs in by_k.items():
        first = len(planes)
        for i in idxs:
            for p, pl in enumerate(parsed[i][3]):
                planes.append((pl, counts[i]))
                row_of.append(i)
                row_dst.append(8 * starts[i] + p)
        groups.append((k, len(planes) - first))
    n_rows = len(planes)
    row_ns = np.array([c for _, c in planes], dtype=np.int64)
    wlen = np.array([pl[2].size for pl, _ in planes], dtype=np.int64)
    n_words = int(wlen.sum())
    # one int64 host buffer: per launch [states, freqs, word_off, word_cnt,
    # ns], then the rows' first bytes, the medians and the counts, then the
    # words as int16
    n_meta = sum(r * (k + 259) for k, r in groups) + n_rows + 2 * len(parsed)
    # pinned for the card, so the copy is asynchronous and not a second
    # synchronization (PyTorch's host allocator keeps the block until it is done)
    card = torch.device(device).type == "cuda"
    staged = torch.empty(n_meta + -(-n_words // 4), dtype=torch.int64, pin_memory=card)
    host = staged.numpy()
    at = row = 0
    for k, r in groups:
        part = planes[row : row + r]
        host[at : at + r * k] = np.concatenate([pl[1] for pl, _ in part])
        host[at + r * k : at + r * (k + 256)] = np.concatenate([pl[0] for pl, _ in part])
        at += r * (k + 256)
        host[at : at + r] = np.cumsum(wlen)[row : row + r] - wlen[row : row + r]
        host[at + r : at + 2 * r] = wlen[row : row + r]
        host[at + 2 * r : at + 3 * r] = row_ns[row : row + r]
        at += 3 * r
        row += r
    tail = [row_dst, [p[0] for p in parsed], counts]
    host[at:n_meta] = np.concatenate([np.asarray(t, dtype=np.int64) for t in tail])
    host.view(np.int16)[4 * n_meta : 4 * n_meta + n_words] = np.concatenate(
        [pl[2] for pl, _ in planes]
    )
    buf = staged.to(device, non_blocking=True)
    words = buf[n_meta:].view(torch.int16)[:n_words]
    syms, short, ns_all = [], [], []
    at = 0
    for k, r in groups:
        states = buf[at : at + r * k].view(r, k)
        freqs = buf[at + r * k : at + r * (k + 256)].view(r, 256)
        at += r * (k + 256)
        off, cnt, ns = (buf[at + j * r : at + (j + 1) * r] for j in range(3))
        at += 3 * r
        sy, used = rans_rows.decode_rows(states, freqs, words, off, cnt, ns, k, cols=cols)
        syms.append(sy)
        short.append(used > cnt)
        ns_all.append(ns)
    dst0 = buf[at : at + n_rows]
    meds, lens = buf[at + n_rows : n_meta].view(2, -1)
    flags = short[0] if len(short) == 1 else torch.cat(short)
    short_rows = np.flatnonzero(flags.cpu().numpy())  # the call's one synchronization
    first_bad = min(row_of[j] for j in short_rows) if short_rows.size else None
    grid = syms[0] if len(syms) == 1 else torch.cat(syms)  # [rows, cols]
    row_n = ns_all[0] if len(ns_all) == 1 else torch.cat(ns_all)
    total = sum(counts)
    j = torch.arange(cols, device=device)
    # cells past a row's symbols go to a spare byte after the values
    dst = torch.where(j < row_n[:, None], dst0[:, None] + 8 * j, 8 * total)
    value_bytes = torch.zeros(8 * total + 1, dtype=torch.uint8, device=device)
    value_bytes[dst] = grid
    med = torch.repeat_interleave(meds, lens, output_size=total)
    q = _unzigzag(value_bytes[: 8 * total].view(torch.int64)) + med
    return list(torch.split(q, counts)), first_bad


_HOST_DECODERS = {"rc": _rc_decode, "raw": _raw_decode, "bitpack": _bitpack_decode}


def _split_tag(data: bytes) -> tuple[str, bytes]:
    if not data:
        raise TruncatedArchiveError("entropy stream is empty (missing tag byte)")
    name = _REV.get(data[0])
    if name is None:
        raise FormatError(f"unknown entropy backend tag {data[0]}")
    return name, bytes(data[1:])


def decode_ints_until_error(
    blobs: list[bytes], device=None, n: int | None = None
) -> tuple[list[torch.Tensor], Exception | None]:
    """Decode tagged streams in order as a loop of :func:`decode_ints`
    would, stopping at the first stream that fails: returns the int64
    tensors (on ``device``, default the card) of the streams before it and
    the payload error it raised (None if every stream decoded).  With
    ``n``, the first stream whose length is not n ends the batch after
    itself, so nothing past a wrong-length stream is decoded.  rANS
    streams with the same lane count share one decoder launch; the other
    tags decode on the host, zstd with one shared context.  An error
    outside :data:`PAYLOAD_ERRORS` (a failed kernel build or launch)
    propagates at once."""
    dev = resolve_device(device)
    out: list[torch.Tensor | None] = [None] * len(blobs)
    rans_idx, parsed = [], []
    stop, exc = len(blobs), None
    zctx = None
    for i, data in enumerate(blobs):
        try:
            name, body = _split_tag(data)
            if name == "rans":
                parsed.append(_parse_rans(body))
                rans_idx.append(i)
                length = parsed[-1][1]
            else:
                if name == "zstd":
                    if zctx is None and _zstd is not None:
                        zctx = _zstd.ZstdDecompressor()
                    q = _zstd_decode(body, decompressor=zctx)
                else:
                    q = _HOST_DECODERS[name](body)
                out[i] = torch.from_numpy(np.ascontiguousarray(q, dtype=np.int64)).to(dev)
                length = out[i].numel()
        except PAYLOAD_ERRORS as e:
            stop, exc = i, e
            break
        if n is not None and length != n:
            stop = i + 1
            break
    qs, bad = _rans_decode_many(parsed, dev)
    for i, q in zip(rans_idx, qs):
        out[i] = q
    if bad is not None and rans_idx[bad] < stop:
        stop, exc = rans_idx[bad], CorruptFrameError("rANS stream ran out of renormalization words")
    return out[:stop], exc


def decode_ints_batch(blobs: list[bytes], device=None) -> list[torch.Tensor]:
    """Decode tagged streams into int64 tensors on ``device`` (default the
    card), raising the first failing stream's error as a loop would.  rANS
    streams with the same lane count share one decoder launch; the other
    tags decode on the host, zstd with one shared context."""
    out, exc = decode_ints_until_error(blobs, device)
    if exc is not None:
        raise exc
    return out


def decode_ints(data: bytes, device=None) -> torch.Tensor:
    """Decode one tagged stream into an int64 tensor on ``device`` (default
    the card)."""
    return decode_ints_batch([data], device)[0]
