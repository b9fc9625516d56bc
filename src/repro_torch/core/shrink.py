"""The SHRINK codec (Alg. 1) in PyTorch, counterpart of ``repro.core.shrink``.

One base, a residual refinement pyramid over an eps ladder, and the
``SHRK`` v2 container, byte-identical to the reference codec.  The codec
runs on the card unless it is given ``device="cpu"``:

    codec = ShrinkCodec.from_fraction(values, frac=0.05)        # eps_b = 5% range
    cs    = codec.compress(values, eps_targets=[1e-2, 0.0], decimals=4)
    vhat  = codec.decompress_at(cs, 1e-2)   # float64 tensor, |vhat - v| <= 1e-2
    exact = codec.decompress_at(cs, 0.0)    # lossless
    css   = codec.compress_batch(values_st, eps_targets=[1e-2])  # [S, T]
    css   = codec.compress_batch([v1, v2, v3], eps_targets=[1e-2])  # ragged
    blob  = cs_to_bytes(cs); cs2 = cs_from_bytes(blob)

On the device: the fluctuation table, the cone scan (CUDA kernel), the
segment compaction, the base predictions, the pyramid quantizer, the
entropy features and the rANS coder (CUDA kernels) with everything around
it.  On the host: the ``Segment`` records, base merging (Alg. 4/5), the
byte framing and the host entropy backends.  The entropy backend defaults
to ``"best"``, the reference's cost model.
"""
from __future__ import annotations

import math
import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.segment_agg import _div
from . import entropy
from .base import (
    base_predictions,
    base_predictions_batch,
    base_predictions_ragged,
    construct_base,
)
from .device import resolve_device
from .errors import (
    CorruptFrameError,
    FormatError,
    LayerCorruptError,
    ShrinkError,
    TruncatedArchiveError,
)
from .residuals import (
    encode_residuals_batch,
    normalize_tiers,
    quantize_pyramid_batch,
)
from .semantics import extract_semantics, extract_semantics_batch, global_range, row_ranges
from .serialize import decode_base, decode_pyramid, encode_base, encode_pyramid, pyramid_layers
from .types import Base, CompressedSeries, ShrinkConfig

__all__ = [
    "BYTES_PER_ROW",
    "ProgressiveDecoder",
    "ShrinkCodec",
    "cs_from_bytes",
    "cs_to_bytes",
    "decompress_at",
    "encode_frames_with_bases",
    "encode_with_base",
    "original_size_bytes",
]

_CONTAINER_MAGIC = b"SHRK"
_CONTAINER_VERSION = 2

# original size is accounted as 16 bytes/row (timestamp + value, two
# float64), the same accounting as the reference's benchmarks
BYTES_PER_ROW = 16


def original_size_bytes(n: int) -> int:
    return BYTES_PER_ROW * n


def _as_values(values, device: torch.device) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        return values.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(values, dtype=np.float64), device=device)


@dataclass
class ShrinkCodec:
    config: ShrinkConfig
    backend: str = "best"
    device: torch.device | str | None = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    @classmethod
    def from_fraction(
        cls,
        values,
        frac: float = 0.05,
        lam: float = 1e-5,
        beta_levels: int = 16,
        backend: str = "best",
        device: torch.device | str | None = None,
    ) -> "ShrinkCodec":
        dev = resolve_device(device)
        vmin, vmax = global_range(_as_values(values, dev))
        rng = max(vmax - vmin, 1e-12)
        return cls(
            config=ShrinkConfig(eps_b=frac * rng, lam=lam, beta_levels=beta_levels),
            backend=backend,
            device=dev,
        )

    def build_base(
        self,
        values,
        value_range: tuple[float, float] | None = None,
        n_hint: int | None = None,
    ) -> Base:
        values = _as_values(values, self.device).reshape(-1)
        segments = extract_semantics(values, self.config, value_range=value_range, n_hint=n_hint)
        if value_range is None:
            vmin, vmax = global_range(values)
        else:
            vmin, vmax = float(value_range[0]), float(value_range[1])
        return construct_base(segments, values.numel(), vmin, vmax, self.config)

    def compress(
        self,
        values,
        eps_targets: list[float],
        decimals: int | None = None,
        value_range: tuple[float, float] | None = None,
        n_hint: int | None = None,
    ) -> CompressedSeries:
        """Alg. 1: extract semantics once, then the residual pyramid over the
        eps ladder (0.0 = lossless, needs ``decimals``).  ``value_range`` /
        ``n_hint`` pin the scan's global quantities as in the reference."""
        values = _as_values(values, self.device).reshape(-1)
        base = self.build_base(values, value_range=value_range, n_hint=n_hint)
        return encode_with_base(values, base, eps_targets, decimals, backend=self.backend)

    def compress_batch(
        self,
        values,
        eps_targets: list[float],
        decimals: int | None = None,
        lengths=None,
        max_buckets: int | None = None,
    ) -> list[CompressedSeries]:
        """Batched Alg. 1 over S series: ``values[S, T]``, ``values[S, T]``
        with ``lengths[S]`` (row i holds ``lengths[i]`` real samples), or a
        list of 1-D series of any lengths, empty ones included.  Ragged
        input is cut into at most ``max_buckets`` percentile length buckets
        (default: about one per 4 series, between 4 and 16), each scanned
        with the valid-length mask, and every layer of every series shares
        one entropy pass.  Each output is byte-identical to the reference's
        ``compress_batch`` on the same input."""
        if isinstance(values, (list, tuple)):
            if lengths is not None:
                raise ValueError("pass lengths only with a padded [S, T] array")
            arrs = [_as_values(v, self.device).reshape(-1) for v in values]
            ns = np.array([a.numel() for a in arrs], dtype=np.int64)
            if ns.size and (ns == ns[0]).all():  # rectangular in disguise
                return self._compress_batch_rect(
                    torch.stack(arrs), eps_targets, decimals
                )
            return self._compress_batch_ragged(arrs, ns, eps_targets, decimals, max_buckets)
        values = _as_values(values, self.device)
        if values.ndim != 2:
            raise ValueError(f"expected values[S, T], got shape {tuple(values.shape)}")
        if lengths is not None:
            ns = np.asarray(lengths, dtype=np.int64).ravel()
            if ns.shape != (values.shape[0],):
                raise ValueError(f"lengths must be [S]={values.shape[0]}, got shape {ns.shape}")
            if (ns < 0).any() or (ns > values.shape[1]).any():
                raise ValueError(f"lengths must lie in [0, T={values.shape[1]}]")
            if not (ns == values.shape[1]).all():
                arrs = [values[i, : ns[i]] for i in range(values.shape[0])]
                return self._compress_batch_ragged(
                    arrs, ns, eps_targets, decimals, max_buckets
                )
        return self._compress_batch_rect(values, eps_targets, decimals)

    def _compress_batch_rect(
        self, values: torch.Tensor, eps_targets: list[float], decimals: int | None
    ) -> list[CompressedSeries]:
        s, n = values.shape
        if n:
            seg_lists = extract_semantics_batch(values, self.config)
            vmins, vmaxs = row_ranges(values)
        else:
            seg_lists = [[] for _ in range(s)]
            vmins = vmaxs = [0.0] * s
        bases = [
            construct_base(seg_lists[i], n, vmins[i], vmaxs[i], self.config) for i in range(s)
        ]
        return encode_frames_with_bases(values, bases, eps_targets, decimals, backend=self.backend)

    def _compress_batch_ragged(
        self,
        arrs: list[torch.Tensor],
        ns: np.ndarray,
        eps_targets: list[float],
        decimals: int | None,
        max_buckets: int | None,
    ) -> list[CompressedSeries]:
        """Mixed lengths: percentile length buckets padded to their longest
        series, masked scans and quantizers, one entropy pass."""
        tiers = normalize_tiers(eps_targets, decimals)
        s = len(arrs)
        if max_buckets is None:
            max_buckets = int(np.clip(s // 4, 4, 16))
        if max_buckets < 1:
            raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
        out: list[CompressedSeries | None] = [None] * s
        for i in np.flatnonzero(ns == 0):
            # an empty series carries an empty base and empty or absent layers
            base = construct_base([], 0, 0.0, 0.0, self.config)
            out[i] = encode_with_base(arrs[i], base, tiers, decimals, backend=self.backend)
        nonempty = np.flatnonzero(ns > 0)
        order = nonempty[np.argsort(ns[nonempty], kind="stable")]
        buckets = (
            [b for b in np.array_split(order, min(max_buckets, order.size)) if b.size]
            if order.size
            else []
        )
        done: list[tuple[int, Base, float, list]] = []
        for bucket in buckets:
            nb = ns[bucket]
            t_pad = int(nb.max())
            ln = torch.as_tensor(nb, device=self.device)
            valid = torch.arange(t_pad, device=self.device)[None, :] < ln[:, None]
            vals = torch.zeros((bucket.size, t_pad), dtype=torch.float64, device=self.device)
            vals[valid] = torch.cat([arrs[i] for i in bucket])
            seg_lists = extract_semantics_batch(vals, self.config, lengths=nb)
            vmins, vmaxs = row_ranges(vals, valid)
            bases = [
                construct_base(seg_lists[r], int(nb[r]), vmins[r], vmaxs[r], self.config)
                for r in range(bucket.size)
            ]
            preds = base_predictions_ragged(bases, t_pad, self.device)
            eps_hats = (vals - preds).masked_fill(~valid, 0.0).abs().amax(dim=1).tolist()
            streams = quantize_pyramid_batch(vals, preds, tiers, decimals, lengths=nb)
            done += [(int(i), bases[r], eps_hats[r], streams[r]) for r, i in enumerate(bucket)]
        todo = [st for *_, row in done for st in row if st is not None]
        blobs = iter(encode_residuals_batch(todo, backend=self.backend))
        for i, base, eps_hat, row in done:
            payloads = [None if st is None else next(blobs) for st in row]
            out[i] = CompressedSeries(
                base=base,
                base_bytes=encode_base(base),
                pyramid=pyramid_layers(tiers, row, payloads),
                eps_b_practical=float(eps_hat),
            )
        return out

    def decompress_at(self, cs: CompressedSeries, eps: float) -> torch.Tensor:
        return decompress_at(cs, eps, device=self.device)


class ProgressiveDecoder:
    """Incremental pyramid decode of one :class:`CompressedSeries` on
    ``device`` (default the card).  ``prefix(k)`` / ``at(eps)`` return the
    float64 reconstruction through layer k / the cheapest tier meeting
    ``eps``; refining from tier j to k > j decodes only the layers in
    between.  Returned tensors are cached: treat them as read-only."""

    def __init__(self, cs: CompressedSeries, device: torch.device | str | None = None):
        self.cs = cs
        self.device = resolve_device(device)
        self._layers = cs.pyramid.layers
        # _recons[0] = base predictions; _recons[d + 1] = through layer d
        self._recons: list[torch.Tensor | None] = [None] * (len(self._layers) + 1)
        self._depth = -1
        self.layers_decoded = 0

    @property
    def depth(self) -> int:
        """Deepest decoded layer index (-1 = base predictions only)."""
        return self._depth

    def intact_depth(self) -> int:
        """Deepest layer index reachable without crossing a quarantined
        (``corrupt``) layer (-1 = base only): layer k refines the error of
        the prefix through k - 1, so nothing below a corrupt layer decodes."""
        for k, layer in enumerate(self._layers):
            if layer.corrupt:
                return k - 1
        return len(self._layers) - 1

    def guarantee(self, k: int | None = None) -> float:
        """Error bound of the prefix through layer ``k`` (default: the
        deepest decoded prefix)."""
        d = self._depth if k is None else k
        g = self.cs.eps_b_practical
        if d >= 0:
            g = min(g, self._layers[d].eps)
        return g

    def available(self) -> tuple[torch.Tensor, float] | None:
        """The deepest reconstruction already materialized and its
        guarantee, with no entropy work; ``None`` before any decode."""
        if self._recons[self._depth + 1] is None:
            return None
        return self._recons[self._depth + 1], self.guarantee()

    def _ensure_base(self) -> None:
        if self._recons[0] is None:
            base = self.cs.base if self.cs.base is not None else decode_base(self.cs.base_bytes)
            self._recons[0] = base_predictions(base, self.device)

    def prefix(self, k: int) -> torch.Tensor:
        """Reconstruction through layer ``k`` (-1 = base only)."""
        self._ensure_base()
        if k > self._depth:
            recon = self._recons[self._depth + 1]
            for d in range(self._depth + 1, k + 1):
                layer = self._layers[d]
                if layer.corrupt:
                    raise LayerCorruptError(
                        "cannot decode past quarantined pyramid layer "
                        f"(tier eps={layer.eps:g}); finest intact prefix is "
                        f"layer {d - 1}",
                        layer=d,
                    )
                if layer.mode == "identity":
                    out = recon
                elif layer.mode == "midpoint":
                    q = self._decode_payload(layer, d, recon.numel())
                    out = recon + (layer.r_lo + (q.double() + 0.5) * layer.step)
                    recon = out
                elif layer.mode == "exact":
                    q = self._decode_payload(layer, d, recon.numel())
                    scale = 10.0 ** int(round(-math.log10(layer.step)))
                    rec_int = torch.round(recon * scale).long()
                    out = _div((rec_int + q).double(), scale)
                else:  # pragma: no cover - decode_pyramid enforces modes
                    raise ValueError(f"unknown layer mode {layer.mode!r}")
                self._recons[d + 1] = out
            self._depth = k
        return self._recons[k + 1]

    def _decode_payload(self, layer, d: int, n: int) -> torch.Tensor:
        """Entropy-decode one layer.  A payload that fails to parse or has
        the wrong length raises :class:`LayerCorruptError` (or the typed
        :class:`ShrinkError` the parser raised); an error of the kernel
        layer (a failed build or launch) propagates unchanged."""
        try:
            q = entropy.decode_ints(layer.payload, self.device)
        except ShrinkError:
            raise
        except entropy.PAYLOAD_ERRORS as e:
            raise LayerCorruptError(
                f"pyramid layer payload failed entropy decode: {e}", layer=d
            ) from e
        if q.numel() != n:
            raise LayerCorruptError(
                f"pyramid layer decoded to {q.numel()} residuals for {n} samples", layer=d
            )
        self.layers_decoded += 1
        return q

    def at(self, eps: float) -> torch.Tensor:
        return self.prefix(self.cs.pyramid.resolve(eps, self.cs.eps_b_practical))


def decompress_at(
    cs: CompressedSeries, eps: float, device: torch.device | str | None = None
) -> torch.Tensor:
    """Reconstruct ``cs`` at resolution ``eps`` on ``device`` (default the
    card): the cheapest layer prefix whose guarantee is <= ``eps``."""
    return ProgressiveDecoder(cs, device).at(eps)


def encode_with_base(
    values: torch.Tensor,
    base: Base,
    eps_targets: list[float],
    decimals: int | None = None,
    backend: str = "best",
) -> CompressedSeries:
    """Residual-encoding tail of Alg. 1 for one series with its base: the
    S = 1 case of :func:`encode_frames_with_bases`."""
    return encode_frames_with_bases(
        values.reshape(1, -1), [base], eps_targets, decimals, backend=backend
    )[0]


def encode_frames_with_bases(
    values: torch.Tensor,
    bases: list[Base],
    eps_targets: list[float],
    decimals: int | None = None,
    backend: str = "best",
) -> list[CompressedSeries]:
    """Batched residual encoding of F equal-length frames whose bases are
    built: one prediction pass, one pyramid quantization and one entropy
    pass over every layer of every frame."""
    values = values.to(torch.float64)
    f_count, n = values.shape
    base_bytes = [encode_base(b) for b in bases]
    preds = base_predictions_batch(bases, values.device)
    if n:
        eps_hats = (values - preds).abs().amax(dim=1).tolist()
    else:
        eps_hats = [0.0] * f_count
    tiers = normalize_tiers(eps_targets, decimals)
    layer_streams = quantize_pyramid_batch(values, preds, tiers, decimals)
    todo = [
        (i, k, st)
        for i in range(f_count)
        for k, st in enumerate(layer_streams[i])
        if st is not None
    ]
    blobs = encode_residuals_batch([st for _, _, st in todo], backend=backend)
    payloads: list[list[bytes | None]] = [[None] * len(tiers) for _ in range(f_count)]
    for (i, k, _), blob in zip(todo, blobs):
        payloads[i][k] = blob
    return [
        CompressedSeries(
            base=bases[i],
            base_bytes=base_bytes[i],
            pyramid=pyramid_layers(tiers, layer_streams[i], payloads[i]),
            eps_b_practical=float(eps_hats[i]),
        )
        for i in range(f_count)
    ]


def cs_to_bytes(cs: CompressedSeries) -> bytes:
    """``SHRK`` v2 container: magic, version, header (eps_hat, base length),
    CRC32 of header + base, the ``SHRB`` base, then the length-prefixed
    ``SHRR`` v3 residual pyramid."""
    pyr = encode_pyramid(cs.pyramid)
    header = struct.pack("<dI", cs.eps_b_practical, len(cs.base_bytes))
    buf = bytearray()
    buf += _CONTAINER_MAGIC
    buf.append(_CONTAINER_VERSION)
    buf += header
    buf += struct.pack("<I", zlib.crc32(header + cs.base_bytes) & 0xFFFFFFFF)
    buf += cs.base_bytes
    buf += struct.pack("<I", len(pyr))
    buf += pyr
    return bytes(buf)


def cs_from_bytes(data: bytes, strict: bool = True) -> CompressedSeries:
    """Parse a ``SHRK`` v2 container; raises a :class:`ShrinkError` subclass
    on foreign, truncated or corrupt input.  ``strict=False`` returns a
    corrupt pyramid layer quarantined instead of raising."""
    data = bytes(data)
    if len(data) < 4 or data[:4] != _CONTAINER_MAGIC:
        raise FormatError("bad container magic: not a SHRK blob")
    if len(data) < 5:
        raise TruncatedArchiveError("truncated SHRK container: missing version")
    if data[4] != _CONTAINER_VERSION:
        raise FormatError(
            f"unsupported SHRK version {data[4]} (this build reads "
            f"v{_CONTAINER_VERSION} containers)"
        )
    if len(data) < 21:
        raise TruncatedArchiveError("truncated SHRK container: incomplete header")
    eps_hat, base_len = struct.unpack_from("<dI", data, 5)
    (hdr_crc,) = struct.unpack_from("<I", data, 17)
    pos = 21
    if pos + base_len > len(data):
        raise TruncatedArchiveError("truncated SHRK container: base blob cut short")
    base_bytes = data[pos : pos + base_len]
    pos += base_len
    if zlib.crc32(data[5:17] + base_bytes) & 0xFFFFFFFF != hdr_crc:
        raise CorruptFrameError("corrupt SHRK container: header/base CRC mismatch")
    if pos + 4 > len(data):
        raise TruncatedArchiveError("truncated SHRK container: missing pyramid length")
    (pyr_len,) = struct.unpack_from("<I", data, pos)
    pos += 4
    if pos + pyr_len > len(data):
        raise TruncatedArchiveError("truncated SHRK container: residual pyramid cut short")
    pyramid = decode_pyramid(data[pos : pos + pyr_len], strict=strict)
    pos += pyr_len
    if pos != len(data):
        raise CorruptFrameError("corrupt SHRK container: trailing bytes after pyramid")
    return CompressedSeries(
        base=decode_base(base_bytes),
        base_bytes=bytes(base_bytes),
        pyramid=pyramid,
        eps_b_practical=eps_hat,
    )
