"""General-purpose lossless baselines, counterpart of
``repro.baselines.standard``: GZip, BZip2, zstd, and TRC.

Input representation: the raw float64 value stream (8 B/value).  Timestamps
are a regular grid for every benchmark series and are reconstructible for
free by all methods (SHRINK does not store them either), so the comparison
is apples-to-apples; the CR denominator (16 B/row) is shared.

"TRC" (Turbo Range Coder) is the adaptive range coder of ``core.entropy``
on the byte stream (small inputs) or the byte-transposed layout (large
inputs) through zstd where it imports, else through the rANS coder.  The
byte planes are torch ops on the values' device, and on the card the rANS
stage launches the ``rans_encode`` and ``rans_decode`` kernels.  GZip,
BZip2, zstd and the range coder run on the host.  Decoders return a
float64 tensor on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

import bz2 as _bz2
import struct
import zlib as _zlib

import numpy as np
import torch

from ..core import entropy
from ..core.device import resolve_device
from .bitio import values_tensor

try:
    import zstandard as _zstd
except Exception:  # pragma: no cover - depends on the installation
    _zstd = None

__all__ = ["gzip_c", "bzip2_c", "zstd_c", "trc_c"]


def _tag(name: bytes, n: int, payload: bytes) -> bytes:
    return name + struct.pack("<Q", n) + payload


def _untag(blob: bytes) -> tuple[bytes, int, bytes]:
    return blob[:4], struct.unpack_from("<Q", blob, 4)[0], blob[12:]


def _raw(values, device) -> tuple[int, bytes]:
    v = values_tensor(values, device)
    return v.numel(), v.cpu().numpy().tobytes()


def _from_raw(raw: bytes, device) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(raw, dtype=np.float64).copy()).to(
        resolve_device(device))


class gzip_c:
    name = "GZip"

    @staticmethod
    def compress(values, device=None) -> bytes:
        n, raw = _raw(values, device)
        return _tag(b"GZIP", n, _zlib.compress(raw, 9))

    @staticmethod
    def decompress(blob: bytes, device=None) -> torch.Tensor:
        _, n, payload = _untag(blob)
        return _from_raw(_zlib.decompress(payload), device)


class bzip2_c:
    name = "BZip2"

    @staticmethod
    def compress(values, device=None) -> bytes:
        n, raw = _raw(values, device)
        return _tag(b"BZP2", n, _bz2.compress(raw, 9))

    @staticmethod
    def decompress(blob: bytes, device=None) -> torch.Tensor:
        _, n, payload = _untag(blob)
        return _from_raw(_bz2.decompress(payload), device)


class zstd_c:
    name = "zstd"

    @staticmethod
    def compress(values, device=None) -> bytes:
        n, raw = _raw(values, device)
        return _tag(b"ZSTD", n, _zstd.ZstdCompressor(level=19).compress(raw))

    @staticmethod
    def decompress(blob: bytes, device=None) -> torch.Tensor:
        _, n, payload = _untag(blob)
        return _from_raw(_zstd.ZstdDecompressor().decompress(payload), device)


class trc_c:
    name = "TRC"
    _RC_LIMIT = 150_000  # bytes through the pure-python coder

    @staticmethod
    def compress(values, device=None) -> bytes:
        v = values_tensor(values, device)
        n = v.numel()
        if n * 8 <= trc_c._RC_LIMIT:
            sym = v.contiguous().view(torch.uint8).to(torch.int64)
            payload = b"\x00" + entropy.encode_ints(sym, backend="rc")
        else:
            # byte-plane transposition (BWT-like reordering) + entropy stage:
            # zstd when installed, the rANS coder otherwise
            bits = v.contiguous().view(torch.int64)
            mat = torch.stack([(bits >> (8 * i)) & 0xFF for i in range(8)])
            if _zstd is not None:
                body = mat.to(torch.uint8).cpu().numpy().tobytes()
                payload = b"\x01" + _zstd.ZstdCompressor(level=19).compress(body)
            else:
                payload = b"\x02" + entropy.encode_ints(mat.reshape(-1), backend="rans")
        return _tag(b"TRC0", n, payload)

    @staticmethod
    def decompress(blob: bytes, device=None) -> torch.Tensor:
        device = resolve_device(device)
        _, n, payload = _untag(blob)
        mode, body = payload[0], payload[1:]
        if mode == 0:
            return entropy.decode_ints(body, device).to(torch.uint8).view(torch.float64)
        if mode == 2:
            mat = entropy.decode_ints(body, device).reshape(8, n)
        else:
            if _zstd is None:
                raise RuntimeError(
                    "this TRC blob was encoded with the zstd entropy stage; "
                    "install the 'zstandard' extra to decode it"
                )
            raw = _zstd.ZstdDecompressor().decompress(body)
            mat = torch.from_numpy(np.frombuffer(raw, dtype=np.uint8).copy()).to(
                device).reshape(8, n).to(torch.int64)
        bits = mat[0].clone()
        for i in range(1, 8):
            bits |= mat[i] << (8 * i)
        return bits.view(torch.float64)
