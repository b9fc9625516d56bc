"""Gorilla float compression (Pelkonen et al., PVLDB 8(12), 2015),
counterpart of ``repro.baselines.gorilla`` — lossless XOR-based encoding of
float64 streams with leading/trailing-zero windows.

The XOR coder is sequential: it runs on the host over the values' bits,
as the reference's does; the decoder returns a float64 tensor on the card
unless given ``device="cpu"``.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from ..core.device import resolve_device
from .bitio import BitReader, BitWriter, values_tensor

__all__ = ["compress", "decompress"]

_MAGIC = b"GORI"


def _clz64(x: int) -> int:
    return 64 - x.bit_length() if x else 64


def _ctz64(x: int) -> int:
    return (x & -x).bit_length() - 1 if x else 64


def compress(values, device=None) -> bytes:
    bits = values_tensor(values, device).cpu().numpy().view(np.uint64)
    n = len(bits)
    w = BitWriter()
    prev = 0
    prev_lz, prev_tz = -1, -1
    first = True
    for cur in bits.tolist():
        if first:
            w.write(cur, 64)
            prev = cur
            first = False
            continue
        xor = cur ^ prev
        prev = cur
        if xor == 0:
            w.write(0, 1)
            continue
        lz = min(_clz64(xor), 31)
        tz = _ctz64(xor)
        if prev_lz >= 0 and lz >= prev_lz and tz >= prev_tz:
            meaning = 64 - prev_lz - prev_tz
            w.write(0b10, 2)
            w.write(xor >> prev_tz, meaning)
        else:
            meaning = 64 - lz - tz
            w.write(0b11, 2)
            w.write(lz, 5)
            w.write(meaning - 1, 6)
            w.write(xor >> tz, meaning)
            prev_lz, prev_tz = lz, tz
    return _MAGIC + struct.pack("<Q", n) + w.finish()


def decompress(blob: bytes, device=None) -> torch.Tensor:
    if blob[:4] != _MAGIC:
        raise ValueError("bad Gorilla magic")
    device = resolve_device(device)
    (n,) = struct.unpack_from("<Q", blob, 4)
    r = BitReader(blob[12:])
    out = np.empty(n, dtype=np.uint64)
    if n:
        prev = r.read(64)
        out[0] = prev
        prev_lz, prev_tz = -1, -1
        for i in range(1, n):
            if r.read(1) == 0:
                out[i] = prev
                continue
            if r.read(1) == 0:  # '10' reuse window
                meaning = 64 - prev_lz - prev_tz
                xor = r.read(meaning) << prev_tz
            else:  # '11' new window
                lz = r.read(5)
                meaning = r.read(6) + 1
                tz = 64 - lz - meaning
                xor = r.read(meaning) << tz
                prev_lz, prev_tz = lz, tz
            prev ^= xor
            out[i] = prev
    return torch.from_numpy(out.view(np.int64)).view(torch.float64).to(device)
