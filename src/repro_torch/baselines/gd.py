"""Generalized Deduplication baseline (Vestergaard et al., INFOCOM 2020;
GreedyGD, Hurst et al., 2024), counterpart of ``repro.baselines.gd`` —
lossless, random-access-friendly.

Values with d decimals are lifted to integers at scale 10^d; each integer is
split into a high-bit *base* and a low-bit *deviation*.  Bases deduplicate
through a dictionary; the stream stores per-value (base id, deviation).  The
deviation width is chosen per dataset by exhaustive cost scan (one
``torch.unique`` a width, on the values' device).  The integers, the split,
the dictionary ids and the bit packing are torch ops on the values'
device; the decoder divides by ``10^d`` as a tensor (an IEEE division on
the card too, where ``x / float`` would be a reciprocal multiply).
"""
from __future__ import annotations

import math
import struct

import torch

from ..core.device import resolve_device
from ..core.serialize import read_varint, write_varint
from ..kernels.segment_agg import _div
from .bitio import pack_fixed, unpack_fixed, values_tensor

__all__ = ["compress", "decompress", "choose_deviation_bits"]

_MAGIC = b"GDDP"


def _to_ints(values: torch.Tensor, decimals: int) -> torch.Tensor:
    return torch.round(values * 10.0**decimals).to(torch.int64)


def choose_deviation_bits(ints) -> tuple[int, int]:
    """Scan deviation widths; return (bits, estimated_total_bytes)."""
    ints = torch.as_tensor(ints).to(torch.int64)
    off = ints - ints.min()
    max_bits = max(1, int(off.max()).bit_length()) if off.numel() else 1
    best = (0, math.inf)
    for b in range(0, max_bits + 1):
        u = int(torch.unique(off >> b).numel())
        id_bits = max(1, (u - 1).bit_length()) if u > 1 else 1
        cost = u * 8 + (off.numel() * (id_bits + b)) / 8
        if cost < best[1]:
            best = (b, cost)
    return best[0], int(best[1])


def compress(values, decimals: int, device=None) -> bytes:
    ints = _to_ints(values_tensor(values, device), decimals)
    lo = int(ints.min()) if ints.numel() else 0
    off = ints - lo
    b, _ = choose_deviation_bits(ints)
    bases = off >> b
    devs = off & ((1 << b) - 1) if b else torch.zeros_like(bases)
    uniq, ids = torch.unique(bases, sorted=True, return_inverse=True)
    id_bits = max(1, (len(uniq) - 1).bit_length()) if len(uniq) > 1 else 1

    buf = bytearray()
    buf += _MAGIC
    write_varint(buf, ints.numel())
    buf += struct.pack("<qBB", lo, decimals, b)
    write_varint(buf, len(uniq))
    prev = 0
    for u in uniq.tolist():  # sorted ascending -> delta varint
        write_varint(buf, u - prev)
        prev = u
    ids_packed = pack_fixed(ids, id_bits)
    devs_packed = pack_fixed(devs, b)
    buf.append(id_bits)
    write_varint(buf, len(ids_packed))
    buf += ids_packed
    write_varint(buf, len(devs_packed))
    buf += devs_packed
    return bytes(buf)


def decompress(blob: bytes, device=None) -> torch.Tensor:
    if blob[:4] != _MAGIC:
        raise ValueError("bad GD magic")
    device = resolve_device(device)
    pos = 4
    n, pos = read_varint(blob, pos)
    lo, decimals, b = struct.unpack_from("<qBB", blob, pos)
    pos += 10
    u, pos = read_varint(blob, pos)
    uniq = []
    prev = 0
    for _ in range(u):
        d, pos = read_varint(blob, pos)
        prev += d
        uniq.append(prev)
    id_bits = blob[pos]
    pos += 1
    ids_len, pos = read_varint(blob, pos)
    ids = unpack_fixed(blob[pos : pos + ids_len], n, id_bits, device)
    pos += ids_len
    devs_len, pos = read_varint(blob, pos)
    devs = unpack_fixed(blob[pos : pos + devs_len], n, b, device)
    uniq_t = torch.tensor(uniq, dtype=torch.int64, device=device)
    ints = (uniq_t[ids] << b) + devs + lo
    return _div(ints.to(torch.float64), 10.0**decimals)
