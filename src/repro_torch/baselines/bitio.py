"""Bit-level IO helpers shared by the baselines, counterpart of
``repro.baselines.bitio``.

``BitWriter`` and ``BitReader`` are the reference's host coders (Gorilla's
and HIRE's sequential streams).  ``pack_fixed`` and ``unpack_fixed`` are
torch ops on the values' device (MSB first, numpy's ``packbits`` order):
byte for byte the reference's.  ``values_tensor`` is how every baseline
takes its input: a tensor stays on its device, an ndarray goes to
``device`` (the card unless ``"cpu"``), both as float64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["BitWriter", "BitReader", "pack_fixed", "unpack_fixed", "values_tensor"]


def values_tensor(values, device=None) -> torch.Tensor:
    """float64 1-D values: a tensor on its own device, anything else on
    ``device`` (default the card)."""
    if isinstance(values, torch.Tensor):
        return values.to(torch.float64).reshape(-1)
    return torch.as_tensor(np.asarray(values, dtype=np.float64).reshape(-1),
                           device=resolve_device(device))


class BitWriter:
    """MSB-first bit writer; ~O(1) amortized per write call."""

    def __init__(self) -> None:
        self.buf = bytearray()
        self.acc = 0
        self.nacc = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.nacc += nbits
        while self.nacc >= 8:
            self.nacc -= 8
            self.buf.append((self.acc >> self.nacc) & 0xFF)
        self.acc &= (1 << self.nacc) - 1

    def finish(self) -> bytes:
        if self.nacc:
            self.buf.append((self.acc << (8 - self.nacc)) & 0xFF)
            self.acc = 0
            self.nacc = 0
        return bytes(self.buf)


class BitReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0  # bit position

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        out = 0
        pos = self.pos
        data = self.data
        for _ in range(nbits):
            byte = data[pos >> 3] if (pos >> 3) < len(data) else 0
            bit = (byte >> (7 - (pos & 7))) & 1
            out = (out << 1) | bit
            pos += 1
        self.pos = pos
        return out


def _shifts(width: int, device) -> torch.Tensor:
    return torch.arange(width - 1, -1, -1, dtype=torch.int64, device=device)


def pack_fixed(vals: torch.Tensor, width: int) -> bytes:
    """Fixed-width bit packing of non-negative int64s, on their device."""
    if width == 0 or vals.numel() == 0:
        return b""
    v = torch.as_tensor(vals).to(torch.int64).reshape(-1)
    bits = ((v[:, None] >> _shifts(width, v.device)) & 1).reshape(-1)
    bits = torch.nn.functional.pad(bits, (0, (-bits.numel()) % 8)).reshape(-1, 8)
    packed = (bits << _shifts(8, v.device)).sum(1).to(torch.uint8)
    return packed.cpu().numpy().tobytes()


def unpack_fixed(data: bytes, count: int, width: int, device=None) -> torch.Tensor:
    """int64 [count] on ``device`` (default the card) from
    :func:`pack_fixed`'s bytes."""
    device = resolve_device(device)
    if width == 0 or count == 0:
        return torch.zeros(count, dtype=torch.int64, device=device)
    raw = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device).to(torch.int64)
    bits = ((raw[:, None] >> _shifts(8, device)) & 1).reshape(-1)[: count * width]
    return (bits.reshape(count, width) << _shifts(width, device)).sum(1)
