"""APCA baseline (Keogh et al., SIGMOD 2001), counterpart of
``repro.baselines.apca``: adaptive piecewise-constant approximation with an
L-infinity guarantee.

Greedy max-length segments: extend while (running max - running min) <= 2*eps;
the segment value is the mid-range.  Serialization: varint length + f32 value
per segment.  The segmenter runs on the host in the reference's order; the
decoder repeats each segment's value on the card unless given
``device="cpu"``.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.serialize import read_varint, write_varint
from .bitio import values_tensor

__all__ = ["compress", "decompress"]

_MAGIC = b"APCA"


def _segments(values: np.ndarray, eps: float) -> list[tuple[int, float]]:
    n = len(values)
    out: list[tuple[int, float]] = []
    i = 0
    while i < n:
        vmin = vmax = float(values[i])
        j = i + 1
        chunk = 256
        closed = False
        while j < n:
            end = min(n, j + chunk)
            seg = values[j:end]
            run_max = np.maximum(np.maximum.accumulate(seg), vmax)
            run_min = np.minimum(np.minimum.accumulate(seg), vmin)
            viol = (run_max - run_min) > 2 * eps
            if viol.any():
                idx = int(np.argmax(viol))
                if idx > 0:
                    vmax = float(run_max[idx - 1])
                    vmin = float(run_min[idx - 1])
                k = j + idx
                out.append((k - i, 0.5 * (vmin + vmax)))
                i = k
                closed = True
                break
            vmax = float(run_max[-1])
            vmin = float(run_min[-1])
            j = end
            chunk = min(chunk * 2, 65536)
        if not closed:
            out.append((n - i, 0.5 * (vmin + vmax)))
            i = n
    return out


def compress(values, eps: float, device=None) -> bytes:
    v = values_tensor(values, device).cpu().numpy()
    segs = _segments(v, eps)
    buf = bytearray()
    buf += _MAGIC
    write_varint(buf, len(v))
    write_varint(buf, len(segs))
    for ln, val in segs:
        write_varint(buf, ln)
        buf += struct.pack("<f", val)
    return bytes(buf)


def decompress(blob: bytes, device=None) -> torch.Tensor:
    if blob[:4] != _MAGIC:
        raise ValueError("bad APCA magic")
    device = resolve_device(device)
    pos = 4
    n, pos = read_varint(blob, pos)
    k, pos = read_varint(blob, pos)
    lens, vals = [], []
    for _ in range(k):
        ln, pos = read_varint(blob, pos)
        (val,) = struct.unpack_from("<f", blob, pos)
        pos += 4
        lens.append(ln)
        vals.append(val)
    if sum(lens) != n:
        raise ValueError(f"APCA segments cover {sum(lens)} values, not {n}")
    return torch.repeat_interleave(torch.tensor(vals, dtype=torch.float64, device=device),
                                   torch.tensor(lens, dtype=torch.int64, device=device),
                                   output_size=n)
