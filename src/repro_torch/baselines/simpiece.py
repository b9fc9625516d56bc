"""Sim-Piece reimplementation (Kitsios et al., PVLDB 16(8), 2023),
counterpart of ``repro.baselines.simpiece``.

PLA with a *fixed* error threshold: shrinking cones anchored at origins
quantized onto the eps grid, grouped by origin, spans merged greedily after
sorting by the lower slope.  This is exactly SHRINK minus (a) the adaptive
threshold and (b) residuals — which makes it the natural ablation baseline.

Serialization mirrors the published format: per sub-base a zigzag-varint
origin-grid delta, a float32 slope, and varint timestamp deltas; segment
lengths are implicit in the global ordering of start indices.  The
segmenter and the merge run on the host in the reference's float order;
the decoder evaluates every piece's line ``b + slope * t`` as torch ops on
the card unless given ``device="cpu"``.
"""
from __future__ import annotations

import math
import struct

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.serialize import read_varint, write_varint
from .bitio import values_tensor

__all__ = ["compress", "decompress", "extract_segments"]

_MAGIC = b"SIMP"
_INF = math.inf


def extract_segments(values, eps: float) -> list[tuple[float, float, float, int, int]]:
    """Fixed-eps shrinking-cone scan (chunked-vectorized), on the host.

    Returns [(b, psi_lo, psi_hi, t0, length)] with b = floor(v0/eps)*eps.
    """
    values = values_tensor(values, "cpu").numpy()
    n = len(values)
    segs: list[tuple[float, float, float, int, int]] = []
    i = 0
    while i < n:
        b = math.floor(values[i] / eps) * eps
        psi_lo, psi_hi = -_INF, _INF
        j = i + 1
        chunk = 256
        closed = False
        while j < n:
            end = min(n, j + chunk)
            dt = np.arange(j - i, end - i, dtype=np.float64)
            seg_vals = values[j:end]
            hi = (seg_vals + (eps - b)) / dt
            lo = (seg_vals - (eps + b)) / dt
            run_hi = np.minimum(np.minimum.accumulate(hi), psi_hi)
            run_lo = np.maximum(np.maximum.accumulate(lo), psi_lo)
            viol = run_lo > run_hi
            if viol.any():
                idx = int(np.argmax(viol))
                if idx > 0:
                    psi_hi = float(run_hi[idx - 1])
                    psi_lo = float(run_lo[idx - 1])
                k = j + idx
                segs.append((b, psi_lo, psi_hi, i, k - i))
                i = k
                closed = True
                break
            psi_hi = float(run_hi[-1])
            psi_lo = float(run_lo[-1])
            j = end
            chunk = min(chunk * 2, 65536)
        if not closed:
            segs.append((b, psi_lo, psi_hi, i, n - i))
            i = n
    return segs


def compress(values, eps: float, device=None) -> bytes:
    v = values_tensor(values, device).cpu()
    n = v.numel()
    segs = extract_segments(v, eps)

    # group by origin grid index, merge sorted spans greedily
    groups: dict[int, list[tuple[float, float, float, int, int]]] = {}
    for seg in segs:
        idx = int(round(seg[0] / eps))
        groups.setdefault(idx, []).append(seg)

    subbases: list[tuple[int, float, list[int]]] = []  # (origin idx, slope, t0s)
    for idx in sorted(groups):
        group = sorted(groups[idx], key=lambda s: (s[1], s[2]))
        cur_lo, cur_hi = -_INF, _INF
        cur_t0s: list[int] = []
        for b, lo, hi, t0, ln in group:
            new_lo, new_hi = max(cur_lo, lo), min(cur_hi, hi)
            if not cur_t0s or new_lo <= new_hi:
                cur_lo, cur_hi = new_lo, new_hi
                cur_t0s.append(t0)
            else:
                subbases.append((idx, _mid_slope(cur_lo, cur_hi), sorted(cur_t0s)))
                cur_lo, cur_hi, cur_t0s = lo, hi, [t0]
        if cur_t0s:
            subbases.append((idx, _mid_slope(cur_lo, cur_hi), sorted(cur_t0s)))

    buf = bytearray()
    buf += _MAGIC
    write_varint(buf, n)
    buf += struct.pack("<d", eps)
    write_varint(buf, len(subbases))
    prev_idx = 0
    for idx, slope, t0s in subbases:
        z = idx - prev_idx
        write_varint(buf, (z << 1) ^ (z >> 63) if z < 0 else (z << 1))
        prev_idx = idx
        buf += struct.pack("<f", slope)
        write_varint(buf, len(t0s))
        prev_t = 0
        for t0 in t0s:
            write_varint(buf, t0 - prev_t)
            prev_t = t0
    return bytes(buf)


def _mid_slope(lo: float, hi: float) -> float:
    if math.isinf(lo) and math.isinf(hi):
        return 0.0
    if math.isinf(lo):
        return min(hi, 0.0)
    if math.isinf(hi):
        return max(lo, 0.0)
    return 0.5 * (lo + hi)


def decompress(blob: bytes, device=None) -> torch.Tensor:
    if blob[:4] != _MAGIC:
        raise ValueError("bad Sim-Piece magic")
    device = resolve_device(device)
    pos = 4
    n, pos = read_varint(blob, pos)
    (eps,) = struct.unpack_from("<d", blob, pos)
    pos += 8
    k, pos = read_varint(blob, pos)
    pieces: list[tuple[int, float, float]] = []  # (t0, b, slope)
    prev_idx = 0
    for _ in range(k):
        z, pos = read_varint(blob, pos)
        d = (z >> 1) ^ -(z & 1)
        idx = prev_idx + d
        prev_idx = idx
        (slope,) = struct.unpack_from("<f", blob, pos)
        pos += 4
        m, pos = read_varint(blob, pos)
        prev_t = 0
        for _ in range(m):
            dt, pos = read_varint(blob, pos)
            t0 = prev_t + dt
            prev_t = t0
            pieces.append((t0, idx * eps, float(slope)))
    pieces.sort()
    if not pieces:
        return torch.empty(n, dtype=torch.float64, device=device)
    # each position's piece and its offset t from the piece's start
    t0s, bs, slopes = zip(*pieces)
    t0s = torch.tensor(t0s + (n,), dtype=torch.int64, device=device)
    bs, slopes = (torch.tensor(c, dtype=torch.float64, device=device) for c in (bs, slopes))
    piece = torch.repeat_interleave(torch.arange(len(pieces), device=device), torch.diff(t0s),
                                    output_size=n)
    t = (torch.arange(n, device=device) - t0s[piece]).to(torch.float64)
    return bs[piece] + slopes[piece] * t
