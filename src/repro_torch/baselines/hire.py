"""HIRE-style baseline (Barbarioli et al., SIGMOD/PACMMOD 2023),
counterpart of ``repro.baselines.hire`` — hierarchical residual encoding
with max-error pruning.

Top-down dyadic decomposition: a node covering [lo, hi) stores its mid-range
value; if every point is within eps of it the node is a leaf, otherwise it
splits in half and the children encode residual structure.  Leaf values are
quantized onto the eps grid and entropy-coded (``core.entropy``, the
``best`` backend); the tree shape is a bit per node.  The tree walk runs on
the host in the reference's order; the decoder spreads the leaves' values
over their ranges as torch ops on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from ..core import entropy
from ..core.device import resolve_device
from .bitio import BitReader, BitWriter, values_tensor

__all__ = ["compress", "decompress"]

_MAGIC = b"HIRE"


def compress(values, eps: float, device=None) -> bytes:
    v = values_tensor(values, device)
    values = v.cpu().numpy()
    n = len(values)
    structure = BitWriter()
    leaf_vals: list[int] = []

    # iterative DFS, preorder; grid-quantize leaf mid-ranges to step eps
    stack: list[tuple[int, int]] = [(0, n)]
    while stack:
        lo, hi = stack.pop()
        seg = values[lo:hi]
        vmin = float(seg.min())
        vmax = float(seg.max())
        mid = 0.5 * (vmin + vmax)
        qmid = int(round(mid / eps)) if eps > 0 else 0
        ok = (vmax - vmin) <= 2 * eps and abs(qmid * eps - mid) + 0.5 * (vmax - vmin) <= eps
        if ok or hi - lo == 1:
            structure.write(1, 1)
            if hi - lo == 1:
                qmid = int(round(float(seg[0]) / eps))
            leaf_vals.append(qmid)
        else:
            structure.write(0, 1)
            m = (lo + hi) // 2
            stack.append((m, hi))  # preorder: left first -> push right first
            stack.append((lo, m))
    sbits = structure.finish()
    payload = entropy.encode_ints(torch.tensor(leaf_vals, dtype=torch.int64, device=v.device),
                                  backend="best")
    return _MAGIC + struct.pack("<Qd I", n, eps, len(sbits)) + sbits + payload


def decompress(blob: bytes, device=None) -> torch.Tensor:
    if blob[:4] != _MAGIC:
        raise ValueError("bad HIRE magic")
    device = resolve_device(device)
    n, eps, slen = struct.unpack_from("<QdI", blob, 4)
    off = 4 + 20
    sbits = BitReader(blob[off : off + slen])
    leaf_vals = entropy.decode_ints(blob[off + slen :], device)
    lens: list[int] = []  # each leaf's range, in preorder (= position order)
    stack: list[tuple[int, int]] = [(0, n)]
    while stack:
        lo, hi = stack.pop()
        if sbits.read(1) == 1:
            lens.append(hi - lo)
        else:
            m = (lo + hi) // 2
            stack.append((m, hi))
            stack.append((lo, m))
    vals = leaf_vals[: len(lens)].to(torch.float64) * eps
    return torch.repeat_interleave(vals, torch.tensor(lens, dtype=torch.int64, device=device),
                                   output_size=n)
