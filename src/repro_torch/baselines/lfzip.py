"""LFZip baseline (Chandak et al., DCC 2020), counterpart of
``repro.baselines.lfzip`` — lossy floating-point compression via an
adaptive (NLMS) linear predictor + uniform quantization of the prediction
error + entropy coding.

Filter order 8 (the original defaults to 32; order 8 keeps the pure-Python
replay tractable on multi-hundred-k series).  Quantization uses step 2*eps
with round-to-nearest, so |v - v_hat| <= eps.  The predictor is
sequential: encoder and decoder replay it on the host in the reference's
float order; the quantized errors go through ``core.entropy`` (the
``best`` backend), and the decoder returns a float64 tensor on the card
unless given ``device="cpu"``.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from ..core import entropy
from ..core.device import resolve_device
from .bitio import values_tensor

__all__ = ["compress", "decompress", "ORDER"]

_MAGIC = b"LFZP"
ORDER = 8
_MU = 0.5
_EPS_NORM = 1e-6


def _nlms_quantize(vals: list[float], eps: float) -> tuple[list[int], float]:
    """Replay NLMS on reconstructed values; return quantized error ints."""
    step = 2.0 * eps
    w = [0.0] * ORDER
    hist = [0.0] * ORDER  # most recent first
    q = []
    for x in vals:
        pred = 0.0
        for j in range(ORDER):
            pred += w[j] * hist[j]
        e = x - pred
        qi = int(round(e / step))
        q.append(qi)
        recon = pred + qi * step
        # NLMS update with reconstructed error (decoder-replayable)
        err = recon - pred
        norm = _EPS_NORM
        for j in range(ORDER):
            norm += hist[j] * hist[j]
        g = _MU * err / norm
        for j in range(ORDER):
            w[j] += g * hist[j]
        hist.pop()
        hist.insert(0, recon)
    return q, step


def compress(values, eps: float, device=None) -> bytes:
    v = values_tensor(values, device)
    q, step = _nlms_quantize(v.tolist(), eps)
    payload = entropy.encode_ints(torch.tensor(q, dtype=torch.int64, device=v.device),
                                  backend="best")
    return _MAGIC + struct.pack("<Qd", v.numel(), step) + payload


def decompress(blob: bytes, device=None) -> torch.Tensor:
    if blob[:4] != _MAGIC:
        raise ValueError("bad LFZip magic")
    device = resolve_device(device)
    n, step = struct.unpack_from("<Qd", blob, 4)
    ql = entropy.decode_ints(blob[20:], device).tolist()
    out = np.empty(n, dtype=np.float64)
    w = [0.0] * ORDER
    hist = [0.0] * ORDER
    for i in range(n):
        pred = 0.0
        for j in range(ORDER):
            pred += w[j] * hist[j]
        recon = pred + ql[i] * step
        out[i] = recon
        err = recon - pred
        norm = _EPS_NORM
        for j in range(ORDER):
            norm += hist[j] * hist[j]
        g = _MU * err / norm
        for j in range(ORDER):
            w[j] += g * hist[j]
        hist.pop()
        hist.insert(0, recon)
    return torch.from_numpy(out).to(device)
