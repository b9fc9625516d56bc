"""Residuals encoding (Alg. 6 + Eq. 6), counterpart of
``repro.core.residuals``: the refinement-ladder quantizer in torch on the
device.

Tier k quantizes the reconstruction error left by tiers 0..k-1 with the
midpoint quantizer (step = 2 * eps, dequant at bin midpoints, |error| <=
eps); the lossless tier (eps == 0.0) is the integer difference at scale
10^decimals.  Every op is elementwise or a per-row reduction, so row s is
bit-identical to the numpy quantizer on that row.  Division by a scalar
goes through a device tensor: CUDA torch would otherwise multiply by the
reciprocal, which is not the same float.
"""
from __future__ import annotations

import torch

from . import entropy
from .types import ResidualStream

__all__ = [
    "encode_residuals_batch",
    "normalize_tiers",
    "quantize_pyramid",
    "quantize_pyramid_batch",
]


def normalize_tiers(eps_targets: list[float], decimals: int | None) -> list[float]:
    """Canonical tier ladder: unique eps targets sorted coarse -> fine, the
    lossless tier (0.0) last."""
    tiers = sorted({float(e) for e in eps_targets}, reverse=True)
    if tiers and tiers[-1] < 0.0:
        raise ValueError(f"eps targets must be >= 0, got {tiers[-1]}")
    if tiers and tiers[-1] == 0.0 and decimals is None:
        raise ValueError("lossless stream requires `decimals`")
    return tiers


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b as a true IEEE division on any device."""
    return torch.div(a, torch.tensor(b, dtype=a.dtype, device=a.device))


def _midpoint_rows_masked(
    e: torch.Tensor, eps_r: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Midpoint quantizer on rows e[S, T]: (q int64 [S, T], r_lo [S], deq
    [S, T]), with ``deq`` recomputed from the corrected q exactly as a
    decoder computes it."""
    step = 2.0 * eps_r
    r_lo = e.amin(dim=1) if e.numel() else e.new_zeros(e.shape[0])
    rl = r_lo[:, None]
    q = torch.floor(_div(e - rl, step)).long()
    # floor at bin boundaries can land one bin off in floating point;
    # correct so |e - dequant| <= step / 2 holds
    deq = rl + (q.double() + 0.5) * step
    q = q + ((e - deq) > step / 2).long() - ((deq - e) > step / 2).long()
    deq = rl + (q.double() + 0.5) * step
    return q, r_lo, deq


def quantize_pyramid_batch(
    values: torch.Tensor,
    preds: torch.Tensor,
    tiers: list[float],
    decimals: int | None = None,
) -> list[list[ResidualStream | None]]:
    """Refinement-ladder quantization over rows values/preds[S, T].

    ``tiers`` is the :func:`normalize_tiers` ladder.  Returns
    ``layers[s][k]``: the stream of series s at tier k, or ``None`` (an
    identity layer) where the prefix through tier k-1 already meets tier k.
    """
    values = values.to(torch.float64)
    preds = preds.to(torch.float64)
    s, t = values.shape
    out: list[list[ResidualStream | None]] = [[None] * len(tiers) for _ in range(s)]
    recon = preds
    for k, eps in enumerate(tiers):
        if eps == 0.0:
            if decimals is None:
                raise ValueError("lossless stream requires `decimals`")
            scale = 10.0**decimals
            q = torch.round(values * scale).long() - torch.round(recon * scale).long()
            for i in range(s):
                out[i][k] = ResidualStream(
                    eps_r=0.0, step=1.0 / scale, r_lo=0.0, mode="exact", q=q[i]
                )
            continue
        e = values - recon
        m = e.abs().amax(dim=1) if t else e.new_zeros(s)
        need = torch.nonzero(m > eps).reshape(-1)
        if need.numel() == 0:
            continue  # identity layer for every row
        full = need.numel() == s
        q, r_lo, deq = _midpoint_rows_masked(e if full else e[need], eps)
        if full:
            recon = recon + deq
        else:
            recon = recon.clone()
            recon[need] = recon[need] + deq
        step = 2.0 * eps
        for j, (i, lo) in enumerate(zip(need.tolist(), r_lo.tolist())):
            out[i][k] = ResidualStream(eps_r=eps, step=step, r_lo=lo, mode="midpoint", q=q[j])
    return out


def quantize_pyramid(
    values: torch.Tensor,
    pred: torch.Tensor,
    tiers: list[float],
    decimals: int | None = None,
) -> list[ResidualStream | None]:
    """Single-series refinement ladder: the S == 1 row of
    :func:`quantize_pyramid_batch`."""
    return quantize_pyramid_batch(values[None], pred[None], tiers, decimals)[0]


def encode_residuals_batch(streams: list[ResidualStream], backend: str = "rans") -> list[bytes]:
    """Entropy-encode a batch of residual streams in one pass."""
    return entropy.encode_ints_batch([st.q for st in streams], backend=backend)
