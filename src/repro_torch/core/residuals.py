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

import math

import numpy as np
import torch

from ..kernels.segment_agg import _div
from . import entropy
from .base import base_predictions
from .types import Base, ResidualStream

__all__ = [
    "compute_residuals",
    "dequantize_exact",
    "dequantize_residuals",
    "encode_residuals_batch",
    "normalize_tiers",
    "quantize_exact",
    "quantize_exact_batch",
    "quantize_pyramid",
    "quantize_pyramid_batch",
    "quantize_residuals",
    "quantize_residuals_batch",
]


def _f64(values) -> torch.Tensor:
    return torch.as_tensor(values).to(torch.float64)


def compute_residuals(values, base: Base) -> torch.Tensor:
    """values - the base's predictions (float64, on values' device)."""
    values = _f64(values)
    return values - base_predictions(base, values.device)


def normalize_tiers(eps_targets: list[float], decimals: int | None) -> list[float]:
    """Canonical tier ladder: unique eps targets sorted coarse -> fine, the
    lossless tier (0.0) last."""
    tiers = sorted({float(e) for e in eps_targets}, reverse=True)
    if tiers and tiers[-1] < 0.0:
        raise ValueError(f"eps targets must be >= 0, got {tiers[-1]}")
    if tiers and tiers[-1] == 0.0 and decimals is None:
        raise ValueError("lossless stream requires `decimals`")
    return tiers


def _midpoint_rows_masked(
    e: torch.Tensor, eps_r: float, ns: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Midpoint quantizer on rows e[S, T], optionally ragged (row i valid in
    its first ``ns[i]`` entries): (q int64 [S, T], r_lo [S], deq [S, T]),
    with ``deq`` recomputed from the corrected q exactly as a decoder
    computes it."""
    step = 2.0 * eps_r
    if ns is None:
        r_lo = e.amin(dim=1) if e.numel() else e.new_zeros(e.shape[0])
    else:
        pad = torch.arange(e.shape[1], device=e.device)[None, :] >= ns[:, None]
        r_lo = e.masked_fill(pad, math.inf).amin(dim=1) if e.shape[1] else e.new_zeros(len(ns))
        r_lo = torch.where(ns > 0, r_lo, 0.0)
    rows = torch.nonzero(r_lo == 0).reshape(-1) if e.numel() else r_lo.new_zeros(0).long()
    if rows.numel():
        # a zero minimum's sign (stored in the layer) depends on the
        # reduction order: those rows take numpy's, in the reference's
        # expression
        host = e[rows].cpu().numpy()
        if ns is None:
            lo = host.min(axis=1)
        else:
            nh = ns[rows].cpu().numpy()
            padh = np.arange(host.shape[1])[None, :] >= nh[:, None]
            lo = np.where(nh > 0, np.where(padh, np.inf, host).min(axis=1, initial=np.inf), 0.0)
        r_lo = r_lo.clone()
        r_lo[rows] = torch.as_tensor(lo, device=e.device)
    rl = r_lo[:, None]
    q = torch.floor(_div(e - rl, step)).long()
    # floor at bin boundaries can land one bin off in floating point;
    # correct so |e - dequant| <= step / 2 holds
    deq = rl + (q.double() + 0.5) * step
    q = q + ((e - deq) > step / 2).long() - ((deq - e) > step / 2).long()
    deq = rl + (q.double() + 0.5) * step
    return q, r_lo, deq


def quantize_residuals(r, eps_r: float) -> ResidualStream:
    """Lossy path: |dequant - r| <= eps_r."""
    return quantize_residuals_batch(_f64(r)[None], eps_r)[0]


def quantize_residuals_batch(r, eps_r: float, lengths=None) -> list[ResidualStream]:
    """Batched lossy path over rows r[S, T]; stream i equals
    ``quantize_residuals(r[i], eps_r)``, or with ``lengths`` (ragged rows
    padded to T) ``quantize_residuals(r[i, :lengths[i]], eps_r)``."""
    if eps_r <= 0:
        raise ValueError("eps_r must be positive for the lossy path")
    r = _f64(r)
    s, t = r.shape
    ends, ns = [t] * s, None
    if lengths is not None:
        ends = torch.as_tensor(lengths, dtype=torch.int64).reshape(-1).tolist()
        ns = torch.tensor(ends, dtype=torch.int64, device=r.device)
        r = r.masked_fill(torch.arange(t, device=r.device)[None, :] >= ns[:, None], 0.0)
    q, r_lo, _ = _midpoint_rows_masked(r, eps_r, ns)
    return [
        ResidualStream(eps_r=eps_r, step=2.0 * eps_r, r_lo=lo, mode="midpoint", q=q[i, : ends[i]])
        for i, lo in enumerate(r_lo.tolist())
    ]


def dequantize_residuals(stream: ResidualStream) -> torch.Tensor:
    if stream.mode == "midpoint":
        return stream.r_lo + (stream.q.double() + 0.5) * stream.step
    raise ValueError(f"not a lossy stream: {stream.mode}")


def quantize_exact(values, base: Base, decimals: int, pred=None) -> ResidualStream:
    """Lossless path for fixed-decimal data: q = round(v * 10^d) -
    round(pred * 10^d), exact int64; ``pred`` defaults to the base's
    predictions."""
    values = _f64(values)
    if pred is None:
        pred = base_predictions(base, values.device)
    return quantize_exact_batch(values[None], _f64(pred)[None], decimals)[0]


def quantize_exact_batch(values, preds, decimals: int, lengths=None) -> list[ResidualStream]:
    """Batched lossless path over rows values/preds[S, T]; with ``lengths``
    each q stream is cut at its row's length."""
    scale = 10.0**decimals
    q = torch.round(_f64(values) * scale).long() - torch.round(_f64(preds) * scale).long()
    ends = [q.shape[1]] * q.shape[0]
    if lengths is not None:
        ends = torch.as_tensor(lengths, dtype=torch.int64).reshape(-1).tolist()
    return [
        ResidualStream(eps_r=0.0, step=1.0 / scale, r_lo=0.0, mode="exact", q=q[i, : ends[i]])
        for i in range(q.shape[0])
    ]


def dequantize_exact(stream: ResidualStream, base: Base, decimals: int) -> torch.Tensor:
    scale = 10.0**decimals
    p_int = torch.round(base_predictions(base, stream.q.device) * scale).long()
    return _div((p_int + stream.q).double(), scale)


def quantize_pyramid_batch(
    values: torch.Tensor,
    preds: torch.Tensor,
    tiers: list[float],
    decimals: int | None = None,
    lengths=None,
) -> list[list[ResidualStream | None]]:
    """Refinement-ladder quantization over rows values/preds[S, T].

    ``tiers`` is the :func:`normalize_tiers` ladder.  Returns
    ``layers[s][k]``: the stream of series s at tier k, or ``None`` (an
    identity layer) where the prefix through tier k-1 already meets tier k.
    With ``lengths`` (ragged rows padded to T) the per-row reductions run
    over each row's valid prefix and every stream is cut at its row's end.
    """
    values = values.to(torch.float64)
    preds = preds.to(torch.float64)
    s, t = values.shape
    ns = None
    ends = [t] * s
    if lengths is not None:
        ends = torch.as_tensor(lengths, dtype=torch.int64).reshape(-1).tolist()
        ns = torch.tensor(ends, dtype=torch.int64, device=values.device)
        pad = torch.arange(t, device=values.device)[None, :] >= ns[:, None]
        values = values.masked_fill(pad, 0.0)
        preds = preds.masked_fill(pad, 0.0)
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
                    eps_r=0.0, step=1.0 / scale, r_lo=0.0, mode="exact", q=q[i, : ends[i]]
                )
            continue
        e = values - recon
        if ns is not None:
            e = e.masked_fill(pad, 0.0)
        m = e.abs().amax(dim=1) if t else e.new_zeros(s)
        need = torch.nonzero(m > eps).reshape(-1)
        if need.numel() == 0:
            continue  # identity layer for every row
        full = need.numel() == s
        q, r_lo, deq = _midpoint_rows_masked(
            e if full else e[need], eps, None if ns is None else ns[need]
        )
        if full:
            recon = recon + deq
        else:
            recon = recon.clone()
            recon[need] = recon[need] + deq
        step = 2.0 * eps
        for j, (i, lo) in enumerate(zip(need.tolist(), r_lo.tolist())):
            out[i][k] = ResidualStream(
                eps_r=eps, step=step, r_lo=lo, mode="midpoint", q=q[j, : ends[i]]
            )
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


def encode_residuals_batch(streams: list[ResidualStream], backend: str = "best") -> list[bytes]:
    """Entropy-encode a batch of residual streams in one pass."""
    return entropy.encode_ints_batch([st.q for st in streams], backend=backend)
