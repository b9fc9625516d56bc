"""Semantics extraction via shrinking cones (Alg. 3), counterpart of
``repro.core.semantics``.

A cone starts at index ``t0`` with origin ``theta = floor(v / eps_hat) *
eps_hat`` and keeps the running intersection (psi_lo, psi_hi) of the slope
intervals ``[(v_i - eps_hat - theta) / dt, (v_i + eps_hat - theta) / dt]``
of the points after it; when the intersection empties, the cone closes and
a new one starts at the violating point.

``extract_semantics_batch`` runs the whole batch on the series' device:
the fluctuation table (Alg. 2) in torch, the scan in the cone-scan kernel
(``kernels.cone_scan``), the segment compaction in torch, and only the
``Segment`` records are built on the host.  It runs in float64 with
unbounded (+-inf) initial spans, so every row is bit-identical to the host
scan ``repro.core.semantics.extract_semantics`` on that series.
``extract_semantics`` is its S = 1 row.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .phases import fluctuation_table
from .types import Segment, ShrinkConfig

__all__ = ["extract_semantics", "extract_semantics_batch", "global_range"]


def global_range(values: torch.Tensor) -> tuple[float, float]:
    if values.numel() == 0:  # empty series compress to an empty base
        return 0.0, 0.0
    return float(values.min()), float(values.max())


def extract_semantics_batch(
    values: torch.Tensor,
    config: ShrinkConfig,
    value_range: tuple[float, float] | None = None,
    n_hint: int | None = None,
) -> list[list[Segment]]:
    """Multi-series cone scan: values[S, T] float64 -> one segment list per
    series.  ``value_range`` pins every row's (vmin, vmax) and ``n_hint``
    the length that sets the interval L, as a caller scanning part of a
    longer series does; ``None`` derives both from each row."""
    if values.ndim != 2:
        raise ValueError(f"expected [S, T], got shape {tuple(values.shape)}")
    values = values.to(torch.float64)
    s, n = values.shape
    if n == 0 or s == 0:
        return [[] for _ in range(s)]
    if value_range is None:
        delta_global = values.amax(dim=1) - values.amin(dim=1)
    else:
        dg = float(value_range[1]) - float(value_range[0])
        delta_global = torch.full((s,), dg, dtype=torch.float64, device=values.device)
    levels, eps_tab = fluctuation_table(values, delta_global, config, n_hint=n_hint)
    scan = ops.cone_scan(values.T.contiguous(), eps_tab.T.contiguous())
    counts, t0s, thetas, lo, hi = ops.compact_segments(*scan)
    c_max = int(counts.max())
    t0s = t0s[:c_max].long()
    seg_levels = levels.T.gather(0, t0s)
    counts = counts.tolist()
    t0s_h = t0s.T.cpu().tolist()
    th_h = thetas[:c_max].T.cpu().tolist()
    lo_h = lo[:c_max].T.cpu().tolist()
    hi_h = hi[:c_max].T.cpu().tolist()
    lv_h = seg_levels.T.cpu().tolist()
    out: list[list[Segment]] = []
    for a in range(s):
        c = counts[a]
        starts = t0s_h[a][:c]
        ends = starts[1:] + [n]
        out.append(
            [
                Segment(theta=th, level=lv, psi_lo=pl, psi_hi=ph, t0=t0, length=t1 - t0)
                for th, lv, pl, ph, t0, t1 in zip(
                    th_h[a], lv_h[a], lo_h[a], hi_h[a], starts, ends
                )
            ]
        )
    return out


def extract_semantics(
    values: torch.Tensor,
    config: ShrinkConfig,
    value_range: tuple[float, float] | None = None,
    n_hint: int | None = None,
) -> list[Segment]:
    """One series' cone scan: the S = 1 row of :func:`extract_semantics_batch`.
    ``value_range`` defaults to the series' own (min, max), as in the
    reference."""
    values = values.to(torch.float64).reshape(-1)
    if values.numel() == 0:
        return []
    if value_range is None:
        value_range = global_range(values)
    return extract_semantics_batch(values[None], config, value_range, n_hint)[0]
