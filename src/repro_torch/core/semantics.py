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

import math

import numpy as np
import torch

from ..kernels import ops
from .phases import fluctuation_table
from .types import Segment, ShrinkConfig

__all__ = ["extract_semantics", "extract_semantics_batch", "global_range", "row_ranges"]


def global_range(values: torch.Tensor) -> tuple[float, float]:
    """(min, max) of one series (or of all of ``values``)."""
    if values.numel() == 0:  # empty series compress to an empty base
        return 0.0, 0.0
    vmin, vmax = float(values.min()), float(values.max())
    if vmin == 0.0 or vmax == 0.0:
        # a zero extreme's sign (+0.0 or -0.0, stored in the base) depends
        # on the reduction order: take numpy's, as the reference does
        host = values.cpu().numpy()
        vmin, vmax = float(host.min()), float(host.max())
    return vmin, vmax


def row_ranges(values: torch.Tensor, valid: torch.Tensor | None = None):
    """Per-row (min, max) lists of non-empty rows values[S, T], over the
    entries where ``valid`` [S, T] holds (all by default).  As in
    :func:`global_range`, a zero extreme takes numpy's sign: only the rows
    that have one are copied to the host."""
    if valid is None:
        vmin, vmax = values.amin(dim=1), values.amax(dim=1)
    else:
        vmin = values.masked_fill(~valid, math.inf).amin(dim=1)
        vmax = values.masked_fill(~valid, -math.inf).amax(dim=1)
    rows = torch.nonzero((vmin == 0) | (vmax == 0)).reshape(-1)
    vmin, vmax = vmin.tolist(), vmax.tolist()
    if rows.numel():
        host = values[rows].cpu().numpy()
        lo = hi = host
        if valid is not None:
            ok = valid[rows].cpu().numpy()
            lo, hi = np.where(ok, host, np.inf), np.where(ok, host, -np.inf)
        for r, a, b in zip(rows.tolist(), lo.min(axis=1).tolist(), hi.max(axis=1).tolist()):
            vmin[r], vmax[r] = a, b
    return vmin, vmax


def extract_semantics_batch(
    values: torch.Tensor,
    config: ShrinkConfig,
    value_range: tuple[float, float] | None = None,
    n_hint: int | None = None,
    lengths=None,
) -> list[list[Segment]]:
    """Multi-series cone scan: values[S, T] float64 -> one segment list per
    series.  ``value_range`` pins every row's (vmin, vmax) and ``n_hint``
    the length that sets the interval L, as a caller scanning part of a
    longer series does; ``None`` derives both from each row.

    ``lengths`` [S] makes the rows ragged: row s holds ``lengths[s]`` real
    samples padded to T.  Each row then gets its own range and L from its
    valid samples, the scan kernel's valid-length mask keeps the padding
    from constraining, breaking or seeding a cone, and the last segment
    ends at the row's own end, so each row equals the scan of its unpadded
    slice."""
    if values.ndim != 2:
        raise ValueError(f"expected [S, T], got shape {tuple(values.shape)}")
    values = values.to(torch.float64)
    s, n = values.shape
    if n == 0 or s == 0:
        return [[] for _ in range(s)]
    dev = values.device
    if lengths is None:
        ends = [n] * s
        ln = None
        if value_range is None:
            delta_global = values.amax(dim=1) - values.amin(dim=1)
        else:
            dg = float(value_range[1]) - float(value_range[0])
            delta_global = torch.full((s,), dg, dtype=torch.float64, device=dev)
    else:
        if value_range is not None or n_hint is not None:
            raise ValueError("ragged rows take their range and L from their own samples")
        ends = torch.as_tensor(lengths, dtype=torch.int64).reshape(-1).tolist()
        if len(ends) != s:
            raise ValueError(f"lengths must be [S]={s}, got {len(ends)}")
        if min(ends) < 0 or max(ends) > n:
            raise ValueError(f"lengths must lie in [0, T={n}]")
        ln = torch.tensor(ends, dtype=torch.int64, device=dev)
        pad = torch.arange(n, device=dev)[None, :] >= ln[:, None]
        delta_global = torch.where(
            ln > 0,
            values.masked_fill(pad, -math.inf).amax(dim=1)
            - values.masked_fill(pad, math.inf).amin(dim=1),
            0.0,
        )
    levels, eps_tab = fluctuation_table(values, delta_global, config, n_hint=n_hint, lengths=ln)
    scan = ops.cone_scan(values.T.contiguous(), eps_tab.T.contiguous(), ln)
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
        c = counts[a] if ends[a] else 0  # an empty row has no segments
        starts = t0s_h[a][:c]
        stops = starts[1:] + [ends[a]]
        out.append(
            [
                Segment(theta=th, level=lv, psi_lo=pl, psi_hi=ph, t0=t0, length=t1 - t0)
                for th, lv, pl, ph, t0, t1 in zip(
                    th_h[a], lv_h[a], lo_h[a], hi_h[a], starts, stops
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
