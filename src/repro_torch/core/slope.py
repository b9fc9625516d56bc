"""Candidate line selection (Alg. 5), a copy of ``repro.core.slope``.

The slope of a merged sub-base is the shortest-decimal number inside its
span [psi_lo, psi_hi]: the smallest digit count d with
ceil(lo * 10^d) <= floor(hi * 10^d), taking the grid value nearest the
midpoint.  Spans with an infinite end get slope 0 (or the finite end when
0 lies outside the span).  Runs on the host, once per sub-base.
"""
from __future__ import annotations

import math

__all__ = ["optimized_slope", "shortest_decimal_in_interval"]

_MAX_DIGITS = 12


def shortest_decimal_in_interval(lo: float, hi: float) -> tuple[float, int]:
    """(value, digits): the decimal with fewest fraction digits in
    [lo, hi], nearest the midpoint at that digit count."""
    if lo > hi:
        lo, hi = hi, lo
    mid = 0.5 * (lo + hi)
    for d in range(0, _MAX_DIGITS + 1):
        scale = 10.0**d
        qlo = math.ceil(lo * scale - 1e-12)
        qhi = math.floor(hi * scale + 1e-12)
        if qlo <= qhi:
            q = round(mid * scale)
            q = min(max(q, qlo), qhi)
            val = q / scale
            if val < lo:
                val = qlo / scale if qlo <= qhi else lo
            if val > hi:
                val = qhi / scale
            if lo <= val <= hi:
                return float(val), d
    return float(mid), _MAX_DIGITS + 1


def optimized_slope(psi_lo: float, psi_hi: float) -> tuple[float, int]:
    """Alg. 5 with the degenerate spans handled: (slope, digits)."""
    lo_inf = math.isinf(psi_lo)
    hi_inf = math.isinf(psi_hi)
    if lo_inf and hi_inf:
        return 0.0, 0
    if lo_inf:
        return (float(psi_hi), _MAX_DIGITS + 1) if psi_hi < 0 else (0.0, 0)
    if hi_inf:
        return (float(psi_lo), _MAX_DIGITS + 1) if psi_lo > 0 else (0.0, 0)
    if psi_lo == psi_hi:
        return float(psi_lo), _MAX_DIGITS + 1
    return shortest_decimal_in_interval(psi_lo, psi_hi)
