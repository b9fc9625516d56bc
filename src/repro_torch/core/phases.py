"""Adaptive phase division (Alg. 2), counterpart of ``repro.core.phases``.

For a cone starting at index ``j`` the local fluctuation over the default
interval ``L = lam * n * eps_b`` sets the adaptive base threshold of Eq. 4,
``eps_hat = eps_b * exp(2/3 - level / beta_levels)``, with the level the
quantized ratio of local to global range.  ``fluctuation_table`` computes
(level, eps_hat) for every start position of a batch of series at once,
as torch ops on the series' device.

The eps_hat lookup table is built on the host with ``math.exp`` and copied
to the device: a device ``exp`` may differ by an ulp, which would move
every cone origin ``floor(v / eps_hat) * eps_hat``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .types import ShrinkConfig

__all__ = [
    "default_interval_length",
    "beta_level",
    "eps_hat_for_level",
    "eps_hat_lut",
    "quantize_origin",
    "fluctuation_table",
    "divide",
]


def default_interval_length(n: int, config: ShrinkConfig) -> int:
    """Alg. 2 line 4:  L = lam * n * eps_b  (clamped)."""
    raw = config.lam * n * config.eps_b
    return int(min(max(raw, config.min_interval), config.max_interval))


def beta_level(delta_local: float, delta_global: float, config: ShrinkConfig) -> int:
    """Quantized fluctuation level in [0, beta_levels]."""
    if delta_global <= 0:
        return 0
    beta = min(max(delta_local / delta_global, 0.0), 1.0)
    return int(round(beta * config.beta_levels))


def eps_hat_for_level(level: int, config: ShrinkConfig) -> float:
    """Eq. 4 with quantized beta: eps_b * exp(2/3 - level/beta_levels)."""
    beta = level / config.beta_levels
    return config.eps_b * math.exp(2.0 / 3.0 - beta)


def eps_hat_lut(config: ShrinkConfig, device: torch.device | str) -> torch.Tensor:
    """eps_hat of every level as a float64 tensor, computed on the host."""
    lut = [eps_hat_for_level(lv, config) for lv in range(config.beta_levels + 1)]
    return torch.tensor(lut, dtype=torch.float64, device=device)


def quantize_origin(value: float, eps_hat: float) -> float:
    """Eq. 5: Theta = floor(v / eps_hat) * eps_hat."""
    return math.floor(value / eps_hat) * eps_hat


def _sliding_forward(v: torch.Tensor, w: int, largest: bool) -> torch.Tensor:
    """Per-row forward-window extremum: out[s, t] = max or min of
    v[s, t:t+w] (windows truncated at the row end).  Van Herk / Gil-Werman
    two-pass over blocks of w for wide windows, shifted whole-array ops
    for w <= 32."""
    s, t = v.shape
    pick = torch.maximum if largest else torch.minimum
    scan = torch.cummax if largest else torch.cummin
    if w >= t:
        return scan(v.flip(1), dim=1).values.flip(1)
    if w <= 32:
        out = v.clone()
        for d in range(1, w):
            out[:, : t - d] = pick(out[:, : t - d], v[:, d:])
        return out
    nb = -(-t // w)
    p = nb * w
    vp = v.new_full((s, p), -math.inf if largest else math.inf)
    vp[:, :t] = v
    blocks = vp.view(s, nb, w)
    pre = scan(blocks, dim=2).values.reshape(s, p)
    suf = scan(blocks.flip(2), dim=2).values.flip(2).reshape(s, p)
    end = torch.arange(t, device=v.device) + (w - 1)
    inb = end < p  # windows whose last index falls inside the padded array
    out = suf[:, :t].clone()
    out[:, inb] = pick(out[:, inb], pre[:, end[inb]])
    return out


def fluctuation_table(
    values: torch.Tensor,
    delta_global: torch.Tensor,
    config: ShrinkConfig,
    lengths=None,
    *,
    n_hint: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Vectorized Alg. 2 over a batch of series: the (level, eps_hat) of a
    cone starting at every (series, index).

    values:       [S, T] float64.
    delta_global: [S] per-series global max - min.
    n_hint:       series length that sets L (default T), as the scan of a
                  series whose L was pinned by its caller.
    lengths:      optional [S] valid samples per row (ragged rows padded to
                  T).  Row s gets its own L from ``lengths[s]`` and its
                  windows stop at its end, as if it were scanned alone;
                  entries past the end are 0-level placeholders.

    Returns (levels int64 [S, T], eps_hat float64 [S, T]).
    """
    s, t = values.shape
    if t == 0:
        z = values.new_zeros((s, 0))
        return z.long(), z
    if lengths is None:
        w = max(default_interval_length(t if n_hint is None else int(n_hint), config), 2)
        delta_local = _sliding_forward(values, w, True) - _sliding_forward(values, w, False)
    else:
        if n_hint is not None:
            raise ValueError("pass n_hint or lengths, not both")
        ns = torch.as_tensor(lengths, dtype=torch.int64).reshape(-1).tolist()
        ln = torch.tensor(ns, dtype=torch.int64, device=values.device)
        pad = torch.arange(t, device=values.device)[None, :] >= ln[:, None]
        # -inf never raises a max and +inf never lowers a min: the windows
        # stop at each row's end
        vmax_in = values.masked_fill(pad, -math.inf)
        vmin_in = values.masked_fill(pad, math.inf)
        delta_local = torch.empty_like(values)
        ws = [max(default_interval_length(n, config), 2) for n in ns]
        for w in sorted(set(ws)):
            rows = torch.tensor([i for i, wi in enumerate(ws) if wi == w], device=values.device)
            delta_local[rows] = _sliding_forward(vmax_in[rows], w, True) - _sliding_forward(
                vmin_in[rows], w, False
            )
    delta_local[:, -1] = 0.0  # size-1 window
    if lengths is not None:
        live = [i for i, n in enumerate(ns) if n > 0]
        if live:
            delta_local[live, [ns[i] - 1 for i in live]] = 0.0
        delta_local[pad] = 0.0
    dg = delta_global.to(torch.float64).reshape(s, 1)
    beta = torch.where(dg > 0, delta_local / dg, torch.zeros_like(delta_local))
    levels = torch.round(beta.clamp(0.0, 1.0) * config.beta_levels).long()
    return levels, eps_hat_lut(config, values.device)[levels]


def divide(
    values: np.ndarray,
    j: int,
    L: int,
    delta_global: float,
    config: ShrinkConfig,
) -> tuple[float, int, float]:
    """Alg. 2 (DIVISION) for one cone at ``j`` on the host: (theta, level,
    eps_hat).  The streaming codec's incremental scan calls it once per
    cone on its numpy sample buffer.

    values:       the series so far (float64 [n]).
    L:            default interval length (pinned once per stream).
    delta_global: global max - min of the series.
    """
    window = values[j : j + max(L, 2)]
    if window.size >= 2:
        delta_local = float(window.max() - window.min())
    else:
        delta_local = 0.0
    level = beta_level(delta_local, delta_global, config)
    eps_hat = eps_hat_for_level(level, config)
    theta = quantize_origin(float(values[j]), eps_hat)
    return theta, level, eps_hat
