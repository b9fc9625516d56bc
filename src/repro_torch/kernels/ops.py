"""Public entry points of the port's kernels (counterpart of
``repro.kernels.ops``).

Every wrapper here launches its hand-written CUDA kernel when given CUDA
tensors and runs the kernel's plain torch version when given CPU tensors;
nothing else chooses between them.  ``launches`` counts kernel launches
by name and ``reset_launches`` zeroes the counts.  The names and argument
orders are the reference's, without its ``force_ref`` switch (the
tensor's device picks the route): ``interval_stats(x, window)``,
``pyramid_quant(x, theta, slope, steps, qmax=127, lengths=None)``,
``pyramid_reconstruct(qs, theta, slope, steps)`` and the rest.

The cone scan needs no block padding: the kernel loops over all T steps
inside each thread, where the TPU kernel needed T to be a multiple of its
time block.  ``compact_segments`` turns its dense per-point outputs into
per-series segment records with torch ops, as ``_compact_segments`` did in
XLA.
"""
from __future__ import annotations

import torch

from ._build import launches, reset_launches
from .base_fit import base_fit
from .cone_scan import cone_scan
from .dequant import dequant, pyramid_reconstruct
from .flash_attention import flash_attention
from .interval_stats import interval_stats
from .rans import ID_SYM as RANS_ID_SYM
from .rans import decode_rows as rans_decode_rows
from .rans import encode_rows as rans_encode_rows
from .residual_quant import pyramid_quant, residual_quant
from .segment_agg import segment_agg

__all__ = [
    "base_fit",
    "compact_segments",
    "cone_scan",
    "cone_scan_segments",
    "dequant",
    "dequant_reconstruct",
    "flash_attention",
    "interval_stats",
    "launches",
    "pyramid_quant",
    "pyramid_reconstruct",
    "RANS_ID_SYM",
    "rans_decode_rows",
    "rans_encode_rows",
    "reset_launches",
    "residual_quant",
    "segment_agg",
]


def compact_segments(brk, theta, psi_lo, psi_hi, fin_lo, fin_hi):
    """Dense scan outputs [T, S] -> per-series segment records.

    Returns (counts[S], t0s[T, S], thetas[T, S], lo[T, S], hi[T, S]): row k
    of each [T, S] output is segment k of that series (rows >= counts[s] are
    zero padding).  A break at t starts segment cumsum(brk)[t] - 1 and
    carries the span of the one before it; the still-open segment's span is
    the final carry.
    """
    t_len, s = brk.shape
    dev = brk.device
    seg = torch.cumsum(brk, dim=0, dtype=torch.int64) - 1
    is_brk = brk.bool()
    cols = torch.arange(s, device=dev).expand(t_len, s)
    tpos = torch.arange(t_len, dtype=torch.int32, device=dev)[:, None].expand(t_len, s)
    # non-break positions scatter into a dump row at index T
    rows = torch.where(is_brk, seg, t_len)
    t0s = torch.zeros((t_len + 1, s), dtype=torch.int32, device=dev)
    t0s.index_put_((rows, cols), tpos)
    thetas = torch.zeros((t_len + 1, s), dtype=theta.dtype, device=dev)
    thetas.index_put_((rows, cols), theta)
    close = torch.where(is_brk & (seg > 0), seg - 1, t_len)
    lo = torch.zeros((t_len + 1, s), dtype=psi_lo.dtype, device=dev)
    lo.index_put_((close, cols), psi_lo)
    hi = torch.zeros((t_len + 1, s), dtype=psi_hi.dtype, device=dev)
    hi.index_put_((close, cols), psi_hi)
    counts = brk.sum(dim=0, dtype=torch.int64)
    lanes = torch.arange(s, device=dev)
    lo[counts - 1, lanes] = fin_lo.reshape(s)
    hi[counts - 1, lanes] = fin_hi.reshape(s)
    return counts, t0s[:t_len], thetas[:t_len], lo[:t_len], hi[:t_len]


def cone_scan_segments(x, eps_hat, lengths=None):
    """The cone scan followed by :func:`compact_segments`: x[T, S],
    eps_hat[T, S] -> (counts[S], t0s, thetas, psi_lo, psi_hi [T, S]).
    Unbounded spans stay +-inf (the Pallas route used +-3.4e38)."""
    return compact_segments(*cone_scan(x, eps_hat, lengths))


def dequant_reconstruct(q, theta, slope, step):
    """The reference's name for :func:`dequant`."""
    return dequant(q, theta, slope, step)
