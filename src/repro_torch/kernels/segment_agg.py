"""Closed-form per-segment aggregates of the analytics path: CUDA kernel,
plain version, wrapper.

Counterpart of ``repro.kernels.segment_agg`` (the Pallas TPU kernel
``segment_agg_kernel`` / ``segment_agg_pallas``, oracle
``repro.kernels.ref.segment_agg_ref``).  For M segment rows, each the line
``theta + slope * i`` over the local window ``i in [a, b)`` (theta, slope,
a, b [M, 1] of one float dtype), returns (sum, sumsq, min, max), each
[M, 1]; rows with ``b <= a`` give the identity (0, 0, +3.4e38, -3.4e38).

The dtype picks the expressions:

* float64 (the analytics path, ``core.segment_algebra``): the per-row
  terms of the reference's ``core.segment_algebra.base_aggregate``,
  ``d1 = S1(b) - S1(a)`` and ``d2 = S2(b) - S2(a)`` with
  ``S1(x) = x(x-1)/2`` and ``S2(x) = x(x-1)(2x-1)/6``, bit for bit.  The
  Pallas body's difference of cubes agrees only while ``2 b^3 < 2^53``
  (windows under ~165,000 samples).
* float32: the Pallas body, held to ``segment_agg_ref`` at 1e-5.

The kernel is ``csrc/segment_agg.cu``; ``segment_agg_plain`` is the same
arithmetic as separate torch ops (divisions by a tensor, so CUDA torch
makes no reciprocal multiply of them), so the two agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["segment_agg", "segment_agg_cuda", "segment_agg_plain"]

_BIG = 3.4e38  # the aggregate identity's +-inf stand-in, as the Pallas kernel's
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as an IEEE division by a tensor on any device (CUDA torch turns
    ``x / d`` into a reciprocal multiply); the port's exact paths use it."""
    return torch.div(x, torch.tensor(d, dtype=x.dtype, device=x.device))


def _s1(x):
    return _div(x * (x - 1.0), 2.0)


def _s2(x):
    return _div(x * (x - 1.0) * (2.0 * x - 1.0), 6.0)


def segment_agg_plain(theta, slope, a, b):
    if theta.dtype == torch.float64:
        w = b - a
        d1 = _s1(b) - _s1(a)
        d2 = _s2(b) - _s2(a)
    else:
        w = torch.clamp(b - a, min=0.0)
        d1 = (b * (b - 1.0) - a * (a - 1.0)) * 0.5
        d2 = _div(b * (b - 1.0) * (2.0 * b - 1.0) - a * (a - 1.0) * (2.0 * a - 1.0), 6.0)
    live = w > 0.0
    total = w * theta + slope * d1
    sumsq = w * theta * theta + 2.0 * theta * slope * d1 + slope * slope * d2
    va = theta + slope * a
    vb = theta + slope * (b - 1.0)
    # on a tie (-0.0 against 0.0) the second operand, as numpy's minimum
    # and maximum give it; torch.minimum would keep -0.0
    vmin = torch.where(va < vb, va, vb)
    vmax = torch.where(va > vb, va, vb)
    return (
        torch.where(live, total, 0.0),
        torch.where(live, sumsq, 0.0),
        torch.where(live, vmin, _BIG),
        torch.where(live, vmax, -_BIG),
    )


_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]


def segment_agg_cuda(theta, slope, a, b):
    """Launch ``csrc/segment_agg.cu``; same contract as
    :func:`segment_agg_plain`."""
    dtype = theta.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"segment_agg takes float64 or float32 rows, got {dtype}")
    m = theta.numel()
    for name, p in (("theta", theta), ("slope", slope), ("a", a), ("b", b)):
        if p.dtype != dtype or p.numel() != m or p.device != theta.device:
            raise ValueError(f"segment_agg: {name} must be {dtype} [M, 1] on {theta.device}")
    out = torch.empty((4, m), dtype=dtype, device=theta.device)
    if m:
        # the packed rows (theta, slope, a, b): one 16-byte-aligned load of a
        # row's four scalars per thread (two for float64)
        rows = torch.stack([p.reshape(m) for p in (theta, slope, a, b)], dim=1)
        if rows.data_ptr() % 16:
            raise ValueError("segment_agg: packed rows are not 16-byte aligned")
        fn = _build.function("segment_agg", f"segment_agg_{_SUFFIX[dtype]}", _ARGS)
        with torch.cuda.device(theta.device):
            rc = fn(rows.data_ptr(), m, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "segment_agg")
        _build.launches["segment_agg"] += 1
    return tuple(out[k].reshape(m, 1) for k in range(4))


def segment_agg(theta, slope, a, b):
    """The wrapper: the kernel for a CUDA tensor, the plain version for a
    CPU tensor.  Returns (sum, sumsq, min, max), each [M, 1]."""
    if theta.is_cuda:
        return segment_agg_cuda(theta, slope, a, b)
    if theta.device.type != "cpu":
        raise ValueError(f"segment_agg runs on cuda or cpu, got {theta.device}")
    return segment_agg_plain(theta, slope, a, b)
