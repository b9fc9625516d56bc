"""Per-block least-squares line of the tensor codec: CUDA kernel, plain
version, wrapper.

Counterpart of ``repro.core.jaxshrink.linear_base_fit``, a float32
matrix-vector product and mean that XLA compiles (there is no Pallas
kernel).  For xb[M, K] float32, with tc = t - (K - 1) / 2:

    slope = (xb @ tc) / sum(tc * tc);  theta = mean(xb) - slope * (K - 1) / 2

The sums run in the order XLA's CPU code gives them (see
:func:`_row_dot` and :func:`_row_sum`), so the plain version is
bit-identical to the reference on the CPU for blocks of up to 876
elements (wider rows the reference's CPU product sums in another order).
The kernel is ``csrc/base_fit.cu``, the same order in one thread per row;
``base_fit_plain`` is elementwise torch ops with an exact fused
multiply-add, so the two agree bit for bit.  The kernel takes blocks of
up to 1024 elements.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["base_fit", "base_fit_cuda", "base_fit_plain", "MAX_BLOCK"]

MAX_BLOCK = 1024  # the kernel's widest row: at most 32 windows of 32

# rows per pass of the plain version: few passes (each launches a few
# hundred small ops) and bounded [rows, 8] float64 temporaries; a multiple
# of 8, so the tiles of 8 rows never straddle two passes
_ROWS = 1 << 19


def _fma32(acc: torch.Tensor, prod: torch.Tensor) -> torch.Tensor:
    """float32 ``acc + prod`` rounded once, as an FMA rounds: ``prod`` is an
    exact float64 product of two float32 values.  The float64 sum is made
    round-to-odd (one ulp toward the exact sum when it was inexact and
    landed on an even mantissa), after which rounding to float32 is exact
    rounding of the true sum."""
    a = acc.double()
    s = a + prod
    bb = s - a
    err = (a - (s - bb)) + (prod - bb)
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    s = torch.where(fix, torch.nextafter(s, s + err), s)
    return s.float()


def _pair_sums(acc: torch.Tensor, adjacent: bool) -> torch.Tensor:
    """Float32 horizontal sum of [M, 8] lanes: adjacent pairs first
    ((a0+a1)+(a2+a3))+((a4+a5)+(a6+a7)), or halves first
    ((a0+a4)+(a2+a6))+((a1+a5)+(a3+a7))."""
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, 0::2] + acc[:, 1::2] if adjacent else acc[:, :h] + acc[:, h:]
    return acc[:, 0]


def _row_dot(xb: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``xb[M, K] @ v[K]`` in float32, summed in XLA's CPU order for a
    matrix-vector product: 8 lanes of fused multiply-adds over the
    columns, then a horizontal sum of adjacent pairs for rows in whole
    tiles of 8 and of halves for the last M % 8 rows; the K % 8 tail
    columns accumulate separately and are added last."""
    m, k = xb.shape
    k8 = k - k % 8
    acc = xb.new_zeros((m, 8))
    for c in range(0, k8, 8):
        acc = _fma32(acc, xb[:, c : c + 8].double() * v[c : c + 8].double())
    full = m - m % 8
    out = torch.cat([_pair_sums(acc[:full], True), _pair_sums(acc[full:], False)])
    if k8 < k:
        tail = xb.new_zeros(m)
        for c in range(k8, k):
            tail = _fma32(tail, xb[:, c].double() * float(v[c]))
        out = out + tail
    return out


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of x[M, K] in float32, in XLA's CPU order for a reduction:
    rows longer than 32 are cut into windows of 32 (zero-padded evenly at
    both ends), each window summed in sequence, and the window sums
    reduced the same way."""
    m, k = x.shape
    if k <= 32:
        acc = x.new_zeros(m)
        for c in range(k):
            acc = acc + x[:, c]
        return acc
    nwin = -(-k // 32)
    pad = nwin * 32 - k
    if pad:
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    xp = x.view(m, nwin, 32)
    acc = x.new_zeros((m, nwin))
    for c in range(32):
        acc = acc + xp[:, :, c]
    return _row_sum(acc)


def _constants(k: int) -> tuple[float, float, float]:
    """(denom, 1 / K, (K - 1) / 2) as float32 values: denom = sum(tc * tc)
    summed on the CPU, whatever the device of the rows."""
    tc = torch.arange(k, dtype=torch.float32) - (k - 1) / 2.0
    denom = float(torch.sum(tc * tc))
    inv_k = float(torch.tensor(1.0 / k, dtype=torch.float32))
    return denom, inv_k, (k - 1) / 2.0


def base_fit_plain(xb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    m, k = xb.shape
    denom, inv_k, t_mean = _constants(k)
    tc = torch.arange(k, dtype=xb.dtype, device=xb.device) - t_mean
    denom_t = torch.tensor(denom, dtype=xb.dtype, device=xb.device)
    inv_k_t = torch.tensor(inv_k, dtype=xb.dtype, device=xb.device)
    theta = torch.empty(m, dtype=xb.dtype, device=xb.device)
    slope = torch.empty_like(theta)
    for a in range(0, m, _ROWS):
        rows = xb[a : a + _ROWS]
        slope[a : a + _ROWS] = torch.div(_row_dot(rows, tc), denom_t)
        mean = _row_sum(rows) * inv_k_t
        theta[a : a + _ROWS] = mean - slope[a : a + _ROWS] * t_mean
    return theta, slope


_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int] + [ctypes.c_float] * 3 + [
    ctypes.c_void_p
] * 3


def base_fit_cuda(xb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/base_fit.cu``; same contract as :func:`base_fit_plain`."""
    if xb.ndim != 2 or xb.dtype != torch.float32:
        raise TypeError(f"base_fit takes float32 xb[M, K], got {xb.dtype} {tuple(xb.shape)}")
    m, k = xb.shape
    if not 1 <= k <= MAX_BLOCK:
        raise ValueError(f"base_fit: the kernel takes blocks of 1..{MAX_BLOCK} elements, got {k}")
    xb = xb.contiguous()
    theta = torch.empty(m, dtype=torch.float32, device=xb.device)
    slope = torch.empty_like(theta)
    if m == 0:
        return theta, slope
    denom, inv_k, t_mean = _constants(k)
    fn = _build.function("base_fit", "base_fit", _ARGS)
    with torch.cuda.device(xb.device):
        rc = fn(
            xb.data_ptr(), m, k, denom, inv_k, t_mean, theta.data_ptr(), slope.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "base_fit")
    _build.launches["base_fit"] += 1
    return theta, slope


def base_fit(xb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The wrapper: the kernel for a CUDA tensor, the plain version for a
    CPU tensor.  Returns (theta[M], slope[M]) float32."""
    if xb.is_cuda:
        return base_fit_cuda(xb)
    if xb.device.type != "cpu":
        raise ValueError(f"base_fit runs on cuda or cpu, got {xb.device}")
    return base_fit_plain(xb)
