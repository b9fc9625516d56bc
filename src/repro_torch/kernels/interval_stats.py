"""Per-window min and max of many series: CUDA kernel, plain version,
wrapper.

Counterpart of ``repro.kernels.interval_stats`` (the Pallas TPU kernel
``interval_stats_kernel`` / ``interval_stats_pallas``).  For x[T, S]
time-major (S series side by side) and a window W with T % W == 0:

    mins[w, s], maxs[w, s] = min, max of x[w*W : (w+1)*W, s]    ([T/W, S] each)

in x's dtype (float32, bfloat16 or float64).  The semantics are the
reference's, as the CPU tests pin them against the JAX function: a window
that holds a NaN gives a NaN (its first, with its own bits; a bfloat16
NaN as the quiet NaN 0x7fc0 with its sign), and -0.0 counts below +0.0,
so a window holding both zeros has min -0.0 and max +0.0 in either order.
Every other output is an input element, bits and all.

The kernel is ``csrc/interval_stats.cu``.  ``interval_stats_plain`` is one
``reshape(T // W, W, S)`` and its ``amin`` / ``amax``, then the two rules
torch's reductions leave open: which zero (torch keeps whichever it meets
first) and which NaN bits, both selected on the integer bits.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["interval_stats", "interval_stats_cuda", "interval_stats_plain"]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
_INT = {torch.float32: torch.int32, torch.float64: torch.int64, torch.bfloat16: torch.int16}


def _windows(x: torch.Tensor, window: int) -> int:
    """The number of windows; raises for what neither route takes."""
    if x.dtype not in _SUFFIX:
        raise TypeError(f"interval_stats takes float32, bfloat16 or float64 x, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"interval_stats takes x[T, S], got shape {tuple(x.shape)}")
    if window < 1 or x.shape[0] % window:
        raise ValueError(f"interval_stats: T={x.shape[0]} is not a multiple of window={window}")
    return x.shape[0] // window


def interval_stats_plain(x: torch.Tensor, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    nw = _windows(x, window)
    xr = x.reshape(nw, window, x.shape[1])
    ints = _INT[x.dtype]  # selections on the bits: torch's bfloat16 gather rewrites NaNs
    mins, maxs = xr.amin(dim=1), xr.amax(dim=1)
    zero = xr == 0
    neg = torch.signbit(xr)
    neg_zero = torch.tensor(-0.0, dtype=x.dtype).view(ints).item()
    mins = torch.where((mins == 0) & (zero & neg).any(dim=1), neg_zero, mins.view(ints))
    maxs = torch.where((maxs == 0) & (zero & ~neg).any(dim=1), 0, maxs.view(ints))
    # a NaN window gives its first NaN (argmax takes the first maximum)
    nan = torch.isnan(xr)
    first = xr.view(ints).gather(1, nan.to(torch.uint8).argmax(dim=1, keepdim=True)).squeeze(1)
    if x.dtype == torch.bfloat16:  # the quiet NaN with the element's sign
        first = (first & -0x8000) | 0x7FC0
    has_nan = nan.any(dim=1)
    return (torch.where(has_nan, first, mins).view(x.dtype),
            torch.where(has_nan, first, maxs).view(x.dtype))


_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int] + [ctypes.c_void_p] * 3


def interval_stats_cuda(x: torch.Tensor, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/interval_stats.cu``; same contract as
    :func:`interval_stats_plain`."""
    nw = _windows(x, window)
    if window > 2**31 - 1:
        raise ValueError(f"interval_stats: window {window} does not fit the kernel's int")
    s = x.shape[1]
    x = x.contiguous()
    mins = torch.empty((nw, s), dtype=x.dtype, device=x.device)
    maxs = torch.empty_like(mins)
    if nw == 0 or s == 0:
        return mins, maxs
    fn = _build.function("interval_stats", f"interval_stats_{_SUFFIX[x.dtype]}", _ARGS)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), nw, s, window, mins.data_ptr(), maxs.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "interval_stats")
    _build.launches["interval_stats"] += 1
    return mins, maxs


def interval_stats(x: torch.Tensor, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The wrapper: the kernel for a CUDA tensor, the plain version for a
    CPU tensor.  Returns (mins, maxs) [T // window, S] in x's dtype."""
    if x.is_cuda:
        return interval_stats_cuda(x, window)
    if x.device.type != "cpu":
        raise ValueError(f"interval_stats runs on cuda or cpu, got {x.device}")
    return interval_stats_plain(x, window)
