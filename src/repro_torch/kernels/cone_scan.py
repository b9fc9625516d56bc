"""The shrinking-cone scan (Alg. 3): CUDA kernel, plain version, wrapper.

Counterpart of ``repro.kernels.cone_scan`` (the Pallas TPU kernel
``_cone_scan_kernel`` / ``cone_scan_pallas``).  The kernel is
``csrc/cone_scan.cu``: one warp a series, which walks windows of
:data:`WINDOW` steps and scans up to a window in one parallel pass
(candidate slopes, prefix min and max, the first break), starting the
next pass at each break (see the source's note for why that gives the
loop's bits and what bounds it on the card).  ``cone_scan_plain`` is the recurrence as torch ops, one
[S]-vector step per time index.

Both take time-major x[T, S] and eps_hat[T, S] (the adaptive threshold of a
cone that would start at (t, s)) and return

* brk[T, S] int32: 1 where a segment starts (brk[0] == 1);
* theta[T, S]: the running cone origin (the new one at a break);
* psi_lo/psi_hi[T, S]: the span of the segment that closed at t - 1
  (meaningful where brk == 1 and t > 0);
* fin_lo/fin_hi[S]: the span of the segment still open at the lane end.

Spans start unbounded at -inf/+inf.  ``lengths`` [S] marks each lane's
valid samples: positions t >= lengths[s] never constrain or break a cone.
The candidate slopes are grouped as the host scan groups them,
(v + (eps - theta)) / dt; the TPU kernel's ((v + eps) - theta) / dt can
differ from it in the last bit of a span.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["cone_scan", "cone_scan_cuda", "cone_scan_plain"]

WINDOW = 256  # steps the kernel scans at once (C in csrc/cone_scan.cu)


def cone_scan_plain(
    x: torch.Tensor,
    eps_hat: torch.Tensor,
    lengths: torch.Tensor | None = None,
):
    t_len, s = x.shape
    dtype, dev = x.dtype, x.device
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    ln = (
        torch.full((s,), t_len, dtype=torch.int32, device=dev)
        if lengths is None
        else lengths.to(device=dev, dtype=torch.int32)
    )
    brk = torch.zeros((t_len, s), dtype=torch.int32, device=dev)
    theta_out = torch.empty_like(x)
    lo_out = torch.empty_like(x)
    hi_out = torch.empty_like(x)
    eps_seg = eps_hat[0].clone()
    theta = torch.floor(x[0] / eps_seg) * eps_seg
    lo = -inf.expand(s).clone()
    hi = inf.expand(s).clone()
    t0 = torch.zeros(s, dtype=torch.int64, device=dev)
    brk[0] = 1
    theta_out[0] = theta
    lo_out[0] = lo
    hi_out[0] = hi
    for t in range(1, t_len):
        v = x[t]
        e_t = eps_hat[t]
        dt = (t - t0).to(dtype)
        cand_hi = (v + (eps_seg - theta)) / dt
        cand_lo = (v - (eps_seg + theta)) / dt
        grow = ln > t
        new_hi = torch.where(grow & (cand_hi < hi), cand_hi, hi)
        new_lo = torch.where(grow & (cand_lo > lo), cand_lo, lo)
        b = grow & (new_lo > new_hi)
        lo_out[t] = lo
        hi_out[t] = hi
        theta = torch.where(b, torch.floor(v / e_t) * e_t, theta)
        eps_seg = torch.where(b, e_t, eps_seg)
        lo = torch.where(b, -inf, new_lo)
        hi = torch.where(b, inf, new_hi)
        t0 = torch.where(b, t, t0)
        brk[t] = b.to(torch.int32)
        theta_out[t] = theta
    return brk, theta_out, lo_out, hi_out, lo, hi


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7


def cone_scan_cuda(
    x: torch.Tensor,
    eps_hat: torch.Tensor,
    lengths: torch.Tensor | None = None,
):
    """Launch ``csrc/cone_scan.cu`` on x's card (float32 or float64)."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cone_scan takes float32 or float64, got {x.dtype}")
    if eps_hat.dtype != x.dtype or eps_hat.shape != x.shape or eps_hat.device != x.device:
        raise ValueError("eps_hat must match x in dtype, shape and device")
    t_len, s = x.shape
    x = x.contiguous()
    eps_hat = eps_hat.contiguous()
    if lengths is not None:
        lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
        if lengths.shape != (s,):
            raise ValueError(f"lengths must be [S]={s}, got {tuple(lengths.shape)}")
    brk = torch.empty((t_len, s), dtype=torch.int32, device=x.device)
    theta = torch.empty_like(x)
    lo = torch.empty_like(x)
    hi = torch.empty_like(x)
    fin_lo = torch.empty(s, dtype=x.dtype, device=x.device)
    fin_hi = torch.empty(s, dtype=x.dtype, device=x.device)
    fn = _build.function(
        "cone_scan", "cone_scan_f64" if x.dtype == torch.float64 else "cone_scan_f32",
        _ARGTYPES,
    )
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            x.data_ptr(), eps_hat.data_ptr(),
            None if lengths is None else lengths.data_ptr(),
            t_len, s,
            brk.data_ptr(), theta.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            fin_lo.data_ptr(), fin_hi.data_ptr(), stream,
        )
    _build.check(err, "cone_scan")
    _build.launches["cone_scan"] += 1
    return brk, theta, lo, hi, fin_lo, fin_hi


def cone_scan(
    x: torch.Tensor,
    eps_hat: torch.Tensor,
    lengths: torch.Tensor | None = None,
):
    """The wrapper: the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if x.is_cuda:
        return cone_scan_cuda(x, eps_hat, lengths)
    if x.device.type != "cpu":
        raise ValueError(f"cone_scan runs on cuda or cpu, got {x.device}")
    return cone_scan_plain(x, eps_hat, lengths)
