"""Fused residual quantization of the tensor codec, and its multi-layer
ladder: CUDA kernels, plain versions, wrappers.

Counterpart of ``repro.kernels.residual_quant`` (the Pallas TPU kernel
``residual_quant_kernel`` / ``residual_quant_pallas``).  For x[M, N]
float32 and per-row theta, slope, step [M, 1] float32:

    pred = theta + slope * t;  r = x - pred
    q    = clip(round(r * (1 / step)), -qmax, qmax);  err = r - q * step

with ragged rows masked (``lengths`` [M]: positions t >= lengths[m] give
q = 0 and err = 0).  The kernel is ``csrc/residual_quant.cu``;
``residual_quant_plain`` is the same arithmetic as separate torch ops (no
op of it fuses a multiply into an add), so the two agree bit for bit.
``q`` comes out in ``out_dtype`` (int8, int16 or int32).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "pyramid_quant", "pyramid_quant_cuda", "pyramid_quant_plain",
    "residual_quant", "residual_quant_cuda", "residual_quant_plain",
]

_SUFFIX = {torch.int8: "i8", torch.int16: "i16", torch.int32: "i32"}


def _reciprocal(step: torch.Tensor) -> torch.Tensor:
    """1 / step as an IEEE division of two tensors on any device."""
    return torch.div(torch.ones_like(step), step)


def residual_quant_plain(x, theta, slope, step, qmax: int = 127, lengths=None,
                         out_dtype=torch.int32):
    m, n = x.shape
    t = torch.arange(n, dtype=x.dtype, device=x.device)[None, :]
    r = x - (theta + slope * t)
    q = torch.clamp(torch.round(r * _reciprocal(step)), -qmax, qmax)
    err = r - q * step
    if lengths is not None:
        pad = t >= lengths.to(device=x.device).reshape(m, 1)
        q = q.masked_fill(pad, 0.0)
        err = err.masked_fill(pad, 0.0)
    return q.to(torch.int32).to(out_dtype), err


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3


def residual_quant_cuda(x, theta, slope, step, qmax: int = 127, lengths=None,
                        out_dtype=torch.int32):
    """Launch ``csrc/residual_quant.cu``; same contract as
    :func:`residual_quant_plain`."""
    if x.ndim != 2 or x.dtype != torch.float32:
        raise TypeError(f"residual_quant takes float32 x[M, N], got {x.dtype} {tuple(x.shape)}")
    m, n = x.shape
    for name, p in (("theta", theta), ("slope", slope), ("step", step)):
        if p.dtype != torch.float32 or p.numel() != m or p.device != x.device:
            raise ValueError(f"residual_quant: {name} must be float32 [M, 1] on {x.device}")
    if out_dtype not in _SUFFIX or qmax > torch.iinfo(out_dtype).max or qmax < 0:
        raise ValueError(f"residual_quant: q of {out_dtype} cannot hold qmax={qmax}")
    x = x.contiguous()
    theta, slope, step = (p.reshape(m).contiguous() for p in (theta, slope, step))
    if lengths is not None:
        lengths = lengths.to(device=x.device, dtype=torch.int32).reshape(m).contiguous()
    q = torch.empty((m, n), dtype=out_dtype, device=x.device)
    err = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return q, err
    fn = _build.function("residual_quant", f"residual_quant_{_SUFFIX[out_dtype]}", _ARGS)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), theta.data_ptr(), slope.data_ptr(), step.data_ptr(),
            None if lengths is None else lengths.data_ptr(), m, n, qmax,
            q.data_ptr(), err.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "residual_quant")
    _build.launches["residual_quant"] += 1
    return q, err


def residual_quant(x, theta, slope, step, qmax: int = 127, lengths=None,
                   out_dtype=torch.int32):
    """The wrapper: the kernel for a CUDA tensor, the plain version for a
    CPU tensor.  Returns (q[M, N] of ``out_dtype``, err[M, N] float32)."""
    if x.is_cuda:
        return residual_quant_cuda(x, theta, slope, step, qmax, lengths, out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"residual_quant runs on cuda or cpu, got {x.device}")
    return residual_quant_plain(x, theta, slope, step, qmax, lengths, out_dtype)


# ---------------------------------------------------------------- the ladder
# Counterpart of ``repro.kernels.residual_quant``'s ``pyramid_quant_kernel``
# / ``pyramid_quant_pallas``, kernel ``csrc/pyramid_quant.cu``.  For x[M, N]
# (float32 or float64), theta, slope [M, 1] and steps [L] (coarse to fine),
# in the Pallas kernel's order:
#
#     e = x - (theta + slope * t)
#     for each layer: q_l = clip(round(e / steps[l]), -qmax, qmax);  e = e - q_l * steps[l]
#
# returning (qs int32 [L, M, N], err [M, N] = the last e), with ragged rows
# masked (``lengths`` [M]: q = 0 on every layer and err = +0.0 at t >=
# lengths[m]).  ``pyramid_quant_plain`` is the same arithmetic as separate
# torch ops (an IEEE division by a tensor, round half to even), so the two
# agree bit for bit.

_FSUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _pyramid_args(x, theta, slope, steps, qmax, lengths):
    """Checked and normalised (theta, slope [M], steps [L], lengths [M] or
    None) for either route; raises for what the kernel does not take."""
    if x.ndim != 2 or x.dtype not in _FSUFFIX:
        raise TypeError(f"pyramid_quant takes float32/float64 x[M, N], got {x.dtype} "
                        f"{tuple(x.shape)}")
    m = x.shape[0]
    for name, p in (("theta", theta), ("slope", slope)):
        if p.dtype != x.dtype or p.numel() != m or p.device != x.device:
            raise ValueError(f"pyramid_quant: {name} must be {x.dtype} [M, 1] on {x.device}")
    steps = torch.as_tensor(steps, dtype=x.dtype, device=x.device).reshape(-1)
    if not 0 <= qmax <= 2**31 - 1:
        raise ValueError(f"pyramid_quant: qmax={qmax} does not fit int32")
    if lengths is not None:
        lengths = lengths.to(device=x.device, dtype=torch.int32).reshape(m)
    return theta.reshape(m), slope.reshape(m), steps, lengths


def pyramid_quant_plain(x, theta, slope, steps, qmax: int = 127, lengths=None):
    theta, slope, steps, lengths = _pyramid_args(x, theta, slope, steps, qmax, lengths)
    m, n = x.shape
    t = torch.arange(n, dtype=x.dtype, device=x.device)[None, :]
    e = x - (theta[:, None] + slope[:, None] * t)
    qs = []
    for step in steps.reshape(-1, 1):  # [1] each: a division by a tensor
        q = torch.clamp(torch.round(torch.div(e, step)), -qmax, qmax)
        e = e - q * step
        qs.append(q.to(torch.int32))
    qs = torch.stack(qs) if qs else torch.empty((0, m, n), dtype=torch.int32, device=x.device)
    if lengths is not None:
        pad = t >= lengths[:, None]
        qs = qs.masked_fill(pad, 0)
        e = e.masked_fill(pad, 0.0)
    return qs, e


_PQ_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_int] + [ctypes.c_void_p] * 3)


def pyramid_quant_cuda(x, theta, slope, steps, qmax: int = 127, lengths=None):
    """Launch ``csrc/pyramid_quant.cu``; same contract as
    :func:`pyramid_quant_plain`."""
    theta, slope, steps, lengths = _pyramid_args(x, theta, slope, steps, qmax, lengths)
    m, n = x.shape
    if n > 2**31 - 1:
        raise ValueError(f"pyramid_quant: N={n} does not fit the kernel's int")
    x, theta, slope, steps = (p.contiguous() for p in (x, theta, slope, steps))
    if lengths is not None:
        lengths = lengths.contiguous()
    qs = torch.empty((steps.numel(), m, n), dtype=torch.int32, device=x.device)
    err = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return qs, err
    fn = _build.function("pyramid_quant", f"pyramid_quant_{_FSUFFIX[x.dtype]}", _PQ_ARGS)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), theta.data_ptr(), slope.data_ptr(), steps.data_ptr(), steps.numel(),
            None if lengths is None else lengths.data_ptr(), m, n, qmax,
            qs.data_ptr(), err.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "pyramid_quant")
    _build.launches["pyramid_quant"] += 1
    return qs, err


def pyramid_quant(x, theta, slope, steps, qmax: int = 127, lengths=None):
    """The wrapper: the kernel for a CUDA tensor, the plain version for a
    CPU tensor.  Returns (qs int32 [L, M, N], err [M, N] in x's dtype)."""
    if x.is_cuda:
        return pyramid_quant_cuda(x, theta, slope, steps, qmax, lengths)
    if x.device.type != "cpu":
        raise ValueError(f"pyramid_quant runs on cuda or cpu, got {x.device}")
    return pyramid_quant_plain(x, theta, slope, steps, qmax, lengths)
