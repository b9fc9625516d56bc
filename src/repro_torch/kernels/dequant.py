"""Fused dequantize + reconstruct of the tensor codec (the inverse of
``residual_quant``): CUDA kernel, plain version, wrapper.

Counterpart of ``repro.kernels.dequant`` (the Pallas TPU kernel
``dequant_kernel`` / ``dequant_reconstruct_pallas``): for q[M, N] (int8,
int16 or int32) and per-row float32 theta, slope, step [M, 1],

    x_hat = (theta + slope * t) + q * step        (float32 [M, N])

The kernel is ``csrc/dequant.cu``; ``dequant_plain`` is the same
arithmetic as separate torch ops, so the two agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["dequant", "dequant_cuda", "dequant_plain"]

_SUFFIX = {torch.int8: "i8", torch.int16: "i16", torch.int32: "i32"}


def dequant_plain(q, theta, slope, step):
    n = q.shape[1]
    t = torch.arange(n, dtype=theta.dtype, device=q.device)[None, :]
    return (theta + slope * t) + q.to(theta.dtype) * step


_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int] + [ctypes.c_void_p] * 2


def dequant_cuda(q, theta, slope, step):
    """Launch ``csrc/dequant.cu``; same contract as :func:`dequant_plain`."""
    if q.ndim != 2 or q.dtype not in _SUFFIX:
        raise TypeError(f"dequant takes int8/int16/int32 q[M, N], got {q.dtype}")
    m, n = q.shape
    for name, p in (("theta", theta), ("slope", slope), ("step", step)):
        if p.dtype != torch.float32 or p.numel() != m or p.device != q.device:
            raise ValueError(f"dequant: {name} must be float32 [M, 1] on {q.device}")
    q = q.contiguous()
    theta, slope, step = (p.reshape(m).contiguous() for p in (theta, slope, step))
    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    if m == 0 or n == 0:
        return out
    fn = _build.function("dequant", f"dequant_{_SUFFIX[q.dtype]}", _ARGS)
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), theta.data_ptr(), slope.data_ptr(), step.data_ptr(), m, n,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "dequant")
    _build.launches["dequant"] += 1
    return out


def dequant(q, theta, slope, step):
    """The wrapper: the kernel for a CUDA tensor, the plain version for a
    CPU tensor.  Returns x_hat[M, N] float32."""
    if q.is_cuda:
        return dequant_cuda(q, theta, slope, step)
    if q.device.type != "cpu":
        raise ValueError(f"dequant runs on cuda or cpu, got {q.device}")
    return dequant_plain(q, theta, slope, step)
