"""Fused dequantize + reconstruct of the tensor codec (the inverse of
``residual_quant``), and of its multi-layer ladder: CUDA kernels, plain
versions, wrappers.

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

__all__ = [
    "dequant", "dequant_cuda", "dequant_plain",
    "pyramid_reconstruct", "pyramid_reconstruct_cuda", "pyramid_reconstruct_plain",
]

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


# ---------------------------------------------------------------- the ladder
# Counterpart of ``repro.kernels.dequant``'s ``pyramid_reconstruct_kernel`` /
# ``pyramid_reconstruct_pallas``, kernel ``csrc/pyramid_reconstruct.cu``: the
# inverse of ``pyramid_quant`` at any layer prefix.  For qs int32 [L, M, N],
# theta, slope [M, 1] (float32 or float64) and steps [L], in the Pallas
# kernel's order:
#
#     acc = theta + slope * t;  for each layer: acc = acc + float(qs[l]) * steps[l]
#
# giving [M, N] in theta's dtype; qs[:k+1] with steps[:k+1] reconstructs
# through layer k.  (The oracle ``pyramid_reconstruct_ref`` sums the layers
# first and adds the line last, which rounds differently.)
# ``pyramid_reconstruct_plain`` is the same arithmetic as separate torch
# ops, so the kernel and it agree bit for bit.

_FSUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _ladder_args(qs, theta, slope, steps):
    """Checked and normalised (theta, slope [M], steps [L]) for either
    route; raises for what the kernel does not take."""
    if qs.ndim != 3 or qs.dtype != torch.int32:
        raise TypeError(f"pyramid_reconstruct takes int32 qs[L, M, N], got {qs.dtype} "
                        f"{tuple(qs.shape)}")
    if theta.dtype not in _FSUFFIX:
        raise TypeError(f"pyramid_reconstruct takes float32/float64 theta, got {theta.dtype}")
    num_layers, m, _ = qs.shape
    for name, p in (("theta", theta), ("slope", slope)):
        if p.dtype != theta.dtype or p.numel() != m or p.device != qs.device:
            raise ValueError(f"pyramid_reconstruct: {name} must be {theta.dtype} [M, 1] "
                             f"on {qs.device}")
    steps = torch.as_tensor(steps, dtype=theta.dtype, device=qs.device).reshape(-1)
    if steps.numel() != num_layers:
        raise ValueError(f"pyramid_reconstruct: {steps.numel()} steps for {num_layers} layers")
    return theta.reshape(m), slope.reshape(m), steps


def pyramid_reconstruct_plain(qs, theta, slope, steps):
    theta, slope, steps = _ladder_args(qs, theta, slope, steps)
    n = qs.shape[2]
    t = torch.arange(n, dtype=theta.dtype, device=qs.device)[None, :]
    acc = theta[:, None] + slope[:, None] * t
    for q, step in zip(qs, steps.reshape(-1, 1)):
        acc = acc + q.to(theta.dtype) * step
    return acc


_PR_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64, ctypes.c_int]
            + [ctypes.c_void_p] * 2)


def pyramid_reconstruct_cuda(qs, theta, slope, steps):
    """Launch ``csrc/pyramid_reconstruct.cu``; same contract as
    :func:`pyramid_reconstruct_plain`."""
    theta, slope, steps = _ladder_args(qs, theta, slope, steps)
    num_layers, m, n = qs.shape
    if n > 2**31 - 1:
        raise ValueError(f"pyramid_reconstruct: N={n} does not fit the kernel's int")
    qs, theta, slope, steps = (p.contiguous() for p in (qs, theta, slope, steps))
    out = torch.empty((m, n), dtype=theta.dtype, device=qs.device)
    if m == 0 or n == 0:
        return out
    fn = _build.function("pyramid_reconstruct", f"pyramid_reconstruct_{_FSUFFIX[theta.dtype]}",
                         _PR_ARGS)
    with torch.cuda.device(qs.device):
        rc = fn(
            qs.data_ptr(), theta.data_ptr(), slope.data_ptr(), steps.data_ptr(), num_layers, m, n,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "pyramid_reconstruct")
    _build.launches["pyramid_reconstruct"] += 1
    return out


def pyramid_reconstruct(qs, theta, slope, steps):
    """The wrapper: the kernel for a CUDA tensor, the plain version for a
    CPU tensor.  Returns x_hat [M, N] in theta's dtype."""
    if qs.is_cuda:
        return pyramid_reconstruct_cuda(qs, theta, slope, steps)
    if qs.device.type != "cpu":
        raise ValueError(f"pyramid_reconstruct runs on cuda or cpu, got {qs.device}")
    return pyramid_reconstruct_plain(qs, theta, slope, steps)
