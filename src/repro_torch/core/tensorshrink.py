"""SHRINK for tensors (KV caches, gradients), counterpart of
``repro.core.jaxshrink``.

The paper's two phases restated for fixed-shape tensor data:

* **base**: a least-squares line ``theta + slope * t`` over each block of
  ``block`` elements of the flattened tensor, with theta and slope stored
  in bf16 (Alg. 5's truncated slope, in binary);
* **residuals**: the ``residual_quant`` kernel quantizes what the line
  leaves to ``bits``-bit integers with a per-block step
  (``max |r| / qmax``) and returns the error-feedback term.

Wire format per tensor: q int8 (int16 above 8 bits) [M, N] + theta, slope
bf16 [M, 1] + step f32 [M, 1].

The reference's ``use_kernel`` switch is gone: as everywhere in the port,
the tensor's device decides (the CUDA kernels on the card, their plain
torch versions on the CPU).  The fit is a kernel too (``base_fit``): it
sums in the reference's own order, with every rounding fixed (no matrix
product, so no TF32 and no library reduction order), and is the same on
both devices.  The default step is torch ops.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..kernels import ops
from . import trace

__all__ = [
    "CompressedTensor",
    "TensorCodecConfig",
    "compress_tensor",
    "decompress_tensor",
    "linear_base_fit",
]

# rows of the block matrix per pass of the default step: bounded [rows,
# block] float32 temporaries
_ROWS = 1 << 19


@dataclasses.dataclass(frozen=True)
class TensorCodecConfig:
    block: int = 256  # elements per block
    bits: int = 8  # residual bits (int8 wire format up to 8)

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1


class CompressedTensor(NamedTuple):
    q: torch.Tensor  # int8/int16 [M, N]
    theta: torch.Tensor  # bf16 [M, 1]
    slope: torch.Tensor  # bf16 [M, 1]
    step: torch.Tensor  # f32 [M, 1]
    orig_len: int
    shape: tuple

    def wire_bits(self) -> int:
        m = self.q.shape[0]
        return int(self.q.numel() * self.q.element_size() * 8 + m * (16 + 16 + 32))


def _blockify(x: torch.Tensor, block: int) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    pad = (-n) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, block), n


def linear_base_fit(xb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row least-squares line: (theta[M, 1], slope[M, 1]) float32, from
    the ``base_fit`` kernel (its plain version on the CPU), which sums in
    the reference's order: bit-identical to
    ``repro.core.jaxshrink.linear_base_fit`` on the CPU for blocks of up to
    876 elements, and the same on the card."""
    theta, slope = ops.base_fit(xb)
    return theta[:, None], slope[:, None]


def _default_step(xb, theta, slope, qmax: int) -> torch.Tensor:
    """max |r| / qmax per row, r the residual of the line; a division by a
    tensor, which CUDA torch does not turn into a reciprocal multiply."""
    t = torch.arange(xb.shape[1], dtype=xb.dtype, device=xb.device)[None, :]
    peak = torch.empty_like(theta)
    for a in range(0, xb.shape[0], _ROWS):
        b = a + _ROWS
        r = xb[a:b] - (theta[a:b] + slope[a:b] * t)
        peak[a:b] = r.abs().amax(dim=1, keepdim=True)
    return torch.div(peak, torch.tensor(float(qmax), device=xb.device))


def compress_tensor(
    x: torch.Tensor,
    cfg: TensorCodecConfig = TensorCodecConfig(),
    step: torch.Tensor | None = None,
) -> tuple[CompressedTensor, torch.Tensor]:
    """Compress ``x``; returns (compressed, error feedback flat [numel]).

    ``step`` [M, 1] may come from outside (a max across replicas, so that
    all quantize on one grid); by default it is each block's
    ``max |r| / qmax``, at least 1e-12."""
    with trace.span("codec.blockify"):
        xb, n = _blockify(x, cfg.block)
    with trace.span("codec.fit"):
        theta, slope = linear_base_fit(xb)
        # bf16-truncate the base (Alg. 5's few-digit slope, binary radix)
        theta = theta.to(torch.bfloat16).to(torch.float32)
        slope = slope.to(torch.bfloat16).to(torch.float32)
    with trace.span("codec.step"):
        if step is None:
            step = _default_step(xb, theta, slope, cfg.qmax)
        step = torch.clamp(step.to(torch.float32), min=1e-12)
    with trace.span("codec.quant"):
        wire = torch.int8 if cfg.bits <= 8 else torch.int16
        q, err = ops.residual_quant(xb, theta, slope, step, qmax=cfg.qmax, out_dtype=wire)
        comp = CompressedTensor(
            q=q,
            theta=theta.to(torch.bfloat16),
            slope=slope.to(torch.bfloat16),
            step=step,
            orig_len=n,
            shape=tuple(x.shape),
        )
    return comp, err.reshape(-1)[:n]


def decompress_tensor(comp: CompressedTensor) -> torch.Tensor:
    """float32 reconstruction of the compressed tensor, in its shape."""
    with trace.span("codec.dequant"):
        xh = ops.dequant(
            comp.q, comp.theta.to(torch.float32), comp.slope.to(torch.float32), comp.step
        )
        return xh.reshape(-1)[: comp.orig_len].reshape(comp.shape)
