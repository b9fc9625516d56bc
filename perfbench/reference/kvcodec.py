"""The plain reference of the KV park and restore cell: SHRINK's tensor
codec as its description states it, in plain PyTorch.

A tensor is flattened and cut into blocks of ``block`` elements (the last
padded with zeros).  Each block keeps a least-squares line theta + slope *
t over t = 0..block-1 (fitted in float64 here), stored in bf16; the step is
max |r| / qmax of the residual r to that stored line, at least 1e-12, in
float32 (true divisions); the residuals are kept as integers round(r / step) in [-qmax,
qmax], qmax = 2^(bits-1) - 1.  A restore is (theta + slope * t) + q * step
in float32, then bf16.  A session parked, restored and parked again c
times is this round trip applied c times to its bf16 cache.

``bits=4`` is the control: the same codec one precision below the
configuration's int8 residuals.
"""
from __future__ import annotations

import torch


def round_trip(x: torch.Tensor, block: int = 256, bits: int = 8,
               rows: int = 1 << 18) -> tuple[torch.Tensor, torch.Tensor]:
    """(bf16 restore of x, the float32 step of each block [M]), computed in
    chunks of ``rows`` blocks."""
    qmax = 2 ** (bits - 1) - 1
    flat = x.reshape(-1)
    n = flat.numel()
    m = -(-n // block)
    out = torch.empty(m * block, dtype=torch.bfloat16, device=x.device)
    steps = torch.empty(m, dtype=torch.float32, device=x.device)
    t64 = torch.arange(block, dtype=torch.float64, device=x.device)
    tc = t64 - t64.mean()
    t32 = t64.float()
    # divisions by a tensor: true divisions on every device (CUDA torch turns
    # a division by a Python number into a multiply by its reciprocal)
    qmax_t = torch.tensor(float(qmax), device=x.device)
    for a in range(0, m, rows):
        b = min(a + rows, m)
        xb = torch.zeros(((b - a) * block,), dtype=torch.float32, device=x.device)
        part = flat[a * block:min(b * block, n)]
        xb[:part.numel()] = part.float()
        xb = xb.view(b - a, block)
        x64 = xb.double()
        slope = (x64 * tc).sum(1, keepdim=True) / (tc * tc).sum()
        theta = x64.mean(1, keepdim=True) - slope * t64.mean()
        theta = theta.to(torch.bfloat16).float()
        slope = slope.to(torch.bfloat16).float()
        line = theta + slope * t32
        r = xb - line
        step = (r.abs().amax(1, keepdim=True) / qmax_t).clamp(min=1e-12)
        q = torch.clamp(torch.round(r / step), -qmax, qmax)
        out[a * block:b * block] = (line + q * step).reshape(-1).to(torch.bfloat16)
        steps[a:b] = step.reshape(-1)
    return out[:n].reshape(x.shape), steps


def chain(x: torch.Tensor, cycles: int, block: int = 256,
          bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """``cycles`` park-and-restore round trips of the bf16 tensor x."""
    steps = None
    for _ in range(cycles):
        x, steps = round_trip(x, block, bits)
    return x, steps


def deviation(got: torch.Tensor, want: torch.Tensor, steps: torch.Tensor,
              block: int = 256) -> tuple[float, float]:
    """(largest, root mean square) of |got - want| in units of the
    reference's step of each element's block."""
    n = want.numel()
    m = steps.numel()
    d = torch.zeros(m * block, dtype=torch.float32, device=want.device)
    d[:n] = (got.reshape(-1).float() - want.reshape(-1).float()).abs()
    d = d.view(m, block) / steps[:, None]
    return float(d.max()), float(torch.sqrt((d * d).sum() / n))
