"""Carry state from the reference package into the port and back.

Every function takes or returns plain data (dicts, bytes, numpy arrays),
never a ``repro`` object, so this module imports nothing of ``repro``:

* :func:`config_from_reference` takes ``dataclasses.asdict`` of a
  ``repro.core.ShrinkConfig``;
* :func:`series_from_reference` takes the ``SHRK`` bytes of a reference
  ``CompressedSeries`` (``repro.core.cs_to_bytes``);
* :func:`compressed_tensor_from_reference` takes the fields of a
  ``repro.core.jaxshrink.CompressedTensor`` as numpy arrays, and
  :func:`compressed_tensor_to_reference` gives them back;
* :func:`attn_cache_from_reference` takes the k, v and kpos of a
  ``repro.models.layers.AttnCache`` as numpy arrays.

bf16 arrays come as numpy's ``bfloat16`` extension type (what
``np.asarray`` makes of a bf16 JAX array) or as float32 arrays holding
bf16 values; they go back as float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.device import resolve_device
from .core.shrink import cs_from_bytes
from .core.tensorshrink import CompressedTensor
from .core.types import CompressedSeries, ShrinkConfig
from .models.layers import AttnCache

__all__ = [
    "attn_cache_from_reference",
    "compressed_tensor_from_reference",
    "compressed_tensor_to_reference",
    "config_from_reference",
    "series_from_reference",
]


def config_from_reference(fields: dict) -> ShrinkConfig:
    """A port config with the same fields as the reference config."""
    names = {f.name for f in dataclasses.fields(ShrinkConfig)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown ShrinkConfig fields {sorted(unknown)}")
    return ShrinkConfig(**fields)


def series_from_reference(blob: bytes) -> CompressedSeries:
    """The port's view of a reference ``SHRK`` blob (same base, pyramid and
    payload bytes)."""
    return cs_from_bytes(blob)


def _bf16(a, device) -> torch.Tensor:
    """A bf16 tensor with exactly the values of ``a``."""
    a = np.array(a)  # an owned, writable copy for torch
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    t = torch.from_numpy(a.astype(np.float32))
    out = t.to(torch.bfloat16)
    if not torch.equal(out.float(), t):
        raise ValueError("array holds values that bf16 cannot represent exactly")
    return out.to(device)


def compressed_tensor_from_reference(
    q, theta, slope, step, orig_len: int, shape, device=None
) -> CompressedTensor:
    """The port's ``CompressedTensor`` with the reference's fields: q int8
    or int16 [M, N], theta and slope bf16 [M, 1], step float32 [M, 1], on
    the card unless ``device="cpu"``."""
    device = resolve_device(device)
    q = np.array(q)
    if q.dtype not in (np.int8, np.int16):
        raise ValueError(f"q must be int8 or int16, got {q.dtype}")
    return CompressedTensor(
        q=torch.from_numpy(q).to(device),
        theta=_bf16(theta, device),
        slope=_bf16(slope, device),
        step=torch.from_numpy(np.array(step, dtype=np.float32)).to(device),
        orig_len=int(orig_len),
        shape=tuple(int(d) for d in shape),
    )


def compressed_tensor_to_reference(comp: CompressedTensor) -> dict:
    """The fields of ``comp`` as numpy arrays (theta and slope as float32
    holding their bf16 values), for ``repro.core.jaxshrink.CompressedTensor``."""
    return {
        "q": comp.q.cpu().numpy(),
        "theta": comp.theta.float().cpu().numpy(),
        "slope": comp.slope.float().cpu().numpy(),
        "step": comp.step.cpu().numpy(),
        "orig_len": comp.orig_len,
        "shape": tuple(comp.shape),
    }


def attn_cache_from_reference(k, v, kpos, device=None) -> AttnCache:
    """The port's ``AttnCache`` from the reference's bf16 k, v and int32
    kpos, on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    return AttnCache(
        k=_bf16(k, device),
        v=_bf16(v, device),
        kpos=torch.from_numpy(np.array(kpos, dtype=np.int32)).to(device),
    )
