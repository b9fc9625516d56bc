"""Model layers in PyTorch, counterpart of ``repro.models.layers``.

Only the decode-time cache containers are here so far, for the serving
KV-cache store (``repro_torch.serving.kvcache``); the layers themselves
come with the port of the models.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["AttnCache", "MLACache"]


@dataclasses.dataclass
class AttnCache:
    """Decode-time KV cache.  k/v: [B, S_buf, KV, D]; kpos: [B, S_buf]
    absolute positions (-1 = empty).  Stacked layer groups carry a leading
    group axis: [G, B, S_buf, KV, D] and [G, B, S_buf]."""

    k: torch.Tensor
    v: torch.Tensor
    kpos: torch.Tensor


@dataclasses.dataclass
class MLACache:
    """MLA latent cache: c_kv [B, S, lora] + k_rope [B, S, rope_dim]."""

    c_kv: torch.Tensor
    k_rope: torch.Tensor
    kpos: torch.Tensor
