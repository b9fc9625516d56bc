"""Serving KV-cache store, counterpart of ``repro.serving.kvcache``:
prefill-to-decode buffer promotion and SHRINK residual-quantized caches.

``promote_caches`` pads caches built at prompt length into decode buffers
of ``max_seq`` positions (``kpos`` pads with -1, "empty").
``quantize_cache`` compresses an :class:`AttnCache`'s K and V with the
tensor codec (a per-block line in bf16 + int8 residuals, through the
``residual_quant`` kernel); ``dequantize_cache`` rebuilds bf16 K and V
through the ``dequant`` kernel.  ``QuantizedKV.memory_bits`` is what the
store holds.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.tensorshrink import (
    CompressedTensor,
    TensorCodecConfig,
    compress_tensor,
    decompress_tensor,
)
from ..models.layers import AttnCache, MLACache

__all__ = ["QuantizedKV", "dequantize_cache", "promote_caches", "quantize_cache"]


def _pad_axis(x: torch.Tensor, axis: int, new_size: int, fill=0) -> torch.Tensor:
    old = x.shape[axis]
    if old >= new_size:
        return x
    shape = list(x.shape)
    shape[axis] = new_size
    out = x.new_full(shape, fill)
    out.narrow(axis, 0, old).copy_(x)
    return out


def promote_caches(caches: Any, max_seq: int) -> Any:
    """Pad every attention cache buffer (and MLA latent cache) of a cache
    tree ``{"prefix": [...], "groups": ..., "tail": [...]}`` from prompt
    length to ``max_seq``; ``kpos`` pads with -1 (empty).  The stacked
    ``groups`` caches carry the group axis first, so their sequence axis
    is 2."""

    def walk(node, stacked: bool):
        ax = 2 if stacked else 1
        if isinstance(node, AttnCache):
            return AttnCache(
                k=_pad_axis(node.k, ax, max_seq),
                v=_pad_axis(node.v, ax, max_seq),
                kpos=_pad_axis(node.kpos, ax, max_seq, fill=-1),
            )
        if isinstance(node, MLACache):
            return MLACache(
                c_kv=_pad_axis(node.c_kv, ax, max_seq),
                k_rope=_pad_axis(node.k_rope, ax, max_seq),
                kpos=_pad_axis(node.kpos, ax, max_seq, fill=-1),
            )
        if isinstance(node, dict):
            return {k: walk(v, stacked) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, stacked) for v in node]
        return node

    return {
        "prefix": walk(caches.get("prefix", []), stacked=False),
        "groups": walk(caches.get("groups"), stacked=True),
        "tail": walk(caches.get("tail", []), stacked=False),
    }


@dataclasses.dataclass
class QuantizedKV:
    k: CompressedTensor
    v: CompressedTensor
    kpos: torch.Tensor

    def memory_bits(self) -> int:
        return self.k.wire_bits() + self.v.wire_bits() + self.kpos.numel() * 32


def quantize_cache(cache: AttnCache, cfg: TensorCodecConfig = TensorCodecConfig()) -> QuantizedKV:
    ck, _ = compress_tensor(cache.k, cfg)
    cv, _ = compress_tensor(cache.v, cfg)
    return QuantizedKV(k=ck, v=cv, kpos=cache.kpos)


def dequantize_cache(q: QuantizedKV) -> AttnCache:
    return AttnCache(
        k=decompress_tensor(q.k).to(torch.bfloat16),
        v=decompress_tensor(q.v).to(torch.bfloat16),
        kpos=q.kpos,
    )
