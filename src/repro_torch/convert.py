"""Carry state from the reference package into the port and back.

Every function takes or returns plain data (dicts, bytes, numpy arrays),
never a ``repro`` object, so this module imports nothing of ``repro``:

* :func:`config_from_reference` takes ``dataclasses.asdict`` of a
  ``repro.core.ShrinkConfig``;
* :func:`series_from_reference` takes the ``SHRK`` bytes of a reference
  ``CompressedSeries`` (``repro.core.cs_to_bytes``);
* :func:`knowledge_base_from_reference` takes the ``SHKB`` bytes of a
  reference ``KnowledgeBase`` (``KnowledgeBase.to_bytes()``); a streamed
  container itself crosses as its ``SHRKS`` bytes, which both packages
  read;
* :func:`compressed_tensor_from_reference` takes the fields of a
  ``repro.core.jaxshrink.CompressedTensor`` as numpy arrays, and
  :func:`compressed_tensor_to_reference` gives them back;
* :func:`attn_cache_from_reference` takes the k, v and kpos of a
  ``repro.models.layers.AttnCache`` as numpy arrays, and
  :func:`decode_caches_from_reference` a whole cache tree of them and of
  the other cache dataclasses (``MLACache``, ``RecState``, ``RwkvState``);
* :func:`model_params_from_reference` takes a reference params pytree as
  nested dicts and lists of numpy arrays, and
  :func:`opt_state_from_reference` a reference AdamW state (its m and v
  trees and its step) the same way.

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
from .core.streaming import KnowledgeBase
from .core.tensorshrink import CompressedTensor
from .core.types import CompressedSeries, ShrinkConfig
from .models.layers import AttnCache, MLACache, RecState, RwkvState

__all__ = [
    "attn_cache_from_reference",
    "compressed_tensor_from_reference",
    "compressed_tensor_to_reference",
    "config_from_reference",
    "decode_caches_from_reference",
    "knowledge_base_from_reference",
    "model_params_from_reference",
    "opt_state_from_reference",
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


def knowledge_base_from_reference(kb_bytes: bytes) -> KnowledgeBase:
    """The port's copy of a reference knowledge base: the same entries, in
    the same positions, with the same refcounts and config."""
    return KnowledgeBase.from_bytes(kb_bytes)


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


def model_params_from_reference(tree, device=None):
    """The port's params of a reference ``Model.init`` pytree given as
    nested dicts and lists of numpy arrays: the same keys, shapes and
    values; bf16 arrays become bf16 tensors, float32 ones float32."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: model_params_from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [model_params_from_reference(v, device) for v in tree]
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        return _bf16(a, device)
    return torch.from_numpy(a).to(device)


def opt_state_from_reference(state, device=None) -> dict:
    """The port's AdamW state of a reference ``adamw_init`` / ``adamw_update``
    state given as ``{"m": tree, "v": tree, "step": scalar}`` of numpy
    arrays: float32 moments and an int32 step."""
    device = resolve_device(device)
    return {
        "m": model_params_from_reference(state["m"], device),
        "v": model_params_from_reference(state["v"], device),
        "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32, device=device),
    }


# the fields of each reference cache dataclass -> the port's class
_CACHES = {frozenset(f.name for f in dataclasses.fields(cls)): cls
           for cls in (AttnCache, MLACache, RecState, RwkvState)}
_FLOAT32_FIELDS = {"h", "wkv"}  # recurrent and WKV states; kpos is int32, the rest bf16


def _cache_field(name: str, a, device) -> torch.Tensor:
    if name == "kpos":
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)
    if name in _FLOAT32_FIELDS:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    return _bf16(a, device)


def decode_caches_from_reference(tree, device=None):
    """The port's decode caches of a reference cache tree given as nested
    dicts and lists, each cache dataclass (``AttnCache``, ``MLACache``,
    ``RecState``, ``RwkvState``) as a dict of its numpy fields
    (``dataclasses.asdict``): bf16 fields as bf16 tensors, the recurrent
    and WKV states float32, positions int32."""
    device = resolve_device(device)
    if isinstance(tree, dict) and frozenset(tree) in _CACHES:
        cls = _CACHES[frozenset(tree)]
        return cls(**{name: _cache_field(name, a, device) for name, a in tree.items()})
    if isinstance(tree, dict):
        return {k: decode_caches_from_reference(v, device) for k, v in tree.items()}
    return [decode_caches_from_reference(v, device) for v in tree]
