"""Spans and counters of the port, for an operator's ``torch.profiler``.

Tracing is on exactly while a torch profiler records, and off otherwise:
there is nothing else to set.  Run ``torch.profiler.profile`` (CPU, and
CUDA on the card) around a prefill or serve loop, and every trace it writes
(``export_chrome_trace``, TensorBoard, ``key_averages()``) carries the
port's spans as host ranges on the profiler's own clock, beside the
operators and device kernels they launched.  Off, a span costs one check
of the profiler's state and a counter nothing at all.

A span is recorded at function scope, like an operator, not as a user
annotation: the profiler then draws no device-side copy of it (such a copy
stretches from the first kernel launched inside the range to the last, over
idle time and child ranges), and a range costs about 1 us on the host
where ``torch.profiler.record_function`` costs about 8.  Every layer of one
kind takes the same name, so a trace's sums by name run across layers:

========================  =====================================================
``model.embed``           ``Model.prefill``'s token embedding
``model.stack``           every block of the prefill
``model.caches``          the prefill's stacking of the group caches
``model.head``            the last position's final norm and logits
``block.mixer``           a block's first norm, its attention, MLA, RG-LRU or
                          RWKV and the residual add (cross-attention too)
``block.ffn``             a block's second norm, its MLP or MoE, the residual
``attn.flash``            the attention core alone (flash kernel or ``_sdpa``)
``moe.route``             router product, softmax, top-k sort, gates
``moe.aux``               the load-balancing loss
``moe.dispatch``          capacity positions, the zeroed buffer, the scatter
``moe.experts``           the experts' three batched products and SiLU
``moe.combine``           the gather, the gate product, the slot-order sum
``moe.shared``            the shared experts' MLP
``moe.count``             the device reductions behind the MoE counters
``kv.park``               ``serving.kvcache.quantize_cache``, whole
``kv.restore``            ``serving.kvcache.dequantize_cache``, bf16 cast too
``codec.blockify``        the tensor codec's flatten, float32 cast and pad
``codec.fit``             the line fit and the bf16 truncation of its base
``codec.step``            the default step (max residual / qmax), the clamp
``codec.quant``           ``residual_quant`` and the packing of its output
``codec.dequant``         ``dequant`` and the reshape back
========================  =====================================================

Decode and the training step share the blocks, so they carry the block,
attention and MoE spans too.  Counters, moved only while a profiler
records (a training step's recompute counts again):

================  =============================================================
``moe.routed``    (token, expert) pairs routed to this process's experts
``moe.slots``     rows of the expert buffers (experts x capacity)
``moe.kept``      routed pairs that found a slot (the rest pass the MoE by)
================  =============================================================

``moe.kept / moe.slots`` is the share of the expert products' rows that
carry a token; ``1 - moe.kept / moe.routed`` the share the capacity drops.
Read them with :func:`counts` after the profiled stretch, and zero them
with :func:`reset_counts` before the next.  The kernels' launch count stays
``kernels._build.launches``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["count", "counts", "recording", "reset_counts", "span"]

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_host: dict[str, int] = {}
_device: dict[torch.device, list] = {}  # device -> [(name, integer scalar)]


def recording() -> bool:
    """Whether a torch profiler records (spans and counters are live)."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A context that records the range ``name`` while a profiler records,
    and the one shared no-op context otherwise."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records.  ``n``
    is a Python int or an integer device scalar, which is kept as it is
    and summed at :func:`counts` (no wait for the device here, and no
    in-place update that a checkpointed region's recompute would refuse);
    off, nothing runs."""
    if not torch._C._autograd._profiler_enabled():
        return
    if not isinstance(n, torch.Tensor):
        with _lock:
            _host[name] = _host.get(name, 0) + int(n)
    elif n.device.type != "meta":  # a meta tensor has a shape, no value
        with _lock:
            _device.setdefault(n.device, []).append((name, n.detach()))


def counts() -> dict[str, int]:
    """Every counter as a Python int (one wait a device)."""
    with _lock:
        out = dict(_host)
        pending = {dev: list(items) for dev, items in _device.items()}
    for items in pending.values():
        for (name, _), v in zip(items, torch.stack([t for _, t in items]).tolist()):
            out[name] = out.get(name, 0) + v
    return out


def reset_counts() -> None:
    """Zero every counter."""
    with _lock:
        _host.clear()
        _device.clear()
