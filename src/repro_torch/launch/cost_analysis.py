"""The cost of one eager step, counted as it dispatches: the port's
counterpart of ``repro.launch.hlo_analysis``.

The reference reads its roofline terms off the compiled HLO of a jitted
step.  The port runs eagerly, so there is no HLO: every aten op is one
launch, and :func:`analyze_step` counts what the step really dispatches,
on any device (meta tensors for the dry run, the CPU, the card), through
one ``TorchDispatchMode``:

* **flops**: ``2 m n k`` for every matmul-class op (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``; ``matmul``, ``einsum`` and ``linear`` reach these).
  Elementwise flops are ignored, as the reference ignores them.
* **bytes**: the operand bytes plus the result bytes of every op that
  launches work; views and metadata ops (``view``, ``expand``, ``t``,
  ``detach``, ``empty``, ...) are skipped, as the reference skips its
  plumbing.  Every op is its own launch in eager mode, so this is the
  step's unfused traffic to device memory.
* **collective bytes**: every ``c10d`` op, by type, at its result's bytes;
  an all-reduce counts twice (the reference's ring convention: send and
  receive).
* **kernels**: a hand-written kernel's wrapper (``kernels._build.counted``)
  pauses the mode around its body and records the work of its function
  instead: the same count for a meta tensor, the plain version on the CPU
  and the kernel on the card.

The reference's ``while_trips`` has no counterpart: the port's layer loop
is Python, so every layer's ops dispatch and are counted.

``peak_live_bytes`` is the peak of the bytes held by the storages that
ops made inside the step (the step's temporaries and outputs), tracked by
weak references: the dry run's ``temp_bytes``.  The storages of the
step's inputs (:func:`tensor_bytes`' trees: dicts, lists, tuples and
dataclass instances such as the decode caches) are not counted, nor are
the views and in-place writes of them that an op returns.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves

from ..kernels import _build

__all__ = ["StepCost", "analyze_step", "tensor_bytes"]

aten = torch.ops.aten

_MATMULS = {aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default}
# ops that make no new data: allocations and metadata (views are found by is_view)
_SKIP_BYTES = {
    aten.detach.default, aten._unsafe_view.default, aten.empty.memory_format,
    aten.empty_strided.default, aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default,
    aten.lift_fresh.default, aten._local_scalar_dense.default, aten.sym_size.int,
    aten.sym_stride.int, aten.sym_numel.default, aten.sym_storage_offset.default,
    aten.is_same_size.default,
}
_COLLECTIVES = {  # c10d op name -> the reference's collective type
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast", "send": "send", "recv_": "recv",
}


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree) for t in _tensors(getattr(tree, f.name))]
    return []


def tensor_bytes(tree) -> int:
    """The bytes of the tensors in ``tree``: dicts, lists, tuples and
    dataclass instances (the decode caches) are nodes."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _matmul_flops(func, args) -> int:
    a, b = (args[1], args[2]) if func in (aten.addmm.default, aten.baddbmm.default) else args[:2]
    return 2 * math.prod(a.shape) * b.shape[-1]


@dataclasses.dataclass
class StepCost:
    """What one step dispatched: flops and bytes (the aten ops' and the
    kernels'), collective bytes in all and by type, the count of matmul
    ops, each kernel's ``{"calls", "flops", "bytes"}``, the peak of the
    live bytes the step's own ops held, and ``by_op``: each aten op's
    ``[calls, flops, bytes]`` (where the bytes go)."""

    flops: int = 0
    bytes: int = 0
    collective_bytes: int = 0
    collective_by_type: dict = dataclasses.field(default_factory=dict)
    dot_count: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)
    peak_live_bytes: int = 0
    by_op: dict = dataclasses.field(default_factory=dict)


class _Counter(TorchDispatchMode):
    counts_kernels = True  # what kernels._build.cost_counter looks for

    def __init__(self, inputs: set[int]):
        super().__init__()
        self.inputs = inputs  # the storage keys of the step's inputs
        self.cost = StepCost()
        self.by_type: dict[str, int] = defaultdict(int)
        self.live: dict[int, list] = {}  # storage key -> [bytes, tensors alive]
        self.live_bytes = 0

    # ------------------------------------------------------------- memory
    def _drop(self, key: int) -> None:
        entry = self.live[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self.live[key]

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.inputs:  # a view or in-place write of an input
                continue
            entry = self.live.get(key)
            if entry is None:
                entry = self.live[key] = [st.nbytes(), 0]
                self.live_bytes += entry[0]
                self.cost.peak_live_bytes = max(self.cost.peak_live_bytes, self.live_bytes)
            entry[1] += 1
            weakref.finalize(t, self._drop, key)

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        if ns == "c10d":
            kind = _COLLECTIVES.get(func._opname)
            if kind is not None:
                n = _nbytes(args[0]) * (2 if kind == "all-reduce" else 1)
                self.by_type[kind] += n
                self.cost.collective_bytes += n
            return out
        flops = nbytes = 0
        if func in _MATMULS:
            flops = _matmul_flops(func, args)
            self.cost.dot_count += 1
        if not (func.is_view or func in _SKIP_BYTES):
            nbytes = _nbytes((args, kwargs)) + _nbytes(out)
        self.cost.flops += flops
        self.cost.bytes += nbytes
        row = self.cost.by_op.setdefault(str(func), [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        self._track(out)
        return out

    # ------------------------------------------------------------ kernels
    def kernel(self, name: str, work: tuple[int, int], body, args):
        """``kernels._build.counted``'s route under this counter."""
        with _disable_current_modes():
            out = body(*args)
        flops, nbytes = work
        k = self.cost.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.cost.flops += flops
        self.cost.bytes += nbytes
        self._track(out)
        return out


def analyze_step(fn, *args, **kw):
    """``(fn(*args, **kw), StepCost)``: the step run once under the
    counter, on this thread (and autograd's device threads).  Counters do
    not nest."""
    if _build.cost_counter() is not None:
        raise RuntimeError("analyze_step is already counting")
    counter = _Counter({t.untyped_storage()._cdata for t in _tensors((args, kw))})
    with counter:
        result = fn(*args, **kw)
    counter.cost.collective_by_type = dict(counter.by_type)
    return result, counter.cost
